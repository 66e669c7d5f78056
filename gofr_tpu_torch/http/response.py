"""Rich response types a handler can return (the port's copy of
``gofr_tpu/http/response.py``; ``serving/responses.py`` re-exports it).

Mirrors reference pkg/gofr/http/response/: ``File``, ``Raw``,
``Redirect``, ``Template``, and the metadata-carrying ``Response``;
plus ``Partial`` for the data+error -> 206 policy
(reference http/responder.go:197-199).

Two additions the port's serving planes need: :class:`Reply` (bytes
sent as they are, with their own status, content type and headers: the
fleet router's mirror of a worker's answer), and ``Stream.headers``.
A :class:`Stream`'s iterator may be asynchronous or plain: ``App`` runs
a plain one on a worker thread (``handler.ThreadPump``), ``ChatServer``
on the request's thread.
"""

from __future__ import annotations

import mimetypes
import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any
from xml.sax.saxutils import escape as _xml_escape


@dataclass
class Response:
    """Data plus optional metadata/headers envelope member."""

    data: Any
    metadata: dict[str, Any] | None = None
    headers: dict[str, str] = field(default_factory=dict)


@dataclass
class Raw:
    """Marshal ``data`` as JSON without the ``{"data": ...}`` envelope."""

    data: Any


@dataclass
class File:
    """Serve bytes with a content type (reference response/file.go)."""

    content: bytes
    content_type: str = "application/octet-stream"

    @classmethod
    def from_path(cls, path: str | Path) -> "File":
        p = Path(path)
        ctype = mimetypes.guess_type(str(p))[0] or "application/octet-stream"
        return cls(content=p.read_bytes(), content_type=ctype)


@dataclass
class Redirect:
    """302 for GET/HEAD, 303 for mutating methods (responder.go:99-110)."""

    url: str


@dataclass
class Template:
    """Render ``./templates/<name>`` with ``data`` via str.format-style
    ``$var`` substitution (stdlib string.Template; the reference uses
    html/template, response/template.go)."""

    name: str
    data: dict[str, Any] = field(default_factory=dict)
    directory: str = "templates"

    def render(self) -> str:
        import string
        text = (Path(self.directory) / self.name).read_text()
        return string.Template(text).safe_substitute(
            {k: str(v) for k, v in self.data.items()})


@dataclass
class XML:
    """Marshal ``data`` as an XML document (reference response/xml.go).

    Dicts become child elements, lists repeat the ``item`` element, and
    scalars become text nodes; attribute-free by design — handlers that
    need full control return :class:`Raw` bytes with an XML content
    type instead.
    """

    data: Any
    root: str = "response"

    def render(self) -> str:
        return ('<?xml version="1.0" encoding="UTF-8"?>'
                f"{_xml_element(self.root, self.data)}")


_XML_TAG_BAD = re.compile(r"[^A-Za-z0-9_.-]")


def _xml_tag(name: str) -> str:
    """Sanitize a data-driven key into a well-formed element name.

    Keys can come from user payloads a handler echoes back; passing
    them through raw would let ``"k></x><admin>"`` inject elements.
    """
    tag = _XML_TAG_BAD.sub("_", str(name)) or "_"
    if not (tag[0].isalpha() or tag[0] == "_"):
        tag = "_" + tag
    return tag


def _xml_element(tag: str, value: Any) -> str:
    tag = _xml_tag(tag)
    if isinstance(value, dict):
        inner = "".join(_xml_element(str(k), v) for k, v in value.items())
    elif isinstance(value, (list, tuple)):
        inner = "".join(_xml_element("item", v) for v in value)
    elif value is None:
        inner = ""
    else:
        inner = _xml_escape(str(value))
    return f"<{tag}>{inner}</{tag}>"


@dataclass
class Partial:
    """Data AND error together -> 206 Partial Content."""

    data: Any
    error: BaseException


@dataclass
class Reply:
    """Bytes sent as they are, with their status, content type and extra
    headers (the fleet router's mirror of a worker's answer)."""

    status: int
    body: bytes
    content_type: str = "application/json"
    headers: dict = field(default_factory=dict)


@dataclass
class Stream:
    """Server-sent token stream: an iterator of chunks.

    ``/chat`` handlers return a ``Stream`` whose iterator yields decoded
    tokens as they leave the device; the server writes each chunk as one
    chunk of a chunked body. An empty chunk is sent as nothing: it tells
    the server to check that the client is still connected (a handler
    yields one while it waits for a token).
    """

    iterator: Any  # (Async)Iterator[str | bytes | dict]
    content_type: str = "text/event-stream"
    #: extra response headers
    headers: dict = field(default_factory=dict)
