"""The transport-independent Request abstraction + HTTP implementation
(the port's copy of ``gofr_tpu/http/request.py``).

Mirrors reference pkg/gofr/request.go:10-17: ``Request`` is what a
Context exposes regardless of transport (HTTP, CLI argv, pub/sub
message, websocket frame): ``param``/``path_param``/``bind``/
``host_name``/``params``. The HTTP implementation carries the parsed
request line, headers, query and body, with JSON / form / multipart
binding (reference http/request.go:29-181, form_data_binder.go).

The port's asyncio server also sets ``request.client_gone``: a callable
that says whether the client has left (EOF or a failed write on its
connection, or the app's request timeout), read by
``Context.client_gone`` from any thread.
"""

from __future__ import annotations

import dataclasses
import json
import types
import typing
from typing import Any, Mapping, Protocol
from urllib.parse import parse_qs, unquote, urlsplit


class Request(Protocol):
    def param(self, key: str) -> str: ...
    def path_param(self, key: str) -> str: ...
    def params(self, key: str) -> list[str]: ...
    def bind(self, target: Any = None) -> Any: ...
    def host_name(self) -> str: ...


class BindError(Exception):
    status_code = 400

    def __init__(self, message: str) -> None:
        super().__init__(message)


def _coerce(value: Any, hint: Any) -> Any:
    """Coerce a string/JSON value toward a type hint; best-effort."""
    if hint in (None, Any, typing.Any):
        return value
    origin = typing.get_origin(hint)
    if origin is typing.Union or origin is types.UnionType:
        args = [a for a in typing.get_args(hint) if a is not type(None)]
        if value is None:
            return None
        hint = args[0] if args else Any
        origin = typing.get_origin(hint)
    try:
        if hint is bool or hint == "bool":
            if isinstance(value, bool):
                return value
            return str(value).strip().lower() in ("1", "true", "yes", "on")
        if hint is int:
            return int(value)
        if hint is float:
            return float(value)
        if hint is str:
            return str(value)
        if origin in (list, tuple) and isinstance(value, (list, tuple)):
            inner = (typing.get_args(hint) or (Any,))[0]
            return [_coerce(v, inner) for v in value]
        if dataclasses.is_dataclass(hint) and isinstance(value, Mapping):
            return bind_dataclass(value, hint)
    except (TypeError, ValueError) as exc:
        raise BindError(f"cannot coerce {value!r} to {hint}: {exc}") from exc
    return value


def bind_dataclass(data: Mapping[str, Any], cls: type) -> Any:
    """Build a dataclass from a mapping, coercing field types.

    The Python analog of the reference's reflection form binder
    (http/form_data_binder.go): nested dataclasses, lists, optionals.
    Unknown keys are ignored; missing keys fall back to field defaults.
    """
    hints = typing.get_type_hints(cls)
    kwargs: dict[str, Any] = {}
    for f in dataclasses.fields(cls):
        if f.name in data:
            kwargs[f.name] = _coerce(data[f.name], hints.get(f.name, Any))
        elif (f.default is dataclasses.MISSING
              and f.default_factory is dataclasses.MISSING):
            raise BindError(f"missing required field {f.name!r}")
    return cls(**kwargs)


class HTTPRequest:
    """Parsed HTTP request implementing the Request protocol."""

    def __init__(self, method: str, target: str, headers: Mapping[str, str],
                 body: bytes = b"", path_params: Mapping[str, str] | None = None,
                 client_addr: str = "") -> None:
        self.method = method.upper()
        split = urlsplit(target)
        self.path = unquote(split.path) or "/"
        self.query = parse_qs(split.query, keep_blank_values=True)
        # header names are case-insensitive
        self.headers = {k.lower(): v for k, v in headers.items()}
        self.body = body
        self._path_params = dict(path_params or {})
        self.client_addr = client_addr

    # -- Request protocol
    def param(self, key: str) -> str:
        values = self.query.get(key)
        return values[0] if values else ""

    def params(self, key: str) -> list[str]:
        """All values for a key, splitting comma-separated entries
        (reference http/request.go Params)."""
        out: list[str] = []
        for v in self.query.get(key, []):
            out.extend(p for p in v.split(",") if p != "")
        return out

    def path_param(self, key: str) -> str:
        return self._path_params.get(key, "")

    def set_path_params(self, params: Mapping[str, str]) -> None:
        self._path_params = dict(params)

    def host_name(self) -> str:
        return self.headers.get("host", "")

    def header(self, key: str) -> str:
        return self.headers.get(key.lower(), "")

    @property
    def content_type(self) -> str:
        return self.headers.get("content-type", "").split(";")[0].strip().lower()

    # -- binding (reference http/request.go:58-79)
    def bind(self, target: Any = None) -> Any:
        ctype = self.content_type
        if ctype in ("", "application/json", "text/json"):
            if not self.body:
                data: Any = {}
            else:
                try:
                    data = json.loads(self.body)
                except json.JSONDecodeError as exc:
                    raise BindError(f"invalid JSON body: {exc}") from exc
        elif ctype in ("application/x-www-form-urlencoded",):
            parsed = parse_qs(self.body.decode("utf-8", "replace"),
                              keep_blank_values=True)
            data = {k: v[0] if len(v) == 1 else v for k, v in parsed.items()}
        elif ctype.startswith("multipart/"):
            data = self._parse_multipart()
        elif ctype in ("application/octet-stream",):
            data = self.body
        elif ctype.startswith("text/"):
            data = self.body.decode("utf-8", "replace")
        else:
            data = self.body
        if target is None:
            return data
        if dataclasses.is_dataclass(target) and isinstance(target, type):
            if not isinstance(data, Mapping):
                raise BindError(f"cannot bind {type(data).__name__} body to "
                                f"{target.__name__}")
            return bind_dataclass(data, target)
        if isinstance(target, type):
            return _coerce(data, target)
        return data

    def _parse_multipart(self) -> dict[str, Any]:
        """Minimal multipart/form-data parser: fields + file parts."""
        full = self.headers.get("content-type", "")
        boundary = None
        for piece in full.split(";"):
            piece = piece.strip()
            if piece.startswith("boundary="):
                boundary = piece[len("boundary="):].strip('"')
        if not boundary:
            raise BindError("multipart body missing boundary")
        delim = b"--" + boundary.encode()
        out: dict[str, Any] = {}
        for part in self.body.split(delim):
            part = part.strip(b"\r\n")
            if not part or part == b"--":
                continue
            if b"\r\n\r\n" in part:
                raw_headers, content = part.split(b"\r\n\r\n", 1)
            else:
                raw_headers, content = part, b""
            disposition = ""
            part_ctype = ""
            for line in raw_headers.decode("utf-8", "replace").split("\r\n"):
                low = line.lower()
                if low.startswith("content-disposition:"):
                    disposition = line.split(":", 1)[1]
                elif low.startswith("content-type:"):
                    part_ctype = line.split(":", 1)[1].strip()
            name, filename = None, None
            for attr in disposition.split(";"):
                attr = attr.strip()
                if attr.startswith("name="):
                    name = attr[5:].strip('"')
                elif attr.startswith("filename="):
                    filename = attr[9:].strip('"')
            if name is None:
                continue
            if filename is not None:
                out[name] = {"filename": filename, "content": content,
                             "content_type": part_ctype}
            else:
                out[name] = content.decode("utf-8", "replace")
        return out
