"""A pub/sub message (copy of ``gofr_tpu/pubsub/message.py``): it answers
the request protocol's reads (``param``, ``params``, ``path_param``,
``bind``, ``host_name``), so a handler reads a broker message as it reads
an HTTP request, and commits once its work is done (at-least-once).

``bind`` returns the decoded JSON body (the raw bytes when it is not
JSON), or, given a dataclass, the body bound to it (``http.request.
bind_dataclass``), as ``ctx.bind(target)`` does for a request.
"""

from __future__ import annotations

import json
from typing import Any, Callable


class Message:
    def __init__(self, topic: str, value: bytes,
                 key: str = "", metadata: dict | None = None,
                 committer: Callable | None = None) -> None:
        self.topic = topic
        self.value = value
        self.key = key
        self.metadata = dict(metadata or {})
        self._committer = committer
        self.committed = False

    def commit(self) -> None:
        """Acknowledge the message once (a second call does nothing)."""
        if not self.committed and self._committer is not None:
            self._committer()
        self.committed = True

    def param(self, key: str) -> str:
        return str(self.metadata.get(key, ""))

    def params(self, key: str) -> list[str]:
        value = self.metadata.get(key)
        return [str(value)] if value is not None else []

    def path_param(self, key: str) -> str:
        if key == "topic":
            return self.topic
        return str(self.metadata.get(key, ""))

    def bind(self, target: Any = None) -> Any:
        try:
            data = json.loads(self.value)
        except (json.JSONDecodeError, UnicodeDecodeError):
            data = self.value
        if target is None:
            return data
        import dataclasses

        from ..http.request import BindError, bind_dataclass
        if dataclasses.is_dataclass(target) and isinstance(target, type):
            if not isinstance(data, dict):
                raise BindError(
                    f"cannot bind message to {target.__name__}")
            return bind_dataclass(data, target)
        return data

    def host_name(self) -> str:
        return self.topic
