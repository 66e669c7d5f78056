"""HTTP router with ``{param}`` path segments and static file serving
(the port's copy of ``gofr_tpu/http/router.py``).

The role of the reference's gorilla/mux wrapper (pkg/gofr/http/router.go:24-59):
register method+pattern pairs, match incoming paths extracting params,
report 405 vs 404 correctly, serve static directories with the same
restricted-file and permission checks (router.go:66-166).
"""

from __future__ import annotations

import mimetypes
import os
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable

RESTRICTED_FILES = {".env", ".htaccess", ".htpasswd", ".git", ".gitignore",
                    "id_rsa", "id_dsa"}


@dataclass
class Route:
    method: str
    pattern: str
    handler: Callable
    segments: list[str] = field(default_factory=list)

    def __post_init__(self) -> None:
        self.segments = [s for s in self.pattern.strip("/").split("/") if s != ""]


@dataclass
class StaticMount:
    url_prefix: str
    directory: str


class Router:
    def __init__(self) -> None:
        self._routes: list[Route] = []
        self._static: list[StaticMount] = []

    # -- registration
    def add(self, method: str, pattern: str, handler: Callable) -> Route:
        route = Route(method=method.upper(), pattern=pattern, handler=handler)
        self._routes.append(route)
        return route

    def add_static(self, url_prefix: str, directory: str) -> None:
        self._static.append(StaticMount(url_prefix.rstrip("/"), directory))

    @property
    def routes(self) -> list[Route]:
        return list(self._routes)

    def registered_methods_for(self, path: str) -> list[str]:
        methods = []
        for route in self._routes:
            if self._match_segments(route, path) is not None:
                methods.append(route.method)
        return sorted(set(methods))

    def registered_paths(self) -> list[str]:
        return sorted({r.pattern for r in self._routes})

    # -- matching
    @staticmethod
    def _match_segments(route: Route, path: str) -> dict[str, str] | None:
        parts = [p for p in path.strip("/").split("/") if p != ""]
        if len(parts) != len(route.segments):
            return None
        params: dict[str, str] = {}
        for seg, part in zip(route.segments, parts):
            if seg.startswith("{") and seg.endswith("}"):
                params[seg[1:-1]] = part
            elif seg != part:
                return None
        return params

    def match(self, method: str, path: str) -> tuple[Route, dict[str, str]] | None:
        method = method.upper()
        for route in self._routes:
            params = self._match_segments(route, path)
            if params is not None and route.method == method:
                return route, params
        # HTTP/1.1: HEAD is answered by GET handlers (the server strips
        # the body via head_only)
        if method == "HEAD":
            return self.match("GET", path)
        return None

    # -- static files (reference router.go:66-166 checks)
    def match_static(self, path: str) -> tuple[str, bytes, str] | None:
        """Return (status-reason, content, content_type) for a static hit."""
        for mount in self._static:
            if not (path == mount.url_prefix or path.startswith(mount.url_prefix + "/")):
                continue
            rel = path[len(mount.url_prefix):].lstrip("/") or "index.html"
            base = Path(mount.directory).resolve()
            target = (base / rel).resolve()
            # path traversal guard
            if not str(target).startswith(str(base) + os.sep) and target != base:
                return self._static_404(base)
            # every component is checked so files inside restricted
            # directories (.git/config etc.) can't be served
            rel_parts = target.relative_to(base).parts if target != base else ()
            if any(part in RESTRICTED_FILES for part in rel_parts):
                return self._static_404(base)
            if target.is_dir():
                target = target / "index.html"
            if not target.is_file():
                return self._static_404(base)
            if not os.access(target, os.R_OK):
                return ("403", b"access denied", "text/plain")
            ctype = mimetypes.guess_type(str(target))[0] or "application/octet-stream"
            return ("200", target.read_bytes(), ctype)
        return None

    @staticmethod
    def _static_404(base: Path) -> tuple[str, bytes, str]:
        fallback = base / "404.html"
        if fallback.is_file():
            return ("404", fallback.read_bytes(), "text/html")
        return ("404", b"404 not found", "text/plain")
