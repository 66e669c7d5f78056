"""CLI argv as a Request: flags become params, positionals route (the
port's copy of ``gofr_tpu/cli/request.py``).

Mirrors reference pkg/gofr/cmd/request.go (arg binder) and
cmd.go:64-89 (parsing): ``-k=v``, ``--k=v``, and bare ``-flag``
(true), with everything before the first flag treated as the
subcommand path. Values require ``=`` — ``--flag value`` is a bare
flag plus a stray arg, exactly as in the reference, which keeps
``tool deploy --verbose prod`` unambiguous.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

from ..http.request import bind_dataclass


def parse_args(argv: list[str]) -> tuple[list[str], dict[str, list[str]]]:
    """argv (no program name) -> (positional path, flag multimap)."""
    positionals: list[str] = []
    flags: dict[str, list[str]] = {}
    i = 0
    seen_flag = False
    while i < len(argv):
        arg = argv[i]
        if arg.startswith("-") and arg not in ("-", "--"):
            seen_flag = True
            name = arg.lstrip("-")
            if "=" in name:
                name, _, value = name.partition("=")
                flags.setdefault(name, []).append(value)
            else:
                flags.setdefault(name, []).append("true")
        elif not seen_flag:
            positionals.append(arg)
        else:
            flags.setdefault("_args", []).append(arg)
        i += 1
    return positionals, flags


class CMDRequest:
    """Request implementation over parsed argv."""

    def __init__(self, argv: list[str]) -> None:
        self.argv = list(argv)
        self.positionals, self.flags = parse_args(argv)
        self.subcommand = " ".join(self.positionals)

    def param(self, key: str) -> str:
        values = self.flags.get(key)
        return values[0] if values else ""

    def params(self, key: str) -> list[str]:
        out: list[str] = []
        for v in self.flags.get(key, []):
            out.extend(p for p in v.split(",") if p != "")
        return out

    def path_param(self, key: str) -> str:
        return self.param(key)

    def host_name(self) -> str:
        import socket
        return socket.gethostname()

    def header(self, key: str) -> str:
        return ""

    def bind(self, target: Any = None) -> Any:
        """Flags -> dict or dataclass (the reflection binder analog).
        Hyphenated flag names map to underscore field names
        (``--dry-run`` binds ``dry_run``)."""
        data: dict[str, Any] = {k.replace("-", "_"): v[0] if len(v) == 1 else v
                                for k, v in self.flags.items()}
        if target is None:
            return data
        if dataclasses.is_dataclass(target) and isinstance(target, type):
            return bind_dataclass(data, target)
        return data
