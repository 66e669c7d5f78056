"""CLI application: subcommand routing on the same Handler model (the
port's copy of ``gofr_tpu/cli/cmd.py``).

Mirrors reference pkg/gofr/cmd.go + factory.go:81 (NewCMD): parse argv,
prefix-match a registered subcommand route (cmd.go:121-134), build a
Context whose Request is the argv and whose terminal is attached, run
the handler, print the result (cmd/responder.go). Includes the help
system (cmd.go:137-200): ``help`` / ``-h`` / unknown command lists
every subcommand with its description and usage.
"""

from __future__ import annotations

import asyncio
import json
import sys
from dataclasses import dataclass, field
from typing import Any, Callable

from ..config.env import EnvConfig
from ..container.container import Container
from ..context import Context
from .request import CMDRequest
from .terminal import Out


@dataclass
class SubCommand:
    pattern: str
    handler: Callable
    description: str = ""
    help_text: str = ""
    segments: list[str] = field(default_factory=list)

    def __post_init__(self) -> None:
        self.segments = self.pattern.split()


class CMDResponder:
    """Result -> stdout, error -> stderr (reference cmd/responder.go)."""

    def __init__(self, out: Out, err_out: Out) -> None:
        self.out = out
        self.err = err_out

    def respond(self, result: Any, error: Exception | None) -> int:
        if error is not None:
            self.err.print(self.err.red(f"error: {error}"))
            return 1
        if result is None:
            return 0
        if isinstance(result, str):
            self.out.print(result)
        elif isinstance(result, (bytes, bytearray)):
            self.out.stream.write(result.decode("utf-8", "replace"))
        else:
            self.out.print(json.dumps(result, indent=2, default=str))
        return 0


class CMDApp:
    """``new_cmd()`` application (reference factory.go:81): no servers,
    same Context/handler surface, argv in place of HTTP."""

    def __init__(self, config_dir: str = "configs", config=None) -> None:
        self.config = config if config is not None else EnvConfig(config_dir)
        self.container = Container.create(self.config)
        self.logger = self.container.logger
        self._subcommands: list[SubCommand] = []
        self.out = Out()
        self.err_out = Out(stream=sys.stderr)

    # ------------------------------------------------------ registration
    def sub_command(self, pattern: str, handler: Callable | None = None, *,
                    description: str = "", help: str = ""):
        """Register (decorator or direct) a subcommand
        (reference gofr.go:228 SubCommand)."""
        if handler is None:
            def decorator(fn: Callable) -> Callable:
                self.sub_command(pattern, fn, description=description,
                                 help=help)
                return fn
            return decorator
        self._subcommands.append(SubCommand(
            pattern=pattern, handler=handler, description=description,
            help_text=help))
        return handler

    # ------------------------------------------------------------ routing
    def _match(self, positionals: list[str]) -> SubCommand | None:
        """Longest-prefix match over registered patterns
        (reference cmd.go:121-134)."""
        best: SubCommand | None = None
        for sub in self._subcommands:
            n = len(sub.segments)
            if positionals[:n] == sub.segments:
                if best is None or n > len(best.segments):
                    best = sub
        return best

    def _print_help(self) -> None:
        name = self.container.app_name
        self.out.print(self.out.bold(f"{name} — available commands:"))
        width = max((len(s.pattern) for s in self._subcommands), default=0)
        for sub in sorted(self._subcommands, key=lambda s: s.pattern):
            line = f"  {sub.pattern:<{width}}  {sub.description}"
            self.out.print(line.rstrip())
            if sub.help_text:
                self.out.print(f"  {'':<{width}}  {sub.help_text}")
        self.out.print("  help" + " " * max(width - 4, 0) +
                       "  show this message")

    # ---------------------------------------------------------- execution
    def run(self, argv: list[str] | None = None) -> int:
        """Parse argv and execute; returns the process exit code
        (reference cmd.Run, cmd.go:37-61)."""
        argv = list(sys.argv[1:]) if argv is None else list(argv)
        request = CMDRequest(argv)

        wants_help = (request.subcommand in ("help", "") or
                      request.param("h") == "true" or
                      request.param("help") == "true")
        sub = self._match(request.positionals)
        if wants_help or sub is None:
            # -h/--help always shows help, matched subcommand or not
            self._print_help()
            return 0 if wants_help else 2

        responder = CMDResponder(self.out, self.err_out)
        ctx = Context(request=request, container=self.container,
                      responder=responder, terminal=self.out)
        try:
            result = sub.handler(ctx)
            if hasattr(result, "__await__"):
                async def _drain_then_run(coro):
                    # async-connect stores (NATS/MQTT pubsub) defer until
                    # a loop exists; CLI apps get one per async handler
                    await self.container.connect_async()
                    return await coro
                result = asyncio.run(_drain_then_run(result))
            return responder.respond(result, None)
        except Exception as exc:
            self.logger.debug(f"subcommand {sub.pattern!r} failed: {exc!r}")
            return responder.respond(None, exc)
