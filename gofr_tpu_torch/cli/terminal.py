"""Terminal output: ANSI colors, cursor control, spinner, progress bar
(the port's copy of ``gofr_tpu/cli/terminal.py``).

Mirrors reference pkg/gofr/cmd/terminal/ (output.go:126-256): a small
TUI toolkit for CLI apps — colored writes, line/screen clearing, an
animated spinner, and a progress bar, all degrading to plain text when
the stream is not a TTY.
"""

from __future__ import annotations

import sys
import threading
import time
from typing import TextIO

RESET = "\x1b[0m"

_COLORS = {"black": 30, "red": 31, "green": 32, "yellow": 33, "blue": 34,
           "magenta": 35, "cyan": 36, "white": 37}

_SPINNER_FRAMES = "⠋⠙⠹⠸⠼⠴⠦⠧⠇⠏"


class Out:
    """The ``ctx.terminal`` object CLI handlers draw with."""

    def __init__(self, stream: TextIO | None = None,
                 force_tty: bool | None = None) -> None:
        self.stream = stream if stream is not None else sys.stdout
        if force_tty is not None:
            self.is_tty = force_tty
        else:
            self.is_tty = bool(getattr(self.stream, "isatty", lambda: False)())

    # ------------------------------------------------------------ writes
    def write(self, text: str) -> None:
        # `tool help | head` closes the pipe mid-output; exit quietly
        # like every well-behaved CLI instead of tracebacking
        try:
            self.stream.write(text)
        except BrokenPipeError:
            raise SystemExit(0)

    def print(self, *values: object, sep: str = " ", end: str = "\n") -> None:
        self.write(sep.join(str(v) for v in values) + end)

    def println(self, *values: object) -> None:
        self.print(*values)

    def printf(self, fmt: str, *args: object) -> None:
        self.write(fmt % args if args else fmt)

    def _colored(self, text: str, code: int) -> str:
        if not self.is_tty:
            return text
        return f"\x1b[{code}m{text}{RESET}"

    def color(self, text: str, name: str) -> str:
        return self._colored(text, _COLORS.get(name.lower(), 37))

    def bold(self, text: str) -> str:
        return self._colored(text, 1)

    # convenience like the reference's per-color helpers
    def green(self, text: str) -> str:
        return self.color(text, "green")

    def red(self, text: str) -> str:
        return self.color(text, "red")

    def yellow(self, text: str) -> str:
        return self.color(text, "yellow")

    def cyan(self, text: str) -> str:
        return self.color(text, "cyan")

    # ---------------------------------------------------- cursor control
    def clear_line(self) -> None:
        if self.is_tty:
            self.stream.write("\r\x1b[2K")

    def clear_screen(self) -> None:
        if self.is_tty:
            self.stream.write("\x1b[2J\x1b[H")

    def move_cursor_up(self, n: int = 1) -> None:
        if self.is_tty:
            self.stream.write(f"\x1b[{n}A")

    def hide_cursor(self) -> None:
        if self.is_tty:
            self.stream.write("\x1b[?25l")

    def show_cursor(self) -> None:
        if self.is_tty:
            self.stream.write("\x1b[?25h")

    # ----------------------------------------------------------- widgets
    def spinner(self, message: str = "") -> "Spinner":
        return Spinner(self, message)

    def progress_bar(self, total: int, width: int = 40) -> "ProgressBar":
        return ProgressBar(self, total, width)


class Spinner:
    """Animated while a with-block runs; single line on non-TTYs."""

    def __init__(self, out: Out, message: str = "",
                 interval: float = 0.08) -> None:
        self.out = out
        self.message = message
        self.interval = interval
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def __enter__(self) -> "Spinner":
        if self.out.is_tty:
            self.out.hide_cursor()
            self._thread = threading.Thread(target=self._spin, daemon=True)
            self._thread.start()
        else:
            self.out.print(f"{self.message}...")
        return self

    def _spin(self) -> None:
        i = 0
        while not self._stop.is_set():
            frame = _SPINNER_FRAMES[i % len(_SPINNER_FRAMES)]
            self.out.write(f"\r{frame} {self.message}")
            self.out.stream.flush()
            i += 1
            time.sleep(self.interval)

    def __exit__(self, *exc) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(1)
        if self.out.is_tty:
            self.out.clear_line()
            self.out.show_cursor()


class ProgressBar:
    """``[████----] 42%`` on TTYs; milestone lines otherwise."""

    def __init__(self, out: Out, total: int, width: int = 40) -> None:
        self.out = out
        self.total = max(total, 1)
        self.width = width
        self.current = 0
        self._last_printed_pct = -10

    def increment(self, n: int = 1) -> None:
        self.set(self.current + n)

    def set(self, value: int) -> None:
        self.current = min(value, self.total)
        pct = 100 * self.current // self.total
        if self.out.is_tty:
            filled = self.width * self.current // self.total
            bar = "█" * filled + "-" * (self.width - filled)
            self.out.write(f"\r[{bar}] {pct:3d}%")
            if self.current >= self.total:
                self.out.write("\n")
            self.out.stream.flush()
        elif pct >= self._last_printed_pct + 10 or self.current >= self.total:
            self._last_printed_pct = pct
            self.out.print(f"progress: {pct}%")
