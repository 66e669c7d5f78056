"""Rule ``blocking-in-async`` (the port's copy of
``gofr_tpu/analysis/rules/async_blocking.py``).

``async def`` bodies (engine loop glue, control-plane agents, the
websocket path) must not stall the event loop: no ``time.sleep``, no
synchronous ``requests``/``urllib`` HTTP, no blocking socket setup, no
``subprocess`` waits, no bare builtin ``open()`` (use a thread
offload or the async file helpers). Nested *sync* ``def``s inside an
async function are skipped — they may legitimately run in an executor
— but nested async defs are scanned.
"""

from __future__ import annotations

import ast

from ..core import Finding, Project, canonical_call, import_aliases

RULE_ID = "blocking-in-async"

BLOCKING_CALLS = {
    "time.sleep": "time.sleep() stalls the event loop — await asyncio.sleep",
    "urllib.request.urlopen": "synchronous HTTP in async code",
    "socket.create_connection": "blocking socket connect in async code",
    "subprocess.run": "subprocess wait blocks the event loop",
    "subprocess.call": "subprocess wait blocks the event loop",
    "subprocess.check_call": "subprocess wait blocks the event loop",
    "subprocess.check_output": "subprocess wait blocks the event loop",
    "os.system": "os.system blocks the event loop",
}
BLOCKING_PREFIXES = {
    "requests.": "synchronous 'requests' HTTP in async code",
}
OPEN_MSG = ("builtin open() is synchronous file IO — offload to a "
            "thread (asyncio.to_thread) or do it before going async")


class _AsyncScanner(ast.NodeVisitor):
    """Walk one async function's body without descending into nested
    sync defs (executor-bound) or nested async defs (scanned on their
    own by the module walk)."""

    def __init__(self, mod, fn: ast.AsyncFunctionDef,
                 aliases: dict[str, str]) -> None:
        self.mod = mod
        self.fn = fn
        self.aliases = aliases
        self.findings: list[Finding] = []

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        return

    def visit_AsyncFunctionDef(self, node: ast.AsyncFunctionDef) -> None:
        if node is not self.fn:
            return
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call) -> None:
        name = canonical_call(node, self.aliases)
        msg = None
        if name is not None:
            msg = BLOCKING_CALLS.get(name)
            if msg is None:
                for prefix, pmsg in BLOCKING_PREFIXES.items():
                    if name.startswith(prefix):
                        msg = pmsg
                        break
        if msg is None and isinstance(node.func, ast.Name) \
                and node.func.id == "open":
            msg = OPEN_MSG
        if msg is not None:
            self.findings.append(Finding(
                RULE_ID, self.mod.rel, node.lineno, node.col_offset,
                f"{msg} (in 'async def {self.fn.name}')"))
        self.generic_visit(node)


def run(project: Project, graph=None) -> list[Finding]:
    findings: list[Finding] = []
    for mod in project.modules:
        aliases = import_aliases(mod.tree)
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.AsyncFunctionDef):
                scanner = _AsyncScanner(mod, node, aliases)
                scanner.visit(node)
                findings.extend(scanner.findings)
    return findings
