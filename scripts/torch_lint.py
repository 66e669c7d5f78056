#!/usr/bin/env python
"""gofrlint for the PyTorch port: the repository's AST invariant checks
over ``gofr_tpu_torch/`` and the port's scripts.

    python scripts/torch_lint.py gofr_tpu_torch/ scripts/torch_*.py
    python scripts/torch_lint.py --format=json gofr_tpu_torch/serving/engine.py
    python scripts/torch_lint.py --rule hot-path-purity gofr_tpu_torch/
    python scripts/torch_lint.py --self-test    # seeded violations must fail

The counterpart of ``scripts/lint.py``, on the port's own copy of the
analyzer (``gofr_tpu_torch.analysis``), whose rules also know the
PyTorch spellings of a device sync, a pool cast and a ``torch.compile``
recompile. Exit codes: 0 clean (suppressed findings don't fail), 1
violations, 2 usage error. Imports only ``gofr_tpu_torch.analysis``
(stdlib ``ast``; never the code under analysis, never torch).
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO_ROOT))

from gofr_tpu_torch.analysis import RULE_IDS, run_analysis  # noqa: E402

# a deliberately rotten snippet in the port's idiom: one violation per
# rule, plus a reason-less allow. --self-test lints it and FAILS if the
# analyzer stops seeing any of them.
SELF_TEST_SNIPPET = '''\
import time
import torch
from gofr_tpu_torch.analysis import hot_path
from gofr_tpu_torch.ops.paged_kv import scatter_chunk_kv


@hot_path
def dispatch(state, logits):
    t0 = time.time()
    rows = state.tolist()
    n = int(torch.sum(logits))
    torch.cuda.synchronize()
    return rows, n, t0


class Pool:
    def locked_write(self, v):
        with self._lock:
            self._items = v

    def racy_write(self, v):
        self._items = v


async def agent_tick():
    time.sleep(0.1)


def serve(req, step):
    f = torch.compile(step)
    return f(req.tokens, len(req.tokens))


def write(kc, vc, tables, k, v):
    return scatter_chunk_kv(kc, vc, tables, k.to(kc.dtype), v.float())


def meter(metrics):
    metrics.increment_counter("app_never_registered_anywhere")


def hushed(metrics):
    metrics.set_gauge("app_also_never_registered", 1.0)  # gofrlint: allow(metric-hygiene)
'''

EXPECTED_SELF_TEST_RULES = set(RULE_IDS) | {"bad-suppression"}


def self_test() -> int:
    with tempfile.TemporaryDirectory() as td:
        bad = Path(td) / "rotten.py"
        bad.write_text(SELF_TEST_SNIPPET)
        findings, _ = run_analysis([bad], root=Path(td))
    hit = {f.rule for f in findings if not f.suppressed}
    missing = EXPECTED_SELF_TEST_RULES - hit
    if missing:
        print(f"gofrlint SELF-TEST FAILED: seeded violations not "
              f"detected for rule(s): {sorted(missing)}", file=sys.stderr)
        for f in findings:
            print("  " + f.render(), file=sys.stderr)
        return 1
    print(f"gofrlint self-test ok: {len(findings)} seeded findings "
          f"across {len(hit)} rules all detected")
    return 0


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="gofrlint", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("paths", nargs="*", help="files or directories to lint")
    ap.add_argument("--format", choices=("text", "json"), default="text")
    ap.add_argument("--rule", action="append", dest="rules",
                    metavar="RULE", help=f"restrict to a rule "
                    f"(repeatable); one of: {', '.join(RULE_IDS)}")
    ap.add_argument("--show-suppressed", action="store_true",
                    help="also print allow()'d findings with reasons")
    ap.add_argument("--list-rules", action="store_true")
    ap.add_argument("--self-test", action="store_true",
                    help="lint a seeded-violation snippet; exit nonzero "
                         "unless every rule fires")
    args = ap.parse_args(argv)

    if args.list_rules:
        for r in RULE_IDS:
            print(r)
        return 0
    if args.self_test:
        return self_test()
    if not args.paths:
        ap.error("no paths given")
    missing = [p for p in args.paths if not Path(p).exists()]
    if missing:
        ap.error(f"path(s) do not exist: {missing}")
    if args.rules:
        unknown = set(args.rules) - set(RULE_IDS)
        if unknown:
            ap.error(f"unknown rule(s): {sorted(unknown)}")

    findings, project = run_analysis(args.paths, rules=args.rules,
                                     root=REPO_ROOT)
    violations = [f for f in findings if not f.suppressed]
    suppressed = [f for f in findings if f.suppressed]

    if args.format == "json":
        print(json.dumps({
            "files": len(project.modules),
            "violations": [f.to_dict() for f in violations],
            "suppressed": [f.to_dict() for f in suppressed],
            "counts": _counts(violations),
        }, indent=2))
    else:
        for f in violations:
            print(f.render())
        if args.show_suppressed:
            for f in suppressed:
                print(f.render())
        tail = (f"{len(project.modules)} files, "
                f"{len(violations)} violation(s), "
                f"{len(suppressed)} allowed")
        print(("FAIL: " if violations else "ok: ") + tail)
    return 1 if violations else 0


def _counts(findings) -> dict[str, int]:
    out: dict[str, int] = {}
    for f in findings:
        out[f.rule] = out.get(f.rule, 0) + 1
    return dict(sorted(out.items()))


if __name__ == "__main__":
    sys.exit(main())
