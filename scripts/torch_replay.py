"""Replay a captured workload file through a local engine of the
PyTorch port (``gofr_tpu_torch``): ``scripts/replay.py`` over the port.

Usage:
    python scripts/torch_replay.py WORKLOAD.jsonl [--speed N]
                             [--closed-loop C] [--seed S] [--max-batch B]
                             [--max-seq L] [--events EVENTS.jsonl]
                             [--report OUT.json] [--no-fail]
                             [--device cuda|cpu]

Downloads from a live server land here:
    curl -s http://host:8000/debug/workload > incident.jsonl
    curl -s http://host:8000/debug/events   > incident-events.jsonl
    python scripts/torch_replay.py incident.jsonl \
        --events incident-events.jsonl

Builds the demo tiny-llama engine (``serving.glue.demo_llama_engine``)
with the workload header's ``engine_seed`` unless ``--seed`` overrides
it, re-injects the workload with original
inter-arrival timing (``--speed N`` compresses it, ``--closed-loop C``
ignores timing and keeps C in flight), and prints the divergence +
latency report JSON. Greedy requests must replay bit-identically when
the engine matches the capture (same model weights/config/seed);
exits 2 on any divergence unless ``--no-fail``. The engine runs on
``--device`` (default ``cuda``; ``cpu`` only when asked for).

For a production model, call ``gofr_tpu_torch.serving.replay.replay_file``
against your own engine instead: it is model-agnostic.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("workload", help="workload JSONL file "
                    "(GET /debug/workload)")
    ap.add_argument("--speed", type=float, default=1.0,
                    help="inter-arrival compression factor (default 1)")
    ap.add_argument("--closed-loop", type=int, default=0, metavar="C",
                    help="ignore timing; keep C requests in flight")
    ap.add_argument("--seed", type=int, default=None,
                    help="override the header's engine_seed")
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=256)
    ap.add_argument("--timeout", type=float, default=300.0)
    ap.add_argument("--events", default=None, metavar="EVENTS.jsonl",
                    help="event-ledger capture recorded alongside the "
                         "workload (GET /debug/events); the report "
                         "gains an event-timeline diff")
    ap.add_argument("--report", default=None,
                    help="also write the report JSON to this path")
    ap.add_argument("--no-fail", action="store_true",
                    help="exit 0 even when streams diverged")
    ap.add_argument("--device", default="cuda",
                    help="the engine's device (default cuda)")
    args = ap.parse_args()

    from gofr_tpu_torch.serving.engine import EngineConfig
    from gofr_tpu_torch.serving.glue import demo_llama_engine
    from gofr_tpu_torch.serving.replay import (load_events, load_workload,
                                               replay_workload)

    workload = load_workload(args.workload)
    events = load_events(args.events) if args.events else None
    header = workload["header"]
    seed = args.seed if args.seed is not None \
        else header.get("engine_seed")
    print(f"# workload: {len(workload['records'])} records, "
          f"engine_seed={header.get('engine_seed')}, "
          f"redacted={header.get('redacted')}", file=sys.stderr)
    engine = demo_llama_engine(EngineConfig(
        max_batch=args.max_batch, max_seq=args.max_seq,
        seed=seed if seed is not None else 0), device=args.device)
    try:
        report = replay_workload(engine, workload, speed=args.speed,
                                 closed_loop=args.closed_loop,
                                 timeout_s=args.timeout, events=events)
    finally:
        engine.stop()
    text = json.dumps(report, indent=2, default=str)
    print(text)
    if args.report:
        with open(args.report, "w") as f:
            f.write(text + "\n")
    for div in report.get("efficiency_divergence") or []:
        # advisory, not an exit condition: replay hardware/config may
        # legitimately differ — but a doubled waste share is worth a
        # line even when every token matched
        print(f"# EFFICIENCY DIVERGED: {div['cause']} waste share "
              f"{div['recorded_share']:.1%} -> "
              f"{div['replayed_share']:.1%}", file=sys.stderr)
    for div in report.get("cost_divergence") or []:
        # advisory too: replay hardware legitimately differs from the
        # capture host, but a single signature's pass cost doubling
        # while the rest hold is a kernel regression with a name
        print(f"# COST DIVERGED: {div['signature']} mean pass "
              f"{div['recorded_mean_s'] * 1e3:.3f}ms -> "
              f"{div['replayed_mean_s'] * 1e3:.3f}ms "
              f"(x{div['ratio']})", file=sys.stderr)
    for div in report.get("digest_divergence") or []:
        # advisory like the others — NEVER an exit condition: a digest
        # mismatch with matching tokens means the fingerprint inputs
        # drifted (params quantization, digest version), which would
        # make golden probes sealed from this capture misfire
        match = "tokens matched" if div.get("tokens_match") \
            else "tokens also diverged"
        print(f"# DIGEST DIVERGED: request {div['index']} "
              f"{div['recorded'][:12]}... -> {div['replayed'][:12]}... "
              f"({match})", file=sys.stderr)
    ev_div = report.get("event_divergence")
    if ev_div and ev_div.get("diverged"):
        # advisory like the efficiency diff: replay timing legitimately
        # shifts some events, but a new kind (engine.restart where the
        # capture had none) deserves a line even when tokens matched
        for kind in ev_div.get("kinds_extra") or []:
            print(f"# EVENTS DIVERGED: replay emitted {kind} the "
                  "capture never saw", file=sys.stderr)
        for kind in ev_div.get("kinds_missing") or []:
            print(f"# EVENTS DIVERGED: capture's {kind} never fired "
                  "in replay", file=sys.stderr)
        for kind, cnt in (ev_div.get("count_divergence") or {}).items():
            print(f"# EVENTS DIVERGED: {kind} x{cnt['recorded']} -> "
                  f"x{cnt['replayed']}", file=sys.stderr)
    if report["divergent"] and not args.no_fail:
        print(f"# DIVERGED: {report['divergent']} request(s)",
              file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
