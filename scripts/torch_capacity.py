"""Replay-driven capacity estimator for the PyTorch port
(``gofr_tpu_torch``): max sustainable concurrency before the SLO burn
rate trips; ``scripts/capacity.py`` over the port.

Usage:
    python scripts/torch_capacity.py WORKLOAD.jsonl
        [--levels 1,2,4,8,16] [--seed S] [--max-batch B] [--max-seq L]
        [--ttft-s 2.0] [--tpot-s 0.5] [--e2e-s 30] [--availability A]
        [--timeout T] [--report OUT.json] [--json SETPOINT.json]
        [--device cuda|cpu]

Replays a captured workload (``GET /debug/workload``) through a local
engine at increasing ``--closed-loop`` concurrency. At each level the
SLO tracker and the goodput meter start clean; after the level drains,
the script records throughput (QPS, tok/s), the goodput ratio and
waste breakdown, and the fast-burn state. The sweep stops at the first
level whose fast-burn trips; the report names the last sustainable
level — the admission-control baseline a scheduler can enforce — plus
the full goodput-vs-load curve (watch padding fall and bubble/preempt
waste rise as the batch saturates).

The engine is the demo tiny-llama family (same as
scripts/torch_replay.py) on ``--device`` (default ``cuda``; ``cpu``
only when asked for); for a production model call :func:`sweep` against
your own engine. The ``--json`` setpoint file is what the port's router
reads (``RouterConfig(setpoint_file=)``).
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def run_level(engine, workload, level: int, slo_config,
              timeout_s: float = 300.0) -> dict:
    """One closed-loop replay at ``level`` in-flight requests with a
    fresh SLO tracker + goodput meter; returns the level's digest."""
    from gofr_tpu_torch.serving.observability import SLOTracker
    from gofr_tpu_torch.serving.replay import replay_workload

    engine.slo = SLOTracker(slo_config)
    report = replay_workload(engine, workload, closed_loop=level,
                             timeout_s=timeout_s)
    slo_state = report.get("slo") or {}
    fast = slo_state.get("fast_burn") or {}
    goodput = report.get("replayed_goodput") or {}
    ok = report["submitted"] - report.get("replay_errors", 0)
    wall = max(report.get("wall_s") or 0.0, 1e-9)
    return {
        "concurrency": level,
        "qps": round(ok / wall, 3),
        "wall_s": report.get("wall_s"),
        "requests_ok": ok,
        "replay_errors": report.get("replay_errors", 0),
        "latency": report.get("replayed_latency"),
        "goodput_ratio": goodput.get("goodput_ratio"),
        "waste_s": goodput.get("waste_s"),
        "busy_s": goodput.get("busy_s"),
        "burn_rate": fast.get("burn_rate"),
        "burn_window": fast.get("window"),
        "tripped": bool(fast.get("tripped")),
    }


def pick_max_sustainable(levels: list[dict]) -> dict | None:
    """The highest untripped level BELOW the first trip (the sweep is
    monotone in offered load, so everything past the first trip is
    over capacity even if a later level happened to squeak by)."""
    best = None
    for entry in levels:
        if entry.get("tripped"):
            break
        best = entry
    return best


def sweep(engine, workload, levels, slo_config,
          timeout_s: float = 300.0, log=print) -> dict:
    """Run the concurrency ladder; stops after the first tripped
    level (it is the capacity boundary — higher levels only burn
    time past it)."""
    curve: list[dict] = []
    for level in levels:
        entry = run_level(engine, workload, level, slo_config,
                          timeout_s=timeout_s)
        curve.append(entry)
        log(f"# closed-loop {level}: {entry['qps']} req/s, "
            f"goodput={entry['goodput_ratio']}, "
            f"burn={entry['burn_rate']} "
            f"({'TRIPPED' if entry['tripped'] else 'ok'})")
        if entry["tripped"]:
            break
    best = pick_max_sustainable(curve)
    return {
        "levels": curve,
        "max_sustainable": best,
        "max_sustainable_concurrency":
            best["concurrency"] if best else 0,
        "max_sustainable_qps": best["qps"] if best else 0.0,
        "tripped_at": next((e["concurrency"] for e in curve
                            if e["tripped"]), None),
    }


def setpoint_doc(result: dict) -> dict:
    """The ``--json`` setpoint file: the exact subset the router
    autoscaler (``RouterConfig.setpoint_file``) and CI consume —
    stable keys, no stdout scraping."""
    return {
        "max_concurrency": result.get("max_sustainable_concurrency", 0),
        "qps": result.get("max_sustainable_qps", 0.0),
        "tripped_at": result.get("tripped_at"),
        "levels": [
            {"concurrency": e.get("concurrency"),
             "qps": e.get("qps"),
             "goodput_ratio": e.get("goodput_ratio"),
             "tripped": bool(e.get("tripped"))}
            for e in result.get("levels", [])
        ],
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("workload", help="workload JSONL file "
                    "(GET /debug/workload)")
    ap.add_argument("--levels", default="1,2,4,8,16",
                    help="comma-separated closed-loop concurrency "
                    "ladder (default 1,2,4,8,16)")
    ap.add_argument("--seed", type=int, default=None,
                    help="override the header's engine_seed")
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=256)
    ap.add_argument("--ttft-s", type=float, default=2.0)
    ap.add_argument("--tpot-s", type=float, default=0.5)
    ap.add_argument("--e2e-s", type=float, default=30.0)
    ap.add_argument("--availability", type=float, default=0.999)
    ap.add_argument("--timeout", type=float, default=300.0,
                    help="per-level replay timeout")
    ap.add_argument("--report", default=None,
                    help="also write the report JSON to this path")
    ap.add_argument("--json", dest="setpoint", default=None,
                    metavar="OUT",
                    help="write a machine-readable setpoint file "
                    "(max_concurrency, qps, per-level goodput) for "
                    "the router autoscaler and CI")
    ap.add_argument("--device", default="cuda",
                    help="the engine's device (default cuda)")
    args = ap.parse_args()

    try:
        levels = sorted({int(x) for x in args.levels.split(",")
                         if x.strip()})
        assert levels and all(lv > 0 for lv in levels)
    except (ValueError, AssertionError):
        print(f"capacity: bad --levels {args.levels!r}", file=sys.stderr)
        return 2

    from gofr_tpu_torch.serving.engine import EngineConfig
    from gofr_tpu_torch.serving.glue import demo_llama_engine
    from gofr_tpu_torch.serving.observability import SLOConfig
    from gofr_tpu_torch.serving.replay import load_workload

    workload = load_workload(args.workload)
    header = workload["header"]
    if header.get("redacted"):
        print("capacity: redacted workloads are not replayable",
              file=sys.stderr)
        return 2
    seed = args.seed if args.seed is not None \
        else header.get("engine_seed")
    print(f"# workload: {len(workload['records'])} records, "
          f"levels={levels}", file=sys.stderr)
    engine = demo_llama_engine(EngineConfig(
        max_batch=args.max_batch, max_seq=args.max_seq,
        seed=seed if seed is not None else 0), device=args.device)
    slo_config = SLOConfig(ttft_s=args.ttft_s, tpot_s=args.tpot_s,
                           e2e_s=args.e2e_s,
                           availability=args.availability)
    # warm every prompt shape first: a cold graph capture on level 1
    # would bill seconds of TTFT to the SLO and trip the burn gate on
    # the capture, not capacity (it also seals the recompile sentinel)
    lens = sorted({len(r.get("prompt_tokens") or [])
                   for r in workload["records"]
                   if r.get("prompt_tokens")})
    if lens:
        print(f"# warmup over {len(lens)} prompt lengths",
              file=sys.stderr)
        engine.warmup(prompt_lens=tuple(lens), chunked=True)
    try:
        result = sweep(engine, workload, levels, slo_config,
                       timeout_s=args.timeout,
                       log=lambda msg: print(msg, file=sys.stderr))
    finally:
        engine.stop()
    result["workload"] = {"records": len(workload["records"]),
                          "engine_seed": header.get("engine_seed")}
    result["slo"] = {"ttft_s": args.ttft_s, "tpot_s": args.tpot_s,
                     "e2e_s": args.e2e_s,
                     "availability": args.availability}
    text = json.dumps(result, indent=2, default=str)
    print(text)
    if args.report:
        with open(args.report, "w") as f:
            f.write(text + "\n")
    if args.setpoint:
        with open(args.setpoint, "w") as f:
            json.dump(setpoint_doc(result), f, indent=2)
            f.write("\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
