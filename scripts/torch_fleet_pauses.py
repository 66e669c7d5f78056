#!/usr/bin/env python3
"""``chip_smoke.py``'s ``serve_fleet`` phase, run again and again, with
the heartbeat timing the leader and the agents see, and optionally with
pauses of the whole process injected while the fleet is up:

    python scripts/torch_fleet_pauses.py --runs 2
    python scripts/torch_fleet_pauses.py --runs 2 --holds 3 --hold-s 0.8
    python scripts/torch_fleet_pauses.py --root <other checkout> --holds 3

A hold is one C call that keeps the GIL (``sum(range(n))``, ``n``
calibrated to ``--hold-s``), as a long collection or a profiler start
does: every thread of the process, the three workers' agents and the
leader's sweeper alike, stops for its length. The holds start once the
leader has three members, ``--hold-gap-s`` apart. ``--root``: the
checkout whose ``chip_smoke.py`` and ``gofr_tpu_torch`` run (parent and
change in one call: one process each, same card). The kernels are
built first (``chip_smoke.phase_build``).

One JSON line a run, after the card's ``nvidia-smi`` name and power
limit: whether the phase passed, its failed checks, the leader's
evictions by reason, per host the longest gap between two heartbeats
the leader received and the longest beat of its agent (body, POST and
answer), the longest lateness of a 5 ms sleep on a probe thread (how
long the process stood still), the holds made, and the phase's wall.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import collections
import json
import subprocess
import sys
import threading
import time
from pathlib import Path


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve()
                                          .parents[1]))
    ap.add_argument("--runs", type=int, default=2)
    ap.add_argument("--holds", type=int, default=0)
    ap.add_argument("--hold-s", type=float, default=0.8)
    ap.add_argument("--hold-gap-s", type=float, default=1.5)
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import chip_smoke
    import gofr_tpu_torch.serving.app as app
    from gofr_tpu_torch.device import resolve_device
    from gofr_tpu_torch.serving import control_plane as cp

    arrivals = collections.defaultdict(list)
    beats = collections.defaultdict(list)
    leaders: list = []

    leader_heartbeat = cp.ControlPlaneLeader.heartbeat

    def heartbeat(self, host_id, *a, **k):
        if leaders and self is leaders[0]:
            arrivals[host_id].append(time.time())
        return leader_heartbeat(self, host_id, *a, **k)

    agent_beat = cp.WorkerAgent._heartbeat_once

    def beat(self):
        t0 = time.time()
        try:
            return agent_beat(self)
        finally:
            beats[self.host_id].append(time.time() - t0)

    serve_fleet_leader = app.serve_fleet_leader

    def serve_leader(*a, **k):
        server = serve_fleet_leader(*a, **k)
        leaders.append(server.leader)
        return server

    cp.ControlPlaneLeader.heartbeat = heartbeat
    cp.WorkerAgent._heartbeat_once = beat
    app.serve_fleet_leader = serve_leader

    late: list = []
    done = threading.Event()

    def probe():
        while not done.is_set():
            t0 = time.perf_counter()
            time.sleep(0.005)
            late.append(time.perf_counter() - t0 - 0.005)

    def hold(per_s: float, made: list, t0: float) -> None:
        while not leaders or len(leaders[0].topology()["members"]) < 3:
            time.sleep(0.01)
        for _ in range(args.holds):
            time.sleep(args.hold_gap_s)
            t = time.perf_counter()
            sum(range(int(per_s * args.hold_s)))
            made.append({"at_s": time.time() - t0,
                         "held_s": time.perf_counter() - t})

    dev = resolve_device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[0]
    chip_smoke.phase_build()
    print(smi, flush=True)
    t = time.perf_counter()
    sum(range(10**6))
    per_s = 10**6 / (time.perf_counter() - t)
    threading.Thread(target=probe, daemon=True).start()
    failures = 0
    for run in range(args.runs):
        arrivals.clear()
        beats.clear()
        leaders.clear()
        late.clear()
        made: list = []
        t0 = time.time()
        if args.holds:
            threading.Thread(target=hold, args=(per_s, made, t0),
                             daemon=True).start()
        error = None
        try:
            chip_smoke.phase_serve_fleet(dev, smi)
        except AssertionError as exc:
            error = str(exc)
            failures += 1
        leader = leaders[0] if leaders else None
        evictions = {} if leader is None else {
            s["labels"].get("reason"): s["value"] for s in
            leader.metrics.snapshot()["metrics"]["app_fleet_evictions"]
            ["series"]}
        print(json.dumps({
            "run": run, "root": str(root), "passed": error is None,
            "error": error, "evictions": evictions,
            "max_gap_s": {h: max((b - a for a, b in zip(v, v[1:])),
                                 default=None)
                          for h, v in sorted(arrivals.items())},
            "max_beat_s": {h: max(v) for h, v in sorted(beats.items())},
            "process_still_max_s": max(late, default=None),
            "holds": made, "wall_s": time.time() - t0}), flush=True)
    done.set()
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
