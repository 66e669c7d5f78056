"""Worker process of ``tests/test_torch_multihost.py``.

Runs as an OS process (``python tests/torch_tp_worker.py``): joins the
port's control-plane leader over HTTP, waits until the group has
``GOFR_EXPECT_WORLD`` members, then hands off exactly as a serving host
does: ``control_plane.tp_engine(assignment, ...)`` joins
``torch.distributed`` with the leader-issued rank (``gloo``, on the CPU)
and builds the tensor-parallel engine on a ``{"tp": world}`` mesh. Rank
0 serves a greedy decode of the scenario's prompt and prints its tokens;
every other rank follows. Then rank 0 creates ``die_flag``; a follower
exits at its next decode launch, as a host that dies mid-pass, and rank
0 prints what became of the request it was serving (the error and the
seconds it took).

The scenario (weights as numpy, prompt, steps, cache rows, timeout)
comes pickled from the file ``GOFR_TP_PAYLOAD``. Imports torch, numpy
and the port only.
"""

import json
import os
import pickle
import sys
import time


def emit(**kw):
    print("EV " + json.dumps(kw), flush=True)


def main() -> None:
    import torch
    torch.set_num_threads(1)
    from gofr_tpu_torch.models.convert import params_from_jax
    from gofr_tpu_torch.models.llama import LlamaConfig
    from gofr_tpu_torch.serving.control_plane import WorkerAgent, tp_engine
    from gofr_tpu_torch.serving.engine import EngineConfig, SamplingParams
    from gofr_tpu_torch.serving.lockstep import follow

    with open(os.environ["GOFR_TP_PAYLOAD"], "rb") as f:
        p = pickle.load(f)
    expect_world = int(os.environ.get("GOFR_EXPECT_WORLD", "2"))
    agent = WorkerAgent(os.environ["GOFR_LEADER_URL"],
                        host_id=os.environ["GOFR_HOST_ID"],
                        address=f"proc:{os.getpid()}", n_devices=1,
                        heartbeat_interval_s=0.3)
    assignment = agent.join()
    deadline = time.time() + 60
    while assignment.world_size != expect_world:
        if time.time() > deadline:
            emit(event="error", error="group never reached expected size")
            sys.exit(2)
        time.sleep(0.2)
        assignment, _ = agent.heartbeat_sync()
    emit(event="settled", **assignment.to_dict())

    c = LlamaConfig.tiny()
    engine = tp_engine(
        assignment, params_from_jax(p["params"], c, "cpu"), c,
        EngineConfig(max_batch=2, max_seq=p["max_seq"], seed=0,
                     kv_layout="slot", decode_steps_per_pass=2),
        device="cpu", timeout_s=p["timeout_s"])
    if assignment.rank != 0:
        launch = engine._op_launch

        def launch_or_die(*args):
            if os.path.exists(p["die_flag"]):
                os._exit(3)
            return launch(*args)

        engine._op_launch = launch_or_die
        follow(engine)
        os._exit(0)

    greedy = SamplingParams(temperature=0.0, max_new_tokens=p["steps"])
    engine.start()
    req = engine.submit(list(p["prompt"]), greedy)
    while req.finished_at is None and req.error is None:
        time.sleep(0.005)
    emit(event="tp_tokens", tokens=list(req.generated), error=req.error)
    open(p["die_flag"], "w").close()
    t0 = time.monotonic()
    req = engine.submit(list(p["prompt"]), greedy)
    while req.finished_at is None and time.monotonic() - t0 < 120:
        time.sleep(0.005)
    emit(event="after_death", error=req.error,
         seconds=time.monotonic() - t0)
    engine.stop()
    os._exit(0)


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    main()
