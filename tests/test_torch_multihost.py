"""The port's multi-process tensor-parallel hand-off (counterpart of
``tests/test_multihost_procs.py::test_tensor_parallel_decode_across_processes``):
two OS processes (``tests/torch_tp_worker.py``) join the port's
``ControlPlaneLeader`` over HTTP, take their ranks, and hand off through
``control_plane.tp_engine`` (``init_process_group`` with the
leader-issued assignment, a ``{"tp": 2}`` mesh, ``llama_engine(mesh=)``)
to one tensor-parallel engine whose greedy tokens must equal JAX's
single-device decode of the same scenario (``tests/multihost_worker.py``'s
``TP_PROMPT`` / ``TP_STEPS`` / ``TP_MAX_SEQ``). Then the follower process
dies mid-pass, and the leader's request must fail within the collectives'
timeout instead of hanging.
"""

import json
import os
import pickle
import socket
import subprocess
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np

from gofr_tpu.models.llama import (LlamaConfig, llama_decode_step,
                                   llama_init, llama_prefill_last,
                                   make_empty_cache)
from gofr_tpu_torch.serving.app import serve_fleet_leader

from .multihost_worker import TP_MAX_SEQ, TP_PROMPT, TP_STEPS

TIMEOUT_S = 10.0


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _jax_decode(params, config) -> list[int]:
    """JAX's single-device greedy decode of the scenario, as the JAX
    test computes it."""
    n = len(TP_PROMPT)
    prompt = jnp.asarray([TP_PROMPT], jnp.int32)
    lengths = jnp.asarray([n], jnp.int32)
    logits, (k, v) = llama_prefill_last(params, prompt, config,
                                        kv_lengths=lengths,
                                        implementation="xla")
    k0, v0 = make_empty_cache(config, 1, max_seq=TP_MAX_SEQ)
    k = k0.at[:, :, :n].set(k)
    v = v0.at[:, :, :n].set(v)
    tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
    want = [int(np.asarray(tok)[0])]
    for step in range(TP_STEPS - 1):
        logits, k, v = llama_decode_step(params, tok, k, v, lengths + step,
                                         config)
        tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        want.append(int(np.asarray(tok)[0]))
    return want


def _spawn(url: str, host_id: str, payload: str) -> subprocess.Popen:
    env = dict(os.environ)
    env.update({"GOFR_LEADER_URL": url, "GOFR_HOST_ID": host_id,
                "GOFR_EXPECT_WORLD": "2", "GOFR_TP_PAYLOAD": payload,
                "GOFR_TELEMETRY": "false"})
    env.pop("XLA_FLAGS", None)          # the workers never import JAX
    script = os.path.join(os.path.dirname(__file__), "torch_tp_worker.py")
    return subprocess.Popen([sys.executable, script], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def _events(stdout: str) -> list[dict]:
    return [json.loads(line[3:]) for line in stdout.splitlines()
            if line.startswith("EV ")]


def test_tensor_parallel_decode_across_processes(tmp_path):
    config = LlamaConfig.tiny()
    params = llama_init(jax.random.key(0), config)
    payload = tmp_path / "payload.pkl"
    payload.write_bytes(pickle.dumps({
        "params": jax.tree.map(np.asarray, params), "prompt": TP_PROMPT,
        "steps": TP_STEPS, "max_seq": TP_MAX_SEQ, "timeout_s": TIMEOUT_S,
        "die_flag": str(tmp_path / "die")}))
    coordinator = f"127.0.0.1:{_free_port()}"
    server = serve_fleet_leader(coordinator=coordinator,
                                heartbeat_interval_s=0.5)
    thread = threading.Thread(target=server.serve_forever, args=(0.01,),
                              daemon=True)
    thread.start()
    try:
        url = f"http://127.0.0.1:{server.port}"
        procs = [_spawn(url, f"tp-{i}", str(payload)) for i in range(2)]
        want = _jax_decode(params, config)     # meanwhile
        outs = []
        for p in procs:
            try:
                stdout, stderr = p.communicate(timeout=120)
            except subprocess.TimeoutExpired:
                p.kill()
                stdout, stderr = p.communicate()
            outs.append((p.returncode, _events(stdout), stderr))
    finally:
        server.shutdown()
        server.server_close()
    by_rank = {}
    for rc, events, stderr in outs:
        settled = next((e for e in events if e["event"] == "settled"), None)
        assert settled is not None, (rc, events, stderr)
        by_rank[settled["rank"]] = (rc, events, stderr)
    assert sorted(by_rank) == [0, 1]
    assert {e["coordinator"] for _, evs, _ in by_rank.values()
            for e in evs if e["event"] == "settled"} == {coordinator}
    rc, events, stderr = by_rank[0]
    assert rc == 0, stderr
    tokens = next(e for e in events if e["event"] == "tp_tokens")
    assert tokens["error"] is None and tokens["tokens"] == want, \
        (tokens, want)
    # the follower died at its next launch (exit 3): the leader's
    # request failed, within the collectives' timeout
    assert by_rank[1][0] == 3, by_rank[1]
    death = next(e for e in events if e["event"] == "after_death")
    assert death["error"] is not None, death
    assert death["seconds"] < TIMEOUT_S + 5, death
