"""The port's ASR serving (``gofr_tpu_torch/serving/asr.py``,
``pubsub/``, ``serving/app.asr_app``) against the JAX package's, on the
CPU, at ``WhisperConfig.tiny_test()`` in float32.

- ``Transcriber``: the same sample and batch buckets and the same result
  fields (``execute_ms`` aside) as JAX's on the same weights, tokens
  exactly; the payload decoder; the HTTP route and the pub/sub worker of
  ``asr_app(device="cpu")``, whose seed-0 weights are carried back to a
  JAX ``Transcriber`` for the comparison.
- ``ASRWorker``: one device batch per drain, results published before
  each commit, a poison message committed and dropped (the counterparts
  of ``tests/test_whisper_asr.py``'s worker tests).
- The broker's semantics call for call against JAX's: redelivery until
  commit, consumer groups, the retained backlog, deletion, health,
  ``partition_for``.
"""

import asyncio
import base64
import json
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gofr_tpu.models import whisper as jw
from gofr_tpu.pubsub import inmemory as jbroker
from gofr_tpu.serving import asr as jasr
from gofr_tpu_torch.models import whisper as tw
from gofr_tpu_torch.models.convert import whisper_params_from_jax
from gofr_tpu_torch.pubsub import inmemory as tbroker
from gofr_tpu_torch.serving import asr as tasr
from gofr_tpu_torch.serving.app import asr_app

torch.set_num_threads(2)

JCFG = jw.WhisperConfig.tiny_test()
TCFG = tw.WhisperConfig.tiny_test()
JPARAMS = jw.whisper_init(jax.random.key(0), JCFG)
TPARAMS = whisper_params_from_jax(jax.tree.map(np.asarray, JPARAMS), TCFG,
                                  "cpu")


def _tone(freq=220.0, seconds=0.25):
    t = np.arange(int(16000 * seconds)) / 16000
    return np.sin(2 * np.pi * freq * t).astype(np.float32)


def _jax_tree(tparams):
    """A port tree back to the JAX layout (convolutions [k, in, out])."""
    out = {k: _jax_tree(v) if isinstance(v, dict)
           else jnp.asarray(v.float().numpy()) for k, v in tparams.items()}
    for key in ("conv1_w", "conv2_w"):
        if key in out:
            out[key] = jnp.transpose(out[key], (2, 1, 0))
    return out


def _strip(results):
    return [{k: v for k, v in r.items() if k != "execute_ms"}
            for r in results]


# ------------------------------------------------------------ transcriber
@pytest.mark.parametrize("max_batch,n_audios,seconds", [
    (4, 2, (0.25, 0.5)), (4, 3, (0.25, 0.25, 0.6)), (3, 3, (0.1, 0.2, 0.3)),
    (2, 1, (1.2,)), (8, 5, (0.3, 0.1, 0.2, 0.4, 0.5))])
def test_transcriber_buckets_and_results_match_jax(max_batch, n_audios,
                                                   seconds):
    asr = dict(max_batch=max_batch, max_tokens=5,
               sample_buckets=(4000, 8000, 16000))
    audios = [_tone(200.0 + 37 * i, s) for i, s in enumerate(seconds)]
    want = jasr.Transcriber(JPARAMS, JCFG, jasr.ASRConfig(**asr)) \
        .transcribe_batch(audios)
    tr = tasr.Transcriber(TPARAMS, TCFG, tasr.ASRConfig(**asr),
                          device="cpu")
    got = tr.transcribe_batch(audios)
    assert _strip(got) == _strip(want)
    assert len(got) == n_audios and tr.executions == 1
    assert all(isinstance(r["execute_ms"], float) for r in got)
    assert tr.transcribe_batch([]) == [] and tr.executions == 1


def test_the_batch_bucket_is_jaxs():
    for max_batch in (1, 2, 3, 4, 5, 8):
        tr = tasr.Transcriber(TPARAMS, TCFG,
                              tasr.ASRConfig(max_batch=max_batch),
                              device="cpu")
        for n in range(1, max_batch + 1):
            want = jasr._bucket(n, tuple(
                b for b in (1, 2, 4, max_batch) if b <= max_batch)
                or (max_batch,))
            assert tr.batch_bucket(n) == want
    assert tasr._bucket(70000, (16000, 80000)) == 80000
    assert tasr._bucket(90000, (16000, 80000)) == 80000


def test_a_tokenizer_adds_text():
    class Letters:
        def decode(self, ids):
            return "".join(chr(97 + i % 26) for i in ids)

    tr = tasr.Transcriber(TPARAMS, TCFG, tasr.ASRConfig(max_tokens=4),
                          Letters(), device="cpu")
    result = tr.transcribe_batch([_tone()])[0]
    assert result["text"] == Letters().decode(result["tokens"])
    assert tr.health_check() == {"status": "UP", "details": {
        "model": "whisper", "executions": 1}}


def test_payload_decoding_matches_jax():
    pcm = _tone()
    b64 = base64.b64encode(pcm.tobytes()).decode()
    for payload in ({"audio": pcm.tolist()}, {"audio_b64": b64},
                    {"audio_b64": b64, "audio": [0.0]}):
        got = tasr.decode_audio_payload(payload)
        assert got.dtype == np.float32
        assert np.array_equal(got, jasr.decode_audio_payload(payload))
    for bad in ({"nope": 1}, [1.0, 2.0], "audio", b"\x00"):
        with pytest.raises(ValueError, match="audio"):
            tasr.decode_audio_payload(bad)


def test_the_entry_points_need_cuda_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        tasr.Transcriber(TPARAMS, TCFG)
    with pytest.raises(RuntimeError, match="cuda"):
        asr_app({})


# ------------------------------------------------------------------ app
def _post(port, path, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as exc:
        return exc.code, json.loads(exc.read())


@pytest.fixture(scope="module")
def app():
    server = asr_app({}, device="cpu")
    thread = threading.Thread(target=server.serve_forever, args=(0.01,),
                              daemon=True)
    thread.start()
    yield server
    server.shutdown()
    server.server_close()
    thread.join(10)
    assert not thread.is_alive()
    assert server.asr_loop.loop.is_closed()


def test_the_app_transcribes_as_jax_on_its_weights(app):
    worker = app.asr_worker
    tr = worker.transcriber
    assert tr.config == TCFG and tr.device == torch.device("cpu")
    assert (tr.asr.max_batch, tr.asr.max_tokens, tr.asr.sample_buckets) == \
        (4, 16, (16000, 80000))
    pcm = _tone(330.0, 0.5)
    status, body = _post(app.port, "/transcribe", {
        "audio_b64": base64.b64encode(pcm.tobytes()).decode()})
    assert status == 201
    want = jasr.Transcriber(
        _jax_tree(tr.params), JCFG,
        jasr.ASRConfig(max_batch=4, max_tokens=16,
                       sample_buckets=(16000, 80000))).transcribe_batch([pcm])
    assert _strip([body["data"]]) == _strip(want)
    status, body = _post(app.port, "/transcribe", {"audio": pcm.tolist()})
    assert status == 201 and body["data"]["tokens"] == want[0]["tokens"]


def test_a_bad_payload_is_a_server_error_as_in_jax(app):
    # JAX's handler raises the decoder's ValueError, which its responder
    # answers as an unexpected error
    status, body = _post(app.port, "/transcribe", {"nope": 1})
    assert status == 500 and "error" in body


def test_the_app_health_lists_the_model_and_the_broker(app):
    with urllib.request.urlopen(
            f"http://127.0.0.1:{app.port}/.well-known/health",
            timeout=30) as resp:
        health = json.loads(resp.read())["data"]
    assert health["status"] == "UP"
    assert health["checks"]["whisper"]["details"]["model"] == "whisper"
    assert health["checks"]["pubsub"]["backend"] == "inmemory"


def test_the_app_worker_consumes_batches_and_commits(app):
    worker, loop = app.asr_worker, app.asr_loop
    broker = worker.pubsub
    before = (worker.batches, worker.transcriber.executions)

    async def publish_all():
        # one coroutine: the worker sees all six at its next drain
        await broker.publish("asr.requests", {"junk": True})
        for i in range(5):
            await broker.publish("asr.requests", {
                "request_id": f"r{i}", "audio": _tone(200.0 + i).tolist()})

    async def results(n):
        return [(await broker.subscribe("asr.results", "test")).bind()
                for _ in range(n)]

    loop.call(publish_all(), timeout=30)
    got = loop.call(results(5), timeout=120)
    assert sorted(r["request_id"] for r in got) == [f"r{i}"
                                                    for i in range(5)]
    # six messages, max_batch 4: two drains, two device batches, the
    # first of three audios (the junk dropped) in a batch of 4, the
    # second of two
    assert (worker.batches - before[0],
            worker.transcriber.executions - before[1]) == (2, 2)
    assert sorted(r["batch"] for r in got) == [2, 2, 4, 4, 4]

    async def redeliver():
        return broker.redeliver_uncommitted("asr.requests", "asr-workers")
    assert loop.call(redeliver(), timeout=30) == 0


# --------------------------------------------------------------- worker
def _worker(max_batch):
    tr = tasr.Transcriber(TPARAMS, TCFG, tasr.ASRConfig(
        max_batch=max_batch, max_tokens=4, sample_buckets=(8000,)),
        device="cpu")
    broker = tbroker.InMemoryBroker()
    return tasr.ASRWorker(tr, broker), tr, broker


def test_batch_consume_publish_commit():
    async def run():
        worker, tr, broker = _worker(4)
        for i in range(3):
            await broker.publish("asr.requests", {
                "request_id": f"r{i}", "audio": _tone(200.0 + i).tolist()})
        assert await worker.run_once() == 3
        assert tr.executions == 1 and worker.batches == 1
        results = [await broker.subscribe("asr.results") for _ in range(3)]
        assert {r.bind()["request_id"] for r in results} == {"r0", "r1",
                                                              "r2"}
        assert broker.redeliver_uncommitted("asr.requests",
                                            "asr-workers") == 0
        return [r.bind() for r in results]

    got = asyncio.run(run())
    tr = jasr.Transcriber(JPARAMS, JCFG, jasr.ASRConfig(
        max_batch=4, max_tokens=4, sample_buckets=(8000,)))
    want = tr.transcribe_batch([_tone(200.0 + i) for i in range(3)])
    assert _strip([{k: v for k, v in r.items() if k != "request_id"}
                   for r in got]) == _strip(want)


def test_a_poison_message_is_dropped():
    async def run():
        worker, tr, broker = _worker(2)
        await broker.publish("asr.requests", {"garbage": True})
        await broker.publish("asr.requests",
                             {"request_id": "ok", "audio": _tone().tolist()})
        assert await worker.run_once() == 1
        result = await broker.subscribe("asr.results")
        assert result.bind()["request_id"] == "ok"
        assert broker.redeliver_uncommitted("asr.requests",
                                            "asr-workers") == 0
        # a drain of poison alone transcribes nothing
        await broker.publish("asr.requests", b"not json")
        assert await worker.run_once() == 0
        assert tr.executions == 1 and worker.processed == 1
    asyncio.run(run())


def test_a_failed_batch_leaves_its_messages_for_redelivery():
    async def run():
        worker, tr, broker = _worker(4)

        def boom(audios):
            raise RuntimeError("device lost")
        tr.transcribe_batch = boom
        for i in range(2):
            await broker.publish("asr.requests", {
                "request_id": f"r{i}", "audio": _tone().tolist()})
        with pytest.raises(RuntimeError):
            await worker.run_once()
        # nothing published, nothing committed: both come back
        assert broker.redeliver_uncommitted("asr.requests",
                                            "asr-workers") == 2
    asyncio.run(run())


def test_the_worker_runs_until_cancelled():
    async def run():
        worker, tr, broker = _worker(4)
        task = asyncio.ensure_future(worker.run())
        await broker.publish("asr.requests", {"request_id": "a",
                                              "audio": _tone().tolist()})
        result = await asyncio.wait_for(
            broker.subscribe("asr.results"), timeout=60)
        task.cancel()
        with pytest.raises(asyncio.CancelledError):
            await task
        return result.bind()["request_id"]
    assert asyncio.run(run()) == "a"


# --------------------------------------------------------------- broker
async def _script(mod):
    """One sequence of broker calls; what each step observes."""
    broker = mod.InMemoryBroker()
    seen = []
    await broker.publish("t", {"n": 1}, key="k1", metadata={"m": "x"})
    await broker.publish("t", "two")
    first = await broker.subscribe("t", "g1")
    seen.append((first.bind(), first.key, first.param("m"),
                 first.params("m"), first.params("none"),
                 first.path_param("topic"), first.path_param("m"),
                 first.host_name()))
    second = await broker.subscribe("t", "g1")
    seen.append(second.bind())
    second.commit()
    second.commit()                      # a second commit does nothing
    # g1 delivered two and committed one: one comes back
    seen.append(broker.redeliver_uncommitted("t", "g1"))
    seen.append((await broker.subscribe("t", "g1")).bind())
    # a group created late starts from the earliest retained message
    seen.append([(await broker.subscribe("t", "g2")).bind()
                 for _ in range(2)])
    await broker.publish("t", b"\xff raw")
    seen.append([(await broker.subscribe("t", g)).bind() for g in ("g1",
                                                                   "g2")])
    seen.append(broker.redeliver_uncommitted("t", "nobody"))
    seen.append((broker.topics, broker.health_check()))
    broker.create_topic("u")
    broker.delete_topic("t")
    await broker.publish("t", "after")
    seen.append([(await broker.subscribe("t", "g3")).bind()])
    mod.InMemoryBroker.BACKLOG_CAP, cap = 3, mod.InMemoryBroker.BACKLOG_CAP
    try:
        for i in range(5):
            await broker.publish("capped", {"i": i})
        seen.append([(await broker.subscribe("capped", "late")).bind()
                     for _ in range(3)])
    finally:
        mod.InMemoryBroker.BACKLOG_CAP = cap
    broker.close()
    seen.append((broker.topics, broker.health_check()))
    return seen


def test_the_broker_matches_jaxs_call_for_call():
    got = asyncio.run(_script(tbroker))
    want = asyncio.run(_script(jbroker))
    assert got == want
    assert got[2] == 1 and got[5][1] == b"\xff raw"


def test_partition_for_matches_jax():
    keys = ["", "a", "user-17", "é", "x" * 100]
    for n in (0, 1, 2, 7, 64):
        assert [tbroker.partition_for(k, n) for k in keys] == \
            [jbroker.partition_for(k, n) for k in keys]
