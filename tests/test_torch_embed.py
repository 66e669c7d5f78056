"""``POST /embed`` of the port (``serving/handlers.make_embed_handler``
behind ``serving/app.embed_app``) against the JAX package's
``make_embed_handler`` on the same ``BertConfig.tiny()`` weights and the
byte tokenizer, on the CPU.

Tolerance: 1e-5 absolute on each embedding (float32 on both sides). The
byte tokenizer's ids pass the tiny vocabulary of 128 and long texts pass
its 64 positions: both packages clamp such gathers to the last row.
"""

import json
import threading
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from gofr_tpu.models import bert as jbert
from gofr_tpu.serving.handlers import make_embed_handler as jax_embed
from gofr_tpu.serving.tokenizer import ByteTokenizer as JaxByteTokenizer
from gofr_tpu_torch.models import bert as tbert
from gofr_tpu_torch.models.convert import bert_params_from_jax
from gofr_tpu_torch.serving.app import embed_app
from gofr_tpu_torch.serving.tokenizer import ByteTokenizer

torch.set_num_threads(2)

ATOL = 1e-5
JCFG = jbert.BertConfig.tiny()
TCFG = tbert.BertConfig.tiny()
JPARAMS = jbert.bert_init(jax.random.key(0), JCFG)
TPARAMS = bert_params_from_jax(jax.tree.map(np.asarray, JPARAMS), TCFG, "cpu")
JAX_HANDLER = jax_embed(JPARAMS, JCFG, JaxByteTokenizer())


class _Ctx:
    def __init__(self, body):
        self.body = body

    def bind(self):
        return self.body


def _post(port, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/embed", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as exc:
        return exc.code, json.loads(exc.read())


@pytest.fixture(scope="module")
def port():
    server = embed_app(TPARAMS, TCFG, ByteTokenizer(), device="cpu")
    thread = threading.Thread(target=server.serve_forever, args=(0.01,),
                              daemon=True)
    thread.start()
    yield server.port
    server.shutdown()
    server.server_close()
    thread.join(10)


@pytest.mark.parametrize("texts", [
    "hello",
    ["a", "b", "longer sentence here"],
    ["", "naïve café ☕", "x" * 40],
    ["y" * 70, "short"],                        # bucket 128 past 64 rows
    ["z" * 600],                                # cut to max_len 512
])
def test_embed_matches_jax(port, texts):
    status, body = _post(port, {"input": texts})
    assert status == 201
    assert set(body) == {"embeddings", "dim", "latency_ms"}   # no envelope
    want = JAX_HANDLER(_Ctx({"input": texts})).data
    got = np.asarray(body["embeddings"])
    n = 1 if isinstance(texts, str) else len(texts)
    assert got.shape == (n, TCFG.dim) and body["dim"] == want["dim"] == 32
    np.testing.assert_allclose(got, np.asarray(want["embeddings"]),
                               atol=ATOL, rtol=0)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0,
                               rtol=1e-5)


def test_a_text_alone_embeds_as_its_row_of_the_batch(port):
    texts = ["one", "a longer second text", "3"]
    _, batch = _post(port, {"input": texts})
    for i, text in enumerate(texts):
        _, alone = _post(port, {"input": text})
        np.testing.assert_allclose(alone["embeddings"][0],
                                   batch["embeddings"][i], atol=1e-6, rtol=0)


@pytest.mark.parametrize("body", [{}, {"input": []}, {"input": None},
                                  {"input": 5}, {"text": "hi"}])
def test_a_request_without_input_is_a_400(port, body):
    status, answer = _post(port, body)
    assert status == 400
    assert answer == {"error": {"message": "Parameter input is required"}}


def test_embed_app_needs_cuda_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        embed_app(TPARAMS, TCFG)
