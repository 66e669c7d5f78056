"""The port's serving surface against the JAX app's, over HTTP on the
CPU: ``POST /chat`` (unary and SSE) and the OpenAI routes.

The JAX app (``tests/apputil.AppRunner`` with ``make_chat_handler`` and
``install_openai_routes`` over a JAX ``llama_engine``,
``paged_attention="xla"``) and the port's ``ChatServer`` serve engines
on the same converted tiny weights (vocabulary 260, the byte
tokenizer's); every request is greedy. Each request of ``CASES`` must
give the same status, the same body (ids, timestamps and timings aside:
``text``, ``tokens``, ``finish_reason``, ``usage`` counts, error
messages and ``details``), and for a stream the same event sequence.

On the port alone: a client that leaves mid-stream and one that leaves
while its request is queued behind two busy slots each cancel their
request (the queued one never gets a slot); a stream whose iterator
raises ends without the terminating chunk; the unary answer keeps the
reference's field rounding. A failure during generation (a planted
raise in the decode dispatch of both engines) answers 500 to a unary
``/chat`` and ``/v1/completions``, and ends a ``/chat`` stream with an
error event and no ``[DONE]``, alike on both stacks.
"""

import http.client
import json
import socket
import threading
import time

import jax
import numpy as np
import pytest
import torch

from gofr_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from gofr_tpu.models.llama import llama_init as jax_llama_init
from gofr_tpu.serving.engine import EngineConfig as JaxEngineConfig
from gofr_tpu.serving.glue import llama_engine as jax_llama_engine
from gofr_tpu.serving.handlers import make_chat_handler as jax_chat_handler
from gofr_tpu.serving.openai_compat import \
    install_openai_routes as jax_install_openai
from gofr_tpu.serving.tokenizer import ByteTokenizer as JaxByteTokenizer
from gofr_tpu_torch.models.convert import params_from_jax
from gofr_tpu_torch.models.llama import LlamaConfig
from gofr_tpu_torch.serving.app import build_server
from gofr_tpu_torch.serving.engine import EngineConfig, SamplingParams
from gofr_tpu_torch.serving.glue import llama_engine
from gofr_tpu_torch.serving.openai_compat import install_openai_routes
from gofr_tpu_torch.serving.responses import Stream
from gofr_tpu_torch.serving.tokenizer import ByteTokenizer

from .apputil import AppRunner

torch.set_num_threads(2)

MODEL = "tiny-llama"
COMMON = dict(max_batch=2, max_seq=128, page_size=16, seed=0,
              decode_steps_per_pass=4, prefix_cache=False)


@pytest.fixture(scope="module")
def weights():
    jparams = jax_llama_init(jax.random.key(0),
                             JaxLlamaConfig.tiny().scaled(vocab_size=260))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams),
                              LlamaConfig.tiny().scaled(vocab_size=260),
                              "cpu")
    return jparams, tparams


class _Stacks:
    """Both HTTP stacks over fresh engines on ``weights``; the engines
    start with the context unless ``start`` is False."""

    def __init__(self, weights, start=True):
        self.jeng = jax_llama_engine(
            weights[0], JaxLlamaConfig.tiny().scaled(vocab_size=260),
            JaxEngineConfig(kv_layout="paged", paged_attention="xla",
                            compile_cache_dir=None, **COMMON),
            implementation="xla")
        self.teng = llama_engine(
            weights[1], LlamaConfig.tiny().scaled(vocab_size=260),
            EngineConfig(**COMMON), device="cpu")
        self.start = start

    def __enter__(self):
        def build(app):
            app.post("/chat", jax_chat_handler(self.jeng, JaxByteTokenizer()))
            jax_install_openai(app, self.jeng, JaxByteTokenizer(),
                               model=MODEL)

        self.runner = AppRunner(build=build)
        self.jport = self.runner.__enter__().port
        # the JAX app resolves every unauthenticated request to
        # "anonymous": the port's server is given the same label
        self.server = build_server(self.teng, port=0,
                                   tenant_of=lambda headers: "anonymous")
        install_openai_routes(self.server, self.teng, ByteTokenizer(),
                              model=MODEL)
        self.thread = threading.Thread(target=self.server.serve_forever,
                                       daemon=True)
        self.thread.start()
        self.tport = self.server.server_address[1]
        if self.start:
            self.jeng.start()
            self.teng.start()
        return self

    def __exit__(self, *exc):
        self.server.shutdown()
        self.server.server_close()
        self.runner.__exit__(*exc)
        self.jeng.stop()
        self.teng.stop()
        self.thread.join(timeout=10)


@pytest.fixture(scope="module")
def stacks(weights):
    with _Stacks(weights) as s:
        yield s


def _call(port, method, path, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        data = body if isinstance(body, (bytes, type(None))) \
            else json.dumps(body)
        conn.request(method, path, body=data,
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, dict(resp.getheaders()), resp.read()
    finally:
        conn.close()


def _events(raw: bytes) -> list:
    """The SSE ``data:`` payloads, JSON-decoded where they are JSON."""
    out = []
    for block in raw.decode().split("\n\n"):
        if not block:
            continue
        assert block.startswith("data: "), block
        payload = block[len("data: "):]
        out.append(payload if payload == "[DONE]" else json.loads(payload))
    return out


def _norm(obj):
    """Ids, timestamps and timings aside (their presence kept)."""
    if isinstance(obj, dict):
        return {k: ("<set>" if v is not None else None)
                if k in ("id", "created", "ttft_ms", "tpot_ms") else _norm(v)
                for k, v in obj.items()}
    if isinstance(obj, list):
        return [_norm(v) for v in obj]
    return obj


def _answer(port, method, path, body=None):
    status, headers, raw = _call(port, method, path, body)
    if headers.get("Content-Type", "").startswith("text/event-stream"):
        assert headers["Cache-Control"] == "no-cache"
        return status, "sse", _norm(_events(raw))
    return status, "json", _norm(json.loads(raw))


SYSTEM_USER = [{"role": "system", "content": "be brief"},
               {"role": "user", "content": "hi"}]
#: (name, status, method, path, body): every request runs on both stacks
CASES = [
    ("chat", 201, "POST", "/chat",
     {"prompt": "hello there", "max_tokens": 6, "temperature": 0}),
    ("chat_stream", 200, "POST", "/chat",
     {"prompt": "hello there", "max_tokens": 6, "temperature": 0,
      "stream": True}),
    ("chat_messages", 201, "POST", "/chat",
     {"messages": [{"role": "user", "content": "hi"}, {"content": "there"}],
      "max_tokens": 4, "temperature": 0}),
    ("chat_no_prompt", 400, "POST", "/chat", {"max_tokens": 4}),
    ("chat_prompt_not_text", 400, "POST", "/chat", {"prompt": 5}),
    ("chat_max_tokens_0", 400, "POST", "/chat",
     {"prompt": "x", "max_tokens": 0}),
    ("chat_bad_temperature", 400, "POST", "/chat",
     {"prompt": "x", "temperature": "hot"}),
    ("chat_not_json", 400, "POST", "/chat", b"{not json"),
    ("models", 200, "GET", "/v1/models", None),
    ("chat_completion", 201, "POST", "/v1/chat/completions",
     {"model": MODEL, "messages": SYSTEM_USER, "max_tokens": 7,
      "temperature": 0}),
    ("chat_completion_stream", 200, "POST", "/v1/chat/completions",
     {"model": MODEL, "messages": SYSTEM_USER, "max_tokens": 7,
      "temperature": 0, "stream": True}),
    ("completion", 201, "POST", "/v1/completions",
     {"model": MODEL, "prompt": "once upon", "max_tokens": 5,
      "temperature": 0}),
    ("completion_stream", 200, "POST", "/v1/completions",
     {"model": MODEL, "prompt": ["once upon"], "max_tokens": 5,
      "temperature": 0, "stream": True}),
    ("content_parts_null_optionals", 201, "POST", "/v1/chat/completions",
     {"messages": [{"role": "user", "content": [
         {"type": "text", "text": "hel"}, {"type": "text", "text": "lo"}]}],
      "max_tokens": 4, "temperature": 0, "top_p": None, "stop": None}),
    ("content_part_image", 400, "POST", "/v1/chat/completions",
     {"messages": [{"role": "user", "content": [{"type": "image_url"}]}]}),
    ("n_2", 400, "POST", "/v1/chat/completions",
     {"messages": SYSTEM_USER, "n": 2}),
    ("no_messages", 400, "POST", "/v1/chat/completions", {"model": MODEL}),
    ("message_without_content", 400, "POST", "/v1/chat/completions",
     {"messages": [{"role": "user"}]}),
    ("no_prompt", 400, "POST", "/v1/completions", {"prompt": ""}),
    ("max_tokens_5000", 400, "POST", "/v1/completions",
     {"prompt": "x", "max_tokens": 5000}),
    ("bad_temperature", 400, "POST", "/v1/completions",
     {"prompt": "x", "temperature": "x"}),
    ("five_stops", 400, "POST", "/v1/completions",
     {"prompt": "x", "stop": list("abcde")}),
]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_the_port_answers_like_the_jax_app(stacks, case):
    _, status, method, path, body = case
    want = _answer(stacks.jport, method, path, body)
    got = _answer(stacks.tport, method, path, body)
    assert got == want
    assert got[0] == status


def _stop_for(text: str) -> str:
    """A 2-character piece of ``text`` whose first match starts past its
    second character."""
    for k in range(2, len(text) - 1):
        if text.find(text[k:k + 2]) == k:
            return text[k:k + 2]
    raise AssertionError(f"no stop sequence in {text!r}")


@pytest.mark.parametrize("stream", [False, True])
def test_a_stop_sequence_cuts_the_text_like_the_jax_app(stacks, stream):
    base = {"prompt": "once upon", "max_tokens": 16, "temperature": 0}
    status, _, raw = _call(stacks.tport, "POST", "/v1/completions", base)
    full = json.loads(raw)["choices"][0]["text"]
    stop = _stop_for(full)
    body = {**base, "stop": [stop, "never-there"], "stream": stream}
    want = _answer(stacks.jport, "POST", "/v1/completions", body)
    got = _answer(stacks.tport, "POST", "/v1/completions", body)
    assert got == want
    if stream:
        text = "".join(e["choices"][0]["text"] for e in got[2][:-1]
                       if isinstance(e, dict))
        assert got[2][-2]["choices"][0]["finish_reason"] == "stop"
        assert got[2][-1] == "[DONE]"
    else:
        text = got[2]["choices"][0]["text"]
        assert got[2]["choices"][0]["finish_reason"] == "stop"
        assert got[2]["usage"]["completion_tokens"] < 16
    assert text == full[:full.find(stop)] and stop not in text


def test_the_unary_chat_answer_rounds_its_timings(stacks):
    status, _, raw = _call(stacks.tport, "POST", "/chat", {
        "prompt": "hello", "max_tokens": 4, "temperature": 0})
    usage = json.loads(raw)["data"]["usage"]
    assert status == 201 and usage["tenant"] == "anonymous"
    assert usage["ttft_ms"] == round(usage["ttft_ms"], 2)
    assert usage["tpot_ms"] == round(usage["tpot_ms"], 3)


def _capture_submits(engine):
    """Record every request the engine's ``submit`` makes."""
    made, inner = [], engine.submit

    def submit(*args, **kwargs):
        made.append(inner(*args, **kwargs))
        return made[-1]

    engine.submit = submit
    return made, inner


def _slowed(engine, seconds):
    """Slow each decode dispatch, so that a request outlasts the test's
    client; returns the original to restore."""
    inner = engine._decode_dispatch

    def slow():
        time.sleep(seconds)
        inner()

    engine._decode_dispatch = slow
    return inner


def _open_stream(port, path, body) -> socket.socket:
    sock = socket.create_connection(("127.0.0.1", port), timeout=30)
    data = json.dumps(body).encode()
    sock.sendall(b"POST %s HTTP/1.1\r\nHost: x\r\nContent-Type: "
                 b"application/json\r\nContent-Length: %d\r\n\r\n%s"
                 % (path.encode(), len(data), data))
    return sock


def _wait(cond, timeout_s):
    deadline = time.time() + timeout_s
    while time.time() < deadline and not cond():
        time.sleep(0.005)
    return cond()


def test_a_client_leaving_mid_stream_cancels_its_request(stacks):
    eng = stacks.teng
    made, inner_submit = _capture_submits(eng)
    inner = _slowed(eng, 0.03)
    try:
        sock = _open_stream(stacks.tport, "/v1/chat/completions", {
            "messages": SYSTEM_USER, "max_tokens": 100, "temperature": 0,
            "stream": True})
        got = b""
        while got.count(b'"content"') < 3:
            chunk = sock.recv(4096)
            assert chunk, got
            got += chunk
        req, = made
        sock.close()
        # what the close means is counted in tokens, not seconds: a
        # wall-clock bound breaks under a loaded host
        at_close = len(req.generated)
        assert _wait(lambda: all(r is None for r in eng.active), 30.0)
    finally:
        eng._decode_dispatch = inner
        eng.submit = inner_submit
    assert req.cancelled and req.done.is_set()
    assert len(req.generated) < 50, len(req.generated)
    # the server sees the close at its next write or two, and the engine
    # retires the slot at its next dispatch: a few passes at most
    passes_after = (len(req.generated) - at_close) \
        / eng.config.decode_steps_per_pass
    assert passes_after <= 6, (at_close, len(req.generated))
    assert sorted(eng._free_pages) == list(range(eng._n_pages))


def test_a_client_leaving_while_queued_never_gets_a_slot(stacks):
    eng = stacks.teng
    inner = _slowed(eng, 0.03)
    blockers = []
    try:
        for _ in range(2):
            blockers.append(eng.submit([1, 2, 3], SamplingParams(
                temperature=0.0, max_new_tokens=100)))
        assert _wait(lambda: all(b.generated for b in blockers), 30)
        made, inner_submit = _capture_submits(eng)
        try:
            sock = _open_stream(stacks.tport, "/chat", {
                "prompt": "queued", "max_tokens": 8, "stream": True})
            assert _wait(lambda: eng.waiting.qsize() == 1, 30)
        finally:
            eng.submit = inner_submit
        sock.close()
        req, = made
        # the handler's next look at the socket cancels it, still queued
        assert _wait(lambda: req.cancelled, 2.0)
        assert req.slot == -1 and not req.generated
        for b in blockers:
            eng.cancel(b)
        assert _wait(lambda: req.done.is_set(), 5.0)
    finally:
        eng._decode_dispatch = inner
    assert req.slot == -1 and not req.generated and req.error is None
    assert _wait(lambda: all(r is None for r in eng.active), 5.0)


def test_a_stream_cut_short_never_sends_the_terminating_chunk(stacks):
    def broken(ctx):
        def chunks():
            yield "data: one\n\n"
            raise RuntimeError("planted stream fault")
        return Stream(chunks())

    stacks.server.post("/broken", broken)
    sock = _open_stream(stacks.tport, "/broken", {})
    raw = b""
    while True:
        chunk = sock.recv(4096)
        if not chunk:
            break
        raw += chunk
    sock.close()
    head, _, body = raw.partition(b"\r\n\r\n")
    assert b"Transfer-Encoding: chunked" in head
    assert body == b"b\r\ndata: one\n\n\r\n"     # no 0\r\n\r\n after it


def test_a_failed_generation_answers_500_and_an_error_event(weights):
    # both engines queue three requests before they start, then crash at
    # their first decode dispatch, after the prefill's first tokens
    answers = {}
    with _Stacks(weights, start=False) as s:
        for side, eng, port in (("jax", s.jeng, s.jport),
                                ("port", s.teng, s.tport)):
            def crash(*args, **kwargs):
                raise RuntimeError("planted decode fault")

            eng._decode_dispatch = crash
            asks = [("/chat", {"prompt": "unary", "max_tokens": 8,
                               "temperature": 0}),
                    ("/chat", {"prompt": "streamed", "max_tokens": 8,
                               "temperature": 0, "stream": True}),
                    ("/v1/completions", {"prompt": "queued",
                                         "max_tokens": 8,
                                         "temperature": 0})]
            got = [None] * len(asks)
            threads = []
            for i, (path, body) in enumerate(asks):
                threads.append(threading.Thread(
                    target=lambda i=i, path=path, body=body: got.__setitem__(
                        i, _answer(port, "POST", path, body))))
                threads[-1].start()
                assert _wait(lambda i=i: eng.waiting.qsize() == i + 1, 30)
            eng.start()
            for t in threads:
                t.join(timeout=60)
            answers[side] = got
    jax_got, port_got = answers["jax"], answers["port"]
    reason = "engine crashed: RuntimeError: planted decode fault"
    # unary /chat: 500 on both; the JAX app's panic recovery masks the
    # handler's message, the port keeps it
    assert jax_got[0] == (500, "json", {"error": {
        "message": "internal server error"}})
    assert port_got[0] == (500, "json", {"error": {
        "message": f"generation failed: {reason}"}})
    # the stream: its first token, then the error event, no [DONE]
    assert port_got[1] == jax_got[1]
    status, kind, events = port_got[1]
    assert status == 200 and kind == "sse" and len(events) == 2
    assert events[-1] == {"error": reason} and "[DONE]" not in events
    # the OpenAI unary route: the same 500 server_error on both
    assert port_got[2] == jax_got[2] == (500, "json", {"error": {
        "message": f"generation failed: {reason}",
        "details": {"type": "server_error", "param": None}}})


def test_a_bad_content_length_is_refused_not_waited_on(stacks):
    for length in (b"-5", b"five"):
        sock = socket.create_connection(("127.0.0.1", stacks.tport),
                                        timeout=10)
        sock.sendall(b"POST /chat HTTP/1.1\r\nHost: x\r\nContent-Length: "
                     + length + b"\r\n\r\n{}")
        reply = b""
        while chunk := sock.recv(4096):  # the server closes after it
            reply += chunk
        sock.close()
        assert reply.startswith(b"HTTP/1.1 400"), reply
        assert b"bad content-length" in reply
    assert _call(stacks.tport, "GET", "/nowhere")[0] == 404
    assert _call(stacks.tport, "GET", "/chat")[0] == 405
