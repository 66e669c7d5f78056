"""The port's native host code (``gofr_tpu_torch/native/``) against the
JAX package's (``gofr_tpu/native/``): the C++ BPE merge loop gives the
ids of JAX's native loop and of the pure-Python loop (curated texts, a
fuzz corpus, pre-tokenizer bounds, merge-priority tables); the port's
``BPETokenizer`` fast path on and off (``GOFR_NATIVE=0``) gives JAX's
ids; the build lands in the git-ignored ``build/gofr_tpu_torch/`` under
a hashed name, and concurrent first builds never load half a library;
the batch queue passes the cases of JAX's ``test_native.py``, native and
pure Python alike.
"""

from __future__ import annotations

import json
import queue as queue_mod
import random
import threading
import time

import pytest

from gofr_tpu.native.bpe import NativeBPE as JaxNativeBPE
from gofr_tpu.serving.tokenizer import BPETokenizer as JaxBPETokenizer
from gofr_tpu_torch.native import available, build, compiler
from gofr_tpu_torch.native.batch_queue import (PyRequestQueue, RequestQueue,
                                               new_request_queue)
from gofr_tpu_torch.native.bpe import NativeBPE
from gofr_tpu_torch.serving.tokenizer import BPETokenizer, _byte_level_table

HAVE_CC = compiler() is not None
needs_cc = pytest.mark.skipif(not HAVE_CC, reason="no C++ compiler")

MERGES = [b"th", b"he", b"in", b"er", b"the", b" t", b" the", b"to", b"ke",
          b"en", b"tok", b"token", b"iz", b"ize"]


def _ranks() -> dict[bytes, int]:
    """Byte vocabulary and some merges, tiktoken-style ascending ranks."""
    ranks = {bytes([i]): i for i in range(256)}
    for merge in MERGES:
        ranks[merge] = len(ranks)
    return ranks


def _hf_json(path) -> str:
    """A byte-level ``tokenizer.json`` whose merge priorities run against
    its ids (the HF style: the merges list orders, the vocab names)."""
    chars = {b: ch for ch, b in _byte_level_table().items()}
    vocab = {chars[b]: b for b in range(256)}
    merges = []
    for piece in reversed(MERGES):        # priorities reversed vs ids
        left, right = piece[:-1], piece[-1:]
        merges.append(" ".join("".join(chars[b] for b in part)
                               for part in (left, right)))
    for i, piece in enumerate(MERGES):
        vocab["".join(chars[b] for b in piece)] = 256 + i
    path.write_text(json.dumps({
        "model": {"type": "BPE", "vocab": vocab, "merges": merges},
        "added_tokens": [{"id": 300, "content": "<|begin_of_text|>"},
                         {"id": 301, "content": "<|end_of_text|>"}]}))
    return str(path)


TEXTS = ["the tokenizer tokenizes the token", "hello world", "", "a", "  ",
         "thththththth", "ünïcödé — emoji 🎉 bytes", "x" * 500,
         "Numbers 12345 and 1,234.5; it's they're\n\n  tabs\tend "]


def _fuzz(n: int, seed: int = 7) -> list:
    rng = random.Random(seed)
    return [bytes(rng.choices(b"thein erko z the token",
                              k=rng.randint(0, 300))) for _ in range(n)]


@needs_cc
class TestNativeBPE:
    def test_builds_into_the_repos_build_directory(self):
        assert available("bpe")
        path = build.library_path("bpe")
        assert path.parent == build.BUILD_DIR
        assert path.parts[-3:-1] == ("build", "gofr_tpu_torch")
        assert path.is_file() and path.name.startswith("bpe-")

    @pytest.mark.parametrize("merge_ranks", [False, True],
                             ids=["tiktoken", "merge_table"])
    def test_equals_jax_native_and_python_loop(self, merge_ranks):
        ranks = _ranks()
        prio = ({p: len(MERGES) - i for i, p in enumerate(MERGES)}
                if merge_ranks else None)
        port, jax_native = NativeBPE(ranks, prio), JaxNativeBPE(ranks, prio)
        python = BPETokenizer(ranks, merge_ranks=prio)
        for data in [t.encode() for t in TEXTS] + _fuzz(150):
            want = python._bpe_merge(data)
            assert port.encode(data) == want == jax_native.encode(data), data

    def test_bounds_keep_merges_inside_pieces(self):
        ranks = _ranks()
        port, jax_native = NativeBPE(ranks), JaxNativeBPE(ranks)
        python = BPETokenizer(ranks)
        rng = random.Random(3)
        for data in _fuzz(100, seed=11):
            cuts = sorted({0, *rng.sample(range(len(data) + 1),
                                          min(len(data) + 1, 6))} - {len(data)})
            pieces = [data[a:b] for a, b in zip(cuts, cuts[1:] + [len(data)])]
            want = [i for p in pieces for i in python._bpe_merge(p)]
            assert port.encode(data, cuts) == want \
                == jax_native.encode(data, cuts), (data, cuts)

    def test_long_text_is_fast_and_lossless(self):
        tok = BPETokenizer(_ranks())
        text = "the tokenizer tokenizes the token " * 2000      # ~68 KB
        start = time.perf_counter()
        ids = tok._native.encode(text.encode())
        assert time.perf_counter() - start < 2.0    # heap merge, not n^2
        assert tok.decode(ids) == text and len(ids) < len(text)


@needs_cc
@pytest.mark.parametrize("style", ["tiktoken", "hf_json"])
def test_tokenizer_fast_path_on_and_off_equals_jax(style, tmp_path,
                                                   monkeypatch):
    """The port's tokenizer with the native loop live and with
    ``GOFR_NATIVE=0`` gives JAX's ids (the HF form splits with the
    pre-tokenizer and hands the bounds to one native call)."""
    if style == "hf_json":
        path = _hf_json(tmp_path / "tokenizer.json")
        make = [lambda: BPETokenizer.from_hf_json(path),
                lambda: JaxBPETokenizer.from_hf_json(path)]
    else:
        make = [lambda: BPETokenizer(_ranks()),
                lambda: JaxBPETokenizer(_ranks())]
    fast, want_tok = make[0](), make[1]()
    from gofr_tpu_torch.native import build as port_build
    monkeypatch.setenv("GOFR_NATIVE", "0")
    monkeypatch.setattr(port_build, "_loaded", {})
    slow = make[0]()
    monkeypatch.delenv("GOFR_NATIVE")
    assert fast.native and not slow.native
    texts = TEXTS + [d.decode("latin-1") for d in _fuzz(60, seed=5)]
    for text in texts:
        want = want_tok.encode(text)
        assert fast.encode(text) == want == slow.encode(text), text
        assert fast.decode(fast.encode(text, bos=False)) == text


def test_no_compiler_falls_back_to_python(monkeypatch):
    from gofr_tpu_torch.native import build as port_build
    monkeypatch.setattr(port_build, "compiler", lambda: None)
    monkeypatch.setattr(port_build, "_loaded", {})
    assert not available("bpe")
    tok = BPETokenizer(_ranks())
    assert not tok.native
    assert tok.encode("the token", bos=False) \
        == JaxBPETokenizer(_ranks()).encode("the token", bos=False)
    assert isinstance(new_request_queue(), PyRequestQueue)


@needs_cc
def test_concurrent_first_builds_never_load_half_a_library(tmp_path,
                                                           monkeypatch):
    """Processes racing the first build each compile to a temporary file
    and rename it into place: all of them load a whole library."""
    import subprocess
    import sys
    script = (
        "import sys\n"
        "from gofr_tpu_torch.native import build\n"
        "from pathlib import Path\n"
        "build.BUILD_DIR = Path(sys.argv[1])\n"
        "from gofr_tpu_torch.native.bpe import NativeBPE\n"
        "r = {bytes([i]): i for i in range(256)}; r[b'ab'] = 256\n"
        "print(NativeBPE(r).encode(b'abab'))\n")
    procs = [subprocess.Popen([sys.executable, "-c", script, str(tmp_path)],
                              stdout=subprocess.PIPE, text=True)
             for _ in range(3)]
    outs = [p.communicate(timeout=180)[0].strip() for p in procs]
    assert [p.returncode for p in procs] == [0, 0, 0]
    assert outs == ["[256, 256]"] * 3
    libs = list(tmp_path.iterdir())
    assert [p.suffix for p in libs] == [".so"], libs   # no temp file left


# ---------------------------------------------------------- batch queue
@needs_cc
def test_new_request_queue_is_native():
    assert isinstance(new_request_queue(), RequestQueue)


@pytest.mark.parametrize("make", [
    pytest.param(lambda: RequestQueue(), id="native", marks=needs_cc),
    pytest.param(lambda: PyRequestQueue(), id="python"),
])
class TestRequestQueueSemantics:
    def test_put_pop_order(self, make):
        q = make()
        for i in range(5):
            assert q.put(f"r{i}")
        assert q.qsize() == 5
        assert q.pop_batch(3, first_wait_s=0.1) == ["r0", "r1", "r2"]
        assert q.pop_batch(10, first_wait_s=0.1) == ["r3", "r4"]

    def test_capacity_refuses_when_full(self, make):
        q = type(make())(2)
        assert q.put("a") and q.put("b") and not q.put("c")
        assert q.pop_batch(4, first_wait_s=0.1) == ["a", "b"]

    def test_timeout_returns_empty(self, make):
        q = make()
        start = time.perf_counter()
        assert q.pop_batch(4, first_wait_s=0.05) == []
        assert time.perf_counter() - start < 1.0

    def test_close_returns_none_after_drain(self, make):
        q = make()
        q.put("last")
        q.close()
        assert not q.put("late")
        assert q.pop_batch(4, first_wait_s=0.05) == ["last"]
        assert q.pop_batch(4, first_wait_s=0.05) is None

    def test_blocking_pop_wakes_on_push(self, make):
        q = make()
        got = []

        def consumer():
            got.extend(q.pop_batch(4, first_wait_s=5.0) or [])

        t = threading.Thread(target=consumer)
        t.start()
        time.sleep(0.05)
        q.put("wake")
        t.join(timeout=5)
        assert not t.is_alive() and got == ["wake"]

    def test_drain_window_coalesces_stragglers(self, make):
        q = make()
        q.put("a")

        def late_producer():
            time.sleep(0.03)
            q.put("b")

        t = threading.Thread(target=late_producer)
        t.start()
        batch = q.pop_batch(4, first_wait_s=0.5, drain_wait_s=0.3)
        t.join()
        assert batch == ["a", "b"]

    def test_get_nowait_compat(self, make):
        q = make()
        q.put("x")
        assert q.get_nowait() == "x"
        with pytest.raises(queue_mod.Empty):
            q.get_nowait()

    def test_many_producers_one_consumer(self, make):
        q = make()
        n_producers, per = 8, 50

        def producer(base):
            for i in range(per):
                q.put(base + i)

        threads = [threading.Thread(target=producer, args=(k * 1000,))
                   for k in range(n_producers)]
        for t in threads:
            t.start()
        seen = []
        deadline = time.time() + 10
        while len(seen) < n_producers * per and time.time() < deadline:
            seen.extend(q.pop_batch(64, first_wait_s=0.5) or [])
        for t in threads:
            t.join()
        assert len(seen) == len(set(seen)) == n_producers * per
