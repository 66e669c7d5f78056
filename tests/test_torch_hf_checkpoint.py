"""Local HF Llama checkpoints, the BPE tokenizer and the checkpoint app
in the port, against the JAX package, on the CPU.

- A checkpoint the JAX package writes (tied, untied, bf16, and split
  into two shards with an index) loads in the port exactly as
  ``params_from_jax`` of JAX's load; the port reads BF16 with no
  ``ml_dtypes``; quantizing on load equals quantizing after it (and
  JAX's quantize on load); a checkpoint the port writes (one file or
  shards) loads in JAX's loader exactly.
- The errors and caps: a missing tensor, ``max_seq`` capped and never
  raised, ``rope_scaling`` round-tripped, ``MODEL_DTYPE=int8`` refused.
- ``BPETokenizer.from_hf_json`` gives the ids of JAX's pure-Python one
  on a ``tokenizer.json`` written here (unicode, runs of spaces and
  newlines, a merge order that differs from the id order).
- The app's checkpoint engine (``app_engine`` with ``MODEL_PATH``, plain
  and ``MODEL_QUANT=int8``) answers ``POST /chat`` with the JAX engine's
  greedy tokens on the same checkpoint and prompt ids.
"""

import json
import sys
import threading
import time
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gofr_tpu.models import hf_checkpoint as jhf
from gofr_tpu.models import llama as jllama
from gofr_tpu.serving.engine import EngineConfig as JaxEngineConfig
from gofr_tpu.serving.engine import SamplingParams as JaxSamplingParams
from gofr_tpu.serving.glue import llama_engine as jax_llama_engine
from gofr_tpu.serving.tokenizer import BPETokenizer as JaxBPETokenizer
from gofr_tpu_torch.models import hf_checkpoint as thf
from gofr_tpu_torch.models.convert import params_from_jax
from gofr_tpu_torch.ops import quant as tq
from gofr_tpu_torch.serving.app import app_engine, build_server
from gofr_tpu_torch.serving.tokenizer import BPETokenizer

torch.set_num_threads(2)


def _jax_config(tie=False, dtype=jnp.float32, **kw):
    return jllama.LlamaConfig.tiny().scaled(tie_embeddings=tie, dtype=dtype,
                                            **kw)


def _write_jax(tmp_path, tie=False, dtype=jnp.float32, sharded=False, **kw):
    """A tiny checkpoint saved by the JAX package; ``sharded`` splits its
    one file into two with JAX's writer and adds the index."""
    jc = _jax_config(tie, dtype, **kw)
    params = jllama.llama_init(jax.random.key(3), jc)
    d = tmp_path / "ckpt"
    jhf.save_llama_checkpoint(params, jc, d)
    if sharded:
        tensors = dict(jhf.read_safetensors(d / "model.safetensors"))
        names = sorted(tensors)
        weight_map = {}
        for i, part in enumerate((names[:len(names) // 2],
                                  names[len(names) // 2:])):
            fname = f"model-{i + 1:05d}-of-00002.safetensors"
            jhf.write_safetensors(d / fname, {n: np.asarray(tensors[n])
                                              for n in part})
            weight_map.update({n: fname for n in part})
        (d / "model.safetensors").unlink()
        (d / "model.safetensors.index.json").write_text(
            json.dumps({"weight_map": weight_map}))
    return d


def _tree(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_tree(tree[k], f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _assert_trees_equal(got, want):
    g, w = _tree(got), _tree(want)
    assert g.keys() == w.keys()
    for name in g:
        assert g[name].dtype == w[name].dtype, name
        torch.testing.assert_close(g[name], w[name], rtol=0, atol=0,
                                   msg=name)


@pytest.mark.parametrize("tie,dtype,sharded", [
    (False, jnp.float32, False), (True, jnp.float32, False),
    (False, jnp.bfloat16, False), (True, jnp.bfloat16, True)],
    ids=["untied-f32", "tied-f32", "untied-bf16", "tied-bf16-sharded"])
def test_port_loads_a_jax_checkpoint_exactly(tmp_path, tie, dtype, sharded):
    d = _write_jax(tmp_path, tie, dtype, sharded)
    jparams, jcfg = jhf.load_llama_checkpoint(d)
    tparams, tcfg = thf.load_llama_checkpoint(d, device="cpu")
    assert tcfg.tie_embeddings == tie == jcfg.tie_embeddings
    assert tcfg.dtype == torch.bfloat16
    assert ("lm_head" in tparams) == (not tie)
    _assert_trees_equal(tparams, params_from_jax(
        jax.tree.map(np.asarray, jparams), tcfg, "cpu"))
    # a float32 serving dtype keeps the stored values
    f32, _ = thf.load_llama_checkpoint(d, device="cpu", dtype=torch.float32)
    assert f32["layers"]["wq"].dtype == torch.float32


def test_port_reads_bf16_without_ml_dtypes(tmp_path, monkeypatch):
    d = _write_jax(tmp_path, dtype=jnp.bfloat16)
    want = np.asarray(jhf.read_safetensors(d / "model.safetensors")
                      ["model.embed_tokens.weight"]).astype(np.float32)
    monkeypatch.setitem(sys.modules, "ml_dtypes", None)   # import fails
    got = thf.read_safetensors(d / "model.safetensors")
    emb = got["model.embed_tokens.weight"]
    assert emb.dtype == torch.bfloat16 and emb.shape == (256, 64)
    np.testing.assert_array_equal(emb.float().numpy(), want)


@pytest.mark.parametrize("form", ["int8", "int4"])
@pytest.mark.parametrize("tie", [False, True], ids=["untied", "tied"])
def test_quantize_on_load_equals_quantize_after_load(tmp_path, form, tie):
    d = _write_jax(tmp_path, tie, jnp.bfloat16)
    plain, cfg = thf.load_llama_checkpoint(d, device="cpu")
    on_load, _ = thf.load_llama_checkpoint(d, device="cpu", quantize=form)
    _assert_trees_equal(on_load,
                        getattr(tq, f"quantize_llama_{form}")(plain))
    jparams, _ = jhf.load_llama_checkpoint(d, quantize=form)
    _assert_trees_equal(on_load, params_from_jax(
        jax.tree.map(np.asarray, jparams), cfg, "cpu"))


@pytest.mark.parametrize("shards", [1, 2])
@pytest.mark.parametrize("tie", [False, True], ids=["untied", "tied"])
def test_jax_loads_a_port_checkpoint_exactly(tmp_path, shards, tie):
    d = _write_jax(tmp_path, tie, jnp.bfloat16)
    tparams, tcfg = thf.load_llama_checkpoint(d, device="cpu")
    out = tmp_path / "port"
    thf.save_llama_checkpoint(tparams, tcfg, out, shards=shards)
    assert (out / "model.safetensors.index.json").is_file() == (shards > 1)
    jparams, jcfg = jhf.load_llama_checkpoint(out)
    assert jhf.llama_config_to_hf(jcfg) == thf.llama_config_to_hf(tcfg)
    _assert_trees_equal(params_from_jax(jax.tree.map(np.asarray, jparams),
                                        tcfg, "cpu"), tparams)
    again, _ = thf.load_llama_checkpoint(out, device="cpu")
    _assert_trees_equal(again, tparams)


def test_missing_tensor_max_seq_cap_rope_scaling_and_dtype_names(tmp_path):
    scaling = {"rope_type": "llama3", "factor": 8.0,
               "low_freq_factor": 1.0, "high_freq_factor": 4.0,
               "original_max_position_embeddings": 64}
    d = _write_jax(tmp_path, rope_scaling=scaling)
    _, cfg = thf.load_llama_checkpoint(d, device="cpu", max_seq=64)
    assert cfg.max_seq == 64 and cfg.rope_scaling == scaling
    _, cfg = thf.load_llama_checkpoint(d, device="cpu", max_seq=100000)
    assert cfg.max_seq == 128                      # a cap, never a raise
    assert thf.llama_config_to_hf(cfg) == jhf.llama_config_to_hf(
        jhf.llama_config_from_hf(json.loads((d / "config.json").read_text())))

    tensors = {name: t.clone() for name, t in
               thf.read_safetensors(d / "model.safetensors").items()}
    del tensors["model.norm.weight"]
    thf.write_safetensors(d / "model.safetensors", tensors)
    with pytest.raises(KeyError, match="missing tensor 'model.norm.weight'"):
        thf.load_llama_checkpoint(d, device="cpu")
    with pytest.raises(FileNotFoundError):
        thf.load_llama_checkpoint(tmp_path, device="cpu")

    assert thf.resolve_serving_dtype(" BF16 ") == torch.bfloat16
    assert thf.resolve_serving_dtype("fp32") == torch.float32
    with pytest.raises(ValueError) as port_err:
        thf.resolve_serving_dtype("int8")
    with pytest.raises(ValueError) as jax_err:
        jhf.resolve_serving_dtype("int8")
    assert str(port_err.value) == str(jax_err.value)
    with pytest.raises(ValueError, match="quantize must be"):
        thf.load_llama_checkpoint(d, device="cpu", quantize="int2")


# ------------------------------------------------------------ tokenizer

def _byte_chars() -> dict[int, str]:
    from gofr_tpu_torch.serving.tokenizer import _byte_level_table
    return {b: c for c, b in _byte_level_table().items()}


def _write_tokenizer(path, vocab_size=320):
    """A byte-level BPE ``tokenizer.json``: the 256 bytes under ids in a
    shuffled order, merges whose ids run against their priority, and the
    Llama-3 specials past them."""
    chars = _byte_chars()
    rng = np.random.default_rng(5)
    vocab = {chars[b]: int(i) for b, i in enumerate(rng.permutation(256))}
    pairs = [("Ġ", "t"), ("h", "e"), ("Ġt", "he"), ("l", "l"), ("e", "ll"),
             ("b", "c"), ("a", "b"), ("Ã", "©"), ("Ġ", "Ġ"), ("o", "r")]
    merges = []
    for m, (left, right) in enumerate(pairs):
        merges.append(f"{left} {right}")
        vocab[left + right] = 256 + len(pairs) - 1 - m    # ids run backwards
    added = [{"id": vocab_size - 20, "content": "<|begin_of_text|>"},
             {"id": vocab_size - 19, "content": "<|end_of_text|>"}]
    path.write_text(json.dumps({"model": {"type": "BPE", "vocab": vocab,
                                          "merges": merges},
                                "added_tokens": added}))
    return path


TEXTS = ["the theme", "abc bcab", "héllo wörld, café ✓ 你好!",
         "  two  spaces\n\n\tand tabs   ", "it's 12345 o'clock", ""]


def test_bpe_ids_equal_jax_pure_python_bpe(tmp_path):
    path = _write_tokenizer(tmp_path / "tokenizer.json")
    tok = BPETokenizer.from_hf_json(path)
    jtok = JaxBPETokenizer.from_hf_json(path)
    jtok._native = None
    for text in TEXTS:
        ids = tok.encode(text)
        assert ids == jtok.encode(text), text
        assert tok.decode(ids[1:]) == text
    assert tok.bos_id == 300 and tok.eos_id == 301
    assert (tok.bos_id, tok.eos_id, tok.pad_id, tok.vocab_size) == \
        (jtok.bos_id, jtok.eos_id, jtok.pad_id, jtok.vocab_size)
    # the merge list, not the id order, decides: "bc" (merge 5) before
    # "ab" (merge 6) although "ab" has the lower id
    vocab = json.loads(path.read_text())["model"]["vocab"]
    assert vocab["ab"] < vocab["bc"]
    assert tok.encode("abc", bos=False) == [vocab["a"], vocab["bc"]]


# ------------------------------------------------------------------ app

def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as resp:
        return json.loads(resp.read())


@pytest.mark.parametrize("quant", [None, "int8"], ids=["bf16", "int8"])
def test_app_serves_a_checkpoint_like_the_jax_engine(tmp_path, quant):
    d = _write_jax(tmp_path, vocab_size=320)
    _write_tokenizer(d / "tokenizer.json")
    env = {"MODEL_PATH": str(d), "MODEL_DTYPE": "float32",
           "MODEL_MAX_SEQ": "96", **({"MODEL_QUANT": quant} if quant else {})}
    engine, tokenizer, name = app_engine(env, device="cpu")
    assert name == "ckpt" and isinstance(tokenizer, BPETokenizer)
    assert engine.config.max_seq == 96
    assert engine.config.eos_id == tokenizer.eos_id == 301
    assert tq.is_quantized(engine.params["embed"]) == (quant is not None)
    prompt = "the theme of héllo wörld"
    server = build_server(engine, tokenizer, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    engine.start()
    thread.start()
    try:
        got = _post(f"http://127.0.0.1:{server.server_address[1]}/chat",
                    {"prompt": prompt, "max_tokens": 10,
                     "temperature": 0})["data"]
    finally:
        server.shutdown()
        server.server_close()
        engine.stop()
    ids = tokenizer.encode(prompt)
    assert got["usage"]["prompt_tokens"] == len(ids) < len(prompt.encode())

    jparams, jcfg = jhf.load_llama_checkpoint(d, quantize=quant,
                                              max_seq=96, dtype=jnp.float32)
    jeng = jax_llama_engine(jparams, jcfg, JaxEngineConfig(
        max_batch=8, max_seq=96, page_size=64, seed=0, eos_id=301,
        kv_layout="paged", paged_attention="interpret",
        compile_cache_dir=None), implementation="xla")
    jeng.start()
    try:
        req = jeng.submit(ids, JaxSamplingParams(temperature=0.0,
                                                 max_new_tokens=10))
        deadline = time.time() + 120
        while req.finished_at is None and req.error is None \
                and time.time() < deadline:
            time.sleep(0.005)
    finally:
        jeng.stop()
    assert req.error is None
    assert got["tokens"] == list(req.generated)
