"""Local HF Whisper checkpoints in the port (the Whisper half of
``gofr_tpu_torch/models/hf_checkpoint.py``) against the JAX package's, on
the CPU, at ``WhisperConfig.tiny_test()``.

- A checkpoint the JAX package writes (float32 and bf16) loads in the
  port exactly as ``whisper_params_from_jax`` of JAX's own load of it
  (the convolutions arrive ``[out, in, k]``, as Hugging Face stores
  them); a checkpoint the port writes loads in JAX's loader exactly.
- The config both ways equals JAX's; a missing tensor is named; encoder
  and decoder head counts that differ are refused.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gofr_tpu.models import hf_checkpoint as jhf
from gofr_tpu.models import whisper as jw
from gofr_tpu_torch.models import hf_checkpoint as thf
from gofr_tpu_torch.models import whisper as tw
from gofr_tpu_torch.models.convert import whisper_params_from_jax

torch.set_num_threads(2)

JCFG = jw.WhisperConfig.tiny_test()


def _leaves(tree, prefix=""):
    out = {}
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            out.update(_leaves(tree[k], f"{prefix}/{k}"))
        else:
            out[f"{prefix}/{k}"] = tree[k]
    return out


def _assert_trees_equal(got: dict, want: dict) -> None:
    got, want = _leaves(got), _leaves(want)
    assert set(got) == set(want)
    for name in got:
        assert got[name].dtype == want[name].dtype, name
        assert torch.equal(got[name], want[name]), name


def _write_jax(tmp_path, dtype=jnp.float32):
    cfg = JCFG.scaled(dtype=dtype)
    params = jw.whisper_init(jax.random.key(4), cfg)
    directory = tmp_path / "whisper"
    jhf.save_whisper_checkpoint(params, cfg, directory)
    return directory, params


@pytest.mark.parametrize("dtype,load_dtype", [
    (jnp.float32, torch.float32), (jnp.float32, None),
    (jnp.bfloat16, None)])
def test_a_jax_checkpoint_loads_as_the_converted_jax_load(tmp_path, dtype,
                                                          load_dtype):
    directory, _ = _write_jax(tmp_path, dtype)
    jax_dtype = None if load_dtype is None else jnp.float32
    j_params, j_config = jhf.load_whisper_checkpoint(directory,
                                                     dtype=jax_dtype)
    t_params, t_config = thf.load_whisper_checkpoint(
        directory, dtype=load_dtype, device="cpu")
    assert t_config.dtype == (load_dtype or torch.bfloat16)
    for field in ("vocab_size", "n_mels", "dim", "n_heads",
                  "n_audio_layers", "n_text_layers", "audio_ctx",
                  "audio_frames", "text_ctx", "sot_token", "eot_token"):
        assert getattr(t_config, field) == getattr(j_config, field)
    want = whisper_params_from_jax(jax.tree.map(np.asarray, j_params),
                                   t_config, "cpu")
    _assert_trees_equal(t_params, want)
    assert t_params["conv2_w"].shape == (JCFG.dim, JCFG.dim, 3)


def test_the_loaded_checkpoint_transcribes_as_jax(tmp_path):
    directory, _ = _write_jax(tmp_path)
    j_params, _ = jhf.load_whisper_checkpoint(directory, dtype=jnp.float32)
    t_params, t_config = thf.load_whisper_checkpoint(
        directory, dtype=torch.float32, device="cpu")
    mel = np.random.default_rng(0).standard_normal(
        (2, JCFG.audio_frames, JCFG.n_mels)).astype(np.float32)
    tokens, lengths = jw.transcribe_greedy(j_params, jnp.asarray(mel), JCFG,
                                           max_tokens=6)
    t_tokens, t_lengths = tw.transcribe_greedy(
        t_params, torch.from_numpy(mel), t_config, max_tokens=6)
    assert np.array_equal(t_tokens.numpy(), np.asarray(tokens))
    assert np.array_equal(t_lengths.numpy(), np.asarray(lengths))


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_a_port_checkpoint_loads_in_jax_exactly(tmp_path, dtype):
    cfg = JCFG.scaled(dtype=dtype)
    j_params = jw.whisper_init(jax.random.key(5), cfg)
    t_config = tw.WhisperConfig.tiny_test().scaled(
        dtype=torch.float32 if dtype == jnp.float32 else torch.bfloat16)
    t_params = whisper_params_from_jax(jax.tree.map(np.asarray, j_params),
                                       t_config, "cpu")
    directory = tmp_path / "port"
    thf.save_whisper_checkpoint(t_params, t_config, directory)
    assert json.loads((directory / "config.json").read_text()) == \
        jhf.whisper_config_to_hf(cfg)
    back, _ = jhf.load_whisper_checkpoint(directory, dtype=dtype)
    got, want = _leaves(back), _leaves(j_params)
    assert set(got) == set(want)
    for name in got:
        assert got[name].dtype == want[name].dtype, name
        assert np.array_equal(np.asarray(got[name]).astype(np.float32),
                              np.asarray(want[name]).astype(np.float32)), name
    # and the port reads its own file back bit for bit
    again, _ = thf.load_whisper_checkpoint(directory, dtype=t_config.dtype,
                                           device="cpu")
    _assert_trees_equal(again, t_params)


def _port_config(j):
    """A JAX WhisperConfig's fields on the port's (dtype aside)."""
    return tw.WhisperConfig(**{f: getattr(j, f) for f in (
        "vocab_size", "n_mels", "audio_frames", "audio_ctx", "text_ctx",
        "dim", "n_heads", "n_audio_layers", "n_text_layers", "sot_token",
        "eot_token")})


def test_the_config_maps_match_jax():
    for name in ("tiny_test", "whisper_tiny", "whisper_large_v3"):
        t = getattr(tw.WhisperConfig, name)()
        j = getattr(jw.WhisperConfig, name)()
        hf = jhf.whisper_config_to_hf(j)
        assert thf.whisper_config_to_hf(t) == hf
        back = thf.whisper_config_from_hf(hf)
        assert back == _port_config(jhf.whisper_config_from_hf(hf))


def test_a_missing_tensor_is_named(tmp_path):
    directory, _ = _write_jax(tmp_path)
    tensors = thf.read_safetensors(directory / "model.safetensors")
    gone = "model.decoder.layers.1.encoder_attn.k_proj.weight"
    kept = {k: v.clone() for k, v in tensors.items() if k != gone}
    del tensors
    thf.write_safetensors(directory / "model.safetensors", kept)
    with pytest.raises(KeyError, match="encoder_attn.k_proj"):
        thf.load_whisper_checkpoint(directory, device="cpu")


def test_mismatched_head_counts_are_refused(tmp_path):
    directory, _ = _write_jax(tmp_path)
    cfg = json.loads((directory / "config.json").read_text())
    cfg["decoder_attention_heads"] = cfg["encoder_attention_heads"] * 2
    (directory / "config.json").write_text(json.dumps(cfg))
    with pytest.raises(ValueError, match="decoder_attention_heads"):
        thf.load_whisper_checkpoint(directory, device="cpu")
    with pytest.raises(ValueError, match="decoder_attention_heads"):
        jhf.load_whisper_checkpoint(directory)


def test_loading_onto_cuda_without_a_card_raises(tmp_path, monkeypatch):
    directory, _ = _write_jax(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        thf.load_whisper_checkpoint(directory)
