"""The port's audio frontend and Whisper model (``gofr_tpu_torch/ops/
audio.py``, ``models/whisper.py``) against the JAX package's, on the CPU,
at ``WhisperConfig.tiny_test()`` in float32 with weights carried across
by ``whisper_params_from_jax`` and inputs drawn with numpy.

Tolerances: the filterbank bit for bit; log-mel 2e-5 absolute (float32
FFTs of two libraries, measured ≤ 2e-6); encoder states, cross K/V and
prefill hidden states 1e-5 (float32 summation order, measured ≤ 1e-6);
greedy tokens and lengths exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gofr_tpu.models import whisper as jw
from gofr_tpu.ops import audio as jaudio
from gofr_tpu_torch.models import whisper as tw
from gofr_tpu_torch.models.convert import whisper_params_from_jax
from gofr_tpu_torch.ops import audio as taudio

from .torch_parity import HostTensors

torch.set_num_threads(2)

ATOL = 1e-5
MEL_ATOL = 2e-5
JCFG = jw.WhisperConfig.tiny_test()
TCFG = tw.WhisperConfig.tiny_test()
JPARAMS = jw.whisper_init(jax.random.key(0), JCFG)


def _convert(jparams):
    return whisper_params_from_jax(jax.tree.map(np.asarray, jparams), TCFG,
                                   "cpu")


TPARAMS = _convert(JPARAMS)


def _eot_prone():
    """The tiny weights with the end-of-text embedding row tripled: its
    logit then wins at some steps of some rows, so one batch holds rows
    that end early, at different steps, and a row that never ends."""
    params = dict(JPARAMS)
    embed = np.asarray(JPARAMS["embed"]).copy()
    embed[JCFG.eot_token] *= 3.0
    params["embed"] = jnp.asarray(embed)
    return params


def _pcm(seed, shape):
    rng = np.random.default_rng(seed)
    t = np.arange(shape[-1]) / 16000.0
    tone = 0.3 * np.sin(2 * np.pi * rng.uniform(100, 2000) * t)
    return (tone + 0.05 * rng.standard_normal(shape)).astype(np.float32)


def _mel(seed, b=4):
    return np.random.default_rng(seed).standard_normal(
        (b, JCFG.audio_frames, JCFG.n_mels)).astype(np.float32)


# ------------------------------------------------------------------ audio
@pytest.mark.parametrize("n_mels", [8, 80, 128])
def test_mel_filterbank_is_bit_equal(n_mels):
    assert np.array_equal(taudio.mel_filterbank(n_mels),
                          jaudio.mel_filterbank(n_mels))
    assert (taudio.SAMPLE_RATE, taudio.N_FFT, taudio.HOP_LENGTH) == \
        (jaudio.SAMPLE_RATE, jaudio.N_FFT, jaudio.HOP_LENGTH)


@pytest.mark.parametrize("shape", [(6400,), (3, 8000)])
@pytest.mark.parametrize("pad_to_frames", [None, 32, 64, 3000])
def test_log_mel_spectrogram_matches_jax(shape, pad_to_frames):
    pcm = _pcm(len(shape) + (pad_to_frames or 0), shape)
    want = np.asarray(jaudio.log_mel_spectrogram(
        jnp.asarray(pcm), n_mels=80, pad_to_frames=pad_to_frames))
    got = taudio.log_mel_spectrogram(torch.from_numpy(pcm), n_mels=80,
                                     pad_to_frames=pad_to_frames).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=MEL_ATOL, rtol=0)
    frames = 1 + shape[-1] // taudio.HOP_LENGTH
    if pad_to_frames is not None and pad_to_frames > frames:
        # the clamp ran before the padding: padded frames are exact zeros
        assert (got[:, frames:] == 0.0).all()


def test_the_window_is_the_periodic_hann():
    window = taudio._window(400, torch.device("cpu")).numpy()
    assert np.array_equal(window,
                          np.hanning(401)[:-1].astype(np.float32))
    assert not np.array_equal(window, np.hanning(400).astype(np.float32))


# ------------------------------------------------------------------ model
def test_presets_match_the_reference():
    for name in ("tiny_test", "whisper_tiny", "whisper_base",
                 "whisper_small", "whisper_large_v3"):
        j, t = getattr(jw.WhisperConfig, name)(), \
            getattr(tw.WhisperConfig, name)()
        for field in ("vocab_size", "n_mels", "audio_frames", "audio_ctx",
                      "text_ctx", "dim", "n_heads", "n_audio_layers",
                      "n_text_layers", "sot_token", "eot_token"):
            assert getattr(t, field) == getattr(j, field), (name, field)
    assert tw.WhisperConfig() == tw.WhisperConfig.whisper_large_v3() \
        .scaled(n_mels=80)
    assert np.array_equal(tw._sinusoids(1500, 1280),
                          jw._sinusoids(1500, 1280))


def test_param_tree_count_and_init():
    assert tw.param_count(TPARAMS) == jw.param_count(JPARAMS)
    own = tw.whisper_init(TCFG, torch.Generator().manual_seed(0), "cpu")
    assert tw.param_count(own) == jw.param_count(JPARAMS)
    for key, value in own.items():
        if isinstance(value, dict):
            assert set(value) == set(JPARAMS[key])
            for k in value:
                assert value[k].shape == TPARAMS[key][k].shape
        else:
            assert value.shape == TPARAMS[key].shape, key
    # the convolutions are stored [out, in, k]
    assert own["conv1_w"].shape == (TCFG.dim, TCFG.n_mels, 3)
    assert JPARAMS["conv1_w"].shape == (3, JCFG.n_mels, JCFG.dim)


@pytest.mark.parametrize("seed", [0, 1])
def test_whisper_encode_matches_jax(seed):
    # audio_frames 64 is even: an XLA "SAME" stride-2 convolution pads it
    # (0, 1), and a (1, 1) pad would shift every output frame
    mel = _mel(seed)
    want = np.asarray(jw.whisper_encode(JPARAMS, jnp.asarray(mel), JCFG))
    got = tw.whisper_encode(TPARAMS, torch.from_numpy(mel), TCFG).numpy()
    assert got.shape == (4, TCFG.audio_ctx, TCFG.dim)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_a_symmetric_stride_two_pad_is_caught(monkeypatch):
    mel = _mel(0)
    want = np.asarray(jw.whisper_encode(JPARAMS, jnp.asarray(mel), JCFG))
    assert tw._same_pad(3000, 3, 2) == (0, 1)
    assert tw._same_pad(64, 3, 2) == (0, 1)
    assert tw._same_pad(63, 3, 2) == (1, 1)
    assert tw._same_pad(64, 3, 1) == (1, 1)
    monkeypatch.setattr(tw, "_same_pad", lambda length, k, s: (1, 1))
    got = tw.whisper_encode(TPARAMS, torch.from_numpy(mel), TCFG).numpy()
    assert np.abs(got - want).max() > 1e-2


def test_cross_kv_and_decoder_prefill_match_jax():
    mel = _mel(3, b=2)
    enc = jw.whisper_encode(JPARAMS, jnp.asarray(mel), JCFG)
    ck, cv = jw.precompute_cross_kv(JPARAMS, enc, JCFG)
    t_enc = tw.whisper_encode(TPARAMS, torch.from_numpy(mel), TCFG)
    t_ck, t_cv = tw.precompute_cross_kv(TPARAMS, t_enc, TCFG)
    assert t_ck.shape == (TCFG.n_text_layers, 2, TCFG.audio_ctx,
                          TCFG.n_heads, TCFG.head_dim)
    np.testing.assert_allclose(t_ck.numpy(), np.asarray(ck), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(t_cv.numpy(), np.asarray(cv), atol=ATOL,
                               rtol=0)
    tokens = np.random.default_rng(4).integers(0, JCFG.vocab_size, (2, 7))
    hidden, (k, v) = jw._decoder_prefill(
        JPARAMS, jnp.asarray(tokens, jnp.int32), jnp.arange(2, 9), ck, cv,
        JCFG)
    t_hidden, (t_k, t_v) = tw._decoder_prefill(
        TPARAMS, torch.from_numpy(tokens), torch.arange(2, 9), t_ck, t_cv,
        TCFG)
    np.testing.assert_allclose(t_hidden.numpy(), np.asarray(hidden),
                               atol=ATOL, rtol=0)
    np.testing.assert_allclose(t_k.numpy(), np.asarray(k), atol=ATOL, rtol=0)
    np.testing.assert_allclose(t_v.numpy(), np.asarray(v), atol=ATOL, rtol=0)
    np.testing.assert_allclose(
        tw._logits(TPARAMS, t_hidden, TCFG).numpy(),
        np.asarray(jw._logits(JPARAMS, hidden, JCFG)), atol=1e-4, rtol=0)


def test_a_decode_step_matches_jax():
    mel = _mel(5, b=3)
    enc = jw.whisper_encode(JPARAMS, jnp.asarray(mel), JCFG)
    ck, cv = jw.precompute_cross_kv(JPARAMS, enc, JCFG)
    t_ck, t_cv = tw.precompute_cross_kv(
        TPARAMS, tw.whisper_encode(TPARAMS, torch.from_numpy(mel), TCFG),
        TCFG)
    rng = np.random.default_rng(6)
    shape = (JCFG.n_text_layers, 3, 9, JCFG.n_heads, JCFG.head_dim)
    cache_k = rng.standard_normal(shape).astype(np.float32)
    cache_v = rng.standard_normal(shape).astype(np.float32)
    tok = rng.integers(0, JCFG.vocab_size, 3)
    lengths = np.array([4, 4, 4])
    logits, k, v = jw._decoder_step_kv(
        JPARAMS, jnp.asarray(tok, jnp.int32), 4, ck, cv, JCFG,
        jnp.asarray(cache_k), jnp.asarray(cache_v),
        jnp.asarray(lengths, jnp.int32))
    t_logits, t_k, t_v = tw._decoder_step_kv(
        TPARAMS, torch.from_numpy(tok), 4, t_ck, t_cv, TCFG,
        torch.from_numpy(cache_k.copy()), torch.from_numpy(cache_v.copy()),
        torch.from_numpy(lengths))
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(logits),
                               atol=1e-4, rtol=0)
    np.testing.assert_allclose(t_k.numpy(), np.asarray(k), atol=ATOL, rtol=0)
    np.testing.assert_allclose(t_v.numpy(), np.asarray(v), atol=ATOL, rtol=0)


@pytest.mark.parametrize("seed,eot_prone", [(0, False), (7, False),
                                            (1, True), (2, True)])
def test_transcribe_greedy_equals_jax(seed, eot_prone):
    jparams = _eot_prone() if eot_prone else JPARAMS
    tparams = _convert(jparams) if eot_prone else TPARAMS
    mel = _mel(seed)
    tokens, lengths = jw.transcribe_greedy(jparams, jnp.asarray(mel), JCFG,
                                           max_tokens=8)
    t_tokens, t_lengths = tw.transcribe_greedy(
        tparams, torch.from_numpy(mel), TCFG, max_tokens=8)
    assert t_tokens.dtype == torch.int32 and t_lengths.dtype == torch.int32
    assert np.array_equal(t_tokens.numpy(), np.asarray(tokens))
    assert np.array_equal(t_lengths.numpy(), np.asarray(lengths))
    if eot_prone:
        # rows that end early, at different steps, beside one that does not
        n = t_lengths.tolist()
        assert max(n) == 8 and min(n) < 8 and len(set(n)) >= 3
        for row, length in zip(t_tokens.numpy(), n):
            assert (row[length:] == TCFG.eot_token).all()
            assert (row[:length] != TCFG.eot_token).all()


def test_every_row_done_stops_the_loop_with_the_same_output(monkeypatch):
    # once every row has emitted end-of-text the port runs no more
    # decode steps, and its output is the fixed-length loop's
    jparams = dict(JPARAMS)
    embed = np.asarray(JPARAMS["embed"]).copy()
    embed[JCFG.eot_token] *= 50.0
    jparams["embed"] = jnp.asarray(embed)
    mel = _mel(2, b=2)
    tokens, lengths = jw.transcribe_greedy(jparams, jnp.asarray(mel), JCFG,
                                           max_tokens=6)
    steps = []
    real = tw._decoder_step_kv
    monkeypatch.setattr(tw, "_decoder_step_kv",
                        lambda *a, **k: steps.append(1) or real(*a, **k))
    t_tokens, t_lengths = tw.transcribe_greedy(
        _convert(jparams), torch.from_numpy(mel), TCFG, max_tokens=6)
    assert np.array_equal(t_tokens.numpy(), np.asarray(tokens))
    assert np.array_equal(t_lengths.numpy(), np.asarray(lengths))
    first_eot = [int(np.argmax(row == JCFG.eot_token))
                 for row in np.asarray(tokens)]
    assert (np.asarray(tokens)[:, -1] == JCFG.eot_token).all()
    assert len(steps) == max(first_eot) < 5


@pytest.mark.parametrize("samples", [6400, 16000])
def test_transcribe_audio_equals_jax(samples):
    pcm = _pcm(samples, (2, samples))
    tokens, lengths = jw.transcribe_audio(JPARAMS, jnp.asarray(pcm), JCFG,
                                          max_tokens=6)
    t_tokens, t_lengths = tw.transcribe_audio(
        TPARAMS, torch.from_numpy(pcm), TCFG, max_tokens=6)
    assert np.array_equal(t_tokens.numpy(), np.asarray(tokens))
    assert np.array_equal(t_lengths.numpy(), np.asarray(lengths))


def test_encode_and_decode_step_make_no_tensor_from_host_data():
    mel = torch.from_numpy(_mel(8, b=2))
    shape = (TCFG.n_text_layers, 2, 9, TCFG.n_heads, TCFG.head_dim)
    cache_k, cache_v = torch.zeros(shape), torch.zeros(shape)
    tok, lengths = torch.tensor([5, 6]), torch.tensor([3, 3])
    with HostTensors() as host:
        enc = tw.whisper_encode(TPARAMS, mel, TCFG)
        ck, cv = tw.precompute_cross_kv(TPARAMS, enc, TCFG)
        tw._decoder_step_kv(TPARAMS, tok, 3, ck, cv, TCFG, cache_k, cache_v,
                            lengths)
    assert host.count == 0
