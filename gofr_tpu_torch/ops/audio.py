"""Audio frontend: the Whisper log-mel spectrogram on tensors
(counterpart of ``gofr_tpu/ops/audio.py``).

16 kHz PCM ``[T]`` or ``[B, T]`` -> log-mel ``[B, frames, n_mels]`` on
the audio's device: frames are a strided view (``unfold``), the STFT is
``torch.fft.rfft`` over periodic-Hann-windowed frames, and the mel
projection is one product with a filterbank built in numpy (a copy of
the JAX package's, bit for bit).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

SAMPLE_RATE = 16000
N_FFT = 400
HOP_LENGTH = 160
CHUNK_SECONDS = 30


def _hz_to_mel(hz):
    return 2595.0 * np.log10(1.0 + np.asarray(hz) / 700.0)


def _mel_to_hz(mel):
    return 700.0 * (10.0 ** (np.asarray(mel) / 2595.0) - 1.0)


@functools.lru_cache(maxsize=8)
def mel_filterbank(n_mels: int = 80, n_fft: int = N_FFT,
                   sample_rate: int = SAMPLE_RATE) -> np.ndarray:
    """[n_fft//2+1, n_mels] triangular filters (HTK mel scale),
    area-normalised per filter. Cached: treat the result as read-only."""
    n_bins = n_fft // 2 + 1
    fft_freqs = np.linspace(0, sample_rate / 2, n_bins)
    mel_points = np.linspace(_hz_to_mel(0.0), _hz_to_mel(sample_rate / 2),
                             n_mels + 2)
    hz_points = _mel_to_hz(mel_points)
    bank = np.zeros((n_bins, n_mels), dtype=np.float32)
    for m in range(n_mels):
        left, center, right = hz_points[m], hz_points[m + 1], hz_points[m + 2]
        up = (fft_freqs - left) / max(center - left, 1e-10)
        down = (right - fft_freqs) / max(right - center, 1e-10)
        tri = np.maximum(0.0, np.minimum(up, down))
        norm = (right - left) / 2
        bank[:, m] = tri / max(norm, 1e-10)
    return bank


def _window(n_fft: int, device: torch.device) -> torch.Tensor:
    """The periodic Hann window, ``jnp.hanning(n_fft + 1)[:-1]``: taken
    in float64, then rounded to float32 as the JAX package does."""
    return torch.hann_window(n_fft, periodic=True, dtype=torch.float64,
                             device=device).float()


def log_mel_spectrogram(audio: torch.Tensor, *, n_mels: int = 80,
                        n_fft: int = N_FFT, hop: int = HOP_LENGTH,
                        sample_rate: int = SAMPLE_RATE,
                        pad_to_frames: int | None = None) -> torch.Tensor:
    """PCM [T] or [B, T] float in [-1, 1] -> float32 log-mel [B, frames,
    n_mels].

    The Whisper recipe: the signal reflect-padded by ``n_fft // 2`` on
    each side, the periodic Hann window, the power spectrum ``|rfft|²``,
    the mel projection, ``log10`` clamped to 8 decades below each batch
    row's maximum over (frames, mels), scaled by ``(x + 4) / 4``. The
    clamp is taken before ``pad_to_frames`` right-pads (with exact
    zeros) or truncates to a fixed frame count.
    """
    if audio.ndim == 1:
        audio = audio[None, :]
    audio = audio.float()
    pad = n_fft // 2
    audio = F.pad(audio[:, None, :], (pad, pad), mode="reflect")[:, 0]
    frames = audio.unfold(-1, n_fft, hop)            # [B, frames, n_fft]
    spectrum = torch.fft.rfft(frames * _window(n_fft, audio.device),
                              n=n_fft, dim=-1)
    power = spectrum.abs() ** 2                      # [B, frames, bins]
    bank = torch.from_numpy(mel_filterbank(n_mels, n_fft, sample_rate)) \
        .to(audio.device)
    mel = power @ bank                               # [B, frames, n_mels]

    log_mel = torch.log10(torch.clamp(mel, min=1e-10))
    log_mel = torch.maximum(
        log_mel, log_mel.amax(dim=(-2, -1), keepdim=True) - 8.0)
    log_mel = (log_mel + 4.0) / 4.0

    if pad_to_frames is not None:
        have = log_mel.shape[1]
        if have < pad_to_frames:
            log_mel = F.pad(log_mel, (0, 0, 0, pad_to_frames - have))
        else:
            log_mel = log_mel[:, :pad_to_frames, :]
    return log_mel
