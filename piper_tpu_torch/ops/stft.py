"""Spectrogram / mel ops.

Counterpart of piper_tpu/ops/stft.py. Parity: reference
mel_processing.py — reflect pad (n_fft-hop)/2, torch.stft(center=False,
hann window), magnitude sqrt(re^2+im^2+1e-6), librosa Slaney mel
filterbank, log dynamic-range compression (clip 1e-5).

Layout as in the JAX package: frames on the second axis, frequency bins
(or mel channels) last. The DFT is a float32 real FFT (torch.fft.rfft,
cuFFT on the card), which autograd differentiates for the generator's
mel loss. The window is hann_window (also the MB-iSTFT vocoder's,
ops/istft.py).
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F


def hann_window(win_length: int) -> np.ndarray:
    """torch.hann_window (periodic), float32 (piper_tpu/ops/stft.py:23)."""
    n = np.arange(win_length)
    return (0.5 - 0.5 * np.cos(2.0 * math.pi * n / win_length)).astype(np.float32)


@lru_cache(maxsize=None)
def mel_filterbank(
    sample_rate: int,
    n_fft: int,
    n_mels: int,
    fmin: float = 0.0,
    fmax: Optional[float] = None,
) -> np.ndarray:
    """Slaney-style mel filterbank, numerically equal to
    librosa.filters.mel(htk=False, norm='slaney') (piper_tpu/ops/stft.py:30).

    Returns (n_mels, n_fft//2 + 1) float32.
    """
    if fmax is None:
        fmax = sample_rate / 2.0
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0

    def hz_to_mel(f):
        f = np.asarray(f, np.float64)
        safe_f = np.maximum(f, 1e-10)
        return np.where(f >= min_log_hz, min_log_mel + np.log(safe_f / min_log_hz) / logstep, f / f_sp)

    def mel_to_hz(m):
        m = np.asarray(m, np.float64)
        return np.where(m >= min_log_mel, min_log_hz * np.exp(logstep * (m - min_log_mel)), f_sp * m)

    n_freqs = n_fft // 2 + 1
    fftfreqs = np.linspace(0, sample_rate / 2.0, n_freqs)
    mel_pts = mel_to_hz(np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels + 2))
    fdiff = np.diff(mel_pts)
    ramps = mel_pts[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0, np.minimum(lower, upper))
    # Slaney normalization
    enorm = 2.0 / (mel_pts[2 : n_mels + 2] - mel_pts[:n_mels])
    weights *= enorm[:, None]
    return weights.astype(np.float32)


def _frame(y: torch.Tensor, frame_length: int, hop: int) -> torch.Tensor:
    """(B, T) -> (B, n_frames, frame_length) overlapping frames (a view)."""
    return y.unfold(-1, frame_length, hop)


def spectrogram(
    y: torch.Tensor,
    *,
    n_fft: int,
    hop_length: int,
    win_length: int,
) -> torch.Tensor:
    """Linear magnitude spectrogram of (B, T) audio: (B, n_frames,
    n_fft//2+1) float32. Parity: mel_processing.spectrogram_torch."""
    pad = (n_fft - hop_length) // 2
    y = F.pad(y.float()[:, None, :], (pad, pad), mode="reflect")[:, 0]
    frames = _frame(y, n_fft, hop_length)
    win = torch.from_numpy(hann_window(win_length)).to(y.device)
    if win_length < n_fft:
        lpad = (n_fft - win_length) // 2
        win = F.pad(win, (lpad, n_fft - win_length - lpad))
    spec = torch.fft.rfft(frames * win, n=n_fft, dim=-1)
    return torch.sqrt(spec.real.square() + spec.imag.square() + 1e-6)


def spec_to_mel(
    spec: torch.Tensor,
    *,
    sample_rate: int,
    n_fft: int,
    n_mels: int,
    fmin: float = 0.0,
    fmax: Optional[float] = None,
) -> torch.Tensor:
    """(B, T, n_freq) linear spec -> (B, T, n_mels) log-mel."""
    basis = torch.from_numpy(mel_filterbank(sample_rate, n_fft, n_mels, fmin, fmax)).to(spec.device)
    mel = torch.matmul(spec, basis.T)
    return torch.log(torch.clamp(mel, min=1e-5))


def mel_spectrogram(
    y: torch.Tensor,
    *,
    sample_rate: int,
    n_fft: int,
    hop_length: int,
    win_length: int,
    n_mels: int,
    fmin: float = 0.0,
    fmax: Optional[float] = None,
) -> torch.Tensor:
    spec = spectrogram(y, n_fft=n_fft, hop_length=hop_length, win_length=win_length)
    return spec_to_mel(
        spec, sample_rate=sample_rate, n_fft=n_fft, n_mels=n_mels, fmin=fmin, fmax=fmax,
    )
