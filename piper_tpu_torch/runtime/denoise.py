"""Spectral bias denoiser.

Counterpart of piper_tpu/runtime/denoise.py, the same numpy code; the
bias comes from the port's TorchVoice (on the card, through both CUDA
kernels). Counterpart of the reference's (dormant) waveglow-style
denoiser (src/python/piper_train/infer_onnx.py:105-196: `denoise`,
`transform`, `inverse`, `stft`, `istft`): synthesize a "bias" audio from
blank input, take its magnitude spectrum, and subtract `strength * bias`
from the magnitude of real synthesized audio before resynthesis with
the original phase.

Divergences (the reference's driver code for this is commented out and
stale — its `transform(audio)` iterates a 1-D array sample-by-sample):
- proper normalized overlap-add resynthesis (the reference's istft
  applies the hann window twice with no COLA normalization, scaling
  output by 1.5x);
- output trimmed to the input length;
- the FFT path is vectorized (numpy rfft/irfft over all frames at
  once) rather than a per-frame Python loop.

Parameters match the reference: fft_size 1024, hop 256, hann window,
frames at range(0, len - fft_size, hop).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

FFT_SIZE = 1024  # infer_onnx.py:176 (istft default fft_size=1024)
HOP = 256


def _frames(n: int) -> int:
    # reference framing: range(0, n - fft_size, hop) — exclusive
    return max(0, (n - FFT_SIZE + HOP - 1) // HOP)


def stft_mag_phase(audio: np.ndarray):
    """1-D float audio -> (magnitude, phase), each (frames, bins)."""
    n_frames = _frames(audio.shape[-1])
    window = np.hanning(FFT_SIZE)
    idx = np.arange(FFT_SIZE)[None, :] + HOP * np.arange(n_frames)[:, None]
    spec = np.fft.rfft(window * audio[idx], axis=-1)
    return np.abs(spec), np.angle(spec)


def istft(magnitude: np.ndarray, phase: np.ndarray, out_len: int) -> np.ndarray:
    """Normalized overlap-add inverse of `stft_mag_phase`."""
    spec = magnitude * (np.cos(phase) + 1j * np.sin(phase))
    window = np.hanning(FFT_SIZE)
    frames = window * np.fft.irfft(spec, n=FFT_SIZE, axis=-1)
    n_frames = frames.shape[0]
    total = n_frames * HOP + FFT_SIZE
    out = np.zeros(total)
    wsum = np.zeros(total)
    for i in range(n_frames):  # small host loop
        out[i * HOP : i * HOP + FFT_SIZE] += frames[i]
        wsum[i * HOP : i * HOP + FFT_SIZE] += window**2
    out = np.where(wsum > 1e-8, out / np.maximum(wsum, 1e-8), out)
    return out[:out_len].astype(np.float32)


class Denoiser:
    """Subtract a voice's model-bias spectrum from synthesized audio.

    bias_spec: (frames_b, bins) magnitude of blank-input synthesis;
    collapsed to its time-mean profile (the reference repeats the bias
    frames along time — with a blank input the frames are statistically
    identical, and the mean profile is length-independent).
    """

    def __init__(self, bias_spec: np.ndarray):
        self.bias_profile = np.asarray(bias_spec).mean(axis=0, keepdims=True)

    @classmethod
    def for_voice(cls, voice, n_blank_ids: int = 300, syn=None) -> "Denoiser":
        """Build from a loaded TorchVoice by synthesizing blank input
        (reference: text_empty = zeros((1, 300)), infer_onnx.py:39-48).
        300 ids fit one phoneme bucket (the ladder reaches 512).

        `syn` (a SynthesisConfig) seeds the blank synthesis: with a seed
        the bias, and so the denoised audio, is the same in every run and
        on every device. The JAX package passes none (its bias draws
        fresh noise each run)."""
        ids = [0] * n_blank_ids
        audio = voice.synthesize_ids_batch([ids], syn=syn)[0]
        mag, _ = stft_mag_phase(np.asarray(audio, np.float32))
        if mag.shape[0] == 0:
            mag = np.zeros((1, FFT_SIZE // 2 + 1), np.float32)
        return cls(mag)

    def __call__(
        self, audio: np.ndarray, strength: float = 0.005
    ) -> np.ndarray:
        audio = np.asarray(audio, np.float32)
        if audio.shape[-1] < FFT_SIZE + HOP:
            return audio  # too short to frame; pass through
        mag, phase = stft_mag_phase(audio)
        mag = np.clip(mag - self.bias_profile * strength, 0.0, None)
        return istft(mag, phase, audio.shape[-1])


def maybe_denoiser(voice, strength: Optional[float], syn=None) -> Optional[Denoiser]:
    """CLI helper: build a Denoiser when strength is set and positive."""
    if not strength or strength <= 0:
        return None
    return Denoiser.for_voice(voice, syn=syn)
