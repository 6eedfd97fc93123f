"""Spectrogram helpers.

Counterpart of piper_tpu/ops/stft.py. Only the window the MB-iSTFT
vocoder's inverse STFT needs (ops/istft.py) is here: the spectrogram
and mel ops belong to training.
"""

from __future__ import annotations

import math

import numpy as np


def hann_window(win_length: int) -> np.ndarray:
    """torch.hann_window (periodic), float32 (piper_tpu/ops/stft.py:23)."""
    n = np.arange(win_length)
    return (0.5 - 0.5 * np.cos(2.0 * math.pi * n / win_length)).astype(np.float32)
