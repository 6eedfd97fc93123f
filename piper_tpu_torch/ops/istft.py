"""iSTFT synthesis and the PQMF multi-band filterbank.

Counterpart of piper_tpu/ops/istft.py: the building blocks of the
MB-iSTFT vocoder (models/vits/istft_generator.py), which predicts per
band magnitude and phase spectra; its audio comes from a per-band
inverse STFT and a PQMF synthesis filterbank.

The inverse real FFT runs in float32 in both precisions, as the JAX
package's does. The constant tables (window, synthesis filters) are
made once per device by `make_tables` and passed in, so a CUDA graph
can hold every op (a capture copies nothing from the host). A batch
row's bits may follow the batch's shape (cuDNN's and cuFFT's choices),
so the decode path runs the generator in frame windows of one shape
(runtime/voice.py).

pqmf_analysis (training's) is not ported.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .stft import hann_window

Tables = Dict[str, torch.Tensor]


def _overlap_add(frames: torch.Tensor, hop_length: int) -> torch.Tensor:
    """(B, T, n_fft) windowed frames -> (B, (T-1)*hop + n_fft) signal:
    the sum of n_fft/hop phase-shifted slices, in slice order
    (piper_tpu/ops/istft.py:27)."""
    b, t, n_fft = frames.shape
    overlap = n_fft // hop_length
    out_len = (t - 1) * hop_length + n_fft
    y = None
    for j in range(overlap):
        seg = frames[:, :, j * hop_length : (j + 1) * hop_length]
        seg = F.pad(seg, (0, 0, j, overlap - 1 - j))
        y = seg if y is None else y + seg
    return y.reshape(b, (t + overlap - 1) * hop_length)[:, :out_len]


def istft(
    spec_real: torch.Tensor,
    spec_imag: torch.Tensor,
    *,
    n_fft: int,
    hop_length: int,
    frame_mask: Optional[torch.Tensor] = None,
    tables: Optional[Tables] = None,
) -> torch.Tensor:
    """Inverse STFT of (B, T_frames, n_fft//2+1) spectra -> (B, T*hop)
    (piper_tpu/ops/istft.py:41-81).

    Hann window, COLA-normalised, center-trimmed to T_frames * hop
    samples. `frame_mask` (B, T) marks valid frames: masked frames add
    nothing and the normalisation envelope counts only valid windows,
    so a padded batch row equals the same row synthesized alone.
    `tables`: make_tables(n_fft, ...) on the spectra's device."""
    assert n_fft % hop_length == 0
    t = spec_real.shape[1]
    frames = torch.fft.irfft(torch.complex(spec_real.float(), spec_imag.float()), n=n_fft, dim=-1)
    win = (tables["window"] if tables is not None
           else torch.from_numpy(hann_window(n_fft)).to(spec_real.device))
    frames = frames * win
    wsq_frames = (win * win).expand(frames.shape)
    if frame_mask is not None:
        m = frame_mask.float()[:, :, None]
        frames = frames * m
        wsq_frames = wsq_frames * m
    y = _overlap_add(frames, hop_length)
    envelope = _overlap_add(wsq_frames, hop_length)
    y = y / torch.clamp(envelope, min=1e-9)
    # trim the half-window padding on both sides (torch.istft center)
    pad = (n_fft - hop_length) // 2
    return y[:, pad : pad + t * hop_length]


@lru_cache(maxsize=None)
def pqmf_filters(
    subbands: int = 4, taps: int = 62, cutoff: float = 0.15, beta: float = 9.0
) -> Tuple[np.ndarray, np.ndarray]:
    """Pseudo-QMF analysis/synthesis filterbanks (cosine-modulated
    Kaiser prototype, the MB-MelGAN design; piper_tpu/ops/istft.py:84).

    Returns (analysis (subbands, taps+1), synthesis (subbands, taps+1)),
    float32. The arrays are shared by every caller: do not write to them."""
    from scipy.signal import firwin

    proto = firwin(taps + 1, cutoff, window=("kaiser", beta))
    n = np.arange(taps + 1)
    analysis = np.zeros((subbands, taps + 1), np.float64)
    synthesis = np.zeros((subbands, taps + 1), np.float64)
    for k in range(subbands):
        phase = (-1) ** k * np.pi / 4
        arg = (2 * k + 1) * np.pi / (2 * subbands) * (n - taps / 2)
        analysis[k] = 2 * proto * np.cos(arg + phase)
        synthesis[k] = 2 * proto * np.cos(arg - phase)
    return analysis.astype(np.float32), synthesis.astype(np.float32)


def _pqmf_weight(subbands: int, device) -> torch.Tensor:
    """The synthesis filters as a conv weight (1, subbands, taps), not
    flipped: the JAX conv is a cross-correlation, as torch's is."""
    return torch.from_numpy(pqmf_filters(subbands)[1].copy()).to(device)[None]


def make_tables(n_fft: int, subbands: int, device) -> Tables:
    """The constant tables of istft and pqmf_synthesis on `device`: the
    Hann window and the synthesis filters."""
    return {
        "window": torch.from_numpy(hann_window(n_fft)).to(device),
        "pqmf": _pqmf_weight(subbands, device),
    }


def pqmf_synthesis(
    bands: torch.Tensor, subbands: int = 4, tables: Optional[Tables] = None
) -> torch.Tensor:
    """(B, T, subbands) band signals -> (B, T*subbands) fullband audio
    (piper_tpu/ops/istft.py:106-126): each band zero-stuffed by
    `subbands` and scaled by it, filtered with its synthesis filter,
    and the bands summed, as one conv over the interleaved signal."""
    weight = tables["pqmf"] if tables is not None else _pqmf_weight(subbands, bands.device)
    weight = weight.to(bands.dtype)
    taps = weight.shape[-1]
    b, t, _ = bands.shape
    up = bands.new_zeros((b, t, subbands, subbands))
    up[:, :, 0, :] = bands * subbands
    up = up.reshape(b, t * subbands, subbands).transpose(1, 2)  # (B, S, T*S)
    pad = (taps - 1) // 2
    out = F.conv1d(F.pad(up, (pad, taps - 1 - pad)), weight)
    return out[:, 0]
