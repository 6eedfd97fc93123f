"""MB-iSTFT vocoder: multi-band iSTFT generation head.

Counterpart of piper_tpu/models/vits/istft_generator.py (Kawamura et
al., MB-iSTFT-VITS): a shortened HiFiGAN stack (conv_pre and two
upsample + MRF stages) predicts per-subband magnitude and phase
spectra; a per-band inverse STFT and a PQMF synthesis filterbank
(ops/istft.py) give the waveform. Total upsampling is
prod(upsample_rates) * istft_hop * subbands (256 on the medium preset:
4 * 4 * 4 * 4).

Every op is plain PyTorch (cuDNN convolutions on the card), as the JAX
package keeps this vocoder on XLA: no Pallas kernel runs on its path,
so no CUDA kernel of this port does either. Two modes, as the HiFiGAN
generator's time-major path has:
- mb_istft_generator_rows: each row alone at its own valid length, so
  a row's bits do not depend on the batch it rides in (cuDNN picks its
  algorithm by shape);
- mb_istft_generator_apply: the whole batch under a mask, the JAX
  function; the fixed-shape mode a CUDA graph holds (the streamed
  chunk, and the decode's frame windows: models/vits/model.py
  synthesizer_frames, runtime/voice.py).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Sequence

import torch

from ...config import ModelConfig
from ...ops import nn as tnn
from ...ops.istft import Tables, istft, make_tables, pqmf_synthesis
from . import generator as G
from . import layers as L

Params = Dict[str, Any]


def prepare_mb(cfg: ModelConfig, device) -> Tables:
    """The constant tables of the iSTFT and the PQMF bank on `device`
    (TorchVoice attaches them as params["dec_mb"])."""
    return make_tables(cfg.istft_n_fft, cfg.subbands, device)


def mb_istft_generator_apply(
    p: Params,
    x: torch.Tensor,
    x_mask: Optional[torch.Tensor],
    *,
    cfg: ModelConfig,
    g: Optional[torch.Tensor] = None,
    tables: Optional[Tables] = None,
) -> torch.Tensor:
    """x: (B, T_frames, C) latent; x_mask: (B, T_frames, 1) or None ->
    (B, T_frames * upsample_factor) float32, zero past each row's length
    (istft_generator.py:46-118)."""
    n_bins = cfg.istft_n_fft // 2 + 1
    sub = cfg.subbands
    if tables is None:
        tables = prepare_mb(cfg, x.device)

    x = L.conv(p["conv_pre"], x, padding=3)
    if g is not None:
        x = x + L.dense(p["cond"], g[:, None, :])
    if x_mask is not None:
        x = x * x_mask
    for i, (u, k) in enumerate(zip(cfg.upsample_rates, cfg.upsample_kernel_sizes)):
        x = tnn.leaky_relu(x, G.LRELU_SLOPE)
        x = tnn.conv1d_transpose(
            x, p["ups"][i]["w"], p["ups"][i]["b"], stride=u, padding=(k - u) // 2
        )
        if x_mask is not None:
            x_mask = torch.repeat_interleave(x_mask, u, dim=1)
            x = x * x_mask
        x = G._mrf_nwc(p["resblocks"][i], x, x_mask, cfg)
    x = tnn.leaky_relu(x, 0.01)
    spec = L.conv(p["conv_post"], x, padding=3)  # (B, T', sub * (n_fft + 2))
    if x_mask is not None:
        spec = spec * x_mask

    b, t, _ = spec.shape
    spec = spec.reshape(b, t, sub, cfg.istft_n_fft + 2)
    log_mag = torch.clamp(spec[..., :n_bins], -12.0, 8.0)
    mag = torch.exp(log_mag.float())
    phase = spec[..., n_bins:].float() * math.pi
    # every band at once: (B, T', S, bins) -> (B * S, T', bins)
    re = (mag * torch.cos(phase)).transpose(1, 2).reshape(b * sub, t, n_bins)
    im = (mag * torch.sin(phase)).transpose(1, 2).reshape(b * sub, t, n_bins)
    frame_mask = x_mask[:, :, 0] if x_mask is not None else None
    band_sig = istft(
        re, im, n_fft=cfg.istft_n_fft, hop_length=cfg.istft_hop,
        frame_mask=None if frame_mask is None else frame_mask.repeat_interleave(sub, dim=0),
        tables=tables,
    )  # (B * S, T' * hop)
    band_sig = band_sig.reshape(b, sub, t * cfg.istft_hop).transpose(1, 2)
    if frame_mask is not None:
        # zero the overlap-add spill past the last valid frames, so a
        # padded row equals the row alone (whose trim discards it)
        band_valid = torch.repeat_interleave(frame_mask, cfg.istft_hop, dim=1)
        band_sig = band_sig * band_valid[..., None].to(band_sig.dtype)
    audio = torch.tanh(pqmf_synthesis(band_sig, sub, tables))  # (B, T' * hop * S)
    if x_mask is not None:
        sample_mask = torch.repeat_interleave(x_mask, cfg.istft_hop * sub, dim=1)[:, :, 0]
        audio = audio * sample_mask.to(audio.dtype)
    return audio


def generator_halo(cfg: ModelConfig) -> int:
    """Frames on either side that one output frame of
    mb_istft_generator_apply depends on: conv_pre, each upsample stage's
    transposed conv and MRF block, conv_post, the iSTFT's window and the
    PQMF filters (the last three under one frame each at these rates)."""
    halo = (7 - 1) // 2 + 3  # conv_pre; conv_post, iSTFT, PQMF
    rate = 1
    for u, k in zip(cfg.upsample_rates, cfg.upsample_kernel_sizes):
        rate *= u
        mrf = max(
            sum((kk * d - d) // 2 + ((kk - 1) // 2 if cfg.resblock == "1" else 0) for d in dil)
            for kk, dil in zip(cfg.resblock_kernel_sizes, cfg.resblock_dilation_sizes)
        )
        halo += -(-k // u) + 1 + -(-mrf // rate)
    return halo


def mb_istft_generator_rows(
    p: Params,
    x: torch.Tensor,
    lengths: Sequence[int],
    *,
    cfg: ModelConfig,
    g: Optional[torch.Tensor] = None,
    tables: Optional[Tables] = None,
) -> torch.Tensor:
    """mb_istft_generator_apply one row at a time, each at its own valid
    frame count (host `lengths`) and unmasked, zeros past it: the bits of
    the row synthesized alone, whatever batch it rides in (as
    generator._conv_pre_rows, _nwc_stage_rows and _tconv_tm_rows keep
    HiFiGAN's). Returns (B, T_frames * upsample_factor) float32."""
    u = cfg.upsample_factor
    if tables is None:
        tables = prepare_mb(cfg, x.device)
    out = torch.zeros((x.shape[0], x.shape[1] * u), dtype=torch.float32, device=x.device)
    for r, n in enumerate(lengths):
        if n:
            out[r, : n * u] = mb_istft_generator_apply(
                p, x[r : r + 1, :n], None, cfg=cfg, g=None if g is None else g[r : r + 1],
                tables=tables,
            )[0]
    return out
