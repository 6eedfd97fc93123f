"""Posterior encoder (training): linear spectrogram -> latent z.

Counterpart of piper_tpu/models/vits/posterior.py. Parity: reference
PosteriorEncoder (models.py:257-296) — pre 1x1, WN 16 layers kernel 5
dilation 1, proj to (m, logs), z = m + eps * exp(logs).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from ...config import ModelConfig
from . import layers as L

Params = Dict[str, Any]

POSTERIOR_KERNEL = 5
POSTERIOR_LAYERS = 16


def init_posterior_encoder(r, cfg: ModelConfig) -> Params:
    """Random numpy weights with the distributions of the JAX package's
    init_posterior_encoder (posterior.py:24); `r` is a model.Init."""
    return {
        "pre": r.dense(cfg.spec_channels, cfg.hidden_channels),
        "enc": r.wn(cfg.hidden_channels, POSTERIOR_KERNEL, POSTERIOR_LAYERS, cfg.gin_channels),
        "proj": r.dense(cfg.hidden_channels, 2 * cfg.inter_channels),
    }


def posterior_encode(
    p: Params,
    spec: torch.Tensor,
    y_mask: torch.Tensor,
    *,
    cfg: ModelConfig,
    g: Optional[torch.Tensor] = None,
    noise: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """spec: (B, T_frames, spec_channels); y_mask: (B, T_frames, 1).

    Returns (z, m_q, logs_q). `noise` is standard normal of m's shape;
    None gives the deterministic mean path (posterior.py:40).
    """
    x = L.dense(p["pre"], spec) * y_mask
    x = L.wn_apply(p["enc"], x, y_mask, kernel_size=POSTERIOR_KERNEL, dilation_rate=1, g=g)
    stats = L.dense(p["proj"], x) * y_mask
    m = stats[..., : cfg.inter_channels]
    logs = stats[..., cfg.inter_channels :]
    if noise is None:
        z = m * y_mask
    else:
        z = (m + noise * torch.exp(logs)) * y_mask
    return z, m, logs
