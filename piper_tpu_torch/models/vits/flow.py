"""Residual coupling normalizing flow (latent z <-> prior z_p).

Counterpart of piper_tpu/models/vits/flow.py::flow_apply (line 95).
Parity: reference ResidualCouplingBlock (models.py:212-254) and
ResidualCouplingLayer (modules.py:412-466) with mean_only=True, built on
the WN gated-residual stack (modules.py:132-209), and VITS2's
self-attention block in the conditioner (flow.py:67-75) when a coupling
layer's tree has `attn`.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from ...config import ModelConfig
from . import encoder as E
from . import layers as L

Params = Dict[str, Any]


def coupling_layer_apply(
    p: Params,
    x: torch.Tensor,
    x_mask: torch.Tensor,
    *,
    cfg: ModelConfig,
    g: Optional[torch.Tensor] = None,
    reverse: bool = False,
):
    """Mean-only affine coupling: x1' = m(x0) + x1 (fwd) / x1 - m (rev)."""
    half = x.shape[-1] // 2
    x0, x1 = x[..., :half], x[..., half:]
    h = L.dense(p["pre"], x0) * x_mask
    h = L.wn_apply(
        p["enc"], h, x_mask,
        kernel_size=cfg.flow_kernel_size, dilation_rate=1, g=g,
    )
    if "attn" in p:
        # VITS2: windowed attention, then a residual layer norm; it only
        # shapes m(x0), so the layer stays invertible
        y = E.local_attention_apply(p["attn"], h, x_mask, n_heads=2)
        h = L.layer_norm(p["attn_norm"], h + y) * x_mask
    m = L.dense(p["post"], h) * x_mask
    if not reverse:
        x1 = (m + x1) * x_mask  # exp(logs)=1, mean_only
        return torch.cat([x0, x1], dim=-1), x.new_zeros(x.shape[0])
    x1 = (x1 - m) * x_mask
    return torch.cat([x0, x1], dim=-1)


def flow_apply(
    p: Params,
    x: torch.Tensor,
    x_mask: torch.Tensor,
    *,
    cfg: ModelConfig,
    g: Optional[torch.Tensor] = None,
    reverse: bool = False,
) -> torch.Tensor:
    """z -> z_p (forward) or z_p -> z (reverse). x: (B, T, C)."""
    if not reverse:
        for lp in p["layers"]:
            x, _ = coupling_layer_apply(lp, x, x_mask, cfg=cfg, g=g)
            x = L.flip_channels(x)
    else:
        for lp in reversed(p["layers"]):
            x = L.flip_channels(x)
            x = coupling_layer_apply(lp, x, x_mask, cfg=cfg, g=g, reverse=True)
    return x
