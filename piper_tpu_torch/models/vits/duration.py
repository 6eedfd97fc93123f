"""Duration predictors.

Counterpart of piper_tpu/models/vits/duration.py: sdp_reverse (line
139), sdp_forward_nll (line 186, training), conv_flow_apply (line 47)
and dp_apply (line 275). Parity:
reference StochasticDurationPredictor (models.py:14-117) and
DurationPredictor (models.py:120-165).

Duration math stays float32 in both precisions: only the conditioning
convnets run in the compute dtype; the flow state, the splines and the
final logw are float32.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from ...config import ModelConfig
from ...ops.spline import rational_quadratic_spline
from . import layers as L

Params = Dict[str, Any]

SDP_NUM_BINS = 10
SDP_TAIL_BOUND = 5.0


def conv_flow_apply(
    p: Params,
    x: torch.Tensor,
    x_mask: torch.Tensor,
    *,
    kernel_size: int,
    g: Optional[torch.Tensor] = None,
    reverse: bool = False,
    dtype: torch.dtype = torch.float32,
):
    """x: (B, T, 2). Spline-coupling flow on the second channel half
    (modules.py:469-527). `dtype` is the compute dtype of the
    conditioning stack (pre / DDSConv / proj) only."""
    half = x.shape[-1] // 2
    filter_channels = p["pre"]["w"].shape[-1]
    x0, x1 = x[..., :half], x[..., half:]
    h = L.dense(p["pre"], x0.to(dtype))
    h = L.ddsconv_apply(
        p["convs"], h, x_mask.to(dtype), kernel_size=kernel_size, g=g
    )
    h = L.dense(p["proj"], h).float() * x_mask  # (B, T, half*(3K-1))

    b, t, _ = x0.shape
    h = h.reshape(b, t, half, SDP_NUM_BINS * 3 - 1)
    denom = math.sqrt(filter_channels)
    uw = h[..., :SDP_NUM_BINS] / denom
    uh = h[..., SDP_NUM_BINS : 2 * SDP_NUM_BINS] / denom
    ud = h[..., 2 * SDP_NUM_BINS :]

    x1_new, logabsdet = rational_quadratic_spline(
        x1, uw, uh, ud, inverse=reverse, tail_bound=SDP_TAIL_BOUND
    )
    x = torch.cat([x0, x1_new], dim=-1) * x_mask
    if not reverse:
        return x, torch.sum(logabsdet * x_mask, dim=(1, 2))
    return x


def _sdp_context(
    p: Params, x: torch.Tensor, x_mask: torch.Tensor, *, kernel_size: int,
    g: Optional[torch.Tensor],
) -> torch.Tensor:
    """Shared conditioning stack (models.py:64-70)."""
    x = L.dense(p["pre"], x)
    if g is not None:
        x = x + L.dense(p["cond"], g[:, None, :])
    x = L.ddsconv_apply(p["convs"], x, x_mask, kernel_size=kernel_size)
    return L.dense(p["proj"], x) * x_mask


def sdp_reverse(
    p: Params,
    x: torch.Tensor,
    x_mask: torch.Tensor,
    *,
    cfg: ModelConfig,
    noise_w,
    noise: torch.Tensor,
    g: Optional[torch.Tensor] = None,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Sample log-durations (models.py:108-117).

    x: (B, T, H) text-encoder hidden; noise: (B, T, 2) standard normal;
    noise_w: scalar noise scale; g: (B, gin). Returns logw (B, T, 1).
    """
    x = x.to(dtype)
    x_mask = x_mask.float()
    if g is not None:
        g = g.to(dtype)
    h = _sdp_context(
        p, x, x_mask.to(dtype), kernel_size=cfg.kernel_size, g=g
    )
    z = noise.float() * noise_w

    # reversed(flows)[:-2] + [last] == Flip,CF4,Flip,CF3,Flip,CF2,Flip,EA
    # (models.py:109-110: one unused ConvFlow+Flip pair is dropped).
    for cf in p["flows"]["conv_flows"][:0:-1]:  # CF4, CF3, CF2
        z = L.flip_channels(z)
        z = conv_flow_apply(
            cf, z, x_mask, kernel_size=cfg.kernel_size, g=h, reverse=True,
            dtype=dtype,
        )
    z = L.flip_channels(z)
    z = L.elementwise_affine(p["flows"]["affine"], z, x_mask, reverse=True)
    return z[..., 0:1]


def sdp_forward_nll(
    p: Params,
    x: torch.Tensor,
    x_mask: torch.Tensor,
    w: torch.Tensor,
    *,
    cfg: ModelConfig,
    g: Optional[torch.Tensor],
    noise: torch.Tensor,
) -> torch.Tensor:
    """Training NLL of durations w (B, T, 1) (models.py:72-107), float32.
    The condition x and g are detached, as in the JAX package: the
    duration loss trains the predictor only. noise: (B, T, 2) standard
    normal (the JAX package draws it from its `rng` argument).

    Returns per-example nll + logq, shape (B,).
    """
    x = x.detach().float()
    if g is not None:
        g = g.detach()
    x_mask = x_mask.float()
    w = w.float()
    h = _sdp_context(p, x, x_mask, kernel_size=cfg.kernel_size, g=g)

    # posterior flows (variational dequantization of integer durations)
    h_w = L.dense(p["post_pre"], w)
    h_w = L.ddsconv_apply(p["post_convs"], h_w, x_mask, kernel_size=cfg.kernel_size)
    h_w = L.dense(p["post_proj"], h_w) * x_mask

    e_q = noise.float() * x_mask
    z_q, logdet_tot_q = L.elementwise_affine(p["post_flows"]["affine"], e_q, x_mask, reverse=False)
    for cf in p["post_flows"]["conv_flows"]:  # EA, then 4x(CF, Flip)
        z_q, ld = conv_flow_apply(cf, z_q, x_mask, kernel_size=cfg.kernel_size, g=h + h_w)
        logdet_tot_q = logdet_tot_q + ld
        z_q = L.flip_channels(z_q)

    z_u, z1 = z_q[..., 0:1], z_q[..., 1:2]
    u = torch.sigmoid(z_u) * x_mask
    z0 = (w - u) * x_mask
    logdet_tot_q = logdet_tot_q + torch.sum(
        (F.logsigmoid(z_u) + F.logsigmoid(-z_u)) * x_mask, dim=(1, 2)
    )
    logq = (
        torch.sum(-0.5 * (math.log(2 * math.pi) + e_q.square()) * x_mask, dim=(1, 2))
        - logdet_tot_q
    )

    # main flows forward: Log, EA, 4x(CF, Flip)
    z0_log = torch.log(torch.clamp(z0, min=1e-5)) * x_mask
    logdet_tot = torch.sum(-z0_log, dim=(1, 2))
    z = torch.cat([z0_log, z1], dim=-1)
    z, ld = L.elementwise_affine(p["flows"]["affine"], z, x_mask, reverse=False)
    logdet_tot = logdet_tot + ld
    for cf in p["flows"]["conv_flows"]:
        z, ld = conv_flow_apply(cf, z, x_mask, kernel_size=cfg.kernel_size, g=h)
        logdet_tot = logdet_tot + ld
        z = L.flip_channels(z)
    nll = (
        torch.sum(0.5 * (math.log(2 * math.pi) + z.square()) * x_mask, dim=(1, 2))
        - logdet_tot
    )
    return nll + logq


def dp_apply(
    p: Params,
    x: torch.Tensor,
    x_mask: torch.Tensor,
    *,
    cfg: ModelConfig,
    g: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Deterministic duration predictor (models.py:120-165). Its
    condition x and g are detached, as in the JAX package (duration.py:
    284-286): the duration loss trains the predictor only."""
    x = x.detach()
    if g is not None:
        x = x + L.dense(p["cond"], g.detach()[:, None, :])
    pad = cfg.kernel_size // 2
    x = L.conv(p["conv1"], x * x_mask, padding=pad)
    x = torch.relu(x)
    x = L.layer_norm(p["norm1"], x)
    x = L.conv(p["conv2"], x * x_mask, padding=pad)
    x = torch.relu(x)
    x = L.layer_norm(p["norm2"], x)
    x = L.dense(p["proj"], x * x_mask)
    return x * x_mask
