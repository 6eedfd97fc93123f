"""Multi-period + scale discriminators, and VITS2's duration
discriminator (training only).

Counterpart of piper_tpu/models/vits/discriminator.py. Parity: reference
MultiPeriodDiscriminator / DiscriminatorP / DiscriminatorS
(models.py:378-519): one 1D-conv scale discriminator plus
period-{2,3,5,7,11} 2D-conv discriminators over reshaped audio.

The weights keep the JAX package's layouts (conv2d HWIO (kh, kw, in,
out), conv1d (k, in/groups, out)); the convolutions run in torch's
channels-first layout, so the feature maps are NCHW (period) and NCW
(scale), where the JAX package's are NHWC and NWC. The losses read
them only through means, which the layout does not change; the logits
are the same flat vectors. mpd_apply runs each discriminator once on
the real and generated audio stacked on the batch axis.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List

import torch
import torch.nn.functional as F

from ...ops import nn as tnn
from . import layers as L

Params = Dict[str, Any]

PERIODS = (2, 3, 5, 7, 11)
LRELU_SLOPE = 0.1
_P_CHANNELS = [(1, 32), (32, 128), (128, 512), (512, 1024), (1024, 1024)]
# (c_in, c_out, k, stride, groups, pad) of the scale discriminator
_S_SPEC = [
    (1, 16, 15, 1, 1, 7),
    (16, 64, 41, 4, 4, 20),
    (64, 256, 41, 4, 16, 20),
    (256, 1024, 41, 4, 64, 20),
    (1024, 1024, 41, 4, 256, 20),
    (1024, 1024, 5, 1, 1, 2),
]


def _conv2d(p: Params, x: torch.Tensor, *, stride, padding) -> torch.Tensor:
    """NCHW convolution with an HWIO kernel."""
    w = p["w"].to(x.dtype).permute(3, 2, 0, 1)
    return F.conv2d(x, w, p["b"].to(x.dtype), stride=stride, padding=padding)


def _conv1d(p: Params, x: torch.Tensor, *, stride=1, padding=0, groups=1) -> torch.Tensor:
    """NCW convolution with a (k, in/groups, out) kernel."""
    w = p["w"].to(x.dtype).permute(2, 1, 0)
    return F.conv1d(x, w, p["b"].to(x.dtype), stride=stride, padding=padding, groups=groups)


def discriminator_p_apply(p: Params, y: torch.Tensor, period: int):
    """y: (B, T). Returns (logits (B, n), fmaps) (discriminator.py:64)."""
    b, t = y.shape
    if t % period != 0:
        n_pad = period - (t % period)
        y = F.pad(y[:, None, :], (0, n_pad), mode="reflect")[:, 0]
        t = t + n_pad
    x = y.reshape(b, 1, t // period, period)  # NCHW: time on H, period on W
    fmap: List[torch.Tensor] = []
    for i, cp in enumerate(p["convs"]):
        x = _conv2d(cp, x, stride=(3, 1) if i < 4 else (1, 1), padding=(2, 0))
        x = tnn.leaky_relu(x, LRELU_SLOPE)
        fmap.append(x)
    x = _conv2d(p["conv_post"], x, stride=(1, 1), padding=(1, 0))
    fmap.append(x)
    return x.reshape(b, -1), fmap


def discriminator_s_apply(p: Params, y: torch.Tensor):
    """y: (B, T). Returns (logits (B, n), fmaps) (discriminator.py:114)."""
    x = y[:, None, :]
    fmap: List[torch.Tensor] = []
    for cp, (_, _, _, s, g, pd) in zip(p["convs"], _S_SPEC):
        x = tnn.leaky_relu(_conv1d(cp, x, stride=s, padding=pd, groups=g), LRELU_SLOPE)
        fmap.append(x)
    x = _conv1d(p["conv_post"], x, padding=1)
    fmap.append(x)
    return x.reshape(x.shape[0], -1), fmap


def mpd_apply(p: Params, y: torch.Tensor, y_hat: torch.Tensor):
    """Run all discriminators on real and generated audio (B, T)
    (discriminator.py:134). Returns (y_d_rs, y_d_gs, fmap_rs, fmap_gs)
    like the reference."""
    b = y.shape[0]
    both = torch.cat([y.to(y_hat.dtype), y_hat])
    y_d_rs, y_d_gs, fmap_rs, fmap_gs = [], [], [], []
    outs = [discriminator_s_apply(p["disc_s"], both)]
    outs += [discriminator_p_apply(dp, both, period) for dp, period in zip(p["disc_p"], PERIODS)]
    for logits, fmap in outs:
        y_d_rs.append(logits[:b])
        y_d_gs.append(logits[b:])
        fmap_rs.append([f[:b] for f in fmap])
        fmap_gs.append([f[b:] for f in fmap])
    return y_d_rs, y_d_gs, fmap_rs, fmap_gs


def dur_disc_apply(
    p: Params,
    x: torch.Tensor,  # (B, T, H) text hidden (the caller detaches it)
    logw: torch.Tensor,  # (B, T, 1) log-durations (real: MAS; fake: predictor)
    x_mask: torch.Tensor,  # (B, T, 1)
) -> torch.Tensor:
    """VITS2's per-position duration discriminator (discriminator.py:
    180): logits (B, T, 1), masked."""
    h = torch.cat([L.dense(p["pre_x"], x), L.dense(p["pre_dur"], logw)], dim=-1)
    h = L.conv(p["conv1"], h * x_mask, padding=1)
    h = L.layer_norm(p["norm1"], tnn.leaky_relu(h, LRELU_SLOPE))
    h = L.conv(p["conv2"], h * x_mask, padding=1)
    h = L.layer_norm(p["norm2"], tnn.leaky_relu(h, LRELU_SLOPE))
    return L.dense(p["proj"], h) * x_mask


# ---------------------------------------------------------------------------
# Random weights (numpy, the JAX initialisers' distributions)
# ---------------------------------------------------------------------------


def _init_conv2d(r, kh, kw, c_in, c_out) -> Params:
    fan_in = c_in * kh * kw
    return {"w": r.uniform((kh, kw, c_in, c_out), math.sqrt(3.0 / fan_in)),
            "b": r.uniform(c_out, 1.0 / math.sqrt(fan_in))}


def init_mpd(r) -> Params:
    """init_mpd (discriminator.py:126); `r` is a model.Init."""
    return {
        "disc_s": {
            "convs": [r.conv(k, ci, co, groups=g) for ci, co, k, _, g, _ in _S_SPEC],
            "conv_post": r.conv(3, 1024, 1),
        },
        "disc_p": [
            {
                "convs": [_init_conv2d(r, 5, 1, ci, co) for ci, co in _P_CHANNELS],
                "conv_post": _init_conv2d(r, 3, 1, 1024, 1),
            }
            for _ in PERIODS
        ],
    }


def init_dur_disc(r, hidden_channels: int, filter_channels: int = 256) -> Params:
    """init_dur_disc (discriminator.py:167)."""
    return {
        "pre_dur": r.dense(1, filter_channels),
        "pre_x": r.dense(hidden_channels, filter_channels),
        "conv1": r.conv(3, 2 * filter_channels, filter_channels),
        "norm1": r.norm(filter_channels),
        "conv2": r.conv(3, filter_channels, filter_channels),
        "norm2": r.norm(filter_channels),
        "proj": r.dense(filter_channels, 1),
    }
