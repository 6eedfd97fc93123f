"""Shared VITS building blocks: dense (1x1 conv), conv, WN, DDSConv.

Counterpart of piper_tpu/models/vits/layers.py (apply functions only;
the port loads weights, it does not initialise them). Each layer is a
dict of tensors in the JAX package's layouts (see ops/nn.py); weights
are cast to the activation dtype at use.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from ...ops import nn as tnn

Params = Dict[str, Any]


def dense(p: Params, x: torch.Tensor) -> torch.Tensor:
    """1x1 conv as matmul: (B, T, Cin) @ (Cin, Cout) + b."""
    out = torch.matmul(x, p["w"].to(x.dtype))
    if "b" in p:
        out = out + p["b"].to(x.dtype)
    return out


def conv(
    p: Params,
    x: torch.Tensor,
    *,
    padding=0,
    dilation: int = 1,
    stride: int = 1,
    groups: int = 1,
) -> torch.Tensor:
    return tnn.conv1d(
        x, p["w"], p.get("b"), stride=stride, padding=padding,
        dilation=dilation, groups=groups,
    )


def layer_norm(p: Params, x: torch.Tensor) -> torch.Tensor:
    return tnn.layer_norm(x, p["gamma"], p["beta"])


def wn_apply(
    p: Params,
    x: torch.Tensor,
    x_mask: torch.Tensor,
    *,
    kernel_size: int,
    dilation_rate: int,
    g: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """WaveNet gated residual stack (modules.py:132-209).
    x: (B, T, H) masked input; g: (B, gin) speaker embedding."""
    hidden = x.shape[-1]
    n_layers = len(p["in_layers"])
    output = torch.zeros_like(x)
    g_all = dense(p["cond_layer"], g[:, None, :]) if g is not None else None

    for i in range(n_layers):
        dilation = dilation_rate**i
        pad = (kernel_size * dilation - dilation) // 2
        x_in = conv(p["in_layers"][i], x, padding=pad, dilation=dilation)
        g_l = (
            g_all[..., i * 2 * hidden : (i + 1) * 2 * hidden]
            if g_all is not None
            else None
        )
        acts = tnn.fused_gated_activation(x_in, g_l)
        res_skip = dense(p["res_skip_layers"][i], acts)
        if i < n_layers - 1:
            x = (x + res_skip[..., :hidden]) * x_mask
            output = output + res_skip[..., hidden:]
        else:
            output = output + res_skip
    return output * x_mask


def ddsconv_apply(
    p: Params,
    x: torch.Tensor,
    x_mask: torch.Tensor,
    *,
    kernel_size: int,
    g: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Dilated depth-separable conv stack (modules.py:81-129).
    x, g: (B, T, C)."""
    channels = x.shape[-1]
    if g is not None:
        x = x + g
    for i in range(len(p["convs_sep"])):
        dilation = kernel_size**i
        pad = (kernel_size * dilation - dilation) // 2
        y = conv(
            p["convs_sep"][i], x * x_mask, padding=pad, dilation=dilation,
            groups=channels,
        )
        y = layer_norm(p["norms_1"][i], y)
        y = tnn.gelu(y)
        y = dense(p["convs_1x1"][i], y)
        y = layer_norm(p["norms_2"][i], y)
        y = tnn.gelu(y)
        x = x + y
    return x * x_mask


def flip_channels(x: torch.Tensor) -> torch.Tensor:
    """Flip over the channel (last) axis (modules.py:384-391)."""
    return x.flip(-1)


def elementwise_affine(
    p: Params, x: torch.Tensor, x_mask: torch.Tensor, *, reverse: bool
):
    if not reverse:
        y = (p["m"] + torch.exp(p["logs"]) * x) * x_mask
        logdet = torch.sum(p["logs"] * x_mask, dim=(1, 2))
        return y, logdet
    return (x - p["m"]) * torch.exp(-p["logs"]) * x_mask
