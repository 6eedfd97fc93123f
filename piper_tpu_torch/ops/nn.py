"""Core neural-net primitives in NWC layout.

Counterpart of piper_tpu/ops/nn.py (lines 29-222). Public functions
keep the JAX package's layouts so the two compare like with like:
activations are (batch, time, channels), and kernels are

  conv1d kernel:            (width, in_channels // groups, out_channels)
  conv1d_transpose kernel:  (width, in_channels, out_channels), pre-flipped
  bias:                     (out_channels,)

Inside, each conv transposes to torch's (batch, channels, time) and
calls torch's convolution.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F


def _ncw_weight(kernel: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """(k, in/groups, out) -> torch's (out, in/groups, k)."""
    return kernel.to(dtype).permute(2, 1, 0)


def conv1d(
    x: torch.Tensor,
    kernel: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    *,
    stride: int = 1,
    padding: Union[int, Tuple[int, int]] = 0,
    dilation: int = 1,
    groups: int = 1,
) -> torch.Tensor:
    """1D convolution over (B, T, C) input.

    `padding` is an int (symmetric, torch-style) or an explicit
    (left, right) tuple.
    """
    xt = x.transpose(1, 2)
    if isinstance(padding, tuple):
        xt = F.pad(xt, padding)
        padding = 0
    out = F.conv1d(
        xt, _ncw_weight(kernel, x.dtype),
        None if bias is None else bias.to(x.dtype),
        stride=stride, padding=padding, dilation=dilation, groups=groups,
    )
    return out.transpose(1, 2)


def torch_conv_transpose_weight(kernel: torch.Tensor) -> torch.Tensor:
    """Undo the pre-flip: (k, in, out) -> torch ConvTranspose1d's (in, out, k).

    The JAX tree stores kernel = torch_w.permute(2, 0, 1)[::-1]
    (piper_tpu/ops/nn.py:78-80), so torch_w = kernel[::-1].permute(1, 2, 0).
    """
    return kernel.flip(0).permute(1, 2, 0)


def conv1d_transpose(
    x: torch.Tensor,
    kernel: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    *,
    stride: int,
    padding: int,
) -> torch.Tensor:
    """Transposed 1D convolution matching torch.nn.ConvTranspose1d.

    Output length = (T - 1) * stride - 2 * padding + width. `kernel` is
    the JAX package's pre-flipped (k, in, out) layout.
    """
    out = F.conv_transpose1d(
        x.transpose(1, 2),
        torch_conv_transpose_weight(kernel.to(x.dtype)),
        None if bias is None else bias.to(x.dtype),
        stride=stride, padding=padding,
    )
    return out.transpose(1, 2)


def layer_norm(
    x: torch.Tensor,
    gamma: torch.Tensor,
    beta: torch.Tensor,
    *,
    eps: float = 1e-5,
) -> torch.Tensor:
    """LayerNorm over the channel (last) axis, computed in float32
    (reference modules.LayerNorm, modules.py:14-26)."""
    y = F.layer_norm(
        x.float(), (x.shape[-1],), gamma.float(), beta.float(), eps
    )
    return y.to(x.dtype)


def leaky_relu(x: torch.Tensor, slope: float = 0.1) -> torch.Tensor:
    return F.leaky_relu(x, slope)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU — torch F.gelu default (used by DDSConv)."""
    return F.gelu(x)


def sequence_mask(lengths: torch.Tensor, max_length: int) -> torch.Tensor:
    """(B,) lengths -> (B, max_length, 1) bool mask
    (reference commons.sequence_mask, commons.py:109-113)."""
    pos = torch.arange(max_length, device=lengths.device)
    return (pos[None, :] < lengths[:, None])[..., None]


def fused_gated_activation(
    x_in: torch.Tensor, g: Optional[torch.Tensor]
) -> torch.Tensor:
    """tanh/sigmoid gate of a 2C-channel pre-activation (WaveNet gate,
    commons.fused_add_tanh_sigmoid_multiply, commons.py:99-106).
    x_in, g: (B, T, 2C) -> (B, T, C)."""
    if g is not None:
        x_in = x_in + g
    c = x_in.shape[-1] // 2
    return torch.tanh(x_in[..., :c]) * torch.sigmoid(x_in[..., c:])
