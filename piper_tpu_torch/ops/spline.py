"""Piecewise rational-quadratic spline flow (linear tails).

Counterpart of piper_tpu/ops/spline.py::rational_quadratic_spline
(line 51) and its _searchsorted (line 39); numerical parity with the
reference (src/python/piper_train/vits/transforms.py:10-212), used by
the stochastic duration predictor's ConvFlow layers.

All math is float32 in both precisions: the softmax/cumsum/division
chains are precision-critical. Bins stay on the trailing axis; the bin
lookups are torch.gather.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

MIN_BIN_WIDTH = 1e-3
MIN_BIN_HEIGHT = 1e-3
MIN_DERIVATIVE = 1e-3


def _searchsorted(bin_locations: torch.Tensor, inputs: torch.Tensor) -> torch.Tensor:
    """Index of the bin containing each input (transforms.py:44-47): a
    sum of comparisons with eps added to the last boundary.
    bin_locations: (N, K+1); inputs: (N,)."""
    eps = 1e-6
    locs = bin_locations.clone()
    locs[..., -1] += eps
    return torch.sum(inputs[..., None] >= locs, dim=-1) - 1


def rational_quadratic_spline(
    inputs: torch.Tensor,
    unnormalized_widths: torch.Tensor,
    unnormalized_heights: torch.Tensor,
    unnormalized_derivatives: torch.Tensor,
    *,
    inverse: bool = False,
    tail_bound: float = 5.0,
    min_bin_width: float = MIN_BIN_WIDTH,
    min_bin_height: float = MIN_BIN_HEIGHT,
    min_derivative: float = MIN_DERIVATIVE,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Monotone rational-quadratic spline with linear tails.

    Returns (outputs, logabsdet). Outside [-tail_bound, tail_bound] the
    transform is the identity with logabsdet 0 (transforms.py:62-76).
    """
    dtype = inputs.dtype
    out_shape = inputs.shape
    num_bins = unnormalized_widths.shape[-1]
    n = math.prod(out_shape) if out_shape else 1

    inputs = inputs.float().reshape(n)
    uw = unnormalized_widths.float().reshape(n, num_bins)
    uh = unnormalized_heights.float().reshape(n, num_bins)
    ud = unnormalized_derivatives.float().reshape(n, -1)

    left = bottom = -tail_bound
    right = top = tail_bound

    inside = (inputs >= left) & (inputs <= right)
    x = inputs.clamp(left, right)

    # Linear tails: boundary derivative pads such that
    # min_derivative + softplus(const) == 1 (transforms.py:68-73).
    const = math.log(math.exp(1.0 - min_derivative) - 1.0)
    ud = F.pad(ud, (1, 1), value=const)

    widths = torch.softmax(uw, dim=-1)
    widths = min_bin_width + (1.0 - min_bin_width * num_bins) * widths
    cumwidths = F.pad(torch.cumsum(widths, dim=-1), (1, 0))
    cumwidths = (right - left) * cumwidths + left
    cumwidths[:, 0] = left
    cumwidths[:, -1] = right
    widths = cumwidths[:, 1:] - cumwidths[:, :-1]

    derivatives = min_derivative + F.softplus(ud)

    heights = torch.softmax(uh, dim=-1)
    heights = min_bin_height + (1.0 - min_bin_height * num_bins) * heights
    cumheights = F.pad(torch.cumsum(heights, dim=-1), (1, 0))
    cumheights = (top - bottom) * cumheights + bottom
    cumheights[:, 0] = bottom
    cumheights[:, -1] = top
    heights = cumheights[:, 1:] - cumheights[:, :-1]

    bin_idx = _searchsorted(cumheights if inverse else cumwidths, x)
    bin_idx = bin_idx.clamp(0, num_bins - 1)[:, None]  # (N, 1)

    def take(arr):
        return torch.gather(arr, -1, bin_idx)[:, 0]

    input_cumwidths = take(cumwidths)
    input_bin_widths = take(widths)
    input_cumheights = take(cumheights)
    delta = heights / widths
    input_delta = take(delta)
    input_derivatives = take(derivatives)
    input_derivatives_p1 = take(derivatives[:, 1:])
    input_heights = take(heights)

    d_sum = input_derivatives + input_derivatives_p1 - 2.0 * input_delta

    if inverse:
        rel = x - input_cumheights
        a = rel * d_sum + input_heights * (input_delta - input_derivatives)
        b = input_heights * input_derivatives - rel * d_sum
        c = -input_delta * rel
        discriminant = b.square() - 4.0 * a * c
        # >= 0 for monotone splines (transforms.py:174); clamp for safety
        root = (2.0 * c) / (-b - torch.sqrt(discriminant.clamp(min=0.0)))
        theta = root
        outputs = root * input_bin_widths + input_cumwidths
    else:
        theta = (x - input_cumwidths) / input_bin_widths
        theta_1m = theta * (1.0 - theta)
        numerator = input_heights * (
            input_delta * theta.square() + input_derivatives * theta_1m
        )
        denominator = input_delta + d_sum * theta_1m
        outputs = input_cumheights + numerator / denominator

    theta_1m = theta * (1.0 - theta)
    denominator = input_delta + d_sum * theta_1m
    derivative_numerator = input_delta.square() * (
        input_derivatives_p1 * theta.square()
        + 2.0 * input_delta * theta_1m
        + input_derivatives * (1.0 - theta).square()
    )
    logabsdet = torch.log(derivative_numerator) - 2.0 * torch.log(denominator)
    if inverse:
        logabsdet = -logabsdet

    outputs = torch.where(inside, outputs, inputs)
    logabsdet = torch.where(inside, logabsdet, torch.zeros_like(logabsdet))
    return (
        outputs.reshape(out_shape).to(dtype),
        logabsdet.reshape(out_shape).to(dtype),
    )
