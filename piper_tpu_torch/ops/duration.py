"""Duration-aligned frame expansion as a gather.

Counterpart of piper_tpu/ops/duration.py::expand_by_duration (line 45).
Frame t belongs to the phoneme whose cumulative-duration interval holds
t (a comparison-sum), and the expansion gathers that phoneme's row —
exactly the reference's alignment matmul (commons.py:116-129,
models.py:711-716) for valid frames; frames past the total duration are
zeroed like the reference's all-zero alignment rows.
"""

from __future__ import annotations

from typing import Tuple

import torch


def duration_to_frame_indices(
    durations: torch.Tensor, num_frames: int, offset: int = 0
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, T_x) integer durations -> (indices (B, num_frames),
    frame_valid (B, num_frames) bool) for the absolute frame window
    [offset, offset + num_frames)."""
    cum = torch.cumsum(durations.long(), dim=-1)  # (B, T_x)
    frames = offset + torch.arange(num_frames, device=durations.device)
    # p(t) = #{phonemes whose cumulative duration <= t}
    idx = torch.searchsorted(
        cum, frames[None, :].expand(cum.shape[0], -1).contiguous(), right=True
    )
    valid = frames[None, :] < cum[:, -1:]
    return idx.clamp(max=durations.shape[-1] - 1), valid


def expand_by_duration(
    values: torch.Tensor,
    durations: torch.Tensor,
    num_frames: int,
    offset: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expand (B, T_x, C) phoneme-level values to (B, T_y, C) frames.

    Returns (expanded, frame_valid (B, T_y, 1) bool mask)."""
    idx, valid = duration_to_frame_indices(durations, num_frames, offset)
    expanded = torch.gather(
        values, 1, idx[..., None].expand(-1, -1, values.shape[-1])
    )
    mask = valid[..., None]
    return expanded * mask.to(values.dtype), mask
