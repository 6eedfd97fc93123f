"""Monotonic Alignment Search on the device.

Counterpart of piper_tpu/ops/mas.py. The JAX package runs the Viterbi
DP as a lax.scan over spectrogram frames; here it is a Python loop over
frames of vector ops over the batch and the phoneme axis, on the
tensors' device, under no_grad (it returns an integer path). Four
small launches per frame forward and four back, so its cost on the
card is launches, not arithmetic (chip_smoke.py phase 7 times it).

Recurrence (reference monotonic_align/core.pyx:5-42): Q[y, x] =
value[y, x] + max(Q[y-1, x], Q[y-1, x-1]), with the x == y boundary
forcing the diagonal; backtrack chooses x-1 when Q[y-1, x-1] >
Q[y-1, x]. Every cell is one float32 addition in both packages, so on
the same scores the path is the JAX package's exactly.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

NEG_INF = -1e9


@torch.no_grad()
def maximum_path(
    neg_cent: torch.Tensor, x_lengths: torch.Tensor, y_lengths: torch.Tensor
) -> torch.Tensor:
    """Best monotonic alignment (piper_tpu/ops/mas.py:23).

    neg_cent: (B, T_y, T_x) alignment scores (frames x phonemes).
    x_lengths: (B,) valid phonemes; y_lengths: (B,) valid frames.
    Returns path: (B, T_y, T_x) float32 in {0, 1}; rows beyond
    y_lengths are all-zero, like the reference's masked output.

    Cells past a row's phonemes are masked once, after the DP: a valid
    cell's predecessors (x and x - 1) are valid, so they never reach a
    valid cell. The backtrack's choices are computed for every cell at
    once, and its loop only follows them: four launches a frame each
    way.
    """
    b, t_y, t_x = neg_cent.shape
    dev = neg_cent.device
    neg_cent = neg_cent.float()
    xs = torch.arange(t_x, device=dev)
    x_len = x_lengths.to(dev).long()
    y_len = y_lengths.to(dev).long()
    # on the diagonal x == y the path must come from (y-1, x-1)
    diag = xs[None, :] == torch.arange(t_y, device=dev)[:, None]  # (T_y, T_x)

    # forward: q[:, y] = neg_cent[:, y] + the better predecessor
    q = torch.empty((b, t_y, t_x), device=dev)
    torch.add(neg_cent[:, 0], torch.where(xs == 0, 0.0, NEG_INF), out=q[:, 0])
    for y in range(1, t_y):
        prev = q[:, y - 1]
        shifted = F.pad(prev[:, :-1], (1, 0), value=NEG_INF)
        best = torch.maximum(torch.where(diag[y], NEG_INF, prev), shifted)
        torch.add(neg_cent[:, y], best, out=q[:, y])
    q = torch.where(xs[None, None, :] < x_len[:, None, None], q, NEG_INF)

    # the backtrack's choice at every cell (y >= 1): step to x - 1 on the
    # diagonal or where Q[y-1, x-1] beats Q[y-1, x]
    move = diag[1:] | ((xs > 0) & (q[:, :-1] < F.pad(q[:, :-1, :-1], (1, 0), value=NEG_INF)))
    active = torch.arange(t_y, device=dev)[None, :] < y_len[:, None]  # (B, T_y)
    x_cur = (x_len - 1).clamp(min=0)
    idx = torch.empty((b, t_y), dtype=torch.long, device=dev)
    idx[:, t_y - 1] = x_cur
    for y in range(t_y - 1, 0, -1):  # from (y_len - 1, x_len - 1) down
        step = move[:, y - 1].gather(1, x_cur[:, None])[:, 0] & active[:, y]
        x_cur = x_cur - step.long()
        idx[:, y - 1] = x_cur
    path = torch.zeros((b, t_y, t_x), device=dev)
    return path.scatter_(2, idx[..., None], active[..., None].float())


def maximum_path_numpy(neg_cent, x_lengths, y_lengths):
    """Pure-numpy oracle (an independent reimplementation of the Viterbi
    recurrence, piper_tpu/ops/mas.py:89) for testing the device path."""
    b, t_y, t_x = neg_cent.shape
    paths = np.zeros((b, t_y, t_x), np.float32)
    for i in range(b):
        ty, tx = int(y_lengths[i]), int(x_lengths[i])
        v = np.full((ty, tx), -np.inf, np.float64)
        for y in range(ty):
            for x in range(min(tx, y + 1)):
                if y == 0:
                    v[y, x] = neg_cent[i, 0, 0] if x == 0 else -np.inf
                    continue
                same = v[y - 1, x] if x != y else -np.inf
                diag = v[y - 1, x - 1] if x > 0 else -np.inf
                v[y, x] = neg_cent[i, y, x] + max(same, diag)
        x = tx - 1
        for y in range(ty - 1, -1, -1):
            paths[i, y, x] = 1.0
            if y > 0 and (x == y or (x > 0 and v[y - 1, x] < v[y - 1, x - 1])):
                x -= 1
    return paths
