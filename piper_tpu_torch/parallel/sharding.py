"""Data-parallel batches, the sharded training step and row-parallel
decoding over a Mesh.

Counterpart of piper_tpu/parallel/sharding.py. Where JAX annotates the
batch with P('data') and lets GSPMD partition one global program, each
rank here holds its rows of the batch (every rank is given the same
whole batch and takes its share) and the collectives are explicit:

- serving (vocode_data_parallel, make_sharded_infer): each rank decodes
  its rows, then the rows are all-gathered over the data group, so every
  rank returns every row;
- training (make_sharded_train_step): each rank builds its loss so that
  the sum over the ranks is the whole batch's loss (train/losses.py
  BatchShard: masked ratios over all-reduced denominators, means over
  equal shares, every random draw at the whole batch's shape), and the
  gradients of both optimizers' parameters are summed over the data
  group before the update, which every rank then applies alike.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from ..config import ModelConfig
from ..train.losses import BatchShard
from .mesh import Mesh


def batch_sharding(mesh: Mesh) -> BatchShard:
    """This rank's share of a batch's rows over 'data', with the
    reductions over its data group."""
    return BatchShard(mesh.groups["data"], mesh.coords["data"], mesh.shape["data"])


def replicate(mesh: Mesh) -> BatchShard:
    """The whole batch, as every rank holds a replicated value."""
    return BatchShard()


def data_rows(n: int, mesh: Mesh) -> List[int]:
    """This rank's rows of an n-row group, the group padded to a multiple
    of the data size with copies of row 0 (TpuVoice's row rounding,
    piper_tpu/runtime/voice.py:633-641)."""
    d = mesh.shape["data"]
    rows = list(range(n)) + [0] * (-n % d)
    per = len(rows) // d
    i = mesh.coords["data"]
    return rows[i * per : (i + 1) * per]


def all_gather(x: torch.Tensor, mesh: Mesh, axis: str) -> List[torch.Tensor]:
    """x of every rank along `axis` (equal shapes and dtypes), in the
    axis's order; [x] for an axis of size 1. Gathered as bytes, so every
    dtype goes through gloo as through NCCL."""
    group = mesh.groups[axis]
    if group is None:
        return [x]
    i, j = mesh.coords["data"], mesh.coords["model"]
    line = [int(r) for r in (mesh.grid[:, j] if axis == "data" else mesh.grid[i, :])]
    flat = x.contiguous().reshape(-1).view(torch.uint8)
    parts = [torch.empty_like(flat) for _ in line]
    dist.all_gather(parts, flat, group=group)
    # a group's ranks are numbered in ascending global rank
    order = sorted(line)
    return [parts[order.index(r)].view(x.dtype).reshape(x.shape) for r in line]


def gather_rows(x: torch.Tensor, mesh: Mesh, n: Optional[int] = None) -> torch.Tensor:
    """Every data rank's rows of x, concatenated in data order; the
    first n (the pad rows of data_rows dropped)."""
    out = torch.cat(all_gather(x, mesh, "data"))
    return out if n is None else out[:n]


def _rows(x, mesh: Mesh):
    x = torch.as_tensor(x)
    d = mesh.shape["data"]
    if x.shape[0] % d:
        raise ValueError(f"{x.shape[0]} rows do not divide over the data axis of {d}")
    return batch_sharding(mesh).rows(x).to(mesh.device)


def shard_batch(batch: Dict[str, object], mesh: Mesh) -> Dict[str, torch.Tensor]:
    """This rank's rows of a host batch (leading axis over 'data'), on
    its device."""
    return {k: _rows(v, mesh) for k, v in batch.items()}


def stack_batches(batches: Sequence[Dict[str, object]], mesh: Mesh) -> Dict[str, torch.Tensor]:
    """K same-shape host batches stacked on a new leading axis, this
    rank's rows of each (make_sharded_scan_step's input)."""
    return {k: torch.stack([_rows(b[k], mesh) for b in batches]) for k in batches[0]}


def make_sharded_train_step(cfg: ModelConfig, mesh: Mesh, **step_kw):
    """step(state, batch, rng) -> (state, metrics): train_step on this
    rank's rows (shard_batch's), as one global step over the whole batch.
    Every rank passes the same key; the losses it returns are the whole
    batch's, and its parameters stay equal to every other rank's. The
    optimizers ride in the TrainState (train/step.py), so JAX's `tx`
    argument has no counterpart."""
    from ..train.step import train_step

    shard = batch_sharding(mesh)

    def step(state, batch, rng):
        return train_step(state, batch, rng.to(mesh.device), cfg=cfg, shard=shard, **step_kw)

    return step


def make_sharded_scan_step(cfg: ModelConfig, mesh: Mesh, n_steps: int, **step_kw):
    """scan(state, batches, rngs) -> (state, metrics): n_steps sharded
    steps in order over stack_batches' K batches with one key each
    (rngs: (K, 2)), as JAX's lax.scan runs them: the same steps as K
    calls of make_sharded_train_step's. Each metric is stacked per step."""
    step = make_sharded_train_step(cfg, mesh, **step_kw)

    def scan(state, batches, rngs):
        per_step = []
        for i in range(n_steps):
            state, metrics = step(state, {k: v[i] for k, v in batches.items()}, rngs[i])
            per_step.append(metrics)
        return state, {k: torch.stack([m[k] for m in per_step]) for k in per_step[0]}

    return scan


def vocode_data_parallel(
    params,
    z_p: torch.Tensor,
    y_mask: torch.Tensor,
    g: Optional[torch.Tensor],
    *,
    cfg: ModelConfig,
    mesh: Mesh,
) -> torch.Tensor:
    """Row-parallel flow reverse + vocoder: every rank passes the whole
    (B, T, C) batch (B a multiple of the data size: the caller pads), runs
    the port's synthesizer_vocode on its rows (on the card both kernels,
    once per decode), and returns every row's audio (B, T * upsample),
    all-gathered over the data group. A row's audio does not depend on
    the rows beside it, so it equals the unsharded call's."""
    from ..models.vits.model import synthesizer_vocode

    shard = batch_sharding(mesh)
    if z_p.shape[0] % shard.count:
        raise ValueError(f"{z_p.shape[0]} rows do not divide over the data axis of {shard.count}")
    audio = synthesizer_vocode(
        params, shard.rows(z_p), shard.rows(y_mask), cfg=cfg,
        g=None if g is None else shard.rows(g),
    )
    return gather_rows(audio, mesh)


def make_sharded_infer(cfg: ModelConfig, mesh: Mesh, *, max_frames: int, dtype=torch.float32):
    """run(params, ids, lengths, noise_scale, length_scale, noise_w, rng)
    -> (audio (B, max_frames * upsample), y_lengths (B,)): the port's
    infer on this rank's rows, every row gathered to every rank. The key
    splits into the duration and frame noise as JAX's infer splits it,
    each drawn at the whole batch's shape and cut to this rank's rows,
    so a row gets the unsharded call's noise (JAX's partitionable
    threefry gives a sharded draw the unsharded bits)."""
    from ..models.vits.model import infer
    from ..ops import prng

    shard = batch_sharding(mesh)

    def run(params, ids, lengths, noise_scale, length_scale, noise_w, rng):
        b, t_x = ids.shape
        if b % shard.count:
            raise ValueError(f"{b} rows do not divide over the data axis of {shard.count}")
        r_enc, r_dec = prng.split(rng.to(mesh.device))
        audio, y_lengths = infer(
            params, shard.rows(ids).to(mesh.device), shard.rows(lengths).to(mesh.device), cfg=cfg,
            max_frames=max_frames, noise_scale=noise_scale, length_scale=length_scale,
            noise_w_scale=noise_w, dtype=dtype,
            dur_noise=shard.rows(prng.normal(r_enc, (b, t_x, 2))),
            frame_noise=shard.rows(prng.normal(r_dec, (b, max_frames, cfg.inter_channels))),
        )
        return gather_rows(audio, mesh), gather_rows(y_lengths, mesh)

    return run

