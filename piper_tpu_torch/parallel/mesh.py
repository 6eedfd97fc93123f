"""The ('data', 'model') mesh over torch.distributed, and multi-process
start-up.

Counterpart of piper_tpu/parallel/mesh.py. The port runs one process per
device (SPMD, torch's model, as JAX's multi-host one is): every rank runs
the same program on the same inputs and does its share, so JAX's mesh of
devices becomes a grid of ranks. Axes:

  data  - rows of a batch (data parallelism);
  model - frames of one utterance (vocoder_shard.sharded_vocode's time
          axis).

A Mesh holds the grid, this rank's coordinates, one process group per
axis (the ranks that share this rank's other coordinate) and this rank's
device. An axis of size 1 has no group, and every collective over it is
the identity, so a 1x1 mesh runs exactly the one-device code.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Dict, Optional, Sequence, Union

import numpy as np
import torch
import torch.distributed as dist

AXES = ("data", "model")
# how long a collective may wait for its peers before it fails
DEFAULT_TIMEOUT = datetime.timedelta(minutes=10)


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    device: Union[None, str, torch.device] = None,
    timeout: datetime.timedelta = DEFAULT_TIMEOUT,
) -> None:
    """Join the processes into one default process group (a no-op for one
    process or when the group exists). Arguments left out come from
    torchrun's environment: WORLD_SIZE, RANK, and MASTER_ADDR/MASTER_PORT
    (init_method "env://"). `coordinator_address` is "host:port" or an
    init_method URL ("tcp://...", "file://..."). The backend is NCCL for
    CUDA (the default device; this rank then uses cuda:LOCAL_RANK) and
    gloo for device="cpu". `timeout` bounds every collective, so a rank
    that never joins one fails the others instead of hanging them."""
    if num_processes is None:
        num_processes = int(os.environ.get("WORLD_SIZE", "1"))
    if num_processes <= 1 or dist.is_initialized():
        return
    if process_id is None:
        process_id = int(os.environ["RANK"])
    if coordinator_address is None:
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    cuda = torch.device("cuda" if device is None else device).type == "cuda"
    if cuda:
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    dist.init_process_group(
        "nccl" if cuda else "gloo", init_method=init_method, world_size=num_processes,
        rank=process_id, timeout=timeout,
    )


def mesh_grid(n: int, data: Optional[int] = None, model: int = 1) -> np.ndarray:
    """The (data, model) grid of positions 0..n-1, row-major; raises
    JAX's ValueError when data * model != n."""
    if data is None:
        data = n // model
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} != {n} devices")
    return np.arange(n).reshape(data, model)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A grid of ranks. grid[i, j] is the global rank at data index i,
    model index j; `coords` this rank's (data, model) indices; `groups`
    each axis's process group of this rank (None for an axis of size 1)."""

    grid: np.ndarray
    coords: Dict[str, int]
    groups: Dict[str, Optional[dist.ProcessGroup]]
    device: torch.device

    @property
    def shape(self) -> Dict[str, int]:
        """{"data": d, "model": m}, as JAX's Mesh.shape."""
        return dict(zip(AXES, self.grid.shape))

    @property
    def size(self) -> int:
        return int(self.grid.size)


def make_mesh(
    data: Optional[int] = None,
    model: int = 1,
    *,
    ranks: Optional[Sequence[int]] = None,
    device: Union[None, str, torch.device] = None,
    timeout: datetime.timedelta = DEFAULT_TIMEOUT,
) -> Optional[Mesh]:
    """('data', 'model') mesh over `ranks` (default: every rank of the
    default group; without one, this process alone: a 1x1 mesh). Every
    rank of the default group must call it, in the same order as its
    other calls that make groups (torch.distributed.new_group is
    collective); a rank outside `ranks` gets None. `device`: None means
    cuda:LOCAL_RANK; "cpu", or a device, when asked."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    ranks = list(range(world)) if ranks is None else [int(r) for r in ranks]
    if any(not 0 <= r < world for r in ranks) or len(set(ranks)) != len(ranks):
        raise ValueError(f"mesh ranks {ranks} are not distinct ranks of a world of {world}")
    grid = np.asarray(ranks, dtype=np.int64)[mesh_grid(len(ranks), data, model)]
    groups: Dict[str, Optional[dist.ProcessGroup]] = {a: None for a in AXES}
    # every rank makes every group, in one order: a row of the grid is a
    # model group, a column a data group
    for axis, lines in (("data", grid.T), ("model", grid)):
        if grid.shape[AXES.index(axis)] == 1:
            continue
        for line in lines:
            group = dist.new_group([int(r) for r in line], timeout=timeout)
            if rank in line:
                groups[axis] = group
    if rank not in ranks:
        return None
    i, j = (int(v[0]) for v in np.nonzero(grid == rank))
    device = torch.device(f"cuda:{int(os.environ.get('LOCAL_RANK', '0'))}" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run on the CPU")
    return Mesh(grid=grid, coords={"data": i, "model": j}, groups=groups, device=device)


def local_mesh(device: Union[None, str, torch.device] = None) -> Mesh:
    """All-data-parallel mesh over every rank."""
    return make_mesh(model=1, device=device)
