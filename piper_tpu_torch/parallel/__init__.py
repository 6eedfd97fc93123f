"""Parallelism over torch.distributed: the ('data', 'model') mesh of
ranks, data-parallel batches, the sharded GAN step, row-parallel
decoding and time-sharded vocoding with halo exchange.

Counterpart of piper_tpu/parallel/: one process per device, every rank
running the same program on the same inputs (torch's SPMD model, as
JAX's multi-host one), with explicit collectives where JAX's GSPMD
inserts them.
"""

from .mesh import make_mesh, local_mesh  # noqa: F401
from .sharding import (  # noqa: F401
    batch_sharding,
    replicate,
    shard_batch,
    make_sharded_train_step,
)
