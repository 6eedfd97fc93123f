"""CUDA graphs: the port's fixed-shape executables.

The JAX package compiles one XLA executable per static shape (a
`jax.jit` per phoneme bucket, frame bucket and row count) and dispatches
each step as one call. The port's counterpart is a CUDA graph: the
launches of one step at one shape, captured once and replayed as a
single launch. A GraphCache keeps one graph per shape key. A key's
first call runs eagerly; its second captures the graph, and every call
after that replays it (TorchVoice.warmup calls each key twice), so a
one-shot shape, such as a CLI run's, pays no capture. All graphs of a
cache share one memory pool; each holds static input buffers, into
which a call copies its inputs, and static outputs, which a call clones
before it lets go of the graph.

Rules the callers keep:
- a captured function reads no value back to the host (no .cpu(),
  .item(), .tolist()) and copies nothing from it; its shapes follow the
  key alone;
- everything that changes between calls of one key is an input tensor
  (scales included), never a Python number baked into the capture;
- graphs are replayed on the caller's current stream. The serving
  threads all launch on the default stream, so replays and eager work
  run in the order they were enqueued and never overlap.

The shared pool, and threads: a server's dispatcher and its /stream
handlers replay the graphs from several threads. Sharing one pool lets
a graph captured later place its static outputs in blocks that an
earlier graph uses as temporaries, and the other way round, so a
graph's outputs hold its results only until the next replay of any
graph of the cache. One lock of the cache is therefore held from the
copy into a graph's static inputs to the clone of its static outputs:
the clone is enqueued before any other replay, and on the one stream
it runs before it. The lock serialises only host enqueues (a copy, one
graph launch, a clone), never device work. Captures run one at a time
under another lock, in the capturing thread's own capture mode
("thread_local"), so other threads keep launching and replaying
meanwhile.

No fallback: on a CUDA device a capture that fails raises. Replay and
the eager first call give the same bits (tests/test_torch_cuda.py,
chip_smoke.py). On the CPU there is nothing to capture, and run()
calls the function.

Launch counts: a replay does not call the kernel wrappers of
ops/cuda/vocoder.py, so each graph records the launches its capture
made (vocoder.recording_launches) and every replay adds them to the
wrappers' counts. The eager calls (a key's first, and the run before a
capture, which initialises cuBLAS, cuDNN and the kernels' attributes
for these shapes on the capturing thread) are counted like any launch.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, Hashable, Optional, Sequence, Tuple

import torch

from ..ops.cuda import vocoder as V


class _Graph:
    __slots__ = ("graph", "inputs", "outputs", "launches")

    def __init__(self, graph, inputs, outputs, launches):
        self.graph = graph
        self.inputs = inputs
        self.outputs = outputs
        self.launches = launches


class GraphCache:
    """One CUDA graph per shape key on one device."""

    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        self._graphs: Dict[Hashable, _Graph] = {}
        self._capture_lock = threading.Lock()
        # held from copy-in to clone-out of any replay: the graphs share
        # one pool, so one graph's replay may overwrite another's outputs
        self._replay_lock = threading.Lock()
        self._stats_lock = threading.Lock()
        self._pool = None
        self._seen: Dict[Hashable, int] = {}  # calls of keys not captured yet
        # captures, replays, seconds spent capturing (eager warm run included)
        self.stats = {"captures": 0, "replays": 0, "capture_s": 0.0}

    def run(
        self,
        key: Hashable,
        fn: Callable[..., Tuple[torch.Tensor, ...]],
        inputs: Sequence[Optional[torch.Tensor]],
    ) -> Tuple[torch.Tensor, ...]:
        """fn(*inputs): eagerly at a key's first call, then as a graph
        replay at `key` (captured at the second). `inputs` may lie on the
        host (pinned for an asynchronous copy) or on the device; None
        stays None. Returns fresh tensors."""
        if self.device.type != "cuda":
            return tuple(fn(*inputs))
        g = self._graphs.get(key)
        if g is None:
            with self._stats_lock:
                first = key not in self._seen
                self._seen[key] = 1
            if first:
                return tuple(fn(*(None if x is None else x.to(self.device, non_blocking=True)
                                  for x in inputs)))
            g = self._capture(key, fn, inputs)
        with self._replay_lock:
            for static, x in zip(g.inputs, inputs):
                if static is not None:
                    static.copy_(x, non_blocking=True)
            g.graph.replay()
            out = tuple(o.clone() for o in g.outputs)
        for wrapper, n in g.launches.items():
            for _ in range(n):
                V.count_launch(wrapper)
        with self._stats_lock:
            self.stats["replays"] += 1
        return out

    def _capture(self, key, fn, inputs) -> _Graph:
        with self._capture_lock:
            g = self._graphs.get(key)
            if g is not None:  # another thread captured it meanwhile
                return g
            t0 = time.perf_counter()
            static = tuple(
                None if x is None
                else torch.empty(x.shape, dtype=x.dtype, device=self.device).copy_(x)
                for x in inputs
            )
            fn(*static)  # eager warm run at these shapes
            if self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
            graph = torch.cuda.CUDAGraph()
            with V.recording_launches() as launches:
                with torch.cuda.graph(graph, pool=self._pool, capture_error_mode="thread_local"):
                    outputs = tuple(fn(*static))
            g = _Graph(graph, static, outputs, dict(launches))
            self._graphs[key] = g
            with self._stats_lock:
                self.stats["captures"] += 1
                self.stats["capture_s"] += time.perf_counter() - t0
            return g

    def memory_bytes(self) -> int:
        """Device memory the graphs hold: their shared pool's segments
        (outputs and the captures' temporaries) and their static inputs."""
        if self._pool is None:
            return 0
        pool = sum(
            seg["total_size"] for seg in torch.cuda.memory_snapshot()
            if tuple(seg["segment_pool_id"]) == tuple(self._pool)
        )
        with self._capture_lock:
            graphs = list(self._graphs.values())
        return pool + sum(x.nbytes for g in graphs for x in g.inputs if x is not None)
