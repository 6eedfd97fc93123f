"""CUDA graphs: the port's fixed-shape executables.

The JAX package compiles one XLA executable per static shape (a
`jax.jit` per phoneme bucket, frame bucket and row count) and dispatches
each step as one call. The port's counterpart is a CUDA graph: the
launches of one step at one shape, captured once and replayed as a
single launch. A GraphCache keeps one graph per shape key. A key's
calls up to its `capture_at`-th (the 2nd by default) run eagerly, and
that call then captures the graph, which every later call replays
(TorchVoice.warmup calls each key twice), so a one-shot shape, such as
a CLI run's, pays no capture. The eager run before a capture is the
call's own result, and it initialises cuBLAS, cuDNN and the kernels'
attributes for these shapes on the capturing thread, which a capture
could not do. TorchVoice's plan graphs (dispatch fusion,
runtime/voice.py) keep their own count of a plan's sightings and call
with capture_at=1 when it decides. All graphs of a cache
share one memory pool; each holds static input buffers, into which a
call copies its inputs, and static outputs, which a call clones before
it lets go of the graph. drop() destroys a graph (a plan graph that
the voice evicts).

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
in the process (as PyTorch requires), under one lock for every cache,
on the capturing thread, in its own capture mode ("thread_local"), so
other threads keep launching, copying, waiting on events and replaying
meanwhile. What no thread may do while a capture is in flight is
synchronise the whole device (torch.cuda.synchronize(), a profiler's
stop), draw from PyTorch's CUDA generator (registered with the graph
being captured) or destroy a CUDA graph: the capture would fail
(PERF.md). The serving path does none of these: collect() waits on an
event, the noise is threefry (ops/prng.py), and a capture calls
capture_begin/capture_end itself, without what torch.cuda.graph adds
around them (a device synchronise, emptying the device and
pinned-memory caches). drop() destroys a graph under the capture lock,
and the cyclic collector is paused while a capture is in flight (a
voice and its batcher form a cycle, so a dropped voice's graphs go with
the collector, on whatever thread it runs).

No fallback: on a CUDA device a capture that fails raises, after
ending its pool's allocation, so the next capture can begin. Replay
and the eager first call give the same bits (tests/test_torch_cuda.py,
chip_smoke.py). TorchVoice catches a plan graph's failure: it logs the
cause, counts it (`fused_failed`) and keeps that plan's batches on the
per-decode path, which runs the same stages and both kernels (as JAX
keeps its per-group dispatches, voice.py:702-715). On the CPU there is
nothing to capture, and run() calls the function.

Launch counts: a replay does not call the kernel wrappers of
ops/cuda/vocoder.py, so each graph records the launches its capture
made (vocoder.recording_launches) and every replay adds them to the
wrappers' counts. The eager calls are counted like any launch, and a
capture counts none: every call counts its own launches once.
"""

from __future__ import annotations

import gc
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


# one capture at a time in the process, whatever its cache: PyTorch's
# CUDA generator and its allocator's routing to a graph pool are state of
# the process
_CAPTURE_LOCK = threading.Lock()


class GraphCache:
    """One CUDA graph per shape key on one device."""

    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        self._graphs: Dict[Hashable, _Graph] = {}
        self._capture_lock = _CAPTURE_LOCK
        # held from copy-in to clone-out of any replay: the graphs share
        # one pool, so one graph's replay may overwrite another's outputs
        self._replay_lock = threading.Lock()
        self._stats_lock = threading.Lock()
        self._pool = None
        self._stream = None  # the captures' side stream
        self._seen: Dict[Hashable, int] = {}  # calls of keys not captured yet
        # captures, replays, seconds spent capturing
        self.stats = {"captures": 0, "replays": 0, "capture_s": 0.0}
        self.capture_seconds: Dict[Hashable, float] = {}  # per key held

    def run(
        self,
        key: Hashable,
        fn: Callable[..., Tuple[torch.Tensor, ...]],
        inputs: Sequence[Optional[torch.Tensor]],
        capture_at: int = 2,
    ) -> Tuple[torch.Tensor, ...]:
        """fn(*inputs): eagerly at a key's calls up to its capture_at-th,
        which then captures the graph at `key`, and as a replay of it
        after that. `inputs` may lie on the host (pinned for an
        asynchronous copy) or on the device; None stays None. Returns
        fresh tensors."""
        if self.device.type != "cuda":
            return tuple(fn(*inputs))
        out = self._replay(key, inputs)
        if out is not None:
            return out
        with self._stats_lock:
            n = self._seen.get(key, 0) + 1
            self._seen[key] = n
        inputs = [None if x is None else x.to(self.device, non_blocking=True) for x in inputs]
        out = tuple(fn(*inputs))
        if n >= capture_at:
            self._capture(key, fn, inputs)
        return out

    def drop(self, key: Hashable) -> None:
        """Destroy the graph at `key`, if there is one, with no capture
        in flight in the process and no replay of this cache."""
        with self._capture_lock, self._replay_lock:
            self._graphs.pop(key, None)
            self.capture_seconds.pop(key, None)

    def _replay(self, key, inputs) -> Optional[Tuple[torch.Tensor, ...]]:
        with self._replay_lock:
            g = self._graphs.get(key)
            if g is None:
                return None
            for static, x in zip(g.inputs, inputs):
                if static is not None:
                    static.copy_(x, non_blocking=True)
            g.graph.replay()
            out = tuple(o.clone() for o in g.outputs)
            launches, g = g.launches, None  # a dropped graph goes here, not later
        for wrapper, n in launches.items():
            for _ in range(n):
                V.count_launch(wrapper)
        with self._stats_lock:
            self.stats["replays"] += 1
        return out

    def _capture(self, key, fn, inputs) -> None:
        with self._capture_lock:
            if key in self._graphs:  # another thread captured it meanwhile
                return
            with self._stats_lock:
                self._seen.pop(key, None)
            t0 = time.perf_counter()
            static = tuple(
                None if x is None
                else torch.empty(x.shape, dtype=x.dtype, device=self.device).copy_(x)
                for x in inputs
            )
            if self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
                self._stream = torch.cuda.Stream(self.device)
            graph = torch.cuda.CUDAGraph()
            collecting = gc.isenabled()
            gc.disable()
            try:
                with V.recording_launches() as launches, torch.cuda.stream(self._stream):
                    graph.capture_begin(pool=self._pool, capture_error_mode="thread_local")
                    try:
                        outputs = tuple(fn(*static))
                    finally:
                        graph.capture_end()
            except BaseException:
                # a capture that failed leaves the pool taking this
                # stream's allocations, and every later capture would fail
                try:
                    torch._C._cuda_endAllocateToPool(
                        torch.cuda.current_device() if self.device.index is None else self.device.index,
                        self._pool)
                except RuntimeError:  # capture_end had ended it
                    pass
                raise
            finally:
                if collecting:
                    gc.enable()
            self._graphs[key] = _Graph(graph, static, outputs, dict(launches))
            seconds = time.perf_counter() - t0
            self.capture_seconds[key] = seconds
            with self._stats_lock:
                self.stats["captures"] += 1
                self.stats["capture_s"] += seconds

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
