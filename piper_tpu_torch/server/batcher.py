"""Cross-request dynamic batching (a copy of piper_tpu/server/batcher.py).

The reference HTTP server synthesizes batch-1 per request - each Flask
request runs its own ONNX inference call
(src/python_run/piper/http_server.py:103-123). This module coalesces
across requests: N concurrent single-sentence clients ride one device
batch.

Design: request threads enqueue their phrase id-lists and block on an
event. A dispatcher thread gathers a few-ms window (capped at
`max_batch` utterances), groups by the device-relevant synthesis
parameters, and calls `voice.submit()` once per group, which enqueues
the batch on the card and starts its copy to the host. The handles flow
to a collector thread that calls `voice.collect()`, so the next window
is submitted while the last one is copied out. Waveform order within a
request is preserved; under a fixed `syn.seed` the voice's
per-utterance content-hash keys give each utterance the same noise in
any batch, the encodes run at one row count and every decode's
frame-level stages run in frame windows of one shape, so on the card
coalescing does not change a row's bits in either precision (tests/test_torch_cuda.py checks the x-low, low,
medium and high presets at 16 rows).

Admission is priority-ordered: requests carry `syn.priority` (lower
dispatches sooner, FIFO within a priority) and an optional
`syn.deadline_s` queue-wait budget - a request still waiting in the
admission queue past its deadline is shed with DeadlineExceeded
instead of taking a device slot (batches in flight are never
cancelled).
"""

from __future__ import annotations

import logging
import queue
import threading
from typing import List, Optional, Sequence

from ..config import SynthesisConfig

_LOGGER = logging.getLogger(__name__)

# Sentinel priority: drains after every real request so close() never
# strands a queued waiter in event.wait().
_SHUTDOWN_PRIO = 1 << 62


class DeadlineExceeded(RuntimeError):
    """The request's syn.deadline_s elapsed while it was still waiting
    in the admission queue (it was shed before any device work)."""


class _Pending:
    __slots__ = (
        "ids_list", "syn", "key", "event", "results", "error",
        "priority", "deadline",
    )

    def __init__(self, ids_list, syn, key, priority=0, deadline=None):
        self.ids_list = ids_list
        self.syn = syn
        self.key = key
        self.priority = priority
        self.deadline = deadline  # absolute time.monotonic() or None
        self.event = threading.Event()
        self.results: Optional[list] = None
        self.error: Optional[BaseException] = None


def _syn_key(voice, syn: SynthesisConfig):
    """Device-relevant synthesis parameters: requests may share one
    submit() only when these agree (silence/volume are applied
    host-side after synthesis and do not gate batching; SEEDS are
    per-row — submit(row_seeds=...) derives each utterance's noise key
    independently, so differently-seeded requests still coalesce)."""
    inf = voice.config.inference
    return (
        syn.speaker_id,
        syn.noise_scale if syn.noise_scale is not None else inf.noise_scale,
        syn.length_scale if syn.length_scale is not None else inf.length_scale,
        syn.noise_w if syn.noise_w is not None else inf.noise_w,
    )


class CoalescingBatcher:
    """Admission queue in front of a TorchVoice's batched pipeline."""

    def __init__(
        self,
        voice,
        *,
        window_ms: float = 4.0,
        max_batch: int = 32,
        max_queue: int = 1024,
    ):
        self.voice = voice
        self.window_s = window_ms / 1000.0
        self.max_batch = max_batch
        # (priority, seq, _Pending | None): heap order is priority then
        # arrival, so urgent requests jump a backed-up queue while ties
        # stay FIFO. seq also keeps _Pending itself out of comparisons.
        self._q: "queue.PriorityQueue" = queue.PriorityQueue(max_queue)
        self._seq = 0
        # Serving counters (read by the server's /metrics endpoint).
        # "requests" is written under _close_lock; the rest only by the
        # dispatcher thread, so each has one writer at a time.
        self.stats = {
            "requests": 0,     # admitted synthesize_ids_batch calls
            "batches": 0,      # device batches dispatched
            "utterances": 0,   # utterances across those batches
            "shed_deadline": 0,  # requests shed past their deadline
            "errors": 0,       # batches that raised
        }
        self._handles: "queue.Queue" = queue.Queue()
        self._closed = False
        # Guards the closed-flag/sentinel pair: no request may enqueue
        # after the shutdown sentinel (it would strand its thread in
        # event.wait() forever).
        self._close_lock = threading.Lock()
        self._dispatcher = threading.Thread(
            target=self._dispatch_loop, daemon=True,
            name="piper-torch-batch-dispatch",
        )
        self._collector = threading.Thread(
            target=self._collect_loop, daemon=True,
            name="piper-torch-batch-collect",
        )
        self._dispatcher.start()
        self._collector.start()

    # -- request side --------------------------------------------------

    def synthesize_ids_batch(
        self,
        ids_list: Sequence[Sequence[int]],
        *,
        syn: Optional[SynthesisConfig] = None,
        stats=None,
    ) -> List:
        """Drop-in for TorchVoice.synthesize_ids_batch; blocks the
        calling (request) thread until its waveforms are ready."""
        import time

        if not ids_list:
            return []
        syn = syn or SynthesisConfig()
        t0 = time.perf_counter()
        priority = getattr(syn, "priority", 0) or 0
        deadline_s = getattr(syn, "deadline_s", None)
        deadline = (
            time.monotonic() + deadline_s if deadline_s is not None else None
        )
        p = _Pending(
            list(ids_list), syn, _syn_key(self.voice, syn),
            priority=priority, deadline=deadline,
        )
        with self._close_lock:
            if self._closed:
                raise RuntimeError("batcher is closed")
            self._seq += 1
            try:
                # non-blocking: a blocking put would hold the close
                # lock and deadlock close(); at max_queue depth the
                # server is overloaded and should shed load anyway
                self._q.put_nowait((priority, self._seq, p))
                self.stats["requests"] += 1
            except queue.Full:
                raise RuntimeError(
                    "batcher admission queue full (overloaded)"
                ) from None
        p.event.wait()
        if p.error is not None:
            raise p.error
        if stats is not None:
            stats.infer_seconds += time.perf_counter() - t0
            stats.audio_seconds += sum(
                len(r) for r in p.results
            ) / self.voice.config.sample_rate
        return p.results

    def close(self) -> None:
        with self._close_lock:
            if self._closed:
                return
            self._closed = True
            self._q.put((_SHUTDOWN_PRIO, 0, None))
        self._dispatcher.join(timeout=5)
        self._handles.put(None)
        self._collector.join(timeout=5)

    # -- worker side ---------------------------------------------------

    def _shed_if_expired(self, p: _Pending, now: float) -> bool:
        """Fail a request whose queue-wait deadline already passed —
        before it occupies a device slot. Returns True when shed."""
        if p.deadline is None or now <= p.deadline:
            return False
        p.error = DeadlineExceeded(
            f"request shed: waited past deadline_s={p.syn.deadline_s} "
            "in the admission queue"
        )
        p.event.set()
        self.stats["shed_deadline"] += 1
        _LOGGER.debug("shed %d utterances past deadline", len(p.ids_list))
        return True

    def _dispatch_loop(self) -> None:
        import time

        carry = None
        while True:
            if carry is not None:
                first, carry = carry, None
            else:
                _prio, _seq, first = self._q.get()
            if first is None:
                return
            if self._shed_if_expired(first, time.monotonic()):
                continue
            group = [first]
            n = len(first.ids_list)
            deadline = time.monotonic() + self.window_s
            while n < self.max_batch:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    _prio, _seq, p = self._q.get(timeout=remaining)
                except queue.Empty:
                    break
                if p is None:
                    self._flush(group)
                    return
                if self._shed_if_expired(p, time.monotonic()):
                    continue
                if n + len(p.ids_list) > self.max_batch and n > 0:
                    # Would exceed the cap (the largest warmed batch):
                    # this request seeds the NEXT window instead.
                    carry = p
                    break
                group.append(p)
                n += len(p.ids_list)
            self._flush(group)

    def _flush(self, group: List[_Pending]) -> None:
        by_key: dict = {}
        for p in group:
            by_key.setdefault(p.key, []).append(p)
        for ps in by_key.values():
            ids: List = []
            seeds: List = []
            spans = []
            for p in ps:
                spans.append((p, len(ids), len(ids) + len(p.ids_list)))
                ids.extend(p.ids_list)
                seeds.extend([p.syn.seed] * len(p.ids_list))
            try:
                handle = self.voice.submit(
                    ids, syn=ps[0].syn, row_seeds=seeds
                )
            except BaseException as e:  # noqa: BLE001 - propagate to waiters
                self.stats["errors"] += 1
                for p in ps:
                    p.error = e
                    p.event.set()
                continue
            self.stats["batches"] += 1
            self.stats["utterances"] += len(ids)
            _LOGGER.debug(
                "coalesced %d requests (%d utterances) into one batch",
                len(ps), len(ids),
            )
            self._handles.put((handle, spans))

    def _collect_loop(self) -> None:
        while True:
            item = self._handles.get()
            if item is None:
                return
            handle, spans = item
            try:
                audios = self.voice.collect(handle)
            except BaseException as e:  # noqa: BLE001
                for p, _a, _b in spans:
                    p.error = e
                    p.event.set()
                continue
            for p, a, b in spans:
                p.results = audios[a:b]
                p.event.set()
