"""Dispatch fusion in the port, on the CPU at tiny widths.

Once a speculative batch plan has been seen 3 times, TorchVoice runs
everything after the encodes (every decode of the plan and the packed
transfer) as one function for that batch and captures it into one
graph on the batch's own thread, and the later batches of the plan
replay it (piper_tpu/runtime/voice.py:600-735, _make_fused and
_fused_get). On the CPU the "graph" is the fused function called
eagerly, so the plan logic and the fused body run here: a fused batch's
audio equals the per-decode path's bit for bit (each voice kind, both
wires, a perturbed flow), and the JAX package's fused audio within its
fast tolerance (atol 0.05, tests/test_longform.py:132; as
tests/test_runtime.py:240-268 runs it). Then the 3-sighting policy, the
wait for a plan graph to recur, none captured behind a batcher, the cap
on plan graphs,
dispatch_fusion=False, the misses of a fused batch, a failed capture
and the body's host traffic (none).
"""

from __future__ import annotations

import functools
import logging

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from piper_tpu.config import SynthesisConfig as JSynthesisConfig
from piper_tpu_torch.config import SynthesisConfig
from piper_tpu_torch.models.vits.model import init_synthesizer_params
from piper_tpu_torch.runtime import voice as RV
from test_torch_speculative import CFGS, FAST_ATOL, _jax_voice, _rows
from torch_parity import TINY, perturb_flow_post, tcfg


@functools.lru_cache(maxsize=None)
def _tree(which):
    """Each voice kind's numpy tree in the JAX package's layouts (the
    port's init, which test_torch_mb_istft.py and test_torch_vits2.py
    hold to JAX's), flow perturbed, made once: the voices only read it."""
    return perturb_flow_post(init_synthesizer_params(3, tcfg(CFGS[which])))


def _voice(which="vits", **kw):
    cfg = tcfg(CFGS[which])
    return RV.TorchVoice(_tree(which), cfg, RV.random_voice_config(cfg), precision="fast",
                         device="cpu", seed=0, **kw)


def _seeds(i, rows):
    return [100 * i + j for j in range(len(rows))]


def _batch(voice, rows, syn, i=0):
    return voice.collect(voice.submit(rows, syn=syn, row_seeds=_seeds(i, rows)))


def _same(a_list, b_list):
    return len(a_list) == len(b_list) and all(
        len(a) == len(b) > 0 and np.array_equal(a, b) for a, b in zip(a_list, b_list))


def _pinned(voice, rows, syn, i=0):
    """A batch with the estimate of the voice's first speculative batch,
    so that a plan's `total` recurs."""
    voice.__dict__.setdefault("_pin", (voice._ratio, voice._spec_margin))
    voice._ratio, voice._spec_margin = voice._pin
    return _batch(voice, rows, syn, i)


@pytest.mark.parametrize("wire", ["int16", "mulaw"])
@pytest.mark.parametrize("which", ["vits", "vits2", "mb_istft"])
def test_fused_batch_equals_the_per_decode_batch(which, wire):
    """An exact batch, then speculative batches of the same rows: the
    first two (seed sets 0 and 1) take the per-decode path; the third
    (seed set 0 again) captures the plan's graph and replays it, and the
    fourth (seed set 1) replays it, each with its seed set's per-decode
    audio bit for bit."""
    voice = _voice(which, wire_format=wire)
    syn = SynthesisConfig(seed=4, speaker_id=1 if which == "vits2" else None)
    rows = _rows((5, 14, 30))  # two decodes
    _batch(voice, rows, syn)
    per_decode = [_batch(voice, rows, syn, i) for i in range(2)]
    assert voice._fused_cache == {} and voice.path_counts["fused"] == 0
    for i in range(2):
        assert _same(per_decode[i], _batch(voice, rows, syn, i)), f"seeds {i}"
        assert list(voice._fused_cache.values()) == ["ready"] and voice.path_counts["fused"] == i + 1
    assert voice.path_counts["fused_failed"] == 0 and voice.path_counts["speculative"] == 4


def test_fused_audio_matches_jax_fused():
    """The same numpy weights (flow perturbed) and seed through both
    packages until each has a ready plan: the next batch of each is
    fused, their audio within atol 0.05 (bf16 in both), and each equal
    to its own package's audio before fusion."""
    rows = _rows((5, 9, 12))  # one phoneme bucket: fewer shapes for XLA to compile
    jv, tv = _jax_voice(TINY, _tree("vits")), _voice()
    ref = [jv.synthesize_ids_batch(rows, syn=JSynthesisConfig(seed=9)) for _ in range(4)]
    got = [tv.synthesize_ids_batch(rows, syn=SynthesisConfig(seed=9)) for _ in range(4)]
    assert jv.wait_dispatch_fusion(120) and tv.wait_dispatch_fusion(0)
    assert {v[0] for v in jv._fused_cache.values()} == {"ready"}
    assert set(tv._fused_cache.values()) == {"ready"} and tv.path_counts["fused"] == 1
    ref_fused = jv.synthesize_ids_batch(rows, syn=JSynthesisConfig(seed=9))
    got_fused = tv.synthesize_ids_batch(rows, syn=SynthesisConfig(seed=9))
    assert tv.path_counts["fused"] == 2
    assert [len(g) for g in got_fused] == [len(r) for r in ref_fused]
    for i, (g, r) in enumerate(zip(got_fused, ref_fused)):
        np.testing.assert_allclose(g, r, atol=FAST_ATOL, rtol=0, err_msg=f"row {i}")
    assert _same(got_fused, got[1]) and _same(ref_fused, ref[-1])
    assert max(np.abs(r).max() for r in ref_fused) > 1e-3


def test_plan_is_captured_at_its_third_sighting():
    """JAX's policy (voice.py:687-690): the first two speculative batches
    of a plan only count it; the third captures its graph and replays it.
    Another plan (other rows) starts its own count."""
    voice = _voice()
    syn = SynthesisConfig(seed=2)
    rows = _rows()
    _batch(voice, rows, syn)
    for n in (1, 2):
        _batch(voice, rows, syn)
        assert voice._fused_cache == {} and list(voice._fused_counts.values()) == [n]
    _batch(voice, rows, syn)
    assert list(voice._fused_cache.values()) == ["ready"] and voice.path_counts["fused"] == 1
    _batch(voice, rows[:2], syn)
    assert len(voice._fused_counts) == 2 and voice.path_counts["fused"] == 1
    _batch(voice, rows, syn)
    assert voice.path_counts["fused"] == 2


def _dropped(voice, monkeypatch):
    """The plan keys whose graphs voice.graphs.drop() destroys."""
    dropped, drop = [], voice.graphs.drop
    monkeypatch.setattr(voice.graphs, "drop", lambda key: (dropped.append(key[1]), drop(key)))
    return dropped


def _key(voice, rows):
    """The plan key of `rows` among the voice's plans."""
    (key,) = [k for k in voice._fused_cache if sum(n for _eg, _fb, n in k[1]) == len(rows)]
    return key


def test_a_capture_waits_for_the_last_plan_graph_to_recur(monkeypatch):
    """A plan that reaches its third sighting while the plan graph
    captured last has not been replayed yet is not captured (traffic
    whose plans do not recur stops capturing); a replay of that graph
    lets the next sighting capture. A graph not replayed within
    FUSION_EXPIRY speculative batches of its capture is destroyed, and
    the plan that waited is captured."""
    monkeypatch.setattr(RV, "FUSION_EXPIRY", 4)
    voice = _voice()
    dropped = _dropped(voice, monkeypatch)
    syn = SynthesisConfig(seed=2)
    rows = _rows()
    _batch(voice, rows, syn)
    p1, p2, p3 = rows[:2], rows[:3], rows[:4]
    for ids in (p1, p2, p1, p2, p1, p2):
        _pinned(voice, ids, syn)
    assert list(voice._fused_cache.values()) == ["ready"] and voice.path_counts["fused"] == 1
    _pinned(voice, p2, syn)  # a 4th sighting, but p1's graph has not recurred
    assert len(voice._fused_cache) == 1 and voice.path_counts["fused"] == 1
    _pinned(voice, p1, syn)  # it recurs
    _pinned(voice, p2, syn)
    assert list(voice._fused_cache.values()) == ["ready"] * 2 and voice.path_counts["fused"] == 3
    key_p2 = _key(voice, p2)
    for _ in range(4):  # p2's graph does not recur within 4 batches
        _pinned(voice, p3, syn)
    assert dropped == [key_p2] and key_p2 not in voice._fused_cache
    assert list(voice._fused_cache.values()) == ["ready"] * 2 and voice.path_counts["fused"] == 4


def test_a_voice_behind_a_batcher_replays_but_does_not_capture():
    """A capture holds every request waiting behind it, so a voice that
    serves through a batcher captures no plan: a plan at its third
    sighting there takes the per-decode path, while a plan graph
    captured before the batcher came is replayed, with its bits."""
    from piper_tpu_torch.server.batcher import CoalescingBatcher

    voice = _voice()
    syn = SynthesisConfig(seed=2)
    rows = _rows()
    _batch(voice, rows, syn)
    for _ in range(3):
        want = _pinned(voice, rows, syn)
    assert list(voice._fused_cache.values()) == ["ready"] and voice.path_counts["fused"] == 1
    voice.batcher = CoalescingBatcher(voice, window_ms=1.0, max_batch=16)
    try:
        for _ in range(3):
            _pinned(voice, rows[:2], syn)
        assert len(voice._fused_cache) == 1 and voice.path_counts["fused"] == 1
        assert _same(want, _pinned(voice, rows, syn)) and voice.path_counts["fused"] == 2
    finally:
        voice.batcher.close()


def test_plan_graphs_past_the_cap_drop_the_least_recently_replayed(monkeypatch):
    """With room for FUSION_PLANS plan graphs, a capture past them drops
    the graph replayed least recently (its plan starts over), and the
    graphs kept still give their batches' bits."""
    monkeypatch.setattr(RV, "FUSION_PLANS", 2)
    voice = _voice()
    dropped = _dropped(voice, monkeypatch)
    syn = SynthesisConfig(seed=2)
    rows = _rows()
    _batch(voice, rows, syn)
    a, b, c = rows[:2], rows[:3], rows[:4]
    for ids in (a, a, a, a, b, b, b, b):  # each captured, then replayed
        _pinned(voice, ids, syn)
    want_a = _pinned(voice, a, syn)  # a is now the most recently replayed
    key_b = _key(voice, b)
    for _ in range(3):
        _pinned(voice, c, syn)
    assert dropped == [key_b] and key_b not in voice._fused_cache
    assert list(voice._fused_cache.values()) == ["ready", "ready"]
    fused = voice.path_counts["fused"]
    assert _same(want_a, _pinned(voice, a, syn)) and voice.path_counts["fused"] == fused + 1


def test_dispatch_fusion_off_never_fuses():
    """dispatch_fusion=False: no plan is counted or captured, every
    batch takes the per-decode path, and wait_dispatch_fusion returns at
    once."""
    voice = _voice(dispatch_fusion=False)
    syn = SynthesisConfig(seed=2)
    rows = _rows()
    outs = [_batch(voice, rows, syn) for _ in range(6)]
    assert voice.wait_dispatch_fusion(0)
    assert voice._fused_cache == {} and voice._fused_counts == {}
    assert voice.path_counts["fused"] == 0 and voice.path_counts["speculative"] == 5
    assert all(_same(outs[1], o) for o in outs[2:])


@pytest.mark.parametrize("miss", ["overflow", "shortfall"])
def test_misses_of_a_fused_batch_give_the_exact_bits(miss):
    """The estimate pinned before every batch, so its plan recurs: a
    bucket overflow (0.5 frames per id: rows re-decode at their true
    bucket) or a margin shortfall (margin 0.25: rows past the transfer
    are re-fetched from the fused graph's audio). The fused batch misses
    as the per-decode ones did, and every row is the exact batch's audio
    bit for bit."""
    voice = _voice()
    voice.frame_buckets = [16, 32, 64, 128, 256, 512]  # small buckets, so short rows can miss
    syn = SynthesisConfig(seed=6)
    rows = _rows()
    exact = _batch(voice, rows, syn)
    ratio = voice._ratio

    def pinned():
        if miss == "overflow":
            voice._ratio = (0.5, 0.5)
        else:
            voice._ratio, voice._spec_margin = ratio, 0.25
        return _batch(voice, rows, syn)

    for _ in range(2):
        assert _same(exact, pinned())
    count = "redecoded" if miss == "overflow" else "refetched"
    before = voice.path_counts[count]
    assert voice._fused_cache == {} and before > 0
    assert _same(exact, pinned())
    assert set(voice._fused_cache.values()) == {"ready"} and voice.path_counts["fused"] == 1
    assert voice.path_counts[count] - before > 0


def test_failed_capture_is_logged_counted_and_keeps_the_bits(monkeypatch, caplog):
    """A capture that raises: the plan is "failed", `fused_failed` counts
    it, the warning names the plan and carries the cause, and its batches
    keep the per-decode path with the same bits."""
    voice = _voice()
    syn = SynthesisConfig(seed=2)
    rows = _rows()

    def no_graph(key):
        raise RuntimeError("capture refused for the test")

    monkeypatch.setattr(voice, "_make_fused", no_graph)
    _batch(voice, rows, syn)
    with caplog.at_level(logging.WARNING, logger=RV.__name__):
        outs = [_batch(voice, rows, syn) for _ in range(3)]
    assert set(voice._fused_cache.values()) == {"failed"} and voice.path_counts["fused_failed"] == 1
    (rec,) = [r for r in caplog.records if "dispatch fusion" in r.getMessage()]
    assert rec.exc_info and "capture refused for the test" in str(rec.exc_info[1])
    assert _same(outs[0], _batch(voice, rows, syn)) and voice.path_counts["fused"] == 0


class _HostTraffic(TorchDispatchMode):
    """Records every op that makes a tensor from host data (torch.tensor:
    lift_fresh) or reads a value back to the host (.item(), bool())."""

    REFUSED = ("lift_fresh", "_local_scalar_dense", "_to_cpu")

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(name in str(func) for name in self.REFUSED):
            self.seen.append(str(func))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("which", ["vits2", "mb_istft"])
def test_plan_body_makes_no_host_traffic(which, monkeypatch):
    """The fused body, on the batch that captures it, makes no tensor
    from host data and reads no value back (on the card either would be
    a host copy or a host read inside the capture), and gives the
    per-decode batch's packed transfer and audio bit for bit."""
    voice = _voice(which)
    syn = SynthesisConfig(seed=3, speaker_id=2 if which == "vits2" else None)
    rows = _rows()
    _batch(voice, rows, syn)
    seen = []
    run = voice.graphs.run

    def watched(key, fn, inputs, capture_at=2):
        if key[0] != "plan":
            return run(key, fn, inputs, capture_at)
        with _HostTraffic() as mode:
            out = run(key, fn, inputs, capture_at)
        seen.append(mode.seen)
        return out

    monkeypatch.setattr(voice.graphs, "run", watched)
    handles = []
    for _ in range(3):
        handles.append(voice.submit(rows, syn=syn, row_seeds=_seeds(0, rows)))
        voice.collect(handles[-1])
    assert seen == [[]] and voice.path_counts["fused"] == 1
    assert torch.equal(handles[0]["host"], handles[2]["host"])
    assert all(torch.equal(a, b) for a, b in zip(handles[0]["spec"]["audio"], handles[2]["spec"]["audio"]))
