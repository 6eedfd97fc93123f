"""The speculative serving path of the port, on the CPU at tiny widths.

A batch after the first (which takes the exact path and calibrates the
frames-per-id estimator) decodes at estimated frame buckets with no
frame-count read, and its audio equals the exact batch's bit for bit:
every plain frame-level stage runs in fixed frame windows, and the
kernels' plain versions run fixed-tile products (ROADMAP fault 17).
Against the JAX package: its speculative audio on the same numpy weights
and seed, within piper_tpu's fast-precision tolerance (atol 0.05,
tests/test_longform.py:132); the estimator's and the margin's updates on
the same scripted ratios and needs. Then the misses (a bucket overflow,
a margin shortfall, a row past the ladder), the estimator snapshot and
pack_total.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from piper_tpu.config import InferenceDefaults, VoiceConfig
from piper_tpu.config import SynthesisConfig as JSynthesisConfig
from piper_tpu.runtime.voice import TpuVoice
from piper_tpu_torch.config import SynthesisConfig
from piper_tpu_torch.runtime import voice as RV
from piper_tpu_torch.runtime.profiling import StageTimer
from torch_parity import TINY, TINY_MB, TINY_VITS2, jax_params, perturb_flow_post, tcfg

FAST_ATOL = 0.05  # piper_tpu's bf16 tolerance on waveforms (tests/test_longform.py:132)
CFGS = {"vits": TINY, "vits2": TINY_VITS2, "mb_istft": TINY_MB}


def _tree(which="vits", seed=3):
    return perturb_flow_post(jax_params(CFGS[which], seed))


def _voice(which="vits", tree=None, **kw):
    cfg = tcfg(CFGS[which])
    return RV.TorchVoice(tree if tree is not None else _tree(which), cfg, RV.random_voice_config(cfg),
                         precision="fast", device="cpu", seed=0, **kw)


def _rows(lengths=(5, 14, 30, 9, 22), seed=7, n_sym=TINY.num_symbols):
    rng = np.random.default_rng(seed)
    return [[1, 0] + [int(x) for s in rng.integers(3, n_sym, n) for x in (s, 0)] + [2]
            for n in lengths]


def _batch(voice, rows, syn, seeds=None):
    return voice.collect(voice.submit(rows, syn=syn, row_seeds=seeds))


@pytest.mark.parametrize("which", ["vits", "vits2", "mb_istft"])
def test_speculative_batch_equals_exact_batch(which):
    """Batch 1 takes the exact path (one frame-count read) and calibrates
    the estimator; batch 2 of the same rows takes the speculative path,
    with no frames_wait span in its submit, and gives the same audio bit
    for bit (a perturbed flow: a random flow is the identity)."""
    voice = _voice(which)
    syn = SynthesisConfig(seed=4, speaker_id=1 if which == "vits2" else None)
    rows = _rows()
    voice.timer = StageTimer()
    exact = _batch(voice, rows, syn)
    assert voice.path_counts["exact"] == 1 and voice.timer.counts["frames_wait"] == 1
    assert voice._ratio is not None
    spec = _batch(voice, rows, syn)
    assert voice.path_counts["speculative"] == 1 and voice.timer.counts["frames_wait"] == 1
    assert voice.timer.counts["pack"] == 1
    for a, b in zip(exact, spec):
        assert len(a) == len(b) > 0
        np.testing.assert_array_equal(a, b)


def _jax_voice(jcfg, tree, **kw):
    id_map = {chr(32 + i): [i] for i in range(jcfg.num_symbols)}
    vconfig = VoiceConfig(num_symbols=jcfg.num_symbols, num_speakers=jcfg.num_speakers,
                          sample_rate=jcfg.audio.sample_rate, espeak_voice="en-us",
                          inference=InferenceDefaults(), phoneme_id_map=id_map)
    return TpuVoice(tree, jcfg, vconfig, precision="fast", seed=0, **kw)


def test_speculative_audio_matches_jax_speculative():
    """The same numpy weights (flow perturbed) and seed through both
    packages' speculative paths (each after its exact batch): the same
    lengths, the audio within atol 0.05 (bf16 in both; piper_tpu's fast
    tolerance), and both packages' speculative audio equal to their
    exact audio."""
    tree = _tree()
    rows = _rows()
    jv, tv = _jax_voice(TINY, tree), _voice(tree=tree)
    ref_exact = jv.synthesize_ids_batch(rows, syn=JSynthesisConfig(seed=9))
    ref = jv.synthesize_ids_batch(rows, syn=JSynthesisConfig(seed=9))
    got_exact = tv.synthesize_ids_batch(rows, syn=SynthesisConfig(seed=9))
    got = tv.synthesize_ids_batch(rows, syn=SynthesisConfig(seed=9))
    assert tv.path_counts == {"exact": 1, "speculative": 1, "fused": 0, "refetched": 0,
                              "redecoded": 0, "longform": 0, "fused_failed": 0}
    assert [len(g) for g in got] == [len(r) for r in ref]
    for i, (g, r) in enumerate(zip(got, ref)):
        np.testing.assert_allclose(g, r, atol=FAST_ATOL, rtol=0, err_msg=f"row {i}")
        np.testing.assert_array_equal(g, got_exact[i])
        np.testing.assert_array_equal(r, ref_exact[i])
    assert max(np.abs(r).max() for r in ref) > 1e-3


def _spec_batch(rows_frames, ids_len, fits: bool, u: int, est_body: int):
    """A speculative transfer (int16 wire) of rows with these true frame
    counts, all in one decode group wide enough for each: the header, a
    body of zeros (or one sample short, so the last row is re-fetched),
    and the rows' tuples as both packages lay them out."""
    r = len(rows_frames)
    a0 = -(-2 * r // 128) * 128
    valid = sum(f * u for f in rows_frames)
    total = a0 + valid + (0 if fits else -1)
    hdr = np.zeros(a0, np.int16)
    hdr[0 : 2 * r : 2] = [f & 0x7FFF for f in rows_frames]
    hdr[1 : 2 * r : 2] = [f >> 15 for f in rows_frames]
    flat = np.concatenate([hdr, np.zeros(total - a0, np.int16)])
    cap = (max(rows_frames) + 1) * u
    rows = [(i, cap, 0, i, 0, i, ids_len[i]) for i in range(r)]
    audio = np.zeros((r, cap), np.int16)
    return flat, rows, audio, dict(a0=a0, total=total, est_body=est_body)


def test_estimator_and_margin_follow_jax():
    """Both packages' _collect_speculative on the same scripted batches
    (true frame counts per id and transfer needs, some short by one
    sample): the same (rm, ru) estimator, margin and calibration state
    after every batch, through the first calibration window (4 batches),
    a shortfall, the tightening window (16) and a jump of the ratios."""
    jv, tv = _jax_voice(TINY, jax_params(TINY, 3)), _voice()
    u = TINY.upsample_factor
    rng = np.random.default_rng(1)
    script = []
    for step in range(30):
        ratio = 2.0 if step < 22 else 4.5
        ids = [int(n) for n in rng.integers(10, 60, 6)]
        frames = [max(1, int(n * ratio * rng.uniform(0.8, 1.2))) for n in ids]
        need = rng.uniform(0.6, 0.9)
        script.append((frames, ids, step not in (6, 25), int(sum(frames) * u / need)))
    exact_frames = [int(n * 2) for n in (20, 30, 40)]
    jv._update_ratio([f / n for f, n in zip(exact_frames, (20, 30, 40))])
    tv._update_ratio([f / n for f, n in zip(exact_frames, (20, 30, 40))])
    for frames, ids, fits, est_body in script:
        flat, rows, audio, meta = _spec_batch(frames, ids, fits, u, est_body)
        jv._collect_speculative(dict(meta, packed=flat, rows=rows, audio=[audio]), [None] * len(rows), u)
        handle = {"host": torch.from_numpy(flat), "decodes": 1,
                  "spec": dict(meta, rows=rows, audio=[torch.from_numpy(audio)])}
        tv._collect_speculative(handle, [None] * len(rows))
        assert tv._ratio == jv._ratio
        assert tv._spec_margin == jv._spec_margin
        assert tv._spec_calibrated == jv._spec_calibrated
        assert tv._spec_need_hist == jv._spec_need_hist
    assert tv.path_counts["refetched"] == 2


@pytest.mark.parametrize("miss", ["overflow", "shortfall", "past_ladder"])
def test_speculative_misses_give_the_exact_bits(miss):
    """A forced bucket overflow (the estimate set low: the rows
    re-decode at their true bucket, one decode per encode group and
    bucket), a forced margin shortfall (margin 0.25: the rows past the
    transfer are re-fetched from the decodes) and a row past the frame
    ladder (re-decoded alone at its own frame count): each gives the
    exact path's audio bit for bit."""
    voice = _voice()
    syn = SynthesisConfig(seed=6)
    rows = _rows()
    voice.frame_buckets = [16, 32, 64, 128, 256, 512]  # small buckets, so short rows can miss
    if miss == "past_ladder":
        voice.frame_buckets = [16, 32, 64, 128]
        rows = rows + _rows((60,), seed=11)  # past the ladder of 128 frames
    exact = _batch(voice, rows, syn)
    if miss == "past_ladder":
        assert max(len(a) for a in exact) > 128 * TINY.upsample_factor
        voice._ratio = (voice._ratio[0], min(voice._ratio[1], 2.0))
    elif miss == "overflow":
        voice._ratio = (0.5, 0.5)
    else:
        voice._spec_margin = 0.25
    handle = voice.submit(rows, syn=syn)
    decodes = handle["decodes"]
    spec = voice.collect(handle)
    counts = voice.path_counts
    assert counts["speculative"] == 1
    if miss == "overflow":
        assert counts["redecoded"] > 0 and handle["decodes"] > decodes
    elif miss == "shortfall":
        assert counts["refetched"] > 0 and voice._spec_margin > 0.25
    else:
        assert counts["longform"] == 1
    for a, b in zip(exact, spec):
        assert len(a) == len(b)
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("corrupt", [None, "not json", '{"ratio": [1.0, NaN], "margin": 1.0}',
                                     '{"ratio": [1.0, 2.0], "margin": 3.0}',
                                     '{"ratio": [-1.0, 2.0], "margin": 1.0}'])
def test_estimator_cache_round_trip_and_rejection(tmp_path, corrupt):
    """With estimator_cache=True the calibrated estimator and margin are
    written atomically under <cache_dir>/piper_tpu_torch/estimators/, and
    a fresh voice of the same weights and knobs starts from them: its
    first batch is speculative. Another wire is another snapshot. A
    corrupt or out-of-range snapshot is deleted and ignored: the fresh
    voice's first batch is exact."""
    tree = _tree()
    first = _voice(tree=tree, estimator_cache=True, cache_dir=tmp_path)
    _batch(first, _rows(), SynthesisConfig(seed=1))
    snaps = list((tmp_path / "piper_tpu_torch" / "estimators").glob("*.json"))
    assert len(snaps) == 1 and not list(snaps[0].parent.glob("*.tmp*"))
    snap = json.loads(snaps[0].read_text())
    assert snap["ratio"] == list(first._ratio) and snap["margin"] == first.spec_margin
    if corrupt is not None:
        snaps[0].write_text(corrupt)
    fresh = _voice(tree=tree, estimator_cache=True, cache_dir=tmp_path)
    if corrupt is None:
        assert fresh._ratio == first._ratio
    else:
        assert fresh._ratio is None and not snaps[0].exists()
    _batch(fresh, _rows(seed=8), SynthesisConfig(seed=2))
    assert fresh.path_counts["speculative" if corrupt is None else "exact"] == 1
    other = _voice(tree=tree, estimator_cache=True, cache_dir=tmp_path, wire_format="mulaw")
    assert other._estimator_cache_path != fresh._estimator_cache_path and other._ratio is None


def test_pack_total_pow2():
    """pack_total sizes the transfer: "quantum" rounds the body up to
    65,536 samples, "pow2" to a power of two of at least that; the audio
    is the same either way."""
    assert RV.round_total(1, "quantum") == RV.round_total(65536, "pow2") == 65536
    assert RV.round_total(65537, "quantum") == 131072 and RV.round_total(200000, "pow2") == 262144
    assert RV.round_total(200000, "quantum") == 262144 and RV.round_total(300000, "pow2") == 524288
    rows, syn = _rows(), SynthesisConfig(seed=2)
    outs = {}
    for mode in ("quantum", "pow2"):
        voice = _voice(pack_total=mode)
        _batch(voice, rows, syn)
        handle = voice.submit(rows, syn=syn)
        body = handle["spec"]["total"] - handle["spec"]["a0"]
        assert body >= RV.PACK_QUANTUM and (body & (body - 1) == 0 if mode == "pow2"
                                            else body % RV.PACK_QUANTUM == 0)
        outs[mode] = voice.collect(handle)
    for a, b in zip(outs["quantum"], outs["pow2"]):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="pack_total"):
        _voice(pack_total="exact")
