"""The port's batch dispatch on the CPU: the decode planner against the
JAX package's, one frame-count read per submit (Phase B), every
decode_grouping giving a row its solo audio, the id upload's dtype,
graph launch recording, and StageTimer's report format.

Bounds: parity rows within 1e-5 of the row alone (float32 on the CPU:
the plain einsums' blocking follows the batch's shape, which moves a
sample by about 1e-7).
"""

import types

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from piper_tpu.runtime.batching import DEFAULT_FRAME_BUCKETS as JAX_FRAME_BUCKETS
from piper_tpu.runtime.profiling import StageTimer as JaxStageTimer
from piper_tpu.runtime.voice import TpuVoice
from piper_tpu_torch.config import AudioConfig, ModelConfig, SynthesisConfig
from piper_tpu_torch.models.vits import model as M
from piper_tpu_torch.ops.cuda import vocoder as V
from piper_tpu_torch.runtime import batching
from piper_tpu_torch.runtime import voice as RV
from piper_tpu_torch.runtime.graphs import GraphCache
from piper_tpu_torch.runtime.profiling import StageTimer

CFG = ModelConfig(
    num_symbols=256, inter_channels=32, hidden_channels=32, filter_channels=64,
    n_heads=2, n_layers=2, upsample_initial_channel=64, audio=AudioConfig(sample_rate=22050),
)
# small frame buckets, so a few short rows span several of them
FRAME_BUCKETS = [16, 24, 32, 48, 64, 96, 128, 4096]


@pytest.fixture(scope="module")
def params():
    return M.init_synthesizer_params(0, CFG)


def _voice(params, precision="parity", frame_buckets=None, **kw):
    voice = RV.TorchVoice(params, CFG, RV.random_voice_config(CFG), precision=precision,
                          device="cpu", seed=0, **kw)
    if frame_buckets is not None:
        voice.frame_buckets = frame_buckets
    return voice


def _rows():
    """Rows in 3 phoneme buckets (32, 48, 80 ids at most)."""
    rng = np.random.default_rng(3)
    return [[1, 0] + [int(x) for s in rng.integers(3, 200, n) for x in (s, 0)] + [2]
            for n in (3, 12, 8, 17, 30, 6, 25)]


def test_frame_buckets_and_round_rows_are_the_jax_ones():
    assert batching.DEFAULT_FRAME_BUCKETS == list(JAX_FRAME_BUCKETS)
    stub = types.SimpleNamespace(_data_size=1)
    for n in range(1, 70):
        assert batching.round_rows(n) == TpuVoice._round_rows(stub, n)


@settings(max_examples=60, deadline=None)
@given(
    frames=st.lists(st.integers(1, max(JAX_FRAME_BUCKETS)), min_size=1, max_size=24),
    grouping=st.sampled_from(batching.DECODE_GROUPINGS),
)
def test_planner_matches_jax(frames, grouping):
    """plan_decode_groups gives TpuVoice._plan_decode_groups' groups for
    any frame counts on the ladder, under every grouping."""
    stub = types.SimpleNamespace(
        decode_grouping=grouping, frame_buckets=list(JAX_FRAME_BUCKETS),
        _round_rows=batching.round_rows,
    )
    want = TpuVoice._plan_decode_groups(stub, frames)
    got = batching.plan_decode_groups(frames, grouping, batching.DEFAULT_FRAME_BUCKETS)
    assert [(int(fb), list(rows)) for fb, rows in got] == [(int(fb), list(rows)) for fb, rows in want]


def test_rows_past_the_ladder_decode_alone(params):
    voice = _voice(params, decode_grouping="uniform", frame_buckets=[16, 32])
    assert voice._plan_decode_groups([5, 40, 20, 33]) == [(32, [0, 2]), (40, [1]), (33, [3])]


def test_one_frame_count_read_per_submit(params):
    """A submit over 3 phoneme buckets encodes 3 times and reads every
    frame count in one copy, after the last encode."""
    voice = _voice(params, "fast")
    events = []
    encode, read = voice._encode, voice._read_frames

    def counting_encode(*a, **k):
        events.append("encode")
        return encode(*a, **k)

    def counting_read(frames):
        events.append(("read", len(frames)))
        return read(frames)

    voice._encode, voice._read_frames = counting_encode, counting_read
    rows = _rows()
    n_buckets = len(batching.group_by_bucket([len(r) for r in rows], voice.phoneme_buckets))
    assert n_buckets >= 3
    voice.collect(voice.submit(rows, syn=SynthesisConfig(seed=1)))
    assert events == ["encode"] * n_buckets + [("read", n_buckets)]


@pytest.mark.parametrize("grouping", batching.DECODE_GROUPINGS)
def test_every_grouping_gives_each_row_its_solo_audio(params, grouping):
    """Parity: the rows of one submit, planned by `grouping` over small
    frame buckets, each within 1e-5 of the row alone."""
    voice = _voice(params, decode_grouping=grouping, frame_buckets=FRAME_BUCKETS)
    rows = _rows()
    seeds = list(range(len(rows)))
    handle = voice.submit(rows, row_seeds=seeds)
    together = voice.collect(handle)
    frames = [len(a) // CFG.upsample_factor for a in together]
    assert len({batching.pick_bucket(f, FRAME_BUCKETS) for f in frames}) >= 2, frames
    if grouping == "bucketed":
        assert handle["decodes"] > 3  # more decodes than phoneme buckets
    for i, (row, seed) in enumerate(zip(rows, seeds)):
        alone = voice.synthesize_ids_batch([row], syn=SynthesisConfig(seed=seed))[0]
        assert len(alone) == len(together[i])
        np.testing.assert_allclose(together[i], alone, atol=1e-5, rtol=0, err_msg=f"row {i}")


@pytest.mark.parametrize("num_symbols,dtype", [
    (256, torch.uint8), (300, torch.int16), (40000, torch.int32),
])
def test_id_upload_dtype_follows_num_symbols(num_symbols, dtype, monkeypatch):
    """The ids reach the encode in TpuVoice's _ids_wire_dtype (voice.py:243)."""
    cfg = ModelConfig(
        num_symbols=num_symbols, inter_channels=16, hidden_channels=16, filter_channels=32,
        n_heads=2, n_layers=1, upsample_initial_channel=32,
    )
    voice = RV.TorchVoice(M.init_synthesizer_params(0, cfg), cfg, RV.random_voice_config(cfg),
                          device="cpu", seed=0)
    assert voice._ids_wire_dtype == dtype
    seen = []
    run = voice.graphs.run

    def recording_run(key, fn, inputs):
        seen.append(inputs[0].dtype)
        return run(key, fn, inputs)

    monkeypatch.setattr(voice.graphs, "run", recording_run)
    voice._encode([[1, 0, num_symbols - 1, 0, 2]], [7], 32, SynthesisConfig())
    assert seen == [dtype]


def test_encode_step_takes_its_scales_as_a_tensor(params):
    """The encode graph's scales are an input tensor: the same bits as
    the Python numbers of an eager encode (which is given the noise the
    graph draws from the row's key)."""
    voice = _voice(params)
    ids = torch.tensor([[1, 0, 40, 0, 41, 0, 2] + [0] * 25])
    lengths = torch.tensor([7], dtype=torch.int32)
    keys = RV.key_table([RV.utterance_seed(0, [1, 0, 40, 0, 41, 0, 2])])
    noise = RV.duration_noise_rows(keys, 32)
    *enc, frames = voice._encode_step(ids.to(torch.uint8), lengths, keys,
                                      torch.tensor([0.8, 1.3]), None)
    ref = M.synthesizer_encode(voice.params, ids, lengths, cfg=CFG, noise_w_scale=0.8,
                               length_scale=1.3, dur_noise=noise, dtype=voice.dtype)
    for got, want in zip(enc, ref):
        assert torch.equal(got, want)
    assert torch.equal(frames, ref.durations.sum(-1))


def test_encodes_run_at_one_row_count(params, monkeypatch):
    """A bucket's rows encode in slices of ENCODE_ROWS padded with the
    slice's first row (20 rows: 16 + 4), every slice at the same shape,
    so each row's encode is the bits of the row encoded alone."""
    voice = _voice(params)
    shapes = []
    run = voice.graphs.run

    def recording_run(key, fn, inputs):
        shapes.append(tuple(inputs[0].shape))
        return run(key, fn, inputs)

    monkeypatch.setattr(voice.graphs, "run", recording_run)
    rng = np.random.default_rng(5)
    rows = [[1] + [int(x) for x in rng.integers(3, 200, n)] + [2] for n in rng.integers(5, 28, 20)]
    keys = list(range(20))
    with torch.inference_mode():
        enc, frames = voice._encode(rows, keys, 32, SynthesisConfig())
        assert shapes == [(RV.ENCODE_ROWS, 32)] * 2 and enc.m_p.shape[0] == frames.shape[0] == 20
        for i in (0, 7, 16, 19):
            alone, f1 = voice._encode([rows[i]], [keys[i]], 32, SynthesisConfig())
            assert torch.equal(alone.m_p[0], enc.m_p[i]) and torch.equal(alone.durations[0], enc.durations[i])
            assert int(f1[0]) == int(frames[i])


@pytest.mark.parametrize("dtype,frames", [(torch.bfloat16, RV.WINDOW_BUDGET),
                                          (torch.float32, RV.WINDOW_BUDGET // 2)])
@pytest.mark.parametrize("bucket", batching.DEFAULT_FRAME_BUCKETS)
def test_flow_graph_rows_fill_the_frame_budget(bucket, dtype, frames, monkeypatch):
    """The frame-window graph (reverse flow and the generator's plain
    stages) holds the most windows of WINDOW_FRAMES + 2 * halo frames
    that stay within WINDOW_BUDGET frames in bf16 and half that in
    float32 (one window when even one exceeds it), whatever the frame
    bucket: a row at `bucket` runs ceil(bucket / WINDOW_FRAMES) windows
    of that one shape. A budget of 0 is a graph per window."""
    span = RV.WINDOW_FRAMES + 2 * M.frame_halo(CFG)
    n = RV.window_rows(CFG, dtype)
    assert n >= 1 and (n == 1 or n * span <= frames) and (n + 1) * span > frames
    assert -(-bucket // RV.WINDOW_FRAMES) * RV.WINDOW_FRAMES >= bucket
    monkeypatch.setattr(RV, "WINDOW_BUDGET", 0)
    assert RV.window_rows(CFG, dtype) == 1


@pytest.mark.parametrize("precision", ["parity", "fast"])
def test_flow_runs_each_row_at_its_own_bucket(params, precision, monkeypatch):
    """Every voice runs a row's reverse flow and the generator's plain
    stages in frame windows, in both precisions: one uniform decode of
    rows in several frame buckets runs only the one window-graph shape
    (window_rows windows of WINDOW_FRAMES + 2 * halo frames), a row's
    windows up to its own length, and a row decoded alone runs the same
    shape and gives the same bits."""
    voice = _voice(params, precision, FRAME_BUCKETS, decode_grouping="uniform")
    span = RV.WINDOW_FRAMES + 2 * M.frame_halo(CFG)
    shapes = []
    step = voice._frames_step

    def spy(m_p, *inputs):  # the window graph's inputs: the latents' and sid
        shapes.append(tuple(m_p.shape[:2]))
        return step(m_p, *inputs)

    monkeypatch.setattr(voice, "_frames_step", spy)
    rows = _rows()
    together = voice.collect(voice.submit(rows, row_seeds=list(range(len(rows)))))
    frames = [len(a) // CFG.upsample_factor for a in together]
    own = [batching.pick_bucket(f, FRAME_BUCKETS) for f in frames]
    assert len(set(own)) >= 2, frames
    k = RV.window_rows(CFG, voice.dtype)
    n_windows = sum(-(-f // RV.WINDOW_FRAMES) for f in frames)
    assert set(shapes) == {(k, span)} and len(shapes) >= -(-n_windows // k)
    for i in (0, len(rows) - 1):
        shapes.clear()
        alone = voice.synthesize_ids_batch([rows[i]], syn=SynthesisConfig(seed=i))[0]
        assert shapes == [(k, span)] * -(-(-(-frames[i] // RV.WINDOW_FRAMES)) // k)
        np.testing.assert_array_equal(together[i], alone)


def test_graph_capture_records_launches_instead_of_counting():
    """recording_launches: the kernels a capture enqueues go into its
    Counter, not the wrappers' counts; outside it, count_launch counts.
    On the CPU a GraphCache runs the function (nothing to capture)."""
    before = V.mrf_fused.launches
    with V.recording_launches() as rec:
        V.count_launch(V.mrf_fused)
        V.count_launch(V.fused_upsample_mrf)
        V.count_launch(V.fused_upsample_mrf)
    assert V.mrf_fused.launches == before
    assert dict(rec) == {V.mrf_fused: 1, V.fused_upsample_mrf: 2}
    V.count_launch(V.mrf_fused)
    assert V.mrf_fused.launches == before + 1
    cache = GraphCache(torch.device("cpu"))
    out = cache.run("k", lambda a, b: (a + b,), (torch.ones(2), torch.ones(2)))
    assert torch.equal(out[0], torch.full((2,), 2.0)) and cache.stats["captures"] == 0


def test_stage_timer_report_has_the_jax_format():
    """The same spans through both StageTimers: the same names, counts
    and keys, totals and means rounded as the JAX module rounds them."""
    ours, theirs = StageTimer(), JaxStageTimer()
    for timer in (ours, theirs):
        for name in ("encode", "decode", "encode", "frames_wait"):
            with timer.span(name):
                pass
    a, b = ours.report(), theirs.report()
    assert list(a) == list(b) == ["decode", "encode", "frames_wait"]
    for name in a:
        assert list(a[name]) == list(b[name]) == ["total_s", "count", "mean_ms"]
        assert a[name]["count"] == b[name]["count"]
        assert a[name]["total_s"] == round(a[name]["total_s"], 4)
        assert a[name]["mean_ms"] == round(a[name]["mean_ms"], 2)
    assert ours.dump().startswith("{\n  \"decode\"")
