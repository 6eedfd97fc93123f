"""The CUDA kernels on the card against their plain versions, over more
shapes than chip_smoke.py's medium voice: resblock "1" and "2", narrow
and odd-sized channel counts, every upsample factor of the presets,
chained phase planes, ragged rows, float32 and bfloat16; and the
wrappers' checks of what they are given.

These tests need an NVIDIA GPU and skip without one. Run them on the
card with

    python -m pytest tests/test_torch_cuda.py -m cuda -q
"""

import pytest
import torch

from piper_tpu_torch.models.vits.generator import _tm_phase_plan
from piper_tpu_torch.ops.cuda import vocoder as V

pytestmark = pytest.mark.cuda

RB = {
    "1": ((3, 7, 11), ((1, 3, 5), (1, 3, 5), (1, 3, 5))),
    "2": ((3, 5, 7), ((1, 2), (2, 6), (3, 12))),
}
# (atol, rtol): float32 differs only in the order of the sums; bfloat16
# rounds at the same points in both, but a sum near a rounding boundary
# may round the other way (2^-8 relative) and the conv chain carries it.
TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (3e-2, 3e-2)}


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    V.build()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _blocks(g, c, rb):
    ks, ds = RB[rb]

    def conv(k):  # unit-gain scale: activations stay O(1) through the chain, as trained ones do
        return {"w": torch.randn((k, c, c), generator=g) / (k * c) ** 0.5,
                "b": torch.randn(c, generator=g) * 0.1}

    if rb == "1":
        return [{"convs1": [conv(k) for _ in d], "convs2": [conv(k) for _ in d]} for k, d in zip(ks, ds)]
    return [{"convs": [conv(k) for _ in d]} for k, d in zip(ks, ds)]


def _close(got, ref, dtype):
    atol, rtol = TOL[dtype]
    torch.testing.assert_close(got.float().cpu(), ref.float().cpu(), atol=atol, rtol=rtol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rb,c,t", [("2", 128, 1000), ("2", 32, 77), ("1", 64, 513), ("1", 12, 300)])
def test_mrf_fused_kernel(dev, rb, c, t, dtype):
    g = torch.Generator().manual_seed(c + t)
    ks, ds = RB[rb]
    w, b = V.pack_stage_weights(_blocks(g, c, rb), ks, ds, rb, dtype=dtype)
    lengths = torch.tensor([t, t - 61, 3], dtype=torch.int32)
    x = torch.randn((3, c, t), generator=g) * (torch.arange(t)[None, None] < lengths[:, None, None])
    args = [a.to(dev) for a in (x.to(dtype), lengths, w, b)]
    kw = dict(kernel_sizes=ks, dilation_sizes=ds, resblock_type=rb)
    before = V.mrf_fused.launches
    got = V.mrf_fused(*args, **kw)
    assert V.mrf_fused.launches == before + 1
    _close(got, V.mrf_fused_plain(*args, **kw), dtype)


def test_mrf_fused_row_alone_equals_row_in_batch(dev):
    """bf16 (the tensor-core body): a row computed alone (another grid,
    another tile) gives the same bits as inside a batch of 3, at the
    medium voice's stage-0 width."""
    g = torch.Generator().manual_seed(13)
    ks, ds = RB["2"]
    t = 1511
    w, b = V.pack_stage_weights(_blocks(g, 128, "2"), ks, ds, "2", dtype=torch.bfloat16)
    lengths = torch.tensor([t, 1203, 40], dtype=torch.int32)
    x = torch.randn((3, 128, t), generator=g) * (torch.arange(t)[None, None] < lengths[:, None, None])
    x, lengths, w, b = x.to(dev, torch.bfloat16), lengths.to(dev), w.to(dev), b.to(dev)
    kw = dict(kernel_sizes=ks, dilation_sizes=ds, resblock_type="2")
    batch = V.mrf_fused(x, lengths, w, b, **kw)
    alone = V.mrf_fused(x[1:2, :, :1203].contiguous(), lengths[1:2].contiguous(), w, b, **kw)
    assert torch.equal(alone[0], batch[1, :, :1203])
    assert not batch[1, :, 1203:].any() and not batch[2, :, 40:].any()


def _stage(g, u, k, c_in, c_out, rb, dtype, dev):
    q0, used, idx = _tm_phase_plan(k, u)
    kern = torch.randn((k, c_in, c_out), generator=g) * 0.1
    wt = torch.zeros((u, used.shape[1], c_in, c_out))
    for p in range(u):
        for qi in range(used.shape[1]):
            if used[p, qi]:
                wt[p, qi] = kern[int(idx[p, qi])]
    ks, ds = RB[rb]
    wm, bm = V.pack_stage_weights(_blocks(g, c_out, rb), ks, ds, rb, dtype=dtype)
    return dict(
        wt=wt.to(dev, dtype), bt=(torch.randn(c_out, generator=g) * 0.1).to(dev), wm=wm.to(dev),
        bm=bm.to(dev), wpost=(torch.randn((7, c_out, 1), generator=g) * 0.3).to(dev, dtype),
        kw=dict(u=u, q0=q0, kernel_sizes=ks, dilation_sizes=ds, resblock_type=rb),
    )


def _run(fn, s, x, lengths, u_in, post):
    return fn(x, lengths, s["wt"], s["bt"], s["wm"], s["bm"], s["wpost"] if post else None,
              u_in=u_in, post=post, **s["kw"])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "u,k,c_in,c_out,rb,post",
    [(8, 16, 128, 64, "2", False), (4, 8, 64, 32, "2", True), (2, 4, 32, 16, "1", True),
     (8, 16, 48, 24, "1", False), (4, 8, 20, 12, "2", True)],
)
def test_fused_upsample_mrf_kernel(dev, u, k, c_in, c_out, rb, post, dtype):
    g = torch.Generator().manual_seed(u * 100 + c_in)
    v = 203
    s = _stage(g, u, k, c_in, c_out, rb, dtype, dev)
    lengths = torch.tensor([v * u, (v - 9) * u - 3, 5], dtype=torch.int32)
    x = torch.randn((3, c_in, v), generator=g) * (torch.arange(v)[None, None] < (lengths // u)[:, None, None])
    x, lengths = x.to(dev, dtype), lengths.to(dev)
    before = V.fused_upsample_mrf.launches
    got = _run(V.fused_upsample_mrf, s, x, lengths, 1, post)
    assert V.fused_upsample_mrf.launches == before + 1
    _close(got, _run(V.fused_upsample_mrf_plain, s, x, lengths, 1, post), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rb", ["1", "2"])
def test_fused_stage_chain_kernel(dev, rb, dtype):
    """u=8 -> phase planes -> u=4 with u_in=8 and conv_post."""
    g = torch.Generator().manual_seed(7)
    v = 131
    frames = torch.tensor([131, 70, 2], dtype=torch.int32)
    s1 = _stage(g, 8, 16, 64, 32, rb, dtype, dev)
    s2 = _stage(g, 4, 8, 32, 16, rb, dtype, dev)
    x = torch.randn((3, 64, v), generator=g) * (torch.arange(v)[None, None] < frames[:, None, None])
    x, frames = x.to(dev, dtype), frames.to(dev)
    outs = []
    for fn in (V.fused_upsample_mrf, V.fused_upsample_mrf_plain):
        y = _run(fn, s1, x, frames * 8, 1, False)
        outs.append(_run(fn, s2, y, frames * 32, 8, True))
    _close(outs[0], outs[1], dtype)


def _planes(g, b, rows, v, frames):
    """Random stage input, zero past each row's frames (as stage outputs are)."""
    return torch.randn((b, rows, v), generator=g) * (torch.arange(v)[None, None] < frames[:, None, None])


@pytest.mark.parametrize("stage", [1, 2])
def test_fused_upsample_mrf_medium_bf16(dev, stage):
    """The medium voice's full stage widths in bf16 (the tensor-core body):
    128 -> 64 with u=8, or 64 -> 32 with u=4, u_in=8 and conv_post; ragged
    frame counts, none a multiple of a tile."""
    g = torch.Generator().manual_seed(40 + stage)
    v = 419
    frames = torch.tensor([419, 382, 7], dtype=torch.int32)
    if stage == 1:
        s, u_in, post, lengths = _stage(g, 8, 16, 128, 64, "2", torch.bfloat16, dev), 1, False, frames * 8
        x = _planes(g, 3, 128, v, frames)
    else:
        s, u_in, post, lengths = _stage(g, 4, 8, 64, 32, "2", torch.bfloat16, dev), 8, True, frames * 32
        x = _planes(g, 3, 8 * 64, v, frames)
    x, lengths = x.to(dev, torch.bfloat16), lengths.to(dev)
    got = _run(V.fused_upsample_mrf, s, x, lengths, u_in, post)
    _close(got, _run(V.fused_upsample_mrf_plain, s, x, lengths, u_in, post), torch.bfloat16)


def test_fused_upsample_mrf_row_alone_equals_row_in_batch(dev):
    """bf16: a row computed alone (other tiles, other grid) gives the same
    bits as inside a batch of 3, through both chained stages."""
    g = torch.Generator().manual_seed(9)
    v = 157
    frames = torch.tensor([157, 101, 12], dtype=torch.int32)
    s1 = _stage(g, 8, 16, 128, 64, "2", torch.bfloat16, dev)
    s2 = _stage(g, 4, 8, 64, 32, "2", torch.bfloat16, dev)
    x = _planes(g, 3, 128, v, frames).to(dev, torch.bfloat16)
    frames = frames.to(dev)

    def both(x, fr):
        y = _run(V.fused_upsample_mrf, s1, x, fr * 8, 1, False)
        return _run(V.fused_upsample_mrf, s2, y, fr * 32, 8, True)

    batch = both(x, frames)
    alone = both(x[1:2].contiguous(), frames[1:2].contiguous())
    assert torch.equal(alone[0], batch[1])


def _f32_medium(g, dev, t, lengths):
    """Stage 0 of the medium voice (C=128, resblock "2") and stages 1-2 in
    float32, with rows of these lengths (positions at stage 0)."""
    ks, ds = RB["2"]
    w, b = V.pack_stage_weights(_blocks(g, 128, "2"), ks, ds, "2")
    x = torch.randn((len(lengths), 128, t), generator=g) * (torch.arange(t)[None, None] < lengths[:, None, None])
    s1 = _stage(g, 8, 16, 128, 64, "2", torch.float32, dev)
    s2 = _stage(g, 4, 8, 64, 32, "2", torch.float32, dev)
    kw = dict(kernel_sizes=ks, dilation_sizes=ds, resblock_type="2")

    def run(x, lengths):
        x0 = V.mrf_fused(x, lengths, w.to(dev), b.to(dev), **kw)
        y = _run(V.fused_upsample_mrf, s1, x0.contiguous(), lengths * 8, 1, False)
        return x0, _run(V.fused_upsample_mrf, s2, y, lengths * 32, 8, True)

    return x.to(dev), lengths.to(dev), run


def test_float32_row_alone_equals_row_in_batch(dev):
    """float32 (3xTF32): a row computed alone (another grid, other tiles)
    gives the same bits as inside a batch of 3, through mrf_fused at the
    medium voice's stage-0 width and both fused stages after it: each
    output element sums in one fixed order (taps, 8-channel units, then
    the three products)."""
    g = torch.Generator().manual_seed(21)
    x, lengths, run = _f32_medium(g, dev, 1211, torch.tensor([1211, 803, 40], dtype=torch.int32))
    x0, wave = run(x, lengths)
    a0, awave = run(x[1:2, :, :803].contiguous(), lengths[1:2].contiguous())
    assert torch.equal(a0[0], x0[1, :, :803])
    assert torch.equal(awave[0], wave[1, :, :803])


def test_float32_kernels_are_deterministic(dev):
    """float32: the same inputs twice give the same bits in both kernels
    (no atomics, one sum order)."""
    g = torch.Generator().manual_seed(22)
    x, lengths, run = _f32_medium(g, dev, 517, torch.tensor([517, 333, 9], dtype=torch.int32))
    first, again = run(x, lengths), run(x, lengths)
    assert all(torch.equal(a, b) for a, b in zip(first, again))


def test_float32_tiles_past_a_row_end_give_zeros(dev):
    """float32: beside a row of 1511 positions, a row of 5: the blocks
    whose tiles start past its end return at once and write zeros, in
    both kernels, and that row's bits are those of the row alone."""
    g = torch.Generator().manual_seed(23)
    x, lengths, run = _f32_medium(g, dev, 1511, torch.tensor([1511, 5], dtype=torch.int32))
    x0, wave = run(x, lengths)
    assert not x0[1, :, 5:].any() and not wave[1, :, 5:].any()
    assert x0[1, :, :5].any() and wave[1, :, :5].any()
    a0, awave = run(x[1:2, :, :5].contiguous(), lengths[1:2].contiguous())
    assert torch.equal(a0[0], x0[1, :, :5]) and torch.equal(awave[0], wave[1, :, :5])


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    ks, ds = RB["2"]
    g = torch.Generator().manual_seed(0)
    w, b = V.pack_stage_weights(_blocks(g, 32, "2"), ks, ds, "2")
    w, b = w.to(dev), b.to(dev)
    x = torch.zeros((2, 32, 50), device=dev)
    lengths = torch.tensor([50, 10], dtype=torch.int32, device=dev)
    kw = dict(kernel_sizes=ks, dilation_sizes=ds, resblock_type="2")
    with pytest.raises(TypeError):
        V.mrf_fused(x.half(), lengths, w.half(), b, **kw)
    with pytest.raises(ValueError, match="contiguous"):
        V.mrf_fused(x.transpose(1, 2).contiguous().transpose(1, 2), lengths, w, b, **kw)
    with pytest.raises(TypeError):
        V.mrf_fused(x, lengths.long(), w, b, **kw)
    with pytest.raises(ValueError, match="is on"):
        V.mrf_fused(x, lengths.cpu(), w, b, **kw)
    with pytest.raises(ValueError, match="stage plan"):
        V.mrf_fused(x, lengths, w[:4], b[:4], **kw)
    # bf16 weights off a 16-byte boundary: the kernel reads its own layout
    # of them (on 16 bytes, as its bulk copies need), which the wrapper
    # checks; one off a boundary is refused
    wb = torch.zeros(w.numel() + 1, dtype=torch.bfloat16, device=dev)[1:].view(w.shape)
    wb.copy_(w)
    with pytest.raises(ValueError, match="16-byte"):
        V._check_bulk(V.tc_weight_layout(wb).view(-1)[1:], (16,), "mrf_fused")
    x = torch.randn((2, 32, 50), generator=g).to(dev)
    xb = x.bfloat16()
    assert torch.equal(V.mrf_fused(xb, lengths, wb, b, **kw), V.mrf_fused(xb, lengths, w.bfloat16(), b, **kw))
    assert torch.equal(V.mrf_fused(x, lengths, w, b, **kw), V.mrf_fused(x, lengths, w, b, **kw))
    xb = x.bfloat16()
    assert torch.equal(V.mrf_fused(xb, lengths, w.bfloat16(), b, **kw), V.mrf_fused(xb, lengths, w.bfloat16(), b, **kw))


# ---------------------------------------------------------------------------
# The serving slice on the card: streaming, submit/collect, warm-up
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def medium(dev):
    """A random-weight medium voice (full width, text phonemes)."""
    from piper_tpu_torch.config import ModelConfig
    from piper_tpu_torch.models.vits.model import init_synthesizer_params
    from piper_tpu_torch.runtime.voice import random_voice_config

    cfg = ModelConfig.for_quality("medium", num_symbols=256)
    return cfg, init_synthesizer_params(1, cfg), random_voice_config(cfg)


def _medium_voice(medium, precision, device="cuda"):
    from piper_tpu_torch.runtime.voice import TorchVoice

    cfg, params, vcfg = medium
    return TorchVoice(params, cfg, vcfg, precision=precision, device=device, seed=0)


def _long_ids(n=90):
    g = torch.Generator().manual_seed(n)
    return [1, 0] + [int(x) for s in torch.randint(3, 256, (n,), generator=g) for x in (s, 0)] + [2]


def test_streaming_on_card_matches_cpu(medium):
    """Parity precision: the same seeded utterance streamed on the card
    and on the CPU, chunk by chunk (atol 1e-3: float32 sums in another
    order through the flows and the conv stack, as chip_smoke.py's card
    vs CPU check)."""
    from piper_tpu_torch.config import SynthesisConfig
    from piper_tpu_torch.runtime.streaming import synthesize_stream_chunks

    ids, syn = _long_ids(), SynthesisConfig(seed=3)
    got = list(synthesize_stream_chunks(_medium_voice(medium, "parity"), ids, syn=syn))
    ref = list(synthesize_stream_chunks(_medium_voice(medium, "parity", "cpu"), ids, syn=syn))
    assert len(got) >= 3 and [len(c) for c in got] == [len(c) for c in ref]
    for g, r in zip(got, ref):
        torch.testing.assert_close(torch.from_numpy(g), torch.from_numpy(r), atol=1e-3, rtol=0)


@pytest.mark.parametrize("precision", ["parity", "fast"])
def test_one_frame_final_chunk_on_card(medium, precision):
    """136 frames stream as 45, 45, 45 and a final chunk of 1 frame (11
    valid frames of the 65-frame window with its left context), each
    chunk one replay of the chunk graph, which holds mrf_fused once and
    fused_upsample_mrf twice; a replayed stream gives the bytes of the
    stream that captured the graph; the chunks agree with one whole
    decode within the seam bounds of the JAX package's streaming test."""
    from piper_tpu_torch.models.vits import model as M
    from piper_tpu_torch.runtime.streaming import StreamingDecoder

    voice = _medium_voice(medium, precision)
    cfg = voice.model_cfg
    u = cfg.upsample_factor
    g = torch.Generator().manual_seed(4)
    z_p = torch.randn((1, 136, cfg.inter_channels), generator=g).to(voice.device, voice.dtype)
    first = list(StreamingDecoder(voice).stream(z_p, 136))  # captures the chunk graph
    n0, n1 = V.mrf_fused.launches, V.fused_upsample_mrf.launches
    chunks = list(StreamingDecoder(voice).stream(z_p, 136))
    assert (V.mrf_fused.launches - n0, V.fused_upsample_mrf.launches - n1) == (4, 8)
    assert [len(c) // u for c in chunks] == [45, 45, 45, 1]
    assert all(a.tobytes() == b.tobytes() for a, b in zip(first, chunks))
    with torch.inference_mode():
        mask = torch.ones((1, 136, 1), device=z_p.device, dtype=z_p.dtype)
        whole = M.synthesizer_vocode(voice.params, z_p, mask, cfg=cfg)[0].float().cpu()
    streamed = torch.cat([torch.from_numpy(c) for c in chunks])
    assert torch.isfinite(streamed).all()
    err = (streamed - whole).abs()
    assert torch.quantile(err, 0.99) < 5e-3 and err.mean() < 1e-3


def test_collect_on_another_thread(medium):
    """fast: submit on this thread, collect on another (waiting on the
    copy's event) gives synthesize_ids_batch's samples."""
    import threading

    import numpy as np

    from piper_tpu_torch.config import SynthesisConfig

    voice = _medium_voice(medium, "fast")
    rows = [_long_ids(n) for n in (40, 25, 60)]
    want = voice.synthesize_ids_batch(rows, syn=SynthesisConfig(seed=9))
    handle = voice.submit(rows, syn=SynthesisConfig(seed=9))
    assert handle["host"].is_pinned()
    got = []
    t = threading.Thread(target=lambda: got.extend(voice.collect(handle)))
    t.start()
    t.join(timeout=300)
    assert len(got) == 3
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_request_racing_background_warmup_builds_once(medium, monkeypatch):
    """A request that races the background warm-up waits for the kernels'
    build (one nvcc per source) instead of starting a second one."""
    import collections
    import threading

    from piper_tpu_torch.config import SynthesisConfig

    calls = collections.Counter()
    compile_ = V._compile

    def counting_compile(name):
        calls[name] += 1
        return compile_(name)

    monkeypatch.setattr(V, "_compile", counting_compile)
    monkeypatch.setattr(V, "_libs", {})
    voice = _medium_voice(medium, "fast")
    warm = threading.Thread(target=voice.warmup, args=((1, 4),), kwargs=dict(full=True))
    warm.start()
    out = voice.synthesize_ids_batch([_long_ids(30)], syn=SynthesisConfig(seed=1))
    warm.join(timeout=600)
    assert not warm.is_alive() and len(out[0]) > 0
    assert calls == {"mrf_fused": 1, "fused_upsample_mrf": 1}


@pytest.mark.parametrize("precision", ["fast", "parity"])
@pytest.mark.parametrize("quality", ["x-low", "low", "medium", "high"])
def test_coalesced_rows_equal_solo_rows_on_card(dev, quality, precision):
    """What the batcher relies on: 16 rows (the batcher's max_batch) of
    several phoneme buckets and lengths (past 256 frames, so a bfloat16
    count would round), each with its own seed, in one submit give each
    row's solo audio bit for bit, in both precisions. On every preset's
    stage split: x-low, low and medium run stage 0's transposed conv row
    by row before mrf_fused; high runs its two wide cuDNN stages row by
    row. Encodes run at one row count (ENCODE_ROWS): over a batch of
    another size the text encoder moved a row by up to 4e-6 in float32
    and 3e-2 in bf16; conv_pre runs row by row: over the batch it moved
    an x-low and a high row by 1.6e-2 in bf16 (python
    tools/row_invariance.py)."""
    import numpy as np

    from piper_tpu_torch.config import ModelConfig, SynthesisConfig
    from piper_tpu_torch.models.vits.model import init_synthesizer_params
    from piper_tpu_torch.runtime.voice import TorchVoice, random_voice_config

    cfg = ModelConfig.for_quality(quality, num_symbols=256)
    voice = TorchVoice(init_synthesizer_params(2, cfg), cfg, random_voice_config(cfg),
                       precision=precision, device="cuda", seed=0)
    rows = [_long_ids(n) for n in (5, 23, 40, 61, 90, 120, 14, 77, 33, 8, 101, 47, 66, 19, 130, 55)]
    seeds = [3, 2**40 + 7, -5, 11, 0, 2**32 - 1, 8, 13, 21, 34, 55, 89, 144, 233, 377, 610]
    together = voice.collect(voice.submit(rows, row_seeds=seeds))
    frames = [len(a) // cfg.upsample_factor for a in together]
    assert max(frames) > 256, frames
    for i, (row, seed) in enumerate(zip(rows, seeds)):
        alone = voice.synthesize_ids_batch([row], syn=SynthesisConfig(seed=seed))[0]
        np.testing.assert_array_equal(together[i], alone, err_msg=f"row {i} ({frames[i]} frames)")


@pytest.mark.parametrize("precision", ["fast", "parity"])
def test_graph_replay_equals_eager_on_card(medium, precision):
    """Each graph kind, replayed with new inputs, gives the bits of its
    function run eagerly on the same inputs at the same shape: the
    encode graph (two phoneme buckets, 3 rows padded to 4), the
    frame-window graph of each decode, and the streamed chunk's graph (a
    full window and a short one)."""
    from piper_tpu_torch.config import SynthesisConfig
    from piper_tpu_torch.runtime.streaming import StreamingDecoder

    voice = _medium_voice(medium, precision)
    calls = []
    run = voice.graphs.run

    def spying_run(key, fn, inputs):
        out = run(key, fn, inputs)
        calls.append((key, fn, [None if x is None else x.to(voice.device) for x in inputs], out))
        return out

    voice.graphs.run = spying_run
    rows = [_long_ids(n) for n in (10, 12, 14)] + [_long_ids(n) for n in (40, 45, 50)]
    for seed in (1, 2):  # the first call captures, the second replays
        voice.synthesize_ids_batch(rows, syn=SynthesisConfig(seed=seed))
    g = torch.Generator().manual_seed(2)
    z_p = torch.randn((1, 120, voice.model_cfg.inter_channels), generator=g).to("cuda", voice.dtype)
    for _ in range(2):
        list(StreamingDecoder(voice).stream(z_p, 120))
    kinds = {key[0] for key, *_ in calls}
    assert kinds == {"encode", "frames", "chunk"}, kinds
    seen, replays = set(), []
    for call in calls:
        if call[0] in seen:
            replays.append(call)
        seen.add(call[0])
    assert len(replays) >= 4
    with torch.inference_mode():
        for key, fn, inputs, out in replays:
            eager = fn(*inputs)
            assert len(eager) == len(out)
            for e, o in zip(eager, out):
                assert torch.equal(e, o), key


def test_two_threads_replay_the_chunk_graph_at_once(medium):
    """Two streams at once through one chunk graph (the cache's lock
    from the copy into its inputs to the clone of its outputs): each
    gets the bytes it gets alone."""
    import threading

    from piper_tpu_torch.runtime.streaming import StreamingDecoder

    voice = _medium_voice(medium, "fast")
    g = torch.Generator().manual_seed(3)
    zs = [torch.randn((1, n, voice.model_cfg.inter_channels), generator=g).to("cuda", voice.dtype)
          for n in (400, 371)]
    alone = [[c.tobytes() for c in StreamingDecoder(voice).stream(z, z.shape[1])] for z in zs]
    got = [None, None]
    barrier = threading.Barrier(2)

    def stream(i):
        barrier.wait()
        got[i] = [c.tobytes() for c in StreamingDecoder(voice).stream(zs[i], zs[i].shape[1])]

    threads = [threading.Thread(target=stream, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    assert got == alone
    assert voice.graphs.stats["captures"] == 1


def test_streams_and_coalesced_batches_at_once_on_card(medium):
    """The graphs share one memory pool, so one graph's replay may
    overwrite another's outputs before they are cloned. Streams on three
    threads (encode and chunk graph replays) while a fourth submits a
    batch of several phoneme buckets (encode and flow graph replays),
    each over and over: every stream and every batch gets the bytes it
    gets alone."""
    import threading

    from piper_tpu_torch.config import SynthesisConfig
    from piper_tpu_torch.runtime.streaming import synthesize_stream_chunks

    voice = _medium_voice(medium, "fast")
    stream_ids = [_long_ids(n) for n in (30, 45, 60)]
    batch = [_long_ids(n) for n in (5, 23, 40, 61, 90, 14)]

    def run_stream(ids):
        return [c.tobytes() for c in synthesize_stream_chunks(voice, ids, syn=SynthesisConfig(seed=4))]

    def run_batch():
        return [a.tobytes() for a in voice.collect(voice.submit(batch, row_seeds=list(range(len(batch)))))]

    for _ in range(2):  # a key's second call captures its graph
        alone_streams = [run_stream(ids) for ids in stream_ids]
        alone_batch = run_batch()
    def shape_graphs():  # a plan graph (dispatch fusion) may be captured meanwhile
        return {k for k in voice.graphs.capture_seconds if k[0] != "plan"}

    shapes = shape_graphs()
    got_streams, got_batches = [[] for _ in stream_ids], []
    barrier = threading.Barrier(len(stream_ids) + 1)

    def streamer(i):
        barrier.wait()
        for _ in range(6):
            got_streams[i].append(run_stream(stream_ids[i]))

    def batcher():
        barrier.wait()
        for _ in range(6):
            got_batches.append(run_batch())

    threads = [threading.Thread(target=streamer, args=(i,)) for i in range(len(stream_ids))]
    threads.append(threading.Thread(target=batcher))
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    assert not any(t.is_alive() for t in threads)
    assert shape_graphs() == shapes
    assert [len(s) for s in got_streams] == [6] * len(stream_ids) and len(got_batches) == 6
    for i, runs in enumerate(got_streams):
        assert all(r == alone_streams[i] for r in runs), i
    assert all(b == alone_batch for b in got_batches)


@pytest.fixture(scope="module")
def medium_files(medium, tmp_path_factory):
    """The medium voice as .npz, as .onnx written by the JAX package's
    exporter (numpy only: piper_tpu.onnx_io imports no JAX) and as a
    Lightning .ckpt from the port's state_dict_from_params, each with the
    same JSON sidecar."""
    import dataclasses
    import json

    from piper_tpu.config import ModelConfig as JModelConfig
    from piper_tpu.onnx_io import export_onnx_voice
    from piper_tpu_torch.weights.native import save_native
    from piper_tpu_torch.weights.torch_export import state_dict_from_params

    cfg, params, vcfg = medium
    d = tmp_path_factory.mktemp("medium_files")
    save_native(str(d / "voice.npz"), params, cfg)
    export_onnx_voice(params, JModelConfig.for_quality("medium", num_symbols=256), str(d / "voice.onnx"))
    hp = {k: v for k, v in dataclasses.asdict(cfg).items() if k != "audio"}
    torch.save({"state_dict": {"model_g." + k: torch.from_numpy(v)
                               for k, v in state_dict_from_params(params, cfg).items()},
                "hyper_parameters": hp}, d / "voice.ckpt")
    for ext in ("npz", "onnx", "ckpt"):
        (d / f"voice.{ext}.json").write_text(json.dumps(vcfg.to_dict()))
    return d


@pytest.mark.parametrize("precision", ["fast", "parity"])
@pytest.mark.parametrize("fmt", ["onnx", "ckpt"])
def test_loaded_voice_gives_the_npz_bytes_on_card(medium_files, fmt, precision):
    """A medium voice loaded from .onnx (the JAX package's export) or
    .ckpt on the card gives the bytes of the same weights loaded from
    .npz: the loaders change nothing after the weights are read, and the
    decodes run through both kernels."""
    from piper_tpu_torch.config import SynthesisConfig
    from piper_tpu_torch.runtime.voice import TorchVoice

    rows = [_long_ids(n) for n in (12, 60, 130)]
    out = {}
    for ext in ("npz", fmt):
        voice = TorchVoice.load(medium_files / f"voice.{ext}", precision=precision, seed=0)
        n0 = V.mrf_fused.launches
        out[ext] = [a.tobytes() for a in voice.synthesize_ids_batch(rows, syn=SynthesisConfig(seed=6))]
        assert V.mrf_fused.launches > n0
    assert all(len(a) > 0 for a in out["npz"]) and out[fmt] == out["npz"]


@pytest.mark.parametrize("precision", ["fast", "parity"])
def test_coalesced_speaker_rows_equal_solo_rows_on_card(dev, precision):
    """The trained two-speaker x-low voice: 16 rows of one speaker in one
    submit give each row's solo audio bit for bit, for either speaker, in
    both precisions. The flow runs each row at its own frame bucket in
    graphs of one row count per bucket: over a decode's rows at the
    decode's bucket, a trained voice's parity rows moved by up to 3.3e-6
    against the row alone
    (tools/row_invariance.py --voice; chip_smoke.py's two-speaker window
    had 4 and 17 of 64 parity responses equal to the request alone)."""
    from pathlib import Path

    import numpy as np

    from piper_tpu_torch.config import SynthesisConfig
    from piper_tpu_torch.runtime.voice import TorchVoice, random_voice_config
    from piper_tpu_torch.weights.native import load_native

    tree, cfg = load_native(str(Path(__file__).parent / "data" / "voice_xlow_ms2_trained_fp16.npz"))
    voice = TorchVoice(tree, cfg, random_voice_config(cfg), precision=precision, device="cuda", seed=0)
    g = torch.Generator().manual_seed(7)
    rows = [[1, 0] + [int(x) for s in torch.randint(3, cfg.num_symbols, (n,), generator=g) for x in (s, 0)]
            + [2] for n in (5, 23, 40, 61, 90, 12, 14, 77, 33, 8, 101, 47, 66, 19, 30, 55)]
    seeds = list(range(16))
    outs = {}
    for spk in (0, 1):
        together = voice.collect(voice.submit(rows, syn=SynthesisConfig(speaker_id=spk), row_seeds=seeds))
        for i, (row, seed) in enumerate(zip(rows, seeds)):
            alone = voice.synthesize_ids_batch([row], syn=SynthesisConfig(seed=seed, speaker_id=spk))[0]
            np.testing.assert_array_equal(together[i], alone, err_msg=f"speaker {spk}, row {i}")
        outs[spk] = together
    assert any(len(a) != len(b) or not np.array_equal(a, b) for a, b in zip(outs[0], outs[1]))


def _variant_voice(variant, precision):
    """A random medium voice of `variant` on the card: "vits2" with two
    speakers (flow_transformer, speaker_cond_encoder) or "vits", their
    flows' `post` perturbed (zero-initialised, it would make the flow the
    identity), or "mb_istft"."""
    import numpy as np

    from piper_tpu_torch.config import ModelConfig
    from piper_tpu_torch.models.vits.model import init_synthesizer_params
    from piper_tpu_torch.runtime.voice import TorchVoice, random_voice_config

    if variant == "vits2":
        cfg = ModelConfig.vits2("medium", num_symbols=256, num_speakers=2)
    elif variant == "vits":
        cfg = ModelConfig.for_quality("medium", num_symbols=256)
    else:
        cfg = ModelConfig.mb_istft("medium", num_symbols=256)
    params = init_synthesizer_params(2, cfg)
    rng = np.random.default_rng(3)
    for layer in params["flow"]["layers"] if variant != "mb_istft" else []:
        layer["post"] = {k: (v + 0.02 * rng.standard_normal(v.shape)).astype(np.float32)
                         for k, v in layer["post"].items()}
    return TorchVoice(params, cfg, random_voice_config(cfg), precision=precision, device="cuda", seed=0)


@pytest.mark.parametrize("precision", ["fast", "parity"])
@pytest.mark.parametrize("variant", ["vits2", "mb_istft"])
def test_coalesced_variant_rows_equal_solo_rows_on_card(dev, variant, precision):
    """16 rows of several phoneme buckets and lengths in one submit give
    each row's solo audio bit for bit, on the medium VITS2 voice (speaker
    1: the flow's attention and the speaker-conditioned encoder) and the
    medium MB-iSTFT voice (its generator row by row at each row's
    length), in both precisions. The flow and the generator's plain
    stages run in frame windows of one graph shape: over a decode's rows
    a bf16 row moved by one step (tools/row_invariance.py --voice).
    VITS2 also counts one mrf_fused and two fused_upsample_mrf launches
    per decode, MB-iSTFT none."""
    import numpy as np

    from piper_tpu_torch.config import SynthesisConfig

    voice = _variant_voice(variant, precision)
    spk = 1 if variant == "vits2" else None
    rows = [_long_ids(n) for n in (5, 23, 40, 61, 90, 120, 14, 77, 33, 8, 101, 47, 66, 19, 130, 55)]
    seeds = list(range(16))
    V.mrf_fused.launches = V.fused_upsample_mrf.launches = 0
    handle = voice.submit(rows, syn=SynthesisConfig(speaker_id=spk), row_seeds=seeds)
    per = 1 if variant == "vits2" else 0
    assert (V.mrf_fused.launches, V.fused_upsample_mrf.launches) == (per * handle["decodes"],
                                                                   2 * per * handle["decodes"])
    together = voice.collect(handle)
    frames = [len(a) // voice.model_cfg.upsample_factor for a in together]
    assert max(frames) > 256, frames
    for i, (row, seed) in enumerate(zip(rows, seeds)):
        alone = voice.synthesize_ids_batch([row], syn=SynthesisConfig(seed=seed, speaker_id=spk))[0]
        np.testing.assert_array_equal(together[i], alone, err_msg=f"row {i} ({frames[i]} frames)")


@pytest.mark.parametrize("precision", ["fast", "parity"])
def test_coalesced_rows_of_a_perturbed_vits_flow_equal_solo_rows_on_card(dev, precision):
    """The medium VITS voice with its flows' `post` perturbed (random
    weights make the flow the identity, which hid that one bf16 row moved
    by one step in a flow over a decode's rows): 16 rows in one submit
    give each row's solo audio bit for bit, in both precisions, since the
    flow runs in frame windows of one graph shape."""
    import numpy as np

    from piper_tpu_torch.config import SynthesisConfig

    voice = _variant_voice("vits", precision)
    rows = [_long_ids(n) for n in (5, 23, 40, 61, 90, 120, 14, 77, 33, 8, 101, 47, 66, 19, 130, 55)]
    seeds = list(range(16))
    together = voice.collect(voice.submit(rows, row_seeds=seeds))
    for i, (row, seed) in enumerate(zip(rows, seeds)):
        alone = voice.synthesize_ids_batch([row], syn=SynthesisConfig(seed=seed))[0]
        np.testing.assert_array_equal(together[i], alone, err_msg=f"row {i}")


def _speculative_at(voice, row, fbucket, syn, prev):
    """Submit `row` alone with the estimator set so that its estimated
    frame bucket is `fbucket` (prev: the bucket below it); returns the
    handle and the audio."""
    target = (prev + fbucket) // 2
    ru = (target - 4) / len(row)
    voice._ratio = (ru, ru)
    handle = voice.submit([row], syn=syn)
    assert handle.get("spec") is not None, "no speculative path: every decode reads its frame counts"
    return handle, voice.collect(handle)[0]


@pytest.mark.parametrize("variant", ["vits", "vits2", "mb_istft"])
def test_rows_keep_their_bits_at_every_larger_frame_bucket_on_card(dev, variant):
    """ROADMAP fault 17: a row decoded at any frame bucket above its own
    (the speculative path's estimate, no frame count on the host) gives
    the bits of its exact decode, fast precision, on the medium VITS
    voice with its flows' post perturbed, the medium VITS2 voice (speaker
    1) and the medium MB-iSTFT voice. On the card cuBLAS and cuDNN pick
    their algorithms by shape, and at the row's own bucket the reverse
    flow, conv_pre, the wide NWC stages and the polyphase product moved
    rows at larger buckets (tools/row_invariance.py --buckets); the
    decode now runs them in frame windows of one shape."""
    import numpy as np

    from piper_tpu_torch.config import SynthesisConfig

    voice = _variant_voice(variant, "fast")
    syn = SynthesisConfig(seed=5, speaker_id=1 if variant == "vits2" else None)
    ladder = [b for b in voice.frame_buckets if b <= 2192]
    for n in (30, 90):
        row = _long_ids(n)
        exact = voice.synthesize_ids_batch([row], syn=syn)[0]
        frames = len(exact) // voice.model_cfg.upsample_factor
        own = min(b for b in ladder if b >= frames)
        tried = 0
        for prev, fbucket in zip(ladder, ladder[1:]):
            if prev < own:
                continue
            handle, got = _speculative_at(voice, row, fbucket, syn, prev)
            assert handle["spec"]["rows"][0][1] == fbucket * voice.model_cfg.upsample_factor
            np.testing.assert_array_equal(got, exact, err_msg=f"{frames} frames at bucket {fbucket}")
            tried += 1
        assert tried >= 3


@pytest.mark.parametrize("wire", ["int16", "mulaw"])
def test_speculative_batch_equals_exact_batch_on_card(dev, wire):
    """16 rows of several phoneme buckets on the medium VITS voice (post
    perturbed), fast precision: the first batch takes the exact path and
    calibrates the estimator, the same rows again take the speculative
    path with no frames_wait span and give the exact batch's audio bit
    for bit, with one mrf_fused and two fused_upsample_mrf launches per
    decode and re-decode, on either wire."""
    import numpy as np

    from piper_tpu_torch.config import SynthesisConfig
    from piper_tpu_torch.runtime.profiling import StageTimer

    voice = _variant_voice("vits", "fast")
    voice.set_wire_format(wire)
    rows = [_long_ids(n) for n in (5, 23, 40, 61, 90, 120, 14, 77, 33, 8, 101, 47, 66, 19, 130, 55)]
    seeds = list(range(16))
    exact = voice.collect(voice.submit(rows, syn=SynthesisConfig(), row_seeds=seeds))
    voice.timer = StageTimer()
    V.mrf_fused.launches = V.fused_upsample_mrf.launches = 0
    handle = voice.submit(rows, syn=SynthesisConfig(), row_seeds=seeds)
    spec = voice.collect(handle)
    assert "spec" in handle and voice.path_counts["speculative"] == 1
    assert voice.timer.counts.get("frames_wait", 0) == 0
    assert (V.mrf_fused.launches, V.fused_upsample_mrf.launches) == (handle["decodes"],
                                                                   2 * handle["decodes"])
    for i, (a, b) in enumerate(zip(exact, spec)):
        np.testing.assert_array_equal(a, b, err_msg=f"row {i}")


@pytest.mark.parametrize("wire", ["int16", "mulaw"])
@pytest.mark.parametrize("variant", ["vits", "vits2", "mb_istft"])
def test_fused_plan_replays_give_the_per_decode_bits_on_card(dev, variant, wire):
    """Dispatch fusion on the card, fast precision, medium voices (flow
    post perturbed; VITS2 speaker 1): 12 rows of several phoneme
    buckets, an exact batch, then speculative batches of the same rows
    with the estimate pinned, so that the plan recurs: seed sets 0 and 1
    on the per-decode path, then seed set 2, whose batch captures the
    plan's graph (it records one mrf_fused and two fused_upsample_mrf
    launches per decode, none for MB-iSTFT) and replays it. Each seed set
    then replays it after batches of other rows (other plans) have
    recycled the pinned host blocks of the earlier uploads: a stale
    upload read at replay would give the wrong seeds' audio. Every replay
    counts `fused` and adds its graph's launches, and gives its seed
    set's per-decode audio bit for bit."""
    import numpy as np

    from piper_tpu_torch.config import SynthesisConfig
    from piper_tpu_torch.ops.cuda import vocoder as V

    voice = _variant_voice(variant, "fast")
    voice.set_wire_format(wire)
    syn = SynthesisConfig(speaker_id=1 if variant == "vits2" else None)
    rows = [_long_ids(n) for n in (5, 23, 40, 61, 90, 120, 14, 77, 33, 8, 101, 47)]
    others = [_long_ids(n) for n in (7, 150, 30)]
    seeds = [[100 * i + j for j in range(len(rows))] for i in range(3)]
    voice.collect(voice.submit(rows, syn=syn, row_seeds=seeds[0]))
    pinned = voice._ratio, voice._spec_margin

    def batch(ids, seed_set):
        voice._ratio, voice._spec_margin = pinned
        return voice.collect(voice.submit(ids, syn=syn, row_seeds=seed_set))

    per_decode = [batch(rows, s) for s in seeds[:2]]
    assert voice._fused_cache == {} and voice.path_counts["fused"] == 0
    batch(rows, seeds[2])
    (key, state), = voice._fused_cache.items()
    assert state == "ready" and voice.path_counts["fused"] == 1
    n = len(key[1])
    want = (0, 0) if variant == "mb_istft" else (n, 2 * n)  # the graph's, per replay
    for i, s in enumerate(seeds[:2]):
        for k in range(2):
            batch(others, [7 * i + k + j for j in range(len(others))])
        before = V.mrf_fused.launches, V.fused_upsample_mrf.launches, voice.path_counts["fused"]
        got = batch(rows, s)
        dm, du = V.mrf_fused.launches - before[0], V.fused_upsample_mrf.launches - before[1]
        assert du == 2 * dm and dm >= want[0] and (dm == 0) == (want[0] == 0)  # re-decodes add 1 + 2
        assert voice.path_counts["fused"] == before[2] + 1
        for r, (a, b) in enumerate(zip(per_decode[i], got)):
            np.testing.assert_array_equal(a, b, err_msg=f"seeds {i}, row {r}")
    assert voice.path_counts["fused_failed"] == 0
