"""The CUDA kernels' own source, built for the host, against the plain versions.

csrc/host_emulation.cpp compiles mrf_fused.cu and fused_upsample_mrf.cu
with -DPT_HOST_EMULATION: each block runs phase by phase on the CPU, and
the bodies' warpgroup products (bf16, and float32's 3xTF32), bulk copies
and mbarriers as the PTX ISA defines them (csrc/tc_common.cuh), so
the kernels' tiling, halos, masks, polyphase and plane index maps are
checked here, where there is no GPU. Launch parameters come from the
same functions the CUDA wrappers use (ops/cuda/vocoder.py::
mrf_launch_config / fused_launch_config); `n_sm` is varied to force
several tile sizes per case.
"""

import hashlib

import numpy as np
import pytest
import torch

from piper_tpu_torch.models.vits.generator import _tm_phase_plan
from piper_tpu_torch.ops.cuda import vocoder as V
from torch_emu import build_emulation

RB = {
    "1": ((3, 7), ((1, 3), (1, 3))),
    "2": ((3, 5, 7), ((1, 2), (2, 6), (3, 12))),
}
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# (atol, rtol). float32: only the summation order differs. bfloat16: both
# round at the same points, but a one-ulp flip early in the chain travels;
# the bounds are a few bf16 ulps (2^-8 relative) of the O(1) activations.
TOL = {torch.float32: (2e-5, 0.0), torch.bfloat16: (3e-2, 2e-2)}


@pytest.fixture(scope="module")
def emu(tmp_path_factory):
    return build_emulation(tmp_path_factory.mktemp("emu"))


def _kernel_weights(w):
    """The bodies read their weights in the kernel layout of their dtype,
    as the CUDA wrappers pass them (ops/cuda/vocoder.py::tc_weights)."""
    return V.kernel_weight_layout(w)


def _blocks(rng, c, rb, unit_gain=False):
    """Random resblock weights: a fixed scale of 0.15, or with unit_gain a
    scale of 1/sqrt(k*C), which keeps activations O(1) through the chain
    at any width, as trained weights do."""
    ks, ds = RB[rb]
    blocks = []
    for k, dils in zip(ks, ds):
        scale = (k * c) ** -0.5 if unit_gain else 0.15

        def conv():
            return {
                "w": torch.from_numpy(rng.standard_normal((k, c, c)).astype(np.float32) * scale),
                "b": torch.from_numpy(rng.standard_normal(c).astype(np.float32) * 0.1),
            }
        if rb == "1":
            blocks.append({"convs1": [conv() for _ in dils], "convs2": [conv() for _ in dils]})
        else:
            blocks.append({"convs": [conv() for _ in dils]})
    return blocks


def _emu_mrf(lib, x, lengths, w, b, rb, n_sm, tile=None):
    """Run the emulated mrf_fused with the wrapper's launch config, or with
    a bf16 tile of the caller's choice."""
    ks, ds = RB[rb]
    bsz, c, t = x.shape
    cfg = V.mrf_launch_config(bsz, c, t, ks, ds, rb, w.shape[1], x.element_size(), n_sm)
    if tile is not None:
        lay = (V.mrf_tc_layout(c, tile, cfg["halo"]) if x.dtype == torch.bfloat16
               else V.mrf_tf32_layout(c, tile, cfg["halo"], rb == "1"))
        cfg.update(tile=tile, smem=lay["bytes"])
    out = torch.full_like(x, float("nan"))
    wk = _kernel_weights(w)
    rc = lib.emu_mrf_fused(
        x.data_ptr(), lengths.data_ptr(), wk.data_ptr(), b.data_ptr(), out.data_ptr(),
        bsz, c, t, cfg["tile"], cfg["halo"], DTYPES[x.dtype],
        V._int_array(cfg["plan"]), len(cfg["plan"]), cfg["smem"],
    )
    assert rc == 0, (rc, lib.emu_fault())
    return out, cfg["tile"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rb,c", [("2", 32), ("1", 16)])
def test_mrf_fused_source_matches_plain(emu, rb, c, dtype):
    rng = np.random.default_rng(0)
    ks, ds = RB[rb]
    t = 300
    lengths = torch.tensor([300, 217, 5], dtype=torch.int32)
    x = torch.from_numpy(rng.standard_normal((3, c, t)).astype(np.float32)).to(dtype)
    w, b = V.pack_stage_weights(_blocks(rng, c, rb), ks, ds, rb, dtype=dtype)
    ref = V.mrf_fused_plain(x, lengths, w, b, kernel_sizes=ks, dilation_sizes=ds, resblock_type=rb)
    tiles = set()
    for n_sm in (1, 8, 64):
        got, tile = _emu_mrf(emu, x, lengths, w, b, rb, n_sm)
        tiles.add(tile)
        np.testing.assert_allclose(got.float().numpy(), ref.float().numpy(), atol=TOL[dtype][0], rtol=TOL[dtype][1])
    assert len(tiles) > 1, tiles


def _medium_stage0(dtype, seed):
    """Stage 0 of the medium voice at a narrow length: C=128, resblock "2"
    (halo 45), three ragged rows, the last shorter than one tile."""
    rng = np.random.default_rng(seed)
    ks, ds = RB["2"]
    t = 200
    lengths = torch.tensor([200, 173, 5], dtype=torch.int32)
    x = torch.from_numpy(rng.standard_normal((3, 128, t)).astype(np.float32)).to(dtype)
    w, b = V.pack_stage_weights(_blocks(rng, 128, "2", unit_gain=True), ks, ds, "2", dtype=dtype)
    return x, lengths, w, b


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mrf_fused_medium_width_source_matches_plain(emu, dtype):
    """The medium voice's stage-0 width (C=128, the bf16 body's largest
    tile, 96 positions: 12 x 8 GEMM tiles)."""
    x, lengths, w, b = _medium_stage0(dtype, seed=5)
    ks, ds = RB["2"]
    ref = V.mrf_fused_plain(x, lengths, w, b, kernel_sizes=ks, dilation_sizes=ds, resblock_type="2")
    got, tile = _emu_mrf(emu, x, lengths, w, b, "2", n_sm=1)
    if dtype == torch.bfloat16:
        assert tile == 96
    np.testing.assert_allclose(got.float().numpy(), ref.float().numpy(), atol=TOL[dtype][0], rtol=TOL[dtype][1])


def test_mrf_fused_bf16_output_does_not_depend_on_the_tile(emu):
    """The bf16 body sums each output element in one fixed order (taps,
    then 16-channel chunks), so tiles of other sizes give the same bits;
    a tile past a row's end writes zeros."""
    x, lengths, w, b = _medium_stage0(torch.bfloat16, seed=6)
    outs = [_emu_mrf(emu, x, lengths, w, b, "2", n_sm=1, tile=tile)[0] for tile in (32, 64, 96)]
    for got in outs[1:]:
        assert torch.equal(got, outs[0])
    assert not torch.isnan(outs[0]).any()
    assert torch.equal(outs[0][2, :, 5:], torch.zeros_like(outs[0][2, :, 5:]))


def test_mrf_fused_bf16_refuses_a_layout_that_does_not_fit(emu):
    """-3, as the CUDA entry returns, for a tile whose layout needs more
    shared memory than a block may use, or than the launch gives."""
    x, lengths, w, b = _medium_stage0(torch.bfloat16, seed=7)
    ks, ds = RB["2"]
    cfg = V.mrf_launch_config(3, 128, 200, ks, ds, "2", w.shape[1], 2, 1)
    assert not V.mrf_tc_fits(128, 112, 45) and V.mrf_tc_fits(128, 96, 45)
    out = torch.empty_like(x)
    wk = _kernel_weights(w)
    for tile, smem in ((112, V.mrf_smem_bytes_tc(128, 112, 45)), (96, V.mrf_smem_bytes_tc(128, 96, 45) - 16)):
        rc = emu.emu_mrf_fused(
            x.data_ptr(), lengths.data_ptr(), wk.data_ptr(), b.data_ptr(), out.data_ptr(),
            3, 128, 200, tile, cfg["halo"], 1,
            V._int_array(cfg["plan"]), len(cfg["plan"]), smem,
        )
        assert rc == -3, (tile, smem, rc)


def _stage_weights(rng, u, k, c_in, c_out, rb, dtype):
    ks, ds = RB[rb]
    q0, used, idx = _tm_phase_plan(k, u)
    kern = rng.standard_normal((k, c_in, c_out)).astype(np.float32) * 0.1
    wt = np.zeros((u, used.shape[1], c_in, c_out), np.float32)
    for p in range(u):
        for qi in range(used.shape[1]):
            if used[p, qi]:
                wt[p, qi] = kern[idx[p, qi]]
    wm, bm = V.pack_stage_weights(_blocks(rng, c_out, rb), ks, ds, rb, dtype=dtype)
    return dict(
        wt=torch.from_numpy(wt).to(dtype),
        bt=torch.from_numpy(rng.standard_normal(c_out).astype(np.float32) * 0.1),
        wm=wm, bm=bm, q0=q0,
        wpost=torch.from_numpy(rng.standard_normal((7, c_out, 1)).astype(np.float32) * 0.3).to(dtype),
    )


def _emu_stage(lib, x, lengths, s, *, u, u_in, rb, post, n_sm):
    ks, ds = RB[rb]
    bsz, _, v = x.shape
    _, nq, c_in, c_out = s["wt"].shape
    cfg = V.fused_launch_config(
        bsz, v, c_in, c_out, u, u_in, s["q0"], nq, 7 if post else 0, ks, ds, rb,
        s["wm"].shape[1], x.element_size(), n_sm,
    )
    rows = u * u_in if post else u * u_in * c_out
    out = torch.full((bsz, rows, v), float("nan"), dtype=x.dtype)
    wt, wm = _kernel_weights(s["wt"]), _kernel_weights(s["wm"])
    rc = lib.emu_fused_upsample_mrf(
        x.data_ptr(), lengths.data_ptr(), wt.data_ptr(), s["bt"].data_ptr(),
        wm.data_ptr(), s["bm"].data_ptr(), s["wpost"].data_ptr() if post else None,
        out.data_ptr(), bsz, V._int_array(cfg["args"]), len(cfg["args"]),
        DTYPES[x.dtype], V._int_array(cfg["plan"]), len(cfg["plan"]), cfg["smem"],
    )
    assert rc == 0, (rc, lib.emu_fault())
    return out, cfg["tile"]


def _plain_stage(x, lengths, s, *, u, u_in, rb, post):
    ks, ds = RB[rb]
    return V.fused_upsample_mrf_plain(
        x, lengths, s["wt"], s["bt"], s["wm"], s["bm"], s["wpost"] if post else None,
        u=u, u_in=u_in, q0=s["q0"], kernel_sizes=ks, dilation_sizes=ds,
        resblock_type=rb, post=post,
    )


STAGE_CASES = [(8, 16, 48, 32, "2", False), (4, 8, 32, 16, "2", True), (2, 4, 16, 8, "1", True),
               (4, 8, 20, 12, "2", True)]


def _stage_case(u, k, c_in, c_out, rb, dtype):
    rng = np.random.default_rng(1)
    v = max(40, 256 // u)  # enough samples for more than one tile size
    lengths = torch.tensor([v * u, (v - 7) * u, 5 * u - 3], dtype=torch.int32)
    x = torch.from_numpy(rng.standard_normal((3, c_in, v)).astype(np.float32))
    x = (x * (torch.arange(v)[None, None] < (lengths // u)[:, None, None])).to(dtype)
    return x, lengths, _stage_weights(rng, u, k, c_in, c_out, rb, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("u,k,c_in,c_out,rb,post", STAGE_CASES)
def test_fused_stage_source_matches_plain(emu, u, k, c_in, c_out, rb, post, dtype):
    x, lengths, s = _stage_case(u, k, c_in, c_out, rb, dtype)
    ref = _plain_stage(x, lengths, s, u=u, u_in=1, rb=rb, post=post)
    tiles = set()
    for n_sm in (1, 32):
        got, tile = _emu_stage(emu, x, lengths, s, u=u, u_in=1, rb=rb, post=post, n_sm=n_sm)
        tiles.add(tile)
        np.testing.assert_allclose(got.float().numpy(), ref.float().numpy(), atol=TOL[dtype][0], rtol=TOL[dtype][1])
    assert len(tiles) > 1, tiles


# sha1 (first 16 hex digits) of the bf16 output bits of each STAGE_CASES
# case (n_sm=32), recorded from the kernel as it was before its MRF chain
# became the one it shares with mrf_fused (tc_common.cuh::mrf_chain_tc).
# The chain moved without a change to its arithmetic; a change that
# alters the sums' order or rounding points changes these on purpose.
STAGE_BF16_SHA1 = ["17b369ed192b93bb", "5a725e4c3ec62dad", "aa66cd54f84048ca", "a38beaf0873f5077"]


@pytest.mark.parametrize("case,sha", zip(STAGE_CASES, STAGE_BF16_SHA1))
def test_fused_stage_bf16_output_bits_are_pinned(emu, case, sha):
    u, k, c_in, c_out, rb, post = case
    x, lengths, s = _stage_case(u, k, c_in, c_out, rb, torch.bfloat16)
    got, _ = _emu_stage(emu, x, lengths, s, u=u, u_in=1, rb=rb, post=post, n_sm=32)
    assert hashlib.sha1(got.view(torch.int16).numpy().tobytes()).hexdigest()[:16] == sha


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_stage_chain_source_matches_plain(emu, dtype):
    """Stage u=8 -> planes -> stage u=4 with u_in=8 and conv_post."""
    rng = np.random.default_rng(2)
    v = 24
    frames = torch.tensor([24, 17, 3], dtype=torch.int32)
    x = torch.from_numpy(rng.standard_normal((3, 32, v)).astype(np.float32))
    x = (x * (torch.arange(v)[None, None] < frames[:, None, None])).to(dtype)
    s1 = _stage_weights(rng, 8, 16, 32, 16, "2", dtype)
    s2 = _stage_weights(rng, 4, 8, 16, 8, "2", dtype)
    ref = _plain_stage(x, frames * 8, s1, u=8, u_in=1, rb="2", post=False)
    ref = _plain_stage(ref, frames * 32, s2, u=4, u_in=8, rb="2", post=True)
    for n_sm in (1, 32):
        y, _ = _emu_stage(emu, x, frames * 8, s1, u=8, u_in=1, rb="2", post=False, n_sm=n_sm)
        got, _ = _emu_stage(emu, y, frames * 32, s2, u=4, u_in=8, rb="2", post=True, n_sm=n_sm)
        np.testing.assert_allclose(got.float().numpy(), ref.float().numpy(), atol=TOL[dtype][0], rtol=TOL[dtype][1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_stage_medium_widths_source_matches_plain(emu, dtype):
    """The medium voice's channel ratio at a narrow length: 128 -> 64 with
    u=8, then 64 -> 32 with u=4, u_in=8 and conv_post; ragged rows. The
    wider sums (3*128 and 7*64 terms) grow the activations, so float32
    also gets a relative bound of 1e-4 for its other summation order."""
    tol = (TOL[dtype][0], max(TOL[dtype][1], 1e-4))
    rng = np.random.default_rng(3)
    v = 20
    frames = torch.tensor([20, 13, 2], dtype=torch.int32)
    x = torch.from_numpy(rng.standard_normal((3, 128, v)).astype(np.float32))
    x = (x * (torch.arange(v)[None, None] < frames[:, None, None])).to(dtype)
    s1 = _stage_weights(rng, 8, 16, 128, 64, "2", dtype)
    s2 = _stage_weights(rng, 4, 8, 64, 32, "2", dtype)
    ref1 = _plain_stage(x, frames * 8, s1, u=8, u_in=1, rb="2", post=False)
    ref2 = _plain_stage(ref1, frames * 32, s2, u=4, u_in=8, rb="2", post=True)
    y, _ = _emu_stage(emu, x, frames * 8, s1, u=8, u_in=1, rb="2", post=False, n_sm=32)
    np.testing.assert_allclose(y.float().numpy(), ref1.float().numpy(), atol=tol[0], rtol=tol[1])
    got, _ = _emu_stage(emu, ref1, frames * 32, s2, u=4, u_in=8, rb="2", post=True, n_sm=32)
    np.testing.assert_allclose(got.float().numpy(), ref2.float().numpy(), atol=tol[0], rtol=tol[1])


def test_fused_stage_bf16_output_does_not_depend_on_the_tile(emu):
    """The bf16 body sums each output element in one fixed order (taps,
    then 16-channel chunks), so tiles of other sizes give the same bits."""
    rng = np.random.default_rng(4)
    v = 48
    lengths = torch.tensor([v * 8, (v - 11) * 8 - 5, 9], dtype=torch.int32)
    x = torch.from_numpy(rng.standard_normal((3, 32, v)).astype(np.float32))
    x = (x * (torch.arange(v)[None, None] < (lengths // 8)[:, None, None])).to(torch.bfloat16)
    s = _stage_weights(rng, 8, 16, 32, 24, "1", torch.bfloat16)
    outs, tiles = [], set()
    for n_sm in (1, 2, 64):
        got, tile = _emu_stage(emu, x, lengths, s, u=8, u_in=1, rb="1", post=True, n_sm=n_sm)
        outs.append(got)
        tiles.add(tile)
    assert len(tiles) == 3, tiles
    for got in outs[1:]:
        assert torch.equal(got, outs[0])
