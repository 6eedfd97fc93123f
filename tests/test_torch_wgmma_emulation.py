"""The host emulation of Hopper's wgmma, mbarriers and bulk copy, and the bf16 bodies built on them.

csrc/tc_common.cuh emulates, with -DPT_HOST_EMULATION, the instructions
the bf16 kernels run on the card: a warpgroup product (wgmma
m64nNk16, A in registers by the warps' fragment layout, B read through
its 64-bit matrix descriptor, the f32 accumulator layout), the bulk copy
that fills a weight stage, and the mbarrier it completes on. Here one
product is held against a plain matrix product at every width the kernels
instantiate, the descriptor's swizzle modes against images laid out by
hand, and the protocol's faults (bytes missing on a barrier, a product
without its fence, A registers rewritten before the product retires) are
shown to fail. Then the emulated bf16 bodies: a fused stage whose grid
runs past a row's end (blocks that return early) gives that row's bits at
its own width, and both bodies agree with the JAX package's Pallas
kernels run in interpret mode.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from piper_tpu.ops.pallas import vocoder as JV
from piper_tpu_torch.models.vits.generator import _tm_phase_plan
from piper_tpu_torch.ops.cuda import vocoder as V
from torch_emu import build_emulation

WIDTHS = (16, 32, 64, 128, 256)
RB2 = ((3, 5, 7), ((1, 2), (2, 6), (3, 12)))
# bf16 against the Pallas kernels: both round every conv output and
# residual to bf16 (lrelu's slope rounds differently), so a few bf16 ulps
# of the O(1) activations, as tests/test_torch_kernel_emulation.py bounds
# the bf16 bodies against their plain versions
BF16_TOL = (3e-2, 2e-2)


@pytest.fixture(scope="module")
def emu(tmp_path_factory):
    return build_emulation(tmp_path_factory.mktemp("wgmma"))


def _desc(start, lbo, sbo, layout=0):
    return (start >> 4) | ((lbo >> 4) << 16) | ((sbo >> 4) << 32) | (layout << 62)


def _bf16(rng, shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(torch.bfloat16)


def _probe(emu, n, a, image, desc, expect=None, flags=0):
    d = torch.full((64, n), float("nan"))
    img = image.contiguous()
    nbytes = img.numel() * img.element_size()
    rc = emu.emu_wgmma_probe(n, a.data_ptr(), img.data_ptr(), nbytes, desc,
                             nbytes if expect is None else expect, flags, d.data_ptr())
    return rc, d


@pytest.mark.parametrize("n", WIDTHS)
def test_emulated_wgmma_is_a_matrix_product_through_the_kernel_layout(emu, n):
    """B in the kernels' weight layout (ops/cuda/vocoder.py::
    tc_weight_layout), read through the descriptor the GEMM builds
    (leading byte offset n*16 along K, stride byte offset 128 along N)."""
    rng = np.random.default_rng(n)
    a, b = _bf16(rng, (64, 16)), _bf16(rng, (16, n))
    rc, d = _probe(emu, n, a, V.tc_weight_layout(b), _desc(0, n * 16, 128))
    assert rc == 0, emu.emu_fault()
    ref = a.double() @ b.double()
    np.testing.assert_allclose(d.numpy(), ref.numpy(), rtol=0, atol=1e-4)
    # the two offsets swapped read other elements (or, at 256, past the
    # emulated shared memory: a fault)
    rc, d = _probe(emu, n, a, V.tc_weight_layout(b), _desc(0, 128, n * 16))
    assert rc == -4 or not np.allclose(d.numpy(), ref.numpy(), atol=1e-2)


def _swizzled_image(b, width, sbo):
    """A K-major B laid out for a `width`-byte swizzle: row n of an 8-row
    atom is `width` bytes, atoms sbo bytes apart, and the 16-byte unit of
    each row XORed with the row's place in the atom (as TMA's swizzle
    modes write a tile)."""
    k, n = b.shape
    bits = {128: 3, 64: 2, 32: 1}[width]
    img = torch.zeros(((n // 8) * sbo) // 2, dtype=torch.bfloat16)
    for col in range(n):
        for row in range(k):
            lin = (col // 8) * sbo + (col % 8) * width + row * 2
            phys = lin ^ (((lin >> 7) & ((1 << bits) - 1)) << 4)
            img[phys // 2] = b[row, col]
    return img


@pytest.mark.parametrize("width,layout", [(128, 1), (64, 2), (32, 3)])
def test_emulated_wgmma_decodes_the_swizzle_modes(emu, width, layout):
    n = 64
    rng = np.random.default_rng(width)
    a, b = _bf16(rng, (64, 16)), _bf16(rng, (16, n))
    img = _swizzled_image(b, width, 8 * width)
    ref = (a.double() @ b.double()).numpy()
    rc, d = _probe(emu, n, a, img, _desc(0, 0, 8 * width, layout))
    assert rc == 0, emu.emu_fault()
    np.testing.assert_allclose(d.numpy(), ref, rtol=0, atol=1e-4)
    other = 1 + layout % 3  # another swizzle mode reads other elements
    rc, d = _probe(emu, n, a, img, _desc(0, 0, 8 * width, other))
    assert rc == 0 and not np.allclose(d.numpy(), ref, atol=1e-2)


def test_emulated_mbarrier_fails_a_wait_on_missing_bytes(emu):
    rng = np.random.default_rng(0)
    a, b = _bf16(rng, (64, 16)), _bf16(rng, (16, 32))
    img = V.tc_weight_layout(b)
    rc, _ = _probe(emu, 32, a, img, _desc(0, 32 * 16, 128), expect=img.numel() * 2 + 16)
    assert rc == -4 and b"not completed" in emu.emu_fault()
    rc, _ = _probe(emu, 32, a, img, _desc(0, 32 * 16, 128), expect=img.numel() * 2 - 16)
    assert rc == -4 and b"more bytes" in emu.emu_fault()
    rc, _ = _probe(emu, 32, a, img.reshape(-1)[:-4], _desc(0, 32 * 16, 128))  # 1016 bytes: not a multiple of 16
    assert rc == -4 and b"bulk copy" in emu.emu_fault()


@pytest.mark.parametrize("flags,what", [(1, b"fence"), (2, b"A registers")])
def test_emulated_wgmma_fails_a_broken_protocol(emu, flags, what):
    rng = np.random.default_rng(1)
    a, b = _bf16(rng, (64, 16)), _bf16(rng, (16, 16))
    rc, _ = _probe(emu, 16, a, V.tc_weight_layout(b), _desc(0, 16 * 16, 128), flags=flags)
    assert rc == -4 and what in emu.emu_fault()


def test_mrf_fused_bf16_refuses_more_output_tiles_than_the_warpgroups_hold(emu):
    """At C=16 (width 16: 4 tiles of 64 rows a warpgroup) a 432-position
    tile spans 522 window rows, 9 tiles: -3, though the layout fits."""
    ks, ds = RB2
    assert V.mrf_tc_fits(16, 416, 45) and not V.mrf_tc_fits(16, 432, 45)
    assert V.mrf_smem_bytes_tc(16, 432, 45) <= V.SMEM_LIMIT
    rng = np.random.default_rng(2)
    x = _bf16(rng, (1, 16, 500))
    w, b = V.pack_stage_weights(_blocks(rng, 16), ks, ds, "2", dtype=torch.bfloat16)
    plan = V.mrf_plan_ints(ks, ds, "2", w.shape[1])
    out, wk, lengths = torch.empty_like(x), V.tc_weight_layout(w), torch.tensor([500], dtype=torch.int32)
    rc = emu.emu_mrf_fused(
        x.data_ptr(), lengths.data_ptr(), wk.data_ptr(), b.data_ptr(), out.data_ptr(), 1, 16, 500, 432, 45, 1,
        V._int_array(plan), len(plan), V.mrf_smem_bytes_tc(16, 432, 45),
    )
    assert rc == -3


def _blocks(rng, c, unit_gain=True):
    ks, ds = RB2
    blocks = []
    for k, dils in zip(ks, ds):
        scale = (k * c) ** -0.5 if unit_gain else 0.15
        blocks.append({"convs": [
            {"w": torch.from_numpy(rng.standard_normal((k, c, c)).astype(np.float32) * scale),
             "b": torch.from_numpy(rng.standard_normal(c).astype(np.float32) * 0.1)}
            for _ in dils
        ]})
    return blocks


def _stage(rng, u, k, c_in, c_out):
    ks, ds = RB2
    q0, used, idx = _tm_phase_plan(k, u)
    kern = rng.standard_normal((k, c_in, c_out)).astype(np.float32) * (k * c_in / u) ** -0.5
    wt = np.zeros((u, used.shape[1], c_in, c_out), np.float32)
    for p in range(u):
        for qi in range(used.shape[1]):
            if used[p, qi]:
                wt[p, qi] = kern[idx[p, qi]]
    wm, bm = V.pack_stage_weights(_blocks(rng, c_out), ks, ds, "2")
    return dict(
        u=u, q0=q0, wt=torch.from_numpy(wt), wm=wm, bm=bm,
        bt=torch.from_numpy(rng.standard_normal(c_out).astype(np.float32) * 0.1),
        wpost=torch.from_numpy(rng.standard_normal((7, c_out, 1)).astype(np.float32) * 0.2),
    )


def _emu_stage(emu, x, lengths, s, *, u_in, post, n_sm, dtype):
    ks, ds = RB2
    bsz, _, v = x.shape
    u, (_, nq, c_in, c_out) = s["u"], s["wt"].shape
    cfg = V.fused_launch_config(
        bsz, v, c_in, c_out, u, u_in, s["q0"], nq, 7 if post else 0, ks, ds, "2",
        s["wm"].shape[1], 2, n_sm,
    )
    out = torch.full((bsz, u * u_in if post else u * u_in * c_out, v), float("nan"), dtype=dtype)
    wt, wm = V.tc_weight_layout(s["wt"].to(dtype)), V.tc_weight_layout(s["wm"].to(dtype))
    wpost, x = s["wpost"].to(dtype), x.to(dtype)
    rc = emu.emu_fused_upsample_mrf(
        x.data_ptr(), lengths.data_ptr(), wt.data_ptr(), s["bt"].data_ptr(), wm.data_ptr(),
        s["bm"].data_ptr(), wpost.data_ptr() if post else None, out.data_ptr(), bsz,
        V._int_array(cfg["args"]), len(cfg["args"]), 1, V._int_array(cfg["plan"]), len(cfg["plan"]),
        cfg["smem"],
    )
    assert rc == 0, (rc, emu.emu_fault())
    return out, cfg["tile"]


@pytest.mark.parametrize("post", [False, True])
def test_fused_stage_bf16_past_the_row_end_gives_the_row_bits(emu, post):
    """Row 0 of 11 frames alone at its own width, and beside a 40-frame
    row at 40 frames: the blocks whose tiles start past row 0's end
    return early with zeros, and row 0's bits are those of its own
    width."""
    rng = np.random.default_rng(3)
    u, c_in, c_out = 4, 32, 16
    s = _stage(rng, u, 8, c_in, c_out)
    frames = torch.tensor([11, 40], dtype=torch.int32)
    x = torch.from_numpy(rng.standard_normal((2, c_in, 40)).astype(np.float32))
    x = (x * (torch.arange(40)[None, None] < frames[:, None, None])).to(torch.bfloat16)
    alone, tile_a = _emu_stage(emu, x[:1, :, :11].contiguous(), frames[:1] * u, s, u_in=1, post=post, n_sm=64,
                               dtype=torch.bfloat16)
    wide, tile_w = _emu_stage(emu, x, frames * u, s, u_in=1, post=post, n_sm=64, dtype=torch.bfloat16)
    assert -(-40 * u // tile_w) > -(-11 * u // tile_w)  # row 0 has blocks past its end
    assert torch.equal(wide[0, :, :11].view(torch.int16), alone[0].view(torch.int16))
    assert not wide[0, :, 11:].float().any()


def test_mrf_fused_bf16_source_matches_pallas(emu):
    """The emulated bf16 body of mrf_fused against the Pallas kernel
    (interpret mode) on the same bf16 inputs, medium resblocks at C=32,
    ragged rows."""
    ks, ds = RB2
    rng = np.random.default_rng(4)
    c, t = 32, 300
    lengths = torch.tensor([300, 203, 5], dtype=torch.int32)
    x = torch.from_numpy(rng.standard_normal((3, c, t)).astype(np.float32))
    x = (x * (torch.arange(t)[None, None] < lengths[:, None, None])).to(torch.bfloat16)
    w, b = V.pack_stage_weights(_blocks(rng, c), ks, ds, "2", dtype=torch.bfloat16)
    ref = JV.mrf_fused(
        jnp.asarray(x.float().numpy(), jnp.bfloat16), jnp.asarray(lengths.numpy()),
        jnp.asarray(w.float().numpy(), jnp.bfloat16), jnp.asarray(b.numpy()), kernel_sizes=ks,
        dilation_sizes=ds, resblock_type="2", t_tile=128, interpret=True,
    )
    cfg = V.mrf_launch_config(3, c, t, ks, ds, "2", w.shape[1], 2, 8)
    out = torch.full_like(x, float("nan"))
    wk = V.tc_weight_layout(w)
    rc = emu.emu_mrf_fused(
        x.data_ptr(), lengths.data_ptr(), wk.data_ptr(), b.data_ptr(), out.data_ptr(),
        3, c, t, cfg["tile"], cfg["halo"], 1, V._int_array(cfg["plan"]), len(cfg["plan"]),
        cfg["smem"],
    )
    assert rc == 0, (rc, emu.emu_fault())
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32), atol=BF16_TOL[0], rtol=BF16_TOL[1])


def test_fused_stage_bf16_source_matches_pallas(emu):
    """The emulated bf16 body of fused_upsample_mrf against the Pallas
    kernel (interpret mode) on the same bf16 inputs: u=4, 32 -> 16
    channels, conv_post, ragged rows."""
    rng = np.random.default_rng(5)
    u, c_in, c_out, v = 4, 32, 16, 40
    s = _stage(rng, u, 8, c_in, c_out)
    lengths = torch.tensor([v * u, 23 * u - 3, 4], dtype=torch.int32)
    x = torch.from_numpy(rng.standard_normal((3, c_in, v)).astype(np.float32))
    x = (x * (torch.arange(v)[None, None] < (lengths // u)[:, None, None])).to(torch.bfloat16)
    got, _ = _emu_stage(emu, x, lengths, s, u_in=1, post=True, n_sm=16, dtype=torch.bfloat16)

    def j(t):
        return jnp.asarray(t.to(torch.bfloat16).float().numpy(), jnp.bfloat16)

    ks, ds = RB2
    ref = JV.fused_upsample_mrf(
        j(x), jnp.asarray(lengths.numpy()), j(s["wt"]), jnp.asarray(s["bt"].numpy()), j(s["wm"]),
        jnp.asarray(s["bm"].numpy()), j(s["wpost"]), u=u, u_in=1, q0=s["q0"], kernel_sizes=ks,
        dilation_sizes=ds, resblock_type="2", post=True, t_tile=128, interpret=True,
    )
    ref = np.asarray(ref, np.float32)[:, :, :v]
    np.testing.assert_allclose(got.float().numpy(), ref, atol=BF16_TOL[0], rtol=BF16_TOL[1])
