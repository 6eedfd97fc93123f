"""The float32 bodies' 3xTF32 products, through the host emulation of the tf32 instructions.

With -DPT_HOST_EMULATION, csrc/tc_common.cuh emulates what the float32
kernels run on the card: cvt.rna.tf32.f32 (round to nearest, ties away
from zero, 10 mantissa bits), a warpgroup product wgmma m64nNk8 tf32
(A's register fragment: register i of lane l holds row (l >> 2) + 8(i & 1)
and column (l & 3) + 4(i >> 1) of the warp's 16 rows; B read through its
descriptor as K-major core matrices of 8 rows x 4 tf32; an operand with
mantissa bits below tf32's is a fault) and its retirement at
wgmma.wait_group (a product without its fence, A registers rewritten
before it retires, a wait on an mbarrier phase that has not completed:
faults). Here one product is held against a matrix product of the
rounded operands at every width, the split against float32, a 3xTF32
conv against float64, both float32 bodies against the JAX package's
Pallas kernels run in interpret mode, a block past its row's end against
the full work, and two mutations of the source (the A lane map, the lo
term) are shown to fail these checks.
"""

import shutil
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

from piper_tpu.ops.pallas import vocoder as JV
from piper_tpu_torch.models.vits.generator import _tm_phase_plan
from piper_tpu_torch.ops.cuda import vocoder as V
from torch_emu import build_emulation

WIDTHS = (16, 32, 64, 128, 256)
RB2 = ((3, 5, 7), ((1, 2), (2, 6), (3, 12)))
# float32 against the Pallas kernels and the plain versions: both sum in
# float32, in other orders; 3xTF32 drops A_lo B_lo (about 2^-22 of each
# product), far below this bound
F32_TOL = (1e-4, 1e-4)


# Mutations of csrc/tc_common.cuh, each of which the checks below must
# catch: the A lane map (the two 8-row / 16-byte halves of ldmatrix's
# addresses swapped) and the lo term (A_lo B_hi replaced by A_hi B_hi).
MUTATIONS = {
    "lane map": ("(l & 7) +\n                        ((l >> 3) & 1) * 8;", "(l & 7) +\n                        (l >> 4) * 8;"),
    "lo term": ("wgmma_tf32<N>(acc[m], fa[m][kLo + u], bh, wg);", "wgmma_tf32<N>(acc[m], fa[m][u], bh, wg);"),
}


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    """The emulation built from csrc/ ("source") and from a copy of it
    with each mutation, the builds side by side."""
    names = ["source", *MUTATIONS]
    dirs = {name: tmp_path_factory.mktemp(name.replace(" ", "_")) for name in names}  # not thread-safe

    def build(name):
        d = dirs[name]
        if name == "source":
            return build_emulation(d)
        src = d / "csrc"
        shutil.copytree(V.CSRC, src)
        old, new = MUTATIONS[name]
        text = (src / "tc_common.cuh").read_text()
        assert text.count(old) == 1, name
        (src / "tc_common.cuh").write_text(text.replace(old, new))
        return build_emulation(d, src)

    with ThreadPoolExecutor(len(names)) as pool:
        return dict(zip(names, pool.map(build, names)))


@pytest.fixture(scope="module")
def emu(libs):
    return libs["source"]


@pytest.fixture(scope="module")
def mutants(libs):
    return libs


def _desc(start, lbo, sbo):
    return (start >> 4) | ((lbo >> 4) << 16) | ((sbo >> 4) << 32)


def _f32(rng, shape, scale=1.0):
    return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32))


def _probe(emu, n, a, image, desc, expect=None, flags=0):
    d = torch.full((64, n), float("nan"))
    img = image.contiguous()
    nbytes = img.numel() * img.element_size()
    rc = emu.emu_tf32_probe(n, a.contiguous().data_ptr(), img.data_ptr(), nbytes, desc,
                            nbytes if expect is None else expect, flags, d.data_ptr())
    return rc, d


def _hi_plane(b):
    """B (8 x n) in the float32 kernels' weight layout, its hi plane."""
    return V.tf32_weight_layout(b)[0]


@pytest.mark.parametrize("n", WIDTHS)
def test_emulated_tf32_product_is_a_matrix_product_of_the_rounded_operands(emu, n):
    """A (64 x 8) loaded with ldmatrix as the float32 bodies load it and
    rounded with cvt.rna.tf32.f32, B in the kernel layout read through the
    descriptor the GEMM builds (leading byte offset n*16 along K, stride
    byte offset 128 along N): D is tf32(A) @ tf32(B)."""
    rng = np.random.default_rng(n)
    a, b = _f32(rng, (64, 8)), _f32(rng, (8, n))
    rc, d = _probe(emu, n, a, _hi_plane(b), _desc(0, n * 16, 128))
    assert rc == 0, emu.emu_fault()
    ref = V.tf32_rna(a).double() @ V.tf32_rna(b).double()
    np.testing.assert_allclose(d.numpy(), ref.numpy(), rtol=0, atol=1e-5)
    assert not np.allclose(d.numpy(), (a.double() @ b.double()).numpy(), rtol=0, atol=1e-5)
    # the two offsets swapped read other elements (or, at 256, past the
    # emulated shared memory: a fault)
    rc, d = _probe(emu, n, a, _hi_plane(b), _desc(0, 128, n * 16))
    assert rc == -4 or not np.allclose(d.numpy(), ref.numpy(), atol=1e-2)


@pytest.mark.parametrize("flags,what", [(1, b"fence"), (2, b"A registers"), (4, b"mantissa bits")])
def test_emulated_tf32_product_fails_a_broken_protocol(emu, flags, what):
    """A product without its wgmma.fence, an A register rewritten before
    wait_group retires the product, an A operand left unrounded."""
    rng = np.random.default_rng(1)
    a, b = _f32(rng, (64, 8)), _f32(rng, (8, 16))
    rc, _ = _probe(emu, 16, a, _hi_plane(b), _desc(0, 16 * 16, 128), flags=flags)
    assert rc == -4 and what in emu.emu_fault()


def test_emulated_tf32_product_fails_a_wait_on_missing_bytes_or_raw_weights(emu):
    rng = np.random.default_rng(2)
    a, b = _f32(rng, (64, 8)), _f32(rng, (8, 32))
    img = _hi_plane(b)
    rc, _ = _probe(emu, 32, a, img, _desc(0, 32 * 16, 128), expect=img.numel() * 4 + 16)
    assert rc == -4 and b"not completed" in emu.emu_fault()
    raw = V.tf32_weight_layout(b)[0].clone()
    raw.view(torch.int32).bitwise_or_(1)  # a weight the wrapper did not round
    rc, _ = _probe(emu, 32, a, raw, _desc(0, 32 * 16, 128))
    assert rc == -4 and b"mantissa bits" in emu.emu_fault()


def _split_c(emu, v):
    v = v.contiguous()
    hi, lo = torch.empty(v.shape, dtype=torch.int32), torch.empty(v.shape, dtype=torch.int32)
    emu.emu_tf32_split(v.data_ptr(), v.numel(), hi.data_ptr(), lo.data_ptr())
    return hi.view(torch.float32), lo.view(torch.float32)


def test_tf32_split_reconstructs_every_float32(emu):
    """cvt.rna.tf32.f32 as the kernels run it and as the wrapper splits
    the weights (ops/cuda/vocoder.py::tf32_split) give the same bits; ties
    round away from zero; hi and lo are tf32 patterns; hi + lo is the
    float32 within 2^-21 of it, over normal floats of every sign and of
    exponents -100..100."""
    rng = np.random.default_rng(3)
    mant = rng.integers(0, 2**23, 200000, dtype=np.int64)
    expo = rng.integers(127 - 100, 127 + 100, 200000, dtype=np.int64)
    sign = rng.integers(0, 2, 200000, dtype=np.int64)
    bits = (sign << 31) | (expo << 23) | mant
    v = torch.from_numpy(np.where(bits >= 2**31, bits - 2**32, bits).astype(np.int32)).view(torch.float32)
    hi, lo = _split_c(emu, v)
    phi, plo = V.tf32_split(v)
    assert torch.equal(hi.view(torch.int32), phi.view(torch.int32))
    assert torch.equal(lo.view(torch.int32), plo.view(torch.int32))
    assert not (hi.view(torch.int32) & 0x1FFF).any() and not (lo.view(torch.int32) & 0x1FFF).any()
    rel = ((hi.double() + lo.double() - v.double()).abs() / v.double().abs()).max().item()
    assert rel <= 2.0**-21, rel
    # ties: exactly half a tf32 ulp rounds away from zero, either sign
    tie = torch.tensor([0x3F801000, -0x407FF000, 0x3F800FFF], dtype=torch.int32).view(torch.float32)
    got = _split_c(emu, tie)[0].view(torch.int32).tolist()
    assert got == [0x3F802000, -0x407FE000, 0x3F800000]


def _rb2_blocks(rng, c, ks=RB2[0], ds=RB2[1]):
    return [{"convs": [{"w": _f32(rng, (k, c, c), (k * c) ** -0.5), "b": _f32(rng, (c,), 0.1)} for _ in d]}
            for k, d in zip(ks, ds)]


def _emu_mrf(emu, x, lengths, w, b, ks, ds, rb, n_sm=8):
    bsz, c, t = x.shape
    cfg = V.mrf_launch_config(bsz, c, t, ks, ds, rb, w.shape[1], x.element_size(), n_sm)
    out = torch.full_like(x, float("nan"))
    wk = V.kernel_weight_layout(w)
    rc = emu.emu_mrf_fused(
        x.data_ptr(), lengths.data_ptr(), wk.data_ptr(), b.data_ptr(), out.data_ptr(), bsz, c, t,
        cfg["tile"], cfg["halo"], 0 if x.dtype == torch.float32 else 1, V._int_array(cfg["plan"]),
        len(cfg["plan"]), cfg["smem"],
    )
    assert rc == 0, (rc, emu.emu_fault())
    return out


def _one_conv_case(seed=4, c=128, t=160):
    """One resblock of one k=7 conv at C=128 (out = x + conv(lrelu(x)) + b
    over the valid positions), ragged rows."""
    rng = np.random.default_rng(seed)
    ks, ds = (7,), ((1,),)
    lengths = torch.tensor([t, t - 37], dtype=torch.int32)
    x = _f32(rng, (2, c, t)) * (torch.arange(t)[None, None] < lengths[:, None, None])
    w, b = V.pack_stage_weights(_rb2_blocks(rng, c, ks, ds), ks, ds, "2")
    return x, lengths, w, b, ks, ds


def _conv_f64(x, lengths, w, b, k):
    """The one-conv stage in float64."""
    valid = (torch.arange(x.shape[-1])[None, :] < lengths[:, None])[:, None]
    a = torch.where(valid, F.leaky_relu(x.double(), 0.1), torch.zeros((), dtype=torch.float64))
    y = F.conv1d(a, w[0, :k].double().permute(2, 1, 0), b[0, :, 0].double(), padding=(k - 1) // 2)
    return torch.where(valid, y + x.double(), torch.zeros((), dtype=torch.float64))


def _accuracy(emu, case):
    """(3xTF32 body's, plain float32's) largest distance from float64."""
    x, lengths, w, b, ks, ds = case
    ref = _conv_f64(x, lengths, w, b, ks[0])
    got = _emu_mrf(emu, x, lengths, w, b, ks, ds, "2")
    plain = V.mrf_fused_plain(x, lengths, w, b, kernel_sizes=ks, dilation_sizes=ds, resblock_type="2")
    return (got.double() - ref).abs().max().item(), (plain.double() - ref).abs().max().item()


def test_3xtf32_conv_is_as_close_to_float64_as_float32(emu):
    """A k=7 conv at C=128 (896 products a sum) through the float32 body
    is no further from float64 than 4x the plain float32 conv's own
    distance (one-pass TF32 would be about 2^11 further)."""
    err, err32 = _accuracy(emu, _one_conv_case())
    assert 0 < err32 and err <= 4 * err32, (err, err32)


def test_mrf_fused_float32_source_matches_pallas(emu):
    """The emulated float32 body of mrf_fused against the Pallas kernel
    (interpret mode) on the same float32 inputs, medium resblocks at
    C=32, ragged rows."""
    ks, ds = RB2
    rng = np.random.default_rng(5)
    c, t = 32, 300
    lengths = torch.tensor([300, 203, 5], dtype=torch.int32)
    x = _f32(rng, (3, c, t)) * (torch.arange(t)[None, None] < lengths[:, None, None])
    w, b = V.pack_stage_weights(_rb2_blocks(rng, c), ks, ds, "2")
    ref = JV.mrf_fused(
        jnp.asarray(x.numpy()), jnp.asarray(lengths.numpy()), jnp.asarray(w.numpy()), jnp.asarray(b.numpy()),
        kernel_sizes=ks, dilation_sizes=ds, resblock_type="2", t_tile=128, interpret=True,
    )
    got = _emu_mrf(emu, x, lengths, w, b, ks, ds, "2")
    np.testing.assert_allclose(got.numpy(), np.asarray(ref, np.float32), atol=F32_TOL[0], rtol=F32_TOL[1])


def _stage(rng, u, k, c_in, c_out):
    ks, ds = RB2
    q0, used, idx = _tm_phase_plan(k, u)
    kern = rng.standard_normal((k, c_in, c_out)).astype(np.float32) * (k * c_in / u) ** -0.5
    wt = np.zeros((u, used.shape[1], c_in, c_out), np.float32)
    for p in range(u):
        for qi in range(used.shape[1]):
            if used[p, qi]:
                wt[p, qi] = kern[idx[p, qi]]
    wm, bm = V.pack_stage_weights(_rb2_blocks(rng, c_out), ks, ds, "2")
    return dict(u=u, q0=q0, wt=torch.from_numpy(wt), wm=wm, bm=bm, bt=_f32(rng, (c_out,), 0.1),
                wpost=_f32(rng, (7, c_out, 1), 0.2))


def _emu_stage(emu, x, lengths, s, *, post, n_sm):
    ks, ds = RB2
    bsz, _, v = x.shape
    u, (_, nq, c_in, c_out) = s["u"], s["wt"].shape
    cfg = V.fused_launch_config(bsz, v, c_in, c_out, u, 1, s["q0"], nq, 7 if post else 0, ks, ds, "2",
                                s["wm"].shape[1], 4, n_sm)
    out = torch.full((bsz, u if post else u * c_out, v), float("nan"))
    wt, wm = V.tf32_weight_layout(s["wt"]), V.tf32_weight_layout(s["wm"])
    rc = emu.emu_fused_upsample_mrf(
        x.data_ptr(), lengths.data_ptr(), wt.data_ptr(), s["bt"].data_ptr(), wm.data_ptr(), s["bm"].data_ptr(),
        s["wpost"].data_ptr() if post else None, out.data_ptr(), bsz, V._int_array(cfg["args"]),
        len(cfg["args"]), 0, V._int_array(cfg["plan"]), len(cfg["plan"]), cfg["smem"],
    )
    assert rc == 0, (rc, emu.emu_fault())
    return out, cfg["tile"]


def test_fused_stage_float32_source_matches_pallas(emu):
    """The emulated float32 body of fused_upsample_mrf against the Pallas
    kernel (interpret mode) on the same float32 inputs: u=4, 32 -> 16
    channels, conv_post, ragged rows."""
    rng = np.random.default_rng(6)
    u, c_in, c_out, v = 4, 32, 16, 40
    s = _stage(rng, u, 8, c_in, c_out)
    lengths = torch.tensor([v * u, 23 * u - 3, 4], dtype=torch.int32)
    x = _f32(rng, (3, c_in, v)) * (torch.arange(v)[None, None] < (lengths // u)[:, None, None])
    got, _ = _emu_stage(emu, x, lengths, s, post=True, n_sm=16)
    ks, ds = RB2
    ref = JV.fused_upsample_mrf(
        jnp.asarray(x.numpy()), jnp.asarray(lengths.numpy()), jnp.asarray(s["wt"].numpy()),
        jnp.asarray(s["bt"].numpy()), jnp.asarray(s["wm"].numpy()), jnp.asarray(s["bm"].numpy()),
        jnp.asarray(s["wpost"].numpy()), u=u, u_in=1, q0=s["q0"], kernel_sizes=ks, dilation_sizes=ds,
        resblock_type="2", post=True, t_tile=128, interpret=True,
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(ref, np.float32)[:, :, :v], atol=F32_TOL[0],
                               rtol=F32_TOL[1])


@pytest.mark.parametrize("post", [False, True])
def test_float32_blocks_past_the_row_end_give_the_bits_of_the_full_work(emu, post):
    """Row 0 of 11 frames alone at its own width, and beside a 40-frame
    row at 40 frames: the float32 blocks whose tiles start past row 0's
    end return at once with zeros, and row 0's bits are those of its own
    width, where every block runs the whole chain; mrf_fused the same at
    C=32."""
    rng = np.random.default_rng(7)
    u, c_in, c_out = 4, 32, 16
    s = _stage(rng, u, 8, c_in, c_out)
    frames = torch.tensor([11, 40], dtype=torch.int32)
    x = _f32(rng, (2, c_in, 40)) * (torch.arange(40)[None, None] < frames[:, None, None])
    alone, _ = _emu_stage(emu, x[:1, :, :11].contiguous(), frames[:1] * u, s, post=post, n_sm=64)
    wide, tile = _emu_stage(emu, x, frames * u, s, post=post, n_sm=64)
    assert -(-40 * u // tile) > -(-11 * u // tile)  # row 0 has blocks past its end
    assert torch.equal(wide[0, :, :11].view(torch.int32), alone[0].view(torch.int32))
    assert not wide[0, :, 11:].any()
    ks, ds = RB2
    w, b = V.pack_stage_weights(_rb2_blocks(rng, 32), ks, ds, "2")
    lengths = torch.tensor([13, 200], dtype=torch.int32)
    x = _f32(rng, (2, 32, 200)) * (torch.arange(200)[None, None] < lengths[:, None, None])
    wide = _emu_mrf(emu, x, lengths, w, b, ks, ds, "2", n_sm=64)
    alone = _emu_mrf(emu, x[:1, :, :13].contiguous(), lengths[:1], w, b, ks, ds, "2", n_sm=64)
    assert torch.equal(wide[0, :, :13].view(torch.int32), alone[0].view(torch.int32))
    assert not wide[0, :, 13:].any()


def test_a_mutated_lane_map_fails_the_body_check(emu, mutants):
    """The float32 body with ldmatrix's lane addresses swapped no longer
    matches the plain version (the unmutated body does)."""
    ks, ds = RB2
    rng = np.random.default_rng(8)
    lengths = torch.tensor([120, 77], dtype=torch.int32)
    x = _f32(rng, (2, 32, 120)) * (torch.arange(120)[None, None] < lengths[:, None, None])
    w, b = V.pack_stage_weights(_rb2_blocks(rng, 32), ks, ds, "2")
    ref = V.mrf_fused_plain(x, lengths, w, b, kernel_sizes=ks, dilation_sizes=ds, resblock_type="2")
    good = _emu_mrf(emu, x, lengths, w, b, ks, ds, "2")
    bad = _emu_mrf(mutants["lane map"], x, lengths, w, b, ks, ds, "2")
    assert np.allclose(good.numpy(), ref.numpy(), atol=F32_TOL[0], rtol=F32_TOL[1])
    assert not np.allclose(bad.numpy(), ref.numpy(), atol=F32_TOL[0], rtol=F32_TOL[1])


def test_a_mutated_lo_term_fails_the_accuracy_check(mutants):
    """Without A_lo B_hi (A rounded once to tf32) the conv drifts from
    float64 by far more than 4x float32's distance."""
    err, err32 = _accuracy(mutants["lo term"], _one_conv_case())
    assert err > 4 * err32, (err, err32)
