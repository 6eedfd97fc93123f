"""Launch configuration of the tensor-core kernels, bf16 and float32, on the CPU.

Every preset's stage split is decided by a shared-memory rule of its own
(models/vits/generator.py: tm_start_stage, fused_suffix_start at
SPLIT_ESIZE; ops/cuda/vocoder.py: mrf_smem_bytes, fused_smem_bytes), and
is pinned here. Both precisions run the same split, so both bodies must
then fit every stage that split gives them: mrf_fused a tile of at least
16 positions, fused_upsample_mrf one of at least one output frame, within
the 232,448 bytes of shared memory one block may use. The Python mirrors
of the layouts (ops/cuda/vocoder.py: bf16 mrf_tc_layout, fused_tc_layout;
float32 mrf_tf32_layout, fused_tf32_layout) equal the C layouts (the
kernel sources built for the host, csrc/host_emulation.cpp) field by
field, ring stages and barriers included, and the kernels' weight
layouts give back every tap slice (float32: its hi + lo planes).
"""

import ctypes

import numpy as np
import pytest
import torch

from piper_tpu_torch.config import ModelConfig
from piper_tpu_torch.models.vits import generator as G
from piper_tpu_torch.ops.cuda import vocoder as V
from torch_emu import build_emulation

QUALITIES = ["x-low", "low", "medium", "high"]
# (rows, frames, SMs) of the launches each stage is sized for: one frame,
# the kernel phase, a warm batch, one SM
SHAPES = ((1, 1, 132), (3, 403, 132), (16, 490, 132), (1, 50, 1))


def _fused_stages(cfg):
    start = G.tm_start_stage(cfg)
    first = G.fused_suffix_start(cfg, start)
    uic, n = cfg.upsample_initial_channel, len(cfg.upsample_rates)
    u_in = 1
    for j in range(first, n):
        u, k = cfg.upsample_rates[j], cfg.upsample_kernel_sizes[j]
        q0, used, _ = G._tm_phase_plan(k, u)
        yield dict(c_in=uic // 2**j, c_out=uic // 2 ** (j + 1), u=u, u_in=u_in, q0=q0,
                   nq=used.shape[1], k_post=7 if j == n - 1 else 0)
        u_in *= u


@pytest.mark.parametrize("quality", ["x-low", "low", "medium", "high"])
def test_bf16_fused_launch_config_fits_every_fused_stage(quality):
    cfg = ModelConfig.for_quality(quality, num_symbols=256)
    ks = tuple(cfg.resblock_kernel_sizes)
    ds = tuple(tuple(d) for d in cfg.resblock_dilation_sizes)
    stages = list(_fused_stages(cfg))
    assert stages, "the split fuses no stage"
    for st in stages:
        u_out = st["u"] * st["u_in"]
        for b, frames, n_sm in ((1, 1, 132), (3, 403 * 8, 132), (16, 490 * 8, 132), (1, 50, 1)):
            v = frames * (cfg.upsample_rates[0] if st["u_in"] == 1 else 1)
            got = V.fused_launch_config(
                b, v, st["c_in"], st["c_out"], st["u"], st["u_in"], st["q0"], st["nq"],
                st["k_post"], ks, ds, cfg.resblock, 7, 2, n_sm,
            )
            tile, halo, hpost = got["tile"], got["args"][10], got["args"][11]
            assert tile >= u_out and tile % u_out == 0
            assert got["smem"] <= V.SMEM_LIMIT
            assert got["smem"] == V.fused_smem_bytes_tc(
                st["c_in"], st["c_out"], st["u"], st["nq"], tile, halo, hpost)
            assert V.fused_tc_fits(st["c_in"], st["c_out"], st["u"], st["nq"], tile, halo, hpost)


# (tm_start_stage, fused_suffix_start) of each preset: stage 0 in
# mrf_fused and stages 1-2 fused, except on high (resblock "1", 512
# initial channels), whose stages 0-1 run the NWC path.
SPLIT = {"x-low": (0, 1), "low": (0, 1), "medium": (0, 1), "high": (2, 2)}


@pytest.mark.parametrize("quality", sorted(SPLIT))
def test_stage_split_is_unchanged(quality):
    cfg = ModelConfig.for_quality(quality, num_symbols=256)
    start = G.tm_start_stage(cfg)
    assert (start, G.fused_suffix_start(cfg, start)) == SPLIT[quality]


@pytest.mark.parametrize("quality", ["x-low", "low", "medium", "high"])
def test_bf16_mrf_launch_config_fits_every_mrf_stage(quality):
    cfg = ModelConfig.for_quality(quality, num_symbols=256)
    ks = tuple(cfg.resblock_kernel_sizes)
    ds = tuple(tuple(d) for d in cfg.resblock_dilation_sizes)
    start = G.tm_start_stage(cfg)
    stages = range(start, G.fused_suffix_start(cfg, start))
    assert len(stages) == SPLIT[quality][1] - SPLIT[quality][0]
    k_max = max(ks)
    for i in stages:
        c = cfg.upsample_initial_channel // 2 ** (i + 1)
        u0 = 1
        for u in cfg.upsample_rates[: i + 1]:
            u0 *= u
        for b, frames, n_sm in ((1, 1, 132), (3, 403, 132), (16, 490, 132), (1, 50, 1)):
            got = V.mrf_launch_config(b, c, frames * u0, ks, ds, cfg.resblock, k_max, 2, n_sm)
            tile, halo = got["tile"], got["halo"]
            assert tile >= 16 and tile % 16 == 0
            assert got["smem"] <= V.SMEM_LIMIT
            assert got["smem"] == V.mrf_smem_bytes_tc(c, tile, halo)
            assert V.mrf_tc_fits(c, tile, halo)


@pytest.fixture(scope="module")
def emu(tmp_path_factory):
    return build_emulation(tmp_path_factory.mktemp("layout"))


def _mrf_stages(cfg):
    start = G.tm_start_stage(cfg)
    for i in range(start, G.fused_suffix_start(cfg, start)):
        u0 = 1
        for u in cfg.upsample_rates[: i + 1]:
            u0 *= u
        yield cfg.upsample_initial_channel // 2 ** (i + 1), u0


@pytest.mark.parametrize("quality", QUALITIES)
def test_bf16_layout_mirrors_equal_the_c_layouts(emu, quality):
    cfg = ModelConfig.for_quality(quality, num_symbols=256)
    ks = tuple(cfg.resblock_kernel_sizes)
    ds = tuple(tuple(d) for d in cfg.resblock_dilation_sizes)
    out = (ctypes.c_longlong * 32)()
    n_checked = 0
    for c, u0 in _mrf_stages(cfg):
        for b, frames, n_sm in SHAPES:
            got = V.mrf_launch_config(b, c, frames * u0, ks, ds, cfg.resblock, max(ks), 2, n_sm)
            py = V.mrf_tc_layout(c, got["tile"], got["halo"])
            n = emu.emu_mrf_tc_layout(c, got["tile"], got["halo"], out)
            assert list(out[:n]) == list(py.values()), (c, got["tile"])
            assert py["n_slots"] >= 3 and py["bytes"] == got["smem"]
            n_checked += 1
    for st in _fused_stages(cfg):
        for b, frames, n_sm in SHAPES:
            v = frames * (cfg.upsample_rates[0] if st["u_in"] == 1 else 1)
            got = V.fused_launch_config(
                b, v, st["c_in"], st["c_out"], st["u"], st["u_in"], st["q0"], st["nq"],
                st["k_post"], ks, ds, cfg.resblock, max(ks), 2, n_sm,
            )
            args = got["args"]
            py = V.fused_tc_layout(st["c_in"], st["c_out"], st["u"], st["nq"], got["tile"], args[10], args[11])
            n = emu.emu_fused_tc_layout(V._int_array(args), len(args), out)
            assert list(out[:n]) == list(py.values()), (st, got["tile"])
            assert py["n_slots"] >= 3 and py["bytes"] == got["smem"]
            n_checked += 1
    assert n_checked >= 2 * len(SHAPES)


@pytest.mark.parametrize("k,n", [(128, 128), (64, 64), (32, 32), (48, 24), (16, 12), (160, 160)])
def test_kernel_weight_layout_gives_back_every_tap_slice(k, n):
    """tc_weight_layout's K-major 8 x 8 core matrices, read back by the
    byte offsets the wgmma descriptor uses (core matrices 128 bytes apart
    along N, Np*16 along K), are packed_w's tap slices, zero-padded."""
    rng = np.random.default_rng(k + n)
    w = torch.from_numpy(rng.standard_normal((3, 2, k, n)).astype(np.float32)).to(torch.bfloat16)
    lay = V.tc_weight_layout(w)
    kp, np_ = -(-k // 16) * 16, V._npad(-(-n // 16) * 16)
    assert lay.shape == (3, 2, kp // 8, np_ // 8, 8, 8) and lay.is_contiguous()
    flat = lay.reshape(3, 2, -1)
    kk, nn = np.meshgrid(np.arange(kp), np.arange(np_), indexing="ij")
    offset = (kk // 8) * (np_ * 16) + (nn // 8) * 128 + (nn % 8) * 16 + (kk % 8) * 2
    back = flat[:, :, torch.from_numpy(offset // 2)]
    assert torch.equal(back[:, :, :k, :n], w)
    assert not back[:, :, k:].float().any() and not back[:, :, :, n:].float().any()
    # one stage of step_rows input channels is one contiguous range
    step = V._step_rows(kp, np_)
    assert step in (16, 32, 64) and kp % step == 0 and step * np_ * 2 <= 16384


@pytest.mark.parametrize("quality", QUALITIES)
def test_float32_launch_config_fits_every_stage_of_the_split(quality):
    """The split is the one pinned above, and the float32 body fits every
    stage it sends to a kernel, at every launch shape."""
    cfg = ModelConfig.for_quality(quality, num_symbols=256)
    ks = tuple(cfg.resblock_kernel_sizes)
    ds = tuple(tuple(d) for d in cfg.resblock_dilation_sizes)
    start = G.tm_start_stage(cfg)
    assert (start, G.fused_suffix_start(cfg, start)) == SPLIT[quality]
    rb1 = cfg.resblock == "1"
    for c, u0 in _mrf_stages(cfg):
        for b, frames, n_sm in SHAPES:
            got = V.mrf_launch_config(b, c, frames * u0, ks, ds, cfg.resblock, max(ks), 4, n_sm)
            tile, halo = got["tile"], got["halo"]
            assert tile >= 16 and tile % 16 == 0 and V.mrf_tf32_fits(c, tile, halo, rb1)
            assert got["smem"] == V.mrf_tf32_layout(c, tile, halo, rb1)["bytes"] <= V.SMEM_LIMIT
    for st in _fused_stages(cfg):
        u_out = st["u"] * st["u_in"]
        for b, frames, n_sm in SHAPES:
            v = frames * (cfg.upsample_rates[0] if st["u_in"] == 1 else 1)
            got = V.fused_launch_config(
                b, v, st["c_in"], st["c_out"], st["u"], st["u_in"], st["q0"], st["nq"],
                st["k_post"], ks, ds, cfg.resblock, max(ks), 4, n_sm,
            )
            tile, halo, hpost = got["tile"], got["args"][10], got["args"][11]
            assert tile >= u_out and tile % u_out == 0
            assert V.fused_tf32_fits(st["c_in"], st["c_out"], st["u"], st["nq"], tile, halo, hpost, rb1)
            lay = V.fused_tf32_layout(st["c_in"], st["c_out"], st["u"], st["nq"], tile, halo, hpost, rb1)
            assert got["smem"] == lay["bytes"] <= V.SMEM_LIMIT


@pytest.mark.parametrize("quality", QUALITIES)
def test_float32_layout_mirrors_equal_the_c_layouts(emu, quality):
    cfg = ModelConfig.for_quality(quality, num_symbols=256)
    ks = tuple(cfg.resblock_kernel_sizes)
    ds = tuple(tuple(d) for d in cfg.resblock_dilation_sizes)
    rb1 = cfg.resblock == "1"
    out = (ctypes.c_longlong * 32)()
    n_checked = 0
    for c, u0 in _mrf_stages(cfg):
        for b, frames, n_sm in SHAPES:
            got = V.mrf_launch_config(b, c, frames * u0, ks, ds, cfg.resblock, max(ks), 4, n_sm)
            py = V.mrf_tf32_layout(c, got["tile"], got["halo"], rb1)
            n = emu.emu_mrf_tf32_layout(c, got["tile"], got["halo"], int(rb1), out)
            assert list(out[:n]) == list(py.values()), (c, got["tile"])
            assert py["n_slots"] >= 3 and py["bytes"] == got["smem"]
            n_checked += 1
    for st in _fused_stages(cfg):
        for b, frames, n_sm in SHAPES:
            v = frames * (cfg.upsample_rates[0] if st["u_in"] == 1 else 1)
            got = V.fused_launch_config(
                b, v, st["c_in"], st["c_out"], st["u"], st["u_in"], st["q0"], st["nq"],
                st["k_post"], ks, ds, cfg.resblock, max(ks), 4, n_sm,
            )
            args = got["args"]
            py = V.fused_tf32_layout(st["c_in"], st["c_out"], st["u"], st["nq"], got["tile"], args[10], args[11],
                                     rb1)
            n = emu.emu_fused_tf32_layout(V._int_array(args), len(args), int(rb1), out)
            assert list(out[:n]) == list(py.values()), (st, got["tile"])
            assert py["n_slots"] >= 3 and py["bytes"] == got["smem"]
            n_checked += 1
    assert n_checked >= 2 * len(SHAPES)


@pytest.mark.parametrize("k,n", [(128, 128), (64, 64), (32, 32), (48, 24), (16, 12), (160, 160)])
def test_float32_weight_layout_gives_back_every_tap_slice(k, n):
    """tf32_weight_layout's two planes, read back by the byte offsets the
    wgmma descriptor uses (K-major core matrices of 8 rows x 4 tf32, 128
    bytes apart along N, Np*16 along K), are tf32 patterns whose sum hi +
    lo is each tap slice's float32 weight within 2^-21 of it, zero-padded;
    a stage of step rows of both planes is one contiguous range each."""
    rng = np.random.default_rng(k + n)
    w = torch.from_numpy(rng.standard_normal((3, 2, k, n)).astype(np.float32))
    lay = V.tf32_weight_layout(w)
    kp, np_ = -(-k // 16) * 16, V._npad(-(-n // 16) * 16)
    assert lay.shape == (2, 3, 2, kp // 4, np_ // 8, 8, 4) and lay.is_contiguous()
    assert not (lay.view(torch.int32) & 0x1FFF).any()
    flat = lay.reshape(2, 3, 2, -1)
    kk, nn = np.meshgrid(np.arange(kp), np.arange(np_), indexing="ij")
    offset = (kk // 4) * (np_ * 16) + (nn // 8) * 128 + (nn % 8) * 16 + (kk % 4) * 4
    hi, lo = (flat[i][:, :, torch.from_numpy(offset // 4)].double() for i in (0, 1))
    back = hi + lo
    rel = ((back[:, :, :k, :n] - w.double()).abs() / w.double().abs()).max().item()
    assert rel <= 2.0**-21, rel
    assert not back[:, :, k:].any() and not back[:, :, :, n:].any()
    step = V._tf32_step_rows(kp, np_)
    assert step in (8, 16) and kp % step == 0 and 2 * step * np_ * 4 <= 16384


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_weights_of_an_inference_tensor_are_made_once(dtype):
    """tc_weights on weights made in torch.inference_mode (which keeps no
    version counter for them, as in prepare_tm called there): the layout
    of the dtype, made once; a tensor with a version counter is made
    again after an in-place change."""
    with torch.inference_mode():
        w = torch.randn((2, 3, 32, 24)).to(dtype)
        lay = V.tc_weights(w)
        assert V.tc_weights(w) is lay and torch.equal(lay, V.kernel_weight_layout(w))
    w = torch.randn((2, 3, 32, 24)).to(dtype)
    lay = V.tc_weights(w)
    w.add_(1)
    assert V.tc_weights(w) is not lay
