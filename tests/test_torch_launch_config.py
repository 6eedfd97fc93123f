"""Launch configuration of the bf16 tensor-core kernels, on the CPU.

Every preset's stage split is decided on the float32 CUDA-core layout
(models/vits/generator.py: tm_start_stage, fused_suffix_start at
SPLIT_ESIZE). Both precisions run the same split, so the bf16 bodies must
then fit every stage that split gives them: mrf_fused a tile of at least
16 positions, fused_upsample_mrf one of at least one output frame, within
the 232,448 bytes of shared memory one block may use.
"""

import pytest

from piper_tpu_torch.config import ModelConfig
from piper_tpu_torch.models.vits import generator as G
from piper_tpu_torch.ops.cuda import vocoder as V


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
