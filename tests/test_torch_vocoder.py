"""The vocoder kernels' plain versions (piper_tpu_torch/ops/cuda/vocoder.py)
against the JAX package's Pallas kernels run in interpret mode on the CPU.

The grids follow tests/test_pallas_vocoder.py at smaller lengths:
mrf_fused over the medium and high presets' resblocks with tile-
divisible and ragged lengths; fused_upsample_mrf over resblock "1" and
"2", post on and off, ragged rows; and two chained fused stages. On a
CPU tensor each CUDA wrapper takes its plain version, and that is what
runs here (the kernels run on the card, in chip_smoke.py). Tolerances
are piper_tpu's: atol 2e-5 / rtol 1e-4 for mrf_fused, atol 2e-4 for
fused stages.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from piper_tpu.config import ModelConfig
from piper_tpu.models.vits import generator as JG
from piper_tpu.ops.pallas import vocoder as JV
from piper_tpu_torch.models.vits import generator as TG
from piper_tpu_torch.ops.cuda import vocoder as TV
from torch_parity import close, np_tree, t

RB = {
    "1": ((3, 7, 11), ((1, 3, 5), (1, 3, 5), (1, 3, 5))),
    "2": ((3, 5, 7), ((1, 2), (2, 6), (3, 12))),
}


def _blocks(seed, c, ks, ds, rb):
    rng = jax.random.PRNGKey(seed)
    return np_tree([
        JG.init_resblock(jax.random.fold_in(rng, j), c, ks[j], ds[j], rb)
        for j in range(len(ks))
    ])


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_torch(v) for v in tree]
    return t(tree)


@pytest.mark.parametrize(
    "quality,c,t_len",
    [("medium", 32, 300), ("medium", 64, 256), ("high", 32, 300)],
)
def test_mrf_fused_plain_matches_pallas(quality, c, t_len):
    """256 is a whole number of 128-sample Pallas tiles, 300 is not."""
    cfg = ModelConfig.for_quality(quality, num_symbols=64)
    ks, ds, rb = cfg.resblock_kernel_sizes, cfg.resblock_dilation_sizes, cfg.resblock
    blocks = _blocks(0, c, ks, ds, rb)
    jw, jb = JV.pack_stage_weights(blocks, ks, ds, rb)
    tw, tb = TV.pack_stage_weights(_to_torch(blocks), ks, ds, rb)
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))

    rng = np.random.default_rng(0)
    lengths = np.array([t_len, t_len - 97, 5], np.int32)
    x = rng.standard_normal((3, c, t_len)).astype(np.float32) * 0.5
    x *= np.arange(t_len)[None, None, :] < lengths[:, None, None]
    ref = JV.mrf_fused(
        jnp.asarray(x), jnp.asarray(lengths), jw, jb, kernel_sizes=ks,
        dilation_sizes=ds, resblock_type=rb, t_tile=128, interpret=True,
    )
    before = TV.mrf_fused.launches
    got = TV.mrf_fused(t(x), t(lengths), tw, tb, kernel_sizes=ks, dilation_sizes=ds, resblock_type=rb)
    assert TV.mrf_fused.launches == before  # a CPU tensor takes the plain version
    close(got, ref)


def _stage(seed, u, k, c_in, c_out, rb):
    ks, ds = RB[rb] if rb == "2" else ((3, 7), ((1, 3), (1, 3)))
    r1, r2, r3 = jax.random.split(jax.random.PRNGKey(seed), 3)
    wt_full = np.asarray(0.1 * jax.random.normal(r1, (k, c_in, c_out)))
    q0, used, idx = JG._tm_phase_plan(k, u)
    wt = np.zeros((u, used.shape[1], c_in, c_out), np.float32)
    for p in range(u):
        for qi in range(used.shape[1]):
            if used[p, qi]:
                wt[p, qi] = wt_full[idx[p, qi]]
    blocks = _blocks(seed + 1, c_out, ks, ds, rb)
    wm, bm = JV.pack_stage_weights(blocks, ks, ds, rb)
    return dict(
        ks=ks, ds=ds, rb=rb, u=u, q0=q0, wt=wt,
        bt=np.asarray(0.1 * jax.random.normal(r2, (c_out,))),
        wm=np.asarray(wm), bm=np.asarray(bm),
        wpost=np.asarray(0.3 * jax.random.normal(r3, (7, c_out, 1))),
    )


def _run(s, x, lengths, *, u_in, post, jax_side):
    kw = dict(u=s["u"], u_in=u_in, q0=s["q0"], kernel_sizes=s["ks"],
              dilation_sizes=s["ds"], resblock_type=s["rb"], post=post)
    args = [s[n] for n in ("wt", "bt", "wm", "bm")] + [s["wpost"] if post else None]
    if jax_side:
        out = JV.fused_upsample_mrf(
            jnp.asarray(x), jnp.asarray(lengths), *[None if a is None else jnp.asarray(a) for a in args],
            t_tile=128, interpret=True, **kw,
        )
        return np.asarray(out)[:, :, : x.shape[2]]  # the Pallas output is padded to its tile
    return TV.fused_upsample_mrf(t(x), t(lengths), *[None if a is None else t(a) for a in args], **kw)


@pytest.mark.parametrize(
    "u,k,c_in,c_out,rb,post,ragged",
    [
        (4, 8, 64, 32, "2", True, False),
        (8, 16, 32, 16, "2", False, True),
        (2, 4, 32, 16, "1", True, False),
        (4, 8, 48, 24, "2", True, True),
    ],
)
def test_fused_upsample_mrf_plain_matches_pallas(u, k, c_in, c_out, rb, post, ragged):
    v = 64
    s = _stage(3, u, k, c_in, c_out, rb)
    lengths = np.array([v * u, (v - 7) * u - 3, 4] if ragged else [v * u] * 3, np.int32)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, c_in, v)).astype(np.float32)
    x *= np.arange(v)[None, None, :] < (lengths // u)[:, None, None]
    ref = _run(s, x, lengths, u_in=1, post=post, jax_side=True)
    got = _run(s, x, lengths, u_in=1, post=post, jax_side=False)
    assert tuple(got.shape) == ref.shape
    close(got, ref, atol=2e-4, rtol=0)


@pytest.mark.parametrize("rb", ["1", "2"])
def test_fused_stage_chain_plain_matches_pallas(rb):
    """Stage u=8 -> phase planes -> stage u=4 with u_in=8 and conv_post."""
    v = 40
    frames = np.array([40, 17], np.int32)
    s1, s2 = _stage(5, 8, 16, 48, 32, rb), _stage(7, 4, 8, 32, 16, rb)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 48, v)).astype(np.float32)
    x *= np.arange(v)[None, None, :] < frames[:, None, None]
    outs = []
    for jax_side in (True, False):
        y = _run(s1, x, frames * 8, u_in=1, post=False, jax_side=jax_side)
        y = np.ascontiguousarray(y) if jax_side else y
        outs.append(_run(s2, y, frames * 32, u_in=8, post=True, jax_side=jax_side))
    close(outs[1], outs[0], atol=2e-4, rtol=0)


def test_wrapper_raises_off_cpu_and_cuda():
    x = torch.zeros((1, 8, 16), device="meta")
    w, b = torch.zeros((2, 3, 8, 8)), torch.zeros((2, 8, 1))
    with pytest.raises(ValueError, match="cuda or cpu"):
        TV.mrf_fused(x, torch.zeros(1, dtype=torch.int32), w, b, kernel_sizes=(3,),
                     dilation_sizes=((1, 2),), resblock_type="2")


def test_split_runs_both_kernels_on_the_medium_voice():
    """Hopper's stage split (shared memory, not VMEM) keeps the TPU's
    bf16 medium split in both precisions: stage 0 in mrf_fused, stages
    1-2 chained in fused_upsample_mrf."""
    from piper_tpu_torch.config import ModelConfig as TModelConfig

    cfg = TModelConfig.for_quality("medium", num_symbols=64)
    start = TG.tm_start_stage(cfg)
    assert (start, TG.fused_suffix_start(cfg, start)) == (0, 1)
    jcfg = ModelConfig.for_quality("medium", num_symbols=64)
    assert JG._tm_start_stage(jcfg) == 0
    assert JG._fused_suffix_start(jcfg, 0, esize=2) == 1
