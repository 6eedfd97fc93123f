"""The port's time-major generator against the JAX package, on the CPU.

generator_tm_apply (plain kernel versions) against JAX's
generator_tm_apply with its Pallas kernels in interpret mode, and
against the reference-shaped generator_apply, on valid samples only
(past a row's end the time-major path leaves conv_post's tail, as in
tests/test_pallas_vocoder.py::test_generator_tm_matches_xla).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from piper_tpu.models.vits import generator as JG
from piper_tpu.ops import nn as JN
from piper_tpu_torch.models.vits import generator as TG
from torch_parity import TINY, close, jax_params, mask_np, normal, port_params, t, tcfg

# Resblock "1", rates 8-8-2-2: the high preset's generator shape, narrow.
TINY_HIGH = dataclasses.replace(
    TINY, resblock="1", resblock_kernel_sizes=(3, 7), resblock_dilation_sizes=((1, 3), (1, 3)),
    upsample_rates=(8, 8, 2, 2), upsample_kernel_sizes=(16, 16, 4, 4),
)


def test_tconv_tm_matches_conv1d_transpose():
    rng = np.random.default_rng(3)
    for k, u, ci, co in [(16, 8, 12, 8), (8, 4, 6, 4), (4, 2, 5, 3)]:
        kern, bias, x = normal(rng, (k, ci, co)), normal(rng, (co,)), normal(rng, (2, 20, ci))
        ref = JN.conv1d_transpose(jnp.asarray(x), jnp.asarray(kern), jnp.asarray(bias),
                                  stride=u, padding=(k - u) // 2)
        q0, used, idx = TG._tm_phase_plan(k, u)
        w = np.zeros(used.shape + (ci, co), np.float32)
        for p in range(used.shape[0]):
            for qi in range(used.shape[1]):
                if used[p, qi]:
                    w[p, qi] = kern[idx[p, qi]]
        got = TG._tconv_tm(t(x).transpose(1, 2), t(w), q0, used, t(bias))
        close(got.transpose(1, 2), ref, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("cfg", [TINY, TINY_HIGH], ids=["medium-shape", "high-shape"])
def test_generator_tm_matches_jax(cfg):
    tree = jax_params(cfg, 0)
    b, tf = 2, 24
    lens = np.array([24, 17], np.int32)
    m = mask_np(lens, tf)
    z = normal(np.random.default_rng(1), (b, tf, cfg.inter_channels)) * m
    jdec = jax.tree.map(jnp.asarray, tree["dec"])
    ref_tm = JG.generator_tm_apply(
        jdec, JG.prepare_tm(jdec, cfg, dtype=jnp.float32), jnp.asarray(z), jnp.asarray(lens),
        cfg=cfg, interpret=True,
    )
    ref = JG.generator_apply(jdec, jnp.asarray(z), jnp.asarray(m), cfg=cfg)
    dec = port_params(tree, cfg)["dec"]
    got = TG.generator_tm_apply(dec, TG.prepare_tm(dec, tcfg(cfg), torch.float32), t(z), t(lens), cfg=tcfg(cfg))
    plain = TG.generator_apply(dec, t(z), t(m), cfg=tcfg(cfg))
    u = cfg.upsample_factor
    assert tuple(got.shape) == (b, tf * u)
    for i in range(b):
        n = int(lens[i]) * u
        close(got[i, :n], np.asarray(ref_tm)[i, :n], what=f"row {i} vs JAX time-major")
        close(got[i, :n], np.asarray(ref)[i, :n], what=f"row {i} vs JAX generator_apply")
    close(plain, ref, what="generator_apply")
