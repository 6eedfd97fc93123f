"""Shared helpers of the tests that hold the PyTorch port against the JAX
package (tests/test_torch_*.py): small configurations, one parameter
tree made by the JAX initialisers and handed to both packages as numpy,
and the conversions between them.

Tolerances start from piper_tpu's own tests: atol 2e-5 / rtol 1e-4 at
module level, 2e-4 for fused vocoder stages.
"""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
import torch

from piper_tpu.config import AudioConfig, ModelConfig
from piper_tpu_torch.config import AudioConfig as TAudioConfig
from piper_tpu_torch.config import ModelConfig as TModelConfig

ATOL, RTOL = 2e-5, 1e-4

# One intra-op thread per test process: the suite runs six xdist workers
# on eight cores, and with conftest.py's OMP_NUM_THREADS=4 each worker's
# PyTorch ran four, 24 threads in all; tests/test_torch_*.py took 928 s
# under -n 6 that way and 265 s with one thread each (CHANGES.md, PR 16).
# An xdist worker imports every test module when it collects, so this
# sets it in every worker.
torch.set_num_threads(1)

# The medium preset's generator shape (rates 8-8-4, kernels 16-16-8,
# resblock "2" with kernels 3-5-7) at narrow widths.
TINY = ModelConfig(
    num_symbols=64, inter_channels=32, hidden_channels=32, filter_channels=64,
    n_heads=2, n_layers=2, upsample_initial_channel=64,
    audio=AudioConfig(sample_rate=16000),
)
TINY_MS = dataclasses.replace(TINY, num_speakers=3, gin_channels=16)
# VITS2 (ModelConfig.vits2's flags) with three speakers, so both the flow's
# attention and the speaker-conditioned text encoder are on; and the
# MB-iSTFT vocoder (ModelConfig.mb_istft's 4-4 stack, 4 bands, n_fft 16).
TINY_VITS2 = dataclasses.replace(
    TINY_MS, flow_transformer=True, use_dur_disc=True, mas_noise=True,
    speaker_cond_encoder=True,
)
TINY_MB = dataclasses.replace(
    TINY, vocoder="mb_istft", upsample_rates=(4, 4), upsample_kernel_sizes=(8, 8),
)


def tcfg(cfg: ModelConfig) -> TModelConfig:
    """The port's copy of a JAX ModelConfig."""
    d = dataclasses.asdict(cfg)
    d["audio"] = TAudioConfig(**d["audio"])
    return TModelConfig(**d)


def np_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a), tree)


def jax_params(cfg: ModelConfig, seed: int = 0):
    from piper_tpu.models.vits.model import init_synthesizer_params

    return np_tree(init_synthesizer_params(jax.random.PRNGKey(seed), cfg))


def perturb_flow_post(tree, seed: int = 1, scale: float = 0.05):
    """The tree with every coupling layer's `post` perturbed (numpy,
    seeded), as tests/test_vits2.py:49-65 perturbs the flow: `post` is
    zero-initialised, so with random weights the flow's attention would
    change nothing and no test could see it."""
    rng = np.random.default_rng(seed)
    out = dict(tree)
    out["flow"] = {"layers": []}
    for layer in tree["flow"]["layers"]:
        layer = dict(layer)
        layer["post"] = {k: (v + scale * rng.standard_normal(v.shape)).astype(np.float32)
                         for k, v in layer["post"].items()}
        out["flow"]["layers"].append(layer)
    return out


def port_params(tree, cfg: ModelConfig, dtype=torch.float32):
    from piper_tpu_torch.weights.bridge import params_from_jax

    return params_from_jax(tree, tcfg(cfg), "cpu", dtype)


def t(a, dtype=None) -> torch.Tensor:
    out = torch.from_numpy(np.array(a))  # a writable copy
    return out if dtype is None else out.to(dtype)


def close(got, ref, atol=ATOL, rtol=RTOL, what=""):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(ref, np.float32), atol=atol, rtol=rtol, err_msg=what)


def normal(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def mask_np(lengths, t):
    return (np.arange(t)[None, :] < np.asarray(lengths)[:, None]).astype(np.float32)[..., None]
