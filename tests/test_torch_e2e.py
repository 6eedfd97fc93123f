"""The port's encode -> latents -> vocode path against the JAX package,
on the CPU: synthesizer_encode + synthesizer_latents +
synthesizer_vocode on tiny single- and multi-speaker configs and on the
trained x-low voice (tests/data/voice_xlow_trained_fp16.npz, the medium
preset's 8-8-4, 256-channel generator at trained magnitudes), and infer
with its frame budget. The same duration and frame noise go to both
packages, and the integer durations match exactly. The JAX side decodes
with generator_apply, the port with its time-major generator.
"""

from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from piper_tpu.models.vits import model as JM
from piper_tpu_torch.models.vits import model as TM
from torch_parity import TINY, TINY_MS, close, jax_params, normal, port_params, t, tcfg

DATA = Path(__file__).parent / "data"


def _ids(rng, n_rows, lengths, num_symbols):
    """BOS, PAD-interspersed random ids, EOS; zero-padded rows."""
    rows = []
    for n in lengths:
        body = rng.integers(3, num_symbols, (n - 3) // 2)
        row = [1, 0] + [int(x) for s in body for x in (s, 0)] + [2]
        rows.append(row[:n] if len(row) >= n else row + [0] * (n - len(row)))
    ids = np.zeros((n_rows, max(lengths)), np.int32)
    for r, row in enumerate(rows):
        ids[r, : len(row)] = row
    return ids


def _e2e(tree, jcfg, ids, lens, sid, seed, atol):
    """encode -> latents -> vocode in both packages; returns the port's
    durations for further checks."""
    cfg = tcfg(jcfg)
    rng = np.random.default_rng(seed)
    dur_noise = normal(rng, ids.shape + (2,))
    enc_j = JM.synthesizer_encode(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(ids), jnp.asarray(lens), cfg=jcfg,
        noise_w_scale=0.8, length_scale=1.0, dur_noise=jnp.asarray(dur_noise),
        sid=None if sid is None else jnp.asarray(sid),
    )
    params = port_params(tree, jcfg)
    enc_t = TM.synthesizer_encode(
        params, t(ids).long(), t(lens), cfg=cfg, noise_w_scale=0.8, length_scale=1.0,
        dur_noise=t(dur_noise), sid=None if sid is None else t(sid),
    )
    np.testing.assert_array_equal(enc_t.durations.numpy(), np.asarray(enc_j.durations))
    close(enc_t.m_p, enc_j.m_p, atol=1e-4, what="m_p")
    close(enc_t.logs_p, enc_j.logs_p, atol=1e-4, what="logs_p")

    frames = np.asarray(enc_j.durations).sum(-1)
    nf = int(frames.max())
    frame_noise = normal(rng, (ids.shape[0], nf, jcfg.inter_channels))
    zj, mj = JM.synthesizer_latents(
        jax.tree.map(jnp.asarray, tree), enc_j, nf, cfg=jcfg, noise_scale=0.667,
        frame_noise=jnp.asarray(frame_noise),
    )
    zt, mt = TM.synthesizer_latents(params, enc_t, nf, cfg=cfg, noise_scale=0.667, frame_noise=t(frame_noise))
    close(zt, zj, atol=1e-4, what="z_p")
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
    ref = JM.synthesizer_vocode(jax.tree.map(jnp.asarray, tree), zj, mj, cfg=jcfg,
                                sid=None if sid is None else jnp.asarray(sid))
    got = TM.synthesizer_vocode(params, zt, mt, cfg=cfg, sid=None if sid is None else t(sid))
    u = jcfg.upsample_factor
    for i, f in enumerate(frames):
        close(got[i, : f * u], np.asarray(ref)[i, : f * u], atol=atol, rtol=0, what=f"audio row {i}")
    return enc_t.durations


@pytest.mark.parametrize("which", ["single", "multi"])
def test_encode_latents_vocode_tiny(which):
    cfg = TINY if which == "single" else TINY_MS
    tree = jax_params(cfg, 3)
    rng = np.random.default_rng(4)
    lens = np.array([21, 13, 5], np.int32)
    ids = _ids(rng, 3, lens, cfg.num_symbols)
    sid = np.array([2, 0, 1], np.int32) if cfg.num_speakers > 1 else None
    # float32 through 2 encoder layers, the SDP, 4 flows and the generator
    _e2e(tree, cfg, ids, lens, sid, seed=5, atol=1e-4)


def test_encode_latents_vocode_trained_xlow_voice():
    from piper_tpu.weights.native import load_native as jax_load
    from piper_tpu_torch.weights.native import load_native as torch_load

    path = DATA / "voice_xlow_trained_fp16.npz"
    tree, jcfg = jax_load(str(path))
    tree_t, cfg_t = torch_load(str(path))
    assert cfg_t == tcfg(jcfg)
    assert jcfg.upsample_rates == (8, 8, 4) and jcfg.upsample_initial_channel == 256
    rng = np.random.default_rng(6)
    lens = np.array([41, 27], np.int32)
    ids = _ids(rng, 2, lens, jcfg.num_symbols)
    durations = _e2e(tree, jcfg, ids, lens, None, seed=7, atol=2e-4)
    assert int(durations.sum(-1).min()) > 10  # trained durations, not a degenerate case


def test_infer_clamps_to_the_frame_budget_like_jax():
    """infer with max_frames below the longest row: overflowing rows lose
    their trailing phonemes in both packages alike."""
    tree = jax_params(TINY, 8)
    rng = np.random.default_rng(9)
    lens = np.array([25, 9], np.int32)
    ids = _ids(rng, 2, lens, TINY.num_symbols)
    dur_noise = normal(rng, ids.shape + (2,))
    max_frames = 30
    frame_noise = normal(rng, (2, max_frames, TINY.inter_channels))
    kw = dict(max_frames=max_frames, noise_scale=0.667, length_scale=1.0, noise_w_scale=0.8)
    ref, ref_len = JM.infer(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(ids), jnp.asarray(lens), cfg=TINY,
        dur_noise=jnp.asarray(dur_noise), frame_noise=jnp.asarray(frame_noise), **kw,
    )
    got, got_len = TM.infer(
        port_params(tree, TINY), t(ids).long(), t(lens), cfg=tcfg(TINY),
        dur_noise=t(dur_noise), frame_noise=t(frame_noise), **kw,
    )
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(ref_len))
    assert int(got_len.max()) == max_frames  # the budget did clamp
    u = TINY.upsample_factor
    for i, n in enumerate(np.asarray(ref_len)):
        close(got[i, : n * u], np.asarray(ref)[i, : n * u], atol=1e-4, rtol=0, what=f"row {i}")
