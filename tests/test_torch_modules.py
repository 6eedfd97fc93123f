"""The PyTorch port's modules against their JAX counterparts, on the CPU.

The weight bridge, ops/nn, the VITS layers, the text encoder, the
rational-quadratic spline, the duration predictors, the duration
expansion and the reverse flow: the same numpy inputs and parameters go
through both packages. Tolerance: atol 2e-5 / rtol 1e-4 (piper_tpu's
module-level tolerance) unless a test says otherwise.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from piper_tpu.models.vits import duration as JD
from piper_tpu.models.vits import encoder as JE
from piper_tpu.models.vits import flow as JF
from piper_tpu.models.vits import layers as JL
from piper_tpu.ops import duration as JOD
from piper_tpu.ops import nn as JN
from piper_tpu.ops import spline as JS
from piper_tpu_torch.models.vits import duration as TD
from piper_tpu_torch.models.vits import encoder as TE
from piper_tpu_torch.models.vits import flow as TF
from piper_tpu_torch.models.vits import layers as TL
from piper_tpu_torch.ops import duration as TOD
from piper_tpu_torch.ops import nn as TN
from piper_tpu_torch.ops import spline as TS
from piper_tpu_torch.weights.bridge import iter_leaves, params_from_jax
from torch_parity import TINY, TINY_MS, close, jax_params, mask_np, normal, port_params, t, tcfg


@pytest.fixture(scope="module")
def trees():
    return {"single": jax_params(TINY, 0), "multi": jax_params(TINY_MS, 1)}


# ---------------------------------------------------------------------------
# weights/bridge.py
# ---------------------------------------------------------------------------


def test_bridge_keeps_every_leaf(trees):
    tree = trees["multi"]
    got = dict(iter_leaves(port_params(tree, TINY_MS)))
    ref = dict(iter_leaves(tree))
    assert got.keys() == ref.keys()
    for name, leaf in ref.items():
        assert tuple(got[name].shape) == leaf.shape, name
        np.testing.assert_array_equal(got[name].numpy(), leaf, err_msg=name)


def test_bridge_casts_fp16_voice_and_keeps_duration_f32(trees):
    tree = {k: _fp16(v) for k, v in trees["single"].items()}
    bf = params_from_jax(tree, tcfg(TINY), "cpu", torch.bfloat16)
    assert bf["dec"]["ups"][0]["w"].dtype == torch.bfloat16
    assert bf["dp"]["pre"]["w"].dtype == torch.float32  # duration math stays f32
    f32 = params_from_jax(tree, tcfg(TINY), "cpu", torch.float32)
    np.testing.assert_array_equal(
        f32["flow"]["layers"][0]["pre"]["w"].numpy(),
        tree["flow"]["layers"][0]["pre"]["w"].astype(np.float32),
    )


def _fp16(tree):
    if isinstance(tree, dict):
        return {k: _fp16(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_fp16(v) for v in tree]
    return tree.astype(np.float16) if tree.dtype.kind == "f" else tree


def test_bridge_rejects_a_tree_of_another_config(trees):
    import dataclasses

    other = dataclasses.replace(TINY, upsample_initial_channel=128)
    with pytest.raises(ValueError, match="dec.ups.0.w"):
        params_from_jax(trees["single"], tcfg(other), "cpu")


def test_conv_transpose_flip_matches_torch_module():
    """The tree's pre-flipped (k, in, out) kernel, undone for
    nn.ConvTranspose1d, gives JAX's conv1d_transpose."""
    rng = np.random.default_rng(0)
    k, u, ci, co = 16, 8, 6, 4
    kern, bias, x = normal(rng, (k, ci, co)), normal(rng, (co,)), normal(rng, (2, 9, ci))
    ref = JN.conv1d_transpose(jnp.asarray(x), jnp.asarray(kern), jnp.asarray(bias),
                              stride=u, padding=(k - u) // 2)
    mod = torch.nn.ConvTranspose1d(ci, co, k, stride=u, padding=(k - u) // 2)
    with torch.no_grad():
        mod.weight.copy_(TN.torch_conv_transpose_weight(t(kern)))
        mod.bias.copy_(t(bias))
        got = mod(t(x).transpose(1, 2)).transpose(1, 2)
    close(got, ref)
    close(TN.conv1d_transpose(t(x), t(kern), t(bias), stride=u, padding=(k - u) // 2), ref)


# ---------------------------------------------------------------------------
# ops/nn.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "padding,dilation,groups", [(1, 1, 1), (4, 2, 1), ((2, 0), 1, 1), (3, 3, 6)]
)
def test_conv1d(padding, dilation, groups):
    rng = np.random.default_rng(1)
    x, w, b = normal(rng, (2, 13, 6)), normal(rng, (3, 6 // groups, 6)), normal(rng, (6,))
    ref = JN.conv1d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), padding=padding,
                    dilation=dilation, groups=groups)
    close(TN.conv1d(t(x), t(w), t(b), padding=padding, dilation=dilation, groups=groups), ref)


def test_pointwise_ops():
    rng = np.random.default_rng(2)
    x, g, b = normal(rng, (2, 7, 8), 3.0), normal(rng, (8,)), normal(rng, (8,))
    close(TN.layer_norm(t(x), t(g), t(b)), JN.layer_norm(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b)))
    close(TN.leaky_relu(t(x), 0.1), JN.leaky_relu(jnp.asarray(x), 0.1))
    close(TN.gelu(t(x)), JN.gelu(jnp.asarray(x)))
    gate = normal(rng, (2, 7, 8))
    close(TN.fused_gated_activation(t(x), t(gate)),
          JN.fused_gated_activation(jnp.asarray(x), jnp.asarray(gate)))
    lens = np.array([7, 3], np.int32)
    np.testing.assert_array_equal(
        TN.sequence_mask(t(lens), 9).numpy(), np.asarray(JN.sequence_mask(jnp.asarray(lens), 9))
    )


# ---------------------------------------------------------------------------
# models/vits/layers.py
# ---------------------------------------------------------------------------


def test_wn_with_speaker(trees):
    cfg = TINY_MS
    jp = trees["multi"]["flow"]["layers"][0]["enc"]
    tp = port_params(trees["multi"], cfg)["flow"]["layers"][0]["enc"]
    rng = np.random.default_rng(3)
    m = mask_np([11, 6], 11)
    x, g = normal(rng, (2, 11, cfg.hidden_channels)) * m, normal(rng, (2, cfg.gin_channels))
    kw = dict(kernel_size=cfg.flow_kernel_size, dilation_rate=1)
    ref = JL.wn_apply(jp, jnp.asarray(x), jnp.asarray(m), g=jnp.asarray(g), **kw)
    close(TL.wn_apply(tp, t(x), t(m), g=t(g), **kw), ref)


def test_ddsconv_dense_affine(trees):
    jp = trees["single"]["dp"]
    tp = port_params(trees["single"], TINY)["dp"]
    rng = np.random.default_rng(4)
    m = mask_np([10, 4], 10)
    x, g = normal(rng, (2, 10, 32)), normal(rng, (2, 10, 32))
    ref = JL.ddsconv_apply(jp["convs"], jnp.asarray(x), jnp.asarray(m), kernel_size=3, g=jnp.asarray(g))
    close(TL.ddsconv_apply(tp["convs"], t(x), t(m), kernel_size=3, g=t(g)), ref)
    close(TL.dense(tp["pre"], t(x)), JL.dense(jp["pre"], jnp.asarray(x)))
    close(TL.conv(tp["convs"]["convs_sep"][0], t(x), padding=1, groups=32),
          JL.conv(jp["convs"]["convs_sep"][0], jnp.asarray(x), padding=1, groups=32))
    close(TL.flip_channels(t(x)), JL.flip_channels(jnp.asarray(x)))
    aff = {"m": normal(rng, (2,)), "logs": normal(rng, (2,))}
    z = normal(rng, (2, 10, 2))
    jaff = {k: jnp.asarray(v) for k, v in aff.items()}
    taff = {k: t(v) for k, v in aff.items()}
    close(TL.elementwise_affine(taff, t(z), t(m), reverse=True),
          JL.elementwise_affine(jaff, jnp.asarray(z), jnp.asarray(m), reverse=True))
    y_t, ld_t = TL.elementwise_affine(taff, t(z), t(m), reverse=False)
    y_j, ld_j = JL.elementwise_affine(jaff, jnp.asarray(z), jnp.asarray(m), reverse=False)
    close(y_t, y_j)
    close(ld_t, ld_j)


# ---------------------------------------------------------------------------
# models/vits/encoder.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("which", ["single", "multi"])
def test_text_encoder(trees, which):
    cfg = TINY if which == "single" else TINY_MS
    tree = trees[which]
    rng = np.random.default_rng(5)
    lens = np.array([17, 9, 1], np.int32)
    ids = rng.integers(0, cfg.num_symbols, (3, 17)).astype(np.int32) * (
        np.arange(17)[None] < lens[:, None]
    )
    m = mask_np(lens, 17)
    ref = JE.text_encoder_apply(tree["enc_p"], jnp.asarray(ids), jnp.asarray(m), cfg=cfg)
    got = TE.text_encoder_apply(port_params(tree, cfg)["enc_p"], t(ids).long(), t(m), cfg=tcfg(cfg))
    for g_, r_, what in zip(got, ref, ("x", "m_p", "logs_p")):
        close(g_, r_, atol=1e-4, what=what)  # 2 attention layers of float32 sums


# ---------------------------------------------------------------------------
# ops/spline.py, models/vits/duration.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("inverse", [False, True])
def test_rational_quadratic_spline(inverse):
    rng = np.random.default_rng(6)
    x = normal(rng, (3, 11, 1), 3.0)  # some inputs fall outside the tails
    uw, uh, ud = normal(rng, (3, 11, 1, 10)), normal(rng, (3, 11, 1, 10)), normal(rng, (3, 11, 1, 9))
    ref = JS.rational_quadratic_spline(*map(jnp.asarray, (x, uw, uh, ud)), inverse=inverse, tail_bound=5.0)
    got = TS.rational_quadratic_spline(*map(t, (x, uw, uh, ud)), inverse=inverse, tail_bound=5.0)
    close(got[0], ref[0], what="outputs")
    close(got[1], ref[1], what="logabsdet")


def _nonzero_proj(tree, rng):
    """The JAX initialiser zeroes the conv flows' projections (the flow
    starts as the identity); give them values so the spline is used."""
    tree = jax_tree_copy(tree)
    for cf in tree["dp"]["flows"]["conv_flows"]:
        cf["proj"]["w"] = normal(rng, cf["proj"]["w"].shape, 0.3)
        cf["proj"]["b"] = normal(rng, cf["proj"]["b"].shape, 0.3)
    return tree


def jax_tree_copy(tree):
    if isinstance(tree, dict):
        return {k: jax_tree_copy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [jax_tree_copy(v) for v in tree]
    return np.array(tree)


@pytest.mark.parametrize("which", ["single", "multi"])
def test_sdp_reverse(trees, which):
    cfg = TINY if which == "single" else TINY_MS
    rng = np.random.default_rng(7)
    tree = _nonzero_proj(trees[which], rng)
    lens = np.array([12, 5], np.int32)
    m = mask_np(lens, 12)
    x = normal(rng, (2, 12, cfg.hidden_channels)) * m
    noise = normal(rng, (2, 12, 2))
    g = normal(rng, (2, cfg.gin_channels)) if cfg.gin_channels else None
    ref = JD.sdp_reverse(tree["dp"], jnp.asarray(x), jnp.asarray(m), cfg=cfg, noise_w=0.8,
                         noise=jnp.asarray(noise), g=None if g is None else jnp.asarray(g))
    got = TD.sdp_reverse(port_params(tree, cfg)["dp"], t(x), t(m), cfg=tcfg(cfg), noise_w=0.8,
                         noise=t(noise), g=None if g is None else t(g))
    close(got, ref)


def test_conv_flow_forward(trees):
    rng = np.random.default_rng(8)
    tree = _nonzero_proj(trees["single"], rng)
    m = mask_np([9, 4], 9)
    z, h = normal(rng, (2, 9, 2)) * m, normal(rng, (2, 9, 32))
    cf_j, cf_t = tree["dp"]["flows"]["conv_flows"][1], port_params(tree, TINY)["dp"]["flows"]["conv_flows"][1]
    y_j, ld_j = JD.conv_flow_apply(cf_j, jnp.asarray(z), jnp.asarray(m), kernel_size=3, g=jnp.asarray(h))
    y_t, ld_t = TD.conv_flow_apply(cf_t, t(z), t(m), kernel_size=3, g=t(h))
    close(y_t, y_j)
    close(ld_t, ld_j, atol=1e-4)


def test_deterministic_duration_predictor():
    import dataclasses

    cfg = dataclasses.replace(TINY_MS, use_sdp=False)
    tree = jax_params(cfg, 2)
    rng = np.random.default_rng(9)
    m = mask_np([8, 3], 8)
    x, g = normal(rng, (2, 8, 32)) * m, normal(rng, (2, 16))
    ref = JD.dp_apply(tree["dp"], jnp.asarray(x), jnp.asarray(m), cfg=cfg, g=jnp.asarray(g))
    close(TD.dp_apply(port_params(tree, cfg)["dp"], t(x), t(m), cfg=tcfg(cfg), g=t(g)), ref)


# ---------------------------------------------------------------------------
# ops/duration.py, models/vits/flow.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("offset", [0, 5])
def test_expand_by_duration(offset):
    rng = np.random.default_rng(10)
    vals = normal(rng, (2, 6, 4))
    dur = np.array([[2, 0, 3, 1, 4, 0], [1, 1, 1, 0, 0, 0]], np.int32)
    ref, ref_m = JOD.expand_by_duration(jnp.asarray(vals), jnp.asarray(dur), 12, offset)
    got, got_m = TOD.expand_by_duration(t(vals), t(dur), 12, offset)
    close(got, ref)
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(ref_m))


@pytest.mark.parametrize("which,reverse", [("single", True), ("multi", True), ("multi", False)])
def test_flow(trees, which, reverse):
    cfg = TINY if which == "single" else TINY_MS
    rng = np.random.default_rng(11)
    tree = jax_tree_copy(trees[which])
    for layer in tree["flow"]["layers"]:  # the initialiser zeroes post
        layer["post"]["w"] = normal(rng, layer["post"]["w"].shape, 0.1)
    m = mask_np([14, 6], 14)
    z = normal(rng, (2, 14, cfg.inter_channels)) * m
    g = normal(rng, (2, cfg.gin_channels)) if cfg.gin_channels else None
    ref = JF.flow_apply(tree["flow"], jnp.asarray(z), jnp.asarray(m), cfg=cfg,
                        g=None if g is None else jnp.asarray(g), reverse=reverse)
    got = TF.flow_apply(port_params(tree, cfg)["flow"], t(z), t(m), cfg=tcfg(cfg),
                        g=None if g is None else t(g), reverse=reverse)
    close(got, ref, atol=5e-5)  # 4 coupling layers of 4-layer WN stacks
