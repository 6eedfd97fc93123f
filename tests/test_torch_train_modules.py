"""The port's training modules against the JAX package on the CPU, at
the tests/torch_parity.py widths, with the same numpy weights handed to
both through the weight bridge: the spectrogram and mel ops, MAS, the
posterior encoder, the discriminators (period and scale, and VITS2's
duration discriminator), the SDP's training NLL, and every loss. Each
compares the forward values and the gradients of a random projection
of the output (jax.grad against torch.autograd) with respect to the
inputs and every parameter.

Bounds: atol 2e-5 / rtol 1e-4 (torch_parity.ATOL, RTOL) unless stated:
- the log-mel ops: values 1e-4, gradients 5e-4 relative to the largest
  (an FFT of 1024 points summed in another order, then a log);
- the discriminators: values 1e-4 relative to the largest (five float32
  convolutions of up to 1024 channels and 41 taps, summed in another
  order), gradients 1e-3 relative to the largest: the feature loss's
  |fmap_r - fmap_g| passes the sign of each difference back, and a
  difference near zero may take the other sign in the other package;
- the posterior encoder: gradients 1e-4 relative to the largest (16 WN
  layers);
- MAS: equal paths, exactly.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from piper_tpu.models.vits import discriminator as JDS
from piper_tpu.models.vits import duration as JD
from piper_tpu.models.vits import posterior as JQ
from piper_tpu.ops import mas as JMAS
from piper_tpu.ops import stft as JSTFT
from piper_tpu.train import losses as JLS
from piper_tpu_torch.models.vits import discriminator as TDS
from piper_tpu_torch.models.vits import duration as TD
from piper_tpu_torch.models.vits import posterior as TQ
from piper_tpu_torch.ops import mas as TMAS
from piper_tpu_torch.ops import stft as TSTFT
from piper_tpu_torch.train import losses as TLS
from piper_tpu_torch.weights.bridge import iter_leaves
from torch_parity import ATOL, RTOL, TINY, TINY_MS, mask_np, normal, np_tree, tcfg

A = TINY.audio
MEL = dict(sample_rate=A.sample_rate, n_fft=A.filter_length, n_mels=A.mel_channels,
           fmin=A.mel_fmin, fmax=A.mel_fmax)


def _tree_t(tree):
    """A numpy tree as float32 leaf tensors that require grad."""
    if isinstance(tree, dict):
        return {k: _tree_t(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_t(v) for v in tree]
    return torch.tensor(np.asarray(tree, np.float32), requires_grad=True)


def _flat(tree) -> dict:
    return dict(iter_leaves(tree))


def _rel_close(got, ref, rel, what):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    scale = float(np.abs(ref).max()) or 1.0
    err = float(np.abs(got - ref).max())
    assert err <= rel * scale, f"{what}: max error {err} > {rel} x {scale}"


def _check_grads(jfn, tfn, args_np, *, atol=ATOL, rtol=RTOL, rel=None, what=""):
    """jfn(*args) and tfn(*args) return scalars: equal values, and equal
    gradients with respect to every argument (numpy arrays or trees of
    them), leaf by leaf."""
    ref, jgrads = jax.jit(jax.value_and_grad(jfn, argnums=tuple(range(len(args_np)))))(
        *jax.tree.map(jnp.asarray, args_np))
    targs = [_tree_t(a) for a in args_np]
    got = tfn(*targs)
    tgrads = torch.autograd.grad(got, [t for a in targs for _, t in iter_leaves(a)], allow_unused=True)
    np.testing.assert_allclose(got.item(), float(ref), rtol=1e-5, err_msg=f"{what} value")
    it = iter(tgrads)
    for i, (jg, a) in enumerate(zip(jgrads, targs)):
        jflat = _flat(np_tree(jg))
        for name, t in iter_leaves(a):
            g = next(it)
            g = torch.zeros_like(t) if g is None else g
            label = f"{what} grad arg {i} {name}"
            if rel is not None:
                _rel_close(g, jflat[name], rel, label)
            else:
                np.testing.assert_allclose(g.numpy(), jflat[name], atol=atol, rtol=rtol, err_msg=label)


def _audio(seed, b, t):
    rng = np.random.default_rng(seed)
    return (0.3 * np.sin(np.arange(t) * 0.05 * (1 + np.arange(b)[:, None]))
            + 0.1 * rng.standard_normal((b, t))).astype(np.float32)


# ---------------------------------------------------------------------------
# STFT / mel
# ---------------------------------------------------------------------------


def test_mel_filterbank_equals_jax():
    np.testing.assert_array_equal(TSTFT.mel_filterbank(**MEL), JSTFT.mel_filterbank(**MEL))
    np.testing.assert_array_equal(TSTFT.mel_filterbank(22050, 1024, 80, 0.0, 8000.0),
                                  JSTFT.mel_filterbank(22050, 1024, 80, 0.0, 8000.0))


def test_spectrogram_and_mel_values():
    y = _audio(0, 2, 5000)
    kw = dict(n_fft=A.filter_length, hop_length=A.hop_length, win_length=A.win_length)
    spec_t = TSTFT.spectrogram(torch.from_numpy(y), **kw)
    spec_j = np.asarray(JSTFT.spectrogram(jnp.asarray(y), **kw))
    assert spec_t.shape == spec_j.shape
    _rel_close(spec_t, spec_j, 1e-5, "spectrogram")
    mel_t = TSTFT.mel_spectrogram(torch.from_numpy(y), hop_length=A.hop_length,
                                  win_length=A.win_length, **MEL)
    mel_j = JSTFT.mel_spectrogram(jnp.asarray(y), hop_length=A.hop_length, win_length=A.win_length, **MEL)
    np.testing.assert_allclose(mel_t.numpy(), np.asarray(mel_j), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(TSTFT.spec_to_mel(spec_t, **MEL).numpy(),
                               np.asarray(JSTFT.spec_to_mel(jnp.asarray(spec_j), **MEL)),
                               atol=1e-4, rtol=1e-4)


def test_mel_spectrogram_gradient():
    """The generator's mel loss differentiates through the STFT."""
    y = _audio(1, 2, 3000)
    target = normal(np.random.default_rng(2), (2, 11, A.mel_channels))  # 11 frames
    kw = dict(hop_length=A.hop_length, win_length=A.win_length, **MEL)

    def jfn(y):
        return jnp.mean(jnp.abs(JSTFT.mel_spectrogram(y, **kw) - target))

    def tfn(y):
        return torch.mean(torch.abs(TSTFT.mel_spectrogram(y, **kw) - torch.from_numpy(target)))

    _check_grads(jfn, tfn, [y], rel=5e-4, what="mel L1")


# ---------------------------------------------------------------------------
# MAS
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1])
def test_maximum_path_equals_jax_and_numpy(seed):
    rng = np.random.default_rng(seed)
    b, t_y, t_x = 4, 53, 17
    neg_cent = (5 * rng.standard_normal((b, t_y, t_x))).astype(np.float32)
    x_len = np.array([17, 11, 6, 1])
    y_len = np.array([53, 30, 12, 4])
    ref = np.asarray(JMAS.maximum_path(jnp.asarray(neg_cent), jnp.asarray(x_len), jnp.asarray(y_len)))
    got = TMAS.maximum_path(torch.from_numpy(neg_cent), torch.from_numpy(x_len), torch.from_numpy(y_len))
    assert got.dtype == torch.float32 and not got.requires_grad
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(TMAS.maximum_path_numpy(neg_cent, x_len, y_len), ref)
    np.testing.assert_array_equal(ref.sum(1)[0] > 0, np.ones(17, bool))  # every phoneme has frames


# ---------------------------------------------------------------------------
# Posterior encoder, SDP NLL
# ---------------------------------------------------------------------------


def _jax_subtree(cfg, key, seed):
    from piper_tpu.models.vits.model import init_synthesizer_params

    return np_tree(init_synthesizer_params(jax.random.PRNGKey(seed), cfg, training=True)[key])


@pytest.mark.parametrize("cfg", [TINY, TINY_MS], ids=["single", "multi"])
def test_posterior_encode(cfg):
    p = _jax_subtree(cfg, "enc_q", 3)
    rng = np.random.default_rng(4)
    b, t = 2, 23
    spec = np.abs(normal(rng, (b, t, cfg.spec_channels)))
    lens = np.array([23, 15])
    mask = mask_np(lens, t)
    noise = normal(rng, (b, t, cfg.inter_channels))
    proj = normal(rng, (b, t, cfg.inter_channels))
    args = [p, spec] + ([normal(rng, (b, cfg.gin_channels))] if cfg.gin_channels else [])

    def jfn(p, spec, g=None):
        z, m, logs = JQ.posterior_encode(p, spec, jnp.asarray(mask), cfg=cfg, noise=jnp.asarray(noise), g=g)
        return jnp.sum((z + 0.5 * m + 0.25 * logs) * proj)

    def tfn(p, spec, g=None):
        z, m, logs = TQ.posterior_encode(p, spec, torch.from_numpy(mask), cfg=tcfg(cfg),
                                         noise=torch.from_numpy(noise), g=g)
        return torch.sum((z + 0.5 * m + 0.25 * logs) * torch.from_numpy(proj))

    _check_grads(jfn, tfn, args, rel=1e-4, what="posterior_encode")


def test_sdp_forward_nll():
    """Values and gradients with respect to the SDP's parameters and the
    durations, on the multi-speaker config (the speaker condition g
    included); the condition x and g are detached in both packages."""
    cfg = TINY_MS
    p = _jax_subtree(cfg, "dp", 5)
    rng = np.random.default_rng(6)
    b, t = 2, 9
    x = normal(rng, (b, t, cfg.hidden_channels))
    mask = mask_np([9, 6], t)
    w = np.abs(normal(rng, (b, t, 1), 3.0)).round() + 1.0
    noise = normal(rng, (b, t, 2))
    g = normal(rng, (b, cfg.gin_channels)) if cfg.gin_channels else None
    coef = np.array([1.0, 0.5], np.float32)

    def jfn(p, w):
        nll = JD.sdp_forward_nll(p, jnp.asarray(x), jnp.asarray(mask), w, cfg=cfg,
                                 g=None if g is None else jnp.asarray(g), rng=jax.random.PRNGKey(0))
        return jnp.sum(nll * coef)

    # the JAX package draws e_q from its rng: the same normal here
    e_q = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (b, t, 2)))

    def tfn(p, w):
        nll = TD.sdp_forward_nll(p, torch.from_numpy(x), torch.from_numpy(mask), w, cfg=tcfg(cfg),
                                 g=None if g is None else torch.from_numpy(g),
                                 noise=torch.from_numpy(e_q))
        return torch.sum(nll * torch.from_numpy(coef))

    del noise
    _check_grads(jfn, tfn, [p, w], atol=1e-4, rtol=1e-4, what="sdp_forward_nll")


# ---------------------------------------------------------------------------
# Discriminators
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def params_d():
    return np_tree(JDS.init_mpd(jax.random.PRNGKey(7)))


def test_mpd_apply_values(params_d):
    y, y_hat = _audio(8, 2, 300), _audio(9, 2, 300)
    jr, jg, jfr, jfg = JDS.mpd_apply(jax.tree.map(jnp.asarray, params_d), jnp.asarray(y), jnp.asarray(y_hat))
    pt = _tree_t(params_d)
    tr, tg, tfr, tfg = TDS.mpd_apply(pt, torch.from_numpy(y), torch.from_numpy(y_hat))
    for i in range(6):
        _rel_close(tr[i], jr[i], 1e-4, f"real logits {i}")
        _rel_close(tg[i], jg[i], 1e-4, f"generated logits {i}")
        for j, (a, bb) in enumerate(zip(tfr[i], jfr[i])):
            # the port's maps are channels-first
            a = a.permute(0, 2, 3, 1) if a.dim() == 4 else a.transpose(1, 2)
            _rel_close(a, bb, 1e-4, f"fmap {i}.{j}")


def test_mpd_losses_and_gradients(params_d):
    """The generator's adversarial and feature losses through the
    discriminators, with gradients with respect to y_hat and every
    discriminator parameter; then the discriminator's loss."""
    y, y_hat = _audio(10, 2, 300), _audio(11, 2, 300)

    def jgen(p, y_hat):
        _, g, fr, fg = JDS.mpd_apply(p, jnp.asarray(y), y_hat)
        return JLS.generator_loss(g)[0] + JLS.feature_loss(fr, fg)

    def tgen(p, y_hat):
        _, g, fr, fg = TDS.mpd_apply(p, torch.from_numpy(y), y_hat)
        return TLS.generator_loss(g)[0] + TLS.feature_loss(fr, fg)

    _check_grads(jgen, tgen, [params_d, y_hat], rel=1e-3, what="generator + feature loss")

    def jdisc(p):
        r, g, _, _ = JDS.mpd_apply(p, jnp.asarray(y), jnp.asarray(y_hat))
        return JLS.discriminator_loss(r, g)[0]

    def tdisc(p):
        r, g, _, _ = TDS.mpd_apply(p, torch.from_numpy(y), torch.from_numpy(y_hat))
        return TLS.discriminator_loss(r, g)[0]

    _check_grads(jdisc, tdisc, [params_d], rel=1e-3, what="discriminator loss")


def test_dur_disc_apply():
    cfg = dataclasses.replace(TINY_MS, use_dur_disc=True)
    p = np_tree(JDS.init_dur_disc(jax.random.PRNGKey(12), cfg.hidden_channels))
    rng = np.random.default_rng(13)
    b, t = 2, 11
    x = normal(rng, (b, t, cfg.hidden_channels))
    logw = normal(rng, (b, t, 1))
    mask = mask_np([11, 7], t)
    proj = normal(rng, (b, t, 1))

    def jfn(p, x, logw):
        return jnp.sum(JDS.dur_disc_apply(p, x, logw, jnp.asarray(mask)) * proj)

    def tfn(p, x, logw):
        return torch.sum(TDS.dur_disc_apply(p, x, logw, torch.from_numpy(mask)) * torch.from_numpy(proj))

    _check_grads(jfn, tfn, [p, x, logw], what="dur_disc_apply")


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------


def test_losses_values_and_gradients():
    rng = np.random.default_rng(14)
    outs_r = [normal(rng, (2, n)) for n in (5, 9)]
    outs_g = [normal(rng, (2, n)) for n in (5, 9)]
    fmap_r = [[normal(rng, (2, 4, 3)), normal(rng, (2, 6))], [normal(rng, (2, 5))]]
    fmap_g = [[normal(rng, (2, 4, 3)), normal(rng, (2, 6))], [normal(rng, (2, 5))]]
    _check_grads(lambda r, g: JLS.discriminator_loss(r, g)[0],
                 lambda r, g: TLS.discriminator_loss(r, g)[0], [outs_r, outs_g], what="discriminator_loss")
    _check_grads(lambda g: JLS.generator_loss(g)[0], lambda g: TLS.generator_loss(g)[0],
                 [outs_g], what="generator_loss")
    _check_grads(JLS.feature_loss, TLS.feature_loss, [fmap_r, fmap_g], what="feature_loss")
    b, t, c = 2, 13, 6
    z_p, logs_q, m_p = (normal(rng, (b, t, c)) for _ in range(3))
    logs_p = normal(rng, (b, t, c), 0.3)
    mask = mask_np([13, 8], t)
    _check_grads(lambda *a: JLS.kl_loss(*a, jnp.asarray(mask)),
                 lambda *a: TLS.kl_loss(*a, torch.from_numpy(mask)),
                 [z_p, logs_q, m_p, logs_p], what="kl_loss")
