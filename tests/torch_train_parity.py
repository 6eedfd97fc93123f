"""Shared helpers of the training-step tests (tests/test_torch_train_step*.py):
one synthetic batch, JAX's initial training state handed to the port
as numpy, train_forward in both packages from one key, and two
train_steps in both, compared after each.

Bounds, set from the arithmetic, not fitted:
- ids_slice and the MAS durations: equal (the same key gives the same
  segment draw; MAS is exact on scores that agree to float32 rounding);
- the forward's float outputs: 1e-4 relative to each one's largest
  magnitude (float32 through the encoder, the posterior's 16 WN layers
  and the flows, summed in another order);
- every loss: rtol 1e-4;
- the parameters after each step: an Adam step moves an element by
  lr * m_hat / (sqrt(v_hat) + eps), about lr whatever the gradient's
  size, so where a gradient is as small as its rounding (near eps, or
  zero in exact arithmetic) the two packages' steps may differ by up to
  about 2 lr; at the second step the moments' cancellations amplify the
  first step's differences too. So, leaf by leaf: the median difference
  at most 1e-7 (a fault shows in most of a leaf), at most 1e-3 of the
  elements, or one element, more than 1e-5 (5% of an Adam step), and
  none more than 2.5 lr per step. The
  text encoder's attention key biases
  (enc_p ... attn.k.b) are held to the second bound only: they shift
  every logit of a query alike, so their gradient is zero in exact
  arithmetic and each package's Adam turns its rounding noise into
  +-lr steps.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

import jax
import jax.numpy as jnp

from piper_tpu.train.forward import train_forward as jax_train_forward
from piper_tpu.train.step import init_train_state, make_optimizer
from piper_tpu.train.step import train_step as jax_train_step
from piper_tpu_torch.train.forward import train_forward
from piper_tpu_torch.train.step import make_train_state, train_step
from piper_tpu_torch.weights.bridge import iter_leaves, params_from_jax
from torch_parity import np_tree, tcfg

LR = 2e-4
# a schedule that halves the rate every step, so the second step shows
# whether the port decays it as optax does (lr * 0.5 ** (count / 1))
OPT = dict(lr_decay=0.5, steps_per_epoch=1)


def step_config(cfg):
    """The config at 16-frame segments (4096 samples): the training
    segment's length, not a width, cut for the CPU."""
    return dataclasses.replace(cfg, segment_size=4096)


def make_batch(cfg, seed=0, b=2, t_x=14, t_y=40):
    rng = np.random.default_rng(seed)
    hop = cfg.audio.hop_length
    batch = {
        "ids": rng.integers(3, cfg.num_symbols, (b, t_x)).astype(np.int32),
        "id_lengths": np.array([t_x, t_x - 4], np.int32),
        "spec": np.abs(rng.standard_normal((b, t_y, cfg.spec_channels))).astype(np.float32),
        "spec_lengths": np.array([t_y, t_y - 9], np.int32),
        "audio": (rng.standard_normal((b, t_y * hop)) * 0.2).astype(np.float32),
    }
    if cfg.num_speakers > 1:
        batch["sid"] = np.array([2, 0], np.int32)
    return batch


def compiled(fn, *args):
    """jax.jit(fn) compiled for `args` at XLA:CPU's lowest backend
    optimisation level: the reference's numbers at a fifth less compile
    time (the GAN step's compile dominates these tests)."""
    return jax.jit(fn).lower(*args).compile(
        {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True})


def key_t(key) -> torch.Tensor:
    return torch.from_numpy(np.asarray(key).astype(np.int64))


def _rel(got, ref, rel, what):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref, np.float32)
    scale = float(np.abs(ref).max()) or 1.0
    err = float(np.abs(got - ref).max())
    assert err <= rel * scale, f"{what}: max error {err} > {rel} x {scale}"


def check_forward(cfg, seed=0):
    """train_forward in both packages from the same params and key."""
    tree = np_tree(init_train_state(jax.random.PRNGKey(seed), cfg)[0].params_g)
    batch = make_batch(cfg, seed)
    key = jax.random.PRNGKey(seed + 5)
    scale = 0.01 if cfg.mas_noise else None
    args = (jax.tree.map(jnp.asarray, tree), batch["ids"], batch["id_lengths"], batch["spec"],
            batch["spec_lengths"], batch.get("sid"), key, None if scale is None else jnp.float32(scale))

    def fwd(p, ids, id_lengths, spec, spec_lengths, sid, rng, mas_noise_scale):
        return jax_train_forward(p, cfg=cfg, ids=ids, id_lengths=id_lengths, spec=spec,
                                 spec_lengths=spec_lengths, sid=sid, rng=rng,
                                 mas_noise_scale=mas_noise_scale)

    ref = compiled(fwd, *args)(*args)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    got = train_forward(
        params_from_jax(tree, tcfg(cfg)), cfg=tcfg(cfg), ids=tb["ids"], id_lengths=tb["id_lengths"],
        spec=tb["spec"], spec_lengths=tb["spec_lengths"], sid=tb.get("sid"), rng=key_t(key),
        mas_noise_scale=None if scale is None else torch.tensor(scale),
    )
    np.testing.assert_array_equal(got.ids_slice.numpy(), np.asarray(ref.ids_slice))
    np.testing.assert_array_equal(got.attn_durations.numpy(), np.asarray(ref.attn_durations))
    assert int(np.asarray(ref.attn_durations).sum()) == int(batch["spec_lengths"].sum())
    fields = ["y_hat", "z_p", "m_p_exp", "logs_p_exp", "m_q", "logs_q", "loss_dur"]
    if cfg.use_dur_disc:
        fields.append("logw_hat")
    for f in fields:
        _rel(getattr(got, f), getattr(ref, f), 1e-4, f)


def check_leaf(name, got, ref, steps, what):
    """One parameter leaf after `steps` Adam steps against its reference,
    at the bounds above."""
    d = np.abs(np.asarray(got) - np.asarray(ref))
    assert float(d.max()) <= 2.5 * LR * steps, f"{what} {name}: {float(d.max())}"
    bad = int((d > 1e-5).sum())
    if not name.endswith("attn.k.b"):
        assert float(np.median(d)) <= 1e-7, f"{what} {name}: median {float(np.median(d))}"
        assert bad <= max(1, 1e-3 * d.size), f"{what} {name}: {bad} of {d.size} differ by > 1e-5"


def _check_params(jtree, ttree, before, steps, what):
    jflat = dict(iter_leaves(np_tree(jtree)))
    for name, t in iter_leaves(ttree):
        check_leaf(name, t.detach().numpy(), jflat[name], steps, what)
    # and the step did move the parameters
    bflat = dict(iter_leaves(before))
    moved = sum(float(np.abs(t.detach().numpy() - bflat[name]).max()) > 0
                for name, t in iter_leaves(ttree))
    assert moved > 0, what


def check_two_steps(cfg, seed=0):
    """Two train_steps in both packages from JAX's initial state and the
    same keys: every loss, then params_g and params_d after each step
    (the AdamW moments and optax's decayed learning rate)."""
    tx = make_optimizer(**OPT)
    state, _ = init_train_state(jax.random.PRNGKey(seed), cfg, optimizer=tx)
    g0, d0 = np_tree(state.params_g), np_tree(state.params_d)
    tstate = make_train_state(g0, d0, tcfg(cfg), **OPT)
    batch = make_batch(cfg, seed)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    keys = [jax.random.PRNGKey(seed + 5), jax.random.PRNGKey(seed + 6)]
    step = compiled(functools.partial(jax_train_step, cfg=cfg, tx=tx), state, jb, keys[0])
    for i, key in enumerate(keys):
        before = (g0, d0) if i == 0 else (np_tree(state.params_g), np_tree(state.params_d))
        state, ref = step(state, jb, key)
        tstate, got = train_step(tstate, tb, key_t(key), cfg=tcfg(cfg))
        assert tstate.step == i + 1 and tstate.opt_g.count == i + 1
        for name, v in ref.items():
            np.testing.assert_allclose(float(got[name]), float(v), rtol=1e-4, err_msg=f"step {i + 1} {name}")
        _check_params(state.params_g, tstate.params_g, before[0], i + 1, f"step {i + 1} params_g")
        _check_params(state.params_d, tstate.params_d, before[1], i + 1, f"step {i + 1} params_d")
