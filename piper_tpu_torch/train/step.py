"""GAN training step: generator and discriminator updates.

Counterpart of piper_tpu/train/step.py. Parity: reference
lightning.py:189-280 two-optimizer steps. Both gradient passes use the
same y_hat from the pre-update generator, and the generator's
gradients are taken against the pre-update discriminator, then both
updates are applied, as the JAX package's train_step does (step.py:
98-233). Gradients come from torch.autograd.grad over explicit
parameter lists, so the generator's loss never writes a
discriminator gradient and no .grad field is kept between steps.

Optimizers: AdamW lr 2e-4, betas (0.8, 0.99), eps 1e-9, weight decay
0.01 (lightning.py:312-332), with the JAX package's optax schedule:
lr * 0.999875 ** (count / steps_per_epoch), continuous, at the count of
updates before this one (optax.exponential_decay), not torch's
per-epoch ExponentialLR; `grad_clip` is optax.clip, elementwise. Loss
weights c_mel=45, c_kl=1 (lightning.py:68-70).

Parameters stay float32; `dtype` is the compute dtype of the generator
(bfloat16 for --precision fast, float32 for parity), as in the JAX
package, whose layers cast weights to the activations' dtype at use.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch

from ..config import ModelConfig
from ..models.vits import discriminator as DS
from ..models.vits.model import Init, init_synthesizer_params
from ..ops.stft import mel_spectrogram, spec_to_mel
from ..weights.bridge import iter_leaves, params_d_from_jax, params_from_jax
from . import losses as LS
from .forward import slice_segments, train_forward

Params = Dict[str, Any]


def leaves(tree: Params) -> List[torch.Tensor]:
    """The tree's tensors in native-format key order."""
    return [t for _, t in iter_leaves(tree)]


class Optimizer:
    """AdamW under optax's continuous exponential decay, with optax.clip.
    One per parameter tree; step() takes that tree's gradients."""

    def __init__(
        self,
        params: List[torch.Tensor],
        *,
        learning_rate: float = 2e-4,
        betas: Tuple[float, float] = (0.8, 0.99),
        eps: float = 1e-9,
        weight_decay: float = 0.01,
        lr_decay: float = 0.999875,
        steps_per_epoch: int = 1000,
        grad_clip: Optional[float] = None,
    ):
        self.params = params
        self.learning_rate = learning_rate
        self.lr_decay = lr_decay
        self.steps_per_epoch = steps_per_epoch
        self.grad_clip = grad_clip
        self.count = 0  # updates applied (optax's schedule count)
        self.adamw = torch.optim.AdamW(
            params, lr=learning_rate, betas=betas, eps=eps, weight_decay=weight_decay,
        )

    def lr(self) -> float:
        """optax.exponential_decay(lr, steps_per_epoch, lr_decay) at the
        count of updates before this one."""
        return self.learning_rate * self.lr_decay ** (self.count / self.steps_per_epoch)

    @torch.no_grad()
    def step(self, grads: List[Optional[torch.Tensor]]) -> None:
        for p, g in zip(self.params, grads):
            g = torch.zeros_like(p) if g is None else g
            if self.grad_clip is not None:
                g = g.clamp(-self.grad_clip, self.grad_clip)
            p.grad = g
        for group in self.adamw.param_groups:
            group["lr"] = self.lr()
        self.adamw.step()
        for p in self.params:
            p.grad = None
        self.count += 1

    def state_dict(self) -> dict:
        return {"adamw": self.adamw.state_dict(), "count": self.count}

    def load_state_dict(self, state: dict) -> None:
        self.adamw.load_state_dict(state["adamw"])
        self.count = state["count"]


def make_optimizer(params: List[torch.Tensor], **kw) -> Optimizer:
    """The JAX package's make_optimizer (step.py:43-63) over `params`."""
    return Optimizer(params, **kw)


@dataclasses.dataclass
class TrainState:
    params_g: Params
    params_d: Params
    opt_g: Optimizer
    opt_d: Optimizer
    step: int = 0


def init_params(seed: int, cfg: ModelConfig) -> Tuple[Params, Params]:
    """Random numpy trees (the JAX initialisers' distributions): the
    generator with enc_q, and the discriminators, with VITS2's duration
    discriminator when cfg.use_dur_disc (step.py:66-90)."""
    params_g = init_synthesizer_params(seed, cfg, training=True)
    r = Init(seed + 1)
    params_d = DS.init_mpd(r)
    if cfg.use_dur_disc:
        params_d["dur_disc"] = DS.init_dur_disc(r, cfg.hidden_channels)
    return params_g, params_d


def make_train_state(
    params_g_np: Params,
    params_d_np: Params,
    cfg: ModelConfig,
    *,
    device="cpu",
    **opt_kw,
) -> TrainState:
    """A TrainState from numpy trees in the JAX layouts (the weight
    bridge's float32 leaves, as trainable tensors on `device`), with a
    fresh optimizer per tree."""
    params_g = params_from_jax(params_g_np, cfg, device, torch.float32)
    params_d = params_d_from_jax(params_d_np, cfg, device)
    for t in leaves(params_g) + leaves(params_d):
        t.requires_grad_(True)
    return TrainState(
        params_g=params_g,
        params_d=params_d,
        opt_g=make_optimizer(leaves(params_g), **opt_kw),
        opt_d=make_optimizer(leaves(params_d), **opt_kw),
    )


def train_step(
    state: TrainState,
    batch: Dict[str, torch.Tensor],
    rng: torch.Tensor,
    *,
    cfg: ModelConfig,
    c_mel: float = 45.0,
    c_kl: float = 1.0,
    dtype: torch.dtype = torch.float32,
    shard: LS.BatchShard = LS.WHOLE,
) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """One GAN step, in place on `state` (returned for symmetry with the
    JAX package). batch: ids (B,T_x), id_lengths (B,), spec (B,T_y,F)
    float32, spec_lengths (B,), audio (B,T_samples) float32, sid optional
    (B,), on the device; rng: a (2,) key on the device. Returns the
    losses as 0-dim device tensors (reading them waits for the step).

    `shard` (parallel/sharding.make_sharded_train_step): the batch is a
    data-parallel share; each loss is built as its share's term, the
    gradients are summed over the shares before either update (so a
    grad_clip clamps the whole batch's gradient), and the losses
    returned are the whole batch's. attn_durations and ids_slice stay
    the share's rows."""
    a = cfg.audio
    seg_frames = cfg.segment_size // a.hop_length
    sid = batch.get("sid")
    mel_kw = dict(sample_rate=a.sample_rate, n_fft=a.filter_length, n_mels=a.mel_channels,
                  fmin=a.mel_fmin, fmax=a.mel_fmax)
    with torch.no_grad():
        mel_all = spec_to_mel(batch["spec"].float(), **mel_kw)

    # VITS2 annealed MAS noise: 0.01, less 2e-6 per step (zero after 5k
    # steps; arXiv:2307.16430 §2.2)
    mas_noise_scale = None
    if cfg.mas_noise:
        mas_noise_scale = torch.tensor(max(0.0, 0.01 - 2e-6 * state.step), device=rng.device)

    # ---- generator loss and gradients, against the pre-update discriminator
    out = train_forward(
        state.params_g, cfg=cfg, ids=batch["ids"], id_lengths=batch["id_lengths"],
        spec=batch["spec"], spec_lengths=batch["spec_lengths"], sid=sid, rng=rng,
        dtype=dtype, mas_noise_scale=mas_noise_scale, shard=shard,
    )
    y_hat = out.y_hat.float()  # (B, seg_samples)
    y_mel = slice_segments(mel_all, out.ids_slice, seg_frames)
    y_hat_mel = mel_spectrogram(y_hat, hop_length=a.hop_length, win_length=a.win_length, **mel_kw)
    y = slice_segments(batch["audio"].float()[..., None], out.ids_slice * a.hop_length,
                       cfg.segment_size)[..., 0]

    _, y_d_hat_g, fmap_r, fmap_g = DS.mpd_apply(state.params_d, y, y_hat)
    loss_mel = shard.share(torch.mean(torch.abs(y_mel - y_hat_mel))) * c_mel
    loss_kl = LS.kl_loss(out.z_p, out.logs_q, out.m_p_exp, out.logs_p_exp, out.y_mask, shard) * c_kl
    loss_fm = shard.share(LS.feature_loss(fmap_r, fmap_g))
    loss_gen = shard.share(LS.generator_loss(y_d_hat_g)[0])
    total = loss_gen + loss_fm + loss_mel + out.loss_dur + loss_kl
    metrics = {"loss_gen": loss_gen, "loss_fm": loss_fm, "loss_mel": loss_mel,
               "loss_dur": out.loss_dur, "loss_kl": loss_kl}
    if cfg.use_dur_disc:
        # VITS2: the duration predictor also fools a per-position
        # discriminator on (text hidden, log-duration) pairs
        dd_g = DS.dur_disc_apply(state.params_d["dur_disc"], out.x_h, out.logw_hat, out.x_mask)
        loss_dur_gen = shard.ratio(torch.sum(torch.square(1.0 - dd_g) * out.x_mask), torch.sum(out.x_mask))
        total = total + loss_dur_gen
        metrics["loss_dur_gen"] = loss_dur_gen
    metrics["loss_gen_all"] = total
    params_g = leaves(state.params_g)
    grads_g = torch.autograd.grad(total, params_g, allow_unused=True)

    # ---- discriminator loss and gradients, on the detached audio
    y, y_hat = y.detach(), y_hat.detach()
    y_d_hat_r, y_d_hat_g, _, _ = DS.mpd_apply(state.params_d, y, y_hat)
    loss_disc = shard.share(LS.discriminator_loss(y_d_hat_r, y_d_hat_g)[0])
    if cfg.use_dur_disc:
        x_h, x_mask = out.x_h, out.x_mask
        dd = state.params_d["dur_disc"]
        dd_r = DS.dur_disc_apply(dd, x_h, out.logw_real, x_mask)
        dd_f = DS.dur_disc_apply(dd, x_h, out.logw_hat.detach(), x_mask)
        loss_disc = loss_disc + shard.ratio(
            torch.sum((torch.square(1.0 - dd_r) + torch.square(dd_f)) * x_mask), torch.sum(x_mask)
        )
    params_d = leaves(state.params_d)
    grads_d = torch.autograd.grad(loss_disc, params_d, allow_unused=True)

    state.opt_g.step(shard.total_grads(grads_g, params_g))
    state.opt_d.step(shard.total_grads(grads_d, params_d))
    state.step += 1
    metrics["loss_disc_all"] = loss_disc
    metrics = {k: v.detach() for k, v in metrics.items()}
    if shard.count > 1:  # every share's terms summed: the whole batch's losses
        metrics = dict(zip(metrics, shard.total(torch.stack(list(metrics.values())))))
    metrics["attn_durations"] = out.attn_durations
    metrics["ids_slice"] = out.ids_slice
    return state, metrics
