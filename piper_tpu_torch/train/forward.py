"""VITS training forward pass.

Counterpart of piper_tpu/train/forward.py. Parity: reference
SynthesizerTrn.forward (models.py:617-679) — text encoder + posterior
encoder + flow + MAS + duration loss + random segment slicing + the
vocoder on the segment.

As in the JAX package: MAS runs on the device (ops/mas.py), the prior
is expanded by the MAS path's per-frame phoneme index with a gather,
and the randomness comes from one key split four ways, drawn with the
JAX package's own calls through ops/prng.py, so one key gives both
packages the same posterior noise, SDP noise, MAS noise and segments.
The vocoder is the plain apply_decoder (autograd through cuDNN on the
card): the JAX training forward runs no Pallas kernel either.
"""

from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Optional

import torch

from ..config import ModelConfig
from ..models.vits import duration as D
from ..models.vits import encoder as E
from ..models.vits import flow as F
from ..models.vits import posterior as Q
from ..models.vits.model import apply_decoder, speaker_embedding
from ..ops import nn as tnn
from ..ops import prng
from ..ops.mas import maximum_path
from .losses import WHOLE, BatchShard

Params = Dict[str, Any]


class TrainForwardOut(NamedTuple):
    y_hat: torch.Tensor  # (B, segment_samples) generated audio segment
    ids_slice: torch.Tensor  # (B,) segment start frames
    loss_dur: torch.Tensor  # scalar duration loss
    z_p: torch.Tensor  # (B, T_y, C)
    m_p_exp: torch.Tensor  # expanded prior mean (B, T_y, C)
    logs_p_exp: torch.Tensor
    m_q: torch.Tensor
    logs_q: torch.Tensor
    y_mask: torch.Tensor  # (B, T_y, 1)
    attn_durations: torch.Tensor  # (B, T_x) frames per phoneme
    # VITS2 duration-discriminator inputs (None unless cfg.use_dur_disc):
    # x_h is the detached text hidden; logw_hat carries generator grads.
    x_h: Optional[torch.Tensor] = None
    x_mask: Optional[torch.Tensor] = None
    logw_hat: Optional[torch.Tensor] = None
    logw_real: Optional[torch.Tensor] = None


def slice_segments(x: torch.Tensor, ids_str: torch.Tensor, segment_size: int) -> torch.Tensor:
    """Per-example slice along time (commons.py:47-53): x (B, T, ...) ->
    (B, segment_size, ...), each start clamped into range as
    jax.lax.dynamic_slice clamps it."""
    start = ids_str.long().clamp(0, x.shape[1] - segment_size)
    idx = start[:, None] + torch.arange(segment_size, device=x.device)
    idx = idx.reshape(idx.shape + (1,) * (x.dim() - 2)).expand(-1, -1, *x.shape[2:])
    return torch.gather(x, 1, idx)


def rand_slice_ids(key: torch.Tensor, lengths: torch.Tensor, segment_size: int,
                   shard: BatchShard = WHOLE) -> torch.Tensor:
    """Random valid segment starts (commons.py:56-63), from the JAX
    package's uniform draw (at the whole batch's shape: `shard`'s rows)."""
    ids_max = torch.clamp(lengths.long() - segment_size + 1, min=1)
    u = shard.rows(prng.uniform(key, (shard.batch(lengths.shape[0]),)))
    return (u * ids_max).long()


def prior_scores(z_p: torch.Tensor, m_p: torch.Tensor, logs_p: torch.Tensor) -> torch.Tensor:
    """MAS's (B, T_y, T_x) log-likelihood of each frame under each
    phoneme's prior (models.py:628-650), float32, no gradient."""
    zp32, mp32, lp32 = (t.detach().float() for t in (z_p, m_p, logs_p))
    s_p_sq_r = torch.exp(-2.0 * lp32)  # (B, T_x, C)
    neg_cent1 = torch.sum(-0.5 * math.log(2 * math.pi) - lp32, dim=-1)  # (B, T_x)
    neg_cent2 = torch.matmul(-0.5 * zp32.square(), s_p_sq_r.transpose(1, 2))
    neg_cent3 = torch.matmul(zp32, (mp32 * s_p_sq_r).transpose(1, 2))
    neg_cent4 = torch.sum(-0.5 * mp32.square() * s_p_sq_r, dim=-1)
    return neg_cent2 + neg_cent3 + neg_cent1[:, None, :] + neg_cent4[:, None, :]


def train_forward(
    params: Params,
    *,
    cfg: ModelConfig,
    ids: torch.Tensor,  # (B, T_x) integer
    id_lengths: torch.Tensor,  # (B,)
    spec: torch.Tensor,  # (B, T_y, spec_channels)
    spec_lengths: torch.Tensor,  # (B,)
    sid: Optional[torch.Tensor],
    rng: torch.Tensor,  # (2,) key (ops/prng.py) on the device
    dtype: torch.dtype = torch.float32,
    mas_noise_scale: Optional[torch.Tensor] = None,
    shard: BatchShard = WHOLE,
) -> TrainForwardOut:
    """`shard`: the rows of a data-parallel batch these are
    (losses.BatchShard): every random draw is made at the whole batch's
    shape and cut to them, and loss_dur is this shard's term of the whole
    batch's."""
    r_post, r_sdp, r_slice, r_mas = prng.split(rng, 4)
    b_all = shard.batch(ids.shape[0])
    seg_frames = cfg.segment_size // cfg.audio.hop_length

    x_mask = tnn.sequence_mask(id_lengths, ids.shape[1]).to(dtype)
    y_mask = tnn.sequence_mask(spec_lengths, spec.shape[1]).to(dtype)
    g = speaker_embedding(params, cfg, sid)

    x, m_p, logs_p = E.text_encoder_apply(params["enc_p"], ids, x_mask, cfg=cfg, dtype=dtype, g=g)

    post_noise = shard.rows(prng.normal(r_post, (b_all, spec.shape[1], cfg.inter_channels))).to(dtype)
    z, m_q, logs_q = Q.posterior_encode(
        params["enc_q"], spec.to(dtype), y_mask, cfg=cfg, g=g, noise=post_noise
    )
    z_p = F.flow_apply(params["flow"], z, y_mask, cfg=cfg, g=g, reverse=False)

    # ---- MAS (no grad; models.py:628-650) ----
    neg_cent = prior_scores(z_p, m_p, logs_p)
    if cfg.mas_noise and mas_noise_scale is not None:
        # VITS2 §2.2: annealed Gaussian noise on the alignment scores
        neg_cent = neg_cent + mas_noise_scale * shard.rows(
            prng.normal(r_mas, (b_all,) + tuple(neg_cent.shape[1:])))
    attn = maximum_path(neg_cent, id_lengths, spec_lengths)  # (B, T_y, T_x)
    w = torch.sum(attn, dim=1)  # (B, T_x) durations

    # ---- duration loss ----
    logw_real = torch.log(w[..., None] + 1e-6) * x_mask
    logw_hat = None
    if cfg.use_sdp:
        nll = D.sdp_forward_nll(
            params["dp"], x, x_mask, w[..., None], cfg=cfg, g=g,
            noise=shard.rows(prng.normal(r_sdp, (b_all, x.shape[1], 2))),
        )
        loss_dur = shard.ratio(torch.sum(nll.float()), torch.sum(x_mask.float()))
        if cfg.use_dur_disc:
            # adversarial target: a sampled log-duration sequence, from
            # the detached text hidden (sdp_reverse, an inference path,
            # does not detach it; forward.py:135-146)
            dur_noise = shard.rows(prng.normal(prng.fold_in(r_sdp, 1), (b_all, x.shape[1], 2)))
            logw_hat = D.sdp_reverse(
                params["dp"], x.detach(), x_mask, cfg=cfg, noise_w=1.0, noise=dur_noise, g=g,
            )
    else:
        logw = D.dp_apply(params["dp"], x, x_mask, cfg=cfg, g=g)
        loss_dur = shard.ratio(torch.sum(torch.square(logw - logw_real)), torch.sum(x_mask))
        logw_hat = logw

    # ---- expand the prior by the path's per-frame phoneme index ----
    frame_idx = torch.argmax(attn, dim=-1)[..., None].expand(-1, -1, m_p.shape[-1])
    m_p_exp = torch.gather(m_p, 1, frame_idx) * y_mask
    logs_p_exp = torch.gather(logs_p, 1, frame_idx) * y_mask

    # ---- random segment + vocoder ----
    ids_slice = rand_slice_ids(r_slice, spec_lengths, seg_frames, shard)
    z_slice = slice_segments(z, ids_slice, seg_frames)
    y_hat = apply_decoder(params, z_slice, None, cfg=cfg, g=g)

    return TrainForwardOut(
        y_hat=y_hat,
        ids_slice=ids_slice,
        loss_dur=loss_dur,
        z_p=z_p,
        m_p_exp=m_p_exp,
        logs_p_exp=logs_p_exp,
        m_q=m_q,
        logs_q=logs_q,
        y_mask=y_mask,
        attn_durations=w,
        x_h=x.detach(),
        x_mask=x_mask,
        logw_hat=logw_hat,
        logw_real=logw_real.detach(),
    )
