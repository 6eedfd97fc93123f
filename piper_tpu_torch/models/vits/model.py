"""VITS synthesizer: the end-to-end inference graph.

Counterpart of piper_tpu/models/vits/model.py. Parity: reference
SynthesizerTrn.infer (models.py:681-722), split like the JAX package
into

  encode:   ids -> (m_p, logs_p, durations)           synthesizer_encode
  latents:  durations + frame noise -> z_p            synthesizer_latents
  vocode:   z_p -> flow reverse -> vocoder -> audio   synthesizer_vocode

Speaker conditioning g = emb_g[sid] (models.py:692-694) is threaded to
the duration predictor, the flow's WN stacks and the generator, and to
the text encoder of a VITS2 voice with speaker_cond_encoder. The vocoder
follows cfg.vocoder, as the JAX package's apply_decoder does
(model.py:70-83): HiFiGAN always takes the time-major path (the CUDA
kernels), MB-iSTFT its plain generator (istft_generator.py), which no
kernel of the port serves, as no Pallas kernel serves it in JAX
(model.py:196).
"""

from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ...config import ModelConfig
from ...ops import nn as tnn
from ...ops.duration import expand_by_duration
from . import duration as D
from . import encoder as E
from . import flow as F
from . import generator as G
from . import istft_generator as MB
from . import posterior as Q

Params = Dict[str, Any]


def speaker_embedding(
    params: Params, cfg: ModelConfig, sid: Optional[torch.Tensor]
) -> Optional[torch.Tensor]:
    if cfg.num_speakers <= 1 or sid is None:
        return None
    return params["emb_g"]["weight"][sid.long()]  # (B, gin)


def apply_decoder(
    params: Params,
    z: torch.Tensor,
    y_mask: Optional[torch.Tensor],
    *,
    cfg: ModelConfig,
    g: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The plain, differentiable vocoder, as the JAX package dispatches
    it (model.py:70-83): HiFiGAN's generator_apply or the MB-iSTFT
    generator. Training decodes through it; no CUDA kernel runs here,
    as no Pallas kernel runs in the JAX training forward."""
    if cfg.vocoder == "mb_istft":
        return MB.mb_istft_generator_apply(params["dec"], z, y_mask, cfg=cfg, g=g)
    return G.generator_apply(params["dec"], z, y_mask, cfg=cfg, g=g)


class EncodeResult(NamedTuple):
    m_p: torch.Tensor  # (B, T_x, C) prior mean per phoneme
    logs_p: torch.Tensor  # (B, T_x, C) prior log-std per phoneme
    durations: torch.Tensor  # (B, T_x) int64 frames per phoneme
    x_mask: torch.Tensor  # (B, T_x, 1)


def synthesizer_encode(
    params: Params,
    ids: torch.Tensor,
    lengths: torch.Tensor,
    *,
    cfg: ModelConfig,
    noise_w_scale,
    length_scale,
    dur_noise: torch.Tensor,
    sid: Optional[torch.Tensor] = None,
    dtype: torch.dtype = torch.float32,
) -> EncodeResult:
    """Text encoder + duration prediction (models.py:691-704).
    dur_noise: (B, T_x, 2) standard normal."""
    x_mask = tnn.sequence_mask(lengths, ids.shape[1]).to(dtype)
    g = speaker_embedding(params, cfg, sid)
    x, m_p, logs_p = E.text_encoder_apply(
        params["enc_p"], ids, x_mask, cfg=cfg, dtype=dtype, g=g
    )
    if cfg.use_sdp:
        logw = D.sdp_reverse(
            params["dp"], x, x_mask, cfg=cfg, noise_w=noise_w_scale,
            noise=dur_noise, g=g, dtype=dtype,
        )
    else:
        logw = D.dp_apply(params["dp"], x, x_mask, cfg=cfg, g=g)
    w = torch.exp(logw.float()) * x_mask.float() * length_scale
    durations = torch.ceil(w)[..., 0].long()
    return EncodeResult(m_p, logs_p, durations, x_mask)


def expand_prior(
    enc: EncodeResult, num_frames: int, frame_offset: int = 0
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The prior's mean and log-std per frame (models.py:705-716):
    (m_p, logs_p (B, num_frames, C), y_mask (B, num_frames, 1))."""
    m_p, y_mask = expand_by_duration(enc.m_p, enc.durations, num_frames, frame_offset)
    logs_p, _ = expand_by_duration(enc.logs_p, enc.durations, num_frames, frame_offset)
    return m_p, logs_p, y_mask.to(m_p.dtype)


def sample_latents(
    m_p: torch.Tensor,
    logs_p: torch.Tensor,
    y_mask: torch.Tensor,
    frame_noise: torch.Tensor,
    noise_scale,
) -> torch.Tensor:
    """z_p = m_p + noise * exp(logs_p) * noise_scale, masked
    (models.py:717-718). The scale is cast to the compute dtype first, as
    the JAX package casts it (model.py:171), and may be a tensor (a CUDA
    graph's input)."""
    scale = torch.as_tensor(noise_scale, device=m_p.device).to(m_p.dtype)
    z_p = m_p + frame_noise.to(m_p.dtype) * torch.exp(logs_p) * scale
    return z_p * y_mask


def synthesizer_latents(
    params: Params,
    enc: EncodeResult,
    num_frames: int,
    *,
    cfg: ModelConfig,
    noise_scale,
    frame_noise: torch.Tensor,
    frame_offset: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Prior expansion + latent sampling (models.py:705-718).

    frame_noise: (B, num_frames, C) standard normal. Returns
    (z_p (B, num_frames, C), y_mask (B, num_frames, 1))."""
    m_p, logs_p, y_mask = expand_prior(enc, num_frames, frame_offset)
    return sample_latents(m_p, logs_p, y_mask, frame_noise, noise_scale), y_mask


def synthesizer_flow(
    params: Params,
    z_p: torch.Tensor,
    y_mask: torch.Tensor,
    *,
    cfg: ModelConfig,
    g: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Flow reverse (models.py:719): z_p -> z, masked. No host read, so
    a CUDA graph can hold it (runtime/voice.py)."""
    z = F.flow_apply(params["flow"], z_p, y_mask, cfg=cfg, g=g, reverse=True)
    return z * y_mask


def synthesizer_generate(
    params: Params,
    z: torch.Tensor,
    y_mask: torch.Tensor,
    *,
    cfg: ModelConfig,
    g: Optional[torch.Tensor] = None,
    frames: Optional[Sequence[int]] = None,
    fixed_shape: bool = False,
) -> torch.Tensor:
    """The vocoder (models.py:720) on the masked flow output z:
    time-major HiFiGAN (`params["dec_tm"]`: generator.prepare_tm's
    tables) or MB-iSTFT (`params["dec_mb"]`: istft_generator.prepare_mb's),
    each made here when the tree lacks them. Both run their plain stages
    row by row at the host lengths `frames` (read from y_mask when not
    given), or, with `fixed_shape`, over the whole batch under the mask
    (the mode a CUDA graph holds)."""
    # counted, not summed in the mask's dtype: a bfloat16 sum rounds
    # lengths past 256 frames (259 -> 260)
    frame_lengths = (y_mask[..., 0] > 0).sum(dim=1).to(torch.int32)
    if cfg.vocoder == "mb_istft":
        tables = params.get("dec_mb")
        if fixed_shape:
            return MB.mb_istft_generator_apply(params["dec"], z, y_mask, cfg=cfg, g=g, tables=tables)
        lengths = list(frames) if frames is not None else frame_lengths.tolist()
        return MB.mb_istft_generator_rows(params["dec"], z, lengths, cfg=cfg, g=g, tables=tables)
    tm = params.get("dec_tm")
    if tm is None:
        tm = G.prepare_tm(params["dec"], cfg, z.dtype)
    return G.generator_tm_apply(
        params["dec"], tm, z, frame_lengths, cfg=cfg, g=g, row_frames=frames,
        fixed_shape=fixed_shape,
    )


def synthesizer_vocode(
    params: Params,
    z_p: torch.Tensor,
    y_mask: torch.Tensor,
    *,
    cfg: ModelConfig,
    sid: Optional[torch.Tensor] = None,
    g: Optional[torch.Tensor] = None,
    frames: Optional[Sequence[int]] = None,
    fixed_shape: bool = False,
) -> torch.Tensor:
    """Flow reverse + vocoder (models.py:719-720): z_p -> waveform
    (B, T_frames * upsample). Samples past each row's length are not
    defined. `frames`: each row's valid frames on the host, when known.
    `fixed_shape`: the graph-capturable mode (synthesizer_generate)."""
    if g is None:
        g = speaker_embedding(params, cfg, sid)
    z = synthesizer_flow(params, z_p, y_mask, cfg=cfg, g=g)
    return synthesizer_generate(
        params, z, y_mask, cfg=cfg, g=g, frames=frames, fixed_shape=fixed_shape
    )


def synthesizer_decode(
    params: Params,
    enc: EncodeResult,
    num_frames: int,
    *,
    cfg: ModelConfig,
    noise_scale,
    frame_noise: torch.Tensor,
    sid: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Prior expansion + flow reverse + vocoder (models.py:705-721).
    Returns (audio (B, num_frames * upsample), y_lengths (B,))."""
    z_p, y_mask = synthesizer_latents(
        params, enc, num_frames, cfg=cfg, noise_scale=noise_scale,
        frame_noise=frame_noise,
    )
    audio = synthesizer_vocode(params, z_p, y_mask, cfg=cfg, sid=sid)
    return audio, enc.durations.sum(dim=-1)


def infer(
    params: Params,
    ids: torch.Tensor,
    lengths: torch.Tensor,
    *,
    cfg: ModelConfig,
    max_frames: int,
    noise_scale,
    length_scale,
    noise_w_scale,
    dur_noise: torch.Tensor,
    frame_noise: torch.Tensor,
    sid: Optional[torch.Tensor] = None,
    dtype: torch.dtype = torch.float32,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-pass inference with a static frame budget. Durations are
    clamped to max_frames per row (overflow truncates trailing phonemes).
    Returns (audio (B, max_frames * upsample), y_lengths (B,))."""
    enc = synthesizer_encode(
        params, ids, lengths, cfg=cfg, noise_w_scale=noise_w_scale,
        length_scale=length_scale, dur_noise=dur_noise, sid=sid, dtype=dtype,
    )
    cum = torch.cumsum(enc.durations, dim=-1).clamp(max=max_frames)
    durations = torch.diff(cum, dim=-1, prepend=torch.zeros_like(cum[:, :1]))
    enc = enc._replace(durations=durations)
    return synthesizer_decode(
        params, enc, max_frames, cfg=cfg, noise_scale=noise_scale,
        frame_noise=frame_noise, sid=sid,
    )


# ---------------------------------------------------------------------------
# Random weights (smoke runs, benchmarks and training from scratch): numpy
# trees in the JAX package's layouts, with the distributions of its
# initialisers (models/vits/*.py init_*), layer by layer. Not bitwise
# the JAX draws.
# ---------------------------------------------------------------------------


class Init:
    """Numpy draws of the JAX initialisers' distributions (layers.py:30-73):
    kaiming-uniform convs and dense layers, HiFiGAN's normal(0, 0.01),
    zeroed layers, unit layer norms."""

    def __init__(self, seed: int):
        self.rng = np.random.default_rng(seed)

    def uniform(self, shape, bound):
        return self.rng.uniform(-bound, bound, shape).astype(np.float32)

    def normal(self, shape, std):
        return (self.rng.standard_normal(shape) * std).astype(np.float32)

    def conv(self, k, c_in, c_out, *, groups=1, std=None, bias=True, zero=False):
        fan_in = (c_in // groups) * k
        shape = (k, c_in // groups, c_out)
        if zero:
            w, b = np.zeros(shape, np.float32), np.zeros(c_out, np.float32)
        elif std is not None:
            w, b = self.normal(shape, std), self.uniform(c_out, 1 / math.sqrt(fan_in))
        else:
            w = self.uniform(shape, math.sqrt(3.0 / fan_in))
            b = self.uniform(c_out, 1 / math.sqrt(fan_in))
        return {"w": w, "b": b} if bias else {"w": w}

    def dense(self, c_in, c_out, zero=False):
        p = self.conv(1, c_in, c_out, zero=zero)
        return {"w": p["w"][0], "b": p["b"]}

    @staticmethod
    def norm(c):
        return {"gamma": np.ones(c, np.float32), "beta": np.zeros(c, np.float32)}

    def ddsconv(self, c, k, n_layers=3):
        return {
            "convs_sep": [self.conv(k, c, c, groups=c) for _ in range(n_layers)],
            "convs_1x1": [self.dense(c, c) for _ in range(n_layers)],
            "norms_1": [self.norm(c) for _ in range(n_layers)],
            "norms_2": [self.norm(c) for _ in range(n_layers)],
        }

    def wn(self, hidden, k, n_layers, gin):
        p = {
            "in_layers": [self.conv(k, hidden, 2 * hidden) for _ in range(n_layers)],
            "res_skip_layers": [
                self.dense(hidden, 2 * hidden if i < n_layers - 1 else hidden)
                for i in range(n_layers)
            ],
        }
        if gin:
            p["cond_layer"] = self.dense(gin, 2 * hidden * n_layers)
        return p


def init_synthesizer_params(seed: int, cfg: ModelConfig, *, training: bool = False) -> Params:
    """Random-weight inference tree for `cfg` (numpy leaves): VITS or
    VITS2 (flow_transformer: attn and attn_norm in every coupling layer;
    speaker_cond_encoder: enc_p.cond), HiFiGAN or MB-iSTFT (conv_post of
    subbands * (n_fft + 2) outputs with a bias). `training` adds the
    posterior encoder enc_q (model.py:38-56)."""
    r = Init(seed)
    h, ic, fc = cfg.hidden_channels, cfg.inter_channels, cfg.filter_channels
    kd = h ** -0.5

    def attention(n_heads=cfg.n_heads):
        xav = math.sqrt(6.0 / (2 * h))
        return {
            "q": {"w": r.uniform((h, h), xav), "b": np.zeros(h, np.float32)},
            "k": {"w": r.uniform((h, h), xav), "b": np.zeros(h, np.float32)},
            "v": {"w": r.uniform((h, h), xav), "b": np.zeros(h, np.float32)},
            "o": {"w": r.uniform((h, h), math.sqrt(3.0 / h)), "b": r.uniform(h, h ** -0.5)},
            "emb_rel_k": r.normal((1, 9, h // n_heads), (h // n_heads) ** -0.5),
            "emb_rel_v": r.normal((1, 9, h // n_heads), (h // n_heads) ** -0.5),
        }

    enc_p = {
        "emb": {"weight": r.normal((cfg.num_symbols, h), kd)},
        "encoder": {
            "layers": [
                {
                    "attn": attention(),
                    "norm1": r.norm(h),
                    "ffn": {
                        "conv1": r.conv(cfg.kernel_size, h, fc),
                        "conv2": r.conv(cfg.kernel_size, fc, h),
                    },
                    "norm2": r.norm(h),
                }
                for _ in range(cfg.n_layers)
            ]
        },
        "proj": r.dense(h, 2 * ic),
    }
    if cfg.speaker_cond_encoder and cfg.gin_channels:
        enc_p["cond"] = r.dense(cfg.gin_channels, h)

    def conv_flow():
        return {
            "pre": r.dense(1, h),
            "convs": r.ddsconv(h, cfg.kernel_size),
            "proj": r.dense(h, D.SDP_NUM_BINS * 3 - 1, zero=True),
        }

    def affine():
        return {"m": np.zeros(2, np.float32), "logs": np.zeros(2, np.float32)}

    if cfg.use_sdp:
        dp = {
            "pre": r.dense(h, h),
            "proj": r.dense(h, h),
            "convs": r.ddsconv(h, cfg.kernel_size),
            "flows": {"affine": affine(), "conv_flows": [conv_flow() for _ in range(4)]},
            "post_pre": r.dense(1, h),
            "post_proj": r.dense(h, h),
            "post_convs": r.ddsconv(h, cfg.kernel_size),
            "post_flows": {"affine": affine(), "conv_flows": [conv_flow() for _ in range(4)]},
        }
        if cfg.gin_channels:
            dp["cond"] = r.dense(cfg.gin_channels, h)
    else:
        dp = {
            "conv1": r.conv(cfg.kernel_size, h, 256), "norm1": r.norm(256),
            "conv2": r.conv(cfg.kernel_size, 256, 256), "norm2": r.norm(256),
            "proj": r.dense(256, 1),
        }
        if cfg.gin_channels:
            dp["cond"] = r.dense(cfg.gin_channels, h)

    def coupling():
        layer = {
            "pre": r.dense(ic // 2, h),
            "enc": r.wn(h, cfg.flow_kernel_size, cfg.flow_n_layers, cfg.gin_channels),
            "post": r.dense(h, ic // 2, zero=True),
        }
        if cfg.flow_transformer:  # flow.py:37-46: two heads
            layer["attn"] = attention(n_heads=2)
            layer["attn_norm"] = r.norm(h)
        return layer

    flow = {"layers": [coupling() for _ in range(cfg.flow_n_flows)]}

    uic = cfg.upsample_initial_channel
    dec: Params = {"conv_pre": r.conv(7, ic, uic), "ups": [], "resblocks": []}
    for i, (u, k) in enumerate(zip(cfg.upsample_rates, cfg.upsample_kernel_sizes)):
        c_in, c_out = uic // 2**i, uic // 2 ** (i + 1)
        dec["ups"].append(
            {"w": r.normal((k, c_in, c_out), 0.01), "b": r.uniform(c_out, 1 / math.sqrt(c_in * k))}
        )
        blocks = []
        for rk, rd in zip(cfg.resblock_kernel_sizes, cfg.resblock_dilation_sizes):
            if cfg.resblock == "1":
                blocks.append({
                    "convs1": [r.conv(rk, c_out, c_out, std=0.01) for _ in rd],
                    "convs2": [r.conv(rk, c_out, c_out, std=0.01) for _ in rd],
                })
            else:
                blocks.append({"convs": [r.conv(rk, c_out, c_out, std=0.01) for _ in rd]})
        dec["resblocks"].append(blocks)
    final_ch = uic // 2 ** len(cfg.upsample_rates)
    if cfg.vocoder == "mb_istft":  # istft_generator.py:35-44
        dec["conv_post"] = r.conv(7, final_ch, cfg.subbands * (cfg.istft_n_fft + 2))
    else:
        dec["conv_post"] = r.conv(7, final_ch, 1, bias=False)
    if cfg.gin_channels:
        dec["cond"] = r.dense(cfg.gin_channels, uic)

    p: Params = {"enc_p": enc_p, "dp": dp, "flow": flow, "dec": dec}
    if cfg.num_speakers > 1:
        p["emb_g"] = {"weight": r.normal((cfg.num_speakers, cfg.gin_channels), 1.0)}
    if training:
        p["enc_q"] = Q.init_posterior_encoder(r, cfg)
    return p
