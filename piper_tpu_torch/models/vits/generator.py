"""HiFiGAN generator (vocoder): frames -> waveform.

Counterpart of piper_tpu/models/vits/generator.py. Parity: reference
Generator (models.py:299-368) and ResBlock1/2 (modules.py:220-368).

Two paths, as in the JAX package:
- generator_apply (line 405) / resblock_apply (line 59): the
  reference-shaped plain torch path (NWC, masks after every conv);
- generator_tm_apply (line 293): the time-major serving path. The
  transposed convs are polyphase products, and the MRF stacks run in
  the CUDA kernels of ops/cuda/vocoder.py (their plain versions on the
  CPU).

The stage split is Hopper's, not the TPU's: the JAX split asks whether a
stage's packed weights and tiles fit VMEM (_tm_start_stage,
_fused_suffix_start, vocoder.py mrf_weight_bytes / fused_stage_vmem_ok),
which depends on the element size. Here the kernels stream weights from
L2, so only the tile has to fit the 227 KB of shared memory of a block.
The split is decided at 4 bytes per element, so both precisions run the
same split; on the medium voice that is the TPU's bf16 split: stage 0 in
mrf_fused after a polyphase product, stages 1-2 chained in
fused_upsample_mrf. Any split computes the same function.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from ...config import ModelConfig
from ...ops import nn as tnn
from ...ops.cuda import vocoder as V
from . import layers as L

Params = Dict[str, Any]

LRELU_SLOPE = 0.1
SPLIT_ESIZE = 4  # bytes per element the stage split is decided at


def _get_padding(kernel_size: int, dilation: int) -> int:
    return (kernel_size * dilation - dilation) // 2


def resblock_apply(
    p: Params,
    x: torch.Tensor,
    x_mask: Optional[torch.Tensor],
    *,
    kernel_size: int,
    dilations,
    resblock_type: str,
) -> torch.Tensor:
    def mask(v):
        return v if x_mask is None else v * x_mask

    if resblock_type == "1":
        for c1, c2, d in zip(p["convs1"], p["convs2"], dilations):
            xt = mask(tnn.leaky_relu(x, LRELU_SLOPE))
            xt = L.conv(c1, xt, padding=_get_padding(kernel_size, d), dilation=d)
            xt = mask(tnn.leaky_relu(xt, LRELU_SLOPE))
            xt = L.conv(c2, xt, padding=_get_padding(kernel_size, 1), dilation=1)
            x = xt + x
    else:
        for c, d in zip(p["convs"], dilations):
            xt = mask(tnn.leaky_relu(x, LRELU_SLOPE))
            xt = L.conv(c, xt, padding=_get_padding(kernel_size, d), dilation=d)
            x = xt + x
    return mask(x)


def _mrf_nwc(blocks, x, mask, cfg: ModelConfig):
    xs = None
    for j, bp in enumerate(blocks):
        r = resblock_apply(
            bp, x, mask, kernel_size=cfg.resblock_kernel_sizes[j],
            dilations=cfg.resblock_dilation_sizes[j], resblock_type=cfg.resblock,
        )
        xs = r if xs is None else xs + r
    return xs / len(blocks)


def generator_apply(
    p: Params,
    x: torch.Tensor,
    x_mask: Optional[torch.Tensor],
    *,
    cfg: ModelConfig,
    g: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """x: (B, T_frames, C) pre-masked latent; returns (B, T_frames * prod(rates))."""
    x = L.conv(p["conv_pre"], x, padding=3)
    if g is not None:
        x = x + L.dense(p["cond"], g[:, None, :])
    if x_mask is not None:
        x = x * x_mask
    for i, (u, k) in enumerate(zip(cfg.upsample_rates, cfg.upsample_kernel_sizes)):
        x = tnn.leaky_relu(x, LRELU_SLOPE)
        x = tnn.conv1d_transpose(
            x, p["ups"][i]["w"], p["ups"][i]["b"], stride=u, padding=(k - u) // 2
        )
        if x_mask is not None:
            x_mask = torch.repeat_interleave(x_mask, u, dim=1)
            x = x * x_mask
        x = _mrf_nwc(p["resblocks"][i], x, x_mask, cfg)
    # torch F.leaky_relu default slope 0.01 here (models.py:364)
    x = tnn.leaky_relu(x, 0.01)
    x = torch.tanh(L.conv(p["conv_post"], x, padding=3))
    if x_mask is not None:
        x = x * x_mask
    return x[..., 0]


# ---------------------------------------------------------------------------
# Time-major serving path
# ---------------------------------------------------------------------------


def _tm_phase_plan(k: int, u: int):
    """Static polyphase plan for one ConvTranspose1d stage.

    With the pre-flipped (k, c_in, c_out) kernel, output t = u*v + p is
    out[t] = sum over taps idx = u*q + (k-1-P-p) in [0, k) of
    K[idx]^T x[v + q]. Returns (q0, used, idx): tap offsets start at
    q0, `used[p, qi]` marks real taps, `idx[p, qi]` the kernel row.
    """
    pad = (k - u) // 2
    nq = -(-k // u) + 1
    q0 = -1
    used = np.zeros((u, nq), bool)
    idx = np.zeros((u, nq), np.int32)
    for p in range(u):
        base = k - 1 - pad - p
        for qi in range(nq):
            t = u * (q0 + qi) + base
            if 0 <= t < k:
                used[p, qi] = True
                idx[p, qi] = t
    return q0, used, idx


def tm_start_stage(cfg: ModelConfig) -> int:
    """First upsample stage to run time-major: the first whose MRF stage
    fits mrf_fused's shared-memory tile (earlier, wider stages run the
    NWC path)."""
    uic = cfg.upsample_initial_channel
    for i in range(len(cfg.upsample_rates)):
        if V.mrf_fits(
            uic // 2 ** (i + 1), cfg.resblock_kernel_sizes,
            cfg.resblock_dilation_sizes, cfg.resblock, SPLIT_ESIZE,
        ):
            return i
    return len(cfg.upsample_rates)


def fused_suffix_start(cfg: ModelConfig, start: int) -> int:
    """First stage of the trailing run of chained fused_upsample_mrf
    launches: the smallest f >= start such that every stage in [f, n)
    fits the fused kernel with its compound plane count. Returns n when
    no suffix qualifies."""
    uic = cfg.upsample_initial_channel
    n = len(cfg.upsample_rates)
    for f in range(start, n):
        u_in = 1
        ok = True
        for j in range(f, n):
            u_j, k_j = cfg.upsample_rates[j], cfg.upsample_kernel_sizes[j]
            _, used_j, _ = _tm_phase_plan(k_j, u_j)
            if not V.fused_stage_fits(
                uic // 2**j, uic // 2 ** (j + 1), u_j, used_j.shape[1],
                cfg.resblock_kernel_sizes, cfg.resblock_dilation_sizes,
                cfg.resblock, u_in=u_in, post=j == n - 1, esize=SPLIT_ESIZE,
            ):
                ok = False
                break
            u_in *= u_j
        if ok:
            return f
    return n


def prepare_tm(
    dec_params: Params, cfg: ModelConfig, dtype: torch.dtype = torch.bfloat16
) -> Params:
    """Derived weights of the time-major path: per-stage polyphase tables
    (u, nq, c_in, c_out) and packed MRF weights for the kernels, on the
    device of the generator's weights."""
    ks = tuple(cfg.resblock_kernel_sizes)
    ds = tuple(tuple(d) for d in cfg.resblock_dilation_sizes)
    start = tm_start_stage(cfg)
    ups, mrf = [], []
    for i, (u, k) in enumerate(zip(cfg.upsample_rates, cfg.upsample_kernel_sizes)):
        if i < start:
            ups.append(None)
            mrf.append(None)
            continue
        kern = dec_params["ups"][i]["w"]
        q0, used, idx = _tm_phase_plan(k, u)
        w = kern.new_zeros(used.shape + tuple(kern.shape[1:]), dtype=torch.float32)
        for p in range(used.shape[0]):
            for qi in range(used.shape[1]):
                if used[p, qi]:
                    w[p, qi] = kern[int(idx[p, qi])].float()
        ups.append(w.to(dtype).contiguous())
        mrf.append(
            V.pack_stage_weights(dec_params["resblocks"][i], ks, ds, cfg.resblock, dtype=dtype)
        )
    return {
        "ups": ups,
        "mrf": mrf,
        "ups_b": [up["b"].float().contiguous() for up in dec_params["ups"]],
        "post": dec_params["conv_post"]["w"].to(dtype).contiguous(),
    }


def _tconv_tm(x_tm, w_phase, q0, used, bias):
    """Polyphase time-major transposed conv: (B, C_in, V) -> (B, C_out, V*u).

    The nq shifted input views are stacked once and contracted over
    (tap, c_in) in one product; the output comes out u-minor, so the
    interleave is a reshape. A plain product outside any kernel, as in
    the JAX package (generator.py:264)."""
    uph, nq = used.shape
    b, c_in, v = x_tm.shape
    segs = []
    for qi in range(nq):
        q = q0 + qi
        seg = torch.nn.functional.pad(x_tm, (max(-q, 0), max(q, 0)))
        segs.append(seg[:, :, max(q, 0) : max(q, 0) + v])
    taps = torch.stack(segs, dim=1)  # (B, nq, C_in, V)
    out = torch.einsum("pqio,bqiv->bovp", w_phase.to(x_tm.dtype), taps)
    out = out.reshape(b, out.shape[1], v * uph)
    return out + bias.to(out.dtype)[None, :, None]


def _tconv_tm_rows(x_tm, w_phase, q0, used, bias, lengths: Sequence[int]):
    """_tconv_tm one row at a time, each at its own valid length (zeros
    past it), so a row's bits do not depend on the batch it rides in:
    cuBLAS picks its algorithm, split-K or not, by the product's shape,
    and a split sums in another order, so a row decoded inside a batch
    would round differently from the same row alone (chip_smoke.py
    checks the bits)."""
    b, _, v = x_tm.shape
    u = used.shape[0]
    out = torch.zeros((b, w_phase.shape[-1], v * u), dtype=x_tm.dtype, device=x_tm.device)
    for r, n in enumerate(lengths):
        if n:
            out[r, :, : n * u] = _tconv_tm(x_tm[r : r + 1, :, :n], w_phase, q0, used, bias)[0]
    return out


def _nwc_stage_rows(p, i: int, x, lengths: Sequence[int], cfg: ModelConfig):
    """Upsample stage i on the NWC path (cuDNN transposed conv, then
    _mrf_nwc), (B, T, C_in) -> (B, T*u, C_out), one row at a time at its
    own valid length (zeros past it), as _tconv_tm_rows and for its
    reason: cuDNN picks its algorithm by the batch's shape."""
    u, k = cfg.upsample_rates[i], cfg.upsample_kernel_sizes[i]
    up = p["ups"][i]
    out = x.new_zeros((x.shape[0], x.shape[1] * u, up["w"].shape[-1]))
    for r, n in enumerate(lengths):
        if n:
            y = tnn.leaky_relu(x[r : r + 1, :n], LRELU_SLOPE)
            y = tnn.conv1d_transpose(y, up["w"], up["b"], stride=u, padding=(k - u) // 2)
            out[r, : n * u] = _mrf_nwc(p["resblocks"][i], y, None, cfg)[0]
    return out


def _conv_pre(p, x, g):
    """conv_pre (+ the speaker's cond), (B, T, C_inter) -> (B, T, C)."""
    x = L.conv(p["conv_pre"], x, padding=3)
    if g is not None:
        x = x + L.dense(p["cond"], g[:, None, :])
    return x


def _conv_pre_rows(p, x, g, lengths: Sequence[int]):
    """_conv_pre one row at a time at its own valid length (zeros past
    it), as _tconv_tm_rows and for its reason: on the x-low and high
    presets cuDNN rounds a row of conv_pre differently in a batch."""
    out = x.new_zeros(x.shape[:2] + (p["conv_pre"]["w"].shape[-1],))
    for r, n in enumerate(lengths):
        if n:
            out[r, :n] = _conv_pre(p, x[r : r + 1, :n], None if g is None else g[r : r + 1])[0]
    return out


def _time_mask(lens: torch.Tensor, t: int, dtype) -> torch.Tensor:
    """(B, t) 1 before each row's length, 0 after."""
    return (torch.arange(t, device=lens.device)[None, :] < lens[:, None]).to(dtype)


def _nwc_stage_masked(p, i: int, x, lens: torch.Tensor, cfg: ModelConfig):
    """_nwc_stage_rows over the whole batch at its full length, masked by
    the device lengths (frames in, samples out): the fixed-shape mode of
    generator_tm_apply, as generator_apply masks."""
    u, k = cfg.upsample_rates[i], cfg.upsample_kernel_sizes[i]
    up = p["ups"][i]
    y = tnn.leaky_relu(x, LRELU_SLOPE)
    y = tnn.conv1d_transpose(y, up["w"], up["b"], stride=u, padding=(k - u) // 2)
    mask = _time_mask(lens * u, y.shape[1], y.dtype)[..., None]
    return _mrf_nwc(p["resblocks"][i], y * mask, mask, cfg)


def keeps_row_bits(cfg: ModelConfig) -> bool:
    """Whether every plain stage of the time-major path lies before its
    first kernel (generator_tm_prefix), so frame windows can hold them
    all: true when at most one polyphase product precedes the fused
    chain (every preset; runtime/voice.py's speculative path needs it)."""
    start = tm_start_stage(cfg)
    return fused_suffix_start(cfg, start) <= start + 1


def prefix_factor(cfg: ModelConfig) -> int:
    """Samples per frame of generator_tm_prefix's output."""
    start = tm_start_stage(cfg)
    f = int(np.prod(cfg.upsample_rates[:start])) if start else 1
    if fused_suffix_start(cfg, start) > start:
        f *= cfg.upsample_rates[start]
    return f


def prefix_halo(cfg: ModelConfig) -> int:
    """Frames on either side that one frame of generator_tm_prefix's
    output depends on: conv_pre's taps, each plain upsample stage's
    transposed conv and MRF block (its widest resblock), rounded up per
    stage."""
    halo = (7 - 1) // 2  # conv_pre
    start = tm_start_stage(cfg)
    rate = 1
    for i in range(min(fused_suffix_start(cfg, start), len(cfg.upsample_rates))):
        u, k = cfg.upsample_rates[i], cfg.upsample_kernel_sizes[i]
        halo += -(-k // u) + 1  # the transposed conv, in its input frames
        rate *= u
        if i < start:  # an NWC stage's MRF block, in samples of its output
            mrf = max(
                sum((kk * d - d) // 2 + ((kk - 1) // 2 if cfg.resblock == "1" else 0) for d in dil)
                for kk, dil in zip(cfg.resblock_kernel_sizes, cfg.resblock_dilation_sizes)
            )
            halo += -(-mrf // rate)
    return halo


def generator_tm_prefix(
    p: Params, tm: Params, x: torch.Tensor, mask: torch.Tensor, *, cfg: ModelConfig,
    g: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The time-major path's plain stages before its first kernel, under
    a mask: conv_pre (+ the speaker's cond), the wide NWC stages and the
    polyphase product before mrf_fused. x: (B, T, C) latent; mask: (B,
    T, 1), any 0/1 pattern (a frame window's valid span). Returns the
    time-major (B, C, T * prefix_factor) input of the first kernel,
    masked. No host read and no length on the host: a CUDA graph holds
    it at a frame window's shape (runtime/voice.py)."""
    start = tm_start_stage(cfg)
    x = _conv_pre(p, x, g) * mask
    for i in range(start):
        u, k = cfg.upsample_rates[i], cfg.upsample_kernel_sizes[i]
        up = p["ups"][i]
        y = tnn.conv1d_transpose(tnn.leaky_relu(x, LRELU_SLOPE), up["w"], up["b"], stride=u,
                                 padding=(k - u) // 2)
        mask = torch.repeat_interleave(mask, u, dim=1)
        x = _mrf_nwc(p["resblocks"][i], y * mask, mask, cfg)
    x = x.transpose(1, 2).contiguous()  # (B, C, T)
    if fused_suffix_start(cfg, start) > start:
        u, k = cfg.upsample_rates[start], cfg.upsample_kernel_sizes[start]
        q0, used, _ = _tm_phase_plan(k, u)
        x = _tconv_tm(tnn.leaky_relu(x, LRELU_SLOPE), tm["ups"][start], q0, used, tm["ups_b"][start])
        x = x * torch.repeat_interleave(mask, u, dim=1).transpose(1, 2)
    return x


def generator_tm_suffix(
    p: Params, tm: Params, x: torch.Tensor, frame_lengths: torch.Tensor, *, cfg: ModelConfig,
    host_lens: Optional[Sequence[int]] = None,
) -> torch.Tensor:
    """The time-major path from generator_tm_prefix's output on: mrf_fused,
    any further polyphase products with their mrf_fused (row by row at
    `host_lens`, the prefix's valid samples, when given), then the chain
    of fused_upsample_mrf launches with conv_post and tanh. x: (B, C, V)
    masked; frame_lengths: (B,) valid frames on the device. Returns (B,
    V / prefix_factor * u_total); samples past a row's length are not
    defined. The kernels mask by the device lengths with one sum order per
    element, so a row's bits do not depend on V or the batch."""
    ks = tuple(cfg.resblock_kernel_sizes)
    ds = tuple(tuple(d) for d in cfg.resblock_dilation_sizes)
    start = tm_start_stage(cfg)
    n_stages = len(cfg.upsample_rates)
    fuse_from = fused_suffix_start(cfg, start)
    lens = frame_lengths.to(device=x.device, dtype=torch.int32) * prefix_factor(cfg)
    for i in range(start, fuse_from):
        if i > start:  # a plain product between kernels (no preset has one)
            u, k = cfg.upsample_rates[i], cfg.upsample_kernel_sizes[i]
            q0, used, _ = _tm_phase_plan(k, u)
            x = tnn.leaky_relu(x, LRELU_SLOPE)
            if host_lens is None:
                x = _tconv_tm(x, tm["ups"][i], q0, used, tm["ups_b"][i])
                x = x * _time_mask(lens * u, x.shape[-1], x.dtype)[:, None, :]
            else:
                x = _tconv_tm_rows(x, tm["ups"][i], q0, used, tm["ups_b"][i], host_lens)
                host_lens = [n * u for n in host_lens]
            lens = lens * u
        pw, pb = tm["mrf"][i]
        x = V.mrf_fused(
            x, lens, pw, pb, kernel_sizes=ks, dilation_sizes=ds,
            resblock_type=cfg.resblock,
        )
    if fuse_from < n_stages:
        b, v_frames = x.shape[0], x.shape[2]
        u_in = 1
        for j in range(fuse_from, n_stages):
            u, k = cfg.upsample_rates[j], cfg.upsample_kernel_sizes[j]
            q0, _, _ = _tm_phase_plan(k, u)
            pw, pb = tm["mrf"][j]
            post = j == n_stages - 1
            x = V.fused_upsample_mrf(
                x, lens * (u * u_in), tm["ups"][j], tm["ups_b"][j], pw, pb,
                tm["post"] if post else None, u=u, u_in=u_in, q0=q0,
                kernel_sizes=ks, dilation_sizes=ds, resblock_type=cfg.resblock,
                post=post,
            )
            u_in *= u
        # waveform planes (B, U, V) -> (B, V*U)
        return x.transpose(1, 2).reshape(b, v_frames * u_in)
    x = tnn.leaky_relu(x, 0.01)
    kp = tm["post"].to(x.dtype)  # (7, C, 1)
    v = x.shape[2]
    pad = (kp.shape[0] - 1) // 2
    xp = torch.nn.functional.pad(x, (pad, pad))
    acc = sum(
        torch.einsum("i,biv->bv", kp[tau, :, 0], xp[:, :, tau : tau + v])
        for tau in range(kp.shape[0])
    )
    return torch.tanh(acc)


def generator_tm_apply(
    p: Params,
    tm: Params,
    x: torch.Tensor,
    frame_lengths: torch.Tensor,
    *,
    cfg: ModelConfig,
    g: Optional[torch.Tensor] = None,
    row_frames: Optional[Sequence[int]] = None,
    fixed_shape: bool = False,
) -> torch.Tensor:
    """Time-major generator. x: (B, T_frames, C) pre-masked latent;
    frame_lengths: (B,) valid frames. Returns (B, T*u_total); samples
    past each row's length are not defined (compare valid samples).
    conv_pre and the plain stages before the kernels run row by row
    (_conv_pre_rows, _nwc_stage_rows, _tconv_tm_rows), so each row gives
    the bits it gives alone.
    `row_frames`: the same lengths on the host, when the caller has them
    (saves reading frame_lengths back).

    `fixed_shape`: the mode a CUDA graph captures (runtime/graphs.py):
    generator_tm_prefix under the length mask, then generator_tm_suffix,
    so no length is read back to the host and every launch's shape
    follows x's alone. A row's valid samples are the same function as
    row by row; on the card they may round differently (cuBLAS and cuDNN
    pick algorithms by shape). The serving decode runs the prefix in
    fixed frame windows instead (runtime/voice.py), which keeps a row's
    bits at any width."""
    lens = frame_lengths.to(device=x.device, dtype=torch.int32)
    if fixed_shape:
        mask = (torch.arange(x.shape[1], device=x.device)[None, :, None]
                < lens[:, None, None]).to(x.dtype)
        return generator_tm_suffix(p, tm, generator_tm_prefix(p, tm, x, mask, cfg=cfg, g=g), lens,
                                   cfg=cfg)
    start = tm_start_stage(cfg)
    fuse_from = fused_suffix_start(cfg, start)
    host_lens = list(row_frames) if row_frames is not None else lens.tolist()
    x = _conv_pre_rows(p, x, g, host_lens)
    mask = (
        torch.arange(x.shape[1], device=x.device)[None, :, None] < lens[:, None, None]
    ).to(x.dtype)
    x = x * mask
    for i in range(start):
        # wide early stages whose MRF tile does not fit shared memory
        x = _nwc_stage_rows(p, i, x, host_lens, cfg)
        host_lens = [n * cfg.upsample_rates[i] for n in host_lens]
    x = x.transpose(1, 2).contiguous()  # (B, C, T)
    if fuse_from > start:
        u, k = cfg.upsample_rates[start], cfg.upsample_kernel_sizes[start]
        q0, used, _ = _tm_phase_plan(k, u)
        x = tnn.leaky_relu(x, LRELU_SLOPE)
        x = _tconv_tm_rows(x, tm["ups"][start], q0, used, tm["ups_b"][start], host_lens)
        host_lens = [n * u for n in host_lens]
    return generator_tm_suffix(p, tm, x, lens, cfg=cfg, host_lens=host_lens)
