"""Text encoder: transformer with windowed relative-position attention.

Counterpart of piper_tpu/models/vits/encoder.py::text_encoder_apply
(line 382) and local_attention_apply (line 211), the windowed attention
of VITS2's flow. Parity target: reference TextEncoder (models.py:168-209) and
attentions.Encoder / MultiHeadAttention / FFN (attentions.py:12-74,
161-359, 362-427) with window_size=4 and shared relative-position heads.

The relative-position terms use the banded form (encoder.py:85-116):
logits against the 9-entry table are placed on the score diagonals, and
the attention weights are read back off them. Here both moves are one
torch.gather each; the selection is exact, so this equals the padded
reference form.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from ...config import ModelConfig
from . import layers as L

Params = Dict[str, Any]

WINDOW_SIZE = 4  # attentions.py:21


def _band_to_absolute(r: torch.Tensor, window: int) -> torch.Tensor:
    """(B, H, L, K=2w+1) banded logits -> (B, H, L, L) absolute.

    A[i, j] = r[i, j - i + w] inside the band, 0 outside."""
    b, h, l, k = r.shape
    io = torch.arange(l, device=r.device)
    idx = io[None, :] - io[:, None] + window  # (L, L)
    idx = torch.where((idx >= 0) & (idx < k), idx, torch.full_like(idx, k))
    r_pad = torch.cat([r, r.new_zeros(b, h, l, 1)], dim=-1)
    return torch.gather(r_pad, -1, idx.expand(b, h, l, l))


def _absolute_to_band(p_attn: torch.Tensor, window: int) -> torch.Tensor:
    """(B, H, L, L) attention weights -> (B, H, L, K=2w+1) band.

    band[i, o] = p_attn[i, i + o - w] (0 where out of range)."""
    b, h, l, _ = p_attn.shape
    k = 2 * window + 1
    io = torch.arange(l, device=p_attn.device)
    j = io[:, None] + torch.arange(k, device=p_attn.device)[None, :] - window
    inside = (j >= 0) & (j < l)
    band = torch.gather(p_attn, -1, j.clamp(0, l - 1).expand(b, h, l, k))
    return band * inside.to(band.dtype)


def attention_apply(
    p: Params,
    x: torch.Tensor,
    attn_mask: torch.Tensor,
    *,
    n_heads: int,
) -> torch.Tensor:
    """Self-attention. x: (B, T, C); attn_mask: (B, 1, T, T) {0,1}."""
    b, t, c = x.shape
    k_channels = c // n_heads
    scale = 1.0 / math.sqrt(k_channels)

    q = L.dense(p["q"], x).reshape(b, t, n_heads, k_channels)
    k = L.dense(p["k"], x).reshape(b, t, n_heads, k_channels)
    v = L.dense(p["v"], x).reshape(b, t, n_heads, k_channels)
    qs = (q * scale).float()

    # (B, H, Tq, Tk) in f32 for softmax stability.
    scores = torch.einsum("bqhd,bkhd->bhqk", qs, k.float())
    rel_k = p["emb_rel_k"].to(x.dtype).float()  # (1 or H, 2w+1, d)
    if rel_k.shape[0] == 1:
        rel_logits = torch.einsum("bqhd,od->bhqo", qs, rel_k[0])
    else:
        rel_logits = torch.einsum("bqhd,hod->bhqo", qs, rel_k)
    scores = scores + _band_to_absolute(rel_logits, WINDOW_SIZE)

    scores = scores.masked_fill(attn_mask == 0, -1e4)
    p_attn = torch.softmax(scores, dim=-1).to(x.dtype)

    out = torch.einsum("bhqk,bkhd->bqhd", p_attn, v)
    rel_v = p["emb_rel_v"].to(x.dtype)
    band_w = _absolute_to_band(p_attn, WINDOW_SIZE)
    if rel_v.shape[0] == 1:
        out = out + torch.einsum("bhqo,od->bqhd", band_w, rel_v[0])
    else:
        out = out + torch.einsum("bhqo,hod->bqhd", band_w, rel_v)
    return L.dense(p["o"], out.reshape(b, t, c))


def _shift_t(a: torch.Tensor, o: int) -> torch.Tensor:
    """a[:, i + o] along the time axis (1), zero past either end."""
    if o == 0:
        return a
    pad = [0, 0] * (a.ndim - 2)
    if o > 0:
        return F.pad(a, pad + [0, o])[:, o:]
    return F.pad(a, pad + [-o, 0])[:, : a.shape[1]]


def local_attention_apply(
    p: Params,
    x: torch.Tensor,
    x_mask: torch.Tensor,
    *,
    n_heads: int,
    window: int = WINDOW_SIZE,
) -> torch.Tensor:
    """Windowed self-attention: position i attends only to |j - i| <= w
    (piper_tpu/models/vits/encoder.py:211-280). x: (B, T, C); x_mask:
    (B, T, 1).

    Scores are computed in band form (B, H, T, 2w+1) from time-shifted
    keys and values, so the (T, T) matrix never exists; the band offset
    is the relative tables' index (emb_rel_k / emb_rel_v, (1 or H, 2w+1,
    d)). Slots past the sequence or its valid length score -1e4. As in
    JAX, the scores are float32 products of x.dtype operands and the
    weights times the values run in x.dtype. Its callers run it at one
    shape per row (the frame windows, the chunk window), which keeps a
    row's bits (PERF.md)."""
    b, t, c = x.shape
    k_channels = c // n_heads
    scale = 1.0 / math.sqrt(k_channels)
    kk = 2 * window + 1

    q = (L.dense(p["q"], x) * scale).reshape(b, t, n_heads, k_channels)
    k = L.dense(p["k"], x).reshape(b, t, n_heads, k_channels)
    v = L.dense(p["v"], x).reshape(b, t, n_heads, k_channels)

    k_band = torch.stack([_shift_t(k, o - window) for o in range(kk)], dim=2)
    v_band = torch.stack([_shift_t(v, o - window) for o in range(kk)], dim=2)
    # (B, T, K): 0 past the sequence or past its valid length
    valid = torch.stack([_shift_t(x_mask[..., 0], o - window) for o in range(kk)], dim=2)

    qf = q.float()
    scores = torch.einsum("bqhd,bqohd->bhqo", qf, k_band.float())
    rel_k = p["emb_rel_k"].to(x.dtype).float()  # (1 or H, 2w+1, d)
    if rel_k.shape[0] == 1:
        scores = scores + torch.einsum("bqhd,od->bhqo", qf, rel_k[0])
    else:
        scores = scores + torch.einsum("bqhd,hod->bhqo", qf, rel_k)
    scores = scores.masked_fill(valid[:, None] == 0, -1e4)
    p_attn = torch.softmax(scores, dim=-1).to(x.dtype)

    out = torch.einsum("bhqo,bqohd->bqhd", p_attn, v_band)
    rel_v = p["emb_rel_v"].to(x.dtype)
    if rel_v.shape[0] == 1:
        out = out + torch.einsum("bhqo,od->bqhd", p_attn, rel_v[0])
    else:
        out = out + torch.einsum("bhqo,hod->bqhd", p_attn, rel_v)
    return L.dense(p["o"], out.reshape(b, t, c))


def ffn_apply(
    p: Params, x: torch.Tensor, x_mask: torch.Tensor, *, kernel_size: int
) -> torch.Tensor:
    """Conv feed-forward (attentions.py:362-427, relu, non-causal)."""
    pad = ((kernel_size - 1) // 2, kernel_size // 2)
    y = L.conv(p["conv1"], x * x_mask, padding=pad)
    y = torch.relu(y)
    y = L.conv(p["conv2"], y * x_mask, padding=pad)
    return y * x_mask


def encoder_apply(
    p: Params, x: torch.Tensor, x_mask: torch.Tensor, *, cfg: ModelConfig
) -> torch.Tensor:
    attn_mask = x_mask[:, None, :, 0:1] * x_mask[:, None, None, :, 0]
    x = x * x_mask
    for lp in p["layers"]:
        y = attention_apply(lp["attn"], x, attn_mask, n_heads=cfg.n_heads)
        x = L.layer_norm(lp["norm1"], x + y)
        y = ffn_apply(lp["ffn"], x, x_mask, kernel_size=cfg.kernel_size)
        x = L.layer_norm(lp["norm2"], x + y)
    return x * x_mask


def text_encoder_apply(
    p: Params,
    ids: torch.Tensor,
    x_mask: torch.Tensor,
    *,
    cfg: ModelConfig,
    dtype: torch.dtype = torch.float32,
    g=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """ids: (B, T) integer; x_mask: (B, T, 1); g: (B, gin) or None.

    Returns (hidden x, m_p, logs_p), each (B, T, ·) (models.py:198-209),
    with VITS2's speaker conditioning when the tree has `cond`
    (encoder.py:400-401).
    """
    emb = p["emb"]["weight"].to(dtype)
    x = emb[ids.long()] * math.sqrt(cfg.hidden_channels)
    if "cond" in p and g is not None:
        x = x + L.dense(p["cond"], g.to(dtype)[:, None, :])
    x_mask = x_mask.to(dtype)
    x = encoder_apply(p["encoder"], x, x_mask, cfg=cfg)
    stats = L.dense(p["proj"], x) * x_mask
    m_p = stats[..., : cfg.inter_channels]
    logs_p = stats[..., cfg.inter_channels :]
    return x, m_p, logs_p
