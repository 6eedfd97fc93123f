"""GAN / VAE losses.

Counterpart of piper_tpu/train/losses.py. Parity: reference losses.py —
LSGAN discriminator/generator losses, feature matching (x2), masked KL.
All reductions in float32.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch


def feature_loss(fmap_r, fmap_g) -> torch.Tensor:
    """Mean-abs feature matching over all discriminator fmaps, x2
    (losses.py:4-12). The real features carry no generator gradient."""
    loss = 0.0
    for dr, dg in zip(fmap_r, fmap_g):
        for rl, gl in zip(dr, dg):
            loss = loss + torch.mean(torch.abs(rl.float() - gl.float()))
    return loss * 2.0


def discriminator_loss(
    disc_real: Sequence[torch.Tensor], disc_gen: Sequence[torch.Tensor]
) -> Tuple[torch.Tensor, List[torch.Tensor], List[torch.Tensor]]:
    """LSGAN: (1-D(y))^2 + D(y_hat)^2 (losses.py:15-28)."""
    loss = 0.0
    r_losses, g_losses = [], []
    for dr, dg in zip(disc_real, disc_gen):
        r = torch.mean(torch.square(1.0 - dr.float()))
        g = torch.mean(torch.square(dg.float()))
        loss = loss + r + g
        r_losses.append(r)
        g_losses.append(g)
    return loss, r_losses, g_losses


def generator_loss(
    disc_outputs: Sequence[torch.Tensor],
) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """LSGAN generator: (1-D(y_hat))^2 (losses.py:31-40)."""
    loss = 0.0
    gen_losses = []
    for dg in disc_outputs:
        l = torch.mean(torch.square(1.0 - dg.float()))
        gen_losses.append(l)
        loss = loss + l
    return loss, gen_losses


def kl_loss(z_p, logs_q, m_p, logs_p, z_mask) -> torch.Tensor:
    """Masked KL(q||p) between posterior and expanded prior
    (losses.py:43-58). Inputs (B, T, C); z_mask (B, T, 1)."""
    z_p, logs_q, m_p, logs_p, z_mask = (t.float() for t in (z_p, logs_q, m_p, logs_p, z_mask))
    kl = logs_p - logs_q - 0.5
    kl = kl + 0.5 * torch.square(z_p - m_p) * torch.exp(-2.0 * logs_p)
    return torch.sum(kl * z_mask) / torch.sum(z_mask)
