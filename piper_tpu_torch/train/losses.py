"""GAN / VAE losses.

Counterpart of piper_tpu/train/losses.py. Parity: reference losses.py —
LSGAN discriminator/generator losses, feature matching (x2), masked KL.
All reductions in float32.

BatchShard is the data-parallel step's reduction hook
(parallel/sharding.py): JAX's sharded step is one global step over the
whole batch, and a rank of the port sees only its rows, so each loss
term a rank builds is its share of the whole batch's term.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist


class BatchShard:
    """The rows of a batch this process holds, share `index` of `count`
    equal shares over the data-parallel process group `group`, and the
    reductions that make its loss terms global: the terms of all the
    shares sum to the whole batch's term. BatchShard() holds the whole
    batch, and every method is then the identity (the one-device step
    keeps its bits)."""

    def __init__(self, group: Optional[dist.ProcessGroup] = None, index: int = 0, count: int = 1):
        self.group, self.index, self.count = group, index, count

    def batch(self, rows: int) -> int:
        """The whole batch's rows, of a share's `rows`."""
        return rows * self.count

    def rows(self, x: torch.Tensor) -> torch.Tensor:
        """This share's rows of x (a random draw at the whole batch's
        shape, or the whole batch itself)."""
        if self.count == 1:
            return x
        n = x.shape[0] // self.count
        return x[self.index * n : (self.index + 1) * n]

    def total(self, x: torch.Tensor) -> torch.Tensor:
        """x summed over the shares (detached)."""
        if self.count == 1:
            return x
        x = x.detach().clone()
        dist.all_reduce(x, group=self.group)
        return x

    def ratio(self, num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
        """This share's term of sum(num) / sum(den) over the whole batch:
        its masked sum over the all-reduced denominator (the masks carry
        no gradient). A mean of the shares' own ratios is not the whole
        batch's once their masks differ."""
        return num / self.total(den)

    def share(self, mean: torch.Tensor) -> torch.Tensor:
        """This share's term of a mean over equal-shape shares."""
        return mean if self.count == 1 else mean / self.count

    def total_grads(
        self, grads: Sequence[Optional[torch.Tensor]], params: Sequence[torch.Tensor]
    ) -> List[Optional[torch.Tensor]]:
        """Each parameter's gradient summed over the shares (None counts
        as zeros), in one all-reduce."""
        if self.count == 1:
            return list(grads)
        flat = torch.cat([(torch.zeros_like(p) if g is None else g).reshape(-1)
                          for g, p in zip(grads, params)])
        dist.all_reduce(flat, group=self.group)
        return [g.view_as(p) for g, p in zip(flat.split([p.numel() for p in params]), params)]


WHOLE = BatchShard()


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


def kl_loss(z_p, logs_q, m_p, logs_p, z_mask, shard: BatchShard = WHOLE) -> torch.Tensor:
    """Masked KL(q||p) between posterior and expanded prior
    (losses.py:43-58). Inputs (B, T, C); z_mask (B, T, 1)."""
    z_p, logs_q, m_p, logs_p, z_mask = (t.float() for t in (z_p, logs_q, m_p, logs_p, z_mask))
    kl = logs_p - logs_q - 0.5
    kl = kl + 0.5 * torch.square(z_p - m_p) * torch.exp(-2.0 * logs_p)
    return shard.ratio(torch.sum(kl * z_mask), torch.sum(z_mask))
