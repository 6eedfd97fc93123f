"""Time-axis sharded vocoding with halo exchange.

Counterpart of piper_tpu/parallel/vocoder_shard.py. The decoder (flow
reverse + HiFiGAN) is convolutional with a bounded receptive field, so a
long utterance can be split across the mesh's 'model' axis along time:
each rank vocodes its frame range extended by `halo_frames` of each
neighbour's frames and keeps only its own samples. With a halo at least
the receptive field the result equals the monolithic decode up to float
reassociation (flow 4 x 4 convs of k=5 -> 32 frames, the generator ~10:
the default of 64 leaves margin for every preset).

JAX exchanges the halos with lax.ppermute. Here every rank all-gathers
its first and last `halo_frames` frames (z and mask) over the model
group and takes its neighbours' slices: gloo runs all_gather on CUDA
tensors as well as CPU ones, where it has no send/recv for CUDA. The
ends get zeros with mask 0, as in JAX.

As JAX's sharded_vocode runs apply_decoder (the plain generator), not
the Pallas path, this runs the port's plain, masked apply_decoder and
launches no kernel: the kernels mask by prefix lengths
(generator_tm_suffix), which a leading halo of masked zeros is not.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from ..config import ModelConfig
from ..models.vits import flow as F
from ..models.vits.model import apply_decoder, speaker_embedding
from .mesh import Mesh
from .sharding import all_gather

DEFAULT_HALO_FRAMES = 64


def sharded_vocode(
    params: Dict[str, Any],
    z_p: torch.Tensor,  # (B, T, C), T divisible by the axis's size
    y_mask: torch.Tensor,  # (B, T, 1)
    *,
    cfg: ModelConfig,
    mesh: Mesh,
    sid: Optional[torch.Tensor] = None,
    halo_frames: int = DEFAULT_HALO_FRAMES,
    axis: str = "model",
) -> torch.Tensor:
    """z_p -> waveform (B, T * upsample) on every rank, T sharded over
    `axis`: every rank passes the whole (B, T, C) and vocodes its T/m
    frames."""
    m = mesh.shape[axis]
    u = cfg.upsample_factor
    halo = halo_frames if m > 1 else 0  # one shard has no neighbour: the monolithic decode
    t = z_p.shape[1]
    if t % m:
        raise ValueError(f"{t} frames do not divide over the {axis} axis of {m}")
    t_local = t // m
    if halo > t_local:
        raise ValueError(f"halo_frames {halo} exceeds a shard's {t_local} frames")
    idx = mesh.coords[axis]
    z_local = z_p[:, idx * t_local : (idx + 1) * t_local]
    mask_local = y_mask[:, idx * t_local : (idx + 1) * t_local].to(z_p.dtype)
    g = speaker_embedding(params, cfg, sid)

    def with_halos(x):
        ends = torch.cat([x[:, :halo], x[:, t_local - halo :]], dim=1)  # (B, 2 * halo, ch)
        parts = all_gather(ends, mesh, axis)
        zeros = torch.zeros_like(x[:, :halo])
        left = parts[idx - 1][:, halo:] if idx > 0 else zeros
        right = parts[idx + 1][:, :halo] if idx < m - 1 else zeros
        return torch.cat([left, x, right], dim=1)

    z_ext, mask_ext = with_halos(z_local), with_halos(mask_local)
    z = F.flow_apply(params["flow"], z_ext, mask_ext, cfg=cfg, g=g, reverse=True)
    audio = apply_decoder(params, z * mask_ext, mask_ext, cfg=cfg, g=g)
    own = audio[:, halo * u : (halo + t_local) * u].contiguous()
    return torch.cat(all_gather(own, mesh, axis), dim=1)
