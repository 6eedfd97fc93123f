"""Voice conversion: re-speak audio in another speaker's voice.

Counterpart of piper_tpu/runtime/voice_conversion.py. Parity: reference
SynthesizerTrn.voice_conversion (models.py:724-732) and the driver
(piper_train/voice_conversion.py:59-103): audio -> linear spectrogram
(ops/stft.spectrogram) -> posterior z (source speaker) -> flow forward
-> flow reverse with the target speaker -> vocoder.

The vocoder is the time-major HiFiGAN (generator.generator_tm_apply),
the same function as the JAX package's generator_apply: on the card it
launches mrf_fused once and fused_upsample_mrf twice per conversion; on
the CPU the same call takes the kernels' plain versions. The posterior's
noise is the JAX package's own stream, jax.random.normal(key, (B, T, C)),
drawn on the device by ops/prng.normal, so a seeded conversion gives the
JAX package's noise bit for bit. Everything runs in float32.

Requires a multi-speaker HiFiGAN voice with its posterior encoder
(enc_q: a training checkpoint, or an .npz exported with it; the
posterior encoder is pruned from inference-only ONNX exports).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from ..config import ModelConfig
from ..models.vits import flow as F
from ..models.vits import generator as G
from ..models.vits import posterior as Q
from ..models.vits.model import speaker_embedding
from ..ops import nn as tnn
from ..ops import prng
from ..ops.stft import spectrogram

Params = Dict[str, Any]


def check_convertible(params: Params, cfg: ModelConfig) -> None:
    """Raise unless `cfg` and `params` can convert: several speakers, the
    posterior encoder, and the HiFiGAN vocoder (the JAX package would
    send an MB-iSTFT voice's latents into the HiFiGAN generator)."""
    if cfg.num_speakers <= 1:
        raise ValueError("voice conversion needs a multi-speaker model")
    if "enc_q" not in params:
        raise ValueError(
            "voice conversion needs the posterior encoder (train checkpoint)"
        )
    if cfg.vocoder != "hifigan":
        raise ValueError(
            f"voice conversion decodes with the HiFiGAN generator; this voice's "
            f"vocoder is {cfg.vocoder!r}"
        )


def voice_convert_spec(
    params: Params,
    spec: torch.Tensor,
    spec_lengths: torch.Tensor,
    sid_src: torch.Tensor,
    sid_tgt: torch.Tensor,
    *,
    cfg: ModelConfig,
    tm: Optional[Params] = None,
    key: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """(B, T, spec_channels) spectrogram -> converted waveform (B, S).

    `params`: the port's float32 tensor tree (weights/bridge.params_from_jax)
    with enc_q; `tm`: generator.prepare_tm(params["dec"], cfg, float32),
    built here when None; `key`: an ops/prng key (prng_key(seed)) for the
    posterior's noise, None for the mean. Samples past a row's
    spec_lengths * upsample_factor are not defined."""
    check_convertible(params, cfg)
    y_mask = tnn.sequence_mask(spec_lengths, spec.shape[1]).to(spec.dtype)
    g_src = speaker_embedding(params, cfg, sid_src)
    g_tgt = speaker_embedding(params, cfg, sid_tgt)

    noise = None
    if key is not None:
        noise = prng.normal(
            key.to(spec.device), (spec.shape[0], spec.shape[1], cfg.inter_channels)
        )
    z, _m_q, _logs_q = Q.posterior_encode(
        params["enc_q"], spec, y_mask, cfg=cfg, g=g_src, noise=noise
    )
    z_p = F.flow_apply(params["flow"], z, y_mask, cfg=cfg, g=g_src, reverse=False)
    z_hat = F.flow_apply(params["flow"], z_p, y_mask, cfg=cfg, g=g_tgt, reverse=True)
    if tm is None:
        tm = G.prepare_tm(params["dec"], cfg, torch.float32)
    return G.generator_tm_apply(
        params["dec"], tm, z_hat * y_mask, spec_lengths, cfg=cfg, g=g_tgt
    )


def voice_convert_audio(
    params: Params,
    audio: np.ndarray,
    sid_src: int,
    sid_tgt: int,
    *,
    cfg: ModelConfig,
    tm: Optional[Params] = None,
    key: Optional[torch.Tensor] = None,
) -> np.ndarray:
    """float32 waveform -> converted float32 waveform (batch-1 helper), on
    the device of `params`. The speakers are checked on the host (on the
    card an embedding row out of range ends the CUDA context)."""
    check_convertible(params, cfg)
    for sid in (sid_src, sid_tgt):
        if not 0 <= sid < cfg.num_speakers:
            raise ValueError(
                f"speaker {sid} out of range: this voice has {cfg.num_speakers} speakers"
            )
    device = params["dec"]["conv_pre"]["w"].device
    a = cfg.audio
    y = torch.as_tensor(np.asarray(audio, np.float32), device=device)[None, :]
    with torch.inference_mode():
        spec = spectrogram(
            y, n_fft=a.filter_length, hop_length=a.hop_length,
            win_length=a.win_length,
        )
        out = voice_convert_spec(
            params, spec,
            torch.tensor([spec.shape[1]], dtype=torch.int32, device=device),
            torch.tensor([sid_src], device=device), torch.tensor([sid_tgt], device=device),
            cfg=cfg, tm=tm, key=key,
        )
        return out[0].float().cpu().numpy()
