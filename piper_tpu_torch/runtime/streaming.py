"""Streaming chunked synthesis (latency mode).

Counterpart of piper_tpu/runtime/streaming.py. As in the reference's
streaming chunker (src/python/piper_train/infer_onnx_streaming.py:76-108)
the latent z_p is decoded (flow reverse + vocoder, through both CUDA
kernels) in chunks of `chunk_frames` (default 45) with `pad_frames`
(default 10) of neighbouring context on each side; the decoded pad
samples (pad * upsample_factor) are trimmed, so the chunks concatenate
with small seams. The final chunk trims only what was actually padded
(the reference trims a stale pad there and drops tail samples).

Differences from the JAX package:
- PyTorch has no static shapes, so each chunk is decoded at its own
  length (a chunk's valid samples do not depend on the length it is
  decoded at);
- the latents of any frame count come from one call, with the batch
  path's own noise (utterance_seed, duration_noise, frame_noise), so
  one branch serves every length and a seeded utterance gets the same
  durations streamed and batched.
"""

from __future__ import annotations

from typing import Iterator, Optional

import numpy as np
import torch

from ..config import SynthesisConfig
from ..models.vits import model as M
from . import batching
from .voice import utterance_seed

DEFAULT_CHUNK_FRAMES = 45  # infer_onnx_streaming.py:28-39
DEFAULT_PAD_FRAMES = 10


class StreamingDecoder:
    """Chunked vocoder around a TorchVoice."""

    def __init__(
        self,
        voice,
        chunk_frames: int = DEFAULT_CHUNK_FRAMES,
        pad_frames: int = DEFAULT_PAD_FRAMES,
    ):
        self.voice = voice
        self.chunk_frames = chunk_frames
        self.pad_frames = pad_frames
        self.window = chunk_frames + 2 * pad_frames
        self.upsample = voice.model_cfg.upsample_factor

    def _vocode(self, seg: torch.Tensor, sid: Optional[torch.Tensor]) -> np.ndarray:
        """Flow reverse + generator of one (1, T, C) segment, all valid."""
        voice = self.voice
        with torch.inference_mode(), voice._precision():
            mask = torch.ones((1, seg.shape[1], 1), dtype=seg.dtype, device=seg.device)
            audio = M.synthesizer_vocode(voice.params, seg, mask, cfg=voice.model_cfg, sid=sid)
            return audio[0].float().cpu().numpy()

    def stream(
        self,
        z_p: torch.Tensor,
        n_frames: int,
        sid: Optional[torch.Tensor] = None,
    ) -> Iterator[np.ndarray]:
        """Yield float32 audio chunks of one utterance.

        z_p: (1, T, C) latent on the voice's device, T >= n_frames;
        n_frames: valid frame count."""
        chunk, pad, u = self.chunk_frames, self.pad_frames, self.upsample
        if n_frames <= 0:
            return
        if n_frames <= self.window:
            # too short to stream (reference: chunk() short-circuit)
            yield self._vocode(z_p[:, :n_frames], sid)[: n_frames * u]
            return
        for start in range(0, n_frames, chunk):
            end = min(start + chunk, n_frames)
            pad_l = min(pad, start)
            pad_r = min(pad, n_frames - end)
            audio = self._vocode(z_p[:, start - pad_l : end + pad_r], sid)
            yield audio[pad_l * u : (pad_l + end - start) * u]


def synthesize_stream_chunks(
    voice,
    ids,
    *,
    syn: Optional[SynthesisConfig] = None,
) -> Iterator[np.ndarray]:
    """Low-latency synthesis of one id sequence: yields float32 audio
    chunks as they are decoded. The durations and latents are the batch
    path's for the same seeded utterance (same key, same noise, same
    phoneme bucket)."""
    syn = syn or SynthesisConfig()
    key = utterance_seed(voice.resolve_seeds([syn.seed])[0], ids)
    bucket = batching.pick_bucket(len(ids), voice.phoneme_buckets)
    sid = voice._speaker(syn, 1)
    with torch.inference_mode(), voice._precision():
        enc, frames = voice._encode([ids], [key], bucket, syn, sid)
        n_frames = frames[0]
        z_p, _ = voice._latents(enc, [key], max(n_frames, 1), syn)
    yield from StreamingDecoder(voice).stream(z_p, n_frames, sid)
