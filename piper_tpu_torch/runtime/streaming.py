"""Streaming chunked synthesis (latency mode).

Counterpart of piper_tpu/runtime/streaming.py. As in the reference's
streaming chunker (src/python/piper_train/infer_onnx_streaming.py:76-108)
the latent z_p is decoded (flow reverse + vocoder, through both CUDA
kernels) in chunks of `chunk_frames` (default 45) with `pad_frames`
(default 10) of neighbouring context on each side; the decoded pad
samples (pad * upsample_factor) are trimmed, so the chunks concatenate
with small seams. The final chunk trims only what was actually padded
(the reference trims a stale pad there and drops tail samples).

As in the JAX package, every chunk is decoded at one fixed window of
chunk_frames + 2 * pad_frames frames under a length mask
(piper_tpu/runtime/streaming.py:66-90), so it runs as one CUDA graph
replay (runtime/graphs.py): the flows, the generator's plain stages in
their fixed-shape mode and both kernels, about 250 launches eagerly.
The latents of any frame count come from one call, with the batch
path's own keys and noise (utterance_seed: JAX's keys, drawn on the
device), so one branch serves every length and a seeded utterance gets
JAX's durations, and the same latents streamed and batched. That last
part is a deliberate divergence: the JAX package's short-form stream
draws normal(fold_in(key, 1), (1, T, C)) for its latents
(piper_tpu/runtime/streaming.py:139-145), other noise than its batch
path's per-frame keys, and promises equal durations only (its
:122-125); the port keeps a streamed utterance equal to the same
utterance batched.
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
    """Fixed-window chunked vocoder around a TorchVoice."""

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

    def _chunk(self, z: torch.Tensor, n: torch.Tensor, sid: Optional[torch.Tensor]):
        """Flow reverse + generator of one (1, window, C) window whose
        first n frames are valid: the function the chunk graph holds."""
        voice = self.voice
        mask = (torch.arange(self.window, device=z.device)[None, :, None] < n).to(z.dtype)
        audio = M.synthesizer_vocode(
            voice.params, z * mask, mask, cfg=voice.model_cfg, sid=sid, fixed_shape=True
        )
        return (audio,)

    def _vocode(self, z: torch.Tensor, n: int, lo: int, hi: int, sid) -> np.ndarray:
        """Samples [lo, hi) of one window (z: (1, window, C), n valid
        frames), through the voice's chunk graph."""
        voice = self.voice
        key = ("chunk", self.window, voice.dtype, sid is not None)
        with torch.inference_mode():
            (audio,) = voice.graphs.run(key, self._chunk, (z, torch.tensor([n]), sid))
            return audio[0, lo:hi].float().cpu().numpy()

    def stream(
        self,
        z_p: torch.Tensor,
        n_frames: int,
        sid: Optional[torch.Tensor] = None,
    ) -> Iterator[np.ndarray]:
        """Yield float32 audio chunks of one utterance.

        z_p: (1, T, C) latent on the voice's device, T >= n_frames;
        n_frames: valid frame count."""
        chunk, pad, u, window = self.chunk_frames, self.pad_frames, self.upsample, self.window
        if n_frames <= 0:
            return
        with torch.inference_mode():
            # every window is a view of one zero-padded copy of the latent
            z = torch.nn.functional.pad(z_p[:, :n_frames], (0, 0, 0, window))
        if n_frames <= window:
            # too short to stream (reference: chunk() short-circuit)
            yield self._vocode(z[:, :window], n_frames, 0, n_frames * u, sid)
            return
        for start in range(0, n_frames, chunk):
            end = min(start + chunk, n_frames)
            pad_l = min(pad, start)
            pad_r = min(pad, n_frames - end)
            lo = start - pad_l
            seg_len = end + pad_r - lo
            yield self._vocode(z[:, lo : lo + window], seg_len, pad_l * u, (seg_len - pad_r) * u, sid)


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
    with torch.inference_mode():
        enc, frames = voice._encode([ids], [key], bucket, syn)
        n_frames = voice._read_frames([frames])[0][0]
        z_p, _ = voice._latents(enc, [key], max(n_frames, 1), syn)
    yield from StreamingDecoder(voice).stream(z_p, n_frames, sid)
