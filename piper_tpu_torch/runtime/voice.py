"""TorchVoice: a loaded voice and its batched synthesis path.

Counterpart of piper_tpu/runtime/voice.py (TpuVoice), kept deliberately
simpler: no speculative packing, dispatch fusion, estimator cache,
mu-law wire or long-form windows. A batch of id sequences runs as

  1. rows grouped by phoneme bucket (runtime/batching.py), padded;
  2. one encode per bucket group (text encoder + duration predictor);
  3. one decode per group at the group's largest frame count: prior
     expansion, frame noise, reverse flow, time-major HiFiGAN through the
     CUDA kernels (ops/cuda/vocoder.py);
  4. conversion to int16 on the device (fast) or float32 (parity), and
     one copy of every row's valid samples to the host.

The batch is split as TpuVoice splits it: submit() enqueues the device
work and starts the copy to the host (pinned memory, non_blocking, an
event after it), collect() waits on that event and returns the
waveforms, so a server's batcher can collect on another thread while
its next batch is submitted. With `batcher` set (server/batcher.py),
synthesize_batch and synthesize_stream_raw go through it.

Threads: a server calls one voice from many threads. The generator of
unseeded requests' seeds is guarded by a lock, and parity precision's
TF32 flags (process-wide) are switched under one process-wide lock
(_fp32_exact), so neither depends on another thread's timing.

Noise: every utterance draws its own noise from (seed, crc32(ids)), as
TpuVoice._content_hashes does (voice.py:923): duration noise for its own
ids, frame noise in blocks of NOISE_BLOCK frames, each block seeded by
its index. An utterance's audio therefore depends neither on the batch
it rides in nor on the frame count it is decoded at (the two properties
of voice.py:262-331). Noise is drawn on the host with torch's CPU
generator and copied to the device, so the CPU and the card see the same
numbers.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
import zlib
from pathlib import Path
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..config import InferenceDefaults, ModelConfig, SynthesisConfig, VoiceConfig
from ..models.vits import generator as G
from ..models.vits import model as M
from ..ops.cuda import vocoder as V
from ..text.phonemes import phonemes_to_ids
from ..text.phonemize import phonemize
from ..weights.bridge import params_from_jax
from ..weights.native import load_native
from . import batching
from .wav import audio_float_to_int16, int16_to_float

NOISE_BLOCK = 64  # frames per frame-noise block


@dataclasses.dataclass
class SynthesisStats:
    """RTF accounting (reference: piper.cpp:385-408)."""

    infer_seconds: float = 0.0
    audio_seconds: float = 0.0

    @property
    def real_time_factor(self) -> float:
        return self.infer_seconds / self.audio_seconds if self.audio_seconds else 0.0


def resolve_device(device: Union[None, str, torch.device]) -> torch.device:
    """`None` means CUDA. Raises when CUDA is asked for and absent: the
    port never drifts onto the CPU unless the caller names it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' (--device cpu) "
            "to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be cuda or cpu, not {dev}")
    return dev


# The TF32 switches are process-wide. Every parity call saves, clears and
# restores them under this lock: two calls that interleaved would restore
# each other's state, switching TF32 back on under a computation still
# running or leaving it off for the process. Reentrant, so a parity call
# may nest another.
_FP32_LOCK = threading.RLock()


@contextlib.contextmanager
def _fp32_exact():
    """Parity precision: no TF32 in matmuls or cuDNN convolutions. Holds
    _FP32_LOCK for its whole extent, so parity calls run one at a time
    (a fast call running beside one sees TF32 off for that time)."""
    with _FP32_LOCK:
        saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _split_phonemes(phones: List[str], max_ids: int, id_cost) -> List[List[str]]:
    """Split a phoneme list so each chunk's id sequence fits in max_ids,
    preferring to break at spaces (piper_tpu/runtime/voice.py:73). A
    fixed 3 ids cover BOS/PAD/EOS framing."""
    budget = max_ids - 3
    costs = [id_cost(p) for p in phones]
    if sum(costs) <= budget:
        return [phones]
    chunks: List[List[str]] = []
    start = 0
    while start < len(phones):
        acc = 0
        end = start
        while end < len(phones) and acc + costs[end] <= budget:
            acc += costs[end]
            end += 1
        end = max(end, start + 1)  # always consume at least one
        if end < len(phones):
            for j in range(end - 1, start, -1):
                if phones[j] == " ":
                    end = j + 1
                    break
        chunks.append(phones[start:end])
        start = end
    return chunks


def utterance_seed(seed: int, ids: Sequence[int]) -> int:
    """The (seed, content hash) key of one utterance's noise. The seed is
    taken mod 2^32, as everywhere (solo, batcher rows, streaming)."""
    crc = zlib.crc32(np.asarray(ids, np.int32).tobytes()) & 0x7FFFFFFF
    return ((seed & 0xFFFFFFFF) << 31) | crc


def _draw(key: int, stream: int, shape) -> torch.Tensor:
    state = np.random.SeedSequence([key, stream]).generate_state(2, np.uint32)
    gen = torch.Generator().manual_seed(int(state[0]) << 32 | int(state[1]))
    return torch.randn(shape, generator=gen)


def duration_noise(key: int, n_ids: int) -> torch.Tensor:
    """(n_ids, 2) standard normal for the stochastic duration predictor."""
    return _draw(key, 0, (n_ids, 2))


def frame_noise(key: int, num_frames: int, channels: int) -> torch.Tensor:
    """(num_frames, channels) standard normal; frame f's noise depends
    only on (key, f), never on num_frames."""
    n_blocks = -(-num_frames // NOISE_BLOCK)
    blocks = [_draw(key, 1 + j, (NOISE_BLOCK, channels)) for j in range(n_blocks)]
    if not blocks:
        return torch.zeros((0, channels))
    return torch.cat(blocks)[:num_frames]


class TorchVoice:
    def __init__(
        self,
        params,
        model_cfg: ModelConfig,
        config: VoiceConfig,
        *,
        precision: str = "fast",
        device: Union[None, str, torch.device] = None,
        seed: Optional[int] = None,
    ):
        """`params`: the voice's parameter tree in the JAX package's
        layouts (numpy leaves, as weights/native.load_native returns it).

        `precision`: "parity" computes in float32 with TF32 off; "fast"
        computes in bfloat16, with the duration and spline math in
        float32 and float32 accumulation inside the kernels.
        `device`: None means CUDA (raises when there is none)."""
        if precision not in ("parity", "fast"):
            raise ValueError(f"precision: {precision!r}")
        M.check_supported(model_cfg)
        self.device = resolve_device(device)
        self.config = config
        self.model_cfg = model_cfg
        self.precision = precision
        self.dtype = torch.float32 if precision == "parity" else torch.bfloat16
        self.params = params_from_jax(params, model_cfg, self.device, self.dtype)
        self.params["dec_tm"] = G.prepare_tm(self.params["dec"], model_cfg, self.dtype)
        self.phoneme_buckets = batching.DEFAULT_PHONEME_BUCKETS
        self._rng = np.random.default_rng(seed)  # seeds of unseeded rows
        self._rng_lock = threading.Lock()
        self.batcher = None  # server/batcher.CoalescingBatcher, when serving

    # ------------------------------------------------------------------
    # Loading
    # ------------------------------------------------------------------

    @classmethod
    def load(
        cls,
        model_path: Union[str, Path],
        config_path: Optional[Union[str, Path]] = None,
        **kw,
    ) -> "TorchVoice":
        """Load a native .npz voice with its JSON config sidecar
        (`<model>.json` or `<model stem>.json` by default)."""
        model_path = Path(model_path)
        if model_path.suffix.lower() != ".npz":
            raise ValueError(
                f"unsupported voice format: {model_path} (this slice of the "
                "port loads native .npz voices; .onnx and .ckpt come later)"
            )
        if config_path is None:
            config_path = model_path.with_suffix(model_path.suffix + ".json")
            if not config_path.exists():
                config_path = model_path.with_suffix(".json")
        config = VoiceConfig.from_file(config_path)
        params, model_cfg = load_native(str(model_path))
        return cls(params, model_cfg, config, **kw)

    @classmethod
    def random(
        cls,
        quality: str = "medium",
        *,
        num_symbols: int = 256,
        num_speakers: int = 1,
        seed: int = 0,
        **kw,
    ) -> "TorchVoice":
        """Random-weight voice with text (codepoint) phonemes."""
        model_cfg = ModelConfig.for_quality(
            quality, num_symbols=num_symbols, num_speakers=num_speakers
        )
        params = M.init_synthesizer_params(seed, model_cfg)
        return cls(params, model_cfg, random_voice_config(model_cfg), seed=seed, **kw)

    # ------------------------------------------------------------------
    # Text front end
    # ------------------------------------------------------------------

    def phonemize(self, text: str) -> List[List[str]]:
        return phonemize(text, self.config)

    def phonemes_to_ids(self, phonemes: Sequence[str]) -> List[int]:
        return phonemes_to_ids(
            phonemes, self.config.phoneme_id_map,
            phoneme_map=self.config.phoneme_map or None,
        )

    # ------------------------------------------------------------------
    # Synthesis
    # ------------------------------------------------------------------

    def _precision(self):
        return _fp32_exact() if self.precision == "parity" else contextlib.nullcontext()

    def resolve_seeds(self, seeds: Sequence[Optional[int]]) -> List[int]:
        """Each row's seed mod 2^32; a None row draws one from the voice's
        generator (under its lock: request threads share it)."""
        missing = sum(s is None for s in seeds)
        drawn = iter(())
        if missing:
            with self._rng_lock:
                drawn = iter(self._rng.integers(0, 2**32, missing).tolist())
        return [next(drawn) if s is None else s & 0xFFFFFFFF for s in seeds]

    def synthesize_ids_batch(
        self,
        ids_list: Sequence[Sequence[int]],
        *,
        syn: Optional[SynthesisConfig] = None,
        stats: Optional[SynthesisStats] = None,
    ) -> List[np.ndarray]:
        """Synthesize many id sequences; returns float32 waveforms."""
        return self.collect(self.submit(ids_list, syn=syn), stats=stats)

    def submit(
        self,
        ids_list: Sequence[Sequence[int]],
        *,
        syn: Optional[SynthesisConfig] = None,
        row_seeds: Optional[Sequence[Optional[int]]] = None,
    ) -> dict:
        """Enqueue a batch's device work and the copy of its samples to
        the host; returns a handle for collect(). The only wait is for the
        frame counts (one small copy per phoneme bucket).

        `row_seeds` gives each row its own seed (a None row draws one),
        overriding syn.seed: the batcher coalesces differently seeded
        requests with it, and a row's audio equals a solo seeded submit's.
        """
        syn = syn or SynthesisConfig()
        t0 = time.perf_counter()
        if row_seeds is None:
            row_seeds = [syn.seed] * len(ids_list)
        seeds = self.resolve_seeds(row_seeds)
        keys = [utterance_seed(s, ids) for s, ids in zip(seeds, ids_list)]
        event = None
        with torch.inference_mode(), self._precision():
            flat, rows = self._synthesize(ids_list, keys, syn)
            if self.device.type == "cuda":
                # into pinned memory without waiting; collect() waits on
                # the event, from whichever thread it runs on
                host = torch.empty(flat.shape, dtype=flat.dtype, pin_memory=True)
                host.copy_(flat, non_blocking=True)
                event = torch.cuda.Event()
                event.record(torch.cuda.current_stream(self.device))
            else:
                host = flat
        return {"host": host, "event": event, "rows": rows, "n": len(ids_list), "t0": t0}

    def collect(
        self, handle: dict, *, stats: Optional[SynthesisStats] = None
    ) -> List[np.ndarray]:
        """Wait for a submit()ted batch; returns float32 waveforms."""
        if handle["event"] is not None:
            handle["event"].synchronize()
        host = handle["host"].numpy()
        if host.dtype == np.int16:
            host = int16_to_float(host)
        results = [np.zeros(0, np.float32)] * handle["n"]
        for idx, start, n in handle["rows"]:
            results[idx] = host[start : start + n]
        if stats is not None:
            stats.infer_seconds += time.perf_counter() - handle["t0"]
            stats.audio_seconds += sum(n for _, _, n in handle["rows"]) / self.config.sample_rate
        return results

    def _scales(self, syn: SynthesisConfig) -> Tuple[float, float, float]:
        """(noise_scale, length_scale, noise_w): the request's, else the voice's."""
        inf = self.config.inference
        return (
            syn.noise_scale if syn.noise_scale is not None else inf.noise_scale,
            syn.length_scale if syn.length_scale is not None else inf.length_scale,
            syn.noise_w if syn.noise_w is not None else inf.noise_w,
        )

    def _speaker(self, syn: SynthesisConfig, b: int) -> Optional[torch.Tensor]:
        if self.model_cfg.num_speakers <= 1:
            return None
        spk = syn.speaker_id if syn.speaker_id is not None else 0
        return torch.full((b,), spk, dtype=torch.long, device=self.device)

    def _encode(self, rows_ids, keys, bucket: int, syn: SynthesisConfig, sid):
        """Encode rows padded to `bucket`, each with its own duration
        noise; returns the EncodeResult and the rows' frame counts (the
        one wait of the path)."""
        b = len(rows_ids)
        ids_arr = np.zeros((b, bucket), np.int64)
        dur_noise = torch.zeros((b, bucket, 2))
        for row, (ids, key) in enumerate(zip(rows_ids, keys)):
            ids_arr[row, : len(ids)] = ids
            dur_noise[row, : len(ids)] = duration_noise(key, len(ids))
        _, length_scale, noise_w = self._scales(syn)
        dev = self.device
        enc = M.synthesizer_encode(
            self.params, torch.from_numpy(ids_arr).to(dev),
            torch.tensor([len(ids) for ids in rows_ids], device=dev), cfg=self.model_cfg,
            noise_w_scale=noise_w, length_scale=length_scale,
            dur_noise=dur_noise.to(dev), sid=sid, dtype=self.dtype,
        )
        return enc, enc.durations.sum(dim=-1).cpu().tolist()

    def _latents(self, enc, keys, num_frames: int, syn: SynthesisConfig):
        """z_p and y_mask at num_frames, each row's frame noise from its key."""
        fnoise = torch.stack([
            frame_noise(key, num_frames, self.model_cfg.inter_channels) for key in keys
        ])
        return M.synthesizer_latents(
            self.params, enc, num_frames, cfg=self.model_cfg,
            noise_scale=self._scales(syn)[0], frame_noise=fnoise.to(self.device),
        )

    def _synthesize(
        self, ids_list, keys, syn: SynthesisConfig
    ) -> Tuple[torch.Tensor, List[Tuple[int, int, int]]]:
        """Device part of submit: returns one flat tensor of every row's
        valid samples and (index, start, n) per row."""
        u = self.model_cfg.upsample_factor
        pieces: List[torch.Tensor] = []
        rows: List[Tuple[int, int, int]] = []
        pos = 0
        for bucket, indices in batching.group_by_bucket(
            [len(ids) for ids in ids_list], self.phoneme_buckets
        ):
            rkeys = [keys[i] for i in indices]
            sid = self._speaker(syn, len(indices))
            enc, frames = self._encode([ids_list[i] for i in indices], rkeys, bucket, syn, sid)
            z_p, y_mask = self._latents(enc, rkeys, max(max(frames), 1), syn)
            audio = M.synthesizer_vocode(
                self.params, z_p, y_mask, cfg=self.model_cfg, sid=sid, frames=frames
            )
            if self.precision == "fast":
                # device-side int16 (voice.py:379-387): tanh output is in [-1, 1]
                audio = torch.round(audio.float().clamp(-1.0, 1.0) * 32767.0).to(torch.int16)
            else:
                audio = audio.float()
            for row, idx in enumerate(indices):
                n = frames[row] * u
                pieces.append(audio[row, :n])
                rows.append((idx, pos, n))
                pos += n
        if not pieces:
            return torch.zeros(0, device=self.device), rows
        return torch.cat(pieces), rows

    def synthesize_batch(
        self,
        texts: Sequence[str],
        *,
        syn: Optional[SynthesisConfig] = None,
        stats: Optional[SynthesisStats] = None,
    ) -> List[List[np.ndarray]]:
        """Per text, its sentences as int16 PCM (reference: voice.py:114-138),
        with phrase splitting on silence phonemes (piper.cpp:508-537).
        Every phrase of every text is synthesised in one batch (through
        the batcher, when one is set)."""
        syn = syn or SynthesisConfig()
        sentences = [self.phonemize(text) for text in texts]
        phrase_ids: List[List[int]] = []
        phrase_meta: List[Tuple[int, int, int]] = []  # (text, sentence, silence)
        for t_idx, sents in enumerate(sentences):
            for s_idx, phonemes in enumerate(sents):
                for ids, sil in self._phrases(phonemes, syn):
                    phrase_ids.append(ids)
                    phrase_meta.append((t_idx, s_idx, sil))
        batch_fn = (
            self.batcher.synthesize_ids_batch
            if self.batcher is not None
            else self.synthesize_ids_batch
        )
        audios = batch_fn(phrase_ids, syn=syn, stats=stats)
        sentence_silence = int(syn.sentence_silence_seconds * self.config.sample_rate)
        parts: dict = {}
        for (t_idx, s_idx, sil), audio in zip(phrase_meta, audios):
            parts.setdefault((t_idx, s_idx), []).append(audio)
            if sil:
                parts[(t_idx, s_idx)].append(np.zeros(sil, np.float32))
        out: List[List[np.ndarray]] = []
        for t_idx, sents in enumerate(sentences):
            pcms = []
            for s_idx in range(len(sents)):
                if (t_idx, s_idx) not in parts:
                    continue
                pcm = audio_float_to_int16(np.concatenate(parts[(t_idx, s_idx)]) * syn.volume)
                if sentence_silence:
                    pcm = np.concatenate([pcm, np.zeros(sentence_silence, np.int16)])
                pcms.append(pcm)
            out.append(pcms)
        return out

    def synthesize_stream_raw(
        self,
        text: str,
        *,
        syn: Optional[SynthesisConfig] = None,
        stats: Optional[SynthesisStats] = None,
    ):
        """Per-sentence int16 PCM chunks of one text, its phrases in one batch."""
        for pcm in self.synthesize_batch([text], syn=syn, stats=stats)[0]:
            yield pcm.tobytes()

    def _phrases(self, phonemes: Sequence[str], syn: SynthesisConfig):
        """(ids, silence samples after it) per phrase of one sentence
        (piper_tpu/runtime/voice.py:1662-1745)."""
        sr = self.config.sample_rate
        phoneme_silence = (
            syn.phoneme_silence_seconds
            if syn.phoneme_silence_seconds is not None
            else self.config.phoneme_silence_seconds
        )
        id_map = self.config.phoneme_id_map
        ph_map = self.config.phoneme_map or {}
        pad_len = len(id_map.get("_", [0]))

        def id_cost(p: str) -> int:
            return sum(len(id_map[q]) + pad_len for q in ph_map.get(p, [p]) if q in id_map)

        phrases: List[Tuple[List[str], int]] = []
        if phoneme_silence:
            current: List[str] = []
            for ph in phonemes:
                current.append(ph)
                if ph in phoneme_silence:
                    phrases.append((current, int(phoneme_silence[ph] * sr)))
                    current = []
            if current:
                phrases.append((current, 0))
        else:
            phrases = [(list(phonemes), 0)]
        out: List[Tuple[List[int], int]] = []
        for phones, sil in phrases:
            if not phones:
                continue
            chunks = _split_phonemes(phones, max(self.phoneme_buckets), id_cost)
            for i, chunk in enumerate(chunks):
                out.append((self.phonemes_to_ids(chunk), sil if i == len(chunks) - 1 else 0))
        return out

    def synthesize(
        self,
        text: str,
        *,
        syn: Optional[SynthesisConfig] = None,
        stats: Optional[SynthesisStats] = None,
    ) -> np.ndarray:
        """Text -> int16 waveform."""
        chunks = list(self.synthesize_stream_raw(text, syn=syn, stats=stats))
        if not chunks:
            return np.zeros(0, np.int16)
        return np.frombuffer(b"".join(chunks), dtype=np.int16)

    def synthesize_wav(
        self, text: str, wav_file, *, syn: Optional[SynthesisConfig] = None,
        stats: Optional[SynthesisStats] = None,
    ) -> None:
        """Write synthesized audio into an open wave.Wave_write
        (reference: voice.py:89-112)."""
        wav_file.setframerate(self.config.sample_rate)
        wav_file.setsampwidth(2)
        wav_file.setnchannels(1)
        for chunk in self.synthesize_stream_raw(text, syn=syn, stats=stats):
            wav_file.writeframes(chunk)

    # ------------------------------------------------------------------
    # Warm-up
    # ------------------------------------------------------------------

    def warmup(self, batch_sizes: Sequence[int] = (1,), *, full: bool = False) -> None:
        """Build the kernels (on CUDA) and run one encode per phoneme
        bucket at each batch size. With `full`, also one whole batch
        (encode, decode, copy to the host) per power-of-two row count up
        to the largest batch size, at this voice's device and dtype: the
        allocator's blocks, cuDNN's and cuBLAS's first calls and both
        kernels' first launches, so no request pays for them."""
        if self.device.type == "cuda":
            V.build()
        syn = SynthesisConfig(seed=0)
        tok = min(3, self.model_cfg.num_symbols - 1)
        with torch.inference_mode(), self._precision():
            for b in sorted(set(batch_sizes)):
                for pb in self.phoneme_buckets:
                    rows = [[tok] * pb] * b
                    self._encode(rows, [utterance_seed(0, r) for r in rows], pb, syn,
                                 self._speaker(syn, b))
        if not full:
            return
        b_max, rows = max(batch_sizes), 1
        while True:
            self.collect(self.submit([[1, 0] + [tok, 0] * 30 + [2]] * rows, syn=syn))
            if rows >= b_max:
                break
            rows = min(2 * rows, b_max)


def random_voice_config(model_cfg: ModelConfig) -> VoiceConfig:
    """Voice config of a random-weight voice: codepoint phonemes
    (phoneme_type "text"), so no espeak is needed."""
    n = model_cfg.num_symbols
    id_map = {chr(32 + i): [i] for i in range(n)}
    id_map.update({"_": [0], "^": [1], "$": [2]})
    return VoiceConfig.from_dict({
        "num_symbols": n,
        "num_speakers": model_cfg.num_speakers,
        "audio": {
            "sample_rate": model_cfg.audio.sample_rate,
            "quality": model_cfg.audio.quality,
        },
        "espeak": {"voice": "en-us"},
        "inference": dataclasses.asdict(InferenceDefaults()),
        "phoneme_type": "text",
        "phoneme_id_map": id_map,
    })
