"""TorchVoice: a loaded voice and its batched synthesis path.

Counterpart of piper_tpu/runtime/voice.py (TpuVoice), kept deliberately
simpler: no speculative packing, dispatch fusion, estimator cache,
mu-law wire or long-form windows. A batch of id sequences runs as

  1. Phase A: rows grouped by phoneme bucket (runtime/batching.py) and
     one encode per bucket (text encoder + duration predictor), each one
     CUDA graph replay at (phoneme bucket, ENCODE_ROWS rows), the ids
     uploaded in the narrowest integer type that holds num_symbols;
  2. Phase B: every bucket's frame counts read to the host in one copy
     (piper_tpu/runtime/voice.py:1046-1101);
  3. each bucket's rows planned into decodes by `decode_grouping`
     (batching.plan_decode_groups: bucketed, uniform or packed), each
     decode at its frame bucket: prior expansion eagerly, then each
     row's frame noise, latents and reverse flow at the frame bucket it
     decodes at alone, as graph replays of flow_graph_rows(bucket) rows,
     the vocoder eagerly at the decode's longest row, since its row
     stages take each row's length on the host: the time-major
     HiFiGAN through the CUDA kernels (ops/cuda/vocoder.py), or the
     MB-iSTFT generator (models/vits/istft_generator.py), every stage
     row by row;
  4. conversion to int16 on the device (fast) or float32 (parity), and
     one copy of every row's valid samples to the host.

The batch is split as TpuVoice splits it: submit() enqueues the device
work and starts the copy to the host (pinned memory, non_blocking, an
event after it), collect() waits on that event and returns the
waveforms, so a server's batcher can collect on another thread while
its next batch is submitted. With `batcher` set (server/batcher.py),
synthesize_batch and synthesize_stream_raw go through it. With `timer`
set (runtime/profiling.StageTimer), submit() times its phases.

Threads: a server calls one voice from many threads. The generator of
unseeded requests' seeds is guarded by a lock, and the graphs by theirs
(runtime/graphs.py). TF32 is switched off once, when a voice is built
(tf32_off): fast precision computes its float32 parts without it at no
cost (PERF.md), so both precisions run under the same process-wide
flags and no call switches them.

Noise: every utterance draws JAX's own random streams (ops/prng.py)
from JAX's key, fold_in(PRNGKey(seed), crc32(ids)) (TpuVoice._utt_keys,
voice.py:923-945): duration noise normal(fold_in(key, 0), (T_x, 2))
(voice.py:274-277), and frame i's noise normal(fold_in(fold_in(key, 1),
i), (C,)) (row_noise, voice.py:314-324). So a seeded utterance gets the
JAX package's noise, and its audio depends neither on the batch it
rides in nor on the frame count it is decoded at (the two properties of
voice.py:262-331). The host computes each row's key (one threefry) and
uploads the keys with the ids; the noise is drawn on the device, inside
the encode graph and the flow graphs. A row's bits are its solo bits in
either precision: the encodes run at one row count (ENCODE_ROWS), the
flow at the row's own frame bucket at one row count per bucket
(flow_graph_rows), and conv_pre and the generator's plain stages (all
of MB-iSTFT's) run row by row (PERF.md).
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
from ..models.vits import istft_generator as MB
from ..models.vits import model as M
from ..ops import prng
from ..ops.cuda import vocoder as V
from ..text.phonemes import phonemes_to_ids
from ..text.phonemize import phonemize
from ..weights.bridge import params_from_jax
from ..weights.native import load_native
from ..weights.onnx_loader import load_onnx_voice
from ..weights.torch_loader import load_torch_checkpoint
from . import batching
from .graphs import GraphCache
from .wav import audio_float_to_int16, int16_to_float

# Rows of every encode: a phoneme bucket's rows run in slices of this
# many, padded with copies of the slice's first row, so a row's bits
# never depend on how many rows share its bucket (cuBLAS and cuDNN pick
# their algorithms by shape; PERF.md). One encode graph per bucket.
ENCODE_ROWS = 16
# Rows and frames of the flow graphs, for the same reason: a row's
# reverse flow runs at its own frame bucket, in graphs of one row count
# per bucket (flow_graph_rows), padded with copies of their first row.
# Over a decode's rows at the decode's bucket a trained voice's float32
# row and a perturbed flow's bf16 row moved (PERF.md).
FLOW_MAX_ROWS = 16
FLOW_FRAMES = 8192  # rows x frame bucket of a bf16 flow graph


def flow_graph_rows(bucket: int, dtype: torch.dtype) -> int:
    """Rows of the flow graph at frame bucket `bucket`: the largest power
    of two up to FLOW_MAX_ROWS whose rows times `bucket` stay within
    FLOW_FRAMES in bf16, half that in float32 (at least 1). Measured on
    the card by tools/flow_rows.py: such a graph costs at most about
    twice one row's, and each row of it at least half as much as alone,
    where a float32 row costs about twice a bf16 row (PERF.md)."""
    frames = FLOW_FRAMES * 2 // dtype.itemsize
    n = 1
    while 2 * n <= FLOW_MAX_ROWS and 2 * n * bucket <= frames:
        n *= 2
    return n


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


def tf32_off() -> None:
    """Compute float32 matmuls and cuDNN convolutions without TF32, for
    the whole process. Parity precision needs it; fast precision loses
    nothing by it (its float32 parts are the duration predictor and the
    splines; PERF.md). The CUDA graphs bake the setting in at capture,
    so it is set before any capture and never switched back."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


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
    """JAX's key of one utterance's noise, fold_in(PRNGKey(seed),
    crc32(ids) & 0x7FFFFFFF) (TpuVoice._utt_keys, voice.py:935-945),
    packed into one int: the key's first word above its second. The seed
    is taken mod 2^32, as everywhere (solo, batcher rows, streaming)."""
    crc = zlib.crc32(np.asarray(ids, np.int32).tobytes()) & 0x7FFFFFFF
    # fold_in of PRNGKey(seed) = (0, seed mod 2^32), in Python ints
    k0, k1 = prng.threefry2x32(0, seed & prng.MASK, 0, crc)
    return k0 << 32 | k1


def key_table(keys: Sequence[int]) -> torch.Tensor:
    """(rows, 2) int64 words of packed keys (utterance_seed's), on the host."""
    return torch.tensor([[k >> 32, k & prng.MASK] for k in keys], dtype=torch.int64).reshape(-1, 2)


def duration_noise_rows(keys: torch.Tensor, n_ids: int) -> torch.Tensor:
    """(rows, n_ids, 2) duration noise of a (rows, 2) key table:
    normal(fold_in(key, 0), (n_ids, 2)) per row (voice.py:274-277). Id i's
    noise does not depend on n_ids (the phoneme bucket)."""
    return prng.normal(prng.fold_in(keys, 0), (n_ids, 2))


def frame_noise_rows(keys: torch.Tensor, num_frames: int, channels: int) -> torch.Tensor:
    """(rows, num_frames, channels) frame noise of a (rows, 2) key table:
    frame i's is normal(fold_in(fold_in(key, 1), i), (channels,))
    (voice.py:314-324), so it depends only on (key, i)."""
    frames = torch.arange(num_frames, device=keys.device)
    return prng.normal(prng.fold_in(prng.fold_in(keys, 1)[:, None, :], frames), (channels,))


def duration_noise(key: int, n_ids: int) -> torch.Tensor:
    """(n_ids, 2) standard normal for the stochastic duration predictor."""
    return duration_noise_rows(key_table([key]), n_ids)[0]


def frame_noise(key: int, num_frames: int, channels: int) -> torch.Tensor:
    """(num_frames, channels) standard normal; frame f's noise depends
    only on (key, f), never on num_frames."""
    return frame_noise_rows(key_table([key]), num_frames, channels)[0]


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
        decode_grouping: str = "bucketed",
    ):
        """`params`: the voice's parameter tree in the JAX package's
        layouts (numpy leaves, as weights/native.load_native returns it).

        `precision`: "parity" computes in float32 with TF32 off; "fast"
        computes in bfloat16, with the duration and spline math in
        float32 and float32 accumulation inside the kernels.
        `device`: None means CUDA (raises when there is none).

        `decode_grouping` (TpuVoice's, piper_tpu/runtime/voice.py:150-167):
          "bucketed" (default): each phoneme bucket's rows decode in one
              group per frame bucket;
          "uniform": each phoneme bucket's rows decode in one group at
              the frame bucket of its longest row (the HTTP server's
              default: fewer decodes per batch);
          "packed": batching.plan_packed_groups' partition of the
              length-sorted rows.
        Every grouping plans the rows of one encode group, so a batch
        runs at least one decode per phoneme bucket. A row's audio is
        the same under any of them."""
        if precision not in ("parity", "fast"):
            raise ValueError(f"precision: {precision!r}")
        if decode_grouping not in batching.DECODE_GROUPINGS:
            raise ValueError(f"decode_grouping: {decode_grouping!r}")
        self.device = resolve_device(device)
        tf32_off()
        self.config = config
        self.model_cfg = model_cfg
        self.precision = precision
        self.dtype = torch.float32 if precision == "parity" else torch.bfloat16
        self.params = params_from_jax(params, model_cfg, self.device, self.dtype)
        # the vocoder's derived tables: HiFiGAN's time-major weights for
        # the kernels, MB-iSTFT's iSTFT and PQMF constants (TpuVoice
        # builds dec_tm only for HiFiGAN, voice.py:203-212)
        if model_cfg.vocoder == "mb_istft":
            self.params["dec_mb"] = MB.prepare_mb(model_cfg, self.device)
        else:
            self.params["dec_tm"] = G.prepare_tm(self.params["dec"], model_cfg, self.dtype)
        self.phoneme_buckets = batching.DEFAULT_PHONEME_BUCKETS
        self.frame_buckets = batching.DEFAULT_FRAME_BUCKETS
        self.decode_grouping = decode_grouping
        # Narrowest host->device type of the phoneme ids (TpuVoice's
        # _ids_wire_dtype, voice.py:243): embedding indices are
        # non-negative, so 8 unsigned bits cover a 256-symbol table.
        ns = model_cfg.num_symbols
        self._ids_wire_dtype = (
            torch.uint8 if ns <= 256 else torch.int16 if ns < 32768 else torch.int32
        )
        self.graphs = GraphCache(self.device)
        self._rng = np.random.default_rng(seed)  # seeds of unseeded rows
        self._rng_lock = threading.Lock()
        self.batcher = None  # server/batcher.CoalescingBatcher, when serving
        self.timer = None  # runtime/profiling.StageTimer: spans of submit()

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
        """Load a voice from a .ckpt (piper_train Lightning checkpoint),
        .onnx (exported piper voice) or .npz (native) file with its JSON
        config sidecar: `<model><suffix>.json`, else `<model stem>.json`
        (TpuVoice.load's rules, piper_tpu/runtime/voice.py:817-852;
        reference: voice.py:24-55). A .ckpt's architecture comes from its
        hyper_parameters, an .onnx's from its tensors over the sidecar's
        preset, an .npz's from the config it embeds."""
        model_path = Path(model_path)
        suffix = model_path.suffix.lower()
        if suffix not in (".ckpt", ".onnx", ".npz"):
            raise ValueError(f"unsupported voice format: {model_path} (.ckpt, .onnx or .npz)")
        if config_path is None:
            config_path = model_path.with_suffix(model_path.suffix + ".json")
            if not config_path.exists():
                config_path = model_path.with_suffix(".json")
        config = VoiceConfig.from_file(config_path)
        if suffix == ".ckpt":
            params, model_cfg = load_torch_checkpoint(str(model_path))
        elif suffix == ".onnx":
            params, model_cfg = load_onnx_voice(str(model_path), config.model_config())
        else:
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
        vocoder: str = "hifigan",
        variant: str = "vits",
        **kw,
    ) -> "TorchVoice":
        """Random-weight voice with text (codepoint) phonemes: `variant`
        "vits" or "vits2", `vocoder` "hifigan" or "mb_istft"
        (TpuVoice.random, piper_tpu/runtime/voice.py:856-895). Note that
        a VITS2 flow's zero-initialised `post` makes its attention change
        nothing until the weights are trained or perturbed."""
        kw_cfg = dict(num_symbols=num_symbols, num_speakers=num_speakers)
        if vocoder == "mb_istft":
            if variant != "vits":
                raise ValueError(
                    "vocoder='mb_istft' with variant='vits2' is not a "
                    "supported combination yet; pick one"
                )
            model_cfg = ModelConfig.mb_istft(quality, **kw_cfg)
        elif variant == "vits2":
            model_cfg = ModelConfig.vits2(quality, **kw_cfg)
        else:
            model_cfg = ModelConfig.for_quality(quality, **kw_cfg)
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

    def _span(self, name: str):
        return self.timer.span(name) if self.timer is not None else contextlib.nullcontext()

    def _plan_decode_groups(self, frame_counts: Sequence[int]) -> List[Tuple[int, List[int]]]:
        """[(frame_bucket, row_positions)] for one encode group's rows
        (decode_grouping). A row past the frame-bucket ladder decodes
        alone at its own frame count: the port decodes any frame count
        in one call, where TpuVoice decodes such a row in windows."""
        top = self.frame_buckets[-1]
        fit = [j for j, f in enumerate(frame_counts) if f <= top]
        plan = [
            (fb, [fit[j] for j in rows])
            for fb, rows in batching.plan_decode_groups(
                [frame_counts[j] for j in fit], self.decode_grouping,
                self.frame_buckets,
            )
        ] if fit else []
        return plan + [(int(f), [j]) for j, f in enumerate(frame_counts) if f > top]

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
        frame counts: one copy for the whole batch (Phase B).

        `row_seeds` gives each row its own seed (a None row draws one),
        overriding syn.seed: the batcher coalesces differently seeded
        requests with it, and a row's audio equals a solo seeded submit's.
        """
        with self._span("submit"):
            return self._submit(ids_list, syn or SynthesisConfig(), row_seeds)

    def _submit(self, ids_list, syn: SynthesisConfig, row_seeds) -> dict:
        t0 = time.perf_counter()
        if row_seeds is None:
            row_seeds = [syn.seed] * len(ids_list)
        seeds = self.resolve_seeds(row_seeds)
        keys = [utterance_seed(s, ids) for s, ids in zip(seeds, ids_list)]
        event = None
        with torch.inference_mode():
            flat, rows, decodes = self._synthesize(ids_list, keys, syn)
            with self._span("copy"):
                if self.device.type == "cuda":
                    # into pinned memory without waiting; collect() waits on
                    # the event, from whichever thread it runs on
                    host = torch.empty(flat.shape, dtype=flat.dtype, pin_memory=True)
                    host.copy_(flat, non_blocking=True)
                    event = torch.cuda.Event()
                    event.record(torch.cuda.current_stream(self.device))
                else:
                    host = flat
        return {"host": host, "event": event, "rows": rows, "n": len(ids_list), "t0": t0,
                "decodes": decodes}

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

    def speaker_id(self, syn: SynthesisConfig) -> Optional[int]:
        """The request's speaker (0 when it names none), None for a
        single-speaker voice. Checked on the host: on the card an
        embedding row out of range is a device-side assert that ends
        the process's CUDA context, where JAX's gather clamps."""
        n = self.model_cfg.num_speakers
        if n <= 1:
            return None
        spk = syn.speaker_id if syn.speaker_id is not None else 0
        if not 0 <= spk < n:
            raise ValueError(f"speaker_id {spk} out of range: this voice has {n} speakers")
        return spk

    def _speaker(self, syn: SynthesisConfig, b: int) -> Optional[torch.Tensor]:
        spk = self.speaker_id(syn)
        if spk is None:
            return None
        return torch.full((b,), spk, dtype=torch.long, device=self.device)

    def _host_zeros(self, shape, dtype=torch.float32) -> torch.Tensor:
        """A zeroed host tensor to fill and copy to the device without
        waiting: on CUDA in pinned memory (the caching host allocator
        keeps the block until the copy has run)."""
        return torch.zeros(shape, dtype=dtype, pin_memory=self.device.type == "cuda")

    def _encode_step(self, ids, lengths, keys, scales, sid):
        """The encode graph's function: each row's duration noise from its
        key, then text encoder + duration predictor over ENCODE_ROWS
        padded rows, and each row's frame count."""
        enc = M.synthesizer_encode(
            self.params, ids, lengths, cfg=self.model_cfg, noise_w_scale=scales[0],
            length_scale=scales[1], dur_noise=duration_noise_rows(keys, ids.shape[1]),
            sid=sid, dtype=self.dtype,
        )
        return (*enc, enc.durations.sum(dim=-1))

    def _latents_step(self, m_p, logs_p, y_mask, keys, noise_scale):
        """The latents graph's function: each row's frame noise from its
        key, and z_p (models.py:717-718)."""
        noise = frame_noise_rows(keys, m_p.shape[1], m_p.shape[2])
        return (M.sample_latents(m_p, logs_p, y_mask, noise, noise_scale),)

    def _flow_step(self, m_p, logs_p, y_mask, keys, noise_scale, sid):
        """The flow graph's function: the latents, then the reverse flow,
        over a graph's rows at their frame bucket (the generator after it
        runs eagerly: its row stages take host lengths)."""
        (z_p,) = self._latents_step(m_p, logs_p, y_mask, keys, noise_scale)
        g = M.speaker_embedding(self.params, self.model_cfg, sid)
        return (M.synthesizer_flow(self.params, z_p, y_mask, cfg=self.model_cfg, g=g),)

    def _graph(self, kind: str, fn, inputs, sid=None):
        """fn over rows at one frame bucket: a graph replay at (kind,
        frame bucket, rows) on the frame-bucket ladder, eager past it (a
        row decoded alone at its own frame count)."""
        m_p = inputs[0]
        if m_p.shape[1] > self.frame_buckets[-1]:
            return fn(*(None if x is None else x.to(self.device, non_blocking=True)
                        for x in inputs))[0]
        key = (kind, m_p.shape[1], m_p.shape[0], self.dtype, sid is not None)
        return self.graphs.run(key, fn, inputs)[0]

    def _flow(self, m_p, logs_p, y_mask, keys, noise_scale, sid) -> torch.Tensor:
        """Latents and reverse flow of rows at one frame bucket."""
        return self._graph("flow", self._flow_step, (m_p, logs_p, y_mask, keys, noise_scale, sid),
                           sid)

    def _flow_rows(self, m_p, logs_p, y_mask, keys, noise_scale, sid,
                   frames: Sequence[int]) -> torch.Tensor:
        """A decode's latents and reverse flow (keys: the rows' (rows, 2)
        key table, noise_scale a (1,) tensor, both on the device): each
        row at the frame bucket it decodes at alone (alone at its own
        frame count past the ladder), the rows of one bucket in graphs of
        flow_graph_rows(bucket) rows, each padded with copies of its
        first row, so a row's flow has one shape alone and in any batch.
        Over a decode's rows at the decode's bucket, cuBLAS and cuDNN
        pick their algorithms by the rows and the bucket: a trained
        voice's float32 row moved against the same row alone, and a bf16
        row of a flow with `post` perturbed (PERF.md)."""
        z = torch.zeros_like(m_p)
        top = self.frame_buckets[-1]
        by_bucket: dict = {}
        for row, f in enumerate(frames):
            fb = batching.pick_bucket(f, self.frame_buckets) if f <= top else f
            by_bucket.setdefault(fb, []).append(row)
        for fb, rows in by_bucket.items():
            n = flow_graph_rows(fb, self.dtype) if fb <= top else 1
            for lo in range(0, len(rows), n):
                part = rows[lo : lo + n]
                sel = part + part[:1] * (n - len(part))
                out = self._flow(
                    *(torch.cat([x[r : r + 1, :fb] for r in sel]) for x in (m_p, logs_p, y_mask)),
                    torch.cat([keys[r : r + 1] for r in sel]),
                    noise_scale,
                    None if sid is None else sid[:1].repeat(n),
                )
                for k, r in enumerate(part):
                    z[r, :fb] = out[k]
        return z

    def _encode(self, rows_ids, keys, bucket: int, syn: SynthesisConfig):
        """Encode rows padded to `bucket`, each with its own duration
        noise, as graph replays at (bucket, ENCODE_ROWS): the rows in
        slices of ENCODE_ROWS, each padded with copies of its first row,
        the pad rows dropped. Returns the EncodeResult of the real rows
        and their frame counts, on the device (read them with
        _read_frames)."""
        _, length_scale, noise_w = self._scales(syn)
        outs = []
        for lo in range(0, len(rows_ids), ENCODE_ROWS):
            part = list(range(lo, min(lo + ENCODE_ROWS, len(rows_ids))))
            order = part + part[:1] * (ENCODE_ROWS - len(part))
            with self._span("upload"):
                ids_arr = self._host_zeros((ENCODE_ROWS, bucket), self._ids_wire_dtype)
                lengths = self._host_zeros((ENCODE_ROWS,), torch.int32)
                key_arr = self._host_zeros((ENCODE_ROWS, 2), torch.int64)
                key_arr[:] = key_table([keys[j] for j in order])
                for row, j in enumerate(order):
                    n = len(rows_ids[j])
                    ids_arr[row, :n] = torch.as_tensor(rows_ids[j], dtype=self._ids_wire_dtype)
                    lengths[row] = n
                scales = self._host_zeros((2,))
                scales[0], scales[1] = noise_w, length_scale
                sid = None
                spk = self.speaker_id(syn)
                if spk is not None:
                    sid = self._host_zeros((ENCODE_ROWS,), torch.long)
                    sid[:] = spk
            with self._span("encode"):
                key = ("encode", bucket, ENCODE_ROWS, self.dtype, sid is not None)
                inputs = (ids_arr, lengths, key_arr, scales, sid)
                outs.append([t[: len(part)] for t in self.graphs.run(key, self._encode_step, inputs)])
        if len(outs) > 1:
            outs = [[torch.cat(ts) for ts in zip(*outs)]]
        *enc, frames = outs[0]
        return M.EncodeResult(*enc), frames

    def _read_frames(self, frames: Sequence[torch.Tensor]) -> List[List[int]]:
        """Every encode group's frame counts to the host in one copy (the
        one wait of submit)."""
        if not frames:
            return []
        with self._span("frames_wait"):
            flat = torch.cat(list(frames)).cpu().tolist()
        out, pos = [], 0
        for f in frames:
            out.append(flat[pos : pos + f.shape[0]])
            pos += f.shape[0]
        return out

    def _noise_inputs(self, keys: Sequence[int], syn: SynthesisConfig):
        """The (rows, 2) key table and the (1,) noise scale, on their way
        to the device (pinned on CUDA, copied without waiting)."""
        with self._span("upload"):
            table = self._host_zeros((len(keys), 2), torch.int64)
            table[:] = key_table(keys)
            scale = self._host_zeros((1,))
            scale[0] = self._scales(syn)[0]
            return (table.to(self.device, non_blocking=True),
                    scale.to(self.device, non_blocking=True))

    def _latents(self, enc, keys, num_frames: int, syn: SynthesisConfig):
        """z_p and y_mask of the rows of `enc` at num_frames (the stream's
        latents), each row's frame noise from its key: a latents graph at
        the frame bucket, the batch path's noise and arithmetic."""
        top = self.frame_buckets[-1]
        fb = batching.pick_bucket(num_frames, self.frame_buckets) if num_frames <= top else num_frames
        with self._span("decode"):
            m_p, logs_p, y_mask = M.expand_prior(enc, fb)
            z_p = self._graph("latents", self._latents_step,
                              (m_p, logs_p, y_mask, *self._noise_inputs(keys, syn)))
        return z_p[:, :num_frames], y_mask[:, :num_frames]

    def _synthesize(
        self, ids_list, keys, syn: SynthesisConfig
    ) -> Tuple[torch.Tensor, List[Tuple[int, int, int]], int]:
        """Device part of submit: returns one flat tensor of every row's
        valid samples, (index, start, n) per row, and the decodes run."""
        u = self.model_cfg.upsample_factor
        # Phase A: every phoneme bucket's encode, no wait
        groups = []
        for bucket, indices in batching.group_by_bucket(
            [len(ids) for ids in ids_list], self.phoneme_buckets
        ):
            rkeys = [keys[i] for i in indices]
            enc, frames = self._encode([ids_list[i] for i in indices], rkeys, bucket, syn)
            groups.append((indices, rkeys, enc, frames))
        # Phase B: all frame counts in one copy
        counts = self._read_frames([g[3] for g in groups])
        pieces: List[torch.Tensor] = []
        rows: List[Tuple[int, int, int]] = []
        pos = decodes = 0
        for (indices, rkeys, enc, _), frames in zip(groups, counts):
            for fbucket, members in self._plan_decode_groups(frames):
                n = len(members)
                if members != list(range(len(indices))):
                    sel = torch.tensor(members, pin_memory=self.device.type == "cuda")
                    sel = sel.to(self.device, non_blocking=True)
                    genc = M.EncodeResult(*(t.index_select(0, sel) for t in enc))
                else:
                    genc = enc
                gframes = [frames[j] for j in members]
                noise_in = self._noise_inputs([rkeys[j] for j in members], syn)
                with self._span("decode"):
                    m_p, logs_p, y_mask = M.expand_prior(genc, fbucket)
                    sid = self._speaker(syn, n)
                    z = self._flow_rows(m_p, logs_p, y_mask, *noise_in, sid, gframes)
                    g = M.speaker_embedding(self.params, self.model_cfg, sid)
                    # the eager generator runs at the longest row, not at
                    # the frame bucket: its kernels' work follows the width
                    t = max(max(gframes), 1)
                    audio = M.synthesizer_generate(
                        self.params, z[:, :t], y_mask[:, :t], cfg=self.model_cfg, g=g,
                        frames=gframes,
                    )
                    if self.precision == "fast":
                        # device-side int16 (voice.py:379-387): tanh output is in [-1, 1]
                        audio = torch.round(audio.float().clamp(-1.0, 1.0) * 32767.0).to(torch.int16)
                    else:
                        audio = audio.float()
                decodes += 1
                for row, j in enumerate(members):
                    n_samples = gframes[row] * u
                    pieces.append(audio[row, :n_samples])
                    rows.append((indices[j], pos, n_samples))
                    pos += n_samples
        if not pieces:
            return torch.zeros(0, device=self.device), rows, decodes
        return torch.cat(pieces), rows, decodes

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
        """Build the kernels (on CUDA), capture the encode graph of every
        phoneme bucket, a stream's latents graph of every frame bucket and
        the streaming chunk's graph (runtime/graphs.py).
        With `full`, also the flow graph of every frame bucket (at
        flow_graph_rows(bucket) rows, the only count it runs), and run
        one whole batch (encode, decode, copy to the host) per
        power-of-two row count up to the largest batch size, at this
        voice's device and dtype: the allocator's blocks, cuDNN's and
        cuBLAS's first calls and both kernels' first launches in the
        eager generator, so no request pays for them."""
        from .streaming import StreamingDecoder

        if self.device.type == "cuda":
            V.build()
        syn = SynthesisConfig(seed=0)
        tok = min(3, self.model_cfg.num_symbols - 1)
        b_max = max(batch_sizes)
        # each graph's key twice: a key's first call runs eagerly, its
        # second captures (runtime/graphs.py)
        with torch.inference_mode():
            for pb in self.phoneme_buckets:
                for _ in range(2):
                    self._encode([[tok] * pb], [utterance_seed(0, [tok] * pb)], pb, syn)
            c = self.model_cfg.inter_channels
            noise_in = self._noise_inputs([0], syn)
            for fb in self.frame_buckets:  # a stream's latents
                z = torch.zeros((1, fb, c), dtype=self.dtype, device=self.device)
                for _ in range(2):
                    self._graph("latents", self._latents_step, (z, z, z[..., :1], *noise_in))
            dec = StreamingDecoder(self)
            z = torch.zeros((1, dec.window, c), dtype=self.dtype, device=self.device)
            for _ in range(2):
                dec._vocode(z, dec.window, 0, 0, self._speaker(syn, 1))
        if not full:
            return
        with torch.inference_mode():
            for fb in self.frame_buckets:
                b = flow_graph_rows(fb, self.dtype)
                z = torch.zeros((b, fb, c), dtype=self.dtype, device=self.device)
                noise_in = self._noise_inputs([0] * b, syn)
                for _ in range(2):
                    self._flow(z, z, z[..., :1], *noise_in, self._speaker(syn, b))
        rows = 1
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
