"""TorchVoice: a loaded voice and its batched synthesis path.

Counterpart of piper_tpu/runtime/voice.py (TpuVoice), without a mesh.
A batch of id sequences runs as

  1. Phase A: rows grouped by phoneme bucket (runtime/batching.py) and
     one encode per bucket (text encoder + duration predictor), each one
     CUDA graph replay at (phoneme bucket, ENCODE_ROWS rows), the ids
     uploaded in the narrowest integer type that holds num_symbols;
  2. the decode plan, by one of two paths (TpuVoice.submit,
     piper_tpu/runtime/voice.py:1074-1101):
     - exact (the first batch, parity precision): every bucket's frame
       counts read to the host in one copy (Phase B), which calibrate
       the frames-per-id estimator;
     - speculative (fast precision, once the estimator is calibrated or
       loaded from its cache): each row's frame bucket from the
       estimate, min(max(int(len * ru) + 4, 1), top bucket), with no
       read at all; the true frame counts ride back in the header of
       the packed transfer (pack2), and collect() re-fetches or
       re-decodes the rows the estimate missed;
  3. each bucket's rows planned into decodes by `decode_grouping`
     (batching.plan_decode_groups: bucketed, uniform or packed), each
     decode (_vocode) at its frame bucket: prior expansion, then the
     frame-level stages (each frame's noise and the latents, the reverse
     flow, the generator's plain stages: models/vits/model.py
     synthesizer_frames) in frame windows, then HiFiGAN's kernels
     (generator_tm_suffix: mrf_fused and fused_upsample_mrf, which mask
     by the device lengths);
  4. conversion to int16 on the device (fast) or float32 (parity), the
     packed transfer on the wire format (int16, or mu-law encoded on the
     device: `wire_format`), and one copy of it to the host.

Dispatch fusion (TpuVoice's dispatch_fusion, voice.py:600-735; on by
default, as JAX's is without a mesh): once a speculative batch plan
(each encode group's phoneme bucket and rows, each decode's encode
group, frame bucket and row count, the transfer's a0 and total, the
wire, a speaker or none) has been seen 3 times, the batch that sees it
runs everything after the encodes as one function (_make_fused: every
decode of the plan, then pack2) and captures it into one CUDA graph,
which every later batch of that plan replays: each copies its inputs (the encode results,
one int64 table of the rows' keys, each decode's rows and frame-window
index and the speaker, the noise scale) into the graph and replays it
once. The body calls the same stages as the per-decode path, each frame
window through _frames_step on a copy of its inputs, so a fused batch's
audio equals the per-decode path's bit for bit. Unlike JAX, whose
compiles run in the background, a capture holds its batch and every
request behind it (0.1-0.9 s on the card, PERF.md), so a voice that
serves through a batcher captures nothing (its batches replay the plan
graphs captured before, and take the per-decode path otherwise), a
plan is captured only once the plan graph captured before it has
recurred (FUSION_EXPIRY), and at most FUSION_PLANS plan graphs are
kept, the
least recently replayed destroyed first: a plan whose `total` follows
drifting estimates may never recur, and its capture would be lost time
and held memory. A capture that fails is logged and counted
(`fused_failed`), and its plan keeps the per-decode path.

Frame windows: a decode's rows are cut into windows of WINDOW_FRAMES
frames with frame_halo(cfg) frames of context on either side, masked by
the row's valid span, and every window of every decode of the voice
runs in one CUDA graph shape, window_rows(cfg, dtype) windows per
replay (padded with copies of the first). A window's output depends on
its own inputs alone, so a row's frames get the same bits whatever its
frame bucket, its decode's width or the batch around it: cuBLAS and
cuDNN pick their algorithms by shape, and at the row's own bucket the
flow, conv_pre, the NWC stages and the polyphase product moved rows at
larger buckets on the card (ROADMAP fault 17, PERF.md). That is what
lets the speculative path decode at an estimated bucket and still give
the exact path's bits, as the JAX package promises
(tests/test_runtime.py:224-237). The kernels keep a row's bits at any
width (one sum order per element, masks by device lengths); their plain
versions on the CPU run fixed-tile products for the same reason.

The batch is split as TpuVoice splits it: submit() enqueues the device
work and starts the copy to the host (pinned memory, non_blocking, an
event after it), collect() waits on that event and returns the
waveforms, so a server's batcher can collect on another thread while
its next batch is submitted. With `batcher` set (server/batcher.py),
synthesize_batch and synthesize_stream_raw go through it. With `timer`
set (runtime/profiling.StageTimer), submit() times its phases (upload,
encode, frames_wait, decode, pack, and fused: a plan graph's capture,
copy-in and replay; copy).

Threads: a server calls one voice from many threads. The generator of
unseeded requests' seeds is guarded by a lock, the graphs by theirs
(runtime/graphs.py), the estimators by one lock (TpuVoice's
_ratio_lock) and the path counters by another. TF32 is switched off
once, when a voice is built (tf32_off): fast precision computes its
float32 parts without it at no cost (PERF.md), so both precisions run
under the same process-wide flags and no call switches them.

Noise: every utterance draws JAX's own random streams (ops/prng.py)
from JAX's key, fold_in(PRNGKey(seed), crc32(ids)) (TpuVoice._utt_keys,
voice.py:923-945): duration noise normal(fold_in(key, 0), (T_x, 2))
(voice.py:274-277), and frame i's noise normal(fold_in(fold_in(key, 1),
i), (C,)) (row_noise, voice.py:314-324). So a seeded utterance gets the
JAX package's noise, and its audio depends neither on the batch it
rides in nor on the frame count it is decoded at (the two properties of
voice.py:262-331). The host computes each row's key (one threefry) and
uploads the keys with the ids; the noise is drawn on the device, inside
the encode graph and the frame-window graph (each window at its frames'
absolute indices).
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import json
import logging
import math
import os
import threading
import time
import zlib
from pathlib import Path
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

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
from . import batching, codec
from .graphs import GraphCache
from .wav import audio_float_to_int16, int16_to_float

_LOGGER = logging.getLogger(__name__)

# Rows of every encode: a phoneme bucket's rows run in slices of this
# many, padded with copies of the slice's first row, so a row's bits
# never depend on how many rows share its bucket (cuBLAS and cuDNN pick
# their algorithms by shape; PERF.md). One encode graph per bucket.
ENCODE_ROWS = 16
# Frame windows of the decode: centre frames of a window, and the frames
# of one window graph in bf16 (half that in float32), for the same
# reason; 8192 bf16 frames was the flow graphs' budget before windows
# (a graph of them cost at most about twice one row's on the card).
WINDOW_FRAMES = 256
WINDOW_BUDGET = 8192
# Packed-transfer size granularity in samples (TpuVoice._PACK_QUANTUM,
# voice.py:115): a transfer's size is the body rounded up to this, or
# to a power of two of at least it (pack_total="pow2").
PACK_QUANTUM = 1 << 16
# Dispatch fusion: plan graphs a voice keeps (a capture past them
# destroys the least recently replayed), and the speculative batches
# within which a plan graph must be replayed once: until it is, or until
# these pass (it is then destroyed), no other plan is captured, so
# traffic whose plans do not recur pays for one capture in this many
# batches at most (a capture holds its batch 0.1-0.5 s on the card,
# PERF.md).
FUSION_PLANS = 16
FUSION_EXPIRY = 64
WIRE_FORMATS = ("int16", "mulaw")
PACK_TOTALS = ("quantum", "pow2")


def window_rows(cfg: ModelConfig, dtype: torch.dtype) -> int:
    """Windows per frame-window graph: as many WINDOW_FRAMES + 2 * halo
    frame windows as fit WINDOW_BUDGET frames in bf16, half in float32
    (at least 1). One count per voice and dtype, so every window runs at
    one shape."""
    span = WINDOW_FRAMES + 2 * M.frame_halo(cfg)
    return max(1, (WINDOW_BUDGET * 2 // dtype.itemsize) // span)


def estimator_dir(base: Optional[Union[str, Path]] = None) -> Path:
    """Where the port keeps its estimator snapshots: `base`, else
    $PIPER_TPU_CACHE, else ~/.cache, then piper_tpu_torch/estimators
    (the JAX package keeps its own under its compilation cache,
    piper_tpu/runtime/cache.py)."""
    if base is None:
        base = os.environ.get("PIPER_TPU_CACHE") or os.path.join(os.path.expanduser("~"), ".cache")
    return Path(base) / "piper_tpu_torch" / "estimators"


def round_total(body: int, pack_total: str) -> int:
    """A transfer body in samples rounded up to PACK_QUANTUM, or to the
    next power of two of at least PACK_QUANTUM (TpuVoice's pack_total)."""
    q = PACK_QUANTUM
    body = max(q, -(-body // q) * q)
    if pack_total == "pow2":
        p = q
        while p < body:
            p <<= 1
        body = p
    return body


def _rows_to_buffer(audio_list: Sequence[torch.Tensor], starts: torch.Tensor, length: int):
    """(length,) buffer of every decode group's rows, row r's whole padded
    width written at starts[r] in row order, later rows over earlier
    ones (TpuVoice._rows_to_buffer, voice.py:390-418: one
    dynamic_update_slice per row). Computed as the last writer of each
    position: per group, the last row starting at or before it (the
    group's starts are sorted), if its width reaches it. No host read."""
    dev = starts.device
    pad = max(a.shape[1] for a in audio_list)
    pos = torch.arange(length, device=dev)
    owner = torch.full((length,), -1, dtype=torch.long, device=dev)
    r0 = 0
    for a in audio_list:
        n, w = a.shape
        s = starts[r0 : r0 + n].contiguous()
        j = torch.searchsorted(s, pos, right=True) - 1
        jc = j.clamp(min=0)
        owner = torch.where((j >= 0) & (pos < s[jc] + w), jc + r0, owner)
        r0 += n
    rows = torch.cat([F.pad(a, (0, pad - a.shape[1])) for a in audio_list])
    o = owner.clamp(min=0)
    vals = rows[o, (pos - starts[o]).clamp(0, pad - 1)]
    return torch.where(owner >= 0, vals, torch.zeros((), dtype=vals.dtype, device=dev))


def pack2(audio_list: Sequence[torch.Tensor], ylen_list: Sequence[torch.Tensor], a0: int,
          total: int, upsample: int, mulaw: bool = False) -> torch.Tensor:
    """The speculative path's self-describing transfer (TpuVoice's
    _pack2_body, pack2_fn and pack2_mulaw_fn, voice.py:430-479): each
    row's valid samples, min(frames * upsample, its decode's width), at
    offsets a0 + the exclusive sum of the valid counts before it,
    computed on the device from the true frame counts `ylen_list`.
    int16 wire: a header of (frames & 0x7FFF, frames >> 15) int16 slots
    per row, zero-padded to a0 slots. mu-law wire: 4 bytes per row,
    frames little-endian in bytes 0-2, byte 3 zero, padded to a0 bytes,
    then the body mu-law encoded (a0 and total count bytes). A fixed
    shape for (rows, a0, total): nothing is read back to the host."""
    ylens = torch.cat(list(ylen_list)).to(torch.long)
    caps = torch.cat([torch.full((a.shape[0],), a.shape[1], dtype=torch.long, device=ylens.device)
                      for a in audio_list])
    valid = torch.minimum(ylens * upsample, caps)
    starts = (torch.cumsum(valid, 0) - valid).clamp(0, total - a0)
    body = _rows_to_buffer([a.to(torch.int16) for a in audio_list], starts, total - a0)
    if mulaw:
        hdr = torch.stack([ylens & 0xFF, (ylens >> 8) & 0xFF, (ylens >> 16) & 0xFF,
                           torch.zeros_like(ylens)], 1).reshape(-1)
        hdr = F.pad(hdr, (0, a0 - hdr.numel())).to(torch.uint8)
        return torch.cat([hdr, codec.mulaw_encode_torch(body)])
    hdr = torch.stack([ylens & 0x7FFF, ylens >> 15], 1).reshape(-1)
    hdr = F.pad(hdr, (0, a0 - hdr.numel())).to(torch.int16)
    return torch.cat([hdr, body])


def read_header(flat: np.ndarray, rows: int) -> np.ndarray:
    """The true frame counts of a pack2 transfer on the host
    (TpuVoice._collect_speculative, voice.py:1479-1488)."""
    if flat.dtype == np.uint8:
        hdr = flat[: 4 * rows].astype(np.int64).reshape(rows, 4)
        return hdr[:, 0] | (hdr[:, 1] << 8) | (hdr[:, 2] << 16)
    hdr = flat[: 2 * rows].astype(np.int64)
    return (hdr[1::2] << 15) | (hdr[0::2] & 0x7FFF)


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
        wire_format: str = "int16",
        pack_total: str = "quantum",
        estimator_cache: bool = False,
        cache_dir: Optional[Union[str, Path]] = None,
        dispatch_fusion: Optional[bool] = None,
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
        the same under any of them.

        `wire_format` (TpuVoice's, voice.py:139-148): the packed
        device->host transfer in "int16" (2 bytes a sample) or "mulaw"
        (G.711 encoded on the device, 1 byte a sample, lossy; fast
        precision only: parity transfers float32). collect() returns
        float32 either way.
        `pack_total`: "quantum" rounds a transfer up to PACK_QUANTUM
        samples, "pow2" to a power of two (fewer distinct sizes under
        concurrent serving, up to twice the bytes).
        `estimator_cache`: keep the calibrated frames-per-id estimator
        and transfer margin in a snapshot under estimator_dir(cache_dir),
        keyed by the weights and every knob that shapes the speculative
        path, so a fresh process starts on the speculative path.
        `dispatch_fusion` (TpuVoice's, voice.py:180-185; None means on):
        replay one CUDA graph for each speculative batch plan seen 3
        times (FUSION_EXPIRY and FUSION_PLANS bound the captures)."""
        if precision not in ("parity", "fast"):
            raise ValueError(f"precision: {precision!r}")
        if decode_grouping not in batching.DECODE_GROUPINGS:
            raise ValueError(f"decode_grouping: {decode_grouping!r}")
        if pack_total not in PACK_TOTALS:
            raise ValueError(f"pack_total: {pack_total!r}")
        self.precision = precision
        self._check_wire(wire_format)
        self.device = resolve_device(device)
        tf32_off()
        self.config = config
        self.model_cfg = model_cfg
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
        self.wire_format = wire_format
        self.pack_total = pack_total
        # Narrowest host->device type of the phoneme ids (TpuVoice's
        # _ids_wire_dtype, voice.py:243): embedding indices are
        # non-negative, so 8 unsigned bits cover a 256-symbol table.
        ns = model_cfg.num_symbols
        self._ids_wire_dtype = (
            torch.uint8 if ns <= 256 else torch.int16 if ns < 32768 else torch.int32
        )
        self._halo = M.frame_halo(model_cfg)
        self._win_rows = window_rows(model_cfg, self.dtype)
        self._prefix_factor = (model_cfg.upsample_factor if model_cfg.vocoder == "mb_istft"
                               else G.prefix_factor(model_cfg))
        # frame windows hold every plain stage only when no plain product
        # lies between two kernels (every preset); otherwise rows could
        # move with their bucket, and no batch goes speculative
        self.speculative_ok = model_cfg.vocoder == "mb_istft" or G.keeps_row_bits(model_cfg)
        self.graphs = GraphCache(self.device)
        self._rng = np.random.default_rng(seed)  # seeds of unseeded rows
        self._rng_lock = threading.Lock()
        self.batcher = None  # server/batcher.CoalescingBatcher, when serving
        self.timer = None  # runtime/profiling.StageTimer: spans of submit()
        # frames-per-id estimator of the speculative buckets, (mean,
        # upper); None until an exact batch calibrates it. The transfer's
        # headroom over its estimated body (TpuVoice, voice.py:503-518).
        self._ratio: Optional[Tuple[float, float]] = None
        self._spec_margin = 1.12
        self._spec_calibrated = False
        self._spec_need_hist: List[float] = []
        self._ratio_lock = threading.Lock()
        # batches by path (fused: speculative batches that replayed a
        # plan graph), rows the speculative path missed, failed captures
        self.path_counts = {"exact": 0, "speculative": 0, "fused": 0, "refetched": 0,
                            "redecoded": 0, "longform": 0, "fused_failed": 0}
        # dispatch fusion: plan key -> "pending" | "ready" | "failed" (the
        # ready ones least recently replayed first), sightings of the keys
        # not captured yet (TpuVoice, voice.py:609-614), speculative
        # batches seen, and the plan graph not replayed since its capture
        # with the batch it was captured at
        self._fusion = True if dispatch_fusion is None else bool(dispatch_fusion)
        self._fused_cache: dict = {}
        self._fused_counts: dict = {}
        self._fused_batches = 0
        self._unreplayed: Optional[Tuple[tuple, int]] = None
        self._fused_lock = threading.Lock()
        self._fused_done = threading.Condition(self._fused_lock)
        self._counts_lock = threading.Lock()
        self._estimator_cache_path: Optional[Path] = None
        if estimator_cache:
            self._estimator_cache_path = self._estimator_cache_file(params, cache_dir)
            self._load_estimators()

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
        the host; returns a handle for collect(). On the exact path the
        one wait is for the frame counts, one copy for the whole batch
        (Phase B); on the speculative path submit() waits for nothing.

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
        with torch.inference_mode():
            # Phase A: every phoneme bucket's encode, no wait
            groups = []
            for bucket, indices in batching.group_by_bucket(
                [len(ids) for ids in ids_list], self.phoneme_buckets
            ):
                rkeys = [keys[i] for i in indices]
                enc, frames = self._encode([ids_list[i] for i in indices], rkeys, bucket, syn)
                groups.append((indices, rkeys, enc, frames))
            if groups and self._speculative():
                handle = self._dispatch_speculative(groups, ids_list, syn)
            else:
                handle = self._dispatch_exact(groups, ids_list, syn)
        handle.update(n=len(ids_list), t0=t0)
        return handle

    def _speculative(self) -> bool:
        """Whether a batch takes the speculative path: fast precision,
        a voice whose rows keep their bits at any bucket, and a
        calibrated estimator (voice.py:1079-1083)."""
        if self.precision != "fast" or not self.speculative_ok:
            return False
        with self._ratio_lock:
            return self._ratio is not None

    def _count(self, key: str, n: int = 1) -> None:
        with self._counts_lock:
            self.path_counts[key] += n

    def _to_host(self, flat: torch.Tensor):
        """Start the one copy of a batch's transfer to the host: into
        pinned memory without waiting, an event after it (collect() waits
        on the event, from whichever thread it runs on)."""
        with self._span("copy"):
            if self.device.type != "cuda":
                return flat, None
            host = torch.empty(flat.shape, dtype=flat.dtype, pin_memory=True)
            host.copy_(flat, non_blocking=True)
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(self.device))
            return host, event

    def _dispatch_exact(self, groups, ids_list, syn: SynthesisConfig) -> dict:
        """Phase B and the decodes at the true frame buckets: all frame
        counts in one copy, which also calibrate the estimator."""
        self._count("exact")
        counts = self._read_frames([g[3] for g in groups])
        ratios = [f / len(ids_list[i]) for (indices, *_), frames in zip(groups, counts)
                  for i, f in zip(indices, frames) if len(ids_list[i]) > 0]
        if ratios:
            self._update_ratio(ratios)
        u = self.model_cfg.upsample_factor
        pieces: List[torch.Tensor] = []
        rows: List[Tuple[int, int, int]] = []
        pos = decodes = 0
        for (indices, rkeys, enc, _), frames in zip(groups, counts):
            for fbucket, members in self._plan_decode_groups(frames):
                gframes = [frames[j] for j in members]
                audio = self._decode_members(enc, rkeys, members, fbucket, gframes, syn)
                decodes += 1
                for row, j in enumerate(members):
                    n_samples = gframes[row] * u
                    pieces.append(audio[row, :n_samples])
                    rows.append((indices[j], pos, n_samples))
                    pos += n_samples
        flat = torch.cat(pieces) if pieces else torch.zeros(0, device=self.device)
        if self.precision == "fast" and pieces:
            # the transfer's size (TpuVoice's pack_fn total, voice.py:1180-1185)
            flat = F.pad(flat, (0, round_total(pos, self.pack_total) - pos))
            if self.wire_format == "mulaw":
                flat = codec.mulaw_encode_torch(flat)
        host, event = self._to_host(flat)
        return {"host": host, "event": event, "rows": rows, "decodes": decodes}

    def _decode_members(self, enc, rkeys, members, fbucket: int, frames: Optional[Sequence[int]],
                        syn: SynthesisConfig) -> torch.Tensor:
        """Decode rows `members` of an encode group at `fbucket`: with
        `frames` (their true counts, known on the host) each row's frame
        windows up to its length and the kernels at the longest row (the
        exact path, re-decodes, the long form), without them every
        window of the bucket and the kernels at its width (the
        speculative path). Returns int16 audio (fast) or float32."""
        n = len(members)
        sel = self._rows_index(members, enc.m_p.shape[0])
        if sel is not None:
            enc = M.EncodeResult(*(t.index_select(0, sel) for t in enc))
        keys_t, scale_t = self._noise_inputs([rkeys[j] for j in members], syn)
        W = WINDOW_FRAMES
        if frames is None:
            windows, width = [-(-fbucket // W)] * n, fbucket
        else:
            windows, width = [max(-(-f // W), 1) for f in frames], max(max(frames), 1)
        with self._span("decode"):
            return self._audio_out(self._vocode(enc, fbucket, keys_t, scale_t, self._speaker(syn, n),
                                                windows, width))

    def _audio_out(self, audio: torch.Tensor) -> torch.Tensor:
        if self.precision == "fast":
            # device-side int16 (voice.py:379-387): tanh output is in [-1, 1]
            return torch.round(audio.float().clamp(-1.0, 1.0) * 32767.0).to(torch.int16)
        return audio.float()

    def _rows_index(self, members: Sequence[int], rows: int) -> Optional[torch.Tensor]:
        """`members` as a device index (pinned, copied without waiting),
        None when they are all `rows` rows in order."""
        if list(members) == list(range(rows)):
            return None
        sel = torch.tensor(members, pin_memory=self.device.type == "cuda")
        return sel.to(self.device, non_blocking=True)

    def _frames_step(self, m_p, logs_p, mask, keys, offsets, noise_scale, sid):
        """The frame-window graph's function over window_rows windows of
        WINDOW_FRAMES + 2 * halo frames: each frame's noise from its row's
        key at its absolute index (offsets: each window's first frame,
        negative in a row's first window), the latents, then
        synthesizer_frames under the window's mask. Returns the windows'
        centre frames."""
        idx = (offsets[:, None] + torch.arange(m_p.shape[1], device=m_p.device)).clamp(min=0)
        noise = prng.normal(prng.fold_in(prng.fold_in(keys, 1)[:, None, :], idx), (m_p.shape[2],))
        z_p = M.sample_latents(m_p, logs_p, mask, noise, noise_scale)
        g = M.speaker_embedding(self.params, self.model_cfg, sid)
        out = M.synthesizer_frames(self.params, z_p, mask, cfg=self.model_cfg, g=g)
        f, h = self._prefix_factor, self._halo
        return (out[..., h * f : (h + WINDOW_FRAMES) * f],)

    def _vocode(self, enc, fbucket: int, keys_t, scale_t, sid, windows: Sequence[int],
                width: int, idx: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Audio (rows, width * upsample) of encoded rows at `fbucket`:
        prior expansion, the rows' frame windows (_frames), then
        HiFiGAN's kernels at `width` frames. keys_t (rows, 2) and scale_t
        (1,) on the device; sid (rows,) or None; idx as _frames takes it."""
        m_p, logs_p, y_mask = M.expand_prior(enc, fbucket)
        x = self._frames(m_p, logs_p, y_mask, keys_t, scale_t, sid, windows, idx)
        f = self._prefix_factor
        if self.model_cfg.vocoder == "mb_istft":
            return x[:, : width * f]
        lens = (y_mask[..., 0] > 0).sum(dim=1).to(torch.int32)
        return G.generator_tm_suffix(self.params["dec"], self.params["dec_tm"],
                                     x[:, :, : width * f].contiguous(), lens, cfg=self.model_cfg)

    def _window_index(self, windows: Sequence[int]) -> List[int]:
        """The frame windows' index of rows with windows[r] windows each
        (nw = max(windows) slots a row): the used slots, then the order
        of the window graph's replays, window_rows slots each, a replay's
        last slots filled with copies of its first."""
        nw, k = max(windows), self._win_rows
        sel = [r * nw + w for r in range(len(windows)) for w in range(windows[r])]
        order = []
        for lo in range(0, len(sel), k):
            part = sel[lo : lo + k]
            order += part + part[:1] * (k - len(part))
        return sel + order

    def _frames(self, m_p, logs_p, y_mask, keys_t, scale_t, sid, windows: Sequence[int],
                idx: Optional[torch.Tensor] = None):
        """The frame-level stages of rows (m_p, logs_p (rows, T, C), y_mask
        (rows, T, 1)): the first windows[r] frame windows of row r through
        the frame-window graph, window_rows windows a replay (padded with
        copies of the first), their centres stitched. Returns HiFiGAN's
        time-major (rows, C, nw * WINDOW_FRAMES * prefix_factor) or
        MB-iSTFT's (rows, nw * WINDOW_FRAMES * upsample) audio, nw =
        max(windows).

        `idx`: _window_index(windows) already on the device, from a plan
        graph's body (_make_fused): then each replay's windows go through
        _frames_step itself, on fresh copies as the graph's static inputs
        would be (one capture cannot replay another graph)."""
        W, h = WINDOW_FRAMES, self._halo
        span, k = W + 2 * h, self._win_rows
        b, t = m_p.shape[:2]
        nw = max(windows)
        right = max(nw * W + h - t, 0)

        def cut(x):  # (rows, T, ch) -> (rows * nw, span, ch)
            xp = F.pad(x, (0, 0, h, right))[:, : nw * W + 2 * h]
            return xp.unfold(1, span, W).transpose(2, 3).reshape(b * nw, span, x.shape[2])

        n_sel = sum(windows)
        fused = idx is not None
        if not fused:
            idx = torch.tensor(self._window_index(windows), dtype=torch.long,
                               pin_memory=self.device.type == "cuda").to(self.device, non_blocking=True)
        sel_d, order_d = idx[:n_sel], idx[n_sel:]
        offsets = (order_d % nw) * W - h
        windows_in = [x.index_select(0, order_d) for x in (cut(m_p), cut(logs_p), cut(y_mask))]
        keys_w = keys_t.index_select(0, order_d // nw)
        sid_w = None if sid is None else sid[:1].repeat(k)
        key = ("frames", k, span, self.dtype, sid is not None)
        outs = []
        for lo in range(0, order_d.shape[0], k):
            part = slice(lo, lo + k)
            inputs = (*(x[part] for x in windows_in), keys_w[part], offsets[part], scale_t, sid_w)
            if fused:
                out = self._frames_step(*(None if x is None else x.clone() for x in inputs))[0]
            else:
                out = self.graphs.run(key, self._frames_step, inputs)[0]
            outs.append(out[: min(k, n_sel - lo)])
        centres = torch.cat(outs)
        buf = centres.new_zeros((b * nw,) + centres.shape[1:]).index_copy_(0, sel_d, centres)
        if buf.dim() == 2:  # MB-iSTFT's audio
            return buf.reshape(b, -1)
        c, wf = buf.shape[1:]
        return buf.reshape(b, nw, c, wf).permute(0, 2, 1, 3).reshape(b, c, nw * wf)

    def set_wire_format(self, wire_format: str) -> None:
        """Switch the transfer's wire format on a live voice
        (TpuVoice.set_wire_format, voice.py:961)."""
        self._check_wire(wire_format)
        self.wire_format = wire_format

    def _check_wire(self, wire_format: str) -> None:
        if wire_format not in WIRE_FORMATS:
            raise ValueError(f"wire_format: {wire_format!r}")
        if wire_format == "mulaw" and self.precision == "parity":
            raise ValueError(
                "wire_format='mulaw' needs the int16 device path "
                "(precision='fast'); parity mode transfers float32"
            )

    @property
    def spec_margin(self) -> float:
        """The speculative transfer's headroom over its estimated body."""
        with self._ratio_lock:
            return self._spec_margin

    def collect(
        self, handle: dict, *, stats: Optional[SynthesisStats] = None
    ) -> List[np.ndarray]:
        """Wait for a submit()ted batch; returns float32 waveforms."""
        if handle["event"] is not None:
            handle["event"].synchronize()
        results: List[np.ndarray] = [np.zeros(0, np.float32)] * handle["n"]
        if "spec" in handle:
            self._collect_speculative(handle, results)
        else:
            host = handle["host"].numpy()
            if host.dtype == np.uint8:
                host = codec.mulaw_decode(host)
            if host.dtype == np.int16:
                host = int16_to_float(host)
            for idx, start, n in handle["rows"]:
                results[idx] = host[start : start + n]
        if stats is not None:
            stats.infer_seconds += time.perf_counter() - handle["t0"]
            stats.audio_seconds += sum(len(r) for r in results) / self.config.sample_rate
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

    # ------------------------------------------------------------------
    # The speculative path (TpuVoice, voice.py:1217-1612)
    # ------------------------------------------------------------------

    def _update_ratio(self, ratios: Sequence[float]) -> None:
        """Track (mean, upper) frames per id (TpuVoice._update_ratio,
        voice.py:1217-1244): mean sizes the transfer, upper picks the
        decode buckets. Both are piecewise constant with hysteresis:
        upper jumps at once on a near miss (a miss costs a re-decode) and
        drops only when twice too large; mean moves only when more than
        12.5% off. Seeded at (mean * 1.05, max * 1.25)."""
        obs_mean = float(np.mean(ratios))
        obs_max = float(np.max(ratios))
        with self._ratio_lock:
            prev = self._ratio
            if self._ratio is None:
                self._ratio = (obs_mean * 1.05, obs_max * 1.25)
            else:
                rm, ru = self._ratio
                if not (0.875 * rm <= obs_mean * 1.05 <= 1.125 * rm):
                    rm = obs_mean * 1.05
                if obs_max * 1.1 > ru or obs_max * 2.0 < ru:
                    ru = obs_max * 1.25
                self._ratio = (rm, ru)
            if self._ratio != prev:
                self._save_estimators_locked()

    def _update_margin(self, need: float, short: int) -> None:
        """Calibrate the transfer's margin from a batch's realized need
        (its valid body over its estimate) and its shortfall rows
        (voice.py:1555-1604): past a shortfall the margin jumps to
        max(need, margin) * 1.05 (cap 1.5); until calibrated it snaps to
        the largest need of 4 batches * 1.05 (floor 0.25, never above
        itself); then it tightens to the largest need of 16 * 1.04 when
        that is 0.02 below it, keeping the last 8."""
        with self._ratio_lock:
            m = self._spec_margin
            if short:
                if need * 1.05 > 1.5:
                    _LOGGER.info("speculative transfer margin cap (1.5) binding: realized need "
                                 "%.2fx estimate; %d rows re-fetched", need, short)
                self._spec_margin = min(max(need * 1.05, m * 1.05), 1.5)
                self._spec_calibrated = True
                self._spec_need_hist.clear()
            elif not self._spec_calibrated:
                self._spec_need_hist.append(need)
                if len(self._spec_need_hist) >= 4:
                    self._spec_margin = min(max(max(self._spec_need_hist) * 1.05, 0.25), m)
                    self._spec_calibrated = True
                    del self._spec_need_hist[:]
            else:
                self._spec_need_hist.append(need)
                if len(self._spec_need_hist) >= 16:
                    tight = max(self._spec_need_hist) * 1.04
                    if tight < m - 0.02:
                        self._spec_margin = max(tight, 0.25)
                    del self._spec_need_hist[:-8]
            if self._spec_margin != m:
                self._save_estimators_locked()

    def _estimator_cache_file(self, params, cache_dir) -> Path:
        """The snapshot's path, keyed as TpuVoice keys it
        (voice.py:1248-1286): every parameter's path and shape, a strided
        sample of the embedding, the model config, and the buckets,
        grouping, wire and precision."""
        h = hashlib.md5()

        def walk(path, node):
            if isinstance(node, dict):
                for k in sorted(node, key=str):
                    walk(f"{path}/{k}", node[k])
            elif isinstance(node, (list, tuple)):
                for i, v in enumerate(node):
                    walk(f"{path}/{i}", v)
            elif node is not None:
                h.update(path.encode())
                h.update(str(tuple(np.shape(node))).encode())

        walk("", params)
        emb = np.asarray(params["enc_p"]["emb"]["weight"], np.float32)
        h.update(emb[:: max(1, emb.shape[0] // 8)].tobytes())
        h.update(repr(self.model_cfg).encode())
        h.update(repr((tuple(self.phoneme_buckets), tuple(self.frame_buckets),
                       self.decode_grouping, self.wire_format, self.precision)).encode())
        return estimator_dir(cache_dir) / (h.hexdigest() + ".json")

    def _load_estimators(self) -> None:
        """Start from a snapshot when there is a valid one: finite values,
        rm, ru > 0, margin in [0.25, 1.5]; a bad one is deleted."""
        path = self._estimator_cache_path
        if path is None or not path.exists():
            return
        try:
            snap = json.loads(path.read_text())
            rm, ru = float(snap["ratio"][0]), float(snap["ratio"][1])
            margin = float(snap["margin"])
            if not all(math.isfinite(v) for v in (rm, ru, margin)):
                raise ValueError("non-finite estimator value")
            if not (rm > 0 and ru > 0 and 0.25 <= margin <= 1.5):
                raise ValueError("estimator value out of range")
        except (OSError, ValueError, KeyError, TypeError, IndexError) as e:
            _LOGGER.info("ignoring the estimator snapshot %s: %s", path, e)
            path.unlink(missing_ok=True)
            return
        with self._ratio_lock:
            self._ratio = (rm, ru)
            self._spec_margin = margin
            self._spec_calibrated = True

    def _save_estimators_locked(self) -> None:
        """Write the snapshot atomically (the caller holds _ratio_lock).
        The values are piecewise constant, so this runs on a change, not
        on every batch."""
        path = self._estimator_cache_path
        if path is None or self._ratio is None:
            return
        try:
            path.parent.mkdir(parents=True, exist_ok=True)
            tmp = path.with_suffix(f".tmp{os.getpid()}")
            tmp.write_text(json.dumps({"ratio": list(self._ratio), "margin": self._spec_margin}))
            os.replace(tmp, path)
        except OSError as e:
            _LOGGER.info("estimator snapshot not written: %s", e)

    def _dispatch_speculative(self, groups, ids_list, syn: SynthesisConfig) -> dict:
        """Decode at the estimated frame buckets and emit one
        self-describing transfer (pack2), with no host read
        (TpuVoice._dispatch_speculative, voice.py:1337-1457)."""
        self._count("speculative")
        with self._ratio_lock:
            rm, ru = self._ratio
            margin = self._spec_margin
        # quantized at use (voice.py:1346-1351): groupings stay put while
        # the estimate drifts underneath
        rm = math.ceil(rm * 8.0) / 8.0
        ru = math.ceil(ru * 8.0) / 8.0
        u = self.model_cfg.upsample_factor
        max_fb = self.frame_buckets[-1]
        plan = []  # (encode group, bucket, rows of the group)
        # per row: (result index, cap samples, decode, row in decode,
        #           encode group, row in encode group, id count)
        rows: List[Tuple[int, int, int, int, int, int, int]] = []
        est_total = 0
        for eg_no, (indices, *_rest) in enumerate(groups):
            lens = [len(ids_list[i]) for i in indices]
            est = [min(max(int(n * ru) + 4, 1), max_fb) for n in lens]
            for fbucket, members in self._plan_decode_groups(est):
                cap = fbucket * u
                for row_i, row in enumerate(members):
                    rows.append((indices[row], cap, len(plan), row_i, eg_no, row, lens[row]))
                    est_total += min(int(lens[row] * rm * u) + 4 * u, cap)
                plan.append((eg_no, fbucket, members))
        mulaw = self.wire_format == "mulaw"
        # header: 2 int16 slots a row, or 4 bytes a row on mu-law (where
        # a0 and total count bytes, one a sample)
        a0 = -(-(4 if mulaw else 2) * len(rows) // 128) * 128
        total = a0 + round_total(int(est_total * margin), self.pack_total)
        key = (tuple((enc.m_p.shape[1], enc.m_p.shape[0]) for _i, _k, enc, _f in groups),
               tuple((eg_no, fbucket, len(members)) for eg_no, fbucket, members in plan),
               a0, total, mulaw, self.speaker_id(syn) is not None)
        packed = self._run_plan(key, groups, plan, syn)
        if packed is None:
            audio, ylens = [], []
            for eg_no, fbucket, members in plan:
                _, rkeys, enc, frames = groups[eg_no]
                audio.append(self._decode_members(enc, rkeys, members, fbucket, None, syn))
                sel = self._rows_index(members, frames.shape[0])
                ylens.append(frames if sel is None else frames.index_select(0, sel))
            with self._span("pack"):
                packed = pack2(audio, ylens, a0, total, u, mulaw)
        else:
            packed, *audio = packed
        host, event = self._to_host(packed)
        return {"host": host, "event": event, "decodes": len(plan), "spec": {
            "a0": a0, "total": total, "est_body": est_total, "rows": rows, "audio": audio,
            "groups": groups, "syn": syn}}

    # ------------------------------------------------------------------
    # Dispatch fusion (TpuVoice, voice.py:645-735)
    # ------------------------------------------------------------------

    def _fused_get(self, key) -> Tuple[Optional[str], List[tuple]]:
        """("ready", []) when the plan's graph is; ("capture", the plan
        graphs to destroy first) when this batch captures it: at the
        plan's 3rd sighting or later (TpuVoice._fused_get, voice.py:672-
        700), unless the voice serves through a batcher (a capture would
        hold every request waiting behind it), once the plan graph
        captured last has been replayed or has gone FUSION_EXPIRY
        batches without; else (None, [])."""
        if not self._fusion:
            return None, []
        with self._fused_lock:
            self._fused_batches += 1
            state = self._fused_cache.get(key)
            if state == "ready":
                self._fused_cache[key] = self._fused_cache.pop(key)  # most recently used last
                if self._unreplayed is not None and self._unreplayed[0] == key:
                    self._unreplayed = None
                return "ready", []
            if state is not None:
                return None, []
            n = self._fused_counts.get(key, 0) + 1
            self._fused_counts[key] = n
            if n < 3 or self.batcher is not None:
                return None, []
            victims = []
            if self._unreplayed is not None:
                last, at = self._unreplayed
                if (self._fused_batches - at < FUSION_EXPIRY
                        or self._fused_cache.get(last) != "ready"):
                    return None, []
                del self._fused_cache[last]  # it did not recur
                victims.append(last)
            ready = [k for k, v in self._fused_cache.items() if v == "ready"]
            if len(ready) >= FUSION_PLANS:
                del self._fused_cache[ready[0]]
                victims.append(ready[0])
            self._unreplayed = (key, self._fused_batches)
            self._fused_cache[key] = "pending"
            return "capture", victims

    def _run_plan(self, key, groups, plan, syn: SynthesisConfig) -> Optional[Tuple[torch.Tensor, ...]]:
        """The batch through its plan's function (the packed transfer,
        then each decode's audio): run eagerly and captured when
        _fused_get says so, replayed once captured; None when the batch
        takes the per-decode path. A capture that fails is logged with
        its cause and counted, and its plan keeps the per-decode path."""
        state, victims = self._fused_get(key)
        if state is None:
            return None
        for victim in victims:
            self.graphs.drop(("plan", victim))
        inputs = self._plan_inputs(groups, plan, syn)
        try:
            with self._span("fused"):
                out = self.graphs.run(("plan", key), self._make_fused(key), inputs, capture_at=1)
        except Exception:
            if state == "ready":
                raise
            _LOGGER.warning("dispatch fusion: capturing the graph of plan %s failed; its batches keep "
                            "the per-decode path", key, exc_info=True)
            self._count("fused_failed")
            out = None
        if state == "capture":
            with self._fused_done:
                self._fused_cache[key] = "ready" if out is not None else "failed"
                if out is None and self._unreplayed is not None and self._unreplayed[0] == key:
                    self._unreplayed = None
                self._fused_done.notify_all()
        if out is not None:
            self._count("fused")
        return out

    def _plan_inputs(self, groups, plan, syn: SynthesisConfig) -> List[torch.Tensor]:
        """A batch's inputs of its plan graph: each encode group's results
        and frame counts (on the device), then one int64 table (each
        group's (rows, 2) key words, each decode's rows in its encode
        group, each decode's frame-window index (_window_index), the
        speaker when there is one) and the (1,) noise scale, pinned on
        CUDA."""
        with self._span("upload"):
            nw = [-(-fbucket // WINDOW_FRAMES) for _eg, fbucket, _m in plan]
            words = [w for _i, rkeys, _e, _f in groups for k in rkeys for w in (k >> 32, k & prng.MASK)]
            words += [j for _eg, _fb, members in plan for j in members]
            words += [j for n, (_eg, _fb, members) in zip(nw, plan)
                      for j in self._window_index([n] * len(members))]
            spk = self.speaker_id(syn)
            if spk is not None:
                words.append(spk)
            table = torch.tensor(words, dtype=torch.int64, pin_memory=self.device.type == "cuda")
            scale = self._host_zeros((1,))
            scale[0] = self._scales(syn)[0]
        return [t for _i, _k, enc, frames in groups for t in (*enc, frames)] + [table, scale]

    def _make_fused(self, key):
        """The plan graph's function (TpuVoice._make_fused, voice.py:645-
        670) over _plan_inputs' tensors: for each decode of the plan what
        the speculative path's _decode_members does (select the rows,
        prior expansion, every frame window of the bucket through
        _frames_step, both kernels, int16), then pack2. Every index comes
        in the table, so the body copies nothing from the host and reads
        nothing back. Returns the packed transfer and each decode's audio
        (collect() re-fetches from it)."""
        groups, plan, a0, total, mulaw, has_sid = key
        W, u = WINDOW_FRAMES, self.model_cfg.upsample_factor
        ng = len(groups)

        def fused(*inputs):
            encs = [M.EncodeResult(*inputs[5 * g : 5 * g + 4]) for g in range(ng)]
            frames = inputs[4 : 5 * ng : 5]
            table, scale = inputs[5 * ng :]
            keys, pos = [], 0
            for _pb, rows in groups:
                keys.append(table[pos : pos + 2 * rows].view(rows, 2))
                pos += 2 * rows
            sels = []
            for _eg, _fb, n in plan:
                sels.append(table[pos : pos + n])
                pos += n
            audio, ylens = [], []
            for (eg_no, fb, n), sel in zip(plan, sels):
                windows = [-(-fb // W)] * n
                win_idx = table[pos : pos + 2 * sum(windows) + (-sum(windows)) % self._win_rows]
                pos += win_idx.shape[0]
                enc = M.EncodeResult(*(t.index_select(0, sel) for t in encs[eg_no]))
                sid = table[-1:].expand(n) if has_sid else None
                x = self._vocode(enc, fb, keys[eg_no].index_select(0, sel), scale, sid, windows, fb,
                                 win_idx)
                audio.append(self._audio_out(x))
                ylens.append(frames[eg_no].index_select(0, sel))
            return (pack2(audio, ylens, a0, total, u, mulaw), *audio)

        return fused

    @property
    def dispatch_fusion(self) -> bool:
        return self._fusion

    def wait_dispatch_fusion(self, timeout: float = 120.0) -> bool:
        """Block until no plan graph is being captured on another thread
        (True) or `timeout` seconds pass (False); True at once with
        fusion off (TpuVoice.wait_dispatch_fusion, voice.py:717-735)."""
        with self._fused_done:
            return self._fused_done.wait_for(
                lambda: "pending" not in self._fused_cache.values(), timeout)

    def _seg_to_float(self, seg: np.ndarray) -> np.ndarray:
        """One segment of the transfer -> float32 (decodes the wire)."""
        if seg.dtype == np.uint8:
            seg = codec.mulaw_decode(seg)
        return int16_to_float(seg)

    def _int16_through_wire(self, seg: np.ndarray) -> np.ndarray:
        """int16 samples fetched outside the transfer (a re-fetch or a
        re-decode) -> float32 through the wire's codec, so the row's
        bits equal a packed row's (voice.py:1467-1476)."""
        if self.wire_format == "mulaw":
            seg = codec.mulaw_decode(codec.mulaw_encode(seg))
        return int16_to_float(seg)

    def _collect_speculative(self, handle: dict, results: List[np.ndarray]) -> None:
        """Read the rows that fit from the transfer, re-fetch the margin's
        shortfalls, re-decode the bucket overflows (one decode per
        encode group and bucket) and rows past the ladder (alone at their
        own frame count), then calibrate the margin and the estimator
        (TpuVoice._collect_speculative, voice.py:1478-1612)."""
        spec = handle["spec"]
        flat = handle["host"].numpy()
        rows = spec["rows"]
        u = self.model_cfg.upsample_factor
        true_frames = read_header(flat, len(rows))
        total, out = spec["total"], spec["a0"]
        refetch, redecode = [], []
        for i, (res_idx, cap, *_r) in enumerate(rows):
            n_true = int(true_frames[i]) * u
            valid = min(n_true, cap)
            if n_true <= cap and out + valid <= total:
                results[res_idx] = self._seg_to_float(flat[out : out + valid])
            elif n_true <= cap:
                refetch.append((i, n_true))
            else:
                redecode.append((i, int(true_frames[i])))
            out += valid
        for i, n_true in refetch:
            res_idx, _cap, g_no, row_i, *_r = rows[i]
            seg = spec["audio"][g_no][row_i, :n_true].cpu().numpy()
            results[res_idx] = self._int16_through_wire(seg)
        self._count("refetched", len(refetch))
        max_fb = self.frame_buckets[-1]
        by_group: dict = {}
        with torch.inference_mode():
            for i, frames in redecode:
                fbucket = batching.pick_bucket(frames, self.frame_buckets) if frames <= max_fb else frames
                by_group.setdefault((rows[i][4], fbucket), []).append((i, frames))
            for (eg_no, fbucket), items in by_group.items():
                _, rkeys, enc, _f = spec["groups"][eg_no]
                frames = [f for _, f in items]
                audio = self._decode_members(enc, rkeys, [rows[i][5] for i, _ in items], fbucket,
                                             frames, spec["syn"])
                for j, (i, f) in enumerate(items):
                    results[rows[i][0]] = self._int16_through_wire(audio[j, : f * u].cpu().numpy())
            handle["decodes"] += len(by_group)
        long = sum(f > max_fb for _, f in redecode)
        self._count("redecoded", len(redecode) - long)
        self._count("longform", long)
        if spec["est_body"] > 0:
            # `out` ends at a0 + the sum of the valid counts: what a
            # perfectly sized transfer would have carried
            self._update_margin((out - spec["a0"]) / spec["est_body"], len(refetch))
        ratios = [float(true_frames[i]) / r[6] for i, r in enumerate(rows) if r[6] > 0]
        if ratios:
            self._update_ratio(ratios)

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
        With `full`, also the frame-window graph (every decode's one
        shape), and run one whole batch (encode, decode, copy to the
        host) per power-of-two row count up to the largest batch size,
        at this voice's device and dtype: the allocator's blocks, cuDNN's
        and cuBLAS's first calls and both kernels' first launches, so no
        request pays for them. The batches run on the exact path and
        leave the estimators as they were."""
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
            k = self._win_rows
            z = torch.zeros((k, WINDOW_FRAMES + 2 * self._halo, c), dtype=self.dtype,
                            device=self.device)
            keys, scale = self._noise_inputs([0] * k, syn)
            offsets = torch.zeros((k,), dtype=torch.long, device=self.device)
            key = ("frames", k, z.shape[1], self.dtype, self.speaker_id(syn) is not None)
            for _ in range(2):
                self.graphs.run(key, self._frames_step,
                                (z, z, z[..., :1], keys, offsets, scale, self._speaker(syn, k)))
        with self._ratio_lock:
            saved = (self._ratio, self._spec_margin, self._spec_calibrated,
                     list(self._spec_need_hist), self._estimator_cache_path)
            # the exact path, and no snapshot of the warm-up's rows
            self._ratio = self._estimator_cache_path = None
        rows = 1
        try:
            while True:
                self.collect(self.submit([[1, 0] + [tok, 0] * 30 + [2]] * rows, syn=syn))
                if rows >= b_max:
                    break
                rows = min(2 * rows, b_max)
        finally:
            with self._ratio_lock:
                (self._ratio, self._spec_margin, self._spec_calibrated,
                 self._spec_need_hist[:], self._estimator_cache_path) = saved


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
