"""Audio normalization + caching for training data.

Counterpart of piper_tpu/train/norm_audio.py, the same numpy code, run
on the host. Parity with the reference norm_audio package
(src/python/piper_train/norm_audio/__init__.py:21-92, trim.py:8-54,
vad.py:14-54): load -> resample -> VAD silence trim -> cache normalized
audio and its spectrogram, keyed by content hash.

Departures from the reference (the JAX package's too):
- caches are .npy (numpy) instead of torch .pt;
- the bundled Silero VAD model (train/models/silero_vad.onnx, the port's
  own copy of the third-party model the reference vendors) runs through
  the port's numpy ONNX interpreter (onnx_io/interp.py), so trims match
  the reference without needing onnxruntime; an energy VAD remains as
  an explicit opt-in fallback (`vad="energy"`). PIPER_TPU_SILERO_VAD
  (the JAX package's variable) names another model file.
- resampling uses polyphase filtering (scipy) instead of librosa.
"""

from __future__ import annotations

import hashlib
import os
import wave
from pathlib import Path
from typing import Optional, Tuple, Union

import numpy as np

from ..config import AudioConfig

CHUNK_SAMPLES = 480  # reference trim.py chunking @16k
KEEP_CHUNKS_BEFORE = 2
KEEP_CHUNKS_AFTER = 2
VAD_SAMPLE_RATE = 16000
VAD_THRESHOLD = 0.2  # reference trim.py:11
_SILERO_PATH = Path(__file__).parent / "models" / "silero_vad.onnx"


class SileroVAD:
    """Silero voice-activity detector executed by onnx_io.interp
    (reference: norm_audio/vad.py:14-54, which uses onnxruntime).

    Stateful across chunks: the LSTM h/c states carry between calls,
    exactly like the reference's session-held `self._h/_c`.
    """

    def __init__(self, model_path: Optional[Union[str, Path]] = None):
        from ..onnx_io.interp import OnnxModel

        path = Path(
            model_path
            or os.environ.get("PIPER_TPU_SILERO_VAD", _SILERO_PATH)
        )
        self.model = OnnxModel(str(path))
        self.reset()

    def reset(self) -> None:
        self._h = np.zeros((2, 1, 64), np.float32)
        self._c = np.zeros((2, 1, 64), np.float32)

    def __call__(self, chunk: np.ndarray, sample_rate: int = 16000) -> float:
        """Probability of speech in a 16 kHz float chunk [0-1]."""
        if sample_rate != VAD_SAMPLE_RATE:
            raise ValueError("only 16 kHz audio is supported")
        from ..onnx_io.interp import run

        if chunk.ndim == 1:
            chunk = chunk[None, :]
        out, self._h, self._c = run(
            self.model,
            {"input": chunk.astype(np.float32),
             "h0": self._h, "c0": self._c},
        )
        # out (1, 2, 1): [:, 1] is the speech-class probability
        # (reference vad.py:51).
        return float(out.squeeze(2)[0, 1])


def make_silence_detector(
    model_path: Optional[Union[str, Path]] = None,
) -> SileroVAD:
    """Counterpart of reference norm_audio/__init__.py:16-18."""
    return SileroVAD(model_path)


def load_audio(path: Union[str, Path], target_sr: int) -> np.ndarray:
    """Load a WAV (PCM) file as float32 mono at target_sr."""
    with wave.open(str(path), "rb") as f:
        sr = f.getframerate()
        n = f.getnframes()
        width = f.getsampwidth()
        channels = f.getnchannels()
        raw = f.readframes(n)
    if width == 2:
        data = np.frombuffer(raw, np.int16).astype(np.float32) / 32768.0
    elif width == 4:
        data = np.frombuffer(raw, np.int32).astype(np.float32) / 2147483648.0
    elif width == 1:
        data = (np.frombuffer(raw, np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise ValueError(f"unsupported sample width {width}")
    if channels > 1:
        data = data.reshape(-1, channels).mean(axis=1)
    return resample(data, sr, target_sr)


def resample(audio: np.ndarray, sr: int, target_sr: int) -> np.ndarray:
    if sr == target_sr:
        return audio.astype(np.float32)
    from scipy.signal import resample_poly
    from math import gcd

    g = gcd(sr, target_sr)
    return resample_poly(audio, target_sr // g, sr // g).astype(np.float32)


def trim_silence_vad(
    audio_16k: np.ndarray,
    detector: SileroVAD,
    *,
    threshold: float = VAD_THRESHOLD,
    samples_per_chunk: int = CHUNK_SAMPLES,
    keep_chunks_before: int = KEEP_CHUNKS_BEFORE,
    keep_chunks_after: int = KEEP_CHUNKS_AFTER,
) -> Tuple[float, Optional[float]]:
    """(offset_sec, duration_sec) of the speech block, with the exact
    chunking/keep-window behavior of the reference trim
    (norm_audio/trim.py:8-54), including its two edge quirks: the final
    partial chunk is never scored, and a single speech chunk (no second
    hit to set the block end) leaves the audio untrimmed.

    The detector is stateful across chunks and across calls (the
    reference holds one ORT session per preprocessing worker and never
    resets h/c between utterances)."""
    seconds_per_chunk = samples_per_chunk / VAD_SAMPLE_RATE
    first_chunk: Optional[int] = None
    last_chunk: Optional[int] = None
    n_full = len(audio_16k) // samples_per_chunk
    rem = len(audio_16k) - n_full * samples_per_chunk
    # chunk i is scored iff audio remains after it was taken
    n_scored = n_full if rem > 0 else n_full - 1
    for idx in range(max(n_scored, 0)):
        chunk = audio_16k[idx * samples_per_chunk:(idx + 1) * samples_per_chunk]
        if detector(chunk) >= threshold:
            if first_chunk is None:
                first_chunk = idx
            else:
                last_chunk = idx
    if first_chunk is None or last_chunk is None:
        return 0.0, None
    first_chunk = max(0, first_chunk - keep_chunks_before)
    last_chunk = min(n_scored, last_chunk + keep_chunks_after)
    offset_sec = first_chunk * seconds_per_chunk
    return offset_sec, (last_chunk + 1) * seconds_per_chunk - offset_sec


def energy_vad(chunk: np.ndarray, threshold: float) -> bool:
    """Speech decision for one chunk: RMS energy over threshold."""
    return float(np.sqrt(np.mean(np.square(chunk)))) >= threshold


def trim_silence(
    audio_16k: np.ndarray,
    *,
    threshold: Optional[float] = None,
    chunk_samples: int = CHUNK_SAMPLES,
    keep_chunks_before: int = KEEP_CHUNKS_BEFORE,
    keep_chunks_after: int = KEEP_CHUNKS_AFTER,
) -> Tuple[int, int]:
    """Find (start, end) sample offsets of speech in 16 kHz audio.

    Chunked scan keeping `keep_chunks_before/after` context chunks
    (reference trim.py:8-54 policy). Returns offsets in 16k samples.
    """
    n_chunks = len(audio_16k) // chunk_samples
    if n_chunks == 0:
        return 0, len(audio_16k)
    rms = np.sqrt(
        np.mean(
            np.square(
                audio_16k[: n_chunks * chunk_samples].reshape(
                    n_chunks, chunk_samples
                )
            ),
            axis=1,
        )
    )
    if threshold is None:
        peak = rms.max()
        threshold = max(peak * 0.1, 1e-4)
    speech = rms >= threshold
    idx = np.nonzero(speech)[0]
    if idx.size == 0:
        return 0, len(audio_16k)
    first = max(0, int(idx[0]) - keep_chunks_before)
    last = min(n_chunks, int(idx[-1]) + 1 + keep_chunks_after)
    return first * chunk_samples, last * chunk_samples


_PROCESS_DETECTOR: Optional[SileroVAD] = None


def _default_detector() -> Optional[SileroVAD]:
    """One stateful detector per process (the reference builds one ORT
    session per preprocessing worker, preprocess.py:209-219)."""
    global _PROCESS_DETECTOR
    if _PROCESS_DETECTOR is None and _SILERO_PATH.exists():
        _PROCESS_DETECTOR = SileroVAD()
    return _PROCESS_DETECTOR


def cache_norm_audio(
    audio_path: Union[str, Path],
    cache_dir: Union[str, Path],
    audio_cfg: AudioConfig,
    *,
    do_trim: bool = True,
    vad: str = "silero",
    detector: Optional[SileroVAD] = None,
) -> Tuple[Path, Path]:
    """Normalize audio_path and cache (audio.npy, spec.npy).

    Cache keys are sha256 of the absolute path (reference
    norm_audio/__init__.py:33-38 uses the same scheme with .pt files).
    vad: "silero" (default; reference-identical trims via the bundled
    model under onnx_io.interp) or "energy" (model-free fallback).
    Returns (audio_norm_path, audio_spec_path).
    """
    audio_path = Path(audio_path)
    cache_dir = Path(cache_dir)
    cache_dir.mkdir(parents=True, exist_ok=True)
    key = hashlib.sha256(str(audio_path.absolute()).encode()).hexdigest()
    norm_path = cache_dir / f"{key}.audio.npy"
    spec_path = cache_dir / f"{key}.spec.npy"
    if norm_path.exists() and spec_path.exists():
        return norm_path, spec_path

    if do_trim:
        audio_16k = load_audio(audio_path, VAD_SAMPLE_RATE)
        if vad == "silero":
            det = detector or _default_detector()
        else:
            det = None
        if det is not None:
            offset_sec, duration_sec = trim_silence_vad(audio_16k, det)
            start = int(offset_sec * audio_cfg.sample_rate)
            end = (
                start + int(duration_sec * audio_cfg.sample_rate)
                if duration_sec is not None
                else None
            )
        else:
            start16, end16 = trim_silence(audio_16k)
            scale = audio_cfg.sample_rate / VAD_SAMPLE_RATE
            start = int(start16 * scale)
            end = int(end16 * scale)
    else:
        start, end = 0, None

    audio = load_audio(audio_path, audio_cfg.sample_rate)
    audio = audio[start : end if end else len(audio)]
    # peak normalize to [-1, 1] like the reference cache
    peak = np.abs(audio).max()
    if peak > 0:
        audio = audio * (0.95 / max(peak, 0.95))
    np.save(norm_path, audio.astype(np.float32))

    spec = spectrogram_np(
        audio,
        n_fft=audio_cfg.filter_length,
        hop_length=audio_cfg.hop_length,
        win_length=audio_cfg.win_length,
    )
    np.save(spec_path, spec.astype(np.float32))
    return norm_path, spec_path


def spectrogram_np(
    audio: np.ndarray, *, n_fft: int, hop_length: int, win_length: int
) -> np.ndarray:
    """Numpy twin of ops/stft.spectrogram for the host-side cache (the
    JAX package's, bit for bit: same math, reflect pad, periodic hann,
    rfft magnitude with the reference's 1e-6 floor). Preprocessing runs
    on the host in worker processes and sees a new length per
    utterance.
    Returns (n_frames, n_fft//2+1).
    """
    from ..ops.stft import hann_window

    pad = (n_fft - hop_length) // 2
    y = np.pad(audio.astype(np.float32), (pad, pad), mode="reflect")
    n_frames = 1 + (len(y) - n_fft) // hop_length
    idx = (
        np.arange(n_fft)[None, :]
        + hop_length * np.arange(n_frames)[:, None]
    )
    frames = y[idx]
    win = hann_window(win_length)
    if win_length < n_fft:
        lpad = (n_fft - win_length) // 2
        win = np.pad(win, (lpad, n_fft - win_length - lpad))
    spec = np.fft.rfft(frames * win[None, :], n=n_fft, axis=-1)
    return np.sqrt(
        np.square(spec.real) + np.square(spec.imag) + 1e-6
    ).astype(np.float32)
