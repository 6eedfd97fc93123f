"""WAV IO and int16 conversion.

Counterpart of piper_tpu/runtime/wav.py. The peak normalisation and the
int16 -> float scaling are the numpy versions behind
piper_tpu.native.normalize_to_int16 / int16_to_float, copied here (the
port does not load the JAX package's C++ host library).

Parity: reference audio_float_to_int16
(src/python_run/piper/util.py:5-12) and the RIFF/PCM16 writer
(src/cpp/wavfile.hpp:6-38) — here via the stdlib wave module.
"""

from __future__ import annotations

import io
import wave
from pathlib import Path
from typing import Union

import numpy as np


def normalize_to_int16(
    audio: np.ndarray, max_wav_value: float = 32767.0
) -> np.ndarray:
    """Peak-normalize float32 audio to int16."""
    audio = np.ascontiguousarray(audio, np.float32)
    peak = float(np.max(np.abs(audio))) if audio.size else 0.0
    scaled = audio * (max_wav_value / max(0.01, peak))
    return np.clip(scaled, -max_wav_value, max_wav_value).astype(np.int16)


def int16_to_float(pcm: np.ndarray, scale: float = 1.0 / 32767.0) -> np.ndarray:
    """int16 -> float32 * scale."""
    return np.ascontiguousarray(pcm, np.int16).astype(np.float32) * np.float32(scale)


def audio_float_to_int16(
    audio: np.ndarray, max_wav_value: float = 32767.0
) -> np.ndarray:
    """Peak-normalize float audio to int16 range."""
    return normalize_to_int16(np.asarray(audio, np.float32), max_wav_value)


def write_wav(
    path_or_file: Union[str, Path, io.IOBase],
    audio_int16: np.ndarray,
    sample_rate: int,
) -> None:
    """Write mono PCM16 WAV."""
    if isinstance(path_or_file, (str, Path)):
        f = wave.open(str(path_or_file), "wb")
    else:
        f = wave.open(path_or_file, "wb")
    with f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(sample_rate)
        f.writeframes(np.ascontiguousarray(audio_int16, np.int16).tobytes())


def wav_bytes(audio_int16: np.ndarray, sample_rate: int) -> bytes:
    buf = io.BytesIO()
    write_wav(buf, audio_int16, sample_rate)
    return buf.getvalue()


def read_wav(path: Union[str, Path]) -> tuple:
    """Read a PCM16 WAV -> (sample_rate, np.int16 array)."""
    with wave.open(str(path), "rb") as f:
        sr = f.getframerate()
        n = f.getnframes()
        data = np.frombuffer(f.readframes(n), dtype=np.int16)
        if f.getnchannels() > 1:
            data = data.reshape(-1, f.getnchannels())[:, 0]
    return sr, data
