"""Wire-format codecs for raw audio streaming (a numpy copy of
piper_tpu/runtime/codec.py).

The reference streams raw int16 PCM only (src/cpp/main.cpp:310-400,
src/python_run/piper/__main__.py --output-raw). G.711 mu-law is offered
beside it: 8 bits per sample instead of 16, half the bytes on the wire
at telephony quality, and every audio stack decodes it (RFC 3551 PCMU,
ffmpeg `-f mulaw`, sox `-t ul`).

Bit-exact G.711 (segmented companding, bias 0x84, clip 32635) in
vectorised integer numpy; tests/test_torch_codec.py holds it against
the JAX package's codec on every int16 value and every code.
"""

from __future__ import annotations

import numpy as np

_BIAS = 0x84
# The encoder is the classic Sun/CCITT 14-bit formulation (as in
# CPython's audioop and sox): drop the two LSBs, clip at 8159, bias 33.
_CLIP14 = 8159
_BIAS14 = _BIAS >> 2
_SEG_UEND = np.array(
    [0x3F, 0x7F, 0xFF, 0x1FF, 0x3FF, 0x7FF, 0xFFF, 0x1FFF], np.int32
)

# Decode is a pure 256-entry table.
_DECODE_LUT = np.zeros(256, np.int16)
for _code in range(256):
    _u = ~_code & 0xFF
    _exp = (_u >> 4) & 0x07
    _mant = _u & 0x0F
    _mag = (((_mant << 3) + _BIAS) << _exp) - _BIAS
    _DECODE_LUT[_code] = -_mag if (_u & 0x80) else _mag


def mulaw_encode(pcm: np.ndarray) -> np.ndarray:
    """int16 PCM -> uint8 G.711 mu-law codes (bit-exact with audioop)."""
    x = np.asarray(pcm, np.int32) >> 2
    mask = np.where(x < 0, 0x7F, 0xFF)
    mag = np.minimum(np.abs(x), _CLIP14) + _BIAS14
    seg = np.searchsorted(_SEG_UEND, mag, side="left")
    seg_c = np.minimum(seg, 7)
    uval = (seg_c << 4) | ((mag >> (seg_c + 1)) & 0x0F)
    uval = np.where(seg >= 8, 0x7F, uval)
    return ((uval ^ mask) & 0xFF).astype(np.uint8)


def mulaw_decode(codes: np.ndarray) -> np.ndarray:
    """uint8 G.711 mu-law codes -> int16 PCM."""
    return _DECODE_LUT[np.asarray(codes, np.uint8)]


def encode_float_mulaw(audio: np.ndarray) -> bytes:
    """float [-1, 1] audio -> mu-law bytes (fixed scaling, as the
    streaming paths use it: the global peak is unknown mid-stream)."""
    pcm = (np.clip(audio, -1.0, 1.0) * 32767.0).astype(np.int16)
    return mulaw_encode(pcm).tobytes()


RAW_FORMATS = ("s16le", "mulaw")


def encode_chunk(audio: np.ndarray, fmt: str = "s16le") -> bytes:
    """Encode one float [-1, 1] chunk for the raw wire.

    s16le: little-endian int16 (the reference's format); mulaw: G.711.
    """
    if fmt == "s16le":
        return (np.clip(audio, -1.0, 1.0) * 32767.0).astype("<i2").tobytes()
    if fmt == "mulaw":
        return encode_float_mulaw(audio)
    raise ValueError(f"unknown raw format {fmt!r} (expected one of {RAW_FORMATS})")
