"""The port's raw-wire codec (piper_tpu_torch/runtime/codec.py) against
the JAX package's (piper_tpu/runtime/codec.py): the same bytes on every
int16 value, every mu-law code and float chunks of the streaming path."""

import numpy as np
import pytest

from piper_tpu.runtime import codec as JC
from piper_tpu_torch.runtime import codec as TC

ALL_INT16 = np.arange(-32768, 32768, dtype=np.int64).astype(np.int16)


def test_mulaw_encode_every_int16_value():
    np.testing.assert_array_equal(TC.mulaw_encode(ALL_INT16), JC.mulaw_encode(ALL_INT16))


def test_mulaw_decode_every_code():
    codes = np.arange(256, dtype=np.uint8)
    np.testing.assert_array_equal(TC.mulaw_decode(codes), JC.mulaw_decode(codes))
    # every code is its own encoding once decoded (0x7F and 0xFF both mean 0)
    again = TC.mulaw_encode(TC.mulaw_decode(codes))
    np.testing.assert_array_equal(again[codes != 0x7F], codes[codes != 0x7F])


@pytest.mark.parametrize("fmt", TC.RAW_FORMATS)
def test_encode_chunk_matches_jax(fmt):
    rng = np.random.default_rng(0)
    audio = np.concatenate([
        rng.uniform(-1.2, 1.2, 4000).astype(np.float32),  # past the clip on both sides
        np.linspace(-1, 1, 513, dtype=np.float32),
        np.zeros(7, np.float32),
    ])
    assert TC.encode_chunk(audio, fmt) == JC.encode_chunk(audio, fmt)


def test_encode_chunk_refuses_unknown_format():
    with pytest.raises(ValueError, match="unknown raw format"):
        TC.encode_chunk(np.zeros(4, np.float32), "flac")
