"""The device mu-law wire and the self-describing packed transfer.

The port's mu-law encoder (runtime/codec.mulaw_encode_torch) against the
JAX package's in-graph encoder (mulaw_encode_jnp) and the numpy one over
the whole int16 domain; pack2's bytes (int16 and mu-law wires) against
TpuVoice's pack2_fn / pack2_mulaw_fn on the same audio and frame counts;
the refusal of a mu-law wire in parity precision; the wire's bytes and
header against the exact path; and the CLI's --wire-format.
"""

from __future__ import annotations

import io
import json
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from piper_tpu.config import InferenceDefaults, VoiceConfig
from piper_tpu.runtime import codec as JC
from piper_tpu.runtime.voice import TpuVoice
from piper_tpu_torch.config import SynthesisConfig
from piper_tpu_torch.runtime import codec as C
from piper_tpu_torch.runtime import voice as RV
from piper_tpu_torch.runtime.wav import int16_to_float
from piper_tpu_torch.weights.native import save_native
from torch_parity import TINY, jax_params, perturb_flow_post, tcfg

ALL_INT16 = np.arange(-32768, 32768, dtype=np.int16)


def test_mulaw_encoder_matches_numpy_and_jax_over_int16():
    """Every int16 value gives the same G.711 code from the torch encoder,
    the port's numpy encoder and the JAX package's in-graph encoder."""
    got = C.mulaw_encode_torch(torch.from_numpy(ALL_INT16)).numpy()
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, C.mulaw_encode(ALL_INT16))
    np.testing.assert_array_equal(got, np.asarray(JC.mulaw_encode_jnp(jnp.asarray(ALL_INT16))))


@pytest.fixture(scope="module")
def jax_fast_voice():
    id_map = {chr(32 + i): [i] for i in range(TINY.num_symbols)}
    vconfig = VoiceConfig(num_symbols=TINY.num_symbols, num_speakers=1,
                          sample_rate=TINY.audio.sample_rate, espeak_voice="en-us",
                          inference=InferenceDefaults(), phoneme_id_map=id_map)
    return TpuVoice(jax_params(TINY, 3), TINY, vconfig, precision="fast", seed=0)


@pytest.mark.parametrize("wire", ["int16", "mulaw"])
def test_pack2_bytes_equal_jax(jax_fast_voice, wire):
    """pack2 on two decode groups of different widths, with a row that
    overflows its decode (frames * u past its width), an empty row, and
    a total that cuts the last rows off: the same bytes as the JAX
    package's speculative pack, header, body and padding."""
    u = TINY.upsample_factor
    rng = np.random.default_rng(5)
    audio = [rng.integers(-32768, 32768, (3, 40 * u)).astype(np.int16),
             rng.integers(-32768, 32768, (4, 24 * u)).astype(np.int16)]
    ylens = [np.array([17, 0, 55], np.int32), np.array([24, 3, 30, 11], np.int32)]
    mulaw = wire == "mulaw"
    a0 = -(-(4 if mulaw else 2) * 7 // 128) * 128
    valid = sum(min(int(y) * u, a.shape[1]) for a, ys in zip(audio, ylens) for y in ys)
    for total in (a0 + valid + 1000, a0 + valid - 30 * u):
        pack = jax_fast_voice._pack2_mulaw if mulaw else jax_fast_voice._pack2
        ref = np.asarray(pack(tuple(jnp.asarray(a) for a in audio), tuple(jnp.asarray(y) for y in ylens),
                              a0, total))
        got = RV.pack2([torch.from_numpy(a) for a in audio], [torch.from_numpy(y) for y in ylens],
                       a0, total, u, mulaw).numpy()
        assert got.dtype == ref.dtype and got.shape == ref.shape
        np.testing.assert_array_equal(got, ref)
        np.testing.assert_array_equal(RV.read_header(got, 7), np.concatenate(ylens))


def _tiny_voice(precision="fast", tree=None, **kw):
    cfg = tcfg(TINY)
    tree = tree if tree is not None else perturb_flow_post(jax_params(TINY, 3))
    return RV.TorchVoice(tree, cfg, RV.random_voice_config(cfg), precision=precision,
                         device="cpu", seed=0, **kw)


def test_mulaw_wire_refused_in_parity():
    """A mu-law wire needs the int16 device path (TpuVoice, voice.py:228-235
    and :961): refused at construction and by set_wire_format in parity
    precision; an unknown wire is refused in either."""
    with pytest.raises(ValueError, match="precision='fast'"):
        _tiny_voice("parity", wire_format="mulaw")
    voice = _tiny_voice("parity")
    with pytest.raises(ValueError, match="precision='fast'"):
        voice.set_wire_format("mulaw")
    with pytest.raises(ValueError, match="wire_format"):
        _tiny_voice("fast", wire_format="alaw")
    fast = _tiny_voice("fast")
    fast.set_wire_format("mulaw")
    assert fast.wire_format == "mulaw"


def _rows(n_rows=5, seed=7):
    rng = np.random.default_rng(seed)
    return [[1, 0] + [int(x) for s in rng.integers(3, TINY.num_symbols, n) for x in (s, 0)] + [2]
            for n in rng.integers(4, 40, n_rows)]


def test_mulaw_wire_bytes_and_header_equal_the_exact_path():
    """On a mu-law wire the exact path's transfer is the numpy encoder's
    bytes of the int16 path's samples, and the speculative path's
    transfer carries the exact frame counts in its header and those same
    bytes for every row; collect() decodes both to the same audio."""
    rows, seeds = _rows(), list(range(5))
    int16 = _tiny_voice()
    ref = [int16.synthesize_ids_batch([r], syn=SynthesisConfig(seed=s))[0] for r, s in zip(rows, seeds)]
    ref16 = [np.round(a * 32767).astype(np.int16) for a in ref]
    voice = _tiny_voice(wire_format="mulaw")
    first = voice.submit(rows, row_seeds=seeds)
    exact = voice.collect(first)
    assert voice.path_counts["exact"] == 1 and first["host"].dtype == torch.uint8
    host = first["host"].numpy()
    for (idx, start, n), want in zip(sorted(first["rows"]), ref16):
        np.testing.assert_array_equal(host[start : start + n], C.mulaw_encode(want))
    handle = voice.submit(rows, row_seeds=seeds)
    assert "spec" in handle
    flat = handle["host"].numpy().copy()
    spec = voice.collect(handle)
    assert voice.path_counts["speculative"] == 1
    u = TINY.upsample_factor
    by_row = {r[0]: r for r in handle["spec"]["rows"]}
    frames = RV.read_header(flat, len(rows))
    out = handle["spec"]["a0"]
    for i, r in enumerate(handle["spec"]["rows"]):
        n = len(ref16[r[0]])
        assert frames[i] * u == n
        if out + n <= handle["spec"]["total"]:  # rows past the margin are re-fetched
            np.testing.assert_array_equal(flat[out : out + n], C.mulaw_encode(ref16[r[0]]))
        out += n
    assert set(by_row) == set(range(len(rows)))
    for a, b, want in zip(exact, spec, ref16):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, int16_to_float(C.mulaw_decode(C.mulaw_encode(want))))


def test_cli_wire_format(tmp_path, monkeypatch):
    """python -m piper_tpu_torch --wire-format mulaw (with --output-raw
    --raw-format mulaw) speaks the same number of bytes as the int16
    wire, close to them, and the flag reaches the voice; --wire-format
    mulaw with --precision parity is refused."""
    from piper_tpu_torch import __main__ as cli

    cfg = tcfg(TINY)
    tree = jax_params(TINY, 3)
    save_native(str(tmp_path / "voice.npz"), tree, cfg)
    json.dump(RV.random_voice_config(cfg).to_dict(), open(tmp_path / "voice.npz.json", "w"))
    monkeypatch.setenv("PIPER_TPU_CACHE", str(tmp_path / "cache"))
    wires = []
    load = RV.TorchVoice.load

    def spy(*a, **k):
        voice = load(*a, **k)
        wires.append(voice.wire_format)
        return voice

    monkeypatch.setattr(RV.TorchVoice, "load", spy)
    outs = {}
    for wire in ("int16", "mulaw"):
        buf = io.BytesIO()
        monkeypatch.setattr(sys, "stdin", io.StringIO("Hello wire.\nSecond line here.\n"))
        monkeypatch.setattr(sys, "stdout", type("O", (), {"buffer": buf})())
        cli.main(["-m", str(tmp_path / "voice.npz"), "--output-raw", "--raw-format", "mulaw",
                  "--wire-format", wire, "--seed", "1", "--device", "cpu", "-q"])
        outs[wire] = np.frombuffer(buf.getvalue(), np.uint8)
    assert wires == ["int16", "mulaw"]
    assert len(outs["mulaw"]) == len(outs["int16"]) > 0
    a, b = (C.mulaw_decode(outs[w]).astype(np.float64) for w in ("int16", "mulaw"))
    assert np.abs(a - b).mean() < 0.02 * np.abs(a).max()
    monkeypatch.setattr(sys, "stdin", io.StringIO("x\n"))
    with pytest.raises(ValueError, match="precision='fast'"):
        cli.main(["-m", str(tmp_path / "voice.npz"), "--output-raw", "--wire-format", "mulaw",
                  "--precision", "parity", "--device", "cpu", "-q"])
