"""The port's JSONL harness, denoiser and voice conversion against the JAX
package's, on the CPU: python -m piper_tpu_torch.infer --device cpu
--seed 1 --batch against python -m piper_tpu.infer on one tiny voice,
with and without --denoiser-strength 0.005 (audio within 1e-4, the port's
e2e tolerance; the JAX package's denoiser bias is drawn with the same
seed, which the port's --seed sets and the JAX package's leaves unset);
the Denoiser on the same audio; voice_convert_audio on a tiny
two-speaker training tree with and without noise (JAX's key, drawn by
the port's ops/prng) and on the trained two-speaker x-low voice
(tests/data/voice_xlow_ms2_trained_fp16.npz, 0.5 s, speaker 0 -> 1),
within 1e-4; python -m piper_tpu_torch.tools.voice_conversion against
the JAX package's CLI; and the refusals: one speaker, no posterior, and
(the port only) an MB-iSTFT voice.
"""

import dataclasses
import io
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from piper_tpu import infer as j_infer
from piper_tpu.config import SynthesisConfig as JSynthesisConfig
from piper_tpu.runtime import denoise as JD
from piper_tpu.runtime import voice_conversion as JVC
from piper_tpu.runtime import wav as j_wav
from piper_tpu_torch import infer as t_infer
from piper_tpu_torch.ops import prng
from piper_tpu_torch.runtime import denoise as TD
from piper_tpu_torch.runtime import voice_conversion as TVC
from piper_tpu_torch.runtime import wav as t_wav
from piper_tpu_torch.runtime.voice import random_voice_config
from piper_tpu_torch.train.dataset import voiced_burst
from piper_tpu_torch.weights.native import load_native, save_native
from torch_parity import TINY, TINY_MB, TINY_MS, port_params, tcfg

DATA = Path(__file__).parent / "data"
ATOL = 1e-4


def _recording(monkeypatch, module, name="audio_float_to_int16"):
    """Record the float audio each WAV is written from."""
    seen = []
    inner = getattr(module, name)

    def spy(audio, *a, **k):
        seen.append(np.asarray(audio, np.float32).copy())
        return inner(audio, *a, **k)

    monkeypatch.setattr(module, name, spy)
    return seen


def _tree(jcfg, seed, training=False):
    """One numpy tree in the JAX package's layouts for both packages (the
    port's initialisers: the JAX package's distributions, no JAX compile)."""
    from piper_tpu_torch.models.vits.model import init_synthesizer_params

    return init_synthesizer_params(seed, tcfg(jcfg), training=training)


@pytest.fixture(scope="module")
def voice(tmp_path_factory):
    d = tmp_path_factory.mktemp("voice")
    tree = _tree(TINY, 50)
    cfg = tcfg(TINY)
    save_native(str(d / "voice.npz"), tree, cfg)
    (d / "voice.npz.json").write_text(json.dumps(random_voice_config(cfg).to_dict()))
    return d / "voice.npz"


def _jsonl():
    rng = np.random.default_rng(51)
    return "".join(
        json.dumps({"phoneme_ids": [1, 0] + [int(x) for s in rng.integers(3, 64, n)
                                             for x in (s, 0)] + [2]}) + "\n"
        for n in (6, 14, 22))


@pytest.mark.parametrize("strength", ["0", "0.005"])
def test_infer_cli_equals_jax(voice, tmp_path, monkeypatch, strength):
    argv = ["-m", str(voice), "--precision", "parity", "--batch", "--seed", "1",
            "--denoiser-strength", strength]
    # the JAX package's denoiser bias with the same seed as the port's
    for_voice = JD.Denoiser.for_voice.__func__

    class Seeded:
        def __init__(self, v):
            self.v = v

        def synthesize_ids_batch(self, ids_list, syn=None):
            return self.v.synthesize_ids_batch(ids_list, syn=JSynthesisConfig(seed=1))

    monkeypatch.setattr(JD.Denoiser, "for_voice", classmethod(
        lambda cls, v, n_blank_ids=300: for_voice(cls, Seeded(v), n_blank_ids)))
    got_audio = _recording(monkeypatch, t_infer)
    ref_audio = _recording(monkeypatch, j_infer)
    for name, main, extra in (("port", t_infer.main, ["--device", "cpu"]),
                              ("jax", j_infer.main, [])):
        monkeypatch.setattr(sys, "stdin", io.StringIO(_jsonl()))
        main(argv + extra + ["-o", str(tmp_path / name)])
    assert len(got_audio) == len(ref_audio) == 3
    for i, (g, r) in enumerate(zip(got_audio, ref_audio)):
        assert g.shape == r.shape and g.size > 0
        np.testing.assert_allclose(g, r, atol=ATOL, rtol=0, err_msg=f"utterance {i}")
        sr, pcm = t_wav.read_wav(tmp_path / "port" / f"{i}.wav")
        assert sr == 16000 and len(pcm) == len(g)


def test_denoiser_equals_jax():
    rng = np.random.default_rng(52)
    bias = np.abs(rng.standard_normal((7, TD.FFT_SIZE // 2 + 1))).astype(np.float32)
    t = np.arange(9000) / 16000
    audio = (0.4 * np.sin(2 * np.pi * 220 * t) + 0.02 * rng.standard_normal(t.shape)).astype(np.float32)
    got = TD.Denoiser(bias)(audio, 0.005)
    ref = JD.Denoiser(bias)(audio, 0.005)
    np.testing.assert_array_equal(got, ref)
    assert not np.array_equal(got, audio)
    short = audio[: TD.FFT_SIZE]
    np.testing.assert_array_equal(TD.Denoiser(bias)(short, 1.0), short)

    calls = []

    class Stub:
        def synthesize_ids_batch(self, ids_list, syn=None):
            calls.append((ids_list, syn))
            return [(0.01 * np.random.default_rng(3).standard_normal(6000)).astype(np.float32)]

    assert TD.maybe_denoiser(Stub(), 0.0) is None and not calls
    den = TD.maybe_denoiser(Stub(), 0.005, syn="seeded")
    np.testing.assert_array_equal(den.bias_profile, JD.maybe_denoiser(Stub(), 0.005).bias_profile)
    assert calls == [([[0] * 300], "seeded"), ([[0] * 300], None)]


def _convert(tree, jcfg, audio, src, tgt, seed):
    """Both packages' voice_convert_audio; seed None means no noise."""
    ref = JVC.voice_convert_audio(tree, audio, src, tgt, cfg=jcfg,
                                  rng=None if seed is None else jax.random.PRNGKey(seed))
    got = TVC.voice_convert_audio(port_params(tree, jcfg), audio, src, tgt, cfg=tcfg(jcfg),
                                  key=None if seed is None else prng.prng_key(seed))
    return got, np.asarray(ref)


@pytest.fixture(scope="module")
def train_tree():
    return _tree(TINY_MS, 53, training=True)


@pytest.mark.parametrize("seed", [None, 7])
def test_voice_conversion_equals_jax(train_tree, seed):
    audio = np.concatenate([np.zeros(1600, np.float32), voiced_burst(0.4, 16000, 150.0)])
    got, ref = _convert(train_tree, TINY_MS, audio, 0, 2, seed)
    assert got.shape == ref.shape and got.size > 0
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)
    same, _ = _convert(train_tree, TINY_MS, audio, 0, 0, seed)
    assert not np.allclose(got, same)  # the target speaker matters


def test_voice_conversion_of_the_trained_two_speaker_voice_equals_jax():
    """The trained x-low voice (full width: 96 hidden, the 256-channel
    8-8-4 generator), 0.5 s of speaker 0's synthesis, speaker 0 -> 1."""
    from piper_tpu_torch.config import SynthesisConfig
    from piper_tpu_torch.runtime.voice import TorchVoice

    tree, cfg = load_native(str(DATA / "voice_xlow_ms2_trained_fp16.npz"))
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32), tree)
    assert "enc_q" in tree
    voice = TorchVoice(tree, cfg, random_voice_config(cfg), precision="parity", device="cpu")
    speech = voice.synthesize_ids_batch([[1, 0] + [20 + (7 * i) % 30 for i in range(20)] + [0, 2]],
                                        syn=SynthesisConfig(seed=3, speaker_id=0))[0]
    speech = speech[: 8000]
    frames = 1 + (len(speech) + 768 - 1024) // 256  # reflect-padded STFT, hop 256
    from piper_tpu.config import AudioConfig as JAudio, ModelConfig as JModel

    d = dataclasses.asdict(cfg)
    jcfg = JModel(**{**d, "audio": JAudio(**d["audio"])})
    got, ref = _convert(tree, jcfg, speech, 0, 1, 11)
    assert got.shape == ref.shape == (frames * 256,) and frames >= 25
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)


def test_voice_conversion_cli_equals_jax(train_tree, tmp_path, monkeypatch):
    """Two WAVs (16 kHz, and 22,050 Hz resampled), seed 4: file i's noise
    from PRNGKey(4 + i) in both packages' CLIs."""
    from piper_tpu.tools import voice_conversion as JT
    from piper_tpu_torch.tools import voice_conversion as TT

    model = tmp_path / "voice.npz"
    save_native(str(model), train_tree, tcfg(TINY_MS))
    wavs = []
    for i, sr in enumerate((16000, 22050)):
        path = tmp_path / f"in{i}.wav"
        t_wav.write_wav(path, t_wav.audio_float_to_int16(voiced_burst(0.4, sr, 130.0 + 40 * i)), sr)
        wavs.append(str(path))
    got = _recording(monkeypatch, t_wav)
    ref = _recording(monkeypatch, j_wav)
    args = ["--model", str(model), "--source-speaker", "1", "--target-speaker", "2", "--seed", "4"]
    TT.main(args + ["--device", "cpu", "--output-dir", str(tmp_path / "port"), *wavs])
    JT.main(args + ["--output-dir", str(tmp_path / "jax"), *wavs])
    assert len(got) == len(ref) == 2
    for g, r in zip(got, ref):
        assert g.shape == r.shape and g.size > 0
        np.testing.assert_allclose(g, r, atol=ATOL, rtol=0)
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == ["in0.wav", "in1.wav"]


def test_voice_conversion_refusals(train_tree):
    """JAX's two refusals (same messages), and an MB-iSTFT voice, which
    the port refuses rather than send into the HiFiGAN generator."""
    audio = voiced_burst(0.3, 16000, 150.0)
    single = _tree(TINY, 54, training=True)
    no_posterior = {k: v for k, v in train_tree.items() if k != "enc_q"}
    for tree, jcfg in ((single, TINY), (no_posterior, TINY_MS)):
        with pytest.raises(ValueError) as ref:
            JVC.voice_convert_audio(tree, audio, 0, 1, cfg=jcfg)
        with pytest.raises(ValueError) as got:
            TVC.voice_convert_audio(port_params(tree, jcfg), audio, 0, 1, cfg=tcfg(jcfg))
        assert str(got.value) == str(ref.value)
    mb_cfg = dataclasses.replace(TINY_MB, num_speakers=3, gin_channels=16)
    mb = _tree(mb_cfg, 55, training=True)
    with pytest.raises(ValueError, match="HiFiGAN"):
        TVC.voice_convert_audio(port_params(mb, mb_cfg), audio, 0, 1, cfg=tcfg(mb_cfg))
    with pytest.raises(ValueError, match="out of range"):
        TVC.voice_convert_audio(port_params(train_tree, TINY_MS), audio, 0, 3, cfg=tcfg(TINY_MS))
