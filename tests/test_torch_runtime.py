"""The port's runtime and package boundary, on the CPU: what it imports,
where it runs, how its noise is keyed, and the CLI's WAVs."""

import ast
import io
import json
import subprocess
import sys
import wave
from pathlib import Path

import numpy as np
import pytest
import torch

from piper_tpu_torch.config import AudioConfig, ModelConfig, SynthesisConfig
from piper_tpu_torch.models.vits import model as M
from piper_tpu_torch.runtime import voice as RV
from piper_tpu_torch.weights.native import save_native

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "piper_tpu_torch"

# The medium preset's generator shape at narrow widths.
CFG = ModelConfig(
    num_symbols=256, inter_channels=32, hidden_channels=32, filter_channels=64,
    n_heads=2, n_layers=2, upsample_initial_channel=64, audio=AudioConfig(sample_rate=22050),
)


@pytest.fixture(scope="module")
def voice_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("voice")
    save_native(str(d / "voice.npz"), M.init_synthesizer_params(0, CFG), CFG)
    (d / "voice.npz.json").write_text(json.dumps(RV.random_voice_config(CFG).to_dict()))
    return d


@pytest.fixture(scope="module")
def cpu_voice(voice_files):
    return RV.TorchVoice.load(voice_files / "voice.npz", device="cpu", precision="parity")


def test_import_pulls_in_no_jax():
    """Every module of the port, and chip_smoke.py, in a fresh process:
    neither jax nor anything of piper_tpu gets imported."""
    mods = sorted(
        "piper_tpu_torch." + ".".join(p.relative_to(PKG).with_suffix("").parts).replace(".__init__", "")
        for p in PKG.rglob("*.py")
    )
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m.rstrip('.'))\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'piper_tpu' or m.startswith('piper_tpu.')]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=300)


def test_sources_import_no_jax():
    """No import statement in the port or chip_smoke.py names jax or
    piper_tpu, however deep inside a function it sits."""
    for path in [*PKG.rglob("*.py"), ROOT / "chip_smoke.py"]:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            for n in names:
                top = n.split(".")[0]
                assert top not in ("jax", "jaxlib", "piper_tpu"), f"{path}: imports {n}"


def test_entry_points_raise_without_cuda(voice_files, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        RV.TorchVoice.load(voice_files / "voice.npz")
    from piper_tpu_torch.__main__ import main

    monkeypatch.setattr(sys, "stdin", io.StringIO("Hello.\n"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["-m", str(voice_files / "voice.npz"), "-f", str(voice_files / "x.wav")])


def test_frame_noise_is_keyed_by_frame():
    key = RV.utterance_seed(7, [1, 0, 5, 0, 2])
    long = RV.frame_noise(key, 150, 8)
    np.testing.assert_array_equal(long[:37].numpy(), RV.frame_noise(key, 37, 8).numpy())
    assert not torch.equal(long, RV.frame_noise(RV.utterance_seed(8, [1, 0, 5, 0, 2]), 150, 8))
    assert not torch.equal(long, RV.frame_noise(RV.utterance_seed(7, [1, 0, 6, 0, 2]), 150, 8))


def test_audio_ignores_batch_composition(cpu_voice):
    rows = [[1, 0] + [40 + (5 * i) % 60 for i in range(n)] + [0, 2] for n in (30, 7, 18)]
    syn = SynthesisConfig(seed=11)
    batch = cpu_voice.synthesize_ids_batch(rows, syn=syn)
    for i, row in enumerate(rows):
        alone = cpu_voice.synthesize_ids_batch([row], syn=syn)[0]
        assert len(alone) == len(batch[i]) > 0
        np.testing.assert_allclose(alone, batch[i], atol=1e-6, rtol=0)  # float32 sums by row


def test_audio_ignores_decoded_frame_count(cpu_voice):
    """A row decoded at its own frame count and at 40 frames more gives
    the same valid samples."""
    cfg, params = cpu_voice.model_cfg, cpu_voice.params
    ids = [1, 0] + [50 + i for i in range(20)] + [0, 2]
    key = RV.utterance_seed(3, ids)
    enc = M.synthesizer_encode(
        params, torch.tensor([ids]), torch.tensor([len(ids)]), cfg=cfg, noise_w_scale=0.8,
        length_scale=1.0, dur_noise=RV.duration_noise(key, len(ids))[None],
    )
    n = int(enc.durations.sum())
    outs = []
    for nf in (n, n + 40):
        z_p, y_mask = M.synthesizer_latents(
            params, enc, nf, cfg=cfg, noise_scale=0.667,
            frame_noise=RV.frame_noise(key, nf, cfg.inter_channels)[None],
        )
        outs.append(M.synthesizer_vocode(params, z_p, y_mask, cfg=cfg)[0, : n * cfg.upsample_factor])
    np.testing.assert_allclose(outs[0].numpy(), outs[1].numpy(), atol=1e-6, rtol=0)


def _wav(path):
    raw = Path(path).read_bytes()
    with wave.open(str(path), "rb") as w:
        return raw, w.getframerate(), np.frombuffer(w.readframes(w.getnframes()), np.int16)


def test_cli_writes_wavs_on_cpu(voice_files, monkeypatch, tmp_path):
    from piper_tpu_torch.__main__ import main

    model = str(voice_files / "voice.npz")
    monkeypatch.setattr(sys, "stdin", io.StringIO("Hello world. A second sentence.\n"))
    main(["-m", model, "-f", str(tmp_path / "one.wav"), "--device", "cpu", "--seed", "1"])
    raw, sr, pcm = _wav(tmp_path / "one.wav")
    assert raw[:4] == b"RIFF" and raw[8:12] == b"WAVE" and sr == 22050
    assert len(pcm) % CFG.upsample_factor == 0 and np.abs(pcm).max() > 0

    lines = "Hello world. A second sentence.\nShort.\nA third line of text.\n"
    for out in ("a", "b"):
        monkeypatch.setattr(sys, "stdin", io.StringIO(lines))
        main(["-m", model, "-d", str(tmp_path / out), "--batch", "--device", "cpu", "--seed", "1", "-q"])
    names = sorted(p.name for p in (tmp_path / "a").glob("*.wav"))
    assert names == ["0000.wav", "0001.wav", "0002.wav"]
    for name in names:
        assert (tmp_path / "a" / name).read_bytes() == (tmp_path / "b" / name).read_bytes()
    # the first line alone (-f) and inside the batch (-d --batch): same samples
    np.testing.assert_array_equal(_wav(tmp_path / "a" / "0000.wav")[2], pcm)


def test_random_voice_speaks_text():
    """TorchVoice.random at the x-low preset's full width: codepoint
    phonemes, so no espeak; int16 PCM of whole frames."""
    voice = RV.TorchVoice.random("x-low", device="cpu", seed=2)
    pcm = voice.synthesize("Hi there.", syn=SynthesisConfig(seed=1, sentence_silence_seconds=0.0))
    assert pcm.dtype == np.int16 and len(pcm) > 0 and len(pcm) % 256 == 0
    assert np.abs(pcm).max() > 0
