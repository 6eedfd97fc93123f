"""The port's benchmark CLI (piper_tpu_torch/benchmark.py) on the CPU,
checked as tests/test_harness_clis.py checks the JAX one, and the
fixed-window streamer against the streamer it replaced (every chunk
decoded at its own length, all frames valid).

Bounds: in parity every valid sample within 1e-5 of the old
streamer's (the two differ only in the masked frames past a chunk's
end, which a correct mask never lets into a valid sample); in fast
(bfloat16) the seams' p99 < 5e-3 and mean < 1e-3, the JAX package's own
streaming bounds (tests/test_streaming.py).
"""

import io
import json

import numpy as np
import pytest
import torch

from piper_tpu_torch.config import AudioConfig, ModelConfig
from piper_tpu_torch.models.vits import model as M
from piper_tpu_torch.runtime import streaming as S
from piper_tpu_torch.runtime import voice as RV
from piper_tpu_torch.weights.native import save_native

CFG = ModelConfig(
    num_symbols=256, inter_channels=32, hidden_channels=32, filter_channels=64,
    n_heads=2, n_layers=2, upsample_initial_channel=64, audio=AudioConfig(sample_rate=16000),
)


@pytest.fixture(scope="module")
def params():
    return M.init_synthesizer_params(0, CFG)


def jsonl_input() -> str:
    rng = np.random.default_rng(0)
    lines = []
    for i in range(3):
        ids = [1] + [int(x) for x in rng.integers(32, 120, 20 + 5 * i)] + [2]
        lines.append(json.dumps({"phoneme_ids": ids}))
    return "\n".join(lines) + "\n"


def test_benchmark_cli(params, tmp_path, monkeypatch, capsys):
    from piper_tpu_torch.benchmark import main

    save_native(str(tmp_path / "voice.npz"), params, CFG)
    (tmp_path / "voice.npz.json").write_text(json.dumps(RV.random_voice_config(CFG).to_dict()))
    monkeypatch.setattr("sys.stdin", io.StringIO(jsonl_input()))
    main(["-m", str(tmp_path / "voice.npz"), "--precision", "parity", "--batch",
          "--device", "cpu"])
    out = capsys.readouterr().out.strip().splitlines()[-1]
    report = json.loads(out)
    assert set(report) == {"load_sec", "rtf_mean", "rtf_stdev", "rtfs", "batch"}
    assert report["load_sec"] > 0
    assert 0 < report["rtf_mean"]
    assert len(report["rtfs"]) == 3
    assert report["batch"]["utterances"] == 3
    assert set(report["batch"]) == {"utterances", "audio_seconds", "wall_s",
                                    "audio_seconds_per_s_per_chip", "rtf"}
    assert report["batch"]["audio_seconds_per_s_per_chip"] > 0


def _all_valid_stream(voice, z_p, n_frames, chunk=45, pad=10):
    """The streamer this one replaced: each chunk at its own length,
    under an all-ones mask."""
    u = voice.model_cfg.upsample_factor
    window = chunk + 2 * pad
    with torch.inference_mode():
        def vocode(seg):
            mask = torch.ones((1, seg.shape[1], 1), dtype=seg.dtype)
            return M.synthesizer_vocode(voice.params, seg, mask, cfg=voice.model_cfg)[0].float().numpy()

        if n_frames <= window:
            return [vocode(z_p[:, :n_frames])[: n_frames * u]]
        out = []
        for start in range(0, n_frames, chunk):
            end = min(start + chunk, n_frames)
            pad_l, pad_r = min(pad, start), min(pad, n_frames - end)
            audio = vocode(z_p[:, start - pad_l : end + pad_r])
            out.append(audio[pad_l * u : (pad_l + end - start) * u])
        return out


@pytest.mark.parametrize("precision", ["parity", "fast"])
@pytest.mark.parametrize("n_frames", [3 * 45 + 1, 50, 200])
def test_fixed_window_stream_matches_all_valid_stream(params, precision, n_frames):
    """Every chunk of the fixed-window streamer (one shape, a length
    mask) against the same chunk decoded at its own length: the same
    chunk boundaries; in parity within 1e-5 (a mask off by one frame
    at a chunk's end moves the samples near it by far more), in fast
    within the seam bounds."""
    voice = RV.TorchVoice(params, CFG, RV.random_voice_config(CFG), precision=precision,
                          device="cpu", seed=0)
    g = torch.Generator().manual_seed(n_frames)
    z_p = torch.randn((1, n_frames, CFG.inter_channels), generator=g).to(voice.dtype)
    got = list(S.StreamingDecoder(voice).stream(z_p, n_frames))
    ref = _all_valid_stream(voice, z_p, n_frames)
    assert [len(c) for c in got] == [len(c) for c in ref]
    err = np.abs(np.concatenate(got) - np.concatenate(ref))
    if precision == "parity":
        assert err.max() < 1e-5, err.max()
    else:
        assert np.percentile(err, 99) < 5e-3 and err.mean() < 1e-3, (np.percentile(err, 99), err.mean())
