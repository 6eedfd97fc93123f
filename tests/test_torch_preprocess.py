"""The port's preprocessing against the JAX package's, on the CPU: the
bundled Silero VAD through the port's ONNX interpreter (tests/test_vad.py's
golden probability, and every probability bit-equal to the JAX
package's), trim_silence_vad with its two edge quirks and trim_silence,
spectrogram_np, the whole dataset directory (python -m
piper_tpu_torch.train.preprocess against piper_tpu.train.preprocess on
one LJSpeech-format corpus, one worker and two: config.json equal apart
from piper_version, dataset.jsonl record by record with paths relative
to each output directory, every .npy bit for bit), the port's trainer
taking a step on that directory, and the dataset tools' outputs.
"""

import io
import json
import sys
from pathlib import Path

import numpy as np
import pytest

from piper_tpu.train import norm_audio as JN
from piper_tpu.train import preprocess as JP
from piper_tpu_torch.train import norm_audio as TN
from piper_tpu_torch.train import preprocess as TP
from piper_tpu_torch.train.dataset import voiced_burst, write_synthetic_corpus

SPC = TN.CHUNK_SAMPLES


def _chunks(seed=42):
    """Silence, wideband noise, then a voiced burst: chunks a detector
    scores in turn (its state carried from one to the next)."""
    rng = np.random.default_rng(seed)
    burst = voiced_burst(0.3, 16000, 140.0)
    return [np.zeros(SPC, np.float32),
            (rng.standard_normal(SPC) * 0.1).astype(np.float32),
            *(burst[i * SPC:(i + 1) * SPC] for i in range(len(burst) // SPC))]


def test_silero_probabilities_equal_jax():
    """The golden silence probability of tests/test_vad.py, and every
    probability of a chunk sequence bit-equal to the JAX package's
    detector: the same numpy interpreter on the port's own copy of the
    model, state carried across chunks."""
    assert TN._SILERO_PATH != JN._SILERO_PATH
    assert TN._SILERO_PATH.read_bytes() == JN._SILERO_PATH.read_bytes()
    got_det, ref_det = TN.SileroVAD(), JN.SileroVAD()
    got = [got_det(c) for c in _chunks()]
    ref = [ref_det(c) for c in _chunks()]
    assert abs(got[0] - 0.032909) < 1e-3
    assert got == ref
    assert max(got[2:]) > TN.VAD_THRESHOLD  # the burst scores as speech
    np.testing.assert_array_equal(got_det._h, ref_det._h)
    np.testing.assert_array_equal(got_det._c, ref_det._c)


@pytest.mark.parametrize("n", [480, 1536])
def test_silero_graph_equals_jax_at_both_if_branches(n):
    from piper_tpu.onnx_io import interp as JI
    from piper_tpu_torch.onnx_io import interp as TI

    rng = np.random.default_rng(n)
    feeds = {"input": (rng.standard_normal((1, n)) * 0.2).astype(np.float32),
             "h0": rng.standard_normal((2, 1, 64)).astype(np.float32),
             "c0": rng.standard_normal((2, 1, 64)).astype(np.float32)}
    got = TI.run(TI.OnnxModel(str(TN._SILERO_PATH)), feeds)
    ref = JI.run(JI.OnnxModel(str(JN._SILERO_PATH)), feeds)
    assert TI.OnnxModel(str(TN._SILERO_PATH)).output_names == ["output", "hn", "cn"]
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)


class Scripted:
    """A detector that returns fixed probabilities and counts its calls."""

    def __init__(self, probs):
        self.probs, self.i = list(probs), 0

    def __call__(self, chunk, sample_rate=16000):
        self.i += 1
        return self.probs[self.i - 1]


# (samples, probabilities): a block; exactly N full chunks (the last is
# never scored); a single speech chunk (untrimmed); no speech
TRIM_CASES = {
    "block": (10 * SPC + 1, [0, 0, 0, 0.9, 0.1, 0.9, 0, 0, 0, 0]),
    "last_chunk_unscored": (5 * SPC, [0.9, 0, 0.9, 0]),
    "single_speech_chunk": (8 * SPC + 3, [0, 0.9, 0, 0, 0, 0, 0, 0]),
    "no_speech": (6 * SPC + 3, [0.0] * 6),
}


@pytest.mark.parametrize("case", list(TRIM_CASES))
def test_trim_silence_vad_equals_jax_quirks_included(case):
    n, probs = TRIM_CASES[case]
    audio = np.zeros(n, np.float32)
    got_det, ref_det = Scripted(probs), Scripted(probs)
    assert TN.trim_silence_vad(audio, got_det) == JN.trim_silence_vad(audio, ref_det)
    assert got_det.i == ref_det.i == len(probs)


def test_trim_with_silero_and_energy_equal_jax():
    rng = np.random.default_rng(5)
    sil = np.zeros(8000, np.float32)
    audio = np.concatenate([sil, voiced_burst(0.8, 16000, 120.0), sil])
    got = TN.trim_silence_vad(audio, TN.SileroVAD())
    assert got == JN.trim_silence_vad(audio, JN.SileroVAD())
    assert got[0] > 0 and got[1] is not None  # trimmed, not to nothing
    noisy = audio + (0.001 * rng.standard_normal(audio.shape)).astype(np.float32)
    assert TN.trim_silence(noisy) == JN.trim_silence(noisy)
    assert TN.trim_silence(noisy, threshold=0.05) == JN.trim_silence(noisy, threshold=0.05)


@pytest.mark.parametrize("sizes", [(1024, 256, 1024), (64, 16, 48)])
def test_spectrogram_np_and_resample_equal_jax(sizes):
    n_fft, hop, win = sizes
    audio = (np.random.default_rng(6).standard_normal(5000) * 0.3).astype(np.float32)
    kw = dict(n_fft=n_fft, hop_length=hop, win_length=win)
    np.testing.assert_array_equal(TN.spectrogram_np(audio, **kw), JN.spectrogram_np(audio, **kw))
    np.testing.assert_array_equal(TN.resample(audio, 16000, 22050), JN.resample(audio, 16000, 22050))


def _preprocess(main, corpus, out, sample_rate, workers, speakers):
    # each run starts with a fresh detector in this process, as a
    # process of its own would (the detector keeps its state across
    # utterances: one per process, as in the reference)
    TN._PROCESS_DETECTOR = JN._PROCESS_DETECTOR = None
    main(["--input-dir", str(corpus), "--output-dir", str(out), "--language", "en-us",
          "--sample-rate", str(sample_rate), "--dataset-format", "ljspeech",
          "--phoneme-type", "text", "--max-workers", str(workers),
          *([] if speakers else ["--single-speaker"])])
    return out


def _records(out: Path):
    recs = [json.loads(line) for line in (out / "dataset.jsonl").read_text().splitlines() if line]
    for rec in recs:
        for key in ("audio_norm_path", "audio_spec_path"):
            rec[key] = str(Path(rec[key]).relative_to(out))
    return recs


# (workers, sample rate, speakers): one worker at the WAVs' 16 kHz, and
# two workers resampling to 22,050 Hz with a speaker column. The JAX
# package runs with one worker in both (its pool would fork this
# process, which runs JAX's threads); its output does not depend on the
# worker count while the jobs fit one chunk of its pool's map (8), as
# here: one worker then takes them all in order, with one detector.
RUNS = {"1_worker_16k": (1, 16000, 0), "2_workers_22k_speakers": (2, 22050, 3)}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("corpus")
    write_synthetic_corpus(d / "plain", n_utterances=5, sample_rate=16000, tones=1,
                           seconds=(0.5, 0.9), seed=0)
    write_synthetic_corpus(d / "speakers", n_utterances=5, sample_rate=16000, speakers=3,
                           seconds=(0.5, 0.9), seed=1)
    return d


@pytest.fixture(scope="module")
def preprocessed(corpus, tmp_path_factory):
    out = {}
    for run, (workers, sr, speakers) in RUNS.items():
        src = corpus / ("speakers" if speakers else "plain")
        out[run] = (
            _preprocess(TP.main, src, tmp_path_factory.mktemp(f"port_{run}"), sr, workers, speakers),
            _preprocess(JP.main, src, tmp_path_factory.mktemp(f"jax_{run}"), sr, 1, speakers),
        )
    return out


@pytest.mark.parametrize("run", list(RUNS))
def test_preprocessed_directory_equals_jax(preprocessed, run):
    got, ref = preprocessed[run]
    cfg_got = json.loads((got / "config.json").read_text())
    cfg_ref = json.loads((ref / "config.json").read_text())
    assert cfg_got.pop("piper_version") == "piper_tpu_torch 0.1.0"
    cfg_ref.pop("piper_version")
    assert cfg_got == cfg_ref
    assert cfg_got["num_speakers"] == max(RUNS[run][2], 1)
    recs_got, recs_ref = _records(got), _records(ref)
    assert len(recs_got) == 5
    assert recs_got == recs_ref
    trimmed = 0
    for rec in recs_got:
        for key in ("audio_norm_path", "audio_spec_path"):
            a, b = (got / rec[key]).read_bytes(), (ref / rec[key]).read_bytes()
            assert a == b, rec[key]
        wav_samples = JN.load_audio(rec["audio_path"], RUNS[run][1]).shape[0]
        kept = np.load(got / rec["audio_norm_path"]).shape[0]
        assert kept > 0
        trimmed += kept < wav_samples
    assert trimmed >= 4  # the voiced bursts are trimmed; the tone is not


def test_port_trainer_steps_on_the_preprocessed_directory(preprocessed, tmp_path):
    """BucketedLoader over the port's directory, then one step of python
    -m piper_tpu_torch.train at tiny widths on the CPU."""
    from piper_tpu_torch.train.__main__ import main as train_main
    from piper_tpu_torch.train.dataset import BucketedLoader, load_dataset

    data = preprocessed["1_worker_16k"][0]
    utts = load_dataset([data / "dataset.jsonl"])
    batches = list(BucketedLoader(utts, batch_size=2, hop_length=256, segment_size=4096, seed=0))
    assert sum(b["ids"].shape[0] for b in batches) == 5
    overrides = json.dumps({"hidden_channels": 32, "inter_channels": 32, "filter_channels": 64,
                            "n_heads": 2, "n_layers": 2, "upsample_initial_channel": 64,
                            "segment_size": 4096})
    ckpt = tmp_path / "ckpt"
    train_main(["--dataset-dir", str(data), "--checkpoint-dir", str(ckpt), "--quality", "x-low",
                "--config-overrides", overrides, "--batch-size", "2", "--validation-split", "0",
                "--validate-steps", "0", "--log-steps", "1", "--precision", "parity", "--device", "cpu",
                "--max-steps", "1", "--checkpoint-steps", "1"])
    metrics = [json.loads(line) for line in (ckpt / "metrics.jsonl").read_text().splitlines()]
    assert metrics and all(np.isfinite(v) for m in metrics for k, v in m.items()
                           if isinstance(v, float))
    assert (ckpt / "voice_1.npz").exists()


def _run_tool(main, argv, stdin="", monkeypatch=None, capsys=None):
    monkeypatch.setattr(sys, "stdin", io.StringIO(stdin))
    main(argv)
    return capsys.readouterr().out


@pytest.mark.parametrize("tool", ["check_phonemes", "filter_utterances", "select_speaker"])
def test_dataset_tools_equal_jax(preprocessed, tool, monkeypatch, capsys):
    import importlib

    jmod = importlib.import_module(f"piper_tpu.tools.{tool}")
    tmod = importlib.import_module(f"piper_tpu_torch.tools.{tool}")
    data = preprocessed["2_workers_22k_speakers"][0]
    dataset = str(data / "dataset.jsonl")
    argv, stdin = {
        "check_phonemes": (["--dataset", dataset, "--config", str(data / "config.json")], ""),
        "filter_utterances": (["--dataset", dataset, "--sample-rate", "22050",
                               "--iqr-factor", "0.5"], ""),
        "select_speaker": (["--speaker", "s1"], (data / "dataset.jsonl").read_text()),
    }[tool]
    got = _run_tool(tmod.main, argv, stdin, monkeypatch, capsys)
    ref = _run_tool(jmod.main, argv, stdin, monkeypatch, capsys)
    assert got == ref and got.strip()


def test_clean_cached_audio_deletes_what_jax_deletes(preprocessed, tmp_path, caplog):
    """A copy of the port's directory with one cache file corrupt and one
    emptied: the port's tool reports and deletes the same two files as
    the JAX package's on a second copy."""
    import shutil

    from piper_tpu.tools import clean_cached_audio as JC
    from piper_tpu_torch.tools import clean_cached_audio as TC

    src = preprocessed["1_worker_16k"][0]
    left = {}
    for name, main in (("port", TC.main), ("jax", JC.main)):
        d = tmp_path / name
        shutil.copytree(src, d)
        recs = [json.loads(line) for line in (d / "dataset.jsonl").read_text().splitlines()]
        for rec in recs:
            for key in ("audio_norm_path", "audio_spec_path"):
                rec[key] = str(d / Path(rec[key]).relative_to(src))
        (d / "dataset.jsonl").write_text("".join(json.dumps(r) + "\n" for r in recs))
        Path(recs[0]["audio_spec_path"]).write_bytes(b"not an npy")
        np.save(recs[2]["audio_norm_path"], np.zeros(0, np.float32))
        main(["--dataset", str(d / "dataset.jsonl"), "--delete"])
        left[name] = sorted(p.name for p in d.rglob("*.npy"))
    assert left["port"] == left["jax"]
    assert len(left["port"]) == 2 * 5 - 2


def test_make_registry_writes_jax_bytes(tmp_path, monkeypatch, capsys):
    from piper_tpu.tools import make_registry as JR
    from piper_tpu_torch.runtime.download import expand
    from piper_tpu_torch.tools import make_registry as TR

    voices = {"xx_XX-a-medium": {
        "key": "xx_XX-a-medium", "language": {"code": "xx_XX"}, "quality": "medium",
        "num_speakers": 2, "aliases": ["xx-a"],
        "files": {"xx/a.onnx": {"size_bytes": 12, "md5_digest": "ab"},
                  "xx/a.onnx.json": {"size_bytes": 3, "md5_digest": "cd"}}}}
    src = tmp_path / "voices.json"
    src.write_text(json.dumps(voices))
    monkeypatch.setattr(TR, "OUT", tmp_path / "port.json")
    monkeypatch.setattr(JR, "OUT", tmp_path / "jax.json")
    TR.main([str(src)])
    JR.main([str(src)])
    assert (tmp_path / "port.json").read_bytes() == (tmp_path / "jax.json").read_bytes()
    assert expand(json.loads((tmp_path / "port.json").read_text())) == voices
