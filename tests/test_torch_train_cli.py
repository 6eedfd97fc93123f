"""The port's trainer, python -m piper_tpu_torch.train, on the CPU: a
tiny synthetic dataset directory in preprocess's layout, a few steps
with a checkpoint and an export, --resume at the saved step, the
exported .npz spoken by python -m piper_tpu_torch, --scan-steps
flushing the batches its buffers hold at the epoch's end, and the
refusals: no GPU without --device cpu, --data-parallel above the
processes started (tests/test_torch_multihost.py runs it under torchrun).
"""

import io
import json
import shutil
import sys
import wave

import numpy as np
import pytest
import torch

from piper_tpu_torch.train.__main__ import main, merge_params
from piper_tpu_torch.train.dataset import BucketedLoader, load_dataset, write_synthetic_dataset

# tiny widths on the x-low preset's 16 kHz generator (8-8-4, hop 256),
# with 16-frame segments
OVERRIDES = json.dumps({
    "hidden_channels": 32, "inter_channels": 32, "filter_channels": 64, "n_heads": 2,
    "n_layers": 2, "upsample_initial_channel": 64, "segment_size": 4096,
})


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    return write_synthetic_dataset(tmp_path_factory.mktemp("data"), n_utterances=6, sample_rate=16000,
                                   num_symbols=64, seconds=(0.6, 1.0), ids=(8, 16), seed=3)


def _args(dataset, ckpt, *extra):
    return ["--dataset-dir", str(dataset), "--checkpoint-dir", str(ckpt), "--quality", "x-low",
            "--config-overrides", OVERRIDES, "--batch-size", "2", "--validation-split", "0",
            "--validate-steps", "0", "--log-steps", "1", "--precision", "parity", *extra]


def _metrics(ckpt):
    return [json.loads(line) for line in (ckpt / "metrics.jsonl").read_text().splitlines()]


def test_dataset_reads_as_preprocess_writes(dataset):
    utts = load_dataset([dataset / "dataset.jsonl"])
    assert len(utts) == 6 and all(u.phoneme_ids[0] == 1 and u.phoneme_ids[-1] == 2 for u in utts)
    batches = list(BucketedLoader(utts, batch_size=2, hop_length=256, segment_size=4096, seed=0))
    assert sum(b["ids"].shape[0] for b in batches) == 6
    for b in batches:
        assert b["spec"].shape[2] == 513 and b["audio"].shape[1] == b["spec"].shape[1] * 256
        assert (b["spec_lengths"] > 0).all() and b["spec"].shape[1] >= 16


def test_train_checkpoint_resume_export_and_speak(dataset, tmp_path, monkeypatch):
    ckpt = tmp_path / "ckpt"
    main(_args(dataset, ckpt, "--device", "cpu", "--max-steps", "3", "--checkpoint-steps", "2"))
    assert sorted(p.name for p in ckpt.glob("state_*.pt")) == ["state_2.pt", "state_3.pt"]
    assert (ckpt / "voice_3.npz").exists()
    rows = _metrics(ckpt)
    assert [r["step"] for r in rows] == [1, 2, 3]
    assert all(np.isfinite(v) for r in rows for k, v in r.items() if k.startswith("loss"))
    first = torch.load(ckpt / "state_2.pt", weights_only=True)
    last = torch.load(ckpt / "state_3.pt", weights_only=True)
    assert last["step"] == 3 and last["opt_g"]["count"] == 3
    moved = [not torch.equal(a, b) for a, b in zip(first["params_g"]["dec"]["conv_pre"].values(),
                                                   last["params_g"]["dec"]["conv_pre"].values())]
    assert all(moved)

    # --resume continues at the saved step
    main(_args(dataset, ckpt, "--device", "cpu", "--max-steps", "5", "--resume"))
    assert [r["step"] for r in _metrics(ckpt)] == [1, 2, 3, 4, 5]
    resumed = torch.load(ckpt / "state_5.pt", weights_only=True)
    assert resumed["step"] == 5 and resumed["opt_g"]["count"] == 5

    # the exported voice speaks through the port's CLI
    from piper_tpu_torch.__main__ import main as speak

    voice = tmp_path / "voice.npz"
    shutil.copy(ckpt / "voice_5.npz", voice)
    shutil.copy(dataset / "config.json", tmp_path / "voice.npz.json")
    monkeypatch.setattr(sys, "stdin", io.StringIO("Hello there.\n"))
    speak(["-m", str(voice), "-f", str(tmp_path / "out.wav"), "--device", "cpu", "--seed", "1"])
    with wave.open(str(tmp_path / "out.wav"), "rb") as w:
        assert w.getframerate() == 16000
        pcm = np.frombuffer(w.readframes(w.getnframes()), np.int16)
    assert len(pcm) > 0 and len(pcm) % 256 == 0 and np.abs(pcm).max() > 0


def test_scan_steps_flush_leftover_batches(dataset, tmp_path):
    """--scan-steps 8 over 3 or more batches per epoch: no shape bucket
    ever fills its buffer, and the JAX trainer would train nothing
    (ADVICE.md); the port runs every batch at the epoch's end."""
    ckpt = tmp_path / "ckpt"
    main(_args(dataset, ckpt, "--device", "cpu", "--max-epochs", "1", "--scan-steps", "8"))
    steps = [r["step"] for r in _metrics(ckpt)]
    assert len(steps) >= 3 and steps == list(range(1, len(steps) + 1))
    assert (ckpt / f"state_{steps[-1]}.pt").exists()


def test_refusals(dataset, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(_args(dataset, tmp_path / "a", "--max-steps", "1"))
    # two ranks asked of one process (no torchrun): JAX's mesh error
    with pytest.raises(ValueError, match=r"mesh 2x1 != 1 devices"):
        main(_args(dataset, tmp_path / "b", "--device", "cpu", "--data-parallel", "2"))


def test_merge_params_keeps_fresh_leaves_where_trees_differ():
    dst = {"a": np.zeros(3), "b": {"w": np.zeros((2, 2))}, "c": [np.zeros(1), np.zeros(1)]}
    src = {"a": np.ones(3), "b": {"w": np.ones((3, 2))}, "c": [np.ones(1)]}
    out = merge_params(dst, src)
    assert out["a"].sum() == 3 and out["b"]["w"].sum() == 0
    assert out["c"][0].sum() == 1 and out["c"][1].sum() == 0
