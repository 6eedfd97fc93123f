"""The port's data-parallel training across processes on the CPU, after
tests/test_multihost.py: gloo groups of real processes
(tests/torch_mesh_worker.py; the trainer under torch.distributed.run),
started once for the file and run side by side.

- The sharded GAN step on 2 ranks against the port's one-device step on
  the whole batch (a process of its own), two steps, for a VITS and a
  VITS2 configuration (the duration discriminator's masked ratios too).
  The two shards' rows differ in length, so their masks differ: every
  loss within rtol 1e-4 and both parameter trees within
  tests/torch_train_parity.py's bounds, the parameters equal bit for bit
  across the ranks, and each rank's segment starts its rows of the
  one-device step's. The same first step with each rank's own masked
  ratios averaged misses the loss bound: the test tells that fault apart.
- Checkpoints with 2 ranks: rank 0 saves after a sharded step, both
  restore into a state from another seed, the same norm, and train on.
- python -m piper_tpu_torch.train --data-parallel 2 --device cpu under
  torch.distributed.run, 2 steps, against --data-parallel 1 on the same
  data: the same losses and parameters within the same bounds.
"""

from __future__ import annotations

import dataclasses
import json
import os
import pickle
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from piper_tpu.config import AudioConfig, ModelConfig
from piper_tpu_torch.train.dataset import write_synthetic_dataset
from piper_tpu_torch.weights.bridge import iter_leaves
from test_torch_parallel import join, launch
from torch_parity import tcfg
from torch_train_parity import check_leaf

ROOT = Path(__file__).resolve().parent.parent
# tests/test_multihost.py's configuration, and VITS2's flags on it with
# three speakers
VITS = ModelConfig(
    num_symbols=40, inter_channels=32, hidden_channels=32, filter_channels=64, n_heads=2, n_layers=1,
    resblock="2", resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1, 2),), upsample_rates=(4, 4),
    upsample_initial_channel=64, upsample_kernel_sizes=(8, 8), spec_channels=33, segment_size=256,
    flow_n_layers=2,
    audio=AudioConfig(sample_rate=16000, filter_length=64, hop_length=16, win_length=64, mel_channels=20),
)
VITS2 = dataclasses.replace(VITS, num_speakers=3, gin_channels=16, flow_transformer=True,
                            use_dur_disc=True, mas_noise=True, speaker_cond_encoder=True)
# the trainer's run: tests/test_torch_train_cli.py's tiny x-low widths
OVERRIDES = json.dumps({
    "hidden_channels": 32, "inter_channels": 32, "filter_channels": 64, "n_heads": 2,
    "n_layers": 2, "upsample_initial_channel": 64, "segment_size": 4096,
})
LOSS_RTOL = 1e-4


def _batch(cfg, seed):
    """4 rows whose lengths differ (shard 0: rows 0-1, shard 1: rows 2-3)."""
    rng = np.random.default_rng(seed)
    b, t_x, t_y = 4, 12, 40
    batch = {
        "ids": rng.integers(3, cfg.num_symbols, (b, t_x)).astype(np.int64),
        "id_lengths": np.array([12, 9, 11, 7], np.int64),
        "spec": np.abs(rng.standard_normal((b, t_y, cfg.spec_channels))).astype(np.float32),
        "spec_lengths": np.array([40, 31, 36, 25], np.int64),
        "audio": (rng.standard_normal((b, t_y * cfg.audio.hop_length)) * 0.2).astype(np.float32),
    }
    if cfg.num_speakers > 1:
        batch["sid"] = np.array([2, 0, 1, 2], np.int64)
    return batch


def _inputs(out: Path) -> None:
    for name, cfg in (("vits", VITS), ("vits2", VITS2)):
        (out / f"cfg_{name}.pkl").write_bytes(pickle.dumps(tcfg(cfg)))
        np.savez(out / f"gan_{name}.npz", **_batch(cfg, 0))


def _trainer(dataset: Path, ckpt: Path, data_parallel: int):
    args = ["-m", "piper_tpu_torch.train", "--dataset-dir", str(dataset), "--checkpoint-dir", str(ckpt),
            "--quality", "x-low", "--config-overrides", OVERRIDES, "--batch-size", "2",
            "--single-bucket", "--validation-split", "0", "--validate-steps", "0", "--log-steps", "1",
            "--precision", "parity", "--max-steps", "2", "--device", "cpu",
            "--data-parallel", str(data_parallel)]
    if data_parallel > 1:
        args = ["-m", "torch.distributed.run", "--standalone", "--nproc-per-node", str(data_parallel)] + args
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(ROOT))
    return subprocess.Popen([sys.executable, *args], env=env, cwd=str(ckpt.parent),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The 2-rank job, the 1-rank reference and both trainer runs, side by
    side; yields their directories, which go at the module's end."""
    dirs = {k: tmp_path_factory.mktemp(k) for k in ("ranks", "single", "cli")}
    for k in ("ranks", "single"):
        _inputs(dirs[k])
    dataset = write_synthetic_dataset(dirs["cli"] / "data", n_utterances=6, sample_rate=16000,
                                      num_symbols=64, seconds=(0.6, 1.0), ids=(8, 16), seed=3)
    procs = [launch("gan", 2, dirs["ranks"]), launch("gan_single", 1, dirs["single"]),
             [_trainer(dataset, dirs["cli"] / "dp2", 2)], [_trainer(dataset, dirs["cli"] / "dp1", 1)]]
    for group in procs:
        join(group)
    yield dirs
    for d in dirs.values():  # the checkpoints and parameter snapshots: ~2.5 GB
        shutil.rmtree(d, ignore_errors=True)


def _res(d: Path, check: str, rank: int = 0):
    return np.load(d / f"{check}.r{rank}.npz")


@pytest.mark.parametrize("variant", ["vits", "vits2"])
def test_two_rank_gan_step_matches_one_rank(runs, variant):
    ranks = [_res(runs["ranks"], f"gan_{variant}", r) for r in range(2)]
    single = _res(runs["single"], f"gan_{variant}")
    for i in range(2):
        losses = [k for k in single.files if k.startswith(f"step{i}/loss")]
        assert f"step{i}/loss_kl" in losses and (variant == "vits" or f"step{i}/loss_dur_gen" in losses)
        for k in losses:
            for r in range(2):
                np.testing.assert_allclose(ranks[r][k], single[k], rtol=LOSS_RTOL, err_msg=f"rank {r} {k}")
        seg = single[f"step{i}/ids_slice"]
        for r in range(2):  # each rank's segments are its rows of the whole batch's draw
            np.testing.assert_array_equal(ranks[r][f"step{i}/ids_slice"], seg[2 * r : 2 * r + 2])
    params = [k for k in single.files if k.startswith("final/")]
    assert any("/params_d/" in k for k in params) and any("/params_g/" in k for k in params)
    for k in params:  # both trees after the two steps
        check_leaf(k, ranks[0][k], single[k], 2, "after 2 steps")
    digests = [k for k in ranks[0].files if k.startswith("digest/")]
    assert len(digests) == len(params)
    for k in digests:  # every rank holds the same parameters, bit for bit
        np.testing.assert_array_equal(ranks[1][k], ranks[0][k], err_msg=k)
    assert sum(not np.array_equal(ranks[0][k], ranks[0]["before/" + k.split("/", 1)[1]])
               for k in digests) > 0


@pytest.mark.parametrize("variant", ["vits", "vits2"])
def test_averaged_per_rank_ratios_miss_the_bound(runs, variant):
    """The fault the global ratios repair: each rank dividing by its own
    masks' sums and the ranks' ratios averaged gives another loss."""
    naive = _res(runs["ranks"], f"gan_{variant}")
    single = _res(runs["single"], f"gan_{variant}")
    ratios = ["loss_kl", "loss_dur"] + (["loss_dur_gen", "loss_disc_all"] if variant == "vits2" else [])
    for k in ratios + ["loss_gen_all"]:
        err = abs(float(naive[f"naive/{k}"]) - float(single[f"step0/{k}"]))
        assert err > LOSS_RTOL * abs(float(single[f"step0/{k}"])), k
    for k in ("loss_mel", "loss_fm", "loss_gen"):  # the means over equal shares agree
        np.testing.assert_allclose(naive[f"naive/{k}"], single[f"step0/{k}"], rtol=LOSS_RTOL, err_msg=k)


def test_checkpoint_save_restore_two_ranks(runs):
    res = [_res(runs["ranks"], "checkpoint", r) for r in range(2)]
    assert sorted(p.name for p in (runs["ranks"] / "ckpt").iterdir()) == ["state_1.pt"]
    for r in res:
        assert int(r["step"]) == 1 and int(r["opt_count"]) == 1
        assert abs(float(r["restored_norm"]) - float(r["trained_norm"])) <= 1e-9 * float(r["trained_norm"])
        assert np.isfinite(r["loss_gen_all"])
    assert float(res[0]["restored_norm"]) == float(res[1]["restored_norm"])
    assert float(res[0]["loss_gen_all"]) == float(res[1]["loss_gen_all"])


def test_trainer_data_parallel_matches_one_process(runs):
    dp2, dp1 = runs["cli"] / "dp2", runs["cli"] / "dp1"
    rows = {k: [json.loads(x) for x in (d / "metrics.jsonl").read_text().splitlines()]
            for k, d in (("dp2", dp2), ("dp1", dp1))}
    assert [r["step"] for r in rows["dp2"]] == [r["step"] for r in rows["dp1"]] == [1, 2]
    for a, b in zip(rows["dp2"], rows["dp1"]):
        for k, v in b.items():
            if k.startswith("loss"):
                assert a[k] == pytest.approx(v, rel=LOSS_RTOL, abs=1e-5), (a["step"], k)
    for d in (dp2, dp1):
        assert sorted(p.name for p in d.glob("state_*.pt")) == ["state_2.pt"]
        assert (d / "voice_2.npz").exists()
    got = torch.load(dp2 / "state_2.pt", weights_only=True)
    ref = torch.load(dp1 / "state_2.pt", weights_only=True)
    assert got["step"] == ref["step"] == 2 and got["opt_g"]["count"] == 2
    for tree in ("params_g", "params_d"):
        ref_leaves = dict(iter_leaves(ref[tree]))
        for name, t in iter_leaves(got[tree]):
            check_leaf(name, t.numpy(), ref_leaves[name].numpy(), 2, f"trainer {tree}")
