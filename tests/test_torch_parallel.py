"""The port's parallel/ package on the CPU, after tests/test_parallel.py:
one gloo group of 4 ranks (tests/torch_mesh_worker.py, one process each,
no JAX), started once for the file; each test asserts one of its checks.

- sharded_vocode (time-sharded, halo exchange) against JAX's monolithic
  synthesizer_vocode at atol 2e-5, as JAX holds its own: model=4 with a
  halo of 32, data=2 x model=2 with a ragged mask (samples past the
  valid length exactly 0), two speakers with a halo of 24;
- vocode_data_parallel at data=4 against the port's unsharded
  synthesizer_vocode (the same bits: a row's audio does not depend on
  the rows beside it) and against JAX's time-major vocode (atol 1e-5);
- the mesh voice at data=4 against the one-device voice, bit for bit:
  parity, fast, a second batch on the speculative path, the mu-law wire;
  the last two rows share a decode and span 1 and 2 frame windows, so
  the ranks' shares of it differ in width;
- make_sharded_infer against the unsharded infer at the same key;
- the scan step against K sequential sharded steps (the same steps in
  the same order: the same bits);
- make_mesh's grid and its ValueError, without a process group.

The sharded-vocode cases use test_parallel.py's small configuration: its
flow's receptive field (16 frames) fits the halos those tests give.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from piper_tpu.config import AudioConfig, ModelConfig
from piper_tpu.models.vits import generator as JG
from piper_tpu.models.vits.model import synthesizer_vocode as jax_vocode
from piper_tpu_torch.models.vits.model import init_synthesizer_params
from piper_tpu_torch.parallel import mesh as PM
from torch_parity import TINY, tcfg

WORKER = Path(__file__).with_name("torch_mesh_worker.py")
WORLD = 4
TIMEOUT = 300

# tests/test_parallel.py's small_cfg
SMALL = ModelConfig(
    num_symbols=40, inter_channels=32, hidden_channels=32, filter_channels=64, n_heads=2,
    n_layers=1, resblock="2", resblock_kernel_sizes=(3, 5), resblock_dilation_sizes=((1, 2), (2, 6)),
    upsample_rates=(4, 4), upsample_initial_channel=64, upsample_kernel_sizes=(8, 8),
    flow_n_layers=2, audio=AudioConfig(sample_rate=16000),
)
# tests/test_multihost.py's training configuration
TRAIN = dataclasses.replace(
    SMALL, resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1, 2),), spec_channels=33,
    segment_size=256,
    audio=AudioConfig(sample_rate=16000, filter_length=64, hop_length=16, win_length=64,
                      mel_channels=20),
)


def launch(job: str, world: int, out: Path):
    """Start `world` ranks of torch_mesh_worker.py's `job` over `out`."""
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(WORKER.parent.parent))
    return [subprocess.Popen([sys.executable, str(WORKER), job, str(r), str(world), str(out)],
                             env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for r in range(world)]


def join(procs, timeout=TIMEOUT):
    """Wait for every rank (killing all past `timeout`); fail with the
    first failed rank's errors."""
    errors = []
    for r, p in enumerate(procs):
        try:
            _, err = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail(f"rank {r} did not finish within {timeout} s")
        if p.returncode != 0:
            errors.append(f"rank {r} exited {p.returncode}:\n{err[-3000:]}")
    assert not errors, errors[0]


def write_cfg(out: Path, name: str, cfg: ModelConfig) -> None:
    (out / f"cfg_{name}.pkl").write_bytes(pickle.dumps(tcfg(cfg)))


def _vocode_inputs(out: Path):
    """Each sharded-vocode case's config and inputs, written for the
    ranks; returns {case: (cfg, inputs)}."""
    cases = {}
    rng = np.random.default_rng(0)
    b, t = 2, 4 * 32
    cases["model4"] = (SMALL, dict(seed=0, z_p=rng.standard_normal((b, t, 32)).astype(np.float32),
                                   y_mask=np.ones((b, t, 1), np.float32)))
    rng = np.random.default_rng(1)
    b, t, valid = 1, 2 * 80, 100
    mask = (np.arange(t)[None, :, None] < valid).astype(np.float32)
    cases["masked"] = (SMALL, dict(seed=1, valid=valid, y_mask=mask,
                                   z_p=rng.standard_normal((b, t, 32)).astype(np.float32) * mask))
    rng = np.random.default_rng(2)
    b, t = 2, 2 * 24
    cases["speakers"] = (dataclasses.replace(SMALL, num_speakers=3, gin_channels=8),
                         dict(seed=2, z_p=rng.standard_normal((b, t, 32)).astype(np.float32),
                              y_mask=np.ones((b, t, 1), np.float32), sid=np.array([0, 2], np.int64)))
    for case, (cfg, x) in cases.items():
        write_cfg(out, case, cfg)
        np.savez(out / f"vocode_{case}.npz", **x)
    return cases


def _jax_tree(seed, cfg):
    return jax.tree.map(jnp.asarray, init_synthesizer_params(seed, tcfg(cfg)))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Write the ranks' inputs, start the 4 ranks, compute the JAX
    references while they run, and wait for them. Yields (dir, refs);
    the directory goes at the module's end."""
    out = tmp_path_factory.mktemp("parallel")
    cases = _vocode_inputs(out)
    rng = np.random.default_rng(7)
    np.savez(out / "vocode_dp.npz", seed=1,
             z_p=rng.standard_normal((4, 64, 32)).astype(np.float32),
             y_mask=(np.arange(64)[None, :, None] < np.array([64, 50, 33, 64])[:, None, None])
             .astype(np.float32))
    rng = np.random.default_rng(8)
    np.savez(out / "infer.npz", seed=0, ids=rng.integers(3, 40, (4, 24)).astype(np.int64),
             lengths=np.array([24, 17, 9, 20], np.int64))
    rng = np.random.default_rng(5)
    rows = [[1, 0] + [int(x) for s in rng.integers(3, 40, n) for x in (s, 0)] + [2]
            for n in (8, 30, 14, 22, 5, 35, 60, 70)]
    width = max(map(len, rows))
    np.savez(out / "voice.npz", seed=0, syn_seed=3,
             rows=np.array([r + [-1] * (width - len(r)) for r in rows], np.int64))
    write_cfg(out, "voice", TINY)
    rng = np.random.default_rng(7)
    k, b, t_x, t_y = 2, 4, 12, 40
    scan = {"k": k}
    for i in range(k):
        scan.update({
            f"ids_{i}": rng.integers(3, 40, (b, t_x)).astype(np.int64),
            f"id_lengths_{i}": np.array([12, 9, 11, 7], np.int64),
            f"spec_{i}": np.abs(rng.standard_normal((b, t_y, 33))).astype(np.float32),
            f"spec_lengths_{i}": np.array([40, 31, 36, 25], np.int64),
            f"audio_{i}": (rng.standard_normal((b, t_y * 16)) * 0.1).astype(np.float32),
        })
    np.savez(out / "scan.npz", **scan)
    write_cfg(out, "train", TRAIN)
    procs = launch("parallel", WORLD, out)
    try:
        refs = {}
        for case, (cfg, x) in cases.items():
            sid = jnp.asarray(x["sid"]) if "sid" in x else None
            refs[case] = np.asarray(jax_vocode(_jax_tree(x["seed"], cfg), jnp.asarray(x["z_p"]),
                                               jnp.asarray(x["y_mask"]), cfg=cfg, sid=sid))
        dp = np.load(out / "vocode_dp.npz")
        params = dict(_jax_tree(1, SMALL))
        params["dec_tm"] = JG.prepare_tm(params["dec"], SMALL, jnp.float32)
        refs["vocode_dp"] = np.asarray(jax_vocode(params, jnp.asarray(dp["z_p"]), jnp.asarray(dp["y_mask"]),
                                                  cfg=SMALL, tm_interpret=True))
    finally:
        join(procs)
    yield out, refs
    shutil.rmtree(out, ignore_errors=True)


def result(out: Path, check: str, rank: int = 0):
    return np.load(out / f"{check}.r{rank}.npz")


@pytest.mark.parametrize("case", ["model4", "masked", "speakers"])
def test_sharded_vocode_matches_jax_monolithic(ranks, case):
    out, refs = ranks
    ref = refs[case]
    for r in range(WORLD):
        got = result(out, f"sharded_vocode_{case}", r)["audio"]
        assert got.shape == ref.shape
        np.testing.assert_allclose(got, ref, atol=2e-5, err_msg=f"rank {r}")
    if case == "masked":
        valid = int(np.load(out / "vocode_masked.npz")["valid"])
        assert np.all(got[:, valid * SMALL.upsample_factor:] == 0)


def test_vocode_data_parallel(ranks):
    out, refs = ranks
    single = result(out, "vocode_dp", 0)["single"]
    lens = np.load(out / "vocode_dp.npz")["y_mask"][..., 0].sum(1).astype(int)
    u = SMALL.upsample_factor
    for r in range(WORLD):
        got = result(out, "vocode_dp", r)["audio"]
        assert got.shape == single.shape
        for i, n in enumerate(lens):  # samples past a row's length are not defined
            np.testing.assert_array_equal(got[i, : n * u], single[i, : n * u], err_msg=f"rank {r} row {i}")
            np.testing.assert_allclose(got[i, : n * u], refs["vocode_dp"][i, : n * u], atol=1e-5,
                                       err_msg=f"rank {r} row {i} vs JAX")


@pytest.mark.parametrize("case", ["parity", "fast", "mulaw"])
def test_mesh_voice_matches_single(ranks, case):
    """Every rank returns every row, each equal to the one-device voice's
    bit for bit, in the exact batch and in the speculative one (fast
    precision: the second batch takes it); dispatch fusion is off."""
    out, _ = ranks
    n_rows = len(np.load(out / "voice.npz")["rows"])
    for r in range(WORLD):
        res = result(out, f"voice_{case}", r)
        assert not res["mesh_fusion"] and res["single_fusion"]
        assert bool(res["mesh_spec"]) == bool(res["single_spec"]) == (case != "parity")
        for i in range(n_rows):
            for batch in ("first", "second"):
                a, b = res[f"mesh_{batch}_{i}"], res[f"single_{batch}_{i}"]
                assert len(a) > 0
                np.testing.assert_array_equal(a, b, err_msg=f"rank {r} {batch} row {i}")
            np.testing.assert_array_equal(res[f"mesh_first_{i}"], res[f"mesh_second_{i}"])


def test_sharded_infer_matches_unsharded(ranks):
    """Each rank's rows get the unsharded call's noise. The products of
    infer's encoder and flow run at 1 row where the unsharded call runs 4,
    and the CPU's BLAS may round another way at another shape (only the
    voice's path keeps a row's bits at any batch), so the audio is held
    to float32 reassociation, 1e-5."""
    out, _ = ranks
    for r in range(WORLD):
        res = result(out, "infer", r)
        np.testing.assert_array_equal(res["y_lengths"], res["ref_y_lengths"])
        u = TINY.upsample_factor
        for i, n in enumerate(res["ref_y_lengths"]):
            n = min(int(n), 128) * u
            assert n > 0
            np.testing.assert_allclose(res["audio"][i, :n], res["ref_audio"][i, :n], atol=1e-5,
                                       err_msg=f"rank {r} row {i}")


def test_scan_step_matches_sequential(ranks):
    out, _ = ranks
    res = [result(out, "scan", r) for r in range(WORLD)]
    k = int(np.load(out / "scan.npz")["k"])
    for i in range(k):
        for key in [f for f in res[0].files if f.startswith(f"seq_{i}_loss")]:
            np.testing.assert_array_equal(res[0][key], res[0][key.replace("seq_", "scan_", 1)], err_msg=key)
    params = [f for f in res[0].files if f.startswith("seqp/")]  # each leaf's SHA-1
    assert any("/params_d/" in f for f in params) and any("/params_g/" in f for f in params)
    for name in params:
        np.testing.assert_array_equal(res[0][name], res[0]["scanp/" + name[len("seqp/"):]], err_msg=name)
        for r in range(1, WORLD):  # every rank holds the same parameters
            np.testing.assert_array_equal(res[r][name], res[0][name], err_msg=f"rank {r} {name}")


def test_make_mesh_grid_and_errors():
    np.testing.assert_array_equal(PM.mesh_grid(8, 2, 4), np.arange(8).reshape(2, 4))
    assert PM.mesh_grid(8, model=2).shape == (4, 2)
    with pytest.raises(ValueError, match=r"mesh 3x2 != 8 devices"):
        PM.mesh_grid(8, 3, 2)
    mesh = PM.make_mesh(device="cpu")  # no process group: this process alone
    assert mesh.shape == {"data": 1, "model": 1} and mesh.coords == {"data": 0, "model": 0}
    assert mesh.groups == {"data": None, "model": None}
    with pytest.raises(ValueError, match=r"mesh 2x1 != 1 devices"):
        PM.make_mesh(2, 1, device="cpu")
