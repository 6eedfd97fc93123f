"""One rank of the port's multi-process CPU tests (tests/test_torch_parallel.py,
tests/test_torch_multihost.py), run as its own process:

    python tests/torch_mesh_worker.py JOB RANK WORLD DIR

It joins a gloo group of WORLD ranks through the file store DIR/store,
runs JOB's checks and writes each check's arrays to DIR/<check>.r<RANK>.npz,
then DIR/done.r<RANK>. Inputs come from the parent in DIR (cfg_<name>.pkl:
the port's ModelConfig; <name>.npz: numpy inputs). It imports no JAX: the
JAX references are computed in the parent. One intra-op thread per rank,
so several ranks share the CPU without oversubscribing it.
"""

from __future__ import annotations

import datetime
import hashlib
import pickle
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from piper_tpu_torch.config import SynthesisConfig  # noqa: E402
from piper_tpu_torch.models.vits.model import init_synthesizer_params, synthesizer_vocode  # noqa: E402
from piper_tpu_torch.ops import prng  # noqa: E402
from piper_tpu_torch.parallel import mesh as PM  # noqa: E402
from piper_tpu_torch.parallel import sharding as PS  # noqa: E402
from piper_tpu_torch.weights.bridge import iter_leaves, params_from_jax  # noqa: E402

TIMEOUT = datetime.timedelta(seconds=240)


class Run:
    def __init__(self, rank: int, out: Path):
        self.rank, self.out = rank, out

    def cfg(self, name):
        return pickle.loads((self.out / f"cfg_{name}.pkl").read_bytes())

    def inputs(self, name):
        return dict(np.load(self.out / f"{name}.npz"))

    def save(self, check, **arrays):
        np.savez(self.out / f"{check}.r{self.rank}.npz", **arrays)


def mesh(data, model):
    return PM.make_mesh(data, model, device="cpu", timeout=TIMEOUT)


# ---------------------------------------------------------------------------
# tests/test_torch_parallel.py (4 ranks)
# ---------------------------------------------------------------------------


def sharded_vocode_cases(run: Run) -> None:
    from piper_tpu_torch.parallel.vocoder_shard import sharded_vocode

    for case, (data, model), halo in (("model4", (1, 4), 32), ("masked", (2, 2), 40),
                                      ("speakers", (2, 2), 24)):
        cfg = run.cfg(case)
        x = run.inputs(f"vocode_{case}")
        params = params_from_jax(init_synthesizer_params(int(x["seed"]), cfg), cfg, "cpu")
        sid = torch.from_numpy(x["sid"]) if "sid" in x else None
        with torch.inference_mode():
            out = sharded_vocode(params, torch.from_numpy(x["z_p"]), torch.from_numpy(x["y_mask"]),
                                 cfg=cfg, mesh=mesh(data, model), sid=sid, halo_frames=halo)
        run.save(f"sharded_vocode_{case}", audio=out.numpy())


def data_parallel_vocode(run: Run) -> None:
    cfg = run.cfg("model4")
    x = run.inputs("vocode_dp")
    params = params_from_jax(init_synthesizer_params(int(x["seed"]), cfg), cfg, "cpu")
    z_p, y_mask = torch.from_numpy(x["z_p"]), torch.from_numpy(x["y_mask"])
    with torch.inference_mode():
        out = PS.vocode_data_parallel(params, z_p, y_mask, None, cfg=cfg, mesh=mesh(4, 1))
        ref = synthesizer_vocode(params, z_p, y_mask, cfg=cfg) if run.rank == 0 else out
    run.save("vocode_dp", audio=out.numpy(), single=ref.numpy())


def sharded_infer(run: Run) -> None:
    from piper_tpu_torch.models.vits.model import infer

    cfg = run.cfg("model4")
    x = run.inputs("infer")
    params = params_from_jax(init_synthesizer_params(int(x["seed"]), cfg), cfg, "cpu")
    ids, lengths = torch.from_numpy(x["ids"]), torch.from_numpy(x["lengths"])
    key = prng.prng_key(11)
    kw = dict(max_frames=128)
    with torch.inference_mode():
        fn = PS.make_sharded_infer(cfg, mesh(4, 1), **kw)
        audio, ylen = fn(params, ids, lengths, 0.667, 1.0, 0.8, key)
        r_enc, r_dec = prng.split(key)
        b, t_x = ids.shape
        ref_audio, ref_ylen = infer(
            params, ids, lengths, cfg=cfg, noise_scale=0.667, length_scale=1.0, noise_w_scale=0.8,
            dur_noise=prng.normal(r_enc, (b, t_x, 2)),
            frame_noise=prng.normal(r_dec, (b, kw["max_frames"], cfg.inter_channels)), **kw)
    run.save("infer", audio=audio.numpy(), y_lengths=ylen.numpy(), ref_audio=ref_audio.numpy(),
             ref_y_lengths=ref_ylen.numpy())


def mesh_voices(run: Run) -> None:
    """The mesh voice at data=4 beside the one-device voice, on each
    rank: parity, fast (exact then speculative), fast on the mu-law wire
    (exact then speculative)."""
    from piper_tpu_torch.runtime.voice import TorchVoice, random_voice_config

    cfg = run.cfg("voice")
    x = run.inputs("voice")
    tree = init_synthesizer_params(int(x["seed"]), cfg)
    rows = [r[r >= 0].tolist() for r in x["rows"]]
    syn = SynthesisConfig(seed=int(x["syn_seed"]))
    m = mesh(4, 1)
    for case, kw in (("parity", dict(precision="parity")), ("fast", dict(precision="fast")),
                     ("mulaw", dict(precision="fast", wire_format="mulaw"))):
        got, ref = {}, {}
        for name, dest, extra in (("mesh", got, dict(mesh=m)), ("single", ref, dict(device="cpu"))):
            voice = TorchVoice(tree, cfg, random_voice_config(cfg), seed=0, **kw, **extra)
            first = voice.synthesize_ids_batch(rows, syn=syn)
            handle = voice.submit(rows, syn=syn)
            dest["spec"] = "spec" in handle
            second = voice.collect(handle)
            for i, (a, b) in enumerate(zip(first, second)):
                dest[f"first_{i}"], dest[f"second_{i}"] = a, b
            dest["fusion"] = voice.dispatch_fusion
        run.save(f"voice_{case}", **{f"mesh_{k}": v for k, v in got.items()},
                 **{f"single_{k}": v for k, v in ref.items()})


def scan_step(run: Run) -> None:
    """make_sharded_scan_step(K) against K make_sharded_train_step calls
    at data=4: the same batches, keys and initial state."""
    from piper_tpu_torch.train.step import init_params, make_train_state

    cfg = run.cfg("train")
    x = run.inputs("scan")
    k = int(x["k"])
    batches = [{n: x[f"{n}_{i}"] for n in ("ids", "id_lengths", "spec", "spec_lengths", "audio")}
               for i in range(k)]
    keys = prng.split(prng.prng_key(5), k)
    m = mesh(4, 1)
    g, d = init_params(0, cfg)
    step = PS.make_sharded_train_step(cfg, m)
    seq = make_train_state(g, d, cfg)
    seq_metrics = []
    for i in range(k):
        seq, met = step(seq, PS.shard_batch(batches[i], m), keys[i])
        seq_metrics.append({n: v.numpy() for n, v in met.items()})
    scan = PS.make_sharded_scan_step(cfg, m, k)
    scanned, stacked = scan(make_train_state(g, d, cfg), PS.stack_batches(batches, m), keys)
    out = {}
    for i in range(k):
        for n, v in seq_metrics[i].items():
            out[f"seq_{i}_{n}"] = v
            out[f"scan_{i}_{n}"] = stacked[n][i].numpy()
    out.update(_leaves(seq, "seqp", full=False))
    out.update(_leaves(scanned, "scanp", full=False))
    run.save("scan", **out)


# ---------------------------------------------------------------------------
# tests/test_torch_multihost.py (2 ranks, and a 1-rank reference process)
# ---------------------------------------------------------------------------


def _leaves(state, prefix, full):
    """Every parameter leaf as `prefix`/tree/name: the array when `full`,
    else its bytes' SHA-1 (the discriminators alone hold ~47M floats)."""
    out = {}
    for tree in ("params_g", "params_d"):
        for name, t in iter_leaves(getattr(state, tree)):
            a = t.detach().numpy()
            out[f"{prefix}/{tree}/{name}"] = (
                a.copy() if full else np.frombuffer(hashlib.sha1(a.tobytes()).digest(), np.uint8))
    return out


def gan_steps(run: Run, world: int) -> None:
    """Two train_steps of the VITS and the VITS2 configuration on the
    whole batch: at world 2 through the sharded step (each rank its two
    rows), at world 1 the port's one-device step. At world 2 also the
    first step with a naive reduction: each rank's own masked ratios,
    averaged over the ranks."""
    from piper_tpu_torch.train import losses as LS
    from piper_tpu_torch.train.step import init_params, make_train_state, train_step

    for variant in ("vits", "vits2"):
        cfg = run.cfg(variant)
        x = run.inputs(f"gan_{variant}")
        batch = {n: x[n] for n in ("ids", "id_lengths", "spec", "spec_lengths", "audio", "sid")
                 if n in x}
        g, d = init_params(0, cfg)
        opt = dict(lr_decay=0.5, steps_per_epoch=1)
        state = make_train_state(g, d, cfg, **opt)
        out = _leaves(state, "before", full=False)
        keys = [prng.prng_key(5), prng.prng_key(6)]
        if world == 1:
            tb = {n: torch.from_numpy(v) for n, v in batch.items()}
            step = lambda st, key: train_step(st, tb, key, cfg=cfg)  # noqa: E731
        else:
            m = mesh(2, 1)
            step_fn = PS.make_sharded_train_step(cfg, m)
            tb = PS.shard_batch(batch, m)
            step = lambda st, key: step_fn(st, tb, key)  # noqa: E731
        for i, key in enumerate(keys):
            state, met = step(state, key)
            out.update({f"step{i}/{n}": v.numpy() for n, v in met.items()})
        out.update(_leaves(state, "digest", full=False))
        out.update(_leaves(state, "final", full=run.rank == 0))
        if world > 1:
            class Naive(LS.BatchShard):
                def ratio(self, num, den):
                    return num / den / self.count

            naive = Naive(m.groups["data"], m.coords["data"], 2)
            st = make_train_state(g, d, cfg, **opt)
            _, met = train_step(st, tb, keys[0], cfg=cfg, shard=naive)
            out.update({f"naive/{n}": v.numpy() for n, v in met.items()})
        run.save(f"gan_{variant}", **out)


def checkpoint(run: Run) -> None:
    """Two ranks: one sharded step, rank 0 saves, both restore into a
    state from another seed, and train on."""
    from piper_tpu_torch.train.__main__ import restore_checkpoint, save_checkpoint
    from piper_tpu_torch.train.step import init_params, leaves, make_train_state

    cfg = run.cfg("vits")
    x = run.inputs("gan_vits")
    batch = {n: x[n] for n in ("ids", "id_lengths", "spec", "spec_lengths", "audio")}
    m = mesh(2, 1)
    step = PS.make_sharded_train_step(cfg, m)
    state = make_train_state(*init_params(0, cfg), cfg)
    state, _ = step(state, PS.shard_batch(batch, m), prng.prng_key(1))
    ckpt = run.out / "ckpt"
    if run.rank == 0:
        ckpt.mkdir()
        save_checkpoint(ckpt, state, 1)
    dist.barrier(group=m.groups["data"])

    def norm(st):
        return float(sum(torch.sum(t.detach().double() ** 2) for t in leaves(st.params_g)))

    trained = norm(state)
    fresh = make_train_state(*init_params(123, cfg), cfg)
    restored, step_no = restore_checkpoint(ckpt, fresh)
    found = dict(step=step_no, trained_norm=trained, restored_norm=norm(restored),
                 opt_count=restored.opt_g.count)
    _, met = step(restored, PS.shard_batch(batch, m), prng.prng_key(2))
    run.save("checkpoint", loss_gen_all=met["loss_gen_all"].numpy(), **found)


JOBS = {
    "parallel": (sharded_vocode_cases, data_parallel_vocode, sharded_infer, mesh_voices, scan_step),
    "gan": (gan_steps, checkpoint),
    "gan_single": (gan_steps,),
}


def main(job: str, rank: int, world: int, out: Path) -> None:
    torch.set_num_threads(1)
    run = Run(rank, out)
    if world > 1:
        dist.init_process_group("gloo", init_method=f"file://{out}/store", rank=rank,
                                world_size=world, timeout=TIMEOUT)
    for fn in JOBS[job]:
        if fn is gan_steps:
            fn(run, world)
        else:
            fn(run)
    (out / f"done.r{rank}").write_text("ok")
    if world > 1:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), Path(sys.argv[4]))
