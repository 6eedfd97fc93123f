"""Training CLI.

Counterpart of `python -m piper_tpu.train` (reference
src/python/piper_train/__main__.py:15-147), with the JAX trainer's
flags: it reads a preprocessed directory (config.json + dataset.jsonl,
as piper_tpu.train.preprocess writes it), builds the model per quality
preset and variant, and runs the GAN training loop (train/step.py) on
CUDA unless --device cpu is given; without a GPU it raises rather than
falling back to the CPU.

Data parallelism (--data-parallel N, the JAX trainer's): one process per
device, started by torchrun (python -m torch.distributed.run
--nproc-per-node N -m piper_tpu_torch.train ...), NCCL on CUDA and gloo
with --device cpu. Every rank walks the same seeded batch order and
trains on its rows of each batch through the sharded step
(parallel/sharding.make_sharded_train_step: one global step, the same
parameters on every rank); a batch whose rows do not divide over the
ranks is skipped. N defaults to gcd(batch size, processes); ranks past N
train nothing. Only rank 0 writes checkpoints, metrics.jsonl, exports and
validation audio; every rank restores. One process is the one-device
trainer.

Where it differs from the JAX trainer:
- checkpoints are torch.save files of the state (params, optimizers,
  step) in the checkpoint directory, state_<step>.pt; --resume reads the
  port's own checkpoints, not the JAX trainer's orbax directories;
- --resume-from-single-speaker-checkpoint reads a native .npz voice and
  keeps the fresh initialisation where the trees differ (the
  multi-speaker surgery, reference __main__.py:92-140);
- --export-every writes native .npz voices (voice_<step>.npz) and the
  validation pass writes WAVs through the port's infer;
- --scan-steps K buffers K same-shape batches and runs them as K
  sequential steps (the JAX trainer's lax.scan over them is the same
  math), with the same keys, and flushes the batches left in the
  buffers at each epoch's end and before the last checkpoint, where the
  JAX trainer drops them.

Usage:
  python -m piper_tpu_torch.train --dataset-dir out --quality medium \\
      --batch-size 32 --max-steps 100000
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import logging
import math
import time
from pathlib import Path
from typing import Any, Dict, List

import numpy as np
import torch
import torch.distributed as dist

from ..config import ModelConfig, VoiceConfig
from ..ops import prng
from ..parallel.mesh import Mesh, initialize_multihost, make_mesh
from ..parallel.sharding import make_sharded_train_step, shard_batch
from ..runtime.voice import resolve_device, tf32_off
from .dataset import BucketedLoader, load_dataset
from .step import TrainState, init_params, leaves, make_train_state

_LOGGER = logging.getLogger(__name__)


def merge_params(dst: Any, src: Any) -> Any:
    """Copy matching leaves of src into dst (same path and shape); keep
    dst's fresh init elsewhere — the multi-speaker surgery
    (piper_tpu/train/__main__.py:41)."""
    if isinstance(dst, dict) and isinstance(src, dict):
        return {k: merge_params(dst[k], src[k]) if k in src else dst[k] for k in dst}
    if isinstance(dst, list) and isinstance(src, list):
        return [merge_params(d, s) for d, s in zip(dst, src)] + list(dst[len(src):])
    if hasattr(dst, "shape") and hasattr(src, "shape") and dst.shape == src.shape:
        return src
    return dst


def _cpu_tree(tree: Any) -> Any:
    """The tree's tensors, detached, on the host."""
    if isinstance(tree, dict):
        return {k: _cpu_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_cpu_tree(v) for v in tree]
    return tree.detach().cpu()


def save_checkpoint(ckpt_dir: Path, state: TrainState, step: int) -> Path:
    """state_<step>.pt: the params (CPU tensors), both optimizers' states
    and the step."""
    path = Path(ckpt_dir) / f"state_{step}.pt"
    torch.save({
        "step": step,
        "params_g": _cpu_tree(state.params_g),
        "params_d": _cpu_tree(state.params_d),
        "opt_g": state.opt_g.state_dict(),
        "opt_d": state.opt_d.state_dict(),
    }, path)
    return path


def latest_checkpoint(ckpt_dir: Path):
    steps = [int(p.stem.split("_", 1)[1]) for p in Path(ckpt_dir).glob("state_*.pt")
             if p.stem.split("_", 1)[1].isdigit()]
    return Path(ckpt_dir) / f"state_{max(steps)}.pt" if steps else None


def restore_checkpoint(ckpt_dir: Path, state: TrainState):
    """The latest state_<step>.pt into `state` (in place); returns
    (state, step), step 0 when there is none."""
    path = latest_checkpoint(ckpt_dir)
    if path is None:
        return state, 0
    saved = torch.load(path, map_location="cpu", weights_only=True)
    with torch.no_grad():
        for key in ("params_g", "params_d"):
            for dst, src in zip(leaves(getattr(state, key)), leaves(saved[key])):
                dst.copy_(src)
    state.opt_g.load_state_dict(saved["opt_g"])
    state.opt_d.load_state_dict(saved["opt_d"])
    state.step = saved["step"]
    return state, saved["step"]


def build_config(args, vcfg: VoiceConfig, error) -> ModelConfig:
    """The JAX trainer's ModelConfig choice: preset, variant, vocoder,
    the dataset's sample rate, then --config-overrides."""
    if args.vocoder == "mb_istft":
        if args.variant == "vits2":
            error("--vocoder mb_istft with --variant vits2 is not a supported combination yet")
        make_cfg = ModelConfig.mb_istft
    elif args.variant == "vits2":
        make_cfg = ModelConfig.vits2
    else:
        make_cfg = ModelConfig.for_quality
    cfg = make_cfg(args.quality, num_symbols=vcfg.num_symbols, num_speakers=vcfg.num_speakers)
    cfg = dataclasses.replace(cfg, audio=dataclasses.replace(cfg.audio, sample_rate=vcfg.sample_rate))
    if args.config_overrides:
        overrides = json.loads(args.config_overrides)
        audio_over = overrides.pop("audio", None)
        for k in ("resblock_kernel_sizes", "upsample_rates", "upsample_kernel_sizes"):
            if k in overrides:
                overrides[k] = tuple(overrides[k])
        if "resblock_dilation_sizes" in overrides:
            overrides["resblock_dilation_sizes"] = tuple(
                tuple(d) for d in overrides["resblock_dilation_sizes"]
            )
        cfg = dataclasses.replace(cfg, **overrides)
        if audio_over:
            cfg = dataclasses.replace(cfg, audio=dataclasses.replace(cfg.audio, **audio_over))
    return cfg


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="piper_tpu_torch.train")
    p.add_argument("--dataset-dir", required=True,
                   help="Directory with config.json and dataset.jsonl")
    p.add_argument("--checkpoint-dir", help="Checkpoint directory (default: dataset-dir/ckpt)")
    p.add_argument("--quality", default="medium", choices=("x-low", "low", "medium", "high"))
    p.add_argument("--variant", default="vits", choices=("vits", "vits2"),
                   help="vits = reference architecture; vits2 adds the 2307.16430 upgrades "
                        "(transformer flow, adversarial durations, noised MAS)")
    p.add_argument("--vocoder", default="hifigan", choices=("hifigan", "mb_istft"),
                   help="hifigan = reference vocoder; mb_istft = multi-band iSTFT head")
    p.add_argument("--config-overrides",
                   help="JSON dict of ModelConfig field overrides (e.g. "
                        '\'{"hidden_channels": 64}\'); "audio" sub-dict overrides AudioConfig fields')
    p.add_argument("--batch-size", type=int, required=True)
    p.add_argument("--max-steps", type=int, default=2_000_000)
    p.add_argument("--max-epochs", type=int, default=10_000)
    p.add_argument("--checkpoint-steps", type=int, default=2000)
    p.add_argument("--log-steps", type=int, default=50)
    p.add_argument("--max-phoneme-ids", type=int)
    p.add_argument("--max-spec-frames", type=int, default=2048,
                   help="Skip utterances longer than this many spectrogram frames")
    p.add_argument("--single-bucket", action="store_true",
                   help="Pad every batch to one (phoneme, frame) shape")
    p.add_argument("--learning-rate", type=float, default=2e-4)
    p.add_argument("--grad-clip", type=float, help="Clip each gradient element to +-value")
    p.add_argument("--seed", type=int, default=1234)
    p.add_argument("--num-test-examples", type=int, default=5)
    p.add_argument("--validation-split", type=float, default=0.1)
    p.add_argument("--resume", action="store_true",
                   help="Resume from the latest state_<step>.pt in checkpoint-dir")
    p.add_argument("--resume-from-single-speaker-checkpoint",
                   help="Native .npz voice to initialize a multi-speaker run from")
    p.add_argument("--data-parallel", type=int,
                   help="Processes on the data axis (default: gcd of the batch size and the "
                        "processes torchrun started)")
    p.add_argument("--precision", choices=("fast", "parity"), default="fast",
                   help="fast: bfloat16 generator compute; parity: float32")
    p.add_argument("--scan-steps", type=int, default=1,
                   help="Buffer K same-shape batches and run them as K sequential steps "
                        "(the JAX trainer's scanned dispatch; the same math and keys)")
    p.add_argument("--export-every", type=int, default=0,
                   help="Export a .npz voice every N steps (0 = only at end)")
    p.add_argument("--validate-steps", type=int, default=2000, help="Validation cadence (0 disables)")
    p.add_argument("--device", help="cuda (default) or cpu")
    p.add_argument("--debug", action="store_true")
    return p


def _barrier(mesh: Mesh) -> None:
    """Every rank waits for rank 0's writes."""
    if mesh.groups["data"] is not None:
        dist.barrier(group=mesh.groups["data"])


def main(argv=None) -> None:
    p = build_parser()
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.DEBUG if args.debug else logging.INFO)
    device = resolve_device(args.device)
    started = not dist.is_initialized()
    initialize_multihost(device=device)  # a no-op outside torchrun
    started = started and dist.is_initialized()
    try:
        _train(args, p, device)
    finally:
        if started:
            dist.destroy_process_group()


def _train(args, p: argparse.ArgumentParser, device: torch.device) -> None:
    world = dist.get_world_size() if dist.is_initialized() else 1
    data_parallel = args.data_parallel or math.gcd(args.batch_size, world)
    mesh = make_mesh(data=data_parallel, model=1, ranks=range(min(data_parallel, world)),
                     device="cpu" if device.type == "cpu" else None)
    if mesh is None:
        _LOGGER.info("rank %s is outside the --data-parallel %s mesh: it trains nothing",
                     dist.get_rank(), data_parallel)
        return
    device = mesh.device
    lead = mesh.coords["data"] == 0  # the rank that writes
    tf32_off()

    dataset_dir = Path(args.dataset_dir)
    ckpt_dir = Path(args.checkpoint_dir or dataset_dir / "ckpt")
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    vcfg = VoiceConfig.from_file(dataset_dir / "config.json")
    cfg = build_config(args, vcfg, p.error)
    _LOGGER.info("Model: %s", cfg)

    utterances = load_dataset([dataset_dir / "dataset.jsonl"], max_phoneme_ids=args.max_phoneme_ids)
    n_val = int(len(utterances) * args.validation_split)
    order = np.random.default_rng(args.seed).permutation(len(utterances))
    val_utts = [utterances[i] for i in order[:n_val]]
    train_utts = [utterances[i] for i in order[n_val:]]
    _LOGGER.info("Train %s / val %s utterances", len(train_utts), len(val_utts))

    loader = BucketedLoader(
        train_utts, batch_size=args.batch_size, hop_length=cfg.audio.hop_length,
        segment_size=cfg.segment_size, multispeaker=cfg.num_speakers > 1, seed=args.seed,
        max_spec_frames=args.max_spec_frames, single_shape=args.single_bucket,
    )
    steps_per_epoch = max(len(train_utts) // args.batch_size, 1)
    params_g, params_d = init_params(args.seed, cfg)
    if args.resume_from_single_speaker_checkpoint and not args.resume:
        from ..weights.native import load_native

        src, _ = load_native(args.resume_from_single_speaker_checkpoint)
        params_g = merge_params(params_g, src)
        _LOGGER.info("Initialized generator from single-speaker checkpoint")
    state = make_train_state(
        params_g, params_d, cfg, device=device, learning_rate=args.learning_rate,
        steps_per_epoch=steps_per_epoch, grad_clip=args.grad_clip,
    )
    start_step = 0
    if args.resume:
        state, start_step = restore_checkpoint(ckpt_dir, state)
        _LOGGER.info("Resumed from step %s", start_step)

    dtype = torch.bfloat16 if args.precision == "fast" else torch.float32
    step_fn = make_sharded_train_step(cfg, mesh, dtype=dtype)
    scan_k = max(1, args.scan_steps)
    key = prng.prng_key(args.seed + 1)
    step = start_step
    metrics: Dict[str, torch.Tensor] = {}
    t_start = time.perf_counter()
    pending: Dict[tuple, List[Dict[str, np.ndarray]]] = {}

    def run(batches, keys, epoch, metrics_file):
        """Steps over `batches` with `keys`, then the cadences that fired
        between the step before and the step after."""
        nonlocal step, state, metrics
        prev_step = step
        for batch, k in zip(batches, keys):
            state, metrics = step_fn(state, shard_batch(batch, mesh), k)
            step += 1

        def crossed(n):
            return n and step // n != prev_step // n

        if not lead:
            if crossed(args.checkpoint_steps):
                _barrier(mesh)
            return
        if crossed(args.log_steps):
            vals = {k: round(float(v), 5) for k, v in metrics.items() if k.startswith("loss")}
            vals.update(step=step, epoch=epoch, wall_s=round(time.perf_counter() - t_start, 1))
            metrics_file.write(json.dumps(vals) + "\n")
            metrics_file.flush()
            _LOGGER.info("step %s gen %.3f disc %.3f mel %.3f", step, vals["loss_gen_all"],
                         vals["loss_disc_all"], vals["loss_mel"])
        if crossed(args.checkpoint_steps):
            save_checkpoint(ckpt_dir, state, step)
            _barrier(mesh)
        if args.export_every and crossed(args.export_every):
            _export(ckpt_dir, state, cfg, step)
        if args.validate_steps and crossed(args.validate_steps):
            _validate(ckpt_dir, state, cfg, step, val_utts, metrics_file, device)

    def flush(epoch, metrics_file):
        """The batches left in the scan buffers, as single steps."""
        nonlocal key
        for buf in pending.values():
            for batch in buf:
                if step >= args.max_steps:
                    break
                key, sub = prng.split(key)
                run([batch], [sub], epoch, metrics_file)
        pending.clear()

    metrics_out = (open(ckpt_dir / "metrics.jsonl", "a", encoding="utf-8") if lead
                   else contextlib.nullcontext())
    with metrics_out as metrics_file:
        for epoch in range(start_step // steps_per_epoch, args.max_epochs):
            for batch in loader:
                if batch["ids"].shape[0] % mesh.size:
                    continue  # its rows do not divide over the mesh
                if scan_k > 1:
                    shape_key = tuple((k, v.shape) for k, v in sorted(batch.items()))
                    buf = pending.setdefault(shape_key, [])
                    buf.append(batch)
                    if len(buf) < scan_k:
                        continue
                    pending[shape_key] = []
                    key, sub = prng.split(key)
                    # never past --max-steps: the last group may be cut
                    n = min(scan_k, args.max_steps - step)
                    run(buf[:n], prng.split(sub, scan_k)[:n], epoch, metrics_file)
                else:
                    key, sub = prng.split(key)
                    run([batch], [sub], epoch, metrics_file)
                if step >= args.max_steps:
                    break
            flush(epoch, metrics_file)
            if step >= args.max_steps:
                break

    if lead:
        save_checkpoint(ckpt_dir, state, step)
        _export(ckpt_dir, state, cfg, step)
    _barrier(mesh)
    _LOGGER.info("Done at step %s", step)


def _export(ckpt_dir: Path, state: TrainState, cfg: ModelConfig, step: int) -> Path:
    from ..weights.native import save_native

    path = Path(ckpt_dir) / f"voice_{step}.npz"
    save_native(str(path), _cpu_tree(state.params_g), cfg)
    _LOGGER.info("Exported %s", path)
    return path


@torch.no_grad()
def _validate(ckpt_dir: Path, state: TrainState, cfg: ModelConfig, step: int, val_utts,
              metrics_file, device) -> None:
    """Validation: mel L1 on held-out utterances and their WAVs
    (reference lightning.py:282-306; piper_tpu/train/__main__.py:347),
    synthesised through the port's infer with the JAX trainer's
    per-utterance keys (PRNGKey(step + i), split into the duration and
    frame noise as its infer splits them)."""
    from ..models.vits.model import infer
    from ..ops.stft import mel_spectrogram
    from ..runtime.wav import audio_float_to_int16, write_wav

    if not val_utts:
        return
    a = cfg.audio
    sample_dir = Path(ckpt_dir) / "samples" / str(step)
    sample_dir.mkdir(parents=True, exist_ok=True)
    mel_l1, dur_ratio = [], []
    val_utts = val_utts[:5]
    t_pad = max(-(-len(u.phoneme_ids) // 64) * 64 for u in val_utts)
    refs = [np.load(u.audio_norm_path).astype(np.float32) for u in val_utts]
    want = max(max(len(r) // a.hop_length for r in refs) * 2, 128)
    max_frames = -(-want // 512) * 512
    mel_kw = dict(sample_rate=a.sample_rate, n_fft=a.filter_length, hop_length=a.hop_length,
                  win_length=a.win_length, n_mels=a.mel_channels)
    for i, (utt, ref_audio) in enumerate(zip(val_utts, refs)):
        n_ids = len(utt.phoneme_ids)
        ids = torch.zeros((1, t_pad), dtype=torch.long)
        ids[0, :n_ids] = torch.as_tensor(utt.phoneme_ids)
        sid = None
        if utt.speaker_id is not None and cfg.num_speakers > 1:
            sid = torch.tensor([utt.speaker_id], device=device)
        r_enc, r_dec = prng.split(prng.prng_key(step + i, device))
        audio, y_lengths = infer(
            state.params_g, ids.to(device), torch.tensor([n_ids], device=device), cfg=cfg,
            max_frames=max_frames, noise_scale=0.667, length_scale=1.0, noise_w_scale=0.8,
            dur_noise=prng.normal(r_enc, (1, t_pad, 2)),
            frame_noise=prng.normal(r_dec, (1, max_frames, cfg.inter_channels)), sid=sid,
        )
        frames = int(y_lengths[0])
        if frames >= max_frames:
            _LOGGER.warning("validation step %s utt %s: predicted %s frames hit the max_frames=%s "
                            "clamp; scoring truncated audio", step, i, frames, max_frames)
        gen = audio[0, : frames * cfg.upsample_factor].float().cpu().numpy()
        dur_ratio.append(frames / max(len(ref_audio) // a.hop_length, 1))
        write_wav(sample_dir / f"val_{i}.wav", audio_float_to_int16(gen), a.sample_rate)
        m = min(len(gen), len(ref_audio))
        if m > a.filter_length:
            mel_g = mel_spectrogram(torch.from_numpy(gen[None, :m]), **mel_kw)
            mel_r = mel_spectrogram(torch.from_numpy(ref_audio[None, :m]), **mel_kw)
            mel_l1.append(float(torch.mean(torch.abs(mel_g - mel_r))))
    if mel_l1:
        rec = {"step": step, "val_mel_l1": round(float(np.mean(mel_l1)), 4),
               "val_dur_ratio": round(float(np.mean(dur_ratio)), 4)}
        metrics_file.write(json.dumps(rec) + "\n")
        metrics_file.flush()
        _LOGGER.info("validation step %s mel L1 %.4f dur ratio %.3f", step, rec["val_mel_l1"],
                     rec["val_dur_ratio"])


if __name__ == "__main__":
    main()
