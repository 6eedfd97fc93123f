#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure makes the exit code non-zero):
  1. the card (nvidia-smi name and power limit), torch and CUDA versions,
     the build of the CUDA kernels from piper_tpu_torch/csrc/, and the
     SASS of both bf16 kernels (cuobjdump), which must hold HMMA
     (tensor-core) instructions;
  2. each kernel against its plain PyTorch version on the card, at the
     medium voice's shapes with ragged lengths, in float32 and bfloat16,
     with its time beside the plain version's, a cuDNN composition of
     the same stage and the card's bound (fused_upsample_mrf also per
     stage, each against the cuDNN composition of that stage alone);
  3. the main path through the CLI entry point
     (python -m piper_tpu_torch --batch --seed 1 on a random-weight
     medium voice): WAV checks, determinism, a row alone vs in a batch,
     the kernels' launch counts, the time-major generator against the
     plain generator, the card against the CPU on a small input, and the
     speed of a warm batch;
  4. the serving path: the HTTP server in this process with the
     coalescing batcher on, after a full warm-up; /health and /metrics;
     two bursts of 16 concurrent GETs of / (each equal to the same
     request served alone, fewer batches than requests, one mrf_fused
     and two fused_upsample_mrf launches per decode); a measurement
     window of 320 GETs from 16 closed-loop clients (p50/p99 latency,
     requests/s, every response checked); POST /batch; a chunked /stream
     (framing, sample count, one mrf_fused and two fused_upsample_mrf
     launches per chunk) cold and 24 times warm (time to first chunk
     p50/p99); the seams of streaming in parity precision against one
     whole decode; both bf16 kernels at the streaming chunk's shape;
  5. one JSON line of per-kernel numbers, then the device line.

Needs one CUDA card; prints no result and exits non-zero without one.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import shutil
import subprocess
import sys
import tempfile
import time
import wave
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# Published dense peaks (NVIDIA data sheets): (bf16 tensor FLOP/s,
# float32 FLOP/s without tensor cores, memory bytes/s).
PEAKS = {
    "PCIe": (756e12, 51e12, 2.0e12),
    "NVL": (835e12, 60e12, 3.9e12),
    "SXM": (989e12, 67e12, 3.35e12),
}
# (atol, rtol) of a kernel against its plain version on the card.
# float32: both accumulate in float32, only the order of the sums
# differs. bfloat16: both round every conv output and residual to bf16
# at the same points, but a sum that lands near a rounding boundary may
# round the other way (one bf16 ulp is 2^-8 relative) and the chain of
# 6 convs per resblock carries such flips on.
TOL = {"float32": (1e-4, 1e-4), "bfloat16": (3e-2, 3e-2)}

FAILURES = []


def check(ok: bool, what: str) -> None:
    print(("ok   " if ok else "FAIL ") + what, flush=True)
    if not ok:
        FAILURES.append(what)


def peaks_for(name: str):
    for key, val in PEAKS.items():
        if key in name:
            return key, val
    return "SXM", PEAKS["SXM"]


def time_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# ---------------------------------------------------------------------------
# Phase 2 helpers: medium-voice stage inputs and the cuDNN compositions
# ---------------------------------------------------------------------------


def stage_inputs(cfg, frames, dtype, seed):
    """Stage 0's mrf_fused input (B, 128, 8F) and its valid samples per
    row, at these frame lengths (F = the longest), on the card."""
    import torch

    g = torch.Generator().manual_seed(seed)
    b, f = len(frames), max(frames)
    u0 = cfg.upsample_rates[0]
    t0 = f * u0
    lens0 = torch.tensor(frames, dtype=torch.int32) * u0
    valid = (torch.arange(t0)[None, :] < lens0[:, None])[:, None, :]
    c0 = cfg.upsample_initial_channel // 2
    x0 = torch.randn((b, c0, t0), generator=g) * valid
    return x0.to("cuda", dtype), lens0.cuda()


def lib_mrf(blocks, x, lens, cfg):
    """cuDNN composition of one MRF stage, (B, C, T) in and out."""
    import torch
    import torch.nn.functional as F

    t = x.shape[-1]
    mask = (torch.arange(t, device=x.device)[None, :] < lens[:, None])[:, None, :].to(x.dtype)
    xs = None
    for j, bp in enumerate(blocks):
        k = cfg.resblock_kernel_sizes[j]
        h = x * mask
        for cp, d in zip(bp["convs"], cfg.resblock_dilation_sizes[j]):
            w = cp["w"].to(x.dtype).permute(2, 1, 0)
            a = F.leaky_relu(h, 0.1) * mask
            h = F.conv1d(a, w, cp["b"].to(x.dtype), padding=(k * d - d) // 2, dilation=d) + h
        h = h * mask
        xs = h if xs is None else xs + h
    return xs / len(blocks)


def lib_stage(up, blocks, wpost, x, lens_out, u, k, cfg):
    """cuDNN composition of one upsample stage in interleaved time:
    (B, C_in, T_in) -> (B, C_out, T_in*u), or (B, T_in*u) with wpost."""
    import torch
    import torch.nn.functional as F

    from piper_tpu_torch.ops.nn import torch_conv_transpose_weight

    t_in = x.shape[-1]
    m_in = (torch.arange(t_in, device=x.device)[None, :] < (lens_out // u)[:, None])[:, None]
    y = F.leaky_relu(x * m_in, 0.1)
    y = F.conv_transpose1d(
        y, torch_conv_transpose_weight(up["w"].to(x.dtype)), up["b"].to(x.dtype),
        stride=u, padding=(k - u) // 2,
    )
    y = lib_mrf(blocks, y, lens_out, cfg)
    if wpost is None:
        return y
    t = y.shape[-1]
    m = (torch.arange(t, device=x.device)[None, :] < lens_out[:, None])[:, None].to(x.dtype)
    y = F.leaky_relu(y, 0.01) * m
    return (torch.tanh(F.conv1d(y, wpost.to(x.dtype).permute(2, 1, 0), padding=3)) * m)[:, 0]


def work_mrf(cfg, c, n_valid):
    """FLOPs of one MRF stage over n_valid output samples (mask-aware)."""
    taps = sum(k * len(ds) for k, ds in zip(cfg.resblock_kernel_sizes, cfg.resblock_dilation_sizes))
    return 2 * taps * c * c * n_valid


def sass_tensor_cores(V) -> None:
    """Phase 1: each bf16 kernel's SASS holds HMMA (mma.sync)."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    for lib, kernel in (("mrf_fused", "mrf_fused_tc_kernel"), ("fused_upsample_mrf", "fused_stage_tc_kernel")):
        res = subprocess.run([tool, "-sass", str(V._lib_path(lib))], capture_output=True, text=True, timeout=300)
        funcs, name = {}, None
        for line in res.stdout.splitlines():
            if "Function :" in line:
                name = line.split("Function :", 1)[1].strip()
                funcs[name] = 0
            elif name is not None and "HMMA" in line:
                funcs[name] += 1
        for fn, n in funcs.items():
            print(f"  SASS {fn}: {n} HMMA")
        tc = [n for fn, n in funcs.items() if kernel in fn]
        check(res.returncode == 0 and len(tc) == 1 and tc[0] > 0,
              f"bf16 {lib} ({kernel}) runs mma.sync: HMMA in its SASS")


def phase_kernels(cfg, params_np, peaks, frames=(403, 396, 5), dtypes=None):
    """Each kernel against its plain version at the medium voice's
    shapes, rows of these frame counts; returns the per-kernel numbers
    by (kernel, dtype). The default rows are ragged (F not a multiple of
    any tile)."""
    import torch

    from piper_tpu_torch.models.vits import generator as G
    from piper_tpu_torch.ops.cuda import vocoder as V
    from piper_tpu_torch.runtime.voice import _fp32_exact
    from piper_tpu_torch.weights.bridge import params_from_jax

    bf16_peak, f32_peak, bw = peaks
    ks = tuple(cfg.resblock_kernel_sizes)
    ds = tuple(tuple(d) for d in cfg.resblock_dilation_sizes)
    rb = cfg.resblock
    frames = list(frames)
    results = {}
    for dtype in dtypes or (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        atol, rtol = TOL[dname]
        dec = params_from_jax(params_np, cfg, "cuda", dtype)["dec"]
        tm = G.prepare_tm(dec, cfg, dtype)
        x0, lens0 = stage_inputs(cfg, frames, dtype, seed=11)
        b, esize = x0.shape[0], x0.element_size()
        ctx = _fp32_exact() if dtype == torch.float32 else contextlib.nullcontext()
        with ctx, torch.inference_mode():
            # --- mrf_fused, stage 0 ---
            pw, pb = tm["mrf"][0]
            kw = dict(kernel_sizes=ks, dilation_sizes=ds, resblock_type=rb)
            got = V.mrf_fused(x0, lens0, pw, pb, **kw)
            ref = V.mrf_fused_plain(x0, lens0, pw, pb, **kw)
            torch.cuda.synchronize()
            err0 = (got.float() - ref.float()).abs().max().item()
            ok0 = bool(torch.allclose(got.float(), ref.float(), atol=atol, rtol=rtol))
            check(ok0, f"mrf_fused stage 0 {dname} (frames {frames}): max_abs_err {err0:.3e} (atol {atol}, rtol {rtol})")
            ms0 = time_ms(lambda: V.mrf_fused(x0, lens0, pw, pb, **kw))
            plain0 = time_ms(lambda: V.mrf_fused_plain(x0, lens0, pw, pb, **kw), reps=3)
            lib0 = time_ms(lambda: lib_mrf(dec["resblocks"][0], x0, lens0, cfg))
            c0 = x0.shape[1]
            flops0 = work_mrf(cfg, c0, int(lens0.sum()))
            bytes0 = 2 * x0.numel() * esize + pw.numel() * esize + pb.numel() * 4 + 4 * b
            # --- fused_upsample_mrf, stage 1 alone and stages 1 -> 2 ---
            x1 = got.contiguous()
            u1, k1 = cfg.upsample_rates[1], cfg.upsample_kernel_sizes[1]
            u2, k2 = cfg.upsample_rates[2], cfg.upsample_kernel_sizes[2]
            q1 = G._tm_phase_plan(k1, u1)[0]
            q2 = G._tm_phase_plan(k2, u2)[0]
            lens1, lens2 = lens0 * u1, lens0 * u1 * u2
            w1, w2 = tm["mrf"][1], tm["mrf"][2]

            def stage1(fn, x):
                return fn(x, lens1, tm["ups"][1], tm["ups_b"][1], w1[0], w1[1], None,
                          u=u1, u_in=1, q0=q1, post=False, **kw)

            def stage2(fn, y):
                return fn(y, lens2, tm["ups"][2], tm["ups_b"][2], w2[0], w2[1], tm["post"],
                          u=u2, u_in=u1, q0=q2, post=True, **kw)

            y_k = stage1(V.fused_upsample_mrf, x1)
            y_p = stage1(V.fused_upsample_mrf_plain, x1)
            torch.cuda.synchronize()
            err1 = (y_k.float() - y_p.float()).abs().max().item()
            ok1 = bool(torch.allclose(y_k.float(), y_p.float(), atol=atol, rtol=rtol))
            check(ok1, f"fused_upsample_mrf stage 1 {dname} (frames {frames}): max_abs_err {err1:.3e}")
            w_k = stage2(V.fused_upsample_mrf, y_k)
            w_p = stage2(V.fused_upsample_mrf_plain, y_p)
            torch.cuda.synchronize()
            err2 = (w_k.float() - w_p.float()).abs().max().item()
            ok2 = bool(torch.allclose(w_k.float(), w_p.float(), atol=atol, rtol=rtol))
            check(ok2, f"fused_upsample_mrf stages 1->2 {dname} (frames {frames}): max_abs_err {err2:.3e}")
            ms1 = time_ms(lambda: stage1(V.fused_upsample_mrf, x1))
            ms2 = time_ms(lambda: stage2(V.fused_upsample_mrf, y_k))
            plain12 = time_ms(lambda: stage2(V.fused_upsample_mrf_plain, stage1(V.fused_upsample_mrf_plain, x1)), reps=3)

            def lib1():
                return lib_stage(dec["ups"][1], dec["resblocks"][1], None, x1, lens1, u1, k1, cfg)

            def lib2(y):
                return lib_stage(dec["ups"][2], dec["resblocks"][2], dec["conv_post"]["w"], y, lens2, u2, k2, cfg)

            y_lib = lib1()
            lib12 = time_ms(lambda: lib2(lib1()))
            lib_s1 = time_ms(lib1)
            lib_s2 = time_ms(lambda: lib2(y_lib))
            c1, c2 = c0 // 2, c0 // 4
            n1, n2 = int(lens1.sum()), int(lens2.sum())
            flops1 = 2 * (k1 // u1) * c0 * c1 * n1 + work_mrf(cfg, c1, n1)
            flops2 = 2 * (k2 // u2) * c1 * c2 * n2 + work_mrf(cfg, c2, n2) + 2 * 7 * c2 * n2
            flops12 = flops1 + flops2
            bytes1 = (x1.numel() + y_k.numel() + tm["ups"][1].numel() + w1[0].numel()) * esize + 4 * (
                w1[1].numel() + c1)
            bytes2 = (y_k.numel() + w_k.numel() + tm["ups"][2].numel() + w2[0].numel()
                      + tm["post"].numel()) * esize + 4 * (w2[1].numel() + c2)
            bytes12 = bytes1 + bytes2
        peak = f32_peak if dtype == torch.float32 else bf16_peak
        for sname, ms, lib, flops, nbytes in (("stage 1", ms1, lib_s1, flops1, bytes1),
                                              ("stage 2", ms2, lib_s2, flops2, bytes2)):
            bound = max(flops / peak, nbytes / bw) * 1e3
            print(f"fused_upsample_mrf {sname} {dname} (frames {frames}): kernel {ms:.3f} ms, cuDNN composition of the stage "
                  f"{lib:.3f} ms, bound {bound:.4f} ms, {flops / ms / 1e9:.2f} TFLOP/s achieved, "
                  f"{100 * bound / ms:.2f}% of the bound", flush=True)
        print(f"fused_upsample_mrf {dname} (frames {frames}): stages 1+2 kernel {ms1 + ms2:.3f} ms vs cuDNN composition "
              f"{lib12:.3f} ms ({'faster' if ms1 + ms2 < lib12 else 'SLOWER'})", flush=True)
        for kname, ms, plain, lib, flops, nbytes, err, src, rep in (
            ("mrf_fused", ms0, plain0, lib0, flops0, bytes0, err0,
             "piper_tpu_torch/csrc/mrf_fused.cu", "piper_tpu/ops/pallas/vocoder.py:286"),
            ("fused_upsample_mrf", ms1 + ms2, plain12, lib12, flops12, bytes12, max(err1, err2),
             "piper_tpu_torch/csrc/fused_upsample_mrf.cu", "piper_tpu/ops/pallas/vocoder.py:693"),
        ):
            t_ops, t_bytes = flops / peak * 1e3, nbytes / bw * 1e3
            row = {
                "name": kname, "route": "cuda", "source": src, "replaces": rep,
                "max_abs_err": err, "ms": ms, "plain_ms": plain,
                "bound_ms": max(t_ops, t_bytes),
                "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                "library_ms": lib, "gflop": flops / 1e9, "mbytes": nbytes / 1e6,
            }
            print(f"{kname} {dname} (B={b}, frames {frames}): kernel {ms:.3f} ms, "
                  f"plain {plain:.3f} ms, cuDNN composition {lib:.3f} ms, bound "
                  f"{row['bound_ms']:.4f} ms ({row['bound_by']}; {flops / 1e9:.2f} GFLOP, "
                  f"{nbytes / 1e6:.2f} MB), {flops / ms / 1e9:.1f} TFLOP/s achieved"
                  + (f" (stage 1 {ms1:.3f} ms + stage 2 {ms2:.3f} ms)" if kname != "mrf_fused" else ""),
                  flush=True)
            results[(kname, dname)] = row
    return results


# ---------------------------------------------------------------------------
# Phase 3: the main path through the CLI entry point
# ---------------------------------------------------------------------------

TEXTS = [
    "The quick brown fox jumps over the lazy dog.",
    "A port runs on the card now. It has two kernels.",
    "Short one.",
    "Speech synthesis on a GPU, sentence by sentence, with a fixed seed.",
]


def run_cli(argv, lines):
    """python -m piper_tpu_torch, in this process (so the launch counts
    are visible here), with `lines` on stdin."""
    from piper_tpu_torch.__main__ import main as cli_main

    saved = sys.stdin
    sys.stdin = io.StringIO("".join(line + "\n" for line in lines))
    try:
        cli_main(argv)
    finally:
        sys.stdin = saved


def read_wav(path):
    import numpy as np

    raw = Path(path).read_bytes()
    with wave.open(str(path), "rb") as w:
        sr, n = w.getframerate(), w.getnframes()
        pcm = np.frombuffer(w.readframes(n), np.int16)
    return raw, sr, pcm


def make_voice(tmp: Path):
    """Random-weight medium voice (.npz + .json, text phonemes)."""
    from piper_tpu_torch.config import ModelConfig
    from piper_tpu_torch.models.vits.model import init_synthesizer_params
    from piper_tpu_torch.runtime.voice import random_voice_config
    from piper_tpu_torch.weights.native import save_native

    cfg = ModelConfig.for_quality("medium", num_symbols=256)
    params = init_synthesizer_params(1, cfg)
    save_native(str(tmp / "voice.npz"), params, cfg)
    (tmp / "voice.npz.json").write_text(json.dumps(random_voice_config(cfg).to_dict()))
    return cfg, params


def phase_main_path(tmp: Path, cfg, params_np, card: str):
    import numpy as np
    import torch

    from piper_tpu_torch.models.vits import generator as G
    from piper_tpu_torch.ops.cuda import vocoder as V
    from piper_tpu_torch.runtime.voice import TorchVoice, _fp32_exact
    from piper_tpu_torch.weights.bridge import params_from_jax

    voice = str(tmp / "voice.npz")
    out_a, out_b, out_1 = tmp / "a", tmp / "b", tmp / "one"
    V.mrf_fused.launches = 0
    V.fused_upsample_mrf.launches = 0
    t0 = time.perf_counter()
    run_cli(["-m", voice, "-d", str(out_a), "--batch", "--seed", "1"], TEXTS)
    cli_s = time.perf_counter() - t0
    launches = {"mrf_fused": V.mrf_fused.launches,
                "fused_upsample_mrf": V.fused_upsample_mrf.launches}
    print(f"main path (CLI --batch, {len(TEXTS)} lines, cold): {cli_s:.3f} s, launches {launches}")
    check(launches["mrf_fused"] >= 1 and launches["fused_upsample_mrf"] == 2 * launches["mrf_fused"],
          "main path launched mrf_fused once and fused_upsample_mrf twice per vocode")

    wavs = sorted(out_a.glob("*.wav"))
    check(len(wavs) == len(TEXTS), f"{len(wavs)} WAVs for {len(TEXTS)} lines")
    u = cfg.upsample_factor
    for p in wavs:
        raw, sr, pcm = read_wav(p)
        check(raw[:4] == b"RIFF" and raw[8:12] == b"WAVE" and sr == 22050
              and len(pcm) > 0 and len(pcm) % u == 0 and int(np.abs(pcm).max()) > 0,
              f"{p.name}: RIFF/WAVE, {sr} Hz, {len(pcm)} samples ({len(pcm) // u} frames), non-zero")

    run_cli(["-m", voice, "-d", str(out_b), "--batch", "--seed", "1", "-q"], TEXTS)
    same = all((out_a / p.name).read_bytes() == (out_b / p.name).read_bytes() for p in wavs)
    check(same, "same seed, same bytes (two CLI runs)")

    run_cli(["-m", voice, "-d", str(out_1), "--batch", "--seed", "1", "-q"], TEXTS[1:2])
    _, _, alone = read_wav(out_1 / "0000.wav")
    _, _, in_batch = read_wav(out_a / "0001.wav")
    n_diff = -1 if len(alone) != len(in_batch) else int(np.abs(alone.astype(np.int32) - in_batch).max())
    print(f"row alone vs in batch (fast): {len(alone)} vs {len(in_batch)} samples, "
          f"max |diff| {n_diff} of 32767")
    check(n_diff == 0, "a row alone equals the same row inside the batch")

    # time-major generator (kernels) against the plain generator (cuDNN), f32
    with _fp32_exact(), torch.inference_mode():
        dec = params_from_jax(params_np, cfg, "cuda", torch.float32)["dec"]
        tm = G.prepare_tm(dec, cfg, torch.float32)
        frames = torch.tensor([97, 60, 9], dtype=torch.int32)
        g = torch.Generator().manual_seed(5)
        mask = (torch.arange(97)[None, :] < frames[:, None])[..., None].float()
        z = (torch.randn((3, 97, cfg.inter_channels), generator=g) * mask).cuda()
        ref = G.generator_apply(dec, z, mask.cuda(), cfg=cfg)
        got = G.generator_tm_apply(dec, tm, z, frames.cuda(), cfg=cfg)
        err = max((got[i, : int(n) * u] - ref[i, : int(n) * u]).abs().max().item()
                  for i, n in enumerate(frames))
    check(err < 1e-4, f"generator_tm_apply (kernels) vs generator_apply (cuDNN), float32: "
                      f"max_abs_err {err:.3e} on valid samples (atol 1e-4)")

    # the card against the CPU: parity precision, one short utterance
    ids = [[1, 0] + [40 + (7 * i) % 50 for i in range(30)] + [0, 2]]
    outs = {}
    for dev in ("cpu", "cuda"):
        v = TorchVoice(params_np, cfg, _voice_cfg(cfg), precision="parity", device=dev)
        outs[dev] = v.synthesize_ids_batch(ids, syn=_syn(seed=3))[0]
    n = min(len(outs["cpu"]), len(outs["cuda"]))
    err_dev = float(np.abs(outs["cpu"][:n] - outs["cuda"][:n]).max()) if n else math.inf
    check(len(outs["cpu"]) == len(outs["cuda"]) and err_dev < 1e-3,
          f"card vs CPU, parity, {len(outs['cuda'])} samples: max_abs_err {err_dev:.3e} "
          "(atol 1e-3: float32 sums in another order through 14 flow and 46 conv layers)")

    # warm batch: 16 rows, about 400 frames each
    fast = TorchVoice(params_np, cfg, _voice_cfg(cfg), precision="fast", device="cuda")
    rng = np.random.default_rng(0)
    rows = [[1, 0] + [int(t) for t in rng.integers(3, 256, 250)] + [0, 2] for _ in range(16)]
    fast.synthesize_ids_batch(rows, syn=_syn(seed=7))  # warm-up
    times, audio_s = [], 0.0
    for _ in range(3):
        t0 = time.perf_counter()
        audios = fast.synthesize_ids_batch(rows, syn=_syn(seed=7))
        times.append(time.perf_counter() - t0)
        audio_s = sum(len(a) for a in audios) / cfg.audio.sample_rate
    best = min(times)
    frames_per_row = [len(a) // u for a in audios]
    print(f"warm batch, fast, 16 rows x {min(frames_per_row)}-{max(frames_per_row)} frames "
          f"({audio_s:.2f} audio-s): wall {sorted(times)} s, best {best:.4f} s, "
          f"{audio_s / best:.1f} audio-s/s, RTF {best / audio_s:.5f}  [{card}]", flush=True)
    profile_batch(fast, rows)
    return launches


def _voice_cfg(cfg):
    from piper_tpu_torch.runtime.voice import random_voice_config

    return random_voice_config(cfg)


def _syn(seed):
    from piper_tpu_torch.config import SynthesisConfig

    return SynthesisConfig(seed=seed)


def profile_batch(voice, rows):
    """Device time by kernel over one warm batch (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        voice.synthesize_ids_batch(rows, syn=_syn(seed=7))
        wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages() if getattr(e, "device_type", None) is not None
              and str(e.device_type).endswith("CUDA")]
    dev_total = sum(e.self_device_time_total for e in events) / 1e3
    print(f"profile of one warm batch: wall {wall * 1e3:.2f} ms, device busy "
          f"{dev_total:.2f} ms ({100 * dev_total / (wall * 1e3):.1f}% of wall)")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<4d} {e.key[:90]}")


# ---------------------------------------------------------------------------
# Phase 4: the serving path (HTTP server, batcher, streaming)
# ---------------------------------------------------------------------------

WINDOW_ROUNDS = 20  # GETs per client in the measurement window (16 clients)
STREAMS = 24  # warm /stream requests timed one after another
STREAM_TEXT = ("Streaming speech from the card arrives chunk by chunk while the rest of "
               "the sentence is still being decoded on the device")


def http_get(port, path, data=None, headers=None):
    """(status, headers, body, seconds) of one request to the local server."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data, headers=headers or {})
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=300) as resp:
            body = resp.read()
            return resp.status, dict(resp.headers), body, time.perf_counter() - t0
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read(), time.perf_counter() - t0


def http_stream(port, path):
    """GET a chunked /stream; returns (headers, chunk payloads, seconds to
    the first chunk, seconds to the terminator), checking the HTTP/1.1
    framing of every chunk."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    t0 = time.perf_counter()
    conn.request("GET", path)
    resp = conn.getresponse()
    headers = dict(resp.getheaders())
    if resp.status != 200 or headers.get("Transfer-Encoding") != "chunked":
        conn.close()
        raise RuntimeError(f"/stream answered {resp.status} {headers}")
    chunks, first = [], None
    while True:
        size_line = resp.fp.readline()
        if not size_line.endswith(b"\r\n"):
            raise RuntimeError(f"bad chunk size line {size_line!r}")
        size = int(size_line, 16)
        payload = resp.fp.read(size)
        if len(payload) != size or resp.fp.read(2) != b"\r\n":
            raise RuntimeError("truncated chunk")
        if size == 0:
            break
        if first is None:
            first = time.perf_counter() - t0
        chunks.append(payload)
    total = time.perf_counter() - t0
    conn.close()
    return headers, chunks, first, total


def wav_pcm(raw):
    import numpy as np

    with wave.open(io.BytesIO(raw), "rb") as w:
        return w.getframerate(), np.frombuffer(w.readframes(w.getnframes()), np.int16)


def profile_stream(port, path):
    """Device time by kernel over one warm /stream (torch.profiler; the
    server's threads launch, CUPTI sees every kernel of the process)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, chunks, first, total = http_stream(port, path)
    events = [e for e in prof.key_averages() if getattr(e, "device_type", None) is not None
              and str(e.device_type).endswith("CUDA")]
    dev_total = sum(e.self_device_time_total for e in events) / 1e3
    print(f"profile of one warm /stream ({len(chunks)} chunks): wall {total * 1e3:.2f} ms (first chunk "
          f"{first * 1e3:.2f} ms), device busy {dev_total:.2f} ms ({100 * dev_total / (total * 1e3):.1f}% "
          "of wall)")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<4d} {e.key[:90]}")


def phase_serving(cfg, params_np, card, peaks):
    """The HTTP server with the batcher on a fast voice on the card."""
    import base64
    import threading
    import urllib.parse

    import numpy as np
    import torch

    from piper_tpu_torch.models.vits import model as M
    from piper_tpu_torch.ops.cuda import vocoder as V
    from piper_tpu_torch.runtime.batching import group_by_bucket, pick_bucket
    from piper_tpu_torch.runtime.streaming import StreamingDecoder
    from piper_tpu_torch.runtime.voice import TorchVoice, utterance_seed
    from piper_tpu_torch.server.batcher import CoalescingBatcher
    from piper_tpu_torch.server.http_server import serve

    voice = TorchVoice(params_np, cfg, _voice_cfg(cfg), precision="fast", device="cuda", seed=0)
    t0 = time.perf_counter()
    voice.warmup((1, 16), full=True)
    print(f"serving: warmup((1, 16), full=True) {time.perf_counter() - t0:.3f} s")
    # every phrase of the burst below in one batch, against each alone:
    # the largest composition the batcher can form, fixed (the burst's
    # own windows vary from run to run)
    phrases, seeds = [], []
    for i in range(16):
        for sentence in voice.phonemize(TEXTS[i % len(TEXTS)]):
            for ids, _ in voice._phrases(sentence, _syn(seed=i)):
                phrases.append(ids)
                seeds.append(i)
    together = voice.collect(voice.submit(phrases, row_seeds=seeds))
    same = sum(np.array_equal(t, voice.synthesize_ids_batch([p], syn=_syn(seed=s))[0])
               for t, p, s in zip(together, phrases, seeds))
    check(same == len(phrases), f"{same} of {len(phrases)} phrases in one batch of {len(phrases)} equal "
                                "the phrase alone, bit for bit")
    voice.batcher = CoalescingBatcher(voice, window_ms=4.0, max_batch=16)
    server = serve(voice, host="127.0.0.1", port=0)
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        for path in ("/health", "/metrics"):
            status, _, body, _ = http_get(port, path)
            check(status == 200 and isinstance(json.loads(body), dict), f"GET {path} answers: {body[:120]!r}")

        # 16 concurrent GETs, each against the same request served alone
        paths = [f"/?text={urllib.parse.quote(TEXTS[i % len(TEXTS)])}&seed={i}" for i in range(16)]
        alone = [http_get(port, p) for p in paths]
        solo = sorted(a[3] for a in alone)
        print(f"serving: 16 GETs one at a time (smoke observation, 16 samples): latency p50 "
              f"{np.percentile(solo, 50):.4f} s, max {solo[-1]:.4f} s  [{card}]", flush=True)
        # (rows, decodes, seconds in submit) of each batch the batcher
        # sends; a decode is one phoneme bucket's encode and vocode
        submits = []
        submit = voice.submit

        def timed_submit(ids_list, **kw):
            t0 = time.perf_counter()
            handle = submit(ids_list, **kw)
            decodes = len(group_by_bucket([len(ids) for ids in ids_list], voice.phoneme_buckets))
            submits.append((len(ids_list), decodes, round(time.perf_counter() - t0, 4)))
            return handle

        def check_launches(what):
            n_mrf, n_fused = V.mrf_fused.launches, V.fused_upsample_mrf.launches
            decodes = sum(d for _, d, _ in submits)
            check(decodes >= 1 and n_mrf == decodes and n_fused == 2 * decodes,
                  f"{what} launched mrf_fused {n_mrf} and fused_upsample_mrf {n_fused} times for "
                  f"{decodes} decodes in {len(submits)} batches (once and twice per decode)")

        def reset_counts():
            submits.clear()
            V.mrf_fused.launches = 0
            V.fused_upsample_mrf.launches = 0

        voice.submit = timed_submit

        def clients(n_clients, rounds):
            """n_clients threads, each sending `rounds` GETs one after
            another (client i's k-th is paths[(i + k) % 16]); returns
            [(path index, (status, headers, body, s))] and the wall."""
            got = [[] for _ in range(n_clients)]
            barrier = threading.Barrier(n_clients)

            def client(i):
                barrier.wait()
                for k in range(rounds):
                    j = (i + k) % len(paths)
                    got[i].append((j, http_get(port, paths[j])))

            threads = [threading.Thread(target=client, args=(i,)) for i in range(n_clients)]
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=300)
            return [r for rs in got for r in rs], time.perf_counter() - t0

        # two bursts of 16 concurrent GETs: correctness checks; their times
        # are smoke observations (16 samples each)
        for run in ("first", "second"):
            before = dict(voice.batcher.stats)
            reset_counts()
            got, wall = clients(16, 1)
            batches = voice.batcher.stats["batches"] - before["batches"]
            n_ok = sum(g[0] == 200 for _, g in got)
            check(len(got) == 16 and n_ok == 16,
                  f"{run} burst of 16 concurrent GETs of /: 16 sent, {n_ok} succeeded, {16 - n_ok} failed")
            if n_ok == 16:
                wavs_ok = all(wav_pcm(g[2])[0] == 22050 and len(wav_pcm(g[2])[1]) > 0 for _, g in got)
                check(wavs_ok, "every response is a 22,050 Hz WAV with samples")
                same = sum(g[2] == alone[j][2] for j, g in got)
                check(same == 16, f"{same} of 16 concurrent responses equal the same request served alone")
                lat = sorted(g[3] for _, g in got)
                print(f"serving: {run} burst (smoke observation, 16 samples), 16 concurrent GETs in "
                      f"{wall:.4f} s, latency min {lat[0]:.4f} s, max {lat[-1]:.4f} s; {batches} batches, "
                      f"(rows, decodes, s in submit) {submits}  [{card}]", flush=True)
            check(0 < batches < 16, f"the batcher coalesced: {batches} batches for 16 requests")
            check_launches(f"the {run} burst")

        # the measurement window: 16 clients in a closed loop at the burst's
        # mix, WINDOW_ROUNDS requests each
        before = dict(voice.batcher.stats)
        reset_counts()
        got, wall = clients(16, WINDOW_ROUNDS)
        batches = voice.batcher.stats["batches"] - before["batches"]
        n = len(got)
        n_ok = sum(g[0] == 200 for _, g in got)
        same = sum(g[0] == 200 and g[2] == alone[j][2] for j, g in got)
        check(n == 16 * WINDOW_ROUNDS and n_ok == n and same == n,
              f"window: {n} GETs sent, {n_ok} succeeded, {same} equal the request served alone")
        check_launches("the window")
        lat = np.array([g[3] for _, g in got])
        rows = [r for r, _, _ in submits]
        print(f"serving: window of {n} GETs from 16 closed-loop clients in {wall} s: {n / wall} requests/s, "
              f"latency p50 {np.percentile(lat, 50)} s, p99 {np.percentile(lat, 99)} s, max {lat.max()} s; "
              f"{batches} batches, rows per batch mean {np.mean(rows) if rows else 0:.2f}, "
              f"decodes per batch mean {np.mean([d for _, d, _ in submits]) if submits else 0:.2f}, "
              f"s in submit p50 {np.percentile([t for _, _, t in submits], 50) if submits else 0}  [{card}]",
              flush=True)
        voice.submit = submit

        status, _, body, _ = http_get(port, "/batch?seed=3", data=json.dumps({"texts": TEXTS}).encode(),
                                      headers={"Content-Type": "application/json"})
        wavs = json.loads(body)["wavs"] if status == 200 else []
        check(len(wavs) == len(TEXTS) and all(wav_pcm(base64.b64decode(w))[0] == 22050 for w in wavs),
              f"POST /batch: {len(wavs)} WAVs for {len(TEXTS)} texts")

        # /stream: cold (first stream of the process), then STREAMS warm
        q = f"/stream?text={urllib.parse.quote(STREAM_TEXT)}&seed=4"
        _, cold_chunks, cold_first, cold_total = http_stream(port, q)
        V.mrf_fused.launches = 0
        V.fused_upsample_mrf.launches = 0
        headers, chunks, first, total = http_stream(port, q)
        n_mrf, n_fused = V.mrf_fused.launches, V.fused_upsample_mrf.launches
        pcm = np.frombuffer(b"".join(chunks), "<i2")
        ids = voice.phonemes_to_ids(voice.phonemize(STREAM_TEXT)[0])
        batched = voice.synthesize_ids_batch([ids], syn=_syn(seed=4))[0]
        audio_s = len(pcm) / cfg.audio.sample_rate
        check(headers.get("X-Sample-Rate") == "22050" and len(chunks) >= 3 and chunks == cold_chunks,
              f"/stream: {len(chunks)} chunks, framing parsed, same bytes cold and warm")
        check(len(pcm) == len(batched), f"/stream: {len(pcm)} samples, batch path {len(batched)}")
        check(n_mrf == len(chunks) and n_fused == 2 * len(chunks),
              f"/stream launched mrf_fused {n_mrf} and fused_upsample_mrf {n_fused} times for "
              f"{len(chunks)} chunks")
        firsts, totals, same = [first], [total], 1
        for _ in range(STREAMS - 1):
            _, c, f, t = http_stream(port, q)
            firsts.append(f)
            totals.append(t)
            same += c == chunks
        check(same == STREAMS, f"{same} of {STREAMS} warm streams give the same bytes")
        print(f"serving: /stream of {audio_s} audio-s in {len(chunks)} chunks, {STREAMS} warm streams one "
              f"after another: time to first chunk p50 {np.percentile(firsts, 50)} s, p99 "
              f"{np.percentile(firsts, 99)} s, max {max(firsts)} s; whole stream p50 "
              f"{np.percentile(totals, 50)} s, {audio_s / np.percentile(totals, 50)} audio-s/s at the p50; "
              f"cold (first stream of the process, one sample): first chunk {cold_first} s, whole "
              f"{cold_total} s  [{card}]", flush=True)
        profile_stream(port, q)
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
        voice.batcher.close()

    # the seams: streaming in parity precision against one whole decode
    parity = TorchVoice(params_np, cfg, _voice_cfg(cfg), precision="parity", device="cuda", seed=0)
    key = utterance_seed(4, ids)
    with torch.inference_mode(), parity._precision():
        bucket = pick_bucket(len(ids), parity.phoneme_buckets)
        enc, frames = parity._encode([ids], [key], bucket, _syn(seed=4), None)
        z_p, y_mask = parity._latents(enc, [key], frames[0], _syn(seed=4))
        whole = M.synthesizer_vocode(parity.params, z_p, y_mask, cfg=cfg)[0].float().cpu().numpy()
    streamed = np.concatenate(list(StreamingDecoder(parity).stream(z_p, frames[0])))
    err = np.abs(streamed - whole[: len(streamed)])
    p99, mean = float(np.percentile(err, 99)), float(err.mean())
    check(len(streamed) == len(whole) and p99 < 5e-3 and mean < 1e-3,
          f"streamed vs whole decode, parity, {frames[0]} frames: p99 {p99:.3e} (< 5e-3), "
          f"mean {mean:.3e} (< 1e-3), max {err.max():.3e}")

    # both bf16 kernels at a streamed chunk's shapes: 45 + 2 x 10 frames,
    # and the final chunk of 1 frame with 10 frames of left context
    for frames_chunk in ((65,), (11,)):
        phase_kernels(cfg, params_np, peaks, frames=frames_chunk, dtypes=(torch.bfloat16,))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from piper_tpu_torch.ops.cuda import vocoder as V

    # 1. the card, versions, kernel build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    part, peaks = peaks_for(name)
    print(smi)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {name} "
          f"({torch.cuda.get_device_properties(0).multi_processor_count} SMs); "
          f"peaks used for bounds: {part} {peaks}")
    t0 = time.perf_counter()
    V.build()
    print(f"kernel build (nvcc, both sources in parallel): {time.perf_counter() - t0:.2f} s")
    for n, log in V.BUILD_LOG.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line or "Compiling entry" in line:
                print(f"  {n}: {line.strip()}")
    sass_tensor_cores(V)

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        cfg, params_np = make_voice(tmp)
        # 2. kernels against plain versions
        results = phase_kernels(cfg, params_np, peaks)
        # 3. main path
        launches = phase_main_path(tmp, cfg, params_np, smi)
        # 4. serving path
        phase_serving(cfg, params_np, smi, peaks)

    kernels = []
    for kname in ("mrf_fused", "fused_upsample_mrf"):
        row = dict(results[(kname, "bfloat16")])
        row["launches"] = launches[kname]
        for key in ("gflop", "mbytes"):
            row.pop(key)
        kernels.append(row)
    if FAILURES:
        print(f"chip_smoke: {len(FAILURES)} check(s) failed:", *FAILURES, sep="\n  ", file=sys.stderr)
        return 1
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
