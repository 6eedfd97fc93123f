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
     speed of a warm batch; then python -m piper_tpu_torch.benchmark
     --batch on the same voice (the reference's JSONL protocol; its
     warm-up captures every CUDA graph its timed runs replay);
  4. the serving path: the HTTP server in this process with the
     coalescing batcher on, after a full warm-up (the CUDA graphs of
     every encode shape, the frame windows and the streamed chunk: their
     capture time and memory, and each graph kind's replay against its
     eager run, bit for bit); /health and /metrics; two bursts of 16 concurrent GETs of /
     (each equal to the same request served alone, fewer batches than
     requests, one mrf_fused and two fused_upsample_mrf launches per
     decode of the batch's plan); a measurement window of 320 GETs from
     16 closed-loop clients under decode_grouping uniform and bucketed
     (p50/p99 latency, requests/s, every response checked, the batches
     on the speculative path, submit's host time by span, the device's
     idle share from a profiled rerun); POST
     /batch; a chunked /stream (framing, sample count, one replay of the
     chunk graph with one mrf_fused and two fused_upsample_mrf launches
     per chunk) cold and 24 times warm (time to first chunk p50/p99);
     /streams on 4 threads while 16 clients' GETs are coalesced (every
     response equal to the request alone: the graphs share one memory
     pool); the seams of streaming in parity precision against one
     whole decode; both bf16 kernels at the streaming chunk's shape;
  5. published voices: phase 3's voice written as a piper_train .ckpt
     (the port's state_dict_from_params) and as a registry voice (the
     whole VITS graph from the port's exporter, onnx_io.export_onnx_voice;
     sidecar; voices.json), each format's load time, and
     python -m piper_tpu_torch -m voice.ckpt and -m <registry name> with
     phase 3's lines and seed: the .npz run's WAVs byte for byte, with
     urlopen made to raise; the trained two-speaker x-low voice behind
     the server with the batcher in both precisions (64 GETs from 8
     clients alternating speaker_id, each equal to the request alone,
     requests/s; the speakers differ; an unknown speaker answered 400);
     one medium row of ~12,000 frames (past the 4096-frame ladder) in
     both precisions (full length, one decode, peak memory, wall), and
     both kernels against their plain versions at B = 1 and its length;
  6. VITS2 and MB-iSTFT voices at the medium preset's full width, written
     as .npz through the port's init_synthesizer_params and save_native:
     a two-speaker VITS2 voice (flow_transformer and speaker_cond_encoder;
     its flows' zero-initialised post perturbed, or the flow's attention
     would change nothing) and a one-speaker MB-iSTFT voice. For each:
     python -m piper_tpu_torch -m voice.npz --batch --seed 1 (WAV checks,
     same bytes twice, one mrf_fused and two fused_upsample_mrf launches
     per decode for VITS2, none for MB-iSTFT, whose generator runs every
     op on the card), the card against the port on the CPU in parity
     (1e-3), the server with the batcher in both precisions after
     warmup((1, 16), full=True) (64 GETs from 8 clients, each equal to
     the request alone; VITS2: speaker_id alternating, the speakers
     differ), each graph kind's replay against its eager run, a parity
     /stream against the port's CPU chunks (1e-3; the seams printed as an
     observation), and a warm 16-row batch's device time beside phase 3's
     HiFiGAN voice's;
  7. training on the card: a synthetic dataset directory in
     preprocess's layout (16 utterances of 1.5-4 s at 22,050 Hz, 30-90
     ids, spectrograms from ops/stft.spectrogram); the seeded noise of
     fixed keys on the card against the CPU (threefry bits equal,
     normals within 1e-6); each training module on the card against the
     port on the CPU in float32 (values and gradients, 1e-3 of the
     largest), MAS against maximum_path_numpy; one train_step at the
     medium preset's full width, batch 2, card against CPU (every loss
     within rtol 1e-3, equal MAS durations and segment starts); the
     warm step time in both precisions at batch 8 with MAS's share and
     the peak memory; one step each of a VITS2 and an MB-iSTFT model at
     medium width (finite losses); python -m piper_tpu_torch.train in
     this process (4 steps at one bucket shape with a checkpoint, a
     validation pass through infer and an export, then --resume to 6)
     and the exported voice through python -m piper_tpu_torch (WAV
     checks). No kernel of the port runs in the
     training step (nor a Pallas kernel in the JAX one); the validation
     pass's infer runs both;
  8. the voice builder's path: a synthetic LJSpeech corpus (8 voiced
     bursts between stretches of silence, 22,050 Hz) through python -m
     piper_tpu_torch.train.preprocess at 16 kHz with --max-workers 4
     (every file trimmed by the Silero VAD, not to nothing; the same
     files as a --max-workers 1 run) and the host's seconds per
     audio-minute for resampling, the VAD and the spectrograms; python
     -m piper_tpu_torch.train for 2 steps at the x-low preset on that
     directory (voice_2.npz); phase 3's medium voice through python -m
     piper_tpu_torch.export --format onnx (seconds, MiB) and that .onnx
     through the CLI with --seed 1 (the .npz's WAVs byte for byte in
     both precisions); python -m piper_tpu_torch.infer --batch --seed 1
     on the .onnx with and without --denoiser-strength 0.005 (the card
     against the CPU in parity within 1e-3, 1 + 2 kernel launches per
     decode, the RTF with and without the denoiser); python -m
     piper_tpu_torch.tools.voice_conversion with the trained two-speaker
     x-low voice, a WAV of speaker 0 from the CLI -> speaker 1, --seed 3
     (card against CPU within 1e-3, the same bytes twice, 1 + 2 launches
     per conversion, wall and device ms per audio-second);
  9. speculative serving, fast precision: the medium voice, the VITS2
     voice of phase 6 and the trained two-speaker x-low voice, each an
     exact batch of 8 rows (3 phoneme buckets) and then the same rows,
     which take the speculative path (the voice's path counter; no
     frames_wait span in that submit) and give the exact int16 audio
     bit for bit; the mu-law wire (the exact and the speculative
     transfers' rows are the numpy encoder's bytes of the int16 audio,
     the header's frame counts the exact ones; the CLI's --output-raw
     --raw-format mulaw --wire-format mulaw); a forced bucket overflow,
     a forced margin shortfall and a row past the ladder, each the exact
     audio, with 1 + 2 launches per decode and re-decode; the estimator
     snapshot (written outside the checkout under $PIPER_TPU_CACHE, set
     to the smoke's temporary directory) loaded by a fresh process whose
     first batch goes speculative, and a corrupt one deleted and ignored;
 10. dispatch fusion, fast precision: phase 9's rows on the same three
     voices, on each wire: three plans (the rows under two seed sets;
     the estimate pinned at 0.5 frames per id, a bucket overflow; the
     margin pinned at 0.25, a shortfall) each seen twice on the
     per-decode path, then each plan's third batch capturing its graph
     and the next one replaying it, the first plan again after the
     other plans' batches: the
     per-decode bits (the exact bits for the misses, re-decodes and
     re-fetches included), `fused` counted, 1 + 2 launches per decode and
     re-decode, no capture failed; submit's host time fused and
     per-decode, each plan's capture seconds and the graphs' memory.
     Phase 4's windows print the share of their batches that replayed a
     plan graph and fail on a failed capture.

Then the card's nvidia-smi line, one JSON line of per-kernel numbers
(launches summed over the CLI main paths of phases 3 and 6, the entry
points of phase 8, phase 9's batches and CLI runs and phase 10's
batches), and the device line. Every phase prints its
start, its end and its wall seconds; a phase that raises is a failed
check, and the failed checks are listed on stdout and on stderr before
a non-zero exit.

Needs one CUDA card; prints no result and exits non-zero without one.

    python3 chip_smoke.py --measure DIR

measures the checkout in DIR instead (see measure()): run it on this
checkout and on its parent, unpacked into a directory .gitignore lists,
in turns within one call, to compare two versions on one card. Its
line adds, where the checkout has them, each wire's transfer bytes per
audio-second, the window's batches by path (the fused ones among them),
the graphs after the window (count, MiB, plan graphs, the seconds of
each capture made in the window) and python -m piper_tpu_torch.tools.profile_stages's stage
times.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import os
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


@contextlib.contextmanager
def phase(name: str):
    """Print a phase's start, its end and its wall seconds; an exception
    inside it is a failed check (so a later phase still runs and the
    failure list names it)."""
    print(f"=== phase {name}: start", flush=True)
    t0 = time.perf_counter()
    try:
        yield
    except Exception as e:  # a phase that raised: record it, run the rest
        import traceback

        traceback.print_exc()
        check(False, f"phase {name} raised {type(e).__name__}: {e}")
    print(f"=== phase {name}: end, {time.perf_counter() - t0:.1f} s of wall", flush=True)


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
        with torch.inference_mode():
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
    from piper_tpu_torch.runtime.voice import TorchVoice
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
    with torch.inference_mode():
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
    settle(fast, rows, _syn(seed=7))
    paths0 = dict(fast.path_counts)
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
          f"{audio_s / best:.1f} audio-s/s, RTF {best / audio_s:.5f}; batches by path "
          f"{ {k: n - paths0[k] for k, n in fast.path_counts.items() if n != paths0[k]} }  [{card}]",
          flush=True)
    return launches, profile_batch(fast, rows)


def _voice_cfg(cfg):
    from piper_tpu_torch.runtime.voice import random_voice_config

    return random_voice_config(cfg)


def _syn(seed):
    from piper_tpu_torch.config import SynthesisConfig

    return SynthesisConfig(seed=seed)


def settle(voice, rows, syn, batches: int = 8) -> None:
    """`batches` batches of `rows`: the first takes the exact path, the
    estimate and the transfer margin settle (the margin after 4
    speculative batches), and the settled plan is seen 3 times and its
    graph captured, so later batches of the rows replay one plan graph."""
    for _ in range(batches):
        voice.synthesize_ids_batch(rows, syn=syn)


def profile_batch(voice, rows):
    """Device time by kernel over one warm batch (torch.profiler);
    returns the device ms."""
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
    return dev_total


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


def serve_in_process(voice):
    """The HTTP server on `voice` in this process, with the coalescing
    batcher (4 ms window, 16 rows): (server, port, thread)."""
    import threading

    from piper_tpu_torch.server.batcher import CoalescingBatcher
    from piper_tpu_torch.server.http_server import serve

    voice.batcher = CoalescingBatcher(voice, window_ms=4.0, max_batch=16)
    server = serve(voice, host="127.0.0.1", port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return server, server.server_address[1], thread


def stop_serving(server, thread, voice) -> None:
    server.shutdown()
    server.server_close()
    thread.join(timeout=30)
    voice.batcher.close()


def window_paths():
    """The window's 16 requests: 4 texts, seeds 0-15."""
    import urllib.parse

    return [f"/?text={urllib.parse.quote(TEXTS[i % len(TEXTS)])}&seed={i}" for i in range(16)]


def clients(port, paths, n_clients, rounds):
    """n_clients threads, each sending `rounds` GETs one after another
    (client i's k-th is paths[(i + k) % len(paths)]); returns
    [(path index, (status, headers, body, s))] and the wall."""
    import threading

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


def profiled_window(port, paths, rounds):
    """The window again under torch.profiler: (GETs, wall s, device busy
    s, the kernels' time summed)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        got, wall = clients(port, paths, 16, rounds)
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if str(getattr(e, "device_type", "")).endswith("CUDA")) / 1e6
    return len(got), wall, busy


def timed_streams(port, path, n):
    """n /streams one after another: (chunk payloads of each, seconds to
    the first chunk of each, seconds to the end of each)."""
    chunks, firsts, totals = [], [], []
    for _ in range(n):
        _, c, f, t = http_stream(port, path)
        chunks.append(c)
        firsts.append(f)
        totals.append(t)
    return chunks, firsts, totals


def check_graphs(voice) -> None:
    """Each graph kind, replayed with new inputs, gives the bits of its
    function run eagerly on the same inputs: the encode and frame-window
    graphs of a two-bucket batch and the streamed chunk's graph."""
    import torch

    from piper_tpu_torch.runtime.streaming import StreamingDecoder

    calls = []
    run = voice.graphs.run

    def spying_run(key, fn, inputs, *rest):
        out = run(key, fn, inputs, *rest)
        calls.append((key, fn, [None if x is None else x.to(voice.device) for x in inputs], out))
        return out

    voice.graphs.run = spying_run
    try:
        rows = [[1, 0] + [40 + (7 * i + j) % 90 for i in range(n)] + [0, 2] for j, n in
                enumerate((12, 20, 26, 50, 61))]
        voice.synthesize_ids_batch(rows, syn=_syn(seed=5))
        g = torch.Generator().manual_seed(2)
        z_p = torch.randn((1, 130, voice.model_cfg.inter_channels), generator=g).to(voice.device, voice.dtype)
        list(StreamingDecoder(voice).stream(z_p, 130))
    finally:
        voice.graphs.run = run
    same = 0
    with torch.inference_mode():
        for key, fn, inputs, out in calls:
            eager = fn(*inputs)
            same += all(torch.equal(e, o) for e, o in zip(eager, out))
    kinds = sorted({key[0] for key, *_ in calls})
    check(kinds == ["chunk", "encode", "frames"] and same == len(calls),
          f"CUDA graph replay equals eager execution bit for bit: {same} of {len(calls)} replays "
          f"({', '.join(kinds)}; {voice.model_cfg.vocoder}"
          f"{', VITS2' if voice.model_cfg.flow_transformer else ''}, {voice.precision})")


def phase_benchmark(tmp: Path, card: str) -> None:
    """python -m piper_tpu_torch.benchmark on the card, in this process:
    the reference's stdin-JSONL protocol, per-utterance RTF and --batch."""
    import numpy as np

    from piper_tpu_torch import benchmark as B
    from piper_tpu_torch.ops.cuda import vocoder as V
    from piper_tpu_torch.runtime.graphs import GraphCache

    rng = np.random.default_rng(0)
    lines = [json.dumps({"phoneme_ids": [1] + [int(x) for x in rng.integers(32, 120, 40 + 20 * i)] + [2]})
             for i in range(8)]
    V.mrf_fused.launches = 0
    V.fused_upsample_mrf.launches = 0
    # captures made in the benchmark's process, and how many of them its
    # warm-up had made: its timed runs (default --repeat 1) must only replay
    captures, warmed = [], []
    capture, warm = GraphCache._capture, B.warm

    def counting_capture(self, *a, **k):
        captures.append(a[0])
        return capture(self, *a, **k)

    def marking_warm(*a, **k):
        warm(*a, **k)
        warmed.append(len(captures))

    saved, out = sys.stdin, io.StringIO()
    sys.stdin = io.StringIO("\n".join(lines) + "\n")
    GraphCache._capture, B.warm = counting_capture, marking_warm
    try:
        with contextlib.redirect_stdout(out):
            B.main(["-m", str(tmp / "voice.npz"), "--batch", "--seed", "0"])
    finally:
        sys.stdin = saved
        GraphCache._capture, B.warm = capture, warm
    plans = [k for k in captures if k[0] == "plan"]
    check(warmed == [len(captures)] and len(captures) > 0,
          f"the benchmark's warm-up captured {warmed[0] if warmed else None} CUDA graphs ({len(plans)} "
          f"plan graphs among all), its timed runs {len(captures) - warmed[0] if warmed else None}")
    n_mrf, n_fused = V.mrf_fused.launches, V.fused_upsample_mrf.launches
    report = json.loads(out.getvalue().strip().splitlines()[-1])
    ok = (set(report) == {"load_sec", "rtf_mean", "rtf_stdev", "rtfs", "batch"} and len(report["rtfs"]) == 8
          and report["batch"]["utterances"] == 8 and report["batch"]["audio_seconds_per_s_per_chip"] > 0)
    check(ok, f"python -m piper_tpu_torch.benchmark --batch on the card: report {json.dumps(report)}  [{card}]")
    check(n_mrf >= 1 and n_fused == 2 * n_mrf,
          f"the benchmark launched mrf_fused {n_mrf} and fused_upsample_mrf {n_fused} times")


def mixed_streams_and_batches(port, paths, alone, card) -> None:
    """/streams on 4 threads, one after another on each, while 16
    clients send GETs of / that the batcher coalesces: the streams
    replay the encode and chunk graphs, the batches the encode and flow
    graphs, and all graphs share one memory pool. Every response equals
    the same request served alone."""
    import threading
    import urllib.parse

    texts = (STREAM_TEXT, TEXTS[0], TEXTS[3], TEXTS[2])
    qs = [f"/stream?text={urllib.parse.quote(t)}&seed={4 + i}" for i, t in enumerate(texts)]
    solo = [http_stream(port, q)[1] for q in qs]
    streamed = [[] for _ in qs]
    done = threading.Event()

    def streamer(i):
        while not done.is_set() or not streamed[i]:
            streamed[i].append(http_stream(port, qs[i])[1])

    threads = [threading.Thread(target=streamer, args=(i,)) for i in range(len(qs))]
    for t in threads:
        t.start()
    try:
        got, wall = clients(port, paths, 16, 4)
    finally:
        done.set()
        for t in threads:
            t.join(timeout=300)
    same_get = sum(g[0] == 200 and g[2] == alone[j][2] for j, g in got)
    n_streams = sum(len(c) for c in streamed)
    same_stream = sum(c == solo[i] for i, cs in enumerate(streamed) for c in cs)
    check(len(got) == 64 and same_get == 64 and n_streams >= 4 and same_stream == n_streams,
          f"streams and coalesced batches at once ({wall:.3f} s): {same_get} of {len(got)} GETs and "
          f"{same_stream} of {n_streams} /streams on 4 threads equal the request served alone  [{card}]")


def phase_serving(cfg, params_np, card, peaks):
    """The HTTP server with the batcher on a fast voice on the card."""
    import base64
    import urllib.parse

    import numpy as np
    import torch

    from piper_tpu_torch.models.vits import model as M
    from piper_tpu_torch.ops.cuda import vocoder as V
    from piper_tpu_torch.runtime.batching import pick_bucket
    from piper_tpu_torch.runtime.profiling import StageTimer
    from piper_tpu_torch.runtime.streaming import StreamingDecoder
    from piper_tpu_torch.runtime.voice import TorchVoice, utterance_seed

    voice = TorchVoice(params_np, cfg, _voice_cfg(cfg), precision="fast", device="cuda", seed=0)
    t0 = time.perf_counter()
    voice.warmup((1, 16), full=True)
    stats = voice.graphs.stats
    print(f"serving: warmup((1, 16), full=True) {time.perf_counter() - t0:.3f} s; {stats['captures']} CUDA "
          f"graphs captured in {stats['capture_s']:.3f} s, "
          f"{voice.graphs.memory_bytes() / 2**20:.1f} MiB of device memory held by the graphs  [{card}]")
    check_graphs(voice)
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
    server, port, thread = serve_in_process(voice)
    try:
        for path in ("/health", "/metrics"):
            status, _, body, _ = http_get(port, path)
            check(status == 200 and isinstance(json.loads(body), dict), f"GET {path} answers: {body[:120]!r}")

        # 16 concurrent GETs, each against the same request served alone
        paths = window_paths()
        alone = [http_get(port, p) for p in paths]
        solo = sorted(a[3] for a in alone)
        print(f"serving: 16 GETs one at a time (smoke observation, 16 samples): latency p50 "
              f"{np.percentile(solo, 50):.4f} s, max {solo[-1]:.4f} s  [{card}]", flush=True)
        # (rows, handle, seconds in submit) of each batch the batcher
        # sends; a decode is one frame bucket's vocode of an encode group
        # (collect() adds the speculative path's re-decodes to the handle)
        submits = []
        submit = voice.submit

        def timed_submit(ids_list, **kw):
            t0 = time.perf_counter()
            handle = submit(ids_list, **kw)
            submits.append((len(ids_list), handle, round(time.perf_counter() - t0, 4)))
            return handle

        def check_launches(what):
            n_mrf, n_fused = V.mrf_fused.launches, V.fused_upsample_mrf.launches
            decodes = sum(h["decodes"] for _, h, _ in submits)
            check(decodes >= 1 and n_mrf == decodes and n_fused == 2 * decodes,
                  f"{what} launched mrf_fused {n_mrf} and fused_upsample_mrf {n_fused} times for "
                  f"{decodes} decodes in {len(submits)} batches (once and twice per decode)")

        def reset_counts():
            submits.clear()
            V.mrf_fused.launches = 0
            V.fused_upsample_mrf.launches = 0

        voice.submit = timed_submit

        # two bursts of 16 concurrent GETs: correctness checks; their times
        # are smoke observations (16 samples each)
        for run in ("first", "second"):
            before = dict(voice.batcher.stats)
            reset_counts()
            got, wall = clients(port, paths, 16, 1)
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
                      f"(rows, decodes, s in submit) {[(r, h['decodes'], t) for r, h, t in submits]}"
                      f"  [{card}]", flush=True)
            check(0 < batches < 16, f"the batcher coalesced: {batches} batches for 16 requests")
            check_launches(f"the {run} burst")

        # the measurement window: 16 clients in a closed loop at the burst's
        # mix, WINDOW_ROUNDS requests each, under each decode grouping
        # (uniform: the server's default), then the same window again
        # under the profiler for the device's busy and idle share
        for grouping in ("uniform", "bucketed"):
            voice.decode_grouping = grouping
            before = dict(voice.batcher.stats)
            paths0 = dict(voice.path_counts)
            reset_counts()
            voice.timer = StageTimer()
            got, wall = clients(port, paths, 16, WINDOW_ROUNDS)
            spans, voice.timer = voice.timer.report(), None
            batches = voice.batcher.stats["batches"] - before["batches"]
            n = len(got)
            n_ok = sum(g[0] == 200 for _, g in got)
            same = sum(g[0] == 200 and g[2] == alone[j][2] for j, g in got)
            check(n == 16 * WINDOW_ROUNDS and n_ok == n and same == n,
                  f"window ({grouping}): {n} GETs sent, {n_ok} succeeded, {same} equal the request "
                  "served alone")
            check_launches(f"the window ({grouping})")
            moved = {k: voice.path_counts[k] - paths0[k] for k in paths0}
            check(moved["speculative"] > 0 and moved["speculative"] >= batches - 1,
                  f"window ({grouping}) runs speculative: batches by path and rows missed {moved} "
                  f"of {batches} batches")
            plans = voice.graphs.capture_seconds
            plan_s = [sec for k, sec in plans.items() if k[0] == "plan"]
            check(moved["fused_failed"] == 0,
                  f"window ({grouping}): dispatch fusion, {moved['fused']} of {batches} batches replayed a "
                  f"plan graph (fused share {moved['fused'] / max(batches, 1)}), {moved['fused_failed']} "
                  f"captures failed; {len(plan_s)} plan graphs so far, capture s each {plan_s}  [{card}]")
            lat = np.array([g[3] for _, g in got])
            rows = [r for r, _, _ in submits]
            print(f"serving: window ({grouping}) of {n} GETs from 16 closed-loop clients in {wall} s: "
                  f"{n / wall} requests/s, latency p50 {np.percentile(lat, 50)} s, p99 "
                  f"{np.percentile(lat, 99)} s, max {lat.max()} s; {batches} batches, rows per batch mean "
                  f"{np.mean(rows) if rows else 0:.2f}, decodes per batch mean "
                  f"{np.mean([h['decodes'] for _, h, _ in submits]) if submits else 0:.2f}, s in submit p50 "
                  f"{np.percentile([t for _, _, t in submits], 50) if submits else 0}  [{card}]", flush=True)
            print(f"serving: window ({grouping}), host time of submit by span (StageTimer): "
                  f"{json.dumps(spans)}", flush=True)
            n, wall, busy = profiled_window(port, paths, WINDOW_ROUNDS)
            print(f"serving: window ({grouping}) under the profiler ({n} GETs in {wall} s): device "
                  f"busy {busy} s, idle share {1 - busy / wall}  [{card}]", flush=True)
        voice.submit = submit
        n_plans = len([k for k in voice.graphs.capture_seconds if k[0] == "plan"])
        print(f"serving: after the windows, {len(voice.graphs.capture_seconds)} CUDA graphs "
              f"({n_plans} of them plan graphs), {voice.graphs.memory_bytes() / 2**20:.1f} MiB "
              f"of device memory held by the graphs  [{card}]", flush=True)

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
        graphs0 = dict(voice.graphs.stats)
        headers, chunks, first, total = http_stream(port, q)
        n_mrf, n_fused = V.mrf_fused.launches, V.fused_upsample_mrf.launches
        replays = voice.graphs.stats["replays"] - graphs0["replays"]
        check(voice.graphs.stats["captures"] == graphs0["captures"] and replays == len(chunks) + 2,
              f"/stream ran through the warm graphs: {replays} replays (its encode, its latents and "
              f"{len(chunks)} chunks), {voice.graphs.stats['captures'] - graphs0['captures']} new captures")
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
        warm_chunks, firsts, totals = timed_streams(port, q, STREAMS - 1)
        firsts, totals = [first] + firsts, [total] + totals
        same = 1 + sum(c == chunks for c in warm_chunks)
        check(same == STREAMS, f"{same} of {STREAMS} warm streams give the same bytes")
        print(f"serving: /stream of {audio_s} audio-s in {len(chunks)} chunks, {STREAMS} warm streams one "
              f"after another: time to first chunk p50 {np.percentile(firsts, 50)} s, p99 "
              f"{np.percentile(firsts, 99)} s, max {max(firsts)} s; whole stream p50 "
              f"{np.percentile(totals, 50)} s, {audio_s / np.percentile(totals, 50)} audio-s/s at the p50; "
              f"cold (first stream of the process, one sample): first chunk {cold_first} s, whole "
              f"{cold_total} s  [{card}]", flush=True)
        profile_stream(port, q)
        mixed_streams_and_batches(port, paths, alone, card)
    finally:
        stop_serving(server, thread, voice)

    # the seams: streaming in parity precision against one whole decode
    parity = TorchVoice(params_np, cfg, _voice_cfg(cfg), precision="parity", device="cuda", seed=0)
    key = utterance_seed(4, ids)
    with torch.inference_mode():
        bucket = pick_bucket(len(ids), parity.phoneme_buckets)
        enc, frames_dev = parity._encode([ids], [key], bucket, _syn(seed=4))
        frames = parity._read_frames([frames_dev])[0]
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


# ---------------------------------------------------------------------------
# Phase 5: published voices (.ckpt, .onnx, registry names, two speakers,
# a row past the frame-bucket ladder)
# ---------------------------------------------------------------------------

MS2_VOICE = ROOT / "tests" / "data" / "voice_xlow_ms2_trained_fp16.npz"
LONG_FRAMES = 12000  # the long row's target: ~3 x the largest frame bucket
VOICE_NAME = "xx_XX-smoke-medium"


def zero_counts() -> None:
    from piper_tpu_torch.ops.cuda import vocoder as V

    V.mrf_fused.launches = 0
    V.fused_upsample_mrf.launches = 0


def read_counts():
    from piper_tpu_torch.ops.cuda import vocoder as V

    return V.mrf_fused.launches, V.fused_upsample_mrf.launches


def write_published(tmp: Path, cfg, params_np):
    """Phase 3's medium voice as voice.ckpt (piper_train's Lightning
    layout, through the port's state_dict_from_params) and as a registry
    voice: <name>.onnx written by the port's exporter (the whole VITS
    graph, onnx_io.export_onnx_voice) with its sidecar and a voices.json
    that lists both files by size and md5."""
    import dataclasses

    import torch

    from piper_tpu_torch.onnx_io import export_onnx_voice
    from piper_tpu_torch.runtime.download import get_file_hash
    from piper_tpu_torch.weights.torch_export import state_dict_from_params

    sd = state_dict_from_params(params_np, cfg)
    hp = {k: v for k, v in dataclasses.asdict(cfg).items() if k != "audio"}
    torch.save({"state_dict": {"model_g." + k: torch.from_numpy(v) for k, v in sd.items()},
                "hyper_parameters": hp}, tmp / "voice.ckpt")
    sidecar = (tmp / "voice.npz.json").read_text()
    (tmp / "voice.ckpt.json").write_text(sidecar)
    data = tmp / "data"
    data.mkdir()
    export_onnx_voice(params_np, cfg, str(data / f"{VOICE_NAME}.onnx"))
    (data / f"{VOICE_NAME}.onnx.json").write_text(sidecar)
    files = {f"xx/xx_XX/smoke/medium/{f.name}": {"size_bytes": f.stat().st_size, "md5_digest": get_file_hash(f)}
             for f in sorted(data.iterdir())}
    (data / "voices.json").write_text(json.dumps({VOICE_NAME: {
        "key": VOICE_NAME, "language": {"code": "xx_XX"}, "quality": "medium", "num_speakers": 1,
        "aliases": [], "files": files}}))
    return data


def phase_published_files(tmp: Path, cfg, params_np, card: str) -> None:
    """The .ckpt and a registry name through the CLI at full medium
    width, with phase 3's lines and seed: the WAVs of the .npz run, byte
    for byte, through both kernels, with no network call; and each
    format's load time."""
    import torch

    from piper_tpu_torch.runtime import download
    from piper_tpu_torch.runtime.voice import TorchVoice
    from piper_tpu_torch.weights.native import load_native
    from piper_tpu_torch.weights.onnx_loader import load_onnx_voice
    from piper_tpu_torch.weights.torch_loader import load_torch_checkpoint

    t0 = time.perf_counter()
    data = write_published(tmp, cfg, params_np)
    print(f"published voices: .ckpt and .onnx written in {time.perf_counter() - t0:.3f} s "
          f"({(tmp / 'voice.ckpt').stat().st_size / 2**20:.1f} / "
          f"{(data / f'{VOICE_NAME}.onnx').stat().st_size / 2**20:.1f} MiB)")
    npz_wavs = sorted((tmp / "a").glob("*.wav"))
    onnx_path = data / f"{VOICE_NAME}.onnx"
    loaders = {
        "npz": (tmp / "voice.npz", lambda: load_native(str(tmp / "voice.npz"))),
        "ckpt": (tmp / "voice.ckpt", lambda: load_torch_checkpoint(str(tmp / "voice.ckpt"))),
        "onnx": (onnx_path, lambda: load_onnx_voice(str(onnx_path), cfg)),
    }
    for fmt, (path, loader) in loaders.items():
        reads, loads = [], []
        for _ in range(2):
            t0 = time.perf_counter()
            tree, got_cfg = loader()
            reads.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            voice = TorchVoice.load(path, precision="fast")
            torch.cuda.synchronize()
            loads.append(time.perf_counter() - t0)
        check(got_cfg.upsample_rates == cfg.upsample_rates and voice.model_cfg.hidden_channels == 192,
              f"{fmt}: medium config read back")
        print(f"load time, {fmt} ({path.stat().st_size / 2**20:.1f} MiB): file read to the numpy tree "
              f"{reads[0]:.4f} / {reads[1]:.4f} s, TorchVoice.load (tree, upload, time-major weights) "
              f"{loads[0]:.4f} / {loads[1]:.4f} s (first / second in this process)  [{card}]", flush=True)
        del voice

    def no_network(*a, **k):
        raise RuntimeError(f"network call: urlopen{a}")

    saved, download.urlopen = download.urlopen, no_network
    try:
        for run, (what, argv) in enumerate((
            (".ckpt", ["-m", str(tmp / "voice.ckpt")]),
            (f"registry name {VOICE_NAME} (.onnx)",
             ["-m", VOICE_NAME, "--data-dir", str(data), "--download-dir", str(data)]),
        )):
            out = tmp / f"published_{run}"
            zero_counts()
            t0 = time.perf_counter()
            run_cli(argv + ["-d", str(out), "--batch", "--seed", "1", "-q"], TEXTS)
            wall = time.perf_counter() - t0
            n_mrf, n_fused = read_counts()
            wavs = sorted(out.glob("*.wav"))
            same = sum((out / p.name).exists() and (out / p.name).read_bytes() == p.read_bytes()
                       for p in npz_wavs)
            check(len(wavs) == len(npz_wavs) == len(TEXTS) and same == len(TEXTS),
                  f"CLI -m {what}: {same} of {len(TEXTS)} WAVs equal the .npz run's byte for byte "
                  f"({wall:.3f} s)  [{card}]")
            check(n_mrf >= 1 and n_fused == 2 * n_mrf,
                  f"CLI -m {what} launched mrf_fused {n_mrf} and fused_upsample_mrf {n_fused} times")
    finally:
        download.urlopen = saved


def phase_two_speakers(card: str) -> None:
    """The trained two-speaker x-low voice behind the server with the
    batcher, in both precisions: 64 GETs from 8 clients alternating
    speaker_id 0 and 1, each equal to the request served alone; the two
    speakers' audio differs; a speaker the voice lacks is answered 400."""
    import urllib.parse

    import numpy as np

    from piper_tpu_torch.runtime.voice import TorchVoice, random_voice_config
    from piper_tpu_torch.weights.native import load_native

    with tempfile.TemporaryDirectory() as d:
        path = Path(d) / "voice.npz"
        shutil.copy(MS2_VOICE, path)
        _, cfg = load_native(str(path))
        (Path(d) / "voice.npz.json").write_text(json.dumps(random_voice_config(cfg).to_dict()))
        for precision in ("fast", "parity"):
            voice = TorchVoice.load(path, precision=precision, seed=0)
            check(voice.model_cfg.num_speakers == 2, f"two-speaker voice ({precision}) loads with 2 speakers")
            t0 = time.perf_counter()
            voice.warmup((1, 16), full=True)
            warm_s = time.perf_counter() - t0
            # 16 requests: 4 texts x seeds, speaker_id alternating with j
            paths = [f"/?text={urllib.parse.quote(TEXTS[j % len(TEXTS)])}&seed={j // 2}&speaker_id={j % 2}"
                     for j in range(16)]
            server, port, thread = serve_in_process(voice)
            try:
                alone = [http_get(port, p) for p in paths]
                zero_counts()
                batches0 = voice.batcher.stats["batches"]
                got, wall = clients(port, paths, 8, 8)
                n_mrf, n_fused = read_counts()
                batches = voice.batcher.stats["batches"] - batches0
                same = sum(g[0] == 200 and g[2] == alone[j][2] for j, g in got)
                check(len(got) == 64 and same == 64 and all(a[0] == 200 for a in alone),
                      f"two speakers ({precision}): {same} of {len(got)} GETs from 8 clients alternating "
                      f"speaker_id equal the request served alone")
                check(n_mrf >= 1 and n_fused == 2 * n_mrf and 0 < batches < 64,
                      f"two speakers ({precision}): {batches} batches for 64 GETs, mrf_fused {n_mrf} and "
                      f"fused_upsample_mrf {n_fused} launches")
                s0, s1 = wav_pcm(alone[0][2])[1], wav_pcm(alone[1][2])[1]
                check(len(s0) > 0 and not np.array_equal(s0, s1[: len(s0)]),
                      f"two speakers ({precision}): speaker 0 and 1 give different audio "
                      f"({len(s0)} / {len(s1)} samples)")
                status = http_get(port, paths[0].replace("speaker_id=0", "speaker_id=2"))[0]
                check(status == 400, f"two speakers ({precision}): speaker_id 2 answered {status}")
                lat = np.array([g[3] for _, g in got])
                print(f"two-speaker window ({precision}, x-low trained, warm-up {warm_s:.2f} s): 64 GETs from "
                      f"8 closed-loop clients in {wall} s: {64 / wall} requests/s, latency p50 "
                      f"{np.percentile(lat, 50)} s, p99 {np.percentile(lat, 99)} s; {batches} batches  "
                      f"[{card}]", flush=True)
            finally:
                stop_serving(server, thread, voice)
            del voice


def long_row(voice, target: int):
    """ids and a length_scale whose row lands near `target` frames
    (noise_w 0: the durations follow length_scale alone), found with the
    encode only; returns (ids, syn, frames)."""
    from piper_tpu_torch.config import SynthesisConfig
    from piper_tpu_torch.runtime.batching import pick_bucket
    from piper_tpu_torch.runtime.voice import utterance_seed

    import torch

    ids = [1, 0] + [40 + (7 * i) % 200 for i in range(250)] + [0, 2]
    bucket = pick_bucket(len(ids), voice.phoneme_buckets)
    scale, frames = 1.0, 0
    for _ in range(6):
        syn = SynthesisConfig(seed=9, length_scale=scale, noise_w=0.0)
        with torch.inference_mode():  # a captured encode graph's static inputs
            enc, f = voice._encode([ids], [utterance_seed(9, ids)], bucket, syn)
            frames = voice._read_frames([f])[0][0]
        if abs(frames - target) <= target // 100:
            break
        scale *= target / max(frames, 1)
    return ids, syn, frames


def phase_long_row(cfg, params_np, card: str, peaks) -> None:
    """One row past the 4096-frame ladder at medium (~12,000 frames), in
    fast and parity precision: decoded alone at its own frame count (its
    frame windows, then both kernels), its full length, peak device
    memory and wall; in fast precision the estimator calibrated by a
    short batch first sends it down the speculative path, which decodes
    it at the top bucket, reads its true length from the transfer's
    header and re-decodes it in the long form (as the JAX package does),
    so each run is two decodes; then both kernels against their plain
    versions at B = 1 and that length."""
    import numpy as np
    import torch

    from piper_tpu_torch.runtime.voice import TorchVoice

    frames = 0
    for precision in ("fast", "parity"):
        voice = TorchVoice(params_np, cfg, _voice_cfg(cfg), precision=precision, device="cuda", seed=0)
        ids, syn, frames = long_row(voice, LONG_FRAMES)
        voice.synthesize_ids_batch([[1, 0, 50, 0, 2]], syn=syn)  # first calls of cuBLAS/cuDNN
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        walls, decodes = [], 0
        for _ in range(2):  # the first call at this length, then again
            t0 = time.perf_counter()
            handle = voice.submit([ids], syn=syn)
            audio = voice.collect(handle)[0]
            walls.append(time.perf_counter() - t0)
            decodes += handle["decodes"]
        n_mrf, n_fused = read_counts()
        peak = torch.cuda.max_memory_allocated()
        u = cfg.upsample_factor
        top = voice.frame_buckets[-1]
        per_run = 2 if precision == "fast" else 1
        check(frames > top and len(audio) == frames * u and handle["decodes"] == per_run
              and bool(np.isfinite(audio).all()) and float(np.abs(audio).max()) > 0
              and (precision == "parity" or voice.path_counts["longform"] == 2),
              f"long row ({precision}): {frames} frames past the {top}-frame ladder, "
              f"{len(audio)} samples = frames x {u}, {handle['decodes']} decodes a run, finite, "
              f"non-zero; paths {voice.path_counts}")
        check(n_mrf == decodes and n_fused == 2 * decodes,
              f"long row ({precision}), two runs, launched mrf_fused {n_mrf} and fused_upsample_mrf "
              f"{n_fused} times for {decodes} decodes")
        print(f"long row ({precision}, medium, {len(ids)} ids, length_scale {syn.length_scale:.4f}): "
              f"{frames} frames, {len(audio) / cfg.audio.sample_rate:.2f} audio-s in {walls[0]:.4f} s of wall "
              f"(first call at this length), {walls[1]:.4f} s (second); peak device memory {peak / 2**20:.1f} MiB "
              f"({(peak - base) / 2**20:.1f} MiB above the {base / 2**20:.1f} MiB held before)  [{card}]",
              flush=True)
        del voice
    # both kernels at B = 1 and the long row's length, in both dtypes
    phase_kernels(cfg, params_np, peaks, frames=(frames,))


# ---------------------------------------------------------------------------
# Phase 6: VITS2 and MB-iSTFT voices at the medium preset's full width
# ---------------------------------------------------------------------------

STREAM_TEXT_SHORT = "Streaming on the card, in two chunks."
POST_SCALE = 0.02  # std of the noise added to VITS2's zero-initialised flow post


def write_variant_voices(out: Path):
    """The two random-weight medium voices of phase 6, written through
    the port's init_synthesizer_params and save_native as
    <name>.npz + <name>.npz.json: a two-speaker VITS2 voice
    (ModelConfig.vits2: flow_transformer and speaker_cond_encoder), its
    flows' `post` perturbed (zero-initialised, it would make the flow's
    attention change nothing), and a one-speaker MB-iSTFT voice
    (ModelConfig.mb_istft). Returns {name: (path, cfg, params)}."""
    import numpy as np

    from piper_tpu_torch.config import ModelConfig
    from piper_tpu_torch.models.vits.model import init_synthesizer_params
    from piper_tpu_torch.runtime.voice import random_voice_config
    from piper_tpu_torch.weights.native import save_native

    out.mkdir(parents=True, exist_ok=True)
    voices = {}
    for seed, (name, cfg) in enumerate((
        ("vits2", ModelConfig.vits2("medium", num_symbols=256, num_speakers=2)),
        ("mb_istft", ModelConfig.mb_istft("medium", num_symbols=256)),
    )):
        params = init_synthesizer_params(11 + seed, cfg)
        if cfg.flow_transformer:
            rng = np.random.default_rng(12)
            for layer in params["flow"]["layers"]:
                for k, v in layer["post"].items():
                    layer["post"][k] = (v + POST_SCALE * rng.standard_normal(v.shape)).astype(np.float32)
        path = out / f"{name}.npz"
        save_native(str(path), params, cfg)
        Path(str(path) + ".json").write_text(json.dumps(random_voice_config(cfg).to_dict()))
        voices[name] = (path, cfg, params)
    return voices


class Decodes(list):
    """Handles of submitted batches; iterating yields each one's decodes,
    read when iterated: a speculative batch's collect() adds its
    re-decodes to its handle."""

    def __iter__(self):
        return (h["decodes"] for h in list.__iter__(self))


@contextlib.contextmanager
def counting_decodes():
    """Every TorchVoice.submit's decodes, from any caller (the CLI, the
    batcher's dispatcher): yields the list each submit appends its handle
    to (sum() of it counts the decodes, re-decodes included)."""
    from piper_tpu_torch.runtime.voice import TorchVoice

    decodes = Decodes()
    submit = TorchVoice.submit

    def counted(self, *a, **k):
        handle = submit(self, *a, **k)
        decodes.append(handle)
        return handle

    TorchVoice.submit = counted
    try:
        yield decodes
    finally:
        TorchVoice.submit = submit


def ops_off_the_card(fn):
    """fn() under a dispatch mode that counts every op and those whose
    tensors (0-dim host scalars aside) are not on CUDA: (result, ops,
    off)."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    counts = [0, 0]

    class Mode(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            flat = list(args) + list((kwargs or {}).values()) + list(out if isinstance(out, (tuple, list))
                                                                      else [out])
            tensors = [x for x in flat if isinstance(x, torch.Tensor)]
            counts[0] += 1
            counts[1] += any(x.device.type != "cuda" and x.dim() > 0 for x in tensors)
            return out

    with Mode():
        result = fn()
    return result, counts[0], counts[1]


def warm_batch_device_ms(voice, rows, card, what):
    """Device time (torch.profiler, the sum of kernel time) and wall of
    one warm 16-row batch, once its plan has settled (settle())."""
    from torch.profiler import ProfilerActivity, profile

    settle(voice, rows, _syn(seed=7))
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        audios = voice.synthesize_ids_batch(rows, syn=_syn(seed=7))
        walls.append(time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        voice.synthesize_ids_batch(rows, syn=_syn(seed=7))
    events = [e for e in prof.key_averages() if str(getattr(e, "device_type", "")).endswith("CUDA")]
    dev_ms = sum(e.self_device_time_total for e in events) / 1e3
    audio_s = sum(len(a) for a in audios) / voice.config.sample_rate
    print(f"{what}: warm batch, fast, 16 rows ({audio_s:.2f} audio-s): device time {dev_ms:.2f} ms, "
          f"{audio_s / (dev_ms / 1e3):.1f} audio-s per device s; wall {sorted(walls)} s, "
          f"{audio_s / min(walls):.1f} audio-s/s at the best wall  [{card}]", flush=True)
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<4d} {e.key[:90]}")
    return dev_ms


def busy_ms(fn, reps: int = 3) -> float:
    """Device busy time of one fn() (torch.profiler, the sum of kernel
    time, the mean of `reps` profiled calls after two warm calls)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with torch.inference_mode():
        fn()
        fn()  # a graph's key is captured at its second call
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if str(getattr(e, "device_type", "")).endswith("CUDA")) / 1e3 / reps


def variant_costs(voice, name: str, card: str) -> None:
    """What this variant's decode costs on the card, at the warm batch's
    shapes (16 rows of 437-490 frames, frame bucket 656), in device ms
    (busy_ms) and event ms (time_ms): the frame-level stages in frame
    windows (the decode path since fault 17: each frame's noise, the
    latents, the reverse flow and the generator's plain stages; MB-iSTFT:
    its whole generator) against the same stages eagerly over the 16 rows
    at the bucket under the mask (over which rows move with their
    bucket). VITS2 adds the flow alone, eagerly, with and without its
    attention blocks."""
    import torch

    from piper_tpu_torch.models.vits import model as M
    from piper_tpu_torch.runtime import batching
    from piper_tpu_torch.runtime import voice as RV

    cfg, p, dt = voice.model_cfg, voice.params, voice.dtype
    g = torch.Generator().manual_seed(4)
    frames = [437 + (7 * i) % 54 for i in range(16)]
    t = batching.pick_bucket(max(frames), voice.frame_buckets)
    mask = (torch.arange(t)[None, :] < torch.tensor(frames)[:, None])[..., None].to("cuda", dt)
    z = torch.randn((16, t, cfg.inter_channels), generator=g).to("cuda", dt) * mask
    sid = torch.ones(16, dtype=torch.long, device="cuda") if cfg.num_speakers > 1 else None
    gemb = M.speaker_embedding(p, cfg, sid)
    keys, scale = voice._noise_inputs(list(range(16)), _syn(seed=0))
    windows = [-(-f // RV.WINDOW_FRAMES) for f in frames]
    runs = [
        (f"frame windows ({voice._win_rows} a graph, {sum(windows)} windows; the decode path)",
         lambda: voice._frames(z, z, mask, keys, scale, sid, windows)),
        ("eager over the rows at the bucket under the mask",
         lambda: M.synthesizer_frames(p, z, mask, cfg=cfg, g=gemb)),
    ]
    if cfg.flow_transformer:
        bare = {**p, "flow": {"layers": [{k: v for k, v in lp.items() if k not in ("attn", "attn_norm")}
                                         for lp in p["flow"]["layers"]]}}
        runs += [
            ("the flow alone, eager, with attention",
             lambda: M.synthesizer_flow(p, z, mask, cfg=cfg, g=gemb)),
            ("the flow alone, eager, without attention",
             lambda: M.synthesizer_flow(bare, z, mask, cfg=cfg, g=gemb)),
        ]
    what = f"frame-level stages, 16 rows of {min(frames)}-{max(frames)} frames (bucket {t})"
    for how, fn in runs:
        dev_ms = busy_ms(fn)
        with torch.inference_mode():
            ev_ms = time_ms(fn)
        print(f"{name} cost ({voice.precision}): {what}, {how}: device {dev_ms:.3f} ms, "
              f"events {ev_ms:.3f} ms  [{card}]", flush=True)


def phase_variant(tmp: Path, name: str, path: Path, cfg, params_np, card: str, hifigan_ms):
    """One phase-6 voice through the port's entry points on the card:
    the CLI (WAV checks, same bytes twice, its kernel launches per
    decode), the card against the port on the CPU in parity, the server
    with the batcher in both precisions after a full warm-up (64 GETs
    from 8 clients each equal to the request alone; VITS2: speaker_id
    alternating, the speakers differ), each graph kind's replay against
    its eager run, a parity /stream against the port's CPU chunks, and a
    warm 16-row batch's device time. Returns the CLI's launches."""
    import urllib.parse

    import numpy as np
    import torch

    from piper_tpu_torch.config import SynthesisConfig
    from piper_tpu_torch.models.vits import model as M
    from piper_tpu_torch.runtime.batching import pick_bucket
    from piper_tpu_torch.runtime.streaming import StreamingDecoder, synthesize_stream_chunks
    from piper_tpu_torch.runtime.voice import TorchVoice, utterance_seed

    t_phase = time.perf_counter()
    vits2 = cfg.flow_transformer
    u = cfg.upsample_factor
    per_decode = (1, 2) if cfg.vocoder == "hifigan" else (0, 0)
    spk = 1 if cfg.num_speakers > 1 else None

    def launches_ok(what, n_mrf, n_fused, decodes, unit="decode"):
        check(decodes >= 1 and n_mrf == per_decode[0] * decodes and n_fused == per_decode[1] * decodes,
              f"{name}: {what} launched mrf_fused {n_mrf} and fused_upsample_mrf {n_fused} times for "
              f"{decodes} {unit}s ({per_decode[0]} and {per_decode[1]} per {unit})")

    # the CLI, twice: WAVs, same bytes, launches per decode
    outs = [tmp / f"{name}_cli_{i}" for i in range(2)]
    with counting_decodes() as decodes:
        zero_counts()
        t0 = time.perf_counter()
        run_cli(["-m", str(path), "-d", str(outs[0]), "--batch", "--seed", "1", "-q"], TEXTS)
        cli_s = time.perf_counter() - t0
        cli_launches = dict(zip(("mrf_fused", "fused_upsample_mrf"), read_counts()))
        launches_ok("the CLI (--batch, 4 lines)", *read_counts(), sum(decodes))
        run_cli(["-m", str(path), "-d", str(outs[1]), "--batch", "--seed", "1", "-q"], TEXTS)
    wavs = sorted(outs[0].glob("*.wav"))
    check(len(wavs) == len(TEXTS), f"{name}: CLI wrote {len(wavs)} WAVs for {len(TEXTS)} lines ({cli_s:.3f} s)")
    for p in wavs:
        raw, sr, pcm = read_wav(p)
        check(raw[:4] == b"RIFF" and sr == 22050 and len(pcm) > 0 and len(pcm) % u == 0
              and int(np.abs(pcm).max()) > 0,
              f"{name}: {p.name}: RIFF/WAVE, {sr} Hz, {len(pcm)} samples ({len(pcm) // u} frames), non-zero")
    same = all((outs[1] / p.name).read_bytes() == p.read_bytes() for p in wavs)
    check(same, f"{name}: same seed, same bytes (two CLI runs)")

    # the card against the port on the CPU: parity, one short utterance
    ids = [[1, 0] + [40 + (7 * i) % 50 for i in range(30)] + [0, 2]]
    got = {}
    for dev in ("cpu", "cuda"):
        v = TorchVoice(params_np, cfg, _voice_cfg(cfg), precision="parity", device=dev)
        got[dev] = v.synthesize_ids_batch(ids, syn=SynthesisConfig(seed=3, speaker_id=spk))[0]
    n = min(len(got["cpu"]), len(got["cuda"]))
    err = float(np.abs(got["cpu"][:n] - got["cuda"][:n]).max()) if n else math.inf
    check(len(got["cpu"]) == len(got["cuda"]) and err < 1e-3,
          f"{name}: card vs CPU, parity, {len(got['cuda'])} samples: max_abs_err {err:.3e} (atol 1e-3)")

    for precision in ("fast", "parity"):
        voice = TorchVoice.load(path, precision=precision, seed=0)
        t0 = time.perf_counter()
        voice.warmup((1, 16), full=True)
        warm_s = time.perf_counter() - t0
        check_graphs(voice)
        if precision == "fast":
            rng = np.random.default_rng(0)
            rows = [[1, 0] + [int(t) for t in rng.integers(3, 256, 250)] + [0, 2] for _ in range(16)]
            dev_ms = warm_batch_device_ms(voice, rows, card, f"{name} (medium)")
            print(f"{name}: warm batch device time {dev_ms:.2f} ms against the HiFiGAN medium voice's "
                  f"{hifigan_ms:.2f} ms (phase 3, same rows)  [{card}]", flush=True)
            variant_costs(voice, name, card)
            if cfg.vocoder == "mb_istft":
                # the frame windows' function eagerly (a replay dispatches
                # no op): the flow and the whole generator, iSTFT and PQMF
                g = torch.Generator().manual_seed(6)
                mask = (torch.arange(336)[None, :] < torch.tensor([336, 200, 90, 17])[:, None])
                mask = mask[..., None].to("cuda", voice.dtype)
                z = torch.randn((4, 336, cfg.inter_channels), generator=g).to("cuda", voice.dtype) * mask
                with torch.inference_mode():
                    _, ops, off = ops_off_the_card(
                        lambda: M.synthesizer_frames(voice.params, z, mask, cfg=cfg))
                check(ops > 0 and off == 0,
                      f"{name}: the MB-iSTFT generator ran {ops} ops, {off} of them on tensors off "
                      "the card")
        # 16 requests, 4 texts; VITS2: each text and seed twice, speaker 0 then 1
        paths = [f"/?text={urllib.parse.quote(TEXTS[(j // 2) % len(TEXTS)])}&seed={j // 2}"
                 + (f"&speaker_id={j % 2}" if vits2 else "") for j in range(16)]
        server, port, thread = serve_in_process(voice)
        try:
            alone = [http_get(port, p) for p in paths]
            with counting_decodes() as decodes:
                zero_counts()
                batches0 = voice.batcher.stats["batches"]
                got, wall = clients(port, paths, 8, 8)
                n_mrf, n_fused = read_counts()
            batches = voice.batcher.stats["batches"] - batches0
            same = sum(g[0] == 200 and g[2] == alone[j][2] for j, g in got)
            check(len(got) == 64 and same == 64 and all(a[0] == 200 for a in alone),
                  f"{name} ({precision}): {same} of {len(got)} GETs from 8 clients"
                  f"{' alternating speaker_id' if vits2 else ''} equal the request served alone")
            check(0 < batches < 64, f"{name} ({precision}): {batches} batches for 64 GETs")
            launches_ok(f"the server ({precision})", n_mrf, n_fused, sum(decodes))
            if vits2:
                s0, s1 = wav_pcm(alone[0][2])[1], wav_pcm(alone[1][2])[1]
                check(len(s0) > 0 and (len(s0) != len(s1) or not np.array_equal(s0, s1)),
                      f"{name} ({precision}): speaker 0 and 1 give different audio for the same text "
                      f"and seed ({len(s0)} / {len(s1)} samples)")
            lat = np.array([g[3] for _, g in got])
            print(f"{name} window ({precision}, medium, warm-up {warm_s:.2f} s): 64 GETs from 8 closed-loop "
                  f"clients in {wall} s: {64 / wall} requests/s, latency p50 {np.percentile(lat, 50)} s, p99 "
                  f"{np.percentile(lat, 99)} s; {batches} batches  [{card}]", flush=True)
            if precision == "parity":
                # /stream on the card against the port's CPU chunks
                q = (f"/stream?text={urllib.parse.quote(STREAM_TEXT_SHORT)}&seed=4"
                     + (f"&speaker_id={spk}" if vits2 else ""))
                zero_counts()
                _, chunks, _, total = http_stream(port, q)
                n_mrf, n_fused = read_counts()
                launches_ok("/stream", n_mrf, n_fused, len(chunks), unit="chunk")
                pcm = np.frombuffer(b"".join(chunks), "<i2").astype(np.float32) / 32767.0
                cpu = TorchVoice(params_np, cfg, _voice_cfg(cfg), precision="parity", device="cpu", seed=0)
                syn = SynthesisConfig(seed=4, speaker_id=spk)
                s_ids = cpu.phonemes_to_ids(cpu.phonemize(STREAM_TEXT_SHORT)[0])
                ref = list(synthesize_stream_chunks(cpu, s_ids, syn=syn))
                ref_f = np.clip(np.concatenate(ref), -1.0, 1.0) if ref else np.zeros(0, np.float32)
                err = float(np.abs(pcm - ref_f).max()) if len(pcm) == len(ref_f) else math.inf
                check(len(chunks) == len(ref) >= 2 and err < 1e-3,
                      f"{name}: /stream on the card, parity, {len(chunks)} chunks ({total:.3f} s) against the "
                      f"port's CPU chunks ({len(ref)}): max_abs_err {err:.3e} (atol 1e-3, int16 wire)")
                # the seams, an observation: JAX's chunking design, not the port's
                key = utterance_seed(4, s_ids)
                with torch.inference_mode():
                    enc, fr = voice._encode([s_ids], [key], pick_bucket(len(s_ids), voice.phoneme_buckets), syn)
                    frames = voice._read_frames([fr])[0][0]
                    z_p, y_mask = voice._latents(enc, [key], frames, syn)
                    sid = voice._speaker(syn, 1)
                    whole = M.synthesizer_vocode(voice.params, z_p, y_mask, cfg=cfg, sid=sid)[0]
                    whole = whole.float().cpu().numpy()
                streamed = np.concatenate(list(StreamingDecoder(voice).stream(z_p, frames, sid)))
                seam = np.abs(streamed - whole[: len(streamed)])
                print(f"{name}: streamed vs whole decode, parity, {frames} frames (observation, not a check): "
                      f"p99 {np.percentile(seam, 99):.3e}, mean {seam.mean():.3e}, max {seam.max():.3e}")
        finally:
            stop_serving(server, thread, voice)
        del voice
    print(f"phase 6, {name}: {time.perf_counter() - t_phase:.1f} s of wall  [{card}]", flush=True)
    return cli_launches


# ---------------------------------------------------------------------------
# Phase 7: training on the card
# ---------------------------------------------------------------------------

TRAIN_UTTERANCES = 16  # synthetic, 1.5-4 s at 22,050 Hz, 30-90 ids each
# (rtol) of the card against the port on the CPU in float32 with TF32
# off: the same float32 ops summed in another order (cuDNN and cuBLAS
# against the CPU's kernels), through the posterior's 16 WN layers, the
# flows, the generator and the discriminators' 1024-channel convs
TRAIN_RTOL = 1e-3
# the feature loss's gradients: |fmap_r - fmap_g| passes back the sign of
# each difference, and a difference within rounding of zero may take the
# other sign on the other device, each such element moving a weight's
# gradient by 2 |d fmap / d w| / N; its values keep TRAIN_RTOL
FEATURE_GRAD_RTOL = 1e-2


def rel_err(got, ref) -> float:
    """max |got - ref| over max |ref|, on the CPU."""
    got, ref = got.detach().float().cpu(), ref.detach().float().cpu()
    return float((got - ref).abs().max()) / max(float(ref.abs().max()), 1e-30)


def cuda_tree(tree):
    if isinstance(tree, dict):
        return {k: cuda_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [cuda_tree(v) for v in tree]
    return tree.detach().cuda().requires_grad_(tree.requires_grad)


def train_batch(ds: Path, cfg, rows: int, shortest: bool = False):
    """One batch of `rows` utterances of the smoke's dataset, collated by
    the trainer's BucketedLoader into one bucket (the shortest ones when
    `shortest`, else the first rows in order)."""
    import numpy as np

    from piper_tpu_torch.train.dataset import BucketedLoader, load_dataset

    utts = load_dataset([ds / "dataset.jsonl"])
    if shortest:
        utts = sorted(utts, key=lambda u: np.load(u.audio_norm_path, mmap_mode="r").shape[0])
    loader = BucketedLoader(utts[:rows], batch_size=rows, hop_length=cfg.audio.hop_length,
                            segment_size=cfg.segment_size, multispeaker=cfg.num_speakers > 1,
                            seed=0, single_shape=True)
    return next(iter(loader))


def _to(batch, device):
    import torch

    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def train_modules_vs_cpu(ds: Path, cfg, params_g, params_d) -> None:
    """Each training module on the card against the port on the CPU,
    float32 with TF32 off, at the medium preset's widths: values, and
    for the differentiable ones the gradient of a random projection."""
    import numpy as np
    import torch

    from piper_tpu_torch.models.vits import discriminator as DS
    from piper_tpu_torch.models.vits import duration as D
    from piper_tpu_torch.models.vits import posterior as Q
    from piper_tpu_torch.ops import mas as MAS
    from piper_tpu_torch.ops import stft as S
    from piper_tpu_torch.train import losses as LS

    a = cfg.audio
    batch = train_batch(ds, cfg, 2, shortest=True)
    gcu, dcu = cuda_tree(params_g), cuda_tree(params_d)
    g = torch.Generator().manual_seed(7)

    def both(name, fn, *inputs, grad_of=None, grad_rtol=TRAIN_RTOL):
        """fn(dev, *inputs) on the CPU and on the card: values, then the
        gradients of a random projection with respect to the inputs that
        require grad and `grad_of(dev)`."""
        outs = {}
        for role, dev in (("cpu", "cpu"), ("card", "cuda")):
            xs = [x.detach().to(dev).requires_grad_(x.requires_grad) if isinstance(x, torch.Tensor)
                  else x for x in inputs]
            out = fn(dev, *xs)
            grads = []
            if grad_of is not None:
                proj = torch.randn(out.shape, generator=torch.Generator().manual_seed(3)).to(dev)
                targets = [x for x in xs if isinstance(x, torch.Tensor) and x.requires_grad]
                targets += grad_of(dev)
                grads = torch.autograd.grad((out.float() * proj).sum(), targets, allow_unused=True)
            outs[role] = (out, grads)
        err = rel_err(outs["card"][0], outs["cpu"][0])
        gerr = max([rel_err(gc, gp) for gc, gp in zip(outs["card"][1], outs["cpu"][1])
                    if gc is not None and gp is not None] or [0.0])
        check(err < TRAIN_RTOL and gerr < grad_rtol,
              f"train module {name}: card vs CPU, float32, max error {err:.2e} of the largest value "
              f"(< {TRAIN_RTOL}), gradients {gerr:.2e} (< {grad_rtol})")

    audio = torch.from_numpy(batch["audio"][:, :16384]).requires_grad_(True)
    mel_kw = dict(sample_rate=a.sample_rate, n_fft=a.filter_length, hop_length=a.hop_length,
                  win_length=a.win_length, n_mels=a.mel_channels, fmin=a.mel_fmin, fmax=a.mel_fmax)
    both("spectrogram", lambda dev, y: S.spectrogram(y, n_fft=a.filter_length, hop_length=a.hop_length,
                                                     win_length=a.win_length), audio, grad_of=lambda d: [])
    both("mel_spectrogram", lambda dev, y: S.mel_spectrogram(y, **mel_kw), audio, grad_of=lambda d: [])

    spec = torch.from_numpy(batch["spec"])
    lens = torch.from_numpy(batch["spec_lengths"])
    y_mask = (torch.arange(spec.shape[1])[None, :] < lens[:, None])[..., None].float()
    noise = torch.randn((2, spec.shape[1], cfg.inter_channels), generator=g)
    pick = {"cpu": params_g, "cuda": gcu}
    both("posterior_encode",
         lambda dev, s, m, n: Q.posterior_encode(pick[dev]["enc_q"], s, m, cfg=cfg, noise=n)[0],
         spec, y_mask, noise, grad_of=lambda d: [pick[d]["enc_q"]["pre"]["w"], pick[d]["enc_q"]["proj"]["w"]])

    t_x = int(batch["id_lengths"].max())
    x = torch.randn((2, t_x, cfg.hidden_channels), generator=g)
    x_mask = (torch.arange(t_x)[None, :] < torch.from_numpy(batch["id_lengths"])[:, None])[..., None].float()
    w = torch.randint(1, 8, (2, t_x, 1), generator=g).float()
    e_q = torch.randn((2, t_x, 2), generator=g)
    both("sdp_forward_nll",
         lambda dev, x, m, w, n: D.sdp_forward_nll(pick[dev]["dp"], x, m, w, cfg=cfg, g=None, noise=n),
         x, x_mask, w, e_q, grad_of=lambda d: [pick[d]["dp"]["post_pre"]["w"], pick[d]["dp"]["pre"]["w"]])

    pick_d = {"cpu": params_d, "cuda": dcu}
    y = torch.from_numpy(batch["audio"][:, :cfg.segment_size])
    y_hat = (0.5 * y + 0.1 * torch.randn(y.shape, generator=g)).requires_grad_(True)

    def gen_side(dev, y, y_hat):
        _, dg, _, _ = DS.mpd_apply(pick_d[dev], y, y_hat)
        return LS.generator_loss(dg)[0]

    def feature_side(dev, y, y_hat):
        _, _, fr, fg = DS.mpd_apply(pick_d[dev], y, y_hat)
        return LS.feature_loss(fr, fg)

    def disc_side(dev, y, y_hat):
        dr, dg, _, _ = DS.mpd_apply(pick_d[dev], y, y_hat)
        return LS.discriminator_loss(dr, dg)[0]

    d_leaves = lambda d: [pick_d[d]["disc_p"][0]["convs"][2]["w"], pick_d[d]["disc_s"]["convs"][3]["w"]]  # noqa: E731
    both("mpd_apply + generator loss", gen_side, y, y_hat, grad_of=d_leaves)
    both("mpd_apply + feature loss", feature_side, y, y_hat, grad_of=d_leaves,
         grad_rtol=FEATURE_GRAD_RTOL)
    both("mpd_apply + discriminator loss", disc_side, y, y_hat.detach(),
         grad_of=lambda d: [pick_d[d]["disc_p"][4]["convs"][1]["w"], pick_d[d]["disc_s"]["conv_post"]["w"]])
    if "dur_disc" in params_d:
        logw = torch.randn((2, t_x, 1), generator=g)
        both("dur_disc_apply", lambda dev, x, lw, m: DS.dur_disc_apply(pick_d[dev]["dur_disc"], x, lw, m),
             x, logw.requires_grad_(True), x_mask,
             grad_of=lambda d: [pick_d[d]["dur_disc"]["conv1"]["w"]])
    z_p, logs_q, m_p = (torch.randn((2, 50, 8), generator=g).requires_grad_(True) for _ in range(3))
    logs_p = (0.3 * torch.randn((2, 50, 8), generator=g)).requires_grad_(True)
    km = (torch.arange(50)[None, :] < torch.tensor([50, 31])[:, None])[..., None].float()
    both("kl_loss", lambda dev, *t: LS.kl_loss(*t), z_p, logs_q, m_p, logs_p, km, grad_of=lambda d: [])

    # MAS: the card's path against maximum_path_numpy on the same scores
    t_y = int(lens.max())
    neg = torch.randn((2, t_y, t_x), generator=g) * 5
    x_len, y_len = torch.from_numpy(batch["id_lengths"]), lens
    got = MAS.maximum_path(neg.cuda(), x_len.cuda(), y_len.cuda()).cpu().numpy()
    ref = MAS.maximum_path_numpy(neg.numpy(), x_len.numpy(), y_len.numpy())
    n_diff = int((got.argmax(-1) != ref.argmax(-1)).sum())
    check(np.array_equal(got, ref), f"maximum_path on the card equals maximum_path_numpy on "
                                    f"(2, {t_y}, {t_x}) scores ({n_diff} frames differ)")


def train_step_vs_cpu(ds: Path, cfg, params_g_np, params_d_np) -> None:
    """One train_step at the medium preset's full width, batch 2, float32
    with TF32 off, from the same params and key on the card and on the
    CPU: every loss within TRAIN_RTOL, equal segment starts and MAS
    durations."""
    import numpy as np
    import torch

    from piper_tpu_torch.ops import prng
    from piper_tpu_torch.train.step import make_train_state, train_step

    batch = train_batch(ds, cfg, 2, shortest=True)
    out = {}
    for role, dev in (("cpu", "cpu"), ("card", "cuda")):
        t0 = time.perf_counter()
        state = make_train_state(params_g_np, params_d_np, cfg, device=dev)
        _, m = train_step(state, _to(batch, dev), prng.prng_key(11, dev), cfg=cfg)
        out[role] = {k: v.cpu() for k, v in m.items()}
        print(f"phase 7: train_step on the {dev}, medium, batch 2 (frames {batch['spec_lengths'].tolist()}), "
              f"float32: {time.perf_counter() - t0:.2f} s with set-up", flush=True)
    dur_c, dur_g = out["cpu"].pop("attn_durations"), out["card"].pop("attn_durations")
    sl_c, sl_g = out["cpu"].pop("ids_slice"), out["card"].pop("ids_slice")
    n_frames = int((dur_c - dur_g).abs().sum())
    check(torch.equal(dur_c, dur_g) and torch.equal(sl_c, sl_g),
          f"train_step card vs CPU: equal MAS durations ({n_frames} frames of "
          f"{int(dur_c.sum())} moved) and segment starts {sl_g.tolist()}")
    for k in sorted(out["cpu"]):
        a, b = float(out["card"][k]), float(out["cpu"][k])
        check(np.isfinite(a) and abs(a - b) <= TRAIN_RTOL * abs(b),
              f"train_step card vs CPU: {k} {a:.6g} vs {b:.6g} (rtol {TRAIN_RTOL})")


def train_cli(ds: Path, tmp: Path, card: str) -> None:
    """python -m piper_tpu_torch.train on the card, in this process (its
    main() with a command line, as run_cli runs the CLI): 4 steps with a
    checkpoint at 2, a validation pass and an export, at one bucket
    shape; --resume to 6 steps; the exported voice through python -m
    piper_tpu_torch."""
    import numpy as np
    import torch

    from piper_tpu_torch.train.__main__ import main as train_main

    ckpt = tmp / "ckpt"
    common = ["--dataset-dir", str(ds), "--checkpoint-dir", str(ckpt), "--batch-size", "4",
              "--single-bucket", "--log-steps", "1", "--checkpoint-steps", "2",
              "--validate-steps", "4", "--export-every", "4"]
    for extra in (["--max-steps", "4"], ["--max-steps", "6", "--resume"]):
        t0 = time.perf_counter()
        train_main(common + extra)
        print(f"phase 7: python -m piper_tpu_torch.train {' '.join(extra)}: "
              f"{time.perf_counter() - t0:.1f} s  [{card}]", flush=True)
    rows = [json.loads(line) for line in (ckpt / "metrics.jsonl").read_text().splitlines()]
    steps = [r["step"] for r in rows if "loss_gen_all" in r]
    finite = all(np.isfinite(v) for r in rows for k, v in r.items() if k.startswith("loss"))
    check(steps == [1, 2, 3, 4, 5, 6] and finite,
          f"trainer: steps {steps} (the second run resumed at 4), every loss finite")
    val = [r for r in rows if "val_mel_l1" in r]
    check(len(val) >= 1 and (ckpt / "samples" / "4" / "val_0.wav").exists(),
          f"trainer: validation at step 4 through infer on the card ({val})")
    print(f"phase 7: trainer losses by step: "
          f"{[(r['step'], r['loss_gen_all'], r['loss_disc_all'], r['loss_mel']) for r in rows if 'loss_mel' in r]}"
          f"  [{card}]", flush=True)
    s2, s6 = (torch.load(ckpt / f"state_{n}.pt", weights_only=True) for n in (2, 6))
    moved = not torch.equal(s2["params_g"]["dec"]["conv_pre"]["w"], s6["params_g"]["dec"]["conv_pre"]["w"])
    check(s6["step"] == 6 and s6["opt_g"]["count"] == 6 and moved,
          "trainer: checkpoint at step 6 after --resume, optimizer count 6, params changed since step 2")
    voice = tmp / "trained.npz"
    shutil.copy(ckpt / "voice_6.npz", voice)
    shutil.copy(ds / "config.json", str(voice) + ".json")
    wav = tmp / "trained.wav"
    run_cli(["-m", str(voice), "-f", str(wav), "--seed", "1"], ["The trained voice speaks."])
    raw, sr, pcm = read_wav(wav)
    check(raw[:4] == b"RIFF" and sr == 22050 and len(pcm) > 0 and len(pcm) % 256 == 0
          and int(np.abs(pcm).max()) > 0,
          f"the exported voice speaks through python -m piper_tpu_torch: {len(pcm)} samples at {sr} Hz")


def step_costs(ds: Path, cfg, params_g_np, params_d_np, card: str, rows: int = 8) -> None:
    """Warm step time at the medium preset in both precisions, batch
    `rows` (one bucket of the dataset), MAS's share of it (the DP at this
    batch's shape alone), peak memory, and one profiled step: the
    device's busy time (the sum of kernel time), its kernel launches and
    its top kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from piper_tpu_torch.ops import mas as MAS
    from piper_tpu_torch.ops import prng
    from piper_tpu_torch.train.step import make_train_state, train_step

    batch = _to(train_batch(ds, cfg, rows), "cuda")
    b, t_x = batch["ids"].shape
    t_y = batch["spec"].shape[1]
    for precision, dtype in (("fast", torch.bfloat16), ("parity", torch.float32)):
        state = make_train_state(params_g_np, params_d_np, cfg, device="cuda")
        key = prng.prng_key(3, "cuda")
        for i in range(2):  # warm-up: cuDNN's and cuBLAS's first calls at these shapes
            train_step(state, batch, prng.fold_in(key, i), cfg=cfg, dtype=dtype)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for i in range(4):
            t0 = time.perf_counter()
            _, m = train_step(state, batch, prng.fold_in(key, 10 + i), cfg=cfg, dtype=dtype)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated() / 2**30
        check(all(math.isfinite(float(v)) for k, v in m.items() if k.startswith("loss")),
              f"train_step {precision} on the card: finite losses after 6 steps")
        neg = torch.randn((b, t_y, t_x), device="cuda")
        mas_times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            MAS.maximum_path(neg, batch["id_lengths"], batch["spec_lengths"])
            torch.cuda.synchronize()
            mas_times.append(time.perf_counter() - t0)
        step_ms, mas_ms = 1e3 * min(times), 1e3 * min(mas_times)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            train_step(state, batch, prng.fold_in(key, 20), cfg=cfg, dtype=dtype)
            torch.cuda.synchronize()
            prof_ms = 1e3 * (time.perf_counter() - t0)
        events = [e for e in prof.key_averages() if str(getattr(e, "device_type", "")).endswith("CUDA")]
        busy = sum(e.self_device_time_total for e in events) / 1e3
        top = [[e.key[:48], round(e.self_device_time_total / 1e3, 2), e.count]
               for e in sorted(events, key=lambda e: -e.self_device_time_total)[:6]]
        print(f"phase 7: train_step {precision}, medium, batch {b} ({t_x} ids, {t_y} frames): "
              f"{sorted(1e3 * t for t in times)} ms, best {step_ms:.1f} ms; MAS alone at ({b}, {t_y}, "
              f"{t_x}) {mas_ms:.1f} ms ({mas_ms / step_ms:.1%} of the step); peak memory {peak:.2f} GiB; "
              f"profiled step: device busy {busy:.1f} ms of {prof_ms:.1f} ms wall, "
              f"{sum(e.count for e in events)} kernels, top {top}  [{card}]", flush=True)
        del state


def variant_steps(ds: Path, card: str) -> None:
    """One in-process train_step each of a two-speaker VITS2 model and an
    MB-iSTFT model at the medium preset's width, on the card."""
    import torch

    from piper_tpu_torch.config import ModelConfig
    from piper_tpu_torch.ops import prng
    from piper_tpu_torch.train.step import init_params, make_train_state, train_step

    for name, cfg in (("vits2", ModelConfig.vits2("medium", num_symbols=256, num_speakers=2)),
                      ("mb_istft", ModelConfig.mb_istft("medium", num_symbols=256))):
        batch = train_batch(ds, cfg, 4)
        if cfg.num_speakers > 1:
            batch["sid"] = (torch.arange(4) % 2).numpy().astype("int32")
        g, d = init_params(5, cfg)
        state = make_train_state(g, d, cfg, device="cuda")
        t0 = time.perf_counter()
        _, m = train_step(state, _to(batch, "cuda"), prng.prng_key(2, "cuda"), cfg=cfg,
                          dtype=torch.bfloat16)
        losses = {k: float(v) for k, v in m.items() if k.startswith("loss")}
        check(all(math.isfinite(v) for v in losses.values()) and ("loss_dur_gen" in losses) == (name == "vits2"),
              f"{name} train_step on the card, medium, batch 4, fast: finite losses "
              f"{ {k: round(v, 4) for k, v in losses.items()} } in {time.perf_counter() - t0:.2f} s (cold)")


def seeded_noise_on_card() -> None:
    """The device noise of fixed keys equals the port's CPU noise: the
    bits exactly, the normals within 1e-6."""
    import torch

    from piper_tpu_torch.ops import prng
    from piper_tpu_torch.runtime import voice as RV

    keys = RV.key_table([RV.utterance_seed(s, [1, 0, 40 + i, 0, 2])
                         for i, s in enumerate((0, 1, 2**32 - 1, 77))])
    devs = (("cpu", "cpu"), ("card", "cuda"))
    bits = {r: prng.random_bits(keys.to(d), (3, 5, 7)).cpu() for r, d in devs}
    fn = {r: RV.frame_noise_rows(keys.to(d), 700, 192).cpu() for r, d in devs}
    dn = {r: RV.duration_noise_rows(keys.to(d), 90).cpu() for r, d in devs}
    err = max(float((fn["card"] - fn["cpu"]).abs().max()), float((dn["card"] - dn["cpu"]).abs().max()))
    check(torch.equal(bits["card"], bits["cpu"]) and err <= 1e-6,
          f"seeded noise: the card's threefry bits equal the CPU's, frame and duration normals "
          f"within {err:.2e} (<= 1e-6)")


def phase_training(card: str) -> None:
    """Phase 7 (see the module docstring)."""
    from piper_tpu_torch.config import ModelConfig
    from piper_tpu_torch.train.dataset import write_synthetic_dataset
    from piper_tpu_torch.train.step import init_params

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        ds = write_synthetic_dataset(tmp / "data", n_utterances=TRAIN_UTTERANCES, sample_rate=22050,
                                     num_symbols=256, seconds=(1.5, 4.0), ids=(30, 90), seed=0)
        cfg = ModelConfig.for_quality("medium", num_symbols=256)
        params_g, params_d = init_params(1, cfg)
        seeded_noise_on_card()
        from piper_tpu_torch.train.step import make_train_state

        cpu = make_train_state(params_g, params_d, cfg, device="cpu")
        train_modules_vs_cpu(ds, cfg, cpu.params_g, cpu.params_d)
        del cpu
        train_step_vs_cpu(ds, cfg, params_g, params_d)
        step_costs(ds, cfg, params_g, params_d, card)
        variant_steps(ds, card)
        train_cli(ds, tmp, card)


# ---------------------------------------------------------------------------
# Phase 8: the voice builder's path
# ---------------------------------------------------------------------------

BUILDER_UTTERANCES = 8  # voiced bursts of 0.6-1.2 s between 0.3-0.6 s of silence
BUILDER_RATE = 16000  # x-low's rate: preprocessing resamples the 22,050 Hz WAVs
VC_TEXT = "Speaker zero says this line, and speaker one will say it back."


def run_module(module: str, argv, timeout: int = 600) -> float:
    """python -m <module> argv in a process of its own (its stdout and
    stderr pass through); returns its wall seconds."""
    t0 = time.perf_counter()
    subprocess.run([sys.executable, "-m", module, *map(str, argv)], cwd=ROOT, check=True,
                   timeout=timeout)
    return time.perf_counter() - t0


def dataset_files(out: Path):
    """(config.json without piper_version, dataset.jsonl records with
    paths relative to `out`, {relative path: bytes} of every .npy)."""
    config = json.loads((out / "config.json").read_text())
    config.pop("piper_version")
    recs = [json.loads(line) for line in (out / "dataset.jsonl").read_text().splitlines() if line]
    for rec in recs:
        for key in ("audio_norm_path", "audio_spec_path"):
            rec[key] = str(Path(rec[key]).relative_to(out))
    npys = {str(p.relative_to(out)): p.read_bytes() for p in sorted(out.rglob("*.npy"))}
    return config, recs, npys


def preprocess_costs(corpus: Path, audio_min: float, card: str) -> None:
    """Host seconds per audio-minute of each step preprocessing takes per
    file (train/norm_audio.cache_norm_audio): the WAV read, the polyphase
    resample to 16 kHz, the Silero VAD's chunk scores (one detector, as a
    worker keeps one) and the spectrogram. cache_norm_audio reads and
    resamples twice (for the VAD, and at the target rate)."""
    from piper_tpu_torch.train import norm_audio as N

    det = N.SileroVAD()
    spent = dict.fromkeys(("read", "resample", "vad", "spectrogram"), 0.0)
    for wav_path in sorted((corpus / "wavs").glob("*.wav")):
        with wave.open(str(wav_path), "rb") as w:
            sr = w.getframerate()
        t0 = time.perf_counter()
        audio = N.load_audio(wav_path, sr)
        t1 = time.perf_counter()
        audio16 = N.resample(audio, sr, N.VAD_SAMPLE_RATE)
        t2 = time.perf_counter()
        offset, duration = N.trim_silence_vad(audio16, det)
        t3 = time.perf_counter()
        start = int(offset * BUILDER_RATE)
        end = start + int(duration * BUILDER_RATE) if duration is not None else len(audio16)
        N.spectrogram_np(audio16[start:end], n_fft=1024, hop_length=256, win_length=1024)
        t4 = time.perf_counter()
        for k, dt in zip(spent, (t1 - t0, t2 - t1, t3 - t2, t4 - t3)):
            spent[k] += dt
    per_min = {k: v / audio_min for k, v in spent.items()}
    print(f"phase 8: preprocessing on the host, s per audio-minute ({audio_min * 60:.2f} audio-s): "
          + ", ".join(f"{k} {v:.4f}" for k, v in per_min.items())
          + f"; cache_norm_audio's total {2 * per_min['read'] + 2 * per_min['resample'] + per_min['vad'] + per_min['spectrogram']:.4f}"
          f"  [{card}; host CPU]", flush=True)


def builder_preprocess(tmp: Path, card: str) -> Path:
    """The corpus through python -m piper_tpu_torch.train.preprocess with
    4 workers and with 1; returns the 4 workers' directory."""
    import numpy as np

    from piper_tpu_torch.train.dataset import write_synthetic_corpus
    from piper_tpu_torch.train.norm_audio import load_audio

    corpus = write_synthetic_corpus(tmp / "corpus", n_utterances=BUILDER_UTTERANCES,
                                    sample_rate=22050, seconds=(0.6, 1.2), seed=0)
    audio_s = 0.0
    for p in (corpus / "wavs").glob("*.wav"):
        with wave.open(str(p), "rb") as w:
            audio_s += w.getnframes() / w.getframerate()
    outs = {}
    for workers in (4, 1):
        out = tmp / f"dataset_{workers}"
        wall = run_module("piper_tpu_torch.train.preprocess", [
            "--input-dir", corpus, "--output-dir", out, "--language", "en-us",
            "--sample-rate", BUILDER_RATE, "--dataset-format", "ljspeech", "--phoneme-type", "text",
            "--max-workers", workers, "--single-speaker"])
        outs[workers] = dataset_files(out)
        print(f"phase 8: python -m piper_tpu_torch.train.preprocess --max-workers {workers}: "
              f"{wall:.2f} s for {audio_s:.2f} audio-s ({wall / (audio_s / 60):.2f} s per audio-minute, "
              f"process start and torch import included)  [{card}; host CPU]", flush=True)
    config, recs, npys = outs[4]
    kept = []
    for rec in recs:
        full = len(load_audio(rec["audio_path"], BUILDER_RATE))
        kept.append((len(np.load(tmp / "dataset_4" / rec["audio_norm_path"])), full))
    check(len(recs) == BUILDER_UTTERANCES and all(0 < k < f for k, f in kept),
          f"preprocess: {len(recs)} records, each trimmed by the Silero VAD and not to nothing "
          f"(kept/full samples {kept})")
    check(outs[4] == outs[1] and len(npys) == 2 * BUILDER_UTTERANCES,
          f"preprocess: --max-workers 4 and 1 wrote the same config.json, dataset.jsonl and "
          f"{len(npys)} .npy files")
    preprocess_costs(corpus, audio_s / 60, card)
    return tmp / "dataset_4"


def builder_train(data: Path, tmp: Path, card: str) -> None:
    """python -m piper_tpu_torch.train, 2 steps at the x-low preset on
    the preprocessed directory, on the card (in this process)."""
    import numpy as np

    from piper_tpu_torch.train.__main__ import main as train_main

    ckpt = tmp / "builder_ckpt"
    t0 = time.perf_counter()
    train_main(["--dataset-dir", str(data), "--checkpoint-dir", str(ckpt), "--quality", "x-low",
                "--batch-size", "4", "--single-bucket", "--max-steps", "2", "--log-steps", "1",
                "--checkpoint-steps", "2", "--validate-steps", "0", "--validation-split", "0",
                "--export-every", "2"])
    wall = time.perf_counter() - t0
    rows = [json.loads(line) for line in (ckpt / "metrics.jsonl").read_text().splitlines()]
    steps = [r["step"] for r in rows if "loss_gen_all" in r]
    finite = all(np.isfinite(v) for r in rows for k, v in r.items() if k.startswith("loss"))
    check(steps == [1, 2] and finite and (ckpt / "voice_2.npz").exists(),
          f"python -m piper_tpu_torch.train on the preprocessed directory: steps {steps}, every loss "
          f"finite, voice_2.npz written ({wall:.1f} s)  [{card}]")


def counted_run(fn):
    """fn() with the launch counts set to 0 just before and read just
    after, and every TorchVoice.submit's decodes recorded:
    (result, mrf_fused launches, fused_upsample_mrf launches, decodes)."""
    with counting_decodes() as decodes:
        zero_counts()
        out = fn()
        n_mrf, n_fused = read_counts()
    return out, n_mrf, n_fused, sum(decodes)


def builder_export(tmp: Path, card: str, launches: dict) -> Path:
    """Phase 3's medium voice through python -m piper_tpu_torch.export
    --format onnx, then the CLI on the .onnx and on the .npz with phase
    3's lines and seed, in both precisions: the same WAVs byte for byte."""
    from piper_tpu_torch.export import main as export_main

    onnx = tmp / "exported.onnx"
    t0 = time.perf_counter()
    export_main(["--input", str(tmp / "voice.npz"), "--format", "onnx", "--output", str(onnx)])
    export_s = time.perf_counter() - t0
    print(f"phase 8: python -m piper_tpu_torch.export --format onnx, medium voice: {export_s:.3f} s, "
          f"{onnx.stat().st_size / 2**20:.2f} MiB (.npz {(tmp / 'voice.npz').stat().st_size / 2**20:.2f} "
          f"MiB)  [{card}; host CPU]", flush=True)
    for precision in ("fast", "parity"):
        runs = {}
        for fmt, model in (("npz", tmp / "voice.npz"), ("onnx", onnx)):
            out = tmp / f"builder_{fmt}_{precision}"
            argv = ["-m", str(model), "-d", str(out), "--batch", "--seed", "1", "-q",
                    "--precision", precision]
            _, n_mrf, n_fused, decodes = counted_run(lambda: run_cli(argv, TEXTS))
            runs[fmt] = sorted(out.glob("*.wav"))
            if fmt == "onnx":
                launches["mrf_fused"] += n_mrf
                launches["fused_upsample_mrf"] += n_fused
                check(decodes >= 1 and n_mrf == decodes and n_fused == 2 * decodes,
                      f"CLI -m exported.onnx ({precision}): mrf_fused {n_mrf}, fused_upsample_mrf "
                      f"{n_fused} launches for {decodes} decodes")
        same = sum(a.name == b.name and a.read_bytes() == b.read_bytes()
                   for a, b in zip(runs["onnx"], runs["npz"]))
        check(len(runs["onnx"]) == len(TEXTS) and same == len(TEXTS),
              f"CLI -m exported.onnx ({precision}): {same} of {len(TEXTS)} WAVs equal the .npz's "
              f"byte for byte  [{card}]")
    return onnx


def builder_jsonl():
    """3 utterances of 40-100 ids (BOS, PAD-interspersed, EOS)."""
    import numpy as np

    rng = np.random.default_rng(8)
    return "".join(json.dumps({"phoneme_ids": [1, 0] + [int(x) for s in rng.integers(3, 256, n)
                                                        for x in (s, 0)] + [2]}) + "\n"
                   for n in (20, 35, 50))


@contextlib.contextmanager
def recorded_audio(module):
    """The float audio of each WAV written through `module`'s
    audio_float_to_int16, recorded while the block runs."""
    import numpy as np

    floats = []
    inner = module.audio_float_to_int16

    def spy(audio, *a, **k):
        floats.append(np.asarray(audio, np.float32).copy())
        return inner(audio, *a, **k)

    module.audio_float_to_int16 = spy
    try:
        yield floats
    finally:
        module.audio_float_to_int16 = inner


def run_infer(argv):
    """python -m piper_tpu_torch.infer in this process with the JSONL on
    stdin: (its seconds, the float audio of each WAV it wrote)."""
    import piper_tpu_torch.infer as I

    saved = sys.stdin
    sys.stdin = io.StringIO(builder_jsonl())
    try:
        with recorded_audio(I) as floats:
            stats = I.main(argv)
    finally:
        sys.stdin = saved
    return stats, floats


def builder_harness(onnx: Path, tmp: Path, card: str, launches: dict) -> None:
    """python -m piper_tpu_torch.infer --batch --seed 1 on the exported
    .onnx, with and without --denoiser-strength 0.005: the RTF of each
    (fast, on the card), the card against the CPU in parity (1e-3), and
    1 + 2 launches per decode (the denoiser's blank synthesis is one)."""
    import numpy as np

    audio = {}
    for precision, device, strength in (("fast", "cuda", "0"), ("fast", "cuda", "0.005"),
                                        ("parity", "cuda", "0"), ("parity", "cuda", "0.005"),
                                        ("parity", "cpu", "0"), ("parity", "cpu", "0.005")):
        argv = ["-m", str(onnx), "-o", str(tmp / f"infer_{precision}_{device}_{strength}"),
                "--batch", "--seed", "1", "--precision", precision, "--device", device,
                "--denoiser-strength", strength]
        (stats, floats), n_mrf, n_fused, decodes = counted_run(lambda: run_infer(argv))
        audio[precision, device, strength] = floats
        rtf = stats["infer_s"] / stats["audio_s"]
        rtf_d = (stats["infer_s"] + stats["denoise_s"]) / stats["audio_s"]
        print(f"phase 8: python -m piper_tpu_torch.infer --batch ({precision}, {device}, denoiser "
              f"{strength}): {len(floats)} WAVs, {stats['audio_s']:.2f} audio-s, infer "
              f"{stats['infer_s']:.4f} s (RTF {rtf:.5f}), denoiser {stats['denoise_s']:.4f} s "
              f"(RTF with it {rtf_d:.5f}; first call of this process's voice, cold)"
              f"  [{card if device == 'cuda' else 'host CPU'}]", flush=True)
        if device == "cuda":
            launches["mrf_fused"] += n_mrf
            launches["fused_upsample_mrf"] += n_fused
            check(decodes >= 1 and n_mrf == decodes and n_fused == 2 * decodes,
                  f"infer ({precision}, denoiser {strength}): mrf_fused {n_mrf}, fused_upsample_mrf "
                  f"{n_fused} launches for {decodes} decodes")
    for strength in ("0", "0.005"):
        card_a, cpu_a = audio["parity", "cuda", strength], audio["parity", "cpu", strength]
        same_len = len(card_a) == len(cpu_a) == 3 and all(a.shape == b.shape for a, b in zip(card_a, cpu_a))
        err = max(float(np.abs(a - b).max()) for a, b in zip(card_a, cpu_a)) if same_len else math.inf
        check(same_len and err < 1e-3,
              f"infer, denoiser {strength}: card vs CPU in parity, max_abs_err {err:.3e} (atol 1e-3)")
    moved = max(float(np.abs(a - b).max()) for a, b in zip(audio["parity", "cuda", "0"],
                                                           audio["parity", "cuda", "0.005"]))
    check(moved > 0, f"the denoiser changed the audio (max |change| {moved:.3e})")


def run_vc(argv):
    """python -m piper_tpu_torch.tools.voice_conversion in this process:
    (wall s, the float audio of each WAV it wrote)."""
    import piper_tpu_torch.runtime.wav as W
    from piper_tpu_torch.tools.voice_conversion import main as vc_main

    t0 = time.perf_counter()
    with recorded_audio(W) as floats:
        vc_main(argv)
    return time.perf_counter() - t0, floats


def builder_voice_conversion(tmp: Path, card: str, launches: dict) -> None:
    """The trained two-speaker x-low voice: speaker 0's WAV from the CLI
    converted to speaker 1 with --seed 3 on the card twice (same bytes)
    and on the CPU (1e-3); 1 + 2 launches per conversion; the warm wall
    and device ms per audio-second of voice_convert_audio."""
    import numpy as np
    import torch

    from piper_tpu_torch.models.vits import generator as G
    from piper_tpu_torch.ops import prng
    from piper_tpu_torch.runtime.voice import random_voice_config
    from piper_tpu_torch.runtime.voice_conversion import voice_convert_audio
    from piper_tpu_torch.runtime.wav import read_wav as read_pcm
    from piper_tpu_torch.weights.bridge import params_from_jax
    from piper_tpu_torch.weights.native import load_native

    d = tmp / "vc"
    d.mkdir()
    model = d / "voice.npz"
    shutil.copy(MS2_VOICE, model)
    tree, cfg = load_native(str(model))
    (d / "voice.npz.json").write_text(json.dumps(random_voice_config(cfg).to_dict()))
    src = d / "speaker0.wav"
    run_cli(["-m", str(model), "-f", str(src), "--seed", "1", "-s", "0", "-q"], [VC_TEXT])
    sr, pcm = read_pcm(src)
    audio_s = len(pcm) / sr
    outs = {}
    for run, device in (("card", "cuda"), ("card again", "cuda"), ("cpu", "cpu")):
        out = d / run.replace(" ", "_")
        argv = ["--model", str(model), "--source-speaker", "0", "--target-speaker", "1", "--seed", "3",
                "--device", device, "--output-dir", str(out), str(src)]
        (wall, floats), n_mrf, n_fused, _ = counted_run(lambda: run_vc(argv))
        outs[run] = (floats, (out / src.name).read_bytes())
        print(f"phase 8: python -m piper_tpu_torch.tools.voice_conversion ({device}, {audio_s:.2f} audio-s "
              f"at {sr} Hz, 0 -> 1): {wall:.3f} s, cold (load and first call included)"
              f"  [{card if device == 'cuda' else 'host CPU'}]", flush=True)
        if device == "cuda":
            launches["mrf_fused"] += n_mrf
            launches["fused_upsample_mrf"] += n_fused
            check(n_mrf == 1 and n_fused == 2,
                  f"voice conversion ({run}): mrf_fused {n_mrf}, fused_upsample_mrf {n_fused} launches "
                  f"for one conversion")
    card_a, cpu_a = outs["card"][0], outs["cpu"][0]
    ok = len(card_a) == len(cpu_a) == 1 and card_a[0].shape == cpu_a[0].shape and card_a[0].size > 0
    err = float(np.abs(card_a[0] - cpu_a[0]).max()) if ok else math.inf
    check(ok and err < 1e-3,
          f"voice conversion: card vs CPU, {card_a[0].size if ok else 0} samples, max_abs_err {err:.3e} "
          f"(atol 1e-3)")
    check(outs["card"][1] == outs["card again"][1], "voice conversion: --seed 3 twice, the same bytes")
    # warm: wall and device time of the conversion alone
    params = params_from_jax(tree, cfg, "cuda", torch.float32)
    tm = G.prepare_tm(params["dec"], cfg, torch.float32)
    x = pcm.astype(np.float32) / 32768.0
    fn = lambda: voice_convert_audio(params, x, 0, 1, cfg=cfg, tm=tm, key=prng.prng_key(3, "cuda"))
    fn()
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        fn()  # ends in the copy of the samples to the host
        walls.append(time.perf_counter() - t0)
    dev_ms = busy_ms(fn)
    print(f"phase 8: voice conversion warm, x-low trained, {audio_s:.2f} audio-s: wall {min(walls) * 1e3:.2f} "
          f"ms ({min(walls) * 1e3 / audio_s:.2f} ms per audio-s), device {dev_ms:.2f} ms "
          f"({dev_ms / audio_s:.2f} ms per audio-s)  [{card}]", flush=True)


def phase_voice_builder(tmp: Path, card: str) -> dict:
    """Phase 8 (see the module docstring); returns the kernels' launches
    on its entry points' runs on the card."""
    launches = {"mrf_fused": 0, "fused_upsample_mrf": 0}
    data = builder_preprocess(tmp, card)
    builder_train(data, tmp, card)
    onnx = builder_export(tmp, card, launches)
    builder_harness(onnx, tmp, card, launches)
    builder_voice_conversion(tmp, card, launches)
    return launches


# ---------------------------------------------------------------------------
# Phase 9: speculative serving
# ---------------------------------------------------------------------------

SPEC_LENGTHS = (8, 20, 35, 60, 90, 130, 180, 240)  # ids of phase 9's rows: 3 phoneme buckets
TRAINED_MS2 = ROOT / "tests" / "data" / "voice_xlow_ms2_trained_fp16.npz"
ESTIMATOR_PROBE = """
import json, sys
sys.path.insert(0, sys.argv[1])
import torch
from piper_tpu_torch.config import SynthesisConfig
from piper_tpu_torch.runtime.voice import TorchVoice
voice = TorchVoice.load(sys.argv[2], precision="fast", device="cuda", estimator_cache=True, seed=0)
loaded = voice._ratio is not None
exists = voice._estimator_cache_path.exists()
voice.synthesize_ids_batch(json.loads(sys.argv[3]), syn=SynthesisConfig(seed=1))
print(json.dumps({"loaded": loaded, "snapshot_after_load": exists, "paths": voice.path_counts,
                  "snapshot": str(voice._estimator_cache_path)}))
"""


def spec_rows(num_symbols: int, seed: int = 0):
    import numpy as np

    rng = np.random.default_rng(seed)
    return [[1, 0] + [int(x) for s in rng.integers(3, num_symbols, n) for x in (s, 0)] + [2]
            for n in SPEC_LENGTHS]


def exact_then_speculative(voice, name: str, rows, syn, card: str):
    """The exact batch (the first: it calibrates the estimator), then the
    same rows again: the voice's path counter shows the speculative path,
    that submit has no frames_wait span, and its int16 audio equals the
    exact batch's bit for bit. Returns (exact, speculative audio)."""
    import numpy as np

    from piper_tpu_torch.runtime.profiling import StageTimer

    seeds = list(range(len(rows)))
    voice.timer = StageTimer()
    t0 = time.perf_counter()
    exact = voice.collect(voice.submit(rows, syn=syn, row_seeds=seeds))
    t_exact = time.perf_counter() - t0
    waits, before = voice.timer.counts.get("frames_wait", 0), dict(voice.path_counts)
    t0 = time.perf_counter()
    handle = voice.submit(rows, syn=syn, row_seeds=seeds)
    t_submit = time.perf_counter() - t0
    spec = voice.collect(handle)
    t_spec = time.perf_counter() - t0
    waits_after, voice.timer = voice.timer.counts.get("frames_wait", 0), None
    check("spec" in handle and voice.path_counts["speculative"] == before["speculative"] + 1
          and voice.path_counts["exact"] == before["exact"],
          f"{name}: the batch after the exact one took the speculative path ({voice.path_counts})")
    check(waits == 1 and waits_after == waits, f"{name}: frames_wait spans: {waits} in the exact "
          f"batch's submit, {waits_after - waits} in the speculative one's")
    same = sum(len(a) == len(b) and np.array_equal(a, b) for a, b in zip(exact, spec))
    check(same == len(rows) and min(len(a) for a in exact) > 0,
          f"{name}: {same} of {len(rows)} rows of the speculative batch equal the exact batch's int16 "
          "audio bit for bit")
    frames = [len(a) // voice.model_cfg.upsample_factor for a in exact]
    print(f"{name}: {len(rows)} rows of {min(frames)}-{max(frames)} frames; exact batch {t_exact:.4f} s "
          f"(first calls), speculative submit {t_submit:.4f} s, with collect {t_spec:.4f} s (first "
          f"calls at its buckets); estimator {voice._ratio}, margin {voice.spec_margin}  [{card}]",
          flush=True)
    return exact, spec


def phase_speculative(tmp: Path, cfg, params_np, variants: Path, card: str) -> dict:
    """9: the speculative serving path on the card, in fast precision:
    phase 3's medium voice, phase 6's VITS2 voice and the trained
    two-speaker x-low voice, each an exact batch then the same rows
    speculative; the mu-law wire (exact and speculative transfers, the
    CLI); a forced bucket overflow, a forced margin shortfall and a row
    past the ladder; the estimator snapshot in a fresh process, and a
    corrupt one. Returns the kernels' launches of the phase's batches and
    CLI runs."""
    import numpy as np

    from piper_tpu_torch.config import SynthesisConfig
    from piper_tpu_torch.runtime import codec
    from piper_tpu_torch.runtime.voice import TorchVoice, read_header
    from piper_tpu_torch.runtime.wav import int16_to_float
    from piper_tpu_torch.weights.native import load_native

    u = cfg.upsample_factor
    rows = spec_rows(cfg.num_symbols)
    syn = SynthesisConfig(seed=3)
    launches = {"mrf_fused": 0, "fused_upsample_mrf": 0}

    def counted(fn):
        """fn() with the kernels' launches counted from 0 and added to the
        phase's sums: (result, mrf_fused launches, fused launches)."""
        zero_counts()
        out = fn()
        n_mrf, n_fused = read_counts()
        launches["mrf_fused"] += n_mrf
        launches["fused_upsample_mrf"] += n_fused
        return out, n_mrf, n_fused

    medium = TorchVoice(params_np, cfg, _voice_cfg(cfg), precision="fast", device="cuda", seed=0)
    (exact, _), _, _ = counted(lambda: exact_then_speculative(medium, "medium", rows, syn, card))
    for name, path, speaker in (("VITS2 (post perturbed)", variants / "vits2.npz", 1),
                                ("trained two-speaker x-low", TRAINED_MS2, 1)):
        params, vcfg = load_native(str(path))
        voice = TorchVoice(params, vcfg, _voice_cfg(vcfg), precision="fast", device="cuda", seed=0)
        exact_then_speculative(voice, name, spec_rows(vcfg.num_symbols),
                               SynthesisConfig(seed=3, speaker_id=speaker), card)
        del voice

    # the mu-law wire: the exact path's transfer and the speculative one's
    # rows are the numpy encoder's bytes of the int16 path's samples, its
    # header the exact frame counts
    ref16 = [np.round(a * 32767).astype(np.int16) for a in exact]
    seeds = list(range(len(rows)))
    mulaw = TorchVoice(params_np, cfg, _voice_cfg(cfg), precision="fast", device="cuda", seed=0,
                       wire_format="mulaw")
    first = mulaw.submit(rows, syn=syn, row_seeds=seeds)
    got = mulaw.collect(first)
    host = first["host"].numpy()
    same = sum(np.array_equal(host[st : st + n], codec.mulaw_encode(ref16[i])) for i, st, n in first["rows"])
    check(host.dtype == np.uint8 and same == len(rows),
          f"mu-law wire, exact path: {same} of {len(rows)} rows' bytes equal the numpy encoder's of the "
          "int16 wire's samples")
    handle = mulaw.submit(rows, syn=syn, row_seeds=seeds)
    flat = handle["host"]
    spec = mulaw.collect(handle)
    flat = flat.numpy()
    hdr = read_header(flat, len(rows))
    want = [len(ref16[r[0]]) // u for r in handle["spec"]["rows"]]
    check("spec" in handle and list(hdr) == want,
          f"mu-law wire, speculative path: the header's frame counts equal the exact path's ({want[:4]}...)")
    out, ok, fit = handle["spec"]["a0"], 0, 0
    for r in handle["spec"]["rows"]:
        n = len(ref16[r[0]])
        if out + n <= handle["spec"]["total"]:
            fit += 1
            ok += np.array_equal(flat[out : out + n], codec.mulaw_encode(ref16[r[0]]))
        out += n
    dec = sum(np.array_equal(a, b) and np.array_equal(a, int16_to_float(codec.mulaw_decode(codec.mulaw_encode(w))))
              for a, b, w in zip(got, spec, ref16))
    check(fit > 0 and ok == fit and dec == len(rows),
          f"mu-law wire, speculative path: {ok} of the {fit} rows in the transfer equal the numpy "
          f"encoder's bytes; {dec} of {len(rows)} rows collect to the int16 path's mu-law audio")
    print(f"mu-law wire: {flat.nbytes} bytes for {sum(len(a) for a in exact) / cfg.audio.sample_rate:.2f} "
          f"audio-s in the speculative transfer  [{card}]", flush=True)
    del mulaw
    out_raw = {}
    for wire in ("int16", "mulaw"):
        buf = io.BytesIO()
        saved = sys.stdout
        sys.stdout = type("Out", (), {"buffer": buf, "write": lambda self, x: None,
                                      "flush": lambda self: None})()
        try:
            counted(lambda: run_cli(["-m", str(tmp / "voice.npz"), "--output-raw", "--raw-format", "mulaw",
                                     "--wire-format", wire, "--seed", "1", "-q"], TEXTS[:2]))
        finally:
            sys.stdout = saved
        out_raw[wire] = buf.getvalue()
    check(len(out_raw["mulaw"]) == len(out_raw["int16"]) > 0,
          f"the CLI's --output-raw --raw-format mulaw with --wire-format mulaw: {len(out_raw['mulaw'])} "
          f"bytes, as with --wire-format int16 ({len(out_raw['int16'])})")

    # the misses, on the calibrated medium voice: each against the exact audio
    def miss(what, setup, count, rows_, syn_, ref):
        setup()
        before = dict(medium.path_counts)

        def run():
            handle = medium.submit(rows_, syn=syn_, row_seeds=list(range(len(rows_))))
            planned = handle["decodes"]
            return handle, planned, medium.collect(handle)

        (handle, planned, got), n_mrf, n_fused = counted(run)
        moved = medium.path_counts[count] - before[count]
        same = sum(np.array_equal(a, b) for a, b in zip(got, ref))
        check("spec" in handle and moved > 0 and same == len(ref),
              f"{what}: {moved} rows {count}, {same} of {len(ref)} rows equal the exact audio bit for bit")
        check(n_mrf == handle["decodes"] and n_fused == 2 * handle["decodes"],
              f"{what}: mrf_fused {n_mrf} and fused_upsample_mrf {n_fused} launches for "
              f"{planned} decodes and {handle['decodes'] - planned} re-decodes (1 + 2 each)")

    saved = (medium._ratio, medium._spec_margin)
    miss("forced bucket overflow (estimator 0.5 frames per id)",
         lambda: setattr(medium, "_ratio", (0.5, 0.5)), "redecoded", rows, syn, exact)
    medium._ratio, medium._spec_margin = saved
    miss("forced margin shortfall (margin 0.25)", lambda: setattr(medium, "_spec_margin", 0.25),
         "refetched", rows, syn, exact)
    medium._ratio, medium._spec_margin = saved
    ids, lsyn, frames = long_row(medium, 5000)
    solo = TorchVoice(params_np, cfg, _voice_cfg(cfg), precision="fast", device="cuda", seed=0)
    long_exact = solo.collect(solo.submit([ids], syn=lsyn, row_seeds=[0]))
    del solo
    miss(f"a row past the ladder ({frames} frames)", lambda: None, "longform", [ids], lsyn, long_exact)

    # the estimator snapshot: a fresh process starts speculative; a
    # corrupt snapshot is deleted and ignored
    cached = TorchVoice.load(tmp / "voice.npz", precision="fast", device="cuda", estimator_cache=True, seed=0)
    cached.synthesize_ids_batch(rows[:4], syn=syn)
    snap = cached._estimator_cache_path
    check(snap.exists() and ROOT not in snap.parents,
          f"estimator snapshot written outside the checkout: {snap}")
    del cached
    for what, corrupt in (("fresh process", None), ("corrupt snapshot", "{not json")):
        if corrupt is not None:
            snap.write_text(corrupt)
        t0 = time.perf_counter()
        res = subprocess.run([sys.executable, "-c", ESTIMATOR_PROBE, str(ROOT), str(tmp / "voice.npz"),
                              json.dumps(rows[:4])], capture_output=True, text=True, timeout=300)
        probe = json.loads(res.stdout.strip().splitlines()[-1]) if res.returncode == 0 else {}
        if corrupt is None:
            check(probe.get("loaded") is True and probe["paths"]["speculative"] == 1
                  and probe["paths"]["exact"] == 0,
                  f"estimator cache, {what} ({time.perf_counter() - t0:.1f} s): loaded the snapshot, its "
                  f"first batch went speculative: {probe or res.stderr[-400:]}")
        else:
            check(probe.get("loaded") is False and probe["snapshot_after_load"] is False
                  and probe["paths"]["exact"] == 1,
                  f"estimator cache, {what} ({time.perf_counter() - t0:.1f} s): deleted and ignored, the "
                  f"first batch exact: {probe or res.stderr[-400:]}")
    return launches


# ---------------------------------------------------------------------------
# Phase 10: dispatch fusion
# ---------------------------------------------------------------------------


def phase_fusion(cfg, params_np, variants: Path, card: str) -> dict:
    """10: dispatch fusion on the card, fast precision: phase 9's rows on
    phase 3's medium voice, phase 6's VITS2 voice and the trained
    two-speaker x-low voice, on each wire. An exact batch, then three
    plans brought to their second sighting on the per-decode path, the
    estimate pinned before every batch so that each plan recurs: the
    rows under two seed sets, the rows with the estimate at 0.5 frames
    per id (every row overflows its bucket) and the rows with the margin
    at 0.25 (rows fall past the transfer). Then each plan's third batch
    runs it eagerly and captures its graph, and the next batch replays
    it (a plan is captured once the graph captured before it has
    recurred, runtime/voice.py); the first plan is replayed once more
    after the other plans' batches have recycled the pinned host blocks:
    the
    per-decode bits (the exact bits for the misses, with the re-decodes
    and re-fetches), `fused` counted, 1 + 2 launches per decode and
    re-decode. No capture fails. Returns the batches' launches."""
    import numpy as np

    from piper_tpu_torch.config import SynthesisConfig
    from piper_tpu_torch.runtime.voice import TorchVoice
    from piper_tpu_torch.weights.native import load_native

    launches = {"mrf_fused": 0, "fused_upsample_mrf": 0}
    voices = [("medium", params_np, cfg, None)]
    for name, path in (("VITS2 (post perturbed)", variants / "vits2.npz"),
                       ("trained two-speaker x-low", TRAINED_MS2)):
        params, vcfg = load_native(str(path))
        voices.append((name, params, vcfg, 1))
    for name, params, vcfg, speaker in voices:
        rows = spec_rows(vcfg.num_symbols)
        syn = SynthesisConfig(seed=3, speaker_id=speaker)
        seeds = [[10 * i + j for j in range(len(rows))] for i in range(2)]
        for wire in ("int16", "mulaw"):
            what = f"{name}, {wire} wire"
            t0 = time.perf_counter()
            voice = TorchVoice(params, vcfg, _voice_cfg(vcfg), precision="fast", device="cuda", seed=0,
                               wire_format=wire)
            exact = voice.collect(voice.submit(rows, syn=syn, row_seeds=seeds[0]))
            settled = voice._ratio, voice._spec_margin
            pins = {"plan": settled, "overflow": ((0.5, 0.5), settled[1]), "shortfall": (settled[0], 0.25)}

            def batch(pin, seed_set):
                """A batch of the rows under a pinned estimate: (audio,
                handle, host s in submit, launches)."""
                voice._ratio, voice._spec_margin = pins[pin]
                zero_counts()
                t_sub = time.perf_counter()
                handle = voice.submit(rows, syn=syn, row_seeds=seed_set)
                t_sub = time.perf_counter() - t_sub
                out = voice.collect(handle)
                n = list(read_counts())
                launches["mrf_fused"] += n[0]
                launches["fused_upsample_mrf"] += n[1]
                return out, handle, t_sub, n

            per_decode = [batch("plan", s) for s in seeds]
            for pin in ("overflow", "shortfall"):
                for _ in range(2):
                    out = batch(pin, seeds[0])[0]
                    same = sum(len(a) == len(b) and np.array_equal(a, b) for a, b in zip(exact, out))
                    check(same == len(rows), f"{what}, {pin} on the per-decode path: {same} of {len(rows)} "
                                             "rows equal the exact batch bit for bit")
            check(voice._fused_cache == {} and voice.path_counts["fused"] == 0,
                  f"{what}: no plan captured before its third sighting ({voice._fused_cache})")
            same = sum(len(a) == len(b) and np.array_equal(a, b) for a, b in zip(exact, per_decode[0][0]))
            check(same == len(rows), f"{what}: {same} of {len(rows)} rows of the per-decode batches equal "
                                     "the exact batch bit for bit")
            # (pin, seed set, reference, miss counter, capture or replay)
            runs = [("plan", 0, per_decode[0][0], None, "capture"),
                    ("plan", 1, per_decode[1][0], None, "replay"),
                    ("overflow", 0, exact, "redecoded", "capture"),
                    ("overflow", 0, exact, "redecoded", "replay"),
                    ("shortfall", 0, exact, "refetched", "capture"),
                    ("shortfall", 0, exact, "refetched", "replay"),
                    ("plan", 0, per_decode[0][0], None, "replay")]
            fused_s = []
            for pin, s_i, ref, miss, kind in runs:
                before = dict(voice.path_counts)
                out, handle, t_sub, n = batch(pin, seeds[s_i])
                moved = {k: voice.path_counts[k] - before[k] for k in before}
                same = sum(len(a) == len(b) and np.array_equal(a, b) for a, b in zip(ref, out))
                check(moved["fused"] == 1 and moved["fused_failed"] == 0 and (miss is None or moved[miss] > 0)
                      and same == len(rows),
                      f"{what}, {pin} (seeds {s_i}): the batch's {kind} of its plan graph ({moved}); "
                      f"{same} of {len(rows)} rows equal the {'exact' if miss else 'per-decode'} audio "
                      f"bit for bit")
                check(n == [handle["decodes"], 2 * handle["decodes"]],
                      f"{what}, {pin} ({kind}): mrf_fused {n[0]} and fused_upsample_mrf {n[1]} launches "
                      f"for {handle['decodes']} decodes and re-decodes (1 + 2 each)")
                if pin == "plan" and kind == "replay":
                    fused_s.append(t_sub)
            states = sorted(voice._fused_cache.values())
            check(states == ["ready"] * 3 and voice.path_counts["fused_failed"] == 0,
                  f"{what}: plan graphs {states}, {voice.path_counts['fused_failed']} captures failed")
            plan_s = [round(sec, 3) for k, sec in voice.graphs.capture_seconds.items() if k[0] == "plan"]
            print(f"{what}: submit's host s, per-decode {per_decode[1][2]:.4f}, fused {fused_s[0]:.4f}; plan "
                  f"capture s {plan_s}; {len(voice.graphs.capture_seconds)} graphs, "
                  f"{voice.graphs.memory_bytes() / 2**20:.1f} MiB; {time.perf_counter() - t0:.1f} s of wall  "
                  f"[{card}]", flush=True)
            del voice
    return launches


SPANNED = ("submit", "_encode", "_read_frames", "_latents", "_flow", "_vocode", "_run_plan")


def span_methods(cls):
    """Time every method of SPANNED that `cls` has, at class level (each
    checkout names its steps differently): returns {name: [calls, s]},
    which the caller clears between measurements."""
    import threading
    from collections import defaultdict

    spans = defaultdict(lambda: [0, 0.0])
    lock = threading.Lock()

    def timed(name, fn):
        def run(self, *a, **k):
            t0 = time.perf_counter()
            try:
                return fn(self, *a, **k)
            finally:
                dt = time.perf_counter() - t0
                with lock:
                    spans[name][0] += 1
                    spans[name][1] += dt

        return run

    for name in SPANNED:
        if hasattr(cls, name):
            setattr(cls, name, timed(name, getattr(cls, name)))
    return spans


def per_submit_ms(spans):
    """Host ms per submit of each spanned method, and the rest of submit."""
    n = max(spans.get("submit", [0, 0.0])[0], 1)
    parts = {k.lstrip("_"): s / n * 1e3 for k, (_, s) in spans.items() if k != "submit"}
    total = spans.get("submit", [0, 0.0])[1] / n * 1e3
    parts["rest_of_submit"] = total - sum(parts.values())
    return {"submits": spans.get("submit", [0, 0.0])[0], "submit_ms": total, "parts_ms": parts}


def measure(root: str) -> int:
    """python3 chip_smoke.py --measure DIR: the numbers of the checkout
    in DIR (this one, or its parent unpacked beside it), so that two
    versions run the same measurement in one call on one card; one JSON
    line. The cold main path (the CLI's first run in a fresh process,
    after the kernels' build, then a second run) with submit's host time
    by method; a warm batch (16 rows) with its device time by kernel;
    after warmup((1, 16), full=True), the serving window of phase 4 under
    the server's default grouping with submit's host time by method, its
    profiled rerun's idle share, and STREAMS warm /streams."""
    import urllib.parse

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    sys.path.insert(0, str(Path(root).resolve()))
    from piper_tpu_torch.ops.cuda import vocoder as V
    from piper_tpu_torch.runtime import voice as RV

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    spans = span_methods(RV.TorchVoice)
    decodes = []
    submit = RV.TorchVoice.submit

    def counting_submit(self, *a, **k):
        handle = submit(self, *a, **k)
        decodes.append(handle.get("decodes", 0))
        return handle

    RV.TorchVoice.submit = counting_submit
    out = {"root": root, "card": card}
    t0 = time.perf_counter()
    V.build()
    out["build_s"] = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        os.environ["PIPER_TPU_CACHE"] = str(tmp / "cache")  # estimator snapshots, outside the checkout
        cfg, params_np = make_voice(tmp)
        for run in ("cold", "second"):
            spans.clear()
            decodes.clear()
            t0 = time.perf_counter()
            run_cli(["-m", str(tmp / "voice.npz"), "-d", str(tmp / run), "--batch", "--seed", "1", "-q"],
                    TEXTS)
            out[f"cli_{run}"] = {"wall_s": time.perf_counter() - t0, "decodes": sum(decodes),
                                 **per_submit_ms(spans)}

    fast = RV.TorchVoice(params_np, cfg, _voice_cfg(cfg), precision="fast", device="cuda")
    rng = np.random.default_rng(0)
    rows = [[1, 0] + [int(t) for t in rng.integers(3, 256, 250)] + [0, 2] for _ in range(16)]
    # a graph is captured at its key's second call, a plan graph (dispatch
    # fusion, where the checkout has it) at its plan's third sighting once
    # the estimate and the margin have settled
    settle(fast, rows, _syn(seed=7))
    paths0 = dict(getattr(fast, "path_counts", {}))
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        fast.synthesize_ids_batch(rows, syn=_syn(seed=7))
        times.append(time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fast.synthesize_ids_batch(rows, syn=_syn(seed=7))
    events = [e for e in prof.key_averages() if str(getattr(e, "device_type", "")).endswith("CUDA")]
    out["warm_batch"] = {
        "paths": {k: n - paths0[k] for k, n in getattr(fast, "path_counts", {}).items()},
        "wall_ms": [t * 1e3 for t in times],
        "device_ms": sum(e.self_device_time_total for e in events) / 1e3,
        "top_kernels_ms": [[e.key[:60], e.self_device_time_total / 1e3, e.count] for e in
                           sorted(events, key=lambda e: -e.self_device_time_total)[:8]],
    }
    # the transfer's bytes per audio-second of the warm batch on each wire
    wires = {}
    for wire in ("int16", "mulaw") if hasattr(fast, "set_wire_format") else ("int16",):
        if wire != "int16":
            fast.set_wire_format(wire)
        handle = fast.submit(rows, syn=_syn(seed=7))
        audio_s = sum(len(a) for a in fast.collect(handle)) / cfg.audio.sample_rate
        nbytes = handle["host"].numel() * handle["host"].element_size()
        wires[wire] = {"bytes": nbytes, "audio_s": audio_s, "bytes_per_audio_s": nbytes / audio_s,
                       "path": "speculative" if "spec" in handle else "exact"}
    out["wire"] = wires
    del fast

    voice = RV.TorchVoice(params_np, cfg, _voice_cfg(cfg), precision="fast", device="cuda", seed=0)
    if hasattr(voice, "decode_grouping"):
        voice.decode_grouping = "uniform"  # the HTTP server's default
    t0 = time.perf_counter()
    voice.warmup((1, 16), full=True)
    out["warmup_s"] = time.perf_counter() - t0
    if hasattr(voice, "graphs"):
        out["graphs"] = {**voice.graphs.stats, "mib": voice.graphs.memory_bytes() / 2**20}
    server, port, thread = serve_in_process(voice)
    try:
        paths = window_paths()
        for p in paths:  # the request path once
            http_get(port, p)
        spans.clear()
        decodes.clear()
        batches0 = voice.batcher.stats["batches"]
        paths0 = dict(getattr(voice, "path_counts", {}))
        captured0 = dict(getattr(voice.graphs, "capture_seconds", {}))
        got, wall = clients(port, paths, 16, WINDOW_ROUNDS)
        lat = [g[3] for _, g in got]
        out["window"] = {
            "requests": len(got), "ok": sum(g[0] == 200 for _, g in got), "wall_s": wall,
            "requests_per_s": len(got) / wall, "p50_s": float(np.percentile(lat, 50)),
            "p99_s": float(np.percentile(lat, 99)),
            "batches": voice.batcher.stats["batches"] - batches0, "decodes": sum(decodes),
            "paths": {k: n - paths0[k] for k, n in getattr(voice, "path_counts", {}).items()},
            **per_submit_ms(spans),
        }
        if hasattr(voice.graphs, "capture_seconds"):  # the submitting threads' captures in the window
            held = voice.graphs.capture_seconds
            out["graphs_after_window"] = {
                "graphs": len(held), "mib": voice.graphs.memory_bytes() / 2**20,
                "plan_graphs": len([k for k in held if k[0] == "plan"]),
                "window_capture_s": [sec for k, sec in held.items() if k not in captured0]}
        paths0 = dict(getattr(voice, "path_counts", {}))
        n, pwall, busy = profiled_window(port, paths, WINDOW_ROUNDS)
        out["profiled_window"] = {
            "requests": n, "wall_s": pwall, "device_busy_s": busy, "idle_share": 1 - busy / pwall,
            "paths": {k: c - paths0[k] for k, c in getattr(voice, "path_counts", {}).items()}}
        q = f"/stream?text={urllib.parse.quote(STREAM_TEXT)}&seed=4"
        http_stream(port, q)
        chunks, firsts, totals = timed_streams(port, q, STREAMS)
        n_chunks = len(chunks[0])
        out["stream"] = {
            "chunks": n_chunks, "first_chunk_p50_s": float(np.percentile(firsts, 50)),
            "first_chunk_p99_s": float(np.percentile(firsts, 99)),
            "whole_p50_s": float(np.percentile(totals, 50)),
            "wall_per_chunk_ms": float(np.percentile(totals, 50)) / n_chunks * 1e3,
        }
    finally:
        stop_serving(server, thread, voice)
    if (Path(root) / "piper_tpu_torch" / "tools" / "profile_stages.py").exists():
        res = subprocess.run([sys.executable, "-m", "piper_tpu_torch.tools.profile_stages"],
                             cwd=root, capture_output=True, text=True, timeout=900)
        out["profile_stages"] = (json.loads(res.stdout.strip().splitlines()[-1]) if res.returncode == 0
                                 else {"error": res.stderr[-300:]})
    print(json.dumps(out), flush=True)
    return 0


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if argv[:1] == ["--measure"] and len(argv) == 2:
        return measure(argv[1])
    if argv:
        print("usage: chip_smoke.py [--measure DIR]", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from piper_tpu_torch.ops.cuda import vocoder as V
    from piper_tpu_torch.runtime.voice import tf32_off

    tf32_off()  # float32 without TF32 everywhere, as every TorchVoice leaves it

    # 1. the card, versions, kernel build
    with phase("1, the card and the kernels' build"):
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
        # the estimator snapshots of every voice loaded with the cache (the
        # CLI's, the server's, the benchmark's), outside the checkout
        os.environ["PIPER_TPU_CACHE"] = str(tmp / "cache")
        cfg, params_np = make_voice(tmp)
        with phase("2, kernels against their plain versions"):
            results = phase_kernels(cfg, params_np, peaks)
        with phase("3, the main path (CLI) and the benchmark CLI"):
            launches, hifigan_ms = phase_main_path(tmp, cfg, params_np, smi)
            phase_benchmark(tmp, smi)
        with phase("4, the serving path"):
            phase_serving(cfg, params_np, smi, peaks)
        with phase("5, published voices"):
            phase_published_files(tmp, cfg, params_np, smi)
            phase_two_speakers(smi)
            phase_long_row(cfg, params_np, smi, peaks)
        # 6. VITS2 and MB-iSTFT voices; the kernels' launches are summed
        # over the main paths of phase 3 and of this phase's CLI runs
        with phase("6, VITS2 and MB-iSTFT voices"):
            variants = tmp / "variants"
            variants.mkdir()
            for variant, (path, vcfg, vparams) in write_variant_voices(variants / "voices").items():
                for k, n in phase_variant(variants, variant, path, vcfg, vparams, smi,
                                          hifigan_ms).items():
                    launches[k] += n
        with phase("7, training on the card"):
            phase_training(smi)
        # 8. the voice builder's path, on phase 3's medium voice and WAVs;
        # its entry points' launches join the sums
        with phase("8, the voice builder's path"):
            for k, n in phase_voice_builder(tmp, smi).items():
                launches[k] += n
        # 9. speculative serving; its CLI runs' launches join the sums
        with phase("9, speculative serving"):
            for k, n in phase_speculative(tmp, cfg, params_np, tmp / "variants" / "voices", smi).items():
                launches[k] += n
        # 10. dispatch fusion; its batches' launches join the sums
        with phase("10, dispatch fusion"):
            for k, n in phase_fusion(cfg, params_np, tmp / "variants" / "voices", smi).items():
                launches[k] += n

    if FAILURES:
        for stream in (sys.stdout, sys.stderr):
            print(f"chip_smoke: {len(FAILURES)} check(s) failed:", *FAILURES, sep="\n  ",
                  file=stream, flush=True)
        return 1
    kernels = []
    for kname in ("mrf_fused", "fused_upsample_mrf"):
        row = dict(results[(kname, "bfloat16")])
        row["launches"] = launches[kname]
        for key in ("gflop", "mbytes"):
            row.pop(key)
        kernels.append(row)
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
