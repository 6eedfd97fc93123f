"""Benchmark harness with the reference's stdin-JSONL protocol.

Counterpart of piper_tpu/benchmark.py. Parity:
src/benchmark/benchmark_onnx.py: reads {"phoneme_ids": [...]} JSONL from
stdin, synthesizes each utterance, and prints a JSON report
{load_sec, rtf_mean, rtf_stdev, rtfs[]}.

Extensions, as in the JAX package: --batch mode reports batched
throughput (audio-seconds/s per card) beside the per-utterance RTF, and
--repeat takes the best of several timings after a warm-up (warm()). Runs on
CUDA unless --device cpu is given (and raises without a GPU); every
timing ends when the audio is on the host.

-m takes what the CLI's -m takes (.onnx, .ckpt, .npz or a registry
voice name, with --data-dir, --download-dir and --update-voices).

Usage:
  python -m piper_tpu_torch.benchmark -m voice.npz < test_en-us.jsonl
  python -m piper_tpu_torch.benchmark -m en_US-lessac-medium < test_en-us.jsonl
  python -m piper_tpu_torch.benchmark -m voice.npz --device cpu --batch < in.jsonl
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from typing import List

import numpy as np


def warm(voice, utterances: List[List[int]], syn) -> None:
    """Kernel builds and first calls of every shape the timings below
    run. A CUDA graph is captured at its key's second call
    (runtime/graphs.py), so the full set and each utterance run twice:
    the timed runs only replay."""
    for _ in range(2):
        voice.synthesize_ids_batch(utterances, syn=syn)
        for ids in utterances:
            voice.synthesize_ids_batch([ids], syn=syn)


def main(argv=None) -> None:
    from .__main__ import add_voice_arguments, load_voice

    p = argparse.ArgumentParser(prog="piper_tpu_torch.benchmark")
    add_voice_arguments(p)
    p.add_argument("--batch", action="store_true",
                   help="Also measure batched throughput")
    p.add_argument("--repeat", type=int, default=1,
                   help="Timing repetitions (after warmup)")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    from .config import SynthesisConfig

    start = time.perf_counter()
    voice = load_voice(args)
    load_sec = time.perf_counter() - start

    utterances: List[List[int]] = []
    for line in sys.stdin:
        line = line.strip()
        if not line:
            continue
        utterances.append(json.loads(line)["phoneme_ids"])

    syn = SynthesisConfig(seed=args.seed)
    sr = voice.config.sample_rate

    warm(voice, utterances, syn)

    # Per-utterance RTF (reference protocol: one at a time).
    rtfs: List[float] = []
    for ids in utterances:
        best = float("inf")
        for _ in range(args.repeat):
            t0 = time.perf_counter()
            audio = voice.synthesize_ids_batch([ids], syn=syn)[0]
            dt = time.perf_counter() - t0
            best = min(best, dt)
        audio_sec = len(audio) / sr
        if audio_sec > 0:
            rtfs.append(best / audio_sec)

    report = {
        "load_sec": load_sec,
        "rtf_mean": statistics.mean(rtfs) if rtfs else None,
        "rtf_stdev": statistics.stdev(rtfs) if len(rtfs) > 1 else 0.0,
        "rtfs": rtfs,
    }

    if args.batch:
        times = []
        audio_sec = 0.0
        for _ in range(max(args.repeat, 3)):
            t0 = time.perf_counter()
            out = voice.synthesize_ids_batch(utterances, syn=syn)
            times.append(time.perf_counter() - t0)
            audio_sec = sum(len(a) for a in out) / sr
        batch_wall = float(np.median(times))
        report["batch"] = {
            "utterances": len(utterances),
            "audio_seconds": audio_sec,
            "wall_s": batch_wall,
            # a TorchVoice runs on one card
            "audio_seconds_per_s_per_chip": audio_sec / batch_wall,
            "rtf": batch_wall / audio_sec,
        }

    json.dump(report, sys.stdout)
    print("")


if __name__ == "__main__":
    main()
