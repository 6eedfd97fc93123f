"""How many rows a reverse-flow graph should hold: its cost by rows and
frame bucket, and what whole requests wait under each choice.

    python tools/flow_rows.py [--tree DIR] [--voices vits,vits2] [--out FILE]

A voice runs a row's reverse flow at the row's own frame bucket, in CUDA
graphs of flow_graph_rows(bucket) rows padded with copies of their
first row (runtime/voice.py), so a row's bits never follow its batch.
This measures what that row count costs, on the medium VITS voice (seed
1) and the medium two-speaker VITS2 voice (seed 11, speaker 1), random
weights with every flow's zero-initialised `post` perturbed by
N(0, 0.02^2), in both precisions:

Part 1 (graphs): for every frame bucket of the ladder and each row count
of --rows, one flow graph in a graph cache of its own
(runtime/graphs.py): the device time of one replay (torch.profiler, the
sum of kernel time, mean of 3), its event time (CUDA events, mean of
10) and the memory its pool and inputs hold.

Part 2 (requests, this checkout only): the wall of whole requests
(submit to collect) of 1, 4, 8 and 16 rows of 254 ids, at length_scale
1 and 8 (the rows' frames and bucket are in each record), under each
--budgets value of runtime/voice.py's FLOW_FRAMES (0: every row in a
graph of its own; 65536: 16 rows at every bucket),
the median of 5 after two calls that capture the graphs, and the
device time of one call.

--tree DIR imports piper_tpu_torch from DIR instead (another checkout,
e.g. a parent commit unpacked with git archive; Part 1 only, through
TorchVoice._flow). Prints one JSON line per measurement and writes all
of them to --out. Needs a card.
"""

from __future__ import annotations

import argparse
import inspect
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
POST_SCALE = 0.02


def busy_ms(fn, reps: int = 3) -> float:
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if str(getattr(e, "device_type", "")).endswith("CUDA")) / 1e3 / reps


def event_ms(fn, reps: int = 10) -> float:
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def make_voice(name: str, precision: str):
    import numpy as np

    from piper_tpu_torch.config import ModelConfig
    from piper_tpu_torch.models.vits.model import init_synthesizer_params
    from piper_tpu_torch.runtime.voice import TorchVoice, random_voice_config

    if name == "vits2":
        cfg, seed = ModelConfig.vits2("medium", num_symbols=256, num_speakers=2), 11
    else:
        cfg, seed = ModelConfig.for_quality("medium", num_symbols=256), 1
    params = init_synthesizer_params(seed, cfg)
    rng = np.random.default_rng(12)
    for layer in params["flow"]["layers"]:
        layer["post"] = {k: (v + POST_SCALE * rng.standard_normal(v.shape)).astype(np.float32)
                         for k, v in layer["post"].items()}
    return TorchVoice(params, cfg, random_voice_config(cfg), precision=precision, device="cuda", seed=0)


def graph_costs(voice, rows_list, emit) -> None:
    import torch

    from piper_tpu_torch.config import SynthesisConfig
    from piper_tpu_torch.runtime.graphs import GraphCache

    cfg = voice.model_cfg
    g = torch.Generator().manual_seed(4)
    syn = SynthesisConfig(speaker_id=1 if cfg.num_speakers > 1 else None)
    for fb in voice.frame_buckets:
        for r in rows_list:
            voice.graphs = GraphCache(voice.device)
            torch.cuda.empty_cache()
            z = torch.randn((r, fb, cfg.inter_channels), generator=g).to("cuda", voice.dtype)
            mask = torch.ones((r, fb, 1), dtype=voice.dtype, device="cuda")
            sid = voice._speaker(syn, r)
            if "keys" in inspect.signature(voice._flow).parameters:
                # a flow graph that draws its rows' frame noise and latents
                noise_in = voice._noise_inputs(list(range(r)), syn)
                inputs = (z, z, mask, *noise_in, sid)
            else:  # an older checkout's flow graph: the latents as input
                inputs = (z, mask, sid)
            with torch.inference_mode():
                def fn():
                    return voice._flow(*inputs)
                fn()
                fn()  # a graph's key is captured at its second call
                emit({"part": "graph", "bucket": fb, "rows": r,
                      "device_ms": busy_ms(fn), "event_ms": event_ms(fn),
                      "graph_mib": voice.graphs.memory_bytes() / 2**20})
    voice.graphs = GraphCache(voice.device)
    torch.cuda.empty_cache()


def request_walls(voice, budgets, ns, emit) -> None:
    import numpy as np
    import torch

    from piper_tpu_torch.config import SynthesisConfig
    from piper_tpu_torch.runtime import voice as RV
    from piper_tpu_torch.runtime.graphs import GraphCache

    budget0 = RV.FLOW_FRAMES
    rng = np.random.default_rng(0)
    rows = [[1, 0] + [int(t) for t in rng.integers(3, 256, 250)] + [0, 2] for _ in range(max(ns))]
    spk = 1 if voice.model_cfg.num_speakers > 1 else None
    for scale in (1.0, 8.0):
        for budget in budgets:
            RV.FLOW_FRAMES = budget
            voice.graphs = GraphCache(voice.device)
            torch.cuda.empty_cache()
            for n in ns:
                syn = SynthesisConfig(length_scale=scale, speaker_id=spk)

                def call():
                    return voice.collect(voice.submit(rows[:n], syn=syn, row_seeds=list(range(n))))
                with torch.inference_mode():
                    call()
                    out = call()
                    walls = []
                    for _ in range(5):
                        t0 = time.perf_counter()
                        call()
                        walls.append((time.perf_counter() - t0) * 1e3)
                    dev = busy_ms(call, reps=1)
                frames = [len(a) // voice.model_cfg.upsample_factor for a in out]
                bucket = min(b for b in voice.frame_buckets if b >= max(frames))
                emit({"part": "request", "flow_frames": budget, "rows": n,
                      "bucket": bucket, "frames": [min(frames), max(frames)],
                      "rows_per_graph": RV.flow_graph_rows(bucket, voice.dtype),
                      "wall_ms_median": statistics.median(walls), "wall_ms": walls,
                      "device_ms": dev})
    RV.FLOW_FRAMES = budget0
    voice.graphs = GraphCache(voice.device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="tools/flow_rows.py")
    ap.add_argument("--tree", help="import piper_tpu_torch from this checkout (Part 1 only)")
    ap.add_argument("--voices", default="vits,vits2")
    ap.add_argument("--precisions", default="fast,parity")
    ap.add_argument("--rows", default="1,2,4,8,16")
    ap.add_argument("--budgets", default="0,4096,8192,16384,65536")
    ap.add_argument("--requests", default="1,4,8,16", help="rows per request of Part 2")
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" / "flow_rows.jsonl"))
    args = ap.parse_args(argv)
    tree = Path(args.tree).resolve() if args.tree else ROOT
    sys.path.insert(0, str(tree))
    import torch

    if not torch.cuda.is_available():
        print("tools/flow_rows.py needs a CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    with out.open("a") as f:
        for name in args.voices.split(","):
            for precision in args.precisions.split(","):
                voice = make_voice(name, precision)
                head = {"tree": str(tree), "voice": name, "precision": precision, "card": card}

                def emit(rec):
                    line = json.dumps({**head, **rec})
                    print(line, flush=True)
                    f.write(line + "\n")
                graph_costs(voice, [int(r) for r in args.rows.split(",")], emit)
                if tree == ROOT:
                    request_walls(voice, [int(b) for b in args.budgets.split(",")],
                                  [int(n) for n in args.requests.split(",")], emit)
                del voice
                torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
