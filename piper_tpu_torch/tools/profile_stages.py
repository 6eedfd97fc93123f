"""Per-stage device time of the serving pipeline.

Counterpart of piper_tpu/tools/profile_stages.py: times each serving
stage (encode, latents, vocode, pack) alone at the benchmark's shapes,
after warm calls (which also capture the stages' CUDA graphs), with
CUDA events around --reps calls, on a random-weight voice in fast
precision at one phoneme bucket (--pb) and one frame bucket (--fb):

  encode   the encode graphs at (pb, ENCODE_ROWS rows), ids and keys
           uploaded (runtime/voice.py _encode)
  latents  prior expansion and the latents graph at (fb, batch rows):
           each frame's noise on the device, then z_p
  vocode   TorchVoice._vocode at fb: each row's frame windows (noise,
           latents, reverse flow, the generator's plain stages) in the
           frame-window graph, then both kernels (the speculative path's
           decode: every window of the bucket)
  pack2    the self-describing packed transfer of the vocode's rows
  flow_reverse  the reverse flow alone, eagerly at (batch, fb)
  generator     vocode - latents - flow_reverse

    python -m piper_tpu_torch.tools.profile_stages [--batch 32] [--fb 768]

Prints one JSON line with the card's name and power limit. Runs on
CUDA; without a GPU it raises (--device cpu runs it on the CPU, with
host-clock times that are no device metric).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="piper_tpu_torch.tools.profile_stages")
    ap.add_argument("--quality", default="medium")
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--pb", type=int, default=512)
    ap.add_argument("--fb", type=int, default=768)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from ..config import SynthesisConfig
    from ..models.vits import model as M
    from ..runtime import voice as RV

    voice = RV.TorchVoice.random(args.quality, num_symbols=256, seed=0, precision="fast",
                                 device=args.device, decode_grouping="uniform")
    voice.phoneme_buckets, voice.frame_buckets = [args.pb], [args.fb]
    cuda = voice.device.type == "cuda"
    if cuda:
        from ..ops.cuda import vocoder as V

        V.build()
    b = args.batch
    rng = np.random.default_rng(0)
    rows = [[int(t) for t in rng.integers(3, 250, args.pb)] for _ in range(b)]
    keys = [RV.utterance_seed(0, r) for r in rows]
    syn = SynthesisConfig(seed=0)

    def timed(fn):
        """ms per call of fn (warm calls first), and its last output."""
        for _ in range(2):
            out = fn()
        if cuda:
            torch.cuda.synchronize()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(args.reps):
                out = fn()
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / args.reps, out
        t0 = time.perf_counter()
        for _ in range(args.reps):
            out = fn()
        return (time.perf_counter() - t0) * 1e3 / args.reps, out

    results = {}
    with torch.inference_mode():
        ms, (enc, frames) = timed(lambda: voice._encode(rows, keys, args.pb, syn))
        results["encode_ms"] = round(ms, 3)
        keys_t, scale_t = voice._noise_inputs(keys, syn)

        def latents():
            m_p, logs_p, y_mask = M.expand_prior(enc, args.fb)
            return voice._graph("latents", voice._latents_step,
                                (m_p, logs_p, y_mask, keys_t, scale_t)), y_mask

        ms, (z_p, y_mask) = timed(latents)
        results["latents_ms"] = round(ms, 3)
        windows = [-(-args.fb // RV.WINDOW_FRAMES)] * b
        ms, audio = timed(lambda: voice._vocode(enc, args.fb, keys_t, scale_t, None, windows,
                                                args.fb))
        results["vocode_ms"] = round(ms, 3)
        audio = torch.round(audio.float().clamp(-1.0, 1.0) * 32767.0).to(torch.int16)
        a0 = -(-2 * b // 128) * 128
        total = a0 + (1 << 20)
        u = voice.model_cfg.upsample_factor
        ms, _ = timed(lambda: RV.pack2((audio,), (frames,), a0, total, u))
        results["pack2_ms"] = round(ms, 3)
        ms, _ = timed(lambda: M.synthesizer_flow(voice.params, z_p, y_mask, cfg=voice.model_cfg))
        results["flow_reverse_ms"] = round(ms, 3)
    results["generator_ms"] = round(
        results["vocode_ms"] - results["latents_ms"] - results["flow_reverse_ms"], 3)
    results.update(batch=b, pb=args.pb, fb=args.fb, quality=args.quality)
    results["sum_ms"] = round(results["encode_ms"] + results["latents_ms"]
                              + results["vocode_ms"] + results["pack2_ms"], 3)
    if cuda:
        results["device"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=False).stdout.strip().splitlines()[0]
        results["timing"] = "cuda events"
    else:
        results["device"] = "cpu"
        results["timing"] = "host clock, CPU"
    print(json.dumps(results))


if __name__ == "__main__":
    main()
