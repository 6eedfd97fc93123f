"""Which layers move a row with the batch it rides in, and what turning
TF32 off costs fast precision.

    python tools/row_invariance.py [--quality medium] [--device cuda]

Part 1: the rows of a coalesced batch (tests/test_torch_cuda.py's 16
rows, one group per phoneme bucket, padded to a power of two with
copies of its first row) go through each layer that runs over the
whole batch: the text encoder, the duration predictor, the reverse
flow and conv_pre, once over the group and once per row alone at the
row's own length (and, for the frame-level layers, alone at the
group's length). Prints the largest difference on valid positions per
layer and precision: 0 means that layer keeps a row's bits.

Part 2: a warm fast-precision batch of 16 rows with the TF32 switches
at PyTorch's defaults and with both off (as a TorchVoice leaves them): the int16 samples that differ,
and the device time of the batch (torch.profiler, the sum of kernel
time), in turns A B B A.

On a VITS2 voice Part 1 adds the flow's windowed attention alone
(flow_attention: layer 0's, on random hidden states), on an MB-iSTFT
voice the generator over the group under its length mask
(mb_generator_masked; the decode path runs it row by row instead).

--perturb-post STD adds noise to the flows' zero-initialised `post`
of --voice's tree first (a random voice's flow is otherwise the
identity, and no layer of it can move a row).

Part 3, with --voice (a native .npz voice of any variant, e.g. the
trained two-speaker tests/data/voice_xlow_ms2_trained_fp16.npz, or
chip_smoke.write_variant_voices' VITS2 and MB-iSTFT voices): the voice's
own stages (encode: m_p, logs_p, durations; latents z_p; the reverse
flow; the generator's audio) on one coalesced submit of the 16 rows
against each row submitted alone, in both precisions, for --speaker
(and Part 1 on that voice with the speaker's embedding in every layer
it conditions). 0 means the stage keeps a row's bits. With it, the
wall of the 16-row submit five times (the first two capture graphs).

Prints one JSON line per part. Runs on CUDA unless --device cpu.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from piper_tpu_torch.config import ModelConfig, SynthesisConfig  # noqa: E402
from piper_tpu_torch.models.vits import duration as D  # noqa: E402
from piper_tpu_torch.models.vits import encoder as E  # noqa: E402
from piper_tpu_torch.models.vits import flow as F  # noqa: E402
from piper_tpu_torch.models.vits import generator as G  # noqa: E402
from piper_tpu_torch.models.vits import istft_generator as MB  # noqa: E402
from piper_tpu_torch.models.vits import model as M  # noqa: E402
from piper_tpu_torch.models.vits.model import init_synthesizer_params  # noqa: E402
from piper_tpu_torch.ops import nn as tnn  # noqa: E402
from piper_tpu_torch.runtime import batching  # noqa: E402
from piper_tpu_torch.runtime.voice import (  # noqa: E402
    TorchVoice, random_voice_config, resolve_device, tf32_off, utterance_seed,
)
from piper_tpu_torch.weights.native import load_native  # noqa: E402

LENGTHS = (5, 23, 40, 61, 90, 120, 14, 77, 33, 8, 101, 47, 66, 19, 130, 55)


def _ids(n: int, num_symbols: int = 256):
    g = torch.Generator().manual_seed(n)
    return [1, 0] + [int(x) for s in torch.randint(3, num_symbols, (n,), generator=g) for x in (s, 0)] + [2]


def _max_diff(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max()) if a.numel() else 0.0


def layer_diffs(voice: TorchVoice, speaker=None) -> dict:
    """Largest |row in group - row alone| per layer over every group
    (with `speaker`, each layer conditioned on its embedding)."""
    cfg, p, dt, dev = voice.model_cfg, voice.params, voice.dtype, voice.device
    rows = [_ids(n, cfg.num_symbols) for n in LENGTHS]
    gen = torch.Generator().manual_seed(0)
    out = {k: 0.0 for k in ("text_encoder", "duration", "flow", "flow_group_length",
                            "conv_pre", "conv_pre_group_length")}
    if cfg.flow_transformer:
        out.update(flow_attention=0.0, flow_attention_group_length=0.0)
    if cfg.vocoder == "mb_istft":
        out.update(mb_generator_masked=0.0)
    u = cfg.upsample_factor
    with torch.inference_mode():
        for bucket, idx in batching.group_by_bucket([len(r) for r in rows], voice.phoneme_buckets):
            # padded to a power of two with copies of the group's first
            # row, as the encode graphs pad
            idx = idx + idx[:1] * (batching.round_rows(len(idx)) - len(idx))
            b = len(idx)
            ids = torch.zeros((b, bucket), dtype=torch.long)
            for j, i in enumerate(idx):
                ids[j, : len(rows[i])] = torch.tensor(rows[i])
            lens = torch.tensor([len(rows[i]) for i in idx])
            ids, lens = ids.to(dev), lens.to(dev)
            g = None if speaker is None else M.speaker_embedding(
                p, cfg, torch.full((b,), speaker, dtype=torch.long, device=dev))
            x_mask = tnn.sequence_mask(lens, bucket).to(dt)
            x, m_p, _ = E.text_encoder_apply(p["enc_p"], ids, x_mask, cfg=cfg, dtype=dt, g=g)
            noise = torch.randn((b, bucket, 2), generator=gen).to(dev)
            logw = D.sdp_reverse(p["dp"], x, x_mask, cfg=cfg, noise_w=0.8, noise=noise, dtype=dt, g=g)
            # frame-level layers: rows of 3x their ids' length in frames
            frames = [3 * len(rows[i]) for i in idx]
            t = max(frames)
            f_mask = (torch.arange(t)[None, :] < torch.tensor(frames)[:, None])[..., None]
            z = (torch.randn((b, t, cfg.inter_channels), generator=gen) * f_mask).to(dev, dt)
            f_mask = f_mask.to(dev, dt)
            zf = F.flow_apply(p["flow"], z, f_mask, cfg=cfg, reverse=True, g=g)
            pre = G._conv_pre(p["dec"], zf * f_mask, g)
            if cfg.flow_transformer:
                attn = p["flow"]["layers"][0]["attn"]
                h = (torch.randn((b, t, cfg.hidden_channels), generator=gen).to(dev, dt) * f_mask)
                att = E.local_attention_apply(attn, h, f_mask, n_heads=2)
            if cfg.vocoder == "mb_istft":
                wav = MB.mb_istft_generator_apply(p["dec"], zf * f_mask, f_mask, cfg=cfg, g=g,
                                                  tables=p.get("dec_mb"))
            for j in range(b):
                gj = None if g is None else g[j : j + 1]
                n_ids = int(lens[j])
                xj, mj, _ = E.text_encoder_apply(p["enc_p"], ids[j : j + 1], x_mask[j : j + 1],
                                                 cfg=cfg, dtype=dt, g=gj)
                out["text_encoder"] = max(out["text_encoder"], _max_diff(mj[0, :n_ids], m_p[j, :n_ids]))
                lj = D.sdp_reverse(p["dp"], x[j : j + 1], x_mask[j : j + 1], cfg=cfg, noise_w=0.8,
                                   noise=noise[j : j + 1], dtype=dt, g=gj)
                out["duration"] = max(out["duration"], _max_diff(lj[0, :n_ids], logw[j, :n_ids]))
                n = frames[j]
                for key, width in (("flow", n), ("flow_group_length", t)):
                    zj = F.flow_apply(p["flow"], z[j : j + 1, :width], f_mask[j : j + 1, :width],
                                      cfg=cfg, reverse=True, g=gj)
                    out[key] = max(out[key], _max_diff(zj[0, :n], zf[j, :n]))
                    # conv_pre on the group's flow output: this layer alone
                    pj = G._conv_pre(p["dec"], (zf * f_mask)[j : j + 1, :width], gj)
                    ckey = key.replace("flow", "conv_pre")
                    out[ckey] = max(out[ckey], _max_diff(pj[0, :n], pre[j, :n]))
                    if cfg.flow_transformer:
                        aj = E.local_attention_apply(attn, h[j : j + 1, :width], f_mask[j : j + 1, :width],
                                                     n_heads=2)
                        akey = key.replace("flow", "flow_attention")
                        out[akey] = max(out[akey], _max_diff(aj[0, :n], att[j, :n]))
                if cfg.vocoder == "mb_istft":
                    wj = MB.mb_istft_generator_apply(p["dec"], (zf * f_mask)[j : j + 1, :n], None, cfg=cfg,
                                                     g=gj, tables=p.get("dec_mb"))
                    out["mb_generator_masked"] = max(out["mb_generator_masked"],
                                                     _max_diff(wj[0], wav[j, : n * u]))
    return out


def stage_diffs(voice: TorchVoice, speaker=None) -> dict:
    """Largest |row in one coalesced submit - row submitted alone| per
    stage of the voice's own path: each stage's per-row output is
    recorded by the row's noise key, on the batch and on each solo run."""
    cfg = voice.model_cfg
    rows = [_ids(n, cfg.num_symbols) for n in LENGTHS]
    seeds = list(range(len(rows)))
    rec, decode_rows, decode_keys = {}, [], []
    encode, noise_inputs, flow_rows = voice._encode, voice._noise_inputs, voice._flow_rows
    generate = M.synthesizer_generate

    def put(stage, key, t):
        rec[(stage, key)] = t.float().cpu()

    def rec_encode(rows_ids, keys, bucket, syn):
        enc, frames = encode(rows_ids, keys, bucket, syn)
        for j, key in enumerate(keys):
            n = len(rows_ids[j])
            for stage, t in (("m_p", enc.m_p), ("logs_p", enc.logs_p), ("durations", enc.durations)):
                put(stage, key, t[j, :n])
        return enc, frames

    def rec_noise_inputs(keys, syn):  # a decode's row keys, before its flows
        decode_keys[:] = list(keys)
        return noise_inputs(keys, syn)

    def rec_flow_rows(m_p, logs_p, y_mask, keys, scale, sid, frames):
        # the latents the flow graphs draw, recomputed eagerly (elementwise:
        # the same bits at the decode's bucket as at each row's own)
        (z_p,) = voice._latents_step(m_p, logs_p, y_mask, keys, scale)
        decode_rows[:] = list(zip(decode_keys, frames))
        for j, (key, f) in enumerate(decode_rows):
            put("z_p", key, z_p[j, :f])
        return flow_rows(m_p, logs_p, y_mask, keys, scale, sid, frames)

    def rec_generate(params, z, *a, **k):
        audio = generate(params, z, *a, **k)
        for j, (key, f) in enumerate(decode_rows):
            put("flow", key, z[j, :f])  # the generator's input
            put("audio", key, audio[j, : f * cfg.upsample_factor])
        return audio

    syn = SynthesisConfig(speaker_id=speaker)
    walls = []
    for _ in range(5):  # the first two capture the graphs, the rest replay
        t0 = time.perf_counter()
        voice.collect(voice.submit(rows, syn=syn, row_seeds=seeds))
        walls.append((time.perf_counter() - t0) * 1e3)
    voice._encode, voice._noise_inputs, voice._flow_rows = rec_encode, rec_noise_inputs, rec_flow_rows
    M.synthesizer_generate = rec_generate
    try:
        voice.collect(voice.submit(rows, syn=syn, row_seeds=seeds))
        together, rec = rec, {}
        for row, seed in zip(rows, seeds):
            voice.synthesize_ids_batch([row], syn=SynthesisConfig(seed=seed, speaker_id=speaker))
    finally:
        del voice._encode, voice._noise_inputs, voice._flow_rows
        M.synthesizer_generate = generate
    out = {}
    for (stage, key), t in together.items():
        alone = rec[(stage, key)]
        d = _max_diff(t, alone) if t.shape == alone.shape else float("inf")
        out[stage] = max(out.get(stage, 0.0), d)
    return {"max_abs_diff": out, "batch_wall_ms": walls}


def tf32_cost(voice: TorchVoice, reps: int = 3) -> dict:
    """Fast precision, a warm 16-row batch: TF32 switches at PyTorch's
    defaults (A) and both off (B)."""
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.default_rng(0)
    rows = [[1, 0] + [int(t) for t in rng.integers(3, 256, 250)] + [0, 2] for _ in range(16)]
    syn = SynthesisConfig(seed=7)
    # A: PyTorch's defaults (no TF32 in matmuls, TF32 in cuDNN); B: both off
    flags = {"A": (False, True), "B": (False, False)}
    outs, device_ms, wall_ms = {}, {"A": [], "B": []}, {"A": [], "B": []}
    for which in ["A", "B", "B", "A"] * reps:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags[which]
        voice.synthesize_ids_batch(rows, syn=syn)  # warm at these flags
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            got = voice.synthesize_ids_batch(rows, syn=syn)
            wall_ms[which].append((time.perf_counter() - t0) * 1e3)
        ev = [e for e in prof.key_averages() if str(getattr(e, "device_type", "")).endswith("CUDA")]
        device_ms[which].append(sum(e.self_device_time_total for e in ev) / 1e3)
        outs[which] = np.concatenate(got)
    tf32_off()
    a, b = (np.round(outs[k] * 32767).astype(np.int32) for k in "AB")
    return {
        "flags_A": flags["A"], "flags_B": flags["B"], "samples": int(a.size),
        "samples_differing": int((a != b).sum()), "max_int16_step": int(np.abs(a - b).max()),
        "device_ms_A": device_ms["A"], "device_ms_B": device_ms["B"],
        "wall_ms_A": wall_ms["A"], "wall_ms_B": wall_ms["B"],
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="tools/row_invariance.py")
    ap.add_argument("--quality", default="medium")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--voice", help="a native .npz voice: Part 1 and Part 3 on it, no Part 2")
    ap.add_argument("--speaker", type=int, default=1, help="the speaker of --voice's rows")
    ap.add_argument("--perturb-post", type=float, default=0.0, metavar="STD",
                    help="add N(0, STD^2) noise (seed 12) to every flow's post first: a random "
                         "voice's zero post makes its flow the identity, which hides its rounding")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if args.voice:
        params, cfg = load_native(args.voice)
        if args.perturb_post:
            rng = np.random.default_rng(12)
            for layer in params["flow"]["layers"]:
                layer["post"] = {k: (v + args.perturb_post * rng.standard_normal(v.shape)).astype(np.float32)
                                 for k, v in layer["post"].items()}
        name = torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu"
        speaker = args.speaker if cfg.num_speakers > 1 else None
        for precision in ("parity", "fast"):
            voice = TorchVoice(params, cfg, random_voice_config(cfg), precision=precision,
                               device=dev, seed=0)
            print(json.dumps({"part": "layers", "voice": args.voice, "speaker": speaker,
                              "perturb_post": args.perturb_post, "precision": precision, "device": name,
                              "max_abs_diff": layer_diffs(voice, speaker)}), flush=True)
            print(json.dumps({"part": "stages", "voice": args.voice, "speaker": speaker,
                              "perturb_post": args.perturb_post, "precision": precision, "device": name,
                              **stage_diffs(voice, speaker)}), flush=True)
        return
    cfg = ModelConfig.for_quality(args.quality, num_symbols=256)
    params = init_synthesizer_params(2, cfg)
    name = torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu"
    for precision in ("parity", "fast"):
        voice = TorchVoice(params, cfg, random_voice_config(cfg), precision=precision,
                           device=dev, seed=0)
        print(json.dumps({"part": "layers", "quality": args.quality, "precision": precision,
                          "device": name, "max_abs_diff": layer_diffs(voice)}), flush=True)
    fast = TorchVoice(params, cfg, random_voice_config(cfg), precision="fast", device=dev, seed=0)
    print(json.dumps({"part": "tf32", "quality": args.quality, "device": name,
                      **tf32_cost(fast, args.reps)}), flush=True)


if __name__ == "__main__":
    main()
