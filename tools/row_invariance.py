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
(mb_generator_masked; the decode path runs it in frame windows).

--perturb-post STD adds noise to the flows' zero-initialised `post`
of --voice's tree first (a random voice's flow is otherwise the
identity, and no layer of it can move a row).

Part 3, with --voice (a native .npz voice of any variant, e.g. the
trained two-speaker tests/data/voice_xlow_ms2_trained_fp16.npz, or
chip_smoke.write_variant_voices' VITS2 and MB-iSTFT voices): the voice's
own stages (encode: m_p, logs_p, durations; the frame windows: the
latents, the reverse flow and the generator's plain stages; the audio)
on one coalesced submit of the 16 rows
against each row submitted alone, in both precisions, for --speaker
(and Part 1 on that voice with the speaker's embedding in every layer
it conditions). 0 means the stage keeps a row's bits. With it, the
wall of the 16-row submit five times (the first two capture graphs).

Part 4, with --buckets (fast precision, the only one the speculative
path runs in): does a row keep its bits at any frame bucket? For each
plain frame-level stage of the decode (the reverse flow, on VITS2 its
windowed attention alone, conv_pre, the wide NWC upsample stages, the
polyphase transposed conv before mrf_fused, MB-iSTFT's generator) and
for the whole vocode (flow, generator, kernels), a row computed as the
exact path computes it (the flow at the row's own frame bucket, the
generator's stages alone at the row's own length) against the same row
at each larger bucket of the ladder under its length mask, alone and
inside a group of rows at that bucket (as many as a flow graph holds
there: 8192 frames in bf16, at most 16 rows). Runs the x-low, medium
and high presets, a VITS2 and an MB-iSTFT medium voice (random weights,
seeds 2, 11 and 12, every flow's `post` perturbed by --perturb-post,
0.02 when not given) and --voice if given, one JSON line each: the
largest difference per stage and bucket, [alone, in the group].

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
from piper_tpu_torch.runtime import voice as RV  # noqa: E402
from piper_tpu_torch.runtime.voice import (  # noqa: E402
    TorchVoice, random_voice_config, resolve_device, tf32_off,
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
    recorded by the row's noise key, on the batch and on each solo run.
    Every submit takes the exact path (the estimator is reset first), so
    each decode knows its rows' frame counts."""
    cfg = voice.model_cfg
    rows = [_ids(n, cfg.num_symbols) for n in LENGTHS]
    seeds = list(range(len(rows)))
    rec, decode_rows = {}, []
    encode, decode_members, frames_fn = voice._encode, voice._decode_members, voice._frames
    u, f_pre = cfg.upsample_factor, voice._prefix_factor

    def put(stage, key, t):
        rec[(stage, key)] = t.float().cpu()

    def rec_encode(rows_ids, keys, bucket, syn):
        enc, frames = encode(rows_ids, keys, bucket, syn)
        for j, key in enumerate(keys):
            n = len(rows_ids[j])
            for stage, t in (("m_p", enc.m_p), ("logs_p", enc.logs_p), ("durations", enc.durations)):
                put(stage, key, t[j, :n])
        return enc, frames

    def rec_decode(enc, rkeys, members, fbucket, frames, syn):
        decode_rows[:] = [(rkeys[j], f) for j, f in zip(members, frames)]
        audio = decode_members(enc, rkeys, members, fbucket, frames, syn)
        for j, (key, f) in enumerate(decode_rows):
            put("audio", key, audio[j, : f * u])
        return audio

    def rec_frames(*a):
        # the frame windows' stitched output: latents, flow and the
        # generator's plain stages (MB-iSTFT: its whole generator)
        x = frames_fn(*a)
        for j, (key, f) in enumerate(decode_rows):
            put("frames", key, x[j, ..., : f * f_pre])
        return x

    def submit(batch, syn, row_seeds=None):
        voice._ratio = None
        return voice.collect(voice.submit(batch, syn=syn, row_seeds=row_seeds))

    syn = SynthesisConfig(speaker_id=speaker)
    walls = []
    for _ in range(5):  # the first two capture the graphs, the rest replay
        t0 = time.perf_counter()
        submit(rows, syn, seeds)
        walls.append((time.perf_counter() - t0) * 1e3)
    voice._encode, voice._decode_members, voice._frames = rec_encode, rec_decode, rec_frames
    try:
        submit(rows, syn, seeds)
        together, rec = rec, {}
        for row, seed in zip(rows, seeds):
            submit([row], SynthesisConfig(seed=seed, speaker_id=speaker))
    finally:
        del voice._encode, voice._decode_members, voice._frames
    out = {}
    for (stage, key), t in together.items():
        alone = rec[(stage, key)]
        d = _max_diff(t, alone) if t.shape == alone.shape else float("inf")
        out[stage] = max(out.get(stage, 0.0), d)
    return {"max_abs_diff": out, "batch_wall_ms": walls}


BUCKET_ROWS = (100, 250, 600)  # frames of the rows whose bucket is varied


def _group_rows(bucket: int) -> int:
    n = 1
    while 2 * n <= 16 and 2 * n * bucket <= 8192:
        n *= 2
    return n


def _perturb_post(params, std: float, seed: int = 12) -> None:
    rng = np.random.default_rng(seed)
    for layer in params["flow"]["layers"]:
        layer["post"] = {k: (np.asarray(v) + std * rng.standard_normal(np.shape(v))).astype(np.float32)
                         for k, v in layer["post"].items()}


def bucket_diffs(voice: TorchVoice, speaker=None, rows=BUCKET_ROWS, top=None) -> dict:
    """{stage: {bucket: [alone, group]}}: the largest |row at a larger
    bucket - row as the exact path computes it| over `rows` (frame
    counts), on the row's valid frames or samples."""
    cfg, p, dt, dev = voice.model_cfg, voice.params, voice.dtype, voice.device
    ladder = [b for b in voice.frame_buckets if top is None or b <= top]
    gen = torch.Generator().manual_seed(4)
    start = G.tm_start_stage(cfg)
    fuse_from = G.fused_suffix_start(cfg, start)
    out: dict = {}

    def put(stage, fb, k, d):
        cell = out.setdefault(stage, {}).setdefault(str(fb), [0.0, 0.0])
        cell[k] = max(cell[k], d)

    def rand(*shape):
        return torch.randn(shape, generator=gen).to(dev, dt)

    def sid_of(b):
        return None if speaker is None else torch.full((b,), speaker, dtype=torch.long, device=dev)

    def mask_of(lens, t):
        return (torch.arange(t, device=dev)[None, :] < torch.as_tensor(lens, device=dev)[:, None])[..., None].to(dt)

    with torch.inference_mode():
        for n in rows:
            own = batching.pick_bucket(n, voice.frame_buckets)
            for fb in [b for b in ladder if b > own]:
                nb = _group_rows(fb)
                lens = [n] + [int(x) for x in torch.randint(1, fb + 1, (nb - 1,), generator=gen)]
                g = M.speaker_embedding(p, cfg, sid_of(nb))
                mask = mask_of(lens, fb)
                z = rand(nb, fb, cfg.inter_channels) * mask
                # the reverse flow: exact path at the row's own bucket
                ref = F.flow_apply(p["flow"], z[:1, :own], mask[:1, :own], cfg=cfg, reverse=True,
                                   g=None if g is None else g[:1])[0, :n]
                for k, b in ((0, 1), (1, nb)):
                    got = F.flow_apply(p["flow"], z[:b], mask[:b], cfg=cfg, reverse=True,
                                       g=None if g is None else g[:b])
                    put("flow", fb, k, _max_diff(got[0, :n], ref))
                if cfg.flow_transformer:
                    attn = p["flow"]["layers"][0]["attn"]
                    h = rand(nb, fb, cfg.hidden_channels) * mask
                    ref = E.local_attention_apply(attn, h[:1, :own], mask[:1, :own], n_heads=2)[0, :n]
                    for k, b in ((0, 1), (1, nb)):
                        got = E.local_attention_apply(attn, h[:b], mask[:b], n_heads=2)
                        put("flow_attention", fb, k, _max_diff(got[0, :n], ref))
                if cfg.vocoder == "mb_istft":
                    u = cfg.upsample_factor
                    ref = MB.mb_istft_generator_rows(p["dec"], z[:1, :n], [n], cfg=cfg,
                                                     g=None if g is None else g[:1],
                                                     tables=p["dec_mb"])[0]
                    for k, b in ((0, 1), (1, nb)):
                        got = MB.mb_istft_generator_apply(p["dec"], z[:b], mask[:b], cfg=cfg,
                                                          g=None if g is None else g[:b],
                                                          tables=p["dec_mb"])
                        put("mb_generator", fb, k, _max_diff(got[0, : n * u], ref))
                    continue
                # conv_pre: exact path alone at the row's own length
                ref = G._conv_pre(p["dec"], z[:1, :n], None if g is None else g[:1])[0]
                for k, b in ((0, 1), (1, nb)):
                    got = G._conv_pre(p["dec"], z[:b], None if g is None else g[:b])
                    put("conv_pre", fb, k, _max_diff(got[0, :n], ref))
                r = 1
                for i in range(start):  # the wide NWC stages
                    c_in = cfg.upsample_initial_channel // 2 ** i
                    x = rand(nb, fb * r, c_in) * torch.repeat_interleave(mask, r, dim=1)
                    ref = G._nwc_stage_rows(p["dec"], i, x[:1, : n * r], [n * r], cfg)[0]
                    for k, b in ((0, 1), (1, nb)):
                        lens_i = torch.as_tensor(lens[:b], device=dev) * r
                        got = G._nwc_stage_masked(p["dec"], i, x[:b], lens_i, cfg)
                        put(f"nwc_stage{i}", fb, k, _max_diff(got[0, : n * r * cfg.upsample_rates[i]], ref))
                    r *= cfg.upsample_rates[i]
                for i in range(start, fuse_from):  # polyphase tconv before mrf_fused
                    uu, kk = cfg.upsample_rates[i], cfg.upsample_kernel_sizes[i]
                    q0, used, _ = G._tm_phase_plan(kk, uu)
                    c_in = cfg.upsample_initial_channel // 2 ** i
                    x = rand(nb, c_in, fb * r) * torch.repeat_interleave(mask, r, dim=1).transpose(1, 2)
                    tm = p["dec_tm"]
                    ref = G._tconv_tm(x[:1, :, : n * r], tm["ups"][i], q0, used, tm["ups_b"][i])[0]
                    for k, b in ((0, 1), (1, nb)):
                        got = G._tconv_tm(x[:b], tm["ups"][i], q0, used, tm["ups_b"][i])
                        put(f"tconv_tm{i}", fb, k, _max_diff(got[0, :, : n * r * uu], ref))
                    r *= uu
                # the kernels alone (generator_tm_suffix): at the row's
                # length and at the bucket's width
                f = G.prefix_factor(cfg)
                c_s = cfg.upsample_initial_channel // 2 ** (start + int(fuse_from > start))
                x = rand(nb, c_s, fb * f) * torch.repeat_interleave(mask, f, dim=1).transpose(1, 2)
                tm, lens_t = p["dec_tm"], torch.as_tensor(lens, device=dev, dtype=torch.int32)
                ref = G.generator_tm_suffix(p["dec"], tm, x[:1, :, : n * f].contiguous(), lens_t[:1],
                                            cfg=cfg)[0, : n * cfg.upsample_factor]
                for k, b in ((0, 1), (1, nb)):
                    got = G.generator_tm_suffix(p["dec"], tm, x[:b], lens_t[:b], cfg=cfg)
                    put("kernels", fb, k, _max_diff(got[0, : n * cfg.upsample_factor], ref))
                # the whole vocode: the exact path (flow at the own bucket,
                # the generator at the row's length) against the fixed-shape
                # vocode at the larger bucket (kernels included)
                u = cfg.upsample_factor
                zf = F.flow_apply(p["flow"], z[:1, :own], mask[:1, :own], cfg=cfg, reverse=True,
                                  g=None if g is None else g[:1]) * mask[:1, :own]
                ref = M.synthesizer_generate(p, zf[:, :n], mask[:1, :n], cfg=cfg,
                                             g=None if g is None else g[:1], frames=[n])[0, : n * u]
                for k, b in ((0, 1), (1, nb)):
                    got = M.synthesizer_vocode(p, z[:b], mask[:b], cfg=cfg, g=None if g is None else g[:b],
                                               fixed_shape=True)
                    put("vocode", fb, k, _max_diff(got[0, : n * u], ref))
            for fb in [b for b in ladder if b > own]:
                # the decode path (runtime/voice.py _frames, then the
                # kernels): the row's frame windows up to its length at its
                # own bucket, against every window of a larger bucket,
                # alone and in a group, latents drawn in the windows
                nb = _group_rows(fb)
                lens = [n] + [int(x) for x in torch.randint(1, fb + 1, (nb - 1,), generator=gen)]
                mask = mask_of(lens, fb)
                m_p, logs_p = rand(nb, fb, cfg.inter_channels) * mask, 0.1 * rand(nb, fb, cfg.inter_channels) * mask
                keys_t = torch.arange(2 * nb, device=dev, dtype=torch.long).reshape(nb, 2)
                scale_t = torch.full((1,), 0.667, device=dev)
                sid = sid_of(nb)
                W = RV.WINDOW_FRAMES

                def decode(b, windows, width):
                    x = voice._frames(m_p[:b, : windows[0] * W], logs_p[:b, : windows[0] * W],
                                      mask[:b, : windows[0] * W], keys_t[:b], scale_t,
                                      None if sid is None else sid[:b], windows)
                    if cfg.vocoder == "mb_istft":
                        return x[:, : width * cfg.upsample_factor]
                    f = G.prefix_factor(cfg)
                    lens_t = torch.as_tensor([min(x_, width) for x_ in lens[:b]], device=dev,
                                             dtype=torch.int32)
                    return G.generator_tm_suffix(p["dec"], p["dec_tm"], x[:, :, : width * f].contiguous(),
                                                 lens_t, cfg=cfg)

                ref = decode(1, [-(-n // W)], n)[0, : n * cfg.upsample_factor]
                for k, b in ((0, 1), (1, nb)):
                    got = decode(b, [-(-fb // W)] * b, fb)
                    put("decode_windows", fb, k, _max_diff(got[0, : n * cfg.upsample_factor], ref))
    return out


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
    ap.add_argument("--buckets", action="store_true",
                    help="Part 4 only: a row at every larger frame bucket, per stage (fast precision)")
    ap.add_argument("--top", type=int, default=None, help="--buckets: the largest bucket to try")
    ap.add_argument("--perturb-post", type=float, default=0.0, metavar="STD",
                    help="add N(0, STD^2) noise (seed 12) to every flow's post first: a random "
                         "voice's zero post makes its flow the identity, which hides its rounding")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if args.buckets:
        name = torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu"
        std = args.perturb_post or 0.02
        voices = [(q, "vits", "hifigan", 2) for q in ("x-low", "medium", "high")]
        voices += [("medium", "vits2", "hifigan", 11), ("medium", "vits", "mb_istft", 12)]
        if args.voice:
            voices.append((args.voice, None, None, None))
        for quality, variant, vocoder, seed in voices:
            if variant is None:
                params, cfg = load_native(quality)
            else:
                make = {"vits2": ModelConfig.vits2, "mb_istft": ModelConfig.mb_istft}.get(
                    variant if vocoder == "hifigan" else vocoder, ModelConfig.for_quality)
                cfg = make(quality, num_symbols=256, **({"num_speakers": 2} if variant == "vits2" else {}))
                params = init_synthesizer_params(seed, cfg)
            _perturb_post(params, std)
            speaker = args.speaker if cfg.num_speakers > 1 else None
            voice = TorchVoice(params, cfg, random_voice_config(cfg), precision="fast", device=dev, seed=0)
            t0 = time.perf_counter()
            diffs = bucket_diffs(voice, speaker, top=args.top)
            print(json.dumps({"part": "buckets", "voice": quality, "variant": variant, "vocoder": vocoder,
                              "perturb_post": std, "speaker": speaker, "precision": "fast", "device": name,
                              "rows": BUCKET_ROWS, "seconds": round(time.perf_counter() - t0, 1),
                              "max_abs_diff": diffs}), flush=True)
        return
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
