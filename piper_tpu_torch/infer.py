"""Batch inference harness: stdin JSONL of utterances -> WAV files.

Counterpart of piper_tpu/infer.py, with its flags and --device. Parity:
src/python/piper_train/infer.py — reads {"phoneme_ids": [...], optional
"text", "speaker_id"} JSONL from stdin, writes numbered WAVs to
--output-dir, and logs the overall RTF (with --denoiser-strength also
the RTF with the denoiser's bias synthesis and its passes). Runs on CUDA
unless --device cpu is given (and raises without a GPU).

The JAX package's speculative path and its estimator cache are not
ported, so nothing stands for its estimator_cache=True. With --seed the
denoiser's blank synthesis is seeded too, so a seeded run gives the same
bytes every time (the JAX package draws that bias from fresh noise).

Usage:
  python -m piper_tpu_torch.infer -m voice.npz -o wavs/ < test_en-us.jsonl
"""

from __future__ import annotations

import argparse
import json
import logging
import sys
import time
from pathlib import Path

from .config import SynthesisConfig
from .runtime.denoise import maybe_denoiser
from .runtime.voice import TorchVoice
from .runtime.wav import audio_float_to_int16, write_wav

_LOGGER = logging.getLogger("piper_tpu_torch.infer")


def main(argv=None) -> dict:
    """Returns the run's seconds: {"infer_s", "denoise_s", "audio_s"}."""
    p = argparse.ArgumentParser(prog="piper_tpu_torch.infer")
    p.add_argument("-m", "--model", required=True)
    p.add_argument("-c", "--config")
    p.add_argument("-o", "--output-dir", required=True)
    p.add_argument("--precision", choices=("fast", "parity"), default="fast")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="cuda (default) or cpu; never chosen for you")
    p.add_argument("--seed", type=int)
    p.add_argument("--batch", action="store_true",
                   help="Synthesize all utterances as one bucketed batch")
    p.add_argument("--noise-scale", type=float)
    p.add_argument("--length-scale", type=float)
    p.add_argument("--noise-w", type=float)
    p.add_argument("--denoiser-strength", type=float, default=0.0,
                   help="Spectral bias-subtraction strength "
                        "(runtime/denoise.py; 0 = off)")
    p.add_argument("--debug", action="store_true")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.DEBUG if args.debug else logging.INFO)

    output_dir = Path(args.output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    voice = TorchVoice.load(args.model, args.config, precision=args.precision,
                            device=args.device)
    sr = voice.config.sample_rate
    syn = SynthesisConfig(
        seed=args.seed, noise_scale=args.noise_scale,
        length_scale=args.length_scale, noise_w=args.noise_w,
    )

    records = []
    for line in sys.stdin:
        line = line.strip()
        if line:
            records.append(json.loads(line))

    start = time.perf_counter()
    if args.batch:
        audios = voice.synthesize_ids_batch(
            [r["phoneme_ids"] for r in records], syn=syn
        )
    else:
        audios = [
            voice.synthesize_ids_batch([r["phoneme_ids"]], syn=syn)[0]
            for r in records
        ]
    infer_sec = time.perf_counter() - start

    start = time.perf_counter()
    denoiser = maybe_denoiser(voice, args.denoiser_strength,
                              syn=SynthesisConfig(seed=args.seed))
    if denoiser is not None:
        audios = [denoiser(audio, args.denoiser_strength) for audio in audios]
    denoise_sec = time.perf_counter() - start
    total_audio = sum(len(audio) for audio in audios) / sr
    for i, audio in enumerate(audios):
        write_wav(output_dir / f"{i}.wav", audio_float_to_int16(audio), sr)

    rtf = infer_sec / total_audio if total_audio else 0.0
    _LOGGER.info(
        "Wrote %s wav(s) | audio %.2fs | infer %.2fs | RTF %.5f",
        len(records), total_audio, infer_sec, rtf,
    )
    if denoiser is not None:
        _LOGGER.info(
            "denoiser (bias synthesis and %s pass(es)) %.2fs | RTF with it %.5f",
            len(records), denoise_sec,
            (infer_sec + denoise_sec) / total_audio if total_audio else 0.0,
        )
    return {"infer_s": infer_sec, "denoise_s": denoise_sec, "audio_s": total_audio}


if __name__ == "__main__":
    main()
