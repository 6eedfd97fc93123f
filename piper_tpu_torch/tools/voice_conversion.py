"""Voice conversion CLI.

Counterpart of piper_tpu/tools/voice_conversion.py, with its flags and
--device; reference piper_train/voice_conversion.py:59-103: re-speak
WAV files in a target speaker's voice through the posterior encoder +
flow (models.py:724-732), decoded by the time-major HiFiGAN (on the
card through both CUDA kernels). File i's noise is the JAX package's
jax.random.normal(PRNGKey(seed + i), ...), drawn on the device. Runs on
CUDA unless --device cpu is given (and raises without a GPU).

Usage:
  python -m piper_tpu_torch.tools.voice_conversion \
      --model voice.npz --source-speaker 0 --target-speaker 3 \
      --output-dir out/ in1.wav in2.wav
"""

from __future__ import annotations

import argparse
import logging
from pathlib import Path

import numpy as np

_LOGGER = logging.getLogger(__name__)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="piper_tpu_torch.tools.voice_conversion")
    p.add_argument("wav_files", nargs="+")
    p.add_argument("--model", required=True,
                   help="Voice with posterior encoder (.npz exported with "
                        "--include-posterior, or .ckpt)")
    p.add_argument("--source-speaker", type=int, required=True)
    p.add_argument("--target-speaker", type=int, required=True)
    p.add_argument("--output-dir", required=True)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="cuda (default) or cpu; never chosen for you")
    p.add_argument("--debug", action="store_true")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.DEBUG if args.debug else logging.INFO)

    import torch

    from ..models.vits import generator as G
    from ..ops import prng
    from ..runtime.voice import resolve_device, tf32_off
    from ..runtime.voice_conversion import check_convertible, voice_convert_audio
    from ..runtime.wav import audio_float_to_int16, read_wav, write_wav
    from ..train.norm_audio import resample
    from ..weights.bridge import params_from_jax

    device = resolve_device(args.device)
    model_path = Path(args.model)
    if model_path.suffix == ".ckpt":
        from ..weights.torch_loader import load_torch_checkpoint

        tree, cfg = load_torch_checkpoint(str(model_path), include_posterior=True)
    else:
        from ..weights.native import load_native

        tree, cfg = load_native(str(model_path))
    check_convertible(tree, cfg)
    tf32_off()
    params = params_from_jax(tree, cfg, device, torch.float32)
    tm = G.prepare_tm(params["dec"], cfg, torch.float32)

    out_dir = Path(args.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    sr = cfg.audio.sample_rate
    for i, wav_path in enumerate(args.wav_files):
        in_sr, pcm = read_wav(wav_path)
        audio = pcm.astype(np.float32) / 32768.0
        audio = resample(audio, in_sr, sr)
        out = voice_convert_audio(
            params, audio, args.source_speaker, args.target_speaker,
            cfg=cfg, tm=tm, key=prng.prng_key(args.seed + i, device),
        )
        out_path = out_dir / Path(wav_path).name
        write_wav(out_path, audio_float_to_int16(out), sr)
        _LOGGER.info("Wrote %s", out_path)


if __name__ == "__main__":
    main()
