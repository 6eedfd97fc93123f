"""piper_tpu_torch CLI: text on stdin -> WAV, on the GPU.

Counterpart of piper_tpu/__main__.py (flag-compatible with the
reference CLI, src/python_run/piper/__main__.py). Modes:

  -f FILE          all of stdin as one text -> one WAV (stdout when '-'
                   or absent); its phrases are synthesised as one batch
  --output-raw     each stdin line's sentences as raw audio on stdout,
                   sentence by sentence (--raw-format s16le or mulaw)
  -d DIR           one WAV per stdin line ({"output_file"} with
                   --json-input, else DIR/<line number>.wav); --batch
                   synthesises all lines in one device batch (with the
                   command line's speaker and scales for every line)

-m takes a .onnx, .ckpt or .npz voice (its JSON config beside it) or a
voice name of the piper-voices registry, resolved offline from the
embedded snapshot when its files are in a --data-dir. --pack-total is
accepted and has no effect. Runs on CUDA unless --device cpu is given;
without a GPU it exits with an error rather than falling back to the
CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import sys
import wave
from pathlib import Path
from typing import Any, Dict

import numpy as np

from .config import SynthesisConfig
from .runtime.codec import RAW_FORMATS, mulaw_encode
from .runtime.voice import SynthesisStats, TorchVoice
from .runtime.wav import write_wav

_LOGGER = logging.getLogger("piper_tpu_torch")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="piper_tpu_torch")
    add_voice_arguments(parser)
    parser.add_argument("-f", "--output-file", "--output_file",
                        help="Output WAV file (default: stdout)")
    parser.add_argument("-d", "--output-dir", "--output_dir",
                        help="Output directory for per-line WAVs")
    parser.add_argument("--output-raw", "--output_raw", action="store_true",
                        help="Stream raw audio to stdout")
    parser.add_argument("--raw-format", "--raw_format", choices=list(RAW_FORMATS),
                        default="s16le",
                        help="Raw stream format: s16le int16 PCM (default, the "
                             "reference's) or G.711 mu-law (half the bytes)")
    parser.add_argument("--json-input", action="store_true",
                        help="stdin lines are JSON objects (C++ CLI protocol)")
    parser.add_argument("-s", "--speaker", type=int, help="Speaker id")
    parser.add_argument("--length-scale", "--length_scale", type=float)
    parser.add_argument("--noise-scale", "--noise_scale", type=float)
    parser.add_argument("--noise-w", "--noise_w", type=float)
    parser.add_argument("--sentence-silence", "--sentence_silence", type=float, default=0.0)
    parser.add_argument(
        "--pack-total", "--pack_total", choices=["quantum", "pow2"], default=None,
        help="accepted for the JAX package's CLI and has no effect: it sizes XLA's packed "
             "transfers there, and the port compiles no such shapes",
    )
    parser.add_argument(
        "--decode-grouping", "--decode_grouping",
        choices=["bucketed", "uniform", "packed"], default=None,
        help="decode planner (default: bucketed for the CLI, uniform for the HTTP server)",
    )
    parser.add_argument("--seed", type=int, help="Deterministic synthesis seed")
    parser.add_argument("--batch", action="store_true",
                        help="With --output-dir: synthesise all stdin lines as one batch")
    parser.add_argument("--debug", action="store_true")
    parser.add_argument("-q", "--quiet", action="store_true")
    return parser


def add_voice_arguments(parser: argparse.ArgumentParser) -> None:
    """The flags load_voice reads (shared with the HTTP server and the
    benchmark CLI)."""
    parser.add_argument(
        "-m", "--model", required=True,
        help="Path to a voice (.onnx, .ckpt or .npz) or a voice name of the registry",
    )
    parser.add_argument("-c", "--config", help="Path to the voice JSON config")
    parser.add_argument("--data-dir", "--data_dir", action="append", default=[str(Path.cwd())],
                        help="Directory searched for a named voice's files (repeatable; "
                             "default: the working directory)")
    parser.add_argument("--download-dir", "--download_dir",
                        help="Directory a named voice's missing files are downloaded to "
                             "(default: the first --data-dir)")
    parser.add_argument("--update-voices", action="store_true",
                        help="Download a fresh voices.json registry")
    parser.add_argument("--precision", choices=["parity", "fast"], default="fast")
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                        help="cuda (default) or cpu; never chosen for you")


def load_voice(args) -> TorchVoice:
    """The voice the parsed arguments name (shared with the HTTP server
    and the benchmark CLI). A -m that is not a file is a voice name:
    resolved with its aliases through the registry (the embedded
    snapshot unless --update-voices or a cached voices.json), its files
    checked by size and md5 in the data dirs and downloaded only when
    missing or corrupt (piper_tpu/__main__.py:92-133), then found under
    the voice's key."""
    if not Path(args.model).exists():
        from urllib.error import URLError

        from .runtime.download import (
            VoiceNotFoundError,
            ensure_voice_exists,
            find_voice,
            get_voices,
        )

        download_dir = args.download_dir or args.data_dir[0]
        try:
            voices_info = get_voices(download_dir, update_voices=args.update_voices)
            aliases: Dict[str, Any] = {}
            for vi in voices_info.values():
                for alias in vi.get("aliases", []):
                    aliases[alias] = {"_is_alias": True, **vi}
            voices_info.update(aliases)
            ensure_voice_exists(args.model, args.data_dir, download_dir, voices_info)
            # an alias's files carry the voice's key (the JAX package
            # looks them up under the alias, and misses them)
            key = voices_info[args.model].get("key", args.model)
            args.model, args.config = find_voice(key, args.data_dir)
        except VoiceNotFoundError:
            raise SystemExit(
                f"Voice '{args.model}' is not a local file and is not in "
                "the voices.json registry. Check the name or pass a path "
                "to a .npz/.ckpt/.onnx voice."
            )
        except (URLError, OSError) as e:
            raise SystemExit(
                f"Voice '{args.model}' is not a local file and the voice "
                f"registry could not be reached ({e}). Pass a path to a "
                "local voice, or place voices.json in the download dir."
            )
    return TorchVoice.load(
        args.model, args.config, precision=args.precision, device=args.device,
        decode_grouping=getattr(args, "decode_grouping", None) or "bucketed",
    )


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    level = logging.DEBUG if args.debug else logging.WARNING if args.quiet else logging.INFO
    logging.basicConfig(level=level)

    voice = load_voice(args)
    base_syn = SynthesisConfig(
        speaker_id=args.speaker,
        length_scale=args.length_scale,
        noise_scale=args.noise_scale,
        noise_w=args.noise_w,
        sentence_silence_seconds=args.sentence_silence,
        seed=args.seed,
    )
    stats = SynthesisStats()

    def parse_line(line: str):
        """(text, syn, output_file) from a stdin line."""
        if not args.json_input:
            return line, base_syn, None
        obj = json.loads(line)
        syn = dataclasses.replace(base_syn)
        if "speaker_id" in obj:
            syn.speaker_id = int(obj["speaker_id"])
        elif "speaker" in obj and voice.config.speaker_id_map:
            syn.speaker_id = voice.config.speaker_id_map.get(str(obj["speaker"]))
        return obj["text"], syn, obj.get("output_file")

    if args.output_raw:
        for line in sys.stdin:
            if not line.strip():
                continue
            text, syn, _ = parse_line(line.strip())
            for chunk in voice.synthesize_stream_raw(text, syn=syn, stats=stats):
                if args.raw_format == "mulaw":
                    chunk = mulaw_encode(np.frombuffer(chunk, "<i2")).tobytes()
                sys.stdout.buffer.write(chunk)
                sys.stdout.buffer.flush()
    elif args.output_dir:
        out_dir = Path(args.output_dir)
        out_dir.mkdir(parents=True, exist_ok=True)
        lines = [parse_line(l.strip()) for l in sys.stdin if l.strip()]
        paths = [
            Path(out_file) if out_file else out_dir / f"{i:04d}.wav"
            for i, (_, _, out_file) in enumerate(lines)
        ]
        if args.batch:
            # one device batch for every line; lines share base_syn
            pcms = voice.synthesize_batch([t for t, _, _ in lines], syn=base_syn, stats=stats)
            for sentences, path in zip(pcms, paths):
                write_wav(path, np.concatenate(sentences or [np.zeros(0, np.int16)]),
                          voice.config.sample_rate)
        else:
            for (text, syn, _), path in zip(lines, paths):
                with wave.open(str(path), "wb") as wav_file:
                    voice.synthesize_wav(text, wav_file, syn=syn, stats=stats)
        for path in paths:
            _LOGGER.info("Wrote %s", path)
    else:
        text = sys.stdin.read()
        target = (
            sys.stdout.buffer
            if not args.output_file or args.output_file == "-"
            else args.output_file
        )
        with wave.open(target, "wb") as wav_file:
            voice.synthesize_wav(text, wav_file, syn=base_syn, stats=stats)

    _LOGGER.info(
        "RTF %.4f (infer %.3fs / audio %.3fs, device %s, precision %s; "
        "includes kernel builds on first use)",
        stats.real_time_factor, stats.infer_seconds, stats.audio_seconds,
        voice.device, voice.precision,
    )


if __name__ == "__main__":
    main()
