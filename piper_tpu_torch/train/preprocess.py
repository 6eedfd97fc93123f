"""Dataset preprocessing CLI.

Counterpart of piper_tpu/train/preprocess.py, with the same flags and
outputs (config.json differs only in "piper_version"). It runs on the
host: its worker processes start by `spawn`, so none inherits a parent's
torch threads, and none touches a GPU. Parity: reference
piper_train.preprocess (preprocess.py:43-257) — ljspeech / mycroft
dataset readers, speaker-id assignment by utterance count,
phonemization, audio normalization + spectrogram caching, and the
config.json + dataset.jsonl outputs (TRAINING.md:53-96 schema).

Usage:
  python -m piper_tpu_torch.train.preprocess \
      --input-dir LJSpeech-1.1 --output-dir out --language en-us \
      --sample-rate 22050 --dataset-format ljspeech

Phonemization backends (see text/phonemize.py): espeak when available,
codepoint 'text' phonemes otherwise, or a precomputed 'phonemes' CSV
column.
"""

from __future__ import annotations

import argparse
import csv
import dataclasses
import json
import logging
import multiprocessing
import os
from collections import Counter
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path
from typing import Any, Dict, Iterable, List, Optional

from .. import __version__
from ..config import AudioConfig, PhonemeType
from ..text.phonemes import BOS, EOS, PAD, phonemes_to_ids

_LOGGER = logging.getLogger(__name__)

_DATA_DIR = Path(__file__).parent.parent / "text" / "data"


def default_espeak_id_map() -> Dict[str, List[int]]:
    """The standard Piper espeak phoneme->id map (the cross-voice
    interop contract; identical across released espeak voices)."""
    with open(_DATA_DIR / "espeak_phoneme_id_map.json", encoding="utf-8") as f:
        return json.load(f)


@dataclasses.dataclass
class RawUtterance:
    text: str
    audio_path: Path
    speaker: Optional[str] = None


def ljspeech_dataset(input_dir: Path) -> Iterable[RawUtterance]:
    """metadata.csv: id|text or id|speaker|text
    (reference preprocess.py:405-448)."""
    metadata = input_dir / "metadata.csv"
    wav_dirs = [input_dir / "wav", input_dir / "wavs", input_dir]
    with open(metadata, encoding="utf-8") as f:
        for row in csv.reader(f, delimiter="|", quoting=csv.QUOTE_NONE):
            if len(row) < 2:
                continue
            if len(row) == 2:
                utt_id, text, speaker = row[0], row[1], None
            else:
                utt_id, speaker, text = row[0], row[1], row[-1]
            for wav_dir in wav_dirs:
                for ext in ("", ".wav"):
                    p = wav_dir / f"{utt_id}{ext}"
                    if p.is_file():
                        yield RawUtterance(text, p, speaker)
                        break
                else:
                    continue
                break
            else:
                _LOGGER.warning("Missing audio for %s", utt_id)


def mycroft_dataset(input_dir: Path) -> Iterable[RawUtterance]:
    """<wav>|<text> info files (reference preprocess.py:451-466)."""
    for info_path in input_dir.rglob("*.info"):
        wav_path = info_path.with_suffix(".wav")
        if wav_path.is_file():
            text = info_path.read_text(encoding="utf-8").strip()
            yield RawUtterance(text, wav_path)


def _phonemize(text: str, language: str, phoneme_type: PhonemeType) -> List[str]:
    from ..text.phonemize import phonemize_codepoints, phonemize_espeak

    if phoneme_type == PhonemeType.ESPEAK:
        sentences = phonemize_espeak(text, language)
    else:
        sentences = phonemize_codepoints(text)
    phonemes: List[str] = []
    for s in sentences:
        phonemes.extend(s)
    return phonemes


def _process_one(args_tuple) -> Optional[Dict[str, Any]]:
    (utt, language, phoneme_type, id_map, cache_dir, audio_cfg, skip_audio) = (
        args_tuple
    )
    try:
        phonemes = _phonemize(utt.text, language, phoneme_type)
        missing: Dict[str, int] = {}
        ids = phonemes_to_ids(phonemes, id_map, missing=missing)
        rec: Dict[str, Any] = {
            "text": utt.text,
            "phonemes": phonemes,
            "phoneme_ids": ids,
            "audio_path": str(utt.audio_path),
            "speaker": utt.speaker,
            "missing_phonemes": missing,
        }
        if not skip_audio:
            from .norm_audio import cache_norm_audio

            norm_path, spec_path = cache_norm_audio(
                utt.audio_path, cache_dir, audio_cfg
            )
            rec["audio_norm_path"] = str(norm_path)
            rec["audio_spec_path"] = str(spec_path)
        return rec
    except Exception:
        _LOGGER.exception("Failed utterance: %s", utt.audio_path)
        return None


def build_codepoint_id_map(texts: Iterable[str]) -> Dict[str, List[int]]:
    """Deterministic codepoint map from a corpus (phoneme_type='text')."""
    from ..text.phonemize import phonemize_codepoints

    chars = set()
    for t in texts:
        for sent in phonemize_codepoints(t):
            chars.update(sent)
    id_map = {PAD: [0], BOS: [1], EOS: [2]}
    next_id = 3
    for ch in sorted(chars):
        if ch not in id_map:
            id_map[ch] = [next_id]
            next_id += 1
    return id_map


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--input-dir", required=True)
    p.add_argument("--output-dir", required=True)
    p.add_argument("--language", required=True, help="espeak voice, e.g. en-us")
    p.add_argument("--sample-rate", type=int, required=True)
    p.add_argument("--cache-dir", help="Audio/spec cache (default: output/cache)")
    p.add_argument(
        "--dataset-format", choices=("ljspeech", "mycroft"), default="ljspeech"
    )
    p.add_argument(
        "--phoneme-type",
        choices=[pt.value for pt in PhonemeType],
        default=PhonemeType.ESPEAK.value,
    )
    p.add_argument("--max-workers", type=int, default=os.cpu_count())
    p.add_argument("--single-speaker", action="store_true")
    p.add_argument("--speaker-id", type=int)
    p.add_argument("--skip-audio", action="store_true")
    p.add_argument("--dataset-name")
    p.add_argument("--audio-quality")
    p.add_argument("--debug", action="store_true")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.DEBUG if args.debug else logging.INFO)

    input_dir = Path(args.input_dir)
    output_dir = Path(args.output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    cache_dir = Path(args.cache_dir or output_dir / "cache" / str(args.sample_rate))
    phoneme_type = PhonemeType(args.phoneme_type)
    audio_cfg = AudioConfig(sample_rate=args.sample_rate, quality=args.audio_quality)

    reader = ljspeech_dataset if args.dataset_format == "ljspeech" else mycroft_dataset
    utterances = list(reader(input_dir))
    _LOGGER.info("%s utterance(s)", len(utterances))

    # Speaker ids by descending utterance count (preprocess.py:153-160)
    speaker_ids: Dict[str, int] = {}
    if not args.single_speaker:
        counts = Counter(u.speaker for u in utterances if u.speaker is not None)
        for i, (spk, _n) in enumerate(counts.most_common()):
            speaker_ids[spk] = i
    num_speakers = max(len(speaker_ids), 1)

    if phoneme_type == PhonemeType.ESPEAK:
        id_map = default_espeak_id_map()
    else:
        id_map = build_codepoint_id_map(u.text for u in utterances)

    # config.json (preprocess.py:168-197 schema)
    config = {
        "dataset": args.dataset_name or input_dir.name,
        "audio": {
            "sample_rate": args.sample_rate,
            **({"quality": args.audio_quality} if args.audio_quality else {}),
        },
        "espeak": {"voice": args.language},
        "language": {"code": args.language},
        "inference": {"noise_scale": 0.667, "length_scale": 1, "noise_w": 0.8},
        "phoneme_type": phoneme_type.value,
        "phoneme_map": {},
        "phoneme_id_map": id_map,
        "num_symbols": max(i[0] for i in id_map.values()) + 1,
        "num_speakers": num_speakers,
        "speaker_id_map": speaker_ids,
        "piper_version": f"piper_tpu_torch {__version__}",
    }
    with open(output_dir / "config.json", "w", encoding="utf-8") as f:
        json.dump(config, f, ensure_ascii=False, indent=2)

    jobs = [
        (u, args.language, phoneme_type, id_map, cache_dir, audio_cfg,
         args.skip_audio)
        for u in utterances
    ]
    missing_total: Counter = Counter()
    n_written = 0
    with open(output_dir / "dataset.jsonl", "w", encoding="utf-8") as out:
        if args.max_workers and args.max_workers > 1:
            ctx = multiprocessing.get_context("spawn")
            with ProcessPoolExecutor(max_workers=args.max_workers, mp_context=ctx) as ex:
                results = ex.map(_process_one, jobs, chunksize=8)
                for rec in results:
                    n_written += _emit(rec, out, speaker_ids, args, missing_total)
        else:
            for job in jobs:
                n_written += _emit(
                    _process_one(job), out, speaker_ids, args, missing_total
                )

    if missing_total:
        for ph, count in missing_total.most_common():
            _LOGGER.warning("Missing %s (%s)", ph, count)
    _LOGGER.info("Wrote %s utterance(s) to %s", n_written, output_dir)


def _emit(rec, out, speaker_ids, args, missing_total) -> int:
    if rec is None:
        return 0
    missing_total.update(rec.pop("missing_phonemes", {}))
    if rec.get("speaker") is not None:
        rec["speaker_id"] = speaker_ids.get(rec["speaker"], 0)
    elif args.speaker_id is not None:
        rec["speaker_id"] = args.speaker_id
    json.dump(rec, out, ensure_ascii=False)
    print("", file=out)
    return 1


if __name__ == "__main__":
    main()
