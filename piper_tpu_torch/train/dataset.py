"""Training dataset: dataset.jsonl utterances -> bucketed numpy batches.

Counterpart of piper_tpu/train/dataset.py, the same reader: it takes
the directory that piper_tpu.train.preprocess writes (dataset.jsonl
with .npy audio and spectrogram caches) and yields the same batches.
Schema parity with the reference PiperDataset
(src/python/piper_train/vits/dataset.py:47-131): JSONL records with
phoneme_ids, audio_norm_path, audio_spec_path, optional speaker_id /
text. Caches are .npy (see train/norm_audio.py).

Collation: instead of the reference's sort-by-length inside each random
batch (dataset.py:132-214), utterances are grouped into (phoneme,
frame) length buckets, so every batch has one of a small set of shapes
(cuDNN and cuBLAS pick and cache their algorithms per shape) with
little padding.
"""

from __future__ import annotations

import json
import logging
import random
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Sequence, Union

import numpy as np

from ..runtime.batching import bucket_ladder, pick_bucket

_LOGGER = logging.getLogger(__name__)


@dataclass
class Utterance:
    phoneme_ids: List[int]
    audio_norm_path: Path
    audio_spec_path: Path
    speaker_id: Optional[int] = None
    text: Optional[str] = None


def load_dataset(
    dataset_paths: Sequence[Union[str, Path]],
    max_phoneme_ids: Optional[int] = None,
) -> List[Utterance]:
    utterances: List[Utterance] = []
    num_skipped = 0
    for path in dataset_paths:
        with open(path, "r", encoding="utf-8") as f:
            for line_idx, line in enumerate(f):
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                    utt = Utterance(
                        phoneme_ids=rec["phoneme_ids"],
                        audio_norm_path=Path(rec["audio_norm_path"]),
                        audio_spec_path=Path(rec["audio_spec_path"]),
                        speaker_id=rec.get("speaker_id"),
                        text=rec.get("text"),
                    )
                    if max_phoneme_ids and len(utt.phoneme_ids) > max_phoneme_ids:
                        num_skipped += 1
                        continue
                    utterances.append(utt)
                except Exception:
                    _LOGGER.exception(
                        "Error on line %s of %s", line_idx + 1, path
                    )
    if num_skipped:
        _LOGGER.warning("Skipped %s long utterance(s)", num_skipped)
    return utterances


class BucketedLoader:
    """Shuffled, length-bucketed batch iterator yielding numpy batches
    ready for train_step."""

    def __init__(
        self,
        utterances: Sequence[Utterance],
        *,
        batch_size: int,
        hop_length: int,
        segment_size: int,
        multispeaker: bool = False,
        seed: int = 1234,
        max_spec_frames: int = 2048,
        drop_last: bool = False,
        single_shape: bool = False,
    ):
        self.utterances = list(utterances)
        self.batch_size = batch_size
        self.hop_length = hop_length
        self.segment_size = segment_size
        self.multispeaker = multispeaker
        self.rng = random.Random(seed)
        self.max_spec_frames = max_spec_frames
        self.drop_last = drop_last
        self.phoneme_buckets = bucket_ladder(32, 1024)
        self.frame_buckets = bucket_ladder(64, max_spec_frames)
        # Pre-read spec lengths lazily on first epoch
        self._spec_frames: Dict[int, int] = {}
        if single_shape:
            # One (phoneme, frame) shape for the whole dataset: more
            # padded compute per step, but one shape for every step.
            max_p = max(len(u.phoneme_ids) for u in self.utterances)
            max_f = max(
                min(self._frames_of(i), max_spec_frames)
                for i in range(len(self.utterances))
            )
            self.phoneme_buckets = [-(-max_p // 16) * 16]
            self.frame_buckets = [-(-max_f // 16) * 16]

    def _frames_of(self, i: int) -> int:
        if i not in self._spec_frames:
            spec = np.load(
                self.utterances[i].audio_spec_path, mmap_mode="r"
            )
            self._spec_frames[i] = spec.shape[0]
        return self._spec_frames[i]

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        order = list(range(len(self.utterances)))
        self.rng.shuffle(order)
        # group into (phoneme_bucket, frame_bucket) bins
        bins: Dict[tuple, List[int]] = {}
        for i in order:
            utt = self.utterances[i]
            frames = self._frames_of(i)
            if frames > self.max_spec_frames:
                continue
            key = (
                pick_bucket(len(utt.phoneme_ids), self.phoneme_buckets),
                pick_bucket(frames, self.frame_buckets),
            )
            bins.setdefault(key, []).append(i)
            if len(bins[key]) >= self.batch_size:
                yield self._collate(bins.pop(key), key)
        if not self.drop_last:
            for key, idxs in bins.items():
                if idxs:
                    yield self._collate(idxs, key)

    def _collate(self, idxs: List[int], key: tuple) -> Dict[str, np.ndarray]:
        pb, fb = key
        b = len(idxs)
        seg_frames = self.segment_size // self.hop_length
        fb = max(fb, seg_frames)
        ids = np.zeros((b, pb), np.int32)
        id_lengths = np.zeros((b,), np.int32)
        spec0 = np.load(self.utterances[idxs[0]].audio_spec_path, mmap_mode="r")
        spec = np.zeros((b, fb, spec0.shape[1]), np.float32)
        spec_lengths = np.zeros((b,), np.int32)
        audio = np.zeros((b, fb * self.hop_length), np.float32)
        sid = np.zeros((b,), np.int32) if self.multispeaker else None
        for row, i in enumerate(idxs):
            utt = self.utterances[i]
            p = np.asarray(utt.phoneme_ids, np.int32)
            ids[row, : len(p)] = p
            id_lengths[row] = len(p)
            s = np.load(utt.audio_spec_path).astype(np.float32)
            t = min(s.shape[0], fb)
            spec[row, :t] = s[:t]
            spec_lengths[row] = t
            a = np.load(utt.audio_norm_path).astype(np.float32)
            n = min(len(a), fb * self.hop_length)
            audio[row, :n] = a[:n]
            if sid is not None and utt.speaker_id is not None:
                sid[row] = utt.speaker_id
        # audio padded to >= segment_size (reference dataset.py:165)
        batch = {
            "ids": ids,
            "id_lengths": id_lengths,
            "spec": spec,
            "spec_lengths": spec_lengths,
            "audio": audio,
        }
        if sid is not None:
            batch["sid"] = sid
        return batch


def write_synthetic_dataset(
    out_dir: Union[str, Path],
    *,
    n_utterances: int,
    sample_rate: int,
    num_symbols: int = 256,
    seconds: Sequence[float] = (1.5, 4.0),
    ids: Sequence[int] = (30, 90),
    num_speakers: int = 1,
    n_fft: int = 1024,
    hop_length: int = 256,
    seed: int = 0,
) -> Path:
    """A dataset directory in the layout piper_tpu.train.preprocess
    writes (config.json, dataset.jsonl, .npy audio and spectrogram
    caches), from synthetic utterances: a few seeded tones with noise,
    normalised, of `seconds` (low, high) each, with `ids` (low, high)
    random codepoint phoneme ids framed by BOS and EOS. The spectrograms
    come from ops/stft.spectrogram. For smoke runs and tests: no raw
    audio, phonemizer or VAD is needed."""
    import torch

    from ..ops.stft import spectrogram

    out = Path(out_dir)
    cache = out / "cache"
    cache.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    id_map = {chr(32 + i): [i] for i in range(num_symbols)}
    id_map.update({"_": [0], "^": [1], "$": [2]})
    config = {
        "dataset": out.name,
        "audio": {"sample_rate": sample_rate},
        "espeak": {"voice": "en-us"},
        "inference": {"noise_scale": 0.667, "length_scale": 1, "noise_w": 0.8},
        "phoneme_type": "text",
        "phoneme_map": {},
        "phoneme_id_map": id_map,
        "num_symbols": num_symbols,
        "num_speakers": num_speakers,
        "speaker_id_map": {f"s{i}": i for i in range(num_speakers)} if num_speakers > 1 else {},
    }
    (out / "config.json").write_text(json.dumps(config), encoding="utf-8")
    with open(out / "dataset.jsonl", "w", encoding="utf-8") as f:
        for i in range(n_utterances):
            n = int(rng.uniform(*seconds) * sample_rate)
            t = np.arange(n) / sample_rate
            audio = sum(np.sin(2 * np.pi * rng.uniform(80, 2000) * t + rng.uniform(0, 6.3))
                        for _ in range(3)) + 0.05 * rng.standard_normal(n)
            audio = (0.95 * audio / np.abs(audio).max()).astype(np.float32)
            spec = spectrogram(torch.from_numpy(audio)[None], n_fft=n_fft, hop_length=hop_length,
                               win_length=n_fft)[0].numpy()
            np.save(cache / f"{i}.npy", audio)
            np.save(cache / f"{i}.spec.npy", spec.astype(np.float32))
            body = rng.integers(3, num_symbols, int(rng.integers(*ids)) - 2)
            rec = {"phoneme_ids": [1] + [int(x) for x in body] + [2],
                   "audio_norm_path": str(cache / f"{i}.npy"),
                   "audio_spec_path": str(cache / f"{i}.spec.npy"),
                   "text": f"utterance {i}"}
            if num_speakers > 1:
                rec["speaker_id"] = i % num_speakers
            f.write(json.dumps(rec) + "\n")
    return out
