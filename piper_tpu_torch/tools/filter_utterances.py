"""Speaking-rate outlier filter.

Counterpart of piper_tpu/tools/filter_utterances.py (host code, the
same records kept). Parity: reference
piper_train/filter_utterances.py:109-136 — computes phonemes-per-second
for each utterance and drops IQR outliers (the
reference shells out to ffprobe/ffmpeg + VAD; here durations come from
the cached normalized audio, which is already VAD-trimmed).

Usage:
  python -m piper_tpu_torch.tools.filter_utterances \
      --dataset dataset.jsonl --sample-rate 22050 > filtered.jsonl
"""

from __future__ import annotations

import argparse
import json
import logging
import sys

import numpy as np

_LOGGER = logging.getLogger(__name__)


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--dataset", required=True)
    p.add_argument("--sample-rate", type=int, required=True)
    p.add_argument("--iqr-factor", type=float, default=1.5,
                   help="Tukey fence factor (default 1.5)")
    p.add_argument("--min-seconds", type=float, default=0.1)
    p.add_argument("--max-seconds", type=float, default=30.0)
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    records = []
    rates = []
    with open(args.dataset, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            audio = np.load(rec["audio_norm_path"], mmap_mode="r")
            seconds = audio.shape[0] / args.sample_rate
            n_phonemes = len(rec.get("phonemes") or rec["phoneme_ids"])
            rate = n_phonemes / seconds if seconds > 0 else 0.0
            records.append((rec, seconds, rate))
            rates.append(rate)

    rates_np = np.asarray(rates)
    q1, q3 = np.percentile(rates_np, [25, 75])
    iqr = q3 - q1
    lo = q1 - args.iqr_factor * iqr
    hi = q3 + args.iqr_factor * iqr
    _LOGGER.info("rate quartiles: q1=%.2f q3=%.2f keep [%.2f, %.2f]", q1, q3, lo, hi)

    kept = dropped = 0
    for rec, seconds, rate in records:
        if (
            lo <= rate <= hi
            and args.min_seconds <= seconds <= args.max_seconds
        ):
            json.dump(rec, sys.stdout, ensure_ascii=False)
            print("")
            kept += 1
        else:
            dropped += 1
    _LOGGER.info("kept %s, dropped %s utterance(s)", kept, dropped)


if __name__ == "__main__":
    main()
