"""Phoneme coverage report.

Counterpart of piper_tpu/tools/check_phonemes.py (host code, the same
report). Parity: reference piper_train/check_phonemes.py (whose import is
broken upstream — check_phonemes.py:7 imports a non-existent module;
this is the working equivalent): counts phoneme usage across a
dataset.jsonl and reports coverage vs the config's phoneme_id_map.

Usage:
  python -m piper_tpu_torch.tools.check_phonemes \
      --dataset dataset.jsonl --config config.json
"""

from __future__ import annotations

import argparse
import json
from collections import Counter


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--dataset", required=True)
    p.add_argument("--config")
    args = p.parse_args(argv)

    counts: Counter = Counter()
    with open(args.dataset, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            counts.update(rec.get("phonemes", []))

    report = {
        "num_distinct_phonemes": len(counts),
        "counts": dict(counts.most_common()),
    }
    if args.config:
        with open(args.config, encoding="utf-8") as f:
            id_map = json.load(f)["phoneme_id_map"]
        unused = sorted(set(id_map) - set(counts) - {"_", "^", "$", " "})
        missing = sorted(set(counts) - set(id_map))
        report["unused_in_dataset"] = unused
        report["missing_from_id_map"] = missing
    print(json.dumps(report, ensure_ascii=False, indent=2))


if __name__ == "__main__":
    main()
