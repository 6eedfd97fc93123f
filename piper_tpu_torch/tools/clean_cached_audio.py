"""Validate / clean cached audio and spectrogram files.

Counterpart of piper_tpu/tools/clean_cached_audio.py (host code).
Parity: reference piper_train/clean_cached_audio.py — loads each cached
artifact referenced by dataset.jsonl and deletes (or reports)
corrupt ones so preprocessing can regenerate them.

Usage:
  python -m piper_tpu_torch.tools.clean_cached_audio --dataset dataset.jsonl [--delete]
"""

from __future__ import annotations

import argparse
import json
import logging
from pathlib import Path

import numpy as np

_LOGGER = logging.getLogger(__name__)


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--dataset", required=True)
    p.add_argument("--delete", action="store_true",
                   help="Delete corrupt cache files (default: report only)")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    checked = bad = 0
    with open(args.dataset, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            for key in ("audio_norm_path", "audio_spec_path"):
                path = Path(rec[key])
                checked += 1
                ok = False
                try:
                    arr = np.load(path)
                    ok = arr.size > 0 and np.isfinite(arr).all()
                except Exception:
                    ok = False
                if not ok:
                    bad += 1
                    _LOGGER.warning("Corrupt: %s", path)
                    if args.delete and path.exists():
                        path.unlink()
    _LOGGER.info("checked %s file(s), %s corrupt", checked, bad)


if __name__ == "__main__":
    main()
