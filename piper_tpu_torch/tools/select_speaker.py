"""Extract one speaker's utterances from a multi-speaker dataset.

Counterpart of piper_tpu/tools/select_speaker.py (host code). Parity:
reference piper_train/select_speaker.py — filters dataset.jsonl to a
single speaker and rewrites records as single-speaker (drops speaker
ids).

Usage:
  python -m piper_tpu_torch.tools.select_speaker --speaker 3 < dataset.jsonl > one.jsonl
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--speaker", required=True,
                   help="Speaker id (int) or name to keep")
    args = p.parse_args(argv)

    for line in sys.stdin:
        line = line.strip()
        if not line:
            continue
        rec = json.loads(line)
        sid = rec.get("speaker_id")
        name = rec.get("speaker")
        if str(sid) == args.speaker or (name is not None and name == args.speaker):
            rec.pop("speaker_id", None)
            rec.pop("speaker", None)
            json.dump(rec, sys.stdout, ensure_ascii=False)
            print("")


if __name__ == "__main__":
    main()
