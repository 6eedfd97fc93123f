"""Build the embedded voice-registry snapshot.

Counterpart of piper_tpu/tools/make_registry.py: it writes the port's
copy (runtime/data/voices_registry.json), in the same form, which
runtime/download.expand reads back.

Transforms a piper voices.json (the HuggingFace piper-voices registry,
reference: src/python_run/piper/voices.json / download.py:40-46) into
the compact embedded form so voice-name resolution works with
no network on first use (the reference vendors the full registry for
the same reason). Refresh with:

    python -m piper_tpu_torch.tools.make_registry /path/to/voices.json
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

OUT = Path(__file__).parent.parent / "runtime" / "data" / "voices_registry.json"


def compact(voices: dict) -> dict:
    """Keep only what resolution + integrity checking needs."""
    out = {}
    for key, info in voices.items():
        out[key] = {
            "lang": info["language"]["code"],
            "quality": info["quality"],
            "num_speakers": info["num_speakers"],
            "aliases": info.get("aliases", []),
            "files": {
                path: [meta["size_bytes"], meta["md5_digest"]]
                for path, meta in info["files"].items()
            },
        }
    return out


def main(argv=None) -> None:
    args = argv if argv is not None else sys.argv[1:]
    if len(args) != 1:
        raise SystemExit(__doc__)
    voices = json.loads(Path(args[0]).read_text(encoding="utf-8"))
    OUT.parent.mkdir(parents=True, exist_ok=True)
    OUT.write_text(
        json.dumps(compact(voices), ensure_ascii=False, sort_keys=True,
                   separators=(",", ":")),
        encoding="utf-8",
    )
    print(f"{OUT}: {len(voices)} voices")


if __name__ == "__main__":
    main()
