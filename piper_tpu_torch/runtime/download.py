"""Voice distribution: registry lookup, download, integrity checks.

Counterpart of piper_tpu/runtime/download.py, standard library only.
Behavioral parity with the reference downloader
(src/python_run/piper/download.py:23-139): voices.json registry from
the HuggingFace piper-voices repo, per-file size + md5 validation,
alias resolution handled by the CLI. Like the reference (which vendors
voices.json), an embedded registry snapshot
(runtime/data/voices_registry.json, a copy of the JAX package's, 97
voices) makes name resolution work offline on first use;
--update-voices fetches a fresh copy. The network is reached only for
--update-voices or a registry voice whose files are missing or corrupt.

Downloaded .onnx voices load through weights/onnx_loader.py.
"""

from __future__ import annotations

import hashlib
import json
import logging
import shutil
from pathlib import Path
from typing import Any, Dict, Iterable, Set, Tuple, Union
from urllib.request import urlopen

URL_FORMAT = "https://huggingface.co/rhasspy/piper-voices/resolve/v1.0.0/{file}"

_LOGGER = logging.getLogger(__name__)
_SKIP_FILES = {"MODEL_CARD"}


class VoiceNotFoundError(Exception):
    pass


def get_file_hash(path: Union[str, Path], bytes_per_chunk: int = 8192) -> str:
    """md5 of a file (reference: file_hash.py)."""
    h = hashlib.md5()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(bytes_per_chunk), b""):
            h.update(chunk)
    return h.hexdigest()


_EMBEDDED_REGISTRY = Path(__file__).parent / "data" / "voices_registry.json"


def expand(snapshot: dict) -> dict:
    """Embedded form -> the registry dict shape the downloader uses (a
    copy of piper_tpu/tools/make_registry.py's expand)."""
    out = {}
    for key, info in snapshot.items():
        out[key] = {
            "key": key,
            "language": {"code": info["lang"]},
            "quality": info["quality"],
            "num_speakers": info["num_speakers"],
            "aliases": info.get("aliases", []),
            "files": {
                path: {"size_bytes": sz, "md5_digest": md5}
                for path, (sz, md5) in info["files"].items()
            },
        }
    return out


def get_voices(
    download_dir: Union[str, Path], update_voices: bool = False
) -> Dict[str, Any]:
    """Load the voices.json registry.

    Resolution order: freshly downloaded copy (update_voices=True) >
    cached copy in download_dir > embedded snapshot (works offline,
    like the reference's vendored voices.json)."""
    download_dir = Path(download_dir)
    voices_path = download_dir / "voices.json"
    if update_voices or (
        not voices_path.exists() and not _EMBEDDED_REGISTRY.exists()
    ):
        url = URL_FORMAT.format(file="voices.json")
        _LOGGER.info("Downloading %s -> %s", url, voices_path)
        voices_path.parent.mkdir(parents=True, exist_ok=True)
        with urlopen(url) as resp, open(voices_path, "wb") as f:
            shutil.copyfileobj(resp, f)
    if voices_path.exists():
        with open(voices_path, "r", encoding="utf-8") as f:
            return json.load(f)
    with open(_EMBEDDED_REGISTRY, "r", encoding="utf-8") as f:
        return expand(json.load(f))


def ensure_voice_exists(
    name: str,
    data_dirs: Iterable[Union[str, Path]],
    download_dir: Union[str, Path],
    voices_info: Dict[str, Any],
) -> None:
    """Verify the voice's files exist with correct size/hash; download
    any that are missing or corrupt."""
    data_dirs = list(data_dirs)
    if not data_dirs:
        raise ValueError("no data dirs")
    if name not in voices_info:
        raise VoiceNotFoundError(name)

    voice_files: Dict[str, Any] = voices_info[name]["files"]
    to_download: Set[str] = set()

    for file_path, info in voice_files.items():
        file_name = Path(file_path).name
        if file_name in _SKIP_FILES:
            continue
        found = False
        for data_dir in data_dirs:
            candidate = Path(data_dir) / file_name
            if not candidate.exists():
                continue
            if candidate.stat().st_size != info["size_bytes"]:
                _LOGGER.warning("Wrong size for %s", candidate)
                continue
            if get_file_hash(candidate) != info["md5_digest"]:
                _LOGGER.warning("Wrong hash for %s", candidate)
                continue
            found = True
            break
        if not found:
            to_download.add(file_path)

    if not voice_files and not to_download:
        raise ValueError(f"Unable to find or download voice: {name}")

    download_dir = Path(download_dir)
    for file_path in to_download:
        file_name = Path(file_path).name
        if file_name in _SKIP_FILES:
            continue
        url = URL_FORMAT.format(file=file_path)
        dest = download_dir / file_name
        dest.parent.mkdir(parents=True, exist_ok=True)
        _LOGGER.info("Downloading %s -> %s", url, dest)
        with urlopen(url) as resp, open(dest, "wb") as f:
            shutil.copyfileobj(resp, f)
        info = voice_files[file_path]
        if dest.stat().st_size != info["size_bytes"] or (
            get_file_hash(dest) != info["md5_digest"]
        ):
            raise ValueError(f"Corrupt download: {dest}")


def find_voice(
    name: str, data_dirs: Iterable[Union[str, Path]]
) -> Tuple[Path, Path]:
    """Locate <name>.onnx (+ .json config) in the data dirs."""
    for data_dir in data_dirs:
        data_dir = Path(data_dir)
        for ext in (".onnx", ".npz", ".ckpt"):
            model = data_dir / f"{name}{ext}"
            cfg = data_dir / f"{name}{ext}.json"
            if model.exists():
                if not cfg.exists():
                    cfg = data_dir / f"{name}.json"
                if cfg.exists():
                    return model, cfg
    raise VoiceNotFoundError(name)
