"""Native voice format: a flat .npz of the parameter tree + embedded
model config.

Counterpart of piper_tpu/weights/native.py (lines 24-80), numpy only:
the loaded tree holds numpy arrays in the JAX package's layouts, and
weights/bridge.py turns it into torch tensors on a device.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Tuple

import numpy as np

from ..config import AudioConfig, ModelConfig

Params = Dict[str, Any]


def _flatten(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}."))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}."))
    else:
        out[prefix[:-1]] = np.asarray(tree)
    return out


def _unflatten(flat: Dict[str, np.ndarray]) -> Any:
    root: Dict[str, Any] = {}
    for key, val in flat.items():
        parts = key.split(".")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val

    def listify(node):
        if not isinstance(node, dict):
            return node
        keys = list(node.keys())
        if keys and all(k.isdigit() for k in keys):
            return [listify(node[str(i)]) for i in range(len(keys))]
        return {k: listify(v) for k, v in node.items()}

    return listify(root)


def save_native(path: str, params: Params, cfg: ModelConfig) -> None:
    """Write a tree of numpy arrays (or CPU tensors) as a native voice."""
    flat = _flatten(params)
    cfg_dict = dataclasses.asdict(cfg)
    np.savez_compressed(
        path,
        __config__=np.frombuffer(
            json.dumps(cfg_dict).encode("utf-8"), dtype=np.uint8
        ),
        **flat,
    )


def load_native(path: str) -> Tuple[Params, ModelConfig]:
    data = np.load(path)
    cfg_dict = json.loads(bytes(data["__config__"]).decode("utf-8"))
    audio = AudioConfig(**cfg_dict.pop("audio"))
    for k in ("resblock_kernel_sizes", "upsample_rates", "upsample_kernel_sizes"):
        cfg_dict[k] = tuple(cfg_dict[k])
    cfg_dict["resblock_dilation_sizes"] = tuple(
        tuple(d) for d in cfg_dict["resblock_dilation_sizes"]
    )
    cfg = ModelConfig(audio=audio, **cfg_dict)
    flat = {k: data[k] for k in data.files if k != "__config__"}
    return _unflatten(flat), cfg
