"""Voice export CLI.

Counterpart of piper_tpu/export.py, with its flags: converts any
loadable voice or checkpoint, read by the port's loaders, into
  - the native .npz artifact + voice JSON sidecar (--format npz, the
    default), or
  - a piper-compatible .onnx (--format onnx, onnx_io/graph.py): the
    reference export's input/output contract (export_onnx.py:88-101),
    so voices trained by the port run under the original piper
    runtimes (onnxruntime C++/Python); the bytes equal the JAX
    package's export of the same weights.

--format torchscript|generator (the JAX package's export_torch.py) is
refused with a message: both build piper_train's SynthesizerTrn, which
neither package ships. Export runs on the host; no GPU is needed.

Usage:
  python -m piper_tpu_torch.export --input epoch=...ckpt --config config.json \
      --output voice.npz
  python -m piper_tpu_torch.export --input en_US-lessac-medium.onnx \
      --output voice.npz          # config auto-found at <input>.json
  python -m piper_tpu_torch.export --input voice.npz --format onnx \
      --output voice.onnx         # deploy back into the piper ecosystem
"""

from __future__ import annotations

import argparse
import logging
import shutil
from pathlib import Path

_LOGGER = logging.getLogger("piper_tpu_torch.export")

NOT_PORTED = (
    "--format {fmt} builds piper_train's torch SynthesizerTrn (the JAX "
    "package's export_torch.py), which is not installed and is not part of "
    "the port; export to npz or onnx instead"
)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="piper_tpu_torch.export")
    p.add_argument("--input", required=True,
                   help=".ckpt (piper_train Lightning), .onnx (piper voice), "
                        "or .npz")
    p.add_argument("--config", help="Voice JSON config (default: <input>.json)")
    p.add_argument("--output", required=True, help="Output path")
    p.add_argument("--format", choices=("npz", "onnx", "torchscript",
                                        "generator"), default="npz",
                   help="Output artifact: native .npz (default) or a "
                        "piper-compatible .onnx (torchscript and generator "
                        "exit with an error: they need piper_train)")
    p.add_argument("--include-posterior", action="store_true",
                   help="Keep the posterior encoder (needed for voice "
                        "conversion; .ckpt inputs only)")
    p.add_argument("--debug", action="store_true")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.DEBUG if args.debug else logging.INFO)
    if args.format in ("torchscript", "generator"):
        raise SystemExit(NOT_PORTED.format(fmt=args.format))

    from .weights.native import save_native

    input_path = Path(args.input)
    suffix = input_path.suffix.lower()
    if suffix == ".ckpt":
        from .weights.torch_loader import load_torch_checkpoint

        params, cfg = load_torch_checkpoint(
            str(input_path), include_posterior=args.include_posterior
        )
    elif suffix == ".onnx":
        from .config import VoiceConfig
        from .weights.onnx_loader import load_onnx_voice

        base_cfg = None
        cfg_path = args.config or f"{input_path}.json"
        if Path(cfg_path).exists():
            base_cfg = VoiceConfig.from_file(cfg_path).model_config()
        params, cfg = load_onnx_voice(str(input_path), base_cfg)
    elif suffix == ".npz":
        from .weights.native import load_native

        params, cfg = load_native(str(input_path))
    else:
        raise SystemExit(f"unsupported input format: {input_path}")

    if args.format == "onnx":
        from .onnx_io import export_onnx_voice

        export_onnx_voice(params, cfg, args.output)
    else:
        save_native(args.output, params, cfg)
    _LOGGER.info("Wrote %s", args.output)

    # Copy the voice JSON sidecar next to the output.
    out_cfg = Path(f"{args.output}.json")
    src_cfg = Path(args.config) if args.config else Path(f"{input_path}.json")
    if src_cfg.exists():
        shutil.copyfile(src_cfg, out_cfg)
        _LOGGER.info("Wrote %s", out_cfg)
    else:
        _LOGGER.warning(
            "No voice JSON config found at %s — write one next to the "
            "output for serving (phoneme_id_map etc.)", src_cfg,
        )


if __name__ == "__main__":
    main()
