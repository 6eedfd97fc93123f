"""ONNX interchange for the port's voices.

Counterpart of piper_tpu/onnx_io/, numpy only (no torch, no onnx):
- `writer`: dependency-free ONNX protobuf serializer + graph builder.
- `graph`: emits the VITS inference graph (piper runtime contract:
  inputs input/input_lengths/scales[/sid], output (B, 1, T_samples) —
  reference export_onnx.py:88-101) from a parameter tree, so voices
  trained by the port run under the original piper runtimes
  (onnxruntime C++/Python).
- `interp`: numpy interpreter for the op subset `graph` emits and for
  the bundled Silero VAD — offline validation (onnxruntime is not a
  dependency) and a pure-CPU reference executor.
"""

from .graph import export_onnx_voice  # noqa: F401
