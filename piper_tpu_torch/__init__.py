"""piper_tpu_torch — the PyTorch/CUDA port of piper_tpu.

A second package beside the JAX reference (`piper_tpu/`), mirroring its
module names. It imports torch and numpy only: nothing of JAX and
nothing of `piper_tpu` (the jax-free modules it needs are copied here).
The HiFiGAN vocoder's two Pallas TPU kernels are hand-written CUDA C++
kernels for Hopper (`csrc/`, bound in `ops/cuda/vocoder.py`).

Entry points run on CUDA unless the caller asks for the CPU
(`device="cpu"`), where every kernel wrapper takes its plain PyTorch
version.
"""

__version__ = "0.1.0"

from .config import (  # noqa: F401
    AudioConfig,
    InferenceDefaults,
    ModelConfig,
    SynthesisConfig,
    VoiceConfig,
)
