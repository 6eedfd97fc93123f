"""Weight loading: native .npz voices, piper_train .ckpt checkpoints and
exported .onnx voices -> a numpy parameter tree in the JAX package's
layouts (native.py, torch_loader.py, onnx_loader.py), and that tree ->
the port's torch parameter tree (bridge.py)."""

from .bridge import params_from_jax  # noqa: F401
from .native import load_native, save_native  # noqa: F401
