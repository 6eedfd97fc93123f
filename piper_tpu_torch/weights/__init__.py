"""Weight loading: native .npz voices -> the port's torch parameter tree."""

from .bridge import params_from_jax  # noqa: F401
from .native import load_native, save_native  # noqa: F401
