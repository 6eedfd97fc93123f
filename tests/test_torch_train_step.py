"""The port's training forward and GAN step against the JAX package on
the CPU, for a VITS voice at the tests/torch_parity.py widths (TINY,
with 16-frame segments): train_forward from the same params and key
(equal segment starts and MAS durations), then two train_steps from
JAX's initial state (every loss, and both parameter trees after each
step). The bounds are tests/torch_train_parity.py's. One jitted JAX
step function, called twice.
"""

from torch_parity import TINY
from torch_train_parity import check_forward, check_two_steps, step_config

CFG = step_config(TINY)


def test_train_forward_matches_jax():
    check_forward(CFG, seed=0)


def test_two_train_steps_match_jax():
    check_two_steps(CFG, seed=0)
