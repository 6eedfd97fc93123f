"""The port's training forward and GAN step against the JAX package on
the CPU, for a VITS2 voice (TINY_VITS2: three speakers, the flow's
attention, the speaker-conditioned encoder, the duration discriminator
and noised MAS, with 16-frame segments): train_forward from the same
params and key (equal segment starts and MAS durations under the MAS
noise), then two train_steps from JAX's initial state (every loss, the
duration discriminator's included, and both parameter trees after each
step). The bounds are tests/torch_train_parity.py's. One jitted JAX
step function, called twice.
"""

from torch_parity import TINY_VITS2
from torch_train_parity import check_forward, check_two_steps, step_config

CFG = step_config(TINY_VITS2)


def test_train_forward_matches_jax():
    check_forward(CFG, seed=1)


def test_two_train_steps_match_jax():
    check_two_steps(CFG, seed=1)
