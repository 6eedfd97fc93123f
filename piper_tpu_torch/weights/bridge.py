"""The weight bridge: a JAX parameter tree (numpy leaves) -> torch tensors.

The port keeps the JAX package's parameter layouts so the two can be
compared leaf by leaf:

  dense:            w (in, out), b (out,)
  conv1d:           w (k, in // groups, out), b (out,)
  conv transpose:   w (k, in, out), stored PRE-FLIPPED for the
                    input-dilated formulation (piper_tpu/ops/nn.py:64-157;
                    the flip shows in piper_tpu/weights/torch_export.py:39)

A plain torch ConvTranspose1d needs that flip undone:
ops/nn.py::torch_conv_transpose_weight does it where the port calls
F.conv_transpose1d; the polyphase tables of the time-major generator
(models/vits/generator.py::prepare_tm) read the pre-flipped layout as is.

Voices may store float16 arrays (tests/data/voice_xlow_trained_fp16.npz),
so every float leaf is cast explicitly: to the compute dtype, except the
duration predictor ("dp"), whose math stays float32 in both precisions
(models/vits/duration.py).
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch

from ..config import ModelConfig

Params = Dict[str, Any]

FLOAT32_SUBTREES = ("dp",)


def _to_tensor(a, device, dtype) -> torch.Tensor:
    arr = np.asarray(a)
    if arr.dtype.kind in "iu":
        return torch.tensor(arr, device=device)
    return torch.tensor(arr, dtype=torch.float32).to(device=device, dtype=dtype)


def _convert(tree: Any, device, dtype) -> Any:
    if isinstance(tree, dict):
        return {k: _convert(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_convert(v, device, dtype) for v in tree]
    return _to_tensor(tree, device, dtype)


def params_from_jax(
    tree: Params,
    cfg: ModelConfig,
    device="cpu",
    dtype: torch.dtype = torch.float32,
) -> Params:
    """Numpy tree in the JAX layouts -> the port's tree of tensors.

    Raises when the tree does not match `cfg` (missing generator stages,
    wrong conv-transpose shapes), so a voice loaded against the wrong
    config fails here and not deep inside a kernel.
    """
    _check_tree(tree, cfg)
    out = {}
    for k, v in tree.items():
        sub_dtype = torch.float32 if k in FLOAT32_SUBTREES else dtype
        out[k] = _convert(v, device, sub_dtype)
    return out


def params_d_from_jax(tree: Params, cfg: ModelConfig, device="cpu") -> Params:
    """The discriminators' numpy tree (the JAX package's params_d:
    disc_s, disc_p and, for VITS2, dur_disc) -> float32 tensors. Raises
    when it does not match `cfg`."""
    _check_tree_d(tree, cfg)
    return _convert(tree, device, torch.float32)


def _check_tree(tree: Params, cfg: ModelConfig) -> None:
    """Raise when the tree lacks what `cfg` runs: the generator's stages
    and shapes (HiFiGAN or MB-iSTFT), VITS2's attention in every coupling
    layer (flow_transformer) and the text encoder's speaker projection
    (speaker_cond_encoder with a speaker embedding)."""
    for key in ("enc_p", "dp", "flow", "dec"):
        if key not in tree:
            raise KeyError(f"voice parameters lack {key!r}")
    dec = tree["dec"]
    uic = cfg.upsample_initial_channel
    if len(dec["ups"]) != len(cfg.upsample_rates):
        raise ValueError(
            f"generator has {len(dec['ups'])} upsample stages, config "
            f"{len(cfg.upsample_rates)}"
        )
    for i, k in enumerate(cfg.upsample_kernel_sizes):
        want = (k, uic // 2**i, uic // 2 ** (i + 1))
        got = tuple(np.shape(dec["ups"][i]["w"]))
        if got != want:
            raise ValueError(f"dec.ups.{i}.w has shape {got}, expected {want}")
    if cfg.vocoder == "mb_istft":
        want = (7, uic // 2 ** len(cfg.upsample_rates), cfg.subbands * (cfg.istft_n_fft + 2))
        got = tuple(np.shape(dec["conv_post"]["w"]))
        if got != want or "b" not in dec["conv_post"]:
            raise ValueError(
                f"dec.conv_post.w has shape {got} (bias: {'b' in dec['conv_post']}), "
                f"MB-iSTFT expects {want} with a bias"
            )
    if cfg.flow_transformer:
        for i, layer in enumerate(tree["flow"]["layers"]):
            if "attn" not in layer or "attn_norm" not in layer:
                raise ValueError(f"flow_transformer: flow.layers.{i} lacks attn or attn_norm")
    if cfg.speaker_cond_encoder and cfg.gin_channels and "cond" not in tree["enc_p"]:
        raise ValueError("speaker_cond_encoder: enc_p lacks cond")
    if "enc_q" in tree:  # a training tree: the posterior encoder's shapes
        enc_q = tree["enc_q"]
        checks = (
            ("enc_q.pre.w", enc_q["pre"]["w"], (cfg.spec_channels, cfg.hidden_channels)),
            ("enc_q.proj.w", enc_q["proj"]["w"], (cfg.hidden_channels, 2 * cfg.inter_channels)),
        )
        for name, w, want in checks:
            if tuple(np.shape(w)) != want:
                raise ValueError(f"{name} has shape {tuple(np.shape(w))}, expected {want}")
        if bool(cfg.gin_channels) != ("cond_layer" in enc_q["enc"]):
            raise ValueError("enc_q.enc.cond_layer must be there exactly when gin_channels is set")


def _check_tree_d(tree: Params, cfg: ModelConfig) -> None:
    """Raise when the discriminators' tree lacks what training runs: the
    scale discriminator, five period discriminators, and VITS2's
    duration discriminator over the text encoder's hidden width."""
    for key in ("disc_s", "disc_p"):
        if key not in tree:
            raise KeyError(f"discriminator parameters lack {key!r}")
    if len(tree["disc_p"]) != 5:
        raise ValueError(f"{len(tree['disc_p'])} period discriminators, expected 5")
    if cfg.use_dur_disc:
        if "dur_disc" not in tree:
            raise KeyError("use_dur_disc: discriminator parameters lack 'dur_disc'")
        got = tuple(np.shape(tree["dur_disc"]["pre_x"]["w"]))[:1]
        if got != (cfg.hidden_channels,):
            raise ValueError(f"dur_disc.pre_x.w takes {got} channels, expected {cfg.hidden_channels}")


def iter_leaves(tree: Any, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """(dotted name, leaf) pairs in the native-format key order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from iter_leaves(v, f"{prefix}{k}.")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from iter_leaves(v, f"{prefix}{i}.")
    else:
        yield prefix[:-1], tree
