"""Parameter tree -> reference-layout state dict.

Counterpart of piper_tpu/weights/torch_export.py (state_dict_from_params
and its helpers), numpy only. The exact inverse of
weights/torch_loader.params_from_state_dict: emits {name: ndarray} with
the reference (piper_train) module names and torch tensor layouts
(Conv1d (out, in/g, k), ConvTranspose1d (in, out, k), 1x1 convs as
(out, in, 1)), from which a .ckpt can be written without the JAX
package.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

from ..config import ModelConfig

Params = Dict[str, Any]
StateDict = Dict[str, np.ndarray]


def _np(x) -> np.ndarray:
    return np.asarray(x, np.float32)


def _dense(sd: StateDict, name: str, p: Params) -> None:
    sd[f"{name}.weight"] = np.ascontiguousarray(_np(p["w"]).T)[:, :, None]
    if "b" in p:
        sd[f"{name}.bias"] = _np(p["b"])


def _conv(sd: StateDict, name: str, p: Params) -> None:
    sd[f"{name}.weight"] = np.ascontiguousarray(_np(p["w"]).transpose(2, 1, 0))
    if "b" in p:
        sd[f"{name}.bias"] = _np(p["b"])


def _conv_transpose(sd: StateDict, name: str, p: Params) -> None:
    # stored (k, in, out) pre-flipped (the JAX package's layout);
    # torch keeps (in, out, k) unflipped
    w = _np(p["w"])[::-1].transpose(1, 2, 0)
    sd[f"{name}.weight"] = np.ascontiguousarray(w)
    sd[f"{name}.bias"] = _np(p["b"])


def _layer_norm(sd: StateDict, name: str, p: Params) -> None:
    sd[f"{name}.gamma"] = _np(p["gamma"])
    sd[f"{name}.beta"] = _np(p["beta"])


def _ddsconv(sd: StateDict, prefix: str, p: Params) -> None:
    for i, c in enumerate(p["convs_sep"]):
        # depthwise (k, 1, C) -> torch (C, 1, k)
        sd[f"{prefix}.convs_sep.{i}.weight"] = np.ascontiguousarray(
            _np(c["w"]).transpose(2, 1, 0)
        )
        sd[f"{prefix}.convs_sep.{i}.bias"] = _np(c["b"])
    for i, c in enumerate(p["convs_1x1"]):
        _dense(sd, f"{prefix}.convs_1x1.{i}", c)
    for i, n in enumerate(p["norms_1"]):
        _layer_norm(sd, f"{prefix}.norms_1.{i}", n)
    for i, n in enumerate(p["norms_2"]):
        _layer_norm(sd, f"{prefix}.norms_2.{i}", n)


def _sdp_flowlist(sd: StateDict, prefix: str, p: Params) -> None:
    sd[f"{prefix}.0.m"] = _np(p["affine"]["m"])[:, None]
    sd[f"{prefix}.0.logs"] = _np(p["affine"]["logs"])[:, None]
    for i, cf in enumerate(p["conv_flows"]):
        name = f"{prefix}.{1 + 2 * i}"
        _dense(sd, f"{name}.pre", cf["pre"])
        _ddsconv(sd, f"{name}.convs", cf["convs"])
        _dense(sd, f"{name}.proj", cf["proj"])


def state_dict_from_params(
    params: Params, cfg: ModelConfig, *, inference_only: bool = True
) -> StateDict:
    """Flatten a parameter tree to reference names/layouts.

    inference_only drops the SDP posterior flows and the posterior
    encoder (what reference ONNX exports contain)."""
    sd: StateDict = {}

    # enc_p
    enc = params["enc_p"]
    sd["enc_p.emb.weight"] = _np(enc["emb"]["weight"])
    for i, lp in enumerate(enc["encoder"]["layers"]):
        a = lp["attn"]
        _dense(sd, f"enc_p.encoder.attn_layers.{i}.conv_q", a["q"])
        _dense(sd, f"enc_p.encoder.attn_layers.{i}.conv_k", a["k"])
        _dense(sd, f"enc_p.encoder.attn_layers.{i}.conv_v", a["v"])
        _dense(sd, f"enc_p.encoder.attn_layers.{i}.conv_o", a["o"])
        sd[f"enc_p.encoder.attn_layers.{i}.emb_rel_k"] = _np(a["emb_rel_k"])
        sd[f"enc_p.encoder.attn_layers.{i}.emb_rel_v"] = _np(a["emb_rel_v"])
        _layer_norm(sd, f"enc_p.encoder.norm_layers_1.{i}", lp["norm1"])
        _conv(sd, f"enc_p.encoder.ffn_layers.{i}.conv_1", lp["ffn"]["conv1"])
        _conv(sd, f"enc_p.encoder.ffn_layers.{i}.conv_2", lp["ffn"]["conv2"])
        _layer_norm(sd, f"enc_p.encoder.norm_layers_2.{i}", lp["norm2"])
    _dense(sd, "enc_p.proj", enc["proj"])

    # dp
    dp = params["dp"]
    if cfg.use_sdp:
        _dense(sd, "dp.pre", dp["pre"])
        _dense(sd, "dp.proj", dp["proj"])
        _ddsconv(sd, "dp.convs", dp["convs"])
        _sdp_flowlist(sd, "dp.flows", dp["flows"])
        if not inference_only and "post_pre" in dp:
            _dense(sd, "dp.post_pre", dp["post_pre"])
            _dense(sd, "dp.post_proj", dp["post_proj"])
            _ddsconv(sd, "dp.post_convs", dp["post_convs"])
            _sdp_flowlist(sd, "dp.post_flows", dp["post_flows"])
        if "cond" in dp:
            _dense(sd, "dp.cond", dp["cond"])
    else:
        _conv(sd, "dp.conv_1", dp["conv1"])
        _layer_norm(sd, "dp.norm_1", dp["norm1"])
        _conv(sd, "dp.conv_2", dp["conv2"])
        _layer_norm(sd, "dp.norm_2", dp["norm2"])
        _dense(sd, "dp.proj", dp["proj"])
        if "cond" in dp:
            _dense(sd, "dp.cond", dp["cond"])

    # flow (odd indices are parameterless Flips)
    for i, lp in enumerate(params["flow"]["layers"]):
        name = f"flow.flows.{2 * i}"
        _dense(sd, f"{name}.pre", lp["pre"])
        for j, c in enumerate(lp["enc"]["in_layers"]):
            _conv(sd, f"{name}.enc.in_layers.{j}", c)
        for j, c in enumerate(lp["enc"]["res_skip_layers"]):
            _dense(sd, f"{name}.enc.res_skip_layers.{j}", c)
        if "cond_layer" in lp["enc"]:
            _dense(sd, f"{name}.enc.cond_layer", lp["enc"]["cond_layer"])
        _dense(sd, f"{name}.post", lp["post"])

    # dec (HiFiGAN)
    dec = params["dec"]
    _conv(sd, "dec.conv_pre", dec["conv_pre"])
    for i, up in enumerate(dec["ups"]):
        _conv_transpose(sd, f"dec.ups.{i}", up)
    num_kernels = len(cfg.resblock_kernel_sizes)
    for i, blocks in enumerate(dec["resblocks"]):
        for j, rb in enumerate(blocks):
            name = f"dec.resblocks.{i * num_kernels + j}"
            if cfg.resblock == "1":
                for m, c in enumerate(rb["convs1"]):
                    _conv(sd, f"{name}.convs1.{m}", c)
                for m, c in enumerate(rb["convs2"]):
                    _conv(sd, f"{name}.convs2.{m}", c)
            else:
                for m, c in enumerate(rb["convs"]):
                    _conv(sd, f"{name}.convs.{m}", c)
    _conv(sd, "dec.conv_post", dec["conv_post"])
    if "cond" in dec:
        _dense(sd, "dec.cond", dec["cond"])

    if "emb_g" in params:
        sd["emb_g.weight"] = _np(params["emb_g"]["weight"])
    if not inference_only and "enc_q" in params:
        q = params["enc_q"]
        _dense(sd, "enc_q.pre", q["pre"])
        for j, c in enumerate(q["enc"]["in_layers"]):
            _conv(sd, f"enc_q.enc.in_layers.{j}", c)
        for j, c in enumerate(q["enc"]["res_skip_layers"]):
            _dense(sd, f"enc_q.enc.res_skip_layers.{j}", c)
        if "cond_layer" in q["enc"]:
            _dense(sd, "enc_q.enc.cond_layer", q["enc"]["cond_layer"])
        _dense(sd, "enc_q.proj", q["proj"])
    return sd
