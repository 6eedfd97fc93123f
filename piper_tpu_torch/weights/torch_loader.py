"""Convert reference (piper_train) torch state dicts to parameter trees.

Counterpart of piper_tpu/weights/torch_loader.py, numpy only apart from
torch.load: the tree holds numpy arrays in the JAX package's layouts,
the tree weights/native.load_native returns, so weights/bridge.py's
params_from_jax takes it unchanged.

Handles:
- weight-norm folding (weight_g / weight_v -> weight), as the reference
  does at export time (reference: export_onnx.py:51-52,
  modules.py:211-217);
- layout transposition NCW->NWC: Conv1d (out,in,k) -> (k,in,out),
  ConvTranspose1d (in,out,k) -> (k,in,out) flipped along k, 1x1 convs
  squeezed to dense (in,out);
- the module-name mapping from the reference tree (models.py) to the
  parameter tree.

The functions take a {name: np.ndarray} mapping so they work for torch
checkpoints (via torch.load) and the ONNX initializer table alike
(weights/onnx_loader.py).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np

from ..config import ModelConfig

Params = Dict[str, Any]
StateDict = Mapping[str, np.ndarray]


def _fold_weight_norm(sd: StateDict) -> Dict[str, np.ndarray]:
    """Replace every {prefix}.weight_g/.weight_v pair with {prefix}.weight.

    torch weight_norm(dim=0): w = g * v / ||v|| with the norm taken over
    all dims except 0.
    """
    out: Dict[str, np.ndarray] = {}
    for k, v in sd.items():
        if k.endswith(".weight_g"):
            prefix = k[: -len(".weight_g")]
            g = np.asarray(v, np.float64)
            vv = np.asarray(sd[prefix + ".weight_v"], np.float64)
            axes = tuple(range(1, vv.ndim))
            norm = np.sqrt(np.sum(vv * vv, axis=axes, keepdims=True))
            out[prefix + ".weight"] = (g * vv / norm).astype(np.float32)
        elif k.endswith(".weight_v"):
            continue
        else:
            out[k] = np.asarray(v)
    return out


class _SD:
    """State-dict view with prefix navigation and access tracking."""

    def __init__(self, sd: Dict[str, np.ndarray], prefix: str = ""):
        self.sd = sd
        self.prefix = prefix

    def sub(self, name: str) -> "_SD":
        return _SD(self.sd, f"{self.prefix}{name}.")

    def get(self, name: str) -> np.ndarray:
        return np.asarray(self.sd[self.prefix + name], np.float32)

    def has(self, name: str) -> bool:
        return (self.prefix + name) in self.sd

    def conv(self, name: str, bias: bool = True) -> Params:
        """Conv1d (out, in/groups, k) -> {w: (k, in/groups, out), b}."""
        w = self.get(f"{name}.weight").transpose(2, 1, 0)
        p: Params = {"w": w}
        if bias and self.has(f"{name}.bias"):
            p["b"] = self.get(f"{name}.bias")
        return p

    def dense(self, name: str, bias: bool = True) -> Params:
        """1x1 Conv1d (out, in, 1) -> {w: (in, out), b}."""
        w = self.get(f"{name}.weight")[:, :, 0].T
        p: Params = {"w": np.ascontiguousarray(w)}
        if bias and self.has(f"{name}.bias"):
            p["b"] = self.get(f"{name}.bias")
        return p

    def conv_transpose(self, name: str) -> Params:
        """ConvTranspose1d (in, out, k) -> {w: (k, in, out) flipped, b}."""
        w = self.get(f"{name}.weight")  # (in, out, k)
        w = w.transpose(2, 0, 1)[::-1]  # (k, in, out), kernel reversed
        return {"w": np.ascontiguousarray(w), "b": self.get(f"{name}.bias")}

    def layer_norm(self, name: str) -> Params:
        return {"gamma": self.get(f"{name}.gamma"), "beta": self.get(f"{name}.beta")}


# ---------------------------------------------------------------------------
# Per-module converters (reference module layout -> parameter tree)
# ---------------------------------------------------------------------------


def _convert_ddsconv(s: _SD, n_layers: int) -> Params:
    return {
        "convs_sep": [
            # depthwise: torch (C, 1, k) -> (k, 1, C)
            {
                "w": s.get(f"convs_sep.{i}.weight").transpose(2, 1, 0),
                "b": s.get(f"convs_sep.{i}.bias"),
            }
            for i in range(n_layers)
        ],
        "convs_1x1": [s.dense(f"convs_1x1.{i}") for i in range(n_layers)],
        "norms_1": [s.layer_norm(f"norms_1.{i}") for i in range(n_layers)],
        "norms_2": [s.layer_norm(f"norms_2.{i}") for i in range(n_layers)],
    }


def _convert_conv_flow(s: _SD) -> Params:
    return {
        "pre": s.dense("pre"),
        "convs": _convert_ddsconv(s.sub("convs"), 3),
        "proj": s.dense("proj"),
    }


def _convert_sdp_flowlist(s: _SD, n_conv_flows: int) -> Params:
    # reference flows: [ElementwiseAffine, (ConvFlow, Flip) * n]
    return {
        "affine": {
            "m": s.get("0.m")[:, 0],
            "logs": s.get("0.logs")[:, 0],
        },
        "conv_flows": [
            _convert_conv_flow(s.sub(f"{1 + 2 * i}")) for i in range(n_conv_flows)
        ],
    }


def _convert_sdp(s: _SD, has_cond: bool) -> Params:
    p = {
        "pre": s.dense("pre"),
        "proj": s.dense("proj"),
        "convs": _convert_ddsconv(s.sub("convs"), 3),
        "flows": _convert_sdp_flowlist(s.sub("flows"), 4),
    }
    # Posterior (training-only) flows are pruned from inference-only
    # exports (ONNX voices keep only the reverse path).
    if s.has("post_pre.weight"):
        p["post_pre"] = s.dense("post_pre")
        p["post_proj"] = s.dense("post_proj")
        p["post_convs"] = _convert_ddsconv(s.sub("post_convs"), 3)
        p["post_flows"] = _convert_sdp_flowlist(s.sub("post_flows"), 4)
    if has_cond and s.has("cond.weight"):
        p["cond"] = s.dense("cond")
    return p


def _convert_dp(s: _SD, has_cond: bool) -> Params:
    p = {
        "conv1": s.conv("conv_1"),
        "norm1": s.layer_norm("norm_1"),
        "conv2": s.conv("conv_2"),
        "norm2": s.layer_norm("norm_2"),
        "proj": s.dense("proj"),
    }
    if has_cond and s.has("cond.weight"):
        p["cond"] = s.dense("cond")
    return p


def _convert_wn(s: _SD, n_layers: int) -> Params:
    p: Params = {
        "in_layers": [s.conv(f"in_layers.{i}") for i in range(n_layers)],
        "res_skip_layers": [s.dense(f"res_skip_layers.{i}") for i in range(n_layers)],
    }
    if s.has("cond_layer.weight"):
        p["cond_layer"] = s.dense("cond_layer")
    return p


def _convert_text_encoder(s: _SD, cfg: ModelConfig) -> Params:
    enc = s.sub("encoder")
    layers = []
    for i in range(cfg.n_layers):
        attn = enc.sub(f"attn_layers.{i}")
        layers.append(
            {
                "attn": {
                    "q": attn.dense("conv_q"),
                    "k": attn.dense("conv_k"),
                    "v": attn.dense("conv_v"),
                    "o": attn.dense("conv_o"),
                    "emb_rel_k": attn.get("emb_rel_k"),
                    "emb_rel_v": attn.get("emb_rel_v"),
                },
                "norm1": enc.layer_norm(f"norm_layers_1.{i}"),
                "ffn": {
                    "conv1": enc.conv(f"ffn_layers.{i}.conv_1"),
                    "conv2": enc.conv(f"ffn_layers.{i}.conv_2"),
                },
                "norm2": enc.layer_norm(f"norm_layers_2.{i}"),
            }
        )
    return {
        "emb": {"weight": s.get("emb.weight")},
        "encoder": {"layers": layers},
        "proj": s.dense("proj"),
    }


def _convert_flow(s: _SD, cfg: ModelConfig) -> Params:
    layers = []
    for i in range(cfg.flow_n_flows):
        lp = s.sub(f"flows.{2 * i}")  # odd indices are Flip (no params)
        layers.append(
            {
                "pre": lp.dense("pre"),
                "enc": _convert_wn(lp.sub("enc"), cfg.flow_n_layers),
                "post": lp.dense("post"),
            }
        )
    return {"layers": layers}


def _convert_generator(s: _SD, cfg: ModelConfig) -> Params:
    p: Params = {
        "conv_pre": s.conv("conv_pre"),
        "ups": [s.conv_transpose(f"ups.{i}") for i in range(len(cfg.upsample_rates))],
        "resblocks": [],
        "conv_post": s.conv("conv_post", bias=False),
    }
    num_kernels = len(cfg.resblock_kernel_sizes)
    for i in range(len(cfg.upsample_rates)):
        blocks = []
        for j in range(num_kernels):
            rb = s.sub(f"resblocks.{i * num_kernels + j}")
            if cfg.resblock == "1":
                n = len(cfg.resblock_dilation_sizes[j])
                blocks.append(
                    {
                        "convs1": [rb.conv(f"convs1.{m}") for m in range(n)],
                        "convs2": [rb.conv(f"convs2.{m}") for m in range(n)],
                    }
                )
            else:
                n = len(cfg.resblock_dilation_sizes[j])
                blocks.append({"convs": [rb.conv(f"convs.{m}") for m in range(n)]})
        p["resblocks"].append(blocks)
    if s.has("cond.weight"):
        p["cond"] = s.dense("cond")
    return p


def _convert_posterior(s: _SD, cfg: ModelConfig) -> Params:
    return {
        "pre": s.dense("pre"),
        "enc": _convert_wn(s.sub("enc"), 16),
        "proj": s.dense("proj"),
    }


def params_from_state_dict(
    state_dict: Mapping[str, Any],
    cfg: ModelConfig,
    *,
    prefix: str = "",
    include_posterior: bool = False,
) -> Params:
    """Build the parameter tree from a reference state dict.

    `prefix` is e.g. "model_g." for Lightning checkpoints
    (reference: lightning.py:87). Values may be torch tensors or numpy
    arrays.
    """
    sd_np: Dict[str, np.ndarray] = {}
    for k, v in state_dict.items():
        if not k.startswith(prefix):
            continue
        k = k[len(prefix):]
        if hasattr(v, "detach"):
            v = v.detach().cpu().numpy()
        sd_np[k] = np.asarray(v)
    sd_np = _fold_weight_norm(sd_np)
    s = _SD(sd_np)

    has_g = cfg.gin_channels > 0
    p: Params = {
        "enc_p": _convert_text_encoder(s.sub("enc_p"), cfg),
        "dp": (
            _convert_sdp(s.sub("dp"), has_g)
            if cfg.use_sdp
            else _convert_dp(s.sub("dp"), has_g)
        ),
        "flow": _convert_flow(s.sub("flow"), cfg),
        "dec": _convert_generator(s.sub("dec"), cfg),
    }
    if s.has("emb_g.weight"):
        p["emb_g"] = {"weight": s.get("emb_g.weight")}
    if include_posterior and s.has("enc_q.pre.weight"):
        p["enc_q"] = _convert_posterior(s.sub("enc_q"), cfg)
    return p


def load_torch_checkpoint(
    path: str,
    cfg: Optional[ModelConfig] = None,
    *,
    include_posterior: bool = False,
):
    """Load a piper_train Lightning checkpoint (.ckpt) into a parameter tree.

    Returns (params, cfg). Derives the ModelConfig from the
    checkpoint's hyper_parameters when `cfg` is None
    (reference hparams: lightning.py:20-77).
    """
    import torch

    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    if "state_dict" in ckpt:
        sd = ckpt["state_dict"]
        prefix = "model_g."
        if cfg is None:
            hp = ckpt.get("hyper_parameters", {})
            cfg = ModelConfig(
                num_symbols=hp["num_symbols"],
                num_speakers=hp.get("num_speakers", 1),
                inter_channels=hp.get("inter_channels", 192),
                hidden_channels=hp.get("hidden_channels", 192),
                filter_channels=hp.get("filter_channels", 768),
                n_heads=hp.get("n_heads", 2),
                n_layers=hp.get("n_layers", 6),
                kernel_size=hp.get("kernel_size", 3),
                p_dropout=hp.get("p_dropout", 0.1),
                resblock=hp.get("resblock", "2"),
                resblock_kernel_sizes=tuple(hp.get("resblock_kernel_sizes", (3, 5, 7))),
                resblock_dilation_sizes=tuple(
                    tuple(d) for d in hp.get("resblock_dilation_sizes", ((1, 2), (2, 6), (3, 12)))
                ),
                upsample_rates=tuple(hp.get("upsample_rates", (8, 8, 4))),
                upsample_initial_channel=hp.get("upsample_initial_channel", 256),
                upsample_kernel_sizes=tuple(hp.get("upsample_kernel_sizes", (16, 16, 8))),
                gin_channels=hp.get("gin_channels", 0) or (
                    512 if hp.get("num_speakers", 1) > 1 else 0
                ),
                use_sdp=hp.get("use_sdp", True),
            )
    else:
        sd = ckpt
        prefix = ""
        if cfg is None:
            raise ValueError("raw state dict requires an explicit ModelConfig")
    params = params_from_state_dict(
        sd, cfg, prefix=prefix, include_posterior=include_posterior
    )
    return params, cfg
