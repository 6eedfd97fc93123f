"""Emit the VITS inference graph as ONNX (piper runtime contract).

Counterpart of piper_tpu/onnx_io/graph.py, numpy only: the same nodes,
names and initializers in the same order, so the port exports the same
bytes as the JAX package from the same parameter tree (the port's
weights/torch_export.state_dict_from_params gives the same state dict).

The exported model follows the reference export's interface
(reference: export_onnx.py:88-101): inputs `input` int64 (B, T_ph),
`input_lengths` int64 (B,), `scales` float32 (3,) =
[noise_scale, length_scale, noise_w], `sid` int64 (B,) for
multi-speaker voices; output `output` float32 (B, 1, T_samples). So a
voice trained with either package runs under the original piper runtimes
(onnxruntime C++/Python) unchanged.

Layout is NCW (the ONNX Conv convention): every weight-carrying op
consumes torch-shaped initializers named after the reference module
tree (weights/torch_export.py), which also makes the file loadable by
weights/onnx_loader.py — the round trip is tested.

The graph is fully dynamic in batch and length; all the reference's
inference math (models.py:681-722) is reproduced:
 - windowed relative-position attention in band form (exactly equal to
   the padded formulation — see models/vits/encoder.py);
 - SDP spline-flow reverse (transforms.py:101-212), inverse branch;
 - duration -> frame expansion as searchsorted + GatherElements
   (equivalent to the reference's dense generate_path matmul);
 - residual-coupling flow reverse and the HiFiGAN stack.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional

import numpy as np

from ..config import ModelConfig
from ..weights.torch_export import state_dict_from_params
from .writer import BOOL, FLOAT, INT64, GraphBuilder

WINDOW = 4  # attentions.py:21
SDP_BINS = 10
SDP_TAIL = 5.0
MIN_W = MIN_H = MIN_D = 1e-3


class _Emit:
    """Thin convenience layer over GraphBuilder for this graph."""

    def __init__(self, b: GraphBuilder, sd: Dict[str, np.ndarray]):
        self.b = b
        self.sd = sd

    # -- weights -------------------------------------------------------
    def w(self, name: str) -> str:
        return self.b.init(name, self.sd[name])

    def has(self, name: str) -> bool:
        return name in self.sd

    # -- scalar/consts -------------------------------------------------
    def cf(self, v: float) -> str:
        return self.b.const(np.float32(v), "f")

    def ci(self, v: int) -> str:
        return self.b.const(np.int64(v), "i")

    # -- generic nodes ---------------------------------------------------
    def n(self, op: str, *ins: str, **attrs) -> str:
        return self.b.node(op, list(ins), **attrs)

    def add(self, a, b):
        return self.n("Add", a, b)

    def sub(self, a, b):
        return self.n("Sub", a, b)

    def mul(self, a, b):
        return self.n("Mul", a, b)

    def div(self, a, b):
        return self.n("Div", a, b)

    def unsq(self, x, axes):
        return self.n("Unsqueeze", x, self.b.i64(axes))

    def sq(self, x, axes):
        return self.n("Squeeze", x, self.b.i64(axes))

    def reshape(self, x, shape) -> str:
        if isinstance(shape, (list, tuple)):
            shape = self.b.i64(shape)
        return self.n("Reshape", x, shape)

    def transpose(self, x, perm):
        return self.n("Transpose", x, perm=list(perm))

    def cast(self, x, to):
        return self.n("Cast", x, to=to)

    def slice(self, x, starts, ends, axes, steps=None):
        ins = [x, self.b.i64(starts), self.b.i64(ends), self.b.i64(axes)]
        if steps is not None:
            ins.append(self.b.i64(steps))
        return self.b.node("Slice", ins)

    def concat(self, xs, axis):
        return self.b.node("Concat", list(xs), axis=axis)

    # -- layers ----------------------------------------------------------
    def conv(self, x, name, *, pads=(0, 0), dilation=1, stride=1, group=1):
        ins = [x, self.w(f"{name}.weight")]
        if self.has(f"{name}.bias"):
            ins.append(self.w(f"{name}.bias"))
        return self.b.node(
            "Conv", ins, pads=list(pads), dilations=[dilation],
            strides=[stride], group=group,
        )

    def conv_t(self, x, name, *, stride, pad):
        return self.b.node(
            "ConvTranspose",
            [x, self.w(f"{name}.weight"), self.w(f"{name}.bias")],
            strides=[stride], pads=[pad, pad],
        )

    def layer_norm(self, x, name):
        """Channel-dim layer norm on (B, C, T) (modules.py:14-26)."""
        mean = self.n("ReduceMean", x, axes=[1], keepdims=1)
        d = self.sub(x, mean)
        var = self.n("ReduceMean", self.mul(d, d), axes=[1], keepdims=1)
        inv = self.div(
            self.cf(1.0), self.n("Sqrt", self.add(var, self.cf(1e-5)))
        )
        y = self.mul(d, inv)
        gamma = self.unsq(self.w(f"{name}.gamma"), [0, 2])
        beta = self.unsq(self.w(f"{name}.beta"), [0, 2])
        return self.add(self.mul(y, gamma), beta)

    def leaky(self, x, slope):
        return self.n("LeakyRelu", x, alpha=float(slope))

    def gelu(self, x):
        """Exact erf GELU (torch F.gelu default, used by DDSConv)."""
        inner = self.n("Erf", self.mul(x, self.cf(1.0 / math.sqrt(2.0))))
        return self.mul(self.mul(x, self.cf(0.5)), self.add(inner, self.cf(1.0)))

    def softplus(self, x):
        """Numerically stable softplus: max(x,0) + log1p(exp(-|x|))."""
        mx = self.n("Max", x, self.cf(0.0))
        tail = self.n(
            "Log",
            self.add(
                self.cf(1.0),
                self.n("Exp", self.n("Neg", self.n("Abs", x))),
            ),
        )
        return self.add(mx, tail)

    def ddsconv(self, x, prefix, xm, *, kernel_size, n_layers=3, g=None):
        """Dilated depth-separable stack (modules.py:81-129).
        x: (B, C, T); g broadcastable or None."""
        if g is not None:
            x = self.add(x, g)
        for i in range(n_layers):
            dil = kernel_size**i
            pad = (kernel_size * dil - dil) // 2
            y = self.conv(
                self.mul(x, xm), f"{prefix}.convs_sep.{i}",
                pads=(pad, pad), dilation=dil, group=self.sd[
                    f"{prefix}.convs_sep.{i}.weight"
                ].shape[0],
            )
            y = self.layer_norm(y, f"{prefix}.norms_1.{i}")
            y = self.gelu(y)
            y = self.conv(y, f"{prefix}.convs_1x1.{i}")
            y = self.layer_norm(y, f"{prefix}.norms_2.{i}")
            y = self.gelu(y)
            x = self.add(x, y)
        return self.mul(x, xm)

    def wn(self, x, prefix, xm, *, kernel_size, n_layers, hidden, g=None):
        """WaveNet gated-residual stack (modules.py:132-209).
        x: (B, H, T) pre-masked; g: (B, gin, 1) or None."""
        g_all = None
        if g is not None and self.has(f"{prefix}.cond_layer.weight"):
            g_all = self.conv(g, f"{prefix}.cond_layer")  # (B, 2H*n, 1)
        output = None
        for i in range(n_layers):
            pad = (kernel_size - 1) // 2
            x_in = self.conv(
                x, f"{prefix}.in_layers.{i}", pads=(pad, pad)
            )
            if g_all is not None:
                g_l = self.slice(
                    g_all, [i * 2 * hidden], [(i + 1) * 2 * hidden], [1]
                )
                x_in = self.add(x_in, g_l)
            t_half, s_half = self.b.node(
                "Split", [x_in, self.b.i64([hidden, hidden])], n_outputs=2,
                axis=1,
            )
            acts = self.mul(self.n("Tanh", t_half), self.n("Sigmoid", s_half))
            res_skip = self.conv(acts, f"{prefix}.res_skip_layers.{i}")
            if i < n_layers - 1:
                res, skip = self.b.node(
                    "Split", [res_skip, self.b.i64([hidden, hidden])],
                    n_outputs=2, axis=1,
                )
                x = self.mul(self.add(x, res), xm)
                output = skip if output is None else self.add(output, skip)
            else:
                output = (
                    res_skip if output is None else self.add(output, res_skip)
                )
        return self.mul(output, xm)

    def flip_channels(self, x):
        """Reverse the channel axis (modules.py:384-391)."""
        return self.slice(
            x, [-1], [-(1 << 62)], [1], [-1]
        )


def _emit_attention(
    e: _Emit, x: str, prefix: str, *, n_heads: int, channels: int,
    band_ctx: Dict[str, str], mask_cond: str,
) -> str:
    """Windowed rel-pos self-attention on (B, C, T).

    Band-form rel-pos (models/vits/encoder.py banded fast path): exactly
    equal to the reference's padded gather formulation."""
    b = e.b
    dk = channels // n_heads
    scale = 1.0 / math.sqrt(dk)
    kk = 2 * WINDOW + 1

    q = e.conv(x, f"{prefix}.conv_q")
    k = e.conv(x, f"{prefix}.conv_k")
    v = e.conv(x, f"{prefix}.conv_v")
    head_shape = e.concat(
        [band_ctx["sB"], b.i64([n_heads, dk]), b.i64([-1])], 0
    )
    q = e.reshape(q, head_shape)  # (B, H, dk, T)
    k = e.reshape(k, head_shape)
    v = e.reshape(v, head_shape)
    qt = e.mul(e.transpose(q, (0, 1, 3, 2)), e.cf(scale))  # (B, H, T, dk)

    scores = e.n("MatMul", qt, k)  # (B, H, T, T)

    # rel-pos K: logits against the 9-entry table, scattered onto the
    # band diagonals
    rel_k = e.transpose(e.sq(e.w(f"{prefix}.emb_rel_k"), [0]), (1, 0))
    rl = e.n("MatMul", qt, rel_k)  # (B, H, T, K)
    bhtt = e.concat(
        [band_ctx["sB"], b.i64([n_heads]), band_ctx["sT"], band_ctx["sT"]], 0
    )
    idxk = e.n("Expand", band_ctx["idxk"], bhtt)
    rel_abs = e.n("GatherElements", rl, idxk, axis=3)
    rel_abs = e.n("Where", band_ctx["validk"], rel_abs, e.cf(0.0))
    scores = e.add(scores, rel_abs)

    scores = e.n("Where", mask_cond, scores, e.cf(-1e4))
    p_attn = e.n("Softmax", scores, axis=-1)

    out = e.n("MatMul", p_attn, e.transpose(v, (0, 1, 3, 2)))  # (B,H,T,dk)

    # rel-pos V: band-extract attention weights, contract with table
    bhtk = e.concat(
        [band_ctx["sB"], b.i64([n_heads]), band_ctx["sT"], b.i64([kk])], 0
    )
    idx2 = e.n("Expand", band_ctx["idx2"], bhtk)
    bw = e.n("GatherElements", p_attn, idx2, axis=3)  # (B, H, T, K)
    bw = e.n("Where", band_ctx["valid2"], bw, e.cf(0.0))
    rel_v = e.sq(e.w(f"{prefix}.emb_rel_v"), [0])  # (K, dk)
    out = e.add(out, e.n("MatMul", bw, rel_v))

    out = e.transpose(out, (0, 1, 3, 2))  # (B, H, dk, T)
    merge_shape = e.concat([band_ctx["sB"], b.i64([channels, -1])], 0)
    out = e.reshape(out, merge_shape)
    return e.conv(out, f"{prefix}.conv_o")


def _emit_band_ctx(e: _Emit, sB: str, sT: str, r_t: str) -> Dict[str, str]:
    """Shared banded-attention index tensors for sequence length T."""
    b = e.b
    kk = 2 * WINDOW + 1
    ri = e.unsq(r_t, [0])  # (1, T) int64
    rj = e.unsq(r_t, [1])  # (T, 1)
    diff = e.sub(ri, rj)  # (T, T): j - i
    idxk = e.n("Clip", e.add(diff, e.ci(WINDOW)), e.ci(0), e.ci(kk - 1))
    validk = e.n(
        "And",
        e.n("GreaterOrEqual", diff, e.ci(-WINDOW)),
        e.n("LessOrEqual", diff, e.ci(WINDOW)),
    )
    t_scalar = e.sq(sT, [0])
    o_ids = e.n("Range", b.i64(0), b.i64(kk), b.i64(1))  # (K,)
    j2 = e.add(rj, e.sub(e.unsq(o_ids, [0]), e.ci(WINDOW)))  # (T, K)
    valid2 = e.n(
        "And",
        e.n("GreaterOrEqual", j2, e.ci(0)),
        e.n("Less", j2, t_scalar),
    )
    idx2 = e.n("Clip", j2, e.ci(0), e.sub(t_scalar, e.ci(1)))
    return {
        "sB": sB,
        "sT": sT,
        "idxk": e.unsq(idxk, [0, 1]),
        "validk": e.unsq(validk, [0, 1]),
        "idx2": e.unsq(idx2, [0, 1]),
        "valid2": e.unsq(valid2, [0, 1]),
    }


def _emit_spline_inverse(
    e: _Emit, x1: str, h_params: str, half: int, wh_scale: float = 1.0
) -> str:
    """Inverse rational-quadratic spline with linear tails
    (transforms.py:101-212). x1: (B, half, T); h_params:
    (B, half*(3K-1), T) conditioner output. Returns x1'.

    wh_scale is applied to the width/height blocks ONLY — the
    reference divides unnormalized_widths/heights by
    sqrt(filter_channels) but leaves unnormalized_derivatives
    unscaled (modules.py:506-510). Scaling all three blocks is
    invisible at random init (ConvFlow's proj is zero-init, h == 0)
    but wrong at trained weights."""
    b = e.b
    K = SDP_BINS
    # (B, half, 3K-1, T) -> (B, half, T, 3K-1)
    shp = e.concat(
        [e.n("Slice", e.n("Shape", x1), b.i64([0]), b.i64([1]), b.i64([0])),
         b.i64([half, 3 * K - 1, -1])], 0,
    )
    hp = e.transpose(e.reshape(h_params, shp), (0, 1, 3, 2))
    uw = e.slice(hp, [0], [K], [3])
    uh = e.slice(hp, [K], [2 * K], [3])
    ud = e.slice(hp, [2 * K], [3 * K - 1], [3])
    if wh_scale != 1.0:
        uw = e.mul(uw, e.cf(wh_scale))
        uh = e.mul(uh, e.cf(wh_scale))

    xin = e.unsq(x1, [3])  # (B, half, T, 1)
    inside = e.n(
        "And",
        e.n("GreaterOrEqual", xin, e.cf(-SDP_TAIL)),
        e.n("LessOrEqual", xin, e.cf(SDP_TAIL)),
    )
    xc = e.n("Clip", xin, e.cf(-SDP_TAIL), e.cf(SDP_TAIL))

    def cumulative(unnorm, min_size):
        wgt = e.n("Softmax", unnorm, axis=-1)
        wgt = e.add(
            e.cf(min_size), e.mul(e.cf(1.0 - min_size * K), wgt)
        )
        cs = e.n("CumSum", wgt, b.const(np.int64(3), "ax"))
        # scale into [-tail, tail]
        cs = e.add(e.mul(cs, e.cf(2 * SDP_TAIL)), e.cf(-SDP_TAIL))
        # first boundary = -tail exactly; last = +tail exactly
        zeros = e.add(e.mul(xc, e.cf(0.0)), e.cf(-SDP_TAIL))
        last = e.add(e.mul(xc, e.cf(0.0)), e.cf(SDP_TAIL))
        mid = e.slice(cs, [0], [K - 1], [3])
        cum = e.concat([zeros, mid, last], 3)  # (B, half, T, K+1)
        widths = e.sub(
            e.slice(cum, [1], [K + 1], [3]), e.slice(cum, [0], [K], [3])
        )
        return cum, widths

    cumw, widths = cumulative(uw, MIN_W)
    cumh, heights = cumulative(uh, MIN_H)

    const = math.log(math.exp(1.0 - MIN_D) - 1.0)
    pad_col = e.add(e.mul(xc, e.cf(0.0)), e.cf(const))
    ud_full = e.concat([pad_col, ud, pad_col], 3)  # (B, half, T, K+1)
    derivs = e.add(e.cf(MIN_D), e.softplus(ud_full))

    # searchsorted on cumheights (inverse): sum(x >= locs) - 1, with eps
    # added to the final boundary (transforms.py:44-47)
    eps_col = e.add(e.slice(cumh, [K], [K + 1], [3]), e.cf(1e-6))
    locs = e.concat([e.slice(cumh, [0], [K], [3]), eps_col], 3)
    ge = e.cast(e.n("GreaterOrEqual", xc, locs), INT64)
    idx = e.sub(e.n("ReduceSum", ge, b.i64([3]), keepdims=1), e.ci(1))
    idx = e.n("Clip", idx, e.ci(0), e.ci(K - 1))  # (B, half, T, 1)

    def take(t):
        return e.n("GatherElements", t, idx, axis=3)

    in_cumw = take(cumw)
    in_w = take(widths)
    in_cumh = take(cumh)
    delta = e.div(heights, widths)
    in_delta = take(delta)
    in_d = take(e.slice(derivs, [0], [K], [3]))
    in_d1 = take(e.slice(derivs, [1], [K + 1], [3]))
    in_h = take(heights)

    d_sum = e.sub(e.add(in_d, in_d1), e.mul(e.cf(2.0), in_delta))
    rel = e.sub(xc, in_cumh)
    a = e.add(
        e.mul(rel, d_sum), e.mul(in_h, e.sub(in_delta, in_d))
    )
    bq = e.sub(e.mul(in_h, in_d), e.mul(rel, d_sum))
    c = e.mul(e.mul(e.cf(-1.0), in_delta), rel)
    disc = e.sub(e.mul(bq, bq), e.mul(e.mul(e.cf(4.0), a), c))
    disc = e.n("Max", disc, e.cf(0.0))
    root = e.div(
        e.mul(e.cf(2.0), c),
        e.sub(e.mul(e.cf(-1.0), bq), e.n("Sqrt", disc)),
    )
    out = e.add(e.mul(root, in_w), in_cumw)
    out = e.n("Where", inside, out, xin)
    return e.sq(out, [3])  # (B, half, T)


def _emit_conv_flow_reverse(
    e: _Emit, z: str, prefix: str, g: str, xm: str, *, kernel_size: int,
    filter_channels: int,
) -> str:
    """ConvFlow reverse (modules.py:469-527): spline coupling on
    channel 1 of a (B, 2, T) tensor, conditioned on channel 0 + g."""
    x0 = e.slice(z, [0], [1], [1])
    x1 = e.slice(z, [1], [2], [1])
    h = e.conv(x0, f"{prefix}.pre")
    h = e.ddsconv(h, f"{prefix}.convs", xm, kernel_size=kernel_size, g=g)
    h = e.mul(e.conv(h, f"{prefix}.proj"), xm)
    x1n = _emit_spline_inverse(
        e, x1, h, 1, wh_scale=1.0 / math.sqrt(filter_channels)
    )
    return e.mul(e.concat([x0, x1n], 1), xm)


def export_onnx_voice(
    params: Dict[str, Any],
    cfg: ModelConfig,
    path: Optional[str] = None,
    *,
    doc: str = "",
) -> bytes:
    """Serialize the VITS inference graph + weights to ONNX bytes
    (writing to `path` when given). Reference-parity architecture only
    (HiFiGAN vocoder, no VITS2 extensions). `params` is a tree in the JAX
    package's layouts (numpy leaves or CPU tensors), as the port's
    loaders return it."""
    if cfg.vocoder != "hifigan":
        raise ValueError(
            f"ONNX export supports the reference architecture only "
            f"(vocoder={cfg.vocoder!r}); MB-iSTFT voices are native-only"
        )
    if cfg.flow_transformer or cfg.speaker_cond_encoder:
        raise ValueError(
            "ONNX export supports the reference architecture only "
            "(VITS2 extensions are native-only)"
        )
    sd = state_dict_from_params(params, cfg, inference_only=True)
    b = GraphBuilder("piper_tpu_vits")
    e = _Emit(b, sd)

    multi = cfg.num_speakers > 1
    b.add_input("input", INT64, ["B", "T"])
    b.add_input("input_lengths", INT64, ["B"])
    b.add_input("scales", FLOAT, [3])
    if multi:
        b.add_input("sid", INT64, ["B"])
    b.add_output("output", FLOAT, ["B", 1, None])

    noise_scale = e.sq(e.slice("scales", [0], [1], [0]), [0])
    length_scale = e.sq(e.slice("scales", [1], [2], [0]), [0])
    noise_w = e.sq(e.slice("scales", [2], [3], [0]), [0])

    shape_in = e.n("Shape", "input")
    sB = e.slice(shape_in, [0], [1], [0])
    sT = e.slice(shape_in, [1], [2], [0])
    t_scalar = e.sq(sT, [0])

    # masks
    r_t = e.n("Range", b.i64(0), t_scalar, b.i64(1))  # (T,) int64
    maskb = e.n(
        "Less", e.unsq(r_t, [0]), e.unsq("input_lengths", [1])
    )  # (B, T) bool
    maskf = e.cast(maskb, FLOAT)
    xm = e.unsq(maskf, [1])  # (B, 1, T)
    mask_cond = e.cast(
        e.mul(e.unsq(maskf, [1, 2]), e.unsq(maskf, [1, 3])), BOOL
    )  # (B, 1, T, T)

    # speaker embedding
    g = None
    if multi:
        ge = e.n("Gather", e.w("emb_g.weight"), "sid", axis=0)  # (B, gin)
        g = e.unsq(ge, [2])  # (B, gin, 1)

    # ---- text encoder (models.py:168-209) ----
    emb = e.n("Gather", e.w("enc_p.emb.weight"), "input", axis=0)  # (B,T,H)
    x = e.mul(
        e.transpose(emb, (0, 2, 1)), e.cf(math.sqrt(cfg.hidden_channels))
    )
    x = e.mul(x, xm)
    band_ctx = _emit_band_ctx(e, sB, sT, r_t)
    ks = cfg.kernel_size
    for i in range(cfg.n_layers):
        y = _emit_attention(
            e, x, f"enc_p.encoder.attn_layers.{i}", n_heads=cfg.n_heads,
            channels=cfg.hidden_channels, band_ctx=band_ctx,
            mask_cond=mask_cond,
        )
        x = e.layer_norm(e.add(x, y), f"enc_p.encoder.norm_layers_1.{i}")
        pad_l, pad_r = (ks - 1) // 2, ks // 2
        y = e.conv(
            e.mul(x, xm), f"enc_p.encoder.ffn_layers.{i}.conv_1",
            pads=(pad_l, pad_r),
        )
        y = e.n("Relu", y)
        y = e.conv(
            e.mul(y, xm), f"enc_p.encoder.ffn_layers.{i}.conv_2",
            pads=(pad_l, pad_r),
        )
        y = e.mul(y, xm)
        x = e.layer_norm(e.add(x, y), f"enc_p.encoder.norm_layers_2.{i}")
    x = e.mul(x, xm)
    stats = e.mul(e.conv(x, "enc_p.proj"), xm)
    m_p, logs_p = b.node(
        "Split", [stats, b.i64([cfg.inter_channels, cfg.inter_channels])],
        n_outputs=2, axis=1,
    )

    # ---- duration predictor ----
    if cfg.use_sdp:
        h = e.conv(x, "dp.pre")
        if g is not None and e.has("dp.cond.weight"):
            h = e.add(h, e.conv(g, "dp.cond"))
        h = e.ddsconv(h, "dp.convs", xm, kernel_size=ks)
        h = e.mul(e.conv(h, "dp.proj"), xm)
        noise = e.n(
            "RandomNormalLike", e.slice(x, [0], [2], [1]), dtype=FLOAT
        )
        z = e.mul(noise, noise_w)
        # reversed(flows)[:-2] + [last]: CF4, CF3, CF2, EA with a Flip
        # before each (models.py:109-110)
        for i in (3, 2, 1):
            z = e.flip_channels(z)
            z = _emit_conv_flow_reverse(
                e, z, f"dp.flows.{1 + 2 * i}", h, xm, kernel_size=ks,
                filter_channels=cfg.hidden_channels,
            )
        z = e.flip_channels(z)
        m_a = e.w("dp.flows.0.m")
        logs_a = e.w("dp.flows.0.logs")
        z = e.mul(
            e.mul(e.sub(z, m_a), e.n("Exp", e.n("Neg", logs_a))), xm
        )
        logw = e.slice(z, [0], [1], [1])
    else:
        h = x
        if g is not None and e.has("dp.cond.weight"):
            h = e.add(h, e.conv(g, "dp.cond"))
        pad = ks // 2
        h = e.conv(e.mul(h, xm), "dp.conv_1", pads=(pad, pad))
        h = e.layer_norm(e.n("Relu", h), "dp.norm_1")
        h = e.conv(e.mul(h, xm), "dp.conv_2", pads=(pad, pad))
        h = e.layer_norm(e.n("Relu", h), "dp.norm_2")
        logw = e.conv(e.mul(h, xm), "dp.proj")
        logw = e.mul(logw, xm)

    # ---- durations -> frame indices (models.py:702-716) ----
    w_dur = e.mul(e.mul(e.n("Exp", logw), xm), length_scale)
    dur = e.cast(e.sq(e.n("Ceil", w_dur), [1]), INT64)  # (B, T)
    cum = e.n("CumSum", dur, b.const(np.int64(1), "ax"))
    y_len = e.slice(cum, [-1], [1 << 62], [1])  # (B, 1)
    y_len = e.n("Max", y_len, e.ci(1))  # clamp_min(1), models.py:704
    t_y = e.n("ReduceMax", y_len, keepdims=0)  # () int64
    frames = e.n("Range", b.i64(0), t_y, b.i64(1))  # (Ty,)
    s_ty = e.n("Shape", frames)  # (1,)
    # p(t) = #{phonemes with cum <= t} (ops/duration.py — equivalent to
    # the reference's generate_path matmul)
    le = e.n(
        "LessOrEqual", e.unsq(cum, [1]), e.unsq(frames, [0, 2])
    )  # (B, Ty, T)
    idx = e.n("ReduceSum", e.cast(le, INT64), b.i64([2]), keepdims=0)
    idx = e.n("Min", idx, e.sub(t_scalar, e.ci(1)))  # (B, Ty)
    validy = e.n("Less", e.unsq(frames, [0]), y_len)  # (B, Ty) bool
    ym = e.unsq(e.cast(validy, FLOAT), [1])  # (B, 1, Ty)

    exp_shape = e.concat([sB, b.i64([cfg.inter_channels]), s_ty], 0)
    idx_e = e.n("Expand", e.unsq(idx, [1]), exp_shape)  # (B, C, Ty)
    mp_e = e.mul(e.n("GatherElements", m_p, idx_e, axis=2), ym)
    logs_e = e.mul(e.n("GatherElements", logs_p, idx_e, axis=2), ym)

    fnoise = e.n("RandomNormalLike", mp_e, dtype=FLOAT)
    z_p = e.add(
        mp_e, e.mul(e.mul(fnoise, e.n("Exp", logs_e)), noise_scale)
    )
    z_p = e.mul(z_p, ym)

    # ---- flow reverse (models.py:247-254) ----
    half = cfg.inter_channels // 2
    z = z_p
    for i in reversed(range(cfg.flow_n_flows)):
        z = e.flip_channels(z)
        name = f"flow.flows.{2 * i}"
        x0, x1 = b.node(
            "Split", [z, b.i64([half, half])], n_outputs=2, axis=1
        )
        hc = e.mul(e.conv(x0, f"{name}.pre"), ym)
        hc = e.wn(
            hc, f"{name}.enc", ym, kernel_size=cfg.flow_kernel_size,
            n_layers=cfg.flow_n_layers, hidden=cfg.hidden_channels, g=g,
        )
        m = e.mul(e.conv(hc, f"{name}.post"), ym)
        x1 = e.mul(e.sub(x1, m), ym)
        z = e.concat([x0, x1], 1)
    z = e.mul(z, ym)

    # ---- HiFiGAN generator (models.py:299-368) ----
    xg = e.conv(z, "dec.conv_pre", pads=(3, 3))
    if g is not None and e.has("dec.cond.weight"):
        xg = e.add(xg, e.conv(g, "dec.cond"))
    nk = len(cfg.resblock_kernel_sizes)
    for i, (u, kup) in enumerate(
        zip(cfg.upsample_rates, cfg.upsample_kernel_sizes)
    ):
        xg = e.leaky(xg, 0.1)
        xg = e.conv_t(xg, f"dec.ups.{i}", stride=u, pad=(kup - u) // 2)
        acc = None
        for j in range(nk):
            name = f"dec.resblocks.{i * nk + j}"
            rk = cfg.resblock_kernel_sizes[j]
            dils = cfg.resblock_dilation_sizes[j]
            hr = xg
            if cfg.resblock == "1":
                for m_i, d in enumerate(dils):
                    pad1 = (rk * d - d) // 2
                    yt = e.conv(
                        e.leaky(hr, 0.1), f"{name}.convs1.{m_i}",
                        pads=(pad1, pad1), dilation=d,
                    )
                    pad2 = (rk - 1) // 2
                    yt = e.conv(
                        e.leaky(yt, 0.1), f"{name}.convs2.{m_i}",
                        pads=(pad2, pad2),
                    )
                    hr = e.add(yt, hr)
            else:
                for m_i, d in enumerate(dils):
                    pad1 = (rk * d - d) // 2
                    yt = e.conv(
                        e.leaky(hr, 0.1), f"{name}.convs.{m_i}",
                        pads=(pad1, pad1), dilation=d,
                    )
                    hr = e.add(yt, hr)
            acc = hr if acc is None else e.add(acc, hr)
        xg = e.mul(acc, e.cf(1.0 / nk))
    xg = e.leaky(xg, 0.01)  # torch F.leaky_relu default (models.py:364)
    xg = e.conv(xg, "dec.conv_post", pads=(3, 3))
    wav = e.n("Tanh", xg)
    b.node("Identity", [wav], out=["output"])

    data = b.serialize(opset=15, doc=doc or "piper_tpu VITS export")
    if path is not None:
        with open(path, "wb") as fh:
            fh.write(data)
    return data
