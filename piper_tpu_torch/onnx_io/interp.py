"""Numpy interpreter for the ONNX op subset emitted by onnx_io.graph.

Counterpart of piper_tpu/onnx_io/interp.py, the same numpy code (the
protobuf readers come from weights/onnx_loader.py). With no
onnxruntime installed, this module is the offline executor that
validates exported voices end to end and runs the bundled Silero VAD
for preprocessing (train/norm_audio.py). Each op follows the ONNX operator spec (opset 15)
for the attribute combinations the exporter emits; unsupported
combinations raise rather than guess.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..weights.onnx_loader import _fields, _parse_tensor, _read_varint

_DTYPE_OF_CODE = {
    1: np.float32, 2: np.uint8, 3: np.int8, 6: np.int32, 7: np.int64,
    9: np.bool_, 10: np.float16, 11: np.float64,
}


def _signed(v: int) -> int:
    return v - (1 << 64) if v >= (1 << 63) else v


def _parse_attribute(buf: memoryview) -> Tuple[str, Any]:
    name = ""
    a_type = None
    f = i = s = t = g = None
    floats: List[float] = []
    ints: List[int] = []
    for field, wire, val in _fields(buf):
        if field == 1 and wire == 2:
            name = bytes(val).decode("utf-8")
        elif field == 2 and wire == 5:
            f = np.frombuffer(bytes(val), "<f4")[0]
        elif field == 3 and wire == 0:
            i = _signed(val)
        elif field == 4 and wire == 2:
            s = bytes(val).decode("utf-8")
        elif field == 5 and wire == 2:
            t = _parse_tensor(val)[1]
        elif field == 6 and wire == 2:
            g = _parse_graph(val)
        elif field == 7:
            if wire == 5:
                floats.append(float(np.frombuffer(bytes(val), "<f4")[0]))
            else:
                floats.extend(np.frombuffer(bytes(val), "<f4").tolist())
        elif field == 8:
            if wire == 0:
                ints.append(_signed(val))
            else:
                p = 0
                mv = memoryview(val)
                while p < len(mv):
                    v, p = _read_varint(mv, p)
                    ints.append(_signed(v))
        elif field == 20 and wire == 0:
            a_type = val
    if a_type == 1:
        return name, float(f)
    if a_type == 2:
        return name, int(i)
    if a_type == 3:
        return name, s
    if a_type == 4:
        return name, t
    if a_type == 5:
        return name, g
    if a_type == 6:
        return name, [float(x) for x in floats]
    if a_type == 7:
        return name, [int(x) for x in ints]
    # untyped (legacy): best-effort
    for v in (i, f, s, t, g):
        if v is not None:
            return name, v
    return name, ints or floats


class Subgraph:
    """Parsed GraphProto for subgraph attributes (If branches)."""

    def __init__(self):
        self.nodes: List[Tuple[str, List[str], List[str], Dict[str, Any]]] = []
        self.initializers: Dict[str, np.ndarray] = {}
        self.input_names: List[str] = []
        self.output_names: List[str] = []


def _parse_graph(buf: memoryview) -> "Subgraph":
    g = Subgraph()
    for gf, gw, gv in _fields(buf):
        if gf == 1 and gw == 2:
            g.nodes.append(_parse_node_full(gv))
        elif gf == 5 and gw == 2:
            name, arr = _parse_tensor(gv)
            g.initializers[name] = arr
        elif gf == 11 and gw == 2:
            g.input_names.append(_parse_value_info(gv))
        elif gf == 12 and gw == 2:
            g.output_names.append(_parse_value_info(gv))
    return g


def _parse_node_full(buf: memoryview):
    inputs: List[str] = []
    outputs: List[str] = []
    op_type = ""
    attrs: Dict[str, Any] = {}
    for field, wire, val in _fields(buf):
        if field == 1 and wire == 2:
            inputs.append(bytes(val).decode("utf-8"))
        elif field == 2 and wire == 2:
            outputs.append(bytes(val).decode("utf-8"))
        elif field == 4 and wire == 2:
            op_type = bytes(val).decode("utf-8")
        elif field == 5 and wire == 2:
            k, v = _parse_attribute(val)
            attrs[k] = v
    return op_type, inputs, outputs, attrs


def _parse_value_info(buf: memoryview) -> str:
    for field, wire, val in _fields(buf):
        if field == 1 and wire == 2:
            return bytes(val).decode("utf-8")
    return ""


class OnnxModel:
    """Parsed ONNX model: initializers, node list, graph IO names."""

    def __init__(self, path_or_bytes):
        if isinstance(path_or_bytes, (bytes, bytearray, memoryview)):
            data = bytes(path_or_bytes)
        else:
            with open(path_or_bytes, "rb") as fh:
                data = fh.read()
        self.initializers: Dict[str, np.ndarray] = {}
        self.nodes: List[Tuple[str, List[str], List[str], Dict[str, Any]]] = []
        self.input_names: List[str] = []
        self.output_names: List[str] = []
        for field, wire, val in _fields(memoryview(data)):
            if field == 7 and wire == 2:  # graph
                for gf, gw, gv in _fields(val):
                    if gf == 1 and gw == 2:
                        self.nodes.append(_parse_node_full(gv))
                    elif gf == 5 and gw == 2:
                        name, arr = _parse_tensor(gv)
                        self.initializers[name] = arr
                    elif gf == 11 and gw == 2:
                        self.input_names.append(_parse_value_info(gv))
                    elif gf == 12 and gw == 2:
                        self.output_names.append(_parse_value_info(gv))


def _conv1d(x, w, b, *, stride, pads, dilation, group):
    """x (B, C, T), w (M, C/g, k) -> (B, M, T_out)."""
    bsz, c, t = x.shape
    m, cg, k = w.shape
    p0, p1 = pads
    xp = np.pad(x, ((0, 0), (0, 0), (p0, p1)))
    span = (k - 1) * dilation + 1
    t_out = (xp.shape[2] - span) // stride + 1
    out = np.zeros((bsz, m, t_out), np.float32)
    mg = m // group
    # gather k tap views and contract channels per group
    for g in range(group):
        xg = xp[:, g * cg : (g + 1) * cg]  # (B, cg, Tp)
        wg = w[g * mg : (g + 1) * mg]  # (mg, cg, k)
        acc = np.zeros((bsz, mg, t_out), np.float32)
        for kk in range(k):
            start = kk * dilation
            seg = xg[:, :, start : start + (t_out - 1) * stride + 1 : stride]
            acc += np.einsum("mc,bct->bmt", wg[:, :, kk], seg)
        out[:, g * mg : (g + 1) * mg] = acc
    if b is not None:
        out += b[None, :, None]
    return out


def _conv_transpose1d(x, w, b, *, stride, pads):
    """x (B, C, T), w (C, M, k) -> (B, M, (T-1)*stride + k - pads_sum)."""
    bsz, c, t = x.shape
    _, m, k = w.shape
    full = (t - 1) * stride + k
    out = np.zeros((bsz, m, full), np.float32)
    contrib = np.einsum("cmk,bct->bmkt", w, x)
    for kk in range(k):
        out[:, :, kk : kk + (t - 1) * stride + 1 : stride] += contrib[:, :, kk]
    p0, p1 = pads
    out = out[:, :, p0 : full - p1]
    if b is not None:
        out += b[None, :, None]
    return out


def _slice(x, starts, ends, axes, steps):
    idx = [slice(None)] * x.ndim
    if axes is None:
        axes = list(range(len(starts)))
    if steps is None:
        steps = [1] * len(starts)
    for st, en, ax, sp in zip(starts, ends, axes, steps):
        ax = int(ax) % x.ndim
        st, en, sp = int(st), int(en), int(sp)
        # ONNX clamps INT64_MIN/MAX sentinels
        big = 1 << 62
        if en > big:
            en = None if sp > 0 else None
        elif en < -big:
            en = None
        idx[ax] = slice(st, en, sp)
    return x[tuple(idx)]


def _reduce(x, op, axes, keepdims):
    if axes is None:
        axes_t = None
    else:
        axes_t = tuple(int(a) % x.ndim for a in axes)
    return op(x, axis=axes_t, keepdims=bool(keepdims))


def _lstm(x, w, r, b, h0, c0):
    """ONNX LSTM, one forward layer with spec-default activations
    (sigmoid/tanh/tanh) and iofc gate order; no peepholes/clip.
    x (T,B,I), w (1,4H,I), r (1,4H,H), b (1,8H), h0/c0 (1,B,H)."""
    w2, r2 = w[0], r[0]
    hsz = r2.shape[1]
    if b is not None:
        bias = b[0][: 4 * hsz] + b[0][4 * hsz :]
    else:
        bias = np.zeros(4 * hsz, np.float32)
    h, c = h0[0], c0[0]

    def sig(v):
        return np.where(v >= 0, 1.0 / (1.0 + np.exp(-v)),
                        np.exp(v) / (1.0 + np.exp(v)))

    ys = []
    for t in range(x.shape[0]):
        gates = x[t] @ w2.T + h @ r2.T + bias
        i_g, o_g, f_g, c_g = np.split(gates, 4, axis=-1)
        c = sig(f_g) * c + sig(i_g) * np.tanh(c_g)
        h = sig(o_g) * np.tanh(c)
        ys.append(h)
    y = np.stack(ys)[:, None]  # (T, num_directions=1, B, H)
    return (y.astype(np.float32), h[None].astype(np.float32),
            c[None].astype(np.float32))


def run(
    model: OnnxModel,
    feeds: Dict[str, np.ndarray],
    *,
    rng: Optional[np.random.Generator] = None,
    outputs: Optional[Sequence[str]] = None,
) -> List[np.ndarray]:
    """Execute the graph; returns the requested (default: graph)
    outputs. `rng` drives RandomNormalLike (pass a fixed generator for
    reproducible runs)."""
    rng = rng or np.random.default_rng(0)
    env: Dict[str, np.ndarray] = {}
    env.update(model.initializers)
    for k, v in feeds.items():
        env[k] = np.asarray(v)
    _exec_nodes(model.nodes, env, rng)
    names = list(outputs) if outputs is not None else model.output_names
    return [env[n] for n in names]


def _exec_nodes(nodes, env: Dict[str, np.ndarray], rng) -> None:
    """Execute a node list against env (in place). Subgraphs (If
    branches) read the outer scope per the ONNX spec; their interior
    values stay in a child env."""
    for op, ins, outs, attrs in nodes:
        def I(j: int, default=None):  # noqa: E743
            if j >= len(ins) or ins[j] == "":
                return default
            return env[ins[j]]

        a = attrs.get
        if op in ("Add", "Sub", "Mul", "Div", "Pow", "Less", "Greater",
                  "LessOrEqual", "GreaterOrEqual", "Equal", "And", "Or"):
            x, y = I(0), I(1)
            r = {
                "Add": lambda: x + y,
                "Sub": lambda: x - y,
                "Mul": lambda: x * y,
                "Div": lambda: x / y if x.dtype.kind == "f" else x // y,
                "Pow": lambda: np.power(x, y),
                "Less": lambda: x < y,
                "Greater": lambda: x > y,
                "LessOrEqual": lambda: x <= y,
                "GreaterOrEqual": lambda: x >= y,
                "Equal": lambda: x == y,
                "And": lambda: x & y,
                "Or": lambda: x | y,
            }[op]()
        elif op == "MatMul":
            r = np.matmul(I(0), I(1))
            if I(0).dtype == np.float32:
                r = r.astype(np.float32)
        elif op == "Neg":
            r = -I(0)
        elif op == "Abs":
            r = np.abs(I(0))
        elif op == "Identity":
            r = I(0)
        elif op == "ReduceMax":
            r = _reduce(I(0), np.max, a("axes"), a("keepdims", 1))
        elif op == "Sqrt":
            r = np.sqrt(I(0))
        elif op == "Exp":
            r = np.exp(I(0))
        elif op == "Log":
            r = np.log(I(0))
        elif op == "Tanh":
            r = np.tanh(I(0))
        elif op == "Erf":
            from math import erf
            r = np.vectorize(erf, otypes=[np.float32])(I(0)).astype(I(0).dtype)
        elif op == "Sigmoid":
            x = I(0)
            r = np.where(x >= 0, 1.0 / (1.0 + np.exp(-x)),
                         np.exp(x) / (1.0 + np.exp(x))).astype(x.dtype)
        elif op == "Relu":
            r = np.maximum(I(0), 0)
        elif op == "LeakyRelu":
            alpha = a("alpha", 0.01)
            x = I(0)
            r = np.where(x >= 0, x, alpha * x).astype(x.dtype)
        elif op == "Softmax":
            x = I(0)
            ax = a("axis", -1)
            mx = np.max(x, axis=ax, keepdims=True)
            e = np.exp(x - mx)
            r = (e / np.sum(e, axis=ax, keepdims=True)).astype(x.dtype)
        elif op == "Ceil":
            r = np.ceil(I(0))
        elif op == "Floor":
            r = np.floor(I(0))
        elif op == "Clip":
            lo, hi = I(1), I(2)
            r = np.clip(I(0), lo, hi)
        elif op == "Min":
            r = np.minimum(I(0), I(1))
        elif op == "Max":
            r = np.maximum(I(0), I(1))
        elif op == "Not":
            r = ~I(0)
        elif op == "Where":
            r = np.where(I(0), I(1), I(2))
        elif op == "Cast":
            r = I(0).astype(_DTYPE_OF_CODE[a("to")])
        elif op == "Shape":
            r = np.asarray(I(0).shape, np.int64)
        elif op == "Gather":
            r = np.take(I(0), I(1).astype(np.int64), axis=a("axis", 0))
        elif op == "GatherElements":
            r = np.take_along_axis(
                I(0), I(1).astype(np.int64), axis=a("axis", 0)
            )
        elif op == "Slice":
            r = _slice(I(0), I(1), I(2), I(3), I(4))
        elif op == "Concat":
            r = np.concatenate([env[i] for i in ins], axis=a("axis"))
        elif op == "Reshape":
            shape = [int(s) for s in I(1)]
            x = I(0)
            shape = [
                x.shape[i] if s == 0 and a("allowzero", 0) == 0 else s
                for i, s in enumerate(shape)
            ]
            r = x.reshape(shape)
        elif op == "Transpose":
            r = np.transpose(I(0), a("perm"))
        elif op == "Expand":
            x, shp = I(0), [int(s) for s in I(1)]
            r = np.broadcast_to(
                x, np.broadcast_shapes(x.shape, tuple(shp))
            ).copy()
        elif op == "Unsqueeze":
            r = I(0)
            for ax in sorted(int(v) for v in I(1)):
                r = np.expand_dims(r, ax if ax >= 0 else ax + r.ndim + 1)
        elif op == "Squeeze":
            axes = sorted((int(v) % I(0).ndim for v in I(1)), reverse=True)
            r = I(0)
            for ax in axes:
                r = np.squeeze(r, axis=ax)
        elif op == "Range":
            s0, s1, s2 = (int(np.asarray(I(j)).reshape(-1)[0]) for j in (0, 1, 2))
            r = np.arange(s0, s1, s2, dtype=I(0).dtype)
        elif op == "ConstantOfShape":
            val = a("value")
            fill = val.reshape(-1)[0] if val is not None else np.float32(0)
            r = np.full([int(s) for s in I(0)], fill, dtype=fill.dtype)
        elif op == "Constant":
            r = a("value")
        elif op == "ReduceMean":
            r = _reduce(I(0), np.mean, a("axes"), a("keepdims", 1))
            r = r.astype(I(0).dtype)
        elif op == "ReduceSum":
            axes = I(1)
            r = _reduce(
                I(0), np.sum, None if axes is None else list(axes),
                a("keepdims", 1),
            ).astype(I(0).dtype)
        elif op == "CumSum":
            ax = int(np.asarray(I(1)).reshape(-1)[0])
            r = np.cumsum(I(0), axis=ax).astype(I(0).dtype)
        elif op == "Conv":
            w = I(1)
            if w.ndim != 3:
                raise NotImplementedError("only 1-D Conv supported")
            r = _conv1d(
                I(0).astype(np.float32), w.astype(np.float32),
                None if I(2) is None else I(2).astype(np.float32),
                stride=(a("strides") or [1])[0],
                pads=tuple(a("pads") or (0, 0)),
                dilation=(a("dilations") or [1])[0],
                group=a("group", 1),
            ).astype(I(0).dtype)
        elif op == "ConvTranspose":
            w = I(1)
            if w.ndim != 3:
                raise NotImplementedError("only 1-D ConvTranspose supported")
            r = _conv_transpose1d(
                I(0).astype(np.float32), w.astype(np.float32),
                None if I(2) is None else I(2).astype(np.float32),
                stride=(a("strides") or [1])[0],
                pads=tuple(a("pads") or (0, 0)),
            ).astype(I(0).dtype)
        elif op == "Pad":
            pads = [int(p) for p in I(1)]
            x = I(0)
            n = x.ndim
            cval = I(2)
            width = [(pads[i], pads[i + n]) for i in range(n)]
            mode = a("mode", "constant")
            if mode == "constant":
                r = np.pad(
                    x, width,
                    constant_values=0 if cval is None else float(cval),
                )
            else:
                r = np.pad(x, width, mode=mode)
        elif op == "Split":
            x = I(0)
            ax = a("axis", 0)
            if len(ins) > 1 and ins[1]:
                sizes = [int(s) for s in I(1)]
            else:
                sizes = [x.shape[ax] // len(outs)] * len(outs)
            pieces = np.split(x, np.cumsum(sizes)[:-1], axis=ax)
            for name, piece in zip(outs, pieces):
                env[name] = piece
            continue
        elif op == "RandomNormalLike":
            x = I(0)
            r = rng.standard_normal(x.shape).astype(
                _DTYPE_OF_CODE[a("dtype")] if a("dtype") else x.dtype
            )
            r = r * a("scale", 1.0) + a("mean", 0.0)
        elif op == "Softplus":
            x = I(0)
            r = (np.maximum(x, 0) + np.log1p(np.exp(-np.abs(x)))).astype(
                x.dtype
            )
        elif op == "NonZero":
            r = np.stack(np.nonzero(I(0))).astype(np.int64)
        elif op == "GatherND":
            data, idx = I(0), I(1).astype(np.int64)
            bd = a("batch_dims", 0)
            if bd == 0:
                r = data[tuple(np.moveaxis(idx, -1, 0))]
            else:
                bshape = data.shape[:bd]
                flat_d = data.reshape((-1,) + data.shape[bd:])
                flat_i = idx.reshape((-1,) + idx.shape[bd:])
                r = np.stack([
                    flat_d[j][tuple(np.moveaxis(flat_i[j], -1, 0))]
                    for j in range(flat_d.shape[0])
                ]).reshape(bshape + idx.shape[bd:-1] + data.shape[
                    bd + idx.shape[-1]:
                ])
        elif op == "ScatterND":
            data, idx, upd = I(0).copy(), I(1).astype(np.int64), I(2)
            if a("reduction", "none") != "none":
                raise NotImplementedError("ScatterND reduction")
            data[tuple(np.moveaxis(idx, -1, 0))] = upd
            r = data
        elif op == "GlobalAveragePool":
            x = I(0)
            r = np.mean(
                x, axis=tuple(range(2, x.ndim)), keepdims=True
            ).astype(x.dtype)
        elif op == "If":
            cond = bool(np.asarray(I(0)).reshape(-1)[0])
            sub = attrs["then_branch"] if cond else attrs["else_branch"]
            child = dict(env)
            child.update(sub.initializers)
            _exec_nodes(sub.nodes, child, rng)
            for name, oname in zip(outs, sub.output_names):
                env[name] = child[oname]
            continue
        elif op == "LSTM":
            if a("direction", "forward") != "forward":
                raise NotImplementedError("only forward LSTM supported")
            y, y_h, y_c = _lstm(
                I(0).astype(np.float32), I(1), I(2), I(3), I(5), I(6)
            )
            for name, val in zip(outs, (y, y_h, y_c)):
                if name:
                    env[name] = val
            continue
        else:
            raise NotImplementedError(f"op {op}")
        env[outs[0]] = np.asarray(r)
