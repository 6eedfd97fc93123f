"""Minimal ONNX reader: initializer table -> parameter tree.

Counterpart of piper_tpu/weights/onnx_loader.py, numpy only. Released
Piper voices ship as torch.onnx exports (reference: export_onnx.py:88-101,
opset 15, weight norm folded for the generator). The graph is not
executed: only the initializers (named after the torch module tree) are
needed, to build the parameter tree through the same converter as the
checkpoint loader (weights/torch_loader.py). The tree holds numpy arrays
in the JAX package's layouts, so weights/bridge.py's params_from_jax
takes it unchanged.

No `onnx`/protobuf dependency: TensorProto/GraphProto/ModelProto are
decoded directly from the protobuf wire format (stable since ONNX IR
v3). Weight-norm'd modules that weren't folded before export (flow /
duration predictor WN layers) appear as separate weight_g/weight_v
initializers, which params_from_state_dict folds.
"""

from __future__ import annotations

import struct
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np

from ..config import ModelConfig

# ONNX TensorProto.DataType -> numpy
_DTYPES = {
    1: np.float32,
    2: np.uint8,
    3: np.int8,
    4: np.uint16,
    5: np.int16,
    6: np.int32,
    7: np.int64,
    9: np.bool_,
    10: np.float16,
    11: np.float64,
    12: np.uint32,
    13: np.uint64,
}


def _read_varint(buf: memoryview, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not (b & 0x80):
            return result, pos
        shift += 7


def _fields(buf: memoryview) -> Iterator[Tuple[int, int, Any]]:
    """Iterate (field_number, wire_type, value) over a message buffer."""
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire == 0:  # varint
            val, pos = _read_varint(buf, pos)
        elif wire == 1:  # fixed64
            val = buf[pos : pos + 8]
            pos += 8
        elif wire == 2:  # length-delimited
            ln, pos = _read_varint(buf, pos)
            val = buf[pos : pos + ln]
            pos += ln
        elif wire == 5:  # fixed32
            val = buf[pos : pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, val


def _parse_tensor(buf: memoryview) -> Tuple[str, np.ndarray]:
    """TensorProto: dims=1, data_type=2, name=8, raw_data=9,
    float_data=4, int64_data=7, int32_data=5, double_data=10."""
    dims: List[int] = []
    data_type = 1
    name = ""
    raw: Optional[bytes] = None
    floats: List[float] = []
    int64s: List[int] = []
    int32s: List[int] = []
    for field, wire, val in _fields(buf):
        if field == 1:
            if wire == 0:
                dims.append(val)
            else:  # packed
                p = 0
                mv = memoryview(val)
                while p < len(mv):
                    v, p = _read_varint(mv, p)
                    dims.append(v)
        elif field == 2 and wire == 0:
            data_type = val
        elif field == 8 and wire == 2:
            name = bytes(val).decode("utf-8")
        elif field == 9 and wire == 2:
            raw = bytes(val)
        elif field == 4:
            if wire == 5:
                floats.append(struct.unpack("<f", bytes(val))[0])
            else:
                floats.extend(np.frombuffer(bytes(val), "<f4").tolist())
        elif field == 7:
            if wire == 0:
                int64s.append(val)
            else:
                p = 0
                mv = memoryview(val)
                while p < len(mv):
                    v, p = _read_varint(mv, p)
                    int64s.append(v)
        elif field == 5:
            if wire == 0:
                int32s.append(val)
            else:
                p = 0
                mv = memoryview(val)
                while p < len(mv):
                    v, p = _read_varint(mv, p)
                    int32s.append(v)
    dtype = _DTYPES.get(data_type, np.float32)
    if raw is not None:
        arr = np.frombuffer(raw, dtype=dtype)
    elif floats:
        arr = np.asarray(floats, np.float32)
    elif int64s:
        arr = np.asarray(int64s, np.int64)
    elif int32s:
        arr = np.asarray(int32s, np.int32)
    else:
        arr = np.zeros(0, dtype)
    # Empty dims on a one-element tensor is a true ONNX scalar (rank 0);
    # rank matters for ops like Gather/Unsqueeze in the interpreter.
    return name, arr.reshape(dims) if (dims or arr.size == 1) else arr


def _parse_node(buf: memoryview) -> Tuple[List[str], List[str], str]:
    """NodeProto: input=1, output=2 (repeated string), op_type=4."""
    inputs: List[str] = []
    outputs: List[str] = []
    op_type = ""
    for field, wire, val in _fields(buf):
        if field == 1 and wire == 2:
            inputs.append(bytes(val).decode("utf-8"))
        elif field == 2 and wire == 2:
            outputs.append(bytes(val).decode("utf-8"))
        elif field == 4 and wire == 2:
            op_type = bytes(val).decode("utf-8")
    return inputs, outputs, op_type


def read_onnx_initializers(
    path: str, *, with_nodes: bool = False
):
    """Parse a .onnx file -> {initializer_name: array} (and optionally
    the [(inputs, op_type)] node list)."""
    with open(path, "rb") as f:
        data = f.read()
    model = memoryview(data)
    init: Dict[str, np.ndarray] = {}
    nodes: List[Tuple[List[str], str]] = []
    for field, wire, val in _fields(model):  # ModelProto
        if field == 7 and wire == 2:  # graph: GraphProto
            for gfield, gwire, gval in _fields(val):
                if gfield == 5 and gwire == 2:  # initializer: TensorProto
                    name, arr = _parse_tensor(gval)
                    init[name] = arr
                elif with_nodes and gfield == 1 and gwire == 2:  # node
                    nodes.append(_parse_node(gval))
    if with_nodes:
        return init, nodes
    return init


def _recover_folded_names(
    init: Dict[str, np.ndarray], nodes: List[Tuple[List[str], List[str], str]]
) -> Dict[str, np.ndarray]:
    """Rename constant-folded weight-norm weights back to module paths.

    torch.onnx constant-folds weight_g*weight_v/||v|| into anonymous
    'onnx::Conv_N' initializers, but the Conv node still carries the
    module-named bias: Conv(X, onnx::Conv_N, <module>.bias) — so the
    weight's module path is recoverable from its sibling bias input.

    Also recovers ElementwiseAffine logs (SDP flows[0]) which folds to
    an exp(-logs) constant feeding the Mul after Sub(z, dp.flows.0.m)
    (modules.py:408); when logs == 0 the Mul is elided entirely and we
    default to zeros.
    """
    out = dict(init)
    for inputs, _outputs, op_type in nodes:
        if op_type not in ("Conv", "ConvTranspose") or len(inputs) < 3:
            continue
        w, b = inputs[1], inputs[2]
        if w in init and w.startswith("onnx::") and b.endswith(".bias"):
            prefix = b[: -len(".bias")]
            if "." in prefix:
                out[prefix + ".weight"] = init[w]
                out.pop(w, None)

    # ElementwiseAffine reverse: Sub(z, m) -> Mul(sub, Exp(-logs)).
    # torch folds -logs into an anonymous initializer feeding an Exp
    # node (or, depending on version, folds Exp(-logs) fully).
    producers = {o: (ins, op) for ins, outs, op in nodes for o in outs}
    for ea_m in [k for k in init if k.endswith(".m") and ".flows." in k]:
        prefix = ea_m[:-2]
        if prefix + ".logs" in out:
            continue
        sub_outs = {
            o for ins, outs, op in nodes
            if op == "Sub" and len(ins) == 2 and ins[1] == ea_m
            for o in outs
        }
        logs: Optional[np.ndarray] = None
        for ins, outs, op in nodes:
            if op != "Mul" or not any(i in sub_outs for i in ins):
                continue
            for other in (i for i in ins if i not in sub_outs):
                if other in init and init[other].shape == init[ea_m].shape:
                    # fully folded exp(-logs) constant
                    with np.errstate(divide="ignore"):
                        logs = -np.log(
                            init[other].astype(np.float64)
                        ).astype(np.float32)
                elif other in producers and producers[other][1] == "Exp":
                    exp_in = producers[other][0][0]
                    if exp_in in init:
                        # initializer holds -logs directly
                        logs = -np.asarray(init[exp_in], np.float32)
            if logs is not None:
                break
        out[prefix + ".logs"] = (
            logs if logs is not None else np.zeros_like(init[ea_m])
        )
    return out


def _synthesize_pruned_sdp_flow(sd: Dict[str, np.ndarray]) -> None:
    """The reverse path drops one ConvFlow (models.py:110), so exports
    omit dp.flows.1.*; fill it with zeros shaped like dp.flows.3.* so
    the pytree structure stays uniform (it is never evaluated at
    inference)."""
    if not any(k.startswith("dp.flows.3.") for k in sd):
        return
    for k in [k for k in list(sd) if k.startswith("dp.flows.3.")]:
        missing = "dp.flows.1." + k[len("dp.flows.3."):]
        if missing not in sd:
            sd[missing] = np.zeros_like(sd[k])


def load_onnx_voice(
    path: str, model_cfg: Optional[ModelConfig] = None
) -> Tuple[Dict[str, Any], ModelConfig]:
    """Load an exported Piper ONNX voice into a parameter tree.

    Requires initializers named after the torch module tree (true for
    reference export_onnx.py exports). Derives architecture dims from
    the tensors when model_cfg is None or inconsistent.
    """
    from .torch_loader import params_from_state_dict

    init, nodes = read_onnx_initializers(path, with_nodes=True)
    init = _recover_folded_names(init, nodes)
    # Drop remaining synthetic constants (shapes, scale vectors, ...).
    sd = {k: v for k, v in init.items() if "." in k and not k.startswith("onnx::")}
    _synthesize_pruned_sdp_flow(sd)
    if not any(k.startswith("enc_p.") for k in sd):
        raise ValueError(
            f"{path}: initializers are not module-named "
            "(unsupported exporter); found e.g. "
            + ", ".join(list(init)[:5])
        )
    cfg = _derive_config(sd, model_cfg)
    params = params_from_state_dict(sd, cfg)
    return params, cfg


def _derive_config(
    sd: Dict[str, np.ndarray], base: Optional[ModelConfig]
) -> ModelConfig:
    """Infer architecture hyperparameters from tensor shapes."""
    import dataclasses

    emb = sd["enc_p.emb.weight"]
    num_symbols, hidden = emb.shape
    inter2 = sd["enc_p.proj.weight"].shape[0]
    inter = inter2 // 2
    filter_channels = sd["enc_p.encoder.ffn_layers.0.conv_1.weight"].shape[0]
    n_layers = max(
        int(k.split(".")[3]) + 1
        for k in sd
        if k.startswith("enc_p.encoder.attn_layers.")
    ) if any(k.startswith("enc_p.encoder.attn_layers.") for k in sd) else 6
    # generator dims
    uic = sd["dec.conv_pre.weight"].shape[0]
    n_ups = len(
        {k.split(".")[2] for k in sd if k.startswith("dec.ups.")}
    )
    up_kernels = []
    up_in = []
    for i in range(n_ups):
        wkey = f"dec.ups.{i}.weight"
        if wkey not in sd:
            wkey = f"dec.ups.{i}.weight_v"
        w = sd[wkey]
        up_kernels.append(w.shape[2])
        up_in.append(w.shape[0])
    n_resblocks = len({k.split(".")[2] for k in sd if k.startswith("dec.resblocks.")})
    num_kernels = n_resblocks // n_ups
    resblock = "1" if any(
        k.startswith("dec.resblocks.0.convs1.") for k in sd
    ) else "2"
    # kernel sizes / dilations from conv shapes can't recover dilation;
    # use the quality presets keyed by resblock type + channels.
    gin = 0
    if "emb_g.weight" in sd:
        gin = sd["emb_g.weight"].shape[1]
    n_speakers = sd["emb_g.weight"].shape[0] if "emb_g.weight" in sd else 1
    use_sdp = any(k.startswith("dp.flows.") for k in sd)

    if base is not None:
        cand = base
    elif resblock == "1":
        cand = ModelConfig.for_quality("high", num_symbols=num_symbols)
    elif hidden <= 96:
        cand = ModelConfig.for_quality("x-low", num_symbols=num_symbols)
    else:
        cand = ModelConfig.for_quality("medium", num_symbols=num_symbols)

    # upsample rates: derive from kernel sizes (reference uses k = 2u
    # except final high-quality stages where k == 2u as well; fall back
    # to preset when consistent)
    preset_ok = (
        tuple(up_kernels) == tuple(cand.upsample_kernel_sizes)
        and uic == cand.upsample_initial_channel
        and resblock == cand.resblock
    )
    rates = cand.upsample_rates if preset_ok else tuple(k // 2 for k in up_kernels)
    return dataclasses.replace(
        cand,
        num_symbols=num_symbols,
        num_speakers=n_speakers,
        hidden_channels=hidden,
        inter_channels=inter,
        filter_channels=filter_channels,
        n_layers=n_layers,
        upsample_initial_channel=uic,
        upsample_kernel_sizes=tuple(up_kernels),
        upsample_rates=tuple(rates),
        resblock=resblock,
        gin_channels=gin,
        use_sdp=use_sdp,
    )
