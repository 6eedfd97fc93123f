"""Dependency-free ONNX serializer + graph builder.

Counterpart of piper_tpu/onnx_io/writer.py, the same code, so both
packages write the same bytes for the same GraphBuilder calls (the
producer name stays "piper_tpu": it names the file format's writer).

Encodes ModelProto/GraphProto/NodeProto/TensorProto/... directly in
protobuf wire format (the read-side twin lives in
weights/onnx_loader.py). Field numbers follow onnx.proto (IR v8).
"""

from __future__ import annotations

import struct
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

# numpy dtype -> TensorProto.DataType
DTYPE_CODES = {
    np.dtype(np.float32): 1,
    np.dtype(np.uint8): 2,
    np.dtype(np.int8): 3,
    np.dtype(np.int32): 6,
    np.dtype(np.int64): 7,
    np.dtype(np.bool_): 9,
    np.dtype(np.float16): 10,
    np.dtype(np.float64): 11,
}

FLOAT, INT64, INT32, BOOL = 1, 7, 6, 9


def _varint(v: int) -> bytes:
    out = bytearray()
    v &= (1 << 64) - 1  # two's complement for negative int64
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _tag(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _f_varint(field: int, v: int) -> bytes:
    return _tag(field, 0) + _varint(v)


def _f_bytes(field: int, v: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(v)) + v


def _f_str(field: int, v: str) -> bytes:
    return _f_bytes(field, v.encode("utf-8"))


def _f_float(field: int, v: float) -> bytes:
    return _tag(field, 5) + struct.pack("<f", v)


def encode_tensor(name: str, arr: np.ndarray) -> bytes:
    """TensorProto: dims=1, data_type=2, name=8, raw_data=9."""
    arr = np.ascontiguousarray(arr)
    if arr.dtype not in DTYPE_CODES:
        raise ValueError(f"unsupported dtype {arr.dtype}")
    out = b""
    for d in arr.shape:
        out += _f_varint(1, d)
    out += _f_varint(2, DTYPE_CODES[arr.dtype])
    if name:
        out += _f_str(8, name)
    out += _f_bytes(9, arr.tobytes())
    return out


def encode_attribute(name: str, value: Any) -> bytes:
    """AttributeProto: name=1, f=2, i=3, s=4, t=5, floats=7, ints=8,
    type=20 (FLOAT=1, INT=2, STRING=3, TENSOR=4, FLOATS=6, INTS=7)."""
    out = _f_str(1, name)
    if isinstance(value, bool):
        out += _f_varint(3, int(value)) + _f_varint(20, 2)
    elif isinstance(value, int):
        out += _f_varint(3, value) + _f_varint(20, 2)
    elif isinstance(value, float):
        out += _f_float(2, value) + _f_varint(20, 1)
    elif isinstance(value, str):
        out += _f_str(4, value) + _f_varint(20, 3)
    elif isinstance(value, np.ndarray):
        out += _f_bytes(5, encode_tensor("", value)) + _f_varint(20, 4)
    elif isinstance(value, (list, tuple)):
        if all(isinstance(v, (int, np.integer)) for v in value):
            for v in value:
                out += _f_varint(8, int(v))
            out += _f_varint(20, 7)
        elif all(isinstance(v, (float, np.floating)) for v in value):
            for v in value:
                out += _f_float(7, float(v))
            out += _f_varint(20, 6)
        else:
            raise ValueError(f"mixed attribute list {name}={value!r}")
    else:
        raise ValueError(f"unsupported attribute {name}={value!r}")
    return out


def encode_node(
    op_type: str,
    inputs: Sequence[str],
    outputs: Sequence[str],
    name: str = "",
    **attrs: Any,
) -> bytes:
    """NodeProto: input=1, output=2, name=3, op_type=4, attribute=5."""
    out = b""
    for i in inputs:
        out += _f_str(1, i)
    for o in outputs:
        out += _f_str(2, o)
    if name:
        out += _f_str(3, name)
    out += _f_str(4, op_type)
    for k, v in attrs.items():
        out += _f_bytes(5, encode_attribute(k, v))
    return out


DimT = Union[int, str, None]


def encode_value_info(name: str, elem_type: int, shape: Sequence[DimT]) -> bytes:
    """ValueInfoProto{name=1,type=2} / TypeProto{tensor_type=1} /
    Tensor{elem_type=1,shape=2} / Shape{dim=1} / Dim{value=1,param=2}."""
    dims = b""
    for d in shape:
        if isinstance(d, int):
            dim = _f_varint(1, d)
        elif isinstance(d, str):
            dim = _f_str(2, d)
        else:  # anonymous dynamic dim
            dim = _f_str(2, "?")
        dims += _f_bytes(1, dim)
    tensor = _f_varint(1, elem_type) + _f_bytes(2, dims)
    type_proto = _f_bytes(1, tensor)
    return _f_str(1, name) + _f_bytes(2, type_proto)


class GraphBuilder:
    """Accumulates nodes/initializers and serializes a ModelProto."""

    def __init__(self, name: str = "piper_tpu"):
        self.name = name
        self.nodes: List[bytes] = []
        self.initializers: Dict[str, np.ndarray] = {}
        self.inputs: List[Tuple[str, int, Sequence[DimT]]] = []
        self.outputs: List[Tuple[str, int, Sequence[DimT]]] = []
        self._counter = 0
        self._const_cache: Dict[Tuple, str] = {}

    # -- naming ------------------------------------------------------
    def fresh(self, hint: str = "t") -> str:
        self._counter += 1
        return f"{hint}_{self._counter}"

    # -- declarations ------------------------------------------------
    def add_input(self, name: str, elem_type: int, shape: Sequence[DimT]) -> str:
        self.inputs.append((name, elem_type, shape))
        return name

    def add_output(self, name: str, elem_type: int, shape: Sequence[DimT]) -> None:
        self.outputs.append((name, elem_type, shape))

    def init(self, name: str, arr: np.ndarray) -> str:
        """Named initializer (weights — module-tree names)."""
        self.initializers[name] = np.ascontiguousarray(arr)
        return name

    def const(self, arr: np.ndarray, hint: str = "c") -> str:
        """Anonymous constant initializer, deduplicated by value."""
        arr = np.ascontiguousarray(arr)
        key = (arr.dtype.str, arr.shape, arr.tobytes())
        if key in self._const_cache:
            return self._const_cache[key]
        name = f"const::{hint}_{len(self._const_cache)}"
        self.initializers[name] = arr
        self._const_cache[key] = name
        return name

    def i64(self, values, hint: str = "i64") -> str:
        return self.const(np.asarray(values, np.int64), hint)

    def f32(self, values, hint: str = "f32") -> str:
        return self.const(np.asarray(values, np.float32), hint)

    # -- nodes -------------------------------------------------------
    def node(
        self,
        op_type: str,
        inputs: Sequence[str],
        n_outputs: int = 1,
        out: Optional[Sequence[str]] = None,
        **attrs: Any,
    ):
        """Append a node; returns its output name (or tuple of names)."""
        if out is None:
            out = [self.fresh(op_type.lower()) for _ in range(n_outputs)]
        self.nodes.append(
            encode_node(op_type, inputs, out, name=self.fresh("n"), **attrs)
        )
        return out[0] if len(out) == 1 else tuple(out)

    # -- serialization -----------------------------------------------
    def serialize(
        self,
        *,
        opset: int = 15,
        ir_version: int = 8,
        producer: str = "piper_tpu",
        doc: str = "",
    ) -> bytes:
        graph = b""
        for nb in self.nodes:
            graph += _f_bytes(1, nb)
        graph += _f_str(2, self.name)
        for name, arr in self.initializers.items():
            graph += _f_bytes(5, encode_tensor(name, arr))
        if doc:
            graph += _f_str(10, doc)
        for name, et, shape in self.inputs:
            graph += _f_bytes(11, encode_value_info(name, et, shape))
        for name, et, shape in self.outputs:
            graph += _f_bytes(12, encode_value_info(name, et, shape))

        opset_id = _f_str(1, "") + _f_varint(2, opset)
        model = (
            _f_varint(1, ir_version)
            + _f_str(2, producer)
            + _f_str(3, "1.0")
            + _f_bytes(7, graph)
            + _f_bytes(8, opset_id)
        )
        return model
