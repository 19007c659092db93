"""Minimal ONNX weight reader (no `onnx` package needed).

Counterpart of cosyvoice_tpu/tools/onnx_reader.py, copied so that the port
imports nothing of the JAX package. The reference ships its speech
tokenizer and speaker-embedding models as ONNX graphs
(speech_tokenizer_v*.onnx, campplus.onnx); the port's
models/speech_tokenizer.py and models/campplus.py re-implement both, and
this module extracts the trained weights from those files for
tools/convert_checkpoint.py.

ONNX is protobuf; only GraphProto.initializer (the weight tensors) is read,
by a wire-format parser over numpy:

  ModelProto.graph = field 7 (message)
  GraphProto.initializer = field 5 (repeated TensorProto)
  TensorProto: dims=1 (repeated varint), data_type=2 (varint),
               name=8 (bytes), raw_data=9 (bytes),
               float_data=4 / int32_data=5 / int64_data=7 (packed)
"""

import struct
from typing import Dict, Tuple

import numpy as np

# TensorProto.DataType -> numpy dtype
_DTYPES = {
    1: np.float32, 2: np.uint8, 3: np.int8, 4: np.uint16, 5: np.int16,
    6: np.int32, 7: np.int64, 9: np.bool_, 10: np.float16, 11: np.float64,
    12: np.uint32, 13: np.uint64,
}


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _iter_fields(buf: bytes):
    """Yields (field_number, wire_type, value) over one message's bytes."""
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire == 0:  # varint
            val, pos = _read_varint(buf, pos)
        elif wire == 1:  # 64-bit
            val = buf[pos : pos + 8]
            pos += 8
        elif wire == 2:  # length-delimited
            ln, pos = _read_varint(buf, pos)
            val = buf[pos : pos + ln]
            pos += ln
        elif wire == 5:  # 32-bit
            val = buf[pos : pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, val


def _parse_tensor(buf: bytes) -> Tuple[str, np.ndarray]:
    dims = []
    dtype_code = 1
    name = ""
    raw = None
    f32, i32, i64, f64 = [], [], [], []
    for field, wire, val in _iter_fields(buf):
        if field == 1 and wire == 0:
            dims.append(val)
        elif field == 1 and wire == 2:  # packed dims
            p = 0
            while p < len(val):
                d, p = _read_varint(val, p)
                dims.append(d)
        elif field == 2:
            dtype_code = val
        elif field == 8:
            name = val.decode("utf-8")
        elif field == 9:
            raw = val
        elif field == 4 and wire == 2:
            f32.extend(struct.unpack(f"<{len(val) // 4}f", val))
        elif field == 4 and wire == 5:
            f32.append(struct.unpack("<f", val)[0])
        elif field == 5 and wire == 2:
            p = 0
            while p < len(val):
                d, p = _read_varint(val, p)
                i32.append(d)
        elif field == 5 and wire == 0:
            i32.append(val)
        elif field == 7 and wire == 2:
            p = 0
            while p < len(val):
                d, p = _read_varint(val, p)
                i64.append(d)
        elif field == 7 and wire == 0:
            i64.append(val)
        elif field == 10 and wire == 2:
            f64.extend(struct.unpack(f"<{len(val) // 8}d", val))
    dtype = _DTYPES.get(dtype_code, np.float32)
    if raw is not None:
        arr = np.frombuffer(raw, dtype=dtype)
    elif f32:
        arr = np.asarray(f32, np.float32)
    elif i64:
        arr = np.asarray(i64, np.int64)
    elif i32:
        arr = np.asarray(i32, np.int32)
    elif f64:
        arr = np.asarray(f64, np.float64)
    else:
        arr = np.zeros(0, dtype)
    return name, arr.reshape(dims) if dims else arr


def read_onnx_weights(path: str) -> Dict[str, np.ndarray]:
    """Returns {initializer_name: array} for an .onnx file."""
    with open(path, "rb") as f:
        model = f.read()
    graph = None
    for field, wire, val in _iter_fields(model):
        if field == 7 and wire == 2:  # ModelProto.graph
            graph = val
            break
    if graph is None:
        raise ValueError(f"{path}: no graph found (not an ONNX ModelProto?)")
    weights = {}
    for field, wire, val in _iter_fields(graph):
        if field == 5 and wire == 2:  # GraphProto.initializer
            name, arr = _parse_tensor(val)
            weights[name] = arr
    return weights
