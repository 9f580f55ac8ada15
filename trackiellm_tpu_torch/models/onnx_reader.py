"""Weights-only ONNX reader: graph initializers -> numpy state dict.

The port's copy of ``trackiellm_tpu/models/onnx_reader.py`` (pure Python
and numpy; ``models/loader.py`` reaches it for .onnx files).

Parity target: the reference loads published perception/audio models
directly from .onnx files through ONNX Runtime (reference:
src/ai_models/tk_model_loader.c:296 ``load_model_onnx``;
src/vision/tk_object_detector.c:83, tk_depth_midas.c:176,
src/sensors/tk_vad_silero.c:25, src/audio/tk_tts_piper.c:237). The
rebuild never executes foreign graphs — models are torch programs — but
it must be able to INGEST the published checkpoints. This module reads
the weight tensors (graph initializers) out of an .onnx protobuf with
no onnx/protobuf dependency (pure wire-format parsing), producing the
name->array state dict that models/convert.py's ``*_from_torch``-style
mappers consume.

ONNX wire facts used (onnx.proto3):
  ModelProto:  field 7 = GraphProto graph
  GraphProto:  field 5 = repeated TensorProto initializer
  TensorProto: 1=dims (repeated int64), 2=data_type (enum),
               8=name (string), 9=raw_data (bytes),
               4=float_data, 5=int32_data, 7=int64_data, 10=double_data
"""

from __future__ import annotations

import struct
from typing import Dict, Iterator, Tuple

import numpy as np

# TensorProto.DataType -> numpy dtype (the types real checkpoints use)
_DTYPES = {
    1: np.float32, 2: np.uint8, 3: np.int8, 4: np.uint16, 5: np.int16,
    6: np.int32, 7: np.int64, 9: np.bool_, 10: np.float16,
    11: np.float64, 12: np.uint32, 13: np.uint64,
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
        if shift > 70:
            raise ValueError("malformed varint")


def _iter_fields(buf: bytes) -> Iterator[Tuple[int, int, object]]:
    """Yield (field_number, wire_type, value) over a protobuf message.
    Length-delimited values are returned as memoryview slices."""
    pos = 0
    n = len(buf)
    while pos < n:
        key, pos = _read_varint(buf, pos)
        field, wire = key >> 3, key & 0x7
        if wire == 0:          # varint
            val, pos = _read_varint(buf, pos)
        elif wire == 1:        # 64-bit
            val = struct.unpack_from("<Q", buf, pos)[0]
            pos += 8
        elif wire == 2:        # length-delimited
            ln, pos = _read_varint(buf, pos)
            val = bytes(buf[pos:pos + ln])
            pos += ln
        elif wire == 5:        # 32-bit
            val = struct.unpack_from("<I", buf, pos)[0]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, val


def _parse_tensor(buf: bytes) -> Tuple[str, np.ndarray]:
    dims = []
    dtype_id = 1
    name = ""
    raw = None
    f32s = []
    i32s = []
    i64s = []
    f64s = []
    for field, wire, val in _iter_fields(buf):
        if field == 1:                       # dims
            if wire == 0:
                dims.append(val)
            else:                            # packed repeated
                p = 0
                while p < len(val):
                    v, p = _read_varint(val, p)
                    dims.append(v)
        elif field == 2:
            dtype_id = val
        elif field == 8:
            name = val.decode("utf-8", errors="replace")
        elif field == 9:
            raw = val
        elif field == 4:
            # Non-packed entries (wire 5) carry the raw 32-bit pattern.
            f32s.append(val if wire == 2 else struct.pack("<I", val))
        elif field == 5:
            i32s.append(val)
        elif field == 7:
            i64s.append(val)
        elif field == 10:
            f64s.append(val if wire == 2 else struct.pack("<Q", val))
    np_dtype = _DTYPES.get(dtype_id)
    if np_dtype is None:
        raise ValueError(f"initializer '{name}': unsupported data_type "
                         f"{dtype_id}")
    shape = tuple(dims)
    if raw is not None:
        arr = np.frombuffer(raw, dtype=np_dtype)
    elif f32s:
        arr = np.frombuffer(b"".join(f32s), dtype=np.float32)
    elif f64s:
        arr = np.frombuffer(b"".join(f64s), dtype=np.float64)
    elif i64s or i32s:
        vals = []
        for chunk in (i64s or i32s):
            if isinstance(chunk, int):
                vals.append(chunk)
            else:
                p = 0
                while p < len(chunk):
                    v, p = _read_varint(chunk, p)
                    vals.append(v)
        # Negative int32/int64 values are varint-encoded as their 64-bit
        # two's-complement pattern — sign-fold before building the array.
        vals = [v - (1 << 64) if v >= (1 << 63) else v for v in vals]
        arr = np.asarray(vals, dtype=np.int64).astype(np_dtype)
    else:
        arr = np.zeros(shape, np_dtype)
    return name, arr.reshape(shape).astype(np_dtype, copy=False)


def read_onnx_initializers(path: str) -> Dict[str, np.ndarray]:
    """Parse an .onnx file and return {initializer_name: array}.

    Only the weight payload is read — graph structure/ops are ignored
    (this framework re-expresses the architectures as torch programs and
    maps weights in by name via models/convert.py).
    """
    with open(path, "rb") as f:
        model = f.read()
    graph = None
    for field, wire, val in _iter_fields(model):
        if field == 7 and wire == 2:
            graph = val
            break
    if graph is None:
        raise ValueError(f"{path}: no GraphProto (field 7) — not an ONNX "
                         "model?")
    out: Dict[str, np.ndarray] = {}
    for field, wire, val in _iter_fields(graph):
        if field == 5 and wire == 2:         # initializer
            name, arr = _parse_tensor(val)
            out[name] = arr
    return out


# ---------------------------------------------------------------------------
# Test-support writer: build a minimal valid ONNX payload so the reader
# can be verified against synthetic checkpoints without the onnx pkg.
# ---------------------------------------------------------------------------

def _varint(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _field(num: int, wire: int, payload: bytes) -> bytes:
    key = _varint((num << 3) | wire)
    if wire == 2:
        return key + _varint(len(payload)) + payload
    return key + payload


_NP_TO_ID = {np.dtype(np.float32): 1, np.dtype(np.uint8): 2,
             np.dtype(np.int8): 3, np.dtype(np.int32): 6,
             np.dtype(np.int64): 7, np.dtype(np.float16): 10,
             np.dtype(np.float64): 11}


def write_onnx_initializers(path: str, tensors: Dict[str, np.ndarray],
                            ) -> None:
    """Write {name: array} as a minimal ModelProto containing only graph
    initializers (raw_data encoding) — enough for read_onnx_initializers
    and for synthetic-checkpoint converter tests."""
    inits = []
    for name, arr in tensors.items():
        arr = np.ascontiguousarray(arr)
        dtype_id = _NP_TO_ID[arr.dtype]
        t = b"".join([
            b"".join(_field(1, 0, _varint(int(d))) for d in arr.shape),
            _field(2, 0, _varint(dtype_id)),
            _field(8, 2, name.encode()),
            _field(9, 2, arr.tobytes()),
        ])
        inits.append(_field(5, 2, t))
    graph = b"".join(inits)
    model = _field(1, 0, _varint(8)) + _field(7, 2, graph)  # ir_version 8
    with open(path, "wb") as f:
        f.write(model)
