"""Model loader: format sniffing, metadata extraction, checkpoint
reading into numpy arrays, and a slotted model cache.

The port's copy of ``trackiellm_tpu/models/loader.py`` (numpy only): the
same readers, dequantizers and cache, importing the port's
``utils.errors`` and ``utils.logging``, so the port reads model files
without the JAX package. ``models/convert.py`` turns what it reads into
torch params.

Parity target: ``tk_model_loader`` (reference: src/ai_models/
tk_model_loader.c): format detection by magic/extension — GGUF / ONNX /
TFLite (:557-603), per-format loading (:199-394), metadata extraction
(:780-868), model cache with slots + eviction (:918-1430, plus
tk_memory_manager.h's memory-pressure eviction), validate / preload
entry points (:1188-1355).

Design: models are parameter trees, so "loading" means parsing a
checkpoint container into numpy arrays. The GGUF reader is complete
and self-contained (header, kv metadata, tensor directory, F32/F16/
Q8_0/Q4_0/Q4_1/Q5_0/Q5_1/Q2_K..Q6_K/IQ4_NL/IQ4_XS tensor data (the
full set published llama.cpp releases ship, incl. the Q4_K_M / Q5_K_M /
Q3_K_M / Q2_K mixes) with dequantization or native requantization into
:class:`trackiellm_tpu_torch.ops.quant.QuantizedLinear` layout) — no llama.cpp.
safetensors and npz load natively; ONNX/TFLite are detected and reported
with a conversion hint (their graphs are not executed at runtime by
design — the architectures are reimplemented in models/).
"""

from __future__ import annotations

import dataclasses
import enum
import json
import struct
import threading
import time
from collections import OrderedDict
from typing import Any, BinaryIO, Dict, List, Optional, Tuple

import numpy as np

from trackiellm_tpu_torch.utils.errors import ErrorCode, TrackieError
from trackiellm_tpu_torch.utils.logging import get_logger

log = get_logger("models.loader")


class ModelFormat(enum.Enum):
    NATIVE = "native"          # this framework's checkpoint directory
    GGUF = "gguf"
    GGML = "ggml"              # whisper.cpp container (models/ggml_reader)
    SAFETENSORS = "safetensors"
    NPZ = "npz"
    ONNX = "onnx"
    TFLITE = "tflite"
    ORBAX = "orbax"
    UNKNOWN = "unknown"


def detect_format(path: str) -> ModelFormat:
    """Magic-first format sniffing (parity: tk_model_loader.c:557-603)."""
    import os

    if os.path.isdir(path):
        try:
            entries = set(os.listdir(path))
        except OSError:
            return ModelFormat.UNKNOWN
        if "checkpoint" in entries or "_METADATA" in entries or any(
                e.startswith("ocdbt") for e in entries):
            return ModelFormat.ORBAX
        if "arrays.npz" in entries and "tree.json" in entries:
            return ModelFormat.NATIVE  # models/checkpoint.py layout
        return ModelFormat.UNKNOWN
    try:
        with open(path, "rb") as f:
            head = f.read(16)
    except OSError as e:
        raise TrackieError(ErrorCode.FILE_NOT_FOUND, f"{path}: {e}") from e
    if head[:4] == b"GGUF":
        return ModelFormat.GGUF
    if head[:4] == b"lmgg":  # 0x67676d6c LE — whisper.cpp GGML
        return ModelFormat.GGML
    if head[4:8] == b"TFL3":
        return ModelFormat.TFLITE
    if head[:2] == b"PK":
        return ModelFormat.NPZ
    if len(head) >= 9:
        # safetensors: u64 LE header length then '{'.
        (hlen,) = struct.unpack("<Q", head[:8])
        if 0 < hlen < (1 << 32) and head[8:9] == b"{":
            return ModelFormat.SAFETENSORS
    if head[:1] == b"\x08" or path.endswith(".onnx"):
        return ModelFormat.ONNX
    return ModelFormat.UNKNOWN


# ---------------------------------------------------------------------------
# GGUF reader (v2/v3)
# ---------------------------------------------------------------------------

_GGUF_SCALAR_FMT = {
    0: ("<B", 1), 1: ("<b", 1), 2: ("<H", 2), 3: ("<h", 2),
    4: ("<I", 4), 5: ("<i", 4), 6: ("<f", 4), 7: ("<?", 1),
    10: ("<Q", 8), 11: ("<q", 8), 12: ("<d", 8),
}
_GGUF_STRING = 8
_GGUF_ARRAY = 9

# ggml tensor types we materialize (id -> name).
GGML_F32, GGML_F16, GGML_Q4_0, GGML_Q8_0 = 0, 1, 2, 8
# The rest of the llama.cpp quant zoo that published checkpoints
# actually ship (Q4_K_M files mix Q4_K + Q6_K tensors; Q5_K_M mixes
# Q5_K + Q6_K; Q3_K_M mixes Q3_K/Q4_K/Q5_K; Q2_K mixes Q2_K + Q3_K).
# Layouts per ggml-quants.c; ids per ggml.h.
GGML_Q4_1, GGML_Q5_0, GGML_Q5_1 = 3, 6, 7
GGML_Q2_K, GGML_Q3_K = 10, 11
GGML_Q4_K, GGML_Q5_K, GGML_Q6_K = 12, 13, 14
# I-quants (ggml.h): the 4-bit codebook pair ships widely as IQ4_XS /
# IQ4_NL mixes; the sub-4-bit grid codebooks (IQ1/IQ2/IQ3) do not map
# to this framework's kernels and stay unsupported.
GGML_IQ4_NL, GGML_IQ4_XS = 20, 23
# MXFP4 (ggml.h id 39; gpt-oss checkpoints ship in it): 32-element
# blocks of one e8m0 shared scale byte + 16 packed e2m1 nibbles
# (OCP Microscaling spec).
GGML_MXFP4 = 39


@dataclasses.dataclass
class GGUFTensorInfo:
    name: str
    shape: Tuple[int, ...]
    ggml_type: int
    offset: int


@dataclasses.dataclass
class GGUFFile:
    version: int
    metadata: Dict[str, Any]
    tensors: Dict[str, GGUFTensorInfo]
    data_start: int
    path: str

    @property
    def architecture(self) -> Optional[str]:
        return self.metadata.get("general.architecture")

    @property
    def name(self) -> Optional[str]:
        return self.metadata.get("general.name")


def _read_gguf_string(f: BinaryIO) -> str:
    (n,) = struct.unpack("<Q", f.read(8))
    return f.read(n).decode("utf-8", errors="replace")


def _read_gguf_value(f: BinaryIO, vtype: int) -> Any:
    if vtype in _GGUF_SCALAR_FMT:
        fmt, size = _GGUF_SCALAR_FMT[vtype]
        return struct.unpack(fmt, f.read(size))[0]
    if vtype == _GGUF_STRING:
        return _read_gguf_string(f)
    if vtype == _GGUF_ARRAY:
        (etype,) = struct.unpack("<I", f.read(4))
        (count,) = struct.unpack("<Q", f.read(8))
        return [_read_gguf_value(f, etype) for _ in range(count)]
    raise TrackieError(ErrorCode.MODEL_METADATA_INVALID,
                       f"unknown GGUF kv type {vtype}")


def read_gguf_header(path: str) -> GGUFFile:
    """Parse the GGUF header: metadata kv store + tensor directory
    (parity: the loader's metadata extraction, tk_model_loader.c:780-868)."""
    with open(path, "rb") as f:
        magic = f.read(4)
        if magic != b"GGUF":
            raise TrackieError(ErrorCode.MODEL_FORMAT_UNKNOWN,
                               f"{path}: not a GGUF file")
        (version,) = struct.unpack("<I", f.read(4))
        if version < 2:
            raise TrackieError(ErrorCode.MODEL_FORMAT_UNKNOWN,
                               f"GGUF v{version} unsupported (need >= 2)")
        n_tensors, n_kv = struct.unpack("<QQ", f.read(16))

        metadata: Dict[str, Any] = {}
        for _ in range(n_kv):
            key = _read_gguf_string(f)
            (vtype,) = struct.unpack("<I", f.read(4))
            metadata[key] = _read_gguf_value(f, vtype)

        tensors: Dict[str, GGUFTensorInfo] = {}
        for _ in range(n_tensors):
            name = _read_gguf_string(f)
            (n_dims,) = struct.unpack("<I", f.read(4))
            dims = struct.unpack(f"<{n_dims}Q", f.read(8 * n_dims))
            ggml_type, = struct.unpack("<I", f.read(4))
            offset, = struct.unpack("<Q", f.read(8))
            # GGUF dims are innermost-first; numpy wants outermost-first.
            tensors[name] = GGUFTensorInfo(name, tuple(reversed(dims)),
                                           ggml_type, offset)

        align = int(metadata.get("general.alignment", 32))
        pos = f.tell()
        data_start = (pos + align - 1) // align * align
        return GGUFFile(version, metadata, tensors, data_start, path)


def _dequant_q8_0(raw: np.ndarray, n_elems: int) -> np.ndarray:
    """GGUF Q8_0: 34-byte blocks = f16 scale + 32 int8 values."""
    blocks = raw.reshape(-1, 34)
    scales = blocks[:, :2].copy().view(np.float16).astype(np.float32)
    values = blocks[:, 2:].copy().view(np.int8).astype(np.float32)
    return (values * scales).reshape(-1)[:n_elems]


def _dequant_q4_0(raw: np.ndarray, n_elems: int) -> np.ndarray:
    """GGUF Q4_0: 18-byte blocks = f16 scale + 16 packed bytes; byte j
    holds elements j (low nibble) and j+16 (high nibble), biased by 8."""
    blocks = raw.reshape(-1, 18)
    scales = blocks[:, :2].copy().view(np.float16).astype(np.float32)
    packed = blocks[:, 2:]
    lo = (packed & 0xF).astype(np.int8) - 8
    hi = (packed >> 4).astype(np.int8) - 8
    vals = np.concatenate([lo, hi], axis=1).astype(np.float32)  # (B, 32)
    return (vals * scales).reshape(-1)[:n_elems]


def _dequant_q4_1(raw: np.ndarray, n_elems: int) -> np.ndarray:
    """GGUF Q4_1: 20-byte blocks = f16 d + f16 m + 16 packed bytes;
    x = d*q + m with unsigned nibbles, element order as Q4_0."""
    blocks = raw.reshape(-1, 20)
    d = blocks[:, 0:2].copy().view(np.float16).astype(np.float32)
    m = blocks[:, 2:4].copy().view(np.float16).astype(np.float32)
    packed = blocks[:, 4:]
    q = np.concatenate([packed & 0xF, packed >> 4], axis=1)
    return (q.astype(np.float32) * d + m).reshape(-1)[:n_elems]


def _dequant_q5_0(raw: np.ndarray, n_elems: int) -> np.ndarray:
    """GGUF Q5_0: 22-byte blocks = f16 d + u32 qh + 16 packed bytes;
    element j's 5th bit is qh bit j, value biased by 16."""
    blocks = raw.reshape(-1, 22)
    d = blocks[:, 0:2].copy().view(np.float16).astype(np.float32)
    qh = blocks[:, 2:6].copy().view(np.uint32)          # (B, 1)
    qs = blocks[:, 6:]
    j = np.arange(16, dtype=np.uint32)
    hi0 = (((qh >> j) & 1) << 4).astype(np.uint8)       # elements 0-15
    hi1 = (((qh >> (j + 16)) & 1) << 4).astype(np.uint8)  # 16-31
    q = np.concatenate([(qs & 0xF) | hi0, (qs >> 4) | hi1],
                       axis=1).astype(np.float32) - 16.0
    return (q * d).reshape(-1)[:n_elems]


def _dequant_q5_1(raw: np.ndarray, n_elems: int) -> np.ndarray:
    """GGUF Q5_1: 24-byte blocks = f16 d + f16 m + u32 qh + 16 bytes;
    x = d*q + m with unsigned 5-bit values."""
    blocks = raw.reshape(-1, 24)
    d = blocks[:, 0:2].copy().view(np.float16).astype(np.float32)
    m = blocks[:, 2:4].copy().view(np.float16).astype(np.float32)
    qh = blocks[:, 4:8].copy().view(np.uint32)
    qs = blocks[:, 8:]
    j = np.arange(16, dtype=np.uint32)
    hi0 = (((qh >> j) & 1) << 4).astype(np.uint8)
    hi1 = (((qh >> (j + 16)) & 1) << 4).astype(np.uint8)
    q = np.concatenate([(qs & 0xF) | hi0, (qs >> 4) | hi1],
                       axis=1).astype(np.float32)
    return (q * d + m).reshape(-1)[:n_elems]


def _dequant_q2_k(raw: np.ndarray, n_elems: int) -> np.ndarray:
    """GGUF Q2_K: 84-byte super-blocks of 256 = 16 scale bytes (low
    nibble: scale, high: min) + 64 quant bytes + f16 d + f16 dmin.
    x = d*sc*q - dmin*m; 16 sub-blocks of 16. Quant byte l of chunk n
    (32 bytes) carries elements (128n + 32s + l) in bit pair s."""
    blocks = raw.reshape(-1, 84)
    nb = blocks.shape[0]
    sc_raw = blocks[:, :16]
    qs = blocks[:, 16:80]
    d = blocks[:, 80:82].copy().view(np.float16).astype(np.float32)
    dmin = blocks[:, 82:84].copy().view(np.float16).astype(np.float32)
    dl = d * (sc_raw & 0xF)       # (nb, 16) per-sub-block scales
    ml = dmin * (sc_raw >> 4)     # (nb, 16) per-sub-block mins
    out = np.empty((nb, 256), np.float32)
    for n in range(2):            # two 128-element halves
        chunk = qs[:, 32 * n:32 * n + 32]
        for s in range(4):        # bit-pair shift 0/2/4/6
            q = ((chunk >> (2 * s)) & 3).astype(np.float32)
            base = 128 * n + 32 * s
            i0 = 8 * n + 2 * s
            out[:, base:base + 16] = dl[:, i0:i0 + 1] * q[:, :16] \
                - ml[:, i0:i0 + 1]
            out[:, base + 16:base + 32] = dl[:, i0 + 1:i0 + 2] \
                * q[:, 16:] - ml[:, i0 + 1:i0 + 2]
    return out.reshape(-1)[:n_elems]


def _unpack_q3k_scales(packed: np.ndarray) -> np.ndarray:
    """Q3_K's 12 packed bytes -> 16 int8 6-bit scales (pre-offset by
    -32 by the caller). Transcribed from dequantize_row_q3_K's
    kmask1/kmask2 aux shuffle."""
    u = packed.copy().view(np.uint32)  # (nb, 3) little-endian words
    a, b, c = u[:, 0], u[:, 1], u[:, 2]
    k1, k2 = np.uint32(0x03030303), np.uint32(0x0F0F0F0F)
    aux = np.stack([
        (a & k2) | (((c >> np.uint32(0)) & k1) << np.uint32(4)),
        (b & k2) | (((c >> np.uint32(2)) & k1) << np.uint32(4)),
        ((a >> np.uint32(4)) & k2) | (((c >> np.uint32(4)) & k1)
                                      << np.uint32(4)),
        ((b >> np.uint32(4)) & k2) | (((c >> np.uint32(6)) & k1)
                                      << np.uint32(4)),
    ], axis=1)  # (nb, 4) uint32
    return aux.view(np.int8).astype(np.float32)  # (nb, 16)


def _dequant_q3_k(raw: np.ndarray, n_elems: int) -> np.ndarray:
    """GGUF Q3_K: 110-byte super-blocks of 256 = 32 hmask bytes + 64
    quant bytes + 12 packed 6-bit scale bytes + f16 d. Element order as
    Q2_K; value = (2-bit pair | high bit from hmask) - 4 when the hmask
    bit is CLEAR (bit index = the (half, shift) group number)."""
    blocks = raw.reshape(-1, 110)
    nb = blocks.shape[0]
    hm = blocks[:, :32]
    qs = blocks[:, 32:96]
    scales = _unpack_q3k_scales(blocks[:, 96:108]) - 32.0  # (nb, 16)
    d = blocks[:, 108:110].copy().view(np.float16).astype(np.float32)
    out = np.empty((nb, 256), np.float32)
    for n in range(2):
        chunk = qs[:, 32 * n:32 * n + 32]
        for s in range(4):
            m = 1 << (4 * n + s)  # hmask bit for this group
            hi = np.where(hm & m, 0.0, 4.0)  # (nb, 32)
            q = ((chunk >> (2 * s)) & 3).astype(np.float32) - hi
            base = 128 * n + 32 * s
            i0 = 8 * n + 2 * s
            out[:, base:base + 16] = d * scales[:, i0:i0 + 1] * q[:, :16]
            out[:, base + 16:base + 32] = (
                d * scales[:, i0 + 1:i0 + 2] * q[:, 16:])
    return out.reshape(-1)[:n_elems]


def _unpack_k4_scales(packed: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """The 6-bit scale/min pairs of Q4_K/Q5_K super-blocks
    (ggml-quants.c get_scale_min_k4): 12 bytes -> 8 scales + 8 mins."""
    q = packed.astype(np.uint8)
    sc = np.empty(q.shape[:-1] + (8,), np.float32)
    mn = np.empty_like(sc)
    for j in range(4):
        sc[..., j] = q[..., j] & 63
        mn[..., j] = q[..., j + 4] & 63
    for j in range(4, 8):
        sc[..., j] = (q[..., j + 4] & 0xF) | ((q[..., j - 4] >> 6) << 4)
        mn[..., j] = (q[..., j + 4] >> 4) | ((q[..., j] >> 6) << 4)
    return sc, mn


def _dequant_q4_k(raw: np.ndarray, n_elems: int) -> np.ndarray:
    """GGUF Q4_K: 144-byte super-blocks of 256 = f16 d + f16 dmin +
    12 bytes packed 6-bit scales/mins + 128 nibble bytes. Eight 32-wide
    sub-blocks: x = d*sc[s]*q - dmin*m[s]; chunk j of 32 bytes holds
    sub-block 2j in its low nibbles and 2j+1 in its high nibbles."""
    blocks = raw.reshape(-1, 144)
    nb = blocks.shape[0]
    d = blocks[:, 0:2].copy().view(np.float16).astype(np.float32)
    dmin = blocks[:, 2:4].copy().view(np.float16).astype(np.float32)
    sc, mn = _unpack_k4_scales(blocks[:, 4:16])
    qs = blocks[:, 16:]
    out = np.empty((nb, 256), np.float32)
    for j in range(4):
        chunk = qs[:, 32 * j:32 * j + 32]
        out[:, 64 * j:64 * j + 32] = (
            d * sc[:, 2 * j:2 * j + 1] * (chunk & 0xF)
            - dmin * mn[:, 2 * j:2 * j + 1])
        out[:, 64 * j + 32:64 * j + 64] = (
            d * sc[:, 2 * j + 1:2 * j + 2] * (chunk >> 4)
            - dmin * mn[:, 2 * j + 1:2 * j + 2])
    return out.reshape(-1)[:n_elems]


def _dequant_q5_k(raw: np.ndarray, n_elems: int) -> np.ndarray:
    """GGUF Q5_K: 176-byte super-blocks = Q4_K layout + 32 bytes qh
    carrying each element's 5th bit (bit pair 2j/2j+1 of qh byte l
    serves sub-blocks 2j and 2j+1 at offset l)."""
    blocks = raw.reshape(-1, 176)
    nb = blocks.shape[0]
    d = blocks[:, 0:2].copy().view(np.float16).astype(np.float32)
    dmin = blocks[:, 2:4].copy().view(np.float16).astype(np.float32)
    sc, mn = _unpack_k4_scales(blocks[:, 4:16])
    qh = blocks[:, 16:48]
    qs = blocks[:, 48:]
    out = np.empty((nb, 256), np.float32)
    for j in range(4):
        chunk = qs[:, 32 * j:32 * j + 32]
        hi_lo = (((qh >> (2 * j)) & 1) << 4).astype(np.uint8)
        hi_hi = (((qh >> (2 * j + 1)) & 1) << 4).astype(np.uint8)
        out[:, 64 * j:64 * j + 32] = (
            d * sc[:, 2 * j:2 * j + 1] * ((chunk & 0xF) | hi_lo)
            - dmin * mn[:, 2 * j:2 * j + 1])
        out[:, 64 * j + 32:64 * j + 64] = (
            d * sc[:, 2 * j + 1:2 * j + 2] * ((chunk >> 4) | hi_hi)
            - dmin * mn[:, 2 * j + 1:2 * j + 2])
    return out.reshape(-1)[:n_elems]


def _dequant_q6_k(raw: np.ndarray, n_elems: int) -> np.ndarray:
    """GGUF Q6_K: 210-byte super-blocks of 256 = 128 bytes ql (low 4
    bits) + 64 bytes qh (high 2 bits) + 16 int8 sub-block scales +
    f16 d (trailing). x = d * scales[s] * (q - 32), 16 sub-blocks of
    16 elements; element interleave per dequantize_row_q6_K."""
    blocks = raw.reshape(-1, 210)
    nb = blocks.shape[0]
    ql = blocks[:, :128]
    qh = blocks[:, 128:192]
    scales = blocks[:, 192:208].copy().view(np.int8).astype(np.float32)
    d = blocks[:, 208:210].copy().view(np.float16).astype(np.float32)
    out = np.empty((nb, 256), np.float32)
    sub = np.arange(32) // 16  # sub-block selector within a 32-row
    for n in range(2):  # two independent 128-element halves
        ql_h = ql[:, 64 * n:64 * n + 64]
        qh_h = qh[:, 32 * n:32 * n + 32]
        sc_h = scales[:, 8 * n:8 * n + 8]
        q1 = ((ql_h[:, :32] & 0xF) | (((qh_h >> 0) & 3) << 4)).astype(
            np.float32) - 32.0
        q2 = ((ql_h[:, 32:] & 0xF) | (((qh_h >> 2) & 3) << 4)).astype(
            np.float32) - 32.0
        q3 = ((ql_h[:, :32] >> 4) | (((qh_h >> 4) & 3) << 4)).astype(
            np.float32) - 32.0
        q4 = ((ql_h[:, 32:] >> 4) | (((qh_h >> 6) & 3) << 4)).astype(
            np.float32) - 32.0
        base = 128 * n
        out[:, base:base + 32] = d * sc_h[:, sub] * q1
        out[:, base + 32:base + 64] = d * sc_h[:, sub + 2] * q2
        out[:, base + 64:base + 96] = d * sc_h[:, sub + 4] * q3
        out[:, base + 96:base + 128] = d * sc_h[:, sub + 6] * q4
    return out.reshape(-1)[:n_elems]


# The IQ4 nonlinear 4-bit codebook (ggml-quants.c kvalues_iq4nl).
_IQ4NL_KVALUES = np.asarray(
    [-127, -104, -83, -65, -49, -35, -22, -10,
     1, 13, 25, 38, 53, 69, 89, 113], np.float32)


def _dequant_iq4_nl(raw: np.ndarray, n_elems: int) -> np.ndarray:
    """GGUF IQ4_NL: 18-byte blocks of 32 = f16 d + 16 packed bytes of
    4-bit CODEBOOK INDICES (nonlinear kvalues table, not linear
    levels). x = d * kvalues[q]; low nibbles are elements 0-15, high
    16-31 (dequantize_row_iq4_nl)."""
    blocks = raw.reshape(-1, 18)
    d = blocks[:, 0:2].copy().view(np.float16).astype(np.float32)
    qs = blocks[:, 2:18]
    lo = _IQ4NL_KVALUES[qs & 0xF]
    hi = _IQ4NL_KVALUES[qs >> 4]
    return (np.concatenate([lo, hi], axis=1) * d).reshape(-1)[:n_elems]


def _dequant_iq4_xs(raw: np.ndarray, n_elems: int) -> np.ndarray:
    """GGUF IQ4_XS: 136-byte super-blocks of 256 = f16 d + u16
    scales_h + 4 bytes scales_l + 128 packed codebook indices. Eight
    32-element sub-blocks; 6-bit scale ib = low nibble from scales_l
    plus 2 bits from scales_h, minus 32: x = d*(ls-32)*kvalues[q]
    (dequantize_row_iq4_xs)."""
    blocks = raw.reshape(-1, 136)
    nb = blocks.shape[0]
    d = blocks[:, 0:2].copy().view(np.float16).astype(np.float32)
    scales_h = blocks[:, 2:4].copy().view(np.uint16).astype(np.uint32)
    scales_l = blocks[:, 4:8]
    qs = blocks[:, 8:136]
    out = np.empty((nb, 256), np.float32)
    for ib in range(8):
        ls = ((scales_l[:, ib // 2] >> (4 * (ib % 2))) & 0xF).astype(
            np.uint32) | (((scales_h[:, 0] >> (2 * ib)) & 3) << 4)
        dl = d[:, 0] * (ls.astype(np.float32) - 32.0)
        q = qs[:, 16 * ib:16 * ib + 16]
        out[:, 32 * ib:32 * ib + 16] = dl[:, None] * _IQ4NL_KVALUES[q & 0xF]
        out[:, 32 * ib + 16:32 * ib + 32] = dl[:, None] \
            * _IQ4NL_KVALUES[q >> 4]
    return out.reshape(-1)[:n_elems]


# MXFP4 e2m1 magnitudes doubled to integers ({0,.5,1,1.5,2,3,4,6}*2),
# compensated by halving the e8m0 scale (ggml-quants.c kvalues_mxfp4).
_MXFP4_KVALUES = np.array(
    [0, 1, 2, 3, 4, 6, 8, 12, 0, -1, -2, -3, -4, -6, -8, -12],
    np.float32)


def _dequant_mxfp4(raw: np.ndarray, n_elems: int) -> np.ndarray:
    """MXFP4 (OCP Microscaling): block of 32 = 1 e8m0 scale byte
    (2^(e-127), shared) + 16 bytes of e2m1 nibbles in the q4_0 element
    order (elem j low nibble, elem j+16 high). Dequant uses the halved
    scale 2^(e-128) against the doubled integer table."""
    blocks = raw.reshape(-1, 17)
    d = np.exp2(blocks[:, 0].astype(np.int32) - 128).astype(np.float32)
    qs = blocks[:, 1:]
    out = np.empty((blocks.shape[0], 32), np.float32)
    out[:, :16] = d[:, None] * _MXFP4_KVALUES[qs & 0xF]
    out[:, 16:] = d[:, None] * _MXFP4_KVALUES[qs >> 4]
    return out.reshape(-1)[:n_elems]


# ggml_type -> (elements per block, bytes per block, dequantizer).
_GGML_DEQUANT = {
    GGML_Q8_0: (32, 34, _dequant_q8_0),
    GGML_Q4_0: (32, 18, _dequant_q4_0),
    GGML_Q4_1: (32, 20, _dequant_q4_1),
    GGML_Q5_0: (32, 22, _dequant_q5_0),
    GGML_Q5_1: (32, 24, _dequant_q5_1),
    GGML_Q2_K: (256, 84, _dequant_q2_k),
    GGML_Q3_K: (256, 110, _dequant_q3_k),
    GGML_Q4_K: (256, 144, _dequant_q4_k),
    GGML_Q5_K: (256, 176, _dequant_q5_k),
    GGML_Q6_K: (256, 210, _dequant_q6_k),
    GGML_IQ4_NL: (32, 18, _dequant_iq4_nl),
    GGML_IQ4_XS: (256, 136, _dequant_iq4_xs),
    GGML_MXFP4: (32, 17, _dequant_mxfp4),
}


def load_gguf_tensor(gguf: GGUFFile, name: str) -> np.ndarray:
    """Materialize one tensor as f32 numpy (dequantizing as needed)."""
    info = gguf.tensors.get(name)
    if info is None:
        raise TrackieError(ErrorCode.NOT_FOUND, f"tensor {name!r}")
    n_elems = int(np.prod(info.shape))
    with open(gguf.path, "rb") as f:
        f.seek(gguf.data_start + info.offset)
        if info.ggml_type == GGML_F32:
            data = np.fromfile(f, np.float32, n_elems)
        elif info.ggml_type == GGML_F16:
            data = np.fromfile(f, np.float16, n_elems).astype(np.float32)
        elif info.ggml_type in _GGML_DEQUANT:
            per_block, block_bytes, fn = _GGML_DEQUANT[info.ggml_type]
            n_blocks = (n_elems + per_block - 1) // per_block
            raw = np.fromfile(f, np.uint8, n_blocks * block_bytes)
            data = fn(raw, n_elems)
        else:
            raise TrackieError(
                ErrorCode.QUANT_UNSUPPORTED,
                f"ggml type {info.ggml_type} for {name!r} not supported")
    return data.reshape(info.shape)


# ---------------------------------------------------------------------------
# safetensors / npz
# ---------------------------------------------------------------------------

_ST_DTYPES = {
    "F32": np.float32, "F16": np.float16, "BF16": None,  # bf16 special
    "I32": np.int32, "I8": np.int8, "U8": np.uint8, "I64": np.int64,
    "F64": np.float64, "BOOL": np.bool_,
}


def load_safetensors(path: str) -> Dict[str, np.ndarray]:
    with open(path, "rb") as f:
        (hlen,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(hlen))
        data_start = 8 + hlen
        out: Dict[str, np.ndarray] = {}
        for name, spec in header.items():
            if name == "__metadata__":
                continue
            a, b = spec["data_offsets"]
            f.seek(data_start + a)
            raw = f.read(b - a)
            dt = spec["dtype"]
            shape = tuple(spec["shape"])
            if dt == "BF16":
                u16 = np.frombuffer(raw, np.uint16)
                arr = (u16.astype(np.uint32) << 16).view(np.float32)
            else:
                np_dt = _ST_DTYPES.get(dt)
                if np_dt is None:
                    raise TrackieError(ErrorCode.MODEL_METADATA_INVALID,
                                       f"safetensors dtype {dt}")
                arr = np.frombuffer(raw, np_dt)
            out[name] = arr.reshape(shape).copy()
    return out


def load_npz(path: str) -> Dict[str, np.ndarray]:
    with np.load(path, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


# ---------------------------------------------------------------------------
# Front-end loader + cache
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class LoadedModel:
    path: str
    format: ModelFormat
    metadata: Dict[str, Any]
    tensors: Dict[str, np.ndarray]
    loaded_at: float
    size_bytes: int


def describe(path: str) -> Dict[str, Any]:
    """Metadata-only inspection (no tensor data read)."""
    fmt = detect_format(path)
    if fmt is ModelFormat.NATIVE:
        import os

        import numpy as np

        info: Dict[str, Any] = {"format": fmt.value}
        cfg_path = os.path.join(path, "config.json")
        if os.path.exists(cfg_path):
            with open(cfg_path) as f:
                info["config"] = json.load(f)
        with np.load(os.path.join(path, "arrays.npz")) as z:
            names = z.files
            info["n_arrays"] = len(names)
            info["n_parameters"] = int(sum(
                int(np.prod(z[n].shape)) for n in names))
        return info
    if fmt is ModelFormat.GGUF:
        g = read_gguf_header(path)
        return {"format": fmt.value, "architecture": g.architecture,
                "name": g.name, "n_tensors": len(g.tensors),
                "metadata_keys": len(g.metadata)}
    if fmt is ModelFormat.SAFETENSORS:
        with open(path, "rb") as f:
            (hlen,) = struct.unpack("<Q", f.read(8))
            header = json.loads(f.read(hlen))
        names = [k for k in header if k != "__metadata__"]
        return {"format": fmt.value, "n_tensors": len(names)}
    if fmt is ModelFormat.GGML:
        from trackiellm_tpu_torch.models.ggml_reader import (
            _HPARAM_NAMES, GGML_MAGIC)

        with open(path, "rb") as f:
            head = f.read(48)
        if len(head) < 48:
            raise TrackieError(
                ErrorCode.MODEL_FORMAT_UNKNOWN,
                f"truncated GGML file: {len(head)} bytes, header is 48")
        vals = struct.unpack("<12i", head)
        if vals[0] != GGML_MAGIC:
            raise TrackieError(
                ErrorCode.MODEL_FORMAT_UNKNOWN,
                f"bad GGML magic 0x{vals[0] & 0xFFFFFFFF:08x}")
        return {"format": fmt.value, "architecture": "whisper",
                "hparams": dict(zip(_HPARAM_NAMES, vals[1:]))}
    return {"format": fmt.value}


def load_model(path: str) -> LoadedModel:
    fmt = detect_format(path)
    meta: Dict[str, Any] = {}
    if fmt is ModelFormat.GGUF:
        g = read_gguf_header(path)
        meta = dict(g.metadata)
        tensors = {n: load_gguf_tensor(g, n) for n in g.tensors}
    elif fmt is ModelFormat.GGML:
        from trackiellm_tpu_torch.models.ggml_reader import read_ggml_whisper

        g = read_ggml_whisper(path)
        meta = {"hparams": g.hparams, "n_vocab_stored": len(g.vocab)}
        tensors = g.tensors
    elif fmt is ModelFormat.SAFETENSORS:
        tensors = load_safetensors(path)
    elif fmt is ModelFormat.NPZ:
        tensors = load_npz(path)
    elif fmt is ModelFormat.ONNX:
        # The graph is never executed (architectures are torch programs in
        # trackiellm_tpu_torch.models); the WEIGHTS load fine — feed them to
        # the matching models.convert mapper.
        from trackiellm_tpu_torch.models.onnx_reader import read_onnx_initializers

        tensors = read_onnx_initializers(path)
    elif fmt is ModelFormat.TFLITE:
        raise TrackieError(
            ErrorCode.MODEL_FORMAT_UNKNOWN,
            "tflite graphs are not executed at runtime; convert the "
            "weights offline (the architectures live in "
            "trackiellm_tpu_torch.models)")
    else:
        raise TrackieError(ErrorCode.MODEL_FORMAT_UNKNOWN, path)
    size = sum(t.nbytes for t in tensors.values())
    return LoadedModel(path, fmt, meta, tensors, time.time(), size)


def optimize_model(model: LoadedModel,
                   target_dtype=np.float16) -> LoadedModel:
    """Parity: the loader's optimize entry point (tk_model_loader.c:1188-
    1301) — here a storage optimization: downcast f32 tensors to the
    target dtype (f16 halves the footprint; norms and small vectors are
    kept f32 for numerical headroom)."""
    out: Dict[str, np.ndarray] = {}
    for name, t in model.tensors.items():
        if t.dtype == np.float32 and t.ndim >= 2 and t.size > 4096:
            out[name] = t.astype(target_dtype)
        else:
            out[name] = t
    size = sum(t.nbytes for t in out.values())
    return LoadedModel(model.path, model.format, model.metadata, out,
                       model.loaded_at, size)


def validate_model(path: str) -> bool:
    """Parity: tk_model_loader validate (:1188) — header parse + tensor
    directory sanity, no full data read."""
    try:
        fmt = detect_format(path)
        if fmt is ModelFormat.GGUF:
            g = read_gguf_header(path)
            return len(g.tensors) > 0
        if fmt in (ModelFormat.SAFETENSORS, ModelFormat.NPZ):
            return bool(describe(path))
        return fmt is not ModelFormat.UNKNOWN
    except TrackieError:
        return False


class ModelCache:
    """Slotted LRU model cache with a memory budget (parity: the loader's
    cache slots + tk_memory_manager's eviction policy)."""

    def __init__(self, max_models: int = 4,
                 max_bytes: int = 8 * (1 << 30)):
        self.max_models = max_models
        self.max_bytes = max_bytes
        self._cache: "OrderedDict[str, LoadedModel]" = OrderedDict()
        self._lock = threading.Lock()
        self.evictions = 0

    def get(self, path: str) -> LoadedModel:
        with self._lock:
            if path in self._cache:
                self._cache.move_to_end(path)
                return self._cache[path]
        model = load_model(path)
        with self._lock:
            self._cache[path] = model
            self._cache.move_to_end(path)
            self._evict_locked()
        return model

    def preload(self, paths: List[str]) -> None:
        """Parity: tk_model_loader preload (:1355)."""
        for p in paths:
            self.get(p)

    def _evict_locked(self) -> None:
        def total() -> int:
            return sum(m.size_bytes for m in self._cache.values())

        while (len(self._cache) > self.max_models
               or total() > self.max_bytes):
            if len(self._cache) <= 1:
                break
            evicted_path, _ = self._cache.popitem(last=False)
            self.evictions += 1
            log.info("evicted model %s from cache", evicted_path)

    @property
    def size(self) -> int:
        with self._lock:
            return len(self._cache)
