"""whisper.cpp GGML checkpoint reader (pure Python, no runtime deps).

The port's copy of ``trackiellm_tpu/models/ggml_reader.py``; it reads
through the port's ``models/loader.py``.

The reference's ASR artifact is a whisper.cpp **GGML** file ("Whisper
tiny GGML": src/cortex/tk_cortex_main.h:70-76, loaded via
``whisper_init_from_file_with_params`` at src/audio/tk_asr_whisper.c:238).
This module reads that container natively so the reference's exact model
file is turnkey, the same way models/loader.py reads llama.cpp GGUF.

Container layout (fixed by whisper.cpp's ``convert-pt-to-ggml.py`` and
``whisper.cpp::whisper_model_load``):

- int32 magic ``0x67676d6c`` (``b"lmgg"`` on disk, little-endian)
- 11 int32 hparams: n_vocab, n_audio_ctx, n_audio_state, n_audio_head,
  n_audio_layer, n_text_ctx, n_text_state, n_text_head, n_text_layer,
  n_mels, ftype (model-level; per-tensor types govern reading)
- mel filterbank: int32 n_mel, int32 n_fft, then n_mel*n_fft f32
- vocab: int32 n_tokens, then per token: int32 byte_len + raw bytes
  (the converter byte-decodes the GPT-2 byte-level vocab, so entries
  are raw UTF-8 fragments, not printable escapes)
- tensors until EOF: int32 n_dims, int32 name_len, int32 ggml_type;
  n_dims int32 dims in REVERSED (ggml ne[]) order; the utf-8 name; raw
  tensor data immediately after (no alignment padding, unlike GGUF)

Tensor names are the openai-whisper state-dict names (the converter
writes ``model.state_dict()`` keys unchanged), so the result feeds
``models/convert.whisper_from_torch`` directly. Two converter-side
reshapes are undone here: conv biases are stored ``(n, 1)`` (explicit
reshape in convert-pt-to-ggml.py) and all tensors were ``squeeze()``d.

Per-tensor type ids are ggml's enum — identical to GGUF's, with
identical block layouts (whisper.cpp's ``quantize`` tool emits Q4_0/
Q5_0/Q5_1/Q8_0 etc. in the same container) — so dequantization reuses
models/loader's ``_GGML_DEQUANT`` table.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import BinaryIO, Dict, List

import numpy as np

from trackiellm_tpu_torch.utils.errors import ErrorCode, TrackieError
from trackiellm_tpu_torch.models.loader import (
    GGML_F16, GGML_F32, _GGML_DEQUANT)

GGML_MAGIC = 0x67676D6C  # b"lmgg" little-endian

_HPARAM_NAMES = (
    "n_vocab", "n_audio_ctx", "n_audio_state", "n_audio_head",
    "n_audio_layer", "n_text_ctx", "n_text_state", "n_text_head",
    "n_text_layer", "n_mels", "ftype",
)

# convert-pt-to-ggml.py reshapes these 1-D biases to (n, 1) on write.
_CONV_BIAS_NAMES = ("encoder.conv1.bias", "encoder.conv2.bias")


@dataclasses.dataclass
class WhisperGGML:
    """Parsed whisper.cpp GGML file."""

    path: str
    hparams: Dict[str, int]
    mel_filters: np.ndarray          # (n_mel, n_fft) f32
    vocab: List[bytes]               # token id -> raw utf-8 bytes
    tensors: Dict[str, np.ndarray]   # torch-layout f32 arrays


def _read_exact(f: BinaryIO, n: int, what: str) -> bytes:
    buf = f.read(n)
    if len(buf) != n:
        raise TrackieError(ErrorCode.MODEL_LOAD_FAILED,
                           f"truncated GGML file reading {what}")
    return buf


def read_ggml_whisper(path: str) -> WhisperGGML:
    """Parse a whisper.cpp GGML file into numpy arrays + vocab."""
    with open(path, "rb") as f:
        (magic,) = struct.unpack("<i", _read_exact(f, 4, "magic"))
        if magic != GGML_MAGIC:
            raise TrackieError(
                ErrorCode.MODEL_FORMAT_UNKNOWN,
                f"{path}: not a whisper.cpp GGML file "
                f"(magic {magic:#x}, want {GGML_MAGIC:#x})")
        vals = struct.unpack("<11i", _read_exact(f, 44, "hparams"))
        hparams = dict(zip(_HPARAM_NAMES, vals))

        n_mel, n_fft = struct.unpack("<2i", _read_exact(f, 8, "mel dims"))
        if not (0 < n_mel <= 1024 and 0 < n_fft <= 65536):
            raise TrackieError(ErrorCode.MODEL_FORMAT_UNKNOWN,
                               f"implausible mel filterbank {n_mel}x{n_fft}")
        filters = np.frombuffer(
            _read_exact(f, 4 * n_mel * n_fft, "mel filters"),
            np.float32).reshape(n_mel, n_fft).copy()

        (n_tok,) = struct.unpack("<i", _read_exact(f, 4, "vocab size"))
        if not 0 <= n_tok <= 2_000_000:
            raise TrackieError(ErrorCode.MODEL_FORMAT_UNKNOWN,
                               f"implausible vocab size {n_tok}")
        vocab: List[bytes] = []
        for i in range(n_tok):
            (ln,) = struct.unpack("<i", _read_exact(f, 4, f"token {i} len"))
            if not 0 <= ln <= 65536:
                raise TrackieError(ErrorCode.MODEL_FORMAT_UNKNOWN,
                                   f"implausible token length {ln}")
            vocab.append(_read_exact(f, ln, f"token {i}"))

        tensors: Dict[str, np.ndarray] = {}
        while True:
            head = f.read(12)
            if not head:
                break
            if len(head) < 12:
                raise TrackieError(ErrorCode.MODEL_LOAD_FAILED,
                                   "truncated GGML tensor header")
            n_dims, name_len, ttype = struct.unpack("<3i", head)
            if not (1 <= n_dims <= 4 and 0 < name_len <= 1024):
                raise TrackieError(
                    ErrorCode.MODEL_FORMAT_UNKNOWN,
                    f"implausible tensor header (n_dims={n_dims}, "
                    f"name_len={name_len})")
            ne = struct.unpack(f"<{n_dims}i",
                               _read_exact(f, 4 * n_dims, "tensor dims"))
            if not all(0 < d <= 2**31 - 1 for d in ne):
                raise TrackieError(
                    ErrorCode.MODEL_FORMAT_UNKNOWN,
                    f"implausible tensor dims ne={ne} "
                    "(corrupt GGML header?)")
            name = _read_exact(f, name_len, "tensor name").decode("utf-8")
            shape = tuple(reversed(ne))  # ggml ne[] is innermost-first
            n_elems = int(np.prod(shape))
            if ttype == GGML_F32:
                data = np.frombuffer(
                    _read_exact(f, 4 * n_elems, name), np.float32).copy()
            elif ttype == GGML_F16:
                data = np.frombuffer(
                    _read_exact(f, 2 * n_elems, name),
                    np.float16).astype(np.float32)
            elif ttype in _GGML_DEQUANT:
                per_block, block_bytes, fn = _GGML_DEQUANT[ttype]
                n_blocks = (n_elems + per_block - 1) // per_block
                raw = np.frombuffer(
                    _read_exact(f, n_blocks * block_bytes, name), np.uint8)
                data = fn(raw, n_elems)
            else:
                raise TrackieError(
                    ErrorCode.QUANT_UNSUPPORTED,
                    f"ggml type {ttype} for {name!r} not supported")
            tensors[name] = data.reshape(shape)

    for bias in _CONV_BIAS_NAMES:
        if bias in tensors:
            tensors[bias] = tensors[bias].reshape(-1)
    return WhisperGGML(path=path, hparams=hparams, mel_filters=filters,
                       vocab=vocab, tensors=tensors)


class GGMLVocabTokenizer:
    """Decode-side tokenizer over the GGML file's embedded byte vocab.

    Whisper's vocabulary is GPT-2 byte-level BPE; the GGML file stores
    each token's raw bytes, which is everything transcription decode
    needs (encode is never used by the ASR path). Ids at or beyond the
    stored list (whisper's synthesized specials: <|endoftext|>, task /
    language / timestamp tokens) decode to nothing.
    """

    def __init__(self, vocab: List[bytes]):
        self._vocab = vocab
        self.vocab_size = len(vocab)

    def decode(self, ids) -> str:
        buf = b"".join(self._vocab[i] for i in ids
                       if 0 <= i < len(self._vocab))
        return buf.decode("utf-8", errors="replace")

    def decode_token(self, tid: int) -> str:
        return self.decode([tid])
