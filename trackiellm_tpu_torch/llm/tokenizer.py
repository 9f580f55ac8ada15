"""Tokenizers for the LLM runner.

Port of ``trackiellm_tpu/llm/tokenizer.py:Tokenizer`` and ``ByteTokenizer``
(the JAX package's ``trackiellm_tpu.llm`` package imports JAX when loaded,
so the byte tokenizer is carried here rather than imported).
"""

from __future__ import annotations

from typing import List, Protocol, Sequence


class Tokenizer(Protocol):
    vocab_size: int
    bos_id: int
    eos_id: int
    pad_id: int

    def encode(self, text: str, add_bos: bool = False) -> List[int]: ...

    def decode(self, ids: Sequence[int]) -> str: ...

    def decode_token(self, token_id: int) -> str: ...


class ByteTokenizer:
    """UTF-8 byte tokenizer: ids 0-255 are raw bytes; specials follow."""

    def __init__(self, n_special_pad_to: int = 512):
        self.bos_id = 256
        self.eos_id = 257
        self.pad_id = 258
        self.vocab_size = max(n_special_pad_to, 259)

    def encode(self, text: str, add_bos: bool = False) -> List[int]:
        ids = list(text.encode("utf-8"))
        return ([self.bos_id] + ids) if add_bos else ids

    def decode(self, ids: Sequence[int]) -> str:
        data = bytes(i for i in ids if 0 <= i < 256)
        return data.decode("utf-8", errors="replace")

    def decode_token(self, token_id: int) -> str:
        if 0 <= token_id < 256:
            return bytes([token_id]).decode("utf-8", errors="replace")
        return ""

    def token_bytes(self, token_id: int) -> bytes:
        return bytes([token_id]) if 0 <= token_id < 256 else b""
