"""Training data: text -> packed token batches, prefetched to the card.

Port of ``trackiellm_tpu/parallel/data.py``: documents tokenize once, pack
into fixed-length rows (no padding), shuffle per epoch, and the next batch
goes to the device while the current step runs.
"""

from __future__ import annotations

import threading
from typing import Iterator, List, Optional, Sequence

import numpy as np
import torch

from trackiellm_tpu_torch.llm.tokenizer import Tokenizer
from trackiellm_tpu_torch.ops.backend import default_device


class PackedDataset:
    """Tokenize + pack documents into (seq_len,) int32 training rows.

    Documents are joined with EOS separators and the concatenated stream
    is chopped into fixed rows: the standard packing that wastes no tokens
    on padding.
    """

    def __init__(self, texts: Sequence[str], tokenizer: Tokenizer,
                 seq_len: int = 256):
        self.seq_len = seq_len
        stream: List[int] = []
        for t in texts:
            stream.extend(tokenizer.encode(t))
            stream.append(tokenizer.eos_id)
        n_rows = len(stream) // seq_len
        self.rows = np.asarray(
            stream[: n_rows * seq_len], np.int32).reshape(n_rows, seq_len)

    def __len__(self) -> int:
        return len(self.rows)

    def batches(self, batch_size: int, seed: int = 0,
                drop_remainder: bool = True) -> Iterator[np.ndarray]:
        """One shuffled epoch of (batch_size, seq_len) batches (numpy's
        permutation from ``seed``, the reference's order)."""
        order = np.random.default_rng(seed).permutation(len(self.rows))
        end = (len(order) // batch_size * batch_size if drop_remainder
               else len(order))
        for i in range(0, end, batch_size):
            yield self.rows[order[i:i + batch_size]]


class PrefetchIterator:
    """Wraps a host batch iterator: the next batch's copy to ``device`` (the
    card unless the CPU is given) starts while the current step computes.
    On the card each batch is staged in pinned memory and copied
    asynchronously on the current stream, so the host does not wait for
    it; the step that reads it is ordered after it on that stream."""

    def __init__(self, batches: Iterator[np.ndarray],
                 device: Optional[torch.device] = None):
        self._it = iter(batches)
        self._device = default_device(device, "prefetch batches")
        self._next = None
        self._lock = threading.Lock()
        self._advance()

    def _put(self, host_batch) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(host_batch))
        if self._device.type == "cuda":
            return t.pin_memory().to(self._device, non_blocking=True)
        return t.to(self._device)

    def _advance(self) -> None:
        try:
            self._next = self._put(next(self._it))
        except StopIteration:
            self._next = None

    def __iter__(self):
        return self

    def __next__(self) -> torch.Tensor:
        with self._lock:
            if self._next is None:
                raise StopIteration
            current = self._next
            self._advance()  # async transfer of the following batch
            return current
