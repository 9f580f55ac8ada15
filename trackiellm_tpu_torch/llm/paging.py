"""Paged KV cache: the page-pool allocator and paged decode.

Port of ``trackiellm_tpu/llm/paging.py``. Many conversations share one
preallocated page pool; each sequence holds a page table, and its pages
return to the free list when the conversation ends, so memory scales with
live tokens, not with max_seq times the conversations.

Device side: the pools are (L, n_pages, page_size, Hk, D) tensors on the
pool's device (or a :class:`QuantPool` of int8 values and f32 scales),
updated in place. A decode step writes each new token's K/V into
``table[len // page_size]`` at row ``len % page_size`` and attends over
the gathered pages; a k-step chunk gathers each slot's pages once into a
contiguous scratch, runs ``models/llm.py``'s ``decode_steps_batch`` over
it and scatters back only the cells it wrote. Host side:
:class:`PagedKVPool` keeps the free list, the tables, and the prefix
cache's hash chain with refcounts and LRU eviction. Page 0 is the trash
page: inactive slots write there, and the allocator never hands it out.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from trackiellm_tpu_torch.models import llm as llm_model
from trackiellm_tpu_torch.ops.attention import decode_attention_batch
from trackiellm_tpu_torch.ops.backend import default_device
from trackiellm_tpu_torch.utils.errors import ErrorCode, TrackieError


class QuantPool(NamedTuple):
    """int8 page pool: values and one f32 scale per (cell, kv head), the
    counterpart of llama.cpp's ``-ctk q8_0`` KV cells. Half the bytes of
    a bf16 pool, so every page gather reads half as much; the scales add
    4 / D bytes a value."""

    vals: torch.Tensor   # int8 (L, P, page, Hk, D)
    scale: torch.Tensor  # f32  (L, P, page, Hk)


def _quant_cells(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 per row: (..., D) -> (int8 (..., D), f32 scale
    (...,)), amax / 127 + 1e-8 and round half to even, as the reference.
    The divisor is a 0-dim tensor on x's device: on CUDA torch turns
    division by a Python number into a product with its f32 reciprocal."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    scale = amax / amax.new_full((), 127.0) + 1e-8
    q = torch.round(xf / scale[..., None])
    return q.to(torch.int8), scale


def _dequant_cells(vals: torch.Tensor, scale: torch.Tensor,
                   dtype: torch.dtype) -> torch.Tensor:
    return (vals.float() * scale[..., None].float()).to(dtype)


def _pool_vals(pool) -> torch.Tensor:
    """The (L, P, page, Hk, D) value tensor of either pool layout."""
    return pool.vals if isinstance(pool, QuantPool) else pool


def _read_pages(pool, index, dtype: torch.dtype) -> torch.Tensor:
    """``pool[index]`` as values of ``dtype`` (dequantized for an int8
    pool): a gathered copy."""
    if isinstance(pool, QuantPool):
        return _dequant_cells(pool.vals[index], pool.scale[index], dtype)
    return pool[index]


def _write_cells(pool, index, val: torch.Tensor) -> None:
    """``pool[index] = val`` in place, quantizing for an int8 pool."""
    if isinstance(pool, QuantPool):
        q, s = _quant_cells(val)
        pool.vals[index] = q
        pool.scale[index] = s
    else:
        pool[index] = val.to(pool.dtype)


def _layer_pool(pool, li: int):
    if isinstance(pool, QuantPool):
        return QuantPool(pool.vals[li], pool.scale[li])
    return pool[li]


def to_device(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on ``device`` without waiting for the device: on the
    card it is staged in pinned memory and copied asynchronously (a
    pageable copy would wait for the stream)."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


@torch.no_grad()
def decode_step_paged(params: Dict[str, Any], cfg: llm_model.LLMConfig,
                      token, pool_k, pool_v, table: torch.Tensor,
                      seq_len: int):
    """One decode step of one sequence over a paged pool (``table`` its
    (max_pages,) page ids, ``seq_len`` its tokens so far): the batched step
    with one active slot. Returns (logits (V,), pool_k, pool_v); the caller
    advances its length."""
    dev = params["tok_emb"].device
    tokens = to_device(np.asarray([int(token)], np.int64), dev)
    lengths = to_device(np.asarray([seq_len], np.int32), dev)
    active = torch.ones((1,), dtype=torch.bool, device=dev)
    logits, pool_k, pool_v = decode_step_batch_paged(
        params, cfg, tokens, active, pool_k, pool_v, table.reshape(1, -1),
        lengths)
    return logits[0], pool_k, pool_v


@torch.no_grad()
def copy_prefill_into_pages(cfg: llm_model.LLMConfig, pool_k, pool_v,
                            table: torch.Tensor,
                            seq_cache: llm_model.KVCache):
    """Scatter a prefilled contiguous cache into the pages of ``table``
    (whole pages; padded tail rows are length-masked later), in place."""
    page = _pool_vals(pool_k).shape[2]
    n = table.shape[0]
    shape = (cfg.n_layers, n, page, cfg.n_kv_heads, cfg.head_dim)
    index = (slice(None), table.long())
    _write_cells(pool_k, index, seq_cache.k[:, :n * page].reshape(shape))
    _write_cells(pool_v, index, seq_cache.v[:, :n * page].reshape(shape))
    return pool_k, pool_v


@torch.no_grad()
def gather_pages_to_cache(cfg: llm_model.LLMConfig, pool_k, pool_v,
                          table: torch.Tensor, length: int,
                          dtype: Optional[torch.dtype] = None
                          ) -> llm_model.KVCache:
    """Stage a page chain (``table``: W pages, padded with the trash page)
    into a contiguous :class:`KVCache` of capacity W * page_size at
    ``length``, so ``extend`` can prefill a suffix after a shared cached
    prefix. An int8 pool dequantizes into ``dtype``."""
    page = _pool_vals(pool_k).shape[2]
    w = table.shape[0]
    index = (slice(None), table.long())
    dt = dtype or _pool_vals(pool_k).dtype
    shape = (cfg.n_layers, w * page, cfg.n_kv_heads, cfg.head_dim)
    k = _read_pages(pool_k, index, dt).reshape(shape)
    v = _read_pages(pool_v, index, dt).reshape(shape)
    return llm_model.KVCache(k=k, v=v, length=int(length))


@torch.no_grad()
def decode_step_batch_paged(params: Dict[str, Any],
                            cfg: llm_model.LLMConfig, tokens: torch.Tensor,
                            active: torch.Tensor, pool_k, pool_v,
                            tables: torch.Tensor, lengths: torch.Tensor,
                            attn_pages: Optional[int] = None):
    """Batched decode over one shared pool with per-slot ``tables`` (B,
    max_pages) and ``lengths`` (B,), both on the device. Each active slot
    writes its new K/V cell in place; inactive slots write the trash page.
    ``attn_pages`` bounds the pages each slot gathers (it must cover
    max(lengths) + 1 tokens). Returns (logits (B, V), pool_k, pool_v)."""
    llm_model.check_supported(cfg, params)
    b = tokens.shape[0]
    page = _pool_vals(pool_k).shape[2]
    pos = lengths.long()
    tables = tables.long()
    page_idx = tables.gather(1, (pos // page)[:, None])[:, 0]
    page_idx = torch.where(active, page_idx, 0)
    slot = torch.where(active, pos % page, 0)
    tv = tables[:, :attn_pages] if attn_pages else tables
    tables_rope = llm_model._rope_tables(params, cfg, pos, pos.max() + 1)
    x = llm_model.embed_tokens(params, tokens)
    hk, hd = cfg.n_kv_heads, cfg.head_dim
    for li in range(cfg.n_layers):
        layer = llm_model._layer(params["layers"], li)
        h, q, k, v = llm_model._qkv(x, layer, cfg, li, tables_rope, pos)
        pk, pv = _layer_pool(pool_k, li), _layer_pool(pool_v, li)
        _write_cells(pk, (page_idx, slot), k)
        _write_cells(pv, (page_idx, slot), v)
        k_seq = _read_pages(pk, tv, x.dtype).reshape(b, -1, hk, hd)
        v_seq = _read_pages(pv, tv, x.dtype).reshape(b, -1, hk, hd)
        attn = decode_attention_batch(q, k_seq, v_seq, pos + 1,
                                      **llm_model._attn_kw(cfg, li, layer))
        x = llm_model._layer_tail(x, h, attn.reshape(b, -1), layer, cfg, li)
    logits = llm_model._output_logits(params, cfg, x)
    return logits, pool_k, pool_v


@torch.no_grad()
def decode_steps_batch_paged(params: Dict[str, Any],
                             cfg: llm_model.LLMConfig, tokens: torch.Tensor,
                             active: torch.Tensor, pool_k, pool_v,
                             tables: torch.Tensor, lengths: torch.Tensor,
                             n_steps: int,
                             attn_pages: Optional[int] = None):
    """``n_steps`` greedy paged batch-decode steps: each slot's first
    ``attn_pages`` pages (all of its table without it) are gathered once
    into a contiguous (L, B, S, Hk, D) scratch, the chunk runs as
    ``decode_steps_batch`` over it, and only the ``n_steps`` cells each
    slot wrote are scattered back (an int8 pool quantizes only those, so
    settled cells never round-trip). The caller must have grown every
    active table to cover ``lengths + n_steps``, and ``attn_pages`` must
    cover ``max(lengths) + n_steps`` tokens. Returns (produced (n_steps,
    B), pool_k, pool_v)."""
    b, max_pages = tables.shape
    page = _pool_vals(pool_k).shape[2]
    tables = tables.long()
    if attn_pages and attn_pages < max_pages:
        tables = tables[:, :attn_pages]
        max_pages = attn_pages
    dt = params["tok_emb"].dtype
    shape = (cfg.n_layers, b, max_pages * page, cfg.n_kv_heads, cfg.head_dim)
    index = (slice(None), tables)
    scratch = llm_model.BatchedKVCache(
        _read_pages(pool_k, index, dt).reshape(shape),
        _read_pages(pool_v, index, dt).reshape(shape), lengths)
    produced, scratch = llm_model.decode_steps_batch(
        params, cfg, tokens, active, scratch, n_steps)
    # Slot b's step j landed at contiguous row lengths[b] + j.
    pos = lengths.long()[:, None] + torch.arange(n_steps,
                                                 device=tables.device)
    rows = torch.arange(b, device=tables.device)[:, None]
    page_idx = torch.where(active[:, None], tables.gather(1, pos // page), 0)
    slot_in = torch.where(active[:, None], pos % page, 0)
    # An inactive slot never advanced: its cells go to the trash page.
    _write_cells(pool_k, (slice(None), page_idx, slot_in),
                 scratch.k[:, rows, pos])
    _write_cells(pool_v, (slice(None), page_idx, slot_in),
                 scratch.v[:, rows, pos])
    return produced, pool_k, pool_v


class PagedKVPool:
    """Host-side page allocator over device pools on ``device``.

    Memory: n_pages x page_size tokens in all, across every live sequence
    (not max_seq per sequence): idle conversations cost only their pages.
    """

    def __init__(self, cfg: llm_model.LLMConfig, n_pages: int = 64,
                 page_size: int = 128, dtype: torch.dtype = torch.bfloat16,
                 compute_dtype: Optional[torch.dtype] = None,
                 device: Optional[torch.device] = None):
        """``dtype=torch.int8`` stores the pool quantized (:class:`
        QuantPool`): half the pool bytes and half the gather traffic.
        ``compute_dtype`` is the dtype a prefix is staged in (bfloat16 for
        an int8 pool by default, else ``dtype``). ``device`` defaults to
        the CUDA card; with none the pool raises unless the CPU is asked
        for."""
        self.cfg = cfg
        self.page_size = page_size
        self.n_pages = n_pages
        self.device = default_device(device, "allocate a page pool")
        self.quantized = dtype == torch.int8
        self.compute_dtype = compute_dtype or (
            torch.bfloat16 if self.quantized else dtype)
        shape = (cfg.n_layers, n_pages, page_size, cfg.n_kv_heads,
                 cfg.head_dim)

        def zeros(shape, dt):
            return torch.zeros(shape, dtype=dt, device=self.device)
        if self.quantized:
            self.pool_k = QuantPool(zeros(shape, torch.int8),
                                    zeros(shape[:-1], torch.float32))
            self.pool_v = QuantPool(zeros(shape, torch.int8),
                                    zeros(shape[:-1], torch.float32))
        else:
            self.pool_k = zeros(shape, dtype)
            self.pool_v = zeros(shape, dtype)
        # Page 0 is reserved as the trash page for inactive batch slots.
        self._free: List[int] = list(range(1, n_pages))
        self._tables: Dict[int, List[int]] = {}
        self._lengths: Dict[int, int] = {}
        self._next_seq = 1
        # Prefix cache: full prompt pages are registered under an exact
        # token hash-chain key; a later sequence whose prompt starts with
        # the same pages shares them (refcounted) and prefills only the
        # suffix. A registered page whose refcount drops to 0 stays
        # resident as LRU-evictable cache, reclaimed only when the free
        # list is empty.
        self._hash_to_page: Dict[Any, int] = {}
        self._page_to_key: Dict[int, Any] = {}
        self._page_refs: Dict[int, int] = {}      # registered pages only
        self._evictable: "OrderedDict[int, None]" = OrderedDict()
        self.prefix_stats = {"hits": 0, "tokens_reused": 0, "evictions": 0}

    # -- allocation ---------------------------------------------------------

    @property
    def free_pages(self) -> int:
        """Allocatable pages: truly free and cache-resident evictables."""
        return len(self._free) + len(self._evictable)

    def ensure_capacity(self, seq_id: int) -> None:
        """Grow the sequence's table if the next token crosses a page
        boundary."""
        length = self._lengths[seq_id]
        if length % self.page_size == 0 and length // self.page_size >= len(
                self._tables[seq_id]):
            self._tables[seq_id].append(self._alloc_page())

    def pages_needed_for(self, seq_ids, n: int) -> int:
        """Pages the given sequences need to decode ``n`` more tokens each
        (None entries skipped)."""
        need = 0
        for s in seq_ids:
            if s is None:
                continue
            covered = len(self._tables[s]) * self.page_size
            short = self._lengths[s] + n - covered
            if short > 0:
                need += (short + self.page_size - 1) // self.page_size
        return need

    def ensure_capacity_for(self, seq_id: int, n: int) -> None:
        """Pre-grow the table so ``n`` more tokens fit, as a multi-step
        chunk needs (its tables are fixed inside it)."""
        target = self._lengths[seq_id] + n
        while len(self._tables[seq_id]) * self.page_size < target:
            self._tables[seq_id].append(self._alloc_page())

    def _batch_inputs(self, tokens, seq_ids):
        """(tokens, active, tables, lengths) on the device for a batch of
        slots (None = inactive); ``tokens`` may already be a device row."""
        active = [s is not None for s in seq_ids]
        max_pages = self.cfg.max_seq // self.page_size
        tables = np.zeros((len(seq_ids), max_pages), np.int64)
        lengths = np.zeros(len(seq_ids), np.int32)
        for i, s in enumerate(seq_ids):
            if s is not None:
                tables[i] = self._table_list(s)
                lengths[i] = self._lengths[s]
        if not isinstance(tokens, torch.Tensor):
            tokens = to_device(np.asarray(
                [t if t is not None else 0 for t in tokens], np.int64),
                self.device)
        return (tokens, to_device(np.asarray(active), self.device),
                to_device(tables, self.device),
                to_device(lengths, self.device))

    def batch_decode_step(self, params, tokens, seq_ids) -> torch.Tensor:
        """One batched step over the shared pool. ``seq_ids`` may hold None
        for inactive slots. Returns (B, V) logits."""
        for s in seq_ids:
            if s is not None:
                self.ensure_capacity(s)
        toks, active, tables, lengths = self._batch_inputs(tokens, seq_ids)
        logits, self.pool_k, self.pool_v = decode_step_batch_paged(
            params, self.cfg, toks, active, self.pool_k, self.pool_v,
            tables, lengths)
        for s in seq_ids:
            if s is not None:
                self._lengths[s] += 1
        return logits

    def batch_decode_steps(self, params, tokens, seq_ids,
                           n_steps: int) -> torch.Tensor:
        """``n_steps`` greedy steps over the shared pool in one chunk with
        no host fetch. Raises DEVICE_OOM before touching the device if the
        pool cannot pre-grow every active slot (the caller falls back to
        the single-step path, which preempts). ``tokens`` is a host list
        (ints, None for inactive slots) or the device (B,) row of the last
        chunk. Returns the produced tokens (n_steps, B) on the device."""
        if self.pages_needed_for(seq_ids, n_steps) > self.free_pages:
            raise TrackieError(ErrorCode.DEVICE_OOM,
                               "KV page pool exhausted")
        for s in seq_ids:
            if s is not None:
                self.ensure_capacity_for(s, n_steps)
        toks, active, tables, lengths = self._batch_inputs(tokens, seq_ids)
        # Page bound of the chunk's gather scratch: the longest active slot
        # and the chunk, in powers of two, at most the whole table.
        max_len = max((self._lengths[s] for s in seq_ids if s is not None),
                      default=0)
        need = -(-(max_len + n_steps) // self.page_size)
        attn_pages = 1
        while attn_pages < need:
            attn_pages *= 2
        attn_pages = min(attn_pages, self.cfg.max_seq // self.page_size)
        produced, self.pool_k, self.pool_v = decode_steps_batch_paged(
            params, self.cfg, toks, active, self.pool_k, self.pool_v,
            tables, lengths, n_steps, attn_pages=attn_pages)
        for s in seq_ids:
            if s is not None:
                self._lengths[s] += n_steps
        return produced

    def _alloc_page(self) -> int:
        if self._free:
            return self._free.pop()
        if self._evictable:
            # Reclaim the least recently cached page: its prefix-cache
            # entry dies with it (only ref-0 pages are evictable).
            page, _ = self._evictable.popitem(last=False)
            key = self._page_to_key.pop(page, None)
            if key is not None:
                self._hash_to_page.pop(key, None)
            self._page_refs.pop(page, None)
            self.prefix_stats["evictions"] += 1
            return page
        raise TrackieError(ErrorCode.DEVICE_OOM, "KV page pool exhausted")

    # -- prefix cache ---------------------------------------------------------

    @staticmethod
    def _chain_key(prev: Any, chunk: Sequence[int]) -> Any:
        # Exact nested-tuple keys, not hashes: a collision would share the
        # wrong pages.
        return (prev, tuple(int(t) for t in chunk))

    def acquire_prefix(self, ids: Sequence[int]) -> Tuple[List[int], int]:
        """The longest cached full-page prefix of ``ids``, its pages'
        refcounts taken at once (out of the evictable list), so no
        allocation before the sequence is created can reclaim them.
        Returns ``(pages, matched_tokens)``; the caller passes the pages to
        :meth:`create_sequence` or gives them back through
        :meth:`release_prefix`. At least one token is left to prefill (the
        admission needs last-token logits)."""
        limit = (len(ids) - 1) // self.page_size
        pages: List[int] = []
        key: Any = None
        for i in range(limit):
            key = self._chain_key(
                key, ids[i * self.page_size:(i + 1) * self.page_size])
            page = self._hash_to_page.get(key)
            if page is None:
                break
            self._page_refs[page] = self._page_refs.get(page, 0) + 1
            self._evictable.pop(page, None)
            pages.append(page)
        if pages:
            self.prefix_stats["hits"] += 1
            self.prefix_stats["tokens_reused"] += len(pages) * self.page_size
        return pages, len(pages) * self.page_size

    def release_prefix(self, pages: Sequence[int]) -> None:
        """Give back refs taken by :meth:`acquire_prefix` without having
        created a sequence."""
        for page in pages:
            self._decref(page)

    def _decref(self, page: int) -> None:
        refs = self._page_refs.get(page)
        if refs is None:
            self._free.append(page)  # a plain owned page
            return
        refs -= 1
        self._page_refs[page] = refs
        if refs <= 0:
            # Stays resident as cache; reclaimable under pressure.
            self._evictable[page] = None
            self._evictable.move_to_end(page)

    def _register_prompt_pages(self, table: List[int], n_shared: int,
                               ids: Sequence[int]) -> None:
        """Register this sequence's full prompt pages in the prefix cache.
        Shared pages only advance the chain key; a fresh full page becomes
        cached (ref 1, this sequence's). Content another sequence already
        registered keeps the first page (this one stays plain-owned)."""
        key: Any = None
        for i in range(len(ids) // self.page_size):
            key = self._chain_key(
                key, ids[i * self.page_size:(i + 1) * self.page_size])
            if i < n_shared:
                continue
            page = table[i]
            if key in self._hash_to_page or page in self._page_to_key:
                continue
            self._hash_to_page[key] = page
            self._page_to_key[page] = key
            self._page_refs[page] = self._page_refs.get(page, 0) + 1

    def create_sequence(self, prefill_cache: Optional[llm_model.KVCache]
                        = None, length: int = 0,
                        shared_pages: Optional[List[int]] = None,
                        register_ids: Optional[Sequence[int]] = None) -> int:
        """A new sequence, optionally seeded from a contiguous prefill.

        ``shared_pages`` (refs from :meth:`acquire_prefix`) cover its first
        ``len(shared_pages) * page_size`` tokens; it reads them and never
        writes them. Only the suffix of ``prefill_cache`` is scattered: the
        shared positions go to the trash page. ``register_ids`` (the prompt
        ids) registers its full prompt pages in the prefix cache."""
        shared = list(shared_pages or [])
        n_shared = len(shared)
        seq_id = self._next_seq
        self._next_seq += 1
        n_pages = max((length + self.page_size - 1) // self.page_size, 1)
        n_fresh = n_pages - n_shared
        if self.free_pages < n_fresh:
            raise TrackieError(ErrorCode.DEVICE_OOM,
                               "KV page pool exhausted")
        fresh = [self._alloc_page() for _ in range(n_fresh)]
        pages = shared + fresh
        self._tables[seq_id] = pages
        self._lengths[seq_id] = length
        if prefill_cache is not None and length > 0:
            write = np.asarray([0] * n_shared + fresh, np.int64)
            self.pool_k, self.pool_v = copy_prefill_into_pages(
                self.cfg, self.pool_k, self.pool_v,
                to_device(write, self.device), prefill_cache)
        if register_ids is not None:
            self._register_prompt_pages(pages, n_shared, register_ids)
        return seq_id

    def gathered_prefix_cache(self, pages: Sequence[int], matched_len: int,
                              total_len: int) -> llm_model.KVCache:
        """Stage a shared prefix into a contiguous cache sized, in
        power-of-two page counts, to also hold ``total_len`` tokens: the
        input of a suffix ``extend``."""
        max_pages = self.cfg.max_seq // self.page_size
        need = max(-(-total_len // self.page_size), 1)
        w = 1
        while w < need:
            w *= 2
        w = min(w, max_pages)
        table = (list(pages) + [0] * (w - len(pages)))[:w]
        return gather_pages_to_cache(
            self.cfg, self.pool_k, self.pool_v,
            to_device(np.asarray(table, np.int64), self.device),
            matched_len, dtype=self.compute_dtype)

    def free_sequence(self, seq_id: int) -> None:
        for page in self._tables.pop(seq_id, []):
            self._decref(page)
        self._lengths.pop(seq_id, None)

    def length(self, seq_id: int) -> int:
        return self._lengths[seq_id]

    def _table_list(self, seq_id: int) -> List[int]:
        """The fixed-width table: live pages, then the last page repeated
        (never read: the length masks it)."""
        pages = self._tables[seq_id]
        max_pages = self.cfg.max_seq // self.page_size
        return pages + [pages[-1]] * (max_pages - len(pages))

    # -- decode ----------------------------------------------------------------

    def decode_step(self, params, token: int, seq_id: int) -> torch.Tensor:
        """One token of one sequence; grows its table at a page boundary."""
        self.ensure_capacity(seq_id)
        length = self._lengths[seq_id]
        table = to_device(np.asarray(self._table_list(seq_id), np.int64),
                          self.device)
        logits, self.pool_k, self.pool_v = decode_step_paged(
            params, self.cfg, token, self.pool_k, self.pool_v, table, length)
        self._lengths[seq_id] = length + 1
        return logits
