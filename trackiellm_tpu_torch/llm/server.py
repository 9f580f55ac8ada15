"""Continuous-batching LLM server: many conversations, one decode loop.

Port of ``trackiellm_tpu/llm/server.py``:

  - a fixed number of batch slots share one ``BatchedKVCache`` (dense) or
    one page pool (``llm/paging.py``: elastic, int8 cells, prefix cache);
  - new requests prefill in admission waves (``prefill_batch``, padded to
    a power of two) or, past ``prefill_chunk`` tokens, one extend chunk a
    serve iteration, and take a free slot between decode steps;
  - ``decode_step_batch`` advances every active slot a step; when every
    active request is greedy, ``chunk_steps`` steps run as one chunk with
    the argmax fed back on the device, and the next chunk is dispatched
    before the last one's tokens are fetched;
  - finished slots (EOS, budget, stop string, grammar closed) free at
    once; pool pressure preempts a slot to the backlog.

Sampling is greedy or per request (temperature, top-k, top-p, min-p,
repetition window) with a ``torch.Generator`` on the server's device;
grammar-constrained requests pick under the port's ``llm/grammar.py``
masks. The serve thread runs on the params' device and never moves work
to another one. ``model=`` serves another module with the same surface
(``models/mla.py``, ``models/mamba.py``) over dense slots; ``mesh=``
serves tensor-parallel, one server a rank, on the plans rank 0 broadcasts.
"""

from __future__ import annotations

import codecs
import collections
import contextlib
import dataclasses
import logging
import os
import queue
import threading
import time
from concurrent.futures import Future
from typing import Any, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from trackiellm_tpu_torch.llm import sampling
from trackiellm_tpu_torch.llm.grammar import JsonGrammar, ToolCallGrammar
from trackiellm_tpu_torch.llm.paging import PagedKVPool, to_device
from trackiellm_tpu_torch.llm.runner import (EXTEND_BUCKETS,
                                             PREFILL_BUCKETS, _bucket_for,
                                             check_tokenizer)
from trackiellm_tpu_torch.llm.tokenizer import ByteTokenizer, Tokenizer
from trackiellm_tpu_torch.models import llm as llm_model
from trackiellm_tpu_torch.utils.errors import ErrorCode, TrackieError

log = logging.getLogger("trackiellm_tpu_torch.llm.server")


@dataclasses.dataclass
class Request:
    prompt: str
    max_tokens: int = 64
    temperature: float = 0.0
    repetition_penalty: float = 1.1   # llama.cpp default; sampled path only
    repeat_window: int = 64
    future: Future = dataclasses.field(default_factory=Future)
    submitted_at: float = dataclasses.field(default_factory=time.monotonic)
    preemptions: int = 0  # paged mode: restarts after pool pressure
    # Streaming: called from the serve thread with each new text piece
    # (chunk granularity on the chunked path). Exceptions are logged and
    # the callback dropped; the future still resolves with the full text.
    on_token: Optional[Any] = None
    # UTF-8 incremental decoder: byte tokens split multibyte characters,
    # so streamed pieces are buffered to concatenate to the final text.
    _decoder: Optional[Any] = None
    # Structured output: a valid tool call naming one of these tools
    # (``tool_schemas`` types each tool's arguments), or valid JSON
    # conforming to ``response_schema`` (any object with ``json_mode``).
    # Constrained slots decode on the per-step path.
    tool_names: Optional[List[str]] = None
    tool_schemas: Optional[Dict[str, Any]] = None
    response_schema: Optional[Dict[str, Any]] = None
    json_mode: bool = False
    # Stop strings: generation ends at the first occurrence of any; the
    # result is cut BEFORE it, and streaming holds back max(len(stop)) - 1
    # characters so no fragment of a match is streamed.
    stop: Optional[List[str]] = None
    # Sampling knobs of temperature > 0 slots (llama.cpp defaults).
    top_k: int = 40
    top_p: float = 0.95
    min_p: float = 0.0
    # The request's id in the serve loop's plans, its prompt ids, and
    # whether a plan said it was cancelled (the loop reads this flag,
    # never the future: under a mesh every rank reads the same one).
    rid: int = -1
    ids: Optional[List[int]] = None
    dropped: bool = False


# The Request fields a plan carries (to the other ranks under a mesh), and
# how many of the plans that carried anything a server keeps (``plans``).
PLAN_LOG = 1024
_PLAN_FIELDS = ("rid", "prompt", "ids", "max_tokens", "temperature",
                "repetition_penalty", "repeat_window", "tool_names",
                "tool_schemas", "response_schema", "json_mode", "stop",
                "top_k", "top_p", "min_p")


@dataclasses.dataclass
class _Slot:
    request: Optional[Request] = None
    generated: List[int] = dataclasses.field(default_factory=list)
    n_emitted: int = 0
    next_token: int = 0
    host_len: int = 0  # the host's copy of the slot's cache length
    seq_id: Optional[int] = None  # paged mode: the pool's sequence handle
    grammar: Optional[Any] = None  # acceptor of a constrained slot
    finish_next: bool = False  # grammar closed: emit next_token, then end
    reserved: bool = False  # held by an in-flight chunked-prefill job
    # Stop-string state (kept only when request.stop is set): the decoded
    # text, the index to cut it at on a match, the characters streamed,
    # and the slot's own UTF-8 decoder.
    text: str = ""
    stop_cut: Optional[int] = None
    streamed: int = 0
    _decoder: Optional[Any] = None
    # Device copies of the grammar's masks, by the identity of the list
    # token_mask returns (kept here so the list stays alive).
    masks: Dict[int, tuple] = dataclasses.field(default_factory=dict)

    @property
    def active(self) -> bool:
        return self.request is not None


@dataclasses.dataclass
class _PrefillJob:
    """An admission whose prompt prefills one extend chunk a serve
    iteration (Sarathi-style chunked prefill), so active slots keep
    decoding between its chunks."""
    slot_idx: int
    slot: _Slot
    req: Request
    ids: List[int]
    cache: Any              # contiguous scratch KVCache
    attn_len: Optional[int]
    plan: List[Any]         # remaining (take, bucket) chunks
    pos: int                # tokens ingested so far
    shared: List[int]       # prefix-cache page refs (paged mode)
    logits: Any = None


class _Chunk(NamedTuple):
    """A dispatched k-step chunk: its (k, B) tokens on the device, and
    their host copy with the event that marks it complete (None on the
    CPU, where the copy is the tensor)."""
    tokens: torch.Tensor
    host: torch.Tensor
    ready: Optional[Any]


class LLMServer:
    """Fixed-slot continuous-batching server over a parameter tree."""

    def __init__(self, params: Dict[str, Any], cfg: llm_model.LLMConfig,
                 batch_slots: int = 4,
                 tokenizer: Optional[Tokenizer] = None,
                 cache_dtype: torch.dtype = torch.bfloat16, seed: int = 0,
                 paged="auto", n_pages: int = 0,
                 page_size: int = 128, chunk_steps: int = 8,
                 kv_memory_budget_bytes: Optional[int] = None,
                 mesh=None, prefix_cache: bool = True,
                 prefill_chunk: int = 0, model=None, device=None):
        """``cache_dtype=torch.int8`` stores the KV pool quantized (paged
        mode only). ``device`` defaults to the params' device.

        ``model``: the module serving the checkpoint, any module with
        ``models/llm.py``'s forward surface (``prefill``, ``extend``,
        ``decode_step_batch``, ``decode_steps_batch``, ``KVCache``,
        ``BatchedKVCache``, ``insert_sequence``); by default
        ``models.llm``. ``models.mla`` serves DeepSeek-V2/V3 over the
        compressed latent cache, ``models.mamba`` the recurrent state.
        Another module serves over dense slots only (the page pool is
        written against the (S, Hk, D) layout), and without
        ``prefill_batch`` each request of a wave prefills on its own.

        ``mesh``: a ``parallel.mesh.Mesh`` serves tensor-parallel, one
        server a rank. ``params`` is the full tree (each rank cuts its
        shard, ``parallel/infer.py:shard_params``) or a rank's cut (it
        holds ``vocab_shard``); ``cfg`` is the model's. Dense slots by
        default; ``paged=True`` gives a pool of the rank's KV heads, int8
        included; ``models.mla`` serves on dense latent slots. Rank 0 takes
        :meth:`submit`; every serve iteration it broadcasts its plan (the
        requests that arrived with their prompt ids and sampling knobs,
        the ones cancelled, stop; with new requests every rank's knobs are
        checked against rank 0's) before any device work, and every rank
        runs the same loop on it, so every host decision (waves, slots,
        chunks, preemption, prefix hits, sampled tokens) is the same on
        every rank and they enter the same collectives. The other ranks
        serve until rank 0's :meth:`close`; their :meth:`close` waits for
        it."""
        self._m = model or llm_model
        self.mesh = mesh
        self.shard_report: Dict[str, dict] = {}
        if self._m is not llm_model:
            if paged is True:
                raise TrackieError(
                    ErrorCode.INVALID_ARGUMENT,
                    "paged KV supports the default models.llm only")
            if mesh is not None and type(cfg).__name__ != "MLAConfig":
                raise TrackieError(
                    ErrorCode.INVALID_ARGUMENT,
                    "mesh serving supports models.llm and models.mla only")
            paged = False
        check_tokenizer(tokenizer or ByteTokenizer(cfg.vocab_size), cfg)
        if mesh is not None:
            from trackiellm_tpu_torch.parallel import infer

            if paged == "auto":
                paged = False  # dense slots under a mesh, as the reference
            if "vocab_shard" in params or mesh.tp == 1:
                cfg = infer.local_config(cfg, mesh.tp)
            else:
                params, cfg, self.shard_report = infer.shard_params(
                    params, cfg, mesh)
        if self._m is llm_model:
            llm_model.check_supported(cfg, params)
        self.params = params
        self.cfg = cfg
        self.batch = batch_slots
        dev = torch.device(device or params["tok_emb"].device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        if params["tok_emb"].device != dev:
            raise ValueError(f"params live on {params['tok_emb'].device}, "
                             f"server device is {dev}")
        self._device = dev
        if cache_dtype == torch.int8:
            # Quantized KV lives in the page pool only; there is no dense
            # int8 slot cache.
            if paged is False:
                raise TrackieError(ErrorCode.INVALID_ARGUMENT,
                                   "int8 KV requires paged mode")
            paged = True
        if paged == "auto":
            # Dense slot caches when they fit the KV budget, the page pool
            # when memory demands it. The default budget is the JAX
            # package's 8 GiB, so "auto" chooses as it does for the same
            # configuration.
            itemsize = torch.empty((), dtype=cache_dtype).element_size()
            dense_bytes = (2 * cfg.n_layers * batch_slots * cfg.max_seq
                           * cfg.n_kv_heads * cfg.head_dim * itemsize)
            budget = kv_memory_budget_bytes or (8 << 30)
            paged = dense_bytes > budget
        # Steady state: when every active request is greedy and no work is
        # waiting, this many decode steps run as one chunk with one host
        # fetch. 1 disables chunking.
        self.chunk_steps = max(1, int(chunk_steps))
        self.tokenizer = tokenizer or ByteTokenizer(cfg.vocab_size)
        self.paged = paged
        # Prefix caching (paged mode only): full prompt pages register in
        # the pool's hash chain; a later request sharing the prefix reuses
        # those pages and prefills only its suffix.
        self.prefix_cache = bool(prefix_cache) and bool(paged)
        # Chunked prefill: prompts longer than this admit through a
        # _PrefillJob, one extend chunk a serve iteration between decode
        # work. 0 = off (whole-prompt admission waves).
        self.prefill_chunk = max(0, int(prefill_chunk))
        self._prefill_job: Optional[_PrefillJob] = None
        if paged:
            if n_pages <= 0:
                n_pages = batch_slots * (cfg.max_seq // page_size) // 2 + 1
            self.pool = PagedKVPool(cfg, n_pages=n_pages,
                                    page_size=page_size, dtype=cache_dtype,
                                    device=dev)
            self.cache = None
        else:
            self.pool = None
            self.cache = self._m.BatchedKVCache.create(
                cfg, batch_slots, dtype=cache_dtype, device=dev)
        self._slots = [_Slot() for _ in range(batch_slots)]
        self._queue: "queue.Queue[Request]" = queue.Queue()
        # The requests the plans delivered, in order (the serve loop's
        # queue), rank 0's requests by id until they end, and the last
        # plans this rank made or received that carried anything.
        self._arrived: List[Request] = []
        self._live: Dict[int, Request] = {}
        self._next_rid = 0
        self._stopping = False
        self.plans: "collections.deque[dict]" = collections.deque(
            maxlen=PLAN_LOG)
        self._backlog: List[Request] = []  # OOM-deferred, retried first
        # Requests popped from the queue but not yet bound to a slot (an
        # admission wave in flight): the death path fails these too.
        self._inflight: List[Request] = []
        self._fatal: Optional[Exception] = None
        self._gen = torch.Generator(device=dev)
        self._gen.manual_seed(seed)
        self._seed, self._cache_dtype = seed, cache_dtype
        self.stats = {"completed": 0, "decode_steps": 0, "tokens": 0}
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._serve_loop,
                                        daemon=True, name="llm-server")
        self._thread.start()

    # ------------------------------------------------------------------

    def submit(self, prompt: str, max_tokens: int = 64,
               temperature: float = 0.0,
               repetition_penalty: float = 1.1,
               on_token=None, tool_names=None, tool_schemas=None,
               response_schema=None, json_mode: bool = False,
               stop=None, top_k: int = 40, top_p: float = 0.95,
               min_p: float = 0.0) -> Future:
        """Enqueue a generation; the Future resolves to the text.

        ``on_token``: an optional callable(text_piece) streamed from the
        serve thread as tokens decode; keep it cheap.

        Fails fast once the serve thread has exited, by close() or by a
        fatal error."""
        if self.mesh is not None and self.mesh.rank != 0:
            raise RuntimeError("a tensor-parallel server takes requests on "
                               "rank 0 only")
        if self._fatal is not None:
            raise RuntimeError(
                f"server serve loop died: {self._fatal}") from self._fatal
        if self._stop.is_set() or not self._thread.is_alive():
            raise RuntimeError("server is closed")
        stop = [s for s in (stop or []) if s]
        req = Request(prompt, max_tokens, temperature,
                      repetition_penalty=repetition_penalty,
                      on_token=on_token, tool_names=tool_names,
                      tool_schemas=tool_schemas,
                      response_schema=response_schema, json_mode=json_mode,
                      stop=stop or None, top_k=top_k, top_p=top_p,
                      min_p=min_p)
        self._queue.put(req)
        return req.future

    def generate(self, prompt: str, max_tokens: int = 64,
                 temperature: float = 0.0, timeout: float = 300.0,
                 repetition_penalty: float = 1.1,
                 tool_names=None, tool_schemas=None,
                 response_schema=None, json_mode: bool = False,
                 stop=None, top_k: int = 40, top_p: float = 0.95,
                 min_p: float = 0.0) -> str:
        return self.submit(prompt, max_tokens, temperature,
                           repetition_penalty,
                           tool_names=tool_names, tool_schemas=tool_schemas,
                           response_schema=response_schema,
                           json_mode=json_mode, stop=stop, top_k=top_k,
                           top_p=top_p, min_p=min_p).result(timeout)

    # ------------------------------------------------------------------

    def _ids(self, ids) -> torch.Tensor:
        return to_device(np.asarray(ids, np.int64), self._device)

    def _next_request(self) -> Optional[Request]:
        """Pop the next waiting request and track it as in flight until
        :meth:`_settle` binds it to a slot (or it fails or is backlogged),
        so the death path can fail it. The waiting requests are those the
        plans delivered (:meth:`_sync`)."""
        if self._backlog:
            req = self._backlog.pop(0)
        elif self._arrived:
            req = self._arrived.pop(0)
        else:
            return None
        self._inflight.append(req)
        return req

    def _sync(self) -> bool:
        """One plan: rank 0 (the only rank without a mesh) drains its
        queue (prompt ids encoded here), collects the requests whose
        futures were cancelled and its stop flag; under a mesh it
        broadcasts them, and every rank's knobs are checked when requests
        arrive (:meth:`_check_knobs`). Every rank then queues the new
        requests and marks the cancelled ones (``Request.dropped``, the one
        flag the loop reads). False once the plan says stop."""
        plan = reqs = None
        if self.mesh is None or self.mesh.rank == 0:
            reqs = []
            while True:
                try:
                    req = self._queue.get_nowait()
                except queue.Empty:
                    break
                req.rid = self._next_rid
                self._next_rid += 1
                req.ids = self.tokenizer.encode(req.prompt, add_bos=True)
                self._live[req.rid] = req
                reqs.append(req)
            cancel = [rid for rid, req in self._live.items()
                      if req.future.cancelled()]
            for rid in [rid for rid, req in self._live.items()
                        if req.future.done()]:
                del self._live[rid]
            plan = {"new": [{f: getattr(r, f) for f in _PLAN_FIELDS}
                            for r in reqs],
                    "cancel": cancel, "stop": self._stop.is_set()}
        if self.mesh is not None:
            plan = self.mesh.broadcast_object(plan, src=0)
        if reqs is None:
            reqs = [Request(**n) for n in plan["new"]]
        if plan["new"] or plan["cancel"] or plan["stop"]:
            self.plans.append(plan)
        self._arrived.extend(reqs)   # the death path fails them from here
        if self.mesh is not None and reqs:
            self._check_knobs()
        if plan["cancel"]:
            gone = set(plan["cancel"])
            for req in self._tracked():
                if req.rid in gone:
                    req.dropped = True
        return not plan["stop"]

    def _tracked(self) -> List[Request]:
        """Every request the serve loop holds: waiting, in flight, in a
        slot or in the chunked-prefill job."""
        out = list(self._arrived) + list(self._backlog) + list(self._inflight)
        out += [s.request for s in self._slots if s.request is not None]
        if self._prefill_job is not None:
            out.append(self._prefill_job.req)
        return out

    def _untrack(self, req: Optional[Request]) -> None:
        try:
            self._inflight.remove(req)
        except ValueError:
            pass

    def _admit(self) -> None:
        """Fill free slots from the queue (prefill, then slot insert).

        Paged mode admits only while the pool has pages for the whole
        prompt and one decode page; a request that does not fit waits in
        the backlog and retries as pages free up. Greedy first tokens are
        fetched once per admission wave, after every prefill of the wave
        has been dispatched."""
        pending = []  # (slot, greedy logits) awaiting the wave's fetch

        def flush():
            if not pending:
                return
            ids = torch.stack([lg for _, lg in pending]).argmax(-1).tolist()
            for (slot, _), tid in zip(pending, ids):
                slot.next_token = int(tid)
            pending.clear()

        buckets = [b for b in PREFILL_BUCKETS if b <= self.cfg.max_seq]
        kv_dtype = (self.pool.compute_dtype if self.paged
                    else self.cache[0].dtype)

        # Phase 1: gather the admission wave (admission control only).
        wave = []  # (slot_idx, slot, req, ids, bucket)
        for slot_idx, slot in enumerate(self._slots):
            if slot.active or slot.reserved:
                continue
            req = self._next_request()
            while req is not None and req.dropped:
                self._untrack(req)  # dropped before admission
                req = self._next_request()
            if req is None:
                break
            ids = list(req.ids)
            if self.paged:
                need = (len(ids) + self.pool.page_size - 1
                        ) // self.pool.page_size + 1
                reserved = sum(
                    (len(w[3]) + self.pool.page_size - 1)
                    // self.pool.page_size + 1 for w in wave)
                if self.pool.free_pages - reserved < need:
                    if need > self.pool.n_pages - 1:
                        # Can never fit, even in an empty pool: reject.
                        self._untrack(req)
                        req.future.set_exception(TrackieError(
                            ErrorCode.DEVICE_OOM,
                            f"prompt needs {need} KV pages, pool has "
                            f"{self.pool.n_pages - 1}"))
                        continue
                    self._untrack(req)
                    self._backlog.insert(0, req)
                    break
            limit = min(buckets[-1], self.cfg.max_seq - req.max_tokens - 1)
            if limit < 1:
                # max_tokens leaves no room for even one prompt token: fail
                # the one request, not the server.
                self._untrack(req)
                req.future.set_exception(TrackieError(
                    ErrorCode.CONTEXT_OVERFLOW,
                    f"max_tokens={req.max_tokens} leaves no prompt room "
                    f"in a {self.cfg.max_seq}-token context"))
                continue
            if len(ids) > limit:
                head = limit // 4
                ids = ids[:head] + ids[-(limit - head):]
            # Long prompts take the chunked-prefill job (one at a time)
            # when it is on; everything else admits in the wave below.
            if (self.prefill_chunk and self._prefill_job is None
                    and len(ids) > self.prefill_chunk
                    and self._start_prefill_job(slot_idx, slot, req, ids)):
                self._untrack(req)  # the job owns it now
                continue
            wave.append((slot_idx, slot, req, ids,
                         _bucket_for(len(ids), buckets)))

        # Phase 2: prefill. Same-bucket groups of >= 2 run as one
        # prefill_batch (each weight read once for the group), padded to a
        # power of two with length-0 rows so the shapes stay few; a single
        # takes the plain prefill, the interactive runner's route.
        def settle(slot_idx, slot, req, ids, logits, seq_cache, shared=()):
            self._settle(slot_idx, slot, req, ids, logits, seq_cache,
                         shared=shared, pending=pending)

        # Prefix-cache hits leave the grouped path: the shared pages are
        # staged once and only the suffix runs (extend).
        by_bucket: Dict[int, list] = {}
        for item in wave:
            slot_idx, slot, req, ids, bucket = item
            if self.prefix_cache:
                shared, matched = self.pool.acquire_prefix(ids)
                if shared:
                    try:
                        staged = self._prefill_suffix(ids, shared, matched)
                        if staged is not None:
                            logits, seq_cache = staged
                            settle(slot_idx, slot, req, ids, logits,
                                   seq_cache, shared=shared)
                            continue
                        # Padded suffix writes cannot fit the context:
                        # give the refs back, take the plain path.
                        self.pool.release_prefix(shared)
                    except TrackieError:
                        self.pool.release_prefix(shared)
                        raise
            by_bucket.setdefault(bucket, []).append(item)

        for bucket, group in by_bucket.items():
            # A module without prefill_batch (models.mla, models.mamba)
            # admits one prefill a request.
            if len(group) == 1 or not hasattr(self._m, "prefill_batch"):
                for slot_idx, slot, req, ids, _ in group:
                    padded = np.zeros(bucket, np.int64)
                    padded[: len(ids)] = ids
                    logits, seq_cache = self._m.prefill(
                        self.params, self.cfg, self._ids(padded), len(ids),
                        self._m.KVCache.create(self.cfg, dtype=kv_dtype,
                                               device=self._device))
                    settle(slot_idx, slot, req, ids, logits, seq_cache)
                continue
            b_pad = 1 << (len(group) - 1).bit_length()
            padded = np.zeros((b_pad, bucket), np.int64)
            lengths = np.zeros(b_pad, np.int32)
            for row, (_, _, _, ids, _) in enumerate(group):
                padded[row, : len(ids)] = ids
                lengths[row] = len(ids)
            logits_b, caches_b = self._m.prefill_batch(
                self.params, self.cfg, self._ids(padded),
                to_device(lengths, self._device), cache_dtype=kv_dtype)
            for row, (slot_idx, slot, req, ids, _) in enumerate(group):
                seq_cache = self._m.KVCache(caches_b.k[row], caches_b.v[row],
                                            len(ids))
                settle(slot_idx, slot, req, ids, logits_b[row], seq_cache)
        flush()

    def _settle(self, slot_idx, slot, req, ids, logits, seq_cache,
                shared=(), pending=None):
        """Bind a finished prefill to its slot: the pool's sequence (its
        pages written, its prompt pages registered) or the dense slot
        insert, then the bookkeeping and the first token. With ``pending``
        (an admission wave) a greedy first token waits for the wave's one
        fetch; without it, it is fetched here."""
        if self.paged:
            slot.seq_id = self.pool.create_sequence(
                prefill_cache=seq_cache, length=len(ids),
                shared_pages=list(shared),
                register_ids=ids if self.prefix_cache else None)
        else:
            self.cache = self._m.insert_sequence(
                self.cache, self.cfg, slot_idx, seq_cache)
        slot.request = req
        self._untrack(req)  # the slot owns it now
        slot.generated = []
        slot.n_emitted = 0
        slot.host_len = len(ids)
        slot.grammar = None
        slot.finish_next = False
        slot.text = ""
        slot.stop_cut = None
        slot.streamed = 0
        slot._decoder = None
        slot.masks = {}
        if req.tool_names:
            slot.grammar = ToolCallGrammar(list(req.tool_names),
                                           req.tool_schemas)
            slot.next_token = self._pick_constrained(slot, logits)
        elif req.response_schema is not None or req.json_mode:
            slot.grammar = JsonGrammar(req.response_schema)
            slot.next_token = self._pick_constrained(slot, logits)
        elif req.temperature <= 0:
            if pending is None:
                slot.next_token = int(torch.argmax(logits))
            else:
                pending.append((slot, logits))  # fetched by the wave
        else:
            slot.next_token = self._sample_one(logits, req, [])

    def _suffix_chunk_plan(self, matched: int, total: int, cap: int = 0):
        """Exact-fill extend-chunk plan for prefilling ``[matched,
        total)``: each chunk takes the largest extend bucket that fits the
        remainder (only the last chunk pads), at most ``cap`` tokens a
        chunk when given. Returns ``(plan, required)``: the (take, bucket)
        chunks, and the furthest padded write end, the least staged-cache
        capacity that holds every chunk's padded rows."""
        buckets = ([b for b in EXTEND_BUCKETS if b <= cap] if cap
                   else list(EXTEND_BUCKETS))
        if not buckets:
            buckets = [EXTEND_BUCKETS[0]]
        plan = []
        pos = matched
        while pos < total:
            remaining = total - pos
            take = max((b for b in buckets if b <= remaining),
                       default=remaining)
            plan.append((take, _bucket_for(take, buckets)))
            pos += take
        required = matched
        pos = matched
        for take, bucket in plan:
            required = max(required, pos + bucket)
            pos += take
        return plan, required

    def _prefill_suffix(self, ids, shared, matched_len):
        """Prefix-cache admission: stage the shared pages into a contiguous
        scratch cache (one copy, no products) and chunk-prefill only the
        uncached suffix over it with ``extend``. Returns (last-valid
        logits, cache), as ``prefill``, or None when the padded chunk
        writes cannot fit the context (the caller prefills the whole
        prompt); ``create_sequence`` scatters the cache's suffix into
        fresh pages."""
        plan, required = self._suffix_chunk_plan(matched_len, len(ids))
        if required > self.cfg.max_seq:
            return None
        cache = self.pool.gathered_prefix_cache(shared, matched_len,
                                                required)
        attn_len = cache.k.shape[1]  # page-bucketed capacity
        logits = None
        pos = matched_len
        for take, bucket in plan:
            padded = np.zeros(bucket, np.int64)
            padded[:take] = ids[pos:pos + take]
            logits, cache = self._m.extend(
                self.params, self.cfg, self._ids(padded), take, cache,
                attn_len=attn_len)
            pos += take
        return logits, cache

    # -- chunked prefill (Sarathi-style admission) -----------------------

    def _start_prefill_job(self, slot_idx: int, slot: _Slot, req: Request,
                           ids: List[int]) -> bool:
        """Reserve ``slot`` and stage a chunked-prefill job for a long
        prompt. False when the padded chunk writes cannot fit the context
        (the caller admits it in the wave)."""
        shared: List[int] = []
        matched = 0
        if self.prefix_cache:
            shared, matched = self.pool.acquire_prefix(ids)
        plan, required = self._suffix_chunk_plan(
            matched, len(ids), cap=self.prefill_chunk)
        if required > self.cfg.max_seq:
            if shared:
                self.pool.release_prefix(shared)
            return False
        if self.paged:
            # Stages the shared prefix (or, on a miss, a length-0 scratch
            # gathered from the trash page) in one copy.
            cache = self.pool.gathered_prefix_cache(shared, matched,
                                                    required)
            attn_len = cache.k.shape[1]
        else:
            cache = self._m.KVCache.create(self.cfg, dtype=self.cache[0].dtype,
                                           device=self._device)
            attn_len = min(1 << (max(required, 1) - 1).bit_length(),
                           self.cfg.max_seq)
        slot.reserved = True
        self._prefill_job = _PrefillJob(slot_idx, slot, req, ids, cache,
                                        attn_len, plan, matched, shared)
        return True

    def _abort_prefill_job(self, exc: Optional[Exception]) -> None:
        """Drop the in-flight job: unreserve its slot, give back its
        prefix refs, and fail its future with ``exc`` (None: cancelled)."""
        job = self._prefill_job
        self._prefill_job = None
        if job is None:
            return
        job.slot.reserved = False
        if job.shared and self.paged:
            self.pool.release_prefix(job.shared)
        if exc is not None:
            self._fail(job.req, exc)

    def _advance_prefill(self) -> None:
        """Run one extend chunk of the in-flight job (once a serve
        iteration, between decode work); settle the slot when the plan is
        done."""
        job = self._prefill_job
        if job.req.dropped:
            self._abort_prefill_job(None)
            return
        take, bucket = job.plan[0]
        padded = np.zeros(bucket, np.int64)
        padded[:take] = job.ids[job.pos:job.pos + take]
        job.logits, job.cache = self._m.extend(
            self.params, self.cfg, self._ids(padded), take, job.cache,
            attn_len=job.attn_len)
        job.pos += take
        job.plan = job.plan[1:]
        self.stats["prefill_chunks"] = self.stats.get("prefill_chunks",
                                                      0) + 1
        if job.plan:
            return
        self._prefill_job = None
        job.slot.reserved = False
        try:
            self._settle(job.slot_idx, job.slot, job.req, job.ids,
                         job.logits, job.cache, shared=job.shared)
        except TrackieError as exc:
            # Pool pressure at sequence creation (decode grew tables while
            # the job ran): back off to the backlog, fail after 3 tries.
            if job.shared:
                self.pool.release_prefix(job.shared)
            job.req.preemptions += 1
            if job.req.preemptions > 3:
                job.req.future.set_exception(exc)
            else:
                self._backlog.append(job.req)

    def _grammar_mask(self, slot: _Slot) -> torch.Tensor:
        """The slot grammar's (V,) token mask on the device; ``token_mask``
        returns one shared list per grammar state, copied once."""
        mask = slot.grammar.token_mask(self.tokenizer)
        hit = slot.masks.get(id(mask))
        if hit is None or hit[0] is not mask:
            hit = (mask, to_device(np.asarray(mask, bool), self._device))
            slot.masks[id(mask)] = hit
        return hit[1]

    def _pick_constrained(self, slot: _Slot, logits: torch.Tensor) -> int:
        """Choose the next token under the slot's grammar mask (greedy or
        sampled), feed its text to the acceptor, and arm finish_next when
        the grammar closes."""
        mask = self._grammar_mask(slot)
        req = slot.request
        if req.temperature <= 0:
            tid = int(sampling.greedy(logits, mask))
        else:
            tid = int(sampling.sample(
                logits, self._gen, req.temperature, mask=mask,
                top_k=req.top_k, top_p=req.top_p, min_p=req.min_p))
        slot.grammar.feed_text(self.tokenizer.decode_token(tid))
        if slot.grammar.done:
            slot.finish_next = True
        return tid

    def _sample_one(self, logits: torch.Tensor, req: Request,
                    recent: List[int]) -> int:
        if req.temperature <= 0:
            return int(sampling.greedy(logits))
        # Repetition penalty over a fixed-width window of the slot's
        # recent tokens (-1 padded).
        window = np.full(req.repeat_window, -1, np.int64)
        tail = recent[-req.repeat_window:]
        window[: len(tail)] = tail
        return int(sampling.sample(
            logits, self._gen, req.temperature,
            top_k=req.top_k, top_p=req.top_p, min_p=req.min_p,
            recent_tokens=self._ids(window),
            repetition_penalty=req.repetition_penalty))

    def _ensure_decode_capacity(self) -> None:
        """Grow each active sequence's table before the batched step; on
        pool exhaustion preempt only the affected slot (its pages freed,
        its request restarted from the backlog). A slot that cannot make
        progress even alone, or is preempted more than 3 times, fails its
        own future."""
        for slot in self._slots:
            if not slot.active:
                continue
            try:
                self.pool.ensure_capacity(slot.seq_id)
            except TrackieError as exc:
                req = slot.request
                slot.request = None
                self.pool.free_sequence(slot.seq_id)
                slot.seq_id = None
                others_active = any(s.active for s in self._slots)
                req.preemptions += 1
                if not others_active or req.preemptions > 3:
                    req.future.set_exception(exc)
                    log.warning("request failed after %d preemptions: %s",
                                req.preemptions, exc)
                else:
                    log.info("preempting slot (pool pressure), retrying "
                             "request (%d preemptions)", req.preemptions)
                    self._backlog.append(req)

    def _finish(self, slot: _Slot) -> None:
        req = slot.request
        if req is not None:
            self._commit_token(slot, req, -1, final=True)  # flush the tail
        text = self.tokenizer.decode(slot.generated)
        if slot.stop_cut is not None:
            text = text[: slot.stop_cut]  # cut BEFORE the stop string
        if slot.grammar is not None and not slot.grammar.done:
            # Budget exhausted mid-structure: emit the grammar's shortest
            # valid closure, so the reply is never invalid JSON.
            closure = slot.grammar.closure()
            if closure and slot.grammar.feed_text(closure):
                text += closure
        slot.grammar = None
        slot.finish_next = False
        slot.request = None
        if self.paged and slot.seq_id is not None:
            self.pool.free_sequence(slot.seq_id)  # pages return at once
            slot.seq_id = None
        self.stats["completed"] += 1
        if req and not req.future.cancelled():
            req.future.set_result(text)

    def _can_chunk(self, offset: int = 0) -> bool:
        """True when a full chunk_steps chunk is safe: every active request
        greedy and unconstrained with chunk_steps of both token budget and
        cache room, no admittable work waiting (waiting requests block
        chunking only while a slot is free to take them), and in paged
        mode enough free pages to pre-grow every table. Always exactly
        chunk_steps steps or none.

        ``offset`` > 0 asks about a chunk dispatched while ``offset``
        earlier steps are in flight (the pipelined path): budgets are
        taken as if every active slot survives those steps. If one does
        not, the chunk's rows for it are junk, as the positions after EOS
        inside a chunk are, and are discarded. The page check adds no
        offset: pool lengths advance at dispatch."""
        if self.chunk_steps <= 1:
            return False
        if ((self._arrived or self._backlog)
                and any(not s.active and not s.reserved
                        for s in self._slots)):
            return False
        k = self.chunk_steps
        for slot in self._slots:
            if not slot.active:
                continue
            req = slot.request
            if (req.temperature > 0
                    or slot.grammar is not None
                    or req.max_tokens - (slot.n_emitted + offset) < k
                    or self.cfg.max_seq - 1 - (slot.host_len + offset) < k):
                return False
        if self.paged:
            seq_ids = [s.seq_id if s.active else None for s in self._slots]
            if (self.pool.pages_needed_for(seq_ids, k)
                    > self.pool.free_pages):
                return False  # the single-step path owns OOM and preemption
        return True

    def _decode_chunk(self) -> None:
        """chunk_steps greedy steps as one chunk and one host fetch, with
        the single-step path's per-token bookkeeping.

        Chunks pipeline: while chunk N's (k, B) tokens are copied to the
        host, chunk N+1 is already dispatched on chunk N's last token row
        on the device. That dispatch assumes no slot finishes inside chunk
        N (``_can_chunk(offset=k)``); when one does, the in-flight chunk's
        rows are junk for that slot only: a dense slot's rows are
        rewritten when it is reused, a paged slot's junk lands in its own
        pages, and the device runs every later prefill after the in-flight
        chunk."""
        k = self.chunk_steps
        produced = self._dispatch_chunk(
            [s.next_token if s.active else None for s in self._slots])
        # Exactly one chunk is in flight at every check, so the offset
        # stays k. An in-flight chunked-prefill job leaves the loop, so
        # the serve iteration comes back to advance it. Each check first
        # takes a plan (new requests end the pipelining; a stop is kept
        # for the serve loop).
        while (self._prefill_job is None and self._sync_in_chunk()
               and self._can_chunk(offset=k)):
            in_flight = self._dispatch_chunk(produced.tokens[k - 1])
            survived = self._consume_chunk(self._fetched(produced))
            if not survived:
                # A slot finished inside the consumed chunk: the in-flight
                # chunk is junk for it (skipped, as it is inactive now) but
                # valid for the others.
                self._consume_chunk(self._fetched(in_flight))
                return
            produced = in_flight
        self._consume_chunk(self._fetched(produced))

    def _sync_in_chunk(self) -> bool:
        """A plan inside the chunk loop. A stop ends the loop, and the
        serve loop after it."""
        if not self._sync():
            self._stopping = True
        return not self._stopping

    def _dispatch_chunk(self, tokens) -> _Chunk:
        """Dispatch one k-step chunk and start the copy of its (k, B)
        tokens to the host; ``tokens`` is a host list (the first chunk) or
        the device (B,) row of the last chunk (pipelined).

        TRACKIE_DENSE_CHUNK_ATTN=1 bounds dense chunks' KV reads by a
        power-of-two ``attn_len`` covering every slot's live context, the
        chunk in flight and this one (2k: host_len lags the device by a
        chunk when pipelined); the JAX package keeps it opt-in."""
        if self.paged:
            produced = self.pool.batch_decode_steps(
                self.params, tokens, [s.seq_id for s in self._slots],
                self.chunk_steps)
        else:
            if not isinstance(tokens, torch.Tensor):
                tokens = self._ids([t if t is not None else 0
                                    for t in tokens])
            active = to_device(np.asarray([s.active for s in self._slots]),
                               self._device)
            attn_len = None
            if int(os.environ.get("TRACKIE_DENSE_CHUNK_ATTN", "0")):
                need = max((s.host_len for s in self._slots if s.active),
                           default=0) + 2 * self.chunk_steps + 1
                attn_len = min(1 << (need - 1).bit_length(),
                               self.cfg.max_seq)
            produced, self.cache = self._m.decode_steps_batch(
                self.params, self.cfg, tokens, active, self.cache,
                self.chunk_steps, attn_len=attn_len)
        self.stats["decode_steps"] += self.chunk_steps
        if not produced.is_cuda:
            return _Chunk(produced, produced, None)
        host = torch.empty(produced.shape, dtype=produced.dtype,
                           pin_memory=True)
        host.copy_(produced, non_blocking=True)
        ready = torch.cuda.Event()
        ready.record()
        return _Chunk(produced, host, ready)

    @staticmethod
    def _fetched(chunk: _Chunk) -> np.ndarray:
        """A chunk's tokens on the host, waiting only for that chunk."""
        if chunk.ready is not None:
            chunk.ready.synchronize()
        return chunk.host.numpy()

    def _stream(self, req: Request, token_id: int,
                final: bool = False) -> None:
        if req.on_token is None:
            return
        try:
            if hasattr(self.tokenizer, "token_bytes"):
                # Byte-level tokenizer: an incremental UTF-8 decoder keeps
                # multibyte characters whole, so the pieces concatenate to
                # tokenizer.decode(generated).
                if req._decoder is None:
                    req._decoder = codecs.getincrementaldecoder(
                        "utf-8")("replace")
                data = (self.tokenizer.token_bytes(token_id)
                        if token_id >= 0 else b"")
                piece = req._decoder.decode(data, final)
            else:
                piece = self.tokenizer.decode_token(token_id)
            if piece:
                req.on_token(piece)
        except Exception as exc:  # noqa: BLE001 (a user callback)
            log.warning("on_token callback raised: %s", exc)
            req.on_token = None  # stop calling a broken callback

    def _commit_token(self, slot: _Slot, req: Request, token_id: int,
                      final: bool = False) -> bool:
        """Commit one token's text for a slot. Plain requests stream
        straight through; stop-armed requests build the slot's text, scan
        its tail for a match and stream with a max(len(stop)) - 1 hold-back
        so no stop fragment escapes. True when a stop string fired."""
        if not req.stop:
            self._stream(req, token_id, final)
            return False
        if slot._decoder is None and hasattr(self.tokenizer,
                                             "token_bytes"):
            slot._decoder = codecs.getincrementaldecoder("utf-8")("replace")
        if slot._decoder is not None:
            data = (self.tokenizer.token_bytes(token_id)
                    if token_id >= 0 else b"")
            piece = slot._decoder.decode(data, final)
        else:
            piece = (self.tokenizer.decode_token(token_id)
                     if token_id >= 0 else "")
        max_stop = max(len(s) for s in req.stop)
        hit = False
        if piece:
            slot.text += piece
            if slot.stop_cut is None:
                start = max(0, len(slot.text) - len(piece) - max_stop + 1)
                best = None
                for s in req.stop:
                    idx = slot.text.find(s, start)
                    if idx >= 0 and (best is None or idx < best):
                        best = idx
                if best is not None:
                    slot.stop_cut = best
                    hit = True
        if req.on_token is not None:
            if slot.stop_cut is not None:
                limit = slot.stop_cut
            elif final:
                limit = len(slot.text)
            else:
                limit = len(slot.text) - (max_stop - 1)
            if limit > slot.streamed:
                try:
                    req.on_token(slot.text[slot.streamed:limit])
                except Exception as exc:  # noqa: BLE001 (a user callback)
                    log.warning("on_token callback raised: %s", exc)
                    req.on_token = None
                slot.streamed = limit
        return hit

    def _consume_chunk(self, prod: np.ndarray) -> bool:
        """Host bookkeeping of one fetched (k, B) chunk. False if any slot
        finished (EOS, budget, stop string) inside it."""
        k = self.chunk_steps
        survived = True
        for i, slot in enumerate(self._slots):
            if not slot.active:
                continue
            req = slot.request
            if req.dropped:
                # The client gave up: free the slot now.
                self._finish(slot)
                survived = False
                continue
            for j in range(k):
                slot.generated.append(slot.next_token)
                stop_hit = self._commit_token(slot, req, slot.next_token)
                slot.n_emitted += 1
                slot.host_len += 1
                self.stats["tokens"] += 1
                nxt = int(prod[j, i])
                if (stop_hit
                        or nxt == self.tokenizer.eos_id
                        or slot.n_emitted >= req.max_tokens
                        or slot.host_len >= self.cfg.max_seq - 1):
                    # Later chunk positions wrote junk into this slot's
                    # rows; it is freed, and they are never read.
                    self._finish(slot)
                    survived = False
                    break
                slot.next_token = nxt
        return survived

    @staticmethod
    def _fail(req: Optional[Request], exc: Exception) -> None:
        """Settle a future with ``exc`` if it is still pending."""
        if req is not None and not req.future.done():
            req.future.set_exception(exc)

    def _serve_loop(self) -> None:
        try:
            # The current device and the grad mode are per thread: enter
            # them inside the serve thread.
            with contextlib.ExitStack() as stack:
                if self._device.type == "cuda":
                    stack.enter_context(torch.cuda.device(self._device))
                stack.enter_context(torch.no_grad())
                self._serve_loop_inner()
        except Exception as exc:  # noqa: BLE001 (fail futures, not hang)
            log.error("serve loop died: %r", exc)
            self._fatal = exc  # submit() fails fast from here on
            self._abort_prefill_job(exc)
            for slot in self._slots:
                if slot.active:
                    self._fail(slot.request, exc)
                    slot.request = None
            # Admission-wave requests: popped, not yet bound to a slot.
            for req in self._arrived + self._inflight:
                self._fail(req, exc)
            self._inflight.clear()
            self._arrived.clear()
            for req in self._backlog:
                self._fail(req, exc)
            self._backlog.clear()
            while True:
                try:
                    self._fail(self._queue.get_nowait(), exc)
                except queue.Empty:
                    break

    def _serve_loop_inner(self) -> None:
        while not self._stopping and self._sync():
            self._admit()
            if self._prefill_job is not None:
                # One prompt chunk an iteration, between decode work.
                self._advance_prefill()
            active_mask = [s.active for s in self._slots]
            if not any(active_mask):
                if self._prefill_job is None:
                    time.sleep(0.005)
                continue

            if self.paged:
                self._ensure_decode_capacity()
                active_mask = [s.active for s in self._slots]
                if not any(active_mask):
                    continue
                if self._can_chunk():
                    self._decode_chunk()
                    continue
                logits = self.pool.batch_decode_step(
                    self.params,
                    [s.next_token if s.active else None
                     for s in self._slots],
                    [s.seq_id for s in self._slots])
            else:
                if self._can_chunk():
                    self._decode_chunk()
                    continue
                tokens = self._ids([s.next_token if s.active else 0
                                    for s in self._slots])
                active = to_device(np.asarray(active_mask), self._device)
                logits, self.cache = self._m.decode_step_batch(
                    self.params, self.cfg, tokens, active, self.cache)
            self.stats["decode_steps"] += 1

            # One fetch for every greedy slot; sampled slots draw alone.
            greedy_all = torch.argmax(logits, dim=-1).tolist()
            for i, slot in enumerate(self._slots):
                if not slot.active:
                    continue
                req = slot.request
                if req.dropped:
                    self._finish(slot)
                    continue
                slot.generated.append(slot.next_token)
                stop_hit = self._commit_token(slot, req, slot.next_token)
                slot.n_emitted += 1
                slot.host_len += 1
                self.stats["tokens"] += 1
                if stop_hit or slot.finish_next:
                    # A stop string, or the grammar closed on this token.
                    self._finish(slot)
                    continue
                if slot.grammar is not None:
                    # Budget check before picking: the acceptor is fed at
                    # pick time, so a picked token never committed would
                    # put the closure a character off.
                    if (slot.n_emitted >= req.max_tokens
                            or slot.host_len >= self.cfg.max_seq - 1):
                        self._finish(slot)  # budget-forced closure
                    else:
                        slot.next_token = self._pick_constrained(
                            slot, logits[i])
                    continue
                if req.temperature <= 0:
                    nxt = int(greedy_all[i])
                else:
                    nxt = self._sample_one(logits[i], req, slot.generated)
                if (nxt == self.tokenizer.eos_id
                        or slot.n_emitted >= req.max_tokens
                        or slot.host_len >= self.cfg.max_seq - 1):
                    self._finish(slot)
                else:
                    slot.next_token = nxt

    def _check_knobs(self) -> None:
        """What must be equal on every rank of a mesh for the host
        decisions and the KV to be the same, gathered from every rank at
        each plan that admits requests: where a rank was built otherwise
        every rank fails here, rather than serve on other KV or wait in a
        collective the others never enter."""
        knobs = {"model": self._m.__name__, "batch": self.batch,
                 "chunk_steps": self.chunk_steps, "paged": bool(self.paged),
                 "prefix_cache": self.prefix_cache,
                 "prefill_chunk": self.prefill_chunk,
                 "pages": self.pool.n_pages if self.paged else 0,
                 "cache_dtype": str(self._cache_dtype),
                 "compute_dtype": (str(self.pool.compute_dtype)
                                   if self.paged else None),
                 "seed": self._seed, "tp": self.mesh.tp,
                 "max_seq": self.cfg.max_seq}
        ranks = self.mesh.all_gather_object(knobs)
        other = [r for r, k in enumerate(ranks) if k != ranks[0]]
        if other:
            raise TrackieError(
                ErrorCode.INVALID_ARGUMENT,
                f"the servers of ranks {other} differ from rank 0's: "
                f"{[ranks[r] for r in other]} against {ranks[0]}")

    def close(self, timeout: float = 30.0) -> None:
        """Stop serving. Under a mesh rank 0's close ends every rank's
        loop (by its next plan); another rank's close waits for that, up
        to ``timeout`` seconds."""
        if self.mesh is None or self.mesh.rank == 0:
            self._stop.set()
        # Returning while the thread is in device code risks a crash at
        # exit: wait for it.
        self._thread.join(timeout=timeout)
        closed = RuntimeError("server closed")
        if self._thread.is_alive():
            # The serve thread still owns _inflight, _backlog and _slots:
            # mutating them here would race it. Only the queue, which is
            # thread-safe, is drained here.
            log.warning("serve loop did not stop within 30 s; skipping "
                        "straggler cleanup to avoid racing it")
            while True:
                try:
                    self._fail(self._queue.get_nowait(), closed)
                except queue.Empty:
                    break
            return
        self._abort_prefill_job(closed)
        for req in self._arrived + self._inflight:
            self._fail(req, closed)
        self._inflight.clear()
        self._arrived.clear()
        for req in self._backlog:
            self._fail(req, closed)
        self._backlog.clear()
        while True:
            try:
                self._fail(self._queue.get_nowait(), closed)
            except queue.Empty:
                break
        for slot in self._slots:
            if slot.active:
                self._fail(slot.request, closed)
                slot.request = None
