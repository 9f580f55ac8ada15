"""Streaming LLM runner: the conversational session API.

Port of ``trackiellm_tpu/llm/runner.py`` (``GenerationConfig``,
``ToolDefinition``, ``_bucket_for``, ``LLMRunner``): prompt -> byte tokens
-> bucketed ``prefill`` (with cross-turn prefix reuse and chunked
``extend`` for long prompts) -> greedy k-token lookahead, sampled decode,
grammar-constrained decode (``force_tool_call``, ``json_mode``,
``response_schema``: ``llm/grammar.py``, ``llm/schema.py``) or
prompt-lookup speculation (``llm/speculative.py``) over the KV cache ->
text through an incremental UTF-8 assembler. Greedy output is
byte-identical to the serial path whatever the lookahead or speculation.
"""

from __future__ import annotations

import codecs
import dataclasses
import json
import logging
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from trackiellm_tpu_torch.llm import sampling
from trackiellm_tpu_torch.llm.grammar import JsonGrammar, ToolCallGrammar
from trackiellm_tpu_torch.llm.speculative import (accepted_prefix,
                                                  propose_ngram)
from trackiellm_tpu_torch.llm.tokenizer import ByteTokenizer, Tokenizer
from trackiellm_tpu_torch.models import llm as llm_model
from trackiellm_tpu_torch.utils.errors import ErrorCode, TrackieError

log = logging.getLogger("trackiellm_tpu_torch.llm.runner")

PREFILL_BUCKETS = (64, 128, 256, 512, 1024, 2048, 4096)
EXTEND_BUCKETS = (16, 64, 256, 1024)
ATTN_BUCKETS = (256, 512, 1024, 2048, 4096)


@dataclasses.dataclass
class GenerationConfig:
    """Sampling knobs (the reference's defaults)."""

    max_tokens: int = 512
    temperature: float = 0.7
    top_k: int = 40
    top_p: float = 0.95
    min_p: float = 0.0
    repetition_penalty: float = 1.1
    repeat_window: int = 64
    seed: int = 0
    stop_strings: tuple = ()
    # Greedy decode runs as k-token device chunks with one host fetch per
    # chunk (models/llm.py decode_chunk_greedy); 1 = one-step lookahead.
    lookahead: int = 4
    # Prompt-lookup speculation (llm/speculative.py): unconstrained replies
    # verify n-gram proposals in one extend() pass. Greedy text is exactly
    # the plain greedy sequence; sampled replies keep the sampler's
    # distribution (sampling.spec_verify_sampled). "auto" turns itself off
    # for spec_probe_interval emitted tokens when the rolling acceptance
    # falls below spec_min_acceptance, or after two passes in a row found
    # no proposal (greedy).
    speculative: Any = "auto"  # False | True | "auto"
    spec_max_propose: int = 7
    spec_ngram: int = 3
    # Shortest n-gram match that may propose. 0 = by tokenizer: 3 for a
    # byte tokenizer (whose longest match then rises to 8), else 1.
    spec_min_ngram: int = 0
    spec_min_acceptance: float = 0.125
    spec_probe_interval: int = 64
    # Ban EOS until this many tokens are emitted.
    min_tokens: int = 0


@dataclasses.dataclass
class ToolDefinition:
    """A tool advertised to the model in the prompt. ``schema``, a JSON
    Schema of the arguments, makes a forced tool call conform to it."""

    name: str
    description: str
    parameters: Dict[str, str]  # arg name -> description
    schema: Optional[Dict[str, Any]] = None

    def render(self) -> str:
        args = ", ".join(f"{k}: {v}" for k, v in self.parameters.items())
        return f"- {self.name}({args}): {self.description}"


def _bucket_for(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    raise TrackieError(
        ErrorCode.CONTEXT_OVERFLOW,
        f"sequence of {n} tokens exceeds the largest bucket {buckets[-1]}",
    )


class LLMRunner:
    """Stateful conversational session over a parameter dict on ``device``.

    The KV cache is updated in place (models/llm.py ``KVCache``); every
    rollback below lowers ``cache.length`` and relies on rows past it being
    masked, exactly the reference runner's contract."""

    PREFIX_REUSE_MIN = 32

    def __init__(self, params: Dict[str, Any], cfg: llm_model.LLMConfig,
                 tokenizer: Optional[Tokenizer] = None,
                 gen_config: Optional[GenerationConfig] = None,
                 cache_dtype: torch.dtype = torch.bfloat16,
                 device: Optional[torch.device] = None):
        llm_model.check_supported(cfg, params)
        self.params = params
        self.cfg = cfg
        dev = torch.device(device or params["tok_emb"].device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        self.device = dev
        if params["tok_emb"].device != self.device:
            raise ValueError(f"params live on {params['tok_emb'].device}, "
                             f"runner device is {self.device}")
        self.tokenizer = tokenizer or ByteTokenizer(
            n_special_pad_to=cfg.vocab_size)
        self.gen = gen_config or GenerationConfig()
        self._cache_dtype = cache_dtype
        self.cache = llm_model.KVCache.create(cfg, dtype=cache_dtype,
                                              device=self.device)
        self._generator = torch.Generator(device=self.device)
        self._generator.manual_seed(self.gen.seed)
        self._grammar = None
        # Device copies of the grammar's masks, by the identity of the
        # host list token_mask returns (one list per grammar state, cached
        # and kept alive by the grammar; the list is kept here too).
        self._mask_dev: Dict[int, tuple] = {}
        self._next_logits: Optional[torch.Tensor] = None
        self._primed_ids: Optional[List[int]] = None
        self._host_len = 0
        self._chat_turns: List[tuple] = []
        self._generated_ids: List[int] = []
        self._generated_text = ""
        self._n_emitted = 0
        self._done = False
        # Every token id committed to the KV cache, in order (len ==
        # _host_len); prefix reuse and the n-gram lookup read it.
        self._committed_ids: List[int] = []
        # Tokens of a verify pass not emitted yet.
        self._pending_spec: List[int] = []
        self._spec_index = 0
        self._spec_offset = 0
        self._spec_accepted = 0
        self.spec_stats = {"passes": 0, "proposed": 0, "accepted": 0}
        # "auto": the acceptance of the last passes, the emitted tokens
        # left to skip speculation for, and greedy passes in a row that
        # found no proposal.
        self._spec_recent: List[float] = []
        self._spec_cooldown = 0
        self._spec_misses = 0
        byte_level = isinstance(self.tokenizer, ByteTokenizer)
        self._spec_min_ngram = self.gen.spec_min_ngram or (
            3 if byte_level else 1)
        self._spec_max_ngram = max(self.gen.spec_ngram,
                                   8 if byte_level
                                   and not self.gen.spec_min_ngram
                                   else self.gen.spec_ngram)
        # k-token lookahead state: fetched-but-unemitted tokens, and the
        # dispatched-ahead chunk.
        self._la_buf: List[int] = []
        self._la_idx = 0
        self._la_offset = 0
        self._la_next: Optional[tuple] = None
        self._prime_max_dispatch = 256
        self._eos_ban: Optional[torch.Tensor] = None
        # Incremental UTF-8 assembly: a multibyte character split across
        # byte tokens must not decode each byte on its own.
        self._utf8 = None

    def _piece(self, tid: int) -> str:
        if hasattr(self.tokenizer, "token_bytes"):
            if self._utf8 is None:
                self._utf8 = codecs.getincrementaldecoder("utf-8")("replace")
            return self._utf8.decode(self.tokenizer.token_bytes(tid))
        return self.tokenizer.decode_token(tid)

    def _flush_text(self) -> str:
        """Flush the UTF-8 assembler at the end of a generation (a trailing
        incomplete multibyte becomes U+FFFD, as ``tokenizer.decode``)."""
        if self._utf8 is None:
            return ""
        tail = self._utf8.decode(b"", True)
        if tail:
            self._generated_text += tail
        return tail

    def _eos_ban_mask(self) -> torch.Tensor:
        """(V,) bool on the device: True everywhere but EOS."""
        if self._eos_ban is None:
            ban = torch.ones(self.cfg.vocab_size, dtype=torch.bool)
            ban[self.tokenizer.eos_id] = False
            self._eos_ban = ban.to(self.device)
        return self._eos_ban

    def _grammar_mask(self) -> torch.Tensor:
        """The grammar's (V,) token mask on the device. ``token_mask``
        returns one shared read-only list per grammar state; its device
        copy is made once."""
        mask = self._grammar.token_mask(self.tokenizer)
        hit = self._mask_dev.get(id(mask))
        if hit is None or hit[0] is not mask:
            hit = (mask, torch.tensor(mask, dtype=torch.bool).to(self.device))
            self._mask_dev[id(mask)] = hit
        return hit[1]

    def _ids(self, ids) -> torch.Tensor:
        return torch.as_tensor(np.asarray(ids, np.int64), device=self.device)

    # ------------------------------------------------------------------
    # Session API
    # ------------------------------------------------------------------

    def count_tokens(self, text: str) -> int:
        return len(self.tokenizer.encode(text))

    @property
    def max_prompt_tokens(self) -> int:
        return max(self.cfg.max_seq - self.gen.max_tokens - 1, 16)

    def build_prompt(self, system: str, context: str, user: str,
                     tools: Sequence[ToolDefinition] = ()) -> str:
        """Instruction-format prompt with an optional tool list."""
        parts = [system]
        if tools:
            parts.append(
                "You may call one tool by replying ONLY with JSON of the "
                'form {"tool_call":{"name":"<tool>","arguments":{...}}}.\n'
                "Available tools:\n" + "\n".join(t.render() for t in tools)
            )
        if context:
            parts.append(f"Context:\n{context}")
        body = "\n\n".join(parts)
        return f"[INST] {body}\n\nUser: {user} [/INST]"

    def prepare_generation(self, prompt: str,
                           tools: Sequence[ToolDefinition] = (),
                           force_tool_call: bool = False,
                           response_schema: Optional[Dict[str, Any]] = None,
                           json_mode: bool = False) -> None:
        """Tokenize and ingest the prompt (bucketed prefill, prefix reuse,
        or the remainder after a matching ``prime``), then arm the grammar
        if asked. A prompt that cannot fit the window minus the generation
        budget is middle-cut."""
        self._drop_pending_lookahead()
        ids = self.tokenizer.encode(prompt, add_bos=True)
        hard_limit = self.max_prompt_tokens
        if len(ids) > hard_limit:
            head = hard_limit // 4
            tail = hard_limit - head
            log.warning("prompt of %d tokens exceeds the %d-token window "
                        "budget; truncated", len(ids), hard_limit)
            ids = ids[:head] + ids[-tail:]

        primed = self._primed_ids
        self._primed_ids = None
        if (primed and len(primed) <= len(ids)
                and ids[: len(primed)] == primed):
            logits = self._next_logits
            rest = ids[len(primed):]
            for pos in range(0, len(rest), EXTEND_BUCKETS[-1]):
                logits = self._extend_ids(rest[pos: pos + EXTEND_BUCKETS[-1]])
            self._next_logits = logits
        else:
            if primed:
                log.info("primed prefix did not match the final prompt; "
                         "falling back to prefix-cache reuse")
            self._prefill_with_prefix_reuse(ids)
        self._arm_generation_state(tools, force_tool_call, response_schema,
                                   json_mode)

    def _arm_generation_state(self, tools: Sequence[ToolDefinition],
                              force_tool_call: bool,
                              response_schema: Optional[Dict[str, Any]],
                              json_mode: bool) -> None:
        """Reset the per-reply state and arm the constrained-decoding
        grammar: a tool call (typed by each tool's schema) or a JSON reply
        (conforming to ``response_schema`` when given)."""
        self._generated_ids = []
        self._generated_text = ""
        self._n_emitted = 0
        self._done = False
        self._utf8 = None
        self._mask_dev = {}
        if force_tool_call:
            if not tools:
                raise TrackieError(ErrorCode.TOOL_CALL_INVALID,
                                   "force_tool_call requires tools")
            if response_schema is not None or json_mode:
                raise TrackieError(
                    ErrorCode.INVALID_ARGUMENT,
                    "force_tool_call and JSON response mode are exclusive")
            self._grammar = ToolCallGrammar(
                [t.name for t in tools],
                {t.name: t.schema for t in tools if t.schema is not None})
        elif response_schema is not None or json_mode:
            self._grammar = JsonGrammar(response_schema)
        else:
            self._grammar = None

    def _prefill_with_prefix_reuse(self, ids) -> None:
        """When the cache already holds a long prefix of ``ids`` (the cortex
        rebuilds the whole prompt every turn), roll ``cache.length`` back to
        it and extend only the rest; otherwise ingest afresh."""
        committed = self._committed_ids
        lcp = 0
        limit = min(len(committed), len(ids))
        while lcp < limit and committed[lcp] == ids[lcp]:
            lcp += 1
        # Keep one prompt token to extend: its logits must be recomputed.
        lcp = min(lcp, len(ids) - 1)
        if lcp < self.PREFIX_REUSE_MIN:
            self._ingest_ids(ids)
            return
        self._drop_pending_lookahead()
        self.cache = self.cache._replace(length=lcp)
        self._host_len = lcp
        del self._committed_ids[lcp:]
        self._pending_spec = []
        rest = ids[lcp:]
        logits = None
        for pos in range(0, len(rest), EXTEND_BUCKETS[-1]):
            logits = self._extend_ids(rest[pos: pos + EXTEND_BUCKETS[-1]])
        self._next_logits = logits
        log.info("prefix-cache reuse: %d/%d prompt tokens already in "
                 "cache; extended %d", lcp, len(ids), len(rest))

    def _ingest_ids(self, ids, max_dispatch: Optional[int] = None) -> None:
        """Fresh-cache ingestion: bucketed prefill of the head, chunked
        extend of the rest. ``max_dispatch`` caps each pass (``prime``)."""
        self._drop_pending_lookahead()
        buckets = ([b for b in PREFILL_BUCKETS if b <= self.cfg.max_seq]
                   or [self.cfg.max_seq])
        if max_dispatch is not None:
            buckets = [b for b in buckets if b <= max_dispatch] or buckets[:1]
        n = len(ids)
        first_n = min(n, buckets[-1])
        bucket = _bucket_for(first_n, buckets)
        padded = np.zeros(bucket, np.int64)
        padded[:first_n] = ids[:first_n]
        # Reuse the allocated KV buffers: the length mask hides old rows.
        self.cache = self.cache._replace(length=0)
        logits, self.cache = llm_model.prefill(
            self.params, self.cfg, self._ids(padded), first_n, self.cache)
        self._host_len = first_n
        self._committed_ids = [int(i) for i in ids[:first_n]]
        self._pending_spec = []
        chunk_cap = EXTEND_BUCKETS[-1]
        if max_dispatch is not None:
            chunk_cap = min(chunk_cap, max_dispatch)
        for pos in range(first_n, n, chunk_cap):
            logits = self._extend_ids(ids[pos: pos + chunk_cap])
        self._next_logits = logits

    def prime(self, prompt_prefix: str) -> None:
        """Ingest a prompt prefix before the full prompt is known (the
        streaming-ASR hook); a following ``prepare_generation`` whose prompt
        starts with it extends only the remainder. Passes are capped at
        ``_prime_max_dispatch`` tokens."""
        ids = self.tokenizer.encode(prompt_prefix, add_bos=True)
        prev = self._primed_ids
        if prev and len(prev) <= len(ids) and ids[: len(prev)] == prev:
            rest = ids[len(prev):]
            cap = min(EXTEND_BUCKETS[-1], self._prime_max_dispatch)
            for pos in range(0, len(rest), cap):
                self._next_logits = self._extend_ids(rest[pos: pos + cap])
        else:
            self._ingest_ids(ids, max_dispatch=self._prime_max_dispatch)
        self._primed_ids = list(ids)

    def _attn_bucket(self) -> Optional[int]:
        return self._attn_bucket_for(self._host_len + 1)

    def _attn_bucket_for(self, need: int) -> Optional[int]:
        if self.cfg.max_seq <= ATTN_BUCKETS[0]:
            return None
        for b in ATTN_BUCKETS:
            if need <= b <= self.cfg.max_seq:
                return b
        return None

    def _extend_ids(self, ids) -> torch.Tensor:
        """Append ids to the live cache with one bucketed extend pass;
        returns the logits at the last one."""
        self._drop_pending_spec()
        self._drop_pending_lookahead()
        bucket = _bucket_for(len(ids), EXTEND_BUCKETS)
        padded = np.zeros(bucket, np.int64)
        padded[: len(ids)] = ids
        logits, self.cache = llm_model.extend(
            self.params, self.cfg, self._ids(padded), len(ids), self.cache,
            attn_len=self._attn_bucket_for(self._host_len + bucket))
        self._host_len += len(ids)
        self._committed_ids.extend(int(i) for i in ids)
        return logits

    def _decode_commit(self, tid: int) -> torch.Tensor:
        """Write ``tid`` into the cache with one decode step; returns the
        logits after it."""
        logits, self.cache = llm_model.decode_step(
            self.params, self.cfg, tid, self.cache,
            attn_len=self._attn_bucket())
        self._host_len += 1
        self._committed_ids.append(tid)
        return logits

    def generate_next_token(self) -> Optional[str]:
        """Sample and return the next token's text, or None when finished
        (EOS, grammar completion, stop string, max_tokens or the window's
        end)."""
        if self._done or (self._next_logits is None
                          and not self._pending_spec):
            return None
        # With a lookahead chunk buffered the cache is ahead of what was
        # emitted: bound the window check by the emitted position.
        eff_len = (self._la_offset + self._la_idx if self._la_buf
                   else self._host_len)
        if (self._n_emitted >= self.gen.max_tokens
                or eff_len >= self.cfg.max_seq - 1):
            self._done = True
            self._drop_pending_spec()
            self._drop_pending_lookahead()
            return None
        if self._pending_spec:
            return self._emit_spec_token()
        if self._la_buf:
            # The "auto" cooldown counts emitted tokens, buffered chunk
            # tokens included.
            if self.gen.speculative == "auto" and self._spec_cooldown > 0:
                self._spec_cooldown -= 1
            return self._greedy_chunk_step()

        # Budget-forced closure: a constrained reply about to run out of
        # tokens emits the grammar's shortest valid completion instead of
        # ending as invalid JSON.
        if self._grammar is not None and not self._grammar.done:
            closure = self._grammar.closure()
            closure_ids = self.tokenizer.encode(closure)
            remaining = self.gen.max_tokens - self._n_emitted
            if closure and len(closure_ids) >= remaining - 1:
                if not self._grammar.feed_text(closure):
                    raise AssertionError(f"the grammar refused its own "
                                         f"closure {closure!r}")
                # Through the UTF-8 assembler, so that a pending partial
                # multibyte comes out (as U+FFFD) before the closure.
                if self._utf8 is not None:
                    piece = self._utf8.decode(closure.encode("utf-8"))
                else:
                    piece = closure
                self._generated_text += piece
                self._generated_ids.extend(closure_ids)
                self._n_emitted = self.gen.max_tokens
                self._extend_ids(closure_ids)
                self._done = True
                return piece

        spec = self.gen.speculative
        # A greedy token that cannot speculate (cooldown, or min_tokens not
        # reached) takes the lookahead chunk path, not the serial loop.
        spec_eligible = (self._n_emitted >= self.gen.min_tokens
                         and self._spec_cooldown <= 0)
        if (self._grammar is None and self.gen.temperature <= 0
                and (not spec
                     or (spec == "auto" and not spec_eligible))):
            if spec == "auto" and self._spec_cooldown > 0:
                self._spec_cooldown -= 1
            if self.gen.lookahead > 1:
                return self._greedy_chunk_step()
            return self._greedy_step_pipelined()
        # Sampled, constrained or speculative flow: a pre-dispatched
        # lookahead chunk is stale from here.
        self._la_next = None

        mask = None
        if self._grammar is not None:
            mask = self._grammar_mask()
        if self._n_emitted < self.gen.min_tokens:
            ban = self._eos_ban_mask()
            mask = ban if mask is None else (mask & ban)

        if self.gen.temperature <= 0:
            token = sampling.greedy(self._next_logits, mask)
        else:
            recent = np.full(self.gen.repeat_window, -1, np.int64)
            tail = self._generated_ids[-self.gen.repeat_window:]
            recent[: len(tail)] = tail
            token = sampling.sample(
                self._next_logits, self._generator, self.gen.temperature,
                top_k=self.gen.top_k, top_p=self.gen.top_p,
                min_p=self.gen.min_p, mask=mask,
                recent_tokens=self._ids(recent),
                repetition_penalty=self.gen.repetition_penalty)
        tid = int(token)
        if tid == self.tokenizer.eos_id:
            self._done = True
            return None

        piece = self._piece(tid)
        if self._grammar is not None:
            self._grammar.feed_text(piece)
            if self._grammar.done:
                self._done = True
        self._generated_ids.append(tid)
        self._generated_text += piece
        self._n_emitted += 1
        # Stop strings mark the reply done but the token still enters the
        # cache, so a following chat()/add_tool_response() extends a cache
        # that holds everything generated.
        self._apply_stop_strings()

        if self._done:
            self._decode_commit(tid)
            self._next_logits = None
            return piece
        if (spec == "auto" and self.gen.temperature > 0
                and self._spec_cooldown > 0):
            # Sampled tokens never take the greedy fast path, so the
            # acceptance cooldown counts down here.
            self._spec_cooldown -= 1
        if (self._spec_allowed() and self._grammar is None
                and self._n_emitted >= self.gen.min_tokens):
            if self._start_speculative_pass(tid):
                self._spec_misses = 0
                return piece
            if spec == "auto" and self.gen.temperature <= 0:
                # No proposal: this token pays a serial decode step. After
                # two in a row, back to the chunk path (greedy only: the
                # sampled flow has no chunk path, and a miss costs it only
                # the host's n-gram scan).
                self._spec_misses += 1
                if self._spec_misses >= 2:
                    self._spec_misses = 0
                    self._spec_cooldown = self.gen.spec_probe_interval
        self._next_logits = self._decode_commit(tid)
        return piece

    def _apply_stop_strings(self) -> bool:
        """Mark the reply done and cut the visible text at the first stop
        string it now contains; True when one was found."""
        for stop in self.gen.stop_strings:
            if stop and stop in self._generated_text:
                self._done = True
                self._generated_text = self._generated_text.split(stop)[0]
                return True
        return False

    def _greedy_step_pipelined(self) -> Optional[str]:
        """Greedy token with a one-step lookahead: the next decode_step is
        dispatched with the device token before its id is fetched. On EOS
        that step is discarded (the serial path never commits EOS; the row
        it wrote sits past ``cache.length``)."""
        mask = (self._eos_ban_mask()
                if self._n_emitted < self.gen.min_tokens else None)
        token_dev = sampling.greedy(self._next_logits, mask)
        nxt_logits, nxt_cache = llm_model.decode_step(
            self.params, self.cfg, token_dev, self.cache,
            attn_len=self._attn_bucket())
        tid = int(token_dev)
        if tid == self.tokenizer.eos_id:
            self._done = True
            return None
        piece = self._piece(tid)
        self._generated_ids.append(tid)
        self._generated_text += piece
        self._n_emitted += 1
        self.cache = nxt_cache
        self._host_len += 1
        self._committed_ids.append(tid)
        self._next_logits = nxt_logits
        if self._apply_stop_strings():
            self._next_logits = None
        return piece

    # ------------------------------------------------------------------
    # k-token lookahead (greedy, unconstrained only)
    # ------------------------------------------------------------------

    def _dispatch_chunk(self, logits, cache, offset: int,
                        emitted_before: int) -> None:
        """Enqueue a k-step greedy chunk from (logits, cache) at host
        position ``offset`` and start copying its tokens to the host; the
        copy is waited on only when the chunk is consumed."""
        k = self.gen.lookahead
        sup = (max(0, min(k, self.gen.min_tokens - emitted_before))
               if self.gen.min_tokens > 0 else 0)
        toks, lg, new_cache = llm_model.decode_chunk_greedy(
            self.params, self.cfg, logits, cache, k,
            attn_len=self._attn_bucket_for(offset + k),
            eos_id=self.tokenizer.eos_id, suppress_until=sup)
        if toks.is_cuda:
            host = torch.empty(toks.shape, dtype=toks.dtype, pin_memory=True)
            host.copy_(toks, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record()
        else:
            host, ready = toks, None
        self._la_next = (host, ready, lg, new_cache, offset)

    def _greedy_chunk_step(self) -> Optional[str]:
        """Emit one token from the k-token lookahead pipeline. Chunks are
        committed tentatively (cache advanced by k); the successor chunk is
        enqueued before this chunk's tokens are waited on, so the wait
        overlaps its compute. Terminal events roll ``cache.length`` back,
        which keeps text and cache identical to the serial path."""
        k = self.gen.lookahead
        if not self._la_buf:
            if self._la_next is None:
                if self._host_len + k > self.cfg.max_seq - 1:
                    # Window tail: no room for a full chunk.
                    return self._greedy_step_pipelined()
                self._dispatch_chunk(self._next_logits, self.cache,
                                     self._host_len, self._n_emitted)
            host, ready, logits_dev, cache_dev, offset = self._la_next
            self._la_next = None
            if offset + 2 * k <= self.cfg.max_seq - 1:
                self._dispatch_chunk(logits_dev, cache_dev, offset + k,
                                     self._n_emitted + k)
            if ready is not None:
                ready.synchronize()
            toks = host.tolist()
            self.cache = cache_dev
            self._next_logits = logits_dev
            self._host_len = offset + k
            self._committed_ids.extend(toks)
            self._la_buf = toks
            self._la_idx = 0
            self._la_offset = offset

        idx = self._la_idx
        tid = self._la_buf[idx]
        self._la_idx += 1
        if tid == self.tokenizer.eos_id:
            self._rollback_lookahead(self._la_offset + idx)
            self._done = True
            return None
        piece = self._piece(tid)
        self._generated_ids.append(tid)
        self._generated_text += piece
        self._n_emitted += 1
        if self._apply_stop_strings():
            # The serial path commits the token that completed the stop.
            self._rollback_lookahead(self._la_offset + idx + 1)
        elif self._la_idx >= len(self._la_buf):
            self._la_buf = []
            self._la_idx = 0
        return piece

    def _rollback_lookahead(self, new_len: int) -> None:
        """Roll the tentative chunk back to ``new_len`` tokens and drop any
        dispatched-ahead chunk."""
        self._truncate(new_len)
        self._la_buf = []
        self._la_idx = 0
        self._la_next = None
        self._next_logits = None

    def _drop_pending_lookahead(self) -> None:
        """Reconcile lookahead state to exactly the emitted tokens."""
        if self._la_buf and self._la_idx < len(self._la_buf):
            self._rollback_lookahead(self._la_offset + self._la_idx)
        else:
            self._la_buf = []
            self._la_idx = 0
            self._la_next = None

    def _truncate(self, new_len: int) -> None:
        """Lower the cache, its host length and the committed ids to
        ``new_len`` tokens (rows past it stay masked)."""
        self.cache = self.cache._replace(length=new_len)
        self._host_len = new_len
        del self._committed_ids[new_len:]

    # ------------------------------------------------------------------
    # Prompt-lookup speculation
    # ------------------------------------------------------------------

    def _spec_allowed(self) -> bool:
        """Whether speculation may run now: in "auto" mode, not during a
        cooldown."""
        if not self.gen.speculative:
            return False
        if self.gen.speculative != "auto":
            return True
        return self._spec_cooldown <= 0

    def _start_speculative_pass(self, tid: int) -> bool:
        """After emitting ``tid``, verify an n-gram proposal in one
        ``extend`` pass (bucket 16) instead of a decode_step. ``tid`` and
        the accepted proposals enter the cache now; the tokens the pass
        yields are buffered and emitted one a call with the plain loop's
        semantics (EOS, stop strings and max_tokens alike). False when no
        proposal fired (the caller decodes ``tid``)."""
        proposal = propose_ngram(self._committed_ids + [tid],
                                 self.gen.spec_max_propose,
                                 max_ngram=self._spec_max_ngram,
                                 min_ngram=self._spec_min_ngram)
        if not proposal:
            return False
        bucket = EXTEND_BUCKETS[0]
        proposal = proposal[: bucket - 1]
        if self._host_len + bucket >= self.cfg.max_seq:
            return False
        chunk = [tid] + proposal
        padded = np.zeros(bucket, np.int64)
        padded[: len(chunk)] = chunk
        offset = self._host_len
        logits, cache = llm_model.extend(
            self.params, self.cfg, self._ids(padded), len(chunk), self.cache,
            attn_len=self._attn_bucket_for(offset + bucket), all_logits=True)
        if self.gen.temperature <= 0:
            greedy = torch.argmax(logits[: len(chunk)], dim=-1).tolist()
            accepted = accepted_prefix(greedy, proposal)
            pending = greedy[: accepted + 1]
        else:
            # Rejection sampling (sampling.spec_verify_sampled). The
            # repetition window at position i is the emitted history (which
            # holds tid) and the proposals before i.
            prop = np.zeros(bucket - 1, np.int64)
            prop[: len(proposal)] = proposal
            rec = np.full((bucket, self.gen.repeat_window), -1, np.int64)
            hist = self._generated_ids
            for i in range(len(proposal) + 1):
                t = (hist + proposal[:i])[-self.gen.repeat_window:]
                rec[i, : len(t)] = t
            verdict = sampling.spec_verify_sampled(
                logits, self._ids(prop), len(proposal), self._generator,
                self.gen.temperature, self._ids(rec), top_k=self.gen.top_k,
                top_p=self.gen.top_p, min_p=self.gen.min_p,
                repetition_penalty=self.gen.repetition_penalty).tolist()
            accepted = verdict[0]  # one fetch a pass
            pending = proposal[:accepted] + [verdict[1]]
        self.spec_stats["passes"] += 1
        self.spec_stats["proposed"] += len(proposal)
        self.spec_stats["accepted"] += accepted
        if self.gen.speculative == "auto":
            self._spec_recent.append(accepted / len(proposal))
            if len(self._spec_recent) > 8:
                self._spec_recent.pop(0)
            if (len(self._spec_recent) >= 4
                    and (sum(self._spec_recent) / len(self._spec_recent)
                         < self.gen.spec_min_acceptance)):
                self._spec_cooldown = self.gen.spec_probe_interval
                self._spec_recent = self._spec_recent[-2:]
        # The cache holds tid and the accepted proposals; the rejected tail
        # past the length is masked.
        self.cache = cache._replace(length=offset + 1 + accepted)
        self._host_len = offset + 1 + accepted
        self._committed_ids.extend(chunk[: 1 + accepted])
        self._spec_offset = offset
        self._spec_accepted = accepted
        self._spec_index = 0
        self._pending_spec = pending
        self._next_logits = None
        return True

    def _emit_spec_token(self) -> Optional[str]:
        """Pop one buffered speculative token with the semantics of the
        plain sample-then-commit path."""
        if (self.gen.speculative == "auto" and self.gen.temperature > 0
                and self._spec_cooldown > 0):
            self._spec_cooldown -= 1
        idx = self._spec_index
        tid = self._pending_spec[idx]
        self._spec_index += 1
        last = self._spec_index >= len(self._pending_spec)
        in_cache = idx < self._spec_accepted  # the bonus token is not

        if tid == self.tokenizer.eos_id:
            # The plain path never commits EOS.
            self._truncate(self._spec_offset + 1 + idx)
            self._pending_spec = []
            self._spec_index = 0
            self._next_logits = None
            self._done = True
            return None

        piece = self._piece(tid)
        self._generated_ids.append(tid)
        self._generated_text += piece
        self._n_emitted += 1
        self._apply_stop_strings()

        if self._done:
            # Commit this token and drop everything after it.
            if in_cache:
                self._truncate(self._spec_offset + 2 + idx)
            else:
                self._decode_commit(tid)
            self._pending_spec = []
            self._spec_index = 0
            self._next_logits = None
        elif last:
            # The bonus token is not in the cache yet: chain another pass
            # from it (unless the cooldown forbids) or decode it.
            self._pending_spec = []
            self._spec_index = 0
            if not (self._spec_allowed()
                    and self._start_speculative_pass(tid)):
                self._next_logits = self._decode_commit(tid)
        return piece

    def _drop_pending_spec(self) -> None:
        """Roll the cache back to exactly the emitted tokens when a reply
        ends with speculative tokens still buffered."""
        if not self._pending_spec:
            return
        self._truncate(self._spec_offset + 1 + self._spec_index)
        self._pending_spec = []
        self._spec_index = 0
        self._next_logits = None

    # ------------------------------------------------------------------

    def generate(self, prompt: str, tools: Sequence[ToolDefinition] = (),
                 force_tool_call: bool = False,
                 on_token: Optional[Callable[[str], None]] = None,
                 should_stop: Optional[Callable[[], bool]] = None,
                 response_schema: Optional[Dict[str, Any]] = None,
                 json_mode: bool = False) -> str:
        """Run a full generation, streaming pieces to ``on_token``;
        ``should_stop`` is polled between tokens. ``json_mode`` and
        ``response_schema`` constrain the reply to (conforming) JSON."""
        self.prepare_generation(prompt, tools, force_tool_call,
                                response_schema=response_schema,
                                json_mode=json_mode)
        while (piece := self.generate_next_token()) is not None:
            if on_token:
                on_token(piece)
            if should_stop is not None and should_stop():
                self._done = True
                break
        # An external stop can land with speculative or lookahead tokens
        # buffered.
        self._drop_pending_spec()
        self._drop_pending_lookahead()
        tail = self._flush_text()
        if tail and on_token:
            on_token(tail)
        return self._generated_text

    def chat(self, user_text: str, system: Optional[str] = None,
             on_token: Optional[Callable[[str], None]] = None) -> str:
        """Multi-turn conversation: later turns extend the cache with only
        the new exchange; a fresh prefill of the recent history when the
        window would overflow."""
        first = self._host_len == 0
        new_ids = self.tokenizer.encode(f"\n[INST] {user_text} [/INST]")
        fits = (self._host_len + len(new_ids) + self.gen.max_tokens
                < self.cfg.max_seq - 1)
        if first or not fits:
            history = "\n".join(
                f"[INST] {u} [/INST] {a}" for u, a in self._chat_turns[-4:])
            prompt = "\n".join(p for p in (
                f"[INST] {system} [/INST]" if system else "",
                history,
                f"[INST] {user_text} [/INST]") if p)
            self.prepare_generation(prompt)
        else:
            self._next_logits = self._extend_ids(new_ids)
            self._generated_ids = []
            self._generated_text = ""
            self._n_emitted = 0
            self._done = False
            self._grammar = None
            self._utf8 = None
        while (piece := self.generate_next_token()) is not None:
            if on_token:
                on_token(piece)
        tail = self._flush_text()
        if tail and on_token:
            on_token(tail)
        self._chat_turns.append((user_text, self._generated_text))
        return self._generated_text

    def add_tool_response(self, tool_name: str, response: Any) -> None:
        """Re-inject a tool's output into the context."""
        text = f"\nTool {tool_name} returned: {json.dumps(response)}\n"
        self._next_logits = self._extend_ids(self.tokenizer.encode(text))
        self._done = False
        self._grammar = None

    @property
    def generated_ids(self) -> List[int]:
        """Token ids of the current reply, in order (a copy)."""
        return list(self._generated_ids)

    @property
    def text(self) -> str:
        return self._generated_text

    def parse_tool_call(self) -> Optional[Dict[str, Any]]:
        """The reply's tool call as {"name", "arguments"}, or None when the
        reply is not one."""
        try:
            obj = json.loads(self._generated_text)
            call = obj.get("tool_call")
            if isinstance(call, dict) and "name" in call:
                return {"name": call["name"],
                        "arguments": call.get("arguments", {})}
        except (json.JSONDecodeError, AttributeError):
            pass
        return None

    def reset(self) -> None:
        """Clear the conversation."""
        self.cache = llm_model.KVCache.create(self.cfg, dtype=self._cache_dtype,
                                              device=self.device)
        self._next_logits = None
        self._host_len = 0
        self._chat_turns = []
        self._generated_ids = []
        self._generated_text = ""
        self._done = False
        self._grammar = None
        self._utf8 = None
        self._committed_ids = []
        self._primed_ids = None
        self._pending_spec = []
        self._spec_index = 0
        self._la_buf = []
        self._la_idx = 0
        self._la_next = None
