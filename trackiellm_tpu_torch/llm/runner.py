"""Streaming LLM runner: the conversational session API.

Port of ``trackiellm_tpu/llm/runner.py`` (``GenerationConfig``,
``_bucket_for``, ``LLMRunner``) for the slice's path: prompt -> byte
tokens -> bucketed ``prefill`` (with cross-turn prefix reuse and chunked
``extend`` for long prompts) -> greedy k-token lookahead or sampled decode
over the KV cache -> text through an incremental UTF-8 assembler. Greedy
output is byte-identical to the serial path whatever the lookahead.

Grammar-constrained decoding (``force_tool_call``, ``json_mode``,
``response_schema``) and prompt-lookup speculation are not ported yet and
raise NotImplementedError naming their ROADMAP item.
"""

from __future__ import annotations

import codecs
import dataclasses
import json
import logging
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from trackiellm_tpu.utils.errors import ErrorCode, TrackieError
from trackiellm_tpu_torch.llm import sampling
from trackiellm_tpu_torch.llm.tokenizer import ByteTokenizer, Tokenizer
from trackiellm_tpu_torch.models import llm as llm_model

log = logging.getLogger("trackiellm_tpu_torch.llm.runner")

PREFILL_BUCKETS = (64, 128, 256, 512, 1024, 2048, 4096)
EXTEND_BUCKETS = (16, 64, 256, 1024)
ATTN_BUCKETS = (256, 512, 1024, 2048, 4096)


@dataclasses.dataclass
class GenerationConfig:
    """Sampling knobs (the reference's defaults, except ``speculative``,
    which stays off until prompt-lookup speculation is ported)."""

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
    speculative: Any = False  # True / "auto" wait for ROADMAP Queue 1 item 10
    min_tokens: int = 0


@dataclasses.dataclass
class ToolDefinition:
    """A tool advertised to the model in the prompt."""

    name: str
    description: str
    parameters: Dict[str, str]  # arg name -> description

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
        self._check_gen()
        self._cache_dtype = cache_dtype
        self.cache = llm_model.KVCache.create(cfg, dtype=cache_dtype,
                                              device=self.device)
        self._generator = torch.Generator(device=self.device)
        self._generator.manual_seed(self.gen.seed)
        self._next_logits: Optional[torch.Tensor] = None
        self._primed_ids: Optional[List[int]] = None
        self._host_len = 0
        self._chat_turns: List[tuple] = []
        self._generated_ids: List[int] = []
        self._generated_text = ""
        self._n_emitted = 0
        self._done = False
        # Every token id committed to the KV cache, in order (len ==
        # _host_len); prefix reuse compares new prompts against it.
        self._committed_ids: List[int] = []
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

    def _check_gen(self) -> None:
        if self.gen.speculative:
            raise NotImplementedError(
                f"speculative={self.gen.speculative!r}: prompt-lookup "
                "speculation is not ported yet (ROADMAP Queue 1 item 10); "
                "pass speculative=False")

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
        or the remainder after a matching ``prime``). A prompt that cannot
        fit the window minus the generation budget is middle-cut."""
        self._check_gen()
        if force_tool_call or json_mode or response_schema is not None:
            raise NotImplementedError(
                "grammar-constrained decoding (force_tool_call, json_mode, "
                "response_schema) is not ported yet (ROADMAP: "
                "grammar/schema, llm/grammar.py and llm/schema.py)")
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
        self._generated_ids = []
        self._generated_text = ""
        self._n_emitted = 0
        self._done = False
        self._utf8 = None

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

    def generate_next_token(self) -> Optional[str]:
        """Sample and return the next token's text, or None when finished
        (EOS, stop string, max_tokens or the window's end)."""
        if self._done or self._next_logits is None:
            return None
        # With a lookahead chunk buffered the cache is ahead of what was
        # emitted: bound the window check by the emitted position.
        eff_len = (self._la_offset + self._la_idx if self._la_buf
                   else self._host_len)
        if (self._n_emitted >= self.gen.max_tokens
                or eff_len >= self.cfg.max_seq - 1):
            self._done = True
            self._drop_pending_lookahead()
            return None
        if self._la_buf:
            return self._greedy_chunk_step()
        if self.gen.temperature <= 0:
            if self.gen.lookahead > 1:
                return self._greedy_chunk_step()
            return self._greedy_step_pipelined()
        # Sampled flow: a pre-dispatched lookahead chunk is stale from here.
        self._la_next = None
        mask = (self._eos_ban_mask()
                if self._n_emitted < self.gen.min_tokens else None)
        recent = np.full(self.gen.repeat_window, -1, np.int64)
        tail = self._generated_ids[-self.gen.repeat_window:]
        recent[: len(tail)] = tail
        token = sampling.sample(
            self._next_logits, self._generator, self.gen.temperature,
            top_k=self.gen.top_k, top_p=self.gen.top_p, min_p=self.gen.min_p,
            mask=mask, recent_tokens=self._ids(recent),
            repetition_penalty=self.gen.repetition_penalty)
        tid = int(token)
        if tid == self.tokenizer.eos_id:
            self._done = True
            return None
        piece = self._piece(tid)
        self._generated_ids.append(tid)
        self._generated_text += piece
        self._n_emitted += 1
        self._apply_stop_strings()
        # The sampled token enters the cache even when it ends the reply,
        # so a following chat()/add_tool_response() extends a cache that
        # holds everything generated.
        logits, self.cache = llm_model.decode_step(
            self.params, self.cfg, tid, self.cache,
            attn_len=self._attn_bucket())
        self._next_logits = None if self._done else logits
        self._host_len += 1
        self._committed_ids.append(tid)
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
    # k-token lookahead (greedy only)
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
        self.cache = self.cache._replace(length=new_len)
        self._host_len = new_len
        del self._committed_ids[new_len:]
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

    # ------------------------------------------------------------------

    def generate(self, prompt: str, tools: Sequence[ToolDefinition] = (),
                 force_tool_call: bool = False,
                 on_token: Optional[Callable[[str], None]] = None,
                 should_stop: Optional[Callable[[], bool]] = None,
                 response_schema: Optional[Dict[str, Any]] = None,
                 json_mode: bool = False) -> str:
        """Run a full generation, streaming pieces to ``on_token``;
        ``should_stop`` is polled between tokens."""
        self.prepare_generation(prompt, tools, force_tool_call,
                                response_schema=response_schema,
                                json_mode=json_mode)
        while (piece := self.generate_next_token()) is not None:
            if on_token:
                on_token(piece)
            if should_stop is not None and should_stop():
                self._done = True
                break
        # An external stop can land with lookahead tokens buffered.
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

    @property
    def generated_ids(self) -> List[int]:
        """Token ids of the current reply, in order (a copy)."""
        return list(self._generated_ids)

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
        self._utf8 = None
        self._committed_ids = []
        self._primed_ids = None
        self._la_buf = []
        self._la_idx = 0
        self._la_next = None
