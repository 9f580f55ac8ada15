"""Prompt-lookup (n-gram) speculative decoding.

Port of ``trackiellm_tpu/llm/speculative.py`` on the port's model
functions. Single-model self-speculation: propose the continuation of the
longest recent n-gram match in the context seen so far (prompt and
generated tokens), then verify all proposals in one parallel ``extend``
pass. Greedy decoding accepts the longest proposal prefix that matches the
model's own argmax at each position, plus one bonus token from the last
accepted position, so a fully accepted pass emits k + 1 tokens for one
weight stream; the worst case is the plain decode loop.

Rejecting proposals costs no copy: rows past ``cache.length`` are masked
and overwritten as real tokens arrive (``models/llm.py`` ``KVCache``), so
a rollback only lowers ``length``.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from trackiellm_tpu_torch.models import llm as llm_model


def propose_ngram(history: Sequence[int], max_propose: int,
                  max_ngram: int = 3, min_ngram: int = 1) -> List[int]:
    """Propose a continuation by matching the most recent n-gram against
    earlier context (prompt-lookup decoding).

    Scans for the previous occurrence of the last ``n`` tokens (longest n
    first) and returns up to ``max_propose`` tokens that followed it. Host
    list work only."""
    h = list(history)
    ln = len(h)
    for n in range(min(max_ngram, ln - 1), min_ngram - 1, -1):
        tail = h[ln - n:]
        # most recent earlier occurrence first
        for start in range(ln - n - 1, -1, -1):
            if h[start:start + n] == tail:
                follow = h[start + n: start + n + max_propose]
                if follow:
                    return follow
                break
    return []


class SpecStats:
    """Counters of a speculative run."""

    def __init__(self) -> None:
        self.passes = 0          # speculative verify passes
        self.plain_steps = 0     # fallback single-token steps
        self.proposed = 0
        self.accepted = 0

    @property
    def acceptance(self) -> float:
        return self.accepted / self.proposed if self.proposed else 0.0

    def as_dict(self) -> Dict[str, float]:
        return {"passes": self.passes, "plain_steps": self.plain_steps,
                "proposed": self.proposed, "accepted": self.accepted,
                "acceptance": round(self.acceptance, 4)}


def _verify(params, cfg, cache, chunk: List[int], bucket: int,
            attn_len: Optional[int]):
    """One verify pass of ``chunk`` (the pending token and the proposals)
    padded to ``bucket``: returns the greedy ids at every chunk position
    (one host fetch) and the cache after the pass."""
    padded = np.zeros((bucket,), np.int64)
    padded[:len(chunk)] = chunk
    tokens = torch.as_tensor(padded, device=cache.k.device)
    logits, cache = llm_model.extend(params, cfg, tokens, len(chunk), cache,
                                     attn_len=attn_len, all_logits=True)
    return torch.argmax(logits, dim=-1).tolist(), cache


def accepted_prefix(greedy: List[int], proposal: List[int]) -> int:
    """Length of the proposal prefix that equals the model's argmax."""
    n = 0
    while n < len(proposal) and greedy[n] == proposal[n]:
        n += 1
    return n


def speculative_generate(
    params: Dict[str, Any],
    cfg: llm_model.LLMConfig,
    history: Sequence[int],
    first_token: int,
    cache: llm_model.KVCache,
    n_tokens: int,
    attn_len: Optional[int] = None,
    max_propose: int = 7,
    max_ngram: int = 3,
) -> Tuple[List[int], llm_model.KVCache, SpecStats]:
    """Greedy-generate ``n_tokens`` after ``first_token`` (drawn after the
    prefill, not yet in the cache) with n-gram proposals verified in
    ``extend`` passes of ``max_propose + 1`` rows.

    ``history`` is the visible context (prompt ids and any generated),
    used only for the n-gram lookup. Returns the generated tokens, the
    advanced cache and the counters; steps without a proposal use
    ``decode_step``."""
    bucket = max_propose + 1
    hist: List[int] = list(history) + [int(first_token)]
    out: List[int] = []
    stats = SpecStats()
    tok = int(first_token)  # pending: emitted but not yet in the cache

    while len(out) < n_tokens:
        proposal = propose_ngram(hist, max_propose, max_ngram=max_ngram)
        if proposal:
            offset = cache.length
            greedy, cache = _verify(params, cfg, cache, [tok] + proposal,
                                    bucket, attn_len)
            stats.passes += 1
            stats.proposed += len(proposal)
            accepted = accepted_prefix(greedy, proposal)
            stats.accepted += accepted
            emitted = greedy[:accepted + 1][: n_tokens - len(out)]
            # In the cache: tok and the accepted proposals before each
            # emitted token, offset + len(emitted) rows (the last emitted
            # token is pending, as decode_step's is). This rolls back the
            # rejected tail and trims the last pass's excess.
            cache = cache._replace(length=offset + len(emitted))
        else:
            logits, cache = llm_model.decode_step(params, cfg, tok, cache,
                                                  attn_len=attn_len)
            stats.plain_steps += 1
            emitted = [int(torch.argmax(logits))][: n_tokens - len(out)]
        out.extend(emitted)
        hist.extend(emitted)
        tok = emitted[-1] if emitted else tok
    return out, cache, stats


def speculative_generate_draft(
    params: Dict[str, Any],
    cfg: llm_model.LLMConfig,
    draft_params: Dict[str, Any],
    draft_cfg: llm_model.LLMConfig,
    history: Sequence[int],
    first_token: int,
    cache: llm_model.KVCache,
    n_tokens: int,
    draft_cache: Optional[llm_model.KVCache] = None,
    attn_len: Optional[int] = None,
    draft_attn_len: Optional[int] = None,
    max_propose: int = 7,
) -> Tuple[List[int], llm_model.KVCache, SpecStats]:
    """Two-model speculative decoding: a small draft model proposes
    ``max_propose`` greedy tokens a round (``decode_chunk_greedy``), the
    target verifies them in one ``extend`` pass, and both caches roll back
    the rejected tail by lowering ``length``. The output equals the
    target's plain greedy loop.

    ``history``: the ids already in the target ``cache`` (the prompt); the
    draft cache is filled with them when ``draft_cache`` is None. The two
    models share a vocabulary."""
    assert cfg.vocab_size == draft_cfg.vocab_size, (
        "draft and target must share a vocabulary")
    bucket = max_propose + 1
    device = cache.k.device
    if draft_cache is None:
        draft_cache = llm_model.KVCache.create(
            draft_cfg, dtype=cache.k.dtype, device=device)
        if len(history):
            _, draft_cache = llm_model.prefill(
                draft_params, draft_cfg,
                torch.as_tensor(list(history), device=device), len(history),
                draft_cache)
    out: List[int] = []
    stats = SpecStats()
    tok = int(first_token)  # pending: emitted but not yet in any cache

    while len(out) < n_tokens:
        k = min(max_propose, n_tokens - len(out))
        # Draft: ingest the pending token, then k greedy tokens.
        d_logits, draft_cache = llm_model.decode_step(
            draft_params, draft_cfg, tok, draft_cache,
            attn_len=draft_attn_len)
        d_offset = draft_cache.length
        proposal_dev, _, draft_cache = llm_model.decode_chunk_greedy(
            draft_params, draft_cfg, d_logits, draft_cache, k,
            attn_len=draft_attn_len)
        proposal = proposal_dev.tolist()
        offset = cache.length
        greedy, cache = _verify(params, cfg, cache, [tok] + proposal, bucket,
                                attn_len)
        stats.passes += 1
        stats.proposed += len(proposal)
        accepted = accepted_prefix(greedy, proposal)
        stats.accepted += accepted
        emitted = greedy[:accepted + 1][: n_tokens - len(out)]
        # Target: offset + len(emitted) rows (the last emitted token stays
        # pending). Draft: the ingested tok and the accepted proposals, the
        # same count past its offset.
        cache = cache._replace(length=offset + len(emitted))
        draft_cache = draft_cache._replace(
            length=d_offset - 1 + len(emitted))
        out.extend(emitted)
        tok = emitted[-1]
    return out, cache, stats
