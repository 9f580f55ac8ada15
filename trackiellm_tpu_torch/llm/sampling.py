"""Token sampling: repetition penalty, masks, min-p, temperature, top-k,
top-p, greedy argmax, and the speculative verify pass's rejection sampling.

Port of ``trackiellm_tpu/llm/sampling.py`` (``sample``, ``_process_chain``,
``spec_verify_sampled``, ``greedy``). Randomness comes from an explicit
``torch.Generator`` on the logits' device; its stream differs from
``jax.random``'s, so the port is held to the same distribution, not the
same draws.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30


def _process_chain(logits: torch.Tensor, temperature: float, top_k: int,
                   top_p: float, min_p: float,
                   mask: Optional[torch.Tensor],
                   recent_tokens: Optional[torch.Tensor],
                   repetition_penalty: float) -> torch.Tensor:
    """llama.cpp's order: repetition penalty -> mask -> min-p (on the
    pre-temperature distribution) -> temperature -> top-k -> top-p.
    Returns the final logits that the categorical draw uses. ``logits`` is
    (V,) or (B, V), each row processed alone (``recent_tokens`` (W,) or
    (B, W), -1 padded)."""
    logits = logits.float()
    v = logits.shape[-1]
    if recent_tokens is not None and repetition_penalty != 1.0:
        idx = torch.where(recent_tokens >= 0, recent_tokens,
                          torch.full_like(recent_tokens, v)).long()
        seen = torch.zeros((*logits.shape[:-1], v + 1), dtype=torch.bool,
                           device=logits.device).scatter_(-1, idx, True)
        penalized = torch.where(logits > 0, logits / repetition_penalty,
                                logits * repetition_penalty)
        logits = torch.where(seen[..., :v], penalized, logits)
    if mask is not None:
        logits = torch.where(mask, logits, NEG_INF)
    if min_p > 0.0:
        top = logits.max(dim=-1, keepdim=True).values
        logits = torch.where(logits - top >= math.log(min_p), logits,
                             NEG_INF)
    logits = logits / max(temperature, 1e-6)
    if 0 < top_k < v:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits >= kth, logits, NEG_INF)
    if top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        # Keep tokens while the exclusive cumulative prob is < top_p.
        cutoff_idx = ((cum - probs) < top_p).sum(dim=-1, keepdim=True) - 1
        cutoff = sorted_logits.gather(-1, cutoff_idx.clamp_min(0))
        logits = torch.where(logits >= cutoff, logits, NEG_INF)
    return logits


def sample(logits: torch.Tensor, generator: torch.Generator,
           temperature: float, top_k: int = 40, top_p: float = 0.95,
           min_p: float = 0.0, mask: Optional[torch.Tensor] = None,
           recent_tokens: Optional[torch.Tensor] = None,
           repetition_penalty: float = 1.0) -> torch.Tensor:
    """Draw one token id (0-d int64 tensor on the logits' device)."""
    final = _process_chain(logits, temperature, top_k, top_p, min_p, mask,
                           recent_tokens, repetition_penalty)
    probs = torch.softmax(final, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[0]


def spec_verify_sampled(logits: torch.Tensor, proposal: torch.Tensor,
                        n_prop: int, generator: torch.Generator,
                        temperature: float, recent: torch.Tensor,
                        top_k: int = 40, top_p: float = 0.95,
                        min_p: float = 0.0,
                        repetition_penalty: float = 1.0) -> torch.Tensor:
    """Rejection-sampling verification of point-mass drafts (prompt-lookup
    proposals), exact with respect to :func:`sample`'s distribution.

    ``logits`` (B, V) are the verify pass's rows, ``proposal`` (B-1,) the
    proposed ids padded past ``n_prop``, ``recent`` (B, W) each position's
    repetition window. Proposal i is accepted with probability p_i(prop_i),
    where p_i is the full chain of :func:`_process_chain`; at the first
    rejection the token is drawn from p_i with prop_i's mass removed, and
    when all ``n_prop`` are accepted a bonus token is drawn from the next
    row's p (Leviathan et al.'s scheme with a point-mass draft). Returns one
    (2,) int32 tensor [accepted, final token], so the caller fetches once a
    pass; rows past ``n_prop + 1`` are padding and never read."""
    kpad = proposal.shape[0]
    proc = _process_chain(logits, temperature, top_k, top_p, min_p, None,
                          recent, repetition_penalty)            # (B, V)
    u = torch.rand((kpad,), generator=generator, device=logits.device)
    logp = torch.log_softmax(proc[:kpad], dim=-1)
    proposal = proposal.long()
    p_prop = logp.gather(1, proposal[:, None])[:, 0].exp()
    idx = torch.arange(kpad, device=logits.device)
    accept = (u < p_prop) & (idx < n_prop)
    n_acc = torch.cumprod(accept.to(torch.int32), dim=0).sum()
    last = proc.index_select(0, n_acc.reshape(1))[0]             # (V,)
    rejected = proposal.index_select(0, n_acc.clamp_max(kpad - 1).reshape(1))
    resid = last.scatter(0, rejected, NEG_INF)
    final = torch.where(n_acc == n_prop, last, resid)
    tok = torch.multinomial(torch.softmax(final, dim=-1), 1,
                            generator=generator)[0]
    return torch.stack([n_acc.to(torch.int32), tok.to(torch.int32)])


def greedy(logits: torch.Tensor,
           mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    if mask is not None:
        logits = torch.where(mask, logits, NEG_INF)
    return torch.argmax(logits)
