"""Attention: flash prefill (CUDA kernel) and cached decode (torch ops).

Port of ``trackiellm_tpu/ops/attention.py``. ``flash_attention`` wraps the
hand-written kernels of ``csrc/flash_attn.cu`` that replace the Pallas
``flash_attention``: bf16 runs on the tensor cores, f32 on the CUDA cores.
``flash_attention_ref`` is their plain twin, the same tiled online softmax
with the same tiles and tile skips, in torch ops.
``attention_ref`` mirrors the dense ``attention_xla`` oracle, and
``decode_attention`` stays torch ops, as it is plain XLA in the reference:
on the card its two products read the cache in its storage dtype with f32
sums (:func:`cache_scores`, :func:`cache_mix`, which ``models/llm.py``'s
``extend`` shares). ``decode_attention_batch`` is the serving slots' decode
attention with per-row lengths on the device, and ``paged_decode_attention``
the reference's decode over a page pool; both are plain XLA there too.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from trackiellm_tpu_torch.ops import _build
from trackiellm_tpu_torch.ops.backend import is_cuda

NEG_INF = -1e30
# Tiles of the CUDA kernels, which their plain twin walks the same way:
# 64 query rows, and keys in tiles of 64 (bf16, tensor cores) or 32 (f32).
BLOCK_Q = 64
BLOCK_K = {torch.bfloat16: 64, torch.float32: 32}

_flash_attn = _build.Launcher("trackie_flash_attn", "flash_attention")


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True, window: int = 0, softcap: float = 0.0,
                  scale: float = 0.0, sinks: Optional[torch.Tensor] = None,
                  chunk: int = 0) -> torch.Tensor:
    """Dense attention over q (H, Sq, D) and k/v (Hk, Sk, D), query and key
    ends aligned by ``Sk - Sq``. ``window`` 0 = unbounded, ``softcap`` 0 =
    off, ``scale`` 0 = 1/sqrt(D), ``sinks`` (H,) per-head extra logits,
    ``chunk`` > 0 = same aligned chunk only."""
    h, sq, d = q.shape
    hk, sk = k.shape[0], k.shape[1]
    scale = scale or 1.0 / math.sqrt(d)
    if hk != h:
        k = k.repeat_interleave(h // hk, dim=0)
        v = v.repeat_interleave(h // hk, dim=0)
    s = torch.einsum("hqd,hkd->hqk", q.float(), k.float()) * scale
    if softcap > 0.0:
        s = softcap * torch.tanh(s / softcap)
    if causal:
        qi = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
        ki = torch.arange(sk, device=q.device)[None, :]
        mask = ki <= qi
        if window > 0:
            mask &= ki > qi - window
        if chunk > 0:
            mask &= (ki // chunk) == (qi // chunk)
        s = torch.where(mask, s, NEG_INF)
    if sinks is not None:
        col = sinks.float()[:, None, None].expand(h, sq, 1)
        p = torch.softmax(torch.cat([s, col], dim=-1), dim=-1)[..., :-1]
    else:
        p = torch.softmax(s, dim=-1)
    return torch.einsum("hqk,hkd->hqd", p, v.float()).to(q.dtype)


def _tile_range(qt: int, n_tiles: int, causal: bool, window: int,
                block_k: int):
    """k tiles of ``block_k`` keys a query tile visits: causal skips tiles
    wholly above the diagonal, a window also those wholly before it (as the
    TPU kernel)."""
    if not causal:
        return range(n_tiles)
    q_lo, q_hi = qt * BLOCK_Q, qt * BLOCK_Q + BLOCK_Q - 1
    end = min(n_tiles, q_hi // block_k + 1)
    begin = 0
    if window > 0:
        first_key = q_lo - window + 1
        begin = first_key // block_k if first_key > 0 else 0
    return range(begin, end)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, window: int = 0,
                        softcap: float = 0.0, scale: float = 0.0,
                        sinks: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain twin of the flash kernels: 64-query tiles, key tiles of
    ``BLOCK_K[dtype]``, an f32 online softmax with one rescale per tile,
    masked scores at -1e30 and the sink logit folded into the final
    denominator. In bf16 the probabilities are rounded to bf16 before P V,
    as the tensor-core kernel feeds them to its products (the row sums add
    the f32 values); the products are summed in f32."""
    _check_flash_operands(q, k, v, sinks)
    h, s, d = q.shape
    block_k = BLOCK_K[q.dtype]
    round_p = q.dtype == torch.bfloat16
    rep = h // k.shape[0]
    scale = scale or 1.0 / math.sqrt(d)
    kf = k.float().repeat_interleave(rep, dim=0)
    vf = v.float().repeat_interleave(rep, dim=0)
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    rows_all = torch.arange(s, device=q.device)
    for qt in range(s // BLOCK_Q):
        rows = rows_all[qt * BLOCK_Q:(qt + 1) * BLOCK_Q, None]
        qq = q[:, qt * BLOCK_Q:(qt + 1) * BLOCK_Q].float()
        m = torch.full((h, BLOCK_Q, 1), NEG_INF, device=q.device)
        l = torch.zeros((h, BLOCK_Q, 1), device=q.device)
        acc = torch.zeros((h, BLOCK_Q, d), device=q.device)
        for kt in _tile_range(qt, s // block_k, causal, window, block_k):
            sl = slice(kt * block_k, (kt + 1) * block_k)
            sc = torch.einsum("hqd,hkd->hqk", qq, kf[:, sl]) * scale
            if softcap > 0.0:
                sc = softcap * torch.tanh(sc / softcap)
            if causal:
                cols = rows_all[None, sl]
                mask = cols <= rows
                if window > 0:
                    mask &= cols > rows - window
                sc = torch.where(mask, sc, NEG_INF)
            m_new = torch.maximum(m, sc.amax(dim=-1, keepdim=True))
            alpha = torch.exp(m - m_new)
            p = torch.exp(sc - m_new)
            l = l * alpha + p.sum(dim=-1, keepdim=True)
            if round_p:
                p = p.to(torch.bfloat16).float()
            acc = acc * alpha + torch.einsum("hqk,hkd->hqd", p, vf[:, sl])
            m = m_new
        if sinks is not None:
            sink = sinks.float()[:, None, None]
            m_tot = torch.maximum(m, sink)
            alpha = torch.exp(m - m_tot)
            l = l * alpha + torch.exp(sink - m_tot)
            acc = acc * alpha
        out[:, qt * BLOCK_Q:(qt + 1) * BLOCK_Q] = acc / l.clamp_min(1e-30)
    return out.to(q.dtype)


def _check_flash_operands(q, k, v, sinks) -> None:
    if q.dim() != 3 or k.dim() != 3 or k.shape != v.shape:
        raise ValueError("flash_attention takes q (H, S, D), k/v (Hk, S, D)")
    h, s, d = q.shape
    hk = k.shape[0]
    if k.shape[1:] != (s, d) or h % hk:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}")
    if q.dtype not in (torch.float32, torch.bfloat16) or not (
            q.dtype == k.dtype == v.dtype):
        raise TypeError(f"q, k, v must share float32 or bfloat16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if d not in (64, 128):
        raise ValueError(f"head dim {d} not supported (64 or 128)")
    if s % BLOCK_Q:
        raise ValueError(f"sequence {s} must be a multiple of {BLOCK_Q}")
    if sinks is not None and tuple(sinks.shape) != (h,):
        raise ValueError(f"sinks must be ({h},), got {tuple(sinks.shape)}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int = 0,
                    softcap: float = 0.0, scale: float = 0.0,
                    sinks: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Flash attention over q (H, S, D), k/v (Hk, S, D); out in q's dtype.

    Replaces ``trackiellm_tpu/ops/attention.py:flash_attention``. A CUDA
    tensor launches ``csrc/flash_attn.cu`` (see its header for what bounds
    it on the H100 and what its design does about that): bf16 the
    tensor-core kernel, f32 the CUDA-core one, chosen by dtype; or it
    raises. A CPU tensor takes :func:`flash_attention_ref`."""
    _check_flash_operands(q, k, v, sinks)
    if not is_cuda(q):
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   softcap=softcap, scale=scale, sinks=sinks)
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must be on one device")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k, v must be contiguous")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("q, k, v must be 16-byte aligned")
    h, s, d = q.shape
    sinks32 = None
    if sinks is not None:
        if sinks.device != q.device:
            raise ValueError("sinks must be on q's device")
        sinks32 = sinks.float().contiguous()
    out = torch.empty_like(q)
    _flash_attn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        sinks32.data_ptr() if sinks32 is not None else None, out.data_ptr(),
        h, k.shape[0], s, d, 0 if q.dtype == torch.float32 else 1,
        scale or 1.0 / math.sqrt(d), int(causal), window, softcap,
        _build.stream(q))
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


def prefill_attention(q, k, v, causal: bool = True, window: int = 0,
                      softcap: float = 0.0, scale: float = 0.0, sinks=None,
                      chunk: int = 0) -> torch.Tensor:
    """The JAX dispatch rule: the flash kernel on the device for S >= 256
    with S % 256 == 0 and no chunk mask; dense attention otherwise."""
    s = q.shape[1]
    if chunk == 0 and is_cuda(q) and s >= 256 and s % 256 == 0:
        return flash_attention(q, k, v, causal=causal, window=window,
                               softcap=softcap, scale=scale, sinks=sinks)
    return attention_ref(q, k, v, causal=causal, window=window,
                         softcap=softcap, scale=scale, sinks=sinks,
                         chunk=chunk)


def cache_scores(qg: torch.Tensor, k_cache: torch.Tensor) -> torch.Tensor:
    """(Hk, R, D) queries against an (S, Hk, D) key cache: (Hk, R, S) f32
    dots, the queries rounded to the cache's dtype first.

    On the card, one batched product reads the (Hk, D, S) view of the cache
    as it is stored (bf16 in the model, no copy) and sums in f32, as the
    reference's ``preferred_element_type=f32`` einsum does; an f32 copy of
    the cache would cost its traffic on every layer. On the CPU both
    operands are widened to f32. Products of bf16 values are exact in f32,
    so the two routes differ only in the order of the sums."""
    qg = qg.to(k_cache.dtype)
    if is_cuda(qg):
        return torch.bmm(qg, k_cache.permute(1, 2, 0),
                         out_dtype=torch.float32)
    return torch.einsum("grd,sgd->grs", qg.float(), k_cache.float())


def cache_mix(p: torch.Tensor, v_cache: torch.Tensor) -> torch.Tensor:
    """(Hk, R, S) probabilities times an (S, Hk, D) value cache: (Hk, R, D)
    f32, the probabilities rounded to the cache's dtype first; the card
    reads the (Hk, S, D) view as :func:`cache_scores` does."""
    p = p.to(v_cache.dtype)
    if is_cuda(p):
        return torch.bmm(p, v_cache.transpose(0, 1), out_dtype=torch.float32)
    return torch.einsum("grs,sgd->grd", p.float(), v_cache.float())


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cur_len: int, window: int = 0,
                     softcap: float = 0.0, scale: float = 0.0,
                     sinks: Optional[torch.Tensor] = None,
                     chunk: int = 0) -> torch.Tensor:
    """One query (H, D) against a length-masked cache (S_max, Hk, D).
    ``cur_len`` (host int) counts the valid rows, the new token's included.
    Operands are rounded to the cache's dtype and multiplied with f32 sums
    (:func:`cache_scores`, :func:`cache_mix`), as the reference's
    ``preferred_element_type=f32`` einsums."""
    h, d = q.shape
    s_max, hk, _ = k_cache.shape
    rep = h // hk
    scale = scale or 1.0 / math.sqrt(d)
    s = cache_scores(q.reshape(hk, rep, d), k_cache) * scale
    if softcap > 0.0:
        s = softcap * torch.tanh(s / softcap)
    idx = torch.arange(s_max, device=q.device)
    mask = idx < cur_len
    if window > 0:
        mask &= idx >= cur_len - window
    if chunk > 0:
        mask &= idx >= ((cur_len - 1) // chunk) * chunk
    s = torch.where(mask, s, NEG_INF)
    if sinks is not None:
        col = sinks.float().reshape(hk, rep, 1)
        p = torch.softmax(torch.cat([s, col], dim=-1), dim=-1)[..., :-1]
    else:
        p = torch.softmax(s, dim=-1)
    out = cache_mix(p, v_cache)
    return out.reshape(h, d).to(q.dtype)


def _bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched product with f32 sums and an f32 result, the operands read
    in their storage dtype."""
    if a.dtype == torch.float32:
        return torch.bmm(a, b)
    return torch.bmm(a, b, out_dtype=torch.float32)


def batch_cache_scores(qg: torch.Tensor, k_cache: torch.Tensor) -> torch.Tensor:
    """(B, Hk, R, D) queries against per-row (B, S, Hk, D) key caches:
    (B, Hk, R, S) f32 dots, the queries rounded to the cache's dtype first
    (:func:`cache_scores` for a batch of rows).

    On the card one batched product reads each row's cache once, as the
    (S * Hk, D) matrix it is stored as (no copy): all (B, H) queries
    against all (S, Hk) key rows, then the (head, its own kv head)
    diagonal is kept. The products off that diagonal are Hk times the
    needed operations, a few microseconds at Mistral's widths, where a
    (B * Hk)-batched product would need a copy of the cache (its two
    batch strides do not merge). On the CPU both operands are widened to
    f32."""
    b, hk, rep, d = qg.shape
    s = k_cache.shape[1]
    qg = qg.to(k_cache.dtype)
    if not is_cuda(qg):
        return torch.einsum("bgrd,bsgd->bgrs", qg.float(), k_cache.float())
    full = _bmm_f32(qg.reshape(b, hk * rep, d),
                    k_cache.reshape(b, s * hk, d).transpose(1, 2))
    diag = torch.diagonal(full.view(b, hk, rep, s, hk), dim1=1, dim2=4)
    return diag.permute(0, 3, 1, 2)                     # (B, Hk, R, S)


def batch_cache_mix(p: torch.Tensor, v_cache: torch.Tensor) -> torch.Tensor:
    """(B, Hk, R, S) probabilities times per-row (B, S, Hk, D) value
    caches: (B, Hk, R, D) f32, the probabilities rounded to the cache's
    dtype first. The card reads each row's cache once as its (S * Hk, D)
    matrix, against the probabilities placed on their kv head's columns
    of a zeroed (H, S * Hk) matrix: the zeros add exact zeros."""
    b, hk, rep, s = p.shape
    d = v_cache.shape[-1]
    p = p.to(v_cache.dtype)
    if not is_cuda(p):
        return torch.einsum("bgrs,bsgd->bgrd", p.float(), v_cache.float())
    full = p.new_zeros((b, hk, rep, s, hk))
    torch.diagonal(full, dim1=1, dim2=4).copy_(p.permute(0, 2, 3, 1))
    out = _bmm_f32(full.view(b, hk * rep, s * hk),
                   v_cache.reshape(b, s * hk, d))
    return out.view(b, hk, rep, d)


def decode_attention_batch(q: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor, cur_len: torch.Tensor,
                           window: int = 0, scale: float = 0.0
                           ) -> torch.Tensor:
    """One query per row, q (B, H, D), against per-row length-masked caches
    (B, S, Hk, D): the reference's ``jax.vmap`` of decode attention over
    the serving slots (``trackiellm_tpu/models/llm.py:1791-1794``).
    ``cur_len`` (B,) is a device tensor of each row's valid rows, the new
    token's included, so the mask is made on the device."""
    b, h, d = q.shape
    s_max, hk = k_cache.shape[1], k_cache.shape[2]
    scale = scale or 1.0 / math.sqrt(d)
    s = batch_cache_scores(q.reshape(b, hk, h // hk, d), k_cache) * scale
    idx = torch.arange(s_max, device=q.device)
    cur = cur_len.reshape(b, 1)
    mask = idx < cur
    if window > 0:
        mask &= idx >= cur - window
    s = torch.where(mask[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return batch_cache_mix(p, v_cache).reshape(b, h, d).to(q.dtype)


def paged_decode_attention(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, page_table: torch.Tensor,
                           cur_len: int, window: int = 0,
                           softcap: float = 0.0, scale: float = 0.0,
                           sinks: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """Decode attention over a paged KV pool (n_pages, page_size, Hk, D):
    one sequence's pages gathered through ``page_table`` (its page ids)
    into a contiguous cache, then :func:`decode_attention`. Port of
    ``trackiellm_tpu/ops/attention.py:paged_decode_attention``."""
    k_seq = k_pages[page_table.long()].reshape(-1, *k_pages.shape[2:])
    v_seq = v_pages[page_table.long()].reshape(-1, *v_pages.shape[2:])
    return decode_attention(q, k_seq, v_seq, cur_len, window=window,
                            softcap=softcap, scale=scale, sinks=sinks)
