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
``extend`` shares).
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
