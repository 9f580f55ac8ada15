"""Attention: flash prefill (CUDA kernel) and cached decode (torch ops).

Port of ``trackiellm_tpu/ops/attention.py``. ``flash_attention`` wraps the
hand-written kernel ``csrc/flash_attn.cu`` that replaces the Pallas
``flash_attention``; ``flash_attention_ref`` is its plain twin, the same
tiled online softmax with the same tile skips, in torch ops.
``attention_ref`` mirrors the dense ``attention_xla`` oracle, and
``decode_attention`` stays plain torch ops, as it is plain XLA in the
reference.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from trackiellm_tpu_torch.ops import _build
from trackiellm_tpu_torch.ops.backend import is_cuda

NEG_INF = -1e30
# Tiles of the CUDA kernel, which its plain twin walks the same way.
BLOCK_Q = 64
BLOCK_K = 32


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


def _tile_range(qt: int, n_tiles: int, causal: bool, window: int):
    """k tiles a query tile visits: causal skips tiles wholly above the
    diagonal, a window also those wholly before it (as the TPU kernel)."""
    if not causal:
        return range(n_tiles)
    q_lo, q_hi = qt * BLOCK_Q, qt * BLOCK_Q + BLOCK_Q - 1
    end = min(n_tiles, q_hi // BLOCK_K + 1)
    begin = 0
    if window > 0:
        first_key = q_lo - window + 1
        begin = first_key // BLOCK_K if first_key > 0 else 0
    return range(begin, end)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, window: int = 0,
                        softcap: float = 0.0, scale: float = 0.0,
                        sinks: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain twin of the flash kernel: 64-query tiles, 32-key tiles, an f32
    online softmax with one rescale per tile, masked scores at -1e30 and
    the sink logit folded into the final denominator."""
    _check_flash_operands(q, k, v, sinks)
    h, s, d = q.shape
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
        for kt in _tile_range(qt, s // BLOCK_K, causal, window):
            sl = slice(kt * BLOCK_K, (kt + 1) * BLOCK_K)
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
    it on the H100 and what its design does about that) or raises; a CPU
    tensor takes :func:`flash_attention_ref`."""
    _check_flash_operands(q, k, v, sinks)
    if not is_cuda(q):
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   softcap=softcap, scale=scale, sinks=sinks)
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must be on one device")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k, v must be contiguous")
    h, s, d = q.shape
    sinks32 = None
    if sinks is not None:
        if sinks.device != q.device:
            raise ValueError("sinks must be on q's device")
        sinks32 = sinks.float().contiguous()
    out = torch.empty_like(q)
    lib = _build.library()
    status = lib.trackie_flash_attn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        sinks32.data_ptr() if sinks32 is not None else None, out.data_ptr(),
        h, k.shape[0], s, d, 0 if q.dtype == torch.float32 else 1,
        scale or 1.0 / math.sqrt(d), int(causal), window, softcap,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(status, "flash_attention")
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


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cur_len: int, window: int = 0,
                     softcap: float = 0.0, scale: float = 0.0,
                     sinks: Optional[torch.Tensor] = None,
                     chunk: int = 0) -> torch.Tensor:
    """One query (H, D) against a length-masked cache (S_max, Hk, D).
    ``cur_len`` (host int) counts the valid rows, the new token's included.
    Operands are rounded to the cache's dtype and multiplied in f32, as the
    reference's ``preferred_element_type=f32`` einsums."""
    h, d = q.shape
    s_max, hk, _ = k_cache.shape
    rep = h // hk
    scale = scale or 1.0 / math.sqrt(d)
    qg = q.reshape(hk, rep, d).to(k_cache.dtype).float()
    s = torch.einsum("grd,sgd->grs", qg, k_cache.float()) * scale
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
    p = p.to(v_cache.dtype).float()
    out = torch.einsum("grs,sgd->grd", p, v_cache.float())
    return out.reshape(h, d).to(q.dtype)
