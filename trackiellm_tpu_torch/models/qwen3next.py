"""Qwen3-Next: the hybrid Gated-DeltaNet / gated-attention family.

Port of ``trackiellm_tpu/models/qwen3next.py``: the same config, params
tree (``layers`` is a list of per-layer dicts, as the layer kinds differ),
cache and forward surface, in torch ops. Qwen3-Next-80B-A3B mixes, 3:1,
linear-attention Gated DeltaNet layers (a causal convolution, then a
per-head gated delta-rule state) with gated full-attention layers (GQA,
zero-centered per-head QK RMSNorm, partial rotary, a sigmoid output gate),
over a Qwen-MoE MLP (softmax top-k renormalized, a sigmoid-gated shared
expert) and zero-centered RMSNorms.

No Pallas kernel is reached from the reference module: the delta rule is
plain XLA there (a scan, or the chunked form with a unit-lower triangular
solve) and stays torch ops here; the attention is f32 einsums over the
whole cache, as the reference's. Every quantized projection, the experts
and ``lm_head`` included, goes through ``models/llm.py:_linear``: W4A8 on
the card at Q4 (f32a above 512 rows), Q8's kernel at Q8.

- ``forward(length=)``: padded positions are inert. Their K/V rows land
  past the advanced length (overwritten by the next call, masked until
  then), the convolution window is taken at the last real input, and the
  recurrence sees them as no-ops (g = 0, beta = 0). ``length`` and the
  cache's ``length`` may be 0-dim device tensors: a step reads no value
  back to the host (the routed MoE's group sizes aside).
- The MoE keeps the reference's own order, not ``models/llm.py``'s
  ``_moe_block``'s: the dense-all-experts sum starts from zero, adds the
  experts in index order, and adds the gated shared expert last.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from trackiellm_tpu_torch.models.llm import (_grouped_dot, _linear,
                                             _moe_use_routed, _top_k_first,
                                             quantized_stack)
from trackiellm_tpu_torch.models.mamba import softplus
from trackiellm_tpu_torch.ops.backend import default_device
from trackiellm_tpu_torch.ops.quant import (QuantizedLinear, quantize_q4,
                                            quantize_q8)
from trackiellm_tpu_torch.ops.scan import cumsum


class Qwen3NextConfig(NamedTuple):
    vocab_size: int = 2048
    dim: int = 64
    n_layers: int = 4
    layer_types: Tuple[str, ...] = ("l", "l", "l", "f")  # l=linear f=full
    # full attention
    n_heads: int = 4
    n_kv_heads: int = 2
    head_dim: int = 16
    partial_rotary_factor: float = 0.25
    rope_theta: float = 10000.0
    # gated deltanet (linear attention)
    lin_k_heads: int = 2
    lin_v_heads: int = 4
    lin_dk: int = 16
    lin_dv: int = 16
    conv_k: int = 4
    # MLP / MoE (n_experts=0 -> dense MLP of hidden_dim)
    hidden_dim: int = 128
    n_experts: int = 0
    n_experts_used: int = 2
    moe_hidden: int = 0
    shared_hidden: int = 0
    norm_topk: bool = True
    norm_eps: float = 1e-6
    max_seq: int = 512

    @property
    def conv_dim(self) -> int:
        return 2 * self.lin_k_heads * self.lin_dk \
            + self.lin_v_heads * self.lin_dv

    @classmethod
    def tiny(cls) -> "Qwen3NextConfig":
        return cls()

    @classmethod
    def qwen3_next_80b_a3b(cls) -> "Qwen3NextConfig":
        """Qwen/Qwen3-Next-80B-A3B-Instruct's config.json: 48 layers, full
        attention every 4th."""
        return cls(vocab_size=151936, dim=2048, n_layers=48,
                   layer_types=("l", "l", "l", "f") * 12, n_heads=16,
                   n_kv_heads=2, head_dim=256, partial_rotary_factor=0.25,
                   rope_theta=1e7, lin_k_heads=16, lin_v_heads=32,
                   lin_dk=128, lin_dv=128, conv_k=4, hidden_dim=512,
                   n_experts=512, n_experts_used=10, moe_hidden=512,
                   shared_hidden=512, norm_topk=True, norm_eps=1e-6,
                   max_seq=4096)


def _rms(xf: torch.Tensor, eps: float) -> torch.Tensor:
    return xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)


def _norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """Zero-centered RMSNorm: the weight stores w, the scale is (1 + w),
    all in f32 before the cast (Qwen3NextRMSNorm)."""
    return (_rms(x.float(), eps) * (1.0 + w.float())).to(x.dtype)


def _gated_norm(x: torch.Tensor, w: torch.Tensor, gate: torch.Tensor,
                eps: float) -> torch.Tensor:
    """Norm, then gate (Qwen3NextRMSNormGated: a plain weight, an f32 silu
    gate)."""
    xf = w.float() * _rms(x.float(), eps)
    return (xf * F.silu(gate.float())).to(x.dtype)


def _l2norm(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """``x * rsqrt(sum(x^2) + eps)``: eps inside the root (not
    ``F.normalize``'s clamp of the norm)."""
    return x * torch.rsqrt((x * x).sum(dim=-1, keepdim=True) + eps)


def _rope(x: torch.Tensor, positions: torch.Tensor,
          cfg: Qwen3NextConfig) -> torch.Tensor:
    """Partial split-half rotary on the first head_dim * factor dims of
    (S, H, D) rows at ``positions`` (S,)."""
    rot = int(cfg.head_dim * cfg.partial_rotary_factor)
    half = rot // 2
    expo = torch.arange(half, dtype=torch.float32, device=x.device) / half
    freqs = 1.0 / torch.pow(torch.tensor(cfg.rope_theta, dtype=torch.float32,
                                         device=x.device), expo)
    ang = positions[:, None].float() * freqs                  # (S, half)
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :rot].float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                    dim=-1).to(x.dtype)
    return torch.cat([out, x[..., rot:]], dim=-1)


# ---------------------------------------------------------------------------
# Full-attention layer (gated)
# ---------------------------------------------------------------------------

def fuse_projections(params, cfg: Qwen3NextConfig):
    """Each layer's input projections concatenated into ONE matrix
    (``w_in``): linear layers [wq|wk|wv|wz|wb|wa], attention layers
    [wq|wk|wv]. Dense trees only; a layer with quantized projections keeps
    the split layout."""
    layers = []
    for lt, lp in zip(cfg.layer_types, params["layers"]):
        keys = (("wq", "wk", "wv", "wz", "wb", "wa") if lt == "l"
                else ("wq", "wk", "wv"))
        if any(isinstance(lp[k], QuantizedLinear) for k in keys):
            layers.append(lp)
            continue
        lp = dict(lp)
        lp["w_in"] = torch.cat([lp.pop(k) for k in keys], dim=1)
        layers.append(lp)
    return {**params, "layers": layers}


def _rows_at(start: torch.Tensor, s: int, total: int) -> torch.Tensor:
    """Row indices of ``dynamic_update_slice`` at ``start``: the start
    clamped so that the ``s`` rows fit in ``total``."""
    first = torch.clamp(start, 0, total - s)
    return first + torch.arange(s, device=start.device)


def _attn_layer(lp, cfg: Qwen3NextConfig, x, positions, k_cache, v_cache,
                kv_len):
    """x (S, D); the cache (S_cache, Hk, hd) holds positions [0, kv_len);
    this call writes S new ones from kv_len. Returns (out, new_k, new_v)."""
    s = x.shape[0]
    h, hk, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    if "w_in" in lp:
        y = _linear(x, lp["w_in"])
        qd, kvd = h * 2 * hd, hk * hd
        qg = y[:, :qd].reshape(s, h, 2 * hd)
        k = y[:, qd:qd + kvd].reshape(s, hk, hd)
        v = y[:, qd + kvd:].reshape(s, hk, hd)
    else:
        qg = _linear(x, lp["wq"]).reshape(s, h, 2 * hd)
        k = _linear(x, lp["wk"]).reshape(s, hk, hd)
        v = _linear(x, lp["wv"]).reshape(s, hk, hd)
    q, gate = qg[..., :hd], qg[..., hd:]
    q = _rope(_norm(q, lp["q_norm"], cfg.norm_eps), positions, cfg)
    k = _rope(_norm(k, lp["k_norm"], cfg.norm_eps), positions, cfg)

    rows = _rows_at(kv_len, s, k_cache.shape[0])
    new_k = k_cache.index_copy(0, rows, k.to(k_cache.dtype))
    new_v = v_cache.index_copy(0, rows, v.to(v_cache.dtype))

    rep = h // hk
    qh = q.reshape(s, hk, rep, hd).float()
    scores = torch.einsum("sgrd,tgd->grst", qh,
                          new_k.float()) / math.sqrt(hd)
    t_idx = torch.arange(new_k.shape[0], device=x.device)
    mask = t_idx[None, None, None, :] <= positions[None, None, :, None]
    scores = scores.masked_fill(~mask, float("-inf"))
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("grst,tgd->sgrd", p,
                       new_v.float()).reshape(s, h * hd)
    out = out.to(x.dtype) * torch.sigmoid(
        gate.reshape(s, h * hd).float()).to(x.dtype)
    return _linear(out, lp["wo"]), new_k, new_v


# ---------------------------------------------------------------------------
# Gated DeltaNet layer (linear attention)
# ---------------------------------------------------------------------------

def _delta_step(state, q_t, k_t, v_t, g_t, b_t):
    """One token of the gated delta rule over (Hv, dk, dv) states."""
    state = state * torch.exp(g_t)[:, None, None]
    kv_mem = torch.einsum("hkv,hk->hv", state, k_t)
    delta = (v_t - kv_mem) * b_t[:, None]
    state = state + k_t[:, :, None] * delta[:, None, :]
    return state, torch.einsum("hkv,hk->hv", state, q_t)


def _delta_layer(lp, cfg: Qwen3NextConfig, x, conv_state, rec_state,
                 length, real):
    """x (S, D); ``length``/``real`` mark the real prefix (see forward).
    conv_state (conv_dim, K-1) holds the PREVIOUS inputs; rec_state
    (Hv, dk, dv) f32. Returns (out, new conv state, new rec state)."""
    s = x.shape[0]
    hk, hv = cfg.lin_k_heads, cfg.lin_v_heads
    dk, dv = cfg.lin_dk, cfg.lin_dv
    if "w_in" in lp:
        y = _linear(x, lp["w_in"])
        widths = (hk * dk, hk * dk, hv * dv, hv * dv, hv, hv)
        q, k, v, z, b, a = y.split(widths, dim=-1)
        z = z.reshape(s, hv, dv)
    else:
        q = _linear(x, lp["wq"])
        k = _linear(x, lp["wk"])
        v = _linear(x, lp["wv"])
        z = _linear(x, lp["wz"]).reshape(s, hv, dv)
        b = x @ lp["wb"]
        a = x @ lp["wa"]

    mixed = torch.cat([q, k, v], dim=-1)                      # (S, C)
    dt = torch.promote_types(conv_state.dtype, mixed.dtype)
    hist = torch.cat([conv_state.t().to(dt), mixed.to(dt)])   # (K-1+S, C)
    # The window ending at the LAST REAL input: hist[K-1+t] is input t, so
    # the K-1 rows before the first pad start at hist[length].
    win = length + torch.arange(cfg.conv_k - 1, device=x.device)
    new_conv = hist.index_select(0, win).t().to(conv_state.dtype)
    w = lp["conv_w"].float()                                  # (C, K)
    acc = torch.zeros((s, cfg.conv_dim), dtype=torch.float32,
                      device=x.device)
    for j in range(cfg.conv_k):
        acc = acc + hist[j:j + s].float() * w[:, j]
    mixed = F.silu(acc).to(x.dtype)

    kd = hk * dk
    q = mixed[:, :kd].reshape(s, hk, dk)
    k = mixed[:, kd:2 * kd].reshape(s, hk, dk)
    v = mixed[:, 2 * kd:].reshape(s, hv, dv)

    beta = torch.sigmoid(b.float())                           # (S, Hv)
    g = -torch.exp(lp["a_log"].float()) * softplus(
        a.float() + lp["dt_bias"].float())
    # Padded positions are recurrence no-ops: decay exp(0) = 1, beta = 0.
    beta = torch.where(real[:, None], beta, 0.0)
    g = torch.where(real[:, None], g, 0.0)
    rep = hv // hk
    q = _l2norm(q.repeat_interleave(rep, dim=1).float()) / math.sqrt(dk)
    k = _l2norm(k.repeat_interleave(rep, dim=1).float())
    v = v.float()

    if s >= 8:
        core, rec = _chunk_gated_delta(
            q.transpose(0, 1), k.transpose(0, 1), v.transpose(0, 1),
            g.t(), beta.t(), rec_state.float())
        core = core.transpose(0, 1)                           # (S, Hv, dv)
    else:
        rec, outs = rec_state.float(), []
        for t in range(s):
            rec, o = _delta_step(rec, q[t], k[t], v[t], g[t], beta[t])
            outs.append(o)
        core = torch.stack(outs)
    core = _gated_norm(core.to(x.dtype), lp["o_norm"], z, cfg.norm_eps)
    return _linear(core.reshape(s, hv * dv), lp["wo"]), new_conv, rec


def _chunk_gated_delta(q, k, v, g, beta, state0, chunk: int = 64):
    """The chunk-parallel gated delta rule: in-chunk dense products and one
    unit-lower triangular solve, one sequential carry a chunk (the
    reference's ``torch_chunk_gated_delta_rule``), the recurrence's math
    reassociated.

    q, k: (H, T, dk), l2-normed, q scaled by 1/sqrt(dk); v: (H, T, dv);
    g, beta: (H, T); state0 (H, dk, dv) f32. Returns (out (H, T, dv) f32,
    the final state)."""
    h, t, dk = k.shape
    dv = v.shape[-1]
    c = min(chunk, max(8, t))
    pad = (-t) % c
    if pad:
        q, k, v = (F.pad(a, (0, 0, 0, pad)) for a in (q, k, v))
        g, beta = F.pad(g, (0, pad)), F.pad(beta, (0, pad))
    n = (t + pad) // c
    qc = q.reshape(h, n, c, dk)
    kc = k.reshape(h, n, c, dk)
    vc = v.reshape(h, n, c, dv)
    gc = cumsum(g.reshape(h, n, c))                           # in-chunk decay
    bc = beta.reshape(h, n, c)
    v_beta = vc * bc[..., None]
    k_beta = kc * bc[..., None]

    ones = torch.ones((c, c), dtype=torch.bool, device=q.device)
    tri, tri_lo = torch.tril(ones), torch.tril(ones, -1)
    decay = torch.where(tri, torch.exp(gc[..., :, None] - gc[..., None, :]),
                        0.0)
    a = torch.where(tri_lo, -(torch.einsum("hncd,hnkd->hnck", k_beta, kc)
                              * decay), 0.0)
    # attn = (I - A)^{-1} for the unit-lower-triangular (I - A).
    eye = torch.eye(c, dtype=a.dtype, device=a.device)
    inv = torch.linalg.solve_triangular(eye - a, eye.expand(a.shape),
                                        upper=False, unitriangular=True)
    u = torch.einsum("hnck,hnkd->hncd", inv, v_beta)
    w = torch.einsum("hnck,hnkd->hncd", inv,
                     k_beta * torch.exp(gc)[..., None])

    state, outs = state0, []
    for i in range(n):
        q_i, k_i, u_i, w_i = qc[:, i], kc[:, i], u[:, i], w[:, i]
        g_i, d_i = gc[:, i], decay[:, i]
        v_new = u_i - torch.einsum("hcd,hdv->hcv", w_i, state)
        attn_inter = torch.einsum("hcd,hdv->hcv",
                                  q_i * torch.exp(g_i)[..., None], state)
        intra = torch.where(tri, torch.einsum("hcd,hkd->hck", q_i, k_i)
                            * d_i, 0.0)
        outs.append(attn_inter + torch.einsum("hck,hkv->hcv", intra, v_new))
        g_last = g_i[:, -1]
        state = state * torch.exp(g_last)[:, None, None] + torch.einsum(
            "hcd,hcv->hdv",
            k_i * torch.exp(g_last[:, None] - g_i)[..., None], v_new)
    out = torch.stack(outs, dim=1).reshape(h, t + pad, dv)
    return out[:, :t], state


# ---------------------------------------------------------------------------
# MLP / MoE
# ---------------------------------------------------------------------------

def _expert(bank, e: int):
    """Expert ``e`` of a dense (E, K, N) bank or a per-expert
    QuantizedLinear stack: a view."""
    if isinstance(bank, QuantizedLinear):
        return QuantizedLinear(values=bank.values[e], scales=bank.scales[e])
    return bank[e]


def _moe_select(x, lp, cfg: Qwen3NextConfig):
    """The router's (S, E) f32 softmax scores, and the values its top-k
    selects on (the same scores)."""
    scores = torch.softmax((x @ lp["moe_gate"]).float(), dim=-1)
    return scores, scores


def _moe_weights(scores, topi, cfg: Qwen3NextConfig):
    """The (S, K) f32 weights of experts ``topi``, renormalized under
    ``norm_topk``."""
    topv = scores.gather(-1, topi)
    if cfg.norm_topk:
        topv = topv / topv.sum(dim=-1, keepdim=True)
    return topv


def _moe_router(x, lp, cfg: Qwen3NextConfig):
    """Softmax, top-k in ``lax.top_k``'s order, renormalized: ((S, K) f32
    weights, (S, K) expert ids)."""
    scores, select = _moe_select(x, lp, cfg)
    topi = _top_k_first(select, cfg.n_experts_used)
    return _moe_weights(scores, topi, cfg), topi


def _moe_routed(x, lp, cfg: Qwen3NextConfig, topv, topi):
    """The sorted grouped products (the reference's ``lax.ragged_dot``
    pair): the (S * K) slots stably sorted by expert, each expert's run
    through its bank with f32 sums, the weighted outputs summed per token
    in ascending expert order from 0.0 (the reference's scatter-add into
    zeros in sorted-slot order). The group sizes are read on the host."""
    s, kk = topi.shape
    flat = topi.reshape(-1)
    order = torch.sort(flat, stable=True).indices
    xs = x[order // kk]
    sizes = torch.bincount(flat, minlength=cfg.n_experts).tolist()
    gate, up = _grouped_dot(xs, lp["w_gu"], sizes).chunk(2, dim=-1)
    ys = _grouped_dot((F.silu(gate) * up).to(x.dtype), lp["w_down"], sizes)
    ys = ys * topv.reshape(-1)[order][:, None]
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.shape[0], device=order.device)
    pos = torch.sort(inv.reshape(s, kk), dim=-1).values
    out = torch.zeros((s, cfg.dim), dtype=torch.float32, device=x.device)
    for j in range(kk):
        out = out + ys[pos[:, j]]
    return out


def _mlp(lp, cfg: Qwen3NextConfig, x):
    if "moe_gate" not in lp:
        gate, up = _linear(x, lp["w_gu"]).chunk(2, dim=-1)
        return _linear(F.silu(gate) * up, lp["w_down"])
    topv, topi = _moe_router(x, lp, cfg)
    if _moe_use_routed(x.shape[0], lp["w_gu"]):
        out = _moe_routed(x, lp, cfg, topv, topi)
    else:
        # Dense-all-experts (decode sizes, quantized banks): every expert
        # on every row, weighted by the (S, E) matrix that is zero off the
        # top-k, summed in expert order from zero.
        weights = torch.zeros((x.shape[0], cfg.n_experts),
                              dtype=torch.float32, device=x.device)
        weights = weights.scatter(-1, topi, topv)
        out = torch.zeros((x.shape[0], cfg.dim), dtype=torch.float32,
                          device=x.device)
        for e in range(cfg.n_experts):
            gate, up = _linear(x, _expert(lp["w_gu"], e)).chunk(2, dim=-1)
            y = _linear(F.silu(gate) * up, _expert(lp["w_down"], e))
            out = out + weights[:, e:e + 1] * y.float()
    sg = torch.sigmoid((x @ lp["shared_gate"]).float())
    gate, up = _linear(x, lp["shared_gu"]).chunk(2, dim=-1)
    shared = _linear(F.silu(gate) * up, lp["shared_down"])
    return (out + sg * shared.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# Cache + forward
# ---------------------------------------------------------------------------

def create_cache(cfg: Qwen3NextConfig, dtype: torch.dtype = torch.float32,
                 device: Optional[torch.device] = None) -> Dict[str, Any]:
    """Per-layer hybrid state on ``device`` (the CUDA card by default):
    (k, v) for full-attention layers, (conv, rec) for linear ones;
    ``length`` (a 0-dim int32 tensor there) counts the ingested tokens."""
    device = default_device(device, "allocate a Qwen3-Next cache")
    states: List[Dict[str, Any]] = []
    for lt in cfg.layer_types:
        if lt == "f":
            shape = (cfg.max_seq, cfg.n_kv_heads, cfg.head_dim)
            states.append({
                "k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)})
        else:
            states.append({
                "conv": torch.zeros((cfg.conv_dim, cfg.conv_k - 1),
                                    dtype=dtype, device=device),
                "rec": torch.zeros((cfg.lin_v_heads, cfg.lin_dk,
                                    cfg.lin_dv), dtype=torch.float32,
                                   device=device)})
    return {"layers": states,
            "length": torch.zeros((), dtype=torch.int32, device=device)}


def _hidden(params, cfg: Qwen3NextConfig, tokens: torch.Tensor, cache,
            length=None):
    """The stack over tokens (S,) from ``cache``: (final residual rows
    (S, D), new cache)."""
    dev = params["tok_emb"].device
    tokens = torch.as_tensor(tokens, device=dev).reshape(-1).long()
    s = tokens.shape[0]
    start = torch.as_tensor(cache["length"], dtype=torch.int32, device=dev)
    length = torch.as_tensor(s if length is None else length,
                             dtype=torch.int32, device=dev)
    steps = torch.arange(s, device=dev)
    positions = start + steps
    real = steps < length
    x = params["tok_emb"][tokens]
    new_states = []
    for li, lt in enumerate(cfg.layer_types):
        lp = params["layers"][li]
        st = cache["layers"][li]
        h = _norm(x, lp["attn_norm"], cfg.norm_eps)
        if lt == "f":
            out, nk, nv = _attn_layer(lp, cfg, h, positions, st["k"],
                                      st["v"], start)
            new_states.append({"k": nk, "v": nv})
        else:
            out, nc, nr = _delta_layer(lp, cfg, h, st["conv"], st["rec"],
                                       length, real)
            new_states.append({"conv": nc, "rec": nr})
        x = x + out
        x = x + _mlp(lp, cfg, _norm(x, lp["mlp_norm"], cfg.norm_eps))
    return x, {"layers": new_states, "length": start + length}


def _logits(params, cfg: Qwen3NextConfig, x: torch.Tensor) -> torch.Tensor:
    x = _norm(x, params["out_norm"], cfg.norm_eps)
    return _linear(x, params["lm_head"]).float()


@torch.no_grad()
def forward(params, cfg: Qwen3NextConfig, tokens, cache, length=None):
    """tokens (S,); ``length`` (an int or a 0-dim tensor) marks how many
    are real, the rest inert (see the module docstring); None = all.
    Returns (all logits (S, V) f32, the new cache); rows at or after
    ``length`` are junk."""
    x, cache = _hidden(params, cfg, tokens, cache, length)
    return _logits(params, cfg, x), cache


@torch.no_grad()
def prefill(params, cfg: Qwen3NextConfig, tokens, length, cache):
    """Padded-chunk ingestion from ``cache`` (the Mamba session contract):
    (the last real token's logits, the cache). Only that row reaches the
    head."""
    x, cache = _hidden(params, cfg, tokens, cache, length)
    last = torch.as_tensor(length, device=x.device).reshape(1).long() - 1
    return _logits(params, cfg, x.index_select(0, last))[0], cache


extend = prefill  # recurrent state: continuation IS another prefill


@torch.no_grad()
def decode_step(params, cfg: Qwen3NextConfig, token, cache):
    """One token (an int or a 0-dim device tensor): (logits (V,), cache)."""
    x, cache = _hidden(params, cfg, torch.as_tensor(token).reshape(1), cache)
    return _logits(params, cfg, x)[0], cache


class Cache:
    """The Mamba session's cache contract: ``Cache.create(cfg)``."""

    @staticmethod
    def create(cfg: Qwen3NextConfig, dtype: torch.dtype = torch.float32,
               max_seq: Optional[int] = None,
               device: Optional[torch.device] = None) -> Dict[str, Any]:
        del max_seq
        return create_cache(cfg, dtype, device)


def greedy_generate(params, cfg: Qwen3NextConfig, prompt,
                    n_tokens: int) -> List[int]:
    """Host greedy loop (tests, the smoke); the session API is
    ``models.mamba.MambaRunner``, which picks this module by config type."""
    dev = params["tok_emb"].device
    cache = create_cache(cfg, device=dev)
    ids = torch.as_tensor(np.asarray(prompt, np.int64), device=dev)
    logits, cache = prefill(params, cfg, ids, len(ids), cache)
    out = []
    tok = torch.argmax(logits)
    for _ in range(n_tokens):
        out.append(int(tok))
        logits, cache = decode_step(params, cfg, tok, cache)
        tok = torch.argmax(logits)
    return out


_QUANTIZED = ("wq", "wk", "wv", "wz", "wo", "w_gu", "w_down", "shared_gu",
              "shared_down")


def quantize_params(params: Dict[str, Any], bits: int = 4,
                    group: int = 256) -> Dict[str, Any]:
    """Quantize the big per-layer matrices of the hybrid tree (the
    attention and DeltaNet projections, the MLP and expert banks, the
    shared expert) and lm_head, where their smaller side is at least
    ``group``; norms, the convolution, dt/A, the b/a projections, the
    router and the shared gate keep their dtype. An (E, K, N) bank becomes
    a per-expert stack, one expert at a time."""
    quantize = quantize_q4 if bits == 4 else quantize_q8
    layers = []
    for lp in params["layers"]:
        nlp = dict(lp)
        for name in _QUANTIZED:
            arr = nlp.get(name)
            if not isinstance(arr, torch.Tensor):
                continue
            if arr.ndim == 2 and min(arr.shape) >= group:
                nlp[name] = quantize(arr.float(), group)
            elif arr.ndim == 3 and min(arr.shape[1:]) >= group:
                it = iter(range(arr.shape[0]))
                nlp[name] = quantized_stack(
                    (arr.shape[0],),
                    lambda: quantize(arr[next(it)].float(), group))
        layers.append(nlp)
    return {**params, "layers": layers,
            "lm_head": quantize(params["lm_head"].float(), group)}


def init_params_quantized(generator: torch.Generator, cfg: Qwen3NextConfig,
                          bits: int = 4, group: int = 256,
                          dtype: torch.dtype = torch.float32,
                          device: Optional[torch.device] = None
                          ) -> Dict[str, Any]:
    """Random params straight into :func:`quantize_params`' layout, one
    (K, N) matrix (one expert's) at a time on ``device`` (``generator``
    lives there): a full-width model never holds a float bank. Matrices
    draw N(0, 1/K); norms N(0, 0.05) about the zero-centered 0; ``a_log``
    and ``dt_bias`` in the HF init's ranges (A uniform in (1, 16), dt
    log-uniform in (1e-3, 0.1) through the inverse softplus)."""
    device = default_device(device, "build Qwen3-Next params")
    quantize = quantize_q4 if bits == 4 else quantize_q8
    d = cfg.dim

    def normal(*shape, s=1.0):
        return torch.randn(shape, generator=generator, device=device) * s

    def uniform(*shape):
        return torch.rand(shape, generator=generator, device=device)

    def mat(kk, nn):
        w = normal(kk, nn, s=1.0 / math.sqrt(kk))
        return quantize(w, group) if min(kk, nn) >= group else w.to(dtype)

    def bank(kk, nn):
        if min(kk, nn) < group:
            return normal(cfg.n_experts, kk, nn,
                          s=1.0 / math.sqrt(kk)).to(dtype)
        return quantized_stack((cfg.n_experts,), lambda: mat(kk, nn))

    def norm(n):
        return normal(n, s=0.05).to(dtype)

    hk, hv, dk, dv = cfg.lin_k_heads, cfg.lin_v_heads, cfg.lin_dk, cfg.lin_dv
    layers = []
    for lt in cfg.layer_types:
        lp: Dict[str, Any] = {"attn_norm": norm(d), "mlp_norm": norm(d)}
        if lt == "f":
            h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
            lp.update(wq=mat(d, h * 2 * hd), wk=mat(d, kv * hd),
                      wv=mat(d, kv * hd), wo=mat(h * hd, d),
                      q_norm=norm(hd), k_norm=norm(hd))
        else:
            dt = torch.exp(uniform(hv) * (math.log(0.1) - math.log(1e-3))
                           + math.log(1e-3))
            lp.update(wq=mat(d, hk * dk), wk=mat(d, hk * dk),
                      wv=mat(d, hv * dv), wz=mat(d, hv * dv),
                      wb=normal(d, hv, s=1.0 / math.sqrt(d)).to(dtype),
                      wa=normal(d, hv, s=1.0 / math.sqrt(d)).to(dtype),
                      conv_w=normal(cfg.conv_dim, cfg.conv_k,
                                    s=1.0 / math.sqrt(cfg.conv_k)).to(dtype),
                      dt_bias=(dt + torch.log(-torch.expm1(-dt))).to(dtype),
                      a_log=torch.log(1.0 + 15.0 * uniform(hv)).to(dtype),
                      o_norm=(1.0 + normal(dv, s=0.05)).to(dtype),
                      wo=mat(hv * dv, d))
        if cfg.n_experts:
            lp.update(moe_gate=normal(d, cfg.n_experts,
                                      s=1.0 / math.sqrt(d)).to(dtype),
                      w_gu=bank(d, 2 * cfg.moe_hidden),
                      w_down=bank(cfg.moe_hidden, d),
                      shared_gu=mat(d, 2 * cfg.shared_hidden),
                      shared_down=mat(cfg.shared_hidden, d),
                      shared_gate=normal(d, 1, s=1.0 / math.sqrt(d)).to(dtype))
        else:
            lp.update(w_gu=mat(d, 2 * cfg.hidden_dim),
                      w_down=mat(cfg.hidden_dim, d))
        layers.append(lp)
    return {"tok_emb": normal(cfg.vocab_size, d, s=0.02).to(dtype),
            "layers": layers, "out_norm": norm(d),
            "lm_head": quantize(normal(d, cfg.vocab_size,
                                       s=1.0 / math.sqrt(d)), group)}
