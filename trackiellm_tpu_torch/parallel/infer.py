"""Tensor-parallel inference: shard specs, the weight cutter, sharded
prefill and decode.

Port of ``trackiellm_tpu/parallel/infer.py``. The JAX package names a
``PartitionSpec`` per leaf and lets GSPMD partition the unchanged forward;
here each rank holds its own local tree, cut by :func:`shard_params`, and
the unchanged forward of ``models/llm.py`` or ``models/mla.py`` runs on a
local config (:func:`local_config`: 1/tp of the heads and MLP columns)
with the collectives carried by the tree itself (Megatron's layout):

- column-parallel ``wqkv`` (each rank its q heads, its k heads and its v
  heads, not a contiguous cut of the fused ``[q | k | v]`` columns),
  ``w_gu`` (its slice of the gate half and of the up half), the MoE banks
  within each expert, the shared expert, and MLA's ``wq``/``wq_b`` and
  ``wkv_b`` by whole heads: plain leaves, no collective;
- row-parallel ``wo``, ``w_down`` and ``shared_down``: a
  ``models.llm.TPLinear`` that all-reduces the f32 partial sums before the
  cast to the activations' dtype; biases are added once, after it;
- the vocabulary: the embedding's rows (``models.llm.VocabShard``: each
  rank's lookup with -0.0 elsewhere, summed) and ``lm_head``'s columns
  (its logits all-gathered, so sampling sees every logit on every rank).

The KV heads of every cache and page pool are the rank's own (the local
config's ``n_kv_heads``); MLA's latent cache and ``wkv_a``/``wq_a`` stay
whole on every rank, as there. The cache and pool specs
(``kv_cache_sharding`` ... ``batched_mla_sharding``) state that layout
beside the JAX package's names; nothing reads them at run time, since the
local config sizes every cache.

**Q4 row shards are repacked.** Q4 packs row r with row K/2 + r in one
byte, so a K slice of the packed bytes is not a K slice of the matrix: the
cutter unpacks the nibbles, slices K and packs again, values and scales
unchanged. A slice must hold whole quantization groups (W4A8 quantizes the
activations by (row, group), so only then is a shard's product exact) and
the kernels want K/2 divisible by the group: where the slice holds whole
groups but misses that, it is padded with whole zero groups (zero weights
against zero activation columns add nothing); where a group would straddle
two ranks, the matrix stays whole on every rank and its input is
all-gathered first (the single device's product). :func:`shard_params`
reports both.
"""

from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional

import torch

from trackiellm_tpu_torch.llm.paging import QuantPool
from trackiellm_tpu_torch.models import llm as llm_model
from trackiellm_tpu_torch.models.llm import TPLinear, VocabShard
from trackiellm_tpu_torch.ops.quant import QuantizedLinear
from trackiellm_tpu_torch.utils.errors import ErrorCode, TrackieError


class Split(NamedTuple):
    """How one leaf is cut: along ``dim`` over mesh axis ``axis`` (None:
    whole on every rank), with ``layout`` "even" (contiguous equal parts),
    "qkv" (the fused ``[q | k | v]`` columns, each part by heads) or "gu"
    (the gate and up halves of a gated MLP, each half evenly; an ungated
    MLP's columns evenly)."""

    dim: Optional[int] = None
    axis: Optional[str] = None
    layout: str = "even"


REPLICATED = Split()


def _q(spec: Split, quantized: bool):
    """A QuantizedLinear's values and scales share one spec."""
    return QuantizedLinear(values=spec, scales=spec) if quantized else spec


# Leaves of the llm tree that stay whole on every rank: vectors read by
# every head (norms, QK norms), biases added once after a reduce, the
# router and the shared expert's gate.
_LLM_WHOLE = ("attn_norm", "mlp_norm", "attn_post_norm", "mlp_post_norm",
              "q_norm", "k_norm", "wo_bias", "w_down_b", "moe_gate",
              "moe_gate_b", "shared_gate")


def infer_param_shardings(quantized: bool,
                          params: Dict[str, Any] = None) -> Dict[str, Any]:
    """Spec tree of a ``models.llm`` inference tree (bf16 or quantized),
    leaf for leaf as the JAX package's: ``tok_emb`` by vocabulary rows,
    ``wqkv``/``w_gu`` by columns, ``wo``/``w_down`` by rows, ``lm_head``
    by vocabulary columns, MoE banks (L, E, K, N) within each expert.
    With ``params`` every leaf the tree holds gets its spec; there
    ``wqkv_bias`` follows wqkv's columns and ``attn_sink`` its heads, which
    the JAX package keeps whole (GSPMD cuts them as the product needs)."""
    tree = {
        "tok_emb": Split(0, "tp"),
        "layers": {
            "attn_norm": REPLICATED,
            "wqkv": _q(Split(2, "tp", "qkv"), quantized),
            "wo": _q(Split(1, "tp"), quantized),
            "mlp_norm": REPLICATED,
            "w_gu": _q(Split(2, "tp", "gu"), quantized),
            "w_down": _q(Split(1, "tp"), quantized),
        },
        "out_norm": REPLICATED,
        "lm_head": _q(Split(1, "tp"), quantized),
    }
    if params is None:
        return tree
    layers = params["layers"]
    out = tree["layers"]
    for key in layers:
        if key in _LLM_WHOLE:
            out[key] = REPLICATED
    if "wqkv_bias" in layers:
        out["wqkv_bias"] = Split(1, "tp", "qkv")
    if "attn_sink" in layers:
        out["attn_sink"] = Split(1, "tp")
    if "moe_gate" in layers:
        out["w_gu"] = _q(Split(3, "tp", "gu"), quantized)
        out["w_down"] = _q(Split(2, "tp"), quantized)
        if "w_gu_b" in layers:
            out["w_gu_b"] = Split(2, "tp", "gu")
    elif "w_gu_b" in layers:
        out["w_gu_b"] = Split(1, "tp", "gu")
    if "shared_gu" in layers:
        out["shared_gu"] = _q(Split(2, "tp", "gu"), quantized)
        out["shared_down"] = _q(Split(1, "tp"), quantized)
    if "w_gu_mlp" in layers:
        out["w_gu_mlp"] = Split(2, "tp", "gu")
        out["w_down_mlp"] = Split(1, "tp")
    for key in ("rope_factors", "rope_factors_short", "rope_factors_long"):
        if key in params:
            tree[key] = REPLICATED
    return tree


def kv_cache_sharding() -> llm_model.KVCache:
    """KV cache (L, S, Hk, D): KV heads over tp; the length is host state."""
    kv = Split(2, "tp")
    return llm_model.KVCache(k=kv, v=kv, length=REPLICATED)


def batched_kv_sharding() -> llm_model.BatchedKVCache:
    """Server slots (L, B, S, Hk, D): KV heads over tp, every slot on every
    rank."""
    kv = Split(3, "tp")
    return llm_model.BatchedKVCache(k=kv, v=kv, lengths=REPLICATED)


def paged_pool_sharding() -> Split:
    """A float page pool (L, n_pages, page_size, Hk, D): KV heads over tp,
    pages whole, so page gathers and scatters stay on the rank (each rank
    holds its heads of every page; the page table is host state)."""
    return Split(3, "tp")


def quant_pool_sharding() -> QuantPool:
    """An int8 pool: values (L, n_pages, page, Hk, D) and their
    per-(cell, head) scales (L, n_pages, page, Hk) on the same head axis."""
    return QuantPool(vals=Split(3, "tp"), scale=Split(3, "tp"))


def mla_param_shardings(params: Dict[str, Any]) -> Dict[str, Any]:
    """Spec tree of a ``models.mla`` tree: ``wq``/``wq_b`` and ``wkv_b``
    by whole heads (both stack head-major), ``wo`` by rows, the latent
    projections and cache whole (every rank's heads score the same latent),
    MoE banks within each expert, the dense MLP as in
    :func:`infer_param_shardings`."""
    attn = {"attn_norm": REPLICATED, "mlp_norm": REPLICATED,
            "kv_a_norm": REPLICATED, "wkv_a": REPLICATED,
            "wkv_b": Split(2, "tp"), "wo": Split(1, "tp")}
    if "wq" in params["attn"]:
        attn["wq"] = Split(2, "tp")
    else:
        attn["wq_a"] = REPLICATED
        attn["q_a_norm"] = REPLICATED
        attn["wq_b"] = Split(2, "tp")
    dense = {} if not params["dense_mlp"] else {
        "w_gu": Split(2, "tp", "gu"), "w_down": Split(1, "tp")}
    moe = {} if not params["moe_mlp"] else {
        "moe_gate": REPLICATED, "w_gu": Split(3, "tp", "gu"),
        "w_down": Split(2, "tp")}
    if "moe_gate_bias" in params["moe_mlp"]:
        moe["moe_gate_bias"] = REPLICATED
    if "shared_gu" in params["moe_mlp"]:
        moe["shared_gu"] = Split(2, "tp", "gu")
        moe["shared_down"] = Split(1, "tp")
    tree = {"tok_emb": Split(0, "tp"), "attn": attn, "dense_mlp": dense,
            "moe_mlp": moe, "out_norm": REPLICATED,
            "lm_head": Split(1, "tp")}
    if "rope_factors" in params:
        tree["rope_factors"] = REPLICATED
    return tree


def mla_cache_sharding():
    """The MLA latent cache: whole on every rank."""
    from trackiellm_tpu_torch.models import mla as mla_model

    return mla_model.MLACache(ckv=REPLICATED, kpe=REPLICATED,
                              length=REPLICATED)


def batched_mla_sharding():
    """The server's latent slots: whole on every rank."""
    from trackiellm_tpu_torch.models import mla as mla_model

    return mla_model.BatchedMLACache(ckv=REPLICATED, kpe=REPLICATED,
                                     lengths=REPLICATED)


# ---------------------------------------------------------------------------
# The cutter
# ---------------------------------------------------------------------------

class Shard(NamedTuple):
    """One rank's cut: its local tree, the local config its forward runs
    on, and the report of the row-parallel matrices that were padded or
    kept whole (name -> dict)."""

    params: Dict[str, Any]
    cfg: Any
    report: Dict[str, dict]


def _is_mla(cfg) -> bool:
    return type(cfg).__name__ == "MLAConfig"


def _refuse(msg: str) -> None:
    raise TrackieError(ErrorCode.INVALID_ARGUMENT, msg)


def local_config(cfg, tp: int):
    """The config a tp rank's forward runs on: 1/tp of the heads (query and
    KV) and of every MLP width; the vocabulary, head_dim and every scalar
    stay the model's. Refuses (TrackieError) a degree the model does not
    divide by, the JAX package's stated precondition."""
    widths = {"n_heads": cfg.n_heads, "hidden_dim": cfg.hidden_dim,
              "vocab_size": cfg.vocab_size}
    if _is_mla(cfg):
        if cfg.n_experts:
            widths["moe_hidden_dim"] = cfg.moe_hidden_dim
    else:
        widths["n_kv_heads"] = cfg.n_kv_heads
        if getattr(cfg, "qk_norm_full", False) and tp > 1:
            _refuse("qk_norm_full (OLMo-2) normalizes the whole projection "
                    "across heads: not supported under tensor parallelism")
    if cfg.moe_shared_hidden:
        widths["moe_shared_hidden"] = cfg.moe_shared_hidden
    for name, value in widths.items():
        if value % tp:
            _refuse(f"{name}={value} does not divide by tp={tp}")
    return cfg._replace(**{k: v // tp for k, v in widths.items()
                           if k != "vocab_size"})


def _cut(t: torch.Tensor, dim: int, tp: int, r: int, layout: str,
         parts=None) -> torch.Tensor:
    """Rank r's part of ``t`` along ``dim``: contiguous, or each of the
    contiguous ``parts`` (sizes along dim) cut evenly and joined."""
    if layout == "even" or parts is None:
        n = t.shape[dim] // tp
        return t.narrow(dim, r * n, n).contiguous()
    out, off = [], 0
    for size in parts:
        n = size // tp
        out.append(t.narrow(dim, off + r * n, n))
        off += size
    return torch.cat(out, dim=dim).contiguous()


def _unpack_q4(values: torch.Tensor) -> torch.Tensor:
    """Packed Q4 (..., K/2, N) -> the signed int8 values (..., K, N)."""
    p = values.to(torch.int16)
    lo = (p & 0xF) - 8
    hi = (((p >> 4) & 0xF) ^ 8) - 8
    return torch.cat([lo, hi], dim=-2).to(torch.int8)


def _pack_q4(q: torch.Tensor) -> torch.Tensor:
    """Signed int8 values (..., K, N) -> packed Q4 (..., K/2, N), the
    encoding of ``ops/quant.py:quantize_q4``."""
    k = q.shape[-2]
    q = q.to(torch.int16)
    lo = (q[..., : k // 2, :] + 8).to(torch.uint8)
    hi = (q[..., k // 2:, :] & 0xF).to(torch.uint8)
    return lo | (hi << 4)


def _row_cut(w, dim: int, tp: int, r: int):
    """Rank r's K slice of a row-parallel leaf: (leaf, pad, kind, note).
    kind is "row", or "whole" where the slice would split a quantization
    group; pad is the zero K rows appended (Q4's packing multiple)."""
    if not isinstance(w, QuantizedLinear):
        return _cut(w, dim, tp, r, "even"), 0, "row", None
    q4 = w.values.dtype == torch.uint8
    k = w.values.shape[-2] * (2 if q4 else 1)
    g = k // w.scales.shape[-2]
    kl = k // tp
    note = {"k": k, "k_local": kl, "group": g}
    if kl % g:
        return w, 0, "whole", {**note, "kind": "whole"}
    scales = _cut(w.scales, w.scales.dim() - 2, tp, r, "even")
    if not q4:
        return (QuantizedLinear(_cut(w.values, w.values.dim() - 2, tp, r,
                                     "even"), scales), 0, "row", None)
    vals = _unpack_q4(w.values)
    vals = vals.narrow(-2, r * kl, kl)
    kp = -(-kl // (2 * g)) * (2 * g)   # K/2 a multiple of the group
    pad = kp - kl
    if pad:
        vals = torch.cat([vals, vals.new_zeros(
            (*vals.shape[:-2], pad, vals.shape[-1]))], dim=-2)
        scales = torch.cat([scales, scales.new_zeros(
            (*scales.shape[:-2], pad // g, scales.shape[-1]))], dim=-2)
    leaf = QuantizedLinear(_pack_q4(vals).contiguous(), scales.contiguous())
    return leaf, pad, "row", ({**note, "kind": "padded", "k_padded": kp}
                              if pad else None)


def _parts(cfg, name: str, size: int, layout: str):
    """The contiguous parts a layout cuts evenly: the q, k and v columns;
    the gate and up halves of a gated MLP (expert banks and the shared
    expert always are)."""
    if layout == "qkv":
        hd = cfg.head_dim
        return (cfg.n_heads * hd, cfg.n_kv_heads * hd, cfg.n_kv_heads * hd)
    gated = (cfg.mlp_gated or name == "shared_gu"
             or (cfg.n_experts and name in ("w_gu", "w_gu_b")))
    if layout == "gu" and gated:
        return (size // 2, size // 2)
    return None


def _cut_leaf(name: str, w, spec, cfg, tp: int, r: int, comm,
              report: dict, path: str):
    """Rank r's leaf ``w`` under ``spec`` (a Split, or a QuantizedLinear of
    Splits), wrapped where it needs a collective."""
    if isinstance(spec, QuantizedLinear):
        spec = spec.values
    if spec.axis is None or tp == 1:
        return w
    lead = w.values.dim() if isinstance(w, QuantizedLinear) else w.dim()
    if spec.dim == lead - 1:     # columns
        if isinstance(w, QuantizedLinear):
            parts = _parts(cfg, name, w.values.shape[-1], spec.layout)
            leaf = QuantizedLinear(
                _cut(w.values, lead - 1, tp, r, spec.layout, parts),
                _cut(w.scales, lead - 1, tp, r, spec.layout, parts))
        else:
            parts = _parts(cfg, name, w.shape[-1], spec.layout)
            leaf = _cut(w, lead - 1, tp, r, spec.layout, parts)
        if name == "lm_head":
            return TPLinear(leaf, comm, "vocab")
        return leaf
    if spec.dim == lead - 2 and name != "tok_emb":   # rows: a reduce
        leaf, pad, kind, note = _row_cut(w, lead - 2, tp, r)
        if note is not None:
            report[path] = note
        return TPLinear(leaf, comm, kind, pad)
    parts = _parts(cfg, name, w.shape[spec.dim], spec.layout)
    return _cut(w, spec.dim, tp, r, spec.layout, parts)


def _cut_tree(tree: Dict[str, Any], specs: Dict[str, Any], cfg, tp: int,
              r: int, comm, report: dict, prefix: str) -> Dict[str, Any]:
    out = {}
    for name, w in tree.items():
        if hasattr(w, "base") and hasattr(w, "a"):
            _refuse(f"{prefix}{name}: LoRA adapters are not cut for tensor "
                    "parallelism (merge them first)")
        if name not in specs:
            _refuse(f"{prefix}{name}: no tensor-parallel spec for this leaf")
        spec = specs[name]
        if isinstance(w, dict) and isinstance(spec, dict):
            out[name] = _cut_tree(w, spec, cfg, tp, r, comm, report,
                                  f"{prefix}{name}.")
        elif isinstance(w, dict):   # a LayerNorm's {"g", "b"}: whole
            out[name] = w
        else:
            out[name] = _cut_leaf(name, w, spec, cfg, tp, r, comm, report,
                                  prefix + name)
    return out


def shard_params(params: Dict[str, Any], cfg, mesh) -> Shard:
    """Cut this rank's local tree from the full tree (``models.llm`` or
    ``models.mla``) for ``mesh``'s tp axis (its ``tp`` and ``tp_rank``):
    the weight carrier of tensor-parallel inference. Refuses
    (TrackieError) a tp that the heads, the vocabulary or an MLP width do
    not divide by. The local tree's leaves are fresh tensors where they are
    cut and the full tree's own where they are whole."""
    tp, r = mesh.tp, mesh.tp_rank
    lcfg = local_config(cfg, tp)
    if _is_mla(cfg):
        specs = mla_param_shardings(params)
    else:
        quantized = isinstance(params["layers"]["wqkv"], QuantizedLinear)
        specs = infer_param_shardings(quantized, params)
    report: Dict[str, dict] = {}
    if tp == 1:
        return Shard(dict(params), lcfg, report)
    tree = {k: v for k, v in params.items() if k != "tok_emb"}
    local = _cut_tree(tree, specs, cfg, tp, r, mesh, report, "")
    rows = cfg.vocab_size // tp
    local["tok_emb"] = params["tok_emb"].narrow(0, r * rows, rows).contiguous()
    local["vocab_shard"] = VocabShard(r * rows, mesh)
    return Shard(local, lcfg, report)


def shard_shapes(params: Dict[str, Any]) -> Dict[str, List[int]]:
    """Each matrix leaf's local shape (a quantized one's values), by dotted
    name: what the smoke prints per rank."""
    out: Dict[str, List[int]] = {}

    def walk(tree, prefix):
        for name, w in tree.items():
            if isinstance(w, TPLinear):
                w = w.w
            if isinstance(w, dict):
                walk(w, f"{prefix}{name}.")
            elif isinstance(w, QuantizedLinear):
                out[prefix + name] = list(w.values.shape)
            elif isinstance(w, torch.Tensor) and w.dim() >= 2:
                out[prefix + name] = list(w.shape)
    walk(params, "")
    return out


# ---------------------------------------------------------------------------
# Sharded forwards
# ---------------------------------------------------------------------------

def make_sharded_prefill(cfg, mesh):
    """``prefill(local_params, tokens, length, cache)`` of ``models.llm``
    on the rank's local tree (:func:`shard_params`) and a cache of its KV
    heads; returns the full (V,) logits on every rank and the cache."""
    lcfg = local_config(cfg, mesh.tp)

    def prefill(params, tokens, length, cache):
        return llm_model.prefill(params, lcfg, tokens, length, cache)
    return prefill


def make_sharded_decode(cfg, mesh, attn_len: Optional[int] = None):
    """``decode(local_params, token, cache)``: one ``models.llm`` decode step
    on the rank's shards, the full logits on every rank."""
    lcfg = local_config(cfg, mesh.tp)

    def decode(params, token, cache):
        return llm_model.decode_step(params, lcfg, token, cache,
                                     attn_len=attn_len)
    return decode


def make_sharded_mla(cfg, mesh, attn_len: Optional[int] = None):
    """(prefill, decode) of ``models.mla`` on a rank's local tree, over a
    latent cache that every rank holds whole."""
    from trackiellm_tpu_torch.models import mla as mla_model

    lcfg = local_config(cfg, mesh.tp)

    def prefill(params, tokens, length, cache):
        return mla_model.prefill(params, lcfg, tokens, length, cache)

    def decode(params, token, cache):
        return mla_model.decode_step(params, lcfg, token, cache,
                                     attn_len=attn_len)
    return prefill, decode
