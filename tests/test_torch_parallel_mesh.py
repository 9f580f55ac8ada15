"""The port's mesh factoring and shard specs against the JAX package's, and
the weight cutter's exactness (no processes: the cutter needs only a tp
degree and a rank).

- ``_factor`` and ``build_mesh``'s axis sizes equal the JAX package's for n
  in 1..64 devices, ``max_tp`` in {1, 2, 4, 8} and ``ep=2``.
- The spec trees (``infer_param_shardings``, ``mla_param_shardings``) split
  the same dimension over the same axis as the JAX package's, leaf for
  leaf, for the dense, Qwen2-bias, Gemma-2 post-norm, MoE, shared-expert,
  MLA (``wq``) and MLA (``q_lora``) trees. Where the JAX package keeps a
  leaf whole and GSPMD cuts it as the product needs (``wqkv_bias``), the
  port cuts it with its projection's columns.
- ``shard_params``: the four ranks' shards, unpacked, reassemble the full
  tree bit for bit: column cuts by heads (``[q | k | v]``) and by the gate
  and up halves, Q4 row shards repacked, padded with whole zero groups, or
  kept whole where a group would straddle two ranks.
"""

import types

import numpy as np
import pytest
import torch

from trackiellm_tpu_torch.models import llm as tllm
from trackiellm_tpu_torch.models.bridge import params_from_jax
from trackiellm_tpu_torch.ops.quant import QuantizedLinear
from trackiellm_tpu_torch.parallel import infer
from trackiellm_tpu_torch.parallel.mesh import _factor, build_mesh, mesh_shape
from trackiellm_tpu_torch.utils.errors import TrackieError

TP = 4
# Leaves the JAX package keeps whole (GSPMD partitions the product around
# them) that the port cuts with their projection.
FOLLOWS_ITS_PROJECTION = {"layers.wqkv_bias"}


class _FakeMesh:
    """Stands in for jax.sharding.Mesh in the JAX build_mesh: records the
    grid's shape and axis names."""

    def __init__(self, devices, names):
        self.shape = dict(zip(names, np.asarray(devices).shape))


@pytest.mark.parametrize("max_tp", [1, 2, 4, 8])
def test_factor_and_axis_sizes_equal_jax(monkeypatch, max_tp):
    from trackiellm_tpu.parallel import mesh as jmesh
    monkeypatch.setattr(jmesh, "Mesh", _FakeMesh)
    for n in range(1, 65):
        assert _factor(n, max_tp) == jmesh._factor(n, max_tp)
        got = mesh_shape(n, max_tp=max_tp)
        assert got == jmesh.build_mesh(list(range(n)), max_tp=max_tp).shape
        if n % 2 == 0:
            got = mesh_shape(n, max_tp=max_tp, ep=2)
            want = jmesh.build_mesh(list(range(n)), max_tp=max_tp, ep=2)
            assert got == want.shape and list(got) == list(want.shape)


def test_a_world_of_one_needs_no_process_group():
    """build_mesh(1) is a (1, 1, 1) mesh whose verbs are the identity; the
    backend is the caller's choice, never a default."""
    mesh = build_mesh(1, backend="gloo", device="cpu")
    assert mesh.shape == {"dp": 1, "fsdp": 1, "tp": 1}
    assert mesh.coords == {"dp": 0, "fsdp": 0, "tp": 0}
    t = torch.arange(6.0).reshape(2, 3)
    assert mesh.all_reduce(t) is t and mesh.all_gather(t) is t
    assert mesh.broadcast_object({"a": 1}) == {"a": 1}
    assert "tp=1" in repr(mesh) and "gloo" in repr(mesh)
    with pytest.raises(TrackieError, match="backend"):
        build_mesh(1, device="cpu")
    with pytest.raises(TrackieError, match="nccl"):
        build_mesh(1, backend="nccl", device="cpu")


def _jax_cfgs(jllm):
    base = jllm.LLMConfig(
        vocab_size=512, dim=256, n_layers=2, n_heads=8, n_kv_heads=4,
        head_dim=32, hidden_dim=512, max_seq=128, sliding_window=128)
    return {"dense": base,
            "qwen2_bias": base._replace(qkv_bias=True),
            "gemma2_post_norm": base._replace(post_norms=True, act="gelu",
                                              logit_softcap=30.0),
            "moe": base._replace(n_experts=4, n_experts_used=2),
            "shared_expert": base._replace(n_experts=4, n_experts_used=2,
                                           moe_shared_hidden=256)}


def _flat(tree, prefix=""):
    """{dotted path: leaf}; a QuantizedLinear's fields get .values/.scales."""
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}."))
    elif hasattr(tree, "values") and hasattr(tree, "scales") and \
            not callable(tree.values):
        out[prefix + "values"] = tree.values
        out[prefix + "scales"] = tree.scales
    else:
        out[prefix[:-1]] = tree
    return out


def _jax_split(ns):
    """(dim, axis) of a NamedSharding's spec: the first split dimension."""
    for dim, axis in enumerate(ns.spec):
        if axis is not None:
            return dim, axis
    return None, None


def _compare_specs(jax_tree, port_tree):
    jflat, pflat = _flat(jax_tree), _flat(port_tree)
    for path, ns in jflat.items():
        key = path.rsplit(".", 1)[0] if path.endswith(
            (".values", ".scales")) else path
        assert path in pflat, path
        got = (pflat[path].dim, pflat[path].axis)
        if key in FOLLOWS_ITS_PROJECTION:
            assert _jax_split(ns) == (None, None) and got[1] == "tp"
            continue
        assert got == _jax_split(ns), path


@pytest.mark.parametrize("name", ["dense", "qwen2_bias", "gemma2_post_norm",
                                  "moe", "shared_expert"])
@pytest.mark.parametrize("quantized", [False, True])
def test_llm_specs_match_jax_leaf_for_leaf(name, quantized):
    import jax
    import jax.numpy as jnp
    from trackiellm_tpu.models import llm as jllm
    from trackiellm_tpu.parallel import build_mesh as jbuild
    from trackiellm_tpu.parallel import infer_param_shardings

    cfg = _jax_cfgs(jllm)[name]
    p = jllm.init_params(jax.random.PRNGKey(0), cfg, dtype=jnp.float32)
    if quantized:
        p = jllm.quantize_params(p, bits=4, group=64)
    mesh = jbuild(jax.devices()[:TP])
    want = infer_param_shardings(mesh, quantized, p)
    got = infer.infer_param_shardings(quantized,
                                      params_from_jax(p, "cpu"))
    _compare_specs(want, got)
    # Every leaf of the tree has a spec (shard_params can cut it).
    assert set(_flat(got)) >= set(
        k for k in _flat(params_from_jax(p, "cpu")))


@pytest.mark.parametrize("q_lora", [0, 24])
def test_mla_specs_match_jax_leaf_for_leaf(q_lora):
    import jax
    import jax.numpy as jnp
    from trackiellm_tpu.models import mla as jmla
    from trackiellm_tpu.parallel import build_mesh as jbuild
    from trackiellm_tpu.parallel import mla_param_shardings

    cfg = jmla.MLAConfig.tiny()._replace(n_heads=4, q_lora_rank=q_lora,
                                         max_seq=64)
    p = jmla.init_params(jax.random.PRNGKey(11), cfg, dtype=jnp.float32)
    want = mla_param_shardings(jbuild(jax.devices()[:TP]), p)
    got = infer.mla_param_shardings(params_from_jax(p, "cpu"))
    assert ("wq_b" in got["attn"]) == bool(q_lora)
    _compare_specs(want, got)


def test_cache_and_pool_specs_split_the_kv_heads():
    assert infer.kv_cache_sharding().k == infer.Split(2, "tp")
    assert infer.batched_kv_sharding().v == infer.Split(3, "tp")
    assert infer.paged_pool_sharding() == infer.Split(3, "tp")
    q = infer.quant_pool_sharding()
    assert q.vals == q.scale == infer.Split(3, "tp")
    assert infer.mla_cache_sharding().ckv == infer.REPLICATED
    assert infer.batched_mla_sharding().kpe == infer.REPLICATED


# -- the cutter ------------------------------------------------------------

def _unpack(values):
    """Packed Q4 -> signed values, the test's own decoding of
    ops/quant.py's layout (low nibble biased by 8, high nibble two's
    complement)."""
    p = values.to(torch.int16)
    lo = (p & 15) - 8
    hi = (p >> 4) & 15
    hi = torch.where(hi >= 8, hi - 16, hi)
    return torch.cat([lo, hi], dim=-2)


def _uncut_columns(parts, sizes):
    """Join the ranks' column cuts of a leaf laid out in ``sizes``."""
    out, per = [], [s // TP for s in sizes]
    for i, _ in enumerate(sizes):
        start = sum(per[:i])
        out += [p[..., start:start + per[i]] for p in parts]
    return torch.cat(out, dim=-1)


def _reassemble(full, locs, spec, cfg, name):
    """The full leaf from the four ranks' leaves, checked bit for bit."""
    if isinstance(spec, QuantizedLinear):
        spec = spec.values
    if isinstance(locs[0], tllm.TPLinear):
        kind = locs[0].kind
        ws = [w.w for w in locs]
        if kind == "whole":
            for w in ws:
                assert w is full
            return "whole"
        if kind == "vocab":
            return _check_cols(full, ws, spec, cfg, name)
        return _check_rows(full, ws, locs[0].pad)
    if spec.axis is None:
        for w in locs:
            assert w is full
        return "whole-leaf"
    return _check_cols(full, locs, spec, cfg, name)


def _sizes(full_n, spec, cfg, name):
    if spec.layout == "qkv":
        return (cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim,
                cfg.n_kv_heads * cfg.head_dim)
    if spec.layout == "gu" and (cfg.mlp_gated or cfg.n_experts
                                or name == "shared_gu"):
        return (full_n // 2, full_n // 2)
    return (full_n,)


def _check_cols(full, locs, spec, cfg, name):
    if isinstance(full, QuantizedLinear):
        sizes = _sizes(full.values.shape[-1], spec, cfg, name)
        assert torch.equal(_uncut_columns([w.values for w in locs], sizes),
                           full.values)
        assert torch.equal(_uncut_columns([w.scales for w in locs], sizes),
                           full.scales)
    else:
        sizes = _sizes(full.shape[-1], spec, cfg, name)
        assert torch.equal(_uncut_columns(locs, sizes), full)
    return "columns"


def _check_rows(full, ws, pad):
    if not isinstance(full, QuantizedLinear):
        assert pad == 0
        assert torch.equal(torch.cat(ws, dim=-2), full)
        return "rows"
    q4 = full.values.dtype == torch.uint8
    k = full.values.shape[-2] * (2 if q4 else 1)
    g = k // full.scales.shape[-2]
    kl = k // TP
    vals = [(_unpack(w.values) if q4 else w.values) for w in ws]
    for v in vals:
        assert v.shape[-2] == kl + pad
        if pad:
            assert not v[..., kl:, :].any()   # whole zero groups
    for w in ws:
        if pad:
            assert not w.scales[..., kl // g:, :].any()
    whole = torch.cat([v[..., :kl, :] for v in vals], dim=-2)
    assert torch.equal(whole, _unpack(full.values) if q4 else full.values)
    assert torch.equal(torch.cat([w.scales[..., :kl // g, :] for w in ws],
                                 dim=-2), full.scales)
    return "padded" if pad else "rows"


def _cut_all(params, cfg):
    return [infer.shard_params(params, cfg, types.SimpleNamespace(
        tp=TP, tp_rank=r)) for r in range(TP)]


def _check_tree(params, shards, specs, cfg, prefix=""):
    kinds = {}
    for name, full in params.items():
        if name in ("tok_emb",):
            rows = torch.cat([s["tok_emb"] for s in shards])
            assert torch.equal(rows, full)
            for r, s in enumerate(shards):
                assert s["vocab_shard"].start == r * full.shape[0] // TP
            kinds[prefix + name] = "rows"
            continue
        locs = [s[name] for s in shards]
        if isinstance(full, dict):
            if isinstance(specs.get(name), dict):
                kinds.update(_check_tree(full, locs, specs[name], cfg,
                                         f"{prefix}{name}."))
            continue
        kinds[prefix + name] = _reassemble(full, locs, specs[name], cfg,
                                           name)
    return kinds


@pytest.mark.parametrize("case", ["q4_padded_and_whole", "moe_q4", "q8",
                                  "f32_qwen2"])
def test_shard_params_reassembles_the_tree_bit_for_bit(case):
    """Dense Q4 at group 64 with hidden 384: wo's K slice (64) is one
    group, padded to two; w_down's (96) is a group and a half, so w_down
    stays whole. The MoE banks with a shared expert, Q8 rows, and the f32
    Qwen2 tree with its QKV bias cut by heads."""
    gen = torch.Generator().manual_seed(5)
    cfg = tllm.LLMConfig(vocab_size=512, dim=256, n_layers=2, n_heads=8,
                         n_kv_heads=4, head_dim=32, hidden_dim=512,
                         max_seq=64)
    bits = {"q4_padded_and_whole": 4, "moe_q4": 4, "q8": 8}.get(case)
    if case == "q4_padded_and_whole":
        cfg = cfg._replace(hidden_dim=384)
    if case == "moe_q4":
        cfg = cfg._replace(n_experts=4, n_experts_used=2,
                           moe_shared_hidden=256)
    if case == "f32_qwen2":
        cfg = cfg._replace(qkv_bias=True)
    p = tllm.init_params(gen, cfg, dtype=torch.float32, device="cpu")
    if bits:
        p = tllm.quantize_params(p, bits=bits, group=64)
    shards = _cut_all(p, cfg)
    for s in shards:
        assert s.cfg.n_heads == 2 and s.cfg.n_kv_heads == 1
        assert s.cfg.hidden_dim == cfg.hidden_dim // TP
        assert s.cfg.vocab_size == cfg.vocab_size
    specs = infer.infer_param_shardings(bits is not None, p)
    kinds = _check_tree(p, [s.params for s in shards], specs, cfg)
    if case == "q4_padded_and_whole":
        assert kinds["layers.wo"] == "padded"
        assert kinds["layers.w_down"] == "whole"
        assert shards[0].report == {
            "layers.wo": {"k": 256, "k_local": 64, "group": 64,
                          "kind": "padded", "k_padded": 128},
            "layers.w_down": {"k": 384, "k_local": 96, "group": 64,
                              "kind": "whole"}}
    if case == "moe_q4":
        assert kinds["layers.w_down"] == "rows"
        assert kinds["layers.shared_down"] == "padded"
    assert kinds["layers.wqkv"] == "columns"
    assert kinds["lm_head"] == "columns"


def test_mla_shards_reassemble_with_whole_and_padded_rows():
    """DeepSeek-V2-Lite's groups at tiny widths: Q4 at group 64 where the
    routed w_down's K slice is a group and a half (whole on every rank) and
    the shared expert's is padded; wkv_b and wq by whole heads."""
    from trackiellm_tpu_torch.models import mla as tmla
    cfg = tmla.MLAConfig.tiny()._replace(
        n_heads=4, dim=256, hidden_dim=512, moe_hidden_dim=384,
        moe_shared_hidden=256, kv_lora_rank=64, max_seq=64)
    p = tmla.init_params(torch.Generator().manual_seed(3), cfg,
                         dtype=torch.float32, device="cpu")
    p = tmla.quantize_params(p, bits=4, group=64)
    shards = _cut_all(p, cfg)
    specs = infer.mla_param_shardings(p)
    kinds = _check_tree(p, [s.params for s in shards], specs, cfg)
    assert kinds["moe_mlp.w_down"] == "whole"
    assert kinds["moe_mlp.shared_down"] == "padded"
    assert kinds["attn.wkv_b"] == "columns"
    assert kinds["attn.wkv_a"] == "whole-leaf"
    assert shards[0].cfg.n_heads == 1
    assert shards[0].cfg.moe_hidden_dim == 96
