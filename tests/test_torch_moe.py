"""The port's MoE block and the Llama-4, gpt-oss and Falcon knobs against the
JAX package, on the CPU.

The MoE block alone (``_moe_block``) runs eager on both sides at tiny widths
(dim 64, 8 or 16 experts 64 wide) with seeded numpy weights in the JAX
package's layout, once per router variant: softmax with and without
renormalization, the gated and ungated shared expert, sigmoid with the
selection-only ``moe_gate_bias``, group-limited routing by max and by top-2
sum and ``moe_routed_scale``, gpt-oss's ``softmax_topk`` with expert and
router biases and the clamped SwiGLU, and Llama-4's input-scaled
``sigmoid_topk``; f32 outputs agree to 1e-5. Exact ties (a zero router,
and the signed zeros that group masking makes) pick the experts that
``lax.top_k`` picks. The routed formulation (``TRACKIE_MOE_ROUTED=1``)
gives the dense-all-experts result and the JAX routed one. Whole models
with these blocks are ``tests/test_torch_moe_models.py``; the knobs of the
attention side (post-rope L2 norm, NoPE temperature, chunks, sinks) and
Falcon's parallel MLP norm run here through ``prefill``, ``extend`` and
``decode_step`` at 1e-4.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from trackiellm_tpu.models import llm as jllm
from trackiellm_tpu_torch.models import llm as tllm
from trackiellm_tpu_torch.models.bridge import params_from_jax

BLOCK_ATOL = 1e-5
ATOL = 1e-4
T = 12          # rows through the block


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


BASE = jllm.LLMConfig.tiny()._replace(
    vocab_size=320, dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
    head_dim=16, hidden_dim=64, max_seq=128, sliding_window=128,
    n_experts=8, n_experts_used=2)

ROUTERS = {
    "softmax_norm": {},
    "softmax_raw": dict(moe_norm_topk=False, n_experts_used=3),
    "shared_gated": dict(moe_shared_hidden=64, moe_norm_topk=False,
                         n_experts_used=4),
    "shared_ungated": dict(moe_shared_hidden=64, moe_shared_gated=False),
    "sigmoid_groups_max": dict(
        n_experts=16, n_experts_used=4, moe_score_func="sigmoid",
        moe_n_groups=4, moe_topk_groups=2, moe_group_score="max",
        moe_routed_scale=2.5, moe_shared_hidden=64, moe_shared_gated=False),
    "sigmoid_groups_top2sum": dict(
        n_experts=16, n_experts_used=4, moe_score_func="sigmoid",
        moe_n_groups=4, moe_topk_groups=2, moe_group_score="top2sum",
        moe_routed_scale=2.5),
    "gptoss": dict(moe_score_func="softmax_topk", moe_norm_topk=False,
                   moe_bias=True, act="gptoss", n_experts_used=4),
    "llama4": dict(moe_score_func="sigmoid_topk", moe_norm_topk=False,
                   moe_scale_input=True, n_experts_used=1,
                   moe_shared_hidden=64, moe_shared_gated=False),
}
GATE_BIAS = ("sigmoid_groups_max", "sigmoid_groups_top2sum")


def _layer_np(cfg, seed, gate_bias=False):
    """One layer's MoE leaves (the JAX package's names), seeded numpy f32:
    the router at 3 / sqrt(D) so that its choices are far apart."""
    rng = np.random.default_rng(seed)
    d, e, h = cfg.dim, cfg.n_experts, cfg.hidden_dim

    def mat(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale / np.sqrt(shape[-2])
                ).astype(np.float32)
    layer = {"mlp_norm": (1 + 0.1 * rng.standard_normal(d)).astype(np.float32),
             "moe_gate": mat(d, e, scale=3.0),
             "w_gu": mat(e, d, 2 * h), "w_down": mat(e, h, d)}
    if cfg.moe_bias:
        layer["moe_gate_b"] = (0.3 * rng.standard_normal(e)).astype(np.float32)
        layer["w_gu_b"] = (0.1 * rng.standard_normal((e, 2 * h))).astype(
            np.float32)
        layer["w_down_b"] = (0.1 * rng.standard_normal((e, d))).astype(
            np.float32)
    if cfg.moe_shared_hidden:
        hs = cfg.moe_shared_hidden
        layer["shared_gu"] = mat(d, 2 * hs)
        layer["shared_down"] = mat(hs, d)
        layer["shared_gate"] = mat(d, 1)
    if gate_bias:
        layer["moe_gate_bias"] = (0.2 * rng.standard_normal(e) - 0.6).astype(
            np.float32)
    return layer


def _block_both(cfg, layer, x):
    jout = jllm._moe_block(jnp.asarray(x), jax.tree_util.tree_map(
        jnp.asarray, layer), cfg)
    tcfg = tllm.LLMConfig(**cfg._asdict())
    tout = tllm._moe_block(torch.from_numpy(x), params_from_jax(layer), tcfg)
    return np.asarray(jout), tout.numpy()


def _x(seed, rows=T, d=64):
    return (2.0 * np.random.default_rng(seed).standard_normal((rows, d))
            ).astype(np.float32)


@pytest.mark.parametrize("name", list(ROUTERS))
def test_moe_block_matches_each_router(monkeypatch, name):
    """Dense-all-experts (the quantized banks' route, and bf16 banks below
    the routed rule) on f32 weights, every router variant."""
    monkeypatch.setenv("TRACKIE_MOE_ROUTED", "0")
    cfg = BASE._replace(**ROUTERS[name])
    layer = _layer_np(cfg, 1, gate_bias=name in GATE_BIAS)
    want, got = _block_both(cfg, layer, _x(2))
    np.testing.assert_allclose(got, want, rtol=0, atol=BLOCK_ATOL)


@pytest.mark.parametrize("name", ["softmax_norm", "shared_gated", "gptoss",
                                  "llama4", "sigmoid_groups_top2sum"])
def test_routed_matches_dense_and_the_jax_routed(monkeypatch, name):
    """``TRACKIE_MOE_ROUTED=1`` (sorted grouped products, the slot-ordered
    combine) against ``=0`` on the port, and against the JAX package's
    routed block (the reference's ``test_routed_matches_dense``)."""
    cfg = BASE._replace(**ROUTERS[name])
    layer = _layer_np(cfg, 3, gate_bias=name in GATE_BIAS)
    x = _x(4, rows=40)
    monkeypatch.setenv("TRACKIE_MOE_ROUTED", "1")
    want_routed, routed = _block_both(cfg, layer, x)
    monkeypatch.setenv("TRACKIE_MOE_ROUTED", "0")
    _, dense = _block_both(cfg, layer, x)
    np.testing.assert_allclose(routed, want_routed, rtol=0, atol=BLOCK_ATOL)
    np.testing.assert_allclose(routed, dense, rtol=0, atol=BLOCK_ATOL)


def test_moe_use_routed_rule():
    """The reference's dispatch: "auto" at 5e11 dense FLOPs, the lever's
    "0" and "1", and quantized banks never routed."""
    big = torch.empty((8, 4096, 28672), device="meta")
    small = torch.empty((8, 1024, 7168), device="meta")
    for n, bank in ((512, big), (2, big), (512, small)):
        jbank = jax.ShapeDtypeStruct(tuple(bank.shape), jnp.bfloat16)
        assert tllm._moe_use_routed(n, bank) == jllm._moe_use_routed(n, jbank)
    assert tllm._moe_use_routed(512, big) and not tllm._moe_use_routed(2, big)
    q = tllm.quantize_params({"layers": {"w_gu": torch.randn(1, 2, 64, 64)},
                              "lm_head": torch.randn(64, 64)},
                             bits=8, group=32)["layers"]["w_gu"]
    assert not tllm._moe_use_routed(10 ** 6, q)


def test_top_k_first_is_lax_top_k_on_ties_and_signed_zeros():
    rng = np.random.default_rng(0)
    for trial in range(20):
        x = rng.integers(-2, 3, (6, 16)).astype(np.float32)
        x[rng.random(x.shape) < 0.3] = -0.0
        x[rng.random(x.shape) < 0.2] = 0.0
        for k in (1, 4, 9):
            want = np.asarray(jax.lax.top_k(jnp.asarray(x), k)[1])
            got = tllm._top_k_first(torch.from_numpy(x), k).numpy()
            np.testing.assert_array_equal(got, want, err_msg=f"{trial} {k}")


@pytest.mark.parametrize("case", ["zero_router", "masked_zeros"])
def test_exact_ties_pick_the_jax_experts(monkeypatch, case):
    """A zero router ties every expert (softmax 1/E): the lower ids win.
    Group masking with a negative selection bias leaves the masked
    experts at +0.0 and -0.0, and with top-4 of one kept group of two the
    zeros win: +0.0 before -0.0, the lower id first, as ``lax.top_k``."""
    monkeypatch.setenv("TRACKIE_MOE_ROUTED", "0")
    if case == "zero_router":
        cfg = BASE._replace(n_experts_used=3, moe_norm_topk=False)
        layer = _layer_np(cfg, 7)
        layer["moe_gate"][:] = 0.0
    else:
        cfg = BASE._replace(n_experts=8, n_experts_used=4,
                            moe_score_func="sigmoid", moe_n_groups=4,
                            moe_topk_groups=1, moe_group_score="max")
        layer = _layer_np(cfg, 8, gate_bias=True)
        # Selections straddle zero: masked ones become +0.0 or -0.0.
        layer["moe_gate_bias"] = np.asarray(
            [-0.9, 0.1, -0.8, -0.2, 0.05, -0.7, -0.1, -0.95], np.float32)
    x = _x(9)
    want, got = _block_both(cfg, layer, x)
    np.testing.assert_allclose(got, want, rtol=0, atol=BLOCK_ATOL)


# -- attention-side knobs and Falcon, through the forward bodies -------------

KNOBS = {
    # Llama-4: L2 norm on rope layers, NoPE every 2nd layer with its
    # temperature (floor 4 binds inside the bucket), chunks of 16.
    "llama4_attn": dict(nope_pattern=2, qk_l2norm=True,
                        attn_temp_tuning=True, attn_temp_floor=4.0,
                        attn_chunk=16),
    "temp_only": dict(nope_pattern=2, attn_temp_tuning=True,
                      attn_temp_floor=8.0),
    "sinks_alt_window": dict(attn_sinks=True, sliding_window=24,
                             alt_window=True, qkv_bias=True, out_bias=True),
    "falcon": dict(norm_type="layernorm", parallel_residual=True,
                   parallel_mlp_norm=True, mlp_gated=False,
                   act="gelu_exact", n_kv_heads=1, qkv_bias=True,
                   out_bias=True, mlp_bias=True, hidden_dim=128),
}


def _dense_tree(cfg, seed):
    shapes = jax.eval_shape(lambda: jllm.init_params(
        jax.random.PRNGKey(0), cfg, dtype=jnp.float32))
    rng = np.random.default_rng(seed)

    def leaf(path, sd):
        name = jax.tree_util.keystr(path)
        if "norm" in name:
            v = 1.0 + 0.1 * rng.standard_normal(sd.shape)
        elif "bias" in name or name.endswith("_b']"):
            v = 0.02 * rng.standard_normal(sd.shape)
        elif "tok_emb" in name or "sink" in name:
            v = 0.5 * rng.standard_normal(sd.shape)
        else:
            v = rng.standard_normal(sd.shape) / np.sqrt(sd.shape[-2])
        return v.astype(np.float32)
    tree = jax.tree_util.tree_map_with_path(leaf, shapes)
    lay = tree["layers"]
    l, d, h = cfg.n_layers, cfg.dim, cfg.hidden_dim
    if not cfg.mlp_gated:   # init_params builds the gated (D, 2H) shape
        lay["w_gu"] = (rng.standard_normal((l, d, h)) / np.sqrt(d)).astype(
            np.float32)
    if cfg.mlp_bias:
        n = lay["w_gu"].shape[-1]
        lay["w_gu_b"] = (0.02 * rng.standard_normal((l, n))).astype(np.float32)
        lay["w_down_b"] = (0.02 * rng.standard_normal((l, d))).astype(
            np.float32)
    if cfg.norm_type == "layernorm":   # LayerNorms with a bias
        for name in ("attn_norm", "mlp_norm"):
            lay[name] = {"g": lay[name],
                         "b": (0.05 * rng.standard_normal(lay[name].shape)
                               ).astype(np.float32)}
    return tree


def _tokens(seed, n):
    return np.random.default_rng(seed).integers(0, 320, n).astype(np.int32)


@pytest.mark.parametrize("name", list(KNOBS))
def test_attention_knobs_and_falcon_through_the_forward_bodies(name):
    """Bucket-64 prefill of 40 tokens (chunks 0-15, 16-31, 32-39), a
    16-token extend with 11 valid crossing into the fourth chunk, and three
    decode steps; f32 logits at 1e-4."""
    cfg = BASE._replace(n_experts=0, **KNOBS[name])
    tcfg = tllm.LLMConfig(**cfg._asdict())
    jp = jax.tree_util.tree_map(jnp.asarray, _dense_tree(cfg, 11))
    tp = params_from_jax(jp)
    jc = jllm.KVCache.create(cfg, dtype=jnp.float32)
    tc = tllm.KVCache.create(tcfg, torch.float32, device="cpu")
    toks = _tokens(1, 64)
    jl, jc = jllm.prefill(jp, cfg, jnp.asarray(toks), jnp.int32(40), jc)
    tl, tc = tllm.prefill(tp, tcfg, torch.from_numpy(toks.astype(np.int64)),
                          40, tc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=ATOL)
    chunk = _tokens(2, 16)
    jl, jc = jllm.extend(jp, cfg, jnp.asarray(chunk), jnp.int32(11), jc)
    tl, tc = tllm.extend(tp, tcfg, torch.from_numpy(chunk.astype(np.int64)),
                         11, tc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=ATOL)
    for step, tok in enumerate([5, 300, 17]):
        jl, jc = jllm.decode_step(jp, cfg, jnp.int32(tok), jc)
        tl, tc = tllm.decode_step(tp, tcfg, tok, tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                                   atol=ATOL, err_msg=f"decode {step}")


def test_knobs_change_the_logits():
    """Each Llama-4 knob is load-bearing at these shapes: dropping it moves
    the prefill logits."""
    cfg = tllm.LLMConfig(**BASE._replace(n_experts=0,
                                         **KNOBS["llama4_attn"])._asdict())
    tp = params_from_jax(_dense_tree(
        BASE._replace(n_experts=0, **KNOBS["llama4_attn"]), 11))
    toks = torch.from_numpy(_tokens(1, 64).astype(np.int64))

    def logits(c):
        cache = tllm.KVCache.create(c, torch.float32, device="cpu")
        return tllm.prefill(tp, c, toks, 40, cache)[0]
    base = logits(cfg)
    for knob, off in (("qk_l2norm", False), ("attn_temp_tuning", False),
                      ("attn_chunk", 0)):
        moved = logits(cfg._replace(**{knob: off}))
        assert (moved - base).abs().max() > 1e-3, knob


def test_every_jax_config_is_supported():
    """``check_supported`` takes every preset and knob set of the JAX
    package and refuses only head counts that do not group."""
    names = [n for n, v in vars(jllm.LLMConfig).items()
             if isinstance(v, classmethod) and not n.startswith("_")]
    assert set(tllm.DENSE_PRESETS + tllm.MOE_PRESETS) <= set(names)
    for name in names:
        want = getattr(jllm.LLMConfig, name)()
        got = getattr(tllm.LLMConfig, name)()
        assert got._asdict() == want._asdict(), name
        tllm.check_supported(got)
    for knobs in list(ROUTERS.values()) + list(KNOBS.values()):
        tllm.check_supported(tllm.LLMConfig(**BASE._replace(
            **knobs)._asdict()))
    with pytest.raises(ValueError, match="multiple"):
        tllm.check_supported(tllm.LLMConfig.tiny()._replace(n_kv_heads=3))
