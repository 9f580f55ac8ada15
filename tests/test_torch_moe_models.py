"""Whole MoE models of the port against the JAX package, on the CPU.

One tiny knob set a family, from the JAX presets (Mixtral, Qwen1.5-MoE,
Qwen3-MoE, gpt-oss with its YaRN factors, Llama-4 Scout) and two shaped
by hand: GLM-4-MoE (a leading dense layer, sigmoid routing with a
selection bias and four groups by top-2 sum, an ungated shared expert,
half rotary) and Llama-4 Maverick's dense/MoE interleave. Widths: 2
layers, dim 64, head dim 16, 4 query heads in the preset's GQA ratio, at
most 16 experts 64 wide with the preset's top-k up to half of them, a
vocabulary of 320; windows become 24, NoPE intervals 2, chunks 16 and the
temperature floor 4, so that every knob binds in a bucket-64 prefill.
Weights are seeded numpy draws in the JAX package's layout (the router
at 3 / sqrt(D), so that its choices are far apart), carried across by
``params_from_jax``.

Dense f32 logits agree to 1e-4 through ``prefill``, ``extend`` and
``decode_step``, ``prefill_batch`` and ``decode_step_batch``, and the
paged int8 pool; Q4 and Q8 chains to 2e-2 relative L2; greedy ids
through ``LLMRunner.generate`` and text through ``LLMServer`` (dense
slots and the int8 pool) equal the JAX package's; a Q4 checkpoint
round trip generates the same ids.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from trackiellm_tpu.llm import paging as jpaging
from trackiellm_tpu.llm import runner as jrunner
from trackiellm_tpu.llm.server import LLMServer as JServer
from trackiellm_tpu.llm.tokenizer import ByteTokenizer as JByteTokenizer
from trackiellm_tpu.models import llm as jllm
from trackiellm_tpu_torch.llm import paging as tpaging
from trackiellm_tpu_torch.llm.runner import GenerationConfig, LLMRunner
from trackiellm_tpu_torch.llm.server import LLMServer
from trackiellm_tpu_torch.llm.tokenizer import ByteTokenizer
from trackiellm_tpu_torch.models import llm as tllm
from trackiellm_tpu_torch.models.bridge import params_from_jax
from trackiellm_tpu_torch.ops.quant import QuantizedLinear

ATOL = 1e-4
REL_Q = 2e-2
GROUP = 32
TIMEOUT = 120
HYBRID_HIDDEN = 96


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tiny(name: str) -> jllm.LLMConfig:
    """A family's knob set at the widths of the module docstring."""
    if name == "glm4moe":
        return jllm.LLMConfig.tiny()._replace(
            vocab_size=320, dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
            head_dim=16, hidden_dim=64, max_seq=128, sliding_window=128,
            qkv_bias=True, qk_norm=True, partial_rotary_factor=0.5,
            n_experts=16, n_experts_used=4, moe_score_func="sigmoid",
            moe_norm_topk=True, moe_routed_scale=2.5, moe_n_groups=4,
            moe_topk_groups=2, moe_group_score="top2sum",
            moe_shared_hidden=64, moe_shared_gated=False, moe_first_dense=1)
    maverick = name == "llama4_maverick"
    c = getattr(jllm.LLMConfig, "llama4_scout" if maverick else name)()
    rep = min(c.n_heads // c.n_kv_heads, 4)
    e = min(c.n_experts, 16)
    windowed = 0 < c.sliding_window < c.max_seq
    c = c._replace(
        vocab_size=320, dim=64, n_layers=2, n_heads=4, n_kv_heads=4 // rep,
        head_dim=16, hidden_dim=64, max_seq=128,
        sliding_window=24 if windowed else 128, n_experts=e,
        n_experts_used=min(c.n_experts_used, e // 2),
        moe_shared_hidden=64 if c.moe_shared_hidden else 0,
        nope_pattern=2 if c.nope_pattern else 0,
        attn_chunk=16 if c.attn_chunk else 0,
        attn_temp_floor=4.0 if c.attn_temp_tuning else c.attn_temp_floor)
    return c._replace(moe_pattern=2) if maverick else c


FAMILIES = ["mixtral_8x7b", "qwen15_moe_a27b", "qwen3_moe_30b_a3b",
            "gpt_oss_20b", "llama4_scout", "glm4moe", "llama4_maverick"]


def _np_tree(cfg: jllm.LLMConfig, seed: int):
    """Seeded numpy leaves in the JAX package's ``init_params`` layout,
    plus a hybrid stack's dense MLP and GLM's selection bias."""
    shapes = jax.eval_shape(lambda: jllm.init_params(
        jax.random.PRNGKey(0), cfg, dtype=jnp.float32))
    rng = np.random.default_rng(seed)

    def leaf(path, sd):
        name = jax.tree_util.keystr(path)
        shape = sd.shape
        if "norm" in name:
            v = 1.0 + 0.1 * rng.standard_normal(shape)
        elif "bias" in name or name.endswith("_b']"):
            v = 0.05 * rng.standard_normal(shape)
        elif "tok_emb" in name or "sink" in name:
            v = 0.5 * rng.standard_normal(shape)
        elif "moe_gate" in name:
            v = 3.0 * rng.standard_normal(shape) / np.sqrt(shape[-2])
        else:
            v = rng.standard_normal(shape) / np.sqrt(shape[-2])
        return v.astype(np.float32)
    tree = jax.tree_util.tree_map_with_path(leaf, shapes)
    lay = tree["layers"]
    l, d = cfg.n_layers, cfg.dim
    if cfg.moe_pattern > 1 or cfg.moe_first_dense:
        lay["w_gu_mlp"] = (rng.standard_normal((l, d, 2 * HYBRID_HIDDEN))
                           / np.sqrt(d)).astype(np.float32)
        lay["w_down_mlp"] = (rng.standard_normal((l, HYBRID_HIDDEN, d))
                             / np.sqrt(HYBRID_HIDDEN)).astype(np.float32)
    if cfg.moe_score_func == "sigmoid":
        lay["moe_gate_bias"] = (0.2 * rng.standard_normal(
            (l, cfg.n_experts)) - 0.3).astype(np.float32)
    return tree


_PARAMS = {}


def _params(name: str, bits: int = 0):
    """(JAX cfg, port cfg, JAX params, port params); ``bits`` 4 or 8
    quantizes at GROUP."""
    key = (name, bits)
    if key not in _PARAMS:
        cfg = _tiny(name)
        p = jax.tree_util.tree_map(jnp.asarray, _np_tree(cfg, 7))
        if name == "gpt_oss_20b":
            p["rope_factors"] = jllm.yarn_rope_factors(cfg, 32.0, 4096,
                                                       truncate=False)
        if bits:
            p = jllm.quantize_params(p, bits=bits, group=GROUP)
        _PARAMS[key] = (cfg, tllm.LLMConfig(**cfg._asdict()), p,
                        params_from_jax(p))
    return _PARAMS[key]


def _tokens(seed, n):
    return np.random.default_rng(seed).integers(0, 320, n).astype(np.int32)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _close(got, want, bits, msg=""):
    if bits:
        assert _rel(got, want) < REL_Q, msg
    else:
        np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                                   atol=ATOL, err_msg=msg)


def _prefill_both(cfg, tcfg, jp, tp, toks, length):
    jc0 = jllm.KVCache.create(cfg, dtype=jnp.float32)
    tc0 = tllm.KVCache.create(tcfg, torch.float32, device="cpu")
    jl, jc = jllm.prefill(jp, cfg, jnp.asarray(toks), jnp.int32(length), jc0)
    tl, tc = tllm.prefill(tp, tcfg, torch.from_numpy(toks.astype(np.int64)),
                          length, tc0)
    return jl, jc, tl, tc


def _chain(name, bits):
    cfg, tcfg, jp, tp = _params(name, bits)
    jl, jc, tl, tc = _prefill_both(cfg, tcfg, jp, tp, _tokens(1, 64), 40)
    _close(tl, jl, bits, "prefill")
    chunk = _tokens(2, 16)
    jl, jc = jllm.extend(jp, cfg, jnp.asarray(chunk), jnp.int32(11), jc)
    tl, tc = tllm.extend(tp, tcfg, torch.from_numpy(chunk.astype(np.int64)),
                         11, tc)
    _close(tl, jl, bits, "extend")
    for step, tok in enumerate([5, 300, 17]):
        jl, jc = jllm.decode_step(jp, cfg, jnp.int32(tok), jc)
        tl, tc = tllm.decode_step(tp, tcfg, tok, tc)
        _close(tl, jl, bits, f"decode {step}")
    if not bits:
        n = tc.length
        for a, b in ((tc.k, jc.k), (tc.v, jc.v)):
            np.testing.assert_allclose(a[:, :n].numpy(), np.asarray(b)[:, :n],
                                       rtol=0, atol=ATOL)


@pytest.mark.parametrize("name", FAMILIES)
def test_prefill_extend_decode_match(name):
    """Bucket-64 prefill of 40 tokens, a 16-token extend with 11 valid and
    three decode steps: f32 logits, and the caches at every written row."""
    _chain(name, 0)


@pytest.mark.parametrize("name,bits", [
    ("mixtral_8x7b", 4), ("gpt_oss_20b", 4), ("qwen3_moe_30b_a3b", 8),
    ("qwen15_moe_a27b", 8)])
def test_quantized_prefill_extend_decode_match(name, bits):
    """The same chain on Q4 and Q8 expert banks (dense-all-experts)."""
    _chain(name, bits)


@pytest.mark.parametrize("name", FAMILIES)
def test_batched_rows_match_single_rows(name):
    """A wave of two prompts (40 and 17 tokens) through ``prefill_batch``,
    each row against ``prefill`` alone and the JAX wave; two
    ``decode_step_batch`` steps on three slots with the middle one
    inactive, each active row against a ``decode_step`` alone."""
    cfg, tcfg, jp, tp = _params(name)
    toks = np.stack([_tokens(3, 64), _tokens(4, 64)])
    lengths = np.asarray([40, 17], np.int32)
    jl, _ = jllm.prefill_batch(jp, cfg, jnp.asarray(toks),
                               jnp.asarray(lengths), cache_dtype=jnp.float32)
    tl, tcs = tllm.prefill_batch(tp, tcfg, torch.from_numpy(toks),
                                 torch.from_numpy(lengths),
                                 cache_dtype=torch.float32)
    _close(tl, jl, 0, "prefill_batch")
    singles = []
    for i in range(2):
        _, _, sl, sc = _prefill_both(cfg, tcfg, jp, tp, toks[i],
                                     int(lengths[i]))
        _close(tl[i], sl, 0, f"row {i} against prefill")
        singles.append(sc)
    tb = tllm.BatchedKVCache.create(tcfg, 3, torch.float32, device="cpu")
    for i, slot in enumerate((0, 2)):
        tb = tllm.insert_sequence(tb, tcfg, slot, tllm.KVCache(
            tcs.k[i], tcs.v[i], int(lengths[i])))
    active = torch.tensor([True, False, True])
    step_toks = [7, 0, 250]
    for step in range(2):
        bl, tb = tllm.decode_step_batch(
            tp, tcfg, torch.tensor(step_toks), active, tb)
        for i, slot in enumerate((0, 2)):
            sl, singles[i] = tllm.decode_step(tp, tcfg, step_toks[slot],
                                              singles[i])
            _close(bl[slot], sl, 0, f"step {step} slot {slot}")
        step_toks = torch.argmax(bl, -1).tolist()
    assert tb.lengths.tolist() == [42, 0, 19]


@pytest.mark.parametrize("name", FAMILIES)
def test_paged_int8_decode_matches(name):
    """One sequence's decode on the int8 page pool (pages of 16) across a
    page boundary, after a 10-token prefill, against the JAX pool's."""
    cfg, tcfg, jp, tp = _params(name)
    jl, jc, tl, tc = _prefill_both(cfg, tcfg, jp, tp, _tokens(5, 64), 10)
    jpool = jpaging.PagedKVPool(cfg, 16, 16, jnp.int8,
                                compute_dtype=jnp.float32)
    tpool = tpaging.PagedKVPool(tcfg, 16, 16, torch.int8,
                                compute_dtype=torch.float32, device="cpu")
    js = jpool.create_sequence(prefill_cache=jc, length=10)
    ts = tpool.create_sequence(prefill_cache=tc, length=10)
    tok = int(jnp.argmax(jl))
    for step in range(8):
        ref = jpool.decode_step(jp, tok, js)
        got = tpool.decode_step(tp, tok, ts)
        _close(got.numpy(), np.asarray(ref), 0, f"paged step {step}")
        tok = int(jnp.argmax(ref))


@pytest.mark.parametrize("name", ["gpt_oss_20b", "llama4_scout", "glm4moe"])
def test_generate_matches_jax_runner(name):
    """Greedy text and ids through ``LLMRunner.generate`` at lookahead 4 on
    Q4 weights, as the JAX runner's."""
    cfg, tcfg, jp, tp = _params(name, 4)
    gen = dict(temperature=0.0, max_tokens=12, speculative=False,
               lookahead=4)
    jr = jrunner.LLMRunner(jp, cfg, JByteTokenizer(cfg.vocab_size),
                           jrunner.GenerationConfig(**gen),
                           cache_dtype=jnp.float32)
    tr = LLMRunner(tp, tcfg, ByteTokenizer(cfg.vocab_size),
                   GenerationConfig(**gen), cache_dtype=torch.float32,
                   device="cpu")
    prompt = "descreva a cena"
    assert tr.generate(prompt) == jr.generate(prompt)
    assert tr._generated_ids == jr._generated_ids


def _serve(server_cls, params, cfg, tok, dtype, **kw):
    server = server_cls(params, cfg, batch_slots=2, tokenizer=tok,
                        cache_dtype=dtype, **kw)
    if kw.get("paged") and "int8" in str(dtype):
        server.pool.compute_dtype = (torch.float32 if server_cls is LLMServer
                                     else jnp.float32)
    try:
        futs = [server.submit(p, max_tokens=m) for p, m in
                (("ola", 11), ("descreva a cena", 9), ("x", 7))]
        return [f.result(timeout=TIMEOUT) for f in futs]
    finally:
        server.close()


@pytest.mark.parametrize("name", ["mixtral_8x7b", "gpt_oss_20b"])
def test_server_serves_moe(name):
    """``LLMServer`` on an MoE config: a burst of three requests on two
    slots, per-step and chunked on dense slots and on the int8 page pool;
    every mode gives the JAX server's text (the reference's
    ``test_server_serves_moe`` and ``test_paged_serving_matches_dense``)."""
    cfg, tcfg, jp, tp = _params(name, 4)
    modes = [dict(chunk_steps=1), dict(chunk_steps=4),
             dict(paged=True, page_size=16, chunk_steps=4, int8=True)]
    for mode in modes:
        mode = dict(mode)
        int8 = mode.pop("int8", False)
        want = _serve(JServer, jp, cfg, JByteTokenizer(cfg.vocab_size),
                      jnp.int8 if int8 else jnp.float32, **mode)
        got = _serve(LLMServer, tp, tcfg, ByteTokenizer(cfg.vocab_size),
                     torch.int8 if int8 else torch.float32, **mode)
        assert got == want, mode
        assert any(got)


def _tree_layout(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_tree_layout(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, QuantizedLinear):
        return {prefix + ".values": (tuple(tree.values.shape),
                                     str(tree.values.dtype)),
                prefix + ".scales": (tuple(tree.scales.shape),
                                     str(tree.scales.dtype))}
    return {prefix: (tuple(tree.shape), str(tree.dtype))}


@pytest.mark.parametrize("bits", [4, 8])
def test_init_params_quantized_has_the_quantized_layout(bits):
    """``init_params_quantized`` builds (L, E, ...) expert stacks one
    expert at a time, in the layout of ``quantize_params(init_params)``;
    the JAX package's ``quantize_params`` gives the same shapes."""
    for name in FAMILIES:
        cfg = _tiny(name)
        tcfg = tllm.LLMConfig(**cfg._asdict())
        g = torch.Generator().manual_seed(0)
        direct = tllm.init_params_quantized(g, tcfg, bits=bits, group=GROUP,
                                            dtype=torch.float32,
                                            device="cpu")
        via = tllm.quantize_params(
            tllm.init_params(g, tcfg, dtype=torch.float32, device="cpu"),
            bits=bits, group=GROUP)
        assert _tree_layout(direct) == _tree_layout(via), name
        jq = params_from_jax(jllm.quantize_params(
            _np_tree(cfg, 1), bits=bits, group=GROUP))
        if cfg.moe_pattern > 1 or cfg.moe_first_dense:
            jq["layers"]["w_gu_mlp"] = direct["layers"]["w_gu_mlp"]
            jq["layers"]["w_down_mlp"] = direct["layers"]["w_down_mlp"]
        for key in ("moe_gate_bias",):
            jq["layers"].pop(key, None)
        assert _tree_layout(jq) == _tree_layout(direct), name


@pytest.mark.parametrize("name", ["gpt_oss_20b", "glm4moe"])
def test_moe_checkpoint_round_trips_and_generates(tmp_path, name):
    """A Q4 MoE checkpoint (4-D expert stacks, sinks, biases, a hybrid
    stack's dense MLP) saves, loads with its config, and generates the
    saved tree's greedy ids."""
    from trackiellm_tpu_torch.models import checkpoint
    _, tcfg, _, tp = _params(name, 4)
    checkpoint.save_checkpoint(str(tmp_path), tp, config=tcfg)
    lp, lcfg, _ = checkpoint.load_checkpoint(str(tmp_path), device="cpu")
    assert lcfg == tcfg
    assert lp["layers"]["w_gu"].values.dim() == 4
    ids = []
    for p in (tp, lp):
        r = LLMRunner(p, tcfg, ByteTokenizer(tcfg.vocab_size),
                      GenerationConfig(temperature=0.0, max_tokens=12,
                                       speculative=False),
                      cache_dtype=torch.float32, device="cpu")
        r.generate("descreva a cena com detalhes")
        ids.append(r._generated_ids)
    assert ids[0] == ids[1] and ids[0]
