"""The dense model families of the port against the JAX package, on the CPU.

Every dense preset of ``LLMConfig`` (Llama-3.x, Qwen2/3, Phi-3, Granite,
GLM-4, Gemma-2/3, OLMo-2, SmolLM3 and Mistral) keeps its knob set at tiny
widths: 2 layers, dim 64, head dim 16, 4 query heads in the preset's GQA
ratio, a vocabulary of 320. Sliding windows become 24 so that the bucket-64
prefill masks with them; Gemma-3's 6-layer window pattern and SmolLM3's
4-layer NoPE interval become 2 so that both kinds of layer are among the
two. Llama-3 runs with ``llama3_rope_factors``, Gemma-3 4B+ with
``linear_rope_factors(cfg, 8.0)``. The weights are seeded numpy draws
(norm weights about 1, biases about 0) in the JAX package's layout, the
same values on both sides through ``params_from_jax``.

Dense f32 logits agree to ``ATOL`` (``tests/test_torch_llm.py``), Q4 and Q8
(on a few knob sets) to 2e-2 relative L2, through ``prefill``, ``extend`` and ``decode_step``,
``prefill_batch`` and ``decode_step_batch``, the paged int8 pool's
``decode_step``, and greedy ids through ``LLMRunner.generate``. Phi-3's
longrope sets switch on both sides at ``rope_original_max_seq``; the rope
factor functions, the LayerNorm's row independence and the fused-MLP
lever's refusals are pinned on their own.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tests.test_torch_llm import ATOL
from trackiellm_tpu.llm import paging as jpaging
from trackiellm_tpu.llm import runner as jrunner
from trackiellm_tpu.llm.tokenizer import ByteTokenizer as JByteTokenizer
from trackiellm_tpu.models import llm as jllm
from trackiellm_tpu_torch.llm import paging as tpaging
from trackiellm_tpu_torch.llm.runner import GenerationConfig, LLMRunner
from trackiellm_tpu_torch.llm.tokenizer import ByteTokenizer
from trackiellm_tpu_torch.models import llm as tllm
from trackiellm_tpu_torch.models.bridge import params_from_jax
from trackiellm_tpu_torch.ops import fused

REL_Q = 2e-2          # Q4 and Q8, relative L2
GROUP = 32            # divides every K/2 of the tiny shapes
WINDOW = 24
PRESETS = tllm.DENSE_PRESETS


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes: one intra-op thread, so this file does not crowd the
    other test workers' CPUs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tiny(name: str) -> jllm.LLMConfig:
    """The preset's knob set at the widths of the module docstring."""
    c = getattr(jllm.LLMConfig, name)()
    rep = min(c.n_heads // c.n_kv_heads, 4)
    windowed = 0 < c.sliding_window < c.max_seq
    return c._replace(
        vocab_size=320, dim=64, n_layers=2, n_heads=4, n_kv_heads=4 // rep,
        head_dim=16, hidden_dim=128, max_seq=128,
        sliding_window=WINDOW if windowed else 128,
        window_pattern=2 if c.window_pattern else 0,
        nope_pattern=2 if c.nope_pattern else 0)


def _rope_kind(name: str) -> str:
    if name == "llama3_8b":
        return "llama3"
    return "linear" if name in ("gemma3_4b", "gemma3_12b",
                                "gemma3_27b") else ""


def _knob_sets():
    """One case per distinct tiny knob set, named by its presets (Gemma-2
    2B and 9B, Gemma-3 4B and 12B cut to the same config). Mistral's is
    tests/test_torch_llm.py's and tests/test_torch_paging.py's."""
    sets = {}
    for name in PRESETS[1:]:
        sets.setdefault((_tiny(name), _rope_kind(name)), []).append(name)
    return [pytest.param(names[0], id="+".join(names))
            for names in sets.values()]


KNOB_SETS = _knob_sets()


def _np_tree(cfg: jllm.LLMConfig, seed: int):
    """Seeded numpy leaves in the JAX package's ``init_params`` layout."""
    shapes = jax.eval_shape(lambda: jllm.init_params(
        jax.random.PRNGKey(0), cfg, dtype=jnp.float32))
    rng = np.random.default_rng(seed)

    def leaf(path, sd):
        name = jax.tree_util.keystr(path)
        shape = sd.shape
        if "norm" in name:
            v = 1.0 + 0.1 * rng.standard_normal(shape)
        elif "bias" in name:
            v = 0.02 * rng.standard_normal(shape)
        elif "tok_emb" in name:
            v = 0.2 * rng.standard_normal(shape)
        else:
            v = rng.standard_normal(shape) / np.sqrt(shape[-2])
        return v.astype(np.float32)
    return jax.tree_util.tree_map_with_path(leaf, shapes)


_PARAMS = {}


def _params(name: str, bits: int = 0):
    """(JAX cfg, port cfg, JAX params, port params) of a preset's knob set,
    with its rope factors; ``bits`` 4 or 8 quantizes at GROUP."""
    key = (name, bits)
    if key not in _PARAMS:
        cfg = _tiny(name)
        p = jax.tree_util.tree_map(jnp.asarray, _np_tree(cfg, 7))
        if _rope_kind(name) == "llama3":
            p["rope_factors"] = jllm.llama3_rope_factors(cfg, 8.0)
        elif _rope_kind(name) == "linear":
            p["rope_factors"] = jllm.linear_rope_factors(cfg, 8.0)
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


def _cache(cfg, tcfg):
    return (jllm.KVCache.create(cfg, dtype=jnp.float32),
            tllm.KVCache.create(tcfg, torch.float32, device="cpu"))


def _prefill_both(cfg, tcfg, jp, tp, toks, length):
    jc0, tc0 = _cache(cfg, tcfg)
    jl, jc = jllm.prefill(jp, cfg, jnp.asarray(toks), jnp.int32(length), jc0)
    tl, tc = tllm.prefill(tp, tcfg, torch.from_numpy(toks.astype(np.int64)),
                          length, tc0)
    return jl, jc, tl, tc


def test_presets_match_and_are_supported():
    """The port's dense presets are the JAX package's, and each runs."""
    for name in PRESETS:
        want = getattr(jllm.LLMConfig, name)()
        got = getattr(tllm.LLMConfig, name)()
        assert got._asdict() == want._asdict(), name
        tllm.check_supported(got)


@pytest.mark.parametrize("name", KNOB_SETS)
def test_prefill_extend_decode_match(name):
    """Bucket-64 prefill of 40 tokens (the window of 24 masks), a 16-token
    extend with 11 valid, then three decode steps: dense f32 logits, and
    the caches at every written row."""
    _prefill_extend_decode(name, 0)


@pytest.mark.parametrize("name,bits", [("gemma2_9b", 4), ("olmo2_7b", 8)])
def test_quantized_prefill_extend_decode_match(name, bits):
    """The same chain on Q4 and Q8 weights (relative L2)."""
    _prefill_extend_decode(name, bits)


def _prefill_extend_decode(name, bits):
    cfg, tcfg, jp, tp = _params(name, bits)
    jl, jc, tl, tc = _prefill_both(cfg, tcfg, jp, tp, _tokens(1, 64), 40)
    _close(tl, jl, bits, "prefill")
    chunk = _tokens(2, 16)
    jl, jc = jllm.extend(jp, cfg, jnp.asarray(chunk), jnp.int32(11), jc)
    tl, tc = tllm.extend(tp, tcfg, torch.from_numpy(chunk.astype(np.int64)),
                         11, tc)
    _close(tl, jl, bits, "extend")
    assert tc.length == int(jc.length) == 51
    for step, tok in enumerate([5, 300, 17]):
        jl, jc = jllm.decode_step(jp, cfg, jnp.int32(tok), jc)
        tl, tc = tllm.decode_step(tp, tcfg, tok, tc)
        _close(tl, jl, bits, f"decode {step}")
    if not bits:
        n = tc.length
        for a, b in ((tc.k, jc.k), (tc.v, jc.v)):
            np.testing.assert_allclose(a[:, :n].numpy(), np.asarray(b)[:, :n],
                                       rtol=0, atol=ATOL)


@pytest.mark.parametrize("name", KNOB_SETS)
def test_batched_steps_match(name):
    """A wave of two prompts (40 and 17 tokens) through ``prefill_batch``,
    inserted into three slots with one left empty, then two
    ``decode_step_batch`` steps with that slot inactive."""
    cfg, tcfg, jp, tp = _params(name)
    toks = np.stack([_tokens(3, 64), _tokens(4, 64)])
    lengths = np.asarray([40, 17], np.int32)
    jl, jcs = jllm.prefill_batch(jp, cfg, jnp.asarray(toks),
                                 jnp.asarray(lengths),
                                 cache_dtype=jnp.float32)
    tl, tcs = tllm.prefill_batch(tp, tcfg, torch.from_numpy(toks),
                                 torch.from_numpy(lengths),
                                 cache_dtype=torch.float32)
    _close(tl, jl, 0, "prefill_batch")
    # The JAX slots are written with numpy (insert_sequence compiles once
    # a slot); the port's through insert_sequence.
    shape = (cfg.n_layers, 3, cfg.max_seq, cfg.n_kv_heads, cfg.head_dim)
    jk, jv = np.zeros(shape, np.float32), np.zeros(shape, np.float32)
    tb = tllm.BatchedKVCache.create(tcfg, 3, torch.float32, device="cpu")
    for i, slot in enumerate((0, 2)):
        jk[:, slot], jv[:, slot] = np.asarray(jcs.k[i]), np.asarray(jcs.v[i])
        tb = tllm.insert_sequence(tb, tcfg, slot, tllm.KVCache(
            tcs.k[i], tcs.v[i], int(lengths[i])))
    jb = jllm.BatchedKVCache(jnp.asarray(jk), jnp.asarray(jv),
                             jnp.asarray([40, 0, 17], jnp.int32))
    active = np.asarray([True, False, True])
    step_toks = np.asarray([7, 0, 250], np.int32)
    for step in range(2):
        jl, jb = jllm.decode_step_batch(jp, cfg, jnp.asarray(step_toks),
                                        jnp.asarray(active), jb)
        tl, tb = tllm.decode_step_batch(
            tp, tcfg, torch.from_numpy(step_toks.astype(np.int64)),
            torch.from_numpy(active), tb)
        _close(tl.numpy()[active], np.asarray(jl)[active], 0,
               f"decode_step_batch {step}")
        step_toks = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    np.testing.assert_array_equal(tb.lengths.numpy(), np.asarray(jb.lengths))


@pytest.mark.parametrize("name", KNOB_SETS)
def test_paged_int8_decode_matches(name):
    """One sequence's decode on the int8 page pool (pages of 16) across a
    page boundary, after a 10-token prefill: logits as the JAX pool's."""
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
    assert tpool.length(ts) == jpool.length(js) == 18


@pytest.mark.parametrize("name", ["gemma2_2b", "gemma3_4b", "phi3_mini",
                                  "olmo2_7b"])
def test_generate_matches_jax_runner(name):
    """Greedy text and ids through ``LLMRunner.generate`` at lookahead 4,
    Q4 weights, as the JAX runner's, on four knob sets (each costs its own
    compiles of the JAX runner's programs)."""
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


def test_longrope_switches_at_the_original_length():
    """Phi-3 longrope: a 40-token prefill (short set) and decode steps past
    ``rope_original_max_seq`` = 44 (long set), against the JAX package; the
    two sets give different logits, so the switch is seen."""
    cfg, _, jp, tp = _params("phi3_mini")
    cfg = cfg._replace(rope_original_max_seq=44)
    tcfg = tllm.LLMConfig(**cfg._asdict())
    rng = np.random.default_rng(11)
    short = (1.0 + rng.random(8)).astype(np.float32)
    long = (2.0 + 2.0 * rng.random(8)).astype(np.float32)
    jp = dict(jp, rope_factors_short=jnp.asarray(short),
              rope_factors_long=jnp.asarray(long))
    tp = dict(tp, rope_factors_short=torch.from_numpy(short),
              rope_factors_long=torch.from_numpy(long))
    toks = _tokens(6, 64)
    jl, jc, tl, tc = _prefill_both(cfg, tcfg, jp, tp, toks, 40)
    _close(tl, jl, 0, "prefill (short)")
    for step in range(6):  # positions 40..45: totals 41..46 cross 44
        jl, jc = jllm.decode_step(jp, cfg, jnp.int32(step + 3), jc)
        tl, tc = tllm.decode_step(tp, tcfg, step + 3, tc)
        _close(tl, jl, 0, f"decode at total {41 + step}")
    # Without the long set the last step differs: the switch took effect.
    tp_short = dict(tp, rope_factors_long=torch.from_numpy(short))
    _, tc2 = _prefill_both(cfg, tcfg, jp, tp_short, toks, 40)[2:]
    for step in range(6):
        tl2, tc2 = tllm.decode_step(tp_short, tcfg, step + 3, tc2)
    assert _rel(tl2, tl) > 1e-3


def test_rope_factor_functions_match():
    for name in ("llama3_8b", "glm4_9b"):
        cfg = getattr(jllm.LLMConfig, name)()
        tcfg = tllm.LLMConfig(**cfg._asdict())
        np.testing.assert_allclose(
            tllm.llama3_rope_factors(tcfg, 8.0).numpy(),
            np.asarray(jllm.llama3_rope_factors(cfg, 8.0)), rtol=1e-6)
        np.testing.assert_allclose(
            tllm.llama3_rope_factors(tcfg, 32.0, 1.0, 4.0, 4096).numpy(),
            np.asarray(jllm.llama3_rope_factors(cfg, 32.0, 1.0, 4.0, 4096)),
            rtol=1e-6)
        np.testing.assert_array_equal(
            tllm.linear_rope_factors(tcfg, 8.0).numpy(),
            np.asarray(jllm.linear_rope_factors(cfg, 8.0)))
        np.testing.assert_allclose(
            tllm._rope_freqs(tcfg).numpy(), np.asarray(jllm._rope_freqs(cfg)),
            rtol=1e-6)


def test_layer_norm_row_does_not_depend_on_the_batch():
    """A LayerNorm row (with its bias) is the same alone or among 16 rows,
    and matches the JAX package's ``_norm``."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((16, 64)).astype(np.float32) * 3 + 1
    g = (1 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    b = (0.1 * rng.standard_normal(64)).astype(np.float32)
    p = {"g": torch.from_numpy(g), "b": torch.from_numpy(b)}
    rows = tllm._norm(torch.from_numpy(x), p, 1e-5, "layernorm")
    for i in range(16):
        alone = tllm._norm(torch.from_numpy(x[i:i + 1]), p, 1e-5, "layernorm")
        assert torch.equal(rows[i:i + 1], alone)
    want = jllm._norm(jnp.asarray(x), {"g": jnp.asarray(g),
                                       "b": jnp.asarray(b)}, 1e-5,
                      "layernorm")
    np.testing.assert_allclose(rows.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("kw", [
    {"act": "gelu"}, {"post_norm": "ones"}, {"residual_multiplier": 0.22},
    {"gated": False}, {"norm_type": "layernorm"},
])
def test_fused_lever_takes_only_swiglu_rms(monkeypatch, kw):
    """``TRACKIE_FUSED_MLP=1`` fuses only SwiGLU with an RMS pre-norm, no
    post-norm, multiplier 1 and gated weights (the JAX rule); GeGLU, a
    post-norm, a multiplier, an ungated MLP or a LayerNorm take the
    composable path."""
    monkeypatch.setenv("TRACKIE_FUSED_MLP", "1")
    calls = []
    monkeypatch.setattr(fused, "_can_fuse", lambda *a: True)
    monkeypatch.setattr(fused, "fused_mlp",
                        lambda *a: calls.append(a) or a[0])
    x = torch.randn(1, 64)
    norm = torch.ones(64)
    w_gu, w_down = torch.randn(64, 256), torch.randn(128, 64)
    tllm._mlp_block(x, norm, w_gu, w_down, 1e-5)
    assert len(calls) == 1           # the SwiGLU RMS block fuses
    kw = dict(kw)
    if kw.get("post_norm") == "ones":
        kw["post_norm"] = norm
    if kw.get("gated") is False:
        w_gu = torch.randn(64, 128)
    tllm._mlp_block(x, norm, w_gu, w_down, 1e-5, **kw)
    assert len(calls) == 1           # this one does not


@pytest.mark.parametrize("name", ["gemma3_4b", "phi3_mini"])
def test_family_checkpoint_round_trips_and_generates(tmp_path, name):
    """A Q4 family checkpoint with its rope factor leaves (Gemma-3's linear
    set; Phi-3's longrope pair) saves, loads with its config, and greedy
    ids through ``LLMRunner.generate`` are the saved tree's."""
    from trackiellm_tpu_torch.models import checkpoint
    _, tcfg, _, tp = _params(name, 4)
    if name == "phi3_mini":
        tcfg = tcfg._replace(rope_original_max_seq=20)
        tp = dict(tp, rope_factors_short=torch.linspace(1.0, 1.5, 8),
                  rope_factors_long=torch.linspace(1.0, 8.0, 8))
    checkpoint.save_checkpoint(str(tmp_path), tp, config=tcfg)
    lp, lcfg, _ = checkpoint.load_checkpoint(str(tmp_path), device="cpu")
    assert lcfg == tcfg
    factor_leaves = sorted(k for k in lp if k.startswith("rope_factors"))
    assert factor_leaves == sorted(k for k in tp if k.startswith("rope"))
    ids = []
    for p in (tp, lp):
        r = LLMRunner(p, tcfg, ByteTokenizer(tcfg.vocab_size),
                      GenerationConfig(temperature=0.0, max_tokens=12,
                                       speculative=False),
                      cache_dtype=torch.float32, device="cpu")
        r.generate("descreva a cena com detalhes")
        ids.append(r._generated_ids)
    assert ids[0] == ids[1] and ids[0]
