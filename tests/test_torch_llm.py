"""Parity of trackiellm_tpu_torch.models.llm with trackiellm_tpu.models.llm.

LLMConfig.tiny() in f32 with Q4 weights at group 64 (group 256 does not
divide tiny's K/2 = 128). The JAX params go through ``params_from_jax``, so
both sides run on the same weight bytes. Logits of prefill, extend and
decode_step agree to 1e-4 abs (f32 sums in another order), the caches agree
at every written row, and decode_chunk_greedy emits the serial chain.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from trackiellm_tpu.models import llm as jllm
from trackiellm_tpu_torch.models import llm as tllm
from trackiellm_tpu_torch.models.bridge import params_from_jax
from trackiellm_tpu_torch.ops.quant import QuantizedLinear

ATOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes: one intra-op thread, so this file does not crowd the
    other test workers' CPUs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(window=0):
    cfg = jllm.LLMConfig.tiny()
    if window:
        cfg = cfg._replace(sliding_window=window)
    return cfg, tllm.LLMConfig(**cfg._asdict())


_PARAMS = {}


def _params(quantized=True):
    """JAX params and their bridged port (built once per module)."""
    if quantized not in _PARAMS:
        cfg, _ = _cfg()
        p = jllm.init_params(jax.random.PRNGKey(3), cfg, dtype=jnp.float32)
        if quantized:
            p = jllm.quantize_params(p, bits=4, group=64)
        _PARAMS[quantized] = (p, params_from_jax(p))
    return _PARAMS[quantized]


def _tokens(seed, n):
    return np.random.default_rng(seed).integers(0, 256, n).astype(np.int32)


def _assert_cache_rows(jc, tc, rows):
    np.testing.assert_allclose(tc.k[:, :rows].numpy(),
                               np.asarray(jc.k)[:, :rows], rtol=0, atol=ATOL)
    np.testing.assert_allclose(tc.v[:, :rows].numpy(),
                               np.asarray(jc.v)[:, :rows], rtol=0, atol=ATOL)


def _prefill_both(jp, tp, jcfg, tcfg, toks, length):
    jl, jc = jllm.prefill(jp, jcfg, jnp.asarray(toks), jnp.int32(length),
                          jllm.KVCache.create(jcfg, dtype=jnp.float32))
    tl, tc = tllm.prefill(tp, tcfg, torch.from_numpy(toks.astype(np.int64)),
                          length, tllm.KVCache.create(tcfg, torch.float32))
    return jl, jc, tl, tc


@pytest.mark.parametrize("quantized", [True, False])
@pytest.mark.parametrize("window", [0, 24])
@pytest.mark.parametrize("bucket,length", [(64, 40), (256, 200)])
def test_prefill_matches(bucket, length, window, quantized):
    jp, tp = _params(quantized)
    jcfg, tcfg = _cfg(window)
    toks = _tokens(bucket, bucket)
    jl, jc, tl, tc = _prefill_both(jp, tp, jcfg, tcfg, toks, length)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=ATOL)
    assert tc.length == int(jc.length) == length
    _assert_cache_rows(jc, tc, bucket)  # every row prefill wrote


@pytest.mark.parametrize("window", [0, 24])
@pytest.mark.parametrize("attn_len", [None, 128])
def test_extend_and_decode_match(attn_len, window):
    jp, tp = _params()
    jcfg, tcfg = _cfg(window)
    toks = _tokens(1, 64)
    jl, jc, tl, tc = _prefill_both(jp, tp, jcfg, tcfg, toks, 30)
    chunk = _tokens(2, 16)
    jl, jc = jllm.extend(jp, jcfg, jnp.asarray(chunk), jnp.int32(11), jc,
                         attn_len=attn_len)
    tl, tc = tllm.extend(tp, tcfg, torch.from_numpy(chunk.astype(np.int64)),
                         11, tc, attn_len=attn_len)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=ATOL)
    assert tc.length == int(jc.length) == 41
    _assert_cache_rows(jc, tc, 30 + 16)
    for step, tok in enumerate([5, 300, 17]):
        jl, jc = jllm.decode_step(jp, jcfg, jnp.int32(tok), jc,
                                  attn_len=attn_len)
        # The port takes a host int or a device token.
        t_tok = tok if step % 2 else torch.tensor(tok)
        tl, tc = tllm.decode_step(tp, tcfg, t_tok, tc, attn_len=attn_len)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                                   atol=ATOL)
        assert tc.length == int(jc.length)
        _assert_cache_rows(jc, tc, tc.length)


def test_embed_tokens_matches():
    jp, tp = _params()
    toks = _tokens(4, 16)
    np.testing.assert_array_equal(
        tllm.embed_tokens(tp, torch.from_numpy(toks)).numpy(),
        np.asarray(jllm.embed_tokens(jp, jnp.asarray(toks))))


@pytest.mark.parametrize("bits", [4, 8])
def test_quantize_params_matches(bits):
    """The port quantizes the bridged dense params to the same bytes the
    JAX package produces."""
    jdense, tdense = _params(quantized=False)
    jq = params_from_jax(jllm.quantize_params(jdense, bits=bits, group=64))
    tq = tllm.quantize_params(tdense, bits=bits, group=64)
    for name in ("wqkv", "wo", "w_gu", "w_down"):
        for part in ("values", "scales"):
            np.testing.assert_array_equal(
                getattr(tq["layers"][name], part).numpy(),
                getattr(jq["layers"][name], part).numpy())
    np.testing.assert_array_equal(tq["lm_head"].values.numpy(),
                                  jq["lm_head"].values.numpy())


def test_decode_chunk_greedy_is_the_serial_chain():
    jp, tp = _params()
    jcfg, tcfg = _cfg()
    toks = _tokens(6, 64)
    jl, jc, tl, tc = _prefill_both(jp, tp, jcfg, tcfg, toks, 25)
    jt, jl2, jc2 = jllm.decode_chunk_greedy(jp, jcfg, jl, jc, 6)
    ct, cl, cc = tllm.decode_chunk_greedy(tp, tcfg, tl, tc, 6)
    assert ct.tolist() == np.asarray(jt).tolist()
    np.testing.assert_allclose(cl.numpy(), np.asarray(jl2), rtol=0, atol=ATOL)
    assert cc.length == 31
    _assert_cache_rows(jc2, cc, 31)
    # The serial chain, on a fresh port cache, gives the same tokens.
    _, _, sl, sc = _prefill_both(jp, tp, jcfg, tcfg, toks, 25)
    serial = []
    for _ in range(6):
        tok = int(torch.argmax(sl))
        serial.append(tok)
        sl, sc = tllm.decode_step(tp, tcfg, tok, sc)
    assert serial == ct.tolist()


def test_decode_chunk_greedy_suppresses_eos():
    jp, tp = _params()
    jcfg, tcfg = _cfg()
    toks = _tokens(7, 64)
    jl, jc, tl, tc = _prefill_both(jp, tp, jcfg, tcfg, toks, 25)
    eos = int(torch.argmax(tl))  # the first token the chain would emit
    jt, _, _ = jllm.decode_chunk_greedy(jp, jcfg, jl, jc, 4, eos_id=eos,
                                        suppress_until=jnp.int32(2))
    ct, _, _ = tllm.decode_chunk_greedy(tp, tcfg, tl, tc, 4, eos_id=eos,
                                        suppress_until=2)
    assert ct.tolist() == np.asarray(jt).tolist()
    assert ct.tolist()[0] != eos


def test_bridge_is_byte_for_byte():
    cfg = jllm.LLMConfig.tiny()
    p = jllm.init_params_quantized(jax.random.PRNGKey(1), cfg, bits=4,
                                   group=64)  # bf16 embeddings and norms
    t = params_from_jax(p)
    assert t["tok_emb"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        t["tok_emb"].view(torch.int16).numpy(),
        np.asarray(p["tok_emb"]).view(np.int16))
    for name in ("wqkv", "wo", "w_gu", "w_down"):
        tw, jw = t["layers"][name], p["layers"][name]
        assert isinstance(tw, QuantizedLinear)
        assert tw.values.dtype == torch.uint8
        np.testing.assert_array_equal(tw.values.numpy(), np.asarray(jw.values))
        np.testing.assert_array_equal(tw.scales.numpy(), np.asarray(jw.scales))


def test_config_fields_and_presets_match():
    assert tllm.LLMConfig._fields == jllm.LLMConfig._fields
    assert tllm.LLMConfig()._asdict() == jllm.LLMConfig()._asdict()
    for preset in ("mistral_7b", "tiny"):
        j = getattr(jllm.LLMConfig, preset)()
        assert getattr(tllm.LLMConfig, preset)() == tllm.LLMConfig(
            **j._asdict())


def test_init_params_quantized_matches_reference_layout():
    cfg = jllm.LLMConfig.tiny()
    jp = jllm.init_params_quantized(jax.random.PRNGKey(0), cfg, bits=4,
                                    group=64)
    tp = tllm.init_params_quantized(torch.Generator().manual_seed(0),
                                    tllm.LLMConfig.tiny(), bits=4, group=64)
    jl = jax.tree_util.tree_leaves_with_path(jp)
    shapes = {jax.tree_util.keystr(k): (tuple(v.shape), str(v.dtype))
              for k, v in jl}
    bridged = params_from_jax(jp)

    def flat(tree, prefix=""):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from flat(v, f"{prefix}[{k!r}]")
        elif isinstance(tree, QuantizedLinear):
            yield from flat(tree.values, prefix + ".values")
            yield from flat(tree.scales, prefix + ".scales")
        else:
            yield prefix, tree

    ours = {k: (tuple(v.shape), v.dtype) for k, v in flat(tp)}
    theirs = {k: (tuple(v.shape), v.dtype) for k, v in flat(bridged)}
    assert ours == theirs and len(ours) == len(shapes)


@pytest.mark.parametrize("knob", [
    {"qkv_bias": True}, {"attn_softcap": 50.0}, {"logit_softcap": 30.0},
    {"n_experts": 8}, {"window_pattern": 6}, {"alt_window": True},
    {"nope_pattern": 4}, {"attn_sinks": True}, {"norm_type": "layernorm"},
    {"partial_rotary_factor": 0.5}, {"act": "gelu"}, {"qk_norm": True},
    {"query_pre_attn_scalar": 256.0}, {"attn_chunk": 8192},
])
def test_other_family_knobs_raise(knob):
    cfg = tllm.LLMConfig.tiny()._replace(**knob)
    name = next(iter(knob))
    with pytest.raises(NotImplementedError, match=name):
        tllm.init_params(torch.Generator().manual_seed(0), cfg)
    _, tp = _params()
    with pytest.raises(NotImplementedError, match=name):
        tllm.prefill(tp, cfg, torch.zeros(64, dtype=torch.long), 1,
                     tllm.KVCache.create(tllm.LLMConfig.tiny(), torch.float32))


def test_rope_factors_raise():
    _, tp = _params()
    cfg = tllm.LLMConfig.tiny()
    with pytest.raises(NotImplementedError, match="rope_factors"):
        tllm.decode_step(dict(tp, rope_factors=torch.ones(32)), cfg, 1,
                         tllm.KVCache.create(cfg, torch.float32))


def test_window_is_off_when_it_covers_max_seq():
    """Mistral's 4096 window at max_seq 512 (the bench cut) is no window,
    as in the reference's _layer_window."""
    cfg = tllm.LLMConfig.mistral_7b()._replace(max_seq=512,
                                               sliding_window=512)
    jcfg = jllm.LLMConfig.mistral_7b()._replace(max_seq=512,
                                                sliding_window=512)
    assert tllm._layer_window(cfg) == jllm._layer_window(jcfg) == 0
    assert tllm._layer_window(cfg._replace(sliding_window=128)) == 128


def test_apply_rope_matches():
    rng = np.random.default_rng(9)
    x = rng.standard_normal((5, 4, 64)).astype(np.float32)
    pos = np.arange(7, 12)
    cfg, tcfg = _cfg()
    ref = np.asarray(jllm.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                                     jllm._rope_freqs(cfg)))
    got = tllm.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                          tllm._rope_freqs(tcfg)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)

