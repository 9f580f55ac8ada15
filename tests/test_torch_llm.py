"""Parity of trackiellm_tpu_torch.models.llm with trackiellm_tpu.models.llm.

LLMConfig.tiny() in f32 with Q4 (or Q8) weights at group 64 (group 256 does
not divide tiny's K/2 = 128). The JAX params go through ``params_from_jax``, so
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


def _params(quantized=True, bits=4):
    """JAX params and their bridged port (built once per module)."""
    key = (quantized, bits)
    if key not in _PARAMS:
        cfg, _ = _cfg()
        p = jllm.init_params(jax.random.PRNGKey(3), cfg, dtype=jnp.float32)
        if quantized:
            p = jllm.quantize_params(p, bits=bits, group=64)
        _PARAMS[key] = (p, params_from_jax(p))
    return _PARAMS[key]


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
                          length, tllm.KVCache.create(tcfg, torch.float32, device="cpu"))
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


@pytest.mark.parametrize("window", [0, 24])
def test_q8_model_matches(window):
    """A Q8 model (``quantize_params(bits=8, group=64)``) bridges byte for
    byte, and its prefill, extend and decode_step logits match."""
    jp, tp = _params(bits=8)
    for name in ("wqkv", "wo", "w_gu", "w_down"):
        tw, jw = tp["layers"][name], jp["layers"][name]
        assert tw.values.dtype == torch.int8
        np.testing.assert_array_equal(tw.values.numpy(), np.asarray(jw.values))
        np.testing.assert_array_equal(tw.scales.numpy(), np.asarray(jw.scales))
    assert tp["lm_head"].values.dtype == torch.int8
    jcfg, tcfg = _cfg(window)
    jl, jc, tl, tc = _prefill_both(jp, tp, jcfg, tcfg, _tokens(8, 64), 33)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=ATOL)
    chunk = _tokens(9, 16)
    jl, jc = jllm.extend(jp, jcfg, jnp.asarray(chunk), jnp.int32(9), jc)
    tl, tc = tllm.extend(tp, tcfg, torch.from_numpy(chunk.astype(np.int64)),
                         9, tc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=ATOL)
    for tok in (3, 301):
        jl, jc = jllm.decode_step(jp, jcfg, jnp.int32(tok), jc)
        tl, tc = tllm.decode_step(tp, tcfg, tok, tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                                   atol=ATOL)
    assert tc.length == int(jc.length) == 33 + 9 + 2
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


@pytest.mark.parametrize("attn_len", [None, 64])
def test_generate_greedy_matches(attn_len):
    """The JAX package's ``generate_greedy`` (one jit, a scan) and the
    port's device loop emit the same ids from the same first token, and
    both are the serial decode_step chain."""
    jp, tp = _params()
    jcfg, tcfg = _cfg()
    toks = _tokens(10, 64)
    jl, jc, tl, tc = _prefill_both(jp, tp, jcfg, tcfg, toks, 30)
    first = int(np.argmax(np.asarray(jl)))
    assert first == int(torch.argmax(tl))
    jt, jc2 = jllm.generate_greedy(jp, jcfg, jnp.int32(first), jc,
                                   n_tokens=6, attn_len=attn_len)
    ct, cc = tllm.generate_greedy(tp, tcfg, torch.tensor(first), tc, 6,
                                  attn_len=attn_len)
    assert ct.tolist() == np.asarray(jt).tolist()
    assert cc.length == int(jc2.length) == 36
    _assert_cache_rows(jc2, cc, 36)
    # The serial chain, on a fresh port cache and a host-int first token.
    _, _, _, sc = _prefill_both(jp, tp, jcfg, tcfg, toks, 30)
    serial, tok = [], first
    for _ in range(6):
        sl, sc = tllm.decode_step(tp, tcfg, tok, sc, attn_len=attn_len)
        tok = int(torch.argmax(sl))
        serial.append(tok)
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



# ---------------------------------------------------------------------------
# Batched serving functions (prefill_batch, BatchedKVCache, insert_sequence,
# decode_step_batch, decode_steps_batch) against the JAX package's
# ---------------------------------------------------------------------------

def _batched_both(jp, tp, jcfg, tcfg, seqs, n_slots):
    """JAX and port batched caches with ``seqs`` ({slot: (tokens, length)})
    prefilled and inserted; the other slots stay empty (length 0)."""
    jb = jllm.BatchedKVCache.create(jcfg, n_slots, dtype=jnp.float32)
    tb = tllm.BatchedKVCache.create(tcfg, n_slots, dtype=torch.float32, device="cpu")
    for slot, (toks, length) in seqs.items():
        _, jc, _, tc = _prefill_both(jp, tp, jcfg, tcfg, toks, length)
        jb = jllm.insert_sequence(jb, jcfg, slot, jc)
        tb = tllm.insert_sequence(tb, tcfg, slot, tc)
    return jb, tb


def _assert_batched_caches(jb, tb):
    np.testing.assert_allclose(tb.k.numpy(), np.asarray(jb.k), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(tb.v.numpy(), np.asarray(jb.v), rtol=0,
                               atol=ATOL)
    assert tb.lengths.tolist() == np.asarray(jb.lengths).tolist()
    assert tb.lengths.dtype == torch.int32


@pytest.mark.parametrize("quantized", [True, False])
@pytest.mark.parametrize("window", [0, 24])
@pytest.mark.parametrize("bucket,lengths", [(64, (40, 7, 0, 0)),
                                            (256, (200, 130))])
def test_prefill_batch_matches(bucket, lengths, window, quantized):
    """A wave's logits at each row's last token and its per-row caches,
    length-0 dummy rows included, match the JAX package's prefill_batch,
    and each real row's logits match a lone prefill of it."""
    jp, tp = _params(quantized)
    jcfg, tcfg = _cfg(window)
    toks = np.stack([_tokens(bucket + i, bucket) for i in range(len(lengths))])
    lens = np.asarray(lengths, np.int32)
    jl, jc = jllm.prefill_batch(jp, jcfg, jnp.asarray(toks),
                                jnp.asarray(lens), cache_dtype=jnp.float32)
    tl, tc = tllm.prefill_batch(tp, tcfg, torch.from_numpy(toks),
                                torch.from_numpy(lens),
                                cache_dtype=torch.float32)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=ATOL)
    assert tc.k.shape == (len(lengths), tcfg.n_layers, tcfg.max_seq,
                          tcfg.n_kv_heads, tcfg.head_dim)
    np.testing.assert_allclose(tc.k[:, :, :bucket].numpy(),
                               np.asarray(jc.k)[:, :, :bucket], rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(tc.v[:, :, :bucket].numpy(),
                               np.asarray(jc.v)[:, :, :bucket], rtol=0,
                               atol=ATOL)
    assert not tc.k[:, :, bucket:].any()
    assert tc.length.tolist() == list(lengths)
    row = 0
    _, _, lone, _ = _prefill_both(jp, tp, jcfg, tcfg, toks[row], lengths[row])
    np.testing.assert_allclose(tl[row].numpy(), lone.numpy(), rtol=0,
                               atol=ATOL)


@pytest.mark.parametrize("quantized", [True, False])
@pytest.mark.parametrize("window,attn_len", [(0, None), (0, 128),
                                             (24, None)])
def test_decode_step_batch_matches(quantized, window, attn_len):
    """Three slots, the middle one inactive: logits of the active slots,
    every cache row and the lengths match the JAX package's
    decode_step_batch at every step, and the inactive slot's rows are
    untouched."""
    jp, tp = _params(quantized)
    jcfg, tcfg = _cfg(window)
    jb, tb = _batched_both(jp, tp, jcfg, tcfg,
                           {0: (_tokens(20, 64), 40),
                            1: (_tokens(21, 64), 9),
                            2: (_tokens(22, 64), 30)}, 3)
    _assert_batched_caches(jb, tb)
    active = np.array([True, False, True])
    idle_k = tb.k[:, 1].clone()
    for step, toks in enumerate(([5, 7, 300], [17, 0, 2], [400, 1, 63])):
        toks = np.asarray(toks, np.int32)
        jl, jb = jllm.decode_step_batch(jp, jcfg, jnp.asarray(toks),
                                        jnp.asarray(active), jb,
                                        attn_len=attn_len)
        tl, tb = tllm.decode_step_batch(tp, tcfg, torch.from_numpy(toks),
                                        torch.from_numpy(active), tb,
                                        attn_len=attn_len)
        np.testing.assert_allclose(tl.numpy()[active],
                                   np.asarray(jl)[active], rtol=0, atol=ATOL,
                                   err_msg=f"step {step}")
        _assert_batched_caches(jb, tb)
    assert tb.lengths.tolist() == [43, 9, 33]
    assert torch.equal(tb.k[:, 1], idle_k)


@pytest.mark.parametrize("quantized", [True, False])
def test_decode_steps_batch_ids_match(quantized):
    """k greedy steps with the argmax fed back on the device: exactly the
    JAX package's ids and lengths, and the port's own step-by-step loop."""
    jp, tp = _params(quantized)
    jcfg, tcfg = _cfg()
    seqs = {0: (_tokens(30, 64), 25), 1: (_tokens(31, 64), 11)}
    jb, tb = _batched_both(jp, tp, jcfg, tcfg, seqs, 2)
    toks = np.asarray([9, 11], np.int32)
    active = np.array([True, True])
    jprod, jb2 = jllm.decode_steps_batch(jp, jcfg, jnp.asarray(toks),
                                         jnp.asarray(active), jb, 6)
    tprod, tb2 = tllm.decode_steps_batch(tp, tcfg, torch.from_numpy(toks),
                                         torch.from_numpy(active), tb, 6)
    assert tprod.tolist() == np.asarray(jprod).tolist()
    _assert_batched_caches(jb2, tb2)
    _, loop = _batched_both(jp, tp, jcfg, tcfg, seqs, 2)
    cur, ids = torch.from_numpy(toks), []
    for _ in range(6):
        logits, loop = tllm.decode_step_batch(tp, tcfg, cur,
                                              torch.from_numpy(active), loop)
        cur = logits.argmax(-1)
        ids.append(cur.tolist())
    assert ids == tprod.tolist()
