"""Prompt-lookup speculation in the port against the JAX package's.

``propose_ngram`` must equal the JAX function; ``extend(all_logits=True)``
must give the JAX logits at every chunk position within ATOL (1e-4, as
tests/test_torch_llm.py); greedy ``speculative=True`` and ``"auto"`` must
give the JAX runner's ids and ``spec_stats`` and the port's own plain ids
on LLMConfig.tiny() in f32 (Q4 at group 64, seed 3, bridged byte for
byte); ``speculative_generate`` and ``speculative_generate_draft`` must
emit plain greedy decode. ``spec_verify_sampled`` draws from a torch
generator, so it is held to the production sampler's distribution by total
variation distance (after tests/test_speculative.py).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from trackiellm_tpu.llm import runner as jrunner
from trackiellm_tpu.llm import sampling as jsampling
from trackiellm_tpu.llm import speculative as jspec
from trackiellm_tpu.llm.tokenizer import ByteTokenizer as JByteTokenizer
from trackiellm_tpu.models import llm as jllm
from trackiellm_tpu_torch.llm import runner as trunner
from trackiellm_tpu_torch.llm import sampling as tsampling
from trackiellm_tpu_torch.llm import speculative as tspec
from trackiellm_tpu_torch.llm.tokenizer import ByteTokenizer
from trackiellm_tpu_torch.models import llm as tllm
from trackiellm_tpu_torch.models.bridge import params_from_jax

ATOL = 1e-4
_PARAMS = {}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes: one intra-op thread, so this file does not crowd the
    other test workers' CPUs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _params(quantized=True):
    if quantized not in _PARAMS:
        cfg = jllm.LLMConfig.tiny()
        p = jllm.init_params(jax.random.PRNGKey(3), cfg, dtype=jnp.float32)
        if quantized:
            p = jllm.quantize_params(p, bits=4, group=64)
        _PARAMS[quantized] = (cfg, tllm.LLMConfig(**cfg._asdict()), p,
                              params_from_jax(p))
    return _PARAMS[quantized]


# --- propose_ngram ------------------------------------------------------------

@pytest.mark.parametrize("seed", range(6))
def test_propose_ngram_matches_jax(seed):
    """Seeded random histories over a small alphabet (so n-grams repeat),
    at every (max_propose, max_ngram, min_ngram) the runner uses."""
    rng = np.random.default_rng(seed)
    for _ in range(40):
        hist = rng.integers(0, 4 + seed, rng.integers(0, 40)).tolist()
        for k, hi, lo in ((7, 3, 1), (7, 8, 3), (3, 2, 2), (15, 5, 1)):
            assert tspec.propose_ngram(hist, k, hi, lo) == \
                jspec.propose_ngram(hist, k, hi, lo)


def test_spec_stats():
    s = tspec.SpecStats()
    s.proposed, s.accepted, s.passes = 10, 4, 2
    assert s.as_dict() == {"passes": 2, "plain_steps": 0, "proposed": 10,
                           "accepted": 4, "acceptance": 0.4}


# --- extend(all_logits=True) --------------------------------------------------

@pytest.mark.parametrize("quantized", [True, False])
@pytest.mark.parametrize("attn_len", [None, 256])
def test_extend_all_logits_matches_jax(quantized, attn_len):
    """A 16-row verify chunk (11 valid) after a 40-token prefill: logits at
    every row and the cache rows it wrote."""
    jcfg, tcfg, jp, tp = _params(quantized)
    toks = np.random.default_rng(0).integers(0, 256, 64).astype(np.int32)
    _, jc = jllm.prefill(jp, jcfg, jnp.asarray(toks), jnp.int32(40),
                         jllm.KVCache.create(jcfg, dtype=jnp.float32))
    _, tc = tllm.prefill(tp, tcfg, torch.from_numpy(toks.astype(np.int64)),
                         40, tllm.KVCache.create(tcfg, torch.float32, device="cpu"))
    chunk = np.random.default_rng(1).integers(0, 256, 16).astype(np.int32)
    jl, jc = jllm.extend(jp, jcfg, jnp.asarray(chunk), jnp.int32(11), jc,
                         attn_len=attn_len, all_logits=True)
    tl, tc = tllm.extend(tp, tcfg, torch.from_numpy(chunk.astype(np.int64)),
                         11, tc, attn_len=attn_len, all_logits=True)
    assert tl.shape == (16, tcfg.vocab_size) and tc.length == 51
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=ATOL)
    np.testing.assert_allclose(tc.k[:, :56].numpy(), np.asarray(jc.k)[:, :56],
                               rtol=0, atol=ATOL)
    # The last valid row is what extend returns without all_logits.
    tl1, _ = tllm.extend(tp, tcfg, torch.from_numpy(chunk.astype(np.int64)),
                         11, tc._replace(length=40), attn_len=attn_len)
    np.testing.assert_allclose(tl[10].numpy(), tl1.numpy(), rtol=0,
                               atol=1e-5)


# --- speculative_generate / _draft ------------------------------------------

PROMPTS = [
    [5, 9, 11, 5, 9, 11, 5, 9, 11, 5, 9],     # periodic: proposals fire
    [3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5],        # mostly plain
    [7, 7, 7, 7, 7, 7],                        # constant
]


def _prefill(tp, tcfg, prompt):
    padded = np.zeros((32,), np.int64)
    padded[:len(prompt)] = prompt
    logits, cache = tllm.prefill(tp, tcfg, torch.from_numpy(padded),
                                 len(prompt),
                                 tllm.KVCache.create(tcfg, torch.float32, device="cpu"))
    return int(torch.argmax(logits)), cache


def _plain_greedy(tp, tcfg, first, cache, n):
    toks, tok = [], first
    for _ in range(n):
        logits, cache = tllm.decode_step(tp, tcfg, tok, cache)
        tok = int(torch.argmax(logits))
        toks.append(tok)
    return toks, cache


@pytest.mark.parametrize("prompt", range(len(PROMPTS)))
def test_speculative_generate_matches_plain_decode(prompt):
    _, tcfg, _, tp = _params(False)
    prompt = PROMPTS[prompt]
    first, cache_a = _prefill(tp, tcfg, prompt)
    want, cache_a = _plain_greedy(tp, tcfg, first, cache_a, 24)
    _, cache_b = _prefill(tp, tcfg, prompt)
    got, cache_b, stats = tspec.speculative_generate(
        tp, tcfg, prompt, first, cache_b, 24)
    assert got == want, stats.as_dict()
    assert cache_b.length == cache_a.length
    # The cache continues like the plain loop's: the rejects were masked.
    more_a, _ = _plain_greedy(tp, tcfg, want[-1], cache_a, 4)
    more_b, _ = _plain_greedy(tp, tcfg, got[-1], cache_b, 4)
    assert more_b == more_a


def test_speculative_generate_matches_jax():
    """The same tokens and counters as the JAX function on the same
    weights, with proposals accepted."""
    jcfg, tcfg, jp, tp = _params(False)
    prompt = PROMPTS[0]
    first, cache = _prefill(tp, tcfg, prompt)
    got, _, stats = tspec.speculative_generate(tp, tcfg, prompt, first,
                                               cache, 48)
    padded = np.zeros((32,), np.int32)
    padded[:len(prompt)] = prompt
    jl, jc = jllm.prefill(jp, jcfg, jnp.asarray(padded),
                          jnp.int32(len(prompt)),
                          jllm.KVCache.create(jcfg, dtype=jnp.float32))
    assert int(jnp.argmax(jl)) == first
    want, _, jstats = jspec.speculative_generate(jp, jcfg, prompt, first,
                                                 jc, 48)
    assert got == want
    assert stats.as_dict() == jstats.as_dict()
    assert stats.accepted > 0 and stats.passes + stats.plain_steps < 48


@pytest.mark.parametrize("prompt", range(len(PROMPTS)))
def test_speculative_generate_draft_matches_plain_decode(prompt):
    """A draft of other weights (erratic acceptance) still gives the
    target's plain greedy tokens."""
    jcfg, tcfg, _, tp = _params(False)
    dcfg = tcfg._replace(n_layers=1)
    dp = params_from_jax(jllm.init_params(
        jax.random.PRNGKey(9), jcfg._replace(n_layers=1), dtype=jnp.float32))
    prompt = PROMPTS[prompt]
    first, cache_a = _prefill(tp, tcfg, prompt)
    want, cache_a = _plain_greedy(tp, tcfg, first, cache_a, 24)
    _, cache_b = _prefill(tp, tcfg, prompt)
    got, cache_b, stats = tspec.speculative_generate_draft(
        tp, tcfg, dp, dcfg, prompt, first, cache_b, 24)
    assert got == want, stats.as_dict()
    assert cache_b.length == cache_a.length


def test_self_draft_accepts_everything():
    _, tcfg, _, tp = _params(False)
    prompt = [5, 9, 11, 5, 9, 11, 5, 9]
    first, cache_a = _prefill(tp, tcfg, prompt)
    want, _ = _plain_greedy(tp, tcfg, first, cache_a, 24)
    _, cache = _prefill(tp, tcfg, prompt)
    got, _, stats = tspec.speculative_generate_draft(
        tp, tcfg, tp, tcfg, prompt, first, cache, 24, max_propose=7)
    assert got == want
    assert stats.acceptance == 1.0 and stats.passes == 3


# --- the runner ---------------------------------------------------------------

def _pair(**gen_kw):
    """A JAX runner and a port runner on the same Q4 weights and config."""
    jcfg, tcfg, jp, tp = _params(True)
    gen_kw.setdefault("temperature", 0.0)
    gen_kw.setdefault("max_tokens", 40)
    jr = jrunner.LLMRunner(jp, jcfg, JByteTokenizer(jcfg.vocab_size),
                           jrunner.GenerationConfig(**gen_kw),
                           cache_dtype=jnp.float32)
    tr = trunner.LLMRunner(tp, tcfg, ByteTokenizer(tcfg.vocab_size),
                           trunner.GenerationConfig(**gen_kw),
                           cache_dtype=torch.float32)
    return jr, tr


def _port(**gen_kw):
    _, tcfg, _, tp = _params(True)
    gen_kw.setdefault("temperature", 0.0)
    gen_kw.setdefault("max_tokens", 40)
    return trunner.LLMRunner(tp, tcfg, ByteTokenizer(tcfg.vocab_size),
                             trunner.GenerationConfig(**gen_kw),
                             cache_dtype=torch.float32)


SPEC_PROMPTS = ["abc abc abc abc ab", "the quick brown fox"]
# spec_min_ngram=1 lets the byte tokenizer's short repeats propose, so
# passes fire on random weights; the default (3..8) is covered too.
SPEC_KW = {"default": {}, "short_ngrams": {"spec_min_ngram": 1,
                                           "spec_probe_interval": 8}}


@pytest.mark.parametrize("kw", sorted(SPEC_KW))
@pytest.mark.parametrize("spec", [True, "auto"])
@pytest.mark.parametrize("prompt", SPEC_PROMPTS)
@pytest.mark.parametrize("lookahead", [1, 4])
def test_greedy_speculation_matches_jax_runner(lookahead, prompt, spec, kw):
    jr, tr = _pair(speculative=spec, lookahead=lookahead, **SPEC_KW[kw])
    out = tr.generate(prompt)
    assert out == jr.generate(prompt)
    assert tr._generated_ids == jr._generated_ids
    assert tr.spec_stats == jr.spec_stats
    assert tr._committed_ids == jr._committed_ids
    assert tr.cache.length == tr._host_len == int(jr.cache.length)
    plain = _port(speculative=False, lookahead=lookahead)
    assert plain.generate(prompt) == out
    assert plain._generated_ids == tr._generated_ids
    if spec is True and kw == "short_ngrams":
        assert tr.spec_stats["passes"] > 0


@pytest.mark.parametrize("max_tokens", [1, 3, 7, 20])
def test_speculation_at_the_budget_matches_plain(max_tokens):
    kw = dict(max_tokens=max_tokens, spec_min_ngram=1)
    a = _port(speculative=True, **kw)
    b = _port(speculative=False, **kw)
    assert a.generate("qq qq qq qq q") == b.generate("qq qq qq qq q")
    assert a._committed_ids == b._committed_ids


def test_speculation_stop_string_and_continuation():
    """A stop string inside a verify pass, then a tool response and more
    tokens: text and cache as the plain path's."""
    probe = _port(speculative=False, max_tokens=48)
    plain_text = probe.generate("abc abc abc abc ab")
    stop = plain_text[len(plain_text) // 2: len(plain_text) // 2 + 2]
    kw = dict(max_tokens=48, spec_min_ngram=1, stop_strings=(stop,) if stop
              else ())
    a = _port(speculative=True, **kw)
    b = _port(speculative=False, **kw)
    assert a.generate("abc abc abc abc ab") == b.generate("abc abc abc abc ab")
    assert a._committed_ids == b._committed_ids and not a._pending_spec
    a.add_tool_response("t", {"ok": 1})
    b.add_tool_response("t", {"ok": 1})
    assert [a.generate_next_token() for _ in range(6)] == \
        [b.generate_next_token() for _ in range(6)]


def test_external_stop_drops_pending_speculation():
    runners = []
    for spec in (True, False):
        r = _port(speculative=spec, spec_min_ngram=1, max_tokens=40)
        seen = []
        r.generate("abc abc abc abc ab", on_token=seen.append,
                   should_stop=lambda s=seen: len(s) >= 5)
        runners.append(r)
    a, b = runners
    assert a._generated_ids == b._generated_ids
    assert a._committed_ids == b._committed_ids
    assert a.cache.length == b.cache.length == a._host_len
    assert not a._pending_spec


def test_cooldown_engages_below_threshold():
    """With an unreachable acceptance threshold the "auto" gate trips once
    its window fills, bounding passes to the probe cadence; the JAX runner
    does the same passes."""
    kw = dict(speculative="auto", max_tokens=60, lookahead=4,
              spec_probe_interval=16, spec_min_ngram=1, spec_ngram=3,
              spec_min_acceptance=1.01)
    jr, tr = _pair(**kw)
    out = tr.generate("abc abc abc abc ab")
    assert out == jr.generate("abc abc abc abc ab")
    assert tr._n_emitted >= 30
    assert 4 <= tr.spec_stats["passes"] <= 14, tr.spec_stats
    assert tr.spec_stats == jr.spec_stats
    assert tr._spec_cooldown == jr._spec_cooldown >= 0


def test_dry_context_rides_the_chunk_path(monkeypatch):
    """No n-gram to look up: after two misses "auto" cools down onto the
    lookahead chunks, and with min_tokens = max_tokens it never arms."""
    chunks = []
    orig = tllm.decode_chunk_greedy
    monkeypatch.setattr(tllm, "decode_chunk_greedy",
                        lambda *a, **k: chunks.append(1) or orig(*a, **k))
    r = _port(speculative="auto", max_tokens=40, lookahead=4,
              spec_probe_interval=16)
    assert r.generate("the quick brown fox") == _port(
        speculative=False, max_tokens=40,
        lookahead=4).generate("the quick brown fox")
    assert r.spec_stats["passes"] <= 6 and chunks
    floor = _port(speculative="auto", max_tokens=16, min_tokens=16)
    chunks.clear()
    floor.generate("abc abc abc abc ab")
    assert floor.spec_stats["passes"] == 0 and len(chunks) >= 4


def test_ngram_granularity_defaults():
    assert (_port(speculative=True)._spec_min_ngram,
            _port(speculative=True)._spec_max_ngram) == (3, 8)
    r = _port(speculative=True, spec_min_ngram=2, spec_ngram=5)
    assert (r._spec_min_ngram, r._spec_max_ngram) == (2, 5)
    assert trunner.GenerationConfig().speculative == "auto"


def test_sampled_speculation_is_seeded_and_consistent():
    """temperature 0.7: passes fire on a repetitive context, two runs with
    one seed agree, and the cache continues."""
    outs = []
    for _ in range(2):
        r = _port(speculative=True, temperature=0.7, spec_min_ngram=1,
                  max_tokens=32, seed=5)
        outs.append(r.generate("abc abc abc abc ab"))
        assert r.spec_stats["passes"] > 0, r.spec_stats
        assert r._host_len == len(r._committed_ids) == r.cache.length
        assert not r._pending_spec
    assert outs[0] == outs[1]
    r.add_tool_response("t", {"ok": 1})
    assert all(m is None or isinstance(m, str)
               for m in (r.generate_next_token() for _ in range(4)))


# --- spec_verify_sampled ----------------------------------------------------

V, B, W, N = 48, 4, 8, 20000
VERIFY_KW = dict(top_k=16, top_p=0.9, min_p=0.05, repetition_penalty=1.0)


def _verdicts(seed=0, temp=0.8, likely=False, scale=2.0, kw=VERIFY_KW):
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((B, V)) * scale).astype(np.float32)
    if likely:  # each position's second most likely token
        proposal = np.argsort(logits, axis=-1)[:B - 1, -2]
    else:
        proposal = rng.integers(0, V, B - 1)
    gen = torch.Generator().manual_seed(seed + 1)
    t_logits = torch.from_numpy(logits)
    t_prop = torch.from_numpy(proposal.astype(np.int64))
    recent = torch.full((B, W), -1, dtype=torch.int64)
    out = np.array([tsampling.spec_verify_sampled(
        t_logits, t_prop, B - 1, gen, temp, recent, **kw).tolist()
        for _ in range(N)])
    return logits, proposal, out[:, 0], out[:, 1]


def _ref_probs(logits, pos, temp, kw=VERIFY_KW):
    lg = np.asarray(jsampling._process_chain(
        jnp.asarray(logits[pos]), jnp.float32(temp), kw["top_k"],
        kw["top_p"], kw["min_p"], None, None, kw["repetition_penalty"]),
        np.float64)
    p = np.exp(lg - lg.max())
    return p / p.sum()


def _tv(tokens, probs):
    emp = np.bincount(tokens, minlength=len(probs)) / len(tokens)
    return 0.5 * np.abs(emp - probs).sum()


def test_verify_first_token_marginal():
    logits, prop, n_acc, toks = _verdicts()
    first = np.where(n_acc >= 1, prop[0], toks)
    assert _tv(first, _ref_probs(logits, 0, 0.8)) < 0.05  # ~0.02 noise


def test_verify_second_token_conditional():
    kw = dict(top_k=32, top_p=0.98, min_p=0.0, repetition_penalty=1.0)
    logits, prop, n_acc, toks = _verdicts(seed=3, temp=1.2, likely=True,
                                          scale=1.0, kw=kw)
    sel = n_acc >= 1
    second = np.where(n_acc >= 2, prop[1], toks)[sel]
    assert len(second) > 1000
    assert _tv(second, _ref_probs(logits, 1, 1.2, kw)) < 0.08


def test_verify_rejection_and_low_temperature():
    logits, prop, n_acc, toks = _verdicts(seed=7)
    assert not np.any(toks[n_acc == 0] == prop[0])
    logits, prop, n_acc, toks = _verdicts(seed=5, temp=0.01)
    first = np.where(n_acc >= 1, prop[0], toks)
    assert (first == int(np.argmax(logits[0]))).mean() > 0.999


def test_verify_is_one_stacked_int32_pair():
    logits = torch.randn((16, 64), generator=torch.Generator().manual_seed(0))
    out = tsampling.spec_verify_sampled(
        logits, torch.zeros(15, dtype=torch.int64), 3,
        torch.Generator().manual_seed(1), 0.7,
        torch.full((16, 8), -1, dtype=torch.int64))
    assert out.shape == (2,) and out.dtype == torch.int32
    assert 0 <= int(out[0]) <= 3 and 0 <= int(out[1]) < 64
