"""The port's continuous-batching LLMServer against the JAX package's.

Same weights (LLMConfig.tiny(), f32, Q4 at group 64, bridged byte for
byte), same prompts, same knobs: greedy text must be byte-identical to the
JAX LLMServer's in every mode (dense and paged, per-step and pipelined
chunks, bursts, EOS mid-chunk, the prefix cache, chunked prefill, the int8
pool, grammar-constrained requests, stop strings). The behaviour tests
mirror tests/test_server.py: OOM preemption, rejections, cancel, close,
the death path, paged="auto", the sampled path's seed and repetition
penalty. Sampled ids cannot equal the JAX server's (another RNG). Every
future has a timeout and every server closes in a ``finally``.
"""

import json
import threading
import time

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from trackiellm_tpu.llm.server import LLMServer as JServer
from trackiellm_tpu.llm.tokenizer import ByteTokenizer as JTokenizer
from trackiellm_tpu.models import llm as jllm
from trackiellm_tpu_torch.llm.server import LLMServer
from trackiellm_tpu_torch.llm.tokenizer import ByteTokenizer
from trackiellm_tpu_torch.models import llm as tllm
from trackiellm_tpu_torch.models.bridge import params_from_jax
from trackiellm_tpu_torch.utils.errors import TrackieError

JCFG = jllm.LLMConfig.tiny()
CFG = tllm.LLMConfig(**JCFG._asdict())
TIMEOUT = 120
_PARAMS = {}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes: one intra-op thread, so this file does not crowd the
    other test workers' CPUs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _params():
    if not _PARAMS:
        p = jllm.quantize_params(
            jllm.init_params(jax.random.PRNGKey(3), JCFG, dtype=jnp.float32),
            bits=4, group=64)
        _PARAMS["p"] = (p, params_from_jax(p))
    return _PARAMS["p"]


def _server(eos_id=None, int8=False, **kw):
    _, tp = _params()
    tok = ByteTokenizer(CFG.vocab_size)
    if eos_id is not None:
        tok.eos_id = eos_id
    kw.setdefault("batch_slots", 2)
    server = LLMServer(tp, CFG, tokenizer=tok,
                       cache_dtype=torch.int8 if int8 else torch.float32,
                       **kw)
    if int8:
        server.pool.compute_dtype = torch.float32
    return server


def _jax_server(eos_id=None, int8=False, **kw):
    jp, _ = _params()
    tok = JTokenizer(JCFG.vocab_size)
    if eos_id is not None:
        tok.eos_id = eos_id
    kw.setdefault("batch_slots", 2)
    server = JServer(jp, JCFG, tokenizer=tok,
                     cache_dtype=jnp.int8 if int8 else jnp.float32, **kw)
    if int8:
        server.pool.compute_dtype = jnp.float32
    return server


def _run(server, jobs, burst=True):
    """Texts of ``jobs`` ((prompt, submit kwargs) pairs): submitted at
    once, or one after another; the server is closed after."""
    try:
        if burst:
            futs = [server.submit(p, **kw) for p, kw in jobs]
            return [f.result(timeout=TIMEOUT) for f in futs]
        return [server.submit(p, **kw).result(timeout=TIMEOUT)
                for p, kw in jobs]
    finally:
        server.close()


def _both(jobs, burst=True, **kw):
    """(JAX texts, port texts) of the same jobs on servers built alike."""
    return (_run(_jax_server(**kw), jobs, burst),
            _run(_server(**kw), jobs, burst))


def _jobs(prompts, max_tokens, **kw):
    return [(p, dict(max_tokens=m, **kw)) for p, m in zip(prompts, max_tokens)]


MIXED = _jobs(["ola", "tudo bem", "descreva a cena a sua frente",
               "outra pergunta longa " * 6, "x"], [5, 9, 37, 19, 29])
PAGED = dict(paged=True, page_size=16)


# -- greedy text, byte for byte ----------------------------------------------

@pytest.mark.parametrize("chunk_steps", [1, 8])
@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_greedy_text_matches_the_jax_server(layout, chunk_steps):
    """A burst of five requests on two slots (waves, backlog, chunk tails
    below and above the chunk size)."""
    kw = dict(PAGED) if layout == "paged" else {}
    want, got = _both(MIXED, chunk_steps=chunk_steps, **kw)
    assert got == want
    assert any(got)


def test_burst_admission_matches_serial():
    """Twice as many requests as slots at once (prefill_batch waves,
    chunks while the backlog is waiting) give the texts of one-at-a-time
    serving on the per-step path, and the JAX server's."""
    jobs = _jobs([f"pergunta {i} sobre a cena" for i in range(6)], [9] * 6)
    serial = _run(_server(batch_slots=1, chunk_steps=1), jobs, burst=False)
    burst = _server(batch_slots=3, chunk_steps=4)
    got = _run(burst, jobs)
    assert burst.stats["decode_steps"] >= 4
    want = _run(_jax_server(batch_slots=3, chunk_steps=4), jobs)
    assert got == serial == want


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_pipelined_eos_mid_chunk_matches(layout):
    """EOS inside a pipelined chunk while the next is in flight: the
    finished slot's in-flight rows are dropped, the other slot's kept. The
    EOS id is the first token of prompt 0's own greedy chain, from its
    sixth on, that the chain has not emitted before: it ends the request
    inside a chunk after the first, with the next one in flight."""
    jp, tp = _params()
    tok = ByteTokenizer(CFG.vocab_size)
    prompts = ["fala comigo", "conta uma historia"]
    ids = tok.encode(prompts[0], add_bos=True)
    padded = np.zeros(64, np.int64)
    padded[:len(ids)] = ids
    logits, cache = tllm.prefill(tp, CFG, torch.from_numpy(padded), len(ids),
                                 tllm.KVCache.create(CFG, torch.float32, device="cpu"))
    chain = []
    for _ in range(24):
        chain.append(int(torch.argmax(logits)))
        logits, cache = tllm.decode_step(tp, CFG, chain[-1], cache)
    at = next(j for j in range(5, 24) if chain[j] not in chain[:j])
    eos = chain[at]
    kw = dict(PAGED) if layout == "paged" else {}
    jobs = _jobs(prompts, [30, 30])
    single = _run(_server(eos_id=eos, chunk_steps=1, **kw), jobs, burst=False)
    assert single[0] == tok.decode(chain[:at])
    want, got = _both(jobs, eos_id=eos, chunk_steps=4, **kw)
    assert got == want == single


def test_pipeline_offset_stays_constant():
    """Exactly one chunk in flight at every check: the speculative budget
    offset is always k, never 2k."""
    server = _server(batch_slots=1, chunk_steps=4)
    seen = []
    orig = server._can_chunk
    server._can_chunk = lambda offset=0: (
        seen.append(offset) or orig(offset=offset))
    _run(server, _jobs(["historia longa"], [41]))
    spec = [o for o in seen if o > 0]
    assert spec and max(spec) == 4 and len(spec) >= 8


def test_prefix_cache_matches():
    """Prompts sharing a 36-token prefix through the prefix cache (16-token
    pages): the JAX server's texts and prefix stats, and the uncached
    server's texts."""
    base = "sistema: voce ajuda pessoas cegas. "
    jobs = _jobs([base + "primeiro", base + "segundo caminho la",
                  base + "primeiro"], [6] * 3)
    kw = dict(batch_slots=1, n_pages=33, **PAGED)
    plain = _run(_server(prefix_cache=False, **kw), jobs, burst=False)
    jserver, server = _jax_server(**kw), _server(**kw)
    want = _run(jserver, jobs, burst=False)
    got = _run(server, jobs, burst=False)
    assert got == want == plain
    assert server.pool.prefix_stats == jserver.pool.prefix_stats
    assert server.pool.prefix_stats["hits"] >= 2


def test_prefix_cache_concurrent_same_prompt():
    """A burst of one prompt: the first registers its pages, the later
    ones share them; all texts agree with the JAX server's and the pool
    drains back to fully allocatable."""
    server = _server(n_pages=33, **PAGED)
    jobs = _jobs(["a" * 40] * 4, [5] * 4)
    got = _run(server, jobs)
    want = _run(_jax_server(n_pages=33, **PAGED), jobs)
    assert got == want and len(set(got)) == 1
    assert server.pool.free_pages == 32


@pytest.mark.parametrize("mode", ["dense", "paged", "paged_prefix"])
def test_chunked_prefill_matches(mode):
    """Long prompts admitted one 64-token extend chunk a serve iteration
    (prefill_chunk=64), among short ones: the JAX server's texts, and the
    whole-prompt server's."""
    if mode == "dense":
        kw = {}
        prompts = ["p" * 90 + " primeira pergunta longa", "curta",
                   "q" * 70 + " segunda longa"]
    else:
        kw = dict(n_pages=65, prefix_cache=mode == "paged_prefix", **PAGED)
        prompts = ["s" * 80 + " rota um", "curta",
                   "s" * 80 + " rota dois bem diferente"]
    jobs = _jobs(prompts, [6] * 3)
    whole = _run(_server(**kw), jobs, burst=False)
    server = _server(prefill_chunk=64, **kw)
    got = _run(server, jobs, burst=mode != "paged_prefix")
    want = _run(_jax_server(prefill_chunk=64, **kw), jobs,
                burst=mode != "paged_prefix")
    assert got == want == whole
    assert server.stats.get("prefill_chunks", 0) >= 2
    if mode == "paged_prefix":
        assert server.pool.prefix_stats["hits"] >= 1


@pytest.mark.parametrize("chunk_steps", [1, 4])
def test_int8_pool_matches(chunk_steps):
    """cache_dtype=int8 forces the paged pool with int8 cells (compute in
    f32): the JAX server's texts, and every page back after."""
    kw = dict(int8=True, page_size=32, n_pages=33, chunk_steps=chunk_steps)
    jobs = _jobs([f"pergunta {i}" for i in range(3)], [12, 5, 9])
    server = _server(**kw)
    assert server.paged and server.pool.quantized
    got = _run(server, jobs)
    want = _run(_jax_server(**kw), jobs)
    assert got == want
    assert server.pool.free_pages == 32


def test_grammar_requests_match():
    """A tool call (typed by a schema), a response_schema reply and a
    json_mode reply beside a plain greedy request: the JAX server's JSON,
    byte for byte, each parsing as its grammar says."""
    schema = {"type": "object", "required": ["direction"],
              "properties": {"direction": {"enum": ["left", "right"]}}}
    jobs = [("Navegue ate a porta",
             dict(max_tokens=60, tool_names=["navigate", "describe"],
                  tool_schemas={"navigate": schema})),
            ("ola", dict(max_tokens=8)),
            ("Responda", dict(max_tokens=40, response_schema=schema)),
            ("va", dict(max_tokens=7, tool_names=["navigate"])),
            ("json", dict(max_tokens=20, json_mode=True))]
    want, got = _both(jobs, chunk_steps=4)
    assert got == want
    call = json.loads(got[0])["tool_call"]
    assert call["name"] in ("navigate", "describe")
    assert isinstance(call["arguments"], dict)
    assert json.loads(got[2])["direction"] in ("left", "right")
    assert "tool_call" in json.loads(got[3])  # the budget's closure
    assert isinstance(json.loads(got[4]), dict)


def test_stop_strings_match():
    """Stop strings cut the text before the first match; streamed pieces
    concatenate to the cut text and never hold a stop; the JAX server
    agrees, with a stop that never occurs and with two stops."""
    server = _server(chunk_steps=4)
    try:
        full = server.generate("ola", max_tokens=48)
        assert len(full) > 15
        stop, late = full[6:9], full[12:15]
        pieces = []
        fut = server.submit("ola", max_tokens=48, stop=[stop],
                            on_token=pieces.append)
        cut = fut.result(timeout=TIMEOUT)
        assert cut == full[: full.find(stop)] == "".join(pieces)
        assert all(stop not in p for p in pieces)
    finally:
        server.close()
    jobs = [("ola", dict(max_tokens=48, stop=[stop])),
            ("ola", dict(max_tokens=48, stop=["ZQX_NEVER"])),
            ("ola", dict(max_tokens=48, stop=[late, stop]))]
    want, got = _both(jobs, chunk_steps=4)
    assert got == want == [cut, full, cut]


def test_dense_chunk_attn_lever_keeps_the_text(monkeypatch):
    """TRACKIE_DENSE_CHUNK_ATTN=1 bounds dense chunks' KV reads by a
    power-of-two bucket: the texts stay the JAX server's under the same
    lever (both read it at each chunk)."""
    monkeypatch.setenv("TRACKIE_DENSE_CHUNK_ATTN", "1")
    want, got = _both(MIXED, chunk_steps=8)
    assert got == want


# -- behaviour ----------------------------------------------------------------

@pytest.mark.parametrize("chunk_steps", [1, 4])
def test_on_token_streams_full_text(chunk_steps):
    """Streamed pieces concatenate to the future's text; a raising
    callback is dropped without failing the request or the loop."""
    server = _server(chunk_steps=chunk_steps)
    try:
        pieces = []
        fut = server.submit("descreva a cena", max_tokens=13,
                            on_token=pieces.append)
        text = fut.result(timeout=TIMEOUT)
        assert "".join(pieces) == text

        def boom(_):
            raise RuntimeError("client bug")
        assert isinstance(server.submit("outra", max_tokens=7,
                                        on_token=boom).result(TIMEOUT), str)
    finally:
        server.close()


def test_oversized_max_tokens_fails_the_request_not_the_server():
    server = _server()
    try:
        bad = server.submit("ola", max_tokens=CFG.max_seq - 1)
        with pytest.raises(TrackieError):
            bad.result(timeout=TIMEOUT)
        assert server.generate("tudo bem", max_tokens=5, timeout=TIMEOUT)
    finally:
        server.close()


def test_close_fails_fast():
    server = _server(batch_slots=1)
    server.close()
    with pytest.raises(RuntimeError):
        server.submit("x")


def test_mid_admission_failure_fails_all_futures():
    """The loop dying inside admission (requests popped, not yet in a
    slot) fails every submitted future at once, and submit fails fast
    after."""
    class Boom:
        def __getattr__(self, name):
            return getattr(tllm, name)

        @staticmethod
        def prefill(*a, **k):
            raise RuntimeError("boom")

        prefill_batch = prefill

    server = _server(batch_slots=4)
    server._m = Boom()
    try:
        t0 = time.monotonic()
        futs = []
        for p in ("a", "bb", "ccc"):
            try:
                futs.append(server.submit(p, max_tokens=4))
            except RuntimeError:
                pass  # the loop already died: the fail-fast contract
        assert futs
        for f in futs:
            with pytest.raises(RuntimeError, match="boom"):
                f.result(timeout=10)
        assert time.monotonic() - t0 < 5.0
        with pytest.raises(RuntimeError):
            server.submit("late")
    finally:
        server.close()


def test_oom_preempts_a_slot_not_the_loop():
    """Two one-page prompts in a pool of 3 usable pages: the second slot's
    growth hits OOM, is preempted, and completes after the first."""
    server = _server(paged=True, page_size=32, n_pages=4)
    try:
        f1 = server.submit("a" * 31, max_tokens=8)
        f2 = server.submit("b" * 31, max_tokens=8)
        assert isinstance(f1.result(timeout=TIMEOUT), str)
        assert isinstance(f2.result(timeout=TIMEOUT), str)
        assert server._thread.is_alive() and server._fatal is None
        assert server.pool.free_pages == server.pool.n_pages - 1
    finally:
        server.close()


def test_never_fitting_prompt_is_rejected():
    server = _server(batch_slots=1, paged=True, page_size=32, n_pages=3)
    try:
        with pytest.raises(TrackieError):
            server.submit("x" * 200, max_tokens=4).result(timeout=TIMEOUT)
        assert isinstance(server.generate("hi", max_tokens=4,
                                          timeout=TIMEOUT), str)
    finally:
        server.close()


def test_paged_chunk_falls_back_when_the_pool_is_tight():
    server = _server(paged=True, page_size=8, n_pages=6, chunk_steps=4)
    try:
        futs = [server.submit(f"p{i}", max_tokens=10) for i in range(3)]
        assert all(isinstance(f.result(timeout=TIMEOUT), str) for f in futs)
    finally:
        server.close()


def test_cancel_frees_the_slot_midstream():
    server = _server(batch_slots=1, chunk_steps=1)
    try:
        started = threading.Event()
        long_fut = server.submit("historia muito longa", max_tokens=200,
                                 on_token=lambda p: started.set())
        assert started.wait(timeout=TIMEOUT)
        queued = server.submit("nunca admitida", max_tokens=50)
        queued.cancel()
        long_fut.cancel()
        assert isinstance(server.generate("curta", max_tokens=5,
                                          timeout=TIMEOUT), str)
        assert server.stats["completed"] >= 2
    finally:
        server.close()


def test_decode_progresses_between_job_chunks():
    """An active request keeps decoding while a long prompt admits through
    the chunked-prefill job (16-token chunks): decode steps run between
    the job's chunks, not only after it."""
    server = _server(n_pages=65, prefill_chunk=16, chunk_steps=1, **PAGED)
    steps_at_chunk = []
    advance = server._advance_prefill

    def watched():
        steps_at_chunk.append(server.stats["decode_steps"])
        advance()
    server._advance_prefill = watched
    try:
        first = server.submit("fluxo ativo", max_tokens=48)
        deadline = time.monotonic() + TIMEOUT
        while (not server.stats["decode_steps"]
               and time.monotonic() < deadline):
            time.sleep(0.005)
        server.submit("z" * 220, max_tokens=2).result(timeout=TIMEOUT)
        first.result(timeout=TIMEOUT)
    finally:
        server.close()
    assert len(steps_at_chunk) >= 10
    # One decode step between consecutive chunks while the first request
    # is active.
    assert steps_at_chunk[-1] - steps_at_chunk[0] >= len(steps_at_chunk) - 1


def test_memory_modes():
    """paged="auto" is dense when the slot caches fit the budget, paged
    under a tight one; int8 needs paged; model= and mesh= wait for their
    queue items."""
    dense = _server()
    try:
        assert dense.paged is False and dense.cache is not None
        assert dense.cache.k.device == dense._device
    finally:
        dense.close()
    tight = _server(kv_memory_budget_bytes=1024)
    try:
        assert tight.paged is True and tight.pool is not None
        assert isinstance(tight.generate("ola", max_tokens=4,
                                         timeout=TIMEOUT), str)
    finally:
        tight.close()
    with pytest.raises(TrackieError):
        _server(int8=True, paged=False)
    _, tp = _params()
    with pytest.raises(NotImplementedError, match="item 11"):
        LLMServer(tp, CFG, model=object())
    with pytest.raises(NotImplementedError, match="item 12"):
        LLMServer(tp, CFG, mesh=object())


def test_sampled_path_is_seeded_and_penalized():
    """Sampled requests: the same seed gives the same ids; a 5x
    repetition penalty at near-greedy temperature keeps any token to at
    most 3 of 12, and the penalty changes the ids."""
    def sampled(seed, penalty, chunk_steps=4):
        server = _server(batch_slots=1, seed=seed, chunk_steps=chunk_steps)
        try:
            server.submit("aaaa", max_tokens=12, temperature=0.01,
                          repetition_penalty=penalty).result(TIMEOUT)
            return list(server._slots[0].generated)
        finally:
            server.close()
    first = sampled(3, 5.0)
    assert first == sampled(3, 5.0, chunk_steps=1)
    assert len(first) == 12
    assert max(first.count(t) for t in set(first)) <= 3
    assert sampled(3, 1.0) != first
