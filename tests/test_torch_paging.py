"""Parity of trackiellm_tpu_torch.llm.paging with trackiellm_tpu.llm.paging.

The page pool's host logic (free list, trash page 0, tables, the prefix
cache's hash chain with refcounts and LRU eviction) is held to the JAX
package's pool step by step; the device functions (paged decode, one step
and k steps, the prefill scatter, the prefix gather, the int8 cells) to
the JAX functions on the same bridged weights (LLMConfig.tiny() at
max_seq 128, f32, Q4 at group 64 or dense): logits at 1e-4 abs, ids, int8
values and f32 scales exactly.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from trackiellm_tpu.llm import paging as jpaging
from trackiellm_tpu.models import llm as jllm
from trackiellm_tpu.ops import attention as jattention
from trackiellm_tpu_torch.llm import paging as tpaging
from trackiellm_tpu_torch.models import llm as tllm
from trackiellm_tpu_torch.models.bridge import params_from_jax
from trackiellm_tpu_torch.ops import attention as tattention
from trackiellm_tpu_torch.utils.errors import TrackieError

ATOL = 1e-4
JCFG = jllm.LLMConfig.tiny()._replace(max_seq=128, sliding_window=128)
TCFG = tllm.LLMConfig(**JCFG._asdict())
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
        p = jllm.init_params(jax.random.PRNGKey(3), JCFG, dtype=jnp.float32)
        if quantized:
            p = jllm.quantize_params(p, bits=4, group=64)
        _PARAMS[quantized] = (p, params_from_jax(p))
    return _PARAMS[quantized]


def _tokens(seed, n):
    return np.random.default_rng(seed).integers(0, 256, n).astype(np.int32)


def _pools(n_pages=16, page_size=16, int8=False):
    """A JAX pool and a port pool of the same shape (f32, or int8 cells
    computing in f32)."""
    if int8:
        return (jpaging.PagedKVPool(JCFG, n_pages, page_size, jnp.int8,
                                    compute_dtype=jnp.float32),
                tpaging.PagedKVPool(TCFG, n_pages, page_size, torch.int8,
                                    compute_dtype=torch.float32, device="cpu"))
    return (jpaging.PagedKVPool(JCFG, n_pages, page_size, jnp.float32),
            tpaging.PagedKVPool(TCFG, n_pages, page_size, torch.float32,
                                device="cpu"))


def _prefilled(jp, tp, toks, length):
    """(JAX logits, JAX cache, port logits, port cache) of one prefill."""
    jl, jc = jllm.prefill(jp, JCFG, jnp.asarray(toks), jnp.int32(length),
                          jllm.KVCache.create(JCFG, dtype=jnp.float32))
    tl, tc = tllm.prefill(tp, TCFG, torch.from_numpy(toks.astype(np.int64)),
                          length,
                          tllm.KVCache.create(TCFG, torch.float32, device="cpu"))
    return jl, jc, tl, tc


def _pool_arrays(pool):
    if isinstance(pool, (jpaging.QuantPool, tpaging.QuantPool)):
        return [np.asarray(pool.vals), np.asarray(pool.scale)]
    return [np.asarray(pool)]


def _assert_pools(jpool, tpool):
    """The pools' cells: floats at ATOL; int8 values within one step, at
    no more than one cell in 10,000: the K/V they quantize differ in the
    last bits of an f32 sum, which moves a value sitting on a rounding
    boundary (``_quant_cells`` itself is held bit for bit above)."""
    for j, t in zip(_pool_arrays(jpool.pool_k) + _pool_arrays(jpool.pool_v),
                    _pool_arrays(tpool.pool_k) + _pool_arrays(tpool.pool_v)):
        if j.dtype == np.int8:
            diff = np.abs(t.astype(np.int32) - j.astype(np.int32))
            assert diff.max() <= 1 and (diff > 0).mean() <= 1e-4
        else:
            np.testing.assert_allclose(t, j, rtol=0, atol=ATOL)


def _assert_host_state(jpool, tpool):
    assert tpool._free == jpool._free
    assert tpool._tables == jpool._tables
    assert tpool._lengths == jpool._lengths
    assert tpool._hash_to_page == jpool._hash_to_page
    assert tpool._page_refs == jpool._page_refs
    assert list(tpool._evictable) == list(jpool._evictable)
    assert tpool.prefix_stats == jpool.prefix_stats
    assert tpool.free_pages == jpool.free_pages


# -- int8 cells ---------------------------------------------------------------

@pytest.mark.parametrize("shape,amp", [((4, 8, 64), 3.0), ((2, 3, 16, 2, 64),
                                                            0.01),
                                       ((5, 128), 250.0)])
def test_quant_cells_bit_exact(shape, amp):
    """int8 values and f32 scales bit for bit against the JAX package's
    _quant_cells (amax / 127 + 1e-8, round half to even), and the
    dequantized cells alike."""
    x = (np.random.default_rng(len(shape)).standard_normal(shape) * amp
         ).astype(np.float32)
    x[..., 0] = 0.5 * np.abs(x).max(-1)  # ties of the rounding
    jq, js = jpaging._quant_cells(jnp.asarray(x))
    tq, ts = tpaging._quant_cells(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy().view(np.uint32),
                                  np.asarray(js).view(np.uint32))
    np.testing.assert_array_equal(
        tpaging._dequant_cells(tq, ts, torch.float32).numpy(),
        np.asarray(jpaging._dequant_cells(jq, js, jnp.float32)))


# -- attention over pages -----------------------------------------------------

@pytest.mark.parametrize("cur_len,window", [(37, 0), (64, 0), (50, 16)])
def test_paged_decode_attention_matches(cur_len, window):
    rng = np.random.default_rng(cur_len)
    q = rng.standard_normal((4, 64)).astype(np.float32)
    kp = rng.standard_normal((9, 16, 2, 64)).astype(np.float32)
    vp = rng.standard_normal((9, 16, 2, 64)).astype(np.float32)
    table = np.asarray([3, 7, 1, 8], np.int32)
    ref = jattention.paged_decode_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(table),
        jnp.int32(cur_len), window=window)
    got = tattention.paged_decode_attention(
        torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
        torch.from_numpy(table), cur_len, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("window", [0, 20])
def test_decode_attention_batch_is_the_vmap(window):
    """Per-row lengths on the device: each row equals decode_attention of
    that row alone (the reference's jax.vmap over the slots)."""
    rng = np.random.default_rng(window)
    q = torch.from_numpy(rng.standard_normal((3, 4, 64)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((3, 48, 2, 64)).astype(
        np.float32))
    v = torch.from_numpy(rng.standard_normal((3, 48, 2, 64)).astype(
        np.float32))
    lens = [1, 30, 48]
    got = tattention.decode_attention_batch(q, k, v, torch.tensor(lens),
                                            window=window)
    for b, n in enumerate(lens):
        want = jattention.decode_attention(
            jnp.asarray(q[b].numpy()), jnp.asarray(k[b].numpy()),
            jnp.asarray(v[b].numpy()), jnp.int32(n), window=window)
        np.testing.assert_allclose(got[b].numpy(), np.asarray(want), rtol=0,
                                   atol=1e-5)


# -- paged decode -------------------------------------------------------------

@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("quantized", [True, False])
def test_decode_step_paged_matches(quantized, int8):
    """One sequence's paged decode chain across a page boundary: logits,
    length and table growth as the JAX pool's, and the pool's cells."""
    jp, tp = _params(quantized)
    toks = _tokens(5, 16)
    jl, jc, tl, tc = _prefilled(jp, tp, toks, 10)
    jpool, tpool = _pools(int8=int8)
    js = jpool.create_sequence(prefill_cache=jc, length=10)
    ts = tpool.create_sequence(prefill_cache=tc, length=10)
    tok = int(jnp.argmax(jl))
    for step in range(9):  # crosses the page boundary at 16
        ref = jpool.decode_step(jp, tok, js)
        got = tpool.decode_step(tp, tok, ts)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                                   atol=ATOL, err_msg=f"step {step}")
        tok = int(jnp.argmax(ref))
    assert tpool.length(ts) == jpool.length(js) == 19
    assert len(tpool._tables[ts]) == 2
    _assert_host_state(jpool, tpool)
    _assert_pools(jpool, tpool)


@pytest.mark.parametrize("int8", [False, True])
def test_batch_decode_step_paged_matches(int8):
    """Two sequences and an inactive slot in one pool: batched paged steps
    match the JAX pool's logits; the inactive slot writes only the trash
    page."""
    jp, tp = _params()
    jpool, tpool = _pools(int8=int8)
    seqs, toks_now = [], []
    for seed, n in ((1, 6), (30, 14)):
        jl, jc, tl, tc = _prefilled(jp, tp, _tokens(seed, 16), n)
        seqs.append((jpool.create_sequence(prefill_cache=jc, length=n),
                     tpool.create_sequence(prefill_cache=tc, length=n)))
        toks_now.append(int(jnp.argmax(jl)))
    for step in range(6):
        ref = jpool.batch_decode_step(
            jp, toks_now + [None], [s[0] for s in seqs] + [None])
        got = tpool.batch_decode_step(
            tp, toks_now + [None], [s[1] for s in seqs] + [None])
        np.testing.assert_allclose(got.numpy()[:2], np.asarray(ref)[:2],
                                   rtol=0, atol=ATOL, err_msg=f"step {step}")
        toks_now = [int(t) for t in np.asarray(jnp.argmax(ref[:2], -1))]
    _assert_host_state(jpool, tpool)
    _assert_pools(jpool, tpool)


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("n_steps,quantized", [(4, True), (9, False)])
def test_decode_steps_batch_paged_matches(n_steps, quantized, int8):
    """A k-step paged chunk (gather once, decode, scatter the new cells
    back), Q4 and dense weights: the JAX ids exactly, the same pool
    lengths and cells; then a pipelined chunk from the last device row
    agrees too."""
    jp, tp = _params(quantized)
    jpool, tpool = _pools(int8=int8)
    seqs, first = [], []
    for seed, n in ((2, 12), (40, 5)):
        jl, jc, tl, tc = _prefilled(jp, tp, _tokens(seed, 16), n)
        seqs.append((jpool.create_sequence(prefill_cache=jc, length=n),
                     tpool.create_sequence(prefill_cache=tc, length=n)))
        first.append(int(jnp.argmax(jl)))
    jids = [None, seqs[0][0], seqs[1][0]]
    tids = [None, seqs[0][1], seqs[1][1]]
    jprod = jpool.batch_decode_steps(jp, [None] + first, jids, n_steps)
    tprod = tpool.batch_decode_steps(tp, [None] + first, tids, n_steps)
    assert [r[1:] for r in tprod.tolist()] == [
        r[1:] for r in np.asarray(jprod).tolist()]
    _assert_host_state(jpool, tpool)
    _assert_pools(jpool, tpool)
    # The pipelined form: the next chunk takes the last row on the device.
    jnext = jpool.batch_decode_steps(jp, jprod[-1], jids, 2)
    tnext = tpool.batch_decode_steps(tp, tprod[-1], tids, 2)
    assert [r[1:] for r in tnext.tolist()] == [
        r[1:] for r in np.asarray(jnext).tolist()]


def test_batch_decode_steps_raises_when_the_pool_is_short():
    jp, tp = _params()
    jpool, tpool = _pools(n_pages=3)
    _, jc, _, tc = _prefilled(jp, tp, _tokens(3, 16), 16)
    s = tpool.create_sequence(prefill_cache=tc, length=16)
    tpool.create_sequence(length=1)  # the last free page
    with pytest.raises(TrackieError):
        tpool.batch_decode_steps(tp, [1], [s], 4)
    assert tpool.length(s) == 16


# -- prefill scatter, prefix gather -------------------------------------------

@pytest.mark.parametrize("int8", [False, True])
def test_prefix_cache_scatter_and_gather_match(int8):
    """create_sequence's scatter (shared positions to the trash page),
    gathered_prefix_cache's staging and an extend of the suffix over it
    match the JAX pool; the first sequence's pages are never rewritten."""
    jp, tp = _params()
    toks = _tokens(11, 48)
    ids = [int(t) for t in toks[:40]]
    _, jc, _, tc = _prefilled(jp, tp, toks, 40)
    jpool, tpool = _pools(int8=int8)
    jpool.create_sequence(prefill_cache=jc, length=40, register_ids=ids)
    ts1 = tpool.create_sequence(prefill_cache=tc, length=40,
                                register_ids=ids)
    before = [a.copy() for a in _pool_arrays(tpool.pool_k)]
    jshared, jm = jpool.acquire_prefix(ids)
    tshared, tm = tpool.acquire_prefix(ids)
    assert (tshared, tm) == (jshared, jm) and tm == 32
    jpool.create_sequence(prefill_cache=jc, length=40, shared_pages=jshared,
                          register_ids=ids)
    tpool.create_sequence(prefill_cache=tc, length=40, shared_pages=tshared,
                          register_ids=ids)
    for b, a in zip(before, _pool_arrays(tpool.pool_k)):
        pages = tpool._tables[ts1]
        np.testing.assert_array_equal(a[:, pages], b[:, pages])
    _assert_host_state(jpool, tpool)
    _assert_pools(jpool, tpool)
    jst = jpool.gathered_prefix_cache(jshared, jm, 64)
    tst = tpool.gathered_prefix_cache(tshared, tm, 64)
    assert tst.k.shape[1] == 64 and tst.length == tm
    assert tst.k.dtype == torch.float32
    np.testing.assert_allclose(tst.k.numpy(), np.asarray(jst.k), rtol=0,
                               atol=ATOL)
    jl, _ = jllm.extend(jp, JCFG, jnp.asarray(toks[32:48]), jnp.int32(8),
                        jst, attn_len=64)
    tl, _ = tllm.extend(tp, TCFG, torch.from_numpy(toks[32:48].astype(
        np.int64)), 8, tst, attn_len=64)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=ATOL)


# -- the host allocator -------------------------------------------------------

def test_alloc_free_and_exhaustion():
    """Page 0 is the trash page: 9 pages, 8 usable; a pool of 3 holds a
    2-page sequence and then refuses another."""
    _, pool = _pools(n_pages=9)
    s1 = pool.create_sequence(length=0)
    assert pool.free_pages == 7
    s2 = pool.create_sequence(length=20)
    assert pool.free_pages == 5
    pool.free_sequence(s1)
    pool.free_sequence(s2)
    assert pool.free_pages == 8
    _, small = _pools(n_pages=3)
    small.create_sequence(length=30)
    with pytest.raises(TrackieError):
        small.create_sequence(length=1)
    _, many = _pools(n_pages=9)
    seqs = [many.create_sequence(length=0) for _ in range(8)]
    assert many.free_pages == 0
    for s in seqs[:4]:
        many.free_sequence(s)
    assert many.free_pages == 4


def test_prefix_cache_host_logic_follows_the_reference():
    """One script of pool operations (register, share, divergent and
    page-exact prompts, release, LRU eviction under pressure, capacity
    growth) on both pools: the same tables, free list, refcounts, LRU
    order and prefix stats after every operation."""
    jpool, tpool = _pools(n_pages=6)
    ids = list(range(40))
    script = [
        ("create", dict(length=40, register_ids=ids)),
        ("acquire", ids), ("release", None),
        ("acquire", ids[:32] + [500, 501, 502]), ("release", None),
        ("acquire", [99] + ids[1:]), ("release", None),
        ("acquire", list(range(32))), ("release", None),
        ("acquire", ids), ("create_shared", dict(length=40,
                                                 register_ids=ids)),
        ("free", 1), ("free", 2),
        ("create", dict(length=48)),             # evicts cached pages
        ("acquire", ids), ("release", None),
        ("grow", (3, 20)), ("free", 3),
    ]
    shared = {}
    for op, arg in script:
        for name, pool in (("j", jpool), ("t", tpool)):
            if op == "create":
                pool.create_sequence(**arg)
            elif op == "acquire":
                shared[name] = pool.acquire_prefix(arg)
            elif op == "release":
                pool.release_prefix(shared[name][0])
            elif op == "create_shared":
                pool.create_sequence(shared_pages=shared[name][0], **arg)
            elif op == "free":
                pool.free_sequence(arg)
            elif op == "grow":
                pool.ensure_capacity_for(*arg)
        if op == "acquire":
            assert shared["t"] == shared["j"], arg
        _assert_host_state(jpool, tpool)
    assert tpool.prefix_stats["evictions"] >= 1
    assert tpool.free_pages == 5


def test_int8_pool_is_half_the_bytes():
    bf = tpaging.PagedKVPool(TCFG, 8, 16, torch.bfloat16, device="cpu")
    q = tpaging.PagedKVPool(TCFG, 8, 16, torch.int8, device="cpu")
    assert q.quantized and q.compute_dtype == torch.bfloat16
    q_bytes = sum(t.numel() * t.element_size() for t in q.pool_k)
    assert q_bytes < 0.55 * bf.pool_k.numel() * bf.pool_k.element_size()


@pytest.mark.parametrize("make", ["pool", "cache", "batched", "vad",
                                  "silero", "navigation", "vision"])
def test_allocators_need_a_card_or_an_explicit_cpu(make, monkeypatch):
    """The page pool, both KV caches, the two VAD states, the navigation
    engine (its RANSAC generator) and the vision pipeline take the CUDA
    card when no device is given, as the JAX package's allocate on the
    accelerator; without a card they raise rather than fall back to the
    CPU, which must be asked for."""
    from trackiellm_tpu_torch.models import vad as tvad
    from trackiellm_tpu_torch.navigation import NavigationEngine
    from trackiellm_tpu_torch.utils.errors import ErrorCode, TrackieError
    from trackiellm_tpu_torch.vision import VisionPipeline
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    build = {"pool": lambda **kw: tpaging.PagedKVPool(TCFG, 8, 16, **kw),
             "cache": lambda **kw: tllm.KVCache.create(TCFG, **kw),
             "batched": lambda **kw: tllm.BatchedKVCache.create(TCFG, 2,
                                                                **kw),
             "vad": lambda **kw: tvad.init_state(tvad.VADConfig(), **kw),
             "silero": lambda **kw: tvad.silero_init_state(
                 tvad.SileroConfig(), **kw),
             "navigation": lambda **kw: NavigationEngine(**kw),
             "vision": lambda **kw: VisionPipeline(None, **kw)}[make]
    with pytest.raises(TrackieError) as err:
        build()
    assert err.value.code == ErrorCode.DEVICE_UNAVAILABLE
    assert "device=torch.device('cpu')" in str(err.value)
    made = build(device="cpu")
    t = {"pool": lambda: made.pool_k, "vad": lambda: made,
         "silero": lambda: made[0],
         "navigation": lambda: made._gen,
         "vision": lambda: torch.empty(0, device=made.device)}.get(
             make, lambda: made.k)()
    assert t.device.type == "cpu"
