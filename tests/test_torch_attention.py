"""Parity of trackiellm_tpu_torch.ops.attention with trackiellm_tpu.ops.attention.

The port's dense ``attention_ref`` and the flash kernel's plain twin
(``flash_attention`` on a CPU tensor) are held against the Pallas
``flash_attention`` in interpret mode and against ``attention_xla``, for
the five prefill variants, at S=256. Tolerances: 2e-5 abs in f32 (sums in
another order), 1e-2 abs in bf16 (one bf16 rounding of the output).
The CUDA kernels themselves are tested in tests/test_torch_cuda.py.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from trackiellm_tpu.ops import attention as ja
from trackiellm_tpu_torch.ops import attention as ta

H, HK, S, D = 4, 2, 256, 64
VARIANTS = {
    "causal": {},
    "window": {"window": 100},
    "softcap": {"softcap": 5.0},
    "scale": {"scale": 0.3},
    "sinks": {"sinks": True},
}
TOL = {"float32": 2e-5, "bfloat16": 1e-2}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes: one intra-op thread, so this file does not crowd the
    other test workers' CPUs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed, h=H, hk=HK, s=S, d=D):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((h, s, d)).astype(np.float32)
    k = rng.standard_normal((hk, s, d)).astype(np.float32)
    v = rng.standard_normal((hk, s, d)).astype(np.float32)
    sinks = rng.standard_normal(h).astype(np.float32)
    return q, k, v, sinks


def _kw(variant, sinks, to):
    kw = dict(VARIANTS[variant])
    if kw.pop("sinks", False):
        kw["sinks"] = to(sinks)
    return kw


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_prefill_variants_match_pallas_and_xla(variant, dtype):
    q, k, v, sinks = _inputs(sorted(VARIANTS).index(variant))
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    td = torch.float32 if dtype == "float32" else torch.bfloat16
    jargs = [jnp.asarray(a).astype(jd) for a in (q, k, v)]
    targs = [torch.from_numpy(a).to(td) for a in (q, k, v)]
    jkw = _kw(variant, sinks, jnp.asarray)
    tkw = _kw(variant, sinks, torch.from_numpy)
    pallas = np.asarray(ja.flash_attention(
        *jargs, block_q=128, block_k=128, interpret=True, **jkw),
        np.float32)
    xla = np.asarray(ja.attention_xla(*jargs, **jkw), np.float32)
    dense = ta.attention_ref(*targs, **tkw)
    tiled = ta.flash_attention(*targs, **tkw)  # CPU tensor -> plain twin
    assert dense.dtype == td and tiled.dtype == td
    for got in (dense, tiled):
        got = got.float().numpy()
        np.testing.assert_allclose(got, pallas, rtol=0, atol=TOL[dtype])
        np.testing.assert_allclose(got, xla, rtol=0, atol=TOL[dtype])


@pytest.mark.parametrize("kw", [{"causal": False}, {"chunk": 64},
                                {"window": 32, "chunk": 128}])
def test_attention_ref_other_masks_match_xla(kw):
    q, k, v, _ = _inputs(11)
    ref = np.asarray(ja.attention_xla(*map(jnp.asarray, (q, k, v)), **kw))
    got = ta.attention_ref(*map(torch.from_numpy, (q, k, v)), **kw).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-5)


def test_attention_ref_aligns_query_and_key_ends():
    """Sq < Sk: the queries are the last Sq positions (extend layout)."""
    q, k, v, _ = _inputs(12)
    q = q[:, -64:]
    ref = np.asarray(ja.attention_xla(*map(jnp.asarray, (q, k, v)),
                                      window=50))
    got = ta.attention_ref(*map(torch.from_numpy, (q, k, v)),
                           window=50).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-5)


@pytest.mark.parametrize("window,tiles", [(0, [0, 1, 2, 3]), (1, [2, 3]),
                                          (33, [1, 2, 3]), (34, [0, 1, 2, 3])])
def test_flash_tile_skip(window, tiles):
    """Query tile 1 (rows 64..127) visits key tiles of 32 from the one that
    holds its window's first key up to its diagonal."""
    assert list(ta._tile_range(1, S // ta.BLOCK_K, True, window)) == tiles
    assert list(ta._tile_range(1, 8, False, window)) == list(range(8))


def test_prefill_attention_dispatch_on_cpu_is_dense():
    q, k, v, _ = _inputs(13)
    t = [torch.from_numpy(a) for a in (q, k, v)]
    np.testing.assert_array_equal(ta.prefill_attention(*t).numpy(),
                                  ta.attention_ref(*t).numpy())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kw", [{}, {"window": 7}, {"softcap": 3.0},
                                {"scale": 0.2}, {"sinks": True},
                                {"chunk": 16}])
def test_decode_attention_matches_xla(kw, dtype):
    rng = np.random.default_rng(21)
    q = rng.standard_normal((H, D)).astype(np.float32)
    kc = rng.standard_normal((48, HK, D)).astype(np.float32)
    vc = rng.standard_normal((48, HK, D)).astype(np.float32)
    sinks = rng.standard_normal(H).astype(np.float32)
    kw = dict(kw)
    use_sinks = kw.pop("sinks", False)
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    td = torch.float32 if dtype == "float32" else torch.bfloat16
    ref = np.asarray(ja.decode_attention(
        jnp.asarray(q).astype(jd), jnp.asarray(kc).astype(jd),
        jnp.asarray(vc).astype(jd), jnp.int32(30),
        sinks=jnp.asarray(sinks) if use_sinks else None, **kw), np.float32)
    got = ta.decode_attention(
        torch.from_numpy(q).to(td), torch.from_numpy(kc).to(td),
        torch.from_numpy(vc).to(td), 30,
        sinks=torch.from_numpy(sinks) if use_sinks else None, **kw)
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=0,
                               atol=1e-5 if dtype == "float32" else 1e-2)


def test_flash_wrapper_checks():
    q, k, v, _ = _inputs(14)
    t = [torch.from_numpy(a) for a in (q, k, v)]
    with pytest.raises(ValueError):
        ta.flash_attention(t[0][:, :100], t[1][:, :100], t[2][:, :100])
    with pytest.raises(TypeError):
        ta.flash_attention(t[0].double(), t[1].double(), t[2].double())
    with pytest.raises(ValueError):
        ta.flash_attention(t[0][:, :, :32], t[1][:, :, :32], t[2][:, :, :32])
