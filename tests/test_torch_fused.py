"""Parity of trackiellm_tpu_torch.ops.fused with trackiellm_tpu.ops.fused.

The plain twin ``fused_mlp_ref`` is held to the JAX oracle
``fused_mlp_xla`` (1e-5 rel L2 in f32; 1e-2 in bf16, where one rounding of
the output may land on the other side) and to the Pallas kernel
``fused_mlp_q4_pallas`` run in interpret mode (2e-4 abs: f32 sums over D and
H taken in another order). ``_can_fuse`` must agree with the JAX gate
everywhere, and a tiny model under ``TRACKIE_FUSED_MLP=1`` must decode the
JAX package's logits through the fused block on both sides.
"""

import itertools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from trackiellm_tpu.models import llm as jllm
from trackiellm_tpu.ops import fused as jfused
from trackiellm_tpu.ops import quant as jq
from trackiellm_tpu_torch.models import llm as tllm
from trackiellm_tpu_torch.models.bridge import params_from_jax
from trackiellm_tpu_torch.ops import fused as tfused
from trackiellm_tpu_torch.ops import quant as tq

EPS = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes: one intra-op thread, so this file does not crowd the
    other test workers' CPUs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _block(seed, m, d, h, g, dtype):
    """The same MLP block for both packages: x (M, D), a norm scale near 1,
    Q4 w_gu (D, 2H) and w_down (H, D) at group g."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, d)).astype(np.float32)
    norm = (1.0 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    w_gu = (rng.standard_normal((d, 2 * h)) / np.sqrt(d)).astype(np.float32)
    w_down = (rng.standard_normal((h, d)) / np.sqrt(h)).astype(np.float32)
    tx, tn = torch.from_numpy(x), torch.from_numpy(norm)
    if dtype == "bfloat16":
        tx, tn = tx.to(torch.bfloat16), tn.to(torch.bfloat16)
    jx = jnp.asarray(tx.float().numpy()).astype(
        jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    jn = jnp.asarray(tn.float().numpy()).astype(jx.dtype)
    jgu = jq.quantize_q4(jnp.asarray(w_gu), g)
    jdown = jq.quantize_q4(jnp.asarray(w_down), g)
    return (tx, tn, params_from_jax(jgu), params_from_jax(jdown)), (
        jx, jn, jgu, jdown)


@pytest.mark.parametrize("g,m,dtype", list(itertools.product(
    [64, 128], [1, 4], ["float32", "bfloat16"])))
def test_fused_ref_matches_xla(g, m, dtype):
    (tx, tn, tgu, tdown), (jx, jn, jgu, jdown) = _block(g + m, m, 256, 512,
                                                        g, dtype)
    out = tfused.fused_mlp_ref(tx, tn, tgu, tdown, EPS)
    ref = jfused.fused_mlp_xla(jx, jn, jgu, jdown, EPS)
    assert out.dtype == tx.dtype and out.shape == tx.shape
    tol = 1e-5 if dtype == "float32" else 1e-2
    assert _rel_l2(out.float().numpy(), np.asarray(ref, np.float32)) < tol
    # The CPU wrappers take the plain version, and only because the tensor
    # is on the CPU.
    for got in (tfused.fused_mlp(tx, tn, tgu, tdown, EPS),
                tfused.fused_mlp_q4(tx, tn, tgu.values, tgu.scales,
                                    tdown.values, tdown.scales, EPS)):
        assert torch.equal(got, out)


@pytest.mark.parametrize("g,m", list(itertools.product([64, 128], [1, 4])))
def test_fused_ref_matches_pallas_interpret(g, m):
    (tx, tn, tgu, tdown), (jx, jn, jgu, jdown) = _block(3 * g + m, m, 256,
                                                        512, g, "float32")
    out = tfused.fused_mlp_ref(tx, tn, tgu, tdown, EPS).numpy()
    kernel = np.asarray(jfused.fused_mlp_q4_pallas(
        jx, jn, jgu.values, jgu.scales, jdown.values, jdown.scales, eps=EPS,
        interpret=True))
    np.testing.assert_allclose(out, kernel, rtol=0, atol=2e-4)


def _stub(k, n, g, q4, lib):
    """A QuantizedLinear of the given logical shape with zero contents."""
    rows = k // 2 if q4 else k
    if lib == "jax":
        return jq.QuantizedLinear(
            np.zeros((rows, n), np.uint8 if q4 else np.int8),
            np.zeros((k // g, n), np.float32))
    return tq.QuantizedLinear(
        torch.zeros((rows, n), dtype=torch.uint8 if q4 else torch.int8),
        torch.zeros((k // g, n)))


@pytest.mark.parametrize("d,h,g", [
    (d, h, g) for d, h, g in itertools.product(
        [256, 384, 512], [512, 768, 1024], [64, 128, 256])
    if d % g == 0 and h % g == 0])  # the group divides K of both weights
def test_can_fuse_matches_jax(d, h, g):
    for m, q4, g_down, dense in itertools.product(
            [1, 8, 9], [True, False], [g, g // 2], [False, True]):
        args = {}
        for lib in ("jax", "torch"):
            w_gu = _stub(d, 2 * h, g, q4, lib)
            w_down = _stub(h, d, g_down, q4, lib)
            if dense:
                w_down = (np.zeros((h, d), np.float32) if lib == "jax"
                          else torch.zeros((h, d)))
            x = np.zeros((m, d), np.float32) if lib == "jax" else torch.zeros(
                (m, d))
            args[lib] = (x, w_gu, w_down)
        assert tfused._can_fuse(*args["torch"]) == jfused._can_fuse(
            *args["jax"]), (d, h, g, m, q4, g_down, dense)


@pytest.fixture
def fused_lever(monkeypatch):
    """TRACKIE_FUSED_MLP=1 for both packages. The JAX side reads it at
    trace time, so its caches are cleared on the way in (a cached trace
    would silently run the unfused path) and on the way out (later tests
    in this worker must not reuse a fused trace)."""
    monkeypatch.setenv("TRACKIE_FUSED_MLP", "1")
    jax.clear_caches()
    yield
    monkeypatch.delenv("TRACKIE_FUSED_MLP")
    jax.clear_caches()


def test_tiny_decode_through_the_fused_block_matches_jax(fused_lever,
                                                         monkeypatch):
    cfg = jllm.LLMConfig.tiny()
    tcfg = tllm.LLMConfig(**cfg._asdict())
    jp = jllm.quantize_params(
        jllm.init_params(jax.random.PRNGKey(5), cfg, dtype=jnp.float32),
        bits=4, group=128)
    tp = params_from_jax(jp)
    seen = {"jax": 0, "torch": 0}

    def counted(fn, key):
        def wrapped(*args, **kwargs):
            seen[key] += 1
            return fn(*args, **kwargs)
        return wrapped

    monkeypatch.setattr(jfused, "fused_mlp_xla",
                        counted(jfused.fused_mlp_xla, "jax"))
    monkeypatch.setattr(tfused, "fused_mlp_ref",
                        counted(tfused.fused_mlp_ref, "torch"))
    toks = np.random.default_rng(5).integers(0, 256, 64).astype(np.int32)
    jl, jc = jllm.prefill(jp, cfg, jnp.asarray(toks), jnp.int32(40),
                          jllm.KVCache.create(cfg, dtype=jnp.float32))
    tl, tc = tllm.prefill(tp, tcfg, torch.from_numpy(toks.astype(np.int64)),
                          40, tllm.KVCache.create(tcfg, torch.float32, device="cpu"))
    assert seen == {"jax": 0, "torch": 0}  # M = 64: the unfused path
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=1e-4)
    for tok in (7, 300, 12):
        jl, jc = jllm.decode_step(jp, cfg, jnp.int32(tok), jc)
        tl, tc = tllm.decode_step(tp, tcfg, tok, tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                                   atol=1e-4)
    # Both sides ran the fused block: the port in each layer of each step,
    # the JAX package in its (single) decode trace.
    assert seen["torch"] == 3 * cfg.n_layers
    assert seen["jax"] >= 1


@pytest.mark.parametrize("sms", [132, 114, 7])
@pytest.mark.parametrize("m", [1, 3, 8])
@pytest.mark.parametrize("d,h,g", [(256, 512, 64), (512, 1024, 128),
                                   (1024, 1280, 64), (4096, 14336, 256)])
def test_fused_plan_covers_every_pair_and_column_once(d, h, g, m, sms):
    """The kernel's split (``fused_plan`` and ``unit_ranges`` mirror its
    ``unit_begin``): every (hidden-pair tile, W_gu row chunk) and every
    (output slice, W_down row chunk) falls to exactly one block, so every
    hidden pair and every output column is summed over all of its rows once;
    the ranges differ by one unit at most, and the grid fits one block an
    SM."""
    plan = tfused.fused_plan(m, d, h, g, sms)
    assert plan.blocks <= sms and plan.rows >= m and plan.rows in (1, 2, 4, 8)
    assert plan.smem_bytes <= 232448 - 1024
    assert g % plan.chunk_a == 0    # a chunk never straddles two groups
    phases = ((plan.units_a, d // 2 // plan.chunk_a,
               h // 2 // plan.tile_pairs, plan.tile_pairs, h // 2),
              (plan.units_b, h // 2 // tfused.CHUNK_B,
               d // plan.slice_cols, plan.slice_cols, d))
    for units, chunks, tiles, width, covered in phases:
        assert units == chunks * tiles
        seen = np.zeros((covered, chunks), np.int64)
        ranges = tfused.unit_ranges(units, plan.blocks)
        assert ranges[0][0] == 0 and ranges[-1][1] == units
        sizes = [u1 - u0 for u0, u1 in ranges]
        assert max(sizes) - min(sizes) <= 1   # an even share of the bytes
        for u0, u1 in ranges:
            for u in range(u0, u1):
                tile, chunk = divmod(u, chunks)
                seen[tile * width:(tile + 1) * width, chunk] += 1
        assert (seen == 1).all()
    # act (H/2, 2, rows) and a (rows, 128) + (rows, 64) partial a block;
    # the partials stay under 1 MB at M = 8 on 132 SMs.
    partial = plan.scratch_floats - plan.rows * h
    assert partial == plan.blocks * plan.rows * (4 * plan.tile_pairs
                                                 + plan.slice_cols)
    assert partial * 4 < 2 ** 20


def test_fused_plan_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError):      # G not a multiple of 64
        tfused.fused_plan(1, 512, 1024, 32, 132)
    with pytest.raises(ValueError):      # D not a multiple of 128
        tfused.fused_plan(1, 320, 1024, 64, 132)
    with pytest.raises(ValueError):      # H/2 not a multiple of 128
        tfused.fused_plan(1, 512, 1408, 64, 132)
    with pytest.raises(ValueError):      # 8 rows of h2 at D 5120 overflow
        tfused.fused_plan(8, 5120, 13824, 256, 132)
    assert tfused.fused_plan(4, 5120, 13824, 256, 132).rows == 4
