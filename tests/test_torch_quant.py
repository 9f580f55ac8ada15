"""Parity of trackiellm_tpu_torch.ops.quant with trackiellm_tpu.ops.quant.

Inputs are made with numpy from a seed and fed to the JAX function and to
its port. Layout functions (quantize, dequantize) must agree bit for bit;
matmuls to 1e-5 relative (f32 sums taken in another order). Each kernel's
plain version (W4A8, Q8, f32-activation Q4) is held against its Pallas
kernel itself, run in interpret mode, and the dispatcher's routing table is
pinned with recorders in place of the kernels.
"""

import itertools

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from trackiellm_tpu.ops import quant as jq
from trackiellm_tpu_torch.ops import quant as tq

GROUPS = [64, 256]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes: one intra-op thread, so this file does not crowd the
    other test workers' CPUs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _w(seed, k, n):
    return np.random.default_rng(seed).standard_normal((k, n)).astype(
        np.float32)


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.mark.parametrize("group", GROUPS)
@pytest.mark.parametrize("bits", [4, 8])
def test_quantize_and_dequantize_bit_identical(bits, group):
    w = _w(group + bits, 512, 384)
    jfn = jq.quantize_q4 if bits == 4 else jq.quantize_q8
    tfn = tq.quantize_q4 if bits == 4 else tq.quantize_q8
    jw = jfn(jnp.asarray(w), group)
    tw = tfn(torch.from_numpy(w), group)
    np.testing.assert_array_equal(tw.values.numpy(), np.asarray(jw.values))
    np.testing.assert_array_equal(tw.scales.numpy(), np.asarray(jw.scales))
    assert tw.values.dtype == (torch.uint8 if bits == 4 else torch.int8)
    assert (tw.k, tw.n, tw.group_size) == (jw.k, jw.n, jw.group_size)
    np.testing.assert_array_equal(tq.dequantize(tw).numpy(),
                                  np.asarray(jq.dequantize(jw)))


@pytest.mark.parametrize("group", GROUPS)
@pytest.mark.parametrize("m", [1, 7, 64])
def test_quantized_matmul_matches_xla(m, group):
    w = _w(m + group, 512, 256)
    x = np.random.default_rng(m).standard_normal((m, 512)).astype(np.float32)
    jw = jq.quantize_q4(jnp.asarray(w), group)
    ref = np.asarray(jq.quantized_matmul_xla(jnp.asarray(x), jw))
    tw = tq.quantize_q4(torch.from_numpy(w), group)
    out = tq.quantized_matmul(torch.from_numpy(x), tw).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5,
                               atol=1e-5 * np.abs(ref).max())
    # The dispatcher keeps leading axes, as the reference does.
    out3 = tq.quantized_matmul(torch.from_numpy(x)[None], tw)
    assert out3.shape == (1, m, 256)


@pytest.mark.parametrize("group", GROUPS)
def test_activation_quantization_bit_identical(group):
    x = np.random.default_rng(group).standard_normal((5, 1024)).astype(
        np.float32) * 3.0
    x[1, :group] = 0.0  # an all-zero group takes the 1e-12 scale floor
    jx, jsx, jsum = jq.quantize_activations_q8(jnp.asarray(x), group)
    tx, tsx, tsum = tq.quantize_activations_q8(torch.from_numpy(x), group)
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(tsx.numpy(), np.asarray(jsx))
    np.testing.assert_array_equal(tsum.numpy(), np.asarray(jsum))
    # The kernel's wrapper takes the plain version on a CPU tensor.
    for got, want in zip(tq.quantize_activations(torch.from_numpy(x), group),
                         (tx, tsx, tsum)):
        assert torch.equal(got, want)
    with pytest.raises(ValueError):
        tq.quantize_activations(torch.from_numpy(x)[:, :group + 1], group)


@pytest.mark.parametrize("group", GROUPS)
def test_activation_quantization_carries_nan_and_inf(group):
    """A NaN or +-Inf activation: both packages give the same sx (NaN for
    a NaN group, inf for an Inf group), a non-finite sxsum in the same
    groups, and W4A8 outputs non-finite at exactly the same elements (the
    plain twin against the Pallas kernel in interpret mode). xq of a
    non-finite group is not compared: the int8 cast of NaN is undefined."""
    k, n = 1024, 256
    x = np.random.default_rng(group + 5).standard_normal((5, k)).astype(
        np.float32)
    x[0, 3] = np.nan                  # group 0 of row 0
    x[1, group + 7] = np.inf          # group 1 of row 1
    x[3, k - 1] = -np.inf             # the last group of row 3
    _, jsx, jsum = jq.quantize_activations_q8(jnp.asarray(x), group)
    _, tsx, tsum = tq.quantize_activations_q8(torch.from_numpy(x), group)
    np.testing.assert_array_equal(tsx.numpy(), np.asarray(jsx))
    assert np.isnan(tsx[0, 0].item()) and tsx[1, 1].item() == np.inf
    assert tsx[3, -1].item() == np.inf
    bad = ~np.isfinite(np.asarray(jsum))
    np.testing.assert_array_equal(~np.isfinite(tsum.numpy()), bad)
    assert bad.sum() == 3 and bad[0, 0] and bad[1, 1] and bad[3, -1]

    w = _w(group, k, n)
    jw = jq.quantize_q4(jnp.asarray(w), group)
    tw = tq.quantize_q4(torch.from_numpy(w), group)
    kernel = np.asarray(jq.q4_matmul_pallas_i8(
        jnp.asarray(x), jw.values, jw.scales, tile_n=128, tile_k=256,
        interpret=True))
    out = tq.q4_matmul_w4a8_ref(torch.from_numpy(x), tw.values,
                                tw.scales).numpy()
    np.testing.assert_array_equal(~np.isfinite(out), ~np.isfinite(kernel))
    assert (~np.isfinite(out)).all(axis=1).tolist() == [True, True, False,
                                                         True, False]
    finite = np.isfinite(out).all(axis=1)
    assert _rel_l2(out[finite], kernel[finite]) < 1e-5


@pytest.mark.parametrize("group", GROUPS)
@pytest.mark.parametrize("m", [1, 8, 32])
def test_w4a8_ref_matches_pallas_interpret(m, group):
    k, n = 1024, 256
    w = _w(7 * m + group, k, n)
    x = np.random.default_rng(m + 1).standard_normal((m, k)).astype(
        np.float32)
    jw = jq.quantize_q4(jnp.asarray(w), group)
    ref = np.asarray(jq.q4_matmul_pallas_i8(
        jnp.asarray(x), jw.values, jw.scales, tile_n=128, tile_k=256,
        interpret=True))
    tw = tq.quantize_q4(torch.from_numpy(w), group)
    out = tq.q4_matmul_w4a8_ref(torch.from_numpy(x), tw.values, tw.scales)
    assert out.dtype == torch.float32 and out.shape == (m, n)
    assert _rel_l2(out.numpy(), ref) < 1e-5
    # The CPU wrapper takes the plain version, and only because the
    # tensor is on the CPU.
    wrapped = tq.q4_matmul_w4a8(torch.from_numpy(x), tw.values, tw.scales)
    np.testing.assert_array_equal(wrapped.numpy(), out.numpy())


def test_w4a8_bf16_activations_follow_the_f32_path():
    """The model path hands bf16 activations to the matmul; both sides
    quantize them from their f32 value."""
    w = _w(3, 512, 128)
    x = np.random.default_rng(4).standard_normal((4, 512)).astype(np.float32)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    tw = tq.quantize_q4(torch.from_numpy(w), 64)
    jw = jq.quantize_q4(jnp.asarray(w), 64)
    ref = np.asarray(jq.q4_matmul_pallas_i8(
        jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16), jw.values,
        jw.scales, tile_n=128, tile_k=128, interpret=True))
    out = tq.q4_matmul_w4a8_ref(xb, tw.values, tw.scales).numpy()
    assert _rel_l2(out, ref) < 1e-5


MISTRAL_KN = [(4096, 6144), (4096, 4096), (4096, 28672), (14336, 4096),
              (4096, 32000)]


def _check_plan(plan, m, n, n_groups, bm, bn):
    """Splits are whole groups, cover every group exactly once, and fill
    the card (four blocks per SM) where the groups allow it."""
    got_bm, splits, per_split = plan
    assert got_bm == bm
    assert 1 <= splits <= n_groups
    assert (splits - 1) * per_split < n_groups <= splits * per_split
    tiles = -(-n // bn) * -(-m // bm)
    assert tiles * splits >= min(4 * 132, tiles * n_groups)


@pytest.mark.parametrize("m,expect_bm", [(1, 16), (4, 16), (8, 16), (16, 16),
                                         (17, 64), (64, 64), (512, 64)])
def test_w4a8_plan(m, expect_bm):
    """The tensor-core W4A8 kernel's plan: 128-column tiles, 16 rows up to
    M = 16 (decode pads M to one m16 slab), 64 above."""
    for k, n in MISTRAL_KN:
        ngh = k // 2 // 256
        _check_plan(tq._w4a8_plan(m, n, ngh), m, n, ngh, expect_bm,
                    tq.W4A8_BN)


@pytest.mark.parametrize("m,expect_bm", [(1, 16), (3, 16), (15, 16),
                                         (16, 16), (17, 64), (64, 64),
                                         (65, 64), (512, 64)])
def test_q8_plan(m, expect_bm):
    """The bf16 Q8 tensor-core kernel's plan: 128-column tiles, 16 rows up
    to M = 16 (the decode tile), 64 above; splits in whole groups of all of
    K, as even as the groups allow, toward 16 blocks per SM for the 16-row
    tiles and one for the 64-row tiles. N = 320 (the card tests' width) leaves
    a column tail."""
    for k, n in MISTRAL_KN + [(1024, 320)]:
        for group in (64, 128, 256):
            ng = k // group
            bm, splits, per_split = tq._q8_plan(m, n, ng)
            assert bm == expect_bm
            assert 1 <= splits <= ng
            assert (splits - 1) * per_split < ng <= splits * per_split
            tiles = -(-n // tq.Q8_BN) * -(-m // bm)
            target = (16 if bm == 16 else 1) * 132
            # Even splits of ceil(ng / s) groups reach at least half of
            # the s splits the target asks for.
            assert 2 * tiles * splits >= min(target, tiles * ng)
            assert per_split == -(-ng // splits)
    # Mistral-7B decode: w_gu two groups a block, wo and w_down one.
    assert tq._q8_plan(1, 28672, 16) == (16, 8, 2)
    assert tq._q8_plan(1, 4096, 16) == (16, 16, 1)
    assert tq._q8_plan(1, 4096, 56) == (16, 56, 1)
    # Prefill at M = 512 is not split.
    assert tq._q8_plan(512, 4096, 56) == (64, 1, 56)


@pytest.mark.parametrize("m,expect_bm", [(1, 16), (3, 16), (15, 16),
                                         (16, 16), (17, 64), (64, 64),
                                         (65, 64), (512, 64)])
def test_f32a_plan(m, expect_bm):
    """The bf16 f32a tensor-core kernel's plan: 128-column tiles, 16 rows
    up to M = 16, 64 above. For every column tile the splits cover the
    group pairs of the K halves once, each split whole group pairs, as
    even as they allow, toward 8 blocks per SM for the 16-row tiles and
    one for the 64-row tiles. Tiny to Mistral-7B widths; N = 320 leaves a
    column tail."""
    for k, n in MISTRAL_KN + [(1024, 320), (256, 4), (64, 68)]:
        for group in (32, 64, 128, 256, 512, 1024):
            if (k // 2) % group:
                continue
            ngh = k // 2 // group
            bm, splits, per_split = tq._f32a_plan(m, n, ngh)
            assert bm == expect_bm
            assert 1 <= splits <= ngh
            cover = np.zeros(ngh, np.int64)
            for z in range(splits):
                cover[z * per_split:(z + 1) * per_split] += 1
            assert (cover == 1).all()
            assert per_split == -(-ngh // splits)
            tiles = -(-n // tq.F32A_BN) * -(-m // bm)
            target = (8 if bm == 16 else 1) * 132
            assert 2 * tiles * splits >= min(target, tiles * ngh)
    # Mistral-7B at decode: two group pairs a split at w_gu, one at wo and
    # w_down; none at M = 512.
    assert tq._f32a_plan(1, 28672, 8) == (16, 4, 2)
    assert tq._f32a_plan(1, 4096, 8) == (16, 8, 1)
    assert tq._f32a_plan(1, 4096, 28) == (16, 28, 1)
    assert tq._f32a_plan(512, 28672, 8) == (64, 1, 8)


@pytest.mark.parametrize("m,expect_bm", [(1, 4), (4, 4), (8, 16), (16, 16),
                                         (64, 64), (512, 64)])
def test_split_k_plan(m, expect_bm):
    """The f32-activation kernels' plan (Q8, f32a): 64-column tiles whose
    rows cover M with the least waste."""
    for k, n in MISTRAL_KN:
        ngh = k // 2 // 256
        _check_plan(tq._split_k_plan(m, n, ngh), m, n, ngh, expect_bm, 64)


def test_dispatch_rules():
    w = tq.quantize_q8(torch.from_numpy(_w(1, 256, 128)), 64)
    x = torch.ones((2, 256))
    # Q8 on the CPU is dequantize-then-matmul, as off the TPU.
    np.testing.assert_allclose(tq.quantized_matmul(x, w).numpy(),
                               (x @ tq.dequantize(w)).numpy(), rtol=1e-6)
    with pytest.raises(ValueError):
        tq.q4_matmul_w4a8(torch.ones((2, 100)), torch.zeros((64, 8),
                          dtype=torch.uint8), torch.ones((2, 8)))
    with pytest.raises(TypeError):
        tq.q4_matmul_w4a8(torch.ones((2, 128)), torch.zeros((64, 8),
                          dtype=torch.int8), torch.ones((2, 8)))
    with pytest.raises(TypeError):      # x must be f32, bf16 or f16
        tq.q4_matmul_w4a8(torch.ones((2, 128), dtype=torch.float64),
                          torch.zeros((64, 8), dtype=torch.uint8),
                          torch.ones((2, 8)))


# --- the f32-activation kernels: Q8 and Q4 under TRACKIE_Q4_F32A ------------

F32A_CASES = list(itertools.product([64, 128], [np.float32, "bfloat16"],
                                    [1, 8, 32]))


def _x_both(seed, m, k, dtype):
    """The same activations for both packages: f32, or f32 values rounded
    to bf16 on the torch side and handed to JAX as bf16."""
    x = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (m, k)).astype(np.float32))
    if dtype == "bfloat16":
        x = x.to(torch.bfloat16)
        return x, jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
    return x, jnp.asarray(x.numpy())


@pytest.mark.parametrize("group,dtype,m", F32A_CASES)
def test_q8_ref_matches_pallas_interpret_and_xla(group, dtype, m):
    k, n = 512, 256
    w = _w(11 * m + group, k, n)
    tx, jx = _x_both(m + group, m, k, dtype)
    jw = jq.quantize_q8(jnp.asarray(w), group)
    tw = tq.quantize_q8(torch.from_numpy(w), group)
    out = tq.q8_matmul_ref(tx, tw.values, tw.scales)
    assert out.dtype == torch.float32 and out.shape == (m, n)
    kernel = np.asarray(jq.q8_matmul_pallas(jx, jw.values, jw.scales,
                                            tile_n=128, tile_k=256,
                                            interpret=True))
    assert _rel_l2(out.numpy(), kernel) < 1e-5
    assert _rel_l2(out.numpy(), np.asarray(jq.quantized_matmul_xla(jx, jw))
                   ) < 1e-5
    # The CPU wrapper takes the plain version, and only because the
    # tensor is on the CPU.
    np.testing.assert_array_equal(
        tq.q8_matmul(tx, tw.values, tw.scales).numpy(), out.numpy())


@pytest.mark.parametrize("group,dtype,m", F32A_CASES)
def test_f32a_ref_matches_pallas_interpret_and_xla(group, dtype, m):
    k, n = 1024, 256
    w = _w(13 * m + group, k, n)
    tx, jx = _x_both(m + 2 * group, m, k, dtype)
    jw = jq.quantize_q4(jnp.asarray(w), group)
    tw = tq.quantize_q4(torch.from_numpy(w), group)
    out = tq.q4_matmul_f32a_ref(tx, tw.values, tw.scales)
    assert out.dtype == torch.float32 and out.shape == (m, n)
    kernel = np.asarray(jq.q4_matmul_pallas(jx, jw.values, jw.scales,
                                            tile_n=128, tile_k=256,
                                            interpret=True))
    assert _rel_l2(out.numpy(), kernel) < 1e-5
    assert _rel_l2(out.numpy(), np.asarray(jq.quantized_matmul_xla(jx, jw))
                   ) < 1e-5
    np.testing.assert_array_equal(
        tq.q4_matmul_f32a(tx, tw.values, tw.scales).numpy(), out.numpy())


@pytest.mark.parametrize("fn", ["q8_matmul", "q4_matmul_f32a"])
def test_f32a_wrappers_refuse_bad_operands(fn):
    bits = 8 if fn == "q8_matmul" else 4
    quant = tq.quantize_q8 if bits == 8 else tq.quantize_q4
    w = quant(torch.from_numpy(_w(2, 256, 64)), 64)
    wrapper = getattr(tq, fn)
    with pytest.raises(TypeError):      # f16 activations: no kernel takes them
        wrapper(torch.ones((2, 256), dtype=torch.float16), w.values, w.scales)
    with pytest.raises(ValueError):     # K mismatch
        wrapper(torch.ones((2, 128)), w.values, w.scales)
    with pytest.raises(TypeError):      # the other format's values
        wrong = (w.values.view(torch.uint8) if bits == 8
                 else w.values.view(torch.int8))
        wrapper(torch.ones((2, 256)), wrong, w.scales)


def _route(monkeypatch, values_dtype, m, lever):
    """Call quantized_matmul as if x were on the card, with recorders in
    place of the three kernels and of the plain path; returns the name of
    what ran."""
    calls = []

    def recorder(name):
        def rec(x, *args):
            calls.append(name)
            n = args[0].n if len(args) == 1 else args[0].shape[-1]
            return torch.zeros((x.shape[0], n))
        return rec

    monkeypatch.setattr(tq, "is_cuda", lambda t: True)
    for name in ("q8_matmul", "q4_matmul_f32a", "q4_matmul_w4a8",
                 "quantized_matmul_ref"):
        monkeypatch.setattr(tq, name, recorder(name))
    if lever is None:
        monkeypatch.delenv("TRACKIE_Q4_F32A", raising=False)
    else:
        monkeypatch.setenv("TRACKIE_Q4_F32A", lever)
    quant = tq.quantize_q8 if values_dtype == torch.int8 else tq.quantize_q4
    qw = quant(torch.from_numpy(_w(0, 128, 16)), 64)
    out = tq.quantized_matmul(torch.ones((m, 128)), qw)
    assert out.shape == (m, 16) and len(calls) == 1
    return calls[0]


@pytest.mark.parametrize("values_dtype,m,lever", list(itertools.product(
    [torch.int8, torch.uint8], [1, 512, 513, 1024, 1500], [None, "1", "0"])))
def test_dispatch_routes_like_the_jax_package(monkeypatch, values_dtype, m,
                                              lever):
    """quant.py:562-587 minus the unread levers, on the card's kernels: Q8
    takes its kernel whatever the lever and M; Q4 takes the f32a kernel
    under TRACKIE_Q4_F32A=1 or at M > 512 (where the JAX package multiplies
    the exact activations by the dequantized weights, the function f32a
    computes), and the W4A8 kernel otherwise. Nothing on the card takes
    the plain path, and above 512 rows nothing quantizes the activations
    (only the W4A8 wrapper does)."""
    got = _route(monkeypatch, values_dtype, m, lever)
    if values_dtype == torch.int8:
        want = "q8_matmul"
    elif m > tq.KERNEL_MAX_M or lever == "1":
        want = "q4_matmul_f32a"
    else:
        want = "q4_matmul_w4a8"
    assert got == want
