"""Parity of the streaming Q4 matmul with ``q4_matmul_pallas_v2``.

``trackiellm_tpu_torch.ops.quant.q4_matmul_stream`` on a CPU tensor takes
its plain version, which is held here against the Pallas kernel itself in
interpret mode on the same weight bytes: rel L2 1e-5 (the same products,
f32 sums in another order). The tile rule (v2's asserts, raised as
ValueError, plus the card's: power-of-two tile_n, groups of 32 rows, and the
ring's shared memory) holds on the CPU too, and the ring's plan is checked
here against what the card's kernel needs.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from trackiellm_tpu.ops import quant as jq
from trackiellm_tpu_torch.ops import quant as tq

TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small shapes: one intra-op thread, so this file does not crowd the
    other test workers' CPUs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _operands(seed, m, k, n, group):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((k, n)).astype(np.float32)
    x = rng.standard_normal((m, k)).astype(np.float32)
    jw = jq.quantize_q4(jnp.asarray(w), group)
    tw = tq.quantize_q4(torch.from_numpy(w), group)
    np.testing.assert_array_equal(tw.values.numpy(), np.asarray(jw.values))
    return x, jw, tw


# (M, K, N, G, tile_n, tile_k): the JAX package's own v2 test shape
# (tests/test_ops.py:TestQ4StreamKernel), then G=256 at decode's M.
CASES = [(8, 1024, 512, 128, 256, 128),
         (1, 1024, 512, 256, 128, 256),
         (8, 1024, 512, 256, 128, 256),
         (8, 2048, 256, 256, 64, 512),
         (1, 1024, 512, 256, tq._stream_tile_n(512), tq.STREAM_TILE_K)]


@pytest.mark.parametrize("m,k,n,group,tile_n,tile_k", CASES)
def test_stream_matches_pallas_v2_interpret(m, k, n, group, tile_n, tile_k):
    x, jw, tw = _operands(m + k + group, m, k, n, group)
    ref = np.asarray(jq.q4_matmul_pallas_v2(
        jnp.asarray(x), jw.values, jw.scales, tile_n=tile_n, tile_k=tile_k,
        interpret=True))
    out = tq.q4_matmul_stream(torch.from_numpy(x), tw.values, tw.scales,
                              tile_n=tile_n, tile_k=tile_k)
    assert out.dtype == torch.float32 and out.shape == (m, n)
    assert _rel_l2(out.numpy(), ref) < TOL
    # The CPU wrapper takes the plain version, whatever the tiles.
    np.testing.assert_array_equal(
        out.numpy(), tq.q4_matmul_stream_ref(torch.from_numpy(x), tw.values,
                                             tw.scales).numpy())
    np.testing.assert_array_equal(
        out.numpy(), tq.q4_matmul_stream(torch.from_numpy(x), tw.values,
                                         tw.scales).numpy())


def test_stream_bf16_activations_follow_the_f32_path():
    """bf16 x is widened to f32 as it is read, as v2 casts it."""
    x, jw, tw = _operands(9, 4, 1024, 256, 128)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    ref = np.asarray(jq.q4_matmul_pallas_v2(
        jnp.asarray(xb.float().numpy()), jw.values, jw.scales, tile_n=128,
        tile_k=256, interpret=True))
    out = tq.q4_matmul_stream(xb, tw.values, tw.scales)
    assert _rel_l2(out.numpy(), ref) < TOL


def test_stream_matches_the_xla_oracle():
    x, jw, tw = _operands(3, 5, 1024, 384, 256)
    ref = np.asarray(jq.quantized_matmul_xla(jnp.asarray(x), jw))
    out = tq.q4_matmul_stream(torch.from_numpy(x), tw.values, tw.scales)
    assert _rel_l2(out.numpy(), ref) < TOL


@pytest.mark.parametrize("tile_n,tile_k,why", [
    (128, 96, "tile_k does not divide K/2"),
    (640, 256, "n % tile_n"),
    (128, 128, "tile_k % g"),
    (48, 256, "not a power of two"),
    (8, 256, "below 16"),
    (1024, 512, "staging exceeds shared memory"),
])
def test_stream_tile_rule_raises(tile_n, tile_k, why):
    _, _, tw = _operands(1, 1, 2048, 3072, 256)
    x = torch.ones((1, 2048))
    with pytest.raises(ValueError):
        tq.q4_matmul_stream(x, tw.values, tw.scales, tile_n=tile_n,
                            tile_k=tile_k)


def test_stream_tiles_clamp_to_the_matrix():
    """As v2 does, tiles larger than the matrix are cut to it."""
    assert tq._stream_tiles(512, 64, 64, 4096, 4096) == (64, 256)
    assert tq._stream_tiles(4096, 4096, 256, tq.STREAM_TILE_N,
                            tq.STREAM_TILE_K) == (tq.STREAM_TILE_N,
                                                  tq.STREAM_TILE_K)
    assert 2 * tq.STREAM_TILE_K * tq.STREAM_TILE_N <= tq.STREAM_SMEM


def test_stream_operand_checks():
    _, _, tw = _operands(2, 1, 1024, 256, 128)
    with pytest.raises(ValueError):      # K mismatch
        tq.q4_matmul_stream(torch.ones((1, 512)), tw.values, tw.scales)
    with pytest.raises(TypeError):
        tq.q4_matmul_stream(torch.ones((1, 1024), dtype=torch.float16),
                            tw.values, tw.scales)


def test_stream_needs_groups_of_32_rows():
    """The bf16 kernel walks a group in 32-row units: G % 32 != 0 is
    refused on either device."""
    with pytest.raises(ValueError):
        tq._stream_tiles(512, 64, 16, 16, 256)
    w = tq.quantize_q4(torch.ones((512, 64)), 16)
    with pytest.raises(ValueError):
        tq.q4_matmul_stream(torch.ones((1, 512)), w.values, w.scales,
                            tile_n=16, tile_k=64)


def test_stream_tiles_depend_on_the_rows_of_x():
    """The ring's x rows count against shared memory: a tile pair that fits
    one f32 row of x may not fit 16 bf16 rows."""
    assert tq._stream_tiles(4096, 4096, 256, 64, 1024, 1, 4) == (64, 1024)
    with pytest.raises(ValueError):
        tq._stream_tiles(4096, 4096, 256, 64, 1024, 16, 2)


MISTRAL = {"wqkv": (4096, 6144), "wo": (4096, 4096), "w_gu": (4096, 28672),
           "w_down": (14336, 4096), "lm_head": (4096, 32000)}


@pytest.mark.parametrize("m,x_bytes", [(1, 2), (8, 2), (20, 2), (1, 4),
                                       (8, 4)])
@pytest.mark.parametrize("name", sorted(MISTRAL))
def test_stream_plan_at_the_defaults(name, m, x_bytes):
    """At the card defaults every SM has a block, the ring fits a block,
    holds at least two stages, and at M <= 8 keeps 32 KiB of packed weights
    in flight a block (all of them where a block streams less): at N = 4096
    about two blocks an SM, so well over 24 KiB in flight on each SM."""
    k, n = MISTRAL[name]
    tile_n, tile_k = tq._stream_tiles(k, n, 256, tq._stream_tile_n(n),
                                      tq.STREAM_TILE_K, m, x_bytes)
    stages, smem = tq._stream_plan(m, k, 256, tile_n, tile_k, x_bytes)
    chunks = k // 2 // tile_k
    assert 2 <= stages <= min(chunks, tq.STREAM_MAX_STAGES)
    assert smem <= tq.STREAM_SMEM
    if m <= 8:
        assert stages * tile_k * tile_n >= min(tq.STREAM_RING,
                                               chunks * tile_k * tile_n)
    assert n // tile_n >= 132         # every SM has a block


@pytest.mark.parametrize("n,tile_n", [(4096, 16), (6144, 32), (28672, 128),
                                      (32000, 128), (8448, 64), (2048, 16),
                                      (48, 16)])
def test_stream_default_tile_n(n, tile_n):
    """The widest of 128 down to 16 that divides N with a block on each of
    the 132 SMs; 16 where none does."""
    assert tq._stream_tile_n(n) == tile_n
    assert tq._stream_tile_n(n, sms=1) == (128 if n % 128 == 0 else 16)


def test_stream_plan_counts_what_a_stage_holds():
    """One stage of 256 packed rows x 16 columns with one bf16 row of x
    (two 512-byte halves, each padded by 16) and one group's two scale rows:
    4096 + 1056 + 128 bytes; 8 stages hold 32 KiB of packed weights, after
    the kernel's 2 KiB of barriers and alignment."""
    stages, smem = tq._stream_plan(1, 4096, 256, 16, 256, 2)
    assert stages == 8 and smem == 2048 + 8 * (4096 + 1056 + 128)
    # K/2 of one stage: one stage; of two: both.
    assert tq._stream_plan(1, 512, 256, 16, 256, 2)[0] == 1
    assert tq._stream_plan(1, 1024, 256, 16, 256, 2)[0] == 2
    # Two stages at least, even where they do not fit (_stream_tiles then
    # refuses the tiles).
    stages, smem = tq._stream_plan(16, 8192, 256, 64, 1024, 2)
    assert stages == 2 and smem > tq.STREAM_SMEM
    # f32 x: the epilogue's row-slice sums may outgrow the ring.
    stages, smem = tq._stream_plan(8, 1024, 256, 1024, 256, 4)
    assert smem == 2048 + max(stages * (256 * 1024 + 2 * 8 * (1024 + 16)
                                        + 2 * 1024 * 4),
                              2 * 8 * 1024 * 4)
