"""The diagnostic probes and tools of the port, on the CPU.

The JAX package's tools (``tools/diag_*.py``) are not imported: importing
one sets JAX's persistent compile cache, ``stream_pallas`` is jitted at a
fixed 512 MiB with no interpret switch, and the near-empty kernels are
nested inside ``main()``. So the Pallas bodies are restated here, line for
line, and run in interpret mode at small shapes against the port's plain
versions: exact for x + 1, rel 1e-5 for the stream sum (f32 sums in another
order). The tools' measurement functions then run on the CPU at tiny sizes,
for control flow only: a CPU time is no device metric.
"""

import functools
import math
import pathlib
import types

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from trackiellm_tpu_torch.models import llm
from trackiellm_tpu_torch.ops import diag, quant
from trackiellm_tpu_torch.tools import (capture, device_ms, diag_envelope,
                                        diag_overhead, diag_scan_overhead,
                                        host_ms, kernel_times)

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes: one intra-op thread, so this file does not crowd the
    other test workers' CPUs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# tools/diag_envelope.py:41-56, _stream_kernel as it stands.
def _stream_kernel(x_ref, w_ref, o_ref, acc_ref):
    i = pl.program_id(0)

    @pl.when(i == 0)
    def _():
        acc_ref[:] = jnp.zeros_like(acc_ref)

    val = (jnp.sum(w_ref[:].astype(jnp.int32).astype(jnp.float32))
           * x_ref[0, 0])
    acc_ref[:] = acc_ref[:] + val

    @pl.when(i == pl.num_programs(0) - 1)
    def _():
        o_ref[:] = acc_ref[:]


# tools/diag_envelope.py:59-76, stream_pallas at a small (rows, cols) and
# tile_r, in interpret mode.
@functools.partial(jax.jit, static_argnames=("tile_r",))
def _stream_pallas(x, w, tile_r):
    rows, cols = w.shape
    return pl.pallas_call(
        _stream_kernel,
        grid=(rows // tile_r,),
        in_specs=[
            pl.BlockSpec((1, 1), lambda i: (0, 0),
                         memory_space=pltpu.SMEM),
            pl.BlockSpec((tile_r, cols), lambda i: (i, 0),
                         memory_space=pltpu.VMEM),
        ],
        out_specs=pl.BlockSpec((1, 1), lambda i: (0, 0),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((1, 1), jnp.float32),
        scratch_shapes=[pltpu.VMEM((1, 1), jnp.float32)],
        interpret=True,
    )(x, w)


# tools/diag_scan_overhead.py:67-68 and tools/diag_overhead.py:96-97: the
# one body both near-empty kernels run.
def _tiny_kernel(x_ref, o_ref):
    o_ref[:] = x_ref[:] + 1.0


# tools/diag_scan_overhead.py:70-77, grid64, in interpret mode, with the
# grid's length as an argument.
def _grid64(x, steps=64):
    return pl.pallas_call(
        _tiny_kernel,
        grid=(steps,),
        in_specs=[pl.BlockSpec((8, 128), lambda i: (0, 0))],
        out_specs=pl.BlockSpec((8, 128), lambda i: (0, 0)),
        out_shape=jax.ShapeDtypeStruct((8, 128), jnp.float32),
        interpret=True,
    )(x)


# tools/diag_overhead.py:101-110, chain_tiny, with the chain's length as an
# argument, in interpret mode.
def _chain_tiny(x, n):
    def body(x, _):
        y = pl.pallas_call(
            _tiny_kernel,
            out_shape=jax.ShapeDtypeStruct((8, 128), jnp.float32),
            interpret=True,
        )(x)
        return y, ()

    y, _ = jax.lax.scan(body, x, None, length=n)
    return y


@pytest.mark.parametrize("rows,cols,tile_r", [(64, 256, 16), (128, 512, 32)])
def test_stream_matches_the_pallas_body(rows, cols, tile_r):
    rng = np.random.default_rng(rows)
    w = rng.integers(0, 255, (rows, cols)).astype(np.uint8)
    x = rng.standard_normal((1, 1)).astype(np.float32)
    ref = np.asarray(_stream_pallas(jnp.asarray(x), jnp.asarray(w), tile_r))
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    out = diag.stream(tx, tw)
    assert out.shape == (1, 1) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5)
    # The CPU wrapper is the plain version; the exact sum agrees too.
    np.testing.assert_array_equal(out.numpy(), diag.stream_ref(tx, tw).numpy())
    exact = float(w.astype(np.int64).sum()) * float(x[0, 0])
    np.testing.assert_allclose(out.numpy()[0, 0], exact, rtol=1e-5)


def test_grid64_matches_the_pallas_body():
    x = np.random.default_rng(1).standard_normal(diag.TILE).astype(
        np.float32)
    ref = np.asarray(jax.jit(_grid64)(jnp.asarray(x)))
    out = diag.grid64(torch.from_numpy(x))
    np.testing.assert_array_equal(out.numpy(), ref)
    np.testing.assert_array_equal(diag.grid64_ref(torch.from_numpy(x)).numpy(),
                                  ref)


@pytest.mark.parametrize("steps", [1, 2, diag.GRID_STEPS])
def test_grid64_steps_match_a_pallas_grid_as_long(steps):
    """grid64's ``steps`` argument is the TPU grid's length: every step
    writes x + 1, so the plain path's output does not depend on it."""
    x = np.random.default_rng(steps).standard_normal(diag.TILE).astype(
        np.float32)
    ref = np.asarray(jax.jit(_grid64, static_argnums=1)(jnp.asarray(x),
                                                        steps))
    np.testing.assert_array_equal(
        diag.grid64(torch.from_numpy(x), steps).numpy(), ref)
    np.testing.assert_array_equal(
        diag.grid64_ref(torch.from_numpy(x), steps).numpy(), ref)


@pytest.mark.parametrize("n", [1, diag.CHAIN])
def test_chain_tiny_matches_the_pallas_chain(n):
    x = np.random.default_rng(n).standard_normal(diag.TILE).astype(
        np.float32) * 100.0
    ref = np.asarray(jax.jit(_chain_tiny, static_argnums=1)(
        jnp.asarray(x), n))
    out = diag.chain_tiny(torch.from_numpy(x), n)
    np.testing.assert_array_equal(out.numpy(), ref)
    np.testing.assert_array_equal(
        diag.chain_tiny_ref(torch.from_numpy(x), n).numpy(), ref)


@pytest.mark.parametrize("n", [1, 2, 3, diag.CHAIN])
def test_chain_tiny_returns_a_new_tensor(n):
    """Whatever the parity of n, the chain's output is a tensor of its own:
    it neither is nor shares storage with x, and x is left as it was."""
    x = torch.arange(1024, dtype=torch.float32).reshape(diag.TILE)
    before = x.clone()
    out = diag.chain_tiny(x, n)
    assert out is not x and out.data_ptr() != x.data_ptr()
    assert torch.equal(x, before) and torch.equal(out, before + n)


@pytest.mark.parametrize("n", [0, -1])
def test_chain_tiny_refuses_an_empty_chain(n):
    with pytest.raises(ValueError):
        diag.chain_tiny(torch.ones(diag.TILE), n)


def test_probe_operand_checks():
    with pytest.raises(ValueError):
        diag.stream(torch.ones((2, 1)), torch.zeros((4, 4), dtype=torch.uint8))
    with pytest.raises(TypeError):
        diag.stream(torch.ones((1, 1)), torch.zeros((4, 4)))
    with pytest.raises(TypeError):
        diag.grid64(torch.ones(diag.TILE, dtype=torch.float64))
    with pytest.raises(ValueError):
        diag.grid64(torch.ones(diag.TILE), 0)
    with pytest.raises(TypeError):
        diag.chain_tiny(torch.ones((0,)))


def test_cpu_calls_launch_nothing():
    """On the CPU the wrappers take the plain versions: no count moves."""
    counts = (diag.stream.launches, diag.grid64.launches,
              diag.chain_tiny.launches, quant.q4_matmul_stream.launches)
    x = torch.ones(diag.TILE)
    diag.grid64(x)
    diag.chain_tiny(x, 3)
    diag.stream(torch.ones((1, 1)), torch.ones((4, 4), dtype=torch.uint8))
    w = quant.quantize_q4(torch.ones((512, 64)), 64)
    quant.q4_matmul_stream(torch.ones((1, 512)), w.values, w.scales)
    assert counts == (diag.stream.launches, diag.grid64.launches,
                      diag.chain_tiny.launches,
                      quant.q4_matmul_stream.launches)


def test_timing_helpers_on_the_cpu():
    calls = []

    def fn():
        calls.append(1)
        return torch.zeros(1)

    assert capture(fn, CPU) is fn
    assert host_ms(fn, CPU, 3) >= 0 and len(calls) == 4   # warm-up + 3
    assert device_ms(fn, CPU, 2) >= 0 and len(calls) == 7


def test_overhead_tool_control_flow(capsys):
    rows = diag_overhead.tiny(CPU, n_chain=3, n_outer=2)
    assert list(rows) == ["chain from one call", "chain_tiny(x, 1) a launch",
                          "x + 1 a launch"]
    assert all(eager > 0 and graph > 0 for eager, graph in rows.values())
    with pytest.raises(ValueError):     # no stream to read off the card
        diag_overhead.stream_handle_us(CPU)
    out = diag_overhead.q4_sweep(CPU, k=512, n=512, group=64,
                                 sweep=((256, 32), (128, 64), (64, 16)),
                                 n_chain=2, n_outer=1)
    assert [r[2] for r in out["sweep"]] == [16, 16, 128]
    assert len(out["fit"]) == 2 and out["f32a_us"] > 0
    assert len(diag_overhead.rmsnorm(CPU, d=64, n_chain=2, n_outer=1)) == 2
    with pytest.raises(ValueError):
        diag_overhead.q4_sweep(CPU, k=512, n=256)
    text = capsys.readouterr().out
    assert "chain from one call" in text and "fit:" in text


def test_scan_overhead_tool_control_flow():
    out = diag_scan_overhead.run(CPU, scan_lengths=(2, 4), unroll=3,
                                 executions=(1, 2), n_outer=2)
    assert sorted(out) == sorted(["scan2", "scan4", "unroll3", "grid64",
                                  "grid64 1 step", "grid64 64 steps",
                                  "grid step us", "1 exec", "2 exec"])
    # A step's cost is a difference of two times: only its sign is free.
    assert math.isfinite(out.pop("grid step us"))
    assert all(v > 0 for v in out.values())


def test_envelope_tool_control_flow():
    out = diag_envelope.envelope(CPU, rows=16, cols=256, n=2)
    assert out["bytes"] == 16 * 256 and out["rel_err"] <= 1e-5
    assert out["kernel_gb_s"] > 0 and out["plain_gb_s"] > 0


def test_decode_composition_control_flow():
    cfg = llm.LLMConfig.tiny()
    params = llm.init_params_quantized(torch.Generator().manual_seed(0), cfg,
                                       group=64, dtype=torch.float32)
    sliced = diag_envelope.layer_slice(params, 1)
    assert sliced["layers"]["wqkv"].values.shape[0] == 1
    assert (sliced["layers"]["wqkv"].values.data_ptr()
            == params["layers"]["wqkv"].values.data_ptr())   # a view
    out = diag_envelope.decode_composition(
        params, cfg, CPU, layers=(2, 1), prompt=16, attn_len=64, n_tokens=2,
        chunk=2, n_chunks=2)
    assert sorted(out["decode_ms"]) == [1, 2]
    assert out["serial_ms"] == out["decode_ms"][2] and out["greedy_ms"] > 0


@pytest.mark.parametrize("tool", [diag_overhead, diag_scan_overhead,
                                  diag_envelope])
def test_tools_exit_non_zero_without_a_card(tool, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tool.main() != 0
    assert "no CUDA device" in capsys.readouterr().err


def test_kernel_times_exits_non_zero_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert kernel_times.main([]) != 0
    assert "no CUDA device" in capsys.readouterr().err


def test_kernel_times_reads_this_checkouts_chip_smoke():
    """The tool times with the chip_smoke.py beside it, whichever checkout's
    port it imports."""
    cs = kernel_times._chip_smoke()
    assert pathlib.Path(cs.__file__) == kernel_times.CHECKOUT / "chip_smoke.py"
    assert callable(cs.time_ms) and callable(cs.device_only_ms)
    assert set(cs.MISTRAL_SHAPES) >= {"w_gu"}



def test_kernel_times_sums_kernels_whose_cut_names_collide():
    class FakeTimers:
        @staticmethod
        def device_only_ms(fn):
            return {"total": 3.0, "kernels": {"k" * 80: 1.0,
                                              "k" * 72 + "x": 2.0,
                                              "other": 0.5}}

        @staticmethod
        def time_ms(fn):
            return 5.0
    got = kernel_times._times(FakeTimers, lambda: None)
    assert got == {"ms": 5.0, "device_ms": 3.0,
                   "device_kernels": {"k" * 72: 3.0, "other": 0.5}}


def _matmul_rows_on_the_cpu(kind, quantize, kernel):
    """kernel_times.matmul_times at tiny shapes on the CPU (the plain
    path), with fake timers that run each timed function once; the split
    sweep calls the C entry, which the CPU has not, so it is left out."""
    ran = []

    class FakeTimers:
        MISTRAL_SHAPES = {"wo": (128, 64), "w_gu": (128, 256)}
        GROUP = 64

        @staticmethod
        def device_only_ms(fn):
            ran.append(tuple(fn().shape))
            return {"total": 2.0, "kernels": {"k": 2.0}}

        @staticmethod
        def time_ms(fn):
            return 4.0
    got = kernel_times.matmul_times(FakeTimers, kind, quantize, kernel, None,
                                    torch.device("cpu"),
                                    torch.Generator().manual_seed(0))
    return got, ran


def test_kernel_times_q8_rows_on_the_cpu():
    """The Q8 rows: w_gu timed per call and device only, every projection
    at M 1 and 512 beside the dense yardstick, each timed function run
    once; no split rows without a sweep."""
    got, ran = _matmul_rows_on_the_cpu("q8", quant.quantize_q8,
                                       quant.q8_matmul)
    assert got["q8 w_gu M=512"] == {"ms": 4.0, "device_ms": 2.0,
                                    "device_kernels": {"k": 2.0}}
    assert set(got) == {"q8 w_gu M=1", "q8 w_gu M=512",
                        "q8 device_ms wo M=1", "q8 device_ms wo M=512",
                        "q8 device_ms w_gu M=1", "q8 device_ms w_gu M=512"}
    assert got["q8 device_ms wo M=1"] == {"q8": 2.0, "dense_bf16": 2.0}
    assert ran == [(1, 64), (1, 64), (512, 64), (512, 64), (1, 256),
                   (1, 256), (512, 256), (512, 256)]


def test_kernel_times_f32a_rows_on_the_cpu():
    """The f32a rows, as the Q8 rows."""
    got, ran = _matmul_rows_on_the_cpu("f32a", quant.quantize_q4,
                                       quant.q4_matmul_f32a)
    assert got["f32a w_gu M=1"] == {"ms": 4.0, "device_ms": 2.0,
                                    "device_kernels": {"k": 2.0}}
    assert set(got) == {"f32a w_gu M=1", "f32a w_gu M=512",
                        "f32a device_ms wo M=1", "f32a device_ms wo M=512",
                        "f32a device_ms w_gu M=1",
                        "f32a device_ms w_gu M=512"}
    assert got["f32a device_ms wo M=512"] == {"f32a": 2.0,
                                              "dense_bf16": 2.0}
    assert ran == [(1, 64), (1, 64), (512, 64), (512, 64), (1, 256),
                   (1, 256), (512, 256), (512, 256)]


def test_kernel_times_split_sweeps_need_the_plans():
    """A checkout without the bf16 kernels' plans (an older one, timed for
    comparison) gets no split sweep."""
    old = types.SimpleNamespace()
    for kind in ("q8", "f32a"):
        assert kernel_times.group_splits(kind, old, None, None) is None
        assert callable(kernel_times.group_splits(kind, quant, None, None))


def test_kernel_times_fused_rows_on_the_cpu():
    """The fused rows' control flow at a tiny shape on the CPU (both blocks'
    plain paths): the fused block per call and device only at each M, the
    unfused block device only, each timed function run once; the fused
    block equals its plain twin and the unfused block returns x's shape."""
    ran = []

    class FakeTimers:
        FUSED_SHAPE = (256, 512, 128)
        FUSED_MS = (1, 4)

        @staticmethod
        def device_only_ms(fn):
            ran.append(tuple(fn().shape))
            return {"total": 2.0, "kernels": {"k": 2.0}}

        @staticmethod
        def time_ms(fn):
            return 4.0
    from trackiellm_tpu_torch.models import llm
    from trackiellm_tpu_torch.ops import fused
    got = kernel_times.fused_times(FakeTimers, quant, fused, llm,
                                   torch.device("cpu"),
                                   torch.Generator().manual_seed(0))
    assert got == {"fused M=1": {"ms": 4.0, "device_ms": 2.0,
                                 "device_kernels": {"k": 2.0}},
                   "unfused device_ms M=1": 2.0,
                   "fused M=4": {"ms": 4.0, "device_ms": 2.0,
                                 "device_kernels": {"k": 2.0}},
                   "unfused device_ms M=4": 2.0}
    assert ran == [(1, 256), (1, 256), (4, 256), (4, 256)]


class _RowTimers:
    """kernel_times' timers on the CPU: each timed function runs once."""
    MISTRAL_SHAPES = {"wqkv": (512, 96), "wo": (512, 64),
                      "w_gu": (512, 128)}
    GROUP = 64
    MATMUL_TOL = 1e-5
    rel_l2 = staticmethod(lambda a, b: ((a - b).norm() / b.norm()).item())
    ran = []

    @classmethod
    def device_only_ms(cls, fn):
        cls.ran.append(tuple(fn().shape))
        return {"total": 2.0, "kernels": {"k": 2.0}}

    @staticmethod
    def time_ms(fn):
        return 4.0


def test_kernel_times_stream_rows_on_the_cpu():
    """The stream rows' control flow at tiny shapes on the CPU (the plain
    path): every projection at M 1 and 8 in bf16 and f32 per call and
    device only, and the tile sweep on wo and w_gu with refused pairs as
    None."""
    _RowTimers.ran = []
    got = kernel_times.stream_times(_RowTimers, quant, CPU,
                                    torch.Generator().manual_seed(0),
                                    sweep_n=(16, 32), sweep_k=(64, 96))
    sweep = got.pop("stream device_ms by (tile_n, tile_k)")
    assert set(got) == {f"stream {p} M={m} {t}"
                        for p in ("wqkv", "wo", "w_gu") for m in (1, 8)
                        for t in ("bfloat16", "float32")}
    assert got["stream wo M=8 float32"] == {"ms": 4.0, "device_ms": 2.0,
                                           "device_kernels": {"k": 2.0}}
    assert sorted(sweep) == ["w_gu M=1 bfloat16", "w_gu M=1 float32",
                             "wo M=1 bfloat16", "wo M=1 float32"]
    assert sweep["wo M=1 float32"] == {"16,64": 2.0, "16,96": None,
                                       "32,64": 2.0, "32,96": None}
    assert len(_RowTimers.ran) == 12 + 4 * 2


def test_kernel_times_grid_rows_on_the_cpu():
    """grid64 beside tile + 1, and at one step where grid64 takes steps (an
    older checkout's does not)."""
    got = kernel_times.grid_times(_RowTimers, diag, CPU,
                                  torch.Generator().manual_seed(0))
    assert sorted(got) == ["grid64", "grid64 1 step", "tile + 1"]
    old = types.SimpleNamespace(TILE=diag.TILE, grid64=lambda x: x + 1.0)
    got = kernel_times.grid_times(_RowTimers, old, CPU,
                                  torch.Generator().manual_seed(0))
    assert sorted(got) == ["grid64", "tile + 1"]


def test_kernel_times_chain_rows_on_the_cpu():
    """The chain rows: the one-call chain, chain_tiny(x, 1) a launch and
    tile + 1 a launch, each checked against n adds and timed every way."""
    got = kernel_times.chain_times(_RowTimers, diag, CPU,
                                   torch.Generator().manual_seed(0), n=3,
                                   reps=2)
    assert sorted(got) == ["chain chain_tiny",
                           "chain chain_tiny(x, 1) a launch",
                           "chain tile + 1 a launch"]
    for row in got.values():
        assert set(row) == {"ms", "device_ms", "device_kernels", "event_ms",
                            "host_ms", "graph_ms"}
        assert min(row["event_ms"], row["host_ms"], row["graph_ms"]) > 0
