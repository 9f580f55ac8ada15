"""The port's embeddable C ABI (trackie_ffi.{h,cpp} via ffi/embed.py):
the JAX package's tests/test_ffi_embed.py on ``trackiellm_tpu_torch``
(tensor create/reshape/fill/add/matmul, media handles, module
registration, sync and async command execution; executors get their input
as a tensor on the CPU here, asked for with ``device="cpu"``; the library
is built here, with no skip where it fails: ``tests/test_torch_ffi.py``
asserts that it builds), then what
the port adds: a frame handed over as a ``NativeVisionFrame`` to an
executor that runs the port's ``VisionPipeline`` (``embed.vision_module``)
gives the direct ``process_frame``'s packed result bit for bit, through
``execute`` and ``execute_async``, and the JAX package's embed route's
objects and distances within the vision path's tolerance.
"""

import threading

import numpy as np
import pytest

import torch

from trackiellm_tpu_torch.ffi import embed

CPU = torch.device("cpu")


def test_version():
    assert embed.version().startswith("2.")
    assert embed.version().endswith("-cuda")


def test_tensor_roundtrip_and_reshape():
    a = np.arange(12, dtype=np.float32).reshape(3, 4)
    t = embed.NativeTensor.from_numpy(a)
    assert t.shape == (3, 4)
    np.testing.assert_array_equal(t.to_numpy(), a)
    t.reshape((4, 3))
    assert t.shape == (4, 3)
    with pytest.raises(Exception):
        t.reshape((5, 5))  # element count mismatch
    t.close()


def test_tensor_fill_add():
    t = embed.NativeTensor(embed.TK_F32, (2, 3)).fill(2.5)
    u = embed.NativeTensor(embed.TK_F32, (2, 3)).fill(0.5)
    s = t.add(u)
    np.testing.assert_allclose(s.to_numpy(), np.full((2, 3), 3.0))
    i = embed.NativeTensor(embed.TK_I32, (4,)).fill(7)
    np.testing.assert_array_equal(i.to_numpy(), np.full((4,), 7, np.int32))


@pytest.mark.parametrize("blocked", [False, True])
def test_tensor_matmul_matches_numpy(blocked):
    rng = np.random.default_rng(0)
    a = rng.standard_normal((17, 33)).astype(np.float32)
    b = rng.standard_normal((33, 9)).astype(np.float32)
    ta = embed.NativeTensor.from_numpy(a)
    tb = embed.NativeTensor.from_numpy(b)
    c = ta.matmul(tb, blocked=blocked, block_size=8)
    np.testing.assert_allclose(c.to_numpy(), a @ b, rtol=1e-5, atol=1e-5)


def test_matmul_shape_error():
    ta = embed.NativeTensor(embed.TK_F32, (2, 3)).fill(1)
    tb = embed.NativeTensor(embed.TK_F32, (4, 2)).fill(1)
    with pytest.raises(Exception):
        ta.matmul(tb)


def test_audio_stream_fifo():
    s = embed.NativeAudioStream(sample_rate=16000, channels=1,
                                capacity_frames=100)
    x = np.linspace(-1, 1, 80, dtype=np.float32)
    assert s.write(x) == 80
    assert s.write(np.zeros(50, np.float32)) == 20  # capacity clamps
    got = s.read(64)
    np.testing.assert_allclose(got, x[:64])
    s.reset()
    assert s.read(10).size == 0
    s.close()


def test_vision_frame_roundtrip():
    f = embed.NativeVisionFrame(8, 4, fmt=embed.NativeVisionFrame.FMT_RGB24)
    fmt, w, h = f.info
    assert (fmt, w, h) == (1, 8, 4)
    pix = np.arange(8 * 4 * 3, dtype=np.uint8).reshape(4, 8, 3)
    f.write(pix)
    np.testing.assert_array_equal(f.read(), pix)
    f.close()


def test_module_sync_command():
    ctx = embed.NativeContext()

    def double(command, arr):
        assert command == "double"
        return arr * 2.0

    ctx.register_python_module(10, double, device=CPU)  # TK_MODULE_VISION
    out = ctx.execute(10, "double", np.ones((2, 2), np.float32))
    np.testing.assert_allclose(out, np.full((2, 2), 2.0))
    ctx.close()


def test_module_not_registered():
    ctx = embed.NativeContext()
    with pytest.raises(Exception):
        ctx.execute(40, "anything")
    ctx.close()


def test_module_async_callback():
    ctx = embed.NativeContext()
    done = threading.Event()
    results = []

    def negate(command, arr):
        return -arr

    ctx.register_python_module(20, negate, device=CPU)

    def cb(status, arr):
        results.append((status, arr))
        done.set()

    ctx.execute_async(20, "neg", np.arange(4, dtype=np.float32), cb)
    assert done.wait(timeout=10.0)
    status, arr = results[0]
    assert status == 0
    np.testing.assert_allclose(arr, -np.arange(4, dtype=np.float32))
    ctx.drain()
    ctx.close()


def test_module_executor_error_propagates():
    ctx = embed.NativeContext()

    def boom(command, arr):
        raise RuntimeError("nope")

    ctx.register_python_module(30, boom, device=CPU)
    with pytest.raises(Exception):
        ctx.execute(30, "x")
    ctx.close()


def test_commandless_result_none():
    ctx = embed.NativeContext()
    calls = []

    def sink(command, arr):
        calls.append(command)
        return None

    ctx.register_python_module(0, sink, device=CPU)
    assert ctx.execute(0, "ping") is None
    assert calls == ["ping"]
    ctx.close()


# --- what the port adds ---------------------------------------------------------

def test_executor_input_is_a_tensor_on_the_asked_device():
    ctx = embed.NativeContext()
    seen = []

    def probe(command, t):
        seen.append((type(t), t.device, t.dtype))
        return t.sum(0, keepdim=True)

    ctx.register_python_module(11, probe, device=CPU)
    out = ctx.execute(11, "sum", torch.arange(6, dtype=torch.float32
                                              ).reshape(2, 3))
    np.testing.assert_array_equal(out, [[3.0, 5.0, 7.0]])
    assert seen == [(torch.Tensor, CPU, torch.float32)]
    ctx.close()


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is here")
def test_executor_device_defaults_to_the_card():
    ctx = embed.NativeContext()
    with pytest.raises(Exception, match="no CUDA device"):
        ctx.register_python_module(12, lambda c, t: t)
    ctx.close()


def test_vision_frame_becomes_a_tensor():
    f = embed.NativeVisionFrame(6, 5)
    pix = np.random.default_rng(0).integers(0, 256, (5, 6, 3), np.uint8)
    f.write(pix)
    t = embed.NativeTensor.from_vision_frame(f)
    assert t.shape == (5, 6, 3) and t.dtype_id == embed.TK_U8
    np.testing.assert_array_equal(t.to_numpy(), pix)
    assert torch.equal(t.to_torch(CPU), torch.from_numpy(pix))
    t.close()
    f.close()


def _tiny_pipelines(n):
    """``n`` port pipelines and one JAX pipeline over the same tiny
    detector and MiDaS weights (tests/test_torch_vision.py's)."""
    import jax.numpy as jnp  # noqa: F401  (the JAX side's arrays)

    from tests.test_torch_vision import jtree, np_tree
    from trackiellm_tpu.models import depth as jdepth
    from trackiellm_tpu.models import detector as jdet
    from trackiellm_tpu.vision import pipeline as jpipe
    from trackiellm_tpu_torch.models import depth as tdepth
    from trackiellm_tpu_torch.models import detector as tdet
    from trackiellm_tpu_torch.vision import pipeline as tpipe

    dcfg, pcfg = jdet.DetectorConfig.tiny(), jdepth.DepthConfig.tiny()
    dtree = np_tree(jdet.init_detector, dcfg, 20, scale=3.0)
    ptree = np_tree(jdepth.init_depth, pcfg, 2)
    jd, jp = jtree(dtree), jtree(ptree)
    td, tp = tdet.params_from_jax(dtree, CPU), tdepth.params_from_jax(
        ptree, CPU)
    conf = dict(detector_input=dcfg.img_size, depth_input=pcfg.img_size,
                confidence_threshold=0.55, max_objects=6,
                labels=tuple(f"c{i}" for i in range(dcfg.num_classes)))
    tcfg_d, tcfg_p = tdet.DetectorConfig.tiny(), tdepth.DepthConfig.tiny()
    ports = [tpipe.VisionPipeline(
        lambda chw: tdet.detector_forward(td, tcfg_d, chw),
        lambda chw: tdepth.depth_forward(tp, tcfg_p, chw),
        config=tpipe.VisionConfig(**conf), device=CPU) for _ in range(n)]
    ref = jpipe.VisionPipeline(
        lambda chw: jdet.detector_forward(jd, dcfg, chw),
        lambda chw: jdepth.depth_forward(jp, pcfg, chw),
        config=jpipe.VisionConfig(**conf))
    return ports, ref


def _frame():
    from tests.test_torch_vision import _fixture, _fixture_frame
    return _fixture_frame(_fixture())


def test_vision_module_equals_the_direct_call():
    """The frame goes in as a NativeVisionFrame, through ``execute`` and
    ``execute_async`` + ``drain``; each packed result is the direct
    ``process_frame``'s bit for bit (each path on a fresh pipeline)."""
    (direct, sync, asyn), _ = _tiny_pipelines(3)
    frame = _frame()
    want = embed.pack_vision_result(direct.process_frame(frame))
    assert want[0, 1] > 0, "the tiny detector found nothing"
    h, w = frame.shape[:2]
    vf = embed.NativeVisionFrame(w, h)
    vf.write(frame)
    t = embed.NativeTensor.from_vision_frame(vf)
    ctx = embed.NativeContext()
    ctx.register_python_module(embed.TK_MODULE_VISION,
                               embed.vision_module(sync), device=CPU)
    got = ctx.execute(embed.TK_MODULE_VISION, "process_frame", t)
    np.testing.assert_array_equal(got, want)
    ctx.unregister_module(embed.TK_MODULE_VISION)
    ctx.register_python_module(embed.TK_MODULE_VISION,
                               embed.vision_module(asyn), device=CPU)
    results = []
    ctx.execute_async(embed.TK_MODULE_VISION, "process_frame", t,
                      lambda status, arr: results.append((status, arr)))
    ctx.drain()
    assert results[0][0] == 0
    np.testing.assert_array_equal(results[0][1], want)
    with pytest.raises(Exception):
        ctx.execute(embed.TK_MODULE_VISION, "no such command", t)
    ctx.close()
    t.close()
    vf.close()


def test_vision_module_matches_the_jax_embed_route():
    """The JAX package's NativeContext with an executor over its
    VisionPipeline, the same weights and frame: the port's objects within
    the vision path's tolerance (tests/test_torch_vision.py)."""
    from trackiellm_tpu.ffi import embed as jembed
    (port,), ref = _tiny_pipelines(1)
    frame = _frame()
    jctx = jembed.NativeContext()
    jctx.register_python_module(
        10, lambda c, arr: embed.pack_vision_result(ref.process_frame(arr)))
    want = jctx.execute(10, "process_frame", frame)
    jctx.close()
    ctx = embed.NativeContext()
    ctx.register_python_module(10, embed.vision_module(port), device=CPU)
    got = ctx.execute(10, "process_frame", frame)
    ctx.close()
    assert got.shape == want.shape and want[0, 1] > 0
    np.testing.assert_array_equal(got[:, 0], want[:, 0])  # bits, class ids
    np.testing.assert_allclose(got[1:, 1], want[1:, 1], atol=1e-5)
    np.testing.assert_allclose(got[1:, 2:6], want[1:, 2:6], atol=1e-3)
    np.testing.assert_allclose(got[1:, 6:], want[1:, 6:], atol=1e-4)
