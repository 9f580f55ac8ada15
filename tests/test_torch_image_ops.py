"""The port's image and tensor op libraries (``ops/image.py``,
``ops/tensor.py``) against the JAX package's, on the CPU.

Every public function of both modules takes the same seeded numpy inputs
on both sides (images 24x32, NCHW 2x3x9x10). Tolerances, absolute: the
morphology, the histogram and max pooling are bit-equal (``EXACT``: the
same f32 comparisons and counts); the convolutions, blurs, Sobel,
Harris, the bilateral filter, the color spaces (a 3-term sum or a
division one ulp apart), average pooling and the norms within ``CONV`` (1e-5: XLA and oneDNN order a window's sums apart); the
matmuls within ``MATMUL`` (1e-4 at K = 1,000: f32 sums of 1,000 products
in another order).
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from trackiellm_tpu.ops import image as jim
from trackiellm_tpu.ops import tensor as jt
from trackiellm_tpu_torch.ops import image as tim
from trackiellm_tpu_torch.ops import tensor as tt

CPU = torch.device("cpu")
EXACT = 0.0
CONV = 1e-5
MATMUL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _img(seed, *shape):
    return np.random.default_rng(seed).random(shape).astype(np.float32)


def _check(got, want, atol):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, (
        got.shape, want.shape, got.dtype, want.dtype)
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


GRAY, RGB = _img(1, 24, 32), _img(2, 24, 32, 3)
EDGE = np.zeros((16, 16), np.float32)
EDGE[:, 8:] = 1.0
KERNEL = np.random.default_rng(3).standard_normal((3, 5)).astype(np.float32)

# (name, args, tolerance); each function is called with the same args on
# both sides (numpy on the port's side, placed on the CPU).
IMAGE_CASES = [
    ("conv2d", (GRAY, KERNEL), CONV),
    ("conv2d", (RGB, KERNEL), CONV),
    ("gaussian_blur", (GRAY, 1.0), CONV),
    ("gaussian_blur", (RGB, 1.5), CONV),
    ("sobel", (GRAY,), CONV),
    ("harris_corners", (GRAY,), CONV),
    ("bilateral_filter", (EDGE, 2.0, 0.05, 2), CONV),
    ("bilateral_filter", (GRAY,), CONV),
    ("dilate", (GRAY, 3), EXACT),
    ("erode", (GRAY, 5), EXACT),
    ("morph_open", (GRAY, 3), EXACT),
    ("morph_close", (GRAY, 3), EXACT),
    ("rgb_to_gray", (RGB,), CONV),
    ("rgb_to_hsv", (RGB,), CONV),
    ("rgb_to_yuv", (RGB,), CONV),
    ("histogram", (GRAY, 64), EXACT),
    ("equalize_histogram", (0.1 * GRAY,), EXACT),
]


@pytest.mark.parametrize("name,args,tol", IMAGE_CASES,
                         ids=[f"{c[0]}-{i}" for i, c in
                              enumerate(IMAGE_CASES)])
def test_image_op_matches_jax(name, args, tol):
    want = getattr(jim, name)(*[jnp.asarray(a) if isinstance(a, np.ndarray)
                                else a for a in args])
    got = getattr(tim, name)(*args, device=CPU)
    if isinstance(want, tuple):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _check(g, w, tol)
    else:
        _check(got, want, tol)


def test_image_ops_keep_a_tensor_on_its_device():
    """A tensor input stays where it is; numpy goes to the device asked
    for, and a numpy input without one needs the card."""
    x = torch.from_numpy(GRAY)
    assert tim.dilate(x).device == CPU
    if not torch.cuda.is_available():
        with pytest.raises(Exception, match="no CUDA device"):
            tim.dilate(GRAY)


def test_all_image_functions_are_covered():
    """The fourteen public functions of the JAX module, each in a case."""
    public = {n for n in ("conv2d", "gaussian_blur", "sobel",
                          "harris_corners", "bilateral_filter", "dilate",
                          "erode", "morph_open", "morph_close",
                          "rgb_to_gray", "rgb_to_hsv", "rgb_to_yuv",
                          "histogram", "equalize_histogram")}
    assert {c[0] for c in IMAGE_CASES} == public
    assert all(hasattr(tim, n) for n in public)


def _nchw(seed):
    return np.random.default_rng(seed).standard_normal(
        (2, 3, 9, 10)).astype(np.float32)


A = np.random.default_rng(5).standard_normal((16, 1000)).astype(np.float32)
B = np.random.default_rng(6).standard_normal((1000, 32)).astype(np.float32)
W = np.random.default_rng(7).standard_normal((4, 3, 3, 3)).astype(
    np.float32)
WG = np.random.default_rng(8).standard_normal((3, 1, 3, 3)).astype(
    np.float32)
X = _nchw(9)
VEC = [np.random.default_rng(10 + i).standard_normal(3).astype(np.float32)
       for i in range(4)]
ROWS = np.random.default_rng(14).standard_normal((4, 64)).astype(np.float32)
SCALE = np.random.default_rng(15).standard_normal(64).astype(np.float32)
BIAS = np.random.default_rng(16).standard_normal(64).astype(np.float32)

# (name, args, kwargs, tolerance)
TENSOR_CASES = [
    ("matmul", (A[:, :64], B[:64]), {}, MATMUL),
    ("matmul_blocked", (A, B), {"block": 256}, MATMUL),
    ("matmul_blocked", (A[:, :100], B[:100]), {"block": 256}, MATMUL),
    ("conv2d", (X, W), {}, CONV),
    ("conv2d", (X, W), {"stride": 2}, CONV),
    ("conv2d", (X, W), {"padding": "VALID"}, CONV),
    ("conv2d", (X, WG), {"groups": 3}, CONV),
    ("max_pool2d", (X,), {}, EXACT),
    ("max_pool2d", (X,), {"size": 3, "stride": 2}, EXACT),
    ("avg_pool2d", (X,), {}, CONV),
    ("avg_pool2d", (X,), {"size": 3, "stride": 2}, CONV),
    ("batch_norm", (X, VEC[0], np.abs(VEC[1]), VEC[2], VEC[3]), {}, CONV),
    ("layer_norm", (ROWS, SCALE, BIAS), {}, CONV),
    ("rms_norm", (ROWS, SCALE), {}, CONV),
]


@pytest.mark.parametrize("name,args,kw,tol", TENSOR_CASES,
                         ids=[f"{c[0]}-{i}" for i, c in
                              enumerate(TENSOR_CASES)])
def test_tensor_op_matches_jax(name, args, kw, tol):
    want = getattr(jt, name)(*[jnp.asarray(a) for a in args], **kw)
    got = getattr(tt, name)(*[torch.from_numpy(a) for a in args], **kw)
    _check(got, want, tol)


def test_all_tensor_functions_are_covered():
    """The eight public functions of the JAX module besides its one-line
    aliases, each in a case."""
    public = {"matmul", "matmul_blocked", "conv2d", "max_pool2d",
              "avg_pool2d", "batch_norm", "layer_norm", "rms_norm"}
    assert {c[0] for c in TENSOR_CASES} == public


def test_bf16_matmul_sums_in_f32():
    """bf16 inputs give an f32 result with f32 sums, as the JAX op's
    ``preferred_element_type``."""
    a = torch.from_numpy(A[:, :64]).to(torch.bfloat16)
    b = torch.from_numpy(B[:64]).to(torch.bfloat16)
    got = tt.matmul(a, b)
    want = np.asarray(jt.matmul(jnp.asarray(a.float().numpy(), jnp.bfloat16),
                                jnp.asarray(b.float().numpy(), jnp.bfloat16)))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=MATMUL)
