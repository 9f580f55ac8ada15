"""Image-processing op library: the JAX package's ``ops/image.py`` in
plain torch ops on the tensor's own device.

Separable convolution, Sobel, Harris corners, the bilateral filter,
morphology, color-space conversion, the histogram and its equalization
(the reference's per-GPU image extensions, ``tk_cuda_image_ops.cu``).
Images are f32, HW (grayscale) or HWC, channels-last; an array that is not
a tensor is placed on ``device`` (the CUDA card unless one is given,
``ops/backend.py:default_device``). Convolutions and the color-space
products sum in full f32 (``exact_f32``: no TF32 on the card), as the JAX
ops do. No JAX path but the ops tests calls these, and none reaches a
Pallas kernel.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from trackiellm_tpu_torch.ops.backend import default_device, exact_f32


def _t(img, device=None) -> torch.Tensor:
    """``img`` as an f32 tensor: a tensor stays on its device, anything
    else goes to ``device``."""
    if isinstance(img, torch.Tensor):
        return img.float()
    return torch.as_tensor(np.asarray(img, np.float32),
                           device=default_device(device, "run an image op"))


# -- separable convolution -------------------------------------------------

def _conv2d_single(img: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """'same' 2-D correlation of an (H, W) image with reflect padding."""
    kh, kw = kernel.shape
    pad = (kw // 2, (kw - 1) // 2, kh // 2, (kh - 1) // 2)
    img_p = F.pad(img[None, None], pad, mode="reflect")
    with exact_f32():
        return F.conv2d(img_p, kernel[None, None].to(img))[0, 0]


def conv2d(img, kernel, device=None) -> torch.Tensor:
    """'same' convolution; HW or HWC (kernel applied per channel)."""
    img = _t(img, device)
    kernel = torch.as_tensor(kernel, dtype=img.dtype, device=img.device)
    if img.dim() == 2:
        return _conv2d_single(img, kernel)
    return torch.stack(
        [_conv2d_single(img[..., c], kernel) for c in range(img.shape[-1])],
        dim=-1)


@functools.lru_cache(maxsize=16)
def _gauss_kernel_1d(sigma: float, radius: int) -> np.ndarray:
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def gaussian_blur(img, sigma: float = 1.5, device=None) -> torch.Tensor:
    """Separable Gaussian blur (two 1-D passes)."""
    img = _t(img, device)
    radius = max(1, int(3.0 * sigma + 0.5))
    k = torch.from_numpy(_gauss_kernel_1d(float(sigma), radius)).to(
        img.device)
    img = conv2d(img, k[None, :])
    return conv2d(img, k[:, None])


# -- gradients / corners -----------------------------------------------------

_SOBEL_X = np.array([[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]], np.float32)


def sobel(img, device=None):
    """Sobel gradients: returns (gx, gy, magnitude) for an (H, W) image."""
    img = _t(img, device)
    sx = torch.from_numpy(_SOBEL_X).to(img.device)
    gx = _conv2d_single(img, sx)
    gy = _conv2d_single(img, sx.t().contiguous())
    return gx, gy, torch.sqrt(gx * gx + gy * gy)


def harris_corners(img, k: float = 0.04, sigma: float = 1.0,
                   device=None) -> torch.Tensor:
    """Harris corner response map (tk_cuda_image_ops.cu Harris)."""
    gx, gy, _ = sobel(img, device)
    ixx = gaussian_blur(gx * gx, sigma)
    iyy = gaussian_blur(gy * gy, sigma)
    ixy = gaussian_blur(gx * gy, sigma)
    det = ixx * iyy - ixy * ixy
    trace = ixx + iyy
    return det - k * trace * trace


# -- bilateral -----------------------------------------------------------------

def bilateral_filter(img, sigma_space: float = 2.0, sigma_color: float = 0.1,
                     radius: int = 3, device=None) -> torch.Tensor:
    """Edge-preserving bilateral filter on an (H, W) image by shifted
    accumulation over the (2r+1)^2 shifts (wrapping at the borders)."""
    img = _t(img, device)
    acc = torch.zeros_like(img)
    norm = torch.zeros_like(img)
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            shifted = torch.roll(img, (dy, dx), dims=(0, 1))
            w_space = float(np.exp(np.float32(
                -0.5 * (dy * dy + dx * dx) / sigma_space ** 2)))
            diff = shifted - img
            w = w_space * torch.exp(-0.5 * (diff / sigma_color) ** 2)
            acc = acc + w * shifted
            norm = norm + w
    return acc / torch.clamp(norm, min=1e-9)


# -- morphology ------------------------------------------------------------------

def _morph(img: torch.Tensor, size: int, is_dilate: bool) -> torch.Tensor:
    """A size x size max (dilate) or min (erode) window, stride 1, padded
    by size // 2 on each side with the op's identity (+-inf)."""
    pad = size // 2
    x = img if is_dilate else -img
    x = F.pad(x[None, None], (pad, pad, pad, pad), value=-float("inf"))
    out = F.max_pool2d(x, size, stride=1)[0, 0]
    return out if is_dilate else -out


def dilate(img, size: int = 3, device=None) -> torch.Tensor:
    return _morph(_t(img, device), size, True)


def erode(img, size: int = 3, device=None) -> torch.Tensor:
    return _morph(_t(img, device), size, False)


def morph_open(img, size: int = 3, device=None) -> torch.Tensor:
    return _morph(_morph(_t(img, device), size, False), size, True)


def morph_close(img, size: int = 3, device=None) -> torch.Tensor:
    return _morph(_morph(_t(img, device), size, True), size, False)


# -- color space --------------------------------------------------------------------

def rgb_to_gray(img, device=None) -> torch.Tensor:
    """ITU-R BT.601 luma."""
    img = _t(img, device)
    with exact_f32():
        return img @ torch.tensor([0.299, 0.587, 0.114], dtype=img.dtype,
                                  device=img.device)


def rgb_to_hsv(img, device=None) -> torch.Tensor:
    img = _t(img, device)
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    mx = img.amax(dim=-1)
    mn = img.amin(dim=-1)
    d = mx - mn
    safe_d = torch.clamp(d, min=1e-9)
    h = torch.where(
        mx == r, torch.remainder((g - b) / safe_d, 6.0),
        torch.where(mx == g, (b - r) / safe_d + 2.0, (r - g) / safe_d + 4.0),
    ) / 6.0
    h = torch.where(d <= 1e-9, torch.zeros_like(h), h)
    s = torch.where(mx <= 1e-9, torch.zeros_like(mx),
                    d / torch.clamp(mx, min=1e-9))
    return torch.stack([h, s, mx], dim=-1)


def rgb_to_yuv(img, device=None) -> torch.Tensor:
    img = _t(img, device)
    m = torch.tensor(
        [[0.299, 0.587, 0.114],
         [-0.14713, -0.28886, 0.436],
         [0.615, -0.51499, -0.10001]], dtype=img.dtype, device=img.device)
    with exact_f32():
        return img @ m.t()


# -- histogram ----------------------------------------------------------------------

def histogram(img, bins: int = 256, device=None) -> torch.Tensor:
    """Intensity histogram of a [0,1] image, int32 counts."""
    img = _t(img, device)
    idx = torch.clamp((img * bins).to(torch.int32), 0, bins - 1).reshape(-1)
    return torch.bincount(idx.long(), minlength=bins).to(torch.int32)


def equalize_histogram(img, bins: int = 256, device=None) -> torch.Tensor:
    """Histogram equalization of a [0,1] grayscale image."""
    img = _t(img, device)
    hist = histogram(img, bins).float()
    cdf = torch.cumsum(hist, dim=0)
    cdf = (cdf - cdf[0]) / torch.clamp(cdf[-1] - cdf[0], min=1e-9)
    idx = torch.clamp((img * bins).to(torch.int32), 0, bins - 1)
    return cdf[idx.long()]
