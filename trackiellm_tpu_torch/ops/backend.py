"""Where an op runs.

The JAX package keys its Pallas dispatch on the process's default backend
(``trackiellm_tpu/ops/backend.py:on_tpu``). Here the key is the tensor's
own device: a CUDA tensor goes to the hand-written kernel or raises, and a
CPU tensor takes the plain PyTorch version. There is no switch that sends a
CUDA tensor to the plain version.

Constructors and entry points that allocate take the CUDA card unless they
are given a device (:func:`default_device`), as the JAX package's put their
arrays on the accelerator; with no card they raise, and the CPU must be
asked for.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional, Union

import torch

from trackiellm_tpu_torch.utils.errors import ErrorCode, TrackieError


def is_cuda(t: torch.Tensor) -> bool:
    """True when ``t`` lies on a CUDA device, so its op launches a kernel.
    (``t.is_cuda`` builds no ``torch.device``: this runs on every launch.)"""
    return t.is_cuda


def default_device(device: Optional[Union[str, torch.device]],
                   what: str) -> torch.device:
    """``device`` as given; by default the current CUDA card. With no card
    it raises a DEVICE_UNAVAILABLE TrackieError naming ``what`` rather than
    fall back to the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise TrackieError(
            ErrorCode.DEVICE_UNAVAILABLE,
            f"no CUDA device: pass device=torch.device('cpu') to {what} on "
            "the CPU")
    return torch.device("cuda", torch.cuda.current_device())


_EXACT_LOCK = threading.Lock()
_exact_depth = 0
_exact_saved: tuple = ()


@contextlib.contextmanager
def exact_f32():
    """f32 convolutions and matmuls in full f32 inside the block, whatever
    the caller's TF32 flags say: the JAX package's voice models ask for f32
    sums (``preferred_element_type=jnp.float32``), and cuDNN runs f32
    convolutions in TF32 by default.

    The flags are process-wide, so while any thread is inside a block every
    thread's f32 work runs without TF32. Blocks nest and overlap across
    threads: the first entry saves the caller's flags and the last exit
    restores them."""
    global _exact_depth, _exact_saved
    matmul, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    with _EXACT_LOCK:
        if _exact_depth == 0:
            _exact_saved = (matmul.allow_tf32, cudnn.enabled,
                            cudnn.allow_tf32)
            matmul.allow_tf32 = False
            cudnn.enabled, cudnn.allow_tf32 = True, False
        _exact_depth += 1
    try:
        yield
    finally:
        with _EXACT_LOCK:
            _exact_depth -= 1
            if _exact_depth == 0:
                (matmul.allow_tf32, cudnn.enabled,
                 cudnn.allow_tf32) = _exact_saved
