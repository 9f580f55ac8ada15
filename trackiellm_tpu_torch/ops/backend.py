"""Where an op runs.

The JAX package keys its Pallas dispatch on the process's default backend
(``trackiellm_tpu/ops/backend.py:on_tpu``). Here the key is the tensor's
own device: a CUDA tensor goes to the hand-written kernel or raises, and a
CPU tensor takes the plain PyTorch version. There is no switch that sends a
CUDA tensor to the plain version.
"""

from __future__ import annotations

import torch


def is_cuda(t: torch.Tensor) -> bool:
    """True when ``t`` lies on a CUDA device, so its op launches a kernel."""
    return t.device.type == "cuda"
