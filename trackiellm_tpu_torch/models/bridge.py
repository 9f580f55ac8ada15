"""The JAX package's params as this package's params, byte for byte.

``params_from_jax`` walks a pytree as the JAX package builds it (dicts,
lists, ``QuantizedLinear`` named tuples, arrays) and returns the same tree
with torch tensors: uint8 packed Q4 values, int8 Q8 values and f32 scales
keep their bytes; bf16 arrays go through their uint16 view, because
``torch.from_numpy`` does not take ``ml_dtypes.bfloat16``. Leaves may be
numpy arrays or anything ``numpy.asarray`` takes (JAX arrays included), so
this module needs no JAX import.

``hwio_tree_from_jax`` carries the vision models' trees (detector, MiDaS,
OCR, DPT) across: the JAX package keeps convolutions HWIO for NHWC
activations, this package OIHW for NCHW, so every 4-D leaf is transposed
once, here (a depthwise (k, k, 1, C) becomes (C, 1, k, k)); 2-D matrices
keep their (in, out) layout, and None leaves stay None.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from trackiellm_tpu_torch.ops.backend import default_device
from trackiellm_tpu_torch.ops.quant import QuantizedLinear


def array_to_torch(a: Any, device: Optional[torch.device] = None
                   ) -> torch.Tensor:
    """One array leaf to a tensor with the same bytes and dtype."""
    arr = np.ascontiguousarray(np.asarray(a))
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr.copy())
    return t.to(device) if device is not None else t


def params_from_jax(tree: Any, device: Optional[torch.device] = None) -> Any:
    """Convert a JAX-package param tree (see module docstring)."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    if hasattr(tree, "values") and hasattr(tree, "scales"):
        return QuantizedLinear(values=array_to_torch(tree.values, device),
                               scales=array_to_torch(tree.scales, device))
    if isinstance(tree, (list, tuple)):
        return [params_from_jax(v, device) for v in tree]
    return array_to_torch(tree, device)


def hwio_tree_from_jax(tree: Any, device: Optional[torch.device] = None,
                       what: str = "carry vision params") -> Any:
    """A JAX-package vision tree with its HWIO convolutions made OIHW, on
    ``device`` (the CUDA card by default; see module docstring)."""
    device = default_device(device, what)

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return [walk(v) for v in t]
        if t is None:
            return None
        a = np.asarray(t)
        return array_to_torch(a.transpose(3, 2, 0, 1) if a.ndim == 4 else a,
                              device)
    return walk(tree)
