"""LoRA adapters over the (frozen, possibly quantized) LLM base.

Port of ``trackiellm_tpu/models/lora.py``: the on-device personalization
path. It adapts the assistant's language to its user by training rank-r
additions (~0.1% of parameters) while the Q4 base stays frozen, on the same
card that serves.

Mechanism: each adapted projection becomes ``y = base(x) + (x @ A) @ B *
(alpha / r)``. ``LoraLinear`` is a named tuple, so the existing forwards
(``models/llm.py``, ``parallel/train.py``) take it unchanged: ``_linear``
knows it by its fields, ``_layer`` slices each of them per layer. Training
takes gradients with respect to the adapter tensors only. A quantized base
gives x its gradient through ``ops/quant.py:quantized_matmul``'s autograd
Function; on the card the forward runs the W4A8, f32a or Q8 kernel.
"""

from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Sequence

import torch

from trackiellm_tpu_torch.models import llm as llm_model
from trackiellm_tpu_torch.parallel.train import lm_loss
from trackiellm_tpu_torch.ops.quant import (QuantizedLinear, dequantize,
                                            quantize_q4, quantize_q8)


class LoraLinear(NamedTuple):
    """base + (x @ a) @ b * alpha / r. ``base`` is a tensor or a
    QuantizedLinear; a: (..., K, r), b: (..., r, N)."""

    base: Any
    a: torch.Tensor
    b: torch.Tensor
    alpha: torch.Tensor  # f32: (L,) once attached, a 0-dim tensor per layer


DEFAULT_TARGETS = ("wqkv", "wo", "w_gu", "w_down")


def _shape(w) -> tuple:
    """(L, K, N) of a stacked projection; a Q4 base stores K/2 packed
    rows."""
    if isinstance(w, QuantizedLinear):
        l, k_stored, n = w.values.shape
        return l, k_stored * (2 if w.values.dtype == torch.uint8 else 1), n
    return tuple(w.shape)


def init_lora(gen: torch.Generator, params: Dict[str, Any], rank: int = 8,
              alpha: float = 16.0, targets: Sequence[str] = DEFAULT_TARGETS,
              dtype: torch.dtype = torch.float32) -> Dict[str, Any]:
    """Adapter tree for the stacked per-layer projections, on ``gen``'s
    device. A is Gaussian over sqrt(K), B is zero (standard LoRA init: the
    delta starts at 0); both require a gradient. ``__alpha__`` is a 0-dim
    f32 tensor that does not."""
    dev = gen.device
    adapters: Dict[str, Any] = {}
    for name in targets:
        l, k, n = _shape(params["layers"][name])
        a = torch.randn((l, k, rank), generator=gen, device=dev) / (k ** 0.5)
        adapters[name] = {
            "a": a.to(dtype).requires_grad_(),
            "b": torch.zeros((l, rank, n), dtype=dtype,
                             device=dev).requires_grad_(),
        }
    adapters["__alpha__"] = torch.tensor(alpha, dtype=torch.float32,
                                         device=dev)
    return adapters


def lora_parameters(adapters: Dict[str, Any]) -> List[torch.Tensor]:
    """The trainable tensors of an adapter tree, in its order (every A and
    B; not ``__alpha__``): what an optimizer is built over."""
    return [t for name, ab in adapters.items() if name != "__alpha__"
            for t in (ab["a"], ab["b"])]


def attach_lora(params: Dict[str, Any],
                adapters: Dict[str, Any]) -> Dict[str, Any]:
    """Wrap the targeted projections with their adapters (the original tree
    is untouched). Alpha rides as an (L,) view, so ``_layer`` slices it
    like every other stacked leaf."""
    alpha = adapters["__alpha__"]
    layers = dict(params["layers"])
    for name, ab in adapters.items():
        if name == "__alpha__":
            continue
        layers[name] = LoraLinear(base=layers[name], a=ab["a"], b=ab["b"],
                                  alpha=alpha.expand(ab["a"].shape[0]))
    return {**params, "layers": layers}


@torch.no_grad()
def merge_lora(params: Dict[str, Any], adapters: Dict[str, Any],
               requantize_bits: int = 0) -> Dict[str, Any]:
    """Fold adapters into the base weights (for deployment without the
    LoRA compute). Quantized bases are dequantized, merged, and
    requantized at ``requantize_bits`` by the port's quantizers (0 keeps
    them dense f32)."""
    alpha = float(adapters["__alpha__"])
    layers = dict(params["layers"])
    for name, ab in adapters.items():
        if name == "__alpha__":
            continue
        base = layers[name]
        rank = ab["a"].shape[-1]
        delta = torch.einsum("lkr,lrn->lkn", ab["a"].float(),
                             ab["b"].float()) * (alpha / rank)
        if isinstance(base, QuantizedLinear):
            merged = torch.stack([dequantize(QuantizedLinear(
                base.values[i], base.scales[i]))
                for i in range(base.values.shape[0])]) + delta
            if requantize_bits in (4, 8):
                quant = quantize_q4 if requantize_bits == 4 else quantize_q8
                qs = [quant(merged[i], base.group_size)
                      for i in range(merged.shape[0])]
                layers[name] = QuantizedLinear(
                    values=torch.stack([q.values for q in qs]),
                    scales=torch.stack([q.scales for q in qs]))
            else:
                layers[name] = merged
        else:
            layers[name] = (base.float() + delta).to(base.dtype)
    return {**params, "layers": layers}


def make_lora_train_step(base_params: Dict[str, Any],
                         cfg: llm_model.LLMConfig):
    """A LoRA training step: ``step(adapters, opt, tokens) -> (adapters,
    opt, loss)``, the JAX package's ``step(adapters, opt_state, tokens)``
    with a ``torch.optim`` optimizer built over :func:`lora_parameters` in
    place of optax's state. The next-token loss of (B, S) ``tokens`` on the
    base's device is backpropagated to the adapters only (the base is a
    closed-over constant that requires no gradient), the optimizer updates
    them in place, and ``__alpha__`` stays fixed. The loss comes back as a
    0-dim tensor, detached."""
    def step(adapters, opt, tokens):
        opt.zero_grad(set_to_none=True)
        loss = lm_loss(attach_lora(base_params, adapters), cfg, tokens)
        loss.backward()
        opt.step()
        return adapters, opt, loss.detach()

    return step

