"""The LM training step on one device: loss, AdamW, state on disk.

Port of the single-device part of ``trackiellm_tpu/parallel/train.py``:
the batched causal forward with per-layer rematerialization, the MoE
load-balancing loss, the next-token loss, optax's AdamW as
``torch.optim.AdamW``, and the train state. The JAX package runs one jitted
step with GSPMD shardings; here a step is eager autograd on the params'
device. Every projection goes through ``models/llm.py:_linear``, so a
quantized base runs the W4A8, f32a or Q8 kernel on the card and gives its
input a gradient (``ops/quant.py:quantized_matmul``).

What needs a mesh (``mesh=``, the expert-parallel dispatch, the
vocab-parallel embedding and cross-entropy) raises NotImplementedError
naming ROADMAP Queue 1 item 5 (ID 12); ``sequence_parallel`` is the no-op
it is on one device.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Dict, List, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from trackiellm_tpu_torch.models import llm as llm_model
from trackiellm_tpu_torch.parallel import layers as shared_layers

_MESH_ONLY = ("needs a device mesh: multi-device training is ROADMAP Queue 1 "
              "item 5 (ID 12)")


def _no_mesh(mesh, expert_parallel: bool = False) -> None:
    if mesh is not None:
        raise NotImplementedError(f"mesh= {_MESH_ONLY}")
    if expert_parallel:
        raise NotImplementedError(f"expert_parallel {_MESH_ONLY}")


def vocab_parallel_embed(tok_emb, tokens, mesh, sequence_parallel=False):
    """The Megatron vocab-parallel lookup: not ported (ID 12)."""
    raise NotImplementedError(f"vocab_parallel_embed {_MESH_ONLY}")


def vocab_parallel_ce(x, lm_head, tokens, mesh):
    """The vocab-parallel cross-entropy: not ported (ID 12)."""
    raise NotImplementedError(f"vocab_parallel_ce {_MESH_ONLY}")


def _moe_mlp_fn(cfg: llm_model.LLMConfig, b: int, s: int):
    """The reference's training MoE MLP, dense-all-experts: every expert on
    every row, weighted by the (T, E) matrix that is zero off the top-k,
    summed in expert order from the shared expert's output, with the
    router's (probs, weights) as its aux. Differentiable end to end (the
    kept weights carry the router's gradient)."""
    def mlp_fn(x, layer):
        h2 = llm_model._rms_norm(x, layer["mlp_norm"], cfg.norm_eps)
        flat = h2.reshape(b * s, -1)
        probs = torch.softmax(
            llm_model._linear(flat, layer["moe_gate"]).float(), dim=-1)
        topi = llm_model._top_k_first(probs, cfg.n_experts_used)
        topv = probs.gather(-1, topi)
        if cfg.moe_norm_topk:
            topv = topv / topv.sum(dim=-1, keepdim=True)
        weights = torch.zeros_like(probs).scatter(-1, topi, topv)
        out = llm_model._moe_shared(flat, layer, cfg)
        for e in range(cfg.n_experts):
            gu = llm_model._linear(
                flat, llm_model._expert_slice(layer["w_gu"], e)).float()
            gate, up = gu.chunk(2, dim=-1)
            y = llm_model._linear((F.silu(gate) * up).to(x.dtype),
                                  llm_model._expert_slice(layer["w_down"], e))
            out = out + weights[:, e:e + 1] * y.float()
        return x + out.to(x.dtype).reshape(b, s, -1), (probs, weights)
    return mlp_fn


def lm_forward_batched(params: Dict[str, Any], cfg: llm_model.LLMConfig,
                       tokens: torch.Tensor, sequence_parallel: bool = False,
                       expert_parallel: bool = False,
                       moe_capacity_factor: float = 2.0, mesh=None,
                       return_hidden: bool = False):
    """Batched causal LM forward: (B, S) int tokens on the params' device
    -> ``(logits (B, S, V) f32, aux)``; ``aux`` is the per-layer router
    stats ``(probs, weights)``, each (L, B*S, E), for MoE configs and None
    for dense ones. With ``return_hidden`` the first item is the final-norm
    hidden states instead of the logits.

    Each layer is the shared config-aware body
    (:mod:`trackiellm_tpu_torch.parallel.layers`) with the dense softmax
    core, run under ``torch.utils.checkpoint`` (non-reentrant: the layer's
    params are closed over, and adapters among them need gradients) where
    autograd records, the reference's ``jax.checkpoint``: the backward
    recomputes each layer's forward, kernels included, rather than keeping
    its activations. ``sequence_parallel`` and ``moe_capacity_factor`` change
    nothing on one device."""
    _no_mesh(mesh, expert_parallel)
    del sequence_parallel, moe_capacity_factor
    tokens = tokens.long()
    b, s = tokens.shape
    positions = torch.arange(s, device=tokens.device)
    tables = llm_model._rope_tables(params, cfg, positions, s)
    x = params["tok_emb"][tokens]                        # (B, S, D)
    mlp_fn = _moe_mlp_fn(cfg, b, s) if cfg.n_experts else None

    def attn_core(q, k, v, li):
        return shared_layers.dense_attn_core(cfg, li, q, k, v, positions)
    auxes = []
    for li in range(cfg.n_layers):
        body = functools.partial(
            shared_layers.transformer_layer,
            layer=llm_model._layer(params["layers"], li), li=li, cfg=cfg,
            tables=tables, positions=positions, attn_core=attn_core,
            mlp_fn=mlp_fn)
        if torch.is_grad_enabled():
            x, aux = checkpoint(body, x, use_reentrant=False)
        else:
            x, aux = body(x)
        auxes.append(aux)
    aux = None if mlp_fn is None else (torch.stack([a[0] for a in auxes]),
                                       torch.stack([a[1] for a in auxes]))
    if return_hidden:
        return llm_model._norm(x, params["out_norm"], cfg.norm_eps,
                               cfg.norm_type), aux
    return llm_model._output_logits(params, cfg, x), aux


def moe_load_balancing_loss(aux, cfg: llm_model.LLMConfig) -> torch.Tensor:
    """Mixtral/Switch load-balancing loss averaged over layers: E *
    sum_e(fraction of (token, k) assignments to e * mean router prob of
    e). 1.0 at a perfectly uniform router; grows as experts collapse."""
    probs, weights = aux                                  # each (L, T, E)
    dispatch = (weights > 0).float()
    frac = dispatch.mean(dim=1) / cfg.n_experts_used      # (L, E)
    imp = probs.mean(dim=1)
    return (cfg.n_experts * (frac * imp).sum(dim=-1)).mean()


def lm_loss(params, cfg: llm_model.LLMConfig, tokens: torch.Tensor,
            sequence_parallel: bool = False, moe_aux_coef: float = 0.02,
            expert_parallel: bool = False, moe_capacity_factor: float = 2.0,
            mesh=None) -> torch.Tensor:
    """Next-token cross-entropy over (B, S) tokens (shifted), a 0-dim f32
    tensor. MoE configs add ``moe_aux_coef`` times the load-balancing loss
    (Mixtral's router_aux_loss_coef default)."""
    logits, aux = lm_forward_batched(
        params, cfg, tokens, sequence_parallel,
        expert_parallel=expert_parallel,
        moe_capacity_factor=moe_capacity_factor, mesh=mesh)
    targets = tokens[:, 1:].long()
    logp = torch.log_softmax(logits[:, :-1], dim=-1)
    loss = -logp.gather(-1, targets[..., None])[..., 0].mean()
    if aux is not None and moe_aux_coef:
        loss = loss + moe_aux_coef * moe_load_balancing_loss(aux, cfg)
    return loss


def make_optimizer(lr: float = 1e-4) -> Callable[..., torch.optim.AdamW]:
    """optax's ``adamw(lr, b1=0.9, b2=0.95, weight_decay=0.01)`` (eps 1e-8,
    the decay decoupled and applied to every leaf): a factory that builds a
    ``torch.optim.AdamW`` over a list of tensors."""
    return functools.partial(torch.optim.AdamW, lr=lr, betas=(0.9, 0.95),
                             eps=1e-8, weight_decay=0.01)


def param_leaves(params: Any) -> List[torch.Tensor]:
    """Every tensor of a param tree, in its order (dicts in insertion
    order, lists in index order): what the optimizer is built over."""
    if isinstance(params, dict):
        return [t for v in params.values() for t in param_leaves(v)]
    if isinstance(params, (list, tuple)):
        return [t for v in params for t in param_leaves(v)]
    return [] if params is None else [params]


def _trainable(params: Any) -> Any:
    """``params`` with every tensor a leaf that requires a gradient."""
    for t in param_leaves(params):
        t.requires_grad_(True)
    return params


def init_train_state(gen: torch.Generator, cfg: llm_model.LLMConfig,
                     mesh=None, lr: float = 1e-4,
                     dtype: torch.dtype = torch.float32
                     ) -> Tuple[Dict, torch.optim.AdamW, Callable]:
    """(params, opt_state, opt): random dense params from ``gen`` on its
    device (the card, or the CPU if the generator lives there), the AdamW
    over them, and :func:`make_optimizer`'s factory. The optimizer object
    is the optimizer state: it keeps the moments beside the params."""
    _no_mesh(mesh)
    params = _trainable(llm_model.init_params(gen, cfg, dtype=dtype,
                                              device=gen.device))
    opt = make_optimizer(lr)
    return params, opt(param_leaves(params)), opt


def make_train_step(cfg: llm_model.LLMConfig, mesh=None,
                    sequence_parallel: bool = True,
                    moe_capacity_factor: float = 2.0):
    """``train_step(params, opt_state, tokens) -> (params, opt_state,
    loss)``: forward, backward and one AdamW update of every param, in
    place (the reference donates its buffers), with ``opt_state`` the
    optimizer :func:`init_train_state` built. The loss is a detached 0-dim
    tensor."""
    _no_mesh(mesh)

    def train_step(params, opt_state, tokens):
        opt_state.zero_grad(set_to_none=True)
        loss = lm_loss(params, cfg, tokens,
                       sequence_parallel=sequence_parallel,
                       moe_capacity_factor=moe_capacity_factor)
        loss.backward()
        opt_state.step()
        return params, opt_state, loss.detach()

    return train_step


def _detached(params: Any) -> Any:
    if isinstance(params, dict):
        return {k: _detached(v) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return [_detached(v) for v in params]
    return None if params is None else params.detach()


def save_train_state(path: str, params, opt_state: torch.optim.Optimizer,
                     step: int = 0) -> None:
    """Persist a train state in one ``torch.save`` file: the param tree,
    the optimizer's ``state_dict`` and the step. The JAX package writes an
    orbax checkpoint directory; the card's host has no orbax, so the two
    formats differ and neither reads the other."""
    torch.save({"params": _detached(params),
                "opt_state": opt_state.state_dict(), "step": int(step)},
               path)


def restore_train_state(path: str, cfg: llm_model.LLMConfig, mesh=None,
                        device=None):
    """(params, opt_state, opt, step) from :func:`save_train_state`'s file,
    on ``device`` (where the tensors were saved if None). The file is read
    with ``weights_only``: tensors and plain containers only. The optimizer
    is rebuilt over the params by :func:`make_optimizer` at the saved
    learning rate and takes the saved moments and step counts."""
    _no_mesh(mesh)
    state = torch.load(path, map_location=device, weights_only=True)
    params = _trainable(state["params"])
    want = (cfg.vocab_size, cfg.dim)
    if tuple(params["tok_emb"].shape) != want:
        raise ValueError(f"{path}: tok_emb {tuple(params['tok_emb'].shape)} "
                         f"is not this config's {want}")
    opt = make_optimizer(state["opt_state"]["param_groups"][0]["lr"])
    opt_state = opt(param_leaves(params))
    opt_state.load_state_dict(state["opt_state"])
    return params, opt_state, opt, state["step"]
