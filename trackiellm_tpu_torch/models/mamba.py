"""Mamba (selective state-space) family.

Port of ``trackiellm_tpu/models/mamba.py``: the same config, params tree,
cache and forward surface, in torch ops. No Pallas kernel is reached from
the reference module; its projections go through ``models/llm.py:_linear``,
so a Q4 checkpoint's ``w_in``, ``w_x``, ``w_out`` and ``lm_head`` run the
W4A8 kernel on the card (f32a at M > 512, Q8 for Q8 weights), as every
quantized projection of the port does.

- Prefill and extend run the diagonal recurrence h_t = dA_t h_{t-1} + dB_t
  x_t as one associative scan over the (S, I, N) pairs, combined by
  (aL, bL) + (aR, bR) = (aL aR, bL aR + bR) in ``jax.lax.associative_scan``'s
  order (``ops/scan.py:associative_scan``); a chunk's initial state folds
  into the first element, which makes chunked prefill exact.
- The depthwise causal convolution is K shifted multiply-adds over the
  concatenated [conv_state, x] rows.
- Decode is the direct recurrence a token, with a (conv, ssm) state cache
  whose size does not depend on the context.

Recurrent state cannot be rolled back by lowering a length, so the
attention runner's lookahead and speculation do not apply:
:class:`MambaRunner` is the strictly sequential session API. The batched
functions at the bottom serve the family through ``LLMServer(model=)``.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from trackiellm_tpu_torch.models.llm import (_layer, _quantize_stack,
                                             quantized_stack)
from trackiellm_tpu_torch.models.llm import _linear as _mm
from trackiellm_tpu_torch.models.llm import _rms_norm as _rms
from trackiellm_tpu_torch.models.llm import embed_token as _embed
from trackiellm_tpu_torch.ops.backend import default_device
from trackiellm_tpu_torch.ops.quant import quantize_q4, quantize_q8
from trackiellm_tpu_torch.ops.scan import associative_scan


class MambaConfig(NamedTuple):
    vocab_size: int = 50280
    dim: int = 768
    n_layers: int = 24
    d_inner: int = 1536          # intermediate_size (2 * dim)
    d_state: int = 16            # ssm_state_size
    d_conv: int = 4              # conv_kernel
    dt_rank: int = 48            # time_step_rank (ceil(dim / 16))
    norm_eps: float = 1e-5
    max_seq: int = 4096          # a session's cap; the state has no length

    @classmethod
    def mamba_130m(cls) -> "MambaConfig":
        return cls()

    @classmethod
    def mamba_2_8b(cls) -> "MambaConfig":
        return cls(dim=2560, d_inner=5120, dt_rank=160, n_layers=64)

    @classmethod
    def test(cls) -> "MambaConfig":
        return cls(vocab_size=96, dim=32, n_layers=2, d_inner=64,
                   d_state=8, d_conv=4, dt_rank=4, max_seq=64)


class MambaCache(NamedTuple):
    """Recurrent state: per layer the last K-1 pre-convolution inputs and
    the (d_inner, d_state) f32 SSM state; ``length`` (a host int) counts
    the tokens consumed."""

    conv: torch.Tensor   # (L, K-1, I)
    ssm: torch.Tensor    # (L, I, N) float32
    length: int

    @classmethod
    def create(cls, cfg: MambaConfig, dtype: torch.dtype = torch.float32,
               max_seq: Optional[int] = None,
               device: Optional[torch.device] = None) -> "MambaCache":
        """Zeroed state on ``device``, by default the CUDA card (with none
        it raises unless the CPU is asked for); ``max_seq`` is accepted
        for the attention caches' signature."""
        del max_seq
        device = default_device(device, "allocate a Mamba state")
        return cls(
            conv=torch.zeros((cfg.n_layers, cfg.d_conv - 1, cfg.d_inner),
                             dtype=dtype, device=device),
            ssm=torch.zeros((cfg.n_layers, cfg.d_inner, cfg.d_state),
                            dtype=torch.float32, device=device),
            length=0)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` as jnp computes it,
    max(x, 0) + log1p(exp(-|x|)) (``F.softplus`` switches to x above 20
    and rounds differently below)."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


def _ssm_assoc(left, right):
    (a_l, b_l), (a_r, b_r) = left, right
    return [a_l * a_r, b_l * a_r + b_r]


def _conv_seq(x_cat: torch.Tensor, conv_w: torch.Tensor,
              conv_b: torch.Tensor, s: int) -> torch.Tensor:
    """The depthwise causal convolution over a sequence: the bias, then
    the K shifted products added in order."""
    conv = conv_b
    for j in range(conv_w.shape[0]):
        conv = conv + x_cat[j:j + s] * conv_w[j]
    return conv


def _mixer_seq(layer, cfg: MambaConfig, x_seq: torch.Tensor,
               conv_init: torch.Tensor, ssm_init: torch.Tensor,
               last_idx: int
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One mixer over a whole (padded) sequence: ``x_seq`` (S, D) normed
    inputs; returns (y (S, D), the conv state and the ssm state at
    ``last_idx``: padded tail rows never reach the carried state)."""
    s = x_seq.shape[0]
    k = cfg.d_conv
    xz = _mm(x_seq, layer["w_in"])                            # (S, 2I)
    x, z = xz.chunk(2, dim=-1)
    x_cat = torch.cat([conv_init.to(x.dtype), x], dim=0)
    h = F.silu(_conv_seq(x_cat, layer["conv_w"], layer["conv_b"], s))
    proj = _mm(h, layer["w_x"])                               # (S, R+2N)
    dt, b_in, c_in = proj.split([cfg.dt_rank, cfg.d_state, cfg.d_state],
                                dim=-1)
    delta = softplus(dt @ layer["w_dt"] + layer["b_dt"])      # (S, I)
    a_mat = -torch.exp(layer["A_log"].float())                # (I, N)
    delta32 = delta.float()
    d_a = torch.exp(delta32[:, :, None] * a_mat[None])        # (S, I, N)
    d_bx = (delta32[:, :, None] * b_in.float()[:, None, :]
            * h.float()[:, :, None])                          # (S, I, N)
    d_bx[0] = d_bx[0] + d_a[0] * ssm_init
    _, hs = associative_scan(_ssm_assoc, [d_a, d_bx])
    del d_a, d_bx
    y = torch.einsum("sin,sn->si", hs, c_in.float())
    y = y + h.float() * layer["d"]
    y = (y * F.silu(z.float())).to(x_seq.dtype)
    out = _mm(y, layer["w_out"])                              # (S, D)
    conv_state = x_cat[last_idx + 1:last_idx + k]
    return out, conv_state, hs[last_idx]


def _logits(params, cfg, x: torch.Tensor) -> torch.Tensor:
    return _mm(_rms(x, params["out_norm"], cfg.norm_eps),
               params["lm_head"]).float()


def _seq_forward(params, cfg: MambaConfig, tokens: torch.Tensor,
                 n_valid: int, cache: MambaCache
                 ) -> Tuple[torch.Tensor, MambaCache]:
    """The prefill/extend body over a (S_pad,) token bucket."""
    last = max(int(n_valid) - 1, 0)
    x = params["tok_emb"][tokens.long()]                      # (S, D)
    convs, ssms = [], []
    for li in range(cfg.n_layers):
        layer = _layer(params["layers"], li)
        h = _rms(x, layer["norm"], cfg.norm_eps)
        out, conv_s, ssm_s = _mixer_seq(layer, cfg, h, cache.conv[li],
                                        cache.ssm[li], last)
        x = x + out
        convs.append(conv_s)
        ssms.append(ssm_s)
    logits = _logits(params, cfg, x[last][None])[0]
    return logits, MambaCache(
        conv=torch.stack(convs).to(cache.conv.dtype),
        ssm=torch.stack(ssms), length=cache.length + int(n_valid))


@torch.no_grad()
def prefill(params: Dict[str, Any], cfg: MambaConfig, tokens: torch.Tensor,
            length: int, cache: MambaCache
            ) -> Tuple[torch.Tensor, MambaCache]:
    """Prompt ingestion of a (S_pad,) bucket with ``length`` real tokens.
    The state starts from zero (``cache`` gives the dtype and device);
    returns the last real token's logits and the state after it."""
    zero = MambaCache.create(cfg, dtype=cache.conv.dtype,
                             device=cache.conv.device)
    return _seq_forward(params, cfg, tokens, length, zero)


@torch.no_grad()
def extend(params: Dict[str, Any], cfg: MambaConfig, tokens: torch.Tensor,
           n_valid: int, cache: MambaCache, attn_len: Optional[int] = None,
           all_logits: bool = False) -> Tuple[torch.Tensor, MambaCache]:
    """Continue from the live state over a padded chunk: exact, as the
    state folds into the scan's first element. ``attn_len`` is accepted
    for the server's contract and ignored (there is no attention)."""
    del attn_len
    if all_logits:
        raise NotImplementedError(
            "all_logits is an attention-path (speculative verify) "
            "feature; the recurrent extend returns last-token logits")
    return _seq_forward(params, cfg, tokens, n_valid, cache)


def _step_layer(layer, cfg: MambaConfig, x: torch.Tensor,
                conv_l: torch.Tensor, ssm_l: torch.Tensor):
    """One token through one layer of rows ``x`` (B, D) with states
    (B, K-1, I) and (B, I, N): returns (x + out, conv window, new ssm)."""
    h_in = _rms(x, layer["norm"], cfg.norm_eps)
    xz = _mm(h_in, layer["w_in"])                             # (B, 2I)
    xi, z = xz.chunk(2, dim=-1)
    x_cat = torch.cat([conv_l.to(xi.dtype), xi[:, None, :]], dim=1)
    conv = (x_cat * layer["conv_w"][None]).sum(1) + layer["conv_b"]
    h = F.silu(conv)                                          # (B, I)
    proj = _mm(h, layer["w_x"])                               # (B, R+2N)
    dt, b_in, c_in = proj.split([cfg.dt_rank, cfg.d_state, cfg.d_state],
                                dim=-1)
    delta = softplus(dt @ layer["w_dt"] + layer["b_dt"])
    a_mat = -torch.exp(layer["A_log"].float())
    d32 = delta.float()
    d_a = torch.exp(d32[:, :, None] * a_mat[None])            # (B, I, N)
    ssm = d_a * ssm_l + (d32[:, :, None] * b_in.float()[:, None, :]
                         * h.float()[:, :, None])
    y = torch.einsum("bin,bn->bi", ssm, c_in.float())
    y = y + h.float() * layer["d"][None]
    y = (y * F.silu(z.float())).to(x.dtype)
    return x + _mm(y, layer["w_out"]), x_cat[:, 1:], ssm


@torch.no_grad()
def decode_step(params: Dict[str, Any], cfg: MambaConfig, token,
                cache: MambaCache, attn_len: Optional[int] = None
                ) -> Tuple[torch.Tensor, MambaCache]:
    """One token (an int or a 0-d device tensor): an O(1) state update a
    layer. ``attn_len`` is accepted for the runners' signature."""
    del attn_len
    x = _embed(params, token)                                 # (1, D)
    convs, ssms = [], []
    for li in range(cfg.n_layers):
        layer = _layer(params["layers"], li)
        x, conv_s, ssm_s = _step_layer(layer, cfg, x, cache.conv[li][None],
                                       cache.ssm[li][None])
        convs.append(conv_s[0])
        ssms.append(ssm_s[0])
    logits = _logits(params, cfg, x)[0]
    return logits, MambaCache(conv=torch.stack(convs).to(cache.conv.dtype),
                              ssm=torch.stack(ssms),
                              length=cache.length + 1)


@torch.no_grad()
def decode_chunk_greedy(params: Dict[str, Any], cfg: MambaConfig,
                        logits: torch.Tensor, cache: MambaCache,
                        n_tokens: int, eos_id: Optional[int] = None,
                        suppress_until: Optional[int] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, MambaCache]:
    """``n_tokens`` greedy steps with the argmax kept on the device (one
    host fetch a chunk). The state cannot be rolled back afterwards: use it
    only where every token of the chunk is consumed."""
    toks = []
    lg = logits
    for step in range(n_tokens):
        if (eos_id is not None and suppress_until is not None
                and step < suppress_until):
            lg = lg.clone()
            lg[eos_id] = -1e30
        tok = torch.argmax(lg)
        toks.append(tok)
        lg, cache = decode_step(params, cfg, tok, cache)
    return torch.stack(toks), lg, cache


def init_params(cfg: MambaConfig, rng, dtype: torch.dtype = torch.float32,
                device: Optional[torch.device] = None) -> Dict[str, Any]:
    """Random params in the converter's layout, drawn with numpy as the
    reference's ``init_params`` draws them (the same ``rng`` gives the same
    values); on ``device``, by default the CUDA card."""
    device = default_device(device, "build Mamba params")
    rng = np.random.default_rng(rng) if isinstance(rng, int) else rng
    n, d, i = cfg.n_layers, cfg.dim, cfg.d_inner

    def t(a, dt=dtype):
        return torch.from_numpy(np.asarray(a, np.float32)).to(device).to(dt)

    def w(*shape, s=0.02):
        return t(rng.normal(0.0, s, shape))

    layers = {
        "norm": t(np.ones((n, d))),
        "w_in": w(n, d, 2 * i),
        "conv_w": w(n, cfg.d_conv, i, s=0.2),
        "conv_b": t(np.zeros((n, i))),
        "w_x": w(n, i, cfg.dt_rank + 2 * cfg.d_state),
        "w_dt": w(n, cfg.dt_rank, i, s=0.1),
        "b_dt": t(np.full((n, i), -2.0)),
        "A_log": t(np.tile(np.log(np.arange(1, cfg.d_state + 1,
                                            dtype=np.float32))[None, None],
                           (n, i, 1)), torch.float32),
        "d": t(np.ones((n, i)), torch.float32),
        "w_out": w(n, i, d),
    }
    emb = rng.normal(0.0, 0.02, (cfg.vocab_size, d))
    return {"tok_emb": t(emb), "layers": layers,
            "out_norm": t(np.ones((d,))),
            "lm_head": t(np.ascontiguousarray(np.asarray(emb, np.float32).T))}


_QUANTIZED = ("w_in", "w_x", "w_out")


def init_params_quantized(generator: torch.Generator, cfg: MambaConfig,
                          bits: int = 4, group: int = 256,
                          dtype: torch.dtype = torch.bfloat16,
                          device: Optional[torch.device] = None
                          ) -> Dict[str, Any]:
    """Random params at :func:`init_params`' scales straight into the
    layout of :func:`quantize_params`, one (K, N) matrix at a time on
    ``device`` (``generator`` lives there): a full-width model never holds
    its float matrices beside the quantized ones."""
    device = default_device(device, "build Mamba params")
    quantize = quantize_q4 if bits == 4 else quantize_q8
    n, d, i = cfg.n_layers, cfg.dim, cfg.d_inner

    def normal(shape, s):
        return torch.randn(shape, generator=generator, device=device) * s

    def stack_q(kk, nn):
        return quantized_stack((n,), lambda: quantize(normal((kk, nn), 0.02),
                                                      group))

    layers = {
        "norm": torch.ones((n, d), dtype=dtype, device=device),
        "w_in": stack_q(d, 2 * i),
        "conv_w": normal((n, cfg.d_conv, i), 0.2).to(dtype),
        "conv_b": torch.zeros((n, i), dtype=dtype, device=device),
        "w_x": stack_q(i, cfg.dt_rank + 2 * cfg.d_state),
        "w_dt": normal((n, cfg.dt_rank, i), 0.1).to(dtype),
        "b_dt": torch.full((n, i), -2.0, dtype=dtype, device=device),
        "A_log": torch.log(torch.arange(
            1, cfg.d_state + 1, dtype=torch.float32,
            device=device)).expand(n, i, cfg.d_state).contiguous(),
        "d": torch.ones((n, i), dtype=torch.float32, device=device),
        "w_out": stack_q(i, d),
    }
    return {"tok_emb": normal((cfg.vocab_size, d), 0.02).to(dtype),
            "layers": layers,
            "out_norm": torch.ones((d,), dtype=dtype, device=device),
            "lm_head": quantize(normal((d, cfg.vocab_size), 0.02), group)}


def quantize_params(params: Dict[str, Any], bits: int = 4,
                    group: int = 256) -> Dict[str, Any]:
    """Quantize ``w_in``, ``w_x``, ``w_out`` (about 90% of the bytes) and
    ``lm_head`` at Q4 or Q8; the SSM tensors, the convolution, the norms
    and the embedding keep their dtype, as llama.cpp's mamba quants do."""
    quantize = quantize_q4 if bits == 4 else quantize_q8
    out = dict(params)
    layers = dict(params["layers"])
    for name in _QUANTIZED:
        layers[name] = _quantize_stack(layers[name], quantize, group)
    out["layers"] = layers
    out["lm_head"] = quantize(params["lm_head"], group)
    return out


# ---------------------------------------------------------------------------
# The session runner
# ---------------------------------------------------------------------------

class MambaRunner:
    """A streaming session over a recurrent-state checkpoint: bucketed
    chunked prefill (the associative scan), then greedy or sampled decode
    a token at a time. Strictly sequential: the state has no rollback, so
    the attention runner's lookahead, speculation and prefix reuse do not
    apply, and each ``generate`` ingests its prompt afresh."""

    CHUNK = 256

    def __init__(self, params, cfg, tokenizer=None, gen_config=None,
                 model=None, device: Optional[torch.device] = None):
        """``model``: the recurrent module (this one, ``models.mamba2`` or
        ``models.qwen3next``: the same prefill/extend/decode_step surface),
        chosen from the config's type when omitted. The session runs on
        the params' device."""
        import sys

        from trackiellm_tpu_torch.llm.runner import GenerationConfig
        from trackiellm_tpu_torch.llm.tokenizer import ByteTokenizer

        if model is None:
            kind = type(cfg).__name__
            if kind == "Mamba2Config":
                from trackiellm_tpu_torch.models import mamba2 as model
            elif kind == "Qwen3NextConfig":
                from trackiellm_tpu_torch.models import qwen3next as model
            else:
                model = sys.modules[__name__]
        self._m = model
        self._cache_cls = (model.Mamba2Cache if hasattr(model, "Mamba2Cache")
                           else model.MambaCache if hasattr(model, "MambaCache")
                           else model.Cache)
        self.params = params
        self.cfg = cfg
        self.device = torch.device(device or params["tok_emb"].device)
        self.tokenizer = tokenizer or ByteTokenizer(
            n_special_pad_to=cfg.vocab_size)
        self.gen = gen_config or GenerationConfig()
        self.cache = self._new_cache()
        self._generator = torch.Generator(device=self.device)
        self._generator.manual_seed(self.gen.seed)
        self._generated_ids: List[int] = []

    def _new_cache(self):
        return self._cache_cls.create(self.cfg, device=self.device)

    def _bucket(self, n: int) -> int:
        from trackiellm_tpu_torch.llm.runner import _bucket_for
        return _bucket_for(n, (16, 64, self.CHUNK))

    def _padded(self, ids) -> torch.Tensor:
        padded = np.zeros(self._bucket(len(ids)), np.int64)
        padded[:len(ids)] = ids
        return torch.from_numpy(padded).to(self.device)

    # The cortex's session surface (build_prompt, generate(tools=,
    # on_token=, should_stop=), add_tool_response, count_tokens,
    # max_prompt_tokens), as the reference's.

    def count_tokens(self, text: str) -> int:
        return len(self.tokenizer.encode(text, add_bos=False))

    @property
    def max_prompt_tokens(self) -> int:
        return max(self.cfg.max_seq - self.gen.max_tokens - 1, 16)

    def build_prompt(self, system: str, context: str, user: str,
                     tools=()) -> str:
        parts = [system]
        if tools:
            parts.append(
                "Ferramentas disponíveis (responda com JSON "
                '{"tool_call": {"name": ..., "arguments": {...}}} '
                "para usar):\n"
                + "\n".join(t.render() for t in tools))
        if context:
            parts.append(f"Context:\n{context}")
        body = "\n\n".join(parts)
        return f"[INST] {body}\n\nUser: {user} [/INST]"

    def add_tool_response(self, tool_name: str, response) -> None:
        """Append the tool's output to the live state (the follow-up
        prompt carries it too)."""
        text = f"\nTool {tool_name} returned: {json.dumps(response)}\n"
        ids = self.tokenizer.encode(text, add_bos=False)
        if not ids:
            return
        _, self.cache = self._m.extend(self.params, self.cfg,
                                       self._padded(ids), len(ids),
                                       self.cache)

    def reset(self) -> None:
        self.cache = self._new_cache()
        self._generated_ids = []

    @property
    def generated_ids(self) -> List[int]:
        return list(self._generated_ids)

    def generate(self, prompt: str, tools=(), max_tokens=None,
                 on_token=None, should_stop=None,
                 force_tool_call: bool = False) -> str:
        if force_tool_call:
            raise NotImplementedError(
                "grammar-constrained decoding needs per-token masks; "
                "use the attention runner for forced tool calls")
        from trackiellm_tpu_torch.llm import sampling

        text = ""
        ids = self.tokenizer.encode(prompt, add_bos=True)
        hard = self.max_prompt_tokens
        if len(ids) > hard:
            head = hard // 4
            ids = ids[:head] + ids[-(hard - head):]
        self.cache = self._new_cache()
        logits = None
        for pos in range(0, len(ids), self.CHUNK):
            chunk = ids[pos:pos + self.CHUNK]
            fn = self._m.prefill if pos == 0 else self._m.extend
            logits, self.cache = fn(self.params, self.cfg,
                                    self._padded(chunk), len(chunk),
                                    self.cache)
        out = []
        eos = self.tokenizer.eos_id
        for _ in range(max_tokens or self.gen.max_tokens):
            if should_stop is not None and should_stop():
                break
            if self.gen.temperature <= 0:
                tid = int(torch.argmax(logits))
            else:
                tid = int(sampling.sample(
                    logits, self._generator, self.gen.temperature,
                    top_k=self.gen.top_k, top_p=self.gen.top_p,
                    min_p=self.gen.min_p))
            if tid == eos:
                break
            out.append(tid)
            piece = self.tokenizer.decode([tid])
            text += piece
            if on_token:
                on_token(piece)
            logits, self.cache = self._m.decode_step(self.params, self.cfg,
                                                     tid, self.cache)
        self._generated_ids = out
        return text


# ---------------------------------------------------------------------------
# Continuous batching (LLMServer's model= contract)
# ---------------------------------------------------------------------------

class BatchedMambaCache(NamedTuple):
    """Per-slot recurrent states for the batching server: B slots cost
    B * (K-1 + N) * I values a layer in all (no max_seq axis), so the
    family needs no paging."""

    conv: torch.Tensor     # (L, B, K-1, I)
    ssm: torch.Tensor      # (L, B, I, N) float32
    lengths: torch.Tensor  # (B,) int32 (bookkeeping only)

    @classmethod
    def create(cls, cfg: MambaConfig, batch: int,
               dtype: torch.dtype = torch.bfloat16,
               max_seq: Optional[int] = None,
               device: Optional[torch.device] = None) -> "BatchedMambaCache":
        del max_seq
        device = default_device(device, "allocate a Mamba state")
        return cls(
            conv=torch.zeros((cfg.n_layers, batch, cfg.d_conv - 1,
                              cfg.d_inner), dtype=dtype, device=device),
            ssm=torch.zeros((cfg.n_layers, batch, cfg.d_inner,
                             cfg.d_state), dtype=torch.float32,
                            device=device),
            lengths=torch.zeros((batch,), dtype=torch.int32, device=device))


@torch.no_grad()
def insert_sequence(cache: BatchedMambaCache, cfg: MambaConfig, slot: int,
                    seq_cache: MambaCache) -> BatchedMambaCache:
    """Copy a single sequence's state (from prefill) into batch slot
    ``slot`` in place."""
    cache.conv[:, slot] = seq_cache.conv.to(cache.conv.dtype)
    cache.ssm[:, slot] = seq_cache.ssm
    cache.lengths[slot] = int(seq_cache.length)
    return cache


@torch.no_grad()
def decode_step_batch(params: Dict[str, Any], cfg: MambaConfig,
                      tokens: torch.Tensor, active: torch.Tensor,
                      cache: BatchedMambaCache,
                      attn_len: Optional[int] = None
                      ) -> Tuple[torch.Tensor, BatchedMambaCache]:
    """One decode step for every slot: tokens (B,) -> logits (B, V).
    Inactive slots compute, but their state does not advance. ``attn_len``
    is accepted for the contract and ignored."""
    del attn_len
    x = params["tok_emb"].index_select(0, tokens.long())      # (B, D)
    act3 = active[:, None, None]
    convs, ssms = [], []
    for li in range(cfg.n_layers):
        layer = _layer(params["layers"], li)
        conv_l, ssm_l = cache.conv[li], cache.ssm[li]
        x, conv_s, ssm_s = _step_layer(layer, cfg, x, conv_l, ssm_l)
        convs.append(torch.where(act3, conv_s.to(conv_l.dtype), conv_l))
        ssms.append(torch.where(act3, ssm_s, ssm_l))
    logits = _logits(params, cfg, x)
    return logits, BatchedMambaCache(
        conv=torch.stack(convs), ssm=torch.stack(ssms),
        lengths=cache.lengths + active.to(torch.int32))


@torch.no_grad()
def decode_steps_batch(params: Dict[str, Any], cfg: MambaConfig,
                       tokens: torch.Tensor, active: torch.Tensor,
                       cache: BatchedMambaCache, n_steps: int,
                       attn_len: Optional[int] = None
                       ) -> Tuple[torch.Tensor, BatchedMambaCache]:
    """``n_steps`` greedy batch steps with each argmax fed back on the
    device; returns ((n_steps, B) tokens, cache)."""
    del attn_len
    produced = []
    toks = tokens
    for _ in range(n_steps):
        logits, cache = decode_step_batch(params, cfg, toks, active, cache)
        toks = torch.argmax(logits, dim=-1)
        produced.append(toks)
    return torch.stack(produced), cache


# LLMServer's model= contract names the cache classes by the attention
# names.
KVCache = MambaCache
BatchedKVCache = BatchedMambaCache
