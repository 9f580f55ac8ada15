"""Mamba-2 (SSD, state-space duality) family.

Port of ``trackiellm_tpu/models/mamba2.py``: per-head scalar decay A (H,),
B and C shared by groups of heads (``n_groups``), a gated RMS norm before
the output projection, and a head-structured (H, P, N) state. The
recurrence h_t = a_t[h] h_{t-1} + (dt_t[h] x_t[h, p]) B_t[h, n] runs as one
associative scan over the sequence in the reference's combine order
(``ops/scan.py:associative_scan``); the decay stays (S, H, 1, 1) and
broadcasts in each combine, where the reference broadcasts it to the
state's shape first: the products are the same, and a Codestral-width
chunk of 256 tokens holds one 1-GiB operand, not two. Its projections are
plain matmuls, as the reference's (``@``, no quantized route).
"""

from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from trackiellm_tpu_torch.models.mamba import (_conv_seq, _embed, _layer,
                                               _rms, _ssm_assoc, softplus)
from trackiellm_tpu_torch.ops.backend import default_device
from trackiellm_tpu_torch.ops.scan import associative_scan


class Mamba2Config(NamedTuple):
    vocab_size: int = 32768
    dim: int = 4096
    n_layers: int = 64
    n_heads: int = 128
    head_dim: int = 64           # P; d_inner = n_heads * head_dim
    d_state: int = 128           # N
    n_groups: int = 8            # G: B/C shared by a group of heads
    d_conv: int = 4              # K
    norm_eps: float = 1e-5
    dt_limit: Tuple[float, float] = (0.0, float("inf"))
    max_seq: int = 4096

    @property
    def d_inner(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def conv_dim(self) -> int:
        return self.d_inner + 2 * self.n_groups * self.d_state

    @classmethod
    def test(cls) -> "Mamba2Config":
        return cls(vocab_size=96, dim=32, n_layers=2, n_heads=4,
                   head_dim=8, d_state=16, n_groups=2, d_conv=4,
                   max_seq=64)


class Mamba2Cache(NamedTuple):
    conv: torch.Tensor    # (L, K-1, conv_dim)
    ssm: torch.Tensor     # (L, H, P, N) float32
    length: int

    @classmethod
    def create(cls, cfg: Mamba2Config, dtype: torch.dtype = torch.float32,
               max_seq: Optional[int] = None,
               device: Optional[torch.device] = None) -> "Mamba2Cache":
        del max_seq
        device = default_device(device, "allocate a Mamba-2 state")
        return cls(
            conv=torch.zeros((cfg.n_layers, cfg.d_conv - 1, cfg.conv_dim),
                             dtype=dtype, device=device),
            ssm=torch.zeros((cfg.n_layers, cfg.n_heads, cfg.head_dim,
                             cfg.d_state), dtype=torch.float32,
                            device=device),
            length=0)


def _gated_norm(y: torch.Tensor, gate: torch.Tensor, w: torch.Tensor,
                eps: float) -> torch.Tensor:
    """MambaRMSNormGated: the silu gate in f32, then the RMS norm."""
    y32 = y.float() * F.silu(gate.float())
    ms = y32.square().mean(dim=-1, keepdim=True)
    return (y32 * torch.rsqrt(ms + eps)) * w


def _dt(dt: torch.Tensor, layer, cfg: Mamba2Config) -> torch.Tensor:
    dt = softplus(dt.float() + layer["dt_bias"])
    lo, hi = cfg.dt_limit
    if lo != 0.0 or hi != float("inf"):
        dt = dt.clamp(lo, hi)
    return dt


def _in_proj(x: torch.Tensor, layer) -> torch.Tensor:
    proj = x @ layer["w_in"]
    if "b_in" in layer:
        proj = proj + layer["b_in"]
    return proj


def _mixer_seq2(layer, cfg: Mamba2Config, x_seq: torch.Tensor,
                conv_init: torch.Tensor, ssm_init: torch.Tensor,
                last_idx: int
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    s = x_seq.shape[0]
    k = cfg.d_conv
    hh, p, n, g = cfg.n_heads, cfg.head_dim, cfg.d_state, cfg.n_groups
    i_sz = cfg.d_inner
    gate, xbc, dt = _in_proj(x_seq, layer).split(
        [i_sz, cfg.conv_dim, hh], dim=-1)
    x_cat = torch.cat([conv_init.to(xbc.dtype), xbc], dim=0)
    xbc = F.silu(_conv_seq(x_cat, layer["conv_w"], layer["conv_b"], s))
    x, b_in, c_in = xbc.split([i_sz, g * n, g * n], dim=-1)
    dt = _dt(dt, layer, cfg)                                  # (S, H)
    a_vec = -torch.exp(layer["A_log"].float())                # (H,)
    d_a = torch.exp(dt * a_vec)                               # (S, H)
    rep = hh // g
    x3 = x.float().reshape(s, hh, p)
    b3 = b_in.float().reshape(s, g, n).repeat_interleave(rep, dim=1)
    c3 = c_in.float().reshape(s, g, n).repeat_interleave(rep, dim=1)
    a = d_a[:, :, None, None]                                 # (S, H, 1, 1)
    b = (dt[:, :, None] * x3)[..., None] * b3[:, :, None, :]  # (S, H, P, N)
    del b3
    b[0] = b[0] + a[0] * ssm_init
    _, hs = associative_scan(_ssm_assoc, [a, b])              # (S, H, P, N)
    del a, b
    y = torch.einsum("shpn,shn->shp", hs, c3)
    y = y + x3 * layer["d"][None, :, None]
    y = _gated_norm(y.reshape(s, i_sz), gate, layer["gate_norm"],
                    cfg.norm_eps)
    out = y.to(x_seq.dtype) @ layer["w_out"]
    return out, x_cat[last_idx + 1:last_idx + k], hs[last_idx]


def _logits(params, cfg, x: torch.Tensor) -> torch.Tensor:
    return (_rms(x, params["out_norm"], cfg.norm_eps)
            @ params["lm_head"]).float()


def _seq_forward2(params, cfg: Mamba2Config, tokens: torch.Tensor,
                  n_valid: int, cache: Mamba2Cache
                  ) -> Tuple[torch.Tensor, Mamba2Cache]:
    last = max(int(n_valid) - 1, 0)
    x = params["tok_emb"][tokens.long()]
    convs, ssms = [], []
    for li in range(cfg.n_layers):
        layer = _layer(params["layers"], li)
        h = _rms(x, layer["norm"], cfg.norm_eps)
        out, conv_s, ssm_s = _mixer_seq2(layer, cfg, h, cache.conv[li],
                                         cache.ssm[li], last)
        x = x + out
        convs.append(conv_s)
        ssms.append(ssm_s)
    logits = _logits(params, cfg, x[last][None])[0]
    return logits, Mamba2Cache(conv=torch.stack(convs).to(cache.conv.dtype),
                               ssm=torch.stack(ssms),
                               length=cache.length + int(n_valid))


@torch.no_grad()
def prefill(params: Dict[str, Any], cfg: Mamba2Config, tokens: torch.Tensor,
            length: int, cache: Mamba2Cache
            ) -> Tuple[torch.Tensor, Mamba2Cache]:
    """Prompt ingestion from a zero state (``cache`` gives dtype and
    device), as ``models/mamba.py:prefill``."""
    zero = Mamba2Cache.create(cfg, dtype=cache.conv.dtype,
                              device=cache.conv.device)
    return _seq_forward2(params, cfg, tokens, length, zero)


@torch.no_grad()
def extend(params: Dict[str, Any], cfg: Mamba2Config, tokens: torch.Tensor,
           n_valid: int, cache: Mamba2Cache
           ) -> Tuple[torch.Tensor, Mamba2Cache]:
    return _seq_forward2(params, cfg, tokens, n_valid, cache)


@torch.no_grad()
def decode_step(params: Dict[str, Any], cfg: Mamba2Config, token,
                cache: Mamba2Cache) -> Tuple[torch.Tensor, Mamba2Cache]:
    """One token (an int or a 0-d device tensor): the direct recurrence."""
    x = _embed(params, token)
    hh, p, n, g = cfg.n_heads, cfg.head_dim, cfg.d_state, cfg.n_groups
    i_sz = cfg.d_inner
    rep = hh // g
    convs, ssms = [], []
    for li in range(cfg.n_layers):
        layer = _layer(params["layers"], li)
        conv_l, ssm_l = cache.conv[li], cache.ssm[li]
        h_in = _rms(x, layer["norm"], cfg.norm_eps)
        gate, xbc, dt = _in_proj(h_in, layer)[0].split(
            [i_sz, cfg.conv_dim, hh])
        x_cat = torch.cat([conv_l.to(xbc.dtype), xbc[None]], dim=0)
        conv = (x_cat * layer["conv_w"]).sum(0) + layer["conv_b"]
        xi, b_in, c_in = F.silu(conv).split([i_sz, g * n, g * n])
        dt = _dt(dt, layer, cfg)                              # (H,)
        d_a = torch.exp(dt * -torch.exp(layer["A_log"].float()))
        x3 = xi.float().reshape(hh, p)
        b2 = b_in.float().reshape(g, n).repeat_interleave(rep, dim=0)
        c2 = c_in.float().reshape(g, n).repeat_interleave(rep, dim=0)
        ssm = (d_a[:, None, None] * ssm_l
               + (dt[:, None] * x3)[..., None] * b2[:, None, :])
        y = torch.einsum("hpn,hn->hp", ssm, c2)
        y = y + x3 * layer["d"][:, None]
        y = _gated_norm(y.reshape(1, i_sz), gate[None], layer["gate_norm"],
                        cfg.norm_eps)
        x = x + y.to(x.dtype) @ layer["w_out"]
        convs.append(x_cat[1:])
        ssms.append(ssm)
    logits = _logits(params, cfg, x)[0]
    return logits, Mamba2Cache(conv=torch.stack(convs).to(cache.conv.dtype),
                               ssm=torch.stack(ssms),
                               length=cache.length + 1)


def init_params(generator: torch.Generator, cfg: Mamba2Config,
                dtype: torch.dtype = torch.bfloat16,
                device: Optional[torch.device] = None) -> Dict[str, Any]:
    """Random params in ``mamba2_from_hf``'s layout on ``device``
    (``generator`` lives there): matrices at 1/sqrt(fan-in), the
    convolution at 0.2, ``A_log`` log(1..H), a dt bias of -2, ``d`` and
    the norms at one; the SSM leaves in f32, as the converter keeps them.
    The reference package has no such initializer; its tests convert a random
    state dict."""
    device = default_device(device, "build Mamba-2 params")
    n, d, hh = cfg.n_layers, cfg.dim, cfg.n_heads
    proj = cfg.d_inner + cfg.conv_dim + hh

    def w(*shape, s=None):
        s = s or 1.0 / math.sqrt(shape[-2])
        return (torch.randn(shape, generator=generator, device=device)
                * s).to(dtype)

    def full(shape, v, dt=dtype):
        return torch.full(shape, v, dtype=dt, device=device)

    layers = {
        "norm": full((n, d), 1.0),
        "w_in": w(n, d, proj),
        "conv_w": w(n, cfg.d_conv, cfg.conv_dim, s=0.2),
        "conv_b": full((n, cfg.conv_dim), 0.0),
        "dt_bias": full((n, hh), -2.0, torch.float32),
        "A_log": torch.log(torch.arange(
            1, hh + 1, dtype=torch.float32, device=device)).expand(
                n, hh).contiguous(),
        "d": full((n, hh), 1.0, torch.float32),
        "gate_norm": full((n, cfg.d_inner), 1.0, torch.float32),
        "w_out": w(n, cfg.d_inner, d),
    }
    return {"tok_emb": w(cfg.vocab_size, d, s=0.02), "layers": layers,
            "out_norm": full((d,), 1.0), "lm_head": w(d, cfg.vocab_size)}
