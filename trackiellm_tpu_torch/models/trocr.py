"""TrOCR: transformer OCR (ViT/DeiT encoder + BART-style text decoder).

Port of ``trackiellm_tpu/models/trocr.py``, the OCR stage's published
checkpoint route: microsoft/trocr-* (printed/handwritten, small/base/large)
load through ``convert.trocr_from_hf`` and run here, and
:class:`TrOCREngine` plugs into ``VisionPipeline(ocr_fn=...)`` (reference
behaviour: the Tesseract engine, src/vision/tk_text_recognition.cpp:71-104).

The reference's attention and matmuls are plain XLA (no Pallas kernel), so
this module is plain torch ops on the params' device under ``exact_f32``:

- the encoder is a pre-LN ViT with the patchify as one matmul (``patch_w``
  is stored ``(3*P*P, D)``);
- the greedy decoder runs the reference's whole token budget with no host
  round trip: each layer's self-attention cache is one ``(B, max_len, D)``
  tensor written in place a step, and the cross-attention K/V are computed
  once from ``enc_out``;
- crops batch along a leading axis where the reference ``vmap``s.
"""

from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from trackiellm_tpu_torch.ops.backend import exact_f32


class TrOCRConfig(NamedTuple):
    # encoder (ViT/DeiT)
    image_size: int = 384
    patch_size: int = 16
    enc_dim: int = 768
    enc_layers: int = 12
    enc_heads: int = 12
    enc_hidden: int = 3072
    n_prefix: int = 1            # 1 = ViT [CLS]; 2 = DeiT [CLS, DIST]
    enc_eps: float = 1e-12
    # decoder (TrOCR / BART-style, post-norm)
    vocab_size: int = 50265
    d_model: int = 1024
    dec_layers: int = 12
    dec_heads: int = 16
    dec_ffn: int = 4096
    max_len: int = 64            # generation budget
    scale_embedding: bool = False
    layernorm_embedding: bool = True
    dec_eps: float = 1e-5
    act: str = "gelu"
    # special ids (from the HF config)
    decoder_start_id: int = 2
    eos_id: int = 2
    pad_id: int = 1

    @property
    def n_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def enc_seq(self) -> int:
        return self.n_patches + self.n_prefix

    @classmethod
    def tiny(cls) -> "TrOCRConfig":
        return cls(image_size=32, patch_size=8, enc_dim=32, enc_layers=2,
                   enc_heads=4, enc_hidden=64, vocab_size=100, d_model=32,
                   dec_layers=2, dec_heads=4, dec_ffn=64, max_len=12)

    @classmethod
    def base(cls) -> "TrOCRConfig":
        """microsoft/trocr-base-printed / -handwritten shape."""
        return cls()

    @classmethod
    def small(cls) -> "TrOCRConfig":
        """microsoft/trocr-small-* shape (DeiT encoder)."""
        return cls(enc_dim=384, enc_layers=12, enc_heads=6,
                   enc_hidden=1536, n_prefix=2, vocab_size=64044,
                   d_model=256, dec_layers=6, dec_heads=8, dec_ffn=1024)


# ---------------------------------------------------------------------------
# Blocks shared with models/ast.py. Activations carry a leading batch axis:
# (B, T, D).
# ---------------------------------------------------------------------------

def _act(x, name: str):
    if name == "gelu":
        return F.gelu(x)
    if name == "relu":
        return F.relu(x)
    raise ValueError(f"unsupported activation {name!r}")


def _ln(x, g, b, eps):
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * g + b


def _mha(q, k, v, heads: int):
    """(B, Tq, D) x (B, Tk, D) -> scaled scores (B, H, Tq, Tk) and the
    head-split values (B, H, Tk, Dh); a mask is added by
    :func:`_attn_out`'s ``bias``."""
    b, tq, d = q.shape
    tk = k.shape[1]
    dh = d // heads
    qh = q.reshape(b, tq, heads, dh).transpose(1, 2)
    kh = k.reshape(b, tk, heads, dh).transpose(1, 2)
    vh = v.reshape(b, tk, heads, dh).transpose(1, 2)
    return (qh @ kh.transpose(2, 3)) / math.sqrt(dh), vh


def _attn_out(s, vh, bias=None):
    if bias is not None:
        s = s + bias
    o = torch.softmax(s, dim=-1) @ vh
    b, h, tq, dh = o.shape
    return o.transpose(1, 2).reshape(b, tq, h * dh)


def _vit_layer(h, lp, heads: int, eps: float):
    """One pre-LN ViT encoder layer (TrOCR's encoder and AST's)."""
    y = _ln(h, lp["ln1_g"], lp["ln1_b"], eps)
    s, vh = _mha(y @ lp["wq"] + lp["bq"], y @ lp["wk"] + lp["bk"],
                 y @ lp["wv"] + lp["bv"], heads)
    h = h + (_attn_out(s, vh) @ lp["wo"] + lp["bo"])
    y = _ln(h, lp["ln2_g"], lp["ln2_b"], eps)
    y = _act(y @ lp["w1"] + lp["b1"], "gelu") @ lp["w2"] + lp["b2"]
    return h + y


def _layer(layers: Dict[str, torch.Tensor], i: int) -> Dict[str, Any]:
    return {k: v[i] for k, v in layers.items()}


# ---------------------------------------------------------------------------
# Encoder (pre-LN ViT / DeiT)
# ---------------------------------------------------------------------------

@torch.no_grad()
def encode_batch(params: Dict[str, Any], cfg: TrOCRConfig,
                 pixels: torch.Tensor) -> torch.Tensor:
    """(B, 3, H, W) normalized pixels -> (B, enc_seq, enc_dim) encoder
    hidden states (after the final layernorm)."""
    p = params["enc"]
    bsz, c, hh, ww = pixels.shape
    ps = cfg.patch_size
    with exact_f32():
        # (B, 3, H, W) -> (B, n_patches, 3*ps*ps): the conv patchify's rows
        x = pixels.reshape(bsz, c, hh // ps, ps, ww // ps, ps)
        x = x.permute(0, 2, 4, 1, 3, 5).reshape(bsz, cfg.n_patches,
                                                 c * ps * ps)
        x = x @ p["patch_w"] + p["patch_b"]
        x = torch.cat([p["prefix"][None].expand(bsz, -1, -1), x],
                      dim=1) + p["pos"]
        for i in range(cfg.enc_layers):
            x = _vit_layer(x, _layer(p["layers"], i), cfg.enc_heads,
                           cfg.enc_eps)
        return _ln(x, p["ln_g"], p["ln_b"], cfg.enc_eps)


def encode(params: Dict[str, Any], cfg: TrOCRConfig,
           pixels: torch.Tensor) -> torch.Tensor:
    """(3, H, W) normalized pixels -> (enc_seq, enc_dim)."""
    return encode_batch(params, cfg, pixels[None])[0]


# ---------------------------------------------------------------------------
# Decoder (BART-style post-norm with cross-attention)
# ---------------------------------------------------------------------------

def _embed(p, cfg: TrOCRConfig, ids: torch.Tensor,
           positions: torch.Tensor) -> torch.Tensor:
    scale = math.sqrt(cfg.d_model) if cfg.scale_embedding else 1.0
    x = p["embed"][ids] * scale + p["pos"][positions + 2]  # BART offset
    if cfg.layernorm_embedding:
        x = _ln(x, p["ln_emb_g"], p["ln_emb_b"], cfg.dec_eps)
    return x


def _dec_layer(h, lp, cfg: TrOCRConfig, self_kv, cross_kv, bias=None):
    """One post-norm decoder layer over (B, T, D) rows, attending to the
    given self (k, v) and cross (k, v)."""
    s, vh = _mha(h @ lp["wq"] + lp["bq"], *self_kv, cfg.dec_heads)
    h = h + (_attn_out(s, vh, bias=bias) @ lp["wo"] + lp["bo"])
    h = _ln(h, lp["ln_sa_g"], lp["ln_sa_b"], cfg.dec_eps)
    s, vh = _mha(h @ lp["cq"] + lp["cbq"], *cross_kv, cfg.dec_heads)
    h = h + (_attn_out(s, vh) @ lp["co"] + lp["cbo"])
    h = _ln(h, lp["ln_ca_g"], lp["ln_ca_b"], cfg.dec_eps)
    y = _act(h @ lp["w1"] + lp["b1"], cfg.act) @ lp["w2"] + lp["b2"]
    return _ln(h + y, lp["ln_f_g"], lp["ln_f_b"], cfg.dec_eps)


@torch.no_grad()
def decoder_logits(params: Dict[str, Any], cfg: TrOCRConfig,
                   enc_out: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Teacher-forced full-sequence decoder: (T,) ids -> (T, vocab)."""
    p = params["dec"]
    t = ids.shape[0]
    pos = torch.arange(t, device=ids.device)
    causal = torch.zeros((t, t), device=enc_out.device).masked_fill(
        pos[:, None] < pos[None, :], -math.inf)
    with exact_f32():
        x = _embed(p, cfg, ids.long(), pos)[None]
        e = enc_out[None]
        for i in range(cfg.dec_layers):
            lp = _layer(p["layers"], i)
            kv = (x @ lp["wk"] + lp["bk"], x @ lp["wv"] + lp["bv"])
            ckv = (e @ lp["ck"] + lp["cbk"], e @ lp["cv"] + lp["cbv"])
            x = _dec_layer(x, lp, cfg, kv, ckv, bias=causal)
        return x[0] @ p["out_w"].T


@torch.no_grad()
def greedy_ids_batch(params: Dict[str, Any], cfg: TrOCRConfig,
                     enc_out: torch.Tensor) -> torch.Tensor:
    """(B, enc_seq, enc_dim) encoder states -> (B, max_len) greedy ids,
    the whole budget on the device (an id after an EOS is garbage by
    construction: the host cuts at EOS)."""
    p = params["dec"]
    bsz = enc_out.shape[0]
    dev = enc_out.device
    ids = torch.empty((bsz, cfg.max_len), dtype=torch.long, device=dev)
    tok = torch.full((bsz,), cfg.decoder_start_id, dtype=torch.long,
                     device=dev)
    with exact_f32():
        lps = [_layer(p["layers"], i) for i in range(cfg.dec_layers)]
        cross = [(enc_out @ lp["ck"] + lp["cbk"],
                  enc_out @ lp["cv"] + lp["cbv"]) for lp in lps]
        kc = torch.zeros((cfg.dec_layers, bsz, cfg.max_len, cfg.d_model),
                         device=dev)
        vc = torch.zeros_like(kc)
        for t in range(cfg.max_len):
            h = _embed(p, cfg, tok[:, None],
                       torch.full((1,), t, dtype=torch.long, device=dev))
            for li, lp in enumerate(lps):
                kc[li, :, t] = (h @ lp["wk"] + lp["bk"])[:, 0]
                vc[li, :, t] = (h @ lp["wv"] + lp["bv"])[:, 0]
                h = _dec_layer(h, lp, cfg,
                               (kc[li, :, :t + 1], vc[li, :, :t + 1]),
                               cross[li])
            tok = torch.argmax(h[:, 0] @ p["out_w"].T, dim=-1)
            ids[:, t] = tok
    return ids


def greedy_ids(params: Dict[str, Any], cfg: TrOCRConfig,
               enc_out: torch.Tensor) -> torch.Tensor:
    """(enc_seq, enc_dim) -> (max_len,) generated ids."""
    return greedy_ids_batch(params, cfg, enc_out[None])[0]


# ---------------------------------------------------------------------------
# Engine: the vision pipeline's ocr_fn surface
# ---------------------------------------------------------------------------

class TrOCREngine:
    """Batch OCR over image crops: plugs into
    ``vision.pipeline.VisionPipeline(ocr_fn=...)`` (crops -> texts), on the
    params' device.

    ``decode_ids``: ids -> text (a tokenizer decode; for real checkpoints
    pass the RobertaTokenizer/XLMRoberta decode; tests use a byte map)."""

    def __init__(self, params: Dict[str, Any], cfg: TrOCRConfig,
                 decode_ids, mean=(0.5, 0.5, 0.5), std=(0.5, 0.5, 0.5)):
        self.params = params
        self.cfg = cfg
        self.decode_ids = decode_ids
        self.device = params["enc"]["patch_w"].device
        self.mean = torch.tensor(mean, dtype=torch.float32,
                                 device=self.device).reshape(3, 1, 1)
        self.std = torch.tensor(std, dtype=torch.float32,
                                device=self.device).reshape(3, 1, 1)
        self._255 = torch.tensor(255.0, device=self.device)

    def _prep(self, crop) -> torch.Tensor:
        """Grayscale or RGB crop (H, W[, 3]) in [0,1] or [0,255], host
        array or tensor -> normalized (3, S, S) f32 on the engine's
        device."""
        raw = crop if isinstance(crop, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(crop))
        a = raw.to(self.device).float()
        # Scale keyed on dtype, not observed max: a near-black uint8 crop
        # (max 0/1) must still divide by 255. A 0-dim divisor keeps the
        # CPU's quotient on the card.
        if not raw.dtype.is_floating_point:
            a = a / self._255
        elif float(a.max()) > 1.5:
            a = a / self._255
        if a.ndim == 3 and a.shape[-1] == 1:
            a = a[..., 0]  # (H, W, 1) channel-last grayscale
        if a.ndim == 2:
            a = torch.stack([a] * 3)
        elif a.shape[-1] == 3:
            a = a.permute(2, 0, 1)
        s = self.cfg.image_size
        _, hh, ww = a.shape
        # Nearest-neighbour resize, the reference's index arithmetic.
        yi = torch.from_numpy(np.clip((np.arange(s) * hh) // max(s, 1), 0,
                                      hh - 1)).to(self.device)
        xi = torch.from_numpy(np.clip((np.arange(s) * ww) // max(s, 1), 0,
                                      ww - 1)).to(self.device)
        a = a[:, yi][:, :, xi]
        return (a - self.mean) / self.std

    def __call__(self, crops) -> list:
        batch = torch.stack([self._prep(c) for c in crops])
        ids = greedy_ids_batch(self.params, self.cfg,
                               encode_batch(self.params, self.cfg, batch))
        ids = ids.cpu().numpy().astype(np.int32)
        texts = []
        for row in ids:
            stop = np.nonzero(row == self.cfg.eos_id)[0]
            texts.append(self.decode_ids(
                row[: stop[0]] if stop.size else row))
        return texts


def init_params(gen: torch.Generator, cfg: TrOCRConfig,
                dtype: torch.dtype = torch.float32) -> Dict[str, Any]:
    """Random params from ``gen``, on its device (tests, the smoke):
    N(0, 0.05) matrices and embeddings, unit norms, zero biases, as the
    reference's ``init_params``."""
    dev = gen.device

    def R(*shape, s=0.05):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=dtype) * s

    def zeros(*shape):
        return torch.zeros(shape, device=dev, dtype=dtype)

    def ones(*shape):
        return torch.ones(shape, device=dev, dtype=dtype)

    d, hd, ne = cfg.enc_dim, cfg.enc_hidden, cfg.enc_layers
    enc_layers = {"ln1_g": ones(ne, d), "ln1_b": zeros(ne, d),
                  "ln2_g": ones(ne, d), "ln2_b": zeros(ne, d)}
    for nm, shp in (("wq", (d, d)), ("wk", (d, d)), ("wv", (d, d)),
                    ("wo", (d, d)), ("w1", (d, hd)), ("w2", (hd, d))):
        enc_layers[nm] = R(ne, *shp)
    for nm, width in (("bq", d), ("bk", d), ("bv", d), ("bo", d),
                      ("b1", hd), ("b2", d)):
        enc_layers[nm] = zeros(ne, width)
    enc = {
        "patch_w": R(3 * cfg.patch_size ** 2, d),
        "patch_b": zeros(d),
        "prefix": R(cfg.n_prefix, d),
        "pos": R(cfg.enc_seq, d),
        "ln_g": ones(d), "ln_b": zeros(d),
        "layers": enc_layers,
    }

    dm, ff, nd = cfg.d_model, cfg.dec_ffn, cfg.dec_layers
    dec_layers = {}
    # Cross-attention keys and values read the encoder's width, as the
    # converted checkpoints' (TrOCR-base: 768 into 1024). The reference's
    # init draws them (d_model, d_model), which only its tiny config, where
    # the two widths are equal, can run.
    for nm, shp in (("wq", (dm, dm)), ("wk", (dm, dm)), ("wv", (dm, dm)),
                    ("wo", (dm, dm)), ("cq", (dm, dm)), ("ck", (d, dm)),
                    ("cv", (d, dm)), ("co", (dm, dm)),
                    ("w1", (dm, ff)), ("w2", (ff, dm))):
        dec_layers[nm] = R(nd, *shp)
    for nm, width in (("bq", dm), ("bk", dm), ("bv", dm), ("bo", dm),
                      ("cbq", dm), ("cbk", dm), ("cbv", dm), ("cbo", dm),
                      ("b1", ff), ("b2", dm)):
        dec_layers[nm] = zeros(nd, width)
    for nm in ("ln_sa", "ln_ca", "ln_f"):
        dec_layers[f"{nm}_g"] = ones(nd, dm)
        dec_layers[f"{nm}_b"] = zeros(nd, dm)
    dec = {
        "embed": R(cfg.vocab_size, dm),
        "pos": R(cfg.max_len + 2 + 2, dm),
        "ln_emb_g": ones(dm), "ln_emb_b": zeros(dm),
        "out_w": R(cfg.vocab_size, dm),
        "layers": dec_layers,
    }
    return {"enc": enc, "dec": dec}
