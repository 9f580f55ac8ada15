"""Text embedding model: the BERT-family encoder behind semantic memory.

Port of ``trackiellm_tpu/models/embedder.py``: a bidirectional post-LN
transformer encoder with learned position and token-type embeddings,
masked mean / CLS / tanh-pooler pooling and L2-normalized sentence
vectors (HF ``BertModel`` semantics: all-MiniLM, BGE, GTE; llama.cpp's
``bert`` arch), and the cross-encoder reranking head. ``TrackieApp``'s
``embed_fn`` takes :meth:`Embedder.embed`, and ``MemoryManager`` then
ranks memories by cosine similarity.

The reference's attention and matmuls are plain XLA (no Pallas kernel), so
this module is plain torch ops on the params' device, under ``exact_f32``
as the voice, vision and CLIP forwards run. Ragged batches pad to the
reference's static ``(batch, length)`` buckets, so the padding the
encoder sees is the reference's.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, NamedTuple, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from trackiellm_tpu_torch.ops.backend import exact_f32


class EmbedderConfig(NamedTuple):
    vocab_size: int = 30522
    hidden: int = 384
    n_layers: int = 6
    n_heads: int = 12
    intermediate: int = 1536
    max_pos: int = 512
    type_vocab: int = 2
    eps: float = 1e-12
    # "mean" (sentence-transformers default, llama.cpp pooling_type 1),
    # "cls" (pooling_type 2), or "pooler" (tanh dense over CLS).
    pooling: str = "mean"

    @classmethod
    def minilm_l6(cls) -> "EmbedderConfig":
        """all-MiniLM-L6-v2 geometry (the llama.cpp embedding demo
        model)."""
        return cls()

    @classmethod
    def test_tiny(cls) -> "EmbedderConfig":
        return cls(vocab_size=128, hidden=32, n_layers=2, n_heads=4,
                   intermediate=64, max_pos=64)


def _ln(x, g, b, eps):
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = (x32 - mu).square().mean(-1, keepdim=True)
    return ((x32 - mu) * torch.rsqrt(var + eps) * g + b).to(x.dtype)


def init_embedder(gen: torch.Generator, cfg: EmbedderConfig,
                  dtype: torch.dtype = torch.float32) -> Dict[str, Any]:
    """Random params from ``gen``, on its device, in the converters'
    layout (N(0, 1/fan_in) matrices, N(0, 0.02) embeddings)."""
    dev = gen.device
    h, m, L = cfg.hidden, cfg.intermediate, cfg.n_layers

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=dev, dtype=dtype)

    def lin(cin, cout):
        return normal(L, cin, cout) * (1.0 / math.sqrt(cin))

    def zeros(*shape):
        return torch.zeros(shape, device=dev, dtype=dtype)

    def ones(*shape):
        return torch.ones(shape, device=dev, dtype=dtype)

    return {
        "word_emb": normal(cfg.vocab_size, h) * 0.02,
        "pos_emb": normal(cfg.max_pos, h) * 0.02,
        "type_emb": normal(cfg.type_vocab, h) * 0.02,
        "emb_norm": {"g": ones(h), "b": zeros(h)},
        "layers": {
            "wq": lin(h, h), "bq": zeros(L, h),
            "wk": lin(h, h), "bk": zeros(L, h),
            "wv": lin(h, h), "bv": zeros(L, h),
            "wo": lin(h, h), "bo": zeros(L, h),
            "attn_norm_g": ones(L, h), "attn_norm_b": zeros(L, h),
            "wi": lin(h, m), "bi": zeros(L, m),
            "wd": lin(m, h), "bd": zeros(L, h),
            "out_norm_g": ones(L, h), "out_norm_b": zeros(L, h),
        },
        "pooler": {"w": normal(h, h) / math.sqrt(h), "b": zeros(h)},
    }


@torch.no_grad()
def encoder_forward(params: Dict[str, Any], cfg: EmbedderConfig,
                    ids: torch.Tensor, mask: torch.Tensor,
                    type_ids: torch.Tensor = None) -> torch.Tensor:
    """(B, T) int ids + (B, T) {0,1} mask -> (B, T, H) hidden states.
    Bidirectional attention; padded positions get a -1e9 additive bias.
    ``type_ids`` (segment ids, pair inputs for reranking) default 0."""
    b, t = ids.shape
    h, nh = cfg.hidden, cfg.n_heads
    hd = h // nh
    ids = ids.long()
    if type_ids is None:
        type_emb = params["type_emb"][0][None, None]
    else:
        type_emb = params["type_emb"][type_ids.long()]
    with exact_f32():
        x = (params["word_emb"][ids] + params["pos_emb"][:t][None]
             + type_emb)
        x = _ln(x, params["emb_norm"]["g"], params["emb_norm"]["b"],
                cfg.eps)
        bias = torch.zeros((b, 1, 1, t), dtype=torch.float32,
                           device=x.device)
        bias = bias.masked_fill(mask[:, None, None, :] <= 0, -1e9)

        def heads(v):
            return v.reshape(b, t, nh, hd).transpose(1, 2)

        lay = params["layers"]
        for i in range(cfg.n_layers):
            lp = {k: v[i] for k, v in lay.items()}
            q = heads(x @ lp["wq"] + lp["bq"])
            k = heads(x @ lp["wk"] + lp["bk"])
            v = heads(x @ lp["wv"] + lp["bv"])
            scores = (q @ k.transpose(2, 3)) / math.sqrt(hd)
            probs = torch.softmax(scores.float() + bias, dim=-1).to(x.dtype)
            ctx = (probs @ v).transpose(1, 2).reshape(b, t, h)
            x = _ln(x + (ctx @ lp["wo"] + lp["bo"]), lp["attn_norm_g"],
                    lp["attn_norm_b"], cfg.eps)
            ff = F.gelu(x @ lp["wi"] + lp["bi"]) @ lp["wd"] + lp["bd"]
            x = _ln(x + ff, lp["out_norm_g"], lp["out_norm_b"], cfg.eps)
    return x


def _pooler(params, first: torch.Tensor) -> torch.Tensor:
    return torch.tanh(first @ params["pooler"]["w"] + params["pooler"]["b"])


@torch.no_grad()
def embed_forward(params: Dict[str, Any], cfg: EmbedderConfig,
                  ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """(B, T) ids + mask -> (B, H) L2-normalized f32 sentence embeddings
    (pooling per cfg.pooling)."""
    hidden = encoder_forward(params, cfg, ids, mask)
    with exact_f32():
        if cfg.pooling == "cls":
            pooled = hidden[:, 0]
        elif cfg.pooling == "pooler":
            pooled = _pooler(params, hidden[:, 0])
        else:  # masked mean (sentence-transformers / llama.cpp default)
            m = mask[..., None].to(hidden.dtype)
            pooled = (hidden * m).sum(1) / torch.clamp(m.sum(1), min=1e-9)
        norm = torch.linalg.vector_norm(pooled.float(), dim=-1,
                                        keepdim=True)
        return (pooled / torch.clamp(norm, min=1e-12)).float()


@torch.no_grad()
def rank_forward(params: Dict[str, Any], cfg: EmbedderConfig,
                 ids: torch.Tensor, mask: torch.Tensor,
                 type_ids: torch.Tensor) -> torch.Tensor:
    """Cross-encoder reranking: (B, T) [CLS] query [SEP] doc [SEP] pairs
    (segment ids 0/1) -> (B,) relevance scores: HF
    ``BertForSequenceClassification(num_labels=1)``, classifier(pooler(CLS)),
    which is llama.cpp's RANK pooling over the bert arch."""
    hidden = encoder_forward(params, cfg, ids, mask, type_ids)
    out = params["cls_out"]
    with exact_f32():
        pooled = _pooler(params, hidden[:, 0])
        return (pooled @ out["w"] + out["b"])[:, 0].float()


# Static (batch, length) buckets, the reference's: a ragged batch pads as
# it pads there.
_LEN_BUCKETS = (16, 32, 64, 128, 256, 512)
_BATCH_BUCKETS = (1, 2, 4, 8, 16, 32)


def _bucket(n: int, buckets: Sequence[int]) -> int:
    for bkt in buckets:
        if n <= bkt:
            return bkt
    return buckets[-1]


class Embedder:
    """Host-side convenience: tokenizer + bucketed batched embedding on
    the params' device, results fetched to the host in one copy.

    ``tokenizer`` must provide ``encode_with_special(text) -> List[int]``
    (WordPieceTokenizer does) or plain ``encode``.
    """

    def __init__(self, params: Dict[str, Any], cfg: EmbedderConfig,
                 tokenizer=None):
        self.params = params
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.device = params["word_emb"].device

    def _ids(self, text: str) -> List[int]:
        tok = self.tokenizer
        if hasattr(tok, "encode_with_special"):
            ids = tok.encode_with_special(text)
        else:
            ids = tok.encode(text)
        return ids[: min(self.cfg.max_pos, _LEN_BUCKETS[-1])]

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    def embed(self, texts: Sequence[str]) -> np.ndarray:
        """List of strings -> (N, H) float32 unit vectors on the host."""
        if not texts:
            return np.zeros((0, self.cfg.hidden), np.float32)
        return self.embed_ids([self._ids(t) for t in texts])

    def embed_ids(self, idlists: Sequence[Sequence[int]]) -> np.ndarray:
        cap = _BATCH_BUCKETS[-1]
        if len(idlists) > cap:
            # Past the largest batch bucket, one call a bucket's worth (the
            # reference writes past its (32, T) buffer there and raises).
            return np.concatenate([self.embed_ids(idlists[i:i + cap])
                                   for i in range(0, len(idlists), cap)])
        n = len(idlists)
        t = _bucket(max((len(i) for i in idlists), default=1),
                    _LEN_BUCKETS)
        bb = _bucket(n, _BATCH_BUCKETS)
        ids = np.zeros((bb, t), np.int32)
        mask = np.zeros((bb, t), np.int32)
        for i, row in enumerate(idlists):
            row = list(row)[:t]
            ids[i, :len(row)] = row
            mask[i, :len(row)] = 1
        out = embed_forward(self.params, self.cfg, self._tensor(ids),
                            self._tensor(mask))
        return out.cpu().numpy()[:n]

    def rank(self, query: str, docs: Sequence[str]) -> np.ndarray:
        """Cross-encode (query, doc) pairs -> (len(docs),) relevance
        scores (requires a checkpoint with the cls head: rerankers)."""
        if "cls_out" not in self.params:
            raise ValueError("checkpoint has no reranking head "
                             "(cls.output tensors absent)")
        cap = _BATCH_BUCKETS[-1]
        if len(docs) > cap:  # as embed_ids does
            return np.concatenate([self.rank(query, docs[i:i + cap])
                                   for i in range(0, len(docs), cap)])
        tok = self.tokenizer
        q = tok.encode(query)
        n = len(docs)
        cap = min(self.cfg.max_pos, _LEN_BUCKETS[-1])
        rows, types = [], []
        for d in docs:
            di = tok.encode(d)
            ids = [tok.cls_id] + q + [tok.sep_id] + di + [tok.sep_id]
            tys = [0] * (len(q) + 2) + [1] * (len(di) + 1)
            rows.append(ids[:cap])
            types.append(tys[:cap])
        t = _bucket(max(len(r) for r in rows), _LEN_BUCKETS)
        bb = _bucket(n, _BATCH_BUCKETS)
        ids = np.zeros((bb, t), np.int32)
        mask = np.zeros((bb, t), np.int32)
        tys = np.zeros((bb, t), np.int32)
        for i, (row, ty) in enumerate(zip(rows, types)):
            ids[i, :len(row)] = row[:t]
            mask[i, :len(row)] = 1
            tys[i, :len(row)] = ty[:t]
        out = rank_forward(self.params, self.cfg, self._tensor(ids),
                           self._tensor(mask), self._tensor(tys))
        return out.cpu().numpy()[:n]


def cosine_topk(query: np.ndarray, corpus: np.ndarray,
                k: int) -> Tuple[np.ndarray, np.ndarray]:
    """(H,) query vs (N, H) corpus (all unit vectors) -> (scores, idx)
    of the top-k by cosine similarity (host numpy, as the reference)."""
    if corpus.shape[0] == 0:
        return np.zeros((0,), np.float32), np.zeros((0,), np.int64)
    sims = corpus @ query
    k = min(k, corpus.shape[0])
    idx = np.argpartition(-sims, k - 1)[:k]
    idx = idx[np.argsort(-sims[idx])]
    return sims[idx], idx
