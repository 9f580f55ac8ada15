"""Embedding accuracy parity: run BERT-family weights through the port's
embedder over a text file and score cosine similarity against expected
embeddings (dumped from sentence-transformers or ``llama-embedding``).

    python -m trackiellm_tpu_torch.tools.parity_embed --checkpoint W \\
        --texts sentences.txt [--vocab vocab.txt] [--expected E.npy]
        [--pooling mean|cls|pooler] [--out embed_out.npy] [--device D]
        [--no-record]

The twin of the JAX package's ``tools/parity_embed.py``: the same flags
(plus ``--device``), failures and JSON payload. Checkpoints: an HF
BertModel state dict (.pt/.safetensors/.npz, with ``--vocab``'s WordPiece
list) or a llama.cpp bert GGUF (vocabulary embedded). Metric: the mean
cosine between produced and expected rows (both L2-normalized) and the
top-1 retrieval agreement over the set. Without ``--expected`` it dumps
the embeddings to ``--out``.
"""

from __future__ import annotations

import argparse

import numpy as np

from trackiellm_tpu_torch.tools.parity_common import (
    die, emit, load_state_dict, ready, record, require_file)
from trackiellm_tpu_torch.tools.parity_common import device as pick_device


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="parity_embed")
    ap.add_argument("--checkpoint", required=True,
                    help="BERT weights (.pt/.safetensors/.npz/.gguf)")
    ap.add_argument("--texts", required=True,
                    help="file with one sentence per line")
    ap.add_argument("--vocab", default=None,
                    help="WordPiece vocab.txt (one piece per line) — "
                    "required for non-GGUF checkpoints")
    ap.add_argument("--expected", default=None,
                    help=".npy (N, H) of expected embeddings, row order "
                    "= line order (omit to dump)")
    ap.add_argument("--pooling", default=None,
                    choices=[None, "mean", "cls", "pooler"])
    ap.add_argument("--out", default="embed_out.npy")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--no-record", action="store_true")
    args = ap.parse_args(argv)

    ckpt = require_file(args.checkpoint, "embedder checkpoint",
                        "HF BertModel state dict or llama.cpp bert GGUF")
    tpath = require_file(args.texts, "text file",
                         "one sentence per line")
    texts = [ln.strip() for ln in open(tpath, encoding="utf-8")
             if ln.strip()]
    if not texts:
        die(f"{tpath!r} contains no sentences")

    dev = pick_device(args.device, "parity_embed")
    ready("parity_embed", dev)
    from trackiellm_tpu_torch.llm.tokenizer import WordPieceTokenizer
    from trackiellm_tpu_torch.models import convert
    from trackiellm_tpu_torch.models.embedder import Embedder

    if ckpt.endswith(".gguf"):
        try:
            params, cfg, tok = convert.gguf_to_bert_params(
                ckpt, pooling=args.pooling, device=dev)
        except KeyError as exc:
            die(f"GGUF does not match the llama.cpp bert layout "
                f"(missing {exc}); `trackiellm_tpu_torch inspect` lists "
                f"its tensors")
        if tok is None:
            die("GGUF has no embedded WordPiece vocab "
                "(tokenizer.ggml.model != 'bert')")
    else:
        state = load_state_dict(ckpt)
        try:
            params, cfg = convert.bert_from_hf(
                state, pooling=args.pooling or "mean", device=dev)
        except KeyError as exc:
            die(f"checkpoint does not match the HF BertModel layout "
                f"(missing {exc}); run python -m trackiellm_tpu_torch "
                f"inspect")
        vpath = require_file(
            args.vocab or "", "WordPiece vocab",
            "pass --vocab vocab.txt (the HF tokenizer's vocab file)")
        tok = WordPieceTokenizer(
            [ln.rstrip("\n") for ln in open(vpath, encoding="utf-8")])

    emb = Embedder(params, cfg, tok)
    vecs = np.asarray(emb.embed(texts))

    if not args.expected:
        np.save(args.out, vecs)
        emit({"tool": "parity_embed", "dumped": args.out,
              "texts": len(texts), "dim": int(vecs.shape[1])})
        return

    require_file(args.expected, "expected embeddings", "(N, H) .npy")
    want = np.load(args.expected)
    if want.shape[0] != len(texts):
        die(f"expected {want.shape[0]} rows but --texts has "
            f"{len(texts)} sentences")
    want = want / np.maximum(
        np.linalg.norm(want, axis=-1, keepdims=True), 1e-12)
    cos = float(np.mean(np.sum(vecs * want, axis=-1)))

    # Top-1 retrieval agreement: same nearest neighbor under both
    # embedding sets (excluding self).
    def nn(mat):
        sims = mat @ mat.T
        np.fill_diagonal(sims, -np.inf)
        return sims.argmax(1)

    agree = float(np.mean(nn(vecs) == nn(want))) if len(texts) > 2 else 1.0

    payload = {"tool": "parity_embed", "checkpoint": ckpt,
               "texts": len(texts), "mean_cosine": round(cos, 6),
               "top1_agreement": round(agree, 4),
               "pass": bool(cos > 0.99)}
    emit(payload)
    if not args.no_record:
        record("parity_embed", ckpt, "mean_cosine", round(cos, 6),
               details=f"top1_agreement {agree:.4f} over {len(texts)} texts")


if __name__ == "__main__":
    main()
