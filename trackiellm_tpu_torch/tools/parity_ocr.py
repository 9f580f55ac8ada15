"""OCR accuracy parity: run TrOCR weights through the port's
``models/trocr.py`` and score recognized text against references (CER
and exact match).

    python -m trackiellm_tpu_torch.tools.parity_ocr --checkpoint W \\
        --config config.json --images crops/ [--vocab vocab.json]
        [--expected texts.json] [--max-len 64] [--out ocr_texts.json]
        [--device D] [--no-record]

The twin of the JAX package's ``tools/parity_ocr.py``: the same flags
(plus ``--device``), failures and JSON payload. The checkpoint is the HF
VisionEncoderDecoderModel state dict, ``--config`` its config.json,
``--vocab`` the decoder's vocab.json ({piece: id}, GPT-2 byte-level
pieces); without it the raw ids are printed. ``--expected``: {image: text}
or a list in sorted image order. Without it the texts are dumped.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from trackiellm_tpu_torch.tools.parity_common import (
    die, edit_distance, emit, load_image, load_state_dict, ready, record,
    require_file)
from trackiellm_tpu_torch.tools.parity_common import device as pick_device


def _decoder_from_vocab(vocab_path: str):
    """{piece: id} (GPT-2 byte-level pieces, RoBERTa-style) -> ids ->
    text decoder that skips special tokens."""
    from trackiellm_tpu_torch.llm.tokenizer import _bytes_to_unicode

    vocab = json.loads(open(vocab_path).read())
    id2piece = {int(i): p for p, i in vocab.items()}
    u2b = {u: b for b, u in _bytes_to_unicode().items()}

    def decode(ids) -> str:
        data = bytearray()
        for i in ids:
            piece = id2piece.get(int(i), "")
            if piece.startswith("<") and piece.endswith(">"):
                continue  # <s> </s> <pad> <mask> <unk>
            for ch in piece:
                if ch in u2b:
                    data.append(u2b[ch])
                else:
                    data.extend(ch.encode("utf-8"))
        return data.decode("utf-8", "replace")

    return decode


def _load_crop(path: str):
    if path.lower().endswith(".npy"):
        return np.load(path)
    return load_image(path)


def _images(path: str):
    if os.path.isdir(path):
        names = sorted(n for n in os.listdir(path)
                       if n.lower().endswith((".png", ".jpg", ".jpeg",
                                              ".npy", ".bmp")))
        if not names:
            die(f"no images in {path}")
        return [(n, os.path.join(path, n)) for n in names]
    return [(os.path.basename(path), path)]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="parity_ocr")
    ap.add_argument("--checkpoint", required=True,
                    help="TrOCR VisionEncoderDecoderModel weights "
                    "(.safetensors/.pt/.npz)")
    ap.add_argument("--config", required=True,
                    help="the model's config.json")
    ap.add_argument("--vocab", default=None,
                    help="decoder vocab.json ({piece: id}, byte-level "
                    "pieces); omitted = dump raw ids")
    ap.add_argument("--images", required=True,
                    help="crop image or directory")
    ap.add_argument("--expected", default=None,
                    help="JSON {image: text} or list (sorted order)")
    ap.add_argument("--max-len", type=int, default=64)
    ap.add_argument("--out", default="ocr_texts.json")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--no-record", action="store_true")
    args = ap.parse_args(argv)

    ckpt = require_file(args.checkpoint, "TrOCR checkpoint",
                        "e.g. microsoft/trocr-base-printed "
                        "model.safetensors")
    conf = json.loads(open(require_file(args.config,
                                        "model config.json")).read())

    dev = pick_device(args.device, "parity_ocr")
    ready("parity_ocr", dev)
    from trackiellm_tpu_torch.models.convert import trocr_from_hf
    from trackiellm_tpu_torch.models.trocr import TrOCREngine

    state = load_state_dict(ckpt)
    try:
        params, cfg = trocr_from_hf(state, conf, max_len=args.max_len,
                                    device=dev)
    except KeyError as exc:
        die(f"checkpoint does not match the HF TrOCR layout (missing "
            f"{exc}); run python -m trackiellm_tpu_torch inspect to list "
            f"its names")

    if args.vocab:
        decode = _decoder_from_vocab(require_file(args.vocab,
                                                  "vocab.json"))
    else:
        decode = lambda ids: " ".join(str(int(i)) for i in ids)  # noqa: E731

    eng = TrOCREngine(params, cfg, decode)
    items = _images(args.images)
    crops = [np.asarray(_load_crop(p), np.float32) for _, p in items]
    texts = eng(crops)
    results = {name: t for (name, _), t in zip(items, texts)}

    if not args.expected:
        with open(args.out, "w") as f:
            json.dump(results, f, ensure_ascii=False, indent=1)
        emit({"tool": "parity_ocr", "dumped": args.out,
              "images": len(items)})
        return

    ref = json.loads(open(require_file(args.expected,
                                       "expected texts JSON")).read())
    if isinstance(ref, list):
        ref = {name: t for (name, _), t in zip(items, ref)}
    total_edit = total_chars = exact = scored = 0
    for name, got in results.items():
        if name not in ref:
            continue
        want = ref[name]
        scored += 1
        total_edit += edit_distance(got, want)
        total_chars += max(len(want), 1)
        exact += got == want
    if not scored:
        die("no image names overlap between --images and --expected")
    result = {"tool": "parity_ocr", "images": scored,
              "cer": round(total_edit / total_chars, 5),
              "exact_match": round(exact / scored, 5)}
    emit(result)
    if not args.no_record:
        record("parity_ocr", ckpt, "CER / exact",
               f"{result['cer']} / {result['exact_match']}",
               f"{scored} crops, max_len {args.max_len}")


if __name__ == "__main__":
    main()
