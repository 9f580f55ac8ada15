"""ASR accuracy parity: run Whisper weights through the port over audio
files and score WER against reference transcripts.

    python -m trackiellm_tpu_torch.tools.parity_asr --checkpoint W \\
        --audio clips/ --refs refs.tsv [--vocab vocab.json]
        [--max-tokens 96] [--device D] [--no-record]

The twin of the JAX package's ``tools/parity_asr.py``: the same flags
(plus ``--device``), failures and JSON payload. ``--checkpoint``: an
openai-whisper state dict (.pt/.safetensors/.npz) or a whisper.cpp GGML
.bin (its vocabulary comes embedded). ``--audio``: a wav/npy file, a
directory or a glob (WAVs resampled to 16 kHz). ``--refs``: a TSV of
"<filename>\\t<reference transcript>" lines. ``--vocab``: JSON {piece: id}
or {id: piece}, or one piece a line; without it (and without a GGML
vocabulary) the byte tokenizer decodes, which only matches byte-level
models, so a warning is printed.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys

from trackiellm_tpu_torch.tools.parity_common import (
    die, emit, load_state_dict, load_wav, ready, record, require_file, wer)
from trackiellm_tpu_torch.tools.parity_common import device as pick_device


def _load_vocab(path):
    from trackiellm_tpu_torch.llm.tokenizer import VocabTokenizer

    if path.endswith(".json"):
        obj = json.loads(open(path).read())
        if all(isinstance(v, int) for v in obj.values()):
            inv = {v: k for k, v in obj.items()}
        else:
            inv = {int(k): v for k, v in obj.items()}
        pieces = [inv.get(i, f"<unk{i}>") for i in range(max(inv) + 1)]
    else:
        pieces = [ln.rstrip("\n") for ln in open(path)]
    return VocabTokenizer(pieces)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="parity_asr")
    ap.add_argument("--checkpoint", required=True,
                    help="Whisper weights (.pt/.safetensors/.npz, or a "
                         "whisper.cpp GGML .bin — vocab comes embedded)")
    ap.add_argument("--audio", required=True)
    ap.add_argument("--refs", required=True,
                    help="TSV: filename<TAB>reference transcript")
    ap.add_argument("--vocab", default=None)
    ap.add_argument("--max-tokens", type=int, default=96)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--no-record", action="store_true")
    args = ap.parse_args(argv)

    ckpt = require_file(args.checkpoint, "whisper checkpoint",
                        "openai-whisper .pt or torch state dict")
    refs_path = require_file(args.refs, "reference transcripts TSV")
    if os.path.isdir(args.audio):
        paths = sorted(
            p for p in glob.glob(os.path.join(args.audio, "*"))
            if p.lower().endswith((".wav", ".npy")))
    else:
        paths = sorted(glob.glob(args.audio))
    if not paths:
        die(f"no audio files under {args.audio!r}")

    refs = {}
    for ln in open(refs_path):
        if "\t" in ln:
            name, text = ln.rstrip("\n").split("\t", 1)
            refs[name] = text
    missing = [os.path.basename(p) for p in paths
               if os.path.basename(p) not in refs]
    if missing:
        die(f"refs file has no transcript for: {missing}")

    dev = pick_device(args.device, "parity_asr")
    ready("parity_asr", dev)
    from trackiellm_tpu_torch.audio.asr import WhisperASR
    from trackiellm_tpu_torch.models.convert import (
        whisper_config_from_torch, whisper_from_ggml, whisper_from_torch)
    from trackiellm_tpu_torch.models.loader import ModelFormat, detect_format

    embedded_tok = None
    if detect_format(ckpt) is ModelFormat.GGML:
        # whisper.cpp GGML (the reference's exact artifact): weights,
        # config AND the byte vocab all come from the one file.
        params, cfg, embedded_tok, _ = whisper_from_ggml(ckpt, device=dev)
    else:
        state = load_state_dict(ckpt)
        try:
            cfg = whisper_config_from_torch(state)
            params, _ = whisper_from_torch(state, device=dev)
        except KeyError as e:
            die(f"checkpoint {ckpt!r} missing expected tensor {e}; list "
                "names with python -m trackiellm_tpu_torch inspect and "
                "check models/convert.py::whisper_from_torch")

    tokenizer = _load_vocab(args.vocab) if args.vocab else embedded_tok
    if tokenizer is None:
        print("WARNING: no --vocab; using the byte tokenizer — WER vs a "
              "real BPE-vocab checkpoint is NOT meaningful", file=sys.stderr)
    asr = WhisperASR(params, cfg, tokenizer=tokenizer,
                     max_tokens=args.max_tokens)

    rows = []
    for p in paths:
        audio = load_wav(p)
        hyp = asr.transcribe(audio)
        name = os.path.basename(p)
        w = wer(refs[name].lower(), hyp.lower())
        rows.append({"file": name, "wer": round(w, 4), "hyp": hyp})
        print(f"{name}: WER {w:.3f}  hyp={hyp[:60]!r}", file=sys.stderr)

    mean_wer = sum(r["wer"] for r in rows) / len(rows)
    emit({"tool": "parity_asr", "checkpoint": ckpt,
          "n_clips": len(rows), "mean_wer": round(mean_wer, 4),
          "per_clip": rows})
    if not args.no_record:
        record("parity_asr", ckpt, "WER", round(mean_wer, 4),
               f"{len(rows)} clips")


if __name__ == "__main__":
    main()
