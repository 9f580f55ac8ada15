"""LLM token parity: greedy-decode a GGUF model through the port and
compare the token stream against a llama.cpp transcript of the same prompt.

    python -m trackiellm_tpu_torch.tools.parity_llm --gguf model.gguf \\
        --transcript llama_run.json [--quantize 0|4|8] [--device D]
        [--no-record]

The twin of the JAX package's ``tools/parity_llm.py``: the same flags
(plus ``--device``), failures and JSON payload. ``--gguf`` is a GGUF file
(``gguf_to_llm_params``, requantized at ``--quantize``, default 4: the
reference's Q4 serving) or a native checkpoint directory (``convert``'s
output; its tokenizer rides the metadata, and an MLA config selects
``models/mla.py``). Dense and MLA models decode behind ``LLMRunner``, the
Mamba, Mamba-2 and Qwen3-Next families behind ``MambaRunner``.

Transcript JSON (llama.cpp at temperature 0):
  {"prompt": "<exact prompt text>", "tokens": [id, ...]}
or {"prompt": "...", "text": "..."} for a text-level (WER) comparison.

The metric is the longest exact prefix and the match rate, not all or
nothing: kernels of other vendors part ways once logit gaps get small.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from trackiellm_tpu_torch.tools.parity_common import (die, emit, launches,
                                                      ready, record,
                                                      require_file)
from trackiellm_tpu_torch.tools.parity_common import device as pick_device

RECURRENT = ("MambaConfig", "Mamba2Config", "Qwen3NextConfig")


def load_model(path: str, quantize: int, dev):
    """(params, cfg, tokenizer or None, model module or None) from a GGUF
    file or a native checkpoint directory, on ``dev``."""
    from trackiellm_tpu_torch.models.convert import (gguf_to_llm_params,
                                                     tokenizer_from_gguf)
    from trackiellm_tpu_torch.models.loader import read_gguf_header

    model = None
    if os.path.isdir(path):
        from trackiellm_tpu_torch.llm.tokenizer import (tokenizer_from_pieces,
                                                        tokenizer_from_spec)
        from trackiellm_tpu_torch.models.checkpoint import load_checkpoint

        print("loading native checkpoint...", file=sys.stderr)
        params, cfg, meta = load_checkpoint(path, device=dev)
        if cfg is None:
            die("checkpoint has no config sidecar")
        tokenizer = None
        if meta.get("tokenizer_spec"):
            tokenizer = tokenizer_from_spec(meta["tokenizer_spec"])
        elif meta.get("vocab_pieces"):
            tokenizer = tokenizer_from_pieces(meta["vocab_pieces"])
        if type(cfg).__name__ == "MLAConfig":
            from trackiellm_tpu_torch.models import mla as model
        return params, cfg, tokenizer, model
    print("loading GGUF...", file=sys.stderr)
    try:
        tokenizer = tokenizer_from_gguf(read_gguf_header(path))
    except Exception as e:
        die(f"GGUF tokenizer table unreadable: {e}")
    params, cfg = gguf_to_llm_params(path, bits=quantize or None,
                                     device=dev)
    return params, cfg, tokenizer, model


def greedy(params, cfg, tokenizer, model, prompt: str, n_tokens: int, dev):
    """(text, generated ids): ``n_tokens`` greedy tokens after ``prompt``
    behind the family's runner."""
    from trackiellm_tpu_torch.llm.runner import GenerationConfig, LLMRunner

    gen = GenerationConfig(max_tokens=n_tokens, temperature=0.0)
    if type(cfg).__name__ in RECURRENT:
        # Recurrent-state families score through their sequential session
        # (the same _generated_ids surface).
        from trackiellm_tpu_torch.models.mamba import MambaRunner

        runner = MambaRunner(params, cfg, tokenizer, gen, device=dev)
    else:
        runner = LLMRunner(params, cfg, tokenizer, gen, device=dev,
                           model=model)
    text = runner.generate(prompt)
    return text, [int(t) for t in runner._generated_ids]


def token_match(got, ref_tokens) -> dict:
    """The exact prefix, the match rate and the first divergence."""
    prefix = 0
    for a, b in zip(got, ref_tokens):
        if a != b:
            break
        prefix += 1
    n = min(len(got), len(ref_tokens))
    matches = sum(1 for a, b in zip(got, ref_tokens) if a == b)
    return {"n_ref_tokens": len(ref_tokens), "n_generated": len(got),
            "exact_prefix": prefix,
            "match_rate": round(matches / n, 4) if n else 0.0,
            "first_divergence": None if prefix == n else {
                "index": prefix,
                "got": got[prefix] if prefix < len(got) else None,
                "ref": ref_tokens[prefix]}}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="parity_llm")
    ap.add_argument("--gguf", required=True,
                    help="GGUF model file OR a native checkpoint dir "
                    "(python -m trackiellm_tpu_torch convert --family *-hf "
                    "— the route for HF-only families like Llama-4)")
    ap.add_argument("--transcript", required=True,
                    help="llama.cpp greedy-run JSON (prompt + tokens)")
    ap.add_argument("--quantize", type=int, default=4, choices=(0, 4, 8),
                    help="requantize to Q4/Q8 on load (0 = keep float; "
                    "default 4, matching the reference's Q4_0 serving)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--no-record", action="store_true")
    args = ap.parse_args(argv)

    if not (os.path.isdir(args.gguf) or os.path.exists(args.gguf)):
        die(f"model not found: {args.gguf!r} (GGUF file or native "
            f"checkpoint dir)")
    gguf_path = args.gguf
    tr_path = require_file(args.transcript, "llama.cpp transcript JSON")
    tr = json.loads(open(tr_path).read())
    if "prompt" not in tr or not ("tokens" in tr or "text" in tr):
        die("transcript JSON needs 'prompt' and 'tokens' (or 'text')")

    dev = pick_device(args.device, "parity_llm")
    ready("parity_llm", dev)
    params, cfg, tokenizer, model = load_model(gguf_path, args.quantize, dev)
    if tokenizer is None:
        from trackiellm_tpu_torch.llm.tokenizer import ByteTokenizer

        print("WARNING: GGUF carries no tokenizer.ggml.tokens table; "
              "using the byte tokenizer (only valid for synthetic "
              "models)", file=sys.stderr)
        tokenizer = ByteTokenizer(cfg.vocab_size)

    ref_tokens = tr.get("tokens")
    n_gen = len(ref_tokens) if ref_tokens else 256
    print(f"greedy-decoding {n_gen} tokens...", file=sys.stderr)
    out_text, got = greedy(params, cfg, tokenizer, model, tr["prompt"],
                           n_gen, dev)
    launches(dev)

    if ref_tokens:
        payload = {"tool": "parity_llm", "gguf": gguf_path,
                   **token_match(got, ref_tokens)}
        metric, value = "token_match", payload["match_rate"]
    else:
        from trackiellm_tpu_torch.tools.parity_common import wer

        w = wer(tr["text"], out_text)
        payload = {"tool": "parity_llm", "gguf": gguf_path,
                   "text_wer": round(w, 4), "generated": out_text[:200]}
        metric, value = "text_WER", payload["text_wer"]

    emit(payload)
    if not args.no_record:
        record("parity_llm", gguf_path, metric, value,
               f"{n_gen} tokens greedy")


if __name__ == "__main__":
    main()
