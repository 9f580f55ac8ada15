"""VLM (LLaVA) parity: encode an image and a prompt through a converted
checkpoint on the port and compare against a reference transcript (HF
transformers or llama.cpp llava-cli at temperature 0).

    python -m trackiellm_tpu_torch.tools.parity_vlm --checkpoint DIR \\
        --image frame.npy --transcript llava_run.json [--max-tokens 64]
        [--device D] [--no-record]

The twin of the JAX package's ``tools/parity_vlm.py``: the same flags
(plus ``--device``), failures and JSON payload. ``DIR`` is
``python -m trackiellm_tpu_torch convert llava.safetensors -o DIR
--family llava-hf --n-heads 32``'s output (the LLM at DIR, the CLIP tower
at DIR/vision). Transcript: {"prompt": "...<image>...", "pixel_values":
"px.npy" (optional: the reference's exact (3, S, S) input), "tokens": [id,
...]} or "text": "...".
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

from trackiellm_tpu_torch.tools.parity_common import (die, emit, ready,
                                                      record, require_file)
from trackiellm_tpu_torch.tools.parity_common import device as pick_device


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="parity_vlm")
    ap.add_argument("--checkpoint", required=True,
                    help="native VLM checkpoint dir (convert "
                    "--family llava-hf; vision tower at <dir>/vision)")
    ap.add_argument("--image", required=True,
                    help=".npy HWC uint8 frame (ignored when the "
                    "transcript pins pixel_values)")
    ap.add_argument("--transcript", required=True,
                    help="reference greedy-run JSON (prompt + tokens)")
    ap.add_argument("--max-tokens", type=int, default=64)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--no-record", action="store_true")
    args = ap.parse_args(argv)

    if not os.path.isdir(args.checkpoint):
        die(f"checkpoint dir not found: {args.checkpoint!r}")
    vis_dir = os.path.join(args.checkpoint, "vision")
    if not os.path.isdir(vis_dir):
        die(f"no vision tower at {vis_dir!r} (convert with "
            f"--family llava-hf)")
    tr = json.loads(open(require_file(
        args.transcript, "reference transcript JSON")).read())
    if "prompt" not in tr or not ("tokens" in tr or "text" in tr):
        die("transcript JSON needs 'prompt' and 'tokens' (or 'text')")

    dev = pick_device(args.device, "parity_vlm")
    ready("parity_vlm", dev)
    from trackiellm_tpu_torch.llm.runner import GenerationConfig
    from trackiellm_tpu_torch.llm.tokenizer import (tokenizer_from_pieces,
                                                    tokenizer_from_spec)
    from trackiellm_tpu_torch.llm.vlm import VLMRunner
    from trackiellm_tpu_torch.models.checkpoint import load_checkpoint

    params, cfg, meta = load_checkpoint(args.checkpoint, device=dev)
    clip_params, clip_cfg, _ = load_checkpoint(vis_dir, device=dev)
    tokenizer = None
    if meta.get("tokenizer_spec"):
        tokenizer = tokenizer_from_spec(meta["tokenizer_spec"])
    elif meta.get("vocab_pieces"):
        tokenizer = tokenizer_from_pieces(meta["vocab_pieces"])
    if tokenizer is None:
        from trackiellm_tpu_torch.llm.tokenizer import ByteTokenizer

        print("WARNING: checkpoint carries no tokenizer sidecar; using "
              "the byte tokenizer (token-id comparison only valid when "
              "the transcript used the same ids)", file=sys.stderr)
        tokenizer = ByteTokenizer(cfg.vocab_size)

    if tr.get("pixel_values"):
        image = np.load(require_file(tr["pixel_values"],
                                     "reference pixel_values .npy"))
    else:
        image = np.load(require_file(args.image, "image .npy"))

    runner = VLMRunner(
        params, cfg, clip_params, clip_cfg, tokenizer=tokenizer,
        gen_config=GenerationConfig(max_tokens=args.max_tokens,
                                    temperature=0.0), device=dev)
    text = runner.generate(tr["prompt"], images=[image])
    ours = list(runner._generated_ids)

    row: dict = {"model": os.path.basename(args.checkpoint.rstrip("/")),
                 "metric": "vlm-token-parity"}
    if "tokens" in tr:
        ref = [int(t) for t in tr["tokens"]][: len(ours)]
        prefix = 0
        for a, b in zip(ours, ref):
            if a != b:
                break
            prefix += 1
        matches = sum(a == b for a, b in zip(ours, ref))
        metric, value = "exact_prefix", prefix
        row.update(n_ref=len(ref), n_ours=len(ours),
                   exact_prefix=prefix,
                   match_rate=round(matches / max(len(ref), 1), 4))
        details = f"match_rate {row['match_rate']} over {len(ref)} tokens"
    else:
        ref_text = tr["text"]
        metric, value = "text_match", text.strip() == ref_text.strip()
        row.update(text_match=value,
                   ours_text=text[:200], ref_text=ref_text[:200])
        details = ""
    emit(row)
    if not args.no_record:
        record("parity_vlm", args.checkpoint, metric, value, details)


if __name__ == "__main__":
    main()
