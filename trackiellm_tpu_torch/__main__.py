"""CLI entry: ``python -m trackiellm_tpu_torch <command>``.

  generate <ckpt> -p PROMPT [--max-tokens N] [--temperature T] [--device D]
      run a generation from a native checkpoint (``LLMConfig`` only), such
      as one that ``python -m trackiellm_tpu convert model.gguf -o DIR
      --bits 8`` wrote.

Port of ``trackiellm_tpu/__main__.py:_cmd_generate`` with the JAX package's
defaults (64 tokens, temperature 0.7). It runs on the CUDA card; the CPU is
used only when ``--device cpu`` asks for it. ``inspect``, ``convert``,
``bench`` and ``demo`` are not ported yet.
"""

from __future__ import annotations

import argparse
import sys

import torch

from trackiellm_tpu_torch.llm.runner import GenerationConfig, LLMRunner
from trackiellm_tpu_torch.llm.tokenizer import (tokenizer_from_pieces,
                                                tokenizer_from_spec)
from trackiellm_tpu_torch.models.checkpoint import load_checkpoint


def _device(name):
    """The device asked for; by default the CUDA card, and no fallback to
    the CPU when there is none."""
    if name is not None:
        return torch.device(name)
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to generate on "
                         "the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def _cmd_generate(args) -> int:
    if args.image:
        raise NotImplementedError(
            "--image: multimodal checkpoints (llm/vlm.py, models/clip.py) "
            "are not ported yet (ROADMAP Queue 1 items 8 and 10)")
    device = _device(args.device)
    params, cfg, meta = load_checkpoint(args.checkpoint, device=device)
    if cfg is None:
        print("checkpoint has no LLMConfig sidecar", file=sys.stderr)
        return 1
    tokenizer = None
    if meta.get("tokenizer_spec"):
        tokenizer = tokenizer_from_spec(meta["tokenizer_spec"])
    elif meta.get("vocab_pieces"):  # checkpoints without a tokenizer_spec
        tokenizer = tokenizer_from_pieces(meta["vocab_pieces"])
    runner = LLMRunner(params, cfg, tokenizer, device=device,
                       gen_config=GenerationConfig(
                           max_tokens=args.max_tokens,
                           temperature=args.temperature))
    runner.generate(args.prompt,
                    on_token=lambda s: print(s, end="", flush=True))
    print()
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="trackiellm_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("generate", help="generate from a checkpoint")
    p.add_argument("checkpoint")
    p.add_argument("-p", "--prompt", default="Olá!")
    p.add_argument("--max-tokens", type=int, default=64)
    p.add_argument("--temperature", type=float, default=0.7)
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card; the CPU only "
                        "when asked for with --device cpu)")
    p.add_argument("--image", default=None,
                   help="multimodal checkpoints: not ported yet")
    p.set_defaults(fn=_cmd_generate)
    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
