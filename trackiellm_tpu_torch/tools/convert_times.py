"""Time a whole Mistral-7B GGUF through the port: write, convert, generate.

    python3 -m trackiellm_tpu_torch.tools.convert_times [--layers 32]
        [--dir DIR]

Writes a Mistral-7B GGUF at its published widths and llama.cpp's Q4_K_M
mix (``chip_smoke.py:mistral_gguf``: seeded random Q4_K and Q6_K blocks,
F32 norms, a 32,000-piece SentencePiece vocabulary) with ``--layers``
layers in a child process, then runs ``python -m trackiellm_tpu_torch
convert FILE -o DIR --bits 4`` on the card in another, so that its peak
resident memory is the conversion's (Linux's ``ru_maxrss`` counts the
parent's size at the fork, and the parent stays small). The child
reports the wall seconds and their split (``chip_smoke.py:conversion_timer``: reading and
dequantizing GGML tensors, requantizing on the card, saving), each also per
layer. Then the checkpoint loads onto the card and answers, behind
``LLMRunner`` as ``chip_smoke.py``'s phase 5 drives it (greedy, 96
tokens, lookahead 4, no speculation): the short prompt and the cortex
prompt, each with its prefill and decode wall; and ``generate`` runs once
through the CLI. Prints the card line, then one JSON line. Exits non-zero
without a CUDA device.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
import json
import os
import pathlib
import subprocess
import sys
import tempfile
import time

import torch

CHECKOUT = pathlib.Path(__file__).resolve().parents[2]


def _chip_smoke():
    """The ``chip_smoke.py`` of this file's checkout, as a module."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", CHECKOUT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(path, f))
               for f in os.listdir(path))


def convert_child(path: str, ckpt: str, layers: int) -> dict:
    """The conversion, timed by part, in this process: what the child
    prints."""
    from trackiellm_tpu_torch import __main__ as cli
    from trackiellm_tpu_torch.models import convert
    cs = _chip_smoke()
    with cs.conversion_timer(convert, cli) as split:
        rc, text, total = cs.run_cli(
            cli, ["convert", path, "-o", ckpt, "--bits", "4"])
    if rc != 0:
        raise RuntimeError(f"convert exited {rc}: {text}")
    return {**cs.conversion_split(split, total, layers),
            "peak_rss_bytes": cs._peak_rss(),
            "card_peak_bytes": torch.cuda.max_memory_allocated()}


def generate_times(cs, ckpt: str, dev) -> dict:
    """Load the checkpoint on the card and answer phase 5's short and
    cortex prompts (each once to warm up, then timed), then ``generate``
    once through the CLI."""
    from trackiellm_tpu_torch import __main__ as cli
    from trackiellm_tpu_torch.llm import runner as runner_mod
    from trackiellm_tpu_torch.llm.tokenizer import tokenizer_from_spec
    from trackiellm_tpu_torch.models.checkpoint import load_checkpoint
    t0 = time.perf_counter()
    params, cfg, meta = load_checkpoint(ckpt, device=dev)
    torch.cuda.synchronize()
    out = {"load_s": time.perf_counter() - t0}
    runner = runner_mod.LLMRunner(
        params, cfg, tokenizer_from_spec(meta["tokenizer_spec"]),
        runner_mod.GenerationConfig(max_tokens=96, temperature=0.0,
                                    speculative=False), device=dev)
    prompts = {"short": cs.SHORT_PROMPT, "cortex": runner.build_prompt(
        cs.SYSTEM, cs.CONTEXT, "What is in front of me right now?")}
    for prompt in prompts.values():   # warm-up: each bucket's first call
        runner.generate(prompt)
    for name, prompt in prompts.items():
        out[name] = cs.request(runner, prompt, name)
    del runner, params
    torch.cuda.empty_cache()
    rc, text, out["cli_generate_s"] = cs.run_cli(
        cli, ["generate", ckpt, "-p", cs.SHORT_PROMPT, "--max-tokens", "32"])
    if rc != 0 or not text.strip():
        raise RuntimeError(f"generate exited {rc} and printed {text!r}")
    out["cli_generate_text"] = text.strip()[:80]
    return out


def write_child(path: str, layers: int) -> dict:
    """The GGUF written, in this process: what the child prints."""
    from trackiellm_tpu_torch.models import llm
    cs = _chip_smoke()
    cfg = llm.LLMConfig.mistral_7b()._replace(n_layers=layers)
    t0 = time.perf_counter()
    tensors, metadata = cs.mistral_gguf(cfg, cs.spm_spec(cfg.vocab_size),
                                        cs.SEED)
    return {"file_bytes": cs.write_gguf(path, tensors, metadata),
            "write_s": time.perf_counter() - t0}


def _child(*argv: str) -> dict:
    """This tool in a child process (``--write`` or ``--convert``): the
    JSON of its last line."""
    t0 = time.perf_counter()
    child = subprocess.run(
        [sys.executable, "-m", "trackiellm_tpu_torch.tools.convert_times",
         *argv], capture_output=True, text=True, cwd=CHECKOUT, check=False)
    if child.returncode != 0:
        raise RuntimeError(f"{argv[0]} exited {child.returncode}: "
                           f"{child.stderr[-4000:]}")
    out = json.loads(child.stdout.strip().splitlines()[-1])
    out["process_s"] = time.perf_counter() - t0
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=32)
    ap.add_argument("--dir", default=None,
                   help="where the file and the checkpoint go (default: a "
                        "temporary directory, removed after)")
    ap.add_argument("--write", metavar="GGUF", help=argparse.SUPPRESS)
    ap.add_argument("--convert", nargs=2, metavar=("GGUF", "CKPT"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("convert_times: no CUDA device; this tool times the card only",
              file=sys.stderr)
        return 1
    if args.write:
        print(json.dumps(write_child(args.write, args.layers)))
        return 0
    if args.convert:
        print(json.dumps(convert_child(*args.convert, args.layers)))
        return 0
    from trackiellm_tpu_torch.tools import card
    cs = _chip_smoke()
    print(card(), flush=True)
    # The file is written and converted by children of this small process:
    # a child's peak RSS counts the parent's size when it forked.
    with contextlib.ExitStack() as stack:
        root = args.dir or stack.enter_context(
            tempfile.TemporaryDirectory(prefix="convert_times_"))
        path, ckpt = os.path.join(root, "mistral.gguf"), os.path.join(
            root, "ckpt")
        layers = ["--layers", str(args.layers)]
        out = {"layers": args.layers,
               "write": _child("--write", path, *layers),
               "convert": _child("--convert", path, ckpt, *layers),
               "parent_peak_rss_bytes": cs._peak_rss(),
               "checkpoint_bytes": _dir_bytes(ckpt)}
        out["generate"] = generate_times(cs, ckpt, torch.device("cuda", 0))
    out["card"] = card()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
