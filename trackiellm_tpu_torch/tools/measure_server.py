"""Aggregate throughput of the port's LLMServer on the card.

Twin of the JAX package's ``tools/measure_server.py``: the whole serve
loop (admission waves, bookkeeping, host fetches), not one decode step.
Mistral-7B at its published widths with random Q4 weights from a time
seed, ``max_seq=512, sliding_window=512``, eight batch slots; each
configuration answers a warm burst of eight requests, then 16 requests
of 48 tokens submitted at once, timed on the host clock from the first
submit to the last future (a future resolves when its tokens are on the
host, which is the sync). Configurations: the per-step loop and 8-step
pipelined chunks, dense slot caches and a paged pool of 128-token pages.
One JSON line each, after the card's name and power limit:

    python -m trackiellm_tpu_torch.tools.measure_server
"""

from __future__ import annotations

import json
import sys
import time
from typing import Dict, List

import torch

from trackiellm_tpu_torch.llm.server import LLMServer
from trackiellm_tpu_torch.llm.tokenizer import ByteTokenizer
from trackiellm_tpu_torch.models import llm
from trackiellm_tpu_torch.tools import card, cuda_device

MAX_TOKENS = 48
N_REQUESTS = 16
BATCH_SLOTS = 8
PAGE_SIZE = 128
TIMEOUT_S = 600.0
# label: LLMServer knobs
CONFIGS: Dict[str, dict] = {
    "per_step": dict(chunk_steps=1),
    "chunk8": dict(chunk_steps=8),
    "paged_per_step": dict(chunk_steps=1, paged=True, page_size=PAGE_SIZE),
    "paged_chunk8": dict(chunk_steps=8, paged=True, page_size=PAGE_SIZE),
}


def prompts(seed: int) -> List[str]:
    return [f"pergunta numero {seed}-{i}: o que ha a minha frente?"
            for i in range(N_REQUESTS)]


def run(server: LLMServer, seed: int) -> dict:
    """A warm burst of ``server.batch`` requests (the admission waves and
    the chunk path run once before the window), then the timed burst of
    N_REQUESTS. Returns aggregate tok/s, wall s and the server's decode
    steps, and the timed requests' texts under ``texts``."""
    asked = prompts(seed)
    warm = [server.submit(p + " (warmup)", max_tokens=MAX_TOKENS)
            for p in asked[: server.batch]]
    for f in warm:
        f.result(timeout=TIMEOUT_S)
    t0 = time.perf_counter()
    futs = [server.submit(p, max_tokens=MAX_TOKENS) for p in asked]
    texts = [f.result(timeout=TIMEOUT_S) for f in futs]
    dt = time.perf_counter() - t0
    if not all(isinstance(t, str) for t in texts):
        raise AssertionError("a request did not resolve to text")
    return {"aggregate_tok_s": N_REQUESTS * MAX_TOKENS / dt, "wall_s": dt,
            "decode_steps": server.stats["decode_steps"], "texts": texts}


def main() -> int:
    dev = cuda_device("measure_server")
    if dev is None:
        return 1
    seed = int(time.time()) & 0x7FFFFFFF
    cfg = llm.LLMConfig.mistral_7b()._replace(max_seq=512,
                                              sliding_window=512)
    params = llm.init_params_quantized(
        torch.Generator(device=dev).manual_seed(seed), cfg, bits=4,
        device=dev)
    tok = ByteTokenizer(cfg.vocab_size)
    smi = card()
    for label, kw in CONFIGS.items():
        server = LLMServer(params, cfg, batch_slots=BATCH_SLOTS,
                           tokenizer=tok, **kw)
        try:
            res = run(server, seed)
        finally:
            server.close()
        del res["texts"]
        print(json.dumps({"config": f"llm_server_b8_{label}", **res,
                          "card": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
