"""Rank program of the tensor-parallel CPU tests (not a test module).

``python tests/torch_tp_ranks.py JOB INPUTS --rank r --world n --init addr
--out file``: one gloo rank on the CPU, as ``trackiellm_tpu_torch/parallel/
launch.py:run_ranks`` starts it. INPUTS is a ``torch.save`` of what the
test prepared (configs, full param trees, tokens; no JAX is imported
here); the rank saves its results to ``--out``.

Jobs:
- ``infer``: per case, this rank's cut (``shard_params``), the sharded
  prefill and one decode step of ``models.llm`` or ``models.mla``; the
  full logits, the report and the local shapes.
- ``server``: ``LLMServer(mesh=...)`` per case (dense slots, the page
  pool, the int8 pool, MLA latent slots), per-step and chunked; rank 0
  submits the prompts and returns each request's ids; every rank returns
  the plans it sent or received. A case with ``"rank_knobs"`` builds the
  server of rank r with those knobs over the case's, and every rank
  returns the error its serve loop died with.
"""

import os
import sys
import threading

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import torch  # noqa: E402

from trackiellm_tpu_torch.parallel import infer, launch  # noqa: E402
from trackiellm_tpu_torch.parallel.mesh import (build_mesh,  # noqa: E402
                                                close_mesh)

TIMEOUT_S = 60.0


def _module(name: str):
    from trackiellm_tpu_torch.models import llm, mla
    return {"llm": llm, "mla": mla}[name]


def infer_job(mesh, inputs: dict) -> dict:
    out = {"broadcast": mesh.broadcast(torch.tensor([mesh.rank, 7]))}
    for name, case in inputs.items():
        m = _module(case["model"])
        cfg, params = case["cfg"], case["params"]
        shard = infer.shard_params(params, cfg, mesh)
        dtype = case.get("cache_dtype", torch.float32)
        cache = m.KVCache.create(shard.cfg, dtype=dtype, device="cpu")
        if case["model"] == "mla":
            prefill, decode = infer.make_sharded_mla(
                cfg, mesh, attn_len=cfg.max_seq)
        else:
            prefill = infer.make_sharded_prefill(cfg, mesh)
            decode = infer.make_sharded_decode(cfg, mesh,
                                               attn_len=cfg.max_seq)
        logits, cache = prefill(shard.params, case["tokens"],
                                case["length"], cache)
        logits2, cache = decode(shard.params, case["decode_token"], cache)
        out[name] = {"logits": logits, "logits2": logits2,
                     "report": shard.report,
                     "shapes": infer.shard_shapes(shard.params)}
        if "extend" in case:   # the other models.llm paths on the shard
            lcfg = shard.cfg
            out[name]["extend"], _ = m.extend(
                shard.params, lcfg, case["extend"], 5, cache)
            out[name]["batch"], _ = m.prefill_batch(
                shard.params, lcfg, case["batch"], case["batch_lengths"],
                cache_dtype=torch.float32)
    return out


def _serve(mesh, case: dict, chunk_steps: int) -> dict:
    from trackiellm_tpu_torch.llm.server import LLMServer
    from trackiellm_tpu_torch.llm.tokenizer import ByteTokenizer

    cfg = case["cfg"]
    kw = dict(case.get("server", {}))
    kw.update(case.get("rank_knobs", {}).get(mesh.rank, {}))
    model = _module(case["model"])
    server = LLMServer(case["params"], cfg, batch_slots=2,
                       tokenizer=ByteTokenizer(cfg.vocab_size),
                       chunk_steps=chunk_steps, mesh=mesh,
                       model=None if case["model"] == "llm" else model, **kw)
    if case.get("compute_f32") and server.paged:
        server.pool.compute_dtype = torch.float32
    ids, lock = {}, threading.Lock()
    finish = server._finish

    def watched(slot):
        if slot.request is not None:
            with lock:
                ids[slot.request.prompt] = list(slot.generated)
        finish(slot)
    server._finish = watched
    texts = None
    try:
        if mesh.rank == 0:
            futs = [server.submit(p, max_tokens=n)
                    for p, n in case["prompts"]]
            if "rank_knobs" in case:   # each request fails with the loop
                for f in futs:
                    f.exception(timeout=TIMEOUT_S)
            else:
                texts = [f.result(timeout=TIMEOUT_S) for f in futs]
    finally:
        server.close(timeout=TIMEOUT_S)
    if server._thread.is_alive():
        raise RuntimeError(f"rank {mesh.rank}: the serve loop did not end")
    if "rank_knobs" in case:
        return {"error": repr(server._fatal)}
    if server._fatal is not None:
        raise RuntimeError(f"rank {mesh.rank}: {server._fatal!r}")
    return {"texts": texts, "ids": ids, "plans": list(server.plans),
            "paged": server.paged, "stats": dict(server.stats),
            "pool": type(server.pool.pool_k).__name__ if server.paged
            else None,
            "cache_heads": (server.cache.k.shape[3]
                            if server.cache is not None
                            and case["model"] == "llm" else None)}


def server_job(mesh, inputs: dict) -> dict:
    return {name: {chunk: _serve(mesh, case, chunk)
                   for chunk in case["chunks"]}
            for name, case in inputs.items()}


JOBS = {"infer": infer_job, "server": server_job}


def main(argv) -> int:
    torch.set_num_threads(1)
    args = launch.rank_args(argv)
    job, inputs_path = argv[1], argv[2]
    mesh = build_mesh(args["world"], backend="gloo", device="cpu",
                      init_method=args["init"], rank=args["rank"],
                      timeout_s=TIMEOUT_S)
    inputs = torch.load(inputs_path, weights_only=False)
    with torch.no_grad():
        result = JOBS[job](mesh, inputs)
    launch.save_result(args["out"], {"rank": mesh.rank, "repr": repr(mesh),
                                     "coords": mesh.coords,
                                     "result": result})
    mesh.barrier()
    close_mesh(mesh)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
