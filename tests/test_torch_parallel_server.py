"""LLMServer(mesh=...): tensor-parallel continuous batching on four gloo
ranks on the CPU.

The JAX package's TestShardedServer (tests/test_parallel.py) as port tests:
``test_tp_server_chunked_matches_tp_per_step`` (served ids of the
pipelined-chunk loop equal the per-step loop's on the same mesh) and
``test_mesh_paged_composition_contract`` (the page pool and the int8 pool
compose with the mesh, each rank holding its KV heads), on dense slots, the
float pool and the int8 pool, and an MLA server on latent slots. Rank 0
takes the requests; every rank runs the serve loop on the plans rank 0
broadcasts, and each follower must have received exactly the plans rank 0
sent. The ranks start once for the file (``tests/torch_tp_ranks.py``, job
``server``), with a hard limit.

Every case's served text is also held against the JAX package's
single-device LLMServer on the same weights, bridged byte for byte, and
the same knobs, as tests/test_torch_server.py holds the port's
single-device server: f32 activations and KV (the int8 pool computes in
f32), so tensor parallelism changes only the order of the f32 sums, by
about 1e-6 of a logit, and the greedy text must be the same.

The two prompts sit in different prefill buckets (64 and 128), so each
prefills alone whichever admission wave takes it: the two loops then run
the same shapes, and their ids must be equal.
"""

import os
import sys

import pytest
import torch

from trackiellm_tpu_torch.models import llm as tllm
from trackiellm_tpu_torch.models.bridge import params_from_jax
from trackiellm_tpu_torch.parallel.launch import run_ranks

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANKS = os.path.join(ROOT, "tests", "torch_tp_ranks.py")
WORLD = 4
SPAWN_LIMIT_S = 120.0
PROMPTS = (("o que ha a frente? " * 4, 21), ("descreva", 13))
CASES = {   # name: (model, server knobs)
    "dense": ("llm", {}),
    "paged": ("llm", {"paged": True, "page_size": 32}),
    "int8": ("llm", {"paged": True, "page_size": 32,
                     "cache_dtype": torch.int8}),
    # The long prompt admits through chunked prefill: extend on the shards.
    "paged_chunked_prefill": ("llm", {"paged": True, "page_size": 32,
                                      "prefill_chunk": 32}),
    "mla": ("mla", {}),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    """The JAX package's (cfg, params) of the dense (Q4 at group 64) and
    MLA models, f32 activations."""
    import jax
    import jax.numpy as jnp

    from trackiellm_tpu.models import llm as jllm
    from trackiellm_tpu.models import mla as jmla

    cfg = jllm.LLMConfig(
        vocab_size=512, dim=256, n_layers=2, n_heads=8, n_kv_heads=4,
        head_dim=32, hidden_dim=512, max_seq=128, sliding_window=128)
    p = jllm.quantize_params(
        jllm.init_params(jax.random.PRNGKey(7), cfg, dtype=jnp.float32),
        bits=4, group=64)
    mcfg = jmla.MLAConfig.tiny()._replace(n_heads=4, vocab_size=320,
                                          max_seq=128)
    mp = jmla.init_params(jax.random.PRNGKey(11), mcfg, dtype=jnp.float32)
    return {"llm": (cfg, p), "mla": (mcfg, mp)}


@pytest.fixture(scope="module")
def served(tmp_path_factory, models):
    from trackiellm_tpu_torch.models import mla as tmla

    cfg, p = models["llm"]
    dense = (tllm.LLMConfig(**cfg._asdict()), params_from_jax(p, "cpu"))
    mcfg, mp = models["mla"]
    mla = (tmla.MLAConfig(**mcfg._asdict()), params_from_jax(mp, "cpu"))
    inputs = {}
    for name, (model, knobs) in CASES.items():
        c, params = mla if model == "mla" else dense
        knobs = dict(knobs)
        knobs.setdefault("cache_dtype", torch.float32)
        inputs[name] = {"model": model, "cfg": c, "params": params,
                        "server": knobs, "prompts": PROMPTS,
                        "chunks": (1, 4),
                        "compute_f32": knobs["cache_dtype"] == torch.int8}
    # Rank 2 builds a float pool where the others build the int8 pool.
    inputs["mismatch"] = dict(inputs["int8"], chunks=(1,), rank_knobs={
        2: {"cache_dtype": torch.float32}})
    path = str(tmp_path_factory.mktemp("tp_server") / "inputs.pt")
    torch.save(inputs, path)
    return run_ranks([sys.executable, RANKS, "server", path], WORLD,
                     timeout_s=SPAWN_LIMIT_S)


@pytest.fixture(scope="module")
def jax_texts(models):
    """Each case's texts from the JAX package's single-device LLMServer
    (pipelined chunks of 4; its own tests hold them equal per step)."""
    import jax.numpy as jnp

    from trackiellm_tpu.llm.server import LLMServer as JServer
    from trackiellm_tpu.llm.tokenizer import ByteTokenizer as JTokenizer
    from trackiellm_tpu.models import mla as jmla

    out = {}
    for name, (model, knobs) in CASES.items():
        cfg, p = models[model]
        knobs = dict(knobs)
        int8 = knobs.pop("cache_dtype", None) == torch.int8
        server = JServer(p, cfg, batch_slots=2,
                         tokenizer=JTokenizer(cfg.vocab_size),
                         chunk_steps=4,
                         cache_dtype=jnp.int8 if int8 else jnp.float32,
                         model=jmla if model == "mla" else None, **knobs)
        if int8:
            server.pool.compute_dtype = jnp.float32
        try:
            futs = [server.submit(p_, max_tokens=n) for p_, n in PROMPTS]
            out[name] = [f.result(timeout=SPAWN_LIMIT_S) for f in futs]
        finally:
            server.close()
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_tp_server_text_matches_the_jax_single_device_server(
        served, jax_texts, case):
    """The served text of every case (dense slots, the float pool, the
    int8 pool, chunked prefill, MLA latent slots; per step and chunked)
    equals the JAX package's single-device server's, byte for byte."""
    out = served[0]["result"][case]
    assert any(jax_texts[case])
    for chunk in (1, 4):
        assert out[chunk]["texts"] == jax_texts[case]


def test_a_rank_built_otherwise_fails_every_rank(served):
    """A rank whose server differs from rank 0's (here its pool's dtype)
    fails every rank's serve loop at the first plan that admits requests,
    before any device work, instead of serving on other KV."""
    for rank in served:
        error = rank["result"]["mismatch"][1]["error"]
        assert "differ from rank 0's" in error and "ranks [2]" in error
        assert "torch.float32" in error and "torch.int8" in error


@pytest.mark.parametrize("case", list(CASES))
def test_tp_server_chunked_matches_tp_per_step(served, case):
    """Byte identity between the per-step and the pipelined-chunk loops on
    the same mesh (the JAX package's test, on each memory layout)."""
    out = served[0]["result"][case]
    per_step, chunked = out[1], out[4]
    prompts = [p for p, _ in PROMPTS]
    assert set(per_step["ids"]) == set(prompts)
    for prompt, budget in PROMPTS:
        assert len(per_step["ids"][prompt]) == budget
        assert chunked["ids"][prompt] == per_step["ids"][prompt]
    assert chunked["texts"] == per_step["texts"]
    assert chunked["stats"]["decode_steps"] >= 4
    assert per_step["stats"]["tokens"] == sum(n for _, n in PROMPTS)
    if case == "paged_chunked_prefill":
        assert per_step["stats"]["prefill_chunks"] >= 2


def test_mesh_paged_composition_contract(served):
    """Dense slots by default under a mesh; paged=True gives the float
    pool, and int8 KV the QuantPool, each of the rank's KV heads."""
    out = served[0]["result"]
    assert out["dense"][1]["paged"] is False
    assert out["dense"][1]["cache_heads"] == 4 // WORLD
    assert out["paged"][1]["paged"] and out["paged"][1]["pool"] == "Tensor"
    assert out["int8"][1]["paged"] and out["int8"][1]["pool"] == "QuantPool"
    assert out["mla"][1]["paged"] is False


def test_followers_receive_exactly_the_plans_rank0_sent(served):
    """Every plan rank 0 broadcast (the requests with their prompt ids and
    sampling knobs, cancellations, stop) is the one each follower ran."""
    lead = served[0]["result"]
    for follower in served[1:]:
        for case in CASES:
            runs = follower["result"][case]
            for chunk, out in runs.items():
                sent = lead[case][chunk]["plans"]
                assert out["plans"] == sent
                assert sent[-1]["stop"] is True
                new = [n for plan in sent for n in plan["new"]]
                assert [n["prompt"] for n in new] == [p for p, _ in PROMPTS]
                assert all(n["ids"][0] == 256 for n in new)   # BOS first
                assert out["ids"] == lead[case][chunk]["ids"]


def test_mla_server_under_tp_serves_every_request(served):
    out = served[0]["result"]["mla"][4]
    assert all(isinstance(t, str) for t in out["texts"])
    assert sorted(len(v) for v in out["ids"].values()) == sorted(
        n for _, n in PROMPTS)
