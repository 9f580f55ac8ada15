"""Tensor-parallel inference of the port against the JAX package's.

Four gloo ranks on the CPU (``device="cpu"``), started once for the whole
file (``tests/torch_tp_ranks.py``, job ``infer``, through
``parallel/launch.py:run_ranks`` with a hard limit): each cuts its shard of
the JAX package's parameters, bridged byte for byte
(``models/bridge.py:params_from_jax``), and runs the sharded prefill and a
decode step. Rank 0's logits are held against the JAX package's
``make_sharded_prefill``/``make_sharded_decode`` (and ``make_sharded_mla``)
on 4 of conftest's 8 virtual devices, and against the JAX single-device
forward, at the port's unsharded parity tolerance (``ATOL``, f32
activations for the f32 and the Q4 trees, as ``tests/test_torch_llm.py``).
TestShardedInference's config and seed (tests/test_parallel.py) for the
dense trees, TestShardedMLA's for MLA.
"""

import os
import sys

import numpy as np
import pytest
import torch

from trackiellm_tpu_torch.models import llm as tllm
from trackiellm_tpu_torch.models.bridge import params_from_jax
from trackiellm_tpu_torch.parallel import infer
from trackiellm_tpu_torch.parallel.launch import run_ranks
from trackiellm_tpu_torch.utils.errors import TrackieError

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANKS = os.path.join(ROOT, "tests", "torch_tp_ranks.py")
WORLD = 4
SPAWN_LIMIT_S = 120.0
ATOL = 1e-4   # the port's unsharded parity tolerance (test_torch_llm.py)
# Port tp=4 against port tp=1 (the same forward, f32 sums in another
# order: the reduce over ranks, the shards' own products). Measured on the
# CPU: at most 3.1e-6 max abs over these cases (logits of magnitude ~1);
# the bound is about 3x that.
TP1_ATOL = 1e-5
LLM_CASES = ("q4", "q4_whole", "q8", "f32", "qwen2", "gemma2", "moe")
MLA_CASES = ("mla", "mla_q_lora")
SHARDED_JAX = ("q4", "f32", "mla")   # also against JAX's sharded functions
PORT_PATHS = ("q4", "f32", "moe")    # also extend and prefill_batch


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _llm_cfgs(jllm):
    base = jllm.LLMConfig(
        vocab_size=512, dim=256, n_layers=2, n_heads=8, n_kv_heads=4,
        head_dim=32, hidden_dim=512, max_seq=128, sliding_window=128)
    # q4_whole: w_down's K slice (96) is a group and a half at group 64,
    # so it stays whole on every rank and its input is gathered.
    return {"q4": base, "q4_whole": base._replace(hidden_dim=384),
            "q8": base, "f32": base,
            "qwen2": base._replace(qkv_bias=True),
            "gemma2": base._replace(post_norms=True, act="gelu",
                                    logit_softcap=30.0),
            "moe": base._replace(n_experts=4, n_experts_used=2,
                                 moe_shared_hidden=256)}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """JAX references, the port's single-device logits, and the four
    ranks' results (one spawn)."""
    import jax
    import jax.numpy as jnp

    from trackiellm_tpu.models import llm as jllm
    from trackiellm_tpu.models import mla as jmla
    from trackiellm_tpu.parallel import (build_mesh, infer_param_shardings,
                                         kv_cache_sharding, make_sharded_mla,
                                         make_sharded_decode,
                                         make_sharded_prefill,
                                         mla_cache_sharding,
                                         mla_param_shardings)
    from trackiellm_tpu_torch.models import mla as tmla

    mesh = build_mesh(jax.devices()[:WORLD])
    assert mesh.shape["tp"] == WORLD
    inputs, ref = {}, {}
    toks = jax.random.randint(jax.random.PRNGKey(8), (64,), 0, 512,
                              jnp.int32)
    for name, cfg in _llm_cfgs(jllm).items():
        p = jllm.init_params(jax.random.PRNGKey(7), cfg, dtype=jnp.float32)
        if name in ("q4", "q4_whole", "q8", "moe"):
            p = jllm.quantize_params(p, bits=8 if name == "q8" else 4,
                                     group=64)
        lg, c = jllm.prefill(p, cfg, toks, jnp.int32(48),
                             jllm.KVCache.create(cfg, dtype=jnp.float32))
        tok = int(jnp.argmax(lg))
        lg2, _ = jllm.decode_step(p, cfg, jnp.int32(tok), c,
                                  attn_len=cfg.max_seq)
        ref[name] = {"single": (np.asarray(lg), np.asarray(lg2))}
        if name in SHARDED_JAX:
            q = name == "q4"
            sp = jax.device_put(p, infer_param_shardings(mesh, q))
            sc = jax.device_put(jllm.KVCache.create(cfg, dtype=jnp.float32),
                                kv_cache_sharding(mesh))
            slg, sc = make_sharded_prefill(cfg, mesh, q)(
                sp, toks, jnp.int32(48), sc)
            slg2, _ = make_sharded_decode(cfg, mesh, q, cfg.max_seq)(
                sp, jnp.int32(tok), sc)
            ref[name]["sharded"] = (np.asarray(slg), np.asarray(slg2))
        tcfg = tllm.LLMConfig(**cfg._asdict())
        inputs[name] = {"model": "llm", "cfg": tcfg,
                        "params": params_from_jax(p, "cpu"),
                        "tokens": torch.from_numpy(np.array(toks)).long(),
                        "length": 48, "decode_token": tok}
        if name in PORT_PATHS:
            t = inputs[name]["tokens"]
            inputs[name].update(extend=t[:16],
                                batch=torch.stack([t, t.flip(0)]),
                                batch_lengths=torch.tensor([48, 30]))
    mtoks = jax.random.randint(jax.random.PRNGKey(12), (32,), 0, 256,
                               jnp.int32)
    for name, q_lora in (("mla", 0), ("mla_q_lora", 24)):
        cfg = jmla.MLAConfig.tiny()._replace(n_heads=4, q_lora_rank=q_lora,
                                             max_seq=64)
        p = jmla.init_params(jax.random.PRNGKey(11), cfg, dtype=jnp.float32)
        lg, c = jmla.prefill(p, cfg, mtoks, jnp.int32(23),
                             jmla.MLACache.create(cfg, dtype=jnp.float32))
        tok = int(jnp.argmax(lg))
        lg2, _ = jmla.decode_step(p, cfg, jnp.int32(tok), c,
                                  attn_len=cfg.max_seq)
        ref[name] = {"single": (np.asarray(lg), np.asarray(lg2))}
        if name in SHARDED_JAX:
            sp = jax.device_put(p, mla_param_shardings(mesh, p))
            sc = jax.device_put(jmla.MLACache.create(cfg, dtype=jnp.float32),
                                mla_cache_sharding(mesh))
            pf, dec = make_sharded_mla(cfg, mesh, p, attn_len=cfg.max_seq)
            slg, sc = pf(sp, mtoks, jnp.int32(23), sc)
            slg2, _ = dec(sp, jnp.int32(tok), sc)
            ref[name]["sharded"] = (np.asarray(slg), np.asarray(slg2))
        inputs[name] = {"model": "mla",
                        "cfg": tmla.MLAConfig(**cfg._asdict()),
                        "params": params_from_jax(p, "cpu"),
                        "tokens": torch.from_numpy(np.array(mtoks)).long(),
                        "length": 23, "decode_token": tok}
    # The port on one device (tp=1), the same inputs.
    port1 = {}
    with torch.no_grad():
        for name, case in inputs.items():
            m = tmla if case["model"] == "mla" else tllm
            cfg = case["cfg"]
            lg, c = m.prefill(case["params"], cfg, case["tokens"],
                              case["length"],
                              m.KVCache.create(cfg, dtype=torch.float32,
                                               device="cpu"))
            lg2, c = m.decode_step(case["params"], cfg, case["decode_token"],
                                   c, attn_len=cfg.max_seq)
            port1[name] = (lg, lg2)
            if "extend" in case:
                ext, _ = m.extend(case["params"], cfg, case["extend"], 5, c)
                batch, _ = m.prefill_batch(case["params"], cfg, case["batch"],
                                           case["batch_lengths"],
                                           cache_dtype=torch.float32)
                port1[name] += (ext, batch)
    path = str(tmp_path_factory.mktemp("tp_infer") / "inputs.pt")
    torch.save(inputs, path)
    ranks = run_ranks([sys.executable, RANKS, "infer", path], WORLD,
                      timeout_s=SPAWN_LIMIT_S)
    return {"ref": ref, "port1": port1, "ranks": ranks, "inputs": inputs}


def _close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=0,
                               atol=atol)


@pytest.mark.parametrize("case", LLM_CASES + MLA_CASES)
def test_tp_prefill_and_decode_match_jax_single_device(world, case):
    got = world["ranks"][0]["result"][case]
    want_prefill, want_decode = world["ref"][case]["single"]
    _close(got["logits"], want_prefill, ATOL)
    _close(got["logits2"], want_decode, ATOL)


@pytest.mark.parametrize("case", SHARDED_JAX)
def test_tp_prefill_and_decode_match_jax_sharded(world, case):
    """Against the JAX package's make_sharded_prefill/decode (and
    make_sharded_mla) on a (1, 1, 4) mesh of virtual devices."""
    got = world["ranks"][0]["result"][case]
    want_prefill, want_decode = world["ref"][case]["sharded"]
    _close(got["logits"], want_prefill, ATOL)
    _close(got["logits2"], want_decode, ATOL)


@pytest.mark.parametrize("case", LLM_CASES + MLA_CASES)
def test_tp_matches_the_port_at_tp1(world, case):
    got = world["ranks"][0]["result"][case]
    lg, lg2 = world["port1"][case][:2]
    _close(got["logits"], lg, TP1_ATOL)
    _close(got["logits2"], lg2, TP1_ATOL)


def test_broadcast_gives_every_rank_coordinate_0s_tensor(world):
    for r in world["ranks"]:
        assert r["result"]["broadcast"].tolist() == [0, 7]


@pytest.mark.parametrize("case", PORT_PATHS)
def test_tp_extend_and_prefill_batch_match_the_port_at_tp1(world, case):
    """The other forward paths on the shards: an extend chunk after the
    decode step (5 of 16 rows valid) and a wave of two prompts through
    prefill_batch (lengths 48 and 30), against the same calls at tp=1."""
    got = world["ranks"][0]["result"][case]
    ext, batch = world["port1"][case][2:]
    _close(got["extend"], ext, TP1_ATOL)
    assert got["batch"].shape == batch.shape == (2, 512)
    _close(got["batch"], batch, TP1_ATOL)


def test_every_rank_returns_the_full_logits(world):
    """The sharded functions return the full logits on every rank, the
    same bits (the all-gather copies)."""
    first = world["ranks"][0]["result"]
    for r in world["ranks"][1:]:
        for case, out in r["result"].items():
            if case == "broadcast":
                continue
            assert out["logits"].shape == first[case]["logits"].shape
            assert torch.equal(out["logits"], first[case]["logits"])
            assert torch.equal(out["logits2"], first[case]["logits2"])


def test_ranks_hold_their_coordinates_and_shards(world):
    """Rank r sits at tp coordinate r of a (1, 1, 4) mesh; each holds a
    quarter of the heads and MLP columns, the Q4 wo padded to its packing
    multiple (K = 64 a rank, group 64: one zero group)."""
    for r, out in enumerate(world["ranks"]):
        assert out["coords"] == {"dp": 0, "fsdp": 0, "tp": r}
        assert "Mesh(dp=1, fsdp=1, tp=4" in out["repr"]
    q4 = world["ranks"][0]["result"]["q4"]
    assert q4["report"] == {"layers.wo": {
        "k": 256, "k_local": 64, "group": 64, "kind": "padded",
        "k_padded": 128}}
    whole = world["ranks"][0]["result"]["q4_whole"]
    assert whole["report"]["layers.w_down"]["kind"] == "whole"
    assert whole["shapes"]["layers.w_down"] == [2, 384 // 2, 256]
    assert q4["shapes"]["layers.wqkv"] == [2, 128, (8 + 2 * 4) * 32 // 4]
    assert q4["shapes"]["layers.wo"] == [2, 64, 256]
    assert q4["shapes"]["tok_emb"] == [128, 256]
    assert q4["shapes"]["lm_head"] == [128, 128]
    moe = world["ranks"][0]["result"]["moe"]["shapes"]
    assert moe["layers.w_gu"] == [2, 4, 128, 2 * 512 // 4]
    assert moe["layers.shared_down"] == [2, 64, 256]
    mla = world["ranks"][0]["result"]["mla"]["shapes"]
    assert mla["attn.wkv_b"][-1] == 1 * (16 + 12)


def test_fused_lever_is_not_taken_under_tp(monkeypatch):
    """TRACKIE_FUSED_MLP=1 takes the one-launch fused block where its gates
    hold; a row-parallel w_down (TPLinear) fails them: the block runs the
    unfused route, whose output it equals."""
    from trackiellm_tpu_torch.ops import fused
    from trackiellm_tpu_torch.ops.quant import quantize_q4

    class Identity:
        tp = 2

        def all_reduce(self, t):
            return t
    g = torch.Generator().manual_seed(0)
    d, h = 256, 512
    w_gu = quantize_q4(torch.randn(d, 2 * h, generator=g) / 16, 128)
    w_down = quantize_q4(torch.randn(h, d, generator=g) / 22, 128)
    x = torch.randn(2, d, generator=g)
    norm = torch.ones(d)
    assert fused._can_fuse(x, w_gu, w_down)
    wrapped = tllm.TPLinear(w_down, Identity(), "row")
    assert not fused._can_fuse(x, w_gu, wrapped)
    monkeypatch.setenv("TRACKIE_FUSED_MLP", "1")

    def refuse(*a, **k):
        raise AssertionError("the fused block ran under tp")
    monkeypatch.setattr(fused, "fused_mlp", refuse)
    out = tllm._mlp_block(x, norm, w_gu, wrapped, 1e-5)
    monkeypatch.delenv("TRACKIE_FUSED_MLP")
    want = tllm._mlp_block(x, norm, w_gu, w_down, 1e-5)
    assert torch.equal(out, want)


@pytest.mark.parametrize("change", [{"n_kv_heads": 2}, {"n_heads": 6,
                                                          "n_kv_heads": 6},
                                    {"vocab_size": 510},
                                    {"hidden_dim": 510}])
def test_a_tp_that_does_not_divide_is_refused(change):
    """shard_params refuses a tp the heads, the vocabulary or the MLP width
    do not divide by (the JAX package's stated precondition), naming it."""
    import types
    cfg = tllm.LLMConfig(vocab_size=512, dim=256, n_layers=1, n_heads=8,
                         n_kv_heads=4, head_dim=32, hidden_dim=512,
                         max_seq=64)._replace(**change)
    p = tllm.init_params(torch.Generator().manual_seed(0), cfg,
                         dtype=torch.float32, device="cpu")
    name = next(iter(change))
    with pytest.raises(TrackieError, match=f"{name}=.*tp=4"):
        infer.shard_params(p, cfg, types.SimpleNamespace(tp=4, tp_rank=0))
