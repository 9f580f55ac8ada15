"""The port's Qwen3-Next against the JAX package's, on the CPU.

The same transformers-named state dict, drawn here with numpy at the JAX
tests' tiny shapes (``tests/test_qwen3next.py``: dim 64, layers
("l", "l", "l", "f"), 4/2 attention heads of 16, 2/4 DeltaNet heads of 16,
4 experts top 2 of width 48, shared 48), goes through both packages'
``qwen3_next_from_hf``; the trees are byte-equal and every forward path
agrees in f32 within REL rel L2 (logits measured 1.4e-6 to 2.5e-6):
teacher-forced logits, cached decode, split and padded prefill, the chunked delta rule
against the recurrence and against JAX's, routed against dense-all
experts, Q8 and Q4 trees, ``fuse_projections``, a ``MambaRunner`` session,
checkpoints, both converters' bytes and the GGUF route's conventions.
"""

import json

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from trackiellm_tpu.llm.runner import GenerationConfig as JGen
from trackiellm_tpu.models import checkpoint as jckpt
from trackiellm_tpu.models import convert as jconv
from trackiellm_tpu.models import mamba as jmamba
from trackiellm_tpu.models import qwen3next as jq
from trackiellm_tpu_torch.llm.runner import GenerationConfig
from trackiellm_tpu_torch.models import checkpoint as tckpt
from trackiellm_tpu_torch.models import convert as tconv
from trackiellm_tpu_torch.models import mamba as tmamba
from trackiellm_tpu_torch.models import qwen3next as tq
from trackiellm_tpu_torch.ops.quant import QuantizedLinear
from trackiellm_tpu_torch.utils.errors import TrackieError

CPU = torch.device("cpu")
REL = 1e-5
VOCAB, DIM, LAYERS = 320, 64, 4
HEADS, KV, HD = 4, 2, 16
LHK, LHV, LDK, LDV, CONVK = 2, 4, 16, 16, 4
EXPERTS, TOPK, MOE_HID, SHARED_HID = 4, 2, 48, 48
SEQ = 15


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _smoke():
    """chip_smoke.py as a module: its Qwen3-Next state dict and GGUF
    writers."""
    import importlib.util
    import os
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


CS = _smoke()


def hf_config(moe: bool = True) -> dict:
    """The HF config.json fields the converters read, at the JAX tests'
    widths."""
    conf = CS.qwen3next_hf_config({
        "dim": DIM, "heads": HEADS, "kv": KV, "head_dim": HD,
        "lin_hk": LHK, "lin_hv": LHV, "lin_d": LDK,
        "experts": EXPERTS if moe else 0, "top_k": TOPK,
        "moe_hidden": MOE_HID, "layers": LAYERS, "vocab": VOCAB})
    return {**conf, "intermediate_size": 96}


def hf_state(conf: dict, seed: int = 7) -> dict:
    """A ``Qwen3NextForCausalLM``-named state dict (chip_smoke's writer):
    norms N(0, 0.2), matrices N(0, 0.08) as tests/test_qwen3next.py draws
    them, A_log and dt_bias in the HF init's ranges."""
    return CS.qwen3next_hf_state(conf, seed)


_MODELS = {}


def _model(moe: bool = True):
    """(state, JAX params, JAX cfg, port params, port cfg) at max_seq 64."""
    if moe not in _MODELS:
        conf = hf_config(moe)
        st = hf_state(conf)
        jp, jc = jconv.qwen3_next_from_hf(st, conf, max_seq=64)
        tp, tc = tconv.qwen3_next_from_hf(st, conf, max_seq=64, device=CPU)
        _MODELS[moe] = (st, jp, jc, tp, tc)
    return _MODELS[moe]


def _tokens(n: int = SEQ + 3, seed: int = 9):
    return np.random.default_rng(seed).integers(0, VOCAB, n).astype(np.int32)


def _same(t, j):
    """Port leaf ``t`` holds the JAX leaf ``j``'s bytes and dtype."""
    if isinstance(j, dict):
        assert isinstance(t, dict) and t.keys() == j.keys()
        for k in j:
            _same(t[k], j[k])
        return
    if isinstance(j, (list, tuple)) and not hasattr(j, "values"):
        assert len(t) == len(j)
        for a, b in zip(t, j):
            _same(a, b)
        return
    if hasattr(j, "values") and hasattr(j, "scales"):
        assert isinstance(t, QuantizedLinear)
        _same(t.values, j.values)
        _same(t.scales, j.scales)
        return
    ja = np.asarray(j)
    ta = t.detach().cpu()
    if ja.dtype.name == "bfloat16":
        assert ta.dtype == torch.bfloat16
        assert np.array_equal(ta.view(torch.int16).numpy(),
                              ja.view(np.int16))
    else:
        assert str(ta.numpy().dtype) == str(ja.dtype)
        assert np.array_equal(ta.numpy(), ja)


def test_converter_gives_the_jax_bytes_and_config():
    st, jp, jc, tp, tc = _model()
    assert tuple(tc) == tuple(jc)
    assert tc.layer_types == ("l", "l", "l", "f") and tc.n_experts == EXPERTS
    _same(tp, jp)


def test_teacher_forced_logits_match_jax():
    _, jp, jc, tp, tc = _model()
    toks = _tokens()[:SEQ]
    want, _ = jq.forward(jp, jc, jnp.asarray(toks), jq.create_cache(jc))
    got, _ = tq.forward(tp, tc, torch.from_numpy(toks),
                        tq.create_cache(tc, device=CPU))
    assert _rel(got, want) < REL


def test_cached_decode_matches_jax():
    """Prefill, then three decode steps: the conv carry, the delta state
    and the KV append, with the recurrent state itself compared."""
    _, jp, jc, tp, tc = _model()
    toks = _tokens()
    jl, jcache = jq.prefill(jp, jc, jnp.asarray(toks[:SEQ]), jnp.int32(SEQ),
                            jq.create_cache(jc))
    tl, tcache = tq.prefill(tp, tc, torch.from_numpy(toks[:SEQ]), SEQ,
                            tq.create_cache(tc, device=CPU))
    assert _rel(tl, jl) < REL
    for j in range(3):
        jl, jcache = jq.decode_step(jp, jc, jnp.int32(toks[SEQ + j]), jcache)
        tl, tcache = tq.decode_step(tp, tc, int(toks[SEQ + j]), tcache)
        assert _rel(tl, jl) < REL, j
    assert int(tcache["length"]) == int(jcache["length"]) == SEQ + 3
    for ts, js in zip(tcache["layers"], jcache["layers"]):
        for k in js:
            assert _rel(ts[k], js[k]) < REL, k


def test_split_prefill_matches_one_shot():
    _, _, _, tp, tc = _model()
    toks = torch.from_numpy(_tokens()[:SEQ])
    one, _ = tq.forward(tp, tc, toks, tq.create_cache(tc, device=CPU))
    _, c = tq.forward(tp, tc, toks[:6], tq.create_cache(tc, device=CPU))
    two, _ = tq.forward(tp, tc, toks[6:], c)
    assert _rel(two, one[6:]) < REL


def test_padded_prefill_matches_exact_and_jax():
    """A bucket of 24 with SEQ real tokens and junk after them: the padded
    rows are inert (conv window, delta no-ops, stale K/V rows), on both
    packages, and the decode after them continues alike."""
    _, jp, jc, tp, tc = _model()
    toks = _tokens()
    padded = np.full(24, 7, np.int32)
    padded[:SEQ] = toks[:SEQ]
    exact, ce = tq.prefill(tp, tc, torch.from_numpy(toks[:SEQ]), SEQ,
                           tq.create_cache(tc, device=CPU))
    pad, cp = tq.prefill(tp, tc, torch.from_numpy(padded),
                         torch.tensor(SEQ), tq.create_cache(tc, device=CPU))
    assert _rel(pad, exact) < REL
    jl, _ = jq.prefill(jp, jc, jnp.asarray(padded), jnp.int32(SEQ),
                       jq.create_cache(jc))
    assert _rel(pad, jl) < REL
    de, _ = tq.decode_step(tp, tc, int(toks[SEQ]), ce)
    dp, _ = tq.decode_step(tp, tc, torch.tensor(int(toks[SEQ])), cp)
    assert _rel(dp, de) < REL


def _delta_inputs(h=3, t=37, dk=8, dv=8, seed=11):
    rng = np.random.RandomState(seed)
    q = rng.randn(h, t, dk).astype(np.float32)
    k = rng.randn(h, t, dk).astype(np.float32)
    v = rng.randn(h, t, dv).astype(np.float32)
    g = (-np.abs(rng.randn(h, t)) * 0.3).astype(np.float32)
    beta = (1 / (1 + np.exp(-rng.randn(h, t)))).astype(np.float32)
    s0 = (rng.randn(h, dk, dv) * 0.1).astype(np.float32)
    return q, k, v, g, beta, s0


@pytest.mark.parametrize("t,chunk", [(37, 16), (8, 64), (130, 64)])
def test_chunked_delta_rule_matches_recurrence_and_jax(t, chunk):
    """The chunked rule (a length past one chunk and not a multiple of
    it, one short chunk, three chunks) against the per-token recurrence
    here and against JAX's chunked rule on the same inputs."""
    q, k, v, g, beta, s0 = _delta_inputs(t=t)
    tqn = tq._l2norm(torch.from_numpy(q)) / np.sqrt(q.shape[-1])
    tkn = tq._l2norm(torch.from_numpy(k))
    out, st = tq._chunk_gated_delta(tqn, tkn, torch.from_numpy(v),
                                    torch.from_numpy(g),
                                    torch.from_numpy(beta),
                                    torch.from_numpy(s0), chunk=chunk)
    rec, outs = torch.from_numpy(s0), []
    for i in range(t):
        rec, o = tq._delta_step(rec, tqn[:, i], tkn[:, i],
                                torch.from_numpy(v[:, i]),
                                torch.from_numpy(g[:, i]),
                                torch.from_numpy(beta[:, i]))
        outs.append(o)
    assert _rel(out, torch.stack(outs, dim=1)) < 1e-5
    assert _rel(st, rec) < 1e-5
    jqn = jq._l2norm(jnp.asarray(q)) / np.sqrt(q.shape[-1])
    jo, js = jq._chunk_gated_delta(jqn, jq._l2norm(jnp.asarray(k)),
                                   jnp.asarray(v), jnp.asarray(g),
                                   jnp.asarray(beta), jnp.asarray(s0),
                                   chunk=chunk)
    assert _rel(out, jo) < REL
    assert _rel(st, js) < REL


def test_cumsum_order_and_l2norm_eps():
    """The in-chunk decay's cumulative sum is XLA's CPU order
    (``ops/scan.py``), and _l2norm puts eps inside the root."""
    g = torch.from_numpy(_delta_inputs(t=64)[3]).reshape(3, 1, 64)
    from trackiellm_tpu_torch.ops.scan import cumsum
    assert np.array_equal(cumsum(g).numpy(),
                          np.asarray(jnp.cumsum(jnp.asarray(g.numpy()),
                                                axis=-1)))
    x = torch.zeros(2, 4)
    assert torch.equal(tq._l2norm(x), torch.zeros(2, 4))
    x = torch.full((1, 4), 1e-4)
    assert torch.allclose(tq._l2norm(x), x * torch.rsqrt(
        torch.tensor(4e-8 + 1e-6)))


def test_routed_matches_the_dense_loop(monkeypatch):
    _, _, _, tp, tc = _model()
    toks = torch.from_numpy(_tokens()[:SEQ])
    monkeypatch.setenv("TRACKIE_MOE_ROUTED", "0")
    dense, _ = tq.forward(tp, tc, toks, tq.create_cache(tc, device=CPU))
    monkeypatch.setenv("TRACKIE_MOE_ROUTED", "1")
    routed, _ = tq.forward(tp, tc, toks, tq.create_cache(tc, device=CPU))
    assert _rel(routed, dense) < REL


def test_routed_matches_jax_routed(monkeypatch):
    _, jp, jc, tp, tc = _model()
    toks = _tokens()[:SEQ]
    monkeypatch.setenv("TRACKIE_MOE_ROUTED", "1")
    want, _ = jq.forward(jp, jc, jnp.asarray(toks), jq.create_cache(jc))
    got, _ = tq.forward(tp, tc, torch.from_numpy(toks),
                        tq.create_cache(tc, device=CPU))
    assert _rel(got, want) < REL


@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_trees_give_jax_bytes_and_logits(bits):
    """quantize_params at group 16 (Q8) and 8 (Q4: K/2 of the width-48
    banks): byte-equal banks (per-expert stacks), prefill and one decode
    step within REL of JAX's."""
    _, jp, jc, tp, tc = _model()
    group = 16 if bits == 8 else 8
    jqp = jq.quantize_params(jp, bits=bits, group=group)
    tqp = tq.quantize_params(tp, bits=bits, group=group)
    _same(tqp, jqp)
    assert isinstance(tqp["layers"][0]["w_gu"], QuantizedLinear)
    assert tqp["layers"][0]["w_gu"].values.shape[0] == EXPERTS
    toks = _tokens()
    jl, jcache = jq.prefill(jqp, jc, jnp.asarray(toks[:SEQ]),
                            jnp.int32(SEQ), jq.create_cache(jc))
    tl, tcache = tq.prefill(tqp, tc, torch.from_numpy(toks[:SEQ]), SEQ,
                            tq.create_cache(tc, device=CPU))
    assert _rel(tl, jl) < REL
    jl, _ = jq.decode_step(jqp, jc, jnp.int32(toks[SEQ]), jcache)
    tl, _ = tq.decode_step(tqp, tc, int(toks[SEQ]), tcache)
    assert _rel(tl, jl) < REL


def test_fuse_projections_matches_split_and_jax():
    _, jp, jc, tp, tc = _model()
    tf = tq.fuse_projections(tp, tc)
    jf = jq.fuse_projections(jp, jc)
    assert all("w_in" in lp and "wq" not in lp for lp in tf["layers"])
    _same(tf, jf)
    toks = _tokens()[:SEQ]
    a, _ = tq.forward(tp, tc, torch.from_numpy(toks),
                      tq.create_cache(tc, device=CPU))
    b, _ = tq.forward(tf, tc, torch.from_numpy(toks),
                      tq.create_cache(tc, device=CPU))
    assert _rel(b, a) < REL
    qp = tq.fuse_projections(tq.quantize_params(tp, bits=8, group=16), tc)
    assert all("w_in" not in lp for lp in qp["layers"])


def test_dense_mlp_variant_matches_jax():
    _, jp, jc, tp, tc = _model(moe=False)
    assert tc.n_experts == 0
    toks = _tokens()[:SEQ]
    want, _ = jq.forward(jp, jc, jnp.asarray(toks), jq.create_cache(jc))
    got, _ = tq.forward(tp, tc, torch.from_numpy(toks),
                        tq.create_cache(tc, device=CPU))
    assert _rel(got, want) < REL


def test_params_carried_from_jax_are_the_same_bytes():
    _, jp, jc, tp, tc = _model()
    carried = tconv.qwen3next_params_from_jax(
        jq.quantize_params(jp, bits=4, group=8), tc, device=CPU)
    _same(carried, jq.quantize_params(jp, bits=4, group=8))
    with pytest.raises(TrackieError, match="layer types"):
        tconv.qwen3next_params_from_jax(
            {**jp, "layers": jp["layers"][:2]}, tc, device=CPU)


def test_mamba_runner_session_matches_the_jax_runner():
    """MambaRunner picks this module by config type: its ids and the
    recurrent state after a turn and a tool response equal the JAX
    runner's (greedy, the byte tokenizer)."""
    _, jp, jc, tp, tc = _model()
    jr = jmamba.MambaRunner(jp, jc, gen_config=JGen(max_tokens=6,
                                                    temperature=0.0))
    tr = tmamba.MambaRunner(tp, tc, gen_config=GenerationConfig(
        max_tokens=6, temperature=0.0), device=CPU)
    assert tr._m is tq and tr._cache_cls is tq.Cache
    prompt = tr.build_prompt("sys", "ctx", "ola")
    assert tr.generate(prompt) == jr.generate(prompt)
    assert tr.generated_ids == list(jr._generated_ids)
    jr.add_tool_response("t", {"ok": 1})
    tr.add_tool_response("t", {"ok": 1})
    assert int(tr.cache["length"]) == int(jr.cache["length"])
    for ts, js in zip(tr.cache["layers"], jr.cache["layers"]):
        for k in js:
            assert _rel(ts[k], js[k]) < REL, k


def test_checkpoint_round_trip_keeps_expert_stacks(tmp_path):
    """A Q4 tree with per-expert stacked banks: saved by either package,
    loaded by the port byte-equal, with the config's layer_types a tuple."""
    _, jp, jc, tp, tc = _model()
    tqp = tq.quantize_params(tp, bits=4, group=8)
    tckpt.save_checkpoint(str(tmp_path / "t"), tqp, config=tc)
    back, cfg, _ = tckpt.load_checkpoint(str(tmp_path / "t"), device=CPU)
    assert cfg == tc and isinstance(cfg.layer_types, tuple)
    _same(back, jq.quantize_params(jp, bits=4, group=8))
    jckpt.save_checkpoint(str(tmp_path / "j"),
                          jq.quantize_params(jp, bits=4, group=8),
                          config=jc)
    back, cfg, _ = tckpt.load_checkpoint(str(tmp_path / "j"), device=CPU)
    assert tuple(cfg) == tuple(tc)
    _same(back, tqp)


def test_greedy_generate_matches_jax():
    _, jp, jc, tp, tc = _model()
    prompt = _tokens()[:6]
    assert tq.greedy_generate(tp, tc, prompt, 4) == jq.greedy_generate(
        jp, jc, prompt, 4)


def test_converter_needs_the_head_splits():
    conf = hf_config()
    st = hf_state(conf)
    bad = {k: v for k, v in conf.items() if k != "linear_key_head_dim"}
    with pytest.raises(TrackieError, match="linear_key_head_dim"):
        tconv.qwen3_next_from_hf(st, bad, device=CPU)
    with pytest.raises(TrackieError, match="head_dim"):
        tconv.qwen3_next_from_hf(st, {k: v for k, v in conf.items()
                                      if k != "head_dim"}, device=CPU)


def _gguf(path, state, conf, **kw):
    from tests.test_loader import write_gguf
    md = CS.qwen3next_gguf_metadata(conf)
    md.update(kw.pop("extra_md", {}))
    write_gguf(path, CS.qwen3next_gguf_tensors(state, conf, **kw),
               metadata=md)


@pytest.mark.parametrize("split_gate,neg_a", [(False, False), (True, True)])
def test_gguf_route_gives_the_jax_bytes(tmp_path, split_gate, neg_a):
    """A qwen3next GGUF in both attention-gate layouts (fused in attn_q or
    a separate attn_gate) and both ssm_a encodings (raw A_log or
    -exp(A_log)): the port's tree and config equal the JAX converter's, and
    the model's logits equal those of the transformers-dict route."""
    st, jp, jc, tp, tc = _model()
    path = str(tmp_path / "q3n.gguf")
    _gguf(path, st, hf_config(), split_gate=split_gate, neg_a=neg_a)
    jg, jgc = jconv.gguf_to_qwen3next_params(path, max_seq=64)
    tg, tgc = tconv.gguf_to_qwen3next_params(path, max_seq=64, device=CPU)
    assert tuple(tgc) == tuple(jgc)
    assert tgc._replace(norm_eps=tc.norm_eps) == tc  # f32 metadata
    _same(tg, jg)
    toks = torch.from_numpy(_tokens()[:SEQ])
    a, _ = tq.forward(tg, tgc, toks, tq.create_cache(tgc, device=CPU))
    b, _ = tq.forward(tp, tc, toks, tq.create_cache(tc, device=CPU))
    assert _rel(a, b) < REL


def test_gguf_route_quantizes_like_jax(tmp_path):
    st, _, _, _, _ = _model()
    path = str(tmp_path / "q3n.gguf")
    _gguf(path, st, hf_config())
    jg, _ = jconv.gguf_to_qwen3next_params(path, bits=8, group=16, max_seq=64)
    tg, _ = tconv.gguf_to_qwen3next_params(path, bits=8, group=16,
                                           max_seq=64, device=CPU)
    _same(tg, jg)
    assert isinstance(tg["layers"][0]["w_gu"], QuantizedLinear)


@pytest.mark.parametrize("key,delta", [
    ("qwen3next.ssm.group_count", 1), ("qwen3next.ssm.inner_size", 16),
    ("qwen3next.attention.key_length", 8), ("qwen3next.expert_count", 1)])
def test_tampered_gguf_geometry_fails_loudly(tmp_path, key, delta):
    st, _, _, _, _ = _model()
    conf = hf_config()
    path = str(tmp_path / "bad.gguf")
    md = CS.qwen3next_gguf_metadata(conf)
    _gguf(path, st, conf, extra_md={key: md[key] + delta})
    with pytest.raises(TrackieError, match=key.split(".", 1)[1]):
        tconv.gguf_to_qwen3next_params(path, max_seq=64, device=CPU)
    with pytest.raises(Exception):
        jconv.gguf_to_qwen3next_params(path, max_seq=64)


def test_gguf_auto_dispatch_and_cli_inspect(tmp_path, capsys):
    """gguf_convert_auto takes the qwen3next route, and both CLIs' inspect
    print the same description of the file."""
    from trackiellm_tpu.__main__ import main as jmain
    from trackiellm_tpu_torch.__main__ import main as tmain
    st, _, _, _, _ = _model()
    path = str(tmp_path / "q3n.gguf")
    _gguf(path, st, hf_config())
    params, cfg = tconv.gguf_convert_auto(path, device=CPU)
    assert type(cfg).__name__ == "Qwen3NextConfig"
    assert jmain(["inspect", path]) == 0
    want = capsys.readouterr().out
    assert tmain(["inspect", path]) == 0
    assert capsys.readouterr().out == want
    assert json.loads(want)["architecture"] == "qwen3next"
