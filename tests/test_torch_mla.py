"""The port's MLA family (DeepSeek-V2/V3) against the JAX package, on the CPU.

Three knob sets: ``MLAConfig.tiny()`` (full q_proj, softmax routing; a
vocabulary of 320 so that the byte tokenizer's ids fit), a
q-LoRA tiny, and V3's routing (sigmoid scores with the selection bias,
top-2-sum groups, renormalized top-k, routed scale 2.5, two dense layers).
Weights are seeded numpy draws in the JAX package's layout (the router at
3 / sqrt(D), so that its choices are far apart), carried across by
``params_from_jax``.

f32 logits agree to 1e-5 rel L2 through ``prefill`` (bucket 64: dense
attention), ``decode_step``, ``extend`` with ``all_logits`` and
``decode_chunk_greedy`` (measured 3.1e-7 to 8.9e-7); Q4 and Q8 weights to
1e-5 as well (the CPU runs the same plain quantized products on both
sides; measured 3.2e-7 to 6.8e-7). The batched step follows the single one and
the JAX package's batched step; ``LLMRunner(model=mla)`` gives the JAX
runner's ids (lookahead chunks, speculation, a forced tool call), and
``LLMServer(model=mla)`` the runner's ids; the converters give the JAX
converters' bytes; checkpoints and the CLI round-trip.
"""

import json

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tests.test_deepseek_gguf import _write_deepseek_gguf
from trackiellm_tpu import __main__ as jcli
from trackiellm_tpu.llm import runner as jrunner
from trackiellm_tpu.models import checkpoint as jckpt
from trackiellm_tpu.models import convert as jconv
from trackiellm_tpu.models import mla as jmla
from trackiellm_tpu_torch import __main__ as tcli
from trackiellm_tpu_torch.llm.runner import (GenerationConfig, LLMRunner,
                                             ToolDefinition)
from trackiellm_tpu_torch.llm.server import LLMServer
from trackiellm_tpu_torch.models import checkpoint as tckpt
from trackiellm_tpu_torch.models import convert as tconv
from trackiellm_tpu_torch.models import mla as tmla
from trackiellm_tpu_torch.models.bridge import params_from_jax
from trackiellm_tpu_torch.ops.quant import QuantizedLinear
from trackiellm_tpu_torch.utils.errors import ErrorCode, TrackieError

CPU = torch.device("cpu")
REL = 1e-5
GROUP = 4
TIMEOUT = 120


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TINY = jmla.MLAConfig.tiny()._replace(vocab_size=320)  # byte tokens fit
CONFIGS = {
    "tiny": TINY,
    "qlora": TINY._replace(q_lora_rank=24),
    "v3": TINY._replace(
        n_layers=3, first_k_dense=2, q_lora_rank=24, n_experts=8,
        n_experts_used=2, moe_norm_topk=True, moe_routed_scale=2.5,
        moe_n_groups=4, moe_topk_groups=2, moe_score_func="sigmoid",
        moe_group_score="top2sum", moe_shared_hidden=24),
}


def _np_tree(cfg, seed: int):
    """Seeded numpy leaves in ``mla.init_params``' layout (V3's selection
    bias under sigmoid scores)."""
    shapes = jax.eval_shape(lambda: jmla.init_params(
        jax.random.PRNGKey(0), cfg, dtype=jnp.float32))
    rng = np.random.default_rng(seed)

    def leaf(path, sd):
        name, shape = jax.tree_util.keystr(path), sd.shape
        if "norm" in name:
            v = 1.0 + 0.1 * rng.standard_normal(shape)
        elif "tok_emb" in name:
            v = 0.5 * rng.standard_normal(shape)
        elif "moe_gate" in name:
            v = 3.0 * rng.standard_normal(shape) / np.sqrt(shape[-2])
        else:
            v = rng.standard_normal(shape) / np.sqrt(shape[-2])
        return v.astype(np.float32)
    tree = jax.tree_util.tree_map_with_path(leaf, shapes)
    if cfg.moe_score_func == "sigmoid":
        m = cfg.n_layers - cfg.first_k_dense
        tree["moe_mlp"]["moe_gate_bias"] = (
            0.2 * rng.standard_normal((m, cfg.n_experts)) - 0.3
        ).astype(np.float32)
    return tree


_PARAMS = {}


def _params(name: str, bits: int = 0, seed: int = 7):
    """(JAX cfg, port cfg, JAX params, port params) in f32; ``bits`` 4 or
    8 quantizes at GROUP."""
    key = (name, bits, seed)
    if key not in _PARAMS:
        cfg = CONFIGS[name]
        p = jax.tree_util.tree_map(jnp.asarray, _np_tree(cfg, seed))
        if bits:
            p = jmla.quantize_params(p, bits=bits, group=GROUP)
        _PARAMS[key] = (cfg, tmla.MLAConfig(**cfg._asdict()), p,
                        params_from_jax(p, CPU))
    return _PARAMS[key]


def _tokens(seed, n, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, n).astype(np.int64)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.int64))


@pytest.mark.parametrize("name,bits", [
    ("tiny", 0), ("qlora", 0), ("v3", 0), ("tiny", 4), ("v3", 8)])
def test_forward_matches_jax(name, bits):
    """Bucket-64 prefill of 40 tokens, three decode steps, a 16-token
    extend with 5 valid (every row's logits), four chunked greedy steps:
    logits to 1e-5 rel L2, the latent cache on every written row, and the
    chunk's tokens equal."""
    cfg, tcfg, jp, tp = _params(name, bits)
    toks = _tokens(1, 64)
    jc = jmla.MLACache.create(cfg, dtype=jnp.float32)
    tc = tmla.MLACache.create(tcfg, torch.float32, device=CPU)
    jl, jc = jmla.prefill(jp, cfg, jnp.asarray(toks, jnp.int32),
                          jnp.int32(40), jc)
    tl, tc = tmla.prefill(tp, tcfg, _t(toks), 40, tc)
    assert _rel(tl, jl) < REL
    for tok in (5, 200, 17):
        jl, jc = jmla.decode_step(jp, cfg, jnp.int32(tok), jc, attn_len=64)
        tl, tc = tmla.decode_step(tp, tcfg, tok, tc, attn_len=64)
        assert _rel(tl, jl) < REL
    chunk = np.zeros(16, np.int64)
    chunk[:5] = _tokens(2, 5)
    jl, jc = jmla.extend(jp, cfg, jnp.asarray(chunk, jnp.int32),
                         jnp.int32(5), jc, attn_len=64, all_logits=True)
    tl, tc = tmla.extend(tp, tcfg, _t(chunk), 5, tc, attn_len=64,
                         all_logits=True)
    assert tl.shape == (16, cfg.vocab_size)
    assert _rel(tl[:5], jl[:5]) < REL
    assert tc.length == int(jc.length) == 48
    np.testing.assert_allclose(tc.ckv[:, :48].numpy(),
                               np.asarray(jc.ckv)[:, :48], rtol=0, atol=1e-5)
    jt, jl, jc = jmla.decode_chunk_greedy(jp, cfg, jl[4], jc, 4, attn_len=64)
    tt, tl, tc = tmla.decode_chunk_greedy(tp, tcfg, tl[4], tc, 4,
                                          attn_len=64)
    assert tt.tolist() == np.asarray(jt).tolist()
    assert _rel(tl, jl) < REL and tc.length == 52


# The batched step runs its projections at M = 3, the single step at M = 1;
# the CPU's BLAS blocks its sums by the row count, so a slot's f32 logits
# may differ from the single step's in their last bits, and with every
# matmul split into one call a row they are equal
# (test_batched_step_gap_is_the_blas_row_blocking). That test's gaps, on
# seeds 7, 11 and 13 and both presets, two steps: 2.10e-6 to 2.82e-6 on
# an x86 CPU with MKL. Held at about twice the largest.
ROW_NOISE = 6e-6


def _seq(cfg, tcfg, tp, toks, n):
    c = tmla.MLACache.create(tcfg, torch.float32, device=CPU)
    return tmla.prefill(tp, tcfg, _t(toks), n, c)


@pytest.mark.parametrize("name", ["tiny", "v3"])
def test_batched_step_matches_single_and_jax(name):
    """Two prompts in slots 0 and 2 of three (slot 1 inactive): the batched
    steps give each slot its single decode step's logits (ROW_NOISE) and
    the JAX package's batched logits (1e-5); the inactive slot never
    moves."""
    cfg, tcfg, jp, tp = _params(name)
    prompts = [(_tokens(3, 64), 30), (_tokens(4, 64), 45)]
    bc = tmla.BatchedMLACache.create(tcfg, 3, torch.float32, device=CPU)
    jbc = jmla.BatchedMLACache.create(cfg, 3, dtype=jnp.float32)
    singles = []
    for slot, (toks, n) in zip((0, 2), prompts):
        _, c = _seq(cfg, tcfg, tp, toks, n)
        bc = tmla.insert_sequence(bc, tcfg, slot, c)
        singles.append(_seq(cfg, tcfg, tp, toks, n)[1])
        _, jc = jmla.prefill(jp, cfg, jnp.asarray(toks, jnp.int32),
                             jnp.int32(n), jmla.MLACache.create(
                                 cfg, dtype=jnp.float32))
        jbc = jmla.insert_sequence(jbc, cfg, slot, jc)
    active = torch.tensor([True, False, True])
    before = bc.ckv[:, 1].clone()
    for tok in ([7, 0, 9], [100, 0, 3]):
        lg, bc = tmla.decode_step_batch(tp, tcfg, torch.tensor(tok), active,
                                        bc, attn_len=64)
        jlg, jbc = jmla.decode_step_batch(
            jp, cfg, jnp.asarray(tok, jnp.int32), jnp.asarray(active.numpy()),
            jbc, attn_len=64)
        assert _rel(lg, jlg) < REL
        for row, slot in enumerate((0, 2)):
            sl, singles[row] = tmla.decode_step(tp, tcfg, tok[slot],
                                                singles[row], attn_len=64)
            np.testing.assert_allclose(lg[slot].numpy(), sl.numpy(),
                                       rtol=0, atol=ROW_NOISE)
    assert bc.lengths.tolist() == [32, 0, 47]
    assert torch.equal(bc.ckv[:, 1], before)
    prod, bc = tmla.decode_steps_batch(tp, tcfg, torch.tensor([1, 0, 2]),
                                       active, bc, 3, attn_len=64)
    jprod, _ = jmla.decode_steps_batch(
        jp, cfg, jnp.asarray([1, 0, 2], jnp.int32),
        jnp.asarray(active.numpy()), jbc, 3, attn_len=64)
    assert prod[:, [0, 2]].tolist() == np.asarray(jprod)[:, [0, 2]].tolist()


def _batched_gap(tcfg, tp) -> float:
    """The largest |batched - single| over the slots' logits in
    test_batched_step_matches_single_and_jax's two steps."""
    bc = tmla.BatchedMLACache.create(tcfg, 3, torch.float32, device=CPU)
    singles = []
    for slot, (toks, n) in zip((0, 2), [(_tokens(3, 64), 30),
                                        (_tokens(4, 64), 45)]):
        bc = tmla.insert_sequence(bc, tcfg, slot,
                                  _seq(None, tcfg, tp, toks, n)[1])
        singles.append(_seq(None, tcfg, tp, toks, n)[1])
    gap = 0.0
    for tok in ([7, 0, 9], [100, 0, 3]):
        lg, bc = tmla.decode_step_batch(tp, tcfg, torch.tensor(tok),
                                        torch.tensor([True, False, True]),
                                        bc, attn_len=64)
        for row, slot in enumerate((0, 2)):
            sl, singles[row] = tmla.decode_step(tp, tcfg, tok[slot],
                                                singles[row], attn_len=64)
            gap = max(gap, float((lg[slot] - sl).abs().max()))
    return gap


def _one_row_a_call(fn):
    def call(a, b, *args, **kw):
        if a.dim() == 2 and a.shape[0] > 1:
            return torch.cat([fn(a[i:i + 1], b, *args, **kw)
                              for i in range(a.shape[0])])
        return fn(a, b, *args, **kw)
    return call


@pytest.mark.parametrize("seed", [7, 11, 13])
@pytest.mark.parametrize("name", ["tiny", "v3"])
def test_batched_step_gap_is_the_blas_row_blocking(name, seed, monkeypatch):
    """ROW_NOISE's cause: with every 2-D ``torch.mm``/``torch.matmul``
    split into one call a row, the batched step gives each slot the single
    step's logits bit for bit, so no sum of the port's is ordered by the
    row count; as run, the gap stays within ROW_NOISE."""
    _, tcfg, _, tp = _params(name, seed=seed)
    assert _batched_gap(tcfg, tp) <= ROW_NOISE
    with monkeypatch.context() as m:
        m.setattr(torch, "mm", _one_row_a_call(torch.mm))
        m.setattr(torch, "matmul", _one_row_a_call(torch.matmul))
        assert _batched_gap(tcfg, tp) == 0.0


def _gen(**kw):
    base = dict(max_tokens=24, temperature=0.0, seed=3)
    base.update(kw)
    return base


@pytest.mark.parametrize("kw", [
    {"lookahead": 4, "speculative": False},
    {"lookahead": 1, "speculative": True},
    {"lookahead": 4, "speculative": "auto"},
], ids=["lookahead4", "speculative", "auto"])
def test_runner_matches_the_jax_runner(kw):
    """LLMRunner(model=mla) greedy over two turns (the second through
    prefix reuse's extend) and a forced tool call give the JAX runner's
    ids and text, for lookahead chunks and speculation alike."""
    cfg, tcfg, jp, tp = _params("qlora")
    gen = _gen(**kw)
    jr = jrunner.LLMRunner(jp, cfg, gen_config=jrunner.GenerationConfig(
        **gen), cache_dtype=jnp.float32, model=jmla)
    tr = LLMRunner(tp, tcfg, gen_config=GenerationConfig(**gen),
                   cache_dtype=torch.float32, device=CPU, model=tmla)
    prompt = "abc abc abc abc describe the scene ahead " * 2
    for p in (prompt, prompt + "and the door on the left"):
        assert tr.generate(p) == jr.generate(p)
        assert tr.generated_ids == list(jr._generated_ids)
    tools = [jrunner.ToolDefinition("go", "move", {"to": "where"})]
    want = jr.generate("Navigate", tools=tools, force_tool_call=True)
    got = tr.generate("Navigate", tools=[ToolDefinition("go", "move",
                                                        {"to": "where"})],
                      force_tool_call=True)
    assert got == want
    assert json.loads(got)["tool_call"]["name"] == "go"


def test_server_serves_mla_and_refuses_the_pool():
    """LLMServer(model=mla) on dense latent slots: a burst of three greedy
    requests gives each the runner's ids; paged and int8 caches are
    refused with the reference's messages."""
    cfg, tcfg, jp, tp = _params("tiny")
    prompts = ["abc abc abc", "describe the scene", "is the path clear?"]
    want = []
    for p in prompts:
        r = LLMRunner(tp, tcfg, gen_config=GenerationConfig(**_gen(
            max_tokens=10, speculative=False)), cache_dtype=torch.float32,
            device=CPU, model=tmla)
        want.append(r.generate(p))
    server = LLMServer(tp, tcfg, batch_slots=2, cache_dtype=torch.float32,
                       model=tmla, device=CPU)
    try:
        futs = [server.submit(p, max_tokens=10) for p in prompts]
        assert [f.result(TIMEOUT) for f in futs] == want
    finally:
        server.close()
    with pytest.raises(TrackieError, match="paged KV supports the default"):
        LLMServer(tp, tcfg, model=tmla, paged=True, device=CPU)
    with pytest.raises(TrackieError, match="int8 KV requires paged mode") as e:
        LLMServer(tp, tcfg, model=tmla, cache_dtype=torch.int8, device=CPU)
    assert e.value.code == ErrorCode.INVALID_ARGUMENT


def _same_tree(got, want):
    """Every leaf of the port's tree has the JAX tree's bytes."""
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _same_tree(got[k], want[k])
        return
    if hasattr(want, "values") and hasattr(want, "scales"):
        assert isinstance(got, QuantizedLinear)
        _same_tree(got.values, want.values)
        _same_tree(got.scales, want.scales)
        return
    w = np.asarray(want)
    g = got.cpu()
    if w.dtype.name == "bfloat16":
        assert g.dtype == torch.bfloat16
        g, w = g.view(torch.int16).numpy().view(np.uint16), w.view(np.uint16)
    else:
        g = g.numpy()
    assert g.dtype == w.dtype and g.shape == w.shape
    assert np.array_equal(g, w)


def _hf_state(cfg, seed: int, v3: bool):
    """A transformers DeepSeek state dict at ``cfg``'s widths."""
    rng = np.random.default_rng(seed)

    def R(*s):
        return (rng.standard_normal(s) / np.sqrt(s[-1])).astype(np.float32)

    h, r = cfg.n_heads, cfg.kv_lora_rank
    st = {"model.embed_tokens.weight": R(cfg.vocab_size, cfg.dim),
          "model.norm.weight": 1.0 + R(cfg.dim),
          "lm_head.weight": R(cfg.vocab_size, cfg.dim)}
    for i in range(cfg.n_layers):
        p = f"model.layers.{i}"
        sa = f"{p}.self_attn"
        st[f"{p}.input_layernorm.weight"] = 1.0 + R(cfg.dim)
        st[f"{p}.post_attention_layernorm.weight"] = 1.0 + R(cfg.dim)
        st[f"{sa}.kv_a_proj_with_mqa.weight"] = R(
            r + cfg.qk_rope_head_dim, cfg.dim)
        st[f"{sa}.kv_a_layernorm.weight"] = 1.0 + R(r)
        st[f"{sa}.kv_b_proj.weight"] = R(
            h * (cfg.qk_nope_head_dim + cfg.v_head_dim), r)
        st[f"{sa}.o_proj.weight"] = R(cfg.dim, h * cfg.v_head_dim)
        if cfg.q_lora_rank:
            st[f"{sa}.q_a_proj.weight"] = R(cfg.q_lora_rank, cfg.dim)
            st[f"{sa}.q_a_layernorm.weight"] = 1.0 + R(cfg.q_lora_rank)
            st[f"{sa}.q_b_proj.weight"] = R(h * cfg.qk_head_dim,
                                            cfg.q_lora_rank)
        else:
            st[f"{sa}.q_proj.weight"] = R(h * cfg.qk_head_dim, cfg.dim)

        def mlp(pre, hid):
            st[f"{pre}.gate_proj.weight"] = R(hid, cfg.dim)
            st[f"{pre}.up_proj.weight"] = R(hid, cfg.dim)
            st[f"{pre}.down_proj.weight"] = R(cfg.dim, hid)
        if i < cfg.first_k_dense:
            mlp(f"{p}.mlp", cfg.hidden_dim)
            continue
        st[f"{p}.mlp.gate.weight"] = R(cfg.n_experts, cfg.dim)
        if v3:
            st[f"{p}.mlp.gate.e_score_correction_bias"] = R(cfg.n_experts)
        for e in range(cfg.n_experts):
            mlp(f"{p}.mlp.experts.{e}", cfg.moe_hidden_dim)
        mlp(f"{p}.mlp.shared_experts", cfg.moe_shared_hidden)
    return st


@pytest.mark.parametrize("name,v3,bits", [
    ("tiny", False, 0), ("qlora", False, 4), ("v3", True, 8)])
def test_hf_converters_give_the_jax_bytes(name, v3, bits):
    """deepseek_v2_from_hf / deepseek_v3_from_hf on a state dict made here
    (V2-Lite's full q_proj, V2's q-LoRA, V3's selection bias) give the
    JAX converters' config and bf16 bytes, and quantize_params (bits 4
    and 8) the JAX package's quantized bytes."""
    cfg = CONFIGS[name]
    state = _hf_state(cfg, 11, v3)
    kw = dict(qk_nope_head_dim=cfg.qk_nope_head_dim,
              qk_rope_head_dim=cfg.qk_rope_head_dim, max_seq=128)
    jfn = jconv.deepseek_v3_from_hf if v3 else jconv.deepseek_v2_from_hf
    tfn = tconv.deepseek_v3_from_hf if v3 else tconv.deepseek_v2_from_hf
    jp, jc = jfn(state, **kw)
    tp, tc = tfn(state, device=CPU, **kw)
    assert tc._asdict() == jc._asdict()
    assert (tc.moe_score_func == "sigmoid") == v3
    _same_tree(tp, jp)
    if bits:
        _same_tree(tmla.quantize_params(tp, bits=bits, group=GROUP),
                   jmla.quantize_params(jp, bits=bits, group=GROUP))


@pytest.mark.parametrize("split,bits", [(False, None), (True, 4), (False, 8)],
                         ids=["kv_b", "split_q4", "q8"])
def test_gguf_route_gives_the_jax_bytes(tmp_path, split, bits):
    """A deepseek2 GGUF written here in neox rope order (the fused kv_b, or
    the split k_b/v_b pair in two orientations) through gguf_to_mla_params
    and gguf_convert_auto: the JAX route's config and bytes at bits None, 4
    and 8."""
    cfg = CONFIGS["v3"]
    params = _np_tree(cfg, 5)
    path = str(tmp_path / "ds.gguf")
    _write_deepseek_gguf(path, params, cfg, split_kv_b=split)
    jp, jc = jconv.gguf_to_mla_params(path, bits=bits, group=GROUP)
    tp, tc = tconv.gguf_to_mla_params(path, bits=bits, group=GROUP,
                                      device=CPU)
    assert tc._asdict() == jc._asdict()
    _same_tree(tp, jp)
    if bits is None:
        ap, ac = tconv.gguf_convert_auto(path, device=CPU)
        assert ac == tc
        _same_tree(ap, jconv.gguf_convert_auto(path)[0])


def test_checkpoint_round_trips_both_ways(tmp_path):
    """A Q4 MLA tree with its MLAConfig: the port loads the JAX package's
    checkpoint and the JAX package the port's, bytes and config equal."""
    cfg, tcfg, jp, tp = _params("qlora", 4)
    jckpt.save_checkpoint(str(tmp_path / "j"), jp, config=cfg)
    got, gcfg, _ = tckpt.load_checkpoint(str(tmp_path / "j"), device=CPU)
    assert isinstance(gcfg, tmla.MLAConfig) and gcfg == tcfg
    _same_tree(got, jp)
    tckpt.save_checkpoint(str(tmp_path / "t"), tp, config=tcfg)
    back, bcfg, _ = jckpt.load_checkpoint(str(tmp_path / "t"))
    assert bcfg == cfg
    _same_tree(tp, back)


def test_cli_convert_inspect_and_generate_match_jax(tmp_path, capsys):
    """A deepseek2 GGUF through both CLIs: ``inspect`` prints the JAX
    description, ``convert --bits 4`` writes the same arrays and
    ``generate`` (greedy) prints the same text. Every quantized K is a
    multiple of 128, as the CLI's group of 64 asks."""
    cfg = TINY._replace(dim=128, n_layers=2, qk_nope_head_dim=64,
                        v_head_dim=64, hidden_dim=128,
                        moe_hidden_dim=128, moe_shared_hidden=128)
    path = str(tmp_path / "ds.gguf")
    _write_deepseek_gguf(path, _np_tree(cfg, 9), cfg)
    assert jcli.main(["inspect", path]) == 0
    want = capsys.readouterr().out
    assert tcli.main(["inspect", path]) == 0
    assert capsys.readouterr().out == want
    out = {}
    for name, main, extra in (("j", jcli.main, []),
                              ("t", tcli.main, ["--device", "cpu"])):
        ck = str(tmp_path / name)
        assert main(["convert", path, "-o", ck, "--bits", "4", *extra]) == 0
        assert main(["generate", ck, "-p", "abc", "--max-tokens", "8",
                     "--temperature", "0", *extra]) == 0
        out[name] = capsys.readouterr().out.splitlines()[-1]
    assert out["t"] == out["j"]
    with np.load(tmp_path / "j" / "arrays.npz") as a, \
            np.load(tmp_path / "t" / "arrays.npz") as b:
        assert set(a.files) == set(b.files)
        for k in a.files:
            assert np.array_equal(a[k], b[k]), k


def test_init_params_quantized_has_quantize_params_layout():
    """The card-side quantized initializer gives quantize_params' tree: the same
    leaves, shapes and dtypes (wkv_a, wkv_b and the router float)."""
    cfg = tmla.MLAConfig(**CONFIGS["v3"]._asdict())
    g = torch.Generator().manual_seed(0)
    want = tmla.quantize_params(tmla.init_params(g, cfg, device=CPU),
                                bits=4, group=GROUP)
    got = tmla.init_params_quantized(torch.Generator().manual_seed(0), cfg,
                                     bits=4, group=GROUP, device=CPU)

    def shapes(t):
        if isinstance(t, dict):
            return {k: shapes(v) for k, v in t.items()}
        if isinstance(t, QuantizedLinear):
            return ("q", shapes(t.values), shapes(t.scales))
        return (tuple(t.shape), t.dtype)
    assert shapes(got) == shapes(want)
    assert not isinstance(got["attn"]["wkv_b"], QuantizedLinear)


def test_quantize_params_halves_the_group_where_it_does_not_divide():
    """DeepSeek-V2-Lite's dense w_down (K = 10,944) has no group of 64 at
    Q4 (K/2 = 5,472 = 2^5 * 171), and the reference's quantize_params
    asserts there. The port takes the largest halving that divides
    (``group_for``); every other matrix keeps the JAX package's bytes.
    Here a dense width of 96 (K/2 = 48) takes 16."""
    cfg = TINY._replace(dim=128, hidden_dim=96, qk_nope_head_dim=64,
                        v_head_dim=64, moe_hidden_dim=128,
                        moe_shared_hidden=128)
    jp = jax.tree_util.tree_map(jnp.asarray, _np_tree(cfg, 3))
    with pytest.raises(AssertionError):
        jmla.quantize_params(jp, bits=4, group=64)
    tp = tmla.quantize_params(params_from_jax(jp, CPU), bits=4, group=64)
    assert tmla.group_for(96, 64, 4) == 16 and tmla.group_for(96, 64, 8) == 32
    assert tp["dense_mlp"]["w_down"].group_size == 16
    moe = dict(jp["moe_mlp"])
    _same_tree({"moe_mlp": {k: tp["moe_mlp"][k] for k in moe}},
               {"moe_mlp": jmla.quantize_params(
                   {**jp, "dense_mlp": {}}, bits=4, group=64)["moe_mlp"]})
