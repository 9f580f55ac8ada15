"""The port's Mamba and Mamba-2 families against the JAX package, on the CPU.

``ops/scan.py:associative_scan`` gives ``jax.lax.associative_scan``'s bits
(eager JAX; under ``jit`` XLA contracts the combine's product and sum
into one FMA, measured at most 4.8e-7 apart on f32 of order one).
``MambaConfig.test()`` with the JAX package's own ``init_params`` draws
(numpy, so both packages build the same values) and ``Mamba2Config.test()``
through ``mamba2_from_hf`` on a state dict made here: f32 logits agree to
1e-5 rel L2 through ``prefill``, ``decode_step``, ``extend`` and (Mamba)
``decode_chunk_greedy`` (measured 7.6e-8 to 5.1e-7, Q4 and Q8 Mamba
weights included); the batched step follows the single one and the JAX
batched step; ``MambaRunner`` gives the JAX runner's text,
``LLMServer(model=mamba)`` the runner's; the converters give the JAX
converters' bytes; checkpoints and the CLI round-trip.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tests import test_mamba as jmamba_tests
from trackiellm_tpu import __main__ as jcli
from trackiellm_tpu.llm.runner import GenerationConfig as JGen
from trackiellm_tpu.models import checkpoint as jckpt
from trackiellm_tpu.models import convert as jconv
from trackiellm_tpu.models import mamba as jmamba
from trackiellm_tpu.models import mamba2 as jmamba2
from trackiellm_tpu_torch import __main__ as tcli
from trackiellm_tpu_torch.llm.runner import GenerationConfig
from trackiellm_tpu_torch.llm.server import LLMServer
from trackiellm_tpu_torch.models import checkpoint as tckpt
from trackiellm_tpu_torch.models import convert as tconv
from trackiellm_tpu_torch.models import mamba as tmamba
from trackiellm_tpu_torch.models import mamba2 as tmamba2
from trackiellm_tpu_torch.models.bridge import params_from_jax
from trackiellm_tpu_torch.ops.quant import QuantizedLinear
from trackiellm_tpu_torch.ops.scan import associative_scan
from trackiellm_tpu_torch.utils.errors import TrackieError

CPU = torch.device("cpu")
REL = 1e-5
GROUP = 16
TIMEOUT = 120
VOCAB = 320   # the byte tokenizer's ids fit


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.int64))


def _tokens(seed, n):
    return np.random.default_rng(seed).integers(0, 256, n).astype(np.int64)


def _pair(left, right):
    return (left[0] * right[0], left[1] * right[0] + right[1])


@pytest.mark.parametrize("n,shape_a", [(1, (3,)), (2, (3,)), (37, (5,)),
                                       (64, (4, 1, 1)), (255, (2, 3))])
def test_associative_scan_gives_jax_bits(n, shape_a):
    """The (a, b) pair scan of the selective SSM, lengths 1 to 255 (odd
    and even levels), a broadcast as Mamba-2's (S, H, 1, 1) decay against
    (S, H, P, N) states: the bits of eager ``jax.lax.associative_scan``."""
    rng = np.random.default_rng(n)
    a = rng.uniform(0.5, 1.0, (n, *shape_a)).astype(np.float32)
    shape_b = (n, 4, 2, 3) if len(shape_a) == 3 else (n, *shape_a)
    b = rng.standard_normal(shape_b).astype(np.float32)
    jb = jax.lax.associative_scan(
        _pair, (jnp.broadcast_to(jnp.asarray(a), shape_b), jnp.asarray(b)))[1]
    ta, tb = associative_scan(lambda l, r: list(_pair(l, r)),
                              [torch.from_numpy(a), torch.from_numpy(b)])
    assert tuple(ta.shape) == a.shape
    assert np.array_equal(tb.numpy(), np.asarray(jb))


_PARAMS = {}


def _mamba(bits: int = 0):
    """(JAX cfg, port cfg, JAX params, port params): the JAX package's
    ``init_params`` draws; ``bits`` 4 or 8 at GROUP."""
    if bits not in _PARAMS:
        cfg = jmamba.MambaConfig.test()._replace(vocab_size=VOCAB)
        p = jmamba.init_params(cfg, 0)
        if bits:
            p = jmamba.quantize_params(p, bits=bits, group=GROUP)
        _PARAMS[bits] = (cfg, tmamba.MambaConfig(**cfg._asdict()), p,
                         params_from_jax(p, CPU))
    return _PARAMS[bits]


def _mamba2_state(cfg, seed: int = 0, bias: bool = False):
    """A transformers Mamba2 state dict at ``cfg``'s widths."""
    rng = np.random.default_rng(seed)

    def R(*s, scale=0.1):
        return (rng.standard_normal(s) * scale).astype(np.float32)

    st = {"backbone.embeddings.weight": R(cfg.vocab_size, cfg.dim),
          "backbone.norm_f.weight": 1.0 + R(cfg.dim)}
    proj = cfg.d_inner + cfg.conv_dim + cfg.n_heads
    for i in range(cfg.n_layers):
        p = f"backbone.layers.{i}.mixer."
        st[f"backbone.layers.{i}.norm.weight"] = 1.0 + R(cfg.dim)
        st[p + "in_proj.weight"] = R(proj, cfg.dim)
        if bias:
            st[p + "in_proj.bias"] = R(proj)
        st[p + "conv1d.weight"] = R(cfg.conv_dim, 1, cfg.d_conv, scale=0.2)
        st[p + "conv1d.bias"] = R(cfg.conv_dim)
        st[p + "dt_bias"] = R(cfg.n_heads) - 1.0
        st[p + "A_log"] = np.log(rng.uniform(0.5, 4.0, cfg.n_heads)
                                 ).astype(np.float32)
        st[p + "D"] = 1.0 + R(cfg.n_heads)
        st[p + "norm.weight"] = 1.0 + R(cfg.d_inner)
        st[p + "out_proj.weight"] = R(cfg.dim, cfg.d_inner)
    return st


def _mamba2():
    if "m2" not in _PARAMS:
        cfg = jmamba2.Mamba2Config.test()._replace(vocab_size=VOCAB)
        jp, jc = jconv.mamba2_from_hf(_mamba2_state(cfg), n_groups=2,
                                      max_seq=64)
        _PARAMS["m2"] = (jc, tmamba2.Mamba2Config(**jc._asdict()), jp,
                         params_from_jax(jp, CPU))
    return _PARAMS["m2"]


@pytest.mark.parametrize("kind,bits", [("mamba", 0), ("mamba", 4),
                                       ("mamba", 8), ("mamba2", 0)])
def test_forward_matches_jax(kind, bits):
    """Bucket-64 prefill of 40 tokens, three decode steps, a 16-token
    extend with 7 valid and (Mamba) four chunked greedy steps: logits to
    1e-5 rel L2, and the recurrent state after each."""
    if kind == "mamba":
        cfg, tcfg, jp, tp = _mamba(bits)
        jm, tm, jcache, tcache = (jmamba, tmamba, jmamba.MambaCache,
                                  tmamba.MambaCache)
    else:
        cfg, tcfg, jp, tp = _mamba2()
        jm, tm, jcache, tcache = (jmamba2, tmamba2, jmamba2.Mamba2Cache,
                                  tmamba2.Mamba2Cache)
    toks = _tokens(1, 64)
    jl, jc = jm.prefill(jp, cfg, jnp.asarray(toks, jnp.int32), jnp.int32(40),
                        jcache.create(cfg))
    tl, tc = tm.prefill(tp, tcfg, _t(toks), 40, tcache.create(tcfg,
                                                              device=CPU))
    assert _rel(tl, jl) < REL and _rel(tc.ssm, jc.ssm) < REL
    for tok in (5, 200, 17):
        jl, jc = jm.decode_step(jp, cfg, jnp.int32(tok), jc)
        tl, tc = tm.decode_step(tp, tcfg, tok, tc)
        assert _rel(tl, jl) < REL
    chunk = np.zeros(16, np.int64)
    chunk[:7] = _tokens(2, 7)
    jl, jc = jm.extend(jp, cfg, jnp.asarray(chunk, jnp.int32), jnp.int32(7),
                       jc)
    tl, tc = tm.extend(tp, tcfg, _t(chunk), 7, tc)
    assert _rel(tl, jl) < REL and tc.length == int(jc.length) == 50
    assert _rel(tc.ssm, jc.ssm) < REL and _rel(tc.conv, jc.conv) < REL
    if kind == "mamba":
        jt, jl, jc = jm.decode_chunk_greedy(jp, cfg, jl, jc, 4)
        tt, tl, tc = tm.decode_chunk_greedy(tp, tcfg, tl, tc, 4)
        assert tt.tolist() == np.asarray(jt).tolist()
        assert _rel(tl, jl) < REL and tc.length == 54


def test_batched_step_matches_single_and_jax():
    """Two prompts in slots 0 and 2 of three (slot 1 inactive): the batched
    steps give each slot its single step's logits (1e-6) and the JAX
    package's batched logits (1e-5); the inactive slot's state stays."""
    cfg, tcfg, jp, tp = _mamba()
    bc = tmamba.BatchedMambaCache.create(tcfg, 3, torch.float32, device=CPU)
    jbc = jmamba.BatchedMambaCache.create(cfg, 3, dtype=jnp.float32)
    singles = []
    for slot, (seed, n) in zip((0, 2), ((3, 30), (4, 45))):
        toks = _tokens(seed, 64)
        _, c = tmamba.prefill(tp, tcfg, _t(toks), n,
                              tmamba.MambaCache.create(tcfg, device=CPU))
        bc = tmamba.insert_sequence(bc, tcfg, slot, c)
        singles.append(c)
        _, jc = jmamba.prefill(jp, cfg, jnp.asarray(toks, jnp.int32),
                               jnp.int32(n), jmamba.MambaCache.create(cfg))
        jbc = jmamba.insert_sequence(jbc, cfg, slot, jc)
    active = torch.tensor([True, False, True])
    before = bc.ssm[:, 1].clone()
    for tok in ([7, 0, 9], [100, 0, 3]):
        lg, bc = tmamba.decode_step_batch(tp, tcfg, torch.tensor(tok),
                                          active, bc)
        jlg, jbc = jmamba.decode_step_batch(
            jp, cfg, jnp.asarray(tok, jnp.int32),
            jnp.asarray(active.numpy()), jbc)
        assert _rel(lg, jlg) < REL
        for row, slot in enumerate((0, 2)):
            sl, singles[row] = tmamba.decode_step(tp, tcfg, tok[slot],
                                                  singles[row])
            np.testing.assert_allclose(lg[slot].numpy(), sl.numpy(),
                                       rtol=0, atol=1e-6)
    assert bc.lengths.tolist() == [32, 0, 47]
    assert torch.equal(bc.ssm[:, 1], before)
    prod, _ = tmamba.decode_steps_batch(tp, tcfg, torch.tensor([1, 0, 2]),
                                        active, bc, 3)
    jprod, _ = jmamba.decode_steps_batch(
        jp, cfg, jnp.asarray([1, 0, 2], jnp.int32),
        jnp.asarray(active.numpy()), jbc, 3)
    assert prod[:, [0, 2]].tolist() == np.asarray(jprod)[:, [0, 2]].tolist()


@pytest.mark.parametrize("kind", ["mamba", "mamba2"])
def test_runner_matches_the_jax_runner(kind):
    """MambaRunner (the module chosen by the config's type) greedy over a
    prompt longer than a chunk (prefill then extend), and after a tool
    response: the JAX runner's text and ids."""
    cfg, tcfg, jp, tp = _mamba() if kind == "mamba" else _mamba2()
    gen = dict(max_tokens=12, temperature=0.0)
    jr = jmamba.MambaRunner(jp, cfg, gen_config=JGen(**gen))
    tr = tmamba.MambaRunner(tp, tcfg, gen_config=GenerationConfig(**gen))
    jr.CHUNK = tr.CHUNK = 16   # the prompt spans several chunks
    assert tr._m is (tmamba if kind == "mamba" else tmamba2)
    prompt = tr.build_prompt("sys", "ctx", "what is ahead?")
    assert prompt == jr.build_prompt("sys", "ctx", "what is ahead?")
    assert tr.generate(prompt) == jr.generate(prompt)
    assert tr.generated_ids == list(jr._generated_ids)
    jr.add_tool_response("go", {"ok": True})
    tr.add_tool_response("go", {"ok": True})
    assert _rel(tr.cache.ssm, jr.cache.ssm) < REL
    assert tr.cache.length == int(jr.cache.length)
    with pytest.raises(NotImplementedError):
        tr.generate("x", force_tool_call=True)


def test_server_serves_mamba_and_refuses_the_pool():
    """LLMServer(model=mamba) on dense state slots: three greedy requests
    give the MambaRunner's ids, per step and in chunks; paged and int8
    caches are refused."""
    cfg, tcfg, jp, tp = _mamba()
    prompts = ["abc abc abc", "describe the scene", "is the path clear?"]
    want = []
    for p in prompts:
        r = tmamba.MambaRunner(tp, tcfg, gen_config=GenerationConfig(
            max_tokens=10, temperature=0.0))
        want.append(r.generate(p))
    for chunk in (1, 4):
        server = LLMServer(tp, tcfg, batch_slots=2,
                           cache_dtype=torch.float32, model=tmamba,
                           chunk_steps=chunk, device=CPU)
        try:
            futs = [server.submit(p, max_tokens=10) for p in prompts]
            assert [f.result(TIMEOUT) for f in futs] == want
        finally:
            server.close()
    with pytest.raises(TrackieError, match="paged KV supports the default"):
        LLMServer(tp, tcfg, model=tmamba, paged=True, device=CPU)
    with pytest.raises(TrackieError, match="int8 KV requires paged mode"):
        LLMServer(tp, tcfg, model=tmamba, cache_dtype=torch.int8,
                  device=CPU)


def _same_tree(got, want):
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
        g, w = g.view(torch.int16).numpy().view(np.uint16), w.view(np.uint16)
    else:
        g = g.numpy()
    assert g.dtype == w.dtype and g.shape == w.shape
    assert np.array_equal(g, w)


@pytest.mark.parametrize("route", ["mamba_hf", "mamba2_hf", "mamba2_bias"])
def test_hf_converters_give_the_jax_bytes(route):
    """mamba_from_hf and mamba2_from_hf (with and without in_proj's bias)
    on state dicts made here: the JAX converters' config and bytes."""
    if route == "mamba_hf":
        cfg = jmamba.MambaConfig.test()
        state = jmamba_tests.TestMambaGGUF()._hf_state(cfg, seed=3)
        jp, jc = jconv.mamba_from_hf(state, max_seq=64)
        tp, tc = tconv.mamba_from_hf(state, max_seq=64, device=CPU)
    else:
        cfg = jmamba2.Mamba2Config.test()
        state = _mamba2_state(cfg, 5, bias=route == "mamba2_bias")
        jp, jc = jconv.mamba2_from_hf(state, n_groups=2,
                                      dt_limit=(0.0, 10.0))
        tp, tc = tconv.mamba2_from_hf(state, n_groups=2,
                                      dt_limit=(0.0, 10.0), device=CPU)
    assert tc._asdict() == jc._asdict()
    _same_tree(tp, jp)


@pytest.mark.parametrize("bits", [None, 4, 8])
def test_gguf_route_gives_the_jax_bytes(tmp_path, bits):
    """A mamba GGUF written here (llama.cpp's squeezed conv and
    ssm_a = -exp(A_log)) through gguf_to_mamba_params and
    gguf_convert_auto: the JAX route's config and bytes; a positive ssm_a
    is refused."""
    cfg = jmamba.MambaConfig.test()
    helper = jmamba_tests.TestMambaGGUF()
    path = str(tmp_path / "m.gguf")
    helper._write(path, cfg, helper._hf_state(cfg, seed=1))
    jp, jc = jconv.gguf_to_mamba_params(path, bits=bits, group=GROUP)
    tp, tc = tconv.gguf_to_mamba_params(path, bits=bits, group=GROUP,
                                        device=CPU)
    assert tc._asdict() == jc._asdict()
    _same_tree(tp, jp)
    if bits is None:
        ap, _ = tconv.gguf_convert_auto(path, device=CPU)
        _same_tree(ap, jconv.gguf_convert_auto(path)[0])
        bad = str(tmp_path / "bad.gguf")
        helper._write(bad, cfg, helper._hf_state(cfg), flip_a_sign=True)
        with pytest.raises(TrackieError, match="ssm_a"):
            tconv.gguf_to_mamba_params(bad, device=CPU)


@pytest.mark.parametrize("kind", ["mamba_q4", "mamba2"])
def test_checkpoint_round_trips_both_ways(tmp_path, kind):
    """Mamba (Q4) and Mamba-2 trees with their configs: each package loads
    the other's checkpoint, bytes and config equal; Mamba-2's dt_limit
    comes back a tuple."""
    cfg, tcfg, jp, tp = _mamba(4) if kind == "mamba_q4" else _mamba2()
    jckpt.save_checkpoint(str(tmp_path / "j"), jp, config=cfg)
    got, gcfg, _ = tckpt.load_checkpoint(str(tmp_path / "j"), device=CPU)
    assert gcfg == tcfg and type(gcfg) is type(tcfg)
    if kind == "mamba2":
        assert isinstance(gcfg.dt_limit, tuple)
    _same_tree(got, jp)
    tckpt.save_checkpoint(str(tmp_path / "t"), tp, config=tcfg)
    back, bcfg, _ = jckpt.load_checkpoint(str(tmp_path / "t"))
    assert bcfg == cfg
    _same_tree(tp, back)


def _generated(main, ck, extra, capsys):
    assert main(["generate", ck, "-p", "abc", "--max-tokens", "8",
                 "--temperature", "0", *extra]) == 0
    return capsys.readouterr().out.splitlines()[-1]


@pytest.mark.parametrize("route", ["gguf_q8", "mamba2_hf"])
def test_cli_convert_and_generate_match_jax(tmp_path, capsys, route):
    """Both CLIs: a mamba GGUF through ``inspect``, ``convert --bits 8``
    and ``generate``, and a Mamba-2 state dict through ``convert --family
    mamba2-hf --bits 0`` and ``generate``: the same arrays and the same
    greedy text."""
    if route == "gguf_q8":
        cfg = jmamba.MambaConfig.test()._replace(dim=256, d_inner=512,
                                                 vocab_size=VOCAB)
        helper = jmamba_tests.TestMambaGGUF()
        src = str(tmp_path / "m.gguf")
        helper._write(src, cfg, helper._hf_state(cfg, seed=2))
        argv = ["--bits", "8"]
        assert jcli.main(["inspect", src]) == 0
        want = capsys.readouterr().out
        assert tcli.main(["inspect", src]) == 0
        assert capsys.readouterr().out == want
    else:
        # The CLI's mamba2_from_hf takes the published 8 groups.
        cfg = jmamba2.Mamba2Config.test()._replace(vocab_size=VOCAB,
                                                   n_groups=8, n_heads=8)
        src = str(tmp_path / "m2.npz")
        np.savez(src, **_mamba2_state(cfg, 6))
        argv = ["--family", "mamba2-hf", "--bits", "0"]
    out = {}
    for name, main, extra in (("j", jcli.main, []),
                              ("t", tcli.main, ["--device", "cpu"])):
        ck = str(tmp_path / name)
        assert main(["convert", src, "-o", ck, *argv, *extra]) == 0
        capsys.readouterr()
        out[name] = _generated(main, ck, extra, capsys)
    assert out["t"] == out["j"]
    with np.load(tmp_path / "j" / "arrays.npz") as a, \
            np.load(tmp_path / "t" / "arrays.npz") as b:
        assert set(a.files) == set(b.files)
        for k in a.files:
            assert np.array_equal(a[k], b[k]), k


def test_init_params_quantized_has_quantize_params_layout():
    """The card-side quantized initializer gives quantize_params' tree, and
    init_params draws the JAX package's values from the same seed."""
    cfg = tmamba.MambaConfig.test()
    jp = jmamba.init_params(jmamba.MambaConfig.test(), 0)
    tp = tmamba.init_params(cfg, 0, device=CPU)
    _same_tree(tp, jp)
    want = tmamba.quantize_params(tp, bits=4, group=GROUP)
    got = tmamba.init_params_quantized(torch.Generator().manual_seed(0), cfg,
                                       bits=4, group=GROUP,
                                       dtype=torch.float32, device=CPU)

    def shapes(t):
        if isinstance(t, dict):
            return {k: shapes(v) for k, v in t.items()}
        if isinstance(t, QuantizedLinear):
            return ("q", shapes(t.values), shapes(t.scales))
        return (tuple(t.shape), t.dtype)
    assert shapes(got) == shapes(want)


def test_cli_mamba_hf_bits_quantize_the_mixer(tmp_path, capsys):
    """``convert --family mamba-hf --bits 4``: the port quantizes w_in, w_x,
    w_out and lm_head (``mamba.quantize_params``, as the mamba GGUF route
    of both packages does); the JAX CLI hands a Mamba tree to
    ``llm.quantize_params``, which finds none of its names and quantizes
    lm_head alone (ROADMAP Queue 3). Both checkpoints generate."""
    cfg = jmamba.MambaConfig.test()._replace(dim=512, d_inner=512,
                                             vocab_size=VOCAB)
    src = str(tmp_path / "m.npz")
    np.savez(src, **jmamba_tests.TestMambaGGUF()._hf_state(cfg, seed=4))
    trees = {}
    for name, main, extra in (("j", jcli.main, []),
                              ("t", tcli.main, ["--device", "cpu"])):
        ck = str(tmp_path / name)
        assert main(["convert", src, "-o", ck, "--family", "mamba-hf",
                     "--bits", "4", *extra]) == 0
        _generated(main, ck, extra, capsys)
        trees[name] = tckpt.load_checkpoint(ck, device=CPU)[0]
    for name in ("w_in", "w_x", "w_out"):
        assert isinstance(trees["t"]["layers"][name], QuantizedLinear)
        assert not isinstance(trees["j"]["layers"][name], QuantizedLinear)
    assert isinstance(trees["j"]["lm_head"], QuantizedLinear)
    _same_tree(trees["t"]["lm_head"], trees["j"]["lm_head"])
