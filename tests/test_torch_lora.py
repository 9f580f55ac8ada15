"""LoRA and the gradient through the frozen quantized product, against the
JAX package.

``tests/test_lora.py``'s CFG (2 layers, dim 64, vocab 96) in f32, with
f32, Q8 and Q4 (group 32) bases. The JAX params and adapters go through
``params_from_jax`` and ``lora_from_jax``, so both sides start from the
same bytes. The JAX package is imported inside the ``J`` fixture, so the
card tests at the end collect on a host without it:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_lora.py
"""

import types

import numpy as np
import pytest
import torch

from trackiellm_tpu_torch.llm.runner import GenerationConfig, LLMRunner
from trackiellm_tpu_torch.llm.server import LLMServer
from trackiellm_tpu_torch.llm.tokenizer import ByteTokenizer
from trackiellm_tpu_torch.models import llm as tllm
from trackiellm_tpu_torch.models import lora as tlora
from trackiellm_tpu_torch.models.bridge import lora_from_jax, params_from_jax
from trackiellm_tpu_torch.ops import quant as tq
from trackiellm_tpu_torch.parallel import train as ttrain

CFG_FIELDS = dict(vocab_size=96, dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
                  head_dim=16, hidden_dim=128, max_seq=64, sliding_window=64)
TCFG = tllm.LLMConfig(**CFG_FIELDS)
GROUP = 32
RANK = 4
BATCH = np.tile(np.arange(32, dtype=np.int32) % 96, (2, 1))
STEPS = 10
BASES = ("f32", "q8", "q4")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes: one intra-op thread, so this file does not crowd the
    other test workers' CPUs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def J():
    """The JAX package's modules (imported here, not at collection)."""
    import jax
    import jax.numpy as jnp
    import optax

    from trackiellm_tpu.llm.runner import GenerationConfig as JGen
    from trackiellm_tpu.llm.runner import LLMRunner as JRunner
    from trackiellm_tpu.llm.server import LLMServer as JServer
    from trackiellm_tpu.llm.tokenizer import ByteTokenizer as JTok
    from trackiellm_tpu.models import llm, lora
    from trackiellm_tpu.ops import quant
    from trackiellm_tpu.parallel import train
    from trackiellm_tpu.parallel.mesh import build_mesh
    return types.SimpleNamespace(
        jax=jax, jnp=jnp, optax=optax, llm=llm, lora=lora, quant=quant,
        train=train,
        build_mesh=build_mesh, cfg=llm.LLMConfig(**CFG_FIELDS), Gen=JGen,
        Runner=JRunner, Server=JServer, Tok=JTok)


@pytest.fixture(scope="module")
def bases(J):
    """kind -> (JAX base, port base)."""
    f32 = J.llm.init_params(J.jax.random.PRNGKey(0), J.cfg,
                            dtype=J.jnp.float32)
    out = {}
    for kind in BASES:
        p = f32 if kind == "f32" else J.llm.quantize_params(
            f32, bits=8 if kind == "q8" else 4, group=GROUP)
        out[kind] = (p, params_from_jax(p))
    return out


def _np_tree(J, tree):
    return J.jax.tree.map(np.asarray, tree)


def _adapters(J, base, seed, perturbed):
    """JAX adapters from ``seed``; ``perturbed`` gives B seeded values (so
    A's gradient is not zero)."""
    ad = J.lora.init_lora(J.jax.random.PRNGKey(seed), base, rank=RANK)
    if perturbed:
        rng = np.random.default_rng(seed)
        for name in J.lora.DEFAULT_TARGETS:
            b = ad[name]["b"]
            ad[name]["b"] = J.jnp.asarray(
                0.05 * rng.standard_normal(b.shape), J.jnp.float32)
    return ad


def _rel_l2(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _graph(t):
    """The names of the autograd nodes behind ``t``."""
    names, todo = set(), [t.grad_fn]
    while todo:
        fn = todo.pop()
        if fn is not None and type(fn).__name__ not in names:
            names.add(type(fn).__name__)
            todo.extend(f for f, _ in fn.next_functions)
    return names


def _port_prefill(params, toks):
    cache = tllm.KVCache.create(TCFG, dtype=torch.float32, device="cpu")
    logits, _ = tllm.prefill(params, TCFG, torch.from_numpy(toks), len(toks),
                             cache)
    return logits.numpy()


def _jax_prefill(J, params, toks):
    cache = J.llm.KVCache.create(J.cfg, dtype=J.jnp.float32)
    logits, _ = J.llm.prefill(params, J.cfg, J.jnp.asarray(toks),
                              J.jnp.int32(len(toks)), cache)
    return np.asarray(logits)


# -- the gradient through the frozen quantized product -----------------------

@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("lead", [(7,), (2, 5)])
def test_quantized_matmul_backward_equals_plain_autograd(bits, lead):
    """quantized_matmul's Function gives x the gradient of the plain
    dequantize-then-matmul (weights frozen), within 1e-6 rel L2."""
    rng = np.random.default_rng(bits)
    w = torch.from_numpy(rng.standard_normal((128, 48)).astype(np.float32))
    qw = (tq.quantize_q4 if bits == 4 else tq.quantize_q8)(w, GROUP)
    x = torch.from_numpy(rng.standard_normal((*lead, 128)).astype(
        np.float32)).requires_grad_()
    dy = torch.from_numpy(rng.standard_normal((*lead, 48)).astype(np.float32))
    y = tq.quantized_matmul(x, qw)
    assert "_QuantizedMatmulFnBackward" in _graph(y)
    (dx,) = torch.autograd.grad(y, x, dy)
    x_plain = x.detach().clone().requires_grad_()
    y_plain = torch.matmul(x_plain, tq.dequantize(qw))
    (dx_plain,) = torch.autograd.grad(y_plain, x_plain, dy)
    assert torch.equal(y.detach(), y_plain.detach())
    assert _rel_l2(dx, dx_plain) <= 1e-6
    assert not qw.values.requires_grad and not qw.scales.requires_grad


def test_quantized_matmul_records_nothing_without_a_gradient():
    """Inference keeps the bare route: no Function, no graph."""
    w = tq.quantize_q4(torch.randn(64, 16, generator=torch.Generator()
                                   .manual_seed(0)), GROUP)
    x = torch.ones((3, 64))
    assert tq.quantized_matmul(x, w).grad_fn is None
    with torch.no_grad():
        assert tq.quantized_matmul(x.requires_grad_(), w).grad_fn is None


# -- LoRA in the forwards ----------------------------------------------------

def test_zero_init_prefill_is_the_base(J, bases):
    """Zero-init adapters leave prefill's logits at the base's (1e-5) and
    at the JAX package's wrapped logits (1e-4)."""
    jb, tb = bases["f32"]
    jad = J.lora.init_lora(J.jax.random.PRNGKey(1), jb, rank=RANK)
    toks = np.arange(8, dtype=np.int32)
    wrapped = tlora.attach_lora(tb, lora_from_jax(_np_tree(J, jad)))
    got = _port_prefill(wrapped, toks)
    np.testing.assert_allclose(got, _port_prefill(tb, toks), rtol=1e-5,
                               atol=1e-5)
    want = _jax_prefill(J, J.lora.attach_lora(jb, jad), toks)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_init_lora_shapes_and_trainable_leaves(bases):
    """init_lora on a Q4 base: A (L, K, r) Gaussian / sqrt(K), B zero, both
    trainable; alpha fixed; an unknown target raises."""
    _, tb = bases["q4"]
    ad = tlora.init_lora(torch.Generator().manual_seed(0), tb, rank=RANK)
    assert ad["wqkv"]["a"].shape == (2, 64, RANK)
    assert ad["w_down"]["a"].shape == (2, 128, RANK)
    assert ad["w_gu"]["b"].shape == (2, RANK, 256)
    assert not ad["wo"]["b"].detach().any()
    assert all(t.requires_grad and t.is_leaf
               for t in tlora.lora_parameters(ad))
    assert len(tlora.lora_parameters(ad)) == 8
    assert float(ad["__alpha__"]) == 16.0
    assert not ad["__alpha__"].requires_grad
    with pytest.raises(KeyError):
        tlora.init_lora(torch.Generator(), tb, targets=("w_nope",))


@pytest.mark.parametrize("bits", [4, 8])
def test_merge_requantizes_to_the_jax_bytes(J, bases, bits):
    """merge_lora over a quantized base at requantize_bits 4 and 8: the
    JAX package's merged weights (its requantize_bits=0), requantized per
    layer by its quantizer at the base's group, byte for byte.

    Not the JAX merge's own requantized bytes: it reads ``group_size`` off
    the stacked (L, K/2, N) base, where the JAX property takes the layer
    count for K, and so requantizes at group 2 (Q4) or 1 (Q8), scales
    (K/2, N) or (K, N) that no kernel of the card takes. The port keeps
    the base's group."""
    jb, tb = bases["q8" if bits == 8 else "q4"]
    jad = _adapters(J, jb, 3, perturbed=True)
    dense = J.lora.merge_lora(jb, jad, requantize_bits=0)
    quant = J.quant.quantize_q4 if bits == 4 else J.quant.quantize_q8
    got = tlora.merge_lora(tb, lora_from_jax(_np_tree(J, jad)),
                           requantize_bits=bits)
    for name in J.lora.DEFAULT_TARGETS:
        g = got["layers"][name]
        assert g.group_size == GROUP
        for i in range(TCFG.n_layers):
            w = quant(dense["layers"][name][i], GROUP)
            assert np.array_equal(g.values[i].numpy(),
                                  np.asarray(w.values)), (name, i)
            assert np.array_equal(g.scales[i].numpy(),
                                  np.asarray(w.scales)), (name, i)


def test_merged_prefill_matches_wrapped(J, bases):
    """Merged (dense f32) and wrapped prefill agree within 1e-4, and the
    port's merged weights are the JAX package's within 1e-6."""
    jb, tb = bases["f32"]
    jad = _adapters(J, jb, 4, perturbed=True)
    tad = lora_from_jax(_np_tree(J, jad))
    merged = tlora.merge_lora(tb, tad)
    toks = np.arange(6, dtype=np.int32)
    np.testing.assert_allclose(
        _port_prefill(merged, toks),
        _port_prefill(tlora.attach_lora(tb, tad), toks), rtol=1e-4,
        atol=1e-4)
    want = J.lora.merge_lora(jb, jad)
    for name in J.lora.DEFAULT_TARGETS:
        np.testing.assert_allclose(merged["layers"][name].numpy(),
                                   np.asarray(want["layers"][name]),
                                   rtol=1e-6, atol=1e-6)


def test_wrapped_model_serves_the_jax_text(J):
    """LLMRunner and LLMServer take attached adapters: greedy text on a
    wrapped Q4 base (CFG with the byte tokenizer's vocab) equals the JAX
    runner's and server's."""
    jcfg = J.cfg._replace(vocab_size=320)
    tcfg = tllm.LLMConfig(**jcfg._asdict())
    jb = J.llm.quantize_params(J.llm.init_params(
        J.jax.random.PRNGKey(6), jcfg, dtype=J.jnp.float32), bits=4,
        group=GROUP)
    jad = _adapters(J, jb, 5, perturbed=True)
    jw = J.lora.attach_lora(jb, jad)
    tw = tlora.attach_lora(params_from_jax(jb),
                           lora_from_jax(_np_tree(J, jad)))
    prompt = "descreva a cena"
    runner = LLMRunner(tw, tcfg, ByteTokenizer(320),
                       GenerationConfig(max_tokens=12, temperature=0.0),
                       cache_dtype=torch.float32)
    jrunner = J.Runner(jw, jcfg, J.Tok(320),
                       J.Gen(max_tokens=12, temperature=0.0),
                       cache_dtype=J.jnp.float32)
    assert runner.generate(prompt) == jrunner.generate(prompt)
    server = LLMServer(tw, tcfg, tokenizer=ByteTokenizer(320),
                       batch_slots=2, cache_dtype=torch.float32)
    jserver = J.Server(jw, jcfg, tokenizer=J.Tok(320), batch_slots=2,
                       cache_dtype=J.jnp.float32)
    try:
        got = server.submit(prompt, max_tokens=9).result(timeout=120)
        want = jserver.submit(prompt, max_tokens=9).result(timeout=120)
    finally:
        server.close()
        jserver.close()
    assert got == want


# -- training ----------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_first_step(J, bases):
    """(kind, perturbed) -> the JAX loss and adapter gradients of one
    step on BATCH."""
    out = {}
    with J.build_mesh(J.jax.devices()[:1]):
        for kind in BASES:
            jb = bases[kind][0]
            for perturbed in (False, True):
                jad = _adapters(J, jb, 2, perturbed)

                def loss_fn(ad, jb=jb):
                    return J.train.lm_loss(J.lora.attach_lora(jb, ad), J.cfg,
                                           J.jnp.asarray(BATCH))
                loss, grads = J.jax.value_and_grad(loss_fn)(jad)
                out[kind, perturbed] = (_np_tree(J, jad), float(loss),
                                        _np_tree(J, grads))
    return out


@pytest.mark.parametrize("perturbed", [False, True],
                         ids=["zero_b", "seeded_b"])
@pytest.mark.parametrize("kind", BASES)
def test_first_step_loss_and_grads_match_jax(bases, jax_first_step, kind,
                                             perturbed):
    """The loss within 1e-6 abs and every adapter gradient within 1e-5 rel
    L2 of JAX's (zero where JAX's is zero: A's, under a zero B)."""
    jad, jloss, jgrads = jax_first_step[kind, perturbed]
    tad = lora_from_jax(jad)
    loss = ttrain.lm_loss(tlora.attach_lora(bases[kind][1], tad), TCFG,
                          torch.from_numpy(BATCH))
    loss.backward()
    assert abs(float(loss.detach()) - jloss) <= 1e-6
    for name in tlora.DEFAULT_TARGETS:
        for leaf in "ab":
            got, want = tad[name][leaf].grad.numpy(), jgrads[name][leaf]
            if not np.any(want):
                assert not np.any(got), (name, leaf)
            else:
                assert _rel_l2(got, want) <= 1e-5, (name, leaf)


@pytest.fixture(scope="module")
def jax_curves(J, bases):
    """kind -> (initial JAX adapters, the losses and final adapters of
    STEPS steps of Adam(1e-2))."""
    out = {}
    opt = J.optax.adam(1e-2)
    with J.build_mesh(J.jax.devices()[:1]):
        for kind in BASES:
            jb = bases[kind][0]
            jad = J.lora.init_lora(J.jax.random.PRNGKey(2), jb, rank=RANK)
            start = _np_tree(J, jad)
            step = J.lora.make_lora_train_step(jb, J.cfg, opt)
            state = opt.init(jad)
            losses = []
            for _ in range(STEPS):
                jad, state, loss = step(jad, state, J.jnp.asarray(BATCH))
                losses.append(float(loss))
            out[kind] = (start, losses, _np_tree(J, jad))
    return out


@pytest.mark.parametrize("kind", BASES)
def test_adam_steps_track_the_jax_losses(bases, jax_curves, kind):
    """STEPS steps of make_lora_train_step under torch.optim.Adam(1e-2):
    each loss within 1e-4 rel of the JAX step's (optax.adam), the last
    below 0.9x the first (as tests/test_lora.py asserts), alpha fixed, the
    base untouched."""
    start, want, _ = jax_curves[kind]
    tb = bases[kind][1]
    before = [t.clone() for t in ttrain.param_leaves(tb)]
    tad = lora_from_jax(start)
    opt = torch.optim.Adam(tlora.lora_parameters(tad), lr=1e-2)
    step = tlora.make_lora_train_step(tb, TCFG)
    got = []
    for _ in range(STEPS):
        tad, opt, loss = step(tad, opt, torch.from_numpy(BATCH))
        assert loss.grad_fn is None
        got.append(float(loss))
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert got[-1] < 0.9 * got[0]
    assert float(tad["__alpha__"]) == 16.0
    assert float(tad["wqkv"]["b"].detach().abs().max()) > 0
    assert all(torch.equal(a, b)
               for a, b in zip(before, ttrain.param_leaves(tb)))


# -- on the card ---------------------------------------------------------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


# rel L2 of the card's dx against the CPU's: both are the same f32 product
# of dy and the dequantized weight, summed in another order.
CARD_GRAD_TOL = 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["w4a8", "f32a", "q8"])
def test_quantized_matmul_gradient_on_the_card(dev, monkeypatch, route):
    """On the card the forward launches the route's kernel (counted), its
    output has a grad_fn, and the backward (on the card) is the CPU's
    within CARD_GRAD_TOL."""
    if route == "f32a":
        monkeypatch.setenv("TRACKIE_Q4_F32A", "1")
    else:
        monkeypatch.delenv("TRACKIE_Q4_F32A", raising=False)
    g = torch.Generator().manual_seed(7)
    w = torch.randn((4096, 1024), generator=g) / 64
    qw = (tq.quantize_q8 if route == "q8" else tq.quantize_q4)(w, 256)
    x = torch.randn((64, 4096), generator=g)
    dy = torch.randn((64, 1024), generator=g)
    wrapper = {"w4a8": tq.q4_matmul_w4a8, "f32a": tq.q4_matmul_f32a,
               "q8": tq.q8_matmul}[route]
    qd = tllm.params_to(qw, dev)
    xd = x.to(dev).requires_grad_()
    before = wrapper.launches
    y = tq.quantized_matmul(xd, qd)
    assert wrapper.launches == before + 1
    assert "_QuantizedMatmulFnBackward" in _graph(y)
    (dx,) = torch.autograd.grad(y, xd, dy.to(dev))
    assert dx.device == xd.device and dx.dtype == torch.float32
    xc = x.clone().requires_grad_()
    (dx_cpu,) = torch.autograd.grad(tq.quantized_matmul(xc, qw), xc, dy)
    assert _rel_l2(dx.float().cpu(), dx_cpu.float()) <= CARD_GRAD_TOL


@pytest.mark.cuda
def test_mm_f32_gradient_on_the_card(dev):
    """torch.mm(..., out_dtype=float32) has no derivative; _mm_f32 on a
    bf16 pair that needs gradients goes through _MmF32Fn, whose grads are
    the f32 products of the CPU's widened pair (bf16-rounded)."""
    g = torch.Generator().manual_seed(8)
    a = torch.randn((32, 256), generator=g).to(torch.bfloat16)
    b = torch.randn((256, 128), generator=g).to(torch.bfloat16)
    dy = torch.randn((32, 128), generator=g)
    with pytest.raises(RuntimeError):
        ad = a.to(dev).requires_grad_()
        torch.mm(ad, b.to(dev), out_dtype=torch.float32).sum().backward()
    ad, bd = a.to(dev).requires_grad_(), b.to(dev).requires_grad_()
    out = tllm._mm_f32(ad, bd)
    assert type(out.grad_fn).__name__ == "_MmF32FnBackward"
    out.backward(dy.to(dev))
    ac, bc = a.clone().requires_grad_(), b.clone().requires_grad_()
    tllm._mm_f32(ac, bc).backward(dy)
    assert _rel_l2(ad.grad.float().cpu(), ac.grad.float()) <= 1e-2
    assert _rel_l2(bd.grad.float().cpu(), bc.grad.float()) <= 1e-2


@pytest.mark.cuda
def test_lora_step_on_the_card_matches_the_cpu(dev, monkeypatch):
    """One LoRA step over a Q4 base on the card (f32a: exact activations,
    as on the CPU): the loss within 1e-5 rel and every adapter gradient
    within 1e-4 rel L2 of the CPU's; W4A8 launches on the default route."""
    cfg = tllm.LLMConfig(**{**CFG_FIELDS, "dim": 512, "hidden_dim": 1024,
                            "n_heads": 8, "head_dim": 64})
    base = tllm.init_params_quantized(torch.Generator().manual_seed(0), cfg,
                                      bits=4, group=256, dtype=torch.float32)
    ad = tlora.init_lora(torch.Generator().manual_seed(1), base, rank=RANK)
    with torch.no_grad():
        for name in tlora.DEFAULT_TARGETS:
            ad[name]["b"].normal_(0, 0.05, generator=torch.Generator()
                                  .manual_seed(2))
    toks = torch.from_numpy(BATCH[:, :16].copy())

    def grads(params, adapters, tokens):
        loss = ttrain.lm_loss(tlora.attach_lora(params, adapters), cfg,
                              tokens)
        loss.backward()
        return float(loss.detach()), [t.grad.float().cpu()
                             for t in tlora.lora_parameters(adapters)]
    cpu_loss, cpu_grads = grads(base, ad, toks)
    card_ad = {k: ({kk: vv.detach().to(dev).requires_grad_()
                    for kk, vv in v.items()} if k != "__alpha__"
                   else v.to(dev)) for k, v in ad.items()}
    monkeypatch.setenv("TRACKIE_Q4_F32A", "1")
    loss, card = grads(tllm.params_to(base, dev), card_ad, toks.to(dev))
    assert abs(loss - cpu_loss) <= 1e-5 * abs(cpu_loss)
    assert max(_rel_l2(a, b) for a, b in zip(card, cpu_grads)) <= 1e-4
    monkeypatch.delenv("TRACKIE_Q4_F32A")
    before = tq.q4_matmul_w4a8.launches
    for t in tlora.lora_parameters(card_ad):
        t.grad = None
    grads(tllm.params_to(base, dev), card_ad, toks.to(dev))
    # forward, the checkpointed recompute: 4 projections a layer, and the
    # head once.
    assert tq.q4_matmul_w4a8.launches - before == 2 * 4 * cfg.n_layers + 1
