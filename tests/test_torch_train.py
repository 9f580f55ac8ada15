"""The single-device trainer against the JAX package's ``parallel/``.

``tests/test_parallel.py``'s TRAIN_CFG (2 layers, dim 128, vocab 128) in
f32, its family-zoo config (QKV biases, GeGLU, sandwich norms, softcaps,
query scaling, alternating windows), a Gemma-3-like dual-rope config and a
Mixtral-like MoE (4 experts, top 2). JAX params go through
``params_from_jax``; the JAX forwards and train steps run under a
one-device mesh, as ``tests/test_lora.py`` runs them. The JAX package is
imported inside the ``J`` fixture, so the card tests at the end collect on
a host without it:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_train.py
"""

import types

import numpy as np
import pytest
import torch

from trackiellm_tpu_torch.llm.tokenizer import ByteTokenizer
from trackiellm_tpu_torch.models import llm as tllm
from trackiellm_tpu_torch.models.bridge import params_from_jax
from trackiellm_tpu_torch.parallel import data as tdata
from trackiellm_tpu_torch.parallel import layers as tlayers
from trackiellm_tpu_torch.parallel import train as ttrain
from trackiellm_tpu_torch.parallel.evaluate import evaluate_perplexity
from trackiellm_tpu_torch.utils.errors import TrackieError

TRAIN = dict(vocab_size=128, dim=128, n_layers=2, n_heads=4, n_kv_heads=2,
             head_dim=32, hidden_dim=256, max_seq=64, sliding_window=64)
CONFIGS = {
    "plain": TRAIN,
    "zoo": {**TRAIN, "qkv_bias": True, "act": "gelu", "post_norms": True,
            "attn_softcap": 50.0, "logit_softcap": 30.0,
            "query_pre_attn_scalar": 48.0, "sliding_window": 16,
            "alt_window": True},
    "gemma3": {**TRAIN, "act": "gelu", "post_norms": True, "qk_norm": True,
               "query_pre_attn_scalar": 32.0, "sliding_window": 16,
               "window_pattern": 2, "rope_local_theta": 10000.0},
    "moe": {**TRAIN, "n_experts": 4, "n_experts_used": 2},
}
BATCH = np.stack([np.arange(32, dtype=np.int32) % 128,
                  (np.arange(32, dtype=np.int32) * 7 + 3) % 128])
STEPS = 5
LR = 3e-3


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

    from trackiellm_tpu.llm.tokenizer import ByteTokenizer as JTok
    from trackiellm_tpu.models import llm
    from trackiellm_tpu.parallel import data, evaluate, layers, train
    from trackiellm_tpu.parallel.mesh import build_mesh
    return types.SimpleNamespace(jax=jax, jnp=jnp, llm=llm, train=train,
                                 data=data, evaluate=evaluate, layers=layers,
                                 build_mesh=build_mesh, Tok=JTok)


def _cfgs(J, name):
    fields = CONFIGS[name]
    return J.llm.LLMConfig(**fields), tllm.LLMConfig(**fields)


@pytest.fixture(scope="module")
def jparams(J):
    """name -> JAX f32 params (numpy leaves)."""
    return {name: J.jax.tree.map(np.asarray, J.llm.init_params(
        J.jax.random.PRNGKey(i + 1), _cfgs(J, name)[0], dtype=J.jnp.float32))
        for i, name in enumerate(CONFIGS)}


def _rel_l2(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _trainable(tree):
    params = params_from_jax(tree)
    for t in ttrain.param_leaves(params):
        t.requires_grad_()
    return params


# -- the forward -------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_forwards(J, jparams):
    """name -> (logits, hidden, aux) of the JAX forward on BATCH."""
    out = {}
    with J.build_mesh(J.jax.devices()[:1]):
        for name in CONFIGS:
            cfg = _cfgs(J, name)[0]
            logits, aux = J.train.lm_forward_batched(
                jparams[name], cfg, J.jnp.asarray(BATCH))
            hidden, _ = J.train.lm_forward_batched(
                jparams[name], cfg, J.jnp.asarray(BATCH), return_hidden=True)
            out[name] = (np.asarray(logits), np.asarray(hidden),
                         None if aux is None else
                         [np.asarray(a) for a in aux])
    return out


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_forward_matches_jax(J, jparams, jax_forwards, name):
    """Logits and final-norm hidden states within 1e-5 rel L2; the MoE
    router's probabilities within 1e-5, its top-k weights on the same
    experts, and the load-balancing loss equal to 1e-6."""
    logits, hidden, aux = jax_forwards[name]
    cfg = _cfgs(J, name)[1]
    params = params_from_jax(jparams[name])
    with torch.no_grad():
        got, got_aux = ttrain.lm_forward_batched(params, cfg,
                                                 torch.from_numpy(BATCH))
        got_hidden, _ = ttrain.lm_forward_batched(
            params, cfg, torch.from_numpy(BATCH), return_hidden=True)
    assert got.shape == logits.shape and got.dtype == torch.float32
    assert _rel_l2(got, logits) <= 1e-5
    assert _rel_l2(got_hidden, hidden) <= 1e-5
    if aux is None:
        assert got_aux is None
        return
    probs, weights = (a.numpy() for a in got_aux)
    assert probs.shape == aux[0].shape == (2, 64, 4)
    assert _rel_l2(probs, aux[0]) <= 1e-5
    assert np.array_equal(weights > 0, aux[1] > 0)
    assert _rel_l2(weights, aux[1]) <= 1e-5
    want = float(J.train.moe_load_balancing_loss(
        tuple(J.jnp.asarray(a) for a in aux), _cfgs(J, name)[0]))
    got_bal = float(ttrain.moe_load_balancing_loss(got_aux, cfg))
    assert abs(got_bal - want) <= 1e-6


@pytest.mark.parametrize("name", ["plain", "zoo", "gemma3"])
def test_forward_rows_match_the_inference_prefill(jparams, name):
    """The exactness contract of parallel/layers.py: a row of the batched
    forward is the inference prefill's logits (1e-5)."""
    cfg = tllm.LLMConfig(**CONFIGS[name])
    params = params_from_jax(jparams[name])
    toks = torch.from_numpy(BATCH[1, :12].copy())
    with torch.no_grad():
        logits, _ = ttrain.lm_forward_batched(params, cfg, toks[None])
    cache = tllm.KVCache.create(cfg, dtype=torch.float32, device="cpu")
    want, _ = tllm.prefill(params, cfg, toks, 12, cache)
    np.testing.assert_allclose(logits[0, 11].numpy(), want.numpy(),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", ["plain", "zoo", "gemma3"])
def test_masks_and_windows_match_jax(J, name):
    """layer_windows and causal_mask per layer, as the JAX functions give
    them."""
    jcfg, cfg = _cfgs(J, name)
    pos = np.arange(40)
    for li in range(4):
        assert tlayers.layer_windows(cfg, li) == int(
            J.layers.layer_windows(jcfg, li))
        got = tlayers.causal_mask(cfg, li, torch.from_numpy(pos),
                                  torch.from_numpy(pos))
        want = J.layers.causal_mask(jcfg, li, J.jnp.asarray(pos),
                                    J.jnp.asarray(pos))
        assert np.array_equal(got.numpy(), np.asarray(want))


def test_moe_aux_loss_uniform_is_one():
    cfg = tllm.LLMConfig(**CONFIGS["moe"])
    t, e = 64, 4
    probs = torch.full((2, t, e), 1.0 / e)
    w = torch.zeros((2, t, e))
    for i in range(t):
        w[:, i, i % e] = 0.5
        w[:, i, (i + 1) % e] = 0.5
    val = float(ttrain.moe_load_balancing_loss((probs, w), cfg))
    np.testing.assert_allclose(val, 1.0, rtol=1e-6)


def test_what_needs_a_mesh_raises_and_sequence_parallel_is_a_no_op(jparams):
    """mesh=, expert_parallel and the vocab-parallel functions raise naming
    ID 12; sequence_parallel gives the same loss; the inference-only layer
    kinds are refused as the reference refuses them."""
    cfg = tllm.LLMConfig(**TRAIN)
    params = params_from_jax(jparams["plain"])
    toks = torch.from_numpy(BATCH)
    for call in (
            lambda: ttrain.lm_loss(params, cfg, toks, mesh=object()),
            lambda: ttrain.lm_loss(params, cfg, toks, expert_parallel=True),
            lambda: ttrain.make_train_step(cfg, mesh=object()),
            lambda: ttrain.init_train_state(torch.Generator(), cfg,
                                            mesh=object()),
            lambda: ttrain.vocab_parallel_embed(None, toks, object()),
            lambda: ttrain.vocab_parallel_ce(None, None, toks, object())):
        with pytest.raises(NotImplementedError, match="ID 12"):
            call()
    with torch.no_grad():
        assert float(ttrain.lm_loss(params, cfg, toks)) == float(
            ttrain.lm_loss(params, cfg, toks, sequence_parallel=True))
    for knob in ({"parallel_residual": True}, {"attn_chunk": 16}):
        with pytest.raises(NotImplementedError, match="inference-only"):
            ttrain.lm_loss(params, cfg._replace(**knob), toks)


# -- the train step ----------------------------------------------------------

@pytest.fixture(scope="module")
def jax_train(J, jparams):
    """name -> the losses of STEPS JAX AdamW steps (make_train_step at LR)
    from jparams[name]."""
    out = {}
    mesh = J.build_mesh(J.jax.devices()[:1])
    with mesh:
        for name in ("plain", "moe"):
            cfg = _cfgs(J, name)[0]
            params = J.jax.tree.map(J.jnp.asarray, jparams[name])
            opt = J.train.make_optimizer(LR)
            state = opt.init(params)
            step = J.train.make_train_step(cfg, mesh, opt)
            losses = []
            for _ in range(STEPS):
                params, state, loss = step(params, state,
                                           J.jnp.asarray(BATCH))
                losses.append(float(loss))
            out[name] = losses
    return out


@pytest.mark.parametrize("name", ["plain", "moe"])
def test_adamw_steps_track_jax(J, jparams, jax_train, name):
    """STEPS steps of make_train_step under make_optimizer's AdamW: each
    loss within 1e-4 rel of the JAX step's (optax.adamw), and falling."""
    cfg = _cfgs(J, name)[1]
    params = _trainable(jparams[name])
    opt_state = ttrain.make_optimizer(LR)(ttrain.param_leaves(params))
    step = ttrain.make_train_step(cfg)
    got = []
    for _ in range(STEPS):
        params, opt_state, loss = step(params, opt_state,
                                       torch.from_numpy(BATCH))
        got.append(float(loss))
    np.testing.assert_allclose(got, jax_train[name], rtol=1e-4)
    assert got[-1] < got[0]


def test_optimizer_is_optax_adamw():
    """make_optimizer: optax.adamw's defaults (b1 0.9, b2 0.95, eps 1e-8,
    weight decay 0.01) on every leaf."""
    opt = ttrain.make_optimizer(5e-4)([torch.zeros(3, requires_grad=True)])
    group = opt.param_groups[0]
    assert isinstance(opt, torch.optim.AdamW)
    assert (group["lr"], group["betas"], group["eps"],
            group["weight_decay"]) == (5e-4, (0.9, 0.95), 1e-8, 0.01)


def test_init_train_state_on_the_generator_device():
    cfg = tllm.LLMConfig(**TRAIN)
    params, opt_state, opt = ttrain.init_train_state(
        torch.Generator().manual_seed(0), cfg, lr=LR)
    leaves = ttrain.param_leaves(params)
    assert all(t.requires_grad and t.is_leaf and t.device.type == "cpu"
               for t in leaves)
    assert len(opt_state.param_groups[0]["params"]) == len(leaves)
    assert opt_state.param_groups[0]["lr"] == LR


def test_save_restore_round_trip(tmp_path):
    """save_train_state/restore_train_state: params, the optimizer's
    moments and the step survive, and the next step's loss equals the
    original trajectory's; a file of another config is refused."""
    cfg = tllm.LLMConfig(**TRAIN)
    params, opt_state, _ = ttrain.init_train_state(
        torch.Generator().manual_seed(7), cfg, lr=LR)
    step = ttrain.make_train_step(cfg)
    toks = torch.from_numpy(BATCH)
    for _ in range(3):
        params, opt_state, _ = step(params, opt_state, toks)
    path = str(tmp_path / "state.pt")
    ttrain.save_train_state(path, params, opt_state, step=3)
    p2, o2, opt2, at = ttrain.restore_train_state(path, cfg)
    assert at == 3 and o2.param_groups[0]["lr"] == LR
    assert opt2([torch.zeros(1, requires_grad=True)]).param_groups[0][
        "lr"] == LR
    for a, b in zip(ttrain.param_leaves(params), ttrain.param_leaves(p2)):
        assert torch.equal(a.detach(), b.detach()) and b.requires_grad
    _, _, loss2 = step(p2, o2, toks)
    _, _, loss = step(params, opt_state, toks)
    assert float(loss2) == float(loss)
    with pytest.raises(ValueError, match="tok_emb"):
        ttrain.restore_train_state(path, cfg._replace(vocab_size=96))


# -- perplexity and data -----------------------------------------------------

def _docs():
    return ["abcdefgh" * 40, "hello world " * 9,
            "".join(chr(33 + i % 90) for i in range(700))]


def test_packed_dataset_and_batches_match_jax(J):
    """Rows and every shuffled batch byte-equal to the JAX package's."""
    want = J.data.PackedDataset(_docs(), J.Tok(128), seq_len=32)
    got = tdata.PackedDataset(_docs(), ByteTokenizer(128), seq_len=32)
    assert got.rows.dtype == np.int32 and len(got) == len(want) >= 30
    assert np.array_equal(got.rows, want.rows)
    for seed, drop in ((0, True), (3, True), (3, False)):
        a = list(got.batches(4, seed=seed, drop_remainder=drop))
        b = list(want.batches(4, seed=seed, drop_remainder=drop))
        assert len(a) == len(b)
        assert all(np.array_equal(x, y) for x, y in zip(a, b))


def test_prefetch_iterator_on_the_cpu(monkeypatch):
    src = [np.full((2, 4), i, np.int32) for i in range(3)]
    out = list(tdata.PrefetchIterator(iter(src), device="cpu"))
    assert len(out) == 3 and all(isinstance(t, torch.Tensor) for t in out)
    assert int(out[2][0, 0]) == 2 and out[0].dtype == torch.int32
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(TrackieError):
        tdata.PrefetchIterator(iter(src))


def test_evaluate_perplexity_matches_jax(J, jparams):
    """The mean NLL and perplexity over packed batches, within 1e-5 rel,
    from numpy batches and from prefetched tensors alike."""
    ds = tdata.PackedDataset(_docs(), ByteTokenizer(128), seq_len=32)
    # The byte tokenizer's EOS (257) is past this vocabulary: fold it in.
    batches = [b % 128 for b in ds.batches(2, seed=1)]
    jcfg, cfg = _cfgs(J, "moe")
    with J.build_mesh(J.jax.devices()[:1]):
        want = J.evaluate.evaluate_perplexity(
            J.jax.tree.map(J.jnp.asarray, jparams["moe"]), jcfg, batches)
    params = params_from_jax(jparams["moe"])
    got = evaluate_perplexity(params, cfg, batches)
    assert got["batches"] == want["batches"] == len(batches)
    np.testing.assert_allclose(got["nll"], want["nll"], rtol=1e-5)
    np.testing.assert_allclose(got["perplexity"], want["perplexity"],
                               rtol=1e-5)
    again = evaluate_perplexity(
        params, cfg, tdata.PrefetchIterator(iter(batches), device="cpu"))
    assert again == got
    assert evaluate_perplexity(params, cfg, [])["batches"] == 0


# -- on the card ---------------------------------------------------------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["plain", "moe"])
def test_train_steps_on_the_card_match_the_cpu(dev, name):
    """Two AdamW steps of make_train_step in f32 on the card and on the
    CPU from the same params: losses within 1e-5 rel."""
    cfg = tllm.LLMConfig(**CONFIGS[name])

    def run(device):
        params = tllm.params_to(tllm.init_params(
            torch.Generator().manual_seed(3), cfg, dtype=torch.float32),
            device)
        for t in ttrain.param_leaves(params):
            t.requires_grad_()
        opt_state = ttrain.make_optimizer(LR)(ttrain.param_leaves(params))
        step = ttrain.make_train_step(cfg)
        toks = torch.from_numpy(BATCH).to(device)
        return [float(step(params, opt_state, toks)[2]) for _ in range(2)]
    np.testing.assert_allclose(run(dev), run(torch.device("cpu")),
                               rtol=1e-5)


@pytest.mark.cuda
def test_bf16_train_step_on_the_card(dev):
    """bf16 dense params on the card: every projection reads the weight as
    stored through _mm_f32's Function, every leaf gets a gradient, and the
    loss falls over three steps."""
    cfg = tllm.LLMConfig(**TRAIN)
    params = tllm.init_params(torch.Generator(device=dev).manual_seed(0),
                              cfg, dtype=torch.bfloat16, device=dev)
    leaves = ttrain.param_leaves(params)
    for t in leaves:
        t.requires_grad_()
    opt_state = ttrain.make_optimizer(1e-2)(leaves)
    step = ttrain.make_train_step(cfg)
    toks = torch.from_numpy(BATCH).to(dev)
    losses = [float(step(params, opt_state, toks)[2]) for _ in range(3)]
    assert all(t.grad is not None for t in leaves)
    assert np.isfinite(losses).all() and losses[-1] < losses[0]


@pytest.mark.cuda
def test_prefetch_iterator_on_the_card(dev):
    """Batches reach the card (pinned, asynchronous), equal to the host's."""
    src = [np.full((2, 4), i, np.int32) for i in range(3)]
    out = list(tdata.PrefetchIterator(iter(src)))
    torch.cuda.synchronize()
    assert all(t.is_cuda for t in out)
    assert [int(t[0, 0]) for t in out] == [0, 1, 2]
