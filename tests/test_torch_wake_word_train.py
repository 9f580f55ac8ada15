"""The port's wake-word trainer against the JAX package's on the CPU.

``train_wake_word`` from the same initial weights (the JAX init carried
across by ``hwio_tree_from_jax``) on the same log-mel windows, made by the
JAX tool's keyword and imposter generators and its log-mel; and the port's
twin of ``tools/train_wake_word_default.py``. The JAX package is imported
inside the ``J`` fixture, so the card tests at the end collect on a host
without it:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_wake_word_train.py
"""

import json
import types

import numpy as np
import pytest
import torch

from trackiellm_tpu_torch.audio import wake_word as tww
from trackiellm_tpu_torch.models.bridge import hwio_tree_from_jax
from trackiellm_tpu_torch.tools import train_wake_word_default as ttool

CPU = torch.device("cpu")
N_TRAIN = 8       # keyword/imposter pairs
STEPS = 10
# rel L2 per leaf after STEPS Adam steps. The first step's gradients agree
# to ~1e-6 (test_first_step_gradients_match_jax); Adam normalizes each
# gradient, so a leaf whose gradient sits near f32 noise (out_b's: the
# balanced labels cancel) moves by the full learning rate either way, and
# as ReLUs flip the gap grows: measured 2.1e-5 after 10 steps, 6.3e-5 at
# 20 and 2.6e-3 at 40 (conv2.w), on the CPU.
PARAM_TOL = 1e-4
FIT_STEPS = 150   # the port alone: the spotter learns the windows


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def J():
    """The JAX package's wake word and its tool (imported here)."""
    import jax
    import jax.numpy as jnp

    from tools import train_wake_word_default as jtool
    from trackiellm_tpu.audio import wake_word as jww
    return types.SimpleNamespace(jax=jax, jnp=jnp, ww=jww, tool=jtool)


@pytest.fixture(scope="module")
def trained(J):
    """(initial JAX params, mels, labels, JAX params after STEPS)."""
    rng = np.random.default_rng(0)
    xs, ys = [], []
    for i in range(N_TRAIN):
        xs.append(np.asarray(J.tool.mel(J.tool.keyword(rng))))
        ys.append(1)
        xs.append(np.asarray(J.tool.mel(J.tool.imposter(rng, i % 6))))
        ys.append(0)
    mels, labels = np.stack(xs), np.asarray(ys, np.int32)
    cfg = J.ww.WakeWordConfig()
    start = J.ww.init_wake_word(J.jax.random.PRNGKey(1), cfg)
    done = J.ww.train_wake_word(start, cfg, J.jnp.asarray(mels),
                                J.jnp.asarray(labels), steps=STEPS)
    return (J.jax.tree.map(np.asarray, start), mels, labels,
            J.jax.tree.map(np.asarray, done))


def _rel_l2(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _leaves(params):
    return {f"{k}.{kk}": v for k, lay in params.items()
            for kk, v in (lay.items() if isinstance(lay, dict)
                          else [("", lay)])}


def _bce(scores, labels):
    """train_wake_word's loss: BCE of the scores clipped to [1e-6, 1 -
    1e-6]."""
    s = scores.clamp(1e-6, 1 - 1e-6)
    return -(labels * torch.log(s) + (1 - labels) * torch.log(1 - s)).mean()


def test_first_step_gradients_match_jax(J, trained):
    """The loss within 1e-6 and the gradient of every leaf together within
    1e-5 rel L2 of the JAX package's value_and_grad, at the start."""
    start, mels, labels, _ = trained
    jcfg = J.ww.WakeWordConfig()
    y = J.jnp.asarray(labels, J.jnp.float32)

    def loss_fn(p):
        s = J.jax.vmap(lambda m: J.ww.wake_word_score(p, jcfg, m))(
            J.jnp.asarray(mels))
        s = J.jnp.clip(s, 1e-6, 1 - 1e-6)
        return -J.jnp.mean(y * J.jnp.log(s) + (1 - y) * J.jnp.log(1 - s))
    jloss, jgrads = J.jax.value_and_grad(loss_fn)(
        J.jax.tree.map(J.jnp.asarray, start))
    params = hwio_tree_from_jax(start, CPU)
    leaves = _leaves(params)
    for v in leaves.values():
        v.requires_grad_()
    loss = _bce(tww._scores(params, tww.WakeWordConfig(),
                            torch.from_numpy(mels)),
                torch.from_numpy(labels).float())
    loss.backward()
    assert abs(float(loss.detach()) - float(jloss)) <= 1e-6
    want = _leaves(hwio_tree_from_jax(J.jax.tree.map(np.asarray, jgrads),
                                      CPU))
    got = np.concatenate([leaves[k].grad.numpy().ravel() for k in want])
    assert _rel_l2(got, np.concatenate([v.numpy().ravel()
                                        for v in want.values()])) <= 1e-5


def test_trained_params_track_jax(trained):
    """STEPS full-batch Adam steps: every leaf within PARAM_TOL rel L2 of
    the JAX package's (HWIO back to its layout), the input untouched."""
    start, mels, labels, want = trained
    params = hwio_tree_from_jax(start, CPU)
    before = {k: v.clone() for k, v in _leaves(params).items()}
    got = tww.train_wake_word(params, tww.WakeWordConfig(),
                              torch.from_numpy(mels), labels, steps=STEPS)
    assert all(torch.equal(v, before[k])
               for k, v in _leaves(params).items())
    want_t = _leaves(hwio_tree_from_jax(want, CPU))
    for k, v in _leaves(got).items():
        assert not v.requires_grad
        assert _rel_l2(v, want_t[k]) <= PARAM_TOL, k


def test_training_separates_the_windows(trained):
    """FIT_STEPS steps: the spotter scores the training windows on the
    right side of its sensitivity, but for at most two."""
    start, mels, labels, _ = trained
    cfg = tww.WakeWordConfig()
    got = tww.train_wake_word(hwio_tree_from_jax(start, CPU), cfg, mels,
                              labels, steps=FIT_STEPS)
    scores = [float(tww.wake_word_score(got, cfg, torch.from_numpy(m)))
              for m in mels]
    hits = [(s >= cfg.sensitivity) == bool(y)
            for s, y in zip(scores, labels)]
    assert sum(hits) >= len(hits) - 2


def test_batched_scores_are_the_single_window_scores(trained):
    """The trainer's batched body gives each window wake_word_score's
    probability."""
    start, mels, _, _ = trained
    params = hwio_tree_from_jax(start, CPU)
    cfg = tww.WakeWordConfig()
    with torch.no_grad():
        batch = tww._scores(params, cfg, torch.from_numpy(mels))
    single = torch.stack([tww.wake_word_score(params, cfg,
                                              torch.from_numpy(m))
                          for m in mels])
    assert torch.allclose(batch, single, rtol=0, atol=1e-6)


def test_tool_generators_are_the_jax_tools(J):
    """The port's tool draws the JAX tool's clips from the same seed."""
    a, b = np.random.default_rng(5), np.random.default_rng(5)
    for i in range(12):
        assert np.array_equal(ttool.keyword(a), J.tool.keyword(b))
        assert np.array_equal(ttool.imposter(a, i % 6),
                              J.tool.imposter(b, i % 6))


def test_tool_trains_and_writes_a_loadable_artifact(tmp_path, capsys,
                                                    monkeypatch):
    """The tool on the CPU at a tiny size: one JSON line, an artifact in
    save_wake_word's format that load_wake_word reads; without a card and
    without --device it refuses."""
    out = str(tmp_path / "ww.npz")
    assert ttool.main(["--device", "cpu", "--steps", "3", "--n-train", "2",
                       "--out", out]) == 0
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert row["device"] == "cpu" and row["train_clips"] == 4
    assert row["steps"] == 3 and row["bytes"] > 0
    assert 0.0 <= row["held_out_false_accept"] <= 1.0
    params, cfg = tww.load_wake_word(out, CPU)
    assert cfg == tww.WakeWordConfig()
    assert params["conv2"]["w"].shape == (16, 8, 3, 3)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from trackiellm_tpu_torch.utils.errors import TrackieError
    with pytest.raises(TrackieError):
        ttool.main(["--steps", "1", "--n-train", "1", "--out", out])


# -- on the card ---------------------------------------------------------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


@pytest.mark.cuda
def test_training_on_the_card_matches_the_cpu(dev):
    """The trainer on the card from the CPU's start and windows: every leaf
    within PARAM_TOL rel L2 of the CPU's after STEPS steps."""
    mels, labels = ttool.training_set(N_TRAIN, CPU)
    cfg = tww.WakeWordConfig()
    start = tww.init_wake_word(torch.Generator().manual_seed(1), cfg)
    cpu = tww.train_wake_word(start, cfg, mels, labels, steps=STEPS)
    card = tww.train_wake_word(
        {k: ({kk: vv.to(dev) for kk, vv in v.items()} if isinstance(v, dict)
             else v.to(dev)) for k, v in start.items()},
        cfg, mels.to(dev), labels.to(dev), steps=STEPS)
    for k, v in _leaves(card).items():
        assert v.is_cuda
        assert _rel_l2(v.cpu(), _leaves(cpu)[k]) <= PARAM_TOL, k
