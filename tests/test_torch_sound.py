"""The port's CNN ambient-sound classifier, its engine and converter
against the JAX package's, on the CPU.

The reference's classifier (three "SAME" 3x3 conv + ReLU + 2x2 "SAME"
max-pool blocks, global mean, dense softmax head) at its tiny width (32
mel bins, 32 frames, 8 channels), at an odd size whose pools pad, and at
its default size (64 mel bins, 96 frames, 32 channels); params drawn by
the JAX package's ``init_sound_classifier`` and carried across with
``hwio_tree_from_jax``, or written as a torch state dict from seeded numpy
for ``sound_classifier_from_torch``.

Tolerances: the converter's leaves are the JAX converter's bytes (HWIO
made OIHW); the probabilities agree to 1e-6 absolute; each engine reports
the same class, or None, on the same window.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from trackiellm_tpu.audio.sound_engine import (
    SoundClassifierEngine as JEngine)
from trackiellm_tpu.models import convert as jconv
from trackiellm_tpu.models import sound_classifier as jsc
from trackiellm_tpu_torch.audio.pipeline import AudioPipeline
from trackiellm_tpu_torch.audio.sound_engine import SoundClassifierEngine
from trackiellm_tpu_torch.models import convert as tconv
from trackiellm_tpu_torch.models import sound_classifier as tsc
from trackiellm_tpu_torch.models.bridge import hwio_tree_from_jax

CPU = torch.device("cpu")
PROB_ATOL = 1e-6
CONFIGS = {"tiny": jsc.SoundClassifierConfig.tiny(),
           "odd": jsc.SoundClassifierConfig(n_mels=30, n_frames=50, ch=8),
           "default": jsc.SoundClassifierConfig.default()}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small shapes: one intra-op thread, so this file does not crowd the
    other test workers' CPUs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def models(name: str, seed: int = 0):
    """(JAX params, JAX cfg, port params, port cfg) of one config."""
    jcfg = CONFIGS[name]
    jp = jsc.init_sound_classifier(jax.random.PRNGKey(seed), jcfg)
    return jp, jcfg, hwio_tree_from_jax(jp, CPU), tsc.SoundClassifierConfig(
        *jcfg)


def window(kind: str, n: int = 16000) -> np.ndarray:
    rng = np.random.default_rng(41)
    t = np.arange(n) / 16000.0
    return {"noise": 0.3 * rng.standard_normal(n),
            "tone": 0.5 * np.sin(2 * np.pi * 880.0 * t),
            "silence": np.zeros(n),
            "short": 0.3 * rng.standard_normal(n // 4)}[kind].astype(
                np.float32)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_classify_window_matches(name):
    jp, jcfg, tp, tcfg = models(name)
    mel = np.random.default_rng(42).standard_normal(
        (jcfg.n_mels, jcfg.n_frames)).astype(np.float32)
    want = np.asarray(jsc.classify_window(jp, jcfg, jnp.asarray(mel)))
    got = tsc.classify_window(tp, tcfg, torch.from_numpy(mel))
    assert got.shape == (len(tsc.SoundClass),)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=PROB_ATOL)
    assert abs(float(got.sum()) - 1.0) < 1e-5


def test_sound_classes_match():
    assert [(c.name, int(c)) for c in tsc.SoundClass] == [
        (c.name, int(c)) for c in jsc.SoundClass]
    assert tuple(tsc.SoundClassifierConfig.default()) == tuple(
        jsc.SoundClassifierConfig.default())


def test_init_draws_the_reference_shapes():
    gen = torch.Generator().manual_seed(0)
    cfg = tsc.SoundClassifierConfig.tiny()
    p = tsc.init_sound_classifier(gen, cfg)
    jp = jsc.init_sound_classifier(jax.random.PRNGKey(0), CONFIGS["tiny"])
    want = hwio_tree_from_jax(jp, CPU)
    for k in ("conv1", "conv2", "conv3"):
        assert p[k]["w"].shape == want[k]["w"].shape
        bound = (9 * p[k]["w"].shape[1]) ** -0.5  # U(+-1/sqrt(fan_in))
        assert float(p[k]["w"].abs().max()) <= bound
        assert float(want[k]["w"].abs().max()) <= bound
    assert p["out_w"].shape == want["out_w"].shape


@pytest.mark.parametrize("kind", ["noise", "tone", "silence", "short"])
@pytest.mark.parametrize("name", ["tiny", "default"])
def test_engine_reports_the_jax_class(name, kind):
    """The engine over its own log-mel, padded or cut to n_frames: the
    JAX engine's class at a threshold that always reports (ignore set
    empty), the default one, and one that abstains."""
    jp, jcfg, tp, tcfg = models(name, seed=1)
    w = window(kind)
    for kw in ({"threshold": 0.0, "ignore": ()}, {},
               {"threshold": 0.999}):
        want = JEngine(jp, jcfg, **kw)(w)
        got = SoundClassifierEngine(tp, tcfg, **kw)(w)
        assert got == want, kw


def forced(tree, cls: int, torch_side: bool):
    """``tree`` with its head bias saturating class ``cls``."""
    bias = np.eye(len(tsc.SoundClass), dtype=np.float32)[cls] * 40.0
    if torch_side:
        return dict(tree, out_b=tree["out_b"] + torch.from_numpy(bias))
    return dict(tree, out_b=tree["out_b"] + jnp.asarray(bias))


@pytest.mark.parametrize("cls", list(tsc.SoundClass),
                         ids=[c.name for c in tsc.SoundClass])
def test_forced_class_and_ignore_set(cls):
    """A head bias forcing each class: ALARM, SIREN, WATER_RUNNING and
    DOG_BARK are reported, SILENCE, SPEECH and OTHER ignored, as by the
    JAX engine."""
    jp, jcfg, tp, tcfg = models("tiny", seed=2)
    w = window("noise")
    want = JEngine(forced(jp, cls, False), jcfg)(w)
    got = SoundClassifierEngine(forced(tp, cls, True), tcfg)(w)
    assert got == want
    assert got == (None if cls.name in ("SILENCE", "SPEECH", "OTHER")
                   else cls.name)


def test_sound_classifier_from_torch_gives_the_jax_bytes():
    rng = np.random.default_rng(43)
    state = {}
    for name, (o, i) in (("conv1", (16, 1)), ("conv2", (32, 16)),
                         ("conv3", (64, 32))):
        state[f"{name}.weight"] = rng.standard_normal(
            (o, i, 3, 3)).astype(np.float32)
        state[f"{name}.bias"] = rng.standard_normal(o).astype(np.float32)
    state["out.weight"] = rng.standard_normal((7, 64)).astype(np.float32)
    state["out.bias"] = rng.standard_normal(7).astype(np.float32)
    jp, jcfg = jconv.sound_classifier_from_torch(state)
    tp, tcfg = tconv.sound_classifier_from_torch(state, device=CPU)
    assert tuple(tcfg) == tuple(jcfg)
    want = hwio_tree_from_jax(jp, CPU)
    for k in ("conv1", "conv2", "conv3"):
        for leaf in ("w", "b"):
            assert torch.equal(tp[k][leaf], want[k][leaf]), (k, leaf)
    assert torch.equal(tp["out_w"], want["out_w"])
    assert torch.equal(tp["out_b"], want["out_b"])


def test_pipeline_sound_fn_reaches_on_sound():
    """SoundClassifierEngine as AudioPipeline's sound_fn: passive
    listening hands it one-second windows, and a forced ALARM reaches
    on_sound."""
    _, _, tp, tcfg = models("default", seed=3)
    engine = SoundClassifierEngine(forced(tp, tsc.SoundClass.ALARM, True),
                                   tcfg)
    seen, heard = [], []

    def sound_fn(audio):
        seen.append(len(audio))
        return engine(audio)
    pipe = AudioPipeline(sound_fn=sound_fn, wake_fn=lambda chunk: False,
                         on_sound=heard.append)
    try:
        for _ in range(10):
            pipe.process_chunk(window("noise", 1600))
    finally:
        pipe.close()
    assert seen == [16000] and heard == ["ALARM"]
