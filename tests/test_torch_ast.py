"""The port's AST (Audio Spectrogram Transformer) sound classifier, its
converter, its host front end and its ``sound_fn`` surface against the JAX
package's, on the CPU.

Tiny ASTs (16 mel bins, 64 frames, 8x8 patches at frequency stride 8 and
time stride 8, or 4 where the patches overlap; width 32, 4 heads, 2
layers, 5 labels) written as HF ``ASTForAudioClassification`` state dicts
from seeded numpy under the names ``ast_from_hf`` reads, with an id2label
list whose label 0 is AudioSet's smoke alarm. Both packages convert the
same bytes and take the same features.

Tolerances: the converters' leaves and labels are equal; the logits agree
to 1e-5 relative L2 and ``ast_features`` to 1e-6 absolute; the ambient
class each package's classifier reports is the same, named as the cortex
names it in the port (``SoundClass``: "ALARM") where the JAX package
names it in lower case ("alarm"), which its cortex never speaks as
urgent.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from trackiellm_tpu.models import ast as jast
from trackiellm_tpu.models import convert as jconv
from trackiellm_tpu_torch.audio.pipeline import AudioPipeline
from trackiellm_tpu_torch.models import ast as tast
from trackiellm_tpu_torch.models import convert as tconv
from trackiellm_tpu_torch.models.bridge import params_from_jax

CPU = torch.device("cpu")
REL = 1e-5           # logits: relative L2
FEAT_ATOL = 1e-6     # ast_features: absolute
MELS, FRAMES, PATCH, DIM, HEADS, HID, LAYERS = 16, 64, 8, 32, 4, 64, 2
LABELS = ["Smoke detector, smoke alarm", "Speech", "Siren",
          "Water tap, faucet", "Dog"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes: one intra-op thread, so this file does not crowd the
    other test workers' CPUs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cortex_name(name):
    """The JAX package's ambient class under the port's name for it."""
    return None if name is None else name.upper()


def rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def hf_config(fstride: int, tstride: int) -> dict:
    return {"num_mel_bins": MELS, "max_length": FRAMES,
            "frequency_stride": fstride, "time_stride": tstride,
            "num_attention_heads": HEADS, "layer_norm_eps": 1e-12,
            "id2label": {str(i): name for i, name in enumerate(LABELS)}}


def ast_state(seed: int, fstride: int, tstride: int) -> dict:
    """An ASTForAudioClassification state dict from seeded numpy: N(0,
    0.08) matrices, N(0, 0.02) biases, norms near 1."""
    rng = np.random.default_rng(seed)

    def w(*shape, s=0.08):
        return (rng.standard_normal(shape) * s).astype(np.float32)

    def norm(prefix):
        return {f"{prefix}.weight": 1 + w(DIM, s=0.1),
                f"{prefix}.bias": w(DIM, s=0.02)}

    def lin(prefix, o, i):
        return {f"{prefix}.weight": w(o, i), f"{prefix}.bias": w(o, s=0.02)}

    n_tok = (((MELS - PATCH) // fstride + 1)
             * ((FRAMES - PATCH) // tstride + 1) + 2)
    pre = "audio_spectrogram_transformer"
    e = f"{pre}.embeddings"
    st = {f"{e}.patch_embeddings.projection.weight": w(DIM, 1, PATCH, PATCH),
          f"{e}.patch_embeddings.projection.bias": w(DIM, s=0.02),
          f"{e}.position_embeddings": w(1, n_tok, DIM),
          f"{e}.cls_token": w(1, 1, DIM),
          f"{e}.distillation_token": w(1, 1, DIM)}
    for i in range(LAYERS):
        p = f"{pre}.encoder.layer.{i}"
        st.update(norm(f"{p}.layernorm_before"))
        st.update(norm(f"{p}.layernorm_after"))
        for name in ("query", "key", "value"):
            st.update(lin(f"{p}.attention.attention.{name}", DIM, DIM))
        st.update(lin(f"{p}.attention.output.dense", DIM, DIM))
        st.update(lin(f"{p}.intermediate.dense", HID, DIM))
        st.update(lin(f"{p}.output.dense", DIM, HID))
    st.update(norm(f"{pre}.layernorm"))
    st.update(norm("classifier.layernorm"))
    st.update(lin("classifier.dense", len(LABELS), DIM))
    return st


@pytest.fixture(scope="module", params=[(8, 8), (8, 4)],
                ids=["stride8", "overlap"])
def models(request):
    """(JAX params, JAX cfg, port params, port cfg, labels)."""
    fs, ts = request.param
    state = ast_state(21 + ts, fs, ts)
    jp, jcfg, jlabels = jconv.ast_from_hf(state, hf_config(fs, ts))
    tp, tcfg, tlabels = tconv.ast_from_hf(state, hf_config(fs, ts),
                                          device=CPU)
    assert tlabels == jlabels == LABELS
    return jp, jcfg, tp, tcfg


def leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves(v, f"{prefix}.{k}")
    else:
        yield prefix, tree


def spec(seed: int) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(
        (FRAMES, MELS)).astype(np.float32)


def test_ast_from_hf_gives_the_jax_bytes(models):
    jp, jcfg, tp, tcfg = models
    assert tuple(tcfg) == tuple(jcfg)
    want = dict(leaves(params_from_jax(jp)))
    got = dict(leaves(tp))
    assert sorted(got) == sorted(want)
    for name, t in got.items():
        assert t.dtype == torch.float32 and torch.equal(t, want[name]), name


def test_ast_from_hf_refuses_a_geometry_mismatch():
    state = ast_state(30, 8, 8)
    with pytest.raises(Exception, match="position embeddings"):
        tconv.ast_from_hf(state, hf_config(8, 4), device=CPU)
    _, _, labels = tconv.ast_from_hf(state, {**hf_config(8, 8),
                                             "id2label": None}, device=CPU)
    assert labels == []


@pytest.mark.parametrize("seed", [31, 32])
def test_ast_logits_match(models, seed):
    jp, jcfg, tp, tcfg = models
    x = spec(seed)
    want = np.asarray(jast.ast_logits(jp, jcfg, jnp.asarray(x)))
    got = tast.ast_logits(tp, tcfg, torch.from_numpy(x))
    assert got.shape == (len(LABELS),)
    assert rel_l2(got, want) <= REL


def test_overlapping_patches_are_load_bearing(models):
    """A patch-sized bump moves the logits (the strided convolution sees
    it), as in the JAX package."""
    _, _, tp, tcfg = models
    x = spec(33)
    bumped = x.copy()
    bumped[10:18, 4:12] += 3.0
    a = tast.ast_logits(tp, tcfg, torch.from_numpy(x))
    b = tast.ast_logits(tp, tcfg, torch.from_numpy(bumped))
    assert float((a - b).abs().max()) > 1e-3


@pytest.mark.parametrize("seconds", [0.3, 1.0, 2.5])
def test_ast_features_match(seconds):
    """The host front end: short windows pad, long ones keep n_frames."""
    cfg = jast.ASTConfig.tiny()
    audio = (0.3 * np.random.default_rng(34).standard_normal(
        int(16000 * seconds))).astype(np.float32)
    want = jast.ast_features(audio, cfg)
    got = tast.ast_features(audio, tast.ASTConfig.tiny())
    assert got.shape == (cfg.n_frames, cfg.n_mels) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=FEAT_ATOL)


def test_label_mapping_and_threshold_match(models):
    """Every label's class and the threshold: each package's classifier
    reports the same ambient class, or None, on the same features (the
    port under the cortex's upper-case name)."""
    jp, jcfg, tp, tcfg = models
    for seed in (35, 36, 37):
        x = spec(seed)
        for thr in (0.0, 0.5, 0.999):
            want = jast.ASTSoundClassifier(
                jp, jcfg, LABELS, threshold=thr,
                features_fn=lambda audio: x)(np.zeros(800, np.float32))
            got = tast.ASTSoundClassifier(
                tp, tcfg, LABELS, threshold=thr,
                features_fn=lambda audio: x)(np.zeros(800, np.float32))
            assert got == _cortex_name(want), (seed, thr)
    assert tast.ASTSoundClassifier(tp, tcfg, LABELS)._class_ids == {
        "ALARM": [0], "SIREN": [2], "WATER_RUNNING": [3], "DOG_BARK": [4]}


@pytest.mark.parametrize("label,name", [
    (0, "alarm"), (2, "siren"), (3, "water_running"), (4, "dog_bark")])
def test_forced_class_detection(models, label, name):
    """A head bias that saturates one label makes both packages report its
    ambient class: the id mapping's direction."""
    jp, jcfg, tp, tcfg = models
    jb = dict(jp, head_b=jnp.asarray(
        np.asarray(jp["head_b"]) + 20.0 * np.eye(len(LABELS))[label]))
    tb = dict(tp, head_b=tp["head_b"] + 20.0 * torch.eye(len(LABELS))[label])
    x = spec(38)
    silence = np.zeros(800, np.float32)
    want = jast.ASTSoundClassifier(jb, jcfg, LABELS,
                                   features_fn=lambda audio: x)(silence)
    got = tast.ASTSoundClassifier(tb, tcfg, LABELS,
                                  features_fn=lambda audio: x)(silence)
    assert want == name and got == name.upper()


def test_pipeline_sound_fn_surface(models):
    """ASTSoundClassifier as AudioPipeline's sound_fn: passive listening
    hands it one-second windows, and the class it returns reaches
    on_sound."""
    _, _, tp, tcfg = models
    tb = dict(tp, head_b=tp["head_b"] + 20.0 * torch.eye(len(LABELS))[0])
    windows = []

    def features(audio):
        windows.append(len(audio))
        return tast.ast_features(audio, tcfg)
    heard = []
    pipe = AudioPipeline(sound_fn=tast.ASTSoundClassifier(
        tb, tcfg, LABELS, features_fn=features),
        wake_fn=lambda chunk: False, on_sound=heard.append)
    try:
        rng = np.random.default_rng(39)
        for _ in range(10):
            pipe.process_chunk((0.1 * rng.standard_normal(1600)).astype(
                np.float32))
    finally:
        pipe.close()
    assert windows == [16000] and heard == ["ALARM"]


class _Said:
    """Records every line a cortex speaks."""

    def __init__(self):
        self.said = []

    def say(self, text, priority):
        self.said.append((text, int(priority)))


def test_ast_alarm_is_urgent_in_the_port_only(models):
    """A smoke alarm that AST hears reaches each package's cortex as the
    class its classifier names: the JAX package's "alarm" is a NORMAL
    context item and no speech, since the cortex speaks urgently only for
    ALARM and SIREN; the port's "ALARM" is an URGENT item and CRITICAL
    speech."""
    from trackiellm_tpu.cortex import main as jcortex
    from trackiellm_tpu_torch.cortex import main as tcortex
    from trackiellm_tpu_torch.cortex.decision import ActionPriority
    jp, jcfg, tp, tcfg = models
    x = spec(38)
    jb = dict(jp, head_b=jnp.asarray(
        np.asarray(jp["head_b"]) + 20.0 * np.eye(len(LABELS))[0]))
    tb = dict(tp, head_b=tp["head_b"] + 20.0 * torch.eye(len(LABELS))[0])
    silence = np.zeros(800, np.float32)
    heard = {"jax": jast.ASTSoundClassifier(
        jb, jcfg, LABELS, features_fn=lambda audio: x)(silence),
        "torch": tast.ASTSoundClassifier(
        tb, tcfg, LABELS, features_fn=lambda audio: x)(silence)}
    assert heard == {"jax": "alarm", "torch": "ALARM"}
    said, context = {}, {}
    for side, mod in (("jax", jcortex), ("torch", tcortex)):
        audio = _Said()
        c = mod.Cortex(audio_pipeline=audio)
        c._process_ambient_sound(heard[side])
        said[side] = audio.said
        context[side] = c.reasoner.generate_context_string()
    assert said["jax"] == []
    assert said["torch"] == [("URGENTE: ALARM detectado!",
                              int(ActionPriority.CRITICAL))]
    assert "Som detectado: alarm" in context["jax"]
    assert "Som detectado: ALARM" in context["torch"]
