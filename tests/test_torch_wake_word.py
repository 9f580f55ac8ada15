"""The port's wake word against the JAX package's on the CPU: the repo's
only trained weights (``models/pretrained/wake_word_default.npz``, copied
into the port) scored through each side's own log-mel on clips made by the
artifact's trainer (``tools/train_wake_word_default.py``'s ``keyword`` and
``imposter``), the streaming detector chunk by chunk, the artifact's
save/load round trip, init and the openwakeword verifier head.
"""

import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from tools.train_wake_word_default import imposter, keyword, mel
from trackiellm_tpu.audio import wake_word as jww
from trackiellm_tpu_torch.audio import wake_word as tww
from trackiellm_tpu_torch.ops.mel import log_mel_spectrogram

CPU = torch.device("cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def bundled():
    return jww.load_default_wake_word(), tww.load_default_wake_word(
        device=CPU)


def _clips(seed, n=8):
    rng = np.random.default_rng(seed)
    return ([("keyword", keyword(rng)) for _ in range(n)]
            + [("imposter", imposter(rng, i % 6)) for i in range(n)])


def test_artifact_is_the_reference_file():
    with open(os.path.join(ROOT, "trackiellm_tpu", "models", "pretrained",
                           "wake_word_default.npz"), "rb") as f:
        want = f.read()
    with open(tww.default_artifact_path(), "rb") as f:
        assert f.read() == want


def test_bundled_scores_match_the_reference(bundled):
    """Scores within 1e-6 on the trainer's keyword and imposter clips,
    each side through its own log-mel (within 1e-5 of each other); the
    same decisions, and the artifact separates the two."""
    jd, td = bundled
    cfg = td.cfg
    assert cfg == tww.WakeWordConfig(*jd.cfg)
    accepted = {"keyword": 0, "imposter": 0}
    for kind, clip in _clips(123):
        mj = mel(clip)
        mt = log_mel_spectrogram(torch.from_numpy(clip), n_mels=40)[:, -76:]
        assert np.abs(np.asarray(mj) - mt.numpy()).max() <= 1e-5
        sj = float(jww.wake_word_score(jd.params, jd.cfg, mj))
        st = float(tww.wake_word_score(td.params, cfg, mt))
        assert abs(sj - st) <= 1e-6, (kind, sj, st)
        assert (st >= cfg.sensitivity) == (sj >= cfg.sensitivity)
        accepted[kind] += st >= cfg.sensitivity
    assert accepted["keyword"] >= 7 and accepted["imposter"] <= 1


def test_streaming_detector_fires_alike(bundled):
    """NeuralWakeWord on a seeded stream (silence, keywords, imposters):
    the same decision chunk by chunk."""
    jd, td = bundled
    jdet = jww.NeuralWakeWord(jd.params, jd.cfg)
    rng = np.random.default_rng(9)
    parts = [np.zeros(3200, np.float32)]
    for kind, clip in _clips(10, n=3):
        parts += [clip, (0.001 * rng.standard_normal(1600)).astype(
            np.float32)]
    stream = np.concatenate(parts)
    got = [td(stream[i:i + 1600]) for i in range(0, len(stream), 1600)]
    want = [jdet(stream[i:i + 1600]) for i in range(0, len(stream), 1600)]
    assert got == want and any(got) and not all(got)


def test_save_load_round_trip(bundled, tmp_path):
    """The port writes the JAX package's layout (HWIO convolutions): the
    JAX loader reads the port's file, the port reads it back, and both
    score alike."""
    _, td = bundled
    path = str(tmp_path / "ww.npz")
    tww.save_wake_word(path, td.params, td.cfg)
    with np.load(path) as a, np.load(tww.default_artifact_path()) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in b.files:
            np.testing.assert_array_equal(a[k], b[k])
    params, cfg = tww.load_wake_word(path, device=CPU)
    jparams, jcfg = jww.load_wake_word(path)
    assert cfg == td.cfg
    m = torch.from_numpy(np.array(mel(keyword(np.random.default_rng(5)))))
    assert float(tww.wake_word_score(params, cfg, m)) == float(
        tww.wake_word_score(td.params, cfg, m))
    assert abs(float(tww.wake_word_score(params, cfg, m)) - float(
        jww.wake_word_score(jparams, jcfg, jnp.asarray(m.numpy())))) <= 1e-6


def test_init_and_legacy_single_pool_head():
    """Random init has the reference's shapes (OIHW here); a (ch, 1) head
    takes the single global pool, as in the reference."""
    cfg = tww.WakeWordConfig()
    p = tww.init_wake_word(torch.Generator().manual_seed(0), cfg)
    jp = jww.init_wake_word(jax.random.PRNGKey(0), jww.WakeWordConfig())
    assert tuple(p["conv1"]["w"].shape) == tuple(
        np.asarray(jp["conv1"]["w"]).transpose(3, 2, 0, 1).shape)
    assert tuple(p["out_w"].shape) == tuple(jp["out_w"].shape)
    legacy_j = dict(jp, out_w=jp["out_w"][:cfg.ch])
    legacy_t = {k: ({kk: torch.from_numpy(np.array(vv)) for kk, vv in
                     v.items()} if isinstance(v, dict)
                    else torch.from_numpy(np.array(v)))
                for k, v in legacy_j.items()}
    for k in ("conv1", "conv2"):
        legacy_t[k]["w"] = legacy_t[k]["w"].permute(3, 2, 0, 1).contiguous()
    m = np.array(mel(imposter(np.random.default_rng(1), 0)))
    assert abs(float(tww.wake_word_score(legacy_t, cfg, torch.from_numpy(m)))
               - float(jww.wake_word_score(legacy_j, jww.WakeWordConfig(),
                                           jnp.asarray(m)))) <= 1e-6


def test_phrase_detector_copy():
    rng = np.random.default_rng(3)
    chunks = [(a * rng.standard_normal(1600)).astype(np.float32)
              for a in (0.001, 0.3, 0.3, 0.3, 0.001, 0.3, 0.3)]
    a = jww.PhraseWakeWord(consecutive=2)
    b = tww.PhraseWakeWord(consecutive=2)
    assert [b(c) for c in chunks] == [a(c) for c in chunks]


def test_verifier_head_matches_the_reference():
    rng = np.random.default_rng(0)
    dims = (96 * 16, 128, 64, 1)
    layers = [(rng.standard_normal((dims[i], dims[i + 1])).astype(
        np.float32) * 0.1, rng.standard_normal(dims[i + 1]).astype(
        np.float32) * 0.1) for i in range(len(dims) - 1)]
    jh, th = jww.VerifierHead(layers), tww.VerifierHead(layers, device=CPU)
    assert th.in_dim == jh.in_dim == 96 * 16
    for _ in range(4):
        x = rng.standard_normal(96 * 16).astype(np.float32) * 0.2
        assert abs(th(x) - jh(x)) <= 1e-6
    with pytest.raises(ValueError, match="expects 1536"):
        th(np.zeros(10, np.float32))


def test_loading_needs_a_card_or_the_cpu(monkeypatch):
    from trackiellm_tpu_torch.utils.errors import TrackieError
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(TrackieError, match="wake-word"):
        tww.load_default_wake_word()
    with pytest.raises(TrackieError, match="VerifierHead"):
        tww.VerifierHead([(np.zeros((2, 1)), np.zeros(1))])
