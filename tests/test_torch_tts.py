"""The port's voice-out path against the JAX package on the CPU: the TTS
acoustic model and vocoder, streamed synthesis, the engine, the
phonemizer and the VITS (Piper) graph.

Tolerances: TTS mel and waveform 1e-5 rel L2 with the frame counts equal;
streamed chunks equal to the one-shot waveform bit for bit; VITS waveform
with injected noise 1e-4 rel L2 with the frame counts equal; phoneme lists
identical.
"""

import json
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from trackiellm_tpu.audio import phonemizer as jph
from trackiellm_tpu.audio import tts_engine as jeng
from trackiellm_tpu.models import tts as jt
from trackiellm_tpu.models import vits as jv
from trackiellm_tpu_torch.audio import phonemizer as tph
from trackiellm_tpu_torch.audio import tts_engine as teng
from trackiellm_tpu_torch.models import tts as tt
from trackiellm_tpu_torch.models import vits as tv
from trackiellm_tpu_torch.models.bridge import params_from_jax

TEXTS = ("hello there streaming friend", "uma xícara à frente, 3 metros.",
         "oi")
GOLD = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "fixtures", "phoneme_gold.json")


def _jax_tree(tree):
    """The port's random params as a JAX-package tree (dicts, lists, f32
    arrays): JAX's own random inits compile op by op and cost seconds."""
    if isinstance(tree, dict):
        return {k: _jax_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_jax_tree(v) for v in tree]
    return jnp.asarray(tree.numpy())


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _tts(cfg, seed=0):
    tcfg = tt.TTSConfig(*cfg)
    jp = _jax_tree(tt.init_tts(torch.Generator().manual_seed(seed), tcfg))
    return jp, params_from_jax(jp), tcfg


TINY = jt.TTSConfig.tiny()
BUCKETED = jt.TTSConfig(d_model=32, voc_ch=32, max_chars=96, max_frames=384)


@pytest.fixture(scope="module")
def tiny():
    return _tts(TINY)


@pytest.mark.parametrize("rate", [1.0, 0.6, 1.7])
@pytest.mark.parametrize("text", TEXTS)
def test_acoustic_and_vocoder_match_jax(tiny, text, rate):
    jp, tp, tcfg = tiny
    ids, n = jt.text_to_ids(text, TINY.max_chars)
    tids, tn = tt.text_to_ids(text, TINY.max_chars)
    assert n == tn and np.array_equal(ids, tids)
    jm, jn = jt.acoustic_forward(jp, TINY, jnp.asarray(ids), jnp.int32(n),
                                 jnp.float32(rate))
    tm, tn_frames = tt.acoustic_forward(tp, tcfg, torch.from_numpy(ids), n,
                                        rate)
    assert int(tn_frames) == int(jn)
    assert _rel_l2(tm.numpy(), jm) <= 1e-5
    jw, jn_s = jt.synthesize(jp, TINY, text, rate=rate)
    tw_, tn_s = tt.synthesize(tp, tcfg, text, rate=rate)
    assert tn_s == jn_s == int(jn) * TINY.hop
    assert _rel_l2(tw_, jw) <= 1e-5


@pytest.mark.parametrize("cfg", [TINY, BUCKETED], ids=["tiny", "bucketed"])
@pytest.mark.parametrize("text", TEXTS)
def test_streamed_chunks_equal_the_one_shot_waveform(cfg, text):
    """The chunked vocoder (overlap >= its receptive field) gives the
    one-shot waveform bit for bit, also through a latency bucket."""
    _, tp, tcfg = _tts(cfg, seed=3)
    full, n = tt.synthesize(tp, tcfg, text)
    chunks = list(tt.synthesize_streaming(tp, tcfg, text, chunk_frames=16,
                                          overlap=8))
    assert len(chunks) > 1 or n <= 16 * cfg.hop
    np.testing.assert_array_equal(np.concatenate(chunks), full)


def test_bucket_config_matches_jax():
    for n in (1, 20, 32, 33, 40, 64, 65, 127):
        assert tuple(tt.bucket_config(tt.TTSConfig(), n)) == tuple(
            jt.bucket_config(jt.TTSConfig(), n))
    assert tt.LATENCY_BUCKETS == jt.LATENCY_BUCKETS


def test_streaming_window_never_leaves_the_buffer(tiny):
    """At max_frames 64 a 16 + 2 * 8 window clamps as lax.dynamic_slice
    does; the chunks still join to the one-shot waveform."""
    jp, tp, tcfg = tiny
    text = "a long enough sentence to fill the buffer"
    ref = np.concatenate(list(jt.synthesize_streaming(
        jp, TINY, text, chunk_frames=48, overlap=16)))
    got = np.concatenate(list(tt.synthesize_streaming(
        tp, tcfg, text, chunk_frames=48, overlap=16)))
    assert len(got) == len(ref)
    assert _rel_l2(got, ref) <= 1e-5


@pytest.mark.parametrize("lang", [None, "pt"])
def test_engine_matches_jax(lang):
    """TTSEngine: sentence chunks, synthesize, stream (bit for bit the
    synthesized waveform) and the callback's total."""
    vocab = jph.PhonemeFrontend.vocab_size if lang else len(jt.TTS_CHARSET)
    cfg = TINY._replace(vocab_size=vocab)
    jp, tp, tcfg = _tts(cfg, seed=5)
    text = "Há uma porta. Siga em frente devagar! Cuidado com o degrau."
    je = jeng.TTSEngine(jp, cfg, rate=1.2, lang=lang)
    te = teng.TTSEngine(tp, tcfg, rate=1.2, lang=lang)
    assert list(te._chunks(text)) == list(je._chunks(text))
    assert te.model_info() == je.model_info()
    ref, got = je.synthesize(text), te.synthesize(text)
    assert len(got) == len(ref) and _rel_l2(got, ref) <= 1e-5
    np.testing.assert_array_equal(np.concatenate(list(te.stream(text))), got)
    seen = []
    assert te.synthesize_streaming(text, seen.append) == len(got)
    te.set_rate(9.0)
    assert te.rate == 4.0
    with pytest.raises(ValueError, match="vocab_size"):
        teng.TTSEngine(tp, tcfg._replace(vocab_size=7), lang="pt")


def test_phonemizer_is_the_reference_on_the_gold_texts():
    with open(GOLD, encoding="utf-8") as f:
        gold = json.load(f)
    for lang in ("pt", "en"):
        for word in gold[lang]:
            assert tph.phonemize(word, lang) == jph.phonemize(word, lang)
        text = " ".join(list(gold[lang])[:40]) + " 1234 e 56."
        assert tph.phonemize(text, lang) == jph.phonemize(text, lang)
        ids, n = tph.PhonemeFrontend(lang)(text, 64)
        rids, rn = jph.PhonemeFrontend(lang)(text, 64)
        assert n == rn and np.array_equal(ids, rids)
    assert tph.PHONEMES == jph.PHONEMES


# ---------------------------------------------------------------------------
# VITS
# ---------------------------------------------------------------------------

VTINY = jv.VITSConfig.tiny()


def _vits(seed):
    return _jax_tree(tv.init_vits(torch.Generator().manual_seed(seed),
                                  tv.VITSConfig(*VTINY)))


def _noise(key, cfg):
    """JAX's two draws, as vits_infer makes them (vits.py:443-445, 464)."""
    k_w, k_z = jax.random.split(key)
    return (np.array(jax.random.normal(k_w, (2, cfg.max_phonemes))),
            np.array(jax.random.normal(k_z, (cfg.d_model, cfg.max_frames))))


def _spline_params(jp, seed):
    """Non-zero ConvFlow projections, so the spline inverse does work (the
    random init's are zeros)."""
    flows = jp["sdp"]["flows"]
    rng = np.random.default_rng(seed)
    flows["proj_w"] = jnp.asarray(
        0.3 * rng.standard_normal(np.shape(flows["proj_w"])), jnp.float32)
    flows["proj_b"] = jnp.asarray(
        0.3 * rng.standard_normal(np.shape(flows["proj_b"])), jnp.float32)
    jp["sdp"]["ea_m"] = jnp.asarray([0.3, -0.2], jnp.float32)
    return jp


@pytest.mark.parametrize("use_sdp", [True, False])
@pytest.mark.parametrize("n", [5, 19])
def test_vits_matches_jax_with_injected_noise(n, use_sdp):
    jp = _spline_params(_vits(7), 8)
    tp = params_from_jax(jp)
    ph = np.zeros(VTINY.max_phonemes, np.int32)
    ph[:n] = 1 + (np.arange(n) * 7) % (VTINY.vocab_size - 1)
    key = jax.random.PRNGKey(n)
    for length_scale in (1.0, 1.6):
        kw = dict(noise_scale=0.667, length_scale=length_scale,
                  noise_scale_w=0.8, use_sdp=use_sdp)
        jwav, jn = jv.vits_infer(jp, VTINY, jnp.asarray(ph), jnp.int32(n),
                                 key, **kw)
        nw, nz = _noise(key, VTINY)
        twav, tn = tv.vits_infer(tp, tv.VITSConfig(*VTINY),
                                 torch.from_numpy(ph), n,
                                 torch.from_numpy(nw), torch.from_numpy(nz),
                                 **kw)
        assert int(tn) == int(jn) > 0
        assert _rel_l2(twav.numpy(), jwav) <= 1e-4


def test_spline_inverse_matches_jax():
    rng = np.random.default_rng(0)
    y = (3.0 * rng.standard_normal((4, 9))).astype(np.float32)
    w, h = (rng.standard_normal((2, 4, 9, 10)) * 2).astype(np.float32)
    d = rng.standard_normal((4, 9, 9)).astype(np.float32)
    ref = np.asarray(jv._rq_spline_inverse(*map(jnp.asarray, (y, w, h, d)),
                                           5.0))
    got = tv._rq_spline_inverse(*map(torch.from_numpy, (y, w, h, d)), 5.0)
    assert np.abs(got.numpy() - ref).max() <= 1e-5


def test_relative_attention_matches_jax():
    cfg = VTINY
    jp = _vits(2)
    lp = jax.tree_util.tree_map(lambda a: a[0], jp["enc"]["layers"])["attn"]
    x = np.random.default_rng(1).standard_normal(
        (cfg.d_model, 12)).astype(np.float32)
    mask = np.ones((12, 12), bool)
    mask[:, 9:] = mask[9:] = False
    ref = jv._rel_attention(jnp.asarray(x), lp, cfg.n_heads, cfg.window,
                            jnp.asarray(mask))
    got = tv._rel_attention(torch.from_numpy(x), params_from_jax(lp),
                            cfg.n_heads, cfg.window, torch.from_numpy(mask))
    assert _rel_l2(got.numpy(), ref) <= 1e-5


def test_voice_draws_its_noise_from_its_generator():
    """VITSVoice: the same seed gives the same waveform, another seed
    another; the grapheme fallback and a phoneme map give ids as the
    reference's voice does."""
    tp = params_from_jax(_vits(9))
    tcfg = tv.VITSConfig(*VTINY)
    a = tv.VITSVoice(tp, tcfg, seed=4).synthesize("ola mundo")
    b = tv.VITSVoice(tp, tcfg, seed=4).synthesize("ola mundo")
    c = tv.VITSVoice(tp, tcfg, seed=5).synthesize("ola mundo")
    assert len(a) > 0 and len(a) % tcfg.hop == 0 and np.isfinite(a).all()
    np.testing.assert_array_equal(a, b)
    assert len(a) != len(c) or not np.array_equal(a, c)
    id_map = {"^": [1], "$": [2], "_": [0], "o": [5], "l": [6], "a": [7]}
    for m in (None, id_map):
        jvoice = jv.VITSVoice(_vits(9),
                              VTINY, phoneme_id_map=m)
        tvoice = tv.VITSVoice(tp, tcfg, phoneme_id_map=m)
        assert tvoice._to_ids("olá, ola") == jvoice._to_ids("olá, ola")
