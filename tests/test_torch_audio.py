"""The port's voice-in path against the JAX package on the CPU: log-mel,
resampling, the two VADs, Whisper (encoder, decode step, greedy ids),
the ASR engine and streaming transcription.

The same inputs, made from a seed with numpy, and the same weights (JAX
params through ``models/bridge.py``) go through both packages; the
tolerances are the slice's: log-mel 1e-4 max abs, resampling 1e-6 max
abs, VAD probabilities over 50 chunks 1e-5 max abs, encoder output and
decode-step logits 1e-5 rel L2, greedy ids identical.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from trackiellm_tpu.audio import asr as jasr
from trackiellm_tpu.audio import streaming_asr as jstream
from trackiellm_tpu.models import vad as jvad
from trackiellm_tpu.models import whisper as jw
from trackiellm_tpu.ops import mel as jmel
from trackiellm_tpu.ops import resample as jres
from trackiellm_tpu_torch.audio import asr as tasr
from trackiellm_tpu_torch.audio import streaming_asr as tstream
from trackiellm_tpu_torch.models import vad as tvad
from trackiellm_tpu_torch.models import whisper as tw
from trackiellm_tpu_torch.models.bridge import params_from_jax
from trackiellm_tpu_torch.ops import mel as tmel
from trackiellm_tpu_torch.ops import resample as tres
from trackiellm_tpu_torch.ops import scan

SR = 16_000


def _jax_tree(tree):
    """The port's random params as a JAX-package tree (dicts, lists, f32
    arrays): JAX's own random inits compile op by op and cost seconds."""
    if isinstance(tree, dict):
        return {k: _jax_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_jax_tree(v) for v in tree]
    return jnp.asarray(tree.numpy())


def _seeded(init, cfg, seed):
    return _jax_tree(init(torch.Generator().manual_seed(seed), cfg))


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _audio(n, seed=0):
    """Speech-like test audio: a few tones under noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / SR
    x = sum(0.2 * np.sin(2 * np.pi * f * t) for f in (220.0, 440.0, 1330.0))
    return (x + 0.05 * rng.standard_normal(n)).astype(np.float32)


@pytest.mark.parametrize("n_mels,seconds", [(80, 1.0), (80, 3.3), (128, 2.0)])
def test_log_mel_matches_jax(n_mels, seconds):
    a = _audio(int(seconds * SR), seed=n_mels)
    ref = np.asarray(jmel.log_mel_spectrogram(jnp.asarray(a), n_mels=n_mels))
    got = tmel.log_mel_spectrogram(torch.from_numpy(a), n_mels=n_mels)
    assert got.shape == ref.shape
    assert np.abs(got.numpy() - ref).max() <= 1e-4


@pytest.mark.parametrize("up,down", [(1, 3), (3, 1), (160, 441), (2, 2)])
def test_resample_matches_jax(up, down):
    a = _audio(4_800, seed=up + down)
    ref = np.asarray(jres.resample_poly(jnp.asarray(a), up, down))
    got = tres.resample_poly(torch.from_numpy(a), up, down).numpy()
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= 1e-6


@pytest.mark.parametrize("n", [1, 7, 16, 17, 100, 256, 300])
def test_cumsum_has_the_reference_bits(n):
    """``ops/scan.cumsum`` gives jnp.cumsum's f32 bits on the CPU (XLA
    blocks sums longer than 16); torch.cumsum accumulates in f64 there."""
    x = np.random.default_rng(n).uniform(0.5, 4.0, (3, n)).astype(np.float32)
    ref = np.asarray(jax.jit(lambda v: jnp.cumsum(v, axis=-1))(x))
    np.testing.assert_array_equal(scan.cumsum(torch.from_numpy(x)).numpy(),
                                  ref)


def _chunks(n_chunks, seed):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_chunks):  # speech, then silence, then speech
        scale = 0.3 if (i // 10) % 2 == 0 else 0.002
        out.append((scale * rng.standard_normal(tvad.CHUNK_SAMPLES))
                   .astype(np.float32))
    return out


def test_neural_vad_over_50_chunks_matches_jax():
    cfg = jvad.VADConfig()
    jp = _seeded(tvad.init_vad, tvad.VADConfig(), 1)
    tp = params_from_jax(jp)
    js, ts = jvad.init_state(cfg), tvad.init_state(tvad.VADConfig(), "cpu")
    worst = 0.0
    tcfg = tvad.VADConfig()
    for chunk in _chunks(50, seed=2):
        jprob, js = jvad.vad_step(jp, cfg, jnp.asarray(chunk), js)
        tprob, ts = tvad.vad_step(tp, tcfg, torch.from_numpy(chunk), ts)
        worst = max(worst, abs(float(jprob) - float(tprob)))
    assert worst <= 1e-5
    assert np.abs(ts.numpy() - np.asarray(js)).max() <= 1e-5


@pytest.mark.parametrize("wrapper", ["neural", "silero"])
def test_streaming_vad_wrappers_match_jax(wrapper):
    """The wrappers re-chunk 100 ms pipeline chunks into 512-sample frames
    and carry the state; both packages give the same maxima."""
    if wrapper == "neural":
        cfg = jvad.VADConfig()
        jp = _seeded(tvad.init_vad, tvad.VADConfig(), 3)
        jv, tv = jvad.NeuralVAD(jp, cfg), tvad.NeuralVAD(params_from_jax(jp))
    else:
        cfg, jp = _silero_params()
        jv, tv = jvad.SileroVAD(jp, cfg), tvad.SileroVAD(params_from_jax(jp))
    rng = np.random.default_rng(4)
    for i in range(8):
        chunk = (0.2 * rng.standard_normal(1600)).astype(np.float32)
        assert abs(jv(chunk) - tv(chunk)) <= 1e-5
    tv.reset()
    assert tv._leftover.size == 0


def _silero_params():
    """A Silero-v5 param tree with non-zero biases (the random init's are
    zeros)."""
    cfg = jvad.SileroConfig()
    jp = _seeded(tvad.init_silero, tvad.SileroConfig(), 5)
    rng = np.random.default_rng(6)
    for name in list(jp):
        if name.endswith(("_b", "_bi", "_bh")):
            jp[name] = jnp.asarray(
                0.05 * rng.standard_normal(np.shape(jp[name])), jnp.float32)
    return cfg, jp


def test_silero_over_50_chunks_matches_jax():
    cfg, jp = _silero_params()
    tp = params_from_jax(jp)
    tcfg = tvad.SileroConfig()
    js = jvad.silero_init_state(cfg)
    ts = tvad.silero_init_state(tcfg, "cpu")
    probs = []
    for chunk in _chunks(50, seed=7):
        jprob, js = jvad.silero_step(jp, cfg, jnp.asarray(chunk), js)
        tprob, ts = tvad.silero_step(tp, tcfg, torch.from_numpy(chunk), ts)
        probs.append((float(jprob), float(tprob)))
    ref, got = np.array(probs).T
    assert np.abs(ref - got).max() <= 1e-5
    for j, t in zip(js, ts):
        assert np.abs(t.numpy() - np.asarray(j)).max() <= 1e-5


def test_energy_vad():
    v = tvad.EnergyVAD(energy_threshold=1e-3)
    assert v(_audio(1600)) == 1.0
    assert v(np.zeros(1600, np.float32)) == 0.0


def _whisper(seed=0):
    """WhisperConfig.test() params with non-zero q/v/out biases."""
    cfg = jw.WhisperConfig.test()
    jp = _seeded(tw.init_whisper, tw.WhisperConfig.test(), seed)
    rng = np.random.default_rng(seed + 100)
    for grp in ("enc", "dec", "cross"):
        for name in ("bq", "bv", "bo"):
            jp[grp][name] = jnp.asarray(0.05 * rng.standard_normal(
                jp[grp][name].shape), jnp.float32)
    return cfg, jp


@pytest.fixture(scope="module")
def whisper():
    cfg, jp = _whisper()
    a = _audio(cfg.n_audio_ctx * 2 * tmel.HOP_LENGTH, seed=9)
    mel = np.array(jmel.log_mel_spectrogram(jnp.asarray(a)))
    return cfg, jp, params_from_jax(jp), tw.WhisperConfig(*cfg), mel


def test_whisper_encoder_and_decode_steps_match_jax(whisper):
    cfg, jp, tp, tcfg, mel = whisper
    jfeat = jw.encode(jp, cfg, jnp.asarray(mel))
    tfeat = tw.encode(tp, tcfg, torch.from_numpy(mel))
    assert tfeat.shape == (cfg.n_audio_ctx, cfg.d_model)
    assert _rel_l2(tfeat.numpy(), jfeat) <= 1e-5
    jc = jw.make_decoder_cache(jp, cfg, jfeat)
    tc = tw.make_decoder_cache(tp, tcfg, torch.from_numpy(np.array(jfeat)))
    sp = tw.special_tokens(tcfg)
    for tok in (sp["sot"], sp["lang_base"] + 3, 17, 250, 5):
        jl, jc = jw.decode_step(jp, cfg, jnp.int32(tok), jc)
        tl, tc = tw.decode_step(tp, tcfg, tok, tc)
        assert _rel_l2(tl.numpy(), jl) <= 1e-5
    assert tc.length == int(jc.length) == 5


def test_gelu_is_the_tanh_form():
    """jax.nn.gelu defaults to the tanh approximation, which the port
    mirrors; the exact erf form would differ."""
    x = np.linspace(-4, 4, 101).astype(np.float32)
    ref = np.asarray(jax.nn.gelu(jnp.asarray(x)))
    got = tw._gelu(torch.from_numpy(x)).numpy()
    assert np.abs(got - ref).max() <= 1e-6
    exact = torch.nn.functional.gelu(torch.from_numpy(x)).numpy()
    assert np.abs(exact - ref).max() > 1e-4


def test_exact_f32_blocks_overlap_across_threads():
    """Two threads' overlapping ``exact_f32`` blocks (the voice pipeline
    runs TTS on one thread while ASR runs on another): TF32 stays off while
    either is inside, and the caller's flags come back once the last one
    leaves, whichever leaves first."""
    import threading
    from trackiellm_tpu_torch.ops.backend import exact_f32
    mm, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = (mm.allow_tf32, cudnn.allow_tf32, cudnn.enabled)
    a_in, b_in, a_out = (threading.Event() for _ in range(3))
    seen = []

    def flags():
        return (mm.allow_tf32, cudnn.allow_tf32, cudnn.enabled)

    def first():
        with exact_f32():
            a_in.set()
            assert b_in.wait(10)
            seen.append(("a inside", flags()))
        a_out.set()

    def second():
        assert a_in.wait(10)
        with exact_f32():
            b_in.set()
            assert a_out.wait(10)
            seen.append(("b after a left", flags()))

    try:
        mm.allow_tf32, cudnn.allow_tf32, cudnn.enabled = True, True, False
        threads = [threading.Thread(target=f) for f in (first, second)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(20)
        assert seen == [("a inside", (False, False, True)),
                        ("b after a left", (False, False, True))]
        assert flags() == (True, True, False)
        with exact_f32():
            with exact_f32():
                pass
            assert flags() == (False, False, True)
        assert flags() == (True, True, False)
    finally:
        mm.allow_tf32, cudnn.allow_tf32, cudnn.enabled = saved


@pytest.mark.parametrize("stop", ["context", "max_tokens", "eot"])
def test_greedy_ids_match_jax(whisper, stop):
    """transcribe_tokens and transcribe_tokens_host give JAX's ids under
    each stop rule: the text context (length >= n_text_ctx - 1), the token
    budget, and EOT (forced by the final norm's bias)."""
    cfg, jp, tp, tcfg, mel = whisper
    max_tokens = {"context": 64, "max_tokens": 5, "eot": 64}[stop]
    if stop == "eot":
        eot = tw.special_tokens(tcfg)["eot"]
        jp = dict(jp, dec_ln_b=jp["tok_emb"][eot] * 50.0)
        tp = dict(tp, dec_ln_b=tp["tok_emb"][eot] * 50.0)
    kw = dict(max_tokens=max_tokens, language=2)
    ref = jw.transcribe_tokens_host(jp, cfg, jnp.asarray(mel), **kw)
    if stop == "context":  # one compile of the reference's device loop
        assert jw.transcribe_tokens(jp, cfg, jnp.asarray(mel), **kw) == ref
    m = torch.from_numpy(mel)
    assert tw.transcribe_tokens_host(tp, tcfg, m, **kw) == ref
    assert tw.transcribe_tokens(tp, tcfg, m, **kw) == ref
    expect = {"context": cfg.n_text_ctx - 1 - 4, "max_tokens": 5, "eot": 0}
    assert len(ref) == expect[stop]


def test_asr_resamples_and_pads_like_jax(whisper):
    """WhisperASR on 48 kHz input: resampled, padded to the window, and
    transcribed to JAX's text; a longer input is trimmed."""
    cfg, jp, tp, tcfg, _ = whisper
    for n in (SR * 3 // 2 * 3, cfg.n_audio_ctx * 2 * 160 * 3 + 999):
        a = _audio(n, seed=n % 97)
        # max_tokens 64: the device loop the greedy test compiled
        ref = jasr.WhisperASR(jp, cfg, max_tokens=64)
        got = tasr.WhisperASR(tp, tcfg, max_tokens=64)
        jmel_in = np.asarray(jres.resample_poly(jnp.asarray(a), SR, 48_000))
        jmel_in = np.pad(jmel_in, (0, max(0, 2 * cfg.n_audio_ctx * 160
                                          - len(jmel_in))))
        jmel_in = jmel_in[:2 * cfg.n_audio_ctx * 160]
        mel = got.mel(a, sample_rate=48_000)
        ref_mel = np.asarray(jmel.log_mel_spectrogram(jnp.asarray(jmel_in)))
        assert np.abs(mel.numpy() - ref_mel).max() <= 1e-4
        assert got.transcribe(a, sample_rate=48_000) == ref.transcribe(
            a, sample_rate=48_000)
    got.set_language(7)
    assert got.language == 7


class _Scripted:
    """An asr_fn that replays a script of hypotheses."""

    def __init__(self, script):
        self.script, self.i = list(script), 0

    def __call__(self, audio):
        out = self.script[min(self.i, len(self.script) - 1)]
        self.i += 1
        return out


def test_streaming_transcriber_matches_jax():
    """The copied LocalAgreement transcriber gives the JAX package's
    partials, stable text and final pass on the same script."""
    script = ["the", "the cat", "the cat sat", "the cat sad on",
              "the cat sat on the", "the cat sat on the mat"]
    outs = []
    for mod in (jstream, tstream):
        partials = []
        st = mod.StreamingTranscriber(_Scripted(script), refresh_s=0.1,
                                      on_partial=partials.append)
        fed = [st.feed(np.zeros(1600, np.float32)) for _ in range(6)]
        outs.append((fed, partials, st.stable_text, st.passes,
                     st.finalize()))
    assert outs[0] == outs[1]
    assert outs[1][2] == "the cat sat on the"
    with pytest.raises(ValueError):
        tstream.StreamingTranscriber(_Scripted(["x"]), agreement=1)


def test_streaming_transcriber_over_the_port_asr(whisper):
    """StreamingTranscriber over the port's WhisperASR: its final pass is
    the engine's own transcript."""
    cfg, jp, tp, tcfg, _ = whisper
    engine = tasr.WhisperASR(tp, tcfg, max_tokens=6)
    st = tstream.StreamingTranscriber(engine, refresh_s=0.5)
    a = _audio(SR * 2, seed=11)
    for i in range(0, len(a), 4000):
        st.feed(a[i:i + 4000])
    assert st.passes == 4
    assert st.finalize(a) == engine(a)
