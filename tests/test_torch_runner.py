"""The port's LLMRunner against the JAX package's, and its sampler.

Greedy text must be byte-identical to the JAX runner on the same weights
(LLMConfig.tiny(), f32, Q4 at group 64, bridged byte for byte) at
lookahead 1 and 4, through prefill, prefix reuse, chat's extend path and
min_tokens. Seed 3's weights were checked to put no top-2 logit margin
under 1e-4 on these generations. The lookahead's rollback is pinned
against the port's own serial path. ``sample`` draws from another RNG
than jax.random, so it is held to the reference distribution by total
variation distance (the pattern of tests/test_speculative.py).
"""

import os
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from trackiellm_tpu.llm import runner as jrunner
from trackiellm_tpu.llm import sampling as jsampling
from trackiellm_tpu.llm.tokenizer import ByteTokenizer as JByteTokenizer
from trackiellm_tpu.models import llm as jllm
from trackiellm_tpu_torch.llm import sampling as tsampling
from trackiellm_tpu_torch.llm.runner import GenerationConfig, LLMRunner
from trackiellm_tpu_torch.llm.tokenizer import ByteTokenizer
from trackiellm_tpu_torch.models import llm as tllm
from trackiellm_tpu_torch.models.bridge import params_from_jax

_PARAMS = {}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes: one intra-op thread, so this file does not crowd the
    other test workers' CPUs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _params(max_seq=None):
    if max_seq not in _PARAMS:
        cfg = jllm.LLMConfig.tiny()
        if max_seq:
            cfg = cfg._replace(max_seq=max_seq, sliding_window=max_seq)
        p = jllm.quantize_params(
            jllm.init_params(jax.random.PRNGKey(3), cfg, dtype=jnp.float32),
            bits=4, group=64)
        _PARAMS[max_seq] = (cfg, p, params_from_jax(p))
    return _PARAMS[max_seq]


def _pair(lookahead, max_seq=None, eos_id=None, **gen_kw):
    """A JAX runner and a port runner on the same weights and config."""
    cfg, jp, tp = _params(max_seq)
    gen_kw.setdefault("temperature", 0.0)
    gen_kw.setdefault("max_tokens", 24)
    gen_kw.setdefault("speculative", False)
    jtok, ttok = JByteTokenizer(cfg.vocab_size), ByteTokenizer(cfg.vocab_size)
    if eos_id is not None:
        jtok.eos_id = ttok.eos_id = eos_id
    jr = jrunner.LLMRunner(
        jp, cfg, jtok, jrunner.GenerationConfig(
            lookahead=lookahead, **gen_kw),
        cache_dtype=jnp.float32)
    tr = LLMRunner(tp, tllm.LLMConfig(**cfg._asdict()), ttok,
                   GenerationConfig(lookahead=lookahead, **gen_kw),
                   cache_dtype=torch.float32)
    return jr, tr


def _port(lookahead, max_seq=None, eos_id=None, **gen_kw):
    return _pair(lookahead, max_seq, eos_id, **gen_kw)[1]


def _assert_state_equal(a, b):
    """Two port runners: same text, ids and cache up to its length."""
    assert a._generated_text == b._generated_text
    assert a._generated_ids == b._generated_ids
    assert a._committed_ids == b._committed_ids
    assert a.cache.length == b.cache.length == a._host_len == b._host_len
    n = a.cache.length
    np.testing.assert_allclose(a.cache.k[:, :n].numpy(),
                               b.cache.k[:, :n].numpy(), rtol=0, atol=1e-5)
    np.testing.assert_allclose(a.cache.v[:, :n].numpy(),
                               b.cache.v[:, :n].numpy(), rtol=0, atol=1e-5)


@pytest.mark.parametrize("lookahead", [1, 4])
def test_generate_matches_jax_runner(lookahead):
    jr, tr = _pair(lookahead)
    prompt = "ola, tudo bem? descreva a cena a sua frente"
    assert tr.generate(prompt) == jr.generate(prompt)
    assert tr._generated_ids == jr._generated_ids
    # Follow-up prompt sharing a long prefix: prefix reuse + extend.
    prompt2 = prompt + " com detalhes, por favor"
    extends = []
    orig = tr._extend_ids
    tr._extend_ids = lambda ids: extends.append(len(ids)) or orig(ids)
    assert tr.generate(prompt2) == jr.generate(prompt2)
    assert extends == [len(" com detalhes, por favor")]  # only the delta
    # chat(): first turn prefills, the second extends the cache.
    assert tr.chat("oi") == jr.chat("oi")
    assert tr.chat("e agora?") == jr.chat("e agora?")
    assert tr._committed_ids == jr._committed_ids
    assert tr.cache.length == int(jr.cache.length)


@pytest.mark.parametrize("lookahead", [1, 4])
def test_min_tokens_matches_jax_runner(lookahead):
    probe = _port(1, max_tokens=12)
    probe.generate("ola")
    eos = probe._generated_ids[1]  # would end the reply at its 2nd token
    jr, tr = _pair(lookahead, eos_id=eos, max_tokens=12, min_tokens=6)
    out = tr.generate("ola")
    assert out == jr.generate("ola")
    assert len(tr._generated_ids) >= 6


def test_prime_then_generate_matches_plain():
    a, b = _port(4), _port(4)
    prompt = "ola, tudo bem? descreva a cena a sua frente"
    a.prime(prompt[:20])
    assert a.generate(prompt) == b.generate(prompt)
    assert a._committed_ids == b._committed_ids


# --- k-token lookahead against the port's serial path ----------------------

@pytest.mark.parametrize("max_tokens", [1, 5, 8, 13])
def test_lookahead_matches_serial_at_budget(max_tokens):
    a, b = _port(8, max_tokens=max_tokens), _port(1, max_tokens=max_tokens)
    assert a.generate("ola, tudo bem?") == b.generate("ola, tudo bem?")
    _assert_state_equal(a, b)


def test_eos_mid_chunk_rolls_back():
    probe = _port(1, max_tokens=12)
    probe.generate("ola")
    ids = probe._generated_ids
    eos_pos = next(j for j in range(2, 7) if ids[j] not in ids[:j])
    a = _port(8, eos_id=ids[eos_pos], max_tokens=12)
    b = _port(1, eos_id=ids[eos_pos], max_tokens=12)
    assert a.generate("ola") == b.generate("ola")
    assert len(a._generated_ids) == eos_pos  # stopped before the EOS
    _assert_state_equal(a, b)
    # The conversation continues identically from the rolled-back cache.
    assert a.chat("e agora?") == b.chat("e agora?")
    _assert_state_equal(a, b)


def test_stop_string_mid_chunk():
    probe = _port(1, max_tokens=12)
    probe.generate("ola")
    stop = probe._generated_text[2:4]
    a = _port(8, max_tokens=12, stop_strings=(stop,))
    b = _port(1, max_tokens=12, stop_strings=(stop,))
    ta, tb = a.generate("ola"), b.generate("ola")
    assert ta == tb and stop not in ta
    _assert_state_equal(a, b)
    assert a.chat("mais") == b.chat("mais")
    _assert_state_equal(a, b)


def test_external_cancel_mid_chunk():
    runners = {}
    for k in (8, 1):
        r = _port(k, max_tokens=24)
        seen = []
        r.generate("ola", on_token=seen.append,
                   should_stop=lambda s=seen: len(s) >= 3)
        assert len(seen) == 3
        runners[k] = r
    _assert_state_equal(runners[8], runners[1])


def test_window_tail_falls_back():
    a = _port(8, max_seq=64, max_tokens=48)
    b = _port(1, max_seq=64, max_tokens=48)
    assert a.generate("oi") == b.generate("oi")
    _assert_state_equal(a, b)


# --- sampling ---------------------------------------------------------------

KW = dict(top_k=16, top_p=0.9, min_p=0.05, repetition_penalty=1.3)


def _chain_inputs(seed, v=48):
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal(v) * 2.0).astype(np.float32)
    recent = np.full(8, -1, np.int32)
    recent[:3] = rng.integers(0, v, 3)
    return logits, recent


@pytest.mark.parametrize("seed,temp", [(0, 0.8), (1, 1.5), (2, 0.3)])
def test_process_chain_matches(seed, temp):
    logits, recent = _chain_inputs(seed)
    ref = np.asarray(jsampling._process_chain(
        jnp.asarray(logits), jnp.float32(temp), KW["top_k"], KW["top_p"],
        KW["min_p"], None, jnp.asarray(recent), KW["repetition_penalty"]))
    got = tsampling._process_chain(
        torch.from_numpy(logits), temp, KW["top_k"], KW["top_p"],
        KW["min_p"], None, torch.from_numpy(recent.astype(np.int64)),
        KW["repetition_penalty"]).numpy()
    kept = ref > -1e29
    np.testing.assert_array_equal(got > -1e29, kept)
    np.testing.assert_allclose(got[kept], ref[kept], rtol=1e-6)


@pytest.mark.parametrize("seed,temp", [(0, 0.8), (3, 1.2)])
def test_sample_distribution(seed, temp):
    logits, recent = _chain_inputs(seed)
    lg = np.asarray(jsampling._process_chain(
        jnp.asarray(logits), jnp.float32(temp), KW["top_k"], KW["top_p"],
        KW["min_p"], None, jnp.asarray(recent), KW["repetition_penalty"]),
        np.float64)
    probs = np.exp(lg - lg.max())
    probs /= probs.sum()
    gen = torch.Generator().manual_seed(seed)
    t_logits = torch.from_numpy(logits)
    t_recent = torch.from_numpy(recent.astype(np.int64))
    n = 20000
    draws = np.array([int(tsampling.sample(
        t_logits, gen, temp, recent_tokens=t_recent, **KW))
        for _ in range(n)])
    emp = np.bincount(draws, minlength=len(logits)) / n
    tv = 0.5 * np.abs(emp - probs).sum()
    assert tv < 0.05, tv  # ~0.02 sampling noise at N=20k
    assert set(np.flatnonzero(emp)) <= set(np.flatnonzero(probs))


def test_sampled_generation_is_seeded():
    texts = []
    for _ in range(2):
        r = _port(1, temperature=0.7, max_tokens=16, seed=5)
        texts.append(r.generate("ola"))
    assert texts[0] == texts[1]
    assert 0 < len(r._generated_ids) <= 16


def test_greedy_mask():
    logits = torch.tensor([0.0, 3.0, 1.0])
    assert int(tsampling.greedy(logits)) == 1
    assert int(tsampling.greedy(logits, torch.tensor([1, 0, 1]).bool())) == 2


def test_port_imports_no_jax():
    """The port must run where JAX is absent: importing its runner (with
    its grammar, schema, speculation and sampling modules), its server and
    page pool, fused block, checkpoint reader, model-file readers, GGUF and
    voice and vision converters with their name maps, the voice path (mel,
    resampling, VAD, Whisper, ASR, streaming transcription, TTS, phonemizer,
    TTS engine, VITS), the vision path (preprocessing, NMS, point cloud,
    detector, MiDaS, OCR, DPT, model registry, fusion, scene graph,
    pipeline, navigation engine, free space), logging, CLI, probes,
    diagnostic, conversion and serving tools and chip_smoke.py pulls in no JAX module, no module of the JAX
    package (``trackiellm_tpu`` or ``trackiellm_tpu.*``, even one that imports no
    JAX) and none of the JAX package's tools (this test process has JAX
    loaded already, hence the subprocess)."""
    code = ("import sys, trackiellm_tpu_torch.llm.runner, "
            "trackiellm_tpu_torch.llm.grammar, "
            "trackiellm_tpu_torch.llm.schema, "
            "trackiellm_tpu_torch.llm.speculative, "
            "trackiellm_tpu_torch.llm.sampling, "
            "trackiellm_tpu_torch.models.bridge, "
            "trackiellm_tpu_torch.ops.fused, "
            "trackiellm_tpu_torch.ops.diag, "
            "trackiellm_tpu_torch.models.checkpoint, "
            "trackiellm_tpu_torch.models.loader, "
            "trackiellm_tpu_torch.models.ggml_reader, "
            "trackiellm_tpu_torch.models.onnx_reader, "
            "trackiellm_tpu_torch.models.convert, "
            "trackiellm_tpu_torch.utils.errors, "
            "trackiellm_tpu_torch.utils.logging, "
            "trackiellm_tpu_torch.tools.convert_times, "
            "trackiellm_tpu_torch.tools.diag_overhead, "
            "trackiellm_tpu_torch.tools.diag_scan_overhead, "
            "trackiellm_tpu_torch.tools.diag_envelope, "
            "trackiellm_tpu_torch.tools.kernel_times, "
            "trackiellm_tpu_torch.tools.measure_server, "
            "trackiellm_tpu_torch.llm.server, "
            "trackiellm_tpu_torch.llm.paging, "
            "trackiellm_tpu_torch.ops.mel, "
            "trackiellm_tpu_torch.ops.resample, "
            "trackiellm_tpu_torch.ops.scan, "
            "trackiellm_tpu_torch.ops.conv, "
            "trackiellm_tpu_torch.models.vad, "
            "trackiellm_tpu_torch.models.whisper, "
            "trackiellm_tpu_torch.models.tts, "
            "trackiellm_tpu_torch.models.vits, "
            "trackiellm_tpu_torch.audio.asr, "
            "trackiellm_tpu_torch.audio.streaming_asr, "
            "trackiellm_tpu_torch.audio.phonemizer, "
            "trackiellm_tpu_torch.audio.tts_engine, "
            "trackiellm_tpu_torch.ops.preprocess, "
            "trackiellm_tpu_torch.ops.nms, "
            "trackiellm_tpu_torch.ops.pointcloud, "
            "trackiellm_tpu_torch.models.detector, "
            "trackiellm_tpu_torch.models.depth, "
            "trackiellm_tpu_torch.models.ocr, "
            "trackiellm_tpu_torch.models.dpt, "
            "trackiellm_tpu_torch.models.registry, "
            "trackiellm_tpu_torch.vision, "
            "trackiellm_tpu_torch.vision.object_analysis, "
            "trackiellm_tpu_torch.vision.scene_graph, "
            "trackiellm_tpu_torch.vision.pipeline, "
            "trackiellm_tpu_torch.navigation, "
            "trackiellm_tpu_torch.navigation.path_planner, "
            "trackiellm_tpu_torch.navigation.free_space, "
            "trackiellm_tpu_torch.models.convert as c; "
            "c.load_name_map('silero_v5'); c.load_name_map('piper_vits'); "
            "c.load_name_map('midas_small'); "
            "import trackiellm_tpu_torch.__main__, chip_smoke; "
            "bad = sorted(m for m in sys.modules if m in "
            "('jax', 'jaxlib', 'tools', 'trackiellm_tpu') or m.startswith("
            "('jax.', 'jaxlib.', 'trackiellm_tpu.', 'tools.'))); "
            "print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120,
                          cwd=os.path.dirname(os.path.dirname(
                              os.path.abspath(__file__))))
    assert proc.returncode == 0, proc.stdout + proc.stderr
