"""The multimodal LLM path of the port against the JAX package, on the CPU:
``prefill``/``extend`` with spliced image embeddings, PaliGemma's
prefix-LM prefill (``bidir_len``), ``VLMRunner`` (prefix reuse and
rollback keyed on image digests, prefix-LM sessions), the cortex's
camera-frame prompt and the ``convert``/``generate --image`` CLI.

The tiny LLaVA and PaliGemma are the transformers state dicts of
``tests/test_torch_clip.py`` (a 4-patch CLIP or SigLIP tower; a 2-layer
Llama, or a 2-layer Gemma at head dim 256 with multi-query attention),
converted on both sides.

Tolerances: f32 logits agree to 1e-4 relative L2 (the same products,
sums in another order), Q4 to 2e-2 relative L2 (the port's W4A8
activation quantization against the JAX package's dequantized product on
the CPU); greedy ids, reuse lengths and CLI text are equal.
"""

import logging
import time

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from tests.test_torch_clip import (HEADS, IMG, VHEADS, jax_llava,
                                   jax_paligemma, llava_state,
                                   paligemma_state, pixels, rel_l2,
                                   torch_llava, torch_paligemma)
from trackiellm_tpu.__main__ import main as jmain
from trackiellm_tpu.llm import runner as jrunner
from trackiellm_tpu.llm import vlm as jvlm
from trackiellm_tpu.models import clip as jclip
from trackiellm_tpu.models import llm as jllm
from trackiellm_tpu.utils.errors import TrackieError as JTrackieError
from trackiellm_tpu_torch.__main__ import main as tmain
from trackiellm_tpu_torch.cortex.main import Cortex, CortexConfig
from trackiellm_tpu_torch.llm import runner as trunner
from trackiellm_tpu_torch.llm import vlm as tvlm
from trackiellm_tpu_torch.models import clip as tclip
from trackiellm_tpu_torch.models import llm as tllm
from trackiellm_tpu_torch.utils.errors import TrackieError

CPU = torch.device("cpu")
F32_REL = 1e-4
Q4_REL = 2e-2
N_IMG = (IMG // 8) ** 2          # 4 image rows, CLS dropped
FILLER = 0
IDS = [1, 5, *([FILLER] * N_IMG), 9, 17, 33]   # text, image run, text
START = 2                        # the image run's first row
CONT = [40, 41, 42]              # teacher-forced decode tokens
PROMPT = "sys preamble " * 8 + "<image> q1"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def llava():
    """(JAX bundle, port bundle) of the tiny LLaVA in f32."""
    state = llava_state()
    return jax_llava(state), torch_llava(state)


@pytest.fixture(scope="module")
def paligemma():
    state = paligemma_state()
    return jax_paligemma(state), torch_paligemma(state)


def _spliced(bundle, side: str, ids, bucket: int, lo: int = 0):
    """The padded bucket's embeddings with the image features over rows
    [START, START + N_IMG) that fall inside it."""
    params, _, cp, cc = bundle
    px = pixels()
    padded = np.zeros(bucket, np.int64)
    padded[:len(ids)] = ids
    if side == "jax":
        feats = np.asarray(jclip.encode_and_project(cp, cc,
                                                    jnp.asarray(px)))
        x = np.array(jllm.embed_tokens(params,
                                       jnp.asarray(padded, jnp.int32)))
    else:
        feats = tclip.encode_and_project(cp, cc, torch.from_numpy(px))
        x = tllm.embed_tokens(params, torch.from_numpy(padded))
    a, b = max(START, lo), min(START + N_IMG, lo + bucket)
    if a < b:
        x[a - lo:b - lo] = feats[a - START:b - START]
    return (jnp.asarray(x) if side == "jax" else x), padded


def _jax_prefill(bundle, ids, bucket, **kw):
    params, cfg, _, _ = bundle
    embeds, padded = _spliced(bundle, "jax", ids, bucket)
    cache = jllm.KVCache.create(cfg, dtype=jnp.float32)
    return jllm.prefill(params, cfg, jnp.asarray(padded, jnp.int32),
                        jnp.int32(len(ids)), cache, embeds=embeds, **kw)


def _torch_prefill(bundle, ids, bucket, **kw):
    params, cfg, _, _ = bundle
    embeds, padded = _spliced(bundle, "torch", ids, bucket)
    cache = tllm.KVCache.create(cfg, dtype=torch.float32, device=CPU)
    return tllm.prefill(params, cfg, torch.from_numpy(padded), len(ids),
                        cache, embeds=embeds, **kw)


def _decode_both(jb, tb, jcache, tcache, tokens):
    """Teacher-forced decode steps on both sides; yields the logits."""
    for tid in tokens:
        jl, jcache = jllm.decode_step(jb[0], jb[1], jnp.int32(tid), jcache)
        tl, tcache = tllm.decode_step(tb[0], tb[1], tid, tcache)
        yield np.asarray(jl), tl.numpy()


# --- the model entry points --------------------------------------------------

def test_prefill_with_embeds_and_decode_match_jax(llava):
    jb, tb = llava
    jl, jcache = _jax_prefill(jb, IDS, 16)
    tl, tcache = _torch_prefill(tb, IDS, 16)
    assert rel_l2(tl.numpy(), np.asarray(jl)) < F32_REL
    for want, got in _decode_both(jb, tb, jcache, tcache, CONT):
        assert rel_l2(got, want) < F32_REL
    # The image rows are load-bearing: the raw filler rows give others.
    params, cfg, _, _ = tb
    padded = torch.zeros(16, dtype=torch.long)
    padded[:len(IDS)] = torch.tensor(IDS)
    plain, _ = tllm.prefill(params, cfg, padded, len(IDS),
                            tllm.KVCache.create(cfg, dtype=torch.float32,
                                                device=CPU))
    assert rel_l2(plain.numpy(), tl.numpy()) > 1e-2


def test_extend_with_embeds_across_the_image_run_matches_jax(llava):
    """Two chunks, the image run straddling their boundary."""
    jb, tb = llava
    jcache = jllm.KVCache.create(jb[1], dtype=jnp.float32)
    tcache = tllm.KVCache.create(tb[1], dtype=torch.float32, device=CPU)
    for lo, hi in ((0, 4), (4, len(IDS))):
        chunk = IDS[lo:hi]
        je, jp = _spliced(jb, "jax", chunk, 8, lo)
        te, tp = _spliced(tb, "torch", chunk, 8, lo)
        jl, jcache = jllm.extend(jb[0], jb[1], jnp.asarray(jp, jnp.int32),
                                 jnp.int32(len(chunk)), jcache, embeds=je)
        tl, tcache = tllm.extend(tb[0], tb[1], torch.from_numpy(tp),
                                 len(chunk), tcache, embeds=te)
    assert rel_l2(tl.numpy(), np.asarray(jl)) < F32_REL
    one, _ = _torch_prefill(tb, IDS, 16)
    assert rel_l2(tl.numpy(), one.numpy()) < F32_REL


def test_prefix_lm_prefill_and_decode_match_jax(paligemma):
    """PaliGemma's bidirectional prompt (bidir_len) then 8 causal decode
    tokens; without bidir_len the logits move."""
    jb, tb = paligemma
    n = len(IDS)
    jl, jcache = _jax_prefill(jb, IDS, 16, bidir_len=jnp.int32(n))
    tl, tcache = _torch_prefill(tb, IDS, 16, bidir_len=n)
    assert rel_l2(tl.numpy(), np.asarray(jl)) < F32_REL
    for want, got in _decode_both(jb, tb, jcache, tcache,
                                  [40 + i for i in range(8)]):
        assert rel_l2(got, want) < F32_REL
    causal, _ = _torch_prefill(tb, IDS, 16)
    assert rel_l2(causal.numpy(), tl.numpy()) > 1e-3


def test_prefix_lm_refuses_windowed_configs(paligemma):
    _, tb = paligemma
    params, cfg, _, _ = tb
    windowed = cfg._replace(sliding_window=8)
    cache = tllm.KVCache.create(windowed, dtype=torch.float32, device=CPU)
    with pytest.raises(NotImplementedError, match="plain-attention"):
        tllm.prefill(params, windowed, torch.zeros(16, dtype=torch.long), 10,
                     cache, bidir_len=10)


@pytest.mark.parametrize("family", ["llava", "paligemma"])
def test_q4_spliced_prefill_matches_jax(family):
    state = llava_state() if family == "llava" else paligemma_state()
    if family == "llava":
        jb, tb = jax_llava(state, bits=4), torch_llava(state, bits=4)
        kw_j, kw_t = {}, {}
    else:
        jb, tb = jax_paligemma(state, bits=4), torch_paligemma(state, bits=4)
        kw_j, kw_t = {"bidir_len": jnp.int32(len(IDS))}, {
            "bidir_len": len(IDS)}
    jl, _ = _jax_prefill(jb, IDS, 16, **kw_j)
    tl, _ = _torch_prefill(tb, IDS, 16, **kw_t)
    assert rel_l2(tl.numpy(), np.asarray(jl)) < Q4_REL


# --- VLMRunner ---------------------------------------------------------------

class _Lines(logging.Handler):
    def __init__(self):
        super().__init__(logging.INFO)
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


@pytest.fixture
def reuse_logs():
    """The "multimodal prefix reuse: n/m" lines of both runners."""
    out = {}
    for side, name in (("jax", "trackiellm.llm.vlm"),
                       ("torch", "trackiellm_tpu_torch.llm.vlm")):
        logger, handler = logging.getLogger(name), _Lines()
        out[side] = (logger, handler, logger.level)
        logger.addHandler(handler)
        logger.setLevel(logging.INFO)
    yield {side: h.lines for side, (_, h, _) in out.items()}
    for logger, handler, level in out.values():
        logger.removeHandler(handler)
        logger.setLevel(level)


def _runners(bundles, prefix_lm=False, **gen):
    jb, tb = bundles
    kw = dict(max_tokens=8, temperature=0.0, lookahead=2, **gen)
    jr = jvlm.VLMRunner(*jb, gen_config=jrunner.GenerationConfig(**kw),
                        cache_dtype=jnp.float32, prefix_lm=prefix_lm)
    tr = tvlm.VLMRunner(*tb, gen_config=trunner.GenerationConfig(**kw),
                        cache_dtype=torch.float32, device=CPU,
                        prefix_lm=prefix_lm)
    return jr, tr


def test_runner_turns_match_jax(llava, reuse_logs):
    """The same image (its prefix reused), another image (rolled back to
    before the image run) and a text-only turn: the same greedy ids, the
    same reuse lengths and the same committed image runs as the JAX
    runner's, and a rolled-back turn equal to a fresh runner's."""
    px_a = pixels()
    px_b = np.random.default_rng(7).normal(size=px_a.shape).astype(
        np.float32)
    turns = [(PROMPT, [px_a]), (PROMPT, [px_a]), (PROMPT, [px_b]),
             ("abc plain text question", [])]
    jr, tr = _runners(llava)
    texts = []
    for prompt, images in turns:
        jr.generate(prompt, images=images)
        texts.append(tr.generate(prompt, images=images))
        assert tr.generated_ids == list(jr._generated_ids)
        assert tr._image_runs == jr._image_runs
        assert tr._committed_ids == [int(i) for i in jr._committed_ids]
    reuse = [line for line in reuse_logs["torch"]
             if line.startswith("multimodal")]
    assert reuse == [line for line in reuse_logs["jax"]
                     if line.startswith("multimodal")]
    # Turn 2 reuses past the image run; turn 3 stops just before it.
    n_pre = len(tr.tokenizer.encode(PROMPT.split("<image>")[0],
                                    add_bos=True))
    rows = [int(line.split()[3].split("/")[0]) for line in reuse]
    assert len(rows) == 2 and rows[0] >= n_pre + N_IMG and rows[1] == n_pre
    fresh = _runners(llava)[1]
    assert fresh.generate(PROMPT, images=[px_b]) == texts[2]


def test_marker_count_mismatch_raises(llava):
    jr, tr = _runners(llava)
    with pytest.raises(JTrackieError):
        jr.generate("no marker here", images=[pixels()])
    with pytest.raises(TrackieError, match="markers"):
        tr.generate("no marker here", images=[pixels()])


def test_prefix_lm_runner_matches_jax(paligemma):
    jr, tr = _runners(paligemma, prefix_lm=True)
    for prompt in ("<image> caption en", "<image> answer en what?"):
        jr.generate(prompt, images=[pixels()])
        tr.generate(prompt, images=[pixels()])
        assert tr.generated_ids == list(jr._generated_ids)
        assert tr._host_len == int(jr._host_len)
    tr.prime("ignored")  # a no-op under prefix-LM semantics


def test_frame_digest_and_features_agree_for_a_tensor_and_numpy(llava):
    """A camera frame as a tensor (on the card in the app) and the same
    bytes as numpy: one digest, the same features."""
    frame = np.random.default_rng(2).integers(0, 256, (24, 32, 3)).astype(
        np.uint8)
    t = torch.from_numpy(frame.copy())
    assert tvlm.VLMRunner._digest(t) == tvlm.VLMRunner._digest(frame)
    assert tvlm.VLMRunner._digest(t) == jvlm.VLMRunner._digest(frame)
    other = frame.copy()
    other[0, 0, 0] ^= 1
    assert tvlm.VLMRunner._digest(other) != tvlm.VLMRunner._digest(frame)
    tr = _runners(llava)[1]
    np.testing.assert_array_equal(tr.encode_image(t).numpy(),
                                  tr.encode_image(frame).numpy())
    with pytest.raises(TrackieError):
        tr.encode_image(np.zeros((4, 4), np.uint8))


def test_cortex_turn_attaches_the_frame(llava):
    """A cortex with vlm_scene_image over the port's VLMRunner: a frame
    injected as the camera worker injects it (a tensor) reaches
    encode_image as that tensor, the turn commits an image run and a reply
    comes out."""
    _, tb = llava
    params, cfg, cp, cc = tb
    runner = tvlm.VLMRunner(
        params, cfg._replace(max_seq=2048), cp, cc,
        gen_config=trunner.GenerationConfig(max_tokens=4, temperature=0.0,
                                            lookahead=1),
        cache_dtype=torch.float32, device=CPU)
    seen, encode = [], runner.encode_image
    runner.encode_image = lambda image: (seen.append(image), encode(image))[1]
    responses = []
    c = Cortex(llm_runner=runner,
               config=CortexConfig(vlm_scene_image=True, system_prompt="s"),
               on_response=responses.append)
    c.run()
    frame = torch.from_numpy(np.random.default_rng(2).integers(
        0, 255, (24, 32, 3)).astype(np.uint8))
    c.inject_video_frame(frame)
    c.inject_user_text("oi")
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline and not responses:
        time.sleep(0.05)
    c.stop(timeout=5.0)
    assert responses, "no reply produced"
    assert runner._image_runs, "image run not committed to cache"
    assert len(seen) == 1 and seen[0] is frame


# --- the CLI -----------------------------------------------------------------

@pytest.mark.parametrize("family", ["llava-hf", "paligemma-hf"])
def test_convert_then_generate_image_matches_the_jax_cli(tmp_path, capsys,
                                                          family):
    """``convert --family llava-hf|paligemma-hf`` then ``generate
    --image``: the same text from both packages' CLIs."""
    state = llava_state() if family == "llava-hf" else paligemma_state()
    src = tmp_path / "state.npz"
    np.savez(src, **state)
    heads = ["--n-heads", str(HEADS)] if family == "llava-hf" else []
    img = np.random.default_rng(5).integers(0, 255, (24, 32, 3)).astype(
        np.uint8)
    np.save(tmp_path / "frame.npy", img)
    outs = {}
    for side, main, dev in (("jax", jmain, []),
                            ("torch", tmain, ["--device", "cpu"])):
        ckpt = str(tmp_path / side)
        assert main(["convert", str(src), "-o", ckpt, "--family", family,
                     "--bits", "0", "--vision-n-heads", str(VHEADS), *heads,
                     *dev]) == 0
        capsys.readouterr()
        assert main(["generate", ckpt, "-p", "what is this? <image>",
                     "--max-tokens", "4", "--temperature", "0", "--image",
                     str(tmp_path / "frame.npy"), *dev]) == 0
        outs[side] = capsys.readouterr().out
    assert outs["torch"] == outs["jax"] and outs["jax"].strip()
