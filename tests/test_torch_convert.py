"""The port's GGUF conversion against the JAX package's, on the CPU.

GGUF files are written in the test (``tests/test_loader.py:write_gguf``)
from seeded numpy weights, one per arch branch of ``gguf_to_llm_params``,
and each goes through both packages' converters: ``config_from_gguf`` gives
an equal ``_asdict()``, ``tokenizer_spec_from_gguf`` an equal spec, and
``gguf_to_llm_params`` at bits 0, 4 and 8 (``device=cpu``) the same tree
with the same bytes in every leaf, through ``models/bridge.py``'s mapping.
The ``convert`` command of both CLIs writes the same checkpoint files, and
a converted model's logits agree with the JAX package's within
``tests/test_torch_llm.py``'s ATOL. llama.cpp's permuted q/k layout is
folded back as the JAX package folds it, pinned against a transformers
Llama. Conversion without a card raises unless the CPU is asked for.
"""

import json
import os

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from tests.test_loader import permute_llama_qk, write_gguf
from tests.test_torch_llm import ATOL
from trackiellm_tpu.__main__ import main as jmain
from trackiellm_tpu.llm import runner as jrunner
from trackiellm_tpu.models import checkpoint as jckpt
from trackiellm_tpu.models import convert as jconv
from trackiellm_tpu.models import llm as jllm
from trackiellm_tpu.models import loader as jload
from trackiellm_tpu_torch import __main__ as tmain_module
from trackiellm_tpu_torch.__main__ import main as tmain
from trackiellm_tpu_torch.models import checkpoint as tckpt
from trackiellm_tpu_torch.models import convert as tconv
from trackiellm_tpu_torch.models import llm as tllm
from trackiellm_tpu_torch.models import loader as tload
from trackiellm_tpu_torch.models.bridge import params_from_jax
from trackiellm_tpu_torch.utils.errors import ErrorCode, TrackieError

CPU = torch.device("cpu")
F32, F16 = jload.GGML_F32, jload.GGML_F16
DIM, LAYERS, HEADS, KV, HID, VOCAB = 64, 2, 4, 2, 128, 96
HD = DIM // HEADS
QD, KVD = HEADS * HD, KV * HD
EXPERTS = 4
GROUP = 32   # divides every K/2 of these shapes


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes: one intra-op thread, so this file does not crowd the
    other test workers' CPUs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --- fixtures: one GGUF per arch branch --------------------------------------

# Per arch: the tensors and metadata its branch of the converters reads.
ARCHES = {
    "llama": {},
    "llama_tied": {"arch": "llama", "tied": True},
    "llama_rope_freqs": {"arch": "llama", "rope_freqs": True},
    "llama_yarn": {"arch": "llama", "meta": {
        "llama.rope.scaling.type": "yarn", "llama.rope.scaling.factor": 4.0,
        "llama.rope.scaling.original_context_length": 32,
        "llama.rope.scaling.attn_factor": 1.5}},
    "llama_linear": {"arch": "llama", "meta": {
        "llama.rope.scaling.type": "linear",
        "llama.rope.scaling.factor": 2.0}},
    "mistral_quantized": {"arch": "llama", "types": "quantized"},
    "qwen2": {"qkv_bias": True},
    "qwen3": {"qk_norm": "head"},
    "phi3": {"fused": True, "meta": {
        "phi3.rope.scaling.original_context_length": 32},
        "longrope": True},
    "gemma2": {"post_norms": True, "meta": {
        "gemma2.attn_logit_softcapping": 40.0,
        "gemma2.final_logit_softcapping": 20.0}},
    "gemma3": {"post_norms": True, "qk_norm": "head"},
    "granite": {"meta": {"granite.residual_scale": 0.25,
                         "granite.attention.scale": 0.125,
                         "granite.embedding_scale": 12.0,
                         "granite.logit_scale": 8.0}},
    "command-r": {"no_ffn_norm": True, "qk_norm": "head",
                  "meta": {"command-r.logit_scale": 0.0625}},
    "cohere2": {"no_ffn_norm": True, "meta": {
        "cohere2.attention.sliding_window_pattern": 4}},
    "olmo2": {"no_pre_norms": True, "post_norms": True, "qk_norm": "full"},
    "glm4": {"post_norms": True, "qkv_bias": True,
             "meta": {"glm4.rope.dimension_count": HD // 2}},
    "nemotron": {"ungated": True, "norm_bias": True,
                 "meta": {"nemotron.rope.dimension_count": HD // 2}},
    "starcoder2": {"ungated": True, "norm_bias": True, "qkv_bias": True,
                   "mlp_bias": True, "out_bias": True},
    "smollm3": {"meta": {"smollm3.no_rope_layer_interval": 2}},
    "mixtral": {"arch": "llama", "experts": True},
    "qwen2moe": {"experts": True, "shared": True},
    "gpt-oss": {"experts": True, "moe_bias": True, "sinks": True,
                "qkv_bias": True, "out_bias": True},
    "gpt-oss_mxfp4": {"arch": "gpt-oss", "experts": "mxfp4",
                      "moe_bias": True, "sinks": True, "qkv_bias": True,
                      "out_bias": True},
    "qwen3moe": {"experts": True, "qk_norm": "head"},
}


def _mxfp4(rng, shape):
    """Random MXFP4 blocks (ggml type 39: an e8m0 scale byte and 16 bytes
    of e2m1 nibbles a 32-block along the last axis) as raw GGUF data."""
    n_blocks = int(np.prod(shape)) // 32
    scales = rng.integers(118, 126, (n_blocks, 1)).astype(np.uint8)
    nibbles = rng.integers(0, 256, (n_blocks, 16)).astype(np.uint8)
    return (np.concatenate([scales, nibbles], axis=1).reshape(-1),
            jload.GGML_MXFP4, shape)


def _arch_gguf(path, name, seed=0, widths=None, **overrides):
    """Write the GGUF of ``ARCHES[name]`` (its keys replaced by
    ``overrides``); returns its arch string. ``widths``: (dim, layers,
    heads, kv heads, hidden, vocab), by default the module's; a partial
    rotary stays half the head dim."""
    dim, layers, heads, kv, hid, vocab = widths or (DIM, LAYERS, HEADS, KV,
                                                   HID, VOCAB)
    hd = dim // heads
    qd, kvd = heads * hd, kv * hd
    spec = dict(ARCHES[name], **overrides)
    arch = spec.get("arch", name)
    rng = np.random.default_rng(seed)

    def m(*shape):
        return (rng.standard_normal(shape) / np.sqrt(shape[-1])
                ).astype(np.float32)

    def vec(n, around=0.0):
        return (around + 0.1 * rng.standard_normal(n)).astype(np.float32)

    quantized = spec.get("types") == "quantized"

    def mat(*shape):
        # F32, or Q8_0 / Q4_0 / F16 in turn for the quantized file
        if not quantized:
            return m(*shape), F32
        mat.turn = (getattr(mat, "turn", -1) + 1) % 3
        return m(*shape), (jload.GGML_Q8_0, jload.GGML_Q4_0, F16)[mat.turn]

    t = {"token_embd.weight": (m(vocab, dim) * 0.2, F32),
         "output_norm.weight": (vec(dim, 1.0), F32)}
    if spec.get("norm_bias"):
        t["output_norm.bias"] = (vec(dim), F32)
    if not spec.get("tied"):
        t["output.weight"] = mat(vocab, dim)
    for i in range(layers):
        p = f"blk.{i}"
        if not spec.get("no_pre_norms"):
            t[f"{p}.attn_norm.weight"] = (vec(dim, 1.0), F32)
            if not spec.get("no_ffn_norm"):
                t[f"{p}.ffn_norm.weight"] = (vec(dim, 1.0), F32)
            if spec.get("norm_bias"):
                t[f"{p}.attn_norm.bias"] = (vec(dim), F32)
                t[f"{p}.ffn_norm.bias"] = (vec(dim), F32)
        if spec.get("post_norms"):
            t[f"{p}.post_attention_norm.weight"] = (vec(dim, 1.0), F32)
            t[f"{p}.post_ffw_norm.weight"] = (vec(dim, 1.0), F32)
        if spec.get("qk_norm") == "head":
            t[f"{p}.attn_q_norm.weight"] = (vec(hd, 1.0), F32)
            t[f"{p}.attn_k_norm.weight"] = (vec(hd, 1.0), F32)
        elif spec.get("qk_norm") == "heads":  # Command-R+: a row a head
            t[f"{p}.attn_q_norm.weight"] = (vec(qd, 1.0), F32)
            t[f"{p}.attn_k_norm.weight"] = (vec(kvd, 1.0), F32)
        elif spec.get("qk_norm") == "full":
            t[f"{p}.attn_q_norm.weight"] = (vec(qd, 1.0), F32)
            t[f"{p}.attn_k_norm.weight"] = (vec(kvd, 1.0), F32)
        if spec.get("fused"):
            t[f"{p}.attn_qkv.weight"] = mat(qd + 2 * kvd, dim)
        else:
            t[f"{p}.attn_q.weight"] = mat(qd, dim)
            t[f"{p}.attn_k.weight"] = mat(kvd, dim)
            t[f"{p}.attn_v.weight"] = mat(kvd, dim)
        if spec.get("qkv_bias"):
            t[f"{p}.attn_q.bias"] = (vec(qd), F32)
            t[f"{p}.attn_k.bias"] = (vec(kvd), F32)
            t[f"{p}.attn_v.bias"] = (vec(kvd), F32)
        t[f"{p}.attn_output.weight"] = mat(dim, qd)
        if spec.get("out_bias"):
            t[f"{p}.attn_output.bias"] = (vec(dim), F32)
        if spec.get("sinks"):
            t[f"{p}.attn_sinks.weight"] = (vec(heads), F32)
        if spec.get("experts"):
            bank = ((lambda *shape: _mxfp4(rng, shape))
                    if spec["experts"] == "mxfp4"
                    else (lambda *shape: (m(*shape), F32)))
            t[f"{p}.ffn_gate_inp.weight"] = (m(EXPERTS, dim), F32)
            t[f"{p}.ffn_gate_exps.weight"] = bank(EXPERTS, hid, dim)
            t[f"{p}.ffn_up_exps.weight"] = bank(EXPERTS, hid, dim)
            t[f"{p}.ffn_down_exps.weight"] = bank(EXPERTS, dim, hid)
            if spec.get("moe_bias"):
                t[f"{p}.ffn_gate_inp.bias"] = (vec(EXPERTS), F32)
                t[f"{p}.ffn_gate_exps.bias"] = (m(EXPERTS, hid), F32)
                t[f"{p}.ffn_up_exps.bias"] = (m(EXPERTS, hid), F32)
                t[f"{p}.ffn_down_exps.bias"] = (m(EXPERTS, dim), F32)
            if spec.get("shared"):
                t[f"{p}.ffn_gate_shexp.weight"] = mat(hid, dim)
                t[f"{p}.ffn_up_shexp.weight"] = mat(hid, dim)
                t[f"{p}.ffn_down_shexp.weight"] = mat(dim, hid)
                t[f"{p}.ffn_gate_inp_shexp.weight"] = (m(1, dim), F32)
        elif spec.get("fused"):
            t[f"{p}.ffn_up.weight"] = mat(2 * hid, dim)
            t[f"{p}.ffn_down.weight"] = mat(dim, hid)
        else:
            if not spec.get("ungated"):
                t[f"{p}.ffn_gate.weight"] = mat(hid, dim)
            t[f"{p}.ffn_up.weight"] = mat(hid, dim)
            t[f"{p}.ffn_down.weight"] = mat(dim, hid)
        if spec.get("mlp_bias"):
            t[f"{p}.ffn_up.bias"] = (vec(hid), F32)
            t[f"{p}.ffn_down.bias"] = (vec(dim), F32)
    if spec.get("rope_freqs"):
        t["rope_freqs.weight"] = (np.linspace(1.0, 8.0, hd // 2,
                                              dtype=np.float32), F32)
    if spec.get("longrope"):
        t["rope_factors_short.weight"] = (vec(hd // 2, 1.0), F32)
        t["rope_factors_long.weight"] = (vec(hd // 2, 2.0), F32)
    meta = {
        "general.architecture": arch,
        "general.name": f"tiny-{name}",
        f"{arch}.embedding_length": dim,
        f"{arch}.block_count": layers,
        f"{arch}.attention.head_count": heads,
        f"{arch}.attention.head_count_kv": kv,
        f"{arch}.feed_forward_length": hid,
        f"{arch}.context_length": 128,
        f"{arch}.attention.layer_norm_rms_epsilon": 1e-5,
        f"{arch}.rope.freq_base": 10000.0,
        f"{arch}.vocab_size": vocab,
    }
    if spec.get("experts"):
        meta.update({f"{arch}.expert_count": EXPERTS,
                     f"{arch}.expert_used_count": 2})
        if spec.get("shared"):
            meta[f"{arch}.expert_shared_feed_forward_length"] = hid
    meta.update(spec.get("meta", {}))
    for key in meta:
        if key.endswith(".rope.dimension_count"):
            meta[key] = hd // 2
    write_gguf(path, t, metadata=meta)
    return arch


_FILES = {}


def _gguf(tmp_path_factory, name):
    """The fixture file of ``name``, written once per test process."""
    if name not in _FILES:
        path = str(tmp_path_factory.mktemp("gguf") / f"{name}.gguf")
        _arch_gguf(path, name)
        _FILES[name] = path
    return _FILES[name]


# --- comparisons ---------------------------------------------------------------

def _leaves(tree, prefix=""):
    """(path, (dtype name, bytes)) of every array of a port tree."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}.{k}")
    elif hasattr(tree, "values") and hasattr(tree, "scales"):
        yield from _leaves(tree.values, prefix + ".values")
        yield from _leaves(tree.scales, prefix + ".scales")
    else:
        t = tree.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            yield prefix, ("bfloat16", t.view(torch.int16).numpy().tobytes())
        else:
            yield prefix, (str(t.dtype), t.numpy().tobytes())


def _assert_same_tree(port, jax_tree):
    want, got = dict(_leaves(params_from_jax(jax_tree))), dict(_leaves(port))
    assert list(got) == list(want)
    for name, leaf in want.items():
        assert got[name] == leaf, name


@pytest.mark.parametrize("name", sorted(ARCHES))
def test_config_from_gguf_matches(tmp_path_factory, name):
    path = _gguf(tmp_path_factory, name)
    want = jconv.config_from_gguf(jload.read_gguf_header(path))
    got = tconv.config_from_gguf(tload.read_gguf_header(path))
    assert isinstance(got, tllm.LLMConfig)
    assert got._asdict() == want._asdict()


@pytest.mark.parametrize("bits", [0, 4, 8])
@pytest.mark.parametrize("name", sorted(ARCHES))
def test_gguf_to_llm_params_gives_the_jax_bytes(tmp_path_factory, name, bits):
    path = _gguf(tmp_path_factory, name)
    jp, jcfg = jconv.gguf_to_llm_params(path, bits=bits or None, group=GROUP)
    tp, tcfg = tconv.gguf_to_llm_params(path, bits=bits or None, group=GROUP,
                                        device=CPU)
    assert tcfg._asdict() == jcfg._asdict()
    _assert_same_tree(tp, jp)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dtype_and_truncation_match(tmp_path_factory, dtype):
    path = _gguf(tmp_path_factory, "qwen2")
    jp, jcfg = jconv.gguf_to_llm_params(path, bits=None, max_layers=1,
                                        dtype=getattr(jnp, dtype))
    tp, tcfg = tconv.gguf_to_llm_params(path, bits=None, max_layers=1,
                                        dtype=getattr(torch, dtype),
                                        device=CPU)
    assert tcfg.n_layers == jcfg.n_layers == 1
    _assert_same_tree(tp, jp)


def test_conversion_needs_a_card_or_an_explicit_cpu(tmp_path_factory,
                                                    monkeypatch, tmp_path):
    """The requantization runs on the card by default; with none it raises
    and does not fall back to the CPU."""
    path = _gguf(tmp_path_factory, "llama")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(TrackieError, match="device=torch.device") as err:
        tconv.gguf_to_llm_params(path, bits=4, group=GROUP)
    assert err.value.code == ErrorCode.DEVICE_UNAVAILABLE
    with pytest.raises(SystemExit, match="--device cpu"):
        tmain(["convert", path, "-o", str(tmp_path / "ckpt")])
    assert not (tmp_path / "ckpt").exists()


# --- the fold of llama.cpp's permuted q/k -------------------------------------

def test_deinterleave_matches(tmp_path):
    w = np.random.default_rng(4).standard_normal((8, 3 * 16)).astype(
        np.float32)
    for rot in (16, 8):
        assert np.array_equal(tconv._deinterleave_rope_cols(w, 3, 16, rot),
                              jconv._deinterleave_rope_cols(w, 3, 16, rot))
    # It inverts llama.cpp's permute of (out, in) q rows.
    q = np.random.default_rng(5).standard_normal((QD, DIM)).astype(np.float32)
    folded = tconv._deinterleave_rope_cols(
        np.ascontiguousarray(permute_llama_qk(q, HEADS).T), HEADS, HD, HD)
    assert np.array_equal(folded, q.T)


class TestLlamaGGUFRopeLayout:
    """A llama-arch GGUF carries q/k permuted into ggml's NORM-rope layout;
    the port folds it back as the JAX package does
    (``tests/test_convert.py::TestLlamaGGUFRopeLayout``): its converted
    params equal the JAX package's byte for byte, and its logits follow a
    transformers Llama oracle; with ``TRACKIE_LLAMA_GGUF_ROPE=hf`` both
    packages skip the fold and the logits leave the oracle."""

    def _oracle(self):
        from transformers import LlamaConfig, LlamaForCausalLM

        torch.manual_seed(31)
        hf_cfg = LlamaConfig(
            vocab_size=VOCAB, hidden_size=DIM, intermediate_size=HID,
            num_hidden_layers=LAYERS, num_attention_heads=HEADS,
            num_key_value_heads=KV, max_position_embeddings=64,
            rope_theta=10000.0, rms_norm_eps=1e-6,
            attention_bias=False, attention_dropout=0.0,
            tie_word_embeddings=False)
        hf_cfg._attn_implementation = "eager"
        model = LlamaForCausalLM(hf_cfg).eval()
        tokens = torch.randint(0, VOCAB, (1, 14),
                               generator=torch.Generator().manual_seed(7))
        with torch.no_grad():
            ref = model(tokens).logits[0].numpy()
        state = {k: v.numpy() for k, v in model.state_dict().items()}
        return state, tokens[0].numpy(), ref

    def _write(self, path, state):
        from tests.test_convert import TestLlamaGGUFRopeLayout as J
        J._write(None, path, state)

    def _convert(self, path):
        jp, jcfg = jconv.gguf_to_llm_params(path, bits=None,
                                            dtype=jnp.float32)
        tp, tcfg = tconv.gguf_to_llm_params(path, bits=None,
                                            dtype=torch.float32, device=CPU)
        _assert_same_tree(tp, jp)
        return tp, tcfg

    def _logits(self, params, cfg, tokens, n, steps):
        cache = tllm.KVCache.create(cfg, torch.float32, device="cpu")
        logits, cache = tllm.prefill(
            params, cfg, torch.from_numpy(tokens[:n].astype(np.int64)), n,
            cache)
        out = [logits.numpy()]
        for j in range(steps):
            logits, cache = tllm.decode_step(params, cfg,
                                             int(tokens[n + j]), cache)
            out.append(logits.numpy())
        return out

    def test_permuted_gguf_matches_oracle(self, tmp_path):
        state, tokens, ref = self._oracle()
        path = str(tmp_path / "llama_real_layout.gguf")
        self._write(path, state)
        params, cfg = self._convert(path)
        n = 11
        for j, logits in enumerate(self._logits(params, cfg, tokens, n, 2)):
            np.testing.assert_allclose(logits, ref[n - 1 + j], rtol=2e-3,
                                       atol=2e-3)

    def test_fold_is_load_bearing(self, tmp_path, monkeypatch):
        state, tokens, ref = self._oracle()
        path = str(tmp_path / "llama_real_layout.gguf")
        self._write(path, state)
        monkeypatch.setenv("TRACKIE_LLAMA_GGUF_ROPE", "hf")
        params, cfg = self._convert(path)
        logits = self._logits(params, cfg, tokens, 11, 0)[0]
        assert not np.allclose(logits, ref[10], atol=2e-3)


def test_yarn_rope_factors_match():
    cfg = jllm.LLMConfig.tiny()._replace(head_dim=128, rope_theta=1e6)
    for factor, orig, truncate in ((4.0, 4096, True), (32.0, 2048, False),
                                   (8.0, 64, True)):
        want = np.asarray(jllm.yarn_rope_factors(cfg, factor, orig,
                                                 truncate=truncate))
        got = tllm.yarn_rope_factors(tllm.LLMConfig(**cfg._asdict()), factor,
                                     orig, truncate=truncate)
        assert got.dtype == torch.float32
        assert got.numpy().tobytes() == want.tobytes()
        assert (tllm.yarn_attention_factor(factor)
                == jllm.yarn_attention_factor(factor))
    assert tllm.yarn_attention_factor(1.0) == 1.0


# --- tokenizers ------------------------------------------------------------------

def _vocab_header(tmp_path, kind):
    """A GGUF header whose metadata holds an spm or a gpt2 vocabulary."""
    path = str(tmp_path / f"{kind}.gguf")
    _arch_gguf(path, "llama")
    header_j, header_t = jload.read_gguf_header(path), tload.read_gguf_header(
        path)
    if kind == "spm":
        md = {"tokenizer.ggml.model": "llama",
              "tokenizer.ggml.tokens": ["<unk>", "<s>", "</s>", "▁hello",
                                        "▁world", "!", "▁", "h", "e", "l",
                                        "o"],
              "tokenizer.ggml.scores": [0.0, 0.0, 0.0, -1.0, -2.0, -3.0,
                                        -4.0, -5.0, -6.0, -7.0, -8.0],
              "tokenizer.ggml.token_type": [2, 3, 3] + [1] * 8,
              "tokenizer.ggml.padding_token_id": 0,
              "tokenizer.ggml.add_space_prefix": False}
    else:
        md = {"tokenizer.ggml.model": "gpt2",
              "tokenizer.ggml.tokens": ["h", "e", "l", "o", "he", "ll",
                                        "hell", "hello", "Ġ", "<|eot|>"],
              "tokenizer.ggml.merges": ["h e", "l l", "he ll", "hell o"],
              "tokenizer.ggml.pre": "llama-bpe",
              "tokenizer.ggml.token_type": [1] * 9 + [3],
              "tokenizer.ggml.bos_token_id": 9,
              "tokenizer.ggml.eos_token_id": 9}
    header_j.metadata.update(md)
    header_t.metadata.update(md)
    return header_j, header_t


@pytest.mark.parametrize("kind", ["spm", "gpt2"])
def test_tokenizer_spec_from_gguf_matches(tmp_path, kind):
    header_j, header_t = _vocab_header(tmp_path, kind)
    spec = tconv.tokenizer_spec_from_gguf(header_t)
    assert spec == jconv.tokenizer_spec_from_gguf(header_j)
    assert spec["model"] == kind
    want = jconv.tokenizer_from_gguf(header_j)
    got = tconv.tokenizer_from_gguf(header_t)
    for text in ("hello world!", " hello hello", "hell o"):
        assert got.encode(text) == want.encode(text)
        assert got.decode(got.encode(text)) == want.decode(want.encode(text))


def test_no_vocab_gives_no_tokenizer(tmp_path_factory):
    path = _gguf(tmp_path_factory, "llama")
    assert tconv.tokenizer_spec_from_gguf(tload.read_gguf_header(path)) is None
    assert tconv.tokenizer_from_gguf(tload.read_gguf_header(path)) is None


@pytest.mark.parametrize("strict", ["0", "1"])
def test_math_key_matches(monkeypatch, strict):
    monkeypatch.setenv("TRACKIE_GGUF_STRICT", strict)
    md = {"a.gating": 2}
    assert tconv._math_key(md, "a.gating", 1) == 2
    if strict == "1":
        for fn in (tconv._math_key, jconv._math_key):
            with pytest.raises(Exception, match="TRACKIE_GGUF_STRICT=1"):
                fn(md, "a.norm", True, "a guess")
    else:
        assert (tconv._math_key(md, "a.norm", True, "a guess")
                == jconv._math_key(md, "a.norm", True, "a guess") is True)


# --- the CLI: convert, then generate ------------------------------------------

# Widths whose K/2 the default group 256 divides (the CLI's group).
CLI_DIM, CLI_HEADS, CLI_KV, CLI_HD, CLI_HID, CLI_VOCAB = 512, 4, 2, 128, 1024, 384


def _spm_metadata(vocab):
    pieces = ["<unk>", "<s>", "</s>"] + [f"<0x{b:02X}>" for b in range(256)]
    words = ["▁"] + [chr(c) for c in range(ord("a"), ord("z") + 1)]
    words += [f"▁{a}" for a in "abcdefghijklmnopqrstuvwxyz"]
    words += [f"▁w{i}" for i in range(vocab - len(pieces) - len(words))]
    return {"tokenizer.ggml.model": "llama",
            "tokenizer.ggml.tokens": pieces + words,
            "tokenizer.ggml.scores": [0.0] * 259
            + [-float(i) for i in range(len(words))],
            "tokenizer.ggml.token_type": [2, 3, 3] + [6] * 256
            + [1] * len(words)}


@pytest.fixture(scope="module")
def cli_gguf(tmp_path_factory):
    """A 2-layer llama GGUF at widths the default group takes, with F32,
    F16, Q8_0 and Q4_0 tensors and an spm vocabulary."""
    rng = np.random.default_rng(0)

    def m(r, c):
        return (rng.standard_normal((r, c)) / np.sqrt(c)).astype(np.float32)

    def norm():
        return (1 + 0.1 * rng.standard_normal(CLI_DIM)).astype(np.float32)
    qd, kvd = CLI_HEADS * CLI_HD, CLI_KV * CLI_HD
    t = {"token_embd.weight": (m(CLI_VOCAB, CLI_DIM) * 0.2, F32),
         "output_norm.weight": (norm(), F32),
         "output.weight": (m(CLI_VOCAB, CLI_DIM), F16)}
    for i in range(2):
        p = f"blk.{i}"
        t[f"{p}.attn_norm.weight"] = (norm(), F32)
        t[f"{p}.ffn_norm.weight"] = (norm(), F32)
        t[f"{p}.attn_q.weight"] = (m(qd, CLI_DIM), jload.GGML_Q8_0)
        t[f"{p}.attn_k.weight"] = (m(kvd, CLI_DIM), jload.GGML_Q4_0)
        t[f"{p}.attn_v.weight"] = (m(kvd, CLI_DIM), F16)
        t[f"{p}.attn_output.weight"] = (m(CLI_DIM, qd), F32)
        t[f"{p}.ffn_gate.weight"] = (m(CLI_HID, CLI_DIM), F32)
        t[f"{p}.ffn_up.weight"] = (m(CLI_HID, CLI_DIM), F32)
        t[f"{p}.ffn_down.weight"] = (m(CLI_DIM, CLI_HID), F32)
    path = str(tmp_path_factory.mktemp("cli") / "model.gguf")
    write_gguf(path, t, metadata={
        "general.architecture": "llama", "llama.embedding_length": CLI_DIM,
        "llama.block_count": 2, "llama.attention.head_count": CLI_HEADS,
        "llama.attention.head_count_kv": CLI_KV,
        "llama.feed_forward_length": CLI_HID, "llama.context_length": 256,
        "llama.rope.freq_base": 10000.0,
        "llama.attention.layer_norm_rms_epsilon": 1e-5,
        **_spm_metadata(CLI_VOCAB)})
    return path


def _widen(tree):
    """bf16 leaves to f32 (exact); quantized leaves as they are."""
    if isinstance(tree, dict):
        return {k: _widen(v) for k, v in tree.items()}
    if hasattr(tree, "values") and hasattr(tree, "scales"):
        return tree
    if isinstance(tree, torch.Tensor):
        return tree.float()
    return jnp.asarray(tree, jnp.float32)


@pytest.mark.parametrize("bits", ["0", "4", "8"])
def test_convert_then_generate_matches_the_jax_cli(cli_gguf, tmp_path, bits,
                                                   capsys):
    """Both CLIs' ``convert`` write the same checkpoint files; on it the
    port's logits agree with the JAX package's within ATOL. The converted
    model's bf16 leaves are widened to f32 on both sides (exact), as
    ``tests/test_torch_llm.py`` runs f32: bf16 activations round apart
    wherever the two sum in another order."""
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    assert jmain(["convert", cli_gguf, "-o", jdir, "--bits", bits]) == 0
    assert tmain(["convert", cli_gguf, "-o", tdir, "--bits", bits,
                  "--device", "cpu"]) == 0
    assert "converted + saved to" in capsys.readouterr().out
    for name in ("tree.json", "config.json"):
        with open(os.path.join(jdir, name)) as a, \
                open(os.path.join(tdir, name)) as b:
            assert a.read() == b.read(), name
    with np.load(os.path.join(jdir, "arrays.npz")) as a, \
            np.load(os.path.join(tdir, "arrays.npz")) as b:
        assert a.files == b.files
        for k in a.files:
            assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes()
    meta = json.loads(open(os.path.join(tdir, "config.json")).read())
    assert meta["metadata"]["tokenizer_spec"]["model"] == "spm"

    jp, jcfg, _ = jckpt.load_checkpoint(jdir, device_put=False)
    tp, tcfg, _ = tckpt.load_checkpoint(tdir, device=CPU)
    toks = np.random.default_rng(int(bits)).integers(
        0, CLI_VOCAB, 40).astype(np.int32)
    jl, _ = jllm.prefill(_widen(jp), jcfg, jnp.asarray(toks), jnp.int32(40),
                         jllm.KVCache.create(jcfg, dtype=jnp.float32))
    tl, _ = tllm.prefill(_widen(tp), tcfg, torch.from_numpy(
        toks.astype(np.int64)), 40, tllm.KVCache.create(tcfg, torch.float32, device="cpu"))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=ATOL)
    assert tmain(["generate", tdir, "-p", "ola mundo", "--max-tokens", "8",
                  "--device", "cpu"]) == 0
    assert capsys.readouterr().out.strip()


# The dense arches whose convert and generate the CLIs are held to at the
# CLI's widths (group 256): a bias on q/k/v, sandwich norms and softcaps,
# rope_freqs, fused QKV with longrope, Command-R's parallel residual with
# per-head LayerNorm QK norms, StarCoder2's biased LayerNorms and ungated
# GELU MLP, Nemotron's squared ReLU with a partial rotary.
CLI_ARCHES = ("qwen2", "gemma2", "llama_rope_freqs", "phi3", "command-r",
              "starcoder2", "nemotron")


def _forced_logits(llm, params, cfg, cache, prompt, ids, runner, as_ids):
    """Logits (f32 numpy) of the prompt's prefill at the runner's first
    bucket, then of a decode step on each of ``ids`` but the last: the
    runner's greedy path, teacher-forced along ``ids``."""
    bucket = 64
    pad = np.zeros(bucket, np.int64)
    pad[:len(prompt)] = prompt
    out = []
    logits, cache = llm.prefill(params, cfg, as_ids(pad), len(prompt), cache)
    for step, tok in enumerate(ids):
        out.append(np.asarray(logits.float() if isinstance(logits, torch.Tensor)
                              else logits, np.float32))
        if step + 1 < len(ids):
            logits, cache = llm.decode_step(
                params, cfg, tok, cache,
                attn_len=runner._attn_bucket_for(len(prompt) + step + 1))
    return out


# The bf16 CLI path's largest logit gap between the packages, teacher-forced
# along the JAX ids, over the largest |JAX logit|: measured 1.09e-2 to
# 1.63e-2 over CLI_ARCHES, about two bf16 steps (2^-7 of the value), held
# under four. Embeddings cast through float8 e4m3 in the port's bf16 path
# alone give 5.3e-2 to 1.46e-1.
BF16_NOISE = 0.03


def _top2_margin(row):
    top = np.sort(row)[-2:]
    return float(top[1] - top[0])


@pytest.mark.parametrize("name", CLI_ARCHES)
def test_convert_then_generate_dense_arches_match_the_jax_cli(
        tmp_path, name, capsys, monkeypatch):
    """A 2-layer GGUF of each dense arch at the CLI's widths: both CLIs'
    ``convert --bits 4`` write the same checkpoint files, and greedy
    ``generate`` on it prints the JAX CLI's text, unless the ids part at a
    near-tie.

    The CLI decodes with bf16 activations and cache, where the two
    packages' sums in another order round activations apart: teacher-forced
    along the JAX ids, the bf16 logits differ by a noise of about two bf16
    steps of the largest logit (5.08e-2 on qwen2), held under BF16_NOISE,
    while the f32-widened logits agree within ATOL at
    every step. So the ids are held equal up to the step where they first
    part, if they do; that step's JAX top-2 margin must be under twice the
    noise, a near-tie that either side may break, and the port's pick must
    lie within twice the noise of the JAX top logit there. Ids that never
    part give the JAX CLI's text."""
    path = str(tmp_path / f"{name}.gguf")
    # Command-R+'s per-head LayerNorm weights: H * head_dim a layer.
    _arch_gguf(path, name, seed=3,
               widths=(CLI_DIM, 2, CLI_HEADS, CLI_KV, CLI_HID, CLI_VOCAB),
               **({"qk_norm": "heads"} if name == "command-r" else {}))
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    assert jmain(["convert", path, "-o", jdir, "--bits", "4"]) == 0
    assert tmain(["convert", path, "-o", tdir, "--bits", "4",
                  "--device", "cpu"]) == 0
    with np.load(os.path.join(jdir, "arrays.npz")) as a, \
            np.load(os.path.join(tdir, "arrays.npz")) as b:
        assert a.files == b.files
        for k in a.files:
            assert a[k].tobytes() == b[k].tobytes(), k
    runners = {}

    def recorded(module, key):
        class Recorded(module.LLMRunner):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                runners[key] = self
        monkeypatch.setattr(module, "LLMRunner", Recorded)

    recorded(jrunner, "jax")
    recorded(tmain_module, "port")
    capsys.readouterr()
    argv = ["generate", "-p", "ola mundo", "--max-tokens", "12",
            "--temperature", "0"]
    assert jmain([argv[0], jdir, *argv[1:]]) == 0
    want = capsys.readouterr().out
    assert tmain([argv[0], tdir, *argv[1:], "--device", "cpu"]) == 0
    got = capsys.readouterr().out
    assert want.strip()
    jids = list(runners["jax"]._generated_ids)
    tids = list(runners["port"]._generated_ids)
    prompt = runners["jax"].tokenizer.encode("ola mundo", add_bos=True)
    assert runners["port"].tokenizer.encode("ola mundo",
                                            add_bos=True) == prompt

    jp, jcfg, _ = jckpt.load_checkpoint(jdir, device_put=False)
    tp, tcfg, _ = tckpt.load_checkpoint(tdir, device=CPU)
    forced = {}
    for dt, (jdt, tdt) in {"bf16": (jnp.bfloat16, torch.bfloat16),
                           "f32": (jnp.float32, torch.float32)}.items():
        wj, wt = (jp, tp) if dt == "bf16" else (_widen(jp), _widen(tp))
        forced[dt] = (
            _forced_logits(jllm, wj, jcfg, jllm.KVCache.create(jcfg, dtype=jdt),
                           prompt, jids, runners["jax"], jnp.asarray),
            _forced_logits(tllm, wt, tcfg,
                           tllm.KVCache.create(tcfg, tdt, device="cpu"),
                           prompt, jids, runners["port"], torch.from_numpy))
    for step, (j, t) in enumerate(zip(*forced["f32"])):
        np.testing.assert_allclose(t, j, rtol=0, atol=ATOL,
                                   err_msg=f"f32 step {step}")
    jb, tb = forced["bf16"]
    noise = max(float(np.abs(t - j).max()) for j, t in zip(jb, tb))
    scale = max(float(np.abs(j).max()) for j in jb)
    assert noise <= BF16_NOISE * scale, (noise, scale)
    # The forced JAX path is the JAX runner's path: it picks its ids.
    assert [int(j.argmax()) for j in jb] == jids
    parted = next((step for step, (a, b) in enumerate(zip(jids, tids))
                   if a != b), None)
    if parted is None:
        assert tids == jids and got == want
    else:
        row = jb[parted]
        assert _top2_margin(row) < 2 * noise, (parted, _top2_margin(row))
        assert row[tids[parted]] >= row.max() - 2 * noise, parted


def test_inspect_prints_the_jax_description(cli_gguf, capsys):
    assert jmain(["inspect", cli_gguf]) == 0
    want = capsys.readouterr().out
    assert tmain(["inspect", cli_gguf]) == 0
    assert capsys.readouterr().out == want
    assert json.loads(want)["architecture"] == "llama"


@pytest.mark.parametrize("arch", ["deepseek2", "mamba", "qwen3next"])
def test_arches_with_their_own_converter_raise(tmp_path, arch, monkeypatch):
    """deepseek2, mamba and qwen3next take their own converters
    (gguf_to_mla_params, gguf_to_mamba_params, gguf_to_qwen3next_params;
    tests/test_torch_mla.py, test_torch_mamba.py and test_torch_qwen3next.py
    hold their bytes), which ``gguf_convert_auto`` dispatches."""
    path = str(tmp_path / f"{arch}.gguf")
    write_gguf(path, {"token_embd.weight": (np.zeros((4, 32), np.float32),
                                            F32)},
               metadata={"general.architecture": arch})
    want = {"deepseek2": tconv.gguf_to_mla_params,
            "mamba": tconv.gguf_to_mamba_params,
            "qwen3next": tconv.gguf_to_qwen3next_params}[arch]
    assert tconv._ARCH_CONVERTERS[arch] is want
    monkeypatch.setitem(tconv._ARCH_CONVERTERS, arch,
                        lambda p, bits, device: (p, bits, device))
    assert tconv.gguf_convert_auto(path, bits=4, device=CPU) == (path, 4, CPU)


# --- the arches with converters of their own: llama4, glm4moe, falcon ---------

OWN = {
    "llama4": {"arch": "llama4"},
    "llama4_maverick": {"arch": "llama4", "step": 2},
    "glm4moe": {"arch": "glm4moe"},
    "falcon": {"arch": "falcon", "two_norm": True},
    "falcon_one_norm": {"arch": "falcon"},
}


def _own_arch_gguf(path, name, seed=0, widths=None):
    """A GGUF of the llama4, glm4moe or falcon arch with the tensors and
    metadata its converter reads (``OWN[name]``): Llama-4 with NoPE every
    2nd layer, chunks of 16 and a shared expert (Maverick: MoE on odd
    layers, a dense MLP on even ones); GLM-4-MoE with one leading dense
    layer, QKV biases, head QK norms, the selection bias and 2 of 4 groups;
    Falcon with MQA-style fused QKV, LayerNorm biases and, with
    ``two_norm``, the second norm. Returns the arch string."""
    dim, layers, heads, kv, hid, vocab = widths or (DIM, LAYERS, HEADS, KV,
                                                   HID, VOCAB)
    hd = dim // heads
    qd, kvd = heads * hd, kv * hd
    spec = OWN[name]
    arch = spec["arch"]
    rng = np.random.default_rng(seed)
    e = 8

    def m(*shape):
        return (rng.standard_normal(shape) / np.sqrt(shape[-1])
                ).astype(np.float32), F32

    def vec(n, around=0.0):
        return (around + 0.1 * rng.standard_normal(n)).astype(np.float32), F32

    t = {"token_embd.weight": (m(vocab, dim)[0] * 0.2, F32),
         "output_norm.weight": vec(dim, 1.0), "output.weight": m(vocab, dim)}
    meta = {"general.architecture": arch, "general.name": f"tiny-{name}",
            f"{arch}.block_count": layers, f"{arch}.context_length": 128,
            f"{arch}.attention.head_count": heads,
            f"{arch}.attention.head_count_kv": kv,
            f"{arch}.rope.freq_base": 10000.0}
    if arch == "falcon":
        t["output_norm.bias"] = vec(dim)
        meta["falcon.attention.layer_norm_epsilon"] = 1e-5
        for i in range(layers):
            p = f"blk.{i}"
            t[f"{p}.attn_norm.weight"] = vec(dim, 1.0)
            t[f"{p}.attn_norm.bias"] = vec(dim)
            if spec.get("two_norm"):
                t[f"{p}.attn_norm_2.weight"] = vec(dim, 1.0)
                t[f"{p}.attn_norm_2.bias"] = vec(dim)
            t[f"{p}.attn_qkv.weight"] = m(qd + 2 * kvd, dim)
            t[f"{p}.attn_output.weight"] = m(dim, qd)
            t[f"{p}.ffn_up.weight"] = m(hid, dim)
            t[f"{p}.ffn_down.weight"] = m(dim, hid)
        write_gguf(path, t, metadata=meta)
        return arch
    meta.update({f"{arch}.embedding_length": dim,
                 f"{arch}.attention.layer_norm_rms_epsilon": 1e-5,
                 f"{arch}.expert_count": e,
                 f"{arch}.expert_feed_forward_length": hid,
                 f"{arch}.vocab_size": vocab})
    step = spec.get("step", 1)
    if arch == "llama4":
        meta.update({"llama4.expert_used_count": 1,
                     "llama4.interleave_moe_layer_step": step,
                     "llama4.no_rope_layer_interval": 2,
                     "llama4.attention.chunk_size": 16,
                     "llama4.attention.temperature_length": 4.0,
                     "llama4.attention.use_kq_norm": int(step == 1),
                     "llama4.feed_forward_length": hid})
    else:
        meta.update({"glm4moe.expert_used_count": 2,
                     "glm4moe.leading_dense_block_count": 1,
                     "glm4moe.expert_gating_func": 2,
                     "glm4moe.expert_weights_norm": 1,
                     "glm4moe.expert_weights_scale": 2.5,
                     "glm4moe.expert_group_count": 4,
                     "glm4moe.expert_group_used_count": 2,
                     "glm4moe.rope.dimension_count": hd // 2})
    for i in range(layers):
        p = f"blk.{i}"
        t[f"{p}.attn_norm.weight"] = vec(dim, 1.0)
        t[f"{p}.ffn_norm.weight"] = vec(dim, 1.0)
        t[f"{p}.attn_q.weight"] = m(qd, dim)
        t[f"{p}.attn_k.weight"] = m(kvd, dim)
        t[f"{p}.attn_v.weight"] = m(kvd, dim)
        t[f"{p}.attn_output.weight"] = m(dim, qd)
        if arch == "glm4moe":
            t[f"{p}.attn_q.bias"] = vec(qd)
            t[f"{p}.attn_k.bias"] = vec(kvd)
            t[f"{p}.attn_v.bias"] = vec(kvd)
            t[f"{p}.attn_q_norm.weight"] = vec(hd, 1.0)
            t[f"{p}.attn_k_norm.weight"] = vec(hd, 1.0)
        moe = (i >= 1 if arch == "glm4moe" else i % step == step - 1)
        if moe:
            t[f"{p}.ffn_gate_inp.weight"] = (m(e, dim)[0] * 3.0, F32)
            t[f"{p}.ffn_gate_exps.weight"] = m(e, hid, dim)
            t[f"{p}.ffn_up_exps.weight"] = m(e, hid, dim)
            t[f"{p}.ffn_down_exps.weight"] = m(e, dim, hid)
            t[f"{p}.ffn_gate_shexp.weight"] = m(hid, dim)
            t[f"{p}.ffn_up_shexp.weight"] = m(hid, dim)
            t[f"{p}.ffn_down_shexp.weight"] = m(dim, hid)
            if arch == "glm4moe":
                t[f"{p}.exp_probs_b.bias"] = vec(e, -0.3)
        else:
            t[f"{p}.ffn_gate.weight"] = m(2 * hid, dim)
            t[f"{p}.ffn_up.weight"] = m(2 * hid, dim)
            t[f"{p}.ffn_down.weight"] = m(dim, 2 * hid)
    write_gguf(path, t, metadata=meta)
    return arch


_OWN_FILES = {}


def _own_gguf(tmp_path_factory, name):
    if name not in _OWN_FILES:
        path = str(tmp_path_factory.mktemp("own") / f"{name}.gguf")
        _own_arch_gguf(path, name)
        _OWN_FILES[name] = path
    return _OWN_FILES[name]


_OWN_FN = {"llama4": "gguf_to_llama4_params",
           "glm4moe": "gguf_to_glm4moe_params",
           "falcon": "gguf_to_falcon_params"}


@pytest.mark.parametrize("bits", [0, 4, 8])
@pytest.mark.parametrize("name", sorted(OWN))
def test_own_arch_converters_give_the_jax_bytes(tmp_path_factory, name,
                                                bits):
    """The llama4, glm4moe and falcon converters: the JAX package's config
    and every leaf's bytes, at bits 0, 4 and 8 (group 32); at bits 0 also
    through ``gguf_convert_auto``'s dispatch."""
    path = _own_gguf(tmp_path_factory, name)
    fn = _OWN_FN[OWN[name]["arch"]]
    if name == "glm4moe" and bits:
        jp, jcfg = _glm4moe_quantized_by_the_jax_quantizers(path, bits)
    else:
        jp, jcfg = getattr(jconv, fn)(path, bits=bits or None, group=GROUP)
    tp, tcfg = getattr(tconv, fn)(path, bits=bits or None, group=GROUP,
                                  device=CPU)
    assert isinstance(tcfg, tllm.LLMConfig)
    assert tcfg._asdict() == jcfg._asdict()
    _assert_same_tree(tp, jp)
    if not bits:
        tp, tcfg = tconv.gguf_convert_auto(path, device=CPU)
        assert tcfg._asdict() == jcfg._asdict()
        _assert_same_tree(tp, jp)


def _glm4moe_quantized_by_the_jax_quantizers(path, bits):
    """What the JAX package's glm4moe route gives at ``bits`` had it not
    failed: its unquantized conversion in f32 with every matrix it
    quantizes (QKV, output, shared expert, lm_head; zeros on the dense
    layer) put through its quantizer one layer at a time, and the other
    leaves in bf16."""
    from trackiellm_tpu.ops.quant import QuantizedLinear as JQ
    from trackiellm_tpu.ops.quant import quantize_q4 as jq4
    from trackiellm_tpu.ops.quant import quantize_q8 as jq8
    with pytest.raises(TypeError, match="stack"):
        jconv.gguf_to_glm4moe_params(path, bits=bits, group=GROUP)
    quantize = jq4 if bits == 4 else jq8
    jp, jcfg = jconv.gguf_to_glm4moe_params(path, bits=None,
                                            dtype=jnp.float32)

    def stacked(w):
        qs = [quantize(w[i], GROUP) for i in range(w.shape[0])]
        return JQ(values=jnp.stack([q.values for q in qs]),
                  scales=jnp.stack([q.scales for q in qs]))
    layers = {}
    for k, v in jp["layers"].items():
        if k in ("wqkv", "wo", "shared_gu", "shared_down"):
            layers[k] = stacked(v)
        elif k == "moe_gate_bias":
            layers[k] = v
        else:
            layers[k] = v.astype(jnp.bfloat16)
    return {"tok_emb": jp["tok_emb"].astype(jnp.bfloat16), "layers": layers,
            "out_norm": jp["out_norm"].astype(jnp.bfloat16),
            "lm_head": quantize(jp["lm_head"], GROUP)}, jcfg


@pytest.mark.parametrize("name", sorted(OWN))
def test_own_arch_models_match_the_jax_logits(tmp_path_factory, name):
    """The converted f32 model (no requantization) through ``prefill`` of
    40 tokens: the port's logits are the JAX package's within ATOL."""
    path = _own_gguf(tmp_path_factory, name)
    fn = _OWN_FN[OWN[name]["arch"]]
    jp, jcfg = getattr(jconv, fn)(path, bits=None, dtype=jnp.float32)
    tp, tcfg = getattr(tconv, fn)(path, bits=None, dtype=torch.float32,
                                  device=CPU)
    toks = np.random.default_rng(1).integers(0, VOCAB, 64).astype(np.int32)
    jl, _ = jllm.prefill(jp, jcfg, jnp.asarray(toks), jnp.int32(40),
                         jllm.KVCache.create(jcfg, dtype=jnp.float32))
    tl, _ = tllm.prefill(tp, tcfg, torch.from_numpy(toks.astype(np.int64)),
                         40, tllm.KVCache.create(tcfg, torch.float32,
                                                 device="cpu"))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=ATOL)


# The MoE routes through both CLIs at the CLI's widths (group 256): gpt-oss
# with MXFP4 experts and Qwen3-MoE through gguf_to_llm_params, and the own
# routes (glm4moe at --bits 0: the JAX CLI's --bits 8 fails there, see
# _glm4moe_quantized_by_the_jax_quantizers).
CLI_MOE = {"gpt-oss_mxfp4": "8", "qwen3moe": "8", "llama4": "8",
           "glm4moe": "0", "falcon": "8"}


@pytest.mark.parametrize("name", sorted(CLI_MOE))
def test_convert_then_generate_moe_arches_match_the_jax_cli(tmp_path, name,
                                                            capsys):
    """``inspect`` prints the JAX CLI's description, both CLIs' ``convert``
    write the same checkpoint files, the converted models (bf16 leaves
    widened to f32 on both sides, as in
    ``test_convert_then_generate_matches_the_jax_cli``: bf16 activations
    round apart where the sums run in another order, and that can flip an
    expert) give the JAX logits and greedy ids, and the port's ``generate``
    command prints text; glm4moe also converts at ``--bits 8`` on the
    port."""
    path = str(tmp_path / f"{name}.gguf")
    widths = (CLI_DIM, 2, CLI_HEADS, CLI_KV, CLI_HID, CLI_VOCAB)
    if name in OWN:
        _own_arch_gguf(path, name, seed=3, widths=widths)
    else:
        _arch_gguf(path, name, seed=3, widths=widths)
    assert jmain(["inspect", path]) == 0
    want = capsys.readouterr().out
    assert tmain(["inspect", path]) == 0
    assert capsys.readouterr().out == want
    bits = CLI_MOE[name]
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    assert jmain(["convert", path, "-o", jdir, "--bits", bits]) == 0
    assert tmain(["convert", path, "-o", tdir, "--bits", bits,
                  "--device", "cpu"]) == 0
    with np.load(os.path.join(jdir, "arrays.npz")) as a, \
            np.load(os.path.join(tdir, "arrays.npz")) as b:
        assert a.files == b.files
        for k in a.files:
            assert a[k].tobytes() == b[k].tobytes(), k
    jp, jcfg, _ = jckpt.load_checkpoint(jdir, device_put=False)
    tp, tcfg, _ = tckpt.load_checkpoint(tdir, device=CPU)
    jp, tp = _widen(jp), _widen(tp)
    toks = np.random.default_rng(2).integers(0, CLI_VOCAB, 40).astype(
        np.int32)
    jl, _ = jllm.prefill(jp, jcfg, jnp.asarray(toks), jnp.int32(40),
                         jllm.KVCache.create(jcfg, dtype=jnp.float32))
    tl, _ = tllm.prefill(tp, tcfg, torch.from_numpy(toks.astype(np.int64)),
                         40, tllm.KVCache.create(tcfg, torch.float32,
                                                 device="cpu"))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=ATOL)
    from trackiellm_tpu.llm import runner as jrunner
    from trackiellm_tpu_torch.llm import runner as trunner
    gen = dict(temperature=0.0, max_tokens=12, speculative=False)
    jr = jrunner.LLMRunner(jp, jcfg, None, jrunner.GenerationConfig(**gen),
                           cache_dtype=jnp.float32)
    tr = trunner.LLMRunner(tp, tcfg, None, trunner.GenerationConfig(**gen),
                           cache_dtype=torch.float32, device="cpu")
    jr.generate("ola mundo")
    tr.generate("ola mundo")
    assert tr._generated_ids == jr._generated_ids
    capsys.readouterr()
    argv = ["generate", "-p", "ola mundo", "--max-tokens", "12",
            "--temperature", "0", "--device", "cpu"]
    assert tmain([argv[0], tdir, *argv[1:]]) == 0
    assert capsys.readouterr().out.strip()
    if name == "glm4moe":
        qdir = str(tmp_path / "port8")
        assert tmain(["convert", path, "-o", qdir, "--bits", "8",
                      "--device", "cpu"]) == 0
        assert tmain([argv[0], qdir, *argv[1:]]) == 0
        assert capsys.readouterr().out.strip()


# --- the transformers-state-dict converters (convert --family *-hf) ----------

def _smoke():
    """chip_smoke.py as a module: its numpy state-dict writers."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


HF_WIDTHS = {"dim": 64, "heads": 2, "kv": 1, "hidden": 64, "vocab": VOCAB,
             "layers": 2, "experts": EXPERTS, "falcon_heads": 4}
# family: (converter name, keyword arguments)
HF_CONVERTERS = {
    "gemma2": ("gemma2_from_hf", {}), "gemma3": ("gemma3_from_hf", {}),
    "smollm3": ("smollm3_from_hf", {}), "olmo2": ("olmo2_from_hf", {}),
    "mixtral": ("mixtral_from_hf", {}),
    "qwen2moe": ("qwen2_moe_from_hf", {}), "qwen3": ("qwen3_from_hf", {}),
    "qwen3moe": ("qwen3_moe_from_hf", {}),
    "granite": ("granite_from_hf", {}), "glm4": ("glm4_from_hf", {}),
    "llama4": ("llama4_from_hf", {"rope_scaling": {
        "rope_type": "llama3", "factor": 8.0,
        "original_max_position_embeddings": 64}}),
    "nemotron": ("nemotron_from_hf", {}),
    "starcoder2": ("starcoder2_from_hf", {}),
    "cohere": ("cohere_from_hf", {"logit_scale": 0.0625}),
    "ernie45": ("ernie45_from_hf", {}),
    "glm4moe": ("glm4_moe_from_hf", {}),
    "falcon": ("falcon_from_hf", {"n_heads": 4}),
    "phi3": ("phi3_from_hf", {"max_seq": 256, "original_max_seq": 64,
                              "rope_factors_short": [1.0] * 8,
                              "rope_factors_long": [2.0] * 8}),
    "gpt_oss": ("gpt_oss_from_hf", {}),
}


@pytest.mark.parametrize("family", sorted(HF_CONVERTERS))
def test_hf_converters_give_the_jax_bytes(family):
    """Each ``*_from_hf`` on the same numpy state dict (transformers names,
    ``chip_smoke.hf_family_state``): the port's tree holds the JAX tree's
    bytes leaf for leaf, in its order, and the configs are equal."""
    name, kw = HF_CONVERTERS[family]
    state = _smoke().hf_family_state(family, HF_WIDTHS, 3)
    jp, jc = getattr(jconv, name)(state, **kw)
    tp, tc = getattr(tconv, name)(state, device=CPU, **kw)
    assert tc._asdict() == jc._asdict()
    _assert_same_tree(tp, jp)


def test_qwen3_next_converter_gives_the_jax_bytes():
    cs = _smoke()
    conf = cs.qwen3next_hf_config({**cs.Q3N_TINY, "dim": 64, "head_dim": 16,
                                   "lin_d": 16, "moe_hidden": 32})
    state = cs.qwen3next_hf_state(conf, 4)
    jp, jc = jconv.qwen3_next_from_hf(state, conf)
    tp, tc = tconv.qwen3_next_from_hf(state, conf, device=CPU)
    assert tuple(tc) == tuple(jc)

    def listless(tree):
        if isinstance(tree, list):
            return {str(i): listless(v) for i, v in enumerate(tree)}
        if isinstance(tree, dict):
            return {k: listless(v) for k, v in tree.items()}
        return tree
    assert list(_leaves(listless(tp))) == list(_leaves(listless(
        params_from_jax(jp))))


def test_wake_word_converter_gives_the_jax_params():
    """The conv spotter's checkpoint: the port's OIHW convolutions are the
    JAX package's HWIO ones transposed, the head and config the same."""
    from trackiellm_tpu_torch.models.bridge import hwio_tree_from_jax
    rng = np.random.default_rng(5)
    state = {"conv1.weight": rng.standard_normal((8, 1, 3, 3)),
             "conv1.bias": rng.standard_normal(8),
             "conv2.weight": rng.standard_normal((16, 8, 3, 3)),
             "conv2.bias": rng.standard_normal(16),
             "out.weight": rng.standard_normal((1, 32)),
             "out.bias": rng.standard_normal(1)}
    state = {k: v.astype(np.float32) for k, v in state.items()}
    jp, jc = jconv.wake_word_from_torch(state)
    tp, tc = tconv.wake_word_from_torch(state, device=CPU)
    assert tuple(tc) == tuple(jc) and tc.ch == 16
    assert dict(_leaves(tp)) == dict(_leaves(hwio_tree_from_jax(jp, CPU)))


def test_openwakeword_verifier_chain_matches_the_jax_one():
    """An (out, in) first layer, an (in, out) second, the width-1 head:
    the same chain, oriented and paired alike; and a non-chaining
    inventory raises in both."""
    rng = np.random.default_rng(8)
    state = {"dense/kernel": rng.standard_normal((48, 96)),
             "dense/bias": rng.standard_normal(48),
             "dense_1/kernel": rng.standard_normal((48, 32)),
             "dense_1/bias": rng.standard_normal(32),
             "dense_2/kernel": rng.standard_normal((32, 1)),
             "dense_2/bias": rng.standard_normal(1)}
    state = {k: v.astype(np.float32) for k, v in state.items()}
    want = jconv.openwakeword_verifier_from_onnx(state)
    got = tconv.openwakeword_verifier_from_onnx(state, device=CPU)
    assert got.in_dim == want.in_dim == 96
    assert len(got.layers) == len(want.layers) == 3
    for (tw, tb), (jw, jb) in zip(got.layers, want.layers):
        assert np.array_equal(tw.numpy(), np.asarray(jw))
        assert np.array_equal(tb.numpy(), np.asarray(jb))
    x = rng.standard_normal(96).astype(np.float32)
    assert abs(got(x) - want(x)) < 1e-6
    bad = {"w": np.ones((5, 7), np.float32)}
    with pytest.raises(TrackieError):
        tconv.openwakeword_verifier_from_onnx(bad, device=CPU)
    with pytest.raises(Exception):
        jconv.openwakeword_verifier_from_onnx(bad)


CLI_HF = ("gemma2", "gemma3", "smollm3", "olmo2", "mixtral", "qwen2moe",
          "qwen3", "qwen3moe", "granite", "glm4", "llama4", "nemotron",
          "starcoder2", "cohere", "ernie45", "glm4moe", "falcon",
          "qwen3next")


def _same_checkpoint(jdir: str, tdir: str) -> None:
    for name in ("tree.json", "config.json"):
        with open(os.path.join(jdir, name)) as a, \
                open(os.path.join(tdir, name)) as b:
            assert a.read() == b.read(), name
    with np.load(os.path.join(jdir, "arrays.npz")) as a, \
            np.load(os.path.join(tdir, "arrays.npz")) as b:
        assert a.files == b.files
        for k in a.files:
            assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes()


@pytest.mark.parametrize("family", CLI_HF)
def test_convert_family_writes_the_jax_checkpoint(family, tmp_path, capsys):
    """``convert STATE --family F-hf`` (``--bits 0``; falcon with
    ``--n-heads``, qwen3next with ``--model-config``) writes the files the
    JAX CLI writes, byte for byte."""
    cs = _smoke()
    if family == "qwen3next":
        conf = cs.qwen3next_hf_config({**cs.Q3N_TINY, "dim": 64,
                                       "head_dim": 16, "lin_d": 16,
                                       "moe_hidden": 32})
        state = cs.qwen3next_hf_state(conf, 6)
        conf_path = str(tmp_path / "config.json")
        with open(conf_path, "w") as f:
            json.dump(conf, f)
        extra = ["--model-config", conf_path]
    else:
        state = cs.hf_family_state(family, HF_WIDTHS, 6)
        extra = cs.hf_family_args(family, HF_WIDTHS)
    src = str(tmp_path / "state.npz")
    np.savez(src, **state)
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    argv = ["convert", src, "--family", f"{family}-hf", "--bits", "0", *extra]
    assert jmain([*argv, "-o", jdir]) == 0
    assert tmain([*argv, "-o", tdir, "--device", "cpu"]) == 0
    assert "converted + saved to" in capsys.readouterr().out
    _same_checkpoint(jdir, tdir)


def test_convert_qwen3next_hf_at_q4_writes_the_jax_checkpoint(tmp_path,
                                                              capsys):
    """``--family qwen3next-hf --bits 4`` at widths where group 256 divides
    every K / 2 (chip_smoke's Q3N_TINY): the experts' per-expert stacks,
    the projections and lm_head requantized by ``qwen3next.quantize_params``
    to the JAX bytes; without ``--model-config`` both CLIs refuse."""
    cs = _smoke()
    conf = cs.qwen3next_hf_config({**cs.Q3N_TINY, "experts": 2})
    src = str(tmp_path / "state.npz")
    np.savez(src, **cs.qwen3next_hf_state(conf, 7))
    conf_path = str(tmp_path / "config.json")
    with open(conf_path, "w") as f:
        json.dump(conf, f)
    argv = ["convert", src, "--family", "qwen3next-hf", "--bits", "4"]
    assert jmain([*argv, "-o", str(tmp_path / "x")]) == 1
    assert tmain([*argv, "-o", str(tmp_path / "x"), "--device", "cpu"]) == 1
    assert "needs --model-config" in capsys.readouterr().err
    argv += ["--model-config", conf_path]
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    assert jmain([*argv, "-o", jdir]) == 0
    assert tmain([*argv, "-o", tdir, "--device", "cpu"]) == 0
    _same_checkpoint(jdir, tdir)
    tree = json.loads(open(os.path.join(tdir, "tree.json")).read())["tree"]
    assert "__qlin__" in tree["layers"][0]["w_gu"]
    assert tmain(["generate", tdir, "-p", "ola", "--max-tokens", "4",
                  "--temperature", "0", "--device", "cpu"]) == 0
