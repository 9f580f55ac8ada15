"""The port's model-file readers against the JAX package's, on the CPU.

``trackiellm_tpu_torch/models/{loader,ggml_reader,onnx_reader}.py`` and
``utils/logging.py`` are copies of the JAX package's modules; the port
imports none of them. Files written here (GGUF by
``tests/test_loader.py:write_gguf`` and by ``chip_smoke.py``'s writer,
safetensors, npz, native checkpoints, whisper.cpp GGML, ONNX) go through
both packages: the same format, description, header, tensors and bytes.
Each of the 13 GGML block types dequantizes to bit-equal f32 on seeded
random blocks, and ``chip_smoke.py``'s vectorized GGUF writer gives
``write_gguf``'s bytes.
"""

import dataclasses
import importlib.util
import io
import json
import logging
import os

import numpy as np
import pytest

import torch

from tests.test_loader import write_gguf
from tests.test_whisper_ggml import write_ggml_whisper
from trackiellm_tpu.models import convert as jconv
from trackiellm_tpu.models import ggml_reader as jggml
from trackiellm_tpu.models import loader as jload
from trackiellm_tpu.models import onnx_reader as jonnx
from trackiellm_tpu.utils import logging as jlog
from trackiellm_tpu_torch.models import checkpoint as tckpt
from trackiellm_tpu_torch.models import convert as tconv
from trackiellm_tpu_torch.models import ggml_reader as tggml
from trackiellm_tpu_torch.models import llm as tllm
from trackiellm_tpu_torch.models import loader as tload
from trackiellm_tpu_torch.models import onnx_reader as tonnx
from trackiellm_tpu_torch.utils import logging as tlog
from trackiellm_tpu_torch.utils.errors import TrackieError

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _same_arrays(got, want):
    assert list(got) == list(want)
    for name, a in want.items():
        assert got[name].dtype == a.dtype, name
        assert got[name].shape == a.shape, name
        assert got[name].tobytes() == a.tobytes(), name


# --- one file of each format -----------------------------------------------------

def _ggml_whisper(path):
    rng = np.random.default_rng(2)
    state = {"encoder.conv1.weight": rng.standard_normal((8, 4, 3)),
             "encoder.conv1.bias": rng.standard_normal(8),
             "decoder.token_embedding.weight": rng.standard_normal((6, 32)),
             "decoder.blocks.0.attn.query.weight":
                 rng.standard_normal((32, 32)),
             "decoder.ln.bias": rng.standard_normal(32)}
    hparams = {"n_vocab": 6, "n_audio_ctx": 10, "n_audio_state": 32,
               "n_audio_head": 2, "n_audio_layer": 1, "n_text_ctx": 8,
               "n_text_state": 32, "n_text_head": 2, "n_text_layer": 1,
               "n_mels": 4, "ftype": 1}
    filters = np.arange(24, dtype=np.float32).reshape(4, 6) / 100.0
    vocab = [b"he", b"llo", b" wor", b"ld", "ç".encode(), b"!"]
    write_ggml_whisper(path, state, hparams, filters, vocab,
                       qtensors={"decoder.blocks.0.attn.query.weight": "q8_0"})


def _write(tmp_path, kind):
    """A model file (or directory) of ``kind``; returns its path."""
    rng = np.random.default_rng(1)
    w = rng.standard_normal((4, 64)).astype(np.float32)
    path = str(tmp_path / f"model.{kind}")
    if kind == "gguf":
        write_gguf(path, {"a": (w, jload.GGML_F32), "b": (w, jload.GGML_F16),
                          "c": (w, jload.GGML_Q8_0),
                          "d": (w, jload.GGML_Q4_0)},
                   metadata={"general.architecture": "llama",
                             "general.name": "four", "llama.block_count": 1,
                             "llama.rope.freq_base": 10000.0,
                             "tokenizer.ggml.tokens": ["a", "b"]})
    elif kind == "native":
        cfg = tllm.LLMConfig.tiny()
        params = tllm.init_params(torch.Generator().manual_seed(0), cfg,
                                  dtype=torch.float32)
        tckpt.save_checkpoint(path, params, config=cfg,
                              metadata={"source": "test"})
    elif kind == "safetensors":
        # An f32 tensor and a bf16 one (w's top 16 bits).
        _write_safetensors(path, {"w": w}, {
            "h": (w.view(np.uint32) >> 16).astype(np.uint16)})
    elif kind == "npz":
        np.savez(path, w=w, n=np.arange(3))
    elif kind == "ggml":
        _ggml_whisper(path)
    elif kind == "onnx":
        jonnx.write_onnx_initializers(path, {"w": w,
                                             "ids": np.arange(4)})
    elif kind == "tflite":
        with open(path, "wb") as f:
            f.write(b"\x00\x00\x00\x00TFL3rest")
    elif kind == "orbax":
        os.makedirs(os.path.join(path, "checkpoint"))
    elif kind == "unknown":
        with open(path, "wb") as f:
            f.write(b"\xff\xfe\xfd\xfc garbage")
    return path


def _write_safetensors(path, f32, bf16):
    header, blobs, offset = {}, [], 0
    for name, arr in f32.items():
        header[name] = {"dtype": "F32", "shape": list(arr.shape),
                        "data_offsets": [offset, offset + arr.nbytes]}
        blobs.append(arr.tobytes())
        offset += arr.nbytes
    for name, arr in bf16.items():
        header[name] = {"dtype": "BF16", "shape": list(arr.shape),
                        "data_offsets": [offset, offset + arr.nbytes]}
        blobs.append(arr.tobytes())
        offset += arr.nbytes
    head = json.dumps(header).encode()
    with open(path, "wb") as f:
        f.write(len(head).to_bytes(8, "little") + head + b"".join(blobs))


KINDS = ("gguf", "native", "safetensors", "npz", "ggml", "onnx", "tflite",
         "orbax", "unknown")


@pytest.mark.parametrize("kind", KINDS)
def test_detect_format_and_describe_match(tmp_path, kind):
    path = _write(tmp_path, kind)
    assert tload.detect_format(path).value == jload.detect_format(path).value
    assert tload.describe(path) == jload.describe(path)
    assert tload.validate_model(path) == jload.validate_model(path)


@pytest.mark.parametrize("kind", ["gguf", "safetensors", "npz", "ggml",
                                  "onnx"])
def test_load_model_matches(tmp_path, kind):
    path = _write(tmp_path, kind)
    got, want = tload.load_model(path), jload.load_model(path)
    assert got.format.value == want.format.value
    assert got.metadata == want.metadata
    assert got.size_bytes == want.size_bytes
    _same_arrays(got.tensors, want.tensors)
    opt_got, opt_want = tload.optimize_model(got), jload.optimize_model(want)
    assert opt_got.size_bytes == opt_want.size_bytes
    _same_arrays(opt_got.tensors, opt_want.tensors)


@pytest.mark.parametrize("kind", ["tflite", "unknown"])
def test_load_model_refuses_alike(tmp_path, kind):
    path = _write(tmp_path, kind)
    with pytest.raises(TrackieError) as got:
        tload.load_model(path)
    with pytest.raises(Exception) as want:
        jload.load_model(path)
    assert got.value.code == want.value.code


def test_read_gguf_header_matches_on_every_kv_type(tmp_path):
    """Every metadata type the reader knows (the 8- to 64-bit ints, f32,
    f64, bool, strings and arrays), an alignment other than 32, and the
    tensor directory: equal metadata, directory and data start."""
    cs = _chip_smoke()
    md = {"general.architecture": "llama", "general.alignment": 64,
          "u8": np.uint8(200), "i8": np.int8(-3), "u16": np.uint16(60000),
          "i16": np.int16(-300), "u32": np.uint32(4000000000),
          "i32": np.int32(-70000), "f32": np.float32(0.1),
          "b": True, "u64": np.uint64(2 ** 40), "i64": np.int64(-2 ** 40),
          "f64": np.float64(1e-5), "s": "olá", "ints": [1, -2, 3],
          "floats": [0.5, -1.25], "strs": ["a", "▁b"], "empty": []}
    w = np.arange(96, dtype=np.float32).reshape(3, 32)
    path = str(tmp_path / "kv.gguf")
    cs.write_gguf(path, {"w": (w, cs.GGML_F32), "h": (w, cs.GGML_F16)}, md,
                  align=64)
    got, want = tload.read_gguf_header(path), jload.read_gguf_header(path)
    assert got.metadata == want.metadata
    assert got.metadata["f64"] == 1e-5 and got.metadata["b"] is True
    assert ({n: dataclasses.asdict(t) for n, t in got.tensors.items()}
            == {n: dataclasses.asdict(t) for n, t in want.tensors.items()})
    assert (got.version, got.data_start, got.path, got.architecture,
            got.name) == (want.version, want.data_start, want.path,
                          want.architecture, want.name)
    assert got.data_start % 64 == 0
    for name in ("w", "h"):
        assert (tload.load_gguf_tensor(got, name).tobytes()
                == jload.load_gguf_tensor(want, name).tobytes())


# --- the 13 GGML block types ---------------------------------------------------

# ggml type -> byte offsets of each block's f16 fields (d, and m or dmin);
# MXFP4's one scale is an e8m0 byte
F16_FIELDS = {
    jload.GGML_Q8_0: (0,), jload.GGML_Q4_0: (0,), jload.GGML_Q4_1: (0, 2),
    jload.GGML_Q5_0: (0,), jload.GGML_Q5_1: (0, 2),
    jload.GGML_Q2_K: (80, 82), jload.GGML_Q3_K: (108,),
    jload.GGML_Q4_K: (0, 2), jload.GGML_Q5_K: (0, 2),
    jload.GGML_Q6_K: (208,), jload.GGML_IQ4_NL: (0,),
    jload.GGML_IQ4_XS: (0,), jload.GGML_MXFP4: (),
}


def test_the_dequantizer_table_matches():
    assert sorted(F16_FIELDS) == sorted(jload._GGML_DEQUANT)
    assert ({t: v[:2] for t, v in tload._GGML_DEQUANT.items()}
            == {t: v[:2] for t, v in jload._GGML_DEQUANT.items()})


@pytest.mark.parametrize("gtype", sorted(F16_FIELDS))
def test_dequantizers_are_bit_equal(tmp_path, gtype):
    per, nbytes, _ = jload._GGML_DEQUANT[gtype]
    rng = np.random.default_rng(gtype)
    n = 4 * 256 // per * 3  # 3 rows of 1024 elements
    raw = rng.integers(0, 256, (n, nbytes), dtype=np.uint8)
    for at in F16_FIELDS[gtype]:
        raw[:, at:at + 2] = rng.uniform(-2.0, 2.0, n).astype("<f2").view(
            np.uint8).reshape(n, 2)
    if gtype == jload.GGML_MXFP4:  # a finite e8m0 scale: 2^(e - 127)
        raw[:, 0] = rng.integers(100, 150, n)
    path = str(tmp_path / "q.gguf")
    write_gguf(path, {"w": (raw.reshape(-1), gtype, (3, 1024))})
    got = tload.load_gguf_tensor(tload.read_gguf_header(path), "w")
    want = jload.load_gguf_tensor(jload.read_gguf_header(path), "w")
    assert got.dtype == want.dtype == np.float32
    assert got.shape == want.shape == (3, 1024)
    assert np.isfinite(want).all()
    assert got.tobytes() == want.tobytes()


def test_unknown_tensor_and_type_raise_alike(tmp_path):
    path = str(tmp_path / "x.gguf")
    write_gguf(path, {"w": (np.zeros(40, np.uint8), 16, (32,))})  # IQ2_S
    for mod in (tload, jload):
        header = mod.read_gguf_header(path)
        with pytest.raises(Exception, match="not supported"):
            mod.load_gguf_tensor(header, "w")
        with pytest.raises(Exception, match="'v'"):
            mod.load_gguf_tensor(header, "v")


# --- chip_smoke.py's writer --------------------------------------------------------

def test_chip_smoke_writer_gives_write_gguf_bytes(tmp_path):
    cs = _chip_smoke()
    rng = np.random.default_rng(3)
    raw = rng.integers(0, 256, 2 * 144, dtype=np.uint8)
    tensors = {"f32": (rng.standard_normal((3, 7)).astype(np.float32),
                       cs.GGML_F32),
               "f16": (rng.standard_normal((5,)).astype(np.float32),
                       cs.GGML_F16),
               "q4k": (raw, cs.GGML_Q4_K, (2, 256)),
               "norm": (np.ones(33, np.float32), cs.GGML_F32)}
    md = {"general.architecture": "llama", "n": 7, "neg": -7, "x": 0.25,
          "tokens": ["<unk>", "▁olá"], "types": [1, 2, 3],
          "scores": [0.0, -1.5], "empty": []}
    a, b = str(tmp_path / "a.gguf"), str(tmp_path / "b.gguf")
    write_gguf(a, tensors, metadata=md)
    size = cs.write_gguf(b, tensors, md)
    assert size == os.path.getsize(a)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()


def test_chip_smoke_mistral_gguf_converts_alike(tmp_path):
    """chip_smoke.py's Q4_K_M file, at tiny widths: finite weights in the
    mix's types, an spm vocabulary the converter reads back as written, and
    the same Q4 checkpoint bytes from both packages."""
    cs = _chip_smoke()
    cfg = tllm.LLMConfig.mistral_7b()._replace(
        vocab_size=512, dim=512, n_layers=2, n_heads=4, n_kv_heads=2,
        head_dim=128, hidden_dim=1024, max_seq=1024, sliding_window=1024)
    spec = cs.spm_spec(cfg.vocab_size)
    tensors, md = cs.mistral_gguf(cfg, spec, seed=5)
    path = str(tmp_path / "m.gguf")
    cs.write_gguf(path, tensors, md)
    header = tload.read_gguf_header(path)
    assert {n: t.ggml_type for n, t in header.tensors.items()} == {
        n: s[1] for n, s in tensors.items()}
    assert header.tensors["blk.0.ffn_down.weight"].ggml_type == cs.GGML_Q6_K
    for name in ("token_embd.weight", "blk.1.attn_q.weight",
                 "blk.1.attn_v.weight", "output.weight"):
        w = tload.load_gguf_tensor(header, name)
        assert np.isfinite(w).all() and 0.005 < w.std() < 0.1, name
    assert tconv.config_from_gguf(header) == cfg
    assert tconv.tokenizer_spec_from_gguf(header) == spec
    tp, _ = tconv.gguf_to_llm_params(path, bits=4, group=64,
                                     device=torch.device("cpu"))
    jp, _ = jconv.gguf_to_llm_params(path, bits=4, group=64)
    from tests.test_torch_convert import _assert_same_tree
    _assert_same_tree(tp, jp)


# --- whisper.cpp GGML, ONNX, the cache, logging ----------------------------------

def test_ggml_whisper_reader_matches(tmp_path):
    path = str(tmp_path / "ggml-tiny.bin")
    _ggml_whisper(path)
    got, want = tggml.read_ggml_whisper(path), jggml.read_ggml_whisper(path)
    assert got.hparams == want.hparams and got.vocab == want.vocab
    assert got.mel_filters.tobytes() == want.mel_filters.tobytes()
    _same_arrays(got.tensors, want.tensors)
    tok, jtok = tggml.GGMLVocabTokenizer(got.vocab), jggml.GGMLVocabTokenizer(
        want.vocab)
    assert tok.decode([0, 1, 2, 3, 5, 99]) == jtok.decode(
        [0, 1, 2, 3, 5, 99]) == "hello world!"
    assert tok.decode_token(4) == jtok.decode_token(4) == "ç"


def test_onnx_reader_and_writer_match(tmp_path):
    rng = np.random.default_rng(0)
    tensors = {"conv.weight": rng.standard_normal((4, 3, 3)).astype(
                   np.float32),
               "emb": rng.standard_normal((7, 5)).astype(np.float16),
               "ids": np.arange(6, dtype=np.int64).reshape(2, 3),
               "mask": rng.integers(0, 255, (8,), dtype=np.uint8)}
    a, b = str(tmp_path / "a.onnx"), str(tmp_path / "b.onnx")
    tonnx.write_onnx_initializers(a, tensors)
    jonnx.write_onnx_initializers(b, tensors)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()
    _same_arrays(tonnx.read_onnx_initializers(a),
                 jonnx.read_onnx_initializers(a))


def test_model_cache_evicts_alike(tmp_path):
    paths = []
    for i in range(3):
        p = str(tmp_path / f"m{i}.npz")
        np.savez(p, w=np.full((250,), float(i), np.float32))
        paths.append(p)
    caches = (tload.ModelCache(max_models=2, max_bytes=1500),
              jload.ModelCache(max_models=2, max_bytes=1500))
    for cache in caches:
        cache.preload(paths[:2])
        cache.get(paths[0])
        cache.get(paths[2])
    assert ([(c.size, c.evictions, list(c._cache)) for c in caches[:1]]
            == [(c.size, c.evictions, list(c._cache)) for c in caches[1:]])


def test_logging_copy_behaves_alike():
    assert ({m.name: int(m) for m in tlog.LogLevel}
            == {m.name: int(m) for m in jlog.LogLevel})
    event = json.loads(tlog.JsonEventFormatter.format_event(
        "t", {"k": 1}, "WARN"))
    want = json.loads(jlog.JsonEventFormatter.format_event(
        "t", {"k": 1}, "WARN"))
    assert event.keys() == want.keys() and event["payload"] == {"k": 1}
    log = tlog.get_logger("models.convert")
    assert log.name == jlog.get_logger("models.convert").name
    stream = io.StringIO()
    handler = logging.StreamHandler(stream)
    log.addHandler(handler)
    try:
        tlog.AuditTrail(log).config_change("me", "k", 2)
    finally:
        log.removeHandler(handler)
    record = json.loads(stream.getvalue())
    assert record["type"] == "audit.config" and record["payload"] == {
        "actor": "me", "action": "set", "detail": {"key": "k", "value": 2}}
