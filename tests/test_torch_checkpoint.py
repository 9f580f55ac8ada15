"""The port's native checkpoints against the JAX package's, and its CLI.

A checkpoint either package writes, the other reads: the tensors come back
byte for byte (Q4 and Q8 values, f32 scales, bf16 embeddings and norms), the
config and metadata equal, and ``tree.json`` / ``config.json`` come out of
the two writers as the same text. Legacy biased-v1 Q4 is repacked, an
unknown packing raises. ``python -m trackiellm_tpu_torch generate`` on the
CPU prints the greedy text that the JAX package's ``generate`` prints on the
same directory.
"""

import json
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from trackiellm_tpu.__main__ import main as jmain
from trackiellm_tpu.models import checkpoint as jckpt
from trackiellm_tpu.models import llm as jllm
from trackiellm_tpu.utils import errors as jerrors
from trackiellm_tpu_torch.__main__ import main as tmain
from trackiellm_tpu_torch.models import checkpoint as tckpt
from trackiellm_tpu_torch.models import llm as tllm
from trackiellm_tpu_torch.models.bridge import params_from_jax
from trackiellm_tpu_torch.ops.quant import QuantizedLinear
from trackiellm_tpu_torch.utils.errors import ErrorCode, TrackieError

CPU = torch.device("cpu")
META = {"source": "test", "bits": 4, "vocab_pieces": None,
        "tokenizer_spec": None}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes: one intra-op thread, so this file does not crowd the
    other test workers' CPUs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_params(bits):
    """A tiny model with bf16 embeddings and norms, Q4 or Q8 matrices, and
    a list node (the format's third container)."""
    p = jllm.init_params_quantized(jax.random.PRNGKey(bits),
                                   jllm.LLMConfig.tiny(), bits=bits, group=64)
    p["extra"] = [jnp.arange(6, dtype=jnp.float32).reshape(2, 3)]
    return p


def _leaves(tree, prefix=""):
    """(path, numpy bytes view) for every array of a JAX or port tree."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}.{k}")
    elif isinstance(tree, (list, tuple)) and not hasattr(tree, "values"):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}[{i}]")
    elif hasattr(tree, "values") and hasattr(tree, "scales"):
        yield from _leaves(tree.values, prefix + ".values")
        yield from _leaves(tree.scales, prefix + ".scales")
    elif isinstance(tree, torch.Tensor):
        t = tree.contiguous()
        if t.dtype == torch.bfloat16:
            yield prefix, ("bfloat16", t.view(torch.int16).numpy().tobytes())
        else:
            yield prefix, (str(t.numpy().dtype), t.numpy().tobytes())
    else:
        a = np.asarray(tree)
        yield prefix, (str(a.dtype), a.tobytes())


def _same_bytes(a, b):
    la, lb = dict(_leaves(a)), dict(_leaves(b))
    assert la.keys() == lb.keys()
    for k in la:
        assert la[k] == lb[k], k


@pytest.mark.parametrize("bits", [4, 8])
def test_jax_checkpoint_loads_byte_for_byte(tmp_path, bits):
    jp = _jax_params(bits)
    jcfg = jllm.LLMConfig.tiny()
    jckpt.save_checkpoint(str(tmp_path), jp, config=jcfg, metadata=META)
    tp, tcfg, meta = tckpt.load_checkpoint(str(tmp_path), device=CPU)
    _same_bytes(tp, jp)
    assert isinstance(tp["layers"]["wqkv"], QuantizedLinear)
    assert tp["tok_emb"].dtype == torch.bfloat16
    assert tcfg == tllm.LLMConfig(**jcfg._asdict())
    assert meta == META


@pytest.mark.parametrize("bits", [4, 8])
def test_port_checkpoint_loads_in_jax(tmp_path, bits):
    jp = _jax_params(bits)
    jcfg = jllm.LLMConfig.tiny()
    tcfg = tllm.LLMConfig(**jcfg._asdict())
    port_dir, jax_dir = tmp_path / "port", tmp_path / "jax"
    tckpt.save_checkpoint(str(port_dir), params_from_jax(jp), config=tcfg,
                          metadata=META)
    jckpt.save_checkpoint(str(jax_dir), jp, config=jcfg, metadata=META)
    lp, lcfg, meta = jckpt.load_checkpoint(str(port_dir), device_put=False)
    _same_bytes(lp, jp)
    assert lcfg == jcfg and meta == META
    # The two writers give the same sidecars, and the same arrays by name.
    for name in ("tree.json", "config.json"):
        assert (port_dir / name).read_text() == (jax_dir / name).read_text()
    with np.load(port_dir / "arrays.npz") as a, \
            np.load(jax_dir / "arrays.npz") as b:
        assert a.files == b.files
        for k in a.files:
            assert a[k].dtype == b[k].dtype
            assert a[k].tobytes() == b[k].tobytes()


def _rewrite(directory, packing, repack=None):
    """Set config.json's q4_packing (None drops the marker) and, with
    ``repack``, re-encode every packed Q4 array."""
    cfg_path = os.path.join(directory, "config.json")
    sidecar = json.loads(open(cfg_path).read())
    sidecar["format"] = {} if packing is None else {"q4_packing": packing}
    with open(cfg_path, "w") as f:
        f.write(json.dumps(sidecar, indent=1))
    if repack is not None:
        path = os.path.join(directory, "arrays.npz")
        with np.load(path) as z:
            arrays = {k: z[k] for k in z.files}
        for k, a in arrays.items():
            if k.endswith(".values") and a.dtype == np.uint8:
                arrays[k] = repack(a)
        np.savez(path, **arrays)


@pytest.mark.parametrize("packing", ["biased-v1", None])
def test_biased_v1_is_repacked(tmp_path, packing):
    jp = _jax_params(4)
    jckpt.save_checkpoint(str(tmp_path), jp, config=jllm.LLMConfig.tiny())
    # biased-v1 keeps the high nibble biased by +8 too: flip its top bit.
    _rewrite(str(tmp_path), packing, repack=lambda a: a ^ np.uint8(0x80))
    tp, _, _ = tckpt.load_checkpoint(str(tmp_path), device=CPU)
    _same_bytes(tp, jp)
    jl, _, _ = jckpt.load_checkpoint(str(tmp_path), device_put=False)
    _same_bytes(tp, jl)


def test_unknown_packing_raises(tmp_path):
    jckpt.save_checkpoint(str(tmp_path), _jax_params(4),
                          config=jllm.LLMConfig.tiny())
    _rewrite(str(tmp_path), "nibble-v9")
    with pytest.raises(TrackieError, match="nibble-v9"):
        tckpt.load_checkpoint(str(tmp_path), device=CPU)


def test_other_families_raise_naming_their_roadmap_item(tmp_path):
    jckpt.save_checkpoint(str(tmp_path), {"w": jnp.ones((2,))},
                          config=jllm.LLMConfig.tiny())
    path = tmp_path / "config.json"
    sidecar = json.loads(path.read_text())
    for cls in ("MLAConfig", "MambaConfig", "Mamba2Config",
                "Qwen3NextConfig", "CLIPVisionConfig", "TrOCRConfig"):
        sidecar["config_class"] = cls
        path.write_text(json.dumps(sidecar))
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tckpt.load_checkpoint(str(tmp_path), device=CPU)


def test_missing_checkpoint_raises(tmp_path):
    with pytest.raises(TrackieError):
        tckpt.load_checkpoint(str(tmp_path / "nowhere"), device=CPU)


def test_params_load_onto_the_device_asked_for(tmp_path):
    jckpt.save_checkpoint(str(tmp_path), _jax_params(8),
                          config=jllm.LLMConfig.tiny())
    tp, _, _ = tckpt.load_checkpoint(str(tmp_path), device=CPU)
    assert tp["layers"]["wo"].values.device.type == "cpu"


def test_load_without_a_device_needs_a_card(tmp_path, monkeypatch):
    """The default device is the CUDA card: with none, loading raises
    instead of landing on the CPU."""
    jckpt.save_checkpoint(str(tmp_path), _jax_params(8),
                          config=jllm.LLMConfig.tiny())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(TrackieError, match="device=torch.device") as err:
        tckpt.load_checkpoint(str(tmp_path))
    assert err.value.code == ErrorCode.DEVICE_UNAVAILABLE


def test_error_codes_match_the_jax_package():
    """The port's copy of the errors module keeps every code's name and
    value."""
    assert ({c.name: int(c) for c in ErrorCode}
            == {c.name: int(c) for c in jerrors.ErrorCode})
    err = TrackieError(ErrorCode.FILE_NOT_FOUND, "x")
    assert str(err) == str(jerrors.TrackieError(
        jerrors.ErrorCode.FILE_NOT_FOUND, "x"))


# --- generate ---------------------------------------------------------------

def _spm_spec(vocab_size):
    """A SentencePiece tokenizer spec as the JAX converter stores it: llama's
    specials, the 256 byte-fallback pieces, then word pieces."""
    pieces = ["<unk>", "<s>", "</s>"] + [f"<0x{b:02X}>" for b in range(256)]
    words = ["▁"] + [chr(c) for c in range(ord("a"), ord("z") + 1)]
    words += [f"▁{a}" for a in "abcdefghijklmnopqrstuvwxyz"]
    words += [a + b for a in "aeiou" for b in "lmnrst"]
    while len(pieces) + len(words) < vocab_size:
        words.append(f"▁w{len(words)}")
    pieces += words[:vocab_size - len(pieces)]
    types = [2, 3, 3] + [6] * 256 + [1] * (vocab_size - 259)
    scores = [0.0] * 259 + [-float(i) for i in range(vocab_size - 259)]
    return {"model": "spm", "tokens": pieces, "scores": scores,
            "token_types": types, "pad_id": 0, "add_space_prefix": True}


@pytest.mark.parametrize("tokenizer", ["byte", "spm"])
def test_generate_matches_the_jax_cli(tmp_path, capsys, tokenizer):
    cfg = jllm.LLMConfig.tiny()
    jp = jllm.quantize_params(
        jllm.init_params(jax.random.PRNGKey(11), cfg, dtype=jnp.float32),
        bits=8, group=64)
    meta = {"source": "test", "bits": 8, "vocab_pieces": None,
            "tokenizer_spec": (_spm_spec(cfg.vocab_size)
                               if tokenizer == "spm" else None)}
    jckpt.save_checkpoint(str(tmp_path), jp, config=cfg, metadata=meta)
    argv = ["generate", str(tmp_path), "-p", "ola, descreva a cena",
            "--max-tokens", "24", "--temperature", "0"]
    assert jmain(argv) == 0
    want = capsys.readouterr().out
    assert tmain(argv + ["--device", "cpu"]) == 0
    got = capsys.readouterr().out
    assert got == want and got.strip()


def test_generate_needs_a_card_or_an_explicit_cpu(tmp_path, monkeypatch):
    jckpt.save_checkpoint(str(tmp_path), _jax_params(8),
                          config=jllm.LLMConfig.tiny())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        tmain(["generate", str(tmp_path), "-p", "oi"])
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tmain(["generate", str(tmp_path), "-p", "oi", "--image", "x.npy",
               "--device", "cpu"])
