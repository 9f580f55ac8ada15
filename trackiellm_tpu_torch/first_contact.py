"""First-contact harness: validate a directory of real checkpoints through
the port in one command.

    python -m trackiellm_tpu_torch first_contact <artifact_dir> \\
        [--report report.json] [--bits 4|8] [--device D]

The twin of ``trackiellm_tpu/first_contact.py``, on the port's readers,
converters and engines. For every file in the directory the harness:

1. **sniffs** the format by magic bytes and content (GGUF, whisper GGML,
   ONNX, safetensors/torch/npz state dicts, Piper voices by their sibling
   ``.json`` config; ``model-XXXXX-of-YYYYY.safetensors`` shard groups are
   merged and checked as one);
2. **converts** it through the matching ``models/convert.py`` route on the
   device, capturing every logged warning (guessed math-bearing metadata
   keys, unknown pre-tokenizer ids, name-map fallbacks);
3. **probes** the converted model: a teacher-forced NLL on
   :data:`PROBE_TEXT` through the file's own tokenizer for LLMs (a bf16
   KV cache, the ids padded to a multiple of 8, as the JAX probe), a
   forward smoke for the perception models;
4. **exercises the staged first-contact flags** (both rope layouts for
   llama-family, deepseek2 and llama4 GGUFs): it converts under each
   setting and compares the probe NLLs, so a trained checkpoint picks its
   layout;
5. **runs the matching parity twin** (``trackiellm_tpu_torch.tools.
   parity_*``) in a child process on the same device when the companion
   files of :data:`COMPANIONS` lie next to the artifact, else reports the
   exact command to run;
6. returns one JSON-able report (PASS/WARN/FAIL per artifact and which
   staged guess won), and the CLI exits non-zero on any FAIL.

The probes run on the CUDA card unless ``Options(device=...)`` /
``--device`` asks for another device. One fault of the JAX harness is
repaired here: its bert-GGUF probe unpacks two values from
``gguf_to_bert_params``, which returns three, so every bert GGUF fails
there; here it is converted and embedded.
"""

from __future__ import annotations

import json
import logging
import os
import pathlib
import re
import subprocess
import sys
import time
import traceback
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from trackiellm_tpu_torch.ops.backend import default_device, exact_f32
from trackiellm_tpu_torch.utils.logging import get_logger

log = get_logger("first_contact")

# The checkout holding this package: the parity children run from there.
CHECKOUT = str(pathlib.Path(__file__).resolve().parents[1])

# Natural-language probe snippet (pt-BR, the product language). Long
# enough that scrambled attention shows up as a large NLL gap on any
# trained model.
PROBE_TEXT = ("A rua estava tranquila quando o assistente descreveu a "
              "cena: duas pessoas caminhavam perto da faixa de "
              "pedestres e um carro aguardava o sinal abrir.")

# Relative NLL gap above which the flag probe is decisive. Correct vs
# column-scrambled q/k on a trained model differs by far more than
# this; random synthetic weights differ by far less.
DECISIVE_GAP = 0.10

# Staged "flip on first contact" flags, per GGUF arch: env var and the
# (default, alternative) values; the port's converters read the same
# variables.
ROPE_FLAGS = {
    "llama": ("TRACKIE_LLAMA_GGUF_ROPE", "norm", "hf"),
    "granite": ("TRACKIE_LLAMA_GGUF_ROPE", "norm", "hf"),
    "granitemoe": ("TRACKIE_LLAMA_GGUF_ROPE", "norm", "hf"),
    "smollm3": ("TRACKIE_LLAMA_GGUF_ROPE", "norm", "hf"),
    "deepseek2": ("TRACKIE_DEEPSEEK2_GGUF_ROPE", "neox", "interleaved"),
    "llama4": ("TRACKIE_LLAMA4_GGUF_ROPE", "fold", "none"),
}

# Companion ground-truth conventions: if these files exist next to the
# artifact, the matching parity twin runs automatically. ``{a}`` = the
# artifact path, ``{stem}`` = artifact path minus its extension; every
# command also gets ``--device``.
_TOOLS = "trackiellm_tpu_torch.tools."
COMPANIONS = {
    "llm": (("{stem}.transcript.json",),
            ["-m", _TOOLS + "parity_llm", "--gguf", "{a}",
             "--transcript", "{stem}.transcript.json",
             "--quantize", "{QUANT}"]),
    "asr": (("{stem}.audio", "{stem}.refs.tsv"),
            ["-m", _TOOLS + "parity_asr", "--checkpoint", "{a}",
             "--audio", "{stem}.audio", "--refs", "{stem}.refs.tsv"]),
    "vad": (("{stem}.wav", "{stem}.expected.json"),
            ["-m", _TOOLS + "parity_vad", "--checkpoint", "{a}",
             "--audio", "{stem}.wav",
             "--expected", "{stem}.expected.json"]),
    "detector": (("{stem}.images", "{stem}.expected.json"),
                 ["-m", _TOOLS + "parity_detector", "--checkpoint", "{a}",
                  "--images", "{stem}.images",
                  "--expected", "{stem}.expected.json"]),
    "depth": (("{stem}.images", "{stem}.expected.npz"),
              ["-m", _TOOLS + "parity_depth", "--checkpoint", "{a}",
               "--images", "{stem}.images",
               "--expected", "{stem}.expected.npz"]),
    "tts": (("{stem}.text.txt", "{stem}.expected.wav", "{VCFG}"),
            ["-m", _TOOLS + "parity_tts", "--voice", "{a}",
             "--config", "{VCFG}",
             "--text", "{TEXT}",
             "--expected", "{stem}.expected.wav"]),
    "ocr": (("{stem}.images", "{stem}.expected.json", "{stem}.vocab.json",
             "{stem}.config.json"),
            ["-m", _TOOLS + "parity_ocr", "--checkpoint", "{a}",
             "--config", "{stem}.config.json",
             "--vocab", "{stem}.vocab.json",
             "--images", "{stem}.images",
             "--expected", "{stem}.expected.json"]),
}

# The loggers the tap listens to: the root and the packages' own (which
# do not propagate to the root).
_TAPPED = ("trackiellm", "trackiellm_tpu_torch")


class _WarningTap(logging.Handler):
    """Collect WARNING+ records from the port's loggers for the report:
    guessed math keys, pre-tokenizer fallbacks, name-map passes all
    announce themselves through logging."""

    def __init__(self):
        super().__init__(level=logging.WARNING)
        self.records: List[str] = []

    def emit(self, record):
        self.records.append(
            f"{record.name}: {record.getMessage()}")

    def __enter__(self):
        logging.getLogger().addHandler(self)
        for name in _TAPPED:
            logging.getLogger(name).addHandler(self)
        return self

    def __exit__(self, *exc):
        logging.getLogger().removeHandler(self)
        for name in _TAPPED:
            logging.getLogger(name).removeHandler(self)
        return False


# ---------------------------------------------------------------------------
# Sniffing
# ---------------------------------------------------------------------------

_SHARD_RE = re.compile(r"-\d{5}-of-\d{5}\.safetensors$")


def sniff(path: str) -> Dict[str, Any]:
    """Classify one file by magic + content. Returns at least
    {"kind": ...}; kind "skip" marks non-artifact files."""
    base = os.path.basename(path)
    low = base.lower()
    try:
        with open(path, "rb") as f:
            head = f.read(8)
    except (IsADirectoryError, PermissionError):
        return {"kind": "skip", "why": "not a regular file"}
    if head[:4] == b"GGUF":
        from trackiellm_tpu_torch.models.loader import read_gguf_header

        hdr = read_gguf_header(path)
        arch = hdr.architecture or ""
        if arch == "clip" or "mmproj" in low:
            return {"kind": "gguf-mmproj", "arch": arch}
        return {"kind": "gguf", "arch": arch,
                "n_tensors": len(hdr.tensors)}
    if head[:4] == (0x67676D6C).to_bytes(4, "little"):
        return {"kind": "ggml-whisper"}
    if low.endswith(".onnx"):
        return _sniff_onnx(path)
    if low.endswith(".safetensors"):
        if _SHARD_RE.search(base):
            return {"kind": "hf-shard"}
        return {"kind": "state-dict"}
    if low.endswith((".pt", ".pth", ".npz")):
        return {"kind": "state-dict"}
    if low.endswith(".bin"):
        # torch pickle / zip; GGML handled by magic above.
        if head[:2] in (b"PK", b"\x80\x02", b"\x80\x04", b"\x80\x05"):
            return {"kind": "state-dict"}
        return {"kind": "skip", "why": "unrecognized .bin container"}
    if low in ("config.json",) or low.endswith(
            (".json", ".md", ".txt", ".tsv", ".wav", ".npy",
             ".gitkeep")):
        return {"kind": "skip", "why": "companion/metadata file"}
    return {"kind": "skip", "why": "unknown format"}


def _sniff_onnx(path: str) -> Dict[str, Any]:
    from trackiellm_tpu_torch.models.onnx_reader import (
        read_onnx_initializers)

    try:
        names = set(read_onnx_initializers(path).keys())
    except Exception as e:  # pragma: no cover - malformed file
        return {"kind": "skip", "why": f"onnx read failed: {e}"}
    plain = {n[len("_model."):] if n.startswith("_model.") else n
             for n in names}
    if any(n.startswith("stft.forward_basis_buffer") for n in plain):
        return {"kind": "onnx-silero"}
    if any(n.startswith("enc_p.") for n in plain):
        for cfg in (path + ".json",
                    os.path.splitext(path)[0] + ".json"):
            if os.path.exists(cfg):
                return {"kind": "onnx-piper", "config": cfg}
        return {"kind": "onnx-piper", "config": None}
    return {"kind": "onnx-weights", "n_tensors": len(names)}


# ---------------------------------------------------------------------------
# NLL probes
# ---------------------------------------------------------------------------

def _probe_ids(tokenizer, vocab_size: int, n: int = 32) -> List[int]:
    """Token ids for the probe: the real tokenizer over PROBE_TEXT when
    the artifact embeds one, else deterministic pseudo-ids (smoke-only;
    the report marks such probes non-decisive)."""
    if tokenizer is not None:
        try:
            ids = list(tokenizer.encode(PROBE_TEXT))
            if len(ids) >= 8:
                return ids[:n]
        except Exception:
            pass
    rng = np.random.default_rng(0)
    return [int(i) for i in rng.integers(0, vocab_size, size=min(n, 24))]


def _nll_from_all_logits(logits: np.ndarray, ids: List[int]) -> float:
    lg = np.asarray(logits, np.float64)[: len(ids) - 1]
    lg = lg - lg.max(axis=-1, keepdims=True)
    logp = lg - np.log(np.exp(lg).sum(axis=-1, keepdims=True))
    tgt = np.asarray(ids[1:], np.int64)
    return float(-logp[np.arange(len(tgt)), tgt].mean())


def _padded(ids: List[int], dev: torch.device) -> Tuple[torch.Tensor, int]:
    """The ids padded with 0 to a multiple of 8 (at least 8), on ``dev``."""
    pad = max(8, -(-len(ids) // 8) * 8)
    return torch.tensor(ids + [0] * (pad - len(ids)), dtype=torch.long,
                        device=dev), pad


def _host(logits: torch.Tensor) -> np.ndarray:
    return logits.float().cpu().numpy()


def _nll_llm(params, cfg, ids: List[int], dev: torch.device) -> float:
    from trackiellm_tpu_torch.models import llm as M

    toks, pad = _padded(ids, dev)
    cache = M.KVCache.create(cfg, dtype=torch.bfloat16, max_seq=pad,
                             device=dev)
    logits, _ = M.extend(params, cfg, toks, len(ids), cache,
                         all_logits=True)
    return _nll_from_all_logits(_host(logits), ids)


def _nll_mla(params, cfg, ids: List[int], dev: torch.device) -> float:
    from trackiellm_tpu_torch.models import mla as M

    toks, pad = _padded(ids, dev)
    cache = M.MLACache.create(cfg, dtype=torch.bfloat16, max_seq=pad,
                              device=dev)
    logits, _ = M.extend(params, cfg, toks, len(ids), cache,
                         all_logits=True)
    return _nll_from_all_logits(_host(logits), ids)


def _nll_mamba(params, cfg, ids: List[int], dev: torch.device) -> float:
    from trackiellm_tpu_torch.models import mamba as M

    cache = M.MambaCache.create(cfg, device=dev)
    rows = []
    for t in ids[:-1]:
        logits, cache = M.decode_step(params, cfg, int(t), cache)
        rows.append(logits)
    lg = _host(torch.stack(rows))
    return _nll_from_all_logits(
        np.concatenate([lg, np.zeros_like(lg[:1])]), ids)


def _nll_qwen3next(params, cfg, ids: List[int], dev: torch.device) -> float:
    from trackiellm_tpu_torch.models import qwen3next as M

    cache = M.create_cache(cfg, device=dev)
    logits, _ = M.forward(params, cfg,
                          torch.tensor(ids, dtype=torch.long, device=dev),
                          cache)
    return _nll_from_all_logits(_host(logits), ids)


_NLL_BY_MODULE = {
    "LLMConfig": _nll_llm,
    "MLAConfig": _nll_mla,
    "MambaConfig": _nll_mamba,
    "Qwen3NextConfig": _nll_qwen3next,
}


@torch.no_grad()
def probe_nll(params, cfg, ids: List[int],
              device: Optional[torch.device] = None) -> float:
    """The mean next-token NLL of ``ids`` under the model, on ``device``
    (the card by default), in full f32 where the model widens."""
    fn = _NLL_BY_MODULE.get(type(cfg).__name__)
    if fn is None:
        raise NotImplementedError(
            f"no NLL probe for config type {type(cfg).__name__}")
    dev = default_device(device, "run an NLL probe")
    with exact_f32():
        return fn(params, cfg, [int(i) for i in ids], dev)


# ---------------------------------------------------------------------------
# Per-kind checks
# ---------------------------------------------------------------------------

def _convert_gguf(path: str, arch: str, bits: Optional[int],
                  dev: torch.device):
    """The CLI's exact conversion route (``convert.gguf_convert_auto``,
    one shared dispatch table), returning (params, cfg, tokenizer)."""
    from trackiellm_tpu_torch.models import convert as C
    from trackiellm_tpu_torch.models.loader import read_gguf_header

    if arch == "bert":
        params, cfg, _ = C.gguf_to_bert_params(path, device=dev)
    else:
        params, cfg = C.gguf_convert_auto(path, bits=bits, device=dev)
    tok = None
    try:
        tok = C.tokenizer_from_gguf(read_gguf_header(path))
    except Exception as e:
        log.warning("tokenizer rebuild failed for %s: %s", path, e)
    return params, cfg, tok


def check_gguf(path: str, arch: str, opts: "Options") -> Dict[str, Any]:
    dev = opts.torch_device()
    entry: Dict[str, Any] = {"arch": arch}
    if arch == "bert":
        from trackiellm_tpu_torch.models.embedder import embed_forward

        params, cfg, _ = _convert_gguf(path, arch, None, dev)
        ids = torch.tensor([[1, 2, 3, 4]], dtype=torch.long, device=dev)
        with torch.no_grad():
            vecs = embed_forward(params, cfg, ids,
                                 torch.ones_like(ids)).cpu().numpy()
        if not np.all(np.isfinite(vecs)):
            raise RuntimeError("embedder produced non-finite vectors")
        entry["probe"] = {"mode": "embed-smoke",
                          "dim": int(vecs.shape[-1])}
        return entry

    params, cfg, tok = _convert_gguf(path, arch, opts.bits, dev)
    ids = _probe_ids(tok, cfg.vocab_size, opts.probe_tokens)
    entry["tokenizer"] = ("embedded" if tok is not None else
                          "absent (pseudo-id probe, non-decisive)")
    t0 = time.time()
    nll = probe_nll(params, cfg, ids, dev)
    entry["probe"] = {"mode": "nll", "text": tok is not None,
                      "nll": round(nll, 4),
                      "seconds": round(time.time() - t0, 1)}
    if not np.isfinite(nll):
        raise RuntimeError(f"probe NLL is not finite: {nll}")

    flag = ROPE_FLAGS.get(arch)
    if flag is not None and not opts.no_flags:
        env, default, alt = flag
        del params  # free before the second conversion
        old = os.environ.get(env)
        try:
            os.environ[env] = alt
            params_alt, cfg_alt, _ = _convert_gguf(path, arch, opts.bits,
                                                   dev)
            nll_alt = probe_nll(params_alt, cfg_alt, ids, dev)
            del params_alt
        finally:
            if old is None:
                os.environ.pop(env, None)
            else:
                os.environ[env] = old
        gap = abs(nll - nll_alt) / max(min(nll, nll_alt), 1e-9)
        winner = default if nll <= nll_alt else alt
        decisive = bool(gap > DECISIVE_GAP and tok is not None)
        entry["flag_probe"] = {
            "env": env, default: round(nll, 4), alt: round(nll_alt, 4),
            "winner": winner, "decisive": decisive,
        }
        if decisive and winner != default:
            entry.setdefault("actions", []).append(
                f"set {env}={winner} for this file (probe NLL "
                f"{nll_alt:.3f} vs {nll:.3f} at the default)")
    # Informational (does not affect status): the production next step.
    entry["next_step"] = (f"python -m trackiellm_tpu_torch convert {path} "
                          f"-o <checkpoint_dir> --bits 4")
    return entry


def check_ggml_whisper(path: str, opts: "Options") -> Dict[str, Any]:
    from trackiellm_tpu_torch.models import convert as C

    params, cfg, tok, mel = C.whisper_from_ggml(path,
                                                device=opts.torch_device())
    ids = tok.encode("ola") if hasattr(tok, "encode") else []
    return {"arch": "whisper-ggml",
            "probe": {"mode": "convert+vocab",
                      "n_audio_layers": cfg.n_audio_layers,
                      "n_mels": cfg.n_mels,
                      "vocab_ok": bool(getattr(tok, "decode", None)),
                      "mel_filters": [int(s) for s in mel.shape]},
            "tokenizer": "embedded" if ids != [] else "embedded (empty "
            "encode smoke)"}


def check_onnx_silero(path: str, opts: "Options") -> Dict[str, Any]:
    from trackiellm_tpu_torch.models import convert as C
    from trackiellm_tpu_torch.models import vad as V
    from trackiellm_tpu_torch.models.onnx_reader import (
        read_onnx_initializers)

    dev = opts.torch_device()
    state = read_onnx_initializers(path)
    entry: Dict[str, Any] = {"arch": "silero-vad"}
    try:
        params, cfg = C.silero_from_onnx(state, device=dev)
    except KeyError:
        # Real export with yet-unseen names: route through the staged
        # name map, record that it was needed.
        state = C.apply_name_map(state, C.load_name_map("silero_v5"))
        params, cfg = C.silero_from_onnx(state, device=dev)
        entry["name_map_applied"] = "silero_v5"
    rng = np.random.default_rng(0)
    chunk = torch.from_numpy(rng.standard_normal(512).astype(np.float32)
                             * 0.05).to(dev)
    with torch.no_grad(), exact_f32():
        p, _ = V.silero_step(params, cfg, chunk,
                             V.silero_init_state(cfg, dev))
    p = float(p)
    if not (0.0 <= p <= 1.0):
        raise RuntimeError(f"silero prob out of range: {p}")
    entry["probe"] = {"mode": "vad-step", "prob_on_noise": round(p, 4)}
    return entry


def check_onnx_piper(path: str, config: Optional[str],
                     opts: "Options") -> Dict[str, Any]:
    entry: Dict[str, Any] = {"arch": "piper-vits"}
    if config is None:
        raise RuntimeError(
            "piper voice without its voice config: expected "
            f"{path}.json (or {os.path.splitext(path)[0]}.json) — "
            "Piper voices need it for phoneme ids + sample rate")
    from trackiellm_tpu_torch.models.vits import VITSVoice

    voice = VITSVoice.from_piper(path, config, device=opts.torch_device())
    entry["probe"] = {"mode": "load", "sample_rate": voice.cfg.sample_rate}
    entry["name_map_applied"] = "piper_vits"
    if opts.deep:
        wav = voice.synthesize("ola")
        entry["probe"]["mode"] = "synth"
        entry["probe"]["samples"] = int(np.asarray(wav).size)
    return entry


def check_state_dict(path: str, opts: "Options") -> Dict[str, Any]:
    from trackiellm_tpu_torch.tools.parity_common import load_state_dict

    state = load_state_dict(path)
    names = list(state.keys())
    family, how = _classify_state_dict(names, path)
    entry: Dict[str, Any] = {"arch": family or "unknown",
                             "detected_by": how,
                             "n_tensors": len(names)}
    if family is None:
        entry["actions"] = [
            "could not classify; run tools/inspect_checkpoint.py "
            f"{path} and convert with an explicit --family"]
        raise RuntimeError("unclassified state dict")
    _convert_state_dict(family, state, path, entry, opts)
    return entry


def _classify_state_dict(names: List[str],
                         path: str) -> Tuple[Optional[str], str]:
    ns = set(names)

    def has(prefix: str) -> bool:
        return any(n.startswith(prefix) for n in ns)

    # Sibling HF config.json is authoritative when present.
    cfg_path = os.path.join(os.path.dirname(path), "config.json")
    if os.path.exists(cfg_path):
        try:
            mt = json.loads(open(cfg_path).read()).get("model_type", "")
            if mt:
                return f"hf:{mt}", "config.json model_type"
        except Exception:
            pass
    if has("encoder.blocks.0.attn.query"):
        return "whisper-torch", "openai-whisper module names"
    if has("model.0.conv") or has("model.0.bn"):
        return "ultralytics", "ultralytics module indices"
    if has("pretrained.layer1"):
        return "midas-small", "torch-hub MiDaS_small names"
    if has("backbone.embeddings") and has("neck."):
        return "dpt-swinv2", "HF DPT names"
    if has("backbone.layers.0.mixer"):
        return "mamba-hf", "HF mamba backbone names"
    if has("audio_spectrogram_transformer"):
        return "ast", "HF AST names"
    if (has("encoder.embeddings") or has("encoder.deit")) and any(
            "decoder.model.decoder" in n for n in ns):
        return "trocr", "HF VisionEncoderDecoder names"
    if has("enc_p."):
        return "piper-vits-pt", "VITS module names"
    if has("model.layers.0."):
        return None, ("HF LLM tree without config.json — model_type "
                      "needed to pick the converter")
    return None, "no known name signature"


def _hf_llm_converters(dev: torch.device):
    """HF model_type -> fn(state, config.json dict) -> (params, cfg) on
    ``dev``. Only families with an implemented converter appear; anything
    else reports the gap explicitly."""
    from trackiellm_tpu_torch.models import convert as C

    def plain(fn):
        return lambda state, conf: fn(state, device=dev)

    table = {
        "gemma2": plain(C.gemma2_from_hf),
        "gemma3": plain(C.gemma3_from_hf),
        "gemma3_text": plain(C.gemma3_from_hf),
        "smollm3": plain(C.smollm3_from_hf),
        "olmo2": plain(C.olmo2_from_hf),
        "mixtral": plain(C.mixtral_from_hf),
        "qwen2_moe": plain(C.qwen2_moe_from_hf),
        "qwen3": plain(C.qwen3_from_hf),
        "qwen3_moe": plain(C.qwen3_moe_from_hf),
        "deepseek_v2": plain(C.deepseek_v2_from_hf),
        "deepseek_v3": plain(C.deepseek_v3_from_hf),
        "granite": plain(C.granite_from_hf),
        "glm4": plain(C.glm4_from_hf),
        "glm4_moe": plain(C.glm4_moe_from_hf),
        "llama4": plain(C.llama4_from_hf),
        "llama4_text": plain(C.llama4_from_hf),
        "nemotron": plain(C.nemotron_from_hf),
        "starcoder2": plain(C.starcoder2_from_hf),
        "cohere": plain(C.cohere_from_hf),
        "cohere2": lambda state, conf: C.cohere_from_hf(
            state, sliding_window_pattern=int(
                conf.get("sliding_window_pattern", 4)), device=dev),
        "ernie4_5": plain(C.ernie45_from_hf),
        "ernie4_5_moe": plain(C.ernie45_from_hf),
        "gpt_oss": plain(C.gpt_oss_from_hf),
        "falcon": lambda state, conf: C.falcon_from_hf(
            state, n_heads=int(conf.get("num_attention_heads",
                                        conf.get("n_head", 0))),
            device=dev),
        "mamba": plain(C.mamba_from_hf),
        "falcon_mamba": plain(C.mamba_from_hf),
        "mamba2": lambda state, conf: C.mamba2_from_hf(
            state, n_groups=int(conf.get("n_groups", 8)), device=dev),
        "qwen3_next": lambda state, conf: C.qwen3_next_from_hf(
            state, conf, device=dev),
        "whisper": plain(C.whisper_from_torch),
    }
    return table


def _nll_probe_entry(params, cfg, opts: "Options",
                     finite: bool = True) -> Dict[str, Any]:
    """The pseudo-id NLL probe of a converted state dict; with ``finite``
    a non-finite NLL fails the artifact (the JAX harness checks it on the
    transformers route, not on mamba-hf)."""
    ids = _probe_ids(None, cfg.vocab_size, opts.probe_tokens)
    nll = probe_nll(params, cfg, ids, opts.torch_device())
    if finite and not np.isfinite(nll):
        raise RuntimeError(f"probe NLL not finite: {nll}")
    return {"mode": "nll", "text": False, "nll": round(float(nll), 4)}


def _convert_state_dict(family: str, state, path: str,
                        entry: Dict[str, Any], opts: "Options") -> None:
    from trackiellm_tpu_torch.models import convert as C

    dev = opts.torch_device()
    if family.startswith("hf:"):
        mt = family[3:]
        conf = {}
        cfg_path = os.path.join(os.path.dirname(path), "config.json")
        if os.path.exists(cfg_path):
            conf = json.loads(open(cfg_path).read())
        table = _hf_llm_converters(dev)
        if mt not in table:
            entry["actions"] = [
                f"model_type {mt!r} has no converter yet — see "
                "docs/MODELS.md for the implemented families"]
            raise RuntimeError(f"unsupported model_type {mt!r}")
        params, cfg = table[mt](state, conf)
        entry["config_type"] = type(cfg).__name__
        if type(cfg).__name__ in _NLL_BY_MODULE:
            entry["probe"] = _nll_probe_entry(params, cfg, opts)
        else:
            entry["probe"] = {"mode": "convert-only"}
        return
    if family == "whisper-torch":
        params, cfg = C.whisper_from_torch(state, device=dev)
        entry["probe"] = {"mode": "convert", "n_mels": cfg.n_mels}
    elif family == "ultralytics":
        params, cfg = C.detector_from_torch(state, device=dev)
        entry["probe"] = {"mode": "convert",
                          "num_classes": cfg.num_classes}
    elif family == "midas-small":
        C.midas_small_from_torch(state, device=dev)
        entry["probe"] = {"mode": "convert"}
    elif family == "dpt-swinv2":
        C.dpt_swinv2_from_torch(state, device=dev)
        entry["probe"] = {"mode": "convert"}
    elif family == "mamba-hf":
        params, cfg = C.mamba_from_hf(state, device=dev)
        entry["probe"] = _nll_probe_entry(params, cfg, opts, finite=False)
    elif family == "ast":
        params, cfg = C.ast_from_hf(state, device=dev)
        entry["probe"] = {"mode": "convert",
                          "n_labels": cfg.n_labels}
    elif family == "trocr":
        conf = None
        cfg_path = os.path.join(os.path.dirname(path), "config.json")
        if os.path.exists(cfg_path):
            conf = json.loads(open(cfg_path).read())
        params, cfg = C.trocr_from_hf(state, conf, device=dev)
        entry["probe"] = {"mode": "convert",
                          "image_size": cfg.image_size}
    elif family == "piper-vits-pt":
        entry["actions"] = [
            "VITS torch checkpoint: pair it with its voice .json and "
            "load via VITSVoice.from_piper"]
        C.vits_from_torch(state, device=dev)
        entry["probe"] = {"mode": "convert"}
    else:  # pragma: no cover
        raise RuntimeError(f"no converter route for {family}")


# ---------------------------------------------------------------------------
# Parity companions
# ---------------------------------------------------------------------------

_KIND_TO_PARITY = {
    "gguf": "llm",
    "ggml-whisper": "asr",
    "onnx-silero": "vad",
    "onnx-piper": "tts",
}
_FAMILY_TO_PARITY = {
    "whisper-torch": "asr",
    "ultralytics": "detector",
    "midas-small": "depth",
    "dpt-swinv2": "depth",
    "trocr": "ocr",
}


def _child_ready(stderr: str, spawned: float) -> Optional[Dict[str, Any]]:
    """The twin's ``ready`` line: seconds from spawn to ready, and whether
    the child ran nvcc (None off the card); with its ``launches`` line (on
    the card), its kernels' launch counts."""
    from trackiellm_tpu_torch.tools.parity_common import (LAUNCHES_PREFIX,
                                                          READY_PREFIX)

    child = None
    for line in stderr.splitlines():
        if line.startswith(READY_PREFIX):
            info = json.loads(line[len(READY_PREFIX):])
            child = {"ready_s": round(info["at"] - spawned, 3),
                     "device": info["device"],
                     "compiled": info["compiled"]}
        elif line.startswith(LAUNCHES_PREFIX) and child is not None:
            child["launches"] = json.loads(line[len(LAUNCHES_PREFIX):])
    return child


def _parity_for(path: str, kind: str, entry: Dict[str, Any],
                repo_root: str, opts: "Options",
                ) -> Optional[Dict[str, Any]]:
    tool = _KIND_TO_PARITY.get(kind) or _FAMILY_TO_PARITY.get(
        entry.get("arch", ""))
    if tool is None:
        return None
    stem = os.path.splitext(path)[0]
    needed, cmd = COMPANIONS[tool]
    # Piper voices ship the config as either voice.onnx.json or
    # voice.json (sniffing accepts both) — resolve to whichever
    # exists, preferring the first.
    vcfg = next((p for p in (path + ".json", stem + ".json")
                 if os.path.exists(p)), path + ".json")
    sub = {"a": path, "stem": stem, "TEXT": "{TEXT}",
           "QUANT": str(opts.quantize), "VCFG": vcfg}
    paths = [n.format(**sub) for n in needed]
    command = ([sys.executable] + [c.format(**sub) for c in cmd]
               + ["--device", str(opts.torch_device())])
    if "{TEXT}" in command:
        text_path = f"{stem}.text.txt"
        text = (open(text_path).read().strip()
                if os.path.exists(text_path) else "")
        command = [text if c == "{TEXT}" else c for c in command]
    if not all(os.path.exists(p) for p in paths):
        return {"ran": False,
                "missing": [p for p in paths if not os.path.exists(p)],
                "suggested": " ".join(command)}
    spawned = time.time()
    proc = subprocess.run(command, capture_output=True, text=True,
                          cwd=repo_root, timeout=3600)
    result: Dict[str, Any] = {"ran": True, "rc": proc.returncode,
                              "command": " ".join(command)}
    for line in reversed(proc.stdout.strip().splitlines()):
        try:
            result["metrics"] = json.loads(line)
            break
        except ValueError:
            continue
    child = _child_ready(proc.stderr, spawned)
    if child is not None:
        result["child"] = child
    if proc.returncode != 0:
        result["stderr_tail"] = proc.stderr.strip().splitlines()[-3:]
    return result


# ---------------------------------------------------------------------------
# Running a directory
# ---------------------------------------------------------------------------

class Options:
    def __init__(self, bits: Optional[int] = None, probe_tokens: int = 32,
                 no_flags: bool = False, deep: bool = False,
                 strict: bool = False, quantize: int = 4,
                 device=None):
        self.bits = bits
        self.probe_tokens = probe_tokens
        self.no_flags = no_flags
        self.deep = deep
        self.strict = strict
        # Requantization the parity_llm companion runs under (4 =
        # the reference's Q4 serving; 0 = float, for models whose dims
        # don't tile the quant groups).
        self.quantize = quantize
        # Where the probes and the parity children run: the CUDA card
        # unless a device is given.
        self.device = device

    def torch_device(self) -> torch.device:
        return default_device(self.device, "run first_contact")


def check_artifact(path: str, opts: Options,
                   repo_root: str = CHECKOUT) -> Optional[Dict[str, Any]]:
    try:
        info = sniff(path)
    except Exception as e:
        # A corrupt/truncated file (half-copied checkpoint) must mark
        # THIS artifact FAIL, never abort the whole gauntlet.
        return {"file": os.path.basename(path), "kind": "unreadable",
                "status": "FAIL",
                "error": f"{type(e).__name__}: {e}",
                "seconds": 0.0}
    kind = info.pop("kind")
    if kind == "skip":
        return None
    if kind == "hf-shard":
        # Individual shards are handled as a GROUP by run(); reaching
        # here means check_artifact was called on one directly.
        return {"file": os.path.basename(path), "kind": kind,
                "status": "WARN",
                "actions": ["run the harness on the DIRECTORY — "
                            "shard groups merge automatically"]}
    entry: Dict[str, Any] = {"file": os.path.basename(path),
                             "kind": kind, **info}
    if opts.strict:
        os.environ["TRACKIE_GGUF_STRICT"] = "1"
    tap = _WarningTap()
    t0 = time.time()
    try:
        with tap:
            if kind == "gguf":
                entry.update(check_gguf(path, info.get("arch", ""),
                                        opts))
            elif kind == "gguf-mmproj":
                from trackiellm_tpu_torch.models.convert import (
                    gguf_to_clip_params)

                _, ccfg = gguf_to_clip_params(path,
                                              device=opts.torch_device())
                entry["probe"] = {"mode": "convert",
                                  "layers": ccfg.n_layers}
            elif kind == "ggml-whisper":
                entry.update(check_ggml_whisper(path, opts))
            elif kind == "onnx-silero":
                entry.update(check_onnx_silero(path, opts))
            elif kind == "onnx-piper":
                entry.update(check_onnx_piper(path, info.get("config"),
                                              opts))
            elif kind == "onnx-weights":
                entry["probe"] = {"mode": "inventory-only"}
                entry["actions"] = [
                    "generic ONNX weights: run tools/inspect_checkpoint"
                    ".py and pick a converter (docs/REAL_WEIGHTS.md)"]
            elif kind == "state-dict":
                entry.update(check_state_dict(path, opts))
        entry["status"] = "PASS"
    except Exception as e:
        entry["status"] = "FAIL"
        entry["error"] = f"{type(e).__name__}: {e}"
        entry["trace_tail"] = traceback.format_exc().splitlines()[-3:]
    finally:
        if opts.strict:
            os.environ.pop("TRACKIE_GGUF_STRICT", None)
    entry["seconds"] = round(time.time() - t0, 1)
    if tap.records:
        entry["warnings"] = tap.records
        if entry["status"] == "PASS":
            entry["status"] = "WARN"
    if entry.get("actions") and entry["status"] == "PASS":
        entry["status"] = "WARN"
    try:
        parity = _parity_for(path, kind, entry, repo_root, opts)
    except Exception as e:  # subprocess/timeout issues never mask convert
        parity = {"ran": True, "rc": -1,
                  "error": f"{type(e).__name__}: {e}"}
    if parity is not None:
        entry["parity"] = parity
        if parity.get("ran") and parity.get("rc", 0) != 0:
            entry["status"] = "FAIL"
    return entry


def check_shard_group(prefix: str, paths: List[str],
                      opts: Options) -> Dict[str, Any]:
    """Merge a model-XXXXX-of-YYYYY.safetensors group into one state
    dict and route it through the state-dict check — the layout most
    published HF checkpoints actually ship in."""
    from trackiellm_tpu_torch.tools.parity_common import load_state_dict

    entry: Dict[str, Any] = {
        "file": f"{os.path.basename(prefix)}-*.safetensors "
                f"({len(paths)} shards)",
        "kind": "hf-sharded"}
    tap = _WarningTap()
    t0 = time.time()
    try:
        with tap:
            state: Dict[str, Any] = {}
            for p in sorted(paths):
                state.update(load_state_dict(p))
            names = list(state.keys())
            family, how = _classify_state_dict(names, paths[0])
            entry.update(arch=family or "unknown", detected_by=how,
                         n_tensors=len(names))
            if family is None:
                entry["actions"] = [
                    "could not classify the merged shards; a sibling "
                    "config.json with model_type picks the converter"]
                raise RuntimeError("unclassified sharded checkpoint")
            _convert_state_dict(family, state, paths[0], entry, opts)
        entry["status"] = "PASS"
    except Exception as e:
        entry["status"] = "FAIL"
        entry["error"] = f"{type(e).__name__}: {e}"
        entry["trace_tail"] = traceback.format_exc().splitlines()[-3:]
    entry["seconds"] = round(time.time() - t0, 1)
    if tap.records:
        entry["warnings"] = tap.records
        if entry["status"] == "PASS":
            entry["status"] = "WARN"
    if entry.get("actions") and entry["status"] == "PASS":
        entry["status"] = "WARN"
    return entry


def run(directory: str, report_path: Optional[str] = None,
        opts: Optional[Options] = None) -> Dict[str, Any]:
    opts = opts or Options()
    files = sorted(
        os.path.join(directory, f) for f in os.listdir(directory)
        if os.path.isfile(os.path.join(directory, f)))
    # Group sharded HF checkpoints (model-00001-of-00002.safetensors)
    # and check each group merged, each remaining file individually.
    groups: Dict[str, List[str]] = {}
    singles: List[str] = []
    for path in files:
        m = _SHARD_RE.search(os.path.basename(path))
        if m:
            prefix = path[: path.rindex(m.group(0))]
            groups.setdefault(prefix, []).append(path)
        else:
            singles.append(path)
    artifacts: List[Dict[str, Any]] = []
    for prefix, paths in sorted(groups.items()):
        entry = check_shard_group(prefix, paths, opts)
        artifacts.append(entry)
        log.info("first_contact %s: %s (%ss)", entry["file"],
                 entry["status"], entry.get("seconds"))
    for path in singles:
        entry = check_artifact(path, opts)
        if entry is None:
            continue
        artifacts.append(entry)
        log.info("first_contact %s: %s (%ss)", entry["file"],
                 entry["status"], entry.get("seconds"))
    summary = {s: sum(1 for a in artifacts if a["status"] == s)
               for s in ("PASS", "WARN", "FAIL")}
    report = {"directory": os.path.abspath(directory),
              "artifacts": artifacts, "summary": summary}
    if report_path:
        with open(report_path, "w") as f:
            json.dump(report, f, indent=1)
    return report


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="first_contact",
        description="validate a directory of real checkpoints")
    ap.add_argument("directory")
    ap.add_argument("--report", default=None,
                    help="write the JSON report here")
    ap.add_argument("--bits", type=int, default=None, choices=(4, 8),
                    help="requantize LLM matrices during the probe "
                    "(default: keep float — fastest, highest fidelity)")
    ap.add_argument("--probe-tokens", type=int, default=32)
    ap.add_argument("--no-flags", action="store_true",
                    help="skip the rope-layout flag gauntlet (halves "
                    "LLM conversion work)")
    ap.add_argument("--deep", action="store_true",
                    help="heavier probes (e.g. full Piper synthesis)")
    ap.add_argument("--strict", action="store_true",
                    help="TRACKIE_GGUF_STRICT=1: absent math-bearing "
                    "GGUF keys fail instead of defaulting")
    ap.add_argument("--device", default=None,
                    help="torch device of the probes and the parity "
                    "children (default: the CUDA card)")
    args = ap.parse_args(argv)
    report = run(args.directory, args.report,
                 Options(bits=args.bits, probe_tokens=args.probe_tokens,
                         no_flags=args.no_flags, deep=args.deep,
                         strict=args.strict, device=args.device))
    for a in report["artifacts"]:
        line = f"{a['status']:4s} {a['kind']:14s} {a['file']}"
        probe = a.get("probe", {})
        if "nll" in probe:
            line += f"  nll={probe['nll']}"
        fp = a.get("flag_probe")
        if fp:
            line += (f"  rope->{fp['winner']}"
                     f"{' (decisive)' if fp['decisive'] else ''}")
        print(line)
        for act in a.get("actions", []):
            print(f"     action: {act}")
        if a["status"] == "FAIL":
            print(f"     error: {a.get('error')}")
    s = report["summary"]
    print(f"# {s['PASS']} PASS / {s['WARN']} WARN / {s['FAIL']} FAIL"
          + (f"  -> report {args.report}" if args.report else ""))
    return 1 if s["FAIL"] else 0


if __name__ == "__main__":
    raise SystemExit(main())
