"""Native checkpoint save/load, in the JAX package's format.

Port of ``trackiellm_tpu/models/checkpoint.py`` with numpy and torch only: a
checkpoint is a directory of three files, all readable with plain numpy,
which the two packages read and write alike:

- ``arrays.npz``: one array per leaf, quantized leaves as ``<path>.values``
  and ``<path>.scales``; bf16 is stored as its uint16 view;
- ``tree.json``: the tree, with ``{"__qlin__": path}`` for a
  ``QuantizedLinear`` and ``{"__leaf__": path, "__dtype__": ...}`` for an
  array, and a ``dtypes`` table by leaf name;
- ``config.json``: the metadata, the config with its class name, and the Q4
  nibble encoding (``q4_packing``) when the tree holds Q4 values.

So a checkpoint that the JAX package converted (``python -m trackiellm_tpu
convert model.gguf -o DIR --bits 8``) loads here, and the reverse. The
configs read are ``LLMConfig`` and the voice models' (``WhisperConfig``,
``TTSConfig``, ``VITSConfig``); a Whisper checkpoint may also carry its
config in the metadata (``whisper_config``), as the JAX package's
``transcribe`` reads it.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from trackiellm_tpu_torch.models.llm import LLMConfig
from trackiellm_tpu_torch.ops.backend import default_device
from trackiellm_tpu_torch.ops.quant import QuantizedLinear
from trackiellm_tpu_torch.utils.errors import ErrorCode, TrackieError

_CONFIG_FILE = "config.json"
_TREE_FILE = "tree.json"
_ARRAYS_FILE = "arrays.npz"

# Q4 packed-nibble encoding. "mixed-bias-v2": low nibble biased +8, high
# nibble two's complement (ops/quant.py quantize_q4). Checkpoints written
# before the marker existed used "biased-v1" (both nibbles biased +8); the
# loader repacks them instead of mis-decoding them.
_Q4_PACKING = "mixed-bias-v2"

# Config classes of other model families, and the ROADMAP item that ports
# them.
_WAITING = {
    "MLAConfig": "model zoo, models/mla.py (ROADMAP Queue 1 item 11)",
    "MambaConfig": "model zoo, models/mamba.py (ROADMAP Queue 1 item 11)",
    "Mamba2Config": "model zoo, models/mamba2.py (ROADMAP Queue 1 item 11)",
    "Qwen3NextConfig": ("model zoo, models/qwen3next.py (ROADMAP Queue 1 "
                        "item 11)"),
    "CLIPVisionConfig": "vision, models/clip.py (ROADMAP Queue 1 item 11)",
    "TrOCRConfig": "vision, models/trocr.py (ROADMAP Queue 1 item 11)",
}


def _repack_q4_biased_v1(packed: np.ndarray) -> np.ndarray:
    """Legacy biased-v1 packed Q4 (both nibbles q + 8) to mixed-bias-v2
    (high nibble two's complement)."""
    lo = packed & 0x0F
    hi = ((packed >> 4) & 0x0F).astype(np.int16) - 8
    hi = (hi & 0x0F).astype(np.uint8)
    return (lo | (hi << 4)).astype(np.uint8)


def _to_numpy(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    """A leaf's bytes as numpy, and the dtype name the JAX package writes
    for it (bf16 travels as its uint16 view)."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


def _flatten(params: Any) -> Tuple[Dict[str, np.ndarray], Dict[str, str],
                                   Any]:
    leaves: Dict[str, np.ndarray] = {}
    dtypes: Dict[str, str] = {}

    def leaf(name: str, t: torch.Tensor) -> str:
        leaves[name], dtypes[name] = _to_numpy(t)
        return dtypes[name]

    def walk(node, prefix):
        if isinstance(node, QuantizedLinear):
            leaf(f"{prefix}.values", node.values)
            leaf(f"{prefix}.scales", node.scales)
            return {"__qlin__": prefix}
        if isinstance(node, dict):
            return {k: walk(v, f"{prefix}.{k}" if prefix else k)
                    for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v, f"{prefix}[{i}]") for i, v in enumerate(node)]
        return {"__leaf__": prefix,
                "__dtype__": leaf(prefix, torch.as_tensor(node))}

    tree = walk(params, "")
    return leaves, dtypes, tree


def _write_atomic(path: str, text: str) -> None:
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".",
                               prefix=".tmp-")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(text.encode("utf-8"))
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def save_checkpoint(directory: str, params: Any,
                    config: Optional[LLMConfig] = None,
                    metadata: Optional[Dict] = None) -> None:
    """Save params (+ config + metadata) to ``directory`` in the JAX
    package's format: ``tree.json`` and ``config.json`` come out as the
    JAX writer writes them for the same tree, and ``arrays.npz`` holds the
    same array bytes under the same names."""
    os.makedirs(directory, exist_ok=True)
    leaves, dtypes, tree = _flatten(params)
    np.savez(os.path.join(directory, _ARRAYS_FILE), **leaves)
    _write_atomic(os.path.join(directory, _TREE_FILE),
                  json.dumps({"tree": tree, "dtypes": dtypes}))
    has_q4 = any(name.endswith(".values") and arr.dtype == np.uint8
                 for name, arr in leaves.items())
    sidecar: Dict[str, Any] = {
        "metadata": metadata or {},
        "format": {"q4_packing": _Q4_PACKING} if has_q4 else {}}
    if config is not None:
        sidecar["config"] = dict(config._asdict())
        sidecar["config_class"] = type(config).__name__
    _write_atomic(os.path.join(directory, _CONFIG_FILE),
                  json.dumps(sidecar, indent=1))


def _from_numpy(a: np.ndarray, dtype: Optional[str],
                device: Optional[torch.device]) -> torch.Tensor:
    if dtype == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16)).view(
            torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(a))
    return t.to(device) if device is not None else t


def _unflatten(tree: Any, arrays: Dict[str, torch.Tensor]) -> Any:
    def walk(node):
        if isinstance(node, dict):
            if "__qlin__" in node:
                p = node["__qlin__"]
                return QuantizedLinear(values=arrays[f"{p}.values"],
                                       scales=arrays[f"{p}.scales"])
            if "__leaf__" in node:
                return arrays[node["__leaf__"]]
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        raise TrackieError(ErrorCode.MODEL_METADATA_INVALID,
                           f"bad tree node {node!r}")

    return walk(tree)


def _voice_config(cls: str):
    """The voice models' config classes, imported when a checkpoint names
    one (their modules import this one's neighbours, not this module)."""
    if cls == "WhisperConfig":
        from trackiellm_tpu_torch.models.whisper import WhisperConfig
        return WhisperConfig
    if cls == "TTSConfig":
        from trackiellm_tpu_torch.models.tts import TTSConfig
        return TTSConfig
    if cls == "VITSConfig":
        from trackiellm_tpu_torch.models.vits import VITSConfig
        return VITSConfig
    return None


def _tuples(v):
    """JSON's lists back to the tuples configs keep (hashable)."""
    return tuple(_tuples(x) for x in v) if isinstance(v, list) else v


def _config(sidecar: Dict[str, Any], directory: str):
    if "config" not in sidecar:
        return None
    cls = sidecar.get("config_class")
    if cls in _WAITING:
        raise NotImplementedError(
            f"{directory} holds a {cls} checkpoint: {_WAITING[cls]} is not "
            "ported yet")
    config_cls = LLMConfig if cls == "LLMConfig" else _voice_config(cls)
    if config_cls is None:
        raise NotImplementedError(
            f"{directory}: config class {cls!r} is not supported; the port "
            "loads LLMConfig checkpoints and the voice models' "
            "(WhisperConfig, TTSConfig, VITSConfig)")
    return config_cls(**{k: _tuples(v)
                         for k, v in sidecar["config"].items()})


def load_checkpoint(directory: str, device: Optional[torch.device] = None,
                    ) -> Tuple[Any, Optional[Any], Dict]:
    """Load (params on ``device``, config or None, metadata). Legacy
    biased-v1 Q4 values are repacked; an unknown Q4 packing raises.
    ``device`` defaults to the current CUDA card; with no card it raises
    rather than fall back to the CPU, which must be asked for."""
    tree_path = os.path.join(directory, _TREE_FILE)
    if not os.path.exists(tree_path):
        raise TrackieError(ErrorCode.FILE_NOT_FOUND, directory)
    device = default_device(device, "load a checkpoint")
    with open(tree_path, encoding="utf-8") as f:
        spec = json.load(f)
    with open(os.path.join(directory, _CONFIG_FILE), encoding="utf-8") as f:
        sidecar = json.load(f)
    cfg = _config(sidecar, directory)
    q4_packing = sidecar.get("format", {}).get("q4_packing")
    arrays = {}
    with np.load(os.path.join(directory, _ARRAYS_FILE)) as z:
        for name in z.files:
            a = z[name]
            if (name.endswith(".values") and a.dtype == np.uint8
                    and q4_packing != _Q4_PACKING):
                if q4_packing not in (None, "biased-v1"):
                    raise TrackieError(
                        ErrorCode.MODEL_METADATA_INVALID,
                        f"unknown q4_packing {q4_packing!r} in {directory}; "
                        f"expected {_Q4_PACKING!r}: re-convert the model")
                a = _repack_q4_biased_v1(a)
            arrays[name] = _from_numpy(a, spec["dtypes"].get(name), device)
    return _unflatten(spec["tree"], arrays), cfg, sidecar.get("metadata", {})
