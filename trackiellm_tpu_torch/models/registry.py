"""Model service: process-wide registry of loaded model handles.

A copy of ``trackiellm_tpu/models/registry.py`` (framework-free; only its
import of the errors module differs). Parity target: the Rust
``model_service`` crate's singleton registry — ``ModelId::{MainLlm,
ObjectDetector}`` -> Arc<Mutex<handle>> (reference:
src/model_service/src/lib.rs:20-25) — widened to the full model set.
"""

from __future__ import annotations

import enum
import threading
from typing import Any, Callable, Dict, Optional

from trackiellm_tpu_torch.utils.errors import ErrorCode, TrackieError


class ModelId(enum.Enum):
    MAIN_LLM = "main_llm"
    OBJECT_DETECTOR = "object_detector"
    DEPTH_ESTIMATOR = "depth_estimator"
    ASR = "asr"
    TTS = "tts"
    VAD = "vad"
    OCR = "ocr"
    SOUND_CLASSIFIER = "sound_classifier"
    WAKE_WORD = "wake_word"


class ModelService:
    """Thread-safe registry with lazy factories."""

    def __init__(self):
        self._handles: Dict[ModelId, Any] = {}
        self._factories: Dict[ModelId, Callable[[], Any]] = {}
        self._lock = threading.RLock()

    def register(self, model_id: ModelId, handle: Any) -> None:
        with self._lock:
            self._handles[model_id] = handle

    def register_factory(self, model_id: ModelId,
                         factory: Callable[[], Any]) -> None:
        """Lazy registration: the model materializes on first get()."""
        with self._lock:
            self._factories[model_id] = factory

    def get(self, model_id: ModelId) -> Any:
        with self._lock:
            if model_id in self._handles:
                return self._handles[model_id]
            factory = self._factories.get(model_id)
            if factory is None:
                raise TrackieError(ErrorCode.NOT_FOUND, model_id.value)
            handle = factory()
            self._handles[model_id] = handle
            return handle

    def try_get(self, model_id: ModelId) -> Optional[Any]:
        try:
            return self.get(model_id)
        except TrackieError:
            return None

    def unload(self, model_id: ModelId) -> bool:
        with self._lock:
            return self._handles.pop(model_id, None) is not None

    def loaded(self) -> Dict[str, bool]:
        with self._lock:
            return {m.value: m in self._handles for m in ModelId}


_GLOBAL: Optional[ModelService] = None
_GLOBAL_LOCK = threading.Lock()


def global_model_service() -> ModelService:
    """The singleton accessor (parity: model_service's global registry)."""
    global _GLOBAL
    with _GLOBAL_LOCK:
        if _GLOBAL is None:
            _GLOBAL = ModelService()
        return _GLOBAL
