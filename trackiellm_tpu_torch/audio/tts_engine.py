"""TTS engine: text in, waveform out, over the TTS model.

Port of ``trackiellm_tpu/audio/tts_engine.py`` (the reference's
``tk_tts_piper``: synth-to-buffer, synth-to-callback, voice params,
model info). Long texts are cut at sentence boundaries to fit the acoustic
model's fixed frame window, then joined.
"""

from __future__ import annotations

import re
from typing import Any, Callable, Dict, Iterable, Optional

import numpy as np

from trackiellm_tpu_torch.models import tts as tts_model
from trackiellm_tpu_torch.utils.logging import get_logger

log = get_logger("audio.tts")

_SENTENCE_SPLIT = re.compile(r"(?<=[.!?;])\s+")


class TTSEngine:
    """Piper-style synthesis surface over the acoustic + vocoder models,
    on the params' device."""

    def __init__(self, params: Dict[str, Any],
                 cfg: tts_model.TTSConfig, rate: float = 1.0,
                 sample_rate: int = 16_000,
                 lang: Optional[str] = None):
        self.params = params
        self.cfg = cfg
        self.rate = rate
        self.sample_rate = sample_rate
        # Language selects the phonemic front end (tk_tts_piper.h:50's
        # language code); None keeps the grapheme charset.
        self.lang = lang
        if lang is not None:
            from trackiellm_tpu_torch.audio.phonemizer import PhonemeFrontend

            self.frontend = PhonemeFrontend(lang)
            if cfg.vocab_size != PhonemeFrontend.vocab_size:
                raise ValueError(
                    "phonemic TTS needs cfg.vocab_size == "
                    f"{PhonemeFrontend.vocab_size}, got {cfg.vocab_size}")
        else:
            self.frontend = None

    def set_rate(self, rate: float) -> None:
        """Voice speaking-rate parameter (tk_tts_piper voice params)."""
        self.rate = max(0.25, min(rate, 4.0))

    def model_info(self) -> Dict[str, Any]:
        return {
            "sample_rate": self.sample_rate,
            "max_chars_per_chunk": self.cfg.max_chars,
            "hop": self.cfg.hop,
            "rate": self.rate,
            "lang": self.lang,
        }

    def _chunks(self, text: str) -> Iterable[str]:
        for sentence in _SENTENCE_SPLIT.split(text.strip()):
            s = sentence.strip()
            while len(s) > self.cfg.max_chars:
                cut = s.rfind(" ", 0, self.cfg.max_chars)
                cut = cut if cut > 0 else self.cfg.max_chars
                yield s[:cut]
                s = s[cut:].strip()
            if s:
                yield s

    def synthesize(self, text: str) -> np.ndarray:
        """Synth-to-buffer: full waveform for the text."""
        parts = []
        for chunk in self._chunks(text):
            wav, n = tts_model.synthesize(self.params, self.cfg, chunk,
                                          rate=self.rate,
                                          frontend=self.frontend)
            parts.append(wav[:n])
        if not parts:
            return np.zeros(0, np.float32)
        return np.concatenate(parts)

    def stream(self, text: str) -> Iterable[np.ndarray]:
        """Generator of waveform chunks: sentence pieces go through the
        chunked vocoder (models.tts.synthesize_streaming), so the first
        ~0.64 s of audio is ready after one small vocoder pass."""
        for piece in self._chunks(text):
            yield from tts_model.synthesize_streaming(
                self.params, self.cfg, piece, rate=self.rate,
                frontend=self.frontend)

    def synthesize_streaming(self, text: str,
                             on_chunk: Callable[[np.ndarray], None]) -> int:
        """Synth-to-callback: each vocoder chunk is delivered as soon as it
        is ready. Returns total samples."""
        total = 0
        for wav in self.stream(text):
            on_chunk(wav)
            total += len(wav)
        return total

    def __call__(self, text: str) -> np.ndarray:
        return self.synthesize(text)
