"""ASR engine: audio in, transcript out, over the Whisper model.

Port of ``trackiellm_tpu/audio/asr.py`` (the reference's
``tk_asr_whisper``: init from file, full-segment greedy transcription,
language switch). The engine owns the mel front end, the padding to the
model's window and the tokenizer's decode; it runs on its params' device.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from trackiellm_tpu_torch.llm.tokenizer import ByteTokenizer, Tokenizer
from trackiellm_tpu_torch.models import whisper as whisper_model
from trackiellm_tpu_torch.ops.mel import (HOP_LENGTH, SAMPLE_RATE,
                                          log_mel_spectrogram)
from trackiellm_tpu_torch.ops.resample import resample_poly
from trackiellm_tpu_torch.utils.logging import get_logger

log = get_logger("audio.asr")


class WhisperASR:
    """Segment transcriber with one mel window (one shape a config)."""

    def __init__(self, params: Dict[str, Any],
                 cfg: whisper_model.WhisperConfig,
                 tokenizer: Optional[Tokenizer] = None,
                 language: int = 0,
                 max_tokens: int = 96):
        self.params = params
        self.cfg = cfg
        self.device = params["tok_emb"].device
        # Real deployments load the Whisper vocab; the byte tokenizer keeps
        # the engine self-contained for tests.
        self.tokenizer = tokenizer or ByteTokenizer(cfg.vocab_size)
        self.language = language
        self.max_tokens = max_tokens
        # Mel frames per segment window: audio ctx is frames/2.
        self._mel_frames = cfg.n_audio_ctx * 2

    def set_language(self, language: int) -> None:
        """The language-switch API (tk_asr_whisper.c:386)."""
        self.language = language

    def mel(self, audio: np.ndarray,
            sample_rate: int = SAMPLE_RATE) -> torch.Tensor:
        """The model's (n_mels, 2 * n_audio_ctx) log-mel input: audio at
        another rate is resampled to 16 kHz, then the samples are padded or
        trimmed to the window before the mel, as the reference does (zero
        samples land on the log-mel floor without moving the global
        max)."""
        x = torch.as_tensor(np.asarray(audio, np.float32).ravel(),
                            device=self.device)
        if sample_rate != SAMPLE_RATE:
            x = resample_poly(x, SAMPLE_RATE, sample_rate)
        n_samples = self._mel_frames * HOP_LENGTH
        x = x[:n_samples]
        if x.shape[0] < n_samples:
            x = torch.nn.functional.pad(x, (0, n_samples - x.shape[0]))
        return log_mel_spectrogram(x, n_mels=self.cfg.n_mels)

    def transcribe_ids(self, audio: np.ndarray,
                       sample_rate: int = SAMPLE_RATE) -> list:
        """Mono f32 audio -> the greedy text token ids."""
        return whisper_model.transcribe_tokens(
            self.params, self.cfg, self.mel(audio, sample_rate),
            max_tokens=self.max_tokens, language=self.language)

    def transcribe(self, audio: np.ndarray,
                   sample_rate: int = SAMPLE_RATE) -> str:
        """Mono f32 audio -> transcript text."""
        return self.tokenizer.decode(
            self.transcribe_ids(audio, sample_rate)).strip()

    def __call__(self, audio: np.ndarray) -> str:
        return self.transcribe(audio)
