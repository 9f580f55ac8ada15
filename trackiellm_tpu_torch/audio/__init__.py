"""The voice path: the streaming pipeline (wake word -> VAD -> ASR -> TTS
with priority interruption), ASR over Whisper, streaming transcription,
the phonemizer, the TTS engine and the wake word (ports of
``trackiellm_tpu/audio/``; ``pipeline.py`` is a copy)."""

from trackiellm_tpu_torch.audio.pipeline import (  # noqa: F401
    AudioPipeline,
    AudioPipelineConfig,
    AudioState,
    TTSPriority,
)
