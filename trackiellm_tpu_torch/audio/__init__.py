"""The voice path's engines: ASR over Whisper, streaming transcription, the
phonemizer and the TTS engine (ports of ``trackiellm_tpu/audio/``)."""
