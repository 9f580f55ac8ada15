"""Incremental (streaming) ASR: stable partial transcripts during speech,
not only at its end.

A copy of ``trackiellm_tpu/audio/streaming_asr.py``, which uses no JAX
(only its import of the logger differs). The reference's tk_asr_whisper
transcribes only the finalized utterance
(src/audio/tk_asr_whisper.c:142-175); this transcriber instead:

  - re-transcribes the whole buffered utterance every ``refresh_s`` of
    new audio;
  - emits as STABLE the longest common word-prefix of the last
    ``agreement`` consecutive hypotheses (LocalAgreement-n, the
    whisper-streaming recipe), so flicker in the tail never escapes;
  - keeps the stable prefix monotone (it never retracts), so consumers
    can act on it at once, e.g. prefill the stable transcript into the
    LLM cache while the user is still speaking (the runner's extend
    path).

``finalize()`` runs the authoritative full-buffer pass, so the final
transcript is exactly what the non-streaming engine would produce.
"""

from __future__ import annotations

from typing import Callable, List, Optional

import numpy as np

from trackiellm_tpu_torch.utils.logging import get_logger

log = get_logger("audio.streaming_asr")


def _common_prefix(a: List[str], b: List[str]) -> List[str]:
    out = []
    for x, y in zip(a, b):
        if x != y:
            break
        out.append(x)
    return out


class StreamingTranscriber:
    """LocalAgreement-n incremental transcription over an ``asr_fn``.

    ``asr_fn(audio f32[T]) -> str`` is any full-segment transcriber
    (e.g. audio.asr.WhisperASR). Feed speech chunks as they arrive;
    read ``stable_text`` or receive ``on_partial(text)`` callbacks as
    the agreed prefix grows; call ``finalize()`` at end-of-speech.
    """

    def __init__(self, asr_fn: Callable[[np.ndarray], str],
                 sample_rate: int = 16000,
                 refresh_s: float = 1.0,
                 agreement: int = 2,
                 on_partial: Optional[Callable[[str], None]] = None):
        if agreement < 2:
            raise ValueError("agreement must be >= 2")
        self.asr_fn = asr_fn
        self.sample_rate = sample_rate
        self.refresh_s = refresh_s
        self.agreement = agreement
        self.on_partial = on_partial
        self._buf: List[np.ndarray] = []
        self._since_pass = 0  # samples fed since the last pass
        self._hyps: List[List[str]] = []  # last `agreement` hypotheses
        self._stable: List[str] = []
        self.passes = 0

    # ------------------------------------------------------------------

    @property
    def stable_text(self) -> str:
        return " ".join(self._stable)

    def feed(self, chunk: np.ndarray) -> Optional[str]:
        """Add one speech chunk. Returns the new stable text when the
        agreed prefix grew, else None."""
        chunk = np.asarray(chunk, np.float32)
        self._buf.append(chunk)
        self._since_pass += len(chunk)
        if self._since_pass < self.refresh_s * self.sample_rate:
            return None
        self._since_pass = 0
        return self._run_pass()

    def _run_pass(self) -> Optional[str]:
        audio = np.concatenate(self._buf)
        try:
            words = self.asr_fn(audio).split()
        except Exception as e:  # a failed pass must not kill capture
            log.warning("streaming ASR pass failed: %s", e)
            return None
        self.passes += 1
        self._hyps = (self._hyps + [words])[-self.agreement:]
        if len(self._hyps) < self.agreement:
            return None
        agreed = self._hyps[0]
        for h in self._hyps[1:]:
            agreed = _common_prefix(agreed, h)
        # Monotone growth: only extend, and only consistently.
        if (len(agreed) > len(self._stable)
                and agreed[: len(self._stable)] == self._stable):
            self._stable = agreed
            text = self.stable_text
            if self.on_partial:
                try:
                    self.on_partial(text)
                except Exception as e:
                    log.warning("on_partial raised: %s", e)
            return text
        return None

    def finalize(self, audio: Optional[np.ndarray] = None) -> str:
        """End-of-speech: authoritative pass over the full utterance
        (pass the pipeline's buffer to be exact about pre-roll), then
        reset for the next utterance."""
        if audio is None:
            audio = (np.concatenate(self._buf) if self._buf
                     else np.zeros(0, np.float32))
        text = self.asr_fn(audio) if len(audio) else ""
        self.reset()
        return text

    def reset(self) -> None:
        self._buf = []
        self._since_pass = 0
        self._hyps = []
        self._stable = []
