"""Ambient-sound classification engine: audio window -> class name.

Port of ``trackiellm_tpu/audio/sound_engine.py``. Parity target: the
reference's passive-listening sound classifier hook (reference:
src/audio/tk_sound_classifier.c wired into
process_audio_for_passive_listening, tk_audio_pipeline.c:481). The engine
owns the mel front end and thresholding; the pipeline just calls it with
~1 s windows. The window goes to the params' device, and the class
probabilities come back in one copy.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from trackiellm_tpu_torch.models import sound_classifier as sc
from trackiellm_tpu_torch.ops.mel import log_mel_spectrogram


class SoundClassifierEngine:
    """Callable: f32 mono window @16 kHz -> class name or None."""

    def __init__(self, params: Dict[str, Any],
                 cfg: sc.SoundClassifierConfig,
                 threshold: float = 0.6,
                 ignore: tuple = ("SILENCE", "SPEECH", "OTHER")):
        self.params = params
        self.cfg = cfg
        self.threshold = threshold
        self.ignore = set(ignore)
        self.device = params["out_w"].device

    def __call__(self, window: np.ndarray) -> Optional[str]:
        mel = log_mel_spectrogram(
            torch.as_tensor(np.asarray(window, np.float32),
                            device=self.device), n_mels=self.cfg.n_mels)
        t = mel.shape[1]
        if t < self.cfg.n_frames:
            mel = F.pad(mel, (0, self.cfg.n_frames - t))
        else:
            mel = mel[:, -self.cfg.n_frames:]
        probs = sc.classify_window(self.params, self.cfg, mel).cpu().numpy()
        idx = int(np.argmax(probs))
        if float(probs[idx]) < self.threshold:
            return None
        name = sc.SoundClass(idx).name
        return None if name in self.ignore else name
