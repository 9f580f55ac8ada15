"""TTS parity: synthesize text through a Piper voice on the port (the
VITS graph, ``models/vits.py``) and score the audio against a reference
waveform rendered by Piper itself.

    python -m trackiellm_tpu_torch.tools.parity_tts --voice V.onnx \\
        --config V.onnx.json --text "ola, tudo bem?"
        [--phonemes P] [--expected piper_render.wav] [--out tts_out.wav]
        [--name-map piper_vits] [--device D] [--no-record]

The twin of the JAX package's ``tools/parity_tts.py``: the same flags
(plus ``--device``), failures and JSON payload. Synthesis runs with
noise_scale 0 and noise_scale_w 0 (deterministic durations and the prior
mean); the score is the log-mel L1 distance after length alignment (the
port's ``ops/mel.py`` at 16 kHz, resampled by ``ops/resample.py``) and the
duration ratio. Without ``--expected`` it writes the synthesis to
``--out``.
"""

from __future__ import annotations

import argparse
import wave

import numpy as np

from trackiellm_tpu_torch.tools.parity_common import (
    die, emit, load_wav, ready, record, require_file)
from trackiellm_tpu_torch.tools.parity_common import device as pick_device


def _write_wav(path, audio, sr):
    pcm = np.clip(audio, -1.0, 1.0)
    data = (pcm * 32767).astype(np.int16).tobytes()
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(data)


def _log_mel(audio, sr):
    """Log-mel at the pipeline's 16 kHz basis (resampling first), on the
    CPU."""
    import torch

    from trackiellm_tpu_torch.ops.mel import log_mel_spectrogram
    from trackiellm_tpu_torch.ops.resample import resample_poly

    x = torch.from_numpy(np.ascontiguousarray(audio, np.float32))
    if sr != 16_000:
        x = resample_poly(x, 16_000, sr)
    return log_mel_spectrogram(x).numpy()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="parity_tts")
    ap.add_argument("--voice", required=True,
                    help="Piper voice weights (.onnx or .npz)")
    ap.add_argument("--config", required=True,
                    help="the voice's .json (phoneme_id_map, sample_rate)")
    ap.add_argument("--text", required=True)
    ap.add_argument("--phonemes", default=None,
                    help="pre-phonemized input (espeak output); when "
                    "given, --text is only recorded, not synthesized")
    ap.add_argument("--expected", default=None,
                    help="reference wav rendered by Piper (omit to just "
                    "write the synthesis to --out)")
    ap.add_argument("--out", default="tts_out.wav")
    ap.add_argument("--name-map", default="piper_vits",
                    help="bundled name-map or JSON path normalizing the "
                    "voice's initializer names onto the converter "
                    "layout (models/name_maps/; 'none' to skip)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--no-record", action="store_true")
    args = ap.parse_args(argv)

    voice_path = require_file(args.voice, "Piper voice checkpoint")
    config_path = require_file(args.config, "voice .json config")

    dev = pick_device(args.device, "parity_tts")
    ready("parity_tts", dev)
    from trackiellm_tpu_torch.models.vits import VITSVoice

    nm = args.name_map if args.name_map.lower() != "none" else None
    try:
        voice = VITSVoice.from_piper(voice_path, config_path,
                                     name_map=nm, device=dev)
    except KeyError as exc:
        die(f"voice checkpoint does not match the published VITS "
            f"layout (missing {exc}); run python -m trackiellm_tpu_torch "
            f"inspect and see docs/REAL_WEIGHTS.md's name table")

    text = args.phonemes if args.phonemes else args.text
    wav = voice.synthesize(text, noise_scale=0.0, noise_scale_w=0.0)
    sr = voice.cfg.sample_rate
    if wav.size == 0:
        die("synthesis produced no audio — check the phoneme_id_map "
            "covers the input (pass --phonemes with espeak output)")
    _write_wav(args.out, wav, sr)

    if not args.expected:
        emit({"tool": "parity_tts", "dumped": args.out,
              "seconds": round(len(wav) / sr, 3), "sample_rate": sr})
        return

    ref = load_wav(require_file(args.expected, "reference wav"),
                   target_sr=sr)
    dur_ratio = len(wav) / max(len(ref), 1)
    m_hyp = _log_mel(wav, sr)
    m_ref = _log_mel(ref, sr)
    t = min(m_hyp.shape[-1], m_ref.shape[-1])
    mel_l1 = float(np.mean(np.abs(m_hyp[..., :t] - m_ref[..., :t])))
    result = {"tool": "parity_tts",
              "mel_l1": round(mel_l1, 5),
              "duration_ratio": round(dur_ratio, 4),
              "seconds": round(len(wav) / sr, 3)}
    emit(result)
    if not args.no_record:
        record("parity_tts", voice_path, "mel L1 / duration ratio",
               f"{result['mel_l1']} / {result['duration_ratio']}",
               f"text={args.text!r}, deterministic (noise 0)")


if __name__ == "__main__":
    main()
