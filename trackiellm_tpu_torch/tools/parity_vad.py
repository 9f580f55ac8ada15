"""VAD accuracy parity: run Silero-v5 ONNX weights through the port's
Silero topology (``models/vad.py:SileroVAD``) and compare per-chunk speech
probabilities against the reference session's output.

    python -m trackiellm_tpu_torch.tools.parity_vad --checkpoint W \\
        --audio utterance.wav [--expected expected_probs.json]
        [--threshold 0.8] [--out vad_probs.json] [--name-map silero_v5]
        [--device D] [--no-record]

The twin of the JAX package's ``tools/parity_vad.py``: the same flags
(plus ``--device``), failures and JSON payload. Without ``--expected`` it
dumps this implementation's per-chunk probabilities (512-sample chunks at
16 kHz) to ``--out``. Metrics: max and mean absolute probability
difference and the speech/no-speech agreement at the threshold.
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from trackiellm_tpu_torch.tools.parity_common import (
    die, emit, load_state_dict, load_wav, ready, record, require_file)
from trackiellm_tpu_torch.tools.parity_common import device as pick_device

CHUNK = 512  # Silero v5 frame @ 16 kHz


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="parity_vad")
    ap.add_argument("--checkpoint", required=True,
                    help="silero_vad.onnx (weights-only read) or "
                    ".npz/.pt of its initializers")
    ap.add_argument("--audio", required=True, help="wav or .npy (16 kHz)")
    ap.add_argument("--expected", default=None,
                    help="JSON list of per-chunk reference probabilities "
                    "(omit to dump this implementation's probs)")
    ap.add_argument("--threshold", type=float, default=0.8,
                    help="decision threshold (reference default)")
    ap.add_argument("--out", default="vad_probs.json")
    ap.add_argument("--name-map", default="silero_v5",
                    help="bundled name-map or JSON path normalizing the "
                    "real file's initializer names onto the converter "
                    "layout (models/name_maps/; 'none' to skip)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--no-record", action="store_true")
    args = ap.parse_args(argv)

    ckpt = require_file(args.checkpoint, "Silero VAD checkpoint",
                        "the published silero_vad.onnx")
    audio = load_wav(require_file(args.audio, "audio file"))

    dev = pick_device(args.device, "parity_vad")
    ready("parity_vad", dev)
    from trackiellm_tpu_torch.models.convert import (apply_name_map,
                                                     load_name_map,
                                                     silero_from_onnx)
    from trackiellm_tpu_torch.models.vad import SileroVAD

    state = load_state_dict(ckpt)
    if args.name_map and args.name_map.lower() != "none":
        state = apply_name_map(state, load_name_map(args.name_map))
    try:
        params, cfg = silero_from_onnx(state, device=dev)
    except KeyError as exc:
        die(f"checkpoint does not match the Silero-v5 initializer "
            f"layout (missing {exc}); run python -m trackiellm_tpu_torch "
            f"inspect to list its names — docs/REAL_WEIGHTS.md has the "
            f"expected table")

    vad = SileroVAD(params, cfg)
    n = len(audio) // CHUNK
    if n == 0:
        die(f"audio too short: {len(audio)} samples < one {CHUNK} chunk")
    probs = [float(vad(audio[i * CHUNK:(i + 1) * CHUNK]))
             for i in range(n)]

    if not args.expected:
        with open(args.out, "w") as f:
            json.dump(probs, f)
        emit({"tool": "parity_vad", "dumped": args.out, "chunks": n})
        return

    require_file(args.expected, "expected probabilities JSON")
    ref = json.loads(open(args.expected).read())
    if len(ref) != n:
        die(f"expected {len(ref)} chunk probs, audio has {n} chunks "
            f"(same 512-sample framing required)")
    diff = np.abs(np.asarray(probs) - np.asarray(ref, np.float64))
    agree = float(np.mean(
        (np.asarray(probs) >= args.threshold)
        == (np.asarray(ref) >= args.threshold)))
    result = {"tool": "parity_vad", "chunks": n,
              "max_abs_diff": round(float(diff.max()), 5),
              "mean_abs_diff": round(float(diff.mean()), 5),
              "decision_agreement": round(agree, 5)}
    emit(result)
    if not args.no_record:
        record("parity_vad", ckpt, "max|dp| / agreement",
               f"{result['max_abs_diff']} / {result['decision_agreement']}",
               f"{n} chunks @ threshold {args.threshold}")


if __name__ == "__main__":
    main()
