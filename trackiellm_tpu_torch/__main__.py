"""CLI entry: ``python -m trackiellm_tpu_torch <command>``.

  inspect <model>
      print the format and metadata of a model file or checkpoint as JSON
      (``models/loader.py:describe``; no tensor data is read).
  convert <model.gguf> -o DIR [--bits 0|4|8] [--device D]
      convert a llama.cpp GGUF into a native checkpoint: the metadata-driven
      LLM route, requantized to Q4 (default) or Q8 on the device, or kept
      in bf16 with ``--bits 0``; the tokenizer travels in the metadata.
  generate <ckpt> -p PROMPT [--max-tokens N] [--temperature T] [--device D]
      run a generation from a native checkpoint (``LLMConfig`` only), such
      as one that ``convert`` wrote.
  transcribe <wav> [--checkpoint DIR] [--device D]
      transcribe a WAV with Whisper: a native checkpoint whose metadata
      holds ``whisper_config``, else random ``WhisperConfig.test()``
      weights (a smoke test, not a transcription).
  synth -t TEXT --voice V --voice-config J [-o OUT] [--length-scale S]
        [--device D]
      synthesize a Piper voice (VITS; ``.onnx`` or ``.npz`` weights and the
      voice's ``.json``) to a 16-bit WAV.
  demo [seconds] [--device D]
      run the whole assistant (``TrackieApp``: mock camera, microphone and
      IMU, the vision pipeline, the audio state machine with the bundled
      wake word, the cortex, the LLM and the TTS) on tiny random models;
      a typed question is injected halfway. Exits 1 when a worker crashed
      or the cortex halted.

Port of ``trackiellm_tpu/__main__.py``'s ``inspect``, the GGUF branch of
``convert``, ``generate``, ``transcribe``, ``synth`` and ``demo``, with
the JAX package's defaults (4 bits; 64 tokens, temperature 0.7; 5 s).
Every command but ``inspect`` runs on the CUDA card; the CPU is used only
when ``--device cpu`` asks for it. The other ``--family`` routes and
``--mmproj`` wait for ROADMAP Queue 1 item 11; ``bench`` is not ported
yet (ROADMAP Queue 1, ID 5).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from trackiellm_tpu_torch.llm.runner import GenerationConfig, LLMRunner
from trackiellm_tpu_torch.llm.tokenizer import (tokenizer_from_pieces,
                                                tokenizer_from_spec)
from trackiellm_tpu_torch.models.checkpoint import (load_checkpoint,
                                                    save_checkpoint)
from trackiellm_tpu_torch.models.convert import (gguf_convert_auto,
                                                 tokenizer_spec_from_gguf)
from trackiellm_tpu_torch.models.loader import describe, read_gguf_header


# The --family values of the JAX package's convert besides "gguf": the
# transformers-state-dict routes, and the ROADMAP items that port them.
_HF_FAMILIES = (
    "gemma2-hf", "gemma3-hf", "smollm3-hf", "olmo2-hf", "mixtral-hf",
    "qwen2moe-hf", "qwen3-hf", "qwen3moe-hf", "deepseekv2-hf",
    "deepseekv3-hf", "granite-hf", "glm4-hf", "llama4-hf", "nemotron-hf",
    "starcoder2-hf", "cohere-hf", "ernie45-hf", "llava-hf", "falcon-hf",
    "mamba-hf", "mamba2-hf", "paligemma-hf", "trocr-hf", "glm4moe-hf",
    "qwen3next-hf")
_MULTIMODAL_FAMILIES = ("llava-hf", "paligemma-hf", "trocr-hf")


def _device(name, verb: str):
    """The device asked for; by default the CUDA card, and no fallback to
    the CPU when there is none."""
    if name is not None:
        return torch.device(name)
    if not torch.cuda.is_available():
        raise SystemExit(f"no CUDA device: pass --device cpu to {verb} on "
                         "the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def _cmd_inspect(args) -> int:
    print(json.dumps(describe(args.model), indent=1))
    return 0


def _cmd_convert(args) -> int:
    if args.family in _MULTIMODAL_FAMILIES:
        raise NotImplementedError(
            f"--family {args.family}: the multimodal converters are not "
            "ported yet (ROADMAP Queue 1 item 11)")
    if args.family != "gguf":
        raise NotImplementedError(
            f"--family {args.family}: the transformers-state-dict "
            "converters (*_from_hf) are not ported yet (ROADMAP Queue 1 "
            "item 11)")
    if args.mmproj:
        raise NotImplementedError(
            "--mmproj: the llama.cpp vision tower (gguf_to_clip_params, "
            "models/clip.py) is not ported yet (ROADMAP Queue 1 item 11)")
    device = _device(args.device, "convert")
    t0 = time.time()
    hdr = read_gguf_header(args.gguf)
    params, cfg = gguf_convert_auto(args.gguf, bits=args.bits or None,
                                    device=device)
    meta = {"source": args.gguf, "bits": args.bits,
            "vocab_pieces": hdr.metadata.get("tokenizer.ggml.tokens"),
            "tokenizer_spec": tokenizer_spec_from_gguf(hdr)}
    save_checkpoint(args.output, params, config=cfg, metadata=meta)
    print(f"converted + saved to {args.output} "
          f"in {time.time() - t0:.1f}s; config: {cfg}")
    return 0


def _cmd_generate(args) -> int:
    if args.image:
        raise NotImplementedError(
            "--image: multimodal checkpoints (llm/vlm.py, models/clip.py) "
            "are not ported yet (ROADMAP Queue 1 item 11)")
    device = _device(args.device, "generate")
    params, cfg, meta = load_checkpoint(args.checkpoint, device=device)
    if cfg is None:
        print("checkpoint has no LLMConfig sidecar", file=sys.stderr)
        return 1
    tokenizer = None
    if meta.get("tokenizer_spec"):
        tokenizer = tokenizer_from_spec(meta["tokenizer_spec"])
    elif meta.get("vocab_pieces"):  # checkpoints without a tokenizer_spec
        tokenizer = tokenizer_from_pieces(meta["vocab_pieces"])
    runner = LLMRunner(params, cfg, tokenizer, device=device,
                       gen_config=GenerationConfig(
                           max_tokens=args.max_tokens,
                           temperature=args.temperature))
    runner.generate(args.prompt,
                    on_token=lambda s: print(s, end="", flush=True))
    print()
    return 0


def _cmd_transcribe(args) -> int:
    import wave

    import numpy as np

    from trackiellm_tpu_torch.audio.asr import WhisperASR
    from trackiellm_tpu_torch.models import whisper as whisper_model

    device = _device(args.device, "transcribe")
    with wave.open(args.wav, "rb") as f:
        sr = f.getframerate()
        raw = f.readframes(f.getnframes())
        audio = np.frombuffer(raw, np.int16).astype(np.float32) / 32768.0
        if f.getnchannels() > 1:
            audio = audio.reshape(-1, f.getnchannels()).mean(1)

    if args.checkpoint:
        params, cfg, meta = load_checkpoint(args.checkpoint, device=device)
        if meta.get("whisper_config"):
            cfg = whisper_model.WhisperConfig(**meta["whisper_config"])
        if not isinstance(cfg, whisper_model.WhisperConfig):
            print("checkpoint has no whisper_config", file=sys.stderr)
            return 1
    else:
        print("(no checkpoint given: using random test weights — output "
              "is a smoke test, not a transcription)", file=sys.stderr)
        cfg = whisper_model.WhisperConfig.test()
        params = whisper_model.init_whisper(
            torch.Generator(device=device).manual_seed(0), cfg)
    asr = WhisperASR(params, cfg)
    print(asr.transcribe(audio, sample_rate=sr))
    return 0


def _cmd_synth(args) -> int:
    """Synthesize speech (the Piper CLI workflow twin): a Piper voice
    (--voice model.onnx --voice-config voice.json) through the VITS graph,
    written as a 16-bit WAV."""
    import wave

    import numpy as np

    from trackiellm_tpu_torch.models.vits import VITSVoice

    device = _device(args.device, "synth")
    voice = VITSVoice.from_piper(args.voice, args.voice_config,
                                 device=device)
    wav = voice.synthesize(args.text, length_scale=args.length_scale)
    pcm = (np.clip(wav, -1.0, 1.0) * 32767).astype(np.int16)
    with wave.open(args.output, "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(voice.cfg.sample_rate)
        f.writeframes(pcm.tobytes())
    print(f"wrote {args.output}: {len(pcm)} samples @ "
          f"{voice.cfg.sample_rate} Hz")
    return 0


def _cmd_demo(args) -> int:
    from trackiellm_tpu_torch import demo

    app = demo.run(args.seconds, _device(args.device, "run the demo"))
    failed = app.failures()
    if failed:
        print(f"demo failed: {failed}", file=sys.stderr)
        return 1
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="trackiellm_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("inspect", help="inspect a model file")
    p.add_argument("model")
    p.set_defaults(fn=_cmd_inspect)

    p = sub.add_parser("convert", help="GGUF -> native checkpoint")
    p.add_argument("gguf", help="a llama.cpp GGUF file")
    p.add_argument("-o", "--output", required=True)
    p.add_argument("--bits", type=int, default=4, choices=(0, 4, 8))
    p.add_argument("--family", default="gguf",
                   choices=("gguf", *_HF_FAMILIES),
                   help="source layout (default: GGUF metadata-driven); "
                        "the others are not ported yet")
    p.add_argument("--mmproj", default=None,
                   help="llama.cpp vision 'mmproj' GGUF: not ported yet")
    p.add_argument("--device", default=None,
                   help="torch device of the requantization (default: the "
                        "CUDA card; the CPU only when asked for with "
                        "--device cpu)")
    p.set_defaults(fn=_cmd_convert)

    p = sub.add_parser("generate", help="generate from a checkpoint")
    p.add_argument("checkpoint")
    p.add_argument("-p", "--prompt", default="Olá!")
    p.add_argument("--max-tokens", type=int, default=64)
    p.add_argument("--temperature", type=float, default=0.7)
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card; the CPU only "
                        "when asked for with --device cpu)")
    p.add_argument("--image", default=None,
                   help="multimodal checkpoints: not ported yet")
    p.set_defaults(fn=_cmd_generate)

    p = sub.add_parser("transcribe", help="transcribe a WAV file")
    p.add_argument("wav")
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card; the CPU only "
                        "when asked for with --device cpu)")
    p.set_defaults(fn=_cmd_transcribe)

    p = sub.add_parser("synth", help="synthesize speech from a Piper "
                       "voice (VITS) to a WAV file")
    p.add_argument("-t", "--text", required=True)
    p.add_argument("--voice", required=True,
                   help="voice weights (.onnx/.npz)")
    p.add_argument("--voice-config", required=True,
                   help="Piper voice .json (phoneme_id_map)")
    p.add_argument("-o", "--output", default="out.wav")
    p.add_argument("--length-scale", type=float, default=1.0)
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card; the CPU only "
                        "when asked for with --device cpu)")
    p.set_defaults(fn=_cmd_synth)

    p = sub.add_parser("demo", help="assistant demo on mock hardware")
    p.add_argument("seconds", nargs="?", type=float, default=5.0)
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card; the CPU only "
                        "when asked for with --device cpu)")
    p.set_defaults(fn=_cmd_demo)
    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
