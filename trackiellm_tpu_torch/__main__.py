"""CLI entry: ``python -m trackiellm_tpu_torch <command>``.

  inspect <model>
      print the format and metadata of a model file or checkpoint as JSON
      (``models/loader.py:describe``; no tensor data is read).
  convert <model.gguf> -o DIR [--bits 0|4|8] [--mmproj MMPROJ.gguf]
          [--device D]
      convert a llama.cpp GGUF into a native checkpoint: the metadata-driven
      LLM route, requantized to Q4 (default) or Q8 on the device, or kept
      in bf16 with ``--bits 0``; the tokenizer travels in the metadata.
      With ``--mmproj``, llama.cpp's LLaVA packaging: the vision tower of
      the mmproj file is saved beside it, in DIR/vision.
  convert <state dict> -o DIR --family llava-hf|paligemma-hf [--bits N]
          [--n-heads H] [--vision-n-heads H] [--device D]
      convert a transformers LLaVA or PaliGemma state dict (.safetensors,
      .pt, .npz): the language model at DIR, the vision tower and
      projector at DIR/vision.
  convert <state dict> -o DIR --family F [--bits N] [--n-heads H]
          [--model-config config.json] [--device D]
      convert a transformers language-model state dict of family F
      (gemma2-hf, gemma3-hf, smollm3-hf, olmo2-hf, mixtral-hf, qwen2moe-hf,
      qwen3-hf, qwen3moe-hf, granite-hf, glm4-hf, llama4-hf, nemotron-hf,
      starcoder2-hf, cohere-hf, ernie45-hf, glm4moe-hf, falcon-hf with
      ``--n-heads``, deepseekv2-hf, deepseekv3-hf, mamba-hf, mamba2-hf,
      qwen3next-hf with ``--model-config``); ``--bits`` requantizes MLA at
      group 64, the others at 256 (Mamba-2 stays f32). A deepseek2, mamba,
      falcon, llama4, glm4moe or qwen3next GGUF takes its own route through
      the plain GGUF form above.
  generate <ckpt> -p PROMPT [--max-tokens N] [--temperature T]
           [--image FRAME.npy] [--device D]
      run a generation from a native checkpoint, such as one that
      ``convert`` wrote: ``LLMConfig`` through ``LLMRunner``, ``MLAConfig``
      through ``LLMRunner(model=models.mla)``, ``MambaConfig``,
      ``Mamba2Config`` and ``Qwen3NextConfig`` through ``MambaRunner``; with
      ``--image`` (an HWC uint8 array,
      .npy or an .npz holding ``image``) a multimodal checkpoint sees the
      frame at the prompt's ``<image>`` marker (prepended when absent).
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
  precompile [--llm CKPT] [--max-seq N] [--cache-dir DIR] [--skip STAGES]
             [--device D]
      make the process ready before its first request: build (or find) the
      CUDA kernel library and the native runtime, printing their seconds,
      then drive each stage's entry points once (llm, server, asr, tts,
      vision, dpt, vlm) at the JAX command's shapes on random weights (or
      ``--llm``'s checkpoint), printing ``[   t s] <stage> warm`` lines and
      a last JSON line with the launches by kernel. Nothing is compiled per
      shape in the port: a stage warms CUDA module loads, cuBLAS and cuDNN
      handles and the allocator's pools, and the built libraries stay under
      ``--cache-dir`` (``tools/cache_artifact.py`` packs them).

  first_contact DIR [--report R] [--bits 4|8] [--probe-tokens N]
                [--no-flags] [--deep] [--strict] [--quantize 0|4|8]
                [--device D]
      validate a directory of real checkpoints (``first_contact.py``):
      sniff, convert, probe (the NLL of a pt-BR snippet through the file's
      own tokenizer), the rope-flag gauntlet, and the matching parity twin
      (``python -m trackiellm_tpu_torch.tools.parity_*``, on the same
      device) where its companion files lie next to the artifact; one
      status line an artifact, exit 1 on any FAIL.

Port of ``trackiellm_tpu/__main__.py``'s ``inspect``, ``convert`` (every
GGUF arch, ``--mmproj`` and all of its ``--family`` routes), ``generate``
(``--image`` included), ``transcribe``, ``synth``, ``demo``,
``precompile`` and ``first_contact``, with the JAX package's defaults (4
bits; 64 tokens, temperature 0.7; 5 s; max_seq 1024; 32 probe tokens).
Every command but ``inspect`` runs on the CUDA card; the CPU is used only
when ``--device cpu`` asks for it. ``bench`` is not ported yet (ROADMAP
Queue 1).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

from trackiellm_tpu_torch.llm.runner import GenerationConfig, LLMRunner
from trackiellm_tpu_torch.llm.tokenizer import (tokenizer_from_pieces,
                                                tokenizer_from_spec)
from trackiellm_tpu_torch.models import convert as convert_mod
from trackiellm_tpu_torch.models.checkpoint import (load_checkpoint,
                                                    save_checkpoint)
from trackiellm_tpu_torch.models.convert import (gguf_convert_auto,
                                                 tokenizer_spec_from_gguf)
from trackiellm_tpu_torch.models.loader import describe, read_gguf_header


# The --family values of the JAX package's convert besides "gguf": the
# transformers-state-dict routes.
_HF_FAMILIES = (
    "gemma2-hf", "gemma3-hf", "smollm3-hf", "olmo2-hf", "mixtral-hf",
    "qwen2moe-hf", "qwen3-hf", "qwen3moe-hf", "deepseekv2-hf",
    "deepseekv3-hf", "granite-hf", "glm4-hf", "llama4-hf", "nemotron-hf",
    "starcoder2-hf", "cohere-hf", "ernie45-hf", "llava-hf", "falcon-hf",
    "mamba-hf", "mamba2-hf", "paligemma-hf", "trocr-hf", "glm4moe-hf",
    "qwen3next-hf")
_MULTIMODAL_FAMILIES = ("llava-hf", "paligemma-hf")
# The language-model state dicts: each family's converter.
_STATE_DICT_CONVERTERS = {
    "gemma2-hf": "gemma2_from_hf", "gemma3-hf": "gemma3_from_hf",
    "smollm3-hf": "smollm3_from_hf", "olmo2-hf": "olmo2_from_hf",
    "mixtral-hf": "mixtral_from_hf", "qwen2moe-hf": "qwen2_moe_from_hf",
    "qwen3-hf": "qwen3_from_hf", "qwen3moe-hf": "qwen3_moe_from_hf",
    "deepseekv2-hf": "deepseek_v2_from_hf",
    "deepseekv3-hf": "deepseek_v3_from_hf", "granite-hf": "granite_from_hf",
    "glm4-hf": "glm4_from_hf", "llama4-hf": "llama4_from_hf",
    "nemotron-hf": "nemotron_from_hf", "starcoder2-hf": "starcoder2_from_hf",
    "cohere-hf": "cohere_from_hf", "ernie45-hf": "ernie45_from_hf",
    "glm4moe-hf": "glm4_moe_from_hf", "qwen3next-hf": "qwen3_next_from_hf",
    "falcon-hf": "falcon_from_hf", "mamba-hf": "mamba_from_hf",
    "mamba2-hf": "mamba2_from_hf"}


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


def _convert_multimodal(args, device: torch.device, t0: float) -> int:
    """LLaVA or PaliGemma from a transformers state dict: the language
    model at --output, the vision tower and projector at --output/vision
    (its own checkpoint, with a CLIPVisionConfig sidecar)."""
    state = convert_mod.load_state_dict(args.gguf)
    if args.family == "llava-hf":
        params, cfg, clip_params, clip_cfg = convert_mod.llava_from_hf(
            state, n_heads=args.n_heads, vision_n_heads=args.vision_n_heads,
            device=device, bits=args.bits or None)
        kind = "llava"
    else:
        params, cfg, clip_params, clip_cfg = convert_mod.paligemma_from_hf(
            state, vision_n_heads=args.vision_n_heads, device=device,
            bits=args.bits or None)
        kind = "paligemma"  # prefix-LM: VLMRunner(prefix_lm=True)
    save_checkpoint(args.output, params, config=cfg,
                    metadata={"source": args.gguf, "bits": args.bits,
                              "multimodal": kind})
    save_checkpoint(os.path.join(args.output, "vision"), clip_params,
                    config=clip_cfg, metadata={"source": args.gguf})
    print(f"converted + saved LLM to {args.output}, vision tower to "
          f"{args.output}/vision in {time.time() - t0:.1f}s")
    return 0


def _convert_trocr(args, device: torch.device, t0: float) -> int:
    """OCR: a transformers VisionEncoderDecoderModel state dict
    (microsoft/trocr-*) -> a models/trocr.py checkpoint with its
    TrOCRConfig sidecar; ``--model-config`` is the HF config.json (head
    counts and special ids)."""
    conf = None
    if args.model_config:
        with open(args.model_config, encoding="utf-8") as f:
            conf = json.load(f)
    params, cfg = convert_mod.trocr_from_hf(
        convert_mod.load_state_dict(args.gguf), conf, device=device)
    save_checkpoint(args.output, params, config=cfg,
                    metadata={"source": args.gguf, "ocr": "trocr"})
    print(f"converted + saved TrOCR to {args.output} in "
          f"{time.time() - t0:.1f}s")
    return 0


def _convert_state_dict(args, device: torch.device, t0: float) -> int:
    """A language model from a transformers state dict, requantized at
    ``--bits`` by the family's ``quantize_params``: MLA at group 64,
    Qwen3-Next by its own policy, the others at 256. Falcon reads
    ``--n-heads``; Qwen3-Next needs ``--model-config`` (its head splits are
    not shape-derivable). Mamba-2 has no quantized route: its weights stay
    f32 whatever ``--bits`` says."""
    fn = getattr(convert_mod, _STATE_DICT_CONVERTERS[args.family])
    kw = {"n_heads": args.n_heads} if args.family == "falcon-hf" else {}
    if args.family == "qwen3next-hf":
        if not args.model_config:
            print("qwen3next-hf needs --model-config config.json "
                  "(linear_num_key_heads / head dims)", file=sys.stderr)
            return 1
        with open(args.model_config, encoding="utf-8") as f:
            kw["config"] = json.load(f)
    params, cfg = fn(convert_mod.load_state_dict(args.gguf), device=device,
                     **kw)
    if args.bits and args.family == "mamba2-hf":
        print("mamba2-hf: Mamba-2 has no quantized route; the weights stay "
              "f32", file=sys.stderr)
    elif args.bits:
        if args.family.startswith("deepseek"):
            from trackiellm_tpu_torch.models.mla import quantize_params
        elif args.family == "mamba-hf":
            from trackiellm_tpu_torch.models.mamba import quantize_params
        elif args.family == "qwen3next-hf":
            from trackiellm_tpu_torch.models.qwen3next import quantize_params
        else:
            from trackiellm_tpu_torch.models.llm import quantize_params
        params = quantize_params(params, bits=args.bits)
    save_checkpoint(args.output, params, config=cfg,
                    metadata={"source": args.gguf, "bits": args.bits,
                              "vocab_pieces": None, "tokenizer_spec": None})
    print(f"converted + saved to {args.output} "
          f"in {time.time() - t0:.1f}s; config: {cfg}")
    return 0


def _cmd_convert(args) -> int:
    device = _device(args.device, "convert")
    t0 = time.time()
    if args.family == "trocr-hf":
        return _convert_trocr(args, device, t0)
    if args.family in _MULTIMODAL_FAMILIES:
        return _convert_multimodal(args, device, t0)
    if args.family in _STATE_DICT_CONVERTERS:
        return _convert_state_dict(args, device, t0)
    hdr = read_gguf_header(args.gguf)
    params, cfg = gguf_convert_auto(args.gguf, bits=args.bits or None,
                                    device=device)
    meta = {"source": args.gguf, "bits": args.bits,
            "vocab_pieces": hdr.metadata.get("tokenizer.ggml.tokens"),
            "tokenizer_spec": tokenizer_spec_from_gguf(hdr)}
    if args.mmproj:
        # llama.cpp's LLaVA packaging: a text GGUF + a vision "mmproj".
        clip_params, clip_cfg = convert_mod.gguf_to_clip_params(
            args.mmproj, device=device)
        meta["multimodal"] = "llava"
        save_checkpoint(args.output, params, config=cfg, metadata=meta)
        save_checkpoint(os.path.join(args.output, "vision"), clip_params,
                        config=clip_cfg, metadata={"source": args.mmproj})
        print(f"converted + saved LLM to {args.output}, mmproj vision "
              f"tower to {args.output}/vision in {time.time() - t0:.1f}s")
        return 0
    save_checkpoint(args.output, params, config=cfg, metadata=meta)
    print(f"converted + saved to {args.output} "
          f"in {time.time() - t0:.1f}s; config: {cfg}")
    return 0


def _generate_image(args, params, cfg, meta, tokenizer, gen_config,
                    device: torch.device) -> int:
    """``generate --image``: the checkpoint's vision tower (DIR/vision)
    sees the frame at the prompt's image marker."""
    import numpy as np

    from trackiellm_tpu_torch.llm.vlm import VLMRunner

    vis_dir = os.path.join(args.checkpoint, "vision")
    clip_params, clip_cfg, _ = load_checkpoint(vis_dir, device=device)
    if type(clip_cfg).__name__ != "CLIPVisionConfig":
        print(f"{vis_dir} has no CLIPVisionConfig sidecar", file=sys.stderr)
        return 1
    if args.image.endswith(".npz"):
        with np.load(args.image) as z:
            image = z["image"]
    else:
        image = np.load(args.image)
    prompt = args.prompt
    if VLMRunner.IMAGE_MARKER not in prompt:
        prompt = VLMRunner.IMAGE_MARKER + "\n" + prompt
    runner = VLMRunner(params, cfg, clip_params, clip_cfg,
                       tokenizer=tokenizer, gen_config=gen_config,
                       device=device,
                       prefix_lm=meta.get("multimodal") == "paligemma")
    runner.generate(prompt, images=[image],
                    on_token=lambda s: print(s, end="", flush=True))
    print()
    return 0


def _cmd_generate(args) -> int:
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
    gen_config = GenerationConfig(max_tokens=args.max_tokens,
                                  temperature=args.temperature)
    kind = type(cfg).__name__
    if kind in ("MambaConfig", "Mamba2Config", "Qwen3NextConfig"):
        # The recurrent-state families (the Qwen3-Next hybrid too) have
        # their own sequential runner.
        from trackiellm_tpu_torch.models.mamba import MambaRunner

        runner = MambaRunner(params, cfg, tokenizer=tokenizer,
                             gen_config=gen_config, device=device)
        runner.generate(args.prompt,
                        on_token=lambda s: print(s, end="", flush=True))
        print()
        return 0
    if args.image:
        return _generate_image(args, params, cfg, meta, tokenizer,
                               gen_config, device)
    model = None
    if kind == "MLAConfig":
        from trackiellm_tpu_torch.models import mla as model
    runner = LLMRunner(params, cfg, tokenizer, device=device,
                       gen_config=gen_config, model=model)
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


def _cmd_precompile(args) -> int:
    import pathlib

    from trackiellm_tpu_torch import precompile
    from trackiellm_tpu_torch.ops import _build

    if args.cache_dir:
        # $TRACKIE_BUILD_DIR for this command (the module read it already).
        os.environ["TRACKIE_BUILD_DIR"] = args.cache_dir
        _build.BUILD_ROOT = pathlib.Path(args.cache_dir)
    device = _device(args.device, "precompile")
    skip = [s for s in (args.skip or "").split(",") if s]
    out = precompile.run(device, args.max_seq, args.llm, skip)
    print(f"precompile done in {out['seconds']:.1f}s; kernel library and "
          f"native runtime under {_build.BUILD_ROOT}", flush=True)
    print(json.dumps({"precompile": out}), flush=True)
    return 0


def _cmd_first_contact(args) -> int:
    from trackiellm_tpu_torch import first_contact as FC

    device = _device(args.device, "run first_contact")
    report = FC.run(args.directory, args.report,
                    FC.Options(bits=args.bits,
                               probe_tokens=args.probe_tokens,
                               no_flags=args.no_flags, deep=args.deep,
                               strict=args.strict,
                               quantize=args.quantize, device=device))
    for a in report["artifacts"]:
        print(f"{a['status']:4s} {a['kind']:14s} {a['file']}")
    s = report["summary"]
    print(f"# {s['PASS']} PASS / {s['WARN']} WARN / {s['FAIL']} FAIL")
    return 1 if s["FAIL"] else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="trackiellm_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("inspect", help="inspect a model file")
    p.add_argument("model")
    p.set_defaults(fn=_cmd_inspect)

    p = sub.add_parser("convert", help="GGUF -> native checkpoint")
    p.add_argument("gguf", help="a llama.cpp GGUF file, or a transformers "
                   "state dict with --family")
    p.add_argument("-o", "--output", required=True)
    p.add_argument("--bits", type=int, default=4, choices=(0, 4, 8))
    p.add_argument("--family", default="gguf",
                   choices=("gguf", *_HF_FAMILIES),
                   help="source layout (default: GGUF metadata-driven; "
                        "the others read a transformers state dict)")
    p.add_argument("--n-heads", type=int, default=32,
                   help="llava-hf and falcon-hf: text attention heads (not "
                        "derivable from shapes)")
    p.add_argument("--vision-n-heads", type=int, default=16,
                   help="llava-hf/paligemma-hf: vision tower heads")
    p.add_argument("--mmproj", default=None,
                   help="llama.cpp vision 'mmproj' GGUF (LLaVA packaging)")
    p.add_argument("--model-config", default=None,
                   help="trocr-hf and qwen3next-hf: the HF config.json "
                        "(head counts and splits, special ids)")
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
                   help="multimodal checkpoints: an HWC uint8 frame "
                        "(.npy, or .npz with 'image')")
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
    p = sub.add_parser(
        "precompile", help="build the kernel library and the native "
        "runtime, which later processes load with no compiler run; then "
        "drive every stage's entry points once and print its warm seconds. "
        "Nothing is compiled per shape: a stage's first call loads CUDA "
        "modules, makes cuBLAS and cuDNN handles and grows the allocator's "
        "pools, and that warmth ends with this command")
    p.add_argument("--llm", default=None,
                   help="LLM checkpoint (default: random Mistral-7B Q4; "
                        "latency does not depend on the weights)")
    p.add_argument("--max-seq", type=int, default=1024)
    p.add_argument("--cache-dir", default=None,
                   help="build directory of the kernel library and the "
                        "native runtime: $TRACKIE_BUILD_DIR for this "
                        "command, so later processes load from it only "
                        "with TRACKIE_BUILD_DIR set to it (default: "
                        "$TRACKIE_BUILD_DIR, else trackiellm_tpu_torch/"
                        "_build)")
    p.add_argument("--skip", default=None,
                   help="comma-separated stages to skip "
                        "(llm,server,asr,tts,vision,dpt,vlm)")
    p.add_argument("--device", default=None,
                   help="the device to warm (default: the CUDA card)")
    p.set_defaults(fn=_cmd_precompile)

    p = sub.add_parser(
        "first_contact",
        help="validate a directory of real checkpoints: sniff -> "
             "convert -> probe -> flag gauntlet -> parity, one JSON "
             "report (docs/REAL_WEIGHTS.md)")
    p.add_argument("directory")
    p.add_argument("--report", default=None)
    p.add_argument("--bits", type=int, default=None, choices=(4, 8))
    p.add_argument("--probe-tokens", type=int, default=32)
    p.add_argument("--no-flags", action="store_true")
    p.add_argument("--deep", action="store_true")
    p.add_argument("--strict", action="store_true")
    p.add_argument("--quantize", type=int, default=4,
                   choices=(0, 4, 8),
                   help="requantization for the parity_llm companion "
                   "runs (4 = the reference's Q4 serving)")
    p.add_argument("--device", default=None,
                   help="the device of the probes and the parity runs "
                   "(default: the CUDA card)")
    p.set_defaults(fn=_cmd_first_contact)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
