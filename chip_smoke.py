#!/usr/bin/env python3
"""Drive the PyTorch port's main paths once on an NVIDIA H100.

    python3 chip_smoke.py

Phases (any failure is an uncaught exception and a non-zero exit):
  1. device: torch, capability (must be (9, 0)), nvidia-smi name and power
     limit;
  2. build: nvcc builds the CUDA kernels from ``trackiellm_tpu_torch/csrc``;
  3. kernels: each of the ten CUDA kernels against its plain PyTorch
     version at the shapes its path gives it (W4A8 at M in {1, 8, 16, 64,
     128, 256, 512}, Q8 and f32-activation Q4 also at 1024, 2048 and 4096:
     the model paths' rows and those of phase 12's admission waves, extend
     chunks and decode steps, ``serve_shapes``; the streaming Q4 at M in
     {1, 8}; all on the five Mistral-7B projections, plus one streaming
     case at other tiles; W4A8's activation quantization at M in {1, 512},
     K in {4096, 14336}, bit for bit; flash attention in five variants at
     H=32, Hk=8, D=128, S in {256, 512, 1024}, bf16 and f32, and causal
     bf16 at the waves' folded heads, 2, 4 and 8 rows of (32, 8) heads at
     S in {256, 512}; the dense families' shapes (``FAMILY_FLASH``: D = 256
     at (16, 8) heads, S in {512, 1024}, causal, window 512, softcap 50;
     D = 96 at (32, 32), S = 512, window 2047; with each kernel's registers
     and spills; ``FAMILY_MATMULS``: W4A8 at groups 128 and 64 and at
     Granite's N = 49,155); the MoE families' shapes (``MOE_MATMULS``:
     W4A8, f32a and Q8 at group 32 on gpt-oss's experts, K = 2880, at M
     in {1, 8, 512}, W4A8 on its lm_head, N = 201,088, at M = 1;
     ``MOE_FLASH``: bf16 D = 64 at (64, 8) heads, S = 512, causal, with
     sinks, with sinks and window 128); the multimodal path's
     (``VLM_MATMULS``: W4A8 on PaliGemma's lm_head, N = 257,216, and its
     w_down, K = 16,384; f32a on LLaVA's w_gu and w_down at M 1024 and
     2048; ``VLM_FLASH``: (32, 32) heads, D = 128, S = 1024); the MLA and
     Mamba paths' (``MLA_MATMULS``: W4A8 at DeepSeek-V2-Lite's projections,
     group 64, and Mamba-2.8B's, group 256; ``MLA_FLASH``: D = 192 at (16,
     16) heads, S = 512, causal, bf16 and f32, V zero from column 128,
     with the kernels' registers and spills, SDPA's time at both or the
     error it raises); Qwen3-Next's (``Q3N_MATMULS``: W4A8 and Q8 at an
     expert's w_down, K = 512, its attention wq, N = 8,192, and lm_head,
     N = 151,936); the fused MLP block at M in {1,
     4, 8}, D 4096, H 14336, bf16 and f32, also timed against the unfused
     path per call and on the device alone; the stream probe over 512 MiB,
     grid64 (64 steps in one block) and a 64-call chain_tiny on (8, 128)),
     with error, tolerance, times, the bound (bytes over the memory rate or
     operations over the peak rate, whichever is larger), the one PyTorch
     call that computes the same function where there is
     one (SDPA for causal bf16 flash, an int64 sum for the stream, x + 1
     for grid64, a chain of 64 x + 1 calls for chain_tiny), and the
     profiler's device-only time of each headline case and of those
     library calls (for chain_tiny also the CUDA-event span of a chain);
  4. width: Mistral-7B width cut to 1 layer (``WIDTH_LAYERS``), random
     weights from a seed,
     card against the port's CPU path: Q4 and Q8 prefill logits, and Q4
     with both opt-in levers through prefill and 8 decode steps;
  5. slice: Mistral-7B (32 layers, max_seq 512, random Q4 weights) behind
     ``LLMRunner`` answers four requests of ``DRIVE_TOKENS`` tokens on the
     default routes, then a
     fresh bucket-512 prefill and 32 decode tokens run under the profiler
     (one ``{"profile": ...}`` line: wall, device busy, idle share,
     launches, the largest costs by kernel);
  6. Q8 slice: the same model cut to 4 layers (``CUT_LAYERS``) with Q8
     weights answers three requests, then runs phase 5's profiled window
     (its own ``{"profile": ...}`` line);
  7. opt-in Q4 routes: phase 5's model cut to 4 layers (views) under
     ``TRACKIE_Q4_F32A=1`` and
     ``TRACKIE_FUSED_MLP=1`` answers two requests, then runs phase 5's
     profiled window under both levers (its own ``{"profile": ...}`` line:
     the fused block's share of a decode token);
  8. entry point: a 2-layer Q8 checkpoint round-trips through
     ``save_checkpoint`` / ``load_checkpoint`` byte for byte, and
     ``python -m trackiellm_tpu_torch generate`` runs on it in-process;
  9. diagnostics: the measurement functions of the three
     ``trackiellm_tpu_torch.tools`` (per-call cost eager and in a CUDA
     graph: the 64-call chain from one host call, one host call a launch
     and x + 1 a launch; the stream handle's read; the streaming Q4 tile
     sweep, graph and op overheads, the 512
     MiB stream envelope, decode of phase 5's model cut to 32/16/8 layers,
     greedy chunks), with their numbers as one JSON line;
 10. tool calls and speculation: phase 5's model at max_seq 2048 behind
     ``LLMRunner`` on the default routes: a forced tool call on the cortex
     prompt with three tools (two with an argument schema) that must parse
     and conform, ``add_tool_response`` and the follow-up reply, and one
     offering only the two schema'd tools; a ``response_schema`` reply at
     temperature 0.7, twice from one seed, whose sampled tokens (not only
     the budget's closure) must advance the grammar; greedy speculation
     ("auto" and True) with the ids of plain decode, and True's passes on
     a repetitive prompt; sampled speculation, twice from one seed, with
     passes (the rejection-sampling verify on the card); a
     600-1000-token prompt (bucket 1024), which must take the f32a kernel
     and never the plain path; the verify pass
     (``extend(all_logits=True)``, 16 rows) against 16 decode steps; its
     numbers as one ``{"slice10": ...}`` line;
 11. GGUF to reply: a llama.cpp GGUF of Mistral-7B at its published widths
     cut to 1 layer (``GGUF_LAYERS``), at the Q4_K_M mix (seeded random Q4_K and Q6_K blocks,
     F32 norms, a 32,000-piece SentencePiece vocabulary), written by this
     script; ``inspect`` names it, ``convert --bits 4`` requantizes it on
     the card into a checkpoint whose config, tokenizer and layer-0 and
     head bytes equal the CPU's requantization (Q8 too), and ``generate``
     answers from it through W4A8 and flash; its times and sizes as one
     ``{"gguf": ...}`` line;
 12. serving: phase 5's model cut to 4 layers (views) behind
     ``LLMServer`` with eight slots:
     ``tools/measure_server.run`` (a warm burst, then 16 requests of 48
     tokens) per-step and in pipelined 8-step chunks, dense and paged
     (128-token pages), and a paged int8 pool, in one round, with their
     admission waves; then on each server a burst of the 16 requests
     queued whole before admission: chunks must give all 16 the per-step
     ids. Eight cortex prompts through the prefix cache, then eight more
     sharing their prefix (hits must count); a ~400-token prompt admitted
     in extend chunks while seven requests decode between them; a forced
     tool call among three cortex prompts (a wave of four at bucket 512:
     f32a), which must conform; a lone request's first token against
     ``LLMRunner``'s; ``prefill_batch`` in waves of 2, 4 and 8 against
     ``prefill`` of each prompt, by rel L2 (W4A8 at bucket 64, f32a and
     flash at bucket 512). Reported: how many requests the runner and the
     other layout answer alike, and a profile of 8-step chunks in a
     process of its own (launches and busy time a decode step, the
     admission's apart); one ``{"serve": ...}`` line before the slice10
     line.
 13. voice: Whisper-tiny at its published widths (random weights from the
     seed written to a whisper.cpp GGML file, f16 matrices) loaded with
     ``whisper_from_ggml`` on the card and on the CPU; ``WhisperASR``
     transcribes a 5-s signal given at 48 kHz (``resample_poly`` runs) at
     the 30-s window (n_audio_ctx 1500) and the app's 10-s window (500),
     48 tokens: the card's ids against the CPU's (reported), the first 8
     decode steps' logits teacher-forced with the CPU's ids (rel L2 1e-4),
     encode and decode times, RTF; the ``transcribe`` CLI on a checkpoint
     and a WAV written here. Whisper large-v3's widths cut to 2+2 layers
     transcribe once. Silero VAD (``SileroConfig()``) from an ONNX file
     under the ``silero_v5`` map's published names runs 312 chunks, state
     carried, against the CPU (max abs 1e-5). The app's TTS
     (``TTSConfig.default()``) says a 60-character reply through
     ``TTSEngine.stream`` and ``synthesize``: the joined chunks against the
     one-shot waveform (bit for bit, else max abs 1e-6). A Piper voice at
     ``VITSConfig()``'s widths from an ONNX file under the ``piper_vits``
     names and its JSON, through ``VITSVoice.from_piper`` and the ``synth``
     CLI: the waveform from injected noise against the CPU's (frames equal,
     rel L2 1e-4). The launches and idle share of the decode window (a
     token) and of the encoder (a call) come from a profile in a process
     of its own (``--voice-profile``); one
     ``{"voice": ...}`` line before the serve line. No hand-written kernel
     is on the voice path: every counter must stay at 0.
 14. vision: a seeded 480x640 floor-and-obstacle frame; YOLOv8n and YOLOv5nu
     at 640, MiDaS v2.1-small at 384, DPT-SwinV2 tiny_256 and the CRNN OCR
     at their published widths (random weights from the seed), each on the
     card and the CPU: the detectors' raw boxes and class probabilities
     (rel L2 1e-5), ``decode_and_nms`` on the card given the CPU's raw
     outputs (bit for bit), the MiDaS and DPT maps (rel L2 1e-5 and 1e-4),
     the OCR logits on the page grid's crops (max abs 1e-5, strings
     equal), the navigation grid given one depth map and the same RANSAC
     indices (equal); ``VisionPipeline.process_frame`` with
     ``AnalysisFlags.ALL``, with MiDaS and with DPT, with OCR and a
     ``NavigationEngine``: every requested ``valid_analyses`` bit must be
     set (a stage that degrades on the card fails the phase), the card's
     objects against the CPU's (reported), the frame wall p50 over 10
     frames; each stage's time and the NMS sweep's alone, with a sync; the
     frame (with a QR code on its wall, the QR detector as ``barcode_fn``)
     as a tensor already on the card and as numpy through two fresh
     pipelines: every bit, object, text and barcode equal. The
     launches and idle share of a frame come from a profile in a process
     of its own (``--vision-profile``); one ``{"vision": ...}`` line before
     the voice line. No hand-written kernel is on the vision path: every
     counter must stay at 0.
 15. app loop: the bundled trained wake word (``load_default_wake_word``)
     on the card and on the CPU scores 16 seeded windows (two-tone
     keyword phrases and imposters) through each side's log-mel (max abs
     1e-5, decisions equal) and streams a seeded signal chunk by chunk
     (firings equal); ``python -m trackiellm_tpu_torch demo 4`` in-process
     (tiny models on the card: exit 0, a VISION job, a spoken line; the
     counters that rose are printed); then
     ``trackiellm_tpu_torch.tools.measure_app_e2e`` in a process of its
     own (``TrackieApp`` with YOLOv8n 640, MiDaS-small 384, Whisper-tiny
     at n_audio_ctx 500, Mistral-7B Q4 at max_seq 1024 and the default
     TTS streamed; one warm run, then 3 measured): end of speech to the
     first reply audio, p50, with first audio and transcript; every run
     must reach reply audio, and its counters must show W4A8, its
     quantization and flash, and none of Q8, the fused block, the
     streaming Q4 or the probes (f32a may rise). One ``{"app": ...}``
     line before the vision line.
 16. dense families: (a) Gemma-2-9B (cut to 2 of its 42 layers,
     ``FAMILY_DEPTH``, dim 3584, 16/8 heads at
     D = 256, GeGLU, sandwich norms, softcaps 50/30, alternating window
     4096, vocab 256,000, max_seq 8192) and Llama-3.1-8B (2 of its 32
     layers, ``llama3_rope_factors(cfg, 8.0)``, max_seq cut to 2048), random Q4
     weights from the seed behind ``LLMRunner``: the cortex prompt (297
     tokens, bucket 512) and 32 greedy tokens at lookahead 4 and 1, equal
     ids and text, every logit finite; Gemma-2-9B then serves a held burst
     of 8 requests of 32 tokens on 8 dense slots and on the int8 paged pool
     (max_seq cut to 2048) and is profiled over 32 decode tokens in a
     process of its own (``--families-profile``); their counters must show
     W4A8, its quantization and flash, and none of Q8, f32a, the fused
     block, the streaming Q4 or the probes. (b) The other dense presets
     (Qwen2, Phi-3, Granite, GLM-4, Gemma-2-2B, Gemma-3 1B/4B/12B/27B,
     OLMo-2, SmolLM3, Qwen3) at their published widths cut to 1 layer
     (Gemma-2-2B 2, ``FAMILY_SWEEP_LAYERS``), Q4
     at the largest group dividing every K/2 (``q4_group``): prefill at
     buckets 64 and 256 on the card against the CPU within WIDTH_TOL, plus
     one prompt longer than each sliding window (Gemma-3-1B 1,024, Phi-3
     2,560, Gemma-2-2B 4,608); Gemma-3-4B with ``linear_rope_factors``,
     Phi-3 as its 128k longrope variant with a prefill on each side of
     the original 4,096. (c) Command-R, Nemotron and StarCoder2 GGUFs
     written here through ``convert --bits 8`` and ``generate`` on the
     card, and the checkpoint's greedy ids on the card equal to the CPU's.
     One ``{"families": ...}`` line before the app line.
 17. MoE families: (a) gpt-oss-20b at its widths cut to 2 of its 24
     layers (``MOE_GPTOSS_LAYERS``; 32 experts top-4, (64, 8) heads at
     D = 64 with sinks, window 128 on even layers, vocab 201,088), random Q4 weights at group 32 from the seed
     with its YaRN factors, max_seq cut to 4096: the cortex prompt and 16
     greedy tokens at lookahead 4 and 1 (equal ids), then a held burst of 8
     requests of 16 tokens on 8 dense slots per step and in 8-step chunks
     (equal ids) and on the int8 pool (its agreement with the dense slots
     reported); tiny gpt-oss and Llama-4 knob sets in f32 (sinks and a
     window of 32, chunks of 32) served on the int8 pool on the card and
     on the CPU, with equal ids; (b) Qwen3-30B-A3B (128 experts top-8,
     group 128) cut to ``MOE_QWEN3_LAYERS`` layers, max_seq 2048: the
     cortex prompt and 16
     greedy tokens, prefill ms, decode ms and the wrappers' launches a
     token; gpt-oss-20b is profiled in a process of its own
     (``--moe-profile``): launches, busy ms and idle share a decode token
     and a decode step; (c) Mixtral-8x7B,
     Qwen1.5-MoE, Qwen3-MoE, gpt-oss-120b and Llama-4 Scout at published
     widths cut to 1 layer (``MOE_SWEEP``), Q4 (gpt-oss-120b also Q8 at
     bucket 64):
     prefill at buckets 64 and 256 on the card against the CPU within
     WIDTH_TOL, the CPU's pass on the card's experts with W4A8's
     activation quantization; every router flip (where the CPU's own
     router chose other experts) printed with its margin, failing the run
     when the margin is above twice the router's card-to-CPU noise on the
     tokens that did not flip; a tiny Llama-4 in f32 across attention
     chunks of 64 (prefill, extend, decode) within MOE_CHUNK_TOL; (d) GGUFs of the MoE arches
     (Mixtral-shaped llama, qwen2moe, qwen3moe, gpt-oss with MXFP4 banks,
     llama4, glm4moe, falcon) through ``inspect``, ``convert --bits 8``
     (qwen3moe also ``--bits 4``) and ``generate`` on the card, and the
     checkpoints' greedy ids on the card equal to the CPU's. Their counters
     must show W4A8, its quantization and flash (Q8 for (d)), and no
     route they do not take. One ``{"moe": ...}`` line (with phase 3's MoE
     rows) before the families line.
 18. multimodal: (a) LLaVA-1.5-7B at its published widths and depth (a
     Llama text model of 32 layers, 32/32 heads, hidden 11,008, vocab
     32,064; CLIP ViT-L/14-336, 576 image rows; the 1024 -> 4096 -> 4096
     projector), random Q4 weights (group 128) and an f32 tower from the
     seed behind ``VLMRunner``: a 480x640 frame on the card through
     ``clip_normalize_chw``, the tower and the projector (its p50 ms), the
     cortex's prompt with "Imagem da câmera: <image>" (bucket 1024: f32a,
     then W4A8 and its quantization in decode, flash), 16 tokens at
     lookahead 4 and 1 (equal ids), the same frame again (its prefix
     reused past the image run) and another (rolled back to its start);
     the plain matmul must not run; (b) card against CPU: the CLIP tower at
     full depth (rel L2 1e-5), LLaVA's text cut to 2 layers on the card's
     projected rows (WIDTH_TOL), PaliGemma-3B's SigLIP at full depth (1e-5)
     and its Gemma cut to 2 layers through the prefix-LM prefill and 8
     decode tokens (WIDTH_TOL, W4A8's activation quantization on the CPU),
     the logits moving without ``bidir_len``; (c) a clip.cpp mmproj GGUF at
     ViT-L widths cut to 2 blocks beside phase 11's GGUF through
     ``convert --mmproj`` (its leaves byte-equal to the CPU's conversion)
     and ``generate --image``; (d) a cortex turn with ``vlm_scene_image``
     in ``TrackieApp`` over (a)'s runner: the frame uploaded as the camera
     worker uploads it reaches ``encode_image`` as that card tensor, the
     reply is spoken, ``failures()`` is empty. One ``{"vlm": ...}`` line
     before the moe line.
 19. outer surfaces: (a) ``python3 -m trackiellm_tpu_torch precompile`` in
     a child process: Mistral-7B Q4 at full width and depth (random
     weights, max_seq 1024) through every stage the JAX command warms (the
     runner's buckets, speculation, the server's waves, Whisper-tiny, the
     TTS, the vision frame, DPT, the CLIP tower and the bucket-1024 spliced
     prefill); each stage's warm seconds, phase 2's library found (no nvcc
     run), and the child's launches by kernel (W4A8, its quantization,
     flash and f32a must rise); (b) ``tools/cache_artifact.py`` packs the
     built libraries and restores them into an empty directory, and a
     child over it launches W4A8 once with no nvcc run: its seconds from
     spawn beside phase 2's cold build; (c) the native runtime must load,
     and a ``NativeContext`` executor over ``VisionPipeline`` (YOLOv8n at
     640, MiDaS-small at 384) given a 480x640 ``NativeVisionFrame``
     through ``execute`` and ``execute_async`` + ``drain`` gives the direct
     ``process_frame``'s packed result bit for bit; (d) a ``tk_*``
     sequence through ``compat``: Mistral-7B widths cut to
     ``SURFACES_LAYERS`` layers, 8 tokens of
     ``tk_llm_runner_generate_next_token`` equal to ``LLMRunner.generate``'s
     ids, a frame, a tool call and a reply through the decision engine, a
     cortex created, fed text and stopped; (e) ``device_trace`` around one
     decode chunk writes a trace holding the W4A8 kernel, and
     ``MetricsCollector.collect()`` reports the card's memory. One
     ``{"surfaces": ...}`` line before the vlm line.
 20. perception models, random weights from the seed at their published
     widths (all-MiniLM-L6-v2, TrOCR-base-printed, AST AudioSet 10-10, the
     reference's CNN sound classifier): (a) card against CPU under
     ``exact_f32``, MiniLM and the CNN at full depth, TrOCR and AST cut to
     2 layers (rel L2 1e-5; TrOCR's greedy ids equal up to EOS or parted
     at a near-tie; the CNN's probabilities within 1e-6); (b) at full
     depth on the card, host-timed: ``Embedder.embed`` over 64 memory
     fragments, ``VisionPipeline(ocr_fn=TrOCREngine)`` on a 480x640 card
     frame with the OCR flag, AST on a 10.24-s window and the CNN engine
     on a 1-s one, each window also profiled in a child process
     (``--perception-profile``); (c) a ``TrackieApp`` turn with
     ``embed_fn``, ``ocr_fn`` and ``sound_fn`` attached and an LLM at
     Mistral-7B widths cut to 2 layers: the memory archived before the
     question retrieved first by cosine, the CNN's forced ALARM spoken at
     CRITICAL, the reply at its priority, the OCR run, ``failures()``
     empty, W4A8, its quantization and flash launched. One
     ``{"perception": ...}`` line before the surfaces line.
 21. MLA and Mamba families (the constants above MLA_LAYERS): (a)
     DeepSeek-V2-Lite at its published widths, Q4 group 64 (32 where 64
     does not divide K/2), cut to dense layer 0 and 3 MoE layers, max_seq
     1024, behind ``LLMRunner(model=mla)``: the cortex prompt (bucket 512:
     flash at D = 192 once a layer, counted) and 8 greedy tokens at
     lookahead 4 (``MLA_TOKENS``, 16 until phase 22 joined), a second
     turn through ``extend``; a burst of 4 queued whole on ``LLMServer(model=mla)`` (4 dense latent slots) with the
     runner's ids; (b) card against CPU: V2-Lite's first 2 layers at
     buckets 64 and 256 and 8 decode steps on the card's experts within
     WIDTH_TOL (router flips within twice the router noise), the V2 and V3
     knob sets at tiny widths in f32 through ``deepseek_v2_from_hf`` and
     ``deepseek_v3_from_hf`` within 1e-4, DeepSeek-V3's published widths
     at 2 layers on the card (a bucket-256 prefill at 128 heads, 4 tokens,
     finite); (c) Mamba-2.8B at its 64 layers, Q4, behind ``MambaRunner``
     (the cortex prompt in chunks of 256, 8 tokens: ``MAMBA_TOKENS``), a burst of 4 on
     ``LLMServer(model=mamba)`` with the runner's ids, its first 2 layers
     card against CPU at buckets 64 and 256; (d) Mamba-Codestral-7B's
     widths in bf16 at 4 layers behind ``MambaRunner`` (no kernel: the
     reference's Mamba-2 projections are plain matmuls) and 2 layers in f32
     card against CPU within 1e-4; (e) a deepseek2 and a mamba GGUF written
     here through ``inspect``, ``convert`` (--bits 4, --bits 8) and
     ``generate``. One ``{"mla_mamba": ...}`` line before the perception
     line.
 22. Qwen3-Next and the transformers converters (the constants above
     Q3N_LAYERS): (a) Qwen3-Next-80B-A3B at its published widths, Q4, cut
     to 4 of 48 layers ("l", "l", "l", "f"), max_seq 1024, behind
     ``MambaRunner``: the cortex prompt (the chunked delta rule at bucket
     256) and 8 greedy tokens, then a second turn, every forward's W4A8
     calls counted (512 experts a MoE layer, each on every row); (b) card
     against CPU: layers 0 and 3 ("l", "f"), a bucket-16 prefill and 2
     decode steps' logits and the recurrent state within WIDTH_TOL on the
     card's experts (router flips within twice the router noise); (c) a
     tiny Qwen3-Next as a transformers state dict (``convert --family
     qwen3next-hf --model-config --bits 4``) and as a qwen3next GGUF
     (``inspect``, ``convert``), each then ``generate``; (d) the 17 other
     ``*-hf`` families at tiny widths converted with ``--bits 4`` on the
     card and on the CPU (byte-equal checkpoints), one bucket-16 prefill
     card against CPU within WIDTH_TOL. One ``{"qwen3next": ...}`` line
     before the ``mla_mamba`` line.
 23. training (the constants above ``train_texts``): (a) Mistral-7B Q4
     group 256 at its 32 layers with LoRA rank 8 on the four default
     targets, 4 steps of ``make_lora_train_step`` under Adam(1e-3) on
     ``PackedDataset`` rows (2 of 256 tokens a step: M = 512 on W4A8)
     prefetched to the card: losses that fall, 257 W4A8 launches a step
     (the checkpointed recompute doubles the layers'), layer 0's adapter
     gradients non-zero (the gradient crossed 31 frozen layers), step ms,
     peak memory, and each frozen projection's backward product
     (``quantized_matmul_grad``) timed beside its bound; (b) its first 2
     layers, one row of 128 tokens: the loss and every adapter gradient
     card against CPU on the f32a route (TRACKIE_Q4_F32A=1, exact
     activations) and a Q8 base within TRAIN_F32A_TOL, the W4A8 route's
     gap reported; (c) ``make_train_step`` on small dense and MoE configs,
     2 AdamW steps card against CPU; (d) ``train_wake_word`` at the
     bundled artifact's config on the tool's synthetic set, 10 steps card
     against CPU, then its 600 steps on the card with the held-out rates.
     One ``{"training": ...}`` line before the ``qwen3next`` line; the
     smoke's wall and then ``{"phase_seconds": ..., "wall_s": ...}`` on
     the two lines before it.
Phases 5-23 zero every launch counter just before they drive their path and
read them just after: the path's kernels must have launched, and the routes
it does not take must not have (no serving path launches the streaming Q4
or a probe; phase 9 must launch all four; phases 13 and 14 launch none).
In
phases 5-7 greedy text must not depend on the lookahead depth, in phase 10
not on speculation, and every logit vector must be finite. Phase 3's
device-only times come from profiles whose launch count matches the calls
(``device_only_ms``). Each phase's first line ends with the seconds since
the build began. The ``training`` line, the ``qwen3next`` line, the
``mla_mamba`` line, the
``perception`` line, the
``surfaces`` line, the
``vlm`` line, the ``moe``
line, the ``families`` line, the ``app`` line, the ``vision`` line, then
the ``voice`` line, come just before the last five lines, which are the
``serve`` line, the ``slice10`` line, the card line, the kernels' JSON
summary and the result line.
"""

import contextlib
import functools
import io
import json
import math
import os
import resource
import struct
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

SEED = 1234
MISTRAL_SHAPES = {  # (K, N) of the quantized projections, group 256
    "wqkv": (4096, 6144), "wo": (4096, 4096), "w_gu": (4096, 28672),
    "w_down": (14336, 4096), "lm_head": (4096, 32000),
}
GROUP = 256
# Decode tokens in phase 5's profiled window (and 6, 7 and the families'
# child): cut from 32 to 8 to bring phases 1-17 under their 600-s budget
# (phase 5 took 61.4 s with 32 and DRIVE_TOKENS 64, 17.6 s with 8 and 32
# in a later call; on an H100 80GB HBM3 at 700 W): the profiler reads
# about 2,000 records a Q4 token.
PROFILE_TOKENS = 8
PROFILE_RETRIES = 3  # profiles of a timed window that missed launches
MATMUL_MS = (1, 8, 64, 256, 512)
# Q8 and f32a take M > 512 on the card: a bucket-1024 prefill's 1024 rows.
# Phase 12's admission waves add their rows (``serve_shapes``).
EXACT_MS = (*MATMUL_MS, 1024)
FLASH_S = (256, 512, 1024)   # prefill buckets; 1024 in phase 10
QUANT_MS, QUANT_KS = (1, 512), (4096, 14336)   # activation quantization
# One H100 SXM (the data sheet, at 700 W): the bound of a kernel is the
# larger of its bytes over the memory rate and its operations over the
# peak rate of their type.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12}
STREAM_MS = (1, 8)   # the streaming Q4's decode shapes
STREAM_ALT = ("wo", 1024, 64)   # one case at non-default (tile_k, tile_n)
# rel: the stream kernel's sum is exact; the plain f32 sum of 512 MiB is not
STREAM_TOL = 1e-5
STREAM_SHAPE = (131072, 4096)   # 512 MiB of uint8, the JAX tool's array
PROBES = ("stream", "grid64", "chain_tiny")
# The kernels no serving path launches: phases 5-8 must leave them idle,
# phase 9 must launch each.
DIAGNOSTIC = ("q4_matmul_stream", *PROBES)
MATMUL_TOL = 1e-5    # rel L2: the same products, f32 sums in another order
# rel L2; in bf16 one rounding of the output may land on the other side
FLASH_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
FUSED_MS = (1, 4, 8)
FUSED_SHAPE = (4096, 14336, 256)  # Mistral-7B D, H, group
FUSED_TOL = FLASH_TOL
WIDTH_TOL = 5e-2     # rel L2: W4A8 activation quantization, ~0.5% per matmul
# rel L2 for the exact-activation routes (Q8, f32a, fused): only the f32
# sum order differs, yet through the bf16 activations of random weights
# that alone moves these logits by ~7e-3 (on the CPU, the Q8 products
# summed per group as the kernel does against dequantize-then-matmul:
# 7.4e-3).
EXACT_WIDTH_TOL = 2e-2
LEVERS = ("TRACKIE_Q4_F32A", "TRACKIE_FUSED_MLP")
SYSTEM = ("You are Trackie, an assistant for a blind user. Answer in one "
          "or two short sentences and warn about hazards first.")
CONTEXT = ("Objects: person 2.1 m ahead, bicycle 3.4 m left, door 5 m "
           "right. Depth: clear path 4 m. Text: EXIT. Sound: traffic.")
SHORT_PROMPT = f"descreva a cena a sua frente com detalhes ({SEED})"
# Phase 10: the cortex's tools (two with an argument schema), a reply
# schema, the token budgets and the long prompt's range (bucket 1024).
TOOLS = (
    ("navigate", "guide the user", {"direction": "left, right or ahead"},
     {"type": "object", "required": ["direction"],
      "properties": {"direction": {"type": "string",
                                   "enum": ["left", "right", "ahead",
                                            "back"]},
                     "meters": {"type": "number"}}}),
    ("describe", "describe an object", {"target": "what to describe"},
     {"type": "object", "required": ["target"],
      "properties": {"target": {"type": "string"},
                     "detail": {"type": "boolean"}}}),
    ("stop", "stop and wait", {}, None),
)
RESPONSE_SCHEMA = {"type": "object", "required": ["hazard", "objects"],
                   "properties": {"hazard": {"type": "string"},
                                  "distance_m": {"type": "number"},
                                  "objects": {"type": "array",
                                              "items": {"type": "string"},
                                              "maxItems": 4}}}
TOOL_TOKENS = 96     # budget of a constrained reply (the closure may end it)
# The response_schema reply's repetition penalty. The grammar tolerates
# whitespace without limit, as the JAX package's does, and the seed's
# random weights favour it: at the default penalty (1.1) the sampler emits
# whitespace until the budget's closure writes the whole object. A strong
# penalty pushes it off the whitespace it has used, so sampled tokens
# advance the grammar on the card.
SCHEMA_PENALTY = 3.0
# A prompt whose n-grams repeat: with spec_min_ngram=1, greedy and sampled
# speculation find proposals on it ("auto" too, unless its first two
# tokens find none and start its cooldown).
REPEAT_PROMPT = "abc abc abc abc abc abc abc abc ab"
# Tokens of each speculation request: cut from 48 to 16 to bring phases
# 1-17 under their 600-s budget (phase 10 took 51.2 s at 48, 39.7-57.0 s
# at 32 in later calls; on an H100 80GB HBM3 at 700 W). Every request and
# check stays. (TOOL_TOKENS stays at 96: at 64 the schema'd reply's sampled
# tokens were all whitespace before the budget's closure, and its check
# failed.)
SPEC_TOKENS = 16
SLICE10_MAX_SEQ = 2048
LONG_PROMPT = (600, 1000)
VERIFY_ROWS = 16     # the verify pass's extend bucket
# Phase 11: a llama.cpp GGUF of Mistral-7B at its published widths, cut to
# GGUF_LAYERS layers (the whole model's conversion is
# trackiellm_tpu_torch/tools/convert_times.py), at llama.cpp's Q4_K_M mix:
# Q4_K for the embeddings, q, k, the attention output, gate and up; Q6_K
# for v, down and the output head; F32 norms.
# 4 until phase 17 joined (see CUT_LAYERS), then 2; 1 to bring phases
# 1-17 under their 600-s budget (phase 11 took 46.4 s at 2 layers, 38.3 s
# at 1 in a later call; on an H100 80GB HBM3 at 700 W). Phase 18's mmproj conversion reuses this file.
GGUF_LAYERS = 1
GGML_F32, GGML_F16, GGML_Q4_K, GGML_Q6_K = 0, 1, 12, 14
# ggml type -> (elements a block, bytes a block, byte offset of the block's
# f16 d, of its f16 dmin or None, and the range d is drawn from). Q4_K's
# dmin is 7.5 d, so that random nibbles and scales give weights about 0
# (the mean scale times the mean nibble).
GGML_BLOCKS = {GGML_Q4_K: (256, 144, 0, 2, (5e-5, 1e-4)),
               GGML_Q6_K: (256, 210, 208, None, (1e-5, 2e-5))}
Q4_K_M = {"token_embd": GGML_Q4_K, "output": GGML_Q6_K,
          "attn_q": GGML_Q4_K, "attn_k": GGML_Q4_K, "attn_v": GGML_Q6_K,
          "attn_output": GGML_Q4_K, "ffn_gate": GGML_Q4_K,
          "ffn_up": GGML_Q4_K, "ffn_down": GGML_Q6_K}
# Tokens of phase 11's generate: 32, then 16 for the 600-s budget of
# phases 1-17, then 8 to pay for phase 21 (phase 11 took 43.5 s at 16, and
# 53.9 s at 8 in a call slower throughout, then 40.6 s; on an H100 80GB
# HBM3 at 700 W).
GGUF_TOKENS = 8


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=30)
    return out.stdout.strip().splitlines()[0]


def l2_flush() -> torch.Tensor:
    """256 MiB to zero before a timed call: it evicts the 50 MiB L2."""
    return torch.empty(64 * 2 ** 20, dtype=torch.int32, device="cuda")


def time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean device time of ``fn`` per call, with L2 flushed before each
    call (the main path finds weights cold: a 7B model is 70x L2)."""
    flush = l2_flush()
    for _ in range(warmup):
        fn()
    total = 0.0
    for _ in range(iters):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / iters


def device_breakdown(fn):
    """Run ``fn`` under ``torch.profiler`` (CUDA activity): the device's
    busy ms (the sum of its kernels and copies), the launches, and ms and
    count by kernel name."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_name = {e.key: (e.self_device_time_total / 1e3, e.count)
               for e in prof.key_averages() if e.self_device_time_total > 0}
    return (sum(ms for ms, _ in by_name.values()),
            sum(n for _, n in by_name.values()), by_name)


def device_only_ms(fn, iters: int = 20, counter=None, per_call: int = 1,
                   notes=None):
    """Device time per call of the kernels ``fn`` launches, by kernel name,
    with L2 flushed before each call and the flush left out: the wrapper's
    host cost is not in it. None where the profiler's count of launches is
    not what the calls made; then ``notes``, a list, gets why.

    One call profiled alone gives the launches of a call by kernel name;
    ``counter`` (a wrapper with a ``launches`` count), where given, must
    rise by ``per_call`` in it. The timed window of ``iters`` calls must
    then show ``iters`` times as many launches of each name. A lone call
    whose profile shows no launch, or a window that misses some, is
    profiled again, up to PROFILE_RETRIES times; a window that never shows
    them all gives no time (a per-call time from a partial count would be
    a fraction of the truth)."""
    flush = l2_flush()
    fn()
    torch.cuda.synchronize()
    for _ in range(1 + PROFILE_RETRIES):
        before = counter.launches if counter is not None else 0
        _, _, one = device_breakdown(fn)
        if counter is not None and counter.launches - before != per_call:
            raise AssertionError(f"one profiled call launched "
                                 f"{counter.launches - before} times, not "
                                 f"{per_call}")
        per = {k: n for k, (_, n) in one.items() if "Fill" not in k}
        if per:
            break
    note = "profiler saw no launch of one call"

    def calls():
        for _ in range(iters):
            flush.zero_()
            fn()
    for _ in range(1 + PROFILE_RETRIES if per else 0):
        _, _, by_name = device_breakdown(calls)
        seen = {k: by_name.get(k, (0.0, 0))[1] for k in per}
        if all(seen[k] == iters * n for k, n in per.items()):
            per_kernel = {k: by_name[k][0] / iters for k in per}
            return {"total": sum(per_kernel.values()), "kernels": per_kernel}
        note = (f"profiler saw {sum(seen.values())} of "
                f"{iters * sum(per.values())} launches")
    if notes is not None:
        notes.append(note)
    return None


def bound_ms(tensors, ops: float, kind: str):
    """(ms, "bytes" or "operations"): the least time the card could take
    for work that reads or writes each of ``tensors`` once and does ``ops``
    operations of type ``kind``, the larger of the two times."""
    by_bytes = sum(t.numel() * t.element_size()
                   for t in tensors) / HBM_BYTES_PER_S * 1e3
    by_ops = ops / PEAK_OPS_PER_S[kind] * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")


def add_row(rows, kname: str, kernel, counter, per_call: int = 1,
            **row) -> None:
    """One phase 3 result of ``kname``; a headline case (``KERNELS``) also
    gets the device-only time of ``kernel`` (``per_call`` launches a call
    by the wrapper ``counter``), or a note of why there is none."""
    if row["case"] in KERNELS[kname][2]:
        notes = []
        row["device"] = device_only_ms(kernel, counter=counter,
                                       per_call=per_call, notes=notes)
        if notes:
            row["device_note"] = notes[0]
            log(f"  {kname} {row['case']}: no device-only time, {notes[0]}")
    rows[kname].append(row)


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


def matmul_case(rows, kname: str, what: str, case: str, kernel, plain,
                inputs, kind: str, counter):
    """One matmul kernel call against its plain version: rel L2 within
    MATMUL_TOL, times and the bound beside (``inputs``: x and the weight's
    tensors; 2 M K N operations of type ``kind``)."""
    got, ref = kernel(), plain()
    torch.cuda.synchronize()
    err = rel_l2(got, ref)
    abs_err = (got - ref).abs().max().item()
    ms, plain_ms = time_ms(kernel), time_ms(plain)
    (m, k), n = inputs[0].shape, got.shape[1]
    bound, by = bound_ms((*inputs, got), 2 * m * k * n, kind)
    log(f"  {what}: rel_l2={err:.3e} (tol {MATMUL_TOL:.0e}) max_abs="
        f"{abs_err:.3e} kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
        f"bound_ms={bound:.4f} ({by})")
    if not err < MATMUL_TOL:
        raise AssertionError(f"{kname} {case}: rel L2 {err}")
    add_row(rows, kname, kernel, counter, case=case, err=abs_err, ms=ms,
            plain=plain_ms, bound=bound, bound_by=by)


def quant_cases(rows, quant, gen, dev) -> None:
    """Phase 3, the activation quantization: the kernel against
    ``quantize_activations_q8`` on bf16 x, equal bit for bit."""
    for m in QUANT_MS:
        for k in QUANT_KS:
            x = torch.randn((m, k), generator=gen, device=dev).to(
                torch.bfloat16)
            got = quant.quantize_activations(x, GROUP)
            ref = quant.quantize_activations_q8(x, GROUP)
            torch.cuda.synchronize()
            diff = sum((a != b).sum().item() for a, b in zip(got, ref))
            abs_err = max((a.float() - b.float()).abs().max().item()
                          for a, b in zip(got, ref))
            ms = time_ms(lambda: quant.quantize_activations(x, GROUP))
            plain_ms = time_ms(lambda: quant.quantize_activations_q8(x, GROUP))
            # per element: abs, max, divide, round, clamp, sum
            bound, by = bound_ms((x, *got), 6 * m * k, "f32")
            log(f"  quant M={m:3d} K={k}: {diff} elements differ (exact) "
                f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
                f"bound_ms={bound:.4f} ({by})")
            if diff:
                raise AssertionError(f"quantize M={m} K={k}: {diff} differ")
            add_row(rows, "quantize_activations",
                    lambda: quant.quantize_activations(x, GROUP),
                    quant.quantize_activations,
                    case=f"M={m} K={k}", err=abs_err, ms=ms, plain=plain_ms,
                    bound=bound, bound_by=by)


def sdpa_ms(q, k, v, ref):
    """The one PyTorch call that computes causal GQA attention,
    ``scaled_dot_product_attention`` on (1, H, S, D), timed as the library
    yardstick (the port never calls it): (ms per call as ``time_ms`` reads
    it, device-only ms as ``device_only_ms`` reads it). Its output must
    agree with the dense oracle as the kernel's does."""
    import torch.nn.functional as F

    def call():
        return F.scaled_dot_product_attention(q[None], k[None], v[None],
                                              is_causal=True, enable_gqa=True)
    err = rel_l2(call()[0], ref)
    if not err < FLASH_TOL[q.dtype]:
        raise AssertionError(f"SDPA against the dense oracle: rel L2 {err}")
    device = device_only_ms(call)
    return time_ms(call), device["total"] if device else None


def attention_pairs(s: int, window: int) -> int:
    """(query, key) pairs a causal mask keeps, with a window if > 0."""
    if window <= 0:
        return s * (s + 1) // 2
    return sum(min(i + 1, window) for i in range(s))


def serve_shapes(runner_mod, max_m: int, max_seq: int, slots: int):
    """The shapes phase 12's LLMServer gives the kernels at ``max_seq``
    with ``slots`` slots. An admission wave is one prefill bucket times 1,
    2, 4 or 8 rows (a wave is padded to a power of two, at most
    ``slots``), an extend chunk one extend bucket, a decode step ``slots``
    rows. Returns the matmul rows at most ``max_m`` (W4A8 takes them)
    joined to MATMUL_MS, the rows above it (Q4 takes f32a there) joined to
    EXACT_MS, and the (S, rows) of the waves that reach flash: a wave
    folds its rows into the heads, (rows * H, S, D) queries against
    (rows * Hk, S, D) keys."""
    buckets = [b for b in runner_mod.PREFILL_BUCKETS if b <= max_seq]
    rows = [1 << i for i in range(slots.bit_length())]
    waves = {b * r for b in buckets for r in rows}
    small = (waves | {slots}
             | {b for b in runner_mod.EXTEND_BUCKETS if b <= max_seq})
    flash = [(s, r) for s in buckets if s >= 256 and s % 256 == 0
             for r in rows if r > 1]
    return (tuple(sorted(set(MATMUL_MS) | {m for m in small if m <= max_m})),
            tuple(sorted(set(EXACT_MS) | {m for m in waves if m > max_m})),
            flash)


def flash_case(rows, attention, gen, dev, heads, s: int, dtype, kw: dict,
               case: str, library: bool, d: int = 128,
               v_width: int = 0) -> None:
    """One flash call on ``heads`` (H, Hk) query and key heads of head dim
    ``d`` at S=s against ``attention_ref``: rel L2 within FLASH_TOL, times
    and the bound beside, and SDPA's times where ``library`` (or, where
    every SDPA backend refuses the call, its error). ``v_width``: V's
    columns from it on are zero (MLA's V zero-padded to D)."""
    h, hk = heads
    q = torch.randn((h, s, d), generator=gen, device=dev).to(dtype)
    kk = torch.randn((hk, s, d), generator=gen, device=dev).to(dtype)
    v = torch.randn((hk, s, d), generator=gen, device=dev).to(dtype)
    if v_width:
        v[..., v_width:] = 0
    kw = dict(kw)
    if kw.pop("sinks", False):
        kw["sinks"] = torch.randn((h,), generator=gen, device=dev)
    got = attention.flash_attention(q, kk, v, **kw)
    ref = attention.attention_ref(q, kk, v, **kw)
    torch.cuda.synchronize()
    err = rel_l2(got, ref)
    abs_err = (got.float() - ref.float()).abs().max().item()
    ms = time_ms(lambda: attention.flash_attention(q, kk, v, **kw))
    plain = time_ms(lambda: attention.attention_ref(q, kk, v, **kw))
    pairs = attention_pairs(s, kw.get("window", 0))
    bound, by = bound_ms(
        (q, kk, v, got, *(t for t in kw.values() if torch.is_tensor(t))),
        4 * h * d * pairs, "bf16" if dtype == torch.bfloat16 else "f32")
    lib = lib_device = lib_error = None
    if library:
        try:
            lib, lib_device = sdpa_ms(q, kk, v, ref)
        except RuntimeError as e:   # no SDPA backend takes the call
            lib_error = str(e).splitlines()[0][:300]
    tol = FLASH_TOL[dtype]
    log(f"  flash {case}: rel_l2={err:.3e} (tol {tol:.0e}) max_abs="
        f"{abs_err:.3e} kernel_ms={ms:.4f} plain_ms={plain:.4f} bound_ms="
        f"{bound:.4f} ({by}) library_ms={lib} library_device_ms={lib_device}"
        + (f" library_error={lib_error}" if lib_error else ""))
    if not err < tol:
        raise AssertionError(f"flash {case}: {err}")
    extra = {"library_error": lib_error} if lib_error else {}
    add_row(rows, "flash_attention",
            lambda: attention.flash_attention(q, kk, v, **kw),
            attention.flash_attention, case=case, err=abs_err, ms=ms,
            plain=plain, bound=bound, bound_by=by, library=lib,
            library_device=lib_device, **extra)


# Phase 3's cases of the dense families (phase 16): flash at Gemma's
# D = 256 ((16, 8) heads; Gemma-2's window of 4096 and Gemma-3's of 512
# both cut what S reaches to 512, and its softcap 50) and Phi-3's D = 96
# ((32, 32) heads, window 2047), bf16 (the models') and f32; W4A8 at the
# groups the families take where 256 does not divide K/2, and at Granite's
# vocabulary of 49,155 columns (N % 4 = 3).
FAMILY_FLASH = (  # (D, (H, Hk), S values, variants)
    (256, (16, 8), (512, 1024), {"causal": {}, "window512": {"window": 512},
                                 "softcap50": {"softcap": 50.0}}),
    (96, (32, 32), (512,), {"causal": {}, "window2047": {"window": 2047}}),
)
FAMILY_MATMULS = (  # (case name, K, N, group, M values)
    ("gemma2_2b w_gu G=128", 2304, 18432, 128, (1, 512)),
    ("gemma3_1b w_gu G=64", 1152, 13824, 64, (1, 512)),
    ("glm4_9b w_down G=64", 13696, 4096, 64, (1, 512)),
    ("granite3_8b lm_head N=49155", 4096, 49155, 256, (1, 16)),
)


def family_kernel_cases(rows, quant, attention, gen, dev) -> None:
    """Phase 3, the dense families' shapes (FAMILY_FLASH, FAMILY_MATMULS),
    each against its plain version with times, bound and, for causal bf16
    flash, SDPA's; and each flash kernel's registers, spill bytes and
    shared memory as ptxas left them (``flash_kernel_attrs``)."""
    for d, heads, sizes, variants in FAMILY_FLASH:
        for dtype in (torch.bfloat16, torch.float32):
            attrs = attention.flash_kernel_attrs(d, dtype)
            log(f"  flash D={d} {str(dtype)[6:]} kernel: {attrs['regs']} "
                f"registers a thread, {attrs['local_bytes']} spill bytes, "
                f"{attrs['smem_bytes']} shared bytes a block")
            if attrs["local_bytes"]:
                raise AssertionError(f"flash D={d} {dtype}: spills")
            for s in sizes:
                for vname, kw in variants.items():
                    flash_case(rows, attention, gen, dev, heads, s, dtype,
                               kw, f"{vname} S={s} D={d} {str(dtype)[6:]}",
                               vname == "causal" and dtype == torch.bfloat16,
                               d=d)
    for name, k, n, group, ms in FAMILY_MATMULS:
        w = quant.quantize_q4(torch.randn((k, n), generator=gen, device=dev)
                              / math.sqrt(k), group)
        args = (w.values, w.scales)
        for m in ms:
            x = torch.randn((m, k), generator=gen, device=dev).to(
                torch.bfloat16)
            matmul_case(rows, "q4_matmul_w4a8",
                        f"w4a8 {name} M={m} K={k} N={n}", f"{name} M={m}",
                        lambda: quant.q4_matmul_w4a8(x, *args),
                        lambda: quant.q4_matmul_w4a8_ref(x, *args),
                        (x, *args), "int8", quant.q4_matmul_w4a8)
        del w, args


# Phase 3's cases of the MoE families (phase 17): W4A8, f32a and Q8 at
# gpt-oss's expert shapes (K = 2880, K/2 = 1440: group 32) at M 1, 8, 512,
# W4A8 on its lm_head (N = 201,088) at M = 1, and bf16 flash at its (64, 8)
# heads, D = 64, S = 512, causal with sinks, with and without window 128
# (SDPA's time on the causal case without sinks: it has no sinks).
MOE_MATMULS = (  # (case name, K, N, group, M values, kernels)
    ("gpt-oss w_gu G=32", 2880, 5760, 32, (1, 8, 512),
     ("q4_matmul_w4a8", "q4_matmul_f32a", "q8_matmul")),
    ("gpt-oss w_down G=32", 2880, 2880, 32, (1, 8, 512),
     ("q4_matmul_w4a8", "q4_matmul_f32a", "q8_matmul")),
    ("gpt-oss lm_head N=201088 G=32", 2880, 201088, 32, (1,),
     ("q4_matmul_w4a8",)),
)
MOE_FLASH = (64, (64, 8), 512, {
    "gpt-oss causal": {}, "gpt-oss sinks": {"sinks": True},
    "gpt-oss sinks window128": {"sinks": True, "window": 128}})


def matmul_table_cases(rows, quant, table, gen, dev) -> None:
    """Phase 3, a table of (case name, K, N, group, M values, kernels)
    (MOE_MATMULS, VLM_MATMULS): each kernel against its plain version on
    one seeded weight, with times and bound."""
    kernels = {  # name: (quantize, kernel, plain, op type)
        "q4_matmul_w4a8": (quant.quantize_q4, quant.q4_matmul_w4a8,
                           quant.q4_matmul_w4a8_ref, "int8"),
        "q4_matmul_f32a": (quant.quantize_q4, quant.q4_matmul_f32a,
                           quant.q4_matmul_f32a_ref, "bf16"),
        "q8_matmul": (quant.quantize_q8, quant.q8_matmul,
                      quant.q8_matmul_ref, "bf16"),
    }
    for name, k, n, group, ms, names in table:
        w32 = torch.randn((k, n), generator=gen, device=dev) / math.sqrt(k)
        for kname in names:
            quantize, kernel, plain, kind = kernels[kname]
            w = quantize(w32, group)
            args = (w.values, w.scales)
            for m in ms:
                x = torch.randn((m, k), generator=gen, device=dev).to(
                    torch.bfloat16)
                matmul_case(rows, kname, f"{kname} {name} M={m} K={k} N={n}",
                            f"{name} M={m}", lambda: kernel(x, *args),
                            lambda: plain(x, *args), (x, *args), kind,
                            kernel)
            del w, args
        del w32


def moe_kernel_cases(rows, quant, attention, gen, dev) -> None:
    """Phase 3, the MoE families' shapes (MOE_MATMULS, MOE_FLASH), each
    against its plain version with times and bound, and the D = 64 flash
    kernels' registers and spills."""
    matmul_table_cases(rows, quant, MOE_MATMULS, gen, dev)
    d, heads, s, variants = MOE_FLASH
    attrs = attention.flash_kernel_attrs(d, torch.bfloat16)
    log(f"  flash D={d} bfloat16 kernel: {attrs['regs']} registers a thread, "
        f"{attrs['local_bytes']} spill bytes, {attrs['smem_bytes']} shared "
        "bytes a block")
    if attrs["local_bytes"]:
        raise AssertionError(f"flash D={d}: spills")
    for vname, kw in variants.items():
        flash_case(rows, attention, gen, dev, heads, s, torch.bfloat16, kw,
                   f"{vname} S={s} D={d} bfloat16", not kw, d=d)


# Phase 3's cases of the multimodal path (phase 18): W4A8 on PaliGemma's
# lm_head (K = 2048, N = 257,216, ragged against the kernel's column tiles)
# and its w_down (K = 16,384) at decode and at a bucket-512 prompt; f32a on
# LLaVA-1.5-7B's w_gu (N = 22,016) and w_down (K = 11,008) at the rows of a
# prompt with its 576 image rows (buckets 1024 and 2048, past W4A8's 512;
# group 128, the largest dividing 11,008 / 2); flash at LLaVA's (32, 32)
# heads, D = 128, S = 1024, bf16.
VLM_MATMULS = (  # (case name, K, N, group, M values, kernels)
    ("paligemma lm_head N=257216", 2048, 257216, 256, (1,),
     ("q4_matmul_w4a8",)),
    ("paligemma w_down K=16384", 16384, 2048, 256, (1, 512),
     ("q4_matmul_w4a8",)),
    ("llava w_gu N=22016 G=128", 4096, 22016, 128, (1024, 2048),
     ("q4_matmul_f32a",)),
    ("llava w_down K=11008 G=128", 11008, 4096, 128, (1024, 2048),
     ("q4_matmul_f32a",)),
)
VLM_FLASH = (128, (32, 32), 1024)   # D, (H, Hk), S: causal bf16


def vlm_kernel_cases(rows, quant, attention, gen, dev) -> None:
    """Phase 3, the multimodal path's shapes (VLM_MATMULS, VLM_FLASH), each
    against its plain version with times and bound (SDPA's for flash)."""
    matmul_table_cases(rows, quant, VLM_MATMULS, gen, dev)
    d, heads, s = VLM_FLASH
    flash_case(rows, attention, gen, dev, heads, s, torch.bfloat16, {},
               f"llava causal S={s} D={d} ({heads[0]}, {heads[1]}) bfloat16",
               True, d=d)


# Phase 3's cases of the MLA and Mamba families (phase 21): W4A8 at
# DeepSeek-V2-Lite's Q4 projections (group 64: wq, wo, an expert's w_gu and
# w_down, lm_head) and Mamba-2.8B's (group 256: w_in, w_x, w_out), at
# decode and (w_gu, w_in) a bucket-512 prompt's rows; flash at MLA's head
# dim 192 (128 + 64 rope dims, V zero-padded to 192), 16 heads of their
# own, S = 512, causal at scale 1/sqrt(192) (the kernel's default at
# D = 192), bf16 (the model's) and f32, with the kernels' registers and
# spills.
MLA_MATMULS = (  # (case name, K, N, group, M values, kernels)
    ("deepseek wq G=64", 2048, 3072, 64, (1,), ("q4_matmul_w4a8",)),
    ("deepseek wo G=64", 2048, 2048, 64, (1,), ("q4_matmul_w4a8",)),
    ("deepseek expert w_gu G=64", 2048, 2816, 64, (1, 512),
     ("q4_matmul_w4a8",)),
    ("deepseek expert w_down G=64", 1408, 2048, 64, (1,),
     ("q4_matmul_w4a8",)),
    ("deepseek lm_head N=102400 G=64", 2048, 102400, 64, (1,),
     ("q4_matmul_w4a8",)),
    ("mamba w_in", 2560, 10240, 256, (1, 512), ("q4_matmul_w4a8",)),
    ("mamba w_x N=192", 5120, 192, 256, (1,), ("q4_matmul_w4a8",)),
    ("mamba w_out", 5120, 2560, 256, (1,), ("q4_matmul_w4a8",)),
)
MLA_FLASH = (192, (16, 16), 512)   # D, (H, Hk), S: causal


def mla_kernel_cases(rows, quant, attention, gen, dev) -> None:
    """Phase 3, the MLA and Mamba paths' shapes (MLA_MATMULS, MLA_FLASH),
    each against its plain version with times and bound (SDPA's for causal
    bf16 flash), and the D = 192 kernels' registers, spill bytes and
    shared memory."""
    matmul_table_cases(rows, quant, MLA_MATMULS, gen, dev)
    d, heads, s = MLA_FLASH
    for dtype in (torch.bfloat16, torch.float32):
        attrs = attention.flash_kernel_attrs(d, dtype)
        log(f"  flash D={d} {str(dtype)[6:]} kernel: {attrs['regs']} "
            f"registers a thread, {attrs['local_bytes']} spill bytes, "
            f"{attrs['smem_bytes']} shared bytes a block")
        flash_case(rows, attention, gen, dev, heads, s, dtype, {},
                   f"causal S={s} D={d} {str(dtype)[6:]}", True, d=d,
                   v_width=128)


# Phase 3's cases of Qwen3-Next (phase 22): W4A8 (its model's route) and Q8
# (a --bits 8 checkpoint's) at its new shapes, group 256: an expert's
# w_down (K = 512, two groups a column), the attention wq (N = 8,192, query
# and gate) and lm_head (N = 151,936), at decode and at a bucket-256
# chunk's rows.
Q3N_MATMULS = (  # (case name, K, N, group, M values, kernels)
    ("qwen3next expert w_down K=512", 512, 2048, 256, (1, 256),
     ("q4_matmul_w4a8", "q8_matmul")),
    ("qwen3next attention wq N=8192", 2048, 8192, 256, (1, 256),
     ("q4_matmul_w4a8", "q8_matmul")),
    ("qwen3next lm_head N=151936", 2048, 151936, 256, (1,),
     ("q4_matmul_w4a8", "q8_matmul")),
)


def phase_kernels(dev, quant, attention, fused, llm, diag, serve):
    """Phase 3: every kernel against its plain version, times beside, at
    the model paths' shapes and at those of phase 12's waves (``serve``,
    from ``serve_shapes``)."""
    gen = torch.Generator(device=dev).manual_seed(SEED)
    w4a8_ms, exact_ms, flash_waves = serve
    matmuls = {  # name: (quantize, kernel, plain, label, M values, op type)
        "q4_matmul_w4a8": (quant.quantize_q4, quant.q4_matmul_w4a8,
                           quant.q4_matmul_w4a8_ref, "w4a8", w4a8_ms,
                           "int8"),
        "q8_matmul": (quant.quantize_q8, quant.q8_matmul,
                      quant.q8_matmul_ref, "q8  ", exact_ms, "bf16"),
        "q4_matmul_f32a": (quant.quantize_q4, quant.q4_matmul_f32a,
                           quant.q4_matmul_f32a_ref, "f32a", exact_ms,
                           "bf16"),
        "q4_matmul_stream": (quant.quantize_q4, quant.q4_matmul_stream,
                             quant.q4_matmul_stream_ref, "strm", STREAM_MS,
                             "bf16"),
    }
    rows = {name: [] for name in KERNELS}
    for name, (k, n) in MISTRAL_SHAPES.items():
        w32 = torch.randn((k, n), generator=gen, device=dev) / math.sqrt(k)
        for kname, (quantize, kernel, plain, label, ms,
                    kind) in matmuls.items():
            w = quantize(w32)
            args = (w.values, w.scales)
            for m in ms:
                x = torch.randn((m, k), generator=gen, device=dev).to(
                    torch.bfloat16)
                matmul_case(rows, kname,
                            f"{label} {name:7s} M={m:3d} K={k} N={n}",
                            f"{name} M={m}", lambda: kernel(x, *args),
                            lambda: plain(x, *args), (x, *args), kind, kernel)
            if kname == "q4_matmul_stream" and name == STREAM_ALT[0]:
                _, tile_k, tile_n = STREAM_ALT
                x = torch.randn((1, k), generator=gen, device=dev).to(
                    torch.bfloat16)
                case = f"{name} M=1 tiles=({tile_k},{tile_n})"
                matmul_case(rows, kname, f"{label} {case}", case,
                            lambda: kernel(x, *args, tile_n=tile_n,
                                           tile_k=tile_k),
                            lambda: plain(x, *args), (x, *args), kind,
                            kernel)
            del w, args
        del w32
    quant_cases(rows, quant, gen, dev)
    h, hk = 32, 8
    variants = {"causal": {}, "window128": {"window": 128},
                "softcap50": {"softcap": 50.0},
                "sinks": {"sinks": True}, "scale0.05": {"scale": 0.05}}
    for s in FLASH_S:
        for dtype in (torch.bfloat16, torch.float32):
            for vname, kw in variants.items():
                flash_case(rows, attention, gen, dev, (h, hk), s, dtype, kw,
                           f"{vname} S={s} {str(dtype)[6:]}",
                           vname == "causal" and dtype == torch.bfloat16)
    for s, n in flash_waves:  # the serving model's attention: causal, bf16
        flash_case(rows, attention, gen, dev, (n * h, n * hk), s,
                   torch.bfloat16, {}, f"causal S={s} {n} rows bfloat16",
                   False)
    family_kernel_cases(rows, quant, attention, gen, dev)
    moe_kernel_cases(rows, quant, attention, gen, dev)
    vlm_kernel_cases(rows, quant, attention, gen, dev)
    mla_kernel_cases(rows, quant, attention, gen, dev)
    matmul_table_cases(rows, quant, Q3N_MATMULS, gen, dev)
    d, hid, grp = FUSED_SHAPE
    w_gu = quant.quantize_q4(torch.randn((d, 2 * hid), generator=gen,
                                         device=dev) / math.sqrt(d), grp)
    w_down = quant.quantize_q4(torch.randn((hid, d), generator=gen,
                                           device=dev) / math.sqrt(hid), grp)
    for dtype in (torch.bfloat16, torch.float32):
        for m in FUSED_MS:
            x = torch.randn((m, d), generator=gen, device=dev).to(dtype)
            norm = (1.0 + 0.1 * torch.randn((d,), generator=gen,
                                            device=dev)).to(dtype)
            args = (x, norm, w_gu.values, w_gu.scales, w_down.values,
                    w_down.scales)
            got = fused.fused_mlp_q4(*args)
            ref = fused.fused_mlp_ref(x, norm, w_gu, w_down, 1e-5)
            torch.cuda.synchronize()
            err = rel_l2(got, ref)
            abs_err = (got.float() - ref.float()).abs().max().item()
            ms = time_ms(lambda: fused.fused_mlp_q4(*args))
            plain = time_ms(
                lambda: fused.fused_mlp_ref(x, norm, w_gu, w_down, 1e-5))
            # The unfused block on the default route: W4A8 w_gu, silu * up,
            # W4A8 w_down, residual, with the levers unset; per call and on
            # the device alone (its ~10 launches follow the host).
            def unfused_block():
                return llm._mlp_block(x, norm, w_gu, w_down, 1e-5)
            unfused = time_ms(unfused_block)
            unfused_device = device_only_ms(unfused_block)
            if unfused_device:
                unfused_device = unfused_device["total"]
            bound, by = bound_ms(
                (*args, got), 2 * m * 3 * d * hid,
                "bf16" if dtype == torch.bfloat16 else "f32")
            tol = FUSED_TOL[dtype]
            log(f"  fused M={m} D={d} H={hid} {str(dtype)[6:]:8s}: "
                f"rel_l2={err:.3e} (tol {tol:.0e}) max_abs={abs_err:.3e} "
                f"kernel_ms={ms:.4f} plain_ms={plain:.4f} "
                f"unfused_ms={unfused:.4f} unfused_device_ms={unfused_device}"
                f" bound_ms={bound:.4f} ({by})")
            if not err < tol:
                raise AssertionError(f"fused M={m} {dtype}: rel L2 {err}")
            add_row(rows, "fused_mlp_q4", lambda: fused.fused_mlp_q4(*args),
                    fused.fused_mlp_q4,
                    case=f"M={m} {str(dtype)[6:]}", err=abs_err, ms=ms,
                    plain=plain, unfused=unfused,
                    unfused_device=unfused_device, bound=bound, bound_by=by)
    del w_gu, w_down
    phase_probes(dev, gen, diag, rows)
    return rows


def phase_probes(dev, gen, diag, rows) -> None:
    """Phase 3, the probes: the stream kernel over 512 MiB (rel tolerance
    STREAM_TOL), grid64 and a 64-call chain_tiny on (8, 128) (exact). The
    library yardsticks, per call and device only: ``w.sum(dtype=
    torch.int64)`` for the stream, ``tile + 1`` for grid64, and a chain of
    64 ``tile + 1`` calls for chain_tiny. The chain's bound counts its 64
    calls' bytes (each reads and writes the tile); its CUDA-event span over
    back-to-back chains is logged beside the profiler's kernel sum, which
    counts the overlap of programmatic dependent launches twice (each
    kernel's time includes its wait on the last)."""
    from trackiellm_tpu_torch.tools import device_ms
    x = torch.randn((1, 1), generator=gen, device=dev)
    w = torch.randint(0, 255, STREAM_SHAPE, generator=gen, device=dev,
                      dtype=torch.uint8)
    tile = torch.randn(diag.TILE, generator=gen, device=dev)

    def tile_chain():
        y = tile
        for _ in range(diag.CHAIN):
            y = y + 1
        return y
    cases = {  # name: (case, kernel, plain, rel tolerance, library call,
               #        inputs, calls, operations and their type)
        "stream": ("512 MiB", lambda: diag.stream(x, w),
                   lambda: diag.stream_ref(x, w), STREAM_TOL,
                   lambda: w.sum(dtype=torch.int64), (x, w), 1, w.numel(),
                   "int8"),
        "grid64": ("(8, 128)", lambda: diag.grid64(tile),
                   lambda: diag.grid64_ref(tile), 0.0, lambda: tile + 1,
                   (tile,), 1, diag.GRID_STEPS * tile.numel(), "f32"),
        "chain_tiny": (f"{diag.CHAIN} calls (8, 128)",
                       lambda: diag.chain_tiny(tile),
                       lambda: diag.chain_tiny_ref(tile), 0.0, tile_chain,
                       (tile,), diag.CHAIN, diag.CHAIN * tile.numel(),
                       "f32"),
    }
    for name, (case, kernel, plain, tol, lib, inputs, calls, ops,
               kind) in cases.items():
        got, ref = kernel(), plain()
        torch.cuda.synchronize()
        abs_err = (got - ref).abs().max().item()
        err = abs_err / ref.abs().max().item()
        ms, plain_ms = time_ms(kernel), time_ms(plain)
        library = time_ms(lib)
        device = device_only_ms(lib)
        library_device = device["total"] if device else None
        # each call reads its inputs and writes its output once
        bound, by = bound_ms((*inputs, got) * calls, ops, kind)
        log(f"  probe {name:10s} {case}: rel_err={err:.3e} (tol "
            f"{tol:.0e}) max_abs={abs_err:.3e} kernel_ms={ms:.4f} "
            f"plain_ms={plain_ms:.4f} library_ms={library} "
            f"library_device_ms={library_device} bound_ms={bound:.6f} ({by})")
        if not err <= tol:
            raise AssertionError(f"{name} {case}: rel error {err}")
        spans = {}
        if name == "chain_tiny":
            spans = {"event_ms": device_ms(kernel, dev, 50),
                     "library_event_ms": device_ms(lib, dev, 50)}
        add_row(rows, name, kernel, getattr(diag, name), per_call=calls,
                case=case,
                err=abs_err, ms=ms, plain=plain_ms, library=library,
                library_device=library_device, bound=bound, bound_by=by,
                **spans)
        if spans:
            log(f"  probe chain_tiny: event span {spans['event_ms']:.4f} ms "
                f"a chain (the 64-call tile + 1 chain "
                f"{spans['library_event_ms']:.4f}), kernel sum "
                f"{rows[name][-1]['device']['total']:.4f} ms (counts the "
                f"launches' overlap twice); kernel_ms <= library_ms: "
                f"{ms <= library}")


# Phase 4's depth: cut from 2 layers to 1 to bring phases 1-17 under their
# 600-s budget (phase 4 took 47.4 s at 2 layers, 26.2 s at 1 in a later
# call; on an H100 80GB HBM3 at 700 W); every width, bucket and lever check stays.
WIDTH_LAYERS = 1


def phase_width(dev, llm, quant, fused):
    """Phase 4: Mistral width, WIDTH_LAYERS layers, card against the CPU
    path: Q4 and Q8 prefill; Q4 with both levers through prefill and 8
    decode steps."""
    cfg = llm.LLMConfig.mistral_7b()._replace(
        n_layers=WIDTH_LAYERS, max_seq=512, sliding_window=512)
    toks = torch.randint(0, 256, (256,),
                         generator=torch.Generator().manual_seed(SEED))
    for bits, tol in ((4, WIDTH_TOL), (8, EXACT_WIDTH_TOL)):
        params = llm.init_params_quantized(
            torch.Generator(device=dev).manual_seed(SEED), cfg, bits=bits,
            device=dev)
        cpu = llm.params_to(params, torch.device("cpu"))
        for bucket, length in ((64, 50), (256, 200)):
            lg, _ = llm.prefill(params, cfg, toks[:bucket].to(dev), length,
                                llm.KVCache.create(cfg, device=dev))
            lc, _ = llm.prefill(cpu, cfg, toks[:bucket], length,
                                llm.KVCache.create(cfg, device="cpu"))
            err = rel_l2(lg.cpu(), lc)
            log(f"  width Q{bits} prefill bucket={bucket}: rel_l2 card vs "
                f"cpu = {err:.3e} (tol {tol:.0e})")
            if not (torch.isfinite(lg).all() and err < tol):
                raise AssertionError(f"width Q{bits} bucket {bucket}: {err}")
    # params / cpu now hold the Q8 model; the levers run on Q4.
    params = llm.init_params_quantized(
        torch.Generator(device=dev).manual_seed(SEED), cfg, bits=4,
        device=dev)
    cpu = llm.params_to(params, torch.device("cpu"))
    steps = torch.randint(0, cfg.vocab_size, (8,),
                          generator=torch.Generator().manual_seed(SEED + 1))
    with levers_on():
        counts = (quant.q4_matmul_f32a.launches, fused.fused_mlp_q4.launches,
                  quant.q4_matmul_w4a8.launches)
        lg, cg = llm.prefill(params, cfg, toks[:64].to(dev), 50,
                             llm.KVCache.create(cfg, device=dev))
        lc, cc = llm.prefill(cpu, cfg, toks[:64], 50,
                             llm.KVCache.create(cfg, device="cpu"))
        errs = [rel_l2(lg.cpu(), lc)]
        for tok in steps.tolist():
            lg, cg = llm.decode_step(params, cfg, tok, cg)
            lc, cc = llm.decode_step(cpu, cfg, tok, cc)
            if not torch.isfinite(lg).all():
                raise AssertionError("width levers: non-finite logits")
            errs.append(rel_l2(lg.cpu(), lc))
        ran = (quant.q4_matmul_f32a.launches - counts[0],
               fused.fused_mlp_q4.launches - counts[1],
               quant.q4_matmul_w4a8.launches - counts[2])
    log(f"  width Q4 both levers, prefill bucket=64 + 8 decode steps: max "
        f"rel_l2 card vs cpu = {max(errs):.3e} (tol {EXACT_WIDTH_TOL:.0e});"
        f" launches f32a={ran[0]} fused={ran[1]} w4a8={ran[2]}")
    if not max(errs) < EXACT_WIDTH_TOL:
        raise AssertionError(f"width levers: rel L2 {errs}")
    if ran[0] == 0 or ran[1] != 8 * cfg.n_layers or ran[2] != 0:
        raise AssertionError(f"width levers took the wrong routes: {ran}")


@contextlib.contextmanager
def levers_on(names=LEVERS):
    """The levers ``names`` (TRACKIE_Q4_F32A=1 and TRACKIE_FUSED_MLP=1 by
    default) set inside the block; the environment is restored after,
    whatever happened."""
    saved = {name: os.environ.get(name) for name in names}
    try:
        for name in names:
            os.environ[name] = "1"
        yield
    finally:
        for name, value in saved.items():
            if value is None:
                os.environ.pop(name, None)
            else:
                os.environ[name] = value


class LogitWatch:
    """Wraps the forward entry points a model module has (``models.llm``'s,
    or ``models.mla``'s and ``models.mamba``'s; given ``paging``, the paged
    batch step too) to record, without a host sync, whether each logit
    tensor they return is finite."""

    NAMES = ("prefill", "extend", "decode_step", "prefill_batch",
             "decode_step_batch")

    def __init__(self, llm, paging=None):
        self.flags = []
        targets = [(llm, n) for n in self.NAMES if hasattr(llm, n)]
        if paging is not None:
            targets.append((paging, "decode_step_batch_paged"))
        self.orig = [(m, n, getattr(m, n)) for m, n in targets]
        for m, n, fn in self.orig:
            setattr(m, n, self._wrap(fn))

    def _wrap(self, fn):
        def watched(*args, **kwargs):
            out = fn(*args, **kwargs)
            self.flags.append(torch.isfinite(out[0]).all())
            return out
        return watched

    def close(self) -> int:
        for m, n, fn in self.orig:
            setattr(m, n, fn)
        if not all(bool(f) for f in self.flags):
            raise AssertionError("a logit vector was not finite")
        return len(self.flags)


def request(runner, prompt: str, tag: str) -> dict:
    """One request through the streaming session API, timed in two parts:
    prompt ingestion (prefill) and decode; returns the numbers it logs."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    runner.prepare_generation(prompt)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    pieces = []
    while (piece := runner.generate_next_token()) is not None:
        pieces.append(piece)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    n_prompt = runner.count_tokens(prompt) + 1
    n_out = len(runner.generated_ids)
    text = "".join(pieces)
    log(f"  request {tag}: prompt_tokens={n_prompt} prefill_ms="
        f"{(t1 - t0) * 1e3:.2f} generated_tokens={n_out} text_bytes="
        f"{len(text.encode())} decode_tok_s={n_out / (t2 - t1):.2f}")
    if n_out == 0:
        raise AssertionError(f"request {tag} generated nothing")
    return {"prompt_tokens": n_prompt, "prefill_ms": (t1 - t0) * 1e3,
            "tokens": n_out, "decode_ms_per_token": (t2 - t1) * 1e3 / n_out,
            "decode_tok_s": n_out / (t2 - t1)}


def _flat(tree, prefix=""):
    """(path, tensor) for every tensor of a param tree."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{prefix}.{k}")
    elif isinstance(tree, tuple):  # QuantizedLinear
        yield from _flat(tree.values, prefix + ".values")
        yield from _flat(tree.scales, prefix + ".scales")
    elif isinstance(tree, list):   # Qwen3-Next's per-layer dicts
        for i, v in enumerate(tree):
            yield from _flat(v, f"{prefix}[{i}]")
    else:
        yield prefix, tree


def param_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for _, t in _flat(tree))


def build_model(dev, llm, cfg, bits: int):
    """Random quantized params (group 256) from the seed, on the card."""
    t0 = time.perf_counter()
    params = llm.init_params_quantized(
        torch.Generator(device=dev).manual_seed(SEED), cfg, bits=bits,
        device=dev)
    torch.cuda.synchronize()
    log(f"  params: {cfg.n_layers} layers Q{bits} in "
        f"{time.perf_counter() - t0:.1f} s, "
        f"{param_bytes(params) / 2 ** 30:.2f} GiB on the card")
    return params


# max_tokens of phases 5-7's requests: cut from 96 to 32 to bring phases
# 1-17 under their 600-s budget (phase 5 took 65.7 s at 96, 61.4 s at 64,
# 17.6 s at 32 with PROFILE_TOKENS 8; three calls on an H100 80GB HBM3 at
# 700 W). Phase 5 keeps Mistral-7B at 32 layers.
DRIVE_TOKENS = 32


def drive(dev, llm, runner_mod, tokenizer_mod, params, cfg, counters,
          steps: str):
    """Answer the requests named in ``steps`` behind ``LLMRunner``: (a) a
    short prompt (bucket 64), (b) the cortex prompt (bucket 512), (c) a
    ``chat()`` follow-up (extend), (d) the cortex prompt rebuilt (prefix
    reuse) at temperature 0.7; then greedy (a) again at lookahead 4 and 1.
    Every counter is zeroed just before and read just after; returns the
    counts."""
    tok = tokenizer_mod.ByteTokenizer(cfg.vocab_size)
    gen = runner_mod.GenerationConfig(max_tokens=DRIVE_TOKENS,
                                      temperature=0.0, speculative=False)
    runner = runner_mod.LLMRunner(params, cfg, tok, gen, device=dev)
    prompt_a = SHORT_PROMPT
    prompt_b = runner.build_prompt(SYSTEM, CONTEXT,
                                   "What is in front of me right now?")
    prompt_d = runner.build_prompt(SYSTEM, CONTEXT,
                                   "Can I walk to the door safely?")
    n_b = runner.count_tokens(prompt_b) + 1
    if not 200 <= n_b <= 400:
        raise AssertionError(f"cortex prompt is {n_b} tokens, not 200-400")
    runner.generate(prompt_a)  # warm-up: allocator, cuBLAS, first launches

    for fn in counters.values():
        fn.launches = 0
    watch = LogitWatch(llm)
    try:
        if "a" in steps:
            request(runner, prompt_a, "a (short, bucket 64)")
        if "b" in steps:
            bucket = runner_mod._bucket_for(n_b, runner_mod.PREFILL_BUCKETS)
            request(runner, prompt_b,
                    f"b (cortex, {n_b} tokens, bucket {bucket})")
        if "c" in steps:
            t0 = time.perf_counter()
            reply = runner.chat("And what about the bicycle?")
            torch.cuda.synchronize()
            n_c = len(runner.generated_ids)
            log(f"  request c (chat follow-up, extend): reply_ms="
                f"{(time.perf_counter() - t0) * 1e3:.2f} generated_tokens="
                f"{n_c} text_bytes={len(reply.encode())}")
            if n_c == 0:
                raise AssertionError("the chat follow-up generated nothing")
        if "d" in steps:
            runner.gen.temperature = 0.7
            request(runner, prompt_d, "d (cortex rebuilt, prefix reuse, "
                    "temperature 0.7)")
            runner.gen.temperature = 0.0
        text_k4 = runner.generate(prompt_a)
        ids_k4 = runner.generated_ids
        serial = runner_mod.LLMRunner(
            params, cfg, tok, runner_mod.GenerationConfig(
                max_tokens=DRIVE_TOKENS, temperature=0.0, speculative=False,
                lookahead=1), device=dev)
        text_k1 = serial.generate(prompt_a)
        ids_k1 = serial.generated_ids
    finally:
        n_logits = watch.close()
    launches = {name: fn.launches for name, fn in counters.items()}
    log(f"  launches: {launches}; finite logit vectors: {n_logits}")
    # Random weights over a 32000-id vocab rarely pick a byte id (< 256),
    # so the text can be short: the token ids are compared as well.
    if text_k4.encode() != text_k1.encode() or ids_k4 != ids_k1:
        raise AssertionError("lookahead 4 and 1 gave different replies")
    if not ids_k4:
        raise AssertionError("request a generated nothing")
    log(f"  lookahead 4 == lookahead 1: {len(ids_k4)} token ids and "
        f"{len(text_k4.encode())} text bytes identical")
    return launches


# The kernels that each main-path wrapper launches, one a call, by the
# names the profiler gives them (substrings of its keys).
PROFILED_KERNELS = {
    "q4_matmul_w4a8": ("q4_w4a8_kernel",),
    "quantize_activations": ("quantize_act_kernel",),
    "flash_attention": ("flash_mma_kernel", "flash_fwd_kernel"),
    "q8_matmul": ("q8_mma_kernel", "q8_fma_kernel"),
    "q4_matmul_f32a": ("q4_f32a_mma_kernel", "q4_f32a_fma_kernel"),
    "fused_mlp_q4": ("fused_mlp_q4_kernel",),
}


def launch_counters() -> dict:
    """Every kernel wrapper by name: each counts its launches in
    ``launches``."""
    from trackiellm_tpu_torch.ops import kernel_wrappers
    return kernel_wrappers()


def missed_launches(by_name, counted):
    """None when a profile (``by_name``: kernel name -> (ms, count)) shows
    as many launches of each main-path wrapper's kernels as its counter
    rose by in the window (``counted``); else what it missed."""
    missed = []
    for wrapper, names in PROFILED_KERNELS.items():
        seen = sum(n for key, (_, n) in by_name.items()
                   if any(name in key for name in names))
        if seen != counted.get(wrapper, 0):
            missed.append(f"{wrapper} {seen} of {counted.get(wrapper, 0)}")
    return "profiler saw " + ", ".join(missed) if missed else None


def profile_path(dev, runner_mod, tokenizer_mod, params, cfg,
                 tokens: int = PROFILE_TOKENS, lookahead: int = 4) -> dict:
    """The breakdown of phases 5 (Q4) and 6 (Q8), on fresh runners: the
    cortex prompt's prefill (bucket 512), then ``tokens`` greedy decode
    tokens (at ``lookahead``).
    Each window runs once on the host clock (wall) and once under the
    profiler (device busy ms, launches, the largest costs by kernel, and
    the copy and cast kernels, whose names hold "copy"); the idle share is
    1 - busy / wall. A profile must show every launch the wrappers counted
    in its window, by kernel name; one that misses some is taken again on
    a fresh runner, up to PROFILE_RETRIES times, and a window that never
    shows them all keeps its wall and a ``partial`` note, and no device
    numbers."""
    tok = tokenizer_mod.ByteTokenizer(cfg.vocab_size)
    gen = runner_mod.GenerationConfig(max_tokens=tokens, temperature=0.0,
                                      speculative=False, lookahead=lookahead)
    counters = launch_counters()

    def windows():
        runner = runner_mod.LLMRunner(params, cfg, tok, gen, device=dev)
        prompt = runner.build_prompt(SYSTEM, CONTEXT,
                                     "What is in front of me right now?")

        def decode():
            while runner.generate_next_token() is not None:
                pass
        return runner, (lambda: runner.prepare_generation(prompt), decode)

    runner, fns = windows()
    wall = []
    for fn in fns:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
    tokens = len(runner.generated_ids)
    out = {}
    for i, name, ms, per in zip((0, 1), ("prefill", "decode"), wall,
                                (1, max(tokens, 1))):
        for _ in range(1 + PROFILE_RETRIES):
            _, fns = windows()
            for fn in fns[:i]:  # the decode window follows its prefill
                fn()
            before = {k: f.launches for k, f in counters.items()}
            busy, n, by_name = device_breakdown(fns[i])
            counted = {k: f.launches - before[k] for k, f in counters.items()}
            note = missed_launches(by_name, counted)
            if note is None:
                break
        if note is not None:
            out[name] = {"wall_ms": ms / per, "partial": note}
            log(f"  profile {name}: partial after {PROFILE_RETRIES} "
                f"retries, {note}")
            continue
        top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]
        copies = {k[:80]: [t / per, c / per] for k, (t, c) in by_name.items()
                  if "copy" in k}
        out[name] = {
            "wall_ms": ms / per, "busy_ms": busy / per,
            "idle_share": 1.0 - busy / ms, "launches": n / per,
            "wrapper_launches": {k: c / per for k, c in counted.items()},
            "top": [[k[:80], t / per, c / per] for k, (t, c) in top],
            "copy_ms": sum(t for t, _ in copies.values()),
            "copies": copies}
        log(f"  profile {name}: wall {out[name]['wall_ms']:.2f} ms busy "
            f"{out[name]['busy_ms']:.2f} ms, {out[name]['launches']:.0f} "
            f"launches (copies and casts {out[name]['copy_ms']:.2f} ms)"
            + (f" per token over {tokens} tokens" if i else ""))
    out["decode"]["tokens"] = tokens
    return out


def expect_routes(launches, ran, idle, phase: str) -> None:
    """The kernels in ``ran`` launched on this path; those in ``idle``
    (routes it does not take) did not."""
    for name in ran:
        if launches[name] == 0:
            raise AssertionError(f"{phase}: {name} never launched")
    for name in idle:
        if launches[name] != 0:
            raise AssertionError(f"{phase}: {name} launched "
                                 f"{launches[name]} times off its route")


@contextlib.contextmanager
def plain_matmul_calls(quant):
    """Inside, each call of the plain Q4/Q8 matmul
    (``quantized_matmul_ref``) is counted in the list yielded."""
    calls = []
    plain = quant.quantized_matmul_ref
    quant.quantized_matmul_ref = lambda *a: calls.append(1) or plain(*a)
    try:
        yield calls
    finally:
        quant.quantized_matmul_ref = plain


def expect_no_plain(calls, phase: str) -> None:
    """The card's path never ran the plain matmul (``plain_matmul_calls``);
    on the CPU it is the route."""
    if calls:
        raise AssertionError(f"{phase}: quantized_matmul_ref ran "
                             f"{len(calls)} times")


def spm_spec(vocab_size: int) -> dict:
    """A SentencePiece tokenizer spec, as the JAX package's converter stores
    one in a checkpoint's metadata: llama's specials, the 256 byte-fallback
    pieces, then word pieces, so every id the model draws prints text."""
    pieces = ["<unk>", "<s>", "</s>"] + [f"<0x{b:02X}>" for b in range(256)]
    words = ["\u2581"] + [chr(c) for c in range(ord("a"), ord("z") + 1)]
    words += ["\u2581" + chr(c) for c in range(ord("a"), ord("z") + 1)]
    words += [f"\u2581w{i}" for i in range(vocab_size - len(pieces)
                                           - len(words))]
    return {"model": "spm", "tokens": pieces + words,
            "scores": [0.0] * len(pieces) + [-float(i)
                                             for i in range(len(words))],
            "token_types": [2, 3, 3] + [6] * 256 + [1] * len(words),
            "pad_id": 0, "add_space_prefix": True}


def _gguf_str(text: str) -> bytes:
    data = text.encode("utf-8")
    return struct.pack("<Q", len(data)) + data


# numpy scalar dtype -> GGUF metadata value type
_GGUF_KV_TYPES = {"uint8": 0, "int8": 1, "uint16": 2, "int16": 3,
                  "uint32": 4, "int32": 5, "float32": 6, "bool": 7,
                  "uint64": 10, "int64": 11, "float64": 12}


def _gguf_kv(value) -> bytes:
    """One metadata value with its type: a numpy scalar as its dtype, a
    bool, a str, an int (uint32, or int32 below 0), a float (f32), or a list
    of str, int (int32) or float (f32)."""
    if isinstance(value, np.generic):
        return (struct.pack("<I", _GGUF_KV_TYPES[value.dtype.name])
                + value.astype(value.dtype.newbyteorder("<")).tobytes())
    if isinstance(value, bool):
        return struct.pack("<I?", 7, value)
    if isinstance(value, str):
        return struct.pack("<I", 8) + _gguf_str(value)
    if isinstance(value, int):
        return struct.pack("<Ii" if value < 0 else "<II",
                           5 if value < 0 else 4, value)
    if isinstance(value, float):
        return struct.pack("<If", 6, value)
    if isinstance(value, (list, tuple)):
        head = struct.pack("<I", 9)
        if all(isinstance(x, str) for x in value):
            return (head + struct.pack("<IQ", 8, len(value))
                    + b"".join(_gguf_str(x) for x in value))
        if all(isinstance(x, int) for x in value):
            return (head + struct.pack("<IQ", 5, len(value))
                    + np.asarray(value, "<i4").tobytes())
        if all(isinstance(x, float) for x in value):
            return (head + struct.pack("<IQ", 6, len(value))
                    + np.asarray(value, "<f4").tobytes())
    raise TypeError(f"no GGUF metadata type for {value!r}")


def write_gguf(path: str, tensors, metadata, align: int = 32) -> int:
    """Write a GGUF v3 file; returns its size in bytes. ``tensors``:
    {name: (array, GGML_F32 or GGML_F16)}, or {name: (raw uint8 blocks,
    ggml type, shape)}, shapes outermost first as numpy has them;
    ``metadata``: {key: value} as ``_gguf_kv`` takes it. Each tensor is
    written whole (a full-width model cannot wait for a writer that
    quantizes block by block in Python); the same tensors and metadata give
    the bytes of ``tests/test_loader.py:write_gguf``."""
    head = [b"GGUF", struct.pack("<IQQ", 3, len(tensors), len(metadata))]
    for key, value in metadata.items():
        head += [_gguf_str(key), _gguf_kv(value)]
    blobs, offset = [], 0
    for name, spec in tensors.items():
        if len(spec) == 3:
            raw, gtype, shape = spec
            data = np.ascontiguousarray(raw, np.uint8)
        else:
            arr, gtype = spec
            shape = arr.shape
            data = np.ascontiguousarray(
                arr, {GGML_F32: "<f4", GGML_F16: "<f2"}[gtype])
        dims = tuple(reversed(shape))  # GGUF stores innermost first
        head += [_gguf_str(name), struct.pack(f"<I{len(dims)}QIQ", len(dims),
                                              *dims, gtype, offset)]
        blobs.append(data)
        offset += -(-data.nbytes // align) * align
    header = b"".join(head)
    with open(path, "wb") as f:
        f.write(header + b"\0" * (-len(header) % align))
        for data in blobs:
            f.write(memoryview(data.reshape(-1).view(np.uint8)))
            f.write(b"\0" * (-data.nbytes % align))
    return os.path.getsize(path)


def kquant_blocks(rng, gtype: int, shape) -> np.ndarray:
    """Seeded random raw blocks (uint8) of a ``gtype`` tensor of ``shape``,
    with each block's f16 d (and dmin) small and finite."""
    per, nbytes, d_at, dmin_at, d_range = GGML_BLOCKS[gtype]
    n = math.prod(shape) // per
    raw = rng.integers(0, 256, (n, nbytes), dtype=np.uint8)
    d = rng.uniform(*d_range, n).astype("<f2")
    raw[:, d_at:d_at + 2] = d.view(np.uint8).reshape(n, 2)
    if dmin_at is not None:
        dmin = (d.astype(np.float32) * 7.5).astype("<f2")
        raw[:, dmin_at:dmin_at + 2] = dmin.view(np.uint8).reshape(n, 2)
    return raw.reshape(-1)


def mistral_gguf(cfg, spec: dict, seed: int):
    """(tensors, metadata) of a llama-arch GGUF of ``cfg``'s shapes at
    llama.cpp's Q4_K_M mix, as ``write_gguf`` takes them: seeded random
    raw blocks for the matrices, F32 norms about 1, and the SentencePiece
    vocabulary of ``spec`` (pieces, scores, token types, add_space_prefix)
    in the tokenizer keys llama.cpp writes."""
    rng = np.random.default_rng(seed)
    qd, kvd = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
    shapes = {"attn_q": (qd, cfg.dim), "attn_k": (kvd, cfg.dim),
              "attn_v": (kvd, cfg.dim), "attn_output": (cfg.dim, qd),
              "ffn_gate": (cfg.hidden_dim, cfg.dim),
              "ffn_up": (cfg.hidden_dim, cfg.dim),
              "ffn_down": (cfg.dim, cfg.hidden_dim)}

    def quantized(kind, shape):
        return kquant_blocks(rng, Q4_K_M[kind], shape), Q4_K_M[kind], shape

    def norm():
        return (1.0 + 0.1 * rng.standard_normal(cfg.dim, np.float32),
                GGML_F32)
    tensors = {"token_embd.weight": quantized(
        "token_embd", (cfg.vocab_size, cfg.dim))}
    for i in range(cfg.n_layers):
        tensors[f"blk.{i}.attn_norm.weight"] = norm()
        tensors[f"blk.{i}.ffn_norm.weight"] = norm()
        for kind, shape in shapes.items():
            tensors[f"blk.{i}.{kind}.weight"] = quantized(kind, shape)
    tensors["output_norm.weight"] = norm()
    tensors["output.weight"] = quantized("output", (cfg.vocab_size, cfg.dim))
    metadata = {
        "general.architecture": "llama",
        "general.name": "mistral-7b random Q4_K_M",
        "general.file_type": 15,  # llama.cpp's LLAMA_FTYPE_MOSTLY_Q4_K_M
        "llama.context_length": cfg.max_seq,
        "llama.embedding_length": cfg.dim,
        "llama.block_count": cfg.n_layers,
        "llama.feed_forward_length": cfg.hidden_dim,
        "llama.rope.dimension_count": cfg.head_dim,
        "llama.attention.head_count": cfg.n_heads,
        "llama.attention.head_count_kv": cfg.n_kv_heads,
        # f64 (GGUF type 12), so the config reads back 1e-5 exactly.
        "llama.attention.layer_norm_rms_epsilon": np.float64(cfg.norm_eps),
        "llama.rope.freq_base": float(cfg.rope_theta),
        "tokenizer.ggml.model": "llama",
        "tokenizer.ggml.tokens": spec["tokens"],
        "tokenizer.ggml.scores": spec["scores"],
        "tokenizer.ggml.token_type": spec["token_types"],
        "tokenizer.ggml.bos_token_id": 1,
        "tokenizer.ggml.eos_token_id": 2,
        "tokenizer.ggml.unknown_token_id": 0,
        "tokenizer.ggml.padding_token_id": spec["pad_id"],
        "tokenizer.ggml.add_space_prefix": spec["add_space_prefix"],
    }
    return tensors, metadata


def _peak_rss() -> int:
    """This process's peak resident bytes so far (``ru_maxrss``, in KiB on
    Linux). Linux carries it across exec from the forking parent, so a
    process measured alone is started by a small one
    (``tools/convert_times.py``)."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


@contextlib.contextmanager
def conversion_timer(convert, cli):
    """Host seconds of a conversion inside the block, by part: reading and
    dequantizing GGML tensors (by tensor name), requantizing on the device
    (by call, synchronized), and saving the checkpoint; and where the
    process's peak resident bytes grew, by 256 MiB or more, as [what had
    just run, bytes]. Yields the dict they go into; the patched functions
    are restored after."""
    split = {"dequant": {}, "requant": [], "save": 0.0,
             "peak_rss": [["start", _peak_rss()]]}
    saved = {name: getattr(convert, name) for name in
             ("load_gguf_tensor", "quantize_q4", "quantize_q8")}
    save = cli.save_checkpoint

    def peak(after: str) -> None:
        rss = _peak_rss()
        if rss >= split["peak_rss"][-1][1] + 2 ** 28:
            split["peak_rss"].append([after, rss])

    def dequant(gguf, name):
        t0 = time.perf_counter()
        try:
            return saved["load_gguf_tensor"](gguf, name)
        finally:
            split["dequant"][name] = (split["dequant"].get(name, 0.0)
                                      + time.perf_counter() - t0)
            peak(name)

    def requant(fn):
        def timed(w, group):
            t0 = time.perf_counter()
            q = fn(w, group)
            if q.values.is_cuda:
                torch.cuda.synchronize()
            split["requant"].append(time.perf_counter() - t0)
            peak(f"requantization {len(split['requant'])}")
            return q
        return timed

    def timed_save(*args, **kwargs):
        t0 = time.perf_counter()
        save(*args, **kwargs)
        split["save"] += time.perf_counter() - t0
        peak("save")
    convert.load_gguf_tensor = dequant
    convert.quantize_q4 = requant(saved["quantize_q4"])
    convert.quantize_q8 = requant(saved["quantize_q8"])
    cli.save_checkpoint = timed_save
    try:
        yield split
    finally:
        for name, fn in saved.items():
            setattr(convert, name, fn)
        cli.save_checkpoint = save


def conversion_split(split: dict, total_s: float, layers: int) -> dict:
    """``conversion_timer``'s seconds as totals and per layer: the layers'
    dequantization and requantization (four matrices a layer, in order
    before the head's), and the rest of the total."""
    layer_dequant = sum(t for name, t in split["dequant"].items()
                        if name.startswith("blk."))
    layer_requant = sum(split["requant"][:4 * layers])
    dequant, requant = (sum(split["dequant"].values()),
                        sum(split["requant"]))
    return {"total_s": total_s, "dequant_s": dequant, "requant_s": requant,
            "save_s": split["save"],
            "peak_rss_steps": split["peak_rss"],
            "other_s": total_s - dequant - requant - split["save"],
            "layer_dequant_s": layer_dequant / layers,
            "layer_requant_s": layer_requant / layers}


def run_cli(cli, argv):
    """``python -m trackiellm_tpu_torch`` in-process: (exit code, printed
    text, seconds)."""
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = cli.main(argv)
    torch.cuda.synchronize()
    return rc, out.getvalue(), time.perf_counter() - t0


def _same_bytes(a: torch.Tensor, b: torch.Tensor) -> bool:
    a, b = a.detach().cpu().contiguous(), b.detach().cpu().contiguous()
    return (a.dtype == b.dtype and a.shape == b.shape
            and torch.equal(a.view(torch.uint8), b.view(torch.uint8)))


def check_conversion(dev, convert, quant, path: str, params) -> int:
    """Layer 0's four matrices and lm_head of a Q4 conversion on the card
    against the CPU's requantization of the same dequantized tensors, byte
    for byte; the same for Q8 (``quantize_q8`` on the card and the CPU);
    and the bf16 embeddings and norms against the CPU's cast. Returns the
    tensors compared."""
    ref, _ = convert.gguf_to_llm_params(path, bits=None, dtype=torch.float32,
                                        max_layers=1,
                                        device=torch.device("cpu"))
    mats = {name: (params["layers"][name].values[0],
                   params["layers"][name].scales[0],
                   ref["layers"][name][0])
            for name in ("wqkv", "wo", "w_gu", "w_down")}
    mats["lm_head"] = (*params["lm_head"], ref["lm_head"])
    n = 0
    for name, (values, scales, w) in mats.items():
        cpu = quant.quantize_q4(w, GROUP)
        card8, cpu8 = quant.quantize_q8(w.to(dev), GROUP), quant.quantize_q8(
            w, GROUP)
        for kind, a, b in (("Q4 values", values, cpu.values),
                           ("Q4 scales", scales, cpu.scales),
                           ("Q8 values", card8.values, cpu8.values),
                           ("Q8 scales", card8.scales, cpu8.scales)):
            if not _same_bytes(a, b):
                raise AssertionError(f"phase 11: {name} {kind} from the card "
                                     "differ from the CPU's")
            n += 1
    for name, a, b in (
            ("tok_emb", params["tok_emb"], ref["tok_emb"]),
            ("attn_norm", params["layers"]["attn_norm"][0],
             ref["layers"]["attn_norm"][0]),
            ("out_norm", params["out_norm"], ref["out_norm"])):
        if not _same_bytes(a, b.to(torch.bfloat16)):
            raise AssertionError(f"phase 11: {name} in bf16 differs from the "
                                 "CPU's cast")
        n += 1
    return n


def phase_gguf(dev, cfg, llm, convert, checkpoint, quant, tokenizer_mod,
               cli, counters, workdir=None) -> dict:
    """Phase 11: a llama.cpp GGUF to a reply on the card, through the
    CLI's commands in-process: a Q4_K_M file of ``cfg`` (Mistral-7B cut to
    GGUF_LAYERS layers); (a) ``inspect`` names its arch and tensor count, and
    its header the mix's GGML types; (b) ``convert --bits 4`` on the card:
    the config is ``cfg``, the tokenizer spec the
    file's vocabulary, and ``check_conversion`` holds the bytes to the
    CPU's; (c) ``generate`` on the checkpoint: text, W4A8 with its
    quantization and flash launched (a prompt of bucket 256 or 512), the
    plain matmul never run, every logit finite. Returns the times and
    sizes; every counter is zeroed just before (c) and read just after.
    With ``workdir``, the GGUF is left there as ``mistral.gguf`` (phase 18
    converts it again beside an mmproj)."""
    from trackiellm_tpu_torch.models import loader
    start = time.perf_counter()
    spec = spm_spec(cfg.vocab_size)
    out = {"layers": cfg.n_layers}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_gguf_",
                                     dir=workdir) as tmp:
        path, ckpt = os.path.join(workdir or tmp, "mistral.gguf"), \
            os.path.join(tmp, "ckpt")
        t0 = time.perf_counter()
        tensors, metadata = mistral_gguf(cfg, spec, SEED)
        out["file_bytes"] = write_gguf(path, tensors, metadata)
        out["write_s"] = time.perf_counter() - t0
        types = {name: spec_[1] for name, spec_ in tensors.items()}
        del tensors
        log(f"  GGUF: {out['file_bytes'] / 1e9:.3f} GB, {len(types)} "
            f"tensors, written in {out['write_s']:.1f} s")

        rc, text, out["inspect_s"] = run_cli(cli, ["inspect", path])
        info = json.loads(text)
        header = loader.read_gguf_header(path)
        if (rc != 0 or info.get("architecture") != "llama"
                or info.get("n_tensors") != len(types)
                or {n: t.ggml_type for n, t in header.tensors.items()}
                != types):
            raise AssertionError(f"phase 11: inspect gave {info} (exit {rc})")
        log(f"  inspect: {info} in {out['inspect_s']:.2f} s; header types "
            "are the Q4_K_M mix")

        with conversion_timer(convert, cli) as split:
            rc, text, total = run_cli(
                cli, ["convert", path, "-o", ckpt, "--bits", "4"])
        if rc != 0:
            raise AssertionError(f"phase 11: convert exited {rc}: {text}")
        out["convert"] = conversion_split(split, total, cfg.n_layers)
        out["checkpoint_bytes"] = sum(
            os.path.getsize(os.path.join(ckpt, f)) for f in os.listdir(ckpt))
        t0 = time.perf_counter()
        params, lcfg, meta = checkpoint.load_checkpoint(ckpt, device=dev)
        torch.cuda.synchronize()
        out["load_s"] = time.perf_counter() - t0
        if lcfg != cfg:
            raise AssertionError(f"phase 11: converted config {lcfg}")
        if meta.get("tokenizer_spec") != spec or meta.get("bits") != 4:
            raise AssertionError("phase 11: the checkpoint's tokenizer spec "
                                 "is not the file's vocabulary")
        t0 = time.perf_counter()
        out["bytes_checked"] = check_conversion(dev, convert, quant, path,
                                                params)
        out["check_s"] = time.perf_counter() - t0
        del params
        log(f"  convert --bits 4: {json.dumps(out['convert'])}; checkpoint "
            f"{out['checkpoint_bytes'] / 1e9:.3f} GB, load "
            f"{out['load_s']:.2f} s; config, tokenizer spec and "
            f"{out['bytes_checked']} tensors equal to the CPU's (checked in "
            f"{out['check_s']:.1f} s)")

        prompt = f"{SYSTEM} {CONTEXT}"
        n_prompt = len(tokenizer_mod.tokenizer_from_spec(spec).encode(
            prompt)) + 1
        if not 128 < n_prompt <= 512:
            raise AssertionError(f"phase 11: the prompt is {n_prompt} tokens")
        for fn in counters.values():
            fn.launches = 0
        watch = LogitWatch(llm)
        try:
            with plain_matmul_calls(quant) as plain_calls:
                rc, text, out["generate_s"] = run_cli(
                    cli, ["generate", ckpt, "-p", prompt, "--max-tokens",
                          str(GGUF_TOKENS)])
        finally:
            n_logits = watch.close()
    out["launches"] = {name: fn.launches for name, fn in counters.items()}
    out["phase_s"] = time.perf_counter() - start
    log(f"  generate ({n_prompt} prompt tokens): exit {rc} in "
        f"{out['generate_s']:.2f} s, {n_logits} finite logit vectors, "
        f"printed {text[:60]!r}; launches: {out['launches']}")
    if rc != 0 or not text.strip():
        raise AssertionError(f"phase 11: generate exited {rc} and printed "
                             f"{text!r}")
    expect_no_plain(plain_calls, "phase 11")
    expect_routes(out["launches"], ("q4_matmul_w4a8", "quantize_activations",
                                    "flash_attention"),
                  ("q8_matmul", "q4_matmul_f32a", "fused_mlp_q4",
                   *DIAGNOSTIC), "phase 11")
    return out


def phase_entry(dev, llm, checkpoint, cli, counters):
    """Phase 8: a 2-layer Mistral-width Q8 checkpoint through the port's
    writer and reader, then the ``generate`` command on it, in-process."""
    cfg = llm.LLMConfig.mistral_7b()._replace(n_layers=2, max_seq=512,
                                              sliding_window=512)
    params = build_model(dev, llm, cfg, 8)
    meta = {"source": "chip_smoke.py", "bits": 8,
            "tokenizer_spec": spm_spec(cfg.vocab_size)}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as ckpt:
        t0 = time.perf_counter()
        checkpoint.save_checkpoint(ckpt, params, config=cfg, metadata=meta)
        t1 = time.perf_counter()
        loaded, lcfg, lmeta = checkpoint.load_checkpoint(ckpt, device=dev)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        size = sum(os.path.getsize(os.path.join(ckpt, f))
                   for f in os.listdir(ckpt))
        want, got = dict(_flat(params)), dict(_flat(loaded))
        if lcfg != cfg or lmeta != meta or want.keys() != got.keys():
            raise AssertionError("the checkpoint did not round-trip")
        for name, t in want.items():
            u = got[name]
            if (u.dtype != t.dtype or u.device != t.device or not torch.equal(
                    u.view(torch.uint8), t.view(torch.uint8))):
                raise AssertionError(f"checkpoint leaf {name} differs")
        log(f"  checkpoint: {size / 2 ** 30:.2f} GiB on disk, save "
            f"{t1 - t0:.2f} s, load {t2 - t1:.2f} s, {len(want)} tensors "
            "byte-equal, config and metadata equal")
        del loaded, got
        for fn in counters.values():
            fn.launches = 0
        rc, text, elapsed = run_cli(cli, ["generate", ckpt, "-p",
                                          "descreva a cena a sua frente",
                                          "--max-tokens", "32"])
    launches = {name: fn.launches for name, fn in counters.items()}
    log(f"  generate: exit {rc} in {elapsed:.2f} s, printed {len(text)} "
        f"chars {text[:60]!r}; launches: {launches}")
    if rc != 0 or not text.strip():
        raise AssertionError(f"generate exited {rc} and printed {text!r}")
    expect_routes(launches, ("q8_matmul",),
                  ("q4_matmul_w4a8", "quantize_activations", *DIAGNOSTIC),
                  "phase 8")


def phase_diagnostics(dev, params, cfg, counters) -> dict:
    """Phase 9: the three diagnostic tools' measurement functions on the
    card; phase 5's model (``cfg``'s 32 layers) is cut to 32/16/8 layers by
    views. Returns the launches; prints the numbers as one JSON line."""
    from trackiellm_tpu_torch.tools import (diag_envelope, diag_overhead,
                                            diag_scan_overhead)
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    out = {"overhead": {"tiny_us": diag_overhead.tiny(dev),
                        "stream_handle_us":
                            diag_overhead.stream_handle_us(dev),
                        **diag_overhead.q4_sweep(dev),
                        "rmsnorm_us": diag_overhead.rmsnorm(dev)},
           "scan": diag_scan_overhead.run(dev),
           "envelope": diag_envelope.envelope(dev),
           "decode": diag_envelope.decode_composition(params, cfg, dev)}
    launches = {name: fn.launches for name, fn in counters.items()}
    log(f"  diagnostics in {time.perf_counter() - t0:.1f} s; launches: "
        f"{launches}")
    log(json.dumps({"diagnostics": out}))
    expect_routes(launches, DIAGNOSTIC, (), "phase 9")
    return launches


def conforms(value, schema) -> bool:
    """Whether ``value`` conforms to ``schema`` in the subset phase 10's
    schemas use (type, enum, properties, required, items, maxItems); no
    schema: any JSON object."""
    if schema is None:
        return isinstance(value, dict)
    if "enum" in schema and value not in schema["enum"]:
        return False
    kind = schema.get("type")
    if kind == "object":
        props = schema.get("properties", {})
        return (isinstance(value, dict) and set(value) <= set(props)
                and set(schema.get("required", ())) <= set(value)
                and all(conforms(v, props[k]) for k, v in value.items()))
    if kind == "array":
        return (isinstance(value, list)
                and len(value) <= schema.get("maxItems", len(value))
                and all(conforms(v, schema.get("items", {})) for v in value))
    types = {"string": str, "boolean": bool, "number": (int, float),
             "integer": int}
    if kind in types:
        return (isinstance(value, types[kind])
                and (kind == "boolean" or not isinstance(value, bool)))
    return True


def timed_reply(runner, tag: str, prompt: str, **kw):
    """One ``generate`` with its wall ms, tokens and the grammar mask's host
    ms a token logged (0 for an unconstrained reply). Returns the text and
    the number of tokens sampled under the grammar's mask, which lead the
    reply (a budget's closure follows them)."""
    mask_s, n_masked = [0.0], [0]
    masks = runner._grammar_mask

    def timed_mask():
        t = time.perf_counter()
        n_masked[0] += 1
        try:
            return masks()
        finally:
            mask_s[0] += time.perf_counter() - t
    runner._grammar_mask = timed_mask
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        text = runner.generate(prompt, **kw)
        torch.cuda.synchronize()
    finally:
        del runner._grammar_mask
    n = len(runner.generated_ids)
    log(f"  request {tag}: wall_ms={(time.perf_counter() - t0) * 1e3:.2f} "
        f"tokens={n} masked_tokens={n_masked[0]} mask_ms_per_token="
        f"{mask_s[0] * 1e3 / max(n, 1):.3f} text={text[:120]!r}")
    if n == 0:
        raise AssertionError(f"request {tag} generated nothing")
    return text, n_masked[0]


def long_prompt(runner) -> str:
    """A cortex prompt whose context repeats until it takes 600-1000
    tokens (prefill bucket 1024)."""
    reps = 1
    while True:
        prompt = runner.build_prompt(SYSTEM, " ".join([CONTEXT] * reps),
                                     "Describe everything around me.")
        n = runner.count_tokens(prompt) + 1
        if n >= LONG_PROMPT[0]:
            if n > LONG_PROMPT[1]:
                raise AssertionError(f"long prompt is {n} tokens")
            return prompt
        reps += 1


def phase_slice10(dev, llm, runner_mod, tokenizer_mod, quant, params, cfg,
                  counters) -> dict:
    """Phase 10: tool calls and speculation on phase 5's Q4 model under
    ``cfg`` (max_seq 2048: bucket 1024 exists), on the default routes.
    (e) a forced tool call on the cortex prompt with three tools (two with
    an argument schema), greedy, then add_tool_response and the follow-up
    reply, and one offering only the two schema'd tools; (f)
    ``response_schema`` at temperature 0.7, twice from one seed, whose
    sampled tokens must hold more than whitespace; (g) greedy speculation,
    "auto" and True, against plain decode on the short and the cortex
    prompts, and with one-token n-grams on a repetitive prompt, where True
    must make passes; (h) sampled speculation on that prompt, twice from
    one seed, with passes (``spec_verify_sampled`` on card tensors); (i) a
    600-1000-token prompt (bucket 1024): the f32a kernel and never the
    plain path; (j) the verify pass, ``extend(all_logits=True)`` on a
    16-token chunk, against 16 decode steps. Counters are zeroed just
    before and read just after; returns the summary (launches in it)."""
    tok = tokenizer_mod.ByteTokenizer(cfg.vocab_size)

    def runner(**gen_kw):
        gen_kw.setdefault("temperature", 0.0)
        return runner_mod.LLMRunner(params, cfg, tok,
                                    runner_mod.GenerationConfig(**gen_kw),
                                    device=dev)
    tools = [runner_mod.ToolDefinition(*t) for t in TOOLS]
    schemas = {t.name: t.schema for t in tools}
    warm = runner(max_tokens=8)
    warm.generate(SHORT_PROMPT)
    warm.generate(long_prompt(warm))   # first bucket-1024 shapes
    del warm
    plain_calls = []
    plain = quant.quantized_matmul_ref
    quant.quantized_matmul_ref = lambda *a: plain_calls.append(1) or plain(*a)
    verify_sampled = runner_mod.sampling.spec_verify_sampled
    verify_devices = []

    def watched_verify(logits, *args, **kw):
        verify_devices.append(logits.device.type)
        return verify_sampled(logits, *args, **kw)
    runner_mod.sampling.spec_verify_sampled = watched_verify
    for fn in counters.values():
        fn.launches = 0
    watch = LogitWatch(llm)
    out = {}
    try:
        r = runner(max_tokens=TOOL_TOKENS)
        ask = r.build_prompt(SYSTEM, CONTEXT, "Take me to the door.", tools)
        text, _ = timed_reply(r, "e (forced tool call, cortex prompt)", ask,
                              tools=tools, force_tool_call=True)
        call = json.loads(text)["tool_call"]
        if (set(json.loads(text)) != {"tool_call"}
                or call["name"] not in schemas
                or not conforms(call["arguments"], schemas[call["name"]])
                or r.parse_tool_call() != call):
            raise AssertionError(f"tool call {text!r} does not conform")
        r.add_tool_response(call["name"], {"ok": True, "distance_m": 4.2})
        follow, _ = timed_reply(r, "e (follow-up after the tool response)",
                                r.build_prompt(SYSTEM, f"Tool {call['name']}"
                                               ": ok", "Take me to the door."))
        rt = runner(max_tokens=TOOL_TOKENS)
        text, _ = timed_reply(rt, "e (forced tool call, the schema'd tools)",
                              ask, tools=tools[:2], force_tool_call=True)
        schema_call = json.loads(text)["tool_call"]
        if (schemas.get(schema_call["name"]) is None
                or schema_call["name"] not in (t.name for t in tools[:2])
                or not conforms(schema_call["arguments"],
                                schemas[schema_call["name"]])
                or rt.parse_tool_call() != schema_call):
            raise AssertionError(f"tool call {text!r} does not conform")
        out["tool_call"] = {"call": call, "follow_up_bytes":
                            len(follow.encode()), "schema_call": schema_call}
        replies = []
        for i in range(2):
            rf = runner(max_tokens=TOOL_TOKENS, temperature=0.7, seed=SEED,
                        repetition_penalty=SCHEMA_PENALTY)
            text, n_masked = timed_reply(
                rf, f"f (response_schema, temperature 0.7, {i})", ask,
                response_schema=RESPONSE_SCHEMA)
            sampled_text = tok.decode(rf.generated_ids[:n_masked])
            replies.append((text, sampled_text))
        if (replies[0] != replies[1]
                or not conforms(json.loads(replies[0][0]), RESPONSE_SCHEMA)
                or not replies[0][1].strip()):
            raise AssertionError(f"schema replies {replies!r}")
        out["response_schema"] = {"reply": json.loads(replies[0][0]),
                                  "sampled": replies[0][1]}
        out["speculation"] = {}
        for name, prompt, kw in (("short", SHORT_PROMPT, {}),
                                 ("cortex", ask, {}),
                                 ("repeat", REPEAT_PROMPT,
                                  {"spec_min_ngram": 1})):
            ids = {}
            for spec in (False, "auto", True):
                rs = runner(max_tokens=SPEC_TOKENS, speculative=spec, **kw)
                timed_reply(rs, f"g (greedy, {name}, speculative={spec})",
                            prompt)
                ids[spec] = rs.generated_ids
                if spec:
                    out["speculation"][f"{name} {spec}"] = rs.spec_stats
                    log(f"  spec_stats {name} {spec}: {rs.spec_stats}")
            if kw and not out["speculation"][f"{name} True"]["passes"]:
                raise AssertionError("greedy speculation made no pass")
            if not ids[False] == ids["auto"] == ids[True]:
                raise AssertionError(f"speculation changed the ids ({name})")
        sampled = []
        for i in range(2):
            rs = runner(max_tokens=SPEC_TOKENS, speculative=True,
                        temperature=0.7, seed=SEED, spec_min_ngram=1)
            timed_reply(rs, f"h (sampled speculation, {i})", REPEAT_PROMPT)
            log(f"  spec_stats sampled True: {rs.spec_stats}")
            sampled.append(rs.generated_ids)
            if not rs.spec_stats["passes"]:
                raise AssertionError("sampled speculation made no pass")
        out["speculation"]["sampled True"] = rs.spec_stats
        if (sampled[0] != sampled[1]
                or set(verify_devices) != {dev.type}):
            raise AssertionError(f"seeded sampled speculation differs, or "
                                 f"verified on {set(verify_devices)}")
        rl = runner(max_tokens=16)
        prompt = long_prompt(rl)
        n_long = rl.count_tokens(prompt) + 1
        f32a_before = quant.q4_matmul_f32a.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rl.prepare_generation(prompt)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        f32a = quant.q4_matmul_f32a.launches - f32a_before
        while rl.generate_next_token() is not None:
            pass
        log(f"  request i (long prompt, {n_long} tokens, bucket 1024): "
            f"prefill_ms={prefill_ms:.2f} f32a_launches={f32a} "
            f"plain_path_calls={len(plain_calls)}")
        if f32a == 0 or plain_calls:
            raise AssertionError("bucket 1024 did not take the f32a kernel")
        out["long_prefill"] = {"tokens": n_long, "prefill_ms": prefill_ms,
                               "f32a_launches": f32a}
        out["verify"] = verify_pass(dev, llm, params, cfg, tok)
    finally:
        quant.quantized_matmul_ref = plain
        runner_mod.sampling.spec_verify_sampled = verify_sampled
        n_logits = watch.close()
    out["launches"] = {name: fn.launches for name, fn in counters.items()}
    log(f"  launches: {out['launches']}; finite logit vectors: {n_logits}")
    return out


def verify_pass(dev, llm, params, cfg, tok) -> dict:
    """(j) The verify pass alone: after the short prompt's prefill, the
    logits of ``extend(all_logits=True)`` on a 16-token chunk against 16
    ``decode_step``s from the same cache: the same argmax at every row,
    rel L2 within EXACT_WIDTH_TOL."""
    ids = tok.encode(SHORT_PROMPT, add_bos=True)
    padded = torch.zeros(64, dtype=torch.int64)
    padded[:len(ids)] = torch.tensor(ids)
    cache = llm.KVCache.create(cfg, device=dev)
    _, cache = llm.prefill(params, cfg, padded.to(dev), len(ids), cache)
    chunk = torch.randint(0, 256, (VERIFY_ROWS,),
                          generator=torch.Generator().manual_seed(SEED))
    attn = 256   # the runner's attention bucket for offset + 16
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ext, _ = llm.extend(params, cfg, chunk.to(dev), VERIFY_ROWS, cache,
                        attn_len=attn, all_logits=True)
    torch.cuda.synchronize()
    extend_ms = (time.perf_counter() - t0) * 1e3
    steps, c = [], cache._replace(length=len(ids))
    t0 = time.perf_counter()
    for t in chunk.tolist():
        lg, c = llm.decode_step(params, cfg, t, c, attn_len=attn)
        steps.append(lg)
    torch.cuda.synchronize()
    steps_ms = (time.perf_counter() - t0) * 1e3
    steps = torch.stack(steps)
    err = rel_l2(ext, steps)
    same = int((ext.argmax(-1) == steps.argmax(-1)).sum())
    log(f"  request j (verify pass, {VERIFY_ROWS} rows): rel_l2 extend vs "
        f"decode = {err:.3e} (tol {EXACT_WIDTH_TOL:.0e}); argmax equal on "
        f"{same}/{VERIFY_ROWS} rows; extend_ms={extend_ms:.2f} "
        f"decode_steps_ms={steps_ms:.2f}")
    if not (err < EXACT_WIDTH_TOL and same == VERIFY_ROWS):
        raise AssertionError(f"verify pass: rel L2 {err}, argmax {same}")
    return {"rel_l2": err, "argmax_equal": same, "extend_ms": extend_ms,
            "decode_steps_ms": steps_ms}


# Phase 12: serving. Eight slots; measure_server's configurations and a
# paged int8 pool; the cortex prompts through the prefix cache; a long
# prompt admitted in extend chunks of at most SERVE_JOB_CHUNK tokens while
# seven short requests decode; a forced tool call among cortex prompts.
SERVE_SLOTS = 8
SERVE_INT8 = ("paged_int8_chunk8", dict(chunk_steps=8, page_size=128,
                                        cache_dtype=torch.int8))
SERVE_PAGE = 128
SERVE_JOB_CHUNK = 128
SERVE_LONG = (350, 450)   # (c)'s prompt tokens
SERVE_RUNNER = 4   # pinned-burst requests also answered by LLMRunner
# Tokens of the profile's two bursts: 16 and 8 (cut from 32 and 16 to
# bring phases 1-17 under their 600-s budget; phase 12 took 41.2 s at 32
# and 16, 40.4 s at 16 and 8 in a later call, on an H100 80GB HBM3 at 700
# W). A burst of 48 (about 100,000
# records) came back without some of its launches in every retry.
SERVE_PROFILE = (16, 8)
SERVE_TIMEOUT = 600.0
# The waves prefill_batch is held to against prefill alone: rows a wave.
WAVE_ROWS = (2, 4, 8)
QUESTIONS = ("What is in front of me right now?", "Is the path clear?",
             "Where is the door?", "What does the sign say?",
             "Is the bicycle moving?", "How far is the person?",
             "What is that sound?", "Can I walk ahead safely?")


class ServerWatch:
    """Two private points of an ``LLMServer`` wrapped. ``_finish`` records
    each finished request's token ids by prompt (``ids``); ``_admit``
    records how many slots each admission wave filled (``waves``) and,
    inside ``held()``, waits before it admits. A burst submitted inside
    ``held()`` is queued whole before the serve loop takes any of it, so
    its waves are the free slots filled in submit order, in every run."""

    def __init__(self, server):
        self.ids, self.waves = {}, []
        self._open, self._parked = threading.Event(), threading.Event()
        self._open.set()
        self._server = server
        finish, admit = server._finish, server._admit

        def watched_finish(slot):
            if slot.request is not None:
                self.ids[slot.request.prompt] = list(slot.generated)
            finish(slot)

        def watched_admit():
            if not self._open.is_set():
                self._parked.set()
                if not self._open.wait(timeout=SERVE_TIMEOUT):
                    raise RuntimeError("admission held too long")
            busy = self._active()
            admit()
            if self._active() > busy:
                self.waves.append(self._active() - busy)
        server._finish, server._admit = watched_finish, watched_admit

    def _active(self) -> int:
        return sum(slot.active for slot in self._server._slots)

    @contextlib.contextmanager
    def held(self):
        self._parked.clear()
        self._open.clear()
        try:
            if not self._parked.wait(timeout=SERVE_TIMEOUT):
                raise AssertionError("phase 12: the serve loop never reached "
                                     "its admission")
            yield
        finally:
            self._open.set()


def first_divergence(a, b):
    """The first position where two id lists differ, None if equal."""
    if a == b:
        return None
    return next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                min(len(a), len(b)))


def burst(server, jobs, watch=None) -> list:
    """Submit ``jobs`` ((prompt, submit kwargs)) at once, inside
    ``watch.held()`` when given; their texts."""
    with watch.held() if watch is not None else contextlib.nullcontext():
        futs = [server.submit(p, **kw) for p, kw in jobs]
    texts = [f.result(timeout=SERVE_TIMEOUT) for f in futs]
    if not all(isinstance(t, str) for t in texts):
        raise AssertionError("phase 12: a future did not resolve to text")
    return texts


def wave_rows(dev, llm, runner_mod, params, cfg, tok, prompts,
              lone: dict) -> dict:
    """The server's two prefill routes on the card for ``prompts`` (one
    bucket): ``prefill_batch`` of the whole wave, padded to a power of two
    as the server pads it, against ``prefill`` of each prompt alone (kept
    in ``lone`` by prompt). Returns the bucket, the wave's matmul rows,
    each row's rel L2 against its lone logits and how many argmax agree."""
    ids = [tok.encode(p, add_bos=True) for p in prompts]
    bucket = next(b for b in runner_mod.PREFILL_BUCKETS
                  if b >= max(map(len, ids)))
    b_pad = 1 << (len(ids) - 1).bit_length()
    padded = np.zeros((b_pad, bucket), np.int64)
    lengths = np.zeros(b_pad, np.int32)
    for row, i in enumerate(ids):
        padded[row, :len(i)] = i
        lengths[row] = len(i)
    wave, _ = llm.prefill_batch(params, cfg, torch.from_numpy(padded).to(dev),
                                torch.from_numpy(lengths).to(dev))
    errs, same = [], 0
    for row, (p, i) in enumerate(zip(prompts, ids)):
        if p not in lone:
            lone[p] = llm.prefill(
                params, cfg, torch.from_numpy(padded[row]).to(dev), len(i),
                llm.KVCache.create(cfg, device=dev))[0].reshape(-1)
        errs.append(rel_l2(wave[row], lone[p]))
        same += int(wave[row].argmax() == lone[p].argmax())
    return {"bucket": bucket, "m": b_pad * bucket, "rel_l2": errs,
            "argmax_equal": same}


def wave_checks(dev, llm, runner_mod, params, cfg, tok, short, cortex):
    """``prefill_batch`` against ``prefill`` on the card, in waves of 2, 4
    and 8 rows (WAVE_ROWS). At bucket 64 (``short``) both take W4A8, at
    different M: within WIDTH_TOL, as the activation quantization may round
    a value the other way where the sums' order moved it. At bucket 512
    (``cortex``) under TRACKIE_Q4_F32A=1 both take f32a (the wave above
    512 rows, as by default; the lone prompt at 512) and flash (the wave's
    rows folded into the heads): within EXACT_WIDTH_TOL, only the sums'
    order differs. Reported, not checked: the bucket-512 waves on the
    default routes, where the lone prompt takes W4A8."""
    out = {}
    for label, prompts, levers, tol in (
            ("w4a8", short, (), WIDTH_TOL),
            ("f32a", cortex, ("TRACKIE_Q4_F32A",), EXACT_WIDTH_TOL),
            ("default", cortex, (), None)):
        lone = {}
        with levers_on(levers):
            for n in WAVE_ROWS:
                res = wave_rows(dev, llm, runner_mod, params, cfg, tok,
                                prompts[:n], lone)
                worst = max(res["rel_l2"])
                log(f"  prefill_batch of {n} vs prefill ({label}, bucket "
                    f"{res['bucket']}, M={res['m']}): rel_l2 max {worst:.3e}"
                    f" (tol {tol}), argmax equal on {res['argmax_equal']}"
                    f"/{n}")
                if tol is not None and not worst < tol:
                    raise AssertionError(
                        f"phase 12: prefill_batch of {n} ({label}) against "
                        f"prefill: rel L2 {res['rel_l2']}")
                out[f"{label} {n}"] = res
    return out


def server_factory(server_mod, params, cfg, tok):
    """A maker of SERVE_SLOTS-slot servers of ``params``, each with its
    ``ServerWatch``."""
    def server(**kw):
        s = server_mod.LLMServer(params, cfg, batch_slots=SERVE_SLOTS,
                                 tokenizer=tok, **kw)
        return s, ServerWatch(s)
    return server


def close_server(s) -> None:
    s.close()
    if s._fatal is not None:
        raise AssertionError(f"phase 12: a serve loop died: {s._fatal!r}")


def phase_serve(dev, llm, runner_mod, tokenizer_mod, server_mod, paging,
                measure, params, cfg, counters, profile=None) -> dict:
    """Phase 12: continuous batching on phase 5's model (``cfg``), eight
    slots. (a) ``measure_server.run`` in its four configurations and a
    paged int8 pool at 8-step chunks, once each, each reporting its
    admission waves; then on each server a pinned burst
    (``ServerWatch.held``) of the 16 requests: in each layout the chunked
    path must give all 16 the per-step path's ids and text. (b) Eight cortex prompts (the 297-token SYSTEM/CONTEXT
    prompt, eight questions) in one wave on a paged server with the prefix
    cache, then eight more: hits and reused tokens must count. (c) A
    ~400-token prompt admitted in extend chunks (``prefill_chunk``) while
    seven short requests decode: decode steps must run between its chunks.
    (d) A forced tool call among three cortex prompts (one wave of four at
    bucket 512: f32a at 2048 rows), which must parse and conform. Every
    future must resolve, no serve loop may die, and every logit must be
    finite. Counters are zeroed just before and read just after. Then a
    lone request's first token must equal ``LLMRunner``'s on the same
    prompt, and ``prefill_batch`` must agree with ``prefill`` on the card
    (``wave_checks``); reported: the share of requests whose ids equal the
    runner's and the other layout's, and a profile of 8-step chunks
    (``serve_profile``, or ``profile()`` when given)."""
    tok = tokenizer_mod.ByteTokenizer(cfg.vocab_size)
    runner = runner_mod.LLMRunner(
        params, cfg, tok, runner_mod.GenerationConfig(
            max_tokens=measure.MAX_TOKENS, temperature=0.0,
            speculative=False), device=dev)
    cortex = [runner.build_prompt(SYSTEM, CONTEXT, q) for q in QUESTIONS]

    server = server_factory(server_mod, params, cfg, tok)
    close = close_server
    for fn in counters.values():
        fn.launches = 0
    watch = LogitWatch(llm, paging)
    configs = [*measure.CONFIGS.items(), SERVE_INT8]
    out = {"configs": {}}
    ids = {}
    prompts = measure.prompts(SEED)
    pinned = [(p, dict(max_tokens=measure.MAX_TOKENS)) for p in prompts]
    try:
        for label, kw in configs:
            s, w = server(**kw)
            try:
                res = measure.run(s, SEED)
                res["waves"] = list(w.waves)
                n = len(w.waves)
                texts = burst(s, pinned, w)
                ids[label] = ([w.ids[p] for p in prompts], texts,
                              w.waves[n:])
            finally:
                close(s)
            del res["texts"]
            out["configs"][label] = res
            log(f"  serve {label}: aggregate_tok_s="
                f"{res['aggregate_tok_s']:.2f} wall_s={res['wall_s']:.3f}"
                f" decode_steps={res['decode_steps']} admission waves "
                f"{res['waves']} (the warm burst's, then the timed "
                "burst's)")
        out["chunk_vs_step"] = {}
        for one, chunked in (("per_step", "chunk8"),
                             ("paged_per_step", "paged_chunk8")):
            differ = {i: first_divergence(ids[chunked][0][i], ids[one][0][i])
                      for i in range(len(prompts))
                      if ids[chunked][0][i] != ids[one][0][i]
                      or ids[chunked][1][i] != ids[one][1][i]}
            out["chunk_vs_step"][chunked] = {
                "requests": len(prompts), "differ": len(differ),
                "waves": [ids[one][2], ids[chunked][2]]}
            log(f"  {chunked} against {one} (pinned burst of {len(prompts)},"
                f" waves {ids[chunked][2]} and {ids[one][2]}): ids and texts"
                f" {'identical' if not differ else f'differ: {differ}'}")
            if differ:
                raise AssertionError(f"phase 12: {chunked} against {one}: "
                                     f"{differ}")

        s, w = server(paged=True, page_size=SERVE_PAGE,
                      n_pages=SERVE_SLOTS * 4 + 1)
        try:
            t0 = time.perf_counter()
            burst(s, [(p, dict(max_tokens=16)) for p in cortex], w)
            cold = time.perf_counter() - t0
            t0 = time.perf_counter()
            burst(s, [(p + " Answer briefly.", dict(max_tokens=16))
                      for p in cortex], w)
            warm = time.perf_counter() - t0
            stats = dict(s.pool.prefix_stats)
        finally:
            close(s)
        n_cortex = runner.count_tokens(cortex[0]) + 1
        log(f"  prefix cache: {len(cortex)} cortex prompts "
            f"({n_cortex} tokens) in {cold * 1e3:.2f} ms, then "
            f"{len(cortex)} sharing their prefix in {warm * 1e3:.2f} ms; "
            f"{stats}; waves {w.waves}")
        if stats["hits"] < len(cortex) or not stats["tokens_reused"]:
            raise AssertionError(f"phase 12: prefix cache stats {stats}")
        out["prefix_cache"] = {"prompt_tokens": n_cortex,
                               "first_burst_ms": cold * 1e3,
                               "shared_burst_ms": warm * 1e3, **stats}

        reps = 1
        while True:
            long = runner.build_prompt(SYSTEM, " ".join([CONTEXT] * reps),
                                       "Describe everything around me.")
            n_long = runner.count_tokens(long) + 1
            if n_long >= SERVE_LONG[0]:
                break
            reps += 1
        if n_long > SERVE_LONG[1]:
            raise AssertionError(f"phase 12: long prompt is {n_long} tokens")
        s, _ = server(prefill_chunk=SERVE_JOB_CHUNK)
        steps_at_chunk = []
        advance = s._advance_prefill

        def watched_advance():
            steps_at_chunk.append(s.stats["decode_steps"])
            advance()
        s._advance_prefill = watched_advance
        try:
            shorts = [s.submit(f"{SHORT_PROMPT} {i}", max_tokens=128)
                      for i in range(SERVE_SLOTS - 1)]
            deadline = time.monotonic() + SERVE_TIMEOUT
            while not s.stats["decode_steps"] and time.monotonic() < deadline:
                time.sleep(0.001)
            t0 = time.perf_counter()
            s.submit(long, max_tokens=8).result(timeout=SERVE_TIMEOUT)
            long_ms = (time.perf_counter() - t0) * 1e3
            burst_texts = [f.result(timeout=SERVE_TIMEOUT) for f in shorts]
        finally:
            close(s)
        between = [b - a for a, b in zip(steps_at_chunk, steps_at_chunk[1:])]
        log(f"  chunked prefill: {n_long}-token prompt in "
            f"{len(steps_at_chunk)} chunks, {long_ms:.2f} ms to its reply; "
            f"decode steps between its chunks {between}")
        if len(steps_at_chunk) < 3 or not all(between) or not all(
                isinstance(t, str) for t in burst_texts):
            raise AssertionError(f"phase 12: chunked prefill did not "
                                 f"interleave: {steps_at_chunk}")
        out["chunked_prefill"] = {"prompt_tokens": n_long,
                                  "chunks": len(steps_at_chunk),
                                  "steps_between": between,
                                  "reply_ms": long_ms}

        tools = [runner_mod.ToolDefinition(*t) for t in TOOLS]
        schemas = {t.name: t.schema for t in tools}
        ask = runner.build_prompt(SYSTEM, CONTEXT, "Take me to the door.",
                                  tools)
        s, w = server()
        try:
            texts = burst(s, [(ask, dict(
                max_tokens=TOOL_TOKENS, tool_names=list(schemas),
                tool_schemas={k: v for k, v in schemas.items() if v}))]
                + [(p, dict(max_tokens=16)) for p in cortex[:3]], w)
        finally:
            close(s)
        call = json.loads(texts[0])["tool_call"]
        log(f"  served tool call (waves {w.waves}): {texts[0]!r}")
        if (call["name"] not in schemas
                or not conforms(call["arguments"], schemas[call["name"]])):
            raise AssertionError(f"phase 12: tool call {texts[0]!r} does "
                                 "not conform")
        out["tool_call"] = call

        s, w = server()
        try:
            s.generate(SHORT_PROMPT, max_tokens=4, timeout=SERVE_TIMEOUT)
        finally:
            close(s)
        served_first = w.ids[SHORT_PROMPT][0]
    finally:
        n_logits = watch.close()
    out["launches"] = {name: fn.launches for name, fn in counters.items()}
    log(f"  launches: {out['launches']}; finite logit tensors: {n_logits}")

    runner.prepare_generation(SHORT_PROMPT)
    want = int(torch.argmax(runner._next_logits))
    log(f"  lone request's first token {served_first}, LLMRunner's {want}")
    if served_first != want:
        raise AssertionError("phase 12: the served first token is not "
                             "the runner's")
    out["waves"] = wave_checks(dev, llm, runner_mod, params, cfg, tok,
                               prompts[:max(WAVE_ROWS)], cortex)
    agree = {}
    for i, prompt in enumerate(prompts[:SERVE_RUNNER]):
        runner.generate(prompt)
        for label in ("per_step", "paged_per_step"):
            agree.setdefault(label, []).append(
                first_divergence(runner.generated_ids, ids[label][0][i]))
    layouts = [first_divergence(a, b) for a, b in
               zip(ids["per_step"][0], ids["paged_per_step"][0])]
    out["agreement"] = {
        "runner_share": {k: v.count(None) / len(v) for k, v in agree.items()},
        "runner_first_divergence": agree,
        "dense_paged_share": layouts.count(None) / len(layouts),
        "dense_paged_first_divergence": layouts,
        "int8_share": sum(a == b for a, b in zip(
            ids["paged_int8_chunk8"][0], ids["paged_chunk8"][0]))
        / len(layouts)}
    log(f"  agreement (reported): {out['agreement']}")
    out["profile"] = (profile() if profile is not None
                      else serve_profile(server, measure, close, counters))
    expect_routes(out["launches"], ("q4_matmul_w4a8", "quantize_activations",
                                    "flash_attention", "q4_matmul_f32a"),
                  ("q8_matmul", "fused_mlp_q4", *DIAGNOSTIC), "phase 12")
    if (out["launches"]["quantize_activations"]
            != out["launches"]["q4_matmul_w4a8"]):
        raise AssertionError("phase 12: not one activation quantization per "
                             "W4A8 matmul")
    return out


def serve_profile(server, measure, close, counters) -> dict:
    """Bursts of eight requests of measure_server's prompts on a dense
    8-step-chunk server, each one admission wave at bucket 64
    (``ServerWatch.held``), after a warm burst: a burst of the longer of
    SERVE_PROFILE's token counts on the host clock, then under the
    profiler a burst of each. Their difference is decode steps alone: the
    launches and device busy ms a step; what the short burst holds beyond
    its steps is the admission wave's. The idle share is the long
    burst's. A profile must show every launch the wrappers (``counters``)
    counted in its window; one that misses some is taken again, up to
    PROFILE_RETRIES times. A window that never shows them all keeps its
    numbers beside a ``missed`` note of what the profiler did not see."""
    s, w = server(chunk_steps=8)
    asked = measure.prompts(SEED)[:SERVE_SLOTS]

    def one(tag, tokens):  # a short tag keeps the prompts in bucket 64
        return burst(s, [(f"{p} ({tag})", dict(max_tokens=tokens))
                         for p in asked], w)
    long, short = SERVE_PROFILE
    windows, notes = {}, {}
    try:
        one("warm", long)
        t0 = time.perf_counter()
        one("wall", long)
        wall = (time.perf_counter() - t0) * 1e3
        for tokens in SERVE_PROFILE:
            for attempt in range(1 + PROFILE_RETRIES):
                steps = s.stats["decode_steps"]
                before = {k: f.launches for k, f in counters.items()}
                busy, n, by_name = device_breakdown(
                    lambda: one(f"p{tokens}-{attempt}", tokens))
                notes[tokens] = missed_launches(by_name, {
                    k: f.launches - before[k] for k, f in counters.items()})
                windows[tokens] = (busy, n, s.stats["decode_steps"] - steps,
                                   by_name)
                if notes[tokens] is None:
                    break
    finally:
        close(s)
    busy, n, steps, by_name = windows[long]
    busy_s, n_s, steps_s, _ = windows[short]
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]
    per_step = (n - n_s) / (steps - steps_s)
    missed = {t: note for t, note in notes.items() if note is not None}
    prof = {"wall_ms": wall, "busy_ms": busy, "idle_share": 1.0 - busy / wall,
            "decode_steps": steps, "launches": n,
            "short_decode_steps": steps_s, "short_launches": n_s,
            "short_busy_ms": busy_s, "launches_per_step": per_step,
            "busy_ms_per_step": (busy - busy_s) / (steps - steps_s),
            "admission_launches": n_s - per_step * steps_s,
            "waves": list(w.waves), "tokens": SERVE_SLOTS * long,
            "top": [[k[:80], t, c] for k, (t, c) in top],
            "missed": missed}
    log(f"  profile chunk8 burst: wall {wall:.2f} ms busy {busy:.2f} ms "
        f"(idle {prof['idle_share']:.3f}), {steps} decode steps; from the "
        f"{long}- and {short}-token bursts: "
        f"{per_step:.1f} launches and {prof['busy_ms_per_step']:.3f} busy "
        f"ms a decode step, {prof['admission_launches']:.1f} launches in "
        f"the admission wave; waves {w.waves}"
        + (f"; after {PROFILE_RETRIES} retries the profiler missed "
           f"{missed}" if missed else ""))
    return prof


SERVE_PROFILE_FLAG = "--serve-profile"


def serve_profile_child() -> dict:
    """Phase 12's profile in a process of its own (this script with
    SERVE_PROFILE_FLAG): late in the smoke's process, after the earlier
    phases' profiles, ``torch.profiler`` left out some kernel records of
    every serving window. The child's log lines are passed on; its last
    line is ``serve_profile``'s result."""
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), SERVE_PROFILE_FLAG],
        capture_output=True, text=True, timeout=SERVE_TIMEOUT)
    lines = proc.stdout.strip().splitlines()
    if proc.returncode != 0 or not lines:
        raise AssertionError(f"phase 12: the profile's process exited "
                             f"{proc.returncode}: {proc.stderr[-2000:]}")
    for line in lines[:-1]:
        log(line)
    return json.loads(lines[-1])


def serve_profile_main(dev) -> int:
    """The child of ``serve_profile_child``: phase 12's model (phase 5's
    cut to CUT_LAYERS layers) from the seed behind a dense 8-step-chunk
    server, ``serve_profile`` on it."""
    from trackiellm_tpu_torch.llm import server as server_mod
    from trackiellm_tpu_torch.llm import tokenizer as tokenizer_mod
    from trackiellm_tpu_torch.models import llm
    from trackiellm_tpu_torch.ops import _build
    from trackiellm_tpu_torch.tools import measure_server
    _build.library()
    cfg = serve_config(llm)._replace(n_layers=CUT_LAYERS)
    params = build_model(dev, llm, cfg, 4)
    tok = tokenizer_mod.ByteTokenizer(cfg.vocab_size)
    prof = serve_profile(server_factory(server_mod, params, cfg, tok),
                         measure_server, close_server, launch_counters())
    print(json.dumps(prof), flush=True)
    return 0


# Phase 13: the voice path. Whisper-tiny at its published widths from a
# whisper.cpp GGML file this script writes, Whisper large-v3's widths cut to
# 2+2 layers, Silero VAD and a Piper voice from ONNX files under the
# published names of the port's name maps, and the app's TTS; the card
# against the port's own CPU run where a tolerance is named.
VOICE_SECONDS = 5            # the transcribed signal
VOICE_RATE = 48_000          # given at the microphone's rate: resample_poly
VOICE_WINDOWS = (1500, 500)  # n_audio_ctx: 30 s, and the app's 10 s
# max_tokens of every transcription: cut from 96 to 48 to bring phases 1-17
# under their 600-s budget (phase 13 took 41.9 s at 96, 31.6-48.7 s at 48
# in later calls; on an H100 80GB HBM3 at 700 W), then to 24 with
# VOICE_PROFILE_TOKENS 8 to pay for phase 21 (51.2 s at 48 and 16, 35.4-42.2
# s at 24 and 8); the ids-equality and logit checks stay.
VOICE_TOKENS = 24
VOICE_FORCED = 8             # teacher-forced decode steps of the logit check
VOICE_LOGIT_TOL = 1e-4       # rel L2, card against CPU
LARGE_V3_LAYERS = 2          # encoder and decoder layers of (b)
SILERO_SECONDS = 10          # 312 chunks of 512 samples
SILERO_TOL = 1e-5            # max abs, probabilities
TTS_REPLY = "Há uma pessoa a dois metros à frente e a porta fica ao lado."
TTS_STREAM_TOL = 1e-6        # max abs, streamed chunks against one-shot
VITS_TEXT = "ola, a porta fica a esquerda e a mesa a frente."
VITS_TOL = 1e-4              # rel L2, card against CPU, injected noise
# Decode steps of the profiled window: cut from 32 to 16 to bring phases
# 1-17 under their 600-s budget (phase 13 took 39.9 s at 32 and
# VOICE_TOKENS 48, 31.6 s at 16 in a later call; on an H100 80GB HBM3 at
# 700 W), then to 8 (above VOICE_TOKENS).
VOICE_PROFILE_TOKENS = 8
VOICE_PROFILE_ENCODES = 5    # encoder calls of the profiled window
VOICE_PROFILE_FLAG = "--voice-profile"
# whisper.cpp's converter keeps these f32 in an f16 file.
GGML_F32_NAMES = ("encoder.conv1.bias", "encoder.conv2.bias",
                  "encoder.positional_embedding",
                  "decoder.positional_embedding")
NAME_MAPS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "trackiellm_tpu_torch", "models", "name_maps")


def voice_signal(seconds: float, rate: int, seed: int) -> np.ndarray:
    """Speech-like audio from the seed: a gliding voiced tone with five
    harmonics under a 4 Hz syllable envelope, and noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * rate)) / rate
    f0 = 140.0 + 40.0 * np.sin(2 * np.pi * 0.7 * t)
    phase = 2 * np.pi * np.cumsum(f0) / rate
    voiced = sum(np.sin(k * phase) / k for k in range(1, 6))
    env = 0.5 * (1.0 + np.sin(2 * np.pi * 4.0 * t))
    return (0.2 * env * voiced
            + 0.01 * rng.standard_normal(t.size)).astype(np.float32)


def whisper_state(cfg, seed: int) -> dict:
    """Random weights at ``cfg``'s widths in openai-whisper's state-dict
    layout, the names a whisper.cpp GGML file keeps."""
    rng = np.random.default_rng(seed)
    d = cfg.d_model

    def lin(cout, cin):
        return rng.uniform(-1, 1, (cout, cin)).astype(np.float32) / np.float32(
            math.sqrt(cin))

    def normal(shape, s):
        return (s * rng.standard_normal(shape)).astype(np.float32)

    st = {"encoder.conv1.weight": normal((d, cfg.n_mels, 3), 0.02),
          "encoder.conv1.bias": normal(d, 0.01),
          "encoder.conv2.weight": normal((d, d, 3), 0.02),
          "encoder.conv2.bias": normal(d, 0.01),
          "encoder.positional_embedding": np.zeros((cfg.n_audio_ctx, d),
                                                   np.float32)}

    def block(prefix, parts):
        for part in parts:
            st[f"{prefix}.{part}_ln.weight"] = np.ones(d, np.float32)
            st[f"{prefix}.{part}_ln.bias"] = np.zeros(d, np.float32)
            for w in ("query", "key", "value", "out"):
                st[f"{prefix}.{part}.{w}.weight"] = lin(d, d)
                if w != "key":
                    st[f"{prefix}.{part}.{w}.bias"] = normal(d, 0.01)
        st[f"{prefix}.mlp_ln.weight"] = np.ones(d, np.float32)
        st[f"{prefix}.mlp_ln.bias"] = np.zeros(d, np.float32)
        st[f"{prefix}.mlp.0.weight"] = lin(4 * d, d)
        st[f"{prefix}.mlp.0.bias"] = normal(4 * d, 0.01)
        st[f"{prefix}.mlp.2.weight"] = lin(d, 4 * d)
        st[f"{prefix}.mlp.2.bias"] = normal(d, 0.01)
    for i in range(cfg.n_audio_layers):
        block(f"encoder.blocks.{i}", ("attn",))
    st["encoder.ln_post.weight"] = np.ones(d, np.float32)
    st["encoder.ln_post.bias"] = np.zeros(d, np.float32)
    # Byte tokens' rows are the longest, so greedy ids often fall on them
    # and a byte tokenizer's transcript is not empty.
    st["decoder.token_embedding.weight"] = normal((cfg.vocab_size, d), 0.02)
    st["decoder.token_embedding.weight"][:256] *= 4.0
    st["decoder.positional_embedding"] = normal((cfg.n_text_ctx, d), 0.01)
    for i in range(cfg.n_text_layers):
        block(f"decoder.blocks.{i}", ("attn", "cross_attn"))
    st["decoder.ln.weight"] = np.ones(d, np.float32)
    st["decoder.ln.bias"] = np.zeros(d, np.float32)
    return st


def write_ggml_whisper(path: str, state: dict, cfg, filters,
                       vocab) -> int:
    """A whisper.cpp GGML file as its convert-pt-to-ggml.py writes one:
    hparams, mel filters, byte vocab, then each tensor squeezed (conv
    biases (n, 1)), dims reversed, f16 for matrices but the converter's f32
    names. Returns its size in bytes."""
    hp = (cfg.vocab_size, cfg.n_audio_ctx, cfg.d_model, cfg.n_heads,
          cfg.n_audio_layers, cfg.n_text_ctx, cfg.d_model, cfg.n_heads,
          cfg.n_text_layers, cfg.n_mels, 1)
    with open(path, "wb") as f:
        f.write(struct.pack("<i", 0x67676D6C))
        f.write(struct.pack("<11i", *hp))
        f.write(struct.pack("<2i", *filters.shape))
        f.write(np.asarray(filters, "<f4").tobytes())
        f.write(struct.pack("<i", len(vocab)))
        for tok in vocab:
            f.write(struct.pack("<i", len(tok)) + tok)
        for name, arr in state.items():
            data = np.asarray(arr, np.float32).squeeze()
            if name in GGML_F32_NAMES[:2]:
                data = data.reshape(data.shape[0], 1)
            if data.ndim < 2 or name in GGML_F32_NAMES:
                ftype, payload = 0, data.astype("<f4").tobytes()
            else:
                ftype, payload = 1, data.astype("<f2").tobytes()
            nm = name.encode()
            f.write(struct.pack("<3i", data.ndim, len(nm), ftype))
            for i in range(data.ndim):
                f.write(struct.pack("<i", data.shape[data.ndim - 1 - i]))
            f.write(nm + payload)
        return f.tell()


def whisper_vocab(n: int):
    """A byte-level vocabulary of ``n`` entries: the 256 bytes, then
    word pieces."""
    return [bytes([i]) for i in range(256)] + [
        f" w{i}".encode() for i in range(256, n)]


def wall_ms(fn):
    """(result, host ms) of ``fn`` between two card synchronizations."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def agreement(a, b) -> dict:
    """How far two id lists agree: equal positions and the first
    divergence."""
    first = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                 min(len(a), len(b)))
    return {"equal": sum(x == y for x, y in zip(a, b)), "first_diff": first,
            "card": len(a), "cpu": len(b)}


def forced_logits(whisper, params, cfg, mel, ids, n_steps: int):
    """The logits of the first ``n_steps`` decode steps after the prompt,
    each step fed ``ids`` (teacher forcing), as one (n_steps, V) tensor."""
    feats = whisper.encode(params, cfg, mel)
    cache = whisper.make_decoder_cache(params, cfg, feats)
    for t in whisper._prompt(cfg, 0):
        logits, cache = whisper.decode_step(params, cfg, t, cache)
    out = [logits]
    for t in ids[:n_steps - 1]:
        logits, cache = whisper.decode_step(params, cfg, t, cache)
        out.append(logits)
    return torch.stack(out)


def decode_window(whisper, params, cfg, mel, steps: int):
    """A function that decodes ``steps`` greedy tokens from the prompt's
    cache (set up outside it) as ``transcribe_tokens`` does: one argmax
    fetch a token."""
    feats = whisper.encode(params, cfg, mel)

    def setup():
        cache = whisper.make_decoder_cache(params, cfg, feats)
        for t in whisper._prompt(cfg, 0):
            logits, cache = whisper.decode_step(params, cfg, t, cache)
        return logits, cache

    def run(state):
        logits, cache = state
        for _ in range(steps):
            tok = int(torch.argmax(logits))
            logits, cache = whisper.decode_step(params, cfg, tok, cache)
        return logits
    return setup, run


def whisper_window(whisper, asr_mod, params, cpu_params, cfg, tok,
                   signal) -> dict:
    """(a) at one window: transcription ids on the card and the CPU, the
    teacher-forced logits, encode and decode times, RTF."""
    asr = asr_mod.WhisperASR(params, cfg, tok, max_tokens=VOICE_TOKENS)
    cpu = asr_mod.WhisperASR(cpu_params, cfg, tok, max_tokens=VOICE_TOKENS)
    asr.transcribe_ids(signal, VOICE_RATE)  # warm
    ids, wall = wall_ms(lambda: asr.transcribe_ids(signal, VOICE_RATE))
    ref = cpu.transcribe_ids(signal, VOICE_RATE)
    mel = asr.mel(signal, VOICE_RATE)
    steps = min(VOICE_FORCED, len(ref) + 1)
    lg = forced_logits(whisper, params, cfg, mel, ref, steps)
    lc = forced_logits(whisper, cpu_params, cfg, cpu.mel(signal, VOICE_RATE),
                       ref, steps)
    if not torch.isfinite(lg).all():
        raise AssertionError(f"phase 13: whisper-tiny n_audio_ctx "
                             f"{cfg.n_audio_ctx}: non-finite logits")
    errs = [rel_l2(lg[i].cpu(), lc[i]) for i in range(steps)]
    encode = time_ms(lambda: whisper.encode(params, cfg, mel), iters=5,
                     warmup=1)
    setup, run = decode_window(whisper, params, cfg, mel, len(ids))
    state = setup()
    _, dec_wall = wall_ms(lambda: run(state))
    out = {"ids": agreement(ids, ref), "logits_rel_l2": max(errs),
           "logits_rel_l2_by_step": errs, "tol": VOICE_LOGIT_TOL,
           "encode_ms": encode,
           "decode_ms_per_token": dec_wall / max(len(ids), 1),
           "transcribe_ms": wall, "rtf": wall / 1e3 / VOICE_SECONDS}
    log(f"  whisper-tiny n_audio_ctx {cfg.n_audio_ctx}: {len(ids)} ids on "
        f"the card, {len(ref)} on the CPU, {out['ids']['equal']} equal "
        f"(first difference at {out['ids']['first_diff']}); teacher-forced "
        f"logits over {steps} steps: rel_l2 {max(errs):.3e} (tol "
        f"{VOICE_LOGIT_TOL:.0e}); encode {encode:.3f} ms, decode "
        f"{out['decode_ms_per_token']:.3f} ms a token, transcribe "
        f"{wall:.1f} ms, RTF {out['rtf']:.4f}")
    if max(errs) > VOICE_LOGIT_TOL:
        raise AssertionError(f"phase 13: whisper-tiny n_audio_ctx "
                             f"{cfg.n_audio_ctx}: logits rel_l2 {max(errs)}")
    return out


def voice_configs() -> dict:
    """Phase 13's configurations: Whisper-tiny, large-v3's widths cut to
    LARGE_V3_LAYERS + LARGE_V3_LAYERS, the app's TTS and the widths
    (d_model, n_layers, up_init_ch, upsample_rates, sample_rate) the Piper
    voice must come out with."""
    from trackiellm_tpu_torch.models import tts, whisper
    return {"tiny": whisper.WhisperConfig.tiny(),
            "large": whisper.WhisperConfig.large_v3()._replace(
                n_audio_layers=LARGE_V3_LAYERS,
                n_text_layers=LARGE_V3_LAYERS),
            "tts": tts.TTSConfig.default(),
            "vits": (192, 6, 512, (8, 8, 2, 2), 22050)}


def phase_whisper(dev, cli, tmp: str, sizes: dict) -> dict:
    """(a) Whisper-tiny from a GGML file at both windows and through the
    ``transcribe`` CLI; (b) large-v3's widths cut to 2+2 layers."""
    import wave

    from trackiellm_tpu_torch.audio import asr as asr_mod
    from trackiellm_tpu_torch.llm.tokenizer import ByteTokenizer
    from trackiellm_tpu_torch.models import checkpoint, convert, whisper
    from trackiellm_tpu_torch.ops.mel import mel_filterbank
    cfg = sizes["tiny"]
    path = os.path.join(tmp, "ggml-tiny.bin")
    t0 = time.perf_counter()
    size = write_ggml_whisper(path, whisper_state(cfg, SEED), cfg,
                              mel_filterbank(cfg.n_mels).T,
                              whisper_vocab(min(cfg.vocab_size, 50257)))
    params, got, ggml_tok, _ = convert.whisper_from_ggml(path, device=dev)
    cpu_params, _, _, _ = convert.whisper_from_ggml(path, device="cpu")
    if got != cfg or params["tok_emb"].device.type != dev.type:
        raise AssertionError(f"phase 13: whisper_from_ggml gave {got} on "
                             f"{params['tok_emb'].device}")
    log(f"  whisper-tiny GGML: {size} bytes written and loaded on the card "
        f"and the CPU in {time.perf_counter() - t0:.1f} s")
    signal = voice_signal(VOICE_SECONDS, VOICE_RATE, SEED)
    out = {"ggml_bytes": size, "windows": {}}
    for ctx in VOICE_WINDOWS:
        out["windows"][str(ctx)] = whisper_window(
            whisper, asr_mod, params, cpu_params,
            cfg._replace(n_audio_ctx=min(ctx, cfg.n_audio_ctx)), ggml_tok,
            signal)

    # The transcribe CLI on a checkpoint and a WAV written here (the app's
    # 10-s window, the byte tokenizer, as the JAX command reads it).
    app = cfg._replace(n_audio_ctx=min(VOICE_WINDOWS[-1], cfg.n_audio_ctx))
    ckpt = os.path.join(tmp, "whisper-ckpt")
    checkpoint.save_checkpoint(ckpt, cpu_params, metadata={
        "whisper_config": dict(app._asdict())})
    wav = os.path.join(tmp, "speech.wav")
    pcm = (np.clip(signal, -1, 1) * 32767).astype(np.int16)
    with wave.open(wav, "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(VOICE_RATE)
        f.writeframes(pcm.tobytes())
    rc, text, secs = run_cli(cli, ["transcribe", wav, "--checkpoint", ckpt])
    ref = asr_mod.WhisperASR(params, app, ByteTokenizer(app.vocab_size)
                             ).transcribe(pcm.astype(np.float32) / 32768.0,
                                          VOICE_RATE)
    if rc != 0 or text.strip() != ref:
        raise AssertionError(f"phase 13: transcribe exited {rc} and printed "
                             f"{text[-200:]!r}, not {ref[-200:]!r}")
    out["cli"] = {"rc": rc, "seconds": secs, "chars": len(text.strip())}
    log(f"  transcribe CLI (checkpoint, 48 kHz WAV): exit {rc} in "
        f"{secs:.1f} s, the engine's text ({len(ref)} chars)")
    del params, cpu_params

    # (b) large-v3's widths cut to LARGE_V3_LAYERS + LARGE_V3_LAYERS.
    lcfg = sizes["large"]
    lparams = whisper.init_whisper(
        torch.Generator(device=dev).manual_seed(SEED), lcfg)
    asr = asr_mod.WhisperASR(lparams, lcfg, max_tokens=VOICE_TOKENS)
    ids, wall = wall_ms(lambda: asr.transcribe_ids(signal, VOICE_RATE))
    mel = asr.mel(signal, VOICE_RATE)
    feats = whisper.encode(lparams, lcfg, mel)
    if (mel.shape != (128, 2 * lcfg.n_audio_ctx)
            or not torch.isfinite(feats).all()
            or not all(0 <= i < lcfg.vocab_size for i in ids)):
        raise AssertionError(f"phase 13: large-v3 widths: mel {mel.shape}, "
                             f"ids {ids[:8]}")
    encode = time_ms(lambda: whisper.encode(lparams, lcfg, mel), iters=3,
                     warmup=1)
    out["large_v3"] = {"layers": LARGE_V3_LAYERS, "ids": len(ids),
                       "transcribe_ms": wall, "encode_ms": encode,
                       "rtf": wall / 1e3 / VOICE_SECONDS,
                       "cut": f"32+32 layers to {LARGE_V3_LAYERS}+"
                              f"{LARGE_V3_LAYERS}"}
    log(f"  whisper large-v3 widths ({LARGE_V3_LAYERS}+{LARGE_V3_LAYERS} "
        f"layers, 128 mels, d 1280, 20 heads, vocab 51866): {len(ids)} ids "
        f"in {wall:.1f} ms (first call), encode {encode:.3f} ms")
    return out


def map_shapes(name: str) -> dict:
    """The published shapes a bundled name map records (``_shape:``)."""
    with open(os.path.join(NAME_MAPS, f"{name}.json"),
              encoding="utf-8") as f:
        data = json.load(f)
    return {k[len("_shape:"):]: tuple(v) for k, v in data.items()
            if k.startswith("_shape:")}


def silero_state(seed: int) -> dict:
    """Random Silero v5 initializers under the ``silero_v5`` map's
    published names, at its shapes; the STFT basis is the real windowed
    DFT."""
    from trackiellm_tpu_torch.models.convert import load_name_map
    from trackiellm_tpu_torch.models.vad import _dft_power_bases
    rng = np.random.default_rng(seed)
    published = {v: k for k, v in load_name_map("silero_v5").items()}
    st = {}
    for name, shape in map_shapes("silero_v5").items():
        if name.endswith("forward_basis_buffer"):
            cos_b, sin_b = _dft_power_bases(shape[2])
            a = np.concatenate([cos_b.T, sin_b.T])[:, None, :]
        elif name.endswith("bias") or len(shape) == 1:
            a = 0.01 * rng.standard_normal(shape)
        else:
            a = rng.uniform(-1, 1, shape) / math.sqrt(np.prod(shape[1:]))
        st[published.get(name, name)] = a.astype(np.float32)
    return st


def phase_silero(dev, tmp: str) -> dict:
    """(c) Silero from an ONNX file, 10 s of audio chunk by chunk with the
    state carried, the card against the CPU."""
    from trackiellm_tpu_torch.models import convert, vad
    from trackiellm_tpu_torch.models.onnx_reader import (
        read_onnx_initializers, write_onnx_initializers)
    path = os.path.join(tmp, "silero_vad.onnx")
    write_onnx_initializers(path, silero_state(SEED))
    state = convert.apply_name_map(read_onnx_initializers(path),
                                   convert.load_name_map("silero_v5"))
    params, cfg = convert.silero_from_onnx(state, device=dev)
    cpu, _ = convert.silero_from_onnx(state, device="cpu")
    if cfg != vad.SileroConfig():
        raise AssertionError(f"phase 13: silero_from_onnx gave {cfg}")
    audio = voice_signal(SILERO_SECONDS, 16_000, SEED + 1)
    n = len(audio) // vad.CHUNK_SAMPLES
    chunks = torch.from_numpy(audio[:n * vad.CHUNK_SAMPLES]).reshape(n, -1)

    def run(p, device):
        state = vad.silero_init_state(cfg, device)
        probs = []
        x = chunks.to(device)
        for i in range(n):
            prob, state = vad.silero_step(p, cfg, x[i], state)
            probs.append(prob)
        return torch.stack(probs)
    got, _ = wall_ms(lambda: run(params, dev))
    ref = run(cpu, torch.device("cpu"))
    err = (got.cpu() - ref).abs().max().item()
    wrapper = vad.SileroVAD(params, cfg)
    _, wall = wall_ms(lambda: [wrapper(audio[i:i + 1600])
                               for i in range(0, len(audio), 1600)])
    out = {"chunks": n, "max_abs_err": err, "tol": SILERO_TOL,
           "ms_per_chunk": wall / n, "speech_share": float(
               (got > 0.5).float().mean())}
    log(f"  silero (ONNX, silero_v5 names): {n} chunks, probabilities card "
        f"vs cpu max abs {err:.3e} (tol {SILERO_TOL:.0e}); "
        f"{out['ms_per_chunk']:.3f} ms a 32-ms chunk through SileroVAD")
    if not (torch.isfinite(got).all() and err <= SILERO_TOL):
        raise AssertionError(f"phase 13: silero max abs {err}")
    return out


def phase_tts(dev, llm, cfg) -> dict:
    """(d) The app's TTS at TTSConfig.default(): a 60-character reply
    through TTSEngine.stream and synthesize; the joined chunks against the
    one-shot waveform, the card against the CPU."""
    from trackiellm_tpu_torch.audio.tts_engine import TTSEngine
    from trackiellm_tpu_torch.models import tts
    params = tts.init_tts(torch.Generator(device=dev).manual_seed(SEED), cfg)
    engine = TTSEngine(params, cfg)
    cpu = TTSEngine(llm.params_to(params, torch.device("cpu")), cfg)
    for _ in engine.stream(TTS_REPLY):  # warm
        pass
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    chunks, first = [], None
    for c in engine.stream(TTS_REPLY):
        first = first or (time.perf_counter() - t0) * 1e3
        chunks.append(c)
    total = (time.perf_counter() - t0) * 1e3
    one, one_ms = wall_ms(lambda: engine.synthesize(TTS_REPLY))
    ref = cpu.synthesize(TTS_REPLY)
    joined = np.concatenate(chunks)
    same = len(joined) == len(one) and np.array_equal(joined, one)
    diff = (float(np.abs(joined - one).max())
            if len(joined) == len(one) else float("inf"))
    frames_card, frames_cpu = len(one) // cfg.hop, len(ref) // cfg.hop
    out = {"chars": len(TTS_REPLY), "chunks": len(chunks),
           "samples": len(one), "first_chunk_ms": first,
           "stream_ms": total, "synthesize_ms": one_ms,
           "streamed_bit_identical": same, "streamed_max_abs": diff,
           "tol": TTS_STREAM_TOL, "frames_card": frames_card,
           "frames_cpu": frames_cpu,
           "rel_l2_vs_cpu": (rel_l2(torch.from_numpy(one),
                                    torch.from_numpy(ref))
                             if len(one) == len(ref) else None)}
    log(f"  TTS default ({len(TTS_REPLY)} chars): {len(chunks)} chunks, "
        f"first at {first:.2f} ms, all {total:.2f} ms (one-shot "
        f"{one_ms:.2f} ms); streamed "
        + ("bit-identical to" if same else f"max abs {diff:.3e} from")
        + f" the one-shot waveform; frames card {frames_card} cpu "
        f"{frames_cpu}" + ("" if frames_card == frames_cpu else
                           " (a duration boundary flipped)")
        + (f", rel_l2 vs cpu {out['rel_l2_vs_cpu']:.3e}"
           if out["rel_l2_vs_cpu"] is not None else ""))
    if not (np.isfinite(one).all() and diff <= TTS_STREAM_TOL):
        raise AssertionError(f"phase 13: streamed TTS max abs {diff}")
    return out


def piper_state(seed: int) -> dict:
    """Random VITS weights at VITSConfig()'s widths under the
    ``piper_vits`` map's published names and shapes: weight-normed convs
    as (g, v) with g = |v|, norms at one, the duration flows' projections
    small."""
    rng = np.random.default_rng(seed)
    shapes = map_shapes("piper_vits")
    st = {}
    for name, shape in shapes.items():
        fan_in = float(np.prod(shape[1:])) if len(shape) > 1 else 1.0
        if name.endswith("weight_g"):
            continue
        if name.endswith("gamma"):
            a = 1.0 + 0.01 * rng.standard_normal(shape)
        elif name.endswith(("beta", "bias")):
            a = 0.01 * rng.standard_normal(shape)
        elif name.endswith(("emb_rel_k", "emb_rel_v")):
            a = rng.standard_normal(shape) / math.sqrt(shape[-1])
        elif name == "enc_p.emb.weight":
            a = rng.standard_normal(shape) / math.sqrt(shape[1])
        elif name.endswith((".m", ".logs")):
            a = 0.1 * rng.standard_normal(shape)
        elif ".flows." in name and name.endswith(("post.weight",
                                                  "proj.weight")):
            a = 0.02 * rng.standard_normal(shape)
        else:
            a = rng.standard_normal(shape) / math.sqrt(fan_in)
        st[name] = a.astype(np.float32)
    for name, shape in shapes.items():
        if name.endswith("weight_g"):
            v = st[name[:-1] + "v"]
            st[name] = np.sqrt((v.reshape(v.shape[0], -1) ** 2).sum(-1)
                               ).reshape(shape).astype(np.float32)
    return st


def phase_vits(dev, cli, tmp: str, widths) -> dict:
    """(e) A Piper voice at VITSConfig()'s widths from an ONNX file and its
    JSON: from_piper on the card and the CPU, the waveform from injected
    noise compared, RTF, and the ``synth`` CLI."""
    import wave

    from trackiellm_tpu_torch.models import vits
    from trackiellm_tpu_torch.models.onnx_reader import (
        write_onnx_initializers)
    onnx = os.path.join(tmp, "pt_BR-voice.onnx")
    write_onnx_initializers(onnx, piper_state(SEED))
    letters = "abcdefghijklmnopqrstuvwxyz"
    conf = {"audio": {"sample_rate": widths[-1]},
            "phoneme_id_map": {"_": [0], "^": [1], "$": [2], " ": [3],
                               ",": [4], ".": [5],
                               **{c: [10 + i] for i, c in
                                  enumerate(letters)}}}
    conf_path = onnx + ".json"
    with open(conf_path, "w", encoding="utf-8") as f:
        json.dump(conf, f)
    voice = vits.VITSVoice.from_piper(onnx, conf_path, device=dev)
    cpu = vits.VITSVoice.from_piper(onnx, conf_path, device="cpu")
    cfg = voice.cfg
    if (cfg.d_model, cfg.n_layers, cfg.up_init_ch, cfg.upsample_rates,
            cfg.sample_rate) != widths:
        raise AssertionError(f"phase 13: the Piper voice's config {cfg}")
    ph, n = voice.phonemes(VITS_TEXT)
    g = torch.Generator().manual_seed(SEED)
    nw = torch.randn((2, cfg.max_phonemes), generator=g)
    nz = torch.randn((cfg.d_model, cfg.max_frames), generator=g)
    wg, fg = vits.vits_infer(voice.params, cfg, ph, n, nw.to(dev),
                             nz.to(dev))
    wc, fc = vits.vits_infer(cpu.params, cfg, ph.cpu(), n, nw, nz)
    frames_card, frames_cpu = int(fg), int(fc)
    err = (rel_l2(wg.cpu(), wc) if frames_card == frames_cpu
           else float("inf"))
    voice.synthesize(VITS_TEXT)  # warm
    wav, ms = wall_ms(lambda: voice.synthesize(VITS_TEXT))
    seconds = len(wav) / cfg.sample_rate
    out_wav = os.path.join(tmp, "synth.wav")
    rc, text, secs = run_cli(cli, ["synth", "-t", VITS_TEXT, "--voice", onnx,
                                   "--voice-config", conf_path,
                                   "-o", out_wav])
    with wave.open(out_wav, "rb") as f:
        cli_rate, cli_frames = f.getframerate(), f.getnframes()
    out = {"phonemes": n, "frames_card": frames_card,
           "frames_cpu": frames_cpu, "rel_l2_vs_cpu": err, "tol": VITS_TOL,
           "synthesize_ms": ms, "audio_s": seconds,
           "rtf": ms / 1e3 / seconds if seconds else None,
           "cli": {"rc": rc, "seconds": secs, "samples": cli_frames}}
    log(f"  VITS (Piper ONNX at VITSConfig() widths, {n} phonemes): frames "
        f"card {frames_card} cpu {frames_cpu}, injected-noise waveform "
        f"rel_l2 {err:.3e} (tol {VITS_TOL:.0e}); synthesize {ms:.1f} ms "
        f"for {seconds:.2f} s of audio (RTF "
        f"{out['rtf'] if out['rtf'] is not None else float('nan'):.4f}); "
        f"synth CLI exit {rc}, {cli_frames} samples at {cli_rate} Hz in "
        f"{secs:.1f} s")
    if frames_card != frames_cpu:
        raise AssertionError(f"phase 13: VITS frames card {frames_card} cpu "
                             f"{frames_cpu}: a duration boundary flipped")
    if not (torch.isfinite(wg).all() and err <= VITS_TOL):
        raise AssertionError(f"phase 13: VITS rel_l2 {err}")
    if (rc != 0 or cli_rate != cfg.sample_rate or cli_frames == 0
            or cli_frames % cfg.hop):
        raise AssertionError(f"phase 13: synth exited {rc}: {text[-300:]}")
    return out


def phase_voice(dev, llm, cli, counters, profile) -> dict:
    """Phase 13: the voice path (module comment above). None of the port's
    hand-written kernels is on it: every counter must stay at 0."""
    t0 = time.perf_counter()
    for f in counters.values():
        f.launches = 0
    sizes = voice_configs()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_voice_") as tmp:
        out = {"whisper_tiny": phase_whisper(dev, cli, tmp, sizes),
               "silero": phase_silero(dev, tmp),
               "tts": phase_tts(dev, llm, sizes["tts"]),
               "vits": phase_vits(dev, cli, tmp, sizes["vits"])}
    launches = {k: f.launches for k, f in counters.items()}
    expect_routes(launches, (), tuple(launches), "phase 13")
    out["whisper_tiny"]["profile"] = profile()
    out["seconds"] = time.perf_counter() - t0
    log(f"  phase 13 took {out['seconds']:.1f} s")
    return out


def voice_profile(dev) -> dict:
    """Whisper-tiny (random weights from the seed) at each window under the
    profiler: the decode window, VOICE_PROFILE_TOKENS greedy steps from the
    prompt's cache, and the encoder, VOICE_PROFILE_ENCODES calls; each on
    the host clock, then profiled: busy ms and launches a token (a call),
    the idle share 1 - busy / wall, the largest kernels."""
    from trackiellm_tpu_torch.audio import asr as asr_mod
    from trackiellm_tpu_torch.models import whisper
    cfg = whisper.WhisperConfig.tiny()
    params = whisper.init_whisper(
        torch.Generator(device=dev).manual_seed(SEED), cfg)
    signal = voice_signal(VOICE_SECONDS, VOICE_RATE, SEED)
    out = {}
    for ctx in VOICE_WINDOWS:
        c = cfg._replace(n_audio_ctx=ctx)
        asr = asr_mod.WhisperASR(params, c, max_tokens=VOICE_PROFILE_TOKENS)
        asr.transcribe_ids(signal, VOICE_RATE)  # warm
        setup, run = decode_window(whisper, params, c,
                                   asr.mel(signal, VOICE_RATE),
                                   VOICE_PROFILE_TOKENS)
        state = setup()
        _, wall = wall_ms(lambda: run(state))
        state = setup()
        busy, n, by_name = device_breakdown(lambda: run(state))
        top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:5]
        per = VOICE_PROFILE_TOKENS
        out[str(ctx)] = {"wall_ms_per_token": wall / per,
                         "busy_ms_per_token": busy / per,
                         "launches_per_token": n / per,
                         "idle_share": 1.0 - busy / wall,
                         "top": [[k[:60], t / per, m / per]
                                 for k, (t, m) in top]}
        log(f"  profile whisper-tiny decode (n_audio_ctx {ctx}): "
            f"{wall / per:.3f} ms wall, {busy / per:.3f} ms busy, "
            f"{n / per:.1f} launches a token (idle "
            f"{out[str(ctx)]['idle_share']:.3f})")
        mel = asr.mel(signal, VOICE_RATE)

        def encodes():
            for _ in range(VOICE_PROFILE_ENCODES):
                whisper.encode(params, c, mel)
        _, wall = wall_ms(encodes)
        busy, n, by_name = device_breakdown(encodes)
        top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:5]
        per = VOICE_PROFILE_ENCODES
        enc = {"wall_ms": wall / per, "busy_ms": busy / per,
               "launches": n / per, "idle_share": 1.0 - busy / wall,
               "top": [[k[:60], t / per, m / per] for k, (t, m) in top]}
        out[str(ctx)]["encode"] = enc
        log(f"  profile whisper-tiny encode (n_audio_ctx {ctx}): "
            f"{enc['wall_ms']:.3f} ms wall, {enc['busy_ms']:.3f} ms busy, "
            f"{enc['launches']:.1f} launches a call (idle "
            f"{enc['idle_share']:.3f})")
    return out


def voice_profile_child() -> dict:
    """``voice_profile`` in a process of its own (this script with
    VOICE_PROFILE_FLAG), as phase 12 profiles: late in the smoke's process
    the profiler has lost kernel records. The child's log lines are passed
    on; its last line is the result."""
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), VOICE_PROFILE_FLAG],
        capture_output=True, text=True, timeout=SERVE_TIMEOUT)
    lines = proc.stdout.strip().splitlines()
    if proc.returncode != 0 or not lines:
        raise AssertionError(f"phase 13: the profile's process exited "
                             f"{proc.returncode}: {proc.stderr[-2000:]}")
    for line in lines[:-1]:
        log(line)
    return json.loads(lines[-1])


# Phase 14: the vision path. YOLOv8n and YOLOv5nu at 640, MiDaS v2.1-small at
# the pipeline's 384, DPT-SwinV2 tiny_256 and the CRNN OCR at their published
# widths (random weights from the seed) behind VisionPipeline on a seeded
# 480x640 floor-and-obstacle frame; the card against the port's own CPU run
# where a tolerance is named.
# Timed frames of each pipeline (p50) and timed calls of each stage: cut
# from 20 and 10 to 5 and 3 to bring phases 1-17 under their 600-s budget
# (phase 14 took 38.3 s at 20 and 10, 26.7-48.4 s at 10 and 5 in later
# calls; on an H100 80GB HBM3 at 700 W); then 3 frames to pay for phase 21
# (48.5 s at 5, 33.4-38.3 s at 3).
VISION_FRAMES = 3
VISION_WARM = 1               # frames before them (3 before the budget)
VISION_STAGE_ITERS = 3
VISION_DET_TOL = 1e-5         # rel L2, raw boxes and class probabilities
VISION_MIDAS_TOL = 1e-5       # rel L2, relative inverse depth
VISION_DPT_TOL = 1e-4         # rel L2, relative inverse depth
VISION_OCR_TOL = 1e-5         # max abs, logits
VISION_BITS = ("DETECTION", "DEPTH", "OCR", "ATTRIBUTES", "SCENE_GRAPH",
               "NAVIGATION")
VISION_PROFILE_FRAMES = 5     # frames of each profiled window
VISION_PROFILE_FLAG = "--vision-profile"


def vision_configs() -> dict:
    """Phase 14's configurations: the two detectors, MiDaS-small at the
    pipeline's input, DPT-SwinV2 tiny_256, the CRNN and the frame."""
    from trackiellm_tpu_torch.models import depth, detector, dpt, ocr
    return {"v8n": detector.DetectorConfig.v8n(),
            "v5nu": detector.DetectorConfig.v5nu(),
            "midas": depth.DepthConfig.small()._replace(img_size=384),
            "dpt": dpt.DPTSwinConfig.tiny_256(),
            "ocr": ocr.OCRConfig(), "frame": (480, 640)}


def vision_frame(hw, seed: int) -> np.ndarray:
    """A synthetic camera frame from the seed: a wall above the horizon and
    a floor brightening toward the camera (a depth-friendly gradient),
    three blocks standing on the floor, a sign of dark strokes on a light
    board, and sensor noise."""
    rng = np.random.default_rng(seed)
    h, w = hw
    y = np.arange(h, dtype=np.float32)[:, None]
    x = np.arange(w, dtype=np.float32)[None, :]
    horizon = int(h * 0.4)
    wall = 150 + 30 * np.sin(x / (w / 7.0)) + 0 * y
    floor = 60 + 150 * (y - horizon) / (h - horizon) + 0 * x
    gray = np.where(y < horizon, wall, floor)
    frame = gray[..., None] * np.asarray([1.0, 0.95, 0.85], np.float32)
    for (x0, x1, y0, y1), rgb in (((0.40, 0.58, 0.45, 0.80), (200, 40, 35)),
                                  ((0.08, 0.22, 0.30, 0.95), (40, 60, 170)),
                                  ((0.72, 0.90, 0.55, 0.70), (90, 160, 70))):
        frame[int(y0 * h):int(y1 * h), int(x0 * w):int(x1 * w)] = rgb
    sy, sx = int(0.08 * h), int(0.62 * w)
    frame[sy:sy + h // 8, sx:sx + w // 4] = 235
    for k in range(6):  # glyph strokes
        c = sx + 8 + k * (w // 4 - 16) // 6
        frame[sy + 6:sy + h // 8 - 6, c:c + 4] = 20
    frame += rng.normal(0.0, 3.0, frame.shape)
    return np.clip(frame, 0, 255).astype(np.uint8)


def p50_ms(fn, iters: int = VISION_STAGE_ITERS, warm: int = 1) -> float:
    """Median host ms of ``fn`` between two card synchronizations."""
    for _ in range(warm):
        fn()
    return float(np.median([wall_ms(fn)[1] for _ in range(iters)]))


def vision_models(dev, sizes: dict) -> dict:
    """Every phase-14 model's random params from the seed on the card, and
    a CPU copy of each."""
    from trackiellm_tpu_torch.models import depth, detector, dpt, llm, ocr
    inits = {"v8n": detector.init_detector, "v5nu": detector.init_detector,
             "midas": depth.init_depth, "dpt": dpt.init_dpt,
             "ocr": ocr.init_ocr}
    out = {}
    for k, (name, init) in enumerate(inits.items()):
        p = init(torch.Generator(device=dev).manual_seed(SEED + 140 + k),
                 sizes[name])
        out[name] = (p, llm.params_to(p, torch.device("cpu")))
    return out


def vision_fns(params: dict, sizes: dict, depth_kind: str):
    """The pipeline's backends over one side's params: the v8n detector,
    the depth model of ``depth_kind`` and the OCR (crops to strings)."""
    from trackiellm_tpu_torch.models import depth, detector, dpt, ocr
    det = lambda chw: detector.detector_forward(  # noqa: E731
        params["v8n"], sizes["v8n"], chw)
    if depth_kind == "dpt":
        dep = lambda chw: dpt.dpt_forward(  # noqa: E731
            params["dpt"], sizes["dpt"], chw)
    else:
        dep = lambda chw: depth.depth_forward(  # noqa: E731
            params["midas"], sizes["midas"], chw)
    dev = params["ocr"]["out_w"].device

    def read(crops):
        return ocr.ctc_greedy_decode(ocr.ocr_forward(
            params["ocr"], sizes["ocr"], torch.from_numpy(crops).to(dev)))
    return det, dep, read


def vision_pipeline(dev, params: dict, sizes: dict, depth_kind: str,
                    seed: int = 0, barcode_fn=None):
    """VisionPipeline with the v8n detector, MiDaS or DPT, the OCR, a
    NavigationEngine and ``barcode_fn``, on ``dev``."""
    from trackiellm_tpu_torch.navigation import NavigationEngine
    from trackiellm_tpu_torch.vision import VisionConfig, VisionPipeline
    det, dep, read = vision_fns(params, sizes, depth_kind)
    conf = (VisionConfig(depth_preproc="dpt",
                         depth_input=sizes["dpt"].image_size)
            if depth_kind == "dpt" else
            VisionConfig(depth_input=sizes["midas"].img_size))
    conf.detector_input = sizes["v8n"].img_size
    return VisionPipeline(det, dep, read, config=conf,
                          barcode_fn=barcode_fn,
                          navigation_engine=NavigationEngine(seed=seed,
                                                             device=dev),
                          device=dev)


def check_valid(res, tag: str) -> list:
    """The requested analyses a frame's ``valid_analyses`` must hold: a
    stage that degraded on the card fails the phase."""
    from trackiellm_tpu_torch.vision import AnalysisFlags
    missing = [b for b in VISION_BITS
               if not res.valid_analyses & AnalysisFlags[b]]
    if missing:
        raise AssertionError(f"phase 14: {tag}: the frame lacks "
                             f"{missing} of valid_analyses")
    return [b for b in VISION_BITS]


def objects_agree(a, b, px: float = 0.5) -> int:
    """Objects of ``a`` that ``b`` also has: the same class, each box
    corner within ``px`` (in any order: random weights put many scores
    within an ulp of each other, and a swap in the score order moves every
    later object)."""
    left = list(b)
    hits = 0
    for x in a:
        for y in left:
            if x.class_id == y.class_id and max(
                    abs(u - v) for u, v in zip(x.box, y.box)) <= px:
                left.remove(y)
                hits += 1
                break
    return hits


def vision_detectors(dev, models, sizes, frame) -> dict:
    """Each detector's raw outputs, card against CPU on the CPU's
    letterbox; decode_and_nms on the card given the CPU's raw outputs
    against the CPU's, bit for bit; the detect stage's time."""
    from trackiellm_tpu_torch.models import detector
    from trackiellm_tpu_torch.ops import nms, preprocess
    out = {}
    size = sizes["v8n"].img_size
    chw, _ = preprocess.letterbox_preprocess(torch.from_numpy(frame), size,
                                             size)
    for name in ("v8n", "v5nu"):
        card, cpu = models[name]
        cfg = sizes[name]
        bg, pg = detector.detector_forward(card, cfg, chw.to(dev))
        bc, pc = detector.detector_forward(cpu, cfg, chw)
        errs = {"boxes": rel_l2(bg.cpu(), bc), "probs": rel_l2(pg.cpu(), pc)}
        dc = nms.decode_and_nms(bc, pc, max_out=20)
        dg = nms.decode_and_nms(bc.to(dev), pc.to(dev), max_out=20)
        same = all(torch.equal(g.cpu(), c) for g, c in zip(dg, dc))
        fdev = torch.from_numpy(frame).to(dev)

        def detect(card=card, cfg=cfg):
            x, m = preprocess.letterbox_preprocess(fdev, size, size)
            d = nms.decode_and_nms(*detector.detector_forward(card, cfg, x),
                                   max_out=20)
            return nms.boxes_to_original(d.boxes, m)
        out[name] = {"raw_rel_l2": errs, "tol": VISION_DET_TOL,
                     "nms_bit_equal": same,
                     "detections": int(dc.valid.sum()),
                     "detect_ms": p50_ms(detect)}
        log(f"  {name} at {size}: raw boxes rel_l2 {errs['boxes']:.3e}, probs "
            f"{errs['probs']:.3e} (tol {VISION_DET_TOL:.0e}); decode_and_nms "
            f"on the card given the CPU's raw outputs "
            + ("bit-equal" if same else "DIFFERS")
            + f" ({out[name]['detections']} detections); letterbox + "
            f"detector + NMS {out[name]['detect_ms']:.3f} ms")
        if not (max(errs.values()) <= VISION_DET_TOL and same
                and torch.isfinite(bg).all() and torch.isfinite(pg).all()):
            raise AssertionError(f"phase 14: {name}: {errs}, nms equal "
                                 f"{same}")
        if name == "v8n":
            raw = (bg, pg)
    return out, raw


def sweep_candidates(boxes, probs):
    """What ``decode_and_nms`` hands its sweep at the default thresholds
    (class-agnostic): who knocks out whom among the top 256."""
    from trackiellm_tpu_torch.ops import nms
    best = probs.max(-1).values
    top, idx = nms.top_k_first_index(torch.where(best >= 0.5, best, 0.0),
                                     min(256, boxes.shape[0]))
    iou = nms.pairwise_iou(boxes[idx], boxes[idx])
    order = torch.arange(len(idx), device=boxes.device)
    return (order[None] > order[:, None]) & (iou > 0.45) & (top > 0)[:, None]


def vision_nms(boxes, probs) -> dict:
    """decode_and_nms alone on the card, and its K-step sweep alone."""
    from trackiellm_tpu_torch.ops import nms
    cand = sweep_candidates(boxes, probs)
    out = {"decode_and_nms_ms": p50_ms(
               lambda: nms.decode_and_nms(boxes, probs, max_out=20)),
           "sweep_ms": p50_ms(lambda: nms.greedy_sweep(cand)),
           "sweep_steps": cand.shape[0]}
    log(f"  NMS on the card: decode_and_nms {out['decode_and_nms_ms']:.3f} "
        f"ms, its {cand.shape[0]}-step sweep alone {out['sweep_ms']:.3f} ms")
    return out


def vision_depths(dev, models, sizes, frame) -> dict:
    """MiDaS and DPT maps, card against CPU on the CPU's normalized input;
    the depth + fusion stage's time."""
    from trackiellm_tpu_torch.models import depth, dpt
    from trackiellm_tpu_torch.ops import preprocess
    from trackiellm_tpu_torch.vision import object_analysis as oa
    out = {}
    f = torch.from_numpy(frame)
    fdev = f.to(dev)
    boxes = torch.tensor([[100.0, 150.0, 300.0, 400.0]] * 20, device=dev)
    ok = torch.ones((20,), dtype=torch.bool, device=dev)
    for name, norm, fwd, tol in (
            ("midas", preprocess.imagenet_normalize_chw, depth.depth_forward,
             VISION_MIDAS_TOL),
            ("dpt", preprocess.dpt_normalize_chw, dpt.dpt_forward,
             VISION_DPT_TOL)):
        card, cpu = models[name]
        cfg = sizes[name]
        s = cfg.img_size if name == "midas" else cfg.image_size
        x = norm(f, s, s)
        got = fwd(card, cfg, x.to(dev))
        ref = fwd(cpu, cfg, x)
        err = rel_l2(got.cpu(), ref)

        def stage(card=card, cfg=cfg, norm=norm, fwd=fwd, s=s):
            m = depth.relative_to_metric(fwd(card, cfg, norm(fdev, s, s)))
            return oa.fuse_boxes_with_depth(boxes, ok, m)
        out[name] = {"rel_l2": err, "tol": tol, "size": s,
                     "depth_fusion_ms": p50_ms(stage)}
        log(f"  {name} at {s}: relative depth rel_l2 {err:.3e} (tol "
            f"{tol:.0e}); normalize + depth + metric + fusion "
            f"{out[name]['depth_fusion_ms']:.3f} ms")
        if not (torch.isfinite(got).all() and err <= tol):
            raise AssertionError(f"phase 14: {name} rel_l2 {err}")
    return out


def vision_ocr(dev, models, sizes, frame) -> dict:
    """The CRNN on the page grid's crops of the frame: logits card against
    CPU, the decoded strings equal; the OCR stage's time."""
    from trackiellm_tpu_torch.models import ocr
    from trackiellm_tpu_torch.vision.pipeline import _host_resize_gray
    gray = frame.astype(np.float32).mean(-1) / 255.0
    h, w = gray.shape
    crops = np.stack([_host_resize_gray(gray[r * h // 4:(r + 1) * h // 4,
                                             c * w // 2:(c + 1) * w // 2],
                                        32, 128)
                      for r in range(4) for c in range(2)])
    card, cpu = models["ocr"]
    cfg = sizes["ocr"]
    lg = ocr.ocr_forward(card, cfg, torch.from_numpy(crops).to(dev))
    lc = ocr.ocr_forward(cpu, cfg, torch.from_numpy(crops))
    err = (lg.cpu() - lc).abs().max().item()
    sg, sc = ocr.ctc_greedy_decode(lg), ocr.ctc_greedy_decode(lc)
    ms = p50_ms(lambda: ocr.ctc_greedy_decode(ocr.ocr_forward(
        card, cfg, torch.from_numpy(crops).to(dev))))
    out = {"crops": len(crops), "max_abs_err": err, "tol": VISION_OCR_TOL,
           "strings_equal": sg == sc, "chars": sum(map(len, sg)),
           "ocr_ms": ms}
    log(f"  OCR (CRNN, {len(crops)} page crops): logits max abs {err:.3e} "
        f"(tol {VISION_OCR_TOL:.0e}), strings "
        + ("equal" if sg == sc else "DIFFER") + f"; crops to strings {ms:.3f}"
        " ms")
    if not (torch.isfinite(lg).all() and err <= VISION_OCR_TOL
            and sg == sc):
        raise AssertionError(f"phase 14: OCR max abs {err}, strings "
                             f"{sg[:2]} / {sc[:2]}")
    return out


def vision_navigation(dev, depth_m: np.ndarray) -> dict:
    """The navigation engine on the card and the CPU given one metric depth
    map and the same RANSAC indices: the grids must be equal."""
    from trackiellm_tpu_torch.navigation import NavigationEngine
    from trackiellm_tpu_torch.navigation.path_planner import (
        draw_ransac_indices)
    idx = draw_ransac_indices(torch.Generator().manual_seed(SEED),
                              depth_m.size)
    card = NavigationEngine(device=dev)
    cpu = NavigationEngine(device="cpu")
    gg = card.update(depth_m, indices=idx)
    gc = cpu.update(depth_m, indices=idx)
    same = bool(np.array_equal(gg, gc))
    ms = p50_ms(lambda: (card.update(depth_m), card.current_hazards()))
    out = {"grid_equal": same, "cells": np.bincount(
               gc.ravel(), minlength=6).tolist(),
           "inlier_frac": cpu.inlier_frac, "cues": cpu.current_hazards(),
           "navigation_ms": ms}
    log(f"  navigation ({depth_m.shape[0]}x{depth_m.shape[1]} depth, same "
        f"RANSAC indices): grid card "
        + ("equal to" if same else "DIFFERS from")
        + f" cpu, cells by class {out['cells']}, cues {out['cues']}; update "
        f"+ hazards {ms:.3f} ms")
    if not same:
        raise AssertionError("phase 14: the navigation grids differ")
    return out


def with_qr(frame: np.ndarray, text: str = "SAIDA 2") -> np.ndarray:
    """``frame`` with a QR code of ``text`` on the wall, top left."""
    from trackiellm_tpu_torch.vision import qr_decode
    code = qr_decode.render_qr(qr_decode.encode_qr(text, version=1),
                               module_px=max(1, min(frame.shape[:2]) // 116))
    out = frame.copy()
    out[16:16 + code.shape[0], 16:16 + code.shape[1]] = code[..., None]
    return out


def frame_summary(res) -> dict:
    """What a frame's result says: its valid bits, objects (boxes, scores,
    distances, attributes, texts), text regions, barcodes and cues."""
    import dataclasses
    return {"valid": int(res.valid_analyses),
            "objects": [dataclasses.asdict(o) for o in res.objects],
            "text_regions": [dataclasses.asdict(t) for t in res.text_regions],
            "full_text": res.full_text, "barcodes": list(res.barcodes),
            "cues": list(res.navigation_cues)}


def vision_tensor_frame(dev, models, sizes, frame) -> dict:
    """process_frame (AnalysisFlags.ALL, MiDaS, the QR detector) on the
    frame as numpy and as a tensor already on ``dev``, each through a fresh
    pipeline: the results must be equal (the camera worker hands the
    pipeline card tensors; the OCR stage once dropped them)."""
    from trackiellm_tpu_torch.vision import AnalysisFlags
    from trackiellm_tpu_torch.vision.qr import QRFinderDetector
    cards = {k: v[0] for k, v in models.items()}
    frame = with_qr(frame)
    got = {}
    for kind, f in (("numpy", frame),
                    ("tensor", torch.from_numpy(frame).to(dev))):
        pipe = vision_pipeline(dev, cards, sizes, "midas",
                               barcode_fn=QRFinderDetector())
        res = pipe.process_frame(f, AnalysisFlags.ALL)
        bits = check_valid(res, f"a {kind} frame")
        got[kind] = frame_summary(res)
    a, b = got["numpy"], got["tensor"]
    log(f"  process_frame ALL on a {dev.type} tensor frame against numpy: "
        f"valid {a['valid']} and {b['valid']}, {len(b['objects'])} objects, "
        f"{len(b['text_regions'])} text regions, barcodes {b['barcodes']}")
    if a != b:
        differ = sorted(k for k in a if a[k] != b[k])
        raise AssertionError(f"phase 14: a tensor frame's result differs "
                             f"from the numpy frame's in {differ}")
    return {"equal": True, "valid": bits,
            "objects": len(b["objects"]),
            "text_regions": len(b["text_regions"]),
            "barcodes": b["barcodes"]}


def vision_pipelines(dev, models, sizes, frames) -> tuple:
    """process_frame with AnalysisFlags.ALL, with MiDaS and with DPT: every
    bit must be valid; the card's objects against the CPU's; the frame's
    wall p50. Returns (results, the CPU's MiDaS metric depth map)."""
    from trackiellm_tpu_torch.vision import AnalysisFlags
    out, depth_m = {}, None
    cards = {k: v[0] for k, v in models.items()}
    cpus = {k: v[1] for k, v in models.items()}
    for kind in ("midas", "dpt"):
        card = vision_pipeline(dev, cards, sizes, kind)
        cpu = vision_pipeline(torch.device("cpu"), cpus, sizes, kind)
        rg = card.process_frame(frames[0], AnalysisFlags.ALL)
        rc = cpu.process_frame(frames[0], AnalysisFlags.ALL)
        bits = check_valid(rg, f"{kind} on the card")
        check_valid(rc, f"{kind} on the CPU")
        if kind == "midas":
            depth_m = rc.depth_map_m
        for f in frames[1:1 + VISION_WARM]:
            card.process_frame(f, AnalysisFlags.ALL)
        walls = []
        for f in frames[1 + VISION_WARM:]:
            res, ms = wall_ms(lambda f=f: card.process_frame(
                f, AnalysisFlags.ALL))
            check_valid(res, f"{kind} on the card")
            walls.append(ms)
        stages = res.timings_ms
        agree = objects_agree(rg.objects, rc.objects)
        out[kind] = {
            "valid": bits, "objects": len(rg.objects),
            "cpu_objects": len(rc.objects), "objects_agree": agree,
            "edges": len(rg.scene_graph["edges"]),
            "text_regions": len(rg.text_regions),
            "cues": rg.navigation_cues,
            "depth_rel_l2_vs_cpu": rel_l2(torch.from_numpy(rg.depth_map_m),
                                          torch.from_numpy(rc.depth_map_m)),
            "frames": len(walls), "frame_ms_p50": float(np.median(walls)),
            "frame_ms_min": float(np.min(walls)),
            "timings_ms_last_frame": stages}
        log(f"  process_frame ALL with {kind} ({frames[0].shape[0]}x"
            f"{frames[0].shape[1]} frame): valid {'|'.join(bits)}; "
            f"{len(rg.objects)} objects ({agree} agree with the CPU's "
            f"{len(rc.objects)}), {out[kind]['edges']} edges, "
            f"{out[kind]['text_regions']} text regions, cues "
            f"{rg.navigation_cues}; frame wall p50 "
            f"{out[kind]['frame_ms_p50']:.2f} ms over {len(walls)} frames")
    return out, depth_m


def phase_vision(dev, counters, profile) -> dict:
    """Phase 14: the vision path (module comment above). None of the port's
    hand-written kernels is on it: every counter must stay at 0."""
    t0 = time.perf_counter()
    for f in counters.values():
        f.launches = 0
    sizes = vision_configs()
    frames = [vision_frame(sizes["frame"], SEED + i)
              for i in range(1 + VISION_WARM + VISION_FRAMES)]
    models = vision_models(dev, sizes)
    out = {"frame": list(sizes["frame"]),
           "models": {"v8n": sizes["v8n"].img_size,
                      "v5nu": sizes["v5nu"].img_size,
                      "midas": sizes["midas"].img_size,
                      "dpt": sizes["dpt"].image_size, "ocr": [32, 128]}}
    out["detector"], raw = vision_detectors(dev, models, sizes, frames[0])
    out["nms"] = vision_nms(*raw)
    out["depth"] = vision_depths(dev, models, sizes, frames[0])
    out["ocr"] = vision_ocr(dev, models, sizes, frames[0])
    out["pipeline"], depth_m = vision_pipelines(dev, models, sizes, frames)
    out["tensor_frame"] = vision_tensor_frame(dev, models, sizes, frames[0])
    out["navigation"] = vision_navigation(dev, depth_m)
    launches = {k: f.launches for k, f in counters.items()}
    expect_routes(launches, (), tuple(launches), "phase 14")
    out["launches"] = launches
    out["profile"] = profile()
    out["seconds"] = time.perf_counter() - t0
    log(f"  phase 14 took {out['seconds']:.1f} s")
    return out


def vision_profile(dev) -> dict:
    """process_frame (AnalysisFlags.ALL) with MiDaS and with DPT under the
    profiler, VISION_PROFILE_FRAMES frames each after a warm-up, and the
    NMS sweep alone: on the host clock, then profiled: busy ms and launches
    a frame (a sweep), the idle share 1 - busy / wall, the largest
    kernels."""
    from trackiellm_tpu_torch.models import detector
    from trackiellm_tpu_torch.ops import nms
    from trackiellm_tpu_torch.vision import AnalysisFlags
    sizes = vision_configs()
    frames = [vision_frame(sizes["frame"], SEED + 100 + i)
              for i in range(2 + 2 * VISION_PROFILE_FRAMES)]
    models = {k: v[0] for k, v in vision_models(dev, sizes).items()}
    out = {}
    for kind in ("midas", "dpt"):
        pipe = vision_pipeline(dev, models, sizes, kind)
        for f in frames[:2]:
            pipe.process_frame(f, AnalysisFlags.ALL)
        n = VISION_PROFILE_FRAMES

        def run(part):
            for f in frames[2 + part * n:2 + (part + 1) * n]:
                pipe.process_frame(f, AnalysisFlags.ALL)
        _, wall = wall_ms(lambda: run(0))
        busy, launches, by_name = device_breakdown(lambda: run(1))
        top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:5]
        out[kind] = {"wall_ms_per_frame": wall / n,
                     "busy_ms_per_frame": busy / n,
                     "launches_per_frame": launches / n,
                     "idle_share": 1.0 - busy / wall,
                     "top": [[k[:60], t / n, c / n] for k, (t, c) in top]}
        log(f"  profile process_frame ALL with {kind}: "
            f"{wall / n:.2f} ms wall, {busy / n:.2f} ms busy, "
            f"{launches / n:.0f} launches a frame (idle "
            f"{out[kind]['idle_share']:.3f})")
    size = sizes["v8n"].img_size
    chw = torch.rand((3, size, size), generator=torch.Generator(
        device=dev).manual_seed(SEED), device=dev)
    cand = sweep_candidates(*detector.detector_forward(models["v8n"],
                                                       sizes["v8n"], chw))
    nms.greedy_sweep(cand)
    _, wall = wall_ms(lambda: nms.greedy_sweep(cand))
    busy, launches, _ = device_breakdown(lambda: nms.greedy_sweep(cand))
    out["nms_sweep"] = {"steps": cand.shape[0], "wall_ms": wall,
                        "busy_ms": busy, "launches": launches,
                        "idle_share": 1.0 - busy / wall}
    log(f"  profile NMS sweep ({cand.shape[0]} steps): {wall:.3f} ms wall, "
        f"{busy:.3f} ms busy, {launches} launches")
    return out


def vision_profile_child() -> dict:
    """``vision_profile`` in a process of its own (this script with
    VISION_PROFILE_FLAG), as phases 12 and 13 profile. The child's log
    lines are passed on; its last line is the result."""
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), VISION_PROFILE_FLAG],
        capture_output=True, text=True, timeout=SERVE_TIMEOUT)
    lines = proc.stdout.strip().splitlines()
    if proc.returncode != 0 or not lines:
        raise AssertionError(f"phase 14: the profile's process exited "
                             f"{proc.returncode}: {proc.stderr[-2000:]}")
    for line in lines[:-1]:
        log(line)
    return json.loads(lines[-1])


APP_DEMO_SECONDS = 4          # the demo's run
# Measured app runs after the warm one: cut from 3 to 2 to bring phases
# 1-17 under their 600-s budget (phase 15 took 40.4 s at 3, 28.5 s at 2
# in a later call; on an H100 80GB HBM3 at 700 W), then to 1 to pay for
# phase 21 (41.6 s at 2, 29.6-30.7 s at 1).
APP_RUNS = 1
APP_REPLY_PRIORITY = 1        # TTSPriority.NORMAL: the LLM reply's speech
APP_TIMEOUT = 900.0           # the measuring child's limit, seconds
WAKE_WINDOWS = 16             # scored windows, keyword-like and not
WAKE_TOL = 1e-5               # max abs, card against CPU scores
WAKE_RATE = 16_000
WAKE_WINDOW = 76 * 160 + 240  # NeuralWakeWord's ring size


def wake_tone_pair(rng, f1: float, f2: float, amp: float = 0.1):
    """A two-tone 'phrase': f1 then f2, jittered phase and noise."""
    t = np.arange(WAKE_WINDOW // 2) / WAKE_RATE
    a = amp * np.sin(2 * np.pi * f1 * t + rng.uniform(0, 6.28))
    b = amp * np.sin(2 * np.pi * f2 * t + rng.uniform(0, 6.28))
    x = np.concatenate([a, b])[:WAKE_WINDOW]
    return (x + 0.02 * rng.standard_normal(WAKE_WINDOW)).astype(np.float32)


def wake_windows(seed: int) -> list:
    """WAKE_WINDOWS windows from the seed, alternately the keyword's
    600 -> 1100 Hz phrase and an imposter: the reversed phrase, one mid
    tone, a noise burst of the same loudness, near silence."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(WAKE_WINDOWS // 2):
        out.append(("keyword", wake_tone_pair(rng, 600.0, 1100.0)))
        kind = i % 4
        if kind == 0:
            clip = wake_tone_pair(rng, 1100.0, 600.0)
        elif kind == 1:
            clip = wake_tone_pair(rng, 850.0, 850.0)
        elif kind == 2:
            clip = (0.1 * rng.standard_normal(WAKE_WINDOW)).astype(np.float32)
        else:
            clip = (0.001 * rng.standard_normal(WAKE_WINDOW)).astype(
                np.float32)
        out.append(("imposter", clip))
    return out


def app_wake_word(dev) -> dict:
    """The bundled trained wake word on the card and on the CPU, each
    scoring the same windows through its own log-mel: scores within
    WAKE_TOL, decisions equal; then the streaming detector chunk by
    chunk on both sides."""
    from trackiellm_tpu_torch.audio import wake_word as ww
    from trackiellm_tpu_torch.ops.mel import log_mel_spectrogram
    card = ww.load_default_wake_word(device=dev)
    cpu = ww.load_default_wake_word(device="cpu")
    cfg = card.cfg
    rows = []
    for kind, clip in wake_windows(SEED):
        scores = []
        for det in (card, cpu):
            mel = log_mel_spectrogram(torch.from_numpy(clip).to(det.device),
                                      n_mels=cfg.n_mels)
            scores.append(float(ww.wake_word_score(
                det.params, cfg, mel[:, -cfg.n_frames:])))
        rows.append((kind, *scores))
    err = max(abs(a - b) for _, a, b in rows)
    same = all((a >= cfg.sensitivity) == (b >= cfg.sensitivity)
               for _, a, b in rows)
    stream = np.concatenate([clip for _, clip in wake_windows(SEED + 1)])
    chunk = WAKE_RATE // 10
    fired = [[det(stream[i:i + chunk]) for i in range(
        0, len(stream) - chunk + 1, chunk)] for det in (card, cpu)]
    hits = {k: sum(a >= cfg.sensitivity for kk, a, _ in rows if kk == k)
            for k in ("keyword", "imposter")}
    log(f"  wake word (bundled artifact, {len(rows)} windows): card against "
        f"CPU max abs {err:.3g} (tolerance {WAKE_TOL:g}), decisions "
        f"{'equal' if same else 'differ'}; accepted {hits['keyword']} of "
        f"{len(rows) // 2} keywords, {hits['imposter']} of {len(rows) // 2} "
        f"imposters; streaming: {sum(fired[0])} firings in {len(fired[0])} "
        f"chunks, {'as' if fired[0] == fired[1] else 'not as'} on the CPU")
    if err > WAKE_TOL or not same or fired[0] != fired[1]:
        raise AssertionError(f"phase 15: wake word card against CPU: max abs "
                             f"{err}, decisions equal {same}, streaming "
                             f"equal {fired[0] == fired[1]}")
    return {"windows": len(rows), "max_abs_err": err, "tol": WAKE_TOL,
            "decisions_equal": same, "accepted": hits,
            "stream_chunks": len(fired[0]), "stream_firings": sum(fired[0])}


def app_demo(dev, cli, counters) -> dict:
    """``python -m trackiellm_tpu_torch demo`` in-process on the card: exit
    0 (the demo exits 1 on any failure the app absorbed: a model call that
    raised, a vision job among them, or a vision stage that degraded a
    frame), at least one VISION job, an LLM turn in the printed cortex
    stats, and the reply spoken at its own priority (NORMAL or below, as
    measure_app_e2e reads it; the safety alerts speak above it). The
    counters are zeroed before and read after (the demo's tiny f32 model
    may launch none)."""
    import ast
    for fn in counters.values():
        fn.launches = 0
    argv = ["demo", str(APP_DEMO_SECONDS)]
    if dev.type != "cuda":  # the card is the demo's default
        argv += ["--device", str(dev)]
    rc, text, secs = run_cli(cli, argv)
    launches = {k: fn.launches for k, fn in counters.items()}

    def printed(label):
        return next((ast.literal_eval(line.split(":", 1)[1].strip())
                     for line in text.splitlines()
                     if line.startswith(f"{label}:")), {})
    stats, cortex = printed("scheduler stats"), printed("cortex stats")
    spoken = [int(line.rsplit(" ", 1)[1]) for line in text.splitlines()
              if line.startswith("[tts]")]
    replies = sum(p <= APP_REPLY_PRIORITY for p in spoken)
    vision = int(stats.get("vision", {}).get("count", 0))
    llm_ms = float(cortex.get("last_llm_ms", 0.0))
    log(f"  demo {APP_DEMO_SECONDS}: exit {rc} in {secs:.1f} s; scheduler "
        f"jobs { {k: int(v['count']) for k, v in stats.items()} }; LLM turn "
        f"{llm_ms:.1f} ms; {len(spoken)} spoken lines, {replies} at the "
        f"reply's priority; counters that rose: "
        f"{ {k: n for k, n in launches.items() if n} }")
    if rc != 0 or vision < 1 or llm_ms <= 0 or not replies:
        raise AssertionError(f"phase 15: demo exit {rc}, {vision} vision "
                             f"jobs, LLM turn {llm_ms} ms, {replies} spoken "
                             f"replies:\n{text}")
    return {"exit": rc, "seconds": secs, "scheduler": stats,
            "last_llm_ms": llm_ms, "spoken": len(spoken), "replies": replies,
            "launches": launches}


def app_e2e_child() -> dict:
    """The port's ``tools/measure_app_e2e`` (full widths, APP_RUNS measured
    runs after a warm one, seed SEED) in a process of its own, as phases
    12-14 profile (late in this process the host loop runs slower). Its
    runs' lines are passed on; its last line is the result."""
    proc = subprocess.run(
        [sys.executable, "-m", "trackiellm_tpu_torch.tools.measure_app_e2e",
         "--runs", str(APP_RUNS), "--seed", str(SEED)],
        capture_output=True, text=True, timeout=APP_TIMEOUT,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    lines = proc.stdout.strip().splitlines()
    for line in proc.stderr.splitlines():
        if line.startswith(("run ", "building", "warming")):
            log(f"  [measure_app_e2e] {line}")
    if proc.returncode != 0 or not lines:
        raise AssertionError(f"phase 15: measure_app_e2e exited "
                             f"{proc.returncode}: {proc.stdout[-2000:]}"
                             f"{proc.stderr[-4000:]}")
    return json.loads(lines[-1])


def phase_app(dev, cli, counters, e2e) -> dict:
    """Phase 15: the app loop (module comment above). The wake word card
    against CPU, the demo, then the product's latency from ``e2e()`` (the
    measuring child): every measured run must reach reply audio, and its
    counters must show W4A8, its quantization and flash, and none of Q8,
    the fused block, the streaming Q4 or the probes."""
    t0 = time.perf_counter()
    out = {"wake_word": app_wake_word(dev),
           "demo": app_demo(dev, cli, counters)}
    res = e2e()
    launches = res.get("launches", {})
    log(f"  measure_app_e2e ({res.get('runs')} runs after a warm one, "
        f"{res.get('incomplete')} incomplete): end of speech to first reply "
        f"audio p50 {res.get('p50_first_reply_audio_ms')} ms, first audio "
        f"{res.get('p50_first_any_audio_ms')} ms, transcript "
        f"{res.get('p50_transcript_ms')} ms; runs {res.get('runs_ms')}; "
        f"{res.get('card')}")
    log(f"  measure_app_e2e launches: {launches}; q4_matmul_f32a "
        f"{'rose' if launches.get('q4_matmul_f32a') else 'stayed at 0'}")
    if res.get("incomplete") or "error" in res or len(
            res.get("runs_ms", ())) != APP_RUNS or res.get("failures"):
        raise AssertionError(f"phase 15: not every app run reached reply "
                             f"audio: {res}")
    expect_routes(launches, ("q4_matmul_w4a8", "quantize_activations",
                             "flash_attention"),
                  ("q8_matmul", "fused_mlp_q4", *DIAGNOSTIC), "phase 15")
    out["e2e"] = res
    out["launches"] = launches
    out["seconds"] = time.perf_counter() - t0
    log(f"  phase 15 took {out['seconds']:.1f} s")
    return out


# Phase 16: the dense families. (a) Gemma-2-9B at its published widths and
# max_seq, and Llama-3.1-8B (Llama-3-8B with the published rope factors)
# cut to max_seq 2048, random Q4 weights from the seed: the cortex prompt
# and FAMILY_TOKENS greedy tokens at lookahead 1 and 4; Gemma-2-9B also
# serves a held burst of SERVE_SLOTS requests on dense slots and on the int8
# paged pool (max_seq cut to FAMILY_SERVE_MAX_SEQ) and is profiled over
# FAMILY_TOKENS decode tokens in a process of its own. (b) Every other dense
# preset at its published widths cut to 2 layers (and max_seq to at most
# FAMILY_SWEEP_MAX_SEQ, which keeps every window that was on), Q4 at the
# largest group dividing every K/2: card against CPU prefill. (c) Tiny GGUFs
# of the arches with no preset, converted and answered from.
# (a)'s greedy, served and profiled tokens: cut from 32 to 16 to bring
# phases 1-17 under their 600-s budget (phase 16 took 90.9 s at 32, 53.1 s
# at 16 in a later call; on an H100 80GB HBM3 at 700 W), then to 8 with
# FAMILY_GGUF_TOKENS 4 to pay for phase 21 (78.9 s at 16 and 8, 71.3-75.3
# s at 8 and 4).
FAMILY_TOKENS = 8
FAMILY_SERVE_MAX_SEQ = 2048
FAMILY_LLAMA_MAX_SEQ = 2048
# (a)'s depths: Gemma-2-9B's 42 and Llama-3.1-8B's 32 layers cut to 8
# since phase 17 joined (the smoke's 1,000-s aim; see CUT_LAYERS), then to
# 2 (both of Gemma-2's layer kinds stay), and (b)'s sweep from 2 layers to
# FAMILY_SWEEP_LAYERS, to bring phases 1-17 under their 600-s budget
# (phase 16 took 103.0 s at 8 and 2, 53.1 s at 4 and 1 with FAMILY_TOKENS
# 16 in a later call; on an H100 80GB HBM3 at 700 W).
FAMILY_DEPTH = {"gemma2_9b": 2, "llama3_8b": 2}
# (b)'s depth: 1 layer, but 2 for Gemma-2-2B, whose windowed and global
# layers alternate (Gemma-3's pattern of 6 has only windowed layers in the
# first two either way).
FAMILY_SWEEP_LAYERS = {"gemma2_2b": 2}
FAMILY_SWEEP = ("qwen2_7b", "phi3_mini", "granite3_8b", "glm4_9b",
                "gemma2_2b", "gemma3_1b", "gemma3_4b", "gemma3_12b",
                "gemma3_27b", "olmo2_7b", "smollm3_3b", "qwen3_8b")
FAMILY_SWEEP_MAX_SEQ = 8192
FAMILY_BUCKETS = (64, 256)
# One prompt longer than each sliding window: the window masks something.
FAMILY_LONG = {"gemma3_1b": 1024, "phi3_mini": 2560, "gemma2_2b": 4608}
# Phi-3-mini-128k's longrope: the original context 4096 (the 128k variant's
# max_seq 131072 cut as the sweep cuts it), its published attention factor
# sqrt(1 + ln(131072 / 4096) / ln(4096)), and a prefill past the original
# context beside the 2560-token one, so that each factor set runs.
PHI3_ORIGINAL = 4096
PHI3_LONG_SIDE = 4352
# (c): the arches with no preset, at widths the default group takes.
FAMILY_GGUF_ARCHES = ("command-r", "nemotron", "starcoder2")
FAMILY_GGUF_WIDTHS = (512, 2, 4, 2, 1024, 384)  # dim, layers, H, Hk, hid, V
FAMILY_GGUF_TOKENS = 4     # 16, then 8 (above FAMILY_TOKENS)
FAMILY_PROFILE_FLAG = "--families-profile"
FAMILY_PROFILE_TIMEOUT = 600.0


def q4_group(cfg, largest: int = 256) -> int:
    """The largest group from ``largest`` down that divides K/2 of every
    quantized matrix of ``cfg`` (dim, the query width, the hidden width
    and a shared expert's are their K)."""
    group = largest
    ks = (cfg.dim, cfg.n_heads * cfg.head_dim, cfg.hidden_dim,
          cfg.moe_shared_hidden or cfg.dim)
    while any((k // 2) % group or k % group for k in ks):
        group //= 2
    return group


def family_model(dev, llm, cfg, name: str):
    """Random Q4 params of ``cfg`` from the seed on the card (group from
    ``q4_group``), with the rope factors ``name``'s checkpoints carry."""
    t0 = time.perf_counter()
    group = q4_group(cfg)
    params = llm.init_params_quantized(
        torch.Generator(device=dev).manual_seed(SEED), cfg, group=group,
        device=dev)
    if name == "llama3_8b":
        params["rope_factors"] = llm.llama3_rope_factors(cfg, 8.0).to(dev)
    elif name == "gemma3_4b":
        params["rope_factors"] = llm.linear_rope_factors(cfg, 8.0).to(dev)
    elif name == "phi3_mini":
        half = cfg.head_dim // 2
        params["rope_factors_short"] = torch.linspace(1.0, 1.5, half,
                                                      device=dev)
        params["rope_factors_long"] = torch.linspace(1.0, 16.0, half,
                                                     device=dev)
    torch.cuda.synchronize()
    log(f"  {name}: {cfg.n_layers} layers Q4 group {group} in "
        f"{time.perf_counter() - t0:.1f} s, "
        f"{param_bytes(params) / 2 ** 30:.2f} GiB on the card")
    return params


def family_cfg(llm, name: str):
    """Phase 16's config of a dense preset: Gemma-2-9B as published but its
    depth (FAMILY_DEPTH); Llama-3 at FAMILY_DEPTH's layers and max_seq
    FAMILY_LLAMA_MAX_SEQ; a swept preset at FAMILY_SWEEP_LAYERS' depth
    (1, or 2) and max_seq at most
    FAMILY_SWEEP_MAX_SEQ, Phi-3 as its 128k variant (PHI3_ORIGINAL). A
    window at or past max_seq stays off, as it was."""
    cfg = getattr(llm.LLMConfig, name)()
    if name == "gemma2_9b":
        return cfg._replace(n_layers=FAMILY_DEPTH[name])
    if name == "llama3_8b":
        return cfg._replace(n_layers=FAMILY_DEPTH[name],
                            max_seq=FAMILY_LLAMA_MAX_SEQ,
                            sliding_window=FAMILY_LLAMA_MAX_SEQ)
    max_seq = min(cfg.max_seq, FAMILY_SWEEP_MAX_SEQ)
    cfg = cfg._replace(n_layers=FAMILY_SWEEP_LAYERS.get(name, 1),
                       max_seq=max_seq,
                       sliding_window=min(cfg.sliding_window, max_seq))
    if name == "phi3_mini":
        cfg = cfg._replace(
            max_seq=FAMILY_SWEEP_MAX_SEQ, rope_original_max_seq=PHI3_ORIGINAL,
            rope_attention_factor=math.sqrt(1 + math.log(
                131072 / PHI3_ORIGINAL) / math.log(PHI3_ORIGINAL)))
    return cfg


def warm_up(runner, tokens: int) -> None:
    """The short prompt through ``runner``, stopped after about ``tokens``
    tokens: first launches, the allocator and cuBLAS, before a timed
    window."""
    runner.generate(SHORT_PROMPT, should_stop=lambda: len(
        runner.generated_ids) >= tokens)


def family_generate(dev, llm, runner_mod, tokenizer_mod, params, cfg,
                    counters, name: str, tokens: int = FAMILY_TOKENS,
                    phase: str = "phase 16", warm: int = 0) -> dict:
    """(a): the cortex prompt and ``tokens`` greedy tokens behind
    ``LLMRunner`` at lookahead 4, then at 1: equal ids and text, every
    logit finite. Counters are zeroed just before and read just after; the
    warm-up before them generates ``warm`` tokens (``tokens`` by
    default)."""
    tok = tokenizer_mod.ByteTokenizer(cfg.vocab_size)

    def runner(lookahead):
        return runner_mod.LLMRunner(params, cfg, tok, runner_mod.GenerationConfig(
            max_tokens=tokens, temperature=0.0, speculative=False,
            lookahead=lookahead), device=dev)
    r4 = runner(4)
    prompt = r4.build_prompt(SYSTEM, CONTEXT,
                             "What is in front of me right now?")
    warm_up(r4, warm or tokens)
    for fn in counters.values():
        fn.launches = 0
    watch = LogitWatch(llm)
    try:
        out = request(r4, prompt, f"{name} cortex prompt, lookahead 4")
        text4, ids4 = r4._generated_text, r4.generated_ids
        r1 = runner(1)
        text1 = r1.generate(prompt)
        ids1 = r1.generated_ids
    finally:
        out["finite_logit_vectors"] = watch.close()
    out["launches"] = {k: fn.launches for k, fn in counters.items()}
    # The streamed text holds back an unfinished UTF-8 tail that
    # generate() flushes: the ids' decoding is compared with it.
    if ids4 != ids1 or tok.decode(ids4).encode() != text1.encode():
        raise AssertionError(f"{phase} {name}: lookahead 4 and 1 differ "
                             f"({len(text4)} streamed characters)")
    log(f"  {name}: lookahead 4 == lookahead 1 ({len(ids4)} ids); "
        f"launches {out['launches']}")
    expect_routes(out["launches"], ("q4_matmul_w4a8", "quantize_activations",
                                    "flash_attention"),
                  ("q8_matmul", "q4_matmul_f32a", "fused_mlp_q4",
                   *DIAGNOSTIC), f"{phase} {name}")
    return out


def family_serve(dev, llm, tokenizer_mod, server_mod, paging, measure,
                 params, cfg, counters) -> dict:
    """(a): a held burst of SERVE_SLOTS of measure_server's prompts (one
    wave at bucket 64), FAMILY_TOKENS tokens each, on dense 8-step-chunk
    slots and on the int8 paged pool: every request answers, every logit
    is finite, the routes are (a)'s."""
    tok = tokenizer_mod.ByteTokenizer(cfg.vocab_size)
    server = server_factory(server_mod, params, cfg, tok)
    jobs = [(p, dict(max_tokens=FAMILY_TOKENS))
            for p in measure.prompts(SEED)[:SERVE_SLOTS]]
    out = {}
    for label, kw in (("dense_chunk8", dict(chunk_steps=8)), SERVE_INT8):
        for fn in counters.values():
            fn.launches = 0
        watch = LogitWatch(llm, paging)
        s, w = server(**kw)
        try:
            burst(s, [(f"{p} (warm)", k) for p, k in jobs], w)
            t0 = time.perf_counter()
            burst(s, jobs, w)
            wall = time.perf_counter() - t0
            tokens = sum(len(w.ids[p]) for p, _ in jobs)
        finally:
            close_server(s)
            n_logits = watch.close()
        launches = {k: fn.launches for k, fn in counters.items()}
        out[label] = {"wall_s": wall, "tokens": tokens,
                      "aggregate_tok_s": tokens / wall,
                      "waves": list(w.waves), "launches": launches}
        log(f"  serve {label}: {tokens} tokens in {wall:.3f} s "
            f"({tokens / wall:.1f} tok/s), waves {w.waves}, {n_logits} "
            f"finite logit tensors; launches {launches}")
        if tokens == 0:
            raise AssertionError(f"phase 16 serve {label}: no tokens")
        expect_routes(launches, ("q4_matmul_w4a8", "quantize_activations"),
                      ("q8_matmul", "q4_matmul_f32a", "fused_mlp_q4",
                       *DIAGNOSTIC), f"phase 16 serve {label}")
    return out


def dequantized_on_cpu(quant, tree):
    """``tree`` on the CPU with each quantized matrix dequantized to f32
    (on the card, the same arithmetic): the CPU's plain route multiplies by
    exactly these weights, dequantized anew at every call (``dequantize``
    of a 262,144-column head takes seconds there)."""
    if isinstance(tree, dict):
        return {k: dequantized_on_cpu(quant, v) for k, v in tree.items()}
    if isinstance(tree, list):   # Qwen3-Next's per-layer dicts
        return [dequantized_on_cpu(quant, v) for v in tree]
    if isinstance(tree, quant.QuantizedLinear):
        # One (K, N) matrix at a time: a stack of experts in f32 on the
        # card would be several times the quantized model.
        lead = tree.values.shape[:-2]
        values = tree.values.reshape(-1, *tree.values.shape[-2:])
        scales = tree.scales.reshape(-1, *tree.scales.shape[-2:])
        out = None
        for i in range(values.shape[0]):
            w = quant.dequantize(quant.QuantizedLinear(values[i], scales[i]))
            if out is None:
                out = torch.empty((values.shape[0], *w.shape),
                                  dtype=w.dtype)
            out[i].copy_(w)   # straight from the card, no host temporary
        return out.reshape(*lead, *out.shape[1:])
    return tree.cpu()


def family_sweep(dev, llm, quant, name: str) -> dict:
    """(b): ``name`` at its published widths cut to FAMILY_SWEEP_LAYERS'
    depth, card against
    the CPU (its plain route, the matrices dequantized once,
    ``dequantized_on_cpu``): prefill at FAMILY_BUCKETS and, for a sliding
    config, one prompt longer than its window (Phi-3 also past its original
    context), rel L2 within WIDTH_TOL."""
    t0 = time.perf_counter()
    cfg = family_cfg(llm, name)
    params = family_model(dev, llm, cfg, name)
    cpu = dequantized_on_cpu(quant, params)
    buckets = list(FAMILY_BUCKETS)
    if name in FAMILY_LONG:
        buckets.append(FAMILY_LONG[name])
    if name == "phi3_mini":
        buckets.append(PHI3_LONG_SIDE)
    toks = torch.randint(0, cfg.vocab_size, (max(buckets),),
                         generator=torch.Generator().manual_seed(SEED))
    out = {"group": q4_group(cfg), "window": llm._layer_window(cfg),
           "rel_l2": {}}
    for bucket in buckets:
        length = bucket - 6
        lg, _ = llm.prefill(params, cfg, toks[:bucket].to(dev), length,
                            llm.KVCache.create(cfg, max_seq=bucket,
                                               device=dev))
        lc, _ = llm.prefill(cpu, cfg, toks[:bucket], length,
                            llm.KVCache.create(cfg, max_seq=bucket,
                                               device="cpu"))
        err = rel_l2(lg.cpu(), lc)
        out["rel_l2"][str(bucket)] = err
        log(f"  {name} prefill bucket={bucket}: rel_l2 card vs cpu = "
            f"{err:.3e} (tol {WIDTH_TOL:.0e})")
        if not (torch.isfinite(lg).all() and err < WIDTH_TOL):
            raise AssertionError(f"phase 16 {name} bucket {bucket}: {err}")
    log(f"  {name} swept in {time.perf_counter() - t0:.1f} s")
    return out


def family_gguf(arch: str, seed: int):
    """(tensors, metadata) of a 2-layer ``arch`` GGUF at
    FAMILY_GGUF_WIDTHS, F32 tensors from the seed, as llama.cpp names them
    (Command-R: a shared LayerNorm, per-head QK LayerNorms and a logit
    scale; Nemotron: biased LayerNorms, squared ReLU, half rotary;
    StarCoder2: biased LayerNorms, q/k/v, output and MLP biases, GELU),
    with ``spm_spec``'s vocabulary."""
    dim, layers, heads, kv, hid, vocab = FAMILY_GGUF_WIDTHS
    hd = dim // heads
    qd, kvd = heads * hd, kv * hd
    rng = np.random.default_rng(seed)
    biased = arch != "command-r"
    gated = arch == "command-r"

    def m(*shape):
        return ((rng.standard_normal(shape) / np.sqrt(shape[-1]))
                .astype(np.float32), GGML_F32)

    def vec(n, around=0.0):
        return ((around + 0.1 * rng.standard_normal(n)).astype(np.float32),
                GGML_F32)
    t = {"token_embd.weight": (0.2 * rng.standard_normal(
        (vocab, dim)).astype(np.float32), GGML_F32),
         "output_norm.weight": vec(dim, 1.0)}
    if biased:
        t["output_norm.bias"] = vec(dim)
        t["output.weight"] = m(vocab, dim)
    for i in range(layers):
        p = f"blk.{i}"
        t[f"{p}.attn_norm.weight"] = vec(dim, 1.0)
        if biased:
            t[f"{p}.attn_norm.bias"] = vec(dim)
            t[f"{p}.ffn_norm.weight"] = vec(dim, 1.0)
            t[f"{p}.ffn_norm.bias"] = vec(dim)
        else:
            t[f"{p}.attn_q_norm.weight"] = vec(qd, 1.0)
            t[f"{p}.attn_k_norm.weight"] = vec(kvd, 1.0)
        t[f"{p}.attn_q.weight"] = m(qd, dim)
        t[f"{p}.attn_k.weight"] = m(kvd, dim)
        t[f"{p}.attn_v.weight"] = m(kvd, dim)
        t[f"{p}.attn_output.weight"] = m(dim, qd)
        if arch == "starcoder2":
            t[f"{p}.attn_q.bias"] = vec(qd)
            t[f"{p}.attn_k.bias"] = vec(kvd)
            t[f"{p}.attn_v.bias"] = vec(kvd)
            t[f"{p}.attn_output.bias"] = vec(dim)
            t[f"{p}.ffn_up.bias"] = vec(hid)
            t[f"{p}.ffn_down.bias"] = vec(dim)
        if gated:
            t[f"{p}.ffn_gate.weight"] = m(hid, dim)
        t[f"{p}.ffn_up.weight"] = m(hid, dim)
        t[f"{p}.ffn_down.weight"] = m(dim, hid)
    spec = spm_spec(vocab)
    meta = {
        "general.architecture": arch, "general.name": f"tiny {arch}",
        f"{arch}.embedding_length": dim, f"{arch}.block_count": layers,
        f"{arch}.attention.head_count": heads,
        f"{arch}.attention.head_count_kv": kv,
        f"{arch}.feed_forward_length": hid, f"{arch}.context_length": 1024,
        f"{arch}.attention.layer_norm_epsilon": 1e-5,
        f"{arch}.attention.layer_norm_rms_epsilon": 1e-5,
        f"{arch}.rope.freq_base": 10000.0, f"{arch}.vocab_size": vocab,
        "tokenizer.ggml.model": "llama",
        "tokenizer.ggml.tokens": spec["tokens"],
        "tokenizer.ggml.scores": spec["scores"],
        "tokenizer.ggml.token_type": spec["token_types"],
        "tokenizer.ggml.bos_token_id": 1, "tokenizer.ggml.eos_token_id": 2,
        "tokenizer.ggml.unknown_token_id": 0,
        "tokenizer.ggml.padding_token_id": spec["pad_id"],
        "tokenizer.ggml.add_space_prefix": spec["add_space_prefix"],
    }
    if arch == "command-r":
        meta["command-r.logit_scale"] = 0.0625
    if arch == "nemotron":
        meta["nemotron.rope.dimension_count"] = hd // 2
    return t, meta


def _widened(params):
    """``params`` with its float leaves in f32 (quantized leaves as they
    are): the card and the CPU then differ only in their sums' order."""
    if isinstance(params, dict):
        return {k: _widened(v) for k, v in params.items()}
    if isinstance(params, tuple):  # QuantizedLinear
        return params
    return params.float()


def family_cli(dev, llm, runner_mod, tokenizer_mod, checkpoint, cli,
               counters) -> dict:
    """(c): each FAMILY_GGUF_ARCHES file through ``convert --bits 8`` and
    ``generate`` on the card (the CLI, in-process); then greedy ids from the
    checkpoint on the card equal the CPU's, its float leaves widened to
    f32 on both (the Q8 kernel keeps exact f32 activations, so only the
    sums' order differs)."""
    out = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_family_") as tmp:
        for arch in FAMILY_GGUF_ARCHES:
            path = os.path.join(tmp, f"{arch}.gguf")
            ckpt = os.path.join(tmp, arch)
            tensors, meta = family_gguf(arch, SEED)
            write_gguf(path, tensors, meta)
            rc, text, conv_s = run_cli(cli, ["convert", path, "-o", ckpt,
                                             "--bits", "8"])
            if rc != 0:
                raise AssertionError(f"phase 16 {arch}: convert exited {rc}")
            for fn in counters.values():
                fn.launches = 0
            rc, text, gen_s = run_cli(cli, [
                "generate", ckpt, "-p", "descreva a cena", "--max-tokens",
                str(FAMILY_GGUF_TOKENS), "--temperature", "0"])
            launches = {k: fn.launches for k, fn in counters.items()}
            # Random weights may draw byte pieces that print no text: the
            # ids below must be there.
            if rc != 0:
                raise AssertionError(f"phase 16 {arch}: generate exited {rc}"
                                     f" and printed {text!r}")
            expect_routes(launches, ("q8_matmul",),
                          ("q4_matmul_w4a8", "q4_matmul_f32a",
                           *DIAGNOSTIC), f"phase 16 {arch}")
            ids = []
            for device in (dev, torch.device("cpu")):
                params, cfg, meta = checkpoint.load_checkpoint(ckpt,
                                                               device=device)
                r = runner_mod.LLMRunner(
                    _widened(params), cfg,
                    tokenizer_mod.tokenizer_from_spec(meta["tokenizer_spec"]),
                    runner_mod.GenerationConfig(
                        max_tokens=FAMILY_GGUF_TOKENS, temperature=0.0,
                        speculative=False),
                    cache_dtype=torch.float32, device=device)
                r.generate("descreva a cena a sua frente")
                ids.append(r.generated_ids)
            log(f"  {arch}: convert {conv_s:.2f} s, generate exit {rc} in "
                f"{gen_s:.2f} s printed {text.strip()[:40]!r}; card ids == "
                f"cpu ids: {ids[0] == ids[1]} ({len(ids[0])} ids); "
                f"{cfg.norm_type} norm, act {cfg.act}, gated "
                f"{cfg.mlp_gated}, parallel residual {cfg.parallel_residual}")
            if ids[0] != ids[1] or not ids[0]:
                raise AssertionError(f"phase 16 {arch}: card ids {ids[0]} "
                                     f"against cpu ids {ids[1]}")
            out[arch] = {"convert_s": conv_s, "generate_s": gen_s,
                         "ids": len(ids[0]), "launches": launches}
    return out


def family_profile_child() -> dict:
    """(a)'s profile of Gemma-2-9B in a process of its own (this script
    with FAMILY_PROFILE_FLAG), as phases 12-14 profile: a fresh bucket-512
    prefill and FAMILY_TOKENS decode tokens (``profile_path``)."""
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), FAMILY_PROFILE_FLAG],
        capture_output=True, text=True, timeout=FAMILY_PROFILE_TIMEOUT)
    lines = proc.stdout.strip().splitlines()
    if proc.returncode != 0 or not lines:
        raise AssertionError(f"phase 16: the profile's process exited "
                             f"{proc.returncode}: {proc.stderr[-2000:]}")
    for line in lines[:-1]:
        log(line)
    return json.loads(lines[-1])


def family_profile_main(dev) -> int:
    """The child of ``family_profile_child``."""
    from trackiellm_tpu_torch.llm import runner as runner_mod
    from trackiellm_tpu_torch.llm import tokenizer as tokenizer_mod
    from trackiellm_tpu_torch.models import llm
    from trackiellm_tpu_torch.ops import _build
    _build.library()
    cfg = family_cfg(llm, "gemma2_9b")
    params = family_model(dev, llm, cfg, "gemma2_9b")
    prof = profile_path(dev, runner_mod, tokenizer_mod, params, cfg)
    print(json.dumps(prof), flush=True)
    return 0


def phase_families(dev, llm, runner_mod, tokenizer_mod, server_mod, paging,
                   measure, checkpoint, attention, quant, cli, counters,
                   profile) -> dict:
    """Phase 16 (the comment above FAMILY_TOKENS): (a) Gemma-2-9B and
    Llama-3.1-8B generate, Gemma-2-9B serves and is profiled
    (``profile()``); (b) the sweep; (c) the GGUF-only arches. Returns the
    ``families`` line's numbers and the launches of (a)'s paths."""
    t0 = time.perf_counter()
    parts = {}

    def lap(part: str) -> None:
        parts[part] = time.perf_counter() - t0 - sum(parts.values())
        log(f"  phase 16 ({part}) took {parts[part]:.1f} s")
    out = {"flash_attrs": {f"D={d} {str(dt)[6:]}": attention.flash_kernel_attrs(
        d, dt) for d in (96, 256) for dt in (torch.bfloat16, torch.float32)}}
    cfg = family_cfg(llm, "gemma2_9b")
    params = family_model(dev, llm, cfg, "gemma2_9b")
    gemma = family_generate(dev, llm, runner_mod, tokenizer_mod, params, cfg,
                            counters, "gemma2_9b")
    gemma["serve"] = family_serve(
        dev, llm, tokenizer_mod, server_mod, paging, measure, params,
        cfg._replace(max_seq=FAMILY_SERVE_MAX_SEQ), counters)
    del params
    torch.cuda.empty_cache()
    lap("a gemma2_9b")
    gemma["profile"] = profile()
    dec = gemma["profile"].get("decode", {})
    log(f"  gemma2_9b profile, a decode token: wall {dec.get('wall_ms')} ms, "
        f"busy {dec.get('busy_ms')} ms, idle share {dec.get('idle_share')}, "
        f"{dec.get('launches')} launches")
    out["gemma2_9b"] = gemma
    lap("profile")
    cfg = family_cfg(llm, "llama3_8b")
    params = family_model(dev, llm, cfg, "llama3_8b")
    out["llama3_1_8b"] = family_generate(dev, llm, runner_mod, tokenizer_mod,
                                         params, cfg, counters, "llama3_8b")
    del params
    torch.cuda.empty_cache()
    lap("a llama3_8b")
    out["sweep"] = {}
    for name in FAMILY_SWEEP:
        out["sweep"][name] = family_sweep(dev, llm, quant, name)
        torch.cuda.empty_cache()
    lap("b")
    out["gguf"] = family_cli(dev, llm, runner_mod, tokenizer_mod, checkpoint,
                             cli, counters)
    lap("c")
    out["launches"] = out["gemma2_9b"]["launches"]
    out["seconds"] = time.perf_counter() - t0
    out["part_seconds"] = parts
    log(f"  phase 16 took {out['seconds']:.1f} s")
    return out


# Phase 17: the MoE families. (a) gpt-oss-20b at its widths cut to
# MOE_GPTOSS_LAYERS of its 24 layers (32 experts top-4, (64, 8) heads at
# D = 64 with sinks, window 128 on even layers, vocab 201,088), Q4 at
# q4_group's G = 32, YaRN factors, max_seq cut to MOE_GPTOSS_MAX_SEQ; (b) Qwen3-30B-A3B (128 experts top-8,
# 768 wide, G = 128) at MOE_QWEN3_LAYERS, max_seq MOE_QWEN3_MAX_SEQ; (c)
# the other MoE presets at published widths cut to MOE_SWEEP's depths, card
# against CPU on the card's experts, and a tiny Llama-4 knob set across
# attention chunks; (a) also serves tiny MOE_POOL knob sets on the int8
# pool, card against CPU; (d)
# GGUFs of the MoE arches through the CLI.
# gpt-oss-20b's 24 layers cut to 2 (both kinds of its alternating
# attention stay) and its tokens from 32 to 16, Qwen3-30B-A3B's 12 layers to
# 2 and the sweep to 1 layer, to bring phases 1-17 under their 600-s
# budget (phase 17 took 254.5 s at 24, 32, 12 and 2: 76.5 s for (a), 14.3
# for (b), 46.2 for the profile child, which rebuilds gpt-oss-20b at
# MOE_GPTOSS_LAYERS, 105.1 for (c); 91.9-183.0 s at 6, 16, 6 and 1 (4 for
# Llama-4) in later calls; on an H100 80GB HBM3 at 700 W).
MOE_GPTOSS_LAYERS = 2
# gpt-oss-20b's and Qwen3-30B-A3B's greedy and served tokens: 16, then 8 to
# pay for phase 21 (phase 17 took 110.2 s at 16, 87.9-97.3 s at 8; on an
# H100 80GB HBM3 at 700 W).
MOE_TOKENS = 8
MOE_GPTOSS_MAX_SEQ = 4096
MOE_QWEN3_MAX_SEQ = 2048
# Qwen3-30B-A3B's 48 layers cut to 12: its dense-all-experts decode token
# is about 73,000 launches at 48 layers, 2 s of host time, which would take
# phase 17 past 250 s (0.50 s a token at 12 layers on an H100 80GB HBM3 at
# 700 W).
MOE_QWEN3_LAYERS = 2
MOE_QWEN3_TOKENS = 8   # 16 before phase 21 (above MOE_TOKENS)
# One layer each: gpt-oss-120b's is windowed (its global layers run in
# (a)'s gpt-oss-20b), Llama-4 Scout's has rope (its NoPE layers run card
# against CPU in the tiny Llama-4 across chunks, moe_chunks). (c) took
# 105.8 s with gpt-oss-120b at 2 layers and Llama-4 at 4, 50.8-102.1 s
# with gpt-oss-120b at 1 in later calls, Llama-4's 25.1-47.0 of it (on an
# H100 80GB HBM3 at 700 W): the CPU side's cost is its f32 copy of every
# expert and head.
MOE_SWEEP = {"mixtral_8x7b": 1, "qwen15_moe_a27b": 1,
             "qwen3_moe_30b_a3b": 1, "gpt_oss_120b": 1, "llama4_scout": 1}
MOE_BUCKETS = (64, 256)
# The Q8 case (preset, bucket): gpt-oss-120b, whose Q4 logits moved most
# (0.52 rel L2 at bucket 64, 35 router flips, on an H100 80GB HBM3 at 700
# W); with exact activations only the sums' order differs.
MOE_SWEEP_Q8 = ("gpt_oss_120b", 64)
MOE_CHUNK = 64           # the tiny Llama-4's attention chunk
MOE_CHUNK_TOL = 1e-4     # rel L2, f32 weights, card against CPU
MOE_GGUF_ARCHES = ("mixtral", "qwen2moe", "qwen3moe", "gpt-oss", "llama4",
                   "glm4moe", "falcon")
MOE_GGUF_BITS4 = "qwen3moe"   # the arch converted at --bits 4 as well
MOE_GGUF_EXPERTS = 8
MOE_GGUF_TOKENS = 8        # 16 before the smoke's 600-s budget
# (a)'s int8 pool card against CPU: knob sets served at tiny widths in f32,
# gpt-oss's window and Llama-4's chunks cut to MOE_POOL_SPAN so that the
# 49-token prompts and their tokens cross them, on pages of MOE_POOL_PAGE.
MOE_POOL = ("gpt_oss_20b", "llama4_scout")
MOE_POOL_SPAN = 32
MOE_POOL_PAGE = 16
MOE_POOL_TOKENS = 24
MOE_PROFILE_FLAG = "--moe-profile"
MOE_PROFILE_TIMEOUT = 900.0
# Decode tokens of the profiled window, at lookahead 1: a gpt-oss-20b step
# is about 20,000 launches, and the profiler's records took most of phase
# 17's time (183.5 s of 386.6 for one token at lookahead 4, which the
# runner decoded as 8 steps, on an H100 80GB HBM3 at 700 W).
MOE_PROFILE_TOKENS = 2
GGML_MXFP4 = 39


def moe_cfg(llm, name: str, layers: int = 0, max_seq: int = 0):
    """A MoE preset with its depth and max_seq cut where given; a window
    at or past max_seq stays off, as it was."""
    cfg = getattr(llm.LLMConfig, name)()
    if layers:
        cfg = cfg._replace(n_layers=layers)
    if max_seq:
        cfg = cfg._replace(max_seq=max_seq, sliding_window=min(
            cfg.sliding_window, max_seq))
    return cfg


def moe_model(dev, llm, cfg, name: str, bits: int = 4):
    """Random Q4 (or Q8) params of ``cfg`` from the seed on the card, one
    expert matrix at a time, at ``q4_group``'s group, with gpt-oss's YaRN
    factors."""
    t0 = time.perf_counter()
    group = q4_group(cfg)
    params = llm.init_params_quantized(
        torch.Generator(device=dev).manual_seed(SEED), cfg, bits=bits,
        group=group, device=dev)
    if name.startswith("gpt_oss"):
        params["rope_factors"] = llm.yarn_rope_factors(
            cfg, 32.0, 4096, truncate=False).to(dev)
    torch.cuda.synchronize()
    log(f"  {name}: {cfg.n_layers} layers, {cfg.n_experts} experts top-"
        f"{cfg.n_experts_used}, Q{bits} group {group} in "
        f"{time.perf_counter() - t0:.1f} s, "
        f"{param_bytes(params) / 2 ** 30:.2f} GiB on the card")
    return params


MOE_SERVE = {  # label: the server's knobs
    "dense_chunk1": dict(chunk_steps=1), "dense_chunk8": dict(chunk_steps=8),
    "int8_chunk8": dict(chunk_steps=8, page_size=SERVE_PAGE,
                        cache_dtype=torch.int8)}


def moe_serve(dev, llm, tokenizer_mod, server_mod, paging, measure, params,
              cfg, counters) -> dict:
    """(a): a held burst of SERVE_SLOTS of measure_server's prompts,
    MOE_TOKENS tokens each, on dense slots per step and in 8-step chunks,
    and on the int8 paged pool in 8-step chunks (MOE_SERVE): on the dense
    slots the chunked ids equal the per-step ids, request by request;
    every logit is finite. The dense and int8 layouts' agreement is
    reported, not held (the int8 cells round K and V, so greedy ids on
    random weights part); ``moe_pool`` holds the int8 pool's path to the
    CPU's."""
    tok = tokenizer_mod.ByteTokenizer(cfg.vocab_size)
    server = server_factory(server_mod, params, cfg, tok)
    jobs = [(p, dict(max_tokens=MOE_TOKENS))
            for p in measure.prompts(SEED)[:SERVE_SLOTS]]
    out, ids = {}, {}
    for label, kw in MOE_SERVE.items():
        for fn in counters.values():
            fn.launches = 0
        watch = LogitWatch(llm, paging)
        s, w = server(**kw)
        try:
            t0 = time.perf_counter()
            burst(s, jobs, w)
            wall = time.perf_counter() - t0
        finally:
            close_server(s)
            watch.close()
        ids[label] = [w.ids[p] for p, _ in jobs]
        tokens = sum(map(len, ids[label]))
        launches = {k: fn.launches for k, fn in counters.items()}
        out[label] = {"wall_s": wall, "tokens": tokens,
                      "aggregate_tok_s": tokens / wall,
                      "waves": list(w.waves), "launches": launches}
        log(f"  serve {label}: {tokens} tokens in {wall:.3f} s "
            f"({tokens / wall:.1f} tok/s), waves {w.waves}; launches "
            f"{launches}")
        if tokens == 0:
            raise AssertionError(f"phase 17 serve {label}: no tokens")
        expect_routes(launches, ("q4_matmul_w4a8", "quantize_activations"),
                      ("q8_matmul", "q4_matmul_f32a", "fused_mlp_q4",
                       *DIAGNOSTIC), f"phase 17 serve {label}")
    a, b = ids["dense_chunk1"], ids["dense_chunk8"]
    if a != b:
        raise AssertionError(
            "phase 17 serve: chunk8 ids differ from per-step ids at "
            f"{[first_divergence(x, y) for x, y in zip(a, b)]}")
    log(f"  serve dense: chunk8 ids == per-step ids on all {len(a)} "
        "requests")
    parts = [first_divergence(x, y)
             for x, y in zip(ids["dense_chunk8"], ids["int8_chunk8"])]
    out["dense_vs_int8"] = {
        "equal": sum(p is None for p in parts), "first_divergence": parts}
    log(f"  serve dense vs int8 pool: ids equal on "
        f"{out['dense_vs_int8']['equal']}/{len(parts)} requests, first "
        f"divergences {parts}")
    return out


def moe_pool_cfg(llm, name: str):
    """``name``'s knob set at tiny widths: 4 layers, dim 256, 4/2 heads at
    D = 64, 8 experts (top-k kept up to 4, a shared expert where it has
    one), vocab 512, max_seq 512; gpt-oss's window and Llama-4's chunks
    (and its temperature floor) MOE_POOL_SPAN."""
    c = getattr(llm.LLMConfig, name)()
    span = MOE_POOL_SPAN
    return c._replace(
        vocab_size=512, dim=256, n_layers=4, n_heads=4, n_kv_heads=2,
        head_dim=64, hidden_dim=256, n_experts=8,
        n_experts_used=min(c.n_experts_used, 4),
        moe_shared_hidden=256 if c.moe_shared_hidden else 0, max_seq=512,
        sliding_window=span if c.sliding_window < c.max_seq else 512,
        attn_chunk=span if c.attn_chunk else 0,
        attn_temp_floor=(float(span) if c.attn_temp_tuning
                         else c.attn_temp_floor))


def moe_pool(dev, llm, tokenizer_mod, server_mod, paging, measure) -> dict:
    """(a): each MOE_POOL knob set (``moe_pool_cfg``), f32 weights from the
    seed, serves a held burst of SERVE_SLOTS of measure_server's prompts,
    MOE_POOL_TOKENS tokens each, on the int8 paged pool (8-step chunks,
    f32 compute) on the card and on the CPU: sinks, windows, chunk masks
    and the MoE block on int8 pages; the ids must be equal, request by
    request, and every logit finite."""
    jobs = [(p, dict(max_tokens=MOE_POOL_TOKENS))
            for p in measure.prompts(SEED)[:SERVE_SLOTS]]
    out = {}
    for name in MOE_POOL:
        cfg = moe_pool_cfg(llm, name)
        params = llm.init_params(torch.Generator().manual_seed(SEED), cfg,
                                 dtype=torch.float32, device="cpu")
        tok = tokenizer_mod.ByteTokenizer(cfg.vocab_size)
        ids = {}
        for side, p in (("card", llm.params_to(params, dev)),
                        ("cpu", params)):
            s, w = server_factory(server_mod, p, cfg, tok)(
                chunk_steps=8, page_size=MOE_POOL_PAGE,
                cache_dtype=torch.int8)
            s.pool.compute_dtype = torch.float32
            watch = LogitWatch(llm, paging)
            try:
                burst(s, jobs, w)
            finally:
                close_server(s)
                watch.close()
            ids[side] = [w.ids[q] for q, _ in jobs]
        parts = [first_divergence(a, b)
                 for a, b in zip(ids["card"], ids["cpu"])]
        n = sum(map(len, ids["card"]))
        log(f"  tiny {name} on the int8 pool: card ids == cpu ids on "
            f"{parts.count(None)}/{len(jobs)} requests ({n} ids), first "
            f"divergences {parts}")
        if parts.count(None) != len(jobs) or not all(ids["card"]):
            raise AssertionError(f"phase 17 int8 pool {name}: card ids part "
                                 f"from the cpu's at {parts}")
        out[name] = {"requests": len(jobs), "equal": parts.count(None),
                     "ids": n}
    return out


def moe_qwen3(dev, llm, runner_mod, tokenizer_mod, counters,
              layers: int) -> dict:
    """(b): Qwen3-30B-A3B behind ``LLMRunner``: the cortex prompt and
    MOE_QWEN3_TOKENS greedy tokens (lookahead 1); the prefill's and the
    decode's wall ms, and the wrappers' launches a decode token."""
    cfg = moe_cfg(llm, "qwen3_moe_30b_a3b", layers, MOE_QWEN3_MAX_SEQ)
    params = moe_model(dev, llm, cfg, "qwen3_moe_30b_a3b")
    tok = tokenizer_mod.ByteTokenizer(cfg.vocab_size)
    runner = runner_mod.LLMRunner(params, cfg, tok, runner_mod.GenerationConfig(
        max_tokens=MOE_QWEN3_TOKENS, temperature=0.0, speculative=False,
        lookahead=1), device=dev)
    prompt = runner.build_prompt(SYSTEM, CONTEXT,
                                 "What is in front of me right now?")
    warm_up(runner, 4)
    watch = LogitWatch(llm)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runner.prepare_generation(prompt)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for fn in counters.values():
            fn.launches = 0
        while runner.generate_next_token() is not None:
            pass
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    finally:
        n_logits = watch.close()
    n = len(runner.generated_ids)
    if n == 0:
        raise AssertionError("phase 17 qwen3: no tokens")
    launches = {k: fn.launches / n for k, fn in counters.items()}
    out = {"layers": cfg.n_layers, "prompt_tokens":
           runner.count_tokens(prompt) + 1, "prefill_ms": (t1 - t0) * 1e3,
           "tokens": n, "decode_ms_per_token": (t2 - t1) * 1e3 / n,
           "launches_per_token": launches, "finite_logit_vectors": n_logits}
    log(f"  qwen3_moe_30b_a3b ({cfg.n_layers} layers): prefill "
        f"{out['prefill_ms']:.1f} ms for {out['prompt_tokens']} tokens, "
        f"{n} tokens at {out['decode_ms_per_token']:.1f} ms a token; wrapper "
        f"launches a token {launches}")
    expect_routes(launches, ("q4_matmul_w4a8", "quantize_activations"),
                  ("q8_matmul", "q4_matmul_f32a", "fused_mlp_q4",
                   *DIAGNOSTIC), "phase 17 qwen3")
    return out


class RouterTap:
    """Wraps the model's router (``llm._moe_router`` and the
    ``llm._moe_select`` it calls) to keep, on the host, each call's (T, E)
    selection values (``select``) and (T, K) expert ids (``ids``), one call
    a MoE layer. Given ``forced`` (id tensors, one a call), call i takes
    the experts ``forced[i]`` instead of its own top-k, weighted by this
    side's own scores (``llm._moe_weights``)."""

    def __init__(self, llm, forced=None):
        self.llm, self.select, self.ids = llm, [], []
        self.orig = select_fn, router_fn = llm._moe_select, llm._moe_router

        def select(h2, layer, cfg):
            scores, sel = select_fn(h2, layer, cfg)
            self.select.append(sel.detach().float().cpu())
            return scores, sel

        def router(h2, layer, cfg):
            if forced is None:
                topv, topi = router_fn(h2, layer, cfg)
            else:
                scores, _ = llm._moe_select(h2, layer, cfg)
                topi = forced[len(self.ids)].to(scores.device)
                topv = llm._moe_weights(scores, topi, cfg)
            self.ids.append(topi.cpu())
            return topv, topi
        llm._moe_select, llm._moe_router = select, router

    def close(self) -> tuple:
        self.llm._moe_select, self.llm._moe_router = self.orig
        return self.select, self.ids


def router_flips(top_k, card_select, card_ids, cpu_select, k: int,
                 rows: int) -> tuple:
    """The router flips of a pass forced to the card's experts: each
    (layer, token) of the first ``rows`` tokens where the CPU's own
    top-``k`` (``top_k`` of its selection values) is not the card's set
    (``card_ids``), with the CPU's margin there (its k-th largest value
    less its (k+1)-th) and how far that token's values moved. Returns them
    with the router's noise: the largest card-to-CPU change of a selection
    value over the tokens that did not flip. A flip needs the swapped
    pair's gap to move by at least the margin, and two values that each
    move by at most the noise move their gap by at most twice it: a flip
    is ``explained`` when its margin is at most twice the noise."""
    if not len(card_select) == len(card_ids) == len(cpu_select):
        raise AssertionError(f"router calls: card {len(card_select)} and "
                             f"{len(card_ids)}, cpu {len(cpu_select)}")
    flips, noise = [], 0.0
    for layer, (a, ids, b) in enumerate(zip(card_select, card_ids,
                                            cpu_select)):
        a, ids, b = a[:rows], ids[:rows], b[:rows]
        own = top_k(b, k)
        moved = (a - b).abs().amax(dim=-1)
        flipped = (own.sort(dim=-1).values
                   != ids.sort(dim=-1).values).any(dim=-1)
        if (~flipped).any():
            noise = max(noise, moved[~flipped].max().item())
        for t in flipped.nonzero().flatten().tolist():
            top = torch.sort(b[t], descending=True).values
            flips.append({"layer": layer, "token": t,
                          "margin": (top[k - 1] - top[k]).item(),
                          "card": sorted(ids[t].tolist()),
                          "cpu": sorted(own[t].tolist()),
                          "moved": moved[t].item()})
    for f in flips:
        f["explained"] = f["margin"] <= 2 * noise
    return flips, noise


def check_router_flips(flips, noise: float, tag: str) -> None:
    """Print every flip; fail on one whose margin is above twice the
    router's noise (``router_flips``)."""
    for f in flips:
        log(f"  {tag}: router flip at layer {f['layer']} token "
            f"{f['token']}: experts {f['card']} (card) / {f['cpu']} (cpu), "
            f"margin {f['margin']:.3e}, router noise {noise:.3e}, the "
            f"token's values moved up to {f['moved']:.3e}"
            + ("" if f["explained"] else " (NOT explained)"))
    bad = [f for f in flips if not f["explained"]]
    if bad:
        raise AssertionError(f"{tag}: {len(bad)} router flips above twice "
                             f"the router noise {noise:.3e}: {bad[:4]}")


def w4a8_groups(quant, tree, cpu) -> dict:
    """{the storage address of a weight of ``cpu`` (``dequantized_on_cpu``
    of ``tree``): its group} for every Q4 matrix of ``tree``."""
    if isinstance(tree, (dict, list)):
        out = {}
        for key, value in (tree.items() if isinstance(tree, dict)
                           else enumerate(tree)):
            out.update(w4a8_groups(quant, value, cpu[key]))
        return out
    if (isinstance(tree, quant.QuantizedLinear)
            and tree.values.dtype == torch.uint8):
        return {cpu.untyped_storage().data_ptr(): tree.group_size}
    return {}


@contextlib.contextmanager
def w4a8_activations(llm, quant, groups):
    """Inside, each of the model's f32 products (``llm._mm_f32``) with a
    weight of ``groups`` (``w4a8_groups``) first quantizes its activations
    per (row, group) to int8 (``quantize_activations_q8``), as the W4A8
    kernel does up to KERNEL_MAX_M rows: the kernel's function on the
    dequantized weight, its f32 sums in another order."""
    mm = llm._mm_f32

    def product(a, b):
        g = groups.get(b.untyped_storage().data_ptr())
        if g and a.shape[0] <= quant.KERNEL_MAX_M:
            m, k = a.shape
            xq, sx, _ = quant.quantize_activations_q8(a, g)
            a = (xq.float().reshape(m, k // g, g)
                 * sx[:, :, None]).reshape(m, k)
        return mm(a, b)
    llm._mm_f32 = product
    try:
        yield
    finally:
        llm._mm_f32 = mm


def moe_sweep(dev, llm, quant, name: str, bits: int, buckets) -> dict:
    """(c): ``name`` at its published widths cut to MOE_SWEEP's depth, Q4
    or Q8, card against the CPU: prefill at ``buckets``, each within
    WIDTH_TOL. The CPU's pass takes the card's experts (``RouterTap``
    forced to the card's ids, weighted by the CPU's own scores) on the
    matrices dequantized once (``dequantized_on_cpu``), with W4A8's
    activation quantization where the card ran W4A8
    (``w4a8_activations``); where its own router would have chosen other
    experts, the flip is printed and must lie within the router's noise
    (``router_flips``)."""
    t0 = time.perf_counter()
    cfg = moe_cfg(llm, name, MOE_SWEEP[name], max(buckets))
    params = moe_model(dev, llm, cfg, name, bits)
    toks = torch.randint(0, cfg.vocab_size, (max(buckets),),
                         generator=torch.Generator().manual_seed(SEED))
    card = {}
    for bucket in buckets:
        tap = RouterTap(llm)
        try:
            lg, _ = llm.prefill(params, cfg, toks[:bucket].to(dev),
                                bucket - 6, llm.KVCache.create(
                                    cfg, max_seq=bucket, device=dev))
        finally:
            select, ids = tap.close()
        card[bucket] = (lg.cpu(), select, ids)
    cpu = dequantized_on_cpu(quant, params)
    w4a8 = bits == 4 and torch.device(dev).type == "cuda"
    groups = w4a8_groups(quant, params, cpu) if w4a8 else {}
    del params
    torch.cuda.empty_cache()
    out = {"layers": cfg.n_layers, "bits": bits, "group": q4_group(cfg),
           "rel_l2": {}, "flips": {}, "router_noise": {}}
    for bucket in buckets:
        length = bucket - 6
        lg, select, ids = card[bucket]
        tap = RouterTap(llm, forced=ids)
        # The CPU's f32 banks take the routed formulation, the same
        # function (tests/test_torch_moe.py holds it to dense-all-experts)
        # at K/E of the work: dense-all on 128 experts is minutes there.
        try:
            with levers_on(("TRACKIE_MOE_ROUTED",)), w4a8_activations(
                    llm, quant, groups):
                lc, _ = llm.prefill(cpu, cfg, toks[:bucket], length,
                                    llm.KVCache.create(cfg, max_seq=bucket,
                                                       device="cpu"))
        finally:
            cpu_select, cpu_ids = tap.close()
        if len(cpu_ids) != len(ids):
            raise AssertionError(f"phase 17 {name}: {len(ids)} router calls "
                                 f"on the card, {len(cpu_ids)} on the cpu")
        tag = f"{name} Q{bits} bucket {bucket}"
        flips, noise = router_flips(llm._top_k_first, select, ids,
                                    cpu_select, cfg.n_experts_used, length)
        check_router_flips(flips, noise, tag)
        err = rel_l2(lg, lc)
        out["rel_l2"][str(bucket)] = err
        out["flips"][str(bucket)] = flips
        out["router_noise"][str(bucket)] = noise
        log(f"  {name} Q{bits} prefill bucket={bucket}: rel_l2 card vs cpu "
            f"on the card's experts = {err:.3e} (tol {WIDTH_TOL:.0e}"
            f"{', W4A8 activations on the cpu' if w4a8 else ''}); "
            f"{len(flips)} router flips in {len(ids)} MoE layers x {length} "
            f"tokens, router noise {noise:.3e}")
        if not torch.isfinite(lg).all():
            raise AssertionError(f"phase 17 {tag}: logits")
        if not err < WIDTH_TOL:
            raise AssertionError(f"phase 17 {tag}: rel_l2 {err}")
    log(f"  {name} Q{bits} swept in {time.perf_counter() - t0:.1f} s")
    return out


def moe_chunks(dev, llm) -> dict:
    """(c): a tiny Llama-4 knob set (NoPE every 2nd layer with temperature
    tuning at floor 64, L2-normed q/k, chunks of MOE_CHUNK, 8 experts top-1
    input-scaled with a shared expert) in f32, card against CPU: a 150-token
    prefill (chunks 0, 1 and 2), a 16-token extend, then decode steps
    across the next chunk boundary, each within MOE_CHUNK_TOL."""
    cfg = llm.LLMConfig.llama4_scout()._replace(
        vocab_size=512, dim=256, n_layers=4, n_heads=4, n_kv_heads=2,
        head_dim=64, hidden_dim=256, n_experts=8, moe_shared_hidden=256,
        max_seq=512, sliding_window=512, nope_pattern=2,
        attn_chunk=MOE_CHUNK, attn_temp_floor=float(MOE_CHUNK))
    params = llm.init_params(torch.Generator().manual_seed(SEED), cfg,
                             dtype=torch.float32, device="cpu")
    sides = {"card": (llm.params_to(params, dev), dev),
             "cpu": (params, torch.device("cpu"))}
    toks = torch.randint(0, cfg.vocab_size, (256 + 16 + 48,),
                         generator=torch.Generator().manual_seed(SEED))
    logits = {}
    for side, (p, d) in sides.items():
        cache = llm.KVCache.create(cfg, torch.float32, device=d)
        lg, cache = llm.prefill(p, cfg, toks[:256].to(d), 150, cache)
        got = [lg.cpu()]
        lg, cache = llm.extend(p, cfg, toks[256:272].to(d), 16, cache)
        got.append(lg.cpu())
        for i in range(48):   # positions 166..213 cross 192
            lg, cache = llm.decode_step(p, cfg, int(toks[272 + i]), cache)
            got.append(lg.cpu())
        logits[side] = got
    errs = [rel_l2(a, b) for a, b in zip(logits["card"], logits["cpu"])]
    worst = max(errs)
    log(f"  tiny llama4 chunk {MOE_CHUNK}: prefill 150 / extend 16 / 48 "
        f"decode steps to position 213, rel_l2 card vs cpu max {worst:.3e} "
        f"(tol {MOE_CHUNK_TOL:.0e})")
    if not worst < MOE_CHUNK_TOL:
        raise AssertionError(f"phase 17 llama4 chunks: {errs}")
    return {"rel_l2_max": worst, "steps": len(errs)}


def _mxfp4_blocks(rng, shape) -> tuple:
    """Seeded MXFP4 blocks (an e8m0 scale byte and 16 nibble bytes a
    32-block) of ``shape`` as ``write_gguf``'s raw triple."""
    n = math.prod(shape) // 32
    raw = np.concatenate([rng.integers(118, 126, (n, 1)).astype(np.uint8),
                          rng.integers(0, 256, (n, 16)).astype(np.uint8)],
                         axis=1)
    return raw.reshape(-1), GGML_MXFP4, shape


def moe_gguf(arch: str, seed: int):
    """(tensors, metadata) of a 2-layer GGUF of a MoE ``arch`` at
    FAMILY_GGUF_WIDTHS with MOE_GGUF_EXPERTS experts, as llama.cpp names
    them: "mixtral" (llama arch with ``*_exps`` banks), qwen2moe (a gated
    shared expert), qwen3moe (QK norms), gpt-oss (MXFP4 expert banks,
    router and expert biases, sinks, QKV and output biases), llama4 (NoPE
    every 2nd layer, chunks of 64, a shared expert, top-1), glm4moe (a
    leading dense layer, QKV biases, QK norms, sigmoid routing with
    ``exp_probs_b`` and 2 of 4 groups, an ungated shared expert) and falcon
    (fused QKV, biased LayerNorms, two norms); F32 tensors from the seed and
    ``spm_spec``'s vocabulary."""
    dim, layers, heads, kv, hid, vocab = FAMILY_GGUF_WIDTHS
    hd = dim // heads
    qd, kvd = heads * hd, kv * hd
    e = MOE_GGUF_EXPERTS
    rng = np.random.default_rng(seed)
    name = "llama" if arch == "mixtral" else arch

    def m(*shape):
        return ((rng.standard_normal(shape) / np.sqrt(shape[-1]))
                .astype(np.float32), GGML_F32)

    def vec(n, around=0.0):
        return ((around + 0.1 * rng.standard_normal(n)).astype(np.float32),
                GGML_F32)
    t = {"token_embd.weight": (0.2 * rng.standard_normal(
        (vocab, dim)).astype(np.float32), GGML_F32),
         "output_norm.weight": vec(dim, 1.0), "output.weight": m(vocab, dim)}
    spec = spm_spec(vocab)
    meta = {
        "general.architecture": name, "general.name": f"tiny {arch}",
        f"{name}.embedding_length": dim, f"{name}.block_count": layers,
        f"{name}.attention.head_count": heads,
        f"{name}.attention.head_count_kv": kv,
        f"{name}.feed_forward_length": hid, f"{name}.context_length": 1024,
        f"{name}.attention.layer_norm_rms_epsilon": 1e-5,
        f"{name}.rope.freq_base": 10000.0, f"{name}.vocab_size": vocab,
        "tokenizer.ggml.model": "llama",
        "tokenizer.ggml.tokens": spec["tokens"],
        "tokenizer.ggml.scores": spec["scores"],
        "tokenizer.ggml.token_type": spec["token_types"],
        "tokenizer.ggml.bos_token_id": 1, "tokenizer.ggml.eos_token_id": 2,
        "tokenizer.ggml.unknown_token_id": 0,
        "tokenizer.ggml.padding_token_id": spec["pad_id"],
        "tokenizer.ggml.add_space_prefix": spec["add_space_prefix"],
    }
    if arch == "falcon":
        t["output_norm.bias"] = vec(dim)
        meta["falcon.attention.layer_norm_epsilon"] = 1e-5
        for i in range(layers):
            p = f"blk.{i}"
            for norm in ("attn_norm", "attn_norm_2"):
                t[f"{p}.{norm}.weight"] = vec(dim, 1.0)
                t[f"{p}.{norm}.bias"] = vec(dim)
            t[f"{p}.attn_qkv.weight"] = m(qd + 2 * kvd, dim)
            t[f"{p}.attn_output.weight"] = m(dim, qd)
            t[f"{p}.ffn_up.weight"] = m(hid, dim)
            t[f"{p}.ffn_down.weight"] = m(dim, hid)
        return t, meta
    meta.update({f"{name}.expert_count": e,
                 f"{name}.expert_used_count": 1 if arch == "llama4" else 2,
                 f"{name}.expert_feed_forward_length": hid})
    if arch == "qwen2moe":
        meta["qwen2moe.expert_shared_feed_forward_length"] = hid
    if arch == "llama4":
        meta.update({"llama4.interleave_moe_layer_step": 1,
                     "llama4.no_rope_layer_interval": 2,
                     "llama4.attention.chunk_size": 64,
                     "llama4.attention.temperature_length": 64.0,
                     "llama4.attention.use_kq_norm": True})
    if arch == "glm4moe":
        meta.update({"glm4moe.leading_dense_block_count": 1,
                     "glm4moe.expert_gating_func": 2,
                     "glm4moe.expert_weights_norm": True,
                     "glm4moe.expert_weights_scale": 2.5,
                     "glm4moe.expert_group_count": 4,
                     "glm4moe.expert_group_used_count": 2,
                     "glm4moe.rope.dimension_count": hd // 2})
    if arch == "gpt-oss":
        meta["gpt-oss.attention.sliding_window"] = 128
    for i in range(layers):
        p = f"blk.{i}"
        t[f"{p}.attn_norm.weight"] = vec(dim, 1.0)
        t[f"{p}.ffn_norm.weight"] = vec(dim, 1.0)
        t[f"{p}.attn_q.weight"] = m(qd, dim)
        t[f"{p}.attn_k.weight"] = m(kvd, dim)
        t[f"{p}.attn_v.weight"] = m(kvd, dim)
        t[f"{p}.attn_output.weight"] = m(dim, qd)
        if arch in ("gpt-oss", "glm4moe"):
            t[f"{p}.attn_q.bias"] = vec(qd)
            t[f"{p}.attn_k.bias"] = vec(kvd)
            t[f"{p}.attn_v.bias"] = vec(kvd)
        if arch == "gpt-oss":
            t[f"{p}.attn_output.bias"] = vec(dim)
            t[f"{p}.attn_sinks.weight"] = vec(heads)
        if arch in ("qwen3moe", "glm4moe"):
            t[f"{p}.attn_q_norm.weight"] = vec(hd, 1.0)
            t[f"{p}.attn_k_norm.weight"] = vec(hd, 1.0)
        if arch == "glm4moe" and i == 0:
            t[f"{p}.ffn_gate.weight"] = m(2 * hid, dim)
            t[f"{p}.ffn_up.weight"] = m(2 * hid, dim)
            t[f"{p}.ffn_down.weight"] = m(dim, 2 * hid)
            continue
        bank = ((lambda *s: _mxfp4_blocks(rng, s)) if arch == "gpt-oss"
                else m)
        t[f"{p}.ffn_gate_inp.weight"] = (3.0 * m(e, dim)[0], GGML_F32)
        t[f"{p}.ffn_gate_exps.weight"] = bank(e, hid, dim)
        t[f"{p}.ffn_up_exps.weight"] = bank(e, hid, dim)
        t[f"{p}.ffn_down_exps.weight"] = bank(e, dim, hid)
        if arch == "gpt-oss":
            t[f"{p}.ffn_gate_inp.bias"] = vec(e)
            t[f"{p}.ffn_gate_exps.bias"] = (0.1 * m(e, hid)[0], GGML_F32)
            t[f"{p}.ffn_up_exps.bias"] = (0.1 * m(e, hid)[0], GGML_F32)
            t[f"{p}.ffn_down_exps.bias"] = (0.1 * m(e, dim)[0], GGML_F32)
        if arch in ("qwen2moe", "llama4", "glm4moe"):
            t[f"{p}.ffn_gate_shexp.weight"] = m(hid, dim)
            t[f"{p}.ffn_up_shexp.weight"] = m(hid, dim)
            t[f"{p}.ffn_down_shexp.weight"] = m(dim, hid)
        if arch == "qwen2moe":
            t[f"{p}.ffn_gate_inp_shexp.weight"] = m(1, dim)
        if arch == "glm4moe":
            t[f"{p}.exp_probs_b.bias"] = vec(e, -0.3)
    return t, meta


def moe_cli(dev, llm, runner_mod, tokenizer_mod, checkpoint, cli,
            counters) -> dict:
    """(d): each MOE_GGUF_ARCHES file through ``inspect``, ``convert --bits
    8`` (and ``--bits 4`` for MOE_GGUF_BITS4) and ``generate`` on the card
    (the CLI, in-process); then each checkpoint's MOE_GGUF_TOKENS greedy
    ids on the card equal the CPU's, float leaves widened to f32 on both
    (as phase 16 (c))."""
    out = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_moe_") as tmp:
        for arch in MOE_GGUF_ARCHES:
            path = os.path.join(tmp, f"{arch}.gguf")
            tensors, meta = moe_gguf(arch, SEED)
            write_gguf(path, tensors, meta)
            rc, text, _ = run_cli(cli, ["inspect", path])
            if rc != 0 or not text.strip():
                raise AssertionError(f"phase 17 {arch}: inspect exited {rc}")
            for bits in ((8, 4) if arch == MOE_GGUF_BITS4 else (8,)):
                tag = f"{arch} --bits {bits}"
                ckpt = os.path.join(tmp, f"{arch}-{bits}")
                rc, text, conv_s = run_cli(cli, ["convert", path, "-o", ckpt,
                                                 "--bits", str(bits)])
                if rc != 0:
                    raise AssertionError(f"phase 17 {tag}: convert exited "
                                         f"{rc}")
                for fn in counters.values():
                    fn.launches = 0
                rc, text, gen_s = run_cli(cli, [
                    "generate", ckpt, "-p", "descreva a cena",
                    "--max-tokens", str(MOE_GGUF_TOKENS), "--temperature",
                    "0"])
                launches = {k: fn.launches for k, fn in counters.items()}
                if rc != 0:
                    raise AssertionError(f"phase 17 {tag}: generate exited "
                                         f"{rc} and printed {text!r}")
                ran = ("q8_matmul",) if bits == 8 else (
                    "q4_matmul_w4a8", "quantize_activations")
                expect_routes(launches, ran, ("q4_matmul_f32a",
                                              *DIAGNOSTIC),
                              f"phase 17 {tag}")
                ids = []
                for device in (dev, torch.device("cpu")):
                    params, cfg, meta = checkpoint.load_checkpoint(
                        ckpt, device=device)
                    r = runner_mod.LLMRunner(
                        _widened(params), cfg,
                        tokenizer_mod.tokenizer_from_spec(
                            meta["tokenizer_spec"]),
                        runner_mod.GenerationConfig(
                            max_tokens=MOE_GGUF_TOKENS, temperature=0.0,
                            speculative=False),
                        cache_dtype=torch.float32, device=device)
                    r.generate("descreva a cena a sua frente")
                    ids.append(r.generated_ids)
                log(f"  {tag}: convert {conv_s:.2f} s, generate exit {rc} "
                    f"in {gen_s:.2f} s; card ids == cpu ids: "
                    f"{ids[0] == ids[1]} ({len(ids[0])} ids); experts "
                    f"{cfg.n_experts} top-{cfg.n_experts_used}, router "
                    f"{cfg.moe_score_func}")
                if ids[0] != ids[1] or not ids[0]:
                    raise AssertionError(f"phase 17 {tag}: card ids {ids[0]} "
                                         f"against cpu ids {ids[1]}")
                out[tag] = {"convert_s": conv_s, "generate_s": gen_s,
                            "ids": len(ids[0]), "launches": launches}
    return out


def moe_profile_child() -> dict:
    """(a)'s profile in a process of its own (this script with
    MOE_PROFILE_FLAG): ``profile_path`` of gpt-oss-20b over
    MOE_PROFILE_TOKENS decode tokens."""
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), MOE_PROFILE_FLAG],
        capture_output=True, text=True, timeout=MOE_PROFILE_TIMEOUT)
    lines = proc.stdout.strip().splitlines()
    if proc.returncode != 0 or not lines:
        raise AssertionError(f"phase 17: the profile's process exited "
                             f"{proc.returncode}: {proc.stderr[-2000:]}")
    for line in lines[:-1]:
        log(line)
    return json.loads(lines[-1])


def moe_profile_main(dev) -> int:
    """The child of ``moe_profile_child``."""
    from trackiellm_tpu_torch.llm import runner as runner_mod
    from trackiellm_tpu_torch.llm import tokenizer as tokenizer_mod
    from trackiellm_tpu_torch.models import llm
    from trackiellm_tpu_torch.ops import _build
    _build.library()
    name = "gpt_oss_20b"
    w4a8 = launch_counters()["q4_matmul_w4a8"]
    cfg = moe_cfg(llm, name, MOE_GPTOSS_LAYERS, MOE_GPTOSS_MAX_SEQ)
    params = moe_model(dev, llm, cfg, name)
    prof = profile_path(dev, runner_mod, tokenizer_mod, params, cfg,
                        tokens=MOE_PROFILE_TOKENS, lookahead=1)
    # The runner decodes a lookahead chunk ahead of the tokens it has
    # given, so the window's decode steps exceed its tokens: one step's
    # W4A8 launches (counted on a step alone) give the steps.
    cache = llm.KVCache.create(cfg, max_seq=64, device=dev)
    _, cache = llm.prefill(params, cfg, torch.zeros(64, dtype=torch.long,
                                                    device=dev), 8, cache)
    before = w4a8.launches
    llm.decode_step(params, cfg, 1, cache)
    per_step = w4a8.launches - before
    dec = prof["decode"]
    if "wrapper_launches" in dec:
        steps = dec["wrapper_launches"]["q4_matmul_w4a8"] / per_step
        dec["steps_per_token"] = steps
        dec["per_step"] = {k: dec[k] / steps for k in (
            "wall_ms", "busy_ms", "launches")}
        log(f"  {name} decode: {steps:.3f} steps a token ({per_step} W4A8 "
            f"launches a step); a step {dec['per_step']}")
    print(json.dumps({name: prof}), flush=True)
    return 0


def phase_moe(dev, llm, runner_mod, tokenizer_mod, server_mod, paging,
              measure, checkpoint, quant, cli, counters, profile) -> dict:
    """Phase 17 (the comment above MOE_TOKENS). Returns the ``moe`` line's
    numbers and the launches of (a)'s generate path."""
    t0 = time.perf_counter()
    out, parts = {}, {}

    def lap(part: str) -> None:
        parts[part] = time.perf_counter() - t0 - sum(parts.values())
        log(f"  phase 17 ({part}) took {parts[part]:.1f} s")
    cfg = moe_cfg(llm, "gpt_oss_20b", MOE_GPTOSS_LAYERS, MOE_GPTOSS_MAX_SEQ)
    params = moe_model(dev, llm, cfg, "gpt_oss_20b")
    gptoss = family_generate(dev, llm, runner_mod, tokenizer_mod, params, cfg,
                             counters, "gpt_oss_20b", tokens=MOE_TOKENS,
                             phase="phase 17", warm=4)
    gptoss["serve"] = moe_serve(dev, llm, tokenizer_mod, server_mod, paging,
                                measure, params, cfg, counters)
    del params
    torch.cuda.empty_cache()
    gptoss["int8_pool"] = moe_pool(dev, llm, tokenizer_mod, server_mod,
                                   paging, measure)
    out["gpt_oss_20b"] = gptoss
    lap("a")
    out["qwen3_moe_30b_a3b"] = moe_qwen3(dev, llm, runner_mod, tokenizer_mod,
                                         counters, MOE_QWEN3_LAYERS)
    torch.cuda.empty_cache()
    lap("b")
    out["profile"] = profile()
    for name, prof in out["profile"].items():
        dec = prof.get("decode", {})
        log(f"  {name} profile, a decode token: wall {dec.get('wall_ms')} "
            f"ms, busy {dec.get('busy_ms')} ms, idle share "
            f"{dec.get('idle_share')}, {dec.get('launches')} launches; a "
            f"decode step {dec.get('per_step')}")
    lap("profiles")
    out["sweep"] = {}
    for name in MOE_SWEEP:
        out["sweep"][name] = moe_sweep(dev, llm, quant, name, 4, MOE_BUCKETS)
        torch.cuda.empty_cache()
    name, bucket = MOE_SWEEP_Q8
    out["sweep"][f"{name} Q8"] = moe_sweep(dev, llm, quant, name, 8,
                                           (bucket,))
    out["chunks"] = moe_chunks(dev, llm)
    lap("c")
    out["gguf"] = moe_cli(dev, llm, runner_mod, tokenizer_mod, checkpoint,
                          cli, counters)
    lap("d")
    out["launches"] = out["gpt_oss_20b"]["launches"]
    out["seconds"] = time.perf_counter() - t0
    out["part_seconds"] = parts
    log(f"  phase 17 took {out['seconds']:.1f} s")
    return out


# Phase 18: the multimodal path. (a) LLaVA-1.5-7B
# (llava-hf/llava-1.5-7b-hf config.json: a Llama text model of dim 4096, 32
# layers, 32 heads and 32 KV heads, hidden 11,008, vocab 32,064, rope theta
# 1e4, RMS eps 1e-5, max_seq cut from 4096 to VLM_MAX_SEQ; the CLIP
# ViT-L/14-336 tower, 24 layers of 1024, 16 heads, 4096 MLP, quick-GELU,
# the -2 feature tap without CLS, 576 image rows; the 1024 -> 4096 -> 4096
# GELU projector) at full width and depth: random Q4 weights (q4_group's
# group, 128) and an f32 tower from the seed behind ``VLMRunner``; a seeded
# 480x640 frame on the card, the cortex's system prompt and a context with
# "Imagem da câmera: <image>", then a question, VLM_TOKENS greedy tokens at
# lookahead 4 and 1 (equal ids), the same frame again (its prefix reused
# past the image run) and another frame (rolled back to before it). (b)
# Card against CPU: the CLIP tower at full depth (VLM_FEAT_TOL), LLaVA's
# text model cut to VLM_CUT_LAYERS on the card's projected features
# (WIDTH_TOL), and PaliGemma-3B (google/paligemma-3b-pt-224: SigLIP-So400m/14
# at 224, 27 layers of 1152, 16 heads, 4304 MLP, no CLS, the post-LN tap,
# 256 image rows, one linear to 2048; Gemma-2B of dim 2048, 18 layers, 8
# heads and 1 KV head at D = 256, hidden 16,384, vocab 257,216, a prefix-LM)
# with SigLIP at full depth and Gemma cut to VLM_CUT_LAYERS: features, the
# prefix-LM prefill and VLM_PALI_DECODE decode tokens. (c) A clip.cpp
# mmproj GGUF at ViT-L widths cut to VLM_MMPROJ_LAYERS beside phase 11's
# text GGUF through ``convert --mmproj`` and ``generate --image``. (d) A
# cortex turn with ``vlm_scene_image`` over (a)'s runner inside
# ``TrackieApp``, the frame injected as the camera worker injects it.
VLM_MAX_SEQ = 2048
# 16 until phase 23 joined, to pay for it: phase 18 (a) took 5.1 s at 16,
# 3.4 s at 8 (two whole runs on an H100 80GB HBM3 at 700 W).
VLM_TOKENS = 8
VLM_CUT_LAYERS = 2
VLM_FEAT_TOL = 1e-5      # rel L2, f32 tower features, card against CPU
VLM_PALI_DECODE = 8
VLM_PALI_PROMPT = "caption en\n"
VLM_MMPROJ_LAYERS = 2
VLM_GGUF_TOKENS = 8
VLM_QUESTION = "O que há à minha frente?"
VLM_CORTEX_TIMEOUT = 120.0


def vlm_configs(llm, clip) -> dict:
    """{"llava": (LLMConfig, CLIPVisionConfig), "paligemma": (...)} at their
    published widths and depths (the comment above VLM_MAX_SEQ)."""
    llava = llm.LLMConfig(
        vocab_size=32064, dim=4096, n_layers=32, n_heads=32, n_kv_heads=32,
        head_dim=128, hidden_dim=11008, norm_eps=1e-5, rope_theta=1e4,
        max_seq=VLM_MAX_SEQ, sliding_window=VLM_MAX_SEQ)
    gemma = llm.LLMConfig(
        vocab_size=257216, dim=2048, n_layers=18, n_heads=8, n_kv_heads=1,
        head_dim=256, hidden_dim=16384, norm_eps=1e-6, rope_theta=1e4,
        max_seq=8192, sliding_window=8192, act="gelu")
    return {"llava": (llava, clip.CLIPVisionConfig(proj_dim=llava.dim)),
            "paligemma": (gemma,
                          clip.CLIPVisionConfig.siglip_so400m_224(gemma.dim))}


def vlm_models(dev, llm, clip, cfg, ccfg, name: str):
    """Random Q4 text params (``q4_group``'s group) and an f32 tower of
    ``ccfg`` from the seed, on the card."""
    t0 = time.perf_counter()
    params = llm.init_params_quantized(
        torch.Generator(device=dev).manual_seed(SEED), cfg,
        group=q4_group(cfg), device=dev)
    cparams = clip.init_params(
        ccfg, torch.Generator(device=dev).manual_seed(SEED + 1))
    torch.cuda.synchronize()
    log(f"  {name}: {cfg.n_layers} layers Q4 group {q4_group(cfg)} "
        f"({param_bytes(params) / 2 ** 30:.2f} GiB), tower of "
        f"{ccfg.n_layers} layers f32 ({param_bytes(cparams) / 2 ** 30:.2f} "
        f"GiB) in {time.perf_counter() - t0:.1f} s")
    return params, cparams


def vlm_ids(tok, prompt: str, n_img: int, marker: str = "<image>"):
    """(ids, image run start) of a one-image prompt as ``VLMRunner``
    builds them."""
    head, tail = prompt.split(marker)
    ids = tok.encode(head, add_bos=True)
    start = len(ids)
    return ids + [0] * n_img + (tok.encode(tail) if tail else []), start


def vlm_spliced(llm, params, ids, start: int, feats, dev):
    """(padded ids, embeddings) of the prefill bucket of ``ids`` on
    ``dev``: the token rows with ``feats`` over the image run's."""
    from trackiellm_tpu_torch.llm.runner import PREFILL_BUCKETS, _bucket_for
    padded = torch.zeros(_bucket_for(len(ids), PREFILL_BUCKETS),
                         dtype=torch.long)
    padded[:len(ids)] = torch.tensor(ids)
    padded = padded.to(dev)
    x = llm.embed_tokens(params, padded)
    x[start:start + feats.shape[0]] = feats.to(dev, x.dtype)
    return padded, x


def vlm_llava(dev, llm, clip, runner_mod, vlm_mod, tokenizer_mod, quant,
              counters, cfg, ccfg):
    """(a): LLaVA behind ``VLMRunner`` (the comment above VLM_MAX_SEQ).
    Returns its numbers and (params, tower params, the lookahead-4 runner,
    the frames) for (b) and (d). Every counter is zeroed just before the
    lookahead-4 turns and read just after; the plain Q4 matmul must not
    run."""
    from trackiellm_tpu_torch.cortex.main import CortexConfig
    from trackiellm_tpu_torch.llm.runner import PREFILL_BUCKETS, _bucket_for
    params, cparams = vlm_models(dev, llm, clip, cfg, ccfg, "llava-1.5-7b")
    frames = [torch.from_numpy(vision_frame((480, 640), SEED + i)).to(dev)
              for i in (0, 1)]
    out = {"encode_ms": p50_ms(lambda: clip.encode_and_project(
        cparams, ccfg, clip.preprocess_clip(frames[0], ccfg)), iters=5)}
    # Every id of the SentencePiece spec prints text (byte tokens past 259
    # decode to nothing), so the reply (d) speaks is never empty.
    tok = tokenizer_mod.tokenizer_from_spec(spm_spec(cfg.vocab_size))

    def runner(lookahead):
        return vlm_mod.VLMRunner(
            params, cfg, cparams, ccfg, tok, runner_mod.GenerationConfig(
                max_tokens=VLM_TOKENS, temperature=0.0, speculative=False,
                lookahead=lookahead), device=dev)
    r1, r4 = runner(1), runner(4)
    prompt = r4.build_prompt(
        CortexConfig().system_prompt,
        f"{CONTEXT}\n\nImagem da câmera: {r4.IMAGE_MARKER}", VLM_QUESTION)
    text1 = r1.generate(prompt, images=[frames[0]])   # also the warm-up
    ids1 = r1.generated_ids
    del r1
    for fn in counters.values():
        fn.launches = 0
    watch = LogitWatch(llm)
    try:
        with plain_matmul_calls(quant) as plain_calls:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r4.prepare_generation(prompt, images=[frames[0]])
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            n_prompt = r4._host_len
            pre = {k: fn.launches for k, fn in counters.items()}
            while r4.generate_next_token() is not None:
                pass
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            ids4 = r4.generated_ids
            post = {k: fn.launches for k, fn in counters.items()}
            start = r4._image_runs[0][0]
            r4.generate(prompt, images=[frames[0]])
            same = r4.last_reuse
            r4.generate(prompt, images=[frames[1]])
            other = r4.last_reuse
    finally:
        n_logits = watch.close()
    launches = {k: fn.launches for k, fn in counters.items()}
    decode = {k: post[k] - pre[k] for k in post}
    out.update({
        "prompt_tokens": n_prompt, "image_start": start,
        "image_rows": ccfg.n_image_tokens,
        "bucket": _bucket_for(n_prompt, PREFILL_BUCKETS),
        "prefill_ms": (t1 - t0) * 1e3, "tokens": len(ids4),
        "decode_ms_per_token": (t2 - t1) * 1e3 / max(len(ids4), 1),
        "launches_per_token": sum(decode.values()) / max(len(ids4), 1),
        "prefill_launches": pre, "reuse_same_frame": same,
        "reuse_other_frame": other, "finite_logit_vectors": n_logits,
        "launches": launches})
    log(f"  llava-1.5-7b: frame to {ccfg.n_image_tokens} projected rows "
        f"{out['encode_ms']:.3f} ms (p50); prompt {n_prompt} tokens (bucket "
        f"{out['bucket']}) prefill {out['prefill_ms']:.2f} ms with the "
        f"encode, {len(ids4)} tokens at {out['decode_ms_per_token']:.2f} ms "
        f"and {out['launches_per_token']:.1f} launches a token; same frame "
        f"reused {same} rows, another frame {other} (its run starts at "
        f"{start}); launches {launches}")
    if not ids4 or ids4 != ids1:
        raise AssertionError(f"phase 18 llava: lookahead 4 gave {ids4}, "
                             f"lookahead 1 {ids1}")
    log(f"  llava-1.5-7b: lookahead 4 == lookahead 1 ({len(ids4)} ids); "
        f"the reply {text1[:60]!r}")
    if out["bucket"] <= quant.KERNEL_MAX_M:
        raise AssertionError(f"phase 18 llava: the prompt's bucket "
                             f"{out['bucket']} is W4A8's")
    expect_routes(pre, ("q4_matmul_f32a", "flash_attention"), (),
                  "phase 18 llava prefill")
    expect_routes(decode, ("q4_matmul_w4a8", "quantize_activations"),
                  ("q4_matmul_f32a", "flash_attention"),
                  "phase 18 llava decode")
    expect_no_plain(plain_calls, "phase 18 llava")
    if same < start + ccfg.n_image_tokens or other != start:
        raise AssertionError(f"phase 18 llava: reused {same} rows on the "
                             f"same frame and {other} on another (the image "
                             f"run is [{start}, "
                             f"{start + ccfg.n_image_tokens}))")
    expect_routes(launches, ("q4_matmul_w4a8", "quantize_activations",
                             "flash_attention", "q4_matmul_f32a"),
                  ("q8_matmul", "fused_mlp_q4", *DIAGNOSTIC), "phase 18")
    return out, (params, cparams, r4, frames, prompt)


def vlm_tower(llm, clip, cparams, ccfg, frame, tag: str):
    """(b): the tower and projector on the card against the CPU on the
    card's normalized frame, each within VLM_FEAT_TOL; returns the card's
    projected rows and the errors."""
    px = clip.preprocess_clip(frame, ccfg)
    feats = clip.encode_image(cparams, ccfg, px)
    proj = clip.project_features(cparams, ccfg, feats)
    cpu = llm.params_to(cparams, torch.device("cpu"))
    cfeats = clip.encode_image(cpu, ccfg, px.cpu())
    cproj = clip.project_features(cpu, ccfg, cfeats)
    errs = {"features_rel_l2": rel_l2(feats.cpu(), cfeats),
            "projected_rel_l2": rel_l2(proj.cpu(), cproj)}
    log(f"  {tag} tower ({ccfg.n_layers} layers, {ccfg.n_run_layers()} run): "
        f"features {tuple(feats.shape)} rel_l2 {errs['features_rel_l2']:.3e},"
        f" projected {errs['projected_rel_l2']:.3e} card vs cpu (tol "
        f"{VLM_FEAT_TOL:.0e})")
    if not (torch.isfinite(proj).all()
            and max(errs.values()) < VLM_FEAT_TOL):
        raise AssertionError(f"phase 18 {tag} tower: {errs}")
    return proj, errs


def vlm_cpu_side(quant, params):
    """The CPU's side of a sweep (phase 17's): the matrices dequantized
    once, and the W4A8 groups whose activations it quantizes."""
    cpu = dequantized_on_cpu(quant, params)
    groups = (w4a8_groups(quant, params, cpu)
              if params["tok_emb"].device.type == "cuda" else {})
    return cpu, groups


def vlm_llava_text(dev, llm, quant, params, cfg, feats, prompt_ids,
                   start: int) -> dict:
    """(b): LLaVA's text model cut to VLM_CUT_LAYERS, the spliced prefill
    on the card against the CPU (within WIDTH_TOL)."""
    from trackiellm_tpu_torch.tools.diag_envelope import layer_slice
    cut_cfg = cfg._replace(n_layers=VLM_CUT_LAYERS)
    cut = layer_slice(params, VLM_CUT_LAYERS)
    padded, x = vlm_spliced(llm, cut, prompt_ids, start, feats, dev)
    n = len(prompt_ids)
    lg, _ = llm.prefill(cut, cut_cfg, padded, n,
                        llm.KVCache.create(cut_cfg, device=dev), embeds=x)
    cpu, groups = vlm_cpu_side(quant, cut)
    with w4a8_activations(llm, quant, groups):
        lc, _ = llm.prefill(cpu, cut_cfg, padded.cpu(), n,
                            llm.KVCache.create(cut_cfg, device="cpu"),
                            embeds=x.cpu())
    err = rel_l2(lg.cpu(), lc)
    log(f"  llava text ({VLM_CUT_LAYERS} layers) spliced prefill, bucket "
        f"{padded.shape[0]}: rel_l2 card vs cpu {err:.3e} (tol "
        f"{WIDTH_TOL:.0e})")
    if not (torch.isfinite(lg).all() and err < WIDTH_TOL):
        raise AssertionError(f"phase 18 llava text: {err}")
    return {"layers": VLM_CUT_LAYERS, "bucket": padded.shape[0],
            "rel_l2": err}


def vlm_paligemma(dev, llm, clip, quant, tokenizer_mod, cfg, ccfg,
                  frame) -> dict:
    """(b): PaliGemma with SigLIP at full depth and Gemma cut to
    VLM_CUT_LAYERS: the tower card against CPU, then the prefix-LM prefill
    (``bidir_len``) and VLM_PALI_DECODE decode tokens (the card's greedy
    ids, fed to both) within WIDTH_TOL; the prefill without ``bidir_len``
    must move the logits by more than the card-to-CPU error."""
    cut_cfg = cfg._replace(n_layers=VLM_CUT_LAYERS)
    params, cparams = vlm_models(dev, llm, clip, cut_cfg, ccfg,
                                 "paligemma-3b")
    feats, tower = vlm_tower(llm, clip, cparams, ccfg, frame, "siglip")
    del cparams
    tok = tokenizer_mod.ByteTokenizer(cfg.vocab_size)
    ids, start = vlm_ids(tok, "<image>" + VLM_PALI_PROMPT,
                         ccfg.n_image_tokens)
    padded, x = vlm_spliced(llm, params, ids, start, feats, dev)
    n = len(ids)
    lg, cg = llm.prefill(params, cut_cfg, padded, n,
                         llm.KVCache.create(cut_cfg, device=dev), embeds=x,
                         bidir_len=n)
    causal, _ = llm.prefill(params, cut_cfg, padded, n,
                            llm.KVCache.create(cut_cfg, device=dev),
                            embeds=x)
    cpu, groups = vlm_cpu_side(quant, params)
    errs = []
    with w4a8_activations(llm, quant, groups):
        lc, cc = llm.prefill(cpu, cut_cfg, padded.cpu(), n,
                             llm.KVCache.create(cut_cfg, device="cpu"),
                             embeds=x.cpu(), bidir_len=n)
        errs.append(rel_l2(lg.cpu(), lc))
        moved = rel_l2(causal.cpu(), lg.cpu())
        for _ in range(VLM_PALI_DECODE):
            tid = int(lg.argmax())
            lg, cg = llm.decode_step(params, cut_cfg, tid, cg)
            lc, cc = llm.decode_step(cpu, cut_cfg, tid, cc)
            if not torch.isfinite(lg).all():
                raise AssertionError("phase 18 paligemma: decode logits")
            errs.append(rel_l2(lg.cpu(), lc))
    log(f"  paligemma text ({VLM_CUT_LAYERS} layers) prefix-LM prefill of "
        f"{n} tokens (bucket {padded.shape[0]}): rel_l2 card vs cpu "
        f"{errs[0]:.3e}, {VLM_PALI_DECODE} decode tokens max "
        f"{max(errs[1:]):.3e} (tol {WIDTH_TOL:.0e}); without bidir_len the "
        f"logits move {moved:.3e}")
    if not max(errs) < WIDTH_TOL:
        raise AssertionError(f"phase 18 paligemma: rel L2 {errs}")
    if not moved > errs[0]:
        raise AssertionError(f"phase 18 paligemma: bidir_len moved the "
                             f"logits {moved}, within the card-to-CPU "
                             f"error {errs[0]}")
    return {"tower": tower, "layers": VLM_CUT_LAYERS, "prompt_tokens": n,
            "bucket": padded.shape[0], "prefill_rel_l2": errs[0],
            "decode_rel_l2_max": max(errs[1:]), "bidir_moved": moved}


def mmproj_gguf(ccfg, text_dim: int, seed: int):
    """(tensors, metadata) of a clip.cpp "mmproj" GGUF of ``ccfg``'s tower
    (its n_layers blocks all stored) with LLaVA's two-layer projector to
    ``text_dim``, as ``write_gguf`` takes them: f16 matrices and patch
    embedding, f32 norms, biases and embeddings, seeded."""
    rng = np.random.default_rng(seed)
    d, hid, p = ccfg.dim, ccfg.hidden_dim, ccfg.patch_size

    def f16(*shape):
        return rng.normal(0.0, 0.02, shape).astype(np.float16), GGML_F16

    def f32(*shape, base=0.0, scale=0.02):
        return (base + rng.normal(0.0, scale, shape)).astype(
            np.float32), GGML_F32
    tensors = {"v.patch_embd.weight": f16(d, 3, p, p),
               "v.class_embd": f32(d),
               "v.position_embd.weight": f32(ccfg.n_patches + 1, d),
               "v.pre_ln.weight": f32(d, base=1.0, scale=0.1),
               "v.pre_ln.bias": f32(d)}
    for i in range(ccfg.n_layers):
        b = f"v.blk.{i}."
        for ln in ("ln1", "ln2"):
            tensors[b + ln + ".weight"] = f32(d, base=1.0, scale=0.1)
            tensors[b + ln + ".bias"] = f32(d)
        for name, shape in (("attn_q", (d, d)), ("attn_k", (d, d)),
                            ("attn_v", (d, d)), ("attn_out", (d, d)),
                            ("ffn_up", (hid, d)), ("ffn_down", (d, hid))):
            tensors[b + name + ".weight"] = f16(*shape)
            tensors[b + name + ".bias"] = f32(shape[0])
    tensors["mm.0.weight"] = f16(text_dim, d)
    tensors["mm.0.bias"] = f32(text_dim)
    tensors["mm.2.weight"] = f16(text_dim, text_dim)
    tensors["mm.2.bias"] = f32(text_dim)
    metadata = {
        "general.architecture": "clip", "clip.has_vision_encoder": True,
        "clip.has_llava_projector": True, "clip.projector_type": "mlp",
        "clip.use_gelu": False, "clip.vision.image_size": ccfg.image_size,
        "clip.vision.patch_size": p, "clip.vision.embedding_length": d,
        "clip.vision.feed_forward_length": hid,
        "clip.vision.block_count": ccfg.n_layers,
        "clip.vision.attention.head_count": ccfg.n_heads,
        "clip.vision.attention.layer_norm_epsilon": ccfg.norm_eps,
        "clip.vision.projection_dim": text_dim,
    }
    return tensors, metadata


def vlm_mmproj(dev, llm, convert, checkpoint, quant, cli, counters,
               text_gguf: str, workdir: str, ccfg) -> dict:
    """(c): an mmproj of ``ccfg``'s widths cut to VLM_MMPROJ_LAYERS beside
    ``text_gguf`` through ``convert --bits 4 --mmproj`` and ``generate
    --image`` in-process: the checkpoint's vision leaves byte-equal to the
    CPU's conversion, the text printed, W4A8, its quantization, f32a (the
    576 image rows take the prompt past 512) and flash launched, the plain
    matmul never run."""
    from trackiellm_tpu_torch.models import loader
    text_dim = int(loader.read_gguf_header(text_gguf).metadata[
        "llama.embedding_length"])
    mcfg = ccfg._replace(n_layers=VLM_MMPROJ_LAYERS)
    path = os.path.join(workdir, "mmproj.gguf")
    ckpt = os.path.join(workdir, "llava_ckpt")
    frame_path = os.path.join(workdir, "frame.npy")
    out = {"file_bytes": write_gguf(path, *mmproj_gguf(mcfg, text_dim,
                                                        SEED + 2))}
    np.save(frame_path, vision_frame((480, 640), SEED + 2))
    rc, text, out["convert_s"] = run_cli(cli, [
        "convert", text_gguf, "-o", ckpt, "--bits", "4", "--mmproj", path])
    if rc != 0:
        raise AssertionError(f"phase 18: convert --mmproj exited {rc}")
    vparams, vcfg, meta = checkpoint.load_checkpoint(
        os.path.join(ckpt, "vision"), device=dev)
    cparams, ccfg_cpu = convert.gguf_to_clip_params(path, device="cpu")
    got, want = dict(_flat(vparams)), dict(_flat(cparams))
    equal = sum(_same_bytes(got[k], want[k]) for k in want)
    out.update({"leaves": len(want), "equal_leaves": equal,
                "feature_layer": vcfg.feature_layer})
    log(f"  mmproj ({VLM_MMPROJ_LAYERS} blocks at {mcfg.dim} wide, to "
        f"{text_dim}): {out['file_bytes'] / 1e6:.1f} MB, convert --mmproj "
        f"exit 0 in {out['convert_s']:.1f} s; {equal} of {len(want)} vision "
        f"leaves byte-equal to the CPU's conversion; config equal: "
        f"{vcfg == ccfg_cpu}")
    if equal != len(want) or set(got) != set(want) or vcfg != ccfg_cpu:
        raise AssertionError("phase 18: the mmproj leaves on the card are "
                             "not the CPU's")
    del vparams, cparams
    for fn in counters.values():
        fn.launches = 0
    watch = LogitWatch(llm)
    try:
        with plain_matmul_calls(quant) as plain_calls:
            rc, text, out["generate_s"] = run_cli(cli, [
                "generate", ckpt, "-p", "Descreva a cena.", "--max-tokens",
                str(VLM_GGUF_TOKENS), "--temperature", "0", "--image",
                frame_path])
    finally:
        n_logits = watch.close()
    out["launches"] = {k: fn.launches for k, fn in counters.items()}
    log(f"  generate --image: exit {rc} in {out['generate_s']:.2f} s, "
        f"{n_logits} finite logit vectors, printed {text.strip()[:60]!r}; "
        f"launches {out['launches']}")
    if rc != 0 or not text.strip():
        raise AssertionError(f"phase 18: generate --image exited {rc} and "
                             f"printed {text!r}")
    expect_no_plain(plain_calls, "phase 18 mmproj")
    expect_routes(out["launches"], ("q4_matmul_w4a8", "quantize_activations",
                                    "q4_matmul_f32a", "flash_attention"),
                  ("q8_matmul", "fused_mlp_q4", *DIAGNOSTIC),
                  "phase 18 mmproj")
    return out


def vlm_cortex(dev, runner, frame) -> dict:
    """(d): ``TrackieApp`` with (a)'s runner, ``vlm_scene_image`` on and a
    TTS stub: the frame injected as the camera worker injects it (uploaded
    by ``to_device_async``), then a question; the frame must reach
    ``encode_image`` as that card tensor, the reply must be spoken at its
    priority and ``failures()`` must be empty."""
    from trackiellm_tpu_torch.app import TrackieApp
    from trackiellm_tpu_torch.runtime.buffers import to_device_async
    seen, spoken = [], []
    encode = runner.encode_image
    runner.encode_image = lambda image: (seen.append(image), encode(image))[1]
    app = TrackieApp(llm_runner=runner,
                     tts_fn=lambda text: np.zeros(1600, np.float32),
                     on_spoken_audio=lambda wav, p: spoken.append(int(p)),
                     device=dev)
    app.cortex.config.vlm_scene_image = True
    app.start()
    try:
        t0 = time.perf_counter()
        card_frame = to_device_async(frame, dev)
        app.cortex.inject_video_frame(card_frame)
        app.cortex.inject_user_text(VLM_QUESTION)
        deadline = t0 + VLM_CORTEX_TIMEOUT
        while (not any(p <= APP_REPLY_PRIORITY for p in spoken)
               and time.perf_counter() < deadline):
            time.sleep(0.05)
        reply_s = time.perf_counter() - t0
    finally:
        app.stop()
        del runner.encode_image
    failures = app.failures()
    on_card = [isinstance(x, torch.Tensor) and x.device == card_frame.device
               for x in seen]
    out = {"reply_s": reply_s, "spoken": spoken, "frames_encoded": len(seen),
           "frame_is_the_card_tensor": all(x is card_frame for x in seen),
           "image_runs": len(runner._image_runs),
           "llm_ms": app.cortex.stats["last_llm_ms"],
           "failures": failures}
    log(f"  cortex turn: reply spoken in {reply_s:.2f} s (priorities "
        f"{spoken}), LLM turn {out['llm_ms']:.1f} ms; {len(seen)} frame(s) "
        f"reached encode_image as the card tensor: "
        f"{out['frame_is_the_card_tensor']}; failures {failures}")
    if (not seen or not all(on_card) or not out["frame_is_the_card_tensor"]
            or not any(p <= APP_REPLY_PRIORITY for p in spoken)
            or failures or not runner._image_runs):
        raise AssertionError(f"phase 18 cortex: {out}")
    return out


def phase_vlm(dev, llm, runner_mod, tokenizer_mod, quant, convert,
              checkpoint, cli, counters, text_gguf, workdir: str) -> dict:
    """Phase 18 (the comment above VLM_MAX_SEQ). ``text_gguf`` is phase
    11's file; with None, one is written here at phase 11's widths.
    Returns the ``vlm`` line's numbers and the launches of (a)'s path."""
    from trackiellm_tpu_torch.llm import vlm as vlm_mod
    from trackiellm_tpu_torch.models import clip
    t0 = time.perf_counter()
    out, parts = {}, {}

    def lap(part: str) -> None:
        parts[part] = time.perf_counter() - t0 - sum(parts.values())
        log(f"  phase 18 ({part}) took {parts[part]:.1f} s")
    cfgs = vlm_configs(llm, clip)
    (lcfg, lccfg), (gcfg, gccfg) = cfgs["llava"], cfgs["paligemma"]
    out["llava"], (params, cparams, runner, frames, prompt) = vlm_llava(
        dev, llm, clip, runner_mod, vlm_mod, tokenizer_mod, quant, counters,
        lcfg, lccfg)
    lap("a")
    feats, tower = vlm_tower(llm, clip, cparams, lccfg, frames[0], "clip")
    ids, start = vlm_ids(runner.tokenizer, prompt, lccfg.n_image_tokens)
    out["card_vs_cpu"] = {
        "clip": tower,
        "llava_text": vlm_llava_text(dev, llm, quant, params, lcfg, feats,
                                     ids, start)}
    del feats
    out["card_vs_cpu"]["paligemma"] = vlm_paligemma(
        dev, llm, clip, quant, tokenizer_mod, gcfg, gccfg, frames[0])
    torch.cuda.empty_cache()
    lap("b")
    if text_gguf is None:
        text_gguf = os.path.join(workdir, "mistral.gguf")
        cfg = llm.LLMConfig.mistral_7b()._replace(n_layers=GGUF_LAYERS)
        write_gguf(text_gguf, *mistral_gguf(cfg, spm_spec(cfg.vocab_size),
                                            SEED))
    out["mmproj"] = vlm_mmproj(dev, llm, convert, checkpoint, quant, cli,
                               counters, text_gguf, workdir, lccfg)
    lap("c")
    out["cortex"] = vlm_cortex(dev, runner, frames[0].cpu().numpy())
    del params, cparams, runner, frames
    torch.cuda.empty_cache()
    lap("d")
    out["launches"] = out["llava"]["launches"]
    out["seconds"] = time.perf_counter() - t0
    out["part_seconds"] = parts
    log(f"  phase 18 took {out['seconds']:.1f} s")
    return out


# Phase 19: the outer surfaces. The precompile child warms every stage at
# the JAX command's shapes (Mistral-7B Q4 at full width and depth, max_seq
# 1024); (d) drives Mistral-7B widths cut to SURFACES_LAYERS layers.
SURFACES_LAYERS = 2
SURFACES_TOKENS = 8
SURFACES_PROMPT = "descreva a cena a sua frente"
SURFACES_TOOL_CALL = '{"tool_call": {"name": "describe", "arguments": {}}}'
PRECOMPILE_TIMEOUT = 600.0
RESTORED_TIMEOUT = 300.0
# The restored library's child: nvcc may not run; one W4A8 launch.
RESTORED_CHILD = r"""
import json, time
import torch
from trackiellm_tpu_torch.ops import _build, quant
def no_nvcc():
    raise AssertionError("nvcc would have run")
_build._nvcc = no_nvcc
dev = torch.device("cuda", 0)
w = quant.quantize_q4(torch.randn((4096, 4096), device=dev, generator=
                      torch.Generator(device=dev).manual_seed(0)))
x = torch.randn((1, 4096), device=dev).to(torch.bfloat16)
y = quant.q4_matmul_w4a8(x, w.values, w.scales)
torch.cuda.synchronize()
print(json.dumps({"first_launch_unix": time.time(),
                  "last_build": _build.last_build,
                  "launches": quant.q4_matmul_w4a8.launches,
                  "finite": bool(torch.isfinite(y).all())}))
"""


def surfaces_precompile() -> dict:
    """(a) ``python3 -m trackiellm_tpu_torch precompile`` in a child: every
    stage warm, the library found (phase 2 built it), and the child's
    launches by kernel: W4A8, its quantization, flash and f32a (the
    bucket-1024 prefills)."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "trackiellm_tpu_torch", "precompile"],
        cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True,
        text=True, timeout=PRECOMPILE_TIMEOUT)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"phase 19 precompile exit {proc.returncode}:\n"
                             f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    for line in proc.stdout.splitlines()[:-1]:
        log(f"  precompile | {line}")
    report = json.loads(proc.stdout.splitlines()[-1])["precompile"]
    stages = [name for name, _ in report["stages"]]
    for stage in ("llm:", "server:", "asr:", "tts:", "vision:", "dpt:",
                  "vlm:"):
        if not any(name.startswith(stage) for name in stages):
            raise AssertionError(f"phase 19 precompile: no {stage} stage")
    if report["build"]["kernels"]["compiled"]:
        raise AssertionError("phase 19 precompile: nvcc ran again")
    launches = report["launches"]
    expect_routes(launches, ("q4_matmul_w4a8", "quantize_activations",
                             "flash_attention", "q4_matmul_f32a"),
                  ("q8_matmul", "fused_mlp_q4", *DIAGNOSTIC),
                  "phase 19 precompile")
    log(f"  precompile child: {wall:.1f} s wall, {report['seconds']:.1f} s "
        f"in the command; launches {launches}")
    return {"wall_s": wall, "seconds": report["seconds"],
            "stages": report["stages"], "build": report["build"],
            "launches": launches}


def surfaces_artifact(build_s: float, work: str) -> dict:
    """(b) ``cache_artifact`` pack of the built libraries, restore into an
    empty directory, then a child over that directory: no nvcc run, one
    W4A8 launch; its seconds from spawn to that launch beside phase 2's
    cold build."""
    from trackiellm_tpu_torch.tools import cache_artifact
    art = os.path.join(work, "kernels.tar.gz")
    fresh = os.path.join(work, "restored")
    packed = cache_artifact.pack(art)
    restored = cache_artifact.restore(art, fresh)
    if restored["mismatches"]:
        raise AssertionError(f"phase 19 restore: {restored['mismatches']}")
    env = dict(os.environ, TRACKIE_BUILD_DIR=fresh)
    spawn = time.time()
    proc = subprocess.run(
        [sys.executable, "-c", RESTORED_CHILD],
        cwd=os.path.dirname(os.path.abspath(__file__)), env=env,
        capture_output=True, text=True, timeout=RESTORED_TIMEOUT)
    if proc.returncode != 0:
        raise AssertionError(f"phase 19 restored child: {proc.stderr[-3000:]}")
    child = json.loads(proc.stdout.splitlines()[-1])
    first = child["first_launch_unix"] - spawn
    if (child["last_build"]["compiled"] or child["launches"] != 1
            or not child["finite"]
            or not child["last_build"]["path"].startswith(fresh)):
        raise AssertionError(f"phase 19 restored child: {child}")
    log(f"  cache artifact: {packed['bytes']} bytes, {len(packed['entries'])}"
        f" files; a fresh process launched W4A8 {first:.2f} s after spawn "
        f"with no nvcc run (phase 2's cold build {build_s:.1f} s)")
    return {"artifact_bytes": packed["bytes"], "entries": packed["entries"],
            "first_launch_s": first, "cold_build_s": build_s,
            "nvcc": packed["nvcc"]}


def surfaces_vision(dev):
    """(c)'s models: YOLOv8n at 640 and MiDaS-small at 384 (the pipeline's
    default inputs), random weights from the seed on the card; returns a
    factory of fresh ``VisionPipeline`` over them."""
    from trackiellm_tpu_torch.models import depth, detector
    from trackiellm_tpu_torch.vision.pipeline import VisionPipeline
    dcfg = detector.DetectorConfig.v8n()
    pcfg = depth.DepthConfig.small()._replace(img_size=384)
    dp = detector.init_detector(
        torch.Generator(device=dev).manual_seed(SEED + 190), dcfg)
    pp = depth.init_depth(
        torch.Generator(device=dev).manual_seed(SEED + 191), pcfg)
    fns = dict(detector_fn=lambda chw: detector.detector_forward(dp, dcfg,
                                                                 chw),
               depth_fn=lambda chw: depth.depth_forward(pp, pcfg, chw))
    return fns, lambda: VisionPipeline(device=dev, **fns)


def surfaces_ffi(dev, pipeline) -> dict:
    """(c) The native runtime on the card host, and a ``NativeContext``
    executor over the port's ``VisionPipeline``: a 480x640 frame handed
    over as a ``NativeVisionFrame``, through ``execute`` and
    ``execute_async`` + ``drain``, each on a fresh pipeline, bit for bit
    the direct ``process_frame``'s packed result."""
    from trackiellm_tpu_torch.ffi import embed, native
    if not native.native_available():
        raise AssertionError("phase 19: the native runtime did not build")
    frame = vision_frame((480, 640), SEED)
    t0 = time.perf_counter()
    want = embed.pack_vision_result(pipeline().process_frame(frame))
    torch.cuda.synchronize()
    direct_ms = (time.perf_counter() - t0) * 1e3
    vf = embed.NativeVisionFrame(640, 480)
    vf.write(frame)
    t = embed.NativeTensor.from_vision_frame(vf)
    ctx = embed.NativeContext()
    mod = embed.TK_MODULE_VISION
    ctx.register_python_module(mod, embed.vision_module(pipeline()),
                               device=dev)
    t0 = time.perf_counter()
    sync = ctx.execute(mod, "process_frame", t)
    sync_ms = (time.perf_counter() - t0) * 1e3
    ctx.unregister_module(mod)
    ctx.register_python_module(mod, embed.vision_module(pipeline()),
                               device=dev)
    results = []
    t0 = time.perf_counter()
    ctx.execute_async(mod, "process_frame", t,
                      lambda status, arr: results.append((status, arr)))
    ctx.drain()
    async_ms = (time.perf_counter() - t0) * 1e3
    ctx.close()
    t.close()
    vf.close()
    out = {"objects": int(want[0, 1]), "valid": int(want[0, 0]),
           "direct_ms": direct_ms, "execute_ms": sync_ms,
           "execute_async_ms": async_ms,
           "execute_equal": sync.tobytes() == want.tobytes(),
           "async_status": results[0][0] if results else None,
           "async_equal": bool(results) and results[0][1] is not None
           and results[0][1].tobytes() == want.tobytes()}
    log(f"  ffi: native runtime {native.library_path()}; the vision "
        f"executor's result equals the direct call's: execute "
        f"{out['execute_equal']}, execute_async {out['async_equal']} "
        f"({out['objects']} objects; {direct_ms:.1f} / {sync_ms:.1f} / "
        f"{async_ms:.1f} ms)")
    if not (out["execute_equal"] and out["async_equal"]
            and out["async_status"] == 0):
        raise AssertionError(f"phase 19 ffi: {out}")
    return out


def surfaces_compat(dev, llm, runner_mod, tokenizer_mod, vision_fns,
                    counters) -> tuple:
    """(d) A ``tk_*`` sequence through ``compat`` on the card: an LLM turn
    at Mistral-7B widths cut to SURFACES_LAYERS layers (8 greedy tokens
    through ``tk_llm_runner_generate_next_token``, equal to
    ``LLMRunner.generate``'s ids), a frame through
    ``tk_vision_pipeline_process_frame``, a tool call and the reply through
    ``tk_decision_engine_process_llm_response``, and a cortex created, fed
    text and stopped. Returns (its record, the runner)."""
    from trackiellm_tpu_torch import compat as tk
    cfg = llm.LLMConfig.mistral_7b()._replace(n_layers=SURFACES_LAYERS)
    params = llm.init_params_quantized(
        torch.Generator(device=dev).manual_seed(SEED + 192), cfg, bits=4,
        device=dev)

    def gen():
        return runner_mod.GenerationConfig(
            max_tokens=SURFACES_TOKENS, temperature=0.0, speculative=False)
    t0 = time.perf_counter()
    r = tk.tk_llm_runner_create(
        params, cfg, tokenizer=tokenizer_mod.ByteTokenizer(cfg.vocab_size),
        gen_config=gen())
    for w in counters.values():
        w.launches = 0
    tk.tk_llm_runner_prepare_generation(r, SURFACES_PROMPT)
    pieces = [tk.tk_llm_runner_generate_next_token(r)
              for _ in range(SURFACES_TOKENS)]
    torch.cuda.synchronize()
    turn_s = time.perf_counter() - t0
    launches = {k: w.launches for k, w in counters.items()}
    ids = list(r._generated_ids)
    ref = runner_mod.LLMRunner(
        params, cfg, tokenizer_mod.ByteTokenizer(cfg.vocab_size), gen())
    ref.generate(SURFACES_PROMPT)
    want = list(ref._generated_ids)
    # The prompt's bucket 64 takes the plain attention, not flash.
    expect_routes(launches, ("q4_matmul_w4a8", "quantize_activations"),
                  ("q8_matmul", "fused_mlp_q4", *DIAGNOSTIC),
                  "phase 19 compat")
    p = tk.tk_vision_pipeline_create(device=dev, **vision_fns)
    res = tk.tk_vision_pipeline_process_frame(p, vision_frame((480, 640),
                                                              SEED))
    tk.tk_vision_result_destroy(res)
    d = tk.tk_decision_engine_create()
    call = tk.tk_decision_engine_process_llm_response(d, SURFACES_TOOL_CALL)
    text = tk.tk_decision_engine_process_llm_response(d, "".join(
        x for x in pieces if x) or "ok")
    done = tk.tk_decision_engine_process_actions(d)
    cortex = tk.tk_cortex_create()
    tk.tk_cortex_run(cortex)
    tk.tk_cortex_inject_user_text(cortex, SURFACES_PROMPT)
    tk.tk_cortex_stop(cortex)
    state = tk.tk_cortex_get_state(cortex)
    tk.tk_cortex_destroy(cortex)
    out = {"layers": SURFACES_LAYERS, "ids": ids, "generate_ids": want,
           "turn_s": turn_s, "launches": launches,
           "vision_objects": len(res.objects),
           "vision_valid": int(res.valid_analyses),
           "tool_call": call.is_tool_call, "reply_is_text": not
           text.is_tool_call, "actions": [(a.name, a.state.value)
                                         for a in done],
           "cortex_state": state}
    log(f"  compat: {len(ids)} ids through tk_llm_runner_generate_next_token"
        f" ({SURFACES_LAYERS} layers, {turn_s:.2f} s with the prefill) "
        f"equal to LLMRunner.generate's: {ids == want}; frame "
        f"{out['vision_objects']} objects; actions {out['actions']}; "
        f"cortex {state}")
    if (not ids or ids != want or not call.is_tool_call
            or text.is_tool_call or state != "shutdown"):
        raise AssertionError(f"phase 19 compat: {out}")
    return out, r


def surfaces_services(dev, runner, counters, work: str) -> dict:
    """(e) ``device_trace`` around one decode chunk of (d)'s runner (a new
    turn's prefill before it): the trace file must hold the W4A8 kernel;
    ``MetricsCollector.collect()`` must report the card's memory."""
    from trackiellm_tpu_torch import compat as tk
    from trackiellm_tpu_torch.services import MetricsCollector
    from trackiellm_tpu_torch.services.profiling import device_trace
    tk.tk_llm_runner_reset(runner)
    tk.tk_llm_runner_prepare_generation(runner, SURFACES_PROMPT + " agora")
    torch.cuda.synchronize()
    for w in counters.values():
        w.launches = 0
    with device_trace(os.path.join(work, "traces")) as prof:
        for _ in range(runner.gen.lookahead):
            tk.tk_llm_runner_generate_next_token(runner)
    counted = counters["q4_matmul_w4a8"].launches
    with open(prof.trace_path) as f:
        events = json.load(f)["traceEvents"]
    traced = sum(1 for e in events if e.get("cat") == "kernel"
                 and "q4_w4a8_kernel" in e.get("name", ""))
    metrics = MetricsCollector().collect()
    out = {"trace_bytes": os.path.getsize(prof.trace_path),
           "w4a8_in_trace": traced, "w4a8_counted": counted,
           "device_mem_used": metrics.get("device_mem_used"),
           "device_mem_limit": metrics.get("device_mem_limit"),
           "device_mem_card_used": metrics.get("device_mem_card_used")}
    if not traced or not out["device_mem_used"]:
        raise AssertionError(f"phase 19 services: {out}")
    log(f"  services: the trace ({out['trace_bytes']} bytes) holds {traced} "
        f"W4A8 kernels ({counted} launches counted); the card holds "
        f"{out['device_mem_used'] / 2 ** 30:.2f} GiB in tensors of "
        f"{out['device_mem_limit'] / 2 ** 30:.1f} GiB")
    return out


def phase_surfaces(dev, llm, runner_mod, tokenizer_mod, counters,
                   build_s: float, work: str) -> dict:
    """Phase 19: precompile (a), the cache artifact (b), the ffi executor
    (c), the compat sequence (d) and the services (e)."""
    marks = {"start": time.perf_counter()}
    out = {"precompile": surfaces_precompile()}
    marks["a"] = time.perf_counter()
    out["artifact"] = surfaces_artifact(build_s, work)
    marks["b"] = time.perf_counter()
    fns, pipeline = surfaces_vision(dev)
    out["ffi"] = surfaces_ffi(dev, pipeline)
    marks["c"] = time.perf_counter()
    out["compat"], runner = surfaces_compat(dev, llm, runner_mod,
                                            tokenizer_mod, fns, counters)
    marks["d"] = time.perf_counter()
    out["services"] = surfaces_services(dev, runner, counters, work)
    marks["e"] = time.perf_counter()
    keys = list(marks)
    out["part_seconds"] = {k: marks[k] - marks[p]
                           for p, k in zip(keys, keys[1:])}
    out["launches"] = out["precompile"]["launches"]
    return out


# Phase 20: the perception models the app plugs in, random weights from
# SEED at their published widths: all-MiniLM-L6-v2 (EmbedderConfig.minilm_l6,
# vocab 30,522), microsoft/trocr-base-printed (TrOCRConfig.base: 384-pixel
# image, 12+12 layers, d_model 1024, vocab 50,265),
# MIT/ast-finetuned-audioset-10-10-0.4593 (ASTConfig: 1,024 frames, 1,212
# patches, 12 layers at 768, 527 labels) and the reference's CNN
# (SoundClassifierConfig.default). (a) card against CPU under exact_f32:
# MiniLM and the CNN at full depth, TrOCR and AST cut to
# PERCEPTION_CPU_LAYERS; (b) each at full depth on the card, host-timed,
# and one window of each profiled in a child; (c) one TrackieApp turn with
# the three hooks attached and the Mistral-7B widths of phase 19 (d).
PERCEPTION_CPU_LAYERS = 2
PERCEPTION_FRAGMENTS = 64     # (b)'s memory fragments embedded in one call
# (b)'s host-timed repeats after a warm one: 3 until phase 23 joined, to
# pay for it: phase 20 (b) took 31.7 s at 3 (the OCR frame 1.17 s a
# call), 25.2 s at 1 (two whole runs on an H100 80GB HBM3 at 700 W).
PERCEPTION_ITERS = 1
PERCEPTION_REL = 1e-5         # rel L2 card against CPU: embeddings, states,
#                               logits
PERCEPTION_PROB_TOL = 1e-6    # max abs card against CPU: the CNN's output
PERCEPTION_NOISE_CAP = 1e-4   # TrOCR's teacher-forced logit gap over the
#                               largest logit, card against CPU
PERCEPTION_TOKENS = 12        # (c)'s reply tokens
PERCEPTION_TURN_TIMEOUT = 120.0
PERCEPTION_PROFILE_FLAG = "--perception-profile"
# TrOCR's decoder steps in the profiled OCR window: the engine's 64-step
# budget is about 56,500 launches, whose records took 13.0 s of
# ``key_averages()`` beside CUPTI's 12.3-s start; 16 steps to pay for phase
# 21 (phase 20 took 55.9 s at 64, 36.5-39.2 s at 16; on an H100 80GB HBM3
# at 700 W). The timed OCR frame of (b) keeps the whole budget.
PERCEPTION_PROFILE_OCR_STEPS = 16
PERCEPTION_QUESTION = "onde ficou a chave de casa?"
PERCEPTION_MEMORY = "a chave de casa ficou na mesa da cozinha"
AST_WINDOW_S = 10.24          # AST's 1,024 frames at a 10-ms hop
SOUND_WINDOW_S = 1.0          # the audio pipeline's passive window
# The words of the memory fragments; the rest of MiniLM's 30,522 pieces
# are fillers, with BERT's specials at their uncased-vocabulary ids.
PERCEPTION_WORDS = (
    "a chave de casa ficou na mesa da cozinha o remédio das horas fica "
    "gaveta do quarto porta azul saída fica à esquerda degrau escada "
    "ônibus passa às ponto perto mercado farmácia abre fecha maria ligou "
    "para você amanhã consulta médico dia rua número segunda terça "
    "quarta quinta sexta onde ? , .").split()
# AST's label list: the AMBIENT_MAP names at positions chosen here (not
# AudioSet's), fillers elsewhere.
AST_NAMED_LABELS = {0: "Speech", 74: "Dog", 75: "Bark",
                    288: "Water tap, faucet", 322: "Siren",
                    323: "Civil defense siren",
                    399: "Smoke detector, smoke alarm", 400: "Fire alarm"}


def perception_vocab(n: int) -> list:
    """MiniLM's WordPiece pieces: [PAD] at 0, [UNK], [CLS], [SEP], [MASK]
    at 100-103, PERCEPTION_WORDS as the uncased tokenizer sees them
    (accents stripped), digits and letters and their ## forms, then
    fillers up to ``n``."""
    import unicodedata
    head = [f"[unused{i}]" for i in range(100)]
    head[0] = "[PAD]"
    head += ["[UNK]", "[CLS]", "[SEP]", "[MASK]"]
    chars = [str(d) for d in range(10)] + [chr(c) for c in range(97, 123)]
    words = list(dict.fromkeys(
        "".join(c for c in unicodedata.normalize("NFD", w)
                if unicodedata.category(c) != "Mn")
        for w in PERCEPTION_WORDS))
    pieces = head + [w for w in words if w not in chars] + chars + [
        f"##{c}" for c in chars]
    return pieces + [f"w{i}" for i in range(n - len(pieces))]


def perception_fragments(n: int) -> list:
    """``n`` memory fragments from the seed, in PERCEPTION_WORDS."""
    rng = np.random.default_rng(SEED + 200)
    templates = ("o remédio das {h} horas fica na gaveta do quarto",
                 "a porta azul da saída fica à esquerda",
                 "o ônibus {h} passa às {h} horas no ponto perto do mercado",
                 "a farmácia da rua {h} abre às {h} horas",
                 "maria ligou para você , consulta médico dia {h}",
                 "cuidado com o degrau da escada na cozinha")
    return [templates[i % len(templates)].format(h=int(rng.integers(1, 24)))
            for i in range(n)]


def perception_models(dev) -> dict:
    """The four models' random params from the seed on the card, with
    their configurations, tokenizer and labels."""
    from trackiellm_tpu_torch.llm.tokenizer import WordPieceTokenizer
    from trackiellm_tpu_torch.models import ast, embedder, sound_classifier
    from trackiellm_tpu_torch.models import trocr

    def gen(k):
        return torch.Generator(device=dev).manual_seed(SEED + 200 + k)
    ecfg, tcfg = embedder.EmbedderConfig.minilm_l6(), trocr.TrOCRConfig.base()
    acfg, scfg = ast.ASTConfig(), sound_classifier.SoundClassifierConfig()
    labels = [AST_NAMED_LABELS.get(i, f"label {i}")
              for i in range(acfg.n_labels)]
    return {"embedder": (embedder.init_embedder(gen(1), ecfg), ecfg),
            "trocr": (trocr.init_params(gen(2), tcfg), tcfg),
            "ast": (ast.init_params(gen(3), acfg), acfg),
            "sound": (sound_classifier.init_sound_classifier(gen(4), scfg),
                      scfg),
            "tokenizer": WordPieceTokenizer(perception_vocab(
                ecfg.vocab_size)),
            "labels": labels}


def cut_layers(tree: dict, n: int) -> dict:
    """The first ``n`` layers of each stacked ``layers`` dict in ``tree``
    (views; a TrOCR tree holds two)."""
    out = {}
    for k, v in tree.items():
        if k == "layers":
            out[k] = {name: t[:n] for name, t in v.items()}
        elif isinstance(v, dict):
            out[k] = cut_layers(v, n)
        else:
            out[k] = v
    return out


def ocr_text(ids) -> str:
    """TrOCR ids as letters (no RoBERTa vocabulary ships here)."""
    return "".join(chr(97 + int(i) % 26) for i in ids)


def perception_card_vs_cpu_embedder(dev, models) -> dict:
    from trackiellm_tpu_torch.models import embedder, llm
    card, cfg = models["embedder"]
    cpu = llm.params_to(card, torch.device("cpu"))
    texts = [PERCEPTION_MEMORY, *perception_fragments(7)]
    out = {}
    for pooling in ("mean", "cls", "pooler"):
        c = cfg._replace(pooling=pooling)
        a = embedder.Embedder(card, c, models["tokenizer"]).embed(texts)
        b = embedder.Embedder(cpu, c, models["tokenizer"]).embed(texts)
        out[pooling] = float(np.linalg.norm(a - b) / np.linalg.norm(b))
    return {"layers": cfg.n_layers, "texts": len(texts), "rel_l2": out}


def trocr_parting(logits_cpu, logits_card, want, got, eos: int) -> dict:
    """Where ``got`` (the card's ids) first parts from ``want`` (the
    CPU's) before the CPU's first EOS, and whether that is a near-tie: the
    CPU's top-2 margin under twice the noise, the largest teacher-forced
    logit gap along the CPU's ids."""
    noise = float((logits_card - logits_cpu).abs().max())
    scale = float(logits_cpu.abs().max())
    end = want.index(eos) + 1 if eos in want else len(want)
    parted = next((s for s in range(end) if got[s] != want[s]), None)
    margin = None
    if parted is not None:
        top = torch.topk(logits_cpu[parted], 2).values
        margin = float(top[0] - top[1])
    return {"noise": noise, "scale": scale, "compared": end,
            "parted_at": parted, "margin": margin,
            "ok": noise <= PERCEPTION_NOISE_CAP * scale and (
                parted is None or margin < 2 * noise)}


def perception_card_vs_cpu_trocr(dev, models) -> dict:
    from trackiellm_tpu_torch.models import llm, trocr
    full, cfg = models["trocr"]
    n = PERCEPTION_CPU_LAYERS
    cfg = cfg._replace(enc_layers=n, dec_layers=n)
    card = cut_layers(full, n)
    cpu = llm.params_to(card, torch.device("cpu"))
    frame = vision_frame((480, 640), SEED + 201)
    eng = trocr.TrOCREngine(cpu, cfg, ocr_text)
    px = torch.stack([eng._prep(frame[:240, 320:]),
                      eng._prep(frame[240:, :320])])
    enc_c = trocr.encode_batch(cpu, cfg, px)
    enc_g = trocr.encode_batch(card, cfg, px.to(dev))
    ids_c = trocr.greedy_ids_batch(cpu, cfg, enc_c)
    ids_g = trocr.greedy_ids_batch(card, cfg, enc_g).cpu()
    rows, logit_rel = [], []
    for b in range(px.shape[0]):
        want = ids_c[b].tolist()
        x = torch.tensor([cfg.decoder_start_id] + want[:-1])
        lc = trocr.decoder_logits(cpu, cfg, enc_c[b], x)
        lg = trocr.decoder_logits(card, cfg, enc_c[b].to(dev),
                                  x.to(dev)).cpu()
        logit_rel.append(rel_l2(lg, lc))
        rows.append(trocr_parting(lc, lg, want, ids_g[b].tolist(),
                                  cfg.eos_id))
    return {"layers": n, "crops": px.shape[0],
            "encoder_rel_l2": rel_l2(enc_g.cpu(), enc_c),
            "logits_rel_l2": max(logit_rel), "ids": rows,
            "ids_equal": torch.equal(ids_c, ids_g)}


def perception_card_vs_cpu_ast(dev, models) -> dict:
    from trackiellm_tpu_torch.models import ast, llm
    full, cfg = models["ast"]
    n = PERCEPTION_CPU_LAYERS
    cfg = cfg._replace(n_layers=n)
    card = cut_layers(full, n)
    cpu = llm.params_to(card, torch.device("cpu"))
    audio = voice_signal(AST_WINDOW_S, 16000, SEED + 202)
    spec = torch.from_numpy(ast.ast_features(audio, cfg))
    a = ast.ast_logits(card, cfg, spec.to(dev)).cpu()
    b = ast.ast_logits(cpu, cfg, spec)
    alarm = models["labels"].index("Smoke detector, smoke alarm")
    forced = dict(card, head_b=card["head_b"] + 20.0 * torch.eye(
        cfg.n_labels, device=dev)[alarm])
    heard = ast.ASTSoundClassifier(forced, cfg, models["labels"])(audio)
    return {"layers": n, "tokens": cfg.n_patches + 2,
            "logits_rel_l2": rel_l2(a, b), "forced_alarm": heard}


def perception_card_vs_cpu_sound(dev, models) -> dict:
    from trackiellm_tpu_torch.audio.sound_engine import SoundClassifierEngine
    from trackiellm_tpu_torch.models import llm, sound_classifier
    card, cfg = models["sound"]
    cpu = llm.params_to(card, torch.device("cpu"))
    mel = torch.randn((cfg.n_mels, cfg.n_frames),
                      generator=torch.Generator().manual_seed(SEED + 203))
    err = float((sound_classifier.classify_window(card, cfg, mel.to(dev))
                 .cpu() - sound_classifier.classify_window(cpu, cfg, mel))
                .abs().max())
    audio = voice_signal(SOUND_WINDOW_S, 16000, SEED + 204)
    names = [SoundClassifierEngine(p, cfg, threshold=0.0, ignore=())(audio)
             for p in (card, cpu)]
    return {"max_abs_err": err, "classes": names}


def perception_card_vs_cpu(dev, models) -> dict:
    """(a): each model on the card and on the CPU on the same inputs."""
    out = {"embedder": perception_card_vs_cpu_embedder(dev, models),
           "trocr": perception_card_vs_cpu_trocr(dev, models),
           "ast": perception_card_vs_cpu_ast(dev, models),
           "sound": perception_card_vs_cpu_sound(dev, models)}
    e, t, a, s = (out[k] for k in ("embedder", "trocr", "ast", "sound"))
    parted = [r["parted_at"] for r in t["ids"]]
    log(f"  (a) card against CPU: MiniLM ({e['layers']} layers) rel L2 "
        + ", ".join(f"{k} {v:.3e}" for k, v in e["rel_l2"].items())
        + f"; TrOCR-base ({t['layers']}+{t['layers']} layers) encoder "
        f"{t['encoder_rel_l2']:.3e}, teacher-forced logits "
        f"{t['logits_rel_l2']:.3e}, greedy ids "
        + ("equal" if t["ids_equal"] else f"part at {parted}")
        + f" (noise {max(r['noise'] for r in t['ids']):.3e}); AST "
        f"({a['layers']} layers, {a['tokens']} tokens) logits "
        f"{a['logits_rel_l2']:.3e}, forced alarm -> {a['forced_alarm']}; "
        f"CNN probabilities max abs {s['max_abs_err']:.3e}, classes "
        f"{s['classes']} (tolerances rel {PERCEPTION_REL:g}, abs "
        f"{PERCEPTION_PROB_TOL:g})")
    bad = [k for k, v in e["rel_l2"].items() if not v <= PERCEPTION_REL]
    bad += [k for k in ("encoder_rel_l2", "logits_rel_l2")
            if not t[k] <= PERCEPTION_REL]
    bad += [f"ids row {i}" for i, r in enumerate(t["ids"]) if not r["ok"]]
    bad += ["ast logits"] * (not a["logits_rel_l2"] <= PERCEPTION_REL)
    bad += ["ast alarm"] * (a["forced_alarm"] != "alarm")
    bad += ["cnn"] * (not s["max_abs_err"] <= PERCEPTION_PROB_TOL
                      or s["classes"][0] != s["classes"][1])
    if bad:
        raise AssertionError(f"phase 20 (a): {bad}: {out}")
    return out


def perception_calls(dev, models) -> dict:
    """(b)'s four calls at full depth on the card, each taking a fresh
    input a call: {name: (what, fn(i))}."""
    from trackiellm_tpu_torch.audio.sound_engine import SoundClassifierEngine
    from trackiellm_tpu_torch.models import ast, embedder, trocr
    from trackiellm_tpu_torch.runtime.buffers import to_device_async
    from trackiellm_tpu_torch.vision import AnalysisFlags, VisionPipeline
    emb = embedder.Embedder(*models["embedder"], models["tokenizer"])
    frags = perception_fragments(PERCEPTION_FRAGMENTS)
    pipe = VisionPipeline(None, ocr_fn=trocr.TrOCREngine(
        *models["trocr"], ocr_text), device=dev)
    frames = [to_device_async(vision_frame((480, 640), SEED + 210 + i), dev)
              for i in range(PERCEPTION_ITERS + 2)]
    acls = ast.ASTSoundClassifier(*models["ast"], models["labels"])
    cnn = SoundClassifierEngine(*models["sound"])
    long_audio = [voice_signal(AST_WINDOW_S, 16000, SEED + 220 + i)
                  for i in range(PERCEPTION_ITERS + 2)]
    return {
        "embed": (f"Embedder.embed, {len(frags)} fragments",
                  lambda i: emb.embed(frags[i:] + frags[:i])),
        "ocr": ("VisionPipeline(ocr_fn=TrOCREngine) on a 480x640 card "
                "frame, OCR flag",
                lambda i: pipe.process_frame(frames[i], AnalysisFlags.OCR)),
        "ast": ("ASTSoundClassifier, 10.24-s window",
                lambda i: acls(long_audio[i])),
        "cnn": ("SoundClassifierEngine, 1-s window",
                lambda i: cnn(long_audio[i][:16000])),
    }


def perception_timed(dev, models) -> dict:
    """(b): each call's host ms between card synchronizations, the median
    of PERCEPTION_ITERS after a warm one, each on a fresh input."""
    from trackiellm_tpu_torch.vision import AnalysisFlags
    out = {}
    for name, (what, fn) in perception_calls(dev, models).items():
        res, _ = wall_ms(lambda: fn(0))
        ms = [wall_ms(lambda i=i: fn(i))[1]
              for i in range(1, PERCEPTION_ITERS + 1)]
        out[name] = {"what": what, "p50_ms": float(np.median(ms)),
                     "ms": ms}
        if name == "ocr":
            out[name]["regions"] = len(res.text_regions)
            if not res.valid_analyses & AnalysisFlags.OCR:
                raise AssertionError(f"phase 20 (b): the OCR stage failed: "
                                     f"{res}")
        elif name == "embed":
            if res.shape != (PERCEPTION_FRAGMENTS, models["embedder"][1]
                             .hidden) or not np.isfinite(res).all():
                raise AssertionError(f"phase 20 (b): embeddings {res.shape}")
    log("  (b) full depth on the card, host ms p50 of "
        f"{PERCEPTION_ITERS}: " + "; ".join(
            f"{v['what']} {v['p50_ms']:.2f}" for v in out.values()))
    return out


def perception_profile(dev) -> dict:
    """One window of each of (b)'s calls under the profiler after a warm
    one (TrOCR at PERCEPTION_PROFILE_OCR_STEPS decoder steps): host ms,
    device busy ms, launches, idle share, largest kernels."""
    models = perception_models(dev)
    params, cfg = models["trocr"]
    models["trocr"] = (params, cfg._replace(
        max_len=min(cfg.max_len, PERCEPTION_PROFILE_OCR_STEPS)))
    out = {}
    for name, (what, fn) in perception_calls(dev, models).items():
        fn(0)
        _, wall = wall_ms(lambda: fn(1))
        busy, launches, by_name = device_breakdown(lambda: fn(2))
        top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:3]
        out[name] = {"wall_ms": wall, "busy_ms": busy, "launches": launches,
                     "idle_share": 1.0 - busy / wall,
                     "top": [[k[:60], t, c] for k, (t, c) in top]}
        log(f"  profile {what}: {wall:.2f} ms wall, {busy:.2f} ms busy, "
            f"{launches} launches (idle {out[name]['idle_share']:.3f})")
    return out


def perception_profile_child() -> dict:
    """``perception_profile`` in a process of its own (this script with
    PERCEPTION_PROFILE_FLAG), as phases 12-14 profile."""
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), PERCEPTION_PROFILE_FLAG],
        capture_output=True, text=True, timeout=SERVE_TIMEOUT)
    lines = proc.stdout.strip().splitlines()
    if proc.returncode != 0 or not lines:
        raise AssertionError(f"phase 20: the profile's process exited "
                             f"{proc.returncode}: {proc.stderr[-2000:]}")
    for line in lines[:-1]:
        log(line)
    return json.loads(lines[-1])


def perception_app(dev, llm, runner_mod, models, counters) -> dict:
    """(c): TrackieApp with embed_fn (MiniLM), ocr_fn (TrOCR-base behind
    YOLOv8n and MiDaS-small), sound_fn (the CNN with its ALARM bias
    forced) and an LLM at Mistral-7B widths cut to SURFACES_LAYERS layers;
    a memory archived, then a question: the memory must be retrieved by
    cosine, the ALARM spoken at CRITICAL, the reply at its priority, the
    OCR run, failures() empty and the counters on W4A8, its quantization
    and flash."""
    from trackiellm_tpu_torch.app import AppSources, TrackieApp
    from trackiellm_tpu_torch.audio.sound_engine import SoundClassifierEngine
    from trackiellm_tpu_torch.cortex.decision import ActionPriority
    from trackiellm_tpu_torch.models import embedder, trocr
    from trackiellm_tpu_torch.models.sound_classifier import SoundClass
    from trackiellm_tpu_torch.tools.measure_app_e2e import (
        ScriptedTextTokenizer)
    cfg = llm.LLMConfig.mistral_7b()._replace(n_layers=SURFACES_LAYERS,
                                              max_seq=1024,
                                              sliding_window=1024)
    params = llm.init_params_quantized(
        torch.Generator(device=dev).manual_seed(SEED + 230), cfg, bits=4,
        device=dev)
    runner = runner_mod.LLMRunner(
        params, cfg, ScriptedTextTokenizer(cfg.vocab_size),
        runner_mod.GenerationConfig(max_tokens=PERCEPTION_TOKENS,
                                    min_tokens=PERCEPTION_TOKENS,
                                    temperature=0.0, lookahead=4))
    prompts, retrieved, ocr_calls, spoken = [], [], [], []
    generate = runner.generate

    @functools.wraps(generate)
    def recorded(prompt, *a, **kw):
        prompts.append(prompt)
        return generate(prompt, *a, **kw)
    runner.generate = recorded
    emb = embedder.Embedder(*models["embedder"], models["tokenizer"])
    engine = trocr.TrOCREngine(*models["trocr"], ocr_text)

    def ocr_fn(crops):
        ocr_calls.append(len(crops))
        return engine(crops)
    sparams, scfg = models["sound"]
    alarm = dict(sparams, out_b=sparams["out_b"] + 40.0 * torch.eye(
        scfg.num_classes, device=dev)[int(SoundClass.ALARM)])
    rng = np.random.default_rng(SEED + 231)
    frame = vision_frame((480, 640), SEED + 232)
    fns, _ = surfaces_vision(dev)
    app = TrackieApp(
        sources=AppSources(
            camera=lambda: frame,
            microphone=lambda: (0.05 * rng.standard_normal(1600)).astype(
                np.float32)),
        embed_fn=emb.embed, ocr_fn=ocr_fn,
        sound_fn=SoundClassifierEngine(alarm, scfg),
        wake_fn=lambda chunk: False, llm_runner=runner,
        tts_fn=lambda text: np.zeros(1600, np.float32),
        on_spoken_audio=lambda wav, p: spoken.append(int(p)),
        device=dev, **fns)
    search = app.memory.retrieve_relevant

    def retrieve(query, top_k=3):
        got = search(query, top_k)
        retrieved.append((query, [f.text for f in got]))
        return got
    app.memory.retrieve_relevant = retrieve
    for text in (*perception_fragments(8), PERCEPTION_MEMORY):
        app.memory.archive(text)
    critical = int(ActionPriority.CRITICAL)
    for w in counters.values():
        w.launches = 0
    t0 = time.perf_counter()
    app.start()
    try:
        app.cortex.inject_user_text(PERCEPTION_QUESTION)
        deadline = t0 + PERCEPTION_TURN_TIMEOUT
        while (not (any(p <= APP_REPLY_PRIORITY for p in spoken)
                    and critical in spoken and ocr_calls)
               and time.perf_counter() < deadline):
            time.sleep(0.05)
        turn_s = time.perf_counter() - t0
    finally:
        app.stop()
    torch.cuda.synchronize()
    launches = {k: w.launches for k, w in counters.items()}
    failures = app.failures()
    # The cosine side of the ranking, recomputed from the stored vectors.
    stored = np.asarray([f.embedding for f in app.memory.fragments],
                        np.float32)
    cos = stored @ emb.embed([PERCEPTION_QUESTION])[0]
    texts = [f.text for f in app.memory.fragments]
    first = retrieved[0][1] if retrieved else []
    out = {"turn_s": turn_s, "spoken": spoken, "ocr_calls": ocr_calls,
           "retrieved": first, "memory_cosine": float(
               cos[texts.index(PERCEPTION_MEMORY)]),
           "cosine_rank": int((cos > cos[texts.index(PERCEPTION_MEMORY)])
                              .sum()) + 1,
           "memory_in_prompt": bool(prompts) and (
               f"Memória: {PERCEPTION_MEMORY}" in prompts[0]),
           "llm_ms": app.cortex.stats["last_llm_ms"],
           "launches": launches, "failures": failures}
    log(f"  (c) TrackieApp turn: reply and ALARM spoken in {turn_s:.2f} s "
        f"(priorities {spoken}), LLM turn {out['llm_ms']:.1f} ms; the "
        f"question retrieved {first[:2]} (the archived memory's cosine "
        f"{out['memory_cosine']:.4f}, rank {out['cosine_rank']} of "
        f"{len(texts)} by cosine; in the prompt: "
        f"{out['memory_in_prompt']}); OCR calls {ocr_calls}; failures "
        f"{failures}; counters that rose "
        f"{ {k: n for k, n in launches.items() if n} }")
    stored_ok = all(f.embedding is not None for f in app.memory.fragments)
    if (not first or first[0] != PERCEPTION_MEMORY or not stored_ok
            or critical not in spoken
            or not any(p <= APP_REPLY_PRIORITY for p in spoken)
            or not ocr_calls or failures):
        raise AssertionError(f"phase 20 (c): {out}")
    expect_routes(launches, ("q4_matmul_w4a8", "quantize_activations",
                             "flash_attention"),
                  ("q8_matmul", "fused_mlp_q4", *DIAGNOSTIC), "phase 20")
    return out


def phase_perception(dev, llm, runner_mod, counters, profile) -> dict:
    """Phase 20 (the comment above PERCEPTION_CPU_LAYERS): (a), (b), the
    profile child, then (c); each part's seconds."""
    t0 = time.perf_counter()
    parts = {}

    def lap(part: str) -> None:
        parts[part] = time.perf_counter() - t0 - sum(parts.values())
    models = perception_models(dev)
    out = {"card_vs_cpu": perception_card_vs_cpu(dev, models)}
    lap("a")
    out["timed"] = perception_timed(dev, models)
    out["profile"] = profile()
    lap("b")
    out["app"] = perception_app(dev, llm, runner_mod, models, counters)
    lap("c")
    out["launches"] = out["app"]["launches"]
    out["seconds"] = time.perf_counter() - t0
    out["part_seconds"] = parts
    log(f"  phase 20 took {out['seconds']:.1f} s ("
        + ", ".join(f"({k}) {v:.1f}" for k, v in parts.items()) + ")")
    return out


# ---------------------------------------------------------------------------
# Phase 21: the MLA (DeepSeek-V2/V3) and Mamba families
# ---------------------------------------------------------------------------

# (a) DeepSeek-V2-Lite (deepseek-ai/DeepSeek-V2-Lite) at its published
# widths, Q4 at group 64 (the largest dividing every K/2: the experts'
# 1408 / 2), max_seq cut to 1024, its 27 layers cut to dense layer 0 and 3
# MoE layers: quantized banks run every expert on every row, about 20
# launches an expert from the host, so a decode step at 27 layers is about
# 33,000 launches (gpt-oss-20b's 20,103 took 368 ms, PERF.md §5), and (a)'s
# two turns, the served burst and its runner twins would take more than
# the phase's 90 s.
MLA_LAYERS = 4
MLA_MAX_SEQ = 1024
MLA_GROUP = 64
MLA_TOKENS = 8
MLA_SERVE_SLOTS = 4
MLA_SERVE_TOKENS = 8
# The served burst and its runner twins run at max_seq 256, where the
# runner's attention reads the whole cache as the server's does: a
# different cache length changes the sums' order of the scores and the
# mix, and random weights' greedy ids follow the last bit.
MLA_SERVE_MAX_SEQ = 256
# (b) V2-Lite at 2 layers (dense layer 0, one MoE layer), card against CPU
# at two buckets and MLA_DECODE teacher-forced decode steps; the V2 and V3
# knob sets at tiny widths in f32 through the transformers converters
# (MLA_KNOB_TOL); DeepSeek-V3 (deepseek-ai/DeepSeek-V3) at its published
# widths, 2 layers (one dense, one MoE), on the card only.
MLA_SWEEP_LAYERS = 2
MLA_BUCKETS = (64, 256)
MLA_DECODE = 8
MLA_KNOB_TOL = 1e-4      # rel L2, f32 weights, card against CPU
MLA_V3_TOKENS = 4
# (c) Mamba-2.8B (state-spaces/mamba-2.8b-hf) at its 64 layers, Q4 group
# 256; (d) Mamba-Codestral-7B's widths (mistralai/Mamba-Codestral-7B-v0.1,
# ``Mamba2Config()``) in bf16, 64 layers cut to 4 (a 7B bf16 model is
# 14.6 GB; 4 layers keep the chunk's 1-GiB scan operands).
MAMBA_GROUP = 256
MAMBA_TOKENS = 8
MAMBA_SWEEP_LAYERS = 2
MAMBA_SWEEP_BUCKETS = (64, 256)
MAMBA2_LAYERS = 4
MAMBA2_TOL = 1e-4        # rel L2, f32 on both sides
# (e) the CLI on tiny deepseek2 and mamba GGUFs written here
SSM_CLI_TOKENS = 8
SSM_CLI_VOCAB = 384


def phase21_configs(mla, mamba, mamba2) -> dict:
    """Phase 21's models at their published widths: DeepSeek-V2-Lite cut
    to MLA_LAYERS layers and max_seq MLA_MAX_SEQ, DeepSeek-V3 cut to 2
    layers (one dense), the knob sets' tiny MLA (MLA's head dims), Mamba-2.8B
    and Mamba-Codestral-7B's widths cut to MAMBA2_LAYERS layers."""
    return {
        "v2_lite": mla.MLAConfig.deepseek_v2_lite()._replace(
            n_layers=MLA_LAYERS, max_seq=MLA_MAX_SEQ),
        "v3": mla.MLAConfig.deepseek_v3()._replace(
            n_layers=2, first_k_dense=1, max_seq=256),
        "knobs": mla.MLAConfig(
            vocab_size=512, dim=256, n_layers=2, n_heads=2, hidden_dim=512,
            q_lora_rank=96, kv_lora_rank=64, n_experts=8, n_experts_used=2,
            moe_hidden_dim=128, moe_shared_hidden=128, first_k_dense=1,
            max_seq=256),
        "mamba": mamba.MambaConfig.mamba_2_8b(),
        "mamba2": mamba2.Mamba2Config()._replace(n_layers=MAMBA2_LAYERS),
    }


def expect_launches(got: int, want: int, what: str) -> None:
    """A kernel launched exactly ``want`` times in a window."""
    if got != want:
        raise AssertionError(f"{what}: {got} launches, not {want}")


def _rows(tree, a: int, b: int):
    """Rows [a, b) of every stacked leaf of ``tree``: views."""
    if isinstance(tree, dict):
        return {k: _rows(v, a, b) for k, v in tree.items()}
    if isinstance(tree, tuple):  # QuantizedLinear
        return type(tree)(tree.values[a:b], tree.scales[a:b])
    return tree[a:b]


def mla_slice(params, cfg, n: int):
    """The first ``n`` layers of an MLA model (views) and their config."""
    k = min(cfg.first_k_dense, n)
    return ({**params, "attn": _rows(params["attn"], 0, n),
             "dense_mlp": _rows(params["dense_mlp"], 0, k),
             "moe_mlp": _rows(params["moe_mlp"], 0, n - k)},
            cfg._replace(n_layers=n, first_k_dense=k))


def _zero(counters) -> None:
    for fn in counters.values():
        fn.launches = 0


def _counts(counters) -> dict:
    return {k: fn.launches for k, fn in counters.items()}


def ssm_serve(server_mod, mod, params, cfg, tok, runner, counters,
              tag: str, **kw) -> dict:
    """A burst of four QUESTIONS queued whole (``ServerWatch.held``) on an
    ``LLMServer(model=mod)`` of four slots: each request's ids must equal
    what ``runner(prompt)`` (a fresh session of the same module) gives."""
    prompts = list(QUESTIONS[:4])
    want = [runner(p) for p in prompts]
    _zero(counters)
    server = server_mod.LLMServer(params, cfg, batch_slots=MLA_SERVE_SLOTS,
                                  tokenizer=tok, model=mod, **kw)
    watch = ServerWatch(server)
    t0 = time.perf_counter()
    try:
        burst(server, [(p, {"max_tokens": len(w)})
                       for p, w in zip(prompts, want)], watch)
    finally:
        close_server(server)
    wall = time.perf_counter() - t0
    got = [watch.ids[p] for p in prompts]
    diverge = [first_divergence(g, w) for g, w in zip(got, want)]
    log(f"  {tag} served burst of {len(prompts)} on {MLA_SERVE_SLOTS} "
        f"slots in {wall:.2f} s, waves {watch.waves}: ids equal to the "
        f"runner's {sum(d is None for d in diverge)} of {len(prompts)} "
        f"(first divergence {diverge})")
    if any(d is not None for d in diverge):
        raise AssertionError(f"phase 21 {tag}: served ids differ from the "
                             f"runner's at {diverge}")
    return {"wall_s": wall, "waves": watch.waves,
            "tokens": [len(g) for g in got], "launches": _counts(counters)}


def mla_v2lite(dev, mla, runner_mod, tokenizer_mod, server_mod, counters,
               cfg) -> tuple:
    """(a): DeepSeek-V2-Lite behind ``LLMRunner(model=mla)``: the cortex
    prompt (bucket 512: flash at D = 192 once a layer) and MLA_TOKENS
    greedy tokens at lookahead 4, then a second turn through ``extend``
    (``chat``); then the served burst. Returns (its numbers, the params
    and config, which (b) cuts to 2 layers)."""
    log(f"  DeepSeek-V2-Lite depth cut: {cfg.n_layers} of 27 layers (dense "
        f"layer 0, {cfg.n_layers - 1} MoE layers), max_seq {cfg.max_seq}")
    t0 = time.perf_counter()
    params = mla.init_params_quantized(
        torch.Generator(device=dev).manual_seed(SEED), cfg, bits=4,
        group=MLA_GROUP, device=dev)
    torch.cuda.synchronize()
    log(f"  params: Q4 group {MLA_GROUP} in {time.perf_counter() - t0:.1f} "
        f"s, {param_bytes(params) / 2 ** 30:.2f} GiB on the card")
    tok = tokenizer_mod.ByteTokenizer(cfg.vocab_size)

    def runner(n: int, c=cfg):
        gen = runner_mod.GenerationConfig(max_tokens=n, temperature=0.0,
                                          speculative=False)
        return runner_mod.LLMRunner(params, c, tok, gen, device=dev,
                                    model=mla)
    r = runner(MLA_TOKENS)
    prompt = r.build_prompt(SYSTEM, CONTEXT, QUESTIONS[0])
    warm_up(r, 4)
    _zero(counters)
    watch = LogitWatch(mla)
    try:
        out = request(r, prompt, "a (DeepSeek-V2-Lite cortex prompt, "
                      "lookahead 4)")
        flash = counters["flash_attention"].launches
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        r.chat("And what about the bicycle?")
        torch.cuda.synchronize()
        out["turn2_ms"] = (time.perf_counter() - t1) * 1e3
        out["turn2_tokens"] = len(r.generated_ids)
    finally:
        out["finite_logit_vectors"] = watch.close()
    out["launches"] = _counts(counters)
    log(f"  second turn (extend): {out['turn2_tokens']} tokens in "
        f"{out['turn2_ms']:.1f} ms; launches {out['launches']}")
    expect_launches(flash, cfg.n_layers, "phase 21 (a): flash at D = 192 "
                    "in a bucket-512 prefill")
    if not out["turn2_tokens"]:
        raise AssertionError("phase 21 (a): the second turn gave nothing")
    expect_routes(out["launches"], ("q4_matmul_w4a8", "quantize_activations",
                                    "flash_attention"),
                  ("q8_matmul", "q4_matmul_f32a", "fused_mlp_q4",
                   *DIAGNOSTIC), "phase 21 (a)")
    scfg = cfg._replace(max_seq=MLA_SERVE_MAX_SEQ)

    def twin(p):
        rr = runner(MLA_SERVE_TOKENS, scfg)
        rr.generate(p)
        return rr.generated_ids
    out["serve"] = ssm_serve(server_mod, mla, params, scfg, tok, twin,
                             counters, "a DeepSeek-V2-Lite")
    return out, params, cfg


def mla_sweep(dev, mla, llm, quant, params, cfg) -> dict:
    """(b) V2-Lite: the first MLA_SWEEP_LAYERS layers of (a)'s model (views)
    on the card and on the CPU (the Q4 matrices dequantized once, W4A8's
    activation quantization where the card ran W4A8, the MoE layers forced
    to the card's experts by ``RouterTap``, flips within twice the router
    noise): prefill at MLA_BUCKETS (flash at 256 on the card), then
    MLA_DECODE decode steps on the card's greedy tokens, within WIDTH_TOL."""
    cut, ccfg = mla_slice(params, cfg, MLA_SWEEP_LAYERS)
    toks = torch.randint(0, cfg.vocab_size, (max(MLA_BUCKETS),),
                         generator=torch.Generator().manual_seed(SEED))

    def run(p, device, bucket, feed=None):
        length = bucket - MLA_DECODE - 2
        c = mla.MLACache.create(ccfg, max_seq=bucket, device=device)
        lg, c = mla.prefill(p, ccfg, toks[:bucket].to(device), length, c)
        out, fed = [lg.float().cpu()], []
        for i in range(MLA_DECODE):
            t = int(torch.argmax(lg)) if feed is None else feed[i]
            fed.append(t)
            lg, c = mla.decode_step(p, ccfg, t, c)
            out.append(lg.float().cpu())
        return torch.stack(out), fed, length
    card = {}
    for bucket in MLA_BUCKETS:
        tap = RouterTap(llm)
        try:
            res = run(cut, dev, bucket)
        finally:
            taps = tap.close()
        card[bucket] = res + taps
    cpu = dequantized_on_cpu(quant, cut)
    groups = w4a8_groups(quant, cut, cpu)
    out = {"layers": MLA_SWEEP_LAYERS, "rel_l2": {}, "flips": {},
           "router_noise": {}}
    for bucket in MLA_BUCKETS:
        lg, fed, length, select, ids = card[bucket]
        tap = RouterTap(llm, forced=ids)
        try:
            with levers_on(("TRACKIE_MOE_ROUTED",)), w4a8_activations(
                    llm, quant, groups):
                lc = run(cpu, torch.device("cpu"), bucket, fed)[0]
        finally:
            cpu_select, _ = tap.close()
        tag = f"V2-Lite {MLA_SWEEP_LAYERS} layers bucket {bucket}"
        flips, noise = router_flips(llm._top_k_first, select, ids,
                                    cpu_select, cfg.n_experts_used, length)
        check_router_flips(flips, noise, tag)
        errs = [rel_l2(a, b) for a, b in zip(lg, lc)]
        out["rel_l2"][str(bucket)] = errs
        out["flips"][str(bucket)] = len(flips)
        out["router_noise"][str(bucket)] = noise
        log(f"  {tag}: rel_l2 card vs cpu prefill {errs[0]:.3e}, decode max "
            f"{max(errs[1:]):.3e} (tol {WIDTH_TOL:.0e}, W4A8 activations "
            f"on the cpu); {len(flips)} router flips, noise {noise:.3e}")
        if not (torch.isfinite(lg).all() and max(errs) < WIDTH_TOL):
            raise AssertionError(f"phase 21 (b) {tag}: rel L2 {errs}")
    return out


def deepseek_state(cfg, seed: int, v3: bool) -> dict:
    """A transformers DeepSeek state dict at ``cfg``'s widths from the
    seed (the router at 3 / sqrt(D), so that its choices are far apart;
    V3's ``e_score_correction_bias``)."""
    rng = np.random.default_rng(seed)

    def R(*s, scale=1.0):
        return (scale * rng.standard_normal(s) / np.sqrt(s[-1])
                ).astype(np.float32)

    def ones(n):
        return (1.0 + 0.1 * rng.standard_normal(n)).astype(np.float32)
    h, r = cfg.n_heads, cfg.kv_lora_rank
    st = {"model.embed_tokens.weight": R(cfg.vocab_size, cfg.dim, scale=8.0),
          "model.norm.weight": ones(cfg.dim),
          "lm_head.weight": R(cfg.vocab_size, cfg.dim)}
    for i in range(cfg.n_layers):
        p, sa = f"model.layers.{i}", f"model.layers.{i}.self_attn"
        st[f"{p}.input_layernorm.weight"] = ones(cfg.dim)
        st[f"{p}.post_attention_layernorm.weight"] = ones(cfg.dim)
        st[f"{sa}.kv_a_proj_with_mqa.weight"] = R(r + cfg.qk_rope_head_dim,
                                                  cfg.dim)
        st[f"{sa}.kv_a_layernorm.weight"] = ones(r)
        st[f"{sa}.kv_b_proj.weight"] = R(
            h * (cfg.qk_nope_head_dim + cfg.v_head_dim), r)
        st[f"{sa}.o_proj.weight"] = R(cfg.dim, h * cfg.v_head_dim)
        st[f"{sa}.q_a_proj.weight"] = R(cfg.q_lora_rank, cfg.dim)
        st[f"{sa}.q_a_layernorm.weight"] = ones(cfg.q_lora_rank)
        st[f"{sa}.q_b_proj.weight"] = R(h * cfg.qk_head_dim, cfg.q_lora_rank)

        def mlp(pre, hid):
            st[f"{pre}.gate_proj.weight"] = R(hid, cfg.dim)
            st[f"{pre}.up_proj.weight"] = R(hid, cfg.dim)
            st[f"{pre}.down_proj.weight"] = R(cfg.dim, hid)
        if i < cfg.first_k_dense:
            mlp(f"{p}.mlp", cfg.hidden_dim)
            continue
        st[f"{p}.mlp.gate.weight"] = R(cfg.n_experts, cfg.dim, scale=3.0)
        if v3:
            st[f"{p}.mlp.gate.e_score_correction_bias"] = (
                0.2 * rng.standard_normal(cfg.n_experts) - 0.3
            ).astype(np.float32)
        for e in range(cfg.n_experts):
            mlp(f"{p}.mlp.experts.{e}", cfg.moe_hidden_dim)
        mlp(f"{p}.mlp.shared_experts", cfg.moe_shared_hidden)
    return st


def mla_knobs(dev, mla, convert, base) -> dict:
    """(b) the V2 knob set (q-LoRA, group-limited softmax routing by max,
    routed scale 16) and V3's (sigmoid scores with the selection bias,
    top-2-sum groups, renormalized top-k, routed scale 2.5) at tiny widths
    with MLA's head dims (flash at D = 192 in f32 on the card), through
    ``deepseek_v2_from_hf`` and ``deepseek_v3_from_hf`` on each side: a
    bucket-256 prefill and 4 decode steps within MLA_KNOB_TOL."""
    knobs = {"v2": (convert.deepseek_v2_from_hf, False, dict(
        n_experts_used=2, n_groups=4, topk_groups=2, routed_scale=16.0)),
             "v3": (convert.deepseek_v3_from_hf, True, dict(
                 n_experts_used=2, n_groups=4, topk_groups=2))}
    toks = torch.randint(0, base.vocab_size, (base.max_seq,),
                         generator=torch.Generator().manual_seed(SEED + 3))
    out = {}
    for name, (fn, v3, kw) in knobs.items():
        state = deepseek_state(base, SEED + (7 if v3 else 5), v3)
        logits = []
        for device in (dev, torch.device("cpu")):
            p, cfg = fn(state, dtype=torch.float32, device=device,
                        max_seq=base.max_seq,
                        qk_nope_head_dim=base.qk_nope_head_dim,
                        qk_rope_head_dim=base.qk_rope_head_dim, **kw)
            c = mla.MLACache.create(cfg, dtype=torch.float32, device=device)
            lg, c = mla.prefill(p, cfg, toks.to(device), base.max_seq - 16,
                                c)
            seq = [lg.cpu()]
            for t in (3, 77, 101, 300):
                lg, c = mla.decode_step(p, cfg, t, c)
                seq.append(lg.cpu())
            logits.append(torch.stack(seq))
        err = rel_l2(*logits)
        out[name] = {"rel_l2": err, "score_func": cfg.moe_score_func,
                     "group_score": cfg.moe_group_score,
                     "gate_bias": "moe_gate_bias" in p["moe_mlp"]}
        log(f"  {name} knobs ({cfg.moe_score_func}, {cfg.moe_group_score} "
            f"groups, routed scale {cfg.moe_routed_scale}): rel_l2 card vs "
            f"cpu {err:.3e} (tol {MLA_KNOB_TOL:.0e})")
        if not err < MLA_KNOB_TOL:
            raise AssertionError(f"phase 21 (b) {name} knobs: {err}")
    return out


def mla_v3(dev, mla, cfg, counters) -> dict:
    """(b) DeepSeek-V3 at its published widths cut to 2 layers (one dense,
    one MoE: 256 experts, 128 heads), Q4 group 64 with a selection bias, on
    the card only: a bucket-256 prefill (flash at D = 192, 128 heads) and
    MLA_V3_TOKENS greedy decode steps, every logit finite."""
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    params = mla.init_params_quantized(gen, cfg, bits=4, group=MLA_GROUP,
                                       device=dev)
    params["moe_mlp"]["moe_gate_bias"] = 0.01 * torch.randn(
        (1, cfg.n_experts), generator=gen, device=dev)
    toks = torch.randint(0, cfg.vocab_size, (cfg.max_seq,), device=dev,
                         generator=gen)
    build = time.perf_counter() - t0
    flash = counters["flash_attention"].launches
    lg, c = mla.prefill(params, cfg, toks, cfg.max_seq - MLA_V3_TOKENS - 2,
                        mla.MLACache.create(cfg, device=dev))
    flash = counters["flash_attention"].launches - flash
    seq = [lg]
    for _ in range(MLA_V3_TOKENS):
        lg, c = mla.decode_step(params, cfg, torch.argmax(lg), c)
        seq.append(lg)
    torch.cuda.synchronize()
    finite = bool(torch.isfinite(torch.stack(seq)).all())
    out = {"build_s": build, "seconds": time.perf_counter() - t0,
           "flash_launches": flash, "finite": finite,
           "gib": param_bytes(params) / 2 ** 30}
    log(f"  DeepSeek-V3 {cfg.n_layers} layers ({cfg.n_experts} experts, "
        f"{cfg.n_heads} heads): built in "
        f"{build:.1f} s ({out['gib']:.2f} GiB), prefill + {MLA_V3_TOKENS} "
        f"tokens finite {finite}, flash launches {flash}")
    if not finite:
        raise AssertionError(f"phase 21 (b) V3: logits {out}")
    expect_launches(flash, cfg.n_layers, "phase 21 (b) V3: flash at D = "
                    "192, 128 heads")
    return out


def flash_attrs(attention, d: int) -> dict:
    """The head-dim-``d`` flash kernels' registers, spill bytes and shared
    memory as ptxas left them, bf16 and f32 (``flash_kernel_attrs``)."""
    return {str(dt)[6:]: attention.flash_kernel_attrs(d, dt)
            for dt in (torch.bfloat16, torch.float32)}


def mamba_28b(dev, mamba, llm, quant, runner_mod, tokenizer_mod, server_mod,
              counters, cfg) -> dict:
    """(c): Mamba-2.8B behind ``MambaRunner`` (the cortex prompt in chunks
    of 256, then MAMBA_TOKENS greedy tokens), the served burst, and its
    first MAMBA_SWEEP_LAYERS layers card against CPU (W4A8's activation
    quantization on the CPU's dequantized weights) at MAMBA_SWEEP_BUCKETS
    and 4 decode steps, within WIDTH_TOL."""
    t0 = time.perf_counter()
    params = mamba.init_params_quantized(
        torch.Generator(device=dev).manual_seed(SEED), cfg, bits=4,
        group=MAMBA_GROUP, device=dev)
    torch.cuda.synchronize()
    log(f"  Mamba-2.8B: {cfg.n_layers} layers Q4 group {MAMBA_GROUP} in "
        f"{time.perf_counter() - t0:.1f} s, "
        f"{param_bytes(params) / 2 ** 30:.2f} GiB on the card")
    tok = tokenizer_mod.ByteTokenizer(cfg.vocab_size)

    def runner(n):
        return mamba.MambaRunner(params, cfg, tok, runner_mod.GenerationConfig(
            max_tokens=n, temperature=0.0), device=dev)
    r = runner(MAMBA_TOKENS)
    r.generate(SHORT_PROMPT, max_tokens=4)
    prompt = r.build_prompt(SYSTEM, CONTEXT, QUESTIONS[0])
    _zero(counters)
    watch = LogitWatch(mamba)
    try:
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        r.generate(prompt)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
    finally:
        n_logits = watch.close()
    n = len(r.generated_ids)
    out = {"prompt_tokens": r.count_tokens(prompt) + 1, "tokens": n,
           "wall_ms": wall * 1e3, "finite_logit_vectors": n_logits,
           "launches": _counts(counters)}
    log(f"  c (Mamba-2.8B cortex prompt, {out['prompt_tokens']} tokens in "
        f"chunks of {r.CHUNK}, {n} tokens): {out['wall_ms']:.1f} ms; "
        f"launches {out['launches']}")
    if not n:
        raise AssertionError("phase 21 (c): no tokens")
    expect_routes(out["launches"], ("q4_matmul_w4a8", "quantize_activations"),
                  ("flash_attention", "q8_matmul", "q4_matmul_f32a",
                   "fused_mlp_q4", *DIAGNOSTIC), "phase 21 (c)")

    def twin(p):
        rr = runner(MLA_SERVE_TOKENS)
        rr.generate(p)
        return rr.generated_ids
    # The runner's state is f32: the served slots hold theirs in f32 too.
    out["serve"] = ssm_serve(server_mod, mamba, params, cfg, tok, twin,
                             counters, "c Mamba-2.8B",
                             cache_dtype=torch.float32)
    from trackiellm_tpu_torch.tools.diag_envelope import layer_slice
    cut = layer_slice(params, MAMBA_SWEEP_LAYERS)
    ccfg = cfg._replace(n_layers=MAMBA_SWEEP_LAYERS)
    cpu = dequantized_on_cpu(quant, cut)
    groups = w4a8_groups(quant, cut, cpu)
    toks = torch.randint(0, cfg.vocab_size, (max(MAMBA_SWEEP_BUCKETS),),
                         generator=torch.Generator().manual_seed(SEED + 1))
    out["rel_l2"] = {}
    for bucket in MAMBA_SWEEP_BUCKETS:
        seqs, fed = [], None
        for p, device in ((cut, dev), (cpu, torch.device("cpu"))):
            with (w4a8_activations(llm, quant, groups) if fed is not None
                  else contextlib.nullcontext()):
                lg, c = mamba.prefill(p, ccfg, toks[:bucket].to(device),
                                      bucket - 3, mamba.MambaCache.create(
                                          ccfg, device=device))
                seq, ids = [lg.float().cpu()], []
                for i in range(4):
                    t = int(torch.argmax(lg)) if fed is None else fed[i]
                    ids.append(t)
                    lg, c = mamba.decode_step(p, ccfg, t, c)
                    seq.append(lg.float().cpu())
            seqs.append(torch.stack(seq))
            fed = ids
        errs = [rel_l2(a, b) for a, b in zip(*seqs)]
        out["rel_l2"][str(bucket)] = errs
        log(f"  Mamba-2.8B {MAMBA_SWEEP_LAYERS} layers bucket {bucket}: "
            f"rel_l2 card vs cpu prefill {errs[0]:.3e}, decode max "
            f"{max(errs[1:]):.3e} (tol {WIDTH_TOL:.0e})")
        if not (torch.isfinite(seqs[0]).all() and max(errs) < WIDTH_TOL):
            raise AssertionError(f"phase 21 (c) bucket {bucket}: {errs}")
    return out


def mamba2_codestral(dev, mamba, mamba2, runner_mod, tokenizer_mod,
                     counters, cfg) -> dict:
    """(d): Mamba-Codestral-7B's widths cut to MAMBA2_LAYERS layers, bf16,
    behind ``MambaRunner`` (which picks ``models.mamba2`` by the config's
    type): the cortex prompt in chunks of 256 and MAMBA_TOKENS greedy
    tokens (plain matmuls, as the reference's: no kernel launches); then
    its first 2 layers in f32 on the card against the CPU, a bucket-64
    prefill and 2 decode steps, within MAMBA2_TOL."""
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = mamba2.init_params(gen, cfg, dtype=torch.bfloat16, device=dev)
    tok = tokenizer_mod.ByteTokenizer(cfg.vocab_size)
    r = mamba.MambaRunner(params, cfg, tok, runner_mod.GenerationConfig(
        max_tokens=MAMBA_TOKENS, temperature=0.0), device=dev)
    if r._m is not mamba2:
        raise AssertionError("phase 21 (d): MambaRunner took the wrong module")
    r.generate(SHORT_PROMPT, max_tokens=2)
    prompt = r.build_prompt(SYSTEM, CONTEXT, QUESTIONS[0])
    torch.cuda.reset_peak_memory_stats(dev)
    _zero(counters)
    watch = LogitWatch(mamba2)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r.generate(prompt)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        n_logits = watch.close()
    out = {"layers": cfg.n_layers, "prompt_tokens": r.count_tokens(prompt)
           + 1, "tokens": len(r.generated_ids), "wall_ms": wall * 1e3,
           "finite_logit_vectors": n_logits, "launches": _counts(counters),
           "peak_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30}
    log(f"  d (Codestral widths, {cfg.n_layers} layers, bf16): "
        f"{out['prompt_tokens']} prompt tokens and {out['tokens']} tokens in "
        f"{out['wall_ms']:.1f} ms; launches {out['launches']}")
    expect_routes(out["launches"], (), tuple(counters), "phase 21 (d)")
    if not out["tokens"]:
        raise AssertionError("phase 21 (d): no tokens")
    cut = {k: v.float() for k, v in _rows(params["layers"], 0, 2).items()}
    cut = {**{k: v.float() for k, v in params.items() if k != "layers"},
           "layers": cut}
    ccfg = cfg._replace(n_layers=2)
    del params, r
    toks = torch.randint(0, cfg.vocab_size, (64,),
                         generator=torch.Generator().manual_seed(SEED + 2))
    seqs = []
    for p in (cut, {k: (v.cpu() if k != "layers" else
                        {kk: vv.cpu() for kk, vv in v.items()})
                    for k, v in cut.items()}):
        device = p["tok_emb"].device
        lg, c = mamba2.prefill(p, ccfg, toks.to(device), 60,
                               mamba2.Mamba2Cache.create(ccfg, device=device))
        seq = [lg.cpu()]
        for t in (5, 300):
            lg, c = mamba2.decode_step(p, ccfg, t, c)
            seq.append(lg.cpu())
        seqs.append(torch.stack(seq))
    out["rel_l2"] = rel_l2(*seqs)
    log(f"  Codestral widths 2 layers f32, bucket 64 + 2 decode steps: "
        f"rel_l2 card vs cpu {out['rel_l2']:.3e} (tol {MAMBA2_TOL:.0e})")
    if not out["rel_l2"] < MAMBA2_TOL:
        raise AssertionError(f"phase 21 (d): rel L2 {out['rel_l2']}")
    return out


def _f32(rng, *shape, scale=1.0):
    return ((scale * rng.standard_normal(shape) / np.sqrt(shape[-1]))
            .astype(np.float32), GGML_F32)


def _gguf_vocab(arch: str, vocab: int) -> dict:
    spec = spm_spec(vocab)
    return {"tokenizer.ggml.model": "llama",
            "tokenizer.ggml.tokens": spec["tokens"],
            "tokenizer.ggml.scores": spec["scores"],
            "tokenizer.ggml.token_type": spec["token_types"],
            "tokenizer.ggml.bos_token_id": 1,
            "tokenizer.ggml.eos_token_id": 2,
            "tokenizer.ggml.unknown_token_id": 0,
            "tokenizer.ggml.padding_token_id": spec["pad_id"],
            "tokenizer.ggml.add_space_prefix": spec["add_space_prefix"],
            "general.architecture": arch, "general.name": f"tiny {arch}"}


def deepseek2_gguf(seed: int):
    """(tensors, metadata) of a 2-layer deepseek2 GGUF (dense layer 0, 4
    experts top 2 with a shared one; 2 heads of MLA's head dims; every
    quantized K a multiple of 128 for group 64), F32 from the seed, rope
    columns in llama.cpp's neox order (the converter reorders them)."""
    rng = np.random.default_rng(seed)
    dim, h, r, rope, nope, vd, hid, e, mh = 256, 2, 64, 64, 64, 64, 256, 4, 128
    t = {"token_embd.weight": _f32(rng, SSM_CLI_VOCAB, dim, scale=8.0),
         "output_norm.weight": (np.ones(dim, np.float32), GGML_F32),
         "output.weight": _f32(rng, SSM_CLI_VOCAB, dim)}
    for i in range(2):
        p = f"blk.{i}"
        t[f"{p}.attn_norm.weight"] = (np.ones(dim, np.float32), GGML_F32)
        t[f"{p}.ffn_norm.weight"] = (np.ones(dim, np.float32), GGML_F32)
        t[f"{p}.attn_q.weight"] = _f32(rng, h * (nope + rope), dim)
        t[f"{p}.attn_kv_a_mqa.weight"] = _f32(rng, r + rope, dim)
        t[f"{p}.attn_kv_a_norm.weight"] = (np.ones(r, np.float32), GGML_F32)
        t[f"{p}.attn_kv_b.weight"] = _f32(rng, h * (nope + vd), r)
        t[f"{p}.attn_output.weight"] = _f32(rng, dim, h * vd)
        if i == 0:
            for n in ("gate", "up"):
                t[f"{p}.ffn_{n}.weight"] = _f32(rng, hid, dim)
            t[f"{p}.ffn_down.weight"] = _f32(rng, dim, hid)
            continue
        t[f"{p}.ffn_gate_inp.weight"] = _f32(rng, e, dim, scale=3.0)
        for n in ("gate", "up"):
            t[f"{p}.ffn_{n}_exps.weight"] = _f32(rng, e, mh, dim)
            t[f"{p}.ffn_{n}_shexp.weight"] = _f32(rng, mh, dim)
        t[f"{p}.ffn_down_exps.weight"] = _f32(rng, e, dim, mh)
        t[f"{p}.ffn_down_shexp.weight"] = _f32(rng, dim, mh)
    a = "deepseek2"
    meta = {**_gguf_vocab(a, SSM_CLI_VOCAB), f"{a}.block_count": 2,
            f"{a}.context_length": 1024, f"{a}.embedding_length": dim,
            f"{a}.feed_forward_length": hid,
            f"{a}.attention.head_count": h,
            f"{a}.attention.layer_norm_rms_epsilon": 1e-6,
            f"{a}.rope.freq_base": 10000.0,
            f"{a}.attention.key_length": nope + rope,
            f"{a}.attention.value_length": vd,
            f"{a}.leading_dense_block_count": 1, f"{a}.expert_count": e,
            f"{a}.expert_used_count": 2,
            f"{a}.expert_feed_forward_length": mh,
            f"{a}.expert_gating_func": 1}
    return t, meta


def mamba_gguf(seed: int):
    """(tensors, metadata) of a 2-layer mamba GGUF (dim 256, d_inner 512:
    every K a multiple of 256 for Q8's group), F32 from the seed in
    llama.cpp's layout (the conv squeezed to (I, K), ssm_a = -exp(A_log))."""
    rng = np.random.default_rng(seed)
    dim, inner, n, rank, k = 256, 512, 16, 16, 4
    t = {"token_embd.weight": _f32(rng, SSM_CLI_VOCAB, dim, scale=8.0),
         "output_norm.weight": (np.ones(dim, np.float32), GGML_F32),
         "output.weight": _f32(rng, SSM_CLI_VOCAB, dim)}
    for i in range(2):
        b = f"blk.{i}."
        t[b + "attn_norm.weight"] = (np.ones(dim, np.float32), GGML_F32)
        t[b + "ssm_in.weight"] = _f32(rng, 2 * inner, dim)
        t[b + "ssm_conv1d.weight"] = _f32(rng, inner, k)
        t[b + "ssm_conv1d.bias"] = (np.zeros(inner, np.float32), GGML_F32)
        t[b + "ssm_x.weight"] = _f32(rng, rank + 2 * n, inner)
        t[b + "ssm_dt.weight"] = _f32(rng, inner, rank)
        t[b + "ssm_dt.bias"] = (np.full(inner, -2.0, np.float32), GGML_F32)
        t[b + "ssm_a"] = (-np.tile(np.arange(1, n + 1, dtype=np.float32),
                                   (inner, 1)), GGML_F32)
        t[b + "ssm_d"] = (np.ones(inner, np.float32), GGML_F32)
        t[b + "ssm_out.weight"] = _f32(rng, dim, inner)
    meta = {**_gguf_vocab("mamba", SSM_CLI_VOCAB), "mamba.block_count": 2,
            "mamba.context_length": 1024, "mamba.embedding_length": dim,
            "mamba.ssm.conv_kernel": k, "mamba.ssm.inner_size": inner,
            "mamba.ssm.state_size": n, "mamba.ssm.time_step_rank": rank,
            "mamba.attention.layer_norm_rms_epsilon": 1e-5}
    return t, meta


def ssm_cli(dev, cli, counters, work: str) -> dict:
    """(e): a deepseek2 and a mamba GGUF written here through ``inspect``,
    ``convert`` (deepseek2 at --bits 4, mamba at --bits 8) and ``generate``
    on the card: exit 0 each; generate launches W4A8 and its quantization
    (deepseek2) or Q8 (mamba), and nothing off its route."""
    out = {}
    for arch, build, bits, ran in (
            ("deepseek2", deepseek2_gguf, 4,
             ("q4_matmul_w4a8", "quantize_activations")),
            ("mamba", mamba_gguf, 8, ("q8_matmul",))):
        src = os.path.join(work, f"{arch}.gguf")
        ck = os.path.join(work, f"{arch}_ckpt")
        write_gguf(src, *build(SEED + 30))
        rc_i, text, _ = run_cli(cli, ["inspect", src])
        described = json.loads(text)["architecture"] if rc_i == 0 else None
        rc_c, _, conv_s = run_cli(cli, ["convert", src, "-o", ck, "--bits",
                                        str(bits)])
        _zero(counters)
        rc_g, reply, gen_s = run_cli(cli, [
            "generate", ck, "-p", SHORT_PROMPT, "--max-tokens",
            str(SSM_CLI_TOKENS), "--temperature", "0"])
        launches = _counts(counters)
        out[arch] = {"inspect": described, "rc": [rc_i, rc_c, rc_g],
                     "convert_s": conv_s, "generate_s": gen_s,
                     "reply_chars": len(reply.strip()),
                     "launches": launches}
        log(f"  e {arch}: inspect -> {described}, convert --bits {bits} "
            f"{conv_s:.1f} s, generate {gen_s:.1f} s; exit codes "
            f"{[rc_i, rc_c, rc_g]}; launches {launches}")
        if [rc_i, rc_c, rc_g] != [0, 0, 0] or described != arch:
            raise AssertionError(f"phase 21 (e) {arch}: {out[arch]}")
        expect_routes(launches, ran,
                      tuple(k for k in counters if k not in ran),
                      f"phase 21 (e) {arch}")
    return out


# PERF.md §5's MLA and Mamba rows: a process of its own, run apart from the
# smoke (``chip_smoke.py --mla-profile``), so that CUPTI's start and the
# records' reading stay out of phase 21's budget.
MLA_PROFILE_FLAG = "--mla-profile"
MLA_PROFILE_TOKENS = 4


def window_breakdown(tag: str, fresh, per: int = 1) -> dict:
    """``fresh()`` gives a new call of the window (its setup done): one
    call on the host clock, one under the profiler; per ``per`` units."""
    fn = fresh()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    busy, n, by_name = device_breakdown(fresh())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:4]
    out = {"wall_ms": wall / per, "busy_ms": busy / per,
           "idle_share": 1.0 - busy / wall, "launches": n / per,
           "top": [[k[:70], t / per, c / per] for k, (t, c) in top]}
    log(f"  profile {tag}: wall {out['wall_ms']:.2f} ms, busy "
        f"{out['busy_ms']:.2f} ms, idle {out['idle_share']:.3f}, "
        f"{out['launches']:.1f} launches" + (f" a token ({per})"
                                             if per > 1 else ""))
    return out


def mla_profile(dev) -> dict:
    """DeepSeek-V2-Lite as phase 21 (a) builds it: the cortex prompt's
    prefill (bucket 512, flash at D = 192) and MLA_PROFILE_TOKENS greedy
    tokens at lookahead 1 behind ``LLMRunner(model=mla)``; Mamba-2.8B as
    (c) builds it: MLA_PROFILE_TOKENS decode steps after the prompt."""
    from trackiellm_tpu_torch.llm import runner as runner_mod
    from trackiellm_tpu_torch.llm import tokenizer as tokenizer_mod
    from trackiellm_tpu_torch.models import mamba, mamba2, mla
    cfgs = phase21_configs(mla, mamba, mamba2)
    cfg = cfgs["v2_lite"]
    params = mla.init_params_quantized(
        torch.Generator(device=dev).manual_seed(SEED), cfg, bits=4,
        group=MLA_GROUP, device=dev)
    tok = tokenizer_mod.ByteTokenizer(cfg.vocab_size)

    def runner():
        gen = runner_mod.GenerationConfig(
            max_tokens=MLA_PROFILE_TOKENS, temperature=0.0, speculative=False,
            lookahead=1)
        return runner_mod.LLMRunner(params, cfg, tok, gen, device=dev,
                                    model=mla)
    prompt = runner().build_prompt(SYSTEM, CONTEXT, QUESTIONS[0])
    runner().generate(prompt)

    def prefill():
        r = runner()
        return lambda: r.prepare_generation(prompt)

    def decode():
        r = runner()
        r.prepare_generation(prompt)

        def run():
            while r.generate_next_token() is not None:
                pass
        return run
    out = {"v2_lite_layers": cfg.n_layers,
           "v2_lite_prefill": window_breakdown("V2-Lite prefill", prefill),
           "v2_lite_decode": window_breakdown("V2-Lite decode", decode,
                                              MLA_PROFILE_TOKENS)}
    del params
    torch.cuda.empty_cache()
    mcfg = cfgs["mamba"]
    mparams = mamba.init_params_quantized(
        torch.Generator(device=dev).manual_seed(SEED), mcfg, bits=4,
        group=MAMBA_GROUP, device=dev)
    mr = mamba.MambaRunner(mparams, mcfg, tok, runner_mod.GenerationConfig(
        max_tokens=1, temperature=0.0), device=dev)
    mr.generate(prompt)

    def steps():
        cache = mr.cache
        lg = mamba.decode_step(mparams, mcfg, 0, cache)[0]

        def run():
            nonlocal lg, cache
            for _ in range(MLA_PROFILE_TOKENS):
                lg, cache = mamba.decode_step(mparams, mcfg,
                                              torch.argmax(lg), cache)
        return run
    out["mamba_decode"] = window_breakdown("Mamba-2.8B decode", steps,
                                           MLA_PROFILE_TOKENS)
    return out


def phase_mla_mamba(dev, counters, work: str) -> dict:
    """Phase 21 (the constants above MLA_LAYERS): (a) DeepSeek-V2-Lite, (b)
    card against CPU (V2-Lite at 2 layers, the V2/V3 knob sets, V3's
    widths), (c) Mamba-2.8B, (d) Mamba-Codestral's widths, (e) the CLI;
    each part's seconds, and the launches of (a), (c) and (e)'s windows."""
    from trackiellm_tpu_torch import __main__ as cli
    from trackiellm_tpu_torch.llm import runner as runner_mod
    from trackiellm_tpu_torch.llm import server as server_mod
    from trackiellm_tpu_torch.llm import tokenizer as tokenizer_mod
    from trackiellm_tpu_torch.models import convert, llm, mamba, mamba2, mla
    from trackiellm_tpu_torch.ops import attention, quant
    t0 = time.perf_counter()
    parts = {}

    def lap(part: str) -> None:
        parts[part] = time.perf_counter() - t0 - sum(parts.values())
    cfgs = phase21_configs(mla, mamba, mamba2)
    out = {"flash_attrs": flash_attrs(attention, 192)}
    out["a"], params, cfg = mla_v2lite(dev, mla, runner_mod, tokenizer_mod,
                                       server_mod, counters, cfgs["v2_lite"])
    lap("a")
    out["b"] = {"v2_lite": mla_sweep(dev, mla, llm, quant, params, cfg)}
    del params
    torch.cuda.empty_cache()
    out["b"]["knobs"] = mla_knobs(dev, mla, convert, cfgs["knobs"])
    out["b"]["v3"] = mla_v3(dev, mla, cfgs["v3"], counters)
    torch.cuda.empty_cache()
    lap("b")
    out["c"] = mamba_28b(dev, mamba, llm, quant, runner_mod, tokenizer_mod,
                         server_mod, counters, cfgs["mamba"])
    torch.cuda.empty_cache()
    lap("c")
    out["d"] = mamba2_codestral(dev, mamba, mamba2, runner_mod,
                                tokenizer_mod, counters, cfgs["mamba2"])
    torch.cuda.empty_cache()
    lap("d")
    out["e"] = ssm_cli(dev, cli, counters, work)
    lap("e")
    windows = (out["a"]["launches"], out["a"]["serve"]["launches"],
               out["c"]["launches"], out["c"]["serve"]["launches"],
               *(v["launches"] for v in out["e"].values()))
    out["launches"] = {k: sum(w[k] for w in windows) for k in counters}
    out["seconds"] = time.perf_counter() - t0
    out["part_seconds"] = parts
    log(f"  phase 21 took {out['seconds']:.1f} s ("
        + ", ".join(f"({k}) {v:.1f}" for k, v in parts.items())
        + f"); launches {out['launches']}")
    return out


# ---------------------------------------------------------------------------
# Phase 22: Qwen3-Next and the transformers-state-dict converters
# ---------------------------------------------------------------------------

# The head_dim each converter resolves from shapes or its defaults (granite,
# nemotron and olmo2 probe 128 first; gemma2 takes 256 below dim 4608;
# gpt-oss 64; falcon dim // --n-heads).
HF_HEAD_DIM = {"gemma2": 256, "gpt_oss": 64}
HF_FAMILIES = ("gemma2", "gemma3", "smollm3", "olmo2", "mixtral",
               "qwen2moe", "qwen3", "qwen3moe", "granite", "glm4", "llama4",
               "nemotron", "starcoder2", "cohere", "ernie45", "glm4moe",
               "falcon")


def hf_family_state(family: str, w: dict, seed: int) -> dict:
    """A transformers state dict of ``family`` at widths ``w`` (dim,
    heads, kv, hidden, vocab, layers, experts; ``falcon_heads``), drawn
    N(0, 0.05) with numpy from ``seed``, norms near one: the names each
    ``*_from_hf`` converter reads (``phi3`` and ``gpt_oss`` too, which
    have no CLI family). MoE families route every layer but
    GLM-4.5's and ERNIE's first, which stay dense as their configs'
    first_k_dense_replace / moe_layer_start_index have them."""
    rng = np.random.default_rng(seed)

    def R(*shape, scale=0.05):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    def ones(n):
        return (1.0 + R(n)).astype(np.float32)
    d, hid, vocab = w["dim"], w["hidden"], w["vocab"]
    n_exp, n_layers = w["experts"], w["layers"]
    if family == "falcon":
        hd = d // w["falcon_heads"]
        st = {"transformer.word_embeddings.weight": R(vocab, d),
              "transformer.ln_f.weight": ones(d),
              "transformer.ln_f.bias": R(d), "lm_head.weight": R(vocab, d)}
        for i in range(n_layers):
            p = f"transformer.h.{i}."
            st[p + "input_layernorm.weight"] = ones(d)
            st[p + "input_layernorm.bias"] = R(d)
            st[p + "self_attention.query_key_value.weight"] = R(d + 2 * hd, d)
            st[p + "self_attention.dense.weight"] = R(d, d)
            st[p + "mlp.dense_h_to_4h.weight"] = R(hid, d)
            st[p + "mlp.dense_4h_to_h.weight"] = R(d, hid)
        return st
    hd = HF_HEAD_DIM.get(family, 128)
    h, kv = w["heads"] * 128 // hd, max(1, w["kv"] * 128 // hd)
    st = {"model.embed_tokens.weight": R(vocab, d),
          "model.norm.weight": ones(d), "lm_head.weight": R(vocab, d)}
    if family in ("nemotron", "starcoder2"):
        st["model.norm.bias"] = R(d)
    for i in range(n_layers):
        p = f"model.layers.{i}."
        a = p + "self_attn."
        st[p + "input_layernorm.weight"] = ones(d)
        if family != "cohere":
            st[p + "post_attention_layernorm.weight"] = ones(d)
        if family in ("nemotron", "starcoder2"):
            st[p + "input_layernorm.bias"] = R(d)
            st[p + "post_attention_layernorm.bias"] = R(d)
        if family in ("gemma2", "gemma3"):
            st[p + "pre_feedforward_layernorm.weight"] = R(d)
            st[p + "post_feedforward_layernorm.weight"] = R(d)
        if family == "olmo2":
            st[p + "post_feedforward_layernorm.weight"] = ones(d)
        if family == "glm4":
            st[p + "post_self_attn_layernorm.weight"] = ones(d)
            st[p + "post_mlp_layernorm.weight"] = ones(d)
        if family == "phi3":
            st[a + "qkv_proj.weight"] = R((h + 2 * kv) * hd, d)
        else:
            for name, rows in (("q", h * hd), ("k", kv * hd),
                               ("v", kv * hd)):
                st[f"{a}{name}_proj.weight"] = R(rows, d)
                if family in ("qwen2moe", "glm4", "starcoder2", "gpt_oss"):
                    st[f"{a}{name}_proj.bias"] = R(rows)
        st[a + "o_proj.weight"] = R(d, h * hd)
        if family in ("starcoder2", "gpt_oss"):
            st[a + "o_proj.bias"] = R(d)
        if family == "gpt_oss":
            st[a + "sinks"] = R(h)
        if family in ("gemma3", "qwen3", "qwen3moe", "glm4moe"):
            st[a + "q_norm.weight"] = ones(hd)
            st[a + "k_norm.weight"] = ones(hd)
        if family == "olmo2":
            st[a + "q_norm.weight"] = ones(h * hd)
            st[a + "k_norm.weight"] = ones(kv * hd)
        m = p + "mlp."
        routed = (family in ("mixtral", "qwen2moe", "qwen3moe", "llama4")
                  or (family in ("glm4moe", "ernie45") and i > 0))
        if family == "mixtral":
            st[p + "block_sparse_moe.gate.weight"] = R(n_exp, d)
            for e in range(n_exp):
                ep = f"{p}block_sparse_moe.experts.{e}."
                st[ep + "w1.weight"] = R(hid, d)
                st[ep + "w3.weight"] = R(hid, d)
                st[ep + "w2.weight"] = R(d, hid)
        elif family == "gpt_oss":
            st[m + "router.weight"] = R(n_exp, d)
            st[m + "router.bias"] = R(n_exp)
            st[m + "experts.gate_up_proj"] = R(n_exp, d, 2 * hid)
            st[m + "experts.gate_up_proj_bias"] = R(n_exp, 2 * hid)
            st[m + "experts.down_proj"] = R(n_exp, hid, d)
            st[m + "experts.down_proj_bias"] = R(n_exp, d)
        elif family == "llama4":
            ff = p + "feed_forward."
            st[ff + "experts.gate_up_proj"] = R(n_exp, d, 2 * hid)
            st[ff + "experts.down_proj"] = R(n_exp, hid, d)
            st[ff + "router.weight"] = R(n_exp, d)
            for name, shape in (("gate_proj", (hid, d)), ("up_proj", (hid, d)),
                                ("down_proj", (d, hid))):
                st[f"{ff}shared_expert.{name}.weight"] = R(*shape)
        elif routed:
            st[m + "gate.weight"] = R(n_exp, d)
            for e in range(n_exp):
                for name, shape in (("gate_proj", (hid, d)),
                                    ("up_proj", (hid, d)),
                                    ("down_proj", (d, hid))):
                    st[f"{m}experts.{e}.{name}.weight"] = R(*shape)
            shared = {"qwen2moe": "shared_expert", "glm4moe": "shared_experts",
                      "ernie45": "shared_experts"}.get(family)
            if shared:
                for name, shape in (("gate_proj", (hid, d)),
                                    ("up_proj", (hid, d)),
                                    ("down_proj", (d, hid))):
                    st[f"{m}{shared}.{name}.weight"] = R(*shape)
            if family == "qwen2moe":
                st[m + "shared_expert_gate.weight"] = R(1, d)
            if family == "glm4moe":
                st[m + "gate.e_score_correction_bias"] = R(n_exp)
            if family == "ernie45":
                st[m + "moe_statics.e_score_correction_bias"] = R(1, n_exp)
        elif family in ("glm4", "phi3"):
            st[m + "gate_up_proj.weight"] = R(2 * hid, d)
            st[m + "down_proj.weight"] = R(d, hid)
        elif family == "nemotron":
            st[m + "up_proj.weight"] = R(hid, d)
            st[m + "down_proj.weight"] = R(d, hid)
        elif family == "starcoder2":
            st[m + "c_fc.weight"] = R(hid, d)
            st[m + "c_fc.bias"] = R(hid)
            st[m + "c_proj.weight"] = R(d, hid)
            st[m + "c_proj.bias"] = R(d)
        else:
            st[m + "gate_proj.weight"] = R(hid, d)
            st[m + "up_proj.weight"] = R(hid, d)
            st[m + "down_proj.weight"] = R(d, hid)
    return st


def hf_family_args(family: str, w: dict) -> list:
    """The CLI flags a family needs beyond ``--family``."""
    return ["--n-heads", str(w["falcon_heads"])] if family == "falcon" else []


# Phase 22 (a): Qwen3-Next-80B-A3B (Qwen/Qwen3-Next-80B-A3B-Instruct's
# config.json: dim 2048; 16/2 attention heads of 256, partial rotary 0.25,
# rope_theta 1e7; DeltaNet 16 key and 32 value heads of 128, conv 4; 512
# experts top 10 of width 512, shared 512; vocab 151,936) at Q4 group 256,
# 48 layers cut to Q3N_LAYERS (one period of the 3:1 pattern), max_seq
# 1024, behind MambaRunner: the cortex prompt and Q3N_TOKENS greedy
# tokens, then a second turn. Quantized banks run every expert on every row
# (the reference's dense-all-experts), ~1,030 W4A8 calls a MoE layer.
Q3N_LAYERS = ("l", "l", "l", "f")
Q3N_MAX_SEQ = 1024
Q3N_GROUP = 256
# 8 until phase 23 joined, to pay for it: phase 22 (a) took 11.9 s at 8,
# 6.7 s at 4 (two whole runs on an H100 80GB HBM3 at 700 W).
Q3N_TOKENS = 4
# (b) card against CPU: layers 0 and 3 of (a) ("l", "f"), a bucket-16
# prefill and Q3N_DECODE teacher-forced decode steps.
Q3N_BUCKET = 16
Q3N_DECODE = 2
# (c) the CLI's file routes at tiny widths (every Q4 K a multiple of 512),
# (d) the other families' transformers state dicts at HF_WIDTHS.
Q3N_TINY = {"dim": 512, "heads": 4, "kv": 2, "head_dim": 128, "lin_hk": 2,
            "lin_hv": 4, "lin_d": 128, "experts": 4, "top_k": 2,
            "moe_hidden": 512, "layers": 4, "vocab": SSM_CLI_VOCAB}
HF_WIDTHS = {"dim": 512, "heads": 4, "kv": 2, "hidden": 512,
             "vocab": SSM_CLI_VOCAB, "layers": 2, "experts": 4,
             "falcon_heads": 8}
HF_BUCKET = 16
Q3N_PROFILE_FLAG = "--qwen3next-profile"
Q3N_PROFILE_TOKENS = 2


def q3n_config(q3n, layer_types=Q3N_LAYERS):
    """Qwen3-Next-80B-A3B at its published widths, cut in depth."""
    return q3n.Qwen3NextConfig.qwen3_next_80b_a3b()._replace(
        n_layers=len(layer_types), layer_types=layer_types,
        max_seq=Q3N_MAX_SEQ)


def q3n_model(dev, q3n, cfg):
    """Random Q4 params drawn and quantized on the card, one matrix (one
    expert's) at a time; f32 elsewhere, as the converters give them."""
    return q3n.init_params_quantized(
        torch.Generator(device=dev).manual_seed(SEED), cfg, bits=4,
        group=Q3N_GROUP, device=dev)


def q3n_w4a8_calls(params, cfg) -> int:
    """W4A8 calls of one forward: the quantized projections a layer reads,
    each expert's two banks and lm_head."""
    from trackiellm_tpu_torch.ops.quant import QuantizedLinear
    n = 1
    for lp in params["layers"]:
        for name, w in lp.items():
            if isinstance(w, QuantizedLinear):
                n += (w.values.shape[0] if w.values.dim() == 3 else 1)
    return n


def q3n_turn(runner, prompt: str) -> dict:
    """One ``generate``: prefill ms (to the first token's fetch) and ms a
    token (between fetches), from ``on_token``'s clock."""
    stamps = []
    t0 = time.perf_counter()
    runner.generate(prompt, on_token=lambda s: stamps.append(
        time.perf_counter()))
    torch.cuda.synchronize()
    ids = runner.generated_ids
    if not ids or len(stamps) != len(ids):
        raise AssertionError(f"phase 22: a turn gave {len(ids)} tokens")
    return {"prompt_tokens": runner.count_tokens(prompt) + 1,
            "tokens": len(ids), "prefill_ms": (stamps[0] - t0) * 1e3,
            "ms_a_token": ((stamps[-1] - stamps[0]) * 1e3
                           / max(len(stamps) - 1, 1)),
            "wall_s": time.perf_counter() - t0}


def q3n_full(dev, q3n, mamba, runner_mod, tokenizer_mod, counters,
             cfg) -> tuple:
    """(a): two turns behind MambaRunner, every forward's W4A8 calls
    counted. Returns (its numbers, the params)."""
    t0 = time.perf_counter()
    params = q3n_model(dev, q3n, cfg)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    tok = tokenizer_mod.ByteTokenizer(cfg.vocab_size)
    runner = mamba.MambaRunner(params, cfg, tok, runner_mod.GenerationConfig(
        max_tokens=Q3N_TOKENS, temperature=0.0), device=dev)
    per_forward = q3n_w4a8_calls(params, cfg)
    out = {"layers": cfg.n_layers, "build_s": build_s,
           "param_gb": param_bytes(params) / 1e9,
           "w4a8_calls_a_forward": per_forward}
    log(f"  Qwen3-Next-80B-A3B depth cut: {cfg.n_layers} of 48 layers "
        f"{cfg.layer_types}, Q4 group {Q3N_GROUP}, {out['param_gb']:.2f} GB "
        f"built on the card in {build_s:.1f} s; {per_forward} W4A8 calls a "
        "forward")
    _zero(counters)
    turns = []
    for question in QUESTIONS[:2]:
        prompt = runner.build_prompt(SYSTEM, CONTEXT, question)
        turns.append(q3n_turn(runner, prompt))
    launches = _counts(counters)
    chunks = sum(-(-t["prompt_tokens"] // mamba.MambaRunner.CHUNK)
                 for t in turns)
    forwards = chunks + sum(t["tokens"] for t in turns)
    expect_routes(launches, ("q4_matmul_w4a8", "quantize_activations"),
                  tuple(k for k in counters if k not in (
                      "q4_matmul_w4a8", "quantize_activations")),
                  "phase 22 (a)")
    expect_launches(launches["q4_matmul_w4a8"], per_forward * forwards,
                    f"phase 22 (a): W4A8 over {forwards} forwards")
    expect_launches(launches["quantize_activations"],
                    launches["q4_matmul_w4a8"], "phase 22 (a): quantization")
    for i, t in enumerate(turns):
        log(f"  turn {i + 1}: {t['prompt_tokens']} prompt tokens, prefill "
            f"{t['prefill_ms']:.1f} ms, {t['tokens']} tokens at "
            f"{t['ms_a_token']:.1f} ms a token ({t['wall_s']:.2f} s)")
    out.update(turns=turns, launches=launches)
    return out, params


def q3n_pass(q3n, params, cfg, toks, length, dev, forced=None):
    """A bucket prefill, then Q3N_DECODE teacher-forced steps, under a
    RouterTap: (logits of each, the DeltaNet layer's recurrent state after
    each, the tap's selection values and ids)."""
    tap = RouterTap(q3n, forced)
    logits, states = [], []
    try:
        cache = q3n.create_cache(cfg, device=dev)
        lg, cache = q3n.prefill(params, cfg, toks[:Q3N_BUCKET].to(dev),
                                length, cache)
        logits.append(lg.cpu())
        states.append(cache["layers"][0]["rec"].cpu())
        for j in range(Q3N_DECODE):
            lg, cache = q3n.decode_step(params, cfg,
                                        int(toks[length + j]), cache)
            logits.append(lg.cpu())
            states.append(cache["layers"][0]["rec"].cpu())
    finally:
        select, ids = tap.close()
    return logits, states, select, ids


def q3n_sweep(dev, q3n, llm, quant, params, cfg) -> dict:
    """(b): layers 0 and 3 of (a)'s model (views), card against the CPU on
    the same inputs: the bucket-16 prefill's and Q3N_DECODE decode steps'
    logits and the f32 recurrent state within WIDTH_TOL rel L2. The CPU
    runs the card's experts (``RouterTap``) on the matrices dequantized
    once, W4A8's activation quantization emulated, routed (the same
    function at K/E of dense-all's work); each router flip's margin must be
    within twice the router noise."""
    t0 = time.perf_counter()
    cut = {**params, "layers": [params["layers"][0], params["layers"][3]]}
    ccfg = cfg._replace(n_layers=2, layer_types=("l", "f"))
    length = Q3N_BUCKET - 2
    toks = torch.randint(0, cfg.vocab_size, (Q3N_BUCKET + Q3N_DECODE,),
                         generator=torch.Generator().manual_seed(SEED))
    card = q3n_pass(q3n, cut, ccfg, toks, length, dev)
    t_card = time.perf_counter() - t0
    cpu = dequantized_on_cpu(quant, cut)
    groups = (w4a8_groups(quant, cut, cpu)
              if torch.device(dev).type == "cuda" else {})
    with levers_on(("TRACKIE_MOE_ROUTED",)), w4a8_activations(
            llm, quant, groups):
        ref = q3n_pass(q3n, cpu, ccfg, toks, length, "cpu", forced=card[3])
    del cpu
    flips, noise = router_flips(q3n._top_k_first, card[2], card[3], ref[2],
                                ccfg.n_experts_used, length)
    check_router_flips(flips, noise, "phase 22 (b)")
    errs = [rel_l2(a, b) for a, b in zip(card[0], ref[0])]
    state_errs = [rel_l2(a, b) for a, b in zip(card[1], ref[1])]
    out = {"layers": list(ccfg.layer_types), "rel_l2": errs,
           "state_rel_l2": state_errs, "flips": flips, "router_noise": noise,
           "card_s": t_card, "seconds": time.perf_counter() - t0}
    log(f"  b card vs cpu ({ccfg.layer_types}, full width, Q4, the card's "
        f"experts on the cpu): prefill bucket {Q3N_BUCKET} rel_l2 "
        f"{errs[0]:.3e}, decode {', '.join(f'{e:.3e}' for e in errs[1:])}; "
        f"recurrent state {', '.join(f'{e:.3e}' for e in state_errs)} (tol "
        f"{WIDTH_TOL:.0e}); {len(flips)} router flips, router noise "
        f"{noise:.3e}; card {t_card:.1f} s, all {out['seconds']:.1f} s")
    if not all(torch.isfinite(lg).all() for lg in card[0]):
        raise AssertionError("phase 22 (b): card logits")
    if not max(errs + state_errs) < WIDTH_TOL:
        raise AssertionError(f"phase 22 (b): rel L2 {errs} {state_errs}")
    return out


def qwen3next_hf_config(w: dict) -> dict:
    """The HF config.json fields of a Qwen3-Next at widths ``w``
    (Q3N_TINY's keys)."""
    return {"vocab_size": w["vocab"], "hidden_size": w["dim"],
            "num_hidden_layers": w["layers"],
            "num_attention_heads": w["heads"],
            "num_key_value_heads": w["kv"], "head_dim": w["head_dim"],
            "linear_num_key_heads": w["lin_hk"],
            "linear_num_value_heads": w["lin_hv"],
            "linear_key_head_dim": w["lin_d"],
            "linear_value_head_dim": w["lin_d"],
            "linear_conv_kernel_dim": 4, "num_experts": w["experts"],
            "num_experts_per_tok": w["top_k"],
            "moe_intermediate_size": w["moe_hidden"],
            "shared_expert_intermediate_size": w["moe_hidden"],
            "intermediate_size": 2 * w["moe_hidden"], "norm_topk_prob": True,
            "partial_rotary_factor": 0.25, "rope_theta": 10000.0,
            "rms_norm_eps": 1e-6, "full_attention_interval": 4}


def qwen3next_hf_state(conf: dict, seed: int, scale: float = 0.08) -> dict:
    """A ``Qwen3NextForCausalLM``-named state dict at ``conf``'s widths:
    every ``full_attention_interval``-th layer full attention, the rest
    Gated DeltaNet; A_log and dt_bias in the HF init's ranges (A uniform in
    (1, 16), dt log-uniform in (1e-3, 0.1)), norms N(0, 0.2), matrices
    N(0, ``scale``), drawn with numpy from ``seed``."""
    rng = np.random.default_rng(seed)

    def R(*s, sc=scale):
        return (rng.standard_normal(s) * sc).astype(np.float32)
    d, v = conf["hidden_size"], conf["vocab_size"]
    hk, hv = conf["linear_num_key_heads"], conf["linear_num_value_heads"]
    dk, dv = conf["linear_key_head_dim"], conf["linear_value_head_dim"]
    h, kv, hd = (conf["num_attention_heads"], conf["num_key_value_heads"],
                 conf["head_dim"])
    st = {"model.embed_tokens.weight": R(v, d),
          "model.norm.weight": R(d, sc=0.2), "lm_head.weight": R(v, d)}
    for i in range(conf["num_hidden_layers"]):
        p = f"model.layers.{i}."
        st[p + "input_layernorm.weight"] = R(d, sc=0.2)
        st[p + "post_attention_layernorm.weight"] = R(d, sc=0.2)
        if (i + 1) % conf["full_attention_interval"]:
            la = p + "linear_attn."
            st[la + "in_proj_qkvz.weight"] = R(2 * hk * dk + 2 * hv * dv, d)
            st[la + "in_proj_ba.weight"] = R(2 * hv, d)
            st[la + "conv1d.weight"] = R(2 * hk * dk + hv * dv, 1,
                                         conf["linear_conv_kernel_dim"])
            dt = np.exp(rng.uniform(np.log(1e-3), np.log(0.1), hv))
            st[la + "dt_bias"] = (dt + np.log(-np.expm1(-dt))).astype(
                np.float32)
            st[la + "A_log"] = np.log(rng.uniform(1, 16, hv)).astype(
                np.float32)
            st[la + "norm.weight"] = (1 + R(dv, sc=0.2)).astype(np.float32)
            st[la + "out_proj.weight"] = R(d, hv * dv)
        else:
            sa = p + "self_attn."
            st[sa + "q_proj.weight"] = R(2 * h * hd, d)
            st[sa + "k_proj.weight"] = R(kv * hd, d)
            st[sa + "v_proj.weight"] = R(kv * hd, d)
            st[sa + "o_proj.weight"] = R(d, h * hd)
            st[sa + "q_norm.weight"] = R(hd, sc=0.2)
            st[sa + "k_norm.weight"] = R(hd, sc=0.2)
        if conf["num_experts"]:
            m = conf["moe_intermediate_size"]
            sh = conf["shared_expert_intermediate_size"]
            st[p + "mlp.gate.weight"] = R(conf["num_experts"], d)
            for e in range(conf["num_experts"]):
                ep = p + f"mlp.experts.{e}."
                st[ep + "gate_proj.weight"] = R(m, d)
                st[ep + "up_proj.weight"] = R(m, d)
                st[ep + "down_proj.weight"] = R(d, m)
            sp = p + "mlp.shared_expert."
            st[sp + "gate_proj.weight"] = R(sh, d)
            st[sp + "up_proj.weight"] = R(sh, d)
            st[sp + "down_proj.weight"] = R(d, sh)
            st[p + "mlp.shared_expert_gate.weight"] = R(1, d)
        else:
            m = conf["intermediate_size"]
            st[p + "mlp.gate_proj.weight"] = R(m, d)
            st[p + "mlp.up_proj.weight"] = R(m, d)
            st[p + "mlp.down_proj.weight"] = R(d, m)
    return st


def qwen3next_gguf_tensors(state: dict, conf: dict, split_gate: bool = False,
                           neg_a: bool = False) -> dict:
    """llama.cpp's ``qwen3next`` tensors of an HF state dict (F32): the
    attention gate fused in ``attn_q`` or split into ``attn_gate``, ssm_a
    as the raw A_log or as -exp(A_log)."""
    def f32(a):
        return (np.ascontiguousarray(a, np.float32), GGML_F32)
    t = {"token_embd.weight": f32(state["model.embed_tokens.weight"]),
         "output_norm.weight": f32(state["model.norm.weight"]),
         "output.weight": f32(state["lm_head.weight"])}
    hd, h = conf["head_dim"], conf["num_attention_heads"]
    for i in range(conf["num_hidden_layers"]):
        p, b = f"model.layers.{i}.", f"blk.{i}."
        t[b + "attn_norm.weight"] = f32(state[p + "input_layernorm.weight"])
        t[b + "ffn_norm.weight"] = f32(
            state[p + "post_attention_layernorm.weight"])
        la = p + "linear_attn."
        if la + "in_proj_qkvz.weight" in state:
            a = state[la + "A_log"]
            for gg, hf in (("ssm_in.weight", "in_proj_qkvz.weight"),
                           ("ssm_beta_alpha.weight", "in_proj_ba.weight"),
                           ("ssm_dt.bias", "dt_bias"),
                           ("ssm_norm.weight", "norm.weight"),
                           ("ssm_out.weight", "out_proj.weight")):
                t[b + gg] = f32(state[la + hf])
            t[b + "ssm_conv1d.weight"] = f32(state[la + "conv1d.weight"][:, 0])
            t[b + "ssm_a"] = f32(-np.exp(a) if neg_a else a)
        else:
            sa = p + "self_attn."
            q = state[sa + "q_proj.weight"]
            if split_gate:
                qg = q.reshape(h, 2 * hd, -1)
                t[b + "attn_q.weight"] = f32(qg[:, :hd].reshape(h * hd, -1))
                t[b + "attn_gate.weight"] = f32(qg[:, hd:].reshape(h * hd, -1))
            else:
                t[b + "attn_q.weight"] = f32(q)
            for gg, hf in (("attn_k", "k_proj"), ("attn_v", "v_proj"),
                           ("attn_output", "o_proj"),
                           ("attn_q_norm", "q_norm"),
                           ("attn_k_norm", "k_norm")):
                t[f"{b}{gg}.weight"] = f32(state[f"{sa}{hf}.weight"])
        if p + "mlp.gate.weight" in state:
            n = conf["num_experts"]
            t[b + "ffn_gate_inp.weight"] = f32(state[p + "mlp.gate.weight"])
            for gg, hf in (("gate", "gate_proj"), ("up", "up_proj"),
                           ("down", "down_proj")):
                t[f"{b}ffn_{gg}_exps.weight"] = f32(np.stack(
                    [state[f"{p}mlp.experts.{e}.{hf}.weight"]
                     for e in range(n)]))
                t[f"{b}ffn_{gg}_shexp.weight"] = f32(
                    state[f"{p}mlp.shared_expert.{hf}.weight"])
            t[b + "ffn_gate_inp_shexp.weight"] = f32(
                state[p + "mlp.shared_expert_gate.weight"])
        else:
            for gg in ("gate", "up", "down"):
                t[f"{b}ffn_{gg}.weight"] = f32(
                    state[f"{p}mlp.{gg}_proj.weight"])
    return t


def qwen3next_gguf_metadata(conf: dict) -> dict:
    """The ``qwen3next.*`` keys llama.cpp writes, at ``conf``'s widths."""
    a, hd = "qwen3next", conf["head_dim"]
    return {"general.architecture": a,
            f"{a}.block_count": conf["num_hidden_layers"],
            f"{a}.embedding_length": conf["hidden_size"],
            f"{a}.attention.head_count": conf["num_attention_heads"],
            f"{a}.attention.head_count_kv": conf["num_key_value_heads"],
            f"{a}.attention.key_length": hd,
            f"{a}.attention.layer_norm_rms_epsilon": conf["rms_norm_eps"],
            f"{a}.rope.freq_base": conf["rope_theta"],
            f"{a}.rope.dimension_count": int(
                conf["partial_rotary_factor"] * hd),
            f"{a}.context_length": 1024,
            f"{a}.expert_count": conf["num_experts"],
            f"{a}.expert_used_count": conf["num_experts_per_tok"],
            f"{a}.ssm.state_size": conf["linear_key_head_dim"],
            f"{a}.ssm.group_count": conf["linear_num_key_heads"],
            f"{a}.ssm.inner_size": (conf["linear_num_value_heads"]
                                    * conf["linear_value_head_dim"]),
            f"{a}.ssm.conv_kernel": conf["linear_conv_kernel_dim"]}


def q3n_cli(dev, cli, counters, work: str) -> dict:
    """(c): a Qwen3-Next at Q3N_TINY's widths as a transformers state dict
    (``convert --family qwen3next-hf --model-config --bits 4``, then
    ``generate``) and as a qwen3next GGUF with the split attention gate and
    -exp(A_log) (``inspect``, ``convert --bits 4``, ``generate``), on the
    card: exit 0 each; generate launches W4A8 and its quantization only."""
    conf = qwen3next_hf_config(Q3N_TINY)
    state = qwen3next_hf_state(conf, SEED + 40)
    src = os.path.join(work, "qwen3next.npz")
    np.savez(src, **state)
    conf_path = os.path.join(work, "qwen3next_config.json")
    with open(conf_path, "w", encoding="utf-8") as f:
        json.dump(conf, f)
    gguf = os.path.join(work, "qwen3next.gguf")
    write_gguf(gguf, qwen3next_gguf_tensors(state, conf, split_gate=True,
                                            neg_a=True),
               {**_gguf_vocab("qwen3next", conf["vocab_size"]),
                **qwen3next_gguf_metadata(conf)})
    ran = ("q4_matmul_w4a8", "quantize_activations")
    out = {}
    for route, path, flags in (
            ("hf", src, ["--family", "qwen3next-hf", "--model-config",
                         conf_path]),
            ("gguf", gguf, [])):
        ck = os.path.join(work, f"qwen3next_{route}_ckpt")
        rc_i, described = 0, None
        if route == "gguf":
            rc_i, text, _ = run_cli(cli, ["inspect", path])
            described = json.loads(text)["architecture"] if rc_i == 0 else None
        rc_c, _, conv_s = run_cli(cli, ["convert", path, "-o", ck, "--bits",
                                        "4", *flags])
        _zero(counters)
        rc_g, reply, gen_s = run_cli(cli, [
            "generate", ck, "-p", SHORT_PROMPT, "--max-tokens",
            str(SSM_CLI_TOKENS), "--temperature", "0"])
        launches = _counts(counters)
        out[route] = {"inspect": described, "rc": [rc_i, rc_c, rc_g],
                      "convert_s": conv_s, "generate_s": gen_s,
                      "reply_chars": len(reply.strip()),
                      "launches": launches}
        log(f"  c {route}: inspect -> {described}, convert --bits 4 "
            f"{conv_s:.1f} s, generate {gen_s:.1f} s; exit codes "
            f"{[rc_i, rc_c, rc_g]}; launches {launches}")
        if [rc_i, rc_c, rc_g] != [0, 0, 0] or (
                route == "gguf" and described != "qwen3next"):
            raise AssertionError(f"phase 22 (c) {route}: {out[route]}")
        expect_routes(launches, ran,
                      tuple(k for k in counters if k not in ran),
                      f"phase 22 (c) {route}")
    return out


def _npz_same(a: str, b: str) -> bool:
    with np.load(a) as x, np.load(b) as y:
        return x.files == y.files and all(
            x[k].dtype == y[k].dtype and x[k].tobytes() == y[k].tobytes()
            for k in x.files)


def hf_families(dev, llm, quant, checkpoint, cli, counters,
                work: str) -> dict:
    """(d): each of HF_FAMILIES at HF_WIDTHS, a numpy state dict converted
    by ``convert --family F-hf --bits 4`` on the card and with ``--device
    cpu``: the checkpoints byte-equal; then one bucket-16 prefill on the
    card (W4A8 and its quantization launched, nothing else) against the
    CPU on the dequantized weights with W4A8's activation quantization
    where the card ran W4A8, the card's experts forced on MoE families
    (router flips within twice the noise), within WIDTH_TOL rel L2."""
    out = {}
    toks = torch.randint(0, HF_WIDTHS["vocab"], (HF_BUCKET,),
                         generator=torch.Generator().manual_seed(SEED))
    length = HF_BUCKET - 3
    for i, family in enumerate(HF_FAMILIES):
        t0 = time.perf_counter()
        src = os.path.join(work, f"{family}.npz")
        np.savez(src, **hf_family_state(family, HF_WIDTHS, SEED + 50 + i))
        dirs = {d: os.path.join(work, f"{family}_{d}") for d in ("card",
                                                                  "cpu")}
        rcs = [run_cli(cli, ["convert", src, "-o", dirs[d], "--family",
                             f"{family}-hf", "--bits", "4", "--device",
                             "cuda" if d == "card" else "cpu",
                             *hf_family_args(family, HF_WIDTHS)])[0]
               for d in ("card", "cpu")]
        same = rcs == [0, 0] and _npz_same(
            os.path.join(dirs["card"], "arrays.npz"),
            os.path.join(dirs["cpu"], "arrays.npz"))
        if not same:
            raise AssertionError(f"phase 22 (d) {family}: exit codes {rcs}, "
                                 "card and cpu checkpoints differ")
        params, cfg, _ = checkpoint.load_checkpoint(dirs["card"], device=dev)
        moe = bool(cfg.n_experts)
        tap = RouterTap(llm) if moe else None
        _zero(counters)
        try:
            lg, _ = llm.prefill(params, cfg, toks.to(dev), length,
                                llm.KVCache.create(cfg, max_seq=HF_BUCKET,
                                                   device=dev))
        finally:
            card_sel, card_ids = tap.close() if moe else ([], [])
        ran = ("q4_matmul_w4a8", "quantize_activations")
        expect_routes(_counts(counters), ran,
                      tuple(k for k in counters if k not in ran),
                      f"phase 22 (d) {family}")
        cpu = dequantized_on_cpu(quant, params)
        groups = (w4a8_groups(quant, params, cpu)
                  if torch.device(dev).type == "cuda" else {})
        tap = RouterTap(llm, forced=card_ids) if moe else None
        try:
            with w4a8_activations(llm, quant, groups):
                lc, _ = llm.prefill(cpu, cfg, toks, length,
                                    llm.KVCache.create(cfg, max_seq=HF_BUCKET,
                                                       device="cpu"))
        finally:
            cpu_sel, _ = tap.close() if moe else ([], [])
        flips, noise = [], 0.0
        if moe:
            flips, noise = router_flips(llm._top_k_first, card_sel, card_ids,
                                        cpu_sel, cfg.n_experts_used, length)
            check_router_flips(flips, noise, f"phase 22 (d) {family}")
        err = rel_l2(lg.cpu(), lc)
        out[family] = {"rel_l2": err, "flips": len(flips),
                       "router_noise": noise,
                       "seconds": time.perf_counter() - t0}
        log(f"  d {family}-hf: convert --bits 4 card == cpu bytes; prefill "
            f"bucket {HF_BUCKET} rel_l2 card vs cpu {err:.3e}"
            + (f", {len(flips)} router flips (noise {noise:.3e})" if moe
               else "") + f" ({out[family]['seconds']:.2f} s)")
        if not (torch.isfinite(lg).all() and err < WIDTH_TOL):
            raise AssertionError(f"phase 22 (d) {family}: rel L2 {err}")
        del params, cpu
    return out


def qwen3next_profile(dev) -> dict:
    """PERF.md §5's Qwen3-Next rows (``chip_smoke.py --qwen3next-profile``,
    a process of its own): (a)'s model, the cortex prompt's prefill behind
    MambaRunner and Q3N_PROFILE_TOKENS decode steps, each window on the
    host clock and under the profiler."""
    from trackiellm_tpu_torch.llm import runner as runner_mod
    from trackiellm_tpu_torch.llm import tokenizer as tokenizer_mod
    from trackiellm_tpu_torch.models import mamba
    from trackiellm_tpu_torch.models import qwen3next as q3n
    cfg = q3n_config(q3n)
    params = q3n_model(dev, q3n, cfg)
    tok = tokenizer_mod.ByteTokenizer(cfg.vocab_size)
    runner = mamba.MambaRunner(params, cfg, tok, runner_mod.GenerationConfig(
        max_tokens=1, temperature=0.0), device=dev)
    prompt = runner.build_prompt(SYSTEM, CONTEXT, QUESTIONS[0])
    runner.generate(prompt)
    ids = tok.encode(prompt, add_bos=True)

    def prefill():
        def run():
            cache = q3n.create_cache(cfg, device=dev)
            for pos in range(0, len(ids), runner.CHUNK):
                chunk = ids[pos:pos + runner.CHUNK]
                cache = q3n.prefill(params, cfg, runner._padded(chunk),
                                    len(chunk), cache)[1]
        return run

    def steps():
        cache = runner.cache
        lg = q3n.decode_step(params, cfg, 0, cache)[0]

        def run():
            nonlocal lg, cache
            for _ in range(Q3N_PROFILE_TOKENS):
                lg, cache = q3n.decode_step(params, cfg, torch.argmax(lg),
                                            cache)
        return run
    return {"layers": cfg.n_layers,
            "w4a8_calls_a_forward": q3n_w4a8_calls(params, cfg),
            "prompt_tokens": len(ids),
            "prefill": window_breakdown("Qwen3-Next prefill", prefill),
            "decode": window_breakdown("Qwen3-Next decode", steps,
                                       Q3N_PROFILE_TOKENS)}


def phase_qwen3next(dev, counters, work: str) -> dict:
    """Phase 22 (the constants above Q3N_LAYERS): (a) Qwen3-Next-80B-A3B
    at 4 layers behind MambaRunner, (b) card against CPU at 2 layers, (c)
    the HF and GGUF routes through the CLI, (d) the other *-hf families;
    each part's seconds, and the launches of (a)'s and (c)'s windows."""
    from trackiellm_tpu_torch import __main__ as cli
    from trackiellm_tpu_torch.llm import runner as runner_mod
    from trackiellm_tpu_torch.llm import tokenizer as tokenizer_mod
    from trackiellm_tpu_torch.models import checkpoint, llm, mamba
    from trackiellm_tpu_torch.models import qwen3next as q3n
    from trackiellm_tpu_torch.ops import quant
    t0 = time.perf_counter()
    parts = {}

    def lap(part: str) -> None:
        parts[part] = time.perf_counter() - t0 - sum(parts.values())
    out = {}
    out["a"], params = q3n_full(dev, q3n, mamba, runner_mod, tokenizer_mod,
                                counters, q3n_config(q3n))
    lap("a")
    out["b"] = q3n_sweep(dev, q3n, llm, quant, params, q3n_config(q3n))
    del params
    torch.cuda.empty_cache()
    lap("b")
    out["c"] = q3n_cli(dev, cli, counters, work)
    lap("c")
    out["d"] = hf_families(dev, llm, quant, checkpoint, cli, counters, work)
    torch.cuda.empty_cache()
    lap("d")
    windows = (out["a"]["launches"],
               *(v["launches"] for v in out["c"].values()))
    out["launches"] = {k: sum(w[k] for w in windows) for k in counters}
    out["seconds"] = time.perf_counter() - t0
    out["part_seconds"] = parts
    log(f"  phase 22 took {out['seconds']:.1f} s ("
        + ", ".join(f"({k}) {v:.1f}" for k, v in parts.items())
        + f"); launches {out['launches']}")
    return out


# Phase 23: the training path. (a) LoRA over Mistral-7B Q4 at its 32
# layers; (b) its first TRAIN_CHECK_LAYERS layers card against CPU on the
# f32a, W4A8 and Q8 routes; (c) make_train_step on small dense and MoE
# configs; (d) the wake-word trainer.
TRAIN_RANK = 8
# torch.optim.Adam's learning rate in (a). tests/test_lora.py's 1e-2 (a
# 2-layer model) diverged at 32 layers: losses 10.86, 9.61, 11.30, 32.62
# over (a)'s four batches (the first run of phase 23 on an H100 80GB HBM3
# at 700 W): Adam's first steps move every B entry by the full rate, and
# 128 adapted projections add up.
TRAIN_LR = 1e-3
TRAIN_STEPS = 4
TRAIN_BATCH = 2           # packed rows a step: M = 512 rows on W4A8
TRAIN_SEQ = 256
TRAIN_CHECK = (2, 1, 128)   # (b): layers, rows, tokens a row
# (b)'s rel L2 of every adapter gradient (and of the loss) card against
# CPU on the f32a route and on a Q8 base, where both sides multiply exact
# activations by the same dequantized weights. Predicted <= 1e-3 before
# the first run; measured 1.036e-2 (f32a) and 9.926e-3 (Q8), the loss
# within 7.1e-5 (the second run of phase 23, on an H100 80GB HBM3 at
# 700 W): the model's activations are bf16, rounded after every projection
# and norm, and an f32 sum in another order flips some of those roundings
# (with f32 activations the card test holds the same step to 1e-4). The
# tolerance is the f32a prefill's (EXACT_WIDTH_TOL).
TRAIN_F32A_TOL = EXACT_WIDTH_TOL
# The W4A8 route quantizes the forward's activations to int8 and its
# backward is the exact product's (straight-through): its gap is reported;
# this bound only catches a gradient that is wrong outright.
TRAIN_W4A8_SANITY = 0.25
TRAIN_SMALL = {   # (c): widths of a small dense model; the MoE adds experts
    "vocab_size": 512, "dim": 512, "n_layers": 2, "n_heads": 8,
    "n_kv_heads": 4, "head_dim": 64, "hidden_dim": 1024, "max_seq": 128,
    "sliding_window": 128}
TRAIN_SMALL_MOE = {"n_experts": 4, "n_experts_used": 2}
TRAIN_SMALL_LR = 3e-3
TRAIN_SMALL_TOL = 1e-5    # rel, (c)'s losses: f32 on both sides, TF32 off
TRAIN_WAKE_PAIRS = 96     # (d): keyword/imposter pairs, the tool's default
TRAIN_WAKE_STEPS = 10     # (d) card against CPU
TRAIN_WAKE_TOL = 1e-4     # rel L2 a leaf after TRAIN_WAKE_STEPS Adam steps
TRAIN_WAKE_FULL = 600     # (d)'s full run on the card, the tool's default


def train_texts() -> list:
    """The documents of (a)'s packed rows: the cortex's system prompt, its
    context and the questions, repeated until they fill the steps."""
    base = [SYSTEM, CONTEXT, *QUESTIONS, SHORT_PROMPT]
    need = TRAIN_STEPS * TRAIN_BATCH * TRAIN_SEQ
    texts, size = [], 0
    while size < need + TRAIN_SEQ:
        for t in base:
            texts.append(t)
            size += len(t.encode()) + 1
    return texts


def lora_grads(lora, train, params, cfg, adapters, tokens):
    """(loss, {target.a/b: gradient on the CPU}) of one LoRA loss."""
    for t in lora.lora_parameters(adapters):
        t.grad = None
    loss = train.lm_loss(lora.attach_lora(params, adapters), cfg, tokens)
    loss.backward()
    return float(loss.detach()), {
        f"{name}.{leaf}": adapters[name][leaf].grad.float().cpu()
        for name in lora.DEFAULT_TARGETS for leaf in "ab"}


def fresh_copy(tree, device):
    """A copy of a dict tree of tensors on ``device`` (a copy on the same
    device too: each run trains its own)."""
    if isinstance(tree, dict):
        return {k: fresh_copy(v, device) for k, v in tree.items()}
    return tree.detach().to(device, copy=True)


def adapters_on(adapters, device):
    """A copy of an adapter tree on ``device``, A and B trainable."""
    return {k: ({kk: vv.detach().to(device).requires_grad_()
                 for kk, vv in v.items()} if k != "__alpha__"
                else v.to(device)) for k, v in adapters.items()}


def backward_product_ms(quant, params, cfg, dev) -> dict:
    """The backward product of each frozen projection at (a)'s M rows
    (``quantized_matmul_grad``: dequantize, then an f32 matmul), ms by CUDA
    events beside its bound (the packed weight, scales, dy and dx moved
    once; 2 M K N f32 operations)."""
    m = TRAIN_BATCH * TRAIN_SEQ
    gen = torch.Generator(device=dev).manual_seed(SEED)
    layer0 = {name: quant.QuantizedLinear(w.values[0], w.scales[0])
              for name, w in params["layers"].items()
              if isinstance(w, quant.QuantizedLinear)}
    out = {}
    for name, qw in (*layer0.items(), ("lm_head", params["lm_head"])):
        dy = torch.randn((m, qw.n), generator=gen, device=dev)
        dx = quant.quantized_matmul_grad(dy, qw)
        bound, by = bound_ms((qw.values, qw.scales, dy, dx),
                             2.0 * m * qw.k * qw.n, "f32")
        ms = time_ms(lambda: quant.quantized_matmul_grad(dy, qw), iters=5)
        out[name] = {"k": qw.k, "n": qw.n, "m": m, "ms": ms,
                     "bound_ms": bound, "bound_by": by}
        log(f"  backward product {name} ({qw.k} x {qw.n}, M={m}): "
            f"{ms:.4f} ms, bound {bound:.4f} ({by})")
    return out


def training_lora(dev, llm, lora, train, data, quant, tokenizer_mod,
                  counters) -> tuple:
    """(a): Mistral-7B Q4 at its 32 layers with rank-TRAIN_RANK adapters on
    the four default targets, TRAIN_STEPS steps of make_lora_train_step
    under Adam(TRAIN_LR) on PackedDataset rows prefetched to the card, a
    new batch each step.
    Returns (result, params)."""
    cfg = serve_config(llm)
    params = build_model(dev, llm, cfg, 4)
    adapters = lora.init_lora(torch.Generator(device=dev).manual_seed(SEED),
                              params, rank=TRAIN_RANK)
    ds = data.PackedDataset(train_texts(),
                            tokenizer_mod.ByteTokenizer(cfg.vocab_size),
                            seq_len=TRAIN_SEQ)
    batches = data.PrefetchIterator(ds.batches(TRAIN_BATCH, seed=SEED),
                                    device=dev)
    opt = torch.optim.Adam(lora.lora_parameters(adapters), lr=TRAIN_LR)
    step = lora.make_lora_train_step(params, cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    losses, step_ms, w4a8 = [], [], []
    _zero(counters)
    for _ in range(TRAIN_STEPS):
        before = counters["q4_matmul_w4a8"].launches
        t0 = time.perf_counter()
        adapters, opt, loss = step(adapters, opt, next(batches))
        losses.append(float(loss))
        step_ms.append((time.perf_counter() - t0) * 1e3)
        w4a8.append(counters["q4_matmul_w4a8"].launches - before)
    launches = _counts(counters)
    peak = torch.cuda.max_memory_allocated(dev)
    expect_routes(launches, ("q4_matmul_w4a8", "quantize_activations"),
                  ("q8_matmul", "q4_matmul_f32a", "flash_attention",
                   "fused_mlp_q4", *DIAGNOSTIC), "phase 23 (a)")
    # A step: each layer's four projections in the forward and again in
    # the checkpointed recompute, and the head once.
    for n in w4a8:
        expect_launches(n, 2 * 4 * cfg.n_layers + 1, "phase 23 (a): W4A8")
    expect_launches(launches["quantize_activations"],
                    launches["q4_matmul_w4a8"], "phase 23 (a): quantization")
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"phase 23 (a): losses {losses} do not fall")
    layer0 = {f"{name}.{leaf}": float(
        adapters[name][leaf].grad[0].abs().max())
        for name in lora.DEFAULT_TARGETS for leaf in "ab"}
    if min(layer0.values()) <= 0.0:
        raise AssertionError(f"phase 23 (a): layer 0's adapter gradients "
                             f"{layer0}: the gradient did not cross the "
                             f"{cfg.n_layers - 1} frozen layers above it")
    if float(adapters["__alpha__"]) != 16.0:
        raise AssertionError("phase 23 (a): alpha moved")
    log(f"  (a) Mistral-7B Q4 {cfg.n_layers} layers, LoRA rank {TRAIN_RANK}"
        f" on {len(lora.DEFAULT_TARGETS)} targets, {TRAIN_STEPS} steps of "
        f"B={TRAIN_BATCH} x S={TRAIN_SEQ}: losses "
        + ", ".join(f"{v:.4f}" for v in losses)
        + f"; step ms " + ", ".join(f"{v:.1f}" for v in step_ms)
        + f"; W4A8 launches a step {w4a8}; peak {peak / 2 ** 30:.2f} GiB;"
        f" layer 0's largest |grad| {min(layer0.values()):.3e} and up")
    result = {"layers": cfg.n_layers, "rank": TRAIN_RANK,
              "rows": TRAIN_BATCH, "seq": TRAIN_SEQ, "packed_rows": len(ds),
              "losses": losses, "step_ms": step_ms,
              "w4a8_launches_a_step": w4a8,
              "peak_gib": peak / 2 ** 30, "layer0_grad_max": layer0,
              "launches": launches,
              "backward_product": backward_product_ms(quant, params, cfg,
                                                      dev)}
    return result, params


def training_check(dev, llm, lora, train, quant, params, counters) -> dict:
    """(b): the first TRAIN_CHECK layers of (a)'s model (views), one LoRA
    loss and its adapter gradients on a packed row's first tokens, card
    against CPU: the f32a route (exact activations, as on the CPU) within
    TRAIN_F32A_TOL, the default W4A8 route's gap, and a Q8 base of the same
    widths within TRAIN_F32A_TOL. The CPU multiplies by the card's
    dequantized weights (``dequantized_on_cpu``), the function its plain
    route computes, dequantized once."""
    from trackiellm_tpu_torch.tools.diag_envelope import layer_slice
    n, rows, seq = TRAIN_CHECK
    cfg = serve_config(llm)._replace(n_layers=n)
    cpu = torch.device("cpu")
    gen = torch.Generator().manual_seed(SEED + 1)
    tokens = torch.randint(0, 256, (rows, seq), generator=gen)
    cut = layer_slice(params, n)
    adapters = lora.init_lora(torch.Generator().manual_seed(SEED), cut,
                              rank=TRAIN_RANK)
    with torch.no_grad():
        for name in lora.DEFAULT_TARGETS:   # B != 0: A gets a gradient too
            adapters[name]["b"].normal_(0.0, 0.01, generator=gen)
    out = {"layers": n, "rows": rows, "seq": seq}
    windows = []

    def compare(tag, base, want, route_env, ran, idle):
        with levers_on(route_env):
            _zero(counters)
            loss, got = lora_grads(lora, train, base, cfg,
                                   adapters_on(adapters, dev),
                                   tokens.to(dev))
            torch.cuda.synchronize()
            launches = _counts(counters)
        expect_routes(launches, ran, idle, f"phase 23 (b) {tag}")
        windows.append(launches)
        want_loss, want_grads = want
        rels = {k: rel_l2(got[k], want_grads[k]) for k in want_grads}
        out[tag] = {"loss": loss, "cpu_loss": want_loss,
                    "loss_rel": abs(loss - want_loss) / abs(want_loss),
                    "grad_rel_l2": rels, "max_grad_rel_l2": max(
                        rels.values()), "launches": launches}
        log(f"  (b) {tag}: loss {loss:.6f} (cpu {want_loss:.6f}), adapter "
            f"gradients rel L2 max {max(rels.values()):.3e} over "
            f"{len(rels)}; launches "
            f"{ {k: v for k, v in launches.items() if v} }")
        return out[tag]

    def on_cpu(base):
        return lora_grads(lora, train, dequantized_on_cpu(quant, base), cfg,
                          adapters_on(adapters, cpu), tokens)
    others = ("flash_attention", "fused_mlp_q4", *DIAGNOSTIC)
    want = on_cpu(cut)
    exact = compare("f32a", cut, want, ("TRACKIE_Q4_F32A",),
                    ("q4_matmul_f32a",), ("q4_matmul_w4a8",
                                          "quantize_activations",
                                          "q8_matmul", *others))
    w4a8 = compare("w4a8", cut, want, (), ("q4_matmul_w4a8",),
                   ("q4_matmul_f32a", "q8_matmul", *others))
    q8 = build_model(dev, llm, cfg, 8)
    q8_row = compare("q8", q8, on_cpu(q8), (), ("q8_matmul",),
                     ("q4_matmul_w4a8", "quantize_activations",
                      "q4_matmul_f32a", *others))
    del q8
    for tag, row in (("f32a", exact), ("q8", q8_row)):
        if max(row["max_grad_rel_l2"], row["loss_rel"]) > TRAIN_F32A_TOL:
            raise AssertionError(
                f"phase 23 (b) {tag}: card against CPU "
                f"{row['max_grad_rel_l2']:.3e} (loss {row['loss_rel']:.3e})"
                f", above {TRAIN_F32A_TOL}")
    if not w4a8["max_grad_rel_l2"] <= TRAIN_W4A8_SANITY:
        raise AssertionError(f"phase 23 (b) w4a8: gradients "
                             f"{w4a8['max_grad_rel_l2']:.3e} from the CPU's")
    out["launches"] = {k: sum(w[k] for w in windows) for k in windows[0]}
    return out


def training_small(dev, llm, train) -> dict:
    """(c): two AdamW steps of make_train_step (make_optimizer at
    TRAIN_SMALL_LR) on a small dense and a small MoE config in f32, card
    against CPU from the same params and tokens: losses within
    TRAIN_SMALL_TOL."""
    out = {}
    gen = torch.Generator().manual_seed(SEED + 2)
    for tag, extra in (("dense", {}), ("moe", TRAIN_SMALL_MOE)):
        cfg = llm.LLMConfig(**TRAIN_SMALL, **extra)
        start = llm.init_params(torch.Generator().manual_seed(SEED), cfg,
                                dtype=torch.float32)
        tokens = torch.randint(0, cfg.vocab_size, (2, 64), generator=gen)
        losses = {}
        for where in ("card", "cpu"):
            device = dev if where == "card" else torch.device("cpu")
            params = fresh_copy(start, device)
            leaves = train.param_leaves(params)
            for t in leaves:
                t.requires_grad_()
            opt = train.make_optimizer(TRAIN_SMALL_LR)(leaves)
            step = train.make_train_step(cfg)
            losses[where] = [float(step(params, opt,
                                        tokens.to(device))[2])
                             for _ in range(2)]
        rel = max(abs(a - b) / abs(b)
                  for a, b in zip(losses["card"], losses["cpu"]))
        out[tag] = {**losses, "max_rel": rel}
        log(f"  (c) {tag}: card losses {losses['card']}, cpu "
            f"{losses['cpu']}, rel {rel:.3e}")
        if rel > TRAIN_SMALL_TOL:
            raise AssertionError(f"phase 23 (c) {tag}: losses {rel:.3e} "
                                 f"apart, above {TRAIN_SMALL_TOL}")
    return out


def wake_leaves(params) -> dict:
    """A wake-word tree's tensors by dotted name."""
    return {f"{k}.{kk}" if isinstance(v, dict) else k: t
            for k, v in params.items()
            for kk, t in (v.items() if isinstance(v, dict) else [("", v)])}


def training_wake_word(dev) -> dict:
    """(d): train_wake_word at the bundled artifact's config on the
    synthetic set (the tool's TRAIN_WAKE_PAIRS keyword/imposter pairs),
    TRAIN_WAKE_STEPS
    Adam steps on the card and on the CPU from one init, every leaf within
    TRAIN_WAKE_TOL rel L2; then the tool's full TRAIN_WAKE_FULL steps on
    the card, timed, with its held-out false-accept/reject rates."""
    from trackiellm_tpu_torch.audio import wake_word as ww
    from trackiellm_tpu_torch.tools import train_wake_word_default as tool
    cfg = ww.WakeWordConfig()
    mels, labels = tool.training_set(TRAIN_WAKE_PAIRS, dev)
    start = ww.init_wake_word(torch.Generator().manual_seed(1), cfg)
    on_card = {k: ({kk: vv.to(dev) for kk, vv in v.items()}
                   if isinstance(v, dict) else v.to(dev))
               for k, v in start.items()}
    card = ww.train_wake_word(on_card, cfg, mels, labels,
                              steps=TRAIN_WAKE_STEPS)
    cpu = ww.train_wake_word(start, cfg, mels.cpu(), labels.cpu(),
                             steps=TRAIN_WAKE_STEPS)
    want = wake_leaves(cpu)
    rels = {k: rel_l2(v.cpu(), want[k]) for k, v in wake_leaves(card).items()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    full = ww.train_wake_word(on_card, cfg, mels, labels,
                              steps=TRAIN_WAKE_FULL)
    torch.cuda.synchronize()
    full_s = time.perf_counter() - t0
    rates = tool.held_out(full, cfg, dev)
    log(f"  (d) wake word: {TRAIN_WAKE_STEPS} steps card vs cpu rel L2 max "
        f"{max(rels.values()):.3e}; {TRAIN_WAKE_FULL} steps on the card in "
        f"{full_s:.2f} s, held out {rates}")
    if max(rels.values()) > TRAIN_WAKE_TOL:
        raise AssertionError(f"phase 23 (d): wake-word params {rels} apart, "
                             f"above {TRAIN_WAKE_TOL}")
    return {"clips": int(mels.shape[0]), "steps": TRAIN_WAKE_STEPS,
            "rel_l2": rels, "full_steps": TRAIN_WAKE_FULL,
            "full_s": full_s, **rates}


TRAIN_PROFILE_FLAG = "--training-profile"


def training_profile(dev) -> dict:
    """PERF.md §5's LoRA-step row (``chip_smoke.py --training-profile``, a
    process of its own): (a)'s model and adapters, one warm step, then a
    step on fresh tokens on the host clock and another under the
    profiler."""
    from trackiellm_tpu_torch.models import llm, lora
    cfg = serve_config(llm)
    params = build_model(dev, llm, cfg, 4)
    adapters = lora.init_lora(torch.Generator(device=dev).manual_seed(SEED),
                              params, rank=TRAIN_RANK)
    opt = torch.optim.Adam(lora.lora_parameters(adapters), lr=TRAIN_LR)
    step = lora.make_lora_train_step(params, cfg)
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def fresh():
        toks = torch.randint(0, 256, (TRAIN_BATCH, TRAIN_SEQ), generator=gen,
                             device=dev)
        return lambda: step(adapters, opt, toks)
    fresh()()
    return {"layers": cfg.n_layers, "rows": TRAIN_BATCH, "seq": TRAIN_SEQ,
            "rank": TRAIN_RANK,
            "step": window_breakdown("LoRA step (32 layers)", fresh)}


def phase_training(dev, counters) -> dict:
    """Phase 23 (the constants above ``train_texts``): (a) LoRA over
    Mistral-7B Q4 at 32 layers, (b) card against CPU at 2 layers on the
    f32a, W4A8 and Q8 routes, (c) make_train_step small, (d) the wake-word
    trainer; each part's seconds, and the launches of (a)'s and (b)'s
    windows."""
    from trackiellm_tpu_torch.llm import tokenizer as tokenizer_mod
    from trackiellm_tpu_torch.models import llm, lora
    from trackiellm_tpu_torch.ops import quant
    from trackiellm_tpu_torch.parallel import data, train
    t0 = time.perf_counter()
    parts = {}

    def lap(part: str) -> None:
        parts[part] = time.perf_counter() - t0 - sum(parts.values())
    out = {}
    out["a"], params = training_lora(dev, llm, lora, train, data, quant,
                                     tokenizer_mod, counters)
    lap("a")
    out["b"] = training_check(dev, llm, lora, train, quant, params,
                              counters)
    del params
    torch.cuda.empty_cache()
    lap("b")
    out["c"] = training_small(dev, llm, train)
    lap("c")
    out["d"] = training_wake_word(dev)
    lap("d")
    windows = (out["a"]["launches"], out["b"]["launches"])
    out["launches"] = {k: sum(w[k] for w in windows) for k in counters}
    out["seconds"] = time.perf_counter() - t0
    out["part_seconds"] = parts
    log(f"  phase 23 took {out['seconds']:.1f} s ("
        + ", ".join(f"({k}) {v:.1f}" for k, v in parts.items())
        + f"); launches {out['launches']}")
    return out


def serve_config(llm):
    """Phases 5-7 and 12's configuration: Mistral-7B cut to max_seq 512."""
    return llm.LLMConfig.mistral_7b()._replace(max_seq=512,
                                              sliding_window=512)


# Phases 6, 7 and 12 run Mistral-7B cut to CUT_LAYERS layers (phase 6
# builds its Q8 model so; 7 and 12 take views of phase 5's first layers):
# depth cut so that the smoke stays near its 1,000-s aim as phases join
# (phases 1-16 took 1,006.7 s at 32 layers; 16 once phase 16 joined; 4
# since phase 17 joined: phases 1-17 took 1,156.6 s with 8 here, phase
# 11's GGUF at 4 layers and phase 16's models at 21 and 16, on an H100
# 80GB HBM3 at 700 W). Phase 5, the main path, keeps all 32.
CUT_LAYERS = 4


def result_line(kind: str) -> str:
    """The last line of the run: it used one card, of this kind."""
    return json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": 1}})


# name: (source, TPU kernel it replaces, the cases whose times the JSON line
# carries (the first at its top level), the phase whose path counts its
# launches). quantize_activations is the W4A8 wrapper's first launch: it
# replaces the pre-pass that runs before the Pallas W4A8 call.
KERNELS = {
    "q4_matmul_w4a8": ("trackiellm_tpu_torch/csrc/q4_w4a8.cu",
                       "trackiellm_tpu/ops/quant.py:662",
                       ("w_gu M=1", "w_gu M=512",
                        "qwen3next expert w_down K=512 M=1",
                        "qwen3next lm_head N=151936 M=1"), 5),
    "quantize_activations": ("trackiellm_tpu_torch/csrc/q4_w4a8.cu",
                             "trackiellm_tpu/ops/quant.py:595",
                             ("M=1 K=4096", "M=512 K=4096"), 5),
    "flash_attention": ("trackiellm_tpu_torch/csrc/flash_attn.cu",
                        "trackiellm_tpu/ops/attention.py:176",
                        ("causal S=512 bfloat16", "causal S=256 bfloat16",
                         "causal S=1024 D=256 bfloat16",
                         "causal S=512 D=96 bfloat16",
                         "causal S=512 D=192 bfloat16"), 5),
    "q8_matmul": ("trackiellm_tpu_torch/csrc/q8_matmul.cu",
                  "trackiellm_tpu/ops/quant.py:184",
                  ("w_gu M=1", "w_gu M=512",
                   "qwen3next lm_head N=151936 M=1"), 6),
    "q4_matmul_f32a": ("trackiellm_tpu_torch/csrc/q4_f32a.cu",
                       "trackiellm_tpu/ops/quant.py:272",
                       ("w_gu M=1", "w_gu M=512"), 7),
    "fused_mlp_q4": ("trackiellm_tpu_torch/csrc/fused_mlp_q4.cu",
                     "trackiellm_tpu/ops/fused.py:144", ("M=1 bfloat16",), 7),
    "q4_matmul_stream": ("trackiellm_tpu_torch/csrc/q4_stream.cu",
                         "trackiellm_tpu/ops/quant.py:389", ("w_gu M=1",), 9),
    "stream": ("trackiellm_tpu_torch/csrc/diag_probes.cu",
               "tools/diag_envelope.py:60", ("512 MiB",), 9),
    "grid64": ("trackiellm_tpu_torch/csrc/diag_probes.cu",
               "tools/diag_scan_overhead.py:70", ("(8, 128)",), 9),
    "chain_tiny": ("trackiellm_tpu_torch/csrc/diag_probes.cu",
                   "tools/diag_overhead.py:101", ("64 calls (8, 128)",), 9),
}


# Keys a kernel's cases carry where its rows have them: the fused block's
# unfused yardstick, the chain's CUDA-event spans, why a case has no
# device-only time.
EXTRA_KEYS = {"unfused_ms": "unfused", "unfused_device_ms": "unfused_device",
              "event_ms": "event_ms", "library_event_ms": "library_event_ms",
              "device_note": "device_note"}


def kernels_line(rows, launches) -> str:
    """The ``{"kernels": [...]}`` line: per kernel, the main path's
    launches and its headline cases' times, bound and library time."""
    kernels = []
    for name, (src, replaces, headlines, phase) in KERNELS.items():
        cases = []
        for case in headlines:
            r = next(r for r in rows[name] if r["case"] == case)
            device = r.get("device")
            cases.append({
                "case": case, "ms": r["ms"], "plain_ms": r["plain"],
                "bound_ms": r["bound"], "bound_by": r["bound_by"],
                "library_ms": r.get("library"),
                "device_ms": device["total"] if device else None,
                "library_device_ms": r.get("library_device"),
                **{key: r[field] for key, field in EXTRA_KEYS.items()
                   if field in r}})
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches[phase][name],
            "max_abs_err": max(r["err"] for r in rows[name]),
            **{k: v for k, v in cases[0].items() if k != "case"},
            "timed_case": headlines[0], "launches_phase": phase,
            "launches_by_phase": {str(p): n[name]
                                  for p, n in sorted(launches.items())},
            "cases": cases})
    return json.dumps({"kernels": kernels})


def main() -> int:
    main_t0 = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    cap = torch.cuda.get_device_capability(0)
    if cap != (9, 0):
        print(f"chip_smoke: needs an sm_90 card, found {cap}", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    for name in LEVERS:  # phases 3-6 and 8 run the default routes
        os.environ.pop(name, None)
    if sys.argv[1:] == [SERVE_PROFILE_FLAG]:
        return serve_profile_main(dev)
    if sys.argv[1:] == [VOICE_PROFILE_FLAG]:
        print(json.dumps(voice_profile(dev)), flush=True)
        return 0
    if sys.argv[1:] == [VISION_PROFILE_FLAG]:
        print(json.dumps(vision_profile(dev)), flush=True)
        return 0
    if sys.argv[1:] == [FAMILY_PROFILE_FLAG]:
        return family_profile_main(dev)
    if sys.argv[1:] == [MOE_PROFILE_FLAG]:
        return moe_profile_main(dev)
    if sys.argv[1:] == [PERCEPTION_PROFILE_FLAG]:
        print(json.dumps(perception_profile(dev)), flush=True)
        return 0
    if sys.argv[1:] == [MLA_PROFILE_FLAG]:
        print(json.dumps(mla_profile(dev)), flush=True)
        return 0
    if sys.argv[1:] == [Q3N_PROFILE_FLAG]:
        print(json.dumps(qwen3next_profile(dev)), flush=True)
        return 0
    if sys.argv[1:] == [TRAIN_PROFILE_FLAG]:
        print(json.dumps(training_profile(dev)), flush=True)
        return 0
    smi = nvidia_smi()
    log(f"phase 1 device: torch {torch.__version__} cuda {torch.version.cuda}"
        f" capability {cap} | {smi}")

    from trackiellm_tpu_torch import __main__ as cli
    from trackiellm_tpu_torch.llm import paging
    from trackiellm_tpu_torch.llm import runner as runner_mod
    from trackiellm_tpu_torch.llm import server as server_mod
    from trackiellm_tpu_torch.llm import tokenizer as tokenizer_mod
    from trackiellm_tpu_torch.models import checkpoint, convert, llm
    from trackiellm_tpu_torch.ops import _build, attention, diag, fused, quant
    from trackiellm_tpu_torch.tools import measure_server
    from trackiellm_tpu_torch.tools.diag_envelope import layer_slice

    counters = launch_counters()
    work = tempfile.TemporaryDirectory(prefix="chip_smoke_")
    t0 = time.perf_counter()
    marks = {2: t0}

    def banner(msg: str) -> None:
        """A phase's first line, with the seconds since the build began."""
        marks[int(msg.split()[1])] = time.perf_counter()
        log(f"{msg} [{time.perf_counter() - t0:.1f} s]")
    path = _build.build()
    _build.library()
    build_s = time.perf_counter() - t0
    log(f"phase 2 build: nvcc and load {build_s:.1f} s -> "
        f"{path.relative_to(_build.BUILD_ROOT.parent.parent)}")

    banner("phase 3 kernels vs plain versions (card, L2 flushed per call):")
    cfg = serve_config(llm)
    rows = phase_kernels(dev, quant, attention, fused, llm, diag,
                         serve_shapes(runner_mod, quant.KERNEL_MAX_M,
                                      cfg.max_seq, SERVE_SLOTS))
    banner(f"phase 4 width check (Mistral-7B width, {WIDTH_LAYERS} "
           "layers):")
    phase_width(dev, llm, quant, fused)
    slice_args = (dev, llm, runner_mod, tokenizer_mod)
    launches = {}
    banner("phase 5 slice (Mistral-7B, 32 layers, Q4, max_seq 512):")
    params4 = build_model(dev, llm, cfg, 4)
    launches[5] = drive(*slice_args, params4, cfg, counters, "abcd")
    expect_routes(launches[5], ("q4_matmul_w4a8", "quantize_activations",
                                "flash_attention"),
                  ("q8_matmul", "q4_matmul_f32a", "fused_mlp_q4",
                   *DIAGNOSTIC), "phase 5")
    if launches[5]["quantize_activations"] != launches[5]["q4_matmul_w4a8"]:
        raise AssertionError("phase 5: not one activation quantization per "
                             "W4A8 matmul")
    log(json.dumps({"profile": profile_path(dev, runner_mod, tokenizer_mod,
                                            params4, cfg), "phase": 5}))
    cut_cfg = cfg._replace(n_layers=CUT_LAYERS)
    cut4 = layer_slice(params4, CUT_LAYERS)
    banner(f"phase 6 Q8 slice (Mistral-7B, {CUT_LAYERS} layers, Q8, max_seq "
           "512):")
    params8 = build_model(dev, llm, cut_cfg, 8)
    launches[6] = drive(*slice_args, params8, cut_cfg, counters, "abc")
    expect_routes(launches[6], ("q8_matmul", "flash_attention"),
                  ("q4_matmul_w4a8", "quantize_activations", "q4_matmul_f32a",
                   "fused_mlp_q4", *DIAGNOSTIC), "phase 6")
    log(json.dumps({"profile": profile_path(dev, runner_mod, tokenizer_mod,
                                            params8, cut_cfg), "phase": 6}))
    del params8
    banner(f"phase 7 opt-in Q4 routes (phase 5's model cut to {CUT_LAYERS} "
           "layers, TRACKIE_Q4_F32A=1, TRACKIE_FUSED_MLP=1):")
    with levers_on():
        launches[7] = drive(*slice_args, cut4, cut_cfg, counters, "ab")
        expect_routes(launches[7],
                      ("q4_matmul_f32a", "fused_mlp_q4", "flash_attention"),
                      ("q4_matmul_w4a8", "quantize_activations", "q8_matmul",
                       *DIAGNOSTIC), "phase 7")
        log(json.dumps({"profile": profile_path(
            dev, runner_mod, tokenizer_mod, cut4, cut_cfg), "phase": 7}))
    banner("phase 8 entry point (2-layer Q8 checkpoint, generate):")
    phase_entry(dev, llm, checkpoint, cli, counters)
    banner("phase 9 diagnostics (the three tools; phase 5's model cut to "
        "32/16/8 layers):")
    launches[9] = phase_diagnostics(dev, params4, cfg, counters)
    banner(f"phase 10 tool calls and speculation (phase 5's model, max_seq "
        f"{SLICE10_MAX_SEQ}):")
    slice10 = phase_slice10(
        dev, llm, runner_mod, tokenizer_mod, quant, params4,
        llm.LLMConfig.mistral_7b()._replace(max_seq=SLICE10_MAX_SEQ),
        counters)
    launches[10] = slice10["launches"]
    expect_routes(launches[10], ("q4_matmul_w4a8", "quantize_activations",
                                 "flash_attention", "q4_matmul_f32a"),
                  ("q8_matmul", "fused_mlp_q4", *DIAGNOSTIC), "phase 10")
    banner(f"phase 11 GGUF to reply (Mistral-7B width, {GGUF_LAYERS} layers, "
        "Q4_K_M file, convert --bits 4, generate):")
    gguf = phase_gguf(
        dev, llm.LLMConfig.mistral_7b()._replace(n_layers=GGUF_LAYERS), llm,
        convert, checkpoint, quant, tokenizer_mod, cli, counters,
        workdir=work.name)
    launches[11] = gguf.pop("launches")
    log(json.dumps({"gguf": gguf}))
    banner(f"phase 12 serving (phase 5's model cut to {CUT_LAYERS} layers, "
           f"{SERVE_SLOTS} slots, max_seq {cfg.max_seq}):")
    serve = phase_serve(dev, llm, runner_mod, tokenizer_mod, server_mod,
                        paging, measure_server, cut4, cut_cfg, counters,
                        profile=serve_profile_child)
    launches[12] = serve.pop("launches")
    del params4, cut4
    banner("phase 13 voice (Whisper-tiny GGML at 30-s and 10-s windows, "
        "large-v3 widths at 2+2 layers, Silero ONNX, TTS default, Piper "
        "VITS):")
    voice = phase_voice(dev, llm, cli, counters, voice_profile_child)
    banner("phase 14 vision (480x640 frame; YOLOv8n and YOLOv5nu at 640, "
           "MiDaS-small at 384, DPT-SwinV2 tiny_256, CRNN OCR, navigation):")
    vision = phase_vision(dev, counters, vision_profile_child)
    banner("phase 15 app loop (the bundled wake word, demo, measure_app_e2e: "
           "YOLOv8n, MiDaS-small, Whisper-tiny, Mistral-7B Q4, TTS):")
    app = phase_app(dev, cli, counters, app_e2e_child)
    launches[15] = app["launches"]
    banner("phase 16 dense families (Gemma-2-9B and Llama-3.1-8B Q4 at "
           f"their widths, {FAMILY_DEPTH['gemma2_9b']} layers, the 1- and "
           "2-layer sweep of the other presets, Command-R, Nemotron and "
           "StarCoder2 GGUFs):")
    families = phase_families(
        dev, llm, runner_mod, tokenizer_mod, server_mod, paging,
        measure_server, checkpoint, attention, quant, cli, counters,
        family_profile_child)
    launches[16] = families["launches"]
    banner(f"phase 17 MoE families (gpt-oss-20b at its widths cut to "
           f"{MOE_GPTOSS_LAYERS} layers, Qwen3-30B-A3B to {MOE_QWEN3_LAYERS},"
           " Q4; the 1-layer sweep of the other MoE presets; tiny gpt-oss "
           "and Llama-4 on the int8 pool and a tiny Llama-4 across chunks; "
           "the MoE GGUF arches):")
    moe = phase_moe(dev, llm, runner_mod, tokenizer_mod, server_mod, paging,
                    measure_server, checkpoint, quant, cli, counters,
                    moe_profile_child)
    launches[17] = moe["launches"]
    banner("phase 18 multimodal (LLaVA-1.5-7B Q4 at its widths and depth "
           "behind VLMRunner; the CLIP tower, LLaVA and PaliGemma-3B card "
           f"against CPU, text cut to {VLM_CUT_LAYERS} layers; an mmproj "
           "GGUF through convert --mmproj and generate --image; a cortex "
           "turn on a card frame):")
    vlm = phase_vlm(dev, llm, runner_mod, tokenizer_mod, quant, convert,
                    checkpoint, cli, counters,
                    os.path.join(work.name, "mistral.gguf"), work.name)
    launches[18] = vlm["launches"]
    banner("phase 19 outer surfaces (precompile in a child at Mistral-7B's "
           "full width and depth, the kernel-cache artifact restored into "
           "a fresh process, the ffi executor over VisionPipeline, a tk_* "
           f"sequence at Mistral-7B widths cut to {SURFACES_LAYERS} layers, "
           "device_trace and MetricsCollector):")
    surfaces = phase_surfaces(dev, llm, runner_mod, tokenizer_mod, counters,
                              build_s, work.name)
    launches[19] = surfaces["launches"]
    banner("phase 20 perception models (all-MiniLM-L6-v2, TrOCR-base, AST "
           "and the CNN sound classifier at their widths: card against CPU "
           f"at full depth or {PERCEPTION_CPU_LAYERS} layers, full depth "
           "timed and profiled, a TrackieApp turn with embed_fn, ocr_fn and "
           f"sound_fn, Mistral-7B widths at {SURFACES_LAYERS} layers):")
    perception = phase_perception(dev, llm, runner_mod, counters,
                                  perception_profile_child)
    launches[20] = perception["launches"]
    banner(f"phase 21 MLA and Mamba families (DeepSeek-V2-Lite Q4 at its "
           f"widths, {MLA_LAYERS} of 27 layers, behind LLMRunner(model=mla) "
           "and LLMServer(model=mla); V2-Lite, the V2/V3 knob sets and V3's "
           "widths card against CPU; Mamba-2.8B Q4 at 64 layers behind "
           "MambaRunner and LLMServer(model=mamba); Mamba-Codestral's widths "
           f"at {MAMBA2_LAYERS} layers; deepseek2 and mamba GGUFs through "
           "the CLI):")
    mla_mamba = phase_mla_mamba(dev, counters, work.name)
    launches[21] = mla_mamba["launches"]
    banner("phase 22 Qwen3-Next and the *-hf converters (Qwen3-Next-80B-A3B "
           f"Q4 at its widths, {len(Q3N_LAYERS)} of 48 layers, behind "
           "MambaRunner; 2 layers card against CPU; its HF and GGUF routes "
           f"through the CLI; {len(HF_FAMILIES)} more *-hf families "
           "converted on the card and the CPU):")
    qwen3next = phase_qwen3next(dev, counters, work.name)
    launches[22] = qwen3next["launches"]
    banner(f"phase 23 training (LoRA rank {TRAIN_RANK} over Mistral-7B Q4 "
           f"at 32 layers, {TRAIN_STEPS} steps of {TRAIN_BATCH} packed rows "
           f"of {TRAIN_SEQ}; {TRAIN_CHECK[0]} layers card against CPU on the "
           "f32a, W4A8 and Q8 routes; make_train_step on small dense and MoE "
           "configs; the wake-word trainer):")
    training = phase_training(dev, counters)
    launches[23] = training["launches"]
    end = time.perf_counter()
    work.cleanup()
    log(f"chip_smoke wall: {end - t0:.1f} s since the build began")
    marks[24] = end
    seconds = {"1": t0 - main_t0}
    seconds.update({str(n): marks[n + 1] - marks[n] for n in range(2, 24)
                    if n in marks and n + 1 in marks})
    print(json.dumps({"phase_seconds": seconds, "wall_s": end - main_t0}),
          flush=True)

    smi = nvidia_smi()
    print(json.dumps({"training": training, "card": smi}, default=str),
          flush=True)
    print(json.dumps({"qwen3next": qwen3next, "card": smi}, default=str),
          flush=True)
    print(json.dumps({"mla_mamba": mla_mamba, "card": smi}, default=str),
          flush=True)
    print(json.dumps({"perception": perception, "card": smi}, default=str),
          flush=True)
    print(json.dumps({"surfaces": surfaces, "card": smi}, default=str),
          flush=True)
    print(json.dumps({"vlm": vlm, "card": smi}), flush=True)
    print(json.dumps({"moe": moe, "moe_kernels": {
        k: [r for r in v if r["case"].startswith("gpt-oss")]
        for k, v in rows.items()}, "card": smi}), flush=True)
    print(json.dumps({"families": families, "card": smi}), flush=True)
    print(json.dumps({"app": app, "card": smi}), flush=True)
    print(json.dumps({"vision": vision, "card": smi}), flush=True)
    print(json.dumps({"voice": voice, "card": smi}), flush=True)
    print(json.dumps({"serve": serve, "card": smi}), flush=True)
    print(json.dumps({"slice10": slice10, "card": smi}), flush=True)
    print(smi, flush=True)
    print(kernels_line(rows, launches), flush=True)
    print(result_line(torch.cuda.get_device_name(0)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
