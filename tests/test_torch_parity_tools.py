"""The port's accuracy-parity twins (``trackiellm_tpu_torch.tools.
parity_*``) must be as turnkey as the JAX package's ``tools/parity_*.py``:
one command against real checkpoint paths gives the metric, and a missing
file fails with the same message and exit code 2.

Real checkpoints are absent here, so each twin runs in-process on the CPU
(``--device cpu``) against seeded synthetic files written by the test,
with the JAX package's tests' writers, and self-parity (a model's output
against its own) must score perfectly: exactly what a correct harness
reports the day real files appear. The twins' copied metric functions
give ``tools/parity_common``'s values on seeded inputs, exactly.

Nothing is written to the tree: the runs take ``--no-record``, or record
to a file under the test's temporary directory (``TRACKIE_PARITY_RESULTS``).
"""

import importlib
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
TOOLS = "trackiellm_tpu_torch.tools."


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run_main(tool, args, capsys):
    """The twin's main() in-process on the CPU; its last stdout line as
    JSON."""
    mod = importlib.import_module(TOOLS + tool)
    mod.main([*args, "--device", "cpu"])
    out = capsys.readouterr().out
    return json.loads(out.strip().splitlines()[-1])


MISSING = [
    ("parity_detector",
     ["--checkpoint", "/nope/yolo.pt", "--images", "/nope/imgs"]),
    ("parity_asr",
     ["--checkpoint", "/nope/whisper.pt", "--audio", "/nope/a",
      "--refs", "/nope/refs.tsv"]),
    ("parity_llm",
     ["--gguf", "/nope/model.gguf", "--transcript", "/nope/t.json"]),
    ("parity_depth",
     ["--checkpoint", "/nope/midas.pt", "--images", "/nope/imgs"]),
    ("parity_vad",
     ["--checkpoint", "/nope/silero.onnx", "--audio", "/nope/a.wav"]),
    ("parity_tts",
     ["--voice", "/nope/voice.onnx", "--config", "/nope/v.json",
      "--text", "ola"]),
    ("parity_embed",
     ["--checkpoint", "/nope/minilm.pt", "--texts", "/nope/s.txt"]),
    ("parity_vlm",
     ["--checkpoint", "/nope/ckpt", "--image", "/nope/i.npy",
      "--transcript", "/nope/t.json"]),
    ("parity_ocr",
     ["--checkpoint", "/nope/trocr.safetensors",
      "--config", "/nope/config.json", "--images", "/nope/crops"]),
]


@pytest.mark.parametrize("tool,args", MISSING, ids=[m[0] for m in MISSING])
def test_missing_checkpoint_fails_as_the_jax_tool(tool, args, capsys):
    """Each twin exits 2 with the JAX tool's "not found" message, before
    it builds anything; so does the JAX tool on the same arguments."""
    mod = importlib.import_module(TOOLS + tool)
    with pytest.raises(SystemExit) as exc:
        mod.main(args)
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert "not found" in err
    sys.path.insert(0, REPO)
    jmod = importlib.import_module("tools." + tool)
    old = sys.argv
    sys.argv = [tool, *args]
    try:
        with pytest.raises(SystemExit) as jexc:
            jmod.main()
    finally:
        sys.argv = old
    assert jexc.value.code == 2
    assert capsys.readouterr().err == err


def test_missing_checkpoint_as_a_command():
    """``python -m trackiellm_tpu_torch.tools.parity_llm`` runs as a
    command: exit 2 and the message, without a card."""
    proc = subprocess.run(
        [sys.executable, "-m", TOOLS + "parity_llm", "--gguf",
         "/nope/model.gguf", "--transcript", "/nope/t.json"], cwd=REPO,
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 2
    assert "not found" in proc.stderr


def test_no_card_and_no_device_is_an_error(tmp_path):
    """Without --device a twin runs on the card; with none it exits 2
    naming --device cpu, never falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from trackiellm_tpu_torch.tools import parity_llm

    (tmp_path / "t.json").write_text(json.dumps({"prompt": "a",
                                                 "tokens": [1]}))
    (tmp_path / "m.gguf").write_bytes(b"GGUF")
    with pytest.raises(SystemExit) as exc:
        parity_llm.main(["--gguf", str(tmp_path / "m.gguf"),
                         "--transcript", str(tmp_path / "t.json")])
    assert exc.value.code == 2


# ---------------------------------------------------------------------------
# The copied metrics and the results table
# ---------------------------------------------------------------------------

def _boxes(rng, n):
    xy = rng.uniform(0, 50, (n, 2))
    wh = rng.uniform(2, 30, (n, 2))
    return [list(map(float, np.concatenate([p, p + s])))
            for p, s in zip(xy, wh)]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_metrics_equal_the_jax_tools(seed):
    """edit_distance, wer, iou_xyxy, average_precision and mean_ap give
    tools/parity_common's values on seeded inputs, exactly."""
    sys.path.insert(0, REPO)
    from tools import parity_common as J

    from trackiellm_tpu_torch.tools import parity_common as T
    rng = np.random.default_rng(seed)
    words = ["a", "casa", "rua", "porta", "mesa"]
    ref = " ".join(rng.choice(words, 12))
    hyp = " ".join(rng.choice(words, 10))
    assert T.wer(ref, hyp) == J.wer(ref, hyp)
    assert T.wer("", hyp) == J.wer("", hyp)
    assert T.edit_distance(ref, hyp) == J.edit_distance(ref, hyp)
    b1, b2 = _boxes(rng, 6), _boxes(rng, 6)
    assert [T.iou_xyxy(a, b) for a, b in zip(b1, b2)] == \
        [J.iou_xyxy(a, b) for a, b in zip(b1, b2)]
    gt = {f"i{k}": [{"box": b, "cls": int(c)} for b, c in
                    zip(_boxes(rng, 4), rng.integers(0, 3, 4))]
          for k in range(3)}
    dets = {img: [{"box": list(np.asarray(g["box"]) + rng.normal(0, 2, 4)),
                   "score": float(rng.random()), "cls": g["cls"]}
                  for g in boxes] + [{"box": _boxes(rng, 1)[0],
                                      "score": float(rng.random()),
                                      "cls": int(rng.integers(0, 3))}]
            for img, boxes in gt.items()}
    for iou in (0.3, 0.5):
        assert T.mean_ap(dets, gt, iou) == J.mean_ap(dets, gt, iou)


def test_record_writes_the_ports_own_table(tmp_path, monkeypatch):
    """record() appends to PARITY-RESULTS-torch.md (here redirected by
    TRACKIE_PARITY_RESULTS), created with its header on first use; the
    JAX package's PARITY-RESULTS.md is not its default."""
    from trackiellm_tpu_torch.tools import parity_common as T

    assert T.RESULTS_FILE.endswith("PARITY-RESULTS-torch.md")
    out = tmp_path / "results.md"
    monkeypatch.setenv(T.RESULTS_ENV, str(out))
    T.record("parity_llm", "/x/m.gguf", "token_match", 1.0, "8 tokens")
    T.record("parity_vad", "/x/s.onnx", "max|dp|", 0.0)
    lines = out.read_text().splitlines()
    assert lines[0].startswith("# PARITY-RESULTS-torch")
    assert lines[-2].endswith("| parity_llm | m.gguf | token_match | 1.0 "
                              "| 8 tokens |")
    assert "| parity_vad | s.onnx |" in lines[-1]


# ---------------------------------------------------------------------------
# Self-parity, one tool at a time
# ---------------------------------------------------------------------------

def test_detector_self_parity_map_is_1(tmp_path, capsys):
    sys.path.insert(0, REPO)
    from PIL import Image

    from tests.test_detector_convert import TV8, _randomize_bn
    from trackiellm_tpu.models.detector import DetectorConfig
    from trackiellm_tpu_torch.models.convert import detector_from_torch
    from trackiellm_tpu_torch.models.detector import detector_forward
    from trackiellm_tpu_torch.ops.preprocess import letterbox_preprocess

    cfg = DetectorConfig.tiny()
    torch.manual_seed(3)
    model = TV8(cfg).eval()
    _randomize_bn(model, torch.Generator().manual_seed(3))
    state = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    ckpt = str(tmp_path / "det.npz")
    np.savez(ckpt, **state)
    img = np.random.default_rng(0).integers(0, 255, (96, 128, 3),
                                            dtype=np.uint8)
    img_path = str(tmp_path / "scene.png")
    Image.fromarray(img).save(img_path)

    # The model's own max class probability sets the threshold below it,
    # so the dump is non-empty.
    params, pcfg = detector_from_torch(state, device=CPU)
    chw, _ = letterbox_preprocess(torch.from_numpy(img), cfg.img_size,
                                  cfg.img_size)
    with torch.no_grad():
        _, cls_probs = detector_forward(params, pcfg, chw)
    conf = float(cls_probs.max()) * 0.8
    assert conf > 0

    args = ["--checkpoint", ckpt, "--images", img_path, "--conf", str(conf),
            "--input-size", str(cfg.img_size), "--no-record"]
    dump = _run_main("parity_detector", args, capsys)
    dets = dump["detections"]["scene.png"]
    assert dets, f"no boxes at probed conf {conf}"
    expected = {"scene.png": [{"box": d["box"], "cls": d["cls"]}
                              for d in dets]}
    exp_path = str(tmp_path / "expected.json")
    with open(exp_path, "w") as f:
        json.dump(expected, f)
    result = _run_main("parity_detector", args + ["--expected", exp_path],
                       capsys)
    assert set(result) == {"tool", "checkpoint", "n_images", "mAP@0.50",
                           "per_class"}
    assert result["mAP@0.50"] == pytest.approx(1.0)


# The byte tokenizer's BOS is id 256: a GGUF without a vocabulary needs
# at least 259 rows for the runner (``_make_gguf`` writes 96 by default).
BYTE_VOCAB = 320


def _byte_gguf(path, seed, monkeypatch):
    """``tests/test_convert.py:_make_gguf`` at BYTE_VOCAB rows."""
    sys.path.insert(0, REPO)
    from tests import test_convert

    monkeypatch.setattr(test_convert, "VOCAB", BYTE_VOCAB)
    test_convert._make_gguf(path, seed=seed)


def _gguf_transcript(tmp_path, prompt, n, monkeypatch):
    """A tiny llama GGUF and the port runner's own greedy ids on it, as
    parity_llm rebuilds them."""
    from trackiellm_tpu_torch.tools import parity_llm

    gguf_path = str(tmp_path / "tiny.gguf")
    _byte_gguf(gguf_path, 11, monkeypatch)
    params, cfg, tok, model = parity_llm.load_model(gguf_path, 0, CPU)
    if tok is None:
        from trackiellm_tpu_torch.llm.tokenizer import ByteTokenizer
        tok = ByteTokenizer(cfg.vocab_size)
    _, ids = parity_llm.greedy(params, cfg, tok, model, prompt, n, CPU)
    return gguf_path, ids


def test_llm_self_parity_token_match_is_1(tmp_path, capsys, monkeypatch):
    """A GGUF's self-transcript scores 1.0, and the row lands in the
    port's results table (redirected under tmp_path)."""
    gguf_path, ids = _gguf_transcript(tmp_path, "ola mundo", 16,
                                      monkeypatch)
    tr_path = str(tmp_path / "transcript.json")
    with open(tr_path, "w") as f:
        json.dump({"prompt": "ola mundo", "tokens": ids}, f)
    results = tmp_path / "results.md"
    monkeypatch.setenv("TRACKIE_PARITY_RESULTS", str(results))
    result = _run_main("parity_llm", ["--gguf", gguf_path, "--transcript",
                                      tr_path, "--quantize", "0"], capsys)
    assert set(result) == {"tool", "gguf", "n_ref_tokens", "n_generated",
                           "exact_prefix", "match_rate", "first_divergence"}
    assert result["match_rate"] == pytest.approx(1.0)
    assert result["exact_prefix"] == len(ids)
    assert result["first_divergence"] is None
    assert "| parity_llm | tiny.gguf | token_match | 1.0 |" in \
        results.read_text()


def test_llm_text_transcript_wer(tmp_path, capsys, monkeypatch):
    """A text transcript scores by WER: the runner's own text gives 0."""
    sys.path.insert(0, REPO)
    from trackiellm_tpu_torch.llm.tokenizer import ByteTokenizer
    from trackiellm_tpu_torch.tools import parity_llm

    gguf_path, _ = _gguf_transcript(tmp_path, "ola", 1, monkeypatch)
    params, cfg, _, model = parity_llm.load_model(gguf_path, 0, CPU)
    text, _ = parity_llm.greedy(params, cfg, ByteTokenizer(cfg.vocab_size),
                                model, "ola", 256, CPU)
    tr_path = str(tmp_path / "transcript.json")
    with open(tr_path, "w") as f:
        json.dump({"prompt": "ola", "text": text}, f)
    result = _run_main("parity_llm", ["--gguf", gguf_path, "--transcript",
                                      tr_path, "--quantize", "0",
                                      "--no-record"], capsys)
    assert set(result) == {"tool", "gguf", "text_wer", "generated"}
    assert result["text_wer"] == 0.0


def test_bos_past_the_vocabulary_is_clamped_by_jax_refused_by_the_port(
        tmp_path):
    """A fault of the reference that the twins' tests meet: on a model of
    96 rows (``_make_gguf``'s) the byte tokenizer's BOS, id 256, is past
    the embedding. The JAX runner's gather clamps it to row 95 and
    generates on a wrong embedding (its parity tests pass so); the port's
    runner refuses the tokenizer before any device work, naming the id and
    the vocabulary size."""
    sys.path.insert(0, REPO)
    import jax.numpy as jnp

    from tests.test_convert import VOCAB, _make_gguf
    from trackiellm_tpu.llm.runner import GenerationConfig as JGen
    from trackiellm_tpu.llm.runner import LLMRunner as JRunner
    from trackiellm_tpu.llm.tokenizer import ByteTokenizer as JByte
    from trackiellm_tpu.models.convert import gguf_to_llm_params
    from trackiellm_tpu_torch.llm.tokenizer import ByteTokenizer
    from trackiellm_tpu_torch.tools import parity_llm

    path = str(tmp_path / "tiny.gguf")
    _make_gguf(path, seed=11)
    assert VOCAB < JByte(VOCAB).bos_id
    jp, jcfg = gguf_to_llm_params(path, bits=None)
    out = JRunner(jp, jcfg, JByte(jcfg.vocab_size),
                  JGen(max_tokens=2, temperature=0.0),
                  cache_dtype=jnp.float32)
    out.generate("ola")
    assert len(out._generated_ids) >= 1
    from trackiellm_tpu_torch.utils.errors import ErrorCode, TrackieError
    params, cfg, _, model = parity_llm.load_model(path, 0, CPU)
    with pytest.raises(TrackieError, match=f"id 256 .* {VOCAB} rows") as err:
        parity_llm.greedy(params, cfg, ByteTokenizer(cfg.vocab_size),
                          model, "ola", 2, CPU)
    assert err.value.code == ErrorCode.INVALID_ARGUMENT


def test_asr_self_parity_wer_is_0(tmp_path, capsys):
    sys.path.insert(0, REPO)
    import jax

    from tests.test_convert import TestWhisperFromTorch
    from trackiellm_tpu.models import whisper as jwhisper
    from trackiellm_tpu_torch.audio.asr import WhisperASR
    from trackiellm_tpu_torch.models.convert import (
        whisper_config_from_torch, whisper_from_torch)

    cfg_w = jwhisper.WhisperConfig.test()
    ref = jwhisper.init_whisper(jax.random.PRNGKey(5), cfg_w)
    state = TestWhisperFromTorch()._to_torch_state(ref, cfg_w)
    ckpt = str(tmp_path / "whisper.npz")
    np.savez(ckpt, **state)

    cfg = whisper_config_from_torch(state)
    params = whisper_from_torch(state, device=CPU)[0]
    audio = (0.1 * np.random.default_rng(2).standard_normal(8000)
             ).astype(np.float32)
    text = WhisperASR(params, cfg, max_tokens=8).transcribe(audio)
    clip = str(tmp_path / "clip.npy")
    np.save(clip, audio)
    refs = str(tmp_path / "refs.tsv")
    with open(refs, "w") as f:
        f.write(f"clip.npy\t{text}\n")
    result = _run_main("parity_asr", ["--checkpoint", ckpt, "--audio", clip,
                                      "--refs", refs, "--max-tokens", "8",
                                      "--no-record"], capsys)
    assert set(result) == {"tool", "checkpoint", "n_clips", "mean_wer",
                           "per_clip"}
    assert result["mean_wer"] == pytest.approx(0.0)


def test_depth_self_parity(tmp_path, capsys):
    sys.path.insert(0, REPO)
    from PIL import Image

    from tests.test_depth_convert import TMidasSmall, _randomize_bn
    from trackiellm_tpu.models.depth import DepthConfig

    cfg = DepthConfig.tiny()
    torch.manual_seed(1)
    model = TMidasSmall(cfg).eval()
    _randomize_bn(model, torch.Generator().manual_seed(1))
    ckpt = str(tmp_path / "midas.npz")
    np.savez(ckpt, **{k: v.numpy() for k, v in model.state_dict().items()})
    img = np.random.default_rng(2).integers(0, 255, (80, 100, 3),
                                            dtype=np.uint8)
    img_path = str(tmp_path / "scene.png")
    Image.fromarray(img).save(img_path)
    out = str(tmp_path / "maps.npz")
    args = ["--checkpoint", ckpt, "--images", img_path,
            "--input-size", str(cfg.img_size), "--no-record"]
    dump = _run_main("parity_depth", args + ["--out", out], capsys)
    assert dump["images"] == 1 and os.path.exists(out)
    res = _run_main("parity_depth", args + ["--expected", out], capsys)
    assert set(res) == {"tool", "images", "rmse_norm_mean", "pearson_mean"}
    assert res["rmse_norm_mean"] < 1e-5
    assert res["pearson_mean"] > 0.9999
    # An expected map at another resolution: the prediction is resized.
    with np.load(out) as z:
        half = {k: z[k][::2, ::2] for k in z.files}
    np.savez(str(tmp_path / "half.npz"), **half)
    res = _run_main("parity_depth", args + ["--expected",
                                            str(tmp_path / "half.npz")],
                    capsys)
    assert res["pearson_mean"] > 0.9


def test_vad_self_parity(tmp_path, capsys):
    sys.path.insert(0, REPO)
    from tests.test_audio_convert import TestSileroExactConverter

    st = TestSileroExactConverter()._torch_state(seed=6)
    ckpt = str(tmp_path / "silero.npz")
    np.savez(ckpt, **{k: v.numpy() for k, v in st.items()})
    audio = (np.random.default_rng(7).normal(0, 0.1, 512 * 5)
             .astype(np.float32))
    wav = str(tmp_path / "a.npy")
    np.save(wav, audio)
    out = str(tmp_path / "probs.json")
    args = ["--checkpoint", ckpt, "--audio", wav, "--no-record"]
    dump = _run_main("parity_vad", args + ["--out", out], capsys)
    assert dump["chunks"] == 5 and os.path.exists(out)
    res = _run_main("parity_vad", args + ["--expected", out], capsys)
    assert set(res) == {"tool", "chunks", "max_abs_diff", "mean_abs_diff",
                        "decision_agreement"}
    assert res["max_abs_diff"] < 1e-6
    assert res["decision_agreement"] == 1.0


def test_tts_self_parity(tmp_path, capsys):
    sys.path.insert(0, REPO)
    from tests.test_vits import TestConverter
    from trackiellm_tpu.models import vits as V

    cfg = V.VITSConfig.tiny()
    st = TestConverter()._torch_vits_state(cfg, seed=5)
    ckpt = str(tmp_path / "voice.npz")
    np.savez(ckpt, **{k: v.numpy() for k, v in st.items()})
    conf = str(tmp_path / "voice.json")
    with open(conf, "w") as f:
        json.dump({"audio": {"sample_rate": 16000},
                   "phoneme_id_map": {"^": [1], "$": [2], "_": [0],
                                      "o": [3], "l": [4], "a": [5]}}, f)
    out = str(tmp_path / "synth.wav")
    args = ["--voice", ckpt, "--config", conf, "--text", "ola",
            "--no-record"]
    dump = _run_main("parity_tts", args + ["--out", out], capsys)
    assert dump["seconds"] > 0 and os.path.exists(out)
    res = _run_main("parity_tts", args + [
        "--expected", out, "--out", str(tmp_path / "synth2.wav")], capsys)
    assert set(res) == {"tool", "mel_l1", "duration_ratio", "seconds"}
    # 16-bit wav quantization bounds the self-distance.
    assert res["mel_l1"] < 0.02
    assert abs(res["duration_ratio"] - 1.0) < 1e-6


def test_embed_self_parity(tmp_path, capsys):
    sys.path.insert(0, REPO)
    from tests.test_embedder import TestWordPiece, _oracle

    model = _oracle(seed=9)
    ckpt = str(tmp_path / "bert.npz")
    np.savez(ckpt, **{k: v.numpy() for k, v in model.state_dict().items()})
    vocab = TestWordPiece.VOCAB + [
        f"w{i}" for i in range(128 - len(TestWordPiece.VOCAB))]
    vpath = str(tmp_path / "vocab.txt")
    open(vpath, "w").write("\n".join(vocab))
    tpath = str(tmp_path / "texts.txt")
    open(tpath, "w").write(
        "the cat sat\nrunning on mats\nunaffable!\nthe 99 cats\n")
    out = str(tmp_path / "emb.npy")
    args = ["--checkpoint", ckpt, "--vocab", vpath, "--texts", tpath,
            "--no-record"]
    dump = _run_main("parity_embed", args + ["--out", out], capsys)
    assert dump["texts"] == 4 and os.path.exists(out)
    res = _run_main("parity_embed", args + ["--expected", out], capsys)
    assert set(res) == {"tool", "checkpoint", "texts", "mean_cosine",
                        "top1_agreement", "pass"}
    assert res["mean_cosine"] > 0.999999
    assert res["top1_agreement"] == 1.0
    assert res["pass"]


def test_llm_native_checkpoint_self_parity(tmp_path, capsys):
    """A native checkpoint directory (the HF-route families' form) drives
    the twin too: the runner's own transcript matches."""
    from trackiellm_tpu_torch.llm.runner import GenerationConfig, LLMRunner
    from trackiellm_tpu_torch.llm.tokenizer import ByteTokenizer
    from trackiellm_tpu_torch.models import llm
    from trackiellm_tpu_torch.models.checkpoint import save_checkpoint

    cfg = llm.LLMConfig.tiny()
    params = llm.init_params(torch.Generator().manual_seed(3), cfg,
                             dtype=torch.bfloat16, device=CPU)
    ckpt = str(tmp_path / "native_ckpt")
    save_checkpoint(ckpt, params, config=cfg, metadata={})
    runner = LLMRunner(params, cfg, ByteTokenizer(cfg.vocab_size),
                       GenerationConfig(max_tokens=10, temperature=0.0,
                                        min_tokens=6), device=CPU)
    runner.generate("ola mundo")
    ref_ids = [int(i) for i in runner._generated_ids]
    assert ref_ids
    tr = str(tmp_path / "transcript.json")
    open(tr, "w").write(json.dumps({"prompt": "ola mundo",
                                    "tokens": ref_ids}))
    res = _run_main("parity_llm", ["--gguf", ckpt, "--transcript", tr,
                                   "--quantize", "0", "--no-record"],
                    capsys)
    assert res["match_rate"] == pytest.approx(1.0)
    assert res["exact_prefix"] == len(ref_ids)


def test_vlm_self_parity(tmp_path, capsys):
    """A tiny LLaVA state dict through the port's ``convert --family
    llava-hf`` and ``VLMRunner``'s own transcript."""
    from transformers import (CLIPVisionConfig, LlamaConfig, LlavaConfig,
                              LlavaForConditionalGeneration)

    from trackiellm_tpu_torch import __main__ as cli
    from trackiellm_tpu_torch.llm.runner import GenerationConfig
    from trackiellm_tpu_torch.llm.vlm import VLMRunner
    from trackiellm_tpu_torch.models.checkpoint import load_checkpoint

    vc = CLIPVisionConfig(hidden_size=32, image_size=16, patch_size=8,
                          num_hidden_layers=2, num_attention_heads=4,
                          intermediate_size=64)
    # BYTE_VOCAB rows, so that the byte tokenizer's BOS has one.
    tc = LlamaConfig(vocab_size=BYTE_VOCAB, hidden_size=48,
                     intermediate_size=96, num_hidden_layers=2,
                     num_attention_heads=4, num_key_value_heads=2,
                     max_position_embeddings=128)
    torch.manual_seed(3)
    m = LlavaForConditionalGeneration(LlavaConfig(
        vision_config=vc, text_config=tc,
        image_token_index=BYTE_VOCAB - 1)).eval()
    np.savez(tmp_path / "llava.npz",
             **{k: v.numpy() for k, v in m.state_dict().items()})
    ckpt = str(tmp_path / "ckpt")
    assert cli.main(["convert", str(tmp_path / "llava.npz"), "-o", ckpt,
                     "--family", "llava-hf", "--n-heads", "4",
                     "--vision-n-heads", "4", "--bits", "0",
                     "--device", "cpu"]) == 0
    capsys.readouterr()
    img = (np.random.default_rng(9).integers(0, 255, (20, 28, 3))
           .astype(np.uint8))
    np.save(tmp_path / "frame.npy", img)
    params, cfg, _ = load_checkpoint(ckpt, device=CPU)
    cp, cc, _ = load_checkpoint(os.path.join(ckpt, "vision"), device=CPU)
    runner = VLMRunner(params, cfg, cp, cc, device=CPU,
                       gen_config=GenerationConfig(max_tokens=8,
                                                   temperature=0.0))
    runner.generate("oi <image> tudo?", images=[img])
    tr = {"prompt": "oi <image> tudo?",
          "tokens": list(runner._generated_ids)}
    tr_path = str(tmp_path / "tr.json")
    with open(tr_path, "w") as f:
        json.dump(tr, f)
    res = _run_main("parity_vlm", ["--checkpoint", ckpt, "--image",
                                   str(tmp_path / "frame.npy"),
                                   "--transcript", tr_path, "--no-record"],
                    capsys)
    assert set(res) == {"model", "metric", "n_ref", "n_ours",
                        "exact_prefix", "match_rate"}
    assert res["match_rate"] == pytest.approx(1.0)
    assert res["exact_prefix"] == len(tr["tokens"])


def test_ocr_self_parity(tmp_path, capsys):
    sys.path.insert(0, REPO)
    from tests.test_trocr import _build_oracle

    _, state, cfgdict = _build_oracle("vit")
    ckpt = str(tmp_path / "trocr.npz")
    np.savez(ckpt, **state)
    confp = str(tmp_path / "config.json")
    with open(confp, "w") as f:
        json.dump(cfgdict, f)
    imgdir = tmp_path / "crops"
    imgdir.mkdir()
    for i in range(2):
        np.save(str(imgdir / f"c{i}.npy"),
                np.random.RandomState(i).rand(20, 50).astype(np.float32))
    out = str(tmp_path / "texts.json")
    args = ["--checkpoint", ckpt, "--config", confp, "--images",
            str(imgdir), "--no-record"]
    dump = _run_main("parity_ocr", args + ["--out", out], capsys)
    assert dump["images"] == 2 and os.path.exists(out)
    res = _run_main("parity_ocr", args + ["--expected", out], capsys)
    assert set(res) == {"tool", "images", "cer", "exact_match"}
    assert res["cer"] == 0.0
    assert res["exact_match"] == 1.0
