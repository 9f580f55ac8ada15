"""The port's first-contact harness (``trackiellm_tpu_torch/first_contact.py``)
against the JAX package's, on the CPU.

The synthetic artifact set of ``tests/test_first_contact.py`` (a tiny llama
GGUF, a whisper GGML, a Silero-v5 ONNX, an openai-whisper state dict and a
non-artifact) goes through both harnesses: the port's report equals the
JAX one field by field except the seconds, the directory, the suggested
commands' tool (``python -m trackiellm_tpu_torch.tools.parity_x ...
--device cpu`` for ``python tools/parity_x.py ...``), the package's name
in ``next_step`` and the loggers' names in warnings. NLLs agree within
``NLL_REL`` relative: the four probes at tiny configs in f32 and at Q4
were measured 1e-10 to 3.1e-5 apart (the LLM's Q4 products sum in another
order), and the tiny GGUF's bf16 weights 1.9e-4 (probe and flag probe).

Each case of ``tests/test_first_contact.py`` has its twin here (the
Piper routes and the companion run are not marked slow: the port's are
quick), plus the bert-GGUF route the JAX harness fails on, and the
``first_contact`` command with ``--device``. Nothing is left in the tree:
the companion's child records to a file under the test's directory.
"""

import json
import os
import re

import numpy as np
import pytest
import torch

from tests.test_first_contact import _silero_state
from trackiellm_tpu import first_contact as JFC
from trackiellm_tpu_torch import first_contact as FC
from trackiellm_tpu_torch.models.onnx_reader import write_onnx_initializers

CPU = torch.device("cpu")
NLL_REL = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _opts(**kw):
    return FC.Options(device="cpu", **kw)


@pytest.fixture(scope="module")
def artifact_dir(tmp_path_factory):
    """tests/test_first_contact.py's directory, with the same writers."""
    d = tmp_path_factory.mktemp("artifacts")
    from tests.test_convert import _make_gguf
    from tests.test_whisper_ggml import _tiny_file

    _make_gguf(str(d / "tiny-llama.gguf"))
    path, state, _, _ = _tiny_file(d)
    assert path.endswith(".bin")
    write_onnx_initializers(str(d / "silero_vad.onnx"), _silero_state())
    np.savez(str(d / "whisper-tiny-state.npz"),
             **{k: np.asarray(v) for k, v in state.items()
                if k != "encoder.positional_embedding"})
    (d / "README.md").write_text("not an artifact\n")
    return d


class TestSniff:
    def test_kinds(self, artifact_dir):
        got = {f: FC.sniff(str(artifact_dir / f))["kind"]
               for f in os.listdir(artifact_dir)}
        assert got["tiny-llama.gguf"] == "gguf"
        assert got["ggml-test.bin"] == "ggml-whisper"
        assert got["silero_vad.onnx"] == "onnx-silero"
        assert got["whisper-tiny-state.npz"] == "state-dict"
        assert got["README.md"] == "skip"
        assert got == {f: JFC.sniff(str(artifact_dir / f))["kind"]
                       for f in os.listdir(artifact_dir)}

    def test_shard_detected(self, tmp_path):
        p = tmp_path / "model-00001-of-00002.safetensors"
        p.write_bytes(b"\x00" * 16)
        assert FC.sniff(str(p))["kind"] == "hf-shard"

    def test_truncated_gguf_fails_one_artifact_not_the_run(self, tmp_path):
        """A half-copied checkpoint (valid magic, truncated header) marks
        that file FAIL and never aborts the gauntlet."""
        (tmp_path / "broken.gguf").write_bytes(b"GGUF\x03\x00")
        rep = FC.run(str(tmp_path), None, _opts())
        assert rep["summary"]["FAIL"] == 1
        e = rep["artifacts"][0]
        assert e["status"] == "FAIL" and e["kind"] == "unreadable"


def _entry(report, name):
    for a in report["artifacts"]:
        if a["file"] == name:
            return a
    raise AssertionError(f"{name} missing from report")


class TestHarnessEndToEnd:
    @pytest.fixture(scope="class")
    def report(self, artifact_dir, tmp_path_factory):
        out = tmp_path_factory.mktemp("report") / "report.json"
        rep = FC.run(str(artifact_dir), str(out), _opts(probe_tokens=12))
        assert out.exists()
        assert json.loads(out.read_text()) == rep
        return rep

    def test_no_failures(self, report):
        assert report["summary"]["FAIL"] == 0, report["artifacts"]

    def test_llama_gguf_probed_with_flag_gauntlet(self, report):
        e = _entry(report, "tiny-llama.gguf")
        assert e["status"] in ("PASS", "WARN")
        assert e["probe"]["mode"] == "nll"
        assert np.isfinite(e["probe"]["nll"])
        fp = e["flag_probe"]
        assert fp["env"] == "TRACKIE_LLAMA_GGUF_ROPE"
        assert "norm" in fp and "hf" in fp
        # Random synthetic weights and no vocab: never decisive.
        assert fp["decisive"] is False

    def test_whisper_ggml(self, report):
        e = _entry(report, "ggml-test.bin")
        assert e["status"] in ("PASS", "WARN")
        assert e["probe"]["n_mels"] > 0
        assert e["probe"]["vocab_ok"]

    def test_silero_onnx(self, report):
        e = _entry(report, "silero_vad.onnx")
        assert e["status"] in ("PASS", "WARN")
        assert 0.0 <= e["probe"]["prob_on_noise"] <= 1.0

    def test_whisper_state_dict(self, report):
        e = _entry(report, "whisper-tiny-state.npz")
        assert e["status"] in ("PASS", "WARN")
        assert e["arch"] == "whisper-torch"

    def test_parity_suggested_without_companions(self, report):
        e = _entry(report, "tiny-llama.gguf")
        assert e["parity"]["ran"] is False
        assert "parity_llm" in e["parity"]["suggested"]
        assert "-m trackiellm_tpu_torch.tools.parity_llm" in \
            e["parity"]["suggested"]
        assert e["parity"]["suggested"].endswith("--device cpu")

    def test_report_equals_the_jax_report(self, report, artifact_dir):
        """Field by field, but the excepted ones (module docstring); the
        NLLs within NLL_REL."""
        want = JFC.run(str(artifact_dir), None, JFC.Options(probe_tokens=12))
        got_n, want_n = _normalized(report), _normalized(want)
        nlls = _pop_nlls(got_n), _pop_nlls(want_n)
        assert got_n == want_n
        assert nlls[0].keys() == nlls[1].keys() and nlls[0]
        for key, value in nlls[1].items():
            assert abs(nlls[0][key] - value) <= NLL_REL * abs(value), key


def _suggested(cmd: str):
    """(tool, arguments) of a suggested parity command, either package's
    form; the port's trailing ``--device D`` dropped."""
    parts = cmd.split()[1:]
    if parts[0] == "-m":
        tool, args = parts[1].rsplit(".", 1)[1], parts[2:]
        assert args[-2] == "--device"
        args = args[:-2]
    else:
        tool, args = os.path.basename(parts[0])[:-3], parts[1:]
    return tool, args


def _normalized(report):
    """The report without the excepted fields (see the module docstring)."""
    out = []
    for a in report["artifacts"]:
        a = json.loads(json.dumps(a))
        a.pop("seconds", None)
        a.get("probe", {}).pop("seconds", None)
        if "parity" in a and "suggested" in a["parity"]:
            a["parity"]["suggested"] = _suggested(a["parity"]["suggested"])
        if "next_step" in a:
            a["next_step"] = a["next_step"].replace("trackiellm_tpu_torch",
                                                    "trackiellm_tpu")
        if "warnings" in a:
            a["warnings"] = [re.sub(r"^[\w.]+: ", "", w)
                             for w in a["warnings"]]
        out.append(a)
    return {"artifacts": out, "summary": report["summary"]}


def _pop_nlls(report):
    """Every NLL of the report by (file, where), taken out of it."""
    nlls = {}
    for a in report["artifacts"]:
        if "nll" in a.get("probe", {}):
            nlls[(a["file"], "probe")] = a["probe"].pop("nll")
        fp = a.get("flag_probe")
        if fp:
            for layout in (k for k in list(fp) if k not in
                           ("env", "winner", "decisive")):
                nlls[(a["file"], layout)] = fp.pop(layout)
    return nlls


# ---------------------------------------------------------------------------
# The four NLL probes against the JAX probe
# ---------------------------------------------------------------------------

def _probe_models(kind: str, bits: int):
    """(JAX params, JAX cfg, port params, port cfg) of the port tests'
    tiny configs, carried across from the JAX package's params."""
    if kind == "llm":
        from tests import test_torch_llm as T
        from trackiellm_tpu.models import llm as jllm
        from trackiellm_tpu_torch.models import llm as tllm

        jp, tp = T._params(quantized=bool(bits), bits=bits or 4)
        cfg = jllm.LLMConfig.tiny()
        return jp, cfg, tp, tllm.LLMConfig(**cfg._asdict())
    if kind == "mla":
        from tests import test_torch_mla as T

        cfg, tcfg, jp, tp = T._params("tiny", bits)
        return jp, cfg, tp, tcfg
    if kind == "mamba":
        from tests import test_torch_mamba as T

        cfg, tcfg, jp, tp = T._mamba(bits)
        return jp, cfg, tp, tcfg
    from tests import test_torch_qwen3next as T
    from trackiellm_tpu.models import qwen3next as jq
    from trackiellm_tpu_torch.models import qwen3next as tq

    _, jp, jc, tp, tc = T._model()
    if bits:
        jp = jq.quantize_params(jp, bits=bits, group=8)
        tp = tq.quantize_params(tp, bits=bits, group=8)
    return jp, jc, tp, tc


@pytest.mark.parametrize("bits", [0, 4])
@pytest.mark.parametrize("kind", ["llm", "mla", "mamba", "qwen3next"])
def test_probe_nll_matches_jax(kind, bits):
    """probe_nll on each of the four model families (the LLM's extend with
    all logits, MLA's extend, Mamba's decode steps, Qwen3-Next's forward)
    at 12 and 32 probe ids, f32 weights and Q4, within NLL_REL."""
    jp, jc, tp, tc = _probe_models(kind, bits)
    for n in (12, 32):
        ids = JFC._probe_ids(None, jc.vocab_size, n)
        assert ids == FC._probe_ids(None, tc.vocab_size, n)
        want = JFC.probe_nll(jp, jc, ids)
        got = FC.probe_nll(tp, tc, ids, CPU)
        assert np.isfinite(got)
        assert abs(got - want) <= NLL_REL * want, (n, got, want)


def test_probe_has_no_route_for_mamba2():
    """As the JAX probe: a config type without a probe is refused."""
    from trackiellm_tpu_torch.models.mamba2 import Mamba2Config

    with pytest.raises(NotImplementedError, match="Mamba2Config"):
        FC.probe_nll({}, Mamba2Config(), [1, 2, 3], CPU)


def test_probe_ids_use_the_files_tokenizer():
    from trackiellm_tpu_torch.llm.tokenizer import ByteTokenizer

    tok = ByteTokenizer(512)
    ids = FC._probe_ids(tok, 512, 32)
    assert ids == tok.encode(FC.PROBE_TEXT)[:32]
    assert FC.PROBE_TEXT == JFC.PROBE_TEXT
    assert FC.DECISIVE_GAP == JFC.DECISIVE_GAP
    assert FC.ROPE_FLAGS == JFC.ROPE_FLAGS


# ---------------------------------------------------------------------------
# The other routes
# ---------------------------------------------------------------------------

class TestPiperVoiceRoute:
    def _voice(self, tmp_path, name):
        from tests.test_vits import TestConverter
        from trackiellm_tpu.models import vits as V

        cfg0 = V.VITSConfig.tiny()
        st = {k: np.asarray(v) for k, v in
              TestConverter()._torch_vits_state(cfg0).items()}
        write_onnx_initializers(str(tmp_path / name), st)
        return cfg0

    def test_piper_onnx_with_config_loads(self, tmp_path):
        """A VITS-named ONNX beside its voice .json goes through
        VITSVoice.from_piper and PASSes, in both harnesses."""
        cfg0 = self._voice(tmp_path, "voice.onnx")
        (tmp_path / "voice.onnx.json").write_text(json.dumps(
            {"audio": {"sample_rate": cfg0.sample_rate},
             "phoneme_id_map": {"a": [1], "^": [0]}}))
        rep = FC.run(str(tmp_path), None, _opts(deep=True))
        assert rep["summary"]["FAIL"] == 0, rep["artifacts"]
        e = [a for a in rep["artifacts"] if a["kind"] == "onnx-piper"][0]
        assert e["status"] in ("PASS", "WARN")
        assert e["probe"]["sample_rate"] == cfg0.sample_rate
        assert e["probe"]["mode"] == "synth" and e["probe"]["samples"] > 0
        want = JFC.run(str(tmp_path), None, JFC.Options())
        assert _normalized(
            FC.run(str(tmp_path), None, _opts())) == _normalized(want)

    def test_piper_without_config_fails_informatively(self, tmp_path):
        self._voice(tmp_path, "lonely.onnx")
        rep = FC.run(str(tmp_path), None, _opts())
        e = rep["artifacts"][0]
        assert e["status"] == "FAIL"
        assert ".json" in e["error"]  # names the expected config path


class TestShardedCheckpointMerging:
    def test_shard_group_merges_and_converts(self, tmp_path):
        """model-XXXXX-of-YYYYY.safetensors groups merge and convert as
        one artifact."""
        from safetensors.numpy import save_file

        from tests.test_whisper_ggml import _tiny_file

        _, state, _, _ = _tiny_file(tmp_path)
        items = sorted((k, np.ascontiguousarray(np.asarray(v)))
                       for k, v in state.items())
        half = len(items) // 2
        save_file(dict(items[:half]),
                  str(tmp_path / "model-00001-of-00002.safetensors"))
        save_file(dict(items[half:]),
                  str(tmp_path / "model-00002-of-00002.safetensors"))
        (tmp_path / "ggml-test.bin").unlink()  # isolate the group
        rep = FC.run(str(tmp_path), None, _opts())
        assert rep["summary"]["FAIL"] == 0, rep["artifacts"]
        sharded = [a for a in rep["artifacts"] if a["kind"] == "hf-sharded"]
        assert len(sharded) == 1
        assert sharded[0]["status"] in ("PASS", "WARN")
        assert sharded[0]["arch"] == "whisper-torch"
        assert "2 shards" in sharded[0]["file"]


class TestStateDictClassifier:
    def test_config_json_wins(self, tmp_path):
        (tmp_path / "config.json").write_text(
            json.dumps({"model_type": "qwen3"}))
        fam, how = FC._classify_state_dict(
            ["model.layers.0.self_attn.q_proj.weight"],
            str(tmp_path / "model.safetensors"))
        assert fam == "hf:qwen3" and "config.json" in how

    def test_llm_tree_without_config_is_unclassified(self, tmp_path):
        fam, how = FC._classify_state_dict(
            ["model.layers.0.self_attn.q_proj.weight"],
            str(tmp_path / "model.safetensors"))
        assert fam is None and "config.json" in how

    def test_ultralytics(self, tmp_path):
        fam, _ = FC._classify_state_dict(
            ["model.0.conv.weight", "model.22.dfl.conv.weight"],
            str(tmp_path / "yolo.pt"))
        assert fam == "ultralytics"


def test_hf_converter_table_names_the_jax_families():
    """The transformers routes: the same model types as the JAX table."""
    import inspect

    src = inspect.getsource(JFC._hf_llm_converters)
    want = set(re.findall(r'^\s+"([\w.]+)": ', src, re.M))
    assert set(FC._hf_llm_converters(CPU)) == want


def test_bert_gguf_route_jax_fails_port_passes(tmp_path):
    """The JAX harness unpacks two values from gguf_to_bert_params, which
    returns three, so a bert GGUF FAILs there; the port converts it and
    embeds (a repaired fault)."""
    from tests.test_torch_embedder import bert_gguf, bert_state

    bert_gguf(str(tmp_path / "minilm.gguf"), bert_state(0, classifier=False),
              rank=False)
    want = JFC.run(str(tmp_path), None, JFC.Options())
    assert want["summary"]["FAIL"] == 1
    assert "ValueError" in want["artifacts"][0]["error"]
    rep = FC.run(str(tmp_path), None, _opts())
    assert rep["summary"]["FAIL"] == 0, rep["artifacts"]
    e = rep["artifacts"][0]
    assert e["arch"] == "bert" and e["probe"]["mode"] == "embed-smoke"
    assert e["probe"]["dim"] > 0


def test_companion_runs_the_parity_twin(tmp_path, monkeypatch):
    """With <stem>.transcript.json next to a GGUF, the harness runs the
    parity_llm twin in a child on the harness's device (--device cpu):
    the runner's own transcript gives match rate 1.0, the child reports
    when it was ready, and nothing is written to the tree."""
    from tests import test_convert
    from trackiellm_tpu_torch.tools import parity_common, parity_llm

    monkeypatch.setattr(test_convert, "VOCAB", 320)  # BOS 256 fits
    gguf = str(tmp_path / "m.gguf")
    test_convert._make_gguf(gguf)
    params, cfg, tok, model = parity_llm.load_model(gguf, 0, CPU)
    from trackiellm_tpu_torch.llm.tokenizer import ByteTokenizer
    _, tokens = parity_llm.greedy(params, cfg, tok or ByteTokenizer(
        cfg.vocab_size), model, "ola", 8, CPU)
    (tmp_path / "m.transcript.json").write_text(json.dumps(
        {"prompt": "ola", "tokens": tokens}))
    results = tmp_path / "results.md"
    monkeypatch.setenv("TRACKIE_PARITY_RESULTS", str(results))
    tree_file = parity_common.RESULTS_FILE
    had_tree_file = os.path.exists(tree_file)
    entry = FC.check_artifact(gguf, _opts(no_flags=True, probe_tokens=10,
                                          quantize=0))
    par = entry["parity"]
    assert par["ran"] is True and par["rc"] == 0, par
    assert par["command"].endswith("--quantize 0 --device cpu")
    assert par["metrics"]["match_rate"] == 1.0
    assert par["metrics"]["exact_prefix"] == len(tokens)
    assert par["child"]["device"] == "cpu" and par["child"]["ready_s"] > 0
    assert par["child"]["compiled"] is None
    assert "| parity_llm | m.gguf | token_match | 1.0 |" in \
        results.read_text()
    assert os.path.exists(tree_file) == had_tree_file
    assert entry["status"] in ("PASS", "WARN")


def test_child_lines_give_start_up_and_launches(capsys):
    """A twin's stderr: the ``ready`` line gives the start-up seconds and
    the device, the ``launches`` line (printed on the card only) the
    kernels' counts; without a ready line there is no child record."""
    from trackiellm_tpu_torch.tools import parity_common as pc

    pc.launches(CPU)
    assert capsys.readouterr().err == ""
    counts = {"q4_matmul_w4a8": 34, "flash_attention": 1}
    err = "\n".join([
        "loading GGUF...",
        pc.READY_PREFIX + json.dumps({"tool": "parity_llm", "at": 12.5,
                                      "device": "cuda:0",
                                      "compiled": False}),
        "greedy-decoding 16 tokens...",
        pc.LAUNCHES_PREFIX + json.dumps(counts)])
    assert FC._child_ready(err, 10.0) == {
        "ready_s": 2.5, "device": "cuda:0", "compiled": False,
        "launches": counts}
    assert FC._child_ready(err.splitlines()[0], 10.0) is None


def test_cli_first_contact(tmp_path, artifact_dir, capsys):
    """``python -m trackiellm_tpu_torch first_contact DIR --device cpu``:
    one line an artifact, the summary, exit 0; --report writes the
    report; the JAX command's defaults."""
    from trackiellm_tpu_torch import __main__ as cli

    out = tmp_path / "r.json"
    rc = cli.main(["first_contact", str(artifact_dir), "--device", "cpu",
                   "--probe-tokens", "12", "--report", str(out)])
    text = capsys.readouterr().out
    assert rc == 0
    assert text.strip().splitlines()[-1] == "# 4 PASS / 0 WARN / 0 FAIL"
    assert "gguf           tiny-llama.gguf" in text
    assert json.loads(out.read_text())["summary"]["PASS"] == 4
    assert FC.main([str(artifact_dir), "--device", "cpu", "--no-flags",
                    "--probe-tokens", "12"]) == 0
    assert "rope->" not in capsys.readouterr().out
