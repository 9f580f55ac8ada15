"""chip_smoke.py's contract where it can be checked without a card.

The script drives the port on an H100 and its last line states the device
the run used: one card. Here, with no CUDA device, it must fail and print
no result.
"""

import importlib.util
import json
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(ROOT, "chip_smoke.py")


def _load():
    spec = importlib.util.spec_from_file_location("chip_smoke", SCRIPT)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_result_line_says_one_card():
    line = _load().result_line("NVIDIA H100 80GB HBM3")
    assert json.loads(line) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}}


# Every function of the JAX package and its tools that reaches
# pl.pallas_call, by file and line, and the CUDA source that replaces it;
# then the activation quantization that runs before the W4A8 Pallas call,
# which the port's W4A8 wrapper launches as a kernel of its own.
TPU_KERNELS = {
    "q4_matmul_w4a8": ("trackiellm_tpu/ops/quant.py:662", "q4_w4a8.cu",
                       "def q4_matmul_pallas_i8("),
    "quantize_activations": ("trackiellm_tpu/ops/quant.py:595", "q4_w4a8.cu",
                             "def quantize_activations_q8("),
    "flash_attention": ("trackiellm_tpu/ops/attention.py:176",
                        "flash_attn.cu", "def flash_attention("),
    "q8_matmul": ("trackiellm_tpu/ops/quant.py:184", "q8_matmul.cu",
                  "def q8_matmul_pallas("),
    "q4_matmul_f32a": ("trackiellm_tpu/ops/quant.py:272", "q4_f32a.cu",
                       "def q4_matmul_pallas("),
    "fused_mlp_q4": ("trackiellm_tpu/ops/fused.py:144", "fused_mlp_q4.cu",
                     "def fused_mlp_q4_pallas("),
    "q4_matmul_stream": ("trackiellm_tpu/ops/quant.py:389", "q4_stream.cu",
                         "def q4_matmul_pallas_v2("),
    "stream": ("tools/diag_envelope.py:60", "diag_probes.cu",
               "def stream_pallas("),
    "grid64": ("tools/diag_scan_overhead.py:70", "diag_probes.cu",
               "    def grid64("),
    "chain_tiny": ("tools/diag_overhead.py:101", "diag_probes.cu",
                   "    def chain_tiny("),
}


def test_kernels_line_lists_all_nine():
    """KERNELS names every TPU kernel of the repo once, and W4A8's
    activation quantization: its source exists, ``replaces`` points at the
    line that defines the JAX function, and each has a headline case."""
    kernels = _load().KERNELS
    assert len(kernels) == 10 and kernels.keys() == TPU_KERNELS.keys()
    for name, (src, replaces, headlines, phase) in kernels.items():
        assert headlines and all(isinstance(h, str) for h in headlines)
        want, cu, definition = TPU_KERNELS[name]
        assert replaces == want
        assert src == f"trackiellm_tpu_torch/csrc/{cu}"
        assert os.path.isfile(os.path.join(ROOT, src))
        path, line = replaces.split(":")
        with open(os.path.join(ROOT, path)) as f:
            assert f.read().splitlines()[int(line) - 1].startswith(definition)
        assert phase in (5, 6, 7, 9)


def test_matmul_kernels_carry_decode_and_prefill_cases():
    """The three quantized matmuls the model paths launch (W4A8, Q8, f32a)
    carry w_gu at M=1 (decode) and M=512 (prefill) as headline cases, so
    the kernels line and PERF.md's table carry both device-only times;
    phase 3 runs both M."""
    cs = _load()
    for name in ("q4_matmul_w4a8", "q8_matmul", "q4_matmul_f32a"):
        assert cs.KERNELS[name][2] == ("w_gu M=1", "w_gu M=512")
    assert {1, 512} <= set(cs.MATMUL_MS)


def test_phase3_covers_the_server_waves():
    """serve_shapes gives phase 3 the rows of phase 12's waves (a bucket
    times 1, 2, 4 or 8 prompts), extend chunks and decode steps: W4A8 up
    to 512 rows, f32a and Q8 above (a wave of four and of eight prompts at
    bucket 512), and flash at the waves' folded heads."""
    from trackiellm_tpu_torch.llm import runner
    cs = _load()
    w4a8, exact, flash = cs.serve_shapes(runner, 512, 512, cs.SERVE_SLOTS)
    assert w4a8 == (1, 8, 16, 64, 128, 256, 512)
    assert exact == (1, 8, 64, 256, 512, 1024, 2048, 4096)
    assert flash == [(256, 2), (256, 4), (256, 8), (512, 2), (512, 4),
                     (512, 8)]


def test_fails_without_a_card(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert _load().main() != 0
    out = capsys.readouterr()
    assert '"ok"' not in out.out and "no CUDA device" in out.err


def test_fails_alone_in_a_directory(tmp_path):
    """Copied alone, without the package, it exits non-zero with no result
    (here it stops at the missing card first, as it does on the H100 host
    at the missing package)."""
    alone = tmp_path / "chip_smoke.py"
    alone.write_text(open(SCRIPT).read())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, str(alone)], cwd=tmp_path,
                          capture_output=True, text=True, timeout=120,
                          env=env)
    assert proc.returncode != 0 and '"ok"' not in proc.stdout


def test_bound_is_the_larger_of_bytes_and_operations():
    """The bound of a kernel: its bytes over the card's memory rate or its
    operations over the peak rate of their type, whichever takes longer."""
    cs = _load()
    x = torch.empty((1024, 1024), dtype=torch.float32)   # 4 MiB
    ms, by = cs.bound_ms((x,), 0, "f32")
    assert by == "bytes" and ms == 4 * 2 ** 20 / cs.HBM_BYTES_PER_S * 1e3
    ms, by = cs.bound_ms((x,), 1e12, "int8")
    assert by == "operations" and ms == 1e12 / cs.PEAK_OPS_PER_S["int8"] * 1e3
    assert cs.attention_pairs(4, 0) == 10 and cs.attention_pairs(4, 2) == 7


def test_kernels_line_carries_every_key():
    """Each kernel of the JSON line has the keys the contract names, from
    its first headline case, and every headline case listed."""
    cs = _load()
    rows = {name: [dict(case=case, err=0.5, ms=2.0, plain=3.0, bound=1.0,
                        bound_by="bytes", library=None,
                        device={"total": 1.5, "kernels": {}})
                   for case in headlines]
            for name, (_, _, headlines, _) in cs.KERNELS.items()}
    launches = {phase: {name: 7 + phase for name in cs.KERNELS}
                for phase in (5, 6, 7, 9, 10, 11, 12)}
    kernels = json.loads(cs.kernels_line(rows, launches))["kernels"]
    assert [k["name"] for k in kernels] == list(cs.KERNELS)
    for k in kernels:
        assert {"name", "route", "source", "replaces", "launches",
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms"} <= k.keys()
        assert (k["route"], k["launches"], k["ms"], k["device_ms"]) == (
            "cuda", 7 + k["launches_phase"], 2.0, 1.5)
        # Phase 12 (serving) is read like every other phase.
        assert k["launches_by_phase"] == {
            str(p): 7 + p for p in (5, 6, 7, 9, 10, 11, 12)}
        assert [c["case"] for c in k["cases"]] == list(
            cs.KERNELS[k["name"]][2])


def test_kernels_line_carries_the_unfused_yardstick():
    """The fused block's cases carry the unfused block's per-call and
    device-only ms beside the kernel's; other kernels carry neither."""
    cs = _load()
    rows = {name: [dict(case=case, err=0.0, ms=2.0, plain=3.0, bound=1.0,
                        bound_by="bytes")
                   for case in headlines]
            for name, (_, _, headlines, _) in cs.KERNELS.items()}
    for r in rows["fused_mlp_q4"]:
        r.update(unfused=0.9, unfused_device=0.1)
    launches = {phase: {name: 1 for name in cs.KERNELS}
                for phase in (5, 6, 7, 9, 12)}
    kernels = {k["name"]: k for k in json.loads(
        cs.kernels_line(rows, launches))["kernels"]}
    fused = kernels.pop("fused_mlp_q4")
    assert (fused["unfused_ms"], fused["unfused_device_ms"]) == (0.9, 0.1)
    assert all("unfused_device_ms" not in k for k in kernels.values())


def test_probe_rows_on_the_cpu(monkeypatch, capsys):
    """Phase 3's probe rows, their control flow on the CPU (the plain
    paths, each timer stubbed to run its function once): every probe has
    its library time, and chain_tiny's bound counts the 64 calls' bytes
    (each reads and writes the 4 KiB tile) with its event spans beside."""
    from trackiellm_tpu_torch.ops import diag
    cs = _load()
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(cs, "time_ms", lambda fn: (fn(), 1.0)[1])
    monkeypatch.setattr(cs, "device_only_ms", lambda fn, **kw: (
        fn(), {"total": 0.5, "kernels": {}})[1])
    monkeypatch.setattr(cs, "STREAM_SHAPE", (64, 64))
    rows = {name: [] for name in cs.KERNELS}
    cs.phase_probes(torch.device("cpu"), torch.Generator().manual_seed(0),
                    diag, rows)
    assert all(rows[name][0]["library"] == 1.0 for name in cs.PROBES)
    chain = rows["chain_tiny"][0]
    assert chain["bound"] == 64 * 8192 / cs.HBM_BYTES_PER_S * 1e3
    assert chain["event_ms"] > 0 and chain["library_event_ms"] > 0
    assert "kernel_ms <= library_ms" in capsys.readouterr().out


def _fake_profiler(cs, monkeypatch, window_counts, lone_counts=(1,)):
    """device_breakdown replaced by a fake that runs ``fn`` and reports one
    kernel "k": for the lone call, the counts of ``lone_counts`` in turn
    until one is not 0, then each timed window's count from
    ``window_counts`` in turn (0.1 ms a launch)."""
    windows, lones = iter(window_counts), iter(lone_counts)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(cs, "l2_flush",
                        lambda: torch.empty(16, dtype=torch.int32))

    def fake(fn):
        fn()
        n = next(lones) if fake.lone else next(windows)
        fake.lone = fake.lone and n == 0
        kernels = {"k": (0.1 * n, n)} if n else {}
        return 0.1 * n, n, {**kernels, "Fill": (0.01, 20)}
    fake.lone = True
    monkeypatch.setattr(cs, "device_breakdown", fake)


def test_device_only_ms_refuses_a_partial_count(monkeypatch):
    """A profiler that drops launches in every window, or never sees the
    lone call's, gives no time and a note, after the retries; one that sees
    all of them gives the mean."""
    cs = _load()
    _fake_profiler(cs, monkeypatch, [1, 19, 0, 5])
    notes = []
    assert cs.device_only_ms(lambda: None, notes=notes) is None
    assert notes == ["profiler saw 5 of 20 launches"]
    _fake_profiler(cs, monkeypatch, [1, 20])
    notes = []
    got = cs.device_only_ms(lambda: None, notes=notes)
    assert notes == [] and got["kernels"] == {"k": 0.1}
    assert abs(got["total"] - 0.1) < 1e-12
    # A lone call whose profile misses the launch is profiled again.
    _fake_profiler(cs, monkeypatch, [20], lone_counts=[0, 0, 1])
    assert cs.device_only_ms(lambda: None)["total"] > 0
    _fake_profiler(cs, monkeypatch, [], lone_counts=[0] * 4)
    notes = []
    assert cs.device_only_ms(lambda: None, notes=notes) is None
    assert notes == ["profiler saw no launch of one call"]


def test_device_only_ms_checks_the_wrapper_count(monkeypatch):
    """The lone profiled call must go through the wrapper as often as a
    call launches it (``per_call``; chain_tiny's 64)."""
    import pytest
    cs = _load()

    class Wrapper:
        launches = 0

        def __call__(self):
            self.launches += 64
    w = Wrapper()
    _fake_profiler(cs, monkeypatch, [64 * 20])
    with pytest.raises(AssertionError):
        cs.device_only_ms(w, counter=w)
    _fake_profiler(cs, monkeypatch, [20])
    assert cs.device_only_ms(w, counter=w, per_call=64)["total"] > 0


def test_conforms_checks_the_schema_subset():
    cs = _load()
    nav = cs.TOOLS[0][3]
    assert cs.conforms({"direction": "left", "meters": 2.5}, nav)
    assert not cs.conforms({"direction": "up"}, nav)
    assert not cs.conforms({"meters": 1}, nav)
    assert not cs.conforms({"direction": "left", "speed": 1}, nav)
    assert not cs.conforms({"direction": "left", "meters": True}, nav)
    assert cs.conforms({"anything": [1]}, None) and not cs.conforms([], None)
    assert cs.conforms({"hazard": "x", "objects": ["a"]}, cs.RESPONSE_SCHEMA)
    assert not cs.conforms({"hazard": "x", "objects": ["a"] * 5},
                           cs.RESPONSE_SCHEMA)


def test_slice10_on_the_cpu(monkeypatch, capsys):
    """Phase 10's control flow on the CPU at tiny size (the timers' syncs
    stubbed): the constrained, schema'd, speculative and sampled requests
    pass their checks, and the long prompt's route check fails, as it must
    where no kernel launches; the verify pass agrees with decode steps."""
    import pytest
    from trackiellm_tpu_torch.llm import runner, tokenizer
    from trackiellm_tpu_torch.models import llm
    from trackiellm_tpu_torch.ops import quant
    cs = _load()
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    cfg = llm.LLMConfig.tiny()._replace(max_seq=cs.SLICE10_MAX_SEQ,
                                        sliding_window=cs.SLICE10_MAX_SEQ)
    params = llm.init_params_quantized(torch.Generator().manual_seed(1), cfg,
                                       group=64, dtype=torch.float32)
    counters = {"q4_matmul_f32a": quant.q4_matmul_f32a}
    plain = quant.quantized_matmul_ref
    with pytest.raises(AssertionError, match="bucket 1024"):
        cs.phase_slice10(torch.device("cpu"), llm, runner, tokenizer, quant,
                         params, cfg, counters)
    assert quant.quantized_matmul_ref is plain
    out = capsys.readouterr().out
    for tag in ("request e", "the schema'd tools", "request f",
                "request g", "request h", "request i",
                "spec_stats cortex True", "spec_stats repeat True",
                "spec_stats sampled True"):
        assert tag in out
    got = cs.verify_pass(torch.device("cpu"), llm, params, cfg,
                         tokenizer.ByteTokenizer(cfg.vocab_size))
    assert got["argmax_equal"] == cs.VERIFY_ROWS and got["rel_l2"] < 1e-4


def _tiny_profile_model():
    from trackiellm_tpu_torch.models import llm
    cfg = llm.LLMConfig.tiny()._replace(max_seq=512, sliding_window=512)
    return cfg, llm.init_params_quantized(torch.Generator().manual_seed(1),
                                          cfg, group=64, dtype=torch.float32)


def test_profile_path_checks_the_launch_count(monkeypatch):
    """profile_path's windows against a fake profiler that sees 10 W4A8
    launches less the window's drop: a window that misses launches is
    profiled again on a fresh runner; one that misses them every time
    keeps its wall and a ``partial`` note, and no busy time or launches."""
    from trackiellm_tpu_torch.llm import runner, tokenizer
    from trackiellm_tpu_torch.ops import quant
    cs = _load()
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(quant.q4_matmul_w4a8, "launches", 0)
    cfg, params = _tiny_profile_model()

    def profiler(drops):
        drops = iter(drops)

        def fake(fn):
            fn()
            quant.q4_matmul_w4a8.launches += 10  # the wrapper's count
            seen = 10 - next(drops)
            fake.windows += 1
            return 2.0, seen + 5, {"void q4_w4a8_kernel<4>(int)": (1.5, seen),
                                   "elementwise copy": (0.5, 5)}
        fake.windows = 0
        monkeypatch.setattr(cs, "device_breakdown", fake)
        return fake

    fake = profiler([3, 0, 0])
    out = cs.profile_path(torch.device("cpu"), runner, tokenizer, params, cfg)
    assert fake.windows == 3
    assert out["prefill"]["launches"] == 15 and "partial" not in out["prefill"]
    assert out["decode"]["busy_ms"] == 2.0 / out["decode"]["tokens"]

    fake = profiler([0] + [1] * (1 + cs.PROFILE_RETRIES))
    out = cs.profile_path(torch.device("cpu"), runner, tokenizer, params, cfg)
    assert fake.windows == 2 + cs.PROFILE_RETRIES
    assert out["prefill"]["busy_ms"] == 2.0
    assert out["decode"]["partial"] == "profiler saw q4_matmul_w4a8 9 of 10"
    assert set(out["decode"]) == {"wall_ms", "partial", "tokens"}


def test_missed_launches_reads_every_wrapper():
    cs = _load()
    by_name = {"void q8_mma_kernel<64>": (1.0, 4), "q8_fma_kernel": (0.1, 1),
               "flash_mma_kernel<128>": (0.2, 2), "copy": (0.1, 9)}
    assert cs.missed_launches(by_name, {"q8_matmul": 5,
                                        "flash_attention": 2}) is None
    assert (cs.missed_launches(by_name, {"q8_matmul": 5})
            == "profiler saw flash_attention 2 of 0")
    assert set(cs.PROFILED_KERNELS) <= set(cs.KERNELS)


def test_phase11_on_the_cpu(monkeypatch, capsys):
    """Phase 11's control flow on the CPU at tiny widths (the syncs
    stubbed, the CLI's device the CPU): the file is inspected, converted
    (config, tokenizer spec and bytes against the CPU's requantization),
    and answered from; the route check then fails, as it must where no
    kernel launches and the plain matmul runs."""
    import pytest
    from trackiellm_tpu_torch import __main__ as cli
    from trackiellm_tpu_torch.llm import tokenizer
    from trackiellm_tpu_torch.models import checkpoint, convert, llm
    from trackiellm_tpu_torch.ops import quant
    cs = _load()
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(cli, "_device", lambda name, verb: torch.device("cpu"))
    cfg = llm.LLMConfig.mistral_7b()._replace(
        vocab_size=512, dim=512, n_layers=2, n_heads=4, n_kv_heads=2,
        head_dim=128, hidden_dim=1024, max_seq=1024, sliding_window=1024)
    plain, load = quant.quantized_matmul_ref, convert.load_gguf_tensor
    with pytest.raises(AssertionError, match="quantized_matmul_ref ran"):
        cs.phase_gguf(torch.device("cpu"), cfg, llm, convert, checkpoint,
                      quant, tokenizer, cli, cs.launch_counters())
    assert quant.quantized_matmul_ref is plain
    assert convert.load_gguf_tensor is load
    out = capsys.readouterr().out
    assert "header types are the Q4_K_M mix" in out
    assert "23 tensors equal to the CPU's" in out
    assert "generate (201 prompt tokens): exit 0" in out


def test_phase12_on_the_cpu(monkeypatch, capsys):
    """Phase 12's control flow on the CPU at tiny widths (the profiler
    faked): measure_server's configurations and the int8 pool, each
    pinned burst's chunks equal to its per-step ids, the prefix cache's
    hits, the chunked prefill's interleave, the served tool call, the lone
    request's first token and prefill_batch against prefill pass; the
    route check then fails, as it must where no kernel launches."""
    import pytest
    from trackiellm_tpu_torch.llm import paging, runner, server, tokenizer
    from trackiellm_tpu_torch.models import llm
    from trackiellm_tpu_torch.tools import measure_server
    cs = _load()

    def fake_profile(fn):
        fn()
        return 1.0, 10, {"elementwise_kernel": (1.0, 10)}
    monkeypatch.setattr(cs, "device_breakdown", fake_profile)
    cfg, params = _tiny_profile_model()
    names = {n: getattr(llm, n) for n in cs.LogitWatch.NAMES}
    with pytest.raises(AssertionError,
                       match="phase 12: q4_matmul_w4a8 never launched"):
        cs.phase_serve(torch.device("cpu"), llm, runner, tokenizer, server,
                       paging, measure_server, params, cfg,
                       cs.launch_counters())
    assert all(getattr(llm, n) is fn for n, fn in names.items())
    out = capsys.readouterr().out
    for tag in ("serve per_step (round 1)", "serve paged_chunk8 (round 2)",
                "serve paged_int8_chunk8 (round 1)",
                "chunk8 against per_step (pinned burst of 16, waves [8, 8] "
                "and [8, 8]): ids and texts identical",
                "paged_chunk8 against paged_per_step (pinned burst",
                "prefix cache: 8 cortex prompts", "waves [8, 8]",
                "chunked prefill:", "served tool call (waves [4])",
                "lone request's first token", "prefill_batch of 8 vs prefill "
                "(f32a, bucket 512, M=4096)", "agreement (reported)",
                "profile chunk8 burst"):
        assert tag in out, tag


def test_serve_profile_notes_what_the_profiler_missed(monkeypatch):
    """serve_profile against a fake profiler that shows W4A8 launches the
    wrappers never counted (on the CPU no kernel launches): each window is
    taken again PROFILE_RETRIES times, then keeps its numbers beside a
    ``missed`` note; launches a step come from the two windows'
    difference, and every burst is one admission wave."""
    from trackiellm_tpu_torch.llm import server
    from trackiellm_tpu_torch.llm.tokenizer import ByteTokenizer
    from trackiellm_tpu_torch.tools import measure_server
    cs = _load()
    calls = []

    def fake_profile(fn):
        fn()
        calls.append(1)
        return 2.0 * len(calls), 100 * len(calls), {
            "q4_w4a8_kernel": (1.0, 10)}
    monkeypatch.setattr(cs, "device_breakdown", fake_profile)
    cfg, params = _tiny_profile_model()

    def make(**kw):
        s = server.LLMServer(params, cfg, batch_slots=cs.SERVE_SLOTS,
                             tokenizer=ByteTokenizer(cfg.vocab_size), **kw)
        return s, cs.ServerWatch(s)
    prof = cs.serve_profile(make, measure_server, lambda s: s.close(),
                            cs.launch_counters())
    tries = 1 + cs.PROFILE_RETRIES
    assert len(calls) == 2 * tries
    assert set(prof["missed"]) == set(cs.SERVE_PROFILE)
    assert "q4_matmul_w4a8 10 of 0" in prof["missed"][cs.SERVE_PROFILE[0]]
    long, short = cs.SERVE_PROFILE
    assert (prof["decode_steps"], prof["short_decode_steps"]) == (long, short)
    assert (prof["launches"], prof["short_launches"]) == (100 * tries,
                                                          200 * tries)
    assert prof["launches_per_step"] == -100 * tries / (long - short)
    assert prof["waves"] == [cs.SERVE_SLOTS] * (2 + 2 * tries)


def test_serve_profile_child_fails_without_a_card(monkeypatch):
    """Phase 12's profile runs this script again with SERVE_PROFILE_FLAG;
    where the child finds no card it exits non-zero, prints no profile,
    and the phase fails with the child's error."""
    import pytest
    cs = _load()
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    with pytest.raises(AssertionError, match="no CUDA device"):
        cs.serve_profile_child()


def _tiny_voice(cs, monkeypatch):
    """Phase 13 at tiny sizes on the CPU: the configs shrunk, the Piper
    state the tiny VITS's, the syncs and CUDA-event timer stubbed, the
    CLI's device the CPU."""
    from tests.test_vits import TestConverter
    from trackiellm_tpu_torch import __main__ as cli
    from trackiellm_tpu_torch.models import tts, vits, whisper
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(cli, "_device", lambda name, verb: torch.device("cpu"))
    monkeypatch.setattr(cs, "time_ms",
                        lambda fn, iters=10, warmup=2: (fn(), 1.0)[1])
    vcfg = vits.VITSConfig.tiny()
    monkeypatch.setattr(cs, "voice_configs", lambda: {
        "tiny": whisper.WhisperConfig.test(),
        "large": whisper.WhisperConfig.test()._replace(n_mels=128),
        "tts": tts.TTSConfig.tiny(),
        "vits": (vcfg.d_model, vcfg.n_layers, vcfg.up_init_ch,
                 vcfg.upsample_rates, 16000)})
    monkeypatch.setattr(cs, "piper_state", lambda seed: {
        k: v.numpy() for k, v in
        TestConverter()._torch_vits_state(vcfg, seed).items()})
    return cli


def test_phase13_on_the_cpu(monkeypatch, capsys):
    """Phase 13's control flow on the CPU at tiny widths: the GGML file is
    written, loaded and transcribed at both windows (the CPU against
    itself), the transcribe CLI prints the engine's text, the large-v3
    widths transcribe, Silero runs its 312 chunks from an ONNX file, the
    TTS streams and the Piper voice is read, compared and said through the
    synth CLI; no kernel counter moves."""
    from trackiellm_tpu_torch.models import llm
    cs = _load()
    cli = _tiny_voice(cs, monkeypatch)
    out = cs.phase_voice(torch.device("cpu"), llm, cli, cs.launch_counters(),
                         lambda: {"500": {"idle_share": 0.5}})
    assert set(out) == {"whisper_tiny", "silero", "tts", "vits", "seconds"}
    wt = out["whisper_tiny"]
    assert set(wt["windows"]) == {str(w) for w in cs.VOICE_WINDOWS}
    for w in wt["windows"].values():
        assert w["logits_rel_l2"] == 0.0 and w["ids"]["first_diff"] == 27
    assert wt["cli"]["rc"] == 0 and wt["profile"] == {"500": {
        "idle_share": 0.5}}
    assert out["silero"]["chunks"] == 312
    assert out["silero"]["max_abs_err"] == 0.0
    assert out["tts"]["streamed_bit_identical"]
    assert out["vits"]["frames_card"] == out["vits"]["frames_cpu"] > 0
    assert out["vits"]["cli"]["rc"] == 0
    text = capsys.readouterr().out
    for tag in ("whisper-tiny GGML:", "transcribe CLI (checkpoint, 48 kHz "
                "WAV): exit 0", "whisper large-v3 widths", "silero (ONNX, "
                "silero_v5 names): 312 chunks", "TTS default (60 chars)",
                "synth CLI exit 0", "phase 13 took"):
        assert tag in text, tag
    json.dumps(out)


def test_phase13_state_builders_match_the_published_layouts():
    """The Silero and Piper initializers phase 13 writes carry the name
    maps' published names and shapes, and convert to SileroConfig() and
    VITSConfig()'s widths; the GGML writer's file reads back as the
    state."""
    from trackiellm_tpu_torch.models import convert, vad, whisper
    from trackiellm_tpu_torch.models.ggml_reader import read_ggml_whisper
    cs = _load()
    st = cs.silero_state(0)
    assert sorted(st) == sorted(convert.load_name_map("silero_v5"))
    _, cfg = convert.silero_from_onnx(
        convert.apply_name_map(st, convert.load_name_map("silero_v5")),
        device="cpu")
    assert cfg == vad.SileroConfig()
    shapes = cs.map_shapes("piper_vits")
    st = cs.piper_state(0)
    assert {k: v.shape for k, v in st.items()} == shapes
    _, vcfg = convert.vits_from_torch(st, device="cpu")
    assert (vcfg.d_model, vcfg.n_layers, vcfg.up_init_ch,
            vcfg.upsample_rates, 22050) == cs.voice_configs()["vits"]
    import tempfile

    import numpy as np
    wcfg = whisper.WhisperConfig.test()
    state = cs.whisper_state(wcfg, 0)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "g.bin")
        cs.write_ggml_whisper(path, state, wcfg, np.zeros((80, 201),
                                                          np.float32),
                              cs.whisper_vocab(300))
        g = read_ggml_whisper(path)
    assert g.hparams["n_audio_head"] == wcfg.n_heads and len(g.vocab) == 300
    for name, a in state.items():
        tol = 0 if a.ndim < 2 or name in cs.GGML_F32_NAMES else 1e-3
        np.testing.assert_allclose(g.tensors[name], a, atol=tol, rtol=tol)


def test_main_prints_the_voice_line_before_the_last_five(monkeypatch,
                                                         capsys):
    """main's output ends with the voice line, then the five lines of
    earlier slices unchanged: serve, slice10, the card, kernels, result."""
    from trackiellm_tpu_torch.ops import _build
    cs = _load()
    monkeypatch.setattr(sys, "argv", ["chip_smoke.py"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_capability", lambda *a: (9, 0))
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: "H100")
    monkeypatch.setattr(cs, "nvidia_smi", lambda: "H100, 700.00 W")
    monkeypatch.setattr(_build, "build", lambda: _build.BUILD_ROOT / "x")
    monkeypatch.setattr(_build, "library", lambda: None)
    for name, value in (("phase_kernels", {}), ("phase_width", None),
                        ("build_model", {}), ("drive", {}),
                        ("expect_routes", None), ("profile_path", {}),
                        ("phase_entry", None), ("phase_diagnostics", {}),
                        ("kernels_line", '{"kernels": []}')):
        monkeypatch.setattr(cs, name, lambda *a, v=value, **k: v)
    monkeypatch.setattr(cs, "drive", lambda *a, **k: {
        "quantize_activations": 1, "q4_matmul_w4a8": 1})
    monkeypatch.setattr(cs, "phase_slice10", lambda *a, **k: {
        "launches": {}, "n": 10})
    monkeypatch.setattr(cs, "phase_gguf", lambda *a, **k: {"launches": {}})
    monkeypatch.setattr(cs, "phase_serve", lambda *a, **k: {
        "launches": {}, "n": 12})
    monkeypatch.setattr(cs, "phase_voice", lambda *a, **k: {"n": 13})
    monkeypatch.setattr(cs, "phase_vision", lambda *a, **k: {"n": 14})
    assert cs.main() == 0
    lines = capsys.readouterr().out.strip().splitlines()[-6:]
    assert json.loads(lines[0]) == {"voice": {"n": 13},
                                    "card": "H100, 700.00 W"}
    assert json.loads(lines[1]) == {"serve": {"n": 12},
                                    "card": "H100, 700.00 W"}
    assert json.loads(lines[2]) == {"slice10": {"launches": {}, "n": 10},
                                    "card": "H100, 700.00 W"}
    assert lines[3] == "H100, 700.00 W"
    assert lines[4] == '{"kernels": []}'
    assert json.loads(lines[5]) == {"ok": True, "device": {
        "platform": "gpu", "kind": "H100", "count": 1}}


def test_voice_profile_child_fails_without_a_card(monkeypatch):
    import pytest
    cs = _load()
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    with pytest.raises(AssertionError, match="no CUDA device"):
        cs.voice_profile_child()


def test_main_prints_the_vision_line_before_the_voice_line(monkeypatch,
                                                            capsys):
    """Phase 14's line comes just before the voice line; the five last
    lines stay serve, slice10, the card, kernels and the result."""
    from trackiellm_tpu_torch.ops import _build
    cs = _load()
    monkeypatch.setattr(sys, "argv", ["chip_smoke.py"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_capability", lambda *a: (9, 0))
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: "H100")
    monkeypatch.setattr(cs, "nvidia_smi", lambda: "H100, 700.00 W")
    monkeypatch.setattr(_build, "build", lambda: _build.BUILD_ROOT / "x")
    monkeypatch.setattr(_build, "library", lambda: None)
    for name, value in (("phase_kernels", {}), ("phase_width", None),
                        ("build_model", {}), ("profile_path", {}),
                        ("expect_routes", None), ("phase_entry", None),
                        ("phase_diagnostics", {}),
                        ("kernels_line", '{"kernels": []}')):
        monkeypatch.setattr(cs, name, lambda *a, v=value, **k: v)
    monkeypatch.setattr(cs, "drive", lambda *a, **k: {
        "quantize_activations": 1, "q4_matmul_w4a8": 1})
    for name, n in (("phase_slice10", 10), ("phase_gguf", 11),
                    ("phase_serve", 12)):
        monkeypatch.setattr(cs, name, lambda *a, n=n, **k: {
            "launches": {}, "n": n})
    seen = []
    monkeypatch.setattr(cs, "phase_voice", lambda *a, **k: (
        seen.append(13), {"n": 13})[1])
    monkeypatch.setattr(cs, "phase_vision", lambda dev, counters, profile: (
        seen.append((14, profile is cs.vision_profile_child)), {"n": 14})[1])
    assert cs.main() == 0
    assert seen == [13, (14, True)]
    lines = capsys.readouterr().out.strip().splitlines()[-7:]
    assert json.loads(lines[0]) == {"vision": {"n": 14},
                                    "card": "H100, 700.00 W"}
    assert json.loads(lines[1]) == {"voice": {"n": 13},
                                    "card": "H100, 700.00 W"}
    assert [json.loads(x) for x in lines[2:4]] == [
        {"serve": {"n": 12}, "card": "H100, 700.00 W"},
        {"slice10": {"launches": {}, "n": 10}, "card": "H100, 700.00 W"}]
    assert lines[4:] == ["H100, 700.00 W", '{"kernels": []}', json.dumps(
        {"ok": True, "device": {"platform": "gpu", "kind": "H100",
                                "count": 1}})]


def _tiny_vision(cs, monkeypatch):
    """Phase 14 at tiny sizes on the CPU: the configs and the frame shrunk,
    a few frames, the syncs stubbed."""
    from trackiellm_tpu_torch.models import depth, detector, dpt, ocr
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(cs, "vision_configs", lambda: {
        "v8n": detector.DetectorConfig.tiny(),
        "v5nu": detector.DetectorConfig.tiny_v5(),
        "midas": depth.DepthConfig.tiny(),
        "dpt": dpt.DPTSwinConfig.test_tiny(),
        "ocr": ocr.OCRConfig.tiny(), "frame": (120, 160)})
    monkeypatch.setattr(cs, "VISION_FRAMES", 2)
    monkeypatch.setattr(cs, "VISION_WARM", 1)
    monkeypatch.setattr(cs, "VISION_STAGE_ITERS", 1)


def test_phase14_on_the_cpu(monkeypatch, capsys):
    """Phase 14's control flow on the CPU at tiny widths (the CPU against
    itself): both detectors, NMS bit for bit, MiDaS and DPT, the OCR, both
    pipelines with every bit valid, the navigation grids; no counter
    moves; the vision line's numbers are JSON."""
    cs = _load()
    _tiny_vision(cs, monkeypatch)
    out = cs.phase_vision(torch.device("cpu"), cs.launch_counters(),
                          lambda: {"midas": {"idle_share": 0.5}})
    assert set(out) == {"frame", "models", "detector", "nms", "depth", "ocr",
                        "pipeline", "navigation", "launches", "profile",
                        "seconds"}
    for name in ("v8n", "v5nu"):
        d = out["detector"][name]
        assert d["nms_bit_equal"] and max(d["raw_rel_l2"].values()) == 0.0
    assert out["depth"]["midas"]["rel_l2"] == out["depth"]["dpt"][
        "rel_l2"] == 0.0
    assert out["ocr"]["strings_equal"] and out["ocr"]["crops"] == 8
    assert out["navigation"]["grid_equal"]
    for kind in ("midas", "dpt"):
        p = out["pipeline"][kind]
        assert p["valid"] == list(cs.VISION_BITS) and p["frames"] == 2
        assert p["objects"] == p["cpu_objects"] == p["objects_agree"] > 0
    assert not any(out["launches"].values())
    assert out["nms"]["sweep_steps"] == 256
    text = capsys.readouterr().out
    for tag in ("v8n at 160:", "v5nu at 160:", "midas at 96:", "dpt at 64:",
                "OCR (CRNN, 8 page crops)", "process_frame ALL with midas",
                "process_frame ALL with dpt", "navigation (96x96 depth",
                "phase 14 took"):
        assert tag in text, tag
    json.dumps(out)


@pytest.mark.parametrize("stage", ["detector", "ocr", "depth"])
def test_phase14_fails_when_a_requested_bit_is_missing(stage, monkeypatch):
    """A stage that raises clears its valid_analyses bit, as the reference
    degrades; phase 14 asked for every bit, so it fails."""
    cs = _load()
    _tiny_vision(cs, monkeypatch)
    real = cs.vision_fns

    def broken(params, sizes, kind):
        fns = list(real(params, sizes, kind))

        def boom(*a):
            raise RuntimeError("stage failed on the card")
        fns[("detector", "depth", "ocr").index(stage)] = boom
        return tuple(fns)
    monkeypatch.setattr(cs, "vision_fns", broken)
    bit = {"detector": "DETECTION", "ocr": "OCR", "depth": "DEPTH"}[stage]
    with pytest.raises(AssertionError, match=f"lacks .*{bit}"):
        cs.phase_vision(torch.device("cpu"), cs.launch_counters(),
                        lambda: {})


def test_vision_profile_child_fails_without_a_card(monkeypatch):
    cs = _load()
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    with pytest.raises(AssertionError, match="no CUDA device"):
        cs.vision_profile_child()


def test_vision_frame_is_seeded():
    cs = _load()
    a = cs.vision_frame((480, 640), 1)
    assert a.shape == (480, 640, 3) and a.dtype.name == "uint8"
    assert (a == cs.vision_frame((480, 640), 1)).all()
    assert (a != cs.vision_frame((480, 640), 2)).any()
    assert a[:100].std() > 5 and a[300:].mean() > a[200:250].mean() - 40
