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

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(ROOT, "chip_smoke.py")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The phase rehearsals are host-bound at tiny widths; beside other
    test processes, torch's thread pool oversubscribes the cores and
    slows them (and their neighbours) many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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
    carry w_gu at M=1 (decode) and M=512 (prefill) as their first headline
    cases, so the kernels line and PERF.md's table carry both device-only
    times; phase 3 runs both M. W4A8 and Q8 also carry Qwen3-Next's
    lm_head (N = 151,936) at decode, W4A8 its expert w_down (K = 512)."""
    cs = _load()
    for name in ("q4_matmul_w4a8", "q8_matmul", "q4_matmul_f32a"):
        assert cs.KERNELS[name][2][:2] == ("w_gu M=1", "w_gu M=512")
    assert cs.KERNELS["q4_matmul_f32a"][2] == ("w_gu M=1", "w_gu M=512")
    for name in ("q4_matmul_w4a8", "q8_matmul"):
        assert "qwen3next lm_head N=151936 M=1" in cs.KERNELS[name][2]
    assert ("qwen3next expert w_down K=512 M=1"
            in cs.KERNELS["q4_matmul_w4a8"][2])
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
    for tag in ("serve per_step: aggregate_tok_s=",
                "serve paged_chunk8: aggregate_tok_s=",
                "serve paged_int8_chunk8: aggregate_tok_s=",
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
        # The tiny model ends its reply after 27 ids, or at the budget.
        assert w["logits_rel_l2"] == 0.0 and (
            w["ids"]["first_diff"] == min(27, cs.VOICE_TOKENS))
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
                        ("build_model", {"layers": {}}), ("drive", {}),
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
    monkeypatch.setattr(cs, "phase_app", lambda *a, **k: {"launches": {}})
    monkeypatch.setattr(cs, "phase_families", lambda *a, **k: {
        "launches": {}})
    monkeypatch.setattr(cs, "phase_moe", lambda *a, **k: {"launches": {}})
    monkeypatch.setattr(cs, "phase_vlm", lambda *a, **k: {"launches": {}})
    monkeypatch.setattr(cs, "phase_surfaces", lambda *a, **k: {
        "launches": {}})
    monkeypatch.setattr(cs, "phase_perception", lambda *a, **k: {
        "launches": {}})
    monkeypatch.setattr(cs, "phase_mla_mamba", lambda *a, **k: {
        "launches": {}})
    monkeypatch.setattr(cs, "phase_qwen3next", lambda *a, **k: {
        "launches": {}})
    monkeypatch.setattr(cs, "phase_training", lambda *a, **k: {
        "launches": {}})
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
                        ("build_model", {"layers": {}}), ("profile_path", {}),
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
    monkeypatch.setattr(cs, "phase_app", lambda *a, **k: {"launches": {}})
    monkeypatch.setattr(cs, "phase_families", lambda *a, **k: {
        "launches": {}})
    monkeypatch.setattr(cs, "phase_moe", lambda *a, **k: {"launches": {}})
    monkeypatch.setattr(cs, "phase_vlm", lambda *a, **k: {"launches": {}})
    monkeypatch.setattr(cs, "phase_surfaces", lambda *a, **k: {
        "launches": {}})
    monkeypatch.setattr(cs, "phase_perception", lambda *a, **k: {
        "launches": {}})
    monkeypatch.setattr(cs, "phase_mla_mamba", lambda *a, **k: {
        "launches": {}})
    monkeypatch.setattr(cs, "phase_qwen3next", lambda *a, **k: {
        "launches": {}})
    monkeypatch.setattr(cs, "phase_training", lambda *a, **k: {
        "launches": {}})
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
                        "pipeline", "navigation", "tensor_frame", "launches",
                        "profile", "seconds"}
    assert out["tensor_frame"]["equal"]
    assert out["tensor_frame"]["valid"] == list(cs.VISION_BITS)
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
                "process_frame ALL on a cpu tensor frame against numpy",
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


def test_main_prints_the_app_line_before_the_vision_line(monkeypatch,
                                                         capsys):
    """Phase 15 runs after phase 14 with the measuring child; its line
    comes just before the vision line, the smoke's wall on a line before
    it, and the kernels line counts phase 15's launches."""
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
                        ("build_model", {"layers": {}}), ("profile_path", {}),
                        ("expect_routes", None), ("phase_entry", None),
                        ("phase_diagnostics", {})):
        monkeypatch.setattr(cs, name, lambda *a, v=value, **k: v)
    monkeypatch.setattr(cs, "drive", lambda *a, **k: {
        "quantize_activations": 1, "q4_matmul_w4a8": 1})
    for name, n in (("phase_slice10", 10), ("phase_gguf", 11),
                    ("phase_serve", 12)):
        monkeypatch.setattr(cs, name, lambda *a, n=n, **k: {
            "launches": {}, "n": n})
    monkeypatch.setattr(cs, "phase_voice", lambda *a, **k: {"n": 13})
    monkeypatch.setattr(cs, "phase_vision", lambda *a, **k: {"n": 14})
    seen = []
    monkeypatch.setattr(cs, "phase_app", lambda dev, cli, counters, e2e: (
        seen.append(e2e is cs.app_e2e_child),
        {"launches": {"q4_matmul_w4a8": 7}, "n": 15})[1])
    monkeypatch.setattr(cs, "kernels_line", lambda rows, launches: json.dumps(
        {"phase15": launches[15]}))
    monkeypatch.setattr(cs, "phase_families", lambda *a, **k: {
        "launches": {}, "n": 16})
    monkeypatch.setattr(cs, "phase_moe", lambda *a, **k: {"launches": {}})
    monkeypatch.setattr(cs, "phase_vlm", lambda *a, **k: {"launches": {}})
    monkeypatch.setattr(cs, "phase_surfaces", lambda *a, **k: {
        "launches": {}})
    monkeypatch.setattr(cs, "phase_perception", lambda *a, **k: {
        "launches": {}})
    monkeypatch.setattr(cs, "phase_mla_mamba", lambda *a, **k: {
        "launches": {}})
    monkeypatch.setattr(cs, "phase_qwen3next", lambda *a, **k: {
        "launches": {}})
    monkeypatch.setattr(cs, "phase_training", lambda *a, **k: {
        "launches": {}})
    assert cs.main() == 0
    assert seen == [True]
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-18].startswith("chip_smoke wall: ")
    assert json.loads(lines[-9])["families"] == {"launches": {}, "n": 16}
    assert json.loads(lines[-8]) == {"app": {
        "launches": {"q4_matmul_w4a8": 7}, "n": 15},
        "card": "H100, 700.00 W"}
    assert json.loads(lines[-7])["vision"] == {"n": 14}
    assert json.loads(lines[-2]) == {"phase15": {"q4_matmul_w4a8": 7}}


def test_phase15_on_the_cpu(monkeypatch, capsys):
    """Phase 15's control flow on the CPU at tiny widths: the wake word
    (the CPU against itself), the demo in-process with --device cpu for as
    long as on the card (the reply must be spoken in its second half), and
    measure_app_e2e's measurement in-process at tiny widths with every run
    complete; the route check then fails, as it must where no kernel
    launches."""
    from trackiellm_tpu_torch import __main__ as cli
    from trackiellm_tpu_torch.models import depth, detector, llm, tts, whisper
    from trackiellm_tpu_torch.tools import measure_app_e2e
    cs = _load()
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    cpu = torch.device("cpu")
    sizes = {"detector": detector.DetectorConfig.tiny(),
             "depth": depth.DepthConfig.tiny(),
             "asr": whisper.WhisperConfig.test(), "llm": llm.LLMConfig.tiny(),
             "llm_group": 64, "tts": tts.TTSConfig.tiny(), "frame": (96, 128)}

    def e2e():
        return measure_app_e2e.measure(
            cpu, runs=cs.APP_RUNS, seed=cs.SEED, sizes=sizes, speech_s=1.0,
            warm_timeout_s=10.0, run_timeout_s=10.0, log=lambda s: None)
    with pytest.raises(AssertionError,
                       match="phase 15: q4_matmul_w4a8 never launched"):
        cs.phase_app(cpu, cli, cs.launch_counters(), e2e)
    out = capsys.readouterr().out
    for tag in ("wake word (bundled artifact, 16 windows): card against CPU "
                "max abs 0", "decisions equal", "as on the CPU",
                f"demo {cs.APP_DEMO_SECONDS}: exit 0", "1 at the reply's "
                "priority",
                f"measure_app_e2e ({cs.APP_RUNS} runs after a warm one, 0 "
                "incomplete)", "q4_matmul_f32a stayed at 0"):
        assert tag in out, tag


def test_phase15_fails_on_an_incomplete_run(monkeypatch):
    """A measured run that never reached reply audio fails the phase (the
    reference's harness skips it)."""
    cs = _load()
    monkeypatch.setattr(cs, "app_wake_word", lambda dev: {})
    monkeypatch.setattr(cs, "app_demo", lambda dev, cli, counters: {})
    with pytest.raises(AssertionError, match="not every app run"):
        cs.phase_app(torch.device("cpu"), None, {}, lambda: {
            "runs": 3, "incomplete": 1, "runs_ms": [1.0, 2.0],
            "launches": {}})


DEMO_OK = ("assistant running for 4s on cuda:0\n"
           "[tts] 12320 samples at priority 3\n"
           "[tts] 6880 samples at priority 1\n"
           "cortex stats: {'last_vision_ms': 63.0, 'last_llm_ms': 120.2}\n"
           "scheduler stats: {'vision': {'count': 4.0, 'ema_ms': 1.0, "
           "'ema_wait_ms': 1.0}, 'tts': {'count': 3.0, 'ema_ms': 1.0, "
           "'ema_wait_ms': 1.0}}\n")


@pytest.mark.parametrize("rc, text, ok", [
    (0, DEMO_OK, True),
    (1, DEMO_OK, False),
    (0, DEMO_OK.replace("priority 1", "priority 2"), False),
    (0, DEMO_OK.replace("'last_llm_ms': 120.2", "'iterations': 3"), False),
    (0, DEMO_OK.replace("'vision'", "'other'"), False),
], ids=["answered", "exit 1", "only alerts spoken", "no LLM turn",
        "no vision job"])
def test_phase15_demo_needs_the_reply_spoken_an_llm_turn_and_vision(
        monkeypatch, rc, text, ok):
    """The demo passes only with exit 0 (no failure absorbed, a failed
    vision job among them), a vision job, an LLM turn in the cortex stats,
    and a spoken line at the reply's priority: a safety alert (CRITICAL)
    is not the cortex's answer."""
    cs = _load()
    monkeypatch.setattr(cs, "run_cli", lambda cli, argv: (rc, text, 4.2))
    if ok:
        out = cs.app_demo(torch.device("cuda"), None, {})
        assert out["replies"] == 1 and out["last_llm_ms"] == 120.2
    else:
        with pytest.raises(AssertionError, match="phase 15: demo exit"):
            cs.app_demo(torch.device("cuda"), None, {})


def test_app_e2e_child_fails_without_a_card(monkeypatch):
    cs = _load()
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    with pytest.raises(AssertionError, match="no CUDA device"):
        cs.app_e2e_child()


def test_wake_windows_are_seeded():
    cs = _load()
    a = cs.wake_windows(1)
    assert len(a) == cs.WAKE_WINDOWS
    assert [k for k, _ in a[:4]] == ["keyword", "imposter"] * 2
    assert all(c.shape == (cs.WAKE_WINDOW,) and c.dtype.name == "float32"
               for _, c in a)
    assert all((x == y).all() for (_, x), (_, y) in zip(a, cs.wake_windows(1)))


def test_phase16_groups_divide_every_family_k():
    """q4_group gives each dense preset the largest group that divides
    every K/2 (256 where it can; Gemma-2-2B, Gemma-3 12B/27B, OLMo-2 and
    SmolLM3 128; Gemma-3-1B and GLM-4 64)."""
    from trackiellm_tpu_torch.models import llm
    cs = _load()
    groups = {name: cs.q4_group(getattr(llm.LLMConfig, name)())
              for name in llm.DENSE_PRESETS}
    assert groups == {
        "mistral_7b": 256, "llama3_8b": 256, "qwen2_7b": 256,
        "phi3_mini": 256, "granite3_8b": 256, "glm4_9b": 64,
        "gemma2_2b": 128, "gemma2_9b": 256, "gemma3_1b": 64,
        "gemma3_4b": 256, "gemma3_12b": 128, "gemma3_27b": 128,
        "olmo2_7b": 128, "smollm3_3b": 128, "qwen3_8b": 256}
    swept = set(cs.FAMILY_SWEEP) | {"gemma2_9b", "llama3_8b", "mistral_7b"}
    assert swept == set(llm.DENSE_PRESETS)


def test_phase16_configs_keep_the_published_widths_and_windows():
    """Phase 16's configs: Gemma-2-9B as published but its depth (2 of 42
    layers; max_seq 8192, the alternating window of 4096 on its even
    layers); Llama-3 at 2 layers and max_seq 2048; the sweep at 1 layer
    (Gemma-2-2B at 2, both its layer kinds) with every window that was on
    still on and each long prompt past it; Phi-3 as its 128k longrope
    variant; phase 3's family cases."""
    from trackiellm_tpu_torch.models import llm
    cs = _load()
    g = cs.family_cfg(llm, "gemma2_9b")
    assert g == llm.LLMConfig.gemma2_9b()._replace(n_layers=2)
    assert llm._layer_window(g) == 4096
    assert {llm._is_sliding(g, li) for li in range(g.n_layers)} == {
        True, False}
    ll = cs.family_cfg(llm, "llama3_8b")
    assert ll.max_seq == 2048 and ll.n_layers == 2
    g2 = cs.family_cfg(llm, "gemma2_2b")
    assert {llm._is_sliding(g2, li) for li in range(g2.n_layers)} == {
        True, False}
    for name in cs.FAMILY_SWEEP:
        pub = getattr(llm.LLMConfig, name)()
        cfg = cs.family_cfg(llm, name)
        assert cfg.n_layers == (2 if name == "gemma2_2b" else 1) and (
            cfg.dim, cfg.hidden_dim, cfg.n_heads,
                                      cfg.head_dim, cfg.vocab_size) == (
            pub.dim, pub.hidden_dim, pub.n_heads, pub.head_dim,
            pub.vocab_size)
        assert llm._layer_window(cfg) == llm._layer_window(pub)
        if name in cs.FAMILY_LONG:
            assert cs.FAMILY_LONG[name] > llm._layer_window(cfg) > 0
            assert cs.FAMILY_LONG[name] % 256 == 0
    phi = cs.family_cfg(llm, "phi3_mini")
    assert phi.rope_original_max_seq == 4096 < cs.PHI3_LONG_SIDE
    assert cs.FAMILY_LONG["phi3_mini"] < 4096
    assert abs(phi.rope_attention_factor - 1.190) < 1e-3
    flash = {(d, heads): (sizes, set(v)) for d, heads, sizes, v in
             cs.FAMILY_FLASH}
    assert flash[(256, (16, 8))] == ((512, 1024), {"causal", "window512",
                                                   "softcap50"})
    assert flash[(96, (32, 32))][0] == (512,)
    assert "window2047" in flash[(96, (32, 32))][1]
    groups = {g for _, _, _, g, _ in cs.FAMILY_MATMULS}
    assert {64, 128} <= groups
    assert any(n == 49155 for _, _, n, _, _ in cs.FAMILY_MATMULS)


def _tiny_family_cfg(llm, name):
    """A preset's knob set at widths the CPU runs in seconds; windows and
    patterns as the families tests cut them."""
    c = getattr(llm.LLMConfig, name)()
    windowed = 0 < c.sliding_window < c.max_seq
    return c._replace(
        vocab_size=320, dim=128, n_layers=2, n_heads=4,
        n_kv_heads=4 // min(c.n_heads // c.n_kv_heads, 4), head_dim=32,
        hidden_dim=256, max_seq=512, sliding_window=24 if windowed else 512,
        window_pattern=2 if c.window_pattern else 0,
        nope_pattern=2 if c.nope_pattern else 0,
        rope_original_max_seq=300 if name == "phi3_mini" else 0)


def test_phase16_on_the_cpu(monkeypatch, capsys):
    """Phase 16's control flow on the CPU at tiny widths (the profile
    child faked, the routes' check recorded): (a) generates at lookahead 4
    and 1 with equal ids and serves its bursts; (b) sweeps every preset
    card against CPU (the same CPU here) with the long prompts and Phi-3's
    two sides; (c) converts the three GGUFs on the CPU and answers with
    equal ids. Every route check asks for the kernels, which here never
    launch."""
    from trackiellm_tpu_torch import __main__ as cli
    from trackiellm_tpu_torch.llm import paging, runner, server, tokenizer
    from trackiellm_tpu_torch.models import checkpoint, llm
    from trackiellm_tpu_torch.ops import attention, quant
    from trackiellm_tpu_torch.tools import measure_server
    cs = _load()
    cpu = torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda *a: None)
    monkeypatch.setattr(cli, "_device", lambda name, verb: cpu)
    monkeypatch.setattr(cs, "family_cfg", _tiny_family_cfg)
    monkeypatch.setattr(cs, "FAMILY_LONG", {"gemma3_1b": 256,
                                            "phi3_mini": 256,
                                            "gemma2_2b": 256})
    monkeypatch.setattr(cs, "PHI3_LONG_SIDE", 320)
    monkeypatch.setattr(cs, "FAMILY_TOKENS", 6)
    monkeypatch.setattr(cs, "FAMILY_GGUF_TOKENS", 6)
    monkeypatch.setattr(cs, "FAMILY_GGUF_WIDTHS", (256, 2, 2, 2, 512, 320))
    monkeypatch.setattr(attention, "flash_kernel_attrs",
                        lambda d, dt: {"regs": 1, "local_bytes": 0,
                                       "smem_bytes": 1})
    routes = []
    monkeypatch.setattr(cs, "expect_routes", lambda launches, ran, idle,
                        phase: routes.append((phase, ran)))
    out = cs.phase_families(
        cpu, llm, runner, tokenizer, server, paging, measure_server,
        checkpoint, attention, quant, cli, cs.launch_counters(),
        lambda: {"decode": {"wall_ms": 1.0}})
    assert set(out["sweep"]) == set(cs.FAMILY_SWEEP)
    assert all(max(r["rel_l2"].values()) == 0.0
               for r in out["sweep"].values())
    assert set(out["sweep"]["phi3_mini"]["rel_l2"]) == {"64", "256", "320"}
    assert set(out["gguf"]) == set(cs.FAMILY_GGUF_ARCHES)
    phases = [p for p, _ in routes]
    assert phases == ["phase 16 gemma2_9b", "phase 16 serve dense_chunk8",
                      "phase 16 serve paged_int8_chunk8",
                      "phase 16 llama3_8b", "phase 16 command-r",
                      "phase 16 nemotron", "phase 16 starcoder2"]
    text = capsys.readouterr().out
    for tag in ("gemma2_9b: lookahead 4 == lookahead 1",
                "serve paged_int8_chunk8:", "card ids == cpu ids: True",
                "layernorm norm, act relu2, gated False",
                "phase 16 took"):
        assert tag in text, tag


def test_main_prints_the_moe_line_before_the_families_line(monkeypatch,
                                                           capsys):
    """Phase 17 runs after phase 16 with its profiling child; its line (with
    phase 3's MoE rows) comes just before the families line, the smoke's
    wall on a line before it, and the kernels line counts its launches."""
    from trackiellm_tpu_torch.ops import _build
    cs = _load()
    monkeypatch.setattr(sys, "argv", ["chip_smoke.py"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_capability", lambda *a: (9, 0))
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: "H100")
    monkeypatch.setattr(cs, "nvidia_smi", lambda: "H100, 700.00 W")
    monkeypatch.setattr(_build, "build", lambda: _build.BUILD_ROOT / "x")
    monkeypatch.setattr(_build, "library", lambda: None)
    rows = {name: [] for name in cs.KERNELS}
    rows["q4_matmul_w4a8"] = [{"case": "gpt-oss w_gu G=32 M=1"},
                              {"case": "w_gu M=1"}]
    for name, value in (("phase_kernels", rows), ("phase_width", None),
                        ("build_model", {"layers": {}}), ("profile_path", {}),
                        ("expect_routes", None), ("phase_entry", None),
                        ("phase_diagnostics", {})):
        monkeypatch.setattr(cs, name, lambda *a, v=value, **k: v)
    monkeypatch.setattr(cs, "drive", lambda *a, **k: {
        "quantize_activations": 1, "q4_matmul_w4a8": 1})
    for name, n in (("phase_slice10", 10), ("phase_gguf", 11),
                    ("phase_serve", 12), ("phase_app", 15),
                    ("phase_families", 16)):
        monkeypatch.setattr(cs, name, lambda *a, n=n, **k: {
            "launches": {}, "n": n})
    monkeypatch.setattr(cs, "phase_voice", lambda *a, **k: {"n": 13})
    monkeypatch.setattr(cs, "phase_vision", lambda *a, **k: {"n": 14})
    seen = []
    monkeypatch.setattr(cs, "phase_moe", lambda *a, **k: (
        seen.append(a[-1] is cs.moe_profile_child),
        {"launches": {"q4_matmul_w4a8": 9}, "n": 17})[1])
    monkeypatch.setattr(cs, "kernels_line", lambda rows, launches: json.dumps(
        {"phase17": launches[17]}))
    monkeypatch.setattr(cs, "phase_vlm", lambda *a, **k: {"launches": {}})
    monkeypatch.setattr(cs, "phase_surfaces", lambda *a, **k: {
        "launches": {}})
    monkeypatch.setattr(cs, "phase_perception", lambda *a, **k: {
        "launches": {}})
    monkeypatch.setattr(cs, "phase_mla_mamba", lambda *a, **k: {
        "launches": {}})
    monkeypatch.setattr(cs, "phase_qwen3next", lambda *a, **k: {
        "launches": {}})
    monkeypatch.setattr(cs, "phase_training", lambda *a, **k: {
        "launches": {}})
    assert cs.main() == 0
    assert seen == [True]
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-18].startswith("chip_smoke wall: ")
    moe = json.loads(lines[-10])
    assert moe["moe"] == {"launches": {"q4_matmul_w4a8": 9}, "n": 17}
    assert moe["moe_kernels"]["q4_matmul_w4a8"] == [
        {"case": "gpt-oss w_gu G=32 M=1"}]
    assert json.loads(lines[-9])["families"]["n"] == 16
    assert json.loads(lines[-2]) == {"phase17": {"q4_matmul_w4a8": 9}}


def test_main_prints_the_vlm_line_and_the_phase_seconds(monkeypatch,
                                                       capsys):
    """Phase 18 runs after phase 17 on phase 11's GGUF; its line comes just
    before the moe line, the smoke's wall and the phase seconds (1 to 21,
    and the wall from the start) on the lines before phase 20's, and the
    kernels line counts its launches."""
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
                        ("build_model", {"layers": {}}), ("profile_path", {}),
                        ("expect_routes", None), ("phase_entry", None),
                        ("phase_diagnostics", {})):
        monkeypatch.setattr(cs, name, lambda *a, v=value, **k: v)
    monkeypatch.setattr(cs, "drive", lambda *a, **k: {
        "quantize_activations": 1, "q4_matmul_w4a8": 1})
    gguf = []
    monkeypatch.setattr(cs, "phase_gguf", lambda *a, **k: (
        gguf.append(k["workdir"]), {"launches": {}})[1])
    for name, n in (("phase_slice10", 10), ("phase_serve", 12),
                    ("phase_app", 15), ("phase_families", 16),
                    ("phase_moe", 17)):
        monkeypatch.setattr(cs, name, lambda *a, n=n, **k: {
            "launches": {}, "n": n})
    monkeypatch.setattr(cs, "phase_voice", lambda *a, **k: {"n": 13})
    monkeypatch.setattr(cs, "phase_vision", lambda *a, **k: {"n": 14})
    seen = []
    monkeypatch.setattr(cs, "phase_vlm", lambda *a, **k: (
        seen.append(a[-2:]), {"launches": {"q4_matmul_f32a": 4}, "n": 18})[1])
    monkeypatch.setattr(cs, "kernels_line", lambda rows, launches: json.dumps(
        {"phase18": launches[18]}))
    monkeypatch.setattr(cs, "phase_surfaces", lambda *a, **k: {
        "launches": {}})
    monkeypatch.setattr(cs, "phase_perception", lambda *a, **k: {
        "launches": {}})
    monkeypatch.setattr(cs, "phase_mla_mamba", lambda *a, **k: {
        "launches": {}})
    monkeypatch.setattr(cs, "phase_qwen3next", lambda *a, **k: {
        "launches": {}})
    monkeypatch.setattr(cs, "phase_training", lambda *a, **k: {
        "launches": {}})
    assert cs.main() == 0
    assert seen == [(os.path.join(gguf[0], "mistral.gguf"), gguf[0])]
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-18].startswith("chip_smoke wall: ")
    timing = json.loads(lines[-17])
    assert set(timing["phase_seconds"]) == {str(n) for n in range(1, 24)}
    assert timing["wall_s"] >= sum(timing["phase_seconds"].values()) * 0.999
    assert json.loads(lines[-11]) == {
        "vlm": {"launches": {"q4_matmul_f32a": 4}, "n": 18},
        "card": "H100, 700.00 W"}
    assert json.loads(lines[-10])["moe"]["n"] == 17
    assert json.loads(lines[-2]) == {"phase18": {"q4_matmul_f32a": 4}}
    assert not os.path.exists(gguf[0])   # the work directory is removed


def test_moe_profile_child_fails_without_a_card(monkeypatch):
    cs = _load()
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    with pytest.raises(AssertionError, match="no CUDA device"):
        cs.moe_profile_child()


def test_phase17_configs_keep_the_published_widths():
    """Phase 17's configs: gpt-oss-20b at its widths cut to 2 of its 24
    layers (both kinds of its alternating attention) with max_seq cut to
    4096 (its window of 128 on), Qwen3-30B-A3B at 2 to 48 layers; the sweep
    keeps every width, expert count and top-k, at 1 layer (gpt-oss-120b's
    windowed one; Llama-4's NoPE layers run in the tiny chunked model);
    q4_group gives gpt-oss group 32 (K/2 = 1440) and the Qwen3 experts 128;
    the int8 pool's tiny knob sets keep sinks, a window, chunks and a NoPE
    layer; phase 3's MoE cases."""
    from trackiellm_tpu_torch.models import llm
    cs = _load()
    g = cs.moe_cfg(llm, "gpt_oss_20b", cs.MOE_GPTOSS_LAYERS,
                   cs.MOE_GPTOSS_MAX_SEQ)
    assert g._replace(max_seq=131072, n_layers=24) == \
        llm.LLMConfig.gpt_oss_20b()
    assert g.n_layers == 2
    assert {llm._window_of(g, li) for li in range(g.n_layers)} == {0, 128}
    assert llm._layer_window(g) == 128 and cs.q4_group(g) == 32
    q = cs.moe_cfg(llm, "qwen3_moe_30b_a3b", cs.MOE_QWEN3_LAYERS,
                   cs.MOE_QWEN3_MAX_SEQ)
    assert 48 >= q.n_layers >= 2 and cs.q4_group(q) == 128
    assert set(cs.MOE_SWEEP) == set(llm.MOE_PRESETS) - {"gpt_oss_20b"}
    for name, layers in cs.MOE_SWEEP.items():
        pub = getattr(llm.LLMConfig, name)()
        cfg = cs.moe_cfg(llm, name, layers, max(cs.MOE_BUCKETS))
        keep = ("dim", "hidden_dim", "n_heads", "n_kv_heads", "head_dim",
                "vocab_size", "n_experts", "n_experts_used",
                "moe_shared_hidden")
        assert all(getattr(cfg, k) == getattr(pub, k) for k in keep), name
        assert cfg.n_layers == 1
    assert any(llm._is_nope(cs.moe_cfg(llm, "llama4_scout", 4), li)
               for li in range(4))   # the depth moe_chunks' model keeps
    o = cs.moe_cfg(llm, "gpt_oss_120b", cs.MOE_SWEEP["gpt_oss_120b"])
    assert [llm._window_of(o, li) for li in range(o.n_layers)] == [128]
    assert cs.MOE_SWEEP_Q8[0] in cs.MOE_SWEEP
    gp, l4 = (cs.moe_pool_cfg(llm, n) for n in cs.MOE_POOL)
    assert gp.attn_sinks and llm._layer_window(gp) == cs.MOE_POOL_SPAN
    assert l4.attn_chunk == cs.MOE_POOL_SPAN and any(
        llm._is_nope(l4, li) for li in range(l4.n_layers))
    shapes = {(k, n, g) for _, k, n, g, _, _ in cs.MOE_MATMULS}
    assert {(2880, 5760, 32), (2880, 2880, 32), (2880, 201088, 32)} == shapes
    for _, _, n, _, ms, kernels in cs.MOE_MATMULS:
        if n == 201088:
            assert ms == (1,) and kernels == ("q4_matmul_w4a8",)
        else:
            assert ms == (1, 8, 512) and set(kernels) == {
                "q4_matmul_w4a8", "q4_matmul_f32a", "q8_matmul"}
    d, heads, s, variants = cs.MOE_FLASH
    assert (d, heads, s) == (64, (64, 8), 512)
    assert {"sinks": True, "window": 128} in variants.values()
    assert {"sinks": True} in variants.values()


def test_a_router_flip_above_its_margin_fails_the_run(capsys):
    """``router_flips`` finds the tokens where the CPU's own top-k is not
    the card's experts, with the CPU's margin there, and measures the
    router's noise on the tokens that did not flip; ``check_router_flips``
    passes a flip whose margin is within twice that noise and fails the
    run on one whose card values moved far more than the noise."""
    from trackiellm_tpu_torch.models import llm
    cs = _load()
    top_k = llm._top_k_first
    cpu = torch.tensor([[3.0, 2.0, 1.0, 0.0], [3.0, 2.0, 1.99, 0.0],
                        [0.0, 1.0, 2.0, 3.0]])
    card = cpu.clone()
    card[0, 1] += 0.006         # rounding: no flip, the noise
    card[1, 1:3] = torch.tensor([1.995, 1.996])   # margin 0.01 crossed
    card[2, 1:3] = torch.tensor([2.5, 1.5])       # margin 1.0 crossed
    ids = top_k(card, 2)
    flips, noise = cs.router_flips(top_k, [card], [ids], [cpu], 2, 2)
    assert [(f["layer"], f["token"]) for f in flips] == [(0, 1)]
    f = flips[0]
    assert (f["card"], f["cpu"]) == ([0, 2], [0, 1]) and f["explained"]
    assert abs(f["margin"] - 0.01) < 1e-6 and abs(noise - 0.006) < 1e-6
    cs.check_router_flips(flips, noise, "near tie")
    flips, noise = cs.router_flips(top_k, [card], [ids], [cpu], 2, 3)
    assert [f["token"] for f in flips] == [1, 2]
    assert flips[0]["explained"] and not flips[1]["explained"]
    assert abs(flips[1]["margin"] - 1.0) < 1e-6
    with pytest.raises(AssertionError, match="above twice the router"):
        cs.check_router_flips(flips, noise, "moved")
    assert "NOT explained" in capsys.readouterr().out
    assert cs.router_flips(top_k, [cpu], [top_k(cpu, 2)], [cpu], 2, 3) == (
        [], 0.0)
    with pytest.raises(AssertionError, match="router calls"):
        cs.router_flips(top_k, [cpu], [], [cpu], 2, 2)


def test_router_tap_forces_the_card_experts():
    """``RouterTap`` keeps each MoE layer's selection values and expert
    ids and restores the router on close; forced to ids, each layer runs
    those experts on its own scores: forced to its own ids the logits keep
    their bits, forced to others they move."""
    from trackiellm_tpu_torch.models import llm
    cs = _load()
    cfg = _tiny_moe_cfg(cs)(llm, "qwen3_moe_30b_a3b")
    params = llm.init_params(torch.Generator().manual_seed(0), cfg,
                             dtype=torch.float32, device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (16,),
                         generator=torch.Generator().manual_seed(1))
    router = llm._moe_router

    def run(forced=None):
        tap = cs.RouterTap(llm, forced)
        try:
            lg, _ = llm.prefill(params, cfg, toks, 16, llm.KVCache.create(
                cfg, torch.float32, max_seq=16, device="cpu"))
        finally:
            select, ids = tap.close()
        assert llm._moe_router is router
        return lg, select, ids
    lg, select, ids = run()
    assert len(select) == len(ids) == cfg.n_layers
    assert select[0].shape == (16, cfg.n_experts)
    assert ids[0].shape == (16, cfg.n_experts_used)
    same, _, same_ids = run(ids)
    assert torch.equal(same, lg)
    assert all(torch.equal(a, b) for a, b in zip(same_ids, ids))
    other = [(i + 1) % cfg.n_experts for i in ids]
    moved, _, got = run(other)
    assert all(torch.equal(a, b) for a, b in zip(got, other))
    assert not torch.allclose(moved, lg)


def test_w4a8_activations_are_the_kernels_plain_function():
    """Inside ``w4a8_activations`` the model's product with a dequantized
    Q4 weight (``dequantized_on_cpu``, found by ``w4a8_groups``) is the
    W4A8 kernel's plain version, activations quantized per (row, group),
    within 1e-5; another weight, or more rows than KERNEL_MAX_M, keeps the
    exact product, and the product is restored on exit."""
    from trackiellm_tpu_torch.models import llm
    from trackiellm_tpu_torch.ops import quant
    cs = _load()
    rng = np.random.default_rng(0)
    w = torch.from_numpy(rng.standard_normal((128, 48)).astype(np.float32))
    qw = quant.quantize_q4(w, 32)
    tree = {"w": qw, "other": w.clone()}
    cpu = cs.dequantized_on_cpu(quant, tree)
    groups = cs.w4a8_groups(quant, tree, cpu)
    assert list(groups.values()) == [32]
    x = torch.from_numpy(rng.standard_normal((8, 128)).astype(np.float32))
    big = torch.from_numpy(rng.standard_normal(
        (quant.KERNEL_MAX_M + 1, 128)).astype(np.float32))
    want = quant.q4_matmul_w4a8_ref(x, qw.values, qw.scales)
    mm = llm._mm_f32
    with cs.w4a8_activations(llm, quant, groups):
        got = llm._mm_f32(x, cpu["w"])
        assert torch.equal(llm._mm_f32(x, cpu["other"]), mm(x, w))
        assert torch.equal(llm._mm_f32(big, cpu["w"]), mm(big, cpu["w"]))
    assert llm._mm_f32 is mm

    def rel(a, b):
        return ((a - b).norm() / b.norm()).item()
    assert rel(got, want) < 1e-5
    assert rel(mm(x, cpu["w"]), want) > 100 * rel(got, want)


def _tiny_moe_cfg(cs):
    """Phase 17's configs at widths the CPU runs in seconds, knob sets and
    expert counts cut as tests/test_torch_moe_models.py cuts them."""
    def moe_cfg(llm, name, layers=0, max_seq=0):
        c = getattr(llm.LLMConfig, name)()
        e = min(c.n_experts, 8)
        return c._replace(
            vocab_size=320, dim=64, n_layers=2, n_heads=4,
            n_kv_heads=4 // min(c.n_heads // c.n_kv_heads, 4), head_dim=16,
            hidden_dim=64, max_seq=max_seq or 512,
            sliding_window=24 if c.sliding_window < c.max_seq else 512,
            n_experts=e, n_experts_used=min(c.n_experts_used, e // 2),
            moe_shared_hidden=64 if c.moe_shared_hidden else 0,
            nope_pattern=2 if c.nope_pattern else 0,
            attn_chunk=16 if c.attn_chunk else 0)
    return moe_cfg


def test_phase17_on_the_cpu(monkeypatch, capsys):
    """Phase 17's control flow on the CPU at tiny widths (the profile child
    faked, the routes' check recorded): (a) generates at lookahead 4 and 1
    with equal ids and serves its bursts (dense per step and chunked with
    equal ids, the int8 pool chunked); (b) answers the cortex prompt; (c)
    sweeps every MoE preset card against CPU (the same CPU here, its second
    side on the routed formulation: within WIDTH_TOL or with explained
    flips) and runs the tiny Llama-4 across its chunks; (d) converts the
    seven GGUFs on the CPU and answers with equal ids."""
    from trackiellm_tpu_torch import __main__ as cli
    from trackiellm_tpu_torch.llm import paging, runner, server, tokenizer
    from trackiellm_tpu_torch.models import checkpoint, llm
    from trackiellm_tpu_torch.ops import quant
    from trackiellm_tpu_torch.tools import measure_server
    cs = _load()
    cpu = torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda *a: None)
    monkeypatch.setattr(cli, "_device", lambda name, verb: cpu)
    monkeypatch.setattr(cs, "moe_cfg", _tiny_moe_cfg(cs))
    monkeypatch.setattr(cs, "MOE_TOKENS", 5)
    monkeypatch.setattr(cs, "MOE_QWEN3_TOKENS", 4)
    monkeypatch.setattr(cs, "MOE_GGUF_TOKENS", 5)
    monkeypatch.setattr(cs, "MOE_POOL_TOKENS", 5)
    monkeypatch.setattr(cs, "FAMILY_GGUF_WIDTHS", (512, 2, 4, 2, 512, 320))
    routes = []
    monkeypatch.setattr(cs, "expect_routes", lambda launches, ran, idle,
                        phase: routes.append(phase))
    out = cs.phase_moe(cpu, llm, runner, tokenizer, server, paging,
                       measure_server, checkpoint, quant, cli,
                       cs.launch_counters(),
                       lambda: {"gpt_oss_20b": {"decode": {"wall_ms": 1.0}}})
    assert set(out["sweep"]) == set(cs.MOE_SWEEP) | {
        f"{cs.MOE_SWEEP_Q8[0]} Q8"}
    for name, res in out["sweep"].items():   # the CPU side routes
        for bucket, err in res["rel_l2"].items():
            assert err < cs.WIDTH_TOL, name
            assert all(f["explained"] for f in res["flips"][bucket])
    assert out["chunks"]["rel_l2_max"] == 0.0
    assert set(out["gguf"]) == {f"{a} --bits 8" for a in cs.MOE_GGUF_ARCHES
                                } | {f"{cs.MOE_GGUF_BITS4} --bits 4"}
    serve = out["gpt_oss_20b"]["serve"]
    assert serve["dense_vs_int8"]["equal"] == sum(
        p is None for p in serve["dense_vs_int8"]["first_divergence"])
    pool = out["gpt_oss_20b"]["int8_pool"]
    assert set(pool) == set(cs.MOE_POOL)
    assert all(r["requests"] == r["equal"] == cs.SERVE_SLOTS and r["ids"]
               for r in pool.values())
    assert routes[:5] == ["phase 17 gpt_oss_20b",
                          "phase 17 serve dense_chunk1",
                          "phase 17 serve dense_chunk8",
                          "phase 17 serve int8_chunk8", "phase 17 qwen3"]
    text = capsys.readouterr().out
    for tag in ("gpt_oss_20b: lookahead 4 == lookahead 1",
                "serve dense: chunk8 ids == per-step ids",
                "serve dense vs int8 pool: ids equal on",
                "on the int8 pool: card ids == cpu ids on 8/8",
                "card ids == cpu ids: True", "router sigmoid",
                "tiny llama4 chunk", "phase 17 took"):
        assert tag in text, tag


def test_phase18_configs_keep_the_published_widths():
    """Phase 18's configs: LLaVA-1.5-7B's text model (llava-hf/llava-1.5-7b-hf:
    dim 4096, 32 layers of 32 heads and 32 KV heads, hidden 11,008, vocab
    32,064) at full depth with CLIP ViT-L/14-336 (576 image rows, the -2
    tap) projecting to 4096; PaliGemma-3B's Gemma-2B (dim 2048, 18 layers,
    8 heads, 1 KV head at D = 256, hidden 16,384, vocab 257,216, GeGLU)
    and SigLIP-So400m/14 at 224 (256 rows, one linear to 2048); phase 3's
    multimodal cases at those shapes."""
    from trackiellm_tpu_torch.models import clip, llm
    cs = _load()
    cfgs = cs.vlm_configs(llm, clip)
    lcfg, lccfg = cfgs["llava"]
    assert (lcfg.dim, lcfg.n_layers, lcfg.n_heads, lcfg.n_kv_heads,
            lcfg.head_dim, lcfg.hidden_dim, lcfg.vocab_size) == (
        4096, 32, 32, 32, 128, 11008, 32064)
    assert lcfg.max_seq == cs.VLM_MAX_SEQ and cs.q4_group(lcfg) == 128
    assert lccfg == clip.CLIPVisionConfig(proj_dim=4096)
    assert lccfg.n_image_tokens == 576 and lccfg.n_run_layers() == 23
    gcfg, gccfg = cfgs["paligemma"]
    assert (gcfg.dim, gcfg.n_layers, gcfg.n_heads, gcfg.n_kv_heads,
            gcfg.head_dim, gcfg.hidden_dim, gcfg.vocab_size, gcfg.act) == (
        2048, 18, 8, 1, 256, 16384, 257216, "gelu")
    assert gccfg.n_image_tokens == 256 and gccfg.proj_dim == 2048
    assert (gccfg.dim, gccfg.n_layers, gccfg.hidden_dim) == (1152, 27, 4304)
    assert not llm._layer_window(gcfg)   # prefix-LM: plain attention
    shapes = {(k, n, g, ms, ks) for _, k, n, g, ms, ks in cs.VLM_MATMULS}
    assert (2048, 257216, 256, (1,), ("q4_matmul_w4a8",)) in shapes
    assert (16384, 2048, 256, (1, 512), ("q4_matmul_w4a8",)) in shapes
    assert (4096, 22016, 128, (1024, 2048), ("q4_matmul_f32a",)) in shapes
    assert (11008, 4096, 128, (1024, 2048), ("q4_matmul_f32a",)) in shapes
    assert cs.VLM_FLASH == (128, (32, 32), 1024)


def _tiny_vlm_configs(llm, clip):
    """Phase 18's configs at widths the CPU runs in seconds: the towers keep
    their image and patch sizes (576 and 256 image rows), so LLaVA's prompt
    still passes 512 rows."""
    def text(**kw):
        return llm.LLMConfig(vocab_size=512, dim=64, n_layers=2, n_heads=4,
                             n_kv_heads=2, head_dim=16, hidden_dim=128,
                             max_seq=2048, sliding_window=2048, **kw)
    tower = dict(dim=32, n_layers=3, n_heads=4, hidden_dim=64)
    return {"llava": (text(), clip.CLIPVisionConfig(proj_dim=64, **tower)),
            "paligemma": (text(act="gelu", norm_eps=1e-6),
                          clip.CLIPVisionConfig.siglip_so400m_224(64)
                          ._replace(**tower))}


def test_phase18_on_the_cpu(monkeypatch, capsys, tmp_path):
    """Phase 18's control flow on the CPU at tiny widths (the routes' check
    recorded): (a) generates from a frame at lookahead 4 and 1 with equal
    ids, reuses the prefix on the same frame and rolls back on another;
    (b) holds the towers, LLaVA's spliced prefill and PaliGemma's prefix-LM
    pass to the CPU (the same CPU here); (c) converts an mmproj beside a
    text GGUF with equal leaves and answers from a frame; (d) answers a
    cortex turn on the injected frame with no failure."""
    from trackiellm_tpu_torch import __main__ as cli
    from trackiellm_tpu_torch.llm import runner, tokenizer
    from trackiellm_tpu_torch.models import checkpoint, convert, llm
    from trackiellm_tpu_torch.ops import quant
    cs = _load()
    cpu = torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda *a: None)
    monkeypatch.setattr(cli, "_device", lambda name, verb: cpu)
    monkeypatch.setattr(cs, "vlm_configs", _tiny_vlm_configs)
    monkeypatch.setattr(cs, "VLM_TOKENS", 4)
    monkeypatch.setattr(cs, "VLM_GGUF_TOKENS", 3)
    routes = []
    monkeypatch.setattr(cs, "expect_routes", lambda launches, ran, idle,
                        phase: routes.append(phase))
    plain = []
    monkeypatch.setattr(cs, "expect_no_plain", lambda calls, phase:
                        plain.append((phase, bool(calls))))
    # Phase 11's tiny GGUF widths (K/2 divisible by the converter's 256).
    text_cfg = llm.LLMConfig(vocab_size=512, dim=512, n_layers=1, n_heads=4,
                             n_kv_heads=2, head_dim=128, hidden_dim=1024,
                             max_seq=2048, sliding_window=2048)
    gguf = str(tmp_path / "text.gguf")
    cs.write_gguf(gguf, *cs.mistral_gguf(text_cfg, cs.spm_spec(512),
                                         cs.SEED))
    out = cs.phase_vlm(cpu, llm, runner, tokenizer, quant, convert,
                       checkpoint, cli, cs.launch_counters(), gguf,
                       str(tmp_path))
    a = out["llava"]
    assert a["bucket"] == 1024 and a["image_rows"] == 576
    assert a["reuse_same_frame"] >= a["image_start"] + 576
    assert a["reuse_other_frame"] == a["image_start"]
    b = out["card_vs_cpu"]
    assert b["clip"]["features_rel_l2"] == 0.0
    assert b["llava_text"]["rel_l2"] == 0.0
    assert b["paligemma"]["prefill_rel_l2"] == 0.0
    assert b["paligemma"]["bidir_moved"] > 0.0
    assert out["mmproj"]["equal_leaves"] == out["mmproj"]["leaves"] > 0
    assert out["cortex"]["frame_is_the_card_tensor"]
    assert out["cortex"]["failures"] == {}
    assert set(out["part_seconds"]) == {"a", "b", "c", "d"}
    assert routes == ["phase 18 llava prefill", "phase 18 llava decode",
                      "phase 18", "phase 18 mmproj"]
    # On the CPU the plain matmul is the route: the check saw it run.
    assert plain == [("phase 18 llava", True), ("phase 18 mmproj", True)]
    assert quant.quantized_matmul_ref is not None
    text = capsys.readouterr().out
    for tag in ("llava-1.5-7b: lookahead 4 == lookahead 1",
                "clip tower", "siglip tower", "llava text",
                "paligemma text", "generate --image: exit 0",
                "cortex turn: reply spoken", "phase 18 took"):
        assert tag in text, tag


def test_main_prints_the_surfaces_line_before_the_vlm_line(monkeypatch,
                                                            capsys):
    """Phase 19 runs after phase 18 with phase 2's build seconds and the
    work directory; its line comes just before the vlm line, the phase
    seconds run 1 to 20, and the kernels line counts its launches (the
    precompile child's)."""
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
                        ("build_model", {"layers": {}}), ("profile_path", {}),
                        ("expect_routes", None), ("phase_entry", None),
                        ("phase_diagnostics", {})):
        monkeypatch.setattr(cs, name, lambda *a, v=value, **k: v)
    monkeypatch.setattr(cs, "drive", lambda *a, **k: {
        "quantize_activations": 1, "q4_matmul_w4a8": 1})
    for name, n in (("phase_slice10", 10), ("phase_gguf", 11),
                    ("phase_serve", 12), ("phase_app", 15),
                    ("phase_families", 16), ("phase_moe", 17),
                    ("phase_vlm", 18)):
        monkeypatch.setattr(cs, name, lambda *a, n=n, **k: {
            "launches": {}, "n": n})
    monkeypatch.setattr(cs, "phase_voice", lambda *a, **k: {"n": 13})
    monkeypatch.setattr(cs, "phase_vision", lambda *a, **k: {"n": 14})
    seen = []
    monkeypatch.setattr(cs, "phase_surfaces", lambda *a, **k: (
        seen.append((type(a[-2]), os.path.isdir(a[-1]))),
        {"launches": {"q4_matmul_f32a": 19}, "n": 19})[1])
    monkeypatch.setattr(cs, "kernels_line", lambda rows, launches: json.dumps(
        {"phase19": launches[19]}))
    monkeypatch.setattr(cs, "phase_perception", lambda *a, **k: {
        "launches": {}})
    monkeypatch.setattr(cs, "phase_mla_mamba", lambda *a, **k: {
        "launches": {}})
    monkeypatch.setattr(cs, "phase_qwen3next", lambda *a, **k: {
        "launches": {}})
    monkeypatch.setattr(cs, "phase_training", lambda *a, **k: {
        "launches": {}})
    assert cs.main() == 0
    assert seen == [(float, True)]
    lines = capsys.readouterr().out.strip().splitlines()
    timing = json.loads(lines[-17])
    assert set(timing["phase_seconds"]) == {str(n) for n in range(1, 24)}
    assert json.loads(lines[-12]) == {
        "surfaces": {"launches": {"q4_matmul_f32a": 19}, "n": 19},
        "card": "H100, 700.00 W"}
    assert json.loads(lines[-11])["vlm"]["n"] == 18
    assert json.loads(lines[-2]) == {"phase19": {"q4_matmul_f32a": 19}}


def _tiny_surfaces_vision(dev):
    """Phase 19's vision models at tiny widths on ``dev``."""
    from trackiellm_tpu_torch.models import depth, detector
    from trackiellm_tpu_torch.vision.pipeline import (VisionConfig,
                                                      VisionPipeline)
    dcfg, pcfg = detector.DetectorConfig.tiny(), depth.DepthConfig.tiny()
    dp = detector.init_detector(torch.Generator().manual_seed(1), dcfg)
    pp = depth.init_depth(torch.Generator().manual_seed(2), pcfg)
    fns = dict(detector_fn=lambda chw: detector.detector_forward(dp, dcfg,
                                                                 chw),
               depth_fn=lambda chw: depth.depth_forward(pp, pcfg, chw),
               config=VisionConfig(detector_input=dcfg.img_size,
                                   depth_input=pcfg.img_size))
    return fns, lambda: VisionPipeline(device=dev, **fns)


def test_phase19_on_the_cpu(monkeypatch, capsys, tmp_path):
    """Phase 19's in-process parts on the CPU at tiny widths (the routes'
    check recorded): (c) the ffi executor's packed vision result equals the
    direct call's through execute and execute_async; (d) the tk_* LLM turn
    gives LLMRunner.generate's ids, and the frame, decision and cortex
    calls run; (e) fails here, where the trace holds no W4A8 kernel."""
    from trackiellm_tpu_torch.llm import runner, tokenizer
    from trackiellm_tpu_torch.models import llm
    cs = _load()
    cpu = torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    # K/2 divisible by the default group 256, as phase 11's tiny GGUF.
    tiny = llm.LLMConfig(vocab_size=512, dim=512, n_layers=1, n_heads=4,
                         n_kv_heads=2, head_dim=128, hidden_dim=1024,
                         max_seq=512, sliding_window=512)
    monkeypatch.setattr(llm.LLMConfig, "mistral_7b", classmethod(
        lambda cls: tiny))
    routes = []
    monkeypatch.setattr(cs, "expect_routes", lambda launches, ran, idle,
                        phase: routes.append(phase))
    fns, pipeline = _tiny_surfaces_vision(cpu)
    ffi = cs.surfaces_ffi(cpu, pipeline)
    assert ffi["execute_equal"] and ffi["async_equal"]
    assert ffi["async_status"] == 0
    out, r = cs.surfaces_compat(cpu, llm, runner, tokenizer, fns,
                                cs.launch_counters())
    assert out["ids"] == out["generate_ids"] and out["ids"]
    assert out["tool_call"] and out["reply_is_text"]
    assert out["actions"] == [("describe", "failed")]
    assert out["cortex_state"] == "shutdown"
    assert routes == ["phase 19 compat"]
    with pytest.raises(AssertionError, match="phase 19 services"):
        cs.surfaces_services(cpu, r, cs.launch_counters(), str(tmp_path))
    text = capsys.readouterr().out
    for tag in ("ffi: native runtime", "compat: "):
        assert tag in text, tag


def test_phase19_precompile_child_fails_without_a_card():
    cs = _load()
    if torch.cuda.is_available():
        pytest.skip("a card is here")
    with pytest.raises(AssertionError, match="phase 19 precompile exit"):
        cs.surfaces_precompile()


def test_main_prints_the_perception_line_before_the_surfaces_line(
        monkeypatch, capsys):
    """Phase 20 runs with the profile child, before phase 21; its line
    comes just before the surfaces line, after phase 21's and the phase
    seconds (1 to 21), and the kernels line counts its launches (the app
    turn's)."""
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
                        ("build_model", {"layers": {}}), ("profile_path", {}),
                        ("expect_routes", None), ("phase_entry", None),
                        ("phase_diagnostics", {})):
        monkeypatch.setattr(cs, name, lambda *a, v=value, **k: v)
    monkeypatch.setattr(cs, "drive", lambda *a, **k: {
        "quantize_activations": 1, "q4_matmul_w4a8": 1})
    for name, n in (("phase_slice10", 10), ("phase_gguf", 11),
                    ("phase_serve", 12), ("phase_app", 15),
                    ("phase_families", 16), ("phase_moe", 17),
                    ("phase_vlm", 18), ("phase_surfaces", 19)):
        monkeypatch.setattr(cs, name, lambda *a, n=n, **k: {
            "launches": {}, "n": n})
    monkeypatch.setattr(cs, "phase_voice", lambda *a, **k: {"n": 13})
    monkeypatch.setattr(cs, "phase_vision", lambda *a, **k: {"n": 14})
    seen = []
    monkeypatch.setattr(cs, "phase_perception", lambda *a, **k: (
        seen.append(a[-1] is cs.perception_profile_child),
        {"launches": {"q4_matmul_w4a8": 20}, "n": 20})[1])
    monkeypatch.setattr(cs, "kernels_line", lambda rows, launches: json.dumps(
        {"phase20": launches[20]}))
    monkeypatch.setattr(cs, "phase_mla_mamba", lambda *a, **k: {
        "launches": {}})
    monkeypatch.setattr(cs, "phase_qwen3next", lambda *a, **k: {
        "launches": {}})
    monkeypatch.setattr(cs, "phase_training", lambda *a, **k: {
        "launches": {}})
    assert cs.main() == 0
    assert seen == [True]
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-18].startswith("chip_smoke wall: ")
    timing = json.loads(lines[-17])
    assert set(timing["phase_seconds"]) == {str(n) for n in range(1, 24)}
    assert json.loads(lines[-13]) == {
        "perception": {"launches": {"q4_matmul_w4a8": 20}, "n": 20},
        "card": "H100, 700.00 W"}
    assert json.loads(lines[-12])["surfaces"]["n"] == 19
    assert json.loads(lines[-2]) == {"phase20": {"q4_matmul_w4a8": 20}}


def test_main_exits_non_zero_when_phase20_fails(monkeypatch, capsys):
    """A failed part of phase 20 is an uncaught exception: no result line,
    so the run cannot exit 0."""
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
                        ("build_model", {"layers": {}}), ("profile_path", {}),
                        ("expect_routes", None), ("phase_entry", None),
                        ("phase_diagnostics", {}),
                        ("kernels_line", '{"kernels": []}')):
        monkeypatch.setattr(cs, name, lambda *a, v=value, **k: v)
    monkeypatch.setattr(cs, "drive", lambda *a, **k: {
        "quantize_activations": 1, "q4_matmul_w4a8": 1})
    for name in ("phase_slice10", "phase_gguf", "phase_serve", "phase_app",
                 "phase_families", "phase_moe", "phase_vlm",
                 "phase_surfaces"):
        monkeypatch.setattr(cs, name, lambda *a, **k: {"launches": {}})
    monkeypatch.setattr(cs, "phase_voice", lambda *a, **k: {})
    monkeypatch.setattr(cs, "phase_vision", lambda *a, **k: {})

    def failed(*a, **k):
        raise AssertionError("phase 20 (c): failures")
    monkeypatch.setattr(cs, "phase_perception", failed)
    monkeypatch.setattr(cs, "phase_mla_mamba", lambda *a, **k: {
        "launches": {}})
    monkeypatch.setattr(cs, "phase_qwen3next", lambda *a, **k: {
        "launches": {}})
    monkeypatch.setattr(cs, "phase_training", lambda *a, **k: {
        "launches": {}})
    with pytest.raises(AssertionError, match="phase 20"):
        cs.main()
    assert '"ok": true' not in capsys.readouterr().out


def _tiny_perception(dev):
    """Phase 20's models at tiny widths on ``dev`` (the vocabulary and the
    labels as the smoke writes them)."""
    from trackiellm_tpu_torch.llm.tokenizer import WordPieceTokenizer
    from trackiellm_tpu_torch.models import ast, embedder, trocr
    from trackiellm_tpu_torch.models import sound_classifier as sc
    cs = _load()

    def gen(k):
        return torch.Generator(device=dev).manual_seed(k)
    ecfg = embedder.EmbedderConfig.test_tiny()._replace(vocab_size=400)
    tcfg = trocr.TrOCRConfig.tiny()
    acfg = ast.ASTConfig.tiny()._replace(n_labels=527)
    scfg = sc.SoundClassifierConfig.tiny()
    return {"embedder": (embedder.init_embedder(gen(1), ecfg), ecfg),
            "trocr": (trocr.init_params(gen(2), tcfg), tcfg),
            "ast": (ast.init_params(gen(3), acfg), acfg),
            "sound": (sc.init_sound_classifier(gen(4), scfg), scfg),
            "tokenizer": WordPieceTokenizer(cs.perception_vocab(400)),
            "labels": [cs.AST_NAMED_LABELS.get(i, f"label {i}")
                       for i in range(527)]}


def _phase20_on_the_cpu(monkeypatch, cs):
    """``cs`` set to rehearse phase 20 on the CPU at tiny widths: the
    routes' check and the profile recorded, Mistral-7B's widths cut as
    phase 19's rehearsal cuts them, the windows shortened."""
    from trackiellm_tpu_torch.models import llm
    cpu = torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    tiny = llm.LLMConfig(vocab_size=512, dim=512, n_layers=1, n_heads=4,
                         n_kv_heads=2, head_dim=128, hidden_dim=1024,
                         max_seq=512, sliding_window=512)
    monkeypatch.setattr(llm.LLMConfig, "mistral_7b", classmethod(
        lambda cls: tiny))
    monkeypatch.setattr(cs, "perception_models", _tiny_perception)
    def stub_detector(chw):  # raw outputs on the frame's device: no box
        return (torch.zeros((8, 4), device=chw.device),
                torch.zeros((8, 80), device=chw.device))
    monkeypatch.setattr(cs, "surfaces_vision", lambda dev: (
        {"detector_fn": stub_detector}, None))
    monkeypatch.setattr(cs, "device_breakdown",
                        lambda fn: (fn(), 0.0, 0, {})[1:])
    monkeypatch.setattr(cs, "AST_WINDOW_S", 0.7)
    routes = []
    monkeypatch.setattr(cs, "expect_routes", lambda launches, ran, idle,
                        phase: routes.append((ran, idle, phase)))
    return cpu, routes


def test_phase20_on_the_cpu(monkeypatch, capsys):
    """Phase 20 on the CPU at tiny widths: (a) each model's card-against-CPU
    check runs (both sides on the CPU here), (b) the four calls are timed
    and profiled, (c) the TrackieApp turn retrieves the archived memory
    first, speaks the forced ALARM at CRITICAL and the reply at its
    priority, runs the OCR, absorbs no failure, and checks the routes W4A8,
    its quantization and flash, and none of Q8, the fused block, the
    streaming Q4 or the probes."""
    from trackiellm_tpu_torch.llm import runner
    from trackiellm_tpu_torch.models import llm
    cs = _load()
    cpu, routes = _phase20_on_the_cpu(monkeypatch, cs)
    out = cs.phase_perception(cpu, llm, runner, cs.launch_counters(),
                              lambda: cs.perception_profile(cpu))
    a = out["card_vs_cpu"]
    assert a["trocr"]["ids_equal"] and a["ast"]["forced_alarm"] == "alarm"
    assert set(out["timed"]) == {"embed", "ocr", "ast", "cnn"}
    assert set(out["profile"]) == {"embed", "ocr", "ast", "cnn"}
    app = out["app"]
    assert app["retrieved"][0] == cs.PERCEPTION_MEMORY
    assert 3 in app["spoken"] and app["ocr_calls"] and not app["failures"]
    assert routes == [(("q4_matmul_w4a8", "quantize_activations",
                        "flash_attention"),
                       ("q8_matmul", "fused_mlp_q4", *cs.DIAGNOSTIC),
                       "phase 20")]
    assert set(out["part_seconds"]) == {"a", "b", "c"}
    text = capsys.readouterr().out
    for tag in ("(a) card against CPU", "(b) full depth", "(c) TrackieApp",
                "phase 20 took"):
        assert tag in text, tag


@pytest.mark.parametrize("part", ["a", "b", "c"])
def test_phase20_fails_when_a_part_fails(monkeypatch, part):
    """Each part's check raises: (a) a card-against-CPU gap over its
    tolerance, (b) an OCR stage that failed, (c) an app turn with a
    failure absorbed."""
    from trackiellm_tpu_torch.app import TrackieApp
    from trackiellm_tpu_torch.llm import runner
    from trackiellm_tpu_torch.models import llm
    cs = _load()
    cpu, _ = _phase20_on_the_cpu(monkeypatch, cs)
    if part == "a":
        monkeypatch.setattr(cs, "PERCEPTION_REL", -1.0)
    elif part == "b":
        def broken(crops):
            raise RuntimeError("no card")
        monkeypatch.setattr(cs, "ocr_text", lambda ids: broken(ids))
    else:
        monkeypatch.setattr(cs, "perception_timed", lambda *a: {})
        monkeypatch.setattr(TrackieApp, "failures", lambda self: {
            "model calls": {"embed: RuntimeError()": 1}})
    with pytest.raises(AssertionError, match=f"phase 20 \\({part}\\)"):
        cs.phase_perception(cpu, llm, runner, cs.launch_counters(),
                            lambda: {})


def test_perception_profile_child_fails_without_a_card(monkeypatch):
    cs = _load()
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    monkeypatch.setattr(cs, "phase_training", lambda *a, **k: {
        "launches": {}})
    with pytest.raises(AssertionError, match="phase 20"):
        cs.perception_profile_child()


def test_phase20_keeps_the_published_widths(monkeypatch):
    """The four models' configurations as perception_models builds them
    (the inits recorded, nothing drawn): all-MiniLM-L6-v2, TrOCR-base,
    AST at AudioSet's 527 labels over 1,212 patches, the reference's CNN;
    MiniLM's vocabulary at 30,522 pieces with BERT's specials at their
    ids; the labels hold every ambient class's name."""
    from trackiellm_tpu_torch.models import ast, embedder, sound_classifier
    from trackiellm_tpu_torch.models import trocr
    cs = _load()
    seen = {}
    for mod, name in ((embedder, "init_embedder"), (trocr, "init_params"),
                      (ast, "init_params"),
                      (sound_classifier, "init_sound_classifier")):
        monkeypatch.setattr(mod, name, lambda gen, cfg, m=mod.__name__: (
            seen.__setitem__(m.rsplit(".", 1)[1], cfg), {})[1])
    models = cs.perception_models(torch.device("cpu"))
    assert tuple(seen["embedder"]) == (30522, 384, 6, 12, 1536, 512, 2,
                                       1e-12, "mean")
    t = seen["trocr"]
    assert (t.image_size, t.patch_size, t.enc_dim, t.enc_layers,
            t.dec_layers, t.d_model, t.vocab_size) == (
                384, 16, 768, 12, 12, 1024, 50265)
    a = seen["ast"]
    assert (a.n_frames, a.n_mels, a.n_patches, a.n_layers, a.dim,
            a.n_labels) == (1024, 128, 1212, 12, 768, 527)
    assert tuple(seen["sound_classifier"]) == (64, 96, 32, 7)
    tok = models["tokenizer"]
    assert tok.vocab_size == 30522
    assert (tok.pad_id, tok.unk_id, tok.cls_id, tok.sep_id) == (0, 100, 101,
                                                                 102)
    assert all(i != tok.unk_id for t in cs.perception_fragments(64)
               for i in tok.encode(t))
    labels = [x.lower() for x in models["labels"]]
    for _, fragments in ast.AMBIENT_MAP:
        assert any(f in name for f in fragments for name in labels)


def test_main_prints_the_mla_mamba_line_before_the_perception_line(
        monkeypatch, capsys):
    """Phase 21 runs last, in the smoke's work directory; its line comes
    just before the perception line, after the phase seconds (1 to 21),
    and the kernels line counts its launches."""
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
                        ("build_model", {"layers": {}}), ("profile_path", {}),
                        ("expect_routes", None), ("phase_entry", None),
                        ("phase_diagnostics", {})):
        monkeypatch.setattr(cs, name, lambda *a, v=value, **k: v)
    monkeypatch.setattr(cs, "drive", lambda *a, **k: {
        "quantize_activations": 1, "q4_matmul_w4a8": 1})
    for name, n in (("phase_slice10", 10), ("phase_gguf", 11),
                    ("phase_serve", 12), ("phase_app", 15),
                    ("phase_families", 16), ("phase_moe", 17),
                    ("phase_vlm", 18), ("phase_surfaces", 19),
                    ("phase_perception", 20)):
        monkeypatch.setattr(cs, name, lambda *a, n=n, **k: {
            "launches": {}, "n": n})
    monkeypatch.setattr(cs, "phase_voice", lambda *a, **k: {"n": 13})
    monkeypatch.setattr(cs, "phase_vision", lambda *a, **k: {"n": 14})
    seen = []
    monkeypatch.setattr(cs, "phase_mla_mamba", lambda dev, counters, work: (
        seen.append(os.path.isdir(work)),
        {"launches": {"flash_attention": 21}, "n": 21})[1])
    monkeypatch.setattr(cs, "phase_qwen3next", lambda *a, **k: {
        "launches": {}})
    monkeypatch.setattr(cs, "kernels_line", lambda rows, launches: json.dumps(
        {"phase21": launches[21]}))
    monkeypatch.setattr(cs, "phase_training", lambda *a, **k: {
        "launches": {}})
    assert cs.main() == 0
    assert seen == [True]
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-18].startswith("chip_smoke wall: ")
    timing = json.loads(lines[-17])
    assert set(timing["phase_seconds"]) == {str(n) for n in range(1, 24)}
    assert json.loads(lines[-14]) == {
        "mla_mamba": {"launches": {"flash_attention": 21}, "n": 21},
        "card": "H100, 700.00 W"}
    assert json.loads(lines[-13])["perception"]["n"] == 20
    assert json.loads(lines[-2]) == {"phase21": {"flash_attention": 21}}


def test_phase21_keeps_the_published_widths_and_the_d192_headline():
    """Phase 21's configs: DeepSeek-V2-Lite (dim 2048, 16 heads of MLA's
    128 + 64 / 128 head dims, latent 512, 64 experts top 6 of width 1408
    with 2816 shared, dense layer 0, vocab 102,400) cut in depth only
    (dense layer 0 kept, at least 3 MoE layers) and max_seq 1024;
    DeepSeek-V3 (dim 7168, 128 heads, q-LoRA 1536, 256 experts top 8 by
    sigmoid in 8 groups of which 4 by top-2 sum, vocab 129,280) at one dense
    and one MoE layer; Mamba-2.8B at its 64 layers; Mamba-Codestral-7B's
    widths (dim 4096, 128 heads of 64, d_state 128, 8 groups); group 64
    divides every DeepSeek K/2 but V2-Lite's dense w_down's (10,944 / 2),
    which takes 32 (``mla.group_for``). Phase 3 holds flash at D = 192 on
    MLA's shape as a headline case."""
    from trackiellm_tpu_torch.models import mamba, mamba2, mla
    cs = _load()
    c = cs.phase21_configs(mla, mamba, mamba2)
    v2 = c["v2_lite"]
    assert v2._replace(n_layers=27, max_seq=8192) == (
        mla.MLAConfig.deepseek_v2_lite())
    assert v2.first_k_dense == 1 and v2.n_layers - 1 >= 3
    assert v2.max_seq == 1024 and v2.qk_head_dim == 192
    v3 = c["v3"]
    assert v3._replace(n_layers=61, first_k_dense=3, max_seq=8192) == (
        mla.MLAConfig.deepseek_v3())
    assert (v3.n_layers, v3.first_k_dense) == (2, 1)
    assert c["mamba"] == mamba.MambaConfig.mamba_2_8b()
    assert c["mamba2"]._replace(n_layers=64) == mamba2.Mamba2Config()
    assert c["mamba2"].n_layers >= 4
    for k in (2048, 1408, 2816, 7168, 18432, 1536, 16384):
        assert mla.group_for(k, cs.MLA_GROUP, 4) == cs.MLA_GROUP, k
    assert mla.group_for(10944, cs.MLA_GROUP, 4) == 32
    assert "causal S=512 D=192 bfloat16" in cs.KERNELS["flash_attention"][2]
    assert cs.MLA_FLASH == (192, (16, 16), 512)
    assert c["knobs"].qk_head_dim == 192


def _phase21_on_the_cpu(monkeypatch, cs):
    """``cs`` set to rehearse phase 21 on the CPU at tiny widths (MLA's
    head dims in the knob sets and the CLI's GGUFs as the smoke has them):
    the routes' and launch counts' checks recorded."""
    from trackiellm_tpu_torch import __main__ as cli
    from trackiellm_tpu_torch.models import mamba, mamba2, mla
    cpu = torch.device("cpu")
    for name in ("synchronize", "empty_cache", "reset_peak_memory_stats"):
        monkeypatch.setattr(torch.cuda, name, lambda *a: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 0)
    monkeypatch.setattr(cli, "_device", lambda name, verb: cpu)
    monkeypatch.setattr(cs, "flash_attrs", lambda attention, d: {})
    tiny = mla.MLAConfig(vocab_size=320, dim=64, n_layers=4, n_heads=2,
                         hidden_dim=128, kv_lora_rank=32, qk_nope_head_dim=16,
                         qk_rope_head_dim=8, v_head_dim=16, n_experts=4,
                         n_experts_used=2, moe_hidden_dim=64,
                         moe_shared_hidden=64, first_k_dense=1,
                         max_seq=1024)
    real = cs.phase21_configs

    def configs(*mods):
        c = real(*mods)
        return {"v2_lite": tiny,
                "v3": tiny._replace(
                    n_layers=2, q_lora_rank=32, n_experts=8, max_seq=256,
                    moe_norm_topk=True, moe_routed_scale=2.5,
                    moe_n_groups=4, moe_topk_groups=2,
                    moe_score_func="sigmoid", moe_group_score="top2sum"),
                "knobs": c["knobs"],
                "mamba": mamba.MambaConfig.test()._replace(
                    vocab_size=320, dim=64, d_inner=128),
                "mamba2": mamba2.Mamba2Config.test()._replace(
                    vocab_size=320)}
    monkeypatch.setattr(cs, "phase21_configs", configs)
    monkeypatch.setattr(cs, "MLA_GROUP", 16)
    monkeypatch.setattr(cs, "MAMBA_GROUP", 32)
    monkeypatch.setattr(cs, "MLA_TOKENS", 6)
    monkeypatch.setattr(cs, "MAMBA_TOKENS", 6)
    monkeypatch.setattr(cs, "MLA_SERVE_TOKENS", 4)
    checks = []
    monkeypatch.setattr(cs, "expect_routes", lambda launches, ran, idle,
                        phase: checks.append(phase))
    monkeypatch.setattr(cs, "expect_launches", lambda got, want, what:
                        checks.append(what))
    return cpu, checks


def test_phase21_on_the_cpu(monkeypatch, capsys, tmp_path):
    """Phase 21's control flow on the CPU at tiny widths: (a) two turns
    behind LLMRunner(model=mla) and the served burst with the runner's ids;
    (b) V2-Lite's cut card against CPU with its router flips explained, the
    V2 and V3 knob sets through the converters, V3's two layers finite;
    (c) MambaRunner and the served burst; (d) MambaRunner on Mamba-2 and
    its f32 sweep; (e) both GGUFs through inspect, convert and generate."""
    cs = _load()
    cpu, checks = _phase21_on_the_cpu(monkeypatch, cs)
    out = cs.phase_mla_mamba(cpu, cs.launch_counters(), str(tmp_path))
    a = out["a"]
    assert a["tokens"] and a["turn2_tokens"]
    assert a["serve"]["tokens"] == [cs.MLA_SERVE_TOKENS] * 4
    v2 = out["b"]["v2_lite"]
    assert all(max(e) < cs.WIDTH_TOL for e in v2["rel_l2"].values())
    assert set(out["b"]["knobs"]) == {"v2", "v3"}
    assert out["b"]["knobs"]["v3"]["gate_bias"]
    assert out["b"]["knobs"]["v3"]["score_func"] == "sigmoid"
    assert all(k["rel_l2"] < cs.MLA_KNOB_TOL
               for k in out["b"]["knobs"].values())
    assert out["b"]["v3"]["finite"]
    assert out["c"]["tokens"] and out["c"]["serve"]["waves"]
    assert out["d"]["rel_l2"] < cs.MAMBA2_TOL and out["d"]["tokens"]
    assert {k: v["inspect"] for k, v in out["e"].items()} == {
        "deepseek2": "deepseek2", "mamba": "mamba"}
    assert set(out["part_seconds"]) == {"a", "b", "c", "d", "e"}
    assert checks[:2] == [
        "phase 21 (a): flash at D = 192 in a bucket-512 prefill",
        "phase 21 (a)"]
    assert "phase 21 (b) V3: flash at D = 192, 128 heads" in checks
    text = capsys.readouterr().out
    for tag in ("DeepSeek-V2-Lite depth cut", "served burst of 4",
                "router flips", "v3 knobs (sigmoid", "Mamba-2.8B",
                "d (Codestral widths", "e deepseek2: inspect",
                "phase 21 took"):
        assert tag in text, tag


def test_mla_profile_on_the_cpu(monkeypatch, capsys):
    """``chip_smoke.py --mla-profile``'s windows on the CPU at tiny widths
    (the profiler faked): V2-Lite's prefill and decode a token, Mamba's
    decode a token, each with wall, busy, idle share and launches."""
    cs = _load()
    cpu, _ = _phase21_on_the_cpu(monkeypatch, cs)
    monkeypatch.setattr(cs, "device_breakdown", lambda fn: (
        fn(), 0.5, 10, {"kernel": (0.5, 10)})[1:])
    out = cs.mla_profile(cpu)
    assert set(out) == {"v2_lite_layers", "v2_lite_prefill",
                        "v2_lite_decode", "mamba_decode"}
    for k in ("v2_lite_prefill", "v2_lite_decode", "mamba_decode"):
        assert out[k]["wall_ms"] > 0 and out[k]["top"]
    assert out["v2_lite_decode"]["launches"] == 10 / cs.MLA_PROFILE_TOKENS
    assert "profile Mamba-2.8B decode" in capsys.readouterr().out


def test_main_prints_the_qwen3next_line_before_the_mla_mamba_line(
        monkeypatch, capsys):
    """Phase 22 runs last, in the smoke's work directory; its line comes
    just before the mla_mamba line, after the phase seconds (1 to 22), and
    the kernels line counts its launches."""
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
                        ("build_model", {"layers": {}}), ("profile_path", {}),
                        ("expect_routes", None), ("phase_entry", None),
                        ("phase_diagnostics", {})):
        monkeypatch.setattr(cs, name, lambda *a, v=value, **k: v)
    monkeypatch.setattr(cs, "drive", lambda *a, **k: {
        "quantize_activations": 1, "q4_matmul_w4a8": 1})
    for name, n in (("phase_slice10", 10), ("phase_gguf", 11),
                    ("phase_serve", 12), ("phase_app", 15),
                    ("phase_families", 16), ("phase_moe", 17),
                    ("phase_vlm", 18), ("phase_surfaces", 19),
                    ("phase_perception", 20), ("phase_mla_mamba", 21)):
        monkeypatch.setattr(cs, name, lambda *a, n=n, **k: {
            "launches": {}, "n": n})
    monkeypatch.setattr(cs, "phase_voice", lambda *a, **k: {"n": 13})
    monkeypatch.setattr(cs, "phase_vision", lambda *a, **k: {"n": 14})
    seen = []
    monkeypatch.setattr(cs, "phase_qwen3next", lambda dev, counters, work: (
        seen.append(os.path.isdir(work)),
        {"launches": {"q4_matmul_w4a8": 22}, "n": 22})[1])
    monkeypatch.setattr(cs, "kernels_line", lambda rows, launches: json.dumps(
        {"phase22": launches[22]}))
    monkeypatch.setattr(cs, "phase_training", lambda *a, **k: {
        "launches": {}})
    assert cs.main() == 0
    assert seen == [True]
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-18].startswith("chip_smoke wall: ")
    timing = json.loads(lines[-17])
    assert set(timing["phase_seconds"]) == {str(n) for n in range(1, 24)}
    assert json.loads(lines[-15]) == {
        "qwen3next": {"launches": {"q4_matmul_w4a8": 22}, "n": 22},
        "card": "H100, 700.00 W"}
    assert json.loads(lines[-14])["mla_mamba"]["n"] == 21
    assert json.loads(lines[-2]) == {"phase22": {"q4_matmul_w4a8": 22}}


def test_phase22_keeps_the_published_widths():
    """Phase 22 (a)'s config is Qwen3-Next-80B-A3B's config.json (dim
    2048, 16/2 heads of 256, partial rotary 0.25, rope_theta 1e7, DeltaNet
    16/32 heads of 128, conv 4, 512 experts top 10 of 512, shared 512,
    vocab 151,936) cut in depth only, to one period of the 3:1 pattern;
    every Q4 K of it and of (c)'s and (d)'s tiny widths is a multiple of
    2 x 256; phase 3 holds W4A8 and Q8 at its new shapes."""
    from trackiellm_tpu_torch.models import qwen3next as q3n
    cs = _load()
    cfg = cs.q3n_config(q3n)
    full = q3n.Qwen3NextConfig.qwen3_next_80b_a3b()
    assert cfg._replace(n_layers=48, layer_types=full.layer_types,
                        max_seq=full.max_seq) == full
    assert cfg.layer_types == ("l", "l", "l", "f") and cfg.max_seq == 1024
    assert (full.dim, full.n_heads, full.n_kv_heads, full.head_dim,
            full.lin_k_heads, full.lin_v_heads, full.lin_dk, full.n_experts,
            full.n_experts_used, full.moe_hidden, full.shared_hidden,
            full.vocab_size, full.rope_theta) == (
                2048, 16, 2, 256, 16, 32, 128, 512, 10, 512, 512, 151936,
                1e7)
    for k in (cfg.dim, cfg.moe_hidden, cfg.n_heads * cfg.head_dim,
              cfg.lin_v_heads * cfg.lin_dv):
        assert k % (2 * cs.Q3N_GROUP) == 0, k
    for w in (cs.Q3N_TINY, cs.HF_WIDTHS):
        assert w["dim"] % 512 == 0 and w["heads"] * 128 % 512 == 0
    shapes = {name: (k, n) for name, k, n, g, ms, kernels in cs.Q3N_MATMULS}
    assert set(shapes.values()) == {(512, 2048), (2048, 8192),
                                    (2048, 151936)}
    assert all(set(kernels) == {"q4_matmul_w4a8", "q8_matmul"}
               for *_, kernels in cs.Q3N_MATMULS)
    assert len(cs.HF_FAMILIES) == 17


def _phase22_on_the_cpu(monkeypatch, cs):
    """``cs`` set to rehearse phase 22 on the CPU: (a) and (b) at tiny
    widths (group 16), (c) and (d) as the smoke has them."""
    from trackiellm_tpu_torch import __main__ as cli
    from trackiellm_tpu_torch.models import qwen3next as q3n
    cpu = torch.device("cpu")
    for name in ("synchronize", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a: None)
    monkeypatch.setattr(cli, "_device", lambda name, verb: cpu)
    tiny = q3n.Qwen3NextConfig(
        vocab_size=320, dim=64, n_layers=4, n_heads=4, n_kv_heads=2,
        head_dim=16, lin_k_heads=2, lin_v_heads=4, lin_dk=16, lin_dv=16,
        n_experts=4, n_experts_used=2, moe_hidden=32, shared_hidden=32,
        hidden_dim=32, max_seq=1024)
    monkeypatch.setattr(cs, "q3n_config", lambda mod, lt=cs.Q3N_LAYERS:
                        tiny._replace(n_layers=len(lt), layer_types=lt))
    monkeypatch.setattr(cs, "Q3N_GROUP", 16)
    checks = []
    monkeypatch.setattr(cs, "expect_routes", lambda launches, ran, idle,
                        phase: checks.append(phase))
    monkeypatch.setattr(cs, "expect_launches", lambda got, want, what:
                        checks.append(what))
    return cpu, checks


def test_phase22_on_the_cpu(monkeypatch, capsys, tmp_path):
    """Phase 22's control flow on the CPU: (a) two MambaRunner turns on the
    hybrid stack, (b) layers 0 and 3 card against CPU on the card's
    experts, (c) the HF and GGUF routes through the CLI, (d) the 17 other
    families converted twice to the same bytes and held card against CPU."""
    cs = _load()
    cpu, checks = _phase22_on_the_cpu(monkeypatch, cs)
    out = cs.phase_qwen3next(cpu, cs.launch_counters(), str(tmp_path))
    a = out["a"]
    assert len(a["turns"]) == 2 and all(t["tokens"] for t in a["turns"])
    assert a["w4a8_calls_a_forward"] > 4 * 2
    b = out["b"]
    assert b["layers"] == ["l", "f"] and len(b["rel_l2"]) == 3
    assert max(b["rel_l2"] + b["state_rel_l2"]) < 1e-5
    assert {k: v["inspect"] for k, v in out["c"].items()} == {
        "hf": None, "gguf": "qwen3next"}
    assert set(out["d"]) == set(cs.HF_FAMILIES)
    assert all(v["rel_l2"] < 1e-5 for v in out["d"].values())
    assert set(out["part_seconds"]) == {"a", "b", "c", "d"}
    assert checks[:3] == ["phase 22 (a)", "phase 22 (a): W4A8 over "
                          f"{checks[1].split('over ')[1]}",
                          "phase 22 (a): quantization"]
    text = capsys.readouterr().out
    for tag in ("Qwen3-Next-80B-A3B depth cut", "turn 2:", "b card vs cpu",
                "c gguf: inspect -> qwen3next", "d falcon-hf",
                "phase 22 took"):
        assert tag in text, tag


def test_qwen3next_profile_on_the_cpu(monkeypatch, capsys):
    """``chip_smoke.py --qwen3next-profile`` on the CPU at tiny widths (the
    profiler faked): the prefill window and a decode token's."""
    cs = _load()
    cpu, _ = _phase22_on_the_cpu(monkeypatch, cs)
    monkeypatch.setattr(cs, "device_breakdown", lambda fn: (
        fn(), 0.5, 10, {"kernel": (0.5, 10)})[1:])
    out = cs.qwen3next_profile(cpu)
    assert set(out) == {"layers", "w4a8_calls_a_forward", "prompt_tokens",
                        "prefill", "decode"}
    assert out["decode"]["launches"] == 10 / cs.Q3N_PROFILE_TOKENS
    assert "profile Qwen3-Next decode" in capsys.readouterr().out


def test_main_prints_the_training_line_before_the_qwen3next_line(
        monkeypatch, capsys):
    """Phase 23 runs last; its line comes just before the qwen3next line,
    after the phase seconds (1 to 23), and the kernels line counts its
    launches."""
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
                        ("build_model", {"layers": {}}), ("profile_path", {}),
                        ("expect_routes", None), ("phase_entry", None),
                        ("phase_diagnostics", {})):
        monkeypatch.setattr(cs, name, lambda *a, v=value, **k: v)
    monkeypatch.setattr(cs, "drive", lambda *a, **k: {
        "quantize_activations": 1, "q4_matmul_w4a8": 1})
    for name, n in (("phase_slice10", 10), ("phase_gguf", 11),
                    ("phase_serve", 12), ("phase_app", 15),
                    ("phase_families", 16), ("phase_moe", 17),
                    ("phase_vlm", 18), ("phase_surfaces", 19),
                    ("phase_perception", 20), ("phase_mla_mamba", 21),
                    ("phase_qwen3next", 22)):
        monkeypatch.setattr(cs, name, lambda *a, n=n, **k: {
            "launches": {}, "n": n})
    monkeypatch.setattr(cs, "phase_voice", lambda *a, **k: {"n": 13})
    monkeypatch.setattr(cs, "phase_vision", lambda *a, **k: {"n": 14})
    monkeypatch.setattr(cs, "phase_training", lambda dev, counters: {
        "launches": {"q4_matmul_w4a8": 23}, "n": 23})
    monkeypatch.setattr(cs, "kernels_line", lambda rows, launches: json.dumps(
        {"phase23": launches[23]}))
    assert cs.main() == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-18].startswith("chip_smoke wall: ")
    timing = json.loads(lines[-17])
    assert set(timing["phase_seconds"]) == {str(n) for n in range(1, 24)}
    assert json.loads(lines[-16]) == {
        "training": {"launches": {"q4_matmul_w4a8": 23}, "n": 23},
        "card": "H100, 700.00 W"}
    assert json.loads(lines[-15])["qwen3next"]["n"] == 22
    assert json.loads(lines[-2]) == {"phase23": {"q4_matmul_w4a8": 23}}


def test_phase23_keeps_the_published_widths():
    """Phase 23 (a) trains Mistral-7B at its published widths and all 32
    layers (M = 512 rows a step: W4A8's largest M); (b) cuts it in depth
    only; (c)'s small widths take group-free f32; (d) the bundled
    artifact's config."""
    from trackiellm_tpu_torch.audio import wake_word as ww
    from trackiellm_tpu_torch.models import llm
    from trackiellm_tpu_torch.ops import quant
    cs = _load()
    cfg = cs.serve_config(llm)
    assert cfg._replace(max_seq=32768, sliding_window=4096) == \
        llm.LLMConfig.mistral_7b()._replace(max_seq=32768)
    assert cfg.n_layers == 32 and cs.TRAIN_CHECK[0] == 2
    assert cs.TRAIN_BATCH * cs.TRAIN_SEQ == quant.KERNEL_MAX_M
    assert cs.TRAIN_SEQ <= cfg.max_seq
    params, cfg_file = ww.load_wake_word(ww.default_artifact_path(), "cpu")
    assert cfg_file._replace(sensitivity=0.5) == ww.WakeWordConfig()
    size = sum(len(t.encode()) + 1 for t in cs.train_texts())
    assert size // cs.TRAIN_SEQ >= cs.TRAIN_STEPS * cs.TRAIN_BATCH


def test_phase23_on_the_cpu(monkeypatch, capsys):
    """Phase 23's control flow on the CPU at tiny widths (dim 512, 2
    layers, group 256; the wake word on 4 pairs): (a) four LoRA steps whose
    losses fall and whose layer-0 gradients are non-zero, the backward
    products, (b) the three routes against the CPU (all the CPU here:
    equal), (c) both small configs, (d) the wake word."""
    from trackiellm_tpu_torch.models import llm
    cs = _load()
    cpu = torch.device("cpu")
    for name in ("synchronize", "empty_cache", "reset_peak_memory_stats"):
        monkeypatch.setattr(torch.cuda, name, lambda *a: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 0)
    tiny = llm.LLMConfig(vocab_size=512, dim=512, n_layers=2, n_heads=8,
                         n_kv_heads=4, head_dim=64, hidden_dim=1024,
                         max_seq=512, sliding_window=512)
    monkeypatch.setattr(cs, "serve_config", lambda mod: tiny)
    monkeypatch.setattr(cs, "time_ms", lambda fn, iters=10, warmup=2: (
        fn(), 0.0)[1])
    monkeypatch.setattr(cs, "TRAIN_SMALL", {**cs.TRAIN_SMALL, "dim": 128,
                                            "hidden_dim": 256})
    monkeypatch.setattr(cs, "TRAIN_WAKE_PAIRS", 4)
    monkeypatch.setattr(cs, "TRAIN_WAKE_FULL", 2)
    checks = []
    monkeypatch.setattr(cs, "expect_routes", lambda launches, ran, idle,
                        phase: checks.append(phase))
    monkeypatch.setattr(cs, "expect_launches", lambda got, want, what:
                        checks.append((what, want)))
    out = cs.phase_training(cpu, cs.launch_counters())
    a = out["a"]
    assert len(a["losses"]) == cs.TRAIN_STEPS
    assert a["losses"][-1] < a["losses"][0]
    assert min(a["layer0_grad_max"].values()) > 0
    assert set(a["backward_product"]) == {"wqkv", "wo", "w_gu", "w_down",
                                          "lm_head"}
    assert checks[:2] == ["phase 23 (a)", ("phase 23 (a): W4A8", 17)]
    b = out["b"]
    for tag in ("f32a", "w4a8", "q8"):
        assert b[tag]["max_grad_rel_l2"] <= 1e-6, tag
        assert len(b[tag]["grad_rel_l2"]) == 8
    assert all(out["c"][k]["max_rel"] == 0.0 for k in ("dense", "moe"))
    assert max(out["d"]["rel_l2"].values()) == 0.0
    assert set(out["part_seconds"]) == {"a", "b", "c", "d"}
    text = capsys.readouterr().out
    for tag in ("(a) Mistral-7B Q4 2 layers", "backward product w_gu",
                "(b) f32a:", "(b) q8:", "(c) moe:", "(d) wake word:",
                "phase 23 took"):
        assert tag in text, tag


def test_training_profile_on_the_cpu(monkeypatch, capsys):
    """``chip_smoke.py --training-profile`` on the CPU at tiny widths (the
    profiler faked): one LoRA step's window."""
    from trackiellm_tpu_torch.models import llm
    cs = _load()
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(cs, "serve_config", lambda mod: llm.LLMConfig(
        vocab_size=512, dim=512, n_layers=2, n_heads=8, n_kv_heads=4,
        head_dim=64, hidden_dim=1024, max_seq=512, sliding_window=512))
    monkeypatch.setattr(cs, "device_breakdown", lambda fn: (
        fn(), 0.5, 10, {"kernel": (0.5, 10)})[1:])
    out = cs.training_profile(torch.device("cpu"))
    assert set(out) == {"layers", "rows", "seq", "rank", "step"}
    assert out["step"]["launches"] == 10
    assert "profile LoRA step" in capsys.readouterr().out
