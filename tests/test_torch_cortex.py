"""The port's cortex and the host modules around it against the JAX
package's, on the CPU.

The cortex (``cortex/``), the voice commands and feedback
(``interaction/``), sensor fusion (``sensors/``), the config and path
utilities, the obstacle tracker and the QR detector are copies of the JAX
package's modules (tests/test_torch_app.py holds their sources to the
reference's); here each group also behaves as the reference does on the
same inputs. The centrepiece drives the JAX ``Cortex`` and the port's on
the same tiny LLM (Q4 at group 64, seed 3, carried with
``params_from_jax``; greedy), the same vision result and the same sensor
state, with the clock frozen: the same prompt, tool definitions, primes
and spoken lines (text and priority).
"""

import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from trackiellm_tpu import cortex as jcortex
from trackiellm_tpu.interaction import commands as jcommands
from trackiellm_tpu.llm import runner as jrunner
from trackiellm_tpu.llm.tokenizer import ByteTokenizer as JByteTokenizer
from trackiellm_tpu.models import llm as jllm
from trackiellm_tpu.navigation import obstacle_tracker as jtracker
from trackiellm_tpu.navigation.path_planner import CellClass as JCellClass
from trackiellm_tpu.sensors import fusion as jfusion
from trackiellm_tpu.utils import config as jconfig
from trackiellm_tpu.vision import pipeline as jvision
from trackiellm_tpu.vision import qr as jqr
from trackiellm_tpu.vision import qr_decode as jqr_decode
from trackiellm_tpu_torch import cortex as tcortex
from trackiellm_tpu_torch.interaction import commands as tcommands
from trackiellm_tpu_torch.llm import runner as trunner
from trackiellm_tpu_torch.llm.tokenizer import ByteTokenizer
from trackiellm_tpu_torch.models import llm as tllm
from trackiellm_tpu_torch.models.bridge import params_from_jax
from trackiellm_tpu_torch.navigation import obstacle_tracker as ttracker
from trackiellm_tpu_torch.navigation.path_planner import CellClass
from trackiellm_tpu_torch.sensors import fusion as tfusion
from trackiellm_tpu_torch.utils import config as tconfig
from trackiellm_tpu_torch.vision import pipeline as tvision
from trackiellm_tpu_torch.vision import qr as tqr
from trackiellm_tpu_torch.vision import qr_decode as tqr_decode

SIDES = {"jax": (jcortex, jvision, jfusion), "torch": (tcortex, tvision,
                                                       tfusion)}
FROZEN_TIME = 1_700_000_000.0
MAX_SEQ = 1024
_PARAMS = {}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def frozen(monkeypatch):
    """time.time and time.monotonic stand still (the reasoner's context
    ages and the decision engine's cooldowns read them)."""
    import time
    monkeypatch.setattr(time, "time", lambda: FROZEN_TIME)
    monkeypatch.setattr(time, "monotonic", lambda: 1000.0)


def _params():
    if not _PARAMS:
        cfg = jllm.LLMConfig.tiny()._replace(max_seq=MAX_SEQ,
                                             sliding_window=MAX_SEQ)
        p = jllm.quantize_params(
            jllm.init_params(jax.random.PRNGKey(3), cfg, dtype=jnp.float32),
            bits=4, group=64)
        _PARAMS["p"] = (cfg, p, params_from_jax(p))
    return _PARAMS["p"]


def _runners():
    """A JAX runner and a port runner on the same weights, greedy."""
    cfg, jp, tp = _params()
    kw = dict(max_tokens=24, temperature=0.0, speculative=False)
    jr = jrunner.LLMRunner(jp, cfg, JByteTokenizer(cfg.vocab_size),
                           jrunner.GenerationConfig(**kw),
                           cache_dtype=jnp.float32)
    tr = trunner.LLMRunner(tp, tllm.LLMConfig(**cfg._asdict()),
                           ByteTokenizer(cfg.vocab_size),
                           trunner.GenerationConfig(**kw),
                           cache_dtype=torch.float32)
    return {"jax": jr, "torch": tr}


class _Audio:
    """Records every line the cortex speaks."""

    def __init__(self):
        self.said = []

    def say(self, text, priority):
        self.said.append((text, int(priority)))

    def clear_speech_queue(self):
        pass

    def process_chunk(self, chunk):
        pass


def _recording(runner, log):
    """Record the prompts, tools and primes a runner is given."""
    generate, prime = runner.generate, runner.prime

    def gen(prompt, tools=(), force_tool_call=False, on_token=None,
            should_stop=None):
        log.append(("generate", prompt, [dataclasses.asdict(t)
                                         for t in tools]))
        return generate(prompt, tools=tools, force_tool_call=force_tool_call,
                        on_token=on_token, should_stop=should_stop)

    def pr(prefix):
        log.append(("prime", prefix))
        return prime(prefix)
    runner.generate, runner.prime = gen, pr


def _cortexes():
    """Each side's cortex on its runner, with one vision result and one
    IMU stream injected alike."""
    out = {}
    for side, runner in _runners().items():
        cortex_mod, vision_mod, fusion_mod = SIDES[side]

        class Vision:
            def process_frame(self, frame, orientation_wxyz=None):
                D = vision_mod.DetectedObject
                objs = [D(0, "person", 0.9, [300.0, 100.0, 380.0, 470.0],
                          distance_m=2.1, attributes=["color:red"]),
                        D(56, "chair", 0.7, [40.0, 250.0, 160.0, 470.0],
                          distance_m=1.2),
                        D(11, "stop sign", 0.8, [500.0, 40.0, 600.0, 140.0],
                          distance_m=4.0, text="PARE")]
                return vision_mod.VisionResult(
                    frame_id=1, objects=objs, depth_map_m=None,
                    scene_graph=None,
                    valid_analyses=(vision_mod.AnalysisFlags.DETECTION
                                    | vision_mod.AnalysisFlags.OCR),
                    timings_ms={}, barcodes=["qr_code@1:SALA 301"],
                    navigation_cues=["degrau à frente a 1.5 m"],
                    full_text="SAIDA")
        sensors = fusion_mod.SensorFusion()
        rng = np.random.default_rng(0)
        for _ in range(40):
            sensors.ingest_imu(rng.normal(0, 0.05, 3).tolist(),
                               (np.asarray([0, 0, 9.81])
                                + rng.normal(0, 2.0, 3)).tolist(), dt=0.05)
        log, audio = [], _Audio()
        _recording(runner, log)
        c = cortex_mod.Cortex(vision_pipeline=Vision(), audio_pipeline=audio,
                              sensor_fusion=sensors, llm_runner=runner)
        c.reasoner.update_motion_context(
            sensors.get_world_state().motion_state.value)
        c.inject_video_frame(object())
        c._process_vision()
        out[side] = (c, log, audio)
    return out


def _same(out):
    (cj, lj, aj), (ct, lt, at) = out["jax"], out["torch"]
    assert lt == lj
    assert at.said == aj.said
    assert ct.reasoner.generate_context_string() == \
        cj.reasoner.generate_context_string()
    return lj, aj.said


def test_user_speech_gives_the_reference_prompt_and_speech(frozen):
    out = _cortexes()
    for c, _, _ in out.values():
        c._process_user_speech("o que você vê?")
        c._process_timer_tick()  # the feedback queue's alerts
    log, said = _same(out)
    (kind, prompt, tools), = log
    assert kind == "generate" and prompt.endswith("o que você vê? [/INST]")
    assert "person" in prompt and "PARE" in prompt
    assert [t["name"] for t in tools] == [
        "describe_scene", "save_memory", "set_fact", "recall_memory",
        "find_clear_path"]
    # the reply (NORMAL) and the safety alerts (CRITICAL)
    assert {p for _, p in said} == {1, 3}


def test_partial_then_final_transcript_primes_alike(frozen):
    out = _cortexes()
    for c, _, _ in out.values():
        c._process_partial_transcript("o que voce")
        c._process_user_speech("o que voce ve agora?")
        assert c.stats["partial_primes"] == 1
    log, _ = _same(out)
    assert [e[0] for e in log] == ["prime", "generate"]
    assert log[1][1].startswith(log[0][1])


def test_command_parser_copy_parses_alike():
    utterances = [
        "pare tudo agora", "silêncio por favor", "repete por favor",
        "onde está a minha chave?", "where is the door", "leia isso",
        "qual o caminho livre?", "lembre este lugar", "guia-me até a porta",
        "oi tudo bem", "", "PARE!", "find my phone", "read the sign",
        "por onde eu vou", "salvar local casa"]
    jp, tp = jcommands.CommandParser(), tcommands.CommandParser()
    for u in utterances:
        a, b = jp.parse(u), tp.parse(u)
        assert (a is None) == (b is None), u
        if a is not None:
            assert dataclasses.asdict(b) == dataclasses.asdict(a), u


def test_sensor_fusion_copy_fuses_alike():
    rng = np.random.default_rng(1)
    sides = [jfusion.SensorFusion(), tfusion.SensorFusion()]
    for step in range(200):
        gyro = rng.normal(0, 0.3 if step > 100 else 0.01, 3).tolist()
        accel = (np.asarray([0.0, 0.0, 9.81])
                 + rng.normal(0, 3.0 if step > 100 else 0.05, 3)).tolist()
        for s in sides:
            s.ingest_imu(gyro, accel, dt=0.05)
        if step % 50 == 49:
            a, b = (s.get_world_state() for s in sides)
            assert b.orientation_wxyz == a.orientation_wxyz
            assert b.motion_state.value == a.motion_state.value
            assert b.accel_magnitude == a.accel_magnitude
            assert sides[1].euler_deg() == sides[0].euler_deg()


def test_qr_copy_detects_and_decodes_alike():
    img = jqr_decode.render_qr(jqr_decode.encode_qr("SALA 301", version=1,
                                                    level=1, mask=3),
                               module_px=6)
    assert np.array_equal(img, tqr_decode.render_qr(tqr_decode.encode_qr(
        "SALA 301", version=1, level=1, mask=3), module_px=6))
    canvas = np.full((240, 320), 200, np.uint8)
    canvas[30:30 + img.shape[0], 60:60 + img.shape[1]] = img
    a, b = jqr.detect_qr(canvas), tqr.detect_qr(canvas)
    assert len(a) == 1 and b == a
    assert tqr.QRFinderDetector()(canvas) == jqr.QRFinderDetector()(canvas)
    assert tqr.QRFinderDetector()(canvas)[0].endswith(":SALA 301")


def test_obstacle_tracker_copy_tracks_alike():
    rng = np.random.default_rng(2)
    jt, tt = jtracker.ObstacleTracker(), ttracker.ObstacleTracker()
    assert int(CellClass.OBSTACLE) == int(JCellClass.OBSTACLE)
    for _ in range(12):
        grid = np.where(rng.random((16, 12)) < 0.12,
                        int(CellClass.OBSTACLE), int(CellClass.TRAVERSABLE))
        ja = jtracker.obstacles_from_grid(grid.astype(np.int32))
        ta = ttracker.obstacles_from_grid(grid.astype(np.int32))
        assert ta == ja
        a, b = jt.update(ja), tt.update(ta)
        assert [dataclasses.asdict(x) for x in b] == [
            dataclasses.asdict(x) for x in a]


def test_config_copy_parses_alike(tmp_path):
    path = tmp_path / "trackie.conf"
    path.write_text("# comment\n; another\n\naudio.chunk_ms = 50\n"
                    "cortex.loop_hz = 12.5  # inline\n"
                    'memory.path = "/tmp/x # y"\nvision.qr_detection = no\n'
                    "audio.wake_word=true\n", encoding="utf-8")
    a, b = jconfig.Config.load(path), tconfig.Config.load(path)
    assert list(b.items()) == list(a.items())
    for key, getter in (("audio.chunk_ms", "get_int"),
                        ("cortex.loop_hz", "get_float"),
                        ("memory.path", "get_string"),
                        ("vision.qr_detection", "get_bool"),
                        ("audio.wake_word", "get_bool")):
        assert getattr(b, getter)(key) == getattr(a, getter)(key)
    bad = tmp_path / "bad.conf"
    bad.write_text("no equals sign here\n", encoding="utf-8")
    for mod in (jconfig, tconfig):
        with pytest.raises(Exception, match="expected 'key = value'"):
            mod.Config.load(bad)
