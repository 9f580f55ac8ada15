"""The port's tk_* compatibility surface: the JAX package's
tests/test_compat.py on ``trackiellm_tpu_torch.compat`` (the reference's
call sites work verbatim; the creators that allocate are given
``device="cpu"`` here), then the same tk_* sequences through both
packages' shims on the same inputs: decision-engine actions, free-space
sectors, a vision frame's objects (the vision path's tolerance) and 12
greedy ids (equal; f32 weights and caches, as tests/test_torch_runner.py).
"""

import dataclasses

import numpy as np
import pytest
import torch

from trackiellm_tpu import compat as jtk
from trackiellm_tpu_torch import compat as tk
from trackiellm_tpu_torch.utils.errors import ErrorCode

CPU = torch.device("cpu")


class TestCompatSurface:
    def test_cortex_lifecycle_and_injection(self):
        cortex = tk.tk_cortex_create()
        assert tk.tk_cortex_get_state(cortex) == "idle"
        tk.tk_cortex_run(cortex)
        tk.tk_cortex_inject_user_text(cortex, "olá")
        tk.tk_cortex_stop(cortex)
        assert tk.tk_cortex_get_state(cortex) == "shutdown"
        tk.tk_cortex_destroy(cortex)

    def test_reasoner_flow_reference_style(self):
        """The reference full-test shape through tk_* names."""
        r = tk.tk_contextual_reasoner_create()
        tk.tk_contextual_reasoner_update_ambient_sound(
            r, "alarme de incêndio", urgent=True)
        tk.tk_contextual_reasoner_add_conversation_turn(
            r, "user", "o que está acontecendo?")
        prompt = tk.tk_contextual_reasoner_generate_context_string(
            r, user_query="o que está acontecendo?")
        assert "URGENTE" in prompt
        assert tk.tk_contextual_reasoner_get_context_summary(
            r)["urgent_items"] == 1

    def test_decision_engine(self):
        d = tk.tk_decision_engine_create()
        resp = tk.tk_decision_engine_process_llm_response(
            d, '{"tool_call":{"name":"x","arguments":{}}}')
        assert resp.is_tool_call
        done = tk.tk_decision_engine_process_actions(d)
        assert done[0].state.value == "failed"  # unknown tool

    def test_vision_pipeline_and_result_destroy(self):
        def stub(chw):
            return torch.zeros((4, 4)), torch.zeros((4, 80))

        p = tk.tk_vision_pipeline_create(detector_fn=stub, device=CPU)
        res = tk.tk_vision_pipeline_process_frame(
            p, np.zeros((64, 64, 3), np.uint8))
        tk.tk_vision_result_destroy(res)  # no-op, must not raise
        tk.tk_vision_pipeline_update_thresholds(p, confidence=0.9)
        assert p.config.confidence_threshold == 0.9

    def test_audio_pipeline(self):
        heard = []
        p = tk.tk_audio_pipeline_create(
            tts_fn=lambda t: np.zeros(16, np.float32),
            on_tts_audio=lambda w, pr: heard.append(pr))
        tk.tk_audio_pipeline_process_chunk(p, np.zeros(1600, np.float32))
        tk.tk_audio_pipeline_say(p, "oi", priority=2)
        assert p.wait_idle(3.0)
        tk.tk_audio_pipeline_destroy(p)
        assert heard == [2]

    def test_sensors_and_navigation(self):
        f = tk.tk_sensors_fusion_create()
        f.ingest_imu([0, 0, 0], [0, 0, 9.81])
        state = tk.tk_sensors_fusion_get_world_state(f)
        assert state.orientation_wxyz is not None

        from tests.test_navigation import _synthetic_depth

        e = tk.tk_navigation_engine_create(device=CPU)
        grid = tk.tk_navigation_engine_update(e, _synthetic_depth())
        sectors = tk.tk_free_space_detector_analyze(grid)
        assert len(sectors) == 7

    def test_tk_call_error_convention(self):
        code, result = tk.tk_call(tk.tk_config_load, "/nonexistent.conf")
        assert code == int(ErrorCode.FILE_NOT_FOUND)
        assert result is None
        code, cfg = tk.tk_call(tk.tk_cortex_create)
        assert code == int(ErrorCode.SUCCESS)

    def test_model_loader_names(self, tmp_path):
        import numpy as np

        p = str(tmp_path / "m.npz")
        np.savez(p, w=np.zeros(4))
        assert tk.tk_model_loader_validate(p)
        m = tk.tk_model_loader_load_model(p)
        assert "w" in m.tensors


# --- the same tk_* sequences through both packages ------------------------------

def _actions(mod):
    d = mod.tk_decision_engine_create()
    d.register_tool("describe", lambda a: f"scene {a.get('detail', 0)}")
    d.register_tool("fail", lambda a: 1 / 0)
    out = []
    for raw in ('{"tool_call":{"name":"describe","arguments":{"detail":2}}}',
                'texto falado', 'antes {"tool_call":{"name":"fail"}} depois',
                '{"tool_call":{"name":"nope","arguments":[]}}'):
        r = mod.tk_decision_engine_process_llm_response(d, raw)
        out.append((r.text, r.tool_name, r.tool_arguments))
    done = mod.tk_decision_engine_process_actions(d, max_actions=2)
    done += mod.tk_decision_engine_process_actions(d)
    out += [(a.name, a.state.value, str(a.result)) for a in done]
    mod.tk_decision_engine_process_llm_response(
        d, '{"tool_call":{"name":"describe"}}')
    out.append(mod.tk_decision_engine_emergency_stop(d))
    return out


def test_decision_engine_actions_match_jax():
    assert _actions(tk) == _actions(jtk)


def _grid(source):
    """The JAX engine's grid of a synthetic floor with a block ahead, or a
    hand-made grid, open or with a block ahead (tests/test_navigation.py)."""
    from tests.test_navigation import TestFreeSpace, _synthetic_depth
    if source == "engine":
        return jtk.tk_navigation_engine_update(
            jtk.tk_navigation_engine_create(),
            _synthetic_depth(obstacle={"z": 1.5}))
    return TestFreeSpace()._grid(block_center=source == "blocked")


@pytest.mark.parametrize("source", ["engine", "open", "blocked"])
def test_free_space_sectors_match_jax(source):
    grid = _grid(source)
    for kw in ({}, {"cell_m": 0.5, "num_sectors": 5}):
        want = jtk.tk_free_space_detector_analyze(grid, **kw)
        got = tk.tk_free_space_detector_analyze(grid, **kw)
        assert ([dataclasses.astuple(x) for x in got]
                == [dataclasses.astuple(x) for x in want])
        if source != "engine":
            assert any(x.is_clear for x in want)


def test_vision_frame_objects_match_jax():
    """tk_vision_pipeline_create and _process_frame on the tiny detector
    and MiDaS, the same weights and frame: objects as the JAX shim's within
    the vision path's tolerance."""
    from tests.test_torch_ffi_embed import _frame, _tiny_pipelines
    (port,), ref = _tiny_pipelines(1)
    frame = _frame()
    jp = jtk.tk_vision_pipeline_create(detector_fn=ref.detector_fn,
                                       depth_fn=ref.depth_fn,
                                       config=ref.config)
    tp = tk.tk_vision_pipeline_create(detector_fn=port.detector_fn,
                                      depth_fn=port.depth_fn,
                                      config=port.config, device=CPU)
    want = jtk.tk_vision_pipeline_process_frame(jp, frame)
    got = tk.tk_vision_pipeline_process_frame(tp, frame)
    assert want.objects and len(got.objects) == len(want.objects)
    assert int(got.valid_analyses) == int(want.valid_analyses)
    for a, b in zip(got.objects, want.objects):
        assert (a.class_id, a.label, a.attributes) == (
            b.class_id, b.label, b.attributes)
        assert a.confidence == pytest.approx(b.confidence, abs=1e-5)
        np.testing.assert_allclose(a.box, b.box, atol=1e-3)
        assert a.distance_m == pytest.approx(b.distance_m, abs=1e-4)


def test_llm_runner_turn_matches_jax():
    """tk_llm_runner_create, _prepare_generation and 12 calls of
    _generate_next_token: the same ids as the JAX shim's."""
    import jax.numpy as jnp

    from tests.test_torch_runner import _params
    from trackiellm_tpu.llm import runner as jrunner
    from trackiellm_tpu.llm.tokenizer import ByteTokenizer as JByteTokenizer
    from trackiellm_tpu_torch.llm.runner import GenerationConfig
    from trackiellm_tpu_torch.llm.tokenizer import ByteTokenizer
    from trackiellm_tpu_torch.models import llm as tllm
    cfg, jp, tp = _params()
    gen = dict(temperature=0.0, max_tokens=12, speculative=False)
    jr = jtk.tk_llm_runner_create(
        jp, cfg, tokenizer=JByteTokenizer(cfg.vocab_size),
        gen_config=jrunner.GenerationConfig(**gen), cache_dtype=jnp.float32)
    tr = tk.tk_llm_runner_create(
        tp, tllm.LLMConfig(**cfg._asdict()),
        tokenizer=ByteTokenizer(cfg.vocab_size),
        gen_config=GenerationConfig(**gen), cache_dtype=torch.float32)
    ids = []
    for mod, r in ((jtk, jr), (tk, tr)):
        mod.tk_llm_runner_prepare_generation(r, "Navigate to the door")
        pieces = [mod.tk_llm_runner_generate_next_token(r)
                  for _ in range(12)]
        assert all(p is not None for p in pieces)
        ids.append(list(r._generated_ids))
        mod.tk_llm_runner_reset(r)
    assert len(ids[0]) == 12 and ids[1] == ids[0]
