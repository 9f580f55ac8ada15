"""tk_* compatibility surface: the reference's C API names, mapped.

Parity target: the public ``tk_*`` entry points a reference user calls
(SURVEY.md section 1's per-layer interfaces). This module exists so
migration is mechanical — each function forwards to the idiomatic
object API and returns the same handle/result shapes. New code should
use the object APIs directly.

Error convention: the reference returns ``tk_error_code_t``; here
functions RAISE :class:`TrackieError` (carrying the same code values) —
wrap calls with :func:`tk_call` to get (code, result) tuples instead.

Port of ``trackiellm_tpu/compat.py``: every name forwards to the port's
class with the reference's arguments. The creators that allocate on a
device (``tk_vision_pipeline_create``, ``tk_navigation_engine_create``)
take the port's ``device=`` and default to the card, as the classes do;
``tk_llm_runner_create`` runs where its params lie unless ``device=``
says otherwise.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

from trackiellm_tpu_torch.utils.errors import ErrorCode, TrackieError


def tk_call(fn, *args, **kwargs) -> Tuple[int, Any]:
    """C-style invocation: returns (error_code, result); never raises."""
    try:
        return int(ErrorCode.SUCCESS), fn(*args, **kwargs)
    except TrackieError as e:
        return int(e.code), None
    except Exception:
        return int(ErrorCode.INTERNAL), None


# ---- cortex (tk_cortex_main.h) -------------------------------------------

def tk_cortex_create(**kwargs):
    from trackiellm_tpu_torch.cortex.main import Cortex

    return Cortex(**kwargs)


def tk_cortex_run(cortex, block: bool = False) -> None:
    cortex.run(block=block)


def tk_cortex_stop(cortex) -> None:
    cortex.stop()


def tk_cortex_destroy(cortex) -> None:
    if cortex.state.value not in ("shutdown", "uninitialized"):
        cortex.stop()


def tk_cortex_inject_video_frame(cortex, frame) -> None:
    cortex.inject_video_frame(frame)


def tk_cortex_inject_audio_frame(cortex, chunk) -> None:
    cortex.inject_audio_chunk(chunk)


def tk_cortex_inject_user_text(cortex, text: str) -> None:
    cortex.inject_user_text(text)


def tk_cortex_get_state(cortex) -> str:
    return cortex.state.value


def tk_cortex_emergency_stop(cortex) -> None:
    cortex.emergency_stop()


# ---- contextual reasoner (tk_contextual_reasoner.h) ------------------------

def tk_contextual_reasoner_create(**kwargs):
    from trackiellm_tpu_torch.cortex.reasoner import ContextualReasoner

    return ContextualReasoner(**kwargs)


def tk_contextual_reasoner_add_conversation_turn(r, role, text) -> None:
    r.add_conversation_turn(role, text)


def tk_contextual_reasoner_update_vision_context(r, objects,
                                                 scene="") -> None:
    r.update_vision_context(objects, scene)


def tk_contextual_reasoner_update_ambient_sound(r, sound,
                                                urgent=False) -> None:
    r.update_ambient_sound(sound, urgent=urgent)


def tk_contextual_reasoner_generate_context_string(r, user_query="",
                                                   token_budget=None) -> str:
    return r.generate_context_string(user_query, token_budget)


def tk_contextual_reasoner_get_context_summary(r) -> dict:
    return r.get_summary()


# ---- decision engine (tk_decision_engine.h) --------------------------------

def tk_decision_engine_create(**kwargs):
    from trackiellm_tpu_torch.cortex.decision import DecisionEngine

    return DecisionEngine(**kwargs)


def tk_decision_engine_process_llm_response(d, raw_text: str):
    return d.process_llm_response(raw_text)


def tk_decision_engine_process_actions(d, max_actions: int = 4):
    return d.process_actions(max_actions)


def tk_decision_engine_emergency_stop(d) -> int:
    return d.emergency_stop()


# ---- vision (tk_vision_pipeline.h) -----------------------------------------

def tk_vision_pipeline_create(**kwargs):
    from trackiellm_tpu_torch.vision.pipeline import VisionPipeline

    return VisionPipeline(**kwargs)


def tk_vision_pipeline_process_frame(p, frame, flags=None):
    from trackiellm_tpu_torch.vision.pipeline import AnalysisFlags

    return p.process_frame(frame, flags if flags is not None
                           else AnalysisFlags.ALL)


def tk_vision_pipeline_update_thresholds(p, confidence=None, iou=None,
                                         max_objects=None) -> None:
    p.update_thresholds(confidence, iou, max_objects)


def tk_vision_result_destroy(result) -> None:
    """No-op: results are garbage-collected (kept for call-site parity)."""


# ---- audio (tk_audio_pipeline.h) -------------------------------------------

def tk_audio_pipeline_create(**kwargs):
    from trackiellm_tpu_torch.audio.pipeline import AudioPipeline

    return AudioPipeline(**kwargs)


def tk_audio_pipeline_process_chunk(p, chunk) -> None:
    p.process_chunk(chunk)


def tk_audio_pipeline_say(p, text: str, priority: int = 1) -> None:
    p.say(text, priority)


def tk_audio_pipeline_destroy(p) -> None:
    p.close()


# ---- model runtime (tk_model_loader.h / tk_model_runner.h) -----------------

def tk_model_loader_load_model(path: str):
    from trackiellm_tpu_torch.models.loader import load_model

    return load_model(path)


def tk_model_loader_validate(path: str) -> bool:
    from trackiellm_tpu_torch.models.loader import validate_model

    return validate_model(path)


def tk_llm_runner_create(params, cfg, **kwargs):
    from trackiellm_tpu_torch.llm.runner import LLMRunner

    return LLMRunner(params, cfg, **kwargs)


def tk_llm_runner_prepare_generation(r, prompt, tools=(),
                                     force_tool_call=False) -> None:
    r.prepare_generation(prompt, tools, force_tool_call)


def tk_llm_runner_generate_next_token(r) -> Optional[str]:
    return r.generate_next_token()


def tk_llm_runner_add_tool_response(r, name, response) -> None:
    r.add_tool_response(name, response)


def tk_llm_runner_reset(r) -> None:
    r.reset()


# ---- sensors / navigation ----------------------------------------------------

def tk_sensors_fusion_create(**kwargs):
    from trackiellm_tpu_torch.sensors.fusion import SensorFusion

    return SensorFusion(**kwargs)


def tk_sensors_fusion_get_world_state(f):
    return f.get_world_state()


def tk_navigation_engine_create(**kwargs):
    from trackiellm_tpu_torch.navigation.path_planner import NavigationEngine

    return NavigationEngine(**kwargs)


def tk_navigation_engine_update(e, depth_map, orientation=None):
    return e.update(depth_map, orientation)


def tk_free_space_detector_analyze(grid, cell_m=0.25, num_sectors=7):
    from trackiellm_tpu_torch.navigation.free_space import FreeSpaceDetector

    return FreeSpaceDetector(num_sectors=num_sectors).analyze(grid, cell_m)


# ---- config / logging (tk_config_parser.h / tk_logging.h) -------------------

def tk_config_load(path: str):
    from trackiellm_tpu_torch.utils.config import Config

    return Config.load(path)


def tk_log_set_level(level) -> None:
    from trackiellm_tpu_torch.utils.logging import set_log_level

    set_log_level(level)
