"""Decision engine: parse LLM output into responses/actions, run the
prioritized action queue, handle emergencies.

Parity target: ``tk_decision_engine`` (reference:
src/cortex/tk_decision_engine.h:236-460 / .c):
  - parse LLM text into either a spoken response or a tool call
    (cJSON parse of {"tool_call": ...}, tk_decision_engine.c:98),
  - priority action queues with pending/executing/completed states
    (.c:39-60), processed on the cortex timer tick
    (tk_decision_engine_process_actions, h:340),
  - action execution against audio (speak), navigation (query), and the
    reasoner (context update),
  - emergency_stop + emergency_response (h:402-417).
"""

from __future__ import annotations

import dataclasses
import enum
import heapq
import itertools
import json
import time
from typing import Any, Callable, Dict, List, Optional


class ActionPriority(enum.IntEnum):
    LOW = 0
    NORMAL = 1
    HIGH = 2
    CRITICAL = 3


class ActionState(enum.Enum):
    """Parity: the pending/executing/completed queues (.c:39-60)."""

    PENDING = "pending"
    EXECUTING = "executing"
    COMPLETED = "completed"
    FAILED = "failed"
    CANCELLED = "cancelled"


@dataclasses.dataclass
class Action:
    name: str
    arguments: Dict[str, Any]
    priority: ActionPriority = ActionPriority.NORMAL
    state: ActionState = ActionState.PENDING
    result: Any = None
    created_at: float = dataclasses.field(default_factory=time.monotonic)


@dataclasses.dataclass
class LLMResponse:
    """Parity: tk_llm_response_t (h:81-190) — text XOR tool call."""

    text: Optional[str] = None
    tool_name: Optional[str] = None
    tool_arguments: Optional[Dict[str, Any]] = None

    @property
    def is_tool_call(self) -> bool:
        return self.tool_name is not None


def parse_llm_response(raw: str) -> LLMResponse:
    """Parity: parse_llm_response_text (tk_decision_engine.c:98) — try
    the tool-call JSON shape first, else treat as spoken text. Tolerates
    leading/trailing prose around the JSON object."""
    raw = raw.strip()
    candidate = raw
    if not candidate.startswith("{"):
        start = candidate.find("{")
        end = candidate.rfind("}")
        candidate = candidate[start:end + 1] if 0 <= start < end else ""
    if candidate:
        try:
            obj = json.loads(candidate)
            call = obj.get("tool_call") if isinstance(obj, dict) else None
            if isinstance(call, dict) and isinstance(call.get("name"), str):
                args = call.get("arguments")
                return LLMResponse(
                    tool_name=call["name"],
                    tool_arguments=args if isinstance(args, dict) else {})
        except json.JSONDecodeError:
            pass
    return LLMResponse(text=raw)


class DecisionEngine:
    """Action queue + executor registry."""

    def __init__(self, speak_fn: Optional[Callable[[str, int], None]] = None):
        # Registered tool executors: name -> fn(arguments) -> result.
        self._executors: Dict[str, Callable[[Dict[str, Any]], Any]] = {}
        # name -> (description, JSON Schema for arguments) — both may
        # be None; the schema types the tool-call grammar.
        self._tool_meta: Dict[str, tuple] = {}
        self._speak = speak_fn
        self._pending: List = []  # heap of (-priority, seq, Action)
        self._seq = itertools.count()
        self.completed: List[Action] = []
        self._emergency = False

    # ------------------------------------------------------------------
    def register_tool(self, name: str,
                      fn: Callable[[Dict[str, Any]], Any],
                      description: Optional[str] = None,
                      schema: Optional[Dict[str, Any]] = None) -> None:
        """Register an executor. ``schema`` (JSON Schema for the
        arguments object) makes grammar-forced calls to this tool emit
        TYPED arguments (llm/schema.py)."""
        self._executors[name] = fn
        self._tool_meta[name] = (description, schema)

    @property
    def tool_names(self) -> List[str]:
        return list(self._executors)

    @property
    def tool_specs(self) -> List[tuple]:
        """(name, description, schema) for every registered tool."""
        return [(n, *self._tool_meta.get(n, (None, None)))
                for n in self._executors]

    # ------------------------------------------------------------------
    # Response handling (parity: _process_llm_response + _execute_response)
    # ------------------------------------------------------------------

    def process_llm_response(self, raw_text: str) -> LLMResponse:
        resp = parse_llm_response(raw_text)
        if resp.is_tool_call:
            self.enqueue(Action(resp.tool_name, resp.tool_arguments or {}))
        elif resp.text and self._speak:
            self._speak(resp.text, int(ActionPriority.NORMAL))
        return resp

    def parse_only(self, raw_text: str) -> LLMResponse:
        """Like process_llm_response but never speaks — for callers that
        already streamed the text to TTS sentence-by-sentence."""
        resp = parse_llm_response(raw_text)
        if resp.is_tool_call:
            self.enqueue(Action(resp.tool_name, resp.tool_arguments or {}))
        return resp

    def enqueue(self, action: Action) -> None:
        if self._emergency and action.priority < ActionPriority.CRITICAL:
            action.state = ActionState.CANCELLED
            self.completed.append(action)
            return
        heapq.heappush(self._pending,
                       (-int(action.priority), next(self._seq), action))

    # ------------------------------------------------------------------
    # Queue processing (parity: tk_decision_engine_process_actions,
    # called from the cortex timer tick)
    # ------------------------------------------------------------------

    def process_actions(self, max_actions: int = 4) -> List[Action]:
        """Execute up to ``max_actions`` queued actions, highest priority
        first. Returns the actions processed this tick."""
        done: List[Action] = []
        while self._pending and len(done) < max_actions:
            _, _, action = heapq.heappop(self._pending)
            if action.state is ActionState.CANCELLED:
                continue
            action.state = ActionState.EXECUTING
            fn = self._executors.get(action.name)
            if fn is None:
                action.state = ActionState.FAILED
                action.result = f"unknown tool: {action.name}"
            else:
                try:
                    action.result = fn(action.arguments)
                    action.state = ActionState.COMPLETED
                except Exception as e:
                    action.state = ActionState.FAILED
                    action.result = str(e)
            done.append(action)
            self.completed.append(action)
        return done

    @property
    def pending_count(self) -> int:
        return len(self._pending)

    # ------------------------------------------------------------------
    # Emergencies (parity: h:402-417)
    # ------------------------------------------------------------------

    def emergency_stop(self) -> int:
        """Cancel everything pending; block sub-critical enqueues until
        cleared. Returns number cancelled."""
        n = 0
        while self._pending:
            _, _, action = heapq.heappop(self._pending)
            action.state = ActionState.CANCELLED
            self.completed.append(action)
            n += 1
        self._emergency = True
        return n

    def emergency_response(self, message: str) -> None:
        """Immediate critical spoken alert, bypassing the queue."""
        if self._speak:
            self._speak(message, int(ActionPriority.CRITICAL))

    def clear_emergency(self) -> None:
        self._emergency = False

    @property
    def in_emergency(self) -> bool:
        return self._emergency
