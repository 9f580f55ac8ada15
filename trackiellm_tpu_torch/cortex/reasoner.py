"""Contextual reasoner: short-term context store + token-budgeted prompt
context generation with urgency-first ordering.

Parity target: ``tk_contextual_reasoner`` (reference:
src/cortex/tk_contextual_reasoner.h:191-419 / .c):
  - context items with priority + exponential decay (config: max 100
    items, 20 turns, 0.95 decay — tk_cortex_main.c:835-841),
  - conversation-turn history,
  - vision / navigation / motion / ambient-sound context updates,
  - ``generate_context_string`` under a token budget (2048 default,
    tk_cortex_main.c:1334) with URGENT items ordered before everything
    else — the exact behavior the reference's tk_cortex_full_test
    asserts (tests/tk_cortex_full_test.c:20-72: fire alarm + step-down
    injected -> prompt contains "URGENTE", the alarm, the step cue, and
    the user query, urgency before query).
"""

from __future__ import annotations

import dataclasses
import enum
import time
from typing import Dict, List, Optional, Sequence


class ContextPriority(enum.IntEnum):
    """Parity: tk_context_priority_t ordering."""

    LOW = 0
    NORMAL = 1
    HIGH = 2
    URGENT = 3


@dataclasses.dataclass
class ContextItem:
    text: str
    priority: ContextPriority
    category: str                 # "vision" | "navigation" | "sound" | ...
    timestamp: float
    relevance: float = 1.0        # decayed over time


@dataclasses.dataclass
class ConversationTurn:
    role: str  # "user" | "assistant"
    text: str
    timestamp: float


@dataclasses.dataclass
class ReasonerConfig:
    """Defaults mirror cortex_initialize_subsystems
    (tk_cortex_main.c:835-841)."""

    max_context_items: int = 100
    max_conversation_turns: int = 20
    relevance_decay: float = 0.95    # per decay tick
    min_relevance: float = 0.05      # items below this are dropped
    token_budget: int = 2048         # tk_cortex_main.c:1334


def _estimate_tokens(text: str) -> int:
    """Cheap token estimate (~4 chars/token, llama-family heuristic)."""
    return max(1, len(text) // 4)


class ContextualReasoner:
    """Short-term context store feeding the LLM prompt."""

    def __init__(self, config: Optional[ReasonerConfig] = None,
                 clock=time.monotonic):
        self.config = config or ReasonerConfig()
        self._clock = clock
        self._items: List[ContextItem] = []
        self._turns: List[ConversationTurn] = []

    # ------------------------------------------------------------------
    # Ingestion (parity: tk_contextual_reasoner_update_* / _add_*)
    # ------------------------------------------------------------------

    def add_context_item(self, text: str,
                         priority: ContextPriority = ContextPriority.NORMAL,
                         category: str = "general") -> None:
        self._items.append(ContextItem(text, priority, category,
                                       self._clock()))
        if len(self._items) > self.config.max_context_items:
            # Drop the lowest (priority, relevance, age) item.
            keep = sorted(self._items,
                          key=lambda i: (i.priority, i.relevance,
                                         i.timestamp))[1:]
            self._items = keep

    def add_conversation_turn(self, role: str, text: str) -> None:
        """Parity: _add_conversation_turn (h:295)."""
        self._turns.append(ConversationTurn(role, text, self._clock()))
        self._turns = self._turns[-self.config.max_conversation_turns:]

    def update_vision_context(self, objects: Sequence,
                              scene_description: str = "") -> None:
        """Parity: _update_vision_context (h:246). ``objects`` are
        vision.pipeline.DetectedObject-like (label, distance_m,
        attributes)."""
        self._drop_category("vision")
        if not objects and not scene_description:
            return
        parts = []
        for o in objects:
            d = getattr(o, "distance_m", None)
            attrs = getattr(o, "attributes", []) or []
            desc = getattr(o, "label", str(o))
            if attrs:
                desc = f"{desc} ({', '.join(attrs)})"
            txt = getattr(o, "text", None)
            if txt:
                # OCR result attached to the triggering object
                # (tk_vision_object_t's text field parity).
                desc = f'{desc} com texto "{txt[:60]}"'
            parts.append(f"{desc} a {d:.1f} m" if d is not None else desc)
        text = "Visível: " + ", ".join(parts)
        if scene_description:
            text += f". {scene_description}"
        self.add_context_item(text, ContextPriority.NORMAL, "vision")

    def update_text_context(self, full_text: str = "",
                            barcodes: Sequence[str] = ()) -> None:
        """Full-page recognized text + QR candidates reach the prompt
        context (parity: the OCR engine's region/full-text results and
        the QR/barcode hooks, tk_text_recognition.cpp:73-104)."""
        self._drop_category("vision_text")
        if full_text:
            self.add_context_item(f"Texto visível: {full_text[:200]}",
                                  ContextPriority.NORMAL, "vision_text")
        if barcodes:
            # Decoded payloads ride the detector string after ":"
            # (vision/qr_decode.py); speak the CONTENT when we have
            # it, presence only when we don't.
            payloads = [b.split(":", 1)[1] for b in barcodes
                        if ":" in b and b.split(":", 1)[1]]
            n = len(barcodes)
            if payloads:
                listed = "; ".join(p[:120] for p in payloads[:3])
                self.add_context_item(
                    f"Código QR à frente diz: {listed}",
                    ContextPriority.NORMAL, "vision_text")
            if len(payloads) < n:
                rest = n - len(payloads)
                self.add_context_item(
                    "Há um código QR visível à frente (não legível "
                    "daqui)" if rest == 1
                    else f"Há {rest} códigos QR visíveis à frente "
                    "(não legíveis daqui)",
                    ContextPriority.NORMAL, "vision_text")

    def update_navigation_context(self, hazards: Sequence[str],
                                  clear_path_deg: Optional[float] = None,
                                  ) -> None:
        """Parity: _update_navigation_context. Hazards are urgent."""
        self._drop_category("navigation")
        for h in hazards:
            self.add_context_item(h, ContextPriority.URGENT, "navigation")
        if clear_path_deg is not None:
            self.add_context_item(
                f"Caminho livre a {clear_path_deg:.0f} graus",
                ContextPriority.NORMAL, "navigation")

    def update_motion_context(self, motion_state: str) -> None:
        self._drop_category("motion")
        self.add_context_item(f"Usuário está {motion_state}",
                              ContextPriority.LOW, "motion")

    def update_ambient_sound(self, sound_class: str,
                             urgent: bool = False) -> None:
        """Parity: _update_ambient_sound (h:205). Alarms are URGENT."""
        pri = (ContextPriority.URGENT if urgent
               else ContextPriority.NORMAL)
        self.add_context_item(f"Som detectado: {sound_class}", pri, "sound")

    def _drop_category(self, category: str) -> None:
        self._items = [i for i in self._items if i.category != category]

    # ------------------------------------------------------------------
    # Decay / maintenance
    # ------------------------------------------------------------------

    def decay_tick(self) -> None:
        """Apply relevance decay; drop items below the floor (the
        reference decays per update cycle with factor 0.95)."""
        for item in self._items:
            if item.priority < ContextPriority.URGENT:
                item.relevance *= self.config.relevance_decay
        self._items = [i for i in self._items
                       if i.relevance >= self.config.min_relevance]

    # ------------------------------------------------------------------
    # Prompt context generation
    # ------------------------------------------------------------------

    # Context categories rewritten every perception tick; under the
    # ``prefix_stable`` layout they are emitted LAST so the prompt's
    # head stays token-identical across turns (prefix-cache reuse,
    # llm/runner.py _prefill_with_prefix_reuse).
    VOLATILE_CATEGORIES = frozenset(
        {"vision", "navigation", "motion", "sound"})

    def generate_context_string(self, user_query: str = "",
                                token_budget: Optional[int] = None,
                                count_fn=None,
                                layout: str = "parity") -> str:
        """Build the LLM context block under the token budget.

        Ordering contract (asserted by the reference's full test):
        URGENT items first, marked ``[URGENTE]``; then high->low priority
        context; then recent conversation; the user query LAST.

        ``layout="prefix_stable"`` keeps the SAME selection (budget
        acceptance is identical line-for-line) but reorders emission
        for cross-turn KV-prefix reuse: conversation history and stable
        context first, per-tick volatile categories after, URGENT items
        right before the query (recency also makes them most salient to
        the model). Measured motivation: under the parity order the
        volatile vision block sat at token ~250 of a ~1000-token prompt
        and capped prefix-cache reuse there (tools/measure_app_e2e.py).

        ``count_fn`` overrides the chars/4 token estimate with the real
        tokenizer's count (the cortex passes the LLM runner's).
        """
        budget = token_budget or self.config.token_budget
        count = count_fn or _estimate_tokens
        lines: List[str] = []
        volatile: List[str] = []
        urgent_lines: List[str] = []
        # The query line is emitted unconditionally (contract: query
        # last), so its cost is RESERVED before any item is accepted —
        # otherwise the returned string overshoots the budget by the
        # query length and the final prompt can overflow the model
        # window (observed as a primed-prefix-killing truncation in the
        # round-3 production-loop measurement).
        used = count(f"Pergunta do usuário: {user_query}") if user_query \
            else 0
        stable_order = layout == "prefix_stable"

        def try_add(line: str, sink: List[str]) -> bool:
            nonlocal used
            t = count(line)
            if used + t > budget:
                return False
            sink.append(line)
            used += t
            return True

        # 1. urgent, newest first
        urgent = [i for i in self._items
                  if i.priority == ContextPriority.URGENT]
        for item in sorted(urgent, key=lambda i: -i.timestamp):
            try_add(f"[URGENTE] {item.text}",
                    urgent_lines if stable_order else lines)

        # 2. other context, by (priority desc, relevance*recency desc)
        rest = [i for i in self._items
                if i.priority < ContextPriority.URGENT]
        for item in sorted(rest, key=lambda i: (-i.priority, -i.relevance,
                                                -i.timestamp)):
            vol = stable_order and item.category in self.VOLATILE_CATEGORIES
            try_add(item.text, volatile if vol else lines)

        # 3. conversation history (most recent turns that fit)
        convo: List[str] = []
        c_used = 0
        for turn in reversed(self._turns):
            line = f"{'Usuário' if turn.role == 'user' else 'Assistente'}: " \
                   f"{turn.text}"
            t = count(line)
            if used + c_used + t > budget:
                break
            convo.append(line)
            c_used += t
        # Stable layout: history is append-only, so it sits after the
        # rarely-changing context but before the per-tick volatile
        # block; urgent alerts land right before the query.
        lines.extend(reversed(convo))
        used += c_used
        if stable_order:
            lines.extend(volatile)
            lines.extend(urgent_lines)

        # 4. the user query, always last
        if user_query:
            lines.append(f"Pergunta do usuário: {user_query}")

        return "\n".join(lines)

    # ------------------------------------------------------------------
    # Introspection (parity: _get_context_summary, h:358)
    # ------------------------------------------------------------------

    def get_summary(self) -> Dict[str, int]:
        return {
            "items": len(self._items),
            "urgent_items": sum(
                1 for i in self._items
                if i.priority == ContextPriority.URGENT),
            "turns": len(self._turns),
        }

    def clear(self) -> None:
        self._items.clear()
        self._turns.clear()
