"""Voice command parsing: keyword/intent matcher ahead of the LLM.

Parity target: the reference's ``tk_voice_commands`` shim over the Rust
keyword matcher (reference: src/interaction/tk_voice_commands.c +
src/interaction/src/command_parser.rs:9-12). Fast-path intents (stop,
repeat, emergency) bypass LLM inference entirely.
"""

from __future__ import annotations

import dataclasses
import re
import unicodedata
from typing import Dict, Optional, Sequence, Tuple


@dataclasses.dataclass
class ParsedCommand:
    intent: str
    confidence: float
    slots: Dict[str, str]
    raw_text: str


def _normalize(text: str) -> str:
    text = unicodedata.normalize("NFD", text.lower())
    text = "".join(c for c in text if unicodedata.category(c) != "Mn")
    return re.sub(r"[^\w\s]", " ", text).strip()


# intent -> (keyword sets, any match wins; PT + EN like the reference UX)
_DEFAULT_INTENTS: Dict[str, Sequence[Sequence[str]]] = {
    "emergency_stop": (("parar", "tudo"), ("pare", "tudo"),
                       ("emergencia",), ("stop", "everything")),
    "stop_speech": (("silencio",), ("cala",), ("quiet",), ("stop",)),
    "repeat": (("repete",), ("repetir",), ("repeat",), ("de novo",)),
    "describe_scene": (("o", "que", "voce", "ve"), ("descreva",),
                       ("describe",), ("what", "do", "you", "see")),
    "find_object": (("onde", "esta"), ("encontre",), ("ache",),
                    ("where", "is"), ("find",)),
    "navigate": (("caminho", "livre"), ("por", "onde"), ("guia",),
                 ("clear", "path"), ("navigate",)),
    "read_text": (("leia",), ("ler",), ("read",)),
    "save_location": (("lembre", "lugar"), ("salvar", "local"),
                      ("remember", "place")),
}


class CommandParser:
    """Keyword-set intent matcher with slot extraction for object names."""

    def __init__(self,
                 intents: Optional[Dict[str, Sequence[Sequence[str]]]] = None):
        self.intents = dict(intents or _DEFAULT_INTENTS)

    def parse(self, text: str) -> Optional[ParsedCommand]:
        norm = _normalize(text)
        words = set(norm.split())
        best: Optional[Tuple[str, float]] = None
        for intent, keyword_sets in self.intents.items():
            for ks in keyword_sets:
                if all(k in words for k in ks):
                    score = len(ks) / max(len(words), 1)
                    if best is None or score > best[1]:
                        best = (intent, score)
        if best is None:
            return None
        intent, score = best
        slots = self._extract_slots(intent, norm)
        return ParsedCommand(intent, min(1.0, 0.5 + score), slots, text)

    def _extract_slots(self, intent: str, norm: str) -> Dict[str, str]:
        slots: Dict[str, str] = {}
        if intent == "find_object":
            m = re.search(r"(?:onde esta|encontre|ache|where is|find)"
                          r"\s+(?:o |a |my |the |meu |minha )?(.+)", norm)
            if m:
                slots["object"] = m.group(1).strip()
        if intent == "save_location":
            m = re.search(r"(?:lugar|local|place)\s+(?:como |as )?(.+)",
                          norm)
            if m:
                slots["name"] = m.group(1).strip()
        return slots

    def add_intent(self, intent: str,
                   keyword_sets: Sequence[Sequence[str]]) -> None:
        self.intents[intent] = tuple(tuple(k) for k in keyword_sets)
