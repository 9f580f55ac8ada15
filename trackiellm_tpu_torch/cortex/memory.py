"""Long-term memory: fragment archive with keyword retrieval, user
facts, known places, JSON persistence — plus opt-in semantic retrieval.

Parity target: the Rust MemoryManager (reference:
src/cortex/src/memory_manager.rs:53-298): ``archive_memory`` (:220),
``retrieve_relevant_memories`` keyword scoring (:263),
``get_fact/set_fact``, known places, ``save_memory_to_disk`` /
load (:176-192). Persistence is atomic (utils.paths) so a crash never
tears the store — same intent as the reference's save path.

Beyond parity: pass ``embed_fn`` (e.g. ``models.embedder.Embedder.embed``)
and retrieval becomes cosine similarity over L2-normalized sentence
embeddings, blended with the keyword score; fragments archived before
the embedder was attached are backfilled lazily in one batched call.
The keyword path remains the zero-model default (the reference's exact
behavior).
"""

from __future__ import annotations

import dataclasses
import json
import re
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from trackiellm_tpu_torch.utils.paths import Path

_WORD_RE = re.compile(r"[\wÀ-ÿ]+", re.UNICODE)


@dataclasses.dataclass
class MemoryFragment:
    text: str
    keywords: List[str]
    timestamp: float
    category: str = "general"
    embedding: Optional[List[float]] = None


def _keywords(text: str) -> List[str]:
    return [w.lower() for w in _WORD_RE.findall(text) if len(w) > 2]


class MemoryManager:
    """Archive + facts + places, with JSON save/load."""

    def __init__(self, store_path: Optional[str] = None,
                 max_fragments: int = 500, clock=time.time,
                 embed_fn: Optional[
                     Callable[[Sequence[str]], np.ndarray]] = None):
        self._path = Path(store_path) if store_path else None
        self._max = max_fragments
        self._clock = clock
        self._embed_fn = embed_fn
        self.fragments: List[MemoryFragment] = []
        self.facts: Dict[str, str] = {}
        self.places: Dict[str, str] = {}
        if self._path and self._path.exists():
            self.load()

    # -- archive ------------------------------------------------------------
    def archive(self, text: str, category: str = "general") -> None:
        """Parity: archive_memory (memory_manager.rs:220)."""
        emb = None
        if self._embed_fn is not None:
            emb = self._embed_fn([text]).tolist()[0]
        self.fragments.append(MemoryFragment(
            text, _keywords(text), self._clock(), category, emb))
        if len(self.fragments) > self._max:
            self.fragments = self.fragments[-self._max:]

    def _backfill_embeddings(self) -> None:
        missing = [f for f in self.fragments if f.embedding is None]
        if not missing or self._embed_fn is None:
            return
        vecs = self._embed_fn([f.text for f in missing]).tolist()
        for frag, vec in zip(missing, vecs):
            frag.embedding = [float(x) for x in vec]

    def retrieve_relevant(self, query: str, top_k: int = 3,
                          ) -> List[MemoryFragment]:
        """Keyword-overlap retrieval with recency tiebreak (parity:
        retrieve_relevant_memories, :263). With an ``embed_fn``
        attached, scores become cosine similarity (dominant term) plus
        a small keyword-overlap bonus — semantically related memories
        surface even with zero lexical overlap."""
        if self._embed_fn is not None and self.fragments:
            self._backfill_embeddings()
            qv = np.asarray(self._embed_fn([query]).tolist()[0], np.float32)
            q = set(_keywords(query))
            scored: List[Tuple[float, MemoryFragment]] = []
            for frag in self.fragments:
                sim = float(np.dot(np.asarray(frag.embedding,
                                              np.float32), qv))
                overlap = len(q & set(frag.keywords))
                scored.append((sim + 0.05 * overlap
                               + frag.timestamp * 1e-12, frag))
            scored.sort(key=lambda s: -s[0])
            return [f for _, f in scored[:top_k]]

        q = set(_keywords(query))
        if not q:
            return []
        scored = []
        for frag in self.fragments:
            overlap = len(q & set(frag.keywords))
            if overlap:
                scored.append((overlap + frag.timestamp * 1e-12, frag))
        scored.sort(key=lambda s: -s[0])
        return [f for _, f in scored[:top_k]]

    # -- facts / places ---------------------------------------------------
    def set_fact(self, key: str, value: str) -> None:
        self.facts[key] = value

    def get_fact(self, key: str) -> Optional[str]:
        return self.facts.get(key)

    def add_place(self, name: str, description: str) -> None:
        self.places[name] = description

    def get_place(self, name: str) -> Optional[str]:
        return self.places.get(name)

    # -- persistence (parity: save_memory_to_disk / load, :176-192) -------
    def save(self) -> None:
        if not self._path:
            return
        payload = {
            "fragments": [dataclasses.asdict(f) for f in self.fragments],
            "facts": self.facts,
            "places": self.places,
        }
        self._path.write_text_atomic(json.dumps(payload, ensure_ascii=False))

    def load(self) -> None:
        if not self._path or not self._path.exists():
            return
        payload = json.loads(self._path.read_text())
        self.fragments = [MemoryFragment(**f)
                          for f in payload.get("fragments", [])]
        self.facts = dict(payload.get("facts", {}))
        self.places = dict(payload.get("places", {}))
