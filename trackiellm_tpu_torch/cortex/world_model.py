"""World model: object tracking over detections + hard safety rules.

Parity target: the Rust reasoning crate's WorldModel (reference:
src/cortex/src/reasoning.rs:86-91):
  - nearest-center association of detections to tracked objects with
    new-ID assignment (process_vision_event, :246-321),
  - hard-coded safety rules with alert cooldowns — person closer than
    1.0 m (10 s cooldown), obstacle closer than 2.0 m (5 s cooldown)
    (run_simple_rules :351-378, run_navigation_rules :391-425),
  - prioritized alert strings ("URGENTE ...") for the prompt builder
    (generate_prompt_for_llm :432-492 — the prompt itself is built by
    ContextualReasoner here).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

PERSON_ALERT_DISTANCE_M = 1.0   # reasoning.rs:351-378
PERSON_ALERT_COOLDOWN_S = 10.0
OBSTACLE_ALERT_DISTANCE_M = 2.0
OBSTACLE_ALERT_COOLDOWN_S = 5.0
MAX_ASSOCIATION_DISTANCE_PX = 120.0
TRACK_EXPIRY_S = 3.0


@dataclasses.dataclass
class TrackedObject:
    track_id: int
    label: str
    center: Tuple[float, float]
    distance_m: Optional[float]
    last_seen: float
    hits: int = 1


class WorldModel:
    """Frame-to-frame object tracker + safety-rule engine."""

    def __init__(self, clock=time.monotonic):
        self._clock = clock
        self._tracks: Dict[int, TrackedObject] = {}
        self._next_id = 1
        self._cooldowns: Dict[str, float] = {}

    # ------------------------------------------------------------------
    # Tracking (parity: process_vision_event)
    # ------------------------------------------------------------------

    def update_from_detections(self, objects: Sequence) -> List[TrackedObject]:
        """Associate DetectedObject-likes (label, box, distance_m) with
        existing tracks by nearest center (same label), else new ID."""
        now = self._clock()
        unmatched = dict(self._tracks)
        out: List[TrackedObject] = []

        for obj in objects:
            box = getattr(obj, "box")
            cx = (box[0] + box[2]) / 2.0
            cy = (box[1] + box[3]) / 2.0
            label = getattr(obj, "label")
            dist = getattr(obj, "distance_m", None)

            best_id, best_d = None, MAX_ASSOCIATION_DISTANCE_PX
            for tid, tr in unmatched.items():
                if tr.label != label:
                    continue
                d = ((tr.center[0] - cx) ** 2
                     + (tr.center[1] - cy) ** 2) ** 0.5
                if d < best_d:
                    best_id, best_d = tid, d

            if best_id is not None:
                tr = unmatched.pop(best_id)
                tr.center = (cx, cy)
                tr.distance_m = dist
                tr.last_seen = now
                tr.hits += 1
                out.append(tr)
            else:
                tr = TrackedObject(self._next_id, label, (cx, cy), dist, now)
                self._next_id += 1
                self._tracks[tr.track_id] = tr
                out.append(tr)

        # Expire stale tracks.
        for tid, tr in list(self._tracks.items()):
            if now - tr.last_seen > TRACK_EXPIRY_S:
                del self._tracks[tid]
        return out

    @property
    def tracks(self) -> List[TrackedObject]:
        return list(self._tracks.values())

    # ------------------------------------------------------------------
    # Safety rules (parity: run_simple_rules / run_navigation_rules)
    # ------------------------------------------------------------------

    def _cooldown_ok(self, key: str, cooldown_s: float) -> bool:
        now = self._clock()
        last = self._cooldowns.get(key, -1e18)
        if now - last >= cooldown_s:
            self._cooldowns[key] = now
            return True
        return False

    def run_safety_rules(self) -> List[str]:
        """Evaluate tracked objects against the hard rules; returns
        URGENTE alert strings (empty when nothing fires / cooled down).

        Cooldowns are PER RULE, not per track — the reference keeps one
        last-alert timestamp per rule (reasoning.rs:351-378). Per-track
        cooldowns looked stricter but were a flood: every new track id
        reset the clock, and a noisy detector minted new ids each frame
        — CRITICAL alerts then saturate the TTS queue and starve the
        reply the user asked for (measured in the production loop)."""
        alerts: List[str] = []
        nearest_person = None
        nearest_obstacle = None
        for tr in self._tracks.values():
            if tr.distance_m is None:
                continue
            if (tr.label == "person"
                    and tr.distance_m < PERSON_ALERT_DISTANCE_M):
                if (nearest_person is None
                        or tr.distance_m < nearest_person.distance_m):
                    nearest_person = tr
            elif (tr.label != "person"
                    and tr.distance_m < OBSTACLE_ALERT_DISTANCE_M):
                if (nearest_obstacle is None
                        or tr.distance_m < nearest_obstacle.distance_m):
                    nearest_obstacle = tr
        if nearest_person is not None and self._cooldown_ok(
                "person", PERSON_ALERT_COOLDOWN_S):
            alerts.append(
                f"URGENTE: pessoa muito próxima, a "
                f"{nearest_person.distance_m:.1f} m")
        if nearest_obstacle is not None and self._cooldown_ok(
                "obstacle", OBSTACLE_ALERT_COOLDOWN_S):
            alerts.append(
                f"URGENTE: obstáculo ({nearest_obstacle.label}) à "
                f"frente, a {nearest_obstacle.distance_m:.1f} m")
        return alerts

    def run_navigation_rules(self, hazards: Sequence[str]) -> List[str]:
        """Navigation-sourced alerts (step/hole/obstacle strings from
        the navigation engine). One per-rule cooldown (reference
        parity, reasoning.rs:391-425): the most urgent hazard is
        voiced, then the rule cools down — not one alert per distinct
        hazard string."""
        if hazards and self._cooldown_ok("nav", OBSTACLE_ALERT_COOLDOWN_S):
            return [f"URGENTE: {hazards[0]}"]
        return []
