"""Spatial scene graph over enriched detections.

A copy of ``trackiellm_tpu/vision/scene_graph.py`` (framework-free).

Parity target: the Rust scene-graph builder with OnTopOf / NextTo
relations serialized to JSON (reference: src/vision/src/scene_graph.rs:
22-66, exported via tk_vision_rust_build_scene_graph, lib.rs:192-409).

Runs on the host over the final (tiny) detection set — graph building
is irregular, branchy work that belongs off-device; the heavy lifting
(boxes, depths) already happened in fixed-shape device programs.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence


@dataclass
class SceneNode:
    node_id: int
    label: str
    box: List[float]  # xyxy camera px
    distance_m: Optional[float] = None
    attributes: List[str] = field(default_factory=list)


@dataclass
class SceneEdge:
    src: int
    dst: int
    relation: str  # "on_top_of" | "next_to"


def _h_overlap(a: Sequence[float], b: Sequence[float]) -> float:
    inter = min(a[2], b[2]) - max(a[0], b[0])
    denom = min(a[2] - a[0], b[2] - b[0])
    return max(inter, 0.0) / max(denom, 1e-6)


def _v_overlap(a: Sequence[float], b: Sequence[float]) -> float:
    inter = min(a[3], b[3]) - max(a[1], b[1])
    denom = min(a[3] - a[1], b[3] - b[1])
    return max(inter, 0.0) / max(denom, 1e-6)


def build_scene_graph(nodes: List[SceneNode],
                      on_top_gap_frac: float = 0.25,
                      next_to_gap_frac: float = 0.75,
                      depth_tol_m: float = 1.0) -> Dict[str, Any]:
    """Derive pairwise spatial relations:

    - ``on_top_of``: A's bottom edge sits near B's top edge with strong
      horizontal overlap (A above B in image space, similar depth).
    - ``next_to``: strong vertical overlap, small horizontal gap,
      similar depth.
    """
    edges: List[SceneEdge] = []
    for a in nodes:
        for b in nodes:
            if a.node_id == b.node_id:
                continue
            depth_ok = (
                a.distance_m is None or b.distance_m is None
                or abs(a.distance_m - b.distance_m) <= depth_tol_m
            )
            if not depth_ok:
                continue
            a_h = a.box[3] - a.box[1]
            # on_top_of: a's bottom close to b's top, horizontally aligned
            if (_h_overlap(a.box, b.box) > 0.5
                    and abs(a.box[3] - b.box[1]) <= on_top_gap_frac * a_h):
                edges.append(SceneEdge(a.node_id, b.node_id, "on_top_of"))
                continue
            # next_to: vertically aligned, horizontally adjacent
            a_w = a.box[2] - a.box[0]
            gap = max(b.box[0] - a.box[2], a.box[0] - b.box[2])
            if (_v_overlap(a.box, b.box) > 0.5
                    and 0 <= gap <= next_to_gap_frac * a_w
                    and a.node_id < b.node_id):  # dedupe symmetric pair
                edges.append(SceneEdge(a.node_id, b.node_id, "next_to"))
    return {
        "nodes": [
            {"id": n.node_id, "label": n.label, "box": list(n.box),
             "distance_m": n.distance_m, "attributes": n.attributes}
            for n in nodes
        ],
        "edges": [
            {"src": e.src, "dst": e.dst, "relation": e.relation}
            for e in edges
        ],
    }


def scene_graph_to_json(graph: Dict[str, Any]) -> str:
    return json.dumps(graph, separators=(",", ":"))


def describe_scene_graph(graph: Dict[str, Any]) -> str:
    """Human-readable summary for the contextual reasoner's prompt
    (parity: the Rust crate's JSON consumed by the reasoner)."""
    by_id = {n["id"]: n for n in graph["nodes"]}
    parts = []
    for e in graph["edges"]:
        rel = "on top of" if e["relation"] == "on_top_of" else "next to"
        parts.append(
            f"{by_id[e['src']]['label']} is {rel} {by_id[e['dst']]['label']}")
    return "; ".join(parts)
