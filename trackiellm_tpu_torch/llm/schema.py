"""JSON-Schema-constrained incremental acceptor for tool arguments.

A copy of ``trackiellm_tpu/llm/schema.py`` (framework-free: it imports
only ``json``, ``typing`` and the grammar module), kept in the port so
that the port imports nothing of the JAX package; its grammar import
points at the port's copy, ``trackiellm_tpu_torch/llm/grammar.py``.

Parity target: llama.cpp's ``json_schema_to_grammar`` (the ecosystem
feature layered over the GBNF engine the reference wires in at
src/ai_models/tk_runner_lifecycle.c:47-80) — typed tool calls, where
``{"tool_call":{"name":...,"arguments":...}}`` must carry arguments
conforming to the tool's declared JSON Schema, not just *some* JSON
object (reference grammar: src/ai_models/grammars/tool_call.gbnf:1-23).

Design: same stance as :mod:`trackiellm_tpu_torch.llm.grammar` — the
constraint engine is host-side and character-incremental; each decode
step it yields a boolean vocab mask applied to device logits with one
fixed-shape ``where``. Instead of compiling the schema to GBNF text
and interpreting that, the schema compiles to a small node tree and a
stack machine accepts conforming JSON directly. The acceptor mirrors
``JsonAcceptor``'s surface (``feed`` / ``done`` / ``failed`` / ``copy``
/ ``closure`` / ``state_key``) so ``ToolCallGrammar`` can swap it in
per-tool, and its state is hashable so the per-state token-mask cache
keeps working.

Supported schema subset (llama.cpp-converter-equivalent core):
``type`` object/array/string/number/integer/boolean/null, ``enum`` and
``const`` (pinned to their canonical JSON rendering), ``properties`` +
``required`` (properties are emitted in declaration order; optional
ones may be skipped; unlisted keys are rejected — the generation-useful
reading that llama.cpp's converter also takes), ``items`` +
``minItems``/``maxItems``. Anything else (``anyOf``, ``patternProperties``,
string patterns, numeric ranges, …) degrades to an unconstrained JSON
value of the right shape rather than failing — constrained generation
should never be *stricter* than the schema intends.
"""

from __future__ import annotations

import json
from typing import Any, List, Optional, Tuple

from trackiellm_tpu_torch.llm.grammar import (JsonAcceptor, _NUM_TERMINAL,
                                              _num_step)

_WS = " \t\n\r"

# ---------------------------------------------------------------------------
# Schema compilation: JSON Schema dict -> immutable node tree (shared by all
# acceptor copies; never part of the mutable per-generation state).
# ---------------------------------------------------------------------------


def _canon(value: Any) -> str:
    """Canonical JSON rendering of an enum/const literal (the exact
    character sequence the model is forced to emit)."""
    return json.dumps(value, separators=(",", ":"), ensure_ascii=False)


def compile_schema(schema: Any) -> tuple:
    """Normalize a JSON-Schema fragment into an acceptor node tuple."""
    if schema is True or schema is None or schema == {}:
        return ("any",)
    if not isinstance(schema, dict):
        return ("any",)
    if "const" in schema:
        return ("enum", (_canon(schema["const"]),))
    if "enum" in schema:
        lits = tuple(_canon(v) for v in schema["enum"])
        if not lits:
            return ("any",)
        return ("enum", lits)
    typ = schema.get("type")
    if isinstance(typ, list):
        if len(typ) == 1:
            typ = typ[0]
        else:
            return ("any",)  # union of types: unconstrained fallback
    if typ == "object":
        props_spec = schema.get("properties")
        required = set(schema.get("required") or ())
        if props_spec is None:
            # No property list at all: any JSON object conforms.
            return ("any_obj",)
        props = tuple((k, compile_schema(v), k in required)
                      for k, v in props_spec.items())
        # NB an explicit empty ``properties: {}`` forces exactly "{}"
        # (a no-argument tool costs two grammar-forced tokens).
        return ("obj", props)
    if typ == "array":
        item = compile_schema(schema.get("items"))
        min_items = int(schema.get("minItems") or 0)
        max_items = schema.get("maxItems")
        max_items = int(max_items) if max_items is not None else None
        return ("arr", item, min_items, max_items)
    if typ == "string":
        return ("str",)
    if typ == "integer":
        return ("num", True)
    if typ == "number":
        return ("num", False)
    if typ == "boolean":
        return ("enum", ("true", "false"))
    if typ == "null":
        return ("enum", ("null",))
    return ("any",)


def _min_value_text(node: tuple) -> str:
    """Shortest valid JSON text for a node (budget-forced closures)."""
    kind = node[0]
    if kind == "obj":
        parts = []
        for key, sub, req in node[1]:
            if req:
                parts.append(_canon(key) + ":" + _min_value_text(sub))
        return "{" + ",".join(parts) + "}"
    if kind == "arr":
        _, item, min_items, _ = node
        return "[" + ",".join([_min_value_text(item)] * min_items) + "]"
    if kind == "str":
        return '""'
    if kind == "num":
        return "0"
    if kind == "enum":
        return min(node[1], key=len)
    if kind == "any_obj":
        return "{}"
    return "null"  # any


# ---------------------------------------------------------------------------
# Frames. Each frame is a small mutable list [tag, ...fields]; the stack is
# deep-copied by copy() (depth is bounded by schema nesting — cheap).
#
#   ['obj', node, phase, idx, keybuf]
#       phase: 'open' | 'key_or_end' | 'key' | 'in_key' | 'in_key_esc'
#              | 'colon' | 'comma_or_end'
#       idx:   index of the first property still allowed to appear
#       keybuf: raw key characters consumed so far (while in_key)
#   ['arr', node, phase, count]
#       phase: 'open' | 'item_or_end' | 'comma_or_end'
#   ['str', phase]              phase: 'open' | 'body' | 'esc'
#   ['num', is_integer, state]  state: number-DFA state or None (pre-start)
#   ['lit', candidates, pos]    fixed-literal alternation (enum/bool/null)
#   ['any', JsonAcceptor]       unconstrained JSON value
# ---------------------------------------------------------------------------


class SchemaAcceptor:
    """Incremental acceptor for one JSON value conforming to a schema."""

    def __init__(self, schema: Any, _node: Optional[tuple] = None):
        self.node = compile_schema(schema) if _node is None else _node
        self.stack: List[list] = [self._value_frame(self.node)]
        self.done = False
        self.failed = False

    # -- lifecycle -----------------------------------------------------------
    def copy(self) -> "SchemaAcceptor":
        new = object.__new__(SchemaAcceptor)
        new.node = self.node
        new.done = self.done
        new.failed = self.failed
        new.stack = [
            [f[0], f[1].copy()] if f[0] == "any" else list(f)
            for f in self.stack
        ]
        return new

    def at_end(self) -> bool:
        """True if the input so far forms a complete conforming value.
        Root-level numbers (and ambiguous literals like enum ``1`` vs
        ``12``) only *pop* on their trailing delimiter, which never
        arrives at end-of-input — this answers "may generation stop
        here?" without one."""
        if self.done:
            return True
        if self.failed or len(self.stack) != 1:
            return False
        f = self.stack[0]
        if f[0] == "num":
            return f[2] in _NUM_TERMINAL
        if f[0] == "lit":
            return any(len(c) == f[2] for c in f[1])
        if f[0] == "any":
            return f[1].at_end()
        return False

    def state_key(self) -> tuple:
        """Hashable signature of the acceptor state (mask caching)."""
        sig: List[tuple] = []
        for f in self.stack:
            if f[0] == "any":
                sig.append(("any",) + f[1].state_key())
            elif f[0] == "obj":
                sig.append(("obj", id(f[1]), f[2], f[3], f[4]))
            elif f[0] == "arr":
                sig.append(("arr", id(f[1]), f[2], f[3]))
            elif f[0] == "lit":
                sig.append(("lit", f[1], f[2]))
            else:
                sig.append(tuple(f))
        return (self.done, self.failed, tuple(sig))

    # -- frame construction --------------------------------------------------
    @staticmethod
    def _value_frame(node: tuple) -> list:
        kind = node[0]
        if kind == "obj":
            return ["obj", node, "open", 0, ""]
        if kind == "arr":
            return ["arr", node, "open", 0]
        if kind == "str":
            return ["str", "open"]
        if kind == "num":
            return ["num", node[1], None]
        if kind == "enum":
            return ["lit", node[1], 0]
        if kind == "any_obj":
            acc = JsonAcceptor(root_object_only=True)
            return ["any", acc]
        return ["any", JsonAcceptor(root_object_only=False)]

    # -- completion plumbing --------------------------------------------------
    def _pop_value(self) -> None:
        """The top frame finished one complete value."""
        self.stack.pop()
        if not self.stack:
            self.done = True
            return
        parent = self.stack[-1]
        if parent[0] == "obj":
            parent[2] = "comma_or_end"
        elif parent[0] == "arr":
            parent[3] += 1
            parent[2] = "comma_or_end"
        else:  # pragma: no cover
            raise AssertionError(parent[0])

    # -- feeding --------------------------------------------------------------
    def feed(self, ch: str) -> bool:
        if self.failed:
            return False
        ok = self._feed(ch)
        if not ok:
            self.failed = True
        return ok

    def _feed(self, ch: str) -> bool:
        if self.done:
            return ch in _WS
        f = self.stack[-1]
        tag = f[0]

        if tag == "any":
            acc: JsonAcceptor = f[1]
            if not acc.feed(ch):
                return False
            if acc.done:
                self._pop_value()
            return True

        if tag == "str":
            if f[1] == "open":
                if ch in _WS:
                    return True
                if ch == '"':
                    f[1] = "body"
                    return True
                return False
            if f[1] == "esc":
                if ch == "u":
                    f[1] = "u4"
                    return True
                if ch in '"\\/bfnrt':  # the legal JSON escapes only
                    f[1] = "body"
                    return True
                return False
            if f[1].startswith("u"):
                if ch in "0123456789abcdefABCDEF":
                    n = int(f[1][1:]) - 1
                    f[1] = "body" if n == 0 else f"u{n}"
                    return True
                return False
            if ch == "\\":
                f[1] = "esc"
                return True
            if ch == '"':
                self._pop_value()
                return True
            return ch >= " "

        if tag == "lit":
            cands, pos = f[1], f[2]
            if pos == 0 and ch in _WS:
                return True
            live = tuple(c for c in cands if len(c) > pos and c[pos] == ch)
            if live:
                f[1], f[2] = live, pos + 1
                # Pop eagerly once exactly one candidate is fully
                # consumed and no other continues past it.
                if len(live) == 1 and len(live[0]) == pos + 1:
                    self._pop_value()
                return True
            # No candidate extends: legal only if one is already
            # complete — then ch belongs to the parent (delimiter).
            if any(len(c) == pos for c in cands):
                self._pop_value()
                return self._feed(ch)
            return False

        if tag == "num":
            is_int, state = f[1], f[2]
            if state is None:
                if ch in _WS:
                    return True
                if ch == "-":
                    f[2] = "INT_NEED_DIGIT"
                    return True
                nxt = _num_step("INT_NEED_DIGIT", ch)
                if nxt is None:
                    return False
                f[2] = nxt
                return True
            nxt = _num_step(state, ch)
            if nxt is not None and is_int and nxt in (
                    "FRAC_NEED_DIGIT", "EXP_NEED"):
                nxt = None  # integers: no fraction, no exponent
            if nxt is not None:
                f[2] = nxt
                return True
            if state not in _NUM_TERMINAL:
                return False
            self._pop_value()
            return self._feed(ch)  # ch is the delimiter after the number

        if tag == "obj":
            node, phase = f[1], f[2]
            props: Tuple = node[1]
            if ch in _WS and phase != "in_key":
                return True
            if phase == "open":
                if ch == "{":
                    f[2] = "key_or_end"
                    return True
                return False
            if phase in ("key_or_end", "key"):
                if ch == '"':
                    if f[3] >= len(props):
                        return False  # no property may still appear
                    f[2], f[4] = "in_key", ""
                    return True
                if ch == "}" and phase == "key_or_end":
                    if any(req for _, _, req in props[f[3]:]):
                        return False  # a required property is missing
                    self._pop_value()
                    return True
                return False
            if phase == "in_key":
                # No escape support inside keys: every char must extend
                # a still-allowed property name verbatim (keys needing
                # JSON escapes are unsupported). Allowing a lone '\\'
                # would create a mask dead-end: an accepted prefix with
                # no completable property.
                if ch == '"':
                    idx = f[3]
                    for j in range(idx, len(props)):
                        key, _, req = props[j]
                        if key == f[4]:
                            f[2], f[3] = "colon", j + 1
                            return True
                        if req:
                            break  # cannot skip a required property
                    return False
                f[4] += ch
                # Must remain a prefix of some still-allowed key.
                idx = f[3]
                for j in range(idx, len(props)):
                    key, _, req = props[j]
                    if key.startswith(f[4]):
                        return True
                    if req:
                        break
                return False
            if phase == "colon":
                if ch == ":":
                    # f[3] was advanced past the matched key.
                    _, sub, _ = props[f[3] - 1]
                    f[2] = "after_colon"
                    self.stack.append(self._value_frame(sub))
                    return True
                return False
            if phase == "comma_or_end":
                if ch == ",":
                    if f[3] >= len(props):
                        return False  # nothing left to name
                    f[2] = "key"
                    return True
                if ch == "}":
                    if any(req for _, _, req in props[f[3]:]):
                        return False
                    self._pop_value()
                    return True
                return False
            return False  # 'after_colon' is transient; value frame on top

        if tag == "arr":
            node, phase, count = f[1], f[2], f[3]
            _, item, min_items, max_items = node
            if ch in _WS:
                return True
            if phase == "open":
                if ch == "[":
                    f[2] = "item_or_end"
                    return True
                return False
            if phase == "item_or_end":
                if ch == "]":
                    if count < min_items:
                        return False
                    self._pop_value()
                    return True
                if max_items is not None and count >= max_items:
                    return False
                f[2] = "after_item_open"
                self.stack.append(self._value_frame(item))
                return self._feed(ch)
            if phase == "comma_or_end":
                if ch == ",":
                    if max_items is not None and count >= max_items:
                        return False
                    f[2] = "item_or_end"
                    return True
                if ch == "]":
                    if count < min_items:
                        return False
                    self._pop_value()
                    return True
                return False
            return False

        raise AssertionError(tag)  # pragma: no cover

    def feed_text(self, text: str) -> bool:
        for ch in text:
            if not self.feed(ch):
                return False
        return True

    # -- budget-forced closure -------------------------------------------------
    def closure(self) -> str:
        """Minimal string completing the current prefix into a value
        that conforms to the schema (same contract as
        ``JsonAcceptor.closure``)."""
        probe = self.copy()
        out: List[str] = []

        def push(s: str) -> None:
            for ch in s:
                assert probe.feed(ch), f"schema closure {ch!r} rejected"
                out.append(ch)

        guard = 0
        while not probe.done:
            guard += 1
            assert guard < 4096, "schema closure did not converge"
            f = probe.stack[-1]
            tag = f[0]
            if tag == "any":
                acc: JsonAcceptor = f[1]
                push(acc.closure() if acc.expect != "root_value"
                     else ("{}" if acc._root_object_only else "null"))
            elif tag == "str":
                if f[1] == "open":
                    push('""')
                elif f[1] == "esc":
                    push('n"')
                elif f[1].startswith("u"):
                    push("0" * int(f[1][1:]) + '"')
                else:
                    push('"')
            elif tag == "lit":
                cands, pos = f[1], f[2]
                best = min((c for c in cands if len(c) >= pos), key=len)
                push(best[pos:])
                if probe.stack and probe.stack[-1] is f:
                    # complete-but-ambiguous literal: delimiter comes
                    # from the parent on the next loop iteration after
                    # we force the pop via a parent-owned char — pop it
                    # by feeding the parent's closing char instead.
                    probe._pop_value()
            elif tag == "num":
                if f[2] is None:
                    push("0")
                elif f[2] not in _NUM_TERMINAL:
                    push("0")
                else:
                    probe._pop_value()  # number is complete as-is
            elif tag == "obj":
                node, phase = f[1], f[2]
                props = node[1]
                if phase == "open":
                    push("{")
                elif phase in ("key_or_end", "key", "comma_or_end"):
                    nxt_req = next(
                        (j for j in range(f[3], len(props))
                         if props[j][2]), None)
                    if nxt_req is None:
                        if phase == "key":
                            # after a comma a key MUST follow: emit the
                            # next (optional) property minimally
                            key, sub, _ = props[f[3]]
                            push(_canon(key) + ":" + _min_value_text(sub))
                        else:
                            push("}")
                    else:
                        key, sub, _ = props[nxt_req]
                        prefix = "," if phase == "comma_or_end" else ""
                        push(prefix + _canon(key) + ":"
                             + _min_value_text(sub))
                elif phase == "in_key":
                    # complete the shortest still-allowed key
                    best = None
                    for j in range(f[3], len(props)):
                        key, _, req = props[j]
                        if key.startswith(f[4]):
                            if best is None or len(key) < len(best):
                                best = key
                        if req and not key.startswith(f[4]):
                            break
                        if req:
                            break
                    assert best is not None, "in_key state must be live"
                    push(best[len(f[4]):] + '"')
                elif phase == "colon":
                    push(":")
                else:  # pragma: no cover
                    raise AssertionError(phase)
            elif tag == "arr":
                node, phase, count = f[1], f[2], f[3]
                _, item, min_items, _ = node
                if phase == "open":
                    push("[")
                elif phase == "item_or_end":
                    if count < min_items:
                        push(_min_value_text(item))
                    else:
                        push("]")
                elif phase == "comma_or_end":
                    if count < min_items:
                        push("," + _min_value_text(item))
                    else:
                        push("]")
                else:  # pragma: no cover
                    raise AssertionError(phase)
            else:  # pragma: no cover
                raise AssertionError(tag)
        return "".join(out)
