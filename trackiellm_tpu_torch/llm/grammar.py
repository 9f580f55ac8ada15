"""Grammar-constrained decoding for tool calls.

A copy of ``trackiellm_tpu/llm/grammar.py`` (framework-free: it imports
only ``copy`` and ``typing``), kept in the port so that the port imports
nothing of the JAX package; only the imports of the schema module point at
the port's copy, ``trackiellm_tpu_torch/llm/schema.py``.

Parity target: the reference's GBNF grammar that forces the LLM to emit
``{"tool_call":{"name":...,"arguments":{...}}}`` (reference:
src/ai_models/grammars/tool_call.gbnf:1-23, wired into llama.cpp sampling
in src/ai_models/tk_runner_lifecycle.c:47-80).

Design: constrained sampling is inherently data-dependent, so it lives on
the host: each step the runner asks the grammar for the set of legal next
tokens, masks the device logits with one fixed-shape ``where``, and
samples. The grammar itself is an incremental character-level acceptor
(fixed skeleton + name alternation + a full incremental JSON acceptor for
the arguments object), equivalent in language to the reference's GBNF.
"""

from __future__ import annotations

import copy
from typing import List, Optional, Sequence

_WS = " \t\n\r"

# JSON number DFA states. *_NEED states cannot legally terminate.
_NUM_TERMINAL = {"INT_ZERO", "INT_DIGITS", "FRAC_DIGITS", "EXP_DIGITS"}


def _num_step(state: str, ch: str):
    """One step of the JSON number DFA. Returns the new state, or None if
    ``ch`` does not continue the number (caller decides: terminate if the
    state is terminal, else the prefix is invalid)."""
    digit = "0" <= ch <= "9"
    if state == "INT_NEED_DIGIT":
        return "INT_ZERO" if ch == "0" else ("INT_DIGITS" if digit else None)
    if state == "INT_ZERO":
        if ch == ".":
            return "FRAC_NEED_DIGIT"
        if ch in "eE":
            return "EXP_NEED"
        return None  # leading zeros / digits after 0 are not JSON
    if state == "INT_DIGITS":
        if digit:
            return "INT_DIGITS"
        if ch == ".":
            return "FRAC_NEED_DIGIT"
        if ch in "eE":
            return "EXP_NEED"
        return None
    if state == "FRAC_NEED_DIGIT":
        return "FRAC_DIGITS" if digit else None
    if state == "FRAC_DIGITS":
        if digit:
            return "FRAC_DIGITS"
        if ch in "eE":
            return "EXP_NEED"
        return None
    if state == "EXP_NEED":
        if ch in "+-":
            return "EXP_NEED_DIGIT"
        return "EXP_DIGITS" if digit else None
    if state == "EXP_NEED_DIGIT":
        return "EXP_DIGITS" if digit else None
    if state == "EXP_DIGITS":
        return "EXP_DIGITS" if digit else None
    raise AssertionError(state)


class JsonAcceptor:
    """Incremental acceptor for a single JSON value (object-rooted here).

    ``feed(ch)`` returns False if the character makes the prefix invalid;
    ``done`` flips once a complete value has been consumed.
    """

    def __init__(self, root_object_only: bool = True):
        self.containers: List[str] = []  # 'O' | 'A'
        self.expect = "root_value"
        self.in_string: Optional[str] = None  # 'key' | 'value'
        self.escape = False
        self.u_rest = 0  # hex digits still owed to a \\u escape
        self.num_state: Optional[str] = None  # JSON number DFA state
        self.lit_rest = ""  # remainder of true/false/null
        self.done = False
        self.failed = False
        self._root_object_only = root_object_only

    def copy(self) -> "JsonAcceptor":
        return copy.copy(self)  # all fields immutable except containers

    def __copy__(self):
        new = object.__new__(JsonAcceptor)
        new.__dict__ = dict(self.__dict__)
        new.containers = list(self.containers)
        return new

    # -- internals ----------------------------------------------------------
    def _end_value(self) -> None:
        if not self.containers:
            self.expect = "done"
            self.done = True
        else:
            self.expect = "comma_or_end"

    def feed(self, ch: str) -> bool:
        if self.failed:
            return False
        ok = self._feed(ch)
        if not ok:
            self.failed = True
        return ok

    def _feed(self, ch: str) -> bool:
        if self.in_string is not None:
            if self.u_rest:
                if ch in "0123456789abcdefABCDEF":
                    self.u_rest -= 1
                    return True
                return False
            if self.escape:
                self.escape = False
                if ch == "u":
                    self.u_rest = 4
                    return True
                return ch in '"\\/bfnrt'  # the legal JSON escapes only
            if ch == "\\":
                self.escape = True
                return True
            if ch == '"':
                was_key = self.in_string == "key"
                self.in_string = None
                if was_key:
                    self.expect = "colon"
                else:
                    self._end_value()
                return True
            return ch >= " "  # no raw control chars in strings

        if self.lit_rest:
            if ch == self.lit_rest[0]:
                self.lit_rest = self.lit_rest[1:]
                if not self.lit_rest:
                    self._end_value()
                return True
            return False

        if self.num_state is not None:
            nxt = _num_step(self.num_state, ch)
            if nxt is not None:
                self.num_state = nxt
                return True
            if self.num_state not in _NUM_TERMINAL:
                return False  # e.g. "9." or "-" followed by a delimiter
            self.num_state = None
            self._end_value()
            # fall through: ch is a structural char after the number

        if ch in _WS:
            return not self.done or True  # whitespace always tolerated

        e = self.expect
        if e in ("value", "root_value", "value_or_end_arr"):
            if e == "value_or_end_arr" and ch == "]":
                self.containers.pop()
                self._end_value()
                return True
            if e == "root_value" and self._root_object_only and ch != "{":
                return False
            if ch == "{":
                self.containers.append("O")
                self.expect = "key_or_end"
                return True
            if ch == "[":
                self.containers.append("A")
                self.expect = "value_or_end_arr"
                return True
            if ch == '"':
                self.in_string = "value"
                return True
            if ch == "-":
                self.num_state = "INT_NEED_DIGIT"
                return True
            if ch == "0":
                self.num_state = "INT_ZERO"
                return True
            if "1" <= ch <= "9":
                self.num_state = "INT_DIGITS"
                return True
            for lit in ("true", "false", "null"):
                if ch == lit[0]:
                    self.lit_rest = lit[1:]
                    if not self.lit_rest:
                        self._end_value()
                    return True
            return False

        if e == "key_or_end":
            if ch == '"':
                self.in_string = "key"
                return True
            if ch == "}":
                self.containers.pop()
                self._end_value()
                return True
            return False

        if e == "key":
            if ch == '"':
                self.in_string = "key"
                return True
            return False

        if e == "colon":
            if ch == ":":
                self.expect = "value"
                return True
            return False

        if e == "comma_or_end":
            top = self.containers[-1]
            if ch == ",":
                self.expect = "key" if top == "O" else "value"
                return True
            if top == "O" and ch == "}":
                self.containers.pop()
                self._end_value()
                return True
            if top == "A" and ch == "]":
                self.containers.pop()
                self._end_value()
                return True
            return False

        # expect == "done": nothing further (whitespace handled above)
        return False

    def closure(self) -> str:
        """Minimal string that completes the current prefix into valid
        JSON (used to force-close a generation that is about to run out
        of token budget — a failure mode the reference's GBNF sampling
        cannot recover from: truncated output is simply invalid there)."""
        probe = self.copy()
        out = []

        def push(s: str) -> None:
            for ch in s:
                assert probe.feed(ch), f"closure char {ch!r} rejected"
                out.append(ch)

        if probe.escape:
            push("n")
        if probe.u_rest:
            push("0" * probe.u_rest)
        if probe.in_string is not None:
            push('"')
        if probe.lit_rest:
            push(probe.lit_rest)
        if probe.num_state is not None and probe.num_state not in _NUM_TERMINAL:
            push("0")  # completes every non-terminal number prefix
        guard = 0
        while not probe.done:
            guard += 1
            assert guard < 256, "closure did not converge"
            if probe.num_state is not None:
                # A closing bracket both terminates the number and pops
                # its container.
                push("}" if probe.containers[-1] == "O" else "]")
                continue
            e = probe.expect
            if e in ("value", "root_value"):
                push("null" if probe.containers else "{}")
            elif e == "value_or_end_arr":
                push("]")
            elif e in ("key_or_end",):
                push("}")
            elif e == "key":
                push('"_":null')
            elif e == "colon":
                push(":null")
            elif e == "comma_or_end":
                push("}" if probe.containers[-1] == "O" else "]")
            else:  # pragma: no cover
                raise AssertionError(f"unexpected state {e}")
        return "".join(out)

    def state_key(self) -> tuple:
        """Hashable signature of the acceptor state (mask caching)."""
        return (tuple(self.containers), self.expect, self.in_string,
                self.escape, self.u_rest, self.num_state, self.lit_rest,
                self.done, self.failed)

    def at_end(self) -> bool:
        """True if the input so far forms a complete JSON value — a
        root-level number has no trailing delimiter to pop it, so
        ``done`` alone under-reports at end-of-input."""
        if self.done:
            return True
        if self.failed or self.containers or self.in_string is not None:
            return False
        return self.num_state in _NUM_TERMINAL


class CharGrammar:
    """Shared machinery for character-incremental constrained-decoding
    grammars: probing (``allows``), text feeding, and the per-state
    cached token mask. Subclasses provide ``feed_char``, ``done``,
    ``closure``, ``_snapshot``/``_restore`` and ``_state_key``;
    ``at_end`` marks states where generation may legally STOP even
    though more characters could extend the value (a root-level JSON
    number, for instance) — the mask adds EOS there."""

    def feed_text(self, text: str) -> bool:
        for ch in text:
            if not self.feed_char(ch):
                return False
        return True

    def allows(self, text: str) -> bool:
        """Probe: would feeding ``text`` keep the prefix valid?"""
        if not text:
            return False
        snap = self._snapshot()
        ok = self.feed_text(text)
        self._restore(snap)
        return ok

    def at_end(self) -> bool:
        return False

    def token_mask(self, tokenizer, extra_allowed: Sequence[int] = ()) -> "list[bool]":
        """Boolean vocab mask of tokens whose text keeps the prefix valid.
        Once the grammar is complete only EOS (and ``extra_allowed``) pass.

        Masks are cached per acceptor state (and the tokenizer's decoded
        pieces per vocab): at a 32k vocab an uncached build walks every
        piece through the acceptor (~tens of ms), which would dominate
        tool-call decode; cached steady-state cost is a dict lookup.
        Returned lists are shared — treat them as read-only.
        """
        v = tokenizer.vocab_size
        if self.done:
            mask = [False] * v
            mask[tokenizer.eos_id] = True
            for t in extra_allowed:
                mask[t] = True
            return mask

        cache = getattr(self, "_mask_cache", None)
        if cache is None or self._mask_tok is not tokenizer:
            cache = {}
            self._mask_cache = cache
            self._mask_tok = tokenizer
            # Group pieces by first character: if feeding a single char
            # fails, every piece starting with it fails — one probe per
            # distinct first char prunes the whole group. In skeleton
            # states (one legal char) this cuts a 32k-piece walk to
            # ~|alphabet| probes + one group's full checks.
            by_first: dict = {}
            for t in range(v):
                piece = tokenizer.decode_token(t)
                if piece:
                    by_first.setdefault(piece[0], []).append((t, piece))
            self._by_first = by_first
        key = self._state_key()
        mask = cache.get(key)
        if mask is None:
            mask = [False] * v
            for ch, group in self._by_first.items():
                if not self.allows(ch):
                    continue
                for t, piece in group:
                    if len(piece) == 1 or self.allows(piece):
                        mask[t] = True
            if self.at_end():
                mask[tokenizer.eos_id] = True
            cache[key] = mask
        if extra_allowed:
            mask = list(mask)
            for t in extra_allowed:
                mask[t] = True
        return mask


class ToolCallGrammar(CharGrammar):
    """Acceptor for ``{"tool_call":{"name":"<tool>","arguments":<obj>}}``.

    Stateful per generation: ``feed_text`` advances; ``allowed`` probes a
    candidate continuation without committing (used for token masking).

    ``tool_schemas`` optionally maps tool names to JSON Schemas for their
    arguments: once the generated name is closed, the arguments acceptor
    for a schema'd tool is a :class:`~trackiellm_tpu_torch.llm.schema.
    SchemaAcceptor` (typed tool calls — llama.cpp
    ``json_schema_to_grammar`` parity) instead of the generic
    :class:`JsonAcceptor`.
    """

    def __init__(self, tool_names: Sequence[str],
                 tool_schemas: Optional[dict] = None):
        if not tool_names:
            raise ValueError("ToolCallGrammar needs at least one tool name")
        self.tool_names = list(tool_names)
        self.tool_schemas = dict(tool_schemas or {})
        self._pre = '{"tool_call":{"name":"'
        self._mid = '","arguments":'
        self._post = "}}"
        self.reset()

    def reset(self) -> None:
        self.phase = "pre"   # pre -> name -> mid -> args -> post -> done
        self.pos = 0          # position within current literal phase
        self.name_buf = ""
        self.json = JsonAcceptor(root_object_only=True)

    def _args_acceptor(self, name: str):
        """The arguments acceptor for ``name`` (schema-typed if given)."""
        schema = self.tool_schemas.get(name)
        if schema is not None:
            from trackiellm_tpu_torch.llm.schema import SchemaAcceptor

            return SchemaAcceptor(schema)
        return JsonAcceptor(root_object_only=True)

    def _min_args(self, name: str) -> str:
        """Minimal valid arguments text for ``name`` (closures that fire
        before the arguments acceptor exists — "{}" is wrong for a
        schema with required properties)."""
        schema = self.tool_schemas.get(name)
        if schema is None:
            return "{}"
        from trackiellm_tpu_torch.llm.schema import (_min_value_text,
                                                     compile_schema)

        return _min_value_text(compile_schema(schema))

    # -- state snapshot (cheap, for probing) ---------------------------------
    def _snapshot(self):
        return (self.phase, self.pos, self.name_buf, self.json.copy())

    def _restore(self, snap) -> None:
        self.phase, self.pos, self.name_buf, self.json = snap

    @property
    def done(self) -> bool:
        return self.phase == "done"

    def feed_char(self, ch: str) -> bool:
        if self.phase == "pre":
            if ch != self._pre[self.pos]:
                return False
            self.pos += 1
            if self.pos == len(self._pre):
                self.phase, self.pos = "name", 0
            return True

        if self.phase == "name":
            cand = self.name_buf + ch
            # Must remain a prefix of some tool name, or close the name.
            if ch == '"':
                if self.name_buf in self.tool_names:
                    self.phase, self.pos = "mid", 1  # '"' consumed = mid[0]
                    self.json = self._args_acceptor(self.name_buf)
                    return True
                return False
            if any(n.startswith(cand) for n in self.tool_names):
                self.name_buf = cand
                return True
            return False

        if self.phase == "mid":
            if ch != self._mid[self.pos]:
                return False
            self.pos += 1
            if self.pos == len(self._mid):
                self.phase = "args"
            return True

        if self.phase == "args":
            ok = self.json.feed(ch)
            if ok and self.json.done:
                self.phase, self.pos = "post", 0
            return ok

        if self.phase == "post":
            if ch != self._post[self.pos]:
                return False
            self.pos += 1
            if self.pos == len(self._post):
                self.phase = "done"
            return True

        return False  # done: no more characters

    def closure(self) -> str:
        """Minimal completion of the current prefix into a full valid
        tool call (budget-forced close; see JsonAcceptor.closure)."""
        if self.phase == "done":
            return ""
        out = []
        if self.phase == "pre":
            out.append(self._pre[self.pos:])
            out.append(self.tool_names[0])
            out.append(self._mid)
            out.append(self._min_args(self.tool_names[0]))
            out.append(self._post)
        elif self.phase == "name":
            name = next(n for n in self.tool_names
                        if n.startswith(self.name_buf))
            out.append(name[len(self.name_buf):])
            out.append('"')
            out.append(self._mid[1:])
            out.append(self._min_args(name))
            out.append(self._post)
        elif self.phase == "mid":
            out.append(self._mid[self.pos:])
            out.append(self._min_args(self.name_buf))
            out.append(self._post)
        elif self.phase == "args":
            out.append(self.json.closure())
            out.append(self._post)
        elif self.phase == "post":
            out.append(self._post[self.pos:])
        text = "".join(out)
        assert self.allows(text), "grammar closure must be self-consistent"
        return text

    def _state_key(self):
        """Hashable signature of the full acceptor state. Inside a JSON
        string the accumulated content is irrelevant to what may come
        next, so the state space during generation is small — masks
        cache extremely well."""
        return (self.phase, self.pos, self.name_buf,
                self.json.state_key())


class JsonGrammar(CharGrammar):
    """Constrain a free response to valid JSON — optionally conforming
    to a JSON Schema (llama.cpp's ``response_format: json_object`` /
    ``json_schema`` parity, over the same acceptor machinery as the
    tool-call grammar).

    ``schema=None`` forces *some* JSON object (``json_object`` mode);
    with a schema the response must conform (root may be any schema'd
    type, including scalars and arrays).
    """

    def __init__(self, schema=None):
        self.schema = schema
        self.reset()

    def reset(self) -> None:
        if self.schema is not None:
            from trackiellm_tpu_torch.llm.schema import SchemaAcceptor

            self.json = SchemaAcceptor(self.schema)
        else:
            self.json = JsonAcceptor(root_object_only=True)

    @property
    def done(self) -> bool:
        return self.json.done

    def at_end(self) -> bool:
        # Root-level numbers / ambiguous enum literals can stop here
        # even though more characters could extend them: allow EOS.
        return self.json.at_end()

    def feed_char(self, ch: str) -> bool:
        return self.json.feed(ch)

    def _snapshot(self):
        return self.json.copy()

    def _restore(self, snap) -> None:
        self.json = snap

    def _state_key(self):
        return ("json", self.json.state_key())

    def closure(self) -> str:
        if self.done or self.at_end():
            return ""
        return self.json.closure()
