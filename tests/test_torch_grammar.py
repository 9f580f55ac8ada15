"""The port's grammar and schema copies, and grammar-constrained replies of
its LLMRunner, against the JAX package's.

The copies must accept and reject the same strings, give the same
``closure()`` and the same ``token_mask`` at every prefix. Forced tool
calls (with and without argument schemas), ``json_mode`` and
``response_schema`` replies must be byte-identical to the JAX runner's on
LLMConfig.tiny() in f32 (Q4 at group 64, seed 3, bridged byte for byte;
the weights of tests/test_torch_runner.py), greedy, at lookahead 1 and 4,
with ``min_tokens`` and with a budget small enough to force the closure.
"""

import json

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from trackiellm_tpu.llm import grammar as jgrammar
from trackiellm_tpu.llm import runner as jrunner
from trackiellm_tpu.llm import schema as jschema
from trackiellm_tpu.llm.tokenizer import ByteTokenizer as JByteTokenizer
from trackiellm_tpu.models import llm as jllm
from trackiellm_tpu.utils.errors import TrackieError as JTrackieError
from trackiellm_tpu_torch.llm import grammar as tgrammar
from trackiellm_tpu_torch.llm import runner as trunner
from trackiellm_tpu_torch.llm import schema as tschema
from trackiellm_tpu_torch.llm.runner import (GenerationConfig, LLMRunner,
                                             ToolDefinition)
from trackiellm_tpu_torch.llm.tokenizer import ByteTokenizer
from trackiellm_tpu_torch.models import llm as tllm
from trackiellm_tpu_torch.models.bridge import params_from_jax
from trackiellm_tpu_torch.utils.errors import TrackieError

SCHEMA_GO = {"type": "object",
             "properties": {"dir": {"type": "string",
                                    "enum": ["left", "right", "ahead"]},
                            "meters": {"type": "number"},
                            "urgent": {"type": "boolean"}},
             "required": ["dir"]}
SCHEMA_SAY = {"type": "object",
              "properties": {"text": {"type": "string"},
                             "lang": {"type": "string"}},
              "required": ["text"]}
RESPONSE_SCHEMA = {"type": "object",
                   "properties": {"hazard": {"type": "string"},
                                  "distance_m": {"type": "number"},
                                  "objects": {"type": "array",
                                              "items": {"type": "string"},
                                              "maxItems": 3}},
                   "required": ["hazard", "objects"]}
TOOLS = (("go", "move the user", {"dir": "left, right or ahead"}, SCHEMA_GO),
         ("say", "speak a sentence", {"text": "the sentence"}, SCHEMA_SAY),
         ("stop", "stop and wait", {}, None))

# name: (build from a grammar module and the schema module, strings)
GRAMMARS = {
    "json_acceptor": (lambda g, s: g.JsonAcceptor(),
                      ['{"a": [1, 2.5e3, true, null], "b": {"c": "x\\"y"}}',
                       '{"a": 01}', '[1]', '{"k": -0.5e-2 }  x',
                       '{"u": "\\u00e9\\n", "t": fals}']),
    "schema_acceptor": (lambda g, s: s.SchemaAcceptor(RESPONSE_SCHEMA),
                        ['{"hazard": "car", "objects": ["a", "b"]}',
                         '{"hazard":"x","distance_m":2.5,"objects":[]}',
                         '{"objects": []}',
                         '{"hazard":"x","objects":["a","b","c","d"]}']),
    "tool_call": (lambda g, s: g.ToolCallGrammar(["go", "say", "stop"]),
                  ['{"tool_call":{"name":"go","arguments":{"x":[1,{}]}}}',
                   '{"tool_call":{"name":"run","arguments":{}}}',
                   '{"tool_call":{"name":"say","arguments":{"text":"oi"}}}',
                   '{"tool_call": {"name":"stop"}}']),
    "tool_call_schema": (
        lambda g, s: g.ToolCallGrammar(["go", "say", "stop"],
                                       {"go": SCHEMA_GO, "say": SCHEMA_SAY}),
        ['{"tool_call":{"name":"go","arguments":{"dir":"left","meters":2}}}',
         '{"tool_call":{"name":"go","arguments":{"dir":"up"}}}',
         '{"tool_call":{"name":"say","arguments":{"text":"oi","lang":"pt"}}}',
         '{"tool_call":{"name":"stop","arguments":{"any":[true]}}}',
         '{"tool_call":{"name":"go","arguments":{"meters":1}}}']),
    "json_grammar": (lambda g, s: g.JsonGrammar(),
                     ['{"reply": "ok", "n": [1, 2]}', ' \n{"a":{}}',
                      '"text"', '{"a": tru}']),
    "json_grammar_schema": (
        lambda g, s: g.JsonGrammar(RESPONSE_SCHEMA),
        ['{"hazard":"stairs","distance_m":1.5,"objects":["rail"]}',
         '{"hazard":"x"}', '{"hazard":"x","objects":[1]}']),
}
CASES = [(name, i) for name, (_, texts) in GRAMMARS.items()
         for i in range(len(texts))]


def _feed(g, ch):
    return g.feed(ch) if hasattr(g, "feed") else g.feed_char(ch)


def _state(g, tokenizer):
    """What the two copies must agree on at one prefix (not the state keys:
    a schema acceptor's holds the identity of its compiled nodes)."""
    if hasattr(g, "token_mask"):
        return (g.done, g.at_end(), g.closure(),
                list(g.token_mask(tokenizer)))
    return (g.done, g.at_end(),
            None if g.done or g.failed else g.closure())


@pytest.mark.parametrize("name,i", CASES)
def test_grammar_copies_agree(name, i):
    """Char by char until the first rejection: the same verdict, closure
    and token mask (ByteTokenizer over tiny's 512 ids) at every
    prefix."""
    build, texts = GRAMMARS[name]
    text = texts[i]
    jg, tg = build(jgrammar, jschema), build(tgrammar, tschema)
    jtok, ttok = JByteTokenizer(512), ByteTokenizer(512)
    assert _state(tg, ttok) == _state(jg, jtok)
    for ch in text:
        ok = _feed(tg, ch)
        assert ok == _feed(jg, ch)
        if not ok:
            break
        assert _state(tg, ttok) == _state(jg, jtok)


def test_token_mask_is_cached_and_shared():
    """One list per grammar state (the runner keys its device copies on
    it); a closed grammar allows only EOS."""
    tok = ByteTokenizer(512)
    g = tgrammar.ToolCallGrammar(["go"])
    a = g.token_mask(tok)
    assert g.token_mask(tok) is a and sum(a) == 1 and a[ord("{")]
    g.feed_text('{"tool_call":{"name":"go","arguments":{}}}')
    assert g.done
    done = g.token_mask(tok)
    assert done[tok.eos_id] and sum(done) == 1


# --- the runner -------------------------------------------------------------

_PARAMS = {}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes: one intra-op thread, so this file does not crowd the
    other test workers' CPUs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _params():
    if not _PARAMS:
        cfg = jllm.LLMConfig.tiny()
        p = jllm.quantize_params(
            jllm.init_params(jax.random.PRNGKey(3), cfg, dtype=jnp.float32),
            bits=4, group=64)
        _PARAMS["tiny"] = (cfg, p, params_from_jax(p))
    return _PARAMS["tiny"]


def _pair(lookahead, eos_id=None, **gen_kw):
    """A JAX runner and a port runner on the same weights, greedy, without
    speculation (constrained replies never speculate)."""
    cfg, jp, tp = _params()
    gen_kw.setdefault("temperature", 0.0)
    gen_kw.setdefault("max_tokens", 48)
    gen_kw.setdefault("speculative", False)
    jtok, ttok = JByteTokenizer(cfg.vocab_size), ByteTokenizer(cfg.vocab_size)
    if eos_id is not None:
        jtok.eos_id = ttok.eos_id = eos_id
    jr = jrunner.LLMRunner(jp, cfg, jtok, jrunner.GenerationConfig(
        lookahead=lookahead, **gen_kw), cache_dtype=jnp.float32)
    tr = LLMRunner(tp, tllm.LLMConfig(**cfg._asdict()), ttok,
                   GenerationConfig(lookahead=lookahead, **gen_kw),
                   cache_dtype=torch.float32)
    return jr, tr


def _tools(module, schemas=True):
    return [module.ToolDefinition(n, d, p, s if schemas else None)
            for n, d, p, s in TOOLS]


MODES = {
    "tool_call": lambda m: {"tools": _tools(m, False),
                            "force_tool_call": True},
    "tool_call_schema": lambda m: {"tools": _tools(m),
                                   "force_tool_call": True},
    "json_mode": lambda m: {"json_mode": True},
    "response_schema": lambda m: {"response_schema": RESPONSE_SCHEMA},
}
PROMPT = "Context: a door 3 m ahead. Where should I go?"


def _both(jr, tr, mode, prompt=PROMPT):
    out_j = jr.generate(prompt, **MODES[mode](jrunner))
    out_t = tr.generate(prompt, **MODES[mode](trunner))
    return out_j, out_t


def _assert_same(jr, tr, out_j, out_t):
    assert out_t.encode() == out_j.encode()
    assert tr._generated_ids == jr._generated_ids
    assert tr._committed_ids == jr._committed_ids
    assert tr.cache.length == tr._host_len == int(jr.cache.length)


def _conforms(mode, text):
    """The reply parses, and a schema'd one has its required keys."""
    obj = json.loads(text)
    if mode.startswith("tool_call"):
        call = obj["tool_call"]
        assert call["name"] in {n for n, *_ in TOOLS}
        schema = dict((n, s) for n, _, _, s in TOOLS)[call["name"]]
        if mode == "tool_call_schema" and schema:
            assert set(schema["required"]) <= set(call["arguments"])
            assert set(call["arguments"]) <= set(schema["properties"])
    elif mode == "response_schema":
        assert {"hazard", "objects"} <= set(obj)
    return obj


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("lookahead", [1, 4])
def test_constrained_reply_matches_jax_runner(mode, lookahead):
    jr, tr = _pair(lookahead)
    out_j, out_t = _both(jr, tr, mode)
    _assert_same(jr, tr, out_j, out_t)
    _conforms(mode, out_t)
    if mode.startswith("tool_call"):
        assert tr.parse_tool_call() == jr.parse_tool_call() is not None
    assert tr.text == out_t


@pytest.mark.parametrize("mode", ["tool_call_schema", "json_mode"])
def test_constrained_reply_with_min_tokens(mode):
    """min_tokens ANDs the EOS ban into the grammar mask."""
    jr, tr = _pair(4, min_tokens=12)
    out_j, out_t = _both(jr, tr, mode)
    _assert_same(jr, tr, out_j, out_t)
    assert len(tr._generated_ids) >= 12


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("max_tokens", [8, 20])
def test_budget_forces_the_closure(mode, max_tokens):
    """A budget too small for the model's own reply ends with the
    grammar's shortest completion, still valid JSON."""
    jr, tr = _pair(1, max_tokens=max_tokens)
    out_j, out_t = _both(jr, tr, mode)
    _assert_same(jr, tr, out_j, out_t)
    _conforms(mode, out_t)
    assert tr._n_emitted == max_tokens


def test_tool_call_then_tool_response_matches_jax_runner():
    """The cortex's two steps: a forced tool call, its result re-injected
    with add_tool_response, then a free follow-up and a chat turn."""
    jr, tr = _pair(4)
    out_j, out_t = _both(jr, tr, "tool_call_schema")
    _assert_same(jr, tr, out_j, out_t)
    call = tr.parse_tool_call()
    jr.add_tool_response(call["name"], {"ok": True, "eta_s": 4})
    tr.add_tool_response(call["name"], {"ok": True, "eta_s": 4})
    assert tr._grammar is None
    more_j = [jr.generate_next_token() for _ in range(8)]
    more_t = [tr.generate_next_token() for _ in range(8)]
    assert more_t == more_j
    assert tr.chat("e agora?") == jr.chat("e agora?")
    assert tr._committed_ids == jr._committed_ids


def test_sampled_constrained_reply_is_seeded_and_valid():
    """At temperature 0.7 the port draws from its own generator: two runs
    with one seed give the same text, and it conforms."""
    texts = []
    for _ in range(2):
        _, tr = _pair(1, temperature=0.7, seed=11, max_tokens=40)
        texts.append(tr.generate(PROMPT, response_schema=RESPONSE_SCHEMA))
    assert texts[0] == texts[1]
    _conforms("response_schema", texts[0])


def test_grammar_arguments_are_checked_like_jax():
    jr, tr = _pair(1)
    with pytest.raises(TrackieError):
        tr.generate(PROMPT, force_tool_call=True)
    with pytest.raises(JTrackieError):
        jr.generate(PROMPT, force_tool_call=True)
    with pytest.raises(TrackieError):
        tr.generate(PROMPT, tools=_tools(trunner), force_tool_call=True,
                    json_mode=True)
    tr.reset()
    assert tr._grammar is None


def test_tool_definition_schema_and_prompt():
    t = ToolDefinition("go", "move", {"dir": "where"}, SCHEMA_GO)
    j = jrunner.ToolDefinition("go", "move", {"dir": "where"}, SCHEMA_GO)
    assert t.render() == j.render()
    assert ToolDefinition("x", "y", {}).schema is None
    jr, tr = _pair(1)
    assert tr.build_prompt("s", "c", "u", _tools(trunner)) == jr.build_prompt(
        "s", "c", "u", _tools(jrunner))


def test_mask_device_copies_follow_the_grammar_state():
    """The runner copies each grammar state's mask to the device once and
    drops the copies when a new reply arms its grammar."""
    _, tr = _pair(1)
    tr.generate(PROMPT, **MODES["tool_call"](trunner))
    n_states = len(tr._mask_dev)
    assert 0 < n_states <= len(tr._generated_ids)
    for mask, dev in tr._mask_dev.values():
        assert np.array_equal(dev.numpy(), np.array(mask, bool))
    tr.prepare_generation(PROMPT)
    assert tr._mask_dev == {}
