"""Tokenizers for the LLM runner.

Port of ``trackiellm_tpu/llm/tokenizer.py`` (``Tokenizer``,
``ByteTokenizer``, the SentencePiece-compatible ``VocabTokenizer`` and the
GPT-2-style byte-level ``BpeTokenizer`` with its llama-bpe, qwen2 and o200k
pre-tokenizers, and BERT's ``WordPieceTokenizer`` for the embedder) and of
``trackiellm_tpu/models/convert.py``'s ``tokenizer_from_pieces`` /
``tokenizer_from_spec``, which rebuild the tokenizer a converted checkpoint
names in its metadata. The JAX package's
``trackiellm_tpu.llm`` and ``trackiellm_tpu.models`` packages import JAX
when loaded, so these are carried here rather than imported.
"""

from __future__ import annotations

import functools
import heapq
import logging
import unicodedata
from typing import Any, Dict, List, Optional, Protocol, Sequence, Tuple

_SPACE_MARKER = "\u2581"  # SentencePiece's word-start marker

log = logging.getLogger("trackiellm_tpu_torch.llm.tokenizer")


class Tokenizer(Protocol):
    vocab_size: int
    bos_id: int
    eos_id: int
    pad_id: int

    def encode(self, text: str, add_bos: bool = False) -> List[int]: ...

    def decode(self, ids: Sequence[int]) -> str: ...

    def decode_token(self, token_id: int) -> str: ...


class ByteTokenizer:
    """UTF-8 byte tokenizer: ids 0-255 are raw bytes; specials follow."""

    def __init__(self, n_special_pad_to: int = 512):
        self.bos_id = 256
        self.eos_id = 257
        self.pad_id = 258
        self.vocab_size = max(n_special_pad_to, 259)

    def encode(self, text: str, add_bos: bool = False) -> List[int]:
        ids = list(text.encode("utf-8"))
        return ([self.bos_id] + ids) if add_bos else ids

    def decode(self, ids: Sequence[int]) -> str:
        data = bytes(i for i in ids if 0 <= i < 256)
        return data.decode("utf-8", errors="replace")

    def decode_token(self, token_id: int) -> str:
        if 0 <= token_id < 256:
            return bytes([token_id]).decode("utf-8", errors="replace")
        return ""

    def token_bytes(self, token_id: int) -> bytes:
        return bytes([token_id]) if 0 <= token_id < 256 else b""


# Token types, matching GGUF tokenizer.ggml.token_type / llama.cpp.
TOKEN_TYPE_NORMAL = 1
TOKEN_TYPE_UNKNOWN = 2
TOKEN_TYPE_CONTROL = 3
TOKEN_TYPE_USER_DEFINED = 4
TOKEN_TYPE_UNUSED = 5
TOKEN_TYPE_BYTE = 6


def _is_byte_piece(piece: str) -> bool:
    return (len(piece) == 6 and piece.startswith("<0x")
            and piece.endswith(">"))


class VocabTokenizer:
    """SentencePiece-compatible tokenizer over an explicit vocabulary.

    Two encode modes:

    - **Score-merge BPE** (when ``scores`` are provided): llama.cpp's
      ``llm_tokenizer_spm`` algorithm — start from unicode codepoints,
      repeatedly merge the adjacent pair whose concatenation is a vocab
      piece with the highest score (leftmost wins ties), then emit ids;
      spans with no piece fall back to ``<0xXX>`` byte tokens when the
      vocab has them, else ``unk``. This reproduces llama.cpp/Mistral
      segmentation exactly (greedy longest-match does NOT: it prefers
      long early pieces over higher-scoring later merges).
    - **Greedy longest-match** (no scores): legacy behavior for plain
      piece lists.

    Vocab file format for :meth:`load`: one piece per line (literal
    text; U+2581 is the SentencePiece space marker). Ids are line
    numbers after the specials block.
    """

    SPECIALS = ("<pad>", "<s>", "</s>", "<unk>")

    def __init__(self, pieces: Sequence[str],
                 scores: Optional[Sequence[float]] = None,
                 token_types: Optional[Sequence[int]] = None,
                 add_space_prefix: bool = True):
        raw = list(self.SPECIALS) + list(pieces)
        sc = (None if scores is None
              else [0.0] * len(self.SPECIALS) + list(scores))
        tt = (None if token_types is None
              else [TOKEN_TYPE_CONTROL] * len(self.SPECIALS)
              + list(token_types))
        self.pad_id, self.bos_id, self.eos_id, self.unk_id = 0, 1, 2, 3
        self._init_tables(raw, sc, tt, add_space_prefix,
                          n_specials=len(self.SPECIALS))

    def _init_tables(self, raw_pieces: List[str],
                     scores: Optional[List[float]],
                     token_types: Optional[List[int]],
                     add_space_prefix: bool, n_specials: int) -> None:
        """Shared setup for both vocab layouts (prepended specials and
        llama-native 0=unk/1=bos/2=eos)."""
        self._raw = [str(p) for p in raw_pieces]
        self.pieces = [p.replace(_SPACE_MARKER, " ") for p in self._raw]
        self.vocab_size = len(self._raw)
        self._scores = list(scores) if scores is not None else None
        self._types = list(token_types) if token_types is not None else None
        # The '▁' convention (and the llama dummy space prefix) only
        # applies to vocabs that actually use the marker; plain word
        # lists tokenize the text literally.
        self._uses_marker = any(_SPACE_MARKER in p for p in self._raw)
        self._add_space_prefix = add_space_prefix and self._uses_marker
        self._n_specials = n_specials

        def matchable(i: int, piece: str) -> bool:
            if not piece:
                return False
            if self._types is not None:
                return self._types[i] in (TOKEN_TYPE_NORMAL,
                                          TOKEN_TYPE_USER_DEFINED)
            # No type table: exclude obvious specials and byte pieces.
            if i < n_specials or i in (self.pad_id, self.bos_id,
                                       self.eos_id, self.unk_id):
                return False
            return not _is_byte_piece(piece)

        # Text-matchable pieces use the RAW form ('▁'-marked): the BPE
        # merge loop runs over normalized text.
        self._index: Dict[str, int] = {}
        for i, p in enumerate(self._raw):
            if matchable(i, p) and p not in self._index:
                self._index[p] = i
        self._max_len = max((len(p) for p in self._index), default=1)

        # Byte-fallback table: <0xXX> pieces, by byte value.
        self._byte_ids: Dict[int, int] = {}
        for i, p in enumerate(self._raw):
            if _is_byte_piece(p):
                try:
                    self._byte_ids[int(p[1:5], 16)] = i
                except ValueError:
                    pass

    @classmethod
    def load(cls, path: str) -> "VocabTokenizer":
        with open(path, "r", encoding="utf-8") as f:
            return cls([line.rstrip("\n") for line in f if line.rstrip("\n")])

    # -- encoding ----------------------------------------------------------

    def encode(self, text: str, add_bos: bool = False) -> List[int]:
        if self._scores is not None:
            ids = self._encode_bpe(text)
        else:
            ids = self._encode_greedy(text)
        return ([self.bos_id] + ids) if add_bos else ids

    def _normalize(self, text: str) -> str:
        if not self._uses_marker:
            return text
        # Dummy space prefix (sentencepiece add_dummy_prefix); its
        # companion remove_extra_whitespaces means an already-space-led
        # text gains no second marker.
        if self._add_space_prefix and text and not text[0].isspace():
            text = " " + text
        return text.replace(" ", _SPACE_MARKER)

    def _emit(self, span: str, out: List[int]) -> None:
        tid = self._index.get(span)
        if tid is not None:
            out.append(tid)
            return
        for b in span.encode("utf-8"):
            out.append(self._byte_ids.get(b, self.unk_id))

    def _encode_bpe(self, text: str) -> List[int]:
        """llama.cpp llm_tokenizer_spm: greedy highest-score pair merge.

        Symbols live in a doubly-linked list; a heap orders candidate
        merges by (score desc, left position asc). Stale entries (either
        side re-merged since queueing) are detected by length mismatch.
        """
        text = self._normalize(text)
        if not text:
            return []
        syms: List[str] = list(text)  # unicode codepoints
        n = len(syms)
        prev = list(range(-1, n - 1))
        nxt = [*range(1, n), -1]
        alive = [True] * n
        heap: List = []

        def try_add(lt: int, rt: int) -> None:
            if lt < 0 or rt < 0:
                return
            tid = self._index.get(syms[lt] + syms[rt])
            if tid is not None:
                heapq.heappush(heap, (-self._scores[tid], lt,
                                      len(syms[lt]), len(syms[rt])))

        for i in range(n - 1):
            try_add(i, i + 1)
        while heap:
            _, lt, llen, rlen = heapq.heappop(heap)
            rt = nxt[lt]
            if (rt < 0 or not alive[lt] or not alive[rt]
                    or len(syms[lt]) != llen or len(syms[rt]) != rlen):
                continue  # stale: one side was merged since queueing
            syms[lt] += syms[rt]
            alive[rt] = False
            nxt[lt] = nxt[rt]
            if nxt[rt] >= 0:
                prev[nxt[rt]] = lt
            try_add(prev[lt], lt)
            try_add(lt, nxt[lt])

        out: List[int] = []
        i = 0
        while i >= 0:
            self._emit(syms[i], out)
            i = nxt[i]
        return out

    def _encode_greedy(self, text: str) -> List[int]:
        text = self._normalize(text)
        ids: List[int] = []
        i = 0
        while i < len(text):
            match = None
            for ln in range(min(self._max_len, len(text) - i), 0, -1):
                cand = text[i:i + ln]
                if cand in self._index:
                    match = (self._index[cand], ln)
                    break
            if match is None:
                self._emit(text[i], ids)
                i += 1
            else:
                ids.append(match[0])
                i += match[1]
        return ids

    # -- decoding ----------------------------------------------------------

    def decode(self, ids: Sequence[int]) -> str:
        """Ids -> text. Byte-fallback tokens are reassembled at the byte
        level so multi-byte UTF-8 split across tokens round-trips."""
        data = bytearray()
        for i in ids:
            if not (0 <= i < self.vocab_size):
                continue
            if i in (self.pad_id, self.bos_id, self.eos_id, self.unk_id):
                continue
            raw = self._raw[i]
            if _is_byte_piece(raw):
                data.append(int(raw[1:5], 16))
            else:
                data.extend(self.pieces[i].encode("utf-8"))
        return data.decode("utf-8", errors="replace")

    def decode_token(self, token_id: int) -> str:
        if not (0 <= token_id < self.vocab_size):
            return ""
        if token_id in (self.pad_id, self.bos_id, self.eos_id):
            return ""
        raw = self._raw[token_id]
        if _is_byte_piece(raw):
            b = int(raw[1:5], 16)
            return chr(b) if b < 0x80 else ""
        return self.pieces[token_id]


# ---------------------------------------------------------------------------
# GPT-2-style byte-level BPE (llama.cpp llm_tokenizer_bpe)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=1)
def _bytes_to_unicode() -> Dict[int, str]:
    """The GPT-2 byte<->printable-unicode bijection: every possible byte
    maps to a visible codepoint so BPE vocab pieces are plain strings.
    (Identical table to the published GPT-2 encoder and llama.cpp's
    unicode_byte_to_utf8.)"""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return {b: chr(c) for b, c in zip(bs, cs)}


def _cat(ch: str) -> str:
    """Unicode major category: 'L' letter, 'N' number, 'Z'/'C' spaces."""
    return unicodedata.category(ch)[0]


def _is_ws(ch: str) -> bool:
    return ch.isspace()


def _pretokenize(text: str, digit_run: int) -> List[str]:
    """Hand-rolled scanner for the llama-bpe / qwen2 pre-tokenizer
    pattern (llama.cpp unicode_regex_split equivalent — Python's `re`
    lacks \\p{L}/\\p{N}, so the alternation is scanned directly):

      (?i:'s|'t|'re|'ve|'m|'ll|'d)
    | [^\\r\\n\\p{L}\\p{N}]?\\p{L}+
    | \\p{N}{1,digit_run}
    |  ?[^\\s\\p{L}\\p{N}]+[\\r\\n]*
    | \\s*[\\r\\n]+
    | \\s+(?!\\S)
    | \\s+

    digit_run: 3 for llama-bpe (Llama-3/GPT-4 style), 1 for qwen2.
    Exactness is pinned against the `tokenizers` Rust regex engine in
    tests/test_bpe_tokenizer.py."""
    out: List[str] = []
    i, n = 0, len(text)
    while i < n:
        c = text[i]
        # 1. English contractions (case-insensitive).
        if c == "'" and i + 1 < n:
            two = text[i:i + 2].lower()
            three = text[i:i + 3].lower()
            if three in ("'re", "'ve", "'ll"):
                out.append(text[i:i + 3]); i += 3; continue
            if two in ("'s", "'t", "'m", "'d"):
                out.append(text[i:i + 2]); i += 2; continue
        # 2. [^\r\n L N]? L+
        k = i
        if (c not in "\r\n" and _cat(c) not in ("L", "N")
                and i + 1 < n and _cat(text[i + 1]) == "L"):
            k = i + 1
        if k < n and _cat(text[k]) == "L":
            j = k
            while j < n and _cat(text[j]) == "L":
                j += 1
            out.append(text[i:j]); i = j; continue
        # 3. N{1,digit_run}
        if _cat(c) == "N":
            j = i
            while j < n and j - i < digit_run and _cat(text[j]) == "N":
                j += 1
            out.append(text[i:j]); i = j; continue
        # 4. ' '? [^ ws L N]+ [\r\n]*
        k = i + 1 if (c == " " and i + 1 < n) else i
        if (k < n and not _is_ws(text[k])
                and _cat(text[k]) not in ("L", "N")):
            j = k
            while (j < n and not _is_ws(text[j])
                   and _cat(text[j]) not in ("L", "N")):
                j += 1
            while j < n and text[j] in "\r\n":
                j += 1
            out.append(text[i:j]); i = j; continue
        # 5-7. whitespace runs.
        if _is_ws(c):
            j = i
            while j < n and _is_ws(text[j]):
                j += 1
            # \s*[\r\n]+ : a run whose TAIL is newlines keeps them.
            last_nl = -1
            for t in range(i, j):
                if text[t] in "\r\n":
                    last_nl = t
            if last_nl >= 0 and all(_is_ws(text[t])
                                    for t in range(i, last_nl)):
                # trailing non-newline ws after the last newline splits off
                if last_nl + 1 == j:
                    out.append(text[i:j]); i = j; continue
                out.append(text[i:last_nl + 1]); i = last_nl + 1; continue
            # \s+(?!\S): all but the last ws char when a non-ws follows.
            if j < n and j - i > 1:
                out.append(text[i:j - 1]); i = j - 1; continue
            out.append(text[i:j]); i = j; continue
        # Fallback: single char (no alternative matched).
        out.append(c); i += 1
    return out


def _is_up(ch: str) -> bool:
    r"""o200k 'uppercase-ish' class: [\p{Lu}\p{Lt}\p{Lm}\p{Lo}\p{M}]."""
    k = unicodedata.category(ch)
    return k in ("Lu", "Lt", "Lm", "Lo") or k[0] == "M"


def _is_lo(ch: str) -> bool:
    r"""o200k 'lowercase-ish' class: [\p{Ll}\p{Lm}\p{Lo}\p{M}]."""
    k = unicodedata.category(ch)
    return k in ("Ll", "Lm", "Lo") or k[0] == "M"


def _pretokenize_o200k(text: str) -> List[str]:
    r"""Hand-rolled scanner for the o200k_base pre-tokenizer (tiktoken;
    the tokenizer of GPT-4o and Llama-4 — llama.cpp pre id "llama4"):

      [^\r\n\p{L}\p{N}]?[UP]*[LO]+(?i:'s|'t|'re|'ve|'m|'ll|'d)?
    | [^\r\n\p{L}\p{N}]?[UP]+[LO]*(?i:'s|'t|'re|'ve|'m|'ll|'d)?
    | \p{N}{1,3}
    |  ?[^\s\p{L}\p{N}]+[\r\n/]*
    | \s*[\r\n]+
    | \s+(?!\S)
    | \s+

    with UP = Lu Lt Lm Lo M and LO = Ll Lm Lo M. The two letter
    branches combined always match the greedy UP-run followed by the
    LO-run (ordered alternation + backtracking collapse to that), with
    an optional case-insensitive contraction suffix GLUED to the word
    (unlike llama-bpe, which splits contractions off). Exactness is
    pinned against the `tokenizers` Rust regex engine in
    tests/test_bpe_tokenizer.py."""
    out: List[str] = []
    i, n = 0, len(text)

    def letters_end(j: int) -> int:
        e = j
        while e < n and _is_up(text[e]):
            e += 1
        while e < n and _is_lo(text[e]):
            e += 1
        return e

    def contraction_end(j: int) -> int:
        low3 = text[j:j + 3].lower()
        if low3 in ("'re", "'ve", "'ll"):
            return j + 3
        if text[j:j + 2].lower() in ("'s", "'t", "'m", "'d"):
            return j + 2
        return j

    while i < n:
        c = text[i]
        k = _cat(c)
        # Letter branches, optional one-char prefix (greedy ?).
        if c not in "\r\n" and k not in ("L", "N") and i + 1 < n:
            e = letters_end(i + 1)
            if e > i + 1:
                out.append(text[i:contraction_end(e)])
                i = contraction_end(e)
                continue
        e = letters_end(i)
        if e > i:
            out.append(text[i:contraction_end(e)])
            i = contraction_end(e)
            continue
        # \p{N}{1,3}
        if k == "N":
            j = i
            while j < n and j - i < 3 and _cat(text[j]) == "N":
                j += 1
            out.append(text[i:j]); i = j; continue
        # ' '? [^\s L N]+ [\r\n/]*
        p0 = i + 1 if (c == " " and i + 1 < n) else i
        if (p0 < n and not _is_ws(text[p0])
                and _cat(text[p0]) not in ("L", "N")):
            j = p0
            while (j < n and not _is_ws(text[j])
                   and _cat(text[j]) not in ("L", "N")):
                j += 1
            while j < n and text[j] in "\r\n/":
                j += 1
            out.append(text[i:j]); i = j; continue
        # Whitespace alternatives (same as llama-bpe).
        if _is_ws(c):
            j = i
            while j < n and _is_ws(text[j]):
                j += 1
            last_nl = -1
            for t in range(i, j):
                if text[t] in "\r\n":
                    last_nl = t
            if last_nl >= 0 and all(_is_ws(text[t])
                                    for t in range(i, last_nl)):
                if last_nl + 1 == j:
                    out.append(text[i:j]); i = j; continue
                out.append(text[i:last_nl + 1]); i = last_nl + 1; continue
            if j < n and j - i > 1:
                out.append(text[i:j - 1]); i = j - 1; continue
            out.append(text[i:j]); i = j; continue
        out.append(c); i += 1
    return out


class BpeTokenizer:
    """GPT-2-style byte-level BPE over a GGUF vocab + merge list — the
    tokenizer family of Llama-3, Qwen2/Qwen2-MoE, and every other
    ``tokenizer.ggml.model == "gpt2"`` checkpoint (llama.cpp:
    llm_tokenizer_bpe; reference inherits it via llama.cpp).

    ``tokens``: vocab strings in the GPT-2 byte-repr space ("Ġ" =
    space). ``merges``: "left right" strings, rank = list index.
    ``pre``: "llama-bpe" (default, 1-3 digit runs) or "qwen2" (single
    digits). Control tokens (``token_types`` 3, e.g. <|im_start|>) are
    matched literally before pre-tokenization, exactly like llama.cpp's
    special-token scan."""

    def __init__(self, tokens: Sequence[str],
                 merges: Sequence[str],
                 pre: str = "llama-bpe",
                 token_types: Optional[Sequence[int]] = None,
                 bos_id: int = 0, eos_id: int = 0, pad_id: int = 0):
        self._pieces = [str(t) for t in tokens]
        self._ids = {t: i for i, t in enumerate(self._pieces)}
        self._ranks: Dict[Tuple[str, str], int] = {}
        for r, m in enumerate(merges):
            left, _, right = str(m).partition(" ")
            self._ranks[(left, right)] = r
        self.vocab_size = len(self._pieces)
        self.bos_id, self.eos_id, self.pad_id = bos_id, eos_id, pad_id
        # llama.cpp defines dozens of "pre" ids; the implemented
        # scanners cover the framework's LLM families (Llama-3, the
        # Qwen2 line, and the o200k/tiktoken family: GPT-4o + Llama-4).
        # Anything else gets the llama-bpe scanner with a warning —
        # ids will be close but not guaranteed exact.
        self._o200k = pre in ("llama4", "gpt-4o", "o200k")
        if pre not in ("llama-bpe", "qwen2", "default", "gpt-2",
                       "llama4", "gpt-4o", "o200k"):
            log.warning(
                "unknown BPE pre-tokenizer %r: falling back to the "
                "llama-bpe scanner (token ids may differ from "
                "llama.cpp for this family)", pre)
        self._digit_run = 1 if pre == "qwen2" else 3
        self._b2u = _bytes_to_unicode()
        self._u2b = {c: b for b, c in self._b2u.items()}
        self._specials = sorted(
            (self._pieces[i] for i in range(len(self._pieces))
             if token_types is not None and int(token_types[i]) == 3
             and self._pieces[i]),
            key=len, reverse=True)

    def _bpe(self, piece: str) -> List[int]:
        """Merge-by-rank on one pre-token (already byte-repr chars)."""
        if piece in self._ids:        # whole-piece fast path
            return [self._ids[piece]]
        parts = list(piece)
        while len(parts) > 1:
            best, best_i = None, -1
            for i in range(len(parts) - 1):
                r = self._ranks.get((parts[i], parts[i + 1]))
                if r is not None and (best is None or r < best):
                    best, best_i = r, i
            if best is None:
                break
            parts[best_i:best_i + 2] = [parts[best_i] + parts[best_i + 1]]
        out = []
        for p in parts:
            if p in self._ids:
                out.append(self._ids[p])
            else:  # unmergeable multi-char fragment: per-char ids
                out.extend(self._ids[c] for c in p if c in self._ids)
        return out

    def _encode_span(self, text: str, out: List[int]) -> None:
        for pre_tok in (_pretokenize_o200k(text) if self._o200k
                        else _pretokenize(text, self._digit_run)):
            repr_str = "".join(self._b2u[b] for b in pre_tok.encode("utf-8"))
            out.extend(self._bpe(repr_str))

    def encode(self, text: str, add_bos: bool = False) -> List[int]:
        out: List[int] = [self.bos_id] if add_bos else []
        spans = [text]
        for sp in self._specials:
            nxt: List[str] = []
            for s in spans:
                if isinstance(s, int) or sp not in s:
                    nxt.append(s)
                    continue
                parts = s.split(sp)
                for j, part in enumerate(parts):
                    if part:
                        nxt.append(part)
                    if j < len(parts) - 1:
                        nxt.append(self._ids[sp])
            spans = nxt
        for s in spans:
            if isinstance(s, int):
                out.append(s)
            else:
                self._encode_span(s, out)
        return out

    def token_bytes(self, token_id: int) -> bytes:
        piece = self._pieces[token_id]
        try:
            return bytes(self._u2b[c] for c in piece)
        except KeyError:  # control/special tokens are literal text
            return piece.encode("utf-8")

    def decode(self, ids: Sequence[int]) -> str:
        return b"".join(self.token_bytes(int(i)) for i in ids
                        if 0 <= int(i) < self.vocab_size).decode(
                            "utf-8", errors="replace")

    def decode_token(self, token_id: int) -> str:
        return self.token_bytes(token_id).decode("utf-8",
                                                 errors="replace")


def tokenizer_from_pieces(pieces, pad_id: int = 0, scores=None,
                          token_types=None, add_space_prefix: bool = True):
    """A VocabTokenizer over raw SentencePiece pieces, with llama's
    positional ids (0 unk, 1 bos, 2 eos). With ``scores`` (GGUF
    ``tokenizer.ggml.scores``) encoding runs llama.cpp's score-merge BPE;
    without them, greedy longest-match."""
    tok = VocabTokenizer.__new__(VocabTokenizer)
    tok.unk_id, tok.bos_id, tok.eos_id = 0, 1, 2
    tok.pad_id = pad_id
    tok._init_tables([str(t) for t in pieces],
                     list(scores) if scores is not None else None,
                     list(token_types) if token_types is not None else None,
                     add_space_prefix, n_specials=3)
    return tok


def tokenizer_from_spec(spec: Dict[str, Any]):
    """Rebuild the tokenizer that a converted checkpoint's
    ``tokenizer_spec`` metadata describes (``model`` "gpt2": byte-level
    BPE; otherwise SentencePiece pieces)."""
    if spec.get("model") == "gpt2":
        return BpeTokenizer(
            spec["tokens"], merges=spec.get("merges", []),
            pre=spec.get("pre", "llama-bpe"),
            token_types=spec.get("token_types"),
            bos_id=spec.get("bos_id", 0), eos_id=spec.get("eos_id", 0),
            pad_id=spec.get("pad_id", 0))
    return tokenizer_from_pieces(
        spec["tokens"], pad_id=spec.get("pad_id", 0),
        scores=spec.get("scores"),
        token_types=spec.get("token_types"),
        add_space_prefix=spec.get("add_space_prefix", True))


class WordPieceTokenizer:
    """BERT WordPiece — the tokenizer of llama.cpp's ``bert``
    embedding-model family (``tokenizer.ggml.model == "bert"``,
    llm_tokenizer_wpm; the HF BertTokenizer contract).

    Pipeline (uncased models, ``lower=True``): clean control chars ->
    lowercase -> NFD + strip combining marks -> isolate CJK chars and
    punctuation -> whitespace split -> greedy longest-match WordPiece
    with "##" continuations; unmatched words become [UNK].
    ``encode_with_special`` wraps the ids in [CLS] ... [SEP] (what the
    encoder actually consumes)."""

    def __init__(self, tokens: Sequence[str], lower: bool = True,
                 max_word_chars: int = 200,
                 unk_id: Optional[int] = None,
                 cls_id: Optional[int] = None,
                 sep_id: Optional[int] = None,
                 pad_id: Optional[int] = None):
        self._pieces = [str(t) for t in tokens]
        self._ids = {t: i for i, t in enumerate(self._pieces)}
        self.vocab_size = len(self._pieces)
        self.lower = lower
        self.max_word_chars = max_word_chars

        def find(name, fallback):
            return self._ids.get(name, fallback)

        self.unk_id = unk_id if unk_id is not None else find("[UNK]", 0)
        self.cls_id = cls_id if cls_id is not None else find("[CLS]", 0)
        self.sep_id = sep_id if sep_id is not None else find("[SEP]", 0)
        self.pad_id = pad_id if pad_id is not None else find("[PAD]", 0)
        # Protocol compat: BOS/EOS map to CLS/SEP.
        self.bos_id, self.eos_id = self.cls_id, self.sep_id

    # --- basic tokenization (HF BasicTokenizer semantics) -------------

    @staticmethod
    def _is_punct(ch: str) -> bool:
        cp = ord(ch)
        if (33 <= cp <= 47 or 58 <= cp <= 64 or 91 <= cp <= 96
                or 123 <= cp <= 126):
            return True
        return unicodedata.category(ch).startswith("P")

    @staticmethod
    def _is_cjk(cp: int) -> bool:
        return (0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF
                or 0x20000 <= cp <= 0x2A6DF or 0x2A700 <= cp <= 0x2B73F
                or 0x2B740 <= cp <= 0x2B81F or 0x2B820 <= cp <= 0x2CEAF
                or 0xF900 <= cp <= 0xFAFF or 0x2F800 <= cp <= 0x2FA1F)

    def _words(self, text: str) -> List[str]:
        out: List[str] = []
        for ch in text:
            cp = ord(ch)
            if cp == 0 or cp == 0xFFFD:
                continue
            cat = unicodedata.category(ch)
            if cat in ("Cc", "Cf") and ch not in "\t\n\r":
                continue
            if ch.isspace():
                out.append(" ")
            elif self._is_cjk(cp):
                out.extend((" ", ch, " "))
            else:
                out.append(ch)
        text = "".join(out)
        if self.lower:
            text = text.lower()
            text = unicodedata.normalize("NFD", text)
            text = "".join(c for c in text
                           if unicodedata.category(c) != "Mn")
        words: List[str] = []
        for tok in text.split():
            run = ""
            for ch in tok:
                if self._is_punct(ch):
                    if run:
                        words.append(run)
                        run = ""
                    words.append(ch)
                else:
                    run += ch
            if run:
                words.append(run)
        return words

    def _wordpiece(self, word: str) -> List[int]:
        if len(word) > self.max_word_chars:
            return [self.unk_id]
        ids: List[int] = []
        start = 0
        while start < len(word):
            end = len(word)
            cur = None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self._ids:
                    cur = self._ids[sub]
                    break
                end -= 1
            if cur is None:
                return [self.unk_id]
            ids.append(cur)
            start = end
        return ids

    def encode(self, text: str, add_bos: bool = False) -> List[int]:
        ids: List[int] = []
        for w in self._words(text):
            ids.extend(self._wordpiece(w))
        if add_bos:
            ids.insert(0, self.cls_id)
        return ids

    def encode_with_special(self, text: str) -> List[int]:
        """[CLS] tokens [SEP] — the sequence BERT encoders consume."""
        return [self.cls_id] + self.encode(text) + [self.sep_id]

    def decode(self, ids: Sequence[int]) -> str:
        parts: List[str] = []
        for i in ids:
            i = int(i)
            if not (0 <= i < self.vocab_size):
                continue
            if i in (self.cls_id, self.sep_id, self.pad_id):
                continue
            p = self._pieces[i]
            if p.startswith("##"):
                parts.append(p[2:])
            else:
                if parts:
                    parts.append(" ")
                parts.append(p)
        return "".join(parts)

    def decode_token(self, token_id: int) -> str:
        if not (0 <= token_id < self.vocab_size):
            return ""
        return self._pieces[token_id]
