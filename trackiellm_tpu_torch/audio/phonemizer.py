"""Grapheme-to-phoneme front end for TTS.

A copy of ``trackiellm_tpu/audio/phonemizer.py``, which uses no JAX.

Parity target: the reference's Piper TTS phonemizes input text through
espeak-ng before synthesis, selected by a language code ("en", "pt")
(reference: src/audio/tk_tts_piper.h:50 — language config;
tk_tts_piper.c:224 — language stored per context). espeak-ng is not in
this image, so the front end is a self-contained rule-based G2P for the
two reference locales:

  - ``pt`` — Brazilian Portuguese. The orthography is regular enough
    that rules get close: digraphs (ch/lh/nh/rr/ss/qu/gu), contextual
    c/g/s, vowel nasalisation before coda m/n, final-vowel reduction
    (o->u, e->i), palatalised ti/di, coda-l vocalisation.
  - ``en`` — heuristic letter-to-sound rules with the common digraphs
    and a magic-e long-vowel check. Not a dictionary system; good
    enough to give the acoustic model a phonemic (not orthographic)
    input space.

Numbers are expanded to words per language before G2P (espeak does the
same internally). Output symbols come from one shared ``PHONEMES``
inventory so a single acoustic model can serve both languages.
"""

from __future__ import annotations

import re
from typing import List, Tuple

import numpy as np

# Shared inventory: index 0 is the pad, index 1 the word boundary.
PHONEMES: List[str] = [
    "_", " ", ".", ",", "!", "?",
    # oral vowels
    "a", "ɐ", "e", "ɛ", "i", "ɪ", "o", "ɔ", "u", "ʊ", "ə", "æ", "ʌ", "ɑ",
    # diphthongs (en)
    "eɪ", "aɪ", "ɔɪ", "aʊ", "oʊ",
    # nasal vowels (pt)
    "ɐ̃", "ẽ", "ĩ", "õ", "ũ",
    # consonants
    "p", "b", "t", "d", "k", "g", "f", "v", "s", "z", "ʃ", "ʒ", "x", "h",
    "m", "n", "ɲ", "ŋ", "l", "ʎ", "ɾ", "r", "w", "j", "tʃ", "dʒ", "θ", "ð",
]
_PH_INDEX = {p: i for i, p in enumerate(PHONEMES)}

_VOWELS_PT = set("aeiouáéíóúâêôãõà")
_NASAL_MAP = {"a": "ɐ̃", "e": "ẽ", "i": "ĩ", "o": "õ", "u": "ũ",
              "â": "ɐ̃", "ê": "ẽ", "ô": "õ", "ã": "ɐ̃", "õ": "õ",
              "é": "ẽ", "ó": "õ", "í": "ĩ", "ú": "ũ"}
# Lexical exceptions the rules cannot derive (espeak ships a whole
# dictionary; these are the high-frequency irregulars from the gold
# lexicon + everyday assistant vocabulary).
_PT_EXCEPTIONS = {
    "muito": ["m", "ũ", "j", "t", "u"],
    "muita": ["m", "ũ", "j", "t", "ɐ"],
    "muitos": ["m", "ũ", "j", "t", "u", "s"],
    "muitas": ["m", "ũ", "j", "t", "ɐ", "s"],
}
_PT_VOWEL = {"a": "a", "á": "a", "à": "a", "â": "ɐ", "ã": "ɐ̃",
             "e": "e", "é": "ɛ", "ê": "e",
             "i": "i", "í": "i",
             "o": "o", "ó": "ɔ", "ô": "o", "õ": "õ",
             "u": "u", "ú": "u"}


# ---------------------------------------------------------------------------
# Number expansion
# ---------------------------------------------------------------------------

_PT_UNITS = ["zero", "um", "dois", "três", "quatro", "cinco", "seis",
             "sete", "oito", "nove", "dez", "onze", "doze", "treze",
             "catorze", "quinze", "dezesseis", "dezessete", "dezoito",
             "dezenove"]
_PT_TENS = ["", "", "vinte", "trinta", "quarenta", "cinquenta",
            "sessenta", "setenta", "oitenta", "noventa"]
_PT_HUNDREDS = ["", "cento", "duzentos", "trezentos", "quatrocentos",
                "quinhentos", "seiscentos", "setecentos", "oitocentos",
                "novecentos"]

_EN_UNITS = ["zero", "one", "two", "three", "four", "five", "six",
             "seven", "eight", "nine", "ten", "eleven", "twelve",
             "thirteen", "fourteen", "fifteen", "sixteen", "seventeen",
             "eighteen", "nineteen"]
_EN_TENS = ["", "", "twenty", "thirty", "forty", "fifty", "sixty",
            "seventy", "eighty", "ninety"]


def _pt_under_1000(n: int) -> str:
    if n < 20:
        return _PT_UNITS[n]
    if n < 100:
        t, u = divmod(n, 10)
        return _PT_TENS[t] + (f" e {_PT_UNITS[u]}" if u else "")
    if n == 100:
        return "cem"
    h, rest = divmod(n, 100)
    s = _PT_HUNDREDS[h]
    return s + (f" e {_pt_under_1000(rest)}" if rest else "")


def _en_under_1000(n: int) -> str:
    if n < 20:
        return _EN_UNITS[n]
    if n < 100:
        t, u = divmod(n, 10)
        return _EN_TENS[t] + (f" {_EN_UNITS[u]}" if u else "")
    h, rest = divmod(n, 100)
    s = f"{_EN_UNITS[h]} hundred"
    return s + (f" {_en_under_1000(rest)}" if rest else "")


def number_to_words(n: int, lang: str) -> str:
    """Integer -> words ('pt' or 'en'); up to the hundreds of millions."""
    if n < 0:
        prefix = "menos " if lang == "pt" else "minus "
        return prefix + number_to_words(-n, lang)
    under = _pt_under_1000 if lang == "pt" else _en_under_1000
    if n < 1000:
        return under(n)
    parts = []
    millions, rest = divmod(n, 1_000_000)
    thousands, low = divmod(rest, 1000)
    if millions:
        if lang == "pt":
            parts.append("um milhão" if millions == 1
                         else f"{under(millions)} milhões")
        else:
            parts.append(f"{under(millions)} million")
    if thousands:
        if lang == "pt":
            parts.append("mil" if thousands == 1
                         else f"{under(thousands)} mil")
        else:
            parts.append(f"{under(thousands)} thousand")
    if low:
        joiner = "e " if lang == "pt" and (low < 100 or low % 100 == 0) \
            else ""
        parts.append(joiner + under(low))
    return " ".join(parts)


def expand_numbers(text: str, lang: str) -> str:
    """Replace every integer run in the text with its word form."""
    return re.sub(r"\d+", lambda m: number_to_words(int(m.group()), lang),
                  text)


# ---------------------------------------------------------------------------
# Portuguese G2P
# ---------------------------------------------------------------------------

def _phonemize_word_pt(word: str) -> List[str]:
    if word in _PT_EXCEPTIONS:
        return list(_PT_EXCEPTIONS[word])
    out: List[str] = []
    w = word
    i = 0
    n = len(w)

    def nxt(k: int = 1) -> str:
        return w[i + k] if i + k < n else ""

    def at_final_syllable_before_s(k: int) -> bool:
        """True at index k when w[k] is the vowel of a final -Vs."""
        return k == n - 2 and w[n - 1] == "s"

    while i < n:
        c = w[i]
        two = w[i:i + 2]
        # digraphs first
        if two == "ch":
            out.append("ʃ"); i += 2; continue
        if two == "lh":
            out.append("ʎ"); i += 2; continue
        if two == "nh":
            out.append("ɲ"); i += 2; continue
        if two == "rr":
            out.append("x"); i += 2; continue
        if two == "ss":
            out.append("s"); i += 2; continue
        if two == "qu":
            out.append("k")
            if nxt(2) in "aoáóâô":
                out.append("w")
            i += 2; continue
        if two == "gu" and nxt(2) in "eiéíêaoáóâô":
            out.append("g")
            if nxt(2) in "aoáóâô":
                out.append("w")
            i += 2; continue
        if two == "ão":
            out.extend(["ɐ̃", "w"]); i += 2; continue
        if two == "ãe":
            out.extend(["ɐ̃", "j"]); i += 2; continue
        if two == "õe":
            out.extend(["õ", "j"]); i += 2; continue

        if c in _PT_VOWEL:
            # nasalisation: vowel + coda m/n (before consonant or end).
            # "nh" is NOT a coda — it's the ɲ digraph ("ninho").
            follower = nxt()
            if (follower != "" and follower in "mn"
                    and not (follower == "n" and nxt(2) == "h")
                    and (i + 2 >= n or nxt(2) not in _VOWELS_PT)):
                out.append(_NASAL_MAP.get(c, _PT_VOWEL[c]))
                # Word-final -em/-ém(-ens) is the nasal DIPHTHONG ẽj
                # ("ontem", "homem", "também"): espeak pt-br õtẽj.
                if (follower == "m" and c in "eé"
                        and (i + 2 == n
                             or (i + 3 == n and nxt(2) == "s"))):
                    out.append("j")
                if (follower == "n" and c in "eé" and nxt(2) == "s"
                        and i + 3 == n):
                    out.append("j")
                i += 2; continue
            # Falling diphthongs: unaccented i/u after a vowel closes
            # into a glide when no vowel follows ("cadeira" -> ej,
            # "pouco" -> ow, "cuidado" -> uj, "baixo" -> aj). Accented
            # í/ú stay hiatus ("saída").
            if (follower != "" and follower in "iu" and follower != c
                    and ((i + 2 >= n or nxt(2) not in _VOWELS_PT)
                         # final -Vi/-Vu before s: "depois", "degraus"
                         or at_final_syllable_before_s(i + 1))):
                out.append(_PT_VOWEL[c])
                out.append("j" if follower == "i" else "w")
                i += 2; continue
            if c == "o" and (i == n - 1
                             or at_final_syllable_before_s(i)):
                out.append("u"); i += 1; continue   # final reduction
            if c == "e" and (i == n - 1
                             or at_final_syllable_before_s(i)):
                out.append("i"); i += 1; continue
            if c == "a" and (i == n - 1
                             or at_final_syllable_before_s(i)):
                # Final unstressed a centralizes ("casa" -> kazɐ).
                out.append("ɐ"); i += 1; continue
            if c == "e" and i == 0 and nxt() == "s" \
                    and nxt(2) not in _VOWELS_PT:
                # Initial es+C raises ("escada" -> iskadɐ).
                out.append("i"); i += 1; continue
            out.append(_PT_VOWEL[c]); i += 1; continue

        if c == "c":
            out.append("s" if nxt() in "eiéíê" else "k"); i += 1; continue
        if c == "ç":
            out.append("s"); i += 1; continue
        if c == "g":
            out.append("ʒ" if nxt() in "eiéíê" else "g"); i += 1; continue
        if c == "j":
            out.append("ʒ"); i += 1; continue
        if c == "x":
            out.append("ʃ"); i += 1; continue
        if c == "h":
            i += 1; continue                   # silent
        if c == "r":
            out.append("x" if i == 0 else "ɾ"); i += 1; continue
        if c == "s":
            prev_v = i > 0 and w[i - 1] in _VOWELS_PT
            next_v = nxt() in _VOWELS_PT
            out.append("z" if prev_v and next_v else "s")
            i += 1; continue
        if c in "td":
            # palatalisation before [i]: ti->tʃi, di->dʒi, incl. final
            # -te/-de and final -tes/-des ("antes" -> ɐ̃tʃis)
            makes_i = (nxt() in "ií"
                       or (nxt() == "e" and i + 1 == n - 1)
                       or (nxt() == "e" and i + 2 == n - 1
                           and w[n - 1] == "s"))
            if makes_i:
                out.append("tʃ" if c == "t" else "dʒ")
            else:
                out.append(c)
            i += 1; continue
        if c == "l":
            # coda-l vocalises (Brazilian): "brasil" -> ...iw
            if i + 1 >= n or nxt() not in _VOWELS_PT:
                out.append("w")
            else:
                out.append("l")
            i += 1; continue
        if c == "y":
            out.append("i"); i += 1; continue
        if c == "w":
            out.append("w"); i += 1; continue
        if c == "z":
            # Word-final z devoices ("talvez" -> tawves).
            out.append("s" if i == n - 1 else "z"); i += 1; continue
        if c in "pbkfvmn":
            out.append(c); i += 1; continue
        i += 1  # anything else: drop
    return out


# ---------------------------------------------------------------------------
# English G2P (heuristic)
# ---------------------------------------------------------------------------

_EN_DIGRAPHS = [
    ("tion", ["ʃ", "ə", "n"]), ("igh", ["aɪ"]),
    ("alk", ["ɔ", "k"]), ("all", ["ɔ", "l"]), ("oor", ["ɔ", "r"]),
    ("ook", ["ʊ", "k"]), ("ood", ["ʊ", "d"]), ("air", ["ɛ", "r"]),
    ("ear", ["ɪ", "r"]), ("ease", ["i", "z"]),
    ("ind", ["aɪ", "n", "d"]), ("old", ["oʊ", "l", "d"]),
    ("nk", ["ŋ", "k"]),
    ("th", ["θ"]), ("sh", ["ʃ"]), ("ch", ["tʃ"]), ("ph", ["f"]),
    ("wh", ["w"]), ("ck", ["k"]), ("qu", ["k", "w"]),
    ("ee", ["i"]), ("ea", ["i"]), ("oo", ["u"]), ("ou", ["aʊ"]),
    ("ai", ["eɪ"]), ("ay", ["eɪ"]), ("oa", ["oʊ"]),
    ("oy", ["ɔɪ"]), ("oi", ["ɔɪ"]),
]
_EN_SHORT = {"a": "æ", "e": "ɛ", "i": "ɪ", "o": "ɑ", "u": "ʌ"}
_EN_LONG = {"a": "eɪ", "e": "i", "i": "aɪ", "o": "oʊ", "u": "u"}
_EN_CONS = {"b": "b", "d": "d", "f": "f", "h": "h", "k": "k", "l": "l",
            "m": "m", "n": "n", "p": "p", "r": "r", "s": "s", "t": "t",
            "v": "v", "w": "w", "z": "z"}
# High-frequency irregulars letter rules cannot reach (espeak ships a
# full dictionary; this covers the function words + everyday
# assistant vocabulary that dominate running text).
_EN_EXCEPTIONS = {
    "the": ["ð", "ə"], "a": ["ə"], "of": ["ʌ", "v"], "to": ["t", "u"],
    "do": ["d", "u"], "you": ["j", "u"], "your": ["j", "ɔ", "r"],
    "was": ["w", "ʌ", "z"], "is": ["ɪ", "z"], "are": ["ɑ", "r"],
    "what": ["w", "ʌ", "t"], "who": ["h", "u"], "one": ["w", "ʌ", "n"],
    "two": ["t", "u"], "there": ["ð", "ɛ", "r"],
    "where": ["w", "ɛ", "r"], "here": ["h", "ɪ", "r"],
    "they": ["ð", "eɪ"], "this": ["ð", "ɪ", "s"],
    "that": ["ð", "æ", "t"], "then": ["ð", "ɛ", "n"],
    "than": ["ð", "æ", "n"], "them": ["ð", "ɛ", "m"],
    "people": ["p", "i", "p", "ə", "l"],
    "water": ["w", "ɔ", "t", "ə", "r"],
    "danger": ["d", "eɪ", "n", "dʒ", "ə", "r"],
    "open": ["oʊ", "p", "ə", "n"], "only": ["oʊ", "n", "l", "i"],
    "said": ["s", "ɛ", "d"], "says": ["s", "ɛ", "z"],
    "door": ["d", "ɔ", "r"], "floor": ["f", "l", "ɔ", "r"],
    "money": ["m", "ʌ", "n", "i"], "busy": ["b", "ɪ", "z", "i"],
    "woman": ["w", "ʊ", "m", "ə", "n"],
    "women": ["w", "ɪ", "m", "ɪ", "n"],
    "sugar": ["ʃ", "ʊ", "g", "ə", "r"],
    "answer": ["æ", "n", "s", "ə", "r"],
    "hour": ["aʊ", "ə", "r"], "our": ["aʊ", "ə", "r"],
    "once": ["w", "ʌ", "n", "s"], "does": ["d", "ʌ", "z"],
    "gone": ["g", "ɔ", "n"], "done": ["d", "ʌ", "n"],
    "some": ["s", "ʌ", "m"], "come": ["k", "ʌ", "m"],
    "have": ["h", "æ", "v"], "give": ["g", "ɪ", "v"],
    "live": ["l", "ɪ", "v"], "move": ["m", "u", "v"],
    "bread": ["b", "r", "ɛ", "d"], "head": ["h", "ɛ", "d"],
    "dead": ["d", "ɛ", "d"], "ready": ["r", "ɛ", "d", "i"],
    "blue": ["b", "l", "u"], "true": ["t", "r", "u"],
    "maybe": ["m", "eɪ", "b", "i"],
    "police": ["p", "ə", "l", "i", "s"],
    "alarm": ["ə", "l", "ɑ", "r", "m"],
    "emergency": ["ɪ", "m", "ə", "r", "dʒ", "ə", "n", "s", "i"],
    "machine": ["m", "ə", "ʃ", "i", "n"],
}


def _phonemize_word_en(word: str) -> List[str]:
    if word in _EN_EXCEPTIONS:
        return list(_EN_EXCEPTIONS[word])
    out: List[str] = []
    w = word
    n = len(w)
    has_earlier_vowel = any(ch in "aeiouy" for ch in w[:-1])
    # magic-e: consonant-vowel-consonant-e makes the vowel long
    magic_vowel_at = -1
    if (n >= 3 and w[-1] == "e" and w[-2] not in "aeiou"
            and w[-3] in "aeiou"):
        magic_vowel_at = n - 3
    elif (n >= 4 and w.endswith("le") and w[-3] not in "aeiou"
          and w[-4] in "aeiou"):
        # Open syllable before syllabic -le: "table" -> eɪ (a DOUBLED
        # consonant would make it short — "little" — and is collapsed
        # below without setting this).
        magic_vowel_at = n - 4
    i = 0
    while i < n:
        if i == n - 1 and w[i] == "e" and has_earlier_vowel:
            # Final e after a consonant is silent in multisyllables
            # ("table", "entrance"), not just the magic-e pattern.
            i += 1; continue
        # Final -le after a consonant is a syllabic l: "table" -> ə l.
        if i == n - 2 and w[i:] == "le" and i > 0 \
                and w[i - 1] not in "aeiou":
            out.extend(["ə", "l"]); i += 2; continue
        # Final -er / multisyllable -or reduce: "water" -> ə r.
        if i == n - 2 and w[i:] == "er":
            out.extend(["ə", "r"]); i += 2; continue
        if i == n - 2 and w[i:] == "or" and n >= 5:
            out.extend(["ə", "r"]); i += 2; continue
        # Final -ow is the long vowel ("follow", "slow"); short words
        # keep the aʊ diphthong ("now", "how", "cow").
        if i == n - 2 and w[i:] == "ow":
            out.append("aʊ" if n <= 3 else "oʊ"); i += 2; continue
        if w.startswith("ow", i):
            out.append("aʊ"); i += 2; continue
        # r-colored vowels before a consonant/end: "far" -> ɑ r,
        # "morning" -> ɔ r, "person" -> ə r (mid-word; the final -er
        # reduction is handled above).
        if (i + 1 < n and w[i + 1] == "r" and w[i] in "aoeu"
                and i != magic_vowel_at
                and (i + 2 >= n or w[i + 2] not in "aeiouy")):
            out.extend([{"a": "ɑ", "o": "ɔ", "e": "ə",
                         "u": "ə"}[w[i]], "r"])
            i += 2; continue
        # "ng" is ŋ at a morpheme end ("warning", "king") but n + soft
        # g before e/i elsewhere ("danger" -> n dʒ).
        if w.startswith("ng", i):
            if i + 2 < n and w[i + 2] in "ei":
                out.append("n"); i += 1; continue
            out.append("ŋ"); i += 2; continue
        matched = False
        for pat, phs in _EN_DIGRAPHS:
            if w.startswith(pat, i):
                out.extend(phs); i += len(pat); matched = True; break
        if matched:
            continue
        c = w[i]
        # Double consonants collapse ("small", "follow").
        if (c not in "aeiou" and i + 1 < n and w[i + 1] == c):
            i += 1; continue
        if c in "aeiou":
            # Word-final o is long ("no", "go", "also").
            if c == "o" and i == n - 1:
                out.append("oʊ"); i += 1; continue
            table = _EN_LONG if i == magic_vowel_at else _EN_SHORT
            out.append(table[c]); i += 1; continue
        if c == "c":
            out.append("s" if i + 1 < n and w[i + 1] in "eiy" else "k")
            i += 1; continue
        if c == "g":
            out.append("dʒ" if i + 1 < n and w[i + 1] in "ei" else "g")
            i += 1; continue
        if c == "j":
            out.append("dʒ"); i += 1; continue
        if c == "x":
            out.extend(["k", "s"]); i += 1; continue
        if c == "y":
            out.append("j" if i == 0 else "i"); i += 1; continue
        if c == "s" and i == n - 1 and i > 0 \
                and w[i - 1] in "rlnmdgvwb":
            # Plural/final s voices after a voiced consonant
            # ("stairs" -> z); after vowels/voiceless it stays s.
            out.append("z"); i += 1; continue
        if c in _EN_CONS:
            out.append(_EN_CONS[c]); i += 1; continue
        i += 1
    return out


# ---------------------------------------------------------------------------
# Public surface
# ---------------------------------------------------------------------------

_WORD_RE = re.compile(r"[a-zà-ÿ]+|[.,!?]")


def phonemize(text: str, lang: str = "pt") -> List[str]:
    """Text -> phoneme symbols (from ``PHONEMES``), with word-boundary
    tokens. Numbers are expanded to words first."""
    if lang not in ("pt", "en"):
        raise ValueError(f"unsupported language {lang!r} (pt or en)")
    g2p = _phonemize_word_pt if lang == "pt" else _phonemize_word_en
    text = expand_numbers(text.lower(), lang)
    out: List[str] = []
    for token in _WORD_RE.findall(text):
        if token in ".,!?":
            out.append(token)
            continue
        if out:
            out.append(" ")
        out.extend(g2p(token))
    return out


def phonemes_to_ids(phonemes: List[str], max_len: int
                    ) -> Tuple[np.ndarray, int]:
    """Symbol list -> fixed-width id array + true length (same contract
    as models/tts.text_to_ids, for the phoneme id space)."""
    ids = [_PH_INDEX[p] for p in phonemes if p in _PH_INDEX][:max_len]
    arr = np.zeros((max_len,), np.int32)
    arr[: len(ids)] = ids
    return arr, len(ids)


class PhonemeFrontend:
    """Drop-in text->(ids, n) front end for models/tts.synthesize.

    Build the TTS model with ``vocab_size=PhonemeFrontend.vocab_size``
    so the embedding table covers the phoneme inventory."""

    vocab_size = len(PHONEMES)

    def __init__(self, lang: str = "pt"):
        if lang not in ("pt", "en"):
            raise ValueError(f"unsupported language {lang!r} (pt or en)")
        self.lang = lang

    def __call__(self, text: str, max_chars: int) -> Tuple[np.ndarray, int]:
        return phonemes_to_ids(phonemize(text, self.lang), max_chars)
