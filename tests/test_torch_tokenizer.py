"""The port's tokenizers against the JAX package's.

``VocabTokenizer`` (SentencePiece score-merge BPE, greedy longest-match,
byte fallback), ``BpeTokenizer`` (byte-level BPE under the llama-bpe, qwen2
and llama4 pre-tokenizers, control tokens) and ``tokenizer_from_spec`` /
``tokenizer_from_pieces`` must give the same ids, text, per-token text and
per-token bytes as the JAX package on the same vocabulary. The byte-level
vocabulary is trained with the ``tokenizers`` package, as
tests/test_bpe_tokenizer.py trains its oracle.
"""

import json

import pytest

from trackiellm_tpu.llm import tokenizer as jtok
from trackiellm_tpu.models.convert import tokenizer_from_pieces as j_pieces
from trackiellm_tpu.models.convert import tokenizer_from_spec as j_spec
from trackiellm_tpu_torch.llm import tokenizer as ttok

TEXTS = [
    "ola mundo",
    "The quick brown fox jumps over 1234 lazy dogs!",
    "vou à padaria comprar pão às 9h30 — çãõ é ü",
    "I'll say it's 2026 and we're 100% sure they'd agree CAN'T",
    "   leading spaces and trailing   ",
    "linha1\nlinha2\r\n\r\n   indentado\t\ttabs \t mixed   \n",
    "a1b2c3 12345 9h30 1.234,56 0000000",
    "..::!! ?? // ** [[ ]] {{}} path/to/file.py",
    "CamelCase USAToday iPhone XPath MiXeD",
    "emoji 🦾 e 漢字 e العربية",
    "",
    " ",
    "\n",
]
CORPUS = TEXTS[:9] * 4


@pytest.fixture(scope="module")
def bpe_vocab():
    """(pieces, merges) of a byte-level BPE trained on CORPUS."""
    from tokenizers import Tokenizer, models, pre_tokenizers, trainers

    tok = Tokenizer(models.BPE(unk_token=None))
    tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
    trainer = trainers.BpeTrainer(
        vocab_size=420, show_progress=False,
        initial_alphabet=pre_tokenizers.ByteLevel.alphabet())
    tok.train_from_iterator(CORPUS, trainer)
    spec = json.loads(tok.to_str())
    vocab = spec["model"]["vocab"]
    merges = [m if isinstance(m, str) else " ".join(m)
              for m in spec["model"]["merges"]]
    pieces = [None] * len(vocab)
    for piece, i in vocab.items():
        pieces[i] = piece
    return pieces, merges


def _same(j, t, texts=TEXTS):
    for text in texts:
        ids = j.encode(text)
        assert t.encode(text) == ids, text
        assert t.encode(text, add_bos=True) == j.encode(text, add_bos=True)
        assert t.decode(ids) == j.decode(ids), text
    assert (t.vocab_size, t.bos_id, t.eos_id, t.pad_id) == (
        j.vocab_size, j.bos_id, j.eos_id, j.pad_id)
    for i in range(j.vocab_size):
        assert t.decode_token(i) == j.decode_token(i), i
        if hasattr(j, "token_bytes"):
            assert t.token_bytes(i) == j.token_bytes(i), i


@pytest.mark.parametrize("pre", ["llama-bpe", "qwen2", "llama4"])
def test_bpe_matches(bpe_vocab, pre):
    pieces, merges = bpe_vocab
    _same(jtok.BpeTokenizer(pieces, merges, pre=pre),
          ttok.BpeTokenizer(pieces, merges, pre=pre))


@pytest.mark.parametrize("pre", ["llama-bpe", "llama4"])
def test_pretokenizers_match(pre):
    for text in TEXTS:
        if pre == "llama4":
            assert ttok._pretokenize_o200k(text) == jtok._pretokenize_o200k(
                text)
        else:
            for run in (1, 3):
                assert ttok._pretokenize(text, run) == jtok._pretokenize(
                    text, run)


def test_bpe_control_tokens_match(bpe_vocab):
    pieces, merges = bpe_vocab
    n = len(pieces)
    pieces = pieces + ["<|im_start|>", "<|im_end|>"]
    types = [1] * n + [3, 3]
    kw = dict(pre="llama-bpe", token_types=types, bos_id=n, eos_id=n + 1)
    j = jtok.BpeTokenizer(pieces, merges, **kw)
    t = ttok.BpeTokenizer(pieces, merges, **kw)
    _same(j, t, TEXTS + ["<|im_start|>ola<|im_end|>", "a<|im_end|>b"])
    assert t.encode("<|im_start|>ola")[0] == n


def _spm_pieces():
    """SentencePiece-style pieces with scores: byte fallback for every
    byte, '▁'-marked words, and merges that greedy longest-match would
    take in another order."""
    pieces = [f"<0x{b:02X}>" for b in range(256)]
    pieces += ["▁", "a", "e", "o", "l", "m", "n", "d", "u", "▁o", "▁m",
               "la", "ol", "▁ola", "mu", "un", "nd", "do", "mundo",
               "▁mundo",
               "1", "2", "3", "4", "12", "123", "ç", "ã", "▁a", "▁e"]
    scores = [0.0] * 256 + [-float(i) for i in range(len(pieces) - 256)]
    types = [6] * 256 + [1] * (len(pieces) - 256)
    return pieces, scores, types


SPM_TEXTS = TEXTS + ["ola mundo ola", "olá 1234 ção", "mundo  mundo"]


@pytest.mark.parametrize("mode", ["scores", "greedy", "no_types"])
def test_vocab_tokenizer_matches(mode):
    pieces, scores, types = _spm_pieces()
    kw = {"scores": scores, "token_types": types}
    if mode == "greedy":
        kw.pop("scores")
    if mode == "no_types":
        kw.pop("token_types")
    _same(jtok.VocabTokenizer(pieces, **kw), ttok.VocabTokenizer(pieces, **kw),
          SPM_TEXTS)


def test_plain_word_list_matches():
    """A plain piece list (no '▁' marker), as tests/test_llm_runner.py
    builds one."""
    words = ["he", "hello", "l", "o", " ", "wor", "d"]
    j, t = jtok.VocabTokenizer(words), ttok.VocabTokenizer(words)
    _same(j, t, ["hello world", "held", "oh hello"])
    assert len(t.encode("hello world")) == 5


@pytest.mark.parametrize("scores", [True, False])
def test_tokenizer_from_pieces_matches(scores):
    pieces, sc, types = _spm_pieces()
    pieces = ["<unk>", "<s>", "</s>"] + pieces
    sc = [0.0] * 3 + sc if scores else None
    types = [2, 3, 3] + types
    _same(j_pieces(pieces, scores=sc, token_types=types),
          ttok.tokenizer_from_pieces(pieces, scores=sc, token_types=types),
          SPM_TEXTS)


def test_tokenizer_from_spec_matches_for_gguf_specs(tmp_path, bpe_vocab):
    """Specs as the converter stores them (built from a GGUF the way
    tests/test_bpe_tokenizer.py builds one, then through JSON)."""
    from tests.test_loader import write_gguf
    from trackiellm_tpu.models import loader as L
    from trackiellm_tpu.models.convert import tokenizer_spec_from_gguf

    import numpy as np

    pieces, merges = bpe_vocab
    spm_pieces, spm_scores, spm_types = _spm_pieces()
    metas = {
        "gpt2": {"tokenizer.ggml.model": "gpt2",
                 "tokenizer.ggml.pre": "qwen2",
                 "tokenizer.ggml.tokens": pieces,
                 "tokenizer.ggml.merges": merges,
                 "tokenizer.ggml.bos_token_id": 1,
                 "tokenizer.ggml.eos_token_id": 2},
        "llama": {"tokenizer.ggml.model": "llama",
                  "tokenizer.ggml.tokens": ["<unk>", "<s>", "</s>"]
                  + spm_pieces,
                  "tokenizer.ggml.scores": [0.0] * 3 + spm_scores,
                  "tokenizer.ggml.token_type": [2, 3, 3] + spm_types},
    }
    for name, meta in metas.items():
        path = str(tmp_path / f"{name}.gguf")
        write_gguf(path, {"token_embd.weight": (
            np.zeros((4, 4), np.float32), L.GGML_F32)}, metadata={
            "general.architecture": "llama", **meta})
        spec = json.loads(json.dumps(tokenizer_spec_from_gguf(
            L.read_gguf_header(path))))
        j, t = j_spec(spec), ttok.tokenizer_from_spec(spec)
        assert type(t).__name__ == type(j).__name__
        _same(j, t, SPM_TEXTS)
