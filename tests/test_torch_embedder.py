"""The port's BERT embedder, its WordPiece tokenizer, its converters and
semantic memory against the JAX package's, on the CPU.

A tiny BERT (vocab 128, width 32, 4 heads, 2 layers) is written as an HF
``BertModel`` state dict from seeded numpy under the names the converters
read (with the pooler and a reranker's classifier head), and as a llama.cpp
``bert`` GGUF (``tests/test_loader.py:write_gguf``). Both packages convert
the same bytes; the forwards take the same ids and masks.

Tolerances: the converters' leaves and the tokenizers' ids are equal; the
encoder's hidden states, the pooled embeddings (mean, cls, pooler) and the
reranker's scores agree to 1e-5 relative L2 (f32 products, sums in another
order), and a padded or batched row agrees with the same text alone to
1e-6 absolute.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from tests.test_loader import write_gguf
from trackiellm_tpu.app import TrackieApp as JApp
from trackiellm_tpu.cortex.memory import MemoryManager as JMemory
from trackiellm_tpu.llm.tokenizer import WordPieceTokenizer as JWordPiece
from trackiellm_tpu.models import convert as jconv
from trackiellm_tpu.models import embedder as jemb
from trackiellm_tpu_torch.app import TrackieApp
from trackiellm_tpu_torch.cortex.memory import MemoryManager
from trackiellm_tpu_torch.llm.tokenizer import WordPieceTokenizer
from trackiellm_tpu_torch.models import convert as tconv
from trackiellm_tpu_torch.models import embedder as temb
from trackiellm_tpu_torch.models.bridge import params_from_jax

CPU = torch.device("cpu")
REL = 1e-5        # hidden states, embeddings, scores: relative L2
PAD_ATOL = 1e-6   # one row padded or batched against the same row alone
VOCAB, HIDDEN, HEADS, INTER, LAYERS, MAX_POS = 128, 32, 4, 64, 2, 64

WORDS = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]",
         "the", "cat", "sat", "on", "mat", "##s", "##ting",
         "un", "##affable", "##able", "run", "##ning", ",", ".",
         "!", "voa", "##r", "9", "##9", "cafe", "caf", "##e", "猫",
         "mesa", "cozinha", "na", "uma", "?", "(", ")"]
TOKENS = WORDS + [f"w{i}" for i in range(VOCAB - len(WORDS))]
TEXTS = ["the cat sat on the mat", "uma mesa na cozinha",
         "the cat", "running, unable!", "Café voar?"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes: one intra-op thread, so this file does not crowd the
    other test workers' CPUs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def bert_state(seed: int = 0, classifier: bool = True) -> dict:
    """An HF BertModel state dict (with the pooler, and a
    BertForSequenceClassification head when ``classifier``) from seeded
    numpy: N(0, 0.2) weights, norms near 1."""
    rng = np.random.default_rng(seed)

    def w(*shape, s=0.2):
        return (rng.standard_normal(shape) * s).astype(np.float32)

    st = {"embeddings.word_embeddings.weight": w(VOCAB, HIDDEN),
          "embeddings.position_embeddings.weight": w(MAX_POS, HIDDEN),
          "embeddings.token_type_embeddings.weight": w(2, HIDDEN),
          "embeddings.LayerNorm.weight": 1 + w(HIDDEN, s=0.1),
          "embeddings.LayerNorm.bias": w(HIDDEN, s=0.1),
          "pooler.dense.weight": w(HIDDEN, HIDDEN),
          "pooler.dense.bias": w(HIDDEN)}
    for i in range(LAYERS):
        pre = f"encoder.layer.{i}"
        for name, (o, n) in (("attention.self.query", (HIDDEN, HIDDEN)),
                             ("attention.self.key", (HIDDEN, HIDDEN)),
                             ("attention.self.value", (HIDDEN, HIDDEN)),
                             ("attention.output.dense", (HIDDEN, HIDDEN)),
                             ("intermediate.dense", (INTER, HIDDEN)),
                             ("output.dense", (HIDDEN, INTER))):
            st[f"{pre}.{name}.weight"] = w(o, n)
            st[f"{pre}.{name}.bias"] = w(o)
        for name in ("attention.output.LayerNorm", "output.LayerNorm"):
            st[f"{pre}.{name}.weight"] = 1 + w(HIDDEN, s=0.1)
            st[f"{pre}.{name}.bias"] = w(HIDDEN, s=0.1)
    if classifier:
        st = {f"bert.{k}": v for k, v in st.items()}
        st["classifier.weight"] = w(1, HIDDEN)
        st["classifier.bias"] = w(1)
    return st


@pytest.fixture(scope="module")
def models():
    """(JAX params, JAX cfg, port params, port cfg) of bert_state()."""
    jp, jcfg = jconv.bert_from_hf(bert_state())
    tp, tcfg = tconv.bert_from_hf(bert_state(), device=CPU)
    jcfg, tcfg = jcfg._replace(n_heads=HEADS), tcfg._replace(n_heads=HEADS)
    return jp, jcfg, tp, tcfg


def leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves(v, f"{prefix}.{k}")
    else:
        yield prefix, tree


def assert_same_bytes(port_tree, jax_tree):
    want = dict(leaves(params_from_jax(jax_tree)))
    got = dict(leaves(port_tree))
    assert sorted(got) == sorted(want)
    for name, t in got.items():
        assert t.dtype == want[name].dtype and t.shape == want[name].shape
        assert torch.equal(t, want[name]), name


def batch(seed: int, b: int = 3, t: int = 12):
    """Seeded ids, a ragged mask (row i keeps t - 3i tokens) and segment
    ids that switch half way."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, VOCAB, (b, t)).astype(np.int32)
    mask = np.zeros((b, t), np.int32)
    for i in range(b):
        mask[i, :t - 3 * i] = 1
    types = np.zeros((b, t), np.int32)
    types[:, t // 2:] = 1
    return ids, mask, types


@pytest.mark.parametrize("classifier", [False, True])
def test_bert_from_hf_gives_the_jax_bytes(classifier):
    """Both prefixes and heads: a plain BertModel dump (the pooler kept)
    and a "bert."-prefixed sequence-classification dump (cls_out)."""
    state = bert_state(1, classifier=classifier)
    jp, jcfg = jconv.bert_from_hf(state)
    tp, tcfg = tconv.bert_from_hf(state, device=CPU)
    assert tuple(tcfg) == tuple(jcfg)
    assert ("cls_out" in tp) == classifier
    assert_same_bytes(tp, jp)


def test_bert_from_hf_without_pooler_gives_the_jax_bytes():
    state = {k: v for k, v in bert_state(2, classifier=False).items()
             if not k.startswith("pooler.")}
    jp, _ = jconv.bert_from_hf(state)
    tp, _ = tconv.bert_from_hf(state, device=CPU)
    assert_same_bytes(tp, jp)


@pytest.mark.parametrize("segments", [False, True])
def test_encoder_forward_matches(models, segments):
    jp, jcfg, tp, tcfg = models
    ids, mask, types = batch(3)
    want = jemb.encoder_forward(jp, jcfg, jnp.asarray(ids),
                                jnp.asarray(mask),
                                jnp.asarray(types) if segments else None)
    got = temb.encoder_forward(tp, tcfg, torch.from_numpy(ids),
                               torch.from_numpy(mask),
                               torch.from_numpy(types) if segments else None)
    assert got.shape == (3, 12, HIDDEN)
    assert rel_l2(got, want) <= REL


@pytest.mark.parametrize("pooling", ["mean", "cls", "pooler"])
def test_embed_forward_matches(models, pooling):
    jp, jcfg, tp, tcfg = models
    ids, mask, _ = batch(4)
    want = np.asarray(jemb.embed_forward(jp, jcfg._replace(pooling=pooling),
                                         jnp.asarray(ids),
                                         jnp.asarray(mask)))
    got = temb.embed_forward(tp, tcfg._replace(pooling=pooling),
                             torch.from_numpy(ids), torch.from_numpy(mask))
    assert got.dtype == torch.float32 and got.shape == (3, HIDDEN)
    assert rel_l2(got, want) <= REL
    np.testing.assert_allclose(np.linalg.norm(got.numpy(), axis=-1), 1.0,
                               atol=1e-6)


def test_rank_forward_matches(models):
    jp, jcfg, tp, tcfg = models
    ids, mask, types = batch(5)
    want = jemb.rank_forward(jp, jcfg, jnp.asarray(ids), jnp.asarray(mask),
                             jnp.asarray(types))
    got = temb.rank_forward(tp, tcfg, torch.from_numpy(ids),
                            torch.from_numpy(mask), torch.from_numpy(types))
    assert got.shape == (3,)
    assert rel_l2(got, want) <= REL


@pytest.mark.parametrize("pooling", ["mean", "cls", "pooler"])
def test_padding_is_invisible(models, pooling):
    """A row padded from 9 to 16 and to 32 positions embeds as at 9."""
    _, _, tp, tcfg = models
    cfg = tcfg._replace(pooling=pooling)
    row = np.random.default_rng(6).integers(0, VOCAB, 9).astype(np.int32)
    outs = []
    for t in (9, 16, 32):
        ids = np.zeros((1, t), np.int32)
        mask = np.zeros((1, t), np.int32)
        ids[0, :9], mask[0, :9] = row, 1
        outs.append(temb.embed_forward(tp, cfg, torch.from_numpy(ids),
                                       torch.from_numpy(mask)).numpy())
    for o in outs[1:]:
        np.testing.assert_allclose(o, outs[0], rtol=0, atol=PAD_ATOL)


def test_embedder_batch_matches_single_and_jax(models):
    """Embedder.embed: host f32 unit vectors; the bucketed batch equals
    each text embedded alone, and the JAX Embedder's rows."""
    jp, jcfg, tp, tcfg = models
    tok = WordPieceTokenizer(TOKENS)
    emb = temb.Embedder(tp, tcfg, tok)
    got = emb.embed(TEXTS)
    assert isinstance(got, np.ndarray) and got.dtype == np.float32
    assert got.shape == (len(TEXTS), HIDDEN)
    singles = np.concatenate([emb.embed([t]) for t in TEXTS])
    np.testing.assert_allclose(got, singles, rtol=0, atol=PAD_ATOL)
    want = jemb.Embedder(jp, jcfg, JWordPiece(TOKENS)).embed(TEXTS)
    assert rel_l2(got, want) <= REL
    assert emb.embed([]).shape == (0, HIDDEN)


def test_embedder_takes_more_texts_than_the_largest_bucket(models):
    """40 texts: the reference's Embedder raises past its 32-row bucket;
    the port embeds them a bucket's worth at a time, each chunk as the
    reference embeds it, and ranks 40 documents so too."""
    jp, jcfg, tp, tcfg = models
    texts = [f"{TEXTS[i % len(TEXTS)]} {'the cat ' * (i % 4)}"
             for i in range(40)]
    jemb_ = jemb.Embedder(jp, jcfg, JWordPiece(TOKENS))
    with pytest.raises(IndexError):
        jemb_.embed(texts)
    temb_ = temb.Embedder(tp, tcfg, WordPieceTokenizer(TOKENS))
    got = temb_.embed(texts)
    want = np.concatenate([jemb_.embed(texts[:32]), jemb_.embed(texts[32:])])
    assert got.shape == (40, HIDDEN) and rel_l2(got, want) <= REL
    scores = temb_.rank("the cat", texts)
    assert scores.shape == (40,)
    assert rel_l2(scores[32:], jemb_.rank("the cat", texts[32:])) <= REL


def test_embedder_rank_matches_jax(models):
    jp, jcfg, tp, tcfg = models
    docs = ["the cat sat", "running!", "unaffable mats", "uma mesa"]
    want = jemb.Embedder(jp, jcfg, JWordPiece(TOKENS)).rank("the cat", docs)
    got = temb.Embedder(tp, tcfg, WordPieceTokenizer(TOKENS)).rank(
        "the cat", docs)
    assert got.shape == (4,)
    assert rel_l2(got, want) <= REL
    plain, _ = tconv.bert_from_hf(bert_state(classifier=False), device=CPU)
    with pytest.raises(ValueError):
        temb.Embedder(plain, tcfg, WordPieceTokenizer(TOKENS)).rank(
            "the cat", docs)


@pytest.mark.parametrize("text", [
    "the cat sat on mats",
    "The CAT, sitting!",
    "unaffable runs",
    "Café voar!",                     # accent stripped
    "the 99 cats...",
    "猫の mesa (na cozinha)?",          # CJK isolated, punctuation split
    "zzz qqq the",                    # unknown words
    "  spaces\tand\nnewlines the cat​ ",
    "x" * 250,                        # longer than max_word_chars
])
def test_wordpiece_ids_equal_jax(text):
    got, want = WordPieceTokenizer(TOKENS), JWordPiece(TOKENS)
    assert got.encode(text) == want.encode(text)
    assert got.encode_with_special(text) == want.encode_with_special(text)
    ids = got.encode_with_special(text)
    assert got.decode(ids) == want.decode(ids)
    assert [got.decode_token(i) for i in ids] == [
        want.decode_token(i) for i in ids]


def test_wordpiece_specials_and_unknown():
    tok = WordPieceTokenizer(TOKENS)
    assert (tok.unk_id, tok.cls_id, tok.sep_id, tok.pad_id) == (1, 2, 3, 0)
    assert tok.encode("zzz") == [tok.unk_id]
    ids = tok.encode_with_special("the cat")
    assert ids[0] == tok.cls_id and ids[-1] == tok.sep_id
    assert tok.decode(ids) == "the cat"


def bert_gguf(path: str, state: dict, rank: bool) -> None:
    """``state`` (plain BertModel names) as a llama.cpp bert GGUF with a
    WordPiece vocabulary; ``rank`` adds the reranker's cls tensors."""
    tensors = {
        "token_embd.weight": state["embeddings.word_embeddings.weight"],
        "position_embd.weight": state["embeddings.position_embeddings.weight"],
        "token_types.weight": state["embeddings.token_type_embeddings.weight"],
        "token_embd_norm.weight": state["embeddings.LayerNorm.weight"],
        "token_embd_norm.bias": state["embeddings.LayerNorm.bias"],
    }
    for i in range(LAYERS):
        pre, blk = f"encoder.layer.{i}", f"blk.{i}"
        for gg, hf in (("attn_q", "attention.self.query"),
                       ("attn_k", "attention.self.key"),
                       ("attn_v", "attention.self.value"),
                       ("attn_output", "attention.output.dense"),
                       ("ffn_up", "intermediate.dense"),
                       ("ffn_down", "output.dense")):
            tensors[f"{blk}.{gg}.weight"] = state[f"{pre}.{hf}.weight"]
            if gg != "attn_k":  # one optional bias absent: zeros
                tensors[f"{blk}.{gg}.bias"] = state[f"{pre}.{hf}.bias"]
        for gg, hf in (("attn_output_norm", "attention.output.LayerNorm"),
                       ("layer_output_norm", "output.LayerNorm")):
            tensors[f"{blk}.{gg}.weight"] = state[f"{pre}.{hf}.weight"]
            tensors[f"{blk}.{gg}.bias"] = state[f"{pre}.{hf}.bias"]
    if rank:
        tensors["cls.weight"] = state["pooler.dense.weight"]
        tensors["cls.bias"] = state["pooler.dense.bias"]
        tensors["cls.output.weight"] = np.full((1, HIDDEN), 0.1, np.float32)
        tensors["cls.output.bias"] = np.zeros((1,), np.float32)
    write_gguf(path, {k: (v, 0) for k, v in tensors.items()}, metadata={
        "general.architecture": "bert",
        "bert.embedding_length": HIDDEN,
        "bert.block_count": LAYERS,
        "bert.attention.head_count": HEADS,
        "bert.feed_forward_length": INTER,
        "bert.context_length": MAX_POS,
        "bert.attention.layer_norm_epsilon": 1e-12,
        "bert.pooling_type": 2 if rank else 1,
        "tokenizer.ggml.model": "bert",
        "tokenizer.ggml.tokens": TOKENS,
        "tokenizer.ggml.unknown_token_id": 1,
        "tokenizer.ggml.cls_token_id": 2,
        "tokenizer.ggml.seperator_token_id": 3,
        "tokenizer.ggml.padding_token_id": 0,
    })


@pytest.mark.parametrize("rank", [False, True])
def test_bert_gguf_route_matches_jax(tmp_path, rank):
    """gguf_to_bert_params: the JAX route's config, bytes and tokenizer
    ids; the GGUF's embeddings equal the HF route's."""
    path = str(tmp_path / "bert.gguf")
    state = bert_state(7, classifier=False)
    bert_gguf(path, state, rank)
    jp, jcfg, jtok = jconv.gguf_to_bert_params(path)
    tp, tcfg, ttok = tconv.gguf_to_bert_params(path, device=CPU)
    assert tuple(tcfg) == tuple(jcfg)
    assert tcfg.pooling == ("cls" if rank else "mean")
    assert ("cls_out" in tp) == rank
    assert_same_bytes(tp, jp)
    assert isinstance(ttok, WordPieceTokenizer)
    for text in TEXTS:
        assert ttok.encode_with_special(text) == jtok.encode_with_special(
            text)
    if not rank:  # the rank GGUF's pooling (cls) is another function
        hp, hcfg = tconv.bert_from_hf(state, device=CPU)
        ids, mask, _ = batch(8)
        a = temb.embed_forward(hp, hcfg._replace(n_heads=HEADS),
                               torch.from_numpy(ids), torch.from_numpy(mask))
        b = temb.embed_forward(tp, tcfg, torch.from_numpy(ids),
                               torch.from_numpy(mask))
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-6)


def test_cosine_topk_matches_jax():
    rng = np.random.default_rng(9)
    corpus = rng.standard_normal((12, 8)).astype(np.float32)
    corpus /= np.linalg.norm(corpus, axis=-1, keepdims=True)
    q = corpus[4] + 0.1 * rng.standard_normal(8).astype(np.float32)
    for k in (1, 3, 12, 20):
        got, want = temb.cosine_topk(q, corpus, k), jemb.cosine_topk(
            q, corpus, k)
        assert np.array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[0], want[0])
    assert temb.cosine_topk(q, corpus[:0], 3)[1].shape == (0,)


MEMORIES = ["the cat sat on the mat", "uma mesa na cozinha",
            "running, unable!", "cafe voar"]


def test_memory_manager_ranks_as_jax(models):
    """MemoryManager with each package's Embedder: fragments archived,
    one backfilled, the same ranking for every query."""
    jp, jcfg, tp, tcfg = models
    tmem = MemoryManager(embed_fn=temb.Embedder(
        tp, tcfg, WordPieceTokenizer(TOKENS)).embed, clock=lambda: 1.0)
    jmem = JMemory(embed_fn=jemb.Embedder(
        jp, jcfg, JWordPiece(TOKENS)).embed, clock=lambda: 1.0)
    for mem in (tmem, jmem):
        for text in MEMORIES:
            mem.archive(text)
    for query in ("the cat", "mesa", "unable running", "zzz"):
        got = [f.text for f in tmem.retrieve_relevant(query, top_k=4)]
        want = [f.text for f in jmem.retrieve_relevant(query, top_k=4)]
        assert got == want, query
    for a, b in zip(tmem.fragments, jmem.fragments):
        np.testing.assert_allclose(a.embedding, b.embedding, rtol=0,
                                   atol=1e-5)


def test_memory_takes_a_tensor_embed_fn(models, tmp_path):
    """An embed_fn that returns a torch tensor (as a card embedder does)
    is fetched once a call: a fragment stored before the embedder came is
    backfilled, and the embeddings and ranking are the numpy embedder's."""
    _, _, tp, tcfg = models
    emb = temb.Embedder(tp, tcfg, WordPieceTokenizer(TOKENS))
    calls = []

    def as_tensor(texts):
        calls.append(len(texts))
        return torch.from_numpy(emb.embed(texts))
    store = str(tmp_path / "mem.json")
    plain = MemoryManager(store_path=store, clock=lambda: 1.0)
    plain.archive(MEMORIES[2])
    plain.save()
    by_tensor = MemoryManager(store_path=store, embed_fn=as_tensor,
                              clock=lambda: 1.0)
    by_array = MemoryManager(store_path=store, embed_fn=emb.embed,
                             clock=lambda: 1.0)
    for mem in (by_tensor, by_array):
        for text in MEMORIES[:2]:
            mem.archive(text)
    got = [f.text for f in by_tensor.retrieve_relevant("the cat", 3)]
    want = [f.text for f in by_array.retrieve_relevant("the cat", 3)]
    assert got == want and got[0] == "the cat sat on the mat"
    assert calls == [1, 1, 1, 1]  # two archives, one backfill, one query
    for a, b in zip(by_tensor.fragments, by_array.fragments):
        assert all(isinstance(x, float) for x in a.embedding)
        assert a.embedding == b.embedding


def test_app_memory_uses_embedder(models):
    """TrackieApp(embed_fn=Embedder.embed) routes memory embedding through
    the shared scheduler into MemoryManager and retrieves by cosine, as
    the JAX app does with the JAX embedder."""
    jp, jcfg, tp, tcfg = models
    emb = temb.Embedder(tp, tcfg, WordPieceTokenizer(TOKENS))
    calls = []

    def embed_fn(texts):
        calls.append(list(texts))
        return emb.embed(texts)
    app = TrackieApp(embed_fn=embed_fn, device=CPU)
    japp = JApp(embed_fn=jemb.Embedder(jp, jcfg, JWordPiece(TOKENS)).embed)
    try:
        for a in (app, japp):
            for text in MEMORIES:
                a.memory.archive(text)
        got = app.memory.retrieve_relevant("uma mesa", top_k=2)
        want = japp.memory.retrieve_relevant("uma mesa", top_k=2)
        assert got and got[0].embedding is not None
        assert [f.text for f in got] == [f.text for f in want]
        assert calls and app.failures() == {}
    finally:
        for a in (app, japp):
            if hasattr(a, "shutdown"):
                a.shutdown()
