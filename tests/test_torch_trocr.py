"""The port's TrOCR, its converter, checkpoint and CLI route and its OCR
engine against the JAX package's, on the CPU.

Tiny TrOCR models (32-pixel images of 8x8 patches, encoder width 32 with
4 heads and 2 layers, decoder width 48 with 4 heads and 2 layers, so the
cross-attention reads another width than it writes as TrOCR-base's does,
vocab 100, a 12-token budget) with a ViT encoder and with a DeiT one (its
distillation token), written as HF ``VisionEncoderDecoderModel`` state
dicts from seeded numpy under the names ``trocr_from_hf`` reads. Both
packages convert the same bytes and take the same pixels and ids.

Tolerances: the converters' leaves are equal and ``_prep``'s pixels too;
the encoder's states and the teacher-forced logits agree to 1e-5 relative
L2. Greedy ids are equal up to the first EOS, or part only at a near-tie:
where the JAX top-2 margin is under twice the noise, the noise being the
largest gap between the packages' teacher-forced logits along the JAX
ids, itself held under NOISE_CAP of the largest logit.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from trackiellm_tpu.models import checkpoint as jckpt
from trackiellm_tpu.models import convert as jconv
from trackiellm_tpu.models import trocr as jtrocr
from trackiellm_tpu_torch import __main__ as tmain
from trackiellm_tpu_torch.models import checkpoint as tckpt
from trackiellm_tpu_torch.models import convert as tconv
from trackiellm_tpu_torch.models import trocr as ttrocr
from trackiellm_tpu_torch.models.bridge import params_from_jax
from trackiellm_tpu_torch.vision import pipeline as tpipe

CPU = torch.device("cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REL = 1e-5         # encoder states, teacher-forced logits: relative L2
NOISE_CAP = 2e-6   # the teacher-forced logit gap over the largest logit:
#                    measured 3.0e-7 to 4.0e-7 (the six rows of the greedy test)
IMG, PATCH, EDIM, EHEADS, EHID = 32, 8, 32, 4, 64
VOCAB, DDIM, DHEADS, DFFN, LAYERS, MAX_POS, MAX_LEN = 100, 48, 4, 64, 2, 64, 12


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


def hf_config() -> dict:
    """The HF config dict's keys that trocr_from_hf reads."""
    return {"decoder_start_token_id": 2,
            "encoder": {"num_attention_heads": EHEADS, "image_size": IMG,
                        "layer_norm_eps": 1e-12},
            "decoder": {"decoder_attention_heads": DHEADS,
                        "eos_token_id": 2, "pad_token_id": 1,
                        "activation_function": "gelu",
                        "scale_embedding": False, "layer_norm_eps": 1e-5}}


def trocr_state(seed: int, deit: bool) -> dict:
    """A VisionEncoderDecoderModel state dict (ViT or DeiT encoder, TrOCR
    decoder with a layernorm_embedding) from seeded numpy: N(0, 0.08)
    matrices, N(0, 0.02) biases, norms near 1."""
    rng = np.random.default_rng(seed)

    def w(*shape, s=0.08):
        return (rng.standard_normal(shape) * s).astype(np.float32)

    def norm(prefix, n):
        return {f"{prefix}.weight": 1 + w(n, s=0.1),
                f"{prefix}.bias": w(n, s=0.02)}

    def lin(prefix, o, i):
        return {f"{prefix}.weight": w(o, i), f"{prefix}.bias": w(o, s=0.02)}

    n_tok = (IMG // PATCH) ** 2 + (2 if deit else 1)
    e = "encoder.embeddings"
    st = {f"{e}.patch_embeddings.projection.weight": w(EDIM, 3, PATCH, PATCH),
          f"{e}.patch_embeddings.projection.bias": w(EDIM, s=0.02),
          f"{e}.position_embeddings": w(1, n_tok, EDIM),
          f"{e}.cls_token": w(1, 1, EDIM)}
    if deit:
        st[f"{e}.distillation_token"] = w(1, 1, EDIM)
    for i in range(LAYERS):
        p = f"encoder.encoder.layer.{i}"
        st.update(norm(f"{p}.layernorm_before", EDIM))
        st.update(norm(f"{p}.layernorm_after", EDIM))
        for name in ("query", "key", "value"):
            st.update(lin(f"{p}.attention.attention.{name}", EDIM, EDIM))
        st.update(lin(f"{p}.attention.output.dense", EDIM, EDIM))
        st.update(lin(f"{p}.intermediate.dense", EHID, EDIM))
        st.update(lin(f"{p}.output.dense", EDIM, EHID))
    st.update(norm("encoder.layernorm", EDIM))
    d = "decoder.model.decoder"
    st[f"{d}.embed_tokens.weight"] = w(VOCAB, DDIM, s=0.5)
    st[f"{d}.embed_positions.weight"] = w(MAX_POS + 2, DDIM, s=0.5)
    st.update(norm(f"{d}.layernorm_embedding", DDIM))
    for i in range(LAYERS):
        p = f"{d}.layers.{i}"
        for attn in ("self_attn", "encoder_attn"):
            for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
                cross_in = attn == "encoder_attn" and proj in ("k_proj",
                                                              "v_proj")
                st.update(lin(f"{p}.{attn}.{proj}", DDIM,
                              EDIM if cross_in else DDIM))
        st.update(lin(f"{p}.fc1", DFFN, DDIM))
        st.update(lin(f"{p}.fc2", DDIM, DFFN))
        for ln in ("self_attn_layer_norm", "encoder_attn_layer_norm",
                   "final_layer_norm"):
            st.update(norm(f"{p}.{ln}", DDIM))
    st["decoder.output_projection.weight"] = w(VOCAB, DDIM, s=0.5)
    return st


@pytest.fixture(scope="module", params=["vit", "deit"])
def models(request):
    """(JAX params, JAX cfg, port params, port cfg) of one encoder kind."""
    state = trocr_state(3 if request.param == "vit" else 4,
                        deit=request.param == "deit")
    jp, jcfg = jconv.trocr_from_hf(state, hf_config(), max_len=MAX_LEN)
    tp, tcfg = tconv.trocr_from_hf(state, hf_config(), max_len=MAX_LEN,
                                   device=CPU)
    return jp, jcfg, tp, tcfg


def leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves(v, f"{prefix}.{k}")
    else:
        yield prefix, tree


def pixels(seed: int, n: int = 1) -> np.ndarray:
    return np.random.default_rng(seed).uniform(
        -1, 1, (n, 3, IMG, IMG)).astype(np.float32)


def jax_forced(jp, jcfg, enc, ids):
    """Teacher-forced JAX logits after [start] + ids[:-1]."""
    x = np.concatenate([[jcfg.decoder_start_id], ids[:-1]]).astype(np.int32)
    return np.asarray(jtrocr.decoder_logits(jp, jcfg, jnp.asarray(enc),
                                            jnp.asarray(x)))


def assert_ids_agree(jp, jcfg, tp, tcfg, enc, want, got):
    """``got`` equals ``want`` up to the first EOS, or parts at a near-tie
    (module docstring): both packages' teacher-forced logits along the JAX
    ids measure the noise."""
    want, got = [int(i) for i in want], [int(i) for i in got]
    jl = jax_forced(jp, jcfg, enc, want)
    x = np.concatenate([[tcfg.decoder_start_id], want[:-1]])
    tl = ttrocr.decoder_logits(tp, tcfg, torch.tensor(enc),
                               torch.from_numpy(x)).numpy()
    noise = float(np.abs(tl - jl).max())
    assert noise <= NOISE_CAP * float(np.abs(jl).max()), noise
    assert [int(r.argmax()) for r in jl] == want  # JAX's own path
    end = want.index(jcfg.eos_id) + 1 if jcfg.eos_id in want else len(want)
    parted = next((s for s in range(end) if got[s] != want[s]), None)
    if parted is not None:
        row = jl[parted]
        top = np.sort(row)[-2:]
        assert top[1] - top[0] < 2 * noise, (parted, top, noise)
        assert row[got[parted]] >= row.max() - 2 * noise, parted
    return parted


def test_trocr_from_hf_gives_the_jax_bytes(models):
    jp, jcfg, tp, tcfg = models
    assert tuple(tcfg) == tuple(jcfg)
    assert tcfg.max_len == MAX_LEN and tcfg.enc_heads == EHEADS
    want = dict(leaves(params_from_jax(jp)))
    got = dict(leaves(tp))
    assert sorted(got) == sorted(want)
    for name, t in got.items():
        assert t.dtype == torch.float32 and torch.equal(t, want[name]), name


def test_trocr_from_hf_refuses_a_non_square_grid():
    state = trocr_state(5, deit=False)
    pos = state["encoder.embeddings.position_embeddings"]
    state["encoder.embeddings.position_embeddings"] = pos[:, :-1]
    with pytest.raises(Exception, match="non-square"):
        tconv.trocr_from_hf(state, hf_config(), device=CPU)


def test_encode_matches(models):
    jp, jcfg, tp, tcfg = models
    px = pixels(7, 2)
    want = np.stack([np.asarray(jtrocr.encode(jp, jcfg, jnp.asarray(p)))
                     for p in px])
    got = ttrocr.encode_batch(tp, tcfg, torch.from_numpy(px))
    assert got.shape == (2, tcfg.enc_seq, EDIM)
    assert rel_l2(got, want) <= REL
    one = ttrocr.encode(tp, tcfg, torch.from_numpy(px[1]))
    assert rel_l2(one, want[1]) <= REL


def test_decoder_logits_match(models):
    jp, jcfg, tp, tcfg = models
    enc = np.asarray(jtrocr.encode(jp, jcfg, jnp.asarray(pixels(8)[0])))
    ids = np.random.default_rng(9).integers(0, VOCAB, 7)
    want = np.asarray(jtrocr.decoder_logits(jp, jcfg, jnp.asarray(enc),
                                            jnp.asarray(ids, jnp.int32)))
    got = ttrocr.decoder_logits(tp, tcfg, torch.tensor(enc),
                                torch.from_numpy(ids))
    assert got.shape == (7, VOCAB)
    assert rel_l2(got, want) <= REL


def test_greedy_ids_match_up_to_eos(models):
    """One crop through greedy_ids and three through greedy_ids_batch:
    each row's ids are the JAX greedy_ids' (near-tie rule)."""
    jp, jcfg, tp, tcfg = models
    px = pixels(10, 3)
    encs = [np.asarray(jtrocr.encode(jp, jcfg, jnp.asarray(p))) for p in px]
    want = [np.asarray(jtrocr.greedy_ids(jp, jcfg, jnp.asarray(e)))
            for e in encs]
    one = ttrocr.greedy_ids(tp, tcfg, torch.tensor(encs[0]))
    assert one.shape == (MAX_LEN,)
    rows = ttrocr.greedy_ids_batch(tp, tcfg, torch.tensor(np.stack(encs)))
    assert rows.shape == (3, MAX_LEN)
    assert_ids_agree(jp, jcfg, tp, tcfg, encs[0], want[0], one)
    for e, w, r in zip(encs, want, rows):
        assert_ids_agree(jp, jcfg, tp, tcfg, e, w, r)


def crops() -> list:
    """The kinds of crop ``_prep`` keys on, from one seed."""
    rng = np.random.default_rng(11)
    gray = rng.integers(0, 256, (20, 60)).astype(np.uint8)
    return [gray, (gray / 255.0), gray.astype(np.float32),
            gray[..., None], rng.integers(0, 256, (40, 24, 3)).astype(
                np.uint8), np.zeros((16, 16), np.uint8) + 1]


@pytest.mark.parametrize("i", range(6), ids=[
    "uint8", "float01", "float255", "hw1", "rgb", "near_black"])
def test_prep_gives_the_jax_pixels(models, i):
    jp, jcfg, tp, tcfg = models
    crop = crops()[i]
    want = jtrocr.TrOCREngine(jp, jcfg, str)._prep(crop)
    eng = ttrocr.TrOCREngine(tp, tcfg, str)
    np.testing.assert_array_equal(eng._prep(crop).numpy(), want)
    np.testing.assert_array_equal(eng._prep(torch.from_numpy(
        np.ascontiguousarray(crop))).numpy(), want)


def decode_ids(ids) -> str:
    return "".join(chr(97 + int(i) % 26) for i in ids)


def test_engine_reads_the_jax_texts(models):
    """TrOCREngine: the JAX engine's ids (near-tie rule) and texts, from
    host crops and from tensors alike."""
    jp, jcfg, tp, tcfg = models
    cs = crops()
    jeng = jtrocr.TrOCREngine(jp, jcfg, decode_ids)
    teng = ttrocr.TrOCREngine(tp, tcfg, decode_ids)
    batch = np.stack([jeng._prep(c) for c in cs])
    jids = np.asarray(jeng._batched(jnp.asarray(batch)))
    encs = ttrocr.encode_batch(tp, tcfg, torch.from_numpy(batch))
    tids = ttrocr.greedy_ids_batch(tp, tcfg, encs)
    parted = [assert_ids_agree(jp, jcfg, tp, tcfg, e.numpy(), w, g)
              for e, w, g in zip(encs, jids, tids)]
    got = teng(cs)
    assert got == teng([torch.from_numpy(np.ascontiguousarray(c))
                        for c in cs])
    if parted == [None] * len(cs):
        assert got == jeng(cs)
    assert all(isinstance(t, str) for t in got) and len(got) == len(cs)


def test_engine_plugs_into_vision_pipeline(models):
    """VisionPipeline(ocr_fn=TrOCREngine): an OCR pass reads every page
    region's crop through the engine, and the text regions hold what the
    engine returned for them."""
    _, _, tp, tcfg = models
    eng = ttrocr.TrOCREngine(tp, tcfg, decode_ids)
    seen = []

    def ocr(batch):
        seen.append(batch)
        return eng(batch)
    frame = np.random.default_rng(12).integers(0, 256, (96, 128, 3)).astype(
        np.uint8)
    pipe = tpipe.VisionPipeline(None, ocr_fn=ocr, device=CPU)
    res = pipe.process_frame(frame, tpipe.AnalysisFlags.OCR)
    assert len(seen) == 1 and len(seen[0]) == 8  # the 4x2 page grid
    texts = [t for t in eng(seen[0]) if t]
    assert sorted(r.text for r in res.text_regions) == sorted(texts)
    assert res.valid_analyses & tpipe.AnalysisFlags.OCR


def test_checkpoint_round_trips_with_the_jax_package(models, tmp_path):
    """A TrOCRConfig checkpoint: the port saves and loads its own, loads
    the JAX package's, and the JAX package loads the port's."""
    jp, jcfg, tp, tcfg = models
    jckpt.save_checkpoint(str(tmp_path / "jax"), jp, config=jcfg)
    tckpt.save_checkpoint(str(tmp_path / "port"), tp, config=tcfg)
    for src in ("jax", "port"):
        p, cfg, _ = tckpt.load_checkpoint(str(tmp_path / src), device=CPU)
        assert isinstance(cfg, ttrocr.TrOCRConfig) and cfg == tcfg
        for name, t in leaves(p):
            assert torch.equal(t, dict(leaves(tp))[name]), (src, name)
    jback, jc, _ = jckpt.load_checkpoint(str(tmp_path / "port"),
                                         device_put=False)
    assert tuple(jc) == tuple(jcfg)
    want = dict(leaves(params_from_jax(jp)))
    for name, t in leaves(params_from_jax(jback)):
        assert torch.equal(t, want[name]), name


CLI_CHILD = r"""
import json, sys
import numpy as np
from trackiellm_tpu_torch.__main__ import main
from trackiellm_tpu_torch.models.checkpoint import load_checkpoint
src, conf, out = sys.argv[1:4]
rc = main(["convert", src, "-o", out, "--family", "trocr-hf",
           "--model-config", conf, "--device", "cpu"])
params, cfg, meta = load_checkpoint(out, device="cpu")
bad = sorted(m for m in sys.modules if m in ("jax", "trackiellm_tpu",
             "transformers") or m.startswith(("jax.", "trackiellm_tpu.")))
print(json.dumps({"rc": rc, "cfg": type(cfg).__name__,
                  "enc_layers": cfg.enc_layers, "meta": meta, "bad": bad,
                  "sum": float(params["dec"]["out_w"].sum())}))
"""


def test_convert_trocr_hf_cli_then_load_without_jax(tmp_path):
    """``convert --family trocr-hf --model-config`` on an .npz state dict,
    then ``load_checkpoint``, in a process that imports no JAX, no module
    of the JAX package and no transformers; the checkpoint's leaves are
    the converter's."""
    state = trocr_state(13, deit=True)
    src, conf = str(tmp_path / "trocr.npz"), str(tmp_path / "config.json")
    np.savez(src, **state)
    with open(conf, "w") as f:
        json.dump(hf_config(), f)
    out = str(tmp_path / "ckpt")
    proc = subprocess.run([sys.executable, "-c", CLI_CHILD, src, conf, out],
                          capture_output=True, text=True, timeout=240,
                          cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["rc"] == 0 and res["bad"] == []
    assert res["cfg"] == "TrOCRConfig" and res["enc_layers"] == LAYERS
    assert res["meta"] == {"source": src, "ocr": "trocr"}
    want, wcfg = tconv.trocr_from_hf(state, hf_config(), device=CPU)
    got, gcfg, _ = tckpt.load_checkpoint(out, device=CPU)
    assert gcfg == wcfg
    for name, t in leaves(got):
        assert torch.equal(t, dict(leaves(want))[name]), name


def test_convert_trocr_hf_through_main_matches_the_jax_cli(tmp_path):
    """The same command through both CLIs writes the same arrays."""
    from trackiellm_tpu.__main__ import main as jmain
    state = trocr_state(14, deit=False)
    src, conf = str(tmp_path / "trocr.npz"), str(tmp_path / "config.json")
    np.savez(src, **state)
    with open(conf, "w") as f:
        json.dump(hf_config(), f)
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    assert jmain(["convert", src, "-o", jdir, "--family", "trocr-hf",
                  "--model-config", conf]) == 0
    assert tmain.main(["convert", src, "-o", tdir, "--family", "trocr-hf",
                       "--model-config", conf, "--device", "cpu"]) == 0
    with np.load(os.path.join(jdir, "arrays.npz")) as a, \
            np.load(os.path.join(tdir, "arrays.npz")) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].tobytes() == b[k].tobytes(), k


def test_init_params_runs_at_two_widths():
    """init_params draws the cross-attention's keys and values from the
    encoder's width: a config whose encoder and decoder widths differ (as
    TrOCR-base's 768 and 1024) encodes and decodes, with the converters'
    shapes."""
    cfg = ttrocr.TrOCRConfig.tiny()._replace(d_model=48)
    p = ttrocr.init_params(torch.Generator().manual_seed(0), cfg)
    assert p["dec"]["layers"]["ck"].shape == (cfg.dec_layers, cfg.enc_dim,
                                              cfg.d_model)
    enc = ttrocr.encode(p, cfg, torch.zeros((3, cfg.image_size,
                                             cfg.image_size)))
    ids = ttrocr.greedy_ids(p, cfg, enc)
    assert ids.shape == (cfg.max_len,)
    state_shapes = {k: v.shape for k, v in leaves(tconv.trocr_from_hf(
        trocr_state(15, deit=False), hf_config(), device=CPU)[0])}
    assert state_shapes[".dec.layers.ck"][1:] == (EDIM, DDIM)
