"""The CLIP and SigLIP vision towers and the multimodal converters of the
port against the JAX package, on the CPU.

Tiny towers (16-pixel images of four 8x8 patches, width 32, 4 heads, 3
layers) in both dialects: CLIP as LLaVA taps it (CLS, pre-LN, the -2
feature layer with CLS dropped, a two-layer GELU projector) and SigLIP as
PaliGemma does (no CLS, patch bias, the post-LN tap, a single linear
projector). Weights are seeded numpy draws in the JAX package's layout or,
for the converters, transformers state dicts with the published key names;
mmproj files are written here with ``tests/test_loader.py:write_gguf``.

Tolerances: ``clip_normalize_chw`` agrees to 1e-6 absolute with the
eager JAX function (the same gathers and products), the towers' features
and projections to 1e-5 relative L2 (f32 products, sums in another
order), and every converter's leaves byte for byte.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tests.test_loader import write_gguf
from trackiellm_tpu.models import checkpoint as jckpt
from trackiellm_tpu.models import clip as jclip
from trackiellm_tpu.models import convert as jconv
from trackiellm_tpu.models import llm as jllm
from trackiellm_tpu.models import loader as jload
from trackiellm_tpu.ops import preprocess as jpre
from trackiellm_tpu.utils.errors import TrackieError as JTrackieError
from trackiellm_tpu_torch.models import checkpoint as tckpt
from trackiellm_tpu_torch.models import clip as tclip
from trackiellm_tpu_torch.models import convert as tconv
from trackiellm_tpu_torch.models.bridge import (hwio_tree_from_jax,
                                                params_from_jax)
from trackiellm_tpu_torch.ops import preprocess as tpre
from trackiellm_tpu_torch.ops.quant import QuantizedLinear
from trackiellm_tpu_torch.utils.errors import TrackieError

CPU = torch.device("cpu")
NORM_ATOL = 1e-6      # clip_normalize_chw, absolute
FEAT_REL = 1e-5       # tower features and projections, relative L2
GROUP = 32            # Q4/Q8 group of the tiny converters' matrices

# The tiny geometry: 16-pixel images of 8x8 patches, so 4 patch rows.
IMG, PATCH, VDIM, VHEADS, VHID, VLAYERS = 16, 8, 32, 4, 64, 3
# The tiny text models: a byte vocabulary, dim 64, head dim 16.
VOCAB, DIM, HEADS, HIDDEN, TLAYERS = 320, 64, 4, 128, 2


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


def clip_cfgs():
    """{dialect: the JAX package's tiny CLIPVisionConfig}."""
    base = dict(image_size=IMG, patch_size=PATCH, dim=VDIM,
                n_layers=VLAYERS, n_heads=VHEADS, hidden_dim=VHID,
                proj_dim=DIM)
    return {
        "clip": jclip.CLIPVisionConfig(**base),
        "siglip": jclip.CLIPVisionConfig(
            **base, norm_eps=1e-6, act="gelu_pytorch_tanh",
            feature_layer=-1, drop_cls=False, use_cls=False,
            patch_bias=True, pre_ln=False, post_ln=True, proj_layers=1),
    }


def torch_cfg(cfg) -> tclip.CLIPVisionConfig:
    return tclip.CLIPVisionConfig(**{
        f: getattr(cfg, f) for f in tclip.CLIPVisionConfig._fields})


def jax_tower(cfg, seed: int = 0):
    """The JAX package's random tower with non-trivial norms and biases
    (its init_params leaves them at 1 and 0)."""
    params = jclip.init_params(cfg, np.random.default_rng(seed))
    rng = np.random.default_rng(seed + 100)

    def jitter(tree):
        if isinstance(tree, dict):
            return {k: jitter(v) for k, v in tree.items()}
        a = np.asarray(tree)
        return jnp.asarray(a + rng.normal(0.0, 0.05, a.shape)
                           .astype(np.float32))
    return jitter(params)


def pixels(seed: int = 1) -> np.ndarray:
    return np.random.default_rng(seed).normal(
        size=(3, IMG, IMG)).astype(np.float32)


# --- preprocessing -----------------------------------------------------------

@pytest.mark.parametrize("hw,target", [((48, 64), 36), ((480, 640), 336)],
                         ids=["small", "camera"])
def test_clip_normalize_chw_matches_jax(hw, target):
    img = np.random.default_rng(0).integers(0, 256, (*hw, 3)).astype(
        np.uint8)
    # Eager: the jitted reference contracts the resize's products into
    # FMAs, so its weights round apart (tests/test_torch_vision.py).
    with jax.disable_jit():
        want = np.asarray(jpre.clip_normalize_chw(img, target, target))
    got = tpre.clip_normalize_chw(torch.from_numpy(img), target, target)
    assert got.shape == (3, target, target) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=NORM_ATOL, rtol=0)
    pre = tclip.preprocess_clip(img, torch_cfg(jclip.CLIPVisionConfig(
        image_size=target)), device=CPU)
    np.testing.assert_array_equal(pre.numpy(), got.numpy())


# --- the towers --------------------------------------------------------------

@pytest.mark.parametrize("dialect", ["clip", "siglip"])
def test_encode_and_project_match_jax(dialect):
    cfg = clip_cfgs()[dialect]
    jp = jax_tower(cfg)
    tp, tc = params_from_jax(jp, CPU), torch_cfg(cfg)
    px = pixels()
    want_f = np.asarray(jclip.encode_image(jp, cfg, jnp.asarray(px)))
    got_f = tclip.encode_image(tp, tc, torch.from_numpy(px)).numpy()
    assert got_f.shape == (tc.n_image_tokens, VDIM) == want_f.shape
    assert rel_l2(got_f, want_f) < FEAT_REL
    want = np.asarray(jclip.project_features(jp, cfg, jnp.asarray(want_f)))
    got = tclip.project_features(tp, tc, torch.from_numpy(got_f)).numpy()
    assert got.shape == (tc.n_image_tokens, DIM)
    assert rel_l2(got, want) < FEAT_REL
    both = tclip.encode_and_project(tp, tc, torch.from_numpy(px)).numpy()
    np.testing.assert_array_equal(both, got)


@pytest.mark.parametrize("knob,value,dialect", [
    ("feature_layer", -1, "clip"),
    ("drop_cls", False, "clip"),
    ("post_ln", False, "siglip"),
], ids=["feature_layer", "drop_cls", "post_ln"])
def test_each_tap_knob_matters_and_matches_jax(knob, value, dialect):
    """Flipping the knob changes the port's features (so the knob is
    load-bearing), and the flipped tower still agrees with the JAX one."""
    cfg = clip_cfgs()[dialect]
    flipped = dataclasses.replace(cfg, **{knob: value})
    jp = jax_tower(cfg)
    tp = params_from_jax(jp, CPU)
    px = torch.from_numpy(pixels())
    base = tclip.encode_image(tp, torch_cfg(cfg), px).numpy()
    got = tclip.encode_image(tp, torch_cfg(flipped), px).numpy()
    want = np.asarray(jclip.encode_image(jp, flipped, jnp.asarray(px)))
    assert rel_l2(got, want) < FEAT_REL
    if base.shape == got.shape:
        assert rel_l2(got, base) > 1e-2
    else:  # the CLS row kept
        assert got.shape[0] == base.shape[0] + 1


def test_siglip_preset_keeps_paligemma_widths():
    """google/paligemma-3b-pt-224's vision_config: 27 layers of 1152, 16
    heads, 4304 MLP, patch 14 at 224, so 256 image tokens."""
    c = tclip.CLIPVisionConfig.siglip_so400m_224()
    assert (c.n_layers, c.dim, c.n_heads, c.hidden_dim) == (27, 1152, 16,
                                                            4304)
    assert c.n_image_tokens == 256 and c.proj_dim == 2048
    assert tclip.CLIPVisionConfig().n_image_tokens == 576  # ViT-L/14-336


def test_tower_tree_carries_across_without_a_transpose():
    """Every leaf of the CLIP/SigLIP trees is a matrix, a vector or a
    stack of them (the patch projection is already (3*P*P, D)): nothing
    is HWIO, so params_from_jax and the vision bridge give the same
    bytes."""
    for cfg in clip_cfgs().values():
        jp = jax_tower(cfg)
        leaves = jax.tree_util.tree_leaves(jp)
        assert all(np.asarray(a).ndim <= 3 for a in leaves)
        assert np.asarray(jp["patch_w"]).shape == (3 * PATCH * PATCH, VDIM)
        a = jax.tree_util.tree_leaves(params_from_jax(jp, CPU))
        b = jax.tree_util.tree_leaves(hwio_tree_from_jax(jp, CPU))
        for x, y, j in zip(a, b, leaves):
            np.testing.assert_array_equal(x.numpy(), np.asarray(j))
            np.testing.assert_array_equal(y.numpy(), np.asarray(j))


def test_jax_vision_checkpoint_loads_in_the_port(tmp_path):
    cfg = clip_cfgs()["siglip"]
    jp = jax_tower(cfg)
    jckpt.save_checkpoint(str(tmp_path), jp, config=cfg,
                          metadata={"source": "test"})
    tp, tc, meta = tckpt.load_checkpoint(str(tmp_path), device=CPU)
    assert tc == torch_cfg(cfg) and meta == {"source": "test"}
    px = pixels()
    want = np.asarray(jclip.encode_and_project(jp, cfg, jnp.asarray(px)))
    got = tclip.encode_and_project(tp, tc, torch.from_numpy(px)).numpy()
    assert rel_l2(got, want) < FEAT_REL
    # And back: the port's writer, the JAX reader.
    tckpt.save_checkpoint(str(tmp_path / "again"), tp, config=tc)
    jp2, jc2, _ = jckpt.load_checkpoint(str(tmp_path / "again"))
    assert jc2 == cfg


# --- transformers state dicts ------------------------------------------------

def _normal(rng, *shape, s=0.02):
    return rng.normal(0.0, s, shape).astype(np.float32)


def _vision_state(rng, vt: str, siglip: bool) -> dict:
    n_pos = (IMG // PATCH) ** 2 + (0 if siglip else 1)
    st = {
        vt + "embeddings.patch_embedding.weight":
            _normal(rng, VDIM, 3, PATCH, PATCH),
        vt + "embeddings.position_embedding.weight":
            _normal(rng, n_pos, VDIM),
        vt + "post_layernorm.weight": 1 + _normal(rng, VDIM, s=0.1),
        vt + "post_layernorm.bias": _normal(rng, VDIM, s=0.1),
    }
    if siglip:
        st[vt + "embeddings.patch_embedding.bias"] = _normal(rng, VDIM)
    else:
        st[vt + "embeddings.class_embedding"] = _normal(rng, VDIM)
        st[vt + "pre_layrnorm.weight"] = 1 + _normal(rng, VDIM, s=0.1)
        st[vt + "pre_layrnorm.bias"] = _normal(rng, VDIM, s=0.1)
    for i in range(VLAYERS):
        pre = f"{vt}encoder.layers.{i}."
        for n in ("layer_norm1", "layer_norm2"):
            st[pre + n + ".weight"] = 1 + _normal(rng, VDIM, s=0.1)
            st[pre + n + ".bias"] = _normal(rng, VDIM, s=0.1)
        for p in ("q", "k", "v", "out"):
            st[pre + f"self_attn.{p}_proj.weight"] = _normal(
                rng, VDIM, VDIM, s=0.15)
            st[pre + f"self_attn.{p}_proj.bias"] = _normal(rng, VDIM)
        st[pre + "mlp.fc1.weight"] = _normal(rng, VHID, VDIM, s=0.15)
        st[pre + "mlp.fc1.bias"] = _normal(rng, VHID)
        st[pre + "mlp.fc2.weight"] = _normal(rng, VDIM, VHID, s=0.15)
        st[pre + "mlp.fc2.bias"] = _normal(rng, VDIM)
    return st


def _text_state(rng, lm: str, heads: int, n_kv: int, head_dim: int,
                gemma: bool) -> dict:
    """A Llama- or Gemma-shaped text model (Gemma's norms are stored as w,
    the converters fold 1 + w)."""
    base = 0.0 if gemma else 1.0
    st = {lm + "embed_tokens.weight": _normal(rng, VOCAB, DIM, s=0.5),
          lm + "norm.weight": base + _normal(rng, DIM, s=0.1)}
    for i in range(TLAYERS):
        pre = f"{lm}layers.{i}."
        st[pre + "input_layernorm.weight"] = base + _normal(rng, DIM, s=0.1)
        st[pre + "post_attention_layernorm.weight"] = (
            base + _normal(rng, DIM, s=0.1))
        st[pre + "self_attn.q_proj.weight"] = _normal(
            rng, heads * head_dim, DIM, s=0.12)
        for p in ("k", "v"):
            st[pre + f"self_attn.{p}_proj.weight"] = _normal(
                rng, n_kv * head_dim, DIM, s=0.12)
        st[pre + "self_attn.o_proj.weight"] = _normal(
            rng, DIM, heads * head_dim, s=0.12)
        st[pre + "mlp.gate_proj.weight"] = _normal(rng, HIDDEN, DIM, s=0.12)
        st[pre + "mlp.up_proj.weight"] = _normal(rng, HIDDEN, DIM, s=0.12)
        st[pre + "mlp.down_proj.weight"] = _normal(rng, DIM, HIDDEN, s=0.09)
    return st


def llava_state(seed: int = 0) -> dict:
    """A tiny transformers LLaVA (>= 4.52 layout): the CLIP tower, the
    two-layer projector and a Llama text model with an untied lm_head."""
    rng = np.random.default_rng(seed)
    st = _vision_state(rng, "model.vision_tower.vision_model.", False)
    st.update(_text_state(rng, "model.language_model.", HEADS, 2,
                          DIM // HEADS, False))
    proj = "model.multi_modal_projector."
    st[proj + "linear_1.weight"] = _normal(rng, DIM, VDIM, s=0.2)
    st[proj + "linear_1.bias"] = _normal(rng, DIM)
    st[proj + "linear_2.weight"] = _normal(rng, DIM, DIM, s=0.2)
    st[proj + "linear_2.bias"] = _normal(rng, DIM)
    st["lm_head.weight"] = _normal(rng, VOCAB, DIM, s=0.1)
    return st


# PaliGemma's Gemma keeps its published head dim (256) and multi-query
# attention: 2 query heads, 1 KV head.
PALI_HEAD_DIM, PALI_HEADS = 256, 2


def paligemma_state(seed: int = 0) -> dict:
    """A tiny transformers PaliGemma (the legacy layout): the SigLIP tower,
    the single-linear projector and a Gemma text model with MQA and a tied
    lm_head."""
    rng = np.random.default_rng(seed)
    st = _vision_state(rng, "vision_tower.vision_model.", True)
    st.update(_text_state(rng, "language_model.model.", PALI_HEADS, 1,
                          PALI_HEAD_DIM, True))
    st["multi_modal_projector.linear.weight"] = _normal(rng, DIM, VDIM, s=0.2)
    st["multi_modal_projector.linear.bias"] = _normal(rng, DIM)
    return st


def jax_llava(state, dtype=jnp.float32, bits=0):
    out = jconv.llava_from_hf(state, n_heads=HEADS, max_seq=256,
                              vision_n_heads=VHEADS, dtype=dtype)
    if bits:
        out = (jllm.quantize_params(out[0], bits=bits, group=GROUP),
               *out[1:])
    return out


def jax_paligemma(state, dtype=jnp.float32, bits=0):
    out = jconv.paligemma_from_hf(state, head_dim=PALI_HEAD_DIM, max_seq=256,
                                  vision_n_heads=VHEADS, dtype=dtype)
    if bits:
        out = (jllm.quantize_params(out[0], bits=bits, group=GROUP),
               *out[1:])
    return out


def torch_llava(state, dtype=torch.float32, bits=None):
    return tconv.llava_from_hf(state, n_heads=HEADS, max_seq=256,
                               vision_n_heads=VHEADS, dtype=dtype,
                               device=CPU, bits=bits, group=GROUP)


def torch_paligemma(state, dtype=torch.float32, bits=None):
    return tconv.paligemma_from_hf(state, head_dim=PALI_HEAD_DIM, max_seq=256,
                                   vision_n_heads=VHEADS, dtype=dtype,
                                   device=CPU, bits=bits, group=GROUP)


def assert_same_tree(tree, jtree, path=""):
    """Leaf for leaf the same bytes (bf16 through its uint16 view)."""
    if isinstance(jtree, dict):
        assert set(tree) == set(jtree), path
        for k in jtree:
            assert_same_tree(tree[k], jtree[k], f"{path}.{k}")
        return
    if hasattr(jtree, "values") and hasattr(jtree, "scales"):
        assert isinstance(tree, QuantizedLinear), path
        assert_same_tree(tree.values, jtree.values, path + ".values")
        assert_same_tree(tree.scales, jtree.scales, path + ".scales")
        return
    want = np.asarray(jtree)
    got = tree.detach().cpu()
    if got.dtype == torch.bfloat16:
        got, want = got.view(torch.int16).numpy(), want.view(np.int16)
    else:
        got = got.numpy()
    assert got.dtype == want.dtype and got.shape == want.shape, path
    np.testing.assert_array_equal(got, want, err_msg=path)


@pytest.mark.parametrize("family", ["llava", "paligemma"])
@pytest.mark.parametrize("bits", [0, 4, 8])
def test_hf_converters_give_the_jax_bytes(family, bits):
    """llava_from_hf / paligemma_from_hf (bf16 text, requantized at 4 and
    8 bits; f32 vision) leaf for leaf equal to the JAX converters', and
    the same configs."""
    if family == "llava":
        state = llava_state()
        want = jax_llava(state, jnp.bfloat16, bits)
        got = torch_llava(state, torch.bfloat16, bits or None)
    else:
        state = paligemma_state()
        want = jax_paligemma(state, jnp.bfloat16, bits)
        got = torch_paligemma(state, torch.bfloat16, bits or None)
    assert_same_tree(got[0], want[0])
    assert got[1]._asdict() == want[1]._asdict()
    assert_same_tree(got[2], want[2])
    assert got[3] == torch_cfg(want[3])


# --- llama.cpp mmproj --------------------------------------------------------

def write_mmproj(path, state, swap_ffn_names=False, md_override=None,
                 full_tower=False):
    """clip.cpp's packaging of the LLaVA state's tower: the blocks cut at
    the -2 feature tap (unless ``full_tower``), clip.vision.* metadata."""
    F32 = jload.GGML_F32
    vt = "model.vision_tower.vision_model."
    proj = "model.multi_modal_projector."
    A = lambda k: np.asarray(state[k], np.float32)  # noqa: E731
    keep = VLAYERS if full_tower else VLAYERS - 1
    t = {
        "v.patch_embd.weight": (A(vt + "embeddings.patch_embedding.weight"),
                                F32),
        "v.class_embd": (A(vt + "embeddings.class_embedding"), F32),
        "v.position_embd.weight":
            (A(vt + "embeddings.position_embedding.weight"), F32),
        "v.pre_ln.weight": (A(vt + "pre_layrnorm.weight"), F32),
        "v.pre_ln.bias": (A(vt + "pre_layrnorm.bias"), F32),
        "mm.0.weight": (A(proj + "linear_1.weight"), F32),
        "mm.0.bias": (A(proj + "linear_1.bias"), F32),
        "mm.2.weight": (A(proj + "linear_2.weight"), F32),
        "mm.2.bias": (A(proj + "linear_2.bias"), F32),
    }
    up, down = (("ffn_down", "ffn_up") if swap_ffn_names
                else ("ffn_up", "ffn_down"))
    for i in range(keep):
        pre, b = f"{vt}encoder.layers.{i}.", f"v.blk.{i}."
        for ours, hf in (("ln1", "layer_norm1"), ("ln2", "layer_norm2"),
                         ("attn_q", "self_attn.q_proj"),
                         ("attn_k", "self_attn.k_proj"),
                         ("attn_v", "self_attn.v_proj"),
                         ("attn_out", "self_attn.out_proj"),
                         (up, "mlp.fc1"), (down, "mlp.fc2")):
            t[b + ours + ".weight"] = (A(pre + hf + ".weight"), F32)
            t[b + ours + ".bias"] = (A(pre + hf + ".bias"), F32)
    md = {"clip.has_vision_encoder": 1, "clip.has_llava_projector": 1,
          "clip.projector_type": "mlp", "clip.use_gelu": 0,
          "clip.vision.image_size": IMG, "clip.vision.patch_size": PATCH,
          "clip.vision.embedding_length": VDIM,
          "clip.vision.feed_forward_length": VHID,
          "clip.vision.block_count": keep,
          "clip.vision.attention.head_count": VHEADS,
          "clip.vision.attention.layer_norm_epsilon": 1e-5,
          "clip.vision.projection_dim": DIM}
    md.update(md_override or {})
    write_gguf(path, t, md)


@pytest.mark.parametrize("case", ["truncated", "swapped_ffn_names",
                                  "feature_layer_-2", "feature_layer_2"])
def test_mmproj_gives_the_jax_bytes(tmp_path, case):
    """gguf_to_clip_params: leaves byte-equal to the JAX route's and the
    same config, for clip.cpp's truncated packaging, the swapped FFN
    names (assigned by shape) and a full tower whose feature-layer
    metadata (either convention) taps at the same block; the features
    then equal the HF converter's."""
    state = llava_state()
    path = str(tmp_path / "mmproj.gguf")
    kw = {"swapped_ffn_names": {"swap_ffn_names": True}}.get(case, {})
    if case.startswith("feature_layer"):
        kw = {"full_tower": True, "md_override": {
            "clip.vision.feature_layer": int(case.rsplit("_", 1)[1])}}
    write_mmproj(path, state, **kw)
    jp, jc = jconv.gguf_to_clip_params(path)
    tp, tc = tconv.gguf_to_clip_params(path, device=CPU)
    assert_same_tree(tp, jp)
    assert tc == torch_cfg(jc)
    assert tc.feature_layer == VLAYERS - 1 and tc.n_image_tokens == 4
    _, _, hp, hc = torch_llava(state)
    px = torch.from_numpy(pixels())
    got = tclip.encode_and_project(tp, tc, px).numpy()
    want = tclip.encode_and_project(hp, hc, px).numpy()
    assert rel_l2(got, want) < FEAT_REL


def test_mmproj_geometry_mismatch_raises(tmp_path):
    path = str(tmp_path / "bad.gguf")
    write_mmproj(path, llava_state(),
                 md_override={"clip.vision.patch_size": 14})
    with pytest.raises(JTrackieError, match="patch_size"):
        jconv.gguf_to_clip_params(path)
    with pytest.raises(TrackieError, match="patch_size"):
        tconv.gguf_to_clip_params(path, device=CPU)


def test_not_an_mmproj_raises(tmp_path):
    path = str(tmp_path / "text.gguf")
    write_gguf(path, {}, {"general.architecture": "llama"})
    with pytest.raises(TrackieError, match="mmproj"):
        tconv.gguf_to_clip_params(path, device=CPU)


def test_load_state_dict_reads_npz_and_torch_files(tmp_path):
    state = {"a.weight": np.arange(6, dtype=np.float32).reshape(2, 3),
             "b": np.ones(4, np.float32)}
    np.savez(tmp_path / "s.npz", **state)
    got = tconv.load_state_dict(str(tmp_path / "s.npz"))
    assert set(got) == set(state)
    for k in state:
        np.testing.assert_array_equal(got[k], state[k])
    torch.save({"state_dict": {k: torch.from_numpy(v)
                               for k, v in state.items()}},
               tmp_path / "s.pt")
    got = tconv.load_state_dict(str(tmp_path / "s.pt"))
    np.testing.assert_array_equal(got["a.weight"], state["a.weight"])
    with pytest.raises(TrackieError, match="unsupported"):
        tconv.load_state_dict(str(tmp_path / "s.bin2"))
