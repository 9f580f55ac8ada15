"""The port's DPT-SwinV2 against the JAX package on the CPU, at
``DPTSwinConfig.test_tiny()`` (clamped windows, shifted and unshifted
blocks, every merge) and at a config with a deep stage.

Weights are a JAX-package tree filled from a numpy seed, carried across
with ``models/dpt.py:params_from_jax``. Tolerances: the backbone features
and the depth map 1e-5 rel L2; the static tables (coordinates, pairwise
index, shift mask) and the window geometry equal; the CPB bias 4e-6 max
abs (a few ulps of values up to 16); the pipeline's DPT depth path 1e-5
rel L2.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tests.test_torch_vision import (MODEL_TOL, _shapes, jtree, np_tree,
                                     rel_l2)
from trackiellm_tpu.models import dpt as jdpt
from trackiellm_tpu.vision import pipeline as jpipe
from trackiellm_tpu_torch.models import dpt as tdpt
from trackiellm_tpu_torch.vision import pipeline as tpipe

CPU = torch.device("cpu")
DEEP = dict(image_size=64, embed_dim=16, depths=(2, 4, 2, 2),
            num_heads=(2, 2, 4, 4), window_size=4, fusion_hidden=32)


def _pair(cfg_kw, seed):
    jcfg = jdpt.DPTSwinConfig(**cfg_kw)
    tree = np_tree(jdpt.init_dpt, jcfg, seed)
    return jcfg, tdpt.DPTSwinConfig(**cfg_kw), tree


def _image(seed, size=64):
    return np.random.default_rng(seed).standard_normal(
        (3, size, size)).astype(np.float32)


@pytest.mark.parametrize("cfg_kw", [jdpt.DPTSwinConfig.test_tiny()._asdict(),
                                    DEEP], ids=["test_tiny", "deep_stage"])
def test_dpt_forward_matches_jax(cfg_kw):
    # Seed 1 gives maps positive almost everywhere (at some seeds the
    # random head's ReLU zeroes most pixels and rel L2 measures a few).
    jcfg, tcfg, tree = _pair(cfg_kw, 1)
    img = _image(1)
    ref = jdpt.dpt_forward(jtree(tree), jcfg, jnp.asarray(img))
    got = tdpt.dpt_forward(tdpt.params_from_jax(tree, CPU), tcfg,
                           torch.from_numpy(img))
    assert got.shape == ref.shape == (64, 64) and bool((got >= 0).all())
    assert rel_l2(got, ref) <= MODEL_TOL


def test_swin_features_match_jax():
    jcfg, tcfg, tree = _pair(jdpt.DPTSwinConfig.test_tiny()._asdict(), 2)
    img = _image(3)
    ref = jax.jit(jdpt.swin_features, static_argnums=1)(
        jtree(tree), jcfg, jnp.asarray(img).transpose(1, 2, 0)[None])
    got = tdpt.swin_features(tdpt.params_from_jax(tree, CPU), tcfg,
                             torch.from_numpy(img)[None])
    assert len(got) == len(ref) == 4
    for g, r in zip(got, ref):
        assert tuple(g.shape) == r.shape
        assert rel_l2(g, r) <= MODEL_TOL


def test_init_has_the_reference_tree():
    tcfg = tdpt.DPTSwinConfig.test_tiny()
    init = tdpt.init_dpt(torch.Generator().manual_seed(0), tcfg)
    shapes = jax.eval_shape(lambda: jdpt.init_dpt(
        jax.random.PRNGKey(0), jdpt.DPTSwinConfig.test_tiny()))
    assert _shapes(init) == _shapes(shapes, hwio=True)
    for name in ("tiny_256", "base_384", "large_384", "test_tiny"):
        assert getattr(tdpt.DPTSwinConfig, name)() == tuple(
            getattr(jdpt.DPTSwinConfig, name)())
    assert tcfg.stage_dims == jdpt.DPTSwinConfig.test_tiny().stage_dims


@pytest.mark.parametrize("res,window,shift", [(16, 16, 8), (8, 16, 8),
                                              (32, 16, 8), (16, 4, 2)])
def test_window_geometry_and_tables_match_jax(res, window, shift):
    assert tdpt._win_geometry(res, window, shift) == jdpt._win_geometry(
        res, window, shift)
    w = min(res, window)
    np.testing.assert_array_equal(tdpt._coords_table(w),
                                  jdpt._coords_table(w))
    np.testing.assert_array_equal(tdpt._rel_index(w), jdpt._rel_index(w))
    if res > window:
        np.testing.assert_array_equal(
            tdpt._shift_mask(res, res, window, shift),
            jdpt._shift_mask(res, res, window, shift))


def test_cpb_bias_matches_jax():
    rng = np.random.default_rng(4)
    p = {"w0": rng.standard_normal((2, 512)).astype(np.float32) * 0.5,
         "b0": rng.standard_normal(512).astype(np.float32) * 0.1,
         "w1": rng.standard_normal((512, 3)).astype(np.float32) * 0.05}
    ref = np.asarray(jdpt._cpb_bias(jtree(p), 4, 3))
    got = tdpt._cpb_bias({k: torch.from_numpy(v) for k, v in p.items()}, 4,
                         3, CPU).numpy()
    assert got.shape == ref.shape == (3, 16, 16)
    assert np.abs(got - ref).max() <= 4e-6  # a few ulps of 16 * sigmoid


def test_pipeline_dpt_depth_path_matches_jax():
    """``depth_preproc="dpt"``: the pipeline normalizes (x - 0.5) / 0.5 at
    the DPT's size and maps the DPT map to meters, as the reference."""
    jcfg, tcfg, tree = _pair(jdpt.DPTSwinConfig.test_tiny()._asdict(), 3)
    jp, tp = jtree(tree), tdpt.params_from_jax(tree, CPU)
    frame = np.random.default_rng(6).integers(0, 256, (48, 64, 3), np.uint8)
    conf = dict(depth_preproc="dpt", depth_input=64)
    rj = jpipe.VisionPipeline(
        None, lambda chw: jdpt.dpt_forward(jp, jcfg, chw),
        config=jpipe.VisionConfig(**conf)).process_frame(
            frame, jpipe.AnalysisFlags.DEPTH)
    rt = tpipe.VisionPipeline(
        None, lambda chw: tdpt.dpt_forward(tp, tcfg, chw),
        config=tpipe.VisionConfig(**conf), device=CPU).process_frame(
            frame, tpipe.AnalysisFlags.DEPTH)
    assert rt.valid_analyses == rj.valid_analyses == tpipe.AnalysisFlags.DEPTH
    assert rel_l2(rt.depth_map_m, rj.depth_map_m) <= MODEL_TOL
    assert rt.depth_map_m.min() == pytest.approx(0.3, abs=1e-6)
