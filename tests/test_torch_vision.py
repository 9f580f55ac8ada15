"""The port's vision path against the JAX package on the CPU: preprocessing,
NMS, the detector (v8 and v5u), MiDaS depth, the CRNN OCR, box-depth
fusion and colour attributes, the scene graph and ``VisionPipeline``.

The same inputs, made from a seed with numpy, and the same weights (a
JAX-package tree filled from a numpy seed, carried across with each model
module's ``params_from_jax``) go through both packages. Tolerances: NMS
exact (ties at score 0 and class-aware boxes included); the letterbox and
the normalizations 2e-5 max abs (the reference's jitted resize contracts
products into FMAs, so its weights round apart; eager JAX gives the port's
bytes); detector boxes and probabilities, the depth map and OCR logits
1e-5 rel L2; fusion and colour means 1e-5 max abs; decoded strings, labels,
attributes, scene-graph edges, text regions and cues equal.
"""

import json
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from trackiellm_tpu.models import depth as jdepth
from trackiellm_tpu.models import detector as jdet
from trackiellm_tpu.models import ocr as jocr
from trackiellm_tpu.models import registry as jreg
from trackiellm_tpu.ops import nms as jnms
from trackiellm_tpu.ops import preprocess as jpre
from trackiellm_tpu.vision import object_analysis as joa
from trackiellm_tpu.vision import pipeline as jpipe
from trackiellm_tpu.vision import scene_graph as jsg
from trackiellm_tpu_torch.models import depth as tdepth
from trackiellm_tpu_torch.models import detector as tdet
from trackiellm_tpu_torch.models import ocr as tocr
from trackiellm_tpu_torch.models import registry as treg
from trackiellm_tpu_torch.ops import nms as tnms
from trackiellm_tpu_torch.ops import preprocess as tpre
from trackiellm_tpu_torch.vision import object_analysis as toa
from trackiellm_tpu_torch.vision import pipeline as tpipe
from trackiellm_tpu_torch.vision import scene_graph as tsg

CPU = torch.device("cpu")
FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                       "regression_cup_on_table.json")
MODEL_TOL = 1e-5   # rel L2: detector, depth, OCR against the JAX package
PRE_TOL = 2e-5     # max abs: letterbox and normalizations in [0, 1]-ish
STAT_TOL = 1e-5    # max abs: fused distances (m) and colour means


def np_tree(init, cfg, seed, scale=1.5):
    """A JAX-package param tree of ``init``'s shapes filled from a numpy
    seed (uniform, about ``scale`` / sqrt(fan-in)); no JAX random op runs."""
    shapes = jax.eval_shape(lambda: init(jax.random.PRNGKey(0), cfg))
    rng = np.random.default_rng(seed)

    def fill(s):
        fan = int(np.prod(s.shape[:-1])) if len(s.shape) > 1 else 100
        return (rng.uniform(-1, 1, s.shape) * scale / np.sqrt(fan)
                ).astype(np.float32)
    return jax.tree.map(fill, shapes)


def jtree(tree):
    return jax.tree.map(jnp.asarray, tree)


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _shapes(tree, hwio=False):
    """Leaf shapes of a tree in the port's layout (a JAX tree's HWIO
    convolutions read as OIHW when ``hwio``)."""
    if isinstance(tree, dict):
        return {k: _shapes(v, hwio) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_shapes(v, hwio) for v in tree]
    if tree is None:
        return None
    s = tuple(np.shape(tree))
    return (s[3], s[2], s[0], s[1]) if hwio and len(s) == 4 else s


# ---------------------------------------------------------------------------
# Preprocessing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hw", [(480, 640), (120, 160), (97, 131)])
def test_letterbox_matches_jax(hw):
    f = np.random.default_rng(hw[0]).integers(0, 256, (*hw, 3), np.uint8)
    jc, jm = jpre.letterbox_preprocess(jnp.asarray(f), 160, 160)
    tc, tm = tpre.letterbox_preprocess(torch.from_numpy(f), 160, 160)
    assert tc.shape == jc.shape and tc.dtype == torch.float32
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    assert np.abs(tc.numpy() - np.asarray(jc)).max() <= PRE_TOL


@pytest.mark.parametrize("fn", ["imagenet_normalize_chw", "dpt_normalize_chw"])
@pytest.mark.parametrize("hw", [(480, 640), (97, 131)])
def test_normalizations_match_jax(fn, hw):
    f = np.random.default_rng(3).integers(0, 256, (*hw, 3), np.uint8)
    ref = np.asarray(getattr(jpre, fn)(jnp.asarray(f), 96, 80))
    got = getattr(tpre, fn)(torch.from_numpy(f), 96, 80).numpy()
    assert got.shape == ref.shape == (3, 96, 80)
    # /255 scales the resize's rounding; the statistics divide by ~0.23.
    assert np.abs(got - ref).max() <= PRE_TOL * 5


def test_bilinear_resize_is_eager_jax_bit_for_bit():
    """Unjitted, the reference's gathers and products give the port's
    bytes: the tolerance above is XLA's FMA contraction alone."""
    f = np.random.default_rng(4).integers(0, 256, (97, 131, 3), np.uint8)
    with jax.disable_jit():
        ref = np.asarray(jpre._bilinear_resize(jnp.asarray(f), 118, 160))
    got = tpre._bilinear_resize(torch.from_numpy(f), 118, 160).numpy()
    np.testing.assert_array_equal(got, ref)


# ---------------------------------------------------------------------------
# NMS: exact, on tie-heavy inputs
# ---------------------------------------------------------------------------

def _tied_detections(seed, anchors=700, classes=6):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 100, (anchors, 2)).astype(np.float32)
    boxes = np.concatenate(
        [xy, xy + rng.uniform(5, 40, (anchors, 2)).astype(np.float32)], 1)
    # Quarter steps: equal scores everywhere, most under the threshold.
    scores = (np.round(rng.uniform(0, 1, (anchors, classes)) * 4) / 4
              ).astype(np.float32)
    return boxes, scores


@pytest.mark.parametrize("class_aware", [True, False])
@pytest.mark.parametrize("thresh,iou,max_out", [
    (0.5, 0.45, 32), (0.8, 0.3, 20), (0.99, 0.6, 8), (1.5, 0.45, 16)])
@pytest.mark.parametrize("seed", [0, 1])
def test_decode_and_nms_is_exact(seed, thresh, iou, max_out, class_aware):
    boxes, scores = _tied_detections(seed)
    ref = jnms.decode_and_nms(jnp.asarray(boxes), jnp.asarray(scores),
                              score_thresh=thresh, iou_thresh=iou,
                              max_out=max_out, class_aware=class_aware)
    got = tnms.decode_and_nms(torch.from_numpy(boxes),
                              torch.from_numpy(scores), score_thresh=thresh,
                              iou_thresh=iou, max_out=max_out,
                              class_aware=class_aware)
    for name, r, g in zip(ref._fields, ref, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r), err_msg=name)


def test_top_k_puts_the_lower_index_first():
    v = torch.tensor([0.0, 0.5, 0.0, 0.5, 0.9, 0.0, 0.0])
    top, idx = tnms.top_k_first_index(v, 5)
    jt, ji = jax.lax.top_k(jnp.asarray(v.numpy()), 5)
    assert idx.tolist() == np.asarray(ji).tolist() == [4, 1, 3, 0, 2]
    np.testing.assert_array_equal(top.numpy(), np.asarray(jt))


def test_pairwise_iou_and_boxes_to_original_match_jax():
    boxes, _ = _tied_detections(5, anchors=64)
    ref = np.asarray(jnms.pairwise_iou(jnp.asarray(boxes),
                                       jnp.asarray(boxes[::-1].copy())))
    got = tnms.pairwise_iou(torch.from_numpy(boxes),
                            torch.from_numpy(boxes[::-1].copy())).numpy()
    np.testing.assert_array_equal(got, ref)
    meta = np.asarray([1.2213740, 3.0, 21.0], np.float32)
    np.testing.assert_array_equal(
        tnms.boxes_to_original(torch.from_numpy(boxes),
                               torch.from_numpy(meta)).numpy(),
        np.asarray(jnms.boxes_to_original(jnp.asarray(boxes),
                                          jnp.asarray(meta))))


def test_greedy_sweep_is_greedy():
    """Candidate 0 kills 1, so 1 (suppressed) cannot kill 2."""
    cand = torch.zeros((3, 3), dtype=torch.bool)
    cand[0, 1] = cand[1, 2] = True
    assert tnms.greedy_sweep(cand).tolist() == [False, True, False]


# ---------------------------------------------------------------------------
# Models
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which", ["tiny", "tiny_v5"])
def test_detector_matches_jax(which):
    cfg = getattr(jdet.DetectorConfig, which)()
    tree = np_tree(jdet.init_detector, cfg, 0)
    img = np.random.default_rng(1).random((3, cfg.img_size, cfg.img_size),
                                          np.float32)
    jb, jc = jdet.detector_forward(jtree(tree), cfg, jnp.asarray(img))
    tcfg = getattr(tdet.DetectorConfig, which)()
    tb, tc = tdet.detector_forward(tdet.params_from_jax(tree, CPU), tcfg,
                                   torch.from_numpy(img))
    assert tb.shape == jb.shape and tc.shape == jc.shape
    assert rel_l2(tb, jb) <= MODEL_TOL and rel_l2(tc, jc) <= MODEL_TOL
    # The port's random init has the reference's tree in OIHW.
    init = tdet.init_detector(torch.Generator().manual_seed(0), tcfg)
    assert _shapes(init) == _shapes(tree, hwio=True)
    assert tcfg == tuple(cfg)


@pytest.mark.parametrize("which", ["v8n", "v5nu"])
def test_detector_configs_match_jax(which):
    assert getattr(tdet.DetectorConfig, which)() == tuple(
        getattr(jdet.DetectorConfig, which)())
    assert tdet.COCO_LABELS == jdet.COCO_LABELS


def test_depth_matches_jax():
    cfg = jdepth.DepthConfig.tiny()
    tree = np_tree(jdepth.init_depth, cfg, 2)
    img = np.random.default_rng(3).standard_normal(
        (3, cfg.img_size, cfg.img_size)).astype(np.float32)
    ref = jdepth.depth_forward(jtree(tree), cfg, jnp.asarray(img))
    got = tdepth.depth_forward(tdepth.params_from_jax(tree, CPU),
                               tdepth.DepthConfig.tiny(),
                               torch.from_numpy(img))
    assert got.shape == ref.shape and bool((got >= 0).all())
    assert rel_l2(got, ref) <= MODEL_TOL
    init = tdepth.init_depth(torch.Generator().manual_seed(0),
                             tdepth.DepthConfig.tiny())
    assert _shapes(init) == _shapes(tree, hwio=True)
    assert tdepth.DepthConfig.small() == tuple(jdepth.DepthConfig.small())


@pytest.mark.parametrize("lo,hi", [(0.3, 10.0), (0.5, 8.0)])
def test_relative_to_metric_matches_jax(lo, hi):
    rel = np.random.default_rng(4).random((40, 50)).astype(np.float32) * 3
    ref = np.asarray(jdepth.relative_to_metric(jnp.asarray(rel), lo, hi))
    got = tdepth.relative_to_metric(torch.from_numpy(rel), lo, hi).numpy()
    assert np.abs(got - ref).max() <= 1e-5
    assert got.min() == pytest.approx(lo) and got.max() == pytest.approx(hi)


def test_same_padding_2d_puts_the_odd_pad_after():
    assert tdepth.same_padding_2d(96, 96, 3, 3, 2) == (0, 1, 0, 1)
    assert tdepth.same_padding_2d(95, 96, 5, 5, 2) == (1, 2, 2, 2)
    assert tdepth.same_padding_2d(8, 8, 3, 3, 1) == (1, 1, 1, 1)


@pytest.mark.parametrize("up", ["_bilinear_up2", "_bilinear_up2_ac"])
def test_upsamples_match_jax(up):
    x = np.random.default_rng(5).standard_normal((1, 7, 5, 3)).astype(
        np.float32)
    ref = np.asarray(getattr(jdepth, up)(jnp.asarray(x)))
    got = getattr(tdepth, up)(torch.from_numpy(x).permute(0, 3, 1, 2))
    # A few ulps: the reference's source coordinates come from linspace,
    # F.interpolate's from a scale.
    assert np.abs(got.permute(0, 2, 3, 1).numpy() - ref).max() <= 4e-6


def test_ocr_matches_jax():
    cfg = jocr.OCRConfig.tiny()
    tree = np_tree(jocr.init_ocr, cfg, 6, scale=4.0)
    crops = np.random.default_rng(7).random((3, cfg.height, cfg.width),
                                            np.float32)
    ref = jocr.ocr_forward(jtree(tree), cfg, jnp.asarray(crops))
    got = tocr.ocr_forward(tocr.params_from_jax(tree, CPU),
                           tocr.OCRConfig.tiny(), torch.from_numpy(crops))
    assert got.shape == ref.shape
    assert rel_l2(got, ref) <= MODEL_TOL
    assert tocr.ctc_greedy_decode(got) == jocr.ctc_greedy_decode(ref)
    init = tocr.init_ocr(torch.Generator().manual_seed(0),
                         tocr.OCRConfig.tiny())
    assert _shapes(init) == _shapes(tree, hwio=True)
    assert tocr.CHARSET == jocr.CHARSET and tocr.OCRConfig() == tuple(
        jocr.OCRConfig())


def test_ctc_greedy_decode_matches_jax():
    idx = {c: i + 1 for i, c in enumerate(tocr.CHARSET)}
    seq = [idx["P"], idx["P"], 0, idx["á"], 0, idx["r"], idx["r"], 0,
           idx["r"]]
    logits = np.full((1, len(seq), len(tocr.CHARSET) + 1), -10.0,
                     np.float32)
    for t, s in enumerate(seq):
        logits[0, t, s] = 10.0
    assert tocr.ctc_greedy_decode(torch.from_numpy(logits)) == \
        jocr.ctc_greedy_decode(jnp.asarray(logits)) == ["Párr"]


# ---------------------------------------------------------------------------
# Fusion, attributes, scene graph
# ---------------------------------------------------------------------------

def _boxes(seed, n=9, h=60, w=80):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-5, [w, h], (n, 2))
    wh = rng.uniform(0.5, 30, (n, 2))
    boxes = np.concatenate([xy, xy + wh], 1).astype(np.float32)
    valid = rng.random(n) > 0.25
    return boxes, valid


def test_fuse_boxes_with_depth_matches_jax():
    boxes, valid = _boxes(8)
    depth = (np.random.default_rng(9).random((60, 80)) * 9 + 0.3).astype(
        np.float32)
    ref = np.asarray(joa.fuse_boxes_with_depth(
        jnp.asarray(boxes), jnp.asarray(valid), jnp.asarray(depth)))
    got = toa.fuse_boxes_with_depth(torch.from_numpy(boxes),
                                    torch.from_numpy(valid),
                                    torch.from_numpy(depth)).numpy()
    assert np.abs(got - ref).max() <= STAT_TOL
    assert (got[~valid] == 0).all()


def test_box_color_stats_and_attributes_match_jax():
    boxes, valid = _boxes(10)
    img = np.random.default_rng(11).random((60, 80, 3)).astype(np.float32)
    ref = np.asarray(joa.box_color_stats(jnp.asarray(img),
                                         jnp.asarray(boxes),
                                         jnp.asarray(valid)))
    got = toa.box_color_stats(torch.from_numpy(img), torch.from_numpy(boxes),
                              torch.from_numpy(valid)).numpy()
    assert np.abs(got - ref).max() <= STAT_TOL
    assert toa.attributes_for(got, valid) == joa.attributes_for(ref, valid)
    rgbs = np.random.default_rng(12).random((200, 3))
    assert ([toa.rgb_to_color_name(c) for c in rgbs]
            == [joa.rgb_to_color_name(c) for c in rgbs])


def test_scene_graph_matches_jax():
    rng = np.random.default_rng(13)
    args = []
    for i in range(12):
        x, y = rng.uniform(0, 100, 2)
        args.append((i, f"obj{i % 4}", [x, y, x + rng.uniform(5, 40),
                                        y + rng.uniform(5, 40)],
                     None if i % 5 == 0 else float(rng.uniform(0.5, 4)),
                     [f"color:c{i}"]))
    ref = jsg.build_scene_graph([jsg.SceneNode(*a) for a in args])
    got = tsg.build_scene_graph([tsg.SceneNode(*a) for a in args])
    assert got == ref and got["edges"]
    assert tsg.scene_graph_to_json(got) == jsg.scene_graph_to_json(ref)
    assert tsg.describe_scene_graph(got) == jsg.describe_scene_graph(ref)


def test_model_registry_serves_handles():
    svc = treg.ModelService()
    svc.register_factory(treg.ModelId.OCR, lambda: "crnn")
    assert svc.get(treg.ModelId.OCR) == "crnn"
    assert svc.loaded()["ocr"] and not svc.loaded()["main_llm"]
    assert svc.try_get(treg.ModelId.ASR) is None
    assert svc.unload(treg.ModelId.OCR)
    assert treg.global_model_service() is treg.global_model_service()
    assert [m.value for m in treg.ModelId] == [m.value for m in jreg.ModelId]


# ---------------------------------------------------------------------------
# VisionPipeline against the JAX pipeline
# ---------------------------------------------------------------------------

def _fixture():
    with open(FIXTURE) as f:
        return json.load(f)


def _fixture_frame(fx):
    """The cup-on-table frame: dark background, brown table, red cup."""
    w, h = fx["camera"]["width"], fx["camera"]["height"]
    frame = np.full((h, w, 3), 40, np.uint8)
    tb = fx["objects"][1]["box"]
    frame[tb[1]:tb[3], tb[0]:tb[2]] = (120, 80, 40)
    cb = fx["objects"][0]["box"]
    frame[cb[1]:cb[3], cb[0]:cb[2]] = (220, 30, 30)
    return frame


def _stub_rows(fx, input_size=640):
    labels = tdet.COCO_LABELS
    h, w = fx["camera"]["height"], fx["camera"]["width"]
    scale = min(input_size / h, input_size / w)
    pad_y = (input_size - round(h * scale)) // 2
    pad_x = (input_size - round(w * scale)) // 2
    rows = []
    for obj in fx["objects"]:
        b = obj["box"]
        rows.append(([b[0] * scale + pad_x, b[1] * scale + pad_y,
                      b[2] * scale + pad_x, b[3] * scale + pad_y],
                     labels.index(obj["label"]), 0.9))
    return rows


def _stub_raw(fx):
    boxes = np.zeros((16, 4), np.float32)
    scores = np.zeros((16, 80), np.float32)
    for i, (lb, cid, sc) in enumerate(_stub_rows(fx)):
        boxes[i] = lb
        scores[i, cid] = sc
    return boxes, scores


def _stubs(fx, side, depth_input=384, fail=None, calls=None):
    """The same stub backends for either package: the detector emits the
    fixture's boxes in letterbox space, depth is flat, OCR reads bright
    strips."""
    boxes, scores = _stub_raw(fx)
    arr = jnp.asarray if side == "jax" else torch.from_numpy
    calls = calls if calls is not None else {}

    def det(chw):
        calls["det"] = calls.get("det", 0) + 1
        if fail == "det":
            raise RuntimeError("model exploded")
        return arr(boxes), arr(scores)

    def dep(chw):
        calls["depth"] = calls.get("depth", 0) + 1
        if fail == "depth":
            raise RuntimeError("depth exploded")
        return arr(np.full((depth_input, depth_input), 0.5, np.float32))

    def ocr(crops):
        calls.setdefault("ocr", []).append(crops.shape[0])
        return ["PARE" if float(c.mean()) > 0.3 else "" for c in crops]
    return det, dep, ocr


def _result_summary(res):
    return {
        "objects": [(o.class_id, o.label, round(o.confidence, 6),
                     [round(v, 3) for v in o.box],
                     None if o.distance_m is None else round(o.distance_m, 4),
                     None if o.min_distance_m is None
                     else round(o.min_distance_m, 4),
                     o.attributes, o.text) for o in res.objects],
        "edges": None if res.scene_graph is None else res.scene_graph[
            "edges"],
        "valid": int(res.valid_analyses),
        "regions": [(t.box, t.text) for t in res.text_regions],
        "full_text": res.full_text, "cues": res.navigation_cues,
        "barcodes": res.barcodes,
        "depth": None if res.depth_map_m is None else res.depth_map_m.shape,
        "timings": sorted(res.timings_ms),
    }


def test_golden_fixture_with_stubs_matches_jax():
    fx = _fixture()
    frame = _fixture_frame(fx)
    frame[0:100, 330:630] = 255  # a bright sign: the page scan reads it

    def run(side, mod):
        det, dep, ocr = _stubs(fx, side)
        return mod.VisionPipeline(
            det, dep, ocr, barcode_fn=lambda g: [f"{g.shape}"],
            **({} if side == "jax" else {"device": CPU})).process_frame(
                frame, mod.AnalysisFlags.ALL)
    rj, rt = run("jax", jpipe), run("torch", tpipe)
    assert _result_summary(rt) == _result_summary(rj)
    by_id = {n["id"]: n["label"] for n in rt.scene_graph["nodes"]}
    rels = {(by_id[e["src"]], by_id[e["dst"]], e["relation"])
            for e in rt.scene_graph["edges"]}
    assert ("cup", "dining table", "on_top_of") in rels
    cup = next(o for o in rt.objects if o.label == "cup")
    assert "color:red" in cup.attributes
    assert rt.valid_analyses == tpipe.AnalysisFlags.ALL & ~(
        tpipe.AnalysisFlags.NAVIGATION)
    assert "PARE" in rt.full_text
    np.testing.assert_allclose(rt.depth_map_m, rj.depth_map_m, atol=1e-6)


def test_tiny_models_pipeline_matches_jax():
    """The tiny detector, MiDaS, OCR and a navigation engine on both
    sides, the same weights; RANSAC's indices are the JAX engine's draw."""
    from trackiellm_tpu.navigation import NavigationEngine as JNav
    from trackiellm_tpu_torch.navigation import NavigationEngine as TNav

    dcfg, pcfg, ocfg = (jdet.DetectorConfig.tiny(), jdepth.DepthConfig.tiny(),
                        jocr.OCRConfig.tiny())
    # Scales at which the random models give varied outputs: class
    # probabilities up to ~0.66, a depth map positive everywhere.
    dtree = np_tree(jdet.init_detector, dcfg, 20, scale=3.0)
    ptree = np_tree(jdepth.init_depth, pcfg, 2)
    otree = np_tree(jocr.init_ocr, ocfg, 22, scale=4.0)
    jd, jp_, jo = jtree(dtree), jtree(ptree), jtree(otree)
    td = tdet.params_from_jax(dtree, CPU)
    tp_ = tdepth.params_from_jax(ptree, CPU)
    to = tocr.params_from_jax(otree, CPU)
    tcfg = dict(detector_input=dcfg.img_size, depth_input=pcfg.img_size,
                confidence_threshold=0.55, max_objects=6,
                labels=tuple(f"c{i}" for i in range(dcfg.num_classes)))
    fx = _fixture()
    frame = _fixture_frame(fx)

    class IndexedNav(TNav):
        """The port's engine fed the JAX engine's RANSAC indices."""

        def __init__(self, ref):
            super().__init__(device=CPU)
            self.ref = ref

        def update(self, depth, orientation=None):
            self.ref._key, sub = jax.random.split(self.ref._key)
            idx = jax.random.randint(sub, (100, 3), 0, depth.size)
            return super().update(depth, orientation,
                                  indices=torch.from_numpy(np.array(idx)))

    jnav = JNav()
    shadow = JNav()
    jpipe_ = jpipe.VisionPipeline(
        lambda chw: jdet.detector_forward(jd, dcfg, chw),
        lambda chw: jdepth.depth_forward(jp_, pcfg, chw),
        lambda crops: jocr.ctc_greedy_decode(
            jocr.ocr_forward(jo, ocfg, jnp.asarray(crops))),
        config=jpipe.VisionConfig(**tcfg), navigation_engine=jnav)
    tpipe_ = tpipe.VisionPipeline(
        lambda chw: tdet.detector_forward(td, tdet.DetectorConfig.tiny(),
                                          chw),
        lambda chw: tdepth.depth_forward(tp_, tdepth.DepthConfig.tiny(), chw),
        lambda crops: tocr.ctc_greedy_decode(tocr.ocr_forward(
            to, tocr.OCRConfig.tiny(), torch.from_numpy(crops))),
        config=tpipe.VisionConfig(**tcfg), navigation_engine=IndexedNav(
            shadow), device=CPU)
    for _ in range(2):
        rj = jpipe_.process_frame(frame, jpipe.AnalysisFlags.ALL)
        rt = tpipe_.process_frame(frame, tpipe.AnalysisFlags.ALL)
        assert rj.objects, "the tiny detector found nothing"
        sj, st = _result_summary(rj), _result_summary(rt)
        for key in ("edges", "valid", "regions", "full_text", "cues",
                    "depth", "timings"):
            assert st[key] == sj[key], key
        assert len(rt.objects) == len(rj.objects)
        for a, b in zip(rt.objects, rj.objects):
            assert (a.class_id, a.label, a.attributes, a.text) == (
                b.class_id, b.label, b.attributes, b.text)
            assert a.confidence == pytest.approx(b.confidence, abs=1e-5)
            np.testing.assert_allclose(a.box, b.box, atol=1e-3)
            assert a.distance_m == pytest.approx(b.distance_m, abs=1e-4)
        assert rel_l2(rt.depth_map_m, rj.depth_map_m) <= MODEL_TOL
        np.testing.assert_array_equal(tpipe_.navigation_engine.grid,
                                      jnav.grid)
    assert rt.valid_analyses == tpipe.AnalysisFlags.ALL


def _behaviour(case):
    """One behaviour of the reference's pipeline tests, run on either
    package; returns what the case observes."""
    fx = _fixture()
    frame = _fixture_frame(fx)
    sign = {"camera": fx["camera"],
            "objects": [{"label": "stop sign",
                         "box": [100, 100, 200, 200]}] * 2}

    def run(side, mod):
        kw = {} if side == "jax" else {"device": CPU}
        calls = {}
        if case == "degradation":
            det, dep, _ = _stubs(fx, side, fail="det", calls=calls)
            r = mod.VisionPipeline(det, dep, **kw).process_frame(
                np.zeros((480, 640, 3), np.uint8))
            return int(r.valid_analyses), len(r.objects)
        if case == "depth_degradation":
            det, dep, _ = _stubs(fx, side, fail="depth", calls=calls)
            r = mod.VisionPipeline(det, dep, **kw).process_frame(frame)
            return int(r.valid_analyses), [o.distance_m for o in r.objects]
        if case == "flag_gating":
            det, dep, _ = _stubs(fx, side, calls=calls)
            r = mod.VisionPipeline(det, dep, **kw).process_frame(
                np.zeros((64, 64, 3), np.uint8), mod.AnalysisFlags.DETECTION)
            return calls, int(r.valid_analyses)
        if case == "thresholds":
            det, _, _ = _stubs(fx, side)
            pipe = mod.VisionPipeline(det, **kw)
            n1 = len(pipe.process_frame(
                frame, mod.AnalysisFlags.DETECTION).objects)
            pipe.update_thresholds(confidence=0.95)
            n2 = len(pipe.process_frame(
                frame, mod.AnalysisFlags.DETECTION).objects)
            pipe.update_thresholds(confidence=0.5, max_objects=1)
            n3 = len(pipe.process_frame(
                frame, mod.AnalysisFlags.DETECTION).objects)
            return n1, n2, n3
        if case in ("ocr_cache", "auto_trigger"):
            det, _, ocr = _stubs(sign, side, calls=calls)
            pipe = mod.VisionPipeline(det, ocr_fn=ocr, **kw)
            f = _fixture_frame({"camera": fx["camera"],
                                "objects": sign["objects"]})
            flags = (mod.AnalysisFlags.DETECTION
                     | (mod.AnalysisFlags.OCR if case == "ocr_cache"
                        else mod.AnalysisFlags.NONE))
            r1 = pipe.process_frame(f, flags)
            r2 = pipe.process_frame(f, flags)
            return (calls["ocr"], pipe.ocr_cache_hits,
                    [o.text for o in r1.objects],
                    [o.text for o in r2.objects])
        if case == "regex_filter":
            f = np.zeros((96, 128, 3), np.uint8)
            f[10:20, 70:120] = 255
            _, _, ocr = _stubs(fx, side)
            pipe = mod.VisionPipeline(None, ocr_fn=ocr, **kw)
            pipe.set_ocr_filter(r"^\d+$")
            r1 = pipe.process_frame(f, mod.AnalysisFlags.OCR)
            pipe.set_ocr_filter(None)
            pipe._ocr_cache.clear()
            r2 = pipe.process_frame(f, mod.AnalysisFlags.OCR)
            return ([(t.box, t.text) for t in r1.text_regions],
                    [(t.box, t.text) for t in r2.text_regions],
                    int(r2.valid_analyses))
        if case == "reading_order":
            f = np.zeros((96, 128, 3), np.uint8)
            f[80:92, 0:60] = 255
            f[4:16, 0:60] = 255
            _, _, ocr = _stubs(fx, side)
            r = mod.VisionPipeline(None, ocr_fn=ocr, **kw).process_frame(
                f, mod.AnalysisFlags.OCR)
            return [(t.box, t.text) for t in r.text_regions], r.full_text
        raise AssertionError(case)
    return run("jax", jpipe), run("torch", tpipe)


@pytest.mark.parametrize("case", [
    "degradation", "depth_degradation", "flag_gating", "thresholds",
    "ocr_cache", "auto_trigger", "regex_filter", "reading_order"])
def test_pipeline_behaviour_matches_jax(case):
    ref, got = _behaviour(case)
    assert got == ref
    if case == "degradation":
        assert got == (int(tpipe.AnalysisFlags.DEPTH), 0)
    if case == "ocr_cache":
        assert len(got[0]) == 1 and got[1] >= 1 and got[3][0] == "PARE"
    if case == "thresholds":
        assert got[1] < got[0] and got[2] == 1


def test_invalid_regex_is_refused():
    pipe = tpipe.VisionPipeline(None, device=CPU)
    with pytest.raises(Exception):
        pipe.set_ocr_filter("(unclosed")


def test_fetch_packs_one_copy():
    t = [torch.tensor([[1.5, 2.0]]), None, torch.tensor([3, -1],
                                                         dtype=torch.int32),
         torch.tensor([True, False])]
    got = tpipe.fetch(t)
    np.testing.assert_array_equal(got[0], [[1.5, 2.0]])
    assert got[1] is None and got[2].dtype == np.int32
    assert got[2].tolist() == [3, -1] and got[3].tolist() == [True, False]
