"""The port's vision converters against the JAX package's on the CPU, on
state dicts in the published layouts: ultralytics YOLOv8 and YOLOv5u
(torch transcriptions from the reference's tests, BN statistics
randomized), MiDaS v2.1 small (its transcription, and the bundled
``midas_small`` name map's published shapes), the CRNN, and
``transformers``' DPT-SwinV2.

Each converted tree must equal the JAX package's, carried across with
``params_from_jax``, byte for byte (the BN folds run in numpy f32 on both
sides), with the same config; the converted models' outputs are held
against the torch oracles at the reference tests' 2e-3.
"""

import numpy as np
import pytest

import jax
import torch

from trackiellm_tpu.models import convert as jc
from trackiellm_tpu_torch.models import convert as tc
from trackiellm_tpu_torch.models import depth as tdepth
from trackiellm_tpu_torch.models import detector as tdet
from trackiellm_tpu_torch.models import dpt as tdpt
from trackiellm_tpu_torch.models import ocr as tocr
from trackiellm_tpu_torch.utils.errors import ErrorCode, TrackieError

CPU = torch.device("cpu")
ORACLE_TOL = 2e-3


def _assert_same_tree(got, ref_port):
    """Two trees in the port's layout: the same structure and bytes."""
    if isinstance(ref_port, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(ref_port)
        for k in ref_port:
            _assert_same_tree(got[k], ref_port[k])
    elif isinstance(ref_port, (list, tuple)):
        assert len(got) == len(ref_port)
        for a, b in zip(got, ref_port):
            _assert_same_tree(a, b)
    elif ref_port is None:
        assert got is None
    else:
        assert got.dtype == ref_port.dtype and got.shape == ref_port.shape
        assert torch.equal(got, ref_port)


def _carried(module, jax_tree):
    return module.params_from_jax(jax.tree.map(np.asarray, jax_tree), CPU)


def _yolo(variant, seed):
    from tests.test_detector_convert import TV5, TV8, _randomize_bn
    from trackiellm_tpu.models.detector import DetectorConfig

    cfg = (DetectorConfig.tiny_v5() if variant == "v5"
           else DetectorConfig.tiny())
    torch.manual_seed(seed)
    model = (TV5 if variant == "v5" else TV8)(cfg).eval()
    _randomize_bn(model, torch.Generator().manual_seed(seed))
    return cfg, model


@pytest.mark.parametrize("variant", ["v8", "v5"])
def test_detector_from_torch_matches_jax(variant):
    cfg, model = _yolo(variant, 3)
    state = {k: v.numpy() for k, v in model.state_dict().items()}
    params, got_cfg = tc.detector_from_torch(state, device=CPU)
    ref, ref_cfg = jc.detector_from_torch(state)
    assert got_cfg == tuple(ref_cfg)
    assert got_cfg._replace(img_size=cfg.img_size) == tuple(cfg)
    _assert_same_tree(params, _carried(tdet, ref))
    img = np.random.RandomState(4).rand(3, cfg.img_size, cfg.img_size
                                        ).astype(np.float32)
    with torch.no_grad():
        want_b, want_c = model.decode(model(torch.from_numpy(img)[None]))
    boxes, cls = tdet.detector_forward(params, got_cfg._replace(
        img_size=cfg.img_size), torch.from_numpy(img))
    np.testing.assert_allclose(boxes.numpy(), want_b.numpy(),
                               rtol=ORACLE_TOL, atol=ORACLE_TOL)
    np.testing.assert_allclose(cls.numpy(), want_c.numpy(),
                               rtol=ORACLE_TOL, atol=ORACLE_TOL)


@pytest.mark.parametrize("which", ["v8n", "v5nu"])
def test_detector_config_from_published_widths(which):
    from tests.test_detector_convert import TV5, TV8
    from trackiellm_tpu.models.detector import DetectorConfig

    cfg = getattr(DetectorConfig, which)()
    model = (TV5 if cfg.variant == "v5" else TV8)(cfg)
    state = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    got = tc.detector_config_from_torch(state)
    assert got == getattr(tdet.DetectorConfig, which)()
    assert got == tuple(jc.detector_config_from_torch(state))


def _midas(seed):
    from tests.test_depth_convert import TMidasSmall, _randomize_bn
    from trackiellm_tpu.models.depth import DepthConfig

    cfg = DepthConfig.tiny()
    torch.manual_seed(seed)
    model = TMidasSmall(cfg).eval()
    _randomize_bn(model, torch.Generator().manual_seed(seed))
    return cfg, model


def test_midas_small_from_torch_matches_jax():
    cfg, model = _midas(0)
    state = {k: v.numpy() for k, v in model.state_dict().items()}
    params, got_cfg = tc.midas_small_from_torch(state, device=CPU)
    ref, ref_cfg = jc.midas_small_from_torch(state)
    assert got_cfg == tuple(ref_cfg)
    assert got_cfg._replace(img_size=cfg.img_size) == tuple(cfg)
    _assert_same_tree(params, _carried(tdepth, ref))
    img = np.random.RandomState(2).rand(3, cfg.img_size, cfg.img_size
                                        ).astype(np.float32)
    with torch.no_grad():
        want = model(torch.from_numpy(img)[None])[0].numpy()
    got = tdepth.depth_forward(params, got_cfg, torch.from_numpy(img))
    np.testing.assert_allclose(got.numpy(), want, rtol=ORACLE_TOL,
                               atol=ORACLE_TOL)


def test_midas_name_map_reads_the_published_layout():
    """The bundled map equals the JAX package's; a state dict at its
    published names and shapes (MiDaS v2.1 small, random) converts to
    DepthConfig.small() and to the JAX package's tree."""
    import json

    mapping = tc.load_name_map("midas_small")
    assert mapping == jc.load_name_map("midas_small")
    path = tc.load_name_map.__code__.co_filename.replace(
        "convert.py", "name_maps/midas_small.json")
    with open(path, encoding="utf-8") as f:
        shapes = {k[len("_shape:"):]: v for k, v in json.load(f).items()
                  if k.startswith("_shape:")}
    rng = np.random.default_rng(5)
    published = {v: k for k, v in mapping.items()}
    state = {}
    for name, shape in shapes.items():
        if name.endswith("running_var"):
            a = rng.uniform(0.5, 1.5, shape)
        elif len(shape) == 0:
            a = np.zeros(shape)
        else:
            a = rng.standard_normal(shape) * 0.1
        state[published.get(name, name)] = a.astype(np.float32)
    state = tc.apply_name_map(state, mapping, strict=True)
    params, cfg = tc.midas_small_from_torch(state, device=CPU)
    ref, _ = jc.midas_small_from_torch(state)
    assert cfg == tdepth.DepthConfig.small()
    _assert_same_tree(params, _carried(tdepth, ref))


def _crnn_state(cfg, seed, n_bias=0.0):
    """A CRNN state dict in torch layouts: Conv2d (O, I, 3, 3), GRUCell
    weight_ih (3H, F) / weight_hh (3H, H) with r, z, n biases, Linear."""
    rng = np.random.default_rng(seed)
    c, h = cfg.conv_ch, cfg.hidden
    feat = c * cfg.height // 8

    def r(*shape, s=0.2):
        return (rng.standard_normal(shape) * s).astype(np.float32)
    st = {"conv1.weight": r(c // 2, 1, 3, 3), "conv1.bias": r(c // 2),
          "conv2.weight": r(c, c // 2, 3, 3), "conv2.bias": r(c),
          "conv3.weight": r(c, c, 3, 3), "conv3.bias": r(c),
          "out.weight": r(cfg.num_classes, 2 * h), "out.bias": r(
              cfg.num_classes)}
    for side in ("gru_fwd", "gru_bwd"):
        st[f"{side}.weight_ih"] = r(3 * h, feat, s=0.05)
        st[f"{side}.weight_hh"] = r(3 * h, h)
        st[f"{side}.bias_ih"] = r(3 * h)
        bh = r(3 * h)
        bh[2 * h:] = n_bias
        st[f"{side}.bias_hh"] = bh
    return st


def test_ocr_from_torch_matches_jax():
    cfg = tocr.OCRConfig.tiny()
    state = _crnn_state(cfg, 6)
    params, got_cfg = tc.ocr_from_torch(state, device=CPU)
    ref, ref_cfg = jc.ocr_from_torch(state)
    assert got_cfg == tuple(ref_cfg) == cfg
    _assert_same_tree(params, _carried(tocr, ref))
    # The folded biases give torch's GRU: one step of the forward side.
    x = torch.from_numpy(np.random.default_rng(7).random(
        (1, cfg.height, cfg.width), np.float32))
    logits = tocr.ocr_forward(params, cfg, x)
    assert logits.shape == (1, cfg.width // 8, cfg.num_classes)
    cell = torch.nn.GRUCell(state["gru_fwd.weight_ih"].shape[1], cfg.hidden)
    with torch.no_grad():
        for name in ("weight_ih", "weight_hh", "bias_ih", "bias_hh"):
            getattr(cell, name).copy_(torch.from_numpy(
                state[f"gru_fwd.{name}"]))
        feat = torch.randn(2, cell.input_size)
        want = cell(feat)
        got = tocr._gru_scan(params["gru_fwd"], feat[None])[0]
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)


def test_ocr_from_torch_refuses_an_n_gate_hidden_bias():
    state = _crnn_state(tocr.OCRConfig.tiny(), 8, n_bias=0.1)
    with pytest.raises(TrackieError) as err:
        tc.ocr_from_torch(state, device=CPU)
    assert err.value.code == ErrorCode.MODEL_METADATA_INVALID


@pytest.fixture(scope="module")
def dpt_oracle():
    pytest.importorskip("transformers")
    from tests.test_dpt import _oracle

    model = _oracle()
    return model, {k: v.numpy() for k, v in model.state_dict().items()}


def test_dpt_swinv2_from_torch_matches_jax(dpt_oracle):
    model, state = dpt_oracle
    params, cfg = tc.dpt_swinv2_from_torch(state, image_size=64,
                                           window_size=4, device=CPU)
    ref, ref_cfg = jc.dpt_swinv2_from_torch(state, image_size=64,
                                            window_size=4)
    assert cfg == tuple(ref_cfg) and cfg.depths == (2, 6, 2, 2)
    _assert_same_tree(params, _carried(tdpt, ref))
    img = np.random.default_rng(9).standard_normal((3, 64, 64)).astype(
        np.float32)
    with torch.no_grad():
        want = model(pixel_values=torch.from_numpy(img)[None]
                     ).predicted_depth[0].numpy()
    got = tdpt.dpt_forward(params, cfg, torch.from_numpy(img)).numpy()
    np.testing.assert_allclose(got, want, rtol=ORACLE_TOL,
                               atol=ORACLE_TOL * float(np.abs(want).max()))


@pytest.mark.parametrize("which", ["detector", "midas", "ocr", "dpt"])
def test_vision_converters_need_a_card_or_an_explicit_cpu(which,
                                                          monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    call = {"detector": lambda: tc.detector_from_torch({}),
            "midas": lambda: tc.midas_small_from_torch({}),
            "ocr": lambda: tc.ocr_from_torch({}),
            "dpt": lambda: tc.dpt_swinv2_from_torch({})}[which]
    with pytest.raises(TrackieError) as err:
        call()
    assert err.value.code == ErrorCode.DEVICE_UNAVAILABLE
    with pytest.raises(TrackieError) as err:
        {"detector": tdet, "midas": tdepth, "ocr": tocr,
         "dpt": tdpt}[which].params_from_jax({"w": np.zeros((1, 1, 1, 1))})
    assert err.value.code == ErrorCode.DEVICE_UNAVAILABLE
