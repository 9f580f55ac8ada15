"""The port's ``precompile`` command and its kernel-cache artifact, on the
CPU.

``precompile --device cpu`` on a tiny checkpoint written here warms the
llm and server stages (the other stages at tiny configs through their
functions); no kernel library is built without a card, the native runtime
is. ``tools/cache_artifact.py`` packs a build directory (a stand-in kernel
library beside the real native runtime), restores it into an empty one
byte for byte, prints its manifest, warns when the manifest and the host
differ and refuses members outside the build directory; a restored library
is found with no compiler run (``ops/_build.py``'s ``last_build``), and the
restored native runtime, as the one ``precompile --cache-dir`` built, loads
in a fresh process with no g++ on its PATH.
"""

import io
import json
import os
import subprocess
import sys
import tarfile

import numpy as np
import pytest
import torch

from trackiellm_tpu_torch import __main__ as cli
from trackiellm_tpu_torch import precompile
from trackiellm_tpu_torch.ffi import native
from trackiellm_tpu_torch.models import checkpoint, llm
from trackiellm_tpu_torch.ops import _build
from trackiellm_tpu_torch.tools import cache_artifact

CPU = torch.device("cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny_checkpoint(tmp_path_factory):
    cfg = llm.LLMConfig.tiny()._replace(max_seq=1024, sliding_window=1024)
    params = llm.init_params_quantized(torch.Generator().manual_seed(0), cfg,
                                       bits=4, group=32, device=CPU)
    path = str(tmp_path_factory.mktemp("ckpt"))
    checkpoint.save_checkpoint(path, params, cfg)
    return path


def test_precompile_warms_the_llm_and_server_stages(tiny_checkpoint,
                                                    capsys):
    assert cli.main(["precompile", "--device", "cpu", "--llm",
                     tiny_checkpoint, "--skip",
                     "asr,tts,vision,dpt,vlm"]) == 0
    out = capsys.readouterr().out.splitlines()
    warm = [ln for ln in out if ln.endswith(" warm")]
    assert [ln.split("] ", 1)[1] for ln in warm] == [
        "llm: params (2 layers) warm",
        "llm: small prefill bucket + decode chunks warm",
        "llm: streaming generate (on_token) shape warm",
        "llm: prime/extend chunk buckets warm",
        "llm: large prefill bucket warm",
        "llm: sampled speculative verify warm",
        "server: admission-wave prefill + batched decode chunks warm"]
    assert any("kernels: not built (device cpu)" in ln for ln in out)
    assert any("native: " in ln and str(native.library_path()) in ln
               for ln in out)
    report = json.loads(out[-1])["precompile"]
    assert report["build"]["kernels"] is None
    assert report["build"]["native"]["path"] == str(native.library_path())
    assert set(report["launches"]) == {
        "q4_matmul_w4a8", "quantize_activations", "flash_attention",
        "q8_matmul", "q4_matmul_f32a", "fused_mlp_q4", "q4_matmul_stream",
        "stream", "grid64", "chain_tiny"}
    assert not any(report["launches"].values())  # no kernel on the CPU


def test_a_later_process_finds_what_precompile_built_in_its_cache_dir(
        tmp_path, monkeypatch, capsys):
    """``precompile --cache-dir X`` builds the native runtime into X; a
    process started after it with ``TRACKIE_BUILD_DIR=X`` and no g++ on
    its PATH loads that runtime, and looks for the kernel library there."""
    cache = tmp_path / "cache"
    monkeypatch.setattr(_build, "BUILD_ROOT", _build.BUILD_ROOT)
    monkeypatch.delenv("TRACKIE_BUILD_DIR", raising=False)
    assert cli.main(["precompile", "--device", "cpu", "--cache-dir",
                     str(cache), "--skip", ",".join(precompile.STAGES)]) == 0
    report = json.loads(capsys.readouterr().out.splitlines()[-1])
    built = report["precompile"]["build"]["native"]
    assert built["path"] == str(native.library_path(cache))
    assert built["compiled"] is True
    code = ("from trackiellm_tpu_torch.ffi import native; "
            "from trackiellm_tpu_torch.ops import _build; "
            "assert native.native_available(); "
            "print(native.library_path()); print(_build.library_path())")
    env = dict(os.environ, TRACKIE_BUILD_DIR=str(cache), PATH="")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == [str(native.library_path(cache)),
                                  str(_build.library_path(cache))]


def test_precompile_refuses_an_unknown_stage(tiny_checkpoint):
    with pytest.raises(ValueError, match="unknown stages"):
        precompile.run(CPU, 1024, tiny_checkpoint, ["llm", "bench"])


def test_precompile_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is here")
    with pytest.raises(SystemExit, match="no CUDA device"):
        cli.main(["precompile", "--skip", "llm,server,asr,tts,vision,dpt,"
                  "vlm"])


def _stage(name, params, cfg, mark):
    from trackiellm_tpu_torch.models import (clip, depth, detector, dpt,
                                             tts, whisper)
    from trackiellm_tpu_torch.vision.pipeline import VisionConfig
    if name == "asr":
        precompile.warm_asr(CPU, mark, whisper.WhisperConfig.tiny()._replace(
            d_model=64, n_heads=2, n_audio_layers=1, n_text_layers=1,
            n_audio_ctx=500))
    elif name == "tts":
        precompile.warm_tts(CPU, mark, tts.TTSConfig.tiny())
    elif name == "vision":
        dcfg, pcfg = detector.DetectorConfig.tiny(), depth.DepthConfig.tiny()
        conf = VisionConfig(detector_input=dcfg.img_size,
                            depth_input=pcfg.img_size)
        precompile.warm_vision(CPU, mark, dcfg, pcfg, conf)
    elif name == "dpt":
        precompile.warm_dpt(CPU, mark, dpt.DPTSwinConfig.test_tiny())
    else:
        precompile.warm_vlm(params, cfg, CPU, mark, 1024,
                            clip.CLIPVisionConfig(
                                image_size=28, patch_size=14, dim=32,
                                n_layers=2, n_heads=2, hidden_dim=64,
                                proj_dim=cfg.dim))


@pytest.mark.parametrize("name,marks", [
    ("asr", 1), ("tts", 1), ("vision", 1), ("dpt", 1), ("vlm", 2)])
def test_stages_run_at_tiny_configs(tiny_checkpoint, name, marks):
    """The stages the CPU command skips, at tiny configs: each reaches its
    entry points and marks its warm lines."""
    params, cfg = precompile.llm_model(CPU, 1024, tiny_checkpoint)
    mark = precompile.Marks()
    _stage(name, params, cfg, mark)
    assert len(mark.done) == marks
    assert all(n.startswith(name) for n, _ in mark.done)


# --- the cache artifact ------------------------------------------------------

@pytest.fixture
def build_root(tmp_path, monkeypatch):
    """A build directory holding a stand-in kernel library at this
    checkout's hash and a copy of the real native runtime."""
    assert native.native_available()
    root = tmp_path / "built"
    monkeypatch.setattr(_build, "BUILD_ROOT", root)
    kernels = _build.library_path()
    kernels.parent.mkdir(parents=True)
    kernels.write_bytes(b"\x7fELF stand-in kernel library")
    lib = native.library_path()
    lib.parent.mkdir(parents=True)
    with open(native._lib._name, "rb") as src:
        lib.write_bytes(src.read())
    return root


def _files(root):
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


def test_pack_restore_info_round_trip(build_root, tmp_path, monkeypatch,
                                      capsys):
    art = str(tmp_path / "kernels.tar.gz")
    assert cache_artifact.main(["pack", "-o", art]) == 0
    packed = json.loads(capsys.readouterr().out)
    assert packed["kernel_digest"] == _build._digest()
    assert packed["native_digest"] == native._digest()
    assert sorted(packed["entries"]) == sorted(_files(build_root))
    fresh = tmp_path / "fresh"
    monkeypatch.setattr(_build, "BUILD_ROOT", fresh)
    assert cache_artifact.main(["restore", art]) == 0
    restored = json.loads(capsys.readouterr().out)
    assert restored["restored"] == 2 and restored["mismatches"] == []
    assert _files(fresh) == _files(build_root)
    assert cache_artifact.main(["info", art]) == 0
    info = json.loads(capsys.readouterr().out)
    for key in ("torch", "cuda_runtime", "nvcc", "nvcc_flags",
                "kernel_digest", "gxx_flags", "native_digest", "entries"):
        assert info[key] == packed[key]
    assert info["nvcc_flags"] == list(_build.NVCC_FLAGS)


def test_restored_library_is_found_without_nvcc(build_root, tmp_path,
                                                monkeypatch):
    art = str(tmp_path / "k.tar.gz")
    cache_artifact.pack(art)
    fresh = tmp_path / "fresh"
    cache_artifact.restore(art, str(fresh))
    monkeypatch.setattr(_build, "BUILD_ROOT", fresh)

    def no_nvcc():
        raise AssertionError("nvcc would have run")
    monkeypatch.setattr(_build, "_nvcc", no_nvcc)
    assert _build.build() == fresh / _build._digest() / _build._LIB_NAME
    assert _build.last_build["compiled"] is False


def test_restored_native_runtime_loads_without_gxx(build_root, tmp_path):
    art = str(tmp_path / "k.tar.gz")
    cache_artifact.pack(art)
    fresh = tmp_path / "fresh"
    cache_artifact.restore(art, str(fresh))
    code = ("from trackiellm_tpu_torch.ffi import native; "
            "assert native.native_available(); "
            "print(native.library_path())")
    env = dict(os.environ, TRACKIE_BUILD_DIR=str(fresh), PATH="")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == str(native.library_path(fresh))


def test_restore_warns_on_a_mismatch(build_root, tmp_path, monkeypatch,
                                     capsys):
    real = cache_artifact.manifest()
    monkeypatch.setattr(cache_artifact, "manifest", lambda: dict(
        real, torch="0.0.0", kernel_digest="0" * 16))
    art = str(tmp_path / "old.tar.gz")
    cache_artifact.pack(art)
    monkeypatch.setattr(cache_artifact, "manifest", lambda: real)
    capsys.readouterr()
    out = cache_artifact.restore(art, str(tmp_path / "fresh"))
    err = capsys.readouterr().err
    assert out["mismatches"] == ["torch", "kernel_digest"]
    assert "WARNING: artifact built with torch=0.0.0" in err
    assert "builds anew" in err


def test_pack_needs_a_built_library(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "empty")
    with pytest.raises(SystemExit, match="precompile"):
        cache_artifact.pack(str(tmp_path / "x.tar.gz"))


def test_restore_refuses_members_outside_the_build_directory(tmp_path):
    art = str(tmp_path / "evil.tar.gz")
    with tarfile.open(art, "w:gz") as tf:
        blob = np.zeros(4, np.uint8).tobytes()
        info = tarfile.TarInfo("../outside/lib.so")
        info.size = len(blob)
        tf.addfile(info, io.BytesIO(blob))
    with pytest.raises(SystemExit, match="refusing"):
        cache_artifact.restore(art, str(tmp_path / "root"))
    assert not (tmp_path / "outside").exists()
