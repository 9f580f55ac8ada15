"""The port's voice converters, name maps and CLI commands against the JAX
package on the CPU.

Each converter reads the same file or state dict in both packages and must
give the same tensors, byte for byte: Whisper from a torch state dict and
from a whisper.cpp GGML file, the small VAD, Silero from an ONNX file under
its published names, the TTS, and a Piper VITS voice from .npz and .onnx
through the ``piper_vits`` map. ``transcribe`` and ``synth`` run on the CPU
with ``--device cpu`` and refuse to run without a card otherwise.
"""

import json
import os
import wave

import numpy as np
import pytest

import torch

from tests import test_audio_convert, test_convert, test_vits
from tests.test_whisper_ggml import _F32_EXCEPTIONS, write_ggml_whisper
from trackiellm_tpu import __main__ as jcli
from trackiellm_tpu.models import checkpoint as jckpt
from trackiellm_tpu.models import convert as jc
from trackiellm_tpu.models import vits as jv
from trackiellm_tpu.models.onnx_reader import (
    read_onnx_initializers as j_read_onnx)
from trackiellm_tpu_torch import __main__ as tcli
from trackiellm_tpu_torch.models import checkpoint as tckpt
from trackiellm_tpu_torch.models import convert as tc
from trackiellm_tpu_torch.models import tts as tt
from trackiellm_tpu_torch.models import vits as tv
from trackiellm_tpu_torch.models import whisper as tw
from trackiellm_tpu_torch.models.onnx_reader import (
    read_onnx_initializers as t_read_onnx, write_onnx_initializers)
from trackiellm_tpu_torch.utils.errors import ErrorCode, TrackieError

CPU = torch.device("cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}.{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}[{i}]")
    else:
        yield prefix, (tree.numpy() if isinstance(tree, torch.Tensor)
                       else np.asarray(tree))


def _assert_same_tree(ref, got):
    """Same paths, shapes, dtypes and bytes."""
    ref, got = dict(_leaves(ref)), dict(_leaves(got))
    assert ref.keys() == got.keys()
    for name, a in ref.items():
        b = got[name]
        assert a.shape == b.shape and a.dtype == b.dtype, name
        assert a.tobytes() == b.tobytes(), name


def _whisper_state(seed=0):
    """A WhisperConfig.test() state dict in openai's layout (matrices
    pre-rounded through f16, so a GGML file holds them exactly)."""
    cfg = tw.WhisperConfig.test()
    params = tw.init_whisper(torch.Generator().manual_seed(seed), cfg)
    rng = np.random.default_rng(seed)
    for grp in ("enc", "dec", "cross"):
        for name in ("bq", "bv", "bo"):
            params[grp][name] = torch.from_numpy(0.01 * rng.standard_normal(
                params[grp][name].shape).astype(np.float32))
    state = test_convert.TestWhisperFromTorch()._to_torch_state(params, cfg)
    for name, arr in state.items():
        a = np.asarray(arr, np.float32)
        if a.squeeze().ndim >= 2 and name not in _F32_EXCEPTIONS:
            a = a.astype(np.float16).astype(np.float32)
        state[name] = a
    return cfg, state


def test_whisper_from_torch_matches_jax():
    _, state = _whisper_state()
    jp, jcfg = jc.whisper_from_torch(state)
    tp, tcfg = tc.whisper_from_torch(state, device=CPU)
    assert tuple(tcfg) == tuple(jcfg)
    _assert_same_tree(jp, tp)


def _ggml_file(tmp_path, hparam_override=None):
    cfg, state = _whisper_state(seed=1)
    state["encoder.positional_embedding"] = np.zeros(
        (cfg.n_audio_ctx, cfg.d_model), np.float32)
    hparams = {
        "n_vocab": cfg.vocab_size, "n_audio_ctx": cfg.n_audio_ctx,
        "n_audio_state": cfg.d_model, "n_audio_head": cfg.n_heads,
        "n_audio_layer": cfg.n_audio_layers, "n_text_ctx": cfg.n_text_ctx,
        "n_text_state": cfg.d_model, "n_text_head": cfg.n_heads,
        "n_text_layer": cfg.n_text_layers, "n_mels": cfg.n_mels, "ftype": 1}
    hparams.update(hparam_override or {})
    filters = np.arange(cfg.n_mels * 6, dtype=np.float32).reshape(
        cfg.n_mels, 6) / 100.0
    vocab = [b"he", b"llo", b" wor", b"ld", "ç".encode(), b"!"]
    path = str(tmp_path / "ggml-test.bin")
    write_ggml_whisper(path, state, hparams, filters, vocab)
    return path, cfg


def test_whisper_from_ggml_matches_jax(tmp_path):
    path, cfg = _ggml_file(tmp_path)
    jp, jcfg, jtok, jfilt = jc.whisper_from_ggml(path)
    tp, tcfg, ttok, tfilt = tc.whisper_from_ggml(path, device=CPU)
    assert tuple(tcfg) == tuple(jcfg) == tuple(cfg)  # 2 heads from hparams
    _assert_same_tree(jp, tp)
    np.testing.assert_array_equal(tfilt, jfilt)
    ids = [0, 1, 2, 3, 4, 5, 50_000]
    assert ttok.decode(ids) == jtok.decode(ids) == "hello worldç!"


def test_whisper_from_ggml_refuses_disagreeing_hparams(tmp_path):
    path, _ = _ggml_file(tmp_path, {"n_text_layer": 3})
    with pytest.raises(TrackieError) as err:
        tc.whisper_from_ggml(path, device=CPU)
    assert err.value.code == ErrorCode.MODEL_METADATA_INVALID


def test_converters_need_a_card_or_an_explicit_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, state = _whisper_state()
    with pytest.raises(TrackieError) as err:
        tc.whisper_from_torch(state)
    assert err.value.code == ErrorCode.DEVICE_UNAVAILABLE


def test_vad_from_torch_matches_jax():
    rng = np.random.default_rng(2)

    def r(*shape):
        return rng.standard_normal(shape).astype(np.float32)
    state = {"conv1.weight": r(32, 32), "conv1.bias": r(32),
             "conv2.weight": r(32, 96), "conv2.bias": r(32),
             "gru.weight_ih": r(192, 32), "gru.weight_hh": r(192, 64),
             "gru.bias_ih": r(192), "gru.bias_hh": r(192),
             "out.weight": r(1, 64), "out.bias": r(1)}
    jp, jcfg = jc.vad_from_torch(state)
    tp, tcfg = tc.vad_from_torch(state, device=CPU)
    assert tuple(tcfg) == tuple(jcfg)
    _assert_same_tree(jp, tp)


@pytest.mark.parametrize("prefixed", [True, False])
def test_silero_from_an_onnx_file_matches_jax(tmp_path, prefixed):
    """A Silero v5 ONNX file under its published names (with and without
    the ``_model.`` prefix), read by each package's reader, renamed by the
    ``silero_v5`` map and converted."""
    silero = test_audio_convert.TestSileroExactConverter()
    st = {k: v.numpy() for k, v in silero._torch_state(seed=3).items()}
    if not prefixed:
        st = {k.replace("_model.", ""): v for k, v in st.items()}
    path = str(tmp_path / "silero.onnx")
    write_onnx_initializers(path, st)
    jstate = jc.apply_name_map(j_read_onnx(path),
                               jc.load_name_map("silero_v5"))
    tstate = tc.apply_name_map(t_read_onnx(path),
                               tc.load_name_map("silero_v5"))
    jp, jcfg = jc.silero_from_onnx(jstate)
    tp, tcfg = tc.silero_from_onnx(tstate, device=CPU)
    assert tuple(tcfg) == tuple(jcfg)
    _assert_same_tree(jp, tp)


def test_tts_from_torch_matches_jax():
    cfg = tt.TTSConfig.tiny()
    params = tt.init_tts(torch.Generator().manual_seed(4), cfg)
    state = {"emb.weight": params["emb"].numpy()}
    for name, p in params.items():
        if name == "emb":
            continue
        w = p["w"].numpy()
        state[f"{name}.weight"] = (w.transpose(2, 1, 0) if w.ndim == 3
                                   else w.T)
        state[f"{name}.bias"] = p["b"].numpy() + 0.01
    jp, jcfg = jc.tts_from_torch(state)
    tp, tcfg = tc.tts_from_torch(state, device=CPU)
    assert tuple(tcfg) == tuple(jcfg)
    _assert_same_tree(jp, tp)


def _piper_files(tmp_path, onnx):
    cfg = jv.VITSConfig.tiny()
    st = {k: v.numpy() for k, v in test_vits.TestConverter()._torch_vits_state(
        cfg, seed=5).items()}
    st["dp.flows.1.proj.weight"] = np.full_like(
        st["dp.flows.1.proj.weight"], 0.01)
    if onnx:
        path = str(tmp_path / "voice.onnx")
        write_onnx_initializers(path, st)
    else:
        path = str(tmp_path / "voice.npz")
        np.savez(path, **st)
    conf = {"audio": {"sample_rate": 16000},
            "phoneme_id_map": {"^": [1], "$": [2], "_": [0], "o": [5],
                               "l": [6], "a": [7], " ": [3]}}
    conf_path = str(tmp_path / "voice.json")
    with open(conf_path, "w") as f:
        json.dump(conf, f)
    return path, conf_path, cfg


@pytest.mark.parametrize("onnx", [True, False], ids=["onnx", "npz"])
def test_piper_voice_matches_jax(tmp_path, onnx):
    path, conf_path, cfg = _piper_files(tmp_path, onnx)
    jvoice = jv.VITSVoice.from_piper(path, conf_path,
                                     max_frames=cfg.max_frames)
    tvoice = tv.VITSVoice.from_piper(path, conf_path,
                                     max_frames=cfg.max_frames, device=CPU)
    assert tuple(tvoice.cfg) == tuple(jvoice.cfg)
    assert tvoice.id_map == jvoice.id_map
    _assert_same_tree(jvoice.params, tvoice.params)
    st = dict(np.load(path)) if not onnx else None
    if st is not None:  # vits_from_torch on the state dict alone
        jp, _ = jc.vits_from_torch(st, max_phonemes=cfg.max_phonemes,
                                   max_frames=cfg.max_frames)
        tp, _ = tc.vits_from_torch(st, max_phonemes=cfg.max_phonemes,
                                   max_frames=cfg.max_frames, device=CPU)
        _assert_same_tree(jp, tp)


def test_name_maps_are_the_reference_maps():
    for name in ("silero_v5", "piper_vits"):
        with open(os.path.join(ROOT, "trackiellm_tpu", "models", "name_maps",
                               f"{name}.json"), "rb") as f:
            ref = f.read()
        with open(os.path.join(ROOT, "trackiellm_tpu_torch", "models",
                               "name_maps", f"{name}.json"), "rb") as f:
            assert f.read() == ref
        assert tc.load_name_map(name) == jc.load_name_map(name)
    state = {"a": 1, "b": 2}
    assert tc.apply_name_map(state, {"a": "x"}) == jc.apply_name_map(
        state, {"a": "x"})
    with pytest.raises(TrackieError):
        tc.apply_name_map(state, {"a": "x"}, strict=True)
    with pytest.raises(TrackieError):
        tc.load_name_map("no_such_map")


def _wav(path, audio, rate):
    pcm = (np.clip(audio, -1, 1) * 32767).astype(np.int16)
    with wave.open(path, "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(rate)
        f.writeframes(pcm.tobytes())


@pytest.fixture(scope="module")
def whisper_checkpoints(tmp_path_factory):
    """One Whisper checkpoint written by each package (the JAX package's
    with the config in its metadata only, the port's with a WhisperConfig
    sidecar too), the same weights, and a 48 kHz WAV."""
    root = tmp_path_factory.mktemp("whisper")
    cfg, state = _whisper_state(seed=6)
    jp, jcfg = jc.whisper_from_torch(state)
    tp, tcfg = tc.whisper_from_torch(state, device=CPU)
    meta = {"whisper_config": dict(jcfg._asdict())}
    jdir, tdir = str(root / "jax"), str(root / "port")
    jckpt.save_checkpoint(jdir, jp, metadata=meta)
    tckpt.save_checkpoint(tdir, tp, config=tcfg, metadata=meta)
    wav = str(root / "speech.wav")
    t = np.arange(48_000 * 2) / 48_000
    _wav(wav, 0.3 * np.sin(2 * np.pi * 300 * t) * np.sin(2 * np.pi * t),
         48_000)
    return jdir, tdir, wav, tcfg


def test_load_checkpoint_reads_a_whisper_checkpoint(whisper_checkpoints):
    jdir, tdir, _, tcfg = whisper_checkpoints
    for d in (jdir, tdir):
        params, cfg, meta = tckpt.load_checkpoint(d, device=CPU)
        assert tw.WhisperConfig(**meta["whisper_config"]) == tcfg
        assert cfg == (tcfg if d == tdir else None)
        assert params["enc"]["wq"].shape == (2, 64, 64)
    jparams, jcfg, _ = jckpt.load_checkpoint(tdir)
    assert jcfg is None
    _assert_same_tree(jparams, tckpt.load_checkpoint(tdir, device=CPU)[0])


def test_transcribe_cli_prints_the_jax_text(whisper_checkpoints, capsys):
    """``transcribe --device cpu`` on either package's checkpoint prints
    what the JAX package's ``transcribe`` prints on it."""
    jdir, tdir, wav, _ = whisper_checkpoints
    assert jcli.main(["transcribe", wav, "--checkpoint", jdir]) == 0
    ref = capsys.readouterr().out
    for d in (jdir, tdir):
        assert tcli.main(["transcribe", wav, "--checkpoint", d,
                          "--device", "cpu"]) == 0
        assert capsys.readouterr().out == ref


def test_transcribe_cli_without_a_checkpoint_warns(whisper_checkpoints,
                                                   capsys):
    _, _, wav, _ = whisper_checkpoints
    assert tcli.main(["transcribe", wav, "--device", "cpu"]) == 0
    assert "random test weights" in capsys.readouterr().err


@pytest.mark.parametrize("command", ["transcribe", "synth"])
def test_voice_commands_need_a_card_or_an_explicit_cpu(command, monkeypatch,
                                                       tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ({"transcribe": ["transcribe", "x.wav"],
             "synth": ["synth", "-t", "ola", "--voice", "v.npz",
                       "--voice-config", "v.json"]})[command]
    with pytest.raises(SystemExit, match=f"--device cpu to {command}"):
        tcli.main(argv)


def test_synth_cli_writes_the_voice_waveform(tmp_path, capsys):
    path, conf_path, cfg = _piper_files(tmp_path, onnx=True)
    out = str(tmp_path / "fala.wav")
    assert tcli.main(["synth", "-t", "ola ola", "--voice", path,
                      "--voice-config", conf_path, "-o", out,
                      "--length-scale", "1.3", "--device", "cpu"]) == 0
    assert "wrote" in capsys.readouterr().out
    voice = tv.VITSVoice.from_piper(path, conf_path, device=CPU)
    ref = voice.synthesize("ola ola", length_scale=1.3)
    with wave.open(out, "rb") as f:
        assert f.getframerate() == 16000
        pcm = np.frombuffer(f.readframes(f.getnframes()), np.int16)
    assert len(pcm) == len(ref) > 0 and len(pcm) % voice.cfg.hop == 0
    np.testing.assert_array_equal(
        pcm, (np.clip(ref, -1, 1) * 32767).astype(np.int16))
