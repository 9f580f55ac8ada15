"""Text-to-speech: acoustic model + neural vocoder, PyTorch.

Port of ``trackiellm_tpu/models/tts.py`` (the reference's Piper TTS
surface: synth-to-buffer, synth-to-callback, speaking rate):

  - acoustic model: character/phoneme embedding -> conv encoder ->
    duration predictor -> static-shape length regulation (a masked
    frame -> token gather from cumulative durations) -> conv decoder ->
    mel frames;
  - vocoder: nearest-neighbour upsampling convolutions (4*5*8 = hop 160
    at 16 kHz) with residual convolutions -> waveform.

Both stages keep the reference's fixed (max_chars, max_frames) shapes and
its layouts ((T, C) activations, (K, Cin, Cout) kernels, XLA "SAME"
padding, ``ops/conv.py``). Durations are summed in the reference's order
(``ops/scan.py``), so frame counts match it on the CPU; convolutions and
matmuls run in full f32 (``exact_f32``).
"""

from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from trackiellm_tpu_torch.ops.backend import exact_f32
from trackiellm_tpu_torch.ops.conv import conv1d_tio
from trackiellm_tpu_torch.ops.scan import cumsum

# Character inventory (grapheme fallback; a phonemizer can map into the
# same id space). Includes pt-BR accented letters, the product language
# (text_to_ids lowercases, so lowercase forms suffice).
TTS_CHARSET = (" abcdefghijklmnopqrstuvwxyzáàâãéêíóôõúüç"
               "0123456789.,!?'-:;")


def text_to_ids(text: str, max_chars: int):
    ids = [TTS_CHARSET.index(c) if c in TTS_CHARSET else 0
           for c in text.lower()][:max_chars]
    n = len(ids)
    arr = np.zeros((max_chars,), np.int32)
    arr[:n] = ids
    return arr, n


class TTSConfig(NamedTuple):
    vocab_size: int = len(TTS_CHARSET)
    d_model: int = 128
    n_mels: int = 80
    hop: int = 160            # samples per mel frame @ 16 kHz
    max_chars: int = 128
    max_frames: int = 512     # ~5.1 s of speech
    upsample: Tuple[int, ...] = (4, 5, 8)
    voc_ch: int = 128

    @classmethod
    def default(cls) -> "TTSConfig":
        return cls()

    @classmethod
    def tiny(cls) -> "TTSConfig":
        return cls(d_model=32, max_chars=32, max_frames=64, voc_ch=32)


def _uniform(gen, shape, s):
    return (torch.rand(shape, generator=gen, device=gen.device) * 2 - 1) * s


def _dense(gen, cin, cout):
    s = 1.0 / math.sqrt(cin)
    return {"w": _uniform(gen, (cin, cout), s),
            "b": torch.zeros((cout,), device=gen.device)}


def _conv1d_init(gen, k, cin, cout):
    s = 1.0 / math.sqrt(k * cin)
    return {"w": _uniform(gen, (k, cin, cout), s),
            "b": torch.zeros((cout,), device=gen.device)}


def init_tts(gen: torch.Generator, cfg: TTSConfig = TTSConfig()
             ) -> Dict[str, Any]:
    """Random params in the reference's layout, on ``gen``'s device."""
    d = cfg.d_model
    c = cfg.voc_ch
    params: Dict[str, Any] = {
        "emb": torch.randn((cfg.vocab_size, d), generator=gen,
                           device=gen.device) * 0.1,
        "enc1": _conv1d_init(gen, 5, d, d),
        "enc2": _conv1d_init(gen, 5, d, d),
        "dur1": _dense(gen, d, d // 2),
        "dur2": _dense(gen, d // 2, 1),
        "dec1": _conv1d_init(gen, 5, d, d),
        "dec2": _conv1d_init(gen, 5, d, d),
        "mel_out": _dense(gen, d, cfg.n_mels),
        "voc_in": _conv1d_init(gen, 7, cfg.n_mels, c),
    }
    ch = c
    for i, _ in enumerate(cfg.upsample):
        params[f"voc_up{i}"] = _conv1d_init(gen, 8, ch, ch // 2)
        params[f"voc_res{i}a"] = _conv1d_init(gen, 3, ch // 2, ch // 2)
        params[f"voc_res{i}b"] = _conv1d_init(gen, 3, ch // 2, ch // 2)
        ch //= 2
    params["voc_out"] = _conv1d_init(gen, 7, ch, 1)
    return params


def _conv1d(x, p, stride=1):
    return conv1d_tio(x, p["w"], p["b"], stride)


def _upsample_conv(x, p, factor):
    """Nearest-neighbour upsample + conv (the HiFiGAN variant without
    transposed-convolution artifacts)."""
    return _conv1d(torch.repeat_interleave(x, factor, dim=0), p)


def _softplus(x):
    """``jax.nn.softplus``: logaddexp(x, 0)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _params_device(params: Dict[str, Any]) -> torch.device:
    return params["emb"].device


@torch.no_grad()
def acoustic_forward(params: Dict[str, Any], cfg: TTSConfig,
                     char_ids: torch.Tensor, n_chars: int,
                     rate: float = 1.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """(max_chars,) ids + true length -> ((max_frames, n_mels) mel,
    n_frames as a 0-dim int32 tensor). ``rate`` scales durations (Piper
    voice-rate parity)."""
    dev = _params_device(params)
    mask = (torch.arange(cfg.max_chars, device=dev) < n_chars)[:, None]
    with exact_f32():
        x = params["emb"][char_ids.long()] * mask
        x = F.relu(_conv1d(x, params["enc1"])) * mask
        x = x + F.relu(_conv1d(x, params["enc2"])) * mask

        # Durations in frames per token: softplus keeps them positive; +2
        # biases toward intelligible pacing even untrained.
        h = F.relu(x @ params["dur1"]["w"] + params["dur1"]["b"])
        rate_t = torch.tensor(rate, dtype=torch.float32, device=dev)
        dur = ((_softplus(h @ params["dur2"]["w"] + params["dur2"]["b"])
                [:, 0] + 2.0) / torch.clamp(rate_t, min=1e-3))
        dur = torch.where(mask[:, 0], dur, 0.0)

        # Static-shape length regulation: frame t copies token
        # argmax(cum_dur > t) via a (max_frames, max_chars) comparison.
        ends = cumsum(dur)                          # (S,)
        t_idx = torch.arange(cfg.max_frames, dtype=torch.float32, device=dev)
        tok_of_frame = torch.sum(
            (t_idx[:, None] >= ends[None, :]).to(torch.int32), dim=1)
        tok_of_frame = torch.clamp(tok_of_frame, 0, cfg.max_chars - 1)
        frames = x[tok_of_frame]                    # (T, d)
        n_frames = torch.clamp(ends[max(n_chars - 1, 0)],
                               max=float(cfg.max_frames)).to(torch.int32)
        fmask = (torch.arange(cfg.max_frames, device=dev) < n_frames)[:, None]

        y = F.relu(_conv1d(frames, params["dec1"])) * fmask
        y = y + F.relu(_conv1d(y, params["dec2"])) * fmask
        mel = (y @ params["mel_out"]["w"] + params["mel_out"]["b"]) * fmask
    return mel, n_frames


@torch.no_grad()
def vocoder_forward(params: Dict[str, Any], cfg: TTSConfig,
                    mel: torch.Tensor) -> torch.Tensor:
    """(frames, n_mels) -> (frames * hop,) waveform in [-1, 1]."""
    with exact_f32():
        x = F.leaky_relu(_conv1d(mel, params["voc_in"]), 0.1)
        for i, f in enumerate(cfg.upsample):
            x = F.leaky_relu(_upsample_conv(x, params[f"voc_up{i}"], f), 0.1)
            r = F.leaky_relu(_conv1d(x, params[f"voc_res{i}a"]), 0.1)
            x = x + _conv1d(r, params[f"voc_res{i}b"])
        return torch.tanh(_conv1d(x, params["voc_out"]))[:, 0]


def vocoder_forward_chunk(params: Dict[str, Any], cfg: TTSConfig,
                          mel_chunk: torch.Tensor,
                          n_frames_chunk: int) -> torch.Tensor:
    """Vocode a (n_frames_chunk, n_mels) mel slice: the same weights and
    math as :func:`vocoder_forward` (the reference compiles one program a
    chunk shape)."""
    del n_frames_chunk
    return vocoder_forward(params, cfg, mel_chunk)


# Short-clause latency buckets: (max_chars, max_frames), small -> full.
# Every TTS weight is independent of the (max_chars, max_frames) shapes,
# so a short first clause can run a cheaper acoustic pass with the same
# params. The frame budget is 8 frames/char; a clause that could outgrow
# its bucket takes the next one.
LATENCY_BUCKETS = ((32, 256), (64, 320))


def bucket_config(cfg: TTSConfig, n_chars: int) -> TTSConfig:
    """Smallest bucket that safely covers ``n_chars`` of text (else ``cfg``
    itself). Mel output for the valid frames is identical across buckets:
    padding positions are masked to zero."""
    for mc, mf in LATENCY_BUCKETS:
        if (n_chars <= mc < cfg.max_chars and mf < cfg.max_frames
                and 8 * n_chars <= mf):
            return cfg._replace(max_chars=mc, max_frames=mf)
    return cfg


def _acoustic(params, cfg, text, rate, frontend):
    ids, n = (frontend or text_to_ids)(text, cfg.max_chars)
    ids_t = torch.from_numpy(np.asarray(ids, np.int64)).to(
        _params_device(params))
    return acoustic_forward(params, cfg, ids_t, n, rate)


def synthesize_streaming(params: Dict[str, Any], cfg: TTSConfig, text: str,
                         rate: float = 1.0, frontend=None,
                         chunk_frames: int = 64, overlap: int = 8):
    """Generator: text -> successive waveform chunks (np.ndarray at
    16 kHz). The first chunk is audible after one acoustic pass and a
    small-chunk vocoder pass.

    The vocoder is convolutional, so each chunk is computed with
    ``overlap`` extra mel frames on each side and the edges discarded; with
    overlap >= the vocoder's receptive field (~5 frames) interior samples
    are those of the one-shot :func:`vocoder_forward`. The window
    arithmetic is the reference's, ``lax.dynamic_slice``'s clamp included:
    the window never leaves the mel buffer."""
    probe_ids, probe_n = (frontend or text_to_ids)(text, cfg.max_chars)
    cfg = bucket_config(cfg, probe_n)
    mel, n_frames_dev = _acoustic(params, cfg, text, rate, frontend)
    n_frames = int(n_frames_dev)
    hop = cfg.hop
    start = 0
    while start < n_frames:
        end = min(start + chunk_frames, n_frames)
        lo = max(start - overlap, 0)
        # One window shape (chunk + 2 * overlap), clamped to max_frames: a
        # small config degrades to one whole-buffer window.
        win = min(chunk_frames + 2 * overlap, cfg.max_frames)
        off = lo if lo <= cfg.max_frames - win else cfg.max_frames - win
        mel_win = mel[off:off + win]
        wav_win = vocoder_forward_chunk(params, cfg, mel_win, win)
        first = (start - off) * hop
        last = (end - off) * hop
        yield wav_win[first:last].cpu().numpy()
        start = end


def synthesize(params: Dict[str, Any], cfg: TTSConfig, text: str,
               rate: float = 1.0, frontend=None):
    """Text -> (waveform np.ndarray at 16 kHz, n_samples) (tk_tts_piper
    synth-to-buffer). ``frontend`` maps text -> (ids, n); it defaults to
    the grapheme charset (pass audio.phonemizer.PhonemeFrontend for
    phonemic input, with a model of its vocab_size)."""
    mel, n_frames = _acoustic(params, cfg, text, rate, frontend)
    wav = vocoder_forward(params, cfg, mel)
    n_samples = int(n_frames) * cfg.hop
    return wav.cpu().numpy()[:n_samples], n_samples
