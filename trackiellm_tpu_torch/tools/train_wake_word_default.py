"""Train and package a wake-word artifact, the twin of the JAX package's
``tools/train_wake_word_default.py``: the conv KWS fitted on the synthetic
keyword-prototype set (a jittered two-tone phrase against six kinds of
imposter), with held-out false-accept and false-reject rates printed as one
JSON line. Deployments retrain on recorded audio of their real phrase with
this script as the template.

    python -m trackiellm_tpu_torch.tools.train_wake_word_default --out ww.npz
    python -m trackiellm_tpu_torch.tools.train_wake_word_default --device cpu

It trains on the CUDA card unless ``--device cpu`` is given, and writes
``save_wake_word``'s format (the JAX package's layout, which both packages
load). The artifact bundled in ``models/pretrained/`` is not its default
output.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from trackiellm_tpu_torch.audio.wake_word import (WakeWordConfig,
                                                  init_wake_word,
                                                  save_wake_word,
                                                  train_wake_word,
                                                  wake_word_score)
from trackiellm_tpu_torch.ops.backend import default_device
from trackiellm_tpu_torch.ops.mel import log_mel_spectrogram

SR = 16_000
WINDOW = 76 * 160 + 240


def tone_pair(rng, f1, f2, amp=0.1):
    t = np.arange(WINDOW // 2) / SR
    a = amp * np.sin(2 * np.pi * f1 * t + rng.uniform(0, 6.28))
    b = amp * np.sin(2 * np.pi * f2 * t + rng.uniform(0, 6.28))
    x = np.concatenate([a, b])[:WINDOW]
    return (x + 0.02 * rng.standard_normal(WINDOW)).astype(np.float32)


def keyword(rng):
    # Jittered formant-like pair: frequency + amplitude augmentation so
    # the spotter generalizes beyond one exact synthesis.
    return tone_pair(rng, 600.0 * rng.uniform(0.95, 1.05),
                     1100.0 * rng.uniform(0.95, 1.05),
                     amp=0.1 * rng.uniform(0.7, 1.3))


def imposter(rng, kind):
    if kind == 0:
        return tone_pair(rng, 1100.0, 600.0)       # reversed order
    if kind == 1:
        return tone_pair(rng, 850.0, 850.0)        # single mid tone
    if kind == 2:
        return (0.1 * rng.standard_normal(WINDOW)).astype(np.float32)
    if kind == 3:
        return (0.001 * rng.standard_normal(WINDOW)).astype(np.float32)
    if kind == 4:                                   # off-key pair
        return tone_pair(rng, 400.0, 1600.0)
    # keyword-adjacent: right first tone, wrong second
    return tone_pair(rng, 600.0, 750.0)


def mel(audio, device) -> torch.Tensor:
    """The last 76 frames of a clip's 40-band log-mel, on ``device``."""
    m = log_mel_spectrogram(torch.from_numpy(audio).to(device), n_mels=40)
    return m[:, -76:]


def training_set(n_train: int, device, seed: int = 0):
    """(mels (2 n_train, 40, 76), labels (2 n_train,)): a keyword and an
    imposter (kinds in turn) per step of numpy's generator from ``seed``,
    as the JAX package's tool draws them."""
    rng = np.random.default_rng(seed)
    xs, ys = [], []
    for i in range(n_train):
        xs.append(mel(keyword(rng), device))
        ys.append(1)
        xs.append(mel(imposter(rng, i % 6), device))
        ys.append(0)
    return torch.stack(xs), torch.tensor(ys, device=device)


def held_out(params, cfg, device, n: int = 48, seed: int = 99) -> dict:
    """False-reject and false-accept rates on ``n`` fresh clips of each."""
    rng = np.random.default_rng(seed)
    kw = [keyword(rng) for _ in range(n)]
    imp = [imposter(rng, i % 6) for i in range(n)]
    kw_s = [float(wake_word_score(params, cfg, mel(a, device))) for a in kw]
    imp_s = [float(wake_word_score(params, cfg, mel(a, device)))
             for a in imp]
    return {"held_out_false_reject":
            sum(s < cfg.sensitivity for s in kw_s) / n,
            "held_out_false_accept":
            sum(s >= cfg.sensitivity for s in imp_s) / n}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="wake_word.npz")
    ap.add_argument("--steps", type=int, default=600)
    ap.add_argument("--n-train", type=int, default=96)
    ap.add_argument("--device", default=None,
                    help="cpu, or a CUDA device (default: the card)")
    args = ap.parse_args(argv)
    device = default_device(args.device, "train a wake word")
    cfg = WakeWordConfig()
    mels, labels = training_set(args.n_train, device)
    params = init_wake_word(torch.Generator(device=device).manual_seed(1),
                            cfg)
    t0 = time.perf_counter()
    params = train_wake_word(params, cfg, mels, labels, steps=args.steps)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    train_s = time.perf_counter() - t0
    rates = held_out(params, cfg, device)
    out_dir = os.path.dirname(os.path.abspath(args.out))
    os.makedirs(out_dir, exist_ok=True)
    save_wake_word(args.out, params, cfg)
    print(json.dumps({
        "config": "wake_word_default_artifact", "out": args.out,
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
        "train_clips": 2 * args.n_train, "steps": args.steps,
        "train_s": train_s, **{k: round(v, 4) for k, v in rates.items()},
        "sensitivity": cfg.sensitivity,
        "bytes": os.path.getsize(args.out)}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
