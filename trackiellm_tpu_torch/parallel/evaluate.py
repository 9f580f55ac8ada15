"""Evaluation: perplexity over packed batches.

Port of ``trackiellm_tpu/parallel/evaluate.py``: the training loop's
companion, and the token-level parity metric once real weights land.
"""

from __future__ import annotations

import math
from typing import Iterable

import numpy as np
import torch

from trackiellm_tpu_torch.models import llm as llm_model
from trackiellm_tpu_torch.parallel.train import lm_loss


@torch.no_grad()
def evaluate_perplexity(params, cfg: llm_model.LLMConfig,
                        batches: Iterable) -> dict:
    """Mean next-token NLL and perplexity over an iterable of (B, S) int
    batches (numpy arrays or tensors), each run on the params' device."""
    device = params["tok_emb"].device
    total_nll = 0.0
    n_batches = 0
    for batch in batches:
        if not isinstance(batch, torch.Tensor):
            batch = torch.from_numpy(np.asarray(batch))
        # moe_aux_coef=0: perplexity is a pure cross-entropy; the MoE
        # load-balancing term is a training regularizer, not NLL.
        total_nll += float(lm_loss(params, cfg, batch.to(device),
                                   moe_aux_coef=0.0))
        n_batches += 1
    if n_batches == 0:
        return {"nll": float("nan"), "perplexity": float("nan"),
                "batches": 0}
    nll = total_nll / n_batches
    return {"nll": nll, "perplexity": math.exp(min(nll, 30.0)),
            "batches": n_batches}
