"""How far the wake-word trainer on the card strays from the CPU.

    python -m trackiellm_tpu_torch.tools.wake_word_gap [--seeds 1 2 3]
        [--steps 10] [--pairs 96]

``audio/wake_word.py:train_wake_word`` at the bundled artifact's config on
``tools/train_wake_word_default.py``'s synthetic set, full-batch Adam. For
each init seed, card against CPU:

- along the CPU's own run of ``--steps`` steps, from each state (the
  params and Adam's moments) one step on the card: the relative gap of the
  loss (the forward); the rel L2 gap of the gradients, every leaf together
  and each leaf alone, beside the CPU gradient's norm (the backward); and
  each leaf's gap from the CPU's next params in units of a full Adam step,
  ``lr sqrt(numel)`` (the gradient and the update together). No gap is
  carried from one state to the next;
- the per-leaf rel L2 of the params after ``--steps`` free-running steps
  from one init, with cuDNN's default algorithms and with its
  deterministic ones: there the two runs' drift compounds.

Adam divides each gradient by its own running size, so a step's relative
error is its gradient's: a leaf whose gradient gap reaches ``ROUNDING`` at
some state (a small gradient against the f32 rounding of its sum, as a
bias's where the balanced labels cancel) drifts by as much. ``at_rounding``
names such leaves, with the state, the gap and the gradient's norm there.
Prints the card's name and power limit, then one JSON line. Exits non-zero
without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
from typing import Any, Dict, List, Tuple

import torch

from trackiellm_tpu_torch.audio import wake_word as ww
from trackiellm_tpu_torch.tools import train_wake_word_default as tool

# The gradient gap at which ``main`` names a leaf at rounding: the bound
# that chip_smoke.py phase 23 (d) holds the first state's gradients to.
ROUNDING = 1e-5


def leaves(params) -> Dict[str, torch.Tensor]:
    """A wake-word tree's tensors by dotted name."""
    return {f"{k}.{kk}" if isinstance(v, dict) else k: t
            for k, v in params.items()
            for kk, t in (v.items() if isinstance(v, dict) else [("", v)])}


def moved(params, device) -> Dict[str, Any]:
    return {k: ({kk: vv.to(device) for kk, vv in v.items()}
                if isinstance(v, dict) else v.to(device))
            for k, v in params.items()}


def detached(params) -> Dict[str, Any]:
    return {k: ({kk: vv.detach().clone() for kk, vv in v.items()}
                if isinstance(v, dict) else v.detach().clone())
            for k, v in params.items()}


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double().cpu(), b.double().cpu()
    return float((a - b).norm() / b.norm())


def _states(params, cfg, mels, labels, steps: int, moments=None
            ) -> Tuple[List[Dict[str, Any]], Dict[str, Any]]:
    """``train_wake_word``'s first ``steps`` states on ``mels``' device,
    each taken before Adam moves it: the params, the loss, the gradients,
    Adam's moments and learning rate; and the params after the last step.
    ``moments`` (a state's, by leaf name) start Adam where another run
    stood."""
    seen = []

    def keep(p, loss, opt):
        named = leaves(p)
        if moments and not seen:
            for k, t in named.items():
                opt.state[t] = {n: (v.clone() if n == "step"
                                    else v.to(t.device))
                                for n, v in moments[k].items()}
        seen.append({
            "params": detached(p), "loss": float(loss.detach()),
            "grads": {k: t.grad.detach().clone() for k, t in named.items()},
            "moments": {k: {n: v.detach().clone()
                            for n, v in opt.state[t].items()}
                        for k, t in named.items()},
            "lr": opt.param_groups[0]["lr"]})

    final = ww.train_wake_word(params, cfg, mels, labels, steps=steps,
                               on_step=keep)
    return seen, final


def trajectory_gaps(start_cpu, cfg, mels, labels, steps: int,
                    dev) -> Dict[str, Any]:
    """From each of the CPU's first ``steps`` states (params and moments),
    one step on ``dev`` against the CPU's: ``loss`` the largest relative
    loss gap; ``grad_all`` a list over the states of the rel L2 gap of
    every leaf's gradient together; per leaf, lists over the states of the
    gradient's rel L2 gap (``grad``), the CPU gradient's norm
    (``grad_norm``) and the next params' gap in units of a full Adam step
    (``step``)."""
    cpu, final = _states(start_cpu, cfg, mels.cpu(), labels.cpu(), steps)
    nexts = [s["params"] for s in cpu[1:]] + [final]
    out = {"loss": 0.0, "grad_all": [], "grad": {}, "grad_norm": {},
           "step": {}}
    for state, after in zip(cpu, nexts):
        (card,), card_after = _states(moved(state["params"], dev), cfg, mels,
                                      labels, 1, state["moments"])
        out["loss"] = max(out["loss"], abs(card["loss"] - state["loss"])
                          / abs(state["loss"]))
        out["grad_all"].append(rel_l2(
            torch.cat([g.flatten().cpu() for g in card["grads"].values()]),
            torch.cat([g.flatten() for g in state["grads"].values()])))
        card_after, after = leaves(card_after), leaves(after)
        for k, g in state["grads"].items():
            out["grad"].setdefault(k, []).append(rel_l2(card["grads"][k], g))
            out["grad_norm"].setdefault(k, []).append(float(g.norm()))
            full = state["lr"] * math.sqrt(g.numel())
            out["step"].setdefault(k, []).append(float(
                (card_after[k].double().cpu() - after[k].double()).norm()
                / full))
    return out


def at_rounding(gaps: Dict[str, Any],
                bound: float) -> Dict[str, Dict[str, float]]:
    """The leaves whose gradient gap reaches ``bound`` at some state, each
    with that state, its largest gap and the CPU gradient's norm there."""
    out = {}
    for k, rels in gaps["grad"].items():
        t = max(range(len(rels)), key=rels.__getitem__)
        if rels[t] >= bound:
            out[k] = {"step": t, "grad_gap": rels[t],
                      "grad_norm": gaps["grad_norm"][k][t]}
    return out


def params_gap(start_cpu, cfg, mels, labels, steps: int, dev,
               deterministic: bool = False) -> Dict[str, float]:
    """Per-leaf rel L2 of the params after ``steps`` steps, card against
    CPU from one init."""
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = deterministic
    try:
        card = ww.train_wake_word(moved(start_cpu, dev), cfg, mels, labels,
                                  steps=steps)
    finally:
        torch.backends.cudnn.deterministic = saved
    cpu = leaves(ww.train_wake_word(start_cpu, cfg, mels.cpu(),
                                    labels.cpu(), steps=steps))
    return {k: rel_l2(v, cpu[k]) for k, v in leaves(card).items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[1, 2, 3, 4, 5, 6])
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--pairs", type=int, default=96)
    args = ap.parse_args(argv)
    from trackiellm_tpu_torch.tools import cuda_device
    dev = cuda_device("wake_word_gap")
    if dev is None:
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = ww.WakeWordConfig()
    mels, labels = tool.training_set(args.pairs, dev)
    rows = []
    for seed in args.seeds:
        start = ww.init_wake_word(torch.Generator().manual_seed(seed), cfg)
        row = {"seed": seed}
        for det in (False, True):
            row[f"params_deterministic_{det}"] = params_gap(
                start, cfg, mels, labels, args.steps, dev, det)
        gaps = trajectory_gaps(start, cfg, mels, labels, args.steps, dev)
        row.update(gaps, at_rounding=at_rounding(gaps, ROUNDING))
        rows.append(row)
    print(json.dumps({"wake_word_gap": rows, "steps": args.steps,
                      "pairs": args.pairs, "rounding": ROUNDING,
                      "params_max": max(max(max(r[f"params_deterministic_{d}"]
                                                .values())
                                            for d in (False, True))
                                        for r in rows),
                      "loss_max": max(r["loss"] for r in rows),
                      "grad_all_first_max": max(r["grad_all"][0]
                                                for r in rows),
                      "step_max": max(max(v) for r in rows
                                      for v in r["step"].values())}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
