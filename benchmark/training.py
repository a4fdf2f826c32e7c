"""The readings that decide ``correct`` in a training cell, shared by its
drivers: each judged step's loss, the first gradient as the optimizer got it
(Adam's first moment after one step over 1 - beta1), and the parameters'
change after the judged steps, each gradient and change taken as a norm per
leaf. A gap is |program - reference| of a number, over the reference's
number; for a leaf, over the larger of its own norm and the median leaf's.
Leaves whose reference gradient is under a thousandth of the median leaf's
move by round-off alone and are left out of the change."""
from __future__ import annotations

import copy
import statistics
from typing import Dict, List, Sequence

import torch

ROUNDOFF_LEAF = 1e-3


def norms(tensors) -> List[float]:
    return [float(t.detach().double().norm()) for t in tensors]


def _leaf_gap(prog: Sequence[float], ref: Sequence[float], keep: Sequence[bool]) -> float:
    scale = statistics.median(ref)
    gaps = [abs(p - r) / max(r, scale, 1e-30) for p, r, k in zip(prog, ref, keep) if k]
    return max(gaps) if gaps else float("nan")


def gaps(prog: Dict[str, List[float]], ref: Dict[str, List[float]]) -> Dict[str, float]:
    """The numbers a cell may compare: ``loss_gap`` (the worst judged step),
    ``grad_gap`` and ``change_gap`` (the worst leaf)."""
    loss_gap = max(abs(p - r) / max(abs(r), 1e-30) for p, r in zip(prog["losses"], ref["losses"]))
    median_grad = statistics.median(ref["grad"])
    moved = [g >= ROUNDOFF_LEAF * median_grad for g in ref["grad"]]
    return {
        "loss_gap": loss_gap,
        "grad_gap": _leaf_gap(prog["grad"], ref["grad"], [True] * len(ref["grad"])),
        "change_gap": _leaf_gap(prog["change"], ref["change"], moved),
    }


def checks(prog, ref, limits) -> list:
    """[(name, value, limit)] of the numbers the cell's limits name."""
    g = gaps(prog, ref)
    return [(name, g[name], float(limit)) for name, limit in limits.items()]


def freeze_step(optimizer, params):
    """A snapshot to restore after a step (the "frozen" fault: a step that
    returns its state unchanged)."""
    saved = (copy.deepcopy(optimizer.state_dict()), [p.detach().clone() for p in params])

    def restore():
        optimizer.load_state_dict(saved[0])
        with torch.no_grad():
            for p, q in zip(params, saved[1]):
                p.copy_(q)

    return restore


def first_moment_norms(optimizer, params):
    """The first gradient as Adam got it: its first moment after one step over 1 - beta1."""
    b1 = optimizer.param_groups[0]["betas"][0]
    return [float(optimizer.state[p]["exp_avg"].double().norm()) / (1 - b1)
            if p in optimizer.state else 0.0 for p in params]


def change_norms(params, start, device):
    return [float((p.detach().float() - s.to(device)).double().norm())
            for p, s in zip(params, start)]
