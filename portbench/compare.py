"""The numbers that decide `correct`, each a gap between what the timed
path produced and what the reference works out.

Training is compared leaf by leaf by norms: for each parameter, the gap
between the program's norm and the reference's, over the reference's norm
of that leaf or of the median leaf, whichever is larger; the worst leaf
is the number. Leaves whose reference gradient is under a thousandth of
the median leaf's move under Adam by round-off alone and are left out of
the parameters' change.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, Iterable, List, Optional

import torch

NEGLIGIBLE = 1e-3


def norms(tree: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(v.detach().double().norm()) for k, v in tree.items()}


def leaf_gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
              keys: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Each leaf's gap of norms (see the module's docstring); a leaf the
    program lacks reads as norm 0."""
    rn = norms(ref)
    keys = list(rn) if keys is None else list(keys)
    med = statistics.median(rn[k] for k in keys)
    out = {}
    for k in keys:
        pn = float(prog[k].detach().double().norm()) if k in prog else 0.0
        out[k] = abs(pn - rn[k]) / max(rn[k], med, 1e-300)
    return out


def leaf_norm_gap(prog, ref, keys=None) -> float:
    """The worst leaf's gap of norms."""
    return max(leaf_gaps(prog, ref, keys).values())


def worst_leaf(prog, ref, keys=None) -> str:
    """The leaf that sets `leaf_norm_gap`."""
    gaps = leaf_gaps(prog, ref, keys)
    return max(gaps, key=gaps.get)


def moving_leaves(ref_grads: Dict[str, torch.Tensor]) -> List[str]:
    """Leaves whose reference gradient is not negligible."""
    rn = norms(ref_grads)
    med = statistics.median(rn.values())
    return [k for k, n in rn.items() if n >= NEGLIGIBLE * med]


def change(after: Dict[str, torch.Tensor],
           before: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: after[k].double() - before[k].double().to(after[k].device)
            for k in before}


def rel_gap(prog: float, ref: float) -> float:
    if not math.isfinite(prog):
        return math.inf
    return abs(prog - ref) / max(abs(ref), 1e-300)


def max_abs_gap(prog: torch.Tensor, ref: torch.Tensor) -> float:
    if prog.shape != ref.shape:
        return math.inf
    d = (prog.double().to(ref.device) - ref.double()).abs()
    return float(d.max()) if d.numel() else 0.0


def rel_max_gap(prog: torch.Tensor, ref: torch.Tensor) -> float:
    """The largest elementwise gap over the reference's largest value."""
    scale = float(ref.double().abs().max()) if ref.numel() else 1.0
    return max_abs_gap(prog, ref) / max(scale, 1e-300)


def share_differing(prog: torch.Tensor, ref: torch.Tensor) -> float:
    if prog.shape != ref.shape:
        return math.inf
    return float((prog.to(ref.device).long() != ref.long()).double().mean())
