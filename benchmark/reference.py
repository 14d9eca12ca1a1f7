"""The plain reference: an adaptive trapezoid bag in plain PyTorch.

The semantics the program is held to, per problem f(x, theta) over
[a, b]: an interval [l, r] is scored by the whole-interval trapezoid
against the sum of its two half-interval trapezoids; it splits at its
midpoint when that discrepancy exceeds ``eps`` (strict ``>``), and
otherwise adds the two-halves value to its problem's area. A theta batch
is a batch of such problems, one per theta.

The bag runs breadth first, a block of rows at a time, in the type it is
given: float64 is the reference, float32 the control. It imports nothing
of the program, and takes only the problems (bounds and thetas) as the
benchmark generated them.
"""

from __future__ import annotations

import importlib.util
import os
from typing import Callable

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
MAX_DEPTH = 80          # a float64 bag of these problems ends far above it
BLOCK_ROWS = 1 << 23    # intervals scored at once


def load_integrand(family: str) -> Callable:
    """``f(x, theta)`` from ``integrands/<family>.py``."""
    path = os.path.join(HERE, "integrands", f"{family}.py")
    spec = importlib.util.spec_from_file_location(f"integrand_{family}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.f


def bag_areas(f: Callable, thetas: torch.Tensor, bounds, eps: float,
              *, dtype=torch.float64, device="cpu",
              block_rows: int = BLOCK_ROWS) -> dict:
    """Areas of the problems ``f(x, theta)`` over ``bounds``, one per
    entry of the 1-D ``thetas``.

    Returns ``{"areas": (n,) tensor, "tasks": intervals scored,
    "max_depth": deepest level}``. Raises when a level passes
    ``MAX_DEPTH``, which a sound bag of these problems never does."""
    th = thetas.reshape(-1).to(device=device, dtype=dtype)
    n = th.shape[0]
    acc = torch.zeros(n, dtype=dtype, device=device)
    level = (torch.full((n,), float(bounds[0]), dtype=dtype, device=device),
             torch.full((n,), float(bounds[1]), dtype=dtype, device=device),
             torch.arange(n, device=device))
    tasks = depth = 0
    while level[0].shape[0]:
        if depth > MAX_DEPTH:
            raise RuntimeError(f"reference bag passed depth {MAX_DEPTH}")
        children = ([], [], [])
        for s in range(0, level[0].shape[0], block_rows):
            l, r, p = (c[s:s + block_rows] for c in level)
            t = th[p]
            mid = (l + r) * 0.5
            fl, fr, fm = f(l, t), f(r, t), f(mid, t)
            lrarea = (fl + fr) * ((r - l) * 0.5)
            value = (fl + fm) * ((mid - l) * 0.5) + (fm + fr) * ((r - mid)
                                                                 * 0.5)
            split = torch.abs(value - lrarea) > eps
            acc.index_add_(0, p[~split], value[~split])
            tasks += int(l.shape[0])
            ms = mid[split]
            for out, part in zip(children, ((l[split], ms), (ms, r[split]),
                                            (p[split], p[split]))):
                out.extend(part)
        level = tuple(torch.cat(c) if c else torch.empty(0, device=device)
                      for c in children)
        depth += 1
    return {"areas": acc, "tasks": tasks, "max_depth": depth - 1}
