"""2D tensor-product cubature rules and their refinement tests (float64).

The 1D rule compares one estimate against its composite refinement and
splits when they disagree. Both 2D tensor-product analogs keep that
shape:

* TRAPEZOID (9-point 3x3 grid): coarse = corner average x area; refined
  = the sum of the four half-size sub-cell trapezoids; split when
  |refined - coarse| > eps (strict). The C rectangle bag
  (``backends/csrc/aquad_seq.c``, 2d mode) runs the same test.
* SIMPSON (25-point 5x5 grid): coarse = one tensor-product Simpson
  panel on the even 3x3 sub-grid; refined = four Simpson panels on the
  quadrant 3x3 grids; error |S2 - S1| / 15 and the Richardson value
  S2 + (S2 - S1) / 15.

The float64 operations are the reference's, in its order: the split
decisions are compared bit for bit with the C twin's. The grid points
go through ``f`` in one call (``f`` is elementwise, so each point's
value is the one a call per point gives), the four sub-cells' sums and
the four quadrant panels are computed side by side (each with the
reference's operations in its order), and a division by a constant
divides by a tensor on the batch's device: PyTorch on CUDA multiplies
by the reciprocal of a Python-scalar divisor.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from ppls_tpu_torch.config import Rule

EVALS_PER_TASK_2D = {Rule.TRAPEZOID: 9, Rule.SIMPSON: 25}


def div(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x / c``, correctly rounded on every device."""
    return x / torch.full((), c, dtype=x.dtype, device=x.device)


def _grid(xs, ys, f: Callable) -> torch.Tensor:
    """``g[i, j] = f(xs[i], ys[j])``, a (len(xs), len(ys), n) block from
    one call of ``f`` on the broadcast points."""
    x = torch.stack(xs)[:, None, :]
    y = torch.stack(ys)[None, :, :]
    return torch.broadcast_to(f(x, y), (x.shape[0], y.shape[1], x.shape[2]))


def trapezoid_rect_batch(lx: torch.Tensor, rx: torch.Tensor,
                         ly: torch.Tensor, ry: torch.Tensor,
                         f: Callable, eps: float
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Evaluate a batch of rectangles: ``(value, err, split)``. ``value``
    is the refined (four sub-cell) estimate, accepted where ``split`` is
    False."""
    mx = 0.5 * (lx + rx)
    my = 0.5 * (ly + ry)
    g = _grid((lx, mx, rx), (ly, my, ry), f)      # g[i, j] = f_ij

    area = (rx - lx) * (ry - ly)
    coarse = 0.25 * (g[0, 0] + g[0, 2] + g[2, 0] + g[2, 2]) * area
    # the four sub-cell corner sums at once, each in the reference's
    # order (f_ij + f_ij+1 + f_i+1j + f_i+1j+1), then q = s00 + s01 +
    # s10 + s11; each sub-cell trapezoid is corner average x area / 4
    s = g[:2, :2] + g[:2, 1:] + g[1:, :2] + g[1:, 1:]
    q = s[0, 0] + s[0, 1] + s[1, 0] + s[1, 1]
    refined = 0.0625 * q * area
    err = torch.abs(refined - coarse)
    return refined, err, err > eps


def simpson_rect_batch(lx: torch.Tensor, rx: torch.Tensor,
                       ly: torch.Tensor, ry: torch.Tensor,
                       f: Callable, eps: float
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Tensor-product Simpson with Richardson extrapolation on the 5x5
    grid. O(h^6) per accepted cell."""
    hx = 0.25 * (rx - lx)
    hy = 0.25 * (ry - ly)
    # g[i, j] = f(lx + i*hx, ly + j*hy), 5x5
    g = _grid([lx + i * hx for i in range(5)],
              [ly + j * hy for j in range(5)], f)
    w = (1.0, 4.0, 1.0)

    def panels(pick):
        # tensor-product Simpson panels on 3x3 sub-grids, weights
        # (1, 4, 1)^2, summed in the reference's order; pick(a, b) is
        # the grid value(s) at panel offset (a, b)
        tot = 0.0
        for a in range(3):
            for b in range(3):
                tot = tot + w[a] * w[b] * pick(a, b)
        return tot

    area = (rx - lx) * (ry - ly)
    # coarse: one panel over the whole cell (even-index 3x3, stride 2)
    s1 = div(panels(lambda a, b: g[2 * a, 2 * b]) * area, 36.0)
    # refined: the four quadrant panels at once (p[u, v] is the panel at
    # (2u, 2v)), added as panel(0,0) + panel(2,0) + panel(0,2) +
    # panel(2,2), each area / 4
    p = panels(lambda a, b: g[a:a + 3:2, b:b + 3:2])
    s2 = div((p[0, 0] + p[1, 0] + p[0, 1] + p[1, 1]) * area, 144.0)
    err = div(torch.abs(s2 - s1), 15.0)
    value = s2 + div(s2 - s1, 15.0)
    return value, err, err > eps


_RULES_2D = {
    Rule.TRAPEZOID: trapezoid_rect_batch,
    Rule.SIMPSON: simpson_rect_batch,
}


def eval_rect_batch(lx: torch.Tensor, rx: torch.Tensor,
                    ly: torch.Tensor, ry: torch.Tensor,
                    f: Callable, eps: float, rule: Rule = Rule.SIMPSON
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Score a batch of rectangles: ``(value, err_est, split_mask)``."""
    return _RULES_2D[Rule(rule)](lx, rx, ly, ry, f, eps)
