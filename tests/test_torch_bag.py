"""The port's float64 family bag engine (the walker's breed and drain)
against the reference's ``integrate_family``: the same families,
bounds, thetas and chunking on both sides.

Contract: task and split counts, rounds and maximum depth equal; areas
within 1e-13 relative (the two differ only in the order of float64
reductions and in libm's last bit for sin/cosh).
"""

import numpy as np
import pytest
import torch

from ppls_tpu.models.integrands import get_family as ref_family
from ppls_tpu.parallel.bag_engine import integrate_family as ref_integrate
from ppls_tpu_torch.models.integrands import family_exact, get_family
from ppls_tpu_torch.parallel.bag_engine import integrate_family

CASES = [
    # the flagship family, deep enough to split ~23k tasks
    ("sin_recip_scaled", 1.0 + np.arange(8) / 8.0, (1e-2, 1.0), 1e-7),
    # the reference C program's problem: cosh^4 on [0, 5] at eps 1e-3
    ("cosh4_scaled", np.array([1.0]), (0.0, 5.0), 1e-3),
    # a mixed cosh4 family through the broadcast-mask tier
    ("cosh4_scaled", 0.5 + np.arange(16) / 16.0, (0.0, 3.0), 1e-6),
]


@pytest.mark.parametrize("fam,theta,bounds,eps", CASES)
def test_integrate_family_matches_reference(fam, theta, bounds, eps):
    kw = dict(chunk=1 << 10, capacity=1 << 16)
    got = integrate_family(get_family(fam), theta, bounds, eps,
                           device="cpu", **kw)
    ref = ref_integrate(ref_family(fam), theta, bounds, eps, **kw)
    assert got.metrics.tasks == ref.metrics.tasks
    assert got.metrics.splits == ref.metrics.splits
    assert got.metrics.rounds == ref.metrics.rounds
    assert got.metrics.max_depth == ref.metrics.max_depth
    assert got.metrics.tasks == got.metrics.splits + got.metrics.leaves
    rel = np.abs(got.areas - ref.areas) / np.abs(ref.areas)
    assert np.max(rel) <= 1e-13
    assert got.host_syncs > 0


def test_reference_problem_golden_values():
    # the reference C program (cosh^4 on [0, 5], eps 1e-3): 6567 tasks,
    # 3283 splits, depth 14, area 7583461.801486 at %.6f
    r = integrate_family(get_family("cosh4_scaled"), [1.0], (0.0, 5.0),
                         1e-3, chunk=1 << 10, capacity=1 << 16,
                         device="cpu")
    assert (r.metrics.tasks, r.metrics.splits, r.metrics.max_depth) \
        == (6567, 3283, 14)
    assert f"{r.areas[0]:.6f}" == "7583461.801486"
    exact = family_exact("cosh4_scaled", 0.0, 5.0, [1.0])[0]
    assert abs(r.areas[0] - exact) < 0.5


def test_bag_entry_point_requires_cuda_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        integrate_family(get_family("sin_recip_scaled"), [1.0],
                         (0.1, 1.0), 1e-3)
