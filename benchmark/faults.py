"""Faults planted under the timed path, for the benchmark's own tests:
each breaks what the program produces in one way a cell can show, and
the check has to answer ``correct`` false. Nothing in a benchmark run
imports this module.

``plant(name)`` patches this process.
"""

from __future__ import annotations

import numpy as np


def _half_areas(areas):
    """Half of the answers kept, the other half the mean of the kept."""
    a = np.array(areas, dtype=np.float64, copy=True)
    flat = a.reshape(-1)
    keep = flat.shape[0] // 2
    flat[keep:] = flat[:keep].mean() if keep else 0.0
    return a


def plant(name: str, set_=setattr) -> None:
    """Plant fault ``name``; ``set_`` sets each patched attribute (a
    test passes its monkeypatch's, which undoes them)."""
    import ppls_tpu_torch as pt
    from ppls_tpu_torch.parallel import walker as W
    from ppls_tpu_torch.runtime import stream as S

    if name == "stalled_step":
        # every walk segment hands its state back unchanged: one step
        # counted, nothing walked, nothing banked
        import torch

        def stalled(state, slot, thresh, cap, batch, nslots, bank, resm,
                    **kwargs):
            zeros = torch.zeros(tuple(bank[0].shape), dtype=torch.float32)
            counters = torch.zeros(8, dtype=torch.int32)
            counters[0] = 1
            return zeros, zeros.clone(), counters
        set_(W, "segment_rf_plain", stalled)
        return
    if name in ("half_batch", "altered_answer"):
        change = (_half_areas if name == "half_batch"
                  else lambda a: np.asarray(a) * (1.0 + 1e-7))
        inner = pt.integrate_family_walker

        def wrapped(*args, **kwargs):
            res = inner(*args, **kwargs)
            res.areas = change(res.areas)
            return res
        set_(pt, "integrate_family_walker", wrapped)
        step = S.StreamEngine.step

        def step_changed(self):
            out = step(self)
            for c in out:
                if c.areas is not None:
                    c.areas = list(change(c.areas))
            return out
        set_(S.StreamEngine, "step", step_changed)
        return
    raise ValueError(f"unknown fault {name!r}")

