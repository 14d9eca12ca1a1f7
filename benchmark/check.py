"""How ``correct`` is decided: the program's answers against the plain
reference (``reference.py``), once the window has closed.

A sample of the answers the window produced, drawn from the seed, is
worked out again by the float64 reference bag from the same problems
(bounds and thetas as the benchmark generated them). The number compared
is the widest absolute gap between a sampled area and the reference's,
held to the limit the configuration states; every answer of the window
is also checked for being present and finite. ``answers_checked``
reaches ``check_answers`` whenever the window produced that many.
"""

from __future__ import annotations

import numpy as np

import generate
import reference


def _answers(rec: dict):
    """(thetas, areas) of every answer the window produced, flat, and
    the count of answers whose shape did not match their problems."""
    if "calls" in rec:
        th, ar = rec["thetas"], rec["areas"]
    else:
        reqs = rec["answers"]
        th = [r["thetas"] for r in reqs]
        ar = [np.asarray(r["areas"] if r["areas"] is not None else [],
                         dtype=np.float64).reshape(-1) for r in reqs]
    missing = sum(max(0, len(t) - len(a)) for t, a in zip(th, ar))
    pairs = [(t[:len(a)], a[:len(t)]) for t, a in zip(th, ar)]
    thetas = np.concatenate([p[0] for p in pairs]) if pairs else np.zeros(0)
    areas = np.concatenate([p[1] for p in pairs]) if pairs else np.zeros(0)
    return thetas, areas, missing


def sample_index(n: int, k: int, seed: int) -> np.ndarray:
    """k answer indices of n, drawn from the seed's check stream."""
    gen = generate.rng(seed, "check")
    return np.sort(gen.choice(n, size=min(k, n), replace=False))


def run(cfg: dict, mix: dict, rec: dict, seed: int, device: str,
        answer_dtype=None) -> dict:
    """Returns ``{"correct", "attempted", "failed", "numbers"}``;
    ``numbers`` maps each compared name to ``{"value", "limit"}``.
    ``answer_dtype`` replaces the program's sampled answers by the
    reference computed in that type (the control)."""
    import torch

    thetas, areas, missing = _answers(rec)
    nonfinite = int(np.count_nonzero(~np.isfinite(areas))) + missing
    idx = sample_index(len(thetas), int(mix["check_answers"]), seed)
    f = reference.load_integrand(cfg["family"])
    th = torch.tensor(thetas[idx], dtype=torch.float64)
    ref = reference.bag_areas(f, th, cfg["bounds"], float(cfg["eps"]),
                              device=device)["areas"].cpu().numpy()
    got = areas[idx]
    if answer_dtype is not None:
        got = reference.bag_areas(
            f, th, cfg["bounds"], float(cfg["eps"]), dtype=answer_dtype,
            device=device)["areas"].cpu().double().numpy()
    gaps = np.abs(got - ref)
    gap = float(np.max(np.where(np.isfinite(gaps), gaps, np.inf))) \
        if len(gaps) else float("inf")
    limit = float(cfg["area_gap_limit"])
    over = int(np.count_nonzero(~(gaps <= limit)))
    numbers = {
        "area_gap": {"value": gap, "limit": limit},
        "bad_answers": {"value": nonfinite, "limit": 0},
        "answers_checked": {"value": int(len(idx)),
                            "limit": int(mix["check_answers"])},
    }
    correct = gap <= limit and nonfinite == 0 and len(idx) > 0
    return {"correct": bool(correct), "attempted": int(len(thetas)) + missing,
            "failed": nonfinite + over, "numbers": numbers}
