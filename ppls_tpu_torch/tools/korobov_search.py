"""Korobov generating-vector search: the provenance of
``ppls_tpu_torch/parallel/qmc.py`` ``KOROBOV_A`` (the same table as the
JAX package's, whose ``tools/korobov_search.py`` this copies).

Criterion: the standard P_2 worst-case error of the rank-1 Korobov
lattice z = (1, a, a^2, ..., a^{d-1}) mod N in the weighted Korobov
space with product weights gamma_j = 2^-j (j = 1..d, decaying: earlier
coordinates matter more, matching how the Genz families weight their
first coordinates through the a-vector draw):

    P_2(a, N) = -1 + (1/N) * sum_k prod_j (1 + gamma_j * w({k z_j / N}))
    w(x) = 2 pi^2 (x^2 - x + 1/6)          # = 2 pi^2 B_2(x)

(B_2 the Bernoulli polynomial.) Candidates: K odd values drawn uniformly
from (1, N/2) with a fixed seed, the classic Korobov restriction (a and
N-a generate mirror-image lattices, so half the range suffices), plus
the incumbent ``KOROBOV_A`` values, so a re-run can only confirm or
improve the table.

Run on the host CPU (numpy only, no device):

    python ppls_tpu_torch/tools/korobov_search.py            # 2^16-2^20
    python ppls_tpu_torch/tools/korobov_search.py --full     # + 2^22
    python ppls_tpu_torch/tools/korobov_search.py --sizes 12 # any sizes

and compare the printed table with ``KOROBOV_A``.
"""

import argparse
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

D = 8
N_CANDIDATES = 256
SEED = 42
GAMMA = 0.5 ** np.arange(1, D + 1)          # product weights 2^-j


def p2_criterion(a: int, n: int, d: int = D,
                 gamma: np.ndarray = GAMMA,
                 _k_cache: dict = {}) -> float:
    """P_2 worst-case error (squared, up to the constant -1 term) of the
    Korobov lattice with generator a, vectorized over all N points.

    The k*z_j mod N reduction runs in f64, not int64: with k < N <= 2^22
    and z_j < N the product is < 2^44 — exact in f64 — and float
    floor-division is ~8x faster than numpy's int64 %, which made the
    naive version time out at N=2^22 on this single-core host. A
    where-correction absorbs the at-most-one-off floor rounding.
    """
    if n not in _k_cache:
        _k_cache[n] = np.arange(n, dtype=np.float64)
    k = _k_cache[n]
    nf = float(n)
    prod = np.ones(n, dtype=np.float64)
    zj = 1
    for j in range(d):
        y = k * float(zj)                    # exact: < 2^44
        r = y - np.floor(y / nf) * nf
        r = np.where(r >= nf, r - nf, r)
        r = np.where(r < 0.0, r + nf, r)
        frac = r / nf
        w = 2.0 * np.pi ** 2 * (frac * frac - frac + 1.0 / 6.0)
        prod *= 1.0 + gamma[j] * w
        zj = (zj * a) % n
    return float(prod.mean() - 1.0)


def search(n: int, extra_candidates=(), n_candidates: int = N_CANDIDATES,
           seed: int = SEED):
    """Best generator among seeded odd candidates + any incumbents."""
    rng = np.random.default_rng(seed)
    cand = set(int(c) for c in extra_candidates)
    while len(cand) < n_candidates:
        a = int(rng.integers(3, n // 2))
        cand.add(a | 1)                      # odd
    scored = sorted((p2_criterion(a, n), a) for a in sorted(cand))
    return scored[0][1], scored[0][0], scored


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true",
                    help="also search N=2^22 (~2 min extra)")
    ap.add_argument("--sizes", type=int, nargs="*", default=None,
                    help="explicit log2 sizes (default: 16 18 20 [22])")
    args = ap.parse_args(argv)

    sys.path.insert(0, ROOT)
    from ppls_tpu_torch.parallel.qmc import KOROBOV_A

    log2s = args.sizes or ([16, 18, 20, 22] if args.full else [16, 18, 20])
    table = {}
    for lg in log2s:
        n = 1 << lg
        incumbent = KOROBOV_A.get(n)
        best_a, best_p2, scored = search(
            n, extra_candidates=[incumbent] if incumbent else [])
        inc_p2 = p2_criterion(incumbent, n) if incumbent else None
        table[n] = best_a
        status = ("MATCHES incumbent" if incumbent == best_a else
                  f"incumbent {incumbent} (P2={inc_p2:.3e}) superseded"
                  if incumbent else "new size")
        print(f"N=2^{lg}: a={best_a}  P2={best_p2:.6e}  [{status}; "
              f"median candidate P2={scored[len(scored)//2][0]:.3e}]",
              flush=True)
    print("\nKOROBOV_A = {")
    for n in sorted(table):
        print(f"    1 << {n.bit_length() - 1}: {table[n]},")
    print("}")


if __name__ == "__main__":
    main()
