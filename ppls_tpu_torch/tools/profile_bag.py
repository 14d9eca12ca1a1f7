"""The cost of each bag-loop component on the card (what one iteration of
the float64 bag engine's body costs, part by part):

    python ppls_tpu_torch/tools/profile_bag.py [K] [--device cuda]

The JAX package's ``tools/profile_bag.py`` at its sizes: CHUNK 2^16
tasks, a CAP 2^22 bag, M 128 families, K iterations (100 by default).
Each component runs K times in one timed region between CUDA events,
after one warm-up call. Its inputs depend on the previous iteration's
output (a float64 scalar ``c`` threads through every iteration and
perturbs the inputs by a few 1e-9), so no iteration can be skipped or
hoisted: the stand-in for the reference's ``fori_loop`` carry. It prints
microseconds per iteration per component.

The components: the three-point trapezoid evaluation of sin(theta / x)
(scalar theta and per-task theta in float64, per-task in float32); the
theta[fam] gather; a stable sort by a 1-bit key carrying 3 or 2 more
columns; the per-family reduction four ways (masked sum, two float32
one-hot products, ``index_add_``, one float64 one-hot product); three
pops of CHUNK from the bag at a carry-dependent offset (``index_select``:
the offset stays on the device); one and three pushes of 2 x CHUNK into
it (``index_copy_``, in place).

With ``--device cpu`` it times the same on the host CPU (perf_counter),
which says nothing of the card; without a card and without that flag it
exits 2 with ``resolve_device``'s message.
"""

from __future__ import annotations

import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

CHUNK = 1 << 16
CAP = 1 << 22
M = 128
K = 100


def bench(name, body, args, k, dev) -> float:
    """Microseconds per iteration of ``c = body(c, *args)`` over ``k``
    iterations after one warm-up call (CUDA events on a card)."""
    import torch
    c = torch.ones((), dtype=torch.float64, device=dev)
    c = body(c, *args)                        # warm-up
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(k):
            c = body(c, *args)
        stop.record()
        torch.cuda.synchronize(dev)
        us = 1e3 * start.elapsed_time(stop) / k
    else:
        t0 = time.perf_counter()
        for _ in range(k):
            c = body(c, *args)
        float(c)
        us = 1e6 * (time.perf_counter() - t0) / k
    if not bool(torch.isfinite(c)):
        raise FloatingPointError(f"{name}: the carry is not finite")
    print(f"{name:45s} {us:9.1f} us/iter", flush=True)
    return us


def profile(device="cuda", k: int = K, seed: int = 0) -> dict:
    """Time every component ``k`` times on ``device``; returns
    ``{component: us per iteration}``."""
    import numpy as np
    import torch

    from ppls_tpu_torch.utils.device import resolve_device
    dev = resolve_device(device)
    f64, f32, i64 = torch.float64, torch.float32, torch.int64
    rng = np.random.default_rng(seed)

    def t(x, dtype=f64):
        return torch.tensor(x, dtype=dtype, device=dev)

    l = t(rng.uniform(1e-4, 0.5, CHUNK))
    r = l + 1e-6
    fam = t(rng.integers(0, M, CHUNK), i64)
    theta = t(1.0 + np.arange(M) / M)
    bag_l = t(rng.uniform(1e-4, 1.0, CAP + 2 * CHUNK))
    leaf = t(rng.uniform(0, 1e-9, CHUNK))
    ids = torch.arange(M, device=dev)
    ar = torch.arange(CHUNK, device=dev)
    ar2 = torch.arange(2 * CHUNK, device=dev)
    out = {}

    def wob(c):
        """a tiny carry-dependent perturbation, keeps values in range"""
        return torch.remainder(c, 3.0) * 1e-9

    def offset(c):
        """a carry-dependent bag offset, on the device"""
        return (c.to(i64) * 2654435761 % CAP) & (CAP - 1)

    def f_eval(x, th):
        return torch.sin(th / x)

    # 1. integrand eval: 3 points + trapezoid arithmetic
    def eval_body(c, l, r, th, tol):
        ll = l + wob(c).to(l.dtype)
        m = (ll + r) * 0.5
        fl, fm, fr = f_eval(ll, th), f_eval(m, th), f_eval(r, th)
        h = r - ll
        lr = (fl + fr) * h * 0.5
        two = (fl + fm) * h * 0.25 + (fm + fr) * h * 0.25
        return c + torch.where((two - lr).abs() > tol, two, lr).sum()

    th_vec = theta[fam]
    out["eval_scalar_f64"] = bench(
        "eval 3pt+trap, scalar theta (f64)", eval_body,
        (l, r, t(1.5), 1e-10), k, dev)
    out["eval_vector_f64"] = bench(
        "eval 3pt+trap, vector theta (f64)", eval_body,
        (l, r, th_vec, 1e-10), k, dev)
    out["eval_vector_f32"] = bench(
        "eval 3pt+trap, vector theta (f32)", eval_body,
        (l.to(f32), r.to(f32), th_vec.to(f32), 1e-7), k, dev)

    # 2. the theta[fam] gather alone (indices depend on the carry)
    def gather_body(c, theta, fam):
        idx = (fam + (c.to(i64) & 1)) % M
        return c + theta[idx].sum() * 1e-12

    out["gather"] = bench("theta[fam] gather (128-table, 65536)",
                          gather_body, (theta, fam), k, dev)

    # 3. stable sort by a 1-bit key, carrying the other columns
    def sort_body(c, l, r, fam):
        ll = l + wob(c)
        key = (ll > 0.25).to(torch.int32)
        perm = torch.sort(key, stable=True).indices
        return c + ll[perm][0] + r[perm][CHUNK - 1] + fam[perm][0] * 1e-12

    out["sort4"] = bench("4-op stable sort (65536)", sort_body,
                         (l, r, fam), k, dev)

    def sort2_body(c, l, r):
        ll = l + wob(c)
        key = (ll > 0.25).to(torch.int32)
        perm = torch.sort(key, stable=True).indices
        return c + ll[perm][0] + r[perm][CHUNK - 1]

    out["sort3"] = bench("3-op stable sort (65536)", sort2_body, (l, r), k,
                         dev)

    # 4. family reduce variants (the leaves depend on the carry)
    def famred_mask(c, fam, leaf):
        lf = leaf + wob(c)
        seg = torch.where(fam[None, :] == ids[:, None], lf[None, :],
                          0.0).sum(dim=1)
        return c + seg.sum() * 1e-12

    out["reduce_mask"] = bench("family reduce: mask (128x65536 f64)",
                               famred_mask, (fam, leaf), k, dev)

    def famred_mm(c, fam, leaf):
        lf = leaf + wob(c)
        hi = lf.to(f32)
        lo = (lf - hi.to(f64)).to(f32)
        oh = torch.nn.functional.one_hot(fam, M).to(f32)
        s = (hi @ oh).to(f64) + (lo @ oh).to(f64)
        return c + s.sum() * 1e-12

    out["reduce_mm_2xf32"] = bench("family reduce: 2xf32 one-hot matmul",
                                   famred_mm, (fam, leaf), k, dev)

    def famred_scatter(c, fam, leaf):
        lf = leaf + wob(c)
        acc = torch.zeros(M, dtype=f64, device=dev).index_add_(0, fam, lf)
        return c + acc.sum() * 1e-12

    out["reduce_scatter"] = bench("family reduce: scatter-add",
                                  famred_scatter, (fam, leaf), k, dev)

    def famred_mm64(c, fam, leaf):
        lf = leaf + wob(c)
        oh = torch.nn.functional.one_hot(fam, M).to(f64)
        return c + (lf @ oh).sum() * 1e-12

    out["reduce_mm_f64"] = bench("family reduce: f64 one-hot matmul",
                                 famred_mm64, (fam, leaf), k, dev)

    # 5. pops from the big bag at a carry-dependent offset
    def pop_body(c, bag):
        idx = offset(c) + ar
        a = torch.index_select(bag, 0, idx)
        b = torch.index_select(bag, 0, idx)
        d = torch.index_select(bag, 0, idx)
        return c + a[0] + b[1] + d[2]

    out["pop3"] = bench("3x dynamic_slice pop (4M bag)", pop_body, (bag_l,),
                        k, dev)

    # 6. pushes into the bag at a carry-dependent offset (in place)
    ch = torch.cat([l, r])

    def push1(c, bag, ch):
        bag.index_copy_(0, offset(c) + ar2, ch + wob(c))
        return c + bag[0]

    out["push1"] = bench("1x dyn_update_slice push (131072 into 4M)", push1,
                         (bag_l.clone(), ch), k, dev)

    def push3(c, b1, b2, b3, ch):
        idx = offset(c) + ar2
        for b in (b1, b2, b3):
            b.index_copy_(0, idx, ch + wob(c))
        return c + b1[0] + b2[0] + b3[0]

    out["push3"] = bench("3x dyn_update_slice push", push3,
                         (bag_l.clone(), bag_l + 1, bag_l + 2, ch), k, dev)
    return out


def main(argv=None) -> int:
    """``argv`` without the program name: ``[K] [--device D]``."""
    import argparse
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("k", nargs="?", type=int, default=K)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    try:
        profile(args.device, args.k)
    except RuntimeError as e:
        if "CUDA is not available" not in str(e):
            raise
        print(f"profile_bag: {e}", file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
