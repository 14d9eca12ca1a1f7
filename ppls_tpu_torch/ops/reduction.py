"""Deterministic accumulation primitives (float64).

No reduction here uses floating-point atomics (``index_add_``,
``scatter_add``): their order changes from run to run and would break
bit-identical reruns. Per-family sums are either ordinary fixed-shape
reductions or the error-free digit-plane contraction, whose result does
not depend on the order of the additions at all.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import torch

from ppls_tpu_torch.ops.pow2 import pow2_f64
from ppls_tpu_torch.utils.device import resolve_device


def masked_sum(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Sum of ``values`` where ``mask``; deterministic for a fixed shape
    and device."""
    return torch.where(mask, values, torch.zeros_like(values)).sum()


def kahan_init(dtype=torch.float64, device="cuda"
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sum, compensation) carried across wavefront rounds, on ``device``
    (CUDA by default, raising without a card unless ``device="cpu"``)."""
    zero = torch.zeros((), dtype=dtype, device=resolve_device(device))
    return zero, zero.clone()


def kahan_sum(acc: Tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
    """The compensated value of a (sum, compensation) pair."""
    s, c = acc
    return s + c


def neumaier_add_host(s: float, c: float, x: float) -> Tuple[float, float]:
    """:func:`kahan_add` on Python floats, for the host-driven engine's
    accumulation across rounds."""
    t = s + x
    if abs(s) >= abs(x):
        c += (s - t) + x
    else:
        c += (x - t) + s
    return t, c


def kahan_add(acc: Tuple[torch.Tensor, torch.Tensor],
              x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Neumaier compensated add: ``acc + x`` with error carry."""
    s, c = acc
    t = s + x
    big_first = torch.abs(s) >= torch.abs(x)
    err = torch.where(big_first, (s - t) + x, (x - t) + s)
    return t, c + err


def _env_force_exact() -> bool:
    """PPLS_EXACT_SEGSUM truthiness (unset, 0, false and off mean
    False)."""
    v = os.environ.get("PPLS_EXACT_SEGSUM", "").strip().lower()
    return v not in ("", "0", "false", "off")


def segment_sum_auto(fam: torch.Tensor, leaf: torch.Tensor, m: int,
                     n: int, force_exact: Optional[bool] = None
                     ) -> torch.Tensor:
    """Per-family sum of ``leaf`` by id ``fam`` with the reference's
    tiers: a plain sum for m == 1, a broadcast-mask reduction for
    m <= 256, and :func:`exact_segment_sum` beyond. Only the last tier
    is error-free; the first two are fixed-order float64 reductions,
    deterministic for a given shape and device, so a sum can move by
    ~1 ulp when m crosses a tier boundary (a rank's m_local <= 256
    against one card's m = 1024).

    ``force_exact`` (default: the ``PPLS_EXACT_SEGSUM`` environment
    knob) sends every tier through :func:`exact_segment_sum`: the
    per-segment totals then do not depend on the tier, and one card and
    a world of ranks give bit-identical shard sums."""
    if force_exact is None:
        force_exact = _env_force_exact()
    if force_exact:
        return exact_segment_sum(fam, leaf, m, n)
    if m == 1:
        return leaf.sum().reshape(1)
    if m <= 256:
        fam_ids = torch.arange(m, dtype=torch.int32, device=fam.device)
        return torch.where(fam[None, :] == fam_ids[:, None],
                           leaf[None, :], 0.0).sum(dim=1)
    return exact_segment_sum(fam, leaf, m, n)


def _segment_factors(m: int, planes: int) -> Tuple[int, int]:
    """Power-of-two (FA, FB) with FA * FB >= m minimising the generated
    operand rows per lane, planes * FA + FB."""
    best = None
    fb = 8
    while fb <= 256:
        fa = 1
        while fa * fb < m:
            fa *= 2
        cost = planes * fa + fb
        if best is None or cost < best[0]:
            best = (cost, fa, fb)
        fb *= 2
    return best[1], best[2]


def _matmul_full_f32(lhs: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """float32 product with TF32 switched off for the call. Every
    operand here is an integer of at most 2^8 in magnitude, which TF32
    would also hold exactly, and every partial sum an integer below
    2^24; full float32 is set anyway so the exactness argument does not
    rest on the tensor-core format."""
    if not lhs.is_cuda:
        return lhs @ rhs
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return lhs @ rhs
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def exact_segment_sum(fam: torch.Tensor, leaf: torch.Tensor, m: int,
                      n: int) -> torch.Tensor:
    """Per-segment float64 sums with no rounding error in the reduction:
    ``seg[j] = sum(leaf[fam == j])``, exactly.

    1. Scale leaves by a power of two S so |r| <= 1/2 (exact).
    2. Decompose r into P balanced base-2^B digits, |d_k| <= 2^(B-1).
    3. Contract the digits against a factored one-hot (fam = a*FB + b)
       in ONE float32 matrix product; every partial sum is an integer
       below 2^24, so the product is exact in any summation order.
    4. Recombine the integer planes in float64 (each plane value is an
       integer below 2^24 times a power of two, added plane by plane).

    The only loss is the truncation of digits beyond P*B >= 72 bits
    below the largest finite |leaf|: at most n * amax * 2^-73 per
    segment. Requires m <= 65536.

    A non-finite leaf stays in its own segment: the digits carry the
    finite leaves only, one more plane counts the non-finite leaves per
    segment, and a segment holding one sums to NaN. (The JAX package's
    contraction scales by the largest |leaf| including the non-finite
    ones, so there one NaN turns every segment NaN; the two agree bit
    for bit on finite leaves.)
    """
    if m > 65536:
        raise ValueError(f"exact_segment_sum supports m <= 65536, got {m}")
    bbits = min(9, 25 - max(n - 1, 1).bit_length())
    if bbits < 2:
        raise ValueError(f"segment length n={n} too large")
    planes = -(-72 // bbits)
    fa_n, fb_n = _segment_factors(m, planes)
    dev = leaf.device

    # non-finite leaves count as 0 in the digits and 1 in one more plane
    # of the same contraction: an exact integer count per segment (on an
    # H100 cheaper than an index_add_ count of the mask: PERF.md §6)
    finite_leaf = torch.nan_to_num(leaf, nan=0.0, posinf=0.0, neginf=0.0)
    bad = (finite_leaf != leaf).to(torch.float32)
    leaf = finite_leaf
    amax = torch.max(torch.abs(leaf))
    e = torch.ceil(torch.log2(torch.clamp(amax, min=2.0 ** -40))) + 1.0
    scale = pow2_f64(torch.clamp(e, -250.0, 250.0))
    r = leaf / scale
    digs = []
    for _ in range(planes):
        t = r * float(1 << bbits)
        d = torch.round(t)
        r = t - d
        digs.append(d.to(torch.float32))
    digs.append(bad)
    digits = torch.stack(digs)                               # (P + 1, n)

    fam = fam.to(torch.int32)
    fa = torch.div(fam, fb_n, rounding_mode="floor")
    fb = fam - fa * fb_n
    mask_a = (fa[None, :] == torch.arange(fa_n, dtype=torch.int32,
                                          device=dev)[:, None]
              ).to(torch.float32)
    oh_b = (fb[:, None] == torch.arange(fb_n, dtype=torch.int32,
                                        device=dev)[None, :]
            ).to(torch.float32)
    lhs = (digits[:, None, :] * mask_a[None, :, :]).reshape(
        (planes + 1) * fa_n, n)
    out = _matmul_full_f32(lhs, oh_b)                  # ((P + 1)*FA, FB)
    out = out.reshape(planes + 1, fa_n, fb_n)
    n_bad = out[planes].reshape(fa_n * fb_n)[:m]
    out = out[:planes].to(torch.float64)
    w = pow2_f64(-bbits * (torch.arange(planes, dtype=torch.float64,
                                        device=dev) + 1)) * scale
    acc = out[0] * w[0]
    for p in range(1, planes):
        acc = acc + out[p] * w[p]
    return torch.where(n_bad > 0, torch.nan, acc.reshape(fa_n * fb_n)[:m])
