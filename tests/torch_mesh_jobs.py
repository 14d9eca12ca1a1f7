"""Rank bodies for the port's mesh tests. The spawned gloo ranks
import this module, which imports only torch and the port (a test module
would pull in JAX and the reference on every rank)."""

import time

import numpy as np
import torch

from ppls_tpu_torch.parallel import mesh as M


def _rows(mesh, outs):
    """Every rank's outputs, gathered to host (n, ...) arrays."""
    return [mesh.syncs.pull_arrays(mesh.all_gather(t))[0] for t in outs]


def primitives(case: dict) -> dict:
    """Run ``strided_reshard`` and ``phase_reshard`` on this rank's row of
    the seeded inputs in ``case`` and return every rank's outputs."""
    mesh = M.make_mesh(device="cpu")
    r = mesh.rank
    cols = [torch.as_tensor(case["cols"][j][r]) for j in range(4)]
    key = torch.as_tensor(case["key"][r])
    fills = case["fills"]
    out = {}
    for tag, sort_key in (("plain", None), ("keyed", key)):
        before = dict(mesh.calls)
        oc, mine, total, header = M.strided_reshard(
            mesh, cols, int(case["n_valid"][r]), fills, case["out_width"],
            sort_key=sort_key)
        calls = {k: mesh.calls[k] - before[k] for k in before}
        rows = _rows(mesh, [*oc, mine.to(torch.int32)])
        out[f"strided_{tag}"] = dict(cols=rows[:4], mine=rows[4],
                                     total=total, header=header,
                                     calls=calls)
    for floor in case["floors"]:
        before = dict(mesh.calls)
        wc, n_mine, did, _h = M.phase_reshard(
            mesh, cols, int(case["n_valid"][r]), fills, case["window"],
            floor, sort_key=key)
        calls = {k: mesh.calls[k] - before[k] for k in before}
        rows = _rows(mesh, [*wc, torch.tensor([n_mine])])
        out[f"phase_{floor}"] = dict(cols=rows[:4], n_mine=rows[4][:, 0],
                                     did=did, calls=calls)
    return out


def seeded_case(n: int, seed: int = 7) -> dict:
    """Seeded per-rank inputs: (n, width) columns, live counts, a depth
    key, the fills, and the deal geometry."""
    rng = np.random.default_rng(seed)
    width = 48
    l = rng.uniform(0.0, 1.0, (n, width))
    rr = l + rng.uniform(0.0, 1.0, (n, width))
    th = rng.uniform(1.0, 2.0, (n, width))
    depth = rng.integers(0, 6, (n, width)).astype(np.int32)
    meta = ((rng.integers(0, 5, (n, width)).astype(np.int32) << 14)
            + depth)
    n_valid = rng.integers(0, width + 1, n).astype(np.int32)
    n_valid[0] = width                  # one rank full
    n_valid[-1] = 0                     # one rank empty
    return dict(cols=[l, rr, th, meta], key=depth, n_valid=n_valid,
                fills=(0.25, 0.25, 1.5, 0), out_width=width, window=16,
                floors=(8, 10 ** 6))


def fail_on(rank: int) -> int:
    """Raise a ValueError on ``rank`` only (the others return)."""
    mesh = M.make_mesh(device="cpu")
    if mesh.rank == rank:
        raise ValueError(f"rank {rank} refuses")
    return mesh.rank


def hang_on(rank: int) -> int:
    """``rank`` never reaches the collective the others wait in."""
    mesh = M.make_mesh(device="cpu")
    if mesh.rank == rank:
        time.sleep(600)
    mesh.psum_host([1])
    return mesh.rank


def cli_output(argv) -> tuple:
    """``python -m ppls_tpu_torch ARGV`` run in this rank's process (inside
    its process group): ``(exit code, standard output)``."""
    import contextlib
    import io

    from ppls_tpu_torch import __main__ as CLI
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = CLI.main(list(argv))
    return rc, buf.getvalue()


def qmc_on_mesh(name: str, n_points: int):
    """``integrate_qmc`` on this rank's mesh, passed in (``mesh=``)."""
    from ppls_tpu_torch.models import genz as G
    from ppls_tpu_torch.parallel.qmc import integrate_qmc
    a, u = G.genz_params(name, 8, seed=0)
    return integrate_qmc(G.get_genz(name).fn, a, u, n_points=n_points,
                         mesh=M.make_mesh(device="cpu"))


def segsum_knob_on_every_rank(m: int = 64, n: int = 4096) -> np.ndarray:
    """Per rank (rows in rank order): whether PPLS_EXACT_SEGSUM reads as
    set here, and whether ``segment_sum_auto`` at m <= 256 gave the
    exact tier's bits on seeded arbitrary leaves."""
    from ppls_tpu_torch.ops import reduction as R
    mesh = M.make_mesh(device="cpu")
    rng = np.random.default_rng(mesh.rank)
    fam = torch.from_numpy(rng.integers(0, m, n).astype(np.int32))
    leaf = torch.from_numpy(rng.uniform(-1, 1, n)
                            * 10.0 ** rng.uniform(-9, -3, n))
    same = torch.equal(R.segment_sum_auto(fam, leaf, m, n),
                       R.exact_segment_sum(fam, leaf, m, n))
    return mesh.gather_host([int(R._env_force_exact()), int(same)])
