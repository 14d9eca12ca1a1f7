"""The port's mesh layer (``ppls_tpu_torch/parallel/mesh.py``) against the
reference's (``ppls_tpu/parallel/mesh.py``), on the CPU.

* ``strided_reshard`` (plain and depth-keyed) and ``phase_reshard`` (a
  taken and a skipped rebalance) run in one spawned gloo world of 4
  ranks on seeded per-rank inputs; the reference runs the same inputs
  under ``shard_map`` on 4 of its 8 host devices. Every rank's dealt
  columns, validity mask, row counts and the replicated decision are
  equal, value for value. Each primitive's collective calls are counted
  by kind (one header gather, one data gather and one rank read per
  deal; a skipped rebalance pays the header gather only).
* ``host_strided_redeal`` and ``device_store`` equal the reference's.
* The launcher: an exception on one rank is raised by the call, a rank
  that never reaches a collective fails the launch at its time limit,
  and without a card a CUDA world refuses to start.
"""

import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import jax
import jax.numpy as jnp
from ppls_tpu.parallel import mesh as RM
from ppls_tpu_torch.parallel import mesh as M

import torch_mesh_jobs as J

N = 4


@pytest.fixture(scope="module")
def port():
    case = J.seeded_case(N)
    return case, M.launch(J.primitives, N, "cpu", (case,), timeout=300)


def _ref_args(case):
    return ([jnp.asarray(c.reshape(-1)) for c in case["cols"]]
            + [jnp.asarray(case["n_valid"]),
               jnp.asarray(case["key"].reshape(-1))])


def _ref_strided(case, keyed: bool):
    def body(l, r, th, meta, nv, key):
        outs, mine, total = RM.strided_reshard(
            "d", (l, r, th, meta), nv[0], case["fills"], case["out_width"],
            sort_key=key if keyed else None)
        return (*outs, mine.astype(jnp.int32), total[None])
    f = jax.jit(RM.shard_map_compat(
        body, mesh=RM.make_mesh(N), in_specs=(P("d"),) * 6,
        out_specs=(P("d"),) * 6))
    return [np.asarray(o).reshape(N, -1) for o in f(*_ref_args(case))]


def _ref_phase(case, floor):
    def body(l, r, th, meta, nv, key):
        win, n_mine, did = RM.phase_reshard(
            "d", (l, r, th, meta), nv[0], case["fills"], case["window"],
            floor, sort_key=key)
        return (*win, n_mine[None], did[None])
    f = jax.jit(RM.shard_map_compat(
        body, mesh=RM.make_mesh(N), in_specs=(P("d"),) * 6,
        out_specs=(P("d"),) * 6))
    return [np.asarray(o).reshape(N, -1) for o in f(*_ref_args(case))]


@pytest.mark.parametrize("keyed", [False, True], ids=["plain", "keyed"])
def test_strided_reshard_matches_reference(port, keyed):
    case, out = port
    got = out["strided_keyed" if keyed else "strided_plain"]
    ref = _ref_strided(case, keyed)
    for j in range(4):
        np.testing.assert_array_equal(got["cols"][j], ref[j])
        assert got["cols"][j].dtype == ref[j].dtype
    np.testing.assert_array_equal(got["mine"], ref[4])
    assert got["total"] == int(ref[5][0, 0]) == int(case["n_valid"].sum())
    np.testing.assert_array_equal(got["header"][:, 0], case["n_valid"])
    # a deal: one header gather, one data gather, one rank read
    assert got["calls"] == {"sum": 0, "gather": 2, "rank": 1}


@pytest.mark.parametrize("which", [0, 1], ids=["taken", "skipped"])
def test_phase_reshard_matches_reference(port, which):
    case, out = port
    floor = case["floors"][which]
    got = out[f"phase_{floor}"]
    ref = _ref_phase(case, floor)
    for j in range(4):
        np.testing.assert_array_equal(got["cols"][j], ref[j])
    np.testing.assert_array_equal(got["n_mine"], ref[4][:, 0])
    assert got["did"] == bool(ref[5][0, 0]) == (which == 0)
    assert got["calls"] == ({"sum": 0, "gather": 2, "rank": 1} if which == 0
                            else {"sum": 0, "gather": 1, "rank": 0})


@pytest.mark.parametrize("n_new", [1, 2, 3, 6])
@pytest.mark.parametrize("keyed", [False, True], ids=["plain", "keyed"])
def test_host_strided_redeal_matches_reference(n_new, keyed):
    case = J.seeded_case(N, seed=11)
    cols = dict(zip(("l", "r", "th", "meta"), case["cols"]))
    fills = dict(zip(("l", "r", "th", "meta"), case["fills"]))
    key = case["key"] if keyed else None
    got, got_n = M.host_strided_redeal(cols, case["n_valid"], n_new, fills,
                                       sort_key=key)
    ref, ref_n = RM.host_strided_redeal(cols, case["n_valid"], n_new, fills,
                                        sort_key=key)
    np.testing.assert_array_equal(got_n, ref_n)
    assert got_n.dtype == ref_n.dtype
    for k in cols:
        np.testing.assert_array_equal(got[k], ref[k])
        assert got[k].dtype == ref[k].dtype


@pytest.mark.parametrize("dtype", ["float64", "int32"])
def test_device_store_matches_reference(dtype):
    rng = np.random.default_rng(3)
    block = rng.integers(-50, 50, (N, 5)).astype(dtype)
    ref = np.asarray(RM.device_store(N, 12, 7, block, jnp.dtype(dtype)))
    for r in range(N):
        got = M.device_store(12, 7, block[r], getattr(torch, dtype), "cpu")
        np.testing.assert_array_equal(got.numpy(), ref[r])


def test_launch_raises_a_rank_exception():
    with pytest.raises(ValueError, match="rank 1 refuses"):
        M.launch(J.fail_on, 2, "cpu", (1,), timeout=120)


def test_launch_fails_a_hang_at_its_time_limit():
    with pytest.raises(TimeoutError, match="of 2 did not finish within 8 s"):
        M.launch(J.hang_on, 2, "cpu", (1,), timeout=8)


def test_a_world_without_its_device_refuses(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        M.launch(J.fail_on, 2, "cuda", (0,), timeout=30)
    with pytest.raises(RuntimeError, match="initialized process group"):
        M.make_mesh(2, "cpu")
