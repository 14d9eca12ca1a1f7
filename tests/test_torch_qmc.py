"""The port's shifted-lattice QMC (``models/genz.py``, ``parallel/qmc.py``
and ``python -m ppls_tpu_torch qmc``) against the reference's, on the
CPU: on one device against a mesh of one, and on 2 ranks (one spawned
gloo world for every call) against a mesh of 2 host devices.

Contract: the parameter draws, closed forms and lattice points are
equal; each shift's estimate is within 1e-12 relative (the reference
sums with XLA's dot and reduction, the port with torch's), on one
device and across ranks, and the estimate does not depend on the world
size (tests/test_qmc.py:39); ``qmc --n-devices`` equals the in-process
call; the refusals keep the reference's wording.
"""

import contextlib
import io
import json
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppls_tpu import __main__ as RCLI
from ppls_tpu.models import genz as RG
from ppls_tpu.parallel import qmc as RQ
from ppls_tpu.parallel.mesh import make_mesh
from ppls_tpu_torch import __main__ as CLI
from ppls_tpu_torch.models import genz as TG
from ppls_tpu_torch.parallel import qmc as TQ
from ppls_tpu_torch.parallel.mesh import launch, run_calls

import torch_mesh_jobs as J

N = 1 << 16
D = 8
EST_REL = 1e-12
ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def runs():
    """The six families once through both packages: {name: (port,
    reference)}."""
    out = {}
    for name in sorted(RG.GENZ):
        a, u = RG.genz_params(name, D, seed=0)
        got = TQ.integrate_qmc(TG.get_genz(name).fn, a, u, n_points=N,
                               device="cpu")
        ref = RQ.integrate_qmc(RG.get_genz(name).fn, a, u, n_points=N,
                               mesh=make_mesh(1), fn_name=name)
        out[name] = (got, ref)
    return out


@pytest.mark.parametrize("name", sorted(RG.GENZ))
def test_integrate_qmc_matches_reference(name, runs):
    got, ref = runs[name]
    assert got.estimates.shape == ref.estimates.shape == (8,)
    rel = np.abs(got.estimates - ref.estimates) / np.abs(ref.estimates)
    assert np.max(rel) <= EST_REL, rel
    assert abs(got.value - ref.value) <= EST_REL * abs(ref.value)
    assert got.std_error == pytest.approx(ref.std_error, rel=1e-6)
    assert got.metrics.integrand_evals == ref.metrics.integrand_evals
    assert got.metrics.n_chips == 1


@pytest.mark.parametrize("name", sorted(RG.GENZ))
def test_genz_params_and_exact_match_reference(name):
    for d, seed in ((8, 0), (5, 3)):
        a, u = TG.genz_params(name, d, seed=seed)
        ra, ru = RG.genz_params(name, d, seed=seed)
        assert np.array_equal(a, ra) and np.array_equal(u, ru)
        assert TG.get_genz(name).exact(a, u) == RG.get_genz(name).exact(a, u)
        assert TG.get_genz(name).difficulty_sum == \
            RG.get_genz(name).difficulty_sum


@pytest.mark.parametrize("n", sorted(TQ.KOROBOV_A))
def test_lattice_block_equals_reference(n):
    assert TQ.KOROBOV_A == RQ.KOROBOV_A
    shift = np.random.default_rng(17).random(D)
    start, count = n - 1000, 1000           # the block's top, k < N
    got = TQ.lattice_block(n, TQ.KOROBOV_A[n], start, count, D,
                           torch.tensor(shift)).numpy()
    ref = np.asarray(RQ.lattice_block(n, RQ.KOROBOV_A[n], jnp.int64(start),
                                      count, D, jnp.asarray(shift)))
    assert np.array_equal(got, ref)
    assert np.all((got >= 0.0) & (got < 1.0))


def test_refusals():
    a, u = TG.genz_params("gaussian", D)
    fn = TG.get_genz("gaussian").fn
    with pytest.raises(ValueError, match="n_points must be one of"):
        TQ.integrate_qmc(fn, a, u, n_points=1000, device="cpu")
    with pytest.raises(ValueError, match="not divisible by mesh size 3"):
        TQ.integrate_qmc(fn, a, u, n_points=N, n_devices=3, device="cpu")
    with pytest.raises(ValueError, match="not a registered Genz family"):
        TQ.integrate_qmc(lambda x, a, u: x[:, 0], a, u, n_points=N,
                         n_devices=2, device="cpu")
    with pytest.raises(KeyError, match="unknown Genz family"):
        TG.get_genz("nope")
    r = TQ.integrate_qmc(fn, a, u, n_points=N, n_devices=1, n_shifts=1,
                         device="cpu")
    assert r.std_error == 0.0 and r.estimates.shape == (1,)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TQ.integrate_qmc(fn, a, u, n_points=N)


def test_first_cpu_call_in_a_process_is_exact():
    """torch's CPU exp can return values ~3.3e-9 off (relative) on the
    chunk a worker thread computes in its first call; the port's CPU
    entry points make that first call themselves (utils.device), so a
    fresh process's first estimate equals its second."""
    code = (
        "import numpy as np\n"
        "from ppls_tpu_torch.models import genz as G\n"
        "from ppls_tpu_torch.parallel.qmc import integrate_qmc\n"
        "a, u = G.genz_params('continuous', 8, seed=0)\n"
        "f = G.get_genz('continuous').fn\n"
        "r1 = integrate_qmc(f, a, u, n_points=1 << 16, device='cpu')\n"
        "r2 = integrate_qmc(f, a, u, n_points=1 << 16, device='cpu')\n"
        "print(np.array_equal(r1.estimates, r2.estimates))\n")
    for _ in range(2):
        out = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                             capture_output=True, text=True, timeout=120,
                             check=True)
        assert out.stdout.strip() == "True"


def _run(cli, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    return rc, buf.getvalue()


def test_cli_qmc_matches_reference():
    argv = ["qmc", "--json", "--n", "65536", "--genz", "gaussian"]
    rc, out = _run(CLI, argv + ["--device", "cpu"])
    rrc, rout = _run(RCLI, argv)
    assert rc == rrc == 0
    got = json.loads(out.strip().splitlines()[-1])
    ref = json.loads(rout.strip().splitlines()[-1])
    assert set(got) == set(ref)
    for k in ("n_points", "shifts", "dim"):
        assert got[k] == ref[k]
    g, r = got["families"]["gaussian"], ref["families"]["gaussian"]
    assert set(g) == set(r)
    assert g["exact"] == r["exact"]
    assert abs(g["value"] - r["value"]) <= EST_REL * abs(r["value"])
    assert abs(g["rel_error"] - r["rel_error"]) <= EST_REL * abs(
        r["value"] / r["exact"])
    assert g["std_error"] == pytest.approx(r["std_error"], rel=1e-6)


def test_cli_qmc_table(capsys):
    assert CLI.main(["qmc", "--device", "cpu", "--n", "65536",
                     "--shifts", "2"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "Genz 8D via shifted lattice: N=65536, 2 shifts"
    assert [ln.split()[0] for ln in lines[1:]] == sorted(TG.GENZ)


# ---------------------------------------------------------------------------
# the lattice across ranks
# ---------------------------------------------------------------------------

QN = 2
CLI_QMC = {"gaussian": ["qmc", "--json", "--n", "65536", "--genz",
                        "gaussian"],
           "all": ["qmc", "--n", "65536", "--shifts", "2"]}


@pytest.fixture(scope="module")
def across():
    """The six families and the two commands on 2 ranks, one world."""
    calls = []
    for name in sorted(RG.GENZ):
        a, u = TG.genz_params(name, D, seed=0)
        calls.append((TQ.integrate_qmc, (TG.get_genz(name).fn, a, u),
                      dict(n_points=N, n_devices=QN, device="cpu")))
    for argv in CLI_QMC.values():
        calls.append((J.cli_output, (argv + ["--n-devices", str(QN),
                                             "--device", "cpu"],), {}))
    outs = launch(run_calls, QN, "cpu", (calls,), timeout=600)
    names = sorted(RG.GENZ)
    return dict(zip(names, outs)), dict(zip(CLI_QMC, outs[len(names):]))


@pytest.mark.parametrize("name", sorted(RG.GENZ))
def test_integrate_qmc_across_devices_matches_reference(name, across,
                                                        runs):
    got = across[0][name]
    a, u = RG.genz_params(name, D, seed=0)
    ref = RQ.integrate_qmc(RG.get_genz(name).fn, a, u, n_points=N,
                           mesh=make_mesh(QN), fn_name=name)
    rel = np.abs(got.estimates - ref.estimates) / np.abs(ref.estimates)
    assert np.max(rel) <= EST_REL, rel
    assert got.metrics.n_chips == ref.metrics.n_chips == QN
    assert got.metrics.tasks_per_chip == ref.metrics.tasks_per_chip
    # mesh-size invariance: the same lattice sum on 1 and 2 ranks
    one = runs[name][0]
    assert abs(got.value - one.value) <= EST_REL * abs(one.value)


@pytest.mark.parametrize("case", sorted(CLI_QMC))
def test_cli_qmc_across_devices(case, across):
    rc, out = across[1][case]
    assert rc == 0
    if case == "gaussian":
        rec = json.loads(out.strip().splitlines()[-1])
        assert rec["families"]["gaussian"]["value"] \
            == across[0]["gaussian"].value
    else:
        lines = out.splitlines()
        assert lines[0] == "Genz 8D via shifted lattice: N=65536, 2 shifts"
        assert [ln.split()[0] for ln in lines[1:]] == sorted(TG.GENZ)
