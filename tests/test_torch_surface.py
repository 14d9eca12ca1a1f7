"""The last of the reference's public surface on the port, against the
JAX package on the CPU:

* ``register_family_exact`` / ``family_exact(prefer_vec=)``: a user
  family registered in both packages routes every batch to the same
  form and gives the same values, bit for bit.
* ``initial_bag(dtype=)``: the seeded columns and accumulator at the
  requested dtype, equal to the reference's.
* ``integrate_qmc(mesh=)``: on a mesh the caller holds inside a rank (a
  world of 2 from ``mesh.launch``), within 1e-12 relative of the
  reference's mesh of 2 (tests/test_torch_qmc.py's contract), and
  spawning nothing.
* ``PPLS_EXACT_SEGSUM``: every rank of a spawned world reads it, and it
  reaches the walker's credit (every family sum through
  ``exact_segment_sum``), with the schedule unchanged.
* ``derive_kernel_evals``: the reference's counts on every branch.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppls_tpu.config import Rule as RRule
from ppls_tpu.models import genz as RG
from ppls_tpu.models import integrands as RI
from ppls_tpu.parallel import bag_engine as RB
from ppls_tpu.parallel import qmc as RQ
from ppls_tpu.parallel import walker as RW
from ppls_tpu.parallel.mesh import make_mesh
from ppls_tpu_torch.config import Rule
from ppls_tpu_torch.models import genz as TG
from ppls_tpu_torch.models import integrands as TI
from ppls_tpu_torch.ops import reduction as TR
from ppls_tpu_torch.parallel import bag_engine as TB
from ppls_tpu_torch.parallel import qmc as TQ
from ppls_tpu_torch.parallel import walker as TW
from ppls_tpu_torch.parallel.mesh import launch, run_calls

import torch_mesh_jobs as J

QMC_N = 1 << 16
EST_REL = 1e-12


# ---------------------------------------------------------------------------
# registered exact forms
# ---------------------------------------------------------------------------

def _cubic(a, b, th):
    """exact(a, b, theta) of theta * x^3: one float per theta."""
    return th * (b ** 4 - a ** 4) / 4.0


def _cubic_vec(a, b, th):
    """The vectorised form, rounded differently on purpose (its own
    order of operations), so the route shows in the bits."""
    th = np.asarray(th, dtype=np.float64)
    return th * 0.25 * (np.float64(b) ** 4 - np.float64(a) ** 4)


@pytest.fixture
def user_families():
    """Register three user families in both packages: both forms, the
    per-theta form alone, the vectorised form alone."""
    forms = {"user_cubic_both": (_cubic, _cubic_vec),
             "user_cubic_scalar": (_cubic, None),
             "user_cubic_vec": (_cubic_vec, _cubic_vec)}
    for name, (fn, vec) in forms.items():
        for mod in (RI, TI):
            mod.register_family_exact(name, fn, vec)
    TI.FAMILY_EXACT.pop("user_cubic_vec")   # vectorised form alone
    RI.FAMILY_EXACT.pop("user_cubic_vec")
    yield sorted(forms)
    for mod in (RI, TI):
        for name in forms:
            mod.FAMILY_EXACT.pop(name, None)
            mod.FAMILY_EXACT_VEC.pop(name, None)


@pytest.mark.parametrize("size,prefer_vec", [(5, None), (64, None),
                                             (5, True), (80, False)])
def test_family_exact_routes_as_the_reference(user_families, size,
                                              prefer_vec):
    th = np.random.default_rng(size).uniform(0.1, 3.0, size)
    th = th.reshape(-1, 1) if size == 80 else th
    for name in user_families:
        got = TI.family_exact(name, 0.1, 1.7, th, prefer_vec=prefer_vec)
        ref = RI.family_exact(name, 0.1, 1.7, th, prefer_vec=prefer_vec)
        assert got.dtype == np.float64 and got.shape == th.shape
        assert np.array_equal(got, ref), (name, size, prefer_vec)
    # the route: the vectorised form for >= 64 thetas or prefer_vec
    vec = prefer_vec if prefer_vec is not None else size >= 64
    want = (_cubic_vec if vec else np.vectorize(_cubic))(0.1, 1.7, th)
    assert np.array_equal(
        TI.family_exact("user_cubic_both", 0.1, 1.7, th,
                        prefer_vec=prefer_vec), want)


def test_family_exact_unknown_and_registration_return():
    assert TI.family_exact("no_such_family", 0.0, 1.0, [1.0]) is None
    assert RI.family_exact("no_such_family", 0.0, 1.0, [1.0]) is None
    try:
        assert TI.register_family_exact("user_tmp", _cubic) is _cubic
        assert "user_tmp" not in TI.FAMILY_EXACT_VEC
    finally:
        TI.FAMILY_EXACT.pop("user_tmp", None)


# ---------------------------------------------------------------------------
# initial_bag(dtype=)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_initial_bag_dtype_matches_reference(dtype):
    rng = np.random.default_rng(3)
    m = 7
    lo = rng.uniform(0.0, 1.0, m)
    bounds = np.stack([lo, lo + rng.uniform(0.5, 2.0, m)], axis=1)
    theta = rng.uniform(1.0, 2.0, m)
    got = TB.initial_bag(bounds, 64, m, 16, theta=theta,
                         dtype=getattr(torch, dtype), device="cpu")
    ref = RB.initial_bag(bounds, 64, m, 16, theta=theta,
                         dtype=getattr(jnp, dtype))
    for col in ("bag_l", "bag_r", "bag_th", "bag_meta", "acc"):
        g = getattr(got, col).numpy()
        r = np.asarray(getattr(ref, col))
        assert g.dtype == r.dtype, col
        assert np.array_equal(g, r), col
    assert got.count == int(ref.count) == m


# ---------------------------------------------------------------------------
# a world of 2: integrate_qmc(mesh=), the knob on every rank
# ---------------------------------------------------------------------------

QMC_FAMILIES = ("gaussian", "oscillatory")


@pytest.fixture(scope="module")
def world_runs():
    """One spawned world of 2 with PPLS_EXACT_SEGSUM=1 in its
    environment: integrate_qmc on each rank's own mesh, then the knob's
    reading and effect on every rank."""
    calls = [(J.qmc_on_mesh, (name, QMC_N), {}) for name in QMC_FAMILIES]
    calls.append((J.segsum_knob_on_every_rank, (), {}))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PPLS_EXACT_SEGSUM", "1")
        outs = launch(run_calls, 2, "cpu", (calls,), timeout=600)
    return dict(zip(QMC_FAMILIES, outs)), outs[-1]


@pytest.mark.parametrize("name", QMC_FAMILIES)
def test_integrate_qmc_on_a_callers_mesh(name, world_runs):
    got = world_runs[0][name]
    assert not isinstance(got, Exception), got
    a, u = RG.genz_params(name, 8, seed=0)
    ref = RQ.integrate_qmc(RG.get_genz(name).fn, a, u, n_points=QMC_N,
                           mesh=make_mesh(2), fn_name=name)
    rel = np.abs(got.estimates - ref.estimates) / np.abs(ref.estimates)
    assert np.max(rel) <= EST_REL, rel
    assert got.metrics.n_chips == ref.metrics.n_chips == 2
    assert got.metrics.tasks_per_chip == ref.metrics.tasks_per_chip
    one = TQ.integrate_qmc(TG.get_genz(name).fn, a, u, n_points=QMC_N,
                           device="cpu")
    assert abs(got.value - one.value) <= EST_REL * abs(one.value)


def test_every_rank_of_a_spawned_world_reads_the_knob(world_runs):
    rows = world_runs[1]
    assert not isinstance(rows, Exception), rows
    assert rows.tolist() == [[1, 1], [1, 1]]


# ---------------------------------------------------------------------------
# the knob reaches the walker's credit
# ---------------------------------------------------------------------------

def test_exact_segsum_knob_reaches_the_walker(monkeypatch):
    """PPLS_EXACT_SEGSUM=1 sends the walker's per-family credit (m = 4:
    the mask tier) through exact_segment_sum; unset, it never runs. The
    schedule is the same; the areas move by float64 rounding only."""
    calls = []
    orig = TR.exact_segment_sum

    def counting(*a, **k):
        calls.append(a[2])
        return orig(*a, **k)
    monkeypatch.setattr(TR, "exact_segment_sum", counting)
    f, fd = TI.get_family("sin_recip_scaled"), \
        TI.get_family_ds("sin_recip_scaled")
    kw = dict(lanes=256, roots_per_lane=1, seg_iters=32,
              min_active_frac=0.05, capacity=1 << 16, device="cpu")
    theta = 1.0 + np.arange(4) / 4
    runs = {}
    for knob in ("0", "1"):
        monkeypatch.setenv("PPLS_EXACT_SEGSUM", knob)
        calls.clear()
        runs[knob] = (TW.integrate_family_walker(
            f, fd, theta, (1e-2, 1.0), 1e-7, **kw), list(calls))
    (off, off_calls), (on, on_calls) = runs["0"], runs["1"]
    assert off_calls == [] and on_calls and set(on_calls) == {4}
    assert on.metrics.tasks == off.metrics.tasks
    assert on.kernel_steps == off.kernel_steps and on.cycles == off.cycles
    assert np.max(np.abs(on.areas - off.areas)
                  / np.abs(off.areas)) <= 1e-15


# ---------------------------------------------------------------------------
# derive_kernel_evals
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("args", [
    (1000, 2000, 50, 700, 300, 40, "trapezoid", 0),    # scout counters
    (0, 0, 5000, 700, 300, 40, "trapezoid", 0),        # eval_active
    (0, 0, 5000, 700, 300, 40, "simpson", 123),        # + a legacy share
    (0, 0, 0, 700, 300, 40, "trapezoid", 0),           # host model
    (0, 0, 0, 700, 300, 40, "simpson", 0),
    (0, 0, 0, 0, 0, 0, "trapezoid", 0),                # nothing walked
])
def test_derive_kernel_evals_matches_reference(args):
    *counts, rule, est = args
    got = TW.derive_kernel_evals(*counts, Rule(rule), est_kevals=est)
    ref = RW.derive_kernel_evals(*counts, RRule(rule), est_kevals=est)
    assert got == tuple(ref)


# ---------------------------------------------------------------------------
# the public surface, module by module
# ---------------------------------------------------------------------------

# The reference's public names the port leaves out by design (ROADMAP
# Queue 1 "No copy, by design" says why for each), by module.
LEFT_OUT = {
    "utils/compile_cache.py": None,              # the whole module
    "parallel/walker.py": {"make_walk_kernel", "deep_trace_probes"},
    "parallel/mesh.py": {"FRONTIER_AXIS", "shard_map_compat"},
    "parallel/sharded.py": {"build_sharded_run"},
    "parallel/sharded_bag.py": {"build_sharded_family_run"},
    "parallel/sharded_walker.py": {"deep_trace_probes"},
    "parallel/bag_engine.py": {"deep_trace_probes"},
    "parallel/device_engine.py": {"deep_trace_probes"},
    "runtime/stream.py": {"deep_trace_probes"},
    "runtime/cluster.py": {"deep_trace_probes"},
    "ops/ds_kernel.py": {"ds", "ds_f64ish"},
    "ops/scout_kernel.py": {"ds", "ds_f64ish", "DS"},
}
# JAX idiom in the reference's signatures: Pallas interpret mode, the
# shard_map axis, all ranks' rows built at once
LEFT_OUT_ARGS = {"interpret", "axis_name", "axis", "n_dev"}


def _public(path):
    """Top-level public names of a reference module: name -> parameter
    names (functions), method -> parameter names (classes) or None."""
    import ast
    out = {}
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.FunctionDef):
            a = node.args
            out[node.name] = [x.arg for x in a.posonlyargs + a.args
                              + a.kwonlyargs]
        elif isinstance(node, ast.ClassDef):
            out[node.name] = {
                b.name: [x.arg for x in b.args.args + b.args.kwonlyargs]
                for b in node.body if isinstance(b, ast.FunctionDef)
                and (b.name == "__init__" or not b.name.startswith("_"))}
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            for t in (node.targets if isinstance(node, ast.Assign)
                      else [node.target]):
                if isinstance(t, ast.Name):
                    out[t.id] = None
    return {k: v for k, v in out.items() if not k.startswith("_")}


def _accepts(obj, names):
    """The reference parameter names ``obj`` does not accept."""
    import inspect
    try:
        params = inspect.signature(obj, follow_wrapped=False).parameters
    except (TypeError, ValueError):
        return []
    if any(p.kind == p.VAR_KEYWORD for p in params.values()):
        return []          # an spmd_entry wrapper: the body's and its own
    return [n for n in names if n not in params
            and n not in ("self", "cls") and n not in LEFT_OUT_ARGS]


def test_every_public_name_of_the_reference_has_a_counterpart():
    """Every public top-level name (and every parameter of a public
    function or method) of every ppls_tpu module exists in the port's
    module of the same path, but those LEFT_OUT lists by design."""
    import importlib
    from pathlib import Path
    root = Path(__file__).resolve().parent.parent / "ppls_tpu"
    missing = []
    for path in sorted(root.rglob("*.py")):
        rel = path.relative_to(root).as_posix()
        skip = LEFT_OUT.get(rel, set())
        if skip is None:
            continue
        mod = importlib.import_module(
            "ppls_tpu_torch." + rel[:-3].replace("/", ".")
            .replace(".__init__", "") if rel != "__init__.py"
            else "ppls_tpu_torch")
        for name, sig in _public(path).items():
            if name in skip:
                continue
            if not hasattr(mod, name):
                missing.append(f"{rel}: {name}")
                continue
            obj = getattr(mod, name)
            if isinstance(sig, list):
                missing += [f"{rel}: {name}({a})" for a in _accepts(obj, sig)]
            elif isinstance(sig, dict):
                for meth, args in sig.items():
                    if not hasattr(obj, meth):
                        missing.append(f"{rel}: {name}.{meth}")
                    else:
                        missing += [f"{rel}: {name}.{meth}({a})" for a in
                                    _accepts(getattr(obj, meth), args)]
    assert missing == []
