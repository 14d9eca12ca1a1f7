"""The port's 2D adaptive cubature (``ops/rules2d.py``,
``parallel/cubature.py``, the 2D integrands, ``run_seq_2d`` and
``python -m ppls_tpu_torch 2d``) against the reference's, on the CPU.

Contract:

* the rules, run op by op on the same seeded rectangles: split masks
  equal; values and errors bit-equal on every rectangle whose grid
  values the two libraries compute bit-equal, and within 1e-13 relative
  (values) on the others, whose share is bounded per integrand (the
  libraries' exp and cos differ in the last ulps);
* one ``rect_bag_step`` from the same mid-run bag (``interop``): the
  store (live prefix and dead slots), count, tasks and splits equal;
* ``integrate_2d``: tasks, splits, rounds and depth equal, areas within
  1e-12 (the reference's float64 sum order is XLA's);
* the C rectangle bag: cells and splits equal to the port's, areas
  within 1e-12;
* ``integrate_2d_sharded`` on 2 ranks (one spawned gloo world for every
  call; the reference on 2 of its host devices, at tests/test_cubature.py
  :70-144's shapes): cells, splits, rounds and ``tasks_per_chip`` equal
  to the reference's, the cells and the area (within 1e-12) to the
  one-device engine's; kill-and-resume bit-equal; a snapshot of another
  run refused; ``2d --n-devices N [--checkpoint]`` equal to the
  in-process call.
"""

import contextlib
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppls_tpu import __main__ as RCLI
from ppls_tpu.config import Rule as RRule
from ppls_tpu.models.integrands import get_integrand_2d as ref_integrand_2d
from ppls_tpu.ops import rules2d as ref_rules2d
from ppls_tpu.parallel import cubature as RC
from ppls_tpu.parallel.mesh import make_mesh
from ppls_tpu_torch import __main__ as CLI
from ppls_tpu_torch import interop
from ppls_tpu_torch.backends.mpi_backend import run_seq_2d
from ppls_tpu_torch.config import Rule
from ppls_tpu_torch.models.integrands import get_integrand_2d
from ppls_tpu_torch.ops import rules2d
from ppls_tpu_torch.parallel import cubature as TC
from ppls_tpu_torch.parallel.mesh import launch, run_calls
from ppls_tpu_torch.utils.device import HostSyncs

import torch_mesh_jobs as J

AREA_TOL = 1e-12
BOUNDS = (0.0, 1.0, 0.0, 1.0)

# tests/test_cubature.py's configurations and the C twin's
# (tests/test_bench_secondary.py): name, bounds, eps, options
CASES = {
    "cos_prod_simpson": ("cos_prod", (0.0, 1.0, 0.0, 2.0), 1e-8, {}),
    "cos_prod_trapezoid": ("cos_prod", (0.0, 1.0, 0.0, 2.0), 1e-8,
                           dict(rule="TRAPEZOID")),
    "cos_prod_trapezoid_coarse": ("cos_prod", (0.0, 1.0, 0.0, 2.0), 1e-6,
                                  dict(rule="TRAPEZOID")),
    "poly_xy": ("poly_xy", BOUNDS, 1e-9, {}),
    "gauss2d_peak": ("gauss2d_peak", BOUNDS, 1e-8,
                     dict(capacity=1 << 21)),
    "gauss2d_peak_anisotropic": ("gauss2d_peak", (0.25, 1.5, -0.5, 0.75),
                                 1e-8, dict(capacity=1 << 21)),
    "c_peak": ("gauss2d_peak", BOUNDS, 1e-8,
               dict(rule="TRAPEZOID", chunk=1 << 11, capacity=1 << 20)),
    "c_ring": ("gauss2d_ring", BOUNDS, 1e-8,
               dict(rule="TRAPEZOID", chunk=1 << 11, capacity=1 << 20)),
}


def _kw(opts, rule_cls):
    kw = dict(opts)
    if "rule" in kw:
        kw["rule"] = rule_cls[kw["rule"]]
    return kw


@pytest.fixture(scope="module")
def runs():
    """Each configuration once through both packages: {case: (port,
    reference)}."""
    out = {}
    for case, (name, bounds, eps, opts) in CASES.items():
        entry = get_integrand_2d(name)
        exact = entry.exact(*bounds)
        got = TC.integrate_2d(entry.fn, bounds, eps, exact=exact,
                              device="cpu", **_kw(opts, Rule))
        ref = RC.integrate_2d(ref_integrand_2d(name).fn, bounds, eps,
                              exact=exact, **_kw(opts, RRule))
        out[case] = (got, ref)
    return out


# ---------------------------------------------------------------------------
# the rules
# ---------------------------------------------------------------------------

def _rects(n=4096, seed=0):
    rng = np.random.default_rng(seed)
    lx, ly = rng.random(n), rng.random(n)
    rx = lx + 10.0 ** rng.uniform(-4, -0.5, n)
    ry = ly + 10.0 ** rng.uniform(-4, -0.5, n)
    return lx, rx, ly, ry


def _grid_points(lx, rx, ly, ry, rule):
    """The rule's grid coordinates, computed as the rules compute them:
    (xs, ys), each a list of (n,) arrays."""
    if rule == "TRAPEZOID":
        return [lx, 0.5 * (lx + rx), rx], [ly, 0.5 * (ly + ry), ry]
    hx, hy = 0.25 * (rx - lx), 0.25 * (ry - ly)
    return ([lx + i * hx for i in range(5)], [ly + j * hy for j in range(5)])


# grid points whose value the libraries compute apart (XLA's exp and cos
# against torch's): at most this share of the points
# (measured on these rectangles: 0 for poly_xy, under 1e-3 for cos_prod,
# 0.13 for the Gaussians)
F_DIFF_SHARE = {"poly_xy": 0.0, "cos_prod": 0.005, "gauss2d_peak": 0.2,
                "gauss2d_ring": 0.2}


@pytest.mark.parametrize("rule", ["TRAPEZOID", "SIMPSON"])
@pytest.mark.parametrize("name", sorted(F_DIFF_SHARE))
def test_rules2d_match_reference(name, rule):
    lx, rx, ly, ry = _rects()
    ent, rent = get_integrand_2d(name), ref_integrand_2d(name)
    xs, ys = _grid_points(lx, rx, ly, ry, rule)
    same_f = np.ones(lx.shape[0], dtype=bool)
    n_diff = 0
    for x in xs:
        for y in ys:
            ft = ent.fn(torch.tensor(x), torch.tensor(y)).numpy()
            fr = np.asarray(rent.fn(jnp.asarray(x), jnp.asarray(y)))
            # absolute, as the split test reads them: torch's CPU sqrt is
            # not correctly rounded (one ulp), and the ring's r - 0.3
            # amplifies that ulp ~10x near the ridge
            assert np.all(np.abs(ft - fr) <= 1e-14)
            same_f &= ft == fr
            n_diff += int(np.sum(ft != fr))
    assert n_diff <= F_DIFF_SHARE[name] * lx.size * len(xs) * len(ys)
    cols = [torch.tensor(c) for c in (lx, rx, ly, ry)]
    _, err0, _ = rules2d.eval_rect_batch(*cols, ent.fn, 0.0, Rule[rule])
    eps = float(np.median(err0.numpy()))      # about half the cells split
    tv, te, ts = (t.numpy() for t in rules2d.eval_rect_batch(
        *cols, ent.fn, eps, Rule[rule]))
    rv, re_, rs = (np.asarray(a) for a in ref_rules2d.eval_rect_batch(
        *(jnp.asarray(c) for c in (lx, rx, ly, ry)), rent.fn, eps,
        RRule[rule]))
    assert np.array_equal(ts, rs)
    assert 0 < ts.sum() < ts.size
    # bit-equal wherever the grid values are; 1e-13 relative elsewhere
    assert np.array_equal(tv[same_f], rv[same_f])
    assert np.array_equal(te[same_f], re_[same_f])
    rel = np.abs(tv - rv) / np.abs(rv)
    assert np.all(rel[~same_f] <= 1e-13)
    assert rules2d.EVALS_PER_TASK_2D[Rule[rule]] == \
        ref_rules2d.EVALS_PER_TASK_2D[RRule[rule]]


def test_div_is_correctly_rounded():
    x = torch.tensor(np.random.default_rng(1).random(1000))
    assert torch.equal(rules2d.div(x, 0.05), x / 0.05)


# ---------------------------------------------------------------------------
# one round from the same mid-run bag
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rule", ["TRAPEZOID", "SIMPSON"])
def test_rect_bag_step_from_reference_bag(rule):
    name, eps, chunk, cap = "gauss2d_ring", 1e-8, 1 << 11, 1 << 16
    if rule == "SIMPSON":
        eps = 1e-11
    seed = RC.seed_rect_state(BOUNDS, chunk, cap)
    mid = jax.device_get(RC._run_rect_bag(
        seed, f=ref_integrand_2d(name).fn, eps=eps, rule=RRule[rule],
        chunk=chunk, capacity=cap, max_iters=6))
    assert int(mid.count) > chunk          # a full chunk to pop
    ref = jax.device_get(RC.rect_bag_step(
        jax.tree_util.tree_map(jnp.asarray, mid),
        ref_integrand_2d(name).fn, eps, RRule[rule], chunk, cap))
    got = TC.rect_bag_step(interop.rect_bag_from_numpy(mid),
                           get_integrand_2d(name).fn, eps, Rule[rule],
                           chunk, cap, HostSyncs())
    got_np = interop.rect_bag_to_numpy(got)
    n = int(ref.count)
    assert got.count == n
    assert (got.tasks, got.splits, got.iters) == (
        int(ref.tasks), int(ref.splits), int(ref.iters))
    assert got.splits > int(mid.splits)
    for j in range(5):       # lx, rx, ly, ry, meta: the whole store
        assert np.array_equal(got_np[j], np.asarray(ref[j])), j
    assert int(got_np[10]) == int(ref.max_depth)
    assert abs(float(got_np[6]) - float(ref.acc)) <= 1e-15


def test_rect_bag_interop_round_trip():
    seed = jax.device_get(RC.seed_rect_state(BOUNDS, 64, 1024))
    bag = interop.rect_bag_from_numpy(seed)
    back = interop.rect_bag_to_numpy(bag)
    for a, b in zip(back, seed):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    assert bag.lx.data_ptr() != bag.rx.data_ptr()
    with pytest.raises(ValueError, match="fields"):
        interop.rect_bag_from_numpy(tuple(seed)[:5])


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", sorted(CASES))
def test_integrate_2d_matches_reference(case, runs):
    got, ref = runs[case]
    g, r = got.metrics, ref.metrics
    assert (g.tasks, g.splits, g.rounds, g.max_depth) == (
        r.tasks, r.splits, r.rounds, r.max_depth)
    assert g.leaves == g.tasks - g.splits
    assert g.integrand_evals == r.integrand_evals
    assert abs(got.area - ref.area) <= AREA_TOL
    assert got.exact == ref.exact
    # one read per round and one at the end
    assert got.host_syncs == g.rounds + 1


@pytest.mark.parametrize("case", ["c_peak", "c_ring"])
def test_c_twin_matches_port(case, runs):
    name, bounds, eps, _ = CASES[case]
    got, _ = runs[case]
    c = run_seq_2d(name, *bounds, eps)
    assert got.metrics.tasks == c["tasks"]
    assert got.metrics.splits == c["splits"]
    assert got.metrics.max_depth == c["max_depth"]
    assert abs(got.area - c["area"]) <= AREA_TOL
    assert c["evals"] == 9 * c["tasks"]


def test_overflow_raises_in_both():
    kw = dict(chunk=64, capacity=128)
    with pytest.raises(RuntimeError, match="overflowed capacity=128"):
        TC.integrate_2d(get_integrand_2d("gauss2d_peak").fn, BOUNDS, 1e-12,
                        rule=Rule.TRAPEZOID, device="cpu", **kw)
    with pytest.raises(RuntimeError, match="overflowed capacity=128"):
        RC.integrate_2d(ref_integrand_2d("gauss2d_peak").fn, BOUNDS, 1e-12,
                        rule=RRule.TRAPEZOID, **kw)


def test_max_iters_and_non_finite():
    f = get_integrand_2d("gauss2d_peak").fn
    with pytest.raises(RuntimeError, match="max_iters=2 exceeded"):
        TC.integrate_2d(f, BOUNDS, 1e-10, max_iters=2, device="cpu")
    with pytest.raises(FloatingPointError, match="non-finite"):
        TC.integrate_2d(lambda x, y: x / (x - x), BOUNDS, 1e-6,
                        device="cpu")
    with pytest.raises(ValueError, match="exceeds capacity"):
        TC.integrate_2d(f, BOUNDS, 1e-6, chunk=256, capacity=128,
                        device="cpu")


def test_pipelined_dispatch_equals_fresh_runs(runs):
    """One seed shared by two dispatches, collected in order: each equal
    to a fresh run (the seed is not consumed), the second's wall spanning
    both."""
    name, bounds, eps, opts = CASES["c_ring"]
    f = get_integrand_2d(name).fn
    kw = _kw(opts, Rule)
    seed = TC.seed_rect_state(bounds, kw["chunk"], kw["capacity"],
                              device="cpu")
    ds = [TC.dispatch_2d(f, bounds, eps, device="cpu", _state_override=seed,
                         **kw) for _ in range(2)]
    rs = [TC.collect_2d(d) for d in ds]
    fresh = runs["c_ring"][0]
    for r in rs:
        assert r.area == fresh.area
        assert r.metrics.tasks == fresh.metrics.tasks
        assert r.metrics.rounds == fresh.metrics.rounds
    assert rs[1].metrics.wall_time_s >= rs[0].metrics.wall_time_s
    assert seed.count == 1 and float(seed.acc) == 0.0


def test_integrands_2d_exact_and_registry():
    for name in ("gauss2d_peak", "gauss2d_ring", "cos_prod", "poly_xy"):
        got, ref = get_integrand_2d(name), ref_integrand_2d(name)
        assert got.exact(*BOUNDS) == ref.exact(*BOUNDS)
    with pytest.raises(ValueError, match="standard"):
        get_integrand_2d("gauss2d_ring").exact(0.0, 2.0, 0.0, 2.0)
    with pytest.raises(KeyError, match="unknown 2D integrand"):
        get_integrand_2d("nope")


def test_entry_points_need_a_card_or_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA default runs")
    f = get_integrand_2d("poly_xy").fn
    for call in (lambda: TC.integrate_2d(f, BOUNDS, 1e-6),
                 lambda: TC.dispatch_2d(f, BOUNDS, 1e-6),
                 lambda: TC.seed_rect_state(BOUNDS)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


# ---------------------------------------------------------------------------
# python -m ppls_tpu_torch 2d
# ---------------------------------------------------------------------------

def _run(cli, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    return rc, buf.getvalue()


@pytest.mark.parametrize("argv", [["2d", "--json"],
                                  ["2d", "--json", "--rule", "trapezoid",
                                   "--eps", "1e-7", "--integrand",
                                   "gauss2d_ring", "--chunk", "2048"]])
def test_cli_2d_matches_reference(argv):
    rc, out = _run(CLI, argv + ["--device", "cpu"])
    rrc, rout = _run(RCLI, argv)
    assert rc == rrc == 0
    got = json.loads(out.strip().splitlines()[-1])
    ref = json.loads(rout.strip().splitlines()[-1])
    assert set(got) == set(ref)
    for k in ref:
        if k in ("area", "global_error"):
            assert abs(got[k] - ref[k]) <= AREA_TOL, k
        elif k != "wall_time_s":
            assert got[k] == ref[k], k


def test_cli_2d_table(capsys):
    assert CLI.main(["2d", "--device", "cpu", "--integrand", "poly_xy"]) == 0
    out = capsys.readouterr().out
    assert out.startswith("Area=0.333333333333  (simpson, eps=1e-08)")
    assert "Cells: 1 (0 splits) in 1 rounds, depth 0" in out


REFUSED_2D = {
    "checkpoint": (["2d", "--checkpoint", "x.ckpt"],
                   "--checkpoint on the 2d mode requires --n-devices"),
}


@pytest.mark.parametrize("name", sorted(REFUSED_2D))
def test_cli_2d_refusals(name, capsys):
    argv, what = REFUSED_2D[name]
    with pytest.raises(SystemExit) as ei:
        CLI.main(argv + ["--device", "cpu"])
    assert what in str(ei.value.code)
    assert capsys.readouterr().out == ""


def test_device_busy_counts_each_kernel_once():
    """A profile's ``key_averages()`` lists a kernel under its own name
    and again in the self device time of the CPU op that launched it:
    the busy time counts the device entries only."""
    from types import SimpleNamespace

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from ppls_tpu_torch.utils.tracing import device_busy_us, device_self_us
    events = [SimpleNamespace(key="aten::add", device_type=DeviceType.CPU,
                              self_device_time_total=30.0),
              SimpleNamespace(key="add_kernel", device_type=DeviceType.CUDA,
                              self_device_time_total=30.0),
              SimpleNamespace(key="Memcpy DtoD", device_type=DeviceType.CUDA,
                              self_device_time_total=5.0)]
    assert device_busy_us(events) == 35.0
    assert sum(device_self_us(e) for e in events) == 65.0
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        TC.integrate_2d(get_integrand_2d("poly_xy").fn, BOUNDS, 1e-9,
                        device="cpu")
    assert device_busy_us(prof.key_averages()) == 0.0


# ---------------------------------------------------------------------------
# the rectangle bag across ranks (tests/test_cubature.py:70-144)
# ---------------------------------------------------------------------------

SH_N = 2
SH_KW = dict(chunk=1 << 8, capacity=1 << 15)
SH_CONSERVE_EPS = 1e-9
SH_RESUME_EPS = 1e-7
CLI_2D = ["2d", "--json", "--rule", "trapezoid", "--eps", "1e-7",
          "--chunk", "256", "--capacity", "32768"]


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    """Every port call across ranks in one spawned world of 2."""
    d = tmp_path_factory.mktemp("sharded_2d")
    paths = {k: str(d / f"{k}.ckpt") for k in ("resume", "ident", "cli")}
    f = get_integrand_2d("gauss2d_peak").fn
    kw = dict(SH_KW, rule=Rule.TRAPEZOID, n_devices=SH_N, device="cpu")
    crash = dict(kw, checkpoint_every=3, _crash_after_legs=2)
    calls = {
        "conserve": (TC.integrate_2d_sharded, (f, BOUNDS, SH_CONSERVE_EPS),
                     dict(kw, exact=get_integrand_2d(
                         "gauss2d_peak").exact(*BOUNDS))),
        "base": (TC.integrate_2d_sharded, (f, BOUNDS, SH_RESUME_EPS), kw),
        "crash": (TC.integrate_2d_sharded, (f, BOUNDS, SH_RESUME_EPS),
                  dict(crash, checkpoint_path=paths["resume"])),
        "resume": (TC.resume_2d_sharded,
                   (paths["resume"], f, BOUNDS, SH_RESUME_EPS),
                   dict(kw, checkpoint_every=3)),
        "crash_ident": (TC.integrate_2d_sharded,
                        (f, BOUNDS, SH_RESUME_EPS),
                        dict(crash, checkpoint_every=2, _crash_after_legs=1,
                             checkpoint_path=paths["ident"])),
        "wrong_eps": (TC.resume_2d_sharded,
                      (paths["ident"], f, BOUNDS, 1e-8), kw),
        "cli": (J.cli_output, (CLI_2D + ["--n-devices", "2", "--checkpoint",
                                         paths["cli"], "--device", "cpu"],),
                {}),
    }
    outs = launch(run_calls, SH_N, "cpu", (list(calls.values()),),
                  timeout=600)
    return dict(zip(calls, outs)), paths


@pytest.fixture(scope="module")
def sharded_ref():
    entry = ref_integrand_2d("gauss2d_peak")
    kw = dict(SH_KW, rule=RRule.TRAPEZOID, mesh=make_mesh(SH_N))
    return {eps: RC.integrate_2d_sharded(entry.fn, BOUNDS, eps, **kw)
            for eps in (SH_CONSERVE_EPS, SH_RESUME_EPS)}


@pytest.mark.parametrize("tag,eps", [("conserve", SH_CONSERVE_EPS),
                                     ("base", SH_RESUME_EPS)])
def test_sharded_2d_matches_reference_and_conserves(sharded, sharded_ref,
                                                    tag, eps):
    s, ref = sharded[0][tag], sharded_ref[eps]
    for k in ("tasks", "splits", "leaves", "rounds", "max_depth",
              "integrand_evals", "n_chips", "tasks_per_chip"):
        assert getattr(s.metrics, k) == getattr(ref.metrics, k), k
    assert abs(s.area - ref.area) <= AREA_TOL
    b = TC.integrate_2d(get_integrand_2d("gauss2d_peak").fn, BOUNDS, eps,
                        rule=Rule.TRAPEZOID, chunk=1 << 10,
                        capacity=1 << 17, device="cpu")
    assert s.metrics.tasks == b.metrics.tasks
    assert s.metrics.splits == b.metrics.splits
    assert abs(s.area - b.area) < AREA_TOL
    assert sum(s.metrics.tasks_per_chip) == s.metrics.tasks
    assert min(s.metrics.tasks_per_chip) > 0
    # one deal per round: the rank read counts the rounds
    assert s.mesh["collective_calls"]["rank"] == s.metrics.rounds
    assert s.mesh["world"] == SH_N


def test_sharded_2d_kill_and_resume_bit_identical(sharded):
    outs, paths = sharded
    assert isinstance(outs["crash"], RuntimeError)
    assert "simulated crash after 2 legs" in str(outs["crash"])
    res, base = outs["resume"], outs["base"]
    assert res.area == base.area                          # bit for bit
    assert res.metrics.tasks == base.metrics.tasks
    assert res.metrics.tasks_per_chip == base.metrics.tasks_per_chip
    assert res.metrics.rounds == base.metrics.rounds
    import os
    assert not os.path.exists(paths["resume"])


def test_sharded_2d_resume_rejects_mismatched_identity(sharded):
    outs, _ = sharded
    assert isinstance(outs["crash_ident"], RuntimeError)
    assert isinstance(outs["wrong_eps"], ValueError)
    assert "different run" in str(outs["wrong_eps"])


def test_sharded_2d_needs_a_registered_integrand_to_spawn():
    with pytest.raises(ValueError, match="is not registered"):
        TC.integrate_2d_sharded(lambda x, y: x * y, BOUNDS, 1e-6,
                                n_devices=2, device="cpu")


@pytest.mark.parametrize("n_devices", [1, 2])
def test_cli_2d_across_devices(sharded, n_devices, tmp_path):
    """``2d --n-devices N [--checkpoint]``: the sharded engine on N ranks
    (N = 1 in this process), equal to the in-process call."""
    if n_devices == 2:
        rc, out = sharded[0]["cli"]
        want = sharded[0]["base"]
        import os
        assert not os.path.exists(sharded[1]["cli"])   # a finished run
    else:
        rc, out = _run(CLI, CLI_2D + ["--n-devices", "1", "--checkpoint",
                                      str(tmp_path / "c.ckpt"),
                                      "--device", "cpu"])
        want = TC.integrate_2d_sharded(
            get_integrand_2d("gauss2d_peak").fn, BOUNDS, SH_RESUME_EPS,
            rule=Rule.TRAPEZOID, n_devices=1, device="cpu", **SH_KW)
    assert rc == 0
    rec = json.loads(out.strip().splitlines()[-1])
    assert rec["area"] == want.area
    assert rec["tasks"] == want.metrics.tasks
    assert rec["max_depth"] == want.metrics.max_depth
