"""The port's multi-process cluster (``ppls_tpu_torch.runtime.cluster``)
against the reference's single stream engine, on the CPU: real worker
processes behind one coordinator, each a port ``StreamEngine``.

tests/test_cluster.py's workload: the dyadic ``quad_scaled`` family
(registered by both packages, so worker processes see it), six thetas
with arrivals [0, 0, 1, 2, 3, 4], eps 1e-9, 256 lanes. Per-request areas
are schedule-independent to the bit there, so every comparison below is
bit-equal (tolerance 0) against the reference's single ``StreamEngine``
on the same requests, in the float64 mode (``f64_rounds=2``) and through
the walk (``f64_rounds=0``: each worker runs K1's plain segment here).

* Bootstrap, manifest and area parity at 1 and 2 processes, both modes;
  the manifest in the checkpoint identity; every worker's launch record;
  no worker process alive after ``close()``.
* Host loss: a real SIGKILL of worker 1 at phase 2 under the
  supervisor; discovery, re-deal, 0 lost, bit-identical areas.
* Cross-topology resume 2 -> 1 -> 2 under ``cluster_resize``, and the
  refusal without it; a truncated worker snapshot recovered.
* The worker protocol's launch counts: a worker's ``step`` and ``state``
  replies carry its process's K1 (walker) or K2 (``refill_slots=0``)
  launches (counted here by a wrapper around the plain segment, as the
  kernels count on the card).
* Without a card ``ClusterStreamEngine`` (CUDA by default) raises
  ``resolve_device``'s error and spawns nothing.
* The workers' distributed bootstrap (``jax_distributed=True``) beside
  the reference's (tests/test_cluster.py:478): every hello reports the
  group's device picture, the ids are 0..n-1, the cluster serves, a
  lost worker blocks no survivor; a spawn on ids other than 0..n-1 fails
  its bootstrap naming the worker, in both packages.

The card's twin (every worker launches K1) is
tests/test_torch_kernel_host.py::test_cuda_cluster_workers_launch_k1.
"""

import os
import re

import numpy as np
import pytest
import torch

from ppls_tpu.runtime.stream import StreamEngine as RefStream
from ppls_tpu_torch.obs.telemetry import Telemetry
from ppls_tpu_torch.parallel import walker as TW
from ppls_tpu_torch.runtime import cluster as C
from ppls_tpu_torch.runtime import guard
from ppls_tpu_torch.runtime.checkpoint import load_family_checkpoint
from ppls_tpu_torch.runtime.cluster import ClusterStreamEngine
from ppls_tpu_torch.runtime.faults import FaultInjector, FaultPlan

# tests/test_cluster.py:46-59
WKW = dict(slots=4, chunk=1 << 10, capacity=1 << 16, lanes=256,
           roots_per_lane=2, refill_slots=2, seg_iters=32,
           min_active_frac=0.05, f64_rounds=2)
THETA6 = [1.0, 1.25, 1.5, 2.0, 0.75, 3.0]
REQS6 = [(t, (0.0, 1.0)) for t in THETA6]
ARR6 = [0, 0, 1, 2, 3, 4]
MODES = {"f64": 2, "walker": 0}


@pytest.fixture(scope="module", autouse=True)
def _no_tuning_table():
    # inherited by the workers the coordinator spawns
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PPLS_TUNING_TABLE", "off")
        yield


@pytest.fixture(scope="module")
def base():
    """The reference's single engine on the workload, per mode."""
    return {m: RefStream("quad_scaled", 1e-9,
                         **dict(WKW, f64_rounds=f)).run(
                             REQS6, arrival_phase=ARR6)
            for m, f in MODES.items()}


def _cluster(n=2, **kw):
    return ClusterStreamEngine("quad_scaled", 1e-9, n_processes=n,
                               device="cpu",
                               worker_kw=kw.pop("worker_kw", WKW), **kw)


def _drive(eng, reqs, arr):
    k = eng.next_rid
    while not eng.idle or k < len(reqs):
        while k < len(reqs) and arr[k] <= eng.phase:
            eng.submit(*reqs[k])
            k += 1
        eng.step()
    return eng.result()


def _spying_telemetry():
    tel = Telemetry()
    events = []
    orig = tel.event

    def spy(name, **kw):
        events.append((name, kw))
        return orig(name, **kw)

    tel.event = spy
    return tel, events


def _alive(pid: int) -> bool:
    try:
        with open(f"/proc/{pid}/stat") as fh:
            return fh.read().split()[2] != "Z"
    except FileNotFoundError:
        return False


@pytest.mark.parametrize("n", [1, 2])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_bootstrap_manifest_and_area_parity(base, n, mode, tmp_path):
    tel, events = _spying_telemetry()
    ck = str(tmp_path / "c.ckpt")
    eng = _cluster(n, worker_kw=dict(WKW, f64_rounds=MODES[mode]),
                   telemetry=tel, checkpoint_path=ck)
    pids = [w.proc.pid for w in eng._workers]
    try:
        assert eng.manifest.identity() == {"processes": n,
                                           "devices": [1] * n}
        rows = eng.manifest.describe()["processes"]
        assert [r["platform"] for r in rows] == ["cpu"] * n
        assert [r["device"] for r in rows] == ["cpu"] * n
        assert any(name == "cluster_bootstrap" for name, _ in events)
        assert sorted(eng.spawn_walls) == list(range(n))
        assert all(0 < s < 180 for s in eng.spawn_walls.values())
        res = eng.run(REQS6, arrival_phase=ARR6)
        # per-request areas bit-identical to the reference's single
        # engine: requests are the unit of cross-host state
        assert np.array_equal(res.areas, base[mode].areas)
        assert sorted(c.rid for c in res.completed) == list(range(6))
        # every worker's launch record (the plain segments count none)
        assert sorted(res.cluster["launches"]) == [str(i)
                                                   for i in range(n)]
        for rec in res.cluster["launches"].values():
            assert set(rec) == {"run_segment_rf", "run_segment_ee"}
        # the manifest rides the checkpoint identity
        eng.snapshot()
        assert all(os.path.exists(f"{ck}.p{i}") for i in range(n))
        with pytest.raises(ValueError, match="different run"):
            load_family_checkpoint(ck, {"engine": "cluster-stream"})
    finally:
        eng.close()
    assert not [p for p in pids if _alive(p)]


def test_host_loss_discovery_redeal_bit_identical(base):
    """SIGKILL worker 1 mid-stream; the supervisor's host_loss arm
    discovers the surviving topology and re-deals through
    host_strided_redeal: areas bit-identical, 0 lost."""
    tel, events = _spying_telemetry()
    inj = FaultInjector(FaultPlan.from_events(
        [{"kind": "host_loss", "at": 2, "chip": 1}]), telemetry=tel)
    eng = _cluster(2, fault_injector=inj, telemetry=tel)
    pids = [w.proc.pid for w in eng._workers]

    def loop():
        return _drive(eng, REQS6, ARR6)

    def resize_fn(exc):
        eng.recover_host_loss(exc)
        return loop

    sup = guard.Supervisor(loop, resize_fn=resize_fn,
                           log=lambda m: None, sleep=lambda s: None)
    try:
        res = sup.run()
        assert sup.recoveries == [("host_loss", "resize_resume")]
        assert eng.manifest.identity() == {"processes": 1,
                                           "devices": [1]}
        assert np.array_equal(res.areas, base["f64"].areas)
        assert sorted(c.rid for c in res.completed) == list(range(6))
        names = [n for n, _ in events]
        assert {"host_killed", "host_loss_discovery",
                "cluster_redeal"} <= set(names)
        assert eng.redeal_walls and eng.redeal_walls[0] < 30.0
        # the lost worker keeps its last launch record
        assert sorted(res.cluster["launches"]) == ["0", "1"]
        assert not _alive(pids[1])
    finally:
        eng.close()
    assert not [p for p in pids if _alive(p)]


def test_cross_topology_resume_both_directions(base, tmp_path):
    ck = str(tmp_path / "xt.ckpt")
    eng = _cluster(2, checkpoint_path=ck, checkpoint_every=1)
    try:
        with pytest.raises(RuntimeError, match="simulated crash"):
            eng.run(REQS6, arrival_phase=ARR6, _crash_after_phases=3)
    finally:
        eng.close()
    # without the flag the deliberate-resize gate refuses, before any
    # worker starts
    with pytest.raises(ValueError, match="different run"):
        ClusterStreamEngine.resume(ck, "quad_scaled", 1e-9,
                                   n_processes=1, worker_kw=WKW,
                                   device="cpu")
    # 2 -> 1: outstanding requests re-deal, the drain completes
    e1 = ClusterStreamEngine.resume(ck, "quad_scaled", 1e-9,
                                    n_processes=1, worker_kw=WKW,
                                    cluster_resize=True,
                                    checkpoint_every=1, device="cpu")
    try:
        res = _drive(e1, REQS6, ARR6)
        assert np.array_equal(res.areas, base["f64"].areas)
        assert len(res.completed) == 6
        e1.snapshot()
    finally:
        e1.close()
    # 1 -> 2: the finished ledger carries over intact
    e2 = ClusterStreamEngine.resume(ck, "quad_scaled", 1e-9,
                                    n_processes=2, worker_kw=WKW,
                                    cluster_resize=True, device="cpu")
    try:
        assert len(e2.completed) == 6 and e2.idle
        assert np.array_equal(e2.result().areas, base["f64"].areas)
    finally:
        e2.close()


def test_corrupt_worker_snapshot_is_recoverable(base, tmp_path):
    """A truncated snapshot on ONE host routes through recovery (fresh
    worker + ledger replay) and never poisons the cluster."""
    ck = str(tmp_path / "cw.ckpt")
    eng = _cluster(2, checkpoint_path=ck, checkpoint_every=1)
    try:
        with pytest.raises(RuntimeError, match="simulated crash"):
            eng.run(REQS6, arrival_phase=ARR6, _crash_after_phases=3)
    finally:
        eng.close()
    p0 = ck + ".p0"
    with open(p0, "r+b") as fh:
        fh.truncate(os.path.getsize(p0) // 2)
    tel, events = _spying_telemetry()
    e2 = ClusterStreamEngine.resume(ck, "quad_scaled", 1e-9,
                                    n_processes=2, worker_kw=WKW,
                                    checkpoint_every=1, telemetry=tel,
                                    device="cpu")
    try:
        assert e2.manifest.identity()["processes"] == 2
        res = _drive(e2, REQS6, ARR6)
        assert np.array_equal(res.areas, base["f64"].areas)
        assert len(res.completed) == 6
        assert any(n == "worker_snapshot_corrupt" for n, _ in events)
    finally:
        e2.close()


def _counting(fn):
    """``fn`` with a ``launches`` count of its calls."""
    def wrapper(*a, **k):
        wrapper.launches += 1
        return fn(*a, **k)

    wrapper.launches = 0
    return wrapper


@pytest.mark.parametrize("refill_slots,kernel", [
    (2, "run_segment_rf"), (0, "run_segment_ee")], ids=["K1", "K2"])
def test_worker_replies_carry_kernel_launches(base, monkeypatch,
                                              refill_slots, kernel):
    """The worker side of the protocol in this process: K1 (K2 at
    refill_slots=0) counted by a wrapper, as the card counts launches;
    ``step`` and ``state`` replies carry the process's totals."""
    for name in ("run_segment_rf", "run_segment_ee"):
        monkeypatch.setattr(TW, name, _counting(getattr(TW, name)))
    spec = dict(WKW, f64_rounds=0, refill_slots=refill_slots,
                family="quad_scaled", eps=1e-9, device="cpu")
    dev = C._worker_device(spec, 0)
    eng, resumed, corrupt = C._worker_build_engine(spec, Telemetry(), dev)
    assert dev.type == "cpu" and not resumed and corrupt is None
    eng.client_state.setdefault("gmap", {})
    try:
        reqs = [{"grid": 10 + i, "theta": t, "bounds": [0.0, 1.0]}
                for i, t in enumerate(THETA6)]
        assert C._worker_dispatch(eng, {"cmd": "submit", "reqs": reqs}) \
            == {"ok": True, "accepted": 6}
        areas, steps = {}, []
        while not eng.idle:
            rep = C._worker_dispatch(eng, {"cmd": "step"})
            steps.append(rep["launches"])
            for r in rep["retired"]:
                areas[r["grid"] - 10] = r["area"]
        state = C._worker_dispatch(eng, {"cmd": "state"})
        assert state["launches"] == steps[-1]
        assert steps[-1][kernel] > 0
        other = ({"run_segment_rf", "run_segment_ee"} - {kernel}).pop()
        assert steps[-1][other] == 0
        # cumulative, never decreasing
        assert all(a[kernel] <= b[kernel]
                   for a, b in zip(steps, steps[1:]))
        got = np.array([areas[i] for i in range(6)])
        if refill_slots:
            assert np.array_equal(got, base["walker"].areas)
        assert state["outstanding"] == [] and len(state["completed"]) == 6
    finally:
        eng.close()


def test_without_a_card_raises_before_spawning(monkeypatch):
    spawned = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(C.subprocess, "Popen",
                        lambda *a, **k: spawned.append(a))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ClusterStreamEngine("quad_scaled", 1e-9, n_processes=2,
                            worker_kw=WKW)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        C._worker_device({"device": "cuda"}, 0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ClusterStreamEngine("quad_scaled", 1e-9, n_processes=2,
                            worker_kw=WKW, jax_distributed=True)
    with pytest.raises(ValueError, match="n_processes must be >= 1"):
        ClusterStreamEngine("quad_scaled", 1e-9, n_processes=0,
                            worker_kw=WKW, device="cpu")
    assert spawned == []



def _port_workers() -> list:
    """This process's port worker children still alive (zombies aside)."""
    out = []
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            with open(f"/proc/{d}/stat") as fh:
                fields = fh.read().rsplit(")", 1)[1].split()
            with open(f"/proc/{d}/cmdline", "rb") as fh:
                cmd = fh.read()
        except OSError:
            continue
        if (int(fields[1]) == os.getpid() and fields[0] != "Z"
                and b"ppls_tpu_torch.runtime.cluster" in cmd):
            out.append(int(d))
    return out


def _both(ref_fn, port_fn):
    """Run the reference's and the port's halves at once (their workers
    start in parallel): (reference outcome, port outcome), each a value
    or the exception raised."""
    import concurrent.futures as cf

    def catch(fn):
        try:
            return fn()
        except Exception as e:  # noqa: BLE001 -- compared by the caller
            return e
    with cf.ThreadPoolExecutor(2) as ex:
        fr, fp = ex.submit(catch, ref_fn), ex.submit(catch, port_fn)
        return fr.result(), fp.result()


def _check_pictures(infos):
    """tests/test_cluster.py:478's invariants on the hellos' pictures."""
    assert all(i is not None for i in infos)
    local = [i["local_devices"] for i in infos]
    assert all(i["global_devices"] == sum(local) for i in infos)
    assert sorted(i["process_id"] for i in infos) == [0, 1]


def test_jax_distributed_bootstrap_beside_the_reference(base):
    """Two workers join one process group (gloo on the CPU) over the
    coordinator's store: each reports the global device picture, as the
    reference's jax.distributed workers do, and the cluster serves over
    it with the reference engine's areas. A killed worker blocks no
    survivor (the group carries no collective after the hello), and no
    worker outlives close()."""
    from ppls_tpu.runtime.cluster import ClusterStreamEngine as RefCluster

    def ref():
        eng = RefCluster("quad_scaled", 1e-9, n_processes=2,
                         worker_kw=dict(WKW), jax_distributed=True)
        try:
            infos = [w.hello.get("jax_distributed") for w in eng._workers]
            return infos, eng.run(REQS6[:2])
        finally:
            # a graceful close waits ~10 s on jax.distributed's shutdown
            eng.close(graceful=False)

    tel, events = _spying_telemetry()

    def port():
        eng = _cluster(2, telemetry=tel, jax_distributed=True)
        pids = [w.proc.pid for w in eng._workers]
        try:
            infos = [w.hello.get("jax_distributed") for w in eng._workers]
            res = eng.run(REQS6[:2])
            eng.kill_process(0)
            eng.recover_host_loss()
            eng.submit(*REQS6[2])
            after = eng.drain()
            return infos, res, after, pids
        finally:
            eng.close()

    (rinfos, rres), got = _both(ref, port)
    assert not isinstance(got, Exception), got
    infos, res, after, pids = got
    _check_pictures(rinfos)
    _check_pictures(infos)
    assert all(i["platform"] == "cpu" for i in infos)
    assert len(res.completed) == len(rres.completed) == 2
    assert np.array_equal(res.areas, base["f64"].areas[:2])
    assert np.array_equal(res.areas, rres.areas)
    assert [c.rid for c in after] == [2]
    assert after[0].area == base["f64"].areas[2]
    boot = [kw for name, kw in events if name == "cluster_bootstrap"]
    assert boot and all(kw["jax_distributed"] is True for kw in boot)
    assert not [p for p in pids if _alive(p)]


def test_jax_distributed_respawn_needs_ids_0_to_n_minus_1():
    """A spawn on process ids other than 0..n-1 (ids [0, 2]): the
    reference's jax.distributed refuses process_id 2 of 2, so worker 2
    exits before its hello and the bootstrap fails naming it; the port
    refuses with the same words and fails the same way, with no worker
    left."""
    from ppls_tpu.runtime import cluster as RC
    spec = dict(WKW, family="quad_scaled", eps=1e-9)
    msg = r"worker process\(es\) \[2\] exited before handshaking"

    def ref():
        return RC._spawn_workers(2, spec, None, 120.0, 60.0, True,
                                 process_ids=[0, 2])

    def port():
        return C._spawn_workers(2, dict(spec, device="cpu"), None, 120.0,
                                60.0, True, process_ids=[0, 2])
    rout, pout = _both(ref, port)
    for out in (rout, pout):
        assert isinstance(out, RuntimeError), out
        assert re.search(msg, str(out)), out
    assert _port_workers() == []
    with pytest.raises(ValueError, match="process_id < num_processes. Got "
                       "process_id=2, num_processes=2"):
        C.init_distributed("127.0.0.1:1", 2, 2, "cpu")
