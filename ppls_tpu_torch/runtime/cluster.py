"""Multi-process cluster: N worker processes behind one coordinator,
surviving-host discovery, and a cluster manifest on the checkpoint
identity (the reference's ``runtime/cluster.py``, on torch processes).

The reference program's design is N-1 workers behind one farmer
(``aquadPartA.c:92-105``). Here the streaming service runs as that
shape at request granularity: the coordinator (this process) deals
requests over N worker processes, each running its own
:class:`~ppls_tpu_torch.runtime.stream.StreamEngine`, and the phase
boundary is the cross-process exchange, over a localhost socket.

* **Workers.** Each worker is ``python -m ppls_tpu_torch.runtime.cluster
  --connect HOST:PORT --process-id P --spec JSON``. A spec whose device
  is ``"cuda"`` runs the worker's engine on ``cuda:(P % device_count)``
  (``parallel/mesh.py``'s rule), so on one card every worker shares
  ``cuda:0``, time-sliced: no rate from that layout is a multi-GPU rate.
  ``"cpu"`` runs the plain PyTorch segments. The engine walks through K1
  (``csrc/walk_rf.cu``, ``refill_slots`` > 0) or K2 (``csrc/walk_ee.cu``,
  ``refill_slots=0``); a worker without a card raises before it
  handshakes, and the bootstrap fails naming it. Every ``step`` and
  ``state`` reply carries the worker process's cumulative
  ``run_segment_rf`` / ``run_segment_ee`` launch counts; the coordinator
  keeps them per process (``launches()``, ``result().cluster``).
* **The workers' distributed bootstrap** (``jax_distributed=True``, the
  reference's ``init_distributed`` path of a TPU pod). The coordinator
  opens a ``TCPStore`` for each spawn and hands its address to every
  worker (``--jax-coordinator HOST:PORT --num-processes N``); each
  worker joins a ``torch.distributed`` process group of the N workers
  (:func:`init_distributed`: gloo when they share one card, NCCL when
  each owns one, ``parallel/mesh.py``'s ``choose_backend``) before it
  builds its engine, all-reduces its device count once and reports the
  picture in its hello. The group is the workers' own, never the
  default group, and carries no collective after that, so a lost worker
  blocks no survivor; the store lives in the coordinator, so no
  worker's loss takes it down. Process ids must be 0..N-1, as the
  reference's ``jax.distributed`` requires: a respawn on other ids fails
  its bootstrap naming the worker, as the reference's does. A worker
  shuts its group down when it exits.
* **Coordinator-held manifest.** :class:`ClusterManifest` records
  process -> devices as the workers report it at hello (``devices``: the
  ranks the worker's engine drives, 1, or ``n_devices`` for
  ``engine="walker-dd"``), joins the coordinator checkpoint identity as
  the ``cluster`` key, and makes cross-topology resume deliberate:
  resuming an n-process snapshot on m != n processes refuses unless
  ``cluster_resize=True``.
* **Surviving-host discovery.** A step RPC that hits a dead socket
  raises :class:`guard.HostLossError`; the supervisor's ``host_loss``
  arm calls :meth:`ClusterStreamEngine.recover_host_loss`, which pings
  every worker, updates the manifest and re-deals the lost host's
  outstanding requests onto the survivors through
  ``mesh.host_strided_redeal``. Requests are the unit of cross-host
  state, so a replayed request's area is the schedule-independent
  per-request contract: bit-identical on dyadic workloads.
* **Zero lost acknowledgements.** The coordinator ledger holds every
  submitted payload, its assignment and its outcome; snapshots are a
  coordinated cut (workers first, then the coordinator). On resume the
  coordinator adopts worker completions newer than its own snapshot and
  re-submits what a worker lost (fresh or corrupt snapshot), so every
  acknowledged rid ends in exactly one of completed/shed/spillover.
* **CPU spillover.** With ``spillover=True`` queue-overflow victims
  without a deadline run as float64 bag rounds on the host CPU
  (``backends/spillover.py``) instead of being shed.
* **Federated metrics.** Workers ship cumulative registry dumps; the
  coordinator merges them (``obs/federation.py``) with its own under
  ``process="coordinator"``.

Worker protocol: newline-delimited JSON over localhost TCP (``hello``
at connect; then ``state`` / ``submit`` / ``step`` / ``snapshot`` /
``ping`` / ``exit``). The reference's ``deep_trace_probes`` (a lint
probe of its compiled worker program) has no copy: only its linter
calls it.
"""

from __future__ import annotations

import dataclasses
import json
import os
import signal
import socket
import subprocess
import sys
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from ppls_tpu_torch.config import Rule
from ppls_tpu_torch.runtime.guard import HostLossError
from ppls_tpu_torch.runtime.stream import StreamResult

# worker engine kwargs the coordinator forwards verbatim (everything
# else in the spec is cluster plumbing)
_WORKER_ENGINE_KEYS = (
    "rule", "slots", "chunk", "capacity", "lanes", "roots_per_lane",
    "refill_slots", "seg_iters", "max_segments", "min_active_frac",
    "f64_rounds", "scout_dtype", "double_buffer", "reduced_integrands",
    "theta_block", "engine", "n_devices", "quarantine",
)

# the kernels a worker's engine launches (``parallel/walker.py``'s
# counting wrappers), reported per process
_LAUNCH_KEYS = ("run_segment_rf", "run_segment_ee")

# the reference's name for the workers' distributed bootstrap; the
# switch itself is ``ClusterStreamEngine(jax_distributed=True)``
ENV_JAX_DISTRIBUTED = "PPLS_JAX_DISTRIBUTED"
# s, the bootstrap rendezvous (every worker joins within it)
DIST_TIMEOUT_S = 300.0

# this worker process's group of workers (init_distributed), if any
_DIST_GROUP = None


def init_distributed(coordinator_address: str, num_processes: int,
                     process_id: int, device="cuda") -> dict:
    """Join the workers' process group over the ``TCPStore`` at
    ``coordinator_address`` (HOST:PORT) as rank ``process_id`` of
    ``num_processes``, on ``cuda:(process_id % cards)`` or the CPU, and
    all-reduce the local device counts once. Returns the device picture
    this process sees (the hello's ``jax_distributed`` row):
    ``process_id``, ``local_devices`` (1: the worker's one device),
    ``global_devices`` (their sum over the group) and ``platform``
    (``"gpu"`` or ``"cpu"``). Raises, as the reference does, unless
    0 <= process_id < num_processes."""
    global _DIST_GROUP
    import datetime

    import torch
    import torch.distributed as dist

    from ppls_tpu_torch.parallel.mesh import (_own_group, choose_backend,
                                              rank_device)
    n, rank = int(num_processes), int(process_id)
    if n < 0 or rank < 0 or rank >= n:
        raise ValueError(
            "process_id and num_processes must be nonnegative, with "
            "process_id < num_processes. Got process_id="
            f"{rank}, num_processes={n}.")
    dev = rank_device(device, rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    host, port = coordinator_address.rsplit(":", 1)
    store = dist.TCPStore(host, int(port), None, False,
                          timeout=datetime.timedelta(seconds=DIST_TIMEOUT_S))
    backend = choose_backend(n, device)
    group = _own_group(backend, dist.PrefixStore("cluster", store), rank,
                       n, DIST_TIMEOUT_S)
    count = torch.ones(1, dtype=torch.int64,
                       device=dev if backend == "nccl" else "cpu")
    group.allreduce([count]).wait()
    _DIST_GROUP = group
    return {"process_id": rank, "local_devices": 1,
            "global_devices": int(count.item()),
            "platform": "gpu" if dev.type == "cuda" else "cpu"}


def _shutdown_distributed() -> None:
    """Shut this worker's group of workers down, if it joined one."""
    global _DIST_GROUP
    if _DIST_GROUP is not None:
        _DIST_GROUP.shutdown()
        _DIST_GROUP = None


@dataclasses.dataclass
class ClusterManifest:
    """Coordinator-held process -> devices map, reported by each worker
    at hello. ``identity()`` is the checkpoint-identity face: resuming
    under a different manifest refuses unless the caller passes
    ``cluster_resize=True``."""

    processes: List[dict] = dataclasses.field(default_factory=list)

    @property
    def n_processes(self) -> int:
        return len(self.processes)

    @property
    def process_ids(self) -> List[int]:
        return sorted(int(p["process_id"]) for p in self.processes)

    def identity(self) -> dict:
        """Process count + per-process device counts in process-id
        order. Host names and pids are left out: a restart on new pids
        of the SAME topology is the same cluster."""
        rows = sorted(self.processes,
                      key=lambda p: int(p["process_id"]))
        return {"processes": len(rows),
                "devices": [int(p.get("devices", 1)) for p in rows]}

    def drop(self, process_id: int) -> None:
        self.processes = [p for p in self.processes
                          if int(p["process_id"]) != int(process_id)]

    def describe(self) -> dict:
        return {"processes": [dict(p) for p in self.processes]}


@dataclasses.dataclass
class ClusterStreamResult(StreamResult):
    """A cluster's :class:`StreamResult`, plus ``cluster``: each worker
    process's cumulative K1/K2 launches as it last reported them
    (``{"launches": {process_id: {"run_segment_rf": n, ...}}}``)."""

    cluster: Optional[dict] = None


# ---------------------------------------------------------------------------
# socket plumbing (newline-delimited JSON, both directions)
# ---------------------------------------------------------------------------

class _SockIO:
    def __init__(self, conn: socket.socket):
        self.conn = conn
        self._rfile = conn.makefile("rb")

    def send(self, obj: dict) -> None:
        self.conn.sendall(json.dumps(obj).encode("utf-8") + b"\n")

    def recv(self, timeout: Optional[float] = None) -> dict:
        self.conn.settimeout(timeout)
        line = self._rfile.readline()
        if not line:
            raise ConnectionError("peer closed the connection")
        return json.loads(line.decode("utf-8"))

    def close(self) -> None:
        try:
            self._rfile.close()
        except OSError:
            pass
        try:
            self.conn.close()
        except OSError:
            pass


# ---------------------------------------------------------------------------
# worker side
# ---------------------------------------------------------------------------

def _worker_device(spec: dict, process_id: int):
    """The worker's device: ``cuda:(process_id % device_count)`` for a
    ``"cuda"`` spec (raises without a card), else the CPU."""
    import torch

    from ppls_tpu_torch.utils.device import resolve_device
    dev = resolve_device(spec.get("device", "cuda"))
    if dev.type == "cuda":
        dev = torch.device("cuda",
                           int(process_id) % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    return dev


def _worker_build_engine(spec: dict, telemetry, device):
    """Build (or resume) the worker-local StreamEngine. A corrupt
    snapshot is recoverable here: report it, discard the file, start
    fresh; the coordinator replays this worker's share from its ledger
    (one host's disk never poisons the cluster)."""
    from ppls_tpu_torch.runtime.checkpoint import CheckpointCorruptError
    from ppls_tpu_torch.runtime.stream import StreamEngine
    kw = {k: spec[k] for k in _WORKER_ENGINE_KEYS if k in spec}
    if "rule" in kw:
        kw["rule"] = Rule(kw["rule"])
    kw["device"] = device
    ckpt = spec.get("checkpoint_path")
    corrupt = None
    if ckpt and os.path.exists(ckpt):
        try:
            eng = StreamEngine.resume(
                ckpt, spec["family"], float(spec["eps"]),
                telemetry=telemetry, checkpoint_every=1 << 30, **kw)
            return eng, True, None
        except CheckpointCorruptError as e:
            corrupt = str(e)[:300]
            os.unlink(ckpt)
    eng = StreamEngine(spec["family"], float(spec["eps"]),
                       checkpoint_path=ckpt, checkpoint_every=1 << 30,
                       telemetry=telemetry, **kw)
    return eng, False, corrupt


def _worker_launches() -> dict:
    """This process's cumulative K1/K2 launch counts."""
    from ppls_tpu_torch.parallel import walker as W
    return {k: int(getattr(W, k).launches) for k in _LAUNCH_KEYS}


def _worker_state(eng) -> dict:
    """The worker's resume-relevant state: outstanding global rids
    (pending + resident), completed records and shed records (a
    worker-side deadline shed is a terminal outcome the coordinator must
    adopt, or its ledger entry stays 'dealt' forever); the coordinator
    reconciles these against its own (possibly older) ledger."""
    gmap = {int(k): int(v)
            for k, v in eng.client_state.get("gmap", {}).items()}
    outstanding = sorted(
        gmap[r.rid] for r in eng._pending if r.rid in gmap)
    outstanding += sorted(
        gmap[r.rid] for r in eng._slot_req.values() if r.rid in gmap)
    done = []
    for c in eng.completed:
        if c.rid not in gmap:
            continue
        done.append(_retired_record(c, gmap[c.rid]))
    shed = [_shed_record(s, gmap[s.rid]) for s in eng.shed
            if s.rid in gmap]
    return {"outstanding": sorted(outstanding), "completed": done,
            "shed": shed}


def _shed_record(s, grid: int) -> dict:
    return {"grid": int(grid), "reason": s.reason,
            "tenant": s.tenant, "priority": int(s.priority)}


def _retired_record(c, grid: int) -> dict:
    return {
        "grid": int(grid),
        "area": (None if c.failed else float(c.area)),
        "areas": ([float(v) for v in c.areas]
                  if (c.areas is not None and not c.failed) else None),
        "failed": bool(c.failed), "failure": c.failure,
        "tenant": c.tenant, "priority": int(c.priority),
    }


def worker_main(argv: Optional[List[str]] = None) -> int:
    """Entry point of one cluster worker process."""
    import argparse
    p = argparse.ArgumentParser(prog="ppls_tpu_torch.runtime.cluster")
    p.add_argument("--connect", required=True, metavar="HOST:PORT")
    p.add_argument("--process-id", type=int, required=True)
    p.add_argument("--spec", required=True,
                   help="engine spec: inline JSON or @file.json")
    p.add_argument("--jax-coordinator", default=None,
                   help="the workers' TCPStore address; arms "
                        "init_distributed (the reference's flag name)")
    p.add_argument("--num-processes", type=int, default=None)
    args = p.parse_args(argv)

    spec = args.spec
    if spec.startswith("@"):
        with open(spec[1:], encoding="utf-8") as fh:
            spec = fh.read()
    spec = json.loads(spec)

    import torch

    from ppls_tpu_torch.obs.telemetry import Telemetry
    dist_info = None
    if args.jax_coordinator and args.num_processes:
        dist_info = init_distributed(args.jax_coordinator,
                                     args.num_processes, args.process_id,
                                     spec.get("device", "cuda"))
    device = _worker_device(spec, args.process_id)
    tel = Telemetry()
    eng, resumed, corrupt = _worker_build_engine(spec, tel, device)
    eng.client_state.setdefault("gmap", {})

    host, port = args.connect.rsplit(":", 1)
    conn = socket.create_connection((host, int(port)), timeout=60)
    io = _SockIO(conn)
    hello = {
        "hello": True, "process_id": int(args.process_id),
        "pid": os.getpid(),
        # the ranks this worker's engine drives (walker-dd: its world)
        "devices": int(getattr(eng, "_n_dev", 1)),
        "platform": "gpu" if device.type == "cuda" else "cpu",
        "device": str(device),
        "device_name": (torch.cuda.get_device_name(device)
                        if device.type == "cuda" else "cpu"),
        "resumed": bool(resumed),
        # the boot-time cumulative dump (a resumed worker's replayed
        # registry; zeros on a fresh start)
        "metrics": tel.registry.dump(),
        "launches": _worker_launches(),
    }
    if corrupt:
        hello["corrupt"] = corrupt
    if dist_info:
        hello["jax_distributed"] = dist_info
    hello.update(_worker_state(eng))
    io.send(hello)

    try:
        while True:
            try:
                cmd = io.recv(timeout=None)
            except (ConnectionError, OSError):
                return 0                # the coordinator went away
            try:
                reply = _worker_dispatch(eng, cmd)
            except Exception as e:  # noqa: BLE001 -- shipped to the coordinator
                reply = {"error": f"{e}"[:500],
                         "etype": type(e).__name__}
            try:
                io.send(reply)
            except (ConnectionError, OSError):
                return 0
            if cmd.get("cmd") == "exit":
                return 0
    finally:
        io.close()
        eng.close()
        _shutdown_distributed()


def _worker_dispatch(eng, cmd: dict) -> dict:
    kind = cmd.get("cmd")
    if kind == "ping":
        return {"ok": True, "phase": int(eng.phase)}
    if kind == "state":
        return dict(_worker_state(eng), ok=True,
                    metrics=eng.telemetry.registry.dump(),
                    launches=_worker_launches())
    if kind == "exit":
        return {"ok": True}
    if kind == "snapshot":
        eng.snapshot()
        return {"ok": True,
                "metrics": eng.telemetry.registry.dump()}
    if kind == "submit":
        gmap = eng.client_state["gmap"]
        for r in cmd["reqs"]:
            rid = eng.submit(
                (tuple(r["theta"]) if isinstance(r["theta"], list)
                 else float(r["theta"])),
                tuple(r["bounds"]), tenant=r.get("tenant", "default"),
                priority=int(r.get("priority", 1)),
                deadline_phases=r.get("deadline_phases"))
            gmap[str(rid)] = int(r["grid"])
        return {"ok": True, "accepted": len(cmd["reqs"])}
    if kind == "step":
        gmap = {int(k): int(v)
                for k, v in eng.client_state["gmap"].items()}
        n0 = eng.phase_rows_len()
        s0 = len(eng.shed)
        retired = eng.step()
        # an idle phase appends no row: report zeros, not the stale
        # previous phase's deltas
        row = (eng.last_phase_row()
               if eng.phase_rows_len() > n0 else None)
        return {
            "ok": True, "phase": int(eng.phase),
            "retired": [_retired_record(c, gmap[c.rid])
                        for c in retired if c.rid in gmap],
            "shed": [_shed_record(s, gmap[s.rid])
                     for s in eng.shed[s0:] if s.rid in gmap],
            "pending": int(eng.pending),
            "resident": int(eng.resident),
            # the trace context's return leg: the global rids still
            # resident on this worker after the phase (retired rids ride
            # the 'retired' list above)
            "resident_grids": sorted(
                gmap[r.rid] for r in eng._slot_req.values()
                if r.rid in gmap),
            # the worker's CUMULATIVE registry dump: the coordinator
            # owns delta computation, so a dropped or replayed reply
            # cannot double-count
            "metrics": eng.telemetry.registry.dump(),
            "launches": _worker_launches(),
            "live": int(row["live_tasks"]) if row else 0,
            "tasks": int(row["tasks"]) if row else 0,
            "wtasks": int(row["wtasks"]) if row else 0,
            "wsteps": int(row["wsteps"]) if row else 0,
            "idle": bool(eng.idle),
        }
    raise ValueError(f"unknown worker command {kind!r}")


# ---------------------------------------------------------------------------
# coordinator side
# ---------------------------------------------------------------------------

class WorkerLost(ConnectionError):
    """A worker RPC hit a dead process/socket; carries which one."""

    def __init__(self, process_id: int, detail: str):
        self.process_id = int(process_id)
        super().__init__(
            f"worker process {process_id} lost ({detail})")


class WorkerHandle:
    """One spawned worker: its Popen, socket, and manifest row."""

    def __init__(self, process_id: int, proc: subprocess.Popen,
                 io: _SockIO, hello: dict, rpc_timeout: float,
                 spawn_s: float = 0.0):
        self.process_id = int(process_id)
        self.proc = proc
        self.io = io
        self.hello = hello
        self.rpc_timeout = float(rpc_timeout)
        # seconds from the spawn to the hello: interpreter, torch
        # import, device context and engine build
        self.spawn_s = float(spawn_s)
        # the workers' TCPStore (jax_distributed), shared by the
        # handles of one spawn and freed with the last of them
        self.dist_store = None

    def send_cmd(self, obj: dict) -> None:
        """Fire one command without reading the reply: the fan-out half
        of a parallel RPC round (every worker computes its phase
        concurrently; :meth:`recv_reply` collects in worker order)."""
        try:
            self.io.send(obj)
        except (OSError, ConnectionError, ValueError) as e:
            # a failed RPC poisons the request/reply pairing (a late
            # reply would answer the NEXT command): close the socket so
            # discovery reaps this worker instead of resyncing
            self.io.close()
            raise WorkerLost(self.process_id,
                             f"{type(e).__name__}: {e}") from e

    def recv_reply(self, timeout: Optional[float] = None) -> dict:
        try:
            reply = self.io.recv(timeout or self.rpc_timeout)
        except (OSError, ConnectionError, ValueError) as e:
            self.io.close()
            raise WorkerLost(self.process_id,
                             f"{type(e).__name__}: {e}") from e
        if "error" in reply:
            if reply.get("etype") == "FloatingPointError":
                raise FloatingPointError(reply["error"])
            raise RuntimeError(
                f"worker {self.process_id}: {reply['error']}")
        return reply

    def call(self, obj: dict,
             timeout: Optional[float] = None) -> dict:
        self.send_cmd(obj)
        return self.recv_reply(timeout)

    def ping(self, timeout: float = 5.0) -> bool:
        if self.proc.poll() is not None:
            return False
        try:
            return bool(self.call({"cmd": "ping"},
                                  timeout=timeout).get("ok"))
        except WorkerLost:
            return False

    def kill(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()

    def reap(self) -> None:
        """Kill the process if it still runs and wait for it, so no
        worker (and no device context it holds) outlives its handle."""
        self.io.close()
        if self.proc.poll() is None:
            self.proc.kill()
        try:
            self.proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            pass

    def close(self, graceful: bool = True) -> None:
        if graceful and self.proc.poll() is None:
            try:
                self.call({"cmd": "exit"}, timeout=10)
            except (WorkerLost, RuntimeError):
                pass
        self.io.close()
        if self.proc.poll() is None:
            self.proc.terminate()
            try:
                self.proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait(timeout=10)
        else:
            self.proc.wait()


def _package_root() -> str:
    """The directory that holds ``ppls_tpu_torch``."""
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


def _spawn_workers(n_processes: int, spec: dict, base_ckpt,
                   spawn_timeout: float, rpc_timeout: float,
                   jax_distributed: bool = False,
                   process_ids: Optional[List[int]] = None
                   ) -> List[WorkerHandle]:
    """Spawn + handshake ``n_processes`` workers. Every worker gets the
    shared engine spec plus its own checkpoint path (sibling files of
    the coordinator snapshot: ``<path>.p<process_id>``). With
    ``jax_distributed`` the workers join one process group over a
    ``TCPStore`` opened here, which every returned handle holds."""
    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.bind(("127.0.0.1", 0))
    srv.listen(n_processes)
    addr = f"127.0.0.1:{srv.getsockname()[1]}"
    ids = (list(process_ids) if process_ids is not None
           else list(range(n_processes)))
    store = None
    if jax_distributed:
        # the workers' rendezvous lives in the coordinator, so it
        # outlives any one worker; every worker gets its address
        import datetime

        import torch.distributed as dist
        store = dist.TCPStore(
            "127.0.0.1", 0, None, True,
            timeout=datetime.timedelta(seconds=DIST_TIMEOUT_S),
            wait_for_workers=False)
    procs, started, handles = {}, {}, {}
    env = dict(os.environ)
    # workers must resolve the package whatever the coordinator's cwd:
    # prepend the root this package loaded from
    env["PYTHONPATH"] = os.pathsep.join(
        [_package_root()] + ([env["PYTHONPATH"]]
                             if env.get("PYTHONPATH") else []))
    try:
        for pid_ in ids:
            wspec = dict(spec)
            if base_ckpt:
                wspec["checkpoint_path"] = f"{base_ckpt}.p{pid_}"
            cmd = [sys.executable, "-m", "ppls_tpu_torch.runtime.cluster",
                   "--connect", addr, "--process-id", str(pid_),
                   "--spec", json.dumps(wspec)]
            if store is not None:
                cmd += ["--jax-coordinator", f"127.0.0.1:{store.port}",
                        "--num-processes", str(n_processes)]
            started[pid_] = time.perf_counter()
            procs[pid_] = subprocess.Popen(
                cmd, stdout=subprocess.DEVNULL, env=env)
        # short accept timeout so a worker that DIES during boot (a bad
        # spec, no card, an unresumable per-process snapshot) fails the
        # bootstrap at once instead of waiting out the spawn budget
        srv.settimeout(2.0)
        deadline = time.monotonic() + spawn_timeout
        while len(handles) < len(ids):
            if time.monotonic() > deadline:
                raise RuntimeError(
                    f"cluster bootstrap: only {len(handles)} of "
                    f"{len(ids)} workers connected within "
                    f"{spawn_timeout:.0f}s")
            dead = [k for k, pr in procs.items()
                    if k not in handles and pr.poll() is not None]
            if dead:
                raise RuntimeError(
                    f"cluster bootstrap: worker process(es) {dead} "
                    f"exited before handshaking (exit codes "
                    f"{[procs[k].returncode for k in dead]}); "
                    f"check the worker spec / per-process snapshots")
            try:
                conn, _ = srv.accept()
            except socket.timeout:
                continue
            io = _SockIO(conn)
            hello = io.recv(timeout=spawn_timeout)
            k = int(hello["process_id"])
            handles[k] = WorkerHandle(
                k, procs[k], io, hello, rpc_timeout,
                spawn_s=time.perf_counter() - started[k])
            handles[k].dist_store = store
        return [handles[k] for k in sorted(handles)]
    except BaseException:
        for h in handles.values():
            h.io.close()
        for pr in procs.values():
            if pr.poll() is None:
                pr.kill()
        for pr in procs.values():
            try:
                pr.wait(timeout=30)
            except subprocess.TimeoutExpired:
                pass
        raise
    finally:
        srv.close()


@dataclasses.dataclass
class _LedgerEntry:
    """One submitted request in the coordinator ledger: the payload
    (enough to re-submit anywhere), its assignment, and its state."""

    grid: int
    theta: object
    bounds: Tuple[float, float]
    tenant: str
    priority: int
    deadline_phases: Optional[int]
    submit_phase: int
    submit_t: float
    assigned: Optional[int] = None        # process_id, None = undealt
    state: str = "pending"      # pending | dealt | spill | done | shed
    # the coordinator phase the request was first dealt at: the admit
    # edge of its trace (queue wait = dealt - submit)
    dealt_phase: Optional[int] = None

    def payload(self) -> dict:
        return {"grid": self.grid,
                "theta": (list(self.theta)
                          if isinstance(self.theta, (tuple, list))
                          else self.theta),
                "bounds": list(self.bounds), "tenant": self.tenant,
                "priority": self.priority,
                "deadline_phases": self.deadline_phases}

    @classmethod
    def from_payload(cls, d: dict, submit_phase: int = 0) -> \
            "_LedgerEntry":
        th = d["theta"]
        return cls(grid=int(d["grid"]),
                   theta=(tuple(th) if isinstance(th, list)
                          else float(th)),
                   bounds=tuple(d["bounds"]),
                   tenant=d.get("tenant", "default"),
                   priority=int(d.get("priority", 1)),
                   deadline_phases=d.get("deadline_phases"),
                   submit_phase=int(d.get("submit_phase",
                                          submit_phase)),
                   submit_t=time.perf_counter())


class ClusterStreamEngine:
    """Coordinator-side streaming engine over N worker processes.

    The driving surface mirrors
    :class:`~ppls_tpu_torch.runtime.stream.StreamEngine` (``submit`` /
    ``step`` / ``drain`` / ``run`` / ``result`` / ``snapshot`` /
    ``resume``), so the serve CLI and the supervisor drive either.
    Requests deal round-robin over the live process set in rid order
    (the deterministic deal), each worker runs its own engine, and the
    coordinator phase is the cross-process boundary: deal -> step-all ->
    collect retirements -> spillover -> checkpoint. The host-side sum of
    the workers' live-row counts is the cross-process occupancy.

    ``device`` is the workers' device (CUDA by default; it is resolved
    before any worker starts, so without a card this raises and spawns
    nothing). ``worker_kw`` are the workers' engine kwargs.
    ``jax_distributed=True`` (the reference's name) builds the workers'
    process group at every spawn (module docstring); each worker's
    hello then carries its ``jax_distributed`` device picture.
    """

    def __init__(self, family: str, eps: float, *,
                 n_processes: int = 2,
                 worker_kw: Optional[dict] = None,
                 checkpoint_path: Optional[str] = None,
                 checkpoint_every: int = 8,
                 telemetry=None, fault_injector=None,
                 queue_limit: Optional[int] = None,
                 spillover: bool = False,
                 spillover_limit: int = 4,
                 jax_distributed: bool = False,
                 spawn_timeout: float = 180.0,
                 rpc_timeout: float = 600.0,
                 slo_config=None,
                 device="cuda",
                 _defer_spawn: bool = False):
        from ppls_tpu_torch.models.integrands import get_family_ds
        from ppls_tpu_torch.obs.federation import FederatedMetrics
        from ppls_tpu_torch.obs.telemetry import Telemetry
        from ppls_tpu_torch.utils.device import resolve_device
        self._closed = True       # nothing to close until workers exist
        self._workers: List[WorkerHandle] = []
        if n_processes < 1:
            raise ValueError(
                f"n_processes must be >= 1, got {n_processes}")
        self.device = resolve_device(device)
        self.family = family
        self.eps = float(eps)
        self.worker_kw = dict(worker_kw or {})
        self.rule = Rule(self.worker_kw.get("rule", Rule.TRAPEZOID))
        self._f_ds = get_family_ds(family)
        self.n_processes = int(n_processes)
        self.jax_distributed = bool(jax_distributed)
        self.checkpoint_path = checkpoint_path
        self.checkpoint_every = max(int(checkpoint_every), 1)
        self.telemetry = telemetry if telemetry is not None \
            else Telemetry()
        self.fault_injector = fault_injector
        self.queue_limit = (None if queue_limit is None
                            else int(queue_limit))
        self.quarantine = bool(self.worker_kw.get("quarantine"))
        self.spillover_limit = int(spillover_limit)
        # the spill queue is BOUNDED: beyond ~8 phases of spillover
        # backlog the victim sheds with an explicit record, or sustained
        # deadline-less overload would re-grow the unbounded backlog
        # queue_limit exists to prevent, one hop downstream
        self._spill_cap = 8 * max(self.spillover_limit, 1)
        self._spill = None
        if spillover:
            from ppls_tpu_torch.backends.spillover import SpilloverExecutor
            self._spill = SpilloverExecutor(
                family, self.eps, rule=self.rule,
                chunk=int(self.worker_kw.get("chunk", 1 << 10)),
                capacity=int(self.worker_kw.get("capacity", 1 << 16)),
                telemetry=self.telemetry)
        self._spawn_timeout = float(spawn_timeout)
        self._rpc_timeout = float(rpc_timeout)

        self.phase = 0
        self._next_rid = 0
        self._ledger: Dict[int, _LedgerEntry] = {}
        self._pending: List[int] = []            # undealt grids
        self._spill_queue: List[int] = []
        self.completed: List = []
        self.shed: List = []
        self.client_state: dict = {}
        self._tasks_total = 0
        self._wtasks_total = 0
        self._wsteps_total = 0
        self.redeal_walls: List[float] = []
        self._rr = 0
        self._phases_after_recovery = 0
        # process id -> its worker's cumulative K1/K2 launches, as last
        # reported (a lost worker keeps its last report)
        self._launches: Dict[int, dict] = {}
        # process id -> seconds from its spawn to its hello, per spawn
        self.spawn_walls: Dict[int, float] = {}

        # coordinator-side SLO accounting: the metric names the
        # single-process engine publishes, observed at the coordinator's
        # clock (submit -> retire in coordinator phases), so the SLO
        # evaluator, the serve summary and the federated /metrics read
        # one surface on both paths. Under the process label these are
        # the "coordinator-merged counters" of the reconciliation
        # invariant: coordinator retired == sum over workers +
        # spillover completions.
        tel = self.telemetry
        self._c_retired = tel.registry.counter(
            "ppls_stream_retired_total", "requests retired with areas")
        self._c_tenant_retired = tel.registry.counter(
            "ppls_stream_tenant_retired_total",
            "requests retired, by tenant", ("tenant",))
        self._c_shed = tel.shed_counter()
        self._c_deadline = tel.registry.counter(
            "ppls_stream_deadline_exceeded_total",
            "in-flight requests retired failed at their phase "
            "deadline", ("tenant",))
        self._c_quarantined = tel.registry.counter(
            "ppls_stream_quarantined_total",
            "requests retired as failed through the NaN quarantine")
        self._c_spillover = tel.registry.counter(
            "ppls_stream_spillover_total",
            "requests completed on the CPU spillover backend "
            "instead of being shed")
        self._h_lat_phases = tel.latency_phases_histogram()
        self._h_lat_seconds = tel.latency_seconds_histogram()
        self._h_class_lat = tel.class_latency_histogram()
        self._h_tenant_lat = tel.tenant_latency_histogram()
        # federated metrics: worker registry dumps merge into one
        # process-labeled registry; the coordinator's own registry joins
        # under process="coordinator"
        self._federation = FederatedMetrics()
        # SLO burn-rate evaluator over the coordinator registry
        self._slo = None
        if slo_config is not None:
            from ppls_tpu_torch.obs.slo import SloEvaluator
            self._slo = SloEvaluator(slo_config, tel)
        # per-rid request spans (the coordinator owns the trace; workers
        # ship rid linkage back in their replies)
        self._rid_spans: Dict[int, object] = {}

        if fault_injector is not None:
            fault_injector.host_kill_fn = self.kill_process

        self._closed = False
        if not _defer_spawn:
            self._spawn(list(range(self.n_processes)))

    # -- bootstrap ---------------------------------------------------------

    def _worker_spec(self) -> dict:
        spec = {k: v for k, v in self.worker_kw.items()
                if k in _WORKER_ENGINE_KEYS and v is not None}
        if "rule" in spec:
            spec["rule"] = str(Rule(spec["rule"]).value)
        spec["family"] = self.family
        spec["eps"] = self.eps
        spec["device"] = self.device.type
        return spec

    def _spawn(self, process_ids: List[int]) -> None:
        self._workers = _spawn_workers(
            len(process_ids), self._worker_spec(),
            self.checkpoint_path, self._spawn_timeout,
            self._rpc_timeout, self.jax_distributed,
            process_ids=process_ids)
        for w in self._workers:
            self.spawn_walls[w.process_id] = w.spawn_s
            if w.hello.get("launches") is not None:
                self._launches[w.process_id] = dict(w.hello["launches"])
        self.manifest = ClusterManifest([
            {"process_id": w.process_id,
             "devices": int(w.hello.get("devices", 1)),
             "pid": int(w.hello.get("pid", 0)),
             "platform": w.hello.get("platform", "cpu"),
             "device": w.hello.get("device", "cpu"),
             "device_name": w.hello.get("device_name", "cpu")}
            for w in self._workers])
        from ppls_tpu_torch.obs.flight import ChipFlightRecorder
        self._flight = ChipFlightRecorder(
            self.telemetry, len(self._workers),
            engine="cluster-stream", span_name="process",
            labels=[w.process_id for w in self._workers])
        self.telemetry.event(
            "cluster_bootstrap",
            processes=self.manifest.n_processes,
            devices=self.manifest.identity()["devices"],
            jax_distributed=self.jax_distributed)

    def _live(self) -> List[WorkerHandle]:
        return list(self._workers)

    def _worker(self, process_id: int) -> Optional[WorkerHandle]:
        for w in self._workers:
            if w.process_id == int(process_id):
                return w
        return None

    def kill_process(self, process_id: Optional[int] = None) -> None:
        """SIGKILL one worker (the fault injector's host_loss hook: the
        real-process spelling of losing a host). The loss SURFACES at
        the next RPC, as a real dead host's would."""
        live = self._live()
        if not live:
            return
        if process_id is None or process_id < 0 \
                or self._worker(process_id) is None:
            w = live[-1]
        else:
            w = self._worker(process_id)
        self.telemetry.event("host_killed",
                             process=w.process_id, phase=self.phase)
        if w.proc.poll() is None:
            os.kill(w.proc.pid, signal.SIGKILL)
            w.proc.wait(timeout=30)

    # -- intake ------------------------------------------------------------

    def submit(self, theta, bounds, tenant: str = "default",
               priority: int = 1,
               deadline_phases: Optional[int] = None) -> int:
        from ppls_tpu_torch.models.integrands import check_ds_domain
        bounds = (float(bounds[0]), float(bounds[1]))
        # the single engine's pre-rid validation, mirrored: a malformed
        # request is rejected HERE with a per-request ValueError, not at
        # deal time in a worker (where it would come back as a fatal
        # whole-service RuntimeError)
        theta_block = int(self.worker_kw.get("theta_block", 1) or 1)
        if isinstance(theta, (tuple, list, np.ndarray)):
            thetas = tuple(float(t)
                           for t in np.asarray(theta).reshape(-1))
            if not thetas:
                raise ValueError("empty theta batch")
            if len(thetas) > theta_block:
                raise ValueError(
                    f"theta batch of {len(thetas)} exceeds the "
                    f"workers' theta_block={theta_block}")
            theta_store = thetas if len(thetas) > 1 else thetas[0]
        else:
            thetas = (float(theta),)
            theta_store = float(theta)
        check_ds_domain(self._f_ds,
                        np.tile(np.array([bounds]), (len(thetas), 1)),
                        np.array(thetas))
        tenant = str(tenant)
        if not tenant or len(tenant) > 128:
            raise ValueError(
                f"tenant must be a non-empty string of <= 128 chars, "
                f"got {tenant!r}")
        if deadline_phases is not None:
            deadline_phases = int(deadline_phases)
            if deadline_phases < 1:
                raise ValueError(
                    f"deadline_phases must be >= 1, got "
                    f"{deadline_phases}")
        grid = self._next_rid
        self._next_rid += 1
        ent = _LedgerEntry(
            grid=grid, theta=theta_store, bounds=bounds,
            tenant=str(tenant), priority=int(priority),
            deadline_phases=deadline_phases,
            submit_phase=self.phase, submit_t=time.perf_counter())
        self._ledger[grid] = ent
        # the rid's trace opens at the ack (the coordinator owns the
        # trace; worker hops link back by grid)
        self._rid_spans[grid] = self.telemetry.request_span(
            grid, tenant=ent.tenant, priority=ent.priority,
            submit_phase=ent.submit_phase)
        if self.queue_limit is not None \
                and len(self._pending) >= self.queue_limit:
            victim_grid = min(
                self._pending,
                key=lambda g: (self._ledger[g].priority, g))
            victim = self._ledger[victim_grid]
            if victim.priority < ent.priority:
                self._pending.remove(victim_grid)
                self._pending.append(grid)
                self._shed_or_spill(victim)
            else:
                self._shed_or_spill(ent)
            return grid
        self._pending.append(grid)
        return grid

    def _shed_or_spill(self, ent: _LedgerEntry) -> None:
        """Overload policy: a queue-overflow victim routes to the CPU
        spillover backend when one is armed and the request is
        spill-eligible (no deadline: slower capacity cannot bound
        latency); otherwise it sheds with the explicit record."""
        spillable = (self._spill is not None
                     and ent.deadline_phases is None)
        if spillable and len(self._spill_queue) < self._spill_cap:
            ent.state = "spill"
            self._spill_queue.append(ent.grid)
            self.telemetry.request_event(
                self._rid_spans.get(ent.grid), "spillover_enqueued",
                rid=ent.grid, tenant=ent.tenant, phase=self.phase,
                submit_phase=ent.submit_phase)
            return
        from ppls_tpu_torch.runtime.stream import ShedRecord
        ent.state = "shed"
        reason = ("spill_queue_full" if spillable else "queue_full")
        rec = ShedRecord(
            rid=ent.grid, theta=ent.theta, bounds=ent.bounds,
            tenant=ent.tenant, priority=ent.priority,
            reason=reason, phase=self.phase,
            submit_phase=ent.submit_phase)
        self.shed.append(rec)
        self._c_shed.labels(tenant=ent.tenant, reason=reason).inc()
        span = self._rid_spans.pop(ent.grid, None)
        self.telemetry.request_event(
            span, "request_shed", rid=ent.grid, tenant=ent.tenant,
            priority=ent.priority, reason=reason,
            phase=self.phase, submit_phase=ent.submit_phase)
        if span is not None:
            span.close(disposition="shed", reason=reason,
                       phase=self.phase)

    def _adopt_worker_shed(self, ent: "_LedgerEntry", rec: dict,
                           process_id: int) -> None:
        """A worker-side shed (deadline unmeetable on its queue) is a
        TERMINAL outcome: adopt it into the coordinator ledger, or the
        entry would stay 'dealt' forever and the cluster would never go
        idle."""
        from ppls_tpu_torch.runtime.stream import ShedRecord
        ent.state = "shed"
        reason = rec.get("reason", "worker_shed")
        self.shed.append(ShedRecord(
            rid=ent.grid, theta=ent.theta, bounds=ent.bounds,
            tenant=ent.tenant, priority=ent.priority,
            reason=reason,
            phase=self.phase, submit_phase=ent.submit_phase))
        self._c_shed.labels(tenant=ent.tenant, reason=reason).inc()
        span = self._rid_spans.pop(ent.grid, None)
        self.telemetry.request_event(
            span, "request_shed", rid=ent.grid, tenant=ent.tenant,
            priority=ent.priority, reason=reason,
            process=process_id, phase=self.phase,
            submit_phase=ent.submit_phase)
        if span is not None:
            span.close(disposition="shed", reason=reason,
                       phase=self.phase)

    @property
    def next_rid(self) -> int:
        return self._next_rid

    @property
    def pending(self) -> int:
        return len(self._pending)

    @property
    def idle(self) -> bool:
        if self._pending or self._spill_queue:
            return False
        return not any(e.state == "dealt"
                       for e in self._ledger.values())

    # -- the phase loop ----------------------------------------------------

    def _deal(self) -> None:
        """Round-robin deal of the undealt queue over the live process
        set, in grid order (the deterministic deal); each worker's own
        engine then admits into slots at ITS phase boundary."""
        live = self._live()
        if not live or not self._pending:
            return
        batches: Dict[int, List[int]] = {}
        for grid in sorted(self._pending):
            w = live[self._rr % len(live)]
            self._rr += 1
            batches.setdefault(w.process_id, []).append(grid)
        self._pending = []
        todo = [w for w in live if w.process_id in batches]
        for i, w in enumerate(todo):
            reqs = []
            for g in batches[w.process_id]:
                ent = self._ledger[g]
                ent.assigned = w.process_id
                ent.state = "dealt"
                if ent.dealt_phase is None:
                    ent.dealt_phase = self.phase
                reqs.append(ent.payload())
                # the deal is the admit edge of the rid's trace: queue
                # wait decomposes here, and the hop names the worker
                # process the request landed on
                self.telemetry.request_event(
                    self._rid_spans.get(g), "request_dealt",
                    rid=g, process=w.process_id, phase=self.phase,
                    submit_phase=ent.submit_phase,
                    queue_wait_phases=self.phase - ent.submit_phase)
            try:
                # the trace context's outbound leg: rid is in each
                # payload's grid; the segment id names the events
                # segment the coordinator's spans live in
                w.call({"cmd": "submit", "reqs": reqs,
                        "trace": {
                            "segment": self.telemetry.tracer.segment}})
            except WorkerLost:
                # batches not yet SENT roll back to pending (the next
                # deal re-assigns them over whatever survives); this
                # worker's batch stays dealt-to-the-dead, which
                # recover_host_loss re-deals from the ledger: nothing is
                # stranded in a state no recovery arm covers
                for w2 in todo[i + 1:]:
                    for g in batches[w2.process_id]:
                        ent = self._ledger[g]
                        ent.assigned = None
                        ent.state = "pending"
                        self._pending.append(g)
                raise

    def _complete(self, ent: _LedgerEntry, rec: dict,
                  spillover: bool = False) -> object:
        from ppls_tpu_torch.runtime.stream import CompletedRequest
        now = time.perf_counter()
        # the admit edge of the trace: the deal phase (or the
        # spillover/retire phase for requests that never dealt)
        admit_phase = (ent.dealt_phase if ent.dealt_phase is not None
                       else self.phase)
        c = CompletedRequest(
            rid=ent.grid, theta=ent.theta, bounds=ent.bounds,
            area=(float("nan") if rec.get("failed")
                  else float(rec["area"])),
            areas=rec.get("areas"),
            submit_phase=ent.submit_phase,
            admit_phase=admit_phase,
            retire_phase=self.phase,
            latency_s=now - ent.submit_t,
            first_seeded_phase=-1, last_credited_phase=-1,
            failed=bool(rec.get("failed")),
            tenant=ent.tenant, priority=ent.priority,
            failure=rec.get("failure"),
            spillover=spillover)
        ent.state = "done"
        self.completed.append(c)
        # coordinator-side SLO accounting, through the one helper the
        # resume replay shares
        self._publish_retirement(c)
        span = self._rid_spans.pop(c.rid, None)
        self.telemetry.request_event(
            span, "retire", rid=c.rid,
            process=(-1 if spillover else ent.assigned),
            area=(None if c.failed else c.area),
            failed=c.failed,
            **({"failure": c.failure} if c.failure else {}),
            spillover=spillover,
            submit_phase=c.submit_phase,
            admit_phase=c.admit_phase,
            retire_phase=self.phase,
            latency_phases=c.latency_phases,
            tenant=c.tenant, priority=c.priority)
        if span is not None:
            span.close(
                disposition=("failed" if c.failed else "retired"),
                **({"failure": c.failure} if c.failure else {}),
                retire_phase=c.retire_phase,
                latency_phases=c.latency_phases)
        return c

    def _run_spillover(self, retired: list) -> None:
        n = 0
        while self._spill_queue and n < self.spillover_limit:
            grid = self._spill_queue.pop(0)
            ent = self._ledger[grid]
            try:
                areas, tasks, _wall = self._spill.run(
                    ent.theta, ent.bounds)
            except FloatingPointError:
                # the quarantine covers the spillover path too: a
                # poisoned request becomes a FAILED record, never an
                # engine-wide abort stranding healthy work
                if not self.quarantine:
                    raise
                self.telemetry.request_event(
                    self._rid_spans.get(ent.grid), "quarantine",
                    rid=ent.grid, phase=self.phase, spillover=True)
                rec = {"area": None, "failed": True,
                       "failure": "nan", "areas": None}
            else:
                rec = {"area": areas[0], "failed": False,
                       "areas": (list(areas)
                                 if isinstance(ent.theta,
                                               (tuple, list))
                                 else None)}
            retired.append(self._complete(ent, rec, spillover=True))
            n += 1

    def step(self) -> list:
        """One coordinator phase: deal -> step every worker -> collect
        retirements -> spillover batch -> checkpoint."""
        tel = self.telemetry
        if self.fault_injector is not None:
            self.fault_injector.on_phase_open(
                self.phase, n_dev=len(self._live()))
        span = tel.span("phase", phase=self.phase)
        retired: list = []
        try:
            self._deal()
            live = self._live()
            tasks, wsteps, rows = [], [], []
            # parallel fan-out: every worker's step command goes out
            # BEFORE any reply is read, so the N phase programs run
            # concurrently (an N-host phase costs ~max, not ~sum). A
            # loss mid-round is held until the survivors' replies are
            # consumed: the newline protocol stays in sync and their
            # retirements are not dropped.
            lost: Optional[WorkerLost] = None
            stepped = []
            for w in live:
                try:
                    w.send_cmd({"cmd": "step"})
                    stepped.append(w)
                except WorkerLost as e:
                    lost = lost or e
            rid_rows: List[list] = []
            fed_dumps: Dict[str, dict] = {}
            for w in stepped:
                try:
                    rep = w.recv_reply()
                except WorkerLost as e:
                    lost = lost or e
                    continue
                tasks.append(int(rep.get("tasks", 0)))
                wsteps.append(int(rep.get("wsteps", 0)))
                rows.append(int(rep.get("live", 0)))
                self._wtasks_total += int(rep.get("wtasks", 0))
                if rep.get("launches") is not None:
                    self._launches[w.process_id] = dict(rep["launches"])
                if rep.get("metrics") is not None:
                    # the worker's cumulative registry dump rode the
                    # step reply
                    fed_dumps[str(w.process_id)] = rep["metrics"]
                # trace linkage, the return leg: every rid live on this
                # worker this phase (still resident + retired this
                # phase) gets a request_phase hop naming the process and
                # this phase span, emitted BEFORE retirement adoption
                # closes the rid spans
                phase_rids = sorted(
                    set(int(g) for g in rep.get("resident_grids", ()))
                    | {int(r["grid"]) for r in rep.get("retired", ())})
                rid_rows.append(phase_rids)
                for g in phase_rids:
                    tel.request_event(
                        self._rid_spans.get(g), "request_phase",
                        rid=g, process=w.process_id, phase=self.phase,
                        phase_span=span.sid)
                for rec in rep.get("retired", ()):
                    ent = self._ledger.get(int(rec["grid"]))
                    if ent is None or ent.state == "done":
                        continue
                    retired.append(self._complete(ent, rec))
                for rec in rep.get("shed", ()):
                    ent = self._ledger.get(int(rec["grid"]))
                    if ent is None or ent.state in ("done", "shed"):
                        continue
                    self._adopt_worker_shed(ent, rec, w.process_id)
            if lost is not None:
                raise lost
            for pid, dump in sorted(fed_dumps.items()):
                self._federation.ingest_dump(pid, dump)
            if live:
                self._flight.record_phase(
                    self.phase, wsteps=wsteps, tasks=tasks,
                    live_rows=rows,
                    bank_delta=[0] * len(live),
                    rids=rid_rows)
                self._tasks_total += sum(tasks)
                self._wsteps_total += sum(wsteps)
            # the cross-process occupancy sum
            occupancy = sum(rows)
            self._run_spillover(retired)
        except WorkerLost as e:
            span.close(error="host_loss", process=e.process_id)
            raise HostLossError(
                e.process_id, len(self._live()),
                detail=str(e)) from e
        self.phase += 1
        self._phases_after_recovery += 1
        if self._slo is not None:
            # burn-rate evaluation over the coordinator registry this
            # boundary just published into
            self._slo.evaluate_slo(self.phase)
        # the coordinator's own registry joins the federated surface
        # under process="coordinator", AFTER this phase's retire/SLO
        # publishes, so the exposed cut is phase-consistent
        from ppls_tpu_torch.obs.federation import COORDINATOR
        self._federation.ingest_dump(
            COORDINATOR, self.telemetry.registry.dump())
        span.close(retired=len(retired), occupancy=int(occupancy),
                   processes=len(self._live()))
        if self.checkpoint_path and \
                self.phase % self.checkpoint_every == 0:
            try:
                self.snapshot()
            except WorkerLost as e:
                # a host dying at the checkpoint cut is a host loss, not
                # a transient: classify it so the supervisor runs
                # discovery + redeal instead of a blind backoff-rerun
                raise HostLossError(
                    e.process_id, len(self._live()),
                    detail=str(e)) from e
        if self.fault_injector is not None:
            self.fault_injector.on_phase_close(
                self.phase - 1, n_dev=len(self._live()))
        return retired

    def drain(self, max_phases: int = 1 << 12) -> list:
        done = []
        phases = 0
        while not self.idle:
            done.extend(self.step())
            phases += 1
            if phases >= max_phases:
                raise RuntimeError(
                    f"cluster did not drain in {max_phases} phases")
        return done

    def run(self, requests, arrival_phase=None,
            _crash_after_phases: Optional[int] = None):
        t0 = time.perf_counter()
        sched = ([0] * len(requests) if arrival_phase is None
                 else [int(p) for p in arrival_phase])
        order = sorted(range(len(requests)), key=lambda i: sched[i])
        queue = [(sched[i], requests[i]) for i in order]
        k = 0
        phases = 0
        while k < len(queue) or not self.idle:
            while k < len(queue) and queue[k][0] <= self.phase:
                r = queue[k][1]
                kw2 = r[2] if len(r) > 2 else {}
                self.submit(r[0], r[1], **kw2)
                k += 1
            self.step()
            phases += 1
            if _crash_after_phases is not None \
                    and phases >= _crash_after_phases:
                raise RuntimeError(
                    f"simulated crash after {phases} phases "
                    f"(test hook)")
            if phases > (1 << 12):
                raise RuntimeError("cluster stream did not converge")
        return self.result(wall_s=time.perf_counter() - t0)

    def launches(self) -> Dict[str, dict]:
        """Each worker process's cumulative K1/K2 launches as it last
        reported them, by process id (a lost worker keeps its last
        report)."""
        return {str(p): dict(v) for p, v in sorted(self._launches.items())}

    def result(self, wall_s: float = 0.0) -> ClusterStreamResult:
        from ppls_tpu_torch.parallel.walker import STREAM_STAT_FIELDS
        return ClusterStreamResult(
            completed=list(self.completed), phases=self.phase,
            wall_s=wall_s,
            totals={"tasks": self._tasks_total,
                    "wtasks": self._wtasks_total,
                    "wsteps": self._wsteps_total},
            phase_stats=np.zeros((0, len(STREAM_STAT_FIELDS)),
                                 np.int64),
            shed=list(self.shed),
            cluster={"launches": self.launches()})

    def spillover_summary(self) -> dict:
        done = [c for c in self.completed
                if getattr(c, "spillover", False)]
        total = len(self.completed)
        tasks = (self._spill.tasks_total
                 if self._spill is not None else 0)
        return {
            "spillover_completed": len(done),
            "spillover_fraction": (len(done) / total if total
                                   else 0.0),
            "spillover_tasks": int(tasks),
        }

    @property
    def federated_registry(self):
        """The ONE cluster metrics surface: every worker's registry
        merged under its ``process`` label plus the coordinator's own
        under ``process="coordinator"``; what ``serve --metrics-port``
        exposes on the cluster path."""
        return self._federation.registry

    def federation_reconcile(self):
        """Problem list for the federation reconciliation invariant
        (empty = every federated child equals the matching process's
        own cumulative value; see ``obs/federation.py``)."""
        return self._federation.reconcile()

    def slo_health(self) -> dict:
        """The /health verdict, the shape of ``StreamEngine.slo_health``
        so the serve CLI wires either."""
        if self._slo is None:
            return {"ok": True, "burning": [], "phase": self.phase}
        return self._slo.health()

    # -- surviving-host discovery + redeal ---------------------------------

    def discover(self) -> List[int]:
        """Ping every worker; reap the dead; return the surviving process
        ids: the DISCOVERED topology, not a hand-built one."""
        survivors, dead = [], []
        for w in list(self._workers):
            if w.ping():
                survivors.append(w)
            else:
                dead.append(w)
        for w in dead:
            self.manifest.drop(w.process_id)
            w.reap()
            self._workers.remove(w)
        self.telemetry.event(
            "host_loss_discovery",
            survivors=[w.process_id for w in survivors],
            lost=[w.process_id for w in dead], phase=self.phase)
        return [w.process_id for w in survivors]

    def _redeal_rows(self, rows: Dict[int, List[int]]) -> int:
        """The one deal arm both recovery paths share: per-host grid rows
        (the n-host layout) re-deal over the LIVE process set through
        ``mesh.host_strided_redeal``, each survivor receiving its share
        as a submit batch. Returns the rows moved."""
        from ppls_tpu_torch.parallel.mesh import host_strided_redeal
        live = sorted(w.process_id for w in self._live())
        if not rows or not live:
            return 0
        hosts = sorted(rows)
        counts = np.array([len(rows[h]) for h in hosts],
                          dtype=np.int64)
        b = max(int(counts.max()), 1)
        col = np.full((len(hosts), b), -1, dtype=np.int64)
        for i, h in enumerate(hosts):
            col[i, :counts[i]] = rows[h]
        dealt, new_counts = host_strided_redeal(
            {"grid": col}, counts, len(live), fills={"grid": -1})
        moved = 0
        for d, w_pid in enumerate(live):
            grids = sorted(int(v) for v in
                           dealt["grid"][d][:new_counts[d]])
            if not grids:
                continue
            reqs = []
            for g in grids:
                ent = self._ledger[g]
                prev = ent.assigned
                ent.assigned = w_pid
                reqs.append(ent.payload())
                # the redeal-after-host-loss hop on the rid's trace:
                # from the lost process to the survivor it re-dealt onto
                self.telemetry.request_event(
                    self._rid_spans.get(g), "request_redeal",
                    rid=g, from_process=prev, process=w_pid,
                    phase=self.phase)
            self._worker(w_pid).call({"cmd": "submit",
                                      "reqs": reqs})
            moved += len(reqs)
        return moved

    def recover_host_loss(self, exc=None) -> int:
        """The supervisor's ``host_loss`` recovery: discover the
        surviving topology, then re-deal every lost host's outstanding
        requests onto the survivors through ``mesh.host_strided_redeal``.
        Returns the surviving process count. Raises the original error
        when nothing survives."""
        t0 = time.perf_counter()
        survivors = self.discover()
        if not survivors:
            raise exc if exc is not None else HostLossError(
                -1, 0, detail="no survivors")
        live_set = set(survivors)
        # outstanding grids whose assigned process no longer exists,
        # grouped per lost process (the n-host rows host_strided_redeal
        # deals from)
        lost_rows: Dict[int, List[int]] = {}
        for g in sorted(self._ledger):
            ent = self._ledger[g]
            if ent.state == "dealt" and ent.assigned not in live_set:
                lost_rows.setdefault(int(ent.assigned), []).append(g)
        moved = self._redeal_rows(lost_rows)
        # survivors reconcile too: a loss mid-phase can drop a step reply
        # on the floor; adopt any completion the coordinator missed and
        # re-submit anything a survivor never received (the ledger
        # replay the corrupt-snapshot path uses)
        self._reconcile_workers(states={
            w.process_id: w.call({"cmd": "state"})
            for w in self._live()})
        # the flight recorder re-targets the surviving topology (the
        # per-process streak history cannot survive a re-deal)
        from ppls_tpu_torch.obs.flight import ChipFlightRecorder
        self._flight = ChipFlightRecorder(
            self.telemetry, len(survivors), engine="cluster-stream",
            span_name="process", labels=sorted(survivors))
        wall = time.perf_counter() - t0
        self.redeal_walls.append(wall)
        self._phases_after_recovery = 0
        self.telemetry.event(
            "cluster_redeal", survivors=survivors, rows=moved,
            wall_s=round(wall, 4), phase=self.phase)
        return len(survivors)

    # -- snapshot / resume -------------------------------------------------

    def _identity(self, cluster: Optional[dict] = None) -> dict:
        from ppls_tpu_torch.runtime.checkpoint import engine_name
        ident = {"engine": engine_name("cluster-stream", self.rule),
                 "fname": self.family, "eps": self.eps,
                 "cluster": (cluster if cluster is not None
                             else self.manifest.identity())}
        wk = self.worker_kw
        for k in ("slots", "chunk", "capacity", "lanes",
                  "refill_slots", "f64_rounds", "theta_block"):
            if k in wk and wk[k] is not None:
                ident[k] = int(wk[k])
        return ident

    def snapshot(self) -> None:
        """The coordinated cut: workers snapshot at this boundary first,
        then the coordinator ledger (a torn cut leaves workers AHEAD,
        which resume reconciles by adopting their completions, never
        behind with work silently lost)."""
        if not self.checkpoint_path:
            raise ValueError("no checkpoint_path configured")
        from ppls_tpu_torch.runtime.checkpoint import save_family_checkpoint
        for w in self._live():
            w.call({"cmd": "snapshot"})
        totals = {
            "phase": self.phase, "next_rid": self._next_rid,
            "rr": self._rr,
            "ledger": [dict(e.payload(), submit_phase=e.submit_phase,
                            assigned=e.assigned, state=e.state,
                            dealt_phase=e.dealt_phase)
                       for e in (self._ledger[g]
                                 for g in sorted(self._ledger))],
            "pending": sorted(self._pending),
            "spill_queue": list(self._spill_queue),
            "completed": [dataclasses.asdict(c)
                          for c in self.completed],
            "shed": [dataclasses.asdict(s) for s in self.shed],
            "client_state": dict(self.client_state),
            "tasks_total": int(self._tasks_total),
            "wtasks_total": int(self._wtasks_total),
            "wsteps_total": int(self._wsteps_total),
            "spill_requests_total": int(
                self._spill.requests_total if self._spill else 0),
            "spill_tasks_total": int(
                self._spill.tasks_total if self._spill else 0),
        }
        save_family_checkpoint(
            self.checkpoint_path, identity=self._identity(),
            bag_cols={}, count=0, acc=np.zeros(1), totals=totals)
        self.telemetry.event(
            "checkpoint", phase=self.phase,
            pending=len(self._pending),
            completed=len(self.completed))
        if self.fault_injector is not None:
            self.fault_injector.on_checkpoint_write(
                self.checkpoint_path)

    @classmethod
    def resume(cls, checkpoint_path: str, family: str, eps: float,
               cluster_resize: bool = False, **kwargs
               ) -> "ClusterStreamEngine":
        """Rebuild a cluster from its coordinator snapshot.

        Same topology: workers resume their own per-process snapshots
        and the coordinator reconciles (adopting completions newer than
        its cut; re-submitting anything a fresh/corrupt worker lost).
        Different topology (``n_processes`` != the manifest): refuses
        unless ``cluster_resize=True``; then every outstanding request
        re-deals over the new process set from the ledger
        (request-granularity redeal, both directions)."""
        from ppls_tpu_torch.runtime.checkpoint import load_family_checkpoint
        from ppls_tpu_torch.runtime.stream import (CompletedRequest,
                                                   ShedRecord)
        eng = cls(family, eps, checkpoint_path=checkpoint_path,
                  _defer_spawn=True, **kwargs)
        # Read the STORED manifest first: worker device counts are
        # unknowable before spawning, so when the process count matches
        # the identity comparison claims the stored cluster (and
        # re-verifies against the ACTUAL spawned manifest below); a
        # different process count leaves the cluster key differing,
        # which load_family_checkpoint refuses unless the caller passed
        # cluster_resize=True: the deliberate-resize gate.
        stored_cluster: dict = {}
        try:
            with np.load(checkpoint_path) as z:
                meta = json.loads(bytes(z["meta"]).decode())
            stored_cluster = dict(
                meta.get("identity", {}).get("cluster") or {})
        except Exception:   # noqa: BLE001 -- the verified load below
            pass            # produces the proper corrupt/IO error
        same_count = (int(stored_cluster.get("processes", -1))
                      == eng.n_processes)
        claim = (stored_cluster if same_count
                 else {"processes": eng.n_processes, "devices": []})
        bag_cols, _count, _acc, totals = load_family_checkpoint(
            checkpoint_path, eng._identity(cluster=claim),
            cluster_resize=cluster_resize)
        resized = not same_count

        eng.phase = int(totals["phase"])
        eng._next_rid = int(totals["next_rid"])
        eng._rr = int(totals.get("rr", 0))
        eng._tasks_total = int(totals.get("tasks_total", 0))
        eng._wtasks_total = int(totals.get("wtasks_total", 0))
        eng._wsteps_total = int(totals.get("wsteps_total", 0))
        if eng._spill is not None:
            # the spillover engagement survives the restart with
            # everything else (spillover_summary reads the executor's
            # live counters)
            eng._spill.requests_total = int(
                totals.get("spill_requests_total", 0))
            eng._spill.tasks_total = int(
                totals.get("spill_tasks_total", 0))
        eng.client_state = dict(totals.get("client_state", {}))
        for d in totals["ledger"]:
            ent = _LedgerEntry.from_payload(d)
            ent.assigned = d.get("assigned")
            ent.state = d.get("state", "pending")
            ent.dealt_phase = d.get("dealt_phase")
            eng._ledger[ent.grid] = ent
        eng._pending = [int(g) for g in totals.get("pending", [])]
        eng._spill_queue = [int(g)
                            for g in totals.get("spill_queue", [])]
        if eng._spill_queue and eng._spill is None:
            # without the backend the queue can never drain: idle stays
            # False forever while every phase is a no-op; acknowledged
            # requests must not be silently stranded
            eng.close()
            raise ValueError(
                f"snapshot carries {len(eng._spill_queue)} "
                f"spillover-queued request(s) but spillover is not "
                f"armed on this resume; pass spillover=True")

        def _theta_in(v):
            return tuple(v) if isinstance(v, list) else v

        eng.completed = [CompletedRequest(
            **{k: (tuple(v) if k == "bounds"
                   else _theta_in(v) if k == "theta" else v)
               for k, v in d.items()})
            for d in totals.get("completed", [])]
        eng.shed = [ShedRecord(
            **{k: (tuple(v) if k == "bounds"
                   else _theta_in(v) if k == "theta" else v)
               for k, v in d.items()})
            for d in totals.get("shed", [])]
        done = {c.rid for c in eng.completed}
        for rid in done:
            if rid in eng._ledger:
                eng._ledger[rid].state = "done"
        # rebuild the coordinator's SLO-accounting registry from the
        # restored record (StreamEngine._replay_registry's discipline),
        # and re-open request spans for every non-terminal rid so the
        # appended events segment keeps its rid linkage
        eng._replay_registry()
        if eng._slo is not None:
            # burn windows re-base at resume (see StreamEngine.resume)
            eng._slo.seed_base(eng.phase)
        for g in sorted(eng._ledger):
            ent = eng._ledger[g]
            if ent.state in ("pending", "dealt", "spill"):
                eng._rid_spans[g] = eng.telemetry.request_span(
                    g, tenant=ent.tenant, priority=ent.priority,
                    submit_phase=ent.submit_phase)

        if resized:
            # cross-topology: stale per-process snapshots must not be
            # resumed by the new workers (their assignment map no longer
            # exists)
            for i in range(max(int(stored_cluster["processes"]),
                               eng.n_processes) + 1):
                p = f"{checkpoint_path}.p{i}"
                if os.path.exists(p):
                    os.unlink(p)
        eng._spawn(list(range(eng.n_processes)))
        if not resized \
                and eng.manifest.identity() != stored_cluster:
            # same process count but the per-process device picture
            # changed (another host class): still a topology change,
            # deliberate only
            if not cluster_resize:
                eng.close()
                raise ValueError(
                    f"checkpoint {checkpoint_path!r} belongs to a "
                    f"different cluster topology (stored "
                    f"{stored_cluster}, actual "
                    f"{eng.manifest.identity()}); pass "
                    f"cluster_resize=True to re-deal onto it")
        eng.telemetry.event(
            "cluster_resume", phase=eng.phase,
            processes=eng.n_processes, resized=bool(resized))

        if resized:
            eng._redeal_all_outstanding()
        else:
            eng._reconcile_workers()
        return eng

    def _redeal_all_outstanding(self) -> None:
        """Cross-topology resume: every dealt-but-uncompleted request
        re-deals over the new process set via ``host_strided_redeal``
        (its old per-process assignment rows are the deal input), and
        undealt pending stays pending."""
        t0 = time.perf_counter()
        rows: Dict[int, List[int]] = {}
        for g in sorted(self._ledger):
            ent = self._ledger[g]
            if ent.state == "dealt":
                rows.setdefault(int(ent.assigned or 0), []).append(g)
        moved = self._redeal_rows(rows)
        self.redeal_walls.append(time.perf_counter() - t0)
        self.telemetry.event(
            "cluster_redeal",
            survivors=[w.process_id for w in self._live()],
            rows=moved,
            wall_s=round(self.redeal_walls[-1], 4), phase=self.phase)

    def _publish_retirement(self, c) -> None:
        """The ONE registry-publication site for a completed record,
        called at live completion (``_complete``) and at resume replay
        (``_replay_registry``), so a metric added to one can never
        undercount in the other."""
        self._c_retired.inc()
        self._c_tenant_retired.labels(tenant=c.tenant).inc()
        self._h_lat_phases.observe(c.latency_phases)
        self._h_lat_seconds.observe(c.latency_s)
        self._h_class_lat.labels(priority=str(c.priority)) \
            .observe(c.latency_phases)
        self._h_tenant_lat.labels(tenant=c.tenant) \
            .observe(c.latency_phases)
        if getattr(c, "spillover", False):
            self._c_spillover.inc()
        if c.failed:
            if c.failure == "deadline_exceeded":
                self._c_deadline.labels(tenant=c.tenant).inc()
            else:
                self._c_quarantined.inc()

    def _replay_registry(self) -> None:
        """Coordinator-registry replay at resume: the restored
        completed/shed records re-publish through ``_publish_retirement``
        (latency_s re-observes the recorded wall values; the seconds
        histogram is the one nondeterministic surface)."""
        for c in self.completed:
            self._publish_retirement(c)
        for s in self.shed:
            self._c_shed.labels(tenant=s.tenant, reason=s.reason).inc()

    def _reconcile_workers(
            self, states: Optional[Dict[int, dict]] = None) -> None:
        """Adopt worker-reported completions the coordinator does not
        hold, and re-submit anything a worker lost. Two callers: the
        same-topology resume (state = each worker's hello, covering the
        fresh start after a corrupt snapshot) and host-loss recovery
        (state = a live ``state`` RPC per survivor, covering step
        replies dropped by the loss)."""
        for w in self._live():
            st = (states[w.process_id] if states is not None
                  else w.hello)
            if st.get("launches") is not None:
                self._launches[w.process_id] = dict(st["launches"])
            if st.get("metrics") is not None:
                # federation catches up on whatever the lost replies
                # dropped (cumulative dumps: delta-safe)
                self._federation.ingest_dump(str(w.process_id),
                                             st["metrics"])
            if st.get("corrupt"):
                self.telemetry.event(
                    "worker_snapshot_corrupt",
                    process=w.process_id,
                    detail=str(st["corrupt"])[:200])
            for rec in st.get("completed", ()):
                ent = self._ledger.get(int(rec["grid"]))
                if ent is not None and ent.state != "done":
                    self._complete(ent, rec)
            for rec in st.get("shed", ()):
                ent = self._ledger.get(int(rec["grid"]))
                if ent is not None \
                        and ent.state not in ("done", "shed"):
                    self._adopt_worker_shed(ent, rec, w.process_id)
            held = set(int(g) for g in st.get("outstanding", ()))
            held |= {int(r["grid"])
                     for r in st.get("completed", ())}
            held |= {int(r["grid"]) for r in st.get("shed", ())}
            missing = []
            for g in sorted(self._ledger):
                ent = self._ledger[g]
                if ent.state == "dealt" \
                        and ent.assigned == w.process_id \
                        and g not in held:
                    missing.append(ent.payload())
            if missing:
                w.call({"cmd": "submit", "reqs": missing})
                self.telemetry.event(
                    "worker_replay", process=w.process_id,
                    rows=len(missing))

    def clear_snapshot(self) -> None:
        """Remove the coordinator snapshot and every per-process sibling
        (a drained run leaves no restart state behind)."""
        if not self.checkpoint_path:
            return
        import glob
        for p in ([self.checkpoint_path]
                  + glob.glob(f"{self.checkpoint_path}.p*")):
            if os.path.exists(p):
                os.unlink(p)

    # -- lifecycle ---------------------------------------------------------

    def close(self, graceful: bool = True) -> None:
        """Stop every worker and wait for it. ``graceful=False`` skips
        the exit RPC and SIGKILLs straight away: the spelling for
        tearing down a cluster whose command/reply pairing may be
        desynced (a watchdog abandoned a thread mid-RPC); writing on
        such a socket could block or confuse a live worker, killing it
        cannot."""
        if self._closed:
            return
        self._closed = True
        for w in self._workers:
            if not graceful:
                w.kill()
            w.close(graceful=graceful)
        self._workers = []

    def __enter__(self) -> "ClusterStreamEngine":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:   # noqa: BLE001 -- interpreter teardown
            pass


if __name__ == "__main__":
    sys.exit(worker_main())
