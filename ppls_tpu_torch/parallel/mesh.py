"""The mesh across devices: one process per rank on ``torch.distributed``.

The reference runs one controller over a 1-D ``jax.sharding.Mesh`` and
one ``shard_map`` program per leg, with ``lax.psum``, ``lax.all_gather``
and ``lax.axis_index`` inside it. Here each rank is a process that runs
its own host loop over tensors on its own device; a :class:`Mesh` holds
the process group, the rank (the ``axis_index``), the world size, the
rank's device and the transport. Every collective goes through
:meth:`Mesh.psum`, :meth:`Mesh.all_gather` or :meth:`Mesh.axis_index`,
which count their calls by kind (``sum``, ``gather``, ``rank``). A loop
condition that the reference replicates with a ``psum`` is here a value
that every rank computes from the same collective, so every rank takes
the same branch and meets the next collective in the same order.

The transport is chosen, never substituted: NCCL when every rank owns a
card, gloo otherwise (several ranks on one card, or the CPU). gloo's
CUDA support does not cover every collective, so with CUDA tensors the
gloo transport stages each operand through host memory; the result's
``mesh`` record says so (``host_staged``) and each staging counts as a
host sync.

The engines' entry points keep the reference's one-call signature with
``n_devices`` (:func:`spmd_entry`): inside an initialized process group
the call is the SPMD body on every rank; outside one, :func:`launch`
starts the ranks (in-process for one rank, else ``torch.multiprocessing``
spawn with a TCP store on 127.0.0.1, rank r on ``cuda:(r %
device_count)``) and returns rank 0's result. A hang fails the launch at
its time limit.

A stream keeps its state on its ranks between phases, so it holds a
:class:`World` instead: rank 0 in the caller's process, ranks 1..N-1
spawned once and looping on rank 0's commands, over a process group the
world owns (its own TCP store, never the default group, so the caller
can still run every other entry point beside it).
"""

from __future__ import annotations

import dataclasses
import datetime
import functools
import importlib
import os
import pickle
import queue
import signal
import socket
import time
import traceback
import weakref
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ppls_tpu_torch.parallel.bag_engine import dyn_slice
from ppls_tpu_torch.utils.device import HostSyncs, resolve_device

COLLECTIVES = ("sum", "gather", "rank")
LAUNCH_TIMEOUT_S = 3600.0
# a persistent world's time limit for one command (and one collective)
WORLD_TIMEOUT_S = 900.0


@dataclasses.dataclass
class Mesh:
    """One rank's view of the 1-D mesh."""

    rank: int
    size: int
    device: torch.device
    backend: str                       # "nccl" or "gloo"
    group: object                      # the process group
    calls: Dict[str, int] = dataclasses.field(
        default_factory=lambda: dict.fromkeys(COLLECTIVES, 0))
    syncs: HostSyncs = dataclasses.field(default_factory=HostSyncs)

    @property
    def host_staged(self) -> bool:
        """True when CUDA operands go through host memory (gloo)."""
        return self.backend == "gloo" and self.device.type == "cuda"

    def record(self) -> dict:
        """The transport and this rank's collective calls, for results."""
        return {"backend": self.backend, "host_staged": self.host_staged,
                "world": self.size, "device": str(self.device),
                "collective_calls": dict(self.calls)}

    def axis_index(self) -> int:
        """This rank's index on the mesh (``lax.axis_index``)."""
        self.calls["rank"] += 1
        return self.rank

    @property
    def wire(self) -> torch.device:
        """Where collective operands live: the card for NCCL, host memory
        for gloo."""
        return self.device if self.backend == "nccl" else torch.device("cpu")

    def _to_wire(self, t: torch.Tensor) -> torch.Tensor:
        if t.device.type == "cuda" and self.wire.type == "cpu":
            self.syncs.n += 1          # the staging copy waits for the card
        return t.to(self.wire).contiguous()

    def psum(self, t: torch.Tensor) -> torch.Tensor:
        """The elementwise sum of ``t`` over the ranks, on ``t``'s
        device (``lax.psum``)."""
        self.calls["sum"] += 1
        buf = self._to_wire(t).clone()
        dist.all_reduce(buf, group=self.group)
        return buf.to(t.device)

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` of every rank stacked in rank order, (size, *t.shape), on
        ``t``'s device (``lax.all_gather``)."""
        self.calls["gather"] += 1
        buf = self._to_wire(t)
        outs = [torch.empty_like(buf) for _ in range(self.size)]
        dist.all_gather(outs, buf, group=self.group)
        return torch.stack(outs).to(t.device)

    def _host_ints(self, values: Sequence[int]) -> torch.Tensor:
        return torch.tensor([int(v) for v in values], dtype=torch.int64,
                            device=self.wire)

    def psum_host(self, values: Sequence[int]) -> list:
        """Host ints summed over the ranks, read back (one host sync)."""
        return self.syncs.pull(self.psum(self._host_ints(values)))

    def barrier(self) -> None:
        """Wait for every rank (a one-int sum): rank 0's snapshot write is
        committed before any rank can go on to read it."""
        self.psum_host([0])

    def gather_host(self, values: Sequence[int]) -> np.ndarray:
        """Host ints of every rank, (size, len(values)) int64, read back
        (one host sync)."""
        g = self.all_gather(self._host_ints(values))
        return np.asarray(self.syncs.pull(g), dtype=np.int64).reshape(
            self.size, len(values))


def rank_device(device, rank: int) -> torch.device:
    """The device rank ``rank`` runs on: the CPU, or ``cuda:(rank %
    device_count)``. Raises without a card (``resolve_device``)."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return torch.device("cuda", rank % torch.cuda.device_count())
    return dev


def make_mesh(n_devices: Optional[int] = None, device="cuda") -> Mesh:
    """This rank's :class:`Mesh` over the initialized process group.
    ``n_devices``, when given, must equal the world size."""
    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs an initialized process group; the engines' "
            "entry points start one (mesh.launch)")
    size, rank = dist.get_world_size(), dist.get_rank()
    if n_devices is not None and int(n_devices) != size:
        raise ValueError(f"requested {n_devices} devices, the process group "
                         f"has {size} ranks")
    return Mesh(rank=rank, size=size, device=rank_device(device, rank),
                backend=dist.get_backend(), group=dist.group.WORLD)


def default_world(device) -> int:
    """``n_devices=None``: every card, or one rank on the CPU."""
    dev = resolve_device(device)
    return torch.cuda.device_count() if dev.type == "cuda" else 1


def choose_backend(n: int, device) -> str:
    """NCCL when each of the ``n`` ranks owns a card, gloo otherwise."""
    dev = torch.device(device)
    return ("nccl" if dev.type == "cuda" and n <= torch.cuda.device_count()
            else "gloo")


# ---------------------------------------------------------------------------
# The launcher
# ---------------------------------------------------------------------------


def _portable(e: BaseException) -> BaseException:
    """``e`` if it survives a pickle round trip, else a RuntimeError with
    its type and message."""
    try:
        return pickle.loads(pickle.dumps(e))
    except Exception:  # noqa: BLE001 -- any unpicklable exception
        return RuntimeError(f"{type(e).__name__}: {e}")


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _init_rank(backend: str, device, rank: int, n: int, timeout: float,
               init_method: Optional[str]) -> None:
    dev = rank_device(device, rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    kw = dict(backend=backend, rank=rank, world_size=n,
              timeout=datetime.timedelta(seconds=timeout))
    if init_method is None:
        kw["store"] = dist.HashStore()
    else:
        kw["init_method"] = init_method
    dist.init_process_group(**kw)


def _rank_main(rank: int, n: int, port: int, backend: str, device,
               target: Tuple[str, str], args: tuple, kwargs: dict,
               timeout: float, out) -> None:
    """The body of a spawned rank: join the group, import the function
    ``target`` names (module, qualified name) and run it, report (rank,
    ok, rank 0's result or the exception)."""
    try:
        if torch.device(device).type == "cpu":
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // n))
        _init_rank(backend, device, rank, n, timeout,
                   f"tcp://127.0.0.1:{port}")
        # every rank finishes connecting before any can fail and close
        # its end (a peer still connecting would report that instead)
        dist.barrier()
        fn = functools.reduce(getattr, target[1].split("."),
                              importlib.import_module(target[0]))
        res = fn(*args, **kwargs)
        out.put((rank, True, res if rank == 0 else None))
    except BaseException as e:  # noqa: BLE001 -- reported to the parent
        out.put((rank, False, (_portable(e), traceback.format_exc())))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def launch(fn: Callable, n_devices: Optional[int], device, args: tuple = (),
           kwargs: Optional[dict] = None, timeout: Optional[float] = None):
    """Run ``fn(*args, **kwargs)`` as the SPMD body of ``n_devices`` ranks
    and return rank 0's result. One rank runs in this process; more are
    spawned, and each imports ``fn`` by its module and qualified name (a
    module-level function). An exception on any rank is raised here (the
    lowest rank's); ranks that have not reported within ``timeout``
    seconds (default ``LAUNCH_TIMEOUT_S``; a hang) are killed and a
    ``TimeoutError`` names them."""
    kwargs = dict(kwargs or {})
    timeout = LAUNCH_TIMEOUT_S if timeout is None else float(timeout)
    resolve_device(device)               # no card: refuse before spawning
    n = default_world(device) if n_devices is None else int(n_devices)
    if n < 1:
        raise ValueError(f"n_devices must be >= 1, got {n}")
    backend = choose_backend(n, device)
    if dist.is_initialized():
        raise RuntimeError("launch: a process group is already initialized "
                           "(call the entry point itself inside it)")
    if n == 1:
        _init_rank(backend, device, 0, 1, timeout, None)
        try:
            return fn(*args, **kwargs)
        finally:
            dist.destroy_process_group()
    ctx = torch.multiprocessing.get_context("spawn")
    out = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_rank_main,
                         args=(r, n, port, backend, str(device),
                               (fn.__module__, fn.__qualname__), args,
                               kwargs, timeout, out))
             for r in range(n)]
    for p in procs:
        p.start()
    got, deadline = {}, time.monotonic() + timeout
    try:
        while len(got) < n:
            left = deadline - time.monotonic()
            if left <= 0:
                missing = sorted(set(range(n)) - set(got))
                raise TimeoutError(
                    f"ranks {missing} of {n} did not finish within "
                    f"{timeout:.0f} s ({backend}); killed")
            try:
                rank, ok, payload = out.get(timeout=min(left, 1.0))
                got[rank] = (ok, payload)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in got and p.exitcode is not None]
                if dead:
                    time.sleep(1.0)     # a report may still be in flight
                    while True:
                        try:
                            rank, ok, payload = out.get_nowait()
                            got[rank] = (ok, payload)
                        except queue.Empty:
                            break
                    dead = [r for r in dead if r not in got]
                    if dead:
                        raise RuntimeError(
                            f"rank {dead[0]} of {n} exited with code "
                            f"{procs[dead[0]].exitcode} without a result")
    finally:
        for p in procs:
            p.join(timeout=5.0 if len(got) == n else 0.1)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    for rank in range(n):
        ok, payload = got[rank]
        if not ok:
            exc, tb = payload
            raise exc from RuntimeError(f"rank {rank} of {n}:\n{tb}")
    return got[0][1]


# ---------------------------------------------------------------------------
# The persistent world
# ---------------------------------------------------------------------------


def _own_group(backend: str, store, rank: int, n: int, timeout: float):
    """A process group built directly on ``store``, never registered as
    the default group: a process holding one can still call every entry
    point (``launch`` and ``spmd_entry`` read the default group)."""
    td = datetime.timedelta(seconds=timeout)
    if backend == "nccl":
        opts = dist.ProcessGroupNCCL.Options()
        opts._timeout = td
        return dist.ProcessGroupNCCL(store, rank, n, opts)
    return dist.ProcessGroupGloo(store, rank, n, td)


def _world_mesh(rank: int, n: int, backend: str, device, store,
                timeout: float, syncs: Optional[HostSyncs] = None) -> Mesh:
    dev = rank_device(device, rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    group = _own_group(backend, dist.PrefixStore("world", store), rank, n,
                       timeout)
    mesh = Mesh(rank=rank, size=n, device=dev, backend=backend, group=group)
    if syncs is not None:
        mesh.syncs = syncs
    # every rank finishes connecting before any can fail and close its
    # end (a peer still connecting would report that instead)
    mesh.barrier()
    return mesh


def _resolve(target: Tuple[str, str]):
    return functools.reduce(getattr, target[1].split("."),
                            importlib.import_module(target[0]))


def _world_rank_main(rank: int, n: int, port: int, backend: str, device,
                     target: Tuple[str, str], args: tuple, timeout: float,
                     conn) -> None:
    """A follower of a :class:`World`: join it, build this rank's object
    ``target(mesh, *args)``, then run each command rank 0 sends (a method
    name and its arguments), answering ("ok", None) or ("err",
    (exception, traceback)). Ends on ``None`` (stop), on an error, or
    when rank 0's end of the pipe closes."""
    signal.signal(signal.SIGINT, signal.SIG_IGN)   # rank 0 decides
    try:
        if torch.device(device).type == "cpu":
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // n))
        factory = _resolve(target)
        conn.send(("hello", rank))
        store = dist.TCPStore("127.0.0.1", port, n, False,
                              timeout=datetime.timedelta(seconds=timeout))
        mesh = _world_mesh(rank, n, backend, device, store, timeout)
        obj = factory(mesh, *args)
        conn.send(("ok", None))
    except BaseException as e:  # noqa: BLE001 -- reported to rank 0
        conn.send(("err", (_portable(e), traceback.format_exc())))
        return
    while True:
        try:
            msg = conn.recv()
        except (EOFError, OSError):
            return                        # rank 0 is gone
        if msg is None:
            mesh.group.shutdown()
            return
        method, margs = msg
        try:
            getattr(obj, method)(*margs)
            conn.send(("ok", None))
        except BaseException as e:  # noqa: BLE001 -- reported to rank 0
            try:
                conn.send(("err", (_portable(e), traceback.format_exc())))
            except (OSError, ValueError):
                pass
            return


def _stop_followers(procs, conns) -> None:
    """Stop and reap every follower: a stop message, a short join, then
    a kill. Safe to call twice (the world's finalizer)."""
    for c in conns:
        try:
            c.send(None)
        except (OSError, ValueError):
            pass
    for p in procs:
        p.join(timeout=5.0)
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    for c in conns:
        c.close()


class World:
    """A world of ``n`` ranks that lives across calls, for an engine
    whose state stays on its ranks between phases.

    Rank 0 lives in this process; ranks 1..n-1 are spawned once (rank r
    on ``cuda:(r % device_count)``, or the CPU) and each loops on
    commands from rank 0. Every rank holds one object, ``target(mesh,
    *args)`` (a module-level callable, imported by name on the spawned
    ranks); :meth:`call` runs one of its methods on every rank, rank 0's
    here, so each rank meets the same collectives in the same order.

    The transport is :func:`choose_backend`'s (NCCL when each rank owns
    a card, gloo otherwise) over a process group the world owns, built
    on its own TCP store and never the default group: the process that
    holds a world can still call every other entry point. A world of one
    rank runs in this process and spawns nothing.

    A follower that dies, raises or does not answer within ``timeout``
    seconds (also the group's collective time limit) fails the command:
    the world closes and the error names the rank. :meth:`close` (also
    the context manager and a finalizer) stops every follower; no
    process outlives the world."""

    def __init__(self, n: int, device, target: Callable, args: tuple = (),
                 timeout: Optional[float] = None,
                 syncs: Optional[HostSyncs] = None):
        self.n = int(n)
        if self.n < 1:
            raise ValueError(f"a world needs >= 1 rank, got {n}")
        self.timeout = WORLD_TIMEOUT_S if timeout is None else float(timeout)
        resolve_device(device)            # no card: refuse before spawning
        self.backend = choose_backend(self.n, device)
        self._procs, self._conns = [], []
        self._open = False
        self._pending = False
        self._finalizer = weakref.finalize(self, _stop_followers,
                                           self._procs, self._conns)
        store = None
        try:
            if self.n == 1:
                store = dist.HashStore()
            else:
                store = dist.TCPStore(
                    "127.0.0.1", 0, self.n, True,
                    timeout=datetime.timedelta(seconds=self.timeout),
                    wait_for_workers=False)
                ctx = torch.multiprocessing.get_context("spawn")
                spec = (target.__module__, target.__qualname__)
                for r in range(1, self.n):
                    mine, theirs = ctx.Pipe(duplex=True)
                    p = ctx.Process(
                        target=_world_rank_main,
                        args=(r, self.n, store.port, self.backend,
                              str(device), spec, tuple(args), self.timeout,
                              theirs),
                        daemon=True)
                    p.start()
                    theirs.close()
                    self._procs.append(p)
                    self._conns.append(mine)
                # every follower imported its code before rank 0 waits
                # in the group's rendezvous (a follower that fails to
                # start fails here, not at the rendezvous's time limit)
                self._answers("hello")
            self.mesh = _world_mesh(0, self.n, self.backend, device, store,
                                    self.timeout, syncs)
            self.local = target(self.mesh, *args)
            if self.n > 1:
                self._answers("ok")
            self._open = True
        except BaseException:
            self._finalizer()
            raise
        self._store = store

    @property
    def size(self) -> int:
        return self.n

    @property
    def pids(self) -> list:
        """The spawned ranks' process ids (rank 1 first)."""
        return [p.pid for p in self._procs]

    @property
    def open(self) -> bool:
        return self._open

    def _answers(self, want: str) -> None:
        """One answer from every follower, within the time limit; a
        dead, failed or silent follower raises naming its rank."""
        deadline = time.monotonic() + self.timeout
        for r, (p, c) in enumerate(zip(self._procs, self._conns), 1):
            while not c.poll(0.05):
                if not p.is_alive() and not c.poll(0.5):
                    raise RuntimeError(
                        f"rank {r} of {self.n} exited with code "
                        f"{p.exitcode} without an answer")
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"rank {r} of {self.n} did not answer within "
                        f"{self.timeout:.0f} s ({self.backend})")
            try:
                kind, payload = c.recv()
            except (EOFError, OSError):
                raise RuntimeError(
                    f"rank {r} of {self.n} closed its pipe (exit code "
                    f"{p.exitcode})") from None
            if kind == "err":
                exc, tb = payload
                raise exc from RuntimeError(f"rank {r} of {self.n}:\n{tb}")
            if kind != want:
                raise RuntimeError(f"rank {r} of {self.n} answered "
                                   f"{kind!r}, expected {want!r}")

    def _check_open(self) -> None:
        if not self._open:
            raise RuntimeError("this world of ranks is closed")
        for r, p in enumerate(self._procs, 1):
            if not p.is_alive():
                self._fail(RuntimeError(
                    f"rank {r} of {self.n} exited with code {p.exitcode}"))

    def _follower_fault(self, grace: float = 1.0):
        """The first follower that reported an error or died, as an
        exception naming its rank (None when all look healthy). Waits at
        most ``grace`` seconds: a follower blocked in a collective is
        not asked to answer."""
        deadline = time.monotonic() + grace
        while True:
            for r, (p, c) in enumerate(zip(self._procs, self._conns), 1):
                try:
                    if c.poll(0):
                        kind, payload = c.recv()
                        if kind == "err":
                            exc, tb = payload
                            exc.__cause__ = RuntimeError(
                                f"rank {r} of {self.n}:\n{tb}")
                            return exc
                except (EOFError, OSError):
                    pass
                if not p.is_alive():
                    return RuntimeError(f"rank {r} of {self.n} exited with "
                                        f"code {p.exitcode}")
            if time.monotonic() > deadline:
                return None
            time.sleep(0.05)

    def _fail(self, exc: BaseException):
        """Close the world and raise ``exc``, or the follower fault that
        caused it (a follower's own error, or its death)."""
        cause = self._follower_fault() if self._procs else None
        self.close()
        if cause is not None:
            raise cause from exc
        raise exc

    def begin(self, method: str, *args) -> None:
        """Send one command to every follower; rank 0's part runs through
        :meth:`run_local`, and :meth:`finish` collects the answers."""
        self._check_open()
        if self._pending:
            raise RuntimeError("a world command is still open")
        for r, c in enumerate(self._conns, 1):
            try:
                c.send((method, args))
            except (OSError, ValueError) as e:
                self._fail(RuntimeError(
                    f"rank {r} of {self.n}: command {method!r} not "
                    f"delivered ({e})"))
        self._pending = True

    def run_local(self, method: str, *args):
        """Rank 0's part of the open command; a failure closes the world
        and raises the follower fault behind it, if any."""
        try:
            return getattr(self.local, method)(*args)
        except BaseException as e:  # noqa: BLE001 -- diagnosed, re-raised
            self._pending = False
            self._fail(e)

    def finish(self) -> None:
        """Every follower's answer to the open command."""
        self._pending = False
        try:
            self._answers("ok")
        except BaseException as e:  # noqa: BLE001 -- closes the world
            self.close()
            raise e

    def call(self, method: str, *args):
        """Run ``method(*args)`` on every rank and return rank 0's
        result."""
        self.begin(method, *args)
        out = self.run_local(method, *args)
        self.finish()
        return out

    def close(self) -> None:
        """Stop every follower and shut the group down (idempotent)."""
        was_open, self._open = self._open, False
        self._pending = False
        self._finalizer()
        if was_open:
            self.mesh.group.shutdown()
        self.local = None
        self.mesh = None
        self._store = None

    def __enter__(self) -> "World":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def run_calls(calls: Sequence[Tuple[Callable, tuple, dict]]) -> list:
    """SPMD body that runs several entry-point calls in one world, in
    order; each result is the call's return value or the exception it
    raised (so one launch serves a batch of runs, as the tests and the
    chip smoke use it)."""
    outs = []
    for fn, args, kwargs in calls:
        try:
            outs.append(fn(*args, **kwargs))
        except Exception as e:  # noqa: BLE001 -- returned to the caller
            outs.append(_portable(e))
    return outs


def spmd_entry(body: Callable) -> Callable:
    """Make ``body(*args, mesh=Mesh, **kwargs)`` an entry point with the
    reference's signature plus ``device``: inside a process group it
    runs ``body`` on this rank's mesh (``mesh`` if given, else
    ``make_mesh(n_devices, device)``); outside one it launches
    ``n_devices`` ranks that each call the entry point, within
    ``LAUNCH_TIMEOUT_S``."""
    @functools.wraps(body)
    def entry(*args, n_devices: Optional[int] = None, device="cuda",
              mesh: Optional[Mesh] = None, **kwargs):
        if dist.is_initialized():
            if mesh is None:
                mesh = make_mesh(n_devices, device)
            return body(*args, mesh=mesh, **kwargs)
        if mesh is not None:
            raise ValueError("mesh= is only meaningful inside a process "
                             "group; pass n_devices instead")
        return launch(entry, n_devices, device, args,
                      dict(kwargs, n_devices=n_devices, device=device))
    return entry


# ---------------------------------------------------------------------------
# Stores and re-deals
# ---------------------------------------------------------------------------


def device_store(store: int, fill, block, dtype=torch.float64,
                 device="cuda") -> torch.Tensor:
    """One rank's (store,) column built on its device: the fill value
    plus one prefix write of the small host ``block`` (the rank's seed
    entries or a snapshot's live prefix). The reference's
    ``device_store`` builds all (n_dev, store) rows; rank r's row of it is
    ``device_store(store, fill[r] or fill, block[r])`` here."""
    col = torch.full((store,), fill, dtype=dtype, device=device)
    blk = torch.as_tensor(np.asarray(block), dtype=dtype)
    col[:blk.shape[0]] = blk.to(device)
    return col


def host_strided_redeal(cols: Dict[str, np.ndarray], counts: np.ndarray,
                        n_new: int, fills: Dict[str, object],
                        sort_key: Optional[np.ndarray] = None
                        ) -> Tuple[Dict[str, np.ndarray], np.ndarray]:
    """The host twin of :func:`strided_reshard` for an elastic resume:
    re-deal an n-rank snapshot's live prefixes onto ``n_new`` ranks.
    ``cols`` maps a column name to (n_old, b) live-prefix arrays and
    ``counts`` holds the (n_old,) live counts. The dense prefix is built
    in rank-block order, optionally stably ordered by ``sort_key`` (an
    aligned (n_old, b) column), and rank d of the new mesh takes dense
    rows d, d + n_new, ... Returns ``(new_cols, new_counts)``: (n_new,
    b_new) arrays with ``fills`` past each count, and the int32 counts."""
    counts = np.asarray(counts, dtype=np.int64)
    n_old = counts.shape[0]
    n_new = int(n_new)
    if n_new < 1:
        raise ValueError(f"cannot redeal onto {n_new} chips")
    dense = {k: np.concatenate([np.asarray(v)[c][:counts[c]]
                                for c in range(n_old)])
             for k, v in cols.items()}
    total = int(counts.sum())
    if sort_key is not None:
        key_dense = np.concatenate(
            [np.asarray(sort_key)[c][:counts[c]] for c in range(n_old)])
        order = np.argsort(key_dense, kind="stable")
        dense = {k: v[order] for k, v in dense.items()}
    new_counts = np.array(
        [(total - d + n_new - 1) // n_new for d in range(n_new)],
        dtype=np.int64)
    b_new = max(int(new_counts.max(initial=0)), 1)
    out = {}
    for k, v in dense.items():
        col = np.full((n_new, b_new), fills[k], dtype=v.dtype)
        for d in range(n_new):
            col[d, :new_counts[d]] = v[d::n_new]
        out[k] = col
    return out, new_counts.astype(np.int32)


def dealt_counts(total: int, n: int, out_width: int) -> np.ndarray:
    """(n,) rows each rank receives from a strided deal of ``total``
    dense rows into ``out_width`` slots: rank d takes rows d, d + n, ..."""
    d = np.arange(n, dtype=np.int64)
    return np.clip((total - d + n - 1) // n, 0, out_width)


def _deal(mesh: Mesh, cols: Sequence[torch.Tensor], counts: np.ndarray,
          fills: Sequence, out_width: int,
          sort_key: Optional[torch.Tensor]) -> Tuple[tuple, torch.Tensor]:
    """Gather every rank's dense prefix (``counts`` are every rank's
    valid rows, already gathered), build the dense global prefix in rank
    order (stably sorted by ``sort_key`` when given) and take this rank's
    strided rows. One gather of the columns packed as float64 rows (every
    column's values, int32 included, are exact there), cut to the widest
    prefix."""
    n = mesh.size
    my = mesh.axis_index()
    total = int(counts.sum())
    dev = cols[0].device
    take = my + torch.arange(out_width, dtype=torch.int64, device=dev) * n
    mine = take < total
    if total == 0:
        return tuple(torch.full((out_width,), f, dtype=c.dtype, device=dev)
                     for c, f in zip(cols, fills)), mine
    w = int(counts.max())
    rows = list(cols) + ([] if sort_key is None else [sort_key])
    packed = torch.stack([r[:w].to(torch.float64) for r in rows])
    g = mesh.all_gather(packed)                        # (n, k, w)
    dense = torch.cat([g[c, :, :counts[c]] for c in range(n)
                       if counts[c] > 0], dim=1)      # (k, total)
    if sort_key is not None:
        _, order = torch.sort(dense[-1], stable=True)
        dense = dense[:len(cols), order]
    idx = torch.clamp(take, max=total - 1)
    outs = tuple(
        torch.where(mine, dense[j, idx].to(c.dtype),
                    torch.full((), f, dtype=c.dtype, device=dev))
        for j, (c, f) in enumerate(zip(cols, fills)))
    return outs, mine


def strided_reshard(mesh: Mesh, cols: Sequence[torch.Tensor], n_valid: int,
                    fills: Sequence, out_width: int,
                    sort_key: Optional[torch.Tensor] = None,
                    extra: Sequence[int] = ()):
    """Deal every rank's dense prefix round-robin across the mesh: the
    demand-driven farmer dispatch at batch granularity. Each rank's
    ``cols`` hold ``n_valid`` valid rows; rank d receives the global
    dense rows d, d + n, d + 2n, ... (ordered stably by ``sort_key``
    first, when given: a stratified sample of the key). ``extra`` ints
    ride in the count gather, so callers can compute replicated
    predicates from every rank's values.

    Returns ``(out_cols, mine, total, header)``: this rank's
    (out_width,) columns with ``fills`` past its rows, the validity mask,
    the global row count, and the gathered (n, 1 + len(extra)) host
    array of (n_valid, *extra) per rank."""
    width = cols[0].shape[0]
    if out_width > width:
        raise ValueError(f"out_width={out_width} exceeds column "
                         f"width={width}")
    header = mesh.gather_host([n_valid, *extra])
    out_cols, mine = _deal(mesh, cols, header[:, 0], fills, out_width,
                           sort_key)
    return out_cols, mine, int(header[:, 0].sum()), header


def phase_reshard(mesh: Mesh, cols: Sequence[torch.Tensor], n_valid: int,
                  fills: Sequence, window: int, rebalance_floor: int,
                  sort_key: Optional[torch.Tensor] = None,
                  extra: Sequence[int] = ()):
    """The phase-granular rebalance: ONE collective boundary per walk
    phase. The global count of every rank's top ``window`` rows decides,
    identically on every rank: below ``rebalance_floor`` the ranks keep
    their windows (the tails drain locally; a zero total terminates the
    caller's loop on the same sum), otherwise the top ``min(n_valid,
    window)`` rows of every rank are dealt round-robin across the mesh
    (:func:`strided_reshard` on the windows, stratified by
    ``sort_key``).

    Returns ``(win_cols, n_mine, did, header)``: the (window,) columns
    to write back at ``n_valid - min(n_valid, window)`` (the local
    window unchanged when ``did`` is False), this rank's row count in
    them, the replicated rebalance flag, and the gathered (n, 1 +
    len(extra)) host array of (taken window rows, *extra) per rank."""
    n_take = min(int(n_valid), int(window))
    start = int(n_valid) - n_take
    local = tuple(dyn_slice(c, start, window) for c in cols)
    key_win = None if sort_key is None else dyn_slice(sort_key, start,
                                                      window)
    header = mesh.gather_host([n_take, *extra])
    glob = int(header[:, 0].sum())
    did = glob >= int(rebalance_floor)
    if not did:
        return local, n_take, False, header
    out_cols, mine = _deal(mesh, local, header[:, 0], fills, window, key_win)
    return out_cols, int(dealt_counts(glob, mesh.size, window)[mesh.rank]), \
        True, header
