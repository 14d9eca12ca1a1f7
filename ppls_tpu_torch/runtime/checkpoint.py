"""Snapshots: round-boundary snapshots of the single-integral host
engine (``save_checkpoint``, ``Checkpointer``, ``resume``: the
frontier, the compensated accumulator and the metrics) and leg-boundary
snapshots of the family engines (the bag, the walker and the streaming
engine). Both are the reference's containers, kept byte-compatible, so
a snapshot that either package writes, the other loads.

The single-integral container holds ``meta`` (the metrics, their
``per_round`` records, the problem identity under ``config``,
``format_version`` and ``checksums``), ``frontier`` ((n, 2) float64) and
``acc`` (the (sum, compensation) pair). The family container is
described below.

A snapshot is one ``np.savez`` container holding

* ``meta``: a JSON blob (uint8) with the run's ``identity`` (the keys
  that say which problem and which schedule it belongs to), the live
  bag ``count``, the ``totals`` (the engine's integer counters and, for
  the stream, its host bookkeeping), ``format_version`` 1 and a
  ``checksums`` map;
* ``acc``: the float64 accumulator (the stream's is the ``(acc,
  acc_c)`` pair, shape (2, m));
* ``bag_<col>``: the live bag prefix, one array per column (``l``,
  ``r``, ``th`` float64, ``meta`` int32).

Every payload array carries a sha256 over its dtype, shape and bytes, so
a truncated or bit-flipped file raises :class:`CheckpointCorruptError`
(with its path) instead of resuming damaged state; a missing file stays
a ``FileNotFoundError``. A snapshot of another run, or of the same run
in another schedule mode, is refused with a ``ValueError`` ("different
run"). Writes are atomic (``mkstemp`` in the destination directory,
then ``os.replace``); :class:`CheckpointWriter` moves them to one
background thread in FIFO order, and every read flushes it first.

``PPLS_CHAOS=1`` re-opens and verifies every snapshot right after it is
written.

Host-only: numpy and the standard library.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import tempfile
import threading
import warnings
from collections import deque
from typing import Callable, Optional, Tuple

import numpy as np

from ppls_tpu_torch.config import QuadConfig, Rule
from ppls_tpu_torch.utils.metrics import RoundStats, RunMetrics

# absent = unverified legacy container; 1 = checksummed
CKPT_FORMAT_VERSION = 1


class CheckpointCorruptError(ValueError):
    """A snapshot file failed integrity verification (truncation,
    bit-flip, or an unparseable container). Carries the offending
    ``path``."""

    def __init__(self, path: str, detail: str):
        super().__init__(
            f"checkpoint {path!r} is corrupt: {detail} (refusing to "
            f"resume from damaged state; delete the file to start "
            f"fresh)")
        self.path = path
        self.detail = detail


def _array_sha(arr: np.ndarray) -> str:
    a = np.ascontiguousarray(arr)
    h = hashlib.sha256()
    h.update(str(a.dtype).encode())
    h.update(str(a.shape).encode())
    h.update(a.tobytes())
    return h.hexdigest()[:16]


def _payload_checksums(arrays: dict) -> dict:
    return {k: _array_sha(np.asarray(v)) for k, v in arrays.items()}


def _verify_payload(path: str, z, meta: dict) -> None:
    """Verify every payload array against the stored checksums; a
    container without ``format_version`` carries none and loads
    unverified."""
    sums = meta.get("checksums")
    if meta.get("format_version") is None or sums is None:
        return
    for k, want in sums.items():
        if k not in z.files:
            raise CheckpointCorruptError(path, f"payload {k!r} missing")
        got = _array_sha(np.asarray(z[k]))
        if got != want:
            raise CheckpointCorruptError(
                path, f"payload {k!r} checksum mismatch "
                      f"(stored {want}, recomputed {got})")


def _chaos_verify_on_write(path: str) -> None:
    """With ``PPLS_CHAOS=1`` every snapshot write is re-opened and
    verified at once, so a serialization fault surfaces where it was
    written."""
    if os.environ.get("PPLS_CHAOS") != "1":
        return
    with np.load(path) as z:
        meta = json.loads(bytes(z["meta"]).decode())
        _verify_payload(path, z, meta)


class CheckpointWriter:
    """One background thread that writes snapshots in submit order.

    Each job ends in the same atomic rename as a synchronous write, so a
    reader never sees a torn file. A failed job parks its exception and
    the next :meth:`submit` or :meth:`flush` raises it; :meth:`flush`
    waits until every submitted job has run. All shared state is guarded
    by one condition's lock."""

    def __init__(self):
        self._cv = threading.Condition()
        self._q: deque = deque()
        self._busy = False
        self._err: Optional[BaseException] = None
        self._closed = False
        self._thread = threading.Thread(
            target=self._run, name="ppls-ckpt-writer", daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while True:
            with self._cv:
                while not self._q and not self._closed:
                    self._cv.wait()
                if self._closed and not self._q:
                    return
                job = self._q.popleft()
                self._busy = True
            try:
                job()
            except BaseException as e:  # noqa: BLE001 -- park, re-raise
                with self._cv:
                    if self._err is None:
                        self._err = e
            finally:
                with self._cv:
                    self._busy = False
                    self._cv.notify_all()

    def _raise_pending(self) -> None:
        if self._err is not None:
            err, self._err = self._err, None
            raise RuntimeError(
                "background checkpoint write failed") from err

    def submit(self, job: Callable[[], None]) -> None:
        """Queue ``job``; raises a previously parked write error first."""
        with self._cv:
            self._raise_pending()
            if self._closed:
                raise RuntimeError(
                    "CheckpointWriter is closed; cannot submit")
            self._q.append(job)
            self._cv.notify_all()

    def flush(self) -> None:
        """Block until every submitted job has run; raise a parked
        write error."""
        with self._cv:
            while self._q or self._busy:
                self._cv.wait()
            self._raise_pending()

    def close(self) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        self._thread.join()
        with self._cv:
            self._raise_pending()


_WRITER: Optional[CheckpointWriter] = None
_WRITER_LOCK = threading.Lock()


def background_writer() -> CheckpointWriter:
    """The process-wide background snapshot writer (started on first
    use)."""
    global _WRITER
    with _WRITER_LOCK:
        if _WRITER is None:
            _WRITER = CheckpointWriter()
        return _WRITER


def flush_background_writer() -> None:
    """Drain the process-wide writer if one was started. Every read path
    calls it, so a load never races a queued write."""
    with _WRITER_LOCK:
        w = _WRITER
    if w is not None:
        w.flush()


def engine_name(base: str, rule) -> str:
    """The rule is part of the engine identity (a Simpson snapshot never
    resumes a trapezoid run); trapezoid keeps the bare name."""
    rule = Rule(rule)
    return base if rule == Rule.TRAPEZOID else f"{base}-{rule.value}"


def _family_identity(engine: str, fname: str, eps: float, m: int,
                     theta: np.ndarray, bounds: np.ndarray) -> dict:
    return {
        "engine": engine, "fname": fname, "eps": eps, "m": m,
        "theta_sha": hashlib.sha256(
            np.ascontiguousarray(theta).tobytes()).hexdigest()[:16],
        "bounds_sha": hashlib.sha256(
            np.ascontiguousarray(bounds).tobytes()).hexdigest()[:16],
    }


def _write_family_container(path: str, meta_blob: bytes,
                            payload: dict) -> None:
    """The atomic commit shared by the synchronous and background paths:
    ``mkstemp`` beside ``path``, ``np.savez``, ``os.replace``."""
    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".ckpt.tmp")
    try:
        with os.fdopen(fd, "wb") as fh:
            np.savez(
                fh,
                meta=np.frombuffer(meta_blob, dtype=np.uint8),
                **payload,
            )
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    _chaos_verify_on_write(path)


def save_family_checkpoint(path: str, *, identity: dict, bag_cols: dict,
                           count: int, acc: np.ndarray, totals: dict,
                           writer: Optional[CheckpointWriter] = None,
                           ) -> None:
    """Atomically snapshot a family run at a leg boundary.

    ``bag_cols`` maps column name -> live-prefix host array; ``totals``
    is JSON-serialisable. With ``writer`` the file write runs on the
    background thread; the meta record is serialised here, so the caller
    may go on changing its ``totals`` after the call."""
    payload = {"acc": np.asarray(acc, dtype=np.float64)}
    payload.update({f"bag_{k}": np.asarray(v)
                    for k, v in bag_cols.items()})
    meta = {"identity": identity, "count": int(count), "totals": totals,
            "format_version": CKPT_FORMAT_VERSION,
            "checksums": _payload_checksums(payload)}
    meta_blob = json.dumps(meta).encode()
    if writer is not None:
        writer.submit(
            lambda: _write_family_container(path, meta_blob, payload))
        return
    _write_family_container(path, meta_blob, payload)


def peek_checkpoint_identity(path: str) -> dict:
    """Only the stored identity of a snapshot (its integrity is checked
    by the :func:`load_family_checkpoint` that follows)."""
    flush_background_writer()
    try:
        with np.load(path) as z:
            meta = json.loads(bytes(z["meta"]).decode())
    except FileNotFoundError:
        raise
    except Exception as e:  # noqa: BLE001 -- any container damage
        raise CheckpointCorruptError(
            path, f"unreadable container ({type(e).__name__}: {e})"
        ) from e
    return dict(meta.get("identity") or {})


def load_family_checkpoint(path: str, identity: dict, *,
                           mesh_resize: bool = False,
                           cluster_resize: bool = False):
    """Returns ``(bag_cols, count, acc, totals)``. Raises ``ValueError``
    when the snapshot belongs to another identity and
    :class:`CheckpointCorruptError` when its payload fails the check.

    ``mesh_resize`` lets the stored identity differ in ``n_dev`` only,
    ``cluster_resize`` also in ``cluster``: the caller then owns the
    re-deal onto its own topology."""
    flush_background_writer()
    try:
        with np.load(path) as z:
            meta = json.loads(bytes(z["meta"]).decode())
            _verify_payload(path, z, meta)
            acc = np.asarray(z["acc"], dtype=np.float64)
            bag_cols = {k[len("bag_"):]: np.asarray(z[k])
                        for k in z.files if k.startswith("bag_")}
    except (CheckpointCorruptError, FileNotFoundError):
        raise                 # a missing snapshot is not a corrupt one
    except Exception as e:  # noqa: BLE001 -- any container damage
        raise CheckpointCorruptError(
            path, f"unreadable container ({type(e).__name__}: {e})"
        ) from e
    stored = meta["identity"]
    if stored != identity:
        diff = {k: (stored.get(k), identity.get(k))
                for k in set(stored) | set(identity)
                if stored.get(k) != identity.get(k)}
        allowed = set()
        if mesh_resize:
            allowed.add("n_dev")
        if cluster_resize:
            allowed.add("cluster")
        if not (allowed and set(diff) <= allowed):
            raise ValueError(
                f"checkpoint {path!r} belongs to a different run; "
                f"refusing to blend (stored vs requested): {diff}")
    return bag_cols, int(meta["count"]), acc, meta["totals"]



# --- the single-integral host engine: round-boundary snapshots -----------

_META_KEYS = ("tasks", "splits", "leaves", "rounds", "max_depth",
              "integrand_evals", "wall_time_s", "n_chips")


def _config_identity(config: QuadConfig) -> dict:
    """The fields that say which problem a snapshot belongs to; resuming
    under another identity would blend two runs."""
    return {"integrand": config.integrand, "a": config.a, "b": config.b,
            "eps": config.eps, "rule": str(Rule(config.rule).value)}


def save_checkpoint(path: str, frontier: np.ndarray,
                    area_acc: Tuple[float, float],
                    metrics: RunMetrics,
                    config: Optional[QuadConfig] = None) -> None:
    """Atomically write (frontier, accumulator, metrics) to ``path``."""
    meta = {k: getattr(metrics, k) for k in _META_KEYS}
    meta["per_round"] = [dataclasses.asdict(s) for s in metrics.per_round]
    if config is not None:
        meta["config"] = _config_identity(config)
    payload = {
        "frontier": np.asarray(frontier, dtype=np.float64).reshape(-1, 2),
        "acc": np.asarray(area_acc, dtype=np.float64),
    }
    meta["format_version"] = CKPT_FORMAT_VERSION
    meta["checksums"] = _payload_checksums(payload)
    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".ckpt.tmp")
    try:
        with os.fdopen(fd, "wb") as fh:
            np.savez(
                fh,
                meta=np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8),
                **payload)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    _chaos_verify_on_write(path)


def load_checkpoint(path: str):
    """Returns ``(frontier, (s, c), RunMetrics, stored_config_or_None)``.
    Raises :class:`CheckpointCorruptError` on a damaged snapshot and
    ``FileNotFoundError`` on a missing one."""
    try:
        with np.load(path) as z:
            meta = json.loads(bytes(z["meta"]).decode())
            _verify_payload(path, z, meta)
            frontier = z["frontier"]
            s, c = (float(x) for x in z["acc"])
    except (CheckpointCorruptError, FileNotFoundError):
        raise
    except Exception as e:  # noqa: BLE001 - any container damage
        raise CheckpointCorruptError(
            path, f"unreadable container ({type(e).__name__}: {e})"
        ) from e
    meta.pop("format_version", None)
    meta.pop("checksums", None)
    stored_cfg = meta.pop("config", None)
    per_round = [RoundStats(**d) for d in meta.pop("per_round")]
    metrics = RunMetrics(**meta, per_round=per_round)
    return frontier, (s, c), metrics, stored_cfg


class Checkpointer:
    """``on_round`` hook that snapshots every ``every`` rounds. With
    ``config`` the snapshots carry the problem identity, so ``resume``
    refuses a mismatched run."""

    def __init__(self, path: str, every: int = 1,
                 config: Optional[QuadConfig] = None):
        self.path = path
        self.every = max(int(every), 1)
        self.config = config

    def hook(self, round_index: int, frontier, area_acc, metrics) -> None:
        if round_index % self.every == 0:
            save_checkpoint(self.path, frontier, area_acc, metrics,
                            config=self.config)


def resume(path: str, config: QuadConfig,
           on_round: Optional[Callable] = None, device="cuda"):
    """Continue an interrupted host-engine run from its last snapshot, on
    ``device`` (CUDA by default). Raises ``ValueError`` for a snapshot of
    another problem (integrand, bounds, eps, rule); warns when the
    snapshot is of a finished run (empty frontier: the result is
    replayed)."""
    from ppls_tpu_torch.runtime.host_frontier import integrate

    frontier, acc, metrics, stored_cfg = load_checkpoint(path)
    if stored_cfg is not None:
        now = _config_identity(config)
        if stored_cfg != now:
            diff = {k: (stored_cfg.get(k), now[k]) for k in now
                    if stored_cfg.get(k) != now[k]}
            raise ValueError(
                f"checkpoint {path!r} belongs to a different problem; "
                f"refusing to blend runs (stored vs requested): {diff}")
    if frontier.size == 0:
        warnings.warn(
            f"checkpoint {path!r} has an empty frontier (finished run); "
            f"resume just replays the stored result", stacklevel=2)
    return integrate(config, frontier=frontier, area_acc=acc,
                     metrics=metrics, on_round=on_round, device=device)
