"""The tuning table: its offline search, its cadence tier and online
adaptation, the port's copy of the JAX package's ``runtime/tune.py``.

* **Offline search** (:func:`tune_workload`, driven by
  ``ppls_tpu_torch/tools/tune_table.py``): a staged coordinate-descent
  sweep seeded from the hand defaults. The waste attribution of the best
  configuration so far picks the next knob to move through
  :data:`BUCKET_KNOB_MAP`; a candidate is kept when it Pareto-beats the
  best on the device-counted proxies (:func:`pareto_improves`). Each
  trial (:func:`measure_trial`) runs the port's walker on its device
  with the cadence passed explicitly, so the table being written never
  steers the sweep. Entries land in a table keyed by workload signature
  and device kind (:func:`update_table`, :func:`write_table`).
* **Table-driven resolution** (:func:`resolve_cadence_tuned`, reached
  through ``walker.resolve_cadence``, the one surface the walker and
  the stream share): explicit values, else the committed tuning table
  (exact signature -> nearest signature), sanity-banded, else the
  hand-tuned defaults. The tier that resolved is recorded
  (:func:`last_resolution`) so a silent fallback stays visible on the
  stream's registry gauge. The table is the committed
  ``tools/tuning_table.json`` at the repo root, a data file outside
  both packages; the port reads it and never writes it. Its rows are
  keyed by the device kind, so a row of one device never serves
  another.
* **Online adaptation** (:class:`OnlineAdapter`, driven by
  ``StreamEngine`` at phase boundaries): the admission budget and the
  spillover batch limit move within declared safe bands from the
  phase-stats row the boundary already read, with hysteresis and one
  step per phase, so the trajectory is a function of the schedule;
  the adapter's state rides the stream snapshot.

The search writes only where it is told: the committed
``tools/tuning_table.json`` is the JAX package's, and the port's tool
refuses to write it.

Host-only: the module imports only the stdlib at import time
(:func:`device_kind` and :func:`measure_trial` import torch and the
walker when called).
"""

from __future__ import annotations

import json
import math
import os
from typing import Callable, Dict, List, Optional, Tuple

# ---------------------------------------------------------------------------
# the shared dominant-bucket -> knob map
# ---------------------------------------------------------------------------

# which knob the search moves when a waste bucket dominates, and what the
# attribution printers recommend (one definition):
#   refill_stall   -> the bank deal: more slots / double-buffer swap
#   masked_dead    -> the exit/suspend cadence thresholds
#   theta_overwalk -> the theta batch width
#   drain_tail     -> the breed target (roots_per_lane) / the dd reshard
#                     window
BUCKET_KNOB_MAP: Dict[str, Tuple[str, ...]] = {
    "refill_stall": ("refill_slots", "double_buffer"),
    "masked_dead": ("exit_frac", "suspend_frac"),
    "theta_overwalk": ("theta_block",),
    "drain_tail": ("roots_per_lane", "reshard_window"),
}

# human hint per bucket, printed next to the knob names
BUCKET_KNOB_HINTS: Dict[str, str] = {
    "refill_stall": "raise the in-kernel bank deal (refill_slots) or "
                    "enable the double-buffer swap cadence",
    "masked_dead": "tighten the exit/suspend cadence thresholds",
    "theta_overwalk": "shrink theta_block (union-refinement overwalk "
                      "outruns the batch win)",
    "drain_tail": "raise the breed target (roots_per_lane sets it via "
                  "walker_sizing) or shrink the dd reshard window",
}


def recommend_knob(attribution: Optional[dict]) -> Optional[dict]:
    """The search's recommendation for an attribution record
    (``WalkerResult.attribution()``): which knob(s) to move for the
    dominant waste bucket, from :data:`BUCKET_KNOB_MAP`. None when there
    is nothing to attack (fully eval-active)."""
    if not isinstance(attribution, dict):
        return None
    dom = attribution.get("dominant_waste")
    if dom is None or dom == "eval_active" or dom not in BUCKET_KNOB_MAP:
        return None
    return {
        "bucket": dom,
        "knobs": list(BUCKET_KNOB_MAP[dom]),
        "hint": BUCKET_KNOB_HINTS[dom],
    }


# ---------------------------------------------------------------------------
# workload signatures + the committed table
# ---------------------------------------------------------------------------

TABLE_SCHEMA = "ppls-tuning-table-v1"
ENTRY_SCHEMA = "ppls-tuning-entry-v1"

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_TABLE_PATH = os.path.join(_REPO, "tools", "tuning_table.json")

# cadence safety bands: a table is data, and data can be wrong. Values
# outside these bands (or a suspend >= exit pair) are discarded at
# resolution time and the hand default used instead, so a corrupt table
# degrades to the hand tier but never wedges an engine.
CADENCE_SAFE_BANDS = {
    "exit_frac": (0.50, 0.99),
    "suspend_frac": (0.30, 0.95),
}


def hand_cadence_defaults(scout: bool, refill_slots: int
                          ) -> Tuple[float, float]:
    """The hand-tuned fallback tier (the one definition
    ``walker.resolve_cadence`` reaches): exit 0.95 / suspend 0.65 with
    scouting and in-kernel refill, 0.80 / 0.50 otherwise."""
    tight = bool(scout) and int(refill_slots) > 0
    return (0.95 if tight else 0.80), (0.65 if tight else 0.50)


def eps_band(eps: float) -> int:
    """Decimal-exponent band of the tolerance: 1e-7 -> -7."""
    return int(round(math.log10(float(eps))))


def theta_band(theta_block: int) -> int:
    """theta_block band edge (1 / 32 / 256 / 4096): cadence economics
    shift with the union-refinement group width, not its exact value."""
    t = int(theta_block)
    for edge in (1, 32, 256):
        if t <= edge:
            return edge
    return 4096


def mode_string(scout: bool, refill_slots: int) -> str:
    """The mode fingerprint: scouting and in-kernel refill change the
    refill-cadence economics, so a tuned entry never crosses modes."""
    return ("scout" if scout else "f64") + \
        ("-ikr" if int(refill_slots) > 0 else "-xla")


def workload_signature(family: str, eps: float, rule,
                       theta_block: int = 1, mesh_shape: int = 1, *,
                       scout: bool = False,
                       refill_slots: int = 0) -> dict:
    """The tuning-table key material: family, eps band, rule,
    theta_block band, mesh shape, plus the mode fingerprint."""
    rule_name = getattr(rule, "name", None) or str(rule)
    return {
        "family": str(family),
        "eps_band": eps_band(eps),
        "rule": str(rule_name).lower(),
        "theta_band": theta_band(theta_block),
        "mesh_shape": int(mesh_shape),
        "mode": mode_string(scout, refill_slots),
    }


_SIG_FIELDS = ("family", "eps_band", "rule", "theta_band",
               "mesh_shape", "mode")


def signature_key(sig: dict, device: str) -> str:
    """Canonical string key of one (signature, device_kind) cell."""
    parts = [f"{k}={sig[k]}" for k in _SIG_FIELDS]
    parts.append(f"device={device}")
    return "|".join(parts)


def device_kind(device="cuda") -> str:
    """The device fingerprint the table's rows are keyed by: ``"cpu"``
    for the CPU; for a CUDA device its name, lowercased with spaces as
    ``-`` (the JAX package's rule). Raises without a card, as the entry
    points do."""
    import torch

    from ppls_tpu_torch.utils.device import resolve_device
    dev = resolve_device(device)
    if dev.type == "cpu":
        return "cpu"
    return str(torch.cuda.get_device_name(dev)).lower().replace(" ", "-")


_TABLE_CACHE: Dict[str, tuple] = {}


def tuning_table_path() -> Optional[str]:
    """The table location: ``PPLS_TUNING_TABLE`` overrides (a path, or
    0/off to disable table-driven resolution entirely), else the
    committed ``tools/tuning_table.json``."""
    env = os.environ.get("PPLS_TUNING_TABLE")
    if env is not None:
        if env.strip().lower() in ("", "0", "off", "none"):
            return None
        return env
    return DEFAULT_TABLE_PATH


def load_tuning_table(path: Optional[str] = None) -> Optional[dict]:
    """Load (and mtime-cache) the tuning table; None when disabled,
    missing, or malformed: a broken table degrades to the hand tier,
    never crashes an engine constructor."""
    if path is None:
        path = tuning_table_path()
    if path is None:
        return None
    try:
        mtime = os.path.getmtime(path)
    except OSError:
        return None
    cached = _TABLE_CACHE.get(path)
    if cached is not None and cached[0] == mtime:
        return cached[1]
    try:
        with open(path, encoding="utf-8") as fh:
            table = json.load(fh)
    except (OSError, json.JSONDecodeError):
        return None
    if not isinstance(table, dict) \
            or table.get("schema") != TABLE_SCHEMA \
            or not isinstance(table.get("entries"), dict):
        return None
    _TABLE_CACHE[path] = (mtime, table)
    return table


def clear_table_cache() -> None:
    """Test hook: drop the mtime cache (monkeypatched paths)."""
    _TABLE_CACHE.clear()


def nearest_entry(entries: Dict[str, dict], sig: dict,
                  device: str) -> Optional[Tuple[str, dict]]:
    """The nearest-signature tier. Hard constraints first (device kind,
    rule, mode fingerprint, mesh shape and theta band match exactly),
    then rank the survivors: a family match (weight 4) beats eps-band
    proximity (weight 3 - |band distance|, floored at 0); candidates
    scoring 0 fall through to the hand tier. Ties break on smaller eps
    distance, then the lexicographically smaller key."""
    best: Optional[Tuple[int, int, str, dict]] = None
    for key in sorted(entries):
        ent = entries[key]
        s = ent.get("signature")
        if not isinstance(s, dict):
            continue
        if ent.get("device_kind") != device:
            continue
        if (s.get("rule") != sig["rule"]
                or s.get("mode") != sig["mode"]
                or s.get("mesh_shape") != sig["mesh_shape"]
                or s.get("theta_band") != sig["theta_band"]):
            continue
        try:
            d = abs(int(s.get("eps_band")) - int(sig["eps_band"]))
        except (TypeError, ValueError):
            continue
        score = (4 if s.get("family") == sig["family"] else 0) \
            + max(0, 3 - d)
        if score <= 0:
            continue
        cand = (score, -d, key, ent)
        # equal (score, distance): the earlier key holds (sorted order)
        if best is None or (cand[0], cand[1]) > (best[0], best[1]):
            best = cand
    if best is None:
        return None
    return best[2], best[3]


def resolve_knobs(sig: Optional[dict], names: Tuple[str, ...],
                  path: Optional[str] = None, *, device="cuda"
                  ) -> Tuple[Dict[str, object], str, Optional[str]]:
    """Three-tier lookup for ``names`` on ``device``'s rows: (values,
    tier, entry_key) with tier in {'exact', 'nearest', 'default'}.
    'default' returns no values; the caller owns the hand fallback."""
    if sig is None:
        return {}, "default", None
    table = load_tuning_table(path)
    if table is None:
        return {}, "default", None
    entries = table["entries"]
    kind = device_kind(device)
    key = signature_key(sig, kind)
    ent = entries.get(key)
    tier = "exact"
    if not isinstance(ent, dict):
        near = nearest_entry(entries, sig, kind)
        if near is None:
            return {}, "default", None
        key, ent = near
        tier = "nearest"
    knobs = ent.get("knobs")
    if not isinstance(knobs, dict):
        return {}, "default", None
    vals = {k: knobs[k] for k in names if k in knobs}
    if not vals:
        return {}, "default", None
    return vals, tier, key


def _cadence_pair_sane(exit_frac, suspend_frac) -> bool:
    for name, v in (("exit_frac", exit_frac),
                    ("suspend_frac", suspend_frac)):
        lo, hi = CADENCE_SAFE_BANDS[name]
        if not isinstance(v, (int, float)) or isinstance(v, bool) \
                or not math.isfinite(v) or not (lo <= v <= hi):
            return False
    return suspend_frac < exit_frac


_LAST_RESOLUTION = {"tier": "default", "key": None,
                    "exit_frac": None, "suspend_frac": None,
                    "signature": None}


def last_resolution() -> dict:
    """The most recent cadence resolution (tier, entry key, values):
    the stream's registry gauge reads it so a fallback to the hand tier
    stays visible."""
    return dict(_LAST_RESOLUTION)


def resolve_cadence_tuned(exit_frac: Optional[float],
                          suspend_frac: Optional[float],
                          scout: bool, refill_slots: int = 0, *,
                          signature: Optional[dict] = None,
                          path: Optional[str] = None,
                          device="cuda") -> Tuple[float, float, str]:
    """The one cadence-resolution surface: explicit values win
    ('explicit' tier); otherwise the tuning table's rows for
    ``device`` (exact -> nearest signature), sanity-banded, with the
    hand-tuned defaults as the fallback tier. Returns ``(exit_frac,
    suspend_frac, tier)`` and records it for :func:`last_resolution`."""
    de, ds = hand_cadence_defaults(scout, refill_slots)
    tier, key = "explicit", None
    if exit_frac is None or suspend_frac is None:
        vals, tier, key = resolve_knobs(
            signature, ("exit_frac", "suspend_frac"), path, device=device)
        te, ts = vals.get("exit_frac"), vals.get("suspend_frac")
        if tier != "default" and not _cadence_pair_sane(te, ts):
            # out-of-band table data: a visible degrade to the hand tier
            te = ts = None
            tier, key = "default", None
        if exit_frac is None:
            exit_frac = te if te is not None else de
        if suspend_frac is None:
            suspend_frac = ts if ts is not None else ds
        if not _cadence_pair_sane(exit_frac, suspend_frac) \
                and tier in ("exact", "nearest"):
            # a sane table pair can still clash with one explicit caller
            # value: the pair contract (suspend < exit) wins
            exit_frac = de if te is not None else exit_frac
            suspend_frac = ds if ts is not None else suspend_frac
            tier, key = "default", None
    exit_frac, suspend_frac = float(exit_frac), float(suspend_frac)
    _LAST_RESOLUTION.update(
        tier=tier, key=key, exit_frac=exit_frac,
        suspend_frac=suspend_frac, signature=signature)
    return exit_frac, suspend_frac, tier


# ---------------------------------------------------------------------------
# offline search: staged coordinate descent on the quick proxies
# ---------------------------------------------------------------------------

# the sweep's trial context: flagship mode (scout + in-kernel refill +
# double buffer) at a small sizing, big enough that the attribution
# buckets are populated; roots_per_lane sits above the bench-quick
# sizing so the breed-target lever has room to move
TUNE_SIZING = dict(capacity=1 << 16, lanes=256, roots_per_lane=8,
                   refill_slots=4, seg_iters=32, min_active_frac=0.05,
                   scout_dtype="f32", double_buffer=True)
TUNE_M = 8

# the tune workloads (family, eps, bounds): tolerances at which the walk
# phase engages at the trial sizing (sin_scaled converges in breed
# rounds alone above ~1e-8)
TUNE_WORKLOADS = (
    ("sin_recip_scaled", 1e-7, (1e-2, 1.0)),
    ("sin_scaled", 1e-9, (0.0, 1.0)),
    ("cosh4_scaled", 1e-8, (0.0, 1.0)),
)

# value domains of the sweepable knobs (theta_block and reshard_window
# are in BUCKET_KNOB_MAP for the recommendation, but theta band 1 and a
# one-device mesh cannot measure them)
KNOB_DOMAINS: Dict[str, Tuple] = {
    "exit_frac": (0.80, 0.90, 0.95, 0.98),
    "suspend_frac": (0.50, 0.65, 0.80),
    "refill_slots": (2, 4, 8),
    "double_buffer": (True, False),
    "roots_per_lane": (4, 8, 12),
}

# the order once the dominant bucket's own knobs are exhausted: the sweep
# keeps spending its budget instead of stalling
_SWEEP_ORDER = ("exit_frac", "suspend_frac", "refill_slots",
                "double_buffer", "roots_per_lane")


def valid_knob_combo(knobs: dict) -> bool:
    """The walker's own constraints on a knob combination (it refuses
    the others), so the sweep spends no trial on them."""
    if knobs["refill_slots"] > knobs["roots_per_lane"]:
        return False
    if knobs["double_buffer"] and (
            knobs["refill_slots"] < 2 or knobs["refill_slots"] % 2):
        return False
    if knobs["suspend_frac"] >= knobs["exit_frac"]:
        return False
    return True


def pareto_improves(cand: dict, base: dict) -> bool:
    """The "beats the hand default" contract: lane efficiency does not
    drop, kernel steps do not grow, and at least one strictly improves;
    the waste buckets must reconcile."""
    if not cand.get("reconciles", False):
        return False
    ce, be = float(cand["lane_efficiency"]), float(base["lane_efficiency"])
    cs, bs = int(cand["kernel_steps"]), int(base["kernel_steps"])
    return ce >= be and cs <= bs and (ce > be or cs < bs)


def measure_trial(family: str, eps: float, bounds, sizing: dict,
                  knobs: dict, device="cuda") -> dict:
    """One sweep trial: the port's walker on ``device`` with the
    candidate knob values (the cadence passed explicitly, so no table
    reaches the trial), returning the device-counted quick proxies.
    ``recompiles`` counts the kernel libraries ``utils/cuda_build.py``
    compiled during the trial: 0 on the CPU, and 0 once the build
    directory holds the kernels (the JAX package counts its jit cache's
    growth instead, so the two counts are not comparable)."""
    import numpy as np

    from ppls_tpu_torch.models.integrands import get_family, get_family_ds
    from ppls_tpu_torch.parallel.walker import integrate_family_walker
    from ppls_tpu_torch.utils import cuda_build

    kw = dict(sizing)
    kw.pop("refill_slots", None)
    kw.pop("double_buffer", None)
    kw.pop("roots_per_lane", None)
    theta = 1.0 + np.arange(TUNE_M) / float(TUNE_M)
    builds0 = cuda_build.builds_done()
    r = integrate_family_walker(
        get_family(family), get_family_ds(family), theta, bounds,
        float(eps),
        exit_frac=float(knobs["exit_frac"]),
        suspend_frac=float(knobs["suspend_frac"]),
        refill_slots=int(knobs["refill_slots"]),
        double_buffer=bool(knobs["double_buffer"]),
        roots_per_lane=int(knobs["roots_per_lane"]),
        device=device, **kw)
    attr = r.attribution() or {}
    return {
        "tasks": int(r.metrics.tasks),
        "cycles": int(r.cycles),
        "kernel_steps": int(r.kernel_steps),
        "lane_efficiency": round(float(r.lane_efficiency), 6),
        "dominant_waste": attr.get("dominant_waste"),
        "reconciles": bool(attr.get("reconciles", False)),
        "recompiles": cuda_build.builds_done() - builds0,
    }


def _knob_key(knobs: dict) -> tuple:
    return tuple(sorted((k, knobs[k]) for k in knobs))


def _next_candidate(best_knobs: dict, best_proxies: dict,
                    tried: set) -> Optional[Tuple[str, object]]:
    """The staged coordinate picker: the dominant waste bucket of the
    best configuration so far names the next knob through
    :data:`BUCKET_KNOB_MAP`; its untried domain values go first, then
    the remaining sweepable knobs in stable order."""
    dom = best_proxies.get("dominant_waste")
    order: List[str] = []
    for k in BUCKET_KNOB_MAP.get(dom, ()):
        if k in KNOB_DOMAINS:
            order.append(k)
    for k in _SWEEP_ORDER:
        if k not in order:
            order.append(k)
    for knob in order:
        for v in KNOB_DOMAINS[knob]:
            cand = dict(best_knobs)
            cand[knob] = v
            if not valid_knob_combo(cand):
                continue
            if _knob_key(cand) in tried:
                continue
            return knob, v
    return None


def tune_workload(family: str, eps: float, bounds, *,
                  rule: str = "trapezoid",
                  sizing: Optional[dict] = None,
                  budget: int = 8, seed: int = 0,
                  measure: Optional[Callable[[dict], dict]] = None,
                  device="cuda") -> dict:
    """The staged sweep for one workload signature: coordinate descent
    seeded from the hand defaults, the attribution-picked knob order,
    Pareto acceptance (:func:`pareto_improves`), ``budget`` trials
    including the baseline. Deterministic given (seed, signature,
    measurement): no randomness is consumed, the seed is provenance.

    ``device`` is the device the trials run on (CUDA by default; raises
    without a card unless ``device="cpu"``); the entry's ``device_kind``
    is :func:`device_kind` of it. ``measure`` injects the trial runner
    (the tests stub it); the default is :func:`measure_trial`."""
    sizing = dict(TUNE_SIZING if sizing is None else sizing)
    scout = sizing.get("scout_dtype") == "f32"
    de, ds = hand_cadence_defaults(scout, sizing.get("refill_slots", 0))
    base_knobs = {
        "exit_frac": de, "suspend_frac": ds,
        "refill_slots": int(sizing.get("refill_slots", 4)),
        "double_buffer": bool(sizing.get("double_buffer", True)),
        "roots_per_lane": int(sizing.get("roots_per_lane", 8)),
    }
    if measure is None:
        def measure(knobs):
            return measure_trial(family, eps, bounds, sizing, knobs,
                                 device=device)
    sig = workload_signature(
        family, eps, rule, theta_block=1, mesh_shape=1, scout=scout,
        refill_slots=base_knobs["refill_slots"])
    kind = device_kind(device)

    base_p = measure(base_knobs)
    trials = [{"knobs": dict(base_knobs), "proxies": base_p,
               "accepted": True, "moved": None}]
    tried = {_knob_key(base_knobs)}
    best_knobs, best_p = dict(base_knobs), base_p
    recompiles = int(base_p.get("recompiles", 0))
    while len(trials) < max(1, int(budget)):
        nxt = _next_candidate(best_knobs, best_p, tried)
        if nxt is None:
            break
        knob, value = nxt
        cand = dict(best_knobs)
        cand[knob] = value
        tried.add(_knob_key(cand))
        p = measure(cand)
        recompiles += int(p.get("recompiles", 0))
        accepted = pareto_improves(p, best_p)
        trials.append({"knobs": cand, "proxies": p,
                       "accepted": accepted,
                       "moved": {"knob": knob, "value": value,
                                 "bucket": best_p.get(
                                     "dominant_waste")}})
        if accepted:
            best_knobs, best_p = cand, p

    def _prox(p):
        return {"tasks": int(p["tasks"]),
                "kernel_steps": int(p["kernel_steps"]),
                "lane_efficiency": float(p["lane_efficiency"])}

    return {
        "schema": ENTRY_SCHEMA,
        "signature": sig,
        "device_kind": kind,
        "knobs": {k: best_knobs[k] for k in sorted(best_knobs)},
        "baseline": _prox(base_p),
        "tuned": _prox(best_p),
        "provenance": {
            "trials": len(trials),
            "recompiles": recompiles,
            "reconciles": bool(best_p.get("reconciles", False)
                               and base_p.get("reconciles", False)),
            "seed": int(seed),
            "budget": int(budget),
            "improved": pareto_improves(best_p, base_p),
            "eps": float(eps),
            "bounds": [float(bounds[0]), float(bounds[1])],
            "sizing": {k: sizing[k] for k in sorted(sizing)},
            "path": [
                {"moved": t["moved"], "accepted": t["accepted"],
                 "kernel_steps": int(t["proxies"]["kernel_steps"]),
                 "lane_efficiency": float(
                     t["proxies"]["lane_efficiency"])}
                for t in trials[1:]],
        },
    }


def entry_key(entry: dict) -> str:
    return signature_key(entry["signature"], entry["device_kind"])


def update_table(table: Optional[dict], entry: dict) -> dict:
    """Insert or replace one entry; creates the table envelope when
    needed. Returns the (mutated) table."""
    if not isinstance(table, dict) or table.get("schema") != TABLE_SCHEMA:
        table = {"schema": TABLE_SCHEMA, "entries": {}}
    table.setdefault("entries", {})[entry_key(entry)] = entry
    return table


def write_table(path: str, table: dict) -> None:
    """Write ``table`` to ``path`` atomically and drop the path's mtime
    cache entry, so a rewrite within the same second is read anew."""
    tmp = f"{path}.tmp"
    with open(tmp, "w", encoding="utf-8") as fh:
        json.dump(table, fh, indent=1, sort_keys=True)
        fh.write("\n")
    os.replace(tmp, path)
    _TABLE_CACHE.pop(path, None)



# ---------------------------------------------------------------------------
# online adaptation (stream phase boundaries)
# ---------------------------------------------------------------------------

# hysteresis: a knob moves only after this many consecutive phases of
# same-direction pressure, and by at most one step per phase: the
# trajectory is a pure function of the phase-row/queue schedule, so a
# resumed run replays it bit-identically from the snapshot state.
ADAPT_HYSTERESIS = 2

# drain_tail + masked_dead lane-step share above which a backlogged
# phase reads as "lanes underfed" (admission pressure up)
ADAPT_WASTE_FRAC = 0.10


def online_safe_bands(defaults: Dict[str, int]) -> Dict[str, tuple]:
    """Declared safe bands for the online knobs, relative to the
    engine's configured values: the admission budget may trickle down
    to 1 but never exceed the admit window (the seed arrays' width);
    the spillover batch limit stays within the spill queue's 8x
    sizing."""
    bands = {}
    if "admit_budget" in defaults:
        bands["admit_budget"] = (1, max(1, int(defaults["admit_budget"])))
    if "spillover_limit" in defaults:
        d = max(1, int(defaults["spillover_limit"]))
        bands["spillover_limit"] = (1, 4 * d)
    return bands


class OnlineAdapter:
    """Deterministic per-phase knob adapter.

    Pure host arithmetic over values the phase boundary already holds:
    per-knob signed pressure streaks, :data:`ADAPT_HYSTERESIS` phases
    of agreement before a move, one step per phase, hard-clamped to
    the declared safe band. ``state()``/``restore()`` ride the stream
    snapshot so kill-and-resume replays the identical trajectory."""

    def __init__(self, defaults: Dict[str, int],
                 bands: Optional[Dict[str, tuple]] = None):
        self.defaults = {k: int(v) for k, v in defaults.items()}
        self.bands = {k: (int(lo), int(hi)) for k, (lo, hi) in
                      (bands if bands is not None
                       else online_safe_bands(defaults)).items()}
        for k, v in self.defaults.items():
            lo, hi = self.bands[k]
            if not lo <= v <= hi:
                raise ValueError(
                    f"online knob {k}: default {v} outside its safe "
                    f"band [{lo}, {hi}]")
        self.values = dict(self.defaults)
        self.streaks = {k: 0 for k in self.defaults}

    def observe(self, pressures: Dict[str, int]) -> List[dict]:
        """Fold one phase's signed pressures (-1/0/+1 per knob) into
        the streaks; returns the applied changes (possibly empty),
        each ``{"knob", "from", "to"}``."""
        changes = []
        for k in sorted(self.values):
            p = int(pressures.get(k, 0))
            if p == 0:
                self.streaks[k] = 0
                continue
            s = self.streaks[k]
            s = s + p if s * p >= 0 else p   # direction flip resets
            if abs(s) >= ADAPT_HYSTERESIS:
                lo, hi = self.bands[k]
                old = self.values[k]
                new = min(hi, max(lo, old + (1 if s > 0 else -1)))
                self.streaks[k] = 0
                if new != old:
                    self.values[k] = new
                    changes.append({"knob": k, "from": old, "to": new})
            else:
                self.streaks[k] = s
        return changes

    def state(self) -> dict:
        return {"values": dict(self.values),
                "streaks": dict(self.streaks)}

    def restore(self, state: dict) -> None:
        vals = state.get("values", {})
        streaks = state.get("streaks", {})
        for k in self.values:
            if k in vals:
                lo, hi = self.bands[k]
                v = int(vals[k])
                if not lo <= v <= hi:
                    raise ValueError(
                        f"snapshot adapt state: {k}={v} outside the "
                        f"declared safe band [{lo}, {hi}]")
                self.values[k] = v
            if k in streaks:
                self.streaks[k] = int(streaks[k])
