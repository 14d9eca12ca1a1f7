"""CLI: ``python -m ppls_tpu_torch [flags]`` and its modes ``family``,
``serve``, ``2d`` and ``qmc`` (``python -m ppls_tpu_torch MODE [flags]``).

The port's copy of the JAX package's ``__main__.py``:

* the root command integrates one registered integrand (the reference
  C program's problem by default): ``--engine host`` (the host-driven
  wavefront, ``runtime/host_frontier.py``) or ``--engine device``
  (``parallel/device_engine.py``), ``--backend jax`` (those engines; the
  reference's name for the accelerator path, here the card), ``mpi``
  (the C farmer/worker program) or ``spillover`` (float64 bag rounds on
  the host CPU, where the reference pins that arm), ``--checkpoint`` on
  the host engine, ``--engine sharded`` (the wavefront across
  ``--n-devices`` ranks, ``parallel/sharded.py``), ``--json``;
* ``family`` integrates a batch of family members with the float64 bag
  (``--engine bag``) or the walker (``--engine walker``: K1 with
  ``--refill-slots`` > 0, K2 with 0), with ``--checkpoint``,
  ``--watchdog``, ``--theta``, ``--theta-block`` and
  ``--reduced-integrands``;
* ``serve`` runs one ``StreamEngine`` over a JSONL or seeded synthetic
  request list (one JSON line per retirement and per shed, the summary
  last), with ``--spillover``, snapshots and restarts, supervision and
  fault injection, admission policy, ``--slo-config`` (the ``/health``
  verdict of ``--metrics-port``), ``--adapt``, ``--events``,
  ``--metrics-port`` and ``--ingest-port``; ``--engine walker-dd
  --n-devices N`` streams across N ranks that live as long as the engine
  (a ``chip_loss`` under ``--supervise`` resize-resumes onto the
  survivors); ``--n-devices`` > 1 on the walker engine exits non-zero;
* ``2d`` integrates a registered 2D integrand with the rectangle bag
  (``parallel/cubature.py``), Simpson or trapezoid, on one device or,
  with ``--n-devices N``, across N ranks (``--checkpoint`` then
  snapshots and resumes), ``--json``;
* ``qmc`` integrates the 8D Genz suite (or one family) with the shifted
  rank-1 lattice (``parallel/qmc.py``), on one device or across
  ``--n-devices`` ranks, ``--json``.

``--trace DIR`` wraps any mode in a ``torch.profiler`` capture. The
parsers are the reference's, flag for flag, plus ``--device`` (default
``cuda``; without a card a command that runs an engine on it exits
non-zero unless ``--device cpu`` is given). ``--engine sharded``,
``family --engine sharded-bag|sharded-walker|sharded-walker-dd``, ``2d
--n-devices`` and ``qmc --n-devices`` run ranks (``parallel/mesh.py``;
several ranks share one card over gloo), and so does ``serve --engine
walker-dd``. ``serve --dispatch [--max-engines N] [--lease]
[--overlap-boundaries]`` runs the pool dispatcher
(``runtime/dispatch.py``): requests may carry their own ``eps`` and
``rule``, each engine key gets its own stream engine. ``serve
--processes N`` runs the multi-process cluster (``runtime/cluster.py``):
this process coordinates N worker processes, each a stream engine on
``--device`` (on one card every worker shares it), with ``--checkpoint``
restarts, ``--supervise`` host-loss recovery, CPU ``--spillover`` and
one federated ``--metrics-port`` surface.
"""

from __future__ import annotations

import argparse
import json
import sys

def theta_batch_arg(s: str):
    """Shared ``--theta`` argparse type (family + serve): a scalar
    ("1.5"), a comma-separated list ("1,1.5,2"), or ``@file.json``
    holding a number, a flat list, or a list of per-slot lists (the
    (m, T) theta-block batch form). Returns a float, a list of floats,
    or a list of lists of floats."""
    s = s.strip()
    if s.startswith("@"):
        with open(s[1:], encoding="utf-8") as fh:
            v = json.load(fh)
        if isinstance(v, (int, float)):
            return float(v)
        if isinstance(v, list):
            if v and all(isinstance(r, list) for r in v):
                return [[float(x) for x in r] for r in v]
            return [float(x) for x in v]
        raise argparse.ArgumentTypeError(
            f"{s}: JSON must be a number, a list, or a list of lists")
    if "," in s:
        return [float(x) for x in s.split(",") if x.strip() != ""]
    return float(s)


def tenant_quotas_arg(s: str) -> dict:
    """``--tenant-quotas`` argparse type: inline JSON or ``@file.json``
    mapping tenant name -> {"rate": R, "burst": B} token-bucket quota
    (``"*"`` is the default for tenants without their own entry)."""
    s = s.strip()
    try:
        if s.startswith("@"):
            with open(s[1:], encoding="utf-8") as fh:
                data = json.load(fh)
        else:
            data = json.loads(s)
    except (OSError, json.JSONDecodeError) as e:
        raise argparse.ArgumentTypeError(
            f"tenant quotas must be JSON or @file: {e}")
    if not isinstance(data, dict) or not all(
            isinstance(v, dict) for v in data.values()):
        raise argparse.ArgumentTypeError(
            "tenant quotas must be an object of per-tenant "
            '{"rate": R, "burst": B} objects')
    return data


def slo_config_arg(s: str) -> dict:
    """``--slo-config`` argparse type: inline JSON or ``@file.json``
    declaring per-tenant/per-class SLO targets and burn-rate windows
    (``obs.slo.parse_slo_config`` is the one validator)."""
    from ppls_tpu_torch.obs.slo import parse_slo_config
    try:
        return parse_slo_config(s)
    except (OSError, ValueError) as e:
        raise argparse.ArgumentTypeError(f"bad SLO config: {e}")


def tenants_arg(s: str) -> list:
    """``--tenants`` argparse type (synthetic load): either an integer
    N (tenants t0..tN-1, weight 1, priority i mod 3) or a
    ``name:weight:priority`` comma list — the deterministic tenant mix
    the bench/CI overload legs drive."""
    s = s.strip()
    if s.isdigit():
        if int(s) < 1:
            raise argparse.ArgumentTypeError(
                "tenant count must be >= 1")
        return [(f"t{i}", 1, i % 3) for i in range(int(s))]
    out = []
    for part in s.split(","):
        bits = part.strip().split(":")
        name = bits[0]
        try:
            weight = int(bits[1]) if len(bits) > 1 else 1
            pri = int(bits[2]) if len(bits) > 2 else 1
        except ValueError:
            raise argparse.ArgumentTypeError(
                f"bad tenant spec {part!r}: want name:weight:priority")
        if not name or weight < 1:
            raise argparse.ArgumentTypeError(
                f"bad tenant spec {part!r}: non-empty name, "
                f"weight >= 1")
        out.append((name, weight, pri))
    if not out:
        raise argparse.ArgumentTypeError("empty tenant spec")
    return out


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m ppls_tpu_torch",
        description="adaptive quadrature on NVIDIA GPUs (ppls_tpu_torch, "
                    "the PyTorch / CUDA port of ppls_tpu)",
        # no prefix abbreviation: the ROOT parser classifies every argv
        # string before subcommand dispatch, so a subcommand's exact
        # flag (`qmc --n`) would otherwise die as an "ambiguous"
        # abbreviation of the root's --n-devices/--n-workers
        allow_abbrev=False,
    )
    p.add_argument("--integrand", default="cosh4",
                   help="registered integrand name (default: cosh4, the "
                        "reference problem)")
    p.add_argument("-a", type=float, default=0.0, help="lower bound")
    p.add_argument("-b", type=float, default=5.0, help="upper bound")
    p.add_argument("--eps", type=float, default=1e-3,
                   help="per-interval split tolerance (reference EPSILON)")
    p.add_argument("--rule", choices=["trapezoid", "simpson"],
                   default="trapezoid")
    p.add_argument("--engine", choices=["host", "device", "sharded"],
                   default="host",
                   help="host: unbounded frontier, host loop; device: the "
                        "frontier on the device, one read per 16 rounds; "
                        "sharded: the wavefront across --n-devices ranks")
    p.add_argument("--backend", choices=["jax", "mpi", "spillover"],
                   default="jax",
                   help="jax: the engines on --device (the reference's "
                        "name for the accelerator path); mpi: the C "
                        "farmer/worker binary (requires an MPI "
                        "toolchain); spillover: float64 bag rounds on the "
                        "host CPU, by design")
    p.add_argument("--capacity", type=int, default=1 << 16)
    p.add_argument("--max-rounds", type=int, default=4096)
    p.add_argument("--n-devices", type=int, default=None)
    p.add_argument("--n-workers", type=int, default=4,
                   help="MPI backend only: worker process count")
    p.add_argument("--checkpoint", default=None,
                   help="snapshot path; resumes from it if it exists "
                        "(host engine only)")
    p.add_argument("--json", action="store_true", dest="as_json",
                   help="print one JSON line instead of the table")
    p.add_argument("--trace", default=None, metavar="DIR",
                   help="capture a torch.profiler trace of the run into "
                        "DIR (a Chrome trace, trace.json)")
    p.add_argument("--device", default="cuda",
                   help="the device every engine runs on (default cuda; "
                        "without a card only --device cpu runs)")

    sub = p.add_subparsers(
        dest="mode",
        description="additional problem modes (default: single 1D "
                    "integral with the flags above)")

    fam = sub.add_parser(
        "family", help="batch of independent 1D integrals "
                       "(BASELINE config #3)")
    fam.add_argument("--family", default="sin_recip_scaled",
                     help="registered family name f(x, theta)")
    fam.add_argument("--m", type=int, default=64, help="family size")
    fam.add_argument("--theta0", type=float, default=1.0)
    fam.add_argument("--theta1", type=float, default=2.0)
    fam.add_argument("--theta", type=theta_batch_arg, default=None,
                     help="explicit theta batch instead of the "
                          "theta0..theta1 linspace: a scalar, a "
                          "comma-separated list, or @file.json (a "
                          "flat list, or a list of per-slot lists "
                          "for --theta-block runs)")
    fam.add_argument("--theta-block", type=int, default=1,
                     dest="theta_block",
                     help="walker engine: T > 1 vectorizes theta — "
                          "one union-refinement frontier scores T "
                          "per-user thetas per interval (theta "
                          "becomes (m, T); requires --refill-slots "
                          "> 0, trapezoid rule, T a power of two "
                          "dividing the lane count)")
    fam.add_argument("-a", type=float, default=1e-4)
    fam.add_argument("-b", type=float, default=1.0)
    fam.add_argument("--eps", type=float, default=1e-8)
    fam.add_argument("--engine",
                     choices=["bag", "walker", "sharded-bag",
                              "sharded-walker", "sharded-walker-dd"],
                     default="bag",
                     help="bag: chunked-LIFO f64; walker: the ds "
                          "flagship (K1 with --refill-slots > 0, K2 "
                          "with 0); sharded-bag: the bag across "
                          "--n-devices ranks; sharded-walker / "
                          "sharded-walker-dd (aliases): the flagship "
                          "across the ranks via demand-driven "
                          "cross-rank root rebalancing")
    fam.add_argument("--rule", choices=["trapezoid", "simpson"],
                     default="trapezoid")
    fam.add_argument("--chunk", type=int, default=1 << 13)
    fam.add_argument("--capacity", type=int, default=1 << 20)
    fam.add_argument("--refill-slots", type=int, default=0,
                     help="walker and sharded-walker-dd engines: R > "
                          "0 deals R work-sorted roots per lane into a "
                          "private bank and the kernel refills its own "
                          "lanes (K1; the flagship bench config uses "
                          "8; on the dd engine also one rebalance per "
                          "walk phase); 0 = boundary refill (K2)")
    fam.add_argument("--scout-dtype", choices=["f64", "f32"],
                     default=None, dest="scout_dtype",
                     help="walker engine, trapezoid rule: 'f32' "
                          "enables mixed-precision scouting (f32 scout "
                          "test with a conservative guard band; "
                          "accepts re-confirmed in full ds); 'f64' "
                          "forces it off; default defers to the "
                          "PPLS_SCOUT=1 environment lane")
    fam.add_argument("--double-buffer", action="store_true",
                     dest="double_buffer",
                     help="walker engine with --refill-slots (even, "
                          ">= 2): rolling half-bank deals")
    fam.add_argument("--reduced-integrands", action="store_true",
                     dest="reduced_integrands",
                     help="prefer the range-reduced ds twin of the "
                          "family in the kernel; families without one "
                          "keep their ds twin")
    fam.add_argument("--n-devices", type=int, default=None)
    fam.add_argument("--checkpoint", default=None,
                     help="snapshot path (bag, walker, sharded-bag, and "
                          "sharded-walker-dd engines); resumes from it "
                          "if it exists")
    fam.add_argument("--watchdog", type=float, default=None,
                     metavar="SECONDS",
                     help="run the engine under a hang watchdog: on "
                          "deadline expiry the run is retried ONCE, "
                          "resuming from --checkpoint when a snapshot "
                          "exists. Size it WELL ABOVE the worst "
                          "healthy run time (kernel build included): "
                          "a timed-out attempt cannot be killed")
    fam.add_argument("--json", action="store_true", dest="as_json")
    fam.add_argument("--device", default=argparse.SUPPRESS,
                     help="the device the engine runs on (default: the "
                          "root parser's --device, cuda); without a "
                          "card only --device cpu runs")

    t2d = sub.add_parser(
        "2d", help="2D adaptive tensor-product cubature "
                   "(BASELINE config #4)")
    t2d.add_argument("--integrand", default="gauss2d_peak",
                     help="registered 2D integrand name")
    t2d.add_argument("--bounds", type=float, nargs=4,
                     default=[0.0, 1.0, 0.0, 1.0],
                     metavar=("AX", "BX", "AY", "BY"))
    t2d.add_argument("--eps", type=float, default=1e-8)
    t2d.add_argument("--rule", choices=["trapezoid", "simpson"],
                     default="simpson")
    t2d.add_argument("--chunk", type=int, default=1 << 12)
    t2d.add_argument("--capacity", type=int, default=1 << 20)
    t2d.add_argument("--n-devices", type=int, default=None,
                     help="run the sharded engine over this many chips "
                          "(default: the one-device engine)")
    t2d.add_argument("--checkpoint", default=None,
                     help="snapshot path (sharded engine only); resumes "
                          "from it if it exists")
    t2d.add_argument("--json", action="store_true", dest="as_json")
    t2d.add_argument("--device", default=argparse.SUPPRESS,
                     help="the device the engine runs on (default: the "
                          "root parser's --device, cuda); without a "
                          "card only --device cpu runs")

    srv = sub.add_parser(
        "serve",
        help="continuous-batching streaming integration service "
             "(phase-boundary admission/retirement of concurrent "
             "requests; runtime/stream.py)")
    srv.add_argument("--family", default="sin_recip_scaled",
                     help="registered family name f(x, theta); "
                          "eps/rule are per-engine (static compile "
                          "args), theta/bounds are per-request")
    srv.add_argument("--eps", type=float, default=1e-8)
    srv.add_argument("--rule", choices=["trapezoid", "simpson"],
                     default="trapezoid")
    srv.add_argument("--engine", choices=["walker", "walker-dd"],
                     default="walker",
                     help="walker: single-chip streaming flagship; "
                          "walker-dd: demand-driven multi-chip stream "
                          "(admission rides the phase reshard)")
    srv.add_argument("--slots", type=int, default=64,
                     help="concurrently resident request cap (family "
                          "slot pool; the pending queue is unbounded)")
    srv.add_argument("--chunk", type=int, default=1 << 13)
    srv.add_argument("--capacity", type=int, default=1 << 20)
    srv.add_argument("--lanes", type=int, default=None,
                     help="walker lanes (default: engine default)")
    srv.add_argument("--refill-slots", type=int, default=8)
    srv.add_argument("--scout-dtype", choices=["f64", "f32"],
                     default=None, dest="scout_dtype",
                     help="per-engine compile static: 'f32' = round-12 "
                          "mixed-precision scouting (see the family "
                          "subcommand's flag)")
    srv.add_argument("--double-buffer", action="store_true",
                     dest="double_buffer",
                     help="rolling half-bank refill deals (even "
                          "--refill-slots >= 2)")
    srv.add_argument("--reduced-integrands", action="store_true",
                     dest="reduced_integrands",
                     help="prefer the family's range-reduced ds twin")
    srv.add_argument("--n-devices", type=int, default=None)
    srv.add_argument("--processes", type=int, default=None,
                     help="run the service as a MULTI-"
                          "PROCESS cluster — N worker processes "
                          "(each with its own host-local engine over "
                          "its own devices) behind one coordinator "
                          "that deals requests, collects retirements "
                          "and, under --supervise, discovers the "
                          "surviving topology on host loss and "
                          "re-deals onto it")
    srv.add_argument("--spillover", action="store_true",
                     help="graceful degradation: queue-"
                          "overflow victims without a deadline run "
                          "as pure-f64 bag rounds on the host CPU "
                          "(slower-but-correct, off-mesh) instead of "
                          "being shed; requires --queue-limit to "
                          "have any effect. NOTE: deadline-bearing "
                          "requests are never spill-eligible (slower "
                          "capacity cannot bound latency), so a "
                          "--deadline-phases DEFAULT applied to every "
                          "request disables spillover entirely — "
                          "everything sheds queue_full")
    srv.add_argument("--spillover-limit", type=int, default=4,
                     dest="spillover_limit",
                     help="max spillover completions per phase "
                          "boundary (default 4)")
    srv.add_argument("--f64-rounds", type=int, default=0,
                     dest="f64_rounds",
                     help="K > 0 runs the engine in PURE-F64 "
                          "streaming mode (K LIFO bag rounds per "
                          "phase, no walk kernel) — the provably "
                          "batch-identical mode the determinism "
                          "contracts are stated on")
    srv.add_argument("--requests", default=None, metavar="FILE",
                     help="JSONL request stream: one "
                          '{"theta": T, "bounds": [A, B], '
                          '"arrival_phase": P?} per line; "-" = stdin. '
                          "Default: synthetic load (--synthetic)")
    srv.add_argument("--synthetic", type=int, default=16, metavar="K",
                     help="generated request count when --requests is "
                          "not given")
    srv.add_argument("--arrival-rate", type=float, default=2.0,
                     help="synthetic load: mean requests per phase "
                          "(open-loop Poisson arrivals, deterministic "
                          "via --seed)")
    srv.add_argument("--seed", type=int, default=0)
    srv.add_argument("--theta0", type=float, default=1.0)
    srv.add_argument("--theta1", type=float, default=2.0)
    srv.add_argument("--theta", type=theta_batch_arg, default=None,
                     help="synthetic-mode theta source: scalar, "
                          "comma-separated list, or @file.json "
                          "(replaces the theta0..theta1 linspace; "
                          "with --theta-block the list is chunked "
                          "into per-request blocks of up to T)")
    srv.add_argument("--theta-block", type=int, default=1,
                     dest="theta_block",
                     help="per-engine compile static: T > 1 makes "
                          "each request a THETA BATCH of up to T "
                          "per-user thetas over one shared frontier "
                          "(JSONL requests may then pass a theta "
                          "list); retirement emits per-theta areas")
    srv.add_argument("-a", type=float, default=1e-3)
    srv.add_argument("-b", type=float, default=1.0)
    srv.add_argument("--checkpoint", default=None,
                     help="stream snapshot path (queue + walker state, "
                          "written every --checkpoint-every phases); "
                          "resumes from it if it exists")
    srv.add_argument("--checkpoint-every", type=int, default=8)
    srv.add_argument("--events", default=None, metavar="FILE",
                     help="structured JSONL event log (obs.spans): the "
                          "run -> phase span timeline with admit/"
                          "retire/checkpoint events and device-counter "
                          "deltas attached; schema-validated shape "
                          "(tools/check_artifacts.py --events FILE); a "
                          "resumed run APPENDS a new segment")
    srv.add_argument("--metrics-port", type=int, default=None,
                     metavar="PORT",
                     help="serve Prometheus-style exposition text "
                          "(queue depth, slot occupancy, per-phase "
                          "counters, compile-cache size, rolling "
                          "p50/p99 retire latency) on 127.0.0.1:PORT "
                          "for the lifetime of the run (0 = ephemeral "
                          "port, printed to stderr). With --processes "
                          "this is the FEDERATED cluster "
                          "surface: every worker's registry merged "
                          "under a process label plus the "
                          "coordinator's own (process=coordinator), "
                          "cluster totals reconciling exactly. GET "
                          "/health returns the SLO burn verdict when "
                          "--slo-config is armed")
    srv.add_argument("--events-max-mb", type=float, default=None,
                     dest="events_max_mb", metavar="MB",
                     help="size-cap the --events file — "
                          "past the cap the timeline rolls to "
                          "FILE.1, FILE.2, ... at a span-safe "
                          "boundary and continues in a fresh segment "
                          "at FILE (every rolled file is a valid "
                          "multi-meta-segment timeline; "
                          "tools/analyze_request.py reads the whole "
                          "chain automatically)")
    srv.add_argument("--slo-config", type=slo_config_arg,
                     default=None, dest="slo_config",
                     metavar="JSON|@FILE",
                     help="arm SLO burn-rate alerting — "
                          "per-tenant/per-class targets "
                          '({"slos": [{"slo": "p99_latency_phases", '
                          '"target": 12, "objective": 0.99, '
                          '"class": "2"}, ...]}) evaluated at every '
                          "phase boundary over the registry the "
                          "boundary already publishes (fast/slow "
                          "phase windows; slo_burn events + "
                          "ppls_slo_burn_total + the /health verdict "
                          "on --metrics-port)")
    srv.add_argument("--watchdog", type=float, default=None,
                     metavar="SECONDS",
                     help="hang watchdog around the serve loop "
                          "(runtime.guard): on expiry the loop is "
                          "retried once, resuming from --checkpoint "
                          "when a snapshot exists. CAVEAT: a timed-out "
                          "attempt cannot be killed (guard.py's "
                          "deadline contract), so after an expiry the "
                          "JSONL stream may carry duplicate rids — "
                          "the stale attempt's lines plus the "
                          "resume's replay since the last snapshot; "
                          "consumers must dedupe by rid. Size the "
                          "deadline well above a healthy phase")
    srv.add_argument("--supervise", action="store_true",
                     help="run the serve loop under the round-14 "
                          "self-healing Supervisor (runtime.guard): "
                          "transient failures get deterministic "
                          "exponential backoff + checkpoint resume, "
                          "chip loss gets resize-resume onto the "
                          "surviving mesh, corrupt snapshots fall "
                          "back to a fresh start, and NaN-poisoned "
                          "requests are quarantined (implies "
                          "--quarantine). Auto-enabled when a fault "
                          "plan is armed. --watchdog then sizes the "
                          "per-attempt hang deadline")
    srv.add_argument("--quarantine", action="store_true",
                     help="per-request NaN quarantine: a request "
                          "whose area goes non-finite retires as a "
                          "failed record (failed=true, area=null) "
                          "while healthy concurrent requests retire "
                          "normally, instead of an engine-wide "
                          "FloatingPointError")
    srv.add_argument("--ingest-port", type=int, default=None,
                     metavar="PORT", dest="ingest_port",
                     help="accept request records over HTTP "
                          "for the lifetime of the run (POST /submit, "
                          "JSONL body; one JSONL verdict per line — "
                          "rid ack, shed record, or per-line "
                          "rejection; 0 = ephemeral port, announced "
                          "on stderr and the summary line). An "
                          "accepted ack means the request is in the "
                          "checkpointed queue: a SIGTERM after it is "
                          "never lost. The loop then runs until "
                          "SIGTERM/SIGINT")
    srv.add_argument("--queue-limit", type=int, default=None,
                     dest="queue_limit",
                     help="bound the pending queue: an arrival that "
                          "would overflow it triggers the "
                          "deterministic shed policy (lowest-priority-"
                          "oldest victim; the arrival itself when it "
                          "does not outrank one), each shed an "
                          "explicit JSONL rejection record + "
                          "request_shed event (default: unbounded)")
    srv.add_argument("--tenant-quotas", type=tenant_quotas_arg,
                     default=None, dest="tenant_quotas",
                     metavar="JSON|@FILE",
                     help="per-tenant token-bucket admission quotas: "
                          '{"pro": {"rate": 4, "burst": 8}, '
                          '"*": {...}} — rate tokens/phase up to '
                          "burst; an out-of-tokens tenant's requests "
                          "wait, they are not shed")
    srv.add_argument("--deadline-phases", type=int, default=None,
                     dest="deadline_phases",
                     help="default per-request deadline (device "
                          "phases from submit): a queued request that "
                          "can no longer meet it is shed, an in-"
                          "flight one retires failed with "
                          "deadline_exceeded and its work is "
                          "cancelled; JSONL requests may override "
                          "per-request")
    srv.add_argument("--tenants", type=tenants_arg, default=None,
                     metavar="N|SPEC",
                     help="synthetic load only: assign tenants/"
                          "priorities to the generated requests — an "
                          "integer N (t0..tN-1, priority i mod 3) or "
                          "a name:weight:priority comma list "
                          "(deterministic weighted round-robin)")
    srv.add_argument("--fault-plan", default=None, metavar="SPEC",
                     dest="fault_plan",
                     help="arm seeded fault injection "
                          "(runtime/faults.py): inline JSON event "
                          "list, @file.json, or seed:<n>[:<k>]; "
                          "PPLS_FAULT_PLAN is the env spelling (flag "
                          "wins). Injected faults fire at phase/"
                          "checkpoint/admit boundaries, emit "
                          "fault_injected events, and the supervisor "
                          "(auto-enabled) recovers the run")
    srv.add_argument("--adapt", action="store_true",
                     help="online host-knob adaptation at "
                          "phase boundaries — the engine nudges its "
                          "admission budget and spillover limit "
                          "within declared safe bands from the "
                          "phase-stats row it already fetched "
                          "(hysteresis + per-phase step clamps; "
                          "knob_adapt events; adapted values ride the "
                          "snapshot so kill-and-resume replays bit-"
                          "identically). Cadence/sizing defaults come "
                          "from the committed tuning table "
                          "(tools/tuning_table.json; override or "
                          "disable via PPLS_TUNING_TABLE)")
    srv.add_argument("--dispatch", action="store_true",
                     help="heterogeneous-shape dispatcher — "
                          "a bounded pool of engines keyed by "
                          "canonicalized (eps band, rule, theta "
                          "bucket) compile statics behind one serving "
                          "surface (runtime/dispatch.py). Requests "
                          "may then carry per-request 'eps'/'rule' "
                          "routing keys (JSONL and POST /submit); "
                          "--eps/--rule become the POOL DEFAULTS for "
                          "requests that omit them, --theta-block is "
                          "ignored (batches bucket to powers of two "
                          "automatically), and the summary gains the "
                          "per-engine decomposition plus the pool "
                          "recompile count (pinned 0 on mixed-shape "
                          "traffic — the tier's whole invariant)")
    srv.add_argument("--max-engines", type=int, default=4,
                     dest="max_engines", metavar="N",
                     help="--dispatch pool cap: at most N live "
                          "engines; an over-cap key parks the LRU "
                          "victim through a checkpoint and resumes "
                          "it bit-identically when its shape returns "
                          "(default 4)")
    srv.add_argument("--lease", action="store_true",
                     help="slot-credit leasing across the "
                          "--dispatch pool — engines with idle slots "
                          "(and parked engines) donate their per-turn "
                          "phase credit to the deepest-backlog engine "
                          "(deterministic donor/borrower policy with "
                          "hysteresis; the lease ledger rides the "
                          "coordinated snapshot so kill-and-resume "
                          "replays every grant bit-identically)")
    srv.add_argument("--overlap-boundaries", action="store_true",
                     dest="overlap_boundaries",
                     help="overlapped phase boundaries — "
                          "launch every due engine's compiled cycle "
                          "before blocking on the first stats fetch "
                          "(asynchronous dispatch) and run checkpoint "
                          "serialization on a background writer that "
                          "keeps the atomic-rename commit point; "
                          "requires --dispatch")
    srv.add_argument("--json", action="store_true", dest="as_json")
    srv.add_argument("--device", default=argparse.SUPPRESS,
                     help="the device every engine runs on (default: "
                          "the root parser's --device, cuda); without a "
                          "card only --device cpu runs")

    qmc = sub.add_parser(
        "qmc", help="8D Genz suite via shifted-lattice QMC "
                    "(BASELINE config #5)")
    qmc.add_argument("--genz", default="all",
                     help="Genz family name, or 'all'")
    qmc.add_argument("--n", type=int, default=1 << 18,
                     help="lattice size (2^16/2^18/2^20/2^22)")
    qmc.add_argument("--shifts", type=int, default=8)
    qmc.add_argument("--dim", type=int, default=8)
    qmc.add_argument("--seed", type=int, default=0,
                     help="Genz parameter draw seed")
    qmc.add_argument("--n-devices", type=int, default=None,
                     help="split the lattice over this many chips")
    qmc.add_argument("--json", action="store_true", dest="as_json")
    qmc.add_argument("--device", default=argparse.SUPPRESS,
                     help="the device the lattice runs on (default: the "
                          "root parser's --device, cuda); without a "
                          "card only --device cpu runs")
    return p


def _check_serve_flags(args) -> None:
    """Exit non-zero on a combination of ``serve`` flags the reference
    refuses, in its wording, before any engine or worker starts."""
    if args.processes is not None:
        if args.dispatch:
            raise SystemExit(
                "--dispatch is not supported with --processes (the "
                "pool is the single-process multi-ENGINE tier, the "
                "cluster is the multi-PROCESS tier); pick one")
        if args.processes < 1:
            # a sweep script parameterized over process counts must get
            # a refusal for P<1, not a silently different engine
            raise SystemExit(
                f"--processes must be >= 1 (got {args.processes}); "
                f"drop the flag to run the single-process engine")
        if args.ingest_port is not None:
            raise SystemExit(
                "--ingest-port is not supported with --processes "
                "(the cluster coordinator owns the request deal); "
                "drive the batch/synthetic schedule instead")
        if args.tenant_quotas is not None:
            raise SystemExit(
                "--tenant-quotas is not supported with --processes "
                "(the cluster coordinator does not implement "
                "per-tenant token buckets); drop the flag or run "
                "single-process")
    if args.dispatch and args.spillover:
        raise SystemExit(
            "--spillover is not supported with --dispatch (queue "
            "overflow is the POOL's shed policy; the CPU spillover "
            "executor is per-engine); drop one of the flags")
    if not args.dispatch and (args.lease or args.overlap_boundaries):
        raise SystemExit(
            "--lease/--overlap-boundaries require --dispatch (they "
            "are cross-engine pool policies); add --dispatch or drop "
            "the flags")
    if args.n_devices is not None and args.n_devices != 1 \
            and args.engine != "walker-dd":
        raise SystemExit(
            f"--n-devices {args.n_devices} applies to --engine walker-dd; "
            f"the walker engine runs on one card")


def _main_serve(args) -> int:
    """Streaming service loop: submit requests on their arrival
    schedule, emit one JSON line per retirement, end with a summary
    line (``"summary": true``)."""
    import os
    import threading
    import time

    import numpy as np

    from ppls_tpu_torch.config import Rule
    from ppls_tpu_torch.runtime.ingest import parse_request_record

    _check_serve_flags(args)
    device = _resolve(args, "serve")

    # ---- materialize the request list + open-loop arrival schedule ----
    # every request is a (theta, bounds, kwargs) triple, kwargs carrying
    # tenant/priority/deadline_phases. A malformed JSONL line emits a
    # per-line rejection record and the loop continues; the same parser
    # backs the --ingest-port HTTP path.
    T = int(args.theta_block)
    dispatch = bool(args.dispatch)
    if dispatch:
        # the pool buckets theta batches itself: the parse-time cap is
        # the dispatcher's lattice cap, and records may carry the
        # per-request eps/rule routing keys (synthetic generation still
        # chunks by --theta-block)
        from ppls_tpu_torch.runtime.dispatch import MAX_THETA_BUCKET
        Tcap = MAX_THETA_BUCKET
    else:
        Tcap = T
    if args.requests:
        fh = sys.stdin if args.requests == "-" else open(args.requests)
        try:
            reqs, arrivals = [], []
            for lineno, line in enumerate(fh, 1):
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = parse_request_record(json.loads(line),
                                               theta_block=Tcap,
                                               dispatch=dispatch)
                except (json.JSONDecodeError, ValueError) as e:
                    print(json.dumps({
                        "rejected": True, "line": lineno,
                        "error": str(e)[:200]}), flush=True)
                    continue
                arrivals.append(int(rec.pop("arrival_phase", 0)))
                reqs.append((rec.pop("theta"), rec.pop("bounds"),
                             rec))
        finally:
            if fh is not sys.stdin:
                fh.close()
    else:
        # deterministic Poisson-ish open-loop load: exponential
        # interarrivals at --arrival-rate requests/phase, seeded
        rng = np.random.default_rng(args.seed)
        k = int(args.synthetic)
        if args.theta is not None:
            tv = args.theta
            if isinstance(tv, float):
                tv = [tv]
            if tv and isinstance(tv[0], list):
                blocks = [tuple(float(x) for x in r) for r in tv]
            else:
                flat = [float(x) for x in tv]
                step = max(T, 1)
                blocks = [tuple(flat[i:i + step])
                          for i in range(0, len(flat), step)]
            k = len(blocks)
        else:
            thetas = np.linspace(args.theta0, args.theta1, k * max(T, 1),
                                 endpoint=False)
            blocks = [tuple(thetas[i * T:(i + 1) * T]) for i in range(k)]
        if k:
            gaps = rng.exponential(1.0 / max(args.arrival_rate, 1e-9),
                                   k)
            arrivals = [int(p) for p in
                        np.floor(np.cumsum(gaps) - gaps[0]).astype(int)]
        else:
            arrivals = []          # pure-ingest service: no batch load
        # deterministic weighted round-robin tenant/priority mix
        cycle = [("default", 1)]
        if args.tenants:
            cycle = [(name, pri) for name, weight, pri in args.tenants
                     for _ in range(weight)]
        reqs = [((b if T > 1 else float(b[0])), (args.a, args.b),
                 {"tenant": cycle[i % len(cycle)][0],
                  "priority": cycle[i % len(cycle)][1]})
                for i, b in enumerate(blocks)]

    # the loop admits in list order gated on arrival_phase, so sort
    # (stably) by arrival phase first; rids then follow sorted order,
    # which the resume's batch_cursor relies on
    order = sorted(range(len(reqs)), key=lambda i: arrivals[i])
    reqs = [reqs[i] for i in order]
    arrivals = [arrivals[i] for i in order]

    if args.processes is not None:
        # the multi-process cluster: this process coordinates N workers
        return _main_serve_cluster(args, reqs, arrivals, device)

    kw = dict(rule=Rule(args.rule), slots=args.slots, chunk=args.chunk,
              capacity=args.capacity, refill_slots=args.refill_slots,
              scout_dtype=args.scout_dtype,
              double_buffer=args.double_buffer,
              reduced_integrands=args.reduced_integrands,
              theta_block=T, engine=args.engine,
              f64_rounds=args.f64_rounds,
              checkpoint_every=args.checkpoint_every,
              queue_limit=args.queue_limit,
              tenant_quotas=args.tenant_quotas,
              default_deadline_phases=args.deadline_phases,
              spillover=args.spillover,
              spillover_limit=args.spillover_limit,
              slo_config=args.slo_config, adapt=bool(args.adapt),
              device=device)
    if args.lanes:
        kw["lanes"] = args.lanes

    # seeded fault injection + self-healing supervision. The injector
    # outlives engine attempts (a consumed fault must not re-fire in the
    # resumed run); supervision arms itself with a plan.
    from ppls_tpu_torch.runtime.faults import FaultInjector, FaultPlan
    plan = (FaultPlan.from_spec(args.fault_plan)
            if args.fault_plan else FaultPlan.from_env())
    supervise = bool(args.supervise or plan is not None
                     or os.environ.get("PPLS_CHAOS") == "1")
    quarantine = bool(args.quarantine or supervise)
    # the world size: the supervisor's resize-resume shrinks it when a
    # chip is lost, and every later engine build targets the survivors
    state = {"n_devices": args.n_devices}

    # one Telemetry per engine attempt (registry served on
    # --metrics-port, the --events timeline), built in make_engine so a
    # retry gets a fresh registry and appends a resume segment
    holder = {}

    class _TelProxy:
        """Forwarder onto the CURRENT attempt's telemetry: the injector
        and the supervisor outlive engine attempts."""

        def event(self, name, **attrs):
            if "tel" in holder:
                holder["tel"].event(name, **attrs)

        @property
        def registry(self):
            from ppls_tpu_torch.obs.registry import MetricsRegistry
            if "tel" in holder:
                return holder["tel"].registry
            return holder.setdefault("_early_reg", MetricsRegistry())

    tel_proxy = _TelProxy()
    injector = (FaultInjector(plan, telemetry=tel_proxy)
                if plan is not None else None)

    # one lock for every stdout JSONL line: shed records print from
    # ingest handler threads (inside eng.submit) while retire records
    # print from the serve loop
    io_lock = threading.Lock()

    def _print_shed(rec):
        with io_lock:
            print(json.dumps(_serve_shed_record(rec)), flush=True)

    def make_pool(tel, resuming):
        """The heterogeneous pool in place of the single engine, behind
        the same serve surface (submit/step/snapshot/result alias;
        per-request eps/rule route)."""
        from ppls_tpu_torch.runtime.checkpoint import CheckpointCorruptError
        from ppls_tpu_torch.runtime.dispatch import EngineDispatcher
        engine_kw = dict(
            chunk=args.chunk, capacity=args.capacity,
            refill_slots=args.refill_slots, scout_dtype=args.scout_dtype,
            double_buffer=args.double_buffer,
            reduced_integrands=args.reduced_integrands,
            engine=args.engine, f64_rounds=args.f64_rounds,
            n_devices=state["n_devices"], adapt=bool(args.adapt))
        if args.lanes:
            engine_kw["lanes"] = args.lanes
        dkw = dict(
            slots=args.slots, max_engines=args.max_engines,
            default_eps=args.eps, default_rule=Rule(args.rule),
            queue_limit=args.queue_limit,
            tenant_quotas=args.tenant_quotas,
            default_deadline_phases=args.deadline_phases,
            checkpoint_every=args.checkpoint_every, telemetry=tel,
            slo_config=args.slo_config, lease=bool(args.lease),
            overlap_boundaries=bool(args.overlap_boundaries),
            fault_injector=injector, quarantine=quarantine,
            on_shed=_print_shed, device=device, engine_kw=engine_kw)
        if resuming:
            try:
                return EngineDispatcher.resume(args.checkpoint,
                                               args.family, **dkw)
            except CheckpointCorruptError as e:
                print(f"serve: {e}; starting fresh", file=sys.stderr,
                      flush=True)
                tel.event("checkpoint_corrupt", path=args.checkpoint,
                          detail=str(e)[:200])
                if os.path.exists(args.checkpoint):
                    os.unlink(args.checkpoint)
        return EngineDispatcher(args.family,
                                checkpoint_path=args.checkpoint, **dkw)

    def make_engine():
        from ppls_tpu_torch.obs.telemetry import Telemetry
        from ppls_tpu_torch.runtime.checkpoint import CheckpointCorruptError
        from ppls_tpu_torch.runtime.stream import StreamEngine
        resuming = bool(args.checkpoint
                        and os.path.exists(args.checkpoint))
        if "tel" in holder:
            # a retry releases the previous attempt's events file handle
            # before the new segment opens it
            holder["tel"].close()
        if "engine" in holder:
            # and the previous attempt's ranks (walker-dd)
            holder.pop("engine").close()
        tel = Telemetry(
            events_path=args.events,
            meta={"mode": "serve", "engine": args.engine,
                  "family": args.family, "eps": args.eps,
                  "rule": args.rule, "slots": args.slots,
                  "lanes": args.lanes or 0, "seed": args.seed,
                  "requests": len(reqs), "resumed": resuming,
                  **({"dispatch": True,
                      "max_engines": args.max_engines}
                     if dispatch else {})},
            append=resuming,
            events_max_bytes=(int(args.events_max_mb * (1 << 20))
                              if args.events_max_mb else None))
        holder["tel"] = tel
        if dispatch:
            holder["engine"] = make_pool(tel, resuming)
            return holder["engine"]
        ekw = dict(kw, n_devices=state["n_devices"], quarantine=quarantine,
                   fault_injector=injector, telemetry=tel,
                   on_shed=_print_shed)
        if resuming:
            try:
                # mesh_resize: after a chip loss the survivors' engine
                # resumes the larger world's snapshot through the
                # elastic rule (a no-op at equal sizes)
                holder["engine"] = StreamEngine.resume(
                    args.checkpoint, args.family, args.eps,
                    mesh_resize=True, **ekw)
                return holder["engine"]
            except CheckpointCorruptError as e:
                # self-healing: a damaged snapshot cannot be resumed;
                # discard it and start fresh (rids are deterministic, so
                # the re-run drains to a correct summary; pre-crash JSONL
                # lines dedupe by rid)
                print(f"serve: {e}; starting fresh", file=sys.stderr,
                      flush=True)
                tel.event("checkpoint_corrupt", path=args.checkpoint,
                          detail=str(e)[:200])
                if os.path.exists(args.checkpoint):
                    os.unlink(args.checkpoint)
        holder["engine"] = StreamEngine(args.family, args.eps,
                                        checkpoint_path=args.checkpoint,
                                        **ekw)
        return holder["engine"]

    # cooperative SIGTERM/SIGINT: the loop reads the flag at phase
    # boundaries and winds down with a final checkpoint, a balanced span
    # close and the summary. One EngineHandle per attempt, resolved
    # through the holder: a hung attempt keeps its own lock, the retry
    # and the ingest threads move to the new one.
    from ppls_tpu_torch.runtime.guard import GracefulShutdown
    from ppls_tpu_torch.runtime.ingest import EngineHandle
    stop = GracefulShutdown()
    holder["handle"] = EngineHandle()

    metrics_srv = None
    if args.metrics_port is not None:
        from ppls_tpu_torch.obs.registry import MetricsRegistry
        from ppls_tpu_torch.obs.server import MetricsServer
        _empty = MetricsRegistry()

        def _health():
            # a supervisor backoff window (no live engine) reports
            # not-ok so a load balancer drains during recovery
            eng = holder["handle"].peek()
            if eng is None:
                return {"ok": False, "burning": [], "ready": False}
            return eng.slo_health()

        metrics_srv = MetricsServer(
            lambda: (holder["tel"].registry if "tel" in holder
                     else _empty),
            port=args.metrics_port, health_fn=_health)
        # the bound port is announced before the first phase (and again
        # on the summary line), so --metrics-port 0 is discoverable
        print(f"serve: metrics on {metrics_srv.url}", file=sys.stderr,
              flush=True)

    ingest_srv = None
    if args.ingest_port is not None:
        from ppls_tpu_torch.runtime.ingest import IngestServer

        def ingest_submit(d):
            rec = parse_request_record(d, theta_block=Tcap,
                                       dispatch=dispatch)
            rec.pop("arrival_phase", None)     # live ingest is "now"
            h = holder["handle"]          # the CURRENT attempt's
            with h.lock():
                eng = h.peek()
                if eng is None or stop.requested:
                    raise ValueError("service not accepting requests")
                n0 = len(eng.shed)
                rid = eng.submit(rec.pop("theta"),
                                 rec.pop("bounds"), **rec)
                if len(eng.shed) > n0 and eng.shed[-1].rid == rid:
                    return {"rid": rid, "accepted": False,
                            "shed": True,
                            "reason": eng.shed[-1].reason}
                return {"rid": rid, "accepted": True}

        def ingest_stats():
            eng = holder["handle"].peek()
            if eng is None:
                return {"ready": False}
            return {"ready": True, "phase": eng.phase,
                    "pending": eng.pending, "resident": eng.resident,
                    "completed": len(eng.completed),
                    "shed": len(eng.shed)}

        ingest_srv = IngestServer(ingest_submit,
                                  port=args.ingest_port,
                                  stats_fn=ingest_stats)
        print(f"serve: ingest on {ingest_srv.url}", file=sys.stderr,
              flush=True)

    def serve_loop():
        t0 = time.perf_counter()
        handle = EngineHandle()
        holder["handle"] = handle
        eng = make_engine()
        handle.publish(eng)
        span = eng.telemetry.span("run", mode="serve",
                                  engine=("dispatch-pool" if dispatch
                                          else f"{args.engine}-stream"),
                                  requests=len(reqs))
        # a resumed engine skips the request-list prefix it submitted
        # before the crash: the cursor rides the snapshot's client_state
        # (sheds and ingest submissions consume rids too, so next_rid
        # alone would mis-skip)
        k = int(eng.client_state.setdefault("batch_cursor",
                                            eng.next_rid))
        # replay the retire records the snapshot holds but this ledger
        # never printed (a cut inside step() precedes its phase's
        # prints): at-least-once, consumers dedupe by rid
        done = int(eng.client_state.setdefault("printed_cursor", 0))
        if done < len(eng.completed):
            with io_lock:
                for c in eng.completed[done:]:
                    print(json.dumps(_serve_completed_record(c)),
                          flush=True)
        eng.client_state["printed_cursor"] = len(eng.completed)
        ingest_on = ingest_srv is not None
        while (k < len(reqs) or not eng.idle or ingest_on) \
                and not stop.requested:
            with handle.lock():
                try:
                    while k < len(reqs) and arrivals[k] <= eng.phase:
                        r = reqs[k]
                        eng.submit(r[0], r[1],
                                   **(r[2] if len(r) > 2 else {}))
                        k += 1
                        eng.client_state["batch_cursor"] = k
                    idle_wait = ingest_on and k >= len(reqs) \
                        and eng.idle
                    retired = [] if idle_wait else eng.step()
                except BaseException:
                    # a failed attempt's engine is dead state: clearing
                    # the handle under the lock makes ingest refuse
                    # (clients retry) until the next attempt publishes
                    handle.clear()
                    raise
            with io_lock:
                for c in retired:
                    print(json.dumps(_serve_completed_record(c)),
                          flush=True)
            # only this thread moves the cursor; the next step()'s
            # snapshot (under the engine lock) persists it
            eng.client_state["printed_cursor"] = len(eng.completed)
            if idle_wait:
                time.sleep(0.02)
        if stop.requested:
            # graceful shutdown: the pending queue rides the final
            # snapshot, so a restart loses no acknowledged request
            holder["stopped"] = stop.signal_name or "signal"
            with handle.lock():
                if args.checkpoint:
                    eng.snapshot()
                eng.telemetry.event(
                    "graceful_shutdown", signal=holder["stopped"],
                    phase=eng.phase, pending=eng.pending,
                    resident=eng.resident,
                    completed=len(eng.completed))
        span.close(phases=eng.phase, completed=len(eng.completed),
                   **({"terminated": holder["stopped"]}
                      if stop.requested else {}))
        return eng, time.perf_counter() - t0

    supervisor = None
    try:
        stop.__enter__()
        if supervise:
            from ppls_tpu_torch.runtime.guard import Supervisor

            def resize_fn(exc):
                # chip loss: every later engine build (the resumed
                # serve_loop's make_engine) targets the surviving ranks
                state["n_devices"] = exc.surviving
                return serve_loop

            supervisor = Supervisor(
                serve_loop, resize_fn=resize_fn, deadline=args.watchdog,
                telemetry=tel_proxy, backoff_base=0.25, backoff_cap=30.0)
            eng, wall = supervisor.run()
        elif args.watchdog:
            from ppls_tpu_torch.runtime.guard import run_with_watchdog
            eng, wall = run_with_watchdog(
                serve_loop, args.watchdog, what="serve loop",
                resume_fn=serve_loop if args.checkpoint else None,
                telemetry=tel_proxy,
                checkpoint_path=args.checkpoint)
        else:
            eng, wall = serve_loop()

        if args.checkpoint and not holder.get("stopped"):
            # a graceful shutdown keeps its snapshot (the restart state);
            # a drained run clears it
            eng.clear_snapshot()
        res = eng.result(wall_s=wall)
        summary = {
            "summary": True,
            "engine": args.engine, "family": args.family,
            "eps": args.eps,
            "rule": args.rule, "slots": args.slots,
            "completed": len(res.completed), "phases": res.phases,
            "wall_s": round(wall, 3),
            "requests_per_sec": round(res.requests_per_sec, 3),
            "latency": res.latency_percentiles(),
            "latency_by_class": res.class_latency_percentiles(),
            "tenants": res.tenant_summary(),
            "shed": len(res.shed),
            "occupancy": res.occupancy_summary(eng.lanes),
            "totals": res.totals,
        }
        if res.shed:
            reasons = {}
            for s in res.shed:
                reasons[s.reason] = reasons.get(s.reason, 0) + 1
            summary["shed_reasons"] = reasons
        summary["spillover"] = eng.spillover_summary()
        if dispatch:
            # the pool's numbers: recompiles (0 on mixed-shape traffic),
            # the per-key decomposition and the lease ledger
            summary["dispatch"] = True
            summary["max_engines"] = args.max_engines
            summary["recompiles"] = eng.recompiles()
            summary["engines"] = eng.engines_summary()
            summary["leases"] = eng.lease_summary()
        if holder.get("stopped"):
            summary["terminated"] = holder["stopped"]
        failed = sum(1 for c in res.completed if c.failed)
        if quarantine or failed:
            summary["failed"] = failed
        deadline_failed = sum(1 for c in res.completed
                              if c.failure == "deadline_exceeded")
        if deadline_failed:
            summary["deadline_exceeded"] = deadline_failed
        if supervisor is not None:
            summary["supervised"] = True
            summary["attempts"] = supervisor.attempts
            summary["recoveries"] = [
                {"kind": k, "action": a}
                for k, a in supervisor.recoveries]
        if injector is not None:
            summary["faults_injected"] = [
                ev.describe() for ev in injector.plan.events
                if ev.fired]
        if metrics_srv is not None:
            summary["metrics_port"] = metrics_srv.port
            summary["metrics_url"] = metrics_srv.url
        if ingest_srv is not None:
            summary["ingest_port"] = ingest_srv.port
            summary["ingest_url"] = ingest_srv.url
        if res.mesh is not None:
            summary["mesh"] = res.mesh
        print(json.dumps(summary))
        return 0
    finally:
        stop.__exit__()
        if "engine" in holder:
            holder.pop("engine").close()
        if ingest_srv is not None:
            ingest_srv.close()
        if "tel" in holder:
            holder["tel"].close()
        if metrics_srv is not None:
            metrics_srv.close()


def _serve_completed_record(c) -> dict:
    """One completed request as its stdout-JSONL ledger record. A failed
    request (NaN quarantine, deadline expiry) reports area null (the
    non-finite payload is not strict JSON) plus the failed marker and
    its failure reason."""
    return {
        "rid": c.rid,
        "theta": (list(c.theta)
                  if isinstance(c.theta, (tuple, list)) else c.theta),
        **({"areas": c.areas}
           if c.areas is not None and not c.failed else {}),
        "bounds": list(c.bounds),
        "area": (None if c.failed else c.area),
        **({"failed": True} if c.failed else {}),
        **({"failure": c.failure} if c.failure else {}),
        **({"spillover": True} if c.spillover else {}),
        "tenant": c.tenant, "priority": c.priority,
        "admit_phase": c.admit_phase,
        "retire_phase": c.retire_phase,
        "phases_in_flight": c.phases_in_flight,
        "latency_phases": c.latency_phases,
        "latency_s": round(c.latency_s, 4)}


def _serve_shed_record(s) -> dict:
    """One shed request as its explicit JSONL rejection record, in the
    same stream as the retirements, so a consumer can account for every
    acknowledged rid."""
    return {
        "rid": s.rid, "shed": True, "reason": s.reason,
        "tenant": s.tenant, "priority": s.priority,
        "phase": s.phase,
        "theta": (list(s.theta)
                  if isinstance(s.theta, (tuple, list)) else s.theta),
        "bounds": list(s.bounds)}


def _main_serve_cluster(args, reqs, arrivals, device) -> int:
    """The multi-process serve path: one coordinator (this process)
    deals the request schedule over N worker processes on ``device``,
    prints the same JSONL ledger + summary as the single-process path
    and, under supervision, survives a real worker death: host-loss
    discovery + re-deal onto the survivors, per-request areas preserved
    (the schedule-independence contract)."""
    import glob
    import os
    import time

    from ppls_tpu_torch.obs.telemetry import Telemetry
    from ppls_tpu_torch.runtime.checkpoint import CheckpointCorruptError
    from ppls_tpu_torch.runtime.cluster import ClusterStreamEngine
    from ppls_tpu_torch.runtime.faults import FaultInjector, FaultPlan
    from ppls_tpu_torch.runtime.guard import GracefulShutdown, Supervisor

    plan = (FaultPlan.from_spec(args.fault_plan)
            if args.fault_plan else FaultPlan.from_env())
    supervise = bool(args.supervise or plan is not None
                     or os.environ.get("PPLS_CHAOS") == "1")
    quarantine = bool(args.quarantine or supervise)
    resuming = bool(args.checkpoint
                    and os.path.exists(args.checkpoint))
    tel = Telemetry(
        events_path=args.events,
        meta={"mode": "serve-cluster", "engine": args.engine,
              "family": args.family, "eps": args.eps,
              "rule": args.rule, "slots": args.slots,
              "processes": int(args.processes), "seed": args.seed,
              "requests": len(reqs), "resumed": resuming},
        append=resuming,
        events_max_bytes=(int(args.events_max_mb * (1 << 20))
                          if args.events_max_mb else None))
    injector = (FaultInjector(plan, telemetry=tel)
                if plan is not None else None)

    worker_kw = dict(
        rule=args.rule, slots=args.slots, chunk=args.chunk,
        capacity=args.capacity, refill_slots=args.refill_slots,
        scout_dtype=args.scout_dtype,
        double_buffer=args.double_buffer,
        reduced_integrands=args.reduced_integrands,
        theta_block=int(args.theta_block),
        engine=args.engine, n_devices=args.n_devices,
        f64_rounds=int(args.f64_rounds),
        quarantine=quarantine)
    if args.lanes:
        worker_kw["lanes"] = args.lanes
    # checkpoint_path stays OUT of ckw: resume() takes it positionally
    # and forwards it to the constructor itself
    ckw = dict(n_processes=int(args.processes),
               worker_kw=worker_kw,
               checkpoint_every=args.checkpoint_every,
               telemetry=tel, fault_injector=injector,
               queue_limit=args.queue_limit,
               spillover=bool(args.spillover),
               spillover_limit=int(args.spillover_limit),
               slo_config=args.slo_config, device=device)

    def build_engine():
        if args.checkpoint and os.path.exists(args.checkpoint):
            try:
                # cluster_resize: a restart may target fewer (or more)
                # processes than the snapshot's manifest
                return ClusterStreamEngine.resume(
                    args.checkpoint, args.family, args.eps,
                    cluster_resize=True, **ckw)
            except CheckpointCorruptError as e:
                print(f"serve: {e}; starting fresh", file=sys.stderr,
                      flush=True)
                tel.event("checkpoint_corrupt", path=args.checkpoint,
                          detail=str(e)[:200])
                # the per-process sibling snapshots go with the
                # coordinator file: a fresh coordinator re-issues grids
                # from 0, and a stale worker snapshot's gmap would
                # credit its old grids to the new run's requests
                for p in ([args.checkpoint]
                          + glob.glob(f"{args.checkpoint}.p*")):
                    if os.path.exists(p):
                        os.unlink(p)
        return ClusterStreamEngine(
            args.family, args.eps,
            checkpoint_path=args.checkpoint, **ckw)

    # the live engine sits in a box: the supervisor's retry arms swap in
    # a FRESH engine (serve_loop) and the summary/teardown follow it
    eng_box = {"eng": build_engine()}
    printed = {"done": 0, "shed": 0}

    # --metrics-port serves the FEDERATED registry (worker registries
    # under process labels + the coordinator's own) and the /health SLO
    # verdict, through eng_box so a rebuild re-points it
    metrics_srv = None
    if args.metrics_port is not None:
        from ppls_tpu_torch.obs.server import MetricsServer
        metrics_srv = MetricsServer(
            lambda: eng_box["eng"].federated_registry,
            port=args.metrics_port,
            health_fn=lambda: eng_box["eng"].slo_health())
        print(f"serve: metrics on {metrics_srv.url}", file=sys.stderr,
              flush=True)

    def flush_ledger():
        # the print cursor trails the ledger, not step()'s return value:
        # retirements collected before a host-loss abort (or restored by
        # a resume) still get their line; consumers dedupe by rid
        eng = eng_box["eng"]
        while printed["done"] < len(eng.completed):
            c = eng.completed[printed["done"]]
            printed["done"] += 1
            print(json.dumps(_serve_completed_record(c)), flush=True)
        while printed["shed"] < len(eng.shed):
            s = eng.shed[printed["shed"]]
            printed["shed"] += 1
            print(json.dumps(_serve_shed_record(s)), flush=True)

    flush_ledger()          # a resumed ledger re-prints (rid dedupe)
    t0 = time.perf_counter()
    loop_state = {"started": False, "recovered": False}
    # SIGTERM/SIGINT: the handler only sets a flag, the loop winds down
    # at the next phase boundary (final snapshot kept, balanced span
    # close, summary with "terminated", exit 0)
    stop = GracefulShutdown()

    def serve_loop():
        # SELF-RESUMING on retry: a watchdog timeout abandons its
        # attempt thread mid-RPC, so a transient/hang re-entry must not
        # re-drive that engine (its sockets may still be owned by the
        # stale thread). Kill the stale cluster and rebuild from the
        # checkpoint. The host_loss arm recovers the engine IN PLACE
        # (recover_host_loss) and sets `recovered` so it is kept.
        if loop_state["started"] \
                and not loop_state.pop("recovered", False):
            eng_box["eng"].close(graceful=False)
            eng_box["eng"] = build_engine()
            # the rebuilt ledger re-prints from 0 (rid dedupe), as a
            # process-level restart does
            printed["done"] = printed["shed"] = 0
            flush_ledger()
        loop_state["started"] = True
        eng = eng_box["eng"]
        k = int(eng.client_state.setdefault("batch_cursor",
                                            eng.next_rid))
        span = tel.span("run", mode="serve-cluster",
                        processes=eng.n_processes,
                        requests=len(reqs))
        while (k < len(reqs) or not eng.idle) and not stop.requested:
            while k < len(reqs) and arrivals[k] <= eng.phase:
                r = reqs[k]
                kw2 = dict(r[2]) if len(r) > 2 else {}
                if args.deadline_phases is not None:
                    # the single-process default-deadline semantics,
                    # applied at submit (spill eligibility keys on it)
                    kw2.setdefault("deadline_phases",
                                   args.deadline_phases)
                eng.submit(r[0], r[1], **kw2)
                k += 1
                eng.client_state["batch_cursor"] = k
            eng.step()
            flush_ledger()
        if stop.requested:
            # graceful shutdown: the final coordinated snapshot IS the
            # restart state (coordinator + worker siblings), kept
            if args.checkpoint:
                eng.snapshot()
            tel.event("graceful_shutdown",
                      signal=stop.signal_name or "signal",
                      phase=eng.phase, pending=eng.pending,
                      completed=len(eng.completed))
        span.close(phases=eng.phase, completed=len(eng.completed),
                   **({"terminated": stop.signal_name or "signal"}
                      if stop.requested else {}))
        return eng

    supervisor = None
    try:
        stop.__enter__()
        if supervise:
            def resize_fn(exc):
                eng_box["eng"].recover_host_loss(exc)
                loop_state["recovered"] = True
                return serve_loop

            supervisor = Supervisor(
                serve_loop, resize_fn=resize_fn,
                deadline=args.watchdog, telemetry=tel,
                backoff_base=0.25, backoff_cap=30.0)
            supervisor.run()
        else:
            serve_loop()
        wall = time.perf_counter() - t0
        flush_ledger()
        eng = eng_box["eng"]
        res = eng.result(wall_s=wall)
        if args.checkpoint and not stop.requested:
            # a graceful shutdown KEEPS its snapshot (the restart
            # state); only a drained run clears it
            eng.clear_snapshot()
        summary = {
            "summary": True, "engine": args.engine,
            "family": args.family, "eps": args.eps,
            "rule": args.rule, "slots": args.slots,
            "processes": int(args.processes),
            "manifest": eng.manifest.identity(),
            "completed": len(res.completed), "phases": res.phases,
            "wall_s": round(wall, 3),
            "requests_per_sec": round(res.requests_per_sec, 3),
            "latency": res.latency_percentiles(),
            "latency_by_class": res.class_latency_percentiles(),
            "tenants": res.tenant_summary(),
            "shed": len(res.shed),
            "spillover": eng.spillover_summary(),
            "redeal_walls_s": [round(w, 4)
                               for w in eng.redeal_walls],
            "totals": res.totals,
            # each worker process's cumulative K1/K2 launches
            "launches": res.cluster["launches"],
        }
        if res.shed:
            reasons = {}
            for s in res.shed:
                reasons[s.reason] = reasons.get(s.reason, 0) + 1
            summary["shed_reasons"] = reasons
        if stop.requested:
            summary["terminated"] = stop.signal_name or "signal"
        failed = sum(1 for c in res.completed if c.failed)
        if quarantine or failed:
            summary["failed"] = failed
        if supervisor is not None:
            summary["supervised"] = True
            summary["attempts"] = supervisor.attempts
            summary["recoveries"] = [
                {"kind": k, "action": a}
                for k, a in supervisor.recoveries]
        if injector is not None:
            summary["faults_injected"] = [
                ev.describe() for ev in injector.plan.events
                if ev.fired]
        if metrics_srv is not None:
            summary["metrics_port"] = metrics_srv.port
            summary["metrics_url"] = metrics_srv.url
        print(json.dumps(summary), flush=True)
        return 0
    finally:
        stop.__exit__()
        if metrics_srv is not None:
            # PPLS_SERVE_METRICS_HOLD: keep the federated surface up N
            # seconds AFTER the summary line, so an external scraper can
            # take a final post-drain sample race-free
            hold = float(os.environ.get("PPLS_SERVE_METRICS_HOLD",
                                        "0") or 0)
            if hold > 0:
                time.sleep(hold)
            metrics_srv.close()
        eng_box["eng"].close()
        tel.close()


def _resolve(args, mode: str):
    """``--device`` as a torch device; without a card the command exits
    non-zero with ``resolve_device``'s message."""
    from ppls_tpu_torch.utils.device import resolve_device
    try:
        return resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(f"{mode}: {e}") from e


def _main_family(args) -> int:
    import os

    import numpy as np

    from ppls_tpu_torch.config import Rule
    from ppls_tpu_torch.models.integrands import (family_exact, get_family,
                                                  get_family_ds)

    device = _resolve(args, "family")
    T = int(args.theta_block)
    if args.theta is not None:
        tv = args.theta
        if isinstance(tv, float):
            tv = [tv]
        theta = np.asarray(tv, dtype=np.float64)
    else:
        theta = np.linspace(args.theta0, args.theta1, args.m,
                            endpoint=False)
    if T > 1:
        if theta.ndim == 1:
            if theta.size % T == 0 and theta.size > T:
                theta = theta.reshape(-1, T)    # m = size/T slots
            else:
                theta = theta.reshape(1, -1)    # one slot
        if theta.shape[1] < T:
            # short blocks pad by replicating the row head (padded
            # thetas vote and credit identically; dropped from output)
            theta = np.concatenate(
                [theta, np.repeat(theta[:, :1],
                                  T - theta.shape[1], axis=1)], axis=1)
        if args.engine not in ("walker", "sharded-walker-dd",
                               "sharded-walker"):
            raise SystemExit(
                "--theta-block > 1 requires the walker or "
                "sharded-walker-dd engine")
    elif theta.ndim != 1:
        theta = theta.reshape(-1)
    bounds = (args.a, args.b)
    f = get_family(args.family)

    # every branch builds a zero-argument call that RESUMES from the
    # snapshot when one exists and runs fresh otherwise, so a watchdog
    # retry after a mid-run hang picks up the wedged attempt's last leg
    if args.engine == "bag":
        from ppls_tpu_torch.parallel.bag_engine import (integrate_family,
                                                        resume_family)
        kw = dict(chunk=args.chunk, capacity=args.capacity,
                  rule=Rule(args.rule), device=device)

        def engine_call():
            if args.checkpoint and os.path.exists(args.checkpoint):
                return resume_family(args.checkpoint, f, theta, bounds,
                                     args.eps, **kw)
            return integrate_family(f, theta, bounds, args.eps,
                                    checkpoint_path=args.checkpoint, **kw)
    elif args.engine in ("sharded-walker-dd", "sharded-walker"):
        # one flagship path across devices (the reference retired its
        # family-deal variant; both names run the demand-driven walker)
        from ppls_tpu_torch.parallel.sharded_walker import (
            integrate_family_walker_dd, resume_family_walker_dd)
        dkw = dict(chunk=args.chunk, capacity=args.capacity,
                   n_devices=args.n_devices, rule=Rule(args.rule),
                   refill_slots=args.refill_slots,
                   scout_dtype=args.scout_dtype,
                   double_buffer=args.double_buffer,
                   reduced_integrands=args.reduced_integrands,
                   theta_block=T, device=str(device))

        def engine_call():
            if args.checkpoint and os.path.exists(args.checkpoint):
                return resume_family_walker_dd(
                    args.checkpoint, args.family, theta, bounds, args.eps,
                    **dkw)
            return integrate_family_walker_dd(
                args.family, theta, bounds, args.eps,
                checkpoint_path=args.checkpoint, **dkw)
    elif args.engine == "sharded-bag":
        from ppls_tpu_torch.parallel.sharded_bag import (
            integrate_family_sharded, resume_family_sharded)
        skw = dict(rule=Rule(args.rule), chunk=args.chunk,
                   capacity=args.capacity, n_devices=args.n_devices,
                   device=str(device))

        def engine_call():
            if args.checkpoint and os.path.exists(args.checkpoint):
                return resume_family_sharded(args.checkpoint, args.family,
                                             theta, bounds, args.eps, **skw)
            return integrate_family_sharded(
                args.family, theta, bounds, args.eps,
                checkpoint_path=args.checkpoint, **skw)
    else:
        from ppls_tpu_torch.parallel.walker import (
            integrate_family_walker, resume_family_walker)
        fds = get_family_ds(args.family, reduced=args.reduced_integrands)
        wkw = dict(chunk=args.chunk, capacity=args.capacity,
                   rule=Rule(args.rule), refill_slots=args.refill_slots,
                   scout_dtype=args.scout_dtype,
                   double_buffer=args.double_buffer, theta_block=T,
                   device=device)

        def engine_call():
            if args.checkpoint and os.path.exists(args.checkpoint):
                return resume_family_walker(args.checkpoint, f, fds,
                                            theta, bounds, args.eps, **wkw)
            return integrate_family_walker(
                f, fds, theta, bounds, args.eps,
                checkpoint_path=args.checkpoint, **wkw)

    if args.watchdog:
        from ppls_tpu_torch.runtime.guard import run_with_watchdog

        def first_attempt():
            # hang-injection hook (consumed on first use): drives the
            # watchdog and checkpoint-resume recovery end to end without
            # a wedged device
            if os.environ.pop("PPLS_CLI_INJECT_HANG", None):
                import threading
                threading.Event().wait(args.watchdog + 60)
            return engine_call()

        res = run_with_watchdog(first_attempt, args.watchdog,
                                what=f"{args.engine} engine",
                                resume_fn=engine_call)
    else:
        res = engine_call()

    m = res.metrics
    exact = family_exact(args.family, args.a, args.b, theta)
    abs_err = (float(np.max(np.abs(np.asarray(res.areas)
                                   - np.asarray(exact))))
               if exact is not None else None)
    areas_flat = np.asarray(res.areas).reshape(-1)
    if args.as_json:
        print(json.dumps({
            "engine": args.engine,
            "m": int(theta.shape[0] if theta.ndim else args.m),
            "eps": args.eps,
            "theta_block": T,
            "areas_head": [float(v) for v in areas_flat[:4]],
            "abs_error": abs_err,
            "tasks": m.tasks, "splits": m.splits, "rounds": m.rounds,
            "max_depth": m.max_depth, "wall_time_s": m.wall_time_s,
            "tasks_per_sec": m.tasks / m.wall_time_s if m.wall_time_s
            else None,
            "tasks_per_chip": m.tasks_per_chip,
            "walker_fraction": getattr(res, "walker_fraction", None),
        }))
    else:
        print(f"{int(theta.size)} x {args.family} on [{args.a}, {args.b}] "
              f"@ eps={args.eps} ({args.engine}"
              + (f", theta_block={T}" if T > 1 else "") + ")")
        print(f"areas[:4] = "
              f"{[round(float(v), 9) for v in areas_flat[:4]]}")
        if abs_err is not None:
            print(f"max abs error vs exact: {abs_err:.3e}")
        print(m.histogram_str())
        print(f"Tasks: {m.tasks} in {m.rounds} rounds, depth "
              f"{m.max_depth}, {m.wall_time_s:.3f}s "
              f"({m.tasks / max(m.wall_time_s, 1e-12) / 1e6:.1f} M "
              f"tasks/s)")
    return 0


def _main_single(args) -> int:
    """The root command: one integrand through the backend and engine
    the flags name."""
    import os

    from ppls_tpu_torch.config import Backend, QuadConfig, Rule

    cfg = QuadConfig(
        integrand=args.integrand, a=args.a, b=args.b, eps=args.eps,
        rule=Rule(args.rule), capacity=args.capacity,
        max_rounds=args.max_rounds, n_devices=args.n_devices,
        backend=Backend(args.backend))

    if cfg.backend == Backend.MPI:
        from ppls_tpu_torch.backends import run_mpi
        res = run_mpi(cfg, n_workers=args.n_workers)
    elif cfg.backend == Backend.SPILLOVER:
        # float64 bag rounds on the host CPU, by design (the same
        # executor the stream engine sheds overload to)
        from ppls_tpu_torch.backends import run_spillover_single
        res = run_spillover_single(cfg)
    elif args.engine == "sharded":
        from ppls_tpu_torch.parallel.sharded import sharded_integrate
        res = sharded_integrate(cfg, device=_resolve(args, "integrate"))
    elif args.engine == "host":
        from ppls_tpu_torch.runtime.host_frontier import integrate
        device = _resolve(args, "integrate")
        if args.checkpoint:
            from ppls_tpu_torch.runtime.checkpoint import (Checkpointer,
                                                           resume)
            ckpt = Checkpointer(args.checkpoint, config=cfg)
            if os.path.exists(args.checkpoint):
                res = resume(args.checkpoint, cfg, on_round=ckpt.hook,
                             device=device)
            else:
                res = integrate(cfg, on_round=ckpt.hook, device=device)
        else:
            res = integrate(cfg, device=device)
    else:
        from ppls_tpu_torch.parallel.device_engine import device_integrate
        res = device_integrate(cfg, device=_resolve(args, "integrate"))

    m = res.metrics
    if args.as_json:
        print(json.dumps({
            "area": res.area,
            "exact": res.exact,
            "global_error": res.global_error,
            "tasks": m.tasks,
            "splits": m.splits,
            "leaves": m.leaves,
            "rounds": m.rounds,
            "max_depth": m.max_depth,
            "integrand_evals": m.integrand_evals,
            "wall_time_s": m.wall_time_s,
            "evals_per_sec_per_chip": m.evals_per_sec_per_chip,
            "tasks_per_chip": m.tasks_per_chip,
        }))
    else:
        # the reference C program's report, plus what it lacks
        print(f"Area={res.area:.6f}")
        print()
        print(m.histogram_str())
        print()
        if res.global_error is not None:
            print(f"Global error: {res.global_error:.6e} "
                  f"(exact {res.exact:.6f})")
        print(f"Tasks: {m.tasks} ({m.splits} splits, {m.leaves} leaves) "
              f"in {m.rounds} rounds, depth {m.max_depth}")
        print(f"Integrand evals: {m.integrand_evals} "
              f"({m.evals_per_sec_per_chip:.0f}/s/chip over "
              f"{m.wall_time_s:.3f}s)")
    return 0


def _main_2d(args) -> int:
    from ppls_tpu_torch.config import Rule
    from ppls_tpu_torch.models.integrands import get_integrand_2d
    from ppls_tpu_torch.parallel import cubature as C

    entry = get_integrand_2d(args.integrand)
    exact = entry.exact(*args.bounds) if entry.exact else None
    ckpt = args.checkpoint
    if args.n_devices:
        import os

        kw2 = dict(rule=Rule(args.rule), chunk=args.chunk,
                   capacity=args.capacity, exact=exact,
                   n_devices=args.n_devices, device=_resolve(args, "2d"))
        if ckpt and os.path.exists(ckpt):
            res = C.resume_2d_sharded(ckpt, entry.fn, args.bounds,
                                      args.eps, **kw2)
        else:
            res = C.integrate_2d_sharded(entry.fn, args.bounds, args.eps,
                                         checkpoint_path=ckpt, **kw2)
    else:
        if ckpt:
            raise SystemExit(
                "--checkpoint on the 2d mode requires --n-devices (only "
                "the sharded 2D engine snapshots; the single-chip run "
                "is one uninterruptible device program)")
        res = C.integrate_2d(entry.fn, args.bounds, args.eps,
                             rule=Rule(args.rule), chunk=args.chunk,
                             capacity=args.capacity, exact=exact,
                             device=_resolve(args, "2d"))
    m = res.metrics
    if args.as_json:
        print(json.dumps({
            "area": res.area, "exact": res.exact,
            "global_error": res.global_error, "rule": args.rule,
            "eps": args.eps, "tasks": m.tasks, "max_depth": m.max_depth,
            "wall_time_s": m.wall_time_s}))
    else:
        print(f"Area={res.area:.12f}  ({args.rule}, eps={args.eps})")
        if res.global_error is not None:
            print(f"Global error: {res.global_error:.3e} "
                  f"(exact {res.exact:.12f})")
        print(f"Cells: {m.tasks} ({m.splits} splits) in {m.rounds} "
              f"rounds, depth {m.max_depth}, {m.wall_time_s:.3f}s")
    return 0


def _main_qmc(args) -> int:
    from ppls_tpu_torch.models.genz import GENZ, genz_params, get_genz
    from ppls_tpu_torch.parallel.qmc import integrate_qmc

    device = _resolve(args, "qmc")
    names = sorted(GENZ) if args.genz == "all" else [args.genz]
    calls = []
    for name in names:
        fam = get_genz(name)
        a, u = genz_params(name, args.dim, seed=args.seed)
        calls.append((integrate_qmc, (fam.fn, a, u), dict(
            n_points=args.n, n_shifts=args.shifts, fn_name=name,
            n_devices=args.n_devices, exact=fam.exact(a, u),
            device=device)))
    import torch.distributed as dist
    if (args.n_devices is not None and args.n_devices > 1
            and not dist.is_initialized()):
        # one world of ranks runs every family (a call of its own would
        # start the ranks once per family)
        from ppls_tpu_torch.parallel.mesh import launch, run_calls
        results = launch(run_calls, args.n_devices, device, (calls,))
        for r in results:
            if isinstance(r, Exception):
                raise r
    else:
        results = [fn(*fargs, **kw) for fn, fargs, kw in calls]
    rows = []
    for name, r in zip(names, results):
        rel = abs(r.value - r.exact) / max(abs(r.exact), 1e-300)
        rows.append((name, r, rel))
    if args.as_json:
        print(json.dumps({
            "n_points": args.n, "shifts": args.shifts, "dim": args.dim,
            "families": {name: {"value": r.value, "exact": r.exact,
                                "rel_error": rel,
                                "std_error": r.std_error}
                         for name, r, rel in rows}}))
    else:
        print(f"Genz 8D via shifted lattice: N={args.n}, "
              f"{args.shifts} shifts")
        for name, r, rel in rows:
            print(f"  {name:14s} value={r.value:+.8e} "
                  f"rel_err={rel:.2e} stderr={r.std_error:.2e}")
    return 0


def _dispatch(args) -> int:
    if args.mode == "family":
        return _main_family(args)
    if args.mode == "serve":
        return _main_serve(args)
    if args.mode == "2d":
        return _main_2d(args)
    if args.mode == "qmc":
        return _main_qmc(args)
    return _main_single(args)


def main(argv=None) -> int:
    from ppls_tpu_torch.utils.tracing import trace

    args = build_parser().parse_args(argv)
    with trace(args.trace):
        return _dispatch(args)


if __name__ == "__main__":
    sys.exit(main())
