"""Federated cluster metrics: the port's copy of the JAX package's
``obs/federation.py`` (host-only Python).

The multi-process service (``runtime/cluster.py``) has one registry per
worker process behind its socket. This module merges them into ONE
surface, the one ``serve --processes N --metrics-port`` serves:

* workers ship **cumulative** registry dumps
  (:meth:`MetricsRegistry.dump`) in their step/state/snapshot replies,
  so a retransmit, a skipped phase or a reply dropped by a host loss can
  never double- or under-count;
* the coordinator folds each dump into ONE federated
  :class:`MetricsRegistry` through :class:`FederatedMetrics`, every
  family re-registered with its own label names plus a ``process``
  label (the worker process ids, and ``"coordinator"`` for the
  coordinator's own registry);
* counters merge by NON-NEGATIVE delta against the previous dump (a
  worker that restarted fresh after a corrupt snapshot re-reports from
  zero, and its new cumulative value becomes the baseline instead of a
  negative delta); gauges are last-write-wins; histograms merge
  per-bucket deltas (:meth:`Histogram.merge_counts`), so the federated
  quantiles run over the cluster-wide samples.

Reconciliation invariant: for every counter family, the federated child
for ``process=i`` equals worker *i*'s own registry value exactly, and
the cluster totals the coordinator reports (completed/shed/spillover in
the summary) equal the sum over worker processes of the matching
federated counters plus the coordinator's spillover completions.
:meth:`FederatedMetrics.reconcile` checks the first half.

Everything here is host dict arithmetic on values the phase boundary
already shipped; no device work.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from ppls_tpu_torch.obs.registry import (PHASE_BUCKETS, SECONDS_BUCKETS,
                                         MetricsRegistry)

PROCESS_LABEL = "process"
COORDINATOR = "coordinator"


class FederatedMetrics:
    """Merge worker registry dumps into one process-labeled registry.

    One instance per cluster coordinator; ``ingest_dump`` is called at
    phase boundaries with whatever cumulative dumps the step replies
    carried. The federated registry is what ``--metrics-port`` serves on
    the cluster path.
    """

    def __init__(self, registry: Optional[MetricsRegistry] = None):
        self.registry = registry if registry is not None \
            else MetricsRegistry()
        # process -> the last cumulative dump ingested (the delta base)
        self._prev: Dict[str, dict] = {}

    def processes(self) -> List[str]:
        return sorted(self._prev)

    def ingest_dump(self, process: str, dump: dict) -> None:
        """Fold one process's cumulative registry dump into the
        federated registry (delta against the previous dump from the
        same process; the module docstring gives the merge rules)."""
        process = str(process)
        prev = self._prev.get(process, {})
        reg = self.registry
        for name, fam in sorted(dump.items()):
            kind = fam["kind"]
            labelnames = tuple(fam.get("labelnames", ())) \
                + (PROCESS_LABEL,)
            help_ = fam.get("help", "")
            if kind == "counter":
                target = reg.counter(name, help_, labelnames)
            elif kind == "gauge":
                target = reg.gauge(name, help_, labelnames)
            elif kind == "histogram":
                target = None        # built per child (bucket edges)
            else:
                continue
            prev_children = {
                tuple(c["labels"]): c
                for c in prev.get(name, {}).get("children", ())}
            for child in fam.get("children", ()):
                key = tuple(child["labels"])
                labels = dict(zip(fam.get("labelnames", ()), key))
                labels[PROCESS_LABEL] = process
                pc = prev_children.get(key)
                if kind == "counter":
                    delta = float(child["value"]) - (
                        float(pc["value"]) if pc else 0.0)
                    if delta < 0:
                        # fresh-restart clamp: the process re-reports
                        # from zero, so its new cumulative value is the
                        # whole delta
                        delta = float(child["value"])
                    if delta:
                        target.labels(**labels).inc(delta)
                elif kind == "gauge":
                    target.labels(**labels).set(float(child["value"]))
                else:
                    counts = [int(c) for c in child["counts"]]
                    csum = float(child["sum"])
                    ccount = int(child["count"])
                    if pc is not None:
                        pcounts = [int(c) for c in pc["counts"]]
                        if int(pc["count"]) <= ccount:
                            counts = [a - b for a, b
                                      in zip(counts, pcounts)]
                            csum -= float(pc["sum"])
                            ccount -= int(pc["count"])
                        # else: a fresh restart, the full value is the
                        # delta
                    if ccount == 0 and not any(counts):
                        continue
                    # the dumped bucket table includes the implicit +Inf
                    # overflow bucket; registration takes the finite
                    # edges only
                    h = reg.histogram(
                        name, help_, labelnames=labelnames,
                        buckets=self._edges_for(dump, name))
                    h.labels(**labels).merge_counts(
                        counts, csum, ccount,
                        float(child.get("max", 0.0)))
        self._prev[process] = dump

    @staticmethod
    def _edges_for(dump: dict, name: str):
        """The finite bucket edges of a dumped histogram. Dumps carry no
        edges, so they are keyed off the bucket count: the two shared
        tables (PHASE_BUCKETS / SECONDS_BUCKETS) differ in length."""
        children = dump[name].get("children", ())
        n = len(children[0]["counts"]) if children else 0
        for table in (PHASE_BUCKETS, SECONDS_BUCKETS):
            if n == len(table) + 1:      # + the implicit +Inf bucket
                return table
        raise ValueError(
            f"federated histogram {name!r} uses an unknown bucket "
            f"table ({n} buckets); ship histograms on the shared "
            f"PHASE/SECONDS tables")

    def reconcile(self) -> List[str]:
        """The mechanical half of the reconciliation invariant: every
        federated counter child must equal the matching process's own
        cumulative dump value exactly. Returns problem strings (empty =
        reconciled). Gauges and histogram counts check the same way."""
        problems: List[str] = []
        for process, dump in sorted(self._prev.items()):
            for name, fam in sorted(dump.items()):
                target = self.registry.get(name)
                if target is None:
                    problems.append(f"{name}: never federated")
                    continue
                for child in fam.get("children", ()):
                    key = tuple(str(v) for v in child["labels"]) \
                        + (process,)
                    want = (int(child["count"])
                            if fam["kind"] == "histogram"
                            else float(child["value"]))
                    # a direct child lookup: labels() would CREATE a
                    # missing child and hide the hole this check looks
                    # for. A zero-valued counter never creates one (the
                    # merge skips zero deltas), so no child is the right
                    # federation of zero.
                    fed = target._children.get(key)
                    if fed is None:
                        if want:
                            problems.append(
                                f"{name}{{process={process},"
                                f"{child['labels']}}}: no federated "
                                f"child for reported {want}")
                        continue
                    got = (fed.count if fam["kind"] == "histogram"
                           else fed.value)
                    if got != want:
                        problems.append(
                            f"{name}{{process={process},"
                            f"{child['labels']}}}: federated {got} "
                            f"!= reported {want}")
        return problems

    def sum_over_workers(self, name: str, **labels) -> float:
        """Sum a federated counter over the non-coordinator process
        children: the left-hand side of the cluster-total invariant."""
        fam = self.registry.get(name)
        if fam is None:
            return 0.0
        total = 0.0
        want = {str(k): str(v) for k, v in labels.items()}
        for key, child in fam.items():
            kv = dict(zip(fam.labelnames, key))
            if kv.get(PROCESS_LABEL) == COORDINATOR:
                continue
            if all(kv.get(k) == v for k, v in want.items()):
                total += child.value
        return total
