"""Dependency-free metrics registry for the serving stack.

Prometheus-style semantics in pure Python — the serving container has no
metrics client library, and the numbers the roadmap items need (TTFT /
inter-token latency distributions, pool pressure, cost-model calibration)
are all derivable from three primitive kinds:

  * ``Counter``   — monotone cumulative count (tokens emitted, preemptions,
    simulated nanoseconds).  ``inc`` adds; ``set`` exists only to mirror an
    external monotone counter (the pool keeps its own cumulative totals and
    the engine reflects them).
  * ``Gauge``     — last-observed value of a fluctuating quantity (free
    pages, queue depth), with a running min/max/mean summary so a snapshot
    taken at exit still shows the excursion, not just the final value.
  * ``Histogram`` — fixed upper-bound buckets plus an overflow bucket,
    cumulative ``sum``/``count``, and Prometheus-style ``percentile``
    estimation (linear interpolation inside the bucket containing the
    rank).  Buckets are fixed at creation: observation is O(log buckets)
    and snapshots are O(buckets), never O(observations).

``MetricsRegistry`` is the get-or-create namespace holding them, with
``snapshot()`` (plain nested dict, JSON-ready) and ``reset()`` (zero every
metric in place — handles stay valid).

``EngineStats`` replaces the engine's untyped ``stats`` dict: the same
``engine.stats["tokens_out"] += 1`` call sites keep working (it is a
``MutableMapping`` over registry counters under the ``engine.`` prefix),
while typed read-only properties and the registry snapshot give tests and
benchmarks a structured view.

``Calibration`` closes the loop on the cost models: the scheduler prices
every iteration (``sim_latency_ns``) but nothing ever checked those
predictions against measured wall time.  It accumulates (predicted,
measured) pairs, fits a single scale factor by least squares through the
origin, and reports the residual distribution — the per-(model, cost-model)
correction factor ``benchmarks/serve_throughput.py`` publishes in
``BENCH_serving.json``'s ``telemetry`` section.
"""

from __future__ import annotations

import bisect
import math
from collections.abc import MutableMapping
from typing import Iterable, Optional

# Default bucket families.  Latency buckets span 50us..5s in roughly
# 1-2.5-5 decades (engine steps on this container sit in the 1-100 ms
# band); token buckets are powers of two up to the max_len scale; ratio
# buckets bracket 1.0 tightly (a calibrated cost model's residuals should
# concentrate there).
LATENCY_MS_BUCKETS = (0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0,
                      50.0, 100.0, 250.0, 500.0, 1000.0, 2500.0, 5000.0)
TOKEN_BUCKETS = (0.0, 1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0, 256.0,
                 512.0, 1024.0, 2048.0, 4096.0)
RATIO_BUCKETS = (0.01, 0.05, 0.1, 0.25, 0.5, 0.75, 0.9, 1.0, 1.1, 1.25,
                 1.5, 2.0, 4.0, 10.0, 100.0)


class Counter:
    """Monotone cumulative counter.  ``value`` starts at integer 0 so token
    counts stay ints; adding a float (simulated ns) promotes it."""

    __slots__ = ("name", "help", "value")
    kind = "counter"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self.value = 0

    def inc(self, n=1) -> None:
        self.value += n

    def set(self, v) -> None:
        """Mirror an external monotone counter (e.g. the pool's cumulative
        ``prefix_hit_tokens``).  Not a gauge — use only for values that
        never decrease."""
        self.value = v

    def reset(self) -> None:
        self.value = 0

    def snapshot(self):
        return self.value


class Gauge:
    """Last-observed value with a running min/max/mean summary."""

    __slots__ = ("name", "help", "value", "n", "total", "vmin", "vmax")
    kind = "gauge"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self.reset()

    def set(self, v) -> None:
        self.value = v
        self.n += 1
        self.total += v
        if self.vmin is None or v < self.vmin:
            self.vmin = v
        if self.vmax is None or v > self.vmax:
            self.vmax = v

    def reset(self) -> None:
        self.value = None
        self.n = 0
        self.total = 0.0
        self.vmin = None
        self.vmax = None

    def snapshot(self) -> dict:
        return {"last": self.value, "min": self.vmin, "max": self.vmax,
                "mean": (self.total / self.n) if self.n else None,
                "n": self.n}


class Histogram:
    """Fixed-bucket histogram with cumulative sum/count and percentile
    estimation.

    ``buckets`` are inclusive upper bounds (``le`` semantics); an implicit
    overflow bucket catches everything above the last bound.  Percentiles
    interpolate linearly inside the bucket containing the rank (the
    Prometheus ``histogram_quantile`` convention), with the first bucket
    anchored at 0 and the overflow bucket clamped to its lower bound — an
    estimate, but one whose error is bounded by the bucket width, which is
    exactly the fixed-memory trade this representation buys.
    """

    __slots__ = ("name", "help", "uppers", "counts", "sum", "count")
    kind = "histogram"

    def __init__(self, name: str, buckets: Iterable[float] = LATENCY_MS_BUCKETS,
                 help: str = ""):
        self.name = name
        self.help = help
        self.uppers = tuple(sorted(float(b) for b in buckets))
        if not self.uppers:
            raise ValueError("histogram needs at least one bucket bound")
        self.counts = [0] * (len(self.uppers) + 1)
        self.sum = 0.0
        self.count = 0

    def observe(self, v) -> None:
        self.counts[bisect.bisect_left(self.uppers, v)] += 1
        self.sum += v
        self.count += 1

    def percentile(self, q: float) -> float:
        """Estimate the ``q``-th percentile (0-100) from the buckets."""
        if self.count == 0:
            return float("nan")
        rank = (q / 100.0) * self.count
        cum = 0
        for i, c in enumerate(self.counts):
            if c == 0:
                continue
            if cum + c >= rank:
                lo = self.uppers[i - 1] if i > 0 else 0.0
                if i == len(self.uppers):   # overflow: no upper bound
                    return self.uppers[-1]
                hi = self.uppers[i]
                frac = (rank - cum) / c
                return lo + (hi - lo) * min(max(frac, 0.0), 1.0)
            cum += c
        return self.uppers[-1]

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else float("nan")

    def reset(self) -> None:
        self.counts = [0] * (len(self.uppers) + 1)
        self.sum = 0.0
        self.count = 0

    def snapshot(self) -> dict:
        buckets = {f"{u:g}": c for u, c in zip(self.uppers, self.counts)}
        buckets["+Inf"] = self.counts[-1]
        return {"count": self.count, "sum": self.sum,
                "mean": self.mean if self.count else None,
                "p50": self.percentile(50) if self.count else None,
                "p90": self.percentile(90) if self.count else None,
                "p99": self.percentile(99) if self.count else None,
                "buckets": buckets}


class MetricsRegistry:
    """Get-or-create namespace of metrics with snapshot/reset."""

    def __init__(self):
        self._metrics: dict[str, object] = {}

    def _get_or_create(self, cls, name: str, *args, **kw):
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = cls(name, *args, **kw)
        elif not isinstance(m, cls):
            raise TypeError(
                f"metric {name!r} already registered as {m.kind}, "
                f"requested {cls.kind}")
        return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get_or_create(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get_or_create(Gauge, name, help)

    def histogram(self, name: str,
                  buckets: Iterable[float] = LATENCY_MS_BUCKETS,
                  help: str = "") -> Histogram:
        return self._get_or_create(Histogram, name, buckets, help)

    def get(self, name: str):
        return self._metrics.get(name)

    def __iter__(self):
        return iter(sorted(self._metrics.values(), key=lambda m: m.name))

    def __len__(self) -> int:
        return len(self._metrics)

    def snapshot(self) -> dict:
        """Plain nested dict (JSON-ready): one section per metric kind."""
        out = {"counters": {}, "gauges": {}, "histograms": {}}
        for m in self:
            out[m.kind + "s"][m.name] = m.snapshot()
        return out

    def reset(self) -> None:
        """Zero every metric in place; existing handles stay valid."""
        for m in self._metrics.values():
            m.reset()

    def merge(self, other: "MetricsRegistry", prefix: str = ""
              ) -> "MetricsRegistry":
        """Copy every metric from ``other`` into this registry under
        ``prefix`` — counters by value, gauges with their full
        min/max/mean running summary, histograms bucket-by-bucket (bucket
        bounds come from the source; a pre-existing target with different
        bounds is replaced).  Values are copied, not moved, and repeated
        merges overwrite — so fanning a replica registry in every sync is
        idempotent and the source stays authoritative."""
        for m in other:
            name = prefix + m.name
            if m.kind == "counter":
                self.counter(name, m.help).set(m.value)
            elif m.kind == "gauge":
                g = self.gauge(name, m.help)
                g.value, g.n, g.total = m.value, m.n, m.total
                g.vmin, g.vmax = m.vmin, m.vmax
            else:
                h = self._metrics.get(name)
                if not isinstance(h, Histogram) or h.uppers != m.uppers:
                    h = self._metrics[name] = Histogram(name, m.uppers,
                                                        m.help)
                h.counts = list(m.counts)
                h.sum, h.count = m.sum, m.count
        return self


# ---------------------------------------------------------------------------
# typed engine stats (dict-compatible view over registry counters)
# ---------------------------------------------------------------------------

ENGINE_COUNTER_KEYS = (
    "mixed_steps", "decode_tokens", "prefill_tokens", "tokens_out",
    "preemptions", "prefix_hit_tokens", "cow_forks",
    "sim_latency_ns", "sim_energy_nj",
    # fault-tolerance lifecycle counters (PR 7): explicit cancels, deadline
    # expiries, admission-control sheds, degraded (pressure-capped) prefill
    # chunks, recovered dispatch failures, snapshot/restore events.
    "aborts", "timeouts", "sheds", "degraded_chunks",
    "dispatch_failures", "snapshots", "restores",
    # terminal transitions of any flavor (EOS/LENGTH + the abort family) —
    # what the replica router sums for its aggregate view
    "finished",
    # kernel-dispatch observability (PR 9): per-step kernel-vs-dense
    # decisions for the paged-attention span (``kernels.ops.paged_dispatch``
    # re-derived by the engine), dense fallbacks split by reject reason as
    # ``dense_fallback_<reason>`` counters, and trie-aware admission
    # deferrals (a WAITING request parked one plan so a prefix leader
    # commits the shared pages it will then admit against).
    "kernel_dispatches", "dense_fallbacks",
    "dense_fallback_disabled", "dense_fallback_softcap",
    "dense_fallback_gqa_replicated", "dense_fallback_vmem",
    "prefix_deferrals")


class EngineStats(MutableMapping):
    """The engine's stats, backed by registry counters.

    Drop-in for the old untyped dict — ``stats["tokens_out"] += 1``,
    ``stats["prefix_hit_tokens"] = pool.prefix_hit_tokens`` and plain reads
    all keep working — while every value is simultaneously a registry
    counter (``engine.<key>``) visible in snapshots, plus typed read-only
    properties for the common keys.
    """

    __slots__ = ("_counters", "_registry")

    def __init__(self, registry: MetricsRegistry):
        self._registry = registry
        self._counters = {k: registry.counter("engine." + k)
                          for k in ENGINE_COUNTER_KEYS}

    def __getitem__(self, key: str):
        return self._counters[key].value

    def __setitem__(self, key: str, value) -> None:
        c = self._counters.get(key)
        if c is None:   # stay dict-compatible: unknown keys get a counter
            c = self._counters[key] = self._registry.counter("engine." + key)
        c.set(value)

    def __delitem__(self, key: str) -> None:
        del self._counters[key]

    def __iter__(self):
        return iter(self._counters)

    def __len__(self) -> int:
        return len(self._counters)

    def as_dict(self) -> dict:
        return {k: c.value for k, c in self._counters.items()}

    # typed accessors for the hot keys (reads only; writes go through
    # __setitem__ so the dict-compat call sites stay the single mutator)
    @property
    def mixed_steps(self) -> int:
        return self._counters["mixed_steps"].value

    @property
    def decode_tokens(self) -> int:
        return self._counters["decode_tokens"].value

    @property
    def prefill_tokens(self) -> int:
        return self._counters["prefill_tokens"].value

    @property
    def tokens_out(self) -> int:
        return self._counters["tokens_out"].value

    @property
    def preemptions(self) -> int:
        return self._counters["preemptions"].value

    @property
    def sim_latency_ns(self) -> float:
        return self._counters["sim_latency_ns"].value

    @property
    def sim_energy_nj(self) -> float:
        return self._counters["sim_energy_nj"].value

    @property
    def aborts(self) -> int:
        return self._counters["aborts"].value

    @property
    def timeouts(self) -> int:
        return self._counters["timeouts"].value

    @property
    def sheds(self) -> int:
        return self._counters["sheds"].value

    @property
    def dispatch_failures(self) -> int:
        return self._counters["dispatch_failures"].value


# ---------------------------------------------------------------------------
# cost-model calibration
# ---------------------------------------------------------------------------

class Calibration:
    """Predicted-vs-measured latency pairs for one (model, cost model) pair.

    The cost models predict *accelerator* time (an HBM roofline, the
    paper's CIM simulator) while the container measures CPU wall clock, so
    nobody expects the absolute numbers to agree — what must hold for the
    scheduler's decisions to be trustworthy is *proportionality*: one
    fitted scale factor should map predictions onto measurements with a
    tight residual distribution.  ``scale`` is the least-squares fit
    through the origin (``sum(p*m) / sum(p*p)``); ``residuals`` are the
    per-step ratios ``measured / (scale * predicted)`` — 1.0 everywhere
    means the model ranks steps exactly right.

    Pairs are one-per-engine-step, so keeping them raw is bounded and
    buys exact residual percentiles; the optional registry histogram
    additionally exposes the raw measured/predicted ratio distribution in
    snapshots.
    """

    def __init__(self, name: str = "step",
                 registry: Optional[MetricsRegistry] = None):
        self.name = name
        self.predicted: list[float] = []
        self.measured: list[float] = []
        self._hist = (registry.histogram(f"calibration.{name}.ratio",
                                         RATIO_BUCKETS)
                      if registry is not None else None)

    def record(self, predicted_ns: float, measured_ns: float) -> None:
        if predicted_ns <= 0 or measured_ns <= 0:
            return   # nothing was priced (or measured): not a data point
        self.predicted.append(float(predicted_ns))
        self.measured.append(float(measured_ns))
        if self._hist is not None:
            self._hist.observe(measured_ns / predicted_ns)

    @property
    def n(self) -> int:
        return len(self.predicted)

    @property
    def scale(self) -> float:
        """Least-squares fit through the origin of measured = scale *
        predicted."""
        if not self.predicted:
            return float("nan")
        num = sum(p * m for p, m in zip(self.predicted, self.measured))
        den = sum(p * p for p in self.predicted)
        return num / den if den > 0 else float("nan")

    def residuals(self) -> list[float]:
        """measured / (scale * predicted) per pair; 1.0 == perfect fit."""
        s = self.scale
        if not self.predicted or not math.isfinite(s) or s == 0:
            return []
        return [m / (s * p) for p, m in zip(self.predicted, self.measured)]

    def report(self) -> dict:
        """JSON-ready summary: fitted scale + residual distribution."""
        res = sorted(self.residuals())

        def pct(q):
            if not res:
                return float("nan")
            i = min(int(q / 100.0 * len(res)), len(res) - 1)
            return res[i]

        return {
            "n": self.n,
            "scale": self.scale,
            "predicted_total_us": sum(self.predicted) / 1e3,
            "measured_total_us": sum(self.measured) / 1e3,
            "residual_p50": pct(50),
            "residual_p90": pct(90),
            "residual_max": res[-1] if res else float("nan"),
        }


def render_report(registry: MetricsRegistry,
                  calibrations: Iterable[Calibration] = ()) -> str:
    """Human-readable multi-line telemetry report (the ``--metrics`` exit
    report in ``examples/serve_decode.py``)."""
    lines = ["telemetry:"]
    snap = registry.snapshot()
    if snap["counters"]:
        lines.append("  counters:")
        for name, v in snap["counters"].items():
            lines.append(f"    {name:<32} {v:g}" if isinstance(v, float)
                         else f"    {name:<32} {v}")
    if snap["gauges"]:
        lines.append("  gauges (last / min / max):")
        for name, g in snap["gauges"].items():
            if g["n"] == 0:
                continue
            lines.append(f"    {name:<32} {g['last']:g} / {g['min']:g} / "
                         f"{g['max']:g}")
    if snap["histograms"]:
        lines.append("  histograms (count / p50 / p90 / p99):")
        for name, h in snap["histograms"].items():
            if h["count"] == 0:
                continue
            lines.append(f"    {name:<32} {h['count']:>6d} / "
                         f"{h['p50']:.3g} / {h['p90']:.3g} / {h['p99']:.3g}")
    for cal in calibrations:
        r = cal.report()
        if r["n"] == 0:
            continue
        lines.append(
            f"  calibration[{cal.name}]: n={r['n']} scale={r['scale']:.3g} "
            f"(predicted {r['predicted_total_us']:.0f} us -> measured "
            f"{r['measured_total_us']:.0f} us), residual p50="
            f"{r['residual_p50']:.2f} p90={r['residual_p90']:.2f}")
    return "\n".join(lines)


__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry", "EngineStats",
           "Calibration", "render_report", "LATENCY_MS_BUCKETS",
           "TOKEN_BUCKETS", "RATIO_BUCKETS", "ENGINE_COUNTER_KEYS"]
