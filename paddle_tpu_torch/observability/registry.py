"""Process-global metrics registry — ONE scrape surface for the tree —
counterpart of ``paddle_tpu/observability/registry.py``.

Reference shape: prometheus_client's CollectorRegistry, trimmed to what the
runtime needs. Two ways in:

* **owned metrics** — :meth:`MetricsRegistry.counter` / :meth:`gauge` /
  :meth:`histogram` create (or return the already-registered) named metric,
  optionally labeled. Name uniqueness is enforced: re-asking for the same
  name with the same type/labels returns the SAME object (so call sites
  don't need import-order coordination); a conflicting re-registration
  raises.
* **sinks** — subsystems that keep their own storage (``ServingMetrics``,
  ``ResilienceMetrics``) register a namespace + exposition/snapshot
  callbacks. Re-registering a namespace REPLACES the previous sink (a
  fresh ``ServingMetrics()`` per server/test is the normal lifecycle; the
  registry always scrapes the newest).

``prometheus_text()`` is a single valid exposition document (owned
families then sinks); ``snapshot()`` is the JSON-able equivalent.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from ..core.histogram import (DEFAULT_BOUNDS_MS, DEFAULT_QUANTILES,
                              Histogram)
from . import format as fmt


class _Labeled:
    """Shared labeled-series storage: label-value tuple -> slot."""

    def __init__(self, name: str, help: str, label_names: Sequence[str]):
        self.name = name
        self.help = help
        self.label_names = tuple(label_names)
        self._series: Dict[Tuple, object] = {}
        self._lock = threading.Lock()

    def _key(self, labels: Dict[str, object]) -> Tuple:
        if tuple(sorted(labels)) != tuple(sorted(self.label_names)):
            raise ValueError(
                f"{self.name}: expected labels {self.label_names}, "
                f"got {tuple(sorted(labels))}")
        return tuple(labels[k] for k in self.label_names)

    def _iter_series(self):
        with self._lock:
            items = list(self._series.items())
        for key, slot in items:
            yield dict(zip(self.label_names, key)), slot


class Counter(_Labeled):
    """Monotonic counter, optionally labeled."""

    def inc(self, by: float = 1.0, **labels) -> None:
        key = self._key(labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + by

    def value(self, **labels) -> float:
        with self._lock:
            return self._series.get(self._key(labels), 0.0)

    @property
    def total(self) -> float:
        with self._lock:
            return sum(self._series.values())

    def lines(self) -> List[str]:
        if self.label_names:
            series = sorted(self._iter_series(),
                            key=lambda kv: tuple(kv[0].items()))
            return fmt.counter_lines(self.name, series=series,
                                     help=self.help or None)
        return fmt.counter_lines(self.name, value=self.value(),
                                 help=self.help or None)

    def snapshot(self):
        if not self.label_names:
            return self.value()
        return {",".join(f"{k}={v}" for k, v in labels.items()): v2
                for labels, v2 in self._iter_series()}


class Gauge(_Labeled):
    """Last-value gauge, optionally labeled."""

    def set(self, value: float, **labels) -> None:
        key = self._key(labels)
        with self._lock:
            self._series[key] = float(value)

    def inc(self, by: float = 1.0, **labels) -> None:
        key = self._key(labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + by

    def value(self, **labels) -> float:
        with self._lock:
            return self._series.get(self._key(labels), 0.0)

    def lines(self) -> List[str]:
        if self.label_names:
            series = sorted(self._iter_series(),
                            key=lambda kv: tuple(kv[0].items()))
            return fmt.gauge_lines(self.name, series=series,
                                   help=self.help or None)
        return fmt.gauge_lines(self.name, value=self.value(),
                               help=self.help or None)

    def snapshot(self):
        if not self.label_names:
            return self.value()
        return {",".join(f"{k}={v}" for k, v in labels.items()): v2
                for labels, v2 in self._iter_series()}


class HistogramMetric(_Labeled):
    """Registry-owned histogram (one ``core.histogram.Histogram`` per
    label combination)."""

    def __init__(self, name, help, label_names=(),
                 bounds: Sequence[float] = DEFAULT_BOUNDS_MS,
                 quantiles: Optional[Sequence[float]] = DEFAULT_QUANTILES):
        super().__init__(name, help, label_names)
        self.bounds = tuple(bounds)
        self.quantiles = tuple(quantiles) if quantiles else None

    def observe(self, value: float, **labels) -> None:
        key = self._key(labels)
        with self._lock:   # record under the lock: lines() formats (and
            h = self._series.get(key)      # sorts percentiles) concurrently
            if h is None:
                h = self._series[key] = Histogram(bounds=self.bounds)
            h.record(value)

    def hist(self, **labels) -> Histogram:
        key = self._key(labels)
        with self._lock:
            h = self._series.get(key)
            if h is None:
                h = self._series[key] = Histogram(bounds=self.bounds)
            return h

    def lines(self) -> List[str]:
        out: List[str] = []
        with self._lock:   # freeze records while formatting (percentile
            if not self.label_names:       # sorts would race otherwise)
                h = self._series.get(())
                if h is None:
                    h = self._series[()] = Histogram(bounds=self.bounds)
                out.extend(fmt.histogram_lines(
                    self.name, h, help=self.help or None,
                    quantiles=self.quantiles))
                return out
            series = sorted(self._series.items())
            if not series:   # no label-set yet: still emit an empty family
                out.extend(fmt.histogram_lines(
                    self.name, Histogram(bounds=self.bounds),
                    help=self.help or None, quantiles=self.quantiles))
                return out
            for i, (key, h) in enumerate(series):
                # one HELP/TYPE per FAMILY, then every label-set's samples
                # (quantile siblings omitted for labeled histograms: they
                # would need their own once-per-family TYPE handling)
                out.extend(fmt.histogram_lines(
                    self.name, h,
                    help=(self.help or None) if i == 0 else None,
                    quantiles=None,
                    labels=dict(zip(self.label_names, key)),
                    include_type=i == 0))
            return out

    def snapshot(self):
        with self._lock:
            if not self.label_names:
                h = self._series.get(())
                h = h if h is not None else Histogram(bounds=self.bounds)
                return h.summary(self.quantiles or ())
            return {",".join(f"{k}={v}" for k, v in
                             zip(self.label_names, key)):
                    h.summary(self.quantiles or ())
                    for key, h in sorted(self._series.items())}


_TYPES = {"counter": Counter, "gauge": Gauge, "histogram": HistogramMetric}


class MetricsRegistry:
    """See module docstring. Thread-safe; one process-global instance via
    :func:`get_registry`, independent instances constructible for tests."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, object] = {}          # name -> metric
        self._kinds: Dict[str, str] = {}               # name -> type
        self._sinks: Dict[str, Tuple[Callable, Optional[Callable]]] = {}

    # -- owned metrics ------------------------------------------------------

    def _get_or_make(self, kind: str, name: str, help: str,
                     labels: Sequence[str], **kw):
        if isinstance(labels, str):
            # labels="op" silently iterates into ('o', 'p'); catch the
            # footgun before it registers an unusable family
            raise TypeError(
                f"metric {name!r}: labels must be a SEQUENCE of label "
                f"names, got the bare string {labels!r} — use "
                f"labels=({labels!r},)")
        labels = tuple(labels)
        with self._lock:
            existing = self._metrics.get(name)
            if existing is not None:
                if self._kinds[name] != kind:
                    raise ValueError(
                        f"metric {name!r} already registered as a "
                        f"{self._kinds[name]}; cannot re-register as a "
                        f"{kind}")
                if existing.label_names != labels:
                    # returning the existing family here would make later
                    # inc(**labels) calls key inconsistently between the
                    # two call sites — fail loudly at registration instead
                    raise ValueError(
                        f"metric {name!r} already registered with label "
                        f"names {existing.label_names}; cannot "
                        f"re-register with label names {labels} — every "
                        f"call site of one family must declare the same "
                        f"labels (order included)")
                if kind == "histogram":
                    bounds = tuple(kw.get("bounds", existing.bounds))
                    if bounds != existing.bounds:
                        raise ValueError(
                            f"histogram {name!r} already registered with "
                            f"bounds {existing.bounds}; cannot "
                            f"re-register with bounds {bounds}")
                    q = kw.get("quantiles", existing.quantiles)
                    q = tuple(q) if q else None
                    if q != existing.quantiles:
                        raise ValueError(
                            f"histogram {name!r} already registered with "
                            f"quantiles {existing.quantiles}; cannot "
                            f"re-register with quantiles {q}")
                return existing
            metric = _TYPES[kind](name, help, labels, **kw)
            self._metrics[name] = metric
            self._kinds[name] = kind
            return metric

    def counter(self, name: str, help: str = "",
                labels: Sequence[str] = ()) -> Counter:
        return self._get_or_make("counter", name, help, labels)

    def gauge(self, name: str, help: str = "",
              labels: Sequence[str] = ()) -> Gauge:
        return self._get_or_make("gauge", name, help, labels)

    def histogram(self, name: str, help: str = "",
                  labels: Sequence[str] = (),
                  bounds: Sequence[float] = DEFAULT_BOUNDS_MS,
                  quantiles: Optional[Sequence[float]] = DEFAULT_QUANTILES
                  ) -> HistogramMetric:
        return self._get_or_make("histogram", name, help, labels,
                                 bounds=bounds, quantiles=quantiles)

    def get(self, name: str):
        with self._lock:
            return self._metrics.get(name)

    # -- sinks --------------------------------------------------------------

    def register_sink(self, namespace: str,
                      text_fn: Callable[[], List[str]],
                      snapshot_fn: Optional[Callable[[], dict]] = None,
                      replace: bool = True) -> None:
        """Register a subsystem sink. ``text_fn`` returns exposition LINES
        (no trailing newline) built via :mod:`.format`; ``snapshot_fn``
        returns a JSON-able dict. A namespace re-registration replaces the
        previous sink unless ``replace=False`` (then it raises)."""
        with self._lock:
            if namespace in self._sinks and not replace:
                raise ValueError(f"sink {namespace!r} already registered")
            self._sinks[namespace] = (text_fn, snapshot_fn)

    def unregister_sink(self, namespace: str) -> None:
        with self._lock:
            self._sinks.pop(namespace, None)

    # -- export -------------------------------------------------------------

    def prometheus_text(self) -> str:
        """One valid exposition document covering owned metrics + sinks."""
        with self._lock:
            metrics = list(self._metrics.values())
            sinks = list(self._sinks.items())
        lines: List[str] = []
        for m in metrics:
            lines.extend(m.lines())
        for _, (text_fn, _snap) in sinks:
            try:
                lines.extend(text_fn())
            except Exception:       # a torn sink must not kill the scrape
                continue
        return "\n".join(lines) + "\n" if lines else ""

    def snapshot(self) -> dict:
        with self._lock:
            metrics = list(self._metrics.items())
            sinks = list(self._sinks.items())
        out: dict = {}
        for name, m in metrics:
            out[name] = m.snapshot()
        for ns, (_text, snap) in sinks:
            if snap is None:
                continue
            try:
                out[ns] = snap()
            except Exception:
                continue
        return out

    def reset(self) -> None:
        """Drop every owned metric and sink (tests)."""
        with self._lock:
            self._metrics.clear()
            self._kinds.clear()
            self._sinks.clear()


#: the process-global registry every subsystem re-registers into
_global = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    return _global
