"""Zero-dependency metrics registry: counters, gauges, histograms
(counterpart of ``paddle_tpu/observability/metrics.py``, the same code).

The registry is the in-process half of the telemetry layer: instrumented
code records into named metrics with optional labels; the exporters of
``paddle_tpu_torch.observability`` turn a registry snapshot into a
Prometheus-style textfile. Everything here is plain CPython — no torch,
no third-party packages — so the coordination-critical layers (the
store, the chaos harness) can import it without pulling in a backend.

Thread safety: every metric guards its label map with its own lock; the
registry guards metric creation with another. Recording is a dict update
under a lock — cheap enough for per-step hot paths (the env-gated module
helpers in ``observability/__init__.py`` skip even that when telemetry is
off).

Histograms keep a BOUNDED reservoir (``deque(maxlen=...)``) of recent
observations next to running count/sum/min/max, so a week-long soak cannot
grow memory without bound while percentiles and per-rank "series" stay
available for the fleet merge.
"""
from __future__ import annotations

import collections
import math
import re
import threading
from typing import Dict, Iterable, Optional, Tuple

NAME_RE = re.compile(r"^[a-z][a-z0-9_]*$")

#: default bounded-reservoir size for histograms
DEFAULT_RESERVOIR = 256


def _labelkey(labels: Dict[str, object]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def labelkey_str(key: Tuple[Tuple[str, str], ...]) -> str:
    return ",".join(f"{k}={v}" for k, v in key)


class _Metric:
    kind = "abstract"

    def __init__(self, name: str, help: str = ""):
        if not NAME_RE.match(name):
            raise ValueError(
                f"metric name {name!r} violates the naming convention "
                f"({NAME_RE.pattern}): lowercase snake_case only")
        self.name = name
        self.help = help
        self._lock = threading.Lock()

    def snapshot(self) -> dict:
        raise NotImplementedError


class Counter(_Metric):
    """Monotonically increasing count (per label set)."""

    kind = "counter"

    def __init__(self, name: str, help: str = ""):
        super().__init__(name, help)
        self._values: Dict[tuple, float] = {}

    def inc(self, value: float = 1, **labels) -> None:
        if value < 0:
            raise ValueError(f"counter {self.name}: negative increment {value}")
        k = _labelkey(labels)
        with self._lock:
            self._values[k] = self._values.get(k, 0) + value

    def value(self, **labels) -> float:
        with self._lock:
            return self._values.get(_labelkey(labels), 0)

    def snapshot(self) -> dict:
        with self._lock:
            values = {labelkey_str(k): v for k, v in self._values.items()}
        return {"type": self.kind, "help": self.help, "values": values}


class Gauge(_Metric):
    """Last-write-wins instantaneous value (per label set)."""

    kind = "gauge"

    def __init__(self, name: str, help: str = ""):
        super().__init__(name, help)
        self._values: Dict[tuple, float] = {}

    def set(self, value: float, **labels) -> None:
        with self._lock:
            self._values[_labelkey(labels)] = float(value)

    def inc(self, value: float = 1, **labels) -> None:
        k = _labelkey(labels)
        with self._lock:
            self._values[k] = self._values.get(k, 0) + value

    def value(self, **labels) -> Optional[float]:
        with self._lock:
            return self._values.get(_labelkey(labels))

    def snapshot(self) -> dict:
        with self._lock:
            values = {labelkey_str(k): v for k, v in self._values.items()}
        return {"type": self.kind, "help": self.help, "values": values}


class _Series:
    __slots__ = ("count", "sum", "min", "max", "reservoir")

    def __init__(self, reservoir: int):
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf
        self.reservoir = collections.deque(maxlen=reservoir)


class Histogram(_Metric):
    """count/sum/min/max plus a bounded reservoir of recent observations.

    The reservoir (not Prometheus buckets) is the export format: it keeps the
    raw recent series available for percentiles AND for the fleet merge,
    where per-rank step-time distributions are compared directly.
    """

    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 reservoir: int = DEFAULT_RESERVOIR):
        super().__init__(name, help)
        self._reservoir_n = max(1, int(reservoir))
        self._series: Dict[tuple, _Series] = {}

    def observe(self, value: float, **labels) -> None:
        v = float(value)
        k = _labelkey(labels)
        with self._lock:
            s = self._series.get(k)
            if s is None:
                s = self._series[k] = _Series(self._reservoir_n)
            s.count += 1
            s.sum += v
            s.min = min(s.min, v)
            s.max = max(s.max, v)
            s.reservoir.append(v)

    def count(self, **labels) -> int:
        with self._lock:
            s = self._series.get(_labelkey(labels))
            return s.count if s else 0

    @staticmethod
    def _quantile(sorted_vals, q: float) -> float:
        if not sorted_vals:
            return 0.0
        idx = min(len(sorted_vals) - 1, int(q * len(sorted_vals)))
        return sorted_vals[idx]

    def snapshot(self) -> dict:
        out = {}
        with self._lock:
            items = [(k, s.count, s.sum, s.min, s.max, list(s.reservoir))
                     for k, s in self._series.items()]
        for k, count, total, lo, hi, values in items:
            sv = sorted(values)
            out[labelkey_str(k)] = {
                "count": count,
                "sum": total,
                "min": lo if count else 0.0,
                "max": hi if count else 0.0,
                "mean": (total / count) if count else 0.0,
                "p50": self._quantile(sv, 0.50),
                "p90": self._quantile(sv, 0.90),
                "p99": self._quantile(sv, 0.99),
                "values": values,
            }
        return {"type": self.kind, "help": self.help, "series": out}


def _prom_labels(label_str: str, extra: Optional[str] = None) -> str:
    parts = []
    if label_str:
        for kv in label_str.split(","):
            k, _, v = kv.partition("=")
            v = v.replace("\\", "\\\\").replace('"', '\\"')
            parts.append(f'{k}="{v}"')
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


class MetricsRegistry:
    """Named metric store; get-or-create with kind checking.

    ``catalog`` (optional dict name -> (kind, help)) pins the declared kind
    and default help text for known names — creating a registered name with
    the wrong kind raises instead of silently exporting nonsense.
    """

    def __init__(self, catalog: Optional[dict] = None):
        self._metrics: Dict[str, _Metric] = {}
        self._lock = threading.RLock()
        self._catalog = catalog or {}

    def _get_or_create(self, cls, name: str, help: str, **kwargs) -> _Metric:
        entry = self._catalog.get(name)
        if entry is not None:
            if entry[0] != cls.kind:
                raise ValueError(
                    f"metric {name!r} is registered as a {entry[0]} in the "
                    f"catalog but was requested as a {cls.kind}")
            help = help or entry[1]
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name, help, **kwargs)
            elif not isinstance(m, cls):
                raise ValueError(
                    f"metric {name!r} already exists as a {m.kind}, "
                    f"requested as a {cls.kind}")
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get_or_create(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get_or_create(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  reservoir: int = DEFAULT_RESERVOIR) -> Histogram:
        return self._get_or_create(Histogram, name, help, reservoir=reservoir)

    def get(self, name: str) -> Optional[_Metric]:
        with self._lock:
            return self._metrics.get(name)

    def names(self) -> Iterable[str]:
        with self._lock:
            return sorted(self._metrics)

    def reset(self) -> None:
        with self._lock:
            self._metrics.clear()

    def snapshot(self) -> dict:
        with self._lock:
            metrics = list(self._metrics.values())
        return {m.name: m.snapshot() for m in metrics}

    def to_prometheus(self, prefix: str = "paddle_tpu_") -> str:
        """Prometheus text exposition (histograms as summary-style lines)."""
        lines = []
        snap = self.snapshot()
        for name in sorted(snap):
            data = snap[name]
            pname = prefix + name
            kind = data["type"]
            if data.get("help"):
                lines.append(f"# HELP {pname} {data['help']}")
            lines.append(f"# TYPE {pname} "
                         f"{'summary' if kind == 'histogram' else kind}")
            if kind in ("counter", "gauge"):
                for label_str, v in sorted(data["values"].items()):
                    lines.append(f"{pname}{_prom_labels(label_str)} {v:g}")
            else:
                for label_str, s in sorted(data["series"].items()):
                    lines.append(
                        f"{pname}_count{_prom_labels(label_str)} {s['count']}")
                    lines.append(
                        f"{pname}_sum{_prom_labels(label_str)} {s['sum']:g}")
                    for q in ("p50", "p90", "p99"):
                        quantile = f'quantile="0.{q[1:]}"'
                        lines.append(
                            f"{pname}{_prom_labels(label_str, quantile)} "
                            f"{s[q]:g}")
                    lines.append(
                        f"{pname}_min{_prom_labels(label_str)} {s['min']:g}")
                    lines.append(
                        f"{pname}_max{_prom_labels(label_str)} {s['max']:g}")
        return "\n".join(lines) + ("\n" if lines else "")
