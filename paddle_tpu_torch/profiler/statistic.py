"""Summary tables over collected host spans — counterpart of
``paddle_tpu/profiler/statistic.py``: spans aggregated by name into
count/total/avg/max/min tables, sortable."""

from __future__ import annotations

from enum import Enum
from typing import Dict, List, Optional, Sequence

from .record import HostSpan


class SortedKeys(Enum):
    CPUTotal = 0
    CPUAvg = 1
    CPUMax = 2
    CPUMin = 3


_UNIT = {"s": 1e-9, "ms": 1e-6, "us": 1e-3, "ns": 1.0}


class _Agg:
    __slots__ = ("count", "total", "max", "min")

    def __init__(self):
        self.count = 0
        self.total = 0
        self.max = 0
        self.min = None

    def add(self, dur: int) -> None:
        self.count += 1
        self.total += dur
        self.max = max(self.max, dur)
        self.min = dur if self.min is None else min(self.min, dur)


def aggregate(spans: Sequence[HostSpan]) -> Dict[str, _Agg]:
    table: Dict[str, _Agg] = {}
    for sp in spans:
        table.setdefault(sp.name, _Agg()).add(sp.end_ns - sp.start_ns)
    return table


def summary(spans: Sequence[HostSpan], sorted_by: Optional[SortedKeys] = None,
            time_unit: str = "ms") -> str:
    """Render the event summary table as a string."""
    scale = _UNIT.get(time_unit, 1e-6)
    table = aggregate(spans)
    key = sorted_by or SortedKeys.CPUTotal
    sort_fn = {
        SortedKeys.CPUTotal: lambda kv: kv[1].total,
        SortedKeys.CPUAvg: lambda kv: kv[1].total / max(kv[1].count, 1),
        SortedKeys.CPUMax: lambda kv: kv[1].max,
        SortedKeys.CPUMin: lambda kv: kv[1].min or 0,
    }[key]
    rows = sorted(table.items(), key=sort_fn, reverse=True)
    name_w = max([len(n) for n, _ in rows] + [10])
    hdr = (f"{'Name':<{name_w}}  {'Calls':>7}  {'Total(' + time_unit + ')':>12}  "
           f"{'Avg(' + time_unit + ')':>12}  {'Max(' + time_unit + ')':>12}  "
           f"{'Min(' + time_unit + ')':>12}")
    lines = [hdr, "-" * len(hdr)]
    for name, agg in rows:
        lines.append(
            f"{name:<{name_w}}  {agg.count:>7}  {agg.total*scale:>12.4f}  "
            f"{agg.total*scale/max(agg.count,1):>12.4f}  "
            f"{agg.max*scale:>12.4f}  {(agg.min or 0)*scale:>12.4f}")
    return "\n".join(lines)
