"""Prometheus exposition-format line builders — the ONE place bucket/
quantile/counter text is assembled (counterpart of
``paddle_tpu/observability/format.py``).

Every metrics sink in the tree (``serving.metrics``, ``resilience.metrics``,
the registry's own metrics) delegates here; ``tests/test_observability.py``
lints that no other module grows a private ``_bucket{le=`` formatter again.
The emitted shapes are byte-compatible with what the serving and resilience
sinks produced before the unification, so existing scrape
configs and tests keep working.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

from ..core.histogram import DEFAULT_QUANTILES, Histogram

#: metric types valid in exposition format TYPE lines
VALID_TYPES = ("counter", "gauge", "histogram", "summary", "untyped")

#: exposition comment-line prefixes (parsers outside this module key on
#: these names instead of growing their own "# TYPE " literals)
TYPE_PREFIX = "# TYPE "
HELP_PREFIX = "# HELP "


def type_line(family: str, kind: str) -> str:
    """``# TYPE <family> <kind>`` — the one emitter for TYPE lines."""
    return f"{TYPE_PREFIX}{family} {kind}"


def help_line(family: str, text: str) -> str:
    """``# HELP <family> <text>`` — the one emitter for HELP lines."""
    return f"{HELP_PREFIX}{family} {text}"


def escape_label_value(v: object) -> str:
    """Escape a label value per the exposition format spec."""
    return (str(v).replace("\\", r"\\").replace("\n", r"\n")
            .replace('"', r'\"'))


def label_str(labels: Optional[Mapping[str, object]]) -> str:
    """``{k="v",...}`` (keys in insertion order), or '' for no labels."""
    if not labels:
        return ""
    inner = ",".join(f'{k}="{escape_label_value(v)}"'
                     for k, v in labels.items())
    return "{" + inner + "}"


def sample_line(name: str, labels: Optional[Mapping[str, object]],
                value: float) -> str:
    return f"{name}{label_str(labels)} {value:g}"


def counter_lines(metric: str, value: Optional[float] = None,
                  series: Optional[Iterable[Tuple[Mapping[str, object],
                                                  float]]] = None,
                  help: Optional[str] = None) -> List[str]:
    """One counter family: TYPE line + either an unlabeled sample or a
    labeled series (never both — an unlabeled grand-total sibling would
    double-count ``sum()`` queries over the family)."""
    lines = []
    if help is not None:
        lines.append(f"# HELP {metric} {help}")
    lines.append(f"# TYPE {metric} counter")
    if series is not None:
        for labels, v in series:
            lines.append(sample_line(metric, labels, v))
    else:
        lines.append(sample_line(metric, None, value or 0.0))
    return lines


def gauge_lines(metric: str, value: Optional[float] = None,
                series: Optional[Iterable[Tuple[Mapping[str, object],
                                                float]]] = None,
                help: Optional[str] = None) -> List[str]:
    lines = []
    if help is not None:
        lines.append(f"# HELP {metric} {help}")
    lines.append(f"# TYPE {metric} gauge")
    if series is not None:
        for labels, v in series:
            lines.append(sample_line(metric, labels, v))
    else:
        lines.append(sample_line(metric, None, value or 0.0))
    return lines


def histogram_lines(metric: str, h: Histogram,
                    help: Optional[str] = None,
                    quantiles: Optional[Sequence[float]] = None,
                    labels: Optional[Mapping[str, object]] = None,
                    include_type: bool = True) -> List[str]:
    """One histogram family: cumulative ``_bucket`` samples, ``_sum``,
    ``_count``; optionally a *sibling* ``<metric>_quantile`` gauge family
    with exact percentiles (mixing quantile samples into a histogram
    family is invalid exposition format, so it gets its own TYPE).
    ``include_type=False`` for the 2nd+ label-set of one family — a
    family may be TYPE'd only once per document."""
    lines = []
    if help is not None:
        lines.append(f"# HELP {metric} {help}")
    if include_type:
        lines.append(f"# TYPE {metric} histogram")
    base = dict(labels) if labels else {}
    acc = 0
    for bound, n in zip(h.bounds, h.bucket_counts):
        acc += n
        lines.append(sample_line(f"{metric}_bucket",
                                 {**base, "le": f"{bound:g}"}, acc))
    lines.append(sample_line(f"{metric}_bucket", {**base, "le": "+Inf"},
                             h.count))
    lines.append(sample_line(f"{metric}_sum", base or None, h.sum))
    lines.append(sample_line(f"{metric}_count", base or None, h.count))
    if quantiles:
        lines.append(f"# TYPE {metric}_quantile gauge")
        for q in quantiles:
            lines.append(sample_line(
                f"{metric}_quantile", {**base, "quantile": f"{q:g}"},
                h.percentile(q)))
    return lines


def validate_exposition_text(text: str) -> None:
    """Line-by-line exposition-format validator (used by tests and
    available to callers): TYPE lines name a valid type, sample lines
    parse as ``name{labels} value``, histogram buckets are cumulative,
    and no family name is TYPE'd twice."""
    import re

    sample_re = re.compile(
        r'^([a-zA-Z_:][a-zA-Z0-9_:]*)'
        r'(\{[a-zA-Z_][a-zA-Z0-9_]*="(?:[^"\\]|\\.)*"'
        r'(,[a-zA-Z_][a-zA-Z0-9_]*="(?:[^"\\]|\\.)*")*\})?'
        r' (-?[0-9.eE+\-naif]+)$')
    typed: Dict[str, str] = {}
    bucket_acc: Dict[str, float] = {}
    for ln, line in enumerate(text.splitlines(), 1):
        if not line:
            raise ValueError(f"line {ln}: empty line inside exposition text")
        if line.startswith("# HELP "):
            continue
        if line.startswith("# TYPE "):
            parts = line.split(" ")
            if len(parts) != 4 or parts[3] not in VALID_TYPES:
                raise ValueError(f"line {ln}: bad TYPE line {line!r}")
            if parts[2] in typed:
                raise ValueError(
                    f"line {ln}: family {parts[2]} TYPE'd twice")
            typed[parts[2]] = parts[3]
            continue
        if line.startswith("#"):
            continue
        m = sample_re.match(line)
        if not m:
            raise ValueError(f"line {ln}: unparseable sample {line!r}")
        name = m.group(1)
        float(m.group(4))  # value parses
        if name.endswith("_bucket"):
            fam = name[:-len("_bucket")]
            if typed.get(fam) != "histogram":
                raise ValueError(
                    f"line {ln}: bucket sample for non-histogram {fam}")
            v = float(m.group(4))
            if v < bucket_acc.get(fam + m.group(0).split("le=")[0], 0.0):
                raise ValueError(f"line {ln}: non-cumulative bucket {line!r}")
            bucket_acc[fam + m.group(0).split("le=")[0]] = v
