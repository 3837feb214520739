"""Exposition: serialize a registry snapshot as Prometheus text or JSON.

A copy of the JAX package's ``obs/export.py`` for the port: the same
snapshot gives the same bytes in both packages.

The snapshot (see :meth:`MetricRegistry.snapshot`) is plain data, so both
formats are straight serializations.  The Prometheus writer follows the
text exposition format 0.0.4 (``# HELP`` / ``# TYPE`` headers, cumulative
``_bucket{le=...}`` + ``_sum`` + ``_count`` per histogram child,
label-value escaping); :func:`validate_prometheus` re-parses that format
and is shared by the CI smoke job and the unit tests so "valid
exposition" means one thing everywhere.
"""

from __future__ import annotations

import json
import math
import re


def _fmt_value(v: float) -> str:
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if math.isnan(v):
        return "NaN"
    f = float(v)
    if f.is_integer() and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _escape_label(v: str) -> str:
    return v.replace("\\", r"\\").replace("\n", r"\n").replace('"', r'\"')


def _escape_help(v: str) -> str:
    return v.replace("\\", r"\\").replace("\n", r"\n")


def _label_str(labels: dict, extra: str = "") -> str:
    parts = [f'{k}="{_escape_label(str(v))}"'
             for k, v in sorted(labels.items())]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


def to_prometheus(snapshot: list) -> str:
    """Prometheus text exposition format 0.0.4."""
    lines: list[str] = []
    for fam in snapshot:
        name = fam["name"]
        if fam.get("help"):
            lines.append(f"# HELP {name} {_escape_help(fam['help'])}")
        lines.append(f"# TYPE {name} {fam['type']}")
        for s in fam["samples"]:
            labels = s.get("labels", {})
            if fam["type"] == "histogram":
                for le, cum in s["buckets"]:
                    le_pair = 'le="%s"' % _fmt_value(le)
                    lines.append(
                        f"{name}_bucket{_label_str(labels, le_pair)} {cum}")
                lines.append(
                    f"{name}_sum{_label_str(labels)} "
                    f"{_fmt_value(s['sum'])}")
                lines.append(
                    f"{name}_count{_label_str(labels)} {s['count']}")
            else:
                lines.append(
                    f"{name}{_label_str(labels)} {_fmt_value(s['value'])}")
    return "\n".join(lines) + "\n"


def to_json(snapshot: list) -> str:
    """JSON exposition (the ``/metrics.json`` endpoint and
    ``hvd.metrics("json")``); +/-Inf bucket edges encode as strings so the
    output is strict JSON."""

    def _enc(o):
        if isinstance(o, float) and (math.isinf(o) or math.isnan(o)):
            return _fmt_value(o)
        if isinstance(o, dict):
            return {k: _enc(v) for k, v in o.items()}
        if isinstance(o, (list, tuple)):
            return [_enc(v) for v in o]
        return o

    return json.dumps({"metrics": _enc(snapshot)}, indent=None,
                      separators=(",", ":"), sort_keys=True)


# -- validation (shared by tests and the CI obs-smoke job) -----------------

_SAMPLE_RE = re.compile(
    r"^[a-zA-Z_:][a-zA-Z0-9_:]*"
    r'(\{[a-zA-Z_][a-zA-Z0-9_]*="(?:[^"\\]|\\.)*"'
    r'(,[a-zA-Z_][a-zA-Z0-9_]*="(?:[^"\\]|\\.)*")*\})?'
    r" [-+]?(?:[0-9]*\.?[0-9]+(?:[eE][-+]?[0-9]+)?|Inf|NaN)$")
_TYPE_RE = re.compile(
    r"^# TYPE ([a-zA-Z_:][a-zA-Z0-9_:]*) "
    r"(counter|gauge|histogram|summary|untyped)$")
_LE_RE = re.compile(r'le="([^"]*)"')


def validate_prometheus(text: str) -> None:
    """Raise ``ValueError`` unless ``text`` is well-formed exposition:
    every sample line parses, every sample's family has a ``# TYPE``
    header, and histogram buckets are cumulative (monotone, ending at
    ``+Inf``)."""
    typed: dict[str, str] = {}
    hist_buckets: dict[str, list] = {}
    for lineno, line in enumerate(text.splitlines(), 1):
        if not line:
            continue
        if line.startswith("# HELP "):
            continue
        if line.startswith("#"):
            m = _TYPE_RE.match(line)
            if not m:
                raise ValueError(f"line {lineno}: bad comment {line!r}")
            typed[m.group(1)] = m.group(2)
            continue
        if not _SAMPLE_RE.match(line):
            raise ValueError(f"line {lineno}: bad sample {line!r}")
        name = re.split(r"[{ ]", line, 1)[0]
        base = re.sub(r"_(bucket|sum|count)$", "", name)
        if name not in typed and base not in typed:
            raise ValueError(
                f"line {lineno}: sample {name!r} has no # TYPE header")
        if typed.get(base) == "histogram" and name.endswith("_bucket"):
            le = _LE_RE.search(line)
            if not le:
                raise ValueError(f"line {lineno}: bucket without le=")
            series = line.rsplit(" ", 1)[0]
            series_key = re.sub(r'le="[^"]*",?', "", series)
            val = float(line.rsplit(" ", 1)[1])
            hist_buckets.setdefault(series_key, []).append(
                (math.inf if le.group(1) == "+Inf" else float(le.group(1)),
                 val))
    for key, pairs in hist_buckets.items():
        if pairs != sorted(pairs, key=lambda p: p[0]):
            raise ValueError(f"{key}: bucket edges out of order")
        counts = [c for _, c in pairs]
        if counts != sorted(counts):
            raise ValueError(f"{key}: bucket counts not cumulative")
        if not math.isinf(pairs[-1][0]):
            raise ValueError(f"{key}: missing +Inf bucket")
