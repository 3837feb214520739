"""Fault-spec grammar: parse ``HVDTPU_FAULTS`` into :class:`FaultRule`\\ s.

One spec is a ``;``-separated list of rules; one rule is a ``:``-separated
list of fields::

    HVDTPU_FAULTS="kv_get:err:p=0.02:seed=7; rank=1:die:after=50; \
negotiate:delay=300ms:p=0.05"

Fields come in two shapes:

- **bare** fields: a fault *kind* (``err`` | ``die`` | ``delay``) or a
  *site* name (anything else; ``fnmatch`` globs allowed, e.g. ``kv_*``;
  omitted = ``*`` = every site).  At most one of each per rule.
- **key=value** params:

  =============  ========================================================
  ``p=F``        fire probability per eligible traversal (default 1.0),
                 drawn from the rule's seeded per-site stream
  ``seed=N``     RNG seed for this rule's streams (default 0); the same
                 seed reproduces the same fire/skip sequence exactly
  ``after=N``    eligible from the Nth matching traversal on (default 1;
                 a trailing unit word like ``steps`` is tolerated)
  ``times=N``    fire at most N times (default: unlimited, except 1 for
                 ``die`` — a process only dies once)
  ``rank=N``     only on cross-rank N (``HVDTPU_CROSS_RANK``); rules
                 without it apply on every process, launcher included
  ``delay=DUR``  sleep duration — implies kind ``delay``; ``300ms`` /
                 ``0.3s`` / bare seconds
  ``once=PATH``  fire only if PATH does not exist yet, creating it
                 atomically on fire — a cross-relaunch "only once per
                 job" latch (an elastic relaunch re-arms the same env
                 spec; without the latch an injected death would
                 re-kill every incarnation)
  =============  ========================================================

Sites are plain strings named at the choke points (see
:data:`KNOWN_SITES`); unknown sites parse fine — wiring a new site needs
no grammar change — but a spec naming only never-fired sites is usually
a typo, so the injector logs the armed rule set once at arm time.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Optional, Tuple

KINDS = ("err", "die", "delay")

#: the sites wired into the runtime (documentation + docs table source;
#: the grammar itself accepts any site string).
KNOWN_SITES = {
    "kv_put": "runner.api.kv_put_blob — one traversal per chunk write",
    "kv_get": "runner.api.kv_get_blob — one traversal per chunk wait",
    "negotiate": "engine negotiation barrier entry (every cycle in "
                 "multi-process mode)",
    "dispatch": "ops.engine collective dispatch (one per fused group)",
    "spawn": "runner.launch worker spawn (one per rank launched)",
    "heartbeat": "runner.launch monitor liveness pass",
    "serving_admit": "serving.engine.submit admission",
    "serving_step": "serving.engine.step (one per serving round)",
    "router": "serving.frontdoor.router placement (one traversal per "
              "placement decision)",
    "mig_export": "serving.disagg.transport.publish_migration — one "
                  "traversal per published blob (K, V, manifest), so "
                  "after=N lands mid-migration",
    "mig_import": "serving.disagg.transport.fetch_migration — one "
                  "traversal per fetched blob",
}

_DUR_RE = re.compile(r"^([0-9]*\.?[0-9]+)(ms|s|m)?$")


def parse_duration_s(raw: str) -> float:
    m = _DUR_RE.match(raw.strip())
    if not m:
        raise ValueError(f"bad duration {raw!r} (want e.g. 300ms, 0.3s)")
    v = float(m.group(1))
    unit = m.group(2) or "s"
    return v * {"ms": 1e-3, "s": 1.0, "m": 60.0}[unit]


@dataclasses.dataclass(frozen=True)
class FaultRule:
    """One parsed rule; ``index`` is its position in the spec (part of
    the RNG stream key, so two otherwise-identical rules draw from
    independent streams)."""

    site: str
    kind: str
    index: int = 0
    p: float = 1.0
    seed: int = 0
    after: int = 1
    times: Optional[int] = None
    rank: Optional[int] = None
    delay_s: float = 0.0
    once_path: Optional[str] = None

    def describe(self) -> str:
        parts = [self.site, self.kind]
        if self.p < 1.0:
            parts.append(f"p={self.p}")
        if self.after > 1:
            parts.append(f"after={self.after}")
        if self.times is not None:
            parts.append(f"times={self.times}")
        if self.rank is not None:
            parts.append(f"rank={self.rank}")
        if self.kind == "delay":
            parts.append(f"delay={self.delay_s * 1000:.0f}ms")
        parts.append(f"seed={self.seed}")
        return ":".join(parts)


def _parse_rule(raw: str, index: int) -> FaultRule:
    site: Optional[str] = None
    kind: Optional[str] = None
    kw: dict = {}
    for tok in (t.strip() for t in raw.split(":")):
        if not tok:
            continue
        if "=" in tok:
            key, _, val = tok.partition("=")
            key, val = key.strip(), val.strip()
            if key == "p":
                kw["p"] = float(val)
            elif key == "seed":
                kw["seed"] = int(val)
            elif key == "after":
                # tolerate a unit word: after=50steps
                kw["after"] = int(re.sub(r"[a-z]+$", "", val))
            elif key == "times":
                kw["times"] = int(val)
            elif key == "rank":
                kw["rank"] = int(val)
            elif key == "delay":
                kw["delay_s"] = parse_duration_s(val)
                if kind is None:
                    kind = "delay"
                elif kind != "delay":
                    raise ValueError(
                        f"rule {raw!r}: delay= conflicts with kind {kind}")
            elif key == "once":
                kw["once_path"] = val
            else:
                raise ValueError(f"rule {raw!r}: unknown param {key!r}")
        elif tok in KINDS:
            if kind is not None and not (tok == "delay"
                                         and kind == "delay"):
                raise ValueError(f"rule {raw!r}: two kinds ({kind}, {tok})")
            kind = tok
        else:
            if site is not None:
                raise ValueError(
                    f"rule {raw!r}: two sites ({site!r}, {tok!r}) — "
                    "param values need key= prefixes")
            site = tok
    if kind is None:
        raise ValueError(f"rule {raw!r}: no fault kind (err/die/delay)")
    if kind == "delay" and kw.get("delay_s", 0.0) <= 0.0:
        raise ValueError(f"rule {raw!r}: delay kind needs delay=<duration>")
    p = kw.get("p", 1.0)
    if not 0.0 < p <= 1.0:
        raise ValueError(f"rule {raw!r}: p must be in (0, 1], got {p}")
    if kw.get("after", 1) < 1:
        raise ValueError(f"rule {raw!r}: after must be >= 1")
    if kw.get("times") is not None and kw["times"] < 1:
        raise ValueError(f"rule {raw!r}: times must be >= 1")
    if kind == "die" and "times" not in kw:
        kw["times"] = 1
    return FaultRule(site=site or "*", kind=kind, index=index, **kw)


def parse_spec(spec: str) -> Tuple[FaultRule, ...]:
    """Parse a full ``HVDTPU_FAULTS`` value; raises ``ValueError`` with
    the offending rule text on any grammar error."""
    rules = []
    for raw in spec.split(";"):
        raw = raw.strip()
        if not raw:
            continue
        rules.append(_parse_rule(raw, index=len(rules)))
    return tuple(rules)
