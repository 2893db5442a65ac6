"""Multi-replica snapshot aggregation and snapshot-diff attribution
(copy of ``pyruhvro_tpu/runtime/fleet.py``, whole).

A serving fleet runs N replicas, each exporting for itself. This module
makes N snapshots one:

* :func:`merge_snapshots`: counters sum, histogram buckets merge (and the
  quantiles are recomputed from the merged distribution), gauges sum or
  take the max by their declared kind (:func:`metrics.gauge_kind`:
  watermarks take the max), routing ledgers and SLO objectives
  concatenate with replica tags, the tenant sketches of the ``memory``
  sections fold by (tenant, schema), breakers are namespaced per replica,
  timelines align on one clock and the audits' digests are checked
  across replicas. A section a document lacks (the port's snapshots
  have no ``serving`` section) is simply absent from the fold. The
  merged document is a regular snapshot: ``report`` / ``prom`` /
  ``slo-report`` / ``mem-report`` render it unchanged.
* :func:`fetch_snapshot`: one live ``/snapshot?compress=1`` pull from a
  replica's obs server (gzip on the wire; standard library only).
* :func:`diff_snapshots` / :func:`render_diff`: the attribution of the
  change between two snapshots: per-key counter and gauge deltas, the
  per-phase latency shift (p50/p95/p99), new and dead keys and
  routing-arm mix changes; :func:`parse_window` / :func:`window_snapshot`
  cut a snapshot to a window of its timeline first.
"""

from __future__ import annotations

import gzip
import json
import urllib.request
from typing import Any, Dict, List, Optional, Tuple

from . import metrics

__all__ = ["fetch_snapshot", "merge_snapshots", "diff_snapshots",
           "render_diff", "parse_window", "window_snapshot"]

_FETCH_TIMEOUT_S = 10.0
_MAX_SPANS = 64  # same retention as telemetry's live ring


# ---------------------------------------------------------------------------
# live scrape
# ---------------------------------------------------------------------------


def fetch_snapshot(hostport: str) -> Dict[str, Any]:
    """Pull ``/snapshot?compress=1`` from one replica's obs server.
    ``hostport`` is ``host:port`` or a full ``http://...`` base URL.
    Raises OSError/ValueError on unreachable hosts or non-snapshot
    bodies (the CLI maps both onto its exit-2 contract)."""
    base = hostport if "://" in hostport else f"http://{hostport}"
    url = base.rstrip("/") + "/snapshot?compress=1"
    req = urllib.request.Request(
        url, headers={"Accept-Encoding": "gzip"})
    with urllib.request.urlopen(req, timeout=_FETCH_TIMEOUT_S) as r:
        body = r.read()
    if body[:2] == b"\x1f\x8b":  # gzip magic
        body = gzip.decompress(body)
    doc = json.loads(body.decode("utf-8"))
    if not isinstance(doc, dict) or not (
            {"counters", "histograms", "spans"} & set(doc)):
        raise ValueError(f"{url} did not return a telemetry snapshot")
    return doc


# ---------------------------------------------------------------------------
# merge
# ---------------------------------------------------------------------------


def _merge_counters(snaps: List[Dict[str, Any]]) -> Dict[str, float]:
    out: Dict[str, float] = {}
    for s in snaps:
        for k, v in (s.get("counters") or {}).items():
            out[k] = out.get(k, 0.0) + float(v)
    return out


def _merge_gauges(snaps: List[Dict[str, Any]]) -> Dict[str, float]:
    out: Dict[str, float] = {}
    for s in snaps:
        for k, v in (s.get("gauges") or {}).items():
            v = float(v)
            if k in out and metrics.gauge_kind(k) == "max":
                out[k] = max(out[k], v)
            else:
                out[k] = out.get(k, 0.0) + v if k in out else v
    return out


def _bucket_counts(summary: Dict[str, Any]) -> Dict[Any, int]:
    """De-cumulate one histogram summary into per-bucket counts keyed
    by upper bound (float, or the string ``"+Inf"``)."""
    counts: Dict[Any, int] = {}
    prev = 0
    for le, cum in summary.get("buckets") or []:
        key = "+Inf" if le == "+Inf" else float(le)
        counts[key] = counts.get(key, 0) + int(cum) - prev
        prev = int(cum)
    return counts


def _quantile(sorted_counts: List[Tuple[Any, int]], n: int,
              q: float) -> float:
    """Prometheus-style upper-bound quantile over merged non-cumulative
    bucket counts (ascending; +Inf last)."""
    if not n:
        return 0.0
    target = q * n
    cum = 0
    for le, c in sorted_counts:
        cum += c
        if c and cum >= target:
            return float("inf") if le == "+Inf" else float(le)
    return float("inf")


def _merge_hist(summaries: List[Dict[str, Any]]) -> Dict[str, Any]:
    counts: Dict[Any, int] = {}
    total = 0
    sum_s = 0.0
    exemplar: Optional[Dict[str, Any]] = None
    for h in summaries:
        total += int(h.get("count", 0))
        sum_s += float(h.get("sum", 0.0))
        for le, c in _bucket_counts(h).items():
            counts[le] = counts.get(le, 0) + c
        ex = h.get("exemplar")
        if ex and (exemplar is None
                   or float(ex["value"]) > float(exemplar["value"])):
            exemplar = dict(ex)
    ordered = sorted(counts.items(),
                     key=lambda kv: (kv[0] == "+Inf",
                                     kv[0] if kv[0] != "+Inf" else 0.0))
    buckets: List[list] = []
    cum = 0
    for le, c in ordered:
        cum += c
        if c:
            buckets.append([le, cum])
    if not buckets or buckets[-1][0] != "+Inf":
        buckets.append(["+Inf", cum])
    out: Dict[str, Any] = {
        "count": total,
        "sum": sum_s,
        "p50": _quantile(ordered, total, 0.50),
        "p95": _quantile(ordered, total, 0.95),
        "p99": _quantile(ordered, total, 0.99),
        "buckets": buckets,
    }
    if exemplar is not None:
        out["exemplar"] = exemplar
    return out


def _merge_histograms(snaps: List[Dict[str, Any]]) -> Dict[str, Any]:
    keys: List[str] = []
    for s in snaps:
        for k in (s.get("histograms") or {}):
            if k not in keys:
                keys.append(k)
    return {k: _merge_hist([s["histograms"][k] for s in snaps
                            if k in (s.get("histograms") or {})])
            for k in sorted(keys)}


def _merge_spans(snaps: List[Dict[str, Any]], tags: List[str]):
    spans: List[Dict[str, Any]] = []
    dropped = 0
    for s, tag in zip(snaps, tags):
        dropped += int(s.get("spans_dropped") or 0)
        for sp in s.get("spans") or []:
            sp = dict(sp)
            attrs = dict(sp.get("attrs") or {})
            attrs["replica"] = tag
            sp["attrs"] = attrs
            spans.append(sp)
    spans.sort(key=lambda sp: float(sp.get("ts") or 0.0))
    if len(spans) > _MAX_SPANS:
        dropped += len(spans) - _MAX_SPANS
        spans = spans[-_MAX_SPANS:]
    return spans, dropped


def _merge_routing(snaps: List[Dict[str, Any]],
                   tags: List[str]) -> Dict[str, Any]:
    ledger: List[Dict[str, Any]] = []
    autotune = False
    ledger_dropped = 0
    for s, tag in zip(snaps, tags):
        r = s.get("routing") or {}
        autotune = autotune or bool(r.get("autotune"))
        ledger_dropped += int(r.get("ledger_dropped") or 0)
        for e in r.get("ledger") or []:
            e = dict(e)
            e["replica"] = tag
            ledger.append(e)
    if not ledger and not ledger_dropped:
        return {}
    return {"autotune": autotune, "ledger": ledger,
            "ledger_dropped": ledger_dropped, "fleet": True}


def _merge_slo(snaps: List[Dict[str, Any]],
               tags: List[str]) -> Dict[str, Any]:
    objectives: List[Dict[str, Any]] = []
    breached: List[str] = []
    files: List[str] = []
    errors: List[str] = []
    for s, tag in zip(snaps, tags):
        sec = s.get("slo")
        if not isinstance(sec, dict) or not sec:
            continue
        f = sec.get("file")
        if f and f not in files:
            files.append(f)
        if sec.get("config_error"):
            errors.append(f"[{tag}] {sec['config_error']}")
        for o in sec.get("objectives") or []:
            o = dict(o)
            o["replica"] = tag
            o["name"] = f"[{tag}] {o.get('name')}"
            objectives.append(o)
        for name in sec.get("breached") or []:
            breached.append(f"[{tag}] {name}")
    if not objectives and not errors:
        return {}
    out: Dict[str, Any] = {
        "file": "; ".join(files),
        "objectives": objectives,
        "breached": breached,
    }
    if errors:
        out["config_error"] = "; ".join(errors)
    return out


def _merge_memory(snaps: List[Dict[str, Any]]) -> Dict[str, Any]:
    sections = [s.get("memory") for s in snaps
                if isinstance(s.get("memory"), dict)]
    if not sections:
        return {}
    out: Dict[str, Any] = {
        "rss_bytes": sum(int(m.get("rss_bytes") or 0) for m in sections),
        "peak_rss_bytes": max(int(m.get("peak_rss_bytes") or 0)
                              for m in sections),
        "tracked_bytes": sum(int(m.get("tracked_bytes") or 0)
                             for m in sections),
    }
    caches: Dict[str, Dict[str, Any]] = {}
    for m in sections:
        for name, c in (m.get("caches") or {}).items():
            dst = caches.setdefault(name, {})
            for k, v in c.items():
                if isinstance(v, (int, float)) and not isinstance(v, bool):
                    if "peak" in k or "high_water" in k:
                        dst[k] = max(dst.get(k, 0), v)
                    else:
                        dst[k] = dst.get(k, 0) + v
                else:
                    dst.setdefault(k, v)
    if caches:
        out["caches"] = {k: caches[k] for k in sorted(caches)}
    # heavy-hitter fold: the per-replica space-saving sketches combine
    # by summing per-(tenant, schema) rows — the fleet's top tenants
    tenants: Dict[Tuple[str, str], Dict[str, Any]] = {}
    for m in sections:
        for row in m.get("tenants") or []:
            key = (str(row.get("tenant")), str(row.get("schema")))
            dst = tenants.setdefault(
                key, {"tenant": key[0], "schema": key[1]})
            for k, v in row.items():
                if isinstance(v, (int, float)) and not isinstance(v, bool):
                    dst[k] = dst.get(k, 0) + int(v)
    if tenants:
        out["tenants"] = sorted(tenants.values(),
                                key=lambda r: -r.get("bytes", 0))
    return out


def _merge_audit(snaps: List[Dict[str, Any]],
                 tags: List[str]) -> Dict[str, Any]:
    """Fold per-replica ``audit`` sections and flag cross-replica
    divergence: two replicas reporting different *result* digests for
    the same (schema, op, input-digest, chunks) cannot both be right —
    one of them is corrupting data, and no single-process audit can see
    it. The merged section carries a ``divergent`` list naming the
    disagreeing replicas and their digests."""
    sections = [(s.get("audit"), tag) for s, tag in zip(snaps, tags)
                if isinstance(s.get("audit"), dict) and s.get("audit")]
    if not sections:
        return {}
    out: Dict[str, Any] = {
        "enabled": any(a.get("enabled") for a, _ in sections),
        "calls": sum(int(a.get("calls") or 0) for a, _ in sections),
        "audited": sum(int(a.get("audited") or 0) for a, _ in sections),
        "shadow_errors": sum(int(a.get("shadow_errors") or 0)
                             for a, _ in sections),
        "mismatches": sum(int(a.get("mismatches") or 0)
                          for a, _ in sections),
        "fleet": True,
    }
    per_arm: List[Dict[str, Any]] = []
    rows = audited_rows = 0.0
    recs: List[Dict[str, Any]] = []
    for a, tag in sections:
        for e in a.get("per_arm") or []:
            e = dict(e)
            e["replica"] = tag
            rows += float(e.get("rows") or 0.0)
            audited_rows += float(e.get("audited_rows") or 0.0)
            per_arm.append(e)
        for m in a.get("mismatch_records") or []:
            m = dict(m)
            m["replica"] = tag
            recs.append(m)
    out["coverage"] = round(audited_rows / rows, 6) if rows > 0 else 0.0
    out["per_arm"] = per_arm
    out["mismatch_records"] = recs
    # divergence: key every exported observation by what went in, then
    # look for disagreement about what came out. Each (key, replica)
    # keeps the full SET of observed results — a replica disagreeing
    # with itself (nondeterminism) is divergence too, and a later
    # same-input observation must not mask an earlier corrupt one.
    obs: Dict[Tuple[str, str, str, int], Dict[str, List[str]]] = {}
    for a, tag in sections:
        for schema, ents in (a.get("digests") or {}).items():
            for e in ents or []:
                if not e.get("input") or not e.get("result"):
                    continue
                key = (str(schema), str(e.get("op")),
                       str(e["input"]), int(e.get("chunks") or 1))
                seen = obs.setdefault(key, {}).setdefault(tag, [])
                if str(e["result"]) not in seen:
                    seen.append(str(e["result"]))
    divergent = []
    for (schema, op, inp, chunks), by_tag in sorted(obs.items()):
        if len({d for ds in by_tag.values() for d in ds}) > 1:
            divergent.append({"schema": schema, "op": op,
                              "input": inp, "chunks": chunks,
                              "results": dict(sorted(by_tag.items()))})
    out["divergent"] = divergent
    return out


def _merge_timeline(snaps: List[Dict[str, Any]],
                    tags: List[str]) -> Dict[str, Any]:
    """Fold per-replica ``timeline`` sections onto ONE clock. Replica
    wall clocks skew; every timeline record carries the ts/mono
    pair and the section's export stamps its own ``now_ts``/``now_mono``,
    so each record's true age is ``now_mono - mono`` (drift-free) and
    its fleet-aligned wall time is ``ref_now - age`` against the newest
    replica's clock. Ticks and events get ``replica`` tags and merge
    into one chronologically-sorted stream — 'which replica tripped
    first' becomes a question the rendering answers directly."""
    sections = [(s.get("timeline"), tag) for s, tag in zip(snaps, tags)
                if isinstance(s.get("timeline"), dict)
                and s.get("timeline")]
    if not sections:
        return {}
    ref_now = max(float(sec.get("now_ts") or 0.0) for sec, _ in sections)
    ticks: List[Dict[str, Any]] = []
    events: List[Dict[str, Any]] = []
    dropped = 0
    for sec, tag in sections:
        now_ts = float(sec.get("now_ts") or 0.0)
        now_mono = sec.get("now_mono")
        offset = ref_now - now_ts  # wall-clock skew fallback
        dropped += int(sec.get("events_dropped") or 0)

        def align(rec: Dict[str, Any]) -> Dict[str, Any]:
            rec = dict(rec)
            rec["replica"] = tag
            mono = rec.get("mono")
            if now_mono is not None and mono is not None:
                age = float(now_mono) - float(mono)
                rec["ts"] = round(ref_now - age, 6)
            elif rec.get("ts") is not None:
                rec["ts"] = round(float(rec["ts"]) + offset, 6)
            return rec

        ticks += [align(t) for t in sec.get("ticks") or []]
        events += [align(e) for e in sec.get("events") or []]
    ticks.sort(key=lambda r: float(r.get("ts") or 0.0))
    events.sort(key=lambda r: float(r.get("ts") or 0.0))
    return {
        "interval_s": min(float(sec.get("interval_s") or 10.0)
                          for sec, _ in sections),
        "retention": max(int(sec.get("retention") or 1)
                         for sec, _ in sections),
        "now_ts": ref_now,
        "ticks": ticks,
        "events": events,
        "events_dropped": dropped,
        "fleet": True,
    }


def _merge_breakers(snaps: List[Dict[str, Any]],
                    tags: List[str]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for s, tag in zip(snaps, tags):
        for name, b in (s.get("breakers") or {}).items():
            out[f"{tag}:{name}"] = b
    return out


def merge_snapshots(snaps: List[Dict[str, Any]],
                    tags: Optional[List[str]] = None) -> Dict[str, Any]:
    """N replica snapshots -> ONE fleet snapshot (still schema v3:
    every existing renderer takes it unchanged). Counter exactness is
    the contract CI asserts: every merged counter equals the sum of
    the per-replica values, bit-for-bit (float addition in input
    order, no re-normalization)."""
    if not snaps:
        raise ValueError("merge_snapshots needs at least one snapshot")
    if tags is None:
        tags = [f"r{i}" for i in range(len(snaps))]
    tags = [str(t) for t in tags] + [
        f"r{i}" for i in range(len(tags), len(snaps))]
    spans, dropped = _merge_spans(snaps, tags)
    out: Dict[str, Any] = {
        "schema_version": max(
            [int(s.get("schema_version") or 1) for s in snaps] + [3]),
        "fleet": {
            "replicas": [
                {"tag": tag, "pid": s.get("pid")}
                for s, tag in zip(snaps, tags)
            ],
            "count": len(snaps),
        },
        "counters": _merge_counters(snaps),
        "histograms": _merge_histograms(snaps),
        "spans": spans,
        "spans_dropped": dropped,
        "flight_records": sum(int(s.get("flight_records") or 0)
                              for s in snaps),
    }
    gauges = _merge_gauges(snaps)
    if gauges:
        out["gauges"] = gauges
    routing = _merge_routing(snaps, tags)
    if routing:
        out["routing"] = routing
    slo_sec = _merge_slo(snaps, tags)
    if slo_sec:
        out["slo"] = slo_sec
    mem = _merge_memory(snaps)
    if mem:
        out["memory"] = mem
    brs = _merge_breakers(snaps, tags)
    if brs:
        out["breakers"] = brs
    tl = _merge_timeline(snaps, tags)
    if tl:
        out["timeline"] = tl
    aud = _merge_audit(snaps, tags)
    if aud:
        out["audit"] = aud
        if aud["divergent"]:
            # the cross-replica corruption signal, as a counter so the
            # report/prom renderers and snapshot diffs surface it
            # metric-key: audit.fleet_divergent
            out["counters"]["audit.fleet_divergent"] = (
                out["counters"].get("audit.fleet_divergent", 0.0)
                + float(len(aud["divergent"])))
    return out


# ---------------------------------------------------------------------------
# timeline windows (diff --window)
# ---------------------------------------------------------------------------


def parse_window(spec: str) -> Tuple[Optional[float], Optional[float]]:
    """Parse ``A..B`` into raw window bounds. Each side is a number or
    empty (unbounded); numbers >= 1e9 are absolute epoch seconds, >= 0
    are seconds forward from a snapshot's FIRST tick, < 0 are seconds
    back from its NEWEST tick — resolved per snapshot by
    :func:`window_snapshot`. Raises ValueError on malformed specs (the
    CLI maps it onto the exit-2 contract)."""
    if ".." not in spec:
        raise ValueError(
            f"--window wants A..B (got {spec!r}); bounds are epoch "
            "seconds, seconds from the first tick, or negative seconds "
            "back from the newest tick")
    lo_s, _, hi_s = spec.partition("..")

    def num(s: str) -> Optional[float]:
        s = s.strip()
        if not s:
            return None
        try:
            return float(s)
        except ValueError:
            raise ValueError(f"--window bound {s!r} is not a number")

    return num(lo_s), num(hi_s)


def _resolve_bound(v: Optional[float], first_ts: float,
                   last_ts: float) -> Optional[float]:
    if v is None:
        return None
    if v >= 1e9:  # no timeline predates 2001; smaller means relative
        return v
    if v < 0:
        return last_ts + v
    return first_ts + v


def _slice_summary(sl: Dict[str, Any]) -> Dict[str, Any]:
    """A tick's histogram slice (NON-cumulative buckets) re-shaped as a
    summary :func:`_merge_hist` accepts (cumulative buckets)."""
    buckets: List[list] = []
    cum = 0
    for le, c in sl.get("buckets") or []:
        cum += int(c)
        buckets.append([le, cum])
    return {"count": sl.get("count", 0), "sum": sl.get("sum", 0.0),
            "buckets": buckets}


def window_snapshot(snap: Dict[str, Any],
                    window: Tuple[Optional[float], Optional[float]],
                    ) -> Optional[Dict[str, Any]]:
    """Reconstruct a snapshot covering ONLY the timeline ticks inside
    ``window``: counters are the sum of in-window deltas, gauges the
    last in-window tick's values, histograms the merge of in-window
    delta slices (quantiles recomputed). Returns None when the snapshot
    has no timeline ticks (legacy, or the plane was off) — callers
    degrade to whole-snapshot attribution."""
    sec = snap.get("timeline")
    if not isinstance(sec, dict) or not sec.get("ticks"):
        return None
    ticks = sec["ticks"]
    first_ts = float(ticks[0].get("ts") or 0.0)
    last_ts = float(ticks[-1].get("ts") or 0.0)
    lo = _resolve_bound(window[0], first_ts, last_ts)
    hi = _resolve_bound(window[1], first_ts, last_ts)
    sel = [t for t in ticks
           if (lo is None or float(t.get("ts") or 0.0) >= lo)
           and (hi is None or float(t.get("ts") or 0.0) <= hi)]
    counters: Dict[str, float] = {}
    slices: Dict[str, List[Dict[str, Any]]] = {}
    gauges: Dict[str, float] = {}
    for t in sel:
        for k, v in (t.get("counters") or {}).items():
            counters[k] = counters.get(k, 0.0) + float(v)
        for k, sl in (t.get("histograms") or {}).items():
            slices.setdefault(k, []).append(_slice_summary(sl))
        if t.get("gauges"):
            gauges = {k: float(v) for k, v in t["gauges"].items()}
    evs = [e for e in sec.get("events") or []
           if (lo is None or float(e.get("ts") or 0.0) >= lo)
           and (hi is None or float(e.get("ts") or 0.0) <= hi)]
    out: Dict[str, Any] = {
        "schema_version": snap.get("schema_version"),
        "pid": snap.get("pid"),
        "counters": counters,
        "histograms": {k: _merge_hist(v)
                       for k, v in sorted(slices.items())},
        "spans": [],
        "spans_dropped": 0,
        "windowed": {
            "from": lo, "to": hi, "ticks": len(sel),
            "of_ticks": len(ticks),
        },
        "timeline": {
            "interval_s": sec.get("interval_s"),
            "retention": sec.get("retention"),
            "now_ts": sec.get("now_ts"),
            "ticks": sel,
            "events": evs,
            "events_dropped": sec.get("events_dropped", 0),
        },
    }
    if gauges:
        out["gauges"] = gauges
    return out


# ---------------------------------------------------------------------------
# diff (regression attribution)
# ---------------------------------------------------------------------------


def _num_diff(a: Dict[str, float], b: Dict[str, float]):
    changed: List[list] = []
    new: Dict[str, float] = {}
    dead: Dict[str, float] = {}
    for k in sorted(set(a) | set(b)):
        va, vb = a.get(k), b.get(k)
        if va is None:
            new[k] = float(vb)
        elif vb is None:
            dead[k] = float(va)
        elif float(va) != float(vb):
            changed.append([k, float(va), float(vb),
                            float(vb) - float(va)])
    changed.sort(key=lambda row: -abs(row[3]))
    return {"changed": changed, "new": new, "dead": dead}


def _arm_mix(counters: Dict[str, float]) -> Dict[str, float]:
    """Routing-arm shares from the flat ``route.<arm>`` counters
    (one-level keys only: ``route.reason.*`` names causes, not arms)."""
    arms = {k[len("route."):]: float(v) for k, v in counters.items()
            if k.startswith("route.") and "." not in k[len("route."):]}
    total = sum(arms.values())
    if not total:
        return {}
    return {arm: v / total for arm, v in sorted(arms.items())}


def diff_snapshots(a: Dict[str, Any],
                   b: Dict[str, Any]) -> Dict[str, Any]:
    """The structured regression-attribution document between baseline
    ``a`` and candidate ``b``."""
    ca = {k: float(v) for k, v in (a.get("counters") or {}).items()}
    cb = {k: float(v) for k, v in (b.get("counters") or {}).items()}
    ga = {k: float(v) for k, v in (a.get("gauges") or {}).items()}
    gb = {k: float(v) for k, v in (b.get("gauges") or {}).items()}
    ha = a.get("histograms") or {}
    hb = b.get("histograms") or {}
    hists: Dict[str, Any] = {}
    for k in sorted(set(ha) | set(hb)):
        xa, xb = ha.get(k), hb.get(k)
        if xa is None or xb is None:
            continue  # new/dead keys already surface via counters
        ent: Dict[str, Any] = {
            "count": [int(xa.get("count", 0)), int(xb.get("count", 0))],
        }
        shifted = False
        for q in ("p50", "p95", "p99"):
            qa, qb = float(xa.get(q) or 0.0), float(xb.get(q) or 0.0)
            ent[q] = [qa, qb]
            if qa != qb:
                shifted = True
        if shifted:
            hists[k] = ent
    mix_a, mix_b = _arm_mix(ca), _arm_mix(cb)
    mix: Dict[str, Any] = {}
    for arm in sorted(set(mix_a) | set(mix_b)):
        fa, fb = mix_a.get(arm, 0.0), mix_b.get(arm, 0.0)
        if abs(fa - fb) > 1e-9:
            mix[arm] = [fa, fb]
    return {
        "counters": _num_diff(ca, cb),
        "gauges": _num_diff(ga, gb),
        "histograms": hists,
        "routing_mix": mix,
    }


def _fmt_q(v: float) -> str:
    return "inf" if v == float("inf") else f"{v * 1e3:.3f}"


def render_diff(a: Dict[str, Any], b: Dict[str, Any],
                top: int = 20) -> str:
    """Text report of :func:`diff_snapshots` — what changed, ranked by
    magnitude, phases first (that is where a bench regression lives)."""
    d = diff_snapshots(a, b)
    out: List[str] = ["== snapshot diff (a -> b) =="]
    hists = d["histograms"]
    if hists:
        out += ["", "-- phase latency shift (ms) --"]
        header = (f"{'phase':<36} {'count a->b':>13} {'p50':>15} "
                  f"{'p95':>15} {'p99':>15}")
        out += [header, "-" * len(header)]
        for k, e in hists.items():
            out.append(
                f"{k:<36} {e['count'][0]:>5}->{e['count'][1]:<6} "
                + " ".join(
                    f"{_fmt_q(e[q][0]):>7}>{_fmt_q(e[q][1]):<7}"
                    for q in ("p50", "p95", "p99")))
    cd = d["counters"]
    if cd["changed"]:
        out += ["", f"-- counter deltas (top {top} by |delta|) --"]
        for k, va, vb, delta in cd["changed"][:top]:
            out.append(f"{k:<44} {va:>14.6g} -> {vb:<14.6g} "
                       f"({'+' if delta >= 0 else ''}{delta:.6g})")
        if len(cd["changed"]) > top:
            out.append(f"... {len(cd['changed']) - top} more changed")
    if cd["new"]:
        out += ["", "-- new counters (absent in a) --"]
        out += [f"{k:<44} {v:.6g}" for k, v in sorted(cd["new"].items())]
    if cd["dead"]:
        out += ["", "-- dead counters (absent in b) --"]
        out += [f"{k:<44} {v:.6g}" for k, v in sorted(cd["dead"].items())]
    gd = d["gauges"]
    if gd["changed"] or gd["new"] or gd["dead"]:
        out += ["", "-- gauge deltas --"]
        for k, va, vb, delta in gd["changed"][:top]:
            out.append(f"{k:<44} {va:>14.6g} -> {vb:<14.6g}")
        out += [f"{k:<44} (new) {v:.6g}"
                for k, v in sorted(gd["new"].items())]
        out += [f"{k:<44} (dead) {v:.6g}"
                for k, v in sorted(gd["dead"].items())]
    if d["routing_mix"]:
        out += ["", "-- routing arm mix --"]
        for arm, (fa, fb) in d["routing_mix"].items():
            out.append(f"route.{arm:<20} {fa * 100:>6.1f}% -> "
                       f"{fb * 100:<6.1f}%")
    if len(out) == 1:
        out.append("no differences")
    return "\n".join(out) + "\n"
