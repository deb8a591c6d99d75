"""PS hot-shard steerer: per-shard skew -> a ``migrate_range`` plan.

The port of ``paddle_tpu/observability/ps_steering.py``. The parameter
server labels every sparse apply with ``ps.apply_ms{shard=,table=}`` and
a coarse ``ps.row_heat{shard=,table=,bucket=}`` census; this module turns
a sustained per-shard skew in them into a proposed row-range move: the
hottest bucket-aligned slice of the hottest table on the hottest shard,
re-homed to the coldest shard. Nothing is applied here.

- ``apply_skew_value(...)`` and ``row_load_skew_value(...)`` are
  ``WatchRule`` extractors over the merged ``metrics.json``: the max/min
  ratio of per-shard mean apply time (the production signal, noisy on
  small workloads) and of per-shard row touches (deterministic for a
  seeded workload, the drills' signal). Both read the last window of the
  merged ``series_windows`` when the document has them, else the
  lifetime counters;
- the ``ps_migrate_range`` steerer (``propose_migrate_range``) derives
  the hot shard, table and split from the same document and returns
  ``{"kind": "migrate_range", "table", "lo", "hi", "from_shard",
  "to_shard", "height", ...}``; applying it is
  ``ShardedPSClient.migrate_range``, through the canary like every plan.

The server buckets row heat over its own slice (it never knows the
global partition), so the candidate splits are the donor span's bucket
edges; the steerer picks the edge that best isolates the hot side and
moves that side.
"""
from __future__ import annotations

import json
import os
from typing import Callable, Dict, List, Optional, Tuple

from . import steering

__all__ = ["apply_skew_value", "shard_apply_means", "table_heat",
           "shard_row_load", "row_load_skew_value",
           "windowed_shard_row_load", "windowed_shard_apply_means",
           "propose_migrate_range", "hot_shard_rule",
           "row_load_rule", "STEERER_NAME", "HEAT_BUCKETS"]

STEERER_NAME = "ps_migrate_range"
HEAT_BUCKETS = 8


def _parse_labels(qualified: str) -> Tuple[str, Dict[str, str]]:
    """``name{k=v,...}`` -> (name, labels). Bare names get {}."""
    if "{" not in qualified or not qualified.endswith("}"):
        return qualified, {}
    name, body = qualified.split("{", 1)
    labels = {}
    for part in body[:-1].split(","):
        if "=" in part:
            k, v = part.split("=", 1)
            labels[k] = v
    return name, labels


def _iter_histograms(doc: Dict, family: str):
    """Yield (labels, snapshot) for every per-process histogram of
    ``family`` in a merged metrics.json (histograms are per-process —
    only counters are pre-totaled by the merge)."""
    for sec in (doc.get("processes") or {}).values():
        hists = ((sec.get("metrics") or {}).get("histograms")) or {}
        for qn, snap in hists.items():
            name, labels = _parse_labels(qn)
            if name == family and isinstance(snap, dict):
                yield labels, snap


def shard_apply_means(doc: Dict, table: str = "_round",
                      min_count: int = 1) -> Dict[int, float]:
    """{shard: mean apply ms} for one table's series, sum/count folded
    across processes (a primary and the backup it failed over from
    both dumped — their observations are one shard's story)."""
    sums: Dict[int, float] = {}
    counts: Dict[int, float] = {}
    for labels, snap in _iter_histograms(doc, "ps.apply_ms"):
        if labels.get("table") != table or "shard" not in labels:
            continue
        try:
            shard = int(labels["shard"])
        except ValueError:
            continue
        c = snap.get("count") or 0
        s = snap.get("sum") or 0.0
        if isinstance(c, (int, float)) and c > 0:
            sums[shard] = sums.get(shard, 0.0) + float(s)
            counts[shard] = counts.get(shard, 0.0) + float(c)
    return {sh: sums[sh] / counts[sh] for sh in sums
            if counts.get(sh, 0) >= min_count}


def windowed_shard_apply_means(doc: Dict, table: str = "_round",
                               min_count: int = 1) -> Dict[int, float]:
    """{shard: mean apply ms OVER THE LAST WINDOW} from the merged
    ``series_windows`` (timeseries.py ships each ``ps.apply_ms``
    histogram as a monotone ``#sum``/``#count`` pair, so the windowed
    mean is delta(sum)/delta(count)). Empty when no series exist —
    callers fall back to the lifetime ``shard_apply_means``."""
    wins = doc.get("series_windows")
    if not isinstance(wins, dict):
        return {}
    sums: Dict[int, float] = {}
    counts: Dict[int, float] = {}
    for qn, win in wins.items():
        if not qn.endswith("#sum") or not isinstance(win, dict):
            continue
        name, labels = _parse_labels(qn[:-len("#sum")])
        if name != "ps.apply_ms" or labels.get("table") != table \
                or "shard" not in labels:
            continue
        cwin = wins.get(qn[:-len("#sum")] + "#count")
        if not isinstance(cwin, dict):
            continue
        ds, dc = win.get("delta"), cwin.get("delta")
        if not isinstance(ds, (int, float)) \
                or not isinstance(dc, (int, float)) or dc <= 0:
            continue
        try:
            shard = int(labels["shard"])
        except ValueError:
            continue
        sums[shard] = sums.get(shard, 0.0) + float(ds)
        counts[shard] = counts.get(shard, 0.0) + float(dc)
    return {sh: sums[sh] / counts[sh] for sh in sums
            if counts.get(sh, 0) >= min_count}


def _skew_ratio(per_shard: Dict[int, float]) -> Optional[float]:
    if len(per_shard) < 2:
        return None
    lo, hi = min(per_shard.values()), max(per_shard.values())
    if lo <= 0:
        return None
    return hi / lo


def apply_skew_value(table: str = "_round", min_count: int = 4,
                     ) -> Callable[[Dict], Optional[float]]:
    """WatchRule extractor: max/min ratio of per-shard mean apply time
    (>= 1.0; 1.0 = perfectly balanced). None until two shards have
    each observed ``min_count`` applies — skew over one shard or over
    a handful of samples is noise, not a migration signal.

    Windowed-first: when the merged doc carries
    ``series_windows`` with enough samples, the skew is computed over
    the LAST WINDOW's apply means — a shard that went hot five minutes
    ago reads hot now, instead of being averaged against hours of
    balanced history. Docs without series (old dumps, sampling off)
    take the lifetime path unchanged."""
    def _get(doc):
        skew = _skew_ratio(windowed_shard_apply_means(
            doc, table=table, min_count=min_count))
        if skew is not None:
            return skew
        return _skew_ratio(shard_apply_means(doc, table=table,
                                             min_count=min_count))
    return _get


def table_heat(doc: Dict, shard: int) -> Dict[str, List[float]]:
    """{table: [heat per bucket]} for one shard, summed over the
    pre-totaled ``ps.row_heat{...}`` counters."""
    totals = doc.get("counters_total") or {}
    out: Dict[str, List[float]] = {}
    for qn, v in totals.items():
        name, labels = _parse_labels(qn)
        if name != "ps.row_heat" or not isinstance(v, (int, float)):
            continue
        if labels.get("shard") != str(shard):
            continue
        t = labels.get("table")
        try:
            b = int(labels.get("bucket", ""))
        except ValueError:
            continue
        if not t or not (0 <= b < HEAT_BUCKETS):
            continue
        out.setdefault(t, [0.0] * HEAT_BUCKETS)[b] += float(v)
    return out


def shard_row_load(doc: Dict,
                   table: Optional[str] = None) -> Dict[int, float]:
    """{shard: total row touches} from the pre-totaled ``ps.row_heat``
    counters, optionally restricted to one table. Counters, so the
    value is bit-deterministic for a deterministic workload — the
    skew signal the seeded chaos drill gates on."""
    totals = doc.get("counters_total") or {}
    out: Dict[int, float] = {}
    for qn, v in totals.items():
        name, labels = _parse_labels(qn)
        if name != "ps.row_heat" or not isinstance(v, (int, float)):
            continue
        if table is not None and labels.get("table") != table:
            continue
        try:
            shard = int(labels.get("shard", ""))
        except ValueError:
            continue
        out[shard] = out.get(shard, 0.0) + float(v)
    return out


def windowed_shard_row_load(doc: Dict, table: Optional[str] = None
                            ) -> Dict[int, float]:
    """{shard: row touches OVER THE LAST WINDOW} from the merged
    ``series_windows`` deltas of the ``ps.row_heat`` counters. Empty
    when no series exist — callers fall back to the lifetime
    ``shard_row_load``."""
    wins = doc.get("series_windows")
    if not isinstance(wins, dict):
        return {}
    out: Dict[int, float] = {}
    for qn, win in wins.items():
        if not isinstance(win, dict):
            continue
        name, labels = _parse_labels(qn)
        if name != "ps.row_heat" \
                or not isinstance(win.get("delta"), (int, float)):
            continue
        if table is not None and labels.get("table") != table:
            continue
        try:
            shard = int(labels.get("shard", ""))
        except ValueError:
            continue
        out[shard] = out.get(shard, 0.0) + float(win["delta"])
    return out


def row_load_skew_value(table: Optional[str] = None,
                        min_rows: int = 8,
                        ) -> Callable[[Dict], Optional[float]]:
    """WatchRule extractor: max/min ratio of per-shard row touches
    (>= 1.0). None until two shards have each absorbed ``min_rows``
    touches — same noise discipline as ``apply_skew_value``, but over
    counters, so a seeded workload yields a seeded signal.

    Windowed-first: with merged ``series_windows``
    present, the ratio is over the LAST WINDOW's row touches (skew
    since the last few dump ticks, not since process start); the
    ``min_rows`` floor then applies per window. Lifetime fallback is
    bit-identical for docs without series."""
    def _get(doc):
        wload = {s: v
                 for s, v in windowed_shard_row_load(doc,
                                                     table).items()
                 if v >= min_rows}
        skew = _skew_ratio(wload)
        if skew is not None:
            return skew
        load = {s: v for s, v in shard_row_load(doc, table).items()
                if v >= min_rows}
        return _skew_ratio(load)
    return _get


def _read_merged(metrics_dir: Optional[str]) -> Optional[Dict]:
    from . import distributed as _dist

    d = metrics_dir or os.environ.get("PADDLE_TPU_METRICS_DIR",
                                      "").strip()
    if not d:
        return None
    try:
        with open(os.path.join(d, _dist.MERGED_METRICS_NAME), "r",
                  encoding="utf-8") as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def propose_migrate_range(report=None, *, doc: Optional[Dict] = None,
                          metrics_dir: Optional[str] = None,
                          height: Optional[int] = None,
                          nshards: Optional[int] = None,
                          min_count: int = 4,
                          by: str = "apply_ms") -> Dict:
    """The ``ps_migrate_range`` steerer body (``report`` is the shared
    steerer signature's profile slot — unused here, the PS signal
    lives in the merged metrics, not a step profile).

    Derivation: hot shard = max mean ``ps.apply_ms{table=_round}``
    (``by="apply_ms"``) or max ``ps.row_heat`` row touches
    (``by="row_heat"`` — deterministic, the seeded drill's choice);
    cold shard = min; hot table = the series that carries the most of
    that signal on the hot shard; split = the heat-bucket edge inside
    the hot shard's span that best separates hot rows from cold,
    moving the hotter side. Raises ``ValueError`` when the telemetry
    cannot support a plan (the daemon records that as a
    propose_error, exactly like a placement search that found
    nothing)."""
    if doc is None:
        doc = _read_merged(metrics_dir)
    if not isinstance(doc, dict):
        raise ValueError("no merged metrics document to steer from")
    if by not in ("apply_ms", "row_heat"):
        raise ValueError("by must be 'apply_ms' or 'row_heat', got %r"
                         % (by,))

    means = shard_apply_means(doc, table="_round",
                              min_count=min_count)
    if by == "row_heat":
        load = shard_row_load(doc)
        if len(load) < 2:
            raise ValueError("need >= 2 shards with row-heat "
                             "counters, have %d" % len(load))
        hot = max(load, key=lambda s: load[s])
        cold = min(load, key=lambda s: load[s])
        skew = (load[hot] / load[cold] if load.get(cold) else None)
    else:
        if len(means) < 2:
            raise ValueError("need >= 2 shards with apply timings, "
                             "have %d" % len(means))
        hot = max(means, key=lambda s: means[s])
        cold = min(means, key=lambda s: means[s])
        skew = (means[hot] / means[cold] if means.get(cold) else None)
    if hot == cold:
        raise ValueError("no per-shard skew to steer on")

    if by == "row_heat":
        # the hot TABLE on the hot shard by row touches
        per_table = {t: sum(h) for t, h in table_heat(doc, hot).items()
                     if sum(h) > 0}
    else:
        # ... by per-table apply time (skip the synthetic whole-round
        # series): the move must name real rows of a real table
        per_table = {}
        for labels, snap in _iter_histograms(doc, "ps.apply_ms"):
            t = labels.get("table")
            if labels.get("shard") != str(hot) or not t \
                    or t == "_round":
                continue
            c, s = snap.get("count") or 0, snap.get("sum") or 0.0
            if isinstance(c, (int, float)) and c > 0:
                per_table[t] = per_table.get(t, 0.0) + float(s)
    if not per_table:
        raise ValueError("hot shard %d has no per-table %s series"
                         % (hot, by))
    table = max(per_table, key=lambda t: per_table[t])

    if nshards is None:
        nshards = len(means)
    if height is None:
        # widest table_rows gauge for this table across shards: the
        # sharded client stamps the GLOBAL height on every push
        best = 0
        totals = doc.get("processes") or {}
        for sec in totals.values():
            gauges = ((sec.get("metrics") or {}).get("gauges")) or {}
            for qn, v in gauges.items():
                name, labels = _parse_labels(qn)
                if name == "ps.table_rows" \
                        and labels.get("table") == table \
                        and isinstance(v, (int, float)):
                    best = max(best, int(v))
        height = best
    if not height or height < nshards:
        raise ValueError("cannot size table %r (height=%r)"
                         % (table, height))

    from ..distributed.ps_shard import row_range

    span_lo, span_hi = row_range(hot, int(height), int(nshards))
    if span_hi - span_lo < 2:
        raise ValueError("hot shard %d's span [%d,%d) is too narrow "
                         "to split" % (hot, span_lo, span_hi))

    heat = (table_heat(doc, hot).get(table)
            or [1.0] * HEAT_BUCKETS)
    # the server's heat census buckets over ITS OWN slice (it never
    # knows the global partition), so bucket b of the donor covers
    # the donor-span rows [span_lo + b*len/8, span_lo + (b+1)*len/8)
    # — edges and side heat both map through the span, not the table
    span_len = span_hi - span_lo
    edges = sorted({
        e for b in range(1, HEAT_BUCKETS)
        for e in (span_lo + (b * span_len + HEAT_BUCKETS - 1)
                  // HEAT_BUCKETS,)
        if span_lo < e < span_hi})
    if not edges:
        edges = [(span_lo + span_hi) // 2]

    def _side_heat(lo: int, hi: int) -> float:
        tot = 0.0
        for b, hv in enumerate(heat):
            blo = span_lo + b * span_len // HEAT_BUCKETS
            bhi = span_lo + (b + 1) * span_len // HEAT_BUCKETS
            ov = max(0, min(hi, bhi) - max(lo, blo))
            if ov > 0 and bhi > blo:
                tot += hv * ov / (bhi - blo)
        return tot

    # pick the edge maximizing heat-per-row contrast between the two
    # sides, then move the hotter side off the hot shard
    best_edge, best_lo, best_hi, best_score = None, None, None, -1.0
    for e in edges:
        for lo, hi in ((span_lo, e), (e, span_hi)):
            rows = hi - lo
            rest = (span_hi - span_lo) - rows
            if rows <= 0 or rest <= 0:
                continue
            score = _side_heat(lo, hi) / rows \
                - _side_heat(*((e, span_hi) if lo == span_lo
                               else (span_lo, e))) / rest
            if score > best_score:
                best_edge, best_lo, best_hi = e, lo, hi
                best_score = score
    if best_lo is None:
        best_lo, best_hi = span_lo, (span_lo + span_hi) // 2

    return {
        "kind": "migrate_range",
        "table": table,
        "lo": int(best_lo),
        "hi": int(best_hi),
        "from_shard": int(hot),
        "to_shard": int(cold),
        "height": int(height),
        "nshards": int(nshards),
        "by": by,
        "skew": round(skew, 4) if skew else None,
        "shard_apply_ms": {str(s): round(v, 4)
                           for s, v in sorted(means.items())},
    }


def hot_shard_rule(threshold: float = 0.5, floor: float = 0.25,
                   min_count: int = 4):
    """The daemon-side ``WatchRule`` for this steerer: per-shard apply
    skew rising past ``threshold`` (relative to the rule's own
    baseline, past an absolute ``floor``) re-runs the steerer. Late
    import keeps module import order loose (the daemon imports THIS
    module through ``_import_consumers``)."""
    from .steering_daemon import WatchRule

    return WatchRule("ps_apply_skew",
                     apply_skew_value(min_count=min_count),
                     direction=-1, threshold=threshold, floor=floor,
                     steerer=STEERER_NAME,
                     description="per-shard PS apply-time skew "
                                 "(max/min mean ratio)")


def row_load_rule(threshold: float = 0.5, floor: float = 0.25,
                  min_rows: int = 8,
                  table: Optional[str] = None):
    """The counter twin of ``hot_shard_rule``: per-shard row-touch
    skew. Deterministic for a seeded workload — the CI chaos drill's
    rule (a wall-time rule under CI jitter flickers on which shard
    reads hot; row counters cannot)."""
    from .steering_daemon import WatchRule

    return WatchRule("ps_row_load_skew",
                     row_load_skew_value(table=table,
                                         min_rows=min_rows),
                     direction=-1, threshold=threshold, floor=floor,
                     steerer=STEERER_NAME,
                     description="per-shard PS row-touch skew "
                                 "(max/min ps.row_heat ratio)")


steering.register_steerer(
    STEERER_NAME, propose_migrate_range,
    description="hot-shard row-range rebalance: apply-time skew + "
                "row heat -> a migrate_range plan")
