"""A job's postmortem: merge its dumps and print the flight events of every
process on one clock.

The twin of ``tools/ft_timeline.py`` over the port. After a supervised run
with ``PADDLE_TPU_METRICS_DIR`` set, every process (the launcher, each
rank, a steering daemon) has left its dump (registry snapshot, span buffer,
flight ring) in the directory. This merges them (``metrics.json`` and the
chrome trace ``trace.json``, ``observability.distributed.merge_job_dir``)
and prints the ordered sequence of flight events over all processes,
rebased onto the wall clock: spawns, clock syncs, steering proposals,
canary decisions, exits. Where the directory also holds the steering
audit trail, each interleaved A/B canary decision follows, window by
window.

Usage: python tools/torch_ft_timeline.py <metrics_dir> [--limit N]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict, List, Optional

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:  # the script's directory is tools/
    sys.path.insert(0, REPO)


def load_events(dirname: str) -> List[Dict]:
    """Every flight event of every dump in ``dirname`` on the wall clock,
    sorted: ``{"t_us", "proc", "pid", "incarnation", "kind", "fields"}``."""
    from paddle_tpu_torch.observability import distributed as dist

    out = []
    for doc in dist.load_dumps(dirname):
        inc = int(doc.get("incarnation", 0) or 0)
        for t_us, kind, fields in dist.doc_flight_events(doc):
            out.append({"t_us": t_us, "proc": doc["proc"],
                        "pid": doc.get("pid"), "incarnation": inc,
                        "kind": kind, "fields": fields})
    out.sort(key=lambda e: e["t_us"])
    return out


def format_events(events: List[Dict]) -> List[str]:
    """One line an event, times relative to the first; a process of a
    later job incarnation is tagged ``i<n>``."""
    if not events:
        return []
    multi_inc = len({e.get("incarnation", 0) for e in events}) > 1
    t0 = events[0]["t_us"]
    lines = []
    for e in events:
        kv = " ".join("%s=%s" % (k, e["fields"][k])
                      for k in sorted(e["fields"]))
        proc = e["proc"]
        if multi_inc:
            proc = "i%d:%s" % (e.get("incarnation", 0), proc)
        lines.append("+%9.3fs %-12s %-20s %s"
                     % ((e["t_us"] - t0) / 1e6, proc, e["kind"], kv))
    return lines


def load_ab_entries(dirname: str) -> List[Dict]:
    """The interleaved A/B canary decisions of the directory's
    ``steering_audit.json``, in append order."""
    from paddle_tpu_torch.observability import canary

    return [e for e in canary.AuditTrail(dirname).entries()
            if e.get("protocol") == canary.AB_PROTOCOL]


def format_ab_timeline(entries) -> List[str]:
    """A block a decision: its header, then each measurement window with
    its open and close relative to the first, a candidate window with its
    pair's verdict."""
    lines: List[str] = []
    for e in entries:
        score = e.get("objective_score")
        lines.append("ab #%s %s plan %s decision=%s reason=%s pairs=%s/%s%s"
                     % (e.get("seq"), e.get("steerer"),
                        str(e.get("plan_digest") or "")[:12],
                        e.get("decision"), e.get("reason"),
                        e.get("ok_pairs"), e.get("pairs"),
                        "" if score is None else " score=%+.4f" % score))
        windows = e.get("windows") or []
        verdicts = {p.get("pair"): p for p in (e.get("pair_verdicts") or [])}
        t0 = windows[0].get("t_open") if windows else None
        for w in windows:
            tag = "A" if w.get("phase") == "incumbent" else "B"
            try:
                span = "+%.3fs..+%.3fs" % (float(w["t_open"]) - float(t0),
                                           float(w["t_close"]) - float(t0))
            except (KeyError, TypeError, ValueError):
                span = "?"
            line = "  w%02d pair%d %s %-10s %s" % (
                w.get("seq", 0), w.get("pair", 0), tag, w.get("phase"), span)
            p = verdicts.get(w.get("pair")) if tag == "B" else None
            if p:
                line += "  verdict=%s" % p.get("verdict")
            lines.append(line)
    return lines


def print_postmortem(dirname: str, limit: Optional[int] = None,
                     out=sys.stdout) -> int:
    """Merge, then print the timeline. Returns the number of event lines
    printed (0: nothing to tell)."""
    from paddle_tpu_torch.observability import distributed as dist

    mpath, tpath = dist.merge_job_dir(dirname)
    events = load_events(dirname)
    lines = format_events(events)
    procs = sorted({e["proc"] for e in events})
    print("== postmortem: %d flight events from %d process(es) %s =="
          % (len(events), len(procs), procs), file=out)
    if mpath:
        with open(mpath, "r", encoding="utf-8") as f:
            pinfo = json.load(f).get("processes") or {}
        srcs = sorted("%s:%s" % (k, v.get("span_source"))
                      for k, v in pinfo.items())
        if srcs:
            print("span sources: %s" % " ".join(srcs), file=out)
    if limit is not None and len(lines) > limit:
        print("... (%d earlier events elided; --limit 0 for all)"
              % (len(lines) - limit), file=out)
        lines = lines[-limit:]
    for ln in lines:
        print(ln, file=out)
    ab = load_ab_entries(dirname)
    if ab:
        print("== A/B canary windows (%d decision(s)) ==" % len(ab),
              file=out)
        for ln in format_ab_timeline(ab):
            print(ln, file=out)
    if mpath:
        print("merged: %s + %s" % (mpath, tpath), file=out)
    return len(lines)


def main() -> int:
    ap = argparse.ArgumentParser("torch_ft_timeline")
    ap.add_argument("metrics_dir", help="the job's $PADDLE_TPU_METRICS_DIR")
    ap.add_argument("--limit", type=int, default=200,
                    help="print at most the newest N lines (0: all)")
    args = ap.parse_args()
    if not os.path.isdir(args.metrics_dir):
        print("no such metrics dir: %s" % args.metrics_dir, file=sys.stderr)
        return 2
    n = print_postmortem(args.metrics_dir, limit=args.limit or None)
    return 0 if n else 1


if __name__ == "__main__":
    sys.exit(main())
