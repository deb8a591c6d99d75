"""Span spooling: telemetry of a long run that outlives the span ring.

Counterpart of ``paddle_tpu/observability/spool.py:65`` (standard library
only, so the port keeps its own copy). The span buffer
(``observability.tracing``) is a 64k-entry ring: a live cache, lossy as
a record. With ``PADDLE_TPU_METRICS_DIR`` set, the per-process dumper
(``observability.distributed.arm``) installs a ``SpanSpool`` and every
recorded span is offered to it:

- **Head**: the first ``PADDLE_TPU_SPOOL_HEAD`` spans (default 65536)
  stream verbatim to size-bounded segment files
  ``<proc>.spans-<nnn>.jsonl`` (rotated at ``PADDLE_TPU_SPOOL_SEGMENT_MB``,
  default 8 MB): a run's start and warm-up are kept exactly.
- **Reservoir**: past the head, weighted reservoir sampling (seeded by
  ``PADDLE_TPU_SPOOL_SEED``, default 0) of capacity
  ``PADDLE_TPU_SPOOL_RESERVOIR`` (default 65536). A span's keep-weight is
  its duration times the inverse frequency of its category so far
  (Efraimidis-Spirakis A-ES keys ``u^(1/w)`` in a min-heap), so a rare
  long span survives where a uniform sample would drop it.
  ``PADDLE_TPU_SPOOL_POLICY=uniform`` takes the plain uniform sampler.
  The reservoir is rewritten atomically to ``<proc>.spans-res.json`` on
  every flush (each dump, at exit, on SIGTERM).

Disk use is bounded by the head and reservoir counts, whatever the run's
length. One line per span: the JSON array ``[name, ts_us, dur_us, tid,
cat, args]``, the tracing tuple.
"""
from __future__ import annotations

import glob
import heapq
import json
import os
import random
import threading
from typing import Dict, List, Optional, Tuple

__all__ = ["SpanSpool", "load_spooled_spans", "spool_files"]

DEFAULT_HEAD = 65536
DEFAULT_RESERVOIR = 65536
DEFAULT_SEGMENT_BYTES = 8 << 20
_FLUSH_EVERY = 1024   # pending head spans per synchronous file append

_RES_SCHEMA = "span_reservoir_v1"


def _policy_from_env() -> str:
    raw = os.environ.get("PADDLE_TPU_SPOOL_POLICY", "").strip().lower()
    return "uniform" if raw == "uniform" else "weighted"


class SpanSpool:
    """Head + seeded-reservoir span spooler for one process."""

    def __init__(self, dirname: str, base: str,
                 head: int = DEFAULT_HEAD,
                 reservoir: int = DEFAULT_RESERVOIR,
                 segment_bytes: int = DEFAULT_SEGMENT_BYTES,
                 seed: int = 0, flush_every: int = _FLUSH_EVERY,
                 policy: Optional[str] = None):
        self.dirname = dirname
        self.base = base
        self.head = max(0, int(head))
        self.res_cap = max(0, int(reservoir))
        self.segment_bytes = max(1024, int(segment_bytes))
        self._flush_every = max(1, int(flush_every))
        self._rng = random.Random(int(seed))
        self._lock = threading.Lock()
        self.policy = policy if policy in ("uniform", "weighted") \
            else _policy_from_env()
        self._offered = 0          # spans ever offered
        self._head_kept = 0
        self._pending: List[Tuple] = []   # head spans not yet on disk
        # uniform: [(stream idx, span)];
        # weighted: min-HEAP of (A-ES key, stream idx, span) — the
        # root is always the entry with the weakest claim to survive
        self._res: List[Tuple] = []
        self._res_seen = 0         # post-head spans seen
        self._cat_seen: Dict[object, int] = {}  # per-category counts
        self._res_dirty = False
        self._seg_idx = 0
        self._seg_bytes = 0

    @classmethod
    def from_env(cls, dirname: str, base: str) -> "SpanSpool":
        def _i(name, default):
            try:
                return int(os.environ.get(name, "") or default)
            except ValueError:
                return default

        return cls(dirname, base,
                   head=_i("PADDLE_TPU_SPOOL_HEAD", DEFAULT_HEAD),
                   reservoir=_i("PADDLE_TPU_SPOOL_RESERVOIR",
                                DEFAULT_RESERVOIR),
                   segment_bytes=_i("PADDLE_TPU_SPOOL_SEGMENT_MB", 8)
                   * (1 << 20),
                   seed=_i("PADDLE_TPU_SPOOL_SEED", 0))

    # -- recording ---------------------------------------------------------

    def _weight(self, ev: Tuple) -> float:
        """Keep-weight of a span: duration x inverse category
        frequency. Long spans outweigh short ones; spans of a category
        seen once per million outweigh the million — "rare but long"
        compounds both, which is exactly the event a postmortem needs
        and a uniform sample loses."""
        try:
            dur = float(ev[2])
        except (TypeError, ValueError, IndexError):
            dur = 0.0
        cat = ev[4] if len(ev) > 4 else None
        seen = self._cat_seen.get(cat, 0) + 1
        self._cat_seen[cat] = seen
        rarity = self._res_seen / float(seen)
        return max(dur, 1.0) * max(rarity, 1.0)

    def offer(self, ev: Tuple) -> None:
        """Called by ``tracing._record`` for every completed span.
        Cheap: a counter, a list/heap append, and (amortized) one file
        append per ``flush_every`` head spans. The append happens
        under the lock — concurrent recording threads' batches must
        reach the segment file in stream order (the head's contract),
        and the write is a small buffered append."""
        with self._lock:
            self._offered += 1
            if self._head_kept < self.head:
                self._head_kept += 1
                self._pending.append(ev)
                if len(self._pending) >= self._flush_every:
                    batch, self._pending = self._pending, []
                    self._append_segment_locked(batch)
            elif self.res_cap:
                self._res_seen += 1
                if self.policy == "weighted":
                    # Efraimidis–Spirakis A-ES: key = u^(1/w); keeping
                    # the res_cap LARGEST keys is a weighted sample
                    # without replacement. Seeded rng ⇒ reproducible.
                    w = self._weight(ev)
                    u = self._rng.random() or 1e-12
                    key = u ** (1.0 / w)
                    if len(self._res) < self.res_cap:
                        heapq.heappush(self._res,
                                       (key, self._offered, ev))
                        self._res_dirty = True
                    elif key > self._res[0][0]:
                        heapq.heapreplace(self._res,
                                          (key, self._offered, ev))
                        self._res_dirty = True
                elif len(self._res) < self.res_cap:
                    self._res.append((self._offered, ev))
                    self._res_dirty = True
                else:
                    j = self._rng.randrange(self._res_seen)
                    if j < self.res_cap:
                        self._res[j] = (self._offered, ev)
                        self._res_dirty = True

    # -- persistence -------------------------------------------------------

    def _seg_path(self, idx: int) -> str:
        return os.path.join(self.dirname,
                            "%s.spans-%03d.jsonl" % (self.base, idx))

    def _res_path(self) -> str:
        return os.path.join(self.dirname,
                            "%s.spans-res.json" % self.base)

    def _append_segment_locked(self, events: List[Tuple]) -> None:
        """Append head spans to the current segment, rotating to a new
        file when the size bound is reached. Caller holds ``_lock`` —
        batches land in stream order, lines never interleave."""
        lines = []
        for ev in events:
            lines.append(json.dumps(list(ev), default=str))
        payload = "\n".join(lines) + "\n"
        try:
            os.makedirs(self.dirname, exist_ok=True)
            with open(self._seg_path(self._seg_idx), "a",
                      encoding="utf-8") as f:
                f.write(payload)
            self._seg_bytes += len(payload)
            if self._seg_bytes >= self.segment_bytes:
                self._seg_idx += 1
                self._seg_bytes = 0
        except OSError:
            pass   # telemetry must never kill work

    def flush(self) -> None:
        """Drain pending head spans to their segment and rewrite the
        reservoir file (atomic) if it changed — wired into the
        periodic / at-exit / on-signal dump path."""
        with self._lock:
            batch, self._pending = self._pending, []
            if batch:
                self._append_segment_locked(batch)
            res_dirty = self._res_dirty
            self._res_dirty = False
            res_snapshot = (self._res_events_locked() if res_dirty
                            else None)
            stats = self._stats_locked()
        if res_snapshot is not None:
            try:
                from ..checkpoint import atomic_write_bytes

                doc = {"schema": _RES_SCHEMA, "proc": self.base,
                       "stats": stats,
                       "events": [list(ev) for ev in res_snapshot]}
                atomic_write_bytes(self._res_path(),
                                   json.dumps(doc, default=str).encode())
            except Exception:
                pass

    def _res_events_locked(self) -> List[Tuple]:
        """Reservoir spans in stream order, either policy's entry
        shape ((idx, ev) uniform / (key, idx, ev) weighted heap)."""
        if self.policy == "weighted":
            return [t[2] for t in sorted(self._res,
                                         key=lambda t: t[1])]
        return [ev for _, ev in sorted(self._res)]

    def _stats_locked(self) -> Dict[str, int]:
        return {"offered": self._offered,
                "head_kept": self._head_kept,
                "reservoir_kept": len(self._res),
                "reservoir_seen": self._res_seen,
                "sampled_out": max(0, self._res_seen - len(self._res)),
                "policy": self.policy,
                "segments": self._seg_idx + 1}

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return self._stats_locked()


# -- readers (merge_job_dir / ft_timeline) ----------------------------------


def spool_files(dirname: str, base: str) -> List[str]:
    """This proc's head segments (sorted) + reservoir file, if any."""
    out = sorted(glob.glob(os.path.join(
        dirname, glob.escape(base) + ".spans-[0-9]*.jsonl")))
    res = os.path.join(dirname, base + ".spans-res.json")
    if os.path.exists(res):
        out.append(res)
    return out


def load_spooled_spans(dirname: str, base: str) -> Optional[List[List]]:
    """Every spooled span for ``base`` (head segments in stream order,
    then the reservoir sample), or None when the process never spooled
    — the caller then falls back to the dump's ring snapshot."""
    files = spool_files(dirname, base)
    if not files:
        return None
    events: List[List] = []
    for path in files:
        try:
            if path.endswith(".jsonl"):
                with open(path, "r", encoding="utf-8") as f:
                    for line in f:
                        line = line.strip()
                        if not line:
                            continue
                        try:
                            ev = json.loads(line)
                        except ValueError:
                            continue   # torn tail line of a kill
                        if isinstance(ev, list):
                            events.append(ev)
            else:
                with open(path, "r", encoding="utf-8") as f:
                    doc = json.load(f)
                if isinstance(doc, dict) \
                        and doc.get("schema") == _RES_SCHEMA:
                    events.extend(ev for ev in doc.get("events") or []
                                  if isinstance(ev, list))
        except (OSError, ValueError):
            continue
    return events
