"""The collective schedule: consistency of the collectives each rank
issues.

Counterpart of ``paddle_tpu/analysis/collective.py``
(``extract_collective_schedule:121``, ``check_collective_schedule:204``,
``check_cross_rank:239``, ``schedule_record:282``), over the port's
collective ops (``ops/collective_ops.py``: ``c_allreduce_*``,
``c_bucket_allreduce``, ``c_sharded_update``, ``c_broadcast``,
``c_allgather``, ``c_reducescatter``, ``c_concat``) and hybrid ops
(``ops/hybrid_parallel_ops.py``: ``c_sharded_lookup``,
``c_ring_attention``). Every rank of a mesh must issue the same sequence
of collectives: same order, kind, ring or axis, payload element count
and dtype. A divergent order deadlocks; a divergent payload corrupts.

- single-program form (``check_collective_schedule``, the engine's check
  before its first step): no collective under a ``while`` /
  ``conditional_block`` (a conditional collective), and no payload
  reduced twice with no write between (a double reduce scales it by
  nranks);
- cross-rank form (``check_cross_rank``): one schedule or program a
  rank, compared position by position; the first divergence is reported
  with both ops named, as would-deadlock (kind, order, ring) or
  would-corrupt (numel, dtype).

``schedule_record`` gives the single-program check and a digest of the
schedule as a record instead of raising.
"""
from __future__ import annotations

import hashlib
from typing import Dict, List, Optional, Sequence, Tuple

from .verifier import Finding, IRVerificationError, ERROR

__all__ = ["CollectiveSig", "CollectiveMismatchError",
           "extract_collective_schedule", "check_collective_schedule",
           "check_cross_rank", "schedule_record"]

# collective families that move payload; the stream-sync / comm-setup
# host ops (c_sync_*, c_gen_nccl_id, c_comm_init) carry none and are
# excluded — they cannot deadlock a mesh by themselves
_PAYLOAD_PREFIXES = ("c_allreduce", "c_bucket_allreduce",
                     "c_sharded_update", "c_broadcast", "c_allgather",
                     "c_reducescatter", "c_concat", "c_alltoall",
                     "c_sharded_lookup", "c_ring_attention")
_PAYLOAD_TYPES = ("allreduce", "broadcast")  # legacy op names


class CollectiveMismatchError(IRVerificationError):
    """Rank-divergent collective schedule: ``.kind`` is
    ``"would-deadlock"`` or ``"would-corrupt"``; ``.pair`` holds the
    two diverging (rank, position, sig) descriptions."""

    def __init__(self, message, kind="would-deadlock", pair=(),
                 findings=()):
        self.kind = kind
        self.pair = tuple(pair)
        super().__init__(message, findings)


class CollectiveSig:
    """One collective's schedule-relevant identity."""

    __slots__ = ("pos", "op_index", "op_type", "ring", "axis", "numel",
                 "dtype", "members")

    def __init__(self, pos, op_index, op_type, ring, axis, numel, dtype,
                 members):
        self.pos = pos            # position in the collective sequence
        self.op_index = op_index  # position in the block's op list
        self.op_type = op_type
        self.ring = ring          # ring_id attr (mesh axis id)
        self.axis = axis          # explicit shard_axis attr, if any
        self.numel = numel        # total payload elements (None=unknown)
        self.dtype = dtype
        self.members = members    # payload var count (bucket width)

    def key(self) -> Tuple:
        return (self.op_type, self.ring, self.axis, self.numel,
                self.dtype, self.members)

    def __str__(self):
        return ("%s(#%d: ring=%s%s, %s x %s elems, %d member%s)"
                % (self.op_type, self.op_index, self.ring,
                   ", axis=%s" % self.axis if self.axis else "",
                   self.dtype, self.numel, self.members,
                   "s" if self.members != 1 else ""))

    __repr__ = __str__


def _is_payload_collective(op_type: str) -> bool:
    if op_type.endswith("_await"):
        # the await half of an async pair slices a Pending buffer back
        # into its members — the wire payload (and the deadlock
        # surface) belongs to the matching _start op
        return False
    return (op_type.startswith(_PAYLOAD_PREFIXES)
            or op_type in _PAYLOAD_TYPES)


def _payload_names(op) -> List[str]:
    for slot in ("X", "Grad", "Q"):
        names = op.input(slot)
        if names:
            return [n for n in names if n]
    return [n for n in op.input_arg_names if n]


def _collectives_in_block(block) -> List[Tuple[int, str]]:
    """(op index, op type) of payload collectives anywhere under a
    block, recursing through nested sub-blocks."""
    out = []
    for i, op in enumerate(block.ops):
        if _is_payload_collective(op.type):
            out.append((i, op.type))
        sb = op.attrs.get("sub_block")
        if sb is not None:
            out.extend(_collectives_in_block(sb))
    return out


def extract_collective_schedule(program, scope=None
                                ) -> Tuple[List[CollectiveSig],
                                           List[Finding]]:
    """The static sequence of payload collectives the program's global
    block issues, plus findings for collectives hiding under
    conditional sub-blocks (which this schedule CANNOT represent — on
    a rank where the branch goes the other way the sequence differs)."""
    from ..parallel.collectives import _numel_and_dtype

    block = program.global_block()
    sigs: List[CollectiveSig] = []
    findings: List[Finding] = []
    for i, op in enumerate(block.ops):
        sb = op.attrs.get("sub_block")
        if sb is not None:
            for j, t in _collectives_in_block(sb):
                findings.append(Finding(
                    "conditional-collective", ERROR, block.idx, i,
                    op.type,
                    "collective %r (sub-block %d op #%d) executes "
                    "under a data-dependent branch — ranks taking "
                    "different branches issue different schedules "
                    "(would deadlock)" % (t, sb.idx, j)))
        if not _is_payload_collective(op.type):
            continue
        names = _payload_names(op)
        total = 0
        dtype = None
        unknown = False
        for n in names:
            k, dt = _numel_and_dtype(block, scope, n)
            if k is None:
                unknown = True
            else:
                total += k
            dtype = dtype or dt
        sigs.append(CollectiveSig(
            pos=len(sigs), op_index=i, op_type=op.type,
            ring=op.attrs.get("ring_id", 0),
            axis=op.attrs.get("shard_axis") or None,
            numel=None if unknown else total,
            dtype=dtype, members=len(names)))
    return sigs, findings


def _double_reduce_findings(program) -> List[Finding]:
    """An in-place psum applied twice to the same var with no
    non-collective write in between multiplies it by nranks."""
    block = program.global_block()
    findings: List[Finding] = []
    reduce_ops = ("c_allreduce", "c_bucket_allreduce")
    last_reduced_at: Dict[str, int] = {}
    for i, op in enumerate(block.ops):
        if op.type == "c_bucket_allreduce_await":
            # the await WRITES the reduced value its start produced —
            # neither a second reduction nor a mark-clearing fresh
            # write (a later re-reduce of the same grad must still
            # flag, so the start's mark survives the await)
            continue
        if op.type.startswith(reduce_ops):
            for n in _payload_names(op):
                prev = last_reduced_at.get(n)
                if prev is not None:
                    findings.append(Finding(
                        "double-reduce", ERROR, block.idx, i, op.type,
                        "%r is reduced again (already reduced by op "
                        "#%d %s, not rewritten since) — the payload "
                        "would be scaled by nranks twice (would "
                        "corrupt)" % (n, prev, block.ops[prev].type)))
                last_reduced_at[n] = i
        else:
            for n in op.output_arg_names:
                last_reduced_at.pop(n, None)
    return findings


def schedule_digest(sigs: Sequence[CollectiveSig]) -> str:
    h = hashlib.sha1()
    for s in sigs:
        h.update(repr(s.key()).encode())
    return h.hexdigest()


def check_collective_schedule(program, nranks: Optional[int] = None,
                              where: str = "", scope=None
                              ) -> List[CollectiveSig]:
    """Single-program form: extract the schedule and raise
    ``CollectiveMismatchError`` on conditional collectives or
    double-reduce hazards. Under SPMD every rank traces this same
    program, so a clean single-program schedule IS the cross-rank
    proof for a single-process mesh; multi-process meshes compare
    ``schedule_digest`` across processes instead."""
    sigs, findings = extract_collective_schedule(program, scope=scope)
    if nranks is not None and nranks <= 1:
        return sigs  # a one-rank "mesh" cannot diverge from itself
    findings += _double_reduce_findings(program)
    errors = [f for f in findings if f.severity == ERROR]
    if errors:
        # a pure double-reduce hazard corrupts (every rank still issues
        # the same sequence); any conditional collective can deadlock
        kind = ("would-corrupt"
                if all(f.invariant == "double-reduce" for f in errors)
                else "would-deadlock")
        raise CollectiveMismatchError(
            "collective schedule%s is rank-divergence-unsafe:\n  %s"
            % (" (%s)" % where if where else "",
               "\n  ".join(str(f) for f in errors)),
            kind=kind, findings=findings)
    return sigs


def _as_schedule(entry, scope=None) -> List[CollectiveSig]:
    if isinstance(entry, (list, tuple)):
        return list(entry)
    sigs, _ = extract_collective_schedule(entry, scope=scope)
    return sigs


def check_cross_rank(per_rank, where: str = "", scope=None) -> int:
    """Cross-rank form: ``per_rank`` is one schedule (or Program) per
    rank. Verifies all ranks would issue an identical collective
    sequence; raises ``CollectiveMismatchError`` naming the diverging
    op pair otherwise. Returns the common schedule length."""
    scheds = [_as_schedule(e, scope=scope) for e in per_rank]
    if not scheds:
        return 0
    ref = scheds[0]
    for r, sched in enumerate(scheds[1:], start=1):
        n = min(len(ref), len(sched))
        for k in range(n):
            a, b = ref[k], sched[k]
            if a.key() == b.key():
                continue
            same_op = (a.op_type == b.op_type and a.ring == b.ring
                       and a.axis == b.axis)
            kind = "would-corrupt" if same_op else "would-deadlock"
            consequence = (
                "payload mismatch silently corrupts the reduction"
                if same_op else
                "ranks block inside DIFFERENT collectives — deadlock")
            raise CollectiveMismatchError(
                "collective schedule%s diverges at position %d: "
                "rank 0 issues %s but rank %d issues %s — %s"
                % (" (%s)" % where if where else "", k, a, r, b,
                   consequence),
                kind=kind, pair=((0, k, a), (r, k, b)))
        if len(ref) != len(sched):
            rr, extra = (0, ref[n]) if len(ref) > len(sched) \
                else (r, sched[n])
            raise CollectiveMismatchError(
                "collective schedule%s diverges: rank %d issues %d "
                "collectives but rank %d issues %d — first unmatched "
                "op is rank %d's %s; the other rank never enters it "
                "(deadlock)"
                % (" (%s)" % where if where else "", 0, len(ref), r,
                   len(sched), rr, extra),
                kind="would-deadlock",
                pair=((rr, n, extra),))
    return len(ref)


def schedule_record(program, nranks: Optional[int] = None, scope=None
                    ) -> Dict:
    """Bench-artifact form: run the single-program check and return a
    JSON-able record (ok flag, schedule length, digest, and the error
    text when not ok) instead of raising — bench runs should report,
    not crash."""
    try:
        sigs = check_collective_schedule(program, nranks=nranks,
                                         scope=scope)
    except CollectiveMismatchError as e:
        sigs, _ = extract_collective_schedule(program, scope=scope)
        return {"ok": False, "kind": e.kind, "error": str(e)[:2000],
                "n_collectives": len(sigs),
                "digest": schedule_digest(sigs)}
    return {"ok": True, "n_collectives": len(sigs),
            "digest": schedule_digest(sigs)}
