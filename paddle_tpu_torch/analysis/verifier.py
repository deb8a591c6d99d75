"""Well-formedness verification of the Program IR.

Counterpart of ``paddle_tpu/analysis/verifier.py`` (``verify_program:103``,
``Finding``, ``IRVerificationError``, ``verify_lazy_graph:505``), with its
invariants and words. ``verify_program`` walks every block and reports
structured findings:

===================  ====================================================
``dangling-input``   op reads a var name no block in scope declares
``dangling-output``  kernel op writes a var name no block declares
``use-before-def``   op reads a temp var before any op has written it
``unknown-op``       op type absent from the op registry
``unknown-slot``     op binds an input/output slot its OpInfo lacks
``missing-slot``     a non-dispensable slot is unbound
``slot-arity``       >1 name bound to a non-duplicable slot
``attr-type``        attr value's type contradicts the registered default
``invalid-dtype``    var dtype is not a known framework dtype
``alias-write``      ONE op writes the same var through two outputs
``overwritten-write``var written twice with no read in between
``unreachable-op``   op feeds neither a fetch, a persistable, nor a
                     side effect (needs ``fetch_names``)
``dead-var``         block var no op touches (needs ``fetch_names``)
``orphan-block``     a block no op runs (its ops are not verified)
``shape-mismatch``   declared out shape contradicts re-inferred shape
                     (``recheck_shapes=True`` only)
``dtype-mismatch``   declared out dtype contradicts re-inferred dtype
===================  ====================================================

Structural violations are ``error`` (raised as ``IRVerificationError``
unless ``raise_on_error=False``); ``unreachable-op``, ``dead-var``,
``overwritten-write``, ``never-written-input`` and ``orphan-block`` are
``warning``. Two departures from the JAX verifier, each a false positive
there: a loop body's reads of the carries its enclosing blocks write are
no use before a definition, and a block no op runs is not verified (an
inference save's prune can drop the ``while`` that ran it).
``recheck_shapes`` runs each op's own function on ``meta`` tensors of its
inputs' declared shapes and types (where the JAX package calls
``jax.eval_shape``), as the port's append-time inference does.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Set, Tuple

from ..core.enforce import EnforceNotMet

__all__ = ["Finding", "IRVerificationError", "verify_program",
           "verify_lazy_graph"]

# severities
ERROR = "error"
WARNING = "warning"

# attr keys injected by executors/passes — never type-checked
_PRIVATE_ATTR_PREFIX = "_"


class Finding:
    """One violated invariant, locatable: (invariant, block, op)."""

    __slots__ = ("invariant", "severity", "block_idx", "op_index",
                 "op_type", "detail")

    def __init__(self, invariant: str, severity: str, block_idx: int,
                 op_index: Optional[int], op_type: Optional[str],
                 detail: str):
        self.invariant = invariant
        self.severity = severity
        self.block_idx = block_idx
        self.op_index = op_index
        self.op_type = op_type
        self.detail = detail

    def where(self) -> str:
        if self.op_index is None:
            return "block %d" % self.block_idx
        return "block %d op #%d (%s)" % (self.block_idx, self.op_index,
                                         self.op_type)

    def __str__(self):
        return "[%s/%s] %s: %s" % (self.severity, self.invariant,
                                   self.where(), self.detail)

    __repr__ = __str__


class IRVerificationError(EnforceNotMet):
    """Error-severity verification findings, with the full structured
    list on ``.findings`` and the triggering rewrite on
    ``.pass_name``."""

    def __init__(self, message: str, findings: Sequence[Finding] = (),
                 pass_name: Optional[str] = None):
        self.findings = list(findings)
        self.pass_name = pass_name
        super().__init__(message)


def _raise(findings: List[Finding], pass_name: Optional[str]):
    errors = [f for f in findings if f.severity == ERROR]
    if not errors:
        return
    head = "IR verification failed%s: %d invariant violation(s)" % (
        " after pass %r" % pass_name if pass_name else "", len(errors))
    body = "\n  ".join(str(f) for f in errors[:20])
    if len(errors) > 20:
        body += "\n  ... and %d more" % (len(errors) - 20)
    raise IRVerificationError("%s\n  %s" % (head, body), findings,
                              pass_name)


def verify_program(program, fetch_names: Optional[Sequence[str]] = None,
                   pass_name: Optional[str] = None,
                   recheck_shapes: bool = False,
                   raise_on_error: bool = True) -> List[Finding]:
    """Verify every block of ``program``; returns ALL findings and (by
    default) raises ``IRVerificationError`` when any is error-severity.
    ``fetch_names`` enables liveness analysis (unreachable ops / dead
    vars); ``recheck_shapes`` re-infers each op's output metadata
    through the registry's shape path and compares against the declared
    vars (expensive — mutation gate / tests, not the per-program
    hook)."""
    findings: List[Finding] = []
    # program-wide writer set: sub-blocks read vars their PARENT block
    # writes, and scope state is legitimately fed from outside — a var
    # nobody in the whole program writes and that has no external
    # source is the suspicious case
    written_anywhere: Set[str] = set()
    for block in program.blocks:
        for op in block.ops:
            written_anywhere.update(n for n in op.output_arg_names if n)
    reachable = _reachable_blocks(program)
    for block in program.blocks:
        if block.idx not in reachable:
            # no op runs it (a prune dropped its while): its ops never run
            findings.append(Finding(
                "orphan-block", WARNING, block.idx, None, None,
                "no op of the program runs block %d" % block.idx))
            continue
        _verify_block(block, findings, written_anywhere,
                      recheck_shapes=recheck_shapes,
                      outer_written=_ancestor_writes(program, block))
    if fetch_names:
        _verify_liveness(program, set(fetch_names), findings)
    if raise_on_error:
        _raise(findings, pass_name)
    return findings


# ---------------------------------------------------------------------------
# per-block structural checks
# ---------------------------------------------------------------------------


def _registry():
    from ..core.registry import OpInfoMap

    return OpInfoMap.instance()


def _external(v) -> bool:
    """Vars whose value legitimately pre-exists the block's first op:
    params / persistables (scope state), data vars (feeds)."""
    return bool(getattr(v, "persistable", False)
                or getattr(v, "is_data", False))


def _sub_block(op):
    sb = op.attrs.get("sub_block")
    return sb if op.type in ("while", "conditional_block") else None


def _op_reads_writes(op) -> Tuple[List[str], List[str]]:
    """(reads, writes) including control-flow sub-block effects."""
    reads = [n for n in op.input_arg_names if n]
    writes = [n for n in op.output_arg_names if n]
    sb = _sub_block(op)
    if sb is not None:
        from ..framework import block_rw

        sw, sr = block_rw(sb)
        reads += [n for n in sr if n]
        writes += [n for n in sw if n]
    return reads, writes


def _reachable_blocks(program) -> Set[int]:
    """The global block and every block a reachable op's ``sub_block``
    names, recursively."""
    seen = {0}
    todo = [program.global_block()]
    while todo:
        for op in todo.pop().ops:
            sb = op.attrs.get("sub_block")
            idx = getattr(sb, "idx", None)
            if idx is not None and idx not in seen:
                seen.add(idx)
                todo.append(sb)
    return seen


def _ancestor_writes(program, block) -> Set[str]:
    """Vars the blocks around ``block`` write: a loop body reads its
    carries (written before the loop, rewritten at the end of each trip)
    before it writes them, which is no use before a definition. The JAX
    verifier flags those (a false positive on every ``while`` body that
    carries a value); the port does not copy it."""
    out: Set[str] = set()
    idx = getattr(block, "parent_idx", -1)
    while idx is not None and idx >= 0:
        outer = program.blocks[idx]
        for op in outer.ops:
            out.update(n for n in op.output_arg_names if n)
        idx = getattr(outer, "parent_idx", -1)
    return out


def _verify_block(block, findings: List[Finding],
                  written_anywhere: Set[str], recheck_shapes=False,
                  outer_written: Set[str] = frozenset()):
    bi = block.idx
    infos = _registry()
    first_write: Dict[str, int] = {}
    for i, op in enumerate(block.ops):
        _, writes = _op_reads_writes(op)
        for n in writes:
            first_write.setdefault(n, i)

    last_write_at: Dict[str, int] = {}
    read_since_write: Dict[str, bool] = {}
    for i, op in enumerate(block.ops):
        reads, writes = _op_reads_writes(op)

        # -- resolution + def-before-use --------------------------------
        for n in reads:
            v = block._find_var_recursive(n)
            if v is None:
                findings.append(Finding(
                    "dangling-input", ERROR, bi, i, op.type,
                    "input var %r is not declared in block %d or any "
                    "ancestor" % (n, bi)))
                continue
            fw = first_write.get(n)
            if fw is None and not _external(v) \
                    and n not in written_anywhere:
                # declared but written by NOBODY in the whole program,
                # and no external source — a rewrite that repointed an
                # input at a garbage temp looks exactly like this.
                # Warning (not error): runtime scope state MAY be fed
                # from outside without the persistable bit.
                findings.append(Finding(
                    "never-written-input", WARNING, bi, i, op.type,
                    "reads %r, which no op in any block writes and "
                    "which has no external source (not persistable, "
                    "not a data var)" % n))
            if fw is not None and not _external(v) \
                    and n not in outer_written:
                if fw > i:
                    findings.append(Finding(
                        "use-before-def", ERROR, bi, i, op.type,
                        "reads %r, first written later by op #%d (%s)"
                        % (n, fw, block.ops[fw].type)))
                elif fw == i and n in writes and n not in last_write_at:
                    # in-place op is this var's FIRST writer and the
                    # var has no external source — reading garbage
                    findings.append(Finding(
                        "use-before-def", ERROR, bi, i, op.type,
                        "in-place op reads %r but is also its first "
                        "writer and the var has no external source"
                        % n))

        info = infos.get(op.type) if infos.has(op.type) else None
        for n in writes:
            v = block._find_var_recursive(n)
            if v is None:
                # host side-effect ops (barrier/comm-init) legitimately
                # name scope-only vars; kernel ops must declare outputs
                sev = ERROR if (info is not None
                                and info.fn is not None) else WARNING
                findings.append(Finding(
                    "dangling-output", sev, bi, i, op.type,
                    "output var %r is not declared in block %d or any "
                    "ancestor" % (n, bi)))

        # -- duplicate-write hazards ------------------------------------
        seen_out: Set[str] = set()
        for slot, names in op.outputs.items():
            for n in names:
                if not n:
                    continue
                if n in seen_out:
                    findings.append(Finding(
                        "alias-write", ERROR, bi, i, op.type,
                        "writes var %r through two output bindings — "
                        "the op's results alias unpredictably" % n))
                seen_out.add(n)
        for n in writes:
            prev = last_write_at.get(n)
            if (prev is not None and not read_since_write.get(n, False)
                    and n not in reads):
                findings.append(Finding(
                    "overwritten-write", WARNING, bi, i, op.type,
                    "overwrites %r written by op #%d (%s) with no "
                    "intervening read — the earlier write is dead"
                    % (n, prev, block.ops[prev].type)))
        for n in reads:
            read_since_write[n] = True
        for n in writes:
            last_write_at[n] = i
            read_since_write[n] = False

        # -- registry consistency ---------------------------------------
        if info is None:
            findings.append(Finding(
                "unknown-op", ERROR, bi, i, op.type,
                "op type %r is not in the op registry" % op.type))
            continue
        _verify_slots(block, op, info, findings, i)
        _verify_attr_types(op, info, findings, bi, i)
        _verify_var_dtypes(block, op, findings, bi, i)
        if recheck_shapes:
            findings.extend(_recheck_op_shapes(block, op, info, i))


def _verify_slots(block, op, info, findings: List[Finding], i: int):
    bi = block.idx
    for kind, bound, slots in (("input", op.inputs, info.inputs),
                               ("output", op.outputs, info.outputs)):
        declared = {s.name: s for s in slots}
        for name, args in bound.items():
            s = declared.get(name)
            if s is None:
                findings.append(Finding(
                    "unknown-slot", ERROR, bi, i, op.type,
                    "%s slot %r is not declared by the %r registry "
                    "entry (declared: %s)"
                    % (kind, name, op.type, sorted(declared))))
                continue
            if not s.duplicable and len(args) > 1:
                findings.append(Finding(
                    "slot-arity", ERROR, bi, i, op.type,
                    "%s slot %r is not duplicable but binds %d vars %r"
                    % (kind, name, len(args), args)))
        for name, s in declared.items():
            if not s.dispensable and not bound.get(name):
                findings.append(Finding(
                    "missing-slot", ERROR, bi, i, op.type,
                    "required %s slot %r is unbound" % (kind, name)))


def _verify_attr_types(op, info, findings: List[Finding], bi: int, i: int):
    for k, default in info.attrs.items():
        if k.startswith(_PRIVATE_ATTR_PREFIX) or default is None:
            continue
        if k not in op.attrs or op.attrs[k] is None:
            continue  # registry default applies
        v = op.attrs[k]
        ok = True
        if isinstance(default, bool):
            ok = isinstance(v, (bool, int)) and not isinstance(v, float)
        elif isinstance(default, (int, float)):
            ok = isinstance(v, (int, float)) and not isinstance(v, str)
        elif isinstance(default, str):
            ok = isinstance(v, str)
        elif isinstance(default, (list, tuple)):
            ok = not isinstance(v, (str, bytes, bool)) \
                and hasattr(v, "__iter__")
        if not ok:
            findings.append(Finding(
                "attr-type", ERROR, bi, i, op.type,
                "attr %r = %r (%s) contradicts the registered default "
                "%r (%s)" % (k, v, type(v).__name__, default,
                             type(default).__name__)))


def _verify_var_dtypes(block, op, findings: List[Finding], bi: int, i: int):
    from ..core import dtypes as _dt

    for n in set(op.input_arg_names) | set(op.output_arg_names):
        if not n:
            continue
        v = block._find_var_recursive(n)
        if v is None or v.dtype is None:
            continue
        try:
            _dt.to_torch_dtype(v.dtype)
        except Exception:
            findings.append(Finding(
                "invalid-dtype", ERROR, bi, i, op.type,
                "var %r declares dtype %r, not a known framework dtype"
                % (n, v.dtype)))


# ---------------------------------------------------------------------------
# liveness (needs the fetch set — runtime information)
# ---------------------------------------------------------------------------


def _verify_liveness(program, fetch: Set[str], findings: List[Finding]):
    """Backward reachability from the sinks: fetched vars, persistable
    writes, side-effect ops. An op reaching no sink is unreachable (its
    work is discarded); a var no op touches is dead weight."""
    infos = _registry()
    block = program.global_block()
    ops = block.ops
    n = len(ops)
    reads_w: List[Tuple[List[str], List[str]]] = [
        _op_reads_writes(op) for op in ops]

    live_vars: Set[str] = set(fetch)
    alive = [False] * n
    for i in range(n - 1, -1, -1):
        op = ops[i]
        reads, writes = reads_w[i]
        info = infos.get(op.type) if infos.has(op.type) else None
        sink = info is not None and info.side_effect
        if not sink:
            for w in writes:
                if w in live_vars:
                    sink = True
                    break
                v = block._find_var_recursive(w)
                if v is not None and getattr(v, "persistable", False):
                    sink = True
                    break
        if sink:
            alive[i] = True
            # note: writes stay live (no kill) — in-place chains make
            # earlier writers of the same name genuine producers, so
            # liveness here is deliberately conservative
            live_vars.update(reads)
    for i, op in enumerate(ops):
        if not alive[i]:
            findings.append(Finding(
                "unreachable-op", WARNING, block.idx, i, op.type,
                "no path from this op to a fetch (%s), a persistable "
                "write, or a side effect — its results are discarded"
                % (sorted(fetch) or "none")))

    touched: Set[str] = set()
    for reads, writes in reads_w:
        touched.update(reads)
        touched.update(writes)
    for name, v in block.vars.items():
        if name in touched or name in fetch or _external(v):
            continue
        findings.append(Finding(
            "dead-var", WARNING, block.idx, None, None,
            "var %r is declared but no op reads or writes it" % name))


# ---------------------------------------------------------------------------
# shape/dtype re-inference (the expensive teeth; opt-in)
# ---------------------------------------------------------------------------


def _recheck_op_shapes(block, op, info, i: int) -> List[Finding]:
    """Re-run the op's function on ``meta`` tensors of its inputs'
    DECLARED metadata and diff the result against the outputs' declared
    shape/dtype: catches metadata corrupted after append-time inference
    (a rewrite flipping a dtype, a mutated shape)."""
    import torch

    from .. import framework as _fw
    from ..core import dtypes as _dt
    from ..core.registry import BOUND_OUTPUTS_ATTR, DEVICE_ATTR

    bi = block.idx
    if info.fn is None or info.needs_lod:
        return []  # a host op, or runtime (LoD) output metadata
    ins = {}
    for slot in info.inputs:
        names = op.input(slot.name)
        if not names:
            ins[slot.name] = None
            continue
        metas = []
        for n in names:
            v = block._find_var_recursive(n)
            if v is None or v.shape is None or v.dtype is None:
                return []  # resolution problems are reported elsewhere
            shape = tuple(_fw._SENTINEL if d < 0 else d for d in v.shape)
            try:
                metas.append(torch.empty(shape,
                                         dtype=_dt.to_torch_dtype(v.dtype),
                                         device="meta"))
            except Exception:
                return []  # invalid-dtype already reported
        ins[slot.name] = metas if slot.duplicable else metas[0]

    attrs = dict(info.attrs)
    attrs.update(op.attrs)
    attrs[BOUND_OUTPUTS_ATTR] = tuple(
        s.name for s in info.outputs if op.output(s.name))
    attrs[DEVICE_ATTR] = torch.device("meta")
    try:
        out_meta = info.fn(ins, attrs)
    except Exception as e:
        return [Finding(
            "op-infer", ERROR, bi, i, op.type,
            "shape/dtype inference fails on the declared input "
            "metadata: %s" % e)]

    found: List[Finding] = []
    for slot in info.outputs:
        names = op.output(slot.name)
        if not names:
            continue
        m = out_meta.get(slot.name)
        if m is None:
            continue
        metas = m if isinstance(m, (list, tuple)) else [m]
        for n, mm in zip(names, metas):
            v = block._find_var_recursive(n)
            if v is None or mm is None:
                continue
            want_shape = tuple(-1 if d == _fw._SENTINEL else int(d)
                               for d in mm.shape)
            want_dtype = _dt.convert_dtype(mm.dtype)
            if v.dtype is not None and v.dtype != want_dtype:
                found.append(Finding(
                    "dtype-mismatch", ERROR, bi, i, op.type,
                    "output %r declares dtype %s but the registered "
                    "kernel produces %s" % (n, v.dtype, want_dtype)))
            if v.shape is not None and len(v.shape) == len(want_shape):
                for d, (a, b) in enumerate(zip(v.shape, want_shape)):
                    if a != b and a != -1 and b != -1:
                        found.append(Finding(
                            "shape-mismatch", ERROR, bi, i, op.type,
                            "output %r declares shape %s but the "
                            "registered kernel produces %s (dim %d)"
                            % (n, tuple(v.shape), want_shape, d)))
                        break
            elif v.shape is not None:
                found.append(Finding(
                    "shape-mismatch", ERROR, bi, i, op.type,
                    "output %r declares rank-%d shape %s but the "
                    "registered kernel produces rank-%d %s"
                    % (n, len(v.shape), tuple(v.shape),
                       len(want_shape), want_shape)))
    return found


# ---------------------------------------------------------------------------
# lazy-dygraph flush graph (the fifth rewritten "program")
# ---------------------------------------------------------------------------


def verify_lazy_graph(wiring, outs_per_node: Sequence[int], n_ext: int,
                      needed) -> None:
    """Structural check of a lazy-engine flush graph before it runs or is
    captured: every wire must reference a real external slot or an
    EARLIER node's real output, and every needed position must exist —
    a mis-wired replay would silently read the wrong tensor."""
    for ni, wires in enumerate(wiring):
        for w in wires:
            if w[0] == "e":
                if not (0 <= w[1] < n_ext):
                    raise IRVerificationError(
                        "lazy flush graph: node %d wires external slot "
                        "%d, only %d exist" % (ni, w[1], n_ext))
            else:
                src, oj = w[1], w[2]
                if not (0 <= src < ni):
                    raise IRVerificationError(
                        "lazy flush graph: node %d wires node %d — not "
                        "an earlier node (use-before-def in the replay)"
                        % (ni, src))
                if not (0 <= oj < outs_per_node[src]):
                    raise IRVerificationError(
                        "lazy flush graph: node %d wires output %d of "
                        "node %d, which has %d outputs"
                        % (ni, oj, src, outs_per_node[src]))
    n = len(outs_per_node)
    for (ni, oj) in needed:
        if not (0 <= ni < n and 0 <= oj < outs_per_node[ni]):
            raise IRVerificationError(
                "lazy flush graph: needed output (%d, %d) does not "
                "exist (%d nodes)" % (ni, oj, n))
