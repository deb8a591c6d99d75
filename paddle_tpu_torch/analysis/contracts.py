"""Rewrite contracts: the pre- and post-conditions of the port's program
rewrites, checked around each pass.

Counterpart of ``paddle_tpu/analysis/contracts.py`` (``checked_rewrite:74``,
``check_pipeline_split:663``). A pass declares a ``RewriteContract``
(``pre(program) -> state`` before the rewrite, ``post(program, state)``
after, raising ``ContractViolation``), registered under the pass's name,
and the pass is wrapped with ``@checked_rewrite(name)``. With
``PADDLE_TPU_VERIFY_IR`` unset the wrapper costs one dict probe and a
branch; set, the contract runs and the whole program is verified after
the rewrite (once a program version).

The contracts of the rewrites the port performs:

- ``insert_allreduce``: every grad an optimizer op reads (but the
  declared shard-skips) is reduced exactly once, before that op;
- ``bucket_allreduce``: bucketing keeps the multiset of reduced grads,
  and no op that read a reduced grad before reads an unreduced one after;
- ``sharded_update``: each param folded into a ``c_sharded_update``
  carries its grad at the same slot position, and each spared param
  still sees its reduced grad;
- ``fused_optimizer``: each (param, grad) pair folded away appears in
  exactly one ``fused_optimizer`` op, and a spared param keeps its op;
- ``fused_epilogue``: no written var is lost and the program never grows;
- ``bucket_quant``: attrs and residual slots only, each residual wired
  consistently;
- ``async_collective``: the async split reduces each grad exactly once (by
  its await), every start has one await after it, no op writes a member
  between the pair, and no new reader comes before a grad's reduction;
- ``reduction_swap``: attrs only, each a registered spelling (the float
  bound of a spelling is ``reassociation_bound``).

``check_pipeline_split`` checks the pipeline's stage split:
the stages tile the forward ops in order, none empty.
"""
from __future__ import annotations

import functools
from typing import Dict, List, Optional, Tuple

from .verifier import IRVerificationError

__all__ = ["ContractViolation", "RewriteContract", "register_contract",
           "contract_for", "checked_rewrite", "reduced_grad_entries",
           "check_pipeline_split", "reassociation_bound"]


class ContractViolation(IRVerificationError):
    """A rewrite pass broke its declared invariant; ``.pass_name``
    names the pass, the message names the op/var that diverged."""


class RewriteContract:
    """Subclass and register under the pass name. ``pre`` may return
    any state object; ``post`` receives it back after the rewrite."""

    name: str = ""

    def pre(self, program):
        return None

    def post(self, program, state) -> None:
        raise NotImplementedError


_CONTRACTS: Dict[str, RewriteContract] = {}


def register_contract(contract: RewriteContract) -> RewriteContract:
    if not contract.name:
        raise ValueError("contract needs a pass name")
    _CONTRACTS[contract.name] = contract
    return contract


def contract_for(name: str) -> Optional[RewriteContract]:
    return _CONTRACTS.get(name)


def checked_rewrite(name: str):
    """Decorator for rewrite passes ``fn(program, *args, **kwargs)``:
    runs the registered contract (if any) around the pass and
    re-verifies the program after it, gated on
    ``PADDLE_TPU_VERIFY_IR``. Passes without a registered contract
    still get the post-rewrite verification — the free half."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(program, *args, **kwargs):
            from . import verify_enabled

            if not verify_enabled():
                return fn(program, *args, **kwargs)
            # per-(pass, program-version) memo: the rewrite passes are
            # idempotent and re-invoked EVERY engine run — re-checking
            # an unchanged program each step would put O(ops) host work
            # on the hot path (and skew the step-profiler measurements
            # the profile-guided planner consumes). A version change
            # (any rewrite) re-arms the check.
            from ..core.compiler_engine import _program_version

            checked = getattr(program, "_analysis_checked", None)
            if checked is None:
                checked = {}
                program._analysis_checked = checked
            if checked.get(name) == _program_version(program):
                return fn(program, *args, **kwargs)
            contract = _CONTRACTS.get(name)
            state = contract.pre(program) if contract is not None \
                else None
            out = fn(program, *args, **kwargs)
            if contract is not None:
                contract.post(program, state)
            from .verifier import verify_program

            verify_program(program, pass_name=name)
            checked[name] = _program_version(program)
            from .. import observability as _obs

            _obs.inc("analysis.pass_checks", rewrite=name)
            return out

        wrapper.__wrapped_pass__ = name
        return wrapper

    return deco


# ---------------------------------------------------------------------------
# shared reduce-coverage map
# ---------------------------------------------------------------------------


def reduced_grad_entries(program) -> Dict[str, List[Tuple[int, str]]]:
    """grad name -> [(op index, reduce kind)] over every form a grad
    reduction takes after the rewrite passes: per-grad in-place
    ``c_allreduce_sum``, ``c_bucket_allreduce`` membership, the
    implicit flat psum inside ``c_sharded_update``, and the AWAIT half
    of an async start/await pair (the op that writes the reduced value
    back — the start issues the psum but binds no grad output, so
    counting it too would double-count every async grad)."""
    block = program.global_block()
    entries: Dict[str, List[Tuple[int, str]]] = {}
    for i, op in enumerate(block.ops):
        if op.type == "c_allreduce_sum":
            x, o = op.input("X"), op.output("Out")
            if len(x) == 1 and x == o:
                entries.setdefault(x[0], []).append((i, "pergrad"))
        elif op.type == "c_bucket_allreduce":
            for n in op.input("X"):
                entries.setdefault(n, []).append((i, "bucket"))
        elif op.type == "c_bucket_allreduce_await":
            for n in op.output("Out"):
                entries.setdefault(n, []).append((i, "bucket_async"))
        elif op.type == "c_sharded_update":
            for n in op.input("Grad"):
                entries.setdefault(n, []).append((i, "sharded"))
    return entries


def _first_reduce_idx(entries, g) -> Optional[int]:
    es = entries.get(g)
    return min(i for i, _ in es) if es else None


def _viol(name: str, msg: str):
    e = ContractViolation("rewrite contract %r violated: %s"
                          % (name, msg))
    e.pass_name = name
    raise e


# ---------------------------------------------------------------------------
# built-in contracts
# ---------------------------------------------------------------------------


class _InsertAllreduceContract(RewriteContract):
    name = "insert_allreduce"

    def post(self, program, state) -> None:
        from ..parallel.transpiler import OPTIMIZER_OP_TYPES

        if not getattr(program, "_grads_allreduced", False):
            return  # pass declined (not a dp rewrite target)
        entries = reduced_grad_entries(program)
        skip = set(getattr(program, "_allreduce_skip_grads", None) or ())
        block = program.global_block()
        for i, op in enumerate(block.ops):
            if op.type not in OPTIMIZER_OP_TYPES:
                continue
            for g in op.input("Grad"):
                if g in skip:
                    continue
                es = entries.get(g)
                if not es:
                    _viol(self.name,
                          "grad %r feeds optimizer op #%d (%s) but no "
                          "reduce op covers it — this rank would apply "
                          "an UNREDUCED gradient" % (g, i, op.type))
                if len(es) > 1:
                    _viol(self.name,
                          "grad %r is reduced %d times (ops %s) — the "
                          "update would see an over-scaled gradient"
                          % (g, len(es), [j for j, _ in es]))
                if es[0][0] > i:
                    _viol(self.name,
                          "grad %r is reduced by op #%d AFTER its "
                          "optimizer op #%d (%s) consumes it"
                          % (g, es[0][0], i, op.type))


class _BucketAllreduceContract(RewriteContract):
    name = "bucket_allreduce"

    def pre(self, program):
        entries = reduced_grad_entries(program)
        block = program.global_block()
        # keyed by op._id (program-unique, monotonically minted, never
        # reused) — NOT id(op): ops the pass frees could have their
        # CPython address reused by ops it inserts, silently masking a
        # violation
        pre_readers: Dict[str, frozenset] = {}
        for g, es in entries.items():
            first = min(i for i, _ in es)
            pre_readers[g] = frozenset(
                op._id for op in block.ops[:first]
                if g in op.input_arg_names)
        multiset = sorted((g, len(es)) for g, es in entries.items())
        return {"multiset": multiset, "pre_readers": pre_readers}

    def post(self, program, state) -> None:
        entries = reduced_grad_entries(program)
        multiset = sorted((g, len(es)) for g, es in entries.items())
        if multiset != state["multiset"]:
            before = dict(state["multiset"])
            after = dict(multiset)
            lost = sorted(set(before) - set(after))
            gained = sorted(set(after) - set(before))
            _viol(self.name,
                  "multiset of reduced grads changed: lost %s, gained "
                  "%s (recounted %s)"
                  % (lost, gained,
                     sorted(g for g in after
                            if g in before and after[g] != before[g])))
        block = program.global_block()
        for g, es in entries.items():
            first = min(i for i, _ in es)
            readers_now = {op._id for op in block.ops[:first]
                           if g in op.input_arg_names}
            leaked = readers_now - set(state["pre_readers"].get(
                g, frozenset()))
            if leaked:
                ops_by_id = {op._id: (i, op.type)
                             for i, op in enumerate(block.ops)}
                named = sorted(ops_by_id[x] for x in leaked)
                _viol(self.name,
                      "consumer-barrier ordering broken for grad %r: "
                      "op(s) %s now read it BEFORE its reduce at op "
                      "#%d — they would see an unreduced value"
                      % (g, named, first))


class _ShardedUpdateContract(RewriteContract):
    name = "sharded_update"

    def pre(self, program):
        from ..parallel.transpiler import OPTIMIZER_OP_TYPES

        entries = reduced_grad_entries(program)
        block = program.global_block()
        opts = []
        for op in block.ops:
            if op.type in OPTIMIZER_OP_TYPES and op.input("Param") \
                    and op.input("Grad"):
                g = op.input("Grad")[0]
                # op._id, not id(op): stable against address reuse
                opts.append((op._id, op.type, op.input("Param")[0], g,
                             g in entries))
        return {"opts": opts}

    def post(self, program, state) -> None:
        block = program.global_block()
        live_ids = {op._id for op in block.ops}
        entries = reduced_grad_entries(program)
        sharded_pairs: Dict[str, str] = {}
        for i, op in enumerate(block.ops):
            if op.type != "c_sharded_update":
                continue
            params, grads = op.input("Param"), op.input("Grad")
            if len(params) != len(grads):
                _viol(self.name,
                      "c_sharded_update op #%d binds %d params but %d "
                      "grads — slot positions must pair" %
                      (i, len(params), len(grads)))
            sharded_pairs.update(zip(params, grads))
            nranks = int(op.attrs.get("nranks", 1) or 1)
            padded = int(op.attrs.get("padded_size", 0) or 0)
            if nranks > 0 and padded % nranks:
                _viol(self.name,
                      "c_sharded_update op #%d padded_size %d is not "
                      "a multiple of nranks %d — shards would "
                      "misalign" % (i, padded, nranks))
        for opid, op_type, p, g, had_reduce in state["opts"]:
            if opid in live_ids:
                # spared param: its per-param path must be intact
                if had_reduce and g not in entries:
                    _viol(self.name,
                          "spared param %r (%s) no longer sees its "
                          "reduced grad %r — the pass removed the "
                          "allreduce but kept the per-param update"
                          % (p, op_type, g))
            else:
                if sharded_pairs.get(p) != g:
                    _viol(self.name,
                          "optimizer op for param %r was removed but "
                          "no c_sharded_update carries (%r, %r) — the "
                          "param would never be updated"
                          % (p, p, g))


class _FusedOptimizerContract(RewriteContract):
    """``core/fusion.apply_fused_optimizer``: every (param, grad) pair
    the pass folds away must reappear in a ``fused_optimizer`` op at
    matching slot positions — exactly once — and spared params keep
    their per-param update op untouched."""

    name = "fused_optimizer"

    def pre(self, program):
        from ..core.fusion import FUSED_OPTIMIZER_TYPES

        block = program.global_block()
        opts = []
        for op in block.ops:
            if op.type in FUSED_OPTIMIZER_TYPES and op.input("Param") \
                    and op.input("Grad"):
                opts.append((op._id, op.type, op.input("Param")[0],
                             op.input("Grad")[0]))
        return {"opts": opts}

    def post(self, program, state) -> None:
        block = program.global_block()
        live_ids = {op._id for op in block.ops}
        fused_pairs: Dict[str, str] = {}
        seen_params: List[str] = []
        for i, op in enumerate(block.ops):
            if op.type != "fused_optimizer":
                continue
            params, grads = op.input("Param"), op.input("Grad")
            if len(params) != len(grads):
                _viol(self.name,
                      "fused_optimizer op #%d binds %d params but %d "
                      "grads — slot positions must pair"
                      % (i, len(params), len(grads)))
            if len(params) != len(op.output("ParamOut")):
                _viol(self.name,
                      "fused_optimizer op #%d updates %d params but "
                      "rebinds %d ParamOut slots" %
                      (i, len(params), len(op.output("ParamOut"))))
            fused_pairs.update(zip(params, grads))
            seen_params.extend(params)
        dupes = {p for p in seen_params if seen_params.count(p) > 1}
        if dupes:
            _viol(self.name,
                  "param(s) %s folded into more than one "
                  "fused_optimizer op — double update"
                  % sorted(dupes))
        for opid, op_type, p, g in state["opts"]:
            if opid in live_ids:
                if p in fused_pairs:
                    _viol(self.name,
                          "param %r keeps its per-param %s op AND is "
                          "folded into a fused_optimizer op — double "
                          "update" % (p, op_type))
            elif fused_pairs.get(p) != g:
                _viol(self.name,
                      "optimizer op for param %r was removed but no "
                      "fused_optimizer carries (%r, %r) — the param "
                      "would never be updated" % (p, p, g))


class _FusedEpilogueContract(RewriteContract):
    """``core/fusion.apply_fused_epilogues``: the pass may merge ops
    but must not LOSE a value — the set of written var names is
    preserved (pre-built grad ops keep reading the intermediates) and
    the op count never grows. Ordering/def-before-use is re-proven by
    the post-rewrite ``verify_program`` run."""

    name = "fused_epilogue"

    def pre(self, program):
        block = program.global_block()
        writes = sorted({n for op in block.ops
                         for n in op.output_arg_names if n})
        return {"writes": writes, "n_ops": len(block.ops)}

    def post(self, program, state) -> None:
        block = program.global_block()
        writes = sorted({n for op in block.ops
                         for n in op.output_arg_names if n})
        lost = sorted(set(state["writes"]) - set(writes))
        if lost:
            _viol(self.name,
                  "fused epilogue dropped written var(s) %s — a "
                  "reader (e.g. a pre-built grad op) would see a "
                  "stale or missing value" % lost[:5])
        if len(block.ops) > state["n_ops"]:
            _viol(self.name,
                  "epilogue fusion GREW the program (%d -> %d ops)"
                  % (state["n_ops"], len(block.ops)))


class _AsyncCollectiveContract(RewriteContract):
    """parallel/scheduling.py schedule_async_collectives: every grad a
    fused bucket reduced must still be reduced exactly once (now by the
    await half), every start/await pair must be properly bracketed
    (start before await, Pending written once and consumed by exactly
    one await), and no NEW reader may slip in front of a grad's
    reduction — the consumer barrier survives the split."""

    name = "async_collective"

    def pre(self, program):
        entries = reduced_grad_entries(program)
        block = program.global_block()
        pre_readers: Dict[str, frozenset] = {}
        for g, es in entries.items():
            first = min(i for i, _ in es)
            pre_readers[g] = frozenset(
                op._id for op in block.ops[:first]
                if g in op.input_arg_names)
        multiset = sorted((g, len(es)) for g, es in entries.items())
        return {"multiset": multiset, "pre_readers": pre_readers}

    def post(self, program, state) -> None:
        entries = reduced_grad_entries(program)
        multiset = sorted((g, len(es)) for g, es in entries.items())
        if multiset != state["multiset"]:
            before = dict(state["multiset"])
            after = dict(multiset)
            _viol(self.name,
                  "multiset of reduced grads changed: lost %s, gained "
                  "%s — an async split must re-cover every grad via "
                  "its await"
                  % (sorted(set(before) - set(after)),
                     sorted(set(after) - set(before))))
        block = program.global_block()
        starts: Dict[str, int] = {}   # pending name -> start index
        start_ids = set()
        awaited: Dict[str, int] = {}  # pending name -> await count
        for i, op in enumerate(block.ops):
            if op.type == "c_bucket_allreduce_start":
                start_ids.add(op._id)
                p = op.output("Pending")
                if len(p) != 1:
                    _viol(self.name,
                          "start op #%d binds %d Pending outputs (want "
                          "exactly 1)" % (i, len(p)))
                if p[0] in starts:
                    _viol(self.name,
                          "Pending var %r written by two start ops "
                          "(#%d and #%d)" % (p[0], starts[p[0]], i))
                starts[p[0]] = i
            elif op.type == "c_bucket_allreduce_await":
                pending = op.input("Pending")
                if not pending:
                    _viol(self.name,
                          "await op #%d binds no Pending input — "
                          "nothing to slice the reduced values from"
                          % i)
                p = pending[0]
                si = starts.get(p)
                if si is None:
                    _viol(self.name,
                          "await op #%d consumes Pending %r with no "
                          "earlier start op — the slice would read "
                          "garbage (use-before-start)" % (i, p))
                if sorted(op.input("X")) != sorted(op.output("Out")):
                    _viol(self.name,
                          "await op #%d rebinds outputs %s != members "
                          "%s — some member grad would keep its "
                          "UNREDUCED value"
                          % (i, sorted(op.output("Out")),
                             sorted(op.input("X"))))
                if si is not None:
                    members = set(op.input("X"))
                    for j in range(si + 1, i):
                        mid = block.ops[j]
                        if mid.type == "c_bucket_allreduce_await":
                            continue
                        hit = members & set(mid.output_arg_names)
                        if hit:
                            _viol(self.name,
                                  "op #%d (%s) WRITES member grad(s) "
                                  "%s between the start (#%d) and its "
                                  "await (#%d) — the await would "
                                  "clobber that write with a "
                                  "reduction of the stale value"
                                  % (j, mid.type, sorted(hit), si, i))
                awaited[p] = awaited.get(p, 0) + 1
        orphans = sorted(set(starts) - set(awaited))
        if orphans:
            _viol(self.name,
                  "start op(s) for Pending %s have no await — their "
                  "member grads are never written back (the optimizer "
                  "would apply UNREDUCED gradients)" % orphans)
        multi = sorted(p for p, n in awaited.items() if n > 1)
        if multi:
            _viol(self.name,
                  "Pending %s consumed by multiple awaits" % multi)
        # consumer barrier: new readers ahead of a grad's reduction may
        # only be the start ops the split itself inserted
        for g, es in entries.items():
            first = min(i for i, _ in es)
            readers_now = {op._id for op in block.ops[:first]
                           if g in op.input_arg_names}
            leaked = readers_now \
                - set(state["pre_readers"].get(g, frozenset())) \
                - start_ids
            if leaked:
                ops_by_id = {op._id: (i, op.type)
                             for i, op in enumerate(block.ops)}
                _viol(self.name,
                      "consumer-barrier ordering broken for grad %r: "
                      "op(s) %s now read it BEFORE its reduction at op "
                      "#%d — they would see an unreduced value"
                      % (g, sorted(ops_by_id[x] for x in leaked),
                         first))


class _ReductionSwapContract(RewriteContract):
    """parallel/scheduling.py swap_reduction_strategy: attr-only — the
    op sequence (identities, types, slot bindings) must be untouched
    and every strategy attr must name a registered spelling. Numerically
    a spelling is the ring's sum in another association: integer payloads
    (int8 codes) exactly, float ones within ``reassociation_bound`` of
    it (``tree`` gives the ring's bits)."""

    name = "reduction_swap"

    def pre(self, program):
        block = program.global_block()
        seq = [(op._id, op.type,
                tuple(sorted((k, tuple(v)) for k, v in op.inputs.items())),
                tuple(sorted((k, tuple(v)) for k, v in
                             op.outputs.items())))
               for op in block.ops]
        return {"seq": seq}

    def post(self, program, state) -> None:
        from ..ops.collective_ops import REDUCTION_STRATEGIES

        block = program.global_block()
        seq = [(op._id, op.type,
                tuple(sorted((k, tuple(v)) for k, v in op.inputs.items())),
                tuple(sorted((k, tuple(v)) for k, v in
                             op.outputs.items())))
               for op in block.ops]
        if seq != state["seq"]:
            _viol(self.name,
                  "reduction swap changed the op sequence/bindings — "
                  "the pass may only flip strategy attrs (op count %d "
                  "-> %d)" % (len(state["seq"]), len(seq)))
        for i, op in enumerate(block.ops):
            if op.type not in ("c_bucket_allreduce",
                               "c_bucket_allreduce_start"):
                continue
            s = op.attrs.get("strategy", "ring")
            if s not in REDUCTION_STRATEGIES:
                _viol(self.name,
                      "op #%d (%s) carries unknown reduction strategy "
                      "%r — the op would raise at its first run "
                      "(want one of %s)"
                      % (i, op.type, s,
                         ", ".join(REDUCTION_STRATEGIES)))


class _BucketQuantContract(RewriteContract):
    """``parallel/scheduling.configure_bucket_quant``: attr/slot-only —
    the op sequence is untouched, quant values are registered modes,
    and every error-feedback Residual is wired CONSISTENTLY (ResidualOut
    rebinds the same var, the var is declared, and its size is a whole
    multiple of the bucket payload — one shard per replica)."""

    name = "bucket_quant"

    def pre(self, program):
        block = program.global_block()
        return {"op_ids": [(op._id, op.type) for op in block.ops]}

    def post(self, program, state) -> None:
        from ..ops.collective_ops import QUANT_WIRE_ITEMSIZE

        block = program.global_block()
        if [(op._id, op.type) for op in block.ops] != state["op_ids"]:
            _viol(self.name,
                  "bucket-quant reconfiguration changed the op "
                  "sequence — it may only flip attrs and wire "
                  "residual slots")
        for i, op in enumerate(block.ops):
            if op.type not in ("c_bucket_allreduce",
                               "c_bucket_allreduce_start"):
                continue
            quant = op.attrs.get("quant", "none")
            if quant not in QUANT_WIRE_ITEMSIZE:
                _viol(self.name,
                      "op #%d carries unknown quant mode %r" % (i, quant))
            res_in = op.input("Residual")
            res_out = op.output("ResidualOut")
            if bool(res_in) != bool(res_out):
                _viol(self.name,
                      "op #%d binds Residual %s but ResidualOut %s — "
                      "the error-feedback state would be read or "
                      "written only half the time (residual silently "
                      "frozen or lost)" % (i, res_in or "(unbound)",
                                           res_out or "(unbound)"))
            if not res_in:
                continue
            if res_in != res_out:
                _viol(self.name,
                      "op #%d reads residual %r but writes %r — the "
                      "next step would fold in a STALE rounding error"
                      % (i, res_in[0], res_out[0]))
            if quant == "none":
                _viol(self.name,
                      "op #%d wires an error-feedback residual but is "
                      "not quantized — the residual would never decay"
                      % i)
            rv = block._find_var_recursive(res_in[0])
            if rv is None:
                _viol(self.name,
                      "op #%d residual var %r is not declared"
                      % (i, res_in[0]))
            import numpy as _np

            total = 0
            known = True
            for n in op.input("X"):
                v = block._find_var_recursive(n)
                shp = getattr(v, "shape", None) if v is not None else None
                if not shp or not all(isinstance(s, int) and s > 0
                                      for s in shp):
                    known = False
                    break
                total += int(_np.prod(shp))
            rshape = getattr(rv, "shape", None)
            if known and rshape and total and \
                    int(_np.prod(rshape)) % total:
                _viol(self.name,
                      "op #%d residual var %r holds %d elements, not a "
                      "whole multiple of the %d-element bucket payload "
                      "— per-replica shards would misalign"
                      % (i, res_in[0], int(_np.prod(rshape)), total))


register_contract(_InsertAllreduceContract())
register_contract(_BucketAllreduceContract())
register_contract(_ShardedUpdateContract())
register_contract(_FusedOptimizerContract())
register_contract(_FusedEpilogueContract())
register_contract(_BucketQuantContract())
register_contract(_AsyncCollectiveContract())
register_contract(_ReductionSwapContract())


def reassociation_bound(abs_sum, nranks: int, eps: float):
    """How far two spellings of one float sum of ``nranks`` terms may lie
    apart, elementwise: each is within ``(n - 1) * eps * sum_i |x_i|`` of
    the exact sum, so the two within twice that. ``abs_sum`` is
    ``sum_i |x_i|``, ``eps`` the dtype's machine epsilon."""
    return 2.0 * max(0, int(nranks) - 1) * float(eps) * abs_sum


# ---------------------------------------------------------------------------
# pipeline stage split (returns stages instead of mutating the program)
# ---------------------------------------------------------------------------


def check_pipeline_split(program, stages, n_fwd_ops: int) -> None:
    """The stage partition must tile ops[0:n_fwd_ops] exactly and in
    order — a dropped/duplicated/reordered op means some stage computes
    with another stage's intermediate state."""
    block = program.global_block()
    want = block.ops[:n_fwd_ops]
    flat = [op for s in stages for op in s]
    for si, s in enumerate(stages):
        if not s:
            _viol("pipeline_split", "stage %d is empty" % si)
    if len(flat) != len(want):
        _viol("pipeline_split",
              "stages cover %d ops but the forward range has %d"
              % (len(flat), len(want)))
    for k, (a, b) in enumerate(zip(flat, want)):
        if a is not b:
            _viol("pipeline_split",
                  "stage op #%d is %s but program forward op #%d is %s "
                  "— partition is not an in-order tiling"
                  % (k, a.type, k, b.type))
