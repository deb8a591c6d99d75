"""AST-based dygraph_to_static conversion.

Counterpart of ``paddle_tpu/dygraph/ast_transform.py``, whose conversion
this module keeps whole: it is pure Python ``ast`` plus calls into the
port's ``layers``. The JAX package follows the reference's
dygraph_to_static transformers (program_translator.py:229,
ifelse_transformer.py, loop_transformer.py, logical_transformer.py): the
Python AST of a ``@declarative`` function is rewritten so that
tensor-dependent ``if``/``while``/``for`` become ops in the built Program
instead of being specialized away at trace time.

The rewritten statements dispatch at run time on the condition's type:

- a Python value keeps exact Python semantics (the transform is a no-op
  for shape-static code paths), while
- a static-graph ``Variable`` builds graph control flow: ``if`` lowers to
  a both-branches select (``where``, as ``layers.cond``) and ``while`` /
  ``for range`` lower to the ``while`` op, whose sub-block the
  whole-program route runs as one captured CUDA graph ``while`` node
  (``core/compiler_engine``).

So a data-dependent loop stays inside one captured program. The
transformed AST is compiled directly (the reference writes .py files).
"""
from __future__ import annotations

import ast
import inspect
import textwrap
from typing import List, Set

import numpy as np

__all__ = [
    "ast_to_static_func",
    "convert_ifelse",
    "convert_while",
    "convert_for_range",
    "convert_logical_and",
    "convert_logical_or",
    "convert_logical_not",
]


class Dy2StaticError(ValueError):
    """A conversion diagnostic: the function DID use tensor control
    flow, but in a way graph lowering cannot express. Never silently
    degraded to the trace path (which would change semantics)."""


class Undefined:
    """Placeholder for a name assigned inside a loop body but unbound
    before the loop (reference: create_undefined_var)."""

    def __init__(self, name):
        self.name = name

    def __repr__(self):
        return "Undefined(%s)" % self.name


def undefined_guard(thunk, name):
    """``x = undefined_guard(lambda: x, 'x')`` — returns x's current
    value, or an Undefined placeholder when x is unbound. The lambda's
    closure cell is unbound exactly when the name is."""
    try:
        return thunk()
    except NameError:
        return Undefined(name)


def _is_variable(x):
    from .. import framework

    return isinstance(x, framework.Variable)


def _to_bool_var(x):
    from ..layers import tensor as ltensor

    if str(getattr(x, "dtype", "bool")) != "bool":
        return ltensor.cast(x, "bool")
    return x


# ---------------------------------------------------------------------------
# Runtime converters (the ``_jst`` surface the transformed code calls)
# ---------------------------------------------------------------------------


def convert_ifelse(pred, true_fn, false_fn):
    """Reference convert_ifelse (convert_operators.py). Returns the
    tuple of values for the statement's modified names."""
    if _is_variable(pred):
        t_out = true_fn()
        f_out = false_fn()
        return _merge_branch_outputs(pred, t_out, f_out)
    # Python / eager (VarBase __bool__ is concrete under the tracer)
    return true_fn() if pred else false_fn()


def _merge_branch_outputs(pred, t_out, f_out):
    from ..layer_helper import LayerHelper

    helper = LayerHelper("jst_ifelse")
    merged = []
    for t, f in zip(t_out, f_out):
        if t is f:
            merged.append(t)
            continue
        if not (_is_variable(t) or _is_variable(f)):
            if isinstance(t, Undefined) or isinstance(f, Undefined):
                raise Dy2StaticError(
                    "dygraph_to_static: name '%s' is only assigned in one "
                    "branch of a tensor-condition `if`; assign it before "
                    "the `if` so both branches have a value"
                    % (t.name if isinstance(t, Undefined) else f.name))
            # equality merge, array-safe: bare `bool(t == f)` on numpy
            # arrays raises ambiguity — use array_equal there; any
            # other type keeps plain `==` (lists, tuples, np scalars)
            if isinstance(t, np.ndarray) or isinstance(f, np.ndarray):
                equal = (type(t) is type(f)) and np.array_equal(t, f)
            else:
                try:
                    equal = bool(t == f)
                except Exception:
                    equal = False
            if equal:
                merged.append(t)
                continue
            scalar = (bool, int, float)
            if not (isinstance(t, scalar) and isinstance(f, scalar)):
                raise Dy2StaticError(
                    "dygraph_to_static: a tensor-condition `if` assigns "
                    "non-tensor values that differ between branches "
                    "(%r vs %r); graph control flow can only carry "
                    "tensors and numeric scalars" % (t, f))
            # differing scalars (e.g. break/continue guard flags):
            # promote both and select
        t, f = _promote_scalar_pair(t, f)
        out = helper.create_variable_for_type_inference(t.dtype)
        helper.append_op("where",
                         inputs={"Condition": [pred], "X": [t], "Y": [f]},
                         outputs={"Out": [out]})
        merged.append(out)
    return tuple(merged)


def _promote_scalar(v, like=None):
    """Promote a Python scalar loop/branch value to a graph constant."""
    from ..layers import tensor as ltensor

    if _is_variable(v):
        return v
    if isinstance(v, bool):
        return ltensor.fill_constant([1], "bool", float(v))
    if isinstance(v, int):
        return ltensor.fill_constant([1], "int64", float(v))
    if isinstance(v, float):
        return ltensor.fill_constant([1], "float32", v)
    raise Dy2StaticError(
        "dygraph_to_static: cannot carry a %s through graph control "
        "flow; only tensors and int/float/bool scalars are supported"
        % type(v).__name__)


def _promote_scalar_pair(t, f):
    """Promote a branch pair to a COMMON dtype (True vs 0 must not
    become bool-vs-int64 `where` operands)."""
    from ..layers import tensor as ltensor

    def fill(v, dt):
        return ltensor.fill_constant([1], dt, float(v))

    if _is_variable(t) and _is_variable(f):
        return t, f
    if _is_variable(t):
        return t, fill(f, str(t.dtype))
    if _is_variable(f):
        return fill(t, str(f.dtype)), f
    if isinstance(t, float) or isinstance(f, float):
        dt = "float32"
    elif isinstance(t, bool) and isinstance(f, bool):
        dt = "bool"
    else:
        dt = "int64"
    return fill(t, dt), fill(f, dt)


def convert_while(cond_fn, body_fn, loop_vars):
    """Reference convert_while_loop (convert_operators.py:27)."""
    pred = cond_fn(*loop_vars)
    if not _is_variable(pred):
        # exact Python semantics
        loop_vars = tuple(loop_vars)
        while pred:
            loop_vars = tuple(body_fn(*loop_vars))
            pred = cond_fn(*loop_vars)
        return loop_vars
    return _build_while(cond_fn, body_fn, loop_vars)


def _rank1(v):
    """Normalize a 0-d Variable to shape [1]: a captured while carry
    keeps its shape, and scalar-vs-[1] drift between the initial value
    and a body update would force the interpreter fallback."""
    if getattr(v, "shape", None) == ():
        from ..layers import nn as lnn

        return lnn.reshape(v, [1])
    return v


def _build_while(cond_fn, body_fn, loop_vars):
    from ..layers import control_flow as cf
    from ..layers import tensor as ltensor

    for v in loop_vars:
        if isinstance(v, Undefined):
            raise Dy2StaticError(
                "dygraph_to_static: name '%s' is assigned inside a "
                "tensor-condition loop but has no value before it; "
                "initialize it before the loop" % v.name)
    carried = [_rank1(_promote_scalar(v)) for v in loop_vars]
    # Loop-carried vars are mutated in place by the body (`assign` into
    # the parent-scope var — the while op's scope-side-effect contract,
    # reference operators/controlflow/while_op.cc). A carried var that
    # is a feed/parameter must not be clobbered: copy into a fresh var.
    fresh = []
    for v in carried:
        nv = ltensor.assign(v)
        nv.shape = v.shape
        nv.dtype = v.dtype
        fresh.append(nv)
    pred_var = _to_bool_var(cond_fn(*fresh))
    w = cf.While(pred_var)
    with w.block():
        new_vars = body_fn(*fresh)
        if len(new_vars) != len(fresh):
            raise ValueError("loop body must return all loop vars")
        for old, new in zip(fresh, new_vars):
            if new is not old:
                ltensor.assign(_rank1(_promote_scalar(new)), old)
        ltensor.assign(_to_bool_var(cond_fn(*fresh)), pred_var)
    return tuple(fresh)


def convert_for_range(range_args, body_fn, loop_vars):
    """``for i in range(...)`` — tensor trip counts lower to a while
    op; Python trip counts keep Python semantics. ``body_fn`` takes
    (iter_var, *loop_vars) and returns the updated loop_vars tuple.
    Returns (final_iter_value, *updated_loop_vars) so the iteration
    variable stays bound after the loop, as in Python."""
    if len(range_args) == 1:
        start, stop, step = 0, range_args[0], 1
    elif len(range_args) == 2:
        start, stop = range_args
        step = 1
    else:
        start, stop, step = range_args
    if not (_is_variable(start) or _is_variable(stop)
            or _is_variable(step)):
        loop_vars = tuple(loop_vars)
        i = Undefined("<loop target>")  # zero-trip: stays undefined
        for i in range(start, stop, step):
            loop_vars = tuple(body_fn(i, *loop_vars))
        return (i,) + loop_vars

    from ..layers import tensor as ltensor

    def _i64(v):
        if _is_variable(v):
            if str(v.dtype) != "int64":
                return ltensor.cast(v, "int64")
            return v
        return ltensor.fill_constant([1], "int64", float(v))

    start_v, stop_v, step_v = _i64(start), _i64(stop), _i64(step)

    def cond_fn(i, *vs):
        # direction-aware bound: (step>0 and i<stop) or (step<0 and
        # i>stop) — a negative step must terminate, not hang the
        # compiled while loop
        from ..layers import control_flow as cf
        from ..layers import tensor as ltensor

        zero = ltensor.fill_constant([1], "int64", 0.0)
        fwd = cf.logical_and(step_v > zero, i < stop_v)
        bwd = cf.logical_and(step_v < zero, i > stop_v)
        return cf.logical_or(fwd, bwd)

    def wrapped_body(i, *vs):
        out = body_fn(i, *vs)
        return (i + step_v,) + tuple(out)

    results = _build_while(cond_fn, wrapped_body,
                           (start_v,) + tuple(loop_vars))
    # results[0] is the first OUT-of-range counter; Python leaves the
    # target at the last in-range value (zero-trip loops get start -
    # step — a documented deviation, Python would leave it unbound)
    final_i = results[0] - step_v
    return (final_i,) + tuple(results[1:])


def convert_logical_and(x, y_fn):
    if _is_variable(x):
        from ..layers import control_flow as cf

        y = y_fn()
        if not _is_variable(y):
            y = _promote_scalar(bool(y))
        return cf.logical_and(_to_bool_var(x), _to_bool_var(y))
    if not x:
        return x
    return y_fn()


def convert_logical_or(x, y_fn):
    if _is_variable(x):
        from ..layers import control_flow as cf

        y = y_fn()
        if not _is_variable(y):
            y = _promote_scalar(bool(y))
        return cf.logical_or(_to_bool_var(x), _to_bool_var(y))
    if x:
        return x
    return y_fn()


def convert_logical_not(x):
    if _is_variable(x):
        from ..layers import control_flow as cf

        return cf.logical_not(_to_bool_var(x))
    return not x


# ---------------------------------------------------------------------------
# AST analysis helpers
# ---------------------------------------------------------------------------


class _ScopedWalker(ast.NodeVisitor):
    """Walk statements without descending into nested function/class
    scopes (their assignments are not this scope's names)."""

    def visit_FunctionDef(self, node):
        pass

    def visit_AsyncFunctionDef(self, node):
        pass

    def visit_ClassDef(self, node):
        pass

    def visit_Lambda(self, node):
        pass


class _AssignedNames(_ScopedWalker):
    def __init__(self):
        self.names: Set[str] = set()

    def visit_Name(self, node):
        if isinstance(node.ctx, (ast.Store, ast.Del)):
            self.names.add(node.id)

    def visit_AugAssign(self, node):
        if isinstance(node.target, ast.Name):
            self.names.add(node.target.id)
        self.generic_visit(node)


class _ReadNames(_ScopedWalker):
    def __init__(self):
        self.names: Set[str] = set()

    def visit_Name(self, node):
        if isinstance(node.ctx, ast.Load):
            self.names.add(node.id)

    # reads inside nested lambdas/functions ARE closure reads of this
    # scope; be conservative and include them
    def visit_Lambda(self, node):
        for n in ast.walk(node):
            if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load):
                self.names.add(n.id)


def _assigned(stmts) -> Set[str]:
    w = _AssignedNames()
    for s in stmts:
        w.visit(s)
    return w.names


def _read(nodes) -> Set[str]:
    w = _ReadNames()
    for s in nodes:
        w.visit(s)
    return w.names


class _OwnLoopFlow(_ScopedWalker):
    """Scan a loop body's OWN scope: break/continue not inside nested
    loops; return at any statement depth (it escapes the loop either
    way); 'clean' is False when a break/continue hides under a
    non-If compound (try/with) the guard rewriter can't wrap."""

    def __init__(self):
        self.has_break = False
        self.has_continue = False
        self.has_return = False
        self.clean = True
        self._if_depth_only = True

    def visit_Return(self, node):
        self.has_return = True

    def visit_Break(self, node):
        self.has_break = True
        if not self._if_depth_only:
            self.clean = False

    def visit_Continue(self, node):
        self.has_continue = True
        if not self._if_depth_only:
            self.clean = False

    def visit_If(self, node):
        for s in node.body + node.orelse:
            self.visit(s)

    def _compound(self, node):
        prev = self._if_depth_only
        self._if_depth_only = False
        self.generic_visit(node)
        self._if_depth_only = prev

    visit_With = _compound
    visit_Try = _compound

    def visit_While(self, node):
        # nested loop BODY: its own break/continue scope — but a
        # return inside it still escapes THIS loop (skip nested
        # functions). The nested loop's else: clause is DIFFERENT:
        # Python binds break/continue there to the OUTER loop — the
        # guard rewriter can't wrap those, so they mark us not-clean.
        stack = list(node.body)
        while stack:
            s = stack.pop()
            if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.Lambda, ast.ClassDef)):
                continue
            if isinstance(s, ast.Return):
                self.has_return = True
            stack.extend(ast.iter_child_nodes(s))
        prev = self._if_depth_only
        self._if_depth_only = False  # break in else: -> clean = False
        for s in node.orelse:
            self.visit(s)
        self._if_depth_only = prev

    visit_For = visit_While


def _scan_own_loop_flow(stmts) -> "_OwnLoopFlow":
    w = _OwnLoopFlow()
    for s in stmts:
        w.visit(s)
    return w


def _flag_assign(name, value: bool):
    return ast.Assign(targets=[_name(name, ast.Store())],
                      value=ast.Constant(value=value))


def _rewrite_break_continue(stmts, brk, cont, guard_flags):
    """Replace break/continue with guard-flag sets and wrap statement
    suffixes in `if not (flags):` (reference
    break_continue_transformer.py). Returns (new_stmts, may_set)."""
    out = []
    for idx, s in enumerate(stmts):
        if isinstance(s, ast.Break):
            out.append(_flag_assign(brk, True))
            return out, True  # anything after a bare break is dead
        if isinstance(s, ast.Continue):
            out.append(_flag_assign(cont, True))
            return out, True
        if isinstance(s, ast.If):
            body, hit_b = _rewrite_break_continue(
                s.body, brk, cont, guard_flags)
            orelse, hit_o = _rewrite_break_continue(
                s.orelse, brk, cont, guard_flags)
            s = ast.If(test=s.test, body=body,
                       orelse=orelse or [])
            out.append(s)
            if hit_b or hit_o:
                rest, _ = _rewrite_break_continue(
                    stmts[idx + 1:], brk, cont, guard_flags)
                if rest:
                    # guard: not flag1 and not flag2 ...
                    test = None
                    for fl in guard_flags:
                        term = ast.UnaryOp(op=ast.Not(),
                                           operand=_name(fl))
                        test = term if test is None else ast.BoolOp(
                            op=ast.And(), values=[test, term])
                    out.append(ast.If(test=test, body=rest, orelse=[]))
                return out, True
            continue
        out.append(s)
    return out, False


def _has_flow_escape(stmts) -> bool:
    """return/break/continue directly in this statement list (not in
    nested loops for break/continue, not in nested functions)."""

    class W(_ScopedWalker):
        found = False

        def visit_Return(self, node):
            self.found = True

        def visit_Break(self, node):
            self.found = True

        def visit_Continue(self, node):
            self.found = True

        def visit_While(self, node):  # its own break/continue scope
            for t in node.body + node.orelse:
                if any(isinstance(n, ast.Return) for n in ast.walk(t)):
                    self.found = True

        visit_For = visit_While

    w = W()
    for s in stmts:
        w.visit(s)
    return w.found


# ---------------------------------------------------------------------------
# The transformer
# ---------------------------------------------------------------------------


def _name(id_, ctx=None):
    return ast.Name(id=id_, ctx=ctx or ast.Load())


def _jst_attr(fn_name):
    return ast.Attribute(value=_name("_jst"), attr=fn_name, ctx=ast.Load())


def _ret_tuple(names: List[str]):
    return ast.Return(value=ast.Tuple(
        elts=[_name(n) for n in names], ctx=ast.Load()))


def _guard_call(n: str):
    """``_jst.undefined_guard(lambda: n, 'n')`` — n's current outer
    value, or Undefined when unbound."""
    return ast.Call(
        func=_jst_attr("undefined_guard"),
        args=[ast.Lambda(
            args=ast.arguments(posonlyargs=[], args=[],
                               kwonlyargs=[], kw_defaults=[],
                               defaults=[]),
            body=_name(n)),
            ast.Constant(value=n)],
        keywords=[])


def _def_with_guard_defaults(name: str, argnames: List[str], body):
    """Branch function whose params DEFAULT to the enclosing scope's
    current values (evaluated at def time). This is how a branch body
    that assigns `s` can still read the pre-branch `s`: as a parameter,
    not a closure read (which Python forbids once the name is local)."""
    return ast.FunctionDef(
        name=name,
        args=ast.arguments(
            posonlyargs=[], args=[ast.arg(arg=a) for a in argnames],
            kwonlyargs=[], kw_defaults=[],
            defaults=[_guard_call(a) for a in argnames]),
        body=body or [ast.Pass()],
        decorator_list=[])


def _tuple_store(names: List[str]):
    return ast.Tuple(elts=[_name(n, ast.Store()) for n in names],
                     ctx=ast.Store())


def _def(name: str, argnames: List[str], body):
    return ast.FunctionDef(
        name=name,
        args=ast.arguments(
            posonlyargs=[], args=[ast.arg(arg=a) for a in argnames],
            kwonlyargs=[], kw_defaults=[], defaults=[]),
        body=body or [ast.Pass()],
        decorator_list=[])


class _ControlFlowTransformer(ast.NodeTransformer):
    """Rewrites if/while/for with potentially-tensor conditions into
    _jst.convert_* calls (reference ifelse/loop/logical transformers)."""

    def __init__(self):
        self._n = 0

    def _uid(self):
        self._n += 1
        return self._n

    # -- logical operators ------------------------------------------------

    def visit_BoolOp(self, node):
        self.generic_visit(node)
        conv = ("convert_logical_and" if isinstance(node.op, ast.And)
                else "convert_logical_or")
        out = node.values[0]
        for v in node.values[1:]:
            out = ast.Call(
                func=_jst_attr(conv),
                args=[out, ast.Lambda(
                    args=ast.arguments(posonlyargs=[], args=[],
                                       kwonlyargs=[], kw_defaults=[],
                                       defaults=[]),
                    body=v)],
                keywords=[])
        return out

    def visit_UnaryOp(self, node):
        self.generic_visit(node)
        if isinstance(node.op, ast.Not):
            return ast.Call(func=_jst_attr("convert_logical_not"),
                            args=[node.operand], keywords=[])
        return node

    # -- if/else ----------------------------------------------------------

    def visit_If(self, node):
        self.generic_visit(node)
        if _has_flow_escape(node.body) or _has_flow_escape(node.orelse):
            # early return/break in a branch: keep the Python `if`
            # (valid for Python conditions; a tensor condition here
            # raises via Variable.__bool__ with a pointer to this
            # limitation — the contract of a trace)
            return node
        uid = self._uid()
        # exclude synthetic _jst_* temporaries (from nested transformed
        # ifs) — they are dead after their converted statement and must
        # not cross the branch merge (mirrors visit_While's filter)
        modified = sorted(n for n in
                          (_assigned(node.body) | _assigned(node.orelse))
                          if not n.startswith("_jst_"))
        pred_name = "_jst_pred_%d" % uid
        true_name = "_jst_true_%d" % uid
        false_name = "_jst_false_%d" % uid
        stmts = [
            ast.Assign(targets=[_name(pred_name, ast.Store())],
                       value=node.test),
            _def_with_guard_defaults(
                true_name, modified,
                list(node.body) + [_ret_tuple(modified)]),
            _def_with_guard_defaults(
                false_name, modified,
                list(node.orelse) + [_ret_tuple(modified)]),
        ]
        call = ast.Call(func=_jst_attr("convert_ifelse"),
                        args=[_name(pred_name), _name(true_name),
                              _name(false_name)],
                        keywords=[])
        if modified:
            stmts.append(ast.Assign(targets=[_tuple_store(modified)],
                                    value=call))
        else:
            stmts.append(ast.Expr(value=call))
        return stmts

    # -- while ------------------------------------------------------------

    def visit_While(self, node):
        if node.orelse:
            self.generic_visit(node)
            return node
        flow = _scan_own_loop_flow(node.body)
        pre = []
        if flow.has_break or flow.has_continue:
            if flow.has_return or not flow.clean:
                # return-in-loop (or break under try/with) stays a
                # Python loop — tensor conditions get the
                # Variable.__bool__ guidance error
                self.generic_visit(node)
                return node
            fuid = self._uid()
            brk = "_loopflag_brk_%d" % fuid      # NOT _jst_: must carry
            cont = "_loopflag_cont_%d" % fuid
            flags = ([brk] if flow.has_break else []) + \
                ([cont] if flow.has_continue else [])
            body, _ = _rewrite_break_continue(node.body, brk, cont,
                                              flags)
            if flow.has_continue:
                # continue only skips the REST of the iteration
                body = [_flag_assign(cont, False)] + body
            if flow.has_break:
                node.test = ast.BoolOp(
                    op=ast.And(),
                    values=[ast.UnaryOp(op=ast.Not(),
                                        operand=_name(brk)),
                            node.test])
                pre.append(_flag_assign(brk, False))
            if flow.has_continue:
                pre.append(_flag_assign(cont, False))
            node = ast.While(test=node.test, body=body, orelse=[])
        self.generic_visit(node)
        if _has_flow_escape(node.body):
            return pre + [node] if pre else node
        uid = self._uid()
        # synthetic _jst_* temporaries (from nested transformed ifs)
        # are recomputed every iteration — never loop-carried
        loop_vars = sorted(n for n in _assigned(node.body)
                           if not n.startswith("_jst_"))
        if not loop_vars:
            return node
        cond_name = "_jst_cond_%d" % uid
        body_name = "_jst_body_%d" % uid
        stmts = []
        for lv in loop_vars:
            # x = undefined_guard(lambda: x, 'x') — Undefined when unbound
            stmts.append(ast.Assign(
                targets=[_name(lv, ast.Store())],
                value=ast.Call(
                    func=_jst_attr("undefined_guard"),
                    args=[ast.Lambda(
                        args=ast.arguments(posonlyargs=[], args=[],
                                           kwonlyargs=[], kw_defaults=[],
                                           defaults=[]),
                        body=_name(lv)),
                        ast.Constant(value=lv)],
                    keywords=[])))
        stmts.append(_def(cond_name, loop_vars,
                          [ast.Return(value=node.test)]))
        stmts.append(_def(body_name, loop_vars,
                          list(node.body) + [_ret_tuple(loop_vars)]))
        stmts.append(ast.Assign(
            targets=[_tuple_store(loop_vars)],
            value=ast.Call(
                func=_jst_attr("convert_while"),
                args=[_name(cond_name), _name(body_name),
                      ast.Tuple(elts=[_name(v) for v in loop_vars],
                                ctx=ast.Load())],
                keywords=[])))
        return pre + stmts

    # -- for range --------------------------------------------------------

    def visit_For(self, node):
        self.generic_visit(node)
        if (node.orelse or _has_flow_escape(node.body)
                or not isinstance(node.target, ast.Name)
                or not isinstance(node.iter, ast.Call)
                or not isinstance(node.iter.func, ast.Name)
                or node.iter.func.id != "range"
                or node.iter.keywords):
            return node
        uid = self._uid()
        target = node.target.id
        loop_vars = sorted(n for n in _assigned(node.body) - {target}
                           if not n.startswith("_jst_"))
        body_name = "_jst_forbody_%d" % uid
        stmts = []
        for lv in loop_vars:
            stmts.append(ast.Assign(
                targets=[_name(lv, ast.Store())],
                value=ast.Call(
                    func=_jst_attr("undefined_guard"),
                    args=[ast.Lambda(
                        args=ast.arguments(posonlyargs=[], args=[],
                                           kwonlyargs=[], kw_defaults=[],
                                           defaults=[]),
                        body=_name(lv)),
                        ast.Constant(value=lv)],
                    keywords=[])))
        stmts.append(_def(body_name, [target] + loop_vars,
                          list(node.body) + [_ret_tuple(loop_vars)]))
        stmts.append(ast.Assign(
            targets=[_tuple_store([target] + loop_vars)],
            value=ast.Call(
                func=_jst_attr("convert_for_range"),
                args=[ast.Tuple(elts=list(node.iter.args),
                                ctx=ast.Load()),
                      _name(body_name),
                      ast.Tuple(elts=[_name(v) for v in loop_vars],
                                ctx=ast.Load())],
                keywords=[])))
        return stmts


# ---------------------------------------------------------------------------
# Function compilation
# ---------------------------------------------------------------------------


class _JstModule:
    """The ``_jst`` namespace injected into transformed functions."""

    convert_ifelse = staticmethod(convert_ifelse)
    convert_while = staticmethod(convert_while)
    convert_for_range = staticmethod(convert_for_range)
    convert_logical_and = staticmethod(convert_logical_and)
    convert_logical_or = staticmethod(convert_logical_or)
    convert_logical_not = staticmethod(convert_logical_not)
    undefined_guard = staticmethod(undefined_guard)


_JST = _JstModule()


def ast_to_static_func(fn):
    """Return (converted_fn, True) or (fn, False) when the source is
    unavailable (builtins, exec-defined, C extensions)."""
    try:
        src = inspect.getsource(fn)
    except (OSError, TypeError):
        return fn, False
    src = textwrap.dedent(src)
    try:
        tree = ast.parse(src)
    except SyntaxError:
        return fn, False
    func_def = tree.body[0]
    if not isinstance(func_def, (ast.FunctionDef, ast.AsyncFunctionDef)):
        return fn, False
    func_def.decorator_list = []
    _ControlFlowTransformer().visit(func_def)

    freevars = list(fn.__code__.co_freevars)
    if freevars:
        # rebuild the closure: wrap in a factory taking the free names
        factory = _def("_jst_factory", freevars,
                       [func_def, ast.Return(value=_name(func_def.name))])
        mod = ast.Module(body=[factory], type_ignores=[])
    else:
        mod = ast.Module(body=[func_def], type_ignores=[])
    ast.fix_missing_locations(mod)

    class _Globals(dict):
        """Live view over the module globals: names defined AFTER the
        decorator runs (later helpers, late imports) must resolve —
        a dict snapshot would freeze the module at decoration time.
        LOAD_GLOBAL honors __missing__ on dict subclasses."""

        def __init__(self, base):
            super().__init__()
            self._base = base

        def __missing__(self, key):
            return self._base[key]

    glb = _Globals(getattr(fn, "__globals__", {}))
    glb["_jst"] = _JST
    code = compile(mod, filename="<dygraph_to_static:%s>" % fn.__name__,
                   mode="exec")
    # exec into ONE namespace so recursive self-references resolve
    exec(code, glb)
    if freevars:
        try:
            # NOTE: a decoration-time snapshot — a free variable
            # rebound later is not seen by the static path (the trace
            # fallback would see it); empty cells (self-recursion,
            # late binding) mean the AST path cannot be built
            cells = [c.cell_contents for c in fn.__closure__]
        except ValueError:  # empty cell
            return fn, False
        new_fn = glb["_jst_factory"](*cells)
    else:
        new_fn = glb[func_def.name]
    new_fn.__defaults__ = fn.__defaults__
    new_fn.__kwdefaults__ = fn.__kwdefaults__
    return new_fn, True
