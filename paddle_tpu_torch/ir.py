"""Program-level IR graph and pass infrastructure.

Counterpart of ``paddle_tpu/ir.py`` (the reference's
``framework/ir/`` graph, pass and pass registry, and the Python
``IrGraph`` wrapper). An ``IrGraph`` is a mutable view of a single-block
``Program``: passes rewrite it with ``create_*_node`` /
``safe_remove_nodes`` and ``to_program()`` materializes the result, op
order preserved. The inference predictor runs ``ConvBnFusePass`` and
``FcFusePass`` on the program it loads (``inference/__init__.py``); both
emit ops the port runs on the card: ``conv2d`` with a ``Bias`` (K5 when
the conv is routed there) and ``fc`` (``ops/fused_ops.py``).

``ConvBnFusePass`` rewrites the scope's tensors in place, on the device
they live on: the OIHW filter is scaled along axis 0 (for either data
format) and the folded bias ``<filter>.bn_fold_bias`` is a new
persistable in the scope, fed through ``conv2d``'s ``Bias`` slot.
"""
from __future__ import annotations

import inspect
import os
from typing import Dict, List, Optional, Sequence

import torch

from . import framework
from .core import dtypes as _dt

__all__ = ["IrVarNode", "IrOpNode", "IrGraph", "Pass", "PassRegistry",
           "GraphVizPass", "FcFusePass", "GraphPatternDetector",
           "ConvBnFusePass", "GraphCheckPass", "MemoryEstimationPass",
           "apply_pass", "apply_passes"]


class IrVarNode:
    """Variable node (reference IrVarNode framework.py:2966)."""

    def __init__(self, graph, name: str, shape=None, dtype="float32",
                 persistable: bool = False, is_parameter: bool = False,
                 trainable: bool = True, stop_gradient: bool = False,
                 is_data: bool = False, lod_level: int = 0,
                 var_type: str = "lod_tensor"):
        self._graph = graph
        self._name = name
        self.shape = tuple(shape) if shape is not None else None
        self.dtype = dtype
        self.persistable = persistable
        self.is_parameter = is_parameter
        self.trainable = trainable
        self.stop_gradient = stop_gradient
        self.is_data = is_data
        self.lod_level = lod_level
        self.var_type = var_type

    def name(self) -> str:
        return self._name

    def is_var(self) -> bool:
        return True

    def is_op(self) -> bool:
        return False

    @property
    def inputs(self) -> List["IrOpNode"]:
        """Ops that write this var."""
        return [op for op in self._graph.all_op_nodes()
                if self._name in op.output_arg_names()]

    @property
    def outputs(self) -> List["IrOpNode"]:
        """Ops that read this var."""
        return [op for op in self._graph.all_op_nodes()
                if self._name in op.input_arg_names()]

    def __repr__(self):
        return "IrVarNode(%s)" % self._name


class IrOpNode:
    """Operator node (reference IrOpNode framework.py:3059)."""

    def __init__(self, graph, op_type: str, inputs: Dict, outputs: Dict,
                 attrs: Optional[Dict] = None):
        self._graph = graph
        self._type = op_type
        self._inputs = {k: list(v) for k, v in inputs.items()}
        self._outputs = {k: list(v) for k, v in outputs.items()}
        self._attrs = dict(attrs or {})

    def name(self) -> str:
        return self._type

    def op_type(self) -> str:
        return self._type

    def is_var(self) -> bool:
        return False

    def is_op(self) -> bool:
        return True

    def input(self, slot: str) -> List[str]:
        return list(self._inputs.get(slot, []))

    def output(self, slot: str) -> List[str]:
        return list(self._outputs.get(slot, []))

    def input_slots(self):
        return dict(self._inputs)

    def output_slots(self):
        return dict(self._outputs)

    def input_arg_names(self) -> List[str]:
        return [n for v in self._inputs.values() for n in v]

    def output_arg_names(self) -> List[str]:
        return [n for v in self._outputs.values() for n in v]

    def attr(self, name: str):
        return self._attrs.get(name)

    def set_attr(self, name: str, value):
        self._attrs[name] = value

    def rename_input(self, old: str, new: str):
        for slot, names in self._inputs.items():
            self._inputs[slot] = [new if n == old else n for n in names]

    def rename_output(self, old: str, new: str):
        for slot, names in self._outputs.items():
            self._outputs[slot] = [new if n == old else n for n in names]

    @property
    def inputs(self) -> List[IrVarNode]:
        return [self._graph.var_node(n) for n in self.input_arg_names()
                if self._graph.has_var_node(n)]

    @property
    def outputs(self) -> List[IrVarNode]:
        return [self._graph.var_node(n) for n in self.output_arg_names()
                if self._graph.has_var_node(n)]

    def __repr__(self):
        return "IrOpNode(%s)" % self._type


class IrGraph:
    """Mutable graph view over a Program (reference framework.py:3212).

    Build with ``IrGraph(program)`` (or ``IrGraph.from_program``); mutate
    with create_*/safe_remove_nodes/rename; materialize back with
    ``to_program()`` — op order is the preserved program order with
    created ops appended before their first consumer.
    """

    def __init__(self, program=None, for_test: bool = False):
        self._for_test = for_test
        self._ops: List[IrOpNode] = []
        self._vars: Dict[str, IrVarNode] = {}
        self._startup_inits: List = []
        if program is not None:
            self._load(program)

    # -- construction -----------------------------------------------------
    @classmethod
    def from_program(cls, program, for_test: bool = False) -> "IrGraph":
        return cls(program, for_test=for_test)

    def _load(self, program):
        if len(program.blocks) > 1:
            raise NotImplementedError(
                "IrGraph covers single-block programs; this one has %d "
                "blocks (control-flow sub-blocks). Apply passes before "
                "adding While/cond, or rewrite sub-blocks explicitly."
                % len(program.blocks))
        block = program.global_block()
        for name, var in block.vars.items():
            self._vars[name] = IrVarNode(
                self, name, getattr(var, "shape", None),
                getattr(var, "dtype", "float32"),
                bool(getattr(var, "persistable", False)),
                is_parameter=isinstance(var, framework.Parameter),
                trainable=bool(getattr(var, "trainable", True)),
                stop_gradient=bool(getattr(var, "stop_gradient", False)),
                is_data=bool(getattr(var, "is_data", False)),
                lod_level=int(getattr(var, "lod_level", 0) or 0),
                var_type=getattr(var, "type", "lod_tensor"))
        for op in block.ops:
            self._ops.append(IrOpNode(self, op.type, dict(op.inputs),
                                      dict(op.outputs), dict(op.attrs)))

    # -- queries ----------------------------------------------------------
    def all_op_nodes(self) -> List[IrOpNode]:
        return list(self._ops)

    def all_var_nodes(self) -> List[IrVarNode]:
        return list(self._vars.values())

    def all_persistable_nodes(self) -> List[IrVarNode]:
        return [v for v in self._vars.values() if v.persistable]

    def has_var_node(self, name: str) -> bool:
        return name in self._vars

    def var_node(self, name: str) -> IrVarNode:
        if name not in self._vars:
            raise ValueError("var node %r not in graph" % name)
        return self._vars[name]

    # -- mutation ---------------------------------------------------------
    def create_var_node(self, name, var_type=None, shape=None,
                        var_dtype="float32") -> IrVarNode:
        node = IrVarNode(self, name, shape, var_dtype, persistable=False)
        self._vars[name] = node
        return node

    def create_persistable_node(self, name, var_type=None, shape=None,
                                var_dtype="float32") -> IrVarNode:
        node = IrVarNode(self, name, shape, var_dtype, persistable=True)
        self._vars[name] = node
        return node

    def create_op_node(self, op_type, attrs, inputs, outputs,
                       before: Optional[IrOpNode] = None) -> IrOpNode:
        """Insert an op node; by default right before the earliest
        consumer of any of its outputs (keeps def-before-use)."""
        node = IrOpNode(self, op_type, inputs, outputs, attrs)
        pos = len(self._ops)
        if before is not None:
            pos = self._ops.index(before)
        else:
            produced = set(node.output_arg_names())
            for i, op in enumerate(self._ops):
                if produced & set(op.input_arg_names()):
                    pos = i
                    break
        self._ops.insert(pos, node)
        return node

    def safe_remove_nodes(self, remove_nodes: Sequence):
        for n in remove_nodes:
            if isinstance(n, IrOpNode):
                if n in self._ops:
                    self._ops.remove(n)
            else:
                self._vars.pop(n.name(), None)

    def link_to(self, node_in, node_out):
        """Edges derive from op input/output names here — kept as a
        no-op for reference-API compatibility (passes call it after
        create_op_node)."""

    # -- init values for created persistables ------------------------------
    def set_initializer(self, var_name: str, value):
        """Record a host value for a created persistable; applied to the
        scope by Pass users / to_program callers."""
        self._startup_inits.append((var_name, value))

    @property
    def startup_inits(self):
        return list(self._startup_inits)

    # -- materialize -------------------------------------------------------
    def to_program(self):
        prog = framework.Program()
        block = prog.global_block()
        for name, v in self._vars.items():
            if v.is_parameter:
                var = block.create_parameter(
                    name=name, shape=v.shape, dtype=v.dtype,
                    trainable=v.trainable)
            else:
                var = block.create_var(name=name, dtype=v.dtype,
                                       persistable=v.persistable,
                                       stop_gradient=v.stop_gradient,
                                       is_data=v.is_data,
                                       lod_level=v.lod_level,
                                       type=v.var_type)
            if v.shape is not None:
                var.shape = tuple(v.shape)
        for op in self._ops:
            block.append_op(op.op_type(), op.input_slots(),
                            op.output_slots(), dict(op._attrs),
                            infer_shape=False)
        return prog

    def draw(self, save_path, name, marked_nodes=None,
             remove_ctr_var=True):
        """Graphviz dot export (reference uses the graph_viz_pass +
        dot binary; here we always write the .dot text)."""
        lines = ["digraph %s {" % name]
        for i, op in enumerate(self._ops):
            lines.append('  op%d [label="%s" shape=box];' % (i,
                                                             op.op_type()))
            for n in op.input_arg_names():
                lines.append('  "%s" -> op%d;' % (n, i))
            for n in op.output_arg_names():
                lines.append('  op%d -> "%s";' % (i, n))
        lines.append("}")
        path = os.path.join(save_path, "%s.dot" % name)
        with open(path, "w") as f:
            f.write("\n".join(lines))
        return path


class Pass:
    """Graph-rewriting pass base (reference ir/pass.h)."""

    name = "pass"

    def apply(self, graph: IrGraph) -> IrGraph:
        raise NotImplementedError

    def __call__(self, graph: IrGraph) -> IrGraph:
        return self.apply(graph)


class PassRegistry:
    _passes: Dict[str, type] = {}

    @classmethod
    def register(cls, pass_cls):
        cls._passes[pass_cls.name] = pass_cls
        return pass_cls

    @classmethod
    def get(cls, name: str) -> Pass:
        if name not in cls._passes:
            raise KeyError("pass %r not registered (have: %s)"
                           % (name, sorted(cls._passes)))
        return cls._passes[name]()

    @classmethod
    def has(cls, name: str) -> bool:
        return name in cls._passes


@PassRegistry.register
class GraphVizPass(Pass):
    """reference ir/graph_viz_pass.cc"""

    name = "graph_viz_pass"

    def __init__(self, save_path=".", graph_name="graph"):
        self.save_path = save_path
        self.graph_name = graph_name

    def apply(self, graph: IrGraph) -> IrGraph:
        graph.draw(self.save_path, self.graph_name)
        return graph


@PassRegistry.register
class FcFusePass(Pass):
    """mul + elementwise_add (+ relu) -> fc (reference
    ir/fc_fuse_pass.cc). The ``fc`` op runs the three ops' functions in
    order, so the rewritten program gives the chain's bits."""

    name = "fc_fuse_pass"

    _ACTS = ("relu",)

    @staticmethod
    def _consumer_index(graph):
        idx: Dict[str, List[IrOpNode]] = {}
        for o in graph._ops:
            for n in o.input_arg_names():
                idx.setdefault(n, []).append(o)
        return idx

    def _is_fc_bias(self, graph, name) -> bool:
        """Only a persistable rank-1-ish bias qualifies (reference
        fc_fuse_pass matches a persistable [N] / [1, N] addend) —
        residual adds of activation tensors must NOT fuse."""
        if not graph.has_var_node(name):
            return False
        v = graph.var_node(name)
        if not v.persistable or v.shape is None:
            return False
        non_unit = [s for s in v.shape if s != 1]
        return len(non_unit) <= 1

    def apply(self, graph: IrGraph) -> IrGraph:
        consumers_of = self._consumer_index(graph)
        i = 0
        while i < len(graph._ops):
            op = graph._ops[i]
            if op.op_type() != "mul":
                i += 1
                continue
            out = op.output("Out")[0]
            consumers = consumers_of.get(out, [])
            if len(consumers) != 1 or \
                    consumers[0].op_type() != "elementwise_add":
                i += 1
                continue
            add = consumers[0]
            bias = (add.input("Y") if add.input("X") == [out]
                    else add.input("X"))[0]
            if not self._is_fc_bias(graph, bias):
                i += 1
                continue
            add_out = add.output("Out")[0]
            act = None
            act_consumers = consumers_of.get(add_out, [])
            if len(act_consumers) == 1 and \
                    act_consumers[0].op_type() in self._ACTS:
                act = act_consumers[0]
            final_out = act.output("Out")[0] if act else add_out
            fc = IrOpNode(graph, "fc",
                          {"Input": op.input("X"), "W": op.input("Y"),
                           "Bias": [bias]},
                          {"Out": [final_out]},
                          {"in_num_col_dims": op.attr("x_num_col_dims")
                           or 1,
                           "activation_type": act.op_type() if act
                           else ""})
            graph._ops[i] = fc
            graph.safe_remove_nodes([add] + ([act] if act else []))
            consumers_of = self._consumer_index(graph)
            i += 1
        return graph


class GraphPatternDetector:
    """Declarative subgraph matcher (reference
    ir/graph_pattern_detector.h PDPattern/PDNode + GraphPatternDetector).

    The reference builds a pattern of PDNodes with assert_is_op /
    LinksTo edges and runs subgraph isomorphism; here a pattern is a
    set of keyed op nodes plus slot-level edges, matched by
    backtracking (patterns are 2-5 ops, so the search is trivial)::

        d = GraphPatternDetector()
        d.op_node("conv", "conv2d")
        d.op_node("bn", "batch_norm")
        d.edge_out("conv", "Output", "conv_out")
        d.edge_in("bn", "X", "conv_out")
        for m in d.detect(graph):
            m["conv"], m["bn"]   # IrOpNodes
            m["conv_out"]        # var name
    """

    def __init__(self):
        self._op_nodes = []   # (key, op_type, predicate)
        self._edges = []      # (op_key, direction, slot, var_key)
        self._var_preds = {}  # var_key -> predicate(graph, name)

    # -- pattern construction ---------------------------------------------

    def op_node(self, key, op_type, predicate=None):
        self._op_nodes.append((key, op_type, predicate))
        return key

    def var_node(self, key, predicate=None):
        if predicate is not None:
            self._var_preds[key] = predicate
        return key

    def edge_out(self, op_key, slot, var_key):
        """op_key's output slot produces var_key (first name in slot)."""
        self._edges.append((op_key, "out", slot, var_key))

    def edge_in(self, op_key, slot, var_key):
        """op_key consumes var_key at input slot (first name)."""
        self._edges.append((op_key, "in", slot, var_key))

    # -- helpers -----------------------------------------------------------

    @staticmethod
    def consumer_index(graph) -> Dict[str, List[IrOpNode]]:
        idx: Dict[str, List[IrOpNode]] = {}
        for o in graph.all_op_nodes():
            for n in o.input_arg_names():
                idx.setdefault(n, []).append(o)
        return idx

    # -- matching ----------------------------------------------------------

    def detect(self, graph: IrGraph):
        """Yield match dicts {key -> IrOpNode | var name}. Ops bind
        injectively; overlapping matches are all yielded — rewriting
        passes must skip ops they already consumed."""
        ops = graph.all_op_nodes()
        by_type: Dict[str, List[IrOpNode]] = {}
        for o in ops:
            by_type.setdefault(o.op_type(), []).append(o)

        def backtrack(i, bound_ops, bound_vars):
            if i == len(self._op_nodes):
                m = dict(bound_ops)
                m.update(bound_vars)
                yield m
                return
            key, op_type, pred = self._op_nodes[i]
            for cand in by_type.get(op_type, []):
                if cand in bound_ops.values():
                    continue
                if pred is not None and not pred(cand):
                    continue
                new_vars = dict(bound_vars)
                ok = True
                for op_key, direction, slot, var_key in self._edges:
                    if op_key != key:
                        continue
                    names = (cand.output(slot) if direction == "out"
                             else cand.input(slot))
                    if not names:
                        ok = False
                        break
                    name = names[0]
                    if var_key in new_vars and new_vars[var_key] != name:
                        ok = False
                        break
                    vp = self._var_preds.get(var_key)
                    if vp is not None and not vp(graph, name):
                        ok = False
                        break
                    new_vars[var_key] = name
                if not ok:
                    continue
                # edges whose op is already bound must agree too
                for op_key, direction, slot, var_key in self._edges:
                    if op_key == key or op_key not in bound_ops:
                        continue
                    other = bound_ops[op_key]
                    names = (other.output(slot) if direction == "out"
                             else other.input(slot))
                    if names and var_key in new_vars \
                            and new_vars[var_key] != names[0]:
                        ok = False
                        break
                if not ok:
                    continue
                bound_ops[key] = cand
                yield from backtrack(i + 1, bound_ops, new_vars)
                del bound_ops[key]

        yield from backtrack(0, {}, {})


@PassRegistry.register
class ConvBnFusePass(Pass):
    """conv2d + batch_norm (inference) -> conv2d with folded weights
    (reference ir/conv_bn_fuse_pass.cc). The BN affine transform is
    folded into the conv filter and a bias:

        W' = W * gamma / sqrt(var + eps)      (per out-channel)
        b' = (b - mean) * gamma / sqrt(var + eps) + beta

    Needs the scope holding the parameter values, whose tensors it
    rewrites in place on their own device, in their own dtype. Only valid
    on a for_test graph (``is_test`` batch norms): training BN updates
    its running statistics.
    """

    name = "conv_bn_fuse_pass"

    def __init__(self, scope=None):
        self.scope = scope

    def _val(self, slot_names):
        v = self.scope.find_var(slot_names[0])
        if v is None or not v.is_initialized():
            return None
        return v.get_tensor().array

    def apply(self, graph: IrGraph) -> IrGraph:
        if self.scope is None:
            raise ValueError("conv_bn_fuse_pass needs the scope holding "
                             "parameter values")
        d = GraphPatternDetector()
        d.op_node("conv", "conv2d")
        d.op_node("bn", "batch_norm",
                  predicate=lambda op: bool(op.attr("is_test")))
        d.edge_out("conv", "Output", "conv_out")
        d.edge_in("bn", "X", "conv_out")
        consumed = set()
        folded_filters = set()
        consumers_of = GraphPatternDetector.consumer_index(graph)
        for m in list(d.detect(graph)):
            conv, bn = m["conv"], m["bn"]
            if id(conv) in consumed or id(bn) in consumed:
                continue
            # conv_out must feed only the bn: a live pre-BN value would be
            # corrupted by the fold
            if len(consumers_of.get(m["conv_out"], [])) != 1:
                continue
            # a filter shared by more than one op must not be folded (the
            # in-place rewrite would corrupt the other consumer)
            filt = conv.input("Filter")[0]
            if filt in folded_filters or \
                    len(consumers_of.get(filt, [])) != 1:
                continue
            w = self._val(conv.input("Filter"))
            gamma = self._val(bn.input("Scale"))
            beta = self._val(bn.input("Bias"))
            mean = self._val(bn.input("Mean"))
            var = self._val(bn.input("Variance"))
            if any(x is None for x in (w, gamma, beta, mean, var)):
                continue
            eps = bn.attr("epsilon")
            eps = 1e-5 if eps is None else float(eps)
            factor = gamma / torch.sqrt(var + eps)
            # the filter is OIHW for either data format: scale axis 0
            w_new = w * factor.reshape((-1,) + (1,) * (w.dim() - 1))
            conv_bias = conv.input("Bias")
            b = self._val(conv_bias) if conv_bias else None
            if b is None:
                b = torch.zeros_like(mean)
            b_new = (b - mean) * factor + beta
            self.scope.find_var(filt).get_tensor().set(w_new)
            bias_name = filt + ".bn_fold_bias"
            graph.create_persistable_node(
                bias_name, shape=tuple(b_new.shape),
                var_dtype=_dt.convert_dtype(b_new.dtype))
            # the value goes straight into the scope: to_program callers
            # never see the graph's startup_inits
            self.scope.var(bias_name).get_tensor().set(b_new)
            graph.set_initializer(bias_name, b_new)
            bn_out = bn.output("Y")[0]
            fused = IrOpNode(
                graph, "conv2d",
                {**conv.input_slots(), "Bias": [bias_name]},
                {"Output": [bn_out]}, dict(conv._attrs))
            graph._ops[graph._ops.index(conv)] = fused
            graph.safe_remove_nodes([bn])
            consumed.update((id(conv), id(bn)))
            folded_filters.add(filt)
            consumers_of = GraphPatternDetector.consumer_index(graph)
        return graph


@PassRegistry.register
class GraphCheckPass(Pass):
    """Graph consistency validator (reference
    ir/multi_devices_graph_check_pass + the SSA sanity checks): every
    op input must be produced by an earlier op, fed (is_data), or
    persistable — a def-before-use audit over the op order the
    executor/compiler will run."""

    name = "graph_check_pass"

    def apply(self, graph: IrGraph) -> IrGraph:
        defined = set()
        for v in graph.all_var_nodes():
            if v.persistable or v.is_parameter or v.is_data:
                defined.add(v.name())
        for op in graph.all_op_nodes():
            if op.op_type() in ("feed", "read", "create_py_reader"):
                defined.update(op.output_arg_names())
                continue
            for n in op.input_arg_names():
                if n not in defined:
                    raise ValueError(
                        "graph_check_pass: op %r reads %r which no "
                        "earlier op produces and which is not "
                        "persistable/fed" % (op.op_type(), n))
            defined.update(op.output_arg_names())
        return graph


@PassRegistry.register
class MemoryEstimationPass(Pass):
    """Liveness-based memory diagnostic (reference
    ir/memory_optimize_pass/*, which rewrites the graph for buffer reuse;
    as in the JAX package this pass only reports: per-var live ranges,
    peak concurrent activation bytes and persistable bytes, with unknown
    dims taken as ``batch_size``)."""

    name = "memory_estimation_pass"

    def __init__(self, batch_size=1):
        self.batch_size = batch_size
        self.report = None

    def _nbytes(self, v) -> int:
        if v.shape is None:
            return 0
        n = 1
        for d in v.shape:
            n *= self.batch_size if d in (-1, None) else int(d)
        return int(n) * _dt.to_torch_dtype(v.dtype).itemsize

    def apply(self, graph: IrGraph) -> IrGraph:
        ops = graph.all_op_nodes()
        first_def: Dict[str, int] = {}
        last_use: Dict[str, int] = {}
        for i, op in enumerate(ops):
            for n in op.output_arg_names():
                first_def.setdefault(n, i)
                last_use[n] = i
            for n in op.input_arg_names():
                last_use[n] = i
        persistable_bytes = 0
        events = []  # (step, +bytes/-bytes)
        var_bytes = {}
        for name in set(first_def) | set(last_use):
            if not graph.has_var_node(name):
                continue
            v = graph.var_node(name)
            b = self._nbytes(v)
            var_bytes[name] = b
            if v.persistable:
                persistable_bytes += b
                continue
            start = first_def.get(name, 0)
            end = last_use.get(name, start)
            events.append((start, b))
            events.append((end + 1, -b))
        peak = cur = 0
        for _, delta in sorted(events, key=lambda e: (e[0], -e[1])):
            cur += delta
            peak = max(peak, cur)
        self.report = {
            "persistable_bytes": persistable_bytes,
            "peak_activation_bytes": peak,
            "n_vars": len(var_bytes),
            "live_ranges": {n: (first_def.get(n, 0), last_use.get(n, 0))
                            for n in var_bytes},
        }
        return graph


def apply_pass(program, pass_name: str, **kwargs):
    """Convenience: program -> pass -> program."""
    cls = PassRegistry._passes[pass_name]
    p = cls(**kwargs) if kwargs else cls()
    return p.apply(IrGraph(program)).to_program()


def apply_passes(program, pass_names, **common_kwargs):
    """Pass-pipeline runner (reference PassBuilder / ir_pass_manager):
    threads one IrGraph through the named passes, then materializes."""
    graph = IrGraph(program)
    applied = []
    for name in pass_names:
        cls = PassRegistry._passes[name]
        sig = inspect.signature(cls.__init__)
        kw = {k: v for k, v in common_kwargs.items()
              if k in sig.parameters}
        p = cls(**kw)
        graph = p.apply(graph)
        applied.append(p)
    prog = graph.to_program()
    return prog, applied
