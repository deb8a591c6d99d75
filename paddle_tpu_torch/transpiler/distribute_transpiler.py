"""Parameter-server program transpiler.

The port of ``paddle_tpu/transpiler/distribute_transpiler.py`` (the
reference's ``distribute_transpiler.py``: ``slice_variable``, the config,
``transpile`` and ``get_pserver_program``), emitting the same programs op
for op. With ``slice_var_up`` (the default) a large dense param is SLICED
into row blocks spread over the pservers: the trainer splits each grad,
sends each block to its server and concats the received param blocks;
each endpoint's server program runs the optimizer on just its block.
Trainer grads route through send / barrier / recv ops, and a server
program is one listen_and_serv op with an optimizer sub-block per hosted
grad. An ``embedding(is_distributed=True)`` table is row-sliced over the
servers: its lookup becomes ``distributed_lookup_table`` (a pull), its
grad ``distributed_push_sparse`` (a push), and its optimizer op moves to
the servers.

The send / recv ops (``ops/distributed_ops.py``) run against in-process
emulated servers when the endpoints are local, and over the socket RPC
of ``distributed/ps_rpc.py`` across processes.
"""
from __future__ import annotations

import math
from typing import Dict, List

from .. import framework
from ..parallel.transpiler import OPTIMIZER_OP_TYPES


class DistributeTranspilerConfig:
    """(reference distribute_transpiler.py:141)"""

    slice_var_up = True
    split_method = None
    min_block_size = 8192
    enable_dc_asgd = False
    mode = "pserver"
    print_log = False
    wait_port = True
    runtime_split_send_recv = False
    sync_mode = True
    # geo-SGD: push parameter deltas every N local steps
    geo_sgd_mode = False
    geo_sgd_need_push_nums = 100


class VarBlock:
    def __init__(self, varname, offset, size):
        self.varname = varname
        self.offset = offset
        self.size = size

    def __str__(self):
        return "%s:%d:%d" % (self.varname, self.offset, self.size)


def slice_variable(var_list, slice_count, min_block_size):
    """Split vars into per-pserver blocks (reference
    distribute_transpiler.py:95): split dim0; block count bounded by
    slice_count and min_block_size."""
    blocks = []
    for var in var_list:
        split_count = slice_count
        var_numel = 1
        for s in var.shape:
            var_numel *= int(s)
        max_pserver_count = int(
            math.floor(var_numel / float(min_block_size)))
        if max_pserver_count == 0:
            max_pserver_count = 1
        if max_pserver_count < slice_count:
            split_count = max_pserver_count
        block_size = int(math.ceil(var_numel / float(split_count)))
        if len(var.shape) >= 2:
            dim1 = 1
            for s in var.shape[1:]:
                dim1 *= int(s)
            remains = block_size % dim1
            if remains != 0:
                block_size += dim1 - remains
        split_count = int(math.ceil(var_numel / float(block_size)))
        for block_id in range(split_count):
            curr_block_size = min(block_size,
                                  var_numel - (block_id * block_size))
            blocks.append(VarBlock(var.name, block_id, curr_block_size))
    return blocks


class DistributeTranspiler:
    def __init__(self, config=None):
        self.config = config or DistributeTranspilerConfig()
        self._transpiled = False

    # -- public API (reference :540) --------------------------------------
    def transpile(self, trainer_id, program=None, pservers="127.0.0.1:6174",
                  trainers=1, sync_mode=True, startup_program=None,
                  current_endpoint="127.0.0.1:6174"):
        self.origin_program = program or framework.default_main_program()
        self.startup_program = (startup_program
                                or framework.default_startup_program())
        self.trainer_id = trainer_id
        self.trainer_num = trainers
        self.sync_mode = sync_mode
        self.pserver_endpoints = (pservers.split(",")
                                  if isinstance(pservers, str) else
                                  list(pservers))

        if self.config.mode == "nccl2":
            # collective mode: grads allreduced, no PS machinery
            from ..parallel.transpiler import insert_allreduce_ops

            insert_allreduce_ops(self.origin_program, trainers)
            self._transpiled = True
            return

        block = self.origin_program.global_block()
        eps_all = self.pserver_endpoints

        # distributed sparse tables (pslib path,
        # distributed_lookup_table_op.cc): embedding(is_distributed=True)
        # tables are ROW-SLICED across pservers; their lookup becomes a
        # sparse pull, their grad a sparse push, and their optimizer op
        # moves server-side
        self.dist_tables: Dict[str, dict] = {}
        for op in block.ops:
            if op.type in ("lookup_table", "lookup_table_v2") \
                    and op.attrs.get("is_distributed"):
                w = op.input("W")[0]
                v = block._find_var_recursive(w)
                rows = int(v.shape[0])
                per = int(math.ceil(rows / float(len(eps_all))))
                starts, counts = [], []
                for k in range(len(eps_all)):
                    s = min(k * per, rows)
                    starts.append(s)
                    counts.append(min(per, rows - s))
                self.dist_tables[w] = {
                    "dim": int(v.shape[1]),
                    "dtype": getattr(v, "dtype", "float32") or "float32",
                    "starts": starts, "counts": counts,
                    "squeeze": op.type == "lookup_table",
                    "padding_idx": int(op.attrs.get("padding_idx", -1)),
                }

        # param/grad pairs from optimizer ops; drop the optimizer ops —
        # updates happen on the pservers. Distributed tables are NOT in
        # the dense send/recv set (their updates ride the sparse push).
        params_grads = []
        opt_ops = []
        self._table_opt_ops: Dict[str, object] = {}
        for op in block.ops:
            if op.type in OPTIMIZER_OP_TYPES:
                p = op.input("Param")[0]
                g = op.input("Grad")[0]
                if p in self.dist_tables:
                    self._table_opt_ops[p] = op
                    self.dist_tables[p]["grad"] = g
                    continue
                opt_ops.append(op)
                params_grads.append((p, g))
        self.params_grads = params_grads
        self._opt_ops = opt_ops

        if self.dist_tables:
            self._rewrite_dist_table_ops(block, eps_all)
            # the trainer never touches the table itself (pull/push only)
            # — initializing the FULL table on every trainer would OOM at
            # exactly the giant-vocab scale this path exists for. The
            # init ops move aside for get_startup_program, which copies
            # them (slice-shaped) into each SERVER's startup.
            sblk = self.startup_program.global_block()
            self._table_init_ops = [
                op for op in sblk.ops
                if any(o in self.dist_tables for o in op.output_arg_names)
            ]
            moved = set(id(op) for op in self._table_init_ops)
            sblk.ops = [op for op in sblk.ops if id(op) not in moved]

        # dense block-slicing (reference :95 wired into :540): a large
        # dense param is split into row blocks spread over pservers —
        # the trainer splits its grad, sends each block to its server,
        # and concats the recv'd param blocks back; each server runs
        # the optimizer on just its block
        eps = self.pserver_endpoints
        self.dense_blocks: Dict[str, List[dict]] = {}
        self._block_origin: Dict[str, tuple] = {}
        if self.config.slice_var_up and len(eps) > 1:
            for (p, g) in params_grads:
                v = block._find_var_recursive(p)
                if v is None or not v.shape:
                    continue
                vb = slice_variable([v], len(eps),
                                    self.config.min_block_size)
                if len(vb) <= 1:
                    continue
                dim1 = 1
                for s in v.shape[1:]:
                    dim1 *= int(s)
                rows = [b.size // max(dim1, 1) for b in vb]
                entries = []
                for k, r in enumerate(rows):
                    pb = "%s.block%d" % (p, k)
                    gb = "%s.block%d" % (g, k)
                    entries.append({"pname": pb, "gname": gb,
                                    "rows": r, "bidx": k,
                                    "origin_grad": g})
                    self._block_origin[pb] = (p, r, k)
                    self._block_origin[gb] = (g, r, k)
                self.dense_blocks[p] = entries

        # round-robin placement units: whole params AND blocks share
        # one rolling counter (RoundRobin dispatcher)
        self.param_to_ep: Dict[str, str] = {}
        self.grad_to_ep: Dict[str, str] = {}
        unit = 0
        for (p, g) in params_grads:
            if p in self.dense_blocks:
                for e in self.dense_blocks[p]:
                    e["ep"] = eps[unit % len(eps)]
                    unit += 1
            else:
                self.param_to_ep[p] = eps[unit % len(eps)]
                self.grad_to_ep[g] = eps[unit % len(eps)]
                unit += 1

        new_ops = [op for op in block.ops if op.type not in OPTIMIZER_OP_TYPES]

        def _append(op_type, ins, outs, attrs):
            op = framework.Operator(block, op_type, ins, outs, attrs)
            op._id = self.origin_program._next_op_id()
            new_ops.append(op)

        # block vars on the trainer (grad splits + recv'd param blocks)
        for p, entries in self.dense_blocks.items():
            v = block._find_var_recursive(p)
            tail = list(v.shape[1:])
            g = entries[0]["origin_grad"]
            for e in entries:
                block.create_var(name=e["pname"],
                                 shape=[e["rows"]] + tail, dtype=v.dtype)
                block.create_var(name=e["gname"],
                                 shape=[e["rows"]] + tail, dtype=v.dtype)
            _append("split", {"X": [g]},
                    {"Out": [e["gname"] for e in entries]},
                    {"sections": [e["rows"] for e in entries],
                     "axis": 0})

        # send grads -> barrier -> recv params -> barrier (sync mode)
        for p, g in params_grads:
            if p in self.dense_blocks:
                for e in self.dense_blocks[p]:
                    _append("send", {"X": [e["gname"]]}, {"Out": []},
                            {"epmap": [e["ep"]], "sync_mode": sync_mode,
                             "table_name": e["gname"]})
            else:
                _append("send", {"X": [g]}, {"Out": []},
                        {"epmap": [self.grad_to_ep[g]],
                         "sync_mode": sync_mode, "table_name": g})
        if sync_mode:
            _append("send_barrier", {}, {},
                    {"endpoints": eps, "trainer_id": trainer_id})
        for p, g in params_grads:
            if p in self.dense_blocks:
                for e in self.dense_blocks[p]:
                    _append("recv", {}, {"Out": [e["pname"]]},
                            {"epmap": [e["ep"]],
                             "table_name": e["pname"]})
                _append("concat",
                        {"X": [e["pname"]
                               for e in self.dense_blocks[p]]},
                        {"Out": [p]}, {"axis": 0})
            else:
                _append("recv", {}, {"Out": [p]},
                        {"epmap": [self.param_to_ep[p]],
                         "table_name": p})
        if sync_mode:
            _append("fetch_barrier", {}, {},
                    {"endpoints": eps, "trainer_id": trainer_id})
        block.ops = new_ops
        self._transpiled = True

    def _rewrite_dist_table_ops(self, block, eps):
        """Swap each distributed table's lookup for a sparse pull, its
        grad op for a sparse push, and drop its trainer-side optimizer
        op (the update happens on the hosting pservers)."""
        new_ops = []
        for op in block.ops:
            if op.type in ("lookup_table", "lookup_table_v2") \
                    and op.input("W")[0] in self.dist_tables:
                w = op.input("W")[0]
                t = self.dist_tables[w]
                nop = framework.Operator(
                    block, "distributed_lookup_table",
                    {"Ids": [op.input("Ids")[0]]},
                    {"Outputs": [op.output("Out")[0]]},
                    {"table_name": w, "endpoints": list(eps),
                     "row_starts": t["starts"], "row_counts": t["counts"],
                     "embed_dim": t["dim"], "squeeze_last": t["squeeze"],
                     "padding_idx": t["padding_idx"],
                     "dtype": str(t.get("dtype", "float32"))})
                nop._id = self.origin_program._next_op_id()
                new_ops.append(nop)
                continue
            if op.type in ("lookup_table_grad", "lookup_table_v2_grad",
                           "lookup_table_sparse_grad") \
                    and op.input("W") \
                    and op.input("W")[0] in self.dist_tables:
                w = op.input("W")[0]
                t = self.dist_tables[w]
                nop = framework.Operator(
                    block, "distributed_push_sparse",
                    {"Ids": [op.input("Ids")[0]],
                     "OutGrad": [op.input("Out@GRAD")[0]]},
                    {},
                    {"table_name": w, "grad_name": t.get("grad",
                                                         w + "@GRAD"),
                     "endpoints": list(eps),
                     "row_starts": t["starts"], "row_counts": t["counts"],
                     "squeeze_last": t["squeeze"],
                     "padding_idx": t["padding_idx"]})
                nop._id = self.origin_program._next_op_id()
                new_ops.append(nop)
                continue
            if op.type in OPTIMIZER_OP_TYPES \
                    and op.input("Param")[0] in self.dist_tables:
                continue  # applied server-side per push
            if op.type == "sum" and op.output("Out") \
                    and any(op.output("Out")[0] == t.get("grad")
                            for t in self.dist_tables.values()):
                # a shared table looked up N times sums N grad partials;
                # each partial became its own sparse push, so the sum
                # (whose inputs no longer exist) goes too
                continue
            new_ops.append(op)
        block.ops = new_ops

    def get_trainer_program(self, wait_port=True):
        if not self._transpiled:
            raise RuntimeError("transpile() first")
        return self.origin_program

    def get_pserver_program(self, endpoint):
        """Server program for one endpoint (reference :1146): one
        listen_and_serv op whose sub-blocks run each hosted param's
        optimizer op against incoming grads."""
        if not self._transpiled:
            raise RuntimeError("transpile() first")
        pserver_program = framework.Program()
        pblock = pserver_program.global_block()
        hosted = [(p, g) for (p, g) in self.params_grads
                  if p not in self.dense_blocks
                  and self.param_to_ep[p] == endpoint]
        origin_block = self.origin_program.global_block()
        opt_blocks = []
        grad_to_block_id = []

        # dense row-blocks hosted here: the optimizer sub-block runs on
        # the BLOCK (param/grad/accumulators all block-shaped)
        for p, entries in self.dense_blocks.items():
            g = entries[0]["origin_grad"]
            pv = origin_block._find_var_recursive(p)
            tail = list(pv.shape[1:])
            full_rows = int(pv.shape[0])
            for e in entries:
                if e["ep"] != endpoint:
                    continue
                sfx = ".block%d" % e["bidx"]
                pblock.create_var(name=e["pname"],
                                  shape=[e["rows"]] + tail,
                                  dtype=pv.dtype, persistable=True)
                pblock.create_var(name=e["gname"],
                                  shape=[e["rows"]] + tail,
                                  dtype=pv.dtype)
                sub = pserver_program._create_block()
                for op in self._opt_ops:
                    if op.input("Param")[0] != p:
                        continue

                    def _map(names):
                        out = []
                        for n in names:
                            if n == p:
                                out.append(e["pname"])
                            elif n == g:
                                out.append(e["gname"])
                            else:
                                v = origin_block._find_var_recursive(n)
                                if (v is not None and v.shape
                                        and tuple(v.shape)
                                        and int(v.shape[0]) == full_rows
                                        and list(v.shape[1:]) == tail):
                                    # full-shaped accumulator
                                    # (velocity/moment): block slice
                                    bn = n + sfx
                                    if not pblock.has_var_local(bn):
                                        pblock.create_var(
                                            name=bn,
                                            shape=[e["rows"]] + tail,
                                            dtype=v.dtype,
                                            persistable=True)
                                    self._block_origin.setdefault(
                                        bn, (n, e["rows"], e["bidx"]))
                                    out.append(bn)
                                else:
                                    if v is not None and \
                                            not pblock.has_var_local(n):
                                        pblock.create_var(
                                            name=n, shape=v.shape,
                                            dtype=v.dtype,
                                            persistable=v.persistable)
                                    out.append(n)
                        return out

                    nop = framework.Operator(
                        sub, op.type,
                        {k: _map(vv) for k, vv in op.inputs.items()},
                        {k: _map(vv) for k, vv in op.outputs.items()},
                        dict(op.attrs))
                    nop._id = pserver_program._next_op_id()
                    sub.ops.append(nop)
                pserver_program._rollback()
                opt_blocks.append(sub)
                grad_to_block_id.append("%s:%d" % (e["gname"], sub.idx))

        for p, g in hosted:
            pv = origin_block._find_var_recursive(p)
            pblock.create_var(name=p, shape=pv.shape, dtype=pv.dtype,
                              persistable=True)
            gv = origin_block._find_var_recursive(g)
            pblock.create_var(name=g, shape=None if gv is None else gv.shape,
                              dtype="float32" if gv is None else gv.dtype)
            sub = pserver_program._create_block()
            for op in self._opt_ops:
                if op.input("Param")[0] != p:
                    continue
                # copy the optimizer op (and its aux vars) into the sub
                for name in op.input_arg_names:
                    v = origin_block._find_var_recursive(name)
                    if v is not None and not pblock.has_var_local(name):
                        pblock.create_var(name=name, shape=v.shape,
                                          dtype=v.dtype,
                                          persistable=v.persistable)
                nop = framework.Operator(
                    sub, op.type,
                    {k: list(vv) for k, vv in op.inputs.items()},
                    {k: list(vv) for k, vv in op.outputs.items()},
                    dict(op.attrs))
                nop._id = pserver_program._next_op_id()
                sub.ops.append(nop)
            pserver_program._rollback()
            opt_blocks.append(sub)
            grad_to_block_id.append("%s:%d" % (g, sub.idx))

        # distributed sparse-table slices hosted here: the var holds
        # THIS endpoint's row block [count, dim]; the sparse push writes
        # a SelectedRows grad (LOCAL rows) and runs the optimizer
        # sub-block, whose kernels take the sparse path
        ep_idx = self.pserver_endpoints.index(endpoint)
        for w, t in getattr(self, "dist_tables", {}).items():
            count = t["counts"][ep_idx]
            if count <= 0:
                continue
            pblock.create_var(name=w, shape=[count, t["dim"]],
                              dtype=t.get("dtype", "float32"),
                              persistable=True)
            gname = t.get("grad", w + "@GRAD")
            pblock.create_var(name=gname, shape=None,
                              dtype=t.get("dtype", "float32"))
            opt = getattr(self, "_table_opt_ops", {}).get(w)
            sub = pserver_program._create_block()
            if opt is not None:
                for name in opt.input_arg_names:
                    v = origin_block._find_var_recursive(name)
                    if v is not None and not pblock.has_var_local(name):
                        shape = v.shape
                        if name not in (w, gname) and shape is not None \
                                and tuple(shape) and \
                                tuple(shape)[0] == t["starts"][-1] \
                                + t["counts"][-1]:
                            # optimizer accumulator shaped like the full
                            # table (momentum velocity): host the slice
                            shape = [count] + list(shape[1:])
                        pblock.create_var(name=name, shape=shape,
                                          dtype=v.dtype,
                                          persistable=v.persistable)
                nop = framework.Operator(
                    sub, opt.type,
                    {k: list(vv) for k, vv in opt.inputs.items()},
                    {k: list(vv) for k, vv in opt.outputs.items()},
                    dict(opt.attrs))
                nop._id = pserver_program._next_op_id()
                sub.ops.append(nop)
            pserver_program._rollback()
            opt_blocks.append(sub)
            grad_to_block_id.append("%s:%d" % (gname, sub.idx))

        op = framework.Operator(
            pblock, "listen_and_serv", {"X": []}, {},
            {"endpoint": endpoint,
             "optimize_blocks": opt_blocks,
             "grad_to_block_id": grad_to_block_id,
             "sync_mode": self.sync_mode,
             "Fanin": self.trainer_num})
        op._id = pserver_program._next_op_id()
        pblock.ops.append(op)
        return pserver_program

    def get_startup_program(self, endpoint, pserver_program=None,
                            startup_program=None):
        """Startup program initializing everything the endpoint's server
        program references (params, optimizer accumulators, lr var)."""
        sp = framework.Program()
        blk = sp.global_block()
        src = (startup_program or self.startup_program).global_block()
        if pserver_program is not None:
            hosted = set()
            for b in pserver_program.blocks:
                for op in b.ops:
                    hosted.update(op.input_arg_names)
                    hosted.update(op.output_arg_names)
        else:
            hosted = {p for (p, g) in self.params_grads
                      if self.param_to_ep.get(p) == endpoint}
            hosted |= {e["pname"]
                       for entries in getattr(self, "dense_blocks",
                                              {}).values()
                       for e in entries if e["ep"] == endpoint}
        # distributed-table slices: this endpoint initializes only ITS
        # row block, so the copied init op's shape attr is overridden
        ep_idx = (self.pserver_endpoints.index(endpoint)
                  if endpoint in self.pserver_endpoints else -1)
        slice_shapes = {}
        if ep_idx >= 0:
            for w, t in getattr(self, "dist_tables", {}).items():
                count = t["counts"][ep_idx]
                if count > 0:
                    slice_shapes[w] = [count, t["dim"]]
                    full = t["starts"][-1] + t["counts"][-1]
                    opt = getattr(self, "_table_opt_ops", {}).get(w)
                    if opt is not None:
                        for name in opt.input_arg_names:
                            v = src._find_var_recursive(name)
                            if (v is not None and name != w
                                    and v.shape and tuple(v.shape)
                                    and tuple(v.shape)[0] == full):
                                slice_shapes[name] = \
                                    [count] + list(v.shape[1:])
        # dense row-blocks hosted here: each hosted block name maps
        # back to its origin var (_block_origin) so the origin's init
        # op is cloned once per block, outputs renamed + shape attr
        # overridden to the block shape. (Random inits are drawn
        # per-block — distribution-equivalent to slicing one draw.)
        origin_to_blocks: Dict[str, List[str]] = {}
        for bn, (orig, rows, k) in getattr(self, "_block_origin",
                                           {}).items():
            if bn in hosted:
                origin_to_blocks.setdefault(orig, []).append(bn)

        for op in list(src.ops) + list(getattr(self, "_table_init_ops",
                                               [])):
            outs = op.output_arg_names
            if any(o in hosted for o in outs):
                attrs = dict(op.attrs)
                for name in outs:
                    v = src._find_var_recursive(name)
                    shape = slice_shapes.get(name,
                                             v.shape if v is not None
                                             else None)
                    if v is not None and not blk.has_var_local(name):
                        blk.create_var(name=name, shape=shape,
                                       dtype=v.dtype, persistable=True)
                    if name in slice_shapes and "shape" in attrs:
                        attrs["shape"] = list(slice_shapes[name])
                nop = framework.Operator(
                    blk, op.type,
                    {k: list(vv) for k, vv in op.inputs.items()},
                    {k: list(vv) for k, vv in op.outputs.items()},
                    attrs)
                nop._id = sp._next_op_id()
                blk.ops.append(nop)
                continue
            block_outs = [o for o in outs if o in origin_to_blocks]
            if not block_outs:
                continue
            orig = block_outs[0]
            v = src._find_var_recursive(orig)
            tail = list(v.shape[1:]) if v is not None and v.shape \
                else []
            for bn in origin_to_blocks[orig]:
                _, rows, _k = self._block_origin[bn]
                attrs = dict(op.attrs)
                if "shape" in attrs:
                    attrs["shape"] = [rows] + tail
                if attrs.get("seed"):
                    # a seeded random init must not draw IDENTICAL
                    # blocks; derive a distinct per-block seed
                    attrs["seed"] = int(attrs["seed"]) + 7919 * (_k + 1)
                if not blk.has_var_local(bn):
                    blk.create_var(name=bn, shape=[rows] + tail,
                                   dtype=v.dtype if v is not None
                                   else "float32", persistable=True)
                nop = framework.Operator(
                    blk, op.type,
                    {k: list(vv) for k, vv in op.inputs.items()},
                    {k: [bn if n == orig else n for n in vv]
                     for k, vv in op.outputs.items()},
                    attrs)
                nop._id = sp._next_op_id()
                blk.ops.append(nop)
        return sp
