"""Geo-SGD transpiler (the port of
``paddle_tpu/transpiler/geo_sgd_transpiler.py``).

Geo-SGD trains locally and ships PARAMETER DELTAS every
``geo_sgd_need_push_nums`` steps instead of per-step gradients: the
trainer keeps its optimizer ops (unlike the sync PS rewrite, which
strips them), snapshots each param into ``<p>.geo.snapshot``, and a
step-gated ``geo_send`` op emits (param - snapshot) to the param's
pserver, then refreshes the snapshot. The pserver applies deltas with
plain additions.
"""
from __future__ import annotations

from typing import Dict

from .. import framework
from .distribute_transpiler import (
    DistributeTranspiler, DistributeTranspilerConfig, OPTIMIZER_OP_TYPES)


class GeoSgdTranspiler(DistributeTranspiler):
    def __init__(self, config=None):
        super().__init__(config or DistributeTranspilerConfig())

    def transpile(self, trainer_id, program=None,
                  pservers="127.0.0.1:6174", trainers=1, sync_mode=False,
                  startup_program=None,
                  current_endpoint="127.0.0.1:6174"):
        self.origin_program = program or framework.default_main_program()
        self.startup_program = (startup_program
                                or framework.default_startup_program())
        self.trainer_id = trainer_id
        self.trainer_num = trainers
        self.sync_mode = False  # geo is async by definition
        self.pserver_endpoints = (pservers.split(",")
                                  if isinstance(pservers, str) else
                                  list(pservers))
        push_nums = int(getattr(self.config, "geo_sgd_need_push_nums", 100))

        block = self.origin_program.global_block()
        params_grads = []
        for op in block.ops:
            if op.type in OPTIMIZER_OP_TYPES:
                params_grads.append((op.input("Param")[0],
                                     op.input("Grad")[0]))
        self.params_grads = params_grads
        self._opt_ops = [op for op in block.ops
                         if op.type in OPTIMIZER_OP_TYPES]

        eps = self.pserver_endpoints
        self.param_to_ep: Dict[str, str] = {}
        for i, (p, _g) in enumerate(params_grads):
            self.param_to_ep[p] = eps[i % len(eps)]

        # keep optimizer ops (local training); append one step-gated
        # delta-push per param — geo_send itself computes param-snapshot
        # at push time and refreshes the snapshot, so deltas accumulate
        # locally between pushes
        startup_block = self.startup_program.global_block()
        for p, _g in params_grads:
            pv = block._find_var_recursive(p)
            snap = block.create_var(name="%s.geo.snapshot" % p,
                                    shape=pv.shape, dtype=pv.dtype,
                                    persistable=True)
            # snapshot starts EQUAL to the initialized param (first
            # delta must be the local progress, not the full weights) —
            # appended after the param's initializer ops in startup
            startup_block.create_var(name=snap.name, shape=pv.shape,
                                     dtype=pv.dtype, persistable=True)
            startup_block.append_op(
                "assign", {"X": [p]}, {"Out": [snap.name]}, {},
                infer_shape=False)
            block.append_op(
                "geo_send", {"Param": [p], "Snapshot": [snap.name]},
                {"SnapshotOut": [snap.name]},
                {"epmap": [self.param_to_ep[p]], "table_name": p,
                 "push_nums": push_nums, "trainers": trainers},
                infer_shape=False)
        self._transpiled = True

    def get_pserver_program(self, endpoint):
        """Delta-apply server (reference get_pserver_program shape): one
        listen_and_serv whose per-param sub-blocks run param += delta;
        geo_send routes each pushed delta to its sub-block via
        grad_to_block_id, like regular send."""
        if not self._transpiled:
            raise RuntimeError("transpile() first")
        prog = framework.Program()
        pblock = prog.global_block()
        hosted = [p for (p, _g) in self.params_grads
                  if self.param_to_ep[p] == endpoint]
        origin_block = self.origin_program.global_block()
        opt_blocks, delta_names = [], []
        for p in hosted:
            pv = origin_block._find_var_recursive(p)
            pblock.create_var(name=p, shape=pv.shape, dtype=pv.dtype,
                              persistable=True)
            dname = "%s.geo.delta" % p
            pblock.create_var(name=dname, shape=pv.shape, dtype=pv.dtype)
            sub = prog._create_block()
            op = framework.Operator(
                sub, "elementwise_add", {"X": [p], "Y": [dname]},
                {"Out": [p]}, {"axis": -1})
            op._id = prog._next_op_id()
            sub.ops.append(op)
            prog._rollback()
            opt_blocks.append(sub)
            delta_names.append(dname)
        op = framework.Operator(
            pblock, "listen_and_serv", {"X": []}, {},
            {"endpoint": endpoint, "optimize_blocks": opt_blocks,
             "grad_to_block_id": ["%s:%d" % (d, b.idx) for d, b in
                                  zip(delta_names, opt_blocks)],
             "sync_mode": False, "Fanin": self.trainer_num})
        op._id = prog._next_op_id()
        pblock.ops.append(op)
        return prog
