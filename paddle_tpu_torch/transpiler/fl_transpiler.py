"""Federated-learning transpiler (the port of
``paddle_tpu/transpiler/fl_transpiler.py``; the contract of the
reference's ``fl_listen_and_serv_op.cc`` test).

Round protocol per trainer: run ``get_trainer_recv_program()`` (pull
the global params), run the UNMODIFIED main program for the local
epoch, run ``get_trainer_send_program()`` (push locally-trained
params); the server (``get_pserver_program(ep)``) FedAvg-means each
param once all ``trainers`` copies arrive.
"""
from __future__ import annotations

from .. import framework

__all__ = ["FlDistributeTranspiler"]


class FlDistributeTranspiler:
    def transpile(self, trainer_id, program=None, startup_program=None,
                  pservers="127.0.0.1:6174", trainers=1):
        self.trainer_id = trainer_id
        self.main_program = program or framework.default_main_program()
        self.startup_program = (startup_program
                                or framework.default_startup_program())
        self.pserver_endpoints = [e.strip() for e in pservers.split(",")
                                  if e.strip()]
        self.trainers = int(trainers)
        params = [p.name for p in
                  self.main_program.global_block().all_parameters]
        # params round-robin over endpoints (slice_variable-style
        # placement is unnecessary: FL ships whole params per round)
        self.param_to_ep = {
            p: self.pserver_endpoints[i % len(self.pserver_endpoints)]
            for i, p in enumerate(sorted(params))}

    # -- trainer side ------------------------------------------------------

    def _param_vars(self, block, endpoint=None):
        """Mirror (hosted) param vars into `block`; optionally only the
        ones assigned to `endpoint`."""
        for name in sorted(self.param_to_ep):
            if endpoint is not None and \
                    self.param_to_ep[name] != endpoint:
                continue
            src = self.main_program.global_block().var(name)
            v = block.create_var(name=name, dtype=src.dtype,
                                 persistable=True)
            if src.shape is not None:
                v.shape = tuple(src.shape)
            yield name, v

    def get_trainer_recv_program(self):
        prog = framework.Program()
        blk = prog.global_block()
        names, eps = [], []
        for name, _v in self._param_vars(blk):
            names.append(name)
            eps.append(self.param_to_ep[name])
        blk.append_op("recv", {}, {"Out": names}, {"epmap": eps},
                      infer_shape=False)
        return prog

    def get_trainer_send_program(self):
        prog = framework.Program()
        blk = prog.global_block()
        names, eps = [], []
        for name, _v in self._param_vars(blk):
            names.append(name)
            eps.append(self.param_to_ep[name])
        blk.append_op("send", {"X": names}, {},
                      {"epmap": eps, "sync_mode": True},
                      infer_shape=False)
        return prog

    # -- server side -------------------------------------------------------

    def get_pserver_program(self, endpoint):
        prog = framework.Program()
        blk = prog.global_block()
        hosted = [name for name, _v in self._param_vars(blk, endpoint)]
        blk.append_op("fl_listen_and_serv", {"X": hosted}, {},
                      {"endpoint": endpoint,
                       "Fanin": self.trainers,
                       "sync_mode": True},
                      infer_shape=False)
        return prog

    def get_startup_program(self, endpoint, pserver_program=None):
        """Initialize the endpoint's hosted params with the SAME init
        ops the trainer startup uses (every FL round starts from the
        server's globals)."""
        sp = framework.Program()
        blk = sp.global_block()
        src_blk = self.startup_program.global_block()
        hosted = {name for name, _v in self._param_vars(blk, endpoint)}
        for op in src_blk.ops:
            outs = [n for ns in op.outputs.values() for n in ns]
            if any(o in hosted for o in outs):
                blk.append_op(op.type, {k: list(v) for k, v in
                                        op.inputs.items()},
                              {k: list(v) for k, v in
                               op.outputs.items()},
                              dict(op.attrs), infer_shape=False)
        return sp
