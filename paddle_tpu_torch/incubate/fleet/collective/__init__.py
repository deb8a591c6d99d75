"""Collective fleet mode (the reference's ``incubate/fleet/collective``:
``Collective(Fleet)``, ``CollectiveOptimizer``, ``DistributedStrategy``).

Counterpart of ``paddle_tpu/incubate/fleet/collective/__init__.py`` for
data parallelism: ``fleet.distributed_optimizer(opt, strategy).minimize``
runs the optimizer's minimize, then the collective transpiler (the loss
grad scaled by 1/nranks and a ``c_allreduce_sum`` for every grad; LocalSGD's
parameter averaging under ``use_local_sgd``), and ``fleet.main_program``
is the program compiled ``with_data_parallel``. ``nranks`` is the fleet's
``worker_num()``: the launcher's ``PADDLE_TRAINERS_NUM``, or a
``UserDefinedRoleMaker``'s count. The hybrid knobs (sharded embedding,
sequence, expert and pipeline parallelism) come with the hybrid slice
(ROADMAP.md): setting one raises.
"""
from __future__ import annotations

from ....compiler import BuildStrategy, CompiledProgram, ExecutionStrategy
from ..base.fleet_base import DistributedOptimizer, Fleet

_HYBRID_KNOBS = ("sharded_embedding", "sequence_parallel",
                 "expert_parallel", "pipeline")


class DistributedStrategy:
    """The knobs (the reference's DistributedStrategy extends
    BuildStrategy): LocalSGD, recompute and AMP among them."""

    def __init__(self):
        self.build_strategy = BuildStrategy()
        self.exec_strategy = ExecutionStrategy()
        self.nccl_comm_num = 1
        self.use_local_sgd = False
        self.local_sgd_k_steps = 1
        self.forward_recompute = False
        self.recompute_checkpoints = []
        self.use_amp = False
        self.amp_loss_scaling = 1.0
        self.sharded_embedding = False
        self.mp_degree = 1
        self.sequence_parallel = False
        self.sp_degree = 1
        self.feed_shard_specs = {}
        self.expert_parallel = False
        self.ep_degree = 1
        self.pipeline = False
        self.pipeline_cut_list = None
        self.pipeline_num_microbatches = 1


class Collective(Fleet):
    def __init__(self):
        super().__init__("collective")
        self._main_program = None
        self._compiled_program = None
        self._loss = None

    def distributed_optimizer(self, optimizer, strategy=None):
        self._optimizer = CollectiveOptimizer(optimizer, strategy, self)
        return self._optimizer

    def init_worker(self):
        pass

    def init_server(self, model_dir=None):
        raise NotImplementedError(
            "Collective mode has no servers; the parameter-server mode is "
            "not ported")

    def run_server(self):
        raise NotImplementedError(
            "Collective mode has no servers; the parameter-server mode is "
            "not ported")

    def stop_worker(self):
        pass

    def save_inference_model(self, executor, dirname, feeded_var_names,
                             target_vars, main_program=None,
                             export_for_deployment=True):
        from .... import io

        io.save_inference_model(dirname, feeded_var_names, target_vars,
                                executor, main_program or self._main_program)

    def save_persistables(self, executor, dirname, main_program=None):
        from .... import io

        io.save_persistables(executor, dirname,
                             main_program or self._main_program)

    @property
    def main_program(self):
        """The data-parallel program (the reference's fleet.main_program
        is the compiled program)."""
        return self._compiled_program or self._main_program


class CollectiveOptimizer(DistributedOptimizer):
    def __init__(self, optimizer, strategy=None, fleet_instance=None):
        super().__init__(optimizer, strategy or DistributedStrategy())
        self._fleet = fleet_instance

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        from ....parallel.transpiler import (insert_allreduce_ops,
                                             insert_local_sgd_ops,
                                             shard_optimizer_state)

        opt = self._optimizer
        strategy = self._strategy
        program = loss.block.program
        on = [k for k in _HYBRID_KNOBS if getattr(strategy, k, False)]
        if on:
            raise NotImplementedError(
                "DistributedStrategy.%s: the hybrid axes are not ported"
                % on[0])
        if getattr(strategy, "use_amp", False):
            from ....contrib import mixed_precision as mp

            opt = mp.decorate(opt)
        if getattr(strategy, "forward_recompute", False):
            from ....optimizer import RecomputeOptimizer

            opt = RecomputeOptimizer(opt)
            opt._set_checkpoints(strategy.recompute_checkpoints)
        optimize_ops, params_grads = opt.minimize(
            loss, startup_program, parameter_list, no_grad_set)
        shard_optimizer_state(program)
        nranks = self._fleet.worker_num() if self._fleet else 1
        if nranks > 1:
            insert_allreduce_ops(program, nranks)
            if getattr(strategy, "use_local_sgd", False):
                insert_local_sgd_ops(program, nranks,
                                     strategy.local_sgd_k_steps)
        if self._fleet is not None:
            self._fleet._main_program = program
            self._fleet._loss = loss
            self._fleet._compiled_program = CompiledProgram(
                program).with_data_parallel(
                    loss_name=loss.name,
                    build_strategy=strategy.build_strategy,
                    exec_strategy=strategy.exec_strategy)
        return optimize_ops, params_grads


fleet = Collective()
