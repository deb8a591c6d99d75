"""Collective fleet mode (the reference's ``incubate/fleet/collective``:
``Collective(Fleet)``, ``CollectiveOptimizer``, ``DistributedStrategy``).

Counterpart of ``paddle_tpu/incubate/fleet/collective/__init__.py``:
``fleet.distributed_optimizer(opt, strategy).minimize`` runs the hybrid
passes the strategy asks for (before the backward, so that it
differentiates through the collective-aware ops), the optimizer's
minimize (wrapped in ``PipelineOptimizer`` under ``pipeline``), then the
collective transpiler (the loss grad scaled by 1/nranks and a
``c_allreduce_sum`` for every grad but those sharded over a data axis;
LocalSGD's parameter averaging under ``use_local_sgd``), and
``fleet.main_program`` is the program compiled ``with_data_parallel``.
``nranks`` is the fleet's ``worker_num()``: the launcher's
``PADDLE_TRAINERS_NUM``, or a ``UserDefinedRoleMaker``'s count.
"""
from __future__ import annotations

from ....compiler import BuildStrategy, CompiledProgram, ExecutionStrategy
from ..base.fleet_base import DistributedOptimizer, Fleet


class DistributedStrategy:
    """The knobs (the reference's DistributedStrategy extends
    BuildStrategy): LocalSGD, recompute and AMP among them, and the hybrid
    axes, each a program pass:

    - ``sharded_embedding`` (+ ``mp_degree``): every embedding table
      row-sharded over an ``mp`` axis;
    - ``sequence_parallel`` (+ ``sp_degree``, ``feed_shard_specs``):
      attention as ring attention over an ``sp`` axis;
      ``feed_shard_specs`` gives the feeds' layouts, e.g. ``{"x": ("dp",
      None, "sp")}``;
    - ``expert_parallel`` (+ ``ep_degree``): MoE experts sharded over an
      ``ep`` axis;
    - ``pipeline`` (+ ``pipeline_cut_list``,
      ``pipeline_num_microbatches``): stages over a ``pp`` axis, with a
      data axis of stage replicas and the model axes inside the stages.

    The rewritten program still runs densely on one device (the ops fall
    back to exact dense math)."""

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
            "Collective mode has no servers; use the transpiler PS mode")

    def run_server(self):
        raise NotImplementedError(
            "Collective mode has no servers; use the transpiler PS mode")

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
        from ....parallel.transpiler import (apply_expert_parallel,
                                             apply_sequence_parallel,
                                             apply_sharded_embedding,
                                             insert_allreduce_ops,
                                             insert_local_sgd_ops,
                                             shard_optimizer_state)

        opt = self._optimizer
        strategy = self._strategy
        program = loss.block.program
        if getattr(strategy, "sharded_embedding", False):
            from .... import framework

            apply_sharded_embedding(
                program, "mp", int(strategy.mp_degree or 0),
                startup_program=(startup_program
                                 or framework.default_startup_program()))
        if getattr(strategy, "sequence_parallel", False):
            from .... import framework

            apply_sequence_parallel(
                program, "sp", int(strategy.sp_degree or 0),
                feed_specs=getattr(strategy, "feed_shard_specs", None),
                startup_program=(startup_program
                                 or framework.default_startup_program()))
        if getattr(strategy, "expert_parallel", False):
            apply_expert_parallel(program, "ep",
                                  int(strategy.ep_degree or 1))
        if getattr(strategy, "use_amp", False):
            from ....contrib import mixed_precision as mp

            opt = mp.decorate(opt)
        if getattr(strategy, "forward_recompute", False):
            from ....optimizer import RecomputeOptimizer

            opt = RecomputeOptimizer(opt)
            opt._set_checkpoints(strategy.recompute_checkpoints)
        if getattr(strategy, "pipeline", False):
            from ....optimizer import PipelineOptimizer

            opt = PipelineOptimizer(
                opt, cut_list=strategy.pipeline_cut_list,
                num_microbatches=int(
                    strategy.pipeline_num_microbatches or 1))
        optimize_ops, params_grads = opt.minimize(
            loss, startup_program, parameter_list, no_grad_set)
        shard_optimizer_state(program)
        nranks = self._fleet.worker_num() if self._fleet else 1
        if nranks > 1:
            # skip only the grads sharded over a data axis
            skip_axes = getattr(program, "_allreduce_skip_grads",
                                None) or {}
            data_axes = set(getattr(program, "_data_axes", None)
                            or ("dp",))
            insert_allreduce_ops(
                program, nranks,
                skip_grads={g for g, axes in skip_axes.items()
                            if set(axes) & data_axes})
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
