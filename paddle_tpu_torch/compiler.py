"""CompiledProgram / BuildStrategy / ExecutionStrategy.

Counterpart of ``paddle_tpu/compiler.py`` (the reference's
``fluid/compiler.py``: ``CompiledProgram``, ``with_data_parallel``, and the
``details/build_strategy.h`` knobs). ``with_data_parallel`` marks the
program for the data-parallel engine (``parallel/engine.py``): the replicas
of ``places`` run the transpiled program in lockstep, the feeds split on
the batch axis, the grads summed over the replicas. ``Executor.run`` routes
a ``CompiledProgram`` here; one that is not data parallel runs its plain
program.
"""
from __future__ import annotations

from typing import Optional


class ExecutionStrategy:
    def __init__(self):
        self.num_threads = 0
        self.num_iteration_per_drop_scope = 100
        self.num_iteration_per_run = 1
        self.use_thread_barrier = True


class BuildStrategy:
    """The knobs and what the port does with each:

    - implemented: ``sync_batch_norm`` (batch statistics reduced over the
      replicas), ``gradient_scale_strategy`` (CoeffNumDevice scales the
      loss grad by 1/n; One and Customized leave it to the user),
      ``fuse_all_reduce_ops`` (the bucketed allreduce; False turns it off)
      and ``fuse_all_optimizer_ops`` (the cross-replica sharded update);
    - subsumed, accepted and ignored: the fusion knobs, ``enable_inplace``
      / ``memory_optimize`` (the captured step's memory pool),
      ``remove_unnecessary_lock``, ``reduce_strategy``;
    - inert, warned when enabled: ``enable_sequential_execution`` (every
      step runs in program order already).
    """

    class ReduceStrategy:
        AllReduce = 0
        Reduce = 1

    class GradientScaleStrategy:
        CoeffNumDevice = 0
        One = 1
        Customized = 2

    _SUBSUMED = {"fuse_elewise_add_act_ops", "fuse_bn_act_ops",
                 "enable_inplace", "memory_optimize",
                 "remove_unnecessary_lock", "reduce_strategy"}
    _INERT = {"enable_sequential_execution"}

    def __init__(self):
        self.reduce_strategy = BuildStrategy.ReduceStrategy.AllReduce
        self.gradient_scale_strategy = (
            BuildStrategy.GradientScaleStrategy.CoeffNumDevice)
        self.fuse_elewise_add_act_ops = False
        self.fuse_bn_act_ops = False
        self.fuse_all_reduce_ops = True
        self.fuse_all_optimizer_ops = False
        self.enable_inplace = True
        self.memory_optimize = None
        self.sync_batch_norm = False
        self.enable_sequential_execution = False
        self.remove_unnecessary_lock = True
        self.num_trainers = 1
        self.trainer_id = 0
        self.nccl_comm_num = 1

    def _warn_inert(self):
        import warnings

        for k in sorted(self._INERT):
            if getattr(self, k, False):
                warnings.warn("BuildStrategy.%s has no effect in the port "
                              "(every step runs in program order); the "
                              "knob is ignored" % k)


class CompiledProgram:
    def __init__(self, program_or_graph,
                 build_strategy: Optional[BuildStrategy] = None):
        self._program = program_or_graph
        self._build_strategy = build_strategy or BuildStrategy()
        self._is_data_parallel = False
        self._loss_name = None
        self._exec_strategy = None
        self._places = None
        self._share_vars_from = None

    def with_data_parallel(self, loss_name=None, build_strategy=None,
                           exec_strategy=None, share_vars_from=None,
                           places=None):
        """Run the program over ``places`` (a list of places, one replica
        each, a place named more than once allowed; a
        ``parallel.Mesh``; default: one replica a visible card, or a
        process of a ``torch.distributed`` world)."""
        self._is_data_parallel = True
        self._loss_name = loss_name
        if build_strategy is not None:
            self._build_strategy = build_strategy
        self._exec_strategy = exec_strategy or ExecutionStrategy()
        self._places = places
        self._share_vars_from = share_vars_from
        return self

    def _run(self, executor, feed, fetch_list, scope, return_numpy):
        """Called by ``Executor.run``."""
        if not self._is_data_parallel:
            return executor.run(self._program, feed=feed,
                                fetch_list=fetch_list, scope=scope,
                                return_numpy=return_numpy)
        # a pipelined program (PipelineOptimizer's metadata) over a mesh
        # with a pp axis takes the pipeline engine: dp replicas of the
        # pipeline and the model axes inside the stages
        from .parallel.mesh_utils import Mesh

        mesh = self._places if isinstance(self._places, Mesh) else None
        if mesh is not None and "pp" in mesh.axis_names and \
                getattr(self._program, "_pipeline_meta", None):
            from .parallel.pipeline import run_pipeline_parallel

            return run_pipeline_parallel(
                executor._core, self._program, scope, feed, fetch_list,
                mesh=mesh, return_numpy=return_numpy)
        from .parallel.engine import run_data_parallel

        return run_data_parallel(
            executor._core, self._program, scope, feed, fetch_list,
            loss_name=self._loss_name, places=self._places,
            build_strategy=self._build_strategy, return_numpy=return_numpy)
