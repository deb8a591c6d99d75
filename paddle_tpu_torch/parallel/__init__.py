"""Data parallelism.

Counterpart of ``paddle_tpu/parallel/`` for its data-parallel half: the
mesh (``mesh_utils``), the engine behind
``CompiledProgram.with_data_parallel`` (``engine.run_data_parallel``), the
collective transpiler's passes (``transpiler``), the bucketed / quantized
allreduce and the cross-replica sharded weight update (``collectives``)
and the collective-schedule passes (``scheduling``). The hybrid axes
(pipeline, MoE, ring and Ulysses attention, the sharded embedding) are
ROADMAP.md's next slice.
"""
from .mesh_utils import Mesh, default_mesh, make_mesh  # noqa: F401
from .engine import run_data_parallel  # noqa: F401
from .transpiler import insert_allreduce_ops  # noqa: F401
