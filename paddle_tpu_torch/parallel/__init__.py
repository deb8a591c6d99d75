"""Distributed and parallel execution.

Counterpart of ``paddle_tpu/parallel/``: the mesh of one or more named
axes (``mesh_utils``), the engine behind
``CompiledProgram.with_data_parallel`` (``engine.run_data_parallel``: the
data axes and the model axes), the collective transpiler's passes, the
data-parallel ones and the hybrid ones (``transpiler``), the bucketed /
quantized allreduce and the cross-replica sharded weight update
(``collectives``), the collective-schedule passes (``scheduling``), and
the hybrid axes: ring and Ulysses attention (``ring_attention``), the
row-sharded embedding (``sharded_embedding``), expert-parallel MoE
(``moe``) and the GPipe pipeline (``pipeline``).
"""
from .mesh_utils import Mesh, default_mesh, make_mesh  # noqa: F401
from .engine import run_data_parallel  # noqa: F401
from .transpiler import insert_allreduce_ops  # noqa: F401
from .ring_attention import (  # noqa: F401
    ring_attention, sequence_parallel_attention, ulysses_attention)
from .moe import expert_parallel_moe, moe_reference  # noqa: F401
from .pipeline import (  # noqa: F401
    run_pipeline_parallel, split_forward_at_cuts)
