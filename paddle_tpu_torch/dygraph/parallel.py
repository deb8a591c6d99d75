"""Dygraph DataParallel.

Counterpart of ``paddle_tpu/dygraph/parallel.py`` (the reference's
``dygraph/parallel.py``: ``DataParallel``, ``scale_loss``,
``apply_collective_grads``; and its NCCL parallel context). Rank and world
come from the launcher's PADDLE_* env vars (``distributed/launch.py``);
``prepare_context`` initializes ``torch.distributed`` with them: NCCL where
every rank can have a card of its own, gloo otherwise (CPU tensors, or
more ranks than cards).
``apply_collective_grads`` coalesces the grads into one flat float32
buffer (one collective, not one a parameter), sums it over the ranks with
``torch.distributed.all_reduce`` and splits it back, each grad in its own
dtype.
"""
from __future__ import annotations

import os

import torch

from .layers import Layer
from .varbase import _is_pending

__all__ = ["prepare_context", "ParallelEnv", "DataParallel", "Env",
           "backend_for"]


class ParallelEnv:
    def __init__(self):
        self._nranks = int(os.getenv("PADDLE_TRAINERS_NUM", "1"))
        self._local_rank = int(os.getenv("PADDLE_TRAINER_ID", "0"))
        self._dev_id = int(os.getenv("FLAGS_selected_gpus",
                                     os.getenv("FLAGS_selected_tpus", "0")))
        eps = os.getenv("PADDLE_TRAINER_ENDPOINTS", "")
        self._trainer_endpoints = eps.split(",") if eps else []
        self._current_endpoint = os.getenv("PADDLE_CURRENT_ENDPOINT", "")

    @property
    def nranks(self):
        return self._nranks

    @property
    def local_rank(self):
        return self._local_rank

    @property
    def dev_id(self):
        return self._dev_id

    @property
    def current_endpoint(self):
        return self._current_endpoint

    @property
    def trainer_endpoints(self):
        return self._trainer_endpoints


Env = ParallelEnv


def backend_for(nranks: int) -> str:
    """NCCL where the host shows a card for every rank, gloo otherwise."""
    if torch.cuda.is_available() and torch.cuda.device_count() >= nranks:
        return "nccl"
    return "gloo"


def prepare_context(strategy=None):
    """Join the job: ``torch.distributed.init_process_group`` over the
    first trainer endpoint (``tcp://host:port``), this rank, the world
    size. A no-op on one rank or when already initialized."""
    env = ParallelEnv()
    if env.nranks > 1:
        import torch.distributed as dist

        if not dist.is_initialized():
            if not env.trainer_endpoints:
                raise RuntimeError(
                    "prepare_context: PADDLE_TRAINER_ENDPOINTS is unset; "
                    "start the ranks with paddle_tpu_torch.distributed."
                    "launch")
            dist.init_process_group(
                backend_for(env.nranks),
                init_method="tcp://%s" % env.trainer_endpoints[0],
                world_size=env.nranks, rank=env.local_rank)
    return env


def _value(t):
    return t.force() if t is not None and _is_pending(t) else t


def _coalesce(grads):
    """One flat float32 buffer (mixed grad dtypes widened; ``_split_like``
    gives each grad its own dtype back)."""
    return torch.cat([g.to(torch.float32).reshape(-1) for g in grads])


def _split_like(flat, refs):
    out, off = [], 0
    for r in refs:
        n = r.numel()
        out.append(flat[off:off + n].reshape(r.shape).to(r.dtype))
        off += n
    return out


def _allreduce_across_processes(flat):
    import torch.distributed as dist

    out = flat.clone()
    dist.all_reduce(out)
    return out


class DataParallel(Layer):
    def __init__(self, layers, strategy=None):
        super().__init__()
        self._layers = layers
        self._strategy = strategy or ParallelEnv()
        nr = getattr(self._strategy, "nranks", None)
        self._nranks = nr if nr is not None else ParallelEnv().nranks

    def forward(self, *inputs, **kwargs):
        return self._layers(*inputs, **kwargs)

    def scale_loss(self, loss):
        if self._nranks <= 1:
            return loss
        from .tracer import current_tracer

        return current_tracer().trace_op(
            "scale", {"X": loss}, {},
            {"scale": 1.0 / self._nranks, "bias": 0.0})["Out"][0]

    @property
    def _sub(self):
        return self._layers

    def parameters(self, include_sublayers=True):
        return self._layers.parameters(include_sublayers)

    def state_dict(self, *args, **kwargs):
        return self._layers.state_dict(*args, **kwargs)

    def set_dict(self, *args, **kwargs):
        return self._layers.set_dict(*args, **kwargs)

    set_state_dict = set_dict

    def apply_collective_grads(self):
        """Sum every parameter's grad over the ranks: coalesced into one
        flat buffer, one all_reduce, split back."""
        if self._nranks <= 1:
            return
        params = [p for p in self.parameters() if p._grad is not None]
        if not params:
            return
        grads = [_value(p._grad) for p in params]
        summed = _allreduce_across_processes(_coalesce(grads))
        for p, g in zip(params, _split_like(summed, grads)):
            p._grad = g
