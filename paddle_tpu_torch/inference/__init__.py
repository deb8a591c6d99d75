"""Inference API: AnalysisConfig + Predictor.

Counterpart of ``paddle_tpu/inference/__init__.py``. A predictor loads a
saved inference model once, keeps its parameters resident on its device
and serves ``run()``; one predictor may be shared by many serving threads,
and its run lock serializes the dispatch (one device stream). ``run`` goes
through the executor's whole-program route: on the card each batch shape
is run once eagerly, then captured into a CUDA graph and replayed
(``warmup_runs`` runs of a shape reach the replay; the serving engine's
warm-up runs each ladder bucket that often).

``AnalysisConfig`` runs on the card by default; ``disable_gpu()`` asks for
the CPU. ``set_prog_file`` / ``set_params_file`` name the model's files
inside its directory, as ``load_inference_model`` takes them (a protobuf
``__model__`` and a combined params file, say). ``switch_ir_optim`` is
recorded: the IR passes of the JAX package (``ir.py`` FcFusePass,
ConvBnFusePass) come with a later slice, so the predictor runs the
program as saved. The zero-copy tensor surface comes
later too.
"""
from __future__ import annotations

import threading
from typing import List

import numpy as np

__all__ = ["AnalysisConfig", "PaddleTensor", "PaddlePredictor",
           "create_paddle_predictor"]


class AnalysisConfig:
    def __init__(self, model_dir=None, params_file=None):
        self._model_dir = model_dir
        self._prog_file = None
        self._params_file = params_file
        self._use_gpu = True
        self._ir_optim = True

    def set_model(self, model_dir, params_file=None):
        self._model_dir = model_dir
        self._params_file = params_file

    def model_dir(self):
        return self._model_dir

    # the reference's SetProgFile / prog_file: file names inside
    # model_dir, a protobuf ``__model__`` and its combined params stream
    def set_prog_file(self, prog_file):
        self._prog_file = prog_file

    def set_params_file(self, params_file):
        self._params_file = params_file

    def prog_file(self):
        return self._prog_file

    def params_file(self):
        return self._params_file

    def enable_use_gpu(self, memory_pool_init_size_mb=100, device_id=0):
        self._use_gpu = True

    def disable_gpu(self):
        self._use_gpu = False

    def use_gpu(self):
        return self._use_gpu

    def switch_ir_optim(self, x=True):
        self._ir_optim = x  # recorded; the IR passes are not yet ported


class PaddleTensor:
    """Name + ndarray."""

    def __init__(self, data=None, name=""):
        self.name = name
        self.data = np.asarray(data) if data is not None else None
        self.shape = tuple(self.data.shape) if self.data is not None else ()
        self.lod = []


# load_inference_model fills the current scope (global_scope()), which a
# process-wide guard stack selects: constructions are serialized so two
# predictors never load into each other's scope
_construct_lock = threading.Lock()


class PaddlePredictor:
    """Loads a saved inference model and serves ``run()``."""

    def __init__(self, config: AnalysisConfig):
        from .. import executor, io
        from ..core import CPUPlace, CUDAPlace, Scope, scope_guard

        self._config = config
        place = CUDAPlace(0) if config.use_gpu() else CPUPlace()
        self._exe = executor.Executor(place)
        self._scope = Scope()
        self._run_lock = threading.Lock()
        with _construct_lock, scope_guard(self._scope):
            (self._program, self._feed_names,
             self._fetch_vars) = io.load_inference_model(
                 config.model_dir(), self._exe,
                 model_filename=config.prog_file(),
                 params_filename=config.params_file())

    @property
    def device(self):
        return self._exe.device

    @property
    def warmup_runs(self) -> int:
        """Runs of one batch shape before ``run`` replays a captured
        graph."""
        return self._exe.runs_to_capture

    def get_input_names(self) -> List[str]:
        return list(self._feed_names)

    def get_output_names(self) -> List[str]:
        return [v.name for v in self._fetch_vars]

    def run(self, inputs) -> List[PaddleTensor]:
        """``inputs``: a list of PaddleTensor (positional feed order) or a
        dict name -> ndarray. Returns a list of PaddleTensor (numpy)."""
        if isinstance(inputs, dict):
            feed = {k: np.asarray(v) for k, v in inputs.items()}
        else:
            feed = {(t.name or self._feed_names[i]): np.asarray(t.data)
                    for i, t in enumerate(inputs)}
        # the scope is passed explicitly: the guard stack is process-wide,
        # and serving threads share this predictor
        with self._run_lock:
            outs = self._exe.run(self._program, feed=feed,
                                 fetch_list=self._fetch_vars,
                                 scope=self._scope)
        return [PaddleTensor(o, name=v.name)
                for o, v in zip(outs, self._fetch_vars)]


def create_paddle_predictor(config: AnalysisConfig) -> PaddlePredictor:
    return PaddlePredictor(config)
