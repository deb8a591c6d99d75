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
``__model__`` and a combined params file, say).

IR passes (``switch_ir_optim``, on by default, as in the JAX package):
after loading, the predictor runs ``ir.ConvBnFusePass`` (each ``is_test``
batch norm that alone reads a conv's output is folded into the conv's
filter and a ``<filter>.bn_fold_bias``, in the scope, on the device) and
``ir.FcFusePass`` (``mul -> elementwise_add [-> relu]`` with a persistable
rank-1 bias becomes ``fc``). The scope's tensors are snapshotted first: if
the rewritten program lost a fetch target, the predictor keeps the program
as loaded and puts the old tensors back. ``IrGraph`` covers one block, so
a program with control-flow sub-blocks (a While decoder) runs as saved.

Zero-copy: ``get_input_handle`` / ``get_output_handle`` (or
``get_input_tensor`` / ``get_output_tensor``) give ``ZeroCopyTensor``
handles; ``copy_from_cpu`` stages an input, ``zero_copy_run`` runs the
staged inputs, ``copy_to_cpu`` reads an output. Staging is per thread, so
concurrent callers of one predictor never see each other's inputs or
results; the run lock serializes the dispatch.
"""
from __future__ import annotations

import threading
from typing import Dict, List

import numpy as np

__all__ = ["AnalysisConfig", "PaddleTensor", "PaddlePredictor",
           "Predictor", "ZeroCopyTensor", "create_paddle_predictor",
           "create_predictor"]


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
        self._ir_optim = bool(x)

    def ir_optim(self):
        return self._ir_optim

    # the zero-copy API's switches: feed and fetch ops never exist in a
    # loaded program here, and inputs are always named
    def switch_use_feed_fetch_ops(self, x):
        pass

    def switch_specify_input_names(self, x=True):
        pass


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


class _ZeroCopyState(threading.local):
    """Per-thread zero-copy staging: stage -> run -> fetch has no request
    handle, so each calling thread stages into and reads from its own
    dicts."""

    def __init__(self):
        self.staged: Dict[str, np.ndarray] = {}
        self.results: Dict[str, np.ndarray] = {}


class PaddlePredictor:
    """Loads a saved inference model and serves ``run()``."""

    def __init__(self, config: AnalysisConfig):
        from .. import executor, io
        from ..core import CPUPlace, CUDAPlace, Scope, scope_guard

        self._config = config
        place = CUDAPlace(0) if config.use_gpu() else CPUPlace()
        self._exe = executor.Executor(place)
        self._scope = Scope()
        self._zc_state = _ZeroCopyState()
        self._run_lock = threading.RLock()
        with _construct_lock, scope_guard(self._scope):
            (self._program, self._feed_names,
             self._fetch_vars) = io.load_inference_model(
                 config.model_dir(), self._exe,
                 model_filename=config.prog_file(),
                 params_filename=config.params_file())
            if config.ir_optim() and len(self._program.blocks) == 1:
                self._apply_ir_passes()

    def _apply_ir_passes(self):
        """``ConvBnFusePass`` then ``FcFusePass`` (the JAX predictor's
        pipeline). The conv+BN fold rebinds scope tensors, so their old
        tensors are kept until the rewritten program is known to keep
        every fetch target; otherwise the program stays as loaded and the
        old tensors go back (the old program with folded weights would
        apply the batch norm twice)."""
        from .. import ir
        from ..core.tensor import LoDTensor

        snap = {n: var.raw().array
                for n, var in self._scope._vars.items()
                if isinstance(var.raw(), LoDTensor)}
        graph = ir.IrGraph(self._program)
        graph = ir.ConvBnFusePass(scope=self._scope).apply(graph)
        graph = ir.FcFusePass().apply(graph)
        new_prog = graph.to_program()
        block = new_prog.global_block()
        if all(block._find_var_recursive(v.name) is not None
               for v in self._fetch_vars):
            self._fetch_vars = [block._find_var_recursive(v.name)
                                for v in self._fetch_vars]
            self._program = new_prog
        else:
            for n, arr in snap.items():
                self._scope.var(n).get_tensor().set(arr)

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

    # -- zero-copy surface (the reference's GetInputTensor /
    # GetOutputTensor / ZeroCopyRun) -------------------------------------

    def get_input_tensor(self, name) -> "ZeroCopyTensor":
        if name not in self._feed_names:
            raise KeyError("no input named %r (have %s)"
                           % (name, self._feed_names))
        return ZeroCopyTensor(self, name, is_input=True)

    def get_output_tensor(self, name) -> "ZeroCopyTensor":
        if name not in self.get_output_names():
            raise KeyError("no output named %r (have %s)"
                           % (name, self.get_output_names()))
        return ZeroCopyTensor(self, name, is_input=False)

    # this thread's staging (threading.local)
    @property
    def _staged(self) -> Dict[str, np.ndarray]:
        return self._zc_state.staged

    @property
    def _results(self) -> Dict[str, np.ndarray]:
        return self._zc_state.results

    def zero_copy_run(self):
        missing = [n for n in self._feed_names if n not in self._staged]
        if missing:
            raise RuntimeError("inputs not staged via copy_from_cpu: %s"
                               % missing)
        outs = self.run({n: self._staged[n] for n in self._feed_names})
        self._zc_state.results = {t.name: t.data for t in outs}

    # the 2.0-style names
    def get_input_handle(self, name):
        return self.get_input_tensor(name)

    def get_output_handle(self, name):
        return self.get_output_tensor(name)


class ZeroCopyTensor:
    """A staged input or a fetched output of a predictor (the reference's
    ZeroCopyTensor): the input is copied to the predictor's device when
    ``zero_copy_run`` feeds it."""

    def __init__(self, predictor, name, is_input):
        self._p = predictor
        self.name = name
        self._is_input = is_input
        self._shape = None

    def reshape(self, shape):
        self._shape = tuple(int(s) for s in shape)

    def copy_from_cpu(self, arr):
        if not self._is_input:
            raise RuntimeError("%r is an output tensor" % self.name)
        arr = np.asarray(arr)
        if self._shape is not None:
            arr = arr.reshape(self._shape)
        self._p._staged[self.name] = arr

    def copy_to_cpu(self):
        if self._is_input:
            raise RuntimeError("%r is an input tensor" % self.name)
        results = self._p._results
        if self.name not in results:
            raise RuntimeError("call zero_copy_run() first")
        return results[self.name]

    def shape(self):
        if self._is_input:
            staged = self._p._staged
            if self.name in staged:
                return list(staged[self.name].shape)
            return list(self._shape or ())
        return list(np.asarray(self.copy_to_cpu()).shape)


Predictor = PaddlePredictor


def create_paddle_predictor(config: AnalysisConfig) -> PaddlePredictor:
    return PaddlePredictor(config)


create_predictor = create_paddle_predictor
