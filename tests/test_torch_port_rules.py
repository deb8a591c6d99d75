"""Rules the port keeps, checked on this host (which has no CUDA card).

- Every module of ``paddle_tpu_torch``, and ``chip_smoke``, imports
  without pulling in ``jax`` or any module of ``paddle_tpu``.
- Entry points run on the card unless asked for the CPU: on a host
  without one, asking for the card raises; nothing carries on on the CPU.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import paddle_tpu_torch as fluid
from paddle_tpu_torch.inference import AnalysisConfig, create_paddle_predictor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = r"""
import importlib, pkgutil, sys
import paddle_tpu_torch
names = [m.name for m in pkgutil.walk_packages(paddle_tpu_torch.__path__,
                                               "paddle_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "paddle_tpu",
                                    "ml_dtypes"))
print(len(names), bad)
assert not bad, bad
"""


def test_port_imports_no_jax_and_nothing_of_paddle_tpu():
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    n_modules = int(res.stdout.split()[0])
    assert n_modules >= 20


def _needs_cardless_host():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card; the rule is about hosts "
                    "without one")


def test_tpu_place_is_the_cuda_place():
    assert fluid.TPUPlace is fluid.CUDAPlace
    assert fluid.CPUPlace().device() == torch.device("cpu")


def test_asking_for_the_card_without_one_raises():
    _needs_cardless_host()
    for make in (fluid.Executor, lambda: fluid.Executor(fluid.CUDAPlace(0)),
                 lambda: fluid.Executor(fluid.TPUPlace(0))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()


def test_scope_from_numpy_states_its_device():
    _needs_cardless_host()
    arrays = {"w": np.ones((2, 3), "float32")}
    scope = fluid.Scope()
    with pytest.raises(TypeError):
        fluid.io.scope_from_numpy(scope, arrays)  # no silent CPU default
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fluid.io.scope_from_numpy(scope, arrays, fluid.CUDAPlace(0))
    fluid.io.scope_from_numpy(scope, arrays, fluid.CPUPlace())
    got = scope.find_var("w").get_tensor().array
    assert got.device.type == "cpu" and torch.equal(got, torch.ones(2, 3))


def test_predictor_defaults_to_the_card(tmp_path):
    _needs_cardless_host()
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.data(name="x", shape=[-1, 4], dtype="float32")
        y = fluid.layers.fc(x, size=3, act="gelu")
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        exe.run(startup)
        fluid.io.save_inference_model(str(tmp_path), ["x"], [y], exe,
                                      main_program=main)
    cfg = AnalysisConfig(str(tmp_path))
    assert cfg.use_gpu()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        create_paddle_predictor(cfg)
    cfg.disable_gpu()
    pred = create_paddle_predictor(cfg)
    (out,) = pred.run({"x": np.ones((2, 4), "float32")})
    assert out.data.shape == (2, 3) and np.isfinite(out.data).all()


def test_chip_smoke_refuses_a_cardless_host():
    _needs_cardless_host()
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


_IMPORT_RECURRENT = r"""
import sys
from paddle_tpu_torch.layers import control_flow, rnn  # noqa: F401
from paddle_tpu_torch.ops import control_flow_ops, rnn_ops  # noqa: F401
from paddle_tpu_torch.core import scope  # noqa: F401
import paddle_tpu_torch as fluid
for name in ("While", "IfElse", "cond", "create_array", "array_write",
             "array_read", "array_length", "StaticRNN", "LSTMCell",
             "GRUCell", "rnn", "BeamSearchDecoder", "dynamic_decode",
             "lstm", "lstm_unit", "gru_unit", "gather_tree", "topk",
             "stack", "squeeze", "unsqueeze", "logical_or"):
    assert hasattr(fluid.layers, name), name
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "paddle_tpu"))
assert not bad, bad
"""


_RECURRENT_MODULES = ("ops/rnn_ops.py", "ops/control_flow_ops.py",
                      "layers/rnn.py", "layers/control_flow.py",
                      "core/scope.py", "backward.py")


def test_recurrent_and_control_flow_modules_name_no_jax():
    """The modules of the recurrent and control-flow slice name neither
    jax nor the JAX package in an import line."""
    for module in _RECURRENT_MODULES:
        with open(os.path.join(REPO, "paddle_tpu_torch", module)) as f:
            imports = [ln.strip() for ln in f
                       if ln.strip().startswith(("import ", "from "))]
        assert not [ln for ln in imports
                    if ln.split()[1].split(".")[0] in (
                        "jax", "jaxlib", "paddle_tpu")], (module, imports)


def test_recurrent_and_control_flow_modules_import_no_jax():
    """Those modules load, with the layers they export, without pulling
    jax or the JAX package in."""
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", _IMPORT_RECURRENT], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


_IMPORT_LOD = r"""
import sys
from paddle_tpu_torch.core import lod_lowering, tensor  # noqa: F401
from paddle_tpu_torch.ops import lod_utils, sequence_ops  # noqa: F401
import paddle_tpu_torch as fluid
for name in ("sequence_pool", "sequence_conv", "sequence_enumerate",
             "sequence_erase", "sequence_first_step", "sequence_last_step",
             "sequence_softmax", "sequence_expand", "sequence_expand_as",
             "sequence_pad", "sequence_unpad", "sequence_reshape",
             "sequence_concat", "sequence_slice", "im2sequence", "lod_reset",
             "dynamic_lstm", "dynamic_gru"):
    assert hasattr(fluid.layers, name), name
for name in ("create_lod_tensor", "create_random_int_lodtensor",
             "DataFeeder", "nets", "lod_tensor"):
    assert hasattr(fluid, name), name
assert hasattr(fluid.nets, "sequence_conv_pool")
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "paddle_tpu"))
assert not bad, bad
"""

_LOD_MODULES = ("core/tensor.py", "core/registry.py", "core/executor_core.py",
                "core/lod_lowering.py", "executor.py", "ops/lod_utils.py",
                "ops/sequence_ops.py", "ops/tensor_ops.py",
                "ops/optimizer_ops.py", "ops/math_ops.py",
                "layers/sequence_lod.py", "layers/extras.py", "nets.py",
                "lod_tensor.py", "data_feeder.py")


def test_lod_and_sparse_modules_name_no_jax():
    """The modules of the LoD and SelectedRows slice name neither jax nor
    the JAX package in an import line, and say nothing is still to come
    that this slice brought."""
    for module in _LOD_MODULES:
        with open(os.path.join(REPO, "paddle_tpu_torch", module)) as f:
            text = f.read()
        imports = [ln.strip() for ln in text.splitlines()
                   if ln.strip().startswith(("import ", "from "))]
        assert not [ln for ln in imports
                    if ln.split()[1].split(".")[0] in (
                        "jax", "jaxlib", "paddle_tpu")], (module, imports)
        assert "later slice" not in text, module


def test_lod_and_sparse_modules_import_no_jax():
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", _IMPORT_LOD], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


_SLICE17_MODULES = ("ops/rank_table_ops.py", "ops/beam_search_ops.py",
                    "models/rnn_search.py", "layers/control_flow.py",
                    "layers/rnn.py", "layers/nn.py", "layers/extras.py",
                    "layers/tensor.py", "nets.py", "optimizer.py")

_IMPORT_SLICE17 = r"""
import importlib, sys
module = sys.argv[1]
importlib.import_module("paddle_tpu_torch." + module[:-3].replace("/", "."))
import paddle_tpu_torch as fluid
for name in ("DynamicRNN", "beam_search", "beam_search_decode", "is_empty",
             "split", "elementwise_max", "elementwise_pow", "gelu",
             "uniform_random", "gaussian_random", "reduce_prod",
             "reduce_all", "reduce_any", "zeros", "ones", "zeros_like",
             "sums", "while_loop"):
    assert hasattr(fluid.layers, name), name
for name in ("glu", "scaled_dot_product_attention"):
    assert hasattr(fluid.nets, name), name
for name in ("ExponentialMovingAverage", "ModelAverage",
             "LookaheadOptimizer"):
    assert hasattr(fluid.optimizer, name), name
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "paddle_tpu"))
assert not bad, bad
"""


@pytest.mark.parametrize("module", _SLICE17_MODULES)
def test_slice17_module_imports_no_jax(module):
    """Each module of the DynamicRNN and LoD beam-search slice names
    neither jax nor the JAX package in an import line, loads alone without
    pulling either in, and the package then has the slice's names."""
    with open(os.path.join(REPO, "paddle_tpu_torch", module)) as f:
        text = f.read()
    imports = [ln.strip() for ln in text.splitlines()
               if ln.strip().startswith(("import ", "from "))]
    assert not [ln for ln in imports if ln.split()[1].split(".")[0] in (
        "jax", "jaxlib", "paddle_tpu")], (module, imports)
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", _IMPORT_SLICE17, module],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


_SLICE18_MODULES = ("ir.py", "distributed/__init__.py",
                    "distributed/fault.py", "observability/__init__.py",
                    "observability/registry.py", "observability/tracing.py",
                    "observability/distributed.py",
                    "observability/flight.py", "serving/http.py",
                    "serving/fleet.py", "serving/metrics.py",
                    "inference/__init__.py")

_IMPORT_SLICE18 = r"""
import importlib, sys
module = sys.argv[1]
name = module[:-3].replace("/", ".")
if name.endswith(".__init__"):
    name = name[:-len(".__init__")]
importlib.import_module("paddle_tpu_torch." + name)
from paddle_tpu_torch import inference, ir, observability, serving
for name in ("start_http_server", "serve", "ServingHTTPServer",
             "FleetRouter", "FleetConfig", "RequestShed",
             "ReplicaUnavailable"):
    assert hasattr(serving, name), name
for name in ("create_predictor", "ZeroCopyTensor", "Predictor"):
    assert hasattr(inference, name), name
for name in ("FcFusePass", "ConvBnFusePass", "apply_passes"):
    assert hasattr(ir, name), name
for name in ("dump_prometheus", "counter", "enable", "reset"):
    assert hasattr(observability, name), name
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "paddle_tpu"))
assert not bad, bad
"""


@pytest.mark.parametrize("module", _SLICE18_MODULES)
def test_slice18_module_imports_no_jax(module):
    """Each module of the serving-front slice names neither jax nor the
    JAX package in an import line, loads alone without pulling either in,
    and says nothing is still to come that this slice brought."""
    with open(os.path.join(REPO, "paddle_tpu_torch", module)) as f:
        text = f.read()
    imports = [ln.strip() for ln in text.splitlines()
               if ln.strip().startswith(("import ", "from "))]
    assert not [ln for ln in imports if ln.split()[1].split(".")[0] in (
        "jax", "jaxlib", "paddle_tpu")], (module, imports)
    assert "later slice" not in text and "come later" not in text, module
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", _IMPORT_SLICE18, module],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


_SLICE19_MODULES = ("ops/cuda/graph_conditional.py", "ops/cuda/support.py",
                    "core/cuda_graph.py", "core/compiler_engine.py",
                    "executor.py", "dygraph/tracer.py", "dygraph/varbase.py",
                    "dygraph/jit.py", "dygraph/ast_transform.py",
                    "dygraph/dygraph_to_static.py", "dygraph/__init__.py",
                    "dygraph/nn.py", "layers/math_op_patch.py",
                    "ops/nn_tail_ops.py")

_IMPORT_SLICE19 = r"""
import importlib, sys
for module in sys.argv[1:]:
    importlib.import_module("paddle_tpu_torch." + module[:-3].replace(
        "/", "."))
from paddle_tpu_torch import dygraph
from paddle_tpu_torch.ops.cuda import support
for name in ("TracedLayer", "ProgramTranslator", "declarative",
             "to_static", "dygraph_to_static"):
    assert hasattr(dygraph, name), name
assert "graph_conditional" in support.SOURCES
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "paddle_tpu"))
assert not bad, bad
"""


def _code_names(text):
    """The names a module's code uses: its NAME tokens, not its strings
    or comments."""
    import io
    import tokenize

    return {tok.string for tok in tokenize.generate_tokens(
        io.StringIO(text).readline) if tok.type == tokenize.NAME}


@pytest.mark.parametrize("module", _SLICE19_MODULES)
def test_slice19_module_names_no_jax(module):
    """Each module of the control-flow and dygraph-to-static slice names
    neither jax nor the JAX package in its code (its docstrings point at
    the JAX package's files) and says nothing is still to come that this
    slice brought."""
    with open(os.path.join(REPO, "paddle_tpu_torch", module)) as f:
        text = f.read()
    assert not _code_names(text) & {"jax", "jnp", "jaxlib", "lax",
                                    "paddle_tpu"}, module
    assert "later slice" not in text and "later work" not in text, module


def test_slice19_modules_import_no_jax():
    """The slice's modules load, with the names it exports, without
    pulling jax or the JAX package in."""
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", _IMPORT_SLICE19,
                          *_SLICE19_MODULES], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
