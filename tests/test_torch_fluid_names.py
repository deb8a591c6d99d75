"""The ``fluid`` names the port adds over code it already has, against
the JAX package on the CPU.

- Eleven ``fluid.layers`` functions whose ops the port registers
  (``mul``, ``sum``, ``conv2d_transpose``, ``conv3d``, ``group_norm``,
  ``instance_norm``, ``prelu``, ``row_conv``, ``spectral_norm``,
  ``bilinear_tensor_product``, ``nce``): each program is built by one
  script under both packages (the same ops, slots and attrs) and runs
  from the JAX startup's persistables to the same outputs and grads
  (``test_torch_training_tail``'s harness). ``nce`` draws its negatives
  from its own generator in each package, so the case fixes them through
  the ``custom_neg_classes`` attr of its op and its grad op in both. The
  layers the JAX package appends without shape inference (``sum``,
  ``row_conv``, ``bilinear_tensor_product``) get their output's shape set
  by the script in both, as a user does.
- Six top-level names: ``in_dygraph_mode``, ``ir`` / ``IrGraph``,
  ``enforce``, ``set_global_seed``, ``WeightNormParamAttr`` (the same
  parameters as the JAX package's helper makes from it) and
  ``CUDAPinnedPlace`` (a host place).

Tolerances: values and grads within 1e-5 of each tensor's scale, as the
other layer tests.
"""
import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu_torch as fluid

from test_torch_dynamic_rnn import close
from test_torch_rnn_search import block_ops
from test_torch_training_tail import feed_xy, program, run_both

R = lambda p, x, shape: p.layers.reshape(x, shape)  # noqa: E731


def shaped(out, shape):
    """Set an output's shape, which the JAX layer leaves unset (it appends
    the op without shape inference) and the loss's mean needs."""
    out.shape = shape
    return out


LAYERS = {
    "mul": lambda p, x, y: [p.layers.mul(x, p.layers.transpose(y, [1, 0]))],
    "sum": lambda p, x, y: [shaped(p.layers.sum([x, y, x]), (4, 6))],
    "conv2d_transpose": lambda p, x, y: [p.layers.conv2d_transpose(
        R(p, x, [4, 2, 1, 3]), num_filters=3, filter_size=2, act="relu")],
    "conv3d": lambda p, x, y: [p.layers.conv3d(
        R(p, x, [2, 2, 1, 2, 3]), num_filters=3, filter_size=[1, 2, 2])],
    "group_norm": lambda p, x, y: [p.layers.group_norm(
        R(p, x, [2, 6, 2, 1]), groups=2)],
    "instance_norm": lambda p, x, y: [p.layers.instance_norm(
        R(p, x, [2, 2, 2, 3]))],
    "prelu": lambda p, x, y: [p.layers.prelu(x, "all"),
                              p.layers.prelu(y, "channel")],
    "row_conv": lambda p, x, y: [shaped(p.layers.row_conv(
        R(p, x, [2, 2, 6]), future_context_size=1), (2, 2, 6))],
    "spectral_norm": lambda p, x, y: [p.layers.spectral_norm(
        x, dim=0, power_iters=2)],
    "bilinear_tensor_product": lambda p, x, y: [shaped(
        p.layers.bilinear_tensor_product(x, y, size=3), (4, 3))],
}


@pytest.mark.parametrize("case", sorted(LAYERS))
def test_layer_matches_the_jax_package(case):
    j, p, (jmain, pmain) = run_both(
        lambda pkg: program(pkg, LAYERS[case]), feed_xy())
    assert len(j) == len(p)
    for k, (a, b) in enumerate(zip(p, j)):
        close(a.array, b.array, "%s fetch %d" % (case, k))


def nce_program(pkg):
    main, startup, fetch = program(pkg, lambda p, x, y: [p.layers.nce(
        x, p.data(name="lbl", shape=[4, 1], dtype="int64"),
        num_total_classes=8, num_neg_samples=3)])
    for op in main.global_block().ops:
        if op.type in ("nce", "nce_grad"):
            op.attrs["custom_neg_classes"] = [1, 5, 6]
    return main, startup, fetch


def test_nce_matches_the_jax_package():
    feed = dict(feed_xy(), lbl=np.array([[0], [3], [7], [2]], "int64"))
    j, p, (jmain, pmain) = run_both(nce_program, feed)
    types = [op.type for op in pmain.global_block().ops]
    assert "nce" in types and "nce_grad" in types
    for k, (a, b) in enumerate(zip(p, j)):
        close(a.array, b.array, "nce fetch %d" % k)


def test_each_layer_is_a_fluid_layers_name():
    for name in list(LAYERS) + ["nce", "switch_moe"]:
        assert name in fluid.layers.__all__, name
        assert callable(getattr(fluid.layers, name))


def test_top_level_names():
    for name in ("in_dygraph_mode", "ir", "IrGraph", "enforce",
                 "set_global_seed", "WeightNormParamAttr",
                 "CUDAPinnedPlace"):
        assert hasattr(fluid, name) and hasattr(jfluid, name), name
    assert not fluid.in_dygraph_mode()
    with fluid.dygraph.guard(fluid.CPUPlace()):
        assert fluid.in_dygraph_mode()
    with pytest.raises(fluid.enforce.EnforceNotMet):
        fluid.enforce.enforce(False, "held")
    place = fluid.CUDAPinnedPlace()
    assert place.device().type == "cpu" and place != fluid.CPUPlace()


def test_set_global_seed_seeds_the_default_programs():
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        fluid.set_global_seed(1234)
        assert fluid.default_main_program().random_seed == 1234
        assert fluid.default_startup_program().random_seed == 1234


def test_ir_graph_round_trips_a_program():
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.data(name="x", shape=[2, 3], dtype="float32")
        fluid.layers.fc(x, size=4)
    graph = fluid.IrGraph(main)
    assert fluid.ir.IrGraph is fluid.IrGraph
    assert [op.type for op in graph.to_program().global_block().ops] == \
        [op.type for op in main.global_block().ops]


def test_weight_norm_param_attr_builds_the_jax_packages_parameters():
    def build(pkg):
        main, startup = pkg.Program(), pkg.Program()
        with pkg.unique_name.guard(), pkg.program_guard(main, startup):
            x = pkg.data(name="x", shape=[4, 6], dtype="float32")
            attr = pkg.WeightNormParamAttr(dim=0, name="wn_w")
            assert attr.dim == 0 and attr.name == "wn_w"
            pkg.layers.fc(x, size=5, param_attr=attr)
        return main

    jmain, pmain = build(jfluid), build(fluid)
    assert block_ops(pmain) == block_ops(jmain)
    assert [p.name for p in pmain.all_parameters()] == \
        [p.name for p in jmain.all_parameters()]
