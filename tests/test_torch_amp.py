"""Mixed precision (``contrib.mixed_precision``, ``ops/amp_ops.py``), the
port against the JAX package, on the CPU.

- The lists: ``AutoMixedPrecisionLists``' sets and custom overrides equal
  the JAX package's, the overlap raises in both.
- Rewrite parity: for each of bench.py's scripts (and ``test_amp.py``'s
  MLP), the program both packages build under ``mp.decorate`` is the same
  op for op (types, slots, var names, attrs), and every var has the same
  type (integers by class: the JAX package, x64 off, stores int64 as
  int32). ``flash_attention`` takes float32 inputs and ``conv2d``
  bfloat16 in both, and every parameter's grad is float32. The two faults
  ``test_torch_amp_training.py`` plants show up here as program
  differences for every script. Shape inference on ``meta`` tensors
  agrees with the types the rewrite wrote.
- The loss-scaling ops bitwise against the JAX ops on every branch.
- ``test_amp.py``'s classes through the port on ``CPUPlace()`` (the
  default route), and its fusion case: the fused optimizer groups the
  float32 masters.
- The op functions an AMP program reaches with bfloat16 tensors keep
  their inputs' type and agree with the JAX ops within one bfloat16 ulp
  (2^-7 relative) of the output's scale, forward and grad: both packages
  round float32-accumulated products (and each elementwise result) to
  bfloat16 once, in sums of another order.
- K5's plain version in bfloat16 against a float64 conv of the same
  bfloat16 inputs.
"""
import copy
import os
import sys
import zlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as jfluid
import paddle_tpu.models  # noqa: F401  (jfluid.models)
from paddle_tpu.contrib import mixed_precision as jmp
from paddle_tpu.core.registry import OpInfoMap as JaxOps
import paddle_tpu_torch as fluid
from paddle_tpu_torch import framework
from paddle_tpu_torch.contrib import mixed_precision as mp
from paddle_tpu_torch.core.registry import DEVICE_ATTR, OpInfoMap
from paddle_tpu_torch.models import gpt
from paddle_tpu_torch.models import transformer as T
from paddle_tpu_torch.models.resnet import build_resnet_train
from paddle_tpu_torch.ops.cuda import conv as k5

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import test_torch_amp_training as AT  # noqa: E402

CPU = torch.device("cpu")
ULP = 2.0 ** -7   # one bfloat16 ulp, relative
KNOB = "PADDLE_TPU_FUSED_OPTIMIZER"


# -- the lists ---------------------------------------------------------------

def test_default_lists_equal_the_jax_package():
    want, got = jmp.AutoMixedPrecisionLists(), mp.AutoMixedPrecisionLists()
    assert got.white_list == want.white_list
    assert got.black_list == want.black_list
    assert got.gray_list == want.gray_list
    assert "flash_attention" not in (got.white_list | got.black_list
                                     | got.gray_list)
    assert "conv2d" in got.white_list


@pytest.mark.parametrize("white,black", [
    ({"softmax"}, None), (None, {"mul"}), ({"layer_norm", "gelu"},
                                           {"conv2d", "flash_attention"})])
def test_custom_lists_equal_the_jax_package(white, black):
    want = jmp.AutoMixedPrecisionLists(white, black)
    got = mp.AutoMixedPrecisionLists(white, black)
    assert (got.white_list, got.black_list, got.gray_list) == \
        (want.white_list, want.black_list, want.gray_list)


def test_custom_lists_overlap_raises_in_both():
    for pkg in (jmp, mp):
        with pytest.raises(ValueError, match="overlap"):
            pkg.AutoMixedPrecisionLists({"mul", "tanh"}, {"tanh"})


# -- rewrite parity ---------------------------------------------------------

def build_mlp(pkg, dyn=False, lr=0.5, decr_every=2):
    """``tests/test_amp.py``'s ``_build`` under ``pkg``: (main, startup,
    loss, decorated optimizer)."""
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        x = pkg.data(name="x", shape=[64, 32], dtype="float32")
        y = pkg.data(name="y", shape=[64, 1], dtype="int64")
        h = pkg.layers.fc(x, 64, act="relu")
        pred = pkg.layers.fc(h, 10, act="softmax")
        loss = pkg.layers.mean(pkg.layers.cross_entropy(pred, y))
        opt = pkg.contrib.mixed_precision.decorate(
            pkg.optimizer.SGD(lr), use_dynamic_loss_scaling=dyn,
            init_loss_scaling=2 ** 10 if dyn else 1.0,
            decr_every_n_nan_or_inf=decr_every)
        opt.minimize(loss)
    return main, startup, loss, opt


PROGRAMS = ["mlp", "mlp_dynamic", "gpt", "wmt_lengths", "bert",
            "resnet50_nhwc"]


def build(pkg, name):
    if name.startswith("mlp"):
        return build_mlp(pkg, dyn=name == "mlp_dynamic")
    return AT.build(pkg, name)


def _kind(dtype):
    return "int" if dtype in ("int32", "int64") else dtype


def signature(program):
    """(type, inputs, outputs, attrs) of every op (``cast``'s
    ``in_dtype`` by class) and every var's type (integers by class)."""
    ops = []
    for op in program.global_block().ops:
        attrs = dict(op.attrs)
        if op.type == "cast" and attrs.get("in_dtype") == 3:
            attrs["in_dtype"] = 2
        ops.append((op.type, op.inputs, op.outputs, attrs))
    dtypes = {n: _kind(v.dtype)
              for n, v in program.global_block().vars.items()}
    return ops, dtypes


@pytest.fixture
def route_all():
    old = fluid.get_flags("FLAGS_use_pallas_conv")
    fluid.set_flags({"FLAGS_use_pallas_conv": "all"})
    yield
    fluid.set_flags(old)


def _input_dtypes(program, op_type):
    """The types of ``op_type``'s floating inputs (lengths left out)."""
    block = program.global_block()
    return {block._find_var_recursive(n).dtype
            for op in block.ops if op.type == op_type
            for n in op.input_arg_names} - {"int32", "int64"}


@pytest.mark.parametrize("name", PROGRAMS)
def test_amp_programs_equal_the_jax_package(route_all, name):
    want, got = build(jfluid, name), build(fluid, name)
    for w, g in zip(want[:2], got[:2]):
        assert signature(g) == signature(w)
    main = got[0]
    params = {p.name for p in main.all_parameters()}
    block = main.global_block()
    # float32 masters and float32 grads for every parameter
    for p in params:
        assert block.var(p).dtype == "float32", p
        if block.has_var_local(p + "@GRAD"):
            assert block.var(p + "@GRAD").dtype == "float32", p
    assert any(v.dtype == "bfloat16" for v in block.vars.values())
    for pkg_main in (want[0], main):
        types = [op.type for op in pkg_main.global_block().ops]
        if "flash_attention" in types:
            assert _input_dtypes(pkg_main, "flash_attention") == {"float32"}
        if name == "resnet50_nhwc":
            assert _input_dtypes(pkg_main, "conv2d") == {"bfloat16"}


@pytest.mark.parametrize("name", ["gpt", "resnet50_nhwc"])
def test_every_master_grad_is_float32_at_run_time(route_all, name):
    """The grad of each parameter's cast comes out in the parameter's
    type, so every master grad the optimizer reads is float32."""
    main, startup, loss = build(fluid, name)[:3]
    grads = [p.name + "@GRAD" for p in main.all_parameters() if p.trainable]
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    res = exe.run(main, feed=AT.feeds(name)[0], scope=scope,
                  fetch_list=grads, return_numpy=False)
    assert {str(t.array.dtype) for t in res} == {"torch.float32"}


@pytest.mark.parametrize("script,counts", [
    ("gpt", (260, 49, 13)), ("bert", (1440, 244, 97)),
    ("wmt", (1925, 344, 109)), ("resnet", (851, 159, 1))])
def test_bench_amp_programs_at_full_width(route_all, script, counts):
    """bench.py's own ``_build_*`` functions with ``use_bf16=True``
    against the port's (gpt_long at 2 x 4096, BERT 32 x 128, WMT 64 x 256
    with lengths, ResNet-50 NHWC at batch 128): the same programs, with
    the op, cast and GEMM counts of the reference under AMP."""
    sys.path.insert(0, AT.REPO)
    import bench

    with jfluid.unique_name.guard():
        if script == "gpt":
            want = bench._build_gpt_long(2, 4096, use_bf16=True)
            got = gpt.build_gpt_long(**gpt.GPT_LONG)
        elif script == "bert":
            want = bench._build_bert_base(32, 128, use_bf16=True)
            b = T.BERT_BASE
            got = T.build_bert_base(b["batch"], b["seq_len"])
        elif script == "wmt":
            want = bench._build_transformer_wmt(64, 256, use_bf16=True,
                                                use_lengths=True)
            got = T.build_transformer_wmt(64, 256)
        else:
            want = bench._build_resnet50(128, use_bf16=True,
                                         data_format="NHWC")
            got = build_resnet_train(128, use_bf16=True)
    assert signature(got[0]) == signature(want[0])
    assert signature(got[1]) == signature(want[1])
    types = [op.type for op in got[0].global_block().ops]
    gemms = types.count("mul") + types.count("matmul")
    assert (len(types), types.count("cast"), gemms) == counts


@pytest.mark.parametrize("fault", sorted(AT.FAULTS))
@pytest.mark.parametrize("name", AT.SCRIPTS)
def test_a_planted_rewrite_fault_changes_the_program(route_all, monkeypatch,
                                                     name, fault):
    want = signature(build(jfluid, name)[0])
    AT.FAULTS[fault](monkeypatch)
    assert signature(build(fluid, name)[0]) != want


@pytest.mark.parametrize("name", ["gpt", "wmt_lengths", "bert",
                                  "resnet50_nhwc"])
def test_shape_inference_agrees_with_the_rewritten_types(route_all, name):
    """Each forward op re-run on ``meta`` tensors gives the types the
    rewrite wrote to its outputs."""
    main = build(fluid, name)[0]
    block = main.global_block()
    n = 0
    for op in list(block.ops):
        if op._role != framework.OpRole.Forward or \
                OpInfoMap.instance().get(op.type).fn is None:
            continue
        outs = {name: copy.copy(block.var(name))
                for name in op.output_arg_names}
        saved = {name: block.vars[name] for name in outs}
        block.vars.update(outs)
        try:
            framework.infer_op_shapes(block, op)
            for name in outs:
                assert block.vars[name].dtype == saved[name].dtype, (
                    op.type, name)
                assert block.vars[name].shape == saved[name].shape, (
                    op.type, name)
        finally:
            block.vars.update(saved)
        n += 1
    assert n > 20


# -- the loss-scaling ops ---------------------------------------------------

def _bits(x):
    """A numpy or torch array as comparable bits."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().astype(np.int64)
        return x.numpy().view(np.uint8).reshape(-1).copy() \
            if x.dtype != torch.bool else x.numpy()
    x = np.asarray(x)
    if x.dtype.name == "bfloat16":
        return x.view(np.int16).astype(np.int64)
    return x.view(np.uint8).reshape(-1).copy() if x.dtype != bool else x


def _both(op_type, ins, attrs, dtype="float32"):
    """(JAX outputs, port outputs) of ``op_type``; float arrays of
    ``dtype``."""
    jinfo = JaxOps.instance().get(op_type)
    pinfo = OpInfoMap.instance().get(op_type)
    ja, pa = dict(jinfo.attrs), dict(pinfo.attrs)
    ja.update(attrs)
    pa.update(attrs)
    pa[DEVICE_ATTR] = CPU

    def j(v):
        if isinstance(v, list):
            return [j(x) for x in v]
        a = jnp.asarray(v)
        return a.astype(dtype) if a.dtype == jnp.float32 and \
            dtype == "bfloat16" else a

    def p(v):
        if isinstance(v, list):
            return [p(x) for x in v]
        t = torch.from_numpy(np.array(v))
        return t.to(torch.bfloat16) if t.dtype == torch.float32 and \
            dtype == "bfloat16" else t

    return (jinfo.fn({k: j(v) for k, v in ins.items()}, ja),
            pinfo.fn({k: p(v) for k, v in ins.items()}, pa))


def _grads(rng, bad=None):
    gs = [rng.randn(3, 5).astype("float32") * 40,
          rng.randn(7).astype("float32"),
          rng.randn(2, 2, 4).astype("float32") * 1e-3]
    if bad is not None:
        gs[1][3] = bad
    return gs


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bad", [None, np.inf, -np.inf, np.nan])
@pytest.mark.parametrize("scale", [1.0, 1024.0, 3.0, 2.0 ** 15])
def test_check_finite_and_unscale_is_bitwise(dtype, bad, scale):
    rng = np.random.RandomState(int(scale) + (0 if bad is None else 7))
    ins = {"X": _grads(rng, bad),
           "Scale": np.array([scale], dtype="float32")}
    j, p = _both("check_finite_and_unscale", ins, {}, dtype)
    assert len(p["Out"]) == 3
    for a, b in zip(j["Out"], p["Out"]):
        assert str(b.dtype).endswith(dtype)
        assert np.array_equal(_bits(a), _bits(b))
    assert p["FoundInfinite"].dtype == torch.bool
    assert p["FoundInfinite"].shape == (1,)
    assert bool(p["FoundInfinite"][0]) == (bad is not None) == \
        bool(np.asarray(j["FoundInfinite"])[0])


# (found, scale, good, bad) -> the branch: growth, growth blocked at
# float32's top, shrink, the floor at 1, the counters counting and reset
SCALING_CASES = {
    "count_good": (False, 1024.0, 3, 1),
    "grow": (False, 1024.0, 999, 0),
    "grow_blocked_at_inf": (False, 3.0e38, 999, 0),
    "count_bad": (True, 1024.0, 57, 0),
    "shrink": (True, 1024.0, 5, 1),
    "shrink_floor_at_1": (True, 1.1, 0, 1),
    "shrink_odd": (True, 3.0, 0, 4),
}


@pytest.mark.parametrize("case", sorted(SCALING_CASES))
def test_update_loss_scaling_is_bitwise(case):
    found, scale, good, bad = SCALING_CASES[case]
    ins = {"FoundInfinite": np.array([found]),
           "PrevLossScaling": np.array([scale], dtype="float32"),
           "InGoodSteps": np.array([good], dtype="int32"),
           "InBadSteps": np.array([bad], dtype="int32")}
    attrs = {"incr_every_n_steps": 1000, "decr_every_n_nan_or_inf": 2,
             "incr_ratio": 2.0, "decr_ratio": 0.8}
    j, p = _both("update_loss_scaling", ins, attrs)
    for slot in ("LossScaling", "OutGoodSteps", "OutBadSteps"):
        assert p[slot].dtype == (torch.float32 if slot == "LossScaling"
                                 else torch.int32)
        assert np.array_equal(_bits(np.asarray(j[slot])), _bits(p[slot])), \
            (slot, np.asarray(j[slot]), p[slot])
    new = float(p["LossScaling"][0])
    if case == "grow":
        assert new == 2048.0 and int(p["OutGoodSteps"][0]) == 0
    if case == "grow_blocked_at_inf":
        assert new == np.float32(3.0e38)
    if case == "shrink_floor_at_1":
        assert new == 1.0 and int(p["OutBadSteps"][0]) == 0
    if case == "count_bad":
        assert new == 1024.0 and int(p["OutGoodSteps"][0]) == 0 \
            and int(p["OutBadSteps"][0]) == 1


# -- tests/test_amp.py's classes through the port -----------------------------

def _batches(n, seed=0):
    rng = np.random.RandomState(seed)
    W = rng.randn(32, 10)
    out = []
    for _ in range(n):
        xb = rng.randn(64, 32).astype("float32")
        yb = (xb @ W).argmax(1).reshape(64, 1).astype("int64")
        out.append((xb, yb))
    return out


class TestRewriteProgram:
    def test_white_ops_get_bf16_casts(self):
        main, _, loss, _ = build_mlp(fluid)
        blk = main.global_block()
        assert any(v.dtype == "bfloat16" for v in blk.vars.values())
        assert any(op.type == "cast" for op in blk.ops)
        for op in blk.ops:
            if op.type == "mul" and not op._role:
                for name in op.input_arg_names:
                    assert blk.var(name).dtype == "bfloat16", (op, name)
        assert blk.var(loss.name).dtype == "float32"

    def test_black_op_inputs_stay_f32(self):
        main = build_mlp(fluid)[0]
        blk = main.global_block()
        for op in blk.ops:
            if op.type == "cross_entropy":
                for name in op.input_arg_names:
                    if blk.var(name).dtype != "int64":
                        assert blk.var(name).dtype == "float32", name


class TestAmpTraining:
    def _train(self, dyn):
        main, startup, loss, _ = build_mlp(fluid, dyn=dyn)
        exe = fluid.Executor(fluid.CPUPlace())
        scope = fluid.Scope()
        exe.run(startup, scope=scope)
        losses = []
        for xb, yb in _batches(50):
            (out,) = exe.run(main, feed={"x": xb, "y": yb},
                             fetch_list=[loss], scope=scope)
            losses.append(float(np.asarray(out).ravel()[0]))
        return losses

    def test_bf16_static_scaling_converges(self):
        losses = self._train(False)
        assert losses[-1] < 0.5 * losses[0], (losses[0], losses[-1])

    def test_bf16_dynamic_scaling_converges(self):
        losses = self._train(True)
        assert losses[-1] < 0.5 * losses[0], (losses[0], losses[-1])


class TestDynamicLossScaling:
    def test_inf_batch_skips_update_and_shrinks_scale(self):
        main, startup, loss, amp_opt = build_mlp(fluid, dyn=True,
                                                 decr_every=1)
        scale_name = amp_opt.get_loss_scaling().name
        exe = fluid.Executor(fluid.CPUPlace())
        scope = fluid.Scope()
        exe.run(startup, scope=scope)

        def read(name):
            return scope.find_var(name).get_tensor().numpy().copy()

        xb, yb = _batches(1, seed=3)[0]
        exe.run(main, feed={"x": xb, "y": yb}, fetch_list=[loss],
                scope=scope)
        params = [p.name for p in main.all_parameters()]
        before = {n: read(n) for n in params}
        s_before = float(read(scale_name)[0])
        bad = xb.copy()
        bad[0, 0] = np.inf
        exe.run(main, feed={"x": bad, "y": yb}, fetch_list=[loss],
                scope=scope)
        for n in params:
            np.testing.assert_array_equal(read(n), before[n], err_msg=n)
        assert float(read(scale_name)[0]) < s_before
        # the next clean batch updates again
        exe.run(main, feed={"x": xb, "y": yb}, fetch_list=[loss],
                scope=scope)
        assert any(not np.array_equal(read(n), before[n]) for n in params)


@pytest.fixture
def knob():
    old = os.environ.pop(KNOB, None)
    yield lambda v: os.environ.__setitem__(KNOB, v)
    os.environ.pop(KNOB, None)
    if old is not None:
        os.environ[KNOB] = old


def _fusion_mlp(pkg):
    """``test_single_chip_fusion.py``'s ``_build_mlp(optimizer="adam",
    amp=True)`` under ``pkg``."""
    main, startup = pkg.Program(), pkg.Program()
    startup.random_seed = 4242
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        x = pkg.data(name="x", shape=[8, 16], dtype="float32")
        lbl = pkg.data(name="lbl", shape=[8, 1], dtype="int64")
        h = x
        for s in (33, 17):
            h = pkg.layers.fc(h, size=s, act="gelu")
        pred = pkg.layers.fc(h, size=10, act="softmax")
        loss = pkg.layers.mean(pkg.layers.cross_entropy(pred, lbl))
        pkg.contrib.mixed_precision.decorate(
            pkg.optimizer.AdamOptimizer(1e-3)).minimize(loss)
    rng = np.random.RandomState(7)
    feed = {"x": rng.rand(8, 16).astype("float32"),
            "lbl": rng.randint(0, 10, (8, 1)).astype("int64")}
    return main, startup, loss, feed


@pytest.mark.parametrize("layout", ["1", "flat"])
def test_amp_master_updates_fuse(knob, layout):
    """``test_single_chip_fusion.py``'s AMP case: the fused optimizer
    groups the float32 masters' Adam updates into one op, and the first
    step's parameters are bitwise those of the per-parameter program."""
    runs = {}
    for side in ("base", "fused"):
        if side == "fused":
            knob(layout)
        main, startup, loss, feed = _fusion_mlp(fluid)
        exe = fluid.Executor(fluid.CPUPlace())
        scope = fluid.Scope()
        exe.run(startup, scope=scope)
        exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
        runs[side] = ([op.type for op in main.global_block().ops],
                      {p.name: scope.find_var(p.name).get_tensor().numpy()
                       for p in main.all_parameters()})
    ops = runs["fused"][0]
    assert ops.count("fused_optimizer") == 1 and "adam" not in ops, ops
    assert "adam" in runs["base"][0]
    for name, want in runs["base"][1].items():
        np.testing.assert_array_equal(runs["fused"][1][name], want,
                                      err_msg=name)


# -- the op functions on bfloat16 tensors ----------------------------------

def _rng(*key):
    return np.random.RandomState(zlib.crc32(repr(key).encode()))


def _f(rng, *shape):
    return rng.randn(*shape).astype("float32")


def _np(v):
    if isinstance(v, torch.Tensor):
        return v.detach().float().numpy(), str(v.dtype).split(".")[-1]
    a = np.asarray(v)
    return a.astype(np.float32) if a.dtype.kind == "V" or \
        a.dtype.name == "bfloat16" else a, a.dtype.name


def _close_bf16(j, p, what):
    for slot, jv in j.items():
        if jv is None:
            continue
        jvs, pvs = (jv, p[slot]) if isinstance(jv, list) else ([jv],
                                                               [p[slot]])
        for a, b in zip(jvs, pvs):
            want, wdt = _np(a)
            got, gdt = _np(b)
            if wdt.startswith("int"):
                np.testing.assert_array_equal(got, want)
                continue
            assert gdt == wdt, (what, slot, gdt, wdt)
            assert got.shape == want.shape, (what, slot)
            scale = max(float(np.abs(want).max(initial=0.0)), 1e-30)
            assert float(np.abs(got - want).max(initial=0.0)) <= \
                ULP * scale, (what, slot, float(np.abs(got - want).max()),
                              scale)


BF16_OPS = {
    "mul": (lambda r: {"X": _f(r, 6, 4, 32), "Y": _f(r, 32, 24)},
            {"x_num_col_dims": 2}, "Out"),
    "matmul": (lambda r: {"X": _f(r, 2, 3, 16, 8), "Y": _f(r, 2, 3, 16, 8)},
               {"transpose_Y": True, "alpha": 0.125}, "Out"),
    "scale": (lambda r: {"X": _f(r, 5, 7)}, {"scale": 0.3, "bias": 0.5},
              "Out"),
    "reshape2": (lambda r: {"X": _f(r, 2, 6, 4)}, {"shape": [2, 6, 2, 2]},
                 "Out"),
    "transpose2": (lambda r: {"X": _f(r, 2, 6, 4)}, {"axis": [0, 2, 1]},
                   "Out"),
    "gather": (lambda r: {"X": _f(r, 9, 5),
                          "Index": np.array([3, 0, 3, 8], "int32")}, {},
               "Out"),
    "lookup_table": (lambda r: {"W": _f(r, 11, 6),
                                "Ids": np.array([[1], [4], [1], [10]],
                                                "int64")},
                     {}, "Out"),
    "relu": (lambda r: {"X": _f(r, 4, 9)}, {}, "Out"),
}
for _n in ("add", "sub", "mul", "div", "max", "min"):
    BF16_OPS["elementwise_" + _n] = (
        lambda r: {"X": _f(r, 3, 4, 5), "Y": _f(r, 4, 5) + 3.0},
        {"axis": 1}, "Out")


@pytest.mark.parametrize("op_type", sorted(BF16_OPS))
def test_bf16_ops_keep_their_type_and_match_the_jax_ops(op_type):
    make, attrs, out = BF16_OPS[op_type]
    ins = make(_rng(op_type))
    j, p = _both(op_type, ins, attrs, "bfloat16")
    _close_bf16(j, p, op_type)
    gins = dict(ins)
    gins[out + "@GRAD"] = _f(_rng(op_type, "g"),
                             *np.asarray(j[out]).shape)
    jg, pg = _both(op_type + "_grad", gins, attrs, "bfloat16")
    assert pg and set(k for k, v in pg.items() if v is not None) == \
        set(k for k, v in jg.items() if v is not None)
    _close_bf16(jg, pg, op_type + "_grad")


def test_auto_vjp_casts_a_float32_cotangent_to_the_bf16_primal():
    """A float32 grad arriving at a bfloat16 op (a cast's consumer on the
    float32 side) is cast to the output's type first, as the JAX
    package's auto-VJP does: the same bits as a bfloat16 cotangent."""
    r = _rng("cot")
    info = OpInfoMap.instance().get("mul_grad")
    attrs = dict(info.attrs)
    attrs[DEVICE_ATTR] = CPU
    x, y = (torch.from_numpy(_f(r, 4, 8)).to(torch.bfloat16),
            torch.from_numpy(_f(r, 8, 3)).to(torch.bfloat16))
    g = torch.from_numpy(_f(r, 4, 3))
    want = info.fn({"X": x, "Y": y, "Out@GRAD": g.to(torch.bfloat16)}, attrs)
    got = info.fn({"X": x, "Y": y, "Out@GRAD": g}, attrs)
    for slot in ("X@GRAD", "Y@GRAD"):
        assert got[slot].dtype == torch.bfloat16
        assert torch.equal(got[slot], want[slot])


@pytest.mark.parametrize("out_dtype", [5, 22])
def test_cast_between_float32_and_bfloat16(out_dtype):
    x = _f(_rng("cast", out_dtype), 4, 7)
    src = "bfloat16" if out_dtype == 5 else "float32"
    j, p = _both("cast", {"X": x}, {"in_dtype": 27 - out_dtype,
                                    "out_dtype": out_dtype}, src)
    assert np.array_equal(_bits(np.asarray(j["Out"])), _bits(p["Out"]))
    g = {"X": x, "Out@GRAD": _f(_rng("cast", "g"), 4, 7)}
    jg, pg = _both("cast_grad", g, {"in_dtype": 27 - out_dtype,
                                    "out_dtype": out_dtype}, src)
    assert str(pg["X@GRAD"].dtype).endswith(src)
    assert np.array_equal(_bits(np.asarray(jg["X@GRAD"])),
                          _bits(pg["X@GRAD"]))


@pytest.mark.parametrize("shape", [
    ((2, 8, 8, 128), (64, 128, 3, 3), 1, 1),    # routed to K5
    ((2, 8, 8, 128), (256, 128, 1, 1), 2, 0),   # routed, stride 2
    ((2, 8, 8, 3), (16, 3, 3, 3), 1, 1)])       # the stem: not routed
def test_bf16_conv2d_and_its_grad_match_the_jax_op(route_all, shape):
    """NHWC ``conv2d`` on bfloat16 input and filter: a routed conv runs
    K5's plain version on the CPU (the JAX package runs XLA's conv
    here), the grads ``conv_backward``; outputs and grads stay
    bfloat16."""
    x_shape, w_shape, stride, pad = shape
    r = _rng("conv", shape)
    ins = {"Input": _f(r, *x_shape), "Filter": _f(r, *w_shape) * 0.1}
    attrs = {"strides": [stride, stride], "paddings": [pad, pad],
             "data_format": "NHWC"}
    calls = []
    plain = k5.conv2d_bn_act_reference
    with pytest.MonkeyPatch.context() as m:
        m.setattr(k5, "conv2d_bn_act_reference",
                  lambda *a, **kw: calls.append(1) or plain(*a, **kw))
        j, p = _both("conv2d", ins, attrs, "bfloat16")
    assert len(calls) == (1 if x_shape[-1] == 128 else 0)
    _close_bf16(j, p, "conv2d")
    gins = dict(ins)
    gins["Output@GRAD"] = _f(r, *np.asarray(j["Output"]).shape)
    jg, pg = _both("conv2d_grad", gins, attrs, "bfloat16")
    _close_bf16({k: v for k, v in jg.items() if k in pg},
                pg, "conv2d_grad")
    assert {"Input@GRAD", "Filter@GRAD"} <= set(pg)


@pytest.mark.parametrize("case", [((4, 14, 14, 256), (3, 3, 256, 256), 1, 1),
                                  ((4, 14, 14, 512), (1, 1, 512, 128), 2, 0),
                                  ((2, 7, 7, 4608 // 9), (3, 3, 512, 64),
                                   1, 1)])
def test_k5_bf16_plain_version_against_float64(case):
    """K5's plain version with bfloat16 x and w returns bfloat16 within
    one bfloat16 ulp of its scale of the float64 conv of the same
    (bfloat16) inputs: float32 sums of up to 4608 products, rounded
    once."""
    x_shape, w_shape, stride, pad = case
    r = _rng("k5", case)
    x = torch.from_numpy(_f(r, *x_shape)).to(torch.bfloat16)
    w = torch.from_numpy(_f(r, *w_shape) * 0.05).to(torch.bfloat16)
    y = k5.conv2d_bn_act(x, w, stride=stride, padding=pad)
    assert y.dtype == torch.bfloat16
    ref = torch.nn.functional.conv2d(
        x.double().permute(0, 3, 1, 2), w.double().permute(3, 2, 0, 1),
        stride=stride, padding=pad).permute(0, 2, 3, 1)
    scale = float(ref.abs().max())
    ulp = 2.0 ** (np.floor(np.log2(scale)) - 7)
    assert float((y.double() - ref).abs().max()) <= ulp
