"""The ResNet slice's op functions against the JAX op functions of the same
name, on the same numpy inputs, and their grad ops (``conv2d_grad`` is
hand-written in the port, the others are the auto-VJP; the JAX package
differentiates every one with ``jax.vjp``).

Tolerances: float32 within 1e-5 of the largest magnitude of the compared
tensor (convs and pools sum up to a few hundred terms in another order).
``gaussian_random`` draws from a torch generator, so it is held to its
distribution (mean and std of 2^20 draws within 5 standard errors) and
to its seed, and ``NormalInitializer`` to the JAX package's init op.
"""
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as jfluid
import paddle_tpu_torch as fluid
from paddle_tpu.core.registry import OpInfoMap as JaxOps
from paddle_tpu_torch.core.registry import (DEVICE_ATTR, GENERATOR_ATTR,
                                            OpInfoMap)

CPU = torch.device("cpu")
RNG = np.random.RandomState(3)
TOL = 1e-5


def _f(*shape):
    return np.asarray(RNG.randn(*shape), dtype="float32")


def _to_jax(v):
    return None if v is None else jnp.asarray(v)


def _to_torch(v):
    return None if v is None else torch.from_numpy(np.array(v))


def _np(v):
    if v is None:
        return None
    return v.detach().numpy() if isinstance(v, torch.Tensor) \
        else np.asarray(v)


def _run(op_type, ins, attrs):
    jinfo = JaxOps.instance().get(op_type)
    jattrs = dict(jinfo.attrs)
    jattrs.update(attrs)
    j = jinfo.fn({k: _to_jax(v) for k, v in ins.items()}, jattrs)
    pinfo = OpInfoMap.instance().get(op_type)
    pattrs = dict(pinfo.attrs)
    pattrs.update(attrs)
    pattrs[DEVICE_ATTR] = CPU
    p = pinfo.fn({k: _to_torch(v) for k, v in ins.items()}, pattrs)
    return ({k: _np(v) for k, v in j.items()},
            {k: _np(v) for k, v in p.items()})


def _close(got, want, name):
    assert got is not None and got.shape == want.shape, name
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * scale,
                               err_msg=name)


def _check(op_type, ins, attrs, out_slots):
    """Forward outputs, then ``<op_type>_grad`` with random output grads
    for ``out_slots``: every input grad either package produces."""
    j, p = _run(op_type, ins, attrs)
    for slot, want in j.items():
        if want is None:
            assert p.get(slot) is None, slot
        else:
            _close(p[slot], want, slot)
    gins = dict(ins)
    for slot in out_slots:
        gins[slot + "@GRAD"] = _f(*j[slot].shape)
    jg, pg = _run(op_type + "_grad", gins, attrs)
    assert set(pg) == set(jg) and pg, (sorted(pg), sorted(jg))
    for slot in jg:
        _close(pg[slot], jg[slot], slot)
    return j, p


@pytest.fixture
def conv_flag():
    old = fluid.get_flags("FLAGS_use_pallas_conv")
    yield lambda v: fluid.set_flags({"FLAGS_use_pallas_conv": v})
    fluid.set_flags(old)


def test_the_resnet_slice_ops_are_registered():
    types = set(OpInfoMap.instance().all_op_types())
    assert {"conv2d", "conv2d_grad", "pool2d", "pool2d_grad", "batch_norm",
            "batch_norm_grad", "relu", "relu_grad", "softmax",
            "softmax_grad", "cross_entropy", "cross_entropy_grad",
            "gaussian_random"} <= types
    assert "gaussian_random_grad" not in types


CONV_CASES = {
    # name: (x shape NCHW, filter OIHW, attrs)
    "k5_1x1_s2": ((2, 128, 7, 7), (64, 128, 1, 1), {"strides": [2, 2]}),
    "k5_3x3_s1": ((2, 128, 6, 6), (32, 128, 3, 3), {"paddings": [1, 1]}),
    "k5_3x3_s2": ((2, 128, 7, 7), (32, 128, 3, 3),
                  {"strides": [2, 2], "paddings": [1, 1]}),
    "stem": ((2, 3, 16, 16), (8, 3, 7, 7),
             {"strides": [2, 2], "paddings": [3, 3]}),
    "groups": ((2, 8, 6, 6), (6, 4, 3, 3), {"groups": 2,
                                            "paddings": [1, 1]}),
    "dilation": ((2, 4, 9, 9), (5, 4, 3, 3), {"dilations": [2, 2]}),
    "asym_pads": ((2, 4, 7, 8), (5, 4, 3, 3),
                  {"paddings": [0, 1, 2, 1], "strides": [2, 1]}),
    "same": ((2, 4, 7, 8), (5, 4, 3, 3),
             {"padding_algorithm": "SAME", "strides": [2, 2]}),
    "valid": ((2, 4, 7, 8), (5, 4, 3, 3),
              {"padding_algorithm": "VALID", "paddings": [1, 1]}),
}


@pytest.mark.parametrize("flag", ["off", "all"])
@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_conv2d_and_its_grad(conv_flag, flag, fmt, case):
    conv_flag(flag)
    xs, ws, attrs = CONV_CASES[case]
    x = _f(*xs)
    if fmt == "NHWC":
        x = np.ascontiguousarray(x.transpose(0, 2, 3, 1))
    w = _f(*ws) * np.float32((2.0 / math.prod(ws[1:])) ** 0.5)
    _check("conv2d", {"Input": x, "Filter": w},
           dict(attrs, data_format=fmt), ["Output"])


def test_conv2d_bias_and_residual_slots():
    x, w = _f(2, 3, 5, 5), _f(4, 3, 3, 3)
    ins = {"Input": x, "Filter": w, "Bias": _f(4),
           "ResidualData": _f(2, 4, 3, 3)}
    _check("conv2d", ins, {}, ["Output"])


def test_routed_conv2d_runs_the_plain_kernel_version(conv_flag,
                                                     monkeypatch):
    from paddle_tpu_torch.ops.cuda import conv as k5

    calls = []
    plain = k5.conv2d_bn_act_reference
    monkeypatch.setattr(k5, "conv2d_bn_act_reference",
                        lambda *a, **kw: calls.append(1) or plain(*a, **kw))
    x = np.ascontiguousarray(_f(2, 128, 4, 4).transpose(0, 2, 3, 1))
    ins = {"Input": x, "Filter": _f(16, 128, 1, 1) * np.float32(0.1)}
    attrs = {"data_format": "NHWC"}
    for flag, routed in (("off", 0), ("auto", 0), ("all", 1)):
        conv_flag(flag)
        calls.clear()
        j, p = _run("conv2d", ins, attrs)
        _close(p["Output"], j["Output"], flag)
        assert len(calls) == routed, flag
    # the grad op runs the backward convs alone: no forward re-run
    calls.clear()
    _run("conv2d_grad", dict(ins, **{"Output@GRAD": _f(2, 4, 4, 16)}),
         attrs)
    assert calls == []


def _conv_double_grad_program(pkg, fmt):
    """d/dW of mean(2 dL/dW) for L = mean(gelu(conv2d(x))): the second
    append_backward differentiates ``conv2d_grad``."""
    main, startup = pkg.Program(), pkg.Program()
    startup.random_seed = 1
    shape = [2, 3, 6, 6] if fmt == "NCHW" else [2, 6, 6, 3]
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        x = pkg.data(name="x", shape=shape, dtype="float32")
        h = pkg.layers.conv2d(x, 4, 3, stride=2, padding=1, act="gelu",
                              data_format=fmt)
        loss = pkg.layers.mean(h)
        g = pkg.backward.append_backward(loss)[0][1]
        loss2 = pkg.layers.mean(pkg.layers.elementwise_add(g, g))
        grads = [gg.name for _, gg in pkg.backward.append_backward(loss2)]
    return main, startup, grads, shape


@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
def test_conv2d_grad_of_grad_matches_the_jax_package(fmt):
    jmain, jstartup, jgrads, shape = _conv_double_grad_program(jfluid, fmt)
    pmain, _, pgrads, _ = _conv_double_grad_program(fluid, fmt)
    ops = [op.type for op in pmain.global_block().ops]
    assert ops == [op.type for op in jmain.global_block().ops]
    assert "conv2d_grad_grad" in ops and pgrads == jgrads
    x = _f(*shape)
    exe = jfluid.Executor(jfluid.CPUPlace())
    scope = jfluid.Scope()
    with jfluid.scope_guard(scope):
        exe.run(jstartup)
        init = {p.name: np.asarray(scope.find_var(p.name).get_tensor())
                for p in jmain.all_parameters()}
        want = exe.run(jmain, feed={"x": x}, fetch_list=jgrads)
    pscope = fluid.Scope()
    fluid.io.scope_from_numpy(pscope, init, fluid.CPUPlace())
    got = fluid.Executor(fluid.CPUPlace()).run(
        pmain, feed={"x": x}, fetch_list=pgrads, scope=pscope)
    assert any(np.abs(np.asarray(w)).max() > 1e-3 for w in want)
    for name, g, w in zip(pgrads, got, want):
        _close(np.asarray(g), np.asarray(w), name)


POOL_CASES = {
    "max_pad": {"pooling_type": "max", "ksize": [3, 3], "strides": [2, 2],
                "paddings": [1, 1]},
    "max_ceil": {"pooling_type": "max", "ksize": [3, 3], "strides": [2, 2],
                 "ceil_mode": True},
    "avg_exclusive": {"pooling_type": "avg", "ksize": [3, 3],
                      "strides": [2, 2], "paddings": [1, 1]},
    "avg_inclusive": {"pooling_type": "avg", "ksize": [3, 3],
                      "strides": [2, 2], "paddings": [1, 1],
                      "exclusive": False},
    "avg_ceil": {"pooling_type": "avg", "ksize": [2, 2], "strides": [2, 2],
                 "ceil_mode": True},
    "global_max": {"pooling_type": "max", "global_pooling": True},
    "global_avg": {"pooling_type": "avg", "global_pooling": True},
    "adaptive_avg": {"pooling_type": "avg", "ksize": [2, 3],
                     "adaptive": True},
}


@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
@pytest.mark.parametrize("case", sorted(POOL_CASES))
def test_pool2d_and_its_grad(fmt, case):
    x = _f(2, 3, 4, 9) if "adaptive" in case else _f(2, 3, 8, 9)
    if fmt == "NHWC":
        x = np.ascontiguousarray(x.transpose(0, 2, 3, 1))
    _check("pool2d", {"X": x}, dict(POOL_CASES[case], data_format=fmt),
           ["Out"])


@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
@pytest.mark.parametrize("mode", ["train", "is_test", "use_global_stats"])
def test_batch_norm_five_outputs_and_grad(fmt, mode):
    C = 6
    x = _f(4, C, 3, 5) * np.float32(2.0) + np.float32(1.0)
    if fmt == "NHWC":
        x = np.ascontiguousarray(x.transpose(0, 2, 3, 1))
    ins = {"X": x, "Scale": _f(C) + np.float32(1.0), "Bias": _f(C),
           "Mean": _f(C), "Variance": np.abs(_f(C)) + np.float32(0.5)}
    attrs = {"data_layout": fmt, "momentum": 0.8, "epsilon": 1e-4,
             "is_test": mode == "is_test",
             "use_global_stats": mode == "use_global_stats"}
    j, p = _check("batch_norm", ins, attrs, ["Y"])
    assert set(p) == set(j) == {"Y", "MeanOut", "VarianceOut", "SavedMean",
                                "SavedVariance", "ReserveSpace"}
    axes = (0, 2, 3) if fmt == "NCHW" else (0, 1, 2)
    if mode == "train":
        # the running update with the biased batch variance, and the
        # inverse std saved, as the reference computes them
        bm = x.astype(np.float64).mean(axis=axes)
        bv = x.astype(np.float64).var(axis=axes)
        np.testing.assert_allclose(p["MeanOut"],
                                   0.8 * ins["Mean"] + 0.2 * bm, rtol=1e-5)
        np.testing.assert_allclose(p["VarianceOut"],
                                   0.8 * ins["Variance"] + 0.2 * bv,
                                   rtol=1e-5)
        np.testing.assert_allclose(p["SavedVariance"], 1 / np.sqrt(bv + 1e-4),
                                   rtol=1e-5)
    else:
        np.testing.assert_array_equal(p["MeanOut"], ins["Mean"])
        np.testing.assert_array_equal(p["VarianceOut"], ins["Variance"])


def test_batch_norm_sync_stats_raises():
    """``_sync_stats`` outside a group of replicas takes the local
    statistics (the JAX op's axis None); inside an in-process group the
    one-replica function raises (the engine's replica walk runs the
    group form), and the group form normalizes every replica with the
    group mean of the local means and of the local E[x^2]."""
    from paddle_tpu_torch.ops.collective_ops import (ReplicaGroup,
                                                     ring_axis_guard)

    info = OpInfoMap.instance().get("batch_norm")
    attrs = dict(info.attrs, _sync_stats=True)
    xs = [torch.from_numpy(_f(2, 3, 2, 2)) for _ in range(2)]

    def ins(x):
        return {"X": x, "Scale": torch.ones(3), "Bias": torch.zeros(3),
                "Mean": torch.zeros(3), "Variance": torch.ones(3)}

    local = info.fn(ins(xs[0]), attrs)
    plain = info.fn(ins(xs[0]), dict(info.attrs))
    for k in ("Y", "MeanOut", "VarianceOut"):
        assert torch.equal(local[k], plain[k])
    group = ReplicaGroup(["cpu", "cpu"])
    with ring_axis_guard({0: group}):
        with pytest.raises(RuntimeError, match="replica"):
            info.fn(ins(xs[0]), attrs)
        outs = info.group_fn([ins(x) for x in xs], attrs, group)
    both = torch.cat(xs).double()
    mean = both.mean(dim=(0, 2, 3))
    var = both.square().mean(dim=(0, 2, 3)) - mean.square()
    for o in outs:
        np.testing.assert_allclose(o["SavedMean"], mean, rtol=1e-5)
        np.testing.assert_allclose(o["MeanOut"], 0.1 * mean, rtol=1e-5,
                                   atol=1e-7)
        np.testing.assert_allclose(o["VarianceOut"], 0.9 + 0.1 * var,
                                   rtol=1e-5)
    assert torch.equal(outs[0]["MeanOut"], outs[1]["MeanOut"])


def test_relu_and_its_grad_at_zero():
    x = _f(4, 7)
    x[0, :3] = 0.0
    _check("relu", {"X": x}, {}, ["Out"])


@pytest.mark.parametrize("axis", [-1, 1])
def test_softmax_and_its_grad(axis):
    _check("softmax", {"X": _f(3, 5, 4)}, {"axis": axis}, ["Out"])


@pytest.mark.parametrize("kind", ["hard", "clamped", "ignore", "soft"])
def test_cross_entropy_and_its_grad(kind):
    probs = np.abs(_f(6, 5)) / np.float32(4.0)
    label = RNG.randint(0, 5, (6, 1)).astype("int64")
    attrs = {}
    if kind == "clamped":
        # below, on and above the [1e-20, 1] clip, where the label looks
        probs[0, label[0, 0]] = 0.0
        probs[1, label[1, 0]] = np.float32(1e-20)
        probs[2, label[2, 0]] = 1.0
        probs[3, label[3, 0]] = 3.0
    elif kind == "ignore":
        label[1, 0] = 2
        attrs = {"ignore_index": 2}
    elif kind == "soft":
        label = np.abs(_f(6, 5))
        label /= label.sum(-1, keepdims=True)
        attrs = {"soft_label": True}
    j, p = _check("cross_entropy", {"X": probs, "Label": label}, attrs, ["Y"])
    if kind == "clamped":
        assert p["Y"][0, 0] == pytest.approx(-math.log(1e-20), rel=1e-6)
        assert p["Y"][3, 0] == 0.0


def _draw(seed, shape, mean=0.0, std=1.0, dtype=5):
    info = OpInfoMap.instance().get("gaussian_random")
    gen = torch.Generator(device=CPU)
    gen.manual_seed(seed)
    attrs = dict(info.attrs, shape=list(shape), mean=mean, std=std,
                 dtype=dtype)
    attrs[DEVICE_ATTR] = CPU
    attrs[GENERATOR_ATTR] = gen
    return info.fn({}, attrs)["Out"]


def test_gaussian_random_distribution_and_seed():
    n = 1 << 20
    out = _draw(7, (1024, 1024), mean=0.5, std=2.0)
    assert out.shape == (1024, 1024) and out.dtype == torch.float32
    d = out.double()
    # standard errors: std / sqrt(n) for the mean, std / sqrt(2n) for std
    assert abs(d.mean().item() - 0.5) < 5 * 2.0 / math.sqrt(n)
    assert abs(d.std().item() - 2.0) < 5 * 2.0 / math.sqrt(2 * n)
    assert torch.equal(_draw(7, (64, 3)), _draw(7, (64, 3)))
    assert not torch.equal(_draw(7, (64, 3)), _draw(8, (64, 3)))
    assert _draw(1, (4,), dtype=6).dtype == torch.float64


def test_gaussian_random_startup_is_seeded():
    def run():
        main, startup = fluid.Program(), fluid.Program()
        startup.random_seed = 11
        with fluid.unique_name.guard(), fluid.program_guard(main, startup):
            x = fluid.data(name="x", shape=[2, 128, 8, 8], dtype="float32")
            fluid.layers.conv2d(x, 256, 3, padding=1, bias_attr=False)
        scope = fluid.Scope()
        fluid.Executor(fluid.CPUPlace()).run(startup, scope=scope)
        return scope.find_var("conv2d.w_0").get_tensor().numpy()

    a, b = run(), run()
    np.testing.assert_array_equal(a, b)
    # conv2d's default init: Normal(0, sqrt(2 / fan_in)), fan_in = 128*3*3
    std = math.sqrt(2.0 / (128 * 9))
    assert abs(a.std() - std) < 0.02 * std and abs(a.mean()) < 0.01 * std


def _startup_ops(pkg, build):
    main, startup = pkg.Program(), pkg.Program()
    startup.random_seed = 3
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        build(pkg)
    return [(op.type, op.inputs, op.outputs, op.attrs)
            for op in startup.global_block().ops]


@pytest.mark.parametrize("which", ["normal", "xavier_normal", "conv2d",
                                   "batch_norm"])
def test_initializers_emit_the_jax_init_ops(which):
    def build(pkg):
        x = pkg.data(name="x", shape=[2, 16, 6, 6], dtype="float32")
        init = pkg.initializer
        if which == "normal":
            pkg.layers.fc(x, 4, param_attr=pkg.ParamAttr(
                initializer=init.NormalInitializer(0.5, 0.1, seed=9)))
        elif which == "xavier_normal":
            pkg.layers.fc(x, 4, param_attr=pkg.ParamAttr(
                initializer=init.XavierInitializer(uniform=False)))
        elif which == "conv2d":
            pkg.layers.conv2d(x, 8, 3, stride=2, padding=1,
                              data_format="NCHW")
        else:
            pkg.layers.batch_norm(x, data_layout="NCHW")

    assert _startup_ops(fluid, build) == _startup_ops(jfluid, build)
