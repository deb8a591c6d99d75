"""The fused-epilogue pass (``core.fusion.apply_fused_epilogues``) and its two
ops against the JAX package, on the CPU.

(a) Pass parity on bench.py's six training programs at their full widths
    (gpt_long, BERT-base, Transformer-base WMT with lengths, ResNet-50
    NHWC, MNIST MLP, Wide&Deep), float32 and, where bench.py has it, AMP:
    the port's builders rewritten by the port's pass and bench.py's
    builders rewritten by the JAX pass give the same op sequence, slots
    and attrs, and the chain counts bench.py's programs hold (BERT 37 /
    1, WMT 44 / 2, ResNet-50 16 / 16, gpt_long 6 / 0, MNIST 2, Wide&Deep
    2). Programs are built only; no step runs.
(b) The pass's rules on planted programs, both packages alike: an
    intermediate written twice does not fuse, nothing fuses after the
    first backward op, a dropout with a ``Seed`` input is not absorbed,
    the fused dropout carries ``_rng_op_id`` and not ``_fwd_op_id``, and
    an intermediate stays fetchable after fusion (the twin of
    ``tests/test_single_chip_fusion.py::test_epilogue_preserves_read_intermediates``).
(c) The fused ops and ``tanh`` / ``sigmoid`` against the JAX ops of the
    same name on the same inputs, forward (and the activations' grads),
    within 1e-5 of the output's scale.
(d) Three Adam steps of the narrow gpt, BERT, WMT and MNIST scripts with
    ``PADDLE_TPU_FUSED_EPILOGUE=1`` in both packages, from the JAX
    startup's persistables: losses within 1e-4 relative, step-1 grads and
    moments within 1e-4 of their scale (at least 1e-3), parameters within
    2 lr a step (the limits of ``test_torch_training.py``).
(e) In the port, the pass on against the pass off from the same state and
    executor seed: losses and every persistable bitwise equal after three
    steps, for those scripts and for a narrow encoder with dropout 0.1
    (``upscale_in_train``, dense attention), whose fused ops absorb their
    dropouts.
"""
import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as jfluid
import paddle_tpu.models  # noqa: F401  (jfluid.models)
import paddle_tpu_torch as fluid
from paddle_tpu.core import fusion as jfusion
from paddle_tpu.core.registry import OpInfoMap as JaxOps
from paddle_tpu_torch.core import compiler_engine as pce
from paddle_tpu_torch.core import fusion
from paddle_tpu_torch.core.registry import (DEVICE_ATTR, GENERATOR_ATTR,
                                            OpInfoMap)
from paddle_tpu_torch.models import gpt, transformer
from paddle_tpu_torch.models.resnet import build_resnet_train
from paddle_tpu_torch.models.wide_deep import build_wide_deep

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
import test_torch_book_training as BT  # noqa: E402
import test_torch_training as GT  # noqa: E402
import test_torch_transformer_training as TT  # noqa: E402

EPI = "PADDLE_TPU_FUSED_EPILOGUE"
KNOBS = (EPI, "PADDLE_TPU_FUSED_OPTIMIZER")
LOSS_RTOL = 1e-4
GRAD_RTOL = 1e-4
GRAD_FLOOR = 1e-3
OP_TOL = 1e-5


@pytest.fixture(autouse=True)
def _knobs_off(monkeypatch):
    for k in KNOBS:
        monkeypatch.delenv(k, raising=False)


def _bench():
    sys.path.insert(0, os.path.dirname(HERE))
    import bench

    return bench


def _op_seq(program):
    """(type, inputs, outputs, attrs) of every op, ``cast``'s
    ``in_dtype`` by class (the JAX package infers int32 for int64)."""
    out = []
    for op in program.global_block().ops:
        attrs = dict(op.attrs)
        if op.type == "cast" and attrs.get("in_dtype") == 3:
            attrs["in_dtype"] = 2
        out.append((op.type, op.inputs, op.outputs, attrs))
    return out


def _mnist_port(batch):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.data(name="x", shape=[batch, 784], dtype="float32")
        label = fluid.data(name="label", shape=[batch, 1], dtype="int64")
        pred = fluid.models.mlp(x)
        loss = fluid.layers.mean(fluid.layers.cross_entropy(pred, label))
        fluid.optimizer.AdamOptimizer(1e-3).minimize(loss)
    return main, startup, loss


# bench.py's builder (JAX) and the port's, each at bench.py's full width
BENCH = {
    "gpt_long": (lambda b, amp: b._build_gpt_long(2, 4096, use_bf16=amp),
                 lambda amp: gpt.build_gpt_long(**gpt.GPT_LONG,
                                                use_bf16=amp)),
    "bert": (lambda b, amp: b._build_bert_base(32, 128, use_bf16=amp),
             lambda amp: transformer.build_bert_base(
                 **transformer.BERT_BASE, use_bf16=amp)),
    "wmt": (lambda b, amp: b._build_transformer_wmt(
        64, 256, use_bf16=amp, use_lengths=True),
        lambda amp: transformer.build_transformer_wmt(
            **transformer.WMT, use_lengths=True, use_bf16=amp)),
    "resnet50": (lambda b, amp: b._build_resnet50(
        128, use_bf16=amp, data_format="NHWC"),
        lambda amp: build_resnet_train(128, use_bf16=amp)),
    "mnist_mlp": (lambda b, amp: b._build_mnist_mlp(512),
                  lambda amp: _mnist_port(512)),
    "wide_deep": (lambda b, amp: b._build_wide_deep(2048),
                  lambda amp: build_wide_deep(2048)),
}
# (fused_bias_act, fused_residual_layer_norm) a program holds after the pass
CHAINS = {
    ("gpt_long", False): (2, 4), ("gpt_long", True): (0, 0),
    ("bert", False): (12, 25), ("bert", True): (0, 1),
    ("wmt", False): (12, 32), ("wmt", True): (0, 2),
    ("resnet50", False): (16, 0), ("resnet50", True): (16, 0),
    ("mnist_mlp", False): (2, 0), ("wide_deep", False): (2, 0),
}


@pytest.mark.parametrize("name,amp", sorted(CHAINS),
                         ids=["%s-%s" % (n, "amp" if a else "f32")
                              for n, a in sorted(CHAINS)])
def test_the_pass_rewrites_bench_programs_as_the_jax_pass(name, amp):
    jbuild, pbuild = BENCH[name]
    with jfluid.unique_name.guard():
        want = jbuild(_bench(), amp)[0]
    got = pbuild(amp)[0]
    assert _op_seq(got) == _op_seq(want)
    n_before = len(got.global_block().ops)
    pce.reset_counters()
    n_j = jfusion.apply_fused_epilogues(want)
    n_p = fusion.apply_fused_epilogues(got)
    assert _op_seq(got) == _op_seq(want)
    types = [op.type for op in got.global_block().ops]
    bias_act, res_ln = CHAINS[(name, amp)]
    assert (types.count("fused_bias_act"),
            types.count("fused_residual_layer_norm")) == (bias_act, res_ln)
    assert n_p == n_j == bias_act + res_ln == \
        pce.counters()["fusion.epilogue_chains"]
    assert len(types) == n_before - n_p - sum(
        op.attrs["dropout_prob"] >= 0 for op in got.global_block().ops
        if op.type == "fused_bias_act")
    assert fusion.apply_fused_epilogues(got) == 0  # once a program


# -- (b) the rules, on planted programs ------------------------------------

def _planted(pkg, case):
    """A forward chain the pass must treat as the JAX pass does."""
    layers = pkg.layers
    main, startup = pkg.Program(), pkg.Program()
    startup.random_seed = 2
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        x = pkg.data(name="x", shape=[8, 16], dtype="float32")
        lbl = pkg.data(name="lbl", shape=[8, 1], dtype="int64")
        h = layers.fc(x, size=16, act="gelu")
        if case == "rebound":
            # the act's output written twice: not a private edge
            layers.assign(x, output=h)
        if case == "seeded_dropout":
            blk = main.global_block()
            seed = layers.fill_constant([1], "int32", 7)
            out = blk.create_var(name="d.out", shape=h.shape,
                                 dtype="float32")
            mask = blk.create_var(name="d.mask", shape=h.shape,
                                  dtype="float32")
            blk.append_op("dropout", inputs={"X": [h], "Seed": [seed]},
                          outputs={"Out": [out], "Mask": [mask]},
                          attrs={"dropout_prob": 0.3})
            h = out
        elif case in ("dropout", "after_backward"):
            h = layers.dropout(h, dropout_prob=0.3)
        h = layers.fc(h, size=16, act="tanh")
        h = layers.elementwise_add(h, x)
        h = layers.layer_norm(h)
        pred = layers.fc(h, size=10, act="softmax")
        loss = layers.mean(layers.cross_entropy(pred, lbl))
        pkg.optimizer.SGD(0.1).minimize(loss)
        if case == "after_backward":
            # a forward-looking chain after the backward: never fused
            tail = layers.elementwise_add(x, x)
            layers.sigmoid(tail)
    return main, startup, loss


PLANTED = ["plain", "rebound", "dropout", "seeded_dropout",
           "after_backward"]


@pytest.mark.parametrize("case", PLANTED)
def test_the_rules_on_planted_programs(case):
    want, got = (_planted(pkg, case)[0] for pkg in (jfluid, fluid))
    assert _op_seq(got) == _op_seq(want)
    n = (jfusion.apply_fused_epilogues(want),
         fusion.apply_fused_epilogues(got))
    assert _op_seq(got) == _op_seq(want)
    ops = got.global_block().ops
    types = [op.type for op in ops]
    bias_act = [op for op in ops if op.type == "fused_bias_act"]
    expect = {"plain": 3, "rebound": 2, "dropout": 3, "seeded_dropout": 3,
              "after_backward": 3}[case]
    assert n == (expect, expect), n
    assert types.count("fused_residual_layer_norm") == 1
    if case == "rebound":
        assert bias_act[0].attrs["act"] == "tanh"  # the gelu chain stays
        assert "gelu" in types
    if case == "dropout":
        (fd,) = [op for op in bias_act if op.attrs["dropout_prob"] >= 0]
        assert "_rng_op_id" in fd.attrs and "_fwd_op_id" not in fd.attrs
        assert fd.output("ActOut") and fd.output("Mask")
        assert "dropout" not in types and "dropout_grad" in types
    if case == "seeded_dropout":
        assert "dropout" in types
        assert all(op.attrs["dropout_prob"] < 0 for op in bias_act)
    if case == "after_backward":
        assert types[-1] == "sigmoid" and types[-2] == "elementwise_add"


def test_a_fused_intermediate_stays_fetchable(monkeypatch):
    monkeypatch.setenv(EPI, "1")
    feed = {"x": np.random.RandomState(0).rand(8, 16).astype("float32"),
            "lbl": np.random.RandomState(1).randint(0, 10, (8, 1))
            .astype("int64")}
    init, out = None, {}
    for name, pkg in (("jax", jfluid), ("port", fluid)):
        main, startup, loss = _planted(pkg, "plain")
        exe = pkg.Executor(pkg.CPUPlace())
        scope = pkg.Scope()
        if init is None:
            with pkg.scope_guard(scope):
                exe.run(startup)
            init = _persistables(main, scope)
        else:
            fluid.io.scope_from_numpy(scope, init, fluid.CPUPlace())
        exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
        fop = next(op for op in main.global_block().ops
                   if op.type == "fused_bias_act")
        inter = fop.output("AddOut")[0]
        out[name] = [np.asarray(v) for v in exe.run(
            main, feed=feed, fetch_list=[loss, inter], scope=scope)]
        assert out[name][1].shape == (8, 16)
    for a, b in zip(out["port"], out["jax"]):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)


# -- (c) the ops against the JAX ops ----------------------------------------

def _run_op(op_type, ins, attrs):
    jinfo = JaxOps.instance().get(op_type)
    ja = dict(jinfo.attrs)
    ja.update(attrs)
    j = jinfo.fn({k: None if v is None else jnp.asarray(v)
                  for k, v in ins.items()}, ja)
    pinfo = OpInfoMap.instance().get(op_type)
    pa = dict(pinfo.attrs)
    pa.update(attrs)
    pa[DEVICE_ATTR] = torch.device("cpu")
    pa[GENERATOR_ATTR] = torch.Generator()
    p = pinfo.fn({k: None if v is None else torch.from_numpy(np.array(v))
                  for k, v in ins.items()}, pa)
    return ({k: np.asarray(v) for k, v in j.items() if v is not None},
            {k: v.detach().numpy() for k, v in p.items() if v is not None})


def _close(got, want, name):
    assert got.shape == want.shape and got.dtype == want.dtype, name
    scale = max(float(np.abs(want).max(initial=0.0)), 1.0)
    np.testing.assert_allclose(got, want, rtol=0, atol=OP_TOL * scale,
                               err_msg=name)


@pytest.mark.parametrize("act", ["tanh", "sigmoid"])
def test_tanh_and_sigmoid_match_the_jax_ops(act):
    rng = np.random.RandomState(3)
    x = (3 * rng.randn(4, 33)).astype("float32")
    j, p = _run_op(act, {"X": x}, {})
    _close(p["Out"], j["Out"], act)
    g = rng.randn(4, 33).astype("float32")
    j, p = _run_op(act + "_grad", {"X": x, "Out@GRAD": g}, {})
    _close(p["X@GRAD"], j["X@GRAD"], act + "_grad")


@pytest.mark.parametrize("act", list(fusion.EPILOGUE_ACTS))
def test_fused_bias_act_matches_the_jax_op(act):
    rng = np.random.RandomState(4)
    x = rng.randn(6, 10).astype("float32")
    y = rng.randn(10).astype("float32")
    attrs = {"act": act, "approximate": act == "gelu"}
    j, p = _run_op("fused_bias_act", {"X": x, "Y": y}, attrs)
    assert set(p) == set(j) == {"Out", "AddOut", "ActOut"}
    for k in j:
        _close(p[k], j[k], k)


def test_fused_residual_layer_norm_matches_the_jax_op():
    rng = np.random.RandomState(5)
    x, y = (rng.randn(2, 5, 12).astype("float32") for _ in range(2))
    ins = {"X": x, "Y": y, "Scale": rng.rand(12).astype("float32"),
           "Bias": rng.randn(12).astype("float32")}
    j, p = _run_op("fused_residual_layer_norm", ins,
                   {"begin_norm_axis": 2, "epsilon": 1e-5})
    assert set(p) == set(j) == {"Out", "AddOut", "Mean", "Variance"}
    for k in j:
        _close(p[k], j[k], k)


def test_the_fused_ops_have_no_grad_and_draw_random_numbers():
    for pkg_ops in (OpInfoMap.instance(), JaxOps.instance()):
        for t in ("fused_bias_act", "fused_residual_layer_norm"):
            assert pkg_ops.get(t).grad is None
            assert not pkg_ops.has(t + "_grad")
        assert pkg_ops.get("fused_bias_act").needs_rng
        assert not pkg_ops.get("fused_residual_layer_norm").needs_rng


# -- (d) three Adam steps with the pass on, against the JAX package ---------

SCRIPTS = {
    "gpt": (GT.build_gpt, lambda: GT.batches(3)),
    "bert": (lambda pkg: TT.build(pkg, "bert"), lambda: TT.feeds("bert")),
    "wmt": (lambda pkg: TT.build(pkg, "wmt_lengths"),
            lambda: TT.feeds("wmt_lengths")),
    "mnist": (lambda pkg: BT.build(pkg, "mlp"), lambda: BT.feeds("mlp")),
}
LRS = {"gpt": GT.LR, "bert": TT.LR, "wmt": TT.LR, "mnist": BT.LR}


def _persistables(main, scope):
    out = {}
    for v in main.global_block().vars.values():
        var = scope.find_var(v.name) if v.persistable else None
        if var is not None and var.is_initialized():
            out[v.name] = np.array(var.get_tensor(), dtype=np.float32)
    return out


def _train(pkg, script, init=None, exe_seed=None, fetch_grads=True):
    build, feeds = SCRIPTS[script]
    main, startup, loss, pg = build(pkg)
    grad_names = [g.name for _, g in pg] if fetch_grads else []
    exe = pkg.Executor(pkg.CPUPlace())
    if exe_seed is not None:
        exe._core.rng.seed = exe_seed
    scope = pkg.Scope()
    if init is None:
        with pkg.scope_guard(scope):
            exe.run(startup)
        init = _persistables(main, scope)
    else:
        fluid.io.scope_from_numpy(scope, init, fluid.CPUPlace())
    losses, grads, states = [], None, []
    for i, feed in enumerate(feeds()):
        res = exe.run(main, feed=feed, scope=scope,
                      fetch_list=[loss] + (grad_names if i == 0 else []))
        losses.append(float(np.asarray(res[0]).reshape(-1)[0]))
        if i == 0:
            grads = [np.asarray(r) for r in res[1:]]
        states.append(_persistables(main, scope))
    return {"main": main, "init": init, "losses": losses, "grads": grads,
            "grad_names": grad_names, "states": states}


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_three_adam_steps_with_the_pass_match_the_jax_package(
        monkeypatch, script):
    monkeypatch.setenv(EPI, "1")
    j = _train(jfluid, script)
    p = _train(fluid, script, init=j["init"])
    assert _op_seq(p["main"]) == _op_seq(j["main"])
    types = [op.type for op in p["main"].global_block().ops]
    assert "fused_bias_act" in types
    for lj, lp in zip(j["losses"], p["losses"]):
        assert abs(lp - lj) <= LOSS_RTOL * abs(lj), (p["losses"],
                                                      j["losses"])
    for name, gj, gp in zip(j["grad_names"], j["grads"], p["grads"]):
        scale = max(float(np.abs(gj).max()), GRAD_FLOOR)
        np.testing.assert_allclose(gp, gj, rtol=0, atol=GRAD_RTOL * scale,
                                   err_msg=name)
    for step, (js, ps) in enumerate(zip(j["states"], p["states"]), 1):
        for name, want in js.items():
            if "moment" in name:
                atol = GRAD_RTOL * max(float(np.abs(want).max()), GRAD_FLOOR)
            else:
                atol = 2 * LRS[script] * step
            np.testing.assert_allclose(ps[name], want, rtol=0, atol=atol,
                                       err_msg=name)


# -- (e) the pass on against the pass off, bitwise, in the port -------------

def _dropout_encoder(pkg):
    main, startup = pkg.Program(), pkg.Program()
    startup.random_seed = 4
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        ids = pkg.data(name="ids", shape=[2, 16], dtype="int64")
        pos = pkg.data(name="pos", shape=[2, 16], dtype="int64")
        enc = pkg.models.transformer.transformer_encoder(
            ids, pos, 64, max_len=16, num_layers=2, num_heads=2, d_model=32,
            d_ff=64, dropout=0.1)
        loss = pkg.layers.mean(pkg.layers.reduce_sum(enc, dim=-1))
        _, pg = pkg.optimizer.AdamOptimizer(1e-3).minimize(loss)
    return main, startup, loss, pg


def _dropout_feeds():
    rng = np.random.RandomState(9)
    pos = np.tile(np.arange(16), (2, 1)).astype("int64")
    return [{"ids": rng.randint(0, 64, (2, 16)).astype("int64"), "pos": pos}
            for _ in range(3)]


def _mlp_dropout(pkg):
    """fc(gelu) -> dropout, the chain the pass absorbs whole (the twin of
    ``test_single_chip_fusion.py::test_epilogue_dropout_stream_parity``)."""
    main, startup = pkg.Program(), pkg.Program()
    startup.random_seed = 5
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        x = pkg.data(name="x", shape=[8, 16], dtype="float32")
        lbl = pkg.data(name="lbl", shape=[8, 1], dtype="int64")
        h = pkg.layers.fc(x, size=32, act="gelu")
        h = pkg.layers.dropout(h, dropout_prob=0.3)
        pred = pkg.layers.fc(h, size=10, act="softmax")
        loss = pkg.layers.mean(pkg.layers.cross_entropy(pred, lbl))
        _, pg = pkg.optimizer.AdamOptimizer(1e-3).minimize(loss)
    return main, startup, loss, pg


def _mlp_feeds():
    rng = np.random.RandomState(7)
    return [{"x": rng.rand(8, 16).astype("float32"),
             "lbl": rng.randint(0, 10, (8, 1)).astype("int64")}
            for _ in range(3)]


SCRIPTS["dropout_encoder"] = (_dropout_encoder, _dropout_feeds)
SCRIPTS["mlp_dropout"] = (_mlp_dropout, _mlp_feeds)


@pytest.mark.parametrize("script", ["dropout_encoder", "mlp_dropout", "bert",
                                    "wmt", "gpt", "mnist"])
def test_the_pass_on_and_off_give_the_same_bits(monkeypatch, script):
    init = _train(fluid, script, fetch_grads=False)["init"]
    runs = {}
    for knob in (None, "1"):
        monkeypatch.delenv(EPI, raising=False)
        if knob:
            monkeypatch.setenv(EPI, knob)
        runs[knob] = _train(fluid, script, init=init, exe_seed=123,
                            fetch_grads=False)
    off, on = runs[None], runs["1"]
    on_types = [op.type for op in on["main"].global_block().ops]
    assert "fused_bias_act" in on_types
    assert "fused_bias_act" not in [op.type for op in
                                    off["main"].global_block().ops]
    absorbed = [op for op in on["main"].global_block().ops
                if op.type == "fused_bias_act"
                and op.attrs["dropout_prob"] >= 0]
    if script == "dropout_encoder":
        # an add -> dropout chain has no activation: its dropouts stay
        assert on_types.count("dropout") == 3 * 2 and not absorbed
    if script == "mlp_dropout":
        assert len(absorbed) == 1 and "dropout" not in on_types
    assert on["losses"] == off["losses"]
    for a, b in zip(off["states"], on["states"]):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
