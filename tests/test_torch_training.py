"""The training slice end to end, the port against the JAX package.

A narrow version of bench.py's gpt_long (``_build_gpt_long``: batch 2,
S 32, d_model 64, 2 heads, 2 layers, vocab 128; causal flash attention,
Adam 1e-4, float32) is built by one script, ``build_gpt`` here, under
both packages; the port's ``models.gpt.build_gpt_long`` must emit the
same program. The JAX
startup runs, every persistable (parameters, learning rate, moments, beta
powers) is carried into the port's scope with ``io.scope_from_numpy``, and
both train on the same numpy batches:

(a) ``minimize`` emits the same op-type sequence, slots and var names;
(b) three Adam steps with ``PADDLE_TPU_FUSED_OPTIMIZER`` unset and set to
    ``flat``: per-step losses, the step-1 ``@GRAD`` fetches, and the
    persistables after each step agree (in the flat layout the moments
    live in the flat state var, which is compared instead);
(c) the fused flat program holds one ``fused_optimizer`` op.

Tolerances: losses within 1e-4 relative (float32; the JAX side runs its
dense attention and XLA's fused math, the port its plain flash versions
op by op). Grads within 1e-4 of their scale (the larger of their largest
magnitude and 1e-3): float32 sums in another order; the floor covers
grads that are zero by symmetry, such as the key projection's bias
(softmax ignores a shift shared by a row's scores), which are float32
rounding noise of ~1e-9 on both sides. Parameters within 2e-6 absolute: Adam moves every weight by about
lr = 1e-4 per step whatever its grad's size, so the parameter error is
a few float32 rounding steps on that move. Moments within 1e-4 of their
scale, like the grads they follow.
"""
import os

import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu_torch as fluid
from paddle_tpu_torch.models import gpt

BATCH, SEQ, D_MODEL, HEADS, LAYERS, VOCAB = 2, 32, 64, 2, 2, 128
LR = 1e-4
LOSS_RTOL = 1e-4
GRAD_RTOL = 1e-4
GRAD_FLOOR = 1e-3
PARAM_ATOL_PER_STEP = 2 * LR
KNOB = "PADDLE_TPU_FUSED_OPTIMIZER"


def build_gpt(pkg, batch=BATCH, seq_len=SEQ, d_model=D_MODEL, n_heads=HEADS,
              n_layers=LAYERS, vocab=VOCAB, use_bf16=False):
    """bench.py's gpt_long script (``_build_gpt_long``) under ``pkg``:
    (main, startup, loss, params_grads); ``use_bf16`` wraps the optimizer
    in ``mp.decorate`` as bench.py does by default."""
    layers = pkg.layers
    head = d_model // n_heads
    main, startup = pkg.Program(), pkg.Program()
    startup.random_seed = 1
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        ids = pkg.data(name="ids", shape=[batch, seq_len], dtype="int64")
        lbl = pkg.data(name="lbl", shape=[batch * seq_len, 1], dtype="int64")
        x = layers.embedding(ids, size=(vocab, d_model))
        for _ in range(n_layers):
            h = layers.layer_norm(x)
            q, k, v = (layers.fc(h, d_model, num_flatten_dims=2)
                       for _ in range(3))

            def heads(t):
                t = layers.reshape(t, [batch, seq_len, n_heads, head])
                return layers.transpose(t, [0, 2, 1, 3])

            ctx = layers.flash_attention(heads(q), heads(k), heads(v),
                                         causal=True)
            ctx = layers.transpose(ctx, [0, 2, 1, 3])
            ctx = layers.reshape(ctx, [batch, seq_len, d_model])
            x = x + layers.fc(ctx, d_model, num_flatten_dims=2)
            m = layers.fc(layers.layer_norm(x), d_model * 4,
                          num_flatten_dims=2, act="gelu")
            x = x + layers.fc(m, d_model, num_flatten_dims=2)
        logits = layers.fc(layers.layer_norm(x), vocab, num_flatten_dims=2)
        loss = layers.mean(layers.softmax_with_cross_entropy(
            layers.reshape(logits, [batch * seq_len, vocab]), lbl))
        opt = pkg.optimizer.AdamOptimizer(LR)
        if use_bf16:
            opt = pkg.contrib.mixed_precision.decorate(opt)
        _, params_grads = opt.minimize(loss)
    return main, startup, loss, params_grads


def test_build_gpt_long_is_the_bench_script():
    """The port's builder emits exactly this file's script."""
    want = build_gpt(fluid)
    got = gpt.build_gpt_long(BATCH, SEQ, D_MODEL, HEADS, LAYERS, VOCAB,
                             learning_rate=LR, seed=1, use_bf16=False)
    for w, g in zip(want[:2], got[:2]):
        assert _op_seq(g) == _op_seq(w) and g.random_seed == w.random_seed
    assert got[2].name == want[2].name
    assert [(p.name, g.name) for p, g in got[3]] == \
        [(p.name, g.name) for p, g in want[3]]


def batches(n, seed=0):
    rng = np.random.RandomState(seed)
    return [gpt.random_batch(rng, BATCH, SEQ, VOCAB) for _ in range(n)]


def persistables(main, scope):
    out = {}
    for v in main.global_block().vars.values():
        var = scope.find_var(v.name) if v.persistable else None
        if var is not None and var.is_initialized():
            out[v.name] = np.array(var.get_tensor(), dtype=np.float32)
    return out


@pytest.fixture
def knob():
    old = os.environ.pop(KNOB, None)

    def set_(value):
        os.environ.pop(KNOB, None)
        if value is not None:
            os.environ[KNOB] = value

    yield set_
    os.environ.pop(KNOB, None)
    if old is not None:
        os.environ[KNOB] = old


def _train_jax(feeds, grad_names):
    main, startup, loss, pg = build_gpt(jfluid)
    exe = jfluid.Executor(jfluid.CPUPlace())
    scope = jfluid.Scope()
    with jfluid.scope_guard(scope):
        exe.run(startup)
        init = persistables(main, scope)
        losses, states, grads = [], [], None
        for i, feed in enumerate(feeds):
            fetch = [loss] + (grad_names if i == 0 else [])
            res = exe.run(main, feed=feed, fetch_list=fetch)
            losses.append(float(np.asarray(res[0]).reshape(-1)[0]))
            if i == 0:
                grads = [np.asarray(r) for r in res[1:]]
            states.append(persistables(main, scope))
    return main, init, losses, grads, states


def _train_port(feeds, grad_names, init):
    main, startup, loss, pg = build_gpt(fluid)
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    fluid.io.scope_from_numpy(scope, init, fluid.CPUPlace())
    losses, states, grads = [], [], None
    for i, feed in enumerate(feeds):
        fetch = [loss] + (grad_names if i == 0 else [])
        res = exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
        losses.append(float(np.asarray(res[0]).reshape(-1)[0]))
        if i == 0:
            grads = [np.asarray(r) for r in res[1:]]
        states.append(persistables(main, scope))
    return main, losses, grads, states


def _op_seq(program):
    return [(op.type, op.inputs, op.outputs)
            for op in program.global_block().ops]


def test_minimize_emits_the_jax_training_program():
    jmain, jstartup, jloss, jpg = build_gpt(jfluid)
    pmain, pstartup, ploss, ppg = build_gpt(fluid)
    assert [op.type for op in pmain.global_block().ops] == \
        [op.type for op in jmain.global_block().ops]
    assert _op_seq(pmain) == _op_seq(jmain)
    assert _op_seq(pstartup) == _op_seq(jstartup)
    assert [(p.name, g.name) for p, g in ppg] == \
        [(p.name, g.name) for p, g in jpg]
    types = {op.type for op in pmain.global_block().ops}
    assert {"flash_attention_grad", "lookup_table_grad", "sum", "adam",
            "softmax_with_cross_entropy_grad", "mean_grad"} <= types
    # forward, backward and optimizer ops carry their roles
    roles = [op._role for op in pmain.global_block().ops]
    Role = fluid.framework.OpRole
    assert roles[0] == Role.Forward and roles[-1] == Role.Optimize
    assert Role.Backward in roles
    n_params = len(pmain.all_parameters())
    assert [op.type for op in pmain.global_block().ops].count("adam") \
        == n_params == 37


def _compare_states(jstate, pstate, steps, flat_names=()):
    diffs = []
    for name, want in jstate.items():
        if name not in pstate:
            assert "moment" in name and flat_names, name
            continue
        got = pstate[name]
        if name.startswith("fused_opt_") or "moment" in name:
            scale = max(float(np.abs(want).max()), GRAD_FLOOR)
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=GRAD_RTOL * scale,
                                       err_msg=name)
        else:
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=PARAM_ATOL_PER_STEP * steps,
                                       err_msg=name)
            diffs.append(np.abs(got - want).ravel())
    # the bound above is for noise-driven weights; 99.9% of all weight
    # elements agree within 1% of one step's move
    assert np.quantile(np.concatenate(diffs), 0.999) <= 0.01 * LR


@pytest.mark.parametrize("layout", [None, "flat"])
def test_three_adam_steps_match_the_jax_package(knob, layout):
    knob(layout)
    feeds = batches(3)
    _, _, _, pg = build_gpt(jfluid)
    grad_names = [g.name for _, g in pg]
    jmain, init, jlosses, jgrads, jstates = _train_jax(feeds, grad_names)
    pmain, plosses, pgrads, pstates = _train_port(feeds, grad_names, init)

    for lj, lp in zip(jlosses, plosses):
        assert abs(lp - lj) <= LOSS_RTOL * abs(lj), (plosses, jlosses)
    assert np.isfinite(plosses).all()
    for name, gj, gp in zip(grad_names, jgrads, pgrads):
        assert gp.shape == gj.shape, name
        scale = max(float(np.abs(gj).max()), GRAD_FLOOR)
        np.testing.assert_allclose(gp, gj, rtol=0, atol=GRAD_RTOL * scale,
                                   err_msg=name)
    pops = [op.type for op in pmain.global_block().ops]
    jops = [op.type for op in jmain.global_block().ops]
    assert pops == jops
    if layout == "flat":
        assert pops.count("fused_optimizer") == 1 and "adam" not in pops
        fop = next(op for op in pmain.global_block().ops
                   if op.type == "fused_optimizer")
        assert fop.attrs["layout"] == "flat"
        flat = [n for n in pstates[0] if n.startswith("fused_opt_")]
        assert len(flat) == 2
    else:
        assert "fused_optimizer" not in pops and pops.count("adam") == 37
    for step, (js, ps) in enumerate(zip(jstates, pstates), 1):
        _compare_states(js, ps, step, flat_names=layout == "flat")


def test_auto_layout_is_chain_on_the_cpu(knob):
    knob("1")
    main, startup, loss, _ = build_gpt(fluid)
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    (l0,) = exe.run(main, feed=batches(1)[0], fetch_list=[loss], scope=scope)
    fop = [op for op in main.global_block().ops
           if op.type == "fused_optimizer"]
    assert len(fop) == 1 and fop[0].attrs["layout"] == "chain"
    assert np.isfinite(l0).all()


def test_port_startup_trains_on_its_own(knob):
    """The port's own startup (uniform Xavier, constants) and 3 steps on
    one batch: the loss falls and stays finite."""
    knob(None)
    main, startup, loss, _ = build_gpt(fluid)
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    feed = batches(1, seed=4)[0]
    losses = [float(np.asarray(exe.run(main, feed=feed, fetch_list=[loss],
                                       scope=scope)[0]).reshape(-1)[0])
              for _ in range(3)]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    # forward activations are freed after their last reader (a grad op)
    names = set(scope.local_var_names())
    assert not any(n.startswith("fc.tmp") for n in names)


def _double_grad_program(pkg):
    """d/dW of mean(2 dL/dW) for L = mean(fc(gelu(fc(x)))): a second
    append_backward over a program that already holds grad ops."""
    main, startup = pkg.Program(), pkg.Program()
    startup.random_seed = 1
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        x = pkg.data(name="x", shape=[4, 3], dtype="float32")
        h = pkg.layers.fc(x, 5, act="gelu")
        loss = pkg.layers.mean(pkg.layers.fc(h, 2))
        g = pkg.backward.append_backward(loss)[0][1]
        loss2 = pkg.layers.mean(pkg.layers.elementwise_add(g, g))
        grads = [gg.name for _, gg in pkg.backward.append_backward(loss2)]
    return main, startup, grads


def test_grad_of_grad_matches_the_jax_package():
    jmain, jstartup, jgrads = _double_grad_program(jfluid)
    pmain, _, pgrads = _double_grad_program(fluid)
    assert _op_seq(pmain) == _op_seq(jmain)
    assert pgrads == jgrads and all(n.endswith("@GRAD@2") for n in pgrads)
    assert "gelu_grad_grad" in [op.type for op in pmain.global_block().ops]
    x = np.random.RandomState(0).rand(4, 3).astype("float32")
    exe = jfluid.Executor(jfluid.CPUPlace())
    scope = jfluid.Scope()
    with jfluid.scope_guard(scope):
        exe.run(jstartup)
        init = persistables(jmain, scope)
        want = exe.run(jmain, feed={"x": x}, fetch_list=jgrads)
    pscope = fluid.Scope()
    fluid.io.scope_from_numpy(pscope, init, fluid.CPUPlace())
    got = fluid.Executor(fluid.CPUPlace()).run(
        pmain, feed={"x": x}, fetch_list=pgrads, scope=pscope)
    assert any(np.abs(np.asarray(w)).max() > 0.01 for w in want)
    for name, g, w in zip(pgrads, got, want):
        scale = max(float(np.abs(w).max()), GRAD_FLOOR)
        np.testing.assert_allclose(g, w, rtol=0, atol=GRAD_RTOL * scale,
                                   err_msg=name)


def _sgd_program(pkg):
    """fc(size=1) -> mean -> SGDOptimizer(0.5).minimize, and a batch_norm
    whose op is built without its ``is_test`` attr."""
    main, startup = pkg.Program(), pkg.Program()
    startup.random_seed = 1
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        x = pkg.data(name="x", shape=[4, 3], dtype="float32")
        loss = pkg.layers.mean(pkg.layers.fc(x, 1))
        pkg.optimizer.SGDOptimizer(0.5).minimize(loss)
    return main, startup, loss


def _bn_program(pkg):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        x = pkg.data(name="x", shape=[2, 3, 4, 4], dtype="float32")
        pkg.layers.batch_norm(x)
    (op,) = [op for op in main.global_block().ops if op.type == "batch_norm"]
    del op.attrs["is_test"]
    return main


def test_clone_for_test_prunes_as_the_jax_package():
    """clone(for_test=True) drops the backward and optimizer ops by role
    and sets is_test wherever the op type's registered attrs name it; one
    run of the clone changes no persistable."""
    jmain, _, _ = _sgd_program(jfluid)
    pmain, pstartup, ploss = _sgd_program(fluid)
    jtest, ptest = jmain.clone(for_test=True), pmain.clone(for_test=True)
    jtypes = [op.type for op in jtest.global_block().ops]
    assert [op.type for op in ptest.global_block().ops] == jtypes
    assert len(jtypes) == 3 and len(pmain.global_block().ops) == 9
    # the original keeps its ops
    assert [op.type for op in pmain.global_block().ops] == \
        [op.type for op in jmain.global_block().ops]

    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    exe.run(pstartup, scope=scope)
    before = persistables(pmain, scope)
    x = np.random.RandomState(0).rand(4, 3).astype("float32")
    (l0,) = exe.run(ptest, feed={"x": x}, fetch_list=[ploss], scope=scope)
    assert np.isfinite(l0).all()
    after = persistables(pmain, scope)
    assert sorted(after) == sorted(before) and len(before) >= 3
    for name, want in before.items():
        np.testing.assert_array_equal(after[name], want, err_msg=name)

    for pkg in (jfluid, fluid):
        bn = _bn_program(pkg)
        assert "is_test" not in bn.global_block().ops[0].attrs
        (op,) = bn.clone(for_test=True).global_block().ops
        assert op.type == "batch_norm" and op.attrs["is_test"] is True
