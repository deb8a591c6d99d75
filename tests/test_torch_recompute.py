"""Recompute (``append_backward(checkpoints=...)``, ``RecomputeOptimizer``),
``fluid.gradients`` and the training recipes' programs, the port against
the JAX package, on the CPU.

- A 2-layer narrow gpt (checkpoints at each block's residual output) and
  a 2-layer narrow BERT (checkpoints at each encoder layer's output) with
  ``RecomputeOptimizer`` build the JAX package's program, op for op
  (the re-emitted forward ops with their ``@RECOMPUTE`` outputs and
  ``_fwd_op_id``), and their step-1 grads equal the same program's
  without recompute within 1e-6 of each grad's scale (the larger of its
  largest magnitude and 1e-3): the recomputed forward is the same ops on
  the same values. The same holds for the BERT with dropout 0.1, inside
  the port (the recomputed dropout draws the forward's mask: same
  executor seed, same op ids), and for the gpt under ``mp.decorate``.
  The gpt's grads with recompute also match the JAX package's within
  ``test_torch_training.py``'s 1e-4.
- ``fluid.gradients`` builds the JAX package's program and fetches its
  grads within 1e-5 of their scale.
- The narrow versions of ``chip_smoke.py`` phases 34-37 (BERT under
  AdamW, a global-norm clip and a warm-up over a linear decay; BERT under
  LAMB; ResNet-50 under Momentum, L2 decay and a piecewise rate; gpt_long
  under recompute; all in bf16 AMP) and the same four at full width
  (built, not run) give the JAX package's programs after the epilogue
  and optimizer passes: the same op types, the same fused_bias_act,
  fused_residual_layer_norm and fused_optimizer counts. The port's
  builders (``models.*`` with ``optimizer_fn``, ``recompute``) emit the
  scripts' programs.
"""
import os
import sys

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu.models  # noqa: F401  (jfluid.models)
import paddle_tpu_torch as fluid
from paddle_tpu.core import fusion as jfusion
from paddle_tpu_torch.core import fusion
from paddle_tpu_torch.models import gpt
from paddle_tpu_torch.models import transformer as T
from paddle_tpu_torch.models.resnet import build_resnet_train

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import test_torch_lr_schedule as LS  # noqa: E402

GRAD_RTOL = 1e-6
JAX_GRAD_RTOL = 1e-4
FLOOR = 1e-3
GPT = dict(batch=2, seq_len=32, d_model=64, n_heads=2, n_layers=2,
           vocab=128)
BERT = dict(batch=2, seq_len=16, vocab=64, num_layers=2, num_heads=2,
            d_model=32, d_ff=64, masked=5)


def gpt_script(pkg, make_opt=None, recompute=False, use_bf16=False,
               batch=2, seq_len=32, d_model=64, n_heads=2, n_layers=2,
               vocab=128):
    """bench.py's gpt_long script under ``pkg`` with ``make_opt(pkg)``'s
    optimizer (Adam 1e-4 by default), optionally under recompute with a
    checkpoint at each block's residual output."""
    L = pkg.layers
    head = d_model // n_heads
    main, startup = pkg.Program(), pkg.Program()
    startup.random_seed = 1
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        ids = pkg.data(name="ids", shape=[batch, seq_len], dtype="int64")
        lbl = pkg.data(name="lbl", shape=[batch * seq_len, 1], dtype="int64")
        x = L.embedding(ids, size=(vocab, d_model))
        checkpoints = []
        for _ in range(n_layers):
            h = L.layer_norm(x)
            q, k, v = (L.fc(h, d_model, num_flatten_dims=2)
                       for _ in range(3))

            def heads(t):
                t = L.reshape(t, [batch, seq_len, n_heads, head])
                return L.transpose(t, [0, 2, 1, 3])

            ctx = L.flash_attention(heads(q), heads(k), heads(v),
                                    causal=True)
            ctx = L.reshape(L.transpose(ctx, [0, 2, 1, 3]),
                            [batch, seq_len, d_model])
            x = x + L.fc(ctx, d_model, num_flatten_dims=2)
            m = L.fc(L.layer_norm(x), d_model * 4, num_flatten_dims=2,
                     act="gelu")
            x = x + L.fc(m, d_model, num_flatten_dims=2)
            checkpoints.append(x)
        logits = L.fc(L.layer_norm(x), vocab, num_flatten_dims=2)
        loss = L.mean(L.softmax_with_cross_entropy(
            L.reshape(logits, [batch * seq_len, vocab]), lbl))
        opt = (make_opt(pkg) if make_opt else
               pkg.optimizer.AdamOptimizer(1e-4))
        if recompute:
            opt = pkg.optimizer.RecomputeOptimizer(opt)
            opt._set_checkpoints(checkpoints)
        main.checkpoint_names = [c.name for c in checkpoints]
        if use_bf16:
            opt = pkg.contrib.mixed_precision.decorate(opt)
        _, params_grads = opt.minimize(loss)
    return main, startup, loss, params_grads


def bert_script(pkg, make_opt=None, recompute=False, use_bf16=False,
                dropout=0.0, batch=2, seq_len=16, vocab=64, num_layers=2,
                num_heads=2, d_model=32, d_ff=64, masked=5):
    """bench.py's BERT script under ``pkg`` with ``make_opt(pkg)``'s
    optimizer, optionally under recompute with a checkpoint at each
    encoder layer's output (its second layer_norm)."""
    L = pkg.layers
    main, startup = pkg.Program(), pkg.Program()
    startup.random_seed = 1
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        src = pkg.data(name="src", shape=[batch, seq_len], dtype="int64")
        pos = pkg.data(name="pos", shape=[batch, seq_len], dtype="int64")
        mpos = pkg.data(name="mpos", shape=[batch, masked], dtype="int64")
        labels = pkg.data(name="labels", shape=[batch, masked, 1],
                          dtype="int64")
        logits = pkg.models.bert_base_pretrain(
            src, pos, mpos, vocab_size=vocab, max_len=seq_len,
            num_layers=num_layers, num_heads=num_heads, d_model=d_model,
            d_ff=d_ff, dropout=dropout)
        loss = L.mean(L.softmax_with_cross_entropy(
            L.reshape(logits, [batch * masked, vocab]),
            L.reshape(labels, [batch * masked, 1])))
        opt = (make_opt(pkg) if make_opt else
               pkg.optimizer.AdamOptimizer(1e-4))
        norms = [op.output("Y")[0] for op in main.global_block().ops
                 if op.type == "layer_norm"]
        main.checkpoint_names = norms[2::2]
        if recompute:
            opt = pkg.optimizer.RecomputeOptimizer(opt)
            opt._set_checkpoints([main.global_block().var(n)
                                  for n in main.checkpoint_names])
        if use_bf16:
            opt = pkg.contrib.mixed_precision.decorate(opt)
        _, params_grads = opt.minimize(loss)
    return main, startup, loss, params_grads


def resnet_script(pkg, make_opt, use_bf16=False, batch=4, image_size=64,
                  class_dim=10):
    main, startup = pkg.Program(), pkg.Program()
    startup.random_seed = 1
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        img = pkg.data(name="img", shape=[batch, image_size, image_size, 3],
                       dtype="float32")
        label = pkg.data(name="label", shape=[batch, 1], dtype="int64")
        pred = pkg.models.resnet(img, class_dim, 50, data_format="NHWC")
        loss = pkg.layers.mean(pkg.layers.cross_entropy(pred, label))
        opt = make_opt(pkg)
        if use_bf16:
            opt = pkg.contrib.mixed_precision.decorate(opt)
        _, params_grads = opt.minimize(loss)
    return main, startup, loss, params_grads


SCRIPTS = {"gpt": (gpt_script, lambda rng: gpt.random_batch(
    rng, GPT["batch"], GPT["seq_len"], GPT["vocab"])),
    "bert": (bert_script, lambda rng: T.bert_batch(
        rng, BERT["batch"], BERT["seq_len"], BERT["vocab"], BERT["masked"]))}


def _step1_grads(script, recompute, use_bf16=False, dropout=0.0,
                 init=None, exe_seed=3):
    make, batch = SCRIPTS[script]
    kw = {"dropout": dropout} if script == "bert" else {}
    main, startup, loss, pg = make(fluid, recompute=recompute,
                                   use_bf16=use_bf16, **kw)
    exe = fluid.Executor(fluid.CPUPlace())
    exe._core.rng.seed = exe_seed
    scope = fluid.Scope()
    if init is None:
        exe.run(startup, scope=scope)
    else:
        fluid.io.scope_from_numpy(scope, init, fluid.CPUPlace())
    out = exe.run(main, feed=batch(np.random.RandomState(5)), scope=scope,
                  fetch_list=[loss] + [g for _, g in pg])
    return main, [np.asarray(o) for o in out], LS.persistables(main, scope)


def _assert_grads_close(got, want, rtol):
    for g, w in zip(got, want):
        scale = max(float(np.abs(w).max()), FLOOR)
        np.testing.assert_allclose(g, w, rtol=0, atol=rtol * scale)


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_recompute_builds_the_jax_program(script):
    make, _ = SCRIPTS[script]
    jmain = make(jfluid, recompute=True)[0]
    pmain = make(fluid, recompute=True)[0]
    assert LS.op_seq(pmain) == LS.op_seq(jmain)
    ops = pmain.global_block().ops
    recomputed = [op for op in ops if any(
        n.endswith("@RECOMPUTE") for n in op.output_arg_names)]
    assert recomputed and all("_fwd_op_id" in op.attrs for op in recomputed)
    # every grad op reads recomputed forward values, none the originals
    # of a recomputed output: only the checkpoints are kept
    renamed = {n[:-len("@RECOMPUTE")] for op in recomputed
               for n in op.output_arg_names if n.endswith("@RECOMPUTE")}
    renamed -= set(pmain.checkpoint_names)
    assert renamed
    for op in ops:
        if op.type.endswith("_grad"):
            assert not renamed & set(
                n for slot, ns in op.inputs.items()
                if not slot.endswith("@GRAD") for n in ns), op.type
    if script == "gpt":
        # flash attention runs in the forward, again recomputed, and again
        # in its auto-VJP grad op
        assert [op.type for op in ops].count("flash_attention") == 4
        assert [op.type for op in ops].count("flash_attention_grad") == 2


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_recompute_gives_the_grads_without_it(script):
    init = _startup_state(script)
    _, plain, _ = _step1_grads(script, False, init=init)
    _, rec, _ = _step1_grads(script, True, init=init)
    assert len(rec) == len(plain)
    _assert_grads_close(rec, plain, GRAD_RTOL)


def _startup_state(script, use_bf16=False, dropout=0.0):
    make, _ = SCRIPTS[script]
    kw = {"dropout": dropout} if script == "bert" else {}
    main, startup, _, _ = make(fluid, use_bf16=use_bf16, **kw)
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    return LS.persistables(main, scope)


def test_recompute_with_dropout_draws_the_forward_mask():
    init = _startup_state("bert", dropout=0.1)
    main, plain, _ = _step1_grads("bert", False, dropout=0.1, init=init)
    assert "dropout" in [op.type for op in main.global_block().ops]
    rmain, rec, _ = _step1_grads("bert", True, dropout=0.1, init=init)
    assert [op.type for op in rmain.global_block().ops].count("dropout") > \
        [op.type for op in main.global_block().ops].count("dropout")
    _assert_grads_close(rec, plain, GRAD_RTOL)
    # another executor seed draws other masks: the grads move
    _, other, _ = _step1_grads("bert", True, dropout=0.1, init=init,
                               exe_seed=4)
    assert any(not np.allclose(a, b) for a, b in zip(other[1:], rec[1:]))


def test_recompute_under_amp_gives_the_grads_without_it():
    init = _startup_state("gpt", use_bf16=True)
    _, plain, _ = _step1_grads("gpt", False, use_bf16=True, init=init)
    main, rec, _ = _step1_grads("gpt", True, use_bf16=True, init=init)
    assert "cast" in [op.type for op in main.global_block().ops]
    _assert_grads_close(rec, plain, GRAD_RTOL)


def test_recompute_grads_match_the_jax_package():
    jmain, jstartup, jloss, jpg = gpt_script(jfluid, recompute=True)
    pmain, _, ploss, ppg = gpt_script(fluid, recompute=True)
    jexe = jfluid.Executor(jfluid.CPUPlace())
    jscope = jfluid.Scope()
    jexe.run(jstartup, scope=jscope)
    pscope = fluid.Scope()
    LS.carry(jmain, jscope, pmain, pscope)
    feed = SCRIPTS["gpt"][1](np.random.RandomState(5))
    j = jexe.run(jmain, feed=feed, scope=jscope,
                 fetch_list=[jloss] + [g for _, g in jpg])
    p = fluid.Executor(fluid.CPUPlace()).run(
        pmain, feed=feed, scope=pscope,
        fetch_list=[ploss] + [g for _, g in ppg])
    np.testing.assert_allclose(np.asarray(p[0]), np.asarray(j[0]),
                               rtol=JAX_GRAD_RTOL)
    _assert_grads_close([np.asarray(x) for x in p[1:]],
                        [np.asarray(x) for x in j[1:]], JAX_GRAD_RTOL)


def test_the_port_builder_emits_the_recompute_script():
    want = gpt_script(fluid, recompute=True, use_bf16=True)
    got = gpt.build_gpt_long(**GPT, learning_rate=1e-4, seed=1,
                             use_bf16=True, recompute=True)
    assert LS.op_seq(got[0]) == LS.op_seq(want[0])
    assert LS.op_seq(got[1]) == LS.op_seq(want[1])


def test_recompute_optimizer_checks_its_use():
    opt = fluid.optimizer.RecomputeOptimizer(fluid.optimizer.SGD(0.1))
    with pytest.raises(ValueError, match="list"):
        opt._set_checkpoints("x")
    with pytest.raises(NotImplementedError, match="load"):
        opt.load({})
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.data(name="x", shape=[2, 3], dtype="float32")
        loss = fluid.layers.mean(fluid.layers.fc(x, 2))
        with pytest.raises(ValueError, match="_set_checkpoints"):
            opt.minimize(loss)


# -- fluid.gradients ----------------------------------------------------------

def _gradients_program(pkg):
    main, startup = pkg.Program(), pkg.Program()
    startup.random_seed = 1
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        x = pkg.data(name="x", shape=[4, 3], dtype="float32")
        x.stop_gradient = False
        h = pkg.layers.fc(x, 5, act="tanh")
        y = pkg.layers.mean(pkg.layers.square(h))
        gx, gw = pkg.gradients(y, [x, main.all_parameters()[0]])
    return main, startup, [y, gx, gw]


def test_gradients_matches_the_jax_package():
    jmain, _, _ = _gradients_program(jfluid)
    pmain, _, _ = _gradients_program(fluid)
    assert LS.op_seq(pmain) == LS.op_seq(jmain)
    feed = {"x": np.random.RandomState(2).randn(4, 3).astype("float32")}
    (j, _), (p, _), _ = LS.train_both(_gradients_program, [feed],
                                    jax_seed=37)
    assert len(p[0]) == 3
    _assert_grads_close(p[0], j[0], 1e-5)


# -- the recipes' programs after both passes ----------------------------------

def _bert_adamw(pkg):
    L = pkg.layers
    lr = L.linear_lr_warmup(
        L.polynomial_decay(1e-4, decay_steps=12, end_learning_rate=0.0,
                           power=1.0), warmup_steps=4, start_lr=0.0,
        end_lr=1e-4)
    return pkg.optimizer.AdamW(
        lr, weight_decay=0.01,
        grad_clip=pkg.clip.GradientClipByGlobalNorm(1.0))


def _bert_lamb(pkg):
    L = pkg.layers
    lr = L.linear_lr_warmup(
        L.polynomial_decay(1e-4, decay_steps=12, end_learning_rate=0.0,
                           power=1.0), warmup_steps=4, start_lr=0.0,
        end_lr=1e-4)
    return pkg.optimizer.LambOptimizer(
        lr, lamb_weight_decay=0.01,
        grad_clip=pkg.clip.GradientClipByGlobalNorm(1.0))


def _resnet_goyal(pkg):
    lr = pkg.layers.piecewise_decay([3, 6], [0.1, 0.01, 0.001])
    return pkg.optimizer.Momentum(
        lr, 0.9, regularization=pkg.regularizer.L2Decay(1e-4))


FULL = {"bert": dict(batch=32, seq_len=128, vocab=30522, num_layers=12,
                     num_heads=12, d_model=768, d_ff=3072, masked=20),
        "resnet": dict(batch=128, image_size=224, class_dim=1000),
        "gpt": dict(batch=2, seq_len=4096, d_model=1024, n_heads=16,
                    n_layers=2, vocab=8192)}
RECIPES = {
    "bert_adamw": lambda pkg, kw: bert_script(pkg, _bert_adamw,
                                              use_bf16=True, **kw),
    "bert_lamb": lambda pkg, kw: bert_script(pkg, _bert_lamb, use_bf16=True,
                                             **kw),
    "resnet_goyal": lambda pkg, kw: resnet_script(pkg, _resnet_goyal,
                                                  use_bf16=True, **kw),
    "gpt_recompute": lambda pkg, kw: gpt_script(pkg, recompute=True,
                                                use_bf16=True, **kw),
}


def _passes(pkg, fus, main):
    n_epi = fus.apply_fused_epilogues(main)
    if pkg is fluid:
        n_opt = fus.apply_fused_optimizer(main, fluid.Scope(),
                                          torch.device("cpu"),
                                          layout="chain")
    else:
        n_opt = fus.apply_fused_optimizer(main, jfluid.Scope(),
                                          layout="chain")
    types = [op.type for op in main.global_block().ops]
    return n_epi, n_opt, types


def recipe_counts(name, full=False, pkg=fluid):
    """(ops after both passes, fused_bias_act, fused_residual_layer_norm,
    fused_optimizer) of a recipe's program."""
    kw = FULL[name.split("_")[0]] if full else {}
    main = RECIPES[name](pkg, kw)[0]
    _, _, types = _passes(pkg, fusion if pkg is fluid else jfusion, main)
    return (len(types), types.count("fused_bias_act"),
            types.count("fused_residual_layer_norm"),
            types.count("fused_optimizer"))


@pytest.mark.parametrize("full", [False, True], ids=["narrow", "full"])
@pytest.mark.parametrize("name", sorted(RECIPES))
def test_recipe_passes_match_the_jax_package(name, full):
    kw = FULL[name.split("_")[0]] if full else {}
    jmain = RECIPES[name](jfluid, kw)[0]
    pmain = RECIPES[name](fluid, kw)[0]
    assert [op.type for op in pmain.global_block().ops] == \
        [op.type for op in jmain.global_block().ops]
    jn = _passes(jfluid, jfusion, jmain)
    pn = _passes(fluid, fusion, pmain)
    assert pn == jn
    want_groups = {"bert_adamw": 1, "bert_lamb": 0, "resnet_goyal": 1,
                   "gpt_recompute": 1}[name]
    assert pn[1] == want_groups
    if name == "bert_lamb":
        assert "lamb" in pn[2]
    else:
        assert "adam" not in pn[2] and "adamw" not in pn[2]


def test_the_port_builders_emit_the_recipe_scripts():
    got = T.build_bert_base(seed=1, learning_rate=1e-4, use_bf16=True,
                            optimizer_fn=lambda: _bert_adamw(fluid),
                            **BERT)
    want = bert_script(fluid, _bert_adamw, use_bf16=True)
    assert LS.op_seq(got[0]) == LS.op_seq(want[0])
    got = build_resnet_train(4, 64, 10, seed=1, use_bf16=True,
                             optimizer_fn=lambda: _resnet_goyal(fluid))
    want = resnet_script(fluid, _resnet_goyal, use_bf16=True)
    assert LS.op_seq(got[0]) == LS.op_seq(want[0])
