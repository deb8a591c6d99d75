"""The port's ``dropout`` op and layer, on the CPU.

``jax.random`` cannot be reproduced in torch, so the op is held to its
distribution and to the mask contract, not to the JAX op's bits:

(a) the keep rate of 100,000 draws lies within 5 binomial standard
    deviations of ``1 - p``, for p in {0.1, 0.5, 0.9};
(b) both implementations scale as the JAX op does (``upscale_in_train``:
    kept elements over ``1 - p`` in training, X under ``is_test``;
    ``downgrade_in_infer``: X times the mask in training, X times ``1 - p``
    under ``is_test``, which the JAX op gives bit for bit too); ``p = 1``
    drops everything;
(c) a ``seed`` attr (``fix_seed``) gives the same mask on every step and
    every executor; without it, every step draws anew;
(d) ``X@GRAD`` is ``Out@GRAD`` times the forward's mask over ``1 - p``,
    bitwise, on the whole-program route and in the interpreter, and the
    fused op (``fused_bias_act`` with its dropout stage) draws the same
    mask as the ``dropout`` op it replaces;
(e) the layer emits the JAX layer's op, and a narrow encoder with
    dropout 0.1 is the JAX model's program op for op; the flash path
    still refuses attention dropout with the JAX package's message.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu.models  # noqa: F401  (jfluid.models)
import paddle_tpu_torch as fluid
from paddle_tpu.core.registry import OpInfoMap as JaxOps
from paddle_tpu_torch.core.registry import (DEVICE_ATTR, GENERATOR_ATTR,
                                            OpInfoMap)

N = 100_000
SIGMAS = 5.0


def _dropout(x, seed=1, **attrs):
    info = OpInfoMap.instance().get("dropout")
    a = dict(info.attrs)
    a.update(attrs)
    a[DEVICE_ATTR] = torch.device("cpu")
    gen = torch.Generator()
    gen.manual_seed(seed)
    a[GENERATOR_ATTR] = gen
    return info.fn({"X": x, "Seed": None}, a)


@pytest.mark.parametrize("p", [0.1, 0.5, 0.9])
def test_keep_rate_within_five_binomial_sigmas(p):
    out = _dropout(torch.ones(N), dropout_prob=p)
    kept = float(out["Mask"].sum())
    sigma = (N * p * (1 - p)) ** 0.5
    assert abs(kept - N * (1 - p)) <= SIGMAS * sigma, (kept, N * (1 - p))
    assert set(torch.unique(out["Mask"]).tolist()) <= {0.0, 1.0}


@pytest.mark.parametrize("impl", ["upscale_in_train", "downgrade_in_infer"])
@pytest.mark.parametrize("p", [0.0, 0.3, 1.0])
def test_scaling_of_both_implementations(impl, p):
    x = torch.from_numpy(np.random.RandomState(0).randn(64, 32)
                         .astype("float32"))
    out = _dropout(x, dropout_prob=p, dropout_implementation=impl)
    mask = out["Mask"]
    if p == 0.0:
        assert bool((mask == 1).all())
    if p == 1.0:
        assert bool((mask == 0).all())
        assert bool((out["Out"] == 0).all())
    elif impl == "upscale_in_train":
        assert torch.equal(out["Out"], x * mask / (1.0 - p))
    else:
        assert torch.equal(out["Out"], x * mask)


@pytest.mark.parametrize("impl", ["upscale_in_train", "downgrade_in_infer"])
def test_is_test_matches_the_jax_op(impl):
    x = np.random.RandomState(1).randn(8, 16).astype("float32")
    attrs = {"dropout_prob": 0.3, "is_test": True,
             "dropout_implementation": impl}
    got = _dropout(torch.from_numpy(x), **attrs)
    jinfo = JaxOps.instance().get("dropout")
    ja = dict(jinfo.attrs)
    ja.update(attrs)
    want = jinfo.fn({"X": x, "Seed": None}, ja)
    assert got["Mask"] is None and want["Mask"] is None
    np.testing.assert_array_equal(got["Out"].numpy(), np.asarray(want["Out"]))


def _drop_program(pkg, p=0.25, seed=None, impl="upscale_in_train",
                  shape=(64, 128)):
    """dropout -> mean, with its backward: (main, x, out, mask, loss)."""
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        x = pkg.data(name="x", shape=list(shape), dtype="float32")
        x.stop_gradient = False
        out = pkg.layers.dropout(x, dropout_prob=p, seed=seed,
                                 dropout_implementation=impl)
        loss = pkg.layers.mean(out)
        pkg.backward.append_backward(loss)
    dop = [op for op in main.global_block().ops if op.type == "dropout"][0]
    return main, x, out, dop.output("Mask")[0], loss


def _masks(seed, steps=3, exe_seed=11, interpret=False):
    main, x, out, mask, loss = _drop_program(fluid, seed=seed)
    exe = fluid.Executor(fluid.CPUPlace())
    exe._core.rng.seed = exe_seed
    scope = fluid.Scope()
    feed = {"x": np.ones((64, 128), "float32")}
    run = ((lambda: exe._core.run_program(main, scope, feed, [mask]))
           if interpret else
           (lambda: exe.run(main, feed=feed, fetch_list=[mask],
                            scope=scope)))
    return [np.asarray(run()[0]) for _ in range(steps)]


def test_fix_seed_gives_one_mask_on_every_step_and_executor():
    a = _masks(seed=123)
    b = _masks(seed=123, exe_seed=77)
    for m in a[1:] + b:
        np.testing.assert_array_equal(m, a[0])
    assert not np.array_equal(_masks(seed=124)[0], a[0])


def test_without_a_seed_every_step_draws_anew_as_the_interpreter():
    a = _masks(seed=None)
    assert len({m.tobytes() for m in a}) == len(a)
    for got, want in zip(a, _masks(seed=None, interpret=True)):
        np.testing.assert_array_equal(got, want)


def test_the_layer_emits_the_jax_layers_op():
    ops = []
    for pkg in (jfluid, fluid):
        main = _drop_program(pkg, seed=5)[0]
        ops.append([(op.type, op.inputs, op.outputs, op.attrs)
                    for op in main.global_block().ops])
    assert ops[0] == ops[1]


@pytest.mark.parametrize("interpret", [False, True],
                         ids=["whole_program", "interpreter"])
@pytest.mark.parametrize("impl", ["upscale_in_train", "downgrade_in_infer"])
def test_the_grad_uses_the_forwards_mask(impl, interpret):
    p = 0.25
    main, x, out, mask, loss = _drop_program(fluid, p=p, impl=impl)
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    xv = np.random.RandomState(2).randn(64, 128).astype("float32")
    fetch = [mask, "x@GRAD", loss.name + "@GRAD"]
    for _ in range(2):
        if interpret:
            m, gx, gl = exe._core.run_program(main, scope, {"x": xv}, fetch)
        else:
            m, gx, gl = exe.run(main, feed={"x": xv}, fetch_list=fetch,
                                scope=scope)
        d_out = np.full((64, 128), float(np.asarray(gl).reshape(-1)[0])
                        / (64 * 128), "float32")
        t_out, t_mask = torch.from_numpy(d_out), torch.from_numpy(m)
        want = (t_out * t_mask / (1.0 - p) if impl == "upscale_in_train"
                else t_out * t_mask)
        np.testing.assert_array_equal(gx, want.numpy())
        assert 0 < m.sum() < m.size


def _fused_program():
    main, startup = fluid.Program(), fluid.Program()
    startup.random_seed = 3
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.data(name="x", shape=[16, 24], dtype="float32")
        h = fluid.layers.fc(x, size=32, act="relu")
        h = fluid.layers.dropout(h, dropout_prob=0.4,
                                 dropout_implementation="upscale_in_train")
        loss = fluid.layers.mean(fluid.layers.fc(h, size=4))
        fluid.optimizer.SGD(0.1).minimize(loss)
    mask = [op for op in main.global_block().ops
            if op.type == "dropout"][0].output("Mask")[0]
    return main, startup, loss, mask


@pytest.mark.parametrize("knob", [None, "1"], ids=["unfused", "fused"])
def test_the_fused_op_draws_the_dropout_ops_mask(monkeypatch, knob):
    feed = {"x": np.random.RandomState(4).rand(16, 24).astype("float32")}
    masks = {}
    for fuse in (None, knob):
        monkeypatch.delenv("PADDLE_TPU_FUSED_EPILOGUE", raising=False)
        if fuse:
            monkeypatch.setenv("PADDLE_TPU_FUSED_EPILOGUE", fuse)
        main, startup, loss, mask = _fused_program()
        exe = fluid.Executor(fluid.CPUPlace())
        exe._core.rng.seed = 5
        scope = fluid.Scope()
        exe.run(startup, scope=scope)
        masks[fuse] = [np.asarray(exe.run(main, feed=feed, scope=scope,
                                          fetch_list=[mask, loss])[0])
                       for _ in range(3)]
        types = [op.type for op in main.global_block().ops]
        assert ("fused_bias_act" in types) == bool(fuse)
        assert ("dropout" in types) == (not fuse)
    for a, b in zip(masks[None], masks[knob]):
        np.testing.assert_array_equal(a, b)
    assert len({m.tobytes() for m in masks[knob]}) == 3


def _encoder(pkg, dropout, use_flash=None, is_test=False):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        ids = pkg.data(name="ids", shape=[2, 8], dtype="int64")
        pos = pkg.data(name="pos", shape=[2, 8], dtype="int64")
        if use_flash:
            emb = pkg.layers.embedding(ids, size=[32, 16])
            pkg.models.transformer.multi_head_attention(
                emb, 2, 16, dropout=dropout, is_test=is_test,
                use_flash=True)
        else:
            enc = pkg.models.transformer.transformer_encoder(
                ids, pos, 32, max_len=8, num_layers=2, num_heads=2,
                d_model=16, d_ff=32, dropout=dropout, is_test=is_test)
            pkg.optimizer.AdamOptimizer(1e-3).minimize(pkg.layers.mean(enc))
    return main


@pytest.mark.parametrize("is_test", [False, True])
def test_an_encoder_with_dropout_is_the_jax_models_program(is_test):
    want, got = (_encoder(pkg, 0.1, is_test=is_test)
                 for pkg in (jfluid, fluid))
    seq = [[(op.type, op.inputs, op.outputs, op.attrs)
            for op in m.global_block().ops] for m in (want, got)]
    assert seq[0] == seq[1]
    types = [op.type for op in got.global_block().ops]
    # per layer: the attention output and the feed-forward output, and in
    # training the dense path's attention weights (at inference attention
    # takes the flash op, as in the JAX model)
    assert types.count("dropout") == 2 * (2 if is_test else 3)
    assert ("flash_attention" in types) == is_test


def test_the_flash_path_refuses_attention_dropout_as_the_jax_package():
    msgs = []
    for pkg in (jfluid, fluid):
        with pytest.raises(ValueError) as err:
            _encoder(pkg, 0.1, use_flash=True)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1] and "dropout" in msgs[0]
    # at inference the flash path takes it
    _encoder(fluid, 0.1, use_flash=True, is_test=True)

