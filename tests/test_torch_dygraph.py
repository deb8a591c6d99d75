"""The port's dygraph (imperative) mode against the JAX package's, on the
CPU, from the same weights and inputs (numpy, seeded).

Both packages run under ``dygraph.guard`` (the port with ``CPUPlace()``);
weights are made with numpy and set into each package's layers in
``parameters()`` order (each package names parameters with its own
counters). Tolerances, float32 throughout:

- one op, forward and tape grads: rtol 1e-5 and atol 1e-5 of the larger
  of the array's largest magnitude and 1, the inputs' scale (torch and
  XLA sum a product or a reduction in other orders, a few ulps; a sum
  that cancels, as a mean of unit normals or the grad of a causal row
  that sees one key, is a few ulps of its terms apart, or exactly zero
  in one package); the port is run eagerly and lazily,
  the JAX package eagerly (its own tests hold its lazy mode to its eager
  mode within 1e-5);
- 3 training steps of the narrow dygraph_mlp and dygraph_bert scripts:
  losses within 1e-4 relative; parameters within 1e-5 of their scale
  (largest magnitude) under all four optimizers. Under Adam and AdamW an
  element whose reference grad is, at some step, within rounding of zero
  (not zero, and below 1e-5 of the parameter's largest grad that step)
  is left out: Adam moves it by about lr whatever its size, in the
  direction of a sign that a sum order may flip. That leaves out 0.1% of
  the elements or fewer (mlp 266, bert 95, LeNet 18). Readings, largest
  error of the rest as a share of the parameter's scale, eager and lazy
  alike: mlp 6.5e-07, bert 7.1e-06, LeNet 2.3e-07 (all elements: 6.5e-06,
  7.1e-06, 9.5e-07); the moments within 1e-4 of their scale;
- the JAX package's dygraph LeNet (``tests/test_models_e2e.py:116``), 3
  Adam steps, as above;
- ``fluid.dygraph.grad``, first and second order, against the formulas
  and the JAX package within 1e-6 / 1e-5;
- the seven learning-rate decays: host floats, equal to the JAX
  package's over 20 steps (the same formulas in Python);
- ``save_dygraph`` in one package and ``load_dygraph`` in the other, both
  ways: every array bitwise.

Then what holds without a JAX twin: grads accumulate, ``no_grad`` and
``stop_gradient`` stop them, dropout keeps 1 - p (within 5 binomial
sigmas) and is the identity scaled in eval mode, ``guard()`` without a
card raises, and the compare ops behind ``Variable`` comparisons match
the JAX package's static programs.
"""
import functools
import os

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as fluid

OP_RTOL = OP_ATOL = 1e-5
LOSS_RTOL = 1e-4
PARAM_TOL = 1e-5
ZERO_GRAD_RTOL = 1e-5   # an Adam element's reference grad near zero
MOMENT_TOL = 1e-4
STEPS = 3
MLP = dict(batch=8, dims=(784, 256, 256, 10))
BERT = dict(n_layers=2, d_model=64, n_heads=4, vocab=100, batch=4, seq=16)
OPTIMIZERS = {"sgd": 0.1, "momentum": 0.05, "adam": 1e-3, "adamw": 1e-3}


def guard(pkg, lazy=False):
    if pkg is fluid:
        return fluid.dygraph.guard(fluid.CPUPlace(), lazy=lazy)
    return jfluid.dygraph.guard(lazy=lazy)


def _np(v):
    return np.asarray(v.numpy())


def _set_weights(params, seed):
    """Seeded numpy weights in ``parameters()`` order: a normal of scale
    0.1 for matrices, 1 + noise for norms' scales, small biases."""
    rng = np.random.RandomState(seed)
    for p in params:
        shape = tuple(p.shape)
        if len(shape) >= 2:
            w = rng.randn(*shape) * 0.1
        else:
            w = rng.randn(*shape) * 0.02
        p.set_value(w.astype("float32"))


# -- one op: forward and tape grads --------------------------------------------

def _rand(rng, *shape):
    return rng.randn(*shape).astype("float32")


def _op_cases():
    rng = np.random.RandomState(0)
    q = lambda: _rand(rng, 2, 2, 64, 64)  # noqa: E731  [B, H, S, D]
    return {
        "matmul_3d": ("matmul", {"X": _rand(rng, 4, 8, 16),
                                 "Y": _rand(rng, 16, 12)},
                      {"transpose_X": False, "transpose_Y": False,
                       "alpha": 1.0}, "Out"),
        "matmul_batched_ty_alpha": (
            "matmul", {"X": _rand(rng, 2, 4, 8, 16),
                       "Y": _rand(rng, 2, 4, 8, 16)},
            {"transpose_X": False, "transpose_Y": True, "alpha": 0.25},
            "Out"),
        "elementwise_add_axis": ("elementwise_add",
                                 {"X": _rand(rng, 4, 8, 12),
                                  "Y": _rand(rng, 12)}, {"axis": 2}, "Out"),
        "elementwise_add": ("elementwise_add", {"X": _rand(rng, 4, 8),
                                                "Y": _rand(rng, 4, 8)},
                            {"axis": -1}, "Out"),
        "relu": ("relu", {"X": _rand(rng, 6, 10)}, {}, "Out"),
        "gelu": ("gelu", {"X": _rand(rng, 6, 10)}, {}, "Out"),
        "layer_norm": ("layer_norm", {"X": _rand(rng, 4, 8, 32),
                                      "Scale": _rand(rng, 32),
                                      "Bias": _rand(rng, 32)},
                       {"epsilon": 1e-5, "begin_norm_axis": 2}, "Y"),
        "lookup_table_v2": ("lookup_table_v2",
                            {"W": _rand(rng, 50, 16),
                             "Ids": rng.randint(0, 50, (4, 7))
                             .astype("int64")},
                            {"padding_idx": -1}, "Out"),
        "reshape2": ("reshape2", {"X": _rand(rng, 4, 6, 8)},
                     {"shape": [4, 6, 2, 4]}, "Out"),
        "transpose2": ("transpose2", {"X": _rand(rng, 2, 3, 4, 5)},
                       {"axis": [0, 2, 1, 3]}, "Out"),
        "softmax": ("softmax", {"X": _rand(rng, 4, 3, 9)}, {"axis": -1},
                    "Out"),
        "softmax_with_cross_entropy": (
            "softmax_with_cross_entropy",
            {"Logits": _rand(rng, 12, 30),
             "Label": rng.randint(0, 30, (12, 1)).astype("int64")},
            {"soft_label": False, "ignore_index": -100,
             "numeric_stable_mode": True, "axis": -1}, "Loss"),
        "mean": ("mean", {"X": _rand(rng, 5, 7)}, {}, "Out"),
        "flash_attention": ("flash_attention", {"Q": q(), "K": q(),
                                                "V": q()},
                            {"causal": False, "scale": 0.0}, "Out"),
        "flash_attention_causal": ("flash_attention",
                                   {"Q": q(), "K": q(), "V": q()},
                                   {"causal": True, "scale": 0.0}, "Out"),
        "flash_attention_lengths": (
            "flash_attention",
            {"Q": q(), "K": q(), "V": q(),
             "Lengths": np.array([64, 37], dtype="int32")},
            {"causal": False, "scale": 0.125}, "Out"),
    }


OP_CASES = _op_cases()


def _run_op(pkg, lazy, op_type, arrays, attrs, out_slot, cot_seed=7):
    """The op's output and the grads of its floating inputs for a seeded
    cotangent, through ``fluid.dygraph.grad``."""
    with guard(pkg, lazy):
        tracer = pkg.framework._dygraph_tracer()
        ins, wrt = {}, []
        for slot, a in arrays.items():
            v = pkg.dygraph.to_variable(a)
            if a.dtype.kind == "f":
                v.stop_gradient = False
                wrt.append(v)
            ins[slot] = v
        out = tracer.trace_op(op_type, ins, {}, dict(attrs))[out_slot][0]
        shape = tuple(out.shape)
        cot = np.asarray(np.random.RandomState(cot_seed).randn(*shape),
                         dtype="float32")
        grads = pkg.dygraph.grad([out], wrt,
                                 grad_outputs=[pkg.dygraph.to_variable(cot)],
                                 allow_unused=True)
        return _np(out), [None if g is None else _np(g) for g in grads]


@functools.lru_cache(maxsize=None)
def _jax_op(name):
    op_type, arrays, attrs, out_slot = OP_CASES[name]
    return _run_op(jfluid, False, op_type, arrays, attrs, out_slot)


@pytest.mark.parametrize("lazy", [False, True], ids=["eager", "lazy"])
@pytest.mark.parametrize("name", sorted(OP_CASES))
def test_op_forward_and_tape_grads_match_the_jax_package(name, lazy):
    op_type, arrays, attrs, out_slot = OP_CASES[name]
    out, grads = _run_op(fluid, lazy, op_type, arrays, attrs, out_slot)
    jout, jgrads = _jax_op(name)
    assert len(grads) == len(jgrads)
    for g, jg in zip([out] + grads, [jout] + jgrads):
        np.testing.assert_allclose(
            g, jg, rtol=OP_RTOL,
            atol=OP_ATOL * max(float(np.abs(jg).max()), 1.0))


# -- the narrow dygraph_mlp and dygraph_bert scripts ----------------------------

def _optimizer(pkg, name, params, lr=None):
    lr = OPTIMIZERS[name] if lr is None else lr
    O = pkg.optimizer
    if name == "sgd":
        return O.SGDOptimizer(lr, parameter_list=params)
    if name == "momentum":
        return O.MomentumOptimizer(lr, 0.9, parameter_list=params)
    if name == "adam":
        return O.AdamOptimizer(lr, parameter_list=params)
    return O.AdamW(lr, weight_decay=0.01, parameter_list=params)


def mlp_script(pkg, batch, dims):
    """bench.py's dygraph_mlp (``bench.py:637-687``) under ``pkg``: its
    layers, and its step (forward, backward, minimize, clear)."""
    D = pkg.dygraph
    layers = [D.Linear(dims[i], dims[i + 1],
                       act="relu" if i < len(dims) - 2 else None)
              for i in range(len(dims) - 1)]
    params = [p for lyr in layers for p in lyr.parameters()]
    rng = np.random.RandomState(0)
    x = rng.rand(batch, dims[0]).astype("float32")
    y = rng.randint(0, dims[-1], (batch, 1)).astype("int64")

    def step(opt):
        h = D.to_variable(x)
        for lyr in layers:
            h = lyr(h)
        loss = pkg.layers.mean(pkg.layers.softmax_with_cross_entropy(
            h, D.to_variable(y)))
        loss.backward()
        opt.minimize(loss, parameter_list=params)
        for p in params:
            p.clear_gradient()
        return loss

    return params, step


def bert_script(pkg, batch, seq, n_layers, d_model, n_heads, vocab,
                attention="dense", lengths=None):
    """bench.py's dygraph_bert (``bench.py:690-773``) under ``pkg``; with
    ``attention="flash"`` its attention is ``layers.flash_attention(q, k,
    v, lengths=...)`` in place of matmul-softmax-matmul."""
    D, L = pkg.dygraph, pkg.layers
    head = d_model // n_heads
    emb = D.Embedding(size=[vocab, d_model])
    pos = D.Embedding(size=[seq, d_model])
    blocks = []
    for _ in range(n_layers):
        blocks.append({
            "q": D.Linear(d_model, d_model), "k": D.Linear(d_model, d_model),
            "v": D.Linear(d_model, d_model), "o": D.Linear(d_model, d_model),
            "ln1": D.LayerNorm(d_model),
            "f1": D.Linear(d_model, d_model * 4, act="gelu"),
            "f2": D.Linear(d_model * 4, d_model), "ln2": D.LayerNorm(d_model),
        })
    out_proj = D.Linear(d_model, vocab)
    params = [p for b in blocks for lyr in b.values()
              for p in lyr.parameters()]
    params += emb.parameters() + pos.parameters() + out_proj.parameters()
    rng = np.random.RandomState(0)
    ids = rng.randint(0, vocab, (batch, seq)).astype("int64")
    pids = np.tile(np.arange(seq), (batch, 1)).astype("int64")
    lbl = rng.randint(0, vocab, (batch * seq, 1)).astype("int64")

    def heads_of(t):
        t = L.reshape(t, [batch, seq, n_heads, head])
        return L.transpose(t, [0, 2, 1, 3])

    def step(opt):
        x = emb(D.to_variable(ids)) + pos(D.to_variable(pids))
        for b in blocks:
            q, k, v = heads_of(b["q"](x)), heads_of(b["k"](x)), \
                heads_of(b["v"](x))
            if attention == "flash":
                ctx = L.flash_attention(
                    q, k, v, lengths=None if lengths is None
                    else D.to_variable(lengths))
            else:
                s = L.matmul(q, k, transpose_y=True,
                             alpha=float(head) ** -0.5)
                ctx = L.matmul(L.softmax(s), v)
            ctx = L.reshape(L.transpose(ctx, [0, 2, 1, 3]),
                            [batch, seq, d_model])
            x = b["ln1"](x + b["o"](ctx))
            x = b["ln2"](x + b["f2"](b["f1"](x)))
        logits = L.reshape(out_proj(x), [batch * seq, vocab])
        loss = L.mean(L.softmax_with_cross_entropy(logits,
                                                   D.to_variable(lbl)))
        loss.backward()
        opt.minimize(loss, parameter_list=params)
        for p in params:
            p.clear_gradient()
        return loss

    return params, step


SCRIPTS = {"mlp": (mlp_script, MLP), "bert": (bert_script, BERT)}


def _record_grads(opt, params):
    """Make ``opt.minimize`` first keep every parameter's grad (numpy);
    returns the list it appends each step's grads to."""
    grads, minimize = [], opt.minimize

    def recording(loss, *args, **kwargs):
        grads.append([np.asarray(p.gradient()) for p in params])
        return minimize(loss, *args, **kwargs)

    opt.minimize = recording
    return grads


def train(pkg, script, opt_name, lazy=False, steps=STEPS, seed=1,
          grads=False):
    """(losses, parameters, state) after ``steps`` steps, and with
    ``grads`` the grads of every step (the reference's, read eagerly)."""
    make, cfg = SCRIPTS[script]
    with guard(pkg, lazy):
        params, step = make(pkg, **cfg)
        _set_weights(params, seed)
        opt = _optimizer(pkg, opt_name, params)
        seen = _record_grads(opt, params) if grads else None
        losses = [float(_np(step(opt)).reshape(-1)[0]) for _ in range(steps)]
        state = {k: _np(v) for k, v in opt._dygraph_state.items()}
        return losses, [_np(p) for p in params], _ordered_state(
            opt, params, state), seen


def _ordered_state(opt, params, state):
    """Optimizer state by (parameter index, slot): the packages name
    parameters differently."""
    out = {}
    for i, p in enumerate(params):
        for k, v in state.items():
            if k.startswith(p.name + "_"):
                out[(i, k[len(p.name) + 1:])] = v
    return out


@functools.lru_cache(maxsize=None)
def _jax_train(script, opt_name):
    return train(jfluid, script, opt_name, grads=True)


def _adam_kept(jgrads):
    """Per parameter, the elements whose reference grad is, at every
    step, exactly zero (no update in either package) or above
    ZERO_GRAD_RTOL of the parameter's largest grad at that step."""
    kept = None
    for step in jgrads:
        now = [(g == 0) | (np.abs(g) > ZERO_GRAD_RTOL * np.abs(g).max())
               for g in step]
        kept = now if kept is None else [a & b for a, b in zip(kept, now)]
    return kept


def check_training(got, want, opt_name):
    losses, params, state, _ = got
    jlosses, jparams, jstate, jgrads = want
    np.testing.assert_allclose(losses, jlosses, rtol=LOSS_RTOL)
    if opt_name in ("sgd", "momentum"):
        kept = [np.ones(p.shape, bool) for p in jparams]
    else:
        kept = _adam_kept(jgrads)
        # the near-zero grads are a few, not a parameter's worth
        assert sum(int((~k).sum()) for k in kept) <= 0.01 * sum(
            k.size for k in kept)
    for p, jp, k in zip(params, jparams, kept):
        scale = max(float(np.abs(jp).max()), 1e-3)
        np.testing.assert_allclose(p[k], jp[k], rtol=0,
                                   atol=PARAM_TOL * scale)
    assert sorted(state) == sorted(jstate)
    for k, v in state.items():
        scale = max(float(np.abs(jstate[k]).max()), 1e-3)
        np.testing.assert_allclose(v, jstate[k], rtol=0,
                                   atol=MOMENT_TOL * scale, err_msg=str(k))


@pytest.mark.parametrize("lazy", [False, True], ids=["eager", "lazy"])
@pytest.mark.parametrize("opt_name", sorted(OPTIMIZERS))
@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_narrow_script_trains_as_the_jax_package(script, opt_name, lazy):
    got = train(fluid, script, opt_name, lazy)
    check_training(got, _jax_train(script, opt_name), opt_name)
    assert all(np.isfinite(got[0]))


def lenet_script(pkg):
    """The JAX package's dygraph LeNet (``tests/test_models_e2e.py:116``)
    and its Adam step on a seeded batch of 8 28x28 images."""
    D = pkg.dygraph

    class LeNet(D.Layer):
        def __init__(self):
            super().__init__()
            self.c1 = D.Conv2D(1, 6, 5, act="relu")
            self.p1 = D.Pool2D(2, pool_type="max", pool_stride=2)
            self.c2 = D.Conv2D(6, 16, 5, act="relu")
            self.p2 = D.Pool2D(2, pool_type="max", pool_stride=2)
            self.f1 = D.Linear(256, 120, act="relu")
            self.f2 = D.Linear(120, 84, act="relu")
            self.f3 = D.Linear(84, 10, act="softmax")

        def forward(self, x):
            h = self.p2(self.c2(self.p1(self.c1(x))))
            h = pkg.layers.reshape(h, [h.shape[0], -1])
            return self.f3(self.f2(self.f1(h)))

    model = LeNet()
    rng = np.random.RandomState(2)
    x = rng.rand(8, 1, 28, 28).astype("float32")
    y = rng.randint(0, 10, (8, 1)).astype("int64")

    def step(opt):
        pred = model(D.to_variable(x))
        loss = pkg.layers.mean(pkg.layers.cross_entropy(pred,
                                                        D.to_variable(y)))
        loss.backward()
        opt.minimize(loss)
        model.clear_gradients()
        return loss

    return model, step


def train_lenet(pkg, lazy=False, grads=False):
    with guard(pkg, lazy):
        model, step = lenet_script(pkg)
        params = model.parameters()
        _set_weights(params, 3)
        opt = pkg.optimizer.AdamOptimizer(1e-3, parameter_list=params)
        seen = _record_grads(opt, params) if grads else None
        losses = [float(_np(step(opt)).reshape(-1)[0]) for _ in range(STEPS)]
        return (losses, [_np(p) for p in params],
                _ordered_state(opt, params, {k: _np(v) for k, v in
                                             opt._dygraph_state.items()}),
                seen)


@functools.lru_cache(maxsize=None)
def _jax_lenet():
    return train_lenet(jfluid, grads=True)


@pytest.mark.parametrize("lazy", [False, True], ids=["eager", "lazy"])
def test_dygraph_lenet_trains_as_the_jax_package(lazy):
    got = train_lenet(fluid, lazy)
    check_training(got, _jax_lenet(), "adam")
    # state_dict: the parameters by structured name, numpy-readable
    with guard(fluid):
        model, _ = lenet_script(fluid)
        sd = model.state_dict()
        assert list(sd)[:2] == ["c1.weight", "c1.bias"]
        assert _np(sd["f3.weight"]).shape == (84, 10)


# -- fluid.dygraph.grad ------------------------------------------------------

def _grad_cases(pkg):
    with guard(pkg):
        D, L = pkg.dygraph, pkg.layers
        x = D.to_variable(np.array([2.0, 3.0], dtype="float32"))
        x.stop_gradient = False
        (g1,) = D.grad(L.reduce_sum(L.elementwise_mul(x, x)), x)
        x = D.to_variable(np.array([1.0, 2.0], dtype="float32"))
        x.stop_gradient = False
        x3 = L.elementwise_mul(L.elementwise_mul(x, x), x)
        (gx,) = D.grad(L.reduce_sum(x3), x, create_graph=True)
        (ggx,) = D.grad(L.reduce_sum(gx), x)
        w = D.to_variable(np.array([[0.5, -1.0], [2.0, 0.25]], "float32"))
        w.stop_gradient = False
        h = L.tanh(L.matmul(w, w))
        (gw,) = D.grad(L.reduce_sum(h), w, create_graph=True)
        (ggw,) = D.grad(L.reduce_sum(L.elementwise_mul(gw, gw)), w)
        return [_np(g1), _np(gx), _np(ggx), _np(gw), _np(ggw)]


def test_grad_first_and_second_order():
    got = _grad_cases(fluid)
    np.testing.assert_allclose(got[0], [4.0, 6.0], rtol=1e-6)
    np.testing.assert_allclose(got[1], [3.0, 12.0], rtol=1e-6)  # 3x^2
    np.testing.assert_allclose(got[2], [6.0, 12.0], rtol=1e-5)  # 6x
    for g, j in zip(got, _grad_cases(jfluid)):
        np.testing.assert_allclose(g, j, rtol=1e-5, atol=1e-6)


def test_grad_leaves_accumulators_alone_and_reports_unreachable():
    with guard(fluid):
        D, L = fluid.dygraph, fluid.layers
        x = D.to_variable(np.ones(3, dtype="float32"))
        x.stop_gradient = False
        z = D.to_variable(np.ones(2, dtype="float32"))
        z.stop_gradient = False
        y = L.reduce_sum(L.elementwise_mul(x, x))
        D.grad(y, x, retain_graph=True)
        assert x._grad is None
        with pytest.raises(ValueError, match="unreachable"):
            D.grad(y, z, retain_graph=True)
        (gz,) = D.grad(y, z, allow_unused=True)
        assert gz is None
        assert not fluid.framework._dygraph_tracer().tape


# -- accumulation, no_grad, stop_gradient --------------------------------------

def test_grads_accumulate_until_cleared():
    with guard(fluid):
        D, L = fluid.dygraph, fluid.layers
        lin = D.Linear(4, 3)
        x = D.to_variable(np.ones((2, 4), dtype="float32"))
        L.mean(lin(x)).backward()
        g1 = lin.weight.gradient()
        L.mean(lin(x)).backward()
        np.testing.assert_allclose(lin.weight.gradient(), 2 * g1, rtol=1e-6)
        lin.clear_gradients()
        assert lin.weight.gradient() is None
        # retain_graph keeps the tape for a second pull
        loss = L.mean(lin(x))
        loss.backward(retain_graph=True)
        loss.backward()
        np.testing.assert_allclose(lin.weight.gradient(), 2 * g1, rtol=1e-6)


def test_no_grad_and_stop_gradient_stop_grads():
    with guard(fluid):
        D, L = fluid.dygraph, fluid.layers
        lin = D.Linear(4, 3)
        x = D.to_variable(np.ones((2, 4), dtype="float32"))
        with D.no_grad():
            out = lin(x)
        assert out.stop_gradient
        assert not fluid.framework._dygraph_tracer().tape
        lin.bias.stop_gradient = True
        L.mean(lin(x)).backward()
        assert lin.weight.gradient() is not None
        assert lin.bias.gradient() is None

        @D.no_grad
        def frozen(v):
            return lin(v)

        assert frozen(x).stop_gradient
        # an integer input is never differentiated
        ids = D.to_variable(np.array([[1, 2]], dtype="int64"))
        ids.stop_gradient = False
        emb = D.Embedding(size=[5, 3])
        L.mean(emb(ids)).backward()
        assert ids.gradient() is None and emb.weight.gradient() is not None


# -- learning-rate decays -----------------------------------------------------

DECAYS = {
    "PiecewiseDecay": dict(boundaries=[3, 8, 14], values=[1.0, 0.5, 0.1,
                                                          0.01]),
    "NaturalExpDecay": dict(learning_rate=0.1, decay_steps=5,
                            decay_rate=0.5, staircase=True),
    "ExponentialDecay": dict(learning_rate=0.1, decay_steps=4,
                             decay_rate=0.9),
    "InverseTimeDecay": dict(learning_rate=0.1, decay_steps=3,
                             decay_rate=0.2, staircase=True),
    "PolynomialDecay": dict(learning_rate=0.1, decay_steps=12,
                            end_learning_rate=0.001, power=2.0, cycle=True),
    "CosineDecay": dict(learning_rate=0.1, step_each_epoch=3, epochs=7),
    "NoamDecay": dict(d_model=64, warmup_steps=6),
}


@pytest.mark.parametrize("name", sorted(DECAYS))
def test_decay_equals_the_jax_package_over_20_steps(name):
    ours = getattr(fluid.dygraph, name)(**DECAYS[name])
    theirs = getattr(jfluid.dygraph, name)(**DECAYS[name])
    got = [ours() for _ in range(20)]
    assert got == [theirs() for _ in range(20)]
    assert len(set(got)) > 1


def test_noam_decay_drives_the_update():
    """The rate the update ops see is the decay's, step by step: SGD
    under NoamDecay against SGD at each step's rate by hand."""
    def run(lr_of_step):
        with guard(fluid):
            params, step = mlp_script(fluid, 4, (6, 5, 3))
            _set_weights(params, 5)
            for s in range(4):
                opt = fluid.optimizer.SGDOptimizer(lr_of_step(s),
                                                   parameter_list=params)
                step(opt)
            return [_np(p) for p in params]

    noam = fluid.dygraph.NoamDecay(d_model=16, warmup_steps=2)
    with guard(fluid):
        params, step = mlp_script(fluid, 4, (6, 5, 3))
        _set_weights(params, 5)
        opt = fluid.optimizer.SGDOptimizer(noam, parameter_list=params)
        for _ in range(4):
            step(opt)
        got = [_np(p) for p in params]
    ref = fluid.dygraph.NoamDecay(d_model=16, warmup_steps=2)
    rates = [ref() for _ in range(4)]
    for a, b in zip(got, run(lambda s: rates[s])):
        np.testing.assert_array_equal(a, b)


# -- save_dygraph / load_dygraph across packages --------------------------------

@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_save_load_across_packages(tmp_path, direction):
    src, dst = (jfluid, fluid) if direction == "jax_to_port" \
        else (fluid, jfluid)
    path = os.path.join(str(tmp_path), "model")
    with guard(src):
        params, step = mlp_script(src, 4, (6, 5, 3))
        _set_weights(params, 9)
        opt = _optimizer(src, "adam", params)
        step(opt)
        layer_state = {"w%d" % i: p for i, p in enumerate(params)}
        want = {k: _np(v) for k, v in layer_state.items()}
        src.dygraph.save_dygraph(layer_state, path)
        opt_state = {k: _np(v) for k, v in opt._dygraph_state.items()}
        src.dygraph.save_dygraph(opt_state, path)   # numpy: .pdopt
    loaded, loaded_opt = dst.dygraph.load_dygraph(path)
    assert sorted(loaded) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(loaded[k], v)
    assert sorted(loaded_opt) == sorted(opt_state)
    for k, v in opt_state.items():
        np.testing.assert_array_equal(loaded_opt[k], v)
    with guard(dst):
        params, _ = mlp_script(dst, 4, (6, 5, 3))
        for i, p in enumerate(params):
            p.set_value(loaded["w%d" % i])
            np.testing.assert_array_equal(_np(p), want["w%d" % i])


def test_layer_and_optimizer_state_dicts_round_trip(tmp_path):
    path = os.path.join(str(tmp_path), "lenet")
    with guard(fluid):
        model, step = lenet_script(fluid)
        opt = fluid.optimizer.AdamOptimizer(1e-3,
                                            parameter_list=model.parameters())
        step(opt)
        fluid.dygraph.save_dygraph(model.state_dict(), path)
        want = {k: _np(v) for k, v in model.state_dict().items()}
        opt_state = {k: _np(v) for k, v in opt.state_dict().items()}
    with guard(fluid):
        model2, _ = lenet_script(fluid)
        params, _ = fluid.dygraph.load_dygraph(path)
        model2.set_dict(params)
        for k, v in model2.state_dict().items():
            np.testing.assert_array_equal(_np(v), want[k])
        opt2 = fluid.optimizer.AdamOptimizer(1e-3)
        opt2.set_dict(opt_state)
        for k, v in opt2.state_dict().items():
            np.testing.assert_array_equal(_np(v), opt_state[k])


# -- dropout, the guard's place, the compare ops ------------------------------

@pytest.mark.parametrize("lazy", [False, True], ids=["eager", "lazy"])
def test_dropout_keep_rate_and_eval_mode(lazy):
    n, p = 100_000, 0.3
    with guard(fluid, lazy):
        D = fluid.dygraph
        drop = D.Dropout(p=p)
        x = D.to_variable(np.ones(n, dtype="float32"))
        a, b = _np(drop(x)), _np(drop(x))
        sigma = (n * p * (1 - p)) ** 0.5
        for out in (a, b):
            kept = float((out != 0).sum())
            assert abs(kept - n * (1 - p)) <= 5 * sigma
        assert not np.array_equal(a, b)   # a new mask each call
        drop.eval()
        np.testing.assert_allclose(_np(drop(x)), 1.0 - p, rtol=1e-6)


def test_guard_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card; the rule is about hosts "
                    "without one")
    for make in (lambda: fluid.dygraph.guard(),
                 lambda: fluid.dygraph.guard(fluid.CUDAPlace(0))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            with make():
                pass
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fluid.dygraph.enable_dygraph()
    assert not fluid.framework.in_dygraph_mode()


def _static_compare(pkg, x, y):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        a = pkg.layers.data(name="a", shape=list(x.shape), dtype="float32",
                            append_batch_size=False)
        b = pkg.layers.data(name="b", shape=list(y.shape), dtype="float32",
                            append_batch_size=False)
        outs = [a < b, a <= b, a > b, a >= b, a > 0.5]
    place = fluid.CPUPlace() if pkg is fluid else jfluid.CPUPlace()
    exe = pkg.Executor(place)
    exe.run(startup)
    got = exe.run(main, feed={"a": x, "b": y}, fetch_list=outs)
    return [op.type for op in main.global_block().ops], \
        [np.asarray(g) for g in got]


def test_variable_comparisons_match_the_jax_package():
    rng = np.random.RandomState(4)
    x = rng.rand(3, 4).astype("float32")
    y = x.copy()
    y[0] += 0.5
    y[1] -= 0.5
    ops, got = _static_compare(fluid, x, y)
    jops, want = _static_compare(jfluid, x, y)
    assert ops == jops
    for g, w in zip(got, want):
        assert g.dtype == np.bool_
        np.testing.assert_array_equal(g, w)


def test_varbase_comparisons():
    with guard(fluid):
        D = fluid.dygraph
        x = D.to_variable(np.array([0, 1, 2], dtype="int64"))
        np.testing.assert_array_equal(_np(x > -0.5), [True, True, True])
        np.testing.assert_array_equal(_np(x <= 1), [True, True, False])
        f = D.to_variable(np.array([0.5, 1.5], dtype="float32"))
        assert bool(f[0:1] < 1.0) and not bool(f[1:2] < 1.0)


def _batch_norm_run(pkg, lazy=False):
    """A dygraph BatchNorm in training mode, then in eval mode: outputs,
    grads of its input and scale, running statistics."""
    rng = np.random.RandomState(12)
    x = rng.randn(4, 3, 5, 5).astype("float32")
    with guard(pkg, lazy):
        D, L = pkg.dygraph, pkg.layers
        bn = D.BatchNorm(3)
        v = D.to_variable(x)
        v.stop_gradient = False
        y = bn(v)
        L.mean(L.elementwise_mul(y, y)).backward()
        out = [_np(y), v.gradient(), bn.weight.gradient(),
               _np(bn._mean), _np(bn._variance)]
        bn.eval()
        out.append(_np(bn(D.to_variable(x))))
        return out


@pytest.mark.parametrize("lazy", [False, True], ids=["eager", "lazy"])
def test_batch_norm_layer_matches_the_jax_package(lazy):
    for g, j in zip(_batch_norm_run(fluid, lazy), _batch_norm_run(jfluid)):
        np.testing.assert_allclose(g, j, rtol=OP_RTOL,
                                   atol=OP_ATOL * max(np.abs(j).max(), 1.0))


def test_an_optimizer_without_a_dygraph_update_raises():
    class Unported(fluid.optimizer.Optimizer):
        pass

    with guard(fluid):
        lin = fluid.dygraph.Linear(3, 2)
        loss = fluid.layers.mean(lin(fluid.dygraph.to_variable(
            np.ones((2, 3), "float32"))))
        loss.backward()
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            Unported(0.1, parameter_list=lin.parameters()).minimize(loss)


def test_flags_dygraph_lazy_sets_the_guard_default():
    try:
        fluid.set_flags({"FLAGS_dygraph_lazy": True})
        with fluid.dygraph.guard(fluid.CPUPlace()):
            assert fluid.framework._dygraph_tracer().lazy_engine is not None
        with fluid.dygraph.guard(fluid.CPUPlace(), lazy=False):
            assert fluid.framework._dygraph_tracer().lazy_engine is None
    finally:
        fluid.set_flags({"FLAGS_dygraph_lazy": False})
    with fluid.dygraph.guard(fluid.CPUPlace()):
        assert fluid.framework._dygraph_tracer().lazy_engine is None
