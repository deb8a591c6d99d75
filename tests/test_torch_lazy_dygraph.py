"""Lazy (queued) dygraph dispatch against eager dispatch, in the port, on
the CPU: the behaviours ``tests/test_lazy_dygraph.py`` fixes for the JAX
package, each reproduced here, and what the port adds.

The contract (``paddle_tpu_torch/dygraph/lazy.py``): under
``guard(lazy=True)`` every op queues; a flush runs the queue, keyed by its
structure (on the card: the second flush of a key is captured into a CUDA
graph and later ones replay it), while the numbers match the eager
tracer: the same op functions, the same tape walk. Losses and parameters
are held to eager ones within the JAX test's tolerance (rtol 1e-5, atol
1e-6); the port gives the same bits on the CPU.

Then: a host read mid-step flushes and the step still works; after the
first step, a step is one structural key; reading a gradient flushes;
dropout draws a new mask each step under one key; shapes read without a
flush; ``x[...]`` with a static index stays queued and its grads flow;
``fluid.dygraph.grad`` works lazily and ``create_graph=True`` raises the
JAX package's message; the ``MAX_NODES`` valve flushes conservatively; a
backward node in the flush of its forward pulls through the forward's
saved graph and never runs the forward again (the flash encoder's
forward and backward kernels, here their plain versions, run once a
layer a step); under ``NoamDecay`` the rate changes every step under one
key.
"""
import numpy as np
import pytest

import paddle_tpu_torch as fluid
from paddle_tpu_torch.dygraph import Linear, lazy as lazy_mod, to_variable
from paddle_tpu_torch.ops.cuda import flash_attention as fa

RTOL, ATOL = 1e-5, 1e-6


def guard(lazy):
    return fluid.dygraph.guard(fluid.CPUPlace(), lazy=lazy)


def _set_weights(params, seed):
    rng = np.random.RandomState(seed)
    for p in params:
        p.set_value((rng.randn(*p.shape) * 0.1).astype("float32"))


def _train(lazy, iters=5, opt_name="sgd", read_mid=False, lr=None):
    with guard(lazy):
        l1 = Linear(16, 32, act="relu")
        l2 = Linear(32, 4)
        params = l1.parameters() + l2.parameters()
        _set_weights(params, 0)
        if opt_name == "sgd":
            opt = fluid.optimizer.SGDOptimizer(lr or 0.1,
                                               parameter_list=params)
        else:
            opt = fluid.optimizer.AdamOptimizer(lr or 1e-2,
                                                parameter_list=params)
        rng = np.random.RandomState(1)
        x = rng.rand(8, 16).astype("float32")
        y = rng.randint(0, 4, (8, 1)).astype("int64")
        losses = []
        for _ in range(iters):
            h = l1(to_variable(x))
            if read_mid:
                # a host read mid-step flushes part of the step; the
                # backward then runs those forwards again
                assert np.isfinite(h.numpy()).all()
            logits = l2(h)
            loss = fluid.layers.mean(fluid.layers.softmax_with_cross_entropy(
                logits, to_variable(y)))
            loss.backward()
            opt.minimize(loss, parameter_list=params)
            for p in params:
                p.clear_gradient()
            losses.append(float(loss.numpy()))
        return losses, [p.numpy() for p in params]


@pytest.mark.parametrize("opt_name", ["sgd", "adam"])
def test_lazy_matches_eager(opt_name):
    le, pe = _train(False, opt_name=opt_name)
    ll, pl = _train(True, opt_name=opt_name)
    np.testing.assert_allclose(le, ll, rtol=RTOL, atol=ATOL)
    for a, b in zip(pe, pl):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)


def test_midstep_host_read_partial_flush():
    le, _ = _train(False, read_mid=True)
    ll, _ = _train(True, read_mid=True)
    np.testing.assert_allclose(le, ll, rtol=RTOL, atol=ATOL)


def test_noam_decay_changes_the_rate_every_step_under_one_key():
    def run(lazy):
        lazy_mod.reset_counters()
        noam = fluid.dygraph.NoamDecay(d_model=32, warmup_steps=3)
        return _train(lazy, iters=6, lr=noam)

    le, pe = run(False)
    ll, pl = run(True)
    c = lazy_mod.counters()
    assert c["lazy.recompiles"] == 1 and c["lazy.cache_hits"] >= 5, c
    np.testing.assert_allclose(le, ll, rtol=RTOL, atol=ATOL)
    for a, b in zip(pe, pl):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)
    # the rate moved: a fixed rate gives other parameters
    _, pf = _train(True, iters=6, lr=0.01)
    assert any(not np.allclose(a, b) for a, b in zip(pl, pf))


def test_steady_state_is_one_key():
    """After the first step, later steps hit the structural plan cache
    (on the card: the same captured graph, one replay a step)."""
    with guard(True):
        l1 = Linear(8, 8)
        params = l1.parameters()
        opt = fluid.optimizer.SGDOptimizer(0.1, parameter_list=params)
        tracer = fluid.framework._dygraph_tracer()
        x = np.random.RandomState(0).rand(4, 8).astype("float32")
        lazy_mod.reset_counters()
        for _ in range(4):
            loss = fluid.layers.mean(l1(to_variable(x)))
            loss.backward()
            opt.minimize(loss, parameter_list=params)
            for p in params:
                p.clear_gradient()
            float(loss.numpy())
        assert len(tracer.lazy_engine._jit_cache) <= 2
        c = lazy_mod.counters()
        assert c["lazy.flushes"] == 4 and c["lazy.cache_hits"] >= 2, c


def test_gradient_read_forces_flush():
    with guard(True):
        l1 = Linear(8, 4)
        params = l1.parameters()
        loss = fluid.layers.mean(l1(to_variable(np.ones((2, 8), "float32"))))
        loss.backward()
        assert fluid.framework._dygraph_tracer().lazy_engine.nodes
        g = params[0].gradient()
        assert g is not None and g.shape == (8, 4) and np.isfinite(g).all()
        assert not fluid.framework._dygraph_tracer().lazy_engine.nodes


def test_dropout_rng_varies_per_step():
    """Seeds are not part of the key: a new mask each step, one plan."""
    with guard(True):
        tracer = fluid.framework._dygraph_tracer()
        x = to_variable(np.ones((4, 64), dtype="float32"))
        outs = [fluid.layers.dropout(x, dropout_prob=0.5).numpy()
                for _ in range(3)]
        assert not np.allclose(outs[0], outs[1])
        assert len(tracer.lazy_engine._jit_cache) <= 1


def test_lazy_shapes_without_flush():
    with guard(True):
        tracer = fluid.framework._dygraph_tracer()
        x = to_variable(np.ones((4, 8), dtype="float32"))
        y = fluid.layers.relu(x)
        assert y.shape == (4, 8)
        assert y.dtype == "float32"
        assert len(tracer.lazy_engine.nodes) == 1  # still queued
        assert np.allclose(y.numpy(), 1.0)          # forces
        assert len(tracer.lazy_engine.nodes) == 0


def test_getitem_stays_queued():
    with guard(True):
        tracer = fluid.framework._dygraph_tracer()
        x = to_variable(np.arange(24, dtype="float32").reshape(4, 6))
        z = fluid.layers.relu(x)[:, 0]
        assert len(tracer.lazy_engine.nodes) == 2  # relu + getitem
        np.testing.assert_allclose(z.numpy(),
                                   np.arange(24).reshape(4, 6)[:, 0])


def test_getitem_grads_under_lazy():
    def run(lazy):
        with guard(lazy):
            l1 = Linear(6, 6)
            _set_weights(l1.parameters(), 2)
            h = l1(to_variable(np.ones((4, 6), dtype="float32")))
            fluid.layers.mean(h[:, 0]).backward()
            return l1.parameters()[0].gradient()

    np.testing.assert_allclose(run(False), run(True), rtol=1e-6)


def test_dygraph_grad_api_under_lazy():
    def run(lazy):
        with guard(lazy):
            l1 = Linear(5, 3)
            _set_weights(l1.parameters(), 3)
            x = to_variable(np.ones((2, 5), dtype="float32"))
            x.stop_gradient = False
            (g,) = fluid.dygraph.grad(fluid.layers.reduce_sum(l1(x)), x)
            return g.numpy()

    np.testing.assert_allclose(run(False), run(True), rtol=1e-6)


def test_dygraph_grad_create_graph_raises_clearly_under_lazy():
    with guard(True):
        x = to_variable(np.ones((2, 2), dtype="float32"))
        x.stop_gradient = False
        y = fluid.layers.reduce_sum(x * x)
        with pytest.raises(NotImplementedError, match="lazy=False"):
            fluid.dygraph.grad(y, x, create_graph=True)


def test_max_nodes_valve_is_conservative():
    """The valve fires before owners attach (also mid-backward): it must
    materialize everything."""
    def run(cap):
        with guard(True):
            tracer = fluid.framework._dygraph_tracer()
            if cap:
                tracer.lazy_engine.MAX_NODES = cap
            l1 = Linear(8, 8)
            params = l1.parameters()
            _set_weights(params, 4)
            opt = fluid.optimizer.SGDOptimizer(0.1, parameter_list=params)
            x = to_variable(np.ones((2, 8), dtype="float32"))
            for _ in range(2):
                loss = fluid.layers.mean(l1(l1(l1(x))))
                loss.backward()
                opt.minimize(loss, parameter_list=params)
                for p in params:
                    p.clear_gradient()
            return float(loss.numpy())

    ref = run(None)
    assert np.allclose(run(3), ref, rtol=1e-5)
    assert np.allclose(run(7), ref, rtol=1e-5)


def _flash_encoder_losses(lazy, monkeypatch, read_mid=False, steps=2,
                          lengths=None, attention="flash"):
    """A 2-layer dygraph encoder (2 heads of 64, d_model 128, seq 16)
    trained ``steps`` Adam steps; counts the flash forward and backward
    calls (their plain versions on the CPU)."""
    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = fa.flash_attention_reference, \
        fa.flash_attention_backward_reference

    def count_fwd(*a, **k):
        calls["fwd"] += 1
        return fwd(*a, **k)

    def count_bwd(*a, **k):
        calls["bwd"] += 1
        return bwd(*a, **k)

    monkeypatch.setattr(fa, "flash_attention_reference", count_fwd)
    monkeypatch.setattr(fa, "flash_attention_backward_reference", count_bwd)
    B, S, H, Dh, layers = 2, 16, 2, 64, 2
    d = H * Dh
    L, D = fluid.layers, fluid.dygraph
    with guard(lazy):
        blocks = [{"q": D.Linear(d, d), "k": D.Linear(d, d),
                   "v": D.Linear(d, d), "ln": D.LayerNorm(d)}
                  for _ in range(layers)]
        params = [p for b in blocks for lyr in b.values()
                  for p in lyr.parameters()]
        _set_weights(params, 5)
        opt = fluid.optimizer.AdamOptimizer(1e-3, parameter_list=params)
        xs = np.random.RandomState(6).randn(B, S, d).astype("float32")
        losses, per_step = [], []

        def heads(t):
            return L.transpose(L.reshape(t, [B, S, H, Dh]), [0, 2, 1, 3])

        for _ in range(steps):
            before = dict(calls)
            x = to_variable(xs)
            for b in blocks:
                q, k, v = heads(b["q"](x)), heads(b["k"](x)), heads(b["v"](x))
                if attention == "flash":
                    ctx = L.flash_attention(
                        q, k, v, lengths=None if lengths is None
                        else to_variable(lengths))
                else:
                    s = L.matmul(q, k, transpose_y=True, alpha=Dh ** -0.5)
                    ctx = L.matmul(L.softmax(s), v)
                if read_mid:
                    ctx.numpy()
                ctx = L.reshape(L.transpose(ctx, [0, 2, 1, 3]), [B, S, d])
                x = b["ln"](x + ctx)
            loss = L.mean(x * x)
            loss.backward()
            opt.minimize(loss, parameter_list=params)
            for p in params:
                p.clear_gradient()
            losses.append(float(loss.numpy()))
            per_step.append({k: calls[k] - before[k] for k in calls})
    return losses, per_step


@pytest.mark.parametrize("lazy", [False, True], ids=["eager", "lazy"])
def test_backward_pulls_the_forward_graph_never_a_second_forward(
        lazy, monkeypatch):
    losses, per_step = _flash_encoder_losses(lazy, monkeypatch)
    assert per_step == [{"fwd": 2, "bwd": 2}] * 2, per_step
    ref, _ = _flash_encoder_losses(False, monkeypatch, attention="dense")
    np.testing.assert_allclose(losses, ref, rtol=1e-5)


def test_backward_of_an_earlier_flush_runs_its_forward_again(monkeypatch):
    """A host read between a forward and its backward flushes the
    forward alone; its backward then runs it again from its inputs (the
    JAX package's backward node does so always), with the same values."""
    le, _ = _flash_encoder_losses(False, monkeypatch, read_mid=True)
    ll, per_step = _flash_encoder_losses(True, monkeypatch, read_mid=True)
    assert per_step == [{"fwd": 4, "bwd": 2}] * 2, per_step
    np.testing.assert_allclose(le, ll, rtol=RTOL, atol=ATOL)


def test_flash_encoder_with_lengths_lazy_matches_eager(monkeypatch):
    lengths = np.array([16, 9], dtype="int32")
    le, _ = _flash_encoder_losses(False, monkeypatch, lengths=lengths,
                                  steps=3)
    ll, _ = _flash_encoder_losses(True, monkeypatch, lengths=lengths,
                                  steps=3)
    np.testing.assert_allclose(le, ll, rtol=RTOL, atol=ATOL)


class EmulatedGraph(lazy_mod._Graph):
    """The card's captured-flush path on the CPU: the capture keeps the
    flush's nodes and a replay runs them again over the graph's static
    input buffers, with its generators reseeded, handing out the same
    values a CUDA graph's replay does (the paired buffers written in
    place, the other outputs cloned)."""

    def capture(self, cache, body, generators=()):
        self._replay_body = body
        return {}

    def launch(self):
        self.outs = self._replay_body()


def _mlp_dropout_run(captured, steps=5, seed_counter=12345):
    """An MLP with dropout, Adam under NoamDecay; with ``captured`` the
    lazy engine takes the card's path (an eager flush, a capture, then
    replays) through ``EmulatedGraph``."""
    with guard(True):
        tracer = fluid.framework._dygraph_tracer()
        tracer._seed_counter = seed_counter
        if captured:
            tracer.lazy_engine.graph_cls = EmulatedGraph
        l1, l2 = Linear(16, 32, act="relu"), Linear(32, 4)
        drop = fluid.dygraph.Dropout(p=0.3)
        params = l1.parameters() + l2.parameters()
        _set_weights(params, 8)
        opt = fluid.optimizer.AdamOptimizer(
            fluid.dygraph.NoamDecay(d_model=16, warmup_steps=2),
            parameter_list=params)
        rng = np.random.RandomState(9)
        x = rng.rand(8, 16).astype("float32")
        y = rng.randint(0, 4, (8, 1)).astype("int64")
        lazy_mod.reset_counters()
        losses, snapshots = [], []
        for i in range(steps):
            loss = fluid.layers.mean(fluid.layers.softmax_with_cross_entropy(
                l2(drop(l1(to_variable(x)))), to_variable(y)))
            loss.backward()
            opt.minimize(loss, parameter_list=params)
            for p in params:
                p.clear_gradient()
            losses.append(float(loss.numpy()))
            # from the capture on, a parameter is its graph's input buffer
            assert lazy_mod.is_state_buffer(params[0]._array) == (
                captured and i >= 1)
            snapshots.append((params[0].detach(), params[0].numpy()))
        state = [v.numpy() for v in opt._dygraph_state.values()]
        return (losses, [p.numpy() for p in params], state, snapshots,
                lazy_mod.counters())


def test_captured_flush_path_matches_eager_flushes():
    """The card's path, emulated: parameters and moments updated in their
    input buffers, the rate an input, the dropout generators reseeded
    each replay: every loss, parameter and moment equals the eager-flush
    run's bits; a detached parameter keeps its value across replays."""
    le, pe, se, _, ce_ = _mlp_dropout_run(False)
    lc, pc, sc, snaps, cc = _mlp_dropout_run(True)
    assert ce_["lazy.captures"] == 0 and cc["lazy.captures"] == 1, cc
    assert cc["lazy.replays"] == 4 and cc["lazy.recompiles"] == 1, cc
    assert le == lc
    for a, b in zip(pe + se, pc + sc):
        np.testing.assert_array_equal(a, b)
    for detached, value in snaps:
        np.testing.assert_array_equal(detached.numpy(), value)
    assert len(set(le)) == len(le)
