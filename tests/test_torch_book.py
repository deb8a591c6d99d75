"""The six classes of ``tests/test_book.py`` through the port, on the CPU.

Each chapter is ``paddle_tpu_torch.models.book``'s script, which writes it
against the Fluid API of the package it is given, so the same script
builds the JAX package's program and the port's: the two must be the same
op for op. The JAX startup runs with its executor's RNG pinned (seed 90,
as ``test_book.py``'s ``_train``), its persistables are carried into the
port, and both take the chapter's first 5 batches from the port's
``dataset`` readers: the port's loss at each step must be within 1e-5 of
the JAX package's, relative to the first step's loss. The port then
trains on through the class's whole schedule, and the class's own
convergence assert must hold on the port's losses. machine_translation's
generation half decodes with the trained weights and must differ from a
decode with freshly initialized ones, as the class asserts.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as fluid
from paddle_tpu_torch.models import book

import test_torch_lr_schedule as LS  # noqa: E402
from test_torch_rnn import norm_seq  # noqa: E402

STEPS = 5
LOSS_RTOL = 1e-5  # of the first step's loss

# test_book.py's schedule and convergence assert of each class
PLAN = {
    "fit_a_line": (dict(epochs=4, limit=20),
                   lambda l: l[-1] < l[0] * 0.5),
    "word2vec": (dict(epochs=3, limit=30),
                 lambda l: np.mean(l[-(len(l) // 3):])
                 < np.mean(l[:len(l) // 3]) * 0.97),
    "recommender_system": (dict(epochs=3), lambda l: l[-1] < l[0] * 0.6),
    "understand_sentiment": (dict(epochs=3), lambda l: l[-1] < l[0] * 0.75),
    "machine_translation": (dict(epochs=6), lambda l: l[-1] < l[0] * 0.5),
    "label_semantic_roles": (dict(epochs=6), lambda l: l[-1] < l[0] * 0.6),
}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The chapters' tensors are tiny: one intra-op thread runs their
    hundreds of steps faster than many, and does not oversubscribe the
    cores the other test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(chapter):
    return chapter.main.global_block().var(chapter.feed_names[0]).shape[0]


def _loss(out):
    return float(np.ravel(np.asarray(out[0]))[0])


def train_both(name):
    """(JAX losses of the first STEPS batches, the port's losses over the
    whole schedule, the port's scope and executor)."""
    jc, pc = book.CHAPTERS[name](jfluid), book.CHAPTERS[name](fluid)
    assert norm_seq(pc.main) == norm_seq(jc.main), name
    jexe = jfluid.Executor(jfluid.CPUPlace())
    jexe._core.rng.seed = 90
    jexe._core.rng.step = 0
    jscope = jfluid.Scope()
    jexe.run(jc.startup, scope=jscope)
    pexe, pscope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    LS.carry(jc.main, jscope, pc.main, pscope)
    feeds = list(book.batches(name, _batch(pc), **PLAN[name][0]))
    jl = [_loss(jexe.run(jc.main, feed=f, fetch_list=[jc.loss],
                         scope=jscope)) for f in feeds[:STEPS]]
    pl = [_loss(pexe.run(pc.main, feed=f, fetch_list=[pc.loss],
                         scope=pscope)) for f in feeds]
    return jl, pl, pscope, pexe


@pytest.mark.parametrize("name", sorted(PLAN))
def test_the_chapter_trains_as_the_jax_package_and_converges(name):
    jl, pl, scope, exe = train_both(name)
    np.testing.assert_allclose(pl[:STEPS], jl, rtol=0,
                               atol=LOSS_RTOL * abs(jl[0]))
    assert np.isfinite(pl).all()
    assert PLAN[name][1](pl), (name, pl[0], pl[-1])
    if name == "machine_translation":
        _decode_uses_the_trained_weights(scope, exe)


def _decode_uses_the_trained_weights(scope, exe):
    """TestMachineTranslation's generation half on the port: the decode
    program's startup initializes its new cells and clobbers the shared
    weights; decoding then, and again after the trained weights are
    restored, must give different ids of the right shape and range."""
    main, startup, outs = book.mt_decode(fluid)
    trained = {}
    for n in scope.local_var_names():
        h = scope.find_var(n).raw()
        if isinstance(h, fluid.LoDTensor) and h.array is not None:
            trained[n] = h.numpy().copy()
    exe.run(startup, scope=scope)
    src = next(book.batches("machine_translation", 16))["src"]
    (fresh,) = exe.run(main, feed={"src": src}, fetch_list=[outs],
                       scope=scope)
    fluid.io.scope_from_numpy(scope, trained, fluid.CPUPlace())
    (ids,) = exe.run(main, feed={"src": src}, fetch_list=[outs],
                     scope=scope)
    ids = np.asarray(ids)
    assert ids.shape == (16, 10, 3)
    assert ((ids >= 0) & (ids < 30)).all()
    assert not np.array_equal(ids, np.asarray(fresh))
