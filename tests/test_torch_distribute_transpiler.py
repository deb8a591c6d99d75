"""The port's parameter-server transpilers and their emulated training,
held against the JAX package from the same numpy inputs.

- Program parity: the trainer, pserver and startup programs that
  ``DistributeTranspiler`` (sync, async, sliced dense blocks, distributed
  tables with Adam's sliced moments), ``GeoSgdTranspiler`` and
  ``FlDistributeTranspiler`` emit equal the JAX package's op for op: op
  types, slots, attrs, block structure, var shapes and dtypes. The
  dispatchers ``HashName`` / ``RoundRobin`` give the same endpoints.
- Emulated training (in-process servers, each with its own ``Scope``):
  the sliced Momentum net, narrow Wide&Deep with row-sliced tables under
  Adam, geo-SGD's delta pushes and an FL round train through both
  packages from the JAX run's start (every server's slice copied from the
  JAX server's scope: the server startup draws from the executor's RNG,
  which torch cannot reproduce). Losses and every server's state agree
  within 2e-5 relative (float32 through XLA's and torch's kernels; the
  same program's ops differ in summation order by a few ulps a step);
  under Adam, as ``tests/test_torch_training.py`` holds Adam runs (a
  weight whose grad is float noise moves by up to 2 lr a step).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu import models as jmodels
from paddle_tpu import transpiler as jtr
from paddle_tpu.ops import distributed_ops as jdops

import paddle_tpu_torch as fluid
from paddle_tpu_torch import models as pmodels
from paddle_tpu_torch import transpiler as ptr
from paddle_tpu_torch.ops import distributed_ops as pdops

RTOL, ATOL = 2e-5, 1e-6
EPS2 = ["127.0.0.1:7164", "127.0.0.1:7165"]


@pytest.fixture(autouse=True)
def _fresh_servers():
    for m in (jdops, pdops):
        m.reset_emulated_servers()
        m.reset_geo_counters()
    yield
    for m in (jdops, pdops):
        m.reset_emulated_servers()
        m.reset_geo_counters()


# -- programs -----------------------------------------------------------------

def _norm(v):
    if hasattr(v, "ops") and hasattr(v, "idx"):  # a Block
        return ("block", v.idx)
    if isinstance(v, (list, tuple)):
        return [_norm(x) for x in v]
    if isinstance(v, dict):
        return {k: _norm(x) for k, x in sorted(v.items())}
    if isinstance(v, (np.integer, np.floating)):
        return v.item()
    if isinstance(v, float):
        return float(np.float32(v))
    if v is not None and not isinstance(v, (int, str, bool)):
        return str(v)
    return v


def _dtype(d):
    """A var's dtype by name; int32 reads as int64 (the JAX package infers
    an int64 slice's output as int32 with x64 off: ROADMAP.md's int64
    hazard)."""
    if d is None:
        return None
    s = str(d).replace("torch.", "").replace("paddle.", "")
    try:
        s = np.dtype(s).name
    except TypeError:
        return s
    return "int64" if s == "int32" else s


def program_sig(prog):
    """Every block of ``prog``: its parent, its ops (type, slots, attrs)
    and its vars (shape, dtype, persistable)."""
    out = []
    for b in prog.blocks:
        ops = [(op.type, _norm(dict(op.inputs)), _norm(dict(op.outputs)),
                _norm({k: v for k, v in op.attrs.items()
                       if not k.startswith("_")}))
               for op in b.ops]
        vars_ = {n: (None if v.shape is None else [int(x) for x in v.shape],
                     _dtype(v.dtype), bool(v.persistable))
                 for n, v in b.vars.items()}
        out.append((b.parent_idx, ops, vars_))
    return out


def assert_same_program(jprog, pprog, what):
    js, ps = program_sig(jprog), program_sig(pprog)
    assert len(js) == len(ps), what
    for i, (jb, pb) in enumerate(zip(js, ps)):
        assert jb[0] == pb[0], (what, i)
        assert [o[0] for o in jb[1]] == [o[0] for o in pb[1]], (what, i)
        for jo, po in zip(jb[1], pb[1]):
            assert jo == po, (what, i, jo, po)
        assert jb[2] == pb[2], (what, i)


def dense_net(pkg, opt="sgd"):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        x = pkg.data(name="x", shape=[16, 8], dtype="float32")
        y = pkg.data(name="y", shape=[16, 1], dtype="float32")
        h = pkg.layers.fc(x, 4, act="relu")
        pred = pkg.layers.fc(
            h, 1,
            param_attr=pkg.ParamAttr(
                name="w",
                initializer=pkg.initializer.ConstantInitializer(0.3)),
            bias_attr=pkg.ParamAttr(
                name="b",
                initializer=pkg.initializer.ConstantInitializer(0.0)))
        loss = pkg.layers.mean(pkg.layers.square_error_cost(pred, y))
        (pkg.optimizer.SGD(0.05) if opt == "sgd"
         else pkg.optimizer.AdamOptimizer(0.01)).minimize(loss)
    return main, startup, loss


def sliced_net(pkg):
    """tests/test_sliced_ps.py's net: w [16, 8] splits into two blocks."""
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        x = pkg.data(name="x", shape=[16, 16], dtype="float32")
        y = pkg.data(name="y", shape=[16, 1], dtype="float32")
        h = pkg.layers.fc(
            x, 8, act="relu",
            param_attr=pkg.ParamAttr(
                name="w",
                initializer=pkg.initializer.ConstantInitializer(0.12)),
            bias_attr=pkg.ParamAttr(
                name="b",
                initializer=pkg.initializer.ConstantInitializer(0.0)))
        pred = pkg.layers.fc(
            h, 1,
            param_attr=pkg.ParamAttr(
                name="w2",
                initializer=pkg.initializer.ConstantInitializer(0.2)),
            bias_attr=pkg.ParamAttr(
                name="b2",
                initializer=pkg.initializer.ConstantInitializer(0.0)))
        loss = pkg.layers.mean(pkg.layers.square_error_cost(pred, y))
        pkg.optimizer.MomentumOptimizer(0.05, 0.9).minimize(loss)
    return main, startup, loss


# narrow Wide&Deep (bench.py's model, cut): vocab 50, 3 slots, embed 8
WD = dict(batch=32, vocab=50, slots=3, dense=4, embed=8, hidden=(16,))


def wide_deep_net(pkg, is_distributed=True, lr=1e-2, opt="adam",
                  is_sparse=False, cfg=WD):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        dense = pkg.data(name="dense", shape=[cfg["batch"], cfg["dense"]],
                         dtype="float32")
        sparse = pkg.data(name="sparse", shape=[cfg["batch"],
                                                cfg["slots"]],
                          dtype="int64")
        label = pkg.data(name="label", shape=[cfg["batch"], 1],
                         dtype="int64")
        models = jmodels if pkg is jfluid else pmodels
        pred = models.wide_deep(
            dense, sparse, vocab_size=cfg["vocab"], embed_dim=cfg["embed"],
            hidden_sizes=cfg["hidden"], is_sparse=is_sparse,
            is_distributed=is_distributed)
        loss = pkg.layers.mean(pkg.layers.cross_entropy(pred, label))
        (pkg.optimizer.AdamOptimizer(lr) if opt == "adam"
         else pkg.optimizer.SGD(lr)).minimize(loss)
    return main, startup, loss


def wd_batches(n, seed=7, cfg=WD):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        sparse = rng.randint(0, cfg["vocab"], (cfg["batch"], cfg["slots"]))
        out.append({"dense": rng.rand(cfg["batch"], cfg["dense"]).astype(
                        "float32"),
                    "sparse": sparse.astype("int64"),
                    "label": (sparse[:, :1] % 2).astype("int64")})
    return out


def geo_net(pkg):
    """tests/test_geo_sgd.py's net."""
    prog, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(prog, startup), pkg.unique_name.guard():
        x = pkg.data(name="x", shape=[4, 3], dtype="float32")
        y = pkg.data(name="y", shape=[4, 1], dtype="float32")
        pred = pkg.layers.fc(x, size=1, param_attr=pkg.ParamAttr(name="w"),
                             bias_attr=False)
        loss = pkg.layers.mean(pkg.layers.square(pred - y))
        pkg.optimizer.SGD(0.1).minimize(loss)
    return prog, startup, loss


def fl_net(pkg):
    """tests/test_fl_training.py's net."""
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        x = pkg.layers.data("x", shape=[4], dtype="float32")
        y = pkg.layers.data("y", shape=[1], dtype="float32")
        pred = pkg.layers.fc(x, 1, bias_attr=False,
                             param_attr=pkg.ParamAttr(name="fl_w"))
        loss = pkg.layers.mean(pkg.layers.square_error_cost(pred, y))
        pkg.optimizer.SGD(0.1).minimize(loss)
    return main, startup, loss


def _transpile(pkg, mode, trainer_id=0, trainers=2):
    """(transpiler, main, startup, loss) of one mode, in ``pkg``."""
    tr = jtr if pkg is jfluid else ptr
    if mode in ("sync", "async"):
        main, startup, loss = dense_net(pkg)
        t = pkg.DistributeTranspiler()
        t.transpile(trainer_id, program=main, startup_program=startup,
                    pservers=",".join(EPS2), trainers=trainers,
                    sync_mode=(mode == "sync"))
    elif mode == "sliced":
        main, startup, loss = sliced_net(pkg)
        cfg = pkg.DistributeTranspilerConfig()
        cfg.min_block_size = 64
        t = pkg.DistributeTranspiler(config=cfg)
        t.transpile(trainer_id, program=main, startup_program=startup,
                    pservers=",".join(EPS2), trainers=trainers)
    elif mode == "dist_table":
        main, startup, loss = wide_deep_net(pkg)
        t = pkg.DistributeTranspiler()
        t.transpile(trainer_id, program=main, startup_program=startup,
                    pservers=",".join(EPS2), trainers=trainers)
    elif mode == "geo":
        main, startup, loss = geo_net(pkg)
        cfg = tr.DistributeTranspilerConfig()
        cfg.geo_sgd_need_push_nums = 2
        t = tr.GeoSgdTranspiler(cfg)
        t.transpile(trainer_id, program=main, startup_program=startup,
                    pservers=EPS2[0], trainers=trainers)
    else:
        main, startup, loss = fl_net(pkg)
        t = tr.FlDistributeTranspiler()
        t.transpile(trainer_id, program=main, startup_program=startup,
                    pservers=",".join(EPS2), trainers=trainers)
    return t, main, startup, loss


@pytest.mark.parametrize("mode", ["sync", "async", "sliced", "dist_table",
                                  "geo", "fl"])
def test_programs_equal_the_jax_package(mode):
    jt, jmain, jstart, _ = _transpile(jfluid, mode)
    pt, pmain, pstart, _ = _transpile(fluid, mode)
    if mode == "fl":
        assert_same_program(jt.get_trainer_recv_program(),
                            pt.get_trainer_recv_program(), "recv")
        assert_same_program(jt.get_trainer_send_program(),
                            pt.get_trainer_send_program(), "send")
    else:
        assert_same_program(jt.get_trainer_program(),
                            pt.get_trainer_program(), "trainer")
    assert_same_program(jstart, pstart, "trainer startup")
    for ep in (EPS2[:1] if mode == "geo" else EPS2):
        jps, pps = jt.get_pserver_program(ep), pt.get_pserver_program(ep)
        assert_same_program(jps, pps, "pserver " + ep)
        assert_same_program(jt.get_startup_program(ep, jps),
                            pt.get_startup_program(ep, pps),
                            "pserver startup " + ep)
    if mode == "dist_table":
        assert pt.dist_tables.keys() == jt.dist_tables.keys()
        for w, t in pt.dist_tables.items():
            assert t["starts"] == jt.dist_tables[w]["starts"]
            assert t["counts"] == jt.dist_tables[w]["counts"]
        # Adam's moments of a table are hosted as its row slice
        pps = pt.get_pserver_program(EPS2[1])
        moments = [v for n, v in pps.global_block().vars.items()
                   if "moment" in n and v.shape and int(v.shape[0]) == 25]
        assert len(moments) == 2 * WD["slots"]
    if mode == "sliced":
        assert [e["rows"] for e in pt.dense_blocks["w"]] == [8, 8]


def test_dispatchers_give_the_jax_endpoints():
    class V:
        def __init__(self, name):
            self.name = name

    vs = [V("fc_%d.w_0" % i) for i in range(7)]
    eps = ["a:1", "b:2", "c:3"]
    assert ptr.HashName(eps).dispatch(vs) == jtr.HashName(eps).dispatch(vs)
    prr, jrr = ptr.RoundRobin(eps), jtr.RoundRobin(eps)
    assert prr.dispatch(vs) == jrr.dispatch(vs)
    assert prr.dispatch(vs[:2]) == jrr.dispatch(vs[:2])
    prr.reset()
    jrr.reset()
    assert prr.dispatch(vs) == jrr.dispatch(vs)


def test_table_partition_is_the_same_for_int32_and_int64_ids():
    ids = np.array([0, 3, 24, 25, 49, 7, 30], dtype=np.int64)
    starts, counts = [0, 25], [25, 25]
    want = [(k, m.tolist(), r.tolist()) for k, m, r in
            jdops._table_partition(ids.astype(np.int32), starts, counts)]
    for dt in (np.int32, np.int64):
        got = [(k, m.tolist(), r.tolist()) for k, m, r in
               pdops._table_partition(ids.astype(dt), starts, counts)]
        assert got == want


def test_memory_optimize_shims():
    prog, _, _ = geo_net(fluid)
    ptr.memory_optimize(prog)
    ptr.release_memory(prog)


# -- emulated training --------------------------------------------------------

def jax_state(scope):
    """Every initialised tensor of a JAX scope, as numpy."""
    out = {}
    for n in scope.local_var_names():
        var = scope.find_var(n)
        if var is None or not var.is_initialized():
            continue
        raw = var.raw()
        arr = getattr(raw, "array", None)
        if arr is not None and hasattr(arr, "shape"):
            out[n] = np.array(arr)
    return out


def port_state(scope):
    out = {}
    for n in scope.local_var_names():
        var = scope.find_var(n)
        if var is None or not var.is_initialized():
            continue
        arr = getattr(var.raw(), "array", None)
        if isinstance(arr, torch.Tensor):
            out[n] = arr.detach().cpu().numpy().copy()
    return out


def load_state(scope, arrays):
    """numpy arrays into a port scope, as CPU tensors (the JAX package's
    int32 counters made int64)."""
    for n, a in arrays.items():
        if a.dtype == np.int32:
            a = a.astype(np.int64)
        scope.var(n).get_tensor().set(torch.from_numpy(np.array(a)))


def _run_emulated(pkg, mode, batches, jstarts=None, trainers=1):
    """Train ``batches`` through 2 emulated servers (one scope each) and
    one trainer; returns (losses, {ep: server state}, trainer state,
    starts). ``jstarts`` (the JAX run's starts) seeds the port run."""
    t, main, startup, loss = _transpile(pkg, mode, trainers=trainers)
    place = jfluid.CPUPlace() if pkg is jfluid else fluid.CPUPlace()
    exe = pkg.Executor(place)
    starts, sscopes = {}, {}
    for ep in EPS2:
        ps = t.get_pserver_program(ep)
        sscope = pkg.Scope()
        with pkg.scope_guard(sscope):
            exe.run(t.get_startup_program(ep, ps))
            if jstarts is not None:
                load_state(sscope, jstarts[ep])
            starts[ep] = (jax_state if pkg is jfluid
                          else port_state)(sscope)
            exe.run(ps)
        sscopes[ep] = sscope
    tscope = pkg.Scope()
    losses = []
    with pkg.scope_guard(tscope):
        exe.run(startup)
        if jstarts is not None:
            load_state(tscope, jstarts["trainer"])
        starts["trainer"] = (jax_state if pkg is jfluid
                             else port_state)(tscope)
        for feed in batches:
            (l,) = exe.run(t.get_trainer_program(), feed=feed,
                           fetch_list=[loss])
            losses.append(float(np.asarray(l).ravel()[0]))
    read = jax_state if pkg is jfluid else port_state
    return (losses, {ep: read(sscopes[ep]) for ep in EPS2}, read(tscope),
            starts)


def _hold(jrun, prun, adam_lr=None, steps=0):
    """Losses and every server's state of the port's run against the JAX
    run's. Under Adam (``adam_lr``) a weight whose grad is float noise
    moves by up to 2 lr a step in either package, so the weights are held
    as ``tests/test_torch_training.py`` holds them: within 2 lr a step,
    and 99.9% of elements within 1% of one step's move; the moments
    within 1e-4 of their scale."""
    rtol = RTOL if adam_lr is None else 1e-4
    np.testing.assert_allclose(prun[0], jrun[0], rtol=rtol, atol=ATOL)
    diffs = []
    for ep in EPS2:
        js, ps = jrun[1][ep], prun[1][ep]
        keys = [k for k in js if "@GRAD" not in k and k in ps]
        assert keys, ep
        for k in keys:
            msg = "%s %s" % (ep, k)
            if adam_lr is None or "pow_acc" in k:
                np.testing.assert_allclose(ps[k], js[k], rtol=RTOL,
                                           atol=ATOL, err_msg=msg)
            elif "moment" in k:
                scale = max(float(np.abs(js[k]).max()), 1e-3)
                np.testing.assert_allclose(ps[k], js[k], rtol=0,
                                           atol=1e-4 * scale, err_msg=msg)
            else:
                np.testing.assert_allclose(ps[k], js[k], rtol=0,
                                           atol=2 * adam_lr * steps,
                                           err_msg=msg)
                diffs.append(np.abs(ps[k] - js[k]).ravel())
    if diffs:
        assert np.quantile(np.concatenate(diffs), 0.999) <= 0.01 * adam_lr


def test_emulated_sliced_momentum_matches_jax():
    rng = np.random.RandomState(5)
    W = rng.randn(16, 1).astype("float32")
    batches = []
    for _ in range(6):
        xb = rng.randn(16, 16).astype("float32")
        batches.append({"x": xb, "y": xb @ W})
    jrun = _run_emulated(jfluid, "sliced", batches)
    prun = _run_emulated(fluid, "sliced", batches, jstarts=jrun[3])
    _hold(jrun, prun)
    # w is sliced: each server holds one 8-row block and its velocity
    for ep in EPS2:
        blocks = [k for k in prun[1][ep] if k.startswith("w.block")]
        assert blocks and all(prun[1][ep][k].shape[0] == 8
                              for k in blocks)


def test_emulated_wide_deep_adam_over_row_sliced_tables_matches_jax():
    batches = wd_batches(5)
    jrun = _run_emulated(jfluid, "dist_table", batches)
    prun = _run_emulated(fluid, "dist_table", batches, jstarts=jrun[3])
    _hold(jrun, prun, adam_lr=1e-2, steps=len(batches))
    # every server holds 25 rows of each table and of its two moments,
    # and the pushes moved its table slices
    for ep in EPS2:
        tables = [k for k, v in prun[1][ep].items()
                  if k.startswith("embedding.") and v.shape == (25, 8)]
        assert len(tables) == 3 * WD["slots"], sorted(prun[1][ep])
        assert all(not np.array_equal(prun[1][ep][k], prun[3][ep][k])
                   for k in tables if "moment" not in k)


def test_emulated_two_trainer_async_matches_jax():
    """Two trainers of one process against the same async servers, in
    turn: each send applies on arrival, as in the JAX package."""
    rng = np.random.RandomState(3)
    W = rng.randn(8, 1).astype("float32")
    feeds = []
    for _ in range(4):
        xb = rng.randn(16, 8).astype("float32")
        feeds.append({"x": xb, "y": xb @ W})
    runs = {}
    for pkg in (jfluid, fluid):
        ts = [_transpile(pkg, "async", trainer_id=i) for i in range(2)]
        place = jfluid.CPUPlace() if pkg is jfluid else fluid.CPUPlace()
        exe = pkg.Executor(place)
        sscopes = {}
        for ep in EPS2:
            ps = ts[0][0].get_pserver_program(ep)
            sscopes[ep] = pkg.Scope()
            with pkg.scope_guard(sscopes[ep]):
                exe.run(ts[0][0].get_startup_program(ep, ps))
                if pkg is fluid:
                    load_state(sscopes[ep], runs["jstart"][ep])
                else:
                    runs["jstart"] = runs.get("jstart", {})
                    runs["jstart"][ep] = jax_state(sscopes[ep])
                exe.run(ps)
        tscopes = [pkg.Scope(), pkg.Scope()]
        for i, (t, main, startup, loss) in enumerate(ts):
            with pkg.scope_guard(tscopes[i]):
                exe.run(startup)
                if pkg is fluid:
                    load_state(tscopes[i], runs["jstart"]["t%d" % i])
                else:
                    runs["jstart"]["t%d" % i] = jax_state(tscopes[i])
        losses = []
        for feed in feeds:
            for i, (t, main, startup, loss) in enumerate(ts):
                with pkg.scope_guard(tscopes[i]):
                    (l,) = exe.run(t.get_trainer_program(), feed=feed,
                                   fetch_list=[loss])
                losses.append(float(np.asarray(l).ravel()[0]))
        read = jax_state if pkg is jfluid else port_state
        runs[pkg] = (losses, {ep: read(sscopes[ep]) for ep in EPS2})
        pdops.reset_emulated_servers()
        jdops.reset_emulated_servers()
    _hold(runs[jfluid], runs[fluid])


def test_emulated_geo_sgd_matches_jax():
    rng = np.random.RandomState(0)
    W = rng.randn(3, 1).astype("float32")
    feeds = []
    for _ in range(4):
        xb = rng.randn(4, 3).astype("float32")
        feeds.append({"x": xb, "y": xb @ W})
    got = {}
    for pkg in (jfluid, fluid):
        t, prog, startup, loss = _transpile(pkg, "geo", trainers=1)
        place = jfluid.CPUPlace() if pkg is jfluid else fluid.CPUPlace()
        exe = pkg.Executor(place)
        sscope, tscope = pkg.Scope(), pkg.Scope()
        zeros = np.zeros((3, 1), "float32")
        with pkg.scope_guard(sscope):
            sscope.var("w").get_tensor().set(
                zeros if pkg is jfluid else torch.from_numpy(zeros))
            exe.run(t.get_pserver_program(EPS2[0]))
        with pkg.scope_guard(tscope):
            exe.run(startup)
            for n in ("w", "w.geo.snapshot"):
                tscope.var(n).get_tensor().set(
                    zeros if pkg is jfluid else torch.from_numpy(zeros))
            losses = []
            for feed in feeds:
                (l,) = exe.run(prog, feed=feed, fetch_list=[loss])
                losses.append(float(np.asarray(l).ravel()[0]))
        read = jax_state if pkg is jfluid else port_state
        got[pkg] = (losses, read(sscope)["w"], read(tscope))
    np.testing.assert_allclose(got[fluid][0], got[jfluid][0], rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(got[fluid][1], got[jfluid][1], rtol=RTOL,
                               atol=ATOL)
    # two pushes telescope to the trainer's weights
    np.testing.assert_allclose(got[fluid][1], got[fluid][2]["w"],
                               rtol=1e-6)


def test_emulated_fl_round_matches_jax(monkeypatch):
    rng = np.random.RandomState(0)
    W = rng.randn(4, 1).astype("float32")
    feeds = [[{"x": x, "y": x @ W} for x in
              (rng.randn(8, 4).astype("float32") for _ in range(3))]
             for _ in range(2)]
    got = {}
    for pkg in (jfluid, fluid):
        t, main, startup, loss = _transpile(pkg, "fl", trainers=2)
        place = jfluid.CPUPlace() if pkg is jfluid else fluid.CPUPlace()
        exe = pkg.Executor(place)
        sscopes = {}
        for ep in EPS2:
            ps = t.get_pserver_program(ep)
            sscopes[ep] = pkg.Scope()
            with pkg.scope_guard(sscopes[ep]):
                exe.run(t.get_startup_program(ep, ps))
                if pkg is fluid:
                    load_state(sscopes[ep], got["jstart"][ep])
                else:
                    got["jstart"] = got.get("jstart", {})
                    got["jstart"][ep] = jax_state(sscopes[ep])
                exe.run(ps)
        for tid in range(2):
            monkeypatch.setenv("PADDLE_TRAINER_ID", str(tid))
            scope = pkg.Scope()
            with pkg.scope_guard(scope):
                exe.run(startup)
                exe.run(t.get_trainer_recv_program())
                for feed in feeds[tid]:
                    exe.run(main, feed=feed, fetch_list=[loss])
                exe.run(t.get_trainer_send_program())
        read = jax_state if pkg is jfluid else port_state
        got[pkg] = {ep: read(sscopes[ep]) for ep in EPS2}
    owner = [ep for ep in EPS2 if "fl_w" in got[fluid][ep]][0]
    np.testing.assert_allclose(got[fluid][owner]["fl_w"],
                               got[jfluid][owner]["fl_w"], rtol=RTOL,
                               atol=ATOL)
    assert not np.allclose(got[fluid][owner]["fl_w"],
                           got["jstart"][owner]["fl_w"])


def test_the_fused_optimizer_pass_folds_the_geo_trainer_as_the_jax_pass():
    """The geo trainer keeps its Adam ops: the JAX package's
    ``apply_fused_optimizer`` folds them into one ``fused_optimizer`` op,
    and so does the port's, over the same params in the same order (on
    the card the op is K4)."""
    from paddle_tpu.core import fusion as jfusion

    from paddle_tpu_torch.core import fusion as pfusion

    got = {}
    for pkg in (jfluid, fluid):
        tr = jtr if pkg is jfluid else ptr
        main, startup, loss = wide_deep_net(pkg, is_distributed=False)
        cfg = tr.DistributeTranspilerConfig()
        cfg.geo_sgd_need_push_nums = 2
        t = tr.GeoSgdTranspiler(cfg)
        t.transpile(0, program=main, startup_program=startup,
                    pservers=",".join(EPS2), trainers=2)
        if pkg is jfluid:
            n = jfusion.apply_fused_optimizer(main, pkg.Scope(),
                                              use_pallas=False,
                                              layout="chain")
        else:
            n = pfusion.apply_fused_optimizer(main, pkg.Scope(),
                                              torch.device("cpu"),
                                              layout="chain")
        ops = main.global_block().ops
        (fused,) = [op for op in ops if op.type == "fused_optimizer"]
        got[pkg] = (n, [op.type for op in ops], fused.input("Param"),
                    fused.attrs.get("op_type"))
    assert got[fluid] == got[jfluid]
    n, types, params, op_type = got[fluid]
    assert n == 1 and "adam" not in types and op_type == "adam"
    assert len(params) == types.count("geo_send") == 9
