"""The port's fast collective path: twins of tests/test_collectives.py.

The same contract, through ``paddle_tpu_torch`` over ``[CPUPlace()] * n``
replicas in one process:
- the bucketed allreduce is bit for bit the per-grad path (each element is
  summed over the replicas in rank order either way);
- the sharded weight update matches the replicated update bit for bit,
  uneven shards included, and its flat state holds the per-param state;
- the quantized allreduce stays within its error bound and still trains.
``test_quantized_psum_error_bounds`` also holds the port's quantized_psum
against the JAX package's on the same data over 8 devices: exact and int8
within 1e-6 relative (the codes and the shared scale are the same; only
XLA's summation order differs), bf16 within the bf16 bound.
"""
import json
import os

import numpy as np
import pytest
import torch

import paddle_tpu_torch as fluid
from paddle_tpu_torch import observability as obs
from paddle_tpu_torch.core.tensor import LoDTensor
from paddle_tpu_torch.parallel import collectives

KNOBS = ("PADDLE_TPU_BUCKET_MB", "PADDLE_TPU_QUANT_ALLREDUCE",
         "PADDLE_TPU_SHARDED_UPDATE", "PADDLE_TPU_BUCKET_PLAN",
         "PADDLE_TPU_BUCKET_PROFILE", "PADDLE_TPU_FUSED_OPTIMIZER")


@pytest.fixture(autouse=True)
def _clean_knobs(monkeypatch):
    for k in KNOBS:
        monkeypatch.delenv(k, raising=False)
    yield


def _set(scope, name, arr):
    scope.var(name).set(LoDTensor(torch.from_numpy(np.array(arr))))


def _get(scope, name):
    return scope.find_var(name).raw().array.numpy().copy()


# -- knob parsing -----------------------------------------------------------


def test_knob_parsing(monkeypatch):
    assert collectives.bucket_mb() == collectives.DEFAULT_BUCKET_MB
    monkeypatch.setenv("PADDLE_TPU_BUCKET_MB", "2.5")
    assert collectives.bucket_mb() == 2.5
    monkeypatch.setenv("PADDLE_TPU_BUCKET_MB", "0")
    assert collectives.bucket_mb() == 0.0
    monkeypatch.setenv("PADDLE_TPU_BUCKET_MB", "junk")
    assert collectives.bucket_mb() == collectives.DEFAULT_BUCKET_MB

    class BS:
        fuse_all_reduce_ops = False
        fuse_all_optimizer_ops = True

    assert collectives.bucket_mb(BS()) == 0.0
    assert collectives.quant_mode() == "none"
    for raw, want in (("bf16", "bf16"), ("INT8", "int8"), ("off", "none"),
                      ("0", "none")):
        monkeypatch.setenv("PADDLE_TPU_QUANT_ALLREDUCE", raw)
        assert collectives.quant_mode() == want
    monkeypatch.setenv("PADDLE_TPU_QUANT_ALLREDUCE", "fp4")
    with pytest.raises(ValueError):
        collectives.quant_mode()
    monkeypatch.delenv("PADDLE_TPU_QUANT_ALLREDUCE")
    assert not collectives.sharded_update_enabled()
    assert collectives.sharded_update_enabled(BS())
    monkeypatch.setenv("PADDLE_TPU_SHARDED_UPDATE", "0")
    assert not collectives.sharded_update_enabled(BS())
    monkeypatch.setenv("PADDLE_TPU_SHARDED_UPDATE", "1")
    assert collectives.sharded_update_enabled()


def test_plan_buckets_caps_and_order():
    K = (0, "float32")
    b = collectives.plan_buckets(
        [(0, 10, K, 3, 0), (1, 10, K, 3, 1), (2, 10, K, 3, 2)], 6)
    assert [x["members"] for x in b] == [[0, 1], [2]]
    K2 = (0, "float16")
    b = collectives.plan_buckets(
        [(0, 10, K, 3, 0), (1, 10, K2, 1, 1)], 1 << 20)
    assert [x["members"] for x in b] == [[0], [1]]
    b = collectives.plan_buckets(
        [(0, 3, K, 1, 0), (5, 10, K, 1, 1)], 1 << 20)
    assert [x["members"] for x in b] == [[0], [1]]
    b = collectives.plan_buckets(
        [(0, 10, K, 1, 0), (1, 10, K, 1, 1)], 0)
    assert [x["members"] for x in b] == [[0], [1]]


# -- program-path parity harness -------------------------------------------


def _build(optimizer, sizes=(32, 10), feat=8, batch=16):
    main, startup = fluid.Program(), fluid.Program()
    startup.random_seed = 7
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.data(name="x", shape=[batch, feat], dtype="float32")
        lbl = fluid.data(name="lbl", shape=[batch, 1], dtype="int64")
        h = x
        for s in sizes[:-1]:
            h = fluid.layers.fc(h, size=s, act="relu")
        pred = fluid.layers.fc(h, size=sizes[-1], act="softmax")
        loss = fluid.layers.mean(fluid.layers.cross_entropy(pred, lbl))
        optimizer().minimize(loss)
    return main, startup, loss


def _persistables(main, scope):
    blk = main.global_block()
    out = {}
    for name in blk.vars:
        v = scope.find_var(name)
        bv = blk._find_var_recursive(name)
        if (v is not None and v.is_initialized() and bv is not None
                and getattr(bv, "persistable", False)):
            out[name] = _get(scope, name)
    return out


def _pin(main, scope, snap):
    if not snap:
        snap.update(_persistables(main, scope))
    else:
        for name, arr in snap.items():
            _set(scope, name, arr)


def _feed(batch, feat, classes):
    rng = np.random.RandomState(0)
    return {"x": rng.rand(batch, feat).astype("float32"),
            "lbl": rng.randint(0, classes, (batch, 1)).astype("int64")}


def _run_mesh(env, optimizer, snap, steps=3, n=2, sizes=(32, 10), feat=8,
              batch=16):
    """One fresh program trained ``steps`` steps over ``n`` CPU replicas
    with the knob env; params seeded from (or recorded into) ``snap``."""
    for k in KNOBS:
        os.environ.pop(k, None)
    os.environ.update(env)
    try:
        main, startup, loss = _build(optimizer, sizes, feat, batch)
        feed = _feed(batch, feat, sizes[-1])
        scope = fluid.Scope()
        exe = fluid.Executor(fluid.CPUPlace())
        exe.run(startup, scope=scope)
        _pin(main, scope, snap)
        cp = fluid.CompiledProgram(main).with_data_parallel(
            loss_name=loss.name, places=[fluid.CPUPlace()] * n)
        for _ in range(steps):
            out = exe.run(cp, feed=feed, fetch_list=[loss], scope=scope)
        state = _persistables(main, scope)
        for nm in scope.local_var_names():
            if nm.startswith("sharded_update_"):
                state[nm] = _get(scope, nm)
        ctypes = [op.type for op in main.global_block().ops
                  if op.type.startswith("c_")]
        assert out[0].shape[0] == n
        return float(np.asarray(out[0]).mean()), state, ctypes
    finally:
        for k in env:
            os.environ.pop(k, None)


def _momentum():
    return fluid.optimizer.MomentumOptimizer(0.1, 0.9)


def _adam():
    return fluid.optimizer.AdamOptimizer(1e-2)


def _assert_params_equal(a, b, skip_substr=()):
    for k, va in a.items():
        if any(s in k.lower() for s in skip_substr):
            continue
        assert k in b, "var %r missing" % k
        assert np.array_equal(va, b[k]), (
            "var %r diverged, max abs err %g"
            % (k, np.abs(va.astype(np.float64)
                         - b[k].astype(np.float64)).max()))


def test_bucketed_allreduce_bit_for_bit():
    snap = {}
    base_loss, base, t0 = _run_mesh({"PADDLE_TPU_BUCKET_MB": "0"},
                                    _momentum, snap)
    buck_loss, buck, t1 = _run_mesh({}, _momentum, snap)
    assert t0.count("c_allreduce_sum") == 4
    assert t1.count("c_bucket_allreduce") == 1
    assert "c_allreduce_sum" not in t1
    assert buck_loss == base_loss
    _assert_params_equal(base, buck)


def test_bucket_size_cap_splits_buckets():
    snap = {}
    base_loss, base, _ = _run_mesh({"PADDLE_TPU_BUCKET_MB": "0"},
                                   _momentum, snap)
    tiny_loss, tiny, t = _run_mesh(
        {"PADDLE_TPU_BUCKET_MB": "0.00001"}, _momentum, snap)
    assert t.count("c_bucket_allreduce") == 4
    assert tiny_loss == base_loss
    _assert_params_equal(base, tiny)


@pytest.mark.parametrize("opt,state_slots", [
    (_momentum, ("velocity",)),
    (_adam, ("moment1", "moment2")),
])
def test_sharded_update_bit_for_bit(opt, state_slots):
    snap = {}
    base_loss, base, _ = _run_mesh({"PADDLE_TPU_BUCKET_MB": "0"},
                                   opt, snap)
    sh_loss, sh, t = _run_mesh({"PADDLE_TPU_SHARDED_UPDATE": "1"},
                               opt, snap)
    assert t.count("c_sharded_update") == 1
    assert "c_allreduce_sum" not in t and "c_bucket_allreduce" not in t
    assert sh_loss == base_loss
    _assert_params_equal(base, sh, skip_substr=("velocity", "moment"))
    for slot in state_slots:
        flats = [v for k, v in sh.items()
                 if k.startswith("sharded_update_")
                 and k.endswith("." + slot)]
        assert len(flats) == 1, "expected one flat %s var" % slot
        flat = flats[0]
        parts = [v.ravel() for k, v in sorted(base.items())
                 if slot in k.lower()]
        want = np.concatenate(parts)
        pad = flat.size - want.size
        assert pad >= 0
        assert np.array_equal(
            np.sort(flat), np.sort(np.concatenate(
                [want, np.zeros(pad, want.dtype)])))


def test_sharded_update_uneven_shards_dp8():
    """58 parameters over 8 replicas: the flat buffers pad to 64 and the
    padded tail stays inert."""
    snap = {}
    kw = dict(sizes=(5, 3), feat=7, n=8, steps=4)
    base_loss, base, _ = _run_mesh({"PADDLE_TPU_BUCKET_MB": "0"},
                                   _adam, snap, **kw)
    sh_loss, sh, t = _run_mesh({"PADDLE_TPU_SHARDED_UPDATE": "1"},
                               _adam, snap, **kw)
    assert t.count("c_sharded_update") == 1
    assert sh_loss == base_loss
    _assert_params_equal(base, sh, skip_substr=("moment",))
    flat = [v for k, v in sh.items() if k.endswith(".moment1")][0]
    assert flat.size == 64 and not flat[58:].any()


def test_sharded_update_flat_names_unique_across_programs():
    from paddle_tpu_torch.parallel.transpiler import insert_allreduce_ops

    scope = fluid.Scope()
    flat_names = []
    for sizes in ((32, 10), (16, 4)):
        main, startup, _loss = _build(_momentum, sizes=sizes)
        exe = fluid.Executor(fluid.CPUPlace())
        exe.run(startup, scope=scope)
        insert_allreduce_ops(main, 2)
        n = collectives.apply_sharded_weight_update(main, scope, 2)
        assert n == 1
        flat_names.append({nm for nm in scope.local_var_names()
                           if nm.startswith("sharded_update_")})
    assert flat_names[0] and flat_names[0] < flat_names[1], flat_names


def _cycle_with_restart(env, snap):
    for k in KNOBS:
        os.environ.pop(k, None)
    os.environ.update(env)
    try:
        main, startup, loss = _build(_adam)
        feed = _feed(16, 8, 10)
        scope = fluid.Scope()
        exe = fluid.Executor(fluid.CPUPlace())
        exe.run(startup, scope=scope)
        _pin(main, scope, snap)
        cp = fluid.CompiledProgram(main).with_data_parallel(
            loss_name=loss.name, places=[fluid.CPUPlace()] * 2)
        for _ in range(2):
            exe.run(cp, feed=feed, fetch_list=[loss], scope=scope)
        exe.run(startup, scope=scope)  # restart mid-job
        _pin(main, scope, snap)
        for _ in range(2):
            out = exe.run(cp, feed=feed, fetch_list=[loss], scope=scope)
        return float(np.asarray(out[0]).mean())
    finally:
        for k in env:
            os.environ.pop(k, None)


def test_sharded_update_state_resets_on_startup_rerun():
    snap = {}
    base = _cycle_with_restart({"PADDLE_TPU_BUCKET_MB": "0"}, snap)
    sh = _cycle_with_restart({"PADDLE_TPU_SHARDED_UPDATE": "1"}, snap)
    assert sh == base


def test_sharded_update_spares_grads_with_other_readers():
    from paddle_tpu_torch.parallel.transpiler import insert_allreduce_ops

    main, startup, _loss = _build(_momentum)
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup, scope=scope)
    insert_allreduce_ops(main, 2)
    blk = main.global_block()
    watched = next(op.input("Grad")[0] for op in blk.ops
                   if op.type == "momentum")
    blk.append_op("scale", {"X": [watched]}, {"Out": ["grad_watch"]},
                  {"scale": 1.0})
    assert collectives.apply_sharded_weight_update(main, scope, 2) == 1
    types = [op.type for op in blk.ops]
    assert types.count("c_sharded_update") == 1
    kept = [op for op in blk.ops if op.type == "momentum"]
    assert [op.input("Grad")[0] for op in kept] == [watched]
    kept_ar = [op for op in blk.ops if op.type == "c_allreduce_sum"]
    assert [op.input("X")[0] for op in kept_ar] == [watched]


def test_sharded_update_dense_fallback_matches():
    """The rewritten program on one replica (no group): the dense form of
    c_sharded_update matches the per-param ops exactly."""
    snap = {}

    def _dense_after_transpile(env):
        for k in KNOBS:
            os.environ.pop(k, None)
        os.environ.update(env)
        try:
            main, startup, loss = _build(_momentum)
            feed = _feed(16, 8, 10)
            scope = fluid.Scope()
            exe = fluid.Executor(fluid.CPUPlace())
            exe.run(startup, scope=scope)
            _pin(main, scope, snap)
            cp = fluid.CompiledProgram(main).with_data_parallel(
                loss_name=loss.name, places=[fluid.CPUPlace()] * 2)
            exe.run(cp, feed=feed, fetch_list=[loss], scope=scope)
            for name, arr in snap.items():
                _set(scope, name, arr)
            for nm in scope.local_var_names():
                if nm.startswith("sharded_update_") and \
                        nm.endswith(".velocity"):
                    _set(scope, nm, np.zeros_like(_get(scope, nm)))
            for _ in range(3):
                out = exe.run(main, feed=feed, fetch_list=[loss],
                              scope=scope)
            return float(np.asarray(out[0]).ravel()[0])
        finally:
            for k in env:
                os.environ.pop(k, None)

    dense_pergrad = _dense_after_transpile({"PADDLE_TPU_BUCKET_MB": "0"})
    dense_sharded = _dense_after_transpile(
        {"PADDLE_TPU_SHARDED_UPDATE": "1"})
    assert dense_sharded == dense_pergrad


# -- quantized allreduce ----------------------------------------------------


def test_quantized_psum_error_bounds():
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from paddle_tpu.ops.collective_ops import quantized_psum as jax_qpsum
    from paddle_tpu.parallel.mesh_utils import make_mesh, shard_map_compat
    from paddle_tpu_torch.ops.collective_ops import (ReplicaGroup,
                                                     quantized_psum)

    n = 8
    rng = np.random.RandomState(3)
    x = (rng.randn(n, 4096) * np.exp(rng.uniform(-3, 3, (n, 1)))
         ).astype("float32")
    group = ReplicaGroup(["cpu"] * n)
    xs = [torch.from_numpy(x[r].copy()) for r in range(n)]
    mesh = make_mesh([n], ["dp"])

    def jax_mode(mode):
        def f(v):
            return jax_qpsum(v.reshape(-1), "dp", mode)[None, :]
        return np.asarray(jax.jit(shard_map_compat(
            f, mesh, in_specs=P("dp"), out_specs=P("dp")))(
                jnp.asarray(x)))[0]

    def port_mode(mode):
        outs = quantized_psum(xs, group, mode)
        for o in outs[1:]:
            assert torch.equal(o, outs[0])  # every replica the same bits
        return outs[0].numpy()

    exact = port_mode("none")
    np.testing.assert_allclose(exact, x.sum(0), rtol=1e-6)
    np.testing.assert_allclose(exact, jax_mode("none"), rtol=1e-6,
                               atol=1e-6 * np.abs(x).max())

    q8 = port_mode("int8")
    scale = np.abs(x).max() / 127.0
    bound8 = n * scale / 2.0 + 1e-12
    assert np.abs(q8 - exact).max() <= bound8
    np.testing.assert_allclose(q8, jax_mode("int8"), rtol=1e-6,
                               atol=1e-6 * scale)

    qb = port_mode("bf16")
    boundb = n * np.abs(x).max() * 2.0 ** -8
    assert np.abs(qb - exact).max() <= boundb
    assert np.abs(qb - jax_mode("bf16")).max() <= boundb
    assert not np.array_equal(q8, exact)


def test_quantized_allreduce_mlp_converges():
    QUANT_LOSS_TOL = 0.05  # abs loss deviation after 8 steps
    snap = {}
    kw = dict(sizes=(64, 10), feat=32, batch=32, steps=8)
    l_first, _, _ = _run_mesh({"PADDLE_TPU_BUCKET_MB": "0"}, _adam, snap,
                              **dict(kw, steps=1))
    l_exact, _, _ = _run_mesh({"PADDLE_TPU_BUCKET_MB": "0"}, _adam, snap,
                              **kw)
    l_q, _, t = _run_mesh({"PADDLE_TPU_QUANT_ALLREDUCE": "int8"}, _adam,
                          snap, **kw)
    assert "c_bucket_allreduce" in t
    assert np.isfinite(l_q)
    assert l_q < l_first
    err = abs(l_q - l_exact)
    assert err <= QUANT_LOSS_TOL, (l_q, l_exact, err)


def test_quant_off_by_default():
    snap = {}
    _, _, t = _run_mesh({}, _momentum, snap)
    assert collectives.quant_mode() == "none"
    assert t.count("c_bucket_allreduce") == 1


# -- observability: kind labels and the bucketing win ----------------------


def test_collective_counters_by_kind_and_bucketing_win():
    obs.enable()
    try:
        obs.metrics().reset()
        snap = {}
        _run_mesh({"PADDLE_TPU_BUCKET_MB": "0"}, _momentum, snap, steps=1)
        base = obs.counter_value("parallel.collective_ops")
        assert base == obs.counter_value("parallel.collective_ops",
                                         kind="allreduce") == 4
        assert obs.counter_value("parallel.collective_bytes",
                                 kind="allreduce") > 0
        obs.metrics().reset()
        _run_mesh({}, _momentum, snap, steps=1)
        assert obs.counter_value("parallel.collective_ops") == 1
        obs.metrics().reset()
        _run_mesh({"PADDLE_TPU_QUANT_ALLREDUCE": "bf16"}, _momentum, snap,
                  steps=1)
        wire = obs.counter_value("parallel.collective_bytes")
        assert obs.counter_value("parallel.collective_bytes_saved") == wire
        obs.metrics().reset()
        _run_mesh({"PADDLE_TPU_QUANT_ALLREDUCE": "int8"}, _momentum, snap,
                  steps=1)
        assert obs.counter_value("parallel.collective_bytes") == 2 * wire
        assert not obs.counter_value("parallel.collective_bytes_saved")
        obs.metrics().reset()
        _run_mesh({"PADDLE_TPU_SHARDED_UPDATE": "1"}, _momentum, snap,
                  steps=1)
        assert obs.counter_value("parallel.collective_ops",
                                 kind="allreduce") == 1
        assert obs.counter_value("parallel.collective_ops",
                                 kind="allgather") == 1
    finally:
        obs.disable()
        obs.metrics().reset()


# -- profile-guided bucket planning ---------------------------------------


def test_bucket_plan_knob_parsing(monkeypatch):
    assert collectives.bucket_plan_mode() == "size"
    for raw, want in (("profile", "profile"), ("SIZE", "size"),
                      ("static", "size"), ("", "size")):
        monkeypatch.setenv("PADDLE_TPU_BUCKET_PLAN", raw)
        assert collectives.bucket_plan_mode() == want
    monkeypatch.setenv("PADDLE_TPU_BUCKET_PLAN", "vibes")
    with pytest.raises(ValueError):
        collectives.bucket_plan_mode()


def test_profile_plan_bit_for_bit(tmp_path):
    """``PADDLE_TPU_BUCKET_PLAN=profile`` with a report shaped for the
    model (its compute positions from the plain program) plans from the
    measurement: its cost line is steep enough that one bucket of all four
    grads passes the hide budget, so the plan splits them where the size
    plan makes one bucket, and stays bit for bit with the per-grad path."""
    from paddle_tpu_torch.observability.profiler import classify_ops

    main, _, _ = _build(_momentum, (32, 10), 8, 16)
    phases = classify_ops(main.global_block())
    fwd_end = sum(1 for p in phases if p == "forward")
    bwd_end = sum(1 for p in phases if p in ("forward", "backward"))
    report = {"n_compute": len(phases),
              "backward_segments": [[fwd_end, bwd_end, 10.0]],
              "per_bucket": [{"bytes": 256, "collective_ms": 1.0}]}
    rpt = tmp_path / "report.json"
    rpt.write_text(json.dumps(report))
    snap = {}
    base_loss, base, t0 = _run_mesh({"PADDLE_TPU_BUCKET_MB": "0"},
                                    _momentum, snap)
    _, _, t_default = _run_mesh({}, _momentum, snap)
    prof_loss, prof_state, t1 = _run_mesh(
        {"PADDLE_TPU_BUCKET_PLAN": "profile",
         "PADDLE_TPU_BUCKET_PROFILE": str(rpt)}, _momentum, snap)
    assert t0.count("c_allreduce_sum") == 4
    assert t_default.count("c_bucket_allreduce") == 1
    assert "c_allreduce_sum" not in t1
    assert t1.count("c_bucket_allreduce") >= 2
    assert prof_loss == base_loss
    _assert_params_equal(base, prof_state)


def test_profile_plan_falls_back_without_report(tmp_path):
    snap = {}
    _, base, t_default = _run_mesh({}, _momentum, snap)
    _, got, t1 = _run_mesh(
        {"PADDLE_TPU_BUCKET_PLAN": "profile",
         "PADDLE_TPU_BUCKET_PROFILE": str(tmp_path / "nope.json")},
        _momentum, snap)
    assert t1 == t_default
    _assert_params_equal(base, got)
    stale = tmp_path / "stale.json"
    stale.write_text(json.dumps(
        {"n_compute": 99999, "backward_segments": [[0, 5, 1.0]],
         "per_bucket": [{"bytes": 8, "collective_ms": 1.0}]}))
    _, got2, t2 = _run_mesh(
        {"PADDLE_TPU_BUCKET_PLAN": "profile",
         "PADDLE_TPU_BUCKET_PROFILE": str(stale)}, _momentum, snap)
    assert t2 == t_default
    _assert_params_equal(base, got2)


# -- every collective op against the JAX op over 8 devices ---------------


@pytest.mark.parametrize("op_type,attrs", [
    ("c_allreduce_sum", {}), ("c_allreduce_max", {}),
    ("c_allreduce_min", {}), ("c_allreduce_prod", {}),
    ("c_broadcast", {"root": 3}), ("c_allgather", {"nranks": 8}),
    ("c_reducescatter", {"nranks": 8}), ("c_concat", {"nranks": 8}),
    ("alltoall", {}), ("allreduce", {"reduce_type": 0}),
    ("allreduce", {"reduce_type": 1}), ("allreduce", {"reduce_type": 2}),
    ("allreduce", {"reduce_type": 3}), ("broadcast", {"root": 5}),
], ids=lambda v: v if isinstance(v, str) else
    "-".join("%s%s" % kv for kv in v.items()))
def test_collective_op_matches_the_jax_op(op_type, attrs):
    """Each op's form over 8 replicas of one process against the JAX op
    under shard_map over the 8 virtual devices, on the same per-replica
    inputs (positive where a product or its log is taken): within 1e-6
    relative (XLA sums in another order)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from paddle_tpu.core.registry import OpInfoMap as JaxOps
    from paddle_tpu.ops.collective_ops import ring_axis_guard as jguard
    from paddle_tpu.parallel.mesh_utils import make_mesh, shard_map_compat
    from paddle_tpu_torch.core.registry import OpInfoMap
    from paddle_tpu_torch.ops.collective_ops import ReplicaGroup

    n = 8
    rng = np.random.RandomState(5)
    x = rng.uniform(0.5, 1.5, (n, 16, 3)).astype("float32")
    if op_type == "allreduce" and attrs["reduce_type"] == 1:
        x[:, ::2] *= -1.0  # signs through the legacy product
    full = dict({"ring_id": 0}, **attrs)
    jfn = JaxOps.instance().get(op_type).fn

    def body(v):
        with jguard({0: "dp", -1: "dp"}):
            return jfn({"X": v[0]}, full)["Out"][None]

    want = np.asarray(jax.jit(shard_map_compat(
        body, make_mesh([n], ["dp"]), in_specs=P("dp"),
        out_specs=P("dp")))(jnp.asarray(x)))
    info = OpInfoMap.instance().get(op_type)
    outs = info.group_fn([{"X": torch.from_numpy(x[r].copy())}
                          for r in range(n)], dict(info.attrs, **full),
                         ReplicaGroup(["cpu"] * n))
    got = np.stack([o["Out"].numpy() for o in outs])
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("env", [
    {"PADDLE_TPU_ASYNC_COLLECTIVES": "1"},
    {"PADDLE_TPU_REDUCE_STRATEGY": "tree"},
    {"PADDLE_TPU_REDUCE_STRATEGY": "two_stage"},
], ids=["async", "tree", "two_stage"])
def test_schedule_shaping_is_bit_for_bit(env, monkeypatch):
    """The async split and the tree and two-stage spellings reshape the
    bucketed program (start / await pairs; each bucket op's ``strategy``)
    and stay bit for bit with the per-grad path over one data axis: the
    split reduces the same flat sum, the tree's shards are the rank-order
    sums of their slices, and two stages over one axis are the ring."""
    snap = {}
    base_loss, base, _ = _run_mesh({"PADDLE_TPU_BUCKET_MB": "0"},
                                   _momentum, snap)
    _, _, t_plain = _run_mesh({"PADDLE_TPU_BUCKET_MB": "0.00001"},
                              _momentum, snap)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    got_loss, got, t = _run_mesh({"PADDLE_TPU_BUCKET_MB": "0.00001"},
                                 _momentum, snap)
    if "PADDLE_TPU_ASYNC_COLLECTIVES" in env:
        assert t.count("c_bucket_allreduce_start") >= 2
        assert t.count("c_bucket_allreduce_await") == \
            t.count("c_bucket_allreduce_start")
        # a bucket whose first reader follows it stays whole
        assert t.count("c_bucket_allreduce") + \
            t.count("c_bucket_allreduce_start") == len(t_plain)
    else:
        assert t == t_plain and set(t) == {"c_bucket_allreduce"}
    assert got_loss == base_loss
    _assert_params_equal(base, got)


def test_int8_error_feedback_residual_trains(monkeypatch):
    """Error feedback gives each quantized bucket a residual var, one
    shard a replica, that holds the rounding error; the run trains."""
    monkeypatch.setenv("PADDLE_TPU_QUANT_ERROR_FEEDBACK", "1")
    snap = {}
    first, _, _ = _run_mesh({"PADDLE_TPU_BUCKET_MB": "0"}, _adam, snap,
                            steps=1)
    loss, state, t = _run_mesh({"PADDLE_TPU_QUANT_ALLREDUCE": "int8"},
                               _adam, snap, steps=4)
    assert t == ["c_bucket_allreduce"]
    assert np.isfinite(loss) and loss < first
    (res,) = [v for k, v in state.items()
              if k.startswith("bucket_ar_residual_")]
    n_params = 8 * 32 + 32 + 32 * 10 + 10
    assert res.shape == (2 * n_params,) and np.abs(res).max() > 0
