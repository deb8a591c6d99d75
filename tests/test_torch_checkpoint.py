"""The port's ``checkpoint.py`` on the CPU: twins of
``tests/test_fault_tolerance.py``'s atomic-checkpoint cases (rotation, the
``latest`` pointer and the fallback past a corrupt shard, a crash before
the rename, a missing or resized file) and of
``tests/test_survivable_ps.py``'s single-process incremental cases, plus
the cross-package cases: a checkpoint saved by either package verifies
and loads in the other (``save_checkpoint`` / ``load_checkpoint`` over a
program's persistables, a JAX-saved int32 step counter cast to the
program's int64), and the scope snapshot loader.

The JAX twins also read the observability counters
``checkpoint.shards_reused`` / ``checkpoint.delta_bytes``; the port has no
registry yet (its ``_count`` is a named no-op), so those asserts wait for
it (ROADMAP.md, queue 1).
"""
import os

import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu_torch as fluid
from paddle_tpu.checkpoint import CheckpointManager as JaxManager
from paddle_tpu_torch import checkpoint as ck
from paddle_tpu_torch.core import proto_format as pf
from paddle_tpu_torch.core.executor_core import CoreExecutor


def _writer(step):
    def w(d):
        np.savez(os.path.join(d, "state.npz"), w=np.full(4, step, "f4"))
    return w


def _damage(path, at=0):
    data = open(path, "rb").read()
    with open(path, "wb") as f:
        f.write(data[:at] + b"garbage" + data[at + 7:])


def test_rotation_latest_and_corrupt_fallback(tmp_path):
    root = str(tmp_path / "ckpts")
    mgr = ck.CheckpointManager(root, keep=3)
    for step in range(1, 6):
        mgr.save(step, _writer(step))
    assert mgr.steps() == [3, 4, 5]
    assert mgr.latest_step() == 5
    assert (tmp_path / "ckpts" / "latest").read_text() == "ckpt-5"
    loaded = {}

    def loader(d):
        loaded["w"] = np.load(os.path.join(d, "state.npz"))["w"]

    assert mgr.load_latest(loader) == 5
    _damage(str(tmp_path / "ckpts" / "ckpt-5" / "state.npz"))
    assert mgr.load_latest(loader) == 4 and loaded["w"][0] == 4.0
    assert mgr.load_at_or_before(3, loader) == 3 and loaded["w"][0] == 3.0
    assert mgr.load_at_or_before(2, loader) is None
    for step in (3, 4):
        _damage(str(tmp_path / "ckpts" / ("ckpt-%d" % step) / "state.npz"))
    with pytest.raises(ck.CheckpointCorrupt, match="sha256"):
        mgr.load_latest(loader)


def test_crash_before_rename_is_invisible(tmp_path):
    root = str(tmp_path / "ckpts")
    mgr = ck.CheckpointManager(root)
    with pytest.raises(RuntimeError, match="died mid-save"):
        with ck.atomic_checkpoint_dir(mgr.dir_for(7)) as tmp:
            np.savez(os.path.join(tmp, "state.npz"), w=np.ones(4))
            raise RuntimeError("died mid-save")
    assert mgr.steps() == [] and mgr.latest_step() is None
    leftover = os.path.join(root, "ckpt-9.tmp-123-456")
    os.makedirs(leftover)
    with open(os.path.join(leftover, "state.npz"), "wb") as f:
        f.write(b"partial")
    assert mgr.steps() == []
    assert mgr.load_latest(lambda d: None) is None


def test_manifest_detects_missing_and_resized(tmp_path):
    final = str(tmp_path / "snap")
    with ck.atomic_checkpoint_dir(final) as tmp:
        for fn in ("a.bin", "b.bin"):
            with open(os.path.join(tmp, fn), "wb") as f:
                f.write(fn[:1].encode() * 4)
    ck.verify_manifest(final)
    os.remove(os.path.join(final, "b.bin"))
    with pytest.raises(ck.CheckpointCorrupt, match="missing file"):
        ck.verify_manifest(final)
    with open(os.path.join(final, "b.bin"), "wb") as f:
        f.write(b"bbbbbb")
    with pytest.raises(ck.CheckpointCorrupt, match="bytes"):
        ck.verify_manifest(final)
    with pytest.raises(ck.CheckpointCorrupt, match="no __manifest__"):
        ck.verify_manifest(str(tmp_path))
    assert ck.verify_manifest(str(tmp_path), required=False) is None


def _must_not_run():
    raise AssertionError("fingerprint-matched shard was produced")


def _load(mgr):
    out = {}

    def loader(d):
        ck.verify_manifest(d)
        for fn in ("state.bin", "ballast.bin"):
            with open(os.path.join(d, fn), "rb") as f:
                out[fn] = f.read()

    return mgr.load_latest(loader), out


@pytest.mark.parametrize("reuse", ["link", "copy"])
def test_incremental_checkpoint_parity_and_fallback(tmp_path, reuse):
    big = os.urandom(1 << 15)
    full = ck.CheckpointManager(str(tmp_path / "full"), keep=3)
    inc = ck.CheckpointManager(str(tmp_path / "inc"), keep=3)

    def writer(step):
        def w(d):
            with open(os.path.join(d, "state.bin"), "wb") as f:
                f.write(b"round-%d" % step)
            with open(os.path.join(d, "ballast.bin"), "wb") as f:
                f.write(big)
        return w

    for step in (1, 2, 3):
        full.save(step, writer(step))
        inc.save_incremental(
            step, {"state.bin": b"round-%d" % step,
                   "ballast.bin": _must_not_run if step > 1 else big},
            fingerprints={"ballast.bin": "static-v1"}, reuse=reuse)
    assert _load(full) == _load(inc)
    ballast = [os.stat(os.path.join(inc.dir_for(s), "ballast.bin"))
               for s in (2, 3)]
    assert (ballast[0].st_ino == ballast[1].st_ino) == (reuse == "link")
    # content-hash reuse without a fingerprint
    inc.save_incremental(4, {"state.bin": b"round-4", "ballast.bin": big},
                         reuse=reuse)
    # a reused shard replaced by garbage (the torn-write case) costs one
    # rotation
    p = os.path.join(inc.dir_for(4), "ballast.bin")
    os.remove(p)
    with open(p, "wb") as f:
        f.write(b"garbage")
    step, out = _load(inc)
    assert step == 3 and out["ballast.bin"] == big
    with pytest.raises(ValueError, match="reuse"):
        inc.save_incremental(5, {}, reuse="move")


def test_incremental_copies_where_links_fail(tmp_path, monkeypatch):
    def no_link(src, dst):
        raise OSError("cross-device link")

    monkeypatch.setattr(ck.os, "link", no_link)
    mgr = ck.CheckpointManager(str(tmp_path / "c"))
    for step in (1, 2):
        mgr.save_incremental(step, {"a.bin": b"same"},
                             fingerprints={"a.bin": "v"})
    a = [os.stat(os.path.join(mgr.dir_for(s), "a.bin")) for s in (1, 2)]
    assert a[0].st_ino != a[1].st_ino
    assert _read(mgr.dir_for(2), "a.bin") == b"same"


def _read(d, fn):
    with open(os.path.join(d, fn), "rb") as f:
        return f.read()


def test_manifest_extra_roundtrips(tmp_path):
    mgr = ck.CheckpointManager(str(tmp_path / "c"), keep=2)
    smap = {"version": 2, "overrides": {"w0": 1}}
    mgr.save_incremental(1, {"state.bin": b"x"}, extra={"shard_map": smap})
    assert ck.manifest_extra(mgr.dir_for(1)).get("shard_map") == smap
    assert ck.manifest_extra(str(tmp_path / "nope")) == {}


def test_each_package_loads_the_other_s_rotation(tmp_path):
    """The same layout, manifest and ``latest`` pointer: the JAX manager
    loads what the port's saved, and back."""
    for Saver, Loader in ((ck.CheckpointManager, JaxManager),
                          (JaxManager, ck.CheckpointManager)):
        root = str(tmp_path / Saver.__module__)
        saver = Saver(root, keep=2)
        for step in (1, 2, 3):
            saver.save(step, _writer(step))
        got = {}
        assert Loader(root).load_latest(lambda d: got.update(
            w=np.load(os.path.join(d, "state.npz"))["w"])) == 3
        assert got["w"][0] == 3.0 and Loader(root).steps() == [2, 3]


def _counter_model(pkg):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        x = pkg.data(name="x", shape=[2, 3], dtype="float32")
        loss = pkg.layers.mean(pkg.layers.fc(x, 4))
        lr = pkg.layers.exponential_decay(0.1, decay_steps=2,
                                          decay_rate=0.5)
        pkg.optimizer.AdamOptimizer(lr).minimize(loss)
    return main, startup, loss


def test_save_checkpoint_crosses_packages_with_the_step_counter(tmp_path):
    """A JAX checkpoint of an Adam program under a schedule (its step
    counter int32, x64 off) loads into the port as the program's int64,
    and the next step's loss is the JAX package's; the port's checkpoint
    loads back into the JAX package."""
    x = np.random.RandomState(5).rand(2, 3).astype("float32")
    jmain, jstartup, jloss = _counter_model(jfluid)
    jexe = jfluid.Executor(jfluid.CPUPlace())
    jexe._core.rng.seed = 3
    jscope = jfluid.Scope()
    with jfluid.scope_guard(jscope):
        jexe.run(jstartup)
        for _ in range(2):
            jexe.run(jmain, feed={"x": x}, fetch_list=[jloss])
        jfluid.checkpoint.save_checkpoint(jexe, str(tmp_path / "j"), 2,
                                          jmain)
        (jnext,) = jexe.run(jmain, feed={"x": x}, fetch_list=[jloss])
    counter = [v.name for v in jmain.global_block().vars.values()
               if v.persistable and "COUNTER" in v.name]
    assert counter and str(np.asarray(jscope.find_var(
        counter[0]).get_tensor()).dtype) == "int32"

    main, _, loss = _counter_model(fluid)
    exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    with fluid.scope_guard(scope):
        assert fluid.checkpoint.load_checkpoint(
            exe, str(tmp_path / "j"), main) == 2
        assert scope.find_var(counter[0]).get_tensor().array.dtype == \
            fluid.core.dtypes.to_torch_dtype("int64")
        (pnext,) = exe.run(main, feed={"x": x}, fetch_list=[loss])
        np.testing.assert_allclose(pnext, jnext, rtol=1e-6)
        fluid.checkpoint.save_checkpoint(exe, str(tmp_path / "p"), 3, main)
    with jfluid.scope_guard(jfluid.Scope()) as _:
        assert jfluid.checkpoint.load_checkpoint(
            jexe, str(tmp_path / "p"), jmain) == 3
    assert fluid.checkpoint.load_checkpoint(exe, str(tmp_path / "none"),
                                            main) is None


def test_scope_snapshot_roundtrip_and_corruption(tmp_path):
    d = str(tmp_path / "snap")
    arrays = {"w": np.arange(4, dtype=np.float32),
              "emb/table": np.ones((3, 2), dtype=np.float32)}
    with ck.atomic_checkpoint_dir(d) as tmp:
        for i, (name, arr) in enumerate(sorted(arrays.items())):
            with open(os.path.join(tmp, "v%d" % i), "wb") as f:
                f.write(pf.serialize_lod_tensor(arr))
        ck.atomic_write_bytes(os.path.join(tmp, ck.SCOPE_VARS_NAME),
                              b'{"v0": "emb/table", "v1": "w"}')
    exe, scope = CoreExecutor(fluid.CPUPlace().device()), fluid.Scope()
    assert ck.load_scope_snapshot(exe, scope, d) == 2
    for name, arr in arrays.items():
        np.testing.assert_array_equal(
            scope.find_var(name).get_tensor().numpy(), arr)
    path = os.path.join(d, "v1")
    data = bytearray(open(path, "rb").read())
    data[8] ^= 0xFF
    with open(path, "wb") as f:
        f.write(bytes(data))
    with pytest.raises(ck.CheckpointCorrupt, match="sha256"):
        ck.load_scope_snapshot(exe, fluid.Scope(), d)


def test_a_flat_layout_checkpoint_resumes_bitwise(tmp_path, monkeypatch):
    """The fused optimizer's flat layout (the card's) keeps Adam's
    moments in flat persistables after its rewrite: a checkpoint loaded
    into a fresh scope resumes the uninterrupted run bit for bit (the
    restart resync must not rebuild the loaded flat state from per-param
    vars the scope does not hold)."""
    monkeypatch.setenv("PADDLE_TPU_FUSED_OPTIMIZER", "flat")
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.data(name="x", shape=[8, 6], dtype="float32")
        loss = fluid.layers.mean(fluid.layers.fc(fluid.layers.fc(x, 9), 3))
        fluid.optimizer.AdamOptimizer(0.05).minimize(loss)
    feed = {"x": np.random.RandomState(4).rand(8, 6).astype("float32")}
    exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    exe.run(startup, scope=scope)
    for _ in range(2):
        exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    assert main._sharded_flat_layout
    with fluid.scope_guard(scope):
        fluid.checkpoint.save_checkpoint(exe, str(tmp_path), 2, main)
    names = sorted(v.name for v in main.list_vars() if v.persistable)
    want = exe.run(main, feed=feed, fetch_list=[loss] + names, scope=scope)
    fresh = fluid.Scope()
    exe2 = fluid.Executor(fluid.CPUPlace())
    with fluid.scope_guard(fresh):
        assert fluid.checkpoint.load_checkpoint(exe2, str(tmp_path),
                                                main) == 2
    got = exe2.run(main, feed=feed, fetch_list=[loss] + names, scope=fresh)
    for n, a, b in zip(["loss"] + names, got, want):
        np.testing.assert_array_equal(a, b, err_msg=n)
