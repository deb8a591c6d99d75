"""Placement and the schedule rewrites, the port against the JAX package:
the cost model, the plan artifact, the verifier-gated search, the reduction
swap, the async split and the engine that reads a plan.

Twins of ``tests/test_placement.py``'s cases, each held to the JAX
package:

- the cost model's fitted coefficients and predictions, the strategy
  factors and the per-bucket quant derivation are the JAX package's,
  number for number (both are pure Python over the same report);
- a plan saved by one package loads in the other with the same digest, and
  a plan whose digest does not match its contents is refused by both;
- ``search_placement`` on the same builder (an MLP, the narrow gpt of
  ``tests/test_torch_training.py``) and the same saved report over 4
  replicas enumerates the same candidates, gives each the same status and
  picks the same winner (the same plan digest) in both packages;
- over the replicas of one process the async split and the tree spelling
  are bit for bit the fused ring reduction, and the two-stage spelling
  over a dp x sp mesh stays within ``reassociation_bound`` of it (another
  association of the same float sum) and trains within the dp x sp limits
  of ``tests/test_torch_hybrid_parallel.py``;
- a plan applied through the port's engine stays within
  ``tests/test_torch_data_parallel.py``'s limits of the JAX mesh under the
  same plan; a plan of another mesh, a sharded plan on a topology its
  update cannot run on and an unreadable plan are skipped whole and
  counted;
- a planted fault, a tree spelling that skips its all-gather, leaves the
  replicas apart.
"""
import json
import os
import sys

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu import placement as jplacement
from paddle_tpu.observability import profiler as jprofiler
from paddle_tpu.parallel import transpiler as jtranspiler
from paddle_tpu.placement import cost_model as jcost
from paddle_tpu.placement import plan as jplan_mod
from paddle_tpu.placement import search as jsearch

import paddle_tpu_torch as fluid
from paddle_tpu_torch import observability as pobs
from paddle_tpu_torch import placement as pplacement
from paddle_tpu_torch.analysis.contracts import reassociation_bound
from paddle_tpu_torch.core.registry import OpInfoMap
from paddle_tpu_torch.observability import profiler as pprofiler
from paddle_tpu_torch.ops import collective_ops
from paddle_tpu_torch.ops.collective_ops import AxisGroups
from paddle_tpu_torch.parallel import scheduling
from paddle_tpu_torch.parallel import transpiler as ptranspiler
from paddle_tpu_torch.parallel.mesh_utils import make_mesh
from paddle_tpu_torch.placement import cost_model as pcost
from paddle_tpu_torch.placement import plan as pplan_mod
from paddle_tpu_torch.placement import search as psearch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import test_torch_collectives as CT  # noqa: E402
import test_torch_data_parallel as DP  # noqa: E402
import test_torch_training as GT  # noqa: E402

KNOBS = ("PADDLE_TPU_BUCKET_MB", "PADDLE_TPU_QUANT_ALLREDUCE",
         "PADDLE_TPU_SHARDED_UPDATE", "PADDLE_TPU_BUCKET_PLAN",
         "PADDLE_TPU_BUCKET_PROFILE", "PADDLE_TPU_REDUCE_STRATEGY",
         "PADDLE_TPU_ASYNC_COLLECTIVES", "PADDLE_TPU_QUANT_ERROR_FEEDBACK",
         "PADDLE_TPU_PLACEMENT_PLAN", "PADDLE_TPU_FUSED_OPTIMIZER")


@pytest.fixture(autouse=True)
def _clean_knobs(monkeypatch):
    for k in KNOBS:
        monkeypatch.delenv(k, raising=False)
    jplan_mod._plan_cache.clear()
    pplan_mod._plan_cache.clear()
    yield
    jplan_mod._plan_cache.clear()
    pplan_mod._plan_cache.clear()


def _canned_report(a=0.5, b=2e-3, n_pts=4, n_compute=15):
    """per_bucket points on a known ``a + b * bytes`` line."""
    pts = [{"bytes": x, "collective_ms": a + b * x, "kind": "allreduce",
            "strategy": "ring", "quant": "none"}
           for x in (1024.0 * (i + 1) for i in range(n_pts))]
    return {"per_bucket": pts, "backward_segments": [[4, 12, 10.0]],
            "phase_ms": {"forward": 5.0, "backward": 10.0,
                         "optimizer": 2.0},
            "overlap_frac": 0.5, "n_compute": n_compute, "nranks": 8,
            "step_ms": 20.0, "exposed_collective_ms": 1.0}


# -- the cost model ------------------------------------------------------------------


def _model_view(m, sched):
    return {"terms": {k: list(v) for k, v in sorted(m.terms.items())},
            "compute_ms": m.compute_ms, "overhead_ms": m.overhead_ms,
            "overlap_eff": m.overlap_eff, "provenance": m.provenance,
            "base_strategy": m.base_strategy, "base_quant": m.base_quant,
            "fitted": sorted(m.fitted_kinds),
            "sync": m.predict(sched), "async": m.predict(sched, True),
            "by_strategy": [m.collective_ms("allreduce", nb, s, (4, 2), q)
                            for nb in (64.0, 1 << 20)
                            for s in ("ring", "tree", "two_stage")
                            for q in ("none", "bf16", "int8")]}


_SCHED = [{"kind": "allreduce", "bytes": 2048.0, "avail_pos": None,
           "strategy": "ring"},
          {"kind": "allreduce", "bytes": 1024.0, "avail_pos": 5,
           "strategy": "tree", "quant": "bf16"},
          {"kind": "allgather", "bytes": 4096.0, "avail_pos": 14}]


def _profile_block_report():
    rep = _canned_report()
    rep["profiled_step_ms"] = rep.pop("step_ms")
    return rep


def _bf16_report():
    rep = _canned_report()
    for b in rep["per_bucket"]:
        b["quant"] = "bf16"
    return rep


@pytest.mark.parametrize("report", [
    _canned_report(), _canned_report(n_pts=1), _canned_report(1.0, 1e-5),
    _profile_block_report(), _bf16_report(), None, {},
    {"per_bucket": [], "backward_segments": "nope"}],
    ids=["four_points", "one_point", "latency_bound", "profile_block",
         "bf16_measured", "none", "empty", "garbage"])
def test_the_cost_model_fits_and_predicts_as_the_jax_package(report):
    jm = jcost.fit_cost_model(report, nranks=8)
    pm = pcost.fit_cost_model(report, nranks=8)
    assert _model_view(pm, _SCHED) == _model_view(jm, _SCHED)
    if report is not None and report.get("per_bucket") and \
            len(report["per_bucket"]) == 4 and report.get("step_ms"):
        fa, fb = pm.terms["allreduce"]
        assert abs(fa - report["per_bucket"][0]["collective_ms"]
                   + fb * 1024.0) < 1e-6
        assert pm.provenance == "fitted"
        assert pm.overhead_ms == pytest.approx(2.0)


def test_strategy_factors_and_the_analytic_model_are_the_jax_package_s():
    for s in ("ring", "tree", "two_stage"):
        for n in (1, 2, 4, 8, 16):
            for stages in (None, (4, 2), (2, 2, 2)):
                assert pcost.strategy_factors(s, n, stages) == \
                    jcost.strategy_factors(s, n, stages)
    for const in ("DEFAULT_ALPHA_MS", "DEFAULT_BW_GBPS",
                  "DEFAULT_OVERLAP_EFF", "ASYNC_OVERLAP_BONUS",
                  "QUANT_COMPUTE_MS_PER_BYTE"):
        assert getattr(pcost, const) == getattr(jcost, const), const
    assert _model_view(pcost.analytic_cost_model(8, 1.0), _SCHED) == \
        _model_view(jcost.analytic_cost_model(8, 1.0), _SCHED)


def test_derive_quant_buckets_flips_only_wire_bound():
    sched = [{"op": "c_bucket_allreduce", "kind": "allreduce",
              "bytes": 4 << 20, "avail_pos": 2, "strategy": "ring"},
             {"op": "c_bucket_allreduce", "kind": "allreduce",
              "bytes": 64, "avail_pos": 8, "strategy": "ring"}]
    got = []
    for search, cost in ((jsearch, jcost), (psearch, pcost)):
        m = cost.fit_cost_model(_canned_report(b=5e-6), nranks=8)
        assert search.derive_quant_buckets(sched, m) is None
        wire = cost.CostModel(nranks=8, terms={"allreduce": (0.01, 1e-4)},
                              compute_ms=1.0, backward_segments=[],
                              fitted_kinds=frozenset({"allreduce"}),
                              base_quant="bf16", compute_fitted=True)
        got.append(search.derive_quant_buckets(sched, wire))
    assert got[1] == got[0] and got[1][0] == "bf16"


# -- the plan artifact ---------------------------------------------------------------


_PLANS = [
    dict(mesh=[("dp", 8)], strategy="tree", bucket_mb=2.0,
         quant_mode="int8", error_feedback=True, async_collectives=True,
         model="mlp"),
    dict(mesh=[("dp", 4), ("sp", 2)], strategy="two_stage",
         bucket_plan_mode="profile", report=_canned_report(),
         predicted_step_ms=12.5, cost_provenance="fitted",
         schedule_digest="ab" * 20, quant_buckets=["bf16", None],
         source={"seed": 0}),
    dict(mesh=[("dp", 2)], sharded_update=True),
]


@pytest.mark.parametrize("i", range(len(_PLANS)))
def test_a_plan_saved_by_one_package_loads_in_the_other(i, tmp_path):
    kw = _PLANS[i]
    jp, pp = jplacement.PlacementPlan(**kw), pplacement.PlacementPlan(**kw)
    assert pp.to_doc() == jp.to_doc() and pp.digest == jp.digest
    assert pp.summary() == jp.summary()
    for save, load, tag in ((pplacement.save_plan, jplacement.load_plan,
                             "port"),
                            (jplacement.save_plan, pplacement.load_plan,
                             "jax")):
        path = str(tmp_path / ("%s.json" % tag))
        digest = save(pp if tag == "port" else jp, path)
        got = load(path)
        assert got.digest == digest == pp.digest
        assert got.to_doc() == pp.to_doc()
    # canonical: the two packages write the same bytes
    assert (tmp_path / "port.json").read_text() == \
        (tmp_path / "jax.json").read_text()
    for nranks, axes in ((8, ("dp",)), (8, ("dp", "sp")), (4, ("dp",)),
                         (2, ("dp",))):
        assert pp.matches(nranks, axes) == jp.matches(nranks, axes)


def test_a_plan_whose_digest_does_not_match_is_refused_by_both(tmp_path):
    path = str(tmp_path / "plan.json")
    pplacement.save_plan(pplacement.PlacementPlan(mesh=[("dp", 8)]), path)
    doc = json.load(open(path))
    doc["strategy"] = "tree"  # edited, not re-digested
    with open(path, "w") as f:
        json.dump(doc, f)
    for load in (pplacement.load_plan, jplacement.load_plan):
        with pytest.raises(ValueError, match="digest mismatch"):
            load(path)
    for P in (pplacement.PlacementPlan, jplacement.PlacementPlan):
        with pytest.raises(ValueError):
            P(mesh=[("dp", 8)], strategy="vibes")
        with pytest.raises(ValueError):
            P(mesh=[("dp", 8)], bucket_plan_mode="profile", report=None)
        with pytest.raises(ValueError):
            P(mesh=[("dp", 8)], quant_buckets=["fp8"])


def test_an_unreadable_plan_degrades_and_is_counted(tmp_path, monkeypatch):
    p = tmp_path / "garbage.json"
    p.write_text("{not json")
    monkeypatch.setenv("PADDLE_TPU_PLACEMENT_PLAN", str(p))
    pobs.enable()
    try:
        before = pobs.counter_value("placement.plan_skipped",
                                    reason="unreadable")
        assert pplan_mod.active_plan() is None
        assert pplan_mod.active_plan() is None  # read once a path
        assert pobs.counter_value("placement.plan_skipped",
                                  reason="unreadable") == before + 1
    finally:
        pobs.disable()


# -- the search ------------------------------------------------------------------------


def _mlp(pkg):
    def build():
        main, startup = pkg.Program(), pkg.Program()
        with pkg.unique_name.guard(), pkg.program_guard(main, startup):
            x = pkg.data(name="x", shape=[16, 8], dtype="float32")
            lbl = pkg.data(name="lbl", shape=[16, 1], dtype="int64")
            h = pkg.layers.fc(x, size=32, act="relu")
            pred = pkg.layers.fc(h, size=10, act="softmax")
            loss = pkg.layers.mean(pkg.layers.cross_entropy(pred, lbl))
            pkg.optimizer.MomentumOptimizer(0.1, 0.9).minimize(loss)
        return main, loss.name
    return build


def _gpt(pkg):
    def build():
        main, _, loss, _ = GT.build_gpt(pkg, batch=1)
        return main, loss.name
    return build


def _shaped_report(pkg, builder, transpiler, profiler, n):
    """The canned report with its compute positions taken from the model
    (a report of another program shape is ignored by the profile plan)."""
    probe, _ = builder()
    transpiler.insert_allreduce_ops(probe, n)
    phases = profiler.classify_ops(probe.global_block())
    n_compute = sum(1 for p in phases if p != "collective")
    fwd = sum(1 for p in phases if p == "forward")
    rep = _canned_report(n_compute=n_compute)
    rep["backward_segments"] = [[fwd, n_compute - 2, 10.0]]
    rep["nranks"] = n
    return rep


def _rows(audit):
    return [(r["mesh"], r["sharded_update"], r["bucket"], r["strategy"],
             r["quant"], r["async_collectives"], r["status"],
             r["verified"], r["schedule_digest"], r["predicted_step_ms"],
             r["provenance"]) for r in audit["candidates"]]


@pytest.mark.parametrize("model,report", [
    ("mlp", True), ("mlp", False), ("gpt", True)],
    ids=["mlp_report", "mlp_analytic", "gpt_report"])
def test_the_search_picks_the_jax_package_s_plan(model, report):
    """4 replicas: the same candidates with the same statuses, schedule
    digests and predictions, the same winner digest; every candidate
    passed the gate before anything ran, the hybrid meshes are recorded
    as unsupported."""
    make = {"mlp": _mlp, "gpt": _gpt}[model]
    rep = (_shaped_report(jfluid, make(jfluid), jtranspiler, jprofiler, 4)
           if report else None)
    if report:
        assert rep == _shaped_report(fluid, make(fluid), ptranspiler,
                                     pprofiler, 4)
    jp, ja = jplacement.search_placement(make(jfluid), 4, report=rep,
                                         beam_width=3, model=model)
    pp, pa = pplacement.search_placement(make(fluid), 4, report=rep,
                                         beam_width=3, model=model)
    assert _rows(pa) == _rows(ja)
    for k in ("enumerated", "verified", "rejected", "deduped", "pruned",
              "unsupported", "capabilities", "cost_provenance",
              "traced_before_verify"):
        assert pa[k] == ja[k], k
    assert pp.digest == jp.digest and pp.to_doc() == jp.to_doc()
    assert pa["traced_before_verify"] == 0 and pa["rejected"] == 0
    assert pa["unsupported"]
    assert pa["cost_provenance"] == ("fitted" if report else "analytic")
    if not report:
        assert pa["deduped"] > 0
    assert pp.predicted_step_ms > 0 and pp.schedule_digest


def test_a_candidate_that_fails_the_gate_is_rejected_not_run(monkeypatch):
    """A rewrite that breaks the program (a bucket op reducing a grad
    twice) is recorded as rejected by the static gate."""
    real = psearch._rewrite_candidate

    def broken(cand, builder, report):
        main, scope, loss = real(cand, builder, report)
        ops = main.global_block().ops
        dup = [op for op in ops if op.type == "c_bucket_allreduce"]
        if dup and cand.strategy == "tree":
            ops.insert(ops.index(dup[0]) + 1, dup[0])
        return main, scope, loss

    monkeypatch.setattr(psearch, "_rewrite_candidate", broken)
    _, audit = pplacement.search_placement(_mlp(fluid), 4, beam_width=3)
    rejected = [r for r in audit["candidates"] if r["status"] == "rejected"]
    assert rejected and all(r["strategy"] == "tree" and not r["verified"]
                            and "static gate" in r["error"]
                            for r in rejected)
    assert audit["winner"]["strategy"] != "tree"


# -- the spellings and the async split over the replicas -------------------------------


def _group(shape, names):
    mesh = make_mesh(shape, names, [fluid.CPUPlace()] * int(np.prod(shape)))
    axes = tuple(names)
    g = AxisGroups(mesh.axis_groups(axes), mesh.devices,
                   [mesh.axis_groups([a]) for a in axes])
    ((ranks, sub),) = g.parts()
    return ranks, sub


def _bucket(sub, xs, **attrs):
    info = OpInfoMap.instance().get("c_bucket_allreduce")
    outs = info.group_fn([{"X": [x]} for x in xs],
                         dict(info.attrs, **attrs), sub)
    return [o["Out"][0] for o in outs]


def test_tree_is_the_ring_s_bits_and_two_stage_within_the_bound():
    """Over a dp(2) x sp(2) group: the tree spelling gives the ring's bits
    (its shards are rank-order sums of their slices), the two-stage
    spelling sums over sp and then over dp (another association), within
    ``reassociation_bound`` of the ring and not its bits on these
    values."""
    ranks, sub = _group([2, 2], ["dp", "sp"])
    assert sub.stages is not None and len(sub.stages) == 2
    rng = np.random.RandomState(3)
    xs = [torch.from_numpy((rng.randn(1001) * 10.0 ** rng.randint(
        -3, 4, 1001)).astype("float32")) for _ in ranks]
    ring = _bucket(sub, xs)
    tree = _bucket(sub, xs, strategy="tree")
    two = _bucket(sub, xs, strategy="two_stage")
    for r, t in zip(ring, tree):
        assert torch.equal(r, t)
    bound = reassociation_bound(
        torch.stack([x.abs() for x in xs]).sum(0).double(), len(xs),
        float(np.finfo(np.float32).eps))
    for r, t in zip(ring, two):
        assert bool(((r.double() - t.double()).abs() <= bound).all())
    assert not torch.equal(ring[0], two[0])
    assert all(torch.equal(two[0], t) for t in two[1:])
    # int8 codes are exact under every spelling
    q_ring = _bucket(sub, xs, quant="int8")
    q_two = _bucket(sub, xs, quant="int8", strategy="two_stage")
    for a, b in zip(q_ring, q_two):
        assert torch.equal(a, b)
    # one axis: two stages are the ring
    _, one = _group([4], ["dp"])
    assert one.stages is None
    for a, b in zip(_bucket(one, xs), _bucket(one, xs,
                                              strategy="two_stage")):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="unknown reduction strategy"):
        _bucket(sub, xs, strategy="vibes")


def test_a_tree_that_skips_its_all_gather_leaves_the_replicas_apart(
        monkeypatch):
    """The planted fault of chip_smoke.py's phase 65: each replica keeps
    only its own shard of the sum."""
    def no_gather(shards, group, numel):
        out = []
        for r, s in enumerate(shards):
            full = torch.zeros(group.nranks * s.numel(), dtype=s.dtype)
            full[r * s.numel():(r + 1) * s.numel()] = s
            out.append(full[:numel])
        return out

    monkeypatch.setattr(collective_ops, "_tree_gather", no_gather)
    snap = {}
    _, base, _ = CT._run_mesh({"PADDLE_TPU_BUCKET_MB": "0"}, CT._momentum,
                              snap)
    monkeypatch.setenv("PADDLE_TPU_REDUCE_STRATEGY", "tree")
    _, got, _ = CT._run_mesh({}, CT._momentum, snap)
    assert any(not np.array_equal(base[k], got[k]) for k in base)


def test_the_async_split_is_bit_for_bit_over_eight_replicas():
    snap = {}
    base_loss, base, _ = CT._run_mesh({"PADDLE_TPU_BUCKET_MB": "0"},
                                      CT._momentum, snap, n=8)
    loss, got, t = CT._run_mesh({"PADDLE_TPU_ASYNC_COLLECTIVES": "1",
                                 "PADDLE_TPU_BUCKET_MB": "0.00001",
                                 "PADDLE_TPU_REDUCE_STRATEGY": "tree"},
                                CT._momentum, snap, n=8)
    assert t.count("c_bucket_allreduce_start") >= 2
    assert t.count("c_bucket_allreduce_await") == \
        t.count("c_bucket_allreduce_start")
    assert loss == base_loss
    CT._assert_params_equal(base, got)


def test_the_async_split_keeps_a_bucket_with_no_room():
    main, _ = _mlp(fluid)()
    ptranspiler.insert_allreduce_ops(main, 8)
    from paddle_tpu_torch.parallel.collectives import bucket_allreduce_ops

    bucket_allreduce_ops(main, bucket_bytes=4 << 20)
    assert scheduling.schedule_async_collectives(main) == 0
    assert main._async_schedule == {"split": 0, "kept": 1}


def test_the_swap_and_split_contracts_catch_a_broken_rewrite(monkeypatch):
    """The async contract refuses a split whose await is missing; the
    swap contract a spelling no op knows."""
    from paddle_tpu_torch.analysis import contracts
    from paddle_tpu_torch.parallel.collectives import bucket_allreduce_ops

    monkeypatch.setenv("PADDLE_TPU_VERIFY_IR", "1")
    main, _ = _mlp(fluid)()
    ptranspiler.insert_allreduce_ops(main, 4)
    bucket_allreduce_ops(main, bucket_bytes=1)
    state = contracts.contract_for("async_collective").pre(main)
    scheduling.schedule_async_collectives(main)
    ops = main.global_block().ops
    ops.remove([op for op in ops if op.type ==
                "c_bucket_allreduce_await"][0])
    with pytest.raises(contracts.ContractViolation, match="await"):
        contracts.contract_for("async_collective").post(main, state)
    main2, _ = _mlp(fluid)()
    ptranspiler.insert_allreduce_ops(main2, 4)
    bucket_allreduce_ops(main2, bucket_bytes=1 << 20)
    state = contracts.contract_for("reduction_swap").pre(main2)
    for op in main2.global_block().ops:
        if op.type == "c_bucket_allreduce":
            op.attrs["strategy"] = "vibes"
    with pytest.raises(contracts.ContractViolation, match="vibes"):
        contracts.contract_for("reduction_swap").post(main2, state)


def test_two_stage_over_dp_sp_trains_within_the_dense_model_s_limits(
        monkeypatch):
    """The narrow gpt over dp(2) x sp(2) with the two-stage spelling,
    against the JAX package's dense run from the same start, under the
    limits the ring spelling meets
    (``tests/test_torch_hybrid_parallel.py``)."""
    import test_torch_hybrid_parallel as HP

    S, B, vocab = 64, 2, 128
    rng = np.random.RandomState(29)
    feeds = [{"ids": rng.randint(0, vocab, (B, S)).astype("int64"),
              "lbl": rng.randint(0, vocab, (B, S, 1)).astype("int64")}
             for _ in range(2)]
    dmain, dstart, dloss = HP.gpt_sp(jfluid, S, sp=0, batch=B)
    jexe, jscope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    with jfluid.scope_guard(jscope):
        jexe.run(dstart)
        init = HP.persistables(dmain, jscope)
    dl, ds = HP.train_jax_dense(dmain, dstart, dloss, init, feeds)
    monkeypatch.setenv("PADDLE_TPU_REDUCE_STRATEGY", "two_stage")
    pmain, pstart, ploss = HP.gpt_sp(fluid, S // 2, sp=2, batch=B // 2,
                                     dp=2)
    pl, ps = HP.train_port(pmain, pstart, ploss, init, feeds, make_mesh(
        [2, 2], ["dp", "sp"], [fluid.CPUPlace()] * 4))
    buckets = [op for op in pmain.global_block().ops
               if op.type == "c_bucket_allreduce"]
    assert buckets and all(op.attrs["strategy"] == "two_stage"
                           for op in buckets)
    HP.assert_keeps_the_dense_model(pl, ps, dl, ds, len(feeds))


# -- the engine reads the plan ----------------------------------------------------------


def test_a_plan_through_the_engine_matches_the_jax_mesh_under_it(
        tmp_path, monkeypatch):
    """One plan (tree, per-grad buckets, the async split) read by both
    engines from ``PADDLE_TPU_PLACEMENT_PLAN`` over 8 replicas: the
    port's run within the data-parallel limits of the JAX mesh's, the
    plan's record on the program, the rewrite the plan named."""
    plan = pplacement.PlacementPlan(
        mesh=[("dp", 8)], strategy="tree", bucket_mb=0.00001,
        async_collectives=True, model="mlp", predicted_step_ms=12.5)
    path = str(tmp_path / "plan.json")
    pplacement.save_plan(plan, path)
    monkeypatch.setenv("PADDLE_TPU_PLACEMENT_PLAN", path)
    n, batch = 8, 32
    feeds = DP.mlp_feeds(3, batch)
    build = lambda pkg: DP.mlp(pkg, batch // n, opt="momentum")  # noqa
    j = DP.run_jax(build, feeds, n)
    p = DP.run_port(build, feeds, n, j[2])
    DP.assert_close_runs(j, p)
    for main in (j[3], p[2]):
        rec = main._placement_plan
        assert rec["plan_digest"] == plan.digest
        assert rec["predicted_step_ms"] == 12.5
        types = [op.type for op in main.global_block().ops]
        assert types.count("c_bucket_allreduce_start") >= 2
    starts = [op for op in p[2].global_block().ops
              if op.type == "c_bucket_allreduce_start"]
    assert all(op.attrs["strategy"] == "tree" for op in starts)


def test_a_plan_of_another_mesh_is_skipped_and_counted(tmp_path,
                                                       monkeypatch):
    plan = pplacement.PlacementPlan(mesh=[("dp", 4)], strategy="tree",
                                    async_collectives=True)
    path = str(tmp_path / "plan.json")
    pplacement.save_plan(plan, path)
    snap = {}
    _, base, t0 = CT._run_mesh({}, CT._momentum, snap, n=2)
    pobs.enable()
    try:
        before = pobs.counter_value("placement.plan_skipped",
                                    reason="mesh_mismatch")
        _, got, t1 = CT._run_mesh({"PADDLE_TPU_PLACEMENT_PLAN": path},
                                  CT._momentum, snap, n=2)
        # counted at each step's look at the plan, as in the JAX engine
        assert pobs.counter_value("placement.plan_skipped",
                                  reason="mesh_mismatch") > before
    finally:
        pobs.disable()
    assert t1 == t0
    CT._assert_params_equal(base, got)


def test_a_sharded_plan_is_skipped_whole_on_a_topology_it_cannot_run(
        tmp_path, monkeypatch):
    from paddle_tpu_torch.parallel.collectives import \
        maybe_rewrite_collectives

    plan = pplacement.PlacementPlan(mesh=[("dp", 4), ("sp", 2)],
                                    sharded_update=True, strategy="tree",
                                    bucket_mb=0.00001)
    path = str(tmp_path / "plan.json")
    pplacement.save_plan(plan, path)
    monkeypatch.setenv("PADDLE_TPU_PLACEMENT_PLAN", path)
    main, _ = _mlp(fluid)()
    ptranspiler._merge_data_axes(main, ("dp", "sp"))
    ptranspiler.insert_allreduce_ops(main, 8)
    maybe_rewrite_collectives(main, fluid.Scope(), 8, ("dp", "sp"))
    types = [op.type for op in main.global_block().ops]
    assert "c_sharded_update" not in types
    buckets = [op for op in main.global_block().ops
               if op.type == "c_bucket_allreduce"]
    assert len(buckets) == 1
    assert buckets[0].attrs.get("strategy", "ring") == "ring"
    assert getattr(main, "_placement_plan", None) is None


def test_int8_error_feedback_tracks_the_bf16_trajectory():
    snap = {}
    losses = {}
    for tag, env in (("bf16", {"PADDLE_TPU_QUANT_ALLREDUCE": "bf16"}),
                     ("int8ef", {"PADDLE_TPU_QUANT_ALLREDUCE": "int8",
                                 "PADDLE_TPU_QUANT_ERROR_FEEDBACK": "1",
                                 "PADDLE_TPU_REDUCE_STRATEGY": "tree"})):
        losses[tag], _, t = CT._run_mesh(env, CT._momentum, snap, steps=8,
                                         n=8)
        assert t == ["c_bucket_allreduce"]
    assert abs(losses["int8ef"] - losses["bf16"]) < 0.05, losses
