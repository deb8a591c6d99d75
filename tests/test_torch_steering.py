"""The steering half of observability, the port against the JAX package:
the steerer registry, the comparator, the steering daemon, the canary and
its audit trail, and the two in-process steerers (the lazy queue's key cap
and the serving ladder).

Each case is a twin of ``tests/test_steering_runtime.py``'s (its ``ps_*``
cases wait with the parameter server): one scenario runs through each
package's modules from the same inputs, the JAX test's assertions hold in
both, and what the scenario returns (verdicts, the comparator's dicts,
plan digests, the daemon's proposals, the audit entries, the plans) must be
equal between the packages, but for wall-clock stamps. These modules are
pure Python in both packages, so equal means exactly equal.
"""
import json
import types

import pytest

import paddle_tpu.dygraph.lazy as jlazy
import paddle_tpu.serving.batcher as jbatcher
from paddle_tpu import observability as jobs
from paddle_tpu.observability import canary as jcanary
from paddle_tpu.observability import comparator as jcomp
from paddle_tpu.observability import flight as jflight
from paddle_tpu.observability import steering as jsteering
from paddle_tpu.observability import steering_daemon as jsd

import paddle_tpu_torch.dygraph.lazy as plazy
import paddle_tpu_torch.serving.batcher as pbatcher
from paddle_tpu_torch import observability as pobs
from paddle_tpu_torch.observability import canary as pcanary
from paddle_tpu_torch.observability import comparator as pcomp
from paddle_tpu_torch.observability import flight as pflight
from paddle_tpu_torch.observability import steering as psteering
from paddle_tpu_torch.observability import steering_daemon as psd

JAX = types.SimpleNamespace(
    name="jax", obs=jobs, canary=jcanary, comp=jcomp, flight=jflight,
    steering=jsteering, sd=jsd, lazy=jlazy, batcher=jbatcher)
PORT = types.SimpleNamespace(
    name="port", obs=pobs, canary=pcanary, comp=pcomp, flight=pflight,
    steering=psteering, sd=psd, lazy=plazy, batcher=pbatcher)
BOTH = (JAX, PORT)

# wall-clock stamps, which differ between two runs of one scenario
_STAMPS = ("t", "created_at", "t_open", "t_close", "installed_at",
           "measured_at", "path")


def _unstamped(doc):
    if isinstance(doc, dict):
        return {k: _unstamped(v) for k, v in doc.items()
                if k not in _STAMPS}
    if isinstance(doc, (list, tuple)):
        return [_unstamped(v) for v in doc]
    return doc


def both(scenario, *args, **kw):
    """Run ``scenario(pkg, ...)`` through each package; its results must
    be equal. Returns the port's."""
    got = [_unstamped(json.loads(json.dumps(scenario(m, *args, **kw),
                                            default=str)))
           for m in BOTH]
    assert got[1] == got[0]
    return got[1]


@pytest.fixture(autouse=True)
def _clean_obs(monkeypatch):
    for k in ("PADDLE_TPU_SAMPLE_EVERY", "PADDLE_TPU_METRICS_DIR",
              "PADDLE_TPU_TIMESERIES", "PADDLE_TPU_TIMESERIES_WINDOWS",
              "PADDLE_TPU_AB_PAIRS"):
        monkeypatch.delenv(k, raising=False)
    for m in BOTH:
        m.obs.reset()
        m.obs.enable()
        m.flight.clear()
    yield
    for m in BOTH:
        m.obs.reset()
        m.obs.disable()
        m.flight.clear()
        for name in ("t_dup", "t_count", "t_steer", "t_ab"):
            m.steering._STEERERS.pop(name, None)


# -- the steerer registry ----------------------------------------------------------


def test_register_steerer_rejects_bad_args():
    for m in BOTH:
        with pytest.raises(ValueError):
            m.steering.register_steerer("", lambda r: r)
        with pytest.raises(ValueError):
            m.steering.register_steerer("x", "not-callable")


def _reregister(m):
    m.steering.register_steerer("t_dup", lambda r, **c: "v1")
    first = m.steering.steer("t_dup", None)
    m.steering.register_steerer("t_dup", lambda r, **c: "v2")
    assert m.steering.steerers().count("t_dup") == 1
    return [first, m.steering.steer("t_dup", None)]


def test_reregister_replaces_idempotently():
    assert both(_reregister) == ["v1", "v2"]


def test_unknown_steerer_is_a_keyerror_that_lists_the_registered():
    for m in BOTH:
        with pytest.raises(KeyError) as ei:
            m.steering.steer("no_such_steerer_xyz", None)
        assert "no_such_steerer_xyz" in str(ei.value)
        assert "have:" in str(ei.value)


def _count(m):
    m.steering.register_steerer("t_count", lambda r, **c: None)
    m.steering.steer("t_count", None)
    m.steering.steer("t_count", None)
    return m.obs.counter_value("steering.plans", steerer="t_count")


def test_steer_counts_dispatches():
    assert both(_count) == 2


def test_the_built_in_steerers_register_under_the_jax_names():
    import paddle_tpu.parallel.collectives  # noqa: F401
    import paddle_tpu.placement.search  # noqa: F401
    import paddle_tpu_torch.parallel.collectives  # noqa: F401
    import paddle_tpu_torch.placement.search  # noqa: F401

    names = {"bucket_layout", "placement", "lazy_policy", "serving_ladder"}
    assert names <= set(jsteering.steerers())
    assert names <= set(psteering.steerers())
    assert psteering.__all__ == jsteering.__all__
    assert psteering.REPORT_FIELDS == jsteering.REPORT_FIELDS


def _coerce(m):
    good = {"per_bucket": [], "backward_segments": []}
    return [m.steering.coerce_report(doc) for doc in (
        None, "nope", {}, {"per_bucket": []}, good, {"profile": good})]


def test_coerce_report_stale_and_garbage():
    good = {"per_bucket": [], "backward_segments": []}
    assert both(_coerce) == [None, None, None, None, good, good]


def test_load_report_never_raises(tmp_path, monkeypatch):
    bad = tmp_path / "garbage.json"
    bad.write_text("{not json")
    rec = tmp_path / "record.json"
    rec.write_text(json.dumps({"profile": {"per_bucket": [1],
                                           "backward_segments": []}}))
    monkeypatch.delenv("PADDLE_TPU_BUCKET_PROFILE", raising=False)
    got = both(lambda m: [m.steering.load_report(p) for p in (
        str(tmp_path / "missing.json"), str(bad), str(rec), None)])
    assert got == [None, None, {"per_bucket": [1],
                                "backward_segments": []}, None]


def _digests(m):
    class WithDigest:
        digest = "feedbeef"

    d = m.steering.plan_digest
    assert d((1, 2, 4)) == d([1, 2, 4])
    assert d({"a": 1, "b": 2}) == d({"b": 2, "a": 1})
    assert d((1, 2)) != d((1, 3))
    return [d((1, 2, 4)), d({"a": 1, "b": [2.5, None]}),
            d(WithDigest()), m.steering.plan_jsonable((3, 4))]


def test_plan_digest_stable_and_shape_agnostic():
    got = both(_digests)
    assert got[2] == "feedbeef" and got[3] == [3, 4]


# -- the comparator -------------------------------------------------------------------


def _rec(**metrics):
    return {"extras": {"wl": dict(metrics)}}


def test_comparator_tables_are_the_jax_package_s():
    assert pcomp.WATCHED == jcomp.WATCHED
    assert pcomp.ABS_NOISE_FLOOR == jcomp.ABS_NOISE_FLOOR
    assert pcomp.COUNTER_WATCH_GROWS_BAD == jcomp.COUNTER_WATCH_GROWS_BAD
    assert pcomp.__all__ == jcomp.__all__


_COMPARISONS = {
    "ok": (_rec(tokens_per_sec=100.0), _rec(tokens_per_sec=99.0)),
    "regression": (_rec(tokens_per_sec=100.0), _rec(tokens_per_sec=80.0)),
    "no_overlap": ({}, {}),
    "noise_floor": (_rec(step_ms=0.5), _rec(step_ms=1.25)),
    "zero_base": (_rec(tokens_per_sec=0.0), _rec(tokens_per_sec=5.0)),
    "counter_growth": (
        {"counters_total": {"executor.compile_fallbacks": 0},
         "extras": {"wl": {"tokens_per_sec": 100.0}}},
        {"counters_total": {"executor.compile_fallbacks": 3},
         "extras": {"wl": {"tokens_per_sec": 100.0}}}),
    "plan_digest_change": (
        {"extras": {"wl": {"step_ms": 10.0,
                           "placement": {"plan_digest": "a" * 40}}}},
        {"extras": {"wl": {"step_ms": 10.0,
                           "placement": {"plan_digest": "b" * 40}}}}),
    "multichip": ({"configs": {"mlp": {"step_ms": 10.0,
                                       "profile": {"mfu_est": 0.5}}}},
                  {"configs": {"mlp": {"step_ms": 30.0,
                                       "profile": {"mfu_est": 0.2}}}}),
}
_WANT_VERDICT = {"ok": "ok", "regression": "regression",
                 "no_overlap": "no_overlap", "noise_floor": "ok",
                 "zero_base": "ok", "counter_growth": "regression",
                 "plan_digest_change": "regression",
                 "multichip": "regression"}


@pytest.mark.parametrize("case", sorted(_COMPARISONS))
def test_compare_gives_the_jax_package_s_dict(case):
    base, head = _COMPARISONS[case]
    doc = both(lambda m: m.comp.compare(base, head).to_dict())
    assert doc["verdict"] == _WANT_VERDICT[case]
    json.dumps(doc)  # JSON-safe: a zero base's rel is "inf"
    if case == "zero_base":
        assert "inf" in [r["rel"] for r in doc["rows"]]


def _improvement(m):
    c = m.comp.compare(_rec(tokens_per_sec=100.0, step_ms=10.0),
                       _rec(tokens_per_sec=150.0, step_ms=5.0))
    return [c.improvement("tokens_per_sec"), c.improvement("step_ms"),
            c.improvement("never_measured"), c.regressed_metrics]


def test_compare_improvement_direction_aware():
    assert both(_improvement) == [pytest.approx(0.5), pytest.approx(0.5),
                                  None, []]


def test_load_and_record_shapes(tmp_path):
    p = tmp_path / "rec.json"
    p.write_text(json.dumps({"parsed": {"extras": {"a": {"x": 1},
                                                   "b_error": {}}}}))
    got = both(lambda m: [m.comp.workloads(m.comp.load(str(p))),
                          m.comp.counter_totals({"totals": {"c": 2}}),
                          m.comp.counter_totals(
                              {"metrics_totals": {"d": 3}})])
    assert got == [{"a": {"x": 1}}, {"c": 2}, {"d": 3}]


# -- objectives ------------------------------------------------------------------------


def test_objective_validates():
    for m in BOTH:
        O = m.comp.Objective
        with pytest.raises(ValueError):
            O({})
        with pytest.raises(ValueError):
            O({"step_ms": 0.0})
        with pytest.raises(ValueError, match="conflict"):
            O({"step_ms": 1.0}, directions={"step_ms": +1})
        with pytest.raises(ValueError, match="direction"):
            O({"my_custom": 1.0})
        with pytest.raises(ValueError):
            O({"my_custom": 1.0}, directions={"my_custom": 2})


_OBJECTIVES = {
    "relative_weights": (
        _rec(tokens_per_sec=100.0, step_ms=10.0),
        _rec(tokens_per_sec=150.0, step_ms=20.0),
        {"weights": {"tokens_per_sec": 2.0, "step_ms": 2.0}}),
    "missing_metric": (_rec(tokens_per_sec=100.0),
                       _rec(tokens_per_sec=150.0),
                       {"weights": {"tokens_per_sec": 1.0,
                                    "mfu_est": 1.0}}),
    "noise_floor": (_rec(step_ms=10.0), _rec(step_ms=11.0),
                    {"weights": {"step_ms": 1.0}}),
    "bounded_regression": (
        _rec(rows_per_s=1000.0, serving_padding_waste_frac=0.10),
        _rec(rows_per_s=1500.0, serving_padding_waste_frac=0.30),
        {"weights": {"rows_per_s": 5.0,
                     "serving_padding_waste_frac": 1.0}}),
    "hard_floor": (_rec(rows_per_s=1000.0, p50_ms=10.0),
                   _rec(rows_per_s=2000.0, p50_ms=16.0),
                   {"weights": {"rows_per_s": 1.0},
                    "hard_floors": {"p50_ms": 15.0}}),
    "counter_regression": (
        {"counters_total": {"executor.compile_fallbacks": 0},
         "extras": {"wl": {"rows_per_s": 1000.0}}},
        {"counters_total": {"executor.compile_fallbacks": 3},
         "extras": {"wl": {"rows_per_s": 2000.0}}},
        {"weights": {"rows_per_s": 1.0}}),
}
_WANT_OBJECTIVE = {"relative_weights": ("objective_regression", -0.25),
                   "missing_metric": ("objective_improved", 0.25),
                   "noise_floor": ("objective_regression", 0.0),
                   "bounded_regression": ("objective_improved",
                                          5.0 / 12 - 1.0 / 3),
                   "hard_floor": ("hard_floor", 1.0),
                   "counter_regression": ("counter_regression", 1.0)}


@pytest.mark.parametrize("case", sorted(_OBJECTIVES))
def test_objective_scores_as_the_jax_package(case):
    base, head, cfg = _OBJECTIVES[case]

    def run(m):
        ob = m.comp.Objective.from_dict(cfg)
        c = m.comp.compare(base, head, objective=ob)
        assert m.comp.Objective.from_dict(ob.to_dict()).to_dict() == \
            ob.to_dict()
        return [c.verdict, c.objective_score, c.to_dict()]

    verdict, score, _ = both(run)
    want_verdict, want_score = _WANT_OBJECTIVE[case]
    assert verdict == want_verdict
    assert score == pytest.approx(want_score)


def test_default_compare_dict_has_no_objective_block():
    doc = both(lambda m: m.comp.compare(_rec(tokens_per_sec=100.0),
                                        _rec(tokens_per_sec=100.0)
                                        ).to_dict())
    assert "objective" not in doc


# -- the steering daemon ---------------------------------------------------------------


def _daemon(m, tmp_path, rule=None, **kw):
    kw.setdefault("merge", False)
    kw.setdefault("hysteresis", 2)
    kw.setdefault("cooldown", 2)
    rule = rule or m.sd.WatchRule(
        "waste", m.sd.counter_ratio("serving.padding_waste",
                                    "serving.batches", min_den=8),
        direction=-1, threshold=0.25, floor=0.10, steerer="t_steer")
    return m.sd.SteeringDaemon(str(tmp_path), rules=[rule], **kw)


def _metrics(tmp_path, ratio, batches=100):
    doc = {"counters_total": {"serving.batches": batches,
                              "serving.padding_waste": ratio * batches}}
    (tmp_path / "metrics.json").write_text(json.dumps(doc))


def _poll_sequence(m, tmp_path, ratios, steerer=lambda r, **c: [1, 2],
                   **kw):
    d = tmp_path / m.name
    d.mkdir()
    m.steering.register_steerer("t_steer", steerer)
    daemon = _daemon(m, d, **kw)
    props = []
    for ratio in ratios:
        if ratio is not None:
            _metrics(d, ratio)
        props.append(daemon.poll_once())
    return props, daemon


def test_daemon_oscillation_never_triggers(tmp_path):
    props = both(lambda m: _poll_sequence(
        m, tmp_path, [0.2] + [0.6, 0.2] * 6)[0])
    assert all(p == [] for p in props)


def test_daemon_sustained_breach_proposes_once_then_cooldown(tmp_path):
    def run(m):
        props, _ = _poll_sequence(m, tmp_path, [0.2, 0.6] + [0.6] * 6)
        assert (tmp_path / m.name / "proposed-t_steer.json").exists()
        return props

    props = both(run)
    assert props[0] == [] and props[1] == []
    fired = [p for ps in props for p in ps]
    assert len(fired) == 1
    assert fired[0]["steerer"] == "t_steer"
    assert fired[0]["plan_digest"] == psteering.plan_digest([1, 2])


def test_daemon_missing_metric_and_doc_skip(tmp_path):
    def run(m):
        d = tmp_path / m.name
        d.mkdir()
        m.steering.register_steerer("t_steer", lambda r, **c: [1])
        daemon = _daemon(m, d)
        out = [daemon.poll_once()]
        _metrics(d, 0.9, batches=2)
        out.append(daemon.poll_once())
        return out + [daemon._state["waste"]["baseline"]]

    assert both(run) == [[], [], None]


def test_daemon_broken_steerer_is_flight_recorded(tmp_path):
    def boom(report, **ctx):
        raise RuntimeError("planner exploded")

    def run(m):
        props, _ = _poll_sequence(m, tmp_path, [0.2, 0.6, 0.6, 0.6],
                                  steerer=boom)
        assert m.obs.counter_value("steering.propose_errors",
                                   steerer="t_steer") >= 1
        kinds = [k for _, k, _ in m.flight.events()]
        assert "steering.propose_error" in kinds
        return props

    assert all(p == [] for p in both(run))


def test_watchrule_validates_and_the_default_rules_match():
    for m in BOTH:
        with pytest.raises(ValueError):
            m.sd.WatchRule("x", lambda d: 0, direction=2, threshold=0.1,
                           steerer="s")
        with pytest.raises(ValueError):
            m.sd.WatchRule("x", lambda d: 0, direction=1, threshold=0.0,
                           steerer="s")
    got = both(lambda m: [(r.name, r.steerer, r.direction, r.threshold,
                           r.floor) for r in m.sd.default_rules()])
    assert {r[0]: r[1] for r in got} == {
        "serving_padding_waste": "serving_ladder",
        "lazy_recompile_frac": "lazy_policy",
        "placement_agreement": "placement"}
    assert psd.__all__ == jsd.__all__


def test_watchrule_objective_rides_the_proposal(tmp_path):
    def run(m):
        ob = m.comp.Objective({"rows_per_s": 2.0,
                               "serving_padding_waste_frac": 1.0})
        rule = m.sd.WatchRule(
            "waste", m.sd.counter_ratio("serving.padding_waste",
                                        "serving.batches", min_den=8),
            direction=-1, threshold=0.25, floor=0.10, steerer="t_steer",
            objective=ob, ab_pairs=4)
        props, _ = _poll_sequence(m, tmp_path, [0.2, 0.6, 0.6, 0.6],
                                  rule=rule)
        fired = [p for ps in props for p in ps]
        assert len(fired) == 1 and fired[0]["ab_pairs"] == 4
        assert m.comp.Objective.from_dict(
            fired[0]["objective"]).to_dict() == ob.to_dict()
        return fired

    both(run)


_WINDOW_DOCS = [
    {"counters_total": {"serving.padding_waste": 50.0,
                        "serving.batches": 100.0}},
    {"counters_total": {"serving.padding_waste": 50.0,
                        "serving.batches": 100.0},
     "series_windows": {
         "serving.padding_waste": {"kind": "counter", "delta": 30.0},
         "serving.batches": {"kind": "counter", "delta": 50.0}}},
    {"counters_total": {"serving.padding_waste": 50.0,
                        "serving.batches": 100.0},
     "series_windows": {
         "serving.padding_waste": {"kind": "counter", "delta": 1.0},
         "serving.batches": {"kind": "counter", "delta": 2.0}}},
    {"counters_total": {"lazy.recompiles": 30, "lazy.cache_hits": 10}},
    {"sampled_profile_drift": {"step_ms": {"spread": 2.5}}},
]


def test_extractors_read_as_the_jax_package():
    def run(m):
        fns = [m.sd.windowed_counter_ratio("serving.padding_waste",
                                           "serving.batches", min_den=8),
               m.sd.counter_ratio("serving.padding_waste",
                                  "serving.batches"),
               m.sd.counter_value("lazy.recompiles"),
               m.sd.recompile_frac(), m.sd.drift_value("step_ms")]
        return [[f(doc) for f in fns] for doc in _WINDOW_DOCS]

    got = both(run)
    assert got[0][0] == pytest.approx(0.5)
    assert got[1][0] == pytest.approx(0.6)
    assert got[2][0] == pytest.approx(0.5)
    assert got[3][3] == pytest.approx(0.75)
    assert got[4][4] == 2.5


def test_placement_agreement_reads_the_active_plan(tmp_path):
    plan = tmp_path / "plan.json"
    plan.write_text(json.dumps({"predicted_step_ms": 10.0}))
    doc = {"sampled_profiles": {
        "trainer-0": {"profile": {"step_ms": 12.0}},
        "trainer-1": {"profile": {"step_ms": 13.0}}}}
    got = both(lambda m: [m.sd.placement_agreement_value(str(plan))(doc),
                          m.sd.placement_agreement_value(
                              str(tmp_path / "none.json"))(doc)])
    assert got == [pytest.approx(0.8), None]


# -- the canary and its audit trail -----------------------------------------------------


def _measure(waste):
    return {"extras": {"serving": {
        "serving_padding_waste_frac": waste,
        "rows_per_s": 1000.0 * (1.0 - waste)}}}


def test_canary_promote_and_rollback_audited(tmp_path):
    def run(m):
        d = str(tmp_path / m.name)
        (tmp_path / m.name).mkdir()
        audit = m.canary.AuditTrail(d)
        store = m.canary.PlanStore(d, "t_steer")
        incumbent = _measure(0.5)
        bad = m.canary.run_canary(
            {"plan": [16], "steerer": "t_steer"}, incumbent,
            lambda plan: _measure(0.9), plan_store=store, audit=audit)
        assert bad.decision == "rolled_back" and store.installs == 0
        good = m.canary.run_canary(
            {"plan": [2, 4, 16], "steerer": "t_steer"}, incumbent,
            lambda plan: _measure(0.1), plan_store=store, audit=audit,
            require_improvement="serving_padding_waste_frac")
        assert good.decision == "promoted" and store.installs == 1
        entries = audit.entries()
        assert [e["seq"] for e in entries] == [0, 1]
        assert store.active_digest() == good.plan_digest
        assert store.read()["audit_seq"] == 1
        fl = {k: f for _, k, f in m.flight.events()
              if k.startswith("canary.")}
        assert fl["canary.rolled_back"]["plan_digest"] == bad.plan_digest
        assert fl["canary.promoted"]["plan_digest"] == good.plan_digest
        return [entries, store.read(), repr(good)]

    entries, active, _ = both(run)
    assert [e["decision"] for e in entries] == ["rolled_back", "promoted"]
    assert active["schema"] == "active_plan_v1"


def test_canary_no_improvement_no_overlap_and_unaudited_refusals(tmp_path):
    def run(m):
        d = str(tmp_path / m.name)
        (tmp_path / m.name).mkdir()
        dec = m.canary.run_canary(
            {"plan": [8], "steerer": "t"}, _measure(0.5),
            lambda plan: _measure(0.49), audit=m.canary.AuditTrail(d),
            require_improvement="serving_padding_waste_frac",
            min_improvement=0.05)
        blind = m.canary.run_canary({"plan": [8]}, {}, lambda plan: {})
        store = m.canary.PlanStore(d, "t")
        with pytest.raises(ValueError):
            store.install([1, 2], {"decision": "rolled_back"})
        with pytest.raises(ValueError):
            store.install([1, 2], {"decision": "promoted",
                                   "plan_digest": "wrong"})
        with pytest.raises(ValueError):
            m.canary.run_canary({"plan": [8]}, _measure(0.5),
                                lambda plan: _measure(0.1),
                                plan_store=store, audit=None)
        assert store.installs == 0 and store.read() is None
        return [dec.promoted, dec.reason, blind.promoted, blind.reason]

    assert both(run) == [False, "no_improvement:serving_padding_waste_frac",
                         False, "no_overlap"]


def test_audit_trail_survives_garbage_file(tmp_path):
    def run(m):
        d = tmp_path / m.name
        d.mkdir()
        (d / "steering_audit.json").write_text("{torn write")
        audit = m.canary.AuditTrail(str(d))
        assert audit.entries() == []
        e = audit.append({"decision": "promoted", "plan_digest": "d"})
        return [e["seq"], audit.entries()]

    seq, entries = both(run)
    assert seq == 0 and entries[0]["decision"] == "promoted"
    assert pcanary.__all__ == jcanary.__all__


_AB_OBJECTIVE = {"weights": {"rows_per_s": 1.0,
                             "serving_padding_waste_frac": 1.0},
                 "floors": {"serving_padding_waste_frac": 0.02}}


def _drifting_measure(incumbent_waste, candidate_waste, drift):
    """A window's measure whose throughput grows by ``drift`` a window
    whatever the plan: the confounder the interleaving cancels."""
    clock = {"n": 0}

    def measure(plan):
        rec = _measure(incumbent_waste if plan is None else candidate_waste)
        rec["extras"]["serving"]["rows_per_s"] *= (1.0 + drift) ** clock["n"]
        clock["n"] += 1
        return rec
    return measure, clock


def test_ab_canary_rejects_a_drift_masked_regression(tmp_path):
    proposal = {"plan": [5, 16], "steerer": "t_ab",
                "objective": dict(_AB_OBJECTIVE), "ab_pairs": 3}

    def run(m):
        measure, clock = _drifting_measure(0.2, 0.3, 0.10)
        stale = measure(None)
        clock["n"] += 5
        flat = m.canary.run_canary({"plan": [5, 16], "steerer": "t_ab"},
                                   stale, measure)
        assert flat.promoted and flat.reason == "ok"
        measure, _ = _drifting_measure(0.2, 0.3, 0.10)
        (tmp_path / m.name).mkdir()
        audit = m.canary.AuditTrail(str(tmp_path / m.name))
        dec = m.canary.run_ab_canary(proposal, measure, audit=audit)
        assert not dec.promoted and dec.reason == "ab_majority:0/3"
        entry = audit.entries()[-1]
        assert m.obs.counter_value("canary.windows", phase="candidate",
                                   steerer="t_ab") == 3
        assert m.obs.gauge_value("steering.objective_score",
                                 steerer="t_ab") == \
            pytest.approx(entry["objective_score"])
        return entry

    entry = both(run)
    assert entry["protocol"] == "ab_interleaved"
    assert [w["phase"] for w in entry["windows"]] == \
        ["incumbent", "candidate"] * 3
    assert entry["objective_score"] < 0
    assert all(pd["verdict"] == "objective_regression"
               for pd in entry["pair_verdicts"])


def test_ab_canary_promotes_and_installs(tmp_path):
    def run(m):
        measure, _ = _drifting_measure(0.2, 0.05, 0.0)
        d = str(tmp_path / m.name)
        (tmp_path / m.name).mkdir()
        audit = m.canary.AuditTrail(d)
        store = m.canary.PlanStore(d, "t_ab")
        calls = []
        dec = m.canary.run_ab_canary(
            {"plan": [2, 4, 16], "steerer": "t_ab",
             "objective": dict(_AB_OBJECTIVE)},
            measure, pairs=2, apply_fn=lambda p: calls.append("apply"),
            revert_fn=lambda p: calls.append("revert"),
            promote_fn=lambda p: calls.append("promote"),
            plan_store=store, audit=audit)
        assert dec.promoted and dec.reason == "ab_majority:2/2"
        assert calls == ["revert", "apply"] * 2 + ["promote"]
        assert store.active_digest() == dec.plan_digest
        fl = {k: f for _, k, f in m.flight.events()
              if k == "canary.promoted"}
        assert fl["canary.promoted"]["ok_pairs"] == 2
        return audit.entries()[-1]

    assert both(run)["objective_score"] > 0


def test_ab_canary_hard_floor_and_min_score(tmp_path):
    def run(m):
        def measure(plan):
            rec = _measure(0.05 if plan is not None else 0.2)
            rec["extras"]["serving"]["p50_ms"] = \
                16.0 if plan is not None else 10.0
            return rec
        ob = m.comp.Objective({"rows_per_s": 1.0},
                              hard_floors={"p50_ms": 15.0})
        vetoed = m.canary.run_ab_canary({"plan": [8], "steerer": "t_ab"},
                                        measure, pairs=3, objective=ob)
        measure2, _ = _drifting_measure(0.2, 0.05, 0.0)
        demoted = m.canary.run_ab_canary(
            {"plan": [2, 16], "steerer": "t_ab",
             "objective": dict(_AB_OBJECTIVE)},
            measure2, pairs=3, min_score=10.0)
        return [vetoed.reason, demoted.reason, vetoed.promoted,
                demoted.promoted]

    assert both(run) == ["ab_hard_floor", "ab_no_objective_improvement",
                         False, False]


def test_ab_pairs_resolution(monkeypatch):
    def run(m):
        out = [m.canary._ab_pairs_default()]
        for raw in ("5", "bogus", "-3"):
            monkeypatch.setenv(m.canary.AB_PAIRS_ENV, raw)
            out.append(m.canary._ab_pairs_default())
        monkeypatch.delenv(m.canary.AB_PAIRS_ENV)
        return out

    assert both(run) == [3, 5, 3, 1]


# -- the two in-process steerers ----------------------------------------------------------


def test_plan_ladder_quantile_rungs_and_steerer():
    def run(m):
        rows = [3] * 60 + [13] * 40
        ladder = m.batcher.plan_ladder(16, rows)
        assert ladder[-1] == 16 and 3 in ladder and 13 in ladder
        assert m.batcher.plan_ladder(16, []) == \
            m.batcher.default_ladder(16)
        with pytest.raises(ValueError):
            m.batcher.plan_ladder(0, rows)
        with pytest.raises(ValueError):
            m.steering.steer("serving_ladder", None)
        bursty = [1 + (i * 7) % 3 for i in range(64)]
        return [ladder, m.steering.steer("serving_ladder", None,
                                         max_batch_size=8,
                                         batch_rows=[2, 2, 5]),
                m.batcher.plan_ladder(8, bursty),
                m.batcher.plan_ladder(64, list(range(1, 65)), max_rungs=3)]

    got = both(run)
    assert got[1][-1] == 8


def test_lazy_policy_plan_and_apply():
    def run(m):
        plans = [m.lazy.plan_lazy_policy(recompiles=r, cache_hits=h,
                                         cache_cap=c)
                 for r, h, c in ((100, 10, 64), (5, 100, 64),
                                 (10000, 0, m.lazy.JIT_CACHE_CAP_MAX),
                                 (0, 0, 4), (9, 1, 4))]

        class FakeEngine:
            JIT_CACHE_CAP = 64
        got = m.lazy.apply_lazy_policy({"jit_cache_cap": 128},
                                       engine_cls=FakeEngine)
        assert got == 128 and FakeEngine.JIT_CACHE_CAP == 128
        with pytest.raises(ValueError):
            m.lazy.apply_lazy_policy({"jit_cache_cap": 0},
                                     engine_cls=FakeEngine)
        plans.append(m.steering.steer("lazy_policy", None, recompiles=8,
                                      cache_hits=0, cache_cap=4))
        return plans

    plans = both(run)
    assert [p["jit_cache_cap"] for p in plans] == [128, 64, 512, 4, 8, 8]
    assert plazy.JIT_CACHE_CAP_MAX == jlazy.JIT_CACHE_CAP_MAX


def test_lazy_policy_reads_the_port_s_own_counters(monkeypatch):
    """Without counts in the context the port's steerer reads the lazy
    queue's ``counters()`` (the JAX one reads its registry), and a dump
    carries them: each also goes to the observability registry."""
    monkeypatch.setitem(plazy.COUNTERS, "lazy.recompiles", 9)
    monkeypatch.setitem(plazy.COUNTERS, "lazy.cache_hits", 1)
    plan = psteering.steer("lazy_policy", None, cache_cap=4)
    assert plan["jit_cache_cap"] == 8 and plan["recompiles"] == 9
    before = pobs.counter_value("lazy.flushes")
    plazy._inc("lazy.flushes")
    assert pobs.counter_value("lazy.flushes") == before + 1
