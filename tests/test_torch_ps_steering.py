"""The PS hot-shard steerer of ``paddle_tpu_torch``
(``observability/ps_steering.py``), case for case against
``tests/test_steering_runtime.py``'s PS cases: the per-shard apply timing
a server records, the apply-time and row-touch skew extractors, the
``ps_migrate_range`` plan from a merged document (by apply time and by
row heat), its refusals, the daemon's proposal, the canary applying it,
and the rules. The plans are the JAX package's own on the same documents,
and the port's steering daemon registers the steerer.
"""
import json
import socket

import numpy as np
import pytest
import torch

from paddle_tpu_torch import observability as obs
from paddle_tpu_torch.observability import canary as canary_mod
from paddle_tpu_torch.observability import flight
from paddle_tpu_torch.observability import ps_steering
from paddle_tpu_torch.observability import steering
from paddle_tpu_torch.observability import steering_daemon as sd_mod


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_ps_apply_ms_labeled_by_shard():
    from paddle_tpu_torch.distributed.ps_rpc import PSClient, PSServer

    class MiniScope(dict):
        def local_var_names(self):
            return list(self)

    class MiniExec:
        device = "cpu"

        def _read_var(self, scope, name):
            return scope.get(name)

        def _write_var(self, scope, name, val):
            scope[name] = val

        def run_block(self, block, scope):
            block(scope)

    scope = MiniScope()
    scope["w"] = torch.zeros(4)
    before = obs.histogram("ps.apply_ms", shard="0",
                           table="_round").count
    server = PSServer(
        "127.0.0.1:%d" % _free_port(), MiniExec(), scope,
        {"w@GRAD": lambda sc: sc.__setitem__(
            "w", sc["w"] - 0.1 * sc["w@GRAD"])}, fanin=1)
    server.start_background()
    c = PSClient(server._own_endpoint, trainer_id=0)
    try:
        c.send_grad("w@GRAD", np.ones(4, np.float32))
        c.send_barrier()
        c.get_param("w")
        c.fetch_barrier()
    finally:
        c.close()
        server.stop()
    assert obs.histogram("ps.apply_ms", shard="0",
                         table="_round").count == before + 1
    # the dense block apply also lands a per-TABLE series — the hot
    # table name the steerer keys on, not just the hot group
    assert obs.histogram("ps.apply_ms", shard="0",
                         table="w").count >= 1


# -- the hot-shard steerer ---------------------------------------------------


def _hist(mean, n=8):
    return {"count": n, "sum": mean * n, "min": mean, "max": mean,
            "mean": mean, "p50": mean, "p90": mean, "p99": mean}


def _ps_doc(hot_ms=40.0, cold_ms=10.0, height=16):
    """A merged metrics.json shaped like a 2-shard PS where shard 1
    runs hot on table 'emb'. The server buckets heat over its OWN
    slice, so shard 1's buckets 6-7 (of its span [8, 16), one row per
    bucket) are global rows [14, 16) — the hot tail the plan should
    move."""
    heat = {}
    for b in range(8):
        heat["ps.row_heat{bucket=%d,shard=1,table=emb}" % b] = \
            50 if b >= 6 else 1
        heat["ps.row_heat{bucket=%d,shard=0,table=emb}" % b] = 2
    return {
        "processes": {
            "pserver-0": {"metrics": {"histograms": {
                "ps.apply_ms{shard=0,table=_round}": _hist(cold_ms),
                "ps.apply_ms{shard=0,table=emb}": _hist(cold_ms),
            }, "gauges": {
                "ps.table_rows{shard=0,table=emb}": height,
            }}},
            "pserver-2": {"metrics": {"histograms": {
                "ps.apply_ms{shard=1,table=_round}": _hist(hot_ms),
                "ps.apply_ms{shard=1,table=emb}": _hist(hot_ms),
            }, "gauges": {
                "ps.table_rows{shard=1,table=emb}": height,
            }}},
        },
        "counters_total": heat,
    }


def test_ps_apply_skew_extractor():
    v = ps_steering.apply_skew_value()
    assert v(_ps_doc(hot_ms=40.0, cold_ms=10.0)) == pytest.approx(4.0)
    assert v(_ps_doc(hot_ms=10.0, cold_ms=10.0)) == pytest.approx(1.0)
    # one shard only: no skew is computable
    doc = _ps_doc()
    del doc["processes"]["pserver-2"]
    assert v(doc) is None
    # below the count floor: noise, not signal
    assert ps_steering.apply_skew_value(min_count=64)(_ps_doc()) is None
    assert v({}) is None


def test_ps_migrate_range_steerer_plan():
    assert ps_steering.STEERER_NAME in steering.steerers()
    plan = steering.steer(ps_steering.STEERER_NAME, None,
                          doc=_ps_doc(), height=16, nshards=2)
    assert plan["kind"] == "migrate_range"
    assert plan["table"] == "emb"
    assert plan["from_shard"] == 1 and plan["to_shard"] == 0
    # the hot side of shard 1's span [8, 16): heat sits in the span's
    # buckets 6-7 = global [14, 16), so that tail moves
    assert (plan["lo"], plan["hi"]) == (14, 16)
    assert plan["skew"] == pytest.approx(4.0)
    # plan digests are stable (the audit-chain identity)
    assert steering.plan_digest(plan) == steering.plan_digest(
        steering.steer(ps_steering.STEERER_NAME, None,
                       doc=_ps_doc(), height=16, nshards=2))


def test_ps_steerer_refuses_without_telemetry():
    with pytest.raises(ValueError):
        ps_steering.propose_migrate_range(doc={})
    with pytest.raises(ValueError):
        ps_steering.propose_migrate_range(doc=None, metrics_dir="")
    # skewless telemetry is a refusal, not a no-op plan
    with pytest.raises(ValueError):
        ps_steering.propose_migrate_range(
            doc=_ps_doc(hot_ms=10.0, cold_ms=10.0))


def test_ps_steering_daemon_proposes_migrate_range(tmp_path):
    rule = ps_steering.hot_shard_rule(threshold=0.5, floor=0.25)
    d = sd_mod.SteeringDaemon(
        str(tmp_path), rules=[rule], hysteresis=2, cooldown=2,
        merge=False,
        context={ps_steering.STEERER_NAME: {
            "metrics_dir": str(tmp_path), "height": 16, "nshards": 2}})
    (tmp_path / "metrics.json").write_text(
        json.dumps(_ps_doc(hot_ms=12.0, cold_ms=10.0)))
    assert d.poll_once() == []          # baseline (skew 1.2)
    (tmp_path / "metrics.json").write_text(
        json.dumps(_ps_doc(hot_ms=40.0, cold_ms=10.0)))
    assert d.poll_once() == []          # breach 1 of 2
    props = d.poll_once()               # breach 2: propose
    assert len(props) == 1
    art = props[0]
    assert art["steerer"] == ps_steering.STEERER_NAME
    assert art["plan"]["kind"] == "migrate_range"
    assert art["plan"]["table"] == "emb"
    path = tmp_path / ("proposed-%s.json" % ps_steering.STEERER_NAME)
    assert path.exists()
    on_disk = json.loads(path.read_text())
    assert on_disk["plan_digest"] == art["plan_digest"]
    kinds = [k for _, k, _ in flight.events()]
    assert "steering.proposed" in kinds


def test_ps_migrate_range_canary_applies_through_protocol(tmp_path):
    """The canary wiring the drill uses: apply_fn IS the live
    migration call; promotion installs through the PlanStore, and an
    injected regression rolls back without installing."""
    plan = steering.steer(ps_steering.STEERER_NAME, None,
                          doc=_ps_doc(), height=16, nshards=2)
    proposal = {"plan": plan,
                "plan_digest": steering.plan_digest(plan),
                "steerer": ps_steering.STEERER_NAME}
    applied = []
    store = canary_mod.PlanStore(str(tmp_path),
                                 ps_steering.STEERER_NAME)
    audit = canary_mod.AuditTrail(str(tmp_path))
    incumbent = {"configs": {"ps_rebalance": {"rounds_per_s": 50.0}}}

    dec = canary_mod.run_canary(
        proposal, incumbent,
        measure=lambda p: {"configs": {
            "ps_rebalance": {"rounds_per_s": 60.0}}},
        apply_fn=lambda p: applied.append(
            (p["table"], p["lo"], p["hi"], p["to_shard"])),
        plan_store=store, audit=audit)
    assert dec.promoted and applied == [("emb", 14, 16, 0)]
    assert store.active_digest() == proposal["plan_digest"]
    assert audit.entries()[-1]["decision"] == "promoted"
    assert audit.entries()[-1]["plan_digest"] == dec.plan_digest

    rolled = []
    dec2 = canary_mod.run_canary(
        proposal, incumbent,
        measure=lambda p: {"configs": {
            "ps_rebalance": {"rounds_per_s": 20.0}}},
        apply_fn=lambda p: applied.append("again"),
        rollback_fn=lambda p: rolled.append(p["table"]),
        plan_store=store, audit=audit)
    assert not dec2.promoted and rolled == ["emb"]
    assert audit.entries()[-1]["decision"] == "rolled_back"
    # the rollback never touched the active-plan pointer
    assert store.active_digest() == proposal["plan_digest"]


def test_ps_row_load_extractor():
    doc = _ps_doc()
    # shard 1: 6*1 + 2*50 = 106 touches; shard 0: 8*2 = 16
    load = ps_steering.shard_row_load(doc)
    assert load == {0: 16.0, 1: 106.0}
    v = ps_steering.row_load_skew_value()
    assert v(doc) == pytest.approx(106.0 / 16.0)
    # counters, not timings: the same doc always yields the same skew
    assert v(doc) == v(json.loads(json.dumps(doc)))
    # one shard's census alone is no signal
    solo = _ps_doc()
    solo["counters_total"] = {
        k: n for k, n in solo["counters_total"].items()
        if "shard=1" in k}
    assert v(solo) is None
    # below the per-shard touch floor: noise
    assert ps_steering.row_load_skew_value(min_rows=32)(doc) is None
    assert v({}) is None


def test_ps_migrate_range_by_row_heat():
    """The drill's deterministic path: hot shard from row counters,
    same span-local split as the wall-time path."""
    plan = steering.steer(ps_steering.STEERER_NAME, None,
                          doc=_ps_doc(), height=16, nshards=2,
                          by="row_heat")
    assert plan["by"] == "row_heat"
    assert plan["table"] == "emb"
    assert plan["from_shard"] == 1 and plan["to_shard"] == 0
    assert (plan["lo"], plan["hi"]) == (14, 16)
    assert plan["skew"] == pytest.approx(round(106.0 / 16.0, 4))
    with pytest.raises(ValueError):
        ps_steering.propose_migrate_range(doc=_ps_doc(), height=16,
                                          nshards=2, by="bogus")


def test_ps_row_load_rule_wiring():
    rule = ps_steering.row_load_rule(threshold=0.5, floor=0.25)
    assert rule.name == "ps_row_load_skew"
    assert rule.steerer == ps_steering.STEERER_NAME
    assert rule.direction == -1
    assert rule.value_fn(_ps_doc()) == pytest.approx(106.0 / 16.0)


def test_ps_plans_are_the_jax_package_s():
    """The same merged documents give the JAX package's plans, skews and
    loads, bit for bit."""
    from paddle_tpu.observability import ps_steering as jps

    docs = [_ps_doc(), _ps_doc(hot_ms=25.0, cold_ms=5.0, height=40),
            _ps_doc(hot_ms=9.0, cold_ms=31.0, height=1000)]
    for doc in docs:
        h = max(v for p in doc["processes"].values()
                for v in p["metrics"]["gauges"].values())
        for by in ("apply_ms", "row_heat"):
            assert ps_steering.propose_migrate_range(
                doc=doc, height=h, nshards=2, by=by) == \
                jps.propose_migrate_range(doc=doc, height=h, nshards=2,
                                          by=by)
        assert ps_steering.shard_row_load(doc) == jps.shard_row_load(doc)
        assert ps_steering.shard_apply_means(doc) == \
            jps.shard_apply_means(doc)
        assert ps_steering.apply_skew_value()(doc) == \
            jps.apply_skew_value()(doc)
        assert ps_steering.row_load_skew_value()(doc) == \
            jps.row_load_skew_value()(doc)


def test_the_port_s_daemon_registers_the_ps_steerer():
    """The daemon imports its consumers before a dispatch: the
    ``ps_migrate_range`` steerer is among them."""
    sd_mod._import_consumers()
    assert ps_steering.STEERER_NAME in steering.steerers()
