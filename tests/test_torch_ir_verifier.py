"""The IR verifier, the collective-schedule check and the rewrite
contracts through the port against the JAX package.

The 15 cases of ``tests/test_ir_verifier.py`` run through the port: a
clean program and every rewrite pass verify clean; a finding is
structured; a dp=8 schedule with one rank diverging names the pair;
``checked_rewrite`` catches a planted broken pass, does nothing with the
knob off, and runs a registered contract; the data-parallel engine
verifies once before its first step and refuses a corrupt program; a
corrupt saved model is refused at load; the pipeline split's contract.

The mutation catalogue of ``tools/ir_mutate.py`` (each a seeded
corruption of a freshly rewritten program) runs through both packages on
the same programs: the port must flag each one, with the same findings in
the same words (``str`` of each finding of the invariant, the error's
text). The contracts run on the port's own dp, bucket, sharded-update,
fusion and bucket-quant passes. The JAX package's ``async_collective``
and ``reduction_swap`` mutations guard rewrites the port leaves undone
(ROADMAP.md). ``verify_lazy_graph`` refuses a mis-wired flush graph, and
the lazy engine checks each new graph.
"""
import copy
import json
import os

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu.analysis as janalysis
import paddle_tpu_torch as fluid
from paddle_tpu_torch import analysis
from paddle_tpu_torch.analysis import (CollectiveMismatchError,
                                       ContractViolation, IRVerificationError)
from paddle_tpu_torch.parallel.mesh_utils import make_mesh

NRANKS = 8


class Pkg:
    """One package's handles, so that a mutation runs alike in both."""

    def __init__(self, port):
        self.port = port
        if port:
            from paddle_tpu_torch.core import fusion
            from paddle_tpu_torch.parallel import collectives, scheduling
            from paddle_tpu_torch.parallel.transpiler import \
                insert_allreduce_ops

            self.fluid, self.analysis = fluid, analysis
            self.fused_optimizer = lambda m, s: fusion.apply_fused_optimizer(
                m, s, torch.device("cpu"))
        else:
            from paddle_tpu.core import fusion
            from paddle_tpu.parallel import collectives, scheduling
            from paddle_tpu.parallel.transpiler import insert_allreduce_ops

            self.fluid, self.analysis = jfluid, janalysis
            self.fused_optimizer = fusion.apply_fused_optimizer
        self.fused_epilogues = fusion.apply_fused_epilogues
        self.insert = insert_allreduce_ops
        self.bucket = collectives.bucket_allreduce_ops
        self.sharded = collectives.apply_sharded_weight_update
        self.bucket_quant = scheduling.configure_bucket_quant
        from importlib import import_module

        self.contracts = import_module(self.analysis.__name__ + ".contracts")


PORT, JAX = Pkg(True), Pkg(False)


@pytest.fixture(autouse=True)
def _verify_on(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_VERIFY_IR", "1")


def build(P, bucket=True, optimizer="sgd", scope=None, transpile=True):
    f = P.fluid
    main, startup = f.Program(), f.Program()
    with f.unique_name.guard(), f.program_guard(main, startup):
        x = f.data(name="x", shape=[16, 8], dtype="float32")
        lbl = f.data(name="lbl", shape=[16, 1], dtype="int64")
        h = f.layers.fc(x, size=32, act="relu")
        pred = f.layers.fc(h, size=10, act="softmax")
        loss = f.layers.mean(f.layers.cross_entropy(pred, lbl))
        if optimizer == "momentum":
            f.optimizer.MomentumOptimizer(0.1, 0.9).minimize(loss)
        else:
            f.optimizer.SGD(0.1).minimize(loss)
    if transpile:
        P.insert(main, NRANKS)
        if bucket:
            P.bucket(main, bucket_bytes=4 << 20, scope=scope)
    return main, startup, loss


def build_single_chip(P):
    f = P.fluid
    scope = f.Scope()
    main, startup = f.Program(), f.Program()
    with f.unique_name.guard(), f.program_guard(main, startup):
        x = f.data(name="x", shape=[16, 8], dtype="float32")
        lbl = f.data(name="lbl", shape=[16, 1], dtype="int64")
        h = f.layers.fc(x, size=32, act="gelu")
        pred = f.layers.fc(h, size=10, act="softmax")
        loss = f.layers.mean(f.layers.cross_entropy(pred, lbl))
        f.optimizer.AdamOptimizer(1e-3).minimize(loss)
    with f.scope_guard(scope):
        f.Executor(f.CPUPlace()).run(startup)
    return main, scope, loss


def op_of(block, t):
    return next(op for op in block.ops if op.type == t)


def findings(P, main, loss, invariant, recheck=False):
    fs = P.analysis.verify_program(main, fetch_names=[loss.name],
                                   recheck_shapes=recheck,
                                   raise_on_error=False)
    return [str(f) for f in fs if f.invariant == invariant]


# -- the mutation catalogue (tools/ir_mutate.py), over a package ---------------

def m_drop_input(P):
    main, _, loss = build(P)
    op_of(main.global_block(), "mul").inputs.pop("X")
    return findings(P, main, loss, "missing-slot")


def m_dangling_input(P):
    main, _, loss = build(P)
    op_of(main.global_block(), "mul").inputs["X"] = ["__no_such_var__"]
    return findings(P, main, loss, "dangling-input")


def m_never_written_input(P):
    main, _, loss = build(P)
    block = main.global_block()
    block.create_var(name="__declared_garbage__", shape=(16, 8),
                     dtype="float32")
    op_of(block, "mul").inputs["X"] = ["__declared_garbage__"]
    return findings(P, main, loss, "never-written-input")


def m_use_before_def(P):
    main, _, loss = build(P)
    block = main.global_block()
    block.ops.append(block.ops.pop(0))
    return findings(P, main, loss, "use-before-def")


def m_dtype_change(P):
    main, _, loss = build(P)
    block = main.global_block()
    block.var(op_of(block, "mul").output("Out")[0]).dtype = "float16"
    return findings(P, main, loss, "dtype-mismatch", recheck=True)


def m_shape_change(P):
    main, _, loss = build(P)
    block = main.global_block()
    v = block.var(op_of(block, "mul").output("Out")[0])
    v.shape = tuple(v.shape[:-1]) + (v.shape[-1] + 3,)
    return findings(P, main, loss, "shape-mismatch", recheck=True)


def m_invalid_dtype(P):
    main, _, loss = build(P)
    block = main.global_block()
    block.var(op_of(block, "mul").output("Out")[0]).dtype = "float99"
    return findings(P, main, loss, "invalid-dtype")


def m_orphan_op(P):
    main, _, loss = build(P)
    block = main.global_block()
    src = op_of(block, "mul").output("Out")[0]
    v = block.create_var(name="__orphan_out__", shape=block.var(src).shape,
                         dtype="float32")
    op = P.fluid.framework.Operator(block, "scale", {"X": [src]},
                                    {"Out": [v.name]},
                                    {"scale": 2.0, "bias": 0.0})
    op._id = main._next_op_id()
    block.ops.append(op)
    return findings(P, main, loss, "unreachable-op")


def m_duplicate_write(P):
    main, _, loss = build(P)
    block = main.global_block()
    i, op = next((i, op) for i, op in enumerate(block.ops)
                 if op.type == "mul")
    clone = copy.copy(op)
    clone.inputs = {k: list(v) for k, v in op.inputs.items()}
    clone.outputs = {k: list(v) for k, v in op.outputs.items()}
    block.ops.insert(i + 1, clone)
    return findings(P, main, loss, "overwritten-write")


def m_drop_output(P):
    main, _, loss = build(P)
    op_of(main.global_block(), "mul").outputs = {}
    return findings(P, main, loss, "missing-slot")


def m_unknown_op(P):
    main, _, loss = build(P)
    op_of(main.global_block(), "mul").type = "bogus_op_xyz"
    return findings(P, main, loss, "unknown-op")


def m_attr_type(P):
    main, _, loss = build(P)
    op_of(main.global_block(), "c_bucket_allreduce").attrs["ring_id"] = \
        "zero"
    return findings(P, main, loss, "attr-type")


def m_alias_write(P):
    main, _, loss = build(P)
    op = op_of(main.global_block(), "mul")
    out = op.output("Out")[0]
    op.outputs["Out"] = [out, out]
    return findings(P, main, loss, "alias-write")


def raised(fn, exc):
    try:
        fn()
    except exc as e:
        return [type(e).__name__, getattr(e, "kind", None), str(e)]
    return []


def m_conditional_collective(P):
    main, _, loss = build(P, bucket=False)
    block = main.global_block()
    g = op_of(block, "c_allreduce_sum").input("X")[0]
    sub = main._create_block(parent_idx=0)
    main._rollback()
    fw = P.fluid.framework
    inner = fw.Operator(sub, "c_allreduce_sum", {"X": [g]}, {"Out": [g]},
                        {"ring_id": 0})
    inner._id = main._next_op_id()
    sub.ops.append(inner)
    cond = fw.Operator(block, "conditional_block", {}, {},
                       {"sub_block": sub})
    cond._id = main._next_op_id()
    block.ops.append(cond)
    return raised(lambda: P.analysis.check_collective_schedule(
        main, nranks=NRANKS), P.analysis.CollectiveMismatchError)


def per_rank(P, edit):
    main, _, _ = build(P, bucket=False)
    sigs, _f = P.analysis.extract_collective_schedule(main)
    scheds = [list(sigs) for _ in range(NRANKS)]
    edit(scheds)
    return raised(lambda: P.analysis.check_cross_rank(
        scheds, where="ir_mutate"), P.analysis.CollectiveMismatchError)


def m_rank_reorder(P):
    def edit(s):
        s[5][0], s[5][1] = s[5][1], s[5][0]
    return per_rank(P, edit)


def m_rank_dtype(P):
    def edit(s):
        s[3][1] = copy.copy(s[3][1])
        s[3][1].dtype = "bfloat16"
    return per_rank(P, edit)


def m_rank_numel(P):
    def edit(s):
        s[7][0] = copy.copy(s[7][0])
        s[7][0].numel = (s[7][0].numel or 0) + 13
    return per_rank(P, edit)


def m_rank_missing(P):
    def edit(s):
        s[2] = s[2][:-1]
    return per_rank(P, edit)


def m_double_reduce(P):
    main, _, _ = build(P, bucket=False)
    block = main.global_block()
    i = next(i for i, op in enumerate(block.ops)
             if op.type == "c_allreduce_sum")
    block.ops.insert(i + 1, copy.copy(block.ops[i]))
    return raised(lambda: P.analysis.check_collective_schedule(
        main, nranks=NRANKS), P.analysis.CollectiveMismatchError)


def contract_run(P, name, before, rewrite, sabotage, main):
    contract = P.contracts.contract_for(name)
    state = contract.pre(main)
    rewrite()
    sabotage()
    return raised(lambda: contract.post(main, state),
                  P.contracts.ContractViolation)


def m_bucket_contract(P):
    main, _, _ = build(P, bucket=False)

    def sabotage():
        op = op_of(main.global_block(), "c_bucket_allreduce")
        op.inputs["X"] = op.input("X")[1:]
        op.outputs["Out"] = op.output("Out")[1:]

    return contract_run(P, "bucket_allreduce", None, lambda: P.bucket(
        main, bucket_bytes=4 << 20), sabotage, main)


def m_sharded_contract(P):
    f = P.fluid
    scope = f.Scope()
    with f.scope_guard(scope):
        main, startup, _ = build(P, bucket=False, optimizer="momentum",
                                 scope=scope)
        f.Executor(f.CPUPlace()).run(startup)

    def sabotage():
        op = op_of(main.global_block(), "c_sharded_update")
        op.inputs["Param"] = op.input("Param")[:-1]
        op.inputs["Grad"] = op.input("Grad")[:-1]
        op.outputs["ParamOut"] = op.output("ParamOut")[:-1]

    return contract_run(P, "sharded_update", None, lambda: P.sharded(
        main, scope, NRANKS), sabotage, main)


def m_fused_optimizer_drop(P):
    main, scope, _ = build_single_chip(P)

    def sabotage():
        op = op_of(main.global_block(), "fused_optimizer")
        op.inputs["Param"] = op.input("Param")[:-1]
        op.inputs["Grad"] = op.input("Grad")[:-1]
        op.outputs["ParamOut"] = op.output("ParamOut")[:-1]

    return contract_run(P, "fused_optimizer", None,
                        lambda: P.fused_optimizer(main, scope), sabotage,
                        main)


def m_fused_optimizer_double_update(P):
    main, scope, _ = build_single_chip(P)
    contract = P.contracts.contract_for("fused_optimizer")
    state = contract.pre(main)
    P.fused_optimizer(main, scope)
    block = main.global_block()
    fop = op_of(block, "fused_optimizer")
    p, g = fop.input("Param")[0], fop.input("Grad")[0]
    dup = P.fluid.framework.Operator(
        block, "adam",
        {"Param": [p], "Grad": [g],
         "LearningRate": fop.input("LearningRate"), "Moment1": [p],
         "Moment2": [p], "Beta1Pow": [p], "Beta2Pow": [p]},
        {"ParamOut": [p], "Moment1Out": [p], "Moment2Out": [p],
         "Beta1PowOut": [p], "Beta2PowOut": [p]}, {})
    dup._id = state["opts"][0][0]
    block.ops.append(dup)
    return raised(lambda: contract.post(main, state),
                  P.contracts.ContractViolation)


def m_fused_epilogue(P):
    main, _, _ = build_single_chip(P)
    return contract_run(
        P, "fused_epilogue", None, lambda: P.fused_epilogues(main),
        lambda: op_of(main.global_block(),
                      "fused_bias_act").outputs.pop("AddOut"), main)


def m_bucket_quant_residual(P):
    scope = P.fluid.Scope()
    main, _, _ = build(P, scope=scope)

    def sabotage():
        op = op_of(main.global_block(), "c_bucket_allreduce")
        assert op.input("Residual")
        op.outputs.pop("ResidualOut")

    return contract_run(P, "bucket_quant", None, lambda: P.bucket_quant(
        main, scope, NRANKS, "dp", modes="int8", error_feedback=True),
        sabotage, main)


def m_lazy_graph(P):
    wiring = [(("e", 0),), (("n", 2, 0),), (("n", 1, 0),)]
    return raised(lambda: P.analysis.verify_lazy_graph(
        wiring, [1, 1, 1], 1, [(2, 0)]), P.analysis.IRVerificationError)


MUTATIONS = {
    "drop-input-var": (m_drop_input, "missing-slot"),
    "dangling-input": (m_dangling_input, "dangling-input"),
    "never-written-input": (m_never_written_input, "never-written-input"),
    "use-before-def": (m_use_before_def, "use-before-def"),
    "dtype-change": (m_dtype_change, "dtype-mismatch"),
    "shape-change": (m_shape_change, "shape-mismatch"),
    "invalid-dtype": (m_invalid_dtype, "invalid-dtype"),
    "orphan-op": (m_orphan_op, "unreachable-op"),
    "duplicate-write": (m_duplicate_write, "overwritten-write"),
    "drop-output": (m_drop_output, "missing-slot"),
    "unknown-op": (m_unknown_op, "unknown-op"),
    "attr-type": (m_attr_type, "attr-type"),
    "alias-write": (m_alias_write, "alias-write"),
    "conditional-collective": (m_conditional_collective,
                               "conditional-collective"),
    "rank-reorder-collectives": (m_rank_reorder, "position 0"),
    "rank-dtype-divergence": (m_rank_dtype, "position 1"),
    "rank-numel-divergence": (m_rank_numel, "rank 7"),
    "rank-missing-collective": (m_rank_missing, "rank 2"),
    "double-reduce": (m_double_reduce, "double-reduce"),
    "bucket-contract-drop-grad": (m_bucket_contract, "multiset"),
    "sharded-contract-drop-param": (m_sharded_contract, "never be updated"),
    "fused-optimizer-drop-pair": (m_fused_optimizer_drop,
                                  "never be updated"),
    "fused-optimizer-double-update": (m_fused_optimizer_double_update,
                                      "double update"),
    "fused-epilogue-drop-intermediate": (m_fused_epilogue,
                                         "dropped written var"),
    "bucket-quant-residual-mismatch": (m_bucket_quant_residual,
                                       "ResidualOut"),
    "lazy-graph-miswire": (m_lazy_graph, "not an earlier node"),
}


class TestVerifier:
    def test_clean_program_verifies_clean(self):
        main, _, loss = build(PORT, transpile=False)
        fs = analysis.verify_program(main, fetch_names=[loss.name],
                                     recheck_shapes=True)
        assert [f for f in fs if f.severity == "error"] == []

    def test_all_rewrite_passes_verify_clean(self):
        main, _, loss = build(PORT)
        fs = analysis.verify_program(main, fetch_names=[loss.name],
                                     recheck_shapes=True)
        assert [f for f in fs if f.severity == "error"] == []
        assert analysis.schedule_record(main, nranks=NRANKS)["ok"]
        jmain, _, jloss = build(JAX)
        assert analysis.schedule_record(main, nranks=NRANKS)["digest"] == \
            janalysis.schedule_record(jmain, nranks=NRANKS)["digest"]

    def test_error_is_structured(self):
        main, _, _ = build(PORT, transpile=False)
        op = main.global_block().ops[0]
        op.inputs["X"] = ["__nope__"]
        with pytest.raises(IRVerificationError) as ei:
            analysis.verify_program(main, pass_name="unit")
        e = ei.value
        assert e.pass_name == "unit"
        assert e.findings and e.findings[0].invariant == "dangling-input"
        assert e.findings[0].op_type == op.type
        assert e.findings[0].block_idx == 0 and "__nope__" in str(e)

    @pytest.mark.parametrize("kind", sorted(MUTATIONS))
    def test_mutation_caught_with_the_jax_packages_words(self, kind):
        fn, needle = MUTATIONS[kind]
        got, want = fn(PORT), fn(JAX)
        assert got, "%s not flagged by the port" % kind
        assert got == want
        assert any(needle in g for g in got if isinstance(g, str))


class TestCrossRank:
    def test_dp8_mismatched_schedule_names_diverging_pair(self):
        main, _, _ = build(PORT, bucket=False)
        sigs, fs = analysis.extract_collective_schedule(main)
        assert not fs and len(sigs) >= 2
        scheds = [list(sigs) for _ in range(NRANKS)]
        bad = scheds[5][1] = copy.copy(scheds[5][1])
        bad.dtype = "float16"
        with pytest.raises(CollectiveMismatchError) as ei:
            analysis.check_cross_rank(scheds, where="dp8")
        e = ei.value
        assert e.kind == "would-corrupt"
        (r0, k0, a), (r5, k5, b) = e.pair
        assert (r0, r5) == (0, 5) and k0 == k5 == 1
        assert "rank 5" in str(e) and "rank 0" in str(e)
        assert a.op_type in str(e) and "float16" in str(e)

    def test_identical_schedules_pass(self):
        main, _, _ = build(PORT, bucket=False)
        assert analysis.check_cross_rank([main] * NRANKS) >= 2


def buggy(program):
    op = program.global_block().ops[0]
    op.inputs = {k: ["__gone__"] for k in op.inputs}


class TestContractsForFree:
    def test_buggy_future_pass_caught(self):
        main, _, _ = build(PORT, transpile=False)
        with pytest.raises(IRVerificationError) as ei:
            analysis.checked_rewrite("future_pass")(buggy)(main)
        assert ei.value.pass_name == "future_pass"

    def test_disabled_flag_skips_checks(self, monkeypatch):
        monkeypatch.setenv("PADDLE_TPU_VERIFY_IR", "0")
        main, _, _ = build(PORT, transpile=False)
        analysis.checked_rewrite("future_pass")(buggy)(main)

    def test_registered_contract_rides_decorator(self):
        calls = []

        class _C(analysis.RewriteContract):
            name = "future_pass2"

            def pre(self, program):
                calls.append("pre")
                return {"ops": len(program.global_block().ops)}

            def post(self, program, state):
                calls.append("post")
                if len(program.global_block().ops) != state["ops"]:
                    raise ContractViolation("op count changed")

        analysis.register_contract(_C())

        @analysis.checked_rewrite("future_pass2")
        def add_op_pass(program):
            block = program.global_block()
            block.ops.append(copy.copy(block.ops[0]))

        main, _, _ = build(PORT, transpile=False)
        with pytest.raises(ContractViolation):
            add_op_pass(main)
        assert calls == ["pre", "post"]


def dp_feed():
    return {"x": np.zeros((16, 8), "float32"),
            "lbl": np.zeros((16, 1), "int64")}


class TestEngineWiring:
    def test_engine_first_run_verifies(self):
        from paddle_tpu_torch import observability as obs

        main, startup, loss = build(PORT, transpile=False)
        exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
        obs.enable()
        try:
            obs.reset()
            exe.run(startup, scope=scope)
            cp = fluid.CompiledProgram(main).with_data_parallel(
                loss_name=loss.name,
                places=make_mesh([2], ["dp"], [fluid.CPUPlace()] * 2))
            for _ in range(2):
                exe.run(cp, feed=dp_feed(), fetch_list=[loss], scope=scope)
            assert obs.counter_value("analysis.verify_runs",
                                     where="parallel.engine") == 1
            assert obs.counter_value("analysis.pass_checks",
                                     rewrite="insert_allreduce") >= 1
        finally:
            obs.disable()

    def test_engine_rejects_corrupt_program(self):
        main, startup, loss = build(PORT, transpile=False)
        block = main.global_block()
        block.ops[2].inputs = {k: ["__gone__"] for k in block.ops[2].inputs}
        exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
        exe.run(startup, scope=scope)
        cp = fluid.CompiledProgram(main).with_data_parallel(
            loss_name=loss.name,
            places=make_mesh([2], ["dp"], [fluid.CPUPlace()] * 2))
        with pytest.raises(IRVerificationError):
            exe.run(cp, feed=dp_feed(), fetch_list=[loss], scope=scope)


class TestLoadWiring:
    def test_corrupt_saved_model_rejected_at_load(self, tmp_path):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.unique_name.guard(), fluid.program_guard(main, startup):
            x = fluid.data(name="x", shape=[4, 8], dtype="float32")
            y = fluid.layers.fc(x, size=3, act=None)
        exe = fluid.Executor(fluid.CPUPlace())
        exe.run(startup)
        d = str(tmp_path / "model")
        fluid.io.save_inference_model(d, ["x"], [y], exe, main_program=main)
        fluid.io.load_inference_model(d, exe)
        p = os.path.join(d, "__model__.json")
        with open(p) as f:
            doc = json.load(f)
        doc["blocks"][0]["ops"][0]["inputs"] = {
            k: ["__corrupt__"] for k in doc["blocks"][0]["ops"][0]["inputs"]}
        with open(p, "w") as f:
            json.dump(doc, f)
        from paddle_tpu_torch.checkpoint import write_manifest

        write_manifest(d)
        with pytest.raises(IRVerificationError):
            fluid.io.load_inference_model(d, exe)


class TestPipelineSplitContract:
    def test_partition_must_tile_forward_range(self):
        main, _, _ = build(PORT, transpile=False)
        ops = main.global_block().ops
        with pytest.raises(ContractViolation):
            analysis.check_pipeline_split(main, [ops[:3], ops[2:6]], 6)

    def test_empty_stage_rejected(self):
        main, _, _ = build(PORT, transpile=False)
        ops = main.global_block().ops
        with pytest.raises(ContractViolation):
            analysis.check_pipeline_split(main, [ops[:6], []], 6)

    def test_good_partition_passes(self):
        main, _, _ = build(PORT, transpile=False)
        ops = main.global_block().ops
        analysis.check_pipeline_split(main, [ops[:3], ops[3:6]], 6)


def test_the_lazy_engine_checks_each_new_flush_graph(monkeypatch):
    """A planted mis-wiring of a queued node reaches the check before the
    flush runs it."""
    from paddle_tpu_torch.dygraph import lazy

    calls = []
    real = analysis.verify_lazy_graph

    def spy(wiring, outs, n_ext, needed):
        calls.append(len(wiring))
        return real(wiring, outs, n_ext, needed)

    monkeypatch.setattr(analysis, "verify_lazy_graph", spy)
    with fluid.dygraph.guard(fluid.CPUPlace(), lazy=True):
        x = fluid.dygraph.to_variable(np.ones((2, 3), "float32"))
        y = fluid.layers.relu(x * 2.0)
        y.numpy()
    assert calls and calls[0] >= 1
    assert lazy is not None


def test_a_while_body_reading_its_carries_verifies_clean():
    """A ``while`` body reads its carries (written before the loop and at
    the end of each trip) before it writes them. The JAX verifier calls
    that a use before a definition (a false positive of the JAX package,
    which would refuse such a saved model at load); the port's does not,
    and still flags a body var no block writes before it is read."""
    import test_torch_predictor_ir as PI

    jmain, _, _ = PI._while_program(jfluid)
    main, _, _ = PI._while_program(fluid)
    jerr = [str(f) for f in janalysis.verify_program(
        jmain, raise_on_error=False) if f.severity == "error"]
    assert len(jerr) == 2 and all("use-before-def" in e for e in jerr)
    assert [f for f in analysis.verify_program(main, raise_on_error=False)
            if f.severity == "error"] == []
    body = main.blocks[1]
    body.create_var(name="__body_temp__", shape=(2, 4), dtype="float32")
    body.ops[0].inputs["X"] = ["__body_temp__"]
    body.ops[1].outputs["Out"] = ["__body_temp__"]
    errs = [f for f in analysis.verify_program(main, raise_on_error=False)
            if f.severity == "error"]
    assert [f.invariant for f in errs] == ["use-before-def"]
    assert errs[0].block_idx == 1


def test_a_block_no_op_runs_is_not_verified():
    """A program whose ``while`` was taken out leaves a body no op runs
    (the JAX package's inference save does that when the loop rewrites
    the fetch target; the port's save keeps the loop): the port's
    verifier names it with a warning and verifies the rest, where the JAX
    verifier flags the dead body's reads."""
    import test_torch_predictor_ir as PI

    main, _, _ = PI._while_program(fluid)
    jmain, _, _ = PI._while_program(jfluid)
    for prog in (main, jmain):
        block = prog.global_block()
        block.ops = [op for op in block.ops if op.type != "while"]
    fs = analysis.verify_program(main, raise_on_error=False)
    assert [f.invariant for f in fs if f.severity == "error"] == []
    assert [(f.invariant, f.block_idx) for f in fs
            if f.invariant == "orphan-block"] == [("orphan-block", 1)]
    assert [f for f in janalysis.verify_program(jmain, raise_on_error=False)
            if f.severity == "error" and f.block_idx == 1]
