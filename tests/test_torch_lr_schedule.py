"""The in-graph learning-rate schedules (``layers/learning_rate_scheduler``),
the port against the JAX package.

Each of the eight schedules (and the variants its arguments select:
staircase, cycle, a warm-up over a schedule and over a number) is built
by one script under both packages: the same op types, slots, var names
and attrs. Each program then runs 12 steps through both packages'
Executors on the CPU from the JAX startup's persistables, fetching the
rate every step; the fetched rates and the step counters afterwards must
agree.

Tolerances: the rates within 1e-6 relative. Each is a few float32 ops on
the step, and the JAX package's ``pow``, ``exp`` and ``cos`` are XLA's
approximations, up to a float32 ulp or two off the correctly rounded
value that torch gives: the largest reading here is 1.2e-7
(``natural_exp_decay``), and ``pow(x, 1.0)`` read 1.6e-7 off at one step
of a warm-up over ``polynomial_decay(1e-2, 12)``. The schedules of only
``+ - * /``, ``min`` and ``where`` (``piecewise_decay``,
``inverse_time_decay``, ``linear_lr_warmup`` over a number) must agree
exactly. The counters are compared by value: the JAX package (x64 off)
keeps them int32, the port int64.

The helpers below (``carry``, ``run_steps``, ``train_both``) are shared
with the other training-recipe tests.
"""
import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu_torch as fluid

STEPS = 12
RATE_RTOL = 1e-6


def op_seq(program):
    """(type, inputs, outputs, attrs) of every op of the global block."""
    return [(op.type, op.inputs, op.outputs, dict(op.attrs))
            for op in program.global_block().ops]


def carry(jmain, jscope, pmain, pscope):
    """Every initialised persistable of the JAX run into the port's scope,
    in the type the port's program declares (the JAX package's int32
    counters become the port's int64)."""
    arrays = {}
    for v in jmain.global_block().vars.values():
        if not v.persistable:
            continue
        var = jscope.find_var(v.name)
        if var is None or not var.is_initialized():
            continue
        a = np.asarray(var.get_tensor())
        pv = pmain.global_block()._find_var_recursive(v.name)
        if pv is not None and str(pv.dtype) in ("int32", "int64"):
            a = a.astype(str(pv.dtype))
        arrays[v.name] = a
    fluid.io.scope_from_numpy(pscope, arrays, fluid.CPUPlace())


def persistables(main, scope):
    out = {}
    for v in main.global_block().vars.values():
        var = scope.find_var(v.name) if v.persistable else None
        if var is not None and var.is_initialized():
            out[v.name] = np.asarray(var.get_tensor())
    return out


def run_steps(exe, main, scope, feeds, fetch):
    return [[np.asarray(r) for r in exe.run(main, feed=feed, scope=scope,
                                            fetch_list=fetch)]
            for feed in feeds]


def train_both(build, feeds, exe_seed=None, jax_seed=None):
    """``build(pkg) -> (main, startup, fetch_list)`` under both packages;
    the JAX startup runs (its executor's RNG seeded with ``jax_seed``
    where given, else from numpy's global state), its persistables are
    carried into the port, and both run one step a feed. Returns ((JAX
    fetches, JAX state), (port fetches, port state), (JAX main, port
    main))."""
    jmain, jstartup, jfetch = build(jfluid)
    pmain, _, pfetch = build(fluid)
    jexe = jfluid.Executor(jfluid.CPUPlace())
    if jax_seed is not None:
        jexe._core.rng.seed = jax_seed
    jscope = jfluid.Scope()
    jexe.run(jstartup, scope=jscope)
    pexe = fluid.Executor(fluid.CPUPlace())
    if exe_seed is not None:
        pexe._core.rng.seed = exe_seed
    pscope = fluid.Scope()
    carry(jmain, jscope, pmain, pscope)
    j = run_steps(jexe, jmain, jscope, feeds, jfetch)
    p = run_steps(pexe, pmain, pscope, feeds, pfetch)
    return ((j, persistables(jmain, jscope)),
            (p, persistables(pmain, pscope)), (jmain, pmain))


def _warm_poly(L):
    return L.linear_lr_warmup(
        L.polynomial_decay(0.1, decay_steps=8, end_learning_rate=0.0,
                           power=1.0),
        warmup_steps=4, start_lr=0.0, end_lr=0.1)


SCHEDULES = {
    "noam": lambda L: L.noam_decay(64, warmup_steps=4, learning_rate=2.0),
    "exponential": lambda L: L.exponential_decay(0.1, 3, 0.5),
    "exponential_staircase": lambda L: L.exponential_decay(
        0.1, 3, 0.5, staircase=True),
    "natural_exp": lambda L: L.natural_exp_decay(0.1, 3, 0.5),
    "natural_exp_staircase": lambda L: L.natural_exp_decay(
        0.1, 3, 0.5, staircase=True),
    "inverse_time": lambda L: L.inverse_time_decay(0.1, 3, 0.5),
    "inverse_time_staircase": lambda L: L.inverse_time_decay(
        0.1, 3, 0.5, staircase=True),
    "polynomial": lambda L: L.polynomial_decay(0.1, 8, 0.001, power=2.0),
    "polynomial_cycle": lambda L: L.polynomial_decay(
        0.1, 5, 0.001, power=1.0, cycle=True),
    "piecewise": lambda L: L.piecewise_decay([3, 6], [0.1, 0.01, 0.001]),
    "cosine": lambda L: L.cosine_decay(0.1, step_each_epoch=3, epochs=4),
    "warmup_over_polynomial": _warm_poly,
    "warmup_over_a_number": lambda L: L.linear_lr_warmup(
        0.05, warmup_steps=5, start_lr=0.01, end_lr=0.05),
}
EXACT = {"piecewise", "inverse_time", "inverse_time_staircase",
         "warmup_over_a_number"}


def build_schedule(name):
    def build(pkg):
        main, startup = pkg.Program(), pkg.Program()
        with pkg.unique_name.guard(), pkg.program_guard(main, startup):
            lr = SCHEDULES[name](pkg.layers)
        return main, startup, [lr]

    return build


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedule_builds_the_jax_program(name):
    jmain, jstartup, _ = build_schedule(name)(jfluid)
    pmain, pstartup, _ = build_schedule(name)(fluid)
    assert op_seq(pmain) == op_seq(jmain)
    assert op_seq(pstartup) == op_seq(jstartup)
    counters = [n for n in pmain.global_block().vars
                if n.startswith("@LR_DECAY_COUNTER@")]
    assert counters and all(
        pmain.global_block().var(n).persistable for n in counters)


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedule_rates_match_the_jax_package(name):
    (j, jstate), (p, pstate), _ = train_both(build_schedule(name),
                                             [{}] * STEPS, jax_seed=11)
    jr = np.array([float(s[0].reshape(-1)[0]) for s in j])
    pr = np.array([float(s[0].reshape(-1)[0]) for s in p])
    assert np.isfinite(pr).all() and len(set(pr.tolist())) > 1
    if name in EXACT:
        np.testing.assert_array_equal(pr.astype(np.float32),
                                      jr.astype(np.float32))
    else:
        np.testing.assert_allclose(pr, jr, rtol=RATE_RTOL, atol=0)
    counters = sorted(n for n in pstate if n.startswith("@LR_DECAY_COUNTER@"))
    assert counters == sorted(n for n in jstate
                              if n.startswith("@LR_DECAY_COUNTER@"))
    for n in counters:
        assert pstate[n].dtype == np.int64
        assert int(pstate[n].reshape(-1)[0]) == \
            int(jstate[n].reshape(-1)[0]) == STEPS


def test_the_port_interpreter_gives_the_whole_program_rates():
    """The op-by-op interpreter and the whole-program route advance the
    counter alike."""
    main, startup, (lr,) = build_schedule("warmup_over_polynomial")(fluid)
    rates = {}
    for route in ("compiled", "interpreter"):
        exe = fluid.Executor(fluid.CPUPlace())
        scope = fluid.Scope()
        exe.run(startup, scope=scope)
        rates[route] = []
        for _ in range(STEPS):
            if route == "compiled":
                (r,) = exe.run(main, scope=scope, fetch_list=[lr])
            else:
                (r,) = exe._core.run_program(main, scope, {}, [lr], True)
            rates[route].append(float(np.asarray(r).reshape(-1)[0]))
    assert rates["compiled"] == rates["interpreter"]
    # warm-up 0.1 * step / 4 for steps 1-3, then the linear decay from
    # 0.1 over 8 steps, clamped at 0 from step 8
    want = [0.1 * s / 4 if s < 4 else 0.1 * (1 - min(s, 8) / 8)
            for s in range(1, STEPS + 1)]
    np.testing.assert_allclose(rates["compiled"], want, rtol=1e-6, atol=1e-9)
