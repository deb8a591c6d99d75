"""Three behaviours of the port held to the JAX package's, on the CPU, each
through both packages on the same program and feeds.

(a) A feed left out of a run. The whole-program route never writes feeds
    into the scope, so a run that leaves out a feed the program reads
    raises the JAX package's ``RuntimeError("variable 'y' must be fed or
    initialized in scope")``; a fetched feed returns the fed value, as in
    the JAX package. The op-by-op interpreters of both packages write
    feeds into the scope, so there a left-out feed reads the last value
    in both. (On the card after a capture: ``tests/test_torch_gpu.py``.)
(b) ``FLAGS_check_nan_inf``. Each op's floating outputs are checked after
    it runs: an inf or a nan raises ``EnforceNotMet`` with the JAX
    package's message, letter for letter, annotation included; a finite
    run passes; with the flag off the inf comes out.
(c) Float64 and Python-list feeds. Staged as the JAX package stages them
    with x64 off: float64 (and a list of Python floats) becomes float32,
    other floating types stay as fed, int64 stays int64 in the port (the
    documented hazard: the JAX package makes it int32). Checked on the
    whole-program route, in the interpreter and in ``AsyncDeviceFeeder``.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as fluid
from paddle_tpu.core.enforce import EnforceNotMet as JaxEnforceNotMet
from paddle_tpu.core.native_feed import AsyncDeviceFeeder as JaxFeeder
from paddle_tpu_torch.core.native_feed import AsyncDeviceFeeder

PKGS = {"jax": jfluid, "port": fluid}
ONES = np.ones((2, 3), "float32")


def _sum_program(pkg, op="elementwise_add"):
    """reduce_sum(x <op> y) over two [2, 3] float32 feeds."""
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        x = pkg.data(name="x", shape=[2, 3], dtype="float32")
        y = pkg.data(name="y", shape=[2, 3], dtype="float32")
        out = pkg.layers.reduce_sum(getattr(pkg.layers, op)(x, y))
    return main, out


def _run(pkg, main, feed, fetch, scope, interpret=False):
    exe = pkg.Executor(pkg.CPUPlace())
    if interpret:
        return exe._core.run_program(main, scope, feed, fetch)
    return exe.run(main, feed=feed, fetch_list=fetch, scope=scope)


# -- (a) a feed left out of a run ------------------------------------------

@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_a_left_out_feed_raises_on_the_whole_program_route(pkg):
    pkg = PKGS[pkg]
    main, out = _sum_program(pkg)
    scope = pkg.Scope()
    (first,) = _run(pkg, main, {"x": ONES, "y": ONES}, [out], scope)
    assert float(first) == 12.0
    with pytest.raises(RuntimeError) as err:
        _run(pkg, main, {"x": 5 * ONES}, [out], scope)
    assert str(err.value) == \
        "variable 'y' must be fed or initialized in scope"


def test_the_port_raises_what_the_jax_package_raises():
    msgs = []
    for pkg in (jfluid, fluid):
        main, out = _sum_program(pkg)
        scope = pkg.Scope()
        _run(pkg, main, {"x": ONES, "y": ONES}, [out], scope)
        with pytest.raises(RuntimeError) as err:
            _run(pkg, main, {"y": ONES}, [out], scope)
        msgs.append((type(err.value), str(err.value)))
    assert msgs[0] == msgs[1]


def test_a_fetched_feed_returns_the_fed_value():
    got = {}
    for name, pkg in PKGS.items():
        main, out = _sum_program(pkg)
        scope = pkg.Scope()
        x = np.arange(6, dtype="float32").reshape(2, 3)
        res = _run(pkg, main, {"x": x, "y": ONES}, ["x", out], scope)
        got[name] = [np.asarray(r) for r in res]
        np.testing.assert_array_equal(got[name][0], x)
        assert float(got[name][1]) == 21.0
    for a, b in zip(got["jax"], got["port"]):
        np.testing.assert_array_equal(a, b)


def test_the_interpreters_keep_feeds_in_the_scope_alike():
    got = {}
    for name, pkg in PKGS.items():
        main, out = _sum_program(pkg)
        scope = pkg.Scope()
        _run(pkg, main, {"x": ONES, "y": ONES}, [out], scope, True)
        (got[name],) = _run(pkg, main, {"x": 5 * ONES}, [out], scope, True)
    assert float(got["port"]) == float(got["jax"]) == 36.0


# -- (b) FLAGS_check_nan_inf -------------------------------------------------

@pytest.fixture
def nan_inf_flag():
    for pkg in (jfluid, fluid):
        pkg.set_flags({"FLAGS_check_nan_inf": True})
    yield
    for pkg in (jfluid, fluid):
        pkg.set_flags({"FLAGS_check_nan_inf": False})


@pytest.mark.parametrize("case", ["inf", "nan"])
def test_check_nan_inf_raises_the_jax_packages_error(nan_inf_flag, case):
    x = ONES if case == "inf" else np.zeros((2, 3), "float32")
    feed = {"x": x, "y": np.zeros((2, 3), "float32")}
    from paddle_tpu_torch.core.enforce import EnforceNotMet

    errs = {}
    for name, pkg in PKGS.items():
        main, out = _sum_program(pkg, "elementwise_div")
        with pytest.raises(EnforceNotMet if pkg is fluid
                           else JaxEnforceNotMet) as err:
            _run(pkg, main, feed, [out], pkg.Scope())
        errs[name] = str(err.value)
    assert errs["port"] == errs["jax"]
    assert errs["port"].startswith(
        "Operator 'elementwise_div' output 'elementwise_div.tmp_0' "
        "contains Inf/Nan (FLAGS_check_nan_inf)\n  [operator "
        "'elementwise_div' error during execution; inputs: ")


def test_check_nan_inf_passes_a_finite_run_and_is_off_by_default(
        nan_inf_flag):
    main, out = _sum_program(fluid, "elementwise_div")
    (ok,) = _run(fluid, main, {"x": ONES, "y": 2 * ONES}, [out],
                 fluid.Scope())
    assert float(ok) == 3.0
    fluid.set_flags({"FLAGS_check_nan_inf": False})
    (inf,) = _run(fluid, main, {"x": ONES, "y": 0 * ONES}, [out],
                  fluid.Scope())
    assert np.isinf(inf)


def test_check_nan_inf_is_documented_as_working():
    doc = fluid.get_flags("FLAGS_check_nan_inf")
    assert doc == {"FLAGS_check_nan_inf": False}
    from paddle_tpu_torch.core import flags

    assert "no-op" not in flags._DEFS["FLAGS_check_nan_inf"][1]


# -- (c) float64 and Python-list feeds ---------------------------------------

def _fc_program(pkg):
    main, startup = pkg.Program(), pkg.Program()
    startup.random_seed = 1
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        x = pkg.data(name="x", shape=[2, 3], dtype="float32")
        out = pkg.layers.fc(x, size=4, act="relu")
    return main, startup, out


FEEDS = {
    "float64": lambda: np.linspace(-1, 1, 6).reshape(2, 3),
    "float_list": lambda: [[0.5, -1.0, 2.0], [1.5, 0.25, -0.75]],
}


@pytest.mark.parametrize("interpret", [False, True],
                         ids=["whole_program", "interpreter"])
@pytest.mark.parametrize("kind", sorted(FEEDS))
def test_float64_and_list_feeds_run_in_float32(kind, interpret):
    got = {}
    init = None
    for name, pkg in PKGS.items():
        main, startup, out = _fc_program(pkg)
        scope = pkg.Scope()
        exe = pkg.Executor(pkg.CPUPlace())
        if init is None:
            with pkg.scope_guard(scope):
                exe.run(startup)
            init = {p.name: np.asarray(scope.find_var(p.name).get_tensor())
                    for p in main.all_parameters()}
        else:
            fluid.io.scope_from_numpy(scope, init, fluid.CPUPlace())
        (got[name],) = _run(pkg, main, {"x": FEEDS[kind]()}, [out], scope,
                            interpret)
        got[name] = np.asarray(got[name])
    assert got["port"].dtype == got["jax"].dtype == np.float32
    np.testing.assert_allclose(got["port"], got["jax"], rtol=0, atol=1e-6)


@pytest.mark.parametrize("interpret", [False, True],
                         ids=["whole_program", "interpreter"])
def test_a_float64_feed_beside_a_float32_one_adds_in_float32(interpret):
    got = {}
    for name, pkg in PKGS.items():
        main, out = _sum_program(pkg)
        feed = {"x": 5 * np.ones((2, 3)), "y": ONES}
        (got[name],) = _run(pkg, main, feed, [out], pkg.Scope(), interpret)
        got[name] = np.asarray(got[name])
    assert got["port"].dtype == got["jax"].dtype == np.float32
    assert float(got["port"]) == float(got["jax"]) == 36.0


def test_other_feed_types_stay_as_fed():
    from paddle_tpu_torch.core.tensor import stage_feed

    assert stage_feed(np.ones(3, "float16")).dtype == torch.float16
    assert stage_feed(torch.ones(3, dtype=torch.bfloat16)).dtype == \
        torch.bfloat16
    assert stage_feed(torch.ones(3, dtype=torch.float64)).dtype == \
        torch.float32
    # int64 stays int64 (the JAX package, x64 off, makes it int32)
    assert stage_feed([1, 2, 3]).dtype == torch.int64
    assert stage_feed(np.arange(3, dtype="int32")).dtype == torch.int32


def test_the_feeder_stages_float64_as_float32_as_the_jax_feeder():
    batch = {"x": np.linspace(0, 1, 6).reshape(2, 3),
             "ids": np.arange(4, dtype="int64")}
    with JaxFeeder(iter([batch])) as jf:
        (jbatch,) = list(jf)
    with AsyncDeviceFeeder(iter([batch]), device=fluid.CPUPlace()) as pf:
        (pbatch,) = list(pf)
    jx = np.asarray(jbatch["x"].array if hasattr(jbatch["x"], "array")
                    else jbatch["x"])
    assert pbatch["x"].dtype == torch.float32 and jx.dtype == np.float32
    np.testing.assert_array_equal(pbatch["x"].numpy(), jx)
    assert pbatch["ids"].dtype == torch.int64
