"""The initializers this slice adds (``TruncatedNormal``, ``MSRA``,
``NumpyArray``, ``Bilinear``), the short aliases and the
``truncated_gaussian_random`` op, the port against the JAX package.

Every initializer appends the JAX package's startup op (type, attrs).
``NumpyArray`` and ``Bilinear`` write fixed values: exactly the JAX
package's. The random ones draw from torch's generator, which cannot
reproduce ``jax.random``'s stream, so both packages' draws are held to the
distribution instead, on 200,000 values (a [400, 500] parameter):

- ``truncated_gaussian_random`` (``TruncatedNormal``): every value inside
  (mean - 2 std, mean + 2 std); the sample mean within 5 standard errors
  of the mean; the sample standard deviation within 1% of the truncated
  normal's, 0.87962566 std (its standard error here is about 0.2%); the
  largest gap between the sample's CDF and the truncated normal's below
  0.005 (the Kolmogorov-Smirnov statistic's 1% critical value at this
  size is 1.63 / sqrt(200000) = 0.0036);
- ``MSRA``: uniform over +-sqrt(6 / fan_in) (values inside, standard
  deviation within 1% of limit / sqrt(3)) or normal with sqrt(2 / fan_in)
  (standard deviation within 1%, mean within 5 standard errors).

The same seed gives the same draw in the port, and another seed another.
"""
import math

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as fluid
from paddle_tpu_torch.core.registry import (DEVICE_ATTR, GENERATOR_ATTR,
                                            OpInfoMap)

SHAPE = (400, 500)
N = SHAPE[0] * SHAPE[1]
TRUNC_STD = 0.87962566  # std of a standard normal cut at +-2
STD_RTOL = 0.01
MEAN_SIGMAS = 5
KS_LIMIT = 0.005


def _phi(x):
    return 0.5 * (1 + math.erf(x / math.sqrt(2)))


def _trunc_cdf(z):
    lo, hi = _phi(-2.0), _phi(2.0)
    return (np.vectorize(_phi)(z) - lo) / (hi - lo)


def init_program(pkg, init, shape=SHAPE, seed=7):
    """(main, startup, param) of one parameter made by ``init``."""
    main, startup = pkg.Program(), pkg.Program()
    startup.random_seed = seed
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        x = pkg.data(name="x", shape=[2, shape[0]], dtype="float32")
        pkg.layers.fc(x, shape[1], param_attr=pkg.ParamAttr(
            name="w", initializer=init(pkg.initializer)), bias_attr=False)
    return main, startup


def drawn(pkg, init, shape=SHAPE, seed=7):
    _, startup = init_program(pkg, init, shape, seed)
    exe = pkg.Executor(pkg.CPUPlace())
    scope = pkg.Scope()
    exe.run(startup, scope=scope)
    return np.asarray(scope.find_var("w").get_tensor())


INITS = {
    "truncated_normal": lambda I: I.TruncatedNormal(loc=0.5, scale=2.0),
    "truncated_normal_seeded": lambda I: I.TruncatedNormalInitializer(
        scale=0.02, seed=11),
    "msra_uniform": lambda I: I.MSRA(),
    "msra_normal": lambda I: I.MSRAInitializer(uniform=False, fan_in=50),
    "numpy_array": lambda I: I.NumpyArrayInitializer(
        np.arange(6 * 4, dtype="float32").reshape(6, 4) / 7),
}


@pytest.mark.parametrize("name", sorted(INITS))
def test_startup_op_is_the_jax_packages(name):
    shape = {"numpy_array": (6, 4)}.get(name, SHAPE)
    _, jstartup = init_program(jfluid, INITS[name], shape)
    _, pstartup = init_program(fluid, INITS[name], shape)
    want = [(op.type, op.inputs, op.outputs, op.attrs)
            for op in jstartup.global_block().ops]
    assert [(op.type, op.inputs, op.outputs, op.attrs)
            for op in pstartup.global_block().ops] == want


def test_numpy_array_initializer_is_exact():
    value = np.arange(6 * 4, dtype="float32").reshape(6, 4) / 7
    init = INITS["numpy_array"]
    got = drawn(fluid, init, (6, 4))
    np.testing.assert_array_equal(got, drawn(jfluid, init, (6, 4)))
    np.testing.assert_array_equal(got, value)


def _bilinear_startup(pkg, shape):
    startup = pkg.Program()
    w = startup.global_block().create_var(name="w", shape=shape,
                                          dtype="float32", persistable=True)
    pkg.initializer.Bilinear()(w, startup.global_block())
    return startup


def _bilinear_program(pkg, shape):
    startup = _bilinear_startup(pkg, shape)
    exe = pkg.Executor(pkg.CPUPlace())
    scope = pkg.Scope()
    exe.run(startup, scope=scope)
    return np.asarray(scope.find_var("w").get_tensor())


@pytest.mark.parametrize("shape", [(2, 3, 4, 4), (1, 1, 3, 5), (4, 2, 6, 6)],
                         ids=str)
def test_bilinear_initializer_is_exact(shape):
    ops = [[(op.type, op.outputs, op.attrs)
            for op in _bilinear_startup(pkg, shape).global_block().ops]
           for pkg in (fluid, jfluid)]
    assert ops[0] == ops[1] and ops[0][0][0] == "assign_value"
    got = _bilinear_program(fluid, shape)
    np.testing.assert_array_equal(got, _bilinear_program(jfluid, shape))
    assert got.shape == shape and np.isfinite(got).all()
    assert (got > 0).any() and (got <= 1).all()


def _check_truncated(v, mean, std):
    assert v.shape == SHAPE and v.dtype == np.float32
    assert (v > mean - 2 * std).all() and (v < mean + 2 * std).all()
    se = TRUNC_STD * std / math.sqrt(N)
    assert abs(v.mean() - mean) < MEAN_SIGMAS * se
    assert abs(v.std() / (TRUNC_STD * std) - 1) < STD_RTOL
    z = np.sort((v.reshape(-1) - mean) / std)
    grid = z[:: N // 2000]
    emp = np.searchsorted(z, grid, side="right") / N
    assert np.abs(emp - _trunc_cdf(grid)).max() < KS_LIMIT


@pytest.mark.parametrize("pkg", [fluid, jfluid], ids=["port", "jax"])
def test_truncated_normal_draws_the_distribution(pkg):
    _check_truncated(drawn(pkg, INITS["truncated_normal"]), 0.5, 2.0)
    _check_truncated(drawn(pkg, INITS["truncated_normal_seeded"]), 0.0,
                     0.02)


@pytest.mark.parametrize("pkg", [fluid, jfluid], ids=["port", "jax"])
def test_msra_draws_the_distribution(pkg):
    fan_in = SHAPE[0]
    u = drawn(pkg, INITS["msra_uniform"])
    limit = math.sqrt(6.0 / fan_in)
    assert (np.abs(u) <= limit).all()
    assert abs(u.std() / (limit / math.sqrt(3)) - 1) < STD_RTOL
    n = drawn(pkg, INITS["msra_normal"])
    std = math.sqrt(2.0 / 50)
    assert abs(n.std() / std - 1) < STD_RTOL
    assert abs(n.mean()) < MEAN_SIGMAS * std / math.sqrt(N)


def _op_draw(seed, shape=SHAPE, mean=0.0, std=1.0):
    info = OpInfoMap.instance().get("truncated_gaussian_random")
    attrs = dict(info.attrs)
    attrs.update({"shape": list(shape), "mean": mean, "std": std,
                  DEVICE_ATTR: torch.device("cpu")})
    gen = torch.Generator()
    gen.manual_seed(seed)
    attrs[GENERATOR_ATTR] = gen
    return info.fn({}, attrs)["Out"].numpy()


def test_truncated_gaussian_random_op_draws_from_its_generator():
    a, b, c = _op_draw(3), _op_draw(3), _op_draw(4)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
    _check_truncated(_op_draw(5, mean=-1.0, std=0.5), -1.0, 0.5)
    assert _op_draw(6, shape=(3, 2)).shape == (3, 2)


def test_the_short_aliases_and_force_init_on_cpu():
    I = fluid.initializer
    for alias, cls in (("Constant", "ConstantInitializer"),
                       ("Uniform", "UniformInitializer"),
                       ("Normal", "NormalInitializer"),
                       ("TruncatedNormal", "TruncatedNormalInitializer"),
                       ("Xavier", "XavierInitializer"),
                       ("MSRA", "MSRAInitializer"),
                       ("Bilinear", "BilinearInitializer")):
        assert getattr(I, alias) is getattr(I, cls)
        assert hasattr(jfluid.initializer, alias)
    assert I.force_init_on_cpu() is jfluid.initializer.force_init_on_cpu() \
        is False
