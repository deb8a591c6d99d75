"""K5, the fused implicit-GEMM conv, on the CPU: the port's plain version
against the JAX package's Pallas kernel in interpret mode.

- ``conv2d_bn_act_reference`` (what a CPU tensor runs) against
  ``paddle_tpu.ops.pallas.conv.conv2d_bn_act(..., interpret=True)`` over
  Cin 128 and 256, 1x1 and 3x3, stride 1 and 2, padding 0 and 1, with and
  without scale/shift, residual and relu. Tolerance 1e-5 of the output's
  largest magnitude: both sum KH * KW float32 products, in other orders.
- ``pallas_conv``'s backward (torch's conv gradients) against ``jax.vjp``
  of the JAX ``pallas_conv`` (XLA's conv transposes), 1e-5 of each grad's
  largest magnitude.
- ``route_pallas`` / ``pallas_conv_viable`` against the JAX copies over
  ResNet-50's 53 NHWC convs (0 / 13 / 44 routed under off / auto / all,
  19 distinct routed shapes) and shapes no route takes.
- Shapes outside the kernel's scope raise, on any device.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.ops.pallas import conv as jconv
from paddle_tpu.ops.pallas.support import pallas_supported
from paddle_tpu_torch.models.resnet import build_resnet_train
from paddle_tpu_torch.ops.cuda import conv as k5

TOL = 1e-5


@pytest.fixture
def interpret():
    if not pallas_supported(interpret=True):
        pytest.skip("pallas interpret mode unavailable on this backend")


def _inputs(seed, B, H, W, Cin, K, Cout, stride, pad, affine, residual):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, H, W, Cin).astype("float32")
    w = (rng.randn(K, K, Cin, Cout) * (2.0 / (K * K * Cin)) ** 0.5).astype(
        "float32")
    sc = (rng.rand(Cout) + 0.5).astype("float32") if affine else None
    sh = rng.randn(Cout).astype("float32") if affine else None
    Ho = (H + 2 * pad - K) // stride + 1
    Wo = (W + 2 * pad - K) // stride + 1
    r = (rng.randn(B, Ho, Wo, Cout).astype("float32") if residual
         else None)
    return x, w, sc, sh, r


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


CASES = [
    # (B, H, W, Cin, K, Cout, stride, pad, affine, residual, relu)
    (2, 8, 8, 128, 1, 64, 1, 0, False, False, False),
    (2, 8, 8, 128, 3, 128, 1, 1, True, False, True),
    (2, 9, 7, 128, 3, 96, 2, 1, True, True, True),
    (1, 8, 8, 256, 1, 130, 2, 0, True, True, False),
    (2, 6, 6, 128, 3, 64, 1, 0, False, True, True),
    (2, 8, 8, 256, 3, 64, 2, 0, False, False, False),
    (3, 5, 5, 128, 1, 256, 1, 1, True, False, False),
]


@pytest.mark.parametrize("case", CASES)
def test_plain_version_matches_the_pallas_kernel(interpret, case):
    *shape, relu = case
    x, w, sc, sh, r = _inputs(len(shape), *shape)
    stride, pad = shape[6], shape[7]
    want = np.asarray(jconv.conv2d_bn_act(
        _j(x), _j(w), _j(sc), _j(sh), stride=stride, padding=pad,
        relu=relu, residual=_j(r), interpret=True))
    got = k5.conv2d_bn_act(_t(x), _t(w), _t(sc), _t(sh), stride=stride,
                           padding=pad, relu=relu, residual=_t(r)).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=TOL * np.abs(want).max())


@pytest.mark.parametrize("K,stride,pad", [(1, 1, 0), (3, 1, 1), (1, 2, 0),
                                          (3, 2, 1)])
def test_backward_matches_jax_vjp(interpret, K, stride, pad):
    x, w, _, _, _ = _inputs(K + stride, 2, 8, 8, 128, K, 128, stride, pad,
                            False, False)
    y, vjp = jax.vjp(lambda a, b: jconv.pallas_conv(a, b, stride, pad),
                     _j(x), _j(w))
    g = np.random.RandomState(7).randn(*y.shape).astype("float32")
    jdx, jdw = vjp(_j(g))
    xt = _t(x).requires_grad_(True)
    wt = _t(w).requires_grad_(True)
    out = k5.pallas_conv(xt, wt, stride, pad)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(y), rtol=0,
                               atol=TOL * np.abs(np.asarray(y)).max())
    dx, dw = torch.autograd.grad(out, (xt, wt), _t(g))
    for got, want in ((dx, jdx), (dw, jdw)):
        want = np.asarray(want)
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=TOL * np.abs(want).max())


def _resnet50_convs():
    main, _, _ = build_resnet_train(128)
    block = main.global_block()
    out = []
    for op in block.ops:
        if op.type != "conv2d":
            continue
        x = block.var(op.input("Input")[0]).shape
        w = block.var(op.input("Filter")[0]).shape
        out.append((tuple(x), (w[2], w[3], w[1], w[0]),
                    op.attrs["strides"][0], op.attrs["paddings"][0],
                    op.attrs["groups"], op.attrs["dilations"],
                    op.attrs["data_format"]))
    return out


def test_routing_matches_the_jax_package_over_resnet50():
    convs = _resnet50_convs()
    assert len(convs) == 53
    routed = {}
    for mode in ("off", "auto", "all"):
        decisions = []
        for x, w, s, _, g, d, fmt in convs:
            got = k5.route_pallas(mode, x, w, s, g, d, fmt)
            assert got == jconv.route_pallas(mode, x, w, s, g, d, fmt)
            assert k5.pallas_conv_viable(x, w, s, g, d, fmt) == \
                jconv.pallas_conv_viable(x, w, s, g, d, fmt)
            decisions.append(got)
        routed[mode] = [c for c, r in zip(convs, decisions) if r]
    assert [len(routed[m]) for m in ("off", "auto", "all")] == [0, 13, 44]
    shapes = {c[:4] for c in routed["all"]}
    assert len(shapes) == 19
    assert {(w[0], s) for _, w, s, _ in shapes} == {(1, 1), (1, 2), (3, 1),
                                                    (3, 2)}
    # the nine convs that stay on the library: the stem and Cin 64
    unrouted = [c for c in convs if c not in routed["all"]]
    assert sorted({c[1][2] for c in unrouted}) == [3, 64]


@pytest.mark.parametrize("x,w,stride,groups,dil,fmt", [
    ((8, 56, 56, 3), (7, 7, 3, 64), 2, 1, [1, 1], "NHWC"),       # stem
    ((8, 14, 14, 256), (3, 3, 128, 256), 1, 2, [1, 1], "NHWC"),  # groups
    ((8, 14, 14, 256), (3, 3, 256, 256), 1, 1, [2, 2], "NHWC"),  # dilated
    ((8, 256, 14, 14), (3, 3, 256, 256), 1, 1, [1, 1], "NCHW"),  # layout
    ((8, 14, 14, 256), (3, 3, 256, 256), 3, 1, [1, 1], "NHWC"),  # stride 3
    ((8, 14, 14, 256), (5, 5, 256, 256), 1, 1, [1, 1], "NHWC"),  # 5x5
    ((8, 14, 14, 256), (1, 3, 256, 256), 1, 1, [1, 1], "NHWC"),  # 1x3
    ((8, 14, 14, 192), (1, 1, 192, 384), 1, 1, [1, 1], "NHWC"),  # Cin 192
])
def test_shapes_no_route_takes(x, w, stride, groups, dil, fmt):
    for mode in ("off", "auto", "all"):
        assert not k5.route_pallas(mode, x, w, stride, groups, dil, fmt)
        assert not jconv.route_pallas(mode, x, w, stride, groups, dil, fmt)
    assert not k5.pallas_conv_viable(x, w, stride, groups, dil, fmt)


def test_stride_3_raises_as_in_the_jax_package():
    x = torch.zeros(1, 9, 9, 128)
    w = torch.zeros(3, 3, 128, 128)
    with pytest.raises(ValueError, match="stride 1 or 2"):
        k5.conv2d_bn_act(x, w, stride=3)
    with pytest.raises(ValueError, match="stride 1 or 2"):
        jconv.conv2d_bn_act(jnp.zeros((1, 9, 9, 128)),
                            jnp.zeros((3, 3, 128, 128)), stride=3,
                            interpret=True)


@pytest.mark.parametrize("x,w,kw,match", [
    ((1, 8, 8, 64), (3, 3, 64, 128), {}, "Cin % 128"),
    ((1, 8, 8, 128), (5, 5, 128, 128), {}, "1x1 or 3x3"),
    ((1, 8, 8, 128), (1, 3, 128, 128), {}, "1x1 or 3x3"),
    ((1, 8, 8, 128), (3, 3, 256, 128), {}, "filter's Cin"),
    ((8, 8, 128), (3, 3, 128, 128), {}, r"\[B, H, W, Cin\]"),
    ((1, 8, 8, 128), (3, 3, 128, 128), {"padding": -1}, "padding"),
    ((1, 2, 2, 128), (3, 3, 128, 128), {}, "empty output"),
    ((1, 8, 8, 128), (1, 1, 128, 64),
     {"residual": torch.zeros(1, 8, 8, 32)}, "residual"),
])
def test_shapes_outside_the_scope_raise(x, w, kw, match):
    with pytest.raises(ValueError, match=match):
        k5.conv2d_bn_act(torch.zeros(x), torch.zeros(w), **kw)


def test_cpu_tensors_run_the_plain_version_and_launch_nothing(monkeypatch):
    calls = []
    plain = k5.conv2d_bn_act_reference
    monkeypatch.setattr(k5, "conv2d_bn_act_reference",
                        lambda *a, **kw: calls.append(1) or plain(*a, **kw))
    before = k5.LAUNCHES.value
    x, w, _, _, _ = _inputs(0, 1, 4, 4, 128, 1, 8, 1, 0, False, False)
    y = k5.pallas_conv(_t(x), _t(w), 1, 0)
    assert calls == [1] and k5.LAUNCHES.value == before
    assert y.shape == (1, 4, 4, 8)


def test_flags_table_matches_the_jax_package():
    from paddle_tpu.core import flags as jflags
    from paddle_tpu_torch.core import flags as pflags

    assert set(pflags._DEFS) == set(jflags._DEFS)
    for name, (default, _) in jflags._DEFS.items():
        assert pflags._DEFS[name][0] == default, name
