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
- The card's float32 arithmetic, emulated: 3xTF32 products summed in
  groups of one 32-channel step from zero (toward zero, as the tensor
  cores round) and added to the running sum in float32 stay within 2e-5
  of the output's scale of the plain version at K 4608 and 1024; one TF32
  pass does not.
- ``choose_tile`` gives each of ResNet-50's 19 routed shapes a tile
  configuration, and Cout 64 a 64-wide one.
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


# The card's K5 runs float32 products as 3xTF32 on mma.sync.m16n8k8:
# hi = tf32(x) rounded to nearest, lo = x - hi cut to tf32 toward zero by
# the tensor cores; the products of one 32-channel step (four depth steps
# of 8: lo*hi, hi*lo, hi*hi each) sum from zero into a partial, each mma
# rounding its sum toward zero, and the partial joins the running sum by a
# float32 add (to nearest). The emulation below repeats that order on the
# im2col matrix, with each mma's sum taken exactly and then rounded.
F32_LIMIT = 2e-5
GROUP, DEPTH = 32, 8


def _tf32(x):
    """float32 rounded to TF32 (10 mantissa bits), to nearest, ties away
    from zero, as ``cvt.rna.tf32.f32`` gives."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _tf32_toward_zero(x):
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def _float32_toward_zero(x64):
    f = x64.to(torch.float32)
    over = f.to(torch.float64).abs() > x64.abs()
    return torch.where(over, torch.nextafter(f, torch.zeros_like(f)), f)


def _im2col(x, KH, KW, stride, pad):
    """[B*H_out*W_out, KH*KW*Cin], taps in w's row order."""
    B, H, W, Cin = x.shape
    Ho = (H + 2 * pad - KH) // stride + 1
    Wo = (W + 2 * pad - KW) // stride + 1
    xp = torch.nn.functional.pad(x, (0, 0, pad, pad, pad, pad))
    cols = [xp[:, r:r + (Ho - 1) * stride + 1:stride,
               c:c + (Wo - 1) * stride + 1:stride, :].reshape(-1, Cin)
            for r in range(KH) for c in range(KW)]
    return torch.cat(cols, dim=1)


def _emulated_conv(x, w, stride, pad, passes):
    KH, KW, Cin, Cout = w.shape
    a = _im2col(x, KH, KW, stride, pad)
    b = w.reshape(KH * KW * Cin, Cout)
    acc = torch.zeros(a.shape[0], Cout, dtype=torch.float32)
    for g0 in range(0, b.shape[0], GROUP):
        part = torch.zeros_like(acc)
        for k in range(g0, g0 + GROUP, DEPTH):
            ak, bk = a[:, k:k + DEPTH], b[k:k + DEPTH]
            ah, bh = _tf32(ak), _tf32(bk)
            terms = [(ah, bh)]
            if passes == 3:
                terms = [(_tf32_toward_zero(ak - ah), bh),
                         (ah, _tf32_toward_zero(bk - bh)), (ah, bh)]
            for p, q in terms:
                part = _float32_toward_zero(
                    part.double() + p.double() @ q.double())
        acc = acc + part
    B, H, W, _ = x.shape
    return acc.reshape(B, (H + 2 * pad - KH) // stride + 1,
                       (W + 2 * pad - KW) // stride + 1, Cout)


@pytest.mark.parametrize("x_shape,w_shape,pad", [
    ((2, 7, 7, 512), (3, 3, 512, 512), 1),      # K 4608
    ((2, 14, 14, 1024), (1, 1, 1024, 256), 0),  # K 1024
])
def test_3xtf32_conv_keeps_the_float32_limit_and_one_pass_does_not(
        x_shape, w_shape, pad):
    rng = np.random.RandomState(x_shape[-1] + w_shape[0])
    KH, KW, Cin, _ = w_shape
    x = torch.from_numpy(rng.randn(*x_shape).astype("float32"))
    w = torch.from_numpy((rng.randn(*w_shape)
                          * (2.0 / (KH * KW * Cin)) ** 0.5).astype("float32"))
    want = k5.conv2d_bn_act_reference(x, w, stride=1, padding=pad)
    limit = F32_LIMIT * float(want.abs().max())

    def error(passes):
        return float((_emulated_conv(x, w, 1, pad, passes) - want)
                     .abs().max())

    assert error(3) <= limit
    assert error(1) > limit


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_every_resnet50_shape_gets_a_tile_and_cout_64_a_narrow_one(dtype):
    shapes = {c[:4] for c in _resnet50_convs()
              if k5.route_pallas("all", *c[:3], *c[4:])}
    assert len(shapes) == 19
    chosen = {}
    for x, w, stride, pad in shapes:
        B, H, W, _ = x
        M = B * k5.output_size(H, w[0], stride, pad) * k5.output_size(
            W, w[1], stride, pad)
        tile = k5.choose_tile(M, w[3], dtype)
        assert tile in range(len(k5.TILES))
        bm, bn = k5.TILES[tile]
        chosen[(M, w[3])] = (bm, bn)
        if w[3] == 64:
            assert bn == 64
        # no shape leaves a block's worth of columns idle
        assert -(-w[3] // bn) * bn - w[3] < bn
    # float32's 196 blocks of 128x128 at M 6,272 by N 512 take 64-row ones
    assert chosen[(6272, 512)] == ((64, 128) if dtype == torch.float32
                                   else (128, 128))
    assert chosen[(401408, 128)] == (128, 128)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,N", [(1, 1), (1, 130), (98, 3), (401408, 64),
                                 (6272, 2048), (10 ** 7, 4096)])
def test_choose_tile_takes_any_size(M, N, dtype):
    assert k5.choose_tile(M, N, dtype) in range(len(k5.TILES))


def test_a_tile_outside_the_table_raises_on_the_card_path():
    with pytest.raises(ValueError, match="tile"):
        k5._launch(torch.zeros(1, 4, 4, 128), torch.zeros(1, 1, 128, 8),
                   None, None, 1, 0, False, None, len(k5.TILES))
