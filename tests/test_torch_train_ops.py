"""The training slice's op functions against the JAX op functions of the
same name, on the same numpy inputs: the new forward ops, the optimizer
updates, ``lookup_table_grad``, and the auto-VJP grad op of every op on
gpt_long's path (the port differentiates with ``torch.autograd``, the JAX
package with ``jax.vjp``).

Tolerances: float32 within 1e-5 (the same math, summed in another order).
The optimizer updates within 4 float32 ULP of the element's largest
operand or result (XLA may contract a product and a sum into one FMA
where eager torch rounds twice; tools/sc_smoke.py states the same bound).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.core.registry import OpInfoMap as JaxOps
from paddle_tpu_torch.core.registry import DEVICE_ATTR, OpInfoMap

CPU = torch.device("cpu")
RNG = np.random.RandomState(1)
TOL = 1e-5


def _f(*shape):
    return np.asarray(RNG.randn(*shape), dtype="float32")


def _to_jax(v):
    if v is None:
        return None
    if isinstance(v, list):
        return [_to_jax(x) for x in v]
    return jnp.asarray(v)


def _to_torch(v):
    if v is None:
        return None
    if isinstance(v, list):
        return [_to_torch(x) for x in v]
    return torch.from_numpy(np.array(v))


def _np(v):
    if v is None:
        return None
    if isinstance(v, list):
        return [_np(x) for x in v]
    return v.detach().numpy() if isinstance(v, torch.Tensor) \
        else np.asarray(v)


def _run(op_type, ins, attrs):
    jinfo = JaxOps.instance().get(op_type)
    jattrs = dict(jinfo.attrs)
    jattrs.update(attrs)
    j = jinfo.fn({k: _to_jax(v) for k, v in ins.items()}, jattrs)
    pinfo = OpInfoMap.instance().get(op_type)
    pattrs = dict(pinfo.attrs)
    pattrs.update(attrs)
    pattrs[DEVICE_ATTR] = CPU
    p = pinfo.fn({k: _to_torch(v) for k, v in ins.items()}, pattrs)
    return ({k: _np(v) for k, v in j.items()},
            {k: _np(v) for k, v in p.items()})


def _close(got, want, name, tol=TOL):
    if isinstance(want, list):
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g, w, "%s[%d]" % (name, i), tol)
        return
    assert got.shape == want.shape, name
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol, err_msg=name)


def test_the_training_slice_ops_are_registered():
    types = set(OpInfoMap.instance().all_op_types())
    assert {"softmax_with_cross_entropy", "mean", "sum", "sgd", "momentum",
            "adam", "adamw", "fused_optimizer", "lookup_table_grad",
            "flash_attention_grad", "mul_grad", "layer_norm_grad"} <= types
    # never differentiated, as in the JAX package
    assert not {"fill_constant_grad", "uniform_random_grad",
                "adam_grad", "lookup_table_grad_grad"} & types


@pytest.mark.parametrize("kind", ["hard", "ignore", "soft", "axis1"])
def test_softmax_with_cross_entropy(kind):
    logits = _f(6, 5)
    attrs, label = {}, RNG.randint(0, 5, (6, 1)).astype("int64")
    if kind == "ignore":
        label[2, 0] = -100
    if kind == "soft":
        label = np.abs(_f(6, 5))
        label /= label.sum(-1, keepdims=True)
        attrs = {"soft_label": True}
    if kind == "axis1":
        logits = _f(2, 5, 3)
        label = RNG.randint(0, 5, (2, 3, 1)).astype("int64")
        attrs = {"axis": 1}
    j, p = _run("softmax_with_cross_entropy",
                {"Logits": logits, "Label": label}, attrs)
    for slot in ("Softmax", "Loss"):
        _close(p[slot], j[slot], slot)
    if kind == "ignore":
        assert p["Loss"][2, 0] == 0


def test_mean_and_sum():
    x = _f(3, 4)
    j, p = _run("mean", {"X": x}, {})
    _close(p["Out"], j["Out"], "mean")
    xs = [_f(3, 4) for _ in range(3)]
    j, p = _run("sum", {"X": xs}, {})
    _close(p["Out"], j["Out"], "sum")


@pytest.mark.parametrize("padding_idx", [-1, 2])
def test_lookup_table_grad(padding_idx):
    w = _f(7, 4)
    ids = np.array([[0, 2, 6], [2, -1, 9]], dtype="int64")[..., None]
    og = _f(2, 3, 4)
    j, p = _run("lookup_table_grad",
                {"W": w, "Ids": ids, "Out@GRAD": og},
                {"padding_idx": padding_idx})
    _close(p["W@GRAD"], j["W@GRAD"], "W@GRAD")
    # -1 counts from the end (row 6); 9 is out of range and dropped
    want6 = og[0, 2] + og[1, 1]
    np.testing.assert_allclose(p["W@GRAD"][6], want6, rtol=TOL, atol=TOL)


def _ulps(got, want, operands):
    scale = np.abs(want)
    for x in operands:
        scale = np.maximum(scale, np.abs(x))
    return float((np.abs(got.astype(np.float64) - want)
                  / np.spacing(scale.astype(np.float32))).max())


@pytest.mark.parametrize("op_type,attrs", [
    ("sgd", {}), ("momentum", {"mu": 0.9}),
    ("momentum", {"mu": 0.9, "use_nesterov": True}),
    ("adam", {}), ("adamw", {"weight_decay": 0.02})])
def test_optimizer_ops(op_type, attrs):
    p, g, m1 = _f(33, 7), _f(33, 7), _f(33, 7)
    m2 = np.abs(_f(33, 7))
    ins = {"Param": p, "Grad": g,
           "LearningRate": np.array([0.01], "float32")}
    if op_type == "momentum":
        ins["Velocity"] = m1
    if op_type in ("adam", "adamw"):
        ins.update(Moment1=m1, Moment2=m2,
                   Beta1Pow=np.array([0.81], "float32"),
                   Beta2Pow=np.array([0.998], "float32"))
    j, pt = _run(op_type, ins, attrs)
    assert set(pt) == set(j)
    for slot in j:
        assert _ulps(pt[slot], j[slot], [p, g, m1, m2]) <= 4, slot


def _grad_case(op_type, ins, attrs, out_slots):
    """Run ``<op_type>_grad`` in both packages with random output grads
    for ``out_slots`` and compare every input grad produced."""
    jf = JaxOps.instance().get(op_type).fn
    fwd = jf({k: _to_jax(v) for k, v in ins.items()}, dict(attrs))
    gins = dict(ins)
    for slot in out_slots:
        gins[slot + "@GRAD"] = _f(*np.shape(fwd[slot]))
    j, p = _run(op_type + "_grad", gins, attrs)
    assert set(p) == set(j) and p, (sorted(p), sorted(j))
    for slot in j:
        _close(p[slot], j[slot], slot)


@pytest.mark.parametrize("case", [
    "mul", "elementwise_add_bcast", "gelu", "layer_norm", "reshape2",
    "transpose2", "softmax_with_cross_entropy", "mean", "sum",
    "flash_attention"])
def test_auto_vjp_grad_ops(case):
    if case == "mul":
        _grad_case("mul", {"X": _f(2, 3, 4), "Y": _f(4, 5)},
                   {"x_num_col_dims": 2}, ["Out"])
    elif case == "elementwise_add_bcast":
        _grad_case("elementwise_add", {"X": _f(2, 3, 4), "Y": _f(4)},
                   {"axis": 2}, ["Out"])
    elif case == "gelu":
        _grad_case("gelu", {"X": _f(3, 5)}, {}, ["Out"])
    elif case == "layer_norm":
        _grad_case("layer_norm", {"X": _f(2, 3, 4), "Scale": _f(12),
                                  "Bias": _f(12)},
                   {"begin_norm_axis": 1}, ["Y"])
    elif case == "reshape2":
        _grad_case("reshape2", {"X": _f(2, 2, 3)}, {"shape": [3, 0, 2]},
                   ["Out"])
    elif case == "transpose2":
        _grad_case("transpose2", {"X": _f(2, 3, 4)}, {"axis": [2, 0, 1]},
                   ["Out"])
    elif case == "softmax_with_cross_entropy":
        _grad_case("softmax_with_cross_entropy",
                   {"Logits": _f(6, 5),
                    "Label": RNG.randint(0, 5, (6, 1)).astype("int64")},
                   {}, ["Loss"])
    elif case == "mean":
        _grad_case("mean", {"X": _f(3, 4)}, {}, ["Out"])
    elif case == "sum":
        _grad_case("sum", {"X": [_f(3, 2), _f(3, 2)]}, {}, ["Out"])
    else:
        _grad_case("flash_attention",
                   {"Q": _f(2, 2, 8, 16), "K": _f(2, 2, 8, 16),
                    "V": _f(2, 2, 8, 16)}, {"causal": True}, ["Out"])
