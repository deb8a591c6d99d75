"""The dygraph ``nn`` tail in the port against the JAX package, on the CPU.

Each of the 13 Layers (``Conv2DTranspose``, ``GRUUnit``, ``PRelu``,
``GroupNorm``, ``InstanceNorm``, ``Conv3D``, ``Conv3DTranspose``,
``BilinearTensorProduct``, ``NCE``, ``SequenceConv``, ``RowConv``,
``SpectralNorm``, ``TreeConv``) is built in both packages with the same
arguments; the JAX layer's parameters go into the port's by name
(``set_dict`` over ``state_dict``); the same numpy-seeded inputs go
through both; the forward and, after ``reduce_sum(out).backward()``, every
parameter's and input's grad must agree. ``NCE`` runs with fixed
negatives (``custom_neg_classes``), its sampler held by a distribution
test; ``TreeConv``'s op runs on the host in both packages and takes no
grad, so only its bias has one. Then each layer's state crosses back into
a second JAX layer by name and answers as the first.

Tolerances: 1e-5 relative and 1e-5 absolute of each tensor's scale (the
largest magnitude, at least 1): the same float32 math in another order
(XLA's convolutions and reductions against torch's).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as fluid

RTOL = 1e-5
NEGS = [3, 7, 11, 0, 19]


def _f(rng, *shape):
    return rng.randn(*shape).astype("float32")


def _edges():
    return np.array([[[1, 2], [1, 3], [3, 4], [3, 5], [0, 0]]], "int32")


# name -> (constructor kwargs, inputs from a RandomState, which inputs
# take a grad)
CASES = {
    "Conv2DTranspose": (dict(num_channels=3, num_filters=4, filter_size=3,
                             stride=2, padding=1, act="relu"),
                        lambda r: [_f(r, 2, 3, 5, 5)], [0]),
    "GRUUnit": (dict(size=12), lambda r: [_f(r, 3, 12), _f(r, 3, 4)],
                [0, 1]),
    "PRelu": (dict(mode="channel", channel=3),
              lambda r: [_f(r, 2, 3, 4, 4)], [0]),
    "GroupNorm": (dict(channels=6, groups=3, act="tanh"),
                  lambda r: [_f(r, 2, 6, 3, 3)], [0]),
    "InstanceNorm": (dict(num_channels=3), lambda r: [_f(r, 2, 3, 4, 5)],
                     [0]),
    "Conv3D": (dict(num_channels=2, num_filters=3, filter_size=3, padding=1,
                    act="relu"), lambda r: [_f(r, 1, 2, 4, 4, 4)], [0]),
    "Conv3DTranspose": (dict(num_channels=2, num_filters=3, filter_size=2,
                             stride=2), lambda r: [_f(r, 1, 2, 3, 3, 3)],
                        [0]),
    "BilinearTensorProduct": (dict(input1_dim=3, input2_dim=4, output_dim=5,
                                   act="sigmoid"),
                              lambda r: [_f(r, 2, 3), _f(r, 2, 4)], [0, 1]),
    "NCE": (dict(num_total_classes=20, dim=6, num_neg_samples=len(NEGS)),
            lambda r: [_f(r, 4, 6), np.array([[1], [2], [3], [4]], "int64")],
            [0]),
    "SequenceConv": (dict(num_filters=5, filter_size=3, input_dim=4,
                          act="tanh"), lambda r: [_f(r, 6, 4)], [0]),
    "RowConv": (dict(future_context_size=2, input_dim=4),
                lambda r: [_f(r, 2, 6, 4)], [0]),
    "SpectralNorm": (dict(weight_shape=[4, 6], dim=0, power_iters=3),
                     lambda r: [_f(r, 4, 6)], [0]),
    "TreeConv": (dict(feature_size=4, output_size=3, num_filters=2,
                      max_depth=2),
                 lambda r: [_f(r, 1, 5, 4), _edges()], []),
}


def _run(pkg, name, state=None, place=None):
    """(outputs, {param name: grad}, [input grads], state dict) of one
    forward and backward of the layer."""
    kwargs, make, grads_of = CASES[name]
    guard = pkg.dygraph.guard(place) if place else pkg.dygraph.guard()
    with guard:
        layer = getattr(pkg.dygraph, name)(**kwargs)
        if name == "NCE":
            layer._attrs["custom_neg_classes"] = list(NEGS)
        if state is not None:
            layer.set_dict(state)
        arrays = make(np.random.RandomState(7))
        ins = []
        for i, a in enumerate(arrays):
            v = pkg.dygraph.to_variable(a)
            v.stop_gradient = i not in grads_of
            ins.append(v)
        out = layer(*ins)
        outs = list(out) if isinstance(out, tuple) else [out]
        loss = pkg.layers.reduce_sum(outs[0])
        loss.backward()
        pgrads = {k: np.asarray(p.gradient())
                  for k, p in layer.state_dict().items()
                  if not p.stop_gradient and p.gradient() is not None}
        igrads = [np.asarray(ins[i].gradient()) for i in grads_of]
        st = {k: np.asarray(p.numpy()) for k, p in
              layer.state_dict().items()}
        return [np.asarray(o.numpy()) for o in outs], pgrads, igrads, st


def _close(got, want, what):
    scale = max(float(np.abs(want).max(initial=0.0)), 1.0)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * scale,
                               err_msg=what)


@pytest.mark.parametrize("name", sorted(CASES))
def test_layer_forward_and_grads_match_the_jax_layer(name):
    jouts, jp, ji, jstate = _run(jfluid, name)
    outs, pg, ig, state = _run(fluid, name, state=jstate,
                               place=fluid.CPUPlace())
    assert sorted(state) == sorted(jstate)
    for k in state:
        np.testing.assert_array_equal(state[k], jstate[k])
    assert len(outs) == len(jouts)
    for o, jo in zip(outs, jouts):
        assert o.shape == jo.shape
        _close(o, jo, "%s forward" % name)
    assert sorted(pg) == sorted(jp), (sorted(pg), sorted(jp))
    for k in pg:
        _close(pg[k], jp[k], "%s grad of %s" % (name, k))
    for g, jg in zip(ig, ji):
        _close(g, jg, "%s input grad" % name)
    # and back: the port's state by name into a second JAX layer
    jouts2, _, _, _ = _run(jfluid, name, state=state)
    for o, jo in zip(jouts2, jouts):
        _close(o, jo, "%s state back into the JAX layer" % name)


def test_the_tail_is_exported_with_the_jax_names():
    from paddle_tpu.dygraph import nn as jnn
    from paddle_tpu_torch.dygraph import nn as pnn

    assert set(jnn.__all__) <= set(pnn.__all__)
    for name in CASES:
        assert getattr(fluid.dygraph, name) is getattr(pnn, name)


@pytest.mark.parametrize("sampler", [0, 1])
def test_nce_sampler_draws_its_distribution(sampler):
    """The uniform and log-uniform samplers (math/sampler.cc) against their
    probabilities: 200,000 draws over 20 classes, each class's frequency
    within 5 standard errors of its probability."""
    from paddle_tpu_torch.ops.nn_tail_ops import sample_negatives

    C, n = 20, 200_000
    gen = torch.Generator().manual_seed(3)
    draws = sample_negatives(gen, sampler, n, 1, C, None,
                             torch.device("cpu")).reshape(-1).numpy()
    if sampler == 0:
        classes, p = C, np.full(C, 1.0 / C)
    else:  # range C - 1
        classes = C - 1
        k = np.arange(classes)
        p = np.log((k + 2.0) / (k + 1.0)) / np.log(classes + 1.0)
        p = p / p.sum()
    assert draws.min() >= 0 and draws.max() < classes
    freq = np.bincount(draws, minlength=classes) / n
    se = np.sqrt(p * (1 - p) / n)
    assert np.all(np.abs(freq - p) < 5 * se), np.abs(freq - p) / se
