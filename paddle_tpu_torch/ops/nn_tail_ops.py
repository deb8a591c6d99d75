"""The ops of the dygraph ``nn`` tail, in torch.

Counterparts of the JAX package's ``conv2d_transpose`` and ``conv3d``
(``paddle_tpu/ops/conv_ops.py``), ``conv3d_transpose``
(``tail_ops2.py``), ``prelu`` (``activation_ops.py``), ``group_norm`` and
``instance_norm`` (``norm_ops.py``), ``bilinear_tensor_product``,
``row_conv`` and ``spectral_norm`` (``misc_ops.py``), ``nce``
(``nce_ops.py``) and ``tree_conv`` (``tree_ops.py``, a host op there and
here, with its ``tree_conv_grad``): the same slots, attrs and math. Each
but ``tree_conv`` is a plain torch function whose grad is the auto-VJP.
The JAX package computes the convolutions outside any Pallas kernel
(``lax.conv_general_dilated``); torch's convolutions compute them here.

``nce`` samples its negatives from the ``torch.Generator`` the executor
seeds for it (``GENERATOR_ATTR``), so the draws differ from
``jax.random``'s: the contract is the sampler's distribution, and with
``custom_neg_classes`` the cost itself.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..core.registry import (GENERATOR_ATTR, In, Out,
                             register_host_op, register_op)
from ..core.tensor import to_host_array
from .conv_ops import _CONV_ATTRS, _conv_pads, _norm_pads

# -- convolutions ---------------------------------------------------------------


@register_op(
    "conv3d",
    inputs=[In("Input"), In("Filter")],
    outputs=[Out("Output")],
    attrs={**_CONV_ATTRS, "strides": [1, 1, 1], "paddings": [0, 0, 0],
           "dilations": [1, 1, 1]},
)
def _conv3d(ins, attrs):
    """NCDHW with OIDHW filters; asymmetric pads are applied to the input
    first, as conv2d's."""
    data_format = attrs.get("data_format", "NCHW")
    if data_format not in ("NCHW", "AnyLayout", "NCDHW"):
        raise ValueError("conv3d: data_format %r (NCDHW only)"
                         % data_format)
    x, w = ins["Input"], ins["Filter"]
    strides = attrs.get("strides", [1, 1, 1])
    dilations = attrs.get("dilations", [1, 1, 1])
    pads = _conv_pads(x.shape[2:], w.shape[2:], strides,
                      attrs.get("paddings", [0, 0, 0]), dilations,
                      attrs.get("padding_algorithm", "EXPLICIT"))
    if any(lo != hi for lo, hi in pads):
        x = F.pad(x, [v for lo, hi in reversed(pads) for v in (lo, hi)])
        pads = [(0, 0)] * 3
    return {"Output": F.conv3d(x, w, None, tuple(strides),
                               tuple(lo for lo, _ in pads),
                               tuple(dilations), attrs.get("groups", 1))}


def _conv_transpose(x, w, strides, paddings, dilations, groups, nd):
    """The transposed convolution over NC<spatial> with w [in_c,
    out_c / groups, k...]: the JAX package's gradient-of-conv form (an
    lhs-dilated conv with the flipped kernel) is torch's conv_transpose
    with the same explicit padding on each side."""
    pads = _norm_pads(paddings, nd)
    lo = [p[0] for p in pads]
    hi = [p[1] for p in pads]
    fn = F.conv_transpose2d if nd == 2 else F.conv_transpose3d
    sym = [min(a, b) for a, b in zip(lo, hi)]
    out = fn(x, w, stride=tuple(strides), padding=tuple(sym),
             dilation=tuple(dilations), groups=groups)
    # an asymmetric padding crops one side more
    crop = [slice(None), slice(None)]
    for d in range(nd):
        extra_lo, extra_hi = lo[d] - sym[d], hi[d] - sym[d]
        crop.append(slice(extra_lo, out.shape[2 + d] - extra_hi))
    return out[tuple(crop)]


@register_op(
    "conv2d_transpose",
    inputs=[In("Input"), In("Filter")],
    outputs=[Out("Output")],
    attrs={**_CONV_ATTRS, "output_size": [], "output_padding": []},
)
def _conv2d_transpose(ins, attrs):
    return {"Output": _conv_transpose(
        ins["Input"], ins["Filter"], attrs.get("strides", [1, 1]),
        attrs.get("paddings", [0, 0]), attrs.get("dilations", [1, 1]),
        attrs.get("groups", 1), 2)}


@register_op(
    "conv3d_transpose",
    inputs=[In("Input"), In("Filter")],
    outputs=[Out("Output")],
    attrs={"strides": [1, 1, 1], "paddings": [0, 0, 0],
           "dilations": [1, 1, 1], "groups": 1, "use_cudnn": True,
           "data_format": "NCHW"},
)
def _conv3d_transpose(ins, attrs):
    return {"Output": _conv_transpose(
        ins["Input"], ins["Filter"], attrs.get("strides", [1, 1, 1]),
        attrs.get("paddings", [0, 0, 0]), attrs.get("dilations", [1, 1, 1]),
        attrs.get("groups", 1), 3)}


# -- activation and normalizations ----------------------------------------------


@register_op("prelu", inputs=[In("X"), In("Alpha")], outputs=[Out("Out")],
             attrs={"mode": "all"})
def _prelu(ins, attrs):
    x, alpha = ins["X"], ins["Alpha"]
    mode = attrs.get("mode", "all")
    if mode == "channel":
        alpha = alpha.reshape((1, -1) + (1,) * (x.dim() - 2))
    elif mode == "all":
        alpha = alpha.reshape(())
    return {"Out": torch.where(x >= 0, x, alpha * x)}


def _scale_bias(y, ins, c, nd):
    shape = (1, c) + (1,) * (nd - 2)
    if ins.get("Scale") is not None:
        y = y * ins["Scale"].reshape(shape)
    if ins.get("Bias") is not None:
        y = y + ins["Bias"].reshape(shape)
    return y


@register_op(
    "instance_norm",
    inputs=[In("X"), In("Scale", dispensable=True),
            In("Bias", dispensable=True)],
    outputs=[Out("Y"), Out("SavedMean", no_grad=True),
             Out("SavedVariance", no_grad=True)],
    attrs={"epsilon": 1e-5},
)
def _instance_norm(ins, attrs):
    x = ins["X"]
    eps = attrs.get("epsilon", 1e-5)
    red = tuple(range(2, x.dim()))
    mean = x.mean(dim=red, keepdim=True)
    var = torch.square(x - mean).mean(dim=red, keepdim=True)
    inv = torch.rsqrt(var + eps)
    y = _scale_bias((x - mean) * inv, ins, x.shape[1], x.dim())
    n, c = x.shape[0], x.shape[1]
    return {"Y": y, "SavedMean": mean.reshape(n * c),
            "SavedVariance": inv.reshape(n * c)}


@register_op(
    "group_norm",
    inputs=[In("X"), In("Scale", dispensable=True),
            In("Bias", dispensable=True)],
    outputs=[Out("Y"), Out("Mean", no_grad=True),
             Out("Variance", no_grad=True)],
    attrs={"epsilon": 1e-5, "groups": 1, "data_layout": "NCHW"},
)
def _group_norm(ins, attrs):
    x = ins["X"]
    g = attrs.get("groups", 1)
    eps = attrs.get("epsilon", 1e-5)
    n, c = x.shape[0], x.shape[1]
    xg = x.reshape((n, g, c // g) + tuple(x.shape[2:]))
    red = tuple(range(2, xg.dim()))
    mean = xg.mean(dim=red, keepdim=True)
    var = torch.square(xg - mean).mean(dim=red, keepdim=True)
    y = ((xg - mean) * torch.rsqrt(var + eps)).reshape(x.shape)
    return {"Y": _scale_bias(y, ins, c, x.dim()),
            "Mean": mean.reshape(n, g), "Variance": var.reshape(n, g)}


# -- products and convolutions over rows ----------------------------------------


@register_op("bilinear_tensor_product",
             inputs=[In("X"), In("Y"), In("Weight"),
                     In("Bias", dispensable=True)],
             outputs=[Out("Out")])
def _bilinear_tensor_product(ins, attrs):
    x, y, w = ins["X"], ins["Y"], ins["Weight"]  # w: [size, dx, dy]
    out = torch.einsum("bi,oij,bj->bo", x, w, y)
    if ins.get("Bias") is not None:
        out = out + ins["Bias"].reshape(1, -1)
    return {"Out": out}


@register_op("row_conv", inputs=[In("X"), In("Filter")],
             outputs=[Out("Out")])
def _row_conv(ins, attrs):
    """Lookahead row convolution over [N, T, D] with a filter
    [future context + 1, D] (row_conv_op.cc, dense layout)."""
    x, f = ins["X"], ins["Filter"]
    out = torch.zeros_like(x)
    for k in range(f.shape[0]):
        shifted = F.pad(x[:, k:], (0, 0, 0, k))
        out = out + shifted * f[k][None, None, :]
    return {"Out": out}


@register_op("spectral_norm",
             inputs=[In("Weight"), In("U", no_grad=True),
                     In("V", no_grad=True)],
             outputs=[Out("Out"), Out("UOut", no_grad=True),
                      Out("VOut", no_grad=True)],
             attrs={"dim": 0, "power_iters": 1, "eps": 1e-12})
def _spectral_norm(ins, attrs):
    """Weight / sigma_max by power iteration (spectral_norm_op.h); u and v
    take no grad before sigma, as the reference's grad kernel treats the
    saved U and V as constants."""
    w = ins["Weight"]
    dim = int(attrs.get("dim", 0))
    eps = attrs.get("eps", 1e-12)
    mat = torch.movedim(w, dim, 0).reshape(w.shape[dim], -1)
    u, v = ins["U"].reshape(-1), ins["V"].reshape(-1)
    for _ in range(int(attrs.get("power_iters", 1))):
        v = mat.T @ u
        v = v / (torch.linalg.vector_norm(v) + eps)
        u = mat @ v
        u = u / (torch.linalg.vector_norm(u) + eps)
    u, v = u.detach(), v.detach()
    sigma = u @ mat @ v
    return {"Out": w / (sigma + eps), "UOut": u, "VOut": v}


# -- nce ------------------------------------------------------------------------


def sample_negatives(gen, sampler, num_neg, batch, num_classes, probs,
                     device):
    """math/sampler.cc: 0 uniform, 1 log-uniform (P(k) =
    log((k+2)/(k+1)) / log(range+1), range = classes - 1), 2 a custom
    distribution (``probs``)."""
    if sampler == 0:
        return torch.randint(0, num_classes, (batch, num_neg),
                             generator=gen, device=device)
    if sampler == 1:
        rng_range = num_classes - 1
        u = torch.rand((batch, num_neg), generator=gen, device=device)
        val = (torch.exp(u * math.log(rng_range + 1.0)) - 1.0).to(
            torch.int64)
        return torch.remainder(val, rng_range)
    return torch.multinomial(probs.reshape(-1).float(), batch * num_neg,
                             replacement=True, generator=gen).reshape(
                                 batch, num_neg)


def _sampler_prob(sampler, targets, num_classes, probs):
    if sampler == 0:
        return torch.full(targets.shape, 1.0 / num_classes,
                          dtype=torch.float32, device=targets.device)
    if sampler == 1:
        k = targets.to(torch.float32)
        return torch.log((k + 2.0) / (k + 1.0)) / math.log(num_classes)
    return probs.reshape(-1)[targets]


@register_op(
    "nce",
    inputs=[In("Input"), In("Label", no_grad=True), In("Weight"),
            In("Bias", dispensable=True),
            In("SampleWeight", dispensable=True, no_grad=True),
            In("CustomDistProbs", dispensable=True, no_grad=True),
            In("CustomDistAlias", dispensable=True, no_grad=True),
            In("CustomDistAliasProbs", dispensable=True, no_grad=True)],
    outputs=[Out("Cost"), Out("SampleLogits", no_grad=True),
             Out("SampleLabels", no_grad=True)],
    attrs={"num_total_classes": 0, "num_neg_samples": 10, "seed": 0,
           "sampler": 0, "custom_neg_classes": [], "is_sparse": False,
           "remote_prefetch": False},
    needs_rng=True,
)
def _nce(ins, attrs):
    """nce_op.h NCEKernel: o = sigmoid(x . w_t + b_t); the cost of a true
    class -log(o / (o + b)), of a sampled negative -log(b / (o + b)),
    b = sampler_prob(t) * negatives."""
    x = ins["Input"]
    label = ins["Label"].to(torch.int64)
    w = ins["Weight"]
    num_classes = int(attrs["num_total_classes"])
    sampler = int(attrs.get("sampler", 0))
    B = x.shape[0]
    num_true = label.shape[1] if label.dim() == 2 else 1
    label2d = label.reshape(B, num_true)
    probs = ins.get("CustomDistProbs")
    custom = list(attrs.get("custom_neg_classes") or [])
    if custom:
        negs = torch.tensor(custom, dtype=torch.int64,
                            device=x.device)[None, :].expand(B, len(custom))
    else:
        negs = sample_negatives(attrs.get(GENERATOR_ATTR), sampler,
                                int(attrs["num_neg_samples"]), B,
                                num_classes, probs, x.device)
    sample_labels = torch.cat([label2d, negs], dim=1)  # [B, T + S]
    logits = torch.einsum("bd,bsd->bs", x, w[sample_labels])
    if ins.get("Bias") is not None:
        logits = logits + ins["Bias"].reshape(-1)[sample_labels]
    o = torch.sigmoid(logits)
    b = _sampler_prob(sampler, sample_labels, num_classes, probs) * \
        float(negs.shape[1])
    is_true = torch.arange(sample_labels.shape[1],
                           device=x.device)[None, :] < num_true
    cost = torch.where(is_true, -torch.log(o / (o + b) + 1e-30),
                       -torch.log(b / (o + b) + 1e-30))
    sw = ins.get("SampleWeight")
    if sw is not None:
        cost = cost * sw.reshape(B, 1)
    return {"Cost": cost.sum(dim=1, keepdim=True), "SampleLogits": o,
            "SampleLabels": sample_labels}


# -- tree_conv (a host op) ------------------------------------------------------


def _construct_tree(edges):
    """Adjacency (1-indexed) and node count (tree2col.cc:54)."""
    node_count = sum(1 for u, v in edges if u != 0 and v != 0) + 1
    tr = [[] for _ in range(node_count + 2)]
    for u, v in edges:
        if u == 0 or v == 0:
            break
        tr[int(u)].append(int(v))
    return tr, node_count


def _construct_patch(root, max_depth, tr):
    """The DFS patch of (node, 1-based child index, siblings, depth)
    (tree2col.cc:21)."""
    stack = [(root, 1, 1, 0)]
    patch = [(root, 1, 1, 0)]
    visited = {root}
    while stack:
        node, _, _, depth = stack[-1]
        end = True
        kids = tr[node] if node < len(tr) else []
        for i, v in enumerate(kids):
            if v not in visited and depth + 1 < max_depth:
                visited.add(v)
                stack.append((v, i, len(kids), depth + 1))
                patch.append((v, i + 1, len(kids), depth + 1))
                end = False
        if end:
            stack.pop()
    return patch


def _etas(index, pclen, depth, max_depth):
    """tree2col.h:35-52."""
    eta_t = (max_depth - depth) / float(max_depth)
    temp = 0.5 if pclen == 1 else (index - 1.0) / (pclen - 1.0)
    eta_l = (1.0 - eta_t) * temp
    eta_r = (1.0 - eta_t) * (1.0 - eta_l)
    return eta_l, eta_r, eta_t


def _patch_matrix(f, edges, max_depth):
    """[nodes, F * 3], columns i * 3 + (l, r, t) (tree2col.cc:113-121),
    and the (row, node, etas) triples the grad scatters back through."""
    tr, node_count = _construct_tree(edges)
    rows, triples = [], []
    for u in range(1, node_count + 1):
        row = np.zeros((f.shape[1], 3), f.dtype)
        for node, index, pclen, depth in _construct_patch(u, max_depth, tr):
            etas = _etas(index, pclen, depth, max_depth)
            for k in range(3):
                row[:, k] += etas[k] * f[node - 1]
            triples.append((u - 1, node - 1, etas))
        rows.append(row.reshape(-1))
    return np.stack(rows), triples, node_count


def _tree_inputs(executor, op, scope):
    read = lambda slot: to_host_array(  # noqa: E731
        executor._read_var(scope, op.input(slot)[0]))
    feats, edges, filt = read("NodesVector"), read("EdgeSet"), read("Filter")
    return feats, edges, filt, int(op.attrs.get("max_depth", 2))


@register_host_op(
    "tree_conv",
    inputs=[In("NodesVector"), In("EdgeSet", no_grad=True), In("Filter")],
    outputs=[Out("Out")],
    attrs={"max_depth": 2},
)
def _tree_conv(executor, op, scope):
    """The tree's patches are walked on the host (data-dependent), the
    product is dense: Out [B, N, out_size, filters], rows past a tree's
    node count zero."""
    feats, edges, filt, max_depth = _tree_inputs(executor, op, scope)
    bsz, n_nodes, n_feat = feats.shape
    out_size, n_filters = filt.shape[2], filt.shape[3]
    w2 = filt.reshape(n_feat * 3, out_size * n_filters)
    out = np.zeros((bsz, n_nodes, out_size, n_filters), feats.dtype)
    for b in range(bsz):
        patch, _, count = _patch_matrix(feats[b], edges[b], max_depth)
        out[b, :count] = (patch @ w2).reshape(count, out_size, n_filters)
    executor._write_var(scope, op.output("Out")[0],
                        torch.from_numpy(out).to(executor.device))


@register_host_op(
    "tree_conv_grad",
    inputs=[In("NodesVector", no_grad=True), In("EdgeSet", no_grad=True),
            In("Filter", no_grad=True), In("Out@GRAD", no_grad=True)],
    outputs=[Out("NodesVector@GRAD"), Out("Filter@GRAD")],
    attrs={"max_depth": 2},
)
def _tree_conv_grad(executor, op, scope):
    """dFilter = patch^T dOut; dNodes scatters the etas back."""
    feats, edges, filt, max_depth = _tree_inputs(executor, op, scope)
    og = to_host_array(executor._read_var(scope, op.input("Out@GRAD")[0]))
    n_feat = feats.shape[2]
    out_size, n_filters = filt.shape[2], filt.shape[3]
    w2 = filt.reshape(n_feat * 3, out_size * n_filters)
    d_filter, d_nodes = np.zeros_like(w2), np.zeros_like(feats)
    for b in range(feats.shape[0]):
        patch, triples, count = _patch_matrix(feats[b], edges[b], max_depth)
        og_flat = og[b, :count].reshape(count, out_size * n_filters)
        d_filter += patch.T @ og_flat
        col = (og_flat @ w2.T).reshape(count, n_feat, 3)
        for u, v, (el, er, et) in triples:
            d_nodes[b, v] += (el * col[u, :, 0] + er * col[u, :, 1]
                              + et * col[u, :, 2])
    dev = executor.device
    if op.output("NodesVector@GRAD"):
        executor._write_var(scope, op.output("NodesVector@GRAD")[0],
                            torch.from_numpy(d_nodes).to(dev))
    if op.output("Filter@GRAD"):
        executor._write_var(scope, op.output("Filter@GRAD")[0],
                            torch.from_numpy(d_filter.reshape(
                                filt.shape)).to(dev))
