"""The dense recurrent cell ops ``lstm_unit`` (:52), ``gru_unit`` (:68)
and ``cudnn_lstm`` (:252) of ``paddle_tpu/ops/rnn_ops.py``: the same
slots, attrs and defaults, written in torch with the JAX functions'
arithmetic order, their grads the registry's auto-VJP.

- ``lstm_unit``: X is the pre-activation ``[B, 4D]`` in gate order i, f,
  o, j; ``forget_bias`` is added to f.
- ``gru_unit``: Weight ``[D, 3D]`` (update and reset gates in the first
  2D columns, the candidate in the last D); ``Gate`` and
  ``ResetHiddenPrev`` take no grad.
- ``cudnn_lstm``: a stack of (bi)LSTMs over ``[T, N, D]`` from one flat
  weight, per (layer, direction) ``Wx [in, 4H]``, ``Wh [H, 4H]``, ``b
  [4H]`` in gate order c, i, f, o; dropout between layers (never after
  the last) from the executor's generator, which the grad op gets seeded
  as the forward's, so both draw the same mask. A library LSTM would need
  its gates permuted and rounds otherwise: the plain loop is the parity
  form.

The LoD ``lstm`` / ``gru`` ops (``dynamic_lstm`` / ``dynamic_gru``) wait
for the LoD slice (ROADMAP.md).
"""
from __future__ import annotations

import torch

from ..core.registry import DEVICE_ATTR, GENERATOR_ATTR, In, Out, register_op


@register_op(
    "lstm_unit",
    inputs=[In("X"), In("C_prev")],
    outputs=[Out("C"), Out("H")],
    attrs={"forget_bias": 0.0},
)
def _lstm_unit(ins, attrs):
    x, c_prev = ins["X"], ins["C_prev"]
    i, f, o, j = torch.chunk(x, 4, dim=-1)
    f = f + attrs.get("forget_bias", 0.0)
    c = torch.sigmoid(f) * c_prev + torch.sigmoid(i) * torch.tanh(j)
    h = torch.sigmoid(o) * torch.tanh(c)
    return {"C": c, "H": h}


@register_op(
    "gru_unit",
    inputs=[In("Input"), In("HiddenPrev"), In("Weight"),
            In("Bias", dispensable=True)],
    outputs=[Out("Gate", no_grad=True), Out("ResetHiddenPrev", no_grad=True),
             Out("Hidden")],
    attrs={"activation": 2, "gate_activation": 1, "origin_mode": False},
)
def _gru_unit(ins, attrs):
    x, h_prev, w = ins["Input"], ins["HiddenPrev"], ins["Weight"]
    d = h_prev.shape[-1]
    if ins.get("Bias") is not None:
        x = x + ins["Bias"].reshape(1, -1)
    g = x[:, :2 * d] + torch.matmul(h_prev, w[:, :2 * d])
    u = torch.sigmoid(g[:, :d])
    r = torch.sigmoid(g[:, d:2 * d])
    rhp = r * h_prev
    c = torch.tanh(x[:, 2 * d:] + torch.matmul(rhp, w[:, 2 * d:]))
    if attrs.get("origin_mode", False):
        h = u * h_prev + (1 - u) * c
    else:
        h = (1 - u) * h_prev + u * c
    return {"Gate": torch.cat([u, r, c], dim=-1), "ResetHiddenPrev": rhp,
            "Hidden": h}


def _lstm_direction(x, h, c, wx, wh, b, hidden, reverse):
    """One direction of one layer over ``x`` [T, N, in]: the outputs [T,
    N, H] and the last (h, c)."""
    xs = torch.flip(x, [0]) if reverse else x
    xp = torch.einsum("tnd,dk->tnk", xs, wx) + b[None, None, :]
    hs = []
    for t in range(xp.shape[0]):
        g = xp[t] + torch.matmul(h, wh)
        cand = torch.tanh(g[:, :hidden])
        ig = torch.sigmoid(g[:, hidden:2 * hidden])
        fg = torch.sigmoid(g[:, 2 * hidden:3 * hidden])
        og = torch.sigmoid(g[:, 3 * hidden:])
        c = cand * ig + c * fg
        h = og * torch.tanh(c)
        hs.append(h)
    out = torch.stack(hs, 0)
    return (torch.flip(out, [0]) if reverse else out), h, c


@register_op(
    "cudnn_lstm",
    inputs=[In("Input"), In("InitH"), In("InitC"), In("W")],
    outputs=[Out("Out"), Out("LastH"), Out("LastC"),
             Out("Reserve", dispensable=True, no_grad=True),
             Out("StateOut", dispensable=True, no_grad=True)],
    attrs={"max_len": 0, "hidden_size": 0, "num_layers": 1,
           "is_bidirec": False, "dropout_prob": 0.0, "is_test": False,
           "input_size": 0, "seed": -1},
    needs_rng=True,
)
def _cudnn_lstm(ins, attrs):
    x, h0, c0 = ins["Input"], ins["InitH"], ins["InitC"]
    w = ins["W"].reshape(-1)
    hidden = int(attrs["hidden_size"])
    layers = int(attrs.get("num_layers", 1))
    ndir = 2 if attrs.get("is_bidirec", False) else 1
    p = float(attrs.get("dropout_prob", 0.0))
    off = 0

    def take(num, shape):
        nonlocal off
        t = w[off:off + num].reshape(shape)
        off += num
        return t

    cur = x
    last_h, last_c = [], []
    for layer in range(layers):
        din = cur.shape[-1]
        outs = []
        for d in range(ndir):
            wx = take(din * 4 * hidden, (din, 4 * hidden))
            wh = take(hidden * 4 * hidden, (hidden, 4 * hidden))
            b = take(4 * hidden, (4 * hidden,))
            s = layer * ndir + d
            hs, h_l, c_l = _lstm_direction(cur, h0[s], c0[s], wx, wh, b,
                                           hidden, reverse=(d == 1))
            outs.append(hs)
            last_h.append(h_l)
            last_c.append(c_l)
        cur = torch.cat(outs, dim=-1) if ndir == 2 else outs[0]
        if p > 0.0 and not attrs.get("is_test", False) \
                and layer < layers - 1:
            u = torch.rand(cur.shape, generator=attrs.get(GENERATOR_ATTR),
                           dtype=torch.float32, device=attrs[DEVICE_ATTR])
            cur = torch.where(u < 1.0 - p, cur / (1.0 - p),
                              torch.zeros_like(cur))
    return {"Out": cur, "LastH": torch.stack(last_h, 0),
            "LastC": torch.stack(last_c, 0)}
