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

The LoD ops ``lstm`` (:147) and ``gru`` (:191), behind ``dynamic_lstm``
and ``dynamic_gru``, run the JAX package's padded, masked scan: the
ragged rows [total, 4D] (or 3D), pre-projected, are gathered into [N,
Tmax, ...] (``_pad_from_lod``), a loop over the steps updates every
sequence at once and keeps a finished sequence's state (``h * m + h_prev
* (1 - m)``), and the outputs are gathered back to the rows
(``_unpad_to_lod``). ``lstm``'s gate columns are (candidate, input,
forget, output), its Bias [1, 7D] with peepholes (the gate biases, then
the input, forget and output checks), [1, 4D] without; ``gru``'s are
(update, reset, candidate) with ``origin_mode`` choosing ``u * h_prev +
(1 - u) * c``. ``is_reverse`` runs each sequence from its end, by the JAX
op's index ``(len - 1 - t) mod len``. H0 and C0 are optional. Their grads
are the auto-VJP, which re-runs the loop, as ``jax.vjp`` re-runs the scan.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.registry import DEVICE_ATTR, GENERATOR_ATTR, In, Out, register_op
from .lod_utils import host_index, lod_offsets, seq_lens


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
    # unbind, not xp[t]: a slice's backward writes a full-size zero
    # tensor a step (quadratic in T); unbind's stacks the grads once
    for x_t in xp.unbind(0):
        g = x_t + torch.matmul(h, wh)
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


_ACTS = {"sigmoid": torch.sigmoid, "tanh": torch.tanh, "relu": torch.relu,
         "identity": lambda x: x, "linear": lambda x: x}


def _act(name):
    return _ACTS[name if isinstance(name, str) else "tanh"]


def _pad_from_lod(x, offsets):
    """[total, D] rows -> ([N, Tmax, D] zero-padded, the lengths)."""
    lens = seq_lens(offsets)
    tmax = int(lens.max()) if len(lens) else 0
    t = np.arange(tmax)[None, :]
    src = np.where(t < lens[:, None], np.asarray(offsets[:-1])[:, None] + t,
                   x.shape[0])
    ext = torch.cat([x, x.new_zeros((1,) + tuple(x.shape[1:]))], 0)
    rows = ext.index_select(0, host_index(src.reshape(-1), x.device))
    return rows.reshape((len(lens), tmax) + tuple(x.shape[1:])), lens


def _unpad_to_lod(padded, lens):
    n, tmax = padded.shape[0], padded.shape[1]
    idx = np.concatenate([i * tmax + np.arange(int(lens[i]))
                          for i in range(n)] or [np.zeros(0, np.int64)])
    return padded.reshape((n * tmax,) + tuple(padded.shape[2:])).index_select(
        0, host_index(idx, padded.device))


def _step_masks(lens, tmax, x):
    """[T, N, 1] masks of the valid steps, in x's type."""
    m = (np.arange(tmax)[:, None] < lens[None, :]).astype(np.float32)
    return torch.from_numpy(m).to(device=x.device, dtype=x.dtype)[..., None]


def _reverse_index(lens, tmax, x):
    """[N, T, D]-gather index running each sequence from its end."""
    idx = (lens[:, None] - 1 - np.arange(tmax)[None, :]) % \
        np.maximum(lens[:, None], 1)
    return host_index(idx.reshape(-1), x.device).reshape(
        len(lens), tmax, 1).expand(-1, -1, x.shape[-1])


def _lstm_scan(x_pad, lens, w, checks, h0, c0, gate_act, cell_act, cand_act,
               is_reverse):
    """The masked loop over the padded steps: x_pad [N, T, 4D]
    pre-projected (gate biases added), w [D, 4D]."""
    n, t, d4 = x_pad.shape
    d = d4 // 4
    check_i, check_f, check_o = checks
    if is_reverse:
        x_pad = torch.gather(x_pad, 1, _reverse_index(lens, t, x_pad))
    ms = _step_masks(lens, t, x_pad)
    h_prev, c_prev = h0, c0
    hs, cs = [], []
    # unbind, not x_pad[:, k]: a slice's backward writes a full-size zero
    # tensor a step (quadratic in T); unbind's stacks the grads once
    for k, x_t in enumerate(x_pad.unbind(1)):
        g = x_t + torch.matmul(h_prev, w)
        cand = cand_act(g[:, :d])
        ig = gate_act(g[:, d:2 * d] + (c_prev * check_i
                                       if check_i is not None else 0.0))
        fg = gate_act(g[:, 2 * d:3 * d] + (c_prev * check_f
                                           if check_f is not None else 0.0))
        c = cand * ig + c_prev * fg
        og = gate_act(g[:, 3 * d:] + (c * check_o
                                      if check_o is not None else 0.0))
        h = og * cell_act(c)
        m = ms[k]
        h_prev = h * m + h_prev * (1 - m)
        c_prev = c * m + c_prev * (1 - m)
        hs.append(h_prev)
        cs.append(c_prev)
    hs, cs = torch.stack(hs, 1), torch.stack(cs, 1)
    if is_reverse:
        idx = _reverse_index(lens, t, hs)
        hs, cs = torch.gather(hs, 1, idx), torch.gather(cs, 1, idx)
    return hs, cs


@register_op(
    "lstm",
    inputs=[In("Input"), In("H0", dispensable=True),
            In("C0", dispensable=True), In("Weight"), In("Bias")],
    outputs=[Out("Hidden"), Out("Cell"),
             Out("BatchGate", dispensable=True, no_grad=True),
             Out("BatchCellPreAct", dispensable=True, no_grad=True)],
    attrs={"use_peepholes": True, "is_reverse": False,
           "gate_activation": "sigmoid", "cell_activation": "tanh",
           "candidate_activation": "tanh", "is_test": False},
    needs_lod=True,
)
def _dynamic_lstm(ins, attrs):
    x, w, b = ins["Input"], ins["Weight"], ins["Bias"]
    offsets = lod_offsets(attrs, "Input")
    if offsets is None:
        raise ValueError("lstm requires LoD input")
    d = w.shape[0]
    b = b.reshape(-1)
    checks = (None, None, None)
    if attrs.get("use_peepholes", True):
        checks = (b[4 * d:5 * d], b[5 * d:6 * d], b[6 * d:7 * d])
    x_pad, lens = _pad_from_lod(x + b[:4 * d][None, :], offsets)
    n = len(lens)
    h0, c0 = ins.get("H0"), ins.get("C0")
    h0 = x.new_zeros((n, d)) if h0 is None else h0
    c0 = x.new_zeros((n, d)) if c0 is None else c0
    hs, cs = _lstm_scan(
        x_pad, lens, w, checks, h0, c0,
        _act(attrs.get("gate_activation", "sigmoid")),
        _act(attrs.get("cell_activation", "tanh")),
        _act(attrs.get("candidate_activation", "tanh")),
        attrs.get("is_reverse", False))
    return {"Hidden": _unpad_to_lod(hs, lens),
            "Cell": _unpad_to_lod(cs, lens)}


@register_op(
    "gru",
    inputs=[In("Input"), In("H0", dispensable=True), In("Weight"),
            In("Bias", dispensable=True)],
    outputs=[Out("Hidden"),
             Out("BatchGate", dispensable=True, no_grad=True),
             Out("BatchResetHiddenPrev", dispensable=True, no_grad=True),
             Out("BatchHidden", dispensable=True, no_grad=True)],
    attrs={"activation": "tanh", "gate_activation": "sigmoid",
           "is_reverse": False, "origin_mode": False, "is_test": False},
    needs_lod=True,
)
def _dynamic_gru(ins, attrs):
    x, w = ins["Input"], ins["Weight"]
    offsets = lod_offsets(attrs, "Input")
    if offsets is None:
        raise ValueError("gru requires LoD input")
    d = w.shape[0]
    if ins.get("Bias") is not None:
        x = x + ins["Bias"].reshape(1, -1)
    x_pad, lens = _pad_from_lod(x, offsets)
    n, t = x_pad.shape[0], x_pad.shape[1]
    h0 = ins.get("H0")
    h_prev = x.new_zeros((n, d)) if h0 is None else h0
    gact = _act(attrs.get("gate_activation", "sigmoid"))
    cact = _act(attrs.get("activation", "tanh"))
    origin = attrs.get("origin_mode", False)
    reverse = attrs.get("is_reverse", False)
    if reverse:
        x_pad = torch.gather(x_pad, 1, _reverse_index(lens, t, x_pad))
    ms = _step_masks(lens, t, x_pad)
    hs = []
    for k, x_t in enumerate(x_pad.unbind(1)):
        g = x_t[:, :2 * d] + torch.matmul(h_prev, w[:, :2 * d])
        u = gact(g[:, :d])
        r = gact(g[:, d:])
        c = cact(x_t[:, 2 * d:] + torch.matmul(r * h_prev, w[:, 2 * d:]))
        h = u * h_prev + (1 - u) * c if origin else \
            (1 - u) * h_prev + u * c
        m = ms[k]
        h_prev = h * m + h_prev * (1 - m)
        hs.append(h_prev)
    hs = torch.stack(hs, 1)
    if reverse:
        hs = torch.gather(hs, 1, _reverse_index(lens, t, hs))
    return {"Hidden": _unpad_to_lod(hs, lens)}
