"""The sequence (LoD) ops: every op of ``paddle_tpu/ops/sequence_ops.py``,
with ``sequence_conv`` (``paddle_tpu/ops/tail_ops2.py:86``) and
``lod_reset`` (``paddle_tpu/ops/misc_ops.py:523``), the same slots, attrs,
defaults and output LoDs.

A LoD op reads its input's offsets from ``attrs['_lod_<slot>']`` (the
interpreter passes them; ``ops/lod_utils``) and gathers or scatters rows
through an index built from them on the host and copied once to the op's
device, where the JAX package builds static index tables at trace time:

- ``sequence_pool``: SUM / AVERAGE / SQRT sum rows per sequence
  (``index_add``; on the card in no fixed order), MAX / MIN reduce them
  (``scatter_reduce``) and split a tied maximum's gradient equally among
  its rows, as ``jax.ops.segment_max``'s VJP does; FIRST / LAST gather a
  row. ``MaxIndex`` is never produced, as in the JAX package.
- ``sequence_softmax``, ``sequence_expand`` (no output LoD),
  ``sequence_expand_as``, ``sequence_pad`` (a [N, padded_length, ...]
  tensor and int64 lengths, no LoD), ``sequence_reshape``,
  ``sequence_concat`` (sequence i of the output is sequence i of each
  input, in order), ``sequence_conv`` (a context window of
  ``contextLength`` rows from ``contextStart``, zero or trainable
  ``PaddingData`` rows outside the sequence, times ``Filter``) and
  ``im2sequence`` (patches through ``unfold``), ``sequence_reverse``
  (``paddle_tpu/ops/misc_ops.py:507``: each sequence's rows reversed,
  axis 0 flipped without a LoD) and ``sequence_scatter``
  (``paddle_tpu/ops/tail_ops2.py:139``: row i of X takes the Updates of
  sequence i of Ids' LoD, added at the columns Ids names) are ops with the
  registry's auto-VJP grad.
- ``sequence_unpad`` (and its grad), ``sequence_slice``,
  ``sequence_enumerate``, ``sequence_erase`` and ``lod_reset`` are host
  ops, as in the JAX package: their output LoD depends on values, which
  they read to the host; the rows stay on the device.

The ``*_padded`` twins (``:331-612``) take a padded ``[B, T, ...]`` value
and a ``[B]`` length tensor where the LoD op takes rows and offsets; the
LoD lowering (``core/lod_lowering``) swaps them in, so that a ragged
program runs on the whole-program route (a CUDA graph on the card). They
read the lengths on the device only, never on the host. ``sequence_mask``
(``Y[..., j] = j < X[...]`` over ``j < maxlen``, a static attr) has no
grad.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..core import dtypes as _dt
from ..core.registry import In, Out, register_host_op, register_op
from ..core.tensor import LoDTensor
from .lod_utils import LOD_ATTR_PREFIX as _LOD
from .lod_utils import host_index, lod_offsets, seg_ids, seq_lens


def _rows_like(x, n):
    return (n,) + tuple(x.shape[1:])


def _col(t, x):
    """A [n] tensor shaped to broadcast over x's trailing dims."""
    return t.reshape((-1,) + (1,) * (x.dim() - 1))


class _SegmentExtreme(torch.autograd.Function):
    """Per-segment max or min of rows; the gradient of a segment goes to
    its rows that attain it, split equally among ties (the rule of
    ``lax.scatter_max``'s JVP, behind ``jax.ops.segment_max``)."""

    @staticmethod
    def forward(ctx, x, ids, n, reduce):
        init = float("-inf") if reduce == "amax" else float("inf")
        idx = _col(ids, x).expand_as(x)
        out = torch.full(_rows_like(x, n), init, dtype=x.dtype,
                         device=x.device).scatter_reduce(
            0, idx, x, reduce, include_self=True)
        ctx.save_for_backward(x, idx, out)
        return out

    @staticmethod
    def backward(ctx, g):
        x, idx, out = ctx.saved_tensors
        hit = (x == out.gather(0, idx)).to(g.dtype)
        count = torch.zeros_like(out).scatter_add(0, idx, hit)
        return (g.gather(0, idx) * (hit * count.reciprocal().gather(0, idx)),
                None, None, None)


def _segment_sum(x, ids, n):
    return torch.zeros(_rows_like(x, n), dtype=x.dtype,
                       device=x.device).index_add(0, ids, x)


@register_op(
    "sequence_pool",
    inputs=[In("X")],
    outputs=[Out("Out"), Out("MaxIndex", dispensable=True, no_grad=True)],
    attrs={"pooltype": "AVERAGE", "pad_value": 0.0, "is_test": False},
    needs_lod=True,
    infer_lod=lambda in_lods, attrs: {},
)
def _sequence_pool(ins, attrs):
    x = ins["X"]
    offsets = lod_offsets(attrs, "X")
    if offsets is None:
        raise ValueError("sequence_pool requires LoD input")
    n = len(offsets) - 1
    pool = attrs.get("pooltype", "AVERAGE").upper()
    if pool in ("SUM", "AVERAGE", "SQRT"):
        out = _segment_sum(x, seg_ids(offsets, x.device), n)
        lens = torch.from_numpy(np.maximum(seq_lens(offsets), 1)).to(
            device=x.device, dtype=x.dtype)
        if pool == "AVERAGE":
            out = out / _col(lens, x)
        elif pool == "SQRT":
            out = out / _col(torch.sqrt(lens), x)
    elif pool in ("MAX", "MIN"):
        out = _SegmentExtreme.apply(x, seg_ids(offsets, x.device), n,
                                    "amax" if pool == "MAX" else "amin")
    elif pool == "LAST":
        out = x.index_select(0, host_index(np.asarray(offsets[1:]) - 1,
                                           x.device))
    elif pool == "FIRST":
        out = x.index_select(0, host_index(offsets[:-1], x.device))
    else:
        raise ValueError("unknown pooltype %r" % pool)
    return {"Out": out, "MaxIndex": None}


@register_op(
    "sequence_softmax",
    inputs=[In("X")],
    outputs=[Out("Out")],
    attrs={},
    needs_lod=True,
)
def _sequence_softmax(ins, attrs):
    x = ins["X"]
    offsets = lod_offsets(attrs, "X")
    ids = seg_ids(offsets, x.device)
    n = len(offsets) - 1
    flat = x.reshape(-1)
    # the max only steadies exp; it moves no gradient
    seg_max = torch.full((n,), float("-inf"), dtype=x.dtype,
                         device=x.device).scatter_reduce(
        0, ids, flat.detach(), "amax", include_self=True)
    e = torch.exp(flat - seg_max[ids])
    return {"Out": (e / _segment_sum(e, ids, n)[ids]).reshape(x.shape)}


@register_op(
    "sequence_expand",
    inputs=[In("X"), In("Y", no_grad=True)],
    outputs=[Out("Out")],
    attrs={"ref_level": -1},
    needs_lod=True,
    infer_lod=None,
)
def _sequence_expand(ins, attrs):
    """Sequence i of X repeated as many times as Y's ``ref_level``
    sequence i is long (a row each where X has no LoD)."""
    x = ins["X"]
    x_lods = attrs.get(_LOD + "X")
    y_off = list(attrs.get(_LOD + "Y")[0][attrs.get("ref_level", -1)])
    x_off = (list(x_lods[0][-1]) if x_lods and x_lods[0]
             else list(range(x.shape[0] + 1)))
    reps = [1] * (len(x_off) - 1)
    for i in range(min(len(reps), len(y_off) - 1)):
        reps[i] = y_off[i + 1] - y_off[i]
    idx = [r for i, k in enumerate(reps)
           for r in list(range(x_off[i], x_off[i + 1])) * k]
    return {"Out": x.index_select(0, host_index(idx, x.device))}


@register_op(
    "sequence_expand_as",
    inputs=[In("X"), In("Y", no_grad=True)],
    outputs=[Out("Out")],
    needs_lod=True,
)
def _sequence_expand_as(ins, attrs):
    """Row i of X repeated as many times as Y's sequence i is long."""
    x = ins["X"]
    y_off = attrs.get(_LOD + "Y")[0][-1]
    return {"Out": x.index_select(0, host_index(
        np.repeat(np.arange(len(y_off) - 1), seq_lens(y_off)), x.device))}


@register_op("sequence_reverse", inputs=[In("X")], outputs=[Out("Y")],
             needs_lod=True)
def _sequence_reverse(ins, attrs):
    x = ins["X"]
    offsets = lod_offsets(attrs, "X")
    if offsets is None:
        return {"Y": torch.flip(x, dims=[0])}
    idx = [r for i in range(len(offsets) - 1)
           for r in range(offsets[i + 1] - 1, offsets[i] - 1, -1)]
    return {"Y": x.index_select(0, host_index(idx, x.device))}


@register_op(
    "sequence_scatter",
    inputs=[In("X"), In("Ids", no_grad=True), In("Updates")],
    outputs=[Out("Out")],
    needs_lod=True,
)
def _sequence_scatter(ins, attrs):
    x = ins["X"]
    ids = ins["Ids"].reshape(-1).to(torch.int64)
    upd = ins["Updates"].reshape(-1)
    offsets = lod_offsets(attrs, "Ids")
    if offsets is None:
        raise ValueError("sequence_scatter requires LoD on Ids")
    if len(offsets) - 1 != x.shape[0]:
        raise ValueError(
            "sequence_scatter: Ids has %d sequences but X has %d rows"
            % (len(offsets) - 1, x.shape[0]))
    flat = seg_ids(offsets, x.device) * x.shape[1] + ids
    return {"Out": x.reshape(-1).index_add(0, flat, upd.to(x.dtype))
            .reshape(x.shape)}


@register_op(
    "sequence_mask",
    inputs=[In("X", no_grad=True),
            In("MaxLenTensor", dispensable=True, no_grad=True)],
    outputs=[Out("Y")],
    attrs={"maxlen": -1, "out_dtype": 5},
    grad=None,
)
def _sequence_mask(ins, attrs):
    x = ins["X"]
    maxlen = attrs.get("maxlen", -1)
    if maxlen < 0:
        raise ValueError("sequence_mask takes a static maxlen attr (the "
                         "MaxLenTensor form is not ported)")
    r = torch.arange(maxlen, device=x.device)
    mask = r[None, :] < x.reshape(-1, 1)
    return {"Y": mask.reshape(tuple(x.shape) + (maxlen,)).to(
        _dt.to_torch_dtype(attrs.get("out_dtype", 5)))}


def _pad_index(offsets, plen):
    """For each of the [N * plen] padded slots, the source row, or -1."""
    lens = seq_lens(offsets)
    t = np.arange(plen)[None, :]
    src = np.asarray(offsets[:-1])[:, None] + t
    return np.where(t < lens[:, None], src, -1).reshape(-1)


@register_op(
    "sequence_pad",
    inputs=[In("X"), In("PadValue")],
    outputs=[Out("Out"), Out("Length", no_grad=True)],
    attrs={"padded_length": -1},
    needs_lod=True,
    infer_lod=lambda in_lods, attrs: {},
)
def _sequence_pad(ins, attrs):
    """[sum, ...] rows -> [N, padded_length, ...] (the longest sequence's
    length by default), PadValue past each sequence's end."""
    x, pad = ins["X"], ins["PadValue"]
    offsets = lod_offsets(attrs, "X")
    lens = seq_lens(offsets)
    n = len(lens)
    plen = attrs.get("padded_length", -1)
    if plen < 0:
        plen = int(lens.max()) if n else 0
    if n and plen < int(lens.max()):
        raise ValueError("sequence_pad: padded_length %d is shorter than "
                         "the longest sequence (%d)" % (plen, lens.max()))
    src = _pad_index(offsets, plen)
    rows = x.index_select(0, host_index(np.maximum(src, 0), x.device))
    keep = _col(host_index(src, x.device) >= 0, rows)
    fill = pad.reshape((1,) * x.dim()).to(x.dtype)
    out = torch.where(keep, rows, fill)
    return {"Out": out.reshape((n, plen) + tuple(x.shape[1:])),
            "Length": torch.from_numpy(lens).to(x.device)}


def _unpad_index(n, t, lens):
    """Rows of a [n * t] flattened padded tensor that hold data."""
    return np.concatenate([i * t + np.arange(int(lens[i]))
                           for i in range(n)] or [np.zeros(0, np.int64)])


def _lengths_to_host(t) -> np.ndarray:
    return t.detach().reshape(-1).cpu().numpy().astype(np.int64)


@register_host_op(
    "sequence_unpad",
    inputs=[In("X"), In("Length", no_grad=True)],
    outputs=[Out("Out")],
)
def _sequence_unpad(executor, op, scope):
    """Padded [N, T, ...] + lengths -> LoD rows [total, ...]: the output
    LoD depends on the Length values, read to the host."""
    x = executor._read_var(scope, op.input("X")[0])
    lens = _lengths_to_host(executor._read_var(scope, op.input("Length")[0]))
    n, t = int(x.shape[0]), int(x.shape[1])
    out = x.reshape((n * t,) + tuple(x.shape[2:])).index_select(
        0, host_index(_unpad_index(n, t, lens), x.device))
    executor._write_var(scope, op.output("Out")[0], LoDTensor(out).set_lod(
        [[0] + np.cumsum(lens).tolist()]))


@register_host_op(
    "sequence_unpad_grad",
    inputs=[In("X", no_grad=True), In("Length", no_grad=True),
            In("Out@GRAD")],
    outputs=[Out("X@GRAD")],
)
def _sequence_unpad_grad(executor, op, scope):
    """The ragged cotangent rows back at their padded positions, zeros in
    the pads."""
    x = executor._read_var(scope, op.input("X")[0])
    lens = _lengths_to_host(executor._read_var(scope, op.input("Length")[0]))
    g = executor._read_var(scope, op.input("Out@GRAD")[0])
    n, t = int(x.shape[0]), int(x.shape[1])
    dx = torch.zeros((n * t,) + tuple(x.shape[2:]), dtype=x.dtype,
                     device=x.device)
    dx.index_copy_(0, host_index(_unpad_index(n, t, lens), x.device),
                   g.to(x.dtype))
    executor._write_var(scope, op.output("X@GRAD")[0], dx.reshape(x.shape))


@register_op(
    "sequence_reshape",
    inputs=[In("X")],
    outputs=[Out("Out")],
    attrs={"new_dim": 1},
    needs_lod=True,
)
def _sequence_reshape(ins, attrs):
    return {"Out": ins["X"].reshape(-1, attrs["new_dim"])}


def _concat_out_lod(in_lods, attrs):
    """Sequence i of the output is sequence i of each input: its offsets
    are the summed lengths."""
    offs = [list(lod[-1]) for lod in (in_lods.get("X") or []) if lod]
    if not offs:
        return {}
    n = min(len(o) - 1 for o in offs)
    out = [0]
    for i in range(n):
        out.append(out[-1] + sum(o[i + 1] - o[i] for o in offs))
    return {("Out", 0): (tuple(out),)}


@register_op(
    "sequence_concat",
    inputs=[In("X", duplicable=True)],
    outputs=[Out("Out")],
    needs_lod=True,
    infer_lod=_concat_out_lod,
)
def _sequence_concat(ins, attrs):
    xs = ins["X"]
    lods = attrs.get(_LOD + "X")
    cat = torch.cat(xs, dim=0)
    if not lods or not all(lods):
        return {"Out": cat}
    offs = [list(lod[-1]) for lod in lods]
    base = np.cumsum([0] + [int(x.shape[0]) for x in xs])
    idx = [base[k] + r for i in range(len(offs[0]) - 1)
           for k, off in enumerate(offs) for r in range(off[i], off[i + 1])]
    return {"Out": cat.index_select(0, host_index(idx, cat.device))}


@register_host_op(
    "sequence_slice",
    inputs=[In("X"), In("Offset", no_grad=True), In("Length", no_grad=True)],
    outputs=[Out("Out")],
)
def _sequence_slice(executor, op, scope):
    """Rows [offset, offset + length) of each sequence: the output LoD
    depends on the Length values."""
    xv = scope.find_var(op.input("X")[0]).raw()
    if not (isinstance(xv, LoDTensor) and xv.lod()):
        raise ValueError("sequence_slice requires LoD input")
    x = xv.array
    offsets = list(xv.lod()[-1])
    off = _lengths_to_host(executor._read_var(scope, op.input("Offset")[0]))
    length = _lengths_to_host(
        executor._read_var(scope, op.input("Length")[0]))
    idx = [offsets[i] + int(off[i]) + r for i in range(len(offsets) - 1)
           for r in range(int(length[i]))]
    out = x.index_select(0, host_index(idx, x.device))
    executor._write_var(scope, op.output("Out")[0], LoDTensor(out).set_lod(
        [[0] + np.cumsum(length[:len(offsets) - 1]).tolist()]))


@register_op(
    "im2sequence",
    inputs=[In("X")],
    outputs=[Out("Out")],
    attrs={"kernels": [1, 1], "strides": [1, 1], "paddings": [0, 0, 0, 0],
           "out_stride": [1, 1]},
    infer_lod=None,
)
def _im2sequence(ins, attrs):
    """[N, C, H, W] -> one row per output position, [N * OH * OW, C * KH *
    KW], positions in row-major order, each row channel-major."""
    x = ins["X"]
    n, c = x.shape[0], x.shape[1]
    kh, kw = attrs["kernels"]
    pt, pl, pb, pr = attrs.get("paddings", [0, 0, 0, 0])
    cols = F.unfold(F.pad(x, (pl, pr, pt, pb)), (kh, kw),
                    stride=tuple(attrs.get("strides", [1, 1])))
    return {"Out": cols.transpose(1, 2).reshape(-1, c * kh * kw)}


@register_host_op(
    "sequence_enumerate",
    inputs=[In("X", no_grad=True)],
    outputs=[Out("Out")],
    attrs={"win_size": 2, "pad_value": 0})
def _sequence_enumerate(executor, op, scope):
    """out[t] = x[t:t+win_size] within t's sequence (the first LoD
    level), pad_value past its end; the LoD kept."""
    xv = scope.find_var(op.input("X")[0]).raw()
    x = xv.array
    flat = x.detach().reshape(-1).cpu().numpy()
    win = int(op.attrs.get("win_size", 2))
    offs = xv.lod()[0] if xv.lod() else [0, flat.shape[0]]
    out = np.full((flat.shape[0], win), op.attrs.get("pad_value", 0),
                  dtype=flat.dtype)
    for s in range(len(offs) - 1):
        lo, hi = int(offs[s]), int(offs[s + 1])
        for t in range(lo, hi):
            k = min(win, hi - t)
            out[t, :k] = flat[t:t + k]
    executor._write_var(scope, op.output("Out")[0], LoDTensor(
        torch.from_numpy(out).to(x.device)).set_lod([list(offs)]))


@register_host_op(
    "sequence_erase",
    inputs=[In("X", no_grad=True)],
    outputs=[Out("Out")],
    attrs={"tokens": []})
def _sequence_erase(executor, op, scope):
    """Each sequence without the listed tokens: the last LoD level
    shrinks, the levels above it (which index sequences) stay."""
    xv = scope.find_var(op.input("X")[0]).raw()
    x = xv.array
    flat = x.detach().reshape(-1).cpu().numpy()
    tokens = [int(t) for t in op.attrs.get("tokens", [])]
    lod = xv.lod() if xv.lod() else [[0, flat.shape[0]]]
    offs = lod[-1]
    keep = ~np.isin(flat, tokens)
    out_offs = [0]
    for s in range(len(offs) - 1):
        out_offs.append(out_offs[-1]
                        + int(keep[int(offs[s]):int(offs[s + 1])].sum()))
    out = torch.from_numpy(flat[keep].reshape(-1, 1)).to(x.device)
    executor._write_var(scope, op.output("Out")[0], LoDTensor(out).set_lod(
        [list(level) for level in lod[:-1]] + [out_offs]))


def _context_index(offsets, n_rows, length, start, pad_rows):
    """[T, length] source rows of each context window over ``x`` extended
    by ``pad_rows`` rows: a row of x inside the sequence, else row
    ``n_rows`` (zero) without trainable padding, or the padding row the
    JAX op picks: ``idx + up`` before the sequence, ``up + (idx - n)``
    past it, clipped."""
    up = max(-start, 0)
    src = np.empty((n_rows, length), dtype=np.int64)
    for s in range(len(offsets) - 1):
        lo, hi = offsets[s], offsets[s + 1]
        n = hi - lo
        for j in range(length):
            idx = np.arange(n) + start + j
            inside = (idx >= 0) & (idx < n)
            if pad_rows:
                pad = np.where(idx < 0, idx + up, up + (idx - n))
                out = n_rows + np.clip(pad, 0, pad_rows - 1)
            else:
                out = np.full(n, n_rows)
            src[lo:hi, j] = np.where(inside, lo + idx, out)
    return src


@register_op(
    "sequence_conv",
    inputs=[In("X"), In("PaddingData", dispensable=True), In("Filter")],
    outputs=[Out("Out")],
    attrs={"contextLength": 3, "contextStart": -1, "contextStride": 1,
           "paddingTrainable": False},
    needs_lod=True,
)
def _sequence_conv(ins, attrs):
    """Each row's context window (rows ``contextStart`` ..
    ``contextStart + contextLength - 1`` from it, within its sequence)
    concatenated, times Filter [contextLength * D, num_filters]."""
    x, filt = ins["X"], ins["Filter"]
    length = int(attrs.get("contextLength", 3))
    start = int(attrs.get("contextStart", -1))
    offsets = lod_offsets(attrs, "X") or [0, x.shape[0]]
    pad = ins.get("PaddingData")
    if pad is not None and attrs.get("paddingTrainable"):
        ext = torch.cat([x, pad.to(x.dtype)], 0)
        pad_rows = int(pad.shape[0])
    else:
        ext = torch.cat([x, x.new_zeros((1,) + tuple(x.shape[1:]))], 0)
        pad_rows = 0
    src = _context_index(offsets, int(x.shape[0]), length, start, pad_rows)
    im = ext.index_select(0, host_index(src.reshape(-1), x.device))
    return {"Out": im.reshape(x.shape[0], -1) @ filt}


@register_host_op("lod_reset",
                  inputs=[In("X"), In("Y", dispensable=True, no_grad=True)],
                  outputs=[Out("Out")],
                  attrs={"target_lod": []})
def _lod_reset(executor, op, scope):
    """X's rows with a new one-level LoD: ``target_lod``, else Y's last
    LoD level, else Y's values."""
    xv = scope.find_var(op.input("X")[0]).raw()
    x = xv.array if isinstance(xv, LoDTensor) else xv
    target = list(op.attrs.get("target_lod") or [])
    if not target and op.input("Y"):
        yv = scope.find_var(op.input("Y")[0]).raw()
        if isinstance(yv, LoDTensor) and yv.lod():
            target = list(yv.lod()[-1])
        else:
            y = yv.array if isinstance(yv, LoDTensor) else yv
            target = _lengths_to_host(y).tolist()
    executor._write_var(scope, op.output("Out")[0],
                        LoDTensor(x).set_lod([target]))


# -- the padded twins, for the whole-program route --------------------------


def _len_mask(ln, t, x):
    """[B, T] mask of the valid steps, shaped to broadcast over x."""
    mask = torch.arange(t, device=x.device)[None, :] < ln.reshape(-1, 1)
    return mask.reshape(mask.shape + (1,) * (x.dim() - 2))


@register_op(
    "sequence_pool_padded",
    inputs=[In("X"), In("Length", no_grad=True)],
    outputs=[Out("Out")],
    attrs={"pooltype": "AVERAGE", "pad_value": 0.0, "is_test": False},
)
def _sequence_pool_padded(ins, attrs):
    x, ln = ins["X"], ins["Length"].reshape(-1)
    t = x.shape[1]
    m = _len_mask(ln, t, x)
    live = ln.reshape((-1,) + (1,) * (x.dim() - 2)) > 0
    pad_value = attrs.get("pad_value", 0.0)
    pool = attrs.get("pooltype", "AVERAGE").upper()
    if pool in ("SUM", "AVERAGE", "SQRT"):
        out = torch.sum(torch.where(m, x, 0.0), dim=1)
        lens = torch.clamp(ln, min=1).to(x.dtype).reshape(
            (-1,) + (1,) * (x.dim() - 2))
        if pool == "AVERAGE":
            out = out / lens
        elif pool == "SQRT":
            out = out / torch.sqrt(lens)
    elif pool in ("MAX", "MIN"):
        fill = float("-inf") if pool == "MAX" else float("inf")
        red = torch.amax if pool == "MAX" else torch.amin
        out = torch.where(live, red(torch.where(m, x, fill), dim=1),
                          pad_value)
    elif pool == "LAST":
        idx = torch.clamp(ln.to(torch.int64) - 1, 0, t - 1).reshape(
            (-1, 1) + (1,) * (x.dim() - 2))
        out = torch.where(live, torch.gather(
            x, 1, idx.expand((-1, 1) + tuple(x.shape[2:]))).squeeze(1),
            pad_value)
    elif pool == "FIRST":
        out = torch.where(live, x[:, 0], pad_value)
    else:
        raise ValueError("unknown pooltype %r" % pool)
    return {"Out": out}


@register_op(
    "sequence_softmax_padded",
    inputs=[In("X"), In("Length", no_grad=True)],
    outputs=[Out("Out")],
    attrs={},
)
def _sequence_softmax_padded(ins, attrs):
    x, ln = ins["X"], ins["Length"]
    mask = _len_mask(ln, x.shape[1], x)
    z = torch.where(mask, x, -1e30)
    z = z - torch.amax(z, dim=1, keepdim=True)
    e = torch.where(mask, torch.exp(z), 0.0)
    return {"Out": e / torch.clamp(torch.sum(e, dim=1, keepdim=True),
                                   min=1e-30)}


@register_op(
    "sequence_conv_padded",
    inputs=[In("X"), In("Filter"), In("Length", no_grad=True)],
    outputs=[Out("Out")],
    attrs={"contextLength": 3, "contextStart": -1, "contextStride": 1,
           "paddingTrainable": False},
)
def _sequence_conv_padded(ins, attrs):
    """``sequence_conv`` over [B, T, D] + lengths: window rows outside [0,
    len_b) are zero, and so are the padded output rows (their grads stay
    clean)."""
    x, filt, ln = ins["X"], ins["Filter"], ins["Length"]
    length = int(attrs.get("contextLength", 3))
    start = int(attrs.get("contextStart", -1))
    t = x.shape[1]
    lens = ln.reshape(-1, 1)
    steps = torch.arange(t, device=x.device)
    cols = []
    for j in range(length):
        idx = steps + start + j
        inside = (idx >= 0)[None, :] & (idx[None, :] < lens)
        g = x.index_select(1, torch.clamp(idx, 0, t - 1))
        cols.append(torch.where(inside[..., None], g, 0.0))
    out = torch.cat(cols, dim=2).to(filt.dtype) @ filt
    return {"Out": torch.where((steps[None, :] < lens)[..., None], out, 0.0)}


@register_op(
    "sequence_expand_padded",
    inputs=[In("X"), In("Y", no_grad=True), In("Length", no_grad=True)],
    outputs=[Out("Out")],
    attrs={"ref_level": -1},
)
def _sequence_expand_padded(ins, attrs):
    """A dense per-sequence X [B, ...] broadcast along Y's time axis,
    zero past each length (the ragged-X form changes the batch by data
    and stays on the interpreter)."""
    x, y, ln = ins["X"], ins["Y"], ins["Length"]
    t = y.shape[1]
    out = x[:, None].expand((x.shape[0], t) + tuple(x.shape[1:]))
    return {"Out": torch.where(_len_mask(ln, t, out), out, 0.0)}


@register_op(
    "sequence_pad_padded",
    inputs=[In("X"), In("PadValue"), In("Length", no_grad=True)],
    outputs=[Out("Out"), Out("Length", no_grad=True)],
    attrs={"padded_length": -1},
)
def _sequence_pad_padded(ins, attrs):
    """``sequence_pad`` on the padded form: cut or extend [B, T, ...] to
    ``padded_length`` (the bucket's T when unset), PadValue past each
    length; lengths beyond ``padded_length`` are clamped with the
    values."""
    x, pad, ln = ins["X"], ins["PadValue"], ins["Length"].reshape(-1)
    t = x.shape[1]
    plen = int(attrs.get("padded_length", -1))
    lens = ln if plen < 0 else torch.clamp(ln, max=plen)
    plen = t if plen < 0 else plen
    if plen > t:
        x = torch.cat([x, x.new_zeros((x.shape[0], plen - t)
                                      + tuple(x.shape[2:]))], dim=1)
    elif plen < t:
        x = x[:, :plen]
    fill = pad.reshape((1,) * x.dim()).expand(x.shape).to(x.dtype)
    return {"Out": torch.where(_len_mask(lens, plen, x), x, fill),
            "Length": lens.to(torch.int64)}


@register_op(
    "sequence_unpad_padded",
    inputs=[In("X"), In("Length", no_grad=True)],
    outputs=[Out("Out")],
)
def _sequence_unpad_padded(ins, attrs):
    """The identity: in the padded form the ragged value is [B, T, ...]
    and its lengths; the lowering keys the output to the Length input."""
    return {"Out": ins["X"]}


@register_op(
    "sequence_concat_padded",
    inputs=[In("X", duplicable=True),
            In("Length", duplicable=True, no_grad=True)],
    outputs=[Out("Out"), Out("OutLength", no_grad=True)],
)
def _sequence_concat_padded(ins, attrs):
    """``sequence_concat`` on the padded form: each input's valid rows
    land after the ones before (offsets by the lengths, on the device);
    OutLength is the sum of the lengths."""
    xs, lens = ins["X"], [ln.reshape(-1) for ln in ins["Length"]]
    b = xs[0].shape[0]
    total_t = sum(int(x.shape[1]) for x in xs)
    tail = tuple(xs[0].shape[2:])
    out = xs[0].new_zeros((b, total_t) + tail)
    rows = torch.arange(b, device=out.device)[:, None]
    offset = torch.zeros(b, dtype=torch.int64, device=out.device)
    for x, ln in zip(xs, lens):
        steps = torch.arange(int(x.shape[1]), device=out.device)
        dest = torch.clamp(offset[:, None] + steps[None, :], 0, total_t - 1)
        contrib = torch.where(_len_mask(ln, x.shape[1], x), x, 0.0)
        out = out.index_put((rows.expand_as(dest), dest),
                            contrib.to(out.dtype), accumulate=True)
        offset = offset + ln.to(torch.int64)
    return {"Out": out, "OutLength": sum(ln.to(torch.int64) for ln in lens)}
