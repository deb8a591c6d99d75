"""``chunk_eval`` (counterpart of ``paddle_tpu/ops/eval_ops.py:24-134``),
a host op with the same slots and attrs: chunk precision, recall and F1
over label sequences in the IOB, IOE, IOBES or plain scheme (reference
chunk_eval_op.cc), leaving out ``excluded_chunk_types``. The sequences are
the LoD's, or the rows of a dense ``[B, T]`` cut at ``SeqLength``, or the
whole input as one. Walking variable-length label runs is host work, as
in the reference (CPU only): a program holding it takes the op-by-op
interpreter, and the executor names ``chunk_eval (host)`` and counts the
fallback, as for every host op.
"""
from __future__ import annotations

import torch

from ..core.registry import In, Out, register_host_op
from ..core.tensor import LoDTensor, to_host_array

_SCHEMES = {
    # scheme -> (num_tag_types, tag_begin, tag_inside, tag_end, tag_single)
    "IOB": (2, 0, 1, -1, -1),
    "IOE": (2, -1, 0, 1, -1),
    "IOBES": (4, 0, 1, 2, 3),
    "plain": (1, -1, -1, -1, -1),
}


def _segments(labels, num_tag_types, other_type, tb, ti, te, ts):
    """Chunk segments [(begin, end, type)] of one sequence (reference
    ChunkEvalKernel::GetSegments with its ChunkBegin/ChunkEnd rules)."""

    def chunk_end(ptag, ptype, tag, typ):
        if ptype == other_type:
            return False
        if typ == other_type or typ != ptype:
            return True
        if ptag == tb or ptag == ti:
            return tag == tb or tag == ts
        return ptag in (te, ts)

    def chunk_begin(ptag, ptype, tag, typ):
        if ptype == other_type:
            return typ != other_type
        if typ == other_type:
            return False
        if typ != ptype or tag == tb or tag == ts:
            return True
        if tag in (ti, te):
            return ptag in (te, ts)
        return False

    segs = []
    in_chunk = False
    start = 0
    tag, typ = -1, other_type
    for i, lab in enumerate(labels):
        ptag, ptype = tag, typ
        tag = int(lab) % num_tag_types
        typ = int(lab) // num_tag_types
        if in_chunk and chunk_end(ptag, ptype, tag, typ):
            segs.append((start, i - 1, ptype))
            in_chunk = False
        if chunk_begin(ptag, ptype, tag, typ):
            start = i
            in_chunk = True
    if in_chunk:
        segs.append((start, len(labels) - 1, typ))
    return segs


@register_host_op(
    "chunk_eval",
    inputs=[In("Inference", no_grad=True), In("Label", no_grad=True),
            In("SeqLength", dispensable=True, no_grad=True)],
    outputs=[Out("Precision"), Out("Recall"), Out("F1-Score"),
             Out("NumInferChunks"), Out("NumLabelChunks"),
             Out("NumCorrectChunks")],
    attrs={"num_chunk_types": 1, "chunk_scheme": "IOB",
           "excluded_chunk_types": []})
def _chunk_eval(executor, op, scope):
    scheme = op.attrs.get("chunk_scheme", "IOB")
    if scheme not in _SCHEMES:
        raise ValueError("unknown chunk scheme %r" % scheme)
    ntag, tb, ti, te, ts = _SCHEMES[scheme]
    ntype = int(op.attrs.get("num_chunk_types", 1))
    other = ntype
    excluded = set(int(x) for x in op.attrs.get("excluded_chunk_types", []))

    seq_len = None
    if op.input("SeqLength"):
        seq_len = to_host_array(executor._read_var(
            scope, op.input("SeqLength")[0])).reshape(-1)

    def sequences(name):
        v = scope.find_var(name).raw()
        arr = to_host_array(v)
        if isinstance(v, LoDTensor) and v.lod():
            flat = arr.reshape(-1)
            off = v.lod()[0]
            return [flat[off[i]:off[i + 1]] for i in range(len(off) - 1)]
        if seq_len is not None:
            # dense [B, T] rows cut at their true lengths (reference
            # chunk_eval_op.h:181, the SeqLength path)
            rows = arr.reshape(len(seq_len), -1)
            return [rows[i, :int(seq_len[i])] for i in range(len(seq_len))]
        return [arr.reshape(-1)]  # one dense sequence

    n_inf = n_lab = n_correct = 0
    for inf, lab in zip(sequences(op.input("Inference")[0]),
                        sequences(op.input("Label")[0])):
        a = [s for s in _segments(inf, ntag, other, tb, ti, te, ts)
             if s[2] not in excluded]
        b = [s for s in _segments(lab, ntag, other, tb, ti, te, ts)
             if s[2] not in excluded]
        n_inf += len(a)
        n_lab += len(b)
        n_correct += len(set(a) & set(b))
    prec = n_correct / n_inf if n_inf else 0.0
    rec = n_correct / n_lab if n_lab else 0.0
    f1 = 2 * prec * rec / (prec + rec) if n_correct else 0.0
    dev = executor.device
    for slot, val, dtype in (
            ("Precision", prec, torch.float32),
            ("Recall", rec, torch.float32),
            ("F1-Score", f1, torch.float32),
            ("NumInferChunks", n_inf, torch.int64),
            ("NumLabelChunks", n_lab, torch.int64),
            ("NumCorrectChunks", n_correct, torch.int64)):
        executor._write_var(scope, op.output(slot)[0],
                            torch.tensor([val], dtype=dtype, device=dev))
