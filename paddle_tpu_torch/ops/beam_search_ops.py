"""The LoD beam-search host ops of the Fluid seq2seq API, the port's copy
of ``paddle_tpu/ops/beam_search_ops.py``: ``beam_search`` (:78) and
``beam_search_decode`` (:147), the same slots and attrs.

They are ragged host ops, as in the JAX package and the reference: a step
reads its few [rows, k] candidates to the host (one copy each), selects
there and writes the selected ids and scores back to the op's device with
their LoD. The vocabulary's scoring stays in the ops before them.

``beam_search`` follows the reference's ``math/beam_search.cc``: the
candidate rows of source sentence i are those its LoD level ``level``
names in *absolute* row offsets (``ToAbsOffset``). Under a two-level LoD,
which every step after the first of a ``While`` loop gives it, level 0
counts the prefixes of the step before, not rows; the JAX package reads
it as rows, so from the second step on it groups the candidates of the
wrong sources (ROADMAP.md lists the fault). On a one-level LoD, and on a
two-level LoD whose level 1 holds one row a prefix, the two agree.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.registry import In, Out, register_host_op
from ..core.tensor import LoDTensor


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _abs_offsets(lod):
    """Each level's offsets in rows of the last level (the reference's
    ``ToAbsOffset``)."""
    out = [list(level) for level in lod]
    for i in range(len(out) - 2, -1, -1):
        out[i] = [out[i + 1][o] for o in out[i]]
    return out


def _select_top_beam(pre_ids, pre_scores, ids, scores, high_level,
                     beam_size, end_id, is_accumulated):
    """``SelectTopBeamSizeItems``: for each source sentence, the top
    ``beam_size`` (row, id, score) items over its candidate rows; a
    finished row (pre_id == end_id) offers the one item (end_id, its
    score). Ties go to the smaller row."""
    flat_pre_ids = pre_ids.reshape(-1)
    flat_pre_scores = pre_scores.reshape(-1)
    width = int(np.prod(scores.shape[1:])) if scores.ndim > 1 else 1
    flat_scores = scores.reshape(-1)
    flat_ids = ids.reshape(-1) if ids is not None else None
    result = []
    for seq in range(len(high_level) - 1):
        items = []
        for row in range(high_level[seq], high_level[seq + 1]):
            pre_id = int(flat_pre_ids[row])
            pre_score = float(flat_pre_scores[row])
            if pre_id == end_id:
                items.append((row, end_id, pre_score))
                continue
            base = row * width
            for d in range(width):
                tok = int(flat_ids[base + d]) if flat_ids is not None else d
                s = (float(flat_scores[base + d]) if is_accumulated
                     else pre_score + float(np.log(flat_scores[base + d])))
                items.append((row, tok, s))
        items.sort(key=lambda it: (-it[2], it[0]))
        result.append(items[:beam_size])
    return result


def _prune_end_beams(pre_ids, per_seq_items, end_id):
    """``PruneEndBeams``: a source whose every selected item and every
    pre_id is end_id is dropped, one step after it finished, so its end
    tokens are written out once."""
    flat_pre = pre_ids.reshape(-1)
    for seq, items in enumerate(per_seq_items):
        if all(tok == end_id and int(flat_pre[row]) == end_id
               for row, tok, _ in items):
            per_seq_items[seq] = []
    return per_seq_items


@register_host_op(
    "beam_search",
    inputs=[In("pre_ids", no_grad=True), In("pre_scores", no_grad=True),
            In("ids", dispensable=True, no_grad=True),
            In("scores", no_grad=True)],
    outputs=[Out("selected_ids"), Out("selected_scores"),
             Out("parent_idx", dispensable=True)],
    attrs={"level": 0, "beam_size": 1, "end_id": 0, "is_accumulated": True},
)
def _beam_search(executor, op, scope):
    level = int(op.attrs.get("level", 0))
    beam_size = int(op.attrs["beam_size"])
    end_id = int(op.attrs["end_id"])
    is_accumulated = bool(op.attrs.get("is_accumulated", True))

    def held(slot):
        return scope.find_var(op.input(slot)[0]).get_tensor()

    pre_ids_t, scores_t = held("pre_ids"), held("scores")
    device = scores_t.array.device
    pre_ids = _host(pre_ids_t.array)
    pre_scores = _host(held("pre_scores").array)
    scores = _host(scores_t.array)
    ids = _host(held("ids").array) if op.input("ids") else None

    lod = scores_t.lod() or pre_ids_t.lod()
    if not lod:
        # the first step: every row its own source (pre_ids may come
        # [rows, 1] or [1, rows])
        n = int(pre_ids.size)
        lod = [list(range(n + 1)), list(range(n + 1))]
    high_level = _abs_offsets(lod)[level]

    per_seq = _select_top_beam(pre_ids, pre_scores, ids, scores, high_level,
                               beam_size, end_id, is_accumulated)
    per_seq = _prune_end_beams(pre_ids, per_seq, end_id)

    # by prefix row (the reference's ToMap), then emitted in row order
    by_row = [[] for _ in range(high_level[-1])]
    for items in per_seq:
        for it in items:
            by_row[it[0]].append(it)
    sel_ids, sel_scores, parent, low_level = [], [], [], [0]
    for row, items in enumerate(by_row):
        for _, tok, s in items:
            sel_ids.append(tok)
            sel_scores.append(s)
            parent.append(row)
        low_level.append(len(sel_ids))
    out_lod = [list(high_level), low_level]
    n = len(sel_ids)
    executor._write_var(scope, op.output("selected_ids")[0], LoDTensor(
        torch.tensor(sel_ids, dtype=torch.int64).reshape(n, 1).to(device),
        out_lod))
    executor._write_var(scope, op.output("selected_scores")[0], LoDTensor(
        torch.tensor(sel_scores, dtype=torch.float32).reshape(n, 1)
        .to(device), out_lod))
    if op.output("parent_idx"):
        executor._write_var(scope, op.output("parent_idx")[0], torch.tensor(
            parent, dtype=torch.int32).to(device))


@register_host_op(
    "beam_search_decode",
    inputs=[In("Ids", no_grad=True), In("Scores", no_grad=True)],
    outputs=[Out("SentenceIds"), Out("SentenceScores")],
    attrs={"beam_size": 1, "end_id": 0},
)
def _beam_search_decode(executor, op, scope):
    """``beam_search_decode_op.h`` ``Backtrace``: walk the steps' selected
    ids from the last to the first, following each row to its prefix
    through the step's sentence-level LoD, and emit each source's
    sentences (reversed at the end) without repeated end tokens: ids and
    scores [n, 1] with a 2-level LoD (source -> sentences -> words)."""
    end_id = int(op.attrs["end_id"])
    ids_arr = scope.find_var(op.input("Ids")[0]).get_lod_tensor_array()
    scores_arr = scope.find_var(op.input("Scores")[0]).get_lod_tensor_array()
    if not len(ids_arr):
        raise ValueError("beam_search_decode: empty step array")
    device = ids_arr[0].array.device
    src_level, sent_level = 0, 1
    src_num = len(ids_arr[0].lod()[src_level]) - 1
    sentences = [[] for _ in range(src_num)]  # per source: (words, scores)
    prefix_idx = [[] for _ in range(src_num)]

    for step in range(len(ids_arr) - 1, -1, -1):
        id_data = _host(ids_arr[step].array).reshape(-1)
        sc_data = _host(scores_arr[step].array).reshape(-1)
        lod = ids_arr[step].lod()
        for src in range(src_num):
            p_start, p_end = lod[src_level][src], lod[src_level][src + 1]
            if not prefix_idx[src]:
                # the last step, or the source was pruned at this one:
                # one sentence a selected row
                for prefix in range(p_start, p_end):
                    for cand in range(lod[sent_level][prefix],
                                      lod[sent_level][prefix + 1]):
                        prefix_idx[src].append(prefix)
                        sentences[src].append(([int(id_data[cand])],
                                               [float(sc_data[cand])]))
                continue
            src_cand_start = lod[sent_level][p_start]
            prefix = p_start
            cand_num = lod[sent_level][prefix + 1] - lod[sent_level][prefix]
            for idx, cand in enumerate(prefix_idx[src]):
                words, scs = sentences[src][idx]
                tok = int(id_data[cand])
                if tok != end_id or not words:
                    words.append(tok)
                    scs.append(float(sc_data[cand]))
                while src_cand_start + cand_num <= cand:
                    prefix += 1
                    cand_num += (lod[sent_level][prefix + 1]
                                 - lod[sent_level][prefix])
                prefix_idx[src][idx] = prefix

    flat_ids, flat_scores, src_lod, sent_lod = [], [], [0], [0]
    for src in range(src_num):
        for words, scs in sentences[src]:
            flat_ids.extend(reversed(words))
            flat_scores.extend(reversed(scs))
            sent_lod.append(len(flat_ids))
        src_lod.append(len(sent_lod) - 1)
    out_lod = [src_lod, sent_lod]
    n = len(flat_ids)
    executor._write_var(scope, op.output("SentenceIds")[0], LoDTensor(
        torch.tensor(flat_ids, dtype=torch.int64).reshape(n, 1).to(device),
        out_lod))
    executor._write_var(scope, op.output("SentenceScores")[0], LoDTensor(
        torch.tensor(flat_scores, dtype=torch.float32).reshape(n, 1)
        .to(device), out_lod))
