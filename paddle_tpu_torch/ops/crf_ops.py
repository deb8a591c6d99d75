"""``linear_chain_crf`` and ``crf_decoding`` (counterparts of
``paddle_tpu/ops/misc_ops.py:548`` and ``:596``), with the same slots,
over DENSE ``[B, T, K]`` emissions (a 2-D ``[T, K]`` is one sequence).

``Transition`` is ``[K+2, K]``, the reference's layout: row 0 the start
weights, row 1 the end weights, rows 2.. the K x K transition matrix.

- ``linear_chain_crf``: the negative log-likelihood of ``Label`` as
  ``LogLikelihood`` ``[B, 1]``: the forward algorithm's log partition
  (``logsumexp`` over the previous tag, one step a time) less the gold
  path's score. ``Alpha`` is the last step's forward scores, as in the JAX
  package; ``EmissionExps`` / ``TransitionExps`` the exponentials. Its grad
  is the auto-VJP, for Emission and Transition.
- ``crf_decoding``: the Viterbi path ``[B, T]`` (int64); with ``Label``,
  the 0/1 match of the path against it, as the reference gives.

Both walk T with ``unbind``: a step's slice ``x[:, t]`` would make the
backward quadratic in T (each slice's grad is a full-size scatter).
``torch.argmax``, as ``jnp.argmax``, takes the first maximum, so ties
decode the same in both packages.
"""
from __future__ import annotations

import torch

from ..core.registry import In, Out, register_op


def _batched(em):
    return em[None] if em.dim() == 2 else em


@register_op(
    "linear_chain_crf",
    inputs=[In("Emission"), In("Transition"), In("Label", no_grad=True)],
    outputs=[Out("Alpha", no_grad=True), Out("EmissionExps", no_grad=True),
             Out("TransitionExps", no_grad=True), Out("LogLikelihood")],
)
def _linear_chain_crf(ins, attrs):
    em = _batched(ins["Emission"])
    trans = ins["Transition"]
    b = em.shape[0]
    labels = ins["Label"].reshape(b, -1).long()
    start, end, t_mat = trans[0], trans[1], trans[2:]

    steps = em.unbind(1)
    alpha = start[None, :] + steps[0]
    for e_t in steps[1:]:
        alpha = torch.logsumexp(
            alpha[:, :, None] + t_mat[None, :, :] + e_t[:, None, :], dim=1)
    log_z = torch.logsumexp(alpha + end[None, :], dim=1)

    gold = (start[labels[:, 0]]
            + em.gather(2, labels[:, :, None])[:, :, 0].sum(dim=1)
            + t_mat[labels[:, :-1], labels[:, 1:]].sum(dim=1)
            + end[labels[:, -1]])
    return {"LogLikelihood": (log_z - gold).reshape(b, 1),
            "Alpha": alpha, "EmissionExps": torch.exp(em),
            "TransitionExps": torch.exp(trans)}


@register_op(
    "crf_decoding",
    inputs=[In("Emission", no_grad=True), In("Transition", no_grad=True),
            In("Label", dispensable=True, no_grad=True)],
    outputs=[Out("ViterbiPath")],
    grad=None,
)
def _crf_decoding(ins, attrs):
    em = _batched(ins["Emission"])
    trans = ins["Transition"]
    start, end, t_mat = trans[0], trans[1], trans[2:]
    b, t, _ = em.shape

    steps = em.unbind(1)
    delta = start[None, :] + steps[0]
    back = []
    for e_t in steps[1:]:
        scores = delta[:, :, None] + t_mat[None, :, :]
        back.append(torch.argmax(scores, dim=1))
        delta = scores.amax(dim=1) + e_t
    state = torch.argmax(delta + end[None, :], dim=1)
    path = [state]
    for bp in reversed(back):
        state = bp.gather(1, state[:, None])[:, 0]
        path.append(state)
    path = torch.stack(path[::-1], dim=1).long()
    if ins.get("Label") is not None:
        lab = ins["Label"].reshape(b, t).long()
        return {"ViterbiPath": (path == lab).long()}
    return {"ViterbiPath": path}
