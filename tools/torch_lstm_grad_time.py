"""The CPU time of ``cudnn_lstm``'s grad, its step loop over ``unbind``
against the same loop over slices ``xp[t]``.

    python3 tools/torch_lstm_grad_time.py [--steps 464] [--rounds 2]

Run from the repository root, on the CPU (one torch thread). It runs the
``cudnn_lstm_grad`` op (the registry's auto-VJP: the forward re-run, then
``torch.autograd.grad``) of a one-layer LSTM (batch 16, input and hidden
32) over ``--steps`` steps, in turns with the port's loop
(``ops/rnn_ops._lstm_direction``, over ``unbind``) and with a copy of it
that slices a step at a time, whose backward writes a full-size zero
tensor a step. It prints each run's seconds and whether the two give the
same grads.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from paddle_tpu_torch.core.registry import (DEVICE_ATTR,  # noqa: E402
                                            GENERATOR_ATTR, OpInfoMap)
from paddle_tpu_torch.ops import rnn_ops  # noqa: E402


def sliced_direction(x, h, c, wx, wh, b, hidden, reverse):
    """``rnn_ops._lstm_direction`` with the loop over ``xp[t]``."""
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


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=464)
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    torch.set_num_threads(1)
    T, N, D, H = args.steps, 16, 32, 32
    rng = np.random.RandomState(0)
    info = OpInfoMap.instance().get("cudnn_lstm_grad")
    ins = {"Input": torch.tensor(rng.randn(T, N, D), dtype=torch.float32),
           "InitH": torch.zeros(1, N, H), "InitC": torch.zeros(1, N, H),
           "W": torch.tensor(rng.randn(4 * H * (D + H + 1)) * 0.1,
                             dtype=torch.float32),
           "Out@GRAD": torch.ones(T, N, H)}
    attrs = dict(info.attrs, hidden_size=H, num_layers=1, input_size=D,
                 max_len=T)
    attrs[DEVICE_ATTR] = torch.device("cpu")
    attrs[GENERATOR_ATTR] = torch.Generator().manual_seed(0)
    loops = {"unbind": rnn_ops._lstm_direction, "slices": sliced_direction}
    grads = {}
    try:
        for _ in range(args.rounds):
            for name in ("slices", "unbind", "unbind", "slices"):
                rnn_ops._lstm_direction = loops[name]
                t0 = time.perf_counter()
                grads[name] = info.fn(ins, attrs)
                print("%s %.3f s (T %d, N %d, D %d, H %d, CPU, 1 thread)"
                      % (name, time.perf_counter() - t0, T, N, D, H))
    finally:
        rnn_ops._lstm_direction = loops["unbind"]
    same = all(torch.equal(grads["unbind"][k], grads["slices"][k])
               for k in grads["unbind"])
    print("grads equal: %s" % same)
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
