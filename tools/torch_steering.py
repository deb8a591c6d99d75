"""Phases 65 and 66 of ``chip_smoke.py`` alone, on one CUDA card.

    python3 tools/torch_steering.py [--repeat N] [65 66]

Builds the port's kernels (``support.build()``), then runs phase 65
(placement on gpt_long over 2 replicas: the hand-knob run's profile_step
report, the placement search on it, the winner applied through
``PADDLE_TPU_PLACEMENT_PLAN``, the tree spelling, the async split and the
profile bucket plan forced once each, two planted faults) and phase 66
(steering and the canary on BERT-base serving, the lazy queue's key-cap
policy, and phase 58's two-rank job run with a metrics directory and
merged into one trace), or the ones named (default both), each
``--repeat`` times. Prints each phase's lines and its seconds, then one
JSON line of every phase's numbers.
"""
import argparse
import json
import os
import sys
import time

import torch


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--repeat", type=int, default=1)
    ap.add_argument("which", nargs="*")
    args = ap.parse_args()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    if not torch.cuda.is_available():
        print("torch_steering: no CUDA device on this host", file=sys.stderr)
        return 2
    import chip_smoke as cs
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.ops.cuda import support

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
        False
    which = args.which or ["65", "66"]
    t0 = time.time()
    support.build()
    support.ensure_kernels(torch.device("cuda"))
    print("build %.1f s; %s" % (time.time() - t0, cs.card_line()),
          flush=True)
    phases = {"65": lambda: cs.phase_placement(fluid, support),
              "66": lambda: cs.phase_steering(fluid, support)}
    out = {}
    for ph in which:
        for i in range(max(1, args.repeat)):
            t0 = time.time()
            result = phases[ph]()
            key = ph if args.repeat == 1 else "%s#%d" % (ph, i)
            out[key] = {"seconds": time.time() - t0, "result": result}
            print("phase %s %.1f s" % (key, out[key]["seconds"]), flush=True)
    print(json.dumps(out, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
