"""Phases 56-58 of ``chip_smoke.py`` alone, on one CUDA card.

    python3 tools/torch_data_parallel.py [56 57 58]

Builds the port's kernels (``support.build()``), then runs phase 56
(gpt_long over two replicas on the card: per-grad, bucketed, int8 and the
sharded update on K4, against one replica's full batch, the planted
faults, K4 at a replica's shard and K1-K3 at a replica's attention
shape), phase 57
(ResNet-50 under sync batch norm, batch 128 as 2 x 64) and phase 58 (two
ranks through ``paddle_tpu_torch.distributed.launch``), or the ones named.
Prints each phase's lines and its seconds, then one JSON line of every
phase's numbers and launch counts.
"""
import json
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402
import paddle_tpu_torch as fluid  # noqa: E402
from paddle_tpu_torch.ops.cuda import flash_attention as fa  # noqa: E402
from paddle_tpu_torch.ops.cuda import support  # noqa: E402


def dp_gpt():
    counts, run = cs.phase_dp_gpt(fluid, support)
    run["k1"] = cs.k1_check(fa, cs.DP_ATTN, None, True, torch.float32, 56,
                            timed=True, phase=56)
    bwd = cs.bwd_check(fa, cs.DP_ATTN, None, True, torch.float32, 66,
                       timed=True, phase=56)
    run["k2_k3"] = {k: v for k, v in bwd.items()
                    if isinstance(v, (int, float, str, bool))}
    return counts, run


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_data_parallel: no CUDA device on this host",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    which = sys.argv[1:] or ["56", "57", "58"]
    t0 = time.time()
    support.build()
    support.ensure_kernels(torch.device("cuda"))
    print("build %.1f s; %s" % (time.time() - t0, cs.card_line()),
          flush=True)
    out = {}
    phases = {"56": dp_gpt,
              "57": lambda: cs.phase_dp_resnet(fluid, support),
              "58": cs.phase_dp_multiprocess}
    for ph in which:
        t0 = time.time()
        counts, run = phases[ph]()
        print("phase %s %.1f s" % (ph, time.time() - t0), flush=True)
        out[ph] = {"counts": counts, "run": run}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
