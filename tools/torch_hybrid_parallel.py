"""Phases 59-62 of ``chip_smoke.py`` alone, on one CUDA card.

    python3 tools/torch_hybrid_parallel.py [59 60 61 62]

Builds the port's kernels (``support.build()``), then runs phase 59
(gpt_long's sequence of 8192 over sp=2 against one replica through
K1-K3, and the attention times at (1, 16, 8192, 64)), phase 60 (gpt_long
in 2 pipeline stages on pp=2 against the single-device PipelineOptimizer
route), phase 61 (dp2 x pp2 x mp2 against microbatch accumulation, and
the planted mp overcount) and phase 62 (switch_moe at ep=4 against its
dense run), or the ones named. Prints each phase's lines and its
seconds, then one JSON line of every phase's numbers and launch counts.
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
from paddle_tpu_torch.ops.cuda import support  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_hybrid_parallel: no CUDA device on this host",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    which = sys.argv[1:] or ["59", "60", "61", "62"]
    t0 = time.time()
    support.build()
    support.ensure_kernels(torch.device("cuda"))
    print("build %.1f s; %s" % (time.time() - t0, cs.card_line()),
          flush=True)
    phases = {"59": cs.phase_hybrid_sp, "60": cs.phase_hybrid_pp,
              "61": cs.phase_hybrid_3d, "62": cs.phase_hybrid_ep}
    out = {}
    for ph in which:
        t0 = time.time()
        counts, run = phases[ph](fluid, support)
        out[ph] = {"seconds": time.time() - t0, "counts": counts,
                   "run": run}
        print("phase %s %.1f s" % (ph, out[ph]["seconds"]), flush=True)
    print(json.dumps(out, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
