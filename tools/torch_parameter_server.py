"""Phases 67, 68 and 69 of ``chip_smoke.py`` alone, on one CUDA card.

    python3 tools/torch_parameter_server.py [--repeat N] [67 68 geo 69]

Builds the port's kernels (``support.build()``), then runs phase 67 (sync
PS: bench.py's Wide&Deep at full width over 2 pservers and 2 trainers on
the card through the launcher, held against the untranspiled program),
phase 68 (the async PS through the Communicator fed by globally shuffled
InMemoryDatasets, with the launcher's serving role beside it) and
``geo`` (phase 68's geo-SGD half: K4 on the geo trainer's update) and
phase 69 (the survivable PS: a primary killed and failed over, the whole
job killed and cold-restored, a hot row range migrated), or the ones named
(default all), each ``--repeat`` times. Prints each phase's
lines and its seconds, then one JSON line of every phase's numbers.
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
        print("torch_parameter_server: no CUDA device on this host",
              file=sys.stderr)
        return 2
    import chip_smoke as cs
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.ops.cuda import fused_optimizer as fo
    from paddle_tpu_torch.ops.cuda import support

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
        False
    which = args.which or ["67", "68", "geo", "69"]
    t0 = time.time()
    support.build()
    support.ensure_kernels(torch.device("cuda"))
    print("build %.1f s; %s" % (time.time() - t0, cs.card_line()),
          flush=True)
    phases = {"67": lambda: cs.phase_ps_sync(fluid, support),
              "68": lambda: cs.phase_ps_async_serving(fluid, support),
              "geo": lambda: cs.phase_ps_geo(fluid, support, fo),
              "69": lambda: cs.phase_ps_survive(fluid, support)}
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
