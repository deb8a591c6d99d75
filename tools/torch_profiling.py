"""Phases 7, 59, 63 and 64 of ``chip_smoke.py`` alone, on one CUDA card,
and the host cost of the disarmed observability hooks.

    python3 tools/torch_profiling.py [--root DIR] [--repeat N] [7 59 63 64 hooks]

Builds the port's kernels (``support.build()``), then runs phase 7
(gpt_long float32 on the captured route: its replay step), phase 59
(gpt_long's sequence of 8192 over sp=2, its layer norms over S x D, against
one replica), phase 63 (gpt_long bf16 AMP under ``fluid.profiler`` with
every observability knob set, then ``profile_step`` and
``device_profile_step``) and phase 64 (gpt_long under
``DGCMomentumOptimizer`` on one card and over 2 replicas, and the mesh's
profile), or the ones named (default 59 63 64), each ``--repeat`` times.
``hooks`` times each hook the runtime calls on every step with its knob
unset (µs a call over 200,000 calls on the host). ``--root DIR`` runs the
chip_smoke.py and package of another checkout (an earlier commit unpacked
with ``git archive``) for an A/B comparison in one call: run the
checkouts in the order parent, change, change, parent. Prints each phase's
lines and its seconds, then one JSON line of every phase's numbers.
"""
import argparse
import json
import os
import sys
import time

import torch


def hook_costs():
    """µs a call of each step hook with its knob unset."""
    from paddle_tpu_torch import analysis
    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch.core import compiler_engine as ce
    from paddle_tpu_torch.observability import capture, profiler, tracing

    for knob in ("PADDLE_TPU_VERIFY_IR", "PADDLE_TPU_SAMPLE_EVERY",
                 "PADDLE_TPU_PROFILE", "PADDLE_TPU_DEVICE_TRACE"):
        os.environ.pop(knob, None)
    capture.rearm()
    obs.disable()
    profiler.disable_annotation()
    prog, scope, feed = object(), object(), {}

    def span():
        with tracing.span("compiled_step", cat="step"):
            pass

    hooks = {
        "observability.enabled": obs.enabled,
        "compiler_engine.inc": lambda: ce.inc("executor.steps",
                                              path="compiled"),
        "tracing.span": span,
        "capture.maybe_sample_step": lambda: capture.maybe_sample_step(
            "executor", prog, scope, feed),
        "analysis.verify_enabled": analysis.verify_enabled,
        "profiler.annotating": profiler.annotating,
        "empty call": lambda: None,
    }
    n = 200_000
    out = {}
    for name, fn in hooks.items():
        fn()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        out[name] = (time.perf_counter() - t0) / n * 1e6
    print("hooks, disarmed, us a call (host): %s" % json.dumps(out),
          flush=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=None)
    ap.add_argument("--repeat", type=int, default=1)
    ap.add_argument("which", nargs="*")
    args = ap.parse_args()
    root = os.path.abspath(args.root or os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    sys.path.insert(0, root)
    if not torch.cuda.is_available():
        print("torch_profiling: no CUDA device on this host",
              file=sys.stderr)
        return 2
    import chip_smoke as cs
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.ops.cuda import support

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
        False
    which = args.which or ["59", "63", "64"]
    t0 = time.time()
    support.build()
    support.ensure_kernels(torch.device("cuda"))
    print("root %s; build %.1f s; %s" % (root, time.time() - t0,
                                         cs.card_line()), flush=True)
    phases = {"7": lambda: cs.phase_training(fluid, support),
              "59": lambda: cs.phase_hybrid_sp(fluid, support),
              "63": lambda: cs.phase_profiled_gpt(fluid, support),
              "64": lambda: cs.phase_dgc(fluid, support),
              "hooks": hook_costs}
    out = {}
    for ph in which:
        for i in range(max(1, args.repeat)):
            t0 = time.time()
            result = phases[ph]()
            key = ph if args.repeat == 1 else "%s#%d" % (ph, i)
            out[key] = {"seconds": time.time() - t0, "result": result}
            print("phase %s %.1f s" % (key, out[key]["seconds"]),
                  flush=True)
    if "7" in which:
        steps = [v["result"][1]["step_ms"] for k, v in out.items()
                 if k.split("#")[0] == "7"]
        print("phase 7 replay step ms, %s: %s" % (root, json.dumps(steps)),
              flush=True)
    print(json.dumps(out, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
