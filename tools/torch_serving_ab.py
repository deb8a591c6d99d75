"""Serving A/B for the PyTorch port on one CUDA card.

Runs phase 4 of ``chip_smoke.py`` (BERT-base behind ``ServingEngine``: 256
requests at once, the same 256 one at a time, and a profiled window of
three predictor runs) for two checkouts of the repo, alternately A, B, B,
A (``--rounds`` times over), each run in a process of its own. Both
checkouts then meet the same host, whose clock moves host-bound serving
numbers by tens of percent from one machine, and one minute, to the next.

    python3 tools/torch_serving_ab.py A_DIR [B_DIR] [--rounds N]

B_DIR defaults to the checkout that holds this script. Each run builds its
checkout's kernels first (phase 2). Prints every run's phase 4 lines, then
one JSON line: for each run its checkout, p50 and p99 latency one at a
time, the burst's sequences per second and the profiled idle share, and
for each checkout the median of each over its runs.

With ``--host-profile`` each run instead times the predictor alone on one
1-row request of phase 4's traffic (200 runs after 20 warm ones, each
ending in its host copy), profiles 100 more with ``cProfile`` and traces
20 more with ``torch.profiler``: it prints the median wall of a run, the
functions that take the most host time of their own, the device's busy
time a run and the CUDA runtime calls that take the most host time
(a host copy that waits for the device shows there), so that a
difference between the checkouts can be placed.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import subprocess
import sys

CHILD = """
import sys
sys.path.insert(0, sys.argv[1])
import torch
import chip_smoke as cs
import paddle_tpu_torch as fluid
from paddle_tpu_torch.ops.cuda import support
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
cs.phase_build_and_probe(support)
cs.phase_serving(fluid, support)
"""

CHILD_HOST_PROFILE = """
import cProfile, pstats, statistics, sys, tempfile, time
sys.path.insert(0, sys.argv[1])
import numpy as np
import torch
import chip_smoke as cs
import paddle_tpu_torch as fluid
from paddle_tpu_torch.inference import AnalysisConfig, create_paddle_predictor
from paddle_tpu_torch.ops.cuda import support
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
cs.phase_build_and_probe(support)
np.random.seed(cs.SEED)
torch.manual_seed(cs.SEED)
feed = cs.make_requests(np.random.RandomState(cs.SEED))[0]
feed = {k: v[:1] for k, v in feed.items()}
with tempfile.TemporaryDirectory() as d:
    cs.build_and_save(fluid, d)
    pred = create_paddle_predictor(AnalysisConfig(d))
    for _ in range(20):
        pred.run(feed)
    walls = []
    for _ in range(200):
        t0 = time.perf_counter()
        pred.run(feed)
        walls.append((time.perf_counter() - t0) * 1e3)
    print("phase 4 host-profile: one 1-row request, median run %.3f ms, "
          "p10 %.3f, p90 %.3f over 200 runs"
          % (statistics.median(walls), np.percentile(walls, 10),
             np.percentile(walls, 90)))
    prof = cProfile.Profile()
    prof.enable()
    for _ in range(100):
        pred.run(feed)
    prof.disable()
    st = pstats.Stats(prof)
    rows = sorted(st.stats.items(), key=lambda kv: -kv[1][2])[:15]
    for (fn, line, name), (cc, nc, tt, ct, _) in rows:
        print("phase 4 host-profile   %8.3f ms own %8.3f ms with callees "
              "a run  %6d calls  %s:%d(%s)"
              % (tt * 10, ct * 10, nc, fn.split("/")[-1], line, name))
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as tp:
        t0 = time.perf_counter()
        for _ in range(20):
            pred.run(feed)
        wall = (time.perf_counter() - t0) * 1e3 / 20
    busy, api = 0.0, {}
    for e in tp.key_averages():
        t_us = getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))
        if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA:
            busy += t_us / 1e3 / 20
        elif e.key.startswith("cuda"):
            api[e.key] = (e.self_cpu_time_total / 1e3 / 20, e.count / 20)
    print("phase 4 host-profile trace, 20 runs: wall %.3f ms a run, device "
          "busy %.3f ms a run" % (wall, busy))
    for key, (ms, n) in sorted(api.items(), key=lambda kv: -kv[1][0])[:6]:
        print("phase 4 host-profile trace   %8.3f ms a run  %7.1f calls a "
              "run  %s" % (ms, n, key))
"""

PATTERNS = {
    "one_at_a_time_p50_ms": r"one at a time .*latency p50 ([\d.]+) ms",
    "one_at_a_time_p99_ms": r"one at a time .*latency p50 [\d.]+ ms p99 "
                            r"([\d.]+) ms",
    "burst_sequences_per_s": r"at once .* ([\d.]+) sequences/s",
    "idle_share": r"profile, .*idle share ([\d.]+)",
}


def run(tree: str, child: str = CHILD) -> dict:
    proc = subprocess.run([sys.executable, "-c", child, tree], cwd=tree,
                          capture_output=True, text=True)
    lines = [l for l in proc.stdout.splitlines() if l.startswith("phase 4")]
    for line in lines:
        print("[%s] %s" % (tree, line[:200]), flush=True)
    if proc.returncode != 0:
        sys.stderr.write(proc.stderr[-4000:])
        raise SystemExit("phase 4 failed in %s (exit %d)"
                         % (tree, proc.returncode))
    out = {"tree": tree}
    text = "\n".join(lines)
    for key, pat in PATTERNS.items():
        m = re.search(pat, text)
        out[key] = float(m.group(1)) if m else None
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("a")
    ap.add_argument("b", nargs="?", default=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), os.pardir))
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--host-profile", action="store_true")
    args = ap.parse_args()
    a, b = os.path.abspath(args.a), os.path.abspath(args.b)
    if args.host_profile:
        for t in (a, b, b, a) * args.rounds:
            run(t, CHILD_HOST_PROFILE)
        return 0
    runs = [run(t) for t in (a, b, b, a) * args.rounds]
    medians = {t: {k: statistics.median(r[k] for r in runs
                                        if r["tree"] == t)
                   for k in PATTERNS} for t in (a, b)}
    print(json.dumps({"serving_ab": runs, "medians": medians}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
