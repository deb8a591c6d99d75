"""Phases 51-53 of ``chip_smoke.py`` alone, on one CUDA card.

    python3 tools/torch_serving_front.py

Builds the port's kernels (``support.build()``), then runs phase 51 (BERT-
base with the predictor's IR passes on and off, and behind
``start_http_server``), phase 52 (ResNet-50 inference folded and unfolded,
on K5) and phase 53 (64 decode streams over ``/generate`` and through a
``FleetRouter`` of two replicas, one stopped part way). Phase 53 needs
phase 13's streams and their in-process tokens: this script decodes them
with one ``DecodeEngine`` in two bursts (the second warm) and hands
phase 53 the second burst's tokens/s and the engine's TTFT and ITL in
phase 13's place. Prints each phase's lines and its seconds, then one JSON
line of every phase's numbers and launch counts.
"""
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402
import paddle_tpu_torch as fluid  # noqa: E402
from paddle_tpu_torch.ops.cuda import support  # noqa: E402
from paddle_tpu_torch.serving.decode import DecodeConfig  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_serving_front: no CUDA device on this host",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
        False
    t0 = time.time()
    support.build()
    support.ensure_kernels(torch.device("cuda"))
    print("build %.1f s; %s" % (time.time() - t0, cs.card_line()),
          flush=True)
    t0 = time.time()
    ir, http, run = cs.phase_serving_http(fluid, support)
    print("phase 51 %.1f s" % (time.time() - t0), flush=True)
    t0 = time.time()
    cnt, rrun = cs.phase_resnet_infer(fluid, support)
    print("phase 52 %.1f s" % (time.time() - t0), flush=True)
    t0 = time.time()
    cfg = DecodeConfig(**cs.DECODE, eos_token=None,
                       max_waiting=2 * cs.N_STREAMS,
                       place=fluid.CUDAPlace(0))
    specs = cs.decode_specs(np.random.RandomState(cs.SEED + 9), cs.N_STREAMS,
                            cs.PROMPT_RANGE, cs.MAX_TOKENS_RANGE,
                            cfg.vocab_size)
    eng = cs.new_decode_engine(support, cfg, torch.device("cuda"))
    outs, _, _, _ = cs.engine_burst(eng, specs, "w")
    outs2, wall2, _, _ = cs.engine_burst(eng, specs, "x")
    if outs != outs2:
        raise RuntimeError("two bursts of one engine decoded other tokens")
    st = eng.stats()
    eng.stop()
    tokens = sum(n for _, n in specs)
    drun = {"tokens_per_s": tokens / wall2,
            "ttft_ms_p50": st["serving.ttft_ms"]["p50"],
            "ttft_ms_p99": st["serving.ttft_ms"]["p99"],
            "itl_ms_p50": st["serving.itl_ms"]["p50"],
            "itl_ms_p99": st["serving.itl_ms"]["p99"]}
    print("in-process decode (two bursts) %.1f s: %s"
          % (time.time() - t0, json.dumps(drun)), flush=True)
    t0 = time.time()
    a, b, r = cs.phase_decode_http(fluid, support, specs, outs, drun)
    print("phase 53 %.1f s" % (time.time() - t0), flush=True)
    print(json.dumps({"51": run, "52": rrun, "53": r,
                      "counts": [ir, http, cnt, a, b]}, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
