"""Every tile configuration of the fused conv (K5) at ResNet-50's shapes.

    python3 tools/torch_conv_tiles.py [--batch 128] [--dtype both] [--ptxas]

Run from the repository root on a CUDA card. For each of the 19 conv
shapes that ``FLAGS_use_pallas_conv=all`` routes to K5 in ResNet-50 NHWC
(``chip_smoke.resnet_routed_convs``), in float32 and in bfloat16, it runs
K5 with each of ``ops/cuda/conv.TILES`` forced, holds the output to the
plain version (``chip_smoke.K5_TOL`` of the output's scale), says whether
every configuration gives the bits of the first, and times each
(``chip_smoke.time_ms``, CUDA events) beside cuDNN's ``F.conv2d`` on
channels-last tensors (TF32 off). It prints one JSON line a shape and
type, then for each type the sums over the 44 convs of one forward: each
configuration alone, the best per shape, ``choose_tile``'s choice and
cuDNN. ``--ptxas`` first compiles the kernel's source with ``-Xptxas -v``
and prints each instantiation's registers and spills.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402


def ptxas_report(support) -> None:
    with tempfile.TemporaryDirectory() as tmp:
        out = subprocess.run(
            [support.nvcc_path(), *support.NVCC_FLAGS, "-Xptxas", "-v",
             "-o", os.path.join(tmp, "k5.so"),
             str(support.CSRC_DIR / "conv2d_bn_act.cu")],
            capture_output=True, text=True, timeout=600)
    for line in (out.stdout + out.stderr).splitlines():
        if any(k in line for k in ("Compiling entry", "registers", "spill",
                                   "error", "warning")):
            print("ptxas", line.strip(), flush=True)
    if out.returncode:
        raise RuntimeError("nvcc failed (exit %d)" % out.returncode)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=cs.RESNET_BATCH)
    ap.add_argument("--dtype", choices=("float32", "bfloat16", "both"),
                    default="both")
    ap.add_argument("--ptxas", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_conv_tiles: no CUDA device", file=sys.stderr)
        return 2
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.ops.cuda import conv as k5
    from paddle_tpu_torch.ops.cuda import support

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("card %s; torch %s, CUDA %s" % (cs.card_line(), torch.__version__,
                                          torch.version.cuda), flush=True)
    if args.ptxas:
        ptxas_report(support)
    F = torch.nn.functional
    shapes = cs.resnet_routed_convs(fluid, args.batch)
    n_tiles = len(k5.TILES)
    sums = {}
    for dtype in (torch.float32, torch.bfloat16):
        key = str(dtype).replace("torch.", "")
        if args.dtype not in ("both", key):
            continue
        tot = {"tile%d" % t: 0.0 for t in range(n_tiles)}
        tot.update(best=0.0, chosen=0.0, cudnn=0.0)
        for i, (xs, ws, stride, pad, count) in enumerate(shapes):
            x, w, _ = cs.k5_inputs(xs, ws, stride, pad, dtype, False,
                                   seed=50 + i)
            ref = k5.conv2d_bn_act_reference(x, w, stride=stride,
                                             padding=pad).float()
            scale = ref.abs().max().item()
            B, H, W, _ = xs
            Ho = (H + 2 * pad - ws[0]) // stride + 1
            Wo = (W + 2 * pad - ws[1]) // stride + 1
            M, N = B * Ho * Wo, ws[3]
            nbytes, flops = cs.k5_work(xs, ws, stride, pad)
            row = {"dtype": key, "x": list(xs), "w_hwio": list(ws),
                   "stride": stride, "count": count, "M": M, "N": N,
                   "chosen": k5.choose_tile(M, N, dtype)}
            first, same, ms = None, True, []
            for t in range(n_tiles):
                y = k5.conv2d_bn_act(x, w, stride=stride, padding=pad,
                                     tile=t)
                torch.cuda.synchronize()
                rel = (y.float() - ref).abs().max().item() / scale
                if not rel <= cs.K5_TOL[dtype]:
                    raise RuntimeError("tile %d, %s: %g of the scale" %
                                       (t, row, rel))
                if first is None:
                    first = y
                else:
                    same = same and torch.equal(y, first)
                ms.append(cs.time_ms(lambda: k5.conv2d_bn_act(
                    x, w, stride=stride, padding=pad, tile=t), iters=20,
                    warmup=3))
                row["rel_err_tile%d" % t] = rel
            xc = x.permute(0, 3, 1, 2)
            wc = w.permute(3, 2, 0, 1).contiguous(
                memory_format=torch.channels_last)
            cud = cs.time_ms(lambda: F.conv2d(xc, wc, None, stride, pad),
                             iters=20, warmup=3)
            row.update({"ms_tile%d" % t: ms[t] for t in range(n_tiles)})
            row.update(same_bits=same, cudnn_ms=cud,
                       tflops_chosen=flops / ms[row["chosen"]] / 1e9)
            print("tiles %s" % json.dumps(row), flush=True)
            for t in range(n_tiles):
                tot["tile%d" % t] += count * ms[t]
            tot["best"] += count * min(ms)
            tot["chosen"] += count * ms[row["chosen"]]
            tot["cudnn"] += count * cud
            del x, w, ref, y, first, xc, wc
            torch.cuda.empty_cache()
        sums[key] = tot
        print("tiles sum over %d convs, %s: %s" % (
            sum(s[-1] for s in shapes), key, json.dumps(tot)), flush=True)
    print("card %s" % cs.card_line(), flush=True)
    print(json.dumps({"tile_sums_ms": sums}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
