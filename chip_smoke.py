#!/usr/bin/env python3
"""Smoke run of paddle_tpu_torch on one NVIDIA H100 (or other Hopper card).

    python3 chip_smoke.py

Run from the repository root. It drives the port's two main paths at full
width, serving (BERT-base) and training (gpt_long), and holds each
hand-written CUDA kernel against its plain PyTorch version on the card.
Phases, one or more lines each:

1. card and settings: name and power limit (nvidia-smi), torch version;
   TF32 off for float32 products;
2. build and probe: compile every kernel source with nvcc (timed as
   set-up) and hold the probe kernel (K7, x + 1) against its plain version;
3. K1, flash-attention forward, against its plain version at the serving
   shape B=8, H=12, S=128, D=64 with key lengths spread over 0..128,
   causal off and on, float32 and bfloat16 (and D=128 for correctness),
   and at the training shape B=2, H=16, S=4096, D=64 causal float32:
   largest error of O and of LSE on rows that see a key, kernel time,
   plain time, the time of torch's scaled_dot_product_attention with the
   same boolean mask (a yardstick the port never calls), and the bound;
4. the serving path: BERT-base (12 layers, 12 heads, d_model 768, d_ff
   3072, vocab 30522, max_len 512, T=128) built with seeded random
   weights on the card, saved, loaded by create_paddle_predictor and
   served by a ServingEngine (max_batch_size 8) to 256 ragged requests of
   1-4 rows, first all at once, then the same 256 one at a time; launch
   counts are zeroed after the model is saved and read just after the
   engine stops, and the probe memo is cleared with them, so the
   predictor's own executor launches the probe; every output must be
   finite, K1 must run 12 times per dispatched batch and the probe once,
   and some requests are re-run through a CPU predictor and compared;
   then a torch.profiler window over served batches says where device
   time goes;
5. K2 and K3, flash-attention backward (dQ; dK and dV), against their
   plain version at the training shape B=2, H=16, S=4096, D=64 causal
   float32, and at the serving shape with its key lengths, causal off and
   on, float32 and bfloat16 (and D=128 for correctness): largest error of
   dQ, dK and dV against their scale, each kernel's time, the plain
   backward's time, the time of the backward of torch's
   scaled_dot_product_attention(is_causal=True) on the same tensors (a
   yardstick the port never calls), and the bounds;
6. K4, the fused optimizer update, against its plain version: adam over
   the training path's 83,912,704-element flat buffer, and sgd, momentum
   (Nesterov off and on) and adamw at a small size, every case bitwise
   equal; kernel time, plain time, the time of one torch._fused_adam_
   call over the same buffers (a yardstick; its formula differs) and the
   bound;
7. the training path: gpt_long (2 layers, d_model 1024, 16 heads of 64,
   vocab 8192, batch 2, seq 4096; causal flash attention; Adam 1e-4) in
   float32 with seeded random weights, ids and labels, built with
   fluid.layers, AdamOptimizer.minimize (append_backward) and run by
   Executor().run with PADDLE_TPU_FUSED_OPTIMIZER set as bench.py sets it:
   the startup on the card, one warm-up step, then 5 steps on one batch
   with the launch counts zeroed just before and read just after. The
   program must hold one fused_optimizer op, the loss must be finite and
   fall, and K1, K2, K3 and K4 must run 20, 10, 10 and 5 times; step time,
   tokens/s and peak memory, then a torch.profiler window over one step;
8. a narrow twin of the training script trained 3 steps on the card and
   through CPUPlace() from the same persistables: the losses and the
   first step's grads must agree, and the card run must go through K1,
   K2, K3 and K4;
9. one JSON line {"kernels": [...]} with each kernel's launches on the
   main paths (by path beside), error, times and bound;
10. the last line: {"ok": true, "device": {...}}.

Any failure raises and exits non-zero without the last line. Without a
CUDA device it exits 2 and prints no result.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

SEED = 0
SEQ_LEN = 128
BERT = dict(vocab_size=30522, max_len=512, num_layers=12, num_heads=12,
            d_model=768, d_ff=3072)
MAX_BATCH = 8
N_REQUESTS = 256      # per regime: enough for a p99 to mean something
N_CPU_CHECKS = 4
CPU_TOL = 1e-3        # card vs CPU predictor, float32 with TF32 off
# kernel vs its plain version on the same card inputs. float32: both
# accumulate in float32 in other orders (observed ~5e-7). bfloat16: both
# round O to bfloat16, whose spacing is 2^-7 = 7.8e-3 near |O| ~ 1-2, so
# one rounding step apart is up to 7.8e-3; 2e-2 allows two.
KERNEL_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
LSE_TOL = 2e-5        # LSE is float32 for either input type
K1_SHAPE = (8, 12, SEQ_LEN, 64)
K1_LENGTHS = (0, 1, 37, 64, 100, 128, 77, 128)
# training: bench.py's gpt_long (models.gpt.GPT_LONG) in float32, and the
# narrow twin (the CPU tests' script with 2 heads of 64, the smallest head
# the kernels take)
GPT_TWIN = dict(batch=2, seq_len=32, d_model=128, n_heads=2, n_layers=2,
                vocab=128)
TRAIN_STEPS = 5
TWIN_STEPS = 3
# card vs CPU twin losses: float32 with TF32 off; products, softmax and the
# embedding grad (index_add_) sum in another order on the card
TWIN_RTOL = 1e-4
# K2/K3 vs their plain version, relative to each grad's largest magnitude:
# float32 sums in another order; bfloat16 rounds dQ, dK, dV once (2^-8
# relative), twice allowed
BWD_TOL = {torch.float32: 2e-5, torch.bfloat16: 1e-2}
BWD_SHAPE = (2, 16, 4096, 64)   # the training path's attention
K4_SIZE = 83912704              # the training path's flat Adam buffer
# H100 SXM peaks (NVIDIA data sheet, dense): bytes/s and FLOP/s by type
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 200, warmup: int = 20) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls, from
    CUDA events after a warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(bytes_moved: float, flops: float, peak_flops: float):
    t_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# -- phase 2: build and the probe kernel (K7) -------------------------------

def phase_build_and_probe(support):
    t0 = time.perf_counter()
    paths = support.build()
    log("phase 2 build: %d libraries in %.2f s (%s)"
        % (len(paths), time.perf_counter() - t0,
           ", ".join(p.name for p in paths.values())))
    x = torch.arange(8 * 128, dtype=torch.float32,
                     device="cuda").reshape(8, 128)
    y = support.probe_add_one(x)
    torch.cuda.synchronize()
    err = (y - support.add_one_reference(x)).abs().max().item()
    if err != 0.0:
        raise RuntimeError("probe kernel disagrees with x + 1: %g" % err)
    ms = time_ms(lambda: support.probe_add_one(x), iters=1000)
    plain_ms = time_ms(lambda: support.add_one_reference(x), iters=1000)
    lib_ms = time_ms(lambda: torch.add(x, 1.0), iters=1000)
    b_ms, b_by = bound(2 * x.numel() * 4, x.numel(),
                       PEAK_FLOPS[torch.float32])
    log("phase 2 probe [8,128] f32: max_abs_err %g, %.5f ms (plain %.5f, "
        "torch.add %.5f, bound %.6f ms by %s)"
        % (err, ms, plain_ms, lib_ms, b_ms, b_by))
    return {"name": "probe_add_one", "route": "cuda",
            "source": "paddle_tpu_torch/csrc/probe.cu",
            "replaces": "paddle_tpu/ops/pallas/support.py:35",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms}


# -- phase 3: flash-attention forward (K1) ----------------------------------

def k1_work(shape, lengths, causal, dtype):
    """Bytes and FLOPs these inputs need: every query row read, keys and
    values only below each batch's length, O and LSE written once."""
    B, H, S, D = shape
    esize = torch.tensor([], dtype=dtype).element_size()
    lens = [min(max(int(n), 0), S) for n in lengths]
    bytes_moved = (B * H * S * D * esize * 2            # Q read, O written
                   + 2 * H * sum(lens) * D * esize      # K, V read
                   + B * H * S * 4 + B * 4)             # LSE, lengths
    visible = 0
    for n in lens:
        visible += (sum(min(n, q + 1) for q in range(S)) if causal
                    else S * n)
    return bytes_moved, 4.0 * D * H * visible


def k1_inputs(shape, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(shape, generator=g).to(dtype).cuda()
            for _ in range(3)]


def k1_check(fa, shape, lengths, causal, dtype, seed, timed):
    q, k, v = k1_inputs(shape, dtype, seed)
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    o, lse = fa.flash_attention(q, k, v, causal, None, lens)
    torch.cuda.synchronize()
    ro, rlse = fa.flash_attention_reference(q, k, v, causal, None, lens)
    B, H, S, _ = shape
    err_o = (o.float() - ro.float()).abs().max().item()
    seen = (lens > 0)[:, None, None].expand(B, H, S).reshape(B * H, S)
    err_lse = (lse - rlse).abs()[seen].max().item()
    tol = KERNEL_TOL[dtype]
    if not (err_o <= tol and err_lse <= LSE_TOL
            and bool(torch.isfinite(o.float()).all())):
        raise RuntimeError(
            "K1 disagrees with its plain version (%s, causal=%s, D=%d): "
            "O err %g (tol %g), LSE err %g (tol %g)"
            % (dtype, causal, shape[-1], err_o, tol, err_lse, LSE_TOL))
    row = {"dtype": str(dtype).replace("torch.", ""), "causal": causal,
           "D": shape[-1], "err_o": err_o, "err_lse": err_lse}
    if timed:
        pos = torch.arange(S, device="cuda")
        mask = (pos[None, None, None, :] < lens[:, None, None, None])
        if causal:
            mask = mask & (pos[:, None] >= pos[None, :])
        sdpa = torch.nn.functional.scaled_dot_product_attention
        long = S >= 1024
        row["ms"] = time_ms(lambda: fa.flash_attention(
            q, k, v, causal, None, lens), iters=5 if long else 200,
            warmup=2 if long else 20)
        row["plain_ms"] = time_ms(lambda: fa.flash_attention_reference(
            q, k, v, causal, None, lens), iters=3 if long else 50,
            warmup=1 if long else 20)
        row["library_ms"] = time_ms(lambda: sdpa(q, k, v, attn_mask=mask),
                                    iters=5 if long else 200,
                                    warmup=2 if long else 20)
        nbytes, flops = k1_work(shape, lengths, causal, dtype)
        row["bound_ms"], row["bound_by"] = bound(nbytes, flops,
                                                 PEAK_FLOPS[dtype])
    log("phase 3 K1 %s" % json.dumps(row))
    return row


def phase_flash(fa):
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        for causal in (False, True):
            rows.append(k1_check(fa, K1_SHAPE, K1_LENGTHS, causal, dtype,
                                 seed=len(rows), timed=True))
    for dtype in (torch.float32, torch.bfloat16):
        rows.append(k1_check(fa, K1_SHAPE[:3] + (128,), K1_LENGTHS, False,
                             dtype, seed=10, timed=False))
    # the training path's attention: full lengths, causal
    train = k1_check(fa, BWD_SHAPE, [BWD_SHAPE[2]] * BWD_SHAPE[0], True,
                     torch.float32, seed=11, timed=True)
    rows.append(train)
    torch.cuda.empty_cache()
    by_dtype = {}
    for r in rows:  # O and LSE, every dtype, causal setting and D
        by_dtype[r["dtype"]] = max(by_dtype.get(r["dtype"], 0.0),
                                   r["err_o"], r["err_lse"])
    main = rows[0]  # float32, causal off: what the encoder runs
    return {"name": "flash_attention_forward", "route": "cuda",
            "source": "paddle_tpu_torch/csrc/flash_attention.cu",
            "replaces": "paddle_tpu/ops/pallas/flash_attention.py:184",
            "max_abs_err": max(by_dtype.values()),
            "max_abs_err_by_dtype": by_dtype, "ms": main["ms"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"],
            "library_ms": main["library_ms"],
            "training_shape": {k: train[k] for k in (
                "ms", "plain_ms", "library_ms", "bound_ms", "bound_by")}}


# -- phase 4: the serving path ------------------------------------------------

def build_and_save(fluid, dirname):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        src = fluid.data(name="src_ids", shape=[-1, SEQ_LEN], dtype="int64")
        pos = fluid.data(name="pos_ids", shape=[-1, SEQ_LEN], dtype="int64")
        lens = fluid.data(name="lengths", shape=[-1], dtype="int32")
        enc = fluid.models.transformer.transformer_encoder(
            src, pos, is_test=True, src_lengths=lens, **BERT)
    exe = fluid.Executor()  # the card
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        exe.run(startup)
        fluid.io.save_inference_model(dirname,
                                      ["src_ids", "pos_ids", "lengths"],
                                      [enc], exe, main_program=main)
    return len(main.global_block().ops)


def make_requests(rng):
    reqs = []
    for _ in range(N_REQUESTS):
        rows = int(rng.randint(1, 5))
        reqs.append({
            "src_ids": rng.randint(0, BERT["vocab_size"],
                                   (rows, SEQ_LEN)).astype("int64"),
            "pos_ids": np.tile(np.arange(SEQ_LEN), (rows, 1)).astype(
                "int64"),
            "lengths": rng.randint(1, SEQ_LEN + 1, rows).astype("int32")})
    return reqs


def serve_burst(engine, reqs):
    """Submit every request at once; per-request latency is submit to
    result on the host clock."""
    done = {}
    lock = threading.Lock()
    futures = []
    t0 = time.perf_counter()
    for i, feed in enumerate(reqs):
        t_sub = time.perf_counter()
        fut = engine.submit(feed)

        def _record(_f, i=i, t_sub=t_sub):
            with lock:
                done[i] = time.perf_counter() - t_sub

        fut.add_done_callback(_record)
        futures.append(fut)
    outs = [f.result(timeout=600) for f in futures]
    wall = time.perf_counter() - t0
    return outs, [done[i] for i in range(len(reqs))], wall


def serve_one_at_a_time(engine, reqs):
    """Latency with nothing else queued: each request waits for the last."""
    lat = []
    for feed in reqs:
        t0 = time.perf_counter()
        engine.predict(feed, timeout=600)
        lat.append(time.perf_counter() - t0)
    return lat


def pcts(lat_s):
    ms = np.asarray(lat_s) * 1e3
    return np.percentile(ms, 50), np.percentile(ms, 99), ms.max()


def profile_window(pred, feed, iters=3):
    """Device time by kernel over ``iters`` predictor runs of one batch."""
    from torch.profiler import ProfilerActivity, profile

    pred.run(feed)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            pred.run(feed)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = []
    for e in prof.key_averages():
        if getattr(e, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        t_us = getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))
        kernels.append((t_us / 1e3, e.count, e.key))
    kernels.sort(reverse=True)
    busy_ms = sum(k[0] for k in kernels)
    return wall_ms, busy_ms, kernels


def phase_serving(fluid, support):
    from paddle_tpu_torch.inference import (AnalysisConfig,
                                            create_paddle_predictor)
    from paddle_tpu_torch.serving import ServingConfig, ServingEngine

    np.random.seed(SEED)   # the executor's RNG seed comes from numpy
    torch.manual_seed(SEED)
    rng = np.random.RandomState(SEED)
    reqs = make_requests(rng)
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        n_ops = build_and_save(fluid, d)
        t_build = time.perf_counter() - t0
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        support.forget_probes()  # the predictor's executor probes again
        support.reset_launch_counts()
        t0 = time.perf_counter()
        pred = create_paddle_predictor(AnalysisConfig(d))  # the card
        engine = ServingEngine(pred, ServingConfig(max_batch_size=MAX_BATCH,
                                                   max_queue=N_REQUESTS))
        engine.start()
        t_load = time.perf_counter() - t0
        outs, lat, wall = serve_burst(engine, reqs)
        lat_seq = serve_one_at_a_time(engine, reqs)
        engine.stop()
        counts = support.launch_counts()
        stats = engine.stats()
        peak = torch.cuda.max_memory_allocated()
        log("phase 4 built %d ops, init + save %.2f s, load + warmup %.2f s"
            % (n_ops, t_build, t_load))

        batches = stats["serving.batches"]
        warm = len(engine.warmed_buckets)
        want = BERT["num_layers"] * (warm + batches)
        if counts["flash_attention_forward"] != want:
            raise RuntimeError("K1 ran %d times, expected 12 x (%d warmup + "
                               "%d batches) = %d"
                               % (counts["flash_attention_forward"], warm,
                                  batches, want))
        if counts["probe_add_one"] != 1:
            raise RuntimeError("the probe kernel ran %d times on the serving "
                               "path, expected once (the predictor's "
                               "executor)" % counts["probe_add_one"])
        for feed, out in zip(reqs, outs):
            (arr,) = out.values()
            rows = feed["src_ids"].shape[0]
            if arr.shape != (rows, SEQ_LEN, BERT["d_model"]) or \
                    not np.isfinite(arr).all():
                raise RuntimeError("bad output: shape %s, finite %s"
                                   % (arr.shape, np.isfinite(arr).all()))
        rows_served = sum(f["src_ids"].shape[0] for f in reqs)
        log("phase 4 served %d requests at once (%d rows) then the same %d "
            "one at a time, in %d batches after %d warmup dispatches; "
            "launches %s" % (len(reqs), rows_served, len(reqs), batches, warm,
                             json.dumps(counts)))
        log("phase 4 at once (%d requests): latency p50 %.3f ms p99 %.3f ms "
            "max %.3f ms, %.2f sequences/s over %.3f s"
            % (len(lat), *pcts(lat), rows_served / wall, wall))
        log("phase 4 one at a time (%d requests): latency p50 %.3f ms p99 "
            "%.3f ms max %.3f ms; max_memory_allocated %d bytes; card %s"
            % (len(lat_seq), *pcts(lat_seq), peak, card_line()))

        cfg = AnalysisConfig(d)
        cfg.disable_gpu()
        cpu_pred = create_paddle_predictor(cfg)
        worst = 0.0
        for feed, out in list(zip(reqs, outs))[:N_CPU_CHECKS]:
            (ref,) = (t.data for t in cpu_pred.run(feed))
            (got,) = out.values()
            worst = max(worst, float(np.abs(ref - got).max()))
        log("phase 4 card vs CPU predictor on %d requests: max |diff| %.3g "
            "(limit %g)" % (N_CPU_CHECKS, worst, CPU_TOL))
        if not worst <= CPU_TOL:
            raise RuntimeError("card and CPU predictors disagree: %g"
                               % worst)

        feed8 = {n: np.concatenate([r[n] for r in reqs])[:MAX_BATCH]
                 for n in reqs[0]}
        wall_ms, busy_ms, kernels = profile_window(pred, feed8)
        log("phase 4 profile, 3 runs of batch %d: wall %.3f ms, device "
            "busy %.3f ms, idle share %s"
            % (MAX_BATCH, wall_ms, busy_ms,
               "%.3f" % (1 - busy_ms / wall_ms) if busy_ms else
               "not measured (no device time in the trace)"))
        for t_ms, count, name in kernels[:8]:
            log("phase 4 profile   %9.3f ms  %5d x  %s"
                % (t_ms, count, name[:110]))
    return counts


# -- phase 5: flash-attention backward (K2, K3) -----------------------------

def visible_pairs(shape, lengths, causal):
    B, H, S, _ = shape
    lens = [S] * B if lengths is None else [min(max(int(n), 0), S)
                                            for n in lengths]
    pairs = 0
    for n in lens:
        pairs += (sum(min(n, q + 1) for q in range(S)) if causal
                  else S * n)
    return H * pairs


def bwd_work(shape, lengths, causal, dtype):
    """(bytes, FLOPs) of K2 and of K3 for these inputs: Q, K, V, dO read
    once, LSE and delta read once, outputs written once; 2 D FLOPs per
    visible (query, key) pair and product: three products in K2 (S, dP,
    dQ), four in K3 (S, dP, dV, dK)."""
    B, H, S, D = shape
    esize = torch.tensor([], dtype=dtype).element_size()
    t = B * H * S * D * esize
    common = 4 * t + 2 * B * H * S * 4 + B * 4
    pairs = visible_pairs(shape, lengths, causal)
    return ((common + t, 3 * 2 * D * pairs),
            (common + 2 * t, 4 * 2 * D * pairs))


def bwd_check(fa, shape, lengths, causal, dtype, seed, timed):
    q, k, v = k1_inputs(shape, dtype, seed)
    g = torch.Generator().manual_seed(seed + 100)
    do = torch.randn(shape, generator=g).to(dtype).cuda()
    lens = (None if lengths is None
            else torch.tensor(lengths, dtype=torch.int32, device="cuda"))
    o, lse = fa.flash_attention(q, k, v, causal, None, lens)
    got = fa.flash_attention_backward(q, k, v, o, lse, do, causal, None,
                                      lens)
    torch.cuda.synchronize()
    want = fa.flash_attention_backward_reference(q, k, v, o, lse, do,
                                                 causal, None, lens)
    errs, rels = [], []
    for a, b in zip(got, want):
        err = (a.float() - b.float()).abs().max().item()
        scale = max(b.float().abs().max().item(), 1.0)
        errs.append(err)
        rels.append(err / scale)
        if not bool(torch.isfinite(a.float()).all()):
            raise RuntimeError("K2/K3 gave non-finite grads")
    tol = BWD_TOL[dtype]
    if max(rels) > tol:
        raise RuntimeError(
            "K2/K3 disagree with their plain version (%s, causal=%s, "
            "shape %s): dQ, dK, dV errors %s, relative %s (tol %g)"
            % (dtype, causal, shape, errs, rels, tol))
    row = {"shape": list(shape), "dtype": str(dtype).replace("torch.", ""),
           "causal": causal, "lengths": lengths is not None,
           "err_dq": errs[0], "err_dk": errs[1], "err_dv": errs[2],
           "rel_err_max": max(rels)}
    del want
    if timed:
        scale = float(shape[-1]) ** -0.5
        delta = fa.backward_delta(o, do)
        iters = 5 if shape[2] >= 1024 else 100
        row["ms_dq"] = time_ms(lambda: fa.launch_backward_dq(
            q, k, v, do, lse, delta, causal, scale, lens), iters=iters,
            warmup=2)
        row["ms_dkv"] = time_ms(lambda: fa.launch_backward_dkv(
            q, k, v, do, lse, delta, causal, scale, lens), iters=iters,
            warmup=2)
        row["plain_ms"] = time_ms(
            lambda: fa.flash_attention_backward_reference(
                q, k, v, o, lse, do, causal, None, lens),
            iters=3 if shape[2] >= 1024 else 20, warmup=1)
        row["library_ms"] = sdpa_backward_ms(q, k, v, do, causal, iters)
        (b2, f2), (b3, f3) = bwd_work(shape, lengths, causal, dtype)
        row["bound_dq_ms"], row["bound_dq_by"] = bound(b2, f2,
                                                       PEAK_FLOPS[dtype])
        row["bound_dkv_ms"], row["bound_dkv_by"] = bound(b3, f3,
                                                         PEAK_FLOPS[dtype])
    torch.cuda.empty_cache()
    log("phase 5 K2/K3 %s" % json.dumps(row))
    return row


def sdpa_backward_ms(q, k, v, do, causal, iters):
    """Device time of the backward of torch's scaled_dot_product_attention
    (is_causal) on the same tensors."""
    leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    out = torch.nn.functional.scaled_dot_product_attention(
        *leaves, is_causal=causal)
    return time_ms(lambda: torch.autograd.grad(out, leaves, do,
                                               retain_graph=True),
                   iters=iters, warmup=2)


def phase_flash_backward(fa):
    main = bwd_check(fa, BWD_SHAPE, None, True, torch.float32, seed=20,
                     timed=True)
    rows = [main]
    for dtype in (torch.float32, torch.bfloat16):
        for causal in (False, True):
            rows.append(bwd_check(fa, K1_SHAPE, K1_LENGTHS, causal, dtype,
                                  seed=21 + len(rows), timed=False))
    for dtype in (torch.float32, torch.bfloat16):
        rows.append(bwd_check(fa, K1_SHAPE[:3] + (128,), K1_LENGTHS, True,
                              dtype, seed=30, timed=False))
    by_dtype = {}
    for r in rows:
        by_dtype[r["dtype"]] = max(by_dtype.get(r["dtype"], 0.0),
                                   r["rel_err_max"])
    common = {"route": "cuda",
              "source": "paddle_tpu_torch/csrc/flash_attention_bwd.cu",
              "plain_ms": main["plain_ms"], "library_ms": main["library_ms"],
              "rel_err_max_by_dtype": by_dtype,
              "shape": main["shape"], "causal": True,
              "plain_covers": "dQ, dK and dV (one plain backward)",
              "library_covers": "dQ, dK and dV (one SDPA backward)"}
    k2 = {"name": "flash_attention_backward_dq",
          "replaces": "paddle_tpu/ops/pallas/flash_attention.py:254",
          "max_abs_err": max(r["err_dq"] for r in rows),
          "ms": main["ms_dq"], "bound_ms": main["bound_dq_ms"],
          "bound_by": main["bound_dq_by"], **common}
    k3 = {"name": "flash_attention_backward_dkv",
          "replaces": "paddle_tpu/ops/pallas/flash_attention.py:308",
          "max_abs_err": max(max(r["err_dk"], r["err_dv"]) for r in rows),
          "ms": main["ms_dkv"], "bound_ms": main["bound_dkv_ms"],
          "bound_by": main["bound_dkv_by"], **common}
    return k2, k3


# -- phase 6: the fused optimizer update (K4) -------------------------------

K4_ATTRS = {"mu": 0.9, "beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8,
            "weight_decay": 0.01}


def k4_case(fo, op_type, n, nesterov, seed):
    """Run K4 and its plain version on the same card buffers; raise unless
    every output is bitwise equal. Returns the case's buffers."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    p, grad, sa = (torch.randn(n, device="cuda", generator=g)
                   for _ in range(3))
    sb = torch.randn(n, device="cuda", generator=g).abs()
    lr, b1p, b2p = (torch.tensor([v], device="cuda")
                    for v in (1e-4, 0.81, 0.998))
    attrs = dict(K4_ATTRS, use_nesterov=nesterov)
    want = fo.fused_optimizer_update_reference(
        op_type, attrs, p, grad, lr.reshape(()), sa, sb, b1p.reshape(()),
        b2p.reshape(()))
    got = fo.fused_optimizer_update(op_type, attrs, p.clone(), grad, lr,
                                    sa.clone(), sb.clone(), b1p, b2p)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        if (a is None) != (b is None) or (
                a is not None and not torch.equal(a, b)):
            raise RuntimeError(
                "K4 %s (nesterov=%s, n=%d) is not bitwise equal to its "
                "plain version" % (op_type, nesterov, n))
    log("phase 6 K4 %s nesterov=%s n=%d: bitwise equal"
        % (op_type, nesterov, n))
    return p, grad, sa, sb, lr, b1p, b2p, attrs


def phase_fused_optimizer(fo):
    for op_type, nesterov in (("sgd", False), ("momentum", False),
                              ("momentum", True), ("adamw", False)):
        k4_case(fo, op_type, 1000003, nesterov, seed=40)
    p, grad, m1, m2, lr, b1p, b2p, attrs = k4_case(
        fo, "adam", K4_SIZE, False, seed=41)
    ms = time_ms(lambda: fo.fused_optimizer_update(
        "adam", attrs, p, grad, lr, m1, m2, b1p, b2p), iters=20, warmup=3)
    plain_ms = time_ms(lambda: fo.fused_optimizer_update_reference(
        "adam", attrs, p, grad, lr.reshape(()), m1, m2, b1p.reshape(()),
        b2p.reshape(())), iters=5, warmup=1)
    step = torch.tensor(1.0, device="cuda")
    library_ms = time_ms(lambda: torch._fused_adam_(
        [p], [grad], [m1], [m2], [], [step], lr=1e-4, beta1=0.9,
        beta2=0.999, weight_decay=0.0, eps=1e-8, amsgrad=False,
        maximize=False), iters=20, warmup=3)
    # param, m1, m2 read and written, grad read: 7 float32 streams
    b_ms, b_by = bound(7 * 4 * K4_SIZE, 15 * K4_SIZE,
                       PEAK_FLOPS[torch.float32])
    log("phase 6 K4 adam over %d elements: %.4f ms (plain %.4f, "
        "torch._fused_adam_ %.4f, bound %.4f ms by %s)"
        % (K4_SIZE, ms, plain_ms, library_ms, b_ms, b_by))
    del p, grad, m1, m2
    torch.cuda.empty_cache()
    return {"name": "fused_optimizer_update", "route": "cuda",
            "source": "paddle_tpu_torch/csrc/fused_optimizer.cu",
            "replaces": "paddle_tpu/ops/pallas/fused_optimizer.py:172",
            "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": library_ms,
            "n": K4_SIZE, "op_type": "adam",
            "library_covers": "torch._fused_adam_ (another formula)"}


# -- phase 7: the training path ---------------------------------------------

def profile_step(run):
    """Device time by kernel over one training step."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = []
    for e in prof.key_averages():
        if getattr(e, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        t_us = getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))
        kernels.append((t_us / 1e3, e.count, e.key))
    kernels.sort(reverse=True)
    return wall_ms, sum(k[0] for k in kernels), kernels


def phase_training(fluid, support):
    from paddle_tpu_torch.models import gpt

    # bench.py's fast paths (_enable_fast_paths): an explicit setting wins
    os.environ.setdefault("PADDLE_TPU_FUSED_OPTIMIZER", "1")
    np.random.seed(SEED)
    t0 = time.perf_counter()
    cfg = gpt.GPT_LONG
    main, startup, loss, params_grads = gpt.build_gpt_long(
        **cfg, seed=SEED + 1)
    n_params = sum(int(np.prod(p.shape)) for p, _ in params_grads)
    exe = fluid.Executor()  # the card
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    feed = gpt.random_batch(np.random.RandomState(SEED), cfg["batch"],
                            cfg["seq_len"], cfg["vocab"])

    def step():
        (out,) = exe.run(main, feed=feed, fetch_list=[loss], scope=scope,
                         return_numpy=False)
        return out

    first = float(step().numpy().reshape(-1)[0])  # warm-up (and rewrite)
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    ops = [op.type for op in main.global_block().ops]
    if ops.count("fused_optimizer") != 1 or "adam" in ops:
        raise RuntimeError("expected one fused_optimizer op and no adam, "
                           "got %d and %d" % (ops.count("fused_optimizer"),
                                              ops.count("adam")))
    torch.cuda.reset_peak_memory_stats()
    support.reset_launch_counts()
    t0 = time.perf_counter()
    outs = [step() for _ in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = support.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    losses = [float(o.numpy().reshape(-1)[0]) for o in outs]
    log("phase 7 gpt_long float32: %d parameters, %d ops, setup (build, "
        "startup, warm-up step) %.2f s, warm-up loss %.6f"
        % (n_params, len(ops), t_setup, first))
    log("phase 7 losses over %d steps on one batch: %s" % (
        TRAIN_STEPS, ", ".join("%.6f" % x for x in losses)))
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise RuntimeError("training did not fall: %s" % losses)
    want = {"flash_attention_forward": 4 * TRAIN_STEPS,
            "flash_attention_backward_dq": 2 * TRAIN_STEPS,
            "flash_attention_backward_dkv": 2 * TRAIN_STEPS,
            "fused_optimizer_update": TRAIN_STEPS}
    bad = {k: (counts.get(k), n) for k, n in want.items()
           if counts.get(k) != n}
    if bad:
        raise RuntimeError("training launches (got, want): %s" % bad)
    tokens = cfg["batch"] * cfg["seq_len"]
    step_ms = wall / TRAIN_STEPS * 1e3
    log("phase 7 %d steps: step %.3f ms, %.1f tokens/s (%d tokens a step), "
        "max_memory_allocated %d bytes; launches %s; card %s"
        % (TRAIN_STEPS, step_ms, tokens / wall * TRAIN_STEPS, tokens, peak,
           json.dumps(counts), card_line()))
    wall_ms, busy_ms, kernels = profile_step(step)
    log("phase 7 profile, one step: wall %.3f ms, device busy %.3f ms, idle "
        "share %s" % (wall_ms, busy_ms,
                      "%.3f" % (1 - busy_ms / wall_ms) if busy_ms else
                      "not measured (no device time in the trace)"))
    for t_ms, count, name in kernels[:10]:
        log("phase 7 profile   %9.3f ms  %5d x  %s"
            % (t_ms, count, name[:110]))
    del exe, scope, outs
    torch.cuda.empty_cache()
    return counts


# -- phase 8: the narrow twin, card against CPU -----------------------------

def phase_twin(fluid, support):
    from paddle_tpu_torch.models import gpt

    rng = np.random.RandomState(SEED + 2)
    feeds = [gpt.random_batch(rng, GPT_TWIN["batch"], GPT_TWIN["seq_len"],
                              GPT_TWIN["vocab"]) for _ in range(TWIN_STEPS)]
    init, losses, grads = None, {}, {}
    for name, place in (("cpu", fluid.CPUPlace()),
                        ("card", fluid.CUDAPlace(0))):
        main, startup, loss, params_grads = gpt.build_gpt_long(
            **GPT_TWIN, seed=SEED + 3)
        grad_names = [g.name for _, g in params_grads]
        exe = fluid.Executor(place)
        scope = fluid.Scope()
        if init is None:
            exe.run(startup, scope=scope)
            init = {v.name: scope.find_var(v.name).get_tensor().numpy()
                    for v in main.global_block().vars.values()
                    if v.persistable}
        else:
            fluid.io.scope_from_numpy(scope, init, place)
        support.reset_launch_counts()
        losses[name] = []
        for i, feed in enumerate(feeds):
            res = exe.run(main, feed=feed, scope=scope,
                          fetch_list=[loss] + (grad_names if i == 0 else []))
            losses[name].append(float(np.asarray(res[0]).reshape(-1)[0]))
            if i == 0:
                grads[name] = res[1:]
        counts = support.launch_counts()
    want = {"flash_attention_forward": 4 * TWIN_STEPS,
            "flash_attention_backward_dq": 2 * TWIN_STEPS,
            "flash_attention_backward_dkv": 2 * TWIN_STEPS,
            "fused_optimizer_update": TWIN_STEPS}
    if any(counts.get(k) != n for k, n in want.items()):
        raise RuntimeError("the card twin's launches %s, want %s"
                           % (counts, want))
    rel = max(abs(a - b) / abs(b)
              for a, b in zip(losses["card"], losses["cpu"]))
    # step-1 grads, against the larger of their scale and 1e-3 (grads
    # that are zero by symmetry, such as the key bias's, are rounding
    # noise on both sides)
    grad_rel = max(float(np.abs(a - b).max()) / max(float(np.abs(b).max()),
                                                    1e-3)
                   for a, b in zip(grads["card"], grads["cpu"]))
    log("phase 8 narrow twin %s, %d steps: card losses %s, CPU losses %s, "
        "largest relative difference %.3g (limit %g); %d step-1 grads, "
        "largest difference %.3g of their scale (limit %g); card launches "
        "%s" % (json.dumps(GPT_TWIN), TWIN_STEPS, losses["card"],
                losses["cpu"], rel, TWIN_RTOL, len(grads["cpu"]), grad_rel,
                TWIN_RTOL, json.dumps(counts)))
    if not (rel <= TWIN_RTOL and grad_rel <= TWIN_RTOL):
        raise RuntimeError("card and CPU training disagree: loss %g, grads "
                           "%g" % (rel, grad_rel))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device on this host", file=sys.stderr)
        return 2
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    from paddle_tpu_torch.ops.cuda import fused_optimizer as fo
    from paddle_tpu_torch.ops.cuda import support

    card = card_line()
    log("phase 1 card: %s; torch %s, CUDA %s, python %s"
        % (card, torch.__version__, torch.version.cuda,
           sys.version.split()[0]))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    probe = phase_build_and_probe(support)
    flash = phase_flash(fa)
    serving = phase_serving(fluid, support)
    k2, k3 = phase_flash_backward(fa)
    k4 = phase_fused_optimizer(fo)
    training = phase_training(fluid, support)
    phase_twin(fluid, support)
    kernels = (probe, flash, k2, k3, k4)
    for kern in kernels:
        by_path = {"serving": serving.get(kern["name"], 0),
                   "training": training.get(kern["name"], 0)}
        kern["launches"] = sum(by_path.values())
        kern["launches_by_path"] = by_path
        if kern["launches"] == 0:
            raise RuntimeError("%s never ran on a main path" % kern["name"])
    log("card: %s" % card_line())
    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    # every required key first, in order, then a kernel's extra fields
    print(json.dumps({"kernels": [
        {**{k: kern[k] for k in keys}, **kern} for kern in kernels]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
