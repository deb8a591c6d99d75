"""The port's CUDA kernels and serving path on the card.

Every test here carries the ``gpu`` marker and skips, with its reason, on
a host without a CUDA device. On the card:

    python -m pytest tests/test_torch_gpu.py -m gpu -q

Kernels are held against their plain PyTorch versions on the same card
inputs: float32 within 2e-5 (float32 sums in another order), bfloat16 O
within 2e-2 (two bfloat16 rounding steps near 1), LSE within 2e-5. The
backward kernels (K2/K3): dQ, dK, dV within 2e-5 of their scale in
float32, 1e-2 of their scale in bfloat16 (one rounding step of 2^-8
relative, twice), two runs bitwise equal; with peaked softmaxes the
float32 limit holds for the kernels' 3xTF32 products and not for one TF32
pass. The fused optimizer kernel (K4) is bitwise equal to its
plain version. The narrow gpt twin trains three steps on the card and on
the CPU with losses within 1e-4 relative (float32, TF32 off; the card's
products and embedding grad sum in another order), and so do the narrow
Transformer-base WMT (with lengths, K1/K2/K3 launched 8/4/4 times a step)
and BERT masked-LM twins, whose gather, matmul, scale and sequence_mask
ops agree with the CPU op by op. The fused
implicit-GEMM conv (K5) agrees with its plain version within 2e-5 of the
output's largest magnitude in float32 (sums of up to 4608 products in
another order) and 1e-2 in bfloat16 (y rounded once, twice allowed). Paged
decode attention (K6) agrees with its plain version within 2e-5 of the
output's largest magnitude on float32, bfloat16 and int8 arenas (both
widen the same stored bits exactly), and a row alone gives the bits it
gives in a batch and through either form (the prefill form's shared
table or a table a row), at D 8 to 256 and blocks of 1, 16 and 17
tokens. K1 also takes S_kv != S_q (not causal), holds the float32 limit
with peaked softmaxes (Q times 8, D 64 and 128; against the exact float64
values, which the float32 plain version misses by as much there), and
gives the same bits twice; K1 and
K6 refuse a misaligned tensor. The decode engine on the card launches K6 as its
counters predict and its streams do not change with the batch, the prefill
chunking or a preemption.

The whole-program route (``core/compiler_engine``) captures a program once
per shape and replays it: a captured narrow BERT step gives the
interpreter's losses within 1e-6 relative (the gather and embedding grads
sum by atomics, in another order each run, so not bitwise); one capture
serves five steps and each replay counts the kernels it launches; a
replay draws the interpreter's random numbers bit for bit, new ones each
step; a host constant (``assign_value``) is made outside the graph; a
graph captured on another thread replays on this one; the
serving engine's warm-up captures one graph per ladder bucket and a burst
after it captures none; ``Executor.close()`` gives the graphs' memory
back.

Mixed precision (``contrib.mixed_precision``) on the card: the settings
keep bfloat16 GEMMs' split-K sums in float32; a dynamically scaled AMP
step on the captured route skips an update whose feed holds an inf
(every master bitwise unchanged, the scale shrunk), updates again on the
next clean batch, and captures nothing new; the narrow ResNet-50 NHWC
AMP twin launches K5 in bfloat16 only (44 a step) and its losses stay
within 0.15 relative of the CPU run's from the same state (the bound of
``test_torch_amp_training.py``: ResNet-50 at batch 4 is chaotic to
bfloat16 rounding).
"""
import gc
import threading

import numpy as np
import pytest
import torch

import paddle_tpu_torch as fluid
from paddle_tpu_torch.core import compiler_engine as ce
from paddle_tpu_torch.inference import AnalysisConfig, create_paddle_predictor
from paddle_tpu_torch.models import gpt, transformer
from paddle_tpu_torch.ops.cuda import conv as k5
from paddle_tpu_torch.ops.cuda import flash_attention as fa
from paddle_tpu_torch.ops.cuda import fused_optimizer as fo
from paddle_tpu_torch.ops.cuda import paged_attention as k6
from paddle_tpu_torch.ops.cuda import support
from paddle_tpu_torch.serving.decode import DecodeConfig, DecodeEngine

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # bfloat16 products sum their split-K partials in float32, as XLA does
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
        False
    return torch.device("cuda")


def test_probe_kernel(cuda):
    support.ensure_kernels(cuda)
    x = torch.randn(8, 128, device=cuda)
    before = support.PROBE_LAUNCHES.value
    y = support.probe_add_one(x)
    torch.cuda.synchronize()
    assert torch.equal(y, x + 1.0)
    assert support.PROBE_LAUNCHES.value == before + 1


def test_forgotten_probe_runs_once_at_the_next_executor(cuda):
    support.ensure_kernels(cuda)
    support.forget_probes()
    before = support.PROBE_LAUNCHES.value
    fluid.Executor()
    fluid.Executor()
    assert support.PROBE_LAUNCHES.value == before + 1


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("S", [128, 100, 1])
def test_flash_kernel_matches_plain_version(cuda, D, dtype, causal, S):
    g = torch.Generator().manual_seed(S + D)
    B, H = 4, 3
    q, k, v = (torch.randn(B, H, S, D, generator=g).to(dtype).to(cuda)
               for _ in range(3))
    lens = torch.tensor([0, 1, S // 2, S], dtype=torch.int32, device=cuda)
    before = fa.LAUNCHES.value
    o, lse = fa.flash_attention(q, k, v, causal, None, lens)
    torch.cuda.synchronize()
    assert fa.LAUNCHES.value == before + 1
    ro, rlse = fa.flash_attention_reference(q, k, v, causal, None, lens)
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(o.float(), ro.float(), rtol=tol, atol=tol)
    seen = (lens > 0).repeat_interleave(H)
    torch.testing.assert_close(lse[seen], rlse[seen], rtol=2e-5, atol=2e-5)
    assert (o[0] == 0).all()


def test_flash_kernel_refuses_what_it_does_not_take(cuda):
    x = torch.zeros(1, 2, 8, 32, device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention(x, x, x)
    y = torch.zeros(1, 2, 8, 64, device=cuda, dtype=torch.float16)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fa.flash_attention(y, y, y)
    z = torch.zeros(1, 8, 2, 64, device=cuda).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention(z, z, z)


def _k1_inputs(cuda, shape, dtype, seed, s_kv=None):
    g = torch.Generator().manual_seed(seed)
    kv = shape[:2] + (shape[2] if s_kv is None else s_kv, shape[3])
    return [torch.randn(s, generator=g).to(dtype).to(cuda)
            for s in (shape, kv, kv)]


def _k1_check(cuda, q, k, v, causal, lens, tol):
    o, lse = fa.flash_attention(q, k, v, causal, None, lens)
    torch.cuda.synchronize()
    ro, rlse = fa.flash_attention_reference(q, k, v, causal, None, lens)
    torch.testing.assert_close(o.float(), ro.float(), rtol=tol, atol=tol)
    H = q.shape[1]
    seen = (torch.ones(q.shape[0], dtype=torch.bool, device=cuda)
            if lens is None else (lens > 0)).repeat_interleave(H)
    torch.testing.assert_close(lse[seen], rlse[seen], rtol=2e-5, atol=2e-5)
    return o, lse


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s_q,s_kv", [(128, 256), (100, 37), (1, 65)])
def test_flash_kernel_takes_rectangular_keys(cuda, dtype, s_q, s_kv):
    q, k, v = _k1_inputs(cuda, (3, 2, s_q, 64), dtype, s_q + s_kv, s_kv)
    lens = torch.tensor([0, s_kv // 2 + 1, s_kv], dtype=torch.int32,
                        device=cuda)
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    o, lse = _k1_check(cuda, q, k, v, False, lens, tol)
    assert o.shape == q.shape and lse.shape == (6, s_q)
    assert (o[0] == 0).all()
    with pytest.raises(ValueError, match="S_q = S_kv"):
        fa.flash_attention(q, k, v, True)


@pytest.mark.parametrize("S", [1, 65, 4097])
def test_flash_kernel_causal_ragged_lengths(cuda, S):
    q, k, v = _k1_inputs(cuda, (2, 2, S, 64), torch.float32, S)
    lens = torch.tensor([S, S // 2 + 1], dtype=torch.int32, device=cuda)
    _k1_check(cuda, q, k, v, True, lens, 2e-5)
    _k1_check(cuda, q, k, v, True, None, 2e-5)


def test_flash_kernel_d128_bf16_and_bitwise_repeatable(cuda):
    q, k, v = _k1_inputs(cuda, (2, 3, 300, 128), torch.bfloat16, 7)
    lens = torch.tensor([300, 123], dtype=torch.int32, device=cuda)
    for causal in (False, True):
        o, lse = _k1_check(cuda, q, k, v, causal, lens, 2e-2)
        o2, lse2 = fa.flash_attention(q, k, v, causal, None, lens)
        torch.cuda.synchronize()
        assert torch.equal(o, o2) and torch.equal(lse, lse2)


def _k1_exact(q, k, v, causal):
    """O and LSE of the plain version's function evaluated in float64."""
    S, D = q.shape[2], q.shape[3]
    s = torch.einsum("bhqd,bhkd->bhqk", q.double() * D ** -0.5, k.double())
    vis = fa._visible(S, causal, None, q.device, k.shape[2])
    s = s.masked_fill(~vis, float("-inf"))
    o = torch.einsum("bhqk,bhkd->bhqd", torch.softmax(s, -1), v.double())
    return o, torch.logsumexp(s, -1).reshape(-1, S)


@pytest.mark.parametrize("D", [64, 128])
def test_flash_kernel_float32_limit_with_peaked_softmax(cuda, D):
    """Q times 8 gives peaked softmaxes, with scores and LSE in the tens:
    the forward's 3xTF32 products and its float32 running sums keep O and
    LSE within 2e-5 absolute (KERNEL_TOL, LSE_TOL) of the exact values
    over 2048 keys. They are held to the function evaluated in float64,
    not to the float32 plain version: at LSE near 46 that version is
    itself up to 2.3e-5 from the exact LSE, so it cannot referee a 2e-5
    limit there."""
    q, k, v = _k1_inputs(cuda, (2, 3, 2048, D), torch.float32, 9)
    q = q * 8
    for causal in (True, False):
        o, lse = fa.flash_attention(q, k, v, causal)
        torch.cuda.synchronize()
        xo, xlse = _k1_exact(q, k, v, causal)
        assert float((o.double() - xo).abs().max()) <= 2e-5
        assert float((lse.double() - xlse).abs().max()) <= 2e-5


def test_flash_kernel_refuses_misaligned_tensors(cuda):
    q = torch.zeros(2 * 8 * 64 + 1, device=cuda)[1:].view(1, 2, 8, 64)
    with pytest.raises(ValueError, match="16-byte aligned"):
        fa.flash_attention(q, q, q)


def test_small_encoder_served_on_the_card_matches_the_cpu(cuda, tmp_path):
    T = 32
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        src = fluid.data(name="src_ids", shape=[-1, T], dtype="int64")
        pos = fluid.data(name="pos_ids", shape=[-1, T], dtype="int64")
        lens = fluid.data(name="lengths", shape=[-1], dtype="int32")
        enc = transformer.transformer_encoder(
            src, pos, 101, max_len=64, num_layers=2, num_heads=2,
            d_model=128, d_ff=256, is_test=True, src_lengths=lens)
    exe = fluid.Executor()
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        exe.run(startup)
        fluid.io.save_inference_model(str(tmp_path),
                                      ["src_ids", "pos_ids", "lengths"],
                                      [enc], exe, main_program=main)
    rng = np.random.RandomState(0)
    feed = {"src_ids": rng.randint(0, 101, (3, T)).astype("int64"),
            "pos_ids": np.tile(np.arange(T), (3, 1)).astype("int64"),
            "lengths": np.array([0, 7, T], dtype="int32")}
    before = fa.LAUNCHES.value
    (got,) = create_paddle_predictor(AnalysisConfig(str(tmp_path))).run(feed)
    assert fa.LAUNCHES.value == before + 2  # one per layer
    cfg = AnalysisConfig(str(tmp_path))
    cfg.disable_gpu()
    (want,) = create_paddle_predictor(cfg).run(feed)
    np.testing.assert_allclose(got.data, want.data, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("S", [128, 100])
def test_flash_backward_kernels_match_plain_version(cuda, D, dtype, causal,
                                                    S):
    g = torch.Generator().manual_seed(S + D + 1)
    B, H = 4, 3
    q, k, v, do = (torch.randn(B, H, S, D, generator=g).to(dtype).to(cuda)
                   for _ in range(4))
    lens = torch.tensor([0, 1, S // 2, S], dtype=torch.int32, device=cuda)
    o, lse = fa.flash_attention(q, k, v, causal, None, lens)
    before = (fa.DQ_LAUNCHES.value, fa.DKV_LAUNCHES.value)
    got = fa.flash_attention_backward(q, k, v, o, lse, do, causal, None,
                                      lens)
    torch.cuda.synchronize()
    assert (fa.DQ_LAUNCHES.value, fa.DKV_LAUNCHES.value) == (
        before[0] + 1, before[1] + 1)
    want = fa.flash_attention_backward_reference(q, k, v, o, lse, do, causal,
                                                 None, lens)
    rel = 2e-5 if dtype == torch.float32 else 1e-2
    for a, b in zip(got, want):
        scale = max(float(b.float().abs().max()), 1.0)
        torch.testing.assert_close(a.float(), b.float(), rtol=0,
                                   atol=rel * scale)
        assert (a[0] == 0).all()  # length 0: no key seen, no grad
    assert (got[1][1, :, 1:] == 0).all() and (got[2][1, :, 1:] == 0).all()


def test_autograd_function_launches_the_backward_kernels(cuda):
    q, k, v = (torch.randn(2, 2, 64, 64, device=cuda, requires_grad=True)
               for _ in range(3))
    before = {n: support.COUNTERS[n].value for n in (
        "flash_attention_forward", "flash_attention_backward_dq",
        "flash_attention_backward_dkv")}
    out = fa.FlashAttentionFunction.apply(q, k, v, None, True, None)
    out.square().sum().backward()
    torch.cuda.synchronize()
    after = {n: support.COUNTERS[n].value - before[n] for n in before}
    assert after == dict.fromkeys(before, 1)
    assert all(torch.isfinite(t.grad).all() for t in (q, k, v))


def _bwd_rel_errors(got, want):
    return [float((a.float() - b.float()).abs().max())
            / max(float(b.float().abs().max()), 1.0)
            for a, b in zip(got, want)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_backward_kernels_are_bitwise_repeatable(cuda, dtype):
    g = torch.Generator().manual_seed(5)
    q, k, v, do = (torch.randn(2, 4, 1000, 64, generator=g).to(dtype)
                   .to(cuda) for _ in range(4))
    lens = torch.tensor([700, 1000], dtype=torch.int32, device=cuda)
    o, lse = fa.flash_attention(q, k, v, True, None, lens)
    first = fa.flash_attention_backward(q, k, v, o, lse, do, True, None,
                                        lens)
    second = fa.flash_attention_backward(q, k, v, o, lse, do, True, None,
                                         lens)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("S", [1, 65, 100, 4097])
def test_flash_backward_kernels_at_ragged_and_edge_shapes(cuda, S):
    """D 128 in float32 with causal, B*H = 96, key lengths 0..S."""
    g = torch.Generator().manual_seed(S)
    B, H, D = 8, 12, 128
    q, k, v, do = (torch.randn(B, H, S, D, generator=g).to(cuda)
                   for _ in range(4))
    lens = torch.tensor([0, 1, S // 3, S // 2, S - 1, S, S, S + 5],
                        dtype=torch.int32, device=cuda)
    o, lse = fa.flash_attention(q, k, v, True, None, lens)
    got = fa.flash_attention_backward(q, k, v, o, lse, do, True, None, lens)
    torch.cuda.synchronize()
    want = fa.flash_attention_backward_reference(q, k, v, o, lse, do, True,
                                                 None, lens)
    assert max(_bwd_rel_errors(got, want)) <= 2e-5
    assert all((a[0] == 0).all() for a in got)
    for b, n in enumerate(lens.tolist()):  # keys past the length: no grad
        assert (got[1][b, :, n:] == 0).all() and (got[2][b, :, n:] == 0).all()


def test_flash_backward_float32_limit_tells_3xtf32_from_one_tf32_pass(cuda):
    """Q times 8 gives peaked softmaxes: the kernels (3xTF32) stay within
    the float32 limit, while the plain version with TF32 products allowed
    (one TF32 pass) goes over it."""
    g = torch.Generator().manual_seed(8)
    q, k, v, do = (torch.randn(2, 3, 256, 64, generator=g).to(cuda)
                   for _ in range(4))
    q = q * 8
    o, lse = fa.flash_attention(q, k, v, True)
    got = fa.flash_attention_backward(q, k, v, o, lse, do, True)
    torch.cuda.synchronize()
    want = fa.flash_attention_backward_reference(q, k, v, o, lse, do, True)
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        one_pass = fa.flash_attention_backward_reference(q, k, v, o, lse,
                                                         do, True)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    assert max(_bwd_rel_errors(got, want)) <= 2e-5
    assert max(_bwd_rel_errors(one_pass, want)) > 2e-5


def test_flash_backward_kernels_refuse_misaligned_tensors(cuda):
    q = torch.zeros(2 * 8 * 64 + 1, device=cuda)[1:].view(1, 2, 8, 64)
    lse = torch.zeros(2, 8, device=cuda)
    with pytest.raises(ValueError, match="16-byte aligned"):
        fa.flash_attention_backward(q, q, q, q, lse, q)


@pytest.mark.parametrize("op_type,nesterov", [
    ("sgd", False), ("momentum", False), ("momentum", True),
    ("adam", False), ("adamw", False)])
@pytest.mark.parametrize("offset", [0, 1])
def test_fused_optimizer_kernel_is_bitwise_plain(cuda, op_type, nesterov,
                                                 offset):
    """Odd size, and (offset 1) buffers off 16-byte alignment, so both the
    float4 path and the scalar path run."""
    n = 100003
    gen = torch.Generator(device=cuda).manual_seed(3)
    base = [torch.randn(n + offset, device=cuda, generator=gen)
            for _ in range(4)]
    p, g, sa, sb = (b[offset:] for b in base)
    sb = sb.abs()
    lr = torch.tensor([1e-3], device=cuda)
    b1p = torch.tensor([0.81], device=cuda)
    b2p = torch.tensor([0.998], device=cuda)
    attrs = {"mu": 0.9, "use_nesterov": nesterov, "beta1": 0.9,
             "beta2": 0.999, "epsilon": 1e-8, "weight_decay": 0.01}
    want = fo.fused_optimizer_update_reference(
        op_type, attrs, p, g, lr.reshape(()), sa, sb, b1p.reshape(()),
        b2p.reshape(()))
    before = fo.LAUNCHES.value
    got = fo.fused_optimizer_update(op_type, attrs, p, g, lr, sa, sb, b1p,
                                    b2p)
    torch.cuda.synchronize()
    assert fo.LAUNCHES.value == before + 1
    assert got[0] is p  # updated in place
    for a, b in zip(got, want):
        assert (a is None) == (b is None)
        if a is not None:
            assert torch.equal(a, b)


def _train_twin(place, init, feeds):
    main, startup, loss, _ = gpt.build_gpt_long(**TWIN, seed=1,
                                                use_bf16=False)
    exe = fluid.Executor(place)
    scope = fluid.Scope()
    if init is None:
        exe.run(startup, scope=scope)
        init = {v.name: scope.find_var(v.name).get_tensor().numpy()
                for v in main.global_block().vars.values() if v.persistable}
    else:
        fluid.io.scope_from_numpy(scope, init, place)
    losses = [float(np.asarray(exe.run(main, feed=f, fetch_list=[loss],
                                       scope=scope)[0]).reshape(-1)[0])
              for f in feeds]
    return init, losses, main


# the tests' narrow gpt with 2 heads of 64, the smallest head the
# kernels take
TWIN = dict(batch=2, seq_len=32, d_model=128, n_heads=2, n_layers=2,
            vocab=128)


def test_narrow_gpt_trains_on_the_card_as_on_the_cpu(cuda, monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_FUSED_OPTIMIZER", "1")
    rng = np.random.RandomState(0)
    feeds = [gpt.random_batch(rng, TWIN["batch"], TWIN["seq_len"],
                              TWIN["vocab"]) for _ in range(3)]
    init, cpu_losses, cpu_main = _train_twin(fluid.CPUPlace(), None, feeds)
    support.reset_launch_counts()
    _, card_losses, card_main = _train_twin(fluid.CUDAPlace(0), init, feeds)
    counts = support.launch_counts()
    np.testing.assert_allclose(card_losses, cpu_losses, rtol=1e-4)
    assert counts["flash_attention_forward"] == 2 * 2 * 3
    assert counts["flash_attention_backward_dq"] == 2 * 3
    assert counts["flash_attention_backward_dkv"] == 2 * 3
    assert counts["fused_optimizer_update"] == 3
    layouts = [[op.attrs["layout"] for op in m.global_block().ops
                if op.type == "fused_optimizer"]
               for m in (cpu_main, card_main)]
    assert layouts == [["chain"], ["flat"]]


# the narrow transformer scripts (bench.py's WMT with lengths, and BERT's
# masked LM), 2 heads of 64
TRANSFORMER_TWIN = dict(vocab=512, num_layers=2, num_heads=2, d_model=128,
                        d_ff=512)


def _transformer_twin(script):
    rng = np.random.RandomState(1)
    if script == "wmt":
        feeds = [transformer.wmt_batch(rng, 2, 32, 512) for _ in range(3)]
        for f in feeds:  # the lengths S and S / 2 in every batch
            f["slen"][:] = (32, 16)
            f["tlen"][:] = (16, 32)
        return (lambda: transformer.build_transformer_wmt(
            2, 32, **TRANSFORMER_TWIN, seed=2, use_bf16=False)), feeds
    feeds = [transformer.bert_batch(rng, 2, 32, 512, 5) for _ in range(3)]
    feeds[0]["mpos"][0, :2] = 3  # a repeated row
    return (lambda: transformer.build_bert_base(
        2, 32, masked=5, **TRANSFORMER_TWIN, seed=2, use_bf16=False)), feeds


def _train_program(build, place, init, feeds):
    """Losses of three steps and the step-1 grads, and the per-step launch
    counts of the last step."""
    main, startup, loss, pg = build()
    grad_names = [g.name for _, g in pg]
    exe = fluid.Executor(place)
    scope = fluid.Scope()
    if init is None:
        exe.run(startup, scope=scope)
        init = {v.name: scope.find_var(v.name).get_tensor().numpy()
                for v in main.global_block().vars.values() if v.persistable}
    else:
        fluid.io.scope_from_numpy(scope, init, place)
    losses, grads = [], None
    for i, feed in enumerate(feeds):
        support.reset_launch_counts()
        res = exe.run(main, feed=feed, scope=scope,
                      fetch_list=[loss] + (grad_names if i == 0 else []))
        losses.append(float(np.asarray(res[0]).reshape(-1)[0]))
        if i == 0:
            grads = [np.asarray(r) for r in res[1:]]
    return init, losses, grads, support.launch_counts()


@pytest.mark.parametrize("script", ["wmt", "bert"])
def test_narrow_transformers_train_on_the_card_as_on_the_cpu(
        cuda, monkeypatch, script):
    """Losses within 1e-4 relative and the step-1 grads within 1e-4 of
    their scale (at least 1e-3), as the gpt twin: float32 with TF32 off,
    products and the gather / embedding scatter-adds sum in another order
    on the card. The WMT twin's 4 flash ops launch K1, K2 and K3 8, 4 and
    4 times a step; BERT's dense attention launches none."""
    monkeypatch.setenv("PADDLE_TPU_FUSED_OPTIMIZER", "1")
    build, feeds = _transformer_twin(script)
    init, cpu_losses, cpu_grads, _ = _train_program(
        build, fluid.CPUPlace(), None, feeds)
    _, card_losses, card_grads, counts = _train_program(
        build, fluid.CUDAPlace(0), init, feeds)
    np.testing.assert_allclose(card_losses, cpu_losses, rtol=1e-4)
    for a, b in zip(card_grads, cpu_grads):
        scale = max(float(np.abs(b).max()), 1e-3)
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4 * scale)
    flash = 4 if script == "wmt" else 0
    assert counts["flash_attention_forward"] == 2 * flash
    assert counts["flash_attention_backward_dq"] == flash
    assert counts["flash_attention_backward_dkv"] == flash
    assert counts["fused_optimizer_update"] == 1


@pytest.mark.parametrize("case", ["gather", "matmul", "scale",
                                  "sequence_mask"])
def test_transformer_ops_on_the_card_match_the_cpu(cuda, case):
    """Each op function on card tensors against the same function on CPU
    tensors: float32 within 1e-5 of the output's scale (TF32 off; sums in
    another order), integer and boolean outputs equal; gather's grad (a
    scatter-add with repeated indices) too."""
    from paddle_tpu_torch.core.registry import DEVICE_ATTR, OpInfoMap

    g = torch.Generator().manual_seed(3)
    if case == "gather":
        ins = {"X": torch.randn(640, 96, generator=g),
               "Index": torch.tensor([5, 7, 5, 5, 639, 0, 7] * 30)}
        attrs = {}
    elif case == "matmul":
        ins = {"X": torch.randn(4, 8, 128, 64, generator=g),
               "Y": torch.randn(4, 8, 96, 64, generator=g)}
        attrs = {"transpose_Y": True, "alpha": 0.125}
    elif case == "scale":
        ins = {"X": (torch.rand(8, 256, generator=g) > 0.5).float()}
        attrs = {"scale": 1e9, "bias": -1.0, "bias_after_scale": False}
    else:
        ins = {"X": torch.tensor([0, 1, 128, 255, 256, 300],
                                 dtype=torch.int32)}
        attrs = {"maxlen": 256, "out_dtype": 5}
    types = [case] + (["gather_grad"] if case == "gather" else [])
    for op_type in types:
        info = OpInfoMap.instance().get(op_type)
        run_ins = dict(ins)
        if op_type == "gather_grad":
            run_ins["Out@GRAD"] = torch.randn(210, 96, generator=g)
        outs = {}
        for dev in ("cpu", cuda):
            full = dict(info.attrs, **attrs)
            full[DEVICE_ATTR] = torch.device(dev)
            res = info.fn({k: v.to(dev) for k, v in run_ins.items()}, full)
            outs[str(dev)] = {k: v.cpu() for k, v in res.items()}
        for slot, want in outs["cpu"].items():
            got = outs[str(cuda)][slot]
            assert got.dtype == want.dtype and got.shape == want.shape
            if want.is_floating_point():
                scale = max(want.abs().max().item(), 1.0)
                assert (got - want).abs().max().item() <= 1e-5 * scale
            else:
                assert torch.equal(got, want)


# ResNet-50's routed conv shapes (x H=W, Cin, K, Cout, stride, pad), each
# run here at batch 2
RESNET_K5_SHAPES = [
    (7, 512, 1, 2048, 1, 0), (7, 512, 3, 512, 1, 1), (7, 2048, 1, 512, 1, 0),
    (14, 256, 1, 1024, 1, 0), (14, 256, 3, 256, 1, 1),
    (14, 512, 3, 512, 2, 1), (14, 1024, 1, 256, 1, 0),
    (14, 1024, 1, 512, 1, 0), (14, 1024, 1, 2048, 2, 0),
    (28, 128, 1, 512, 1, 0), (28, 128, 3, 128, 1, 1),
    (28, 256, 3, 256, 2, 1), (28, 512, 1, 128, 1, 0),
    (28, 512, 1, 256, 1, 0), (28, 512, 1, 1024, 2, 0),
    (56, 128, 3, 128, 2, 1), (56, 256, 1, 64, 1, 0),
    (56, 256, 1, 128, 1, 0), (56, 256, 1, 512, 2, 0)]
K5_TOL = {torch.float32: 2e-5, torch.bfloat16: 1e-2}


def _k5_case(cuda, B, H, W, Cin, K, Cout, stride, pad, dtype, epilogue,
             seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(B, H, W, Cin, generator=g).to(dtype).to(cuda)
    w = (torch.randn(K, K, Cin, Cout, generator=g)
         * (2.0 / (K * K * Cin)) ** 0.5).to(dtype).to(cuda)
    kw = {}
    if epilogue:
        Ho = (H + 2 * pad - K) // stride + 1
        Wo = (W + 2 * pad - K) // stride + 1
        kw = {"scale": torch.rand(Cout, generator=g).to(cuda) + 0.5,
              "shift": torch.randn(Cout, generator=g).to(cuda),
              "residual": torch.randn(B, Ho, Wo, Cout,
                                      generator=g).to(dtype).to(cuda),
              "relu": True}
    return x, w, kw


def _k5_close(cuda, x, w, kw, stride, pad, dtype):
    before = k5.LAUNCHES.value
    y = k5.conv2d_bn_act(x, w, stride=stride, padding=pad, **kw)
    torch.cuda.synchronize()
    assert k5.LAUNCHES.value == before + 1
    ref = k5.conv2d_bn_act_reference(x, w, stride=stride, padding=pad, **kw)
    assert y.dtype == dtype and y.shape == ref.shape
    scale = float(ref.float().abs().max())
    torch.testing.assert_close(y.float(), ref.float(), rtol=0,
                               atol=K5_TOL[dtype] * scale)


@pytest.mark.parametrize("shape", RESNET_K5_SHAPES)
def test_conv_kernel_matches_plain_at_resnet_shapes(cuda, shape):
    H, Cin, K, Cout, stride, pad = shape
    x, w, kw = _k5_case(cuda, 2, H, H, Cin, K, Cout, stride, pad,
                        torch.float32, False)
    _k5_close(cuda, x, w, kw, stride, pad, torch.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [
    # B, H, W, Cin, K, Cout, stride, pad: odd B*H*W, Cout 128, 130 (the
    # scalar path), 3 and 2048, stride 2 with odd sizes
    (3, 13, 13, 128, 3, 128, 1, 1), (1, 9, 7, 256, 1, 130, 2, 0),
    (5, 7, 9, 128, 3, 3, 2, 1), (2, 4, 4, 512, 1, 2048, 1, 0),
    (1, 1, 1, 128, 1, 128, 1, 0), (3, 11, 5, 384, 3, 200, 2, 1)])
def test_conv_kernel_epilogue_and_odd_sizes(cuda, dtype, case):
    B, H, W, Cin, K, Cout, stride, pad = case
    for epilogue in (False, True):
        x, w, kw = _k5_case(cuda, B, H, W, Cin, K, Cout, stride, pad, dtype,
                            epilogue, seed=B + H)
        _k5_close(cuda, x, w, kw, stride, pad, dtype)


def test_conv_kernel_float32_limit_at_k4608_against_float64(cuda):
    """K 4608, the deepest routed reduction: the 3xTF32 products, summed
    from zero a 32-channel step at a time and added in float32, keep y
    within 2e-5 of the output's scale of the conv evaluated in float64."""
    x, w, kw = _k5_case(cuda, 8, 7, 7, 512, 3, 512, 1, 1, torch.float32,
                        False, seed=3)
    y = k5.conv2d_bn_act(x, w, stride=1, padding=1)
    torch.cuda.synchronize()
    exact = torch.nn.functional.conv2d(
        x.double().permute(0, 3, 1, 2), w.double().permute(3, 2, 0, 1),
        padding=1).permute(0, 2, 3, 1)
    scale = float(exact.abs().max())
    assert float((y.double() - exact).abs().max()) <= 2e-5 * scale


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tile", range(len(k5.TILES)))
def test_conv_kernel_gives_the_same_bits_twice_for_each_tile(cuda, dtype,
                                                              tile):
    """Two runs of a tile configuration give the same bits, and every
    configuration those of the wrapper's choice: each output sums its
    products in the same order whatever the tile."""
    # an M tail (3 * 13 * 13 = 507 rows) and an N tail (Cout 200)
    x, w, kw = _k5_case(cuda, 3, 13, 13, 256, 3, 200, 1, 1, dtype, True,
                        seed=7)
    a = k5.conv2d_bn_act(x, w, stride=1, padding=1, tile=tile, **kw)
    b = k5.conv2d_bn_act(x, w, stride=1, padding=1, tile=tile, **kw)
    chosen = k5.conv2d_bn_act(x, w, stride=1, padding=1, **kw)
    torch.cuda.synchronize()
    assert torch.equal(a, b) and torch.equal(a, chosen)
    ref = k5.conv2d_bn_act_reference(x, w, stride=1, padding=1, **kw)
    torch.testing.assert_close(a.float(), ref.float(), rtol=0,
                               atol=K5_TOL[dtype] * float(ref.float().abs()
                                                          .max()))


def test_conv_kernel_takes_misaligned_and_strided_views(cuda):
    x, w, kw = _k5_case(cuda, 2, 6, 6, 128, 3, 64, 1, 1, torch.float32,
                        True)
    base = torch.zeros(x.numel() + 1, device=cuda)
    x_off = base[1:].view_as(x).copy_(x)           # 4 bytes off 16
    w_t = w.permute(0, 1, 3, 2).contiguous().permute(0, 1, 3, 2)
    assert x_off.data_ptr() % 16 and not w_t.is_contiguous()
    y = k5.conv2d_bn_act(x_off, w_t, stride=1, padding=1, **kw)
    ref = k5.conv2d_bn_act_reference(x, w, stride=1, padding=1, **kw)
    torch.testing.assert_close(y, ref, rtol=0,
                               atol=2e-5 * float(ref.abs().max()))


@pytest.mark.parametrize("x,w,stride,match", [
    ((1, 8, 8, 128), (3, 3, 128, 128), 3, "stride 1 or 2"),
    ((1, 8, 8, 64), (3, 3, 64, 128), 1, "Cin % 128"),
    ((1, 8, 8, 128), (5, 5, 128, 128), 1, "1x1 or 3x3")])
def test_conv_kernel_refuses_what_it_does_not_take(cuda, x, w, stride,
                                                   match):
    with pytest.raises(ValueError, match=match):
        k5.conv2d_bn_act(torch.zeros(x, device=cuda),
                         torch.zeros(w, device=cuda), stride=stride)
    h = torch.zeros((1, 8, 8, 128), device=cuda, dtype=torch.float16)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        k5.conv2d_bn_act(h, torch.zeros((1, 1, 128, 8), device=cuda,
                                        dtype=torch.float16))


def test_conv_kernel_never_reaches_the_plain_version_on_the_card(
        cuda, monkeypatch):
    calls = []
    monkeypatch.setattr(k5, "conv2d_bn_act_reference",
                        lambda *a, **kw: calls.append(1))
    x, w, _ = _k5_case(cuda, 2, 8, 8, 128, 1, 64, 1, 0, torch.float32,
                       False)
    before = k5.LAUNCHES.value
    y = k5.pallas_conv(x.requires_grad_(True), w.requires_grad_(True), 1, 0)
    y.square().sum().backward()
    torch.cuda.synchronize()
    assert calls == [] and k5.LAUNCHES.value == before + 1
    assert torch.isfinite(x.grad).all() and torch.isfinite(w.grad).all()


def test_routed_conv2d_op_launches_k5_once_per_forward(cuda):
    old = fluid.get_flags("FLAGS_use_pallas_conv")
    fluid.set_flags({"FLAGS_use_pallas_conv": "all"})
    try:
        main, startup = fluid.Program(), fluid.Program()
        with fluid.unique_name.guard(), fluid.program_guard(main, startup):
            x = fluid.data(name="x", shape=[2, 8, 8, 128], dtype="float32")
            x.stop_gradient = False
            y = fluid.layers.conv2d(x, 64, 3, padding=1, bias_attr=False,
                                    data_format="NHWC")
            loss = fluid.layers.mean(y)
            fluid.backward.append_backward(loss)
        feed = {"x": np.random.RandomState(0).rand(2, 8, 8, 128).astype(
            "float32")}
        outs = {}
        for name, place in (("cpu", fluid.CPUPlace()), ("card", cuda)):
            exe = fluid.Executor(place if name == "cpu"
                                 else fluid.CUDAPlace(0))
            scope = fluid.Scope()
            exe.run(startup, scope=scope)
            if name == "card":
                fluid.io.scope_from_numpy(scope, init, fluid.CUDAPlace(0))
            else:
                init = {"conv2d.w_0": scope.find_var(
                    "conv2d.w_0").get_tensor().numpy()}
            before = k5.LAUNCHES.value
            outs[name] = exe.run(main, feed=feed, scope=scope,
                                 fetch_list=[y, "conv2d.w_0@GRAD",
                                             "x@GRAD"])
            launched = k5.LAUNCHES.value - before
        assert launched == 1  # the forward only: conv2d_grad runs cuDNN
        for got, want in zip(outs["card"], outs["cpu"]):
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=2e-5 * np.abs(want).max())
    finally:
        fluid.set_flags(old)


# -- paged decode attention (K6) and the decode engine -------------------------

K6_TOL = 2e-5  # every storage: both sides widen the same stored bits


def _k6_case(cuda, B, H, D, bt, lens, storage, shared, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    seqs = [max(lens)] if shared else list(lens)
    nb = sum(-(-n // bt) for n in seqs) + 3
    shape = (nb, bt, H, D)
    if storage == "int8":
        ka, va = (torch.randint(-127, 128, shape, device=cuda, generator=g,
                                dtype=torch.int8) for _ in range(2))
        ks, vs = ((torch.rand(nb, H, device=cuda, generator=g) + 0.5) / 127
                  for _ in range(2))
    else:
        ka, va = (torch.randn(shape, device=cuda, generator=g)
                  for _ in range(2))
        ks = vs = None
        if storage == "bf16":
            ka, va, ks, vs = ka.bfloat16(), va.bfloat16(), "bf16", "bf16"
    perm = torch.randperm(nb, device=cuda, generator=g).to(torch.int32)
    width = max(1, max(-(-n // bt) for n in seqs))
    table = torch.full((len(seqs), width), -1, dtype=torch.int32,
                       device=cuda)
    used = 0
    for b, n in enumerate(seqs):
        k = -(-n // bt)
        table[b, :k] = perm[used:used + k]
        used += k
    return dict(q=torch.randn(B, H, D, device=cuda, generator=g),
                k_arena=ka, v_arena=va, k_scales=ks, v_scales=vs,
                block_tables=table, block_tokens=bt,
                seq_lens=torch.tensor(lens, dtype=torch.int32, device=cuda))


@pytest.mark.parametrize("storage", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("form", [
    # (B, H, D, block_tokens, lengths or None for the prefill form)
    (6, 16, 64, 16, [0, 1, 15, 16, 17, 300]),
    (20, 16, 64, 16, None),
    (9, 2, 8, 16, [0, 1, 15, 16, 17, 40, 3, 100, 7]),
    (5, 3, 200, 4, [9, 0, 1, 3, 4]),
    (7, 2, 31, 8, None)])
def test_paged_kernel_matches_plain_version(cuda, storage, form):
    B, H, D, bt, lens = form
    shared = lens is None
    if shared:
        lens = [40 + t + 1 for t in range(B)]
    case = _k6_case(cuda, B, H, D, bt, lens, storage, shared, seed=B + D)
    before = k6.LAUNCHES.value
    got = k6.paged_decode_attention(**case)
    torch.cuda.synchronize()
    assert k6.LAUNCHES.value == before + 1
    want = k6.paged_attention_reference(**case)
    scale = float(want.abs().max())
    torch.testing.assert_close(got, want, rtol=0, atol=K6_TOL * scale)
    for b, n in enumerate(lens):
        if n == 0:
            assert (got[b] == 0).all()
    # a row alone: the bits it has in the batch (and in the other form)
    for b in (0, B - 1):
        one = dict(case, q=case["q"][b:b + 1].contiguous(),
                   seq_lens=case["seq_lens"][b:b + 1].contiguous(),
                   block_tables=case["block_tables"][
                       0 if shared else b:(0 if shared else b) + 1])
        assert torch.equal(k6.paged_decode_attention(**one)[0], got[b])


@pytest.mark.parametrize("storage", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("D", [8, 64, 128, 256])
@pytest.mark.parametrize("bt", [1, 16, 17])
def test_paged_kernel_forms_give_the_same_bits(cuda, storage, D, bt):
    """A prefill chunk's rows (one shared table, lengths start + t + 1, so
    rows end inside, at and past tiles that cross blocks) give the same
    bits through the decode form, each row with its own copy of the
    table, and agree with the plain version."""
    B, H = 70, 2
    lens = [30 + t for t in range(B)]
    case = _k6_case(cuda, B, H, D, bt, lens, storage, True, seed=D + bt)
    got = k6.paged_decode_attention(**case)
    wide = dict(case, block_tables=case["block_tables"].expand(
        B, -1).contiguous())
    assert torch.equal(k6.paged_decode_attention(**wide), got)
    want = k6.paged_attention_reference(**case)
    scale = float(want.abs().max())
    torch.testing.assert_close(got, want, rtol=0, atol=K6_TOL * scale)


@pytest.mark.parametrize("storage,D", [("f32", 64), ("bf16", 64),
                                       ("int8", 64), ("f32", 30),
                                       ("int8", 8)])
def test_paged_kernel_refuses_a_misaligned_arena(cuda, storage, D):
    """An arena view one element off the copy width's alignment (16 bytes
    for 16-byte rows, 8 for f32 D 30 and int8 D 8) raises."""
    case = _k6_case(cuda, 2, 2, D, 4, [3, 5], storage, False, 0)
    ka = case["k_arena"]
    width = k6.copy_width(D, ka.element_size())
    assert width > ka.element_size()
    flat = torch.zeros(ka.numel() + 1, dtype=ka.dtype, device=cuda)
    shifted = flat[1:].view(ka.shape)
    shifted.copy_(ka)
    with pytest.raises(ValueError, match="aligned to %d bytes" % width):
        k6.paged_decode_attention(**dict(case, k_arena=shifted))


def test_paged_kernel_refuses_what_it_does_not_take(cuda):
    case = _k6_case(cuda, 2, 2, 8, 4, [3, 5], "f32", False, 0)
    with pytest.raises(ValueError, match="head dim"):
        k6.paged_decode_attention(**dict(
            case, q=torch.zeros(2, 2, 300, device=cuda),
            k_arena=torch.zeros(4, 4, 2, 300, device=cuda),
            v_arena=torch.zeros(4, 4, 2, 300, device=cuda)))
    with pytest.raises(ValueError, match="backend"):
        k6.paged_decode_attention(**case, backend="dense")
    with pytest.raises(ValueError, match="float32 q"):
        k6.paged_decode_attention(**dict(case, q=case["q"].double()))
    with pytest.raises(ValueError, match="contiguous"):
        k6.paged_decode_attention(**dict(
            case, k_arena=case["k_arena"].transpose(1, 2).contiguous()
            .transpose(1, 2)))


def test_paged_kernel_never_reaches_the_plain_version_on_the_card(
        cuda, monkeypatch):
    calls = []
    monkeypatch.setattr(k6, "paged_attention_reference",
                        lambda *a, **kw: calls.append(1))
    for storage in ("f32", "bf16", "int8"):
        case = _k6_case(cuda, 4, 2, 8, 4, [3, 0, 9, 4], storage, False, 1)
        out = k6.paged_decode_attention(**case)
        assert torch.isfinite(out).all()
    assert calls == []


def _decode_cfg(place, **kw):
    kw.setdefault("kv_blocks", 128)
    kw.setdefault("eos_token", None)
    return DecodeConfig(place=place, **kw)


def _stream_tokens(engine, specs):
    streams = [engine.submit(p, max_tokens=n) for p, n in specs]
    return [[e["token"] for e in s if e["type"] == "token"] for s in streams]


def test_decode_engine_on_the_card_launches_k6_and_agrees(cuda):
    rng = np.random.RandomState(3)
    specs = [([int(t) for t in rng.randint(1, 97, size=n)], 12)
             for n in (3, 9, 20, 33, 5, 14)]
    support.reset_launch_counts()
    card = DecodeEngine(_decode_cfg(fluid.CUDAPlace(0))).start()
    try:
        assert card.device.type == "cuda"
        got = _stream_tokens(card, specs)
        st = card.stats()
    finally:
        card.stop()
    assert support.launch_counts()["paged_decode_attention"] == 2 * (
        st["serving.decode_steps"] + st["serving.prefill_chunks"])
    cpu = DecodeEngine(_decode_cfg(fluid.CPUPlace())).start()
    try:
        want = _stream_tokens(cpu, specs)
    finally:
        cpu.stop()
    # float32 on both sides; at this size no top-2 gap is within rounding
    assert got == want


@pytest.mark.parametrize("kv_dtype", ["f32", "bf16", "int8"])
def test_decode_engine_tokens_do_not_depend_on_batch_or_preemption(
        cuda, kv_dtype):
    rng = np.random.RandomState(4)
    specs = [([int(t) for t in rng.randint(1, 97, size=n)], 20)
             for n in (30, 17, 41, 25)]

    def run(together, **kw):
        # one block size throughout: int8 scales are per block
        e = DecodeEngine(_decode_cfg(fluid.CUDAPlace(0), kv_dtype=kv_dtype,
                                     max_batch_size=4, kv_block_tokens=4,
                                     **kw)).start()
        try:
            if together:
                return _stream_tokens(e, specs), e.stats()
            return [_stream_tokens(e, [s])[0] for s in specs], e.stats()
        finally:
            e.stop()

    alone, _ = run(False)
    # 20 blocks of 4 hold the longest stream (16 blocks), not all four
    tight, st = run(True, kv_blocks=20)
    assert st["serving.preemptions"] >= 1
    chunked, _ = run(True, prefill_chunk_tokens=5)
    assert alone == tight == chunked


# -- the whole-program route: CUDA graph capture ---------------------------

def _persistables(main, scope):
    return {v.name: scope.find_var(v.name).get_tensor().numpy()
            for v in main.global_block().vars.values()
            if v.persistable and scope.find_var(v.name) is not None
            and scope.find_var(v.name).is_initialized()}


def test_captured_bert_step_matches_the_interpreter(cuda):
    build, feeds = _transformer_twin("bert")
    main, startup, loss, _ = build()
    exe = fluid.Executor()
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    init = _persistables(main, scope)
    ce.reset_counters()
    captured = [float(np.asarray(exe.run(main, feed=f, fetch_list=[loss],
                                         scope=scope)[0]).reshape(-1)[0])
                for f in feeds]
    assert ce.counters()["executor.jit_traces"] == 1
    scope2 = fluid.Scope()
    fluid.io.scope_from_numpy(scope2, init, fluid.CUDAPlace(0))
    interp = [float(np.asarray(exe._core.run_program(
        main, scope2, f, [loss])[0]).reshape(-1)[0]) for f in feeds]
    np.testing.assert_allclose(captured, interp, rtol=1e-6, atol=0)
    want = _persistables(main, scope2)
    for name, got in _persistables(main, scope).items():
        scale = max(float(np.abs(want[name]).max()), 1e-3)
        np.testing.assert_allclose(got, want[name], rtol=0,
                                   atol=1e-4 * scale, err_msg=name)


def test_one_capture_serves_five_steps_and_replays_count_launches(
        cuda, monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_FUSED_OPTIMIZER", "1")
    main, startup, loss, _ = gpt.build_gpt_long(**TWIN, seed=1,
                                                use_bf16=False)
    feed = gpt.random_batch(np.random.RandomState(0), TWIN["batch"],
                            TWIN["seq_len"], TWIN["vocab"])
    exe = fluid.Executor()
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    ce.reset_counters()
    support.reset_launch_counts()
    losses = []
    for step in range(5):
        before = support.launch_counts()
        (out,) = exe.run(main, feed=feed, fetch_list=[loss], scope=scope,
                         return_numpy=False)
        after = support.launch_counts()
        delta = {k: after[k] - before[k] for k in after if after[k] != before[k]}
        assert delta == {"flash_attention_forward": 4,
                         "flash_attention_backward_dq": 2,
                         "flash_attention_backward_dkv": 2,
                         "fused_optimizer_update": 1}, (step, delta)
        losses.append(out)
    c = ce.counters()
    assert (c["executor.compiles"], c["executor.jit_traces"],
            c["executor.steps"], c["executor.compile_fallbacks"]) == \
        (1, 1, 5, 0)
    vals = [float(o.numpy().reshape(-1)[0]) for o in losses]
    assert len(set(vals)) == 5 and vals[-1] < vals[0], vals


def _uniform_program(seed=0):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.data(name="x", shape=[64, 32], dtype="float32")
        blk = main.global_block()
        u = blk.create_var(name="u", shape=(64, 32), dtype="float32")
        blk.append_op("uniform_random", outputs={"Out": [u]},
                      attrs={"shape": [64, 32], "min": -2.0, "max": 3.0,
                             "seed": seed, "dtype": 5}, infer_shape=False)
        y = fluid.layers.elementwise_add(x, u)
    return main, y


@pytest.mark.parametrize("seed", [0, 7])
def test_replays_draw_what_the_interpreter_draws(cuda, seed):
    main, y = _uniform_program(seed)
    feed = {"x": np.zeros((64, 32), "float32")}
    draws = {}
    for mode in ("captured", "interp"):
        exe = fluid.Executor()
        exe._core.rng.seed = 12345
        ce.reset_counters()
        run = (exe.run if mode == "captured" else
               lambda p, feed, fetch_list, scope: exe._core.run_program(
                   p, scope, feed, fetch_list))
        scope = fluid.Scope()
        draws[mode] = [run(main, feed=feed, fetch_list=[y],
                           scope=scope)[0] for _ in range(5)]
        if mode == "captured":
            assert ce.counters()["executor.jit_traces"] == 1
    assert [d.tobytes() for d in draws["captured"]] == \
        [d.tobytes() for d in draws["interp"]]
    got = draws["captured"]
    assert all(((d >= -2.0) & (d < 3.0)).all() for d in got)
    distinct = len({d.tobytes() for d in got})
    assert distinct == (1 if seed else 5)  # a fixed seed draws the same


def test_a_host_constant_is_made_outside_the_captured_graph(cuda):
    """``assign_value`` copies its values from the host, which a graph
    cannot capture: the route makes it once, before the capture (the WMT
    script's causal-bias form has one)."""
    vals = np.arange(12, dtype="float32").reshape(3, 4) / 7.0
    main = fluid.Program()
    with fluid.program_guard(main, fluid.Program()):
        x = fluid.data(name="x", shape=[3, 4], dtype="float32")
        c = fluid.layers.assign(vals)
        y = fluid.layers.elementwise_mul(x, c)
    assert "assign_value" in [op.type for op in main.global_block().ops]
    exe = fluid.Executor()
    scope = fluid.Scope()
    rng = np.random.RandomState(0)
    ce.reset_counters()
    for _ in range(4):
        f = {"x": rng.rand(3, 4).astype("float32")}
        (got,) = exe.run(main, feed=f, fetch_list=[y], scope=scope)
        np.testing.assert_array_equal(got, f["x"] * vals)
    assert ce.counters()["executor.jit_traces"] == 1


def test_a_graph_captured_on_a_worker_thread_replays_here(cuda):
    main, y = _uniform_program(seed=3)
    exe = fluid.Executor()
    scope = fluid.Scope()
    rng = np.random.RandomState(0)
    feeds = [{"x": rng.rand(64, 32).astype("float32")} for _ in range(4)]
    out, errors = [], []

    def worker():
        try:
            for f in feeds[:2]:  # the eager run, then the capture
                out.append(exe.run(main, feed=f, fetch_list=[y],
                                   scope=scope)[0])
        except Exception as e:  # re-raised below
            errors.append(e)

    ce.reset_counters()
    t = threading.Thread(target=worker)
    t.start()
    t.join(timeout=120)
    assert not t.is_alive() and not errors, errors
    for f in feeds[2:]:
        out.append(exe.run(main, feed=f, fetch_list=[y], scope=scope)[0])
    assert ce.counters()["executor.jit_traces"] == 1
    interp = fluid.Scope()
    for f, o in zip(feeds, out):  # a fixed seed: the same u every step
        (want,) = exe._core.run_program(main, interp, f, [y])
        assert o.tobytes() == want.tobytes()


def test_serving_warmup_captures_each_bucket_and_a_burst_none(cuda,
                                                              tmp_path):
    from paddle_tpu_torch.serving import ServingConfig, ServingEngine

    T = 32
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        src = fluid.data(name="src_ids", shape=[-1, T], dtype="int64")
        pos = fluid.data(name="pos_ids", shape=[-1, T], dtype="int64")
        lens = fluid.data(name="lengths", shape=[-1], dtype="int32")
        enc = transformer.transformer_encoder(
            src, pos, 101, max_len=64, num_layers=2, num_heads=2,
            d_model=128, d_ff=256, is_test=True, src_lengths=lens)
    exe = fluid.Executor()
    with fluid.scope_guard(fluid.Scope()):
        exe.run(startup)
        fluid.io.save_inference_model(str(tmp_path),
                                      ["src_ids", "pos_ids", "lengths"],
                                      [enc], exe, main_program=main)
    pred = create_paddle_predictor(AnalysisConfig(str(tmp_path)))
    ce.reset_counters()
    engine = ServingEngine(pred, ServingConfig(max_batch_size=8,
                                               max_queue=64))
    engine.start()
    assert ce.counters()["executor.jit_traces"] == 4  # buckets 1, 2, 4, 8
    rng = np.random.RandomState(0)
    reqs = []
    for _ in range(40):
        rows = int(rng.randint(1, 4))
        reqs.append({"src_ids": rng.randint(0, 101, (rows, T)).astype(
                         "int64"),
                     "pos_ids": np.tile(np.arange(T), (rows, 1)).astype(
                         "int64"),
                     "lengths": rng.randint(1, T + 1, rows).astype("int32")})
    futures = [engine.submit(r) for r in reqs]
    outs = [f.result(timeout=120) for f in futures]
    engine.stop()
    assert ce.counters()["executor.jit_traces"] == 4
    assert ce.counters()["executor.compile_fallbacks"] == 0
    cfg = AnalysisConfig(str(tmp_path))
    cfg.disable_gpu()
    cpu = create_paddle_predictor(cfg)
    for r, o in list(zip(reqs, outs))[:4]:
        (want,) = cpu.run(r)
        (got,) = o.values()
        np.testing.assert_allclose(got, want.data, rtol=1e-4, atol=1e-4)


def test_close_gives_the_graphs_memory_back(cuda):
    build, feeds = _transformer_twin("wmt")
    main, startup, loss, _ = build()
    exe = fluid.Executor()
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    for f in feeds:
        exe.run(main, feed=f, fetch_list=[loss], scope=scope)
    assert len(exe._core.graphs) == 1
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_reserved()
    exe.close()
    gc.collect()
    torch.cuda.empty_cache()
    assert not exe._core.graphs
    assert torch.cuda.memory_reserved() < held


def test_bf16_gemm_partial_sums_stay_float32(cuda):
    assert not torch.backends.cuda.matmul.\
        allow_bf16_reduced_precision_reduction


def _amp_mlp(dyn):
    """tests/test_amp.py's MLP under ``mp.decorate`` with dynamic loss
    scaling from 2**10, shrinking after one overflowing step."""
    main, startup = fluid.Program(), fluid.Program()
    startup.random_seed = 3
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.data(name="x", shape=[64, 32], dtype="float32")
        y = fluid.data(name="y", shape=[64, 1], dtype="int64")
        h = fluid.layers.fc(x, 64, act="relu")
        pred = fluid.layers.fc(h, 10, act="softmax")
        loss = fluid.layers.mean(fluid.layers.cross_entropy(pred, y))
        opt = fluid.contrib.mixed_precision.decorate(
            fluid.optimizer.SGD(0.5), use_dynamic_loss_scaling=dyn,
            init_loss_scaling=2 ** 10, decr_every_n_nan_or_inf=1)
        opt.minimize(loss)
    return main, startup, loss, opt


def test_amp_inf_step_on_the_captured_route_skips_and_shrinks(cuda):
    main, startup, loss, opt = _amp_mlp(dyn=True)
    rng = np.random.RandomState(0)
    xb = rng.randn(64, 32).astype("float32")
    feed = {"x": xb, "y": rng.randint(0, 10, (64, 1)).astype("int64")}
    exe = fluid.Executor()
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    for _ in range(3):  # eager, capture, replay
        exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    ce.reset_counters()
    params = [p.name for p in main.all_parameters()]
    scale = opt.get_loss_scaling().name
    before = _persistables(main, scope)
    bad = dict(feed, x=xb.copy())
    bad["x"][5, 7] = np.inf
    exe.run(main, feed=bad, fetch_list=[loss], scope=scope)
    after = _persistables(main, scope)
    for n in params:
        np.testing.assert_array_equal(after[n], before[n], err_msg=n)
    assert after[scale][0] < before[scale][0]
    exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    again = _persistables(main, scope)
    assert all(not np.array_equal(again[n], after[n]) for n in params)
    c = ce.counters()
    assert (c["executor.jit_traces"], c["executor.compile_fallbacks"],
            c["executor.steps"]) == (0, 0, 2)


def test_resnet_amp_twin_launches_k5_in_bf16_only(cuda, monkeypatch):
    """ResNet-50 NHWC at 64x64, batch 4, class_dim 10, lr 1e-3 under
    ``mp.decorate``, three steps on the card, each from the CPU run's
    state before it."""
    from paddle_tpu_torch.models.resnet import build_resnet_train, \
        random_batch

    monkeypatch.setenv("PADDLE_TPU_FUSED_OPTIMIZER", "1")
    old = fluid.get_flags("FLAGS_use_pallas_conv")
    fluid.set_flags({"FLAGS_use_pallas_conv": "all"})
    try:
        rng = np.random.RandomState(5)
        feeds = [random_batch(rng, 4, 64, 10) for _ in range(3)]
        losses, states = {}, []
        for side, place in (("cpu", fluid.CPUPlace()),
                            ("card", fluid.CUDAPlace(0))):
            main, startup, loss = build_resnet_train(
                4, 64, 10, learning_rate=1e-3, seed=6, use_bf16=True)
            exe = fluid.Executor(place)
            scope = fluid.Scope()
            if side == "cpu":
                exe.run(startup, scope=scope)
            support.reset_launch_counts()
            losses[side] = []
            for i, feed in enumerate(feeds):
                if side == "cpu":
                    states.append(_persistables(main, scope))
                else:
                    fluid.io.scope_from_numpy(scope, states[i], place)
                (out,) = exe.run(main, feed=feed, fetch_list=[loss],
                                 scope=scope)
                losses[side].append(float(np.asarray(out).reshape(-1)[0]))
            counts = support.launch_counts()
    finally:
        fluid.set_flags(old)
    assert counts["conv2d_bn_act"] == counts["conv2d_bn_act_bf16"] == 44 * 3
    assert counts["fused_optimizer_update"] == 3
    assert np.isfinite(losses["card"]).all()
    np.testing.assert_allclose(losses["card"], losses["cpu"], rtol=0.15)
