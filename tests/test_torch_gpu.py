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

Slice 11 on the card: after a capture, a run that leaves out a feed raises
the JAX package's error (feeds are never written into the scope) and a
float64 feed runs in float32; ``FLAGS_check_nan_inf`` raises
``EnforceNotMet`` at the op whose output holds an inf; ``dropout`` under
capture draws a new mask every replay, keeps 1 - p of the elements within
5 binomial standard deviations, its grad is Out@GRAD times the forward's
mask over 1 - p bit for bit, and every fetch equals the interpreter's
bits for the same executor seed; the narrow Wide&Deep twin (vocab 1000, 4
slots, batch 64, both fusion passes on) trains 3 steps on the card with
one capture and K4 launched 3 times, its losses within 1e-4 relative of
the CPU run's.

Dygraph on the card (``fluid.dygraph.guard()``): lazy mode captures a
repeated step once (an eager flush first, then a replay a step) and a
one-off structure never; under NoamDecay the replayed steps give the
eager card run's parameters (the rate is a graph input); a flash
encoder's tape launches K1/K2/K3 once each per layer a step, eager and
lazy; a narrow encoder trained lazily on the card agrees with the CPU
within 1e-4.

LoD on the card (slice 15): each LoD op and its grad (sequence_pool MAX
over ties, sequence_conv with trainable padding, lstm, gru, the padded
twins) gives its CPU result within 1e-5 of scale; an ``is_sparse``
embedding's SelectedRows grad has the CPU's rows and values and its sgd
the CPU's table; a lowered LoD program (convolution_net's shape) is
captured once for a bucket, declines nothing and gives the card
interpreter's losses within 1e-5 relative.

The training recipe on the card (slice 13): a scheduled learning rate
advances across the replays of one captured graph (its step counters are
state buffers) and gives the CPU's rates within 1e-6; K4 reads a rate
computed inside the graph, and its updates agree with the CPU's within
1e-4 of each parameter's scale; a per-parameter rate leaves one K4 group
and one per-parameter adam op; the narrow gpt under recompute launches
K1/K2/K3/K4 6/2/2/1 times a step and gives the losses of the run without
recompute.

The recurrent family and control flow on the card (slice 14): each new op
(the shape and selection ops, the logical ops, ``gather_tree`` and the
cells ``lstm_unit``, ``gru_unit``, ``cudnn_lstm``, forward and, where it
has one, grad) gives its CPU result on the same inputs, within 1e-5 of the
output's scale in float32 (TF32 off; products summed in another order)
and exactly for integer and boolean outputs; ``top_k`` breaks planted ties
lower index first on a row of 77,090 candidates; a ``while`` program
trained through ``while_grad`` takes the interpreter (one counted
fallback, no capture) and gives the CPU's losses and weights within 1e-5;
a forward ``while`` is a captured while node (slice 19: bitwise against
the card's interpreter, one capture replayed at 50, 17 and 0 trips, no
condition read in a replay, exact launch counts through its body), a
scalar ``conditional_block`` an if node, a dropout in a loop declined by
name; the
seq2seq beam decode at batch 8 gives the CPU's ids and scores within
1e-5 (random weights, no near-tie at the beam's edge at this seed).

Data parallelism on the card (slice 20): a narrow gpt over
``[CUDAPlace(0)] * 2`` captures both replicas once, keeps their
parameters bitwise equal and in separate buffers after every step, and
its replicas' mean loss stays within 1e-4 of one replica's full batch;
``c_sharded_update`` runs K4 on each replica's shard, bitwise its plain
version on the same shards; a program the single-chip fused optimizer
rewrote is refused on two replicas; two gloo ranks on one card decline
the static program's capture by the collective's name.

The hybrid axes on the card (slice 21): ``c_ring_attention``'s form over
4 sp replicas (causal, key lengths) within 2e-5 of the dense reference in
float32 and 5e-2 in bfloat16; ``c_sharded_lookup``'s grad form takes each
block's own hit rows (the blocks together the dense grad within 1e-6,
two runs the same bits); a dp x mp step's capture replays its eager step
bit for bit from the same state; a pipelined step runs eagerly and
counts its decline, ``pipeline (eager stages)``, once.

Placement and steering on the card (slice 23): over two replicas of a
narrow gpt the tree spelling, the async split and the profile bucket plan
(from the card's own profile_step report) train the ring's losses bit for
bit; a tree that skips its all-gather leaves the replicas apart; the
card's report fits the search's cost model and the winner applies through
PADDLE_TPU_PLACEMENT_PLAN; a canary serves the serving_ladder proposal's
answers within 1e-5 of the incumbent's and audits its decision; the lazy
key-cap policy stops recaptures.

The parameter server on the card (slice 24): two sync rounds of a narrow
Wide&Deep, its tables row-sliced over two in-process pservers on the CPU,
with the trainer on the card give the CPU trainer's losses and every
server's state within 1e-5 (TF32 off; products summed in another order),
the trainer's host copies counted at the PS ops; a geo-SGD trainer's
Adam ops fold into one fused_optimizer op under
PADDLE_TPU_FUSED_OPTIMIZER, K4 runs once a step and its delta pushes
leave the server's params at the trainer's, within 1e-5 of the CPU run.

The survivable parameter server on the card (slice 25): a primary and a
backup whose executors hold their state on the card, the primary stopped
after round 2 of 4: the promoted backup's tables, moments and params are
bitwise the unkilled group's, and the servers copied their card state
down to hash and ship it (``copy_counts``).
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


# -- the repaired faults, dropout and Wide&Deep on the card -----------------

def _sum_program():
    main = fluid.Program()
    with fluid.program_guard(main, fluid.Program()):
        x = fluid.data(name="x", shape=[2, 3], dtype="float32")
        y = fluid.data(name="y", shape=[2, 3], dtype="float32")
        out = fluid.layers.reduce_sum(fluid.layers.elementwise_add(x, y))
    return main, out


def test_a_left_out_feed_raises_after_a_capture(cuda):
    main, out = _sum_program()
    exe = fluid.Executor()
    ones = np.ones((2, 3), "float32")
    for fetch, left_out in ((["y", out], "x"), ([out], "y")):
        scope = fluid.Scope()
        ce.reset_counters()
        for _ in range(3):  # eager, capture, replay
            res = exe.run(main, feed={"x": ones, "y": 2 * ones},
                          fetch_list=fetch, scope=scope)
            assert float(res[-1]) == 18.0
            if len(res) == 2:  # a fetched feed returns the fed value
                np.testing.assert_array_equal(res[0], 2 * ones)
        assert ce.counters()["executor.jit_traces"] == 1
        # a fetch is written into the scope (as the JAX route writes its
        # fetches), a feed never: leave out the one never fetched
        kept = {"x": ones, "y": ones}
        del kept[left_out]
        with pytest.raises(RuntimeError) as err:
            exe.run(main, feed=kept, fetch_list=[out], scope=scope)
        assert str(err.value) == ("variable %r must be fed or initialized "
                                  "in scope" % left_out)


def test_a_float64_feed_runs_in_float32_on_the_card(cuda):
    main, out = _sum_program()
    exe = fluid.Executor()
    scope = fluid.Scope()
    for _ in range(3):
        (got,) = exe.run(main, feed={"x": np.ones((2, 3)),
                                     "y": [[1.0] * 3] * 2},
                         fetch_list=[out], scope=scope)
        assert got.dtype == np.float32 and float(got) == 12.0


def test_check_nan_inf_raises_on_the_card(cuda):
    from paddle_tpu_torch.core.enforce import EnforceNotMet

    main = fluid.Program()
    with fluid.program_guard(main, fluid.Program()):
        x = fluid.data(name="x", shape=[2, 3], dtype="float32")
        y = fluid.data(name="y", shape=[2, 3], dtype="float32")
        out = fluid.layers.reduce_sum(fluid.layers.elementwise_div(x, y))
    exe = fluid.Executor()
    fluid.set_flags({"FLAGS_check_nan_inf": True})
    try:
        with pytest.raises(EnforceNotMet) as err:
            exe.run(main, feed={"x": np.ones((2, 3), "float32"),
                                "y": np.zeros((2, 3), "float32")},
                    fetch_list=[out], scope=fluid.Scope())
    finally:
        fluid.set_flags({"FLAGS_check_nan_inf": False})
    assert str(err.value).startswith(
        "Operator 'elementwise_div' output 'elementwise_div.tmp_0' "
        "contains Inf/Nan (FLAGS_check_nan_inf)")


def test_dropout_under_capture_draws_anew_and_the_grad_sees_its_mask(cuda):
    p = 0.3
    main = fluid.Program()
    with fluid.program_guard(main, fluid.Program()):
        x = fluid.data(name="x", shape=[256, 512], dtype="float32")
        x.stop_gradient = False
        d = fluid.layers.dropout(x, dropout_prob=p,
                                 dropout_implementation="upscale_in_train")
        loss = fluid.layers.mean(d)
        fluid.backward.append_backward(loss)
    mask = [op for op in main.global_block().ops
            if op.type == "dropout"][0].output("Mask")[0]
    feed = {"x": np.random.RandomState(0).randn(256, 512).astype("float32")}
    fetch = [mask, "x@GRAD", loss.name + "@GRAD"]
    runs = {}
    for route in ("captured", "interp"):
        exe = fluid.Executor()
        exe._core.rng.seed = 4242
        scope = fluid.Scope()
        ce.reset_counters()
        if route == "captured":
            runs[route] = [exe.run(main, feed=feed, fetch_list=fetch,
                                   scope=scope) for _ in range(6)]
            assert ce.counters()["executor.jit_traces"] == 1
        else:
            runs[route] = [exe._core.run_program(main, scope, feed, fetch)
                           for _ in range(6)]
    replays = runs["captured"][2:]
    assert len({m.tobytes() for m, _, _ in replays}) == len(replays)
    n = feed["x"].size
    for m, gx, gl in replays:
        kept = float(m.sum())
        assert abs(kept - n * (1 - p)) <= 5 * (n * p * (1 - p)) ** 0.5
        d_out = torch.full(m.shape, float(np.asarray(gl).reshape(-1)[0]) / n)
        want = d_out * torch.from_numpy(m) / (1 - p)
        np.testing.assert_array_equal(gx, want.numpy())
    for a, b in zip(runs["captured"], runs["interp"]):
        for u, v in zip(a, b):
            assert np.asarray(u).tobytes() == np.asarray(v).tobytes()


def test_narrow_wide_deep_trains_on_the_card_as_on_the_cpu(cuda,
                                                           monkeypatch):
    import sys

    wd = sys.modules["paddle_tpu_torch.models.wide_deep"]
    monkeypatch.setenv("PADDLE_TPU_FUSED_OPTIMIZER", "1")
    monkeypatch.setenv("PADDLE_TPU_FUSED_EPILOGUE", "1")
    rng = np.random.RandomState(3)
    feeds = [wd.random_batch(rng, 64, 1000, 4) for _ in range(3)]
    init, losses = None, {}
    for side, place in (("cpu", fluid.CPUPlace()),
                        ("card", fluid.CUDAPlace(0))):
        main, startup, loss, _ = wd.build_wide_deep(64, 1000, 4, seed=1)
        exe = fluid.Executor(place)
        scope = fluid.Scope()
        if init is None:
            exe.run(startup, scope=scope)
            init = _persistables(main, scope)
        else:
            fluid.io.scope_from_numpy(scope, init, place)
        support.reset_launch_counts()
        ce.reset_counters()
        losses[side] = [float(np.asarray(exe.run(
            main, feed=f, fetch_list=[loss], scope=scope)[0]).reshape(-1)[0])
            for f in feeds]
    types = [op.type for op in main.global_block().ops]
    assert types.count("fused_bias_act") == 2
    assert types.count("fused_optimizer") == 1
    assert support.launch_counts()["fused_optimizer_update"] == 3
    assert ce.counters()["executor.jit_traces"] == 1
    np.testing.assert_allclose(losses["card"], losses["cpu"], rtol=1e-4)


# -- dygraph on the card ---------------------------------------------------------

def _dy_encoder_run(place, lazy, steps, make_opt, attention="dense",
                    lengths=None, batch=4, seq=32, d=128, heads=2, vocab=64,
                    layers=2, counts_per_step=False):
    """A narrow dygraph BERT-like encoder (d_model 128, 2 heads of 64)
    trained ``steps`` steps from seeded weights under ``guard(place,
    lazy)``: the losses, the parameters and (optionally) each step's
    launches."""
    from paddle_tpu_torch.dygraph import lazy as lz

    D, L = fluid.dygraph, fluid.layers
    with D.guard(place, lazy=lazy):
        emb = D.Embedding(size=[vocab, d])
        blocks = [{"q": D.Linear(d, d), "k": D.Linear(d, d),
                   "v": D.Linear(d, d), "ln": D.LayerNorm(d)}
                  for _ in range(layers)]
        out = D.Linear(d, vocab)
        params = emb.parameters() + [p for b in blocks for lyr in b.values()
                                     for p in lyr.parameters()] \
            + out.parameters()
        rng = np.random.RandomState(11)
        for p in params:
            if len(p.shape) >= 2:
                p.set_value((rng.randn(*p.shape) * 0.05).astype("float32"))
        ids = rng.randint(0, vocab, (batch, seq)).astype("int64")
        lbl = rng.randint(0, vocab, (batch * seq, 1)).astype("int64")
        opt = make_opt(params)
        h = d // heads

        def split(t):
            return L.transpose(L.reshape(t, [batch, seq, heads, h]),
                               [0, 2, 1, 3])

        lz.reset_counters()
        losses, per_step = [], []
        for _ in range(steps):
            support.reset_launch_counts()
            x = emb(D.to_variable(ids))
            for b in blocks:
                q, k, v = split(b["q"](x)), split(b["k"](x)), split(b["v"](x))
                if attention == "flash":
                    ctx = L.flash_attention(
                        q, k, v, lengths=None if lengths is None
                        else D.to_variable(lengths))
                else:
                    ctx = L.matmul(L.softmax(L.matmul(
                        q, k, transpose_y=True, alpha=h ** -0.5)), v)
                ctx = L.reshape(L.transpose(ctx, [0, 2, 1, 3]),
                                [batch, seq, d])
                x = b["ln"](x + ctx)
            loss = L.mean(L.softmax_with_cross_entropy(
                L.reshape(out(x), [batch * seq, vocab]), D.to_variable(lbl)))
            loss.backward()
            opt.minimize(loss, parameter_list=params)
            for p in params:
                p.clear_gradient()
            losses.append(float(loss))
            per_step.append(support.launch_counts())
        return losses, [p.numpy() for p in params], per_step, lz.counters()


def _momentum(params):
    return fluid.optimizer.MomentumOptimizer(0.05, 0.9,
                                             parameter_list=params)


def test_lazy_dygraph_captures_a_repeated_key_once_and_a_one_off_never(cuda):
    """Five steps of one structure: an eager flush, one capture, then a
    replay a step; a step of another shape afterwards is a one-off key
    and captures nothing."""
    from paddle_tpu_torch.dygraph import lazy as lz

    _, _, _, c = _dy_encoder_run(None, True, 5, _momentum)
    assert c["lazy.captures"] == 1 and c["lazy.replays"] == 4, c
    assert c["lazy.recompiles"] == 1 and c["lazy.cache_hits"] == 4, c
    _, _, _, c = _dy_encoder_run(None, True, 1, _momentum, batch=2)
    assert c["lazy.captures"] == 0 and c["lazy.replays"] == 0, c
    assert lz.counters()["lazy.flushes"] == 1


def test_lazy_dygraph_rate_is_an_input_across_replays(cuda):
    """Under NoamDecay the rate changes every step: the replayed steps
    give the eager card run's parameters (the same kernels)."""
    def noam(params):
        return fluid.optimizer.SGDOptimizer(
            fluid.dygraph.NoamDecay(d_model=128, warmup_steps=2),
            parameter_list=params)

    le, pe, _, _ = _dy_encoder_run(None, False, 5, noam)
    ll, pl, _, c = _dy_encoder_run(None, True, 5, noam)
    assert c["lazy.replays"] == 4
    np.testing.assert_allclose(ll, le, rtol=1e-6)
    for a, b in zip(pl, pe):
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=1e-6 * max(np.abs(b).max(), 1e-3))
    # a rate baked into the graph would give other parameters
    _, pf, _, _ = _dy_encoder_run(None, True, 5, lambda ps:
                                  fluid.optimizer.SGDOptimizer(
                                      0.02, parameter_list=ps))
    assert any(not np.allclose(a, b) for a, b in zip(pl, pf))


@pytest.mark.parametrize("lazy", [False, True], ids=["eager", "lazy"])
def test_dygraph_flash_launches_k1_k3_through_the_tape(cuda, lazy):
    """Each flash op runs K1 once forward and its tape pullback K2 and K3
    once: 2/2/2 launches a step for 2 layers, eager and lazy (the lazy
    backward pulls through the forward's saved graph, never a second
    K1), and the losses are the dense attention's within 1e-4."""
    lengths = np.array([32, 17, 32, 5], dtype="int32")
    losses, _, per_step, _ = _dy_encoder_run(None, lazy, 3, _momentum,
                                             attention="flash")
    for counts in per_step:
        assert [counts.get(k, 0) for k in (
            "flash_attention_forward", "flash_attention_backward_dq",
            "flash_attention_backward_dkv")] == [2, 2, 2], counts
    dense, _, _, _ = _dy_encoder_run(None, lazy, 3, _momentum)
    np.testing.assert_allclose(losses, dense, rtol=1e-4)
    _, _, per_step, _ = _dy_encoder_run(None, lazy, 2, _momentum,
                                        attention="flash", lengths=lengths)
    assert all(c.get("flash_attention_forward") == 2 for c in per_step)


@pytest.mark.parametrize("attention", ["dense", "flash"])
def test_dygraph_twin_card_against_cpu(cuda, attention):
    """The narrow encoder trained 3 steps lazily on the card (an eager
    flush, a capture, a replay) and eagerly on the CPU from the same
    weights: losses within 1e-4 relative, parameters within 1e-4 of their
    scale (float32, TF32 off)."""
    lengths = np.array([32, 17, 32, 5], dtype="int32") \
        if attention == "flash" else None
    lc, pc, _, c = _dy_encoder_run(None, True, 3, _momentum,
                                   attention=attention, lengths=lengths)
    lh, ph, _, _ = _dy_encoder_run(fluid.CPUPlace(), False, 3, _momentum,
                                   attention=attention, lengths=lengths)
    assert c["lazy.captures"] == 1
    np.testing.assert_allclose(lc, lh, rtol=1e-4)
    for a, b in zip(pc, ph):
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=1e-4 * max(np.abs(b).max(), 1e-3))


# -- the training recipe on the card (slice 13) ----------------------------------

def _recipe_mlp(make_opt, w1_lr=1.0, seed=1):
    """An MLP (16 -> 64 relu -> 1, mean squared error) under
    ``make_opt()``'s optimizer; returns (main, startup, loss, lr var or
    None)."""
    main, startup = fluid.Program(), fluid.Program()
    startup.random_seed = seed
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.data(name="x", shape=[32, 16], dtype="float32")
        y = fluid.data(name="y", shape=[32, 1], dtype="float32")
        h = fluid.layers.fc(x, 64, act="relu", param_attr=fluid.ParamAttr(
            learning_rate=w1_lr))
        loss = fluid.layers.mean(fluid.layers.square(
            fluid.layers.fc(h, 1) - y))
        opt = make_opt()
        opt.minimize(loss)
    lr = opt._learning_rate
    return main, startup, loss, lr if isinstance(lr, fluid.Variable) \
        else None


def _recipe_feeds(n, seed=4):
    rng = np.random.RandomState(seed)
    w = rng.randn(16, 1).astype("float32")
    out = []
    for _ in range(n):
        x = rng.randn(32, 16).astype("float32")
        out.append({"x": x, "y": x @ w})
    return out


def _warm_poly_adam():
    L = fluid.layers
    lr = L.linear_lr_warmup(
        L.polynomial_decay(0.01, decay_steps=6, end_learning_rate=0.0,
                           power=1.0), warmup_steps=2, start_lr=0.0,
        end_lr=0.01)
    return fluid.optimizer.Adam(
        lr, grad_clip=fluid.clip.GradientClipByGlobalNorm(1.0))


def _card_and_cpu(build, feeds):
    """Train ``build()``'s program through CPUPlace() and on the card from
    the CPU startup's state; (losses, rates, state, launches, counters)
    of each side."""
    init, out = None, {}
    for side, place in (("cpu", fluid.CPUPlace()),
                        ("card", fluid.CUDAPlace(0))):
        main, startup, loss, lr = build()
        exe = fluid.Executor(place)
        scope = fluid.Scope()
        if init is None:
            exe.run(startup, scope=scope)
            init = _persistables(main, scope)
        else:
            fluid.io.scope_from_numpy(scope, init, place)
        support.reset_launch_counts()
        ce.reset_counters()
        fetch = [loss] + ([lr] if lr is not None else [])
        res = [exe.run(main, feed=f, fetch_list=fetch, scope=scope)
               for f in feeds]
        out[side] = ([float(np.asarray(r[0]).reshape(-1)[0]) for r in res],
                     [float(np.asarray(r[-1]).reshape(-1)[0]) for r in res],
                     _persistables(main, scope), support.launch_counts(),
                     ce.counters(), main)
    return out


def test_a_scheduled_rate_advances_across_replays(cuda, monkeypatch):
    """One capture, then replays: each replay advances the step counters
    (state buffers at fixed addresses) and fetches the schedule's next
    rate, the CPU run's; the counters land back in the scope."""
    monkeypatch.setenv("PADDLE_TPU_FUSED_OPTIMIZER", "1")
    out = _card_and_cpu(lambda: _recipe_mlp(_warm_poly_adam), _recipe_feeds(8))
    cpu, card = out["cpu"], out["card"]
    assert card[4]["executor.jit_traces"] == 1
    # warm-up to 0.01 over 2 steps, then the linear decay to 0 at step 6
    want = [0.005 * s if s < 2 else 0.01 * (1 - min(s, 6) / 6)
            for s in range(1, 9)]
    np.testing.assert_allclose(card[1], want, rtol=1e-6, atol=1e-12)
    # the card may fuse a scale's multiply-add: an ulp or so
    np.testing.assert_allclose(card[1], cpu[1], rtol=1e-6, atol=0)
    np.testing.assert_allclose(card[0], cpu[0], rtol=1e-4)
    counters = [n for n in card[2] if n.startswith("@LR_DECAY_COUNTER@")]
    assert len(counters) == 2
    assert all(int(card[2][n].reshape(-1)[0]) == 8 for n in counters)


def test_k4_reads_a_rate_computed_in_the_graph(cuda, monkeypatch):
    """K4 (the flat fused Adam) reads the schedule's rate from device
    memory: every replay's update is the CPU's per-parameter update at
    that step's rate."""
    monkeypatch.setenv("PADDLE_TPU_FUSED_OPTIMIZER", "1")
    out = _card_and_cpu(lambda: _recipe_mlp(_warm_poly_adam), _recipe_feeds(6))
    cpu, card = out["cpu"], out["card"]
    assert card[3]["fused_optimizer_update"] == 6
    assert [op.type for op in card[5].global_block().ops].count(
        "fused_optimizer") == 1
    for n, want in cpu[2].items():
        if n in card[2] and want.dtype == np.float32 and \
                not n.startswith("fused_opt_"):
            scale = max(float(np.abs(want).max()), 1e-3)
            np.testing.assert_allclose(card[2][n], want, rtol=0,
                                       atol=1e-4 * scale, err_msg=n)


def test_per_parameter_rate_k4_groups(cuda, monkeypatch):
    """A parameter at twice the rate gets its own rate var: K4 updates the
    other three in one group (one launch a step) and the fourth stays a
    per-parameter adam op, as the JAX pass groups them."""
    monkeypatch.setenv("PADDLE_TPU_FUSED_OPTIMIZER", "1")
    out = _card_and_cpu(lambda: _recipe_mlp(
        lambda: fluid.optimizer.Adam(0.01), w1_lr=2.0), _recipe_feeds(4))
    cpu, card = out["cpu"], out["card"]
    types = [op.type for op in card[5].global_block().ops]
    assert types.count("fused_optimizer") == 1 and types.count("adam") == 1
    assert card[3]["fused_optimizer_update"] == 4
    np.testing.assert_allclose(card[0], cpu[0], rtol=1e-4)


def test_recompute_launches_on_a_small_causal_program(cuda, monkeypatch):
    """The narrow gpt under RecomputeOptimizer: K1 runs in the forward,
    again in the recomputed forward and again in each flash grad op (its
    auto-VJP re-runs the forward), so 6 a step with 2 layers; K2/K3 2 a
    step, K4 1; the losses are the run without recompute's (the first
    within 1e-6; the card's embedding grad sums by atomics in another
    order each run, so the later ones within 1e-5)."""
    monkeypatch.setenv("PADDLE_TPU_FUSED_OPTIMIZER", "1")
    feed = gpt.random_batch(np.random.RandomState(0), TWIN["batch"],
                            TWIN["seq_len"], TWIN["vocab"])
    runs = {}
    for rc in (False, True):
        main, startup, loss, _ = gpt.build_gpt_long(
            **TWIN, seed=1, use_bf16=False, recompute=rc)
        exe = fluid.Executor()
        scope = fluid.Scope()
        exe.run(startup, scope=scope)
        support.reset_launch_counts()
        runs[rc] = [float(np.asarray(exe.run(
            main, feed=feed, fetch_list=[loss], scope=scope)[0]).reshape(
                -1)[0]) for _ in range(3)]
        counts = support.launch_counts()
        want = {"flash_attention_forward": (6 if rc else 4) * 3,
                "flash_attention_backward_dq": 2 * 3,
                "flash_attention_backward_dkv": 2 * 3,
                "fused_optimizer_update": 3}
        assert {k: counts.get(k, 0) for k in want} == want, (rc, counts)
    np.testing.assert_allclose(runs[True][0], runs[False][0], rtol=1e-6)
    np.testing.assert_allclose(runs[True], runs[False], rtol=1e-5)


# -- slice 14: the recurrent family and control flow -------------------------

def _slice14_cases():
    g = np.random.RandomState(14)
    f = lambda *s: g.randn(*s).astype("float32")  # noqa: E731
    lstm_w = f(2 * (4 * 24 + 6 * 24 + 24) + 2 * (12 * 24 + 6 * 24 + 24))
    return {
        "squeeze2": ({"X": f(3, 1, 4, 1)}, {"axes": [1, 3]}, "Out"),
        "unsqueeze2": ({"X": f(3, 4)}, {"axes": [0, 2]}, "Out"),
        "stack": ({"X": [f(3, 4), f(3, 4)]}, {"axis": 1}, "Y"),
        "top_k": ({"X": f(5, 40)}, {"k": 6}, "Out"),
        "one_hot": ({"X": g.randint(-1, 8, (6, 1))}, {"depth": 7}, None),
        "gather_tree": ({"Ids": g.randint(0, 50, (6, 3, 4)),
                         "Parents": g.randint(0, 4, (6, 3, 4))}, {}, None),
        "logical_or": ({"X": g.rand(4, 5) > 0.5, "Y": g.rand(4, 5) > 0.5},
                       {}, None),
        "logical_not": ({"X": g.rand(4, 5) > 0.5}, {}, None),
        "lstm_unit": ({"X": f(5, 24), "C_prev": f(5, 6)},
                      {"forget_bias": 1.0}, "H"),
        "gru_unit": ({"Input": f(5, 18), "HiddenPrev": f(5, 6),
                      "Weight": f(6, 18), "Bias": f(1, 18)},
                     {"origin_mode": False}, "Hidden"),
        "cudnn_lstm": ({"Input": f(5, 3, 4), "InitH": f(4, 3, 6),
                        "InitC": f(4, 3, 6), "W": lstm_w * 0.3},
                       {"hidden_size": 6, "num_layers": 2,
                        "is_bidirec": True, "input_size": 4}, "Out"),
    }


def _op_on(device, op_type, ins, attrs, grad_of):
    from paddle_tpu_torch.core.registry import (DEVICE_ATTR, GENERATOR_ATTR,
                                                OpInfoMap)

    def put(v):
        return [put(x) for x in v] if isinstance(v, list) else \
            torch.from_numpy(np.array(v)).to(device)

    ops = OpInfoMap.instance()
    info = ops.get(op_type)
    a = dict(info.attrs, **attrs)
    a[DEVICE_ATTR] = device
    if info.needs_rng:
        a[GENERATOR_ATTR] = torch.Generator(device=device).manual_seed(0)
    t_ins = {k: put(v) for k, v in ins.items()}
    outs = info.fn(t_ins, a)
    res = {k: [x.cpu() for x in v] if isinstance(v, list) else v.cpu()
           for k, v in outs.items() if v is not None}
    if grad_of is not None:
        g_ins = dict(t_ins)
        g_ins[grad_of + "@GRAD"] = torch.ones_like(outs[grad_of]) * 0.5
        gouts = ops.get(op_type + "_grad").fn(g_ins, a)
        res.update({"grad:" + k: v.cpu() for k, v in gouts.items()
                    if isinstance(v, torch.Tensor)})
    return res


@pytest.mark.parametrize("op_type", sorted(_slice14_cases()))
def test_slice14_op_on_the_card_gives_its_cpu_result(cuda, op_type):
    ins, attrs, grad_of = _slice14_cases()[op_type]
    want = _op_on(torch.device("cpu"), op_type, ins, attrs, grad_of)
    got = _op_on(cuda, op_type, ins, attrs, grad_of)
    assert sorted(got) == sorted(want)
    for k in want:
        gs = got[k] if isinstance(got[k], list) else [got[k]]
        ws = want[k] if isinstance(want[k], list) else [want[k]]
        for a, b in zip(gs, ws):
            if b.is_floating_point():
                scale = max(float(b.abs().max()), 1.0) if b.numel() else 1.0
                torch.testing.assert_close(a, b, rtol=0, atol=1e-5 * scale)
            else:
                assert torch.equal(a, b), k


def test_top_k_ties_on_the_card(cuda):
    """Rows of 77,090 candidates (beam 10 x vocab 7709) drawn from four
    values: the card's indices are the stable descending order's, lower
    index first, as on the CPU."""
    from paddle_tpu_torch.core.registry import DEVICE_ATTR, OpInfoMap

    g = np.random.RandomState(3)
    x = g.choice([-1e9, -3.0, -2.5, 0.0], size=(16, 77090)).astype("float32")
    info = OpInfoMap.instance().get("top_k")
    out = info.fn({"X": torch.from_numpy(x).to(cuda)},
                  {"k": 10, DEVICE_ATTR: cuda})
    want = np.argsort(-x, axis=1, kind="stable")[:, :10]
    np.testing.assert_array_equal(out["Indices"].cpu().numpy(), want)


def _while_rnn_program(trips=4, B=3, D=5):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.data(name="x", shape=[B, D], dtype="float32")
        w = fluid.layers.create_parameter([D, D], "float32", name="w_rnn")
        h = fluid.layers.fill_constant([B, D], "float32", 0.0)
        i = fluid.layers.fill_constant([1], "int64", 0)
        n = fluid.layers.fill_constant([1], "int64", trips)
        cond = fluid.layers.less_than(i, n)
        with fluid.layers.While(cond).block():
            nh = fluid.layers.tanh(fluid.layers.elementwise_add(
                fluid.layers.matmul(h, w), x))
            fluid.layers.assign(nh, h)
            fluid.layers.increment(i, value=1, in_place=True)
            fluid.layers.less_than(i, n, cond=cond)
        loss = fluid.layers.reduce_mean(h)
        fluid.optimizer.SGDOptimizer(0.5).minimize(loss)
    return main, startup, loss, None


def test_while_on_the_card_takes_the_interpreter_and_trains_as_the_cpu(cuda):
    feeds = [{"x": np.random.RandomState(s).randn(3, 5).astype("float32")}
             for s in range(3)]
    out = _card_and_cpu(_while_rnn_program, feeds)
    cpu, card = out["cpu"], out["card"]
    assert card[4]["executor.compile_fallbacks"] == 1
    assert card[4]["executor.jit_traces"] == 0
    np.testing.assert_allclose(card[0], cpu[0], rtol=1e-5, atol=1e-6)
    w_card, w_cpu = card[2]["w_rnn"], cpu[2]["w_rnn"]
    np.testing.assert_allclose(w_card, w_cpu, rtol=0,
                               atol=1e-5 * max(1.0, np.abs(w_cpu).max()))


def _decode_program(B=8, T=7, H=16, V=29, K=4, steps=9):
    from paddle_tpu_torch.layers.rnn import (BeamSearchDecoder, LSTMCell,
                                             RNNCell, dynamic_decode, rnn)

    L = fluid.layers

    class Stacked(RNNCell):
        def __init__(self, prefix):
            self.cells = [LSTMCell(H, param_attr=fluid.ParamAttr(
                name="%s_l%d_w" % (prefix, i)), bias_attr=fluid.ParamAttr(
                name="%s_l%d_b" % (prefix, i))) for i in range(2)]

        def call(self, inputs, states):
            new = []
            for i, cell in enumerate(self.cells):
                inputs, (h, c) = cell.call(inputs, states[2 * i:2 * i + 2])
                new += [h, c]
            return inputs, new

        @property
        def state_shape(self):
            return [[H]] * 4

    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        src = fluid.data(name="src", shape=[B, T], dtype="int64")
        src_len = fluid.data(name="src_len", shape=[B], dtype="int64")
        emb = L.embedding(src, size=[V, H], param_attr=fluid.ParamAttr(
            name="source_embedding"))
        _, enc_final = rnn(Stacked("enc"), emb, sequence_length=src_len)
        dec = BeamSearchDecoder(
            Stacked("dec"), start_token=0, end_token=1, beam_size=K,
            embedding_fn=lambda ids: L.embedding(
                ids, size=[V, H],
                param_attr=fluid.ParamAttr(name="target_embedding")),
            output_fn=lambda x: L.fc(x, size=V, param_attr=fluid.ParamAttr(
                name="output_w"), bias_attr=False))
        outs, states = dynamic_decode(dec, inits=enc_final,
                                      max_step_num=steps)
    return main, startup, [outs, states.log_probs]


def test_beam_decode_at_batch_8_on_the_card_gives_the_cpu_ids(cuda):
    main, startup, fetch = _decode_program()
    g = np.random.RandomState(8)
    feed = {"src": g.randint(0, 29, (8, 7)).astype("int64"),
            "src_len": g.randint(2, 8, 8).astype("int64")}
    res, init = {}, None
    for side, place in (("cpu", fluid.CPUPlace()), ("card", fluid.CUDAPlace(0))):
        exe = fluid.Executor(place)
        scope = fluid.Scope()
        if init is None:
            exe.run(startup, scope=scope)
            init = _persistables(main, scope)
        else:
            fluid.io.scope_from_numpy(scope, init, place)
        res[side] = [exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
                     for _ in range(3)]  # eager, capture, replay
    for card in res["card"]:
        np.testing.assert_array_equal(card[0], res["cpu"][0][0])
        np.testing.assert_allclose(card[1], res["cpu"][0][1], rtol=0,
                                   atol=1e-5 * max(1.0, float(np.abs(
                                       res["cpu"][0][1]).max())))


# -- slice 15: LoD, sparse embeddings and the LoD lowering --------------

_LENS15 = [3, 1, 7, 2, 5]


def _slice15_cases():
    g = np.random.RandomState(15)
    f = lambda *s: g.randn(*s).astype("float32")  # noqa: E731
    lod = ((tuple(int(v) for v in np.cumsum([0] + _LENS15)),),)
    rows = sum(_LENS15)
    ties = g.randint(-2, 3, (rows, 4)).astype("float32")
    n = len(_LENS15)
    lens = np.array(_LENS15, "int64")
    # case -> (op, inputs, attrs, the output whose grad is pulled back)
    return {
        "sequence_pool_max_ties": (
            "sequence_pool", {"X": ties},
            {"pooltype": "MAX", "_lod_X": lod}, "Out"),
        "sequence_pool_sqrt": (
            "sequence_pool", {"X": f(rows, 4)},
            {"pooltype": "SQRT", "_lod_X": lod}, "Out"),
        "sequence_softmax": (
            "sequence_softmax", {"X": f(rows, 1)}, {"_lod_X": lod}, "Out"),
        "sequence_expand_as": (
            "sequence_expand_as", {"X": f(n, 4), "Y": f(rows, 1)},
            {"_lod_Y": lod}, "Out"),
        "sequence_pad": (
            "sequence_pad", {"X": f(rows, 4), "PadValue": f(1)},
            {"_lod_X": lod, "padded_length": 8}, "Out"),
        "sequence_conv": (
            "sequence_conv",
            {"X": f(rows, 4), "Filter": f(12, 5), "PaddingData": f(2, 4)},
            {"_lod_X": lod, "paddingTrainable": True}, "Out"),
        "lstm": (
            "lstm", {"Input": f(rows, 16), "Weight": f(4, 16) * 0.5,
                     "Bias": f(1, 28) * 0.5},
            {"_lod_Input": lod, "is_reverse": True}, "Hidden"),
        "gru": (
            "gru", {"Input": f(rows, 12), "Weight": f(4, 12) * 0.5,
                    "Bias": f(1, 12)},
            {"_lod_Input": lod, "origin_mode": True}, "Hidden"),
        "sequence_pool_padded": (
            "sequence_pool_padded", {"X": f(n, 8, 4), "Length": lens},
            {"pooltype": "MAX"}, "Out"),
        "sequence_conv_padded": (
            "sequence_conv_padded",
            {"X": f(n, 8, 4), "Filter": f(12, 5), "Length": lens}, {},
            "Out"),
    }


@pytest.mark.parametrize("op_type", sorted(_slice15_cases()))
def test_slice15_lod_op_on_the_card_gives_its_cpu_result(cuda, op_type):
    """A LoD op and its grad op (whose ``_lod_<slot>`` attrs are its
    forward's) on the card against the CPU, within 1e-5 of scale."""
    name, ins, attrs, grad_of = _slice15_cases()[op_type]
    want = _op_on(torch.device("cpu"), name, ins, attrs, grad_of)
    got = _op_on(cuda, name, ins, attrs, grad_of)
    assert sorted(got) == sorted(want) and len(want) >= 2
    for k in want:
        scale = max(float(want[k].abs().max()), 1.0)
        torch.testing.assert_close(got[k], want[k], rtol=0,
                                   atol=1e-5 * scale)


def _sparse_sgd_program():
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        ids = fluid.data(name="ids", shape=[-1, 1], dtype="int64",
                         lod_level=1)
        lab = fluid.data(name="lab", shape=[-1, 1], dtype="int64")
        emb = fluid.layers.embedding(ids, size=[50, 8], is_sparse=True,
                                     param_attr=fluid.ParamAttr(name="t_emb"))
        pooled = fluid.layers.sequence_pool(emb, "sum")
        pred = fluid.layers.fc(pooled, size=3, act="softmax")
        loss = fluid.layers.mean(fluid.layers.cross_entropy(pred, lab))
        fluid.optimizer.SGD(learning_rate=0.5).minimize(loss)
    return main, startup, loss


def test_selected_rows_grad_and_its_sgd_on_the_card(cuda):
    """The sparse grad's rows are the ids on both sides, its values and
    the updated table within 1e-5 of scale (duplicate rows sum by
    atomics on the card)."""
    g = np.random.RandomState(5)
    lens = [4, 6, 1, 9]
    feeds = [{"ids": fluid.create_lod_tensor(
        g.randint(0, 7, (sum(lens), 1)).astype("int64"), [lens]),
        "lab": g.randint(0, 3, (4, 1)).astype("int64")} for _ in range(3)]
    res, init = {}, None
    for side, place in (("cpu", fluid.CPUPlace()),
                        ("card", fluid.CUDAPlace(0))):
        main, startup, loss = _sparse_sgd_program()
        exe, scope = fluid.Executor(place), fluid.Scope()
        if init is None:
            exe.run(startup, scope=scope)
            init = _persistables(main, scope)
        else:
            fluid.io.scope_from_numpy(scope, init, place)
        out = []
        for feed in feeds:
            exe.run(main, feed=feed, fetch_list=[loss, "t_emb@GRAD"],
                    scope=scope)
            sr = scope.find_var("t_emb@GRAD").raw()
            assert sr.get_tensor().array.device.type == place.device().type
            out.append((list(sr.rows()), sr.get_tensor().numpy(),
                        sr.to_dense().cpu().numpy()))
        res[side] = (out, scope.find_var("t_emb").get_tensor().numpy())
    for (rc, vc, dc), (rg, vg, dg) in zip(res["cpu"][0], res["card"][0]):
        assert rg == rc
        np.testing.assert_allclose(vg, vc, rtol=0, atol=1e-5 * max(
            1.0, np.abs(vc).max()))
        np.testing.assert_allclose(dg, dc, rtol=0, atol=1e-5 * max(
            1.0, np.abs(dc).max()))
    np.testing.assert_allclose(res["card"][1], res["cpu"][1], rtol=0,
                               atol=1e-5 * max(1.0, np.abs(
                                   res["cpu"][1]).max()))


def _lowered_conv_program():
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        ids = fluid.data(name="ids", shape=[-1, 1], dtype="int64",
                         lod_level=1)
        lab = fluid.data(name="lab", shape=[-1, 1], dtype="int64")
        emb = fluid.layers.embedding(ids, size=[40, 8])
        pools = [fluid.nets.sequence_conv_pool(emb, num_filters=6,
                                               filter_size=k, act="tanh",
                                               pool_type="sqrt")
                 for k in (3, 4)]
        pred = fluid.layers.fc(pools, size=2, act="softmax")
        loss = fluid.layers.mean(fluid.layers.cross_entropy(pred, lab))
        fluid.optimizer.AdagradOptimizer(0.05).minimize(loss)
    return main, startup, loss


def test_a_lowered_lod_program_is_captured_on_the_card(cuda):
    """convolution_net's shape with a dense embedding grad: one lowered
    clone, one capture for the batches of one bucket (their lengths
    differ: a feed, never a constant of the graph), zero declines, and the
    card interpreter's losses within 1e-5 relative."""
    g = np.random.RandomState(6)
    feeds = []
    for _ in range(4):
        lens = g.randint(9, 17, 6).tolist()  # all in the 16 bucket
        feeds.append({"ids": fluid.create_lod_tensor(
            g.randint(0, 40, (sum(lens), 1)).astype("int64"), [lens]),
            "lab": g.randint(0, 2, (6, 1)).astype("int64")})
    main, startup, loss = _lowered_conv_program()
    exe = fluid.Executor()
    scope, scope2 = fluid.Scope(), fluid.Scope()
    exe.run(startup, scope=scope)
    init = _persistables(main, scope)
    fluid.io.scope_from_numpy(scope2, init, fluid.CUDAPlace(0))
    ce.reset_counters()
    lowered = [float(np.asarray(exe.run(main, feed=f, fetch_list=[loss],
                                        scope=scope)[0]).reshape(-1)[0])
               for f in feeds]
    c = ce.counters()
    assert (c["lod_lowering.lowered"], c["lod_lowering.declines"],
            c["executor.compile_fallbacks"], c["executor.jit_traces"]) == \
        (1, 0, 0, 1), (c, ce.declines())
    interp = [float(np.asarray(exe._core.run_program(
        main, scope2, f, [loss])[0]).reshape(-1)[0]) for f in feeds]
    np.testing.assert_allclose(lowered, interp, rtol=1e-5, atol=0)


# -- slice 16: save, load and the book's ops on the card ---------------------

def _slice16_cases():
    g = np.random.RandomState(16)

    def f(*shape):
        return g.randn(*shape).astype("float32")

    lab = g.randint(0, 5, (3, 9)).astype("int64")
    return {
        "linear_chain_crf": (
            "linear_chain_crf", {"Emission": f(3, 9, 5),
                                 "Transition": f(7, 5) * 0.5, "Label": lab},
            {}, "LogLikelihood"),
        "crf_decoding": (
            "crf_decoding", {"Emission": f(3, 9, 5), "Transition": f(7, 5)},
            {}, None),
        "crf_decoding_label": (
            "crf_decoding", {"Emission": f(3, 9, 5), "Transition": f(7, 5),
                             "Label": lab}, {}, None),
        "cos_sim": ("cos_sim", {"X": f(6, 4), "Y": f(6, 4)}, {}, "Out"),
        "square_error_cost": ("square_error_cost",
                              {"X": f(6, 4), "Y": f(6, 4)}, {}, "Out"),
        "depthwise_conv2d": (
            "depthwise_conv2d", {"Input": f(2, 7, 6, 4),
                                 "Filter": f(8, 1, 3, 3)},
            {"data_format": "NHWC", "paddings": [1, 1], "groups": 4},
            "Output"),
    }


@pytest.mark.parametrize("case", sorted(_slice16_cases()))
def test_slice16_op_on_the_card_gives_its_cpu_result(cuda, case):
    """The CRF ops (the Viterbi path exactly), cos_sim, square_error_cost
    and depthwise_conv2d with their grads, card against CPU, within 1e-5
    of scale."""
    name, ins, attrs, grad_of = _slice16_cases()[case]
    want = _op_on(torch.device("cpu"), name, ins, attrs, grad_of)
    got = _op_on(cuda, name, ins, attrs, grad_of)
    assert sorted(got) == sorted(want)
    for k in want:
        if not want[k].is_floating_point():
            assert torch.equal(got[k], want[k]), k
            continue
        scale = max(float(want[k].abs().max()), 1.0)
        torch.testing.assert_close(got[k], want[k], rtol=0,
                                   atol=1e-5 * scale)


@pytest.mark.parametrize("params", [None, "__params__"])
def test_a_protobuf_model_loads_onto_the_card(cuda, tmp_path, params):
    """Saved on the CPU in the reference's format, loaded by a predictor
    on the card: every parameter lands on the card, the answers are the
    CPU's within 1e-5 relative."""
    from paddle_tpu_torch.inference import (AnalysisConfig,
                                            create_paddle_predictor)

    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.data(name="x", shape=[-1, 6], dtype="float32")
        pred = fluid.layers.fc(fluid.layers.fc(x, 16, act="relu"), 3,
                               act="softmax")
    xv = np.random.RandomState(2).rand(5, 6).astype("float32")
    exe = fluid.Executor(fluid.CPUPlace())
    with fluid.scope_guard(fluid.Scope()):
        exe.run(startup)
        (want,) = exe.run(main, feed={"x": xv}, fetch_list=[pred])
        fluid.io.save_inference_model(str(tmp_path), ["x"], [pred], exe,
                                      main_program=main,
                                      model_filename="__model__",
                                      params_filename=params)
    cfg = AnalysisConfig(str(tmp_path))
    cfg.set_prog_file("__model__")
    cfg.set_params_file(params)
    p = create_paddle_predictor(cfg)
    assert p.device.type == "cuda"
    for n in p._scope.local_var_names():
        assert p._scope.find_var(n).get_tensor().array.is_cuda, n
    (got,) = p.run({"x": xv})
    np.testing.assert_allclose(got.data, want, rtol=1e-5, atol=0)


def test_a_checkpoint_loads_onto_the_card(cuda, tmp_path):
    """A checkpoint saved on the CPU (an Adam program under a schedule:
    its step counter int64) loads onto the card's executor: every
    persistable on the card, bitwise the saved values, and the next step's
    loss the CPU's within 1e-5 relative."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.data(name="x", shape=[4, 3], dtype="float32")
        loss = fluid.layers.mean(fluid.layers.fc(x, 5))
        lr = fluid.layers.exponential_decay(0.1, decay_steps=2,
                                            decay_rate=0.5)
        fluid.optimizer.AdamOptimizer(lr).minimize(loss)
    xv = np.random.RandomState(3).rand(4, 3).astype("float32")
    cpu = fluid.Executor(fluid.CPUPlace())
    with fluid.scope_guard(fluid.Scope()):
        cpu.run(startup)
        cpu.run(main, feed={"x": xv}, fetch_list=[loss])
        fluid.checkpoint.save_checkpoint(cpu, str(tmp_path), 1, main)
        saved = _persistables(main, fluid.global_scope())
        (want,) = cpu.run(main, feed={"x": xv}, fetch_list=[loss])
    exe = fluid.Executor()
    with fluid.scope_guard(fluid.Scope()):
        assert fluid.checkpoint.load_checkpoint(exe, str(tmp_path),
                                                main) == 1
        scope = fluid.global_scope()
        for n, v in saved.items():
            t = scope.find_var(n).get_tensor().array
            assert t.is_cuda, n
            np.testing.assert_array_equal(t.cpu().numpy(), v, err_msg=n)
        (got,) = exe.run(main, feed={"x": xv}, fetch_list=[loss])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)


def test_load_without_an_executor_keeps_the_card(cuda, tmp_path):
    """``fluid.load`` and ``load_persistables`` given no executor after a
    startup on the card: every parameter stays on the card, bitwise the
    saved values; a var the scope lacks lands on the card too."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.data(name="x", shape=[4, 3], dtype="float32")
        loss = fluid.layers.mean(fluid.layers.fc(x, 5))
        fluid.optimizer.AdamOptimizer(0.1).minimize(loss)
    path = str(tmp_path / "model")
    with fluid.scope_guard(fluid.Scope()):
        fluid.Executor().run(startup)
        saved = _persistables(main, fluid.global_scope())
        fluid.save(main, path)
        fluid.io.save_persistables(None, str(tmp_path / "vars"), main)
    for load in (lambda: fluid.load(main, path),
                 lambda: fluid.io.load_persistables(
                     None, str(tmp_path / "vars"), main)):
        with fluid.scope_guard(fluid.Scope()):
            fluid.Executor().run(startup)
            load()
            scope = fluid.global_scope()
            for n, v in saved.items():
                t = scope.find_var(n).get_tensor().array
                assert t.is_cuda, n
                np.testing.assert_array_equal(t.cpu().numpy(), v,
                                              err_msg=n)
    with fluid.scope_guard(fluid.Scope()):
        fluid.load(main, path)
        for n in saved:
            assert fluid.global_scope().find_var(
                n).get_tensor().array.is_cuda, n


# -- slice 17: DynamicRNN and the LoD beam search --------------------------


def _rnn_search_twin(generate=False):
    from paddle_tpu_torch.models import rnn_search

    cfg = rnn_search.NARROW
    if generate:
        return rnn_search.generate_program(fluid, cfg), cfg, rnn_search
    return rnn_search.train_program(fluid, cfg), cfg, rnn_search


def test_slice17_dynamic_rnn_step_keeps_every_tensor_on_the_card(
        cuda, monkeypatch):
    """Every tensor a narrow RNNsearch step makes lies on the card: each
    LoDTensor built while it runs, the scope's vars and the while's
    snapshots after it; three steps give the CPU's losses."""
    from paddle_tpu_torch.core.tensor import LoDTensor, LoDTensorArray

    (main, startup, loss), cfg, rs = _rnn_search_twin()
    feeds = [rs.train_batch(fluid, np.random.RandomState(70 + i), cfg)
             for i in range(3)]
    cpu = fluid.Executor(fluid.CPUPlace())
    cscope = fluid.Scope()
    cpu.run(startup, scope=cscope)
    init = _persistables(main, cscope)
    want = [float(np.ravel(cpu.run(main, feed=f, fetch_list=[loss],
                                   scope=cscope)[0])[0]) for f in feeds]
    made = set()
    init_fn = LoDTensor.__init__

    def spy(self, array=None, lod=None):
        if isinstance(array, torch.Tensor):
            made.add(array.device.type)
        init_fn(self, array, lod)

    exe = fluid.Executor()
    scope = fluid.Scope()
    fluid.io.scope_from_numpy(scope, init, fluid.CUDAPlace(0))
    monkeypatch.setattr(LoDTensor, "__init__", spy)
    got = [float(np.ravel(exe.run(main, feed=f, fetch_list=[loss],
                                  scope=scope)[0])[0]) for f in feeds]
    monkeypatch.undo()
    assert made == {"cuda"}, made

    def devices(h):
        if isinstance(h, LoDTensor):
            return {h.array.device.type}
        if isinstance(h, LoDTensorArray):
            return set().union(*[devices(i) for i in h if i is not None])
        if isinstance(h, list):  # a while's snapshots
            return set().union(*[devices(v) for snap in h
                                 for v in snap.values()])
        return set()

    seen = set()
    for name in scope.local_var_names():
        seen |= devices(scope.find_var(name).raw())
    assert seen == {"cuda"}, seen
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_slice17_beam_search_ops_on_the_card_give_their_cpu_result(cuda):
    """A step under a two-level LoD (one row ended), then the backtrace
    of three steps, on card tensors and on CPU tensors."""
    from paddle_tpu_torch.core.tensor import LoDTensor, LoDTensorArray

    lod = [[0, 1, 2], [0, 2, 4]]
    ins = {"pre_ids": np.array([[5], [6], [0], [8]], "int64"),
           "pre_scores": np.array([[-1.0], [-2.0], [-0.75], [-4.0]],
                                  "float32"),
           "ids": np.array([[11, 12], [13, 14], [15, 16], [17, 18]],
                           "int64"),
           "scores": np.array([[-1.5, -2.5], [-1.0, -3.0], [-0.5, -0.5],
                               [-4.0, -4.5]], "float32")}
    out = {}
    for dev in ("cpu", "cuda"):
        prog = fluid.Program()
        blk = prog.global_block()
        for n in list(ins) + ["sel_ids", "sel_scores", "sent_ids",
                              "sent_scores"]:
            blk.create_var(name=n, persistable=True)
        blk.create_var(name="ids_arr", persistable=True,
                       type="lod_tensor_array")
        blk.create_var(name="scores_arr", persistable=True,
                       type="lod_tensor_array")
        blk.append_op("beam_search", {k: [k] for k in ins},
                      {"selected_ids": ["sel_ids"],
                       "selected_scores": ["sel_scores"]},
                      {"level": 0, "beam_size": 2, "end_id": 0},
                      infer_shape=False)
        blk.append_op("beam_search_decode",
                      {"Ids": ["ids_arr"], "Scores": ["scores_arr"]},
                      {"SentenceIds": ["sent_ids"],
                       "SentenceScores": ["sent_scores"]},
                      {"beam_size": 2, "end_id": 1}, infer_shape=False)
        scope = fluid.Scope()
        for k, v in ins.items():
            scope.var(k).set(LoDTensor(torch.from_numpy(v).to(dev),
                                       lod if k in ("ids", "scores")
                                       else None))
        for name, dt in (("ids_arr", torch.int64),
                         ("scores_arr", torch.float32)):
            arr = LoDTensorArray()
            for step_lod, data in (([[0, 1, 2], [0, 1, 2]], [0, 0]),
                                   ([[0, 1, 2], [0, 2, 4]], [2, 3, 4, 5]),
                                   ([[0, 2, 4], [0, 1, 2, 3, 4]],
                                    [1, 1, 3, 5])):
                arr.append(LoDTensor(torch.tensor(data, dtype=dt).reshape(
                    -1, 1).to(dev), step_lod))
            scope.var(name).set(arr)
        exe = fluid.Executor(fluid.CPUPlace() if dev == "cpu"
                             else fluid.CUDAPlace(0))
        exe._core.run_program(prog, scope)
        res = {}
        for n in ("sel_ids", "sel_scores", "sent_ids", "sent_scores"):
            h = scope.find_var(n).get_tensor()
            assert h.array.device.type == dev, n
            res[n] = (h.numpy(), h.lod())
        out[dev] = res
    for n, (v, lod_) in out["cpu"].items():
        np.testing.assert_array_equal(out["cuda"][n][0], v, err_msg=n)
        assert out["cuda"][n][1] == lod_, n


def test_slice17_rnn_search_generation_on_the_card_gives_the_cpus(cuda):
    """The narrow generator at beam 3 (the end id's bias raised by 1.5 so
    beams end), from the same weights on the card and the CPU."""
    (main, startup, ids, scores), cfg, rs = _rnn_search_twin(generate=True)
    cpu = fluid.Executor(fluid.CPUPlace())
    cscope = fluid.Scope()
    cpu.run(startup, scope=cscope)
    init = _persistables(main, cscope)
    init["out_b"] = init["out_b"] + np.float32(1.5) * (
        np.arange(init["out_b"].shape[-1]) == cfg["end"])
    got = {}
    for side, exe, place in (("cpu", cpu, fluid.CPUPlace()),
                             ("card", fluid.Executor(), fluid.CUDAPlace(0))):
        scope = fluid.Scope()
        fluid.io.scope_from_numpy(scope, init, place)
        feed = rs.source_batch(fluid, np.random.RandomState(71), cfg)
        i, s = exe.run(main, feed=feed, fetch_list=[ids, scores],
                       scope=scope, return_numpy=False)
        got[side] = (np.asarray(i), i.lod(), np.asarray(s))
    cpu_ids, cpu_lod, cpu_scores = got["cpu"]
    np.testing.assert_array_equal(got["card"][0], cpu_ids)
    assert got["card"][1] == cpu_lod and len(cpu_lod) == 2
    scale = max(1.0, float(np.abs(cpu_scores).max()))
    assert float(np.abs(got["card"][2] - cpu_scores).max()) <= 1e-5 * scale
    assert (cpu_ids.reshape(-1) == cfg["end"]).any()


def test_slice17_moving_average_swaps_the_captured_buffers(cuda):
    """Three captured SGD steps with an ExponentialMovingAverage: apply()
    writes the averages into the parameters' own buffers (the graph's
    addresses) and a captured evaluation reads them; restore() writes the
    trained values back; both as on the CPU."""
    def build():
        main, startup = fluid.Program(), fluid.Program()
        with fluid.unique_name.guard(), fluid.program_guard(main, startup):
            x = fluid.data(name="x", shape=[8, 3], dtype="float32")
            pred = fluid.layers.fc(x, 2, param_attr=fluid.ParamAttr(
                name="ema_w"), bias_attr=False)
            loss = fluid.layers.mean(fluid.layers.square(pred))
            test = main.clone(for_test=True)
            fluid.optimizer.SGD(0.1).minimize(loss)
            ema = fluid.optimizer.ExponentialMovingAverage(0.5)
            ema.update()
        return main, startup, loss, test, ema

    xs = [np.random.RandomState(72 + i).rand(8, 3).astype("float32")
          for i in range(3)]
    out, init = {}, None
    for side, place in (("cpu", fluid.CPUPlace()),
                        ("card", fluid.CUDAPlace(0))):
        main, startup, loss, test, ema = build()
        exe = fluid.Executor(place)
        scope = fluid.Scope()
        with fluid.scope_guard(scope):
            if init is None:
                exe.run(startup)
                init = _persistables(main, scope)
            else:
                fluid.io.scope_from_numpy(scope, init, place)
            for x in xs:
                exe.run(main, feed={"x": x}, fetch_list=[loss])
            w = scope.find_var("ema_w").get_tensor().array
            ptr, trained = w.data_ptr(), w.cpu().numpy().copy()
            with ema.apply(exe):
                assert scope.find_var("ema_w").get_tensor().array \
                    .data_ptr() == ptr
                evals = [float(np.ravel(exe.run(
                    test, feed={"x": xs[0]}, fetch_list=[loss.name])[0])[0])
                    for _ in range(2)]
                averaged = scope.find_var("ema_w").get_tensor().numpy() \
                    .copy()
            np.testing.assert_array_equal(
                scope.find_var("ema_w").get_tensor().numpy(), trained,
                err_msg="restored on the %s" % side)
        out[side] = (evals, averaged, trained)
    for a, b in zip(out["card"], out["cpu"]):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-7)
    assert np.abs(out["card"][1] - out["card"][2]).max() > 1e-6


# -- slice 18: the serving front ----------------------------------------------

def test_slice18_fc_is_captured_in_a_replay(cuda, tmp_path):
    """The fc ops FcFusePass emits run inside the predictor's captured
    graph: one capture, no fallback, the card interpreter's answer within
    1e-6 relative, and the passes-off predictor's within 1e-5."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.data(name="x", shape=[-1, 3, 16], dtype="float32")
        h = fluid.layers.fc(x, 32, num_flatten_dims=2, act="relu")
        y = fluid.layers.fc(h, 8, num_flatten_dims=2)
    exe = fluid.Executor()
    with fluid.scope_guard(fluid.Scope()):
        exe.run(startup)
        fluid.io.save_inference_model(str(tmp_path), ["x"], [y], exe,
                                      main_program=main)
    pred = create_paddle_predictor(AnalysisConfig(str(tmp_path)))
    assert [op.type for op in pred._program.global_block().ops] == [
        "fc", "fc"]
    cfg = AnalysisConfig(str(tmp_path))
    cfg.switch_ir_optim(False)
    off = create_paddle_predictor(cfg)
    xv = np.random.RandomState(5).randn(4, 3, 16).astype("float32")
    ce.reset_counters()
    outs = [pred.run({"x": xv})[0].data for _ in range(4)]
    c = ce.counters()
    assert c["executor.jit_traces"] == 1
    assert c["executor.compile_fallbacks"] == 0
    (interp,) = pred._exe._core.run_program(pred._program, pred._scope,
                                            {"x": xv}, pred._fetch_vars)
    for o in outs:
        np.testing.assert_allclose(o, interp, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(outs[-1], off.run({"x": xv})[0].data,
                               rtol=1e-5, atol=1e-6)


def test_slice18_folded_conv_runs_k5_bitwise_twice(cuda, tmp_path):
    """A conv+BN folded by ConvBnFusePass on the card: the filter and its
    bn_fold_bias stay on the card, the conv runs K5 (one launch a run)
    and two runs give the same bits; the answer is the passes-off
    predictor's within 1e-4 of scale."""
    import importlib

    resnet = importlib.import_module("paddle_tpu_torch.models.resnet")
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        img = fluid.data(name="img", shape=[-1, 8, 8, 128],
                         dtype="float32")
        y = resnet._conv_bn(img, 128, 3, 1, act="relu", is_test=True,
                            data_format="NHWC")
    rng = np.random.RandomState(6)
    exe = fluid.Executor()
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        exe.run(startup)
        for op in main.global_block().ops:
            if op.type == "batch_norm":
                for slot in ("Mean", "Variance", "Scale", "Bias"):
                    (n,) = op.input(slot)
                    v = rng.uniform(0.5, 1.5, 128).astype("float32")
                    scope.find_var(n).get_tensor().set(
                        torch.from_numpy(v).to(cuda))
        fluid.io.save_inference_model(str(tmp_path), ["img"], [y], exe,
                                      main_program=main)
    fluid.set_flags({"FLAGS_use_pallas_conv": "all"})
    try:
        pred = create_paddle_predictor(AnalysisConfig(str(tmp_path)))
        cfg = AnalysisConfig(str(tmp_path))
        cfg.switch_ir_optim(False)
        off = create_paddle_predictor(cfg)
        types = [op.type for op in pred._program.global_block().ops]
        assert types == ["conv2d", "relu"], types
        conv = pred._program.global_block().ops[0]
        (bias,) = conv.input("Bias")
        assert bias.endswith(".bn_fold_bias")
        for n in (bias, conv.input("Filter")[0]):
            assert pred._scope.find_var(n).get_tensor().array.is_cuda
        xv = rng.randn(4, 8, 8, 128).astype("float32")
        support.reset_launch_counts()
        a = pred._exe._core.run_program(pred._program, pred._scope,
                                        {"img": xv}, pred._fetch_vars)[0]
        b = pred._exe._core.run_program(pred._program, pred._scope,
                                        {"img": xv}, pred._fetch_vars)[0]
        assert support.launch_counts()["conv2d_bn_act"] == 2
        assert a.tobytes() == b.tobytes()
        (want,) = off.run({"img": xv})
        scale = max(float(np.abs(want.data).max()), 1.0)
        np.testing.assert_allclose(a, want.data, rtol=0, atol=1e-4 * scale)
    finally:
        fluid.set_flags({"FLAGS_use_pallas_conv": "off"})


def test_slice18_generate_on_the_card_is_the_in_process_stream(cuda):
    """POST /generate on a decode engine on the card streams, bit for bit,
    the tokens and finish event the engine gives in process, K6 running
    under both."""
    import json
    import urllib.request

    from paddle_tpu_torch.serving import start_http_server

    eng = DecodeEngine(_decode_cfg(fluid.CUDAPlace(0))).start()
    server, _ = start_http_server(eng, port=0)
    base = "http://127.0.0.1:%d" % server.server_address[1]
    try:
        for i, (prompt, n) in enumerate((([5, 6, 7], 24),
                                         ([3] * 40, 16))):
            want = list(eng.submit(prompt, max_tokens=n,
                                   request_id="in-%d" % i))
            before = support.launch_counts()["paged_decode_attention"]
            req = urllib.request.Request(
                base + "/generate",
                json.dumps({"prompt": prompt, "max_tokens": n}).encode(),
                {"X-Request-Id": "http-%d" % i}, method="POST")
            with urllib.request.urlopen(req, timeout=60) as r:
                got = [json.loads(ln) for ln in r if ln.strip()]
            assert got == want
            assert support.launch_counts()["paged_decode_attention"] > before
    finally:
        server.shutdown()
        server.server_close()
        eng.stop()


# -- slice 19: control flow on the captured route -----------------------------

def _fed_loop(B=8, D=16):
    """h <- tanh(h W + x), n times, n fed: a forward while."""
    main, startup = fluid.Program(), fluid.Program()
    L = fluid.layers
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.data(name="x", shape=[B, D], dtype="float32")
        n = fluid.data(name="n", shape=[1], dtype="int64")
        w = L.create_parameter([D, D], "float32", name="w_loop")
        h = L.fill_constant([B, D], "float32", 0.0)
        i = L.fill_constant([1], "int64", 0)
        cond = L.less_than(i, n)
        with L.While(cond).block():
            L.assign(L.tanh(L.elementwise_add(L.matmul(h, w), x)), h)
            L.increment(i, value=1, in_place=True)
            L.less_than(i, n, cond=cond)
    return main, startup, [h, i]


def _loop_feed(trips, B=8, D=16):
    return {"x": np.random.RandomState(trips).randn(B, D).astype("float32"),
            "n": np.array([trips], dtype="int64")}


def test_slice19_while_node_is_the_card_interpreter_bitwise(cuda):
    """The captured while node runs the interpreter's kernels in its
    order: its fetches equal the interpreter's on the card bit for bit,
    and a replay reads no condition on the host."""
    main, startup, fetch = _fed_loop()
    exe = fluid.Executor(fluid.CUDAPlace(0))
    s1, s2 = fluid.Scope(), fluid.Scope()
    exe.run(startup, scope=s1)
    w = s1.find_var("w_loop").get_tensor().numpy()
    exe.run(startup, scope=s2)
    fluid.io.scope_from_numpy(s2, {"w_loop": w}, fluid.CUDAPlace(0))
    feed = _loop_feed(9)
    ce.reset_counters()
    for _ in range(2):  # eager, then the capture
        exe.run(main, feed=feed, fetch_list=fetch, scope=s1)
    reads = ce.counters()["executor.condition_reads"]
    got = exe.run(main, feed=feed, fetch_list=fetch, scope=s1)
    c = ce.counters()
    assert (c["executor.jit_traces"], c["executor.compile_fallbacks"]) == \
        (1, 0)
    assert c["executor.condition_reads"] == reads == 10  # the eager run's
    want = exe._core.run_program(main, s2, feed, fetch, True)
    for g, wv in zip(got, want):
        assert np.asarray(g).tobytes() == np.asarray(wv).tobytes()
    exe.close()


def test_slice19_one_capture_replays_three_trip_counts(cuda):
    """One capture holds a trip count the data decides: replays at 50, 17
    and 0 trips each give the interpreter's answer, with no recapture."""
    main, startup, fetch = _fed_loop()
    exe = fluid.Executor(fluid.CUDAPlace(0))
    scope, ref = fluid.Scope(), fluid.Scope()
    exe.run(startup, scope=scope)
    w = scope.find_var("w_loop").get_tensor().numpy()
    exe.run(startup, scope=ref)
    fluid.io.scope_from_numpy(ref, {"w_loop": w}, fluid.CUDAPlace(0))
    ce.reset_counters()
    for trips in (50, 50, 17, 0, 50):
        feed = _loop_feed(trips)
        got = exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
        want = exe._core.run_program(main, ref, feed, fetch, True)
        assert int(np.asarray(got[1]).reshape(-1)[0]) == trips
        for g, wv in zip(got, want):
            assert np.asarray(g).tobytes() == np.asarray(wv).tobytes()
    assert ce.counters()["executor.jit_traces"] == 1
    exe.close()


def _if_program(D=16):
    main, startup = fluid.Program(), fluid.Program()
    L = fluid.layers
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.data(name="x", shape=[4, D], dtype="float32")
        flag = fluid.data(name="flag", shape=[1], dtype="bool")
        y = L.tanh(x)
        blk = main.current_block()
        sub = main._create_block()
        L.assign(L.scale(y, scale=3.0, bias=1.0), output=y)
        main._rollback()
        blk.append_op("conditional_block", inputs={"Cond": [flag]},
                      outputs={}, attrs={"sub_block": sub,
                                         "is_scalar_condition": True})
    return main, startup, [y]


def test_slice19_if_node_both_ways(cuda):
    """A scalar conditional_block is an if node: one capture answers
    either way as the CPU does; a false condition leaves y as it was."""
    main, startup, fetch = _if_program()
    card, cpu = fluid.Executor(fluid.CUDAPlace(0)), \
        fluid.Executor(fluid.CPUPlace())
    sc, sp = fluid.Scope(), fluid.Scope()
    card.run(startup, scope=sc)
    cpu.run(startup, scope=sp)
    ce.reset_counters()
    x = np.random.RandomState(0).randn(4, 16).astype("float32")
    for flag in (True, False, True, False):
        feed = {"x": x, "flag": np.array([flag])}
        (got,) = card.run(main, feed=feed, fetch_list=fetch, scope=sc)
        (want,) = cpu.run(main, feed=feed, fetch_list=fetch, scope=sp)
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
        base = np.tanh(x)
        np.testing.assert_allclose(got, base * 3 + 1 if flag else base,
                                   rtol=1e-5, atol=1e-6)
    c = ce.counters()
    assert (c["executor.jit_traces"], c["executor.compile_fallbacks"]) == \
        (1, 0)
    card.close()


def test_slice19_p1_against_its_host_loop(cuda):
    """P1: a while node captured by hand gives the plain host loop's
    values and trips bit for bit; its trip counter counts the body's
    runs over replays."""
    from paddle_tpu_torch.core.cuda_graph import CapturedGraph, GraphCache
    from paddle_tpu_torch.ops.cuda import graph_conditional as p1

    n = torch.tensor([13], dtype=torch.int64, device=cuda)
    x0 = torch.randn(1000, device=cuda)
    state = {"x": x0.clone(), "i": torch.zeros(1, dtype=torch.int64,
                                               device=cuda)}

    def plain():
        state["x"], state["i"] = state["x"] * 0.5 + 1.0, state["i"] + 1

    assert p1.host_while(lambda: state["i"] < n, plain) == 13
    xb, ib = x0.clone(), torch.zeros(1, dtype=torch.int64, device=cuda)
    trips = support.TripCounter(cuda)
    graph, cache = CapturedGraph(), GraphCache(cuda)

    def body():
        with graph.conditional(ib < n, True, trips) as new_cond:
            xb.copy_(xb * 0.5 + 1.0)
            ib.copy_(ib + 1)
            new_cond.append(ib < n)

    graph.capture(cache, body)
    for _ in range(3):
        xb.copy_(x0)
        ib.zero_()
        graph.launch()
    torch.cuda.synchronize()
    assert torch.equal(xb, state["x"]) and int(ib.item()) == 13
    assert trips.flush() == 39
    cache.clear()


def test_slice19_rng_in_a_captured_loop_is_declined_by_name(cuda):
    """A dropout in a while body would replay one Philox offset, so one
    mask, every trip of a captured loop: the card declines the program
    by name, counts it and interprets it."""
    main, startup = fluid.Program(), fluid.Program()
    L = fluid.layers
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.data(name="x", shape=[8, 8], dtype="float32")
        h = L.assign(x)
        i = L.fill_constant([1], "int64", 0)
        n = L.fill_constant([1], "int64", 2)
        c = L.less_than(i, n)
        with L.While(c).block():
            L.assign(L.dropout(h, 0.5), output=h)
            L.increment(i, value=1, in_place=True)
            L.less_than(i, n, cond=c)
    exe = fluid.Executor(fluid.CUDAPlace(0))
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    ce.reset_counters()
    with pytest.warns(UserWarning, match="falls back"):
        exe.run(main, feed={"x": np.ones((8, 8), "float32")},
                fetch_list=[h], scope=scope)
    assert ce.declines() == {"while>dropout (rng in a captured loop)": 1}
    c = ce.counters()
    assert c["executor.compile_fallbacks"] == 1
    assert c["executor.jit_traces"] == 0
    exe.close()


def test_slice19_launch_counts_through_a_while_body_are_exact(cuda):
    """K1 in a while body launches once a trip: the trip counter keeps
    the counts exact over replays (K1 trips x runs; P1 a set before the
    node and one a trip, each run)."""
    B, H, S, D, T = 2, 2, 64, 64, 5
    main, startup = fluid.Program(), fluid.Program()
    L = fluid.layers
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        q = fluid.data(name="q", shape=[B, H, S, D], dtype="float32")
        k = fluid.data(name="k", shape=[B, H, S, D], dtype="float32")
        h = L.assign(q)
        i = L.fill_constant([1], "int64", 0)
        n = L.fill_constant([1], "int64", T)
        c = L.less_than(i, n)
        with L.While(c).block():
            L.assign(L.flash_attention(h, k, k), output=h)
            L.increment(i, value=1, in_place=True)
            L.less_than(i, n, cond=c)
    exe = fluid.Executor(fluid.CUDAPlace(0))
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    rng = np.random.RandomState(0)
    feed = {"q": rng.randn(B, H, S, D).astype("float32"),
            "k": rng.randn(B, H, S, D).astype("float32")}
    exe.run(main, feed=feed, fetch_list=[h], scope=scope)  # eager
    support.reset_launch_counts()
    ce.reset_counters()
    for _ in range(4):  # the capture, then 3 replays
        exe.run(main, feed=feed, fetch_list=[h], scope=scope)
    counts = support.launch_counts()
    assert ce.counters()["executor.jit_traces"] == 1
    assert counts["flash_attention_forward"] == 4 * T
    assert counts["graph_conditional"] == 4 * (1 + T)
    exe.close()


def test_slice19_a_failed_conditional_capture_raises(cuda):
    """A conditional node begun on a stream that is not capturing raises
    with the CUDA error; the engine's route has no fallback to the host
    loop for a condition on the card."""
    from paddle_tpu_torch.ops.cuda import graph_conditional as p1

    cond = torch.ones(1, dtype=torch.bool, device=cuda)
    side = p1.create_stream()
    try:
        with pytest.raises(RuntimeError, match="CUDA error"):
            p1.begin(torch.cuda.current_stream().cuda_stream, side, True,
                     cond)
        with pytest.raises(ValueError, match="one value"):
            p1.begin(torch.cuda.current_stream().cuda_stream, side, True,
                     torch.ones(2, dtype=torch.bool, device=cuda))
    finally:
        p1.destroy_stream(side)


# -- slice 20: data parallelism on the card ----------------------------------


def _slice20_gpt(batch, env):
    import os

    for k in ("PADDLE_TPU_BUCKET_MB", "PADDLE_TPU_SHARDED_UPDATE",
              "PADDLE_TPU_QUANT_ALLREDUCE", "PADDLE_TPU_FUSED_OPTIMIZER"):
        os.environ.pop(k, None)
    os.environ.update(env)
    return gpt.build_gpt_long(batch, 64, 128, 2, 2, 128, seed=3,
                              use_bf16=False)


@pytest.mark.parametrize("env", [{}, {"PADDLE_TPU_SHARDED_UPDATE": "1"}],
                         ids=["bucketed", "sharded_update"])
def test_slice20_two_replicas_on_one_card_stay_bitwise_equal(cuda, env):
    """A narrow gpt over [CUDAPlace(0)] * 2: an eager step, one capture of
    both replicas and the reductions, replays; after every step both
    replicas' parameters are bitwise equal and never one buffer; the
    mean of the replicas' losses within 1e-4 of one replica's full batch;
    K1 8 and K4 2 (sharded) a step."""
    import os

    from paddle_tpu_torch.parallel import engine

    try:
        rng = np.random.RandomState(0)
        feed = gpt.random_batch(rng, 2, 64, 128)
        main, startup, loss, _ = _slice20_gpt(2, env)
        exe = fluid.Executor(fluid.CUDAPlace(0))
        scope = fluid.Scope()
        exe.run(startup, scope=scope)
        init = {p.name: np.array(scope.find_var(p.name).get_tensor())
                for p in main.all_parameters()}
        ref = [float(np.asarray(exe.run(main, feed=feed, fetch_list=[loss],
                                        scope=scope)[0]).ravel()[0])
               for _ in range(4)]
        main, startup, loss, _ = _slice20_gpt(1, env)
        exe = fluid.Executor(fluid.CUDAPlace(0))
        scope = fluid.Scope()
        exe.run(startup, scope=scope)
        fluid.io.scope_from_numpy(scope, init, fluid.CUDAPlace(0))
        cp = fluid.CompiledProgram(main).with_data_parallel(
            loss.name, places=[fluid.CUDAPlace(0)] * 2)
        support.reset_launch_counts()
        ce.reset_counters()
        got = []
        for _ in range(4):
            (out,) = exe.run(cp, feed=feed, fetch_list=[loss], scope=scope)
            got.append(float(np.asarray(out, np.float64).mean()))
            for p in main.all_parameters():
                a, b = engine.replica_values(exe, p.name)
                assert a.data_ptr() != b.data_ptr()
                assert torch.equal(a, b), p.name
        counts = support.launch_counts()
        assert ce.counters()["executor.jit_traces"] == 1
        assert not ce.declines()
        np.testing.assert_allclose(got, ref, rtol=1e-4)
        assert counts["flash_attention_forward"] == 4 * 2 * 4
        assert counts["fused_optimizer_update"] == (
            2 * 4 if env else 0)
        exe.close()
    finally:
        for k in env:
            os.environ.pop(k, None)


def test_slice20_sync_batch_norm_backward_on_the_card(cuda):
    """A small NHWC conv-bn net under sync batch norm over
    [CUDAPlace(0)] * 2, captured: three steps give one replica's losses
    and parameters on the whole batch (the backward reduces the grad
    statistics over the replicas), within 1e-5 relative losses and 1e-5
    absolute parameters, TF32 off."""
    L = fluid.layers

    def build(batch):
        main, startup = fluid.Program(), fluid.Program()
        startup.random_seed = 5
        with fluid.unique_name.guard(), fluid.program_guard(main, startup):
            img = fluid.data(name="img", shape=[batch, 8, 8, 4],
                             dtype="float32")
            lbl = fluid.data(name="lbl", shape=[batch, 1], dtype="int64")
            h = L.conv2d(img, 8, 3, padding=1, bias_attr=False,
                         data_format="NHWC")
            h = L.batch_norm(h, act="relu", data_layout="NHWC")
            h = L.pool2d(h, pool_type="avg", global_pooling=True,
                         data_format="NHWC")
            pred = L.fc(h, size=10, act="softmax")
            loss = L.mean(L.cross_entropy(pred, lbl))
            fluid.optimizer.MomentumOptimizer(0.1, 0.9).minimize(loss)
        return main, startup, loss

    rng = np.random.RandomState(13)
    feed = {"img": (rng.randn(16, 8, 8, 4) * 2 + 1).astype("float32"),
            "lbl": rng.randint(0, 10, (16, 1)).astype("int64")}
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        runs = []
        for reps in (1, 2):
            main, startup, loss = build(16 // reps)
            exe = fluid.Executor(fluid.CUDAPlace(0))
            scope = fluid.Scope()
            exe.run(startup, scope=scope)
            prog = main
            if reps == 1:
                init = {p.name: np.array(scope.find_var(p.name).get_tensor())
                        for p in main.all_parameters()}
            else:
                fluid.io.scope_from_numpy(scope, init, fluid.CUDAPlace(0))
                bs = fluid.BuildStrategy()
                bs.sync_batch_norm = True
                prog = fluid.CompiledProgram(main).with_data_parallel(
                    loss.name, build_strategy=bs,
                    places=[fluid.CUDAPlace(0)] * 2)
                ce.reset_counters()
            losses = [float(np.asarray(exe.run(prog, feed=feed,
                                               fetch_list=[loss],
                                               scope=scope)[0],
                                       np.float64).mean())
                      for _ in range(3)]
            runs.append((losses, {p.name: np.array(
                scope.find_var(p.name).get_tensor())
                for p in main.all_parameters()}))
            exe.close()
        assert ce.counters()["executor.jit_traces"] == 1
        np.testing.assert_allclose(runs[1][0], runs[0][0], rtol=1e-5)
        for k, v in runs[0][1].items():
            np.testing.assert_allclose(runs[1][1][k], v, rtol=0, atol=1e-5,
                                       err_msg=k)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32


def test_slice20_sharded_update_on_k4_against_its_plain_version(cuda):
    """c_sharded_update's form over 2 replicas on the card: each replica's
    1/2 shard through K4 (an uneven total padded to an even size), the
    parameters and state bitwise equal to the plain version on the same
    shards on the card."""
    from paddle_tpu_torch.core.registry import OpInfoMap
    from paddle_tpu_torch.ops.collective_ops import ReplicaGroup

    info = OpInfoMap.instance().get("c_sharded_update")
    gen = torch.Generator(device="cpu").manual_seed(0)
    shapes = [(33, 7), (5,), (19, 3)]
    total = sum(int(np.prod(s)) for s in shapes)
    padded = total + (total % 2)
    params = [torch.randn(s, generator=gen) for s in shapes]
    m1 = torch.randn(padded, generator=gen).abs() * 1e-3
    m2 = torch.randn(padded, generator=gen).abs() * 1e-5
    attrs = {"op_type": "adam", "shard_axis": "dp", "nranks": 2,
             "padded_size": padded, "quant": "none", "beta1": 0.9,
             "beta2": 0.999, "epsilon": 1e-8}
    grads = [[torch.randn(s, generator=gen) for s in shapes]
             for _ in range(2)]
    lr = torch.tensor([1e-3])
    pows = (torch.tensor([0.9 ** 3]), torch.tensor([0.999 ** 3]))

    def ins(r, dev):
        half = padded // 2
        return {"Param": [p.to(dev) for p in params],
                "Grad": [g.to(dev) for g in grads[r]],
                "LearningRate": lr.to(dev),
                "StateA": m1[r * half:(r + 1) * half].clone().to(dev),
                "StateB": m2[r * half:(r + 1) * half].clone().to(dev),
                "Beta1Pow": [pows[0].to(dev)] * len(shapes),
                "Beta2Pow": [pows[1].to(dev)] * len(shapes)}

    before = fo.LAUNCHES.value
    ins_k = [ins(r, cuda) for r in range(2)]
    outs = info.group_fn(ins_k, attrs, ReplicaGroup([cuda, cuda]))
    torch.cuda.synchronize()
    assert fo.LAUNCHES.value == before + 2
    # the plain version on the same shards, on the card
    g_sum = torch.cat([torch.cat([g.reshape(-1) for g in grads[0]]) +
                       torch.cat([g.reshape(-1) for g in grads[1]]),
                       torch.zeros(padded - total)]).to(cuda)
    p_flat = torch.cat([torch.cat([p.reshape(-1) for p in params]),
                        torch.zeros(padded - total)]).to(cuda)
    half = padded // 2
    new_p = []
    for r in range(2):
        sl = slice(r * half, (r + 1) * half)
        p_new, a, b = fo.fused_optimizer_update_reference(
            "adam", attrs, p_flat[sl], g_sum[sl], lr.to(cuda).reshape(()),
            m1[sl].to(cuda), m2[sl].to(cuda), pows[0].to(cuda).reshape(()),
            pows[1].to(cuda).reshape(()))
        assert torch.equal(outs[r]["StateAOut"], a)
        assert torch.equal(outs[r]["StateBOut"], b)
        new_p.append(p_new)
    flat = torch.cat(new_p)[:total]
    for r in range(2):
        got = torch.cat([p.reshape(-1) for p in outs[r]["ParamOut"]])
        assert torch.equal(got, flat)


def test_slice20_fused_optimizer_program_refused_on_the_mesh(cuda):
    """The single-chip fused-optimizer rewrite (K4's flat layout on the
    card) is refused on two replicas, with the JAX engine's message."""
    import os

    from paddle_tpu_torch.parallel import engine

    try:
        main, startup, loss, _ = _slice20_gpt(
            1, {"PADDLE_TPU_FUSED_OPTIMIZER": "1"})
        exe = fluid.Executor(fluid.CUDAPlace(0))
        scope = fluid.Scope()
        exe.run(startup, scope=scope)
        rng = np.random.RandomState(0)
        exe.run(main, feed=gpt.random_batch(rng, 1, 64, 128),
                fetch_list=[loss], scope=scope)
        assert main._fused_optimizer_groups == 1
        cp = fluid.CompiledProgram(main).with_data_parallel(
            loss.name, places=[fluid.CUDAPlace(0)] * 2)
        with pytest.raises(ValueError) as e:
            exe.run(cp, feed=gpt.random_batch(rng, 2, 64, 128),
                    fetch_list=[loss], scope=scope)
        assert str(e.value) == engine.FUSED_OPTIMIZER_REFUSAL
        exe.close()
    finally:
        os.environ.pop("PADDLE_TPU_FUSED_OPTIMIZER", None)


def test_slice20_gloo_collective_capture_is_declined_by_name(cuda,
                                                             tmp_path):
    """Two ranks over gloo on one card (the launcher, the dygraph and
    static workers of tests/dist_worker_dp_torch.py): the static program's
    capture is declined by the collective's name and counted, every step
    runs eagerly, and the ranks agree with one process bit for bit in
    their parameters."""
    import json
    import os
    import socket
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    worker = os.path.join(repo, "tests", "dist_worker_dp_torch.py")
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("PADDLE_", "FLAGS_selected"))}
    if torch.cuda.device_count() >= 2:
        pytest.skip("two or more cards: the ranks take NCCL, not gloo")
    env.update(PADDLE_DP_DEVICE="cuda",
               PYTHONPATH=repo + os.pathsep + env.get("PYTHONPATH", ""))
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    proc = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
         "--nproc_per_node=2", "--started_port=%d" % port, worker,
         str(tmp_path)], env=env, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    ranks = [json.loads((tmp_path / ("rank%d.json" % r)).read_text())
             for r in (0, 1)]
    for r in ranks:
        assert r["backend"] == "gloo"
        assert r["declines"] == {
            "c_bucket_allreduce (gloo collective: not capturable)": 1}
        assert r["counters"]["executor.jit_traces"] == 0
        assert r["launches"]["probe_add_one"] == 1
    params = [np.load(tmp_path / ("rank%d.npz" % r)) for r in (0, 1)]
    for k in params[0].files:
        assert np.array_equal(params[0][k], params[1][k]), k


# -- slice 21: the hybrid axes on the card -------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_slice21_ring_group_form_against_reference_attention(cuda, dtype):
    """c_ring_attention's form over an sp subgroup of 4 replicas on the card
    (causal, key lengths) against the dense reference_attention: float32
    within 2e-5, bfloat16 within 5e-2 of the float32 oracle."""
    from paddle_tpu_torch.core.registry import OpInfoMap
    from paddle_tpu_torch.ops.collective_ops import ReplicaGroup
    from paddle_tpu_torch.parallel.ring_attention import reference_attention

    g = torch.Generator(device="cuda").manual_seed(21)
    q, k, v = (torch.randn(2, 4, 64, 32, generator=g, device="cuda")
               for _ in range(3))
    lens = torch.tensor([64, 23], dtype=torch.int32, device="cuda")
    dt = getattr(torch, dtype)
    ins = [{"Q": a.to(dt), "K": b.to(dt), "V": c.to(dt), "Lengths": lens}
           for a, b, c in zip(q.chunk(4, 2), k.chunk(4, 2), v.chunk(4, 2))]
    info = OpInfoMap.instance().get("c_ring_attention")
    outs = info.group_fn(ins, {"causal": True, "scale": 0.0},
                         ReplicaGroup(["cuda"] * 4))
    got = torch.cat([o["Out"] for o in outs], dim=2)
    assert got.dtype == dt and got.is_cuda
    ref = reference_attention(q, k, v, causal=True, lengths=lens)
    tol = 2e-5 if dtype == "float32" else 5e-2
    assert (got.float() - ref).abs().max().item() <= tol


def test_slice21_sharded_lookup_grad_on_the_card(cuda):
    """c_sharded_lookup_grad's form over an mp subgroup of 2 on the card:
    each block takes its own hit rows of this replica's cotangent (ids
    repeated), the blocks together the dense lookup's grad, and two runs
    give the same bits."""
    from paddle_tpu_torch.core.registry import OpInfoMap
    from paddle_tpu_torch.ops.collective_ops import ReplicaGroup

    g = torch.Generator(device="cuda").manual_seed(22)
    w = torch.randn(18, 8, generator=g, device="cuda")
    ids = torch.tensor([[0], [9], [17], [9], [3], [9]], device="cuda")
    ct = torch.randn(6, 8, generator=g, device="cuda")
    grad = OpInfoMap.instance().get("c_sharded_lookup_grad")
    ins = [{"W": blk, "Ids": ids, "Out@GRAD": ct} for blk in w.chunk(2)]
    attrs = {"shard_axis": "mp", "padding_idx": -1, "squeeze_last": True}
    runs = [torch.cat([o["W@GRAD"] for o in grad.group_fn(
        ins, attrs, ReplicaGroup(["cuda"] * 2))]) for _ in range(2)]
    want = torch.zeros_like(w).index_add_(0, ids.reshape(-1), ct)
    assert torch.equal(runs[0], runs[1])
    assert (runs[0] - want).abs().max().item() <= 1e-6


def test_slice21_captured_hybrid_step_replays_its_eager_step(cuda):
    """A dp x mp step (a row-sharded table and an fc over 4 replicas on
    the card): the eager step and the captured one from the same state and
    feed give the same bits, the capture taken once, no decline."""
    from paddle_tpu_torch.incubate.fleet.collective import (
        CollectiveOptimizer, DistributedStrategy)
    from paddle_tpu_torch.parallel.mesh_utils import make_mesh

    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        ids = fluid.data(name="ids", shape=[8, 1], dtype="int64")
        tgt = fluid.data(name="tgt", shape=[8, 4], dtype="float32")
        emb = fluid.layers.embedding(ids, size=[16, 8],
                                     param_attr=fluid.ParamAttr(name="emb"))
        pred = fluid.layers.fc(emb, size=4)
        loss = fluid.layers.reduce_mean(fluid.layers.square(
            fluid.layers.elementwise_sub(pred, tgt)))
        strat = DistributedStrategy()
        strat.sharded_embedding = True
        strat.mp_degree = 2
        CollectiveOptimizer(fluid.optimizer.MomentumOptimizer(0.1, 0.9),
                            strat).minimize(loss)
    rng = np.random.RandomState(23)
    feed = {"ids": rng.randint(0, 16, (16, 1)).astype("int64"),
            "tgt": rng.randn(16, 4).astype("float32")}
    exe = fluid.Executor(fluid.CUDAPlace(0))
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    names = [v.name for v in main.global_block().vars.values()
             if v.persistable]
    cp = fluid.CompiledProgram(main).with_data_parallel(
        loss.name, places=make_mesh([2, 2], ["dp", "mp"],
                                    [fluid.CUDAPlace(0)] * 4))
    ce.reset_counters()
    states, losses = [], []
    for _ in range(2):  # the eager step, then the capture (and replay)
        before = {n: scope.find_var(n).get_tensor().array.clone()
                  for n in names if scope.find_var(n) is not None}
        (out,) = exe.run(cp, feed=feed, fetch_list=[loss], scope=scope)
        losses.append(np.asarray(out))
        states.append({n: scope.find_var(n).get_tensor().array.clone()
                       for n in before})
        # back to the same state for the next step
        for n, t in before.items():
            scope.find_var(n).get_tensor().array.copy_(t)
    assert ce.counters()["executor.jit_traces"] == 1
    assert not ce.declines()
    np.testing.assert_array_equal(losses[0], losses[1])
    for n in states[0]:
        assert torch.equal(states[0][n], states[1][n]), n
    exe.close()


def test_slice21_eager_pipeline_step_names_its_decline(cuda):
    """A pipelined program over a pp mesh on the card runs its stages
    eagerly: its first step counts the decline ``pipeline (eager
    stages)`` once, in ``executor.compile_fallbacks`` too, and a second
    step of the same program on the same mesh does not count it again."""
    from paddle_tpu_torch.parallel import pipeline
    from paddle_tpu_torch.parallel.mesh_utils import make_mesh

    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.data(name="x", shape=[4, 12], dtype="float32")
        label = fluid.data(name="label", shape=[4, 1], dtype="int64")
        h1 = fluid.layers.fc(x, size=16, act="relu")
        pred = fluid.layers.fc(h1, size=10, act="softmax")
        loss = fluid.layers.mean(fluid.layers.cross_entropy(pred, label))
        fluid.optimizer.PipelineOptimizer(
            fluid.optimizer.MomentumOptimizer(0.1, 0.9), cut_list=[[h1]],
            num_microbatches=2).minimize(loss)
    rng = np.random.RandomState(24)
    feed = {"x": rng.randn(8, 12).astype("float32"),
            "label": rng.randint(0, 10, (8, 1)).astype("int64")}
    exe = fluid.Executor(fluid.CUDAPlace(0))
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    cp = fluid.CompiledProgram(main).with_data_parallel(
        loss.name, places=make_mesh([2], ["pp"], [fluid.CUDAPlace(0)] * 2))
    ce.reset_counters()
    with pytest.warns(UserWarning, match="capture declined"):
        (first,) = exe.run(cp, feed=feed, fetch_list=[loss], scope=scope)
    (second,) = exe.run(cp, feed=feed, fetch_list=[loss], scope=scope)
    assert ce.declines() == {pipeline.EAGER_DECLINE: 1}
    assert ce.counters()["executor.compile_fallbacks"] == 1
    assert np.isfinite(first).all() and np.isfinite(second).all()
    exe.close()


# -- slice 22: DGC, the step profiler, the device trace, the sp layer norm ---

# tests/test_torch_training.py's PARAM_ATOL_PER_STEP (twice its Adam rate,
# 1e-4), the limit the CPU tests hold an sp run's parameters to; that file
# imports the JAX package, which the card's machine does not have
SP_PARAM_ATOL_PER_STEP = 2e-4

@pytest.mark.parametrize("n", [64 * 33, (1 << 24) + 4099])
def test_slice22_dgc_on_the_card_against_its_plain_version(cuda, n):
    """The dgc op on card tensors against its plain function on the same
    values on the CPU, past the rampup (the walk's third sparsity) and
    over 2^24 elements: the same entries selected, every output the same
    bits."""
    from paddle_tpu_torch.core.registry import OpInfoMap

    fn = OpInfoMap.instance().get("dgc").fn
    g = torch.Generator(device="cuda").manual_seed(22)
    ins = {"U": torch.randn(n, generator=g, device="cuda") * 0.1,
           "V": torch.randn(n, generator=g, device="cuda") * 0.1,
           "Grad": torch.randn(n, generator=g, device="cuda"),
           "CurrentStep": torch.full((1,), 3.0, device="cuda")}
    attrs = {"m": 0.9, "use_nesterov": False,
             "sparsity": [0.75, 0.9375, 0.984375, 0.996, 0.999],
             "rampup_begin_step": 1.0, "rampup_step": 4.0}
    got = fn(ins, dict(attrs))
    want = fn({k: v.cpu() for k, v in ins.items()}, dict(attrs))
    assert torch.equal(got["EncodeGrad"].cpu() != 0,
                       want["EncodeGrad"] != 0)
    for k in ("UOut", "VOut", "EncodeGrad", "GradOut"):
        assert torch.equal(got[k].cpu(), want[k]), k
    kept = int((want["EncodeGrad"] != 0).sum())
    assert abs(kept - round(n * (1 - 0.984375))) <= 1


def slice22_mlp(opt="adam"):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.data(name="x", shape=[64, 32], dtype="float32")
        y = fluid.data(name="y", shape=[64, 1], dtype="int64")
        h = fluid.layers.fc(x, 128, act="relu")
        pred = fluid.layers.fc(h, 10, act="softmax")
        loss = fluid.layers.mean(fluid.layers.cross_entropy(pred, y))
        fluid.optimizer.AdamOptimizer(1e-3).minimize(loss)
    rng = np.random.RandomState(22)
    feed = {"x": rng.rand(64, 32).astype("float32"),
            "y": rng.randint(0, 10, (64, 1)).astype("int64")}
    return main, startup, loss, feed


def slice22_state(main, scope):
    return {v.name: scope.find_var(v.name).get_tensor().array.clone()
            for v in main.list_vars() if v.persistable
            and scope.find_var(v.name) is not None
            and scope.find_var(v.name).is_initialized()}


def test_slice22_profile_step_leaves_the_state_on_the_card(cuda,
                                                           monkeypatch):
    """profile_step on the card (K4's flat adam): captured prefixes timed
    with CUDA events, the state (parameters, the flat moments) bit for bit
    as it was, its graphs' pool given back."""
    from paddle_tpu_torch.observability import profiler as prof

    monkeypatch.setenv("PADDLE_TPU_FUSED_OPTIMIZER", "1")
    main, startup, loss, feed = slice22_mlp()
    exe, scope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
    exe.run(startup, scope=scope)
    for _ in range(3):
        exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    before = slice22_state(main, scope)
    assert any(n.startswith("fused_opt_") for n in before)
    rep = prof.profile_step(main, scope, feed)
    after = slice22_state(main, scope)
    for n, t in before.items():
        assert torch.equal(after[n], t), n
    assert rep["timing"] == "cuda graph replays, cuda events"
    assert set(rep["phase_ms"]) == {"forward", "backward", "optimizer"}
    assert rep["peak_bytes"] > 0 and rep["step_ms"] > 0
    assert rep["launches"].get("fused_optimizer_update", 0) >= 1
    exe.close()


def test_slice22_device_fold_on_the_card(cuda):
    """device_profile_step on the card: a fold that is not None, each of
    the step's phases with device time, the kernel records seen beside
    the launches of the port's kernels."""
    from paddle_tpu_torch.observability import device_trace
    from paddle_tpu_torch.observability import profiler as prof

    main, startup, loss, feed = slice22_mlp()
    exe, scope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
    exe.run(startup, scope=scope)
    exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    dev = device_trace.device_profile_step(main, scope, feed, steps=2)
    assert dev is not None
    assert {"forward", "backward", "optimizer"} <= set(
        dev["device_phase_ms"])
    assert all(ms > 0 for ms in dev["device_phase_ms"].values())
    assert dev["kernel_records"] >= dev["n_attributed"] > 0
    assert not prof.annotating()
    exe.close()


def test_slice22_sp_layer_norm_over_s_x_d_against_the_dense_run(cuda):
    """A narrow gpt (2 layers, d 64, one head of 64, S 128) whose layer
    norms span S x D, under sp=2 on the card against its dense program on
    the card from the same start: the first loss within 1e-5 relative,
    every parameter after 2 steps within ``SP_PARAM_ATOL_PER_STEP`` a step
    (``tests/test_torch_training.py``'s ``PARAM_ATOL_PER_STEP``, 2e-4, as
    the CPU test holds its sp run). Prints each parameter's grad norm in
    the dense run's first step beside its change and its gap: the key
    projection's bias has a grad of rounding noise (the softmax does not
    see a shift of every key), which Adam turns into moves of about the
    same size in both runs."""
    from paddle_tpu_torch.incubate.fleet.collective import (
        CollectiveOptimizer, DistributedStrategy)
    from paddle_tpu_torch.parallel.mesh_utils import make_mesh

    S, vocab = 128, 128
    kw = dict(d_model=64, n_heads=1, n_layers=2, vocab=vocab,
              learning_rate=1e-3, seed=22, use_bf16=False)

    def sp_opt():
        strat = DistributedStrategy()
        strat.sequence_parallel = True
        strat.sp_degree = 2
        strat.feed_shard_specs = {"ids": (None, "sp"), "lbl": ("sp", None)}
        return CollectiveOptimizer(fluid.optimizer.AdamOptimizer(1e-3),
                                   strat)

    rng = np.random.RandomState(22)
    feeds = [gpt.random_batch(rng, 1, S, vocab) for _ in range(2)]
    runs = []
    for sp in (0, 2):
        main, startup, loss, _ = gpt.build_gpt_long(
            1, S // (sp or 1), optimizer_fn=sp_opt if sp else None, **kw)
        exe, scope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
        exe.run(startup, scope=scope)
        names = [p.name for p in main.all_parameters()]
        if sp:
            assert sum(op.attrs.get("shard_axis") == "sp"
                       for op in main.global_block().ops
                       if op.type == "layer_norm") == 5
            for n, t in runs[0][2].items():
                scope.var(n).set(fluid.LoDTensor(t.clone()))
            prog = fluid.CompiledProgram(main).with_data_parallel(
                loss.name, places=make_mesh([2], ["sp"],
                                            [fluid.CUDAPlace(0)] * 2))
            grads = []
        else:
            prog = main
            grads = [n + "@GRAD" for n in names]
        init = {n: scope.find_var(n).get_tensor().array.clone()
                for n in names}
        outs = [exe.run(prog, feed=f, fetch_list=[loss] + grads,
                        scope=scope) for f in feeds[:1]]
        outs += [exe.run(prog, feed=f, fetch_list=[loss], scope=scope)
                 for f in feeds[1:]]
        losses = [float(np.asarray(o[0]).mean()) for o in outs]
        grad_norms = {n: float(np.linalg.norm(g))
                      for n, g in zip(names, outs[0][1:])}
        params = {n: scope.find_var(n).get_tensor().array.clone()
                  for n in names}
        runs.append((losses, params, init, grad_norms))
        exe.close()
    (dl, dp, d0, dgrad), (sl, spp, _, _) = runs
    gaps = {n: float((spp[n] - want).abs().max()) for n, want in dp.items()}
    for n in sorted(dgrad, key=dgrad.get):
        print("slice22 sp S x D: %-24s grad norm %.3e  change %.3e  gap "
              "%.3e" % (n, dgrad[n], float((dp[n] - d0[n]).norm()),
                        gaps[n]))
    assert abs(sl[0] - dl[0]) / abs(dl[0]) < 1e-5
    assert all(spp[n].shape == want.shape for n, want in dp.items())
    limit = SP_PARAM_ATOL_PER_STEP * len(feeds)
    assert all(g <= limit for g in gaps.values()), {
        n: g for n, g in gaps.items() if g > limit}


# -- slice 23: placement, steering and the canary on the card ------------------

_SLICE23_KNOBS = ("PADDLE_TPU_BUCKET_MB", "PADDLE_TPU_SHARDED_UPDATE",
                  "PADDLE_TPU_QUANT_ALLREDUCE", "PADDLE_TPU_FUSED_OPTIMIZER",
                  "PADDLE_TPU_REDUCE_STRATEGY",
                  "PADDLE_TPU_ASYNC_COLLECTIVES", "PADDLE_TPU_BUCKET_PLAN",
                  "PADDLE_TPU_BUCKET_PROFILE", "PADDLE_TPU_PLACEMENT_PLAN")


def _slice23_run(env, init=None, steps=3, profile=False, plant=None):
    """The narrow gpt over [CUDAPlace(0)] * 2 under ``env``: losses, the
    program, the profile report (``profile``); the replicas' parameters
    compared after each step (a difference raises)."""
    import contextlib
    import os

    from paddle_tpu_torch.observability import profiler as prof
    from paddle_tpu_torch.parallel import engine

    for k in _SLICE23_KNOBS:
        os.environ.pop(k, None)
    os.environ.update(env)
    try:
        main, startup, loss, _ = gpt.build_gpt_long(1, 64, 128, 2, 2, 128,
                                                    seed=23, use_bf16=False)
        exe, scope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
        exe.run(startup, scope=scope)
        if init is not None:
            fluid.io.scope_from_numpy(scope, init, fluid.CUDAPlace(0))
        places = [fluid.CUDAPlace(0)] * 2
        cp = fluid.CompiledProgram(main).with_data_parallel(loss.name,
                                                            places=places)
        feed = gpt.random_batch(np.random.RandomState(23), 2, 64, 128)
        losses = []
        with (plant() if plant else contextlib.nullcontext()):
            for _ in range(steps):
                (out,) = exe.run(cp, feed=feed, fetch_list=[loss],
                                 scope=scope)
                losses.append(np.asarray(out).copy())
                for p in main.all_parameters():
                    a, b = engine.replica_values(exe, p.name)
                    if not torch.equal(a, b):
                        raise AssertionError("replicas differ: " + p.name)
        rep = prof.profile_step(main, scope, feed, mesh=places) \
            if profile else None
        exe.close()
        return losses, main, rep
    finally:
        for k in _SLICE23_KNOBS:
            os.environ.pop(k, None)


def _slice23_init():
    main, startup, _, _ = gpt.build_gpt_long(1, 64, 128, 2, 2, 128, seed=23,
                                             use_bf16=False)
    exe, scope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
    exe.run(startup, scope=scope)
    init = {p.name: np.array(scope.find_var(p.name).get_tensor())
            for p in main.all_parameters()}
    exe.close()
    return init


def test_slice23_spellings_and_the_split_give_the_ring_s_bits(cuda,
                                                              tmp_path):
    """Over two replicas on the card, the tree spelling, the async split
    and the profile bucket plan (from the card's own profile_step report)
    train the ring's 4 MB-bucket losses bit for bit, the replicas bitwise
    after every step."""
    import json

    init = _slice23_init()
    base, _, rep = _slice23_run({"PADDLE_TPU_BUCKET_MB": "0.01"}, init,
                                profile=True)
    path = tmp_path / "report.json"
    path.write_text(json.dumps(rep, default=str))
    for env, check in (
            ({"PADDLE_TPU_REDUCE_STRATEGY": "tree"},
             lambda m: {op.attrs["strategy"] for op in m.global_block().ops
                        if op.type == "c_bucket_allreduce"} == {"tree"}),
            ({"PADDLE_TPU_ASYNC_COLLECTIVES": "1"},
             lambda m: m._async_schedule["split"] >= 1),
            ({"PADDLE_TPU_BUCKET_PLAN": "profile",
              "PADDLE_TPU_BUCKET_PROFILE": str(path)},
             lambda m: m._bucket_plan["mode"] == "profile")):
        got, main, _ = _slice23_run(dict(env, PADDLE_TPU_BUCKET_MB="0.01"),
                                    init)
        assert check(main), env
        for a, b in zip(got, base):
            assert np.array_equal(a, b), env


def test_slice23_a_tree_without_its_all_gather_leaves_the_replicas_apart(
        cuda):
    import chip_smoke

    with pytest.raises(AssertionError, match="replicas differ"):
        _slice23_run({"PADDLE_TPU_REDUCE_STRATEGY": "tree"}, _slice23_init(),
                     plant=chip_smoke.tree_without_gather)


def test_slice23_a_card_report_fits_the_search_and_the_plan_applies(
        cuda, tmp_path, monkeypatch):
    """profile_step over the card's mesh fits the cost model (provenance
    ``fitted``); the winner, saved and named by PADDLE_TPU_PLACEMENT_PLAN,
    is the plan the engine records, its losses within 1e-5 of the ring's
    (bitwise unless it compresses the payload or shards the update)."""
    from paddle_tpu_torch import placement

    init = _slice23_init()
    base, _, rep = _slice23_run({"PADDLE_TPU_BUCKET_MB": "4"}, init,
                                profile=True)

    def build():
        main, _, loss, _ = gpt.build_gpt_long(1, 64, 128, 2, 2, 128,
                                              seed=23, use_bf16=False)
        return main, loss.name

    plan, audit = placement.search_placement(build, 2, report=rep)
    assert audit["cost_provenance"] == "fitted"
    assert plan.cost_provenance == "fitted" and plan.predicted_step_ms > 0
    path = str(tmp_path / "plan.json")
    placement.save_plan(plan, path)
    got, main, _ = _slice23_run({"PADDLE_TPU_PLACEMENT_PLAN": path}, init)
    assert main._placement_plan["plan_digest"] == plan.digest
    np.testing.assert_allclose(np.mean(got, 1), np.mean(base, 1), rtol=1e-5)


def test_slice23_canary_on_the_card_serves_the_proposal_s_answers(
        cuda, tmp_path):
    """A narrow encoder served on the card through the incumbent ladder
    and the serving_ladder steerer's proposal fitted to its batch rows:
    the proposal's answers within 1e-5 of the incumbent's scale, and
    run_canary's decision audited (the pointer installed only on a
    promotion)."""
    from paddle_tpu_torch.observability import canary, steering
    from paddle_tpu_torch.serving import ServingConfig, ServingEngine
    from paddle_tpu_torch.serving import metrics as sm

    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.data(name="x", shape=[-1, 32], dtype="float32")
        y = fluid.layers.fc(fluid.layers.fc(x, 64, act="relu"), 16)
    exe, scope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
    with fluid.scope_guard(scope):
        exe.run(startup)
        fluid.io.save_inference_model(str(tmp_path / "m"), ["x"], [y], exe,
                                      main_program=main)
    pred = create_paddle_predictor(AnalysisConfig(str(tmp_path / "m")))
    rng = np.random.RandomState(23)
    reqs = [{"x": rng.rand(1, 32).astype("float32")} for _ in range(60)]
    sizes = [1 + i % 3 for i in range(30)]

    def serve(ladder):
        eng = ServingEngine(pred, ServingConfig(max_batch_size=8,
                                                ladder=ladder))
        eng.start()
        outs, lat, i = [], [], 0
        for k in sizes:
            futs = [eng.submit(f) for f in reqs[i:i + k]]
            i += k
            outs += [next(iter(f.result(timeout=60).values())) for f in futs]
        rows = eng.metrics.samples(sm.BATCH_SIZE)
        st = eng.stats()
        eng.stop()
        waste = float(st["serving.padding_waste"])
        rec = {"extras": {"s": {"serving_padding_waste_frac":
                                waste / (waste + i)}}}
        return outs, rows, rec

    inc_outs, rows, inc_rec = serve(None)
    ladder = steering.steer("serving_ladder", None, max_batch_size=8,
                            batch_rows=rows)
    got = {}

    def measure(plan):
        got["outs"], _, rec = serve(tuple(plan))
        return rec

    audit = canary.AuditTrail(str(tmp_path))
    store = canary.PlanStore(str(tmp_path), "serving_ladder")
    dec = canary.run_canary({"plan": list(ladder),
                             "steerer": "serving_ladder"}, inc_rec, measure,
                            plan_store=store, audit=audit)
    entry = audit.entries()[-1]
    assert entry["plan_digest"] == dec.plan_digest
    assert (store.active_digest() == dec.plan_digest) == dec.promoted
    scale = max(float(np.abs(o).max()) for o in inc_outs)
    for a, b in zip(got["outs"], inc_outs):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5 * scale)


def test_slice23_the_lazy_policy_stops_recaptures_on_the_card(cuda):
    """A lazy dygraph MLP fed 8 batch sizes under a key cap of 4 recompiles
    every flush; the lazy_policy plan doubles the cap, and after it the
    keys capture once and replay: no recompile, no capture."""
    import chip_smoke

    plan, cap, before, after = chip_smoke.lazy_policy_check(fluid)
    assert cap == 8 and plan["prev_cap"] == 4
    assert before["lazy.recompiles"] == 16 and before["lazy.cache_hits"] == 0
    assert after["lazy.recompiles"] == 0 and after["lazy.captures"] == 0
    assert after["lazy.replays"] == 16


# -- slice 24: the parameter server -------------------------------------------

def _slice24_wide_deep(is_distributed=True):
    from paddle_tpu_torch import models

    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        dense = fluid.data(name="dense", shape=[32, 4], dtype="float32")
        sparse = fluid.data(name="sparse", shape=[32, 3], dtype="int64")
        label = fluid.data(name="label", shape=[32, 1], dtype="int64")
        pred = models.wide_deep(dense, sparse, vocab_size=50, embed_dim=8,
                                hidden_sizes=(16,),
                                is_distributed=is_distributed)
        loss = fluid.layers.mean(fluid.layers.cross_entropy(pred, label))
        fluid.optimizer.AdamOptimizer(1e-2).minimize(loss)
    return main, startup, loss


def _slice24_feeds(n):
    rng = np.random.RandomState(7)
    out = []
    for _ in range(n):
        sparse = rng.randint(0, 50, (32, 3)).astype("int64")
        out.append({"dense": rng.rand(32, 4).astype("float32"),
                    "sparse": sparse, "label": sparse[:, :1] % 2})
    return out


def _slice24_state(scope):
    return {n: scope.find_var(n).get_tensor().array.detach().cpu().numpy()
            .copy() for n in scope.local_var_names()
            if scope.find_var(n).is_initialized()
            and isinstance(getattr(scope.find_var(n).raw(), "array", None),
                           torch.Tensor)}


def _slice24_sync(trainer_place, start=None):
    from paddle_tpu_torch.distributed import ps_rpc
    from paddle_tpu_torch.ops import distributed_ops

    distributed_ops.reset_emulated_servers()
    eps = ["127.0.0.1:7164", "127.0.0.1:7165"]
    main, startup, loss = _slice24_wide_deep()
    t = fluid.DistributeTranspiler()
    t.transpile(0, program=main, startup_program=startup,
                pservers=",".join(eps), trainers=1)
    sexe = fluid.Executor(fluid.CPUPlace())
    sscopes, starts = {}, {}
    for ep in eps:
        ps = t.get_pserver_program(ep)
        sscopes[ep] = fluid.Scope()
        with fluid.scope_guard(sscopes[ep]):
            sexe.run(t.get_startup_program(ep, ps))
            if start is not None:
                for n, a in start[ep].items():
                    sscopes[ep].var(n).get_tensor().set(torch.from_numpy(a))
            starts[ep] = _slice24_state(sscopes[ep])
            sexe.run(ps)
    exe = fluid.Executor(trainer_place)
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        exe.run(startup)
        if start is not None:
            for n, a in start["trainer"].items():
                scope.var(n).get_tensor().set(
                    torch.from_numpy(a).to(exe.device))
        starts["trainer"] = _slice24_state(scope)
        ps_rpc.reset_copy_counts()
        losses = [float(np.asarray(exe.run(
            main, feed=f, fetch_list=[loss])[0]).ravel()[0])
            for f in _slice24_feeds(2)]
        copies = ps_rpc.copy_counts()
    return losses, {ep: _slice24_state(sscopes[ep]) for ep in eps}, \
        starts, copies


def test_slice24_a_sync_round_on_the_card_is_the_cpu_round(cuda):
    cpu = _slice24_sync(fluid.CPUPlace())
    card = _slice24_sync(fluid.CUDAPlace(0), start=cpu[2])
    np.testing.assert_allclose(card[0], cpu[0], rtol=1e-5)
    for ep, state in cpu[1].items():
        for n, a in state.items():
            if "@GRAD" in n:
                continue
            np.testing.assert_allclose(card[1][ep][n], a, rtol=1e-5,
                                       atol=1e-6, err_msg=n)
    # the card's trainer copies only at the PS ops: the ids down and the
    # pulled rows up at each lookup, grads down at each push and send,
    # params up at each recv
    assert cpu[3]["h2d"] == cpu[3]["d2h"] == 0
    assert card[3]["h2d"] > 0 and card[3]["d2h"] > 0


def test_slice24_k4_on_the_geo_trainer_update(cuda, monkeypatch):
    from paddle_tpu_torch import transpiler
    from paddle_tpu_torch.ops import distributed_ops

    monkeypatch.setenv("PADDLE_TPU_FUSED_OPTIMIZER", "1")

    def run(place, start=None):
        distributed_ops.reset_emulated_servers()
        distributed_ops.reset_geo_counters()
        main, startup, loss = _slice24_wide_deep(is_distributed=False)
        cfg = transpiler.DistributeTranspilerConfig()
        cfg.geo_sgd_need_push_nums = 2
        t = transpiler.GeoSgdTranspiler(cfg)
        t.transpile(0, program=main, startup_program=startup,
                    pservers="127.0.0.1:7166", trainers=1)
        exe = fluid.Executor(place)
        scope, sscope = fluid.Scope(), fluid.Scope()
        names = [p for p, _g in t.params_grads]
        with fluid.scope_guard(scope):
            exe.run(startup)
            if start is not None:
                for n in names:
                    for v in (n, n + ".geo.snapshot"):
                        scope.var(v).get_tensor().set(
                            torch.from_numpy(start[n]).to(exe.device))
        with fluid.scope_guard(sscope):
            for n in names:
                sscope.var(n).get_tensor().set(
                    scope.find_var(n).get_tensor().array.cpu().clone())
            fluid.Executor(fluid.CPUPlace()).run(
                t.get_pserver_program("127.0.0.1:7166"))
        init = {n: scope.find_var(n).get_tensor().numpy().copy()
                for n in names}
        support.reset_launch_counts()
        with fluid.scope_guard(scope):
            losses = [float(np.asarray(exe.run(
                main, feed=f, fetch_list=[loss])[0]).ravel()[0])
                for f in _slice24_feeds(4)]
        k4 = support.launch_counts()["fused_optimizer_update"]
        ops = [op.type for op in main.global_block().ops]
        server = {n: sscope.find_var(n).get_tensor().numpy() for n in names}
        trainer = {n: scope.find_var(n).get_tensor().numpy()
                   for n in names}
        return losses, k4, ops, server, trainer, init

    cpu = run(fluid.CPUPlace())
    card = run(fluid.CUDAPlace(0), start=cpu[5])
    assert card[2].count("fused_optimizer") == 1 and "adam" not in card[2]
    assert card[1] == 4  # K4 once a step
    np.testing.assert_allclose(card[0], cpu[0], rtol=1e-5)
    for n in card[3]:
        np.testing.assert_allclose(card[3][n], card[4][n], rtol=1e-6,
                                   atol=1e-7)
        np.testing.assert_allclose(card[3][n], cpu[3][n], rtol=1e-5,
                                   atol=1e-6)


# -- slice 25: the survivable parameter server --------------------------------

def _slice25_group_run(place, kill_after=None, rounds=4):
    """A primary + backup group of in-process ``PSServer``s over the
    pserver program of ``_slice24_wide_deep`` (its tables' sparse Adam and
    the dense blocks), their executors and scopes on ``place``, and one
    trainer on ``place`` through the transpiled program. ``kill_after``:
    the primary stops after that round and the backup takes over. Returns
    the serving member's state, the trainer's losses and the copies."""
    import os
    import socket

    from paddle_tpu_torch.distributed import ps_rpc
    from paddle_tpu_torch.ops import distributed_ops

    def free():
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
        s.close()
        return "127.0.0.1:%d" % port

    distributed_ops.reset_emulated_servers()
    eps = [free(), free()]
    saved = {k: os.environ.get(k) for k in (
        "PADDLE_PSERVER_ENDPOINTS", "PADDLE_PSERVER_SHARDS",
        "PADDLE_PS_LEASE_MS", "PADDLE_PS_FAILOVER_CONNECT_TIMEOUT",
        "PADDLE_PS_CONNECT_TIMEOUT")}
    os.environ.update({"PADDLE_PSERVER_ENDPOINTS": ",".join(eps),
                       "PADDLE_PSERVER_SHARDS": "1",
                       "PADDLE_PS_LEASE_MS": "600",
                       "PADDLE_PS_CONNECT_TIMEOUT": "2",
                       "PADDLE_PS_FAILOVER_CONNECT_TIMEOUT": "1"})
    servers = []
    try:
        main, startup, loss = _slice24_wide_deep()
        t = fluid.DistributeTranspiler()
        t.transpile(0, program=main, startup_program=startup,
                    pservers=eps[0], trainers=1)
        ps = t.get_pserver_program(eps[0])
        lsv = [op for op in ps.global_block().ops
               if op.type == "listen_and_serv"][0]
        for ep in eps:
            sexe = fluid.Executor(place)
            sexe._core.rng.seed = 123
            scope = fluid.Scope()
            with fluid.scope_guard(scope):
                sexe.run(t.get_startup_program(eps[0], ps))
            srv = ps_rpc.PSServer(ep, sexe._core, scope,
                                  distributed_ops._grad_to_block(lsv),
                                  fanin=1)
            srv.start_background()
            servers.append((srv, scope))
        exe = fluid.Executor(place)
        exe._core.rng.seed = 7
        tscope = fluid.Scope()
        with fluid.scope_guard(tscope):
            exe.run(startup)
        ps_rpc.reset_copy_counts()
        losses = []
        with fluid.scope_guard(tscope):
            for i, f in enumerate(_slice24_feeds(rounds)):
                losses.append(float(np.asarray(exe.run(
                    main, feed=f, fetch_list=[loss])[0]).ravel()[0]))
                if kill_after == i + 1:
                    servers[0][0].stop()
        copies = ps_rpc.copy_counts()
        serving = servers[1] if kill_after else servers[0]
        assert serving[0]._active_role()
        if kill_after:
            assert serving[0]._promoted
        return _slice24_state(serving[1]), losses, copies
    finally:
        for srv, _ in servers:
            srv.stop()
        ps_rpc.PSClient.reset()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def test_slice25_a_card_group_fails_over_bitwise(cuda):
    """A group whose executors hold their state on the card: the primary
    stops after round 2 of 4, the backup (its state streamed from the
    card through host copies) wins the election and the trainer fails
    over. The promoted backup's tables, moments and dense params are
    bitwise the unkilled group's, and the servers copied their card
    state down to hash and ship it (``copy_counts``)."""
    place = fluid.CUDAPlace(0)
    clean, clean_losses, _ = _slice25_group_run(place)
    got, losses, copies = _slice25_group_run(place, kill_after=2)
    assert losses == clean_losses
    assert set(got) == set(clean)
    for n, a in clean.items():
        assert got[n].tobytes() == a.tobytes(), n
    # every replicated round reads the primary's scope down: at least the
    # tables a round for rounds 1-2
    table_bytes = sum(a.nbytes for n, a in clean.items()
                      if n.startswith("embedding"))
    assert copies["d2h_bytes"] >= 2 * table_bytes, copies
    assert copies["h2d"] > 0
