// Flash-attention forward for NVIDIA Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel `_flash_kernel`, reached through
// `_flash_forward` (paddle_tpu/ops/pallas/flash_attention.py:118 and :184).
// It computes the same function: O = softmax(scale * Q K^T + mask) V and the
// per-row log-sum-exp LSE, with the online softmax kept in float32 whatever
// the input type, an optional causal mask and optional per-batch key lengths
// (keys at or past lengths[b] are invisible). A row that sees no key writes
// O = 0 and LSE = m + log(max(l, 1e-30)), never NaN. Query rows past the
// length are computed like any other row, as in the Pallas kernel. Q has
// S_q rows and K, V have S_kv (equal under `causal`, whose mask is the
// square one, as in the JAX package's dense path).
//
// What bounds it on this card. Per (batch, head) it does two S_q x S_kv x D
// products against O((S_q + S_kv) D) bytes: at the training shape (S 4096,
// D 64, causal) hundreds of FLOP per byte, so it is bound by operations;
// for float32 the least time is that of float32-accurate products on the
// tensor cores, the 3xTF32 split at a third of the dense TF32 rate (494.7 /
// 3 = 165 TFLOP/s), the route PyTorch's own float32 SDPA takes; bfloat16
// runs at 989 TFLOP/s. At the serving shape (S 128, D 64) it is bound by
// bytes, and by how many blocks are in flight: 2 query tiles x 96 heads.
// The S x S score matrix never reaches device memory. Design:
//
//  * Products on the tensor cores with mma.sync, with K2/K3's fragment
//    code (csrc/tensor_core.cuh, shared with them). float32 splits each
//    operand x into hi = tf32(x) (round to nearest) and lo = x - hi and
//    sums lo*hi + hi*lo + hi*hi with m16n8k8.tf32: one TF32 pass keeps
//    about three decimal digits and misses the float32 limit. The tensor
//    cores round their sums toward zero, so the twelve products of four
//    depth steps sum from zero and join the running sum by a float32 add,
//    which rounds to nearest; summed in place, O's running sum over 4096
//    keys drifts past the limit.
//    bfloat16 runs m16n8k16.bf16 with float32 accumulators, P rounded to
//    bf16 for P V, as in FA2.
//  * A warp owns 16 query rows, a block 4 warps (64 rows) and walks 64-key
//    tiles. S, the row max and the row sum stay in registers; row
//    reductions are quad shuffles; P is formed in registers and feeds P V
//    straight from them (the depth index of the m16n8k8 product is permuted
//    so that the accumulator layout serves as the A operand, and V's rows
//    are read in the same order). 64 rows keep the serving shape's 192
//    blocks all resident at once (two blocks an SM at D 64 in float32).
//  * Q is copied into shared memory once; K and V stream through a ring of
//    two stages by cp.async, 16 bytes a thread, so tile t + 1 loads while
//    tile t computes. Rows past the end are zero-filled by the copy.
//  * Shared rows are padded (float32 by 4 words, bf16 by 8 elements) so
//    every fragment load of a warp hits 32 distinct banks; bf16 column-wise
//    fragments come from ldmatrix.trans.
//  * Causal balance: blockIdx.x is the (batch, head) and blockIdx.y counts
//    query tiles from the last, so the longest walks start first.
//  * The walk stops at min(S_kv, lengths[b]) and, with `causal`, at the end
//    of the query tile, so padded and future keys are never loaded.
//
// Later work: wgmma (TF32 wgmma wants both operands K-major in shared
// memory; P V's V is not), TMA loads with mbarriers, warp specialisation.
//
// The kernel launches on the caller's stream, allocates nothing and does
// not synchronise. The entry point returns the cudaError_t of its launch.
// Q, K and V must be 16-byte aligned (the wrapper checks).

#include "tensor_core.cuh"

namespace {

constexpr int kThreads = 128;  // four warps
constexpr int kRows = 64;      // query rows a block owns: 16 a warp
constexpr int kWarpRows = 16;
constexpr int kCols = 64;      // keys per streamed tile
constexpr float kNegInf = -1e30f;  // mask value of the JAX kernel

template <class Op, int D>
constexpr size_t smem_bytes() {
  // Q, and two stages of K and V
  return sizeof(typename Op::T) * size_t(kRows + 4 * kCols) * (D + Op::kPad);
}

template <class Op, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const typename Op::T* __restrict__ q,
                 const typename Op::T* __restrict__ k,
                 const typename Op::T* __restrict__ v,
                 const int* __restrict__ lengths,
                 typename Op::T* __restrict__ o, float* __restrict__ lse,
                 int H, int S, int S_kv, int causal, float scale) {
  using T = typename Op::T;
  constexpr int kStride = D + Op::kPad;
  constexpr int kNT = kCols / 8;  // 8-wide tiles of S
  constexpr int kDT = D / 8;      // 8-wide tiles of O
  constexpr int kKTile = kCols * kStride;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);  // [kRows][kStride]
  T* kv = qs + kRows * kStride;  // stage s: K at kv + 2 s kKTile, V after

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;  // longest first
  const int warp = threadIdx.x >> 5;
  const int64_t qbase = int64_t(bh) * S * D;
  const int64_t kbase = int64_t(bh) * S_kv * D;
  const int kv_len =
      lengths == nullptr ? S_kv : min(S_kv, max(lengths[bh / H], 0));
  // keys past kv_end are invisible to every row of this tile
  const int kv_end = causal ? min(kv_len, q0 + kRows) : kv_len;
  const int n_tiles = (kv_end + kCols - 1) / kCols;

  const int qa = q0 + warp * kWarpRows + lane_g(), qb = qa + 8;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[kDT][4];
#pragma unroll
  for (int n = 0; n < kDT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  if (n_tiles > 0) {
    load_tile<kThreads, T, D, kRows, kStride>(qs, q + qbase, q0, S);
    load_tile<kThreads, T, D, kCols, kStride>(kv, k + kbase, 0, kv_end);
    load_tile<kThreads, T, D, kCols, kStride>(kv + kKTile, v + kbase, 0,
                                              kv_end);
    cp_async_commit();
    const T* qw = qs + warp * kWarpRows * kStride;

    for (int it = 0; it < n_tiles; ++it) {
      if (it + 1 < n_tiles) {  // the next tile loads while this one runs
        T* nxt = kv + ((it + 1) & 1) * 2 * kKTile;
        load_tile<kThreads, T, D, kCols, kStride>(
            nxt, k + kbase, (it + 1) * kCols, kv_end);
        load_tile<kThreads, T, D, kCols, kStride>(
            nxt + kKTile, v + kbase, (it + 1) * kCols, kv_end);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const T* ks = kv + (it & 1) * 2 * kKTile;
      const T* vs = ks + kKTile;
      const int k0 = it * kCols;

      float s[kNT][4];
#pragma unroll
      for (int n = 0; n < kNT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
      gemm_nk<Op, D, kNT>(s, qw, ks, kStride);
      // every key of the tile visible to every row of the block: no mask
      const bool open =
          k0 + kCols <= kv_len && (!causal || k0 + kCols <= q0 + 1);
      float tmax[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int n = 0; n < kNT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = e < 2 ? qa : qb;
          const int key = k0 + 8 * n + 2 * lane_t() + (e & 1);
          const bool vis = open || (key < kv_len && (!causal || key <= row));
          s[n][e] = vis ? s[n][e] * scale : kNegInf;
          tmax[e >> 1] = fmaxf(tmax[e >> 1], s[n][e]);
        }
      float alpha[2], psum[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 1));
        tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 2));
        const float m_new = fmaxf(m[r], tmax[r]);
        alpha[r] = expf(m[r] - m_new);
        m[r] = m_new;
      }
#pragma unroll
      for (int n = 0; n < kNT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          // a masked score is exactly kNegInf; it gets p = 0 outright
          const float p = s[n][e] == kNegInf ? 0.f : expf(s[n][e] - m[r]);
          s[n][e] = p;
          psum[r] += p;
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        psum[r] += __shfl_xor_sync(0xffffffffu, psum[r], 1);
        psum[r] += __shfl_xor_sync(0xffffffffu, psum[r], 2);
        l[r] = l[r] * alpha[r] + psum[r];
      }
#pragma unroll
      for (int n = 0; n < kDT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] *= alpha[e >> 1];
      gemm_kn<Op, kCols, kDT>(acc, s, vs, kStride);
      __syncthreads();  // this stage is consumed before it is refilled
    }
  }

  const float l_a = fmaxf(l[0], 1e-30f), l_b = fmaxf(l[1], 1e-30f);
  const float inv_a = 1.f / l_a, inv_b = 1.f / l_b;
#pragma unroll
  for (int n = 0; n < kDT; ++n) {
    const int c = 8 * n + 2 * lane_t();
    if (qa < S)
      Op::store2(o + qbase + int64_t(qa) * D + c, acc[n][0] * inv_a,
                 acc[n][1] * inv_a);
    if (qb < S)
      Op::store2(o + qbase + int64_t(qb) * D + c, acc[n][2] * inv_b,
                 acc[n][3] * inv_b);
  }
  if (lane_t() == 0) {
    if (qa < S) lse[int64_t(bh) * S + qa] = m[0] + logf(l_a);
    if (qb < S) lse[int64_t(bh) * S + qb] = m[1] + logf(l_b);
  }
}

template <class Op, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* lengths, void* o, float* lse, int B, int H,
                   int S, int S_kv, int causal, float scale,
                   cudaStream_t stream) {
  using T = typename Op::T;
  static std::atomic<size_t> done[kMaxDevices];
  auto kernel = flash_fwd_kernel<Op, D>;
  const size_t smem = smem_bytes<Op, D>();
  cudaError_t err = raise_smem_limit(kernel, smem, done);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (S + kRows - 1) / kRows);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lengths, static_cast<T*>(o), lse, H, S, S_kv,
      causal, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q, o: contiguous, 16-byte aligned [B, H, S, D]; k, v: [B, H, S_kv, D]
// (S_kv = S when causal), float32 (is_bf16 = 0) or bfloat16 (is_bf16 = 1);
// lengths: [B] int32 on the device, or null; lse: [B*H, S] float32. D must
// be 64 or 128, B*H and ceil(S / 64) at most 65535.
int paddle_flash_attention_forward(const void* q, const void* k,
                                   const void* v, const int* lengths,
                                   void* o, float* lse, int B, int H, int S,
                                   int S_kv, int D, int is_bf16, int causal,
                                   float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (causal && S != S_kv) return int(cudaErrorInvalidValue);
  if (D == 64 && !is_bf16)
    return launch<Tf32x3, 64>(q, k, v, lengths, o, lse, B, H, S, S_kv, causal, scale, st);
  if (D == 128 && !is_bf16)
    return launch<Tf32x3, 128>(q, k, v, lengths, o, lse, B, H, S, S_kv, causal, scale, st);
  if (D == 64 && is_bf16)
    return launch<Bf16, 64>(q, k, v, lengths, o, lse, B, H, S, S_kv, causal, scale, st);
  if (D == 128 && is_bf16)
    return launch<Bf16, 128>(q, k, v, lengths, o, lse, B, H, S, S_kv, causal, scale, st);
  return int(cudaErrorInvalidValue);
}

const char* paddle_flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
