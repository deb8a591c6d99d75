// Flash-attention backward for NVIDIA Hopper (sm_90a), plain C interface:
// two kernels, as in the Pallas module.
//
// Replaces the Pallas TPU kernels `_flash_bwd_dq_kernel` (K2) and
// `_flash_bwd_dkv_kernel` (K3), reached through `_flash_backward`
// (paddle_tpu/ops/pallas/flash_attention.py:254, :308 and :367). Given Q,
// K, V, dO, the forward's per-row log-sum-exp LSE and delta = rowsum(dO * O)
// (computed by the caller, as the JAX package computes it outside Pallas),
// they recompute the probabilities P = exp(scale * Q K^T - LSE) tile by tile
// and return
//
//   dQ = scale * (P * (dO V^T - delta)) K                     (K2)
//   dV = P^T dO,  dK = scale * (P * (dO V^T - delta))^T Q     (K3)
//
// with the forward's masks: causal (key k visible to query q iff k <= q)
// and per-batch key lengths (keys at or past lengths[b] are invisible). A
// masked element gets p = 0 outright; it is never computed as exp(0). A row
// of a batch with length 0 sees no key and gets dQ = 0; keys past the length
// get dK = dV = 0. Query rows past the length are computed like any other,
// as in the forward.
//
// What bounds it on this card. Per (batch, head) K2 does three S x S x D
// products and K3 four, against O(S D) bytes: at the training shape (S =
// 4096, D = 64, causal) hundreds of FLOP per byte, so both are bound by
// operations. For float32 the least time is that of float32-accurate
// products on the tensor cores: the 3xTF32 split (below) at a third of the
// dense TF32 rate, 494.7 / 3 = 165 TFLOP/s, the route PyTorch's own float32
// SDPA backward takes. bfloat16 runs at the bf16 rate, 989 TFLOP/s. No two
// blocks write the same output, so there are no atomics and every run gives
// the same bits; the S x S matrices never reach device memory.
//
// Design (the fragment code is in csrc/tensor_core.cuh, shared with K1
// and K6):
//  * Products on the tensor cores with mma.sync. float32 splits each
//    operand x into hi = tf32(x) (round to nearest) and lo = x - hi, and
//    sums lo*hi + hi*lo + hi*hi in float32 with m16n8k8.tf32 (3xTF32): one
//    TF32 pass alone keeps about three decimal digits and misses the
//    float32 limit. The tensor cores round their sums toward zero, so the
//    twelve products of four depth steps sum from zero and join the
//    running sum by a float32 add (rounding to nearest); summed in place,
//    the sums drifted past the float32 limit over a walk of 4096 keys.
//    The split happens in registers as a fragment is loaded (three integer
//    and float operations an element; lo is left for the tensor cores to
//    cut to tf32), not once per staged tile, which would double the
//    shared memory and halve the blocks an SM holds.
//    bfloat16 runs m16n8k16.bf16 with float32 accumulators; P and dS are
//    rounded to bf16 for the second products, as in FA2.
//  * Each warp owns 16 rows: query rows in K2, keys in K3. A block is 4
//    warps over a 64-row tile and walks the other axis: K2 64-key tiles of
//    K and V, K3 query tiles of Q, dO, LSE and delta (64 rows at D = 64, 32
//    at D = 128, to keep dK, dV, S and dP in registers). S and dP of the
//    warp's rows are computed into registers; P and dS are formed there with
//    the masks and feed the second products straight from registers. The
//    accumulator layout of m16n8k16 is its A-operand layout; for m16n8k8
//    it is not, so the depth index of those products is permuted (logical
//    column t is column 2t of an 8-wide tile, t + 4 is 2t + 1) and the B
//    operand's rows are read in the same order. K3 works on S^T, so all
//    four of its products stay within the warp's keys.
//  * dQ (K2) and dK, dV (K3) accumulate in float32 registers over the whole
//    walk and are written once.
//  * Streamed tiles arrive by cp.async (16 bytes a thread; LSE and delta 4)
//    into a ring of two stages: tile t + 1 loads while tile t computes.
//    Rows past the end are zero-filled by the copy.
//  * Shared rows are padded (float32 by 4 words, bf16 by 8 elements) so
//    that every fragment load of a warp, row- or column-wise, hits 32
//    distinct banks; bf16 column-wise fragments come from ldmatrix.trans.
//  * Shared memory: K2 6 tiles of 64 rows (Q, dO, two stages of K and V),
//    K3 K and V plus two stages of Q, dO, LSE and delta: 104 KB at D = 64
//    in float32, two blocks an SM.
//  * Causal balance: blockIdx.x is the (batch, head) and blockIdx.y the
//    tile, so every head's longest walks start first: K2 takes the query
//    tiles from the last, K3 the key tiles from the first.
//
// Later work: wgmma (TF32 wgmma wants both operands K-major in shared
// memory, which dV = P^T dO and dK = dS^T Q are not), TMA loads with
// mbarriers, warp specialisation, and a persistent grid.
//
// The kernels launch on the caller's stream, allocate nothing and do not
// synchronise. Each entry point returns the cudaError_t of its launch. Q,
// K, V and dO must be 16-byte aligned (the wrapper checks).

#include "tensor_core.cuh"

namespace {

constexpr int kThreads = 128;  // four warps
constexpr int kRows = 64;      // rows a block owns: 16 a warp
constexpr int kWarpRows = 16;

__device__ __forceinline__ int key_length(const int* lengths, int bh, int H,
                                          int S) {
  return lengths == nullptr ? S : min(S, max(lengths[bh / H], 0));
}

// an accumulator strip [16][8 NT] times `mul` into rows r0.. of a [S, D]
// slice, rows at or past S skipped
template <class Op, int NT>
__device__ __forceinline__ void store_strip(typename Op::T* dst,
                                            const float (*acc)[4], int r0,
                                            int S, int D, float mul) {
  const int ra = r0 + lane_g(), rb = ra + 8;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int c = 8 * n + 2 * lane_t();
    if (ra < S)
      Op::store2(dst + int64_t(ra) * D + c, acc[n][0] * mul,
                 acc[n][1] * mul);
    if (rb < S)
      Op::store2(dst + int64_t(rb) * D + c, acc[n][2] * mul,
                 acc[n][3] * mul);
  }
}

// K3's streamed tile of queries: 64 at D = 64, 32 at D = 128
template <int D>
constexpr int kDkvCols = D == 64 ? 64 : 32;

template <class Op, int D>
constexpr size_t dq_smem_bytes() {
  // Q, dO, and two stages of K and V
  return sizeof(typename Op::T) * size_t(6) * kRows * (D + Op::kPad);
}

template <class Op, int D>
constexpr size_t dkv_smem_bytes() {
  // K, V, two stages of Q and dO, two stages of LSE and delta
  return sizeof(typename Op::T) * size_t(2 * kRows + 4 * kDkvCols<D>) *
             (D + Op::kPad) +
         sizeof(float) * 4 * kDkvCols<D>;
}

// ---------------------------------------------------------------- K2: dQ

template <class Op, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const typename Op::T* __restrict__ q,
                    const typename Op::T* __restrict__ k,
                    const typename Op::T* __restrict__ v,
                    const typename Op::T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    const int* __restrict__ lengths,
                    typename Op::T* __restrict__ dq, int H, int S,
                    int causal, float scale) {
  using T = typename Op::T;
  constexpr int kStride = D + Op::kPad;
  constexpr int kCols = 64;          // keys per streamed tile
  constexpr int kNT = kCols / 8;     // 8-wide tiles of S and dP
  constexpr int kDT = D / 8;         // 8-wide tiles of dQ
  constexpr int kTile = kRows * kStride;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);  // [kRows][kStride]
  T* dos = qs + kTile;                     // [kRows][kStride]
  T* kv = dos + kTile;  // stage s: K at kv + 2 s kTile, V after it

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;  // longest first
  const int warp = threadIdx.x >> 5;
  const int64_t base = int64_t(bh) * S * D;
  const int kv_len = key_length(lengths, bh, H, S);
  const int kv_end = causal ? min(kv_len, q0 + kRows) : kv_len;
  const int n_tiles = (kv_end + kCols - 1) / kCols;

  float acc[kDT][4];
#pragma unroll
  for (int n = 0; n < kDT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  if (n_tiles > 0) {
    load_tile<kThreads, T, D, kRows, kStride>(qs, q + base, q0, S);
    load_tile<kThreads, T, D, kRows, kStride>(dos, dout + base, q0, S);
    load_tile<kThreads, T, D, kCols, kStride>(kv, k + base, 0, kv_end);
    load_tile<kThreads, T, D, kCols, kStride>(kv + kTile, v + base, 0, kv_end);
    cp_async_commit();

    const int qa = q0 + warp * kWarpRows + lane_g(), qb = qa + 8;
    const float lse_a = qa < S ? lse[int64_t(bh) * S + qa] : 0.f;
    const float lse_b = qb < S ? lse[int64_t(bh) * S + qb] : 0.f;
    const float del_a = qa < S ? delta[int64_t(bh) * S + qa] : 0.f;
    const float del_b = qb < S ? delta[int64_t(bh) * S + qb] : 0.f;
    const T* qw = qs + warp * kWarpRows * kStride;
    const T* dow = dos + warp * kWarpRows * kStride;

    for (int it = 0; it < n_tiles; ++it) {
      if (it + 1 < n_tiles) {  // the next tile loads while this one runs
        T* nxt = kv + ((it + 1) & 1) * 2 * kTile;
        load_tile<kThreads, T, D, kCols, kStride>(
            nxt, k + base, (it + 1) * kCols, kv_end);
        load_tile<kThreads, T, D, kCols, kStride>(
            nxt + kTile, v + base, (it + 1) * kCols, kv_end);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const T* ks = kv + (it & 1) * 2 * kTile;
      const T* vs = ks + kTile;
      const int k0 = it * kCols;

      float s[kNT][4], dp[kNT][4];
#pragma unroll
      for (int n = 0; n < kNT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
      gemm_nk<Op, D, kNT>(s, qw, ks, kStride);
      gemm_nk<Op, D, kNT>(dp, dow, vs, kStride);
      // every key of the tile visible to every row of the block: no mask
      const bool open = k0 + kCols <= kv_len && q0 + kRows <= S &&
                        (!causal || k0 + kCols <= q0 + 1);
#pragma unroll
      for (int n = 0; n < kNT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = e < 2 ? qa : qb;
          const int key = k0 + 8 * n + 2 * lane_t() + (e & 1);
          const bool vis =
              open || (row < S && key < kv_len && (!causal || key <= row));
          const float p =
              vis ? expf(s[n][e] * scale - (e < 2 ? lse_a : lse_b)) : 0.f;
          s[n][e] = p * (dp[n][e] - (e < 2 ? del_a : del_b));  // dS
        }
      gemm_kn<Op, kCols, kDT>(acc, s, ks, kStride);
      __syncthreads();  // this stage is consumed before it is refilled
    }
  }
  store_strip<Op, kDT>(dq + base, acc, q0 + warp * kWarpRows, S, D, scale);
}

// ---------------------------------------------------------- K3: dK and dV

template <class Op, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const typename Op::T* __restrict__ q,
                     const typename Op::T* __restrict__ k,
                     const typename Op::T* __restrict__ v,
                     const typename Op::T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     const int* __restrict__ lengths,
                     typename Op::T* __restrict__ dk,
                     typename Op::T* __restrict__ dv, int H, int S,
                     int causal, float scale) {
  using T = typename Op::T;
  constexpr int kStride = D + Op::kPad;
  constexpr int kCols = kDkvCols<D>;  // queries per streamed tile
  constexpr int kNT = kCols / 8;        // 8-wide tiles of S^T and dP^T
  constexpr int kDT = D / 8;            // 8-wide tiles of dK and dV
  constexpr int kKeyTile = kRows * kStride;
  constexpr int kQTile = kCols * kStride;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ks = reinterpret_cast<T*>(smem_raw);  // [kRows][kStride]
  T* vs = ks + kKeyTile;                   // [kRows][kStride]
  T* qd = vs + kKeyTile;  // stage s: Q at qd + 2 s kQTile, dO after it
  float* stats = reinterpret_cast<float*>(qd + 4 * kQTile);
  // stage s: LSE at stats + 2 s kCols, delta after it

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * kRows;  // the first key tiles walk longest
  const int warp = threadIdx.x >> 5;
  const int64_t base = int64_t(bh) * S * D;
  const int64_t row_base = int64_t(bh) * S;
  const int kv_len = key_length(lengths, bh, H, S);

  float dk_acc[kDT][4], dv_acc[kDT][4];
#pragma unroll
  for (int n = 0; n < kDT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;

  if (k0 < kv_len) {  // else no query sees this tile: dK = dV = 0
    // with `causal`, queries before the key tile see none of it
    const int q_begin = causal ? (k0 / kCols) * kCols : 0;
    const int n_tiles = (S - q_begin + kCols - 1) / kCols;
    auto load_stage = [&](int it) {
      T* qs = qd + (it & 1) * 2 * kQTile;
      float* st = stats + (it & 1) * 2 * kCols;
      const int i0 = q_begin + it * kCols;
      load_tile<kThreads, T, D, kCols, kStride>(qs, q + base, i0, S);
      load_tile<kThreads, T, D, kCols, kStride>(qs + kQTile, dout + base, i0,
                                                S);
      for (int i = threadIdx.x; i < kCols; i += kThreads) {
        const bool ok = i0 + i < S;
        const int64_t r = row_base + (ok ? i0 + i : 0);
        cp_async_4(st + i, lse + r, ok);
        cp_async_4(st + kCols + i, delta + r, ok);
      }
    };
    load_tile<kThreads, T, D, kRows, kStride>(ks, k + base, k0, kv_len);
    load_tile<kThreads, T, D, kRows, kStride>(vs, v + base, k0, kv_len);
    load_stage(0);
    cp_async_commit();

    const int ka = k0 + warp * kWarpRows + lane_g(), kb = ka + 8;
    const T* kw = ks + warp * kWarpRows * kStride;
    const T* vw = vs + warp * kWarpRows * kStride;

    for (int it = 0; it < n_tiles; ++it) {
      if (it + 1 < n_tiles) {  // the next tile loads while this one runs
        load_stage(it + 1);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const T* qs = qd + (it & 1) * 2 * kQTile;
      const T* dos = qs + kQTile;
      const float* lse_s = stats + (it & 1) * 2 * kCols;
      const float* del_s = lse_s + kCols;
      const int i0 = q_begin + it * kCols;

      float s[kNT][4], dp[kNT][4];  // S^T, dP^T: [key][query]
#pragma unroll
      for (int n = 0; n < kNT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
      gemm_nk<Op, D, kNT>(s, kw, qs, kStride);
      gemm_nk<Op, D, kNT>(dp, vw, dos, kStride);
      // every query of the tile sees every key of the block: no mask
      const bool open = i0 + kCols <= S && k0 + kRows <= kv_len &&
                        (!causal || k0 + kRows <= i0 + 1);
#pragma unroll
      for (int n = 0; n < kNT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = e < 2 ? ka : kb;
          const int col = 8 * n + 2 * lane_t() + (e & 1);
          const int qpos = i0 + col;
          const bool vis = open || (qpos < S && key < kv_len &&
                                    (!causal || key <= qpos));
          const float p = vis ? expf(s[n][e] * scale - lse_s[col]) : 0.f;
          s[n][e] = p;                             // P^T
          dp[n][e] = p * (dp[n][e] - del_s[col]);  // dS^T
        }
      gemm_kn<Op, kCols, kDT>(dv_acc, s, dos, kStride);
      gemm_kn<Op, kCols, kDT>(dk_acc, dp, qs, kStride);
      __syncthreads();  // this stage is consumed before it is refilled
    }
  }
  const int r0 = k0 + warp * kWarpRows;
  store_strip<Op, kDT>(dk + base, dk_acc, r0, S, D, scale);
  store_strip<Op, kDT>(dv + base, dv_acc, r0, S, D, 1.f);
}

template <class Op, int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const float* delta,
                      const int* lengths, void* dq, int B, int H, int S,
                      int causal, float scale, cudaStream_t stream) {
  using T = typename Op::T;
  static std::atomic<size_t> done[kMaxDevices];
  auto kernel = flash_bwd_dq_kernel<Op, D>;
  const size_t smem = dq_smem_bytes<Op, D>();
  cudaError_t err = raise_smem_limit(kernel, smem, done);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (S + kRows - 1) / kRows);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      lengths, static_cast<T*>(dq), H, S, causal, scale);
  return cudaGetLastError();
}

template <class Op, int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const float* lse,
                       const float* delta, const int* lengths, void* dk,
                       void* dv, int B, int H, int S, int causal, float scale,
                       cudaStream_t stream) {
  using T = typename Op::T;
  static std::atomic<size_t> done[kMaxDevices];
  auto kernel = flash_bwd_dkv_kernel<Op, D>;
  const size_t smem = dkv_smem_bytes<Op, D>();
  cudaError_t err = raise_smem_limit(kernel, smem, done);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (S + kRows - 1) / kRows);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      lengths, static_cast<T*>(dk), static_cast<T*>(dv), H, S, causal,
      scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q, k, v, dout, dq: contiguous, 16-byte aligned [B, H, S, D] of float32
// (is_bf16 = 0) or bfloat16 (is_bf16 = 1); lse, delta: [B*H, S] float32;
// lengths: [B] int32 on the device, or null. D must be 64 or 128, and
// ceil(S / 64) at most 65535.
int paddle_flash_attention_backward_dq(const void* q, const void* k,
                                       const void* v, const void* dout,
                                       const float* lse, const float* delta,
                                       const int* lengths, void* dq, int B,
                                       int H, int S, int D, int is_bf16,
                                       int causal, float scale,
                                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64 && !is_bf16)
    return launch_dq<Tf32x3, 64>(q, k, v, dout, lse, delta, lengths, dq, B, H, S, causal, scale, st);
  if (D == 128 && !is_bf16)
    return launch_dq<Tf32x3, 128>(q, k, v, dout, lse, delta, lengths, dq, B, H, S, causal, scale, st);
  if (D == 64 && is_bf16)
    return launch_dq<Bf16, 64>(q, k, v, dout, lse, delta, lengths, dq, B, H, S, causal, scale, st);
  if (D == 128 && is_bf16)
    return launch_dq<Bf16, 128>(q, k, v, dout, lse, delta, lengths, dq, B, H, S, causal, scale, st);
  return int(cudaErrorInvalidValue);
}

// as above, writing dk and dv (each [B, H, S, D] of the input type)
int paddle_flash_attention_backward_dkv(const void* q, const void* k,
                                        const void* v, const void* dout,
                                        const float* lse, const float* delta,
                                        const int* lengths, void* dk,
                                        void* dv, int B, int H, int S, int D,
                                        int is_bf16, int causal, float scale,
                                        void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64 && !is_bf16)
    return launch_dkv<Tf32x3, 64>(q, k, v, dout, lse, delta, lengths, dk, dv, B, H, S, causal, scale, st);
  if (D == 128 && !is_bf16)
    return launch_dkv<Tf32x3, 128>(q, k, v, dout, lse, delta, lengths, dk, dv, B, H, S, causal, scale, st);
  if (D == 64 && is_bf16)
    return launch_dkv<Bf16, 64>(q, k, v, dout, lse, delta, lengths, dk, dv, B, H, S, causal, scale, st);
  if (D == 128 && is_bf16)
    return launch_dkv<Bf16, 128>(q, k, v, dout, lse, delta, lengths, dk, dv, B, H, S, causal, scale, st);
  return int(cudaErrorInvalidValue);
}

const char* paddle_flash_attention_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
