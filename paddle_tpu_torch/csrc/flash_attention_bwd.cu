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
//   dQ = scale * (P * (dO V^T - delta)) K            (K2)
//   dV = P^T dO,  dK = scale * (P * (dO V^T - delta))^T Q   (K3)
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
// 4096, D = 64, causal) that is hundreds of FLOP per byte, so both are
// bound by operations. Like the forward, this first version runs its
// products on the float32 CUDA cores (67 TFLOP/s); wgmma and TMA are later
// work. What the design keeps from the Pallas kernels is that the S x S
// matrices never reach device memory, and that no two blocks write the same
// output, so there are no atomics and every run gives the same bits:
//
//  * K2: one block of 128 threads per (64-row query tile, batch * head);
//    two threads share a query row, each owning the interleaved half of the
//    keys of a tile and of the columns of dQ. Q (scaled) and dO of the tile
//    are staged once; the block walks 64-key tiles of K and V, stopping at
//    the length and, with `causal`, at the end of the query tile. dS goes
//    through one shared row per query; dQ stays in registers.
//  * K3: one block of 128 threads per (64-key tile, batch * head); two
//    threads share a key, each owning the interleaved half of the query
//    rows of a tile and of the columns of dK and dV. K and V of the tile
//    are staged once; the block walks 64-row query tiles from the
//    diagonal (with `causal`) to S. P^T and dS^T go through shared rows;
//    dK and dV stay in registers. A key tile wholly past the length writes
//    zeros without walking.
//
// Shared tiles are float32 with rows padded to D + 1 so that the column
// reads of a warp fall in distinct banks. The kernels launch on the
// caller's stream, allocate nothing and do not synchronise. Each entry
// point returns the cudaError_t of its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kBlockQ = 64;            // query rows per tile
constexpr int kBlockK = 64;            // keys per tile
constexpr int kThreads = 128;          // two threads per row (or key)
constexpr int kPStride = 65;           // padded row of a P / dS tile

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ int key_length(const int* lengths, int bh, int H,
                                          int S) {
  return lengths == nullptr ? S : min(S, max(lengths[bh / H], 0));
}

// rows [r0, r0 + 64) of a [S, D] slice into a [64][D + 1] float tile,
// times `mul`; rows at or past `end` read as zeros
template <typename T, int D>
__device__ __forceinline__ void stage(float* dst, const T* src, int r0,
                                      int end, float mul) {
  for (int i = threadIdx.x; i < 64 * D; i += kThreads) {
    const int r = i / D, c = i - r * D;
    dst[r * (D + 1) + c] =
        r0 + r < end ? to_float(src[int64_t(r0 + r) * D + c]) * mul : 0.f;
  }
}

template <int D>
__device__ __forceinline__ float dot_rows(const float* a, const float* b) {
  float s = 0.f;
#pragma unroll 16
  for (int d = 0; d < D; ++d) s += a[d] * b[d];
  return s;
}

template <int D>
constexpr size_t dq_smem_bytes() {
  return sizeof(float) * (size_t(4) * 64 * (D + 1) + kBlockQ * kPStride);
}

template <int D>
constexpr size_t dkv_smem_bytes() {
  return sizeof(float) *
         (size_t(4) * 64 * (D + 1) + 2 * kBlockK * kPStride + 2 * kBlockQ);
}

// ---------------------------------------------------------------- K2: dQ

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    const int* __restrict__ lengths, T* __restrict__ dq,
                    int H, int S, int causal, float scale) {
  constexpr int kStride = D + 1;
  constexpr int kHalfD = D / 2;
  constexpr int kHalfK = kBlockK / 2;
  extern __shared__ float smem[];
  float* qs = smem;                      // [kBlockQ][kStride], Q * scale
  float* dos = qs + kBlockQ * kStride;   // [kBlockQ][kStride], dO
  float* ks = dos + kBlockQ * kStride;   // [kBlockK][kStride]
  float* vs = ks + kBlockK * kStride;    // [kBlockK][kStride]
  float* dss = vs + kBlockK * kStride;   // [kBlockQ][kPStride], dS

  const int tid = threadIdx.x;
  const int row = tid >> 1;
  const int half = tid & 1;
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kBlockQ;
  const int qrow = q0 + row;
  const int64_t base = int64_t(bh) * S * D;

  const int kv_len = key_length(lengths, bh, H, S);
  const int kv_end = causal ? min(kv_len, q0 + kBlockQ) : kv_len;

  stage<T, D>(qs, q + base, q0, S, scale);
  stage<T, D>(dos, dout + base, q0, S, 1.f);
  const float row_lse = qrow < S ? lse[int64_t(bh) * S + qrow] : 0.f;
  const float row_delta = qrow < S ? delta[int64_t(bh) * S + qrow] : 0.f;

  float acc[kHalfD];
#pragma unroll
  for (int i = 0; i < kHalfD; ++i) acc[i] = 0.f;

  for (int k0 = 0; k0 < kv_end; k0 += kBlockK) {
    __syncthreads();  // the previous tile is consumed (and Q, dO staged)
    stage<T, D>(ks, k + base, k0, kv_end, 1.f);
    stage<T, D>(vs, v + base, k0, kv_end, 1.f);
    __syncthreads();

    const float* qr = qs + row * kStride;
    const float* dr = dos + row * kStride;
#pragma unroll 4
    for (int jj = 0; jj < kHalfK; ++jj) {
      const int j = 2 * jj + half;
      const int kpos = k0 + j;
      const bool vis = qrow < S && kpos < kv_len && (!causal || kpos <= qrow);
      float ds = 0.f;
      if (vis) {
        const float p = expf(dot_rows<D>(qr, ks + j * kStride) - row_lse);
        ds = p * (dot_rows<D>(dr, vs + j * kStride) - row_delta);
      }
      dss[row * kPStride + j] = ds;
    }
    __syncwarp();  // both halves of the dS row are written (same warp)

    const float* dsr = dss + row * kPStride;
    for (int j = 0; j < kBlockK; ++j) {
      const float ds = dsr[j];
      const float* kr = ks + j * kStride + half;
#pragma unroll
      for (int i = 0; i < kHalfD; ++i) acc[i] += ds * kr[2 * i];
    }
  }

  if (qrow < S) {
    T* out = dq + base + int64_t(qrow) * D + half;
#pragma unroll
    for (int i = 0; i < kHalfD; ++i) out[2 * i] = from_float<T>(acc[i] * scale);
  }
}

// ---------------------------------------------------------- K3: dK and dV

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     const int* __restrict__ lengths, T* __restrict__ dk,
                     T* __restrict__ dv, int H, int S, int causal,
                     float scale) {
  constexpr int kStride = D + 1;
  constexpr int kHalfD = D / 2;
  constexpr int kHalfQ = kBlockQ / 2;
  extern __shared__ float smem[];
  float* ks = smem;                      // [kBlockK][kStride]
  float* vs = ks + kBlockK * kStride;    // [kBlockK][kStride]
  float* qs = vs + kBlockK * kStride;    // [kBlockQ][kStride], Q * scale
  float* dos = qs + kBlockQ * kStride;   // [kBlockQ][kStride], dO
  float* pts = dos + kBlockQ * kStride;  // [kBlockK][kPStride], P^T
  float* dst = pts + kBlockK * kPStride; // [kBlockK][kPStride], dS^T
  float* lse_s = dst + kBlockK * kPStride;  // [kBlockQ]
  float* delta_s = lse_s + kBlockQ;         // [kBlockQ]

  const int tid = threadIdx.x;
  const int key = tid >> 1;    // key inside the tile
  const int half = tid & 1;    // which interleaved half this thread owns
  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * kBlockK;
  const int kpos = k0 + key;
  const int64_t base = int64_t(bh) * S * D;
  const int kv_len = key_length(lengths, bh, H, S);

  float dk_acc[kHalfD], dv_acc[kHalfD];
#pragma unroll
  for (int i = 0; i < kHalfD; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  if (k0 < kv_len) {  // else no query sees this tile: dK = dV = 0
    stage<T, D>(ks, k + base, k0, kv_len, 1.f);
    stage<T, D>(vs, v + base, k0, kv_len, 1.f);
    // with `causal`, query tiles above this key tile see none of it
    const int q_begin = causal ? (k0 / kBlockQ) * kBlockQ : 0;
    const float* kr = ks + key * kStride;
    const float* vr = vs + key * kStride;
    for (int q0 = q_begin; q0 < S; q0 += kBlockQ) {
      __syncthreads();  // the previous tile is consumed (and K, V staged)
      stage<T, D>(qs, q + base, q0, S, scale);
      stage<T, D>(dos, dout + base, q0, S, 1.f);
      if (tid < kBlockQ) {
        const bool in = q0 + tid < S;
        lse_s[tid] = in ? lse[int64_t(bh) * S + q0 + tid] : 0.f;
        delta_s[tid] = in ? delta[int64_t(bh) * S + q0 + tid] : 0.f;
      }
      __syncthreads();

#pragma unroll 4
      for (int ii = 0; ii < kHalfQ; ++ii) {
        const int i = 2 * ii + half;
        const int qpos = q0 + i;
        const bool vis = qpos < S && kpos < kv_len && (!causal || kpos <= qpos);
        float p = 0.f, ds = 0.f;
        if (vis) {
          p = expf(dot_rows<D>(qs + i * kStride, kr) - lse_s[i]);
          ds = p * (dot_rows<D>(dos + i * kStride, vr) - delta_s[i]);
        }
        pts[key * kPStride + i] = p;
        dst[key * kPStride + i] = ds;
      }
      __syncwarp();  // both halves of this key's rows are written

      const float* pr = pts + key * kPStride;
      const float* dr = dst + key * kPStride;
      for (int i = 0; i < kBlockQ; ++i) {
        const float p = pr[i], ds = dr[i];
        const float* dor = dos + i * kStride + half;
        const float* qr = qs + i * kStride + half;
#pragma unroll
        for (int c = 0; c < kHalfD; ++c) {
          dv_acc[c] += p * dor[2 * c];
          dk_acc[c] += ds * qr[2 * c];  // Q is staged times scale
        }
      }
    }
  }

  if (kpos < S) {
    T* dko = dk + base + int64_t(kpos) * D + half;
    T* dvo = dv + base + int64_t(kpos) * D + half;
#pragma unroll
    for (int c = 0; c < kHalfD; ++c) {
      dko[2 * c] = from_float<T>(dk_acc[c]);
      dvo[2 * c] = from_float<T>(dv_acc[c]);
    }
  }
}

constexpr int kMaxDevices = 64;

// The staged tiles exceed the default 48 KB of dynamic shared memory, so
// each kernel instantiation raises its limit once per device, not per
// launch. Two threads racing here both set the same value, which is
// harmless.
template <typename Kernel>
cudaError_t raise_smem_limit_once(Kernel kernel, size_t bytes,
                                  std::atomic<bool>* done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && done[dev].load(std::memory_order_acquire))
    return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(bytes));
  if (err == cudaSuccess && dev < kMaxDevices)
    done[dev].store(true, std::memory_order_release);
  return err;
}

template <typename T, int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const float* delta,
                      const int* lengths, void* dq, int B, int H, int S,
                      int causal, float scale, cudaStream_t stream) {
  static std::atomic<bool> done[kMaxDevices];
  auto kernel = flash_bwd_dq_kernel<T, D>;
  const size_t smem = dq_smem_bytes<D>();
  cudaError_t err = raise_smem_limit_once(kernel, smem, done);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kBlockQ - 1) / kBlockQ, B * H);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      lengths, static_cast<T*>(dq), H, S, causal, scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const float* lse,
                       const float* delta, const int* lengths, void* dk,
                       void* dv, int B, int H, int S, int causal, float scale,
                       cudaStream_t stream) {
  static std::atomic<bool> done[kMaxDevices];
  auto kernel = flash_bwd_dkv_kernel<T, D>;
  const size_t smem = dkv_smem_bytes<D>();
  cudaError_t err = raise_smem_limit_once(kernel, smem, done);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kBlockK - 1) / kBlockK, B * H);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      lengths, static_cast<T*>(dk), static_cast<T*>(dv), H, S, causal,
      scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q, k, v, dout, dq: contiguous [B, H, S, D] of float32 (is_bf16 = 0) or
// bfloat16 (is_bf16 = 1); lse, delta: [B*H, S] float32; lengths: [B] int32
// on the device, or null. D must be 64 or 128.
int paddle_flash_attention_backward_dq(const void* q, const void* k,
                                       const void* v, const void* dout,
                                       const float* lse, const float* delta,
                                       const int* lengths, void* dq, int B,
                                       int H, int S, int D, int is_bf16,
                                       int causal, float scale,
                                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64 && !is_bf16)
    return launch_dq<float, 64>(q, k, v, dout, lse, delta, lengths, dq, B, H, S, causal, scale, st);
  if (D == 128 && !is_bf16)
    return launch_dq<float, 128>(q, k, v, dout, lse, delta, lengths, dq, B, H, S, causal, scale, st);
  if (D == 64 && is_bf16)
    return launch_dq<__nv_bfloat16, 64>(q, k, v, dout, lse, delta, lengths, dq, B, H, S, causal, scale, st);
  if (D == 128 && is_bf16)
    return launch_dq<__nv_bfloat16, 128>(q, k, v, dout, lse, delta, lengths, dq, B, H, S, causal, scale, st);
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
    return launch_dkv<float, 64>(q, k, v, dout, lse, delta, lengths, dk, dv, B, H, S, causal, scale, st);
  if (D == 128 && !is_bf16)
    return launch_dkv<float, 128>(q, k, v, dout, lse, delta, lengths, dk, dv, B, H, S, causal, scale, st);
  if (D == 64 && is_bf16)
    return launch_dkv<__nv_bfloat16, 64>(q, k, v, dout, lse, delta, lengths, dk, dv, B, H, S, causal, scale, st);
  if (D == 128 && is_bf16)
    return launch_dkv<__nv_bfloat16, 128>(q, k, v, dout, lse, delta, lengths, dk, dv, B, H, S, causal, scale, st);
  return int(cudaErrorInvalidValue);
}

const char* paddle_flash_attention_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
