// Tensor-core fragments and asynchronous copies for NVIDIA Hopper (sm_90a),
// shared by the flash-attention forward (K1, flash_attention.cu), its
// backward (K2/K3, flash_attention_bwd.cu), the fused conv (K5,
// conv2d_bn_act.cu) and paged attention (K6, paged_attention.cu). Each of
// those sources builds alone into its own
// library and includes this header once; the build hashes the header's
// bytes with each source's (ops/cuda/support.library_path).
//
// float32 products run as 3xTF32 on mma.sync.m16n8k8.tf32: each operand x
// is split into hi = tf32(x) (round to nearest) and lo = x - hi, and the
// product is lo*hi + hi*lo + hi*hi; one TF32 pass alone keeps about three
// decimal digits and misses the float32 limit. An operand that is exact in
// tf32 (bf16 widened by a shift, int8 codes) has no lo part, so two
// products suffice. bfloat16 products run m16n8k16.bf16 with float32
// accumulators.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kMaxDevices = 64;

// ------------------------------------------------------- asynchronous copies

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes, or 16 zeros when !valid (the source is then not read)
__device__ __forceinline__ void cp_async_16(void* dst, const void* src,
                                            bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_8(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 8 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_4(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// rows [r0, r0 + ROWS) of a [S, D] slice into a [ROWS][STRIDE] tile by a
// block of THREADS threads, 16 bytes a copy; rows at or past `end` are
// zero-filled
template <int THREADS, typename T, int D, int ROWS, int STRIDE>
__device__ __forceinline__ void load_tile(T* dst, const T* src, int r0,
                                          int end) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kChunks = D / kVec;
  static_assert(ROWS * kChunks % THREADS == 0, "tile split");
#pragma unroll
  for (int j = 0; j < ROWS * kChunks / THREADS; ++j) {
    const int i = threadIdx.x + j * THREADS;
    const int r = i / kChunks, c = (i % kChunks) * kVec;
    const bool ok = r0 + r < end;
    cp_async_16(dst + r * STRIDE + c,
                src + int64_t(ok ? r0 + r : 0) * D + c, ok);
  }
}

// ------------------------------------------------------------ mma fragments

// cvt.rna.tf32.f32 for finite x, which is all these kernels see: the 13
// low mantissa bits rounded to nearest, ties away from zero. Two integer
// operations; the conversion instruction compiles to several on sm_90a.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c = a * b, the sum starting from zero
__device__ __forceinline__ void mma_tf32_zero(float* c, const uint32_t* a,
                                              const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(c[0]), "=f"(c[1]), "=f"(c[2]), "=f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
        "f"(0.f));
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Four 8x8 matrices of 16-bit elements by ldmatrix.x4, lanes 8i..8i+7
// addressing the rows of matrix i (each row 16 bytes, 16-byte aligned):
// lane l receives, of matrix i, row l / 4, 32-bit word l % 4
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(row)));
}

// Lane roles of every fragment below: g = lane / 4 is the row (A, C) or
// column (B) group, t = lane % 4 the position inside it. An accumulator
// tile acc[n][4] of a 16-row strip holds (g, 8n + 2t), (g, 8n + 2t + 1),
// (g + 8, 8n + 2t), (g + 8, 8n + 2t + 1).
__device__ __forceinline__ int lane_g() { return (threadIdx.x & 31) >> 2; }
__device__ __forceinline__ int lane_t() { return threadIdx.x & 3; }

// float32 through 3xTF32 (m16n8k8)
struct Tf32x3 {
  using T = float;
  static constexpr int kDepth = 8;
  static constexpr int kPad = 4;  // row stride = 4 (mod 32) words
  struct A {
    uint32_t hi[4], lo[4];
  };
  struct B {
    uint32_t hi[2], lo[2];  // lo unused where the operand is exact in tf32
  };

  // hi = tf32(x) rounded to nearest; lo = x - hi exactly, passed as it
  // is: the tensor cores read a tf32 operand's top 19 bits, which cuts lo
  // to tf32 toward zero, an error of at most 2^-21 |x| whose sign follows
  // lo's and so averages out. Rounding lo as well gave the same errors on
  // the card and took longer.
  static __device__ __forceinline__ void split(float x, uint32_t& hi,
                                               uint32_t& lo) {
    hi = to_tf32(x);
    lo = __float_as_uint(__fsub_rn(x, __uint_as_float(hi)));
  }
  // A = s[0:16][k0:k0+8], row-major
  static __device__ __forceinline__ A load_a(const float* s, int stride,
                                             int k0) {
    const float* r = s + lane_g() * stride + k0 + lane_t();
    A a;
    split(r[0], a.hi[0], a.lo[0]);
    split(r[8 * stride], a.hi[1], a.lo[1]);
    split(r[4], a.hi[2], a.lo[2]);
    split(r[8 * stride + 4], a.hi[3], a.lo[3]);
    return a;
  }
  // load_a's fragment by one ldmatrix.x4: rows 16-byte aligned
  // (stride % 4 == 0, k0 % 4 == 0); lanes 0-15 address rows 0-15 at k0,
  // lanes 16-31 the same rows at k0 + 4
  static __device__ __forceinline__ A load_a_x4(const float* s, int stride,
                                                int k0) {
    const int l = threadIdx.x & 31;
    uint32_t v[4];
    ldmatrix_x4(v, s + (l & 15) * stride + k0 + (l >> 4) * 4);
    A a;
#pragma unroll
    for (int i = 0; i < 4; ++i) split(__uint_as_float(v[i]), a.hi[i], a.lo[i]);
    return a;
  }
  // B[k][n] = s[n0 + n][k0 + k]
  static __device__ __forceinline__ B load_b_nk(const float* s, int stride,
                                                int n0, int k0) {
    const float* r = s + (n0 + lane_g()) * stride + k0 + lane_t();
    B b;
    split(r[0], b.hi[0], b.lo[0]);
    split(r[4], b.hi[1], b.lo[1]);
    return b;
  }
  // B[k][n] = s[k0 + k][n0 + n] with the depth permuted as in from_acc:
  // logical rows t and t + 4 are rows 2t and 2t + 1
  static __device__ __forceinline__ B load_b_kn(const float* s, int stride,
                                                int k0, int n0) {
    const float* r = s + (k0 + 2 * lane_t()) * stride + n0 + lane_g();
    B b;
    split(r[0], b.hi[0], b.lo[0]);
    split(r[stride], b.hi[1], b.lo[1]);
    return b;
  }
  // B[k][n] = s[k0 + k][n0 + n] with the depth in order (logical rows t
  // and t + 4 are rows t and t + 4): pairs with load_a, not from_acc
  static __device__ __forceinline__ B load_b_rows(const float* s,
                                                  int stride, int k0,
                                                  int n0) {
    const float* r = s + (k0 + lane_t()) * stride + n0 + lane_g();
    B b;
    split(r[0], b.hi[0], b.lo[0]);
    split(r[4 * stride], b.hi[1], b.lo[1]);
    return b;
  }
  // A = columns [8 kc, 8 kc + 8) of an accumulator strip, permuted (the
  // accumulator layout of m16n8k8 is not its A-operand layout: logical
  // column t is column 2t, t + 4 is 2t + 1)
  static __device__ __forceinline__ A from_acc(const float (*acc)[4],
                                               int kc) {
    A a;
    split(acc[kc][0], a.hi[0], a.lo[0]);
    split(acc[kc][2], a.hi[1], a.lo[1]);
    split(acc[kc][1], a.hi[2], a.lo[2]);
    split(acc[kc][3], a.hi[3], a.lo[3]);
    return a;
  }
  // part = sum over j < N of a[j] * b[j], from zero, small products first:
  // lo*hi and hi*lo (lo*hi alone where b is exact in tf32), then hi*hi
  template <int N, bool kExact = false>
  static __device__ __forceinline__ void mma_sum(float* part, const A* a,
                                                 const B* b) {
    mma_tf32_zero(part, a[0].lo, b[0].hi);
    if (!kExact) mma_tf32(part, a[0].hi, b[0].lo);
#pragma unroll
    for (int j = 1; j < N; ++j) {
      mma_tf32(part, a[j].lo, b[j].hi);
      if (!kExact) mma_tf32(part, a[j].hi, b[j].lo);
    }
#pragma unroll
    for (int j = 0; j < N; ++j) mma_tf32(part, a[j].hi, b[j].hi);
  }
  // c += sum over j < kGroup of a[j] * b[j]. The tensor cores round their
  // float32 sums toward zero, and relative to the running sum that drifts
  // past the float32 limit over a long walk (or a peaked softmax); so the
  // twelve products of four steps sum from zero and reach c by a float32
  // add, which rounds to nearest. (Fewer steps a partial gave the same
  // errors on the card and took longer.)
  static constexpr int kGroup = 4;
  static __device__ __forceinline__ void mma(float* c, const A* a,
                                             const B* b) {
    float part[4];
    mma_sum<kGroup>(part, a, b);
#pragma unroll
    for (int e = 0; e < 4; ++e) c[e] += part[e];
  }
  // one depth step of such a group, for a caller that keeps a partial a
  // tile and adds it to its sum after kGroup steps: part = a * b on the
  // group's first step (from zero), part += a * b after it; lo*hi, hi*lo,
  // then hi*hi
  static __device__ __forceinline__ void mma_step(float* part, const A& a,
                                                  const B& b, bool first) {
    if (first)
      mma_tf32_zero(part, a.lo, b.hi);
    else
      mma_tf32(part, a.lo, b.hi);
    mma_tf32(part, a.hi, b.lo);
    mma_tf32(part, a.hi, b.hi);
  }
  static __device__ __forceinline__ void store2(float* p, float x,
                                                float y) {
    *reinterpret_cast<float2*>(p) = make_float2(x, y);
  }
};

// bfloat16 (m16n8k16)
struct Bf16 {
  using T = __nv_bfloat16;
  static constexpr int kDepth = 16;
  static constexpr int kPad = 8;  // row stride = 4 (mod 32) words
  struct A {
    uint32_t r[4];
  };
  struct B {
    uint32_t r[2];
  };

  static __device__ __forceinline__ uint32_t ld32(const T* p) {
    return *reinterpret_cast<const uint32_t*>(p);
  }
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&h);
  }
  static __device__ __forceinline__ A load_a(const T* s, int stride,
                                             int k0) {
    const T* r = s + lane_g() * stride + k0 + 2 * lane_t();
    return A{{ld32(r), ld32(r + 8 * stride), ld32(r + 8),
              ld32(r + 8 * stride + 8)}};
  }
  // load_a's fragment by one ldmatrix.x4: rows 16-byte aligned
  // (stride % 8 == 0, k0 % 8 == 0); lanes 0-15 address rows 0-15 at k0,
  // lanes 16-31 the same rows at k0 + 8
  static __device__ __forceinline__ A load_a_x4(const T* s, int stride,
                                                int k0) {
    const int l = threadIdx.x & 31;
    A a;
    ldmatrix_x4(a.r, s + (l & 15) * stride + k0 + (l >> 4) * 8);
    return a;
  }
  static __device__ __forceinline__ B load_b_nk(const T* s, int stride,
                                                int n0, int k0) {
    const T* r = s + (n0 + lane_g()) * stride + k0 + 2 * lane_t();
    return B{{ld32(r), ld32(r + 8)}};
  }
  // rows k0..k0+15 of s, columns n0..n0+7, transposed by ldmatrix: lanes
  // 0-7 address rows k0..k0+7, lanes 8-15 rows k0+8..k0+15
  static __device__ __forceinline__ B load_b_kn(const T* s, int stride,
                                                int k0, int n0) {
    const T* r = s + (k0 + (threadIdx.x & 15)) * stride + n0;
    B b;
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
        : "=r"(b.r[0]), "=r"(b.r[1])
        : "r"(smem_addr(r)));
    return b;
  }
  // A = columns [16 kc, 16 kc + 16): accumulator tiles 2 kc and 2 kc + 1
  // (the accumulator layout of m16n8k16 is its A-operand layout)
  static __device__ __forceinline__ A from_acc(const float (*acc)[4],
                                               int kc) {
    const float* x = acc[2 * kc];
    const float* y = acc[2 * kc + 1];
    return A{{pack(x[0], x[1]), pack(x[2], x[3]), pack(y[0], y[1]),
              pack(y[2], y[3])}};
  }
  static constexpr int kGroup = 1;
  static __device__ __forceinline__ void mma(float* c, const A* a,
                                             const B* b) {
    mma_bf16(c, a->r, b->r);
  }
  static __device__ __forceinline__ void store2(T* p, float x, float y) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
  }
};

// acc[0:16][0:8 NT] += a[0:16][0:K] * b[0:8 NT][0:K]^T, both in shared;
// kGroup steps of depth at a time
template <class Op, int K, int NT>
__device__ __forceinline__ void gemm_nk(float (*acc)[4],
                                        const typename Op::T* a,
                                        const typename Op::T* b,
                                        int stride) {
  constexpr int kStep = Op::kDepth, kG = Op::kGroup;
  static_assert(K % (kStep * kG) == 0, "depth steps");
#pragma unroll
  for (int k0 = 0; k0 < K; k0 += kStep * kG) {
    typename Op::A fa[kG];
#pragma unroll
    for (int j = 0; j < kG; ++j) fa[j] = Op::load_a(a, stride, k0 + j * kStep);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      typename Op::B fb[kG];
#pragma unroll
      for (int j = 0; j < kG; ++j)
        fb[j] = Op::load_b_nk(b, stride, 8 * n, k0 + j * kStep);
      Op::mma(acc[n], fa, fb);
    }
  }
}

// acc[0:16][0:8 NT] += p[0:16][0:K] * b[0:K][0:8 NT]: p an accumulator
// strip in registers, b in shared
template <class Op, int K, int NT>
__device__ __forceinline__ void gemm_kn(float (*acc)[4],
                                        const float (*p)[4],
                                        const typename Op::T* b,
                                        int stride) {
  constexpr int kStep = Op::kDepth, kG = Op::kGroup;
  static_assert(K % (kStep * kG) == 0, "depth steps");
#pragma unroll
  for (int kc = 0; kc < K / kStep; kc += kG) {
    typename Op::A fa[kG];
#pragma unroll
    for (int j = 0; j < kG; ++j) fa[j] = Op::from_acc(p, kc + j);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      typename Op::B fb[kG];
#pragma unroll
      for (int j = 0; j < kG; ++j)
        fb[j] = Op::load_b_kn(b, stride, (kc + j) * kStep, 8 * n);
      Op::mma(acc[n], fa, fb);
    }
  }
}

// ------------------------------------------------------------ launch limits

// Dynamic shared memory above 48 KB needs the kernel's limit raised. Each
// kernel raises it once per device to the largest size launched so far
// (`done` is the kernel's own record), not on every launch.
template <typename Kernel>
cudaError_t raise_smem_limit(Kernel kernel, size_t bytes,
                             std::atomic<size_t>* done) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && done[dev].load(std::memory_order_acquire) >= bytes)
    return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(bytes));
  if (err == cudaSuccess && dev < kMaxDevices) done[dev].store(bytes);
  return err;
}

}  // namespace
