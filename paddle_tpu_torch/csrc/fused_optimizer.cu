// Fused optimizer update for NVIDIA Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel `_kernel`, reached through `_pallas_update`
// (paddle_tpu/ops/pallas/fused_optimizer.py:84 and :172): one
// read-modify-write pass over an optimizer instance's flat float32
// parameter, gradient and state buffers that applies sgd, momentum (with or
// without Nesterov), adam or adamw to every element. The learning rate and
// the beta powers are device scalars, read once per thread.
//
// Bit-exactness is the contract. Every operation is written with a
// correctly rounded intrinsic (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn,
// __fsqrt_rn) in the order of `_update_math` (fused_optimizer.py:47), so
// nvcc cannot contract a product and a sum into one FMA, and the result
// equals the eager PyTorch plain version bit for bit. Constants such as
// 1 - beta1 arrive from the host already rounded to float32, as JAX's
// weak-typed scalars are; lr_t = lr * sqrt(1 - beta2_pow) / (1 - beta1_pow)
// is computed here in float32 from the device scalars.
//
// Unlike the JAX kernel, which returns new arrays, this one updates the
// parameter and state buffers in place: the flat buffers are the
// optimizer's own, and in-place saves a second copy of each.
//
// What bounds it on this card: bytes. adam and adamw read four streams and
// write three (param, m1, m2 in and out, grad in), 28 bytes an element for
// about 15 operations, far under the card's 20 float32 operations per
// byte. The design streams each element once: 16-byte float4 loads and
// stores where every buffer is 16-byte aligned, a scalar tail for the
// rest, and a grid-stride loop over as many blocks as keep the card's
// memory busy. Any size is taken; nothing needs padding.
//
// The kernel launches on the caller's stream, allocates nothing and does
// not synchronise. The entry point returns the cudaError_t of its launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Kind { kSgd = 0, kMomentum = 1, kAdam = 2, kAdamW = 3 };

struct Consts {
  float mu;        // momentum
  float beta1;     // adam, adamw
  float one_minus_beta1;
  float beta2;
  float one_minus_beta2;
  float epsilon;
  float weight_decay;  // adamw
  int nesterov;        // momentum
};

constexpr int kThreads = 256;

template <int KIND>
__device__ __forceinline__ void update(float& p, float g, float& a, float& b,
                                       const Consts& c, float lr,
                                       float lr_t) {
  if constexpr (KIND == kSgd) {
    p = __fsub_rn(p, __fmul_rn(lr, g));
  } else if constexpr (KIND == kMomentum) {
    const float v = __fadd_rn(__fmul_rn(c.mu, a), g);
    a = v;
    if (c.nesterov)
      p = __fsub_rn(p, __fmul_rn(__fadd_rn(g, __fmul_rn(c.mu, v)), lr));
    else
      p = __fsub_rn(p, __fmul_rn(lr, v));
  } else {
    const float m1 = __fadd_rn(__fmul_rn(c.beta1, a),
                               __fmul_rn(c.one_minus_beta1, g));
    const float m2 = __fadd_rn(__fmul_rn(c.beta2, b),
                               __fmul_rn(c.one_minus_beta2, __fmul_rn(g, g)));
    float out = __fsub_rn(
        p, __fdiv_rn(__fmul_rn(lr_t, m1), __fadd_rn(__fsqrt_rn(m2), c.epsilon)));
    if constexpr (KIND == kAdamW)
      out = __fsub_rn(out, __fmul_rn(__fmul_rn(lr, c.weight_decay), p));
    p = out;
    a = m1;
    b = m2;
  }
}

template <int KIND>
__global__ void __launch_bounds__(kThreads)
fused_update_kernel(float* __restrict__ p, const float* __restrict__ g,
                    float* __restrict__ sa, float* __restrict__ sb,
                    const float* __restrict__ lr_ptr,
                    const float* __restrict__ b1pow_ptr,
                    const float* __restrict__ b2pow_ptr, int64_t n,
                    Consts c, int vectorized) {
  constexpr bool kHasA = KIND != kSgd;
  constexpr bool kHasB = KIND == kAdam || KIND == kAdamW;
  const float lr = *lr_ptr;
  float lr_t = 0.f;
  if constexpr (kHasB) {
    lr_t = __fdiv_rn(__fmul_rn(lr, __fsqrt_rn(__fsub_rn(1.f, *b2pow_ptr))),
                     __fsub_rn(1.f, *b1pow_ptr));
  }
  const int64_t stride = int64_t(gridDim.x) * blockDim.x;
  const int64_t first = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t n_vec = vectorized ? n / 4 : 0;

  for (int64_t i = first; i < n_vec; i += stride) {
    float4 pv = reinterpret_cast<float4*>(p)[i];
    const float4 gv = reinterpret_cast<const float4*>(g)[i];
    float4 av = make_float4(0.f, 0.f, 0.f, 0.f), bv = av;
    if constexpr (kHasA) av = reinterpret_cast<float4*>(sa)[i];
    if constexpr (kHasB) bv = reinterpret_cast<float4*>(sb)[i];
    update<KIND>(pv.x, gv.x, av.x, bv.x, c, lr, lr_t);
    update<KIND>(pv.y, gv.y, av.y, bv.y, c, lr, lr_t);
    update<KIND>(pv.z, gv.z, av.z, bv.z, c, lr, lr_t);
    update<KIND>(pv.w, gv.w, av.w, bv.w, c, lr, lr_t);
    reinterpret_cast<float4*>(p)[i] = pv;
    if constexpr (kHasA) reinterpret_cast<float4*>(sa)[i] = av;
    if constexpr (kHasB) reinterpret_cast<float4*>(sb)[i] = bv;
  }
  for (int64_t i = n_vec * 4 + first; i < n; i += stride) {
    float pv = p[i];
    float av = kHasA ? sa[i] : 0.f;
    float bv = kHasB ? sb[i] : 0.f;
    update<KIND>(pv, g[i], av, bv, c, lr, lr_t);
    p[i] = pv;
    if constexpr (kHasA) sa[i] = av;
    if constexpr (kHasB) sb[i] = bv;
  }
}

template <int KIND>
cudaError_t launch(float* p, const float* g, float* sa, float* sb,
                   const float* lr, const float* b1pow, const float* b2pow,
                   int64_t n, const Consts& c, cudaStream_t stream) {
  const uintptr_t bits = reinterpret_cast<uintptr_t>(p) |
                         reinterpret_cast<uintptr_t>(g) |
                         reinterpret_cast<uintptr_t>(sa) |
                         reinterpret_cast<uintptr_t>(sb);
  const int vectorized = (bits & 15u) == 0;
  const int64_t items = vectorized ? (n + 3) / 4 : n;
  int dev = 0, sms = 132;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  // eight blocks of 256 threads an SM keep enough loads in flight
  const int64_t want = (items + kThreads - 1) / kThreads;
  const int blocks = int(want < int64_t(sms) * 8 ? want : int64_t(sms) * 8);
  fused_update_kernel<KIND><<<blocks, kThreads, 0, stream>>>(
      p, g, sa, sb, lr, b1pow, b2pow, n, c, vectorized);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// kind: 0 sgd, 1 momentum, 2 adam, 3 adamw. p, g: n float32 each; sa: the
// velocity (momentum) or the first moment (adam, adamw), else null; sb: the
// second moment (adam, adamw), else null; lr: one float32 on the device;
// b1pow, b2pow: one float32 each on the device (adam, adamw), else null.
// The scalars after n are the optimizer's constants, already float32.
int paddle_fused_optimizer_update(int kind, void* p, const void* g, void* sa,
                                  void* sb, const void* lr, const void* b1pow,
                                  const void* b2pow, int64_t n, float mu,
                                  float beta1, float one_minus_beta1,
                                  float beta2, float one_minus_beta2,
                                  float epsilon, float weight_decay,
                                  int nesterov, void* stream) {
  if (n <= 0) return int(cudaSuccess);
  const Consts c{mu, beta1, one_minus_beta1, beta2, one_minus_beta2,
                 epsilon, weight_decay, nesterov};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* pp = static_cast<float*>(p);
  const float* gp = static_cast<const float*>(g);
  float* ap = static_cast<float*>(sa);
  float* bp = static_cast<float*>(sb);
  const float* lp = static_cast<const float*>(lr);
  const float* b1 = static_cast<const float*>(b1pow);
  const float* b2 = static_cast<const float*>(b2pow);
  switch (kind) {
    case kSgd: return int(launch<kSgd>(pp, gp, ap, bp, lp, b1, b2, n, c, st));
    case kMomentum: return int(launch<kMomentum>(pp, gp, ap, bp, lp, b1, b2, n, c, st));
    case kAdam: return int(launch<kAdam>(pp, gp, ap, bp, lp, b1, b2, n, c, st));
    case kAdamW: return int(launch<kAdamW>(pp, gp, ap, bp, lp, b1, b2, n, c, st));
  }
  return int(cudaErrorInvalidValue);
}

const char* paddle_fused_optimizer_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
