// Fused implicit-GEMM conv2d (+ per-channel scale/shift, + residual, + relu)
// for NVIDIA Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel `_kernel`, reached through `conv2d_bn_act`
// (paddle_tpu/ops/pallas/conv.py:33 and :97): an NHWC convolution of
// x [B, H, W, Cin] with an HWIO filter w [KH, KW, Cin, Cout], accumulated in
// float32, whose epilogue y = relu?(acc * scale + shift + residual?) runs
// on the accumulator before the one store of y [B, H_out, W_out, Cout].
// The im2col matrix never exists in device memory.
//
// The convolution is one GEMM: M = B * H_out * W_out output pixels, N =
// Cout channels, K = KH * KW * Cin taps. Each block owns a 128 x 128 tile
// of y and walks the whole K reduction itself, 16 taps-channels at a time,
// so its 8 x 8 accumulators per thread stay in registers, no two blocks
// write the same output, and every run gives the same bits (no atomics).
// Cin % 128 == 0, so a 16-wide K step never straddles two filter taps: for
// tap (r, c) and channels ci0..ci0+15, row m of the A tile is
// x[b, ho*stride + r - pad, wo*stride + c - pad, ci0:ci0+16], read straight
// from x with a bounds predicate that gives zeros in the padding. The
// Pallas version pads x in HBM and decimates stride 2 by reshapes (a
// Mosaic workaround); here the stride is an index multiplier.
//
// What bounds it on this card: operations. ResNet-50's routed convs do
// 30-230 FLOPs per byte they must move, far above the card's 20 float32
// FLOPs per byte of HBM. This first version multiplies on the float32 CUDA
// cores (FFMA, 67 TFLOP/s peak): register tiles of 8 x 8 per thread, A and
// B tiles staged through double-buffered shared memory with a register
// prefetch of the next tile during the current one's products, 16-byte
// loads and stores. Tensor cores (mma.sync / wgmma on TF32 or bf16), TMA
// and a deeper pipeline are later work.
//
// Types: float32, or bfloat16 x, w and residual (converted to float32 on
// load) with a bfloat16 y; scale and shift are float32. Every pointer must
// be 16-byte aligned (the wrapper ensures it). Cout % 4 == 0 takes the
// vector path for w, residual and y; any other Cout the scalar one.
//
// The kernel launches on the caller's stream, allocates nothing and does
// not synchronise. The entry point returns the cudaError_t of its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;       // output pixels per block
constexpr int kBN = 128;       // output channels per block
constexpr int kBK = 16;        // reduction step
constexpr int kPadM = 4;       // As row padding: halves bank conflicts
constexpr int kThreads = 256;  // 16 x 16 threads, 8 x 8 outputs each

struct Params {
  const void* x;
  const void* w;
  const float* scale;
  const float* shift;
  const void* res;  // null: no residual
  void* y;
  int H, W, Cin, Hout, Wout, Cout, KW, stride, pad, relu;
  int nsteps;        // KH * KW * Cin / kBK
  int64_t M;         // B * Hout * Wout
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// four consecutive elements (p aligned to four elements) as float32
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

__device__ __forceinline__ void store4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float* v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&lo);
  u.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
conv2d_bn_act_kernel(const Params p) {
  __shared__ __align__(16) float As[2][kBK][kBM + kPadM];
  __shared__ __align__(16) float Bs[2][kBK][kBN];

  const T* __restrict__ x = static_cast<const T*>(p.x);
  const T* __restrict__ w = static_cast<const T*>(p.w);
  const int tid = threadIdx.x;
  const int64_t m0 = int64_t(blockIdx.x) * kBM;
  const int n0 = blockIdx.y * kBN;

  // A loader: rows a_row and a_row + 64 of the tile, 4 channels from a_k
  const int a_k = (tid & 3) * 4;
  const int a_row = tid >> 2;
  int64_t a_img[2];  // offset of image b in x
  int a_h[2], a_w[2];
  bool a_ok[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int64_t m = m0 + a_row + i * 64;
    a_ok[i] = m < p.M;
    const int64_t mm = a_ok[i] ? m : 0;
    const int wo = int(mm % p.Wout);
    const int64_t t = mm / p.Wout;
    const int ho = int(t % p.Hout);
    const int64_t b = t / p.Hout;
    a_h[i] = ho * p.stride - p.pad;
    a_w[i] = wo * p.stride - p.pad;
    a_img[i] = b * p.H * p.W * p.Cin;
  }
  // B loader: reduction rows b_k and b_k + 8, 4 channels from b_n
  const int b_n = (tid & 31) * 4;
  const int b_k = tid >> 5;
  const int steps_per_tap = p.Cin / kBK;

  float4 ra[2], rb[2];
  auto load_tile = [&](int step) {
    const int tap = step / steps_per_tap;
    const int ci0 = (step - tap * steps_per_tap) * kBK;
    const int r = tap / p.KW;
    const int c = tap - r * p.KW;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int h = a_h[i] + r;
      const int ww = a_w[i] + c;
      if (a_ok[i] && h >= 0 && h < p.H && ww >= 0 && ww < p.W) {
        ra[i] = load4(x + a_img[i] + (int64_t(h) * p.W + ww) * p.Cin + ci0 +
                      a_k);
      } else {
        ra[i] = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int64_t row =
          (int64_t(tap) * p.Cin + ci0 + b_k + i * 8) * int64_t(p.Cout);
      const int n = n0 + b_n;
      if (VEC) {
        rb[i] = n < p.Cout ? load4(w + row + n)
                           : make_float4(0.f, 0.f, 0.f, 0.f);
      } else {
        rb[i].x = n + 0 < p.Cout ? to_float(w[row + n + 0]) : 0.f;
        rb[i].y = n + 1 < p.Cout ? to_float(w[row + n + 1]) : 0.f;
        rb[i].z = n + 2 < p.Cout ? to_float(w[row + n + 2]) : 0.f;
        rb[i].w = n + 3 < p.Cout ? to_float(w[row + n + 3]) : 0.f;
      }
    }
  };
  auto store_tile = [&](int buf) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      As[buf][a_k + 0][a_row + i * 64] = ra[i].x;
      As[buf][a_k + 1][a_row + i * 64] = ra[i].y;
      As[buf][a_k + 2][a_row + i * 64] = ra[i].z;
      As[buf][a_k + 3][a_row + i * 64] = ra[i].w;
      *reinterpret_cast<float4*>(&Bs[buf][b_k + i * 8][b_n]) = rb[i];
    }
  };

  // thread (ty, tx) owns rows ty*4 + {0..3, 64..67} and columns
  // tx*4 + {0..3, 64..67} of the tile: neighbouring threads read
  // neighbouring 16-byte words of shared memory
  const int tx = tid & 15;
  const int ty = tid >> 4;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  load_tile(0);
  store_tile(0);
  __syncthreads();
  for (int step = 0; step < p.nsteps; ++step) {
    const int buf = step & 1;
    const bool more = step + 1 < p.nsteps;
    if (more) load_tile(step + 1);  // in flight during the products
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[buf][k][ty * 4]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&As[buf][k][ty * 4 + 64]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[buf][k][tx * 4]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&Bs[buf][k][tx * 4 + 64]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    // the other buffer was last read before the previous barrier
    if (more) store_tile(buf ^ 1);
    __syncthreads();
  }

  // epilogue on the accumulator: acc * scale + shift, + residual, relu,
  // each rounded on its own as the plain version's separate operations are
  const T* __restrict__ res = static_cast<const T*>(p.res);
  T* __restrict__ y = static_cast<T*>(p.y);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int64_t m = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + (i - 4));
    if (m >= p.M) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int n = n0 + half * 64 + tx * 4;
      if (n >= p.Cout) continue;
      const int64_t off = m * p.Cout + n;
      float v[4];
      float rv[4] = {0.f, 0.f, 0.f, 0.f};
      if (res != nullptr) {
        if (VEC) {
          const float4 r4 = load4(res + off);
          rv[0] = r4.x; rv[1] = r4.y; rv[2] = r4.z; rv[3] = r4.w;
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (n + j < p.Cout) rv[j] = to_float(res[off + j]);
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int nj = min(n + j, p.Cout - 1);
        float t = __fadd_rn(__fmul_rn(acc[i][half * 4 + j], p.scale[nj]),
                            p.shift[nj]);
        if (res != nullptr) t = __fadd_rn(t, rv[j]);
        if (p.relu) t = fmaxf(t, 0.f);
        v[j] = t;
      }
      if (VEC) {
        store4(y + off, v);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (n + j < p.Cout) y[off + j] = from_float<T>(v[j]);
      }
    }
  }
}

template <typename T>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const int64_t mtiles = (p.M + kBM - 1) / kBM;
  if (mtiles > 0x7fffffff) return cudaErrorInvalidValue;
  const dim3 grid(unsigned(mtiles), unsigned((p.Cout + kBN - 1) / kBN));
  if (p.Cout % 4 == 0) {
    conv2d_bn_act_kernel<T, true><<<grid, kThreads, 0, stream>>>(p);
  } else {
    conv2d_bn_act_kernel<T, false><<<grid, kThreads, 0, stream>>>(p);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16 (x, w, residual and y). x [B, H, W, Cin],
// w [KH, KW, Cin, Cout], scale and shift [Cout] float32, residual (or null)
// and y [B, Hout, Wout, Cout], all contiguous and 16-byte aligned.
// Requires Cin % 16 == 0 (the wrapper takes Cin % 128 == 0).
int paddle_conv2d_bn_act(int dtype, const void* x, const void* w,
                         const void* scale, const void* shift,
                         const void* residual, void* y, int B, int H, int W,
                         int Cin, int KH, int KW, int Cout, int stride,
                         int pad, int Hout, int Wout, int relu,
                         void* stream) {
  if (Cin <= 0 || Cin % kBK != 0 || KH <= 0 || KW <= 0 || Cout <= 0 ||
      stride <= 0 || pad < 0)
    return int(cudaErrorInvalidValue);
  Params p;
  p.x = x;
  p.w = w;
  p.scale = static_cast<const float*>(scale);
  p.shift = static_cast<const float*>(shift);
  p.res = residual;
  p.y = y;
  p.H = H;
  p.W = W;
  p.Cin = Cin;
  p.Hout = Hout;
  p.Wout = Wout;
  p.Cout = Cout;
  p.KW = KW;
  p.stride = stride;
  p.pad = pad;
  p.relu = relu;
  p.nsteps = KH * KW * (Cin / kBK);
  p.M = int64_t(B) * Hout * Wout;
  if (p.M <= 0) return int(cudaSuccess);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return int(launch<float>(p, st));
    case 1: return int(launch<__nv_bfloat16>(p, st));
  }
  return int(cudaErrorInvalidValue);
}

const char* paddle_conv2d_bn_act_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
