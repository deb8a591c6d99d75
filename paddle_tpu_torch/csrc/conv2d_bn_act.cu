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
// Cout channels, K = KH * KW * Cin taps. A block owns a BM x BN tile of y
// and walks the whole K reduction itself, so no two blocks write the same
// output, there are no atomics and every run gives the same bits. K steps
// by BK = 32 (float32) or 64 (bfloat16) channels of one tap; Cin % 64 ==
// 0 (the wrapper takes Cin % 128 == 0), so a step never straddles two
// taps. For tap (r, c) and channels ci0..ci0+BK-1, row m of the A tile is
// x[b, ho*stride + r - pad, wo*stride + c - pad, ci0:ci0+BK], and the B
// tile is rows step*BK.. of w seen as [KH*KW*Cin, Cout]. The Pallas
// version pads x in HBM and decimates stride 2 by reshapes (a Mosaic
// workaround); here the stride is an index multiplier and the padding a
// zero-filled copy.
//
// What bounds it on this card. For float32 the least time is that of
// float32-accurate products on the tensor cores: the 3xTF32 split at a
// third of the dense TF32 rate (494.7 / 3 = 165 TFLOP/s), 49 FLOPs for
// each byte of device memory (3.35 TB/s); bfloat16 runs at 989 TFLOP/s.
// ResNet-50's 19 routed shapes at batch 128 (chip_smoke.py phase 9), in
// FLOPs per float32 byte of x, w and y: the three 1x1 convs that read x
// at 56 x 56 (K = 256) do 26-43 and are bound by bytes; the 1x1 convs at
// 28 x 28 with K or N = 128 sit at the balance (51); the rest do 85-843
// and are bound by operations.
//
// Design (fragment code in csrc/tensor_core.cuh, shared with K1-K3, K6):
//  * Products on the tensor cores with mma.sync. float32 splits each
//    operand into hi = tf32(x) and lo = x - hi as its fragment is loaded
//    and sums lo*hi + hi*lo + hi*hi (m16n8k8.tf32). The tensor cores round
//    their sums toward zero, which over K up to 4608 drifts past the
//    float32 limit; so the twelve products of one 32-channel step sum from
//    zero into a partial tile (Tf32x3::kGroup = 4 depth steps) that joins
//    the accumulator by a float32 add, rounding to nearest. bfloat16 x, w
//    and residual are staged as stored and run m16n8k16.bf16 into float32
//    accumulators; y is rounded to bfloat16 once.
//  * A and B tiles arrive by cp.async, 16 bytes a copy, into a ring of
//    four stages (bfloat16: three) in dynamic shared memory, one barrier
//    a step: step s + 3 (s + 2) loads while step s computes. Padding and
//    the M tail are zero-filled by the copy (the source is not read). A
//    block first writes a table of its rows (offset of the pixel's window
//    in x, its first input row and column) that every step's A copies
//    read.
//  * Shared rows are padded (A by Op::kPad, B by 8 elements) so that each
//    fragment load of a warp hits 32 distinct banks. A fragments come
//    from ldmatrix.x4 (one instruction for four 32-bit loads), bfloat16
//    B fragments from ldmatrix.trans.
//  * Tiles (Tile<0..2> below; ops/cuda/conv.py choose_tile picks one from
//    M, N and the type, and passes its index), each timed at the 19 shapes
//    by tools/torch_conv_tiles.py:
//      0: 128x128, 8 warps of 64x32. One block an SM in float32 (224-239
//         registers a thread, 145 KB of ring), two in bfloat16 (110 KB).
//         The default: the other tiles tie with it in float32 and lose by
//         20-40% in bfloat16, where it holds two blocks an SM.
//      1: 128x64, 4 warps of 64x32, two blocks an SM. For Cout <= 64
//         (the two Cout-64 convs at M 401,408): a 128-wide tile would
//         compute half zeros, and takes 1.9x as long.
//      2: 64x128, 4 warps of 64x32, two blocks an SM. For float32 grids of
//         fewer than two waves of 128x128 blocks (M 6,272 by N 512: 196
//         blocks for 132 SMs): half-size blocks, two an SM, share out the
//         last wave more finely; 0.58 ms against 0.68 at K 4608.
//    A 64x64 tile (4 warps of 32x32, three blocks an SM) won nowhere by
//    more than noise and was dropped.
//  * Blocks walk N fastest (one 1-D grid), so the blocks resident at once
//    share rows of x and each A row comes from device memory about once.
//  * The epilogue runs on the accumulator fragments in the plain version's
//    rounding order (acc * scale, + shift, + residual, relu). Lanes 2i and
//    2i + 1 swap half their fragment by one shuffle so that each holds
//    four consecutive columns of one row: 16-byte float32 or 8-byte bf16
//    stores.
//  * Cout not a multiple of 16 bytes' worth (4 float32, 8 bfloat16)
//    cannot take 16-byte copies of w rows or vector stores of y: its B
//    tiles are loaded element by element and y is stored a column at a
//    time.
//
// Later work: wgmma with TMA loads and mbarriers, warp specialisation and
// a persistent grid, as for K1-K3.
//
// The kernel launches on the caller's stream, allocates nothing and does
// not synchronise. The entry point returns the cudaError_t of its launch.
// Every pointer must be 16-byte aligned (the wrapper ensures it).

#include "tensor_core.cuh"

namespace {

constexpr int kPadB = 8;  // B row padding, elements

// The reduction step (channels of one tap) and the cp.async ring's depth.
// float32 steps 32 channels, one group of grouped sums (Tf32x3::kGroup
// depth steps of 8), in four stages; bfloat16 steps 64 channels (four
// m16n8k16 steps a barrier) in three.
template <class Op>
struct Step {
  static constexpr int kBK = 32, kStages = 4;
};
template <>
struct Step<Bf16> {
  static constexpr int kBK = 64, kStages = 3;
};
constexpr int kMaxBK = 64;

// BM x BN tile, WM x WN warps; min_blocks for __launch_bounds__ (the
// blocks an SM must hold, float32 or bfloat16: caps the registers a thread
// may use; shared memory allows as many)
template <int CFG>
struct Tile;
template <>
struct Tile<0> {
  static constexpr int BM = 128, BN = 128, WM = 2, WN = 4;
  static constexpr int min_blocks(bool bf16) { return bf16 ? 2 : 1; }
};
template <>
struct Tile<1> {
  static constexpr int BM = 128, BN = 64, WM = 2, WN = 2;
  static constexpr int min_blocks(bool bf16) { return bf16 ? 3 : 2; }
};
template <>
struct Tile<2> {
  static constexpr int BM = 64, BN = 128, WM = 1, WN = 4;
  static constexpr int min_blocks(bool bf16) { return bf16 ? 3 : 2; }
};
constexpr int kTiles = 3;

struct Params {
  const void* x;
  const void* w;
  const float* scale;
  const float* shift;
  const void* res;  // null: no residual
  void* y;
  int H, W, Cin, Hout, Wout, Cout, KW, stride, pad, relu;
  int taps;           // KH * KW
  int steps_per_tap;  // Cin / kBK
  int nsteps;         // taps * steps_per_tap
  int ntiles;         // N tiles: blockIdx.x % ntiles
  int64_t M;          // B * Hout * Wout
};

// a row of the A tile: its window's offset in x (at tap (0, 0)), and the
// input row and column of that tap; h0 is far negative past the M tail
struct RowInfo {
  int64_t base;
  int h0, w0;
};

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// four consecutive elements (p aligned to four elements)
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

// the epilogue of one output: acc * scale + shift, + residual, relu, each
// rounded on its own as the plain version's separate operations are
__device__ __forceinline__ float epilogue(float acc, float scale,
                                          float shift, bool has_res,
                                          float res, bool relu) {
  float t = __fadd_rn(__fmul_rn(acc, scale), shift);
  if (has_res) t = __fadd_rn(t, res);
  return relu ? fmaxf(t, 0.f) : t;
}

template <class Op, int CFG>
struct Layout {
  using T = typename Op::T;
  using Tl = Tile<CFG>;
  static constexpr int kThreads = Tl::WM * Tl::WN * 32;
  static constexpr int kVec = 16 / int(sizeof(T));  // elements a copy
  static constexpr int kBK = Step<Op>::kBK, kStages = Step<Op>::kStages;
  static constexpr int kSA = kBK + Op::kPad;         // A row stride
  static constexpr int kSB = Tl::BN + kPadB;         // B row stride
  static constexpr int kStage = Tl::BM * kSA + kBK * kSB;  // elements
  static constexpr size_t kSmem =
      sizeof(RowInfo) * Tl::BM + sizeof(T) * size_t(kStages) * kStage;
};

template <class Op, int CFG, bool VEC>
__global__ void __launch_bounds__(
    Layout<Op, CFG>::kThreads,
    Tile<CFG>::min_blocks(sizeof(typename Op::T) == 2))
conv2d_bn_act_kernel(const Params p) {
  using T = typename Op::T;
  using L = Layout<Op, CFG>;
  using Tl = Tile<CFG>;
  constexpr int BM = Tl::BM, BN = Tl::BN;
  constexpr int kThreads = L::kThreads, kVec = L::kVec;
  constexpr int kSA = L::kSA, kSB = L::kSB;
  constexpr int kBK = L::kBK, kStages = L::kStages;
  constexpr int kWTM = BM / Tl::WM, kWTN = BN / Tl::WN;  // warp tile
  constexpr int MT = kWTM / 16, NT = kWTN / 8;
  constexpr bool kGrouped = Op::kGroup > 1;
  static_assert(!kGrouped || kBK == Op::kDepth * Op::kGroup,
                "one step of K is one group of grouped sums");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  RowInfo* rows = reinterpret_cast<RowInfo*>(smem_raw);
  T* ring = reinterpret_cast<T*>(rows + BM);  // stage s at s * kStage

  const T* __restrict__ x = static_cast<const T*>(p.x);
  const T* __restrict__ w = static_cast<const T*>(p.w);
  const int tid = threadIdx.x;
  const int n0 = int(blockIdx.x % unsigned(p.ntiles)) * BN;
  const int64_t m0 = int64_t(blockIdx.x / unsigned(p.ntiles)) * BM;

  for (int i = tid; i < BM; i += kThreads) {
    const int64_t m = m0 + i;
    RowInfo ri{0, -(1 << 30), 0};
    if (m < p.M) {
      const int wo = int(m % p.Wout);
      const int64_t t = m / p.Wout;
      const int ho = int(t % p.Hout);
      const int64_t b = t / p.Hout;
      ri.h0 = ho * p.stride - p.pad;
      ri.w0 = wo * p.stride - p.pad;
      ri.base = ((b * p.H + ri.h0) * p.W + ri.w0) * int64_t(p.Cin);
    }
    rows[i] = ri;
  }
  __syncthreads();

  auto load_stage = [&](int step, int buf) {
    T* as = ring + buf * L::kStage;
    T* bs = as + BM * kSA;
    const int tap = step / p.steps_per_tap;
    const int ci0 = (step - tap * p.steps_per_tap) * kBK;
    const int r = tap / p.KW;
    const int c = tap - r * p.KW;
    const int64_t tap_off = (int64_t(r) * p.W + c) * p.Cin + ci0;
    constexpr int kChA = kBK / kVec;
    static_assert(BM * kChA % kThreads == 0, "A tile split");
#pragma unroll
    for (int j = 0; j < BM * kChA / kThreads; ++j) {
      const int i = tid + j * kThreads;
      const int row = i / kChA, col = (i % kChA) * kVec;
      const RowInfo ri = rows[row];
      const bool ok = unsigned(ri.h0 + r) < unsigned(p.H) &&
                      unsigned(ri.w0 + c) < unsigned(p.W);
      cp_async_16(as + row * kSA + col, ok ? x + ri.base + tap_off + col : x,
                  ok);
    }
    const int64_t k0 = int64_t(step) * kBK;
    if constexpr (VEC) {
      constexpr int kChB = BN / kVec;
      static_assert(kBK * kChB % kThreads == 0, "B tile split");
#pragma unroll
      for (int j = 0; j < kBK * kChB / kThreads; ++j) {
        const int i = tid + j * kThreads;
        const int k = i / kChB, col = (i % kChB) * kVec;
        const bool ok = n0 + col < p.Cout;
        cp_async_16(bs + k * kSB + col,
                    ok ? w + (k0 + k) * p.Cout + n0 + col : w, ok);
      }
    } else {
      // a row of w is not 16-byte aligned: element by element, stored
      // before the barrier that publishes this stage
      for (int i = tid; i < kBK * BN; i += kThreads) {
        const int k = i / BN, col = i % BN;
        bs[k * kSB + col] = n0 + col < p.Cout
                                ? w[(k0 + k) * p.Cout + n0 + col]
                                : from_float<T>(0.f);
      }
    }
  };

  const int warp = tid >> 5;
  const int wy = warp / Tl::WN, wx = warp % Tl::WN;
  float acc[MT][NT][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < p.nsteps) load_stage(s, s);
    cp_async_commit();
  }
  for (int step = 0; step < p.nsteps; ++step) {
    cp_async_wait<kStages - 2>();
    // step's tile has landed for every thread, and every thread is done
    // with step - 1's buffer, which the next load refills
    __syncthreads();
    if (step + kStages - 1 < p.nsteps)
      load_stage(step + kStages - 1, (step + kStages - 1) % kStages);
    cp_async_commit();

    const T* as = ring + (step % kStages) * L::kStage + wy * kWTM * kSA;
    const T* bs = ring + (step % kStages) * L::kStage + BM * kSA + wx * kWTN;
    if constexpr (kGrouped) {
      float part[MT][NT][4];
#pragma unroll
      for (int j = 0; j < Op::kGroup; ++j) {
        typename Op::B fb[NT];
#pragma unroll
        for (int n = 0; n < NT; ++n)
          fb[n] = Op::load_b_rows(bs, kSB, j * Op::kDepth, 8 * n);
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          const typename Op::A fa =
              Op::load_a_x4(as + 16 * m * kSA, kSA, j * Op::kDepth);
#pragma unroll
          for (int n = 0; n < NT; ++n)
            Op::mma_step(part[m][n], fa, fb[n], j == 0);
        }
      }
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[m][n][e] += part[m][n][e];
    } else {
#pragma unroll
      for (int j = 0; j < kBK / Op::kDepth; ++j) {
        typename Op::B fb[NT];
#pragma unroll
        for (int n = 0; n < NT; ++n)
          fb[n] = Op::load_b_kn(bs, kSB, j * Op::kDepth, 8 * n);
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          const typename Op::A fa =
              Op::load_a_x4(as + 16 * m * kSA, kSA, j * Op::kDepth);
#pragma unroll
          for (int n = 0; n < NT; ++n) Op::mma(acc[m][n], &fa, &fb[n]);
        }
      }
    }
  }
  cp_async_wait<0>();

  const T* __restrict__ res = static_cast<const T*>(p.res);
  T* __restrict__ y = static_cast<T*>(p.y);
  const bool has_res = res != nullptr, relu = p.relu != 0;
  const int g = lane_g(), t = lane_t();
  const int64_t row0 = m0 + wy * kWTM + g;
  const int col0 = n0 + wx * kWTN;
#pragma unroll
  for (int m = 0; m < MT; ++m) {
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const float a[4] = {acc[m][n][0], acc[m][n][1], acc[m][n][2],
                          acc[m][n][3]};
      if constexpr (VEC) {
        // lane 2i keeps row g, columns 2t, 2t + 1 and takes 2t + 2, 2t + 3
        // from lane 2i + 1, which keeps row g + 8 and takes the other two
        const bool odd = t & 1;
        const float r0 = __shfl_xor_sync(0xffffffffu, odd ? a[0] : a[2], 1);
        const float r1 = __shfl_xor_sync(0xffffffffu, odd ? a[1] : a[3], 1);
        const float v[4] = {odd ? r0 : a[0], odd ? r1 : a[1],
                            odd ? a[2] : r0, odd ? a[3] : r1};
        const int64_t row = row0 + 16 * m + (odd ? 8 : 0);
        const int col = col0 + 8 * n + 4 * (t >> 1);
        if (row >= p.M || col >= p.Cout) continue;
        const int64_t off = row * p.Cout + col;
        const float4 sc = load4(p.scale + col), sh = load4(p.shift + col);
        float4 rv = make_float4(0.f, 0.f, 0.f, 0.f);
        if (has_res) rv = load4(res + off);
        float out[4] = {epilogue(v[0], sc.x, sh.x, has_res, rv.x, relu),
                        epilogue(v[1], sc.y, sh.y, has_res, rv.y, relu),
                        epilogue(v[2], sc.z, sh.z, has_res, rv.z, relu),
                        epilogue(v[3], sc.w, sh.w, has_res, rv.w, relu)};
        store4(y + off, out);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int64_t row = row0 + 16 * m + (e >= 2 ? 8 : 0);
          const int col = col0 + 8 * n + 2 * t + (e & 1);
          if (row >= p.M || col >= p.Cout) continue;
          const int64_t off = row * p.Cout + col;
          y[off] = from_float<T>(epilogue(
              a[e], p.scale[col], p.shift[col], has_res,
              has_res ? to_float(res[off]) : 0.f, relu));
        }
      }
    }
  }
}

template <class Op, int CFG, bool VEC>
cudaError_t launch_vec(const Params& p, cudaStream_t stream) {
  using L = Layout<Op, CFG>;
  static std::atomic<size_t> done[kMaxDevices];
  auto kernel = conv2d_bn_act_kernel<Op, CFG, VEC>;
  cudaError_t err = raise_smem_limit(kernel, L::kSmem, done);
  if (err != cudaSuccess) return err;
  const int64_t blocks =
      (p.M + Tile<CFG>::BM - 1) / Tile<CFG>::BM * int64_t(p.ntiles);
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  kernel<<<unsigned(blocks), L::kThreads, L::kSmem, stream>>>(p);
  return cudaGetLastError();
}

template <class Op, int CFG>
cudaError_t launch(Params p, cudaStream_t stream) {
  p.ntiles = (p.Cout + Tile<CFG>::BN - 1) / Tile<CFG>::BN;
  p.steps_per_tap = p.Cin / Step<Op>::kBK;
  p.nsteps = p.taps * p.steps_per_tap;
  if (p.Cout % Layout<Op, CFG>::kVec == 0)
    return launch_vec<Op, CFG, true>(p, stream);
  return launch_vec<Op, CFG, false>(p, stream);
}

template <class Op>
cudaError_t launch_tile(const Params& p, int tile, cudaStream_t stream) {
  switch (tile) {
    case 0: return launch<Op, 0>(p, stream);
    case 1: return launch<Op, 1>(p, stream);
    case 2: return launch<Op, 2>(p, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16 (x, w, residual and y). x [B, H, W, Cin],
// w [KH, KW, Cin, Cout], scale and shift [Cout] float32, residual (or null)
// and y [B, Hout, Wout, Cout], all contiguous and 16-byte aligned.
// Requires Cin % 64 == 0 (the wrapper takes Cin % 128 == 0). tile: the
// index of the tile configuration, 0-2 (ops/cuda/conv.py TILES).
int paddle_conv2d_bn_act(int dtype, const void* x, const void* w,
                         const void* scale, const void* shift,
                         const void* residual, void* y, int B, int H, int W,
                         int Cin, int KH, int KW, int Cout, int stride,
                         int pad, int Hout, int Wout, int relu, int tile,
                         void* stream) {
  if (Cin <= 0 || Cin % kMaxBK != 0 || KH <= 0 || KW <= 0 || Cout <= 0 ||
      stride <= 0 || pad < 0 || tile < 0 || tile >= kTiles)
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
  p.taps = KH * KW;
  p.ntiles = 1;
  p.M = int64_t(B) * Hout * Wout;
  if (p.M <= 0) return int(cudaSuccess);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return int(launch_tile<Tf32x3>(p, tile, st));
    case 1: return int(launch_tile<Bf16>(p, tile, st));
  }
  return int(cudaErrorInvalidValue);
}

const char* paddle_conv2d_bn_act_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
