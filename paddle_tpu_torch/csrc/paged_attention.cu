// Paged decode attention for NVIDIA Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel `_paged_kernel`, reached through
// `_paged_pallas` (paddle_tpu/ops/pallas/paged_attention.py:108 and :153;
// entry `paged_decode_attention:196`). It computes the same function as
// `paged_attention_reference:62`: for every row b, one query q[b] of
// [H, D] attends over the first seq_lens[b] tokens of its sequence, whose
// keys and values live in fixed-size blocks of a [num_blocks, block_tokens,
// H, D] arena, token t at (tables[b][t / block_tokens], t % block_tokens).
// out[b, h] = softmax(scale * q[b, h] . K^T) V in float32; a row of length
// 0 writes zeros. The arenas may hold float32, bfloat16 bits (widened as
// bits << 16) or int8 codes with one float32 scale per (block, head)
// (value = code * scale); the Pallas path took float32 only.
//
// What bounds it on this card. Each (row, head) reads its length times D
// keys and values once and does 4 D FLOPs per key: one FLOP per byte of
// float32 K/V, far below the card's 20 FLOP per byte of float32 CUDA-core
// work, so in the decode form it is bound by the bytes it reads. (In the
// prefill form the rows share one sequence, each K/V byte serves many rows,
// and the bound is the FLOPs.) The design spends nothing on the score
// matrix and keeps many loads in flight:
//
//  * a row's tokens are cut into tiles of 32, and the tiles are dealt to 4
//    chains by index (tile i to chain i % 4), each an online softmax with
//    its own running max, sum and accumulator in registers; a warp folds a
//    tile with one token per lane for the scores and D / 32 feature
//    columns per lane for the output, the tile max and sum being warp
//    butterflies; at the end the 4 chains merge in a fixed order;
//  * a tile of K and V is staged in shared memory, widened to float32,
//    with rows padded to D + 1 so that a lane's row walk and the warp's
//    column reads fall in distinct banks; a warp loads a tile row by row,
//    each load instruction reading 32 consecutive values of one row, with
//    up to 32 loads a lane in flight before the first store;
//  * in the decode form every row has its own table, and the 4 warps of a
//    block run the 4 chains of one (row, head) side by side; in the
//    prefill form (one table shared by all rows, as the rows of one prompt
//    chunk share their sequence) the warps of a block take consecutive
//    rows of one head, each running its row's 4 chains, and the block
//    stages each tile once for all of them;
//  * the walk stops at the row's length, so table entries past it (the -1
//    padding included) are never read.
//
// Determinism: a row's arithmetic depends only on its own q, table and
// length, never on the batch or the form: the chain of a tile and the
// merge order are functions of the length alone, and both forms fold the
// same staged values with the same code. Every floating-point operation of
// the fold and the merge is an explicitly rounded intrinsic, so the
// compiler cannot contract it differently in one place than in another.
// The serving tier relies on this: a token's attention is bit for bit the
// same in a prefill chunk, in a decode batch of any size, and after a
// preemption and re-prefill.
//
// The kernel launches on the caller's stream, allocates nothing and does
// not synchronise. The entry point returns the cudaError_t of its launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kTile = 32;           // tokens per tile, one per lane
constexpr int kChains = 4;          // a row's tiles, dealt by index
constexpr int kSharedRows = 32;     // most rows (warps) per prefill block
constexpr float kNegInf = -1e30f;   // mask value of the JAX kernel
constexpr int kMaxDevices = 64;

enum Storage { kF32 = 0, kBF16 = 1, kInt8 = 2 };

struct Params {
  const float* q;            // [B, H, D]
  const void* k;             // [NB, BT, H, D]
  const void* v;
  const float* k_scales;     // [NB, H] for int8, else null
  const float* v_scales;
  const int* tables;         // [B, MB], or [1, MB] in the prefill form
  const int* lens;           // [B]
  float* out;                // [B, H, D]
  int B, H, D, bt, max_blocks;
  float scale;
};

template <int S>
__device__ __forceinline__ float widen(const void* arena, int64_t i, float s) {
  if (S == kF32) return static_cast<const float*>(arena)[i];
  if (S == kBF16)
    return __uint_as_float(uint32_t(static_cast<const uint16_t*>(arena)[i])
                           << 16);
  return __fmul_rn(float(static_cast<const int8_t*>(arena)[i]), s);
}

// Shared-memory layout of one staged tile: token offsets, int8 scales,
// then K and V as [kTile][D + 1] float32.
struct Tile {
  int64_t* off;
  float* sk;
  float* sv;
  float* k;
  float* v;
};

__host__ __device__ constexpr size_t tile_bytes(int D) {
  return sizeof(int64_t) * kTile + sizeof(float) * (2 * kTile)
         + sizeof(float) * (2 * size_t(kTile) * (D + 1));
}

__device__ __forceinline__ Tile carve_tile(char* base, int D) {
  Tile t;
  t.off = reinterpret_cast<int64_t*>(base);
  t.sk = reinterpret_cast<float*>(t.off + kTile);
  t.sv = t.sk + kTile;
  t.k = t.sv + kTile;
  t.v = t.k + kTile * (D + 1);
  return t;
}

// Token offsets (and int8 scales) of tokens t0 .. t0 + 31 below n_load,
// by the 32 lanes of one warp.
template <int S>
__device__ __forceinline__ void tile_offsets(const Params& p,
                                             const int* table, int h, int t0,
                                             int n_load, const Tile& tile,
                                             int lane) {
  const int tok = t0 + lane;
  int64_t off = 0;
  float sk = 1.f, sv = 1.f;
  if (tok < n_load) {
    const int blk = table[tok / p.bt];
    off = ((int64_t(blk) * p.bt + tok % p.bt) * p.H + h) * p.D;
    if (S == kInt8) {
      sk = p.k_scales[int64_t(blk) * p.H + h];
      sv = p.v_scales[int64_t(blk) * p.H + h];
    }
  }
  tile.off[lane] = off;
  tile.sk[lane] = sk;
  tile.sv[lane] = sv;
}

// Rows j = j_first, j_first + j_step, ... of the tile (those below
// n_load - t0), widened into shared memory by one warp: a load reads 32
// consecutive values of one row, and kGroup rows are loaded into registers
// before any is stored, so that their loads are in flight together. Rows
// past the length are left as they are: no fold reads them.
template <int NV, int S, int kGroup>
__device__ __forceinline__ void load_rows(const Params& p, const Tile& tile,
                                          int t0, int n_load, int j_first,
                                          int j_step, int lane) {
  const int D = p.D, DP = D + 1;
  const int jn = min(kTile, n_load - t0);
  for (int j0 = j_first; j0 < jn; j0 += kGroup * j_step) {
    float kr[kGroup][NV], vr[kGroup][NV];
#pragma unroll
    for (int g = 0; g < kGroup; ++g) {
      const int j = j0 + g * j_step;
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const int d = lane + 32 * i;
        kr[g][i] = 0.f;
        vr[g][i] = 0.f;
        if (j < jn && d < D) {
          const int64_t x = tile.off[j] + d;
          kr[g][i] = widen<S>(p.k, x, tile.sk[j]);
          vr[g][i] = widen<S>(p.v, x, tile.sv[j]);
        }
      }
    }
#pragma unroll
    for (int g = 0; g < kGroup; ++g) {
      const int j = j0 + g * j_step;
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const int d = lane + 32 * i;
        if (j < jn && d < D) {
          tile.k[j * DP + d] = kr[g][i];
          tile.v[j * DP + d] = vr[g][i];
        }
      }
    }
  }
}

// One chain's running softmax state for one (row, head).
template <int NV>
struct RowState {
  float m, l;
  float acc[NV];
};

template <int NV>
__device__ __forceinline__ void init_row(RowState<NV>& st) {
  st.m = kNegInf;
  st.l = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i) st.acc[i] = 0.f;
}

// Fold one staged tile into a chain of the row whose length is n (the
// tile starts at t0 < n). Lane j scores token t0 + j; lane `lane` owns the
// output columns lane + 32 i.
template <int NV>
__device__ __forceinline__ void fold_tile(RowState<NV>& st, const float* qs,
                                          const Tile& tile, int D, int t0,
                                          int n, float scale, int lane) {
  const int DP = D + 1;
  const bool vis = t0 + lane < n;
  float s = kNegInf;
  if (vis) {
    const float* kr = tile.k + lane * DP;
    float dot = 0.f;
    for (int d = 0; d < D; ++d) dot = __fmaf_rn(qs[d], kr[d], dot);
    s = __fmul_rn(dot, scale);
  }
  float tmax = s;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, o));
  const float m_new = fmaxf(st.m, tmax);
  const float alpha = expf(__fsub_rn(st.m, m_new));
  const float pr = vis ? expf(__fsub_rn(s, m_new)) : 0.f;
  float psum = pr;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    psum = __fadd_rn(psum, __shfl_xor_sync(0xffffffffu, psum, o));
  st.l = __fadd_rn(__fmul_rn(st.l, alpha), psum);
  st.m = m_new;
#pragma unroll
  for (int i = 0; i < NV; ++i) st.acc[i] = __fmul_rn(st.acc[i], alpha);
  const int jmax = min(kTile, n - t0);
  for (int jj = 0; jj < jmax; ++jj) {
    const float pj = __shfl_sync(0xffffffffu, pr, jj);
    const float* vr = tile.v + jj * DP;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int d = lane + 32 * i;
      if (d < D) st.acc[i] = __fmaf_rn(pj, vr[d], st.acc[i]);
    }
  }
}

// Merge the 4 chains in chain order and write the row (zeros for n = 0).
template <int NV>
__device__ __forceinline__ void merge_store(const RowState<NV> (&st)[kChains],
                                            float* orow, int D, int n,
                                            int lane) {
  float m = st[0].m;
#pragma unroll
  for (int c = 1; c < kChains; ++c) m = fmaxf(m, st[c].m);
  float l = 0.f;
  float acc[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i) acc[i] = 0.f;
#pragma unroll
  for (int c = 0; c < kChains; ++c) {
    const float w = expf(__fsub_rn(st[c].m, m));
    l = __fadd_rn(l, __fmul_rn(st[c].l, w));
#pragma unroll
    for (int i = 0; i < NV; ++i)
      acc[i] = __fadd_rn(acc[i], __fmul_rn(st[c].acc[i], w));
  }
  const float l_safe = fmaxf(l, 1e-30f);
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int d = lane + 32 * i;
    if (d < D) orow[d] = n > 0 ? __fdiv_rn(acc[i], l_safe) : 0.f;
  }
}

// Decode form: block b owns (row, head) = (b / H, b % H) with its own
// table; its W warps run the 4 chains (warp w the chains w, w + W, ...),
// each staging its own tiles, then hand their states to warp 0 to merge.
template <int NV, int W>
__host__ __device__ constexpr size_t decode_smem(int D) {
  return (tile_bytes(D) * W + sizeof(float) * D
          + sizeof(float) * kChains * (2 + 32 * NV) + 15) / 16 * 16;
}

template <int NV, int S, int W>
__global__ void __launch_bounds__(32 * W)
paged_decode_kernel(Params p) {
  extern __shared__ __align__(16) char smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row = blockIdx.x;
  const int b = row / p.H, h = row - (row / p.H) * p.H;
  const int D = p.D;
  const Tile tile = carve_tile(smem + size_t(warp) * tile_bytes(D), D);
  float* qs = reinterpret_cast<float*>(smem + size_t(W) * tile_bytes(D));
  float* cm = qs + D;                     // [kChains] chain maxima
  float* cl = cm + kChains;               // [kChains] chain sums
  float* cacc = cl + kChains;             // [kChains][32 * NV]
  const float* qrow = p.q + int64_t(row) * D;
  for (int d = threadIdx.x; d < D; d += 32 * W) qs[d] = qrow[d];
  __syncthreads();
  const int n = max(p.lens[b], 0);
  const int* table = p.tables + int64_t(b) * p.max_blocks;
#pragma unroll
  for (int c0 = 0; c0 < kChains; c0 += W) {
    const int c = c0 + warp;
    RowState<NV> st;
    init_row(st);
    for (int t0 = c * kTile; t0 < n; t0 += kChains * kTile) {
      tile_offsets<S>(p, table, h, t0, n, tile, lane);
      __syncwarp();
      load_rows<NV, S, (16 / NV > 0 ? 16 / NV : 1)>(p, tile, t0, n, 0, 1,
                                                    lane);
      __syncwarp();
      fold_tile<NV>(st, qs, tile, D, t0, n, p.scale, lane);
      __syncwarp();  // the tile is consumed before the next load
    }
    if (lane == 0) {
      cm[c] = st.m;
      cl[c] = st.l;
    }
#pragma unroll
    for (int i = 0; i < NV; ++i) cacc[c * 32 * NV + 32 * i + lane] = st.acc[i];
  }
  __syncthreads();
  if (warp == 0) {
    RowState<NV> st[kChains];
#pragma unroll
    for (int c = 0; c < kChains; ++c) {
      st[c].m = cm[c];
      st[c].l = cl[c];
#pragma unroll
      for (int i = 0; i < NV; ++i) st[c].acc[i] = cacc[c * 32 * NV + 32 * i + lane];
    }
    merge_store<NV>(st, p.out + int64_t(row) * D, D, n, lane);
  }
}

// Prefill form: every row reads the one table `tables[0]`; block
// (blockIdx.x, h) owns rows blockIdx.x * G .. + G - 1 of head h, one per
// warp, and stages each tile once for all of them, up to the longest row.
template <int NV, int S>
__global__ void __launch_bounds__(32 * kSharedRows)
paged_prefill_kernel(Params p) {
  extern __shared__ __align__(16) char smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int G = blockDim.x >> 5;
  const int h = blockIdx.y;
  const int b = blockIdx.x * G + warp;
  const int D = p.D;
  const Tile tile = carve_tile(smem, D);
  float* qs = reinterpret_cast<float*>(smem + tile_bytes(D)) + warp * D;
  __shared__ int n_max;
  const bool live = b < p.B;
  const int n = live ? max(p.lens[b], 0) : 0;
  if (live) {
    const float* qrow = p.q + (int64_t(b) * p.H + h) * D;
    for (int d = lane; d < D; d += 32) qs[d] = qrow[d];
  }
  if (threadIdx.x == 0) n_max = 0;
  __syncthreads();
  if (lane == 0 && n > 0) atomicMax(&n_max, n);
  __syncthreads();
  const int n_load = n_max;
  RowState<NV> st[kChains];
#pragma unroll
  for (int c = 0; c < kChains; ++c) init_row(st[c]);
  for (int t00 = 0; t00 < n_load; t00 += kChains * kTile) {
#pragma unroll
    for (int c = 0; c < kChains; ++c) {
      const int t0 = t00 + c * kTile;
      if (t0 < n_load) {  // uniform over the block
        if (warp == 0) tile_offsets<S>(p, p.tables, h, t0, n_load, tile, lane);
        __syncthreads();
        // a warp a row: few registers beside the 4 chains' states
        load_rows<NV, S, 1>(p, tile, t0, n_load, warp, G, lane);
        __syncthreads();
        if (t0 < n) fold_tile<NV>(st[c], qs, tile, D, t0, n, p.scale, lane);
        __syncthreads();  // every warp is done with the tile
      }
    }
  }
  if (live) merge_store<NV>(st, p.out + (int64_t(b) * p.H + h) * D, D, n, lane);
}

// Dynamic shared memory above 48 KB needs the kernel's limit raised; each
// kernel raises it once per device to the largest size launched so far.
template <typename Kernel>
cudaError_t raise_smem_limit(Kernel kernel, size_t bytes,
                             std::atomic<size_t>* done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (bytes <= 48 * 1024) return cudaSuccess;
  if (dev < kMaxDevices && done[dev].load(std::memory_order_acquire) >= bytes)
    return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(bytes));
  if (err == cudaSuccess && dev < kMaxDevices) done[dev].store(bytes);
  return err;
}

template <int NV, int S>
cudaError_t launch(const Params& p, int shared, cudaStream_t stream) {
  static std::atomic<size_t> decode_done[kMaxDevices];
  static std::atomic<size_t> prefill_done[kMaxDevices];
  // warps per decode block: one per chain, but one in all at D > 128,
  // where 4 staged tiles would not fit in shared memory
  constexpr int W = NV <= 4 ? kChains : 1;
  cudaError_t err;
  if (shared) {
    const int G = p.B < kSharedRows ? p.B : kSharedRows;
    const size_t smem = tile_bytes(p.D) + sizeof(float) * size_t(G) * p.D;
    err = raise_smem_limit(paged_prefill_kernel<NV, S>, smem, prefill_done);
    if (err != cudaSuccess) return err;
    const dim3 grid((p.B + G - 1) / G, p.H);
    paged_prefill_kernel<NV, S><<<grid, 32 * G, smem, stream>>>(p);
  } else {
    const size_t smem = decode_smem<NV, W>(p.D);
    err = raise_smem_limit(paged_decode_kernel<NV, S, W>, smem, decode_done);
    if (err != cudaSuccess) return err;
    const int64_t rows = int64_t(p.B) * p.H;
    paged_decode_kernel<NV, S, W><<<unsigned(rows), 32 * W, smem, stream>>>(p);
  }
  return cudaGetLastError();
}

template <int S>
cudaError_t launch_storage(const Params& p, int shared, cudaStream_t st) {
  if (p.D <= 32) return launch<1, S>(p, shared, st);
  if (p.D <= 64) return launch<2, S>(p, shared, st);
  if (p.D <= 128) return launch<4, S>(p, shared, st);
  return launch<8, S>(p, shared, st);
}

}  // namespace

extern "C" {

// q: [B, H, D] float32; k_arena, v_arena: [num_blocks, block_tokens, H, D]
// of float32 (storage 0), bfloat16 bits (1) or int8 codes (2); k_scales,
// v_scales: [num_blocks, H] float32 for storage 2, else null; tables: int32
// [B, max_blocks], or [1, max_blocks] shared by every row when
// shared_table = 1; seq_lens: [B] int32; out: [B, H, D] float32. All on
// the device, contiguous. 1 <= D <= 256.
int paddle_paged_attention(const float* q, const void* k_arena,
                           const void* v_arena, const float* k_scales,
                           const float* v_scales, const int* tables,
                           const int* seq_lens, float* out, int B, int H,
                           int D, int block_tokens, int max_blocks,
                           int storage, int shared_table, float scale,
                           void* stream) {
  if (B <= 0 || H <= 0) return int(cudaSuccess);
  if (D < 1 || D > 256 || block_tokens < 1 || H > 65535)
    return int(cudaErrorInvalidValue);
  if (storage == kInt8 && (k_scales == nullptr || v_scales == nullptr))
    return int(cudaErrorInvalidValue);
  Params p{q, k_arena, v_arena, k_scales, v_scales, tables, seq_lens, out,
           B, H, D, block_tokens, max_blocks, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int shared = shared_table && B > 1;
  if (storage == kF32) return int(launch_storage<kF32>(p, shared, st));
  if (storage == kBF16) return int(launch_storage<kBF16>(p, shared, st));
  if (storage == kInt8) return int(launch_storage<kInt8>(p, shared, st));
  return int(cudaErrorInvalidValue);
}

const char* paddle_paged_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
