// Paged attention for NVIDIA Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel `_paged_kernel`, reached through
// `_paged_pallas` (paddle_tpu/ops/pallas/paged_attention.py:108 and :153;
// entry `paged_decode_attention:196`). It computes the same function as
// `paged_attention_reference:62`: for every row b, one query q[b] of
// [H, D] attends over the first seq_lens[b] tokens of its sequence, whose
// keys and values live in fixed-size blocks of a [num_blocks, block_tokens,
// H, D] arena, token t at (tables[b][t / block_tokens], t % block_tokens).
// out[b, h] = softmax(scale * q[b, h] . K^T) V in float32; a row of length
// 0 writes zeros. The arenas may hold float32, bfloat16 bits or int8 codes
// with one float32 scale per (block, head) (value = code * scale); the
// Pallas path took float32 only. Two forms: decode (a table per row) and
// prefill (one table [1, max_blocks] shared by every row, as the rows of a
// prompt chunk share their sequence).
//
// What bounds it on this card. The decode form reads each row's keys and
// values once for 4 D FLOPs a token: one FLOP per byte of float32 K/V, so
// it is bound by the bytes it reads (at D 64 a 32-token float32 tile is 16
// KB, some 1,180 SM cycles of the SM's share of 3.35 TB/s, against a few
// hundred cycles of products). In the prefill form the rows share one
// sequence, each K/V byte serves up to 512 rows, and the bound is the
// products: float32-accurate on the tensor cores, a third of the TF32 rate.
// The previous kernel ran every product on the float32 CUDA cores, one FMA
// at a time, and read bf16 and int8 one element a lane per load, so those
// arenas decoded slower than float32 at half and a quarter of the bytes.
// Design:
//
//  * Products on the tensor cores with mma.sync.m16n8k8.tf32 (the fragment
//    code of csrc/tensor_core.cuh, shared with K1-K3): S = q K^T over a
//    staged tile of 32 tokens, then O += P V. A float32 operand x
//    is split into hi = tf32(x) and lo = x - hi (3xTF32: lo*hi + hi*lo +
//    hi*hi); a K or V that is exact in tf32 (bf16 widened by a shift, int8
//    codes) has no lo part, so two products suffice. Int8 scales multiply
//    after the product: S's columns by the key scale, P's columns by the
//    value scale before P V. Each group of up to four depth steps sums
//    from zero and joins its sum by a float32 add (the tensor cores round
//    toward zero; summed in place, a long walk drifts).
//  * A warp folds a tile for 16 query rows of one head. Prefill: the 16
//    rows of a 16-row group; decode: its row is row 0 of the A fragment and
//    the other rows are zero. A row of an mma.sync result depends only on
//    that row of A and on B, so both forms compute a row the same way.
//  * A row's tiles are dealt to 4 chains by index (tile i to chain i % 4),
//    each an online softmax (running max, sum, accumulator in registers);
//    warps of a block run chains side by side (4 at once, or 2 or 1 where
//    the staged tiles of 4 would not fit in shared memory), and the 4
//    chain states merge in chain order through shared memory, one thread
//    an output element.
//  * Decode: a block owns one (row, head); its warps are its chains, each
//    staging its own tiles. Prefill: a block owns 64 rows (16 at D > 64)
//    of one head: 4 row groups x 4 chains, 16 warps; the 4 warps of a
//    chain share each of its staged tiles (a named barrier each).
//  * Loads: K and V tiles (and int8 scales) arrive by cp.async into a ring
//    of two stages, so tile t + 1 is in flight while tile t folds. Values
//    are staged as stored (f32, bf16 or int8) and widened as fragments
//    load, so a 16-byte copy moves 4, 8 or 16 values. Because of the
//    paging a tile's tokens come from up to ceil(32 / block_tokens) + 1
//    blocks; each token's [D] row is contiguous, and a row whose bytes are
//    not a multiple of 16 takes the widest copy that divides it (8, 4, or
//    plain 2- and 1-byte loads), so every D from 1 to 256 is taken. The
//    block table entry of the next tile is loaded a tile ahead.
//  * D is padded to 8, 16, 32, 64, 128 or 256 (at least 16 for int8) with
//    zeros in shared memory, and rows are padded by 16 bytes so that every
//    fragment load of a warp falls in distinct banks.
//  * The walk stops at the row's length (in prefill, the longest row of the
//    block), so table entries past it (the -1 padding) are never read.
//
// Determinism: a row's arithmetic depends only on its own q, table and
// length, never on the batch, the row count or the form. The chain of a
// tile, the fold order and the merge order are functions of the length and
// D alone, and both forms run the same fold on the same staged values
// (tokens past a row's length get p = 0 whether they are staged or
// zero-filled). In a prefill block a row whose length ends before a tile
// keeps its chain state as it was: the fold's result is not selected for
// it. Every floating-point operation of the fold and the merge outside the
// tensor cores is an explicitly rounded intrinsic, so the compiler cannot
// contract it differently in one place than in another. The serving tier
// relies on this: a token's attention is bit for bit the same in a prefill
// chunk, in a decode batch of any size, and after a preemption and
// re-prefill. There are no atomics on values.
//
// What remains: wgmma (64-row warpgroup products; TF32 wgmma wants K-major
// operands in shared memory, which P V's V is not) and TMA with mbarriers
// for the paged gathers; the decode form uses 1/16 of each product.
//
// The kernel launches on the caller's stream, allocates nothing and does
// not synchronise. The entry point returns the cudaError_t of its launch;
// an arena base not aligned to the copy width gets cudaErrorMisalignedAddress
// (the wrapper checks first).

#include "tensor_core.cuh"

namespace {

constexpr int kTile = 32;          // tokens per tile
constexpr int kChains = 4;         // a row's tiles, dealt by index
constexpr float kNegInf = -1e30f;  // mask value of the JAX kernel
// a block's shared memory, less the static
constexpr int kMaxSmem = 232448 - 1024;

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
  int shared;                // the prefill form
  int chains_at_once;        // warps of a row group: 4, 2 or 1
  int stages;                // staged tiles a chain: 2 (a ring) or 1
  int width;                 // bytes a copy moves: 16, 8, 4, 2 or 1
};

// Geometry of one storage type at a padded head dim DP.
template <int S, int DP>
struct Geo {
  static constexpr int kEsize = S == kF32 ? 4 : S == kBF16 ? 2 : 1;
  static constexpr int kRowBytes = DP * kEsize + 16;  // padded row
  static constexpr int kTileBytes = kTile * kRowBytes;
  // K, V, then (int8) the tokens' key and value scales
  static constexpr int kStageBytes =
      2 * kTileBytes + (S == kInt8 ? 2 * kTile * 4 : 0);
  static constexpr int kQStride = DP + 4;  // floats, = 4 (mod 8)
};

__host__ __device__ constexpr size_t q_bytes(int rows, int DP) {
  return sizeof(float) * size_t(rows) * (DP + 4);
}

__host__ __device__ constexpr size_t merge_bytes(int rows, int DP) {
  return sizeof(float) * size_t(kChains) * rows * (DP + 2);
}

// ------------------------------------------------------- asynchronous copies

// W bytes from src to dst, or W zeros when !valid (src not read then).
// 16, 8 and 4 bytes go by cp.async; 2 and 1 by plain loads.
__device__ __forceinline__ void copy_chunk(unsigned char* dst,
                                           const unsigned char* src,
                                           bool valid, int W) {
  if (W == 16) {
    cp_async_16(dst, src, valid);
  } else if (W == 8) {
    cp_async_8(dst, src, valid);
  } else if (W == 4) {
    cp_async_4(dst, src, valid);
  } else if (W == 2) {
    *reinterpret_cast<uint16_t*>(dst) =
        valid ? *reinterpret_cast<const uint16_t*>(src) : uint16_t(0);
  } else {
    *dst = valid ? *src : static_cast<unsigned char>(0);
  }
}

// the warps that share one chain's tiles: a named barrier each (G > 1)
template <int G>
__device__ __forceinline__ void chain_sync(int slot) {
  if (G == 1) {
    __syncwarp();
  } else {
    asm volatile("bar.sync %0, %1;\n" ::"r"(slot + 1), "r"(32 * G)
                 : "memory");
  }
}

// ------------------------------------------------------------ mma fragments

// the 3xTF32 fragments of csrc/tensor_core.cuh: q and P are A, K and V B
using FragA = Tf32x3::A;
using FragB = Tf32x3::B;

// one stored value, widened to float32
template <int S>
__device__ __forceinline__ float widen(const unsigned char* p) {
  if (S == kF32) return *reinterpret_cast<const float*>(p);
  if (S == kBF16)
    return __uint_as_float(uint32_t(*reinterpret_cast<const uint16_t*>(p))
                           << 16);
  return float(*reinterpret_cast<const int8_t*>(p));
}

template <int S>
__device__ __forceinline__ void set_b(FragB& b, int i, float x) {
  if (S == kF32) {
    Tf32x3::split(x, b.hi[i], b.lo[i]);
  } else {
    b.hi[i] = __float_as_uint(x);  // exact in tf32
  }
}

// B[k][n] = K[token n0 + n][k0 + k]
template <int S, int DP>
__device__ __forceinline__ FragB load_k(const unsigned char* kt, int n0,
                                        int k0) {
  using G = Geo<S, DP>;
  const unsigned char* r =
      kt + (n0 + lane_g()) * G::kRowBytes + (k0 + lane_t()) * G::kEsize;
  FragB b;
  set_b<S>(b, 0, widen<S>(r));
  set_b<S>(b, 1, widen<S>(r + 4 * G::kEsize));
  return b;
}

// B[k][n] = V[token k0 + k][n0 + n], the depth permuted as in the P
// fragment: logical rows t and t + 4 are tokens 2t and 2t + 1
template <int S, int DP>
__device__ __forceinline__ FragB load_v(const unsigned char* vt, int k0,
                                        int n0) {
  using G = Geo<S, DP>;
  const unsigned char* r =
      vt + (k0 + 2 * lane_t()) * G::kRowBytes + (n0 + lane_g()) * G::kEsize;
  FragB b;
  set_b<S>(b, 0, widen<S>(r));
  set_b<S>(b, 1, widen<S>(r + G::kRowBytes));
  return b;
}

// ------------------------------------------------------------------ the fold

// One chain's running softmax state for the warp's 16 rows: rows g and
// g + 8 of lane (g, t), their columns 8n + 2t and 8n + 2t + 1.
template <int DT>
struct ChainState {
  float m[2], l[2];
  float acc[DT][4];
};

template <int DT>
__device__ __forceinline__ void init_state(ChainState<DT>& st) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    st.m[r] = kNegInf;
    st.l[r] = 0.f;
  }
#pragma unroll
  for (int n = 0; n < DT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) st.acc[n][e] = 0.f;
}

// Fold one staged tile (tokens t0 .. t0 + 31) into a chain of the warp's
// 16 rows, whose lengths are n[0] (row g) and n[1] (row g + 8). A row with
// t0 >= its length keeps its state.
template <int S, int DP>
__device__ __forceinline__ void fold_tile(ChainState<DP / 8>& st,
                                          const float* qw,
                                          const unsigned char* stage,
                                          int t0, const int* n,
                                          float scale) {
  using Gm = Geo<S, DP>;
  constexpr int DT = DP / 8;               // 8-wide tiles of D
  constexpr int kGS = DT < 4 ? DT : 4;     // depth steps a group
  constexpr bool kExact = S != kF32;
  const unsigned char* kt = stage;
  const unsigned char* vt = stage + Gm::kTileBytes;
  const float* sk = reinterpret_cast<const float*>(stage + 2 * Gm::kTileBytes);
  const float* sv = sk + kTile;
  const int t = lane_t();

  // S = q K^T over the tile's 4 8-token tiles
  float s[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
  for (int k0 = 0; k0 < DT; k0 += kGS) {
    FragA fa[kGS];
#pragma unroll
    for (int i = 0; i < kGS; ++i)
      fa[i] = Tf32x3::load_a(qw, Gm::kQStride, 8 * (k0 + i));
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      FragB fb[kGS];
#pragma unroll
      for (int i = 0; i < kGS; ++i)
        fb[i] = load_k<S, DP>(kt, 8 * j, 8 * (k0 + i));
      float part[4];
      Tf32x3::mma_sum<kGS, kExact>(part, fa, fb);
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = __fadd_rn(s[j][e], part[e]);
    }
  }

  // the online softmax of the two rows, quad shuffles across the tile
  bool live[2];
  float tmax[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int r = 0; r < 2; ++r) live[r] = t0 < n[r];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int tok = 8 * j + 2 * t + (e & 1);
      float x = s[j][e];
      if (S == kInt8) x = __fmul_rn(x, sk[tok]);
      x = t0 + tok < n[e >> 1] ? __fmul_rn(x, scale) : kNegInf;
      s[j][e] = x;
      tmax[e >> 1] = fmaxf(tmax[e >> 1], x);
    }
  float m_new[2], alpha[2], psum[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 1));
    tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 2));
    m_new[r] = fmaxf(st.m[r], tmax[r]);
    alpha[r] = expf(__fsub_rn(st.m[r], m_new[r]));
    psum[r] = 0.f;
  }
  float pv[4][4];  // P, times the value scales for int8
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1;
      const int tok = 8 * j + 2 * t + (e & 1);
      const float p =
          t0 + tok < n[r] ? expf(__fsub_rn(s[j][e], m_new[r])) : 0.f;
      psum[r] = __fadd_rn(psum[r], p);
      pv[j][e] = S == kInt8 ? __fmul_rn(p, sv[tok]) : p;
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    psum[r] = __fadd_rn(psum[r], __shfl_xor_sync(0xffffffffu, psum[r], 1));
    psum[r] = __fadd_rn(psum[r], __shfl_xor_sync(0xffffffffu, psum[r], 2));
  }

  // O = O alpha + P V: the tile's 4 depth steps are one group
  FragA fa[4];
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) fa[kc] = Tf32x3::from_acc(pv, kc);
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) {
    FragB fb[4];
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) fb[kc] = load_v<S, DP>(vt, 8 * kc, 8 * dt);
    float part[4];
    Tf32x3::mma_sum<4, kExact>(part, fa, fb);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1;
      const float x = __fadd_rn(__fmul_rn(st.acc[dt][e], alpha[r]), part[e]);
      st.acc[dt][e] = live[r] ? x : st.acc[dt][e];
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float l = __fadd_rn(__fmul_rn(st.l[r], alpha[r]), psum[r]);
    st.l[r] = live[r] ? l : st.l[r];
    st.m[r] = live[r] ? m_new[r] : st.m[r];
  }
}

// Where thread `tid` of a chain slot starts in a tile's copies (token j,
// byte c of its row) and how far it steps: cpr copies a row, 32 G threads.
struct CopyWalk {
  int j, c, dj, dc, rounds;
};

template <int G>
__device__ __forceinline__ CopyWalk copy_walk(int tid, int cpr, int W) {
  const int step = 32 * G;
  return CopyWalk{tid / cpr, (tid % cpr) * W, step / cpr, (step % cpr) * W,
                  (kTile * cpr + step - 1) / step};
}

// Stage tile (tokens t0 .. t0 + 31, those at or past n_load zero-filled)
// by the 32 G threads of one chain slot; `off` is lane j's token offset in
// elements and `blk` its block (both for t0 + j < n_load).
template <int S, int DP, int G>
__device__ __forceinline__ void load_stage(const Params& p,
                                           unsigned char* stage, int t0,
                                           int n_load, int64_t off, int blk,
                                           int h, int tid,
                                           const CopyWalk& cw) {
  using Gm = Geo<S, DP>;
  const int W = p.width;
  const int row = p.D * Gm::kEsize;
  const unsigned char* ka = static_cast<const unsigned char*>(p.k);
  const unsigned char* va = static_cast<const unsigned char*>(p.v);
  int j = cw.j, c = cw.c;
  for (int r = 0; r < cw.rounds; ++r) {  // uniform over the warp
    const int64_t o = __shfl_sync(0xffffffffu, off, min(j, kTile - 1));
    if (j < kTile) {
      const bool valid = t0 + j < n_load;
      const int64_t src = valid ? o * Gm::kEsize + c : 0;
      copy_chunk(stage + j * Gm::kRowBytes + c, ka + src, valid, W);
      copy_chunk(stage + Gm::kTileBytes + j * Gm::kRowBytes + c, va + src,
                 valid, W);
    }
    j += cw.dj;
    c += cw.dc;
    if (c >= row) {
      c -= row;
      ++j;
    }
  }
  if (S == kInt8 && tid < 32) {
    float* sk = reinterpret_cast<float*>(stage + 2 * Gm::kTileBytes);
    const bool valid = t0 + tid < n_load;
    const int64_t x = valid ? int64_t(blk) * p.H + h : 0;
    cp_async_4(sk + tid, p.k_scales + x, valid);
    cp_async_4(sk + kTile + tid, p.v_scales + x, valid);
  }
}

// (block, element offset) of token `tok` of a sequence, or (0, 0) past
// n_load (the table is not read there)
__device__ __forceinline__ int token_block(const Params& p, const int* table,
                                           int tok, int n_load) {
  return tok < n_load ? table[tok / p.bt] : 0;
}

__device__ __forceinline__ int64_t token_offset(const Params& p, int blk,
                                                int tok, int h) {
  return ((int64_t(blk) * p.bt + tok % p.bt) * p.H + h) * p.D;
}

// Block (row block, head h = blockIdx.y). Decode: blockIdx.x is the row,
// which is row 0 of a 16-row group. Prefill: rows blockIdx.x * 16 G ..
// + 16 G - 1, group r of 16 in warps r, r + G, ... Warp w runs chains w /
// G, w / G + CP, ... of its group; CP = chains_at_once.
template <int S, int DP, int G>
__global__ void __launch_bounds__(128 * G, G == 1 && DP <= 64 ? 3 : 1)
paged_kernel(Params p) {
  using Gm = Geo<S, DP>;
  constexpr int DT = DP / 8;
  constexpr int R = 16 * G;  // rows of the block's A fragments
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int n_max;
  const int CP = p.chains_at_once;
  const size_t chain_bytes = size_t(p.stages) * Gm::kStageBytes;
  const int nthreads = blockDim.x;
  const int warp = threadIdx.x >> 5;
  const int slot = warp / G, grp = warp - slot * G;
  const int tid_slot = threadIdx.x - slot * 32 * G;
  const int h = blockIdx.y;
  const int row0 = p.shared ? blockIdx.x * R : blockIdx.x;
  const int nrows = p.shared ? min(R, p.B - row0) : 1;
  const int* table = p.shared ? p.tables
                              : p.tables + int64_t(row0) * p.max_blocks;

  float* qs = reinterpret_cast<float*>(smem);  // [R][kQStride]
  unsigned char* stages = smem + q_bytes(R, DP);
  unsigned char* my_stages = stages + slot * chain_bytes;
  const bool alias =
      CP == kChains && merge_bytes(R, DP) <= kChains * chain_bytes;
  float* mbuf = reinterpret_cast<float*>(alias ? stages
                                               : stages + CP * chain_bytes);

  // q of the block's rows (zeros elsewhere), the staged rows' padding
  for (int i = threadIdx.x; i < R * DP; i += nthreads) {
    const int r = i / DP, d = i - r * DP;
    qs[r * Gm::kQStride + d] =
        r < nrows && d < p.D ? p.q[(int64_t(row0 + r) * p.H + h) * p.D + d]
                             : 0.f;
  }
  {
    const int pad = (DP - p.D) * Gm::kEsize;
    const int rows = CP * p.stages * 2 * kTile;
    for (int i = threadIdx.x; i < rows * pad; i += nthreads) {
      const int r = i / pad, c = i - r * pad;
      const int tile = r / kTile, j = r - tile * kTile;
      const int stage = tile >> 1;  // K and V tiles of one stage
      stages[size_t(stage) * Gm::kStageBytes +
             (tile & 1) * Gm::kTileBytes + j * Gm::kRowBytes +
             p.D * Gm::kEsize + c] = 0;
    }
  }
  if (threadIdx.x == 0) n_max = 0;
  __syncthreads();
  for (int r = threadIdx.x; r < nrows; r += nthreads) {
    const int nr = p.lens[row0 + r];
    if (nr > 0) atomicMax(&n_max, nr);
  }
  __syncthreads();
  const int n_load = n_max;
  const int ra = grp * 16 + lane_g(), rb = ra + 8;
  const int n[2] = {ra < nrows ? max(p.lens[row0 + ra], 0) : 0,
                    rb < nrows ? max(p.lens[row0 + rb], 0) : 0};
  const float* qw = qs + grp * 16 * Gm::kQStride;
  const int lane = threadIdx.x & 31;
  const int n_tiles = (n_load + kTile - 1) / kTile;
  const CopyWalk cw =
      copy_walk<G>(tid_slot, p.D * Gm::kEsize / p.width, p.width);

  for (int c = slot; c < kChains; c += CP) {  // uniform: CP divides 4
    ChainState<DT> st;
    init_state(st);
    const int nt = n_tiles > c ? (n_tiles - c + kChains - 1) / kChains : 0;
    if (nt > 0) {
      // lane j's token in the next tile to stage, and its block, loaded a
      // tile ahead of its use (0 past n_load, where the table is not read)
      int kn = 0, tok = c * kTile + lane;
      int blk = token_block(p, table, tok, n_load);
      auto stage_next = [&](unsigned char* dst) {
        load_stage<S, DP, G>(p, dst, (c + kChains * kn) * kTile, n_load,
                             token_offset(p, blk, tok, h), blk, h, tid_slot,
                             cw);
        cp_async_commit();
        ++kn;
        tok += kChains * kTile;
        blk = token_block(p, table, tok, n_load);
      };
      if (p.stages == 2) stage_next(my_stages);
      for (int it = 0; it < nt; ++it) {
        unsigned char* stage =
            my_stages + (p.stages == 2 ? it & 1 : 0) * Gm::kStageBytes;
        if (p.stages == 1) {
          stage_next(stage);
          cp_async_wait<0>();
        } else if (it + 1 < nt) {  // the next tile loads while this folds
          stage_next(my_stages + ((it + 1) & 1) * Gm::kStageBytes);
          cp_async_wait<1>();
        } else {
          cp_async_wait<0>();
        }
        chain_sync<G>(slot);
        fold_tile<S, DP>(st, qw, stage, (c + kChains * it) * kTile, n,
                         p.scale);
        chain_sync<G>(slot);  // this stage is consumed before a refill
      }
    }
    if (alias) __syncthreads();  // every chain is done with the stages
    // the chain's state: acc [c][row][DP], then m and l [c][row]
    float* acc_c = mbuf + size_t(c) * R * DP;
    float* ml = mbuf + size_t(kChains) * R * DP;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      const int col = 8 * dt + 2 * lane_t();
      acc_c[ra * DP + col] = st.acc[dt][0];
      acc_c[ra * DP + col + 1] = st.acc[dt][1];
      acc_c[rb * DP + col] = st.acc[dt][2];
      acc_c[rb * DP + col + 1] = st.acc[dt][3];
    }
    if (lane_t() == 0) {
      ml[(c * R + ra) * 2] = st.m[0];
      ml[(c * R + ra) * 2 + 1] = st.l[0];
      ml[(c * R + rb) * 2] = st.m[1];
      ml[(c * R + rb) * 2 + 1] = st.l[1];
    }
  }
  __syncthreads();

  // merge the 4 chains in chain order, one thread an output element
  const float* ml = mbuf + size_t(kChains) * R * DP;
  for (int i = threadIdx.x; i < nrows * p.D; i += nthreads) {
    const int r = i / p.D, d = i - r * p.D;
    const int nr = p.lens[row0 + r];
    float mx = ml[r * 2];
#pragma unroll
    for (int c = 1; c < kChains; ++c) mx = fmaxf(mx, ml[(c * R + r) * 2]);
    float l = 0.f, a = 0.f;
#pragma unroll
    for (int c = 0; c < kChains; ++c) {
      const float w = expf(__fsub_rn(ml[(c * R + r) * 2], mx));
      l = __fadd_rn(l, __fmul_rn(ml[(c * R + r) * 2 + 1], w));
      a = __fadd_rn(a, __fmul_rn(mbuf[(size_t(c) * R + r) * DP + d], w));
    }
    p.out[(int64_t(row0 + r) * p.H + h) * p.D + d] =
        nr > 0 ? __fdiv_rn(a, fmaxf(l, 1e-30f)) : 0.f;
  }
}

// shared memory of one launch with CP chains at once, 0 if over the limit
template <int S, int DP, int G>
size_t smem_for(int CP, int stages) {
  const size_t chains = size_t(CP) * stages * Geo<S, DP>::kStageBytes;
  const size_t merge = merge_bytes(16 * G, DP);
  const bool alias = CP == kChains && merge <= kChains * (chains / CP);
  const size_t total = q_bytes(16 * G, DP) + chains + (alias ? 0 : merge);
  return total <= size_t(kMaxSmem) ? total : 0;
}

template <int S, int DP, int G>
cudaError_t launch_g(Params p, cudaStream_t stream) {
  static std::atomic<size_t> done[kMaxDevices];
  // the prefill form rings two stages a chain; the decode form stages
  // one, so that more blocks fit an SM (its other warps hide the loads)
  p.stages = p.shared ? 2 : 1;
  size_t smem = 0;
  for (int cp = kChains; cp >= 1 && smem == 0; cp /= 2) {
    smem = smem_for<S, DP, G>(cp, p.stages);
    p.chains_at_once = cp;
  }
  if (smem == 0) return cudaErrorInvalidValue;
  auto kernel = paged_kernel<S, DP, G>;
  cudaError_t err = raise_smem_limit(kernel, smem, done);
  if (err != cudaSuccess) return err;
  const int rows = p.shared ? (p.B + 16 * G - 1) / (16 * G) : p.B;
  const dim3 grid(rows, p.H);
  kernel<<<grid, 32 * G * p.chains_at_once, smem, stream>>>(p);
  return cudaGetLastError();
}

// the prefill form takes 4 row groups a block up to DP 64
template <int S, int DP>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  if (DP <= 64 && p.shared) return launch_g<S, DP, (DP <= 64 ? 4 : 1)>(p, stream);
  return launch_g<S, DP, 1>(p, stream);
}

template <int S>
cudaError_t launch_storage(const Params& p, cudaStream_t st) {
  if (S != kInt8 && p.D <= 8) return launch<S, 8>(p, st);
  if (p.D <= 16) return launch<S, 16>(p, st);
  if (p.D <= 32) return launch<S, 32>(p, st);
  if (p.D <= 64) return launch<S, 64>(p, st);
  if (p.D <= 128) return launch<S, 128>(p, st);
  return launch<S, 256>(p, st);
}

}  // namespace

extern "C" {

// q: [B, H, D] float32; k_arena, v_arena: [num_blocks, block_tokens, H, D]
// of float32 (storage 0), bfloat16 bits (1) or int8 codes (2), their bases
// aligned to the widest of 16, 8, 4, 2, 1 bytes that divides a token row
// (D times the element size); k_scales, v_scales: [num_blocks, H] float32
// for storage 2, else null; tables: int32 [B, max_blocks], or [1,
// max_blocks] shared by every row when shared_table = 1; seq_lens: [B]
// int32; out: [B, H, D] float32. All on the device, contiguous.
// 1 <= D <= 256.
int paddle_paged_attention(const float* q, const void* k_arena,
                           const void* v_arena, const float* k_scales,
                           const float* v_scales, const int* tables,
                           const int* seq_lens, float* out, int B, int H,
                           int D, int block_tokens, int max_blocks,
                           int storage, int shared_table, float scale,
                           void* stream) {
  if (B <= 0 || H <= 0) return int(cudaSuccess);
  if (D < 1 || D > 256 || block_tokens < 1 || H > 65535 || storage < 0 ||
      storage > 2)
    return int(cudaErrorInvalidValue);
  if (storage == kInt8 && (k_scales == nullptr || v_scales == nullptr))
    return int(cudaErrorInvalidValue);
  const int esize = storage == kF32 ? 4 : storage == kBF16 ? 2 : 1;
  const int row = D * esize;
  int width = 16;
  while (row % width) width /= 2;
  if (reinterpret_cast<uintptr_t>(k_arena) % width ||
      reinterpret_cast<uintptr_t>(v_arena) % width)
    return int(cudaErrorMisalignedAddress);
  Params p{q, k_arena, v_arena, k_scales, v_scales, tables, seq_lens, out,
           B, H, D, block_tokens, max_blocks, scale,
           shared_table && B > 1, 0, 0, width};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (storage == kF32) return int(launch_storage<kF32>(p, st));
  if (storage == kBF16) return int(launch_storage<kBF16>(p, st));
  return int(launch_storage<kInt8>(p, st));
}

const char* paddle_paged_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
