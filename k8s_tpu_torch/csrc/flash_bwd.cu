// Flash attention backward for Hopper (sm_90a): bf16 in and out, f32
// math. Two kernels, both recomputing P = exp(scale * Q K^T - lse) from
// the forward's natural-log logsumexp, so no S x S tensor reaches device
// memory:
//
// - flash_bwd_dq_kernel (K2) replaces k8s_tpu/ops/attention.py:
//   _bwd_dq_kernel (launched by _flash_backward through pl.pallas_call):
//   dQ = scale * sum_k P o (dO V^T - D) K.
// - flash_bwd_dkv_kernel (K3) replaces _bwd_dkv_kernel (same launcher):
//   dV = sum_q P^T dO and dK = scale * sum_q (P o (dO V^T - D))^T Q,
//   summed over the G query heads of the kv head's group.
//
// D = rowsum(dO o O) comes from the caller (compute_dd, plain PyTorch).
//
// What bounds them on the H100: K2 does three S x S x D products per
// query head (Q K^T, dO V^T, dS K) and K3 four (both recomputes, P^T dO,
// dS^T Q) over only (4 to 6) * S * D * H bf16 bytes, so at training
// lengths they sit far above the ~295 FLOP/byte ridge: tensor-core
// throughput bounds both. The design feeds the tensor cores from shared
// memory that TMA fills behind the math, and keeps every accumulator in
// registers for the whole loop.
//
// Design. The Pallas kernels carry their dQ (resp. dK/dV) scratch across
// a sequential grid axis; Hopper blocks run in no order, so each block
// loops over that axis itself. Both kernels are warp specialised like
// flash_fwd.cu, on the helpers of hopper.cuh:
//
// - Warpgroup 0 is the producer: it gives up registers (setmaxnreg) and
//   one thread issues every TMA load over tensor maps of the strided
//   [B, S, H, D] views (64-column, 128B-swizzled boxes; rows past the
//   sequence end read as zeros). The block's own tile arrives once; the
//   streamed 64-row tiles pass through a ring (4 stages in K2, 2 in K3)
//   guarded by full and empty mbarriers.
// - Two consumer warpgroups own 64 rows each. Per streamed tile they run
//   the two recomputes as wgmma m64n64k16 with both operands in shared
//   memory (K-major), P in base 2 (scale * log2(e) and lse * log2(e)
//   folded into one FMA before ex2) on the f32 accumulators, and the
//   gradient products as wgmma m64n128k16 with P or dS packed to bf16 in
//   registers as A and the streamed tile as an MN-major B. With two
//   consumer warpgroups per SM, one's softmax runs under the other's
//   products.
// - Only a tile that crosses the causal diagonal or a sequence end is
//   masked; causal loops stop (K2) or start (K3) at the diagonal.
// - No atomics: every output element is written once by one block, so a
//   repeat call is bit-identical.
//
// K2: one block per (q head, batch, 128 query rows), query tiles last
// first (the longest causal rows start first). Q and dO stay in shared
// memory; 64-key K and V tiles stream. Each thread keeps its two rows'
// lse and D in registers; dQ (64 f32 per thread) stays in registers and
// leaves scaled, in bf16, through shared memory in 16-byte stores. P is
// formed while dP is still in flight, and a key tile's stage is released
// when the next tile's S has waited for the dS K product that read it,
// so dS K overlaps the next tile's loads and recomputes.
//
// K3: one block per (key block, kv head, batch) with the 16 key blocks
// of one (batch, kv head) adjacent in launch order, so their common
// Q/dO stream is read from L2; the first keys, which see the most query
// tiles, launch first. K and V (128 keys) stay in shared memory; the
// producer walks the G query heads of the group and, for each, the
// 64-row Q/dO tiles from the diagonal on, with the tiles' lse and D
// (a rank-2 f32 tensor map, zero past the end). dK and dV (64 + 64 f32
// per thread) stay in registers across all G heads — the GQA sum — and
// are written once in bf16. Per tile: S^T = K Q^T and dP^T = V dO^T are
// issued together; P^T and dS^T = P^T o (dP^T - D) are formed from the
// f32 tiles and packed to bf16 element by element, so the two f32 tiles
// die as the two packed ones grow (at most 128 + 64 + a few live
// registers: ptxas neither spills nor serialises the wgmma chain);
// then dV += P^T dO and dK += dS^T Q are issued together and waited for
// before the stage is released. (Issuing dV before dP^T is formed, or
// leaving dV/dK in flight into the next tile, holds 208-224 registers;
// ptxas then serialises the wgmma chain, and both orders timed slower
// than this one on an H100.)
//
// Both: any Sq, Sk (causal needs Sq == Sk), G taken at run time, D 128.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int D = 128;    // head dim: two 64-wide swizzled halves
constexpr int TILE = 64;  // rows per streamed tile: keys (K2), queries (K3)
constexpr int TILE_HALF_BYTES = TILE * 128;  // one 64-column half of a tile
constexpr int TILE_BYTES = 2 * TILE_HALF_BYTES;
constexpr float LOG2E = 1.4426950408889634f;

constexpr int NC = 2;  // consumer warpgroups, 64 owned rows each
constexpr int THREADS = 128 * (NC + 1);
constexpr int OWN_ROWS = 64 * NC;  // rows a block owns
constexpr int OWN_HALF_BYTES = OWN_ROWS * 128;
constexpr int OWN_BYTES = 2 * OWN_HALF_BYTES;

// The streamed-tile ring depths are the fastest of 2, 3 and 4 on an H100
// at B 8, S 2048: K2 gains from a deeper ring (its block's key loop is
// short and each tile feeds one product), K3 from a shallower one.
struct DqCfg {
  static constexpr int STAGES = 4;
  static constexpr int OFF_Q = 0;
  static constexpr int OFF_DO = OWN_BYTES;
  static constexpr int OFF_K = 2 * OWN_BYTES;
  static constexpr int OFF_V = OFF_K + STAGES * TILE_BYTES;
  static constexpr int OFF_BAR = OFF_V + STAGES * TILE_BYTES;
  // Q/dO barrier, full[STAGES], empty[STAGES]; + slack to align to 1024
  static constexpr int SMEM = OFF_BAR + 8 * (1 + 2 * STAGES) + 1024;
};

struct DkvCfg {
  static constexpr int STAGES = 2;
  static constexpr int ROWS_BYTES = 2 * TILE * 4;  // one tile's lse and D
  static constexpr int OFF_K = 0;
  static constexpr int OFF_V = OWN_BYTES;
  static constexpr int OFF_Q = 2 * OWN_BYTES;
  static constexpr int OFF_DO = OFF_Q + STAGES * TILE_BYTES;
  static constexpr int OFF_ROWS = OFF_DO + STAGES * TILE_BYTES;
  static constexpr int OFF_BAR = OFF_ROWS + STAGES * ROWS_BYTES;
  // K/V barrier, full[STAGES], empty[STAGES]; + slack to align to 1024
  static constexpr int SMEM = OFF_BAR + 8 * (1 + 2 * STAGES) + 1024;
};

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

// `x` as a value the compiler cannot see through, so the descriptors
// built from it are recomputed in the loop instead of held live across
// it in registers the accumulators need
__device__ __forceinline__ uint32_t opaque(uint32_t x) {
  asm volatile("" : "+r"(x));
  return x;
}

// the m64n64 accumulator packed to bf16: pk[4i .. 4i + 3] is the register
// A operand of the k step over its columns 16i .. 16i + 15
__device__ __forceinline__ void pack_tile(uint32_t (&pk)[16], const float (&x)[32]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    pk[2 * j] = pack_f32(x[4 * j], x[4 * j + 1]);
    pk[2 * j + 1] = pack_f32(x[4 * j + 2], x[4 * j + 3]);
  }
}

// X[64 x 64] = A[64 rows] B[64 rows]^T over D = 128: both operands
// K-major swizzled tiles (A's rows `a` in a tile of half size
// `a_half`, B a streamed 64-row tile)
__device__ __forceinline__ void product_nt(float (&x)[32], uint32_t a,
                                           uint32_t a_half, uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk % 4) * 32;  // 16 columns into the half
    wgmma_m64n64k16_ss<0>(x, desc_kmajor(a + (kk / 4) * a_half + off),
                          desc_kmajor(b + (kk / 4) * TILE_HALF_BYTES + off),
                          kk > 0);
  }
}

// ACC[64 x 128] += X[64 x 64] (packed bf16 in registers) B[64 x 128],
// B a streamed 64-row tile read MN-major
__device__ __forceinline__ void product_acc(float (&acc)[64],
                                            const uint32_t (&pk)[16],
                                            uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < TILE / 16; ++kk) {
    const uint32_t a[4] = {pk[4 * kk], pk[4 * kk + 1], pk[4 * kk + 2],
                           pk[4 * kk + 3]};
    wgmma_m64n128k16_rs<1>(acc, a, desc_mnmajor(b + kk * 16 * 128, TILE_HALF_BYTES),
                           1);
  }
}

// A warpgroup's 64 x 128 f32 accumulator times `mul`, in bf16, through
// its 64 rows of a two-half swizzled shared tile (`half_bytes` apart, no
// longer read) to rows row0 .. row0 + 63 of a strided output; rows at or
// past `rows` are dropped.
__device__ __forceinline__ void store_rows(const float (&acc)[64], float mul,
                                           uint8_t* tile, int half_bytes,
                                           __nv_bfloat16* out, long long stride,
                                           int row0, int rows, int bar_id) {
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int rl0 = warp * 16 + g;  // rl0 % 8 == (rl0 + 8) % 8 == g
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    uint8_t* chunk = tile + (j / 8) * half_bytes + (((j % 8) ^ g) * 16) + t * 4;
    *reinterpret_cast<uint32_t*>(chunk + rl0 * 128) =
        pack_f32(acc[4 * j] * mul, acc[4 * j + 1] * mul);
    *reinterpret_cast<uint32_t*>(chunk + (rl0 + 8) * 128) =
        pack_f32(acc[4 * j + 2] * mul, acc[4 * j + 3] * mul);
  }
  named_bar_sync(bar_id, 128);
  for (int i = tid; i < 64 * 16; i += 128) {
    const int rl = i / 16, j = i % 16;
    if (row0 + rl < rows)
      *reinterpret_cast<uint4*>(out + (row0 + rl) * stride + j * 8) =
          *reinterpret_cast<const uint4*>(
              tile + (j / 8) * half_bytes + rl * 128 + (((j % 8) ^ (rl % 8)) * 16));
  }
}

__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    const __grid_constant__ CUtensorMap tm_do,
                    const float* __restrict__ lse, const float* __restrict__ dd,
                    __nv_bfloat16* __restrict__ dq, int Sq, int Sk, int Hq,
                    int groups, long long row_stride, long long dq_sb,
                    long long dq_ss, long long dq_sh, float scale,
                    int causal) {
  using C = DqCfg;
  extern __shared__ uint8_t smem_raw[];
  // 128B-swizzled tiles start on 1024-byte boundaries
  const uint32_t raw = smem_u32(smem_raw);
  uint8_t* smem = smem_raw + (((raw + 1023) & ~1023u) - raw);
  const uint32_t sbase = smem_u32(smem);
  const uint32_t bar_qd = sbase + C::OFF_BAR;
  const uint32_t bar_full = bar_qd + 8;               // + 8 * stage
  const uint32_t bar_empty = bar_full + 8 * C::STAGES;  // + 8 * stage

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * OWN_ROWS;  // last tile first
  // causal: keys past the block's last query row are never visible
  const int kv_end = causal ? min(Sk, q0 + OWN_ROWS) : Sk;
  const int n_tiles = (kv_end + TILE - 1) / TILE;

  if (threadIdx.x == 0) {
    mbar_init(bar_qd, 1);
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, NC);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---------------- producer warpgroup ----------------
    setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      const int hk = h / groups;
      mbar_arrive_expect_tx(bar_qd, 2 * OWN_BYTES);
      tma_load_4d(sbase + C::OFF_Q, &tm_q, bar_qd, 0, h, q0, b);
      tma_load_4d(sbase + C::OFF_Q + OWN_HALF_BYTES, &tm_q, bar_qd, 64, h, q0, b);
      tma_load_4d(sbase + C::OFF_DO, &tm_do, bar_qd, 0, h, q0, b);
      tma_load_4d(sbase + C::OFF_DO + OWN_HALF_BYTES, &tm_do, bar_qd, 64, h, q0, b);
      for (int it = 0; it < n_tiles; ++it) {
        const int stage = it % C::STAGES;
        if (it >= C::STAGES) mbar_wait(bar_empty + 8 * stage, (it / C::STAGES - 1) & 1);
        const uint32_t full = bar_full + 8 * stage;
        const uint32_t ks = sbase + C::OFF_K + stage * TILE_BYTES;
        const uint32_t vs = sbase + C::OFF_V + stage * TILE_BYTES;
        const int k0 = it * TILE;
        mbar_arrive_expect_tx(full, 2 * TILE_BYTES);
        tma_load_4d(ks, &tm_k, full, 0, hk, k0, b);
        tma_load_4d(ks + TILE_HALF_BYTES, &tm_k, full, 64, hk, k0, b);
        tma_load_4d(vs, &tm_v, full, 0, hk, k0, b);
        tma_load_4d(vs + TILE_HALF_BYTES, &tm_v, full, 64, hk, k0, b);
      }
    }
  } else {
    // ---------------- consumer warpgroups ----------------
    setmaxnreg_inc<232>();
    const int tid = threadIdx.x - 128;
    const int cw = tid / 128;  // this warpgroup's 64 rows of the block
    const int warp = (tid / 32) % 4, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    const int wg_row0 = q0 + cw * 64;
    const int r0 = wg_row0 + warp * 16 + g;  // x[4j + 0, 1]; r0 + 8: x[4j + 2, 3]
    const int r1 = r0 + 8;
    const uint32_t sq = sbase + C::OFF_Q + cw * 64 * 128;  // its rows in half 0
    const uint32_t sdo = sbase + C::OFF_DO + cw * 64 * 128;
    const long long row_base = (static_cast<long long>(b) * Hq + h) * row_stride;
    const float l0 = r0 < Sq ? lse[row_base + r0] * LOG2E : 0.f;
    const float l1 = r1 < Sq ? lse[row_base + r1] * LOG2E : 0.f;
    const float d0 = r0 < Sq ? dd[row_base + r0] : 0.f;
    const float d1 = r1 < Sq ? dd[row_base + r1] : 0.f;
    const float scale_log2 = scale * LOG2E;
    // causal: this warpgroup's rows see no key past its last row
    const int my_tiles = ((causal ? min(Sk, wg_row0 + 64) : Sk) + TILE - 1) / TILE;

    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    uint32_t pk[16];

    mbar_wait(bar_qd, 0);
    for (int it = 0; it < my_tiles; ++it) {
      const int stage = it % C::STAGES;
      const int k0 = it * TILE;
      const uint32_t ks = sbase + C::OFF_K + stage * TILE_BYTES;
      const uint32_t vs = sbase + C::OFF_V + stage * TILE_BYTES;
      mbar_wait(bar_full + 8 * stage, (it / C::STAGES) & 1);

      // S = Q K^T and dP = dO V^T: 64 rows x 64 keys each
      float s[32], dp[32];
      wgmma_fence();
      product_nt(s, opaque(sq), OWN_HALF_BYTES, ks);
      wgmma_commit();
      product_nt(dp, opaque(sdo), OWN_HALF_BYTES, vs);
      wgmma_commit();
      wgmma_wait<1>();  // S, and the previous tile's dS K, are done
      fence_operands(s);
      fence_operands(acc);
      if (it > 0 && tid % 128 == 0)
        mbar_arrive(bar_empty + 8 * ((it - 1) % C::STAGES));

      // P = exp(scale S - lse) in base 2; masked only on a tile that
      // crosses the diagonal or the sequence end
      const bool edge = k0 + TILE > Sk || (causal && k0 + TILE - 1 > wg_row0);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = fast_exp2(fmaf(s[4 * j + e], scale_log2, e < 2 ? -l0 : -l1));
          if (edge) {
            const int key = k0 + 8 * j + 2 * t + (e & 1);
            if (key >= Sk || (causal && key > (e < 2 ? r0 : r1))) p = 0.f;
          }
          s[4 * j + e] = p;
        }
      }
      wgmma_wait<0>();  // dP
      fence_operands(dp);
      // dS = P (dP - D), packed to bf16 as the A operand of dS K
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[4 * j] *= dp[4 * j] - d0;
        s[4 * j + 1] *= dp[4 * j + 1] - d0;
        s[4 * j + 2] *= dp[4 * j + 2] - d1;
        s[4 * j + 3] *= dp[4 * j + 3] - d1;
      }
      pack_tile(pk, s);

      // dQ += dS K: K, stored [key][d], is the MN-major B
      fence_operands(acc);
      fence_operands(pk);
      wgmma_fence();
      product_acc(acc, pk, ks);
      wgmma_commit();
    }
    wgmma_wait<0>();
    fence_operands(acc);
    fence_operands(pk);

    // ---------------- epilogue ----------------
    // dQ * scale over this warpgroup's Q rows (no longer read)
    store_rows(acc, scale, smem + C::OFF_Q + cw * 64 * 128, OWN_HALF_BYTES,
               dq + b * dq_sb + h * dq_sh, dq_ss, wg_row0, Sq, 1 + cw);
  }
}

__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v,
                     const __grid_constant__ CUtensorMap tm_do,
                     const __grid_constant__ CUtensorMap tm_lse,
                     const __grid_constant__ CUtensorMap tm_dd,
                     __nv_bfloat16* __restrict__ dk,
                     __nv_bfloat16* __restrict__ dv, int Sq, int Sk, int Hq,
                     int groups, long long dk_sb, long long dk_ss,
                     long long dk_sh, long long dv_sb, long long dv_ss,
                     long long dv_sh, float scale, int causal) {
  using C = DkvCfg;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  uint8_t* smem = smem_raw + (((raw + 1023) & ~1023u) - raw);
  const uint32_t sbase = smem_u32(smem);
  const uint32_t bar_kv = sbase + C::OFF_BAR;
  const uint32_t bar_full = bar_kv + 8;               // + 8 * stage
  const uint32_t bar_empty = bar_full + 8 * C::STAGES;  // + 8 * stage

  const int kb = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int k0 = kb * OWN_ROWS;  // first keys (the most query tiles) first
  // causal: query tiles that end above the block's first key see none
  // of it; start at the tile holding query k0 (the diagonal)
  const int q_begin = causal ? k0 : 0;
  const int n_q = (Sq - q_begin + TILE - 1) / TILE;  // per query head

  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, NC);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---------------- producer warpgroup ----------------
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      mbar_arrive_expect_tx(bar_kv, 2 * OWN_BYTES);
      tma_load_4d(sbase + C::OFF_K, &tm_k, bar_kv, 0, hk, k0, b);
      tma_load_4d(sbase + C::OFF_K + OWN_HALF_BYTES, &tm_k, bar_kv, 64, hk, k0, b);
      tma_load_4d(sbase + C::OFF_V, &tm_v, bar_kv, 0, hk, k0, b);
      tma_load_4d(sbase + C::OFF_V + OWN_HALF_BYTES, &tm_v, bar_kv, 64, hk, k0, b);
      int it = 0;
      for (int j = 0; j < groups; ++j) {  // the query heads of this kv head
        const int h = hk * groups + j;
        for (int i = 0; i < n_q; ++i, ++it) {
          const int stage = it % C::STAGES;
          if (it >= C::STAGES) mbar_wait(bar_empty + 8 * stage, (it / C::STAGES - 1) & 1);
          const uint32_t full = bar_full + 8 * stage;
          const uint32_t qs = sbase + C::OFF_Q + stage * TILE_BYTES;
          const uint32_t dos = sbase + C::OFF_DO + stage * TILE_BYTES;
          const uint32_t rows = sbase + C::OFF_ROWS + stage * C::ROWS_BYTES;
          const int q0 = q_begin + i * TILE;
          mbar_arrive_expect_tx(full, 2 * TILE_BYTES + C::ROWS_BYTES);
          tma_load_4d(qs, &tm_q, full, 0, h, q0, b);
          tma_load_4d(qs + TILE_HALF_BYTES, &tm_q, full, 64, h, q0, b);
          tma_load_4d(dos, &tm_do, full, 0, h, q0, b);
          tma_load_4d(dos + TILE_HALF_BYTES, &tm_do, full, 64, h, q0, b);
          tma_load_2d(rows, &tm_lse, full, q0, b * Hq + h);
          tma_load_2d(rows + TILE * 4, &tm_dd, full, q0, b * Hq + h);
        }
      }
    }
  } else {
    // ---------------- consumer warpgroups ----------------
    setmaxnreg_inc<240>();
    const int tid = threadIdx.x - 128;
    const int cw = tid / 128;  // this warpgroup's 64 keys of the block
    const int warp = (tid / 32) % 4, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    const int kw0 = k0 + cw * 64;
    const int key0 = kw0 + warp * 16 + g;  // x[4j + 0, 1]; key0 + 8: x[4j + 2, 3]
    const int key1 = key0 + 8;
    const uint32_t skw = sbase + C::OFF_K + cw * 64 * 128;  // its keys in half 0
    const uint32_t svw = sbase + C::OFF_V + cw * 64 * 128;
    const float scale_log2 = scale * LOG2E;

    float dka[64], dva[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) dka[i] = dva[i] = 0.f;
    uint32_t pp[16], pd[16];  // P^T and dS^T packed to bf16

    mbar_wait(bar_kv, 0);
    int it = 0;
    for (int j = 0; j < groups; ++j) {
      for (int i = 0; i < n_q; ++i, ++it) {
        const int stage = it % C::STAGES;
        const int q0 = q_begin + i * TILE;
        mbar_wait(bar_full + 8 * stage, (it / C::STAGES) & 1);
        if (causal && q0 + TILE <= kw0) {
          // every query of the tile lies above this warpgroup's keys
          if (tid % 128 == 0) mbar_arrive(bar_empty + 8 * stage);
          continue;
        }
        const uint32_t qs = sbase + C::OFF_Q + stage * TILE_BYTES;
        const uint32_t dos = sbase + C::OFF_DO + stage * TILE_BYTES;
        const float* ls = reinterpret_cast<const float*>(
            smem + C::OFF_ROWS + stage * C::ROWS_BYTES);  // the tile's lse
        const float* ds = ls + TILE;                      // and its D

        // S^T = K Q^T and dP^T = V dO^T: 64 keys x 64 queries each
        float s[32], dp[32];
        wgmma_fence();
        product_nt(s, opaque(skw), OWN_HALF_BYTES, qs);
        product_nt(dp, opaque(svw), OWN_HALF_BYTES, dos);
        wgmma_commit();
        wgmma_wait<0>();
        fence_operands(s);
        fence_operands(dp);

        // P^T = exp(scale S^T - lse) in base 2, each column its query's
        // lse, masked only on a tile that crosses the diagonal or an end;
        // dS^T = P^T (dP^T - D) from the f32 P^T; both packed to bf16 as
        // they are formed, so the f32 tiles die as the packed ones grow
        const bool edge = q0 + TILE > Sq || kw0 + 64 > Sk ||
                          (causal && q0 < kw0 + 63);
#pragma unroll
        for (int jn = 0; jn < 8; ++jn) {
          const float2 l = *reinterpret_cast<const float2*>(ls + 8 * jn + 2 * t);
          const float2 dc = *reinterpret_cast<const float2*>(ds + 8 * jn + 2 * t);
          float p[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float lc = (e & 1) ? l.y : l.x;
            p[e] = fast_exp2(fmaf(s[4 * jn + e], scale_log2, -lc * LOG2E));
            if (edge) {
              const int q = q0 + 8 * jn + 2 * t + (e & 1);
              const int key = e < 2 ? key0 : key1;
              if (q >= Sq || key >= Sk || (causal && key > q)) p[e] = 0.f;
            }
          }
          pp[2 * jn] = pack_f32(p[0], p[1]);
          pp[2 * jn + 1] = pack_f32(p[2], p[3]);
          pd[2 * jn] = pack_f32(p[0] * (dp[4 * jn] - dc.x), p[1] * (dp[4 * jn + 1] - dc.y));
          pd[2 * jn + 1] =
              pack_f32(p[2] * (dp[4 * jn + 2] - dc.x), p[3] * (dp[4 * jn + 3] - dc.y));
        }

        // dV += P^T dO and dK += dS^T Q
        fence_operands(dva);
        fence_operands(dka);
        fence_operands(pp);
        fence_operands(pd);
        wgmma_fence();
        product_acc(dva, pp, dos);
        product_acc(dka, pd, qs);
        wgmma_commit();
        wgmma_wait<0>();
        fence_operands(dva);
        fence_operands(dka);
        fence_operands(pp);
        fence_operands(pd);
        if (tid % 128 == 0) mbar_arrive(bar_empty + 8 * stage);
      }
    }

    // ---------------- epilogue ----------------
    // dK * scale and dV over this warpgroup's K and V rows (no longer read)
    store_rows(dka, scale, smem + C::OFF_K + cw * 64 * 128, OWN_HALF_BYTES,
               dk + b * dk_sb + hk * dk_sh, dk_ss, kw0, Sk, 1 + cw);
    store_rows(dva, 1.f, smem + C::OFF_V + cw * 64 * 128, OWN_HALF_BYTES,
               dv + b * dv_sb + hk * dv_sh, dv_ss, kw0, Sk, 1 + cw);
  }
}

}  // namespace

extern "C" const char* k8s_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// the dynamic shared memory of one block: kernel 0 = K2 (dq), 1 = K3
extern "C" int k8s_flash_bwd_smem_bytes(int kernel) {
  return kernel == 0 ? DqCfg::SMEM : DkvCfg::SMEM;
}

// K2. q/dout/dq [B, Sq, Hq, D], k/v [B, Sk, Hkv, D] (bf16, strided: unit
// stride on D, other strides multiples of 8 elements, q/k/v/dout bases
// 16-byte aligned — TMA's rules); lse and dd [B, Hq, Sq] f32 with rows
// `row_stride` (a multiple of 4, >= Sq) elements apart. Causal requires
// Sq == Sk. Built for D = 128; anything else returns
// cudaErrorInvalidValue.
extern "C" int k8s_flash_bwd_dq_bf16(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* dd, void* dq, int B, int Sq, int Sk, int Hq,
    int Hkv, int D_, long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb,
    long long v_ss, long long v_sh, long long do_sb, long long do_ss,
    long long do_sh, long long dq_sb, long long dq_ss, long long dq_sh,
    long long row_stride, float scale, int causal, void* stream) {
  using C = DqCfg;
  if (D_ != D || Hkv <= 0 || Hq % Hkv || Sq <= 0 || Sk <= 0 ||
      row_stride % 4 || row_stride < Sq)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  CUtensorMap tq, tk, tv, tdo;
  int err = make_bshd_map(&tq, q, B, Sq, Hq, D, q_sb, q_ss, q_sh, OWN_ROWS);
  if (!err) err = make_bshd_map(&tk, k, B, Sk, Hkv, D, k_sb, k_ss, k_sh, TILE);
  if (!err) err = make_bshd_map(&tv, v, B, Sk, Hkv, D, v_sb, v_ss, v_sh, TILE);
  if (!err) err = make_bshd_map(&tdo, dout, B, Sq, Hq, D, do_sb, do_ss, do_sh, OWN_ROWS);
  if (err) return err;
  static std::atomic<bool> smem_set[hopper::MAX_DEVICES];
  const cudaError_t attr =
      hopper::set_smem_limit_once(flash_bwd_dq_kernel, C::SMEM, smem_set);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(Hq, B, (Sq + OWN_ROWS - 1) / OWN_ROWS);
  flash_bwd_dq_kernel
      <<<grid, THREADS, C::SMEM, static_cast<cudaStream_t>(stream)>>>(
          tq, tk, tv, tdo, static_cast<const float*>(lse),
          static_cast<const float*>(dd), static_cast<__nv_bfloat16*>(dq), Sq,
          Sk, Hq, Hq / Hkv, row_stride, dq_sb, dq_ss, dq_sh, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

// K3. Shapes and rules as K2; dk/dv [B, Sk, Hkv, D] bf16 (strided), each
// written once with the sum over the Hq / Hkv query heads of its group.
extern "C" int k8s_flash_bwd_dkv_bf16(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* dd, void* dk, void* dv, int B, int Sq, int Sk,
    int Hq, int Hkv, int D_, long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb,
    long long v_ss, long long v_sh, long long do_sb, long long do_ss,
    long long do_sh, long long dk_sb, long long dk_ss, long long dk_sh,
    long long dv_sb, long long dv_ss, long long dv_sh, long long row_stride,
    float scale, int causal, void* stream) {
  using C = DkvCfg;
  if (D_ != D || Hkv <= 0 || Hq % Hkv || Sq <= 0 || Sk <= 0 ||
      row_stride % 4 || row_stride < Sq)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  CUtensorMap tq, tk, tv, tdo, tl, tdd;
  int err = make_bshd_map(&tq, q, B, Sq, Hq, D, q_sb, q_ss, q_sh, TILE);
  if (!err) err = make_bshd_map(&tk, k, B, Sk, Hkv, D, k_sb, k_ss, k_sh, OWN_ROWS);
  if (!err) err = make_bshd_map(&tv, v, B, Sk, Hkv, D, v_sb, v_ss, v_sh, OWN_ROWS);
  if (!err) err = make_bshd_map(&tdo, dout, B, Sq, Hq, D, do_sb, do_ss, do_sh, TILE);
  if (!err) err = make_rows_map(&tl, lse, B * Hq, Sq, row_stride, TILE);
  if (!err) err = make_rows_map(&tdd, dd, B * Hq, Sq, row_stride, TILE);
  if (err) return err;
  static std::atomic<bool> smem_set[hopper::MAX_DEVICES];
  const cudaError_t attr =
      hopper::set_smem_limit_once(flash_bwd_dkv_kernel, C::SMEM, smem_set);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((Sk + OWN_ROWS - 1) / OWN_ROWS, Hkv, B);
  flash_bwd_dkv_kernel
      <<<grid, THREADS, C::SMEM, static_cast<cudaStream_t>(stream)>>>(
          tq, tk, tv, tdo, tl, tdd, static_cast<__nv_bfloat16*>(dk),
          static_cast<__nv_bfloat16*>(dv), Sq, Sk, Hq, Hq / Hkv, dk_sb, dk_ss,
          dk_sh, dv_sb, dv_ss, dv_sh, scale, causal);
  return static_cast<int>(cudaGetLastError());
}
