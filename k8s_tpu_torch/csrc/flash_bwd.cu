// Flash attention backward for Hopper (sm_90a): bf16 in and out, f32
// math. Two kernels, both recomputing P = exp(scale * Q K^T - lse) from
// the forward's logsumexp, so no S x S tensor reaches device memory:
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
// dS^T Q) over (4 to 6) * S * D * H bf16 bytes, so at training lengths
// they sit far above the ~295 FLOP/byte ridge: tensor-core throughput
// bounds both.
//
// Design. The Pallas kernels carry their dQ (resp. dK/dV) scratch
// across a sequential grid axis (kv blocks for dQ, q blocks for dK/dV);
// Hopper blocks run in no order, so here each block loops over that axis
// itself and keeps the accumulator in registers:
//
// - K2: one block of 4 warps per (batch, q head, 64 query rows); each
//   warp keeps its 16 rows' Q and dO fragments and the f32 dQ
//   accumulator in registers and streams 64-key K/V tiles through padded
//   shared memory, 16 keys at a time (S and dP fragments are 16 x 16, so
//   registers stay below the spill line); dS is re-packed in registers
//   as the A operand of dS K. Causal blocks stop at the diagonal.
// - K3: one block per (batch, kv head, 64 keys); each warp owns 16 keys
//   and their f32 dK and dV accumulators (128 registers a thread). K and
//   V stay in shared memory (A fragments read from there), and the block
//   streams 64-row Q and dO tiles of every query head of the group, from
//   the first tile that reaches the diagonal on. The GQA sum thus happens
//   in registers: the Pallas route writes f32 dK/dV per query head
//   ([B * Hq, S, D], 2 x 268 MB at B 8, S 2048, Hq 32) and sums them
//   afterwards; this one writes bf16 [B, S, Hkv, D] once. 70 KB of
//   dynamic shared memory (K, V, Q, dO tiles plus the tile's lse and D).
//
// Both kernels zero-fill and mask a ragged last tile, so any S works;
// causal masking compares absolute positions (Sq == Sk, checked by the
// wrapper). Not yet used: wgmma, TMA, ldmatrix, double buffering.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// mma.sync m16n8k16 fragments (lane = 4 * g + t), as in flash_fwd.cu: an
// A tile (16x16, row-major) holds rows g and g + 8, columns 2t, 2t + 1
// (regs 0, 1) and 2t + 8, 2t + 9 (regs 2, 3); a B tile (16x8) holds
// column g, rows 2t, 2t + 1 (reg 0) and 2t + 8, 2t + 9 (reg 1); a C tile
// (16x8, f32) holds rows g (c0, c1) and g + 8 (c2, c3), columns 2t,
// 2t + 1. Two C tiles side by side, packed to bf16, are one A tile.
__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// D (16x8, f32) += A (16x16, bf16, row) * B (16x8, bf16, col)
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two consecutive bf16 of row `row` (zero past the sequence end)
__device__ __forceinline__ uint32_t load_pair(const __nv_bfloat16* base,
                                              int row, int col, int rows,
                                              long long row_stride) {
  if (row >= rows) return 0u;
  return *reinterpret_cast<const uint32_t*>(base + row * row_stride + col);
}

// two consecutive bf16 of a row in shared memory
__device__ __forceinline__ uint32_t lds_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// the A fragment of rows r0 and r0 + 8, columns c0 .. c0 + 15, of a
// row-major shared tile with row stride ld
__device__ __forceinline__ void lds_a(uint32_t (&a)[4],
                                      const __nv_bfloat16* tile, int ld,
                                      int r0, int c0) {
  const __nv_bfloat16* p = tile + r0 * ld + c0;
  a[0] = lds_pair(p);
  a[1] = lds_pair(p + 8 * ld);
  a[2] = lds_pair(p + 8);
  a[3] = lds_pair(p + 8 * ld + 8);
}

// the B fragment B[k][n] = tile[k0 + k][n0 + n] (k in 0..15, n = g): a
// row-major [k][n] shared tile read down its column, two rows per reg
__device__ __forceinline__ void lds_b_trans(uint32_t& b0, uint32_t& b1,
                                            const __nv_bfloat16* tile, int ld,
                                            int k0, int n0, int g, int t) {
  const __nv_bfloat16* p = tile + (k0 + 2 * t) * ld + n0 + g;
  b0 = pack_bf16(p[0], p[ld]);
  b1 = pack_bf16(p[8 * ld], p[9 * ld]);
}

constexpr int BLOCK_M = 64;  // rows a block owns: queries (K2), keys (K3)
constexpr int BLOCK_N = 64;  // rows per streamed tile: keys (K2), queries (K3)
constexpr int NUM_WARPS = 4;
constexpr int PAD = 8;       // bf16 padding per shared row (bank spread)

// cooperative copy of rows [r0, r0 + BLOCK_N) of a [S, D] slab (row
// stride `stride`) into a padded shared tile; rows past S are zero
template <int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src, int r0,
                                          int rows, long long stride,
                                          int tid) {
  constexpr int LD = D + PAD;
  for (int i = tid; i < BLOCK_N * (D / 8); i += NUM_WARPS * 32) {
    const int r = i / (D / 8), c = (i % (D / 8)) * 8;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < rows)
      x = *reinterpret_cast<const uint4*>(src + (r0 + r) * stride + c);
    *reinterpret_cast<uint4*>(dst + r * LD + c) = x;
  }
}

template <int D>
__global__ void __launch_bounds__(NUM_WARPS * 32)
flash_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    const __nv_bfloat16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ dd,
                    __nv_bfloat16* __restrict__ dq,
                    int Sq, int Sk, int Hq, int groups,
                    long long q_sb, long long q_ss, long long q_sh,
                    long long k_sb, long long k_ss, long long k_sh,
                    long long v_sb, long long v_ss, long long v_sh,
                    long long do_sb, long long do_ss, long long do_sh,
                    long long dq_sb, long long dq_ss, long long dq_sh,
                    float scale, int causal) {
  constexpr int KSTEPS = D / 16;  // mma k-steps over the head dim
  constexpr int DTILES = D / 8;   // 8-wide column tiles of dQ
  constexpr int LD = D + PAD;
  __shared__ __align__(16) __nv_bfloat16 ks[BLOCK_N * LD];
  __shared__ __align__(16) __nv_bfloat16 vs[BLOCK_N * LD];

  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * BLOCK_M;
  const int row0 = q0 + warp * 16 + g;  // this thread's rows: row0, row0 + 8

  const __nv_bfloat16* qb = q + b * q_sb + h * q_sh;
  const __nv_bfloat16* dob = dout + b * do_sb + h * do_sh;
  const __nv_bfloat16* kb = k + b * k_sb + (h / groups) * k_sh;
  const __nv_bfloat16* vb = v + b * v_sb + (h / groups) * v_sh;

  // A fragments of this warp's 16 rows of Q and dO, straight from memory
  uint32_t qa[KSTEPS][4], da[KSTEPS][4];
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    const int c = kk * 16 + t * 2;
    qa[kk][0] = load_pair(qb, row0, c, Sq, q_ss);
    qa[kk][1] = load_pair(qb, row0 + 8, c, Sq, q_ss);
    qa[kk][2] = load_pair(qb, row0, c + 8, Sq, q_ss);
    qa[kk][3] = load_pair(qb, row0 + 8, c + 8, Sq, q_ss);
    da[kk][0] = load_pair(dob, row0, c, Sq, do_ss);
    da[kk][1] = load_pair(dob, row0 + 8, c, Sq, do_ss);
    da[kk][2] = load_pair(dob, row0, c + 8, Sq, do_ss);
    da[kk][3] = load_pair(dob, row0 + 8, c + 8, Sq, do_ss);
  }
  // this thread's rows' lse and D
  const long long row_base = (static_cast<long long>(b) * Hq + h) * Sq;
  float lr[2], dr[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + i * 8;
    lr[i] = row < Sq ? lse[row_base + row] : 0.f;
    dr[i] = row < Sq ? dd[row_base + row] : 0.f;
  }

  float acc[DTILES][4];
#pragma unroll
  for (int dt = 0; dt < DTILES; ++dt)
    acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;

  // causal: keys past the block's last query row are never visible
  const int kv_end = causal ? min(Sk, q0 + BLOCK_M) : Sk;
  for (int k0 = 0; k0 < kv_end; k0 += BLOCK_N) {
    __syncthreads();  // the previous tile is fully consumed
    load_tile<D>(ks, kb, k0, Sk, k_ss, tid);
    load_tile<D>(vs, vb, k0, Sk, v_ss, tid);
    __syncthreads();

#pragma unroll 1
    for (int c = 0; c < BLOCK_N / 16; ++c) {  // 16 keys at a time
      // S = Q K^T and dP = dO V^T for 16 rows x 16 keys (two 8-key tiles)
      float s[2][4], dp[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
        dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
        const __nv_bfloat16* kr = ks + (c * 16 + j * 8 + g) * LD + t * 2;
        const __nv_bfloat16* vr = vs + (c * 16 + j * 8 + g) * LD + t * 2;
#pragma unroll
        for (int kk = 0; kk < KSTEPS; ++kk) {
          mma16816(s[j], qa[kk], lds_pair(kr + kk * 16),
                   lds_pair(kr + kk * 16 + 8));
          mma16816(dp[j], da[kk], lds_pair(vr + kk * 16),
                   lds_pair(vr + kk * 16 + 8));
        }
      }
      // P from lse (masked: ragged tail, causal), then dS = P (dP - D)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + c * 16 + j * 8 + t * 2 + (e & 1);
          const int row = row0 + (e >> 1) * 8;
          const bool visible = key < Sk && !(causal && key > row);
          const float p =
              visible ? __expf(s[j][e] * scale - lr[e >> 1]) : 0.f;
          s[j][e] = p * (dp[j][e] - dr[e >> 1]);
        }
      }
      uint32_t a[4];
      a[0] = pack_f32(s[0][0], s[0][1]);
      a[1] = pack_f32(s[0][2], s[0][3]);
      a[2] = pack_f32(s[1][0], s[1][1]);
      a[3] = pack_f32(s[1][2], s[1][3]);
      // dQ += dS K: B[key][d] = K[key][d], read down the shared tile
#pragma unroll
      for (int dt = 0; dt < DTILES; ++dt) {
        uint32_t b0, b1;
        lds_b_trans(b0, b1, ks, LD, c * 16, dt * 8, g, t);
        mma16816(acc[dt], a, b0, b1);
      }
    }
  }

  __nv_bfloat16* dqb = dq + b * dq_sb + h * dq_sh;
#pragma unroll
  for (int dt = 0; dt < DTILES; ++dt) {
    const int col = dt * 8 + t * 2;
    if (row0 < Sq)
      *reinterpret_cast<uint32_t*>(dqb + row0 * dq_ss + col) =
          pack_f32(scale * acc[dt][0], scale * acc[dt][1]);
    if (row0 + 8 < Sq)
      *reinterpret_cast<uint32_t*>(dqb + (row0 + 8) * dq_ss + col) =
          pack_f32(scale * acc[dt][2], scale * acc[dt][3]);
  }
}

template <int D>
constexpr int dkv_smem_bytes() {
  return 4 * BLOCK_N * (D + PAD) * 2 + 2 * BLOCK_N * 4;
}

template <int D>
__global__ void __launch_bounds__(NUM_WARPS * 32)
flash_bwd_dkv_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     const __nv_bfloat16* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ dd,
                     __nv_bfloat16* __restrict__ dk,
                     __nv_bfloat16* __restrict__ dv,
                     int Sq, int Sk, int Hq, int groups,
                     long long q_sb, long long q_ss, long long q_sh,
                     long long k_sb, long long k_ss, long long k_sh,
                     long long v_sb, long long v_ss, long long v_sh,
                     long long do_sb, long long do_ss, long long do_sh,
                     long long dk_sb, long long dk_ss, long long dk_sh,
                     long long dv_sb, long long dv_ss, long long dv_sh,
                     float scale, int causal) {
  constexpr int KSTEPS = D / 16;
  constexpr int DTILES = D / 8;
  constexpr int LD = D + PAD;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem);  // [64][LD]
  __nv_bfloat16* vs = ks + BLOCK_M * LD;
  __nv_bfloat16* qs = vs + BLOCK_M * LD;  // current query tile
  __nv_bfloat16* dos = qs + BLOCK_N * LD;
  float* ls = reinterpret_cast<float*>(dos + BLOCK_N * LD);  // its lse
  float* ds = ls + BLOCK_N;                                  // its D

  const int hk = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int k0 = blockIdx.x * BLOCK_M;
  const int kr0 = warp * 16;       // this warp's keys within the tile
  const int key0 = k0 + kr0 + g;   // this thread's keys: key0, key0 + 8

  load_tile<D>(ks, k + b * k_sb + hk * k_sh, k0, Sk, k_ss, tid);
  load_tile<D>(vs, v + b * v_sb + hk * v_sh, k0, Sk, v_ss, tid);

  float dka[DTILES][4], dva[DTILES][4];
#pragma unroll
  for (int dt = 0; dt < DTILES; ++dt) {
    dka[dt][0] = dka[dt][1] = dka[dt][2] = dka[dt][3] = 0.f;
    dva[dt][0] = dva[dt][1] = dva[dt][2] = dva[dt][3] = 0.f;
  }

  // causal: query tiles whose last row lies above this key tile's first
  // key see none of it; start at the tile holding query k0 (the diagonal)
  const int q_begin = causal ? (k0 / BLOCK_N) * BLOCK_N : 0;
#pragma unroll 1
  for (int j = 0; j < groups; ++j) {  // the query heads of this kv head
    const int h = hk * groups + j;
    const __nv_bfloat16* qb = q + b * q_sb + h * q_sh;
    const __nv_bfloat16* dob = dout + b * do_sb + h * do_sh;
    const long long row_base = (static_cast<long long>(b) * Hq + h) * Sq;
#pragma unroll 1
    for (int q0 = q_begin; q0 < Sq; q0 += BLOCK_N) {
      __syncthreads();  // the previous tile is fully consumed
      load_tile<D>(qs, qb, q0, Sq, q_ss, tid);
      load_tile<D>(dos, dob, q0, Sq, do_ss, tid);
      for (int i = tid; i < BLOCK_N; i += NUM_WARPS * 32) {
        const bool in = q0 + i < Sq;
        ls[i] = in ? lse[row_base + q0 + i] : 0.f;
        ds[i] = in ? dd[row_base + q0 + i] : 0.f;
      }
      __syncthreads();

#pragma unroll 1
      for (int c = 0; c < BLOCK_N / 16; ++c) {  // 16 queries at a time
        // S^T = K Q^T and dP^T = V dO^T: 16 keys x 16 queries
        float s[2][4], dp[2][4];
#pragma unroll
        for (int jn = 0; jn < 2; ++jn) {
          s[jn][0] = s[jn][1] = s[jn][2] = s[jn][3] = 0.f;
          dp[jn][0] = dp[jn][1] = dp[jn][2] = dp[jn][3] = 0.f;
        }
#pragma unroll
        for (int kk = 0; kk < KSTEPS; ++kk) {
          uint32_t ka[4], va[4];
          lds_a(ka, ks, LD, kr0 + g, kk * 16 + t * 2);
          lds_a(va, vs, LD, kr0 + g, kk * 16 + t * 2);
#pragma unroll
          for (int jn = 0; jn < 2; ++jn) {
            const int qr = (c * 16 + jn * 8 + g) * LD + kk * 16 + t * 2;
            mma16816(s[jn], ka, lds_pair(qs + qr), lds_pair(qs + qr + 8));
            mma16816(dp[jn], va, lds_pair(dos + qr), lds_pair(dos + qr + 8));
          }
        }
        // P^T from lse (masked: ragged tails, causal), dS^T = P^T (dP^T - D)
        float p[2][4];
#pragma unroll
        for (int jn = 0; jn < 2; ++jn) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qi = c * 16 + jn * 8 + t * 2 + (e & 1);  // in tile
            const int key = key0 + (e >> 1) * 8;
            const bool visible = q0 + qi < Sq && key < Sk &&
                                 !(causal && key > q0 + qi);
            const float pe =
                visible ? __expf(s[jn][e] * scale - ls[qi]) : 0.f;
            p[jn][e] = pe;
            s[jn][e] = pe * (dp[jn][e] - ds[qi]);
          }
        }
        uint32_t pa[4], sa[4];
        pa[0] = pack_f32(p[0][0], p[0][1]);
        pa[1] = pack_f32(p[0][2], p[0][3]);
        pa[2] = pack_f32(p[1][0], p[1][1]);
        pa[3] = pack_f32(p[1][2], p[1][3]);
        sa[0] = pack_f32(s[0][0], s[0][1]);
        sa[1] = pack_f32(s[0][2], s[0][3]);
        sa[2] = pack_f32(s[1][0], s[1][1]);
        sa[3] = pack_f32(s[1][2], s[1][3]);
        // dV += P^T dO and dK += dS^T Q: B[query][d], read down the tiles
#pragma unroll
        for (int dt = 0; dt < DTILES; ++dt) {
          uint32_t b0, b1;
          lds_b_trans(b0, b1, dos, LD, c * 16, dt * 8, g, t);
          mma16816(dva[dt], pa, b0, b1);
          lds_b_trans(b0, b1, qs, LD, c * 16, dt * 8, g, t);
          mma16816(dka[dt], sa, b0, b1);
        }
      }
    }
  }

  __nv_bfloat16* dkb = dk + b * dk_sb + hk * dk_sh;
  __nv_bfloat16* dvb = dv + b * dv_sb + hk * dv_sh;
#pragma unroll
  for (int dt = 0; dt < DTILES; ++dt) {
    const int col = dt * 8 + t * 2;
    if (key0 < Sk) {
      *reinterpret_cast<uint32_t*>(dkb + key0 * dk_ss + col) =
          pack_f32(scale * dka[dt][0], scale * dka[dt][1]);
      *reinterpret_cast<uint32_t*>(dvb + key0 * dv_ss + col) =
          pack_f32(dva[dt][0], dva[dt][1]);
    }
    if (key0 + 8 < Sk) {
      *reinterpret_cast<uint32_t*>(dkb + (key0 + 8) * dk_ss + col) =
          pack_f32(scale * dka[dt][2], scale * dka[dt][3]);
      *reinterpret_cast<uint32_t*>(dvb + (key0 + 8) * dv_ss + col) =
          pack_f32(dva[dt][2], dva[dt][3]);
    }
  }
}

}  // namespace

extern "C" const char* k8s_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// K2. q/dout/dq [B, Sq, Hq, D], k/v [B, Sk, Hkv, D] (bf16, strided; unit
// stride on D), lse and dd [B, Hq, Sq] f32 contiguous. Causal requires
// Sq == Sk. Built for D = 128; another D returns cudaErrorInvalidValue.
extern "C" int k8s_flash_bwd_dq_bf16(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* dd, void* dq, int B, int Sq, int Sk, int Hq,
    int Hkv, int D, long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb,
    long long v_ss, long long v_sh, long long do_sb, long long do_ss,
    long long do_sh, long long dq_sb, long long dq_ss, long long dq_sh,
    float scale, int causal, void* stream) {
  if (D != 128) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((Sq + BLOCK_M - 1) / BLOCK_M, Hq, B);
  flash_bwd_dq_kernel<128><<<grid, NUM_WARPS * 32, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(dd),
      static_cast<__nv_bfloat16*>(dq), Sq, Sk, Hq, Hq / Hkv, q_sb, q_ss, q_sh,
      k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, do_sb, do_ss, do_sh, dq_sb, dq_ss,
      dq_sh, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

// K3. Shapes as K2; dk/dv [B, Sk, Hkv, D] bf16 (strided), each written
// once with the sum over the Hq / Hkv query heads of its group.
extern "C" int k8s_flash_bwd_dkv_bf16(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* dd, void* dk, void* dv, int B, int Sq, int Sk,
    int Hq, int Hkv, int D, long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb,
    long long v_ss, long long v_sh, long long do_sb, long long do_ss,
    long long do_sh, long long dk_sb, long long dk_ss, long long dk_sh,
    long long dv_sb, long long dv_ss, long long dv_sh, float scale,
    int causal, void* stream) {
  if (D != 128) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int smem = dkv_smem_bytes<128>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<128>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sk + BLOCK_M - 1) / BLOCK_M, Hkv, B);
  flash_bwd_dkv_kernel<128><<<grid, NUM_WARPS * 32, smem,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(dd),
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), Sq,
      Sk, Hq, Hq / Hkv, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
      do_sb, do_ss, do_sh, dk_sb, dk_ss, dk_sh, dv_sb, dv_ss, dv_sh, scale,
      causal);
  return static_cast<int>(cudaGetLastError());
}
