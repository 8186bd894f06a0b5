// Flash attention forward for Hopper (sm_90a): bf16 in and out, f32 math.
//
// Replaces: k8s_tpu/ops/attention.py:_fwd_kernel (launched by
// _flash_forward through pl.pallas_call) — blockwise online-softmax
// attention, causal block skip, GQA by h // groups, O plus optional lse.
//
// What bounds it on the H100: at prefill and training lengths the work
// is 4*Sq*Sk*D*Hq flops (halved by causality) over only
// (2*Sq*Hq + 2*Sk*Hkv)*D*2 bytes, far above the ~295 FLOP/byte ridge, so
// tensor-core throughput bounds it; at the shortest buckets (16-64
// tokens) launch latency does.
//
// Design: warp specialised, one block per (q head, batch, query tile).
//
// - Warpgroup 0 is the producer: it gives up registers (setmaxnreg) and
//   one thread issues every TMA load. Q's tile arrives once; K and V
//   tiles of 128 keys stream through a 2-stage ring guarded by full and
//   empty mbarriers, so the next tile's load overlaps this one's math.
//   Tensor maps over the strided [B, S, H, D] views (built per call by
//   the C entry point) read 64-column, 128B-swizzled boxes and zero-fill
//   rows past the sequence end, so a ragged tail needs only the mask.
// - Each consumer warpgroup owns 64 query rows (BLOCK_M = 64 x
//   consumers): S = Q K^T is a wgmma m64n128k16 chain with both operands
//   in shared memory (K-major), the online softmax runs in base 2 on the
//   f32 accumulator (scale * log2(e) folded into one FMA before ex2), P
//   is packed to bf16 in registers and O += P V is a wgmma with A from
//   registers and V as an MN-major B. O, the running max and the sum stay
//   in registers for the whole key loop (the TPU's VMEM scratch carry).
// - Causal blocks stop at the diagonal; only tiles that cross it, or the
//   ragged last tile, are masked. Query tiles are scheduled last-first
//   (blockIdx.z reversed), so the longest causal rows start first.
// - Epilogue: O / l goes to bf16 through this warpgroup's Q rows in
//   shared memory (same swizzle, conflict-free) and out to the device in
//   16-byte stores, rows past Sq dropped; lse = (m2 + log2 l) * ln 2, the
//   natural-log value the backward kernels (flash_bwd.cu) read.
//
// Two instances, chosen per call by the wrapper (ops/attention.py
// _flash_fwd_config): two consumer warpgroups (BLOCK_M 128, 384 threads,
// 160 KB of shared memory) for long sequences, one (BLOCK_M 64, 256
// threads) when 128-row tiles would leave SMs idle.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int D = 128;        // head dim: two 64-wide swizzled halves
constexpr int BLOCK_N = 128;  // keys per K/V tile
constexpr int STAGES = 2;     // K/V ring depth
constexpr int KV_HALF_BYTES = BLOCK_N * 128;  // one 64-column half of a tile
constexpr int KV_TILE_BYTES = 2 * KV_HALF_BYTES;
constexpr float LN2 = 0.6931471805599453f;

template <int NC>  // consumer warpgroups
struct Cfg {
  static constexpr int BLOCK_M = 64 * NC;
  static constexpr int THREADS = 128 * (NC + 1);
  static constexpr int Q_HALF_BYTES = BLOCK_M * 128;
  static constexpr int Q_BYTES = 2 * Q_HALF_BYTES;
  static constexpr int OFF_K = Q_BYTES;
  static constexpr int OFF_V = OFF_K + STAGES * KV_TILE_BYTES;
  static constexpr int OFF_BAR = OFF_V + STAGES * KV_TILE_BYTES;
  // q barrier, full[STAGES], empty[STAGES]; + slack to align to 1024
  static constexpr int SMEM = OFF_BAR + 8 * (1 + 2 * STAGES) + 1024;
};

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int NC>
__global__ void __launch_bounds__(Cfg<NC>::THREADS, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tm_q,
                 const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v,
                 __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                 int Sq, int Sk, int Hq, int groups, long long o_sb,
                 long long o_ss, long long o_sh, float scale_log2,
                 int causal) {
  using C = Cfg<NC>;
  extern __shared__ uint8_t smem_raw[];
  // 128B-swizzled tiles start on 1024-byte boundaries
  const uint32_t raw = smem_u32(smem_raw);
  uint8_t* smem = smem_raw + (((raw + 1023) & ~1023u) - raw);
  const uint32_t sbase = smem_u32(smem);
  const uint32_t bar_q = sbase + C::OFF_BAR;
  const uint32_t bar_full = bar_q + 8;               // + 8 * stage
  const uint32_t bar_empty = bar_full + 8 * STAGES;  // + 8 * stage

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * C::BLOCK_M;  // last tile first
  // causal: keys past the tile's last query row are never visible
  const int kv_end = causal ? min(Sk, q0 + C::BLOCK_M) : Sk;
  const int n_tiles = (kv_end + BLOCK_N - 1) / BLOCK_N;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, NC);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---------------- producer warpgroup ----------------
    if constexpr (NC == 2) setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      const int hk = h / groups;
      mbar_arrive_expect_tx(bar_q, C::Q_BYTES);
      tma_load_4d(sbase, &tm_q, bar_q, 0, h, q0, b);
      tma_load_4d(sbase + C::Q_HALF_BYTES, &tm_q, bar_q, 64, h, q0, b);
      for (int it = 0; it < n_tiles; ++it) {
        const int stage = it % STAGES;
        if (it >= STAGES) mbar_wait(bar_empty + 8 * stage, (it / STAGES - 1) & 1);
        const uint32_t full = bar_full + 8 * stage;
        const uint32_t ks = sbase + C::OFF_K + stage * KV_TILE_BYTES;
        const uint32_t vs = sbase + C::OFF_V + stage * KV_TILE_BYTES;
        const int k0 = it * BLOCK_N;
        mbar_arrive_expect_tx(full, 2 * KV_TILE_BYTES);
        tma_load_4d(ks, &tm_k, full, 0, hk, k0, b);
        tma_load_4d(ks + KV_HALF_BYTES, &tm_k, full, 64, hk, k0, b);
        tma_load_4d(vs, &tm_v, full, 0, hk, k0, b);
        tma_load_4d(vs + KV_HALF_BYTES, &tm_v, full, 64, hk, k0, b);
      }
    }
  } else {
    // ---------------- consumer warpgroups ----------------
    if constexpr (NC == 2) setmaxnreg_inc<232>();
    const int tid = threadIdx.x - 128;
    const int cw = tid / 128;  // this warpgroup's 64 rows of the tile
    const int warp = (tid / 32) % 4, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    const int wg_row0 = q0 + cw * 64;
    const int r0 = wg_row0 + warp * 16 + g;  // d[4j + 0, 1]; r0 + 8: d[4j + 2, 3]
    const int r1 = r0 + 8;
    const uint32_t sq = sbase + cw * 64 * 128;  // its Q rows in half 0

    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    float m0 = -INFINITY, m1 = -INFINITY;  // running max of the raw scores
    float l0 = 0.f, l1 = 0.f;  // running sums over this thread's columns

    mbar_wait(bar_q, 0);
    for (int it = 0; it < n_tiles; ++it) {
      const int stage = it % STAGES;
      const int k0 = it * BLOCK_N;
      const uint32_t ks = sbase + C::OFF_K + stage * KV_TILE_BYTES;
      const uint32_t vs = sbase + C::OFF_V + stage * KV_TILE_BYTES;
      mbar_wait(bar_full + 8 * stage, (it / STAGES) & 1);

      // S = Q K^T: 64 rows x 128 keys, 8 k steps over the head dim
      float s[64];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32;  // 16 columns into the half
        wgmma_m64n128k16_ss<0>(
            s, desc_kmajor(sq + (kk / 4) * C::Q_HALF_BYTES + off),
            desc_kmajor(ks + (kk / 4) * KV_HALF_BYTES + off), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands(s);

      // mask only a tile that crosses the diagonal or the sequence end
      if (k0 + BLOCK_N > Sk || (causal && k0 + BLOCK_N - 1 > wg_row0)) {
#pragma unroll
        for (int j = 0; j < 16; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = k0 + 8 * j + 2 * t + (e & 1);
            const int row = e < 2 ? r0 : r1;
            if (key >= Sk || (causal && key > row)) s[4 * j + e] = -INFINITY;
          }
        }
      }

      // online softmax in base 2 (scale > 0, so the raw max is the max)
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
        mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      // a row with nothing visible yet keeps -inf: subtract 0 instead
      const float ms0 = mx0 == -INFINITY ? 0.f : mx0 * scale_log2;
      const float ms1 = mx1 == -INFINITY ? 0.f : mx1 * scale_log2;
      const float corr0 = fast_exp2(m0 * scale_log2 - ms0);
      const float corr1 = fast_exp2(m1 * scale_log2 - ms1);
      m0 = mx0;
      m1 = mx1;

      uint32_t p[32];
      float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const float p0 = fast_exp2(fmaf(s[4 * j], scale_log2, -ms0));
        const float p1 = fast_exp2(fmaf(s[4 * j + 1], scale_log2, -ms0));
        const float p2 = fast_exp2(fmaf(s[4 * j + 2], scale_log2, -ms1));
        const float p3 = fast_exp2(fmaf(s[4 * j + 3], scale_log2, -ms1));
        ls0 += p0 + p1;
        ls1 += p2 + p3;
        p[2 * j] = pack_f32(p0, p1);
        p[2 * j + 1] = pack_f32(p2, p3);
      }
      l0 = l0 * corr0 + ls0;
      l1 = l1 * corr1 + ls1;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        acc[4 * j] *= corr0;
        acc[4 * j + 1] *= corr0;
        acc[4 * j + 2] *= corr1;
        acc[4 * j + 3] *= corr1;
      }

      // O += P V: 8 k steps of 16 keys, V as the MN-major B operand
      fence_operands(acc);
      fence_operands(p);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BLOCK_N / 16; ++kk) {
        const uint32_t a[4] = {p[4 * kk], p[4 * kk + 1], p[4 * kk + 2],
                               p[4 * kk + 3]};
        wgmma_m64n128k16_rs<1>(
            acc, a, desc_mnmajor(vs + kk * 16 * 128, KV_HALF_BYTES), 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands(acc);
      fence_operands(p);
      if (tid % 128 == 0) mbar_arrive(bar_empty + 8 * stage);
    }

    // ---------------- epilogue ----------------
    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    l0 = fmaxf(l0, 1e-30f);
    l1 = fmaxf(l1, 1e-30f);
    const float inv0 = 1.f / l0, inv1 = 1.f / l1;
    // O in bf16 over this warpgroup's Q rows (no longer read), in the
    // same swizzled two-half layout
    uint8_t* so = smem + cw * 64 * 128;
    const int rl0 = warp * 16 + g;  // rl0 % 8 == (rl0 + 8) % 8 == g
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      uint8_t* chunk = so + (j / 8) * C::Q_HALF_BYTES + (((j % 8) ^ g) * 16) + t * 4;
      *reinterpret_cast<uint32_t*>(chunk + rl0 * 128) =
          pack_f32(acc[4 * j] * inv0, acc[4 * j + 1] * inv0);
      *reinterpret_cast<uint32_t*>(chunk + (rl0 + 8) * 128) =
          pack_f32(acc[4 * j + 2] * inv1, acc[4 * j + 3] * inv1);
    }
    named_bar_sync(1 + cw, 128);
    __nv_bfloat16* ob = o + b * o_sb + h * o_sh;
    for (int i = tid % 128; i < 64 * 16; i += 128) {
      const int rl = i / 16, j = i % 16;
      const int row = wg_row0 + rl;
      if (row < Sq)
        *reinterpret_cast<uint4*>(ob + row * o_ss + j * 8) =
            *reinterpret_cast<const uint4*>(
                so + (j / 8) * C::Q_HALF_BYTES + rl * 128 + (((j % 8) ^ (rl % 8)) * 16));
    }
    if (lse != nullptr && t == 0) {
      float* lb = lse + (static_cast<long long>(b) * Hq + h) * Sq;
      if (r0 < Sq) lb[r0] = (m0 * scale_log2 + log2f(l0)) * LN2;
      if (r1 < Sq) lb[r1] = (m1 * scale_log2 + log2f(l1)) * LN2;
    }
  }
}

template <int NC>
int launch(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
           void* o, void* lse, int B, int Sq, int Sk, int Hq, int groups,
           long long o_sb, long long o_ss, long long o_sh, float scale_log2,
           int causal, cudaStream_t stream) {
  using C = Cfg<NC>;
  static std::atomic<bool> smem_set[hopper::MAX_DEVICES];
  const cudaError_t attr =
      hopper::set_smem_limit_once(flash_fwd_kernel<NC>, C::SMEM, smem_set);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(Hq, B, (Sq + C::BLOCK_M - 1) / C::BLOCK_M);
  flash_fwd_kernel<NC><<<grid, C::THREADS, C::SMEM, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse),
      Sq, Sk, Hq, groups, o_sb, o_ss, o_sh, scale_log2, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" const char* k8s_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// the dynamic shared memory of one block of tile config `config` (bytes)
extern "C" int k8s_flash_fwd_smem_bytes(int config) {
  return config == 0 ? Cfg<2>::SMEM : Cfg<1>::SMEM;
}

// q [B, Sq, Hq, D], k/v [B, Sk, Hkv, D] (bf16, strided: unit stride on D,
// other strides multiples of 8 elements, bases 16-byte aligned — TMA's
// rules), o like q, lse [B, Hq, Sq] f32 or null. Causal requires
// Sq == Sk; scale > 0. config 0: 128-row query tiles (two consumer
// warpgroups), 1: 64-row tiles (one). Built for D = 128 (Llama-3-8B);
// anything else returns cudaErrorInvalidValue.
extern "C" int k8s_flash_fwd_bf16(
    const void* q, const void* k, const void* v, void* o, void* lse, int B,
    int Sq, int Sk, int Hq, int Hkv, int D_, long long q_sb, long long q_ss,
    long long q_sh, long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh, long long o_sb,
    long long o_ss, long long o_sh, float scale, int causal, int config,
    void* stream) {
  if (D_ != D || Hkv <= 0 || Hq % Hkv || !(scale > 0.f) || Sk <= 0 ||
      (config != 0 && config != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || Sq == 0) return 0;
  const int block_m = config == 0 ? Cfg<2>::BLOCK_M : Cfg<1>::BLOCK_M;
  CUtensorMap tq, tk, tv;
  int err = make_bshd_map(&tq, q, B, Sq, Hq, D, q_sb, q_ss, q_sh, block_m);
  if (!err) err = make_bshd_map(&tk, k, B, Sk, Hkv, D, k_sb, k_ss, k_sh, BLOCK_N);
  if (!err) err = make_bshd_map(&tv, v, B, Sk, Hkv, D, v_sb, v_ss, v_sh, BLOCK_N);
  if (err) return err;
  const float scale_log2 = scale * 1.4426950408889634f;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return config == 0
             ? launch<2>(tq, tk, tv, o, lse, B, Sq, Sk, Hq, Hq / Hkv, o_sb, o_ss,
                         o_sh, scale_log2, causal, s)
             : launch<1>(tq, tk, tv, o, lse, B, Sq, Sk, Hq, Hq / Hkv, o_sb, o_ss,
                         o_sh, scale_log2, causal, s);
}
