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
//   natural-log value the backward kernels (flash_bwd.cu) read. With
//   `out_f32` (the Pallas kernel's out_f32: ring attention merges each
//   ring step's partial O in f32, and rounding every partial to bf16
//   would compound once per step) O / l is stored in f32 straight from
//   the accumulator registers, 8 bytes (two columns) per store, rows past
//   Sq dropped: twice the bf16 bytes would not fit the Q half it stages
//   through, and the stores are a small share of the block's time.
//
// - Segment ids (optional: a null pointer means none): one int32 row per
//   batch for the queries (rows `seg_stride` apart, a multiple of 4) and
//   one for the keys, `seg_kv`, with the same stride (Sq == Sk). A null
//   `seg_kv` means the query row serves both sides (self-attention); ring
//   attention passes the resident KV chunk's row, which differs from the
//   local query row (the Pallas kernel's segment_ids_kv). Query row i
//   sees key j only when their ids are equal — the Pallas _segment_mask
//   (packed documents; BERT's padding mask, 1 real, 0 pad). Each
//   consumer thread reads its two rows' ids once from the query row; the
//   producer stages each key tile's 128 ids from the key row in shared
//   memory with the tile (a rank-2 TMA box, zeros past Sk), and
//   every tile is masked, not only the edge ones. (Per-thread loads of
//   the 32 column ids from global memory made K1 2.2x slower at
//   BERT-base's shape on an H100.) A tile may hide every key from some
//   rows: their running max stays where it was (or -inf), and the guard
//   on the max keeps the rescale finite.
//
// Instances: the head dim D (128: two 64-wide swizzled halves per row;
// 64: one half, so half the Q K^T k-steps and an N-64 P V product), with
// or without segment ids (the instance without holds no mask code), O in
// bf16 or f32 (the bf16 instance's code is the one without out_f32), and
// two tile configs, chosen per call by the wrapper (ops/attention.py
// _flash_fwd_config): two consumer warpgroups (BLOCK_M 128, 384 threads,
// 160 KB of shared memory at D 128) for long sequences, one (BLOCK_M 64,
// 256 threads) when 128-row tiles would leave SMs idle.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int BLOCK_N = 128;  // keys per K/V tile
constexpr int STAGES = 2;     // K/V ring depth
constexpr int KV_HALF_BYTES = BLOCK_N * 128;  // one 64-column half of a tile
constexpr float LN2 = 0.6931471805599453f;

template <int D, int NC>  // head dim (64 or 128), consumer warpgroups
struct Cfg {
  static constexpr int HALVES = D / 64;  // 64-column swizzled halves per row
  static constexpr int KV_TILE_BYTES = HALVES * KV_HALF_BYTES;
  static constexpr int BLOCK_M = 64 * NC;
  static constexpr int THREADS = 128 * (NC + 1);
  static constexpr int Q_HALF_BYTES = BLOCK_M * 128;
  static constexpr int Q_BYTES = HALVES * Q_HALF_BYTES;
  static constexpr int OFF_K = Q_BYTES;
  static constexpr int OFF_V = OFF_K + STAGES * KV_TILE_BYTES;
  static constexpr int IDS_BYTES = BLOCK_N * 4;  // one key tile's segment ids
  static constexpr int OFF_IDS = OFF_V + STAGES * KV_TILE_BYTES;
  static constexpr int OFF_BAR = OFF_IDS + STAGES * IDS_BYTES;
  // q barrier, full[STAGES], empty[STAGES]; + slack to align to 1024
  static constexpr int SMEM = OFF_BAR + 8 * (1 + 2 * STAGES) + 1024;
};

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

// + whether segment ids mask S, whether O is f32 (else bf16)
template <int D, int NC, bool SEG, bool OF32>
__global__ void __launch_bounds__(Cfg<D, NC>::THREADS, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tm_q,
                 const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v,
                 const __grid_constant__ CUtensorMap tm_seg,
                 void* __restrict__ o, float* __restrict__ lse,
                 const int* __restrict__ seg, long long seg_stride, int Sq,
                 int Sk, int Hq,
                 int groups, long long o_sb, long long o_ss, long long o_sh,
                 float scale_log2, int causal) {
  using C = Cfg<D, NC>;
  constexpr int NJ = D / 8;  // 8-column groups of an output row
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
#pragma unroll
      for (int hh = 0; hh < C::HALVES; ++hh)
        tma_load_4d(sbase + hh * C::Q_HALF_BYTES, &tm_q, bar_q, 64 * hh, h, q0, b);
      for (int it = 0; it < n_tiles; ++it) {
        const int stage = it % STAGES;
        if (it >= STAGES) mbar_wait(bar_empty + 8 * stage, (it / STAGES - 1) & 1);
        const uint32_t full = bar_full + 8 * stage;
        const uint32_t ks = sbase + C::OFF_K + stage * C::KV_TILE_BYTES;
        const uint32_t vs = sbase + C::OFF_V + stage * C::KV_TILE_BYTES;
        const int k0 = it * BLOCK_N;
        mbar_arrive_expect_tx(full, 2 * C::KV_TILE_BYTES + (SEG ? C::IDS_BYTES : 0));
#pragma unroll
        for (int hh = 0; hh < C::HALVES; ++hh) {
          tma_load_4d(ks + hh * KV_HALF_BYTES, &tm_k, full, 64 * hh, hk, k0, b);
          tma_load_4d(vs + hh * KV_HALF_BYTES, &tm_v, full, 64 * hh, hk, k0, b);
        }
        if constexpr (SEG)
          tma_load_2d(sbase + C::OFF_IDS + stage * C::IDS_BYTES, &tm_seg, full, k0, b);
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
    // this batch's query-side segment ids (the key side rides the tiles)
    int sg0 = 0, sg1 = 0;
    if constexpr (SEG) {
      const int* sg = seg + static_cast<long long>(b) * seg_stride;
      sg0 = r0 < Sq ? sg[r0] : 0;
      sg1 = r1 < Sq ? sg[r1] : 0;
    }

    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    float m0 = -INFINITY, m1 = -INFINITY;  // running max of the raw scores
    float l0 = 0.f, l1 = 0.f;  // running sums over this thread's columns

    mbar_wait(bar_q, 0);
    for (int it = 0; it < n_tiles; ++it) {
      const int stage = it % STAGES;
      const int k0 = it * BLOCK_N;
      const uint32_t ks = sbase + C::OFF_K + stage * C::KV_TILE_BYTES;
      const uint32_t vs = sbase + C::OFF_V + stage * C::KV_TILE_BYTES;
      mbar_wait(bar_full + 8 * stage, (it / STAGES) & 1);

      // S = Q K^T: 64 rows x 128 keys, D / 16 k steps over the head dim
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

      // mask a tile that crosses the diagonal or the sequence end, and
      // every tile under segment ids
      if (SEG || k0 + BLOCK_N > Sk || (causal && k0 + BLOCK_N - 1 > wg_row0)) {
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          int2 kid = make_int2(0, 0);  // this tile's key ids, staged by the producer
          if constexpr (SEG)
            kid = *reinterpret_cast<const int2*>(smem + C::OFF_IDS + stage * C::IDS_BYTES +
                                                 4 * (8 * j + 2 * t));
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = k0 + 8 * j + 2 * t + (e & 1);
            const int row = e < 2 ? r0 : r1;
            bool hide = key >= Sk || (causal && key > row);
            if constexpr (SEG) hide = hide || ((e & 1) ? kid.y : kid.x) != (e < 2 ? sg0 : sg1);
            if (hide) s[4 * j + e] = -INFINITY;
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
      for (int j = 0; j < NJ; ++j) {
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
        wgmma_rs<1>(acc, a, desc_mnmajor(vs + kk * 16 * 128, KV_HALF_BYTES), 1);
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
    if constexpr (OF32) {
      // f32 O from the registers: this thread's two columns of each
      // 8-column group, on its rows r0 and r1
      float* ob = static_cast<float*>(o) + b * o_sb + h * o_sh;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int col = 8 * j + 2 * t;
        if (r0 < Sq)
          *reinterpret_cast<float2*>(ob + r0 * o_ss + col) =
              make_float2(acc[4 * j] * inv0, acc[4 * j + 1] * inv0);
        if (r1 < Sq)
          *reinterpret_cast<float2*>(ob + r1 * o_ss + col) =
              make_float2(acc[4 * j + 2] * inv1, acc[4 * j + 3] * inv1);
      }
    } else {
      // O in bf16 over this warpgroup's Q rows (no longer read), in the
      // same swizzled layout
      uint8_t* so = smem + cw * 64 * 128;
      const int rl0 = warp * 16 + g;  // rl0 % 8 == (rl0 + 8) % 8 == g
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        uint8_t* chunk = so + (j / 8) * C::Q_HALF_BYTES + (((j % 8) ^ g) * 16) + t * 4;
        *reinterpret_cast<uint32_t*>(chunk + rl0 * 128) =
            pack_f32(acc[4 * j] * inv0, acc[4 * j + 1] * inv0);
        *reinterpret_cast<uint32_t*>(chunk + (rl0 + 8) * 128) =
            pack_f32(acc[4 * j + 2] * inv1, acc[4 * j + 3] * inv1);
      }
      named_bar_sync(1 + cw, 128);
      __nv_bfloat16* ob = static_cast<__nv_bfloat16*>(o) + b * o_sb + h * o_sh;
      for (int i = tid % 128; i < 64 * NJ; i += 128) {
        const int rl = i / NJ, j = i % NJ;
        const int row = wg_row0 + rl;
        if (row < Sq)
          *reinterpret_cast<uint4*>(ob + row * o_ss + j * 8) =
              *reinterpret_cast<const uint4*>(
                  so + (j / 8) * C::Q_HALF_BYTES + rl * 128 + (((j % 8) ^ (rl % 8)) * 16));
      }
    }
    if (lse != nullptr && t == 0) {
      float* lb = lse + (static_cast<long long>(b) * Hq + h) * Sq;
      if (r0 < Sq) lb[r0] = (m0 * scale_log2 + log2f(l0)) * LN2;
      if (r1 < Sq) lb[r1] = (m1 * scale_log2 + log2f(l1)) * LN2;
    }
  }
}

template <int D, int NC, bool SEG, bool OF32>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           const int* seg, const int* seg_kv, long long seg_stride, int B,
           int Sq, int Sk, int Hq, int Hkv,
           long long q_sb, long long q_ss, long long q_sh, long long k_sb,
           long long k_ss, long long k_sh, long long v_sb, long long v_ss,
           long long v_sh, long long o_sb, long long o_ss, long long o_sh,
           float scale_log2, int causal, cudaStream_t stream) {
  using C = Cfg<D, NC>;
  CUtensorMap tq, tk, tv, tsg = {};
  int err = make_bshd_map(&tq, q, B, Sq, Hq, D, q_sb, q_ss, q_sh, C::BLOCK_M);
  if (!err) err = make_bshd_map(&tk, k, B, Sk, Hkv, D, k_sb, k_ss, k_sh, BLOCK_N);
  if (!err) err = make_bshd_map(&tv, v, B, Sk, Hkv, D, v_sb, v_ss, v_sh, BLOCK_N);
  // the key tiles' ids: the key-side row (the query row without one)
  if (!err && seg != nullptr)
    err = make_rows_map(&tsg, seg_kv != nullptr ? seg_kv : seg, B, Sk, seg_stride, BLOCK_N,
                        CU_TENSOR_MAP_DATA_TYPE_INT32);
  if (err) return err;
  static std::atomic<bool> smem_set[hopper::MAX_DEVICES];
  const cudaError_t attr = hopper::set_smem_limit_once(flash_fwd_kernel<D, NC, SEG, OF32>,
                                                       C::SMEM, smem_set);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(Hq, B, (Sq + C::BLOCK_M - 1) / C::BLOCK_M);
  flash_fwd_kernel<D, NC, SEG, OF32><<<grid, C::THREADS, C::SMEM, stream>>>(
      tq, tk, tv, tsg, o, static_cast<float*>(lse), seg, seg_stride, Sq, Sk, Hq,
      Hq / Hkv, o_sb, o_ss, o_sh, scale_log2, causal);
  return static_cast<int>(cudaGetLastError());
}

using LaunchFn = decltype(&launch<128, 2, false, false>);

// the instance for (segment ids, f32 O) at head dim D and NC consumers
template <int D, int NC>
LaunchFn pick(bool seg, bool of32) {
  if (seg) return of32 ? launch<D, NC, true, true> : launch<D, NC, true, false>;
  return of32 ? launch<D, NC, false, true> : launch<D, NC, false, false>;
}

}  // namespace

extern "C" const char* k8s_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// the dynamic shared memory of one block of tile config `config` at head
// dim `d` (bytes; 0 for a head dim with no instance)
extern "C" int k8s_flash_fwd_smem_bytes(int config, int d) {
  if (d == 128) return config == 0 ? Cfg<128, 2>::SMEM : Cfg<128, 1>::SMEM;
  if (d == 64) return config == 0 ? Cfg<64, 2>::SMEM : Cfg<64, 1>::SMEM;
  return 0;
}

// q [B, Sq, Hq, D], k/v [B, Sk, Hkv, D] (bf16, strided: unit stride on D,
// other strides multiples of 8 elements, bases 16-byte aligned — TMA's
// rules), o like q in bf16, or in f32 with `out_f32`, lse [B, Hq, Sq] f32
// or null, seg [B, Sq] int32 (the query rows) with rows `seg_stride` (a
// multiple of 4, >= Sq) elements apart, or null; seg_kv [B, Sk] int32
// (the key rows, the same stride) or null for the query rows; segment ids
// need Sq == Sk, seg_kv needs seg. Causal requires Sq == Sk; scale > 0.
// config 0: 128-row query tiles (two consumer warpgroups), 1: 64-row
// tiles (one). Built for D = 128 (Llama-3-8B) and D = 64 (BERT-base);
// anything else returns cudaErrorInvalidValue.
extern "C" int k8s_flash_fwd_bf16(
    const void* q, const void* k, const void* v, void* o, void* lse,
    const void* seg, const void* seg_kv, long long seg_stride, int B, int Sq,
    int Sk, int Hq, int Hkv, int D_,
    long long q_sb, long long q_ss, long long q_sh, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss,
    long long v_sh, long long o_sb, long long o_ss, long long o_sh,
    float scale, int causal, int out_f32, int config, void* stream) {
  if ((D_ != 128 && D_ != 64) || Hkv <= 0 || Hq % Hkv || !(scale > 0.f) ||
      Sk <= 0 || (config != 0 && config != 1) || (seg == nullptr && seg_kv != nullptr) ||
      (seg != nullptr && (Sq != Sk || seg_stride % 4 || seg_stride < Sq)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || Sq == 0) return 0;
  const float scale_log2 = scale * 1.4426950408889634f;
  const bool sg = seg != nullptr, f32 = out_f32 != 0;
  const LaunchFn fn = D_ == 128 ? (config == 0 ? pick<128, 2>(sg, f32) : pick<128, 1>(sg, f32))
                                : (config == 0 ? pick<64, 2>(sg, f32) : pick<64, 1>(sg, f32));
  return fn(q, k, v, o, lse, static_cast<const int*>(seg), static_cast<const int*>(seg_kv),
            seg_stride, B, Sq, Sk, Hq, Hkv, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb,
            v_ss, v_sh, o_sb, o_ss, o_sh, scale_log2, causal,
            static_cast<cudaStream_t>(stream));
}
