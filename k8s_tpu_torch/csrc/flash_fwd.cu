// Flash attention forward for Hopper (sm_90a): bf16 in and out, f32 math.
//
// Replaces: k8s_tpu/ops/attention.py:_fwd_kernel (launched by
// _flash_forward through pl.pallas_call) — blockwise online-softmax
// attention, causal block skip, GQA by h // groups, O plus optional lse.
//
// What bounds it on the H100: at prefill lengths the work is
// 4*Sq*Sk*D*Hq multiply-adds over only (2*Sq*Hq + 2*Sk*Hkv)*D*2 bytes,
// far above the ~295 FLOP/byte ridge, so tensor-core throughput bounds
// it; at the shortest buckets (16-64 tokens) launch latency does.
//
// Design: one block of 4 warps owns one (batch, q-head, 64-row q tile)
// and loops over 64-row KV tiles itself — the loop takes the place of
// the TPU's sequential kv grid axis plus VMEM scratch carry, since
// Hopper blocks run in no order and carry nothing between them. Each
// warp keeps 16 query rows: its Q fragments, the running max/sum and
// the f32 output accumulator live in registers for the whole loop; K
// and V tiles are staged in padded shared memory (conflict-free
// fragment reads). Both products are mma.sync m16n8k16 bf16 -> f32;
// the score fragments are re-packed in registers as the A operand of
// P*V, so the score tile never touches shared or device memory. Causal
// blocks stop at the diagonal; a ragged last tile (any bucket length)
// is zero-filled and masked, so no length restriction applies. K/V are
// read at kv head h / groups through the [B, S, H, D] strides — no
// transpose copies. Not yet used: wgmma, TMA, double buffering.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCK_Q = 64;  // query rows per block: 4 warps x 16
constexpr int BLOCK_K = 64;  // keys per KV tile
constexpr int NUM_WARPS = 4;
constexpr int PAD = 8;       // bf16 padding per shared row (bank spread)
constexpr float NEG_INF = -1e30f;

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

template <int D>
__global__ void __launch_bounds__(NUM_WARPS * 32)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                 int Sq, int Sk, int Hq, int groups,
                 long long q_sb, long long q_ss, long long q_sh,
                 long long k_sb, long long k_ss, long long k_sh,
                 long long v_sb, long long v_ss, long long v_sh,
                 long long o_sb, long long o_ss, long long o_sh,
                 float scale, int causal) {
  constexpr int KSTEPS = D / 16;      // mma k-steps over the head dim
  constexpr int DTILES = D / 8;       // 8-wide column tiles of O
  constexpr int NTILES = BLOCK_K / 8; // 8-wide key tiles of S
  constexpr int LD = D + PAD;         // shared row stride (elements)
  __shared__ __align__(16) __nv_bfloat16 ks[BLOCK_K * LD];
  __shared__ __align__(16) __nv_bfloat16 vs[BLOCK_K * LD];

  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;  // mma group id / thread in group
  const int q0 = blockIdx.x * BLOCK_Q;
  const int row0 = q0 + warp * 16 + g;  // this thread's rows: row0, row0 + 8

  const __nv_bfloat16* qb = q + b * q_sb + h * q_sh;
  const __nv_bfloat16* kb = k + b * k_sb + (h / groups) * k_sh;
  const __nv_bfloat16* vb = v + b * v_sb + (h / groups) * v_sh;

  // A fragments of this warp's 16 query rows, straight from memory
  uint32_t qa[KSTEPS][4];
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    const int c = kk * 16 + t * 2;
    qa[kk][0] = load_pair(qb, row0, c, Sq, q_ss);
    qa[kk][1] = load_pair(qb, row0 + 8, c, Sq, q_ss);
    qa[kk][2] = load_pair(qb, row0, c + 8, Sq, q_ss);
    qa[kk][3] = load_pair(qb, row0 + 8, c + 8, Sq, q_ss);
  }

  float m[2] = {NEG_INF, NEG_INF};  // running max (scaled scores)
  float l[2] = {0.f, 0.f};          // running sum, this thread's columns
  float acc[DTILES][4];
#pragma unroll
  for (int dt = 0; dt < DTILES; ++dt)
    acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;

  // causal: keys past the block's last query row are never visible
  const int kv_end = causal ? min(Sk, q0 + BLOCK_Q) : Sk;
  for (int k0 = 0; k0 < kv_end; k0 += BLOCK_K) {
    __syncthreads();  // the previous tile is fully consumed
    for (int i = tid; i < BLOCK_K * (D / 8); i += NUM_WARPS * 32) {
      const int r = i / (D / 8), c = (i % (D / 8)) * 8;
      uint4 kv4 = make_uint4(0u, 0u, 0u, 0u), vv4 = kv4;
      if (k0 + r < Sk) {
        kv4 = *reinterpret_cast<const uint4*>(kb + (k0 + r) * k_ss + c);
        vv4 = *reinterpret_cast<const uint4*>(vb + (k0 + r) * v_ss + c);
      }
      *reinterpret_cast<uint4*>(ks + r * LD + c) = kv4;
      *reinterpret_cast<uint4*>(vs + r * LD + c) = vv4;
    }
    __syncthreads();

    // S = Q K^T for 16 rows x 64 keys
    float s[NTILES][4];
#pragma unroll
    for (int nt = 0; nt < NTILES; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      const __nv_bfloat16* kr = ks + (nt * 8 + g) * LD + t * 2;
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(kr + kk * 16);
        const uint32_t b1 =
            *reinterpret_cast<const uint32_t*>(kr + kk * 16 + 8);
        mma16816(s[nt], qa[kk], b0, b1);
      }
    }

    // scale, mask (ragged tail + causal), tile row max
    float mcur[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int nt = 0; nt < NTILES; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + nt * 8 + t * 2 + (e & 1);
        const int row = row0 + (e >> 1) * 8;
        float x = s[nt][e] * scale;
        if (key >= Sk || (causal && key > row)) x = NEG_INF;
        s[nt][e] = x;
        mcur[e >> 1] = fmaxf(mcur[e >> 1], x);
      }
    }
    float corr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mcur[i] = fmaxf(mcur[i], __shfl_xor_sync(0xffffffffu, mcur[i], 1));
      mcur[i] = fmaxf(mcur[i], __shfl_xor_sync(0xffffffffu, mcur[i], 2));
      const float mnew = fmaxf(m[i], mcur[i]);
      corr[i] = __expf(m[i] - mnew);
      m[i] = mnew;
    }
    float lsum[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < NTILES; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = __expf(s[nt][e] - m[e >> 1]);
        s[nt][e] = p;
        lsum[e >> 1] += p;
      }
    }
    l[0] = l[0] * corr[0] + lsum[0];
    l[1] = l[1] * corr[1] + lsum[1];
#pragma unroll
    for (int dt = 0; dt < DTILES; ++dt) {
      acc[dt][0] *= corr[0];
      acc[dt][1] *= corr[0];
      acc[dt][2] *= corr[1];
      acc[dt][3] *= corr[1];
    }

    // O += P V: score fragments re-packed as bf16 A fragments
#pragma unroll
    for (int kk = 0; kk < BLOCK_K / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_f32(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_f32(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_f32(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_f32(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      const __nv_bfloat16* vr = vs + (kk * 16 + t * 2) * LD + g;
#pragma unroll
      for (int dt = 0; dt < DTILES; ++dt) {
        const __nv_bfloat16* vp = vr + dt * 8;
        const uint32_t b0 = pack_bf16(vp[0], vp[LD]);
        const uint32_t b1 = pack_bf16(vp[8 * LD], vp[9 * LD]);
        mma16816(acc[dt], pa, b0, b1);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    l[i] = fmaxf(l[i], 1e-30f);
  }
  __nv_bfloat16* ob = o + b * o_sb + h * o_sh;
#pragma unroll
  for (int dt = 0; dt < DTILES; ++dt) {
    const int col = dt * 8 + t * 2;
    if (row0 < Sq)
      *reinterpret_cast<uint32_t*>(ob + row0 * o_ss + col) =
          pack_f32(acc[dt][0] / l[0], acc[dt][1] / l[0]);
    if (row0 + 8 < Sq)
      *reinterpret_cast<uint32_t*>(ob + (row0 + 8) * o_ss + col) =
          pack_f32(acc[dt][2] / l[1], acc[dt][3] / l[1]);
  }
  if (lse != nullptr && t == 0) {
    float* lb = lse + (static_cast<long long>(b) * Hq + h) * Sq;
    if (row0 < Sq) lb[row0] = m[0] + logf(l[0]);
    if (row0 + 8 < Sq) lb[row0 + 8] = m[1] + logf(l[1]);
  }
}

}  // namespace

extern "C" const char* k8s_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q [B, Sq, Hq, D], k/v [B, Sk, Hkv, D], o like q (bf16, strided; unit
// stride on D), lse [B, Hq, Sq] f32 or null. Causal requires Sq == Sk.
// Built for D = 128 (Llama-3-8B); another D returns cudaErrorInvalidValue.
extern "C" int k8s_flash_fwd_bf16(
    const void* q, const void* k, const void* v, void* o, void* lse, int B,
    int Sq, int Sk, int Hq, int Hkv, int D, long long q_sb, long long q_ss,
    long long q_sh, long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh, long long o_sb,
    long long o_ss, long long o_sh, float scale, int causal, void* stream) {
  if (D != 128) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((Sq + BLOCK_Q - 1) / BLOCK_Q, Hq, B);
  flash_fwd_kernel<128><<<grid, NUM_WARPS * 32, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      static_cast<float*>(lse), Sq, Sk, Hq, Hq / Hkv, q_sb, q_ss, q_sh, k_sb,
      k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh, scale, causal);
  return static_cast<int>(cudaGetLastError());
}
