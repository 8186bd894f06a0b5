// Ragged single-token decode attention with in-place KV-cache append,
// for Hopper (sm_90a): bf16 in and out, f32 math.
//
// Replaces: k8s_tpu/ops/attention.py:_decode_attn_kernel (launched by
// decode_attention_update through pl.pallas_call with
// input_output_aliases) — per (batch, kv-head): the G grouped queries
// attend over cache[b, h, :pos[b]] plus the new token's k/v as an
// explicit extra term, and the new row is appended at pos[b] in place.
//
// What bounds it on the H100: bytes. Each cache row is 2*D*2 bytes and
// takes 4*G*D flops, about G flops per byte — two orders of magnitude
// under the ridge — so the floor is (rows read) / 3.35 TB/s.
//
// Design: one block of 8 warps owns one (batch, kv-head) and serves all
// G queries of the group, so each cache row is read from memory once
// for the group. It reads ONLY rows < pos[b] (the TPU kernel stages the
// whole [S, D] slab into VMEM and masks), plus the new k/v for row
// pos[b]. A row is split over D/8 lanes holding 8 contiguous elements
// each (one 16-byte load per lane per row, coalesced), the dot products
// are finished with lane shuffles, and each row group keeps its own
// running max/sum/accumulator (online softmax, 4 rows in flight per
// iteration). The partials are merged with shuffles inside a warp and
// through shared memory across warps. The new row is written straight
// to cache row pos[b] — no aligned 8-row window is needed. pos is read
// on the device (no host sync) and clamped to [0, S - 1] so a bad
// index cannot write out of bounds. Not yet used: split-S across
// blocks (only B*Hkv blocks are launched), cp.async prefetch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int NUM_WARPS = THREADS / 32;
constexpr int UNROLL = 4;  // rows per row group per iteration

__device__ __forceinline__ void unpack8(const uint4& w, float (&f)[8]) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&w);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 x = __bfloat1622float2(p[j]);
    f[2 * j] = x.x;
    f[2 * j + 1] = x.y;
  }
}

template <int D, int G>
__global__ void __launch_bounds__(THREADS)
decode_attn_kernel(const __nv_bfloat16* __restrict__ q,
                   const __nv_bfloat16* __restrict__ k_new,
                   const __nv_bfloat16* __restrict__ v_new,
                   __nv_bfloat16* __restrict__ k_cache,
                   __nv_bfloat16* __restrict__ v_cache,
                   const int* __restrict__ pos_v,
                   __nv_bfloat16* __restrict__ out, int Hkv, int S,
                   float scale) {
  constexpr int LPR = D / 8;          // lanes per row
  constexpr int RPW = 32 / LPR;       // row groups per warp
  constexpr int GROUPS = NUM_WARPS * RPW;
  __shared__ float sm_m[NUM_WARPS][G];
  __shared__ float sm_l[NUM_WARPS][G];
  __shared__ float sm_acc[NUM_WARPS][G][D];

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int sub = lane / LPR, li = lane % LPR;
  const int grp = warp * RPW + sub;   // this thread's row group
  const int d0 = li * 8;              // this lane's 8 head-dim elements
  const int pos = min(max(pos_v[b], 0), S - 1);
  const long long head = static_cast<long long>(b) * Hkv + h;
  __nv_bfloat16* kc = k_cache + head * S * D;
  __nv_bfloat16* vc = v_cache + head * S * D;
  const __nv_bfloat16* kn = k_new + head * D;
  const __nv_bfloat16* vn = v_new + head * D;
  const __nv_bfloat16* qp = q + head * G * D;  // q heads h*G .. h*G+G-1

  float qf[G][8];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    unpack8(*reinterpret_cast<const uint4*>(qp + g * D + d0), qf[g]);
#pragma unroll
    for (int j = 0; j < 8; ++j) qf[g][j] *= scale;
  }

  float m[G], l[G], acc[G][8];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[g][j] = 0.f;
  }

  // rows [0, pos) from the cache, row pos from k_new / v_new
  const int n_rows = pos + 1;
  for (int base = 0; base < n_rows; base += GROUPS * UNROLL) {
    uint4 kr[UNROLL], vr[UNROLL];
    bool ok[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int r = base + u * GROUPS + grp;
      ok[u] = r < n_rows;
      kr[u] = vr[u] = make_uint4(0u, 0u, 0u, 0u);
      if (ok[u]) {
        const __nv_bfloat16* ks = r == pos ? kn : kc + static_cast<long long>(r) * D;
        const __nv_bfloat16* vs = r == pos ? vn : vc + static_cast<long long>(r) * D;
        kr[u] = *reinterpret_cast<const uint4*>(ks + d0);
        vr[u] = *reinterpret_cast<const uint4*>(vs + d0);
      }
    }
    float s[UNROLL][G];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      float kf[8];
      unpack8(kr[u], kf);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float x = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) x = fmaf(qf[g][j], kf[j], x);
#pragma unroll
        for (int off = LPR / 2; off > 0; off >>= 1)
          x += __shfl_xor_sync(0xffffffffu, x, off);
        s[u][g] = ok[u] ? x : -INFINITY;
      }
    }
    float vf[UNROLL][8];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) unpack8(vr[u], vf[u]);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float mnew = m[g];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) mnew = fmaxf(mnew, s[u][g]);
      if (mnew == -INFINITY) continue;  // no row of this group yet
      const float corr = __expf(m[g] - mnew);
      l[g] *= corr;
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[g][j] *= corr;
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const float p = __expf(s[u][g] - mnew);
        l[g] += p;
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[g][j] = fmaf(p, vf[u][j], acc[g][j]);
      }
      m[g] = mnew;
    }
  }

  // merge the row groups of this warp (lanes holding the same d0)
#pragma unroll
  for (int off = LPR; off < 32; off <<= 1) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[g], off);
      const float lo = __shfl_xor_sync(0xffffffffu, l[g], off);
      const float mn = fmaxf(m[g], mo);
      const float a = m[g] == -INFINITY ? 0.f : __expf(m[g] - mn);
      const float c = mo == -INFINITY ? 0.f : __expf(mo - mn);
      l[g] = l[g] * a + lo * c;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float ao = __shfl_xor_sync(0xffffffffu, acc[g][j], off);
        acc[g][j] = acc[g][j] * a + ao * c;
      }
      m[g] = mn;
    }
  }
  if (sub == 0) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (li == 0) {
        sm_m[warp][g] = m[g];
        sm_l[warp][g] = l[g];
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) sm_acc[warp][g][d0 + j] = acc[g][j];
    }
  }
  // append the new row in place; no thread reads cache row pos
  for (int i = tid; i < D / 8; i += THREADS) {
    reinterpret_cast<uint4*>(kc + static_cast<long long>(pos) * D)[i] =
        reinterpret_cast<const uint4*>(kn)[i];
    reinterpret_cast<uint4*>(vc + static_cast<long long>(pos) * D)[i] =
        reinterpret_cast<const uint4*>(vn)[i];
  }
  __syncthreads();

  // merge across warps; row pos always exists, so M is finite
  for (int i = tid; i < G * D; i += THREADS) {
    const int g = i / D, d = i % D;
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < NUM_WARPS; ++w) M = fmaxf(M, sm_m[w][g]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < NUM_WARPS; ++w) {
      const float mw = sm_m[w][g];
      const float f = mw == -INFINITY ? 0.f : __expf(mw - M);
      L += sm_l[w][g] * f;
      A += sm_acc[w][g][d] * f;
    }
    out[(head * G + g) * D + d] = __float2bfloat16(A / L);
  }
}

}  // namespace

extern "C" const char* k8s_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q [B, Hkv*G, D], k_new/v_new [B, Hkv, D], caches [B, Hkv, S, D] (all
// bf16, contiguous), pos [B] int32 on the device, out like q. Built for
// D = 128, G = 4 (Llama-3-8B); other shapes return cudaErrorInvalidValue.
extern "C" int k8s_decode_attn_bf16(const void* q, const void* k_new,
                                    const void* v_new, void* k_cache,
                                    void* v_cache, const void* pos, void* out,
                                    int B, int Hkv, int G, int S, int D,
                                    float scale, void* stream) {
  if (D != 128 || G != 4) return static_cast<int>(cudaErrorInvalidValue);
  decode_attn_kernel<128, 4>
      <<<dim3(Hkv, B), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const __nv_bfloat16*>(q),
          static_cast<const __nv_bfloat16*>(k_new),
          static_cast<const __nv_bfloat16*>(v_new),
          static_cast<__nv_bfloat16*>(k_cache),
          static_cast<__nv_bfloat16*>(v_cache), static_cast<const int*>(pos),
          static_cast<__nv_bfloat16*>(out), Hkv, S, scale);
  return static_cast<int>(cudaGetLastError());
}
