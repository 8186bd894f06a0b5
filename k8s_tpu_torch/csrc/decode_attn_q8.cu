// Ragged single-token decode attention over an int8 KV cache with per-row
// f32 scales, with the in-place quantized append, for Hopper (sm_90a):
// bf16 q / new k,v / out, int8 cache, f32 math.
//
// Replaces: k8s_tpu/ops/attention.py:_decode_attn_kernel_q8 (launched by
// decode_attention_update_q8 through pl.pallas_call with
// input_output_aliases) — per (batch, kv-head): the G grouped queries
// attend over cache[b, h, :pos[b]] (scores (scale q).k_int8 times the
// row's key scale, probs times the row's value scale before the PV
// product) plus the new token's exact bf16 k/v as an extra term; the new
// row is quantized (scale amax / 127 over D, amax clamped at 1e-6, round
// half to even) and written at pos[b] with its scales, in place.
//
// What bounds it on the H100: bytes. A cache row costs 2*D int8 bytes
// plus two f32 scales (264 B at D = 128, against 512 B for the bf16
// cache of decode_attn.cu) for 4*G*D flops, so the floor is
// (rows read) * 264 B / 3.35 TB/s.
//
// Design: decode_attn.cu's, for 1-byte elements. One block of 8 warps
// owns one (batch, kv-head) and serves all G queries of the group; it
// reads ONLY rows < pos[b]. A 128-byte int8 row is split over D/16 = 8
// lanes holding 16 contiguous elements each (one 16-byte load per lane
// per row, coalesced), so a warp covers 4 rows at a time. The scales are
// applied to the [G]-sized scores and probs, never to the [S, D] cache.
// Each row group keeps its own running max/sum/accumulator (online
// softmax), merged with lane shuffles inside a warp and through shared
// memory across warps; the new token's term joins in that last merge.
// Warps 0 and 1 quantize k_new / v_new before the loop: the amax is a
// shuffle reduction over the 32 lanes that hold D, the scale amax times
// the f32 reciprocal of 127 (how XLA compiles the reference's amax /
// 127), the quotient an IEEE divide (no fast-math flags) and the
// rounding __float2int_rn (ties to even), so the appended row and scale
// are bit-identical to the plain version's. pos is read on
// the device and clamped to [0, S - 1]. Not yet used: split-S across
// blocks (only B*Hkv blocks are launched), cp.async prefetch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int NUM_WARPS = THREADS / 32;
constexpr int UNROLL = 2;  // rows per row group per iteration

__device__ __forceinline__ void unpack_bf16x8(const uint4& w, float* f) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&w);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 x = __bfloat1622float2(p[j]);
    f[2 * j] = x.x;
    f[2 * j + 1] = x.y;
  }
}

__device__ __forceinline__ void unpack_bf16x4(const uint2& w, float (&f)[4]) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&w);
  const float2 a = __bfloat1622float2(p[0]);
  const float2 c = __bfloat1622float2(p[1]);
  f[0] = a.x;
  f[1] = a.y;
  f[2] = c.x;
  f[3] = c.y;
}

// 16 int8 values (one 16-byte load) to f32, sign-extended by shifts
__device__ __forceinline__ void unpack_i8x16(const uint4& w, float (&f)[16]) {
  const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      f[4 * i + j] =
          static_cast<float>(static_cast<int>(words[i] << (24 - 8 * j)) >> 24);
  }
}

template <int D, int G>
__global__ void __launch_bounds__(THREADS)
decode_attn_q8_kernel(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k_new,
                      const __nv_bfloat16* __restrict__ v_new,
                      int8_t* __restrict__ k_cache,
                      int8_t* __restrict__ v_cache,
                      float* __restrict__ k_scale,
                      float* __restrict__ v_scale,
                      const int* __restrict__ pos_v,
                      __nv_bfloat16* __restrict__ out, int Hkv, int S,
                      float scale) {
  constexpr int EPL = 16;             // int8 elements per lane
  constexpr int LPR = D / EPL;        // lanes per row
  constexpr int RPW = 32 / LPR;       // row groups per warp
  constexpr int GROUPS = NUM_WARPS * RPW;
  constexpr int NPL = D / 32;         // new-row elements per lane
  __shared__ float sm_m[NUM_WARPS][G];
  __shared__ float sm_l[NUM_WARPS][G];
  __shared__ float sm_acc[NUM_WARPS][G][D];
  __shared__ float sm_snew[G];

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int sub = lane / LPR, li = lane % LPR;
  const int grp = warp * RPW + sub;   // this thread's row group
  const int d0 = li * EPL;            // this lane's 16 head-dim elements
  const int pos = min(max(pos_v[b], 0), S - 1);
  const long long head = static_cast<long long>(b) * Hkv + h;
  int8_t* kc = k_cache + head * S * D;
  int8_t* vc = v_cache + head * S * D;
  float* ks = k_scale + head * S;
  float* vs = v_scale + head * S;
  const __nv_bfloat16* kn = k_new + head * D;
  const __nv_bfloat16* vn = v_new + head * D;
  const __nv_bfloat16* qp = q + head * G * D;  // q heads h*G .. h*G+G-1

  // the new row: warp 0 quantizes k_new (and takes the new token's
  // scores), warp 1 v_new; both append at row pos, which no thread reads
  if (warp < 2) {
    const __nv_bfloat16* src = warp == 0 ? kn : vn;
    float x[NPL];
    unpack_bf16x4(*reinterpret_cast<const uint2*>(src + lane * NPL), x);
    float amax = 0.f;
#pragma unroll
    for (int j = 0; j < NPL; ++j) amax = fmaxf(amax, fabsf(x[j]));
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
    // the reference's amax / 127 as XLA compiles it (times the f32
    // reciprocal); the quotient below is an IEEE divide
    const float s8 = fmaxf(amax, 1e-6f) * (1.0f / 127.0f);
    uint32_t packed = 0u;
#pragma unroll
    for (int j = 0; j < NPL; ++j)
      packed |= (static_cast<uint32_t>(__float2int_rn(x[j] / s8)) & 0xffu)
                << (8 * j);
    int8_t* dst = (warp == 0 ? kc : vc) + static_cast<long long>(pos) * D;
    *reinterpret_cast<uint32_t*>(dst + lane * NPL) = packed;
    if (lane == 0) (warp == 0 ? ks : vs)[pos] = s8;
    if (warp == 0) {
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float qv[NPL];
        unpack_bf16x4(*reinterpret_cast<const uint2*>(qp + g * D + lane * NPL), qv);
        float part = 0.f;
#pragma unroll
        for (int j = 0; j < NPL; ++j) part = fmaf(qv[j] * scale, x[j], part);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          part += __shfl_xor_sync(0xffffffffu, part, off);
        if (lane == 0) sm_snew[g] = part;
      }
    }
  }

  float qf[G][EPL];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    unpack_bf16x8(*reinterpret_cast<const uint4*>(qp + g * D + d0), qf[g]);
    unpack_bf16x8(*reinterpret_cast<const uint4*>(qp + g * D + d0 + 8), qf[g] + 8);
#pragma unroll
    for (int j = 0; j < EPL; ++j) qf[g][j] *= scale;
  }

  float m[G], l[G], acc[G][EPL];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int j = 0; j < EPL; ++j) acc[g][j] = 0.f;
  }

  // cache rows [0, pos); the new token joins at the final merge
  for (int base = 0; base < pos; base += GROUPS * UNROLL) {
    uint4 kr[UNROLL], vr[UNROLL];
    float ksr[UNROLL], vsr[UNROLL];
    bool ok[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int r = base + u * GROUPS + grp;
      ok[u] = r < pos;
      kr[u] = vr[u] = make_uint4(0u, 0u, 0u, 0u);
      ksr[u] = vsr[u] = 0.f;
      if (ok[u]) {
        kr[u] = *reinterpret_cast<const uint4*>(kc + static_cast<long long>(r) * D + d0);
        vr[u] = *reinterpret_cast<const uint4*>(vc + static_cast<long long>(r) * D + d0);
        ksr[u] = ks[r];
        vsr[u] = vs[r];
      }
    }
    float s[UNROLL][G];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      float kf[EPL];
      unpack_i8x16(kr[u], kf);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float x = 0.f;
#pragma unroll
        for (int j = 0; j < EPL; ++j) x = fmaf(qf[g][j], kf[j], x);
#pragma unroll
        for (int off = LPR / 2; off > 0; off >>= 1)
          x += __shfl_xor_sync(0xffffffffu, x, off);
        s[u][g] = ok[u] ? x * ksr[u] : -INFINITY;
      }
    }
    // online softmax per query; p is scaled by the row's value scale
    float p[UNROLL][G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float mnew = m[g];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) mnew = fmaxf(mnew, s[u][g]);
      if (mnew == -INFINITY) {  // no row of this group yet
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) p[u][g] = 0.f;
        continue;
      }
      const float corr = __expf(m[g] - mnew);
      l[g] *= corr;
#pragma unroll
      for (int j = 0; j < EPL; ++j) acc[g][j] *= corr;
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const float e = __expf(s[u][g] - mnew);
        l[g] += e;
        p[u][g] = e * vsr[u];
      }
      m[g] = mnew;
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      float vf[EPL];
      unpack_i8x16(vr[u], vf);
#pragma unroll
      for (int g = 0; g < G; ++g) {
#pragma unroll
        for (int j = 0; j < EPL; ++j) acc[g][j] = fmaf(p[u][g], vf[j], acc[g][j]);
      }
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
      for (int j = 0; j < EPL; ++j) {
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
      for (int j = 0; j < EPL; ++j) sm_acc[warp][g][d0 + j] = acc[g][j];
    }
  }
  __syncthreads();

  // merge across warps, with the new token's exact term: its score is
  // finite, so M is finite
  for (int i = tid; i < G * D; i += THREADS) {
    const int g = i / D, d = i % D;
    const float sn = sm_snew[g];
    float M = sn;
#pragma unroll
    for (int w = 0; w < NUM_WARPS; ++w) M = fmaxf(M, sm_m[w][g]);
    const float pn = __expf(sn - M);
    float L = pn, A = pn * __bfloat162float(vn[d]);
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

// q [B, Hkv*G, D], k_new/v_new [B, Hkv, D] (bf16), caches [B, Hkv, S, D]
// int8, scales [B, Hkv, S] f32 (all contiguous), pos [B] int32 on the
// device, out like q. Built for D = 128, G = 4 (Llama-3-8B); other shapes
// return cudaErrorInvalidValue.
extern "C" int k8s_decode_attn_q8(const void* q, const void* k_new,
                                  const void* v_new, void* k_cache,
                                  void* v_cache, void* k_scale, void* v_scale,
                                  const void* pos, void* out, int B, int Hkv,
                                  int G, int S, int D, float scale,
                                  void* stream) {
  if (D != 128 || G != 4) return static_cast<int>(cudaErrorInvalidValue);
  decode_attn_q8_kernel<128, 4>
      <<<dim3(Hkv, B), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const __nv_bfloat16*>(q),
          static_cast<const __nv_bfloat16*>(k_new),
          static_cast<const __nv_bfloat16*>(v_new),
          static_cast<int8_t*>(k_cache), static_cast<int8_t*>(v_cache),
          static_cast<float*>(k_scale), static_cast<float*>(v_scale),
          static_cast<const int*>(pos), static_cast<__nv_bfloat16*>(out), Hkv,
          S, scale);
  return static_cast<int>(cudaGetLastError());
}
