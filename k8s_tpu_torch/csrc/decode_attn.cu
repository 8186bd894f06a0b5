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
// under the ridge — so the floor is (rows read) * 512 B / 3.35 TB/s
// (PERF.md's K4 byte count: the rows < pos[b] of k and v, plus q, out
// and the new rows).
//
// Design: split-S with a merge, two kernels on one stream.
//
// - decode_attn_split_kernel, grid (ceil(S / C), Hkv, B): block c of
//   (b, h) owns cache rows [c*C, (c+1)*C). One block per (b, h), as
//   before, left the deepest slot's block walking all its rows alone
//   while the card's other SMs idled (64 or 128 blocks on 132 SMs); now
//   that slot's rows are spread over ceil(pos/C) blocks of the same
//   length as everyone else's. C depends on (B, Hkv, S) only (the
//   wrapper's _decode_split_rows), never on pos, so the grid needs no
//   host read of pos. A block of 8 warps serves all G queries of the
//   group, so each cache row is read once for the group, and reads ONLY
//   rows < pos[b]. A row is split over D/8 lanes holding 8 contiguous
//   elements each (one 16-byte load per lane per row, coalesced); the
//   dot products are finished with lane shuffles; each row group keeps
//   its own running max/sum/accumulator (online softmax, 4 rows in
//   flight per iteration), merged with shuffles inside a warp and
//   through shared memory across warps. The block whose range holds
//   pos[b] takes row pos[b] from k_new/v_new (the new token's term) and
//   writes it to the cache; no block reads cache row pos[b], so the
//   append races with nothing. A block that starts past pos[b] writes
//   an empty partial (lse = -inf) and returns. Each block writes its G
//   partial outputs normalised, in f32, with their natural-log lse.
// - decode_attn_merge_kernel, grid (Hkv, B): out = sum_c e^(lse_c - M)
//   O_c / sum_c e^(lse_c - M), M = max_c lse_c, over the splits in
//   ascending order; empty partials are skipped (weight 0, their O_c is
//   never read). The split owning pos[b] is never empty, so M is finite.
//
// The order of every sum is fixed and nothing is atomic: a repeat call
// is bit-identical. pos is read on the device and clamped to
// [0, S - 1], so a bad index cannot write out of bounds. Prefetch: each
// lane already has 4 rows (8 16-byte loads) in flight per iteration,
// and the split loop reads 62-80% of 3.35 TB/s at chip_smoke's shapes
// (PERF.md), so there is no shared-memory ring.

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
decode_attn_split_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k_new,
                         const __nv_bfloat16* __restrict__ v_new,
                         __nv_bfloat16* __restrict__ k_cache,
                         __nv_bfloat16* __restrict__ v_cache,
                         const int* __restrict__ pos_v,
                         float* __restrict__ part_o,
                         float* __restrict__ part_lse, int S, int C,
                         float scale) {
  constexpr int LPR = D / 8;          // lanes per row
  constexpr int RPW = 32 / LPR;       // row groups per warp
  constexpr int GROUPS = NUM_WARPS * RPW;
  __shared__ float sm_m[NUM_WARPS][G];
  __shared__ float sm_l[NUM_WARPS][G];
  __shared__ float sm_acc[NUM_WARPS][G][D];

  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int pos = min(max(pos_v[b], 0), S - 1);
  const long long head = static_cast<long long>(b) * gridDim.y + h;
  const long long split = head * gridDim.x + c;
  float* po = part_o + split * G * D;
  float* pl = part_lse + split * G;
  const int start = c * C;
  if (start > pos) {  // past the last row: an empty partial
    if (tid < G) pl[tid] = -INFINITY;
    return;
  }
  // rows [start, end): cache rows < pos, and row pos (in the owning
  // split only) from k_new / v_new
  const int end = min(start + C, pos + 1);

  const int sub = lane / LPR, li = lane % LPR;
  const int grp = warp * RPW + sub;   // this thread's row group
  const int d0 = li * 8;              // this lane's 8 head-dim elements
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

  for (int base = start; base < end; base += GROUPS * UNROLL) {
    uint4 kr[UNROLL], vr[UNROLL];
    bool ok[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int r = base + u * GROUPS + grp;
      ok[u] = r < end;
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
      const float e = mo == -INFINITY ? 0.f : __expf(mo - mn);
      l[g] = l[g] * a + lo * e;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float ao = __shfl_xor_sync(0xffffffffu, acc[g][j], off);
        acc[g][j] = acc[g][j] * a + ao * e;
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
  // the owning split appends the new row in place
  if (end == pos + 1) {
    for (int i = tid; i < D / 8; i += THREADS) {
      reinterpret_cast<uint4*>(kc + static_cast<long long>(pos) * D)[i] =
          reinterpret_cast<const uint4*>(kn)[i];
      reinterpret_cast<uint4*>(vc + static_cast<long long>(pos) * D)[i] =
          reinterpret_cast<const uint4*>(vn)[i];
    }
  }
  __syncthreads();

  // merge across warps into this split's partial; the split holds at
  // least one row, so M is finite
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
    po[i] = A / L;
    if (d == 0) pl[g] = M + logf(L);
  }
}

// One block per (kv head, batch): G*D/4 threads, each merging 4
// consecutive elements of one query head's output over the splits.
template <int D, int G>
__global__ void __launch_bounds__(G * D / 4)
decode_attn_merge_kernel(const float* __restrict__ part_o,
                         const float* __restrict__ part_lse,
                         __nv_bfloat16* __restrict__ out, int nsplit) {
  const int h = blockIdx.x, b = blockIdx.y;
  const int g = threadIdx.x / (D / 4), d0 = (threadIdx.x % (D / 4)) * 4;
  const long long head = static_cast<long long>(b) * gridDim.x + h;
  const float* pl = part_lse + head * nsplit * G + g;
  const float* po = part_o + head * nsplit * G * D + g * D + d0;
  float M = -INFINITY;
  for (int c = 0; c < nsplit; ++c) M = fmaxf(M, pl[c * G]);
  float L = 0.f, A[4] = {0.f, 0.f, 0.f, 0.f};
  for (int c = 0; c < nsplit; ++c) {
    const float lse = pl[c * G];
    if (lse == -INFINITY) continue;  // an empty split: weight 0
    const float w = __expf(lse - M);
    const float4 o = *reinterpret_cast<const float4*>(po + static_cast<long long>(c) * G * D);
    L += w;
    A[0] = fmaf(w, o.x, A[0]);
    A[1] = fmaf(w, o.y, A[1]);
    A[2] = fmaf(w, o.z, A[2]);
    A[3] = fmaf(w, o.w, A[3]);
  }
  __nv_bfloat162 r[2] = {__floats2bfloat162_rn(A[0] / L, A[1] / L),
                         __floats2bfloat162_rn(A[2] / L, A[3] / L)};
  *reinterpret_cast<uint2*>(out + (head * G + g) * D + d0) =
      *reinterpret_cast<const uint2*>(r);
}

}  // namespace

extern "C" const char* k8s_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q [B, Hkv*G, D], k_new/v_new [B, Hkv, D], caches [B, Hkv, S, D] (all
// bf16, contiguous), pos [B] int32 on the device, out like q; workspace
// part_o [B, Hkv, ceil(S/C), G, D] and part_lse [B, Hkv, ceil(S/C), G]
// f32. C is the split length in rows. Built for D = 128, G = 4
// (Llama-3-8B); other shapes return cudaErrorInvalidValue.
extern "C" int k8s_decode_attn_bf16(const void* q, const void* k_new,
                                    const void* v_new, void* k_cache,
                                    void* v_cache, const void* pos,
                                    void* part_o, void* part_lse, void* out,
                                    int B, int Hkv, int G, int S, int D, int C,
                                    float scale, void* stream) {
  constexpr int kD = 128, kG = 4;
  if (D != kD || G != kG || S <= 0 || C <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || Hkv == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nsplit = (S + C - 1) / C;
  decode_attn_split_kernel<kD, kG><<<dim3(nsplit, Hkv, B), THREADS, 0, st>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k_new),
      static_cast<const __nv_bfloat16*>(v_new),
      static_cast<__nv_bfloat16*>(k_cache),
      static_cast<__nv_bfloat16*>(v_cache), static_cast<const int*>(pos),
      static_cast<float*>(part_o), static_cast<float*>(part_lse), S, C, scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_attn_merge_kernel<kD, kG><<<dim3(Hkv, B), kG * kD / 4, 0, st>>>(
      static_cast<const float*>(part_o), static_cast<const float*>(part_lse),
      static_cast<__nv_bfloat16*>(out), nsplit);
  return static_cast<int>(cudaGetLastError());
}
