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
// (rows read) * 264 B / 3.35 TB/s (PERF.md's K5 byte count: the rows
// < pos[b] with their scales, plus q, out, the new rows and scales).
//
// Design: decode_attn.cu's split-S with a merge, for 1-byte elements.
//
// - decode_attn_q8_split_kernel, grid (ceil(S / C), Hkv, B): block c of
//   (b, h) owns cache rows [c*C, (c+1)*C), so the deepest slot's rows
//   are spread over ceil(pos/C) blocks instead of one block walking
//   them all while the other SMs idle. C comes from (B, Hkv, S) only.
//   A block of 8 warps serves all G queries of the group and reads ONLY
//   rows < pos[b]. A 128-byte int8 row is split over D/16 = 8 lanes
//   holding 16 contiguous elements each (one 16-byte chunk per lane per
//   row, coalesced), so a warp covers 4 rows at a time, 2 per row group
//   and iteration. The scales are applied to the [G]-sized scores and
//   probs, never to the [S, D] cache. Each row group keeps its own
//   running max/sum/accumulator (online softmax), merged with lane
//   shuffles inside a warp and through shared memory across warps. The
//   block whose range holds pos[b] (the owner) also takes the new
//   token's exact bf16 term in that last merge, and its warps 0 and 1
//   quantize k_new / v_new and append them: the amax is a shuffle
//   reduction over the 32 lanes that hold D, the scale amax times the
//   f32 reciprocal of 127 (how XLA compiles the reference's amax / 127),
//   the quotient an IEEE divide (no fast-math flags) and the rounding
//   __float2int_rn (ties to even), so the appended row and scale are
//   bit-identical to the plain version's. No block reads cache row
//   pos[b]. A block that starts past pos[b] writes an empty partial
//   (lse = -inf) and returns; the others write their G partial outputs
//   normalised, in f32, with their natural-log lse.
// - decode_attn_q8_merge_kernel, grid (Hkv, B): the splits' partials
//   merged in ascending order by their lse, empty ones skipped, as in
//   decode_attn.cu.
//
// Prefetch: each thread streams its own rows' 16-byte chunks and scales
// through STAGES slots of a shared-memory ring by cp.async, STAGES - 1
// iterations ahead of the one it computes on, without holding them in
// registers (the kernel already needs ~220: one block per SM). The
// split loop without the ring stayed well under 60% of 3.35 TB/s; with
// it the loop is bound by instruction issue (two 16-value
// dequantizations, 128 FMAs and the shuffles per lane and row), not by
// memory: a deeper ring, twice the occupancy (8 values per lane, 2
// blocks per SM) and an exact byte-permute dequantization did not help
// (PERF.md).
//
// The order of every sum is fixed and nothing is atomic: a repeat call
// is bit-identical. pos is read on the device and clamped to [0, S - 1].

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int NUM_WARPS = THREADS / 32;
constexpr int UNROLL = 2;  // rows per row group per iteration
// iterations of rows each thread keeps in flight through its ring slots
constexpr int STAGES = 3;
// the ring: [STAGES][UNROLL][k, v][THREADS] 16-byte row chunks, then as
// many f32 scales (each lane keeps its row's, as it would in registers)
constexpr int RING_BYTES = STAGES * UNROLL * 2 * THREADS * (16 + 4);

// 16 (or 4) bytes global -> shared, asynchronous; with ok false nothing
// is read and the destination is zero-filled
__device__ __forceinline__ void cp_async16(uint4* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::
                   "r"(static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::
                   "r"(static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's newest copy groups are pending
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

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
decode_attn_q8_split_kernel(const __nv_bfloat16* __restrict__ q,
                            const __nv_bfloat16* __restrict__ k_new,
                            const __nv_bfloat16* __restrict__ v_new,
                            int8_t* __restrict__ k_cache,
                            int8_t* __restrict__ v_cache,
                            float* __restrict__ k_scale,
                            float* __restrict__ v_scale,
                            const int* __restrict__ pos_v,
                            float* __restrict__ part_o,
                            float* __restrict__ part_lse, int S, int C,
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
  extern __shared__ uint4 ring_kv[];  // RING_BYTES, see above
  float* ring_sc = reinterpret_cast<float*>(ring_kv + STAGES * UNROLL * 2 * THREADS);

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
  // cache rows [start, end); the owner also takes the new token
  const int end = min(start + C, pos);
  const bool owner = pos < start + C;

  const int sub = lane / LPR, li = lane % LPR;
  const int grp = warp * RPW + sub;   // this thread's row group
  const int d0 = li * EPL;            // this lane's 16 head-dim elements
  int8_t* kc = k_cache + head * S * D;
  int8_t* vc = v_cache + head * S * D;
  float* ks = k_scale + head * S;
  float* vs = v_scale + head * S;
  const __nv_bfloat16* kn = k_new + head * D;
  const __nv_bfloat16* vn = v_new + head * D;
  const __nv_bfloat16* qp = q + head * G * D;  // q heads h*G .. h*G+G-1

  // the new row: warp 0 of the owner quantizes k_new (and takes the new
  // token's scores), warp 1 v_new; both append at row pos, which no
  // thread reads
  if (owner && warp < 2) {
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

  // Each thread streams the 16-byte chunks (and scales) of its own rows
  // through its own ring slots, STAGES - 1 iterations ahead of the one
  // it computes on; it reads back only what it copied, so no barrier.
  // The slot refilled at iteration it was read at it - 1, before this
  // iteration's copies were issued. The new token joins at the final
  // merge.
  constexpr int ROWS_PER_ITER = GROUPS * UNROLL;
  const int n_iter = (end - start + ROWS_PER_ITER - 1) / ROWS_PER_ITER;
  auto slot = [tid](int stage, int u, int kv) {
    return ((stage * UNROLL + u) * 2 + kv) * THREADS + tid;
  };
  auto issue = [&](int it) {
    if (it < n_iter) {
      const int stage = it % STAGES;
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int r = start + it * ROWS_PER_ITER + u * GROUPS + grp;
        const bool ok = r < end;
        const long long row = ok ? r : start;  // a valid address, not read
        cp_async16(ring_kv + slot(stage, u, 0), kc + row * D + d0, ok);
        cp_async16(ring_kv + slot(stage, u, 1), vc + row * D + d0, ok);
        cp_async4(ring_sc + slot(stage, u, 0), ks + row, ok);
        cp_async4(ring_sc + slot(stage, u, 1), vs + row, ok);
      }
    }
    cp_async_commit();  // empty past the last iteration: keeps the count
  };
#pragma unroll
  for (int it = 0; it < STAGES - 1; ++it) issue(it);
  for (int it = 0; it < n_iter; ++it) {
    issue(it + STAGES - 1);
    cp_async_wait<STAGES - 1>();  // iteration it's copies have landed
    const int stage = it % STAGES;
    uint4 kr[UNROLL], vr[UNROLL];
    float ksr[UNROLL], vsr[UNROLL];
    bool ok[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      ok[u] = start + it * ROWS_PER_ITER + u * GROUPS + grp < end;
      kr[u] = ring_kv[slot(stage, u, 0)];
      vr[u] = ring_kv[slot(stage, u, 1)];
      ksr[u] = ring_sc[slot(stage, u, 0)];
      vsr[u] = ring_sc[slot(stage, u, 1)];
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
  cp_async_wait<0>();

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
      for (int j = 0; j < EPL; ++j) {
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
      for (int j = 0; j < EPL; ++j) sm_acc[warp][g][d0 + j] = acc[g][j];
    }
  }
  __syncthreads();

  // merge across warps into this split's partial, with the new token's
  // exact term in the owner: a split holds a cache row or the new token,
  // so M is finite
  for (int i = tid; i < G * D; i += THREADS) {
    const int g = i / D, d = i % D;
    float M = -INFINITY, L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < NUM_WARPS; ++w) M = fmaxf(M, sm_m[w][g]);
    if (owner) {
      const float sn = sm_snew[g];
      M = fmaxf(M, sn);
      L = __expf(sn - M);
      A = L * __bfloat162float(vn[d]);
    }
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
// consecutive elements of one query head's output over the splits in
// ascending order (decode_attn.cu's merge).
template <int D, int G>
__global__ void __launch_bounds__(G * D / 4)
decode_attn_q8_merge_kernel(const float* __restrict__ part_o,
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

// q [B, Hkv*G, D], k_new/v_new [B, Hkv, D] (bf16), caches [B, Hkv, S, D]
// int8, scales [B, Hkv, S] f32 (all contiguous), pos [B] int32 on the
// device, out like q; workspace part_o [B, Hkv, ceil(S/C), G, D] and
// part_lse [B, Hkv, ceil(S/C), G] f32. C is the split length in rows.
// Built for D = 128, G = 4 (Llama-3-8B); other shapes return
// cudaErrorInvalidValue.
extern "C" int k8s_decode_attn_q8(const void* q, const void* k_new,
                                  const void* v_new, void* k_cache,
                                  void* v_cache, void* k_scale, void* v_scale,
                                  const void* pos, void* part_o,
                                  void* part_lse, void* out, int B, int Hkv,
                                  int G, int S, int D, int C, float scale,
                                  void* stream) {
  constexpr int kD = 128, kG = 4;
  if (D != kD || G != kG || S <= 0 || C <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || Hkv == 0) return 0;
  static std::atomic<bool> smem_set[hopper::MAX_DEVICES];
  const cudaError_t attr = hopper::set_smem_limit_once(
      decode_attn_q8_split_kernel<kD, kG>, RING_BYTES, smem_set);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nsplit = (S + C - 1) / C;
  decode_attn_q8_split_kernel<kD, kG>
      <<<dim3(nsplit, Hkv, B), THREADS, RING_BYTES, st>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k_new),
      static_cast<const __nv_bfloat16*>(v_new),
      static_cast<int8_t*>(k_cache), static_cast<int8_t*>(v_cache),
      static_cast<float*>(k_scale), static_cast<float*>(v_scale),
      static_cast<const int*>(pos), static_cast<float*>(part_o),
      static_cast<float*>(part_lse), S, C, scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_attn_q8_merge_kernel<kD, kG><<<dim3(Hkv, B), kG * kD / 4, 0, st>>>(
      static_cast<const float*>(part_o), static_cast<const float*>(part_lse),
      static_cast<__nv_bfloat16*>(out), nsplit);
  return static_cast<int>(cudaGetLastError());
}
