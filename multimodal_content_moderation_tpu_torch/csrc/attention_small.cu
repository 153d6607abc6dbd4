// Whole-tile attention with an optional dense additive mask over strided
// [B, H, T, dh] views, for Hopper (sm_90a). Forward only, as the TPU kernel.
// Two kernels: a bf16 one on the tensor cores (attention_small_mma_launch),
// and an fp32 SIMT one (attention_small_launch) for fp32 inputs, the parity
// path.
//
// Replaces: multimodal_content_moderation_tpu/ops/pallas_attention.py,
//   attention_small (body _small_body), the short-sequence path of fused_mha.
//
// Computes, for every batch row b, head h and query row t < Tq, over the keys
// j < S, in fp32, in the TPU kernel's order:
//   s = (q[b,h,t,:] . k[b,h,j,:]) * dh^-0.5 + mask[b,h,t,j]   (mask when given)
//   p = exp(s - max_j s) / sum_j exp(s - max_j s)
//   out[b,h,t,:] = sum_j p[j] v[b,h,j,:], written in q's type.
// The mask carries every masking source: the caller (fused_mha) folds a
// causal flag and a key-padding row into it first. A row whose entries are
// all -FLT_MAX averages its keys; a row of -inf entries gives NaN, as the TPU
// kernel's max-subtraction does. The JAX contract's [B*H, T, dh] arrays are
// the case B = 1.
//
// Strides: q, k, v and out are addressed by element strides for (b, h, t)
// with a contiguous last axis, so the caller passes the projections' [B, T, D]
// memory viewed as [B, H, T, dh] without a copy; the mask takes strides for
// (b, h, t, j), where a stride of 0 broadcasts (a [B, 1, T, S] mask is read
// with a head stride of 0, never expanded).
//
// Bound on an H100: bytes. At a CLIP text tower shape with a dense mask
// (B=64, 8 heads, T=77, dh=64, bf16) the kernel reads q, k, v (3 x 5.0 MB)
// and the [B, 1, T, S] fp32 mask as fused_mha passes it (1.5 MB, read once
// per batch row through a head stride of 0) and writes 5.0 MB, 21.7 MB in
// all (6.5 us at 3.35 TB/s), against 4 BH T S dh = 0.78 GFLOP (0.8 us at the
// bf16 tensor-core rate). The JAX cost estimate counts an expanded
// [B*H, T, S] mask instead (12.1 MB, 32.3 MB in all, 9.6 us); chip_smoke.py
// reports it beside the bound as jax_estimate_ms.
//
// bf16 design (tensor cores, attention_mma.cuh): a grid of (slice b*H + h,
// 64-query tile), 4 warps of 16 query rows each, Q fragments in registers.
// The slice's K and V are staged whole in shared memory as bf16 (16-byte
// cp.async where the rows allow it, element loads otherwise), zero-padded to
// a multiple of 64 keys, one cp.async group per 64-key chunk so the first
// chunk is multiplied while the rest land: 36 KB at S = 77, dh = 64, at most
// 136 KB at S = 256, dh = 128. S = Q K^T and O += P V run on mma.sync
// m16n8k16 with fp32 accumulation over the chunks with an online softmax in
// registers, P split into bf16 hi + lo (no score goes through shared memory).
// The mask is added in the fragment layout, each thread reading its own
// (t, j) entries, after the scale: s = (q.k) * scale + mask. Without a mask a
// chunk of real keys for 16 real rows takes the scale alone.
//
// fp32 design (SIMT, the parity path): one block of 256 threads per slice.
// The slice's keys sit in shared memory as fp32 rows padded to dh+1 floats
// (a warp's per-key dot products hit distinct banks); v is read from global
// memory (cached: every warp of the block reads the same rows), one
// coalesced row per key, so shared memory stays within the card's limit for
// every T <= 256 and dh <= 128 (at most 144 KB). Each of the 8 warps owns
// query rows in turn: the lanes split the keys, keep the row's scores in
// shared memory, add the mask row, and do max -> exp -> sum -> divide -> .V
// in fp32. It is templated on the element type; the bf16 instance is
// reachable only through attention_small_launch with is_bf16 = 1, which the
// port's wrapper never asks for (chip_smoke.py times it as the earlier
// design).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

#include "attention_mma.cuh"

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int MAX_DH = 128;  // per-lane accumulators: MAX_DH / 32
constexpr float NEG_INF = -3.4028235e38f;

struct Strides {
  long long q[3], k[3], v[3], o[3];  // (b, h, t); the last axis is contiguous
  long long mask[4];                 // (b, h, t, j)
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
attention_small_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const float* __restrict__ mask,
                       T* __restrict__ out, int H, int Tq, int S, int dh, float scale,
                       Strides st) {
  extern __shared__ float smem[];
  const int kstride = dh + 1;
  float* Ks = smem;                   // [S, dh+1]
  float* Ps = Ks + S * kstride;       // [WARPS, S] scores / probabilities
  float* Qs = Ps + WARPS * S;         // [WARPS, dh] query row

  const int b = blockIdx.x / H;
  const int h = blockIdx.x - b * H;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  const T* qb = q + b * st.q[0] + h * st.q[1];
  const T* kb = k + b * st.k[0] + h * st.k[1];
  const T* vb = v + b * st.v[0] + h * st.v[1];
  T* ob = out + b * st.o[0] + h * st.o[1];
  const float* mb = mask != nullptr ? mask + b * st.mask[0] + h * st.mask[1] : nullptr;

  for (int idx = tid; idx < S * dh; idx += THREADS) {
    const int j = idx / dh;
    const int d = idx - j * dh;
    Ks[j * kstride + d] = to_f(kb[j * st.k[2] + d]);
  }
  __syncthreads();

  float* p = Ps + warp * S;
  float* qrow = Qs + warp * dh;
  for (int t = warp; t < Tq; t += WARPS) {
    for (int d = lane; d < dh; d += 32) qrow[d] = to_f(qb[t * st.q[2] + d]);
    __syncwarp();

    const float* mrow = mb != nullptr ? mb + t * st.mask[2] : nullptr;
    float m = NEG_INF;
    for (int j = lane; j < S; j += 32) {
      const float* kr = Ks + j * kstride;
      float acc = 0.f;
      for (int d = 0; d < dh; ++d) acc = fmaf(qrow[d], kr[d], acc);
      float s = __fmul_rn(acc, scale);  // scale after the dot, no FMA contraction
      if (mrow != nullptr) s = s + mrow[j * st.mask[3]];
      p[j] = s;
      m = fmaxf(m, s);
    }
    m = warp_max(m);

    float l = 0.f;
    for (int j = lane; j < S; j += 32) {
      const float e = expf(p[j] - m);
      p[j] = e;
      l += e;
    }
    l = warp_sum(l);
    for (int j = lane; j < S; j += 32) p[j] = p[j] / l;
    __syncwarp();

    float o[MAX_DH / 32];
#pragma unroll
    for (int c = 0; c < MAX_DH / 32; ++c) o[c] = 0.f;
    for (int j = 0; j < S; ++j) {
      const float pj = p[j];
      const T* vr = vb + j * st.v[2];
#pragma unroll
      for (int c = 0; c < MAX_DH / 32; ++c) {
        const int d = lane + 32 * c;
        if (d < dh) o[c] = fmaf(pj, to_f(vr[d]), o[c]);
      }
    }
#pragma unroll
    for (int c = 0; c < MAX_DH / 32; ++c) {
      const int d = lane + 32 * c;
      if (d < dh) store_out(ob + t * st.o[2] + d, o[c]);
    }
    __syncwarp();  // qrow and p are rewritten by this warp's next row
  }
}

size_t smem_bytes(int S, int dh) {
  return sizeof(float) * ((size_t)S * (dh + 1) + (size_t)WARPS * S + (size_t)WARPS * dh);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const float* mask, void* out, int B,
           int H, int Tq, int S, int dh, float scale, const Strides& st, cudaStream_t stream) {
  const size_t bytes = smem_bytes(S, dh);
  if (bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(attention_small_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  attention_small_kernel<T><<<B * H, THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), mask,
      static_cast<T*>(out), H, Tq, S, dh, scale, st);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------

namespace am = attention_mma;
constexpr int MMA_WARPS = 4;            // warps of 16 query rows
constexpr int MMA_BQ = MMA_WARPS * 16;  // query rows per block
using bf16 = __nv_bfloat16;

// The score of the warp's row r and key j from the raw dot, in the TPU
// kernel's order: the scale after the dot, then the mask; a key past S or a
// row past Tq scores -inf (weighs 0, and the row is not stored)
struct SmallScore {
  const float* mb;   // this (b, h)'s mask or null
  long long mt, mj;  // its (t, j) strides
  int t0, Tq, S;
  float scale;
  __device__ __forceinline__ float operator()(float acc, int r, int j) const {
    const int t = t0 + r;
    if (t >= Tq || j >= S) return -INFINITY;
    const float s = __fmul_rn(acc, scale);  // scale after the dot, no FMA contraction
    return mb != nullptr ? s + mb[t * mt + j * mj] : s;
  }
};

// waits until at most n of this thread's cp.async groups are in flight
__device__ __forceinline__ void wait_groups(int n) {
  switch (n) {
    case 0: am::cp_async_wait<0>(); break;
    case 1: am::cp_async_wait<1>(); break;
    case 2: am::cp_async_wait<2>(); break;
    default: am::cp_async_wait<3>(); break;
  }
}

template <int DHP>
__global__ void __launch_bounds__(MMA_WARPS * 32)
attention_small_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                           const bf16* __restrict__ v, const float* __restrict__ mask,
                           bf16* __restrict__ out, int H, int Tq, int S, int dh, float scale,
                           Strides st, int vec, int pairs) {
  constexpr int STR = am::row_stride(DHP);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int chunks = (S + am::CHUNK - 1) / am::CHUNK;  // <= 4: S <= 256
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);      // [chunks * 64][DHP + 8]
  bf16* Vs = Ks + chunks * am::CHUNK * STR;          // [chunks * 64][DHP + 8]

  const int b = blockIdx.x / H;
  const int h = blockIdx.x - b * H;
  const int warp = threadIdx.x / 32;
  const int g = (threadIdx.x & 31) >> 2;
  const int t0 = blockIdx.y * MMA_BQ + warp * 16;  // the warp's first row

  const bf16* qb = q + b * st.q[0] + h * st.q[1];
  const bf16* kb = k + b * st.k[0] + h * st.k[1];
  const bf16* vb = v + b * st.v[0] + h * st.v[1];
  bf16* ob = out + b * st.o[0] + h * st.o[1];

  // the slice's K and V, one cp.async group per 64-key chunk, so that the
  // first chunk is multiplied while the others load
  for (int c = 0; c < chunks; ++c) {
    const int j0 = c * am::CHUNK;
    am::stage_rows<DHP>(Ks + j0 * STR, kb, st.k[2], j0, am::CHUNK, S, dh, vec);
    am::stage_rows<DHP>(Vs + j0 * STR, vb, st.v[2], j0, am::CHUNK, S, dh, vec);
    am::cp_async_commit();
  }

  am::WarpRows<DHP> w;
  w.start(t0 + g < Tq ? qb + (t0 + g) * st.q[2] : nullptr,
          t0 + g + 8 < Tq ? qb + (t0 + g + 8) * st.q[2] : nullptr, dh, pairs);
  const SmallScore score{mask != nullptr ? mask + b * st.mask[0] + h * st.mask[1] : nullptr,
                         st.mask[2], st.mask[3], t0, Tq, S, scale};
  // no mask and all 16 rows real: a chunk of real keys needs only the scale
  const bool unmasked = mask == nullptr && t0 + 16 <= Tq;
  for (int c = 0; c < chunks; ++c) {
    const int k0 = c * am::CHUNK;
    wait_groups(chunks - 1 - c);  // chunk c has landed ...
    __syncthreads();              // ... for every thread's copies
    if (t0 >= Tq) continue;       // a warp past the last row (warp-uniform)
    if (unmasked && k0 + am::CHUNK <= S)
      w.attend(Ks + k0 * STR, Vs + k0 * STR, k0, am::ScaleOnly{scale});
    else
      w.attend(Ks + k0 * STR, Vs + k0 * STR, k0, score);
  }
  if (t0 >= Tq) return;
  w.finish(t0 + g < Tq ? ob + (t0 + g) * st.o[2] : nullptr,
           t0 + g + 8 < Tq ? ob + (t0 + g + 8) * st.o[2] : nullptr, dh, pairs);
}

size_t mma_smem_bytes(int S, int dhp) {
  const size_t sp = (S + am::CHUNK - 1) / am::CHUNK * am::CHUNK;
  return sizeof(bf16) * 2 * sp * am::row_stride(dhp);
}

template <int DHP>
int launch_mma(const void* q, const void* k, const void* v, const float* mask, void* out,
               int B, int H, int Tq, int S, int dh, float scale, const Strides& st, int vec,
               int pairs, cudaStream_t stream) {
  const size_t bytes = mma_smem_bytes(S, DHP);
  if (bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(attention_small_mma_kernel<DHP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  dim3 grid(B * H, (Tq + MMA_BQ - 1) / MMA_BQ);
  attention_small_mma_kernel<DHP><<<grid, MMA_WARPS * 32, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      mask, static_cast<bf16*>(out), H, Tq, S, dh, scale, st, vec, pairs);
  return static_cast<int>(cudaGetLastError());
}

Strides unpack(const long long* strides) {
  Strides st;
  long long* dst[5] = {st.q, st.k, st.v, st.o, st.mask};
  const int len[5] = {3, 3, 3, 3, 4};
  int n = 0;
  for (int a = 0; a < 5; ++a)
    for (int i = 0; i < len[a]; ++i) dst[a][i] = strides[n++];
  return st;
}

}  // namespace

// bf16 q, k, v and out on the tensor cores; the other arguments as
// attention_small_launch's below. K and V rows are copied 16 bytes at a time
// where k, v are 16-byte aligned with strides and dh multiples of 8
// elements; q and out are read and written in pairs where they are 4-byte
// aligned with even strides and dh.
extern "C" int attention_small_mma_launch(const void* q, const void* k, const void* v,
                                          const void* mask, void* out, int B, int H, int Tq,
                                          int S, int dh, float scale, const long long* strides,
                                          void* stream) {
  if (dh > MAX_DH || dh < 1 || S < 1 || S > 4 * am::CHUNK)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides st = unpack(strides);
  auto mult = [](const void* p, const long long* s, int n) {
    bool ok = reinterpret_cast<uintptr_t>(p) % (2 * n) == 0;
    for (int i = 0; i < 3; ++i) ok = ok && s[i] % n == 0;
    return ok;
  };
  const int vec = dh % 8 == 0 && mult(k, st.k, 8) && mult(v, st.v, 8);
  const int pairs = dh % 2 == 0 && mult(q, st.q, 2) && mult(out, st.o, 2);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* m = static_cast<const float*>(mask);
  const int dhp = am::padded_width(dh);
  const auto run = dhp == 16 ? launch_mma<16> : dhp == 32 ? launch_mma<32>
                 : dhp == 64 ? launch_mma<64> : launch_mma<128>;
  return run(q, k, v, m, out, B, H, Tq, S, dh, scale, st, vec, pairs, s);
}

// is_bf16: 0 -> q, k, v, out are float*; 1 -> __nv_bfloat16*. q, out:
// [B, H, Tq, dh]; k, v: [B, H, S, dh]; mask: fp32 broadcast to
// [B, H, Tq, S] by its strides, or null. strides: 16 element strides on the
// host, in the order q (b, h, t), k, v, out (b, h, t), mask (b, h, t, j).
// scale: dh^-0.5, computed by the caller. Returns cudaGetLastError() after
// the launch, or the error of raising the kernel's shared-memory limit.
extern "C" int attention_small_launch(const void* q, const void* k, const void* v,
                                      const void* mask, void* out, int B, int H, int Tq, int S,
                                      int dh, float scale, const long long* strides,
                                      int is_bf16, void* stream) {
  if (dh > MAX_DH || dh < 1) return static_cast<int>(cudaErrorInvalidValue);
  const Strides st = unpack(strides);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* m = static_cast<const float*>(mask);
  if (is_bf16) return launch<__nv_bfloat16>(q, k, v, m, out, B, H, Tq, S, dh, scale, st, s);
  return launch<float>(q, k, v, m, out, B, H, Tq, S, dh, scale, st, s);
}

extern "C" const char* attention_small_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
