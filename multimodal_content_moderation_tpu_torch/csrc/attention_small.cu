// Whole-tile attention with an optional dense additive mask over
// [BH, T, dh], for Hopper (sm_90a). Forward only, as the TPU kernel.
//
// Replaces: multimodal_content_moderation_tpu/ops/pallas_attention.py,
//   attention_small (body _small_body), the short-sequence path of fused_mha.
//
// Computes, for every (batch * head) slice i and query row t, over the keys
// j < S, in fp32, in the TPU kernel's order:
//   s = (q[i,t,:] . k[i,j,:]) * dh^-0.5 + mask[i,t,j]   (mask when given)
//   p = exp(s - max_j s) / sum_j exp(s - max_j s)
//   out[i,t,:] = sum_j p[j] v[i,j,:], written in q's type.
// The mask carries every masking source: the caller (fused_mha) folds a
// causal flag and a key-padding row into it first. A row whose entries are
// all -FLT_MAX averages its keys; a row of -inf entries gives NaN, as the TPU
// kernel's max-subtraction does.
//
// Bound on an H100: the dense mask dominates the bytes. At a CLIP text tower
// shape with a dense mask (B=64, 8 heads, T=77, dh=64, bf16) one call reads
// q, k, v (3 x 5.0 MB) and the fp32 mask (12.1 MB) and writes 5.0 MB, 32 MB
// in all (9.6 us at 3.35 TB/s), against 4 BH T S dh = 0.78 GFLOP (0.8 us at
// the bf16 tensor-core rate): bound by bytes.
//
// Design (simple and right): one block of 256 threads per slice i. The
// slice's keys sit in shared memory as fp32 rows padded to dh+1 floats (a
// warp's per-key dot products hit distinct banks); v is read from global
// memory (cached: every warp of the block reads the same rows), one
// coalesced row per key, so shared
// memory stays within the card's limit for every T <= 256 and dh <= 128
// (at most 144 KB). Each of the 8 warps owns query rows in turn: the lanes
// split the keys, keep the row's scores in shared memory, add the mask row
// (read once, coalesced), and do max -> exp -> sum -> divide -> .V in fp32.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int MAX_DH = 128;  // per-lane accumulators: MAX_DH / 32
constexpr float NEG_INF = -3.4028235e38f;

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
                       T* __restrict__ out, int Tq, int S, int dh, float scale) {
  extern __shared__ float smem[];
  const int kstride = dh + 1;
  float* Ks = smem;                   // [S, dh+1]
  float* Ps = Ks + S * kstride;       // [WARPS, S] scores / probabilities
  float* Qs = Ps + WARPS * S;         // [WARPS, dh] query row

  const size_t i = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  const T* kb = k + i * S * dh;
  const T* vb = v + i * S * dh;
  for (int idx = tid; idx < S * dh; idx += THREADS) {
    const int j = idx / dh;
    Ks[j * kstride + (idx - j * dh)] = to_f(kb[idx]);
  }
  __syncthreads();

  float* p = Ps + warp * S;
  float* qrow = Qs + warp * dh;
  for (int t = warp; t < Tq; t += WARPS) {
    const size_t row = i * Tq + t;
    for (int d = lane; d < dh; d += 32) qrow[d] = to_f(q[row * dh + d]);
    __syncwarp();

    const float* mrow = mask != nullptr ? mask + row * S : nullptr;
    float m = NEG_INF;
    for (int j = lane; j < S; j += 32) {
      const float* kr = Ks + j * kstride;
      float acc = 0.f;
      for (int d = 0; d < dh; ++d) acc = fmaf(qrow[d], kr[d], acc);
      float s = __fmul_rn(acc, scale);  // scale after the dot, no FMA contraction
      if (mrow != nullptr) s = s + mrow[j];
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
      const T* vr = vb + (size_t)j * dh;
#pragma unroll
      for (int c = 0; c < MAX_DH / 32; ++c) {
        const int d = lane + 32 * c;
        if (d < dh) o[c] = fmaf(pj, to_f(vr[d]), o[c]);
      }
    }
#pragma unroll
    for (int c = 0; c < MAX_DH / 32; ++c) {
      const int d = lane + 32 * c;
      if (d < dh) store_out(out + row * dh + d, o[c]);
    }
    __syncwarp();  // qrow and p are rewritten by this warp's next row
  }
}

size_t smem_bytes(int S, int dh) {
  return sizeof(float) * ((size_t)S * (dh + 1) + (size_t)WARPS * S + (size_t)WARPS * dh);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const float* mask, void* out,
           int BH, int Tq, int S, int dh, float scale, cudaStream_t stream) {
  const size_t bytes = smem_bytes(S, dh);
  if (bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(attention_small_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  attention_small_kernel<T><<<BH, THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), mask,
      static_cast<T*>(out), Tq, S, dh, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// is_bf16: 0 -> q, k, v, out are float*; 1 -> __nv_bfloat16*. q, out:
// [BH, Tq, dh]; k, v: [BH, S, dh]; mask: fp32 [BH, Tq, S] or null; all
// contiguous. scale: dh^-0.5, computed by the caller. Returns
// cudaGetLastError() after the launch, or the error of raising the kernel's
// shared-memory limit.
extern "C" int attention_small_launch(const void* q, const void* k, const void* v,
                                      const void* mask, void* out, int BH, int Tq, int S,
                                      int dh, float scale, int is_bf16, void* stream) {
  if (dh > MAX_DH || dh < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* m = static_cast<const float*>(mask);
  if (is_bf16) return launch<__nv_bfloat16>(q, k, v, m, out, BH, Tq, S, dh, scale, s);
  return launch<float>(q, k, v, m, out, BH, Tq, S, dh, scale, s);
}

extern "C" const char* attention_small_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
