// Short-sequence multi-head attention over the [B, T, D] layout, for Hopper
// (sm_90a). Forward only.
//
// Replaces: multimodal_content_moderation_tpu/ops/pallas_attention.py,
//   attention_nhd (body _nhd_body).
//
// Computes, for every batch row b and head h (dh = D / H):
//   s[t, j] = (q[b, t, h*dh:(h+1)*dh] . k[b, j, h*dh:(h+1)*dh]) * dh^-0.5
//   s += key_mask[b, j]                (additive fp32, when given)
//   s = (j <= t) ? s : -FLT_MAX        (when causal)
//   p = softmax_j(s) in fp32 (max-subtracted, then normalised)
//   out[b, t, h*dh + d] = sum_j p[t, j] * v[b, j, h*dh + d], in q's type.
// The masked value is -FLT_MAX, not -inf, exactly as the TPU kernel: a row
// whose keys are all masked therefore gets a uniform average, not NaN.
//
// Bound on an H100: at the main path (B=144; vision T=50, D=768, 12 heads;
// text T=77, D=512, 8 heads) one call reads q, k, v and writes the output:
// about 44 MB in bf16, 13 us at 3.35 TB/s, against 4*B*T*T*D = 1.1 GFLOP of
// products. The kernel is bound by bytes.
//
// Design: one block per (query tile of 32 rows, head, batch row). The
// block loads its head's K and V slices [S, dh] straight from the [B, S, D]
// layout (a head-offset strided read, no transpose anywhere) into shared
// memory as fp32; K rows are padded to dh+1 floats so the per-key dot
// products of a warp hit distinct banks. Each of the 4 warps owns query
// rows: the lanes split the S keys, keep the row's scores in shared memory,
// and do max -> exp -> sum -> normalise -> .V in fp32. Shared memory is
// dynamic (up to ~139 KB at S=256, dh=64), raised past 48 KB with
// cudaFuncSetAttribute.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int QTILE = 32;      // query rows per block
constexpr int MAX_DH = 128;    // per-lane accumulators: MAX_DH / 32
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
attention_nhd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const float* __restrict__ key_mask,
                     T* __restrict__ out, int Tq, int S, int D, int dh, int causal,
                     float scale) {
  extern __shared__ float smem[];
  const int kstride = dh + 1;
  float* Ks = smem;                        // [S, dh+1]
  float* Vs = Ks + S * kstride;            // [S, dh]
  float* Ms = Vs + S * dh;                 // [S] key mask
  float* Ps = Ms + S;                      // [WARPS, S] scores / probabilities
  float* Qs = Ps + WARPS * S;              // [WARPS, dh] query row

  const int tile = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  const size_t kv_base = (size_t)b * S * D + (size_t)h * dh;
  for (int idx = tid; idx < S * dh; idx += THREADS) {
    const int j = idx / dh;
    const int d = idx - j * dh;
    const size_t g = kv_base + (size_t)j * D + d;
    Ks[j * kstride + d] = to_f(k[g]);
    Vs[j * dh + d] = to_f(v[g]);
  }
  for (int j = tid; j < S; j += THREADS)
    Ms[j] = key_mask != nullptr ? key_mask[(size_t)b * S + j] : 0.f;
  __syncthreads();

  float* p = Ps + warp * S;
  float* qrow = Qs + warp * dh;
  const int t_end = min(Tq, (tile + 1) * QTILE);
  for (int t = tile * QTILE + warp; t < t_end; t += WARPS) {
    const size_t q_off = ((size_t)b * Tq + t) * D + (size_t)h * dh;
    for (int d = lane; d < dh; d += 32) qrow[d] = to_f(q[q_off + d]);
    __syncwarp();

    float m = NEG_INF;
    for (int j = lane; j < S; j += 32) {
      const float* kr = Ks + j * kstride;
      float acc = 0.f;
      for (int d = 0; d < dh; ++d) acc = fmaf(qrow[d], kr[d], acc);
      float s = __fmul_rn(acc, scale) + Ms[j];  // scale after the dot, no FMA contraction
      if (causal && j > t) s = NEG_INF;
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
    const float inv = 1.f / l;
    for (int j = lane; j < S; j += 32) p[j] = p[j] * inv;
    __syncwarp();

    float o[MAX_DH / 32];
#pragma unroll
    for (int c = 0; c < MAX_DH / 32; ++c) o[c] = 0.f;
    for (int j = 0; j < S; ++j) {
      const float pj = p[j];
      const float* vr = Vs + j * dh;
#pragma unroll
      for (int c = 0; c < MAX_DH / 32; ++c) {
        const int d = lane + 32 * c;
        if (d < dh) o[c] = fmaf(pj, vr[d], o[c]);
      }
    }
#pragma unroll
    for (int c = 0; c < MAX_DH / 32; ++c) {
      const int d = lane + 32 * c;
      if (d < dh) store_out(out + q_off + d, o[c]);
    }
    __syncwarp();  // qrow and p are rewritten by this warp's next row
  }
}

size_t smem_bytes(int S, int dh) {
  return sizeof(float) *
         ((size_t)S * (dh + 1) + (size_t)S * dh + S + (size_t)WARPS * S + (size_t)WARPS * dh);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const float* key_mask, void* out,
           int B, int Tq, int S, int H, int dh, int causal, float scale,
           cudaStream_t stream) {
  const size_t bytes = smem_bytes(S, dh);
  if (bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(attention_nhd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  dim3 grid((Tq + QTILE - 1) / QTILE, H, B);
  attention_nhd_kernel<T><<<grid, THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), key_mask,
      static_cast<T*>(out), Tq, S, H * dh, dh, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// is_bf16: 0 -> q, k, v, out are float*; 1 -> __nv_bfloat16*.
// key_mask: fp32 [B, S] or null. scale: dh^-0.5, computed by the caller.
// Returns cudaGetLastError() after the launch,
// or the error of raising the kernel's shared-memory limit.
extern "C" int attention_nhd_launch(const void* q, const void* k, const void* v,
                                    const void* key_mask, void* out, int B, int Tq, int S,
                                    int H, int dh, int causal, float scale, int is_bf16,
                                    void* stream) {
  if (dh > MAX_DH) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* km = static_cast<const float*>(key_mask);
  if (is_bf16) return launch<__nv_bfloat16>(q, k, v, km, out, B, Tq, S, H, dh, causal, scale, s);
  return launch<float>(q, k, v, km, out, B, Tq, S, H, dh, causal, scale, s);
}

extern "C" const char* attention_nhd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
