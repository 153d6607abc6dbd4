// Short-sequence multi-head attention over the [B, T, D] layout, for Hopper
// (sm_90a). Forward only. Two kernels: a bf16 one on the tensor cores
// (attention_nhd_mma_launch), and an fp32 SIMT one (attention_nhd_launch)
// for fp32 inputs, the parity path.
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
// bf16 design (tensor cores, attention_mma.cuh): one block per (head, batch
// row) with ceil(T / 16) warps (up to 16 at T = 256; up to 8 at dh > 64,
// where a warp then takes two groups of 16 rows). The block stages the
// head's K and V once, as bf16, straight from the [B, S, D] layout (16-byte
// cp.async where the rows allow it), zero-padded to a multiple of 64 keys:
// <= 74 KB at S = 256, dh = 64, <= 140 KB at dh = 128, one cp.async group
// per 64 keys, so the first keys are multiplied while the rest land. Each
// warp loads its 16 query rows as MMA fragments from global memory and runs
// the shared routine over the staged keys in 64-key steps: S = Q K^T and
// O += P V on mma.sync m16n8k16 with fp32 accumulation, P split into bf16
// hi + lo, the online softmax in registers, the output written straight
// from registers. A chunk of real keys without a key mask or causal flag
// takes the scale alone (no per-score checks). K and V are read from device
// memory once per (batch row, head).
//
// fp32 design (SIMT, the parity path): one block per (query tile of 32
// rows, head, batch row). The block loads its head's K and V slices
// [S, dh] into shared memory as fp32; K rows are padded to dh+1 floats so
// the per-key dot products of a warp hit distinct banks. Each of the 4
// warps owns query rows: the lanes split the S keys, keep the row's scores
// in shared memory, and do max -> exp -> sum -> normalise -> .V in fp32.
// Shared memory is dynamic (up to ~139 KB at S=256, dh=64), raised past 48
// KB with cudaFuncSetAttribute. It is templated on the element type; the
// bf16 instance is reachable only through attention_nhd_launch with
// is_bf16 = 1, which the port's wrapper never asks for (chip_smoke.py times
// it as the earlier design).

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "attention_mma.cuh"

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

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------

namespace am = attention_mma;
using bf16 = __nv_bfloat16;

// warps per block at most: one per 16 query rows up to T = 256; at dh = 128
// the registers of 16 warps would spill, so 8 warps take two row groups
__host__ __device__ constexpr int max_warps(int dhp) { return dhp <= 64 ? 16 : 8; }

// The score of the warp's row r and key j from the raw dot (am::key_score)
struct NhdScore {
  const float* Ms;  // the staged key mask (zeros without one)
  int t0, S, causal;
  float scale;
  __device__ __forceinline__ float operator()(float acc, int r, int j) const {
    return am::key_score(acc, scale, Ms[j], t0 + r, j, S, causal);
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
__global__ void __launch_bounds__(max_warps(DHP) * 32)
attention_nhd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const float* __restrict__ key_mask,
                         bf16* __restrict__ out, int Tq, int S, int D, int dh, int causal,
                         float scale, int vec, int pairs) {
  constexpr int STR = am::row_stride(DHP);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int chunks = (S + am::CHUNK - 1) / am::CHUNK;  // <= 4: S <= 256
  const int Sp = chunks * am::CHUNK;
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);     // [Sp][DHP + 8]
  bf16* Vs = Ks + Sp * STR;                         // [Sp][DHP + 8]
  float* Ms = reinterpret_cast<float*>(Vs + Sp * STR);  // [Sp] key mask

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int nwarps = blockDim.x / 32;
  const int g = (threadIdx.x & 31) >> 2;

  // the head's K and V, one cp.async group per 64-key chunk, so that the
  // first chunk is multiplied while the others load
  const size_t kv_base = (size_t)b * S * D + (size_t)h * dh;
  for (int c = 0; c < chunks; ++c) {
    const int j0 = c * am::CHUNK;
    am::stage_rows<DHP>(Ks + j0 * STR, k + kv_base, D, j0, am::CHUNK, S, dh, vec);
    am::stage_rows<DHP>(Vs + j0 * STR, v + kv_base, D, j0, am::CHUNK, S, dh, vec);
    am::cp_async_commit();
  }
  for (int j = threadIdx.x; j < S; j += blockDim.x)
    Ms[j] = key_mask != nullptr ? key_mask[(size_t)b * S + j] : 0.f;

  const int groups = (Tq + 15) / 16;  // every warp has at least one
  for (int rg = warp; rg < groups; rg += nwarps) {
    const bool first = rg == warp;  // K and V land during every warp's first group
    const int t0 = rg * 16;
    const size_t row0 = ((size_t)b * Tq + t0 + g) * D + (size_t)h * dh;  // row t0 + g
    const size_t row8 = row0 + (size_t)8 * D;                             // row t0 + g + 8
    am::WarpRows<DHP> w;
    w.start(t0 + g < Tq ? q + row0 : nullptr, t0 + g + 8 < Tq ? q + row8 : nullptr, dh, pairs);
    const NhdScore score{Ms, t0, S, causal, scale};
    const bool unmasked = key_mask == nullptr && !causal;
    const int last = min(Tq - 1, t0 + 15);
    for (int c = 0; c < chunks; ++c) {
      const int k0 = c * am::CHUNK;
      if (first) {  // the same barriers in every warp
        wait_groups(chunks - 1 - c);
        __syncthreads();
      }
      // every key from here on is above the group's rows: it adds exactly 0
      // unless a row has seen no unmasked key yet (warp-uniform)
      if (causal && k0 > last && !__any_sync(0xffffffffu, w.open(t0, Tq))) continue;
      if (unmasked && k0 + am::CHUNK <= S)
        w.attend(Ks + k0 * STR, Vs + k0 * STR, k0, am::ScaleOnly{scale});
      else
        w.attend(Ks + k0 * STR, Vs + k0 * STR, k0, score);
    }
    w.finish(t0 + g < Tq ? out + row0 : nullptr, t0 + g + 8 < Tq ? out + row8 : nullptr, dh,
             pairs);
  }
}

size_t mma_smem_bytes(int S, int dhp) {
  const size_t sp = (S + am::CHUNK - 1) / am::CHUNK * am::CHUNK;
  return sizeof(bf16) * 2 * sp * am::row_stride(dhp) + sizeof(float) * sp;
}

template <int DHP>
int launch_mma(const void* q, const void* k, const void* v, const float* key_mask, void* out,
               int B, int Tq, int S, int H, int dh, int causal, float scale, int vec, int pairs,
               cudaStream_t stream) {
  const size_t bytes = mma_smem_bytes(S, DHP);
  if (bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(attention_nhd_mma_kernel<DHP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int warps = min((Tq + 15) / 16, max_warps(DHP));
  dim3 grid(H, B);
  attention_nhd_mma_kernel<DHP><<<grid, warps * 32, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      key_mask, static_cast<bf16*>(out), Tq, S, H * dh, dh, causal, scale, vec, pairs);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// bf16 q, k, v and out on the tensor cores; the other arguments as
// attention_nhd_launch's below. K and V rows are copied 16 bytes at a time
// where k and v are 16-byte aligned and dh is a multiple of 8; q and out
// are read and written in pairs where they are 4-byte aligned and dh is
// even.
extern "C" int attention_nhd_mma_launch(const void* q, const void* k, const void* v,
                                        const void* key_mask, void* out, int B, int Tq, int S,
                                        int H, int dh, int causal, float scale, void* stream) {
  if (dh > MAX_DH || dh < 1) return static_cast<int>(cudaErrorInvalidValue);
  auto aligned = [](const void* p, int n) { return reinterpret_cast<uintptr_t>(p) % n == 0; };
  const int vec = dh % 8 == 0 && aligned(k, 16) && aligned(v, 16);
  const int pairs = dh % 2 == 0 && aligned(q, 4) && aligned(out, 4);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* km = static_cast<const float*>(key_mask);
  const int dhp = am::padded_width(dh);
  const auto run = dhp == 16 ? launch_mma<16> : dhp == 32 ? launch_mma<32>
                 : dhp == 64 ? launch_mma<64> : launch_mma<128>;
  return run(q, k, v, km, out, B, Tq, S, H, dh, causal, scale, vec, pairs, s);
}

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
