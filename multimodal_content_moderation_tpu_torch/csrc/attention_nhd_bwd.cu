// Backward of the short-sequence multi-head attention over the [B, T, D]
// layout, for Hopper (sm_90a).
//
// Replaces: multimodal_content_moderation_tpu/ops/pallas_attention.py,
//   _attention_nhd_bwd_call (body _nhd_bwd_body), the recompute backward of
//   attention_nhd_diff.
//
// Computes, for every batch row b and head h (dh = D / H), in fp32:
//   p  = softmax_j(q.k * dh^-0.5 + key_mask, causal)   (recomputed, exactly
//        as csrc/attention_nhd.cu forms it)
//   dv = p^T . dO ;  dp = dO . v^T ;  ds = p * (dp - rowsum(dp * p))
//   dz = ds * dh^-0.5 ;  dq = dz . k ;  dk = dz^T . q
// and writes dq [B, Tq, D], dk and dv [B, S, D] in q's type. The rowsum is
// JAX's rowsum(dp * p), not FlashAttention-2's rowsum(dO * O): the same in
// exact arithmetic, rounded differently in bf16.
//
// Masking reproduces the forward so that the recomputed p is the p of the
// forward: the key mask is added as fp32 (-FLT_MAX for a masked key), a
// causal position is set to -FLT_MAX (not -inf), the scale is applied after
// the dot with __fmul_rn, and the row max is subtracted before exp. A row
// whose keys are all masked is a uniform average in both passes and stays
// finite.
//
// Bound on an H100: one call reads q, dO (Tq rows), k, v (S rows) and
// writes dq, dk, dv: (3 Tq + 4 S) B D bytes per element type, against
// 10 B H Tq S dh operations (half that when causal), the JAX cost estimate.
// At the training path (B=32, vision T=50, D=768, 12 heads; text T=48,
// D=512, 8 heads, bf16) a vision call moves ~17 MB and does ~0.61 GFLOP:
// 5.1 us of bytes at 3.35 TB/s against 0.6 us at the bf16 tensor-core rate,
// so the kernel is bound by bytes.
//
// Design (simple and right; fast is later work): one wrapper call runs two
// __global__ functions on the caller's stream.
//  A. grid (query tile of 32 rows, head, batch row): stages the tile's q and
//     dO rows in shared memory, streams k and v in chunks of 64 keys through
//     shared memory, recomputes the scores and the softmax of each row over
//     all S keys, forms dp and dz, accumulates dq in registers, and stores
//     each row's max, 1/sum and rowsum(dp * p) in an fp32 [B, H, Tq, 3]
//     scratch buffer.
//  B. grid (key tile of 32 keys, head, batch row): stages its keys' k and v,
//     streams q and dO in chunks of 64 query rows with their statistics,
//     rebuilds p and dz for its keys bit for bit as A formed them (same dot
//     order, same statistics), and accumulates dk and dv in registers.
// Each warp owns rows; lanes split the keys (or queries) for the dots and
// split dh for the accumulations. Chunked rows are padded to dh+1 floats so
// a warp's per-row dot products hit distinct banks. Shared memory is
// dynamic (up to ~132 KB at S=256, dh=128), raised past 48 KB with
// cudaFuncSetAttribute. The wrapper counts one launch per call.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int QTILE = 32;          // query rows per block of launch A
constexpr int KTILE = 32;          // key rows per block of launch B
constexpr int CHUNK = 64;          // rows streamed through shared memory at a time
constexpr int MAX_DH = 128;
constexpr int NACC = MAX_DH / 32;  // per-lane accumulators of one row
constexpr int RPW = QTILE / WARPS; // rows per warp (A) / keys per warp (B)
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

// The dot product of every score and every dp, in both launches: ascending
// d, one fma per element, as the forward kernel forms its scores.
__device__ __forceinline__ float dot_row(const float* a, const float* b, int dh) {
  float acc = 0.f;
  for (int d = 0; d < dh; ++d) acc = fmaf(a[d], b[d], acc);
  return acc;
}

// dst[r * stride + d] = src[base + (row0 + r) * D + d] in fp32, r < n, d < dh
template <typename T>
__device__ __forceinline__ void load_rows(float* dst, int stride, const T* __restrict__ src,
                                          size_t base, int row0, int n, int D, int dh) {
  for (int idx = threadIdx.x; idx < n * dh; idx += THREADS) {
    const int r = idx / dh;
    const int d = idx - r * dh;
    dst[r * stride + d] = to_f(src[base + (size_t)(row0 + r) * D + d]);
  }
}

// Launch A: dq and the per-row statistics.
template <typename T>
__global__ void __launch_bounds__(THREADS)
attention_nhd_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v, const T* __restrict__ dout,
                            const float* __restrict__ key_mask, T* __restrict__ dq,
                            float* __restrict__ stats, int Tq, int S, int H, int dh,
                            int causal, float scale) {
  extern __shared__ float smem[];
  const int D = H * dh;
  const int cs = dh + 1;
  float* Qs = smem;              // [QTILE, dh]   q rows
  float* Gs = Qs + QTILE * dh;   // [QTILE, dh]   dO rows
  float* Ps = Gs + QTILE * dh;   // [QTILE, S]    scores, then p
  float* Zs = Ps + QTILE * S;    // [QTILE, S]    dp, then dz
  float* Ms = Zs + QTILE * S;    // [S]           key mask
  float* Cs = Ms + S;            // [CHUNK, dh+1] a chunk of k or v rows

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int t0 = blockIdx.x * QTILE;
  const int rows = min(QTILE, Tq - t0);
  const size_t q_base = (size_t)b * Tq * D + (size_t)h * dh;
  const size_t kv_base = (size_t)b * S * D + (size_t)h * dh;

  load_rows(Qs, dh, q, q_base, t0, rows, D, dh);
  load_rows(Gs, dh, dout, q_base, t0, rows, D, dh);
  for (int j = threadIdx.x; j < S; j += THREADS)
    Ms[j] = key_mask != nullptr ? key_mask[(size_t)b * S + j] : 0.f;

  // scores s = q.k * scale + mask, streaming k
  for (int c0 = 0; c0 < S; c0 += CHUNK) {
    const int n = min(CHUNK, S - c0);
    __syncthreads();
    load_rows(Cs, cs, k, kv_base, c0, n, D, dh);
    __syncthreads();
    for (int r = warp; r < rows; r += WARPS) {
      const int t = t0 + r;
      for (int jj = lane; jj < n; jj += 32) {
        const int j = c0 + jj;
        float s = __fmul_rn(dot_row(Qs + r * dh, Cs + jj * cs, dh), scale) + Ms[j];
        if (causal && j > t) s = NEG_INF;
        Ps[r * S + j] = s;
      }
    }
  }
  __syncthreads();

  // softmax per row, as the forward: max, exp(s - max), sum, * (1/sum)
  for (int r = warp; r < rows; r += WARPS) {
    float* p = Ps + r * S;
    float m = NEG_INF;
    for (int j = lane; j < S; j += 32) m = fmaxf(m, p[j]);
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
    if (lane == 0) {
      float* st = stats + (((size_t)b * H + h) * Tq + t0 + r) * 3;
      st[0] = m;
      st[1] = inv;
    }
  }

  // dp = dO.v, streaming v
  for (int c0 = 0; c0 < S; c0 += CHUNK) {
    const int n = min(CHUNK, S - c0);
    __syncthreads();
    load_rows(Cs, cs, v, kv_base, c0, n, D, dh);
    __syncthreads();
    for (int r = warp; r < rows; r += WARPS)
      for (int jj = lane; jj < n; jj += 32)
        Zs[r * S + c0 + jj] = dot_row(Gs + r * dh, Cs + jj * cs, dh);
  }
  __syncthreads();

  // dz = p * (dp - rowsum(dp * p)) * scale
  for (int r = warp; r < rows; r += WARPS) {
    const float* p = Ps + r * S;
    float* z = Zs + r * S;
    float acc = 0.f;
    for (int j = lane; j < S; j += 32) acc += z[j] * p[j];
    const float rs = warp_sum(acc);
    for (int j = lane; j < S; j += 32) z[j] = __fmul_rn(p[j] * (z[j] - rs), scale);
    if (lane == 0) stats[(((size_t)b * H + h) * Tq + t0 + r) * 3 + 2] = rs;
  }

  // dq = dz.k, streaming k again; lanes split dh
  float acc[RPW][NACC];
#pragma unroll
  for (int i = 0; i < RPW; ++i)
#pragma unroll
    for (int c = 0; c < NACC; ++c) acc[i][c] = 0.f;
  for (int c0 = 0; c0 < S; c0 += CHUNK) {
    const int n = min(CHUNK, S - c0);
    __syncthreads();
    load_rows(Cs, cs, k, kv_base, c0, n, D, dh);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const int r = warp + WARPS * i;
      if (r >= rows) continue;
      const float* z = Zs + r * S + c0;
      for (int jj = 0; jj < n; ++jj) {
        const float zj = z[jj];
        const float* kr = Cs + jj * cs;
#pragma unroll
        for (int c = 0; c < NACC; ++c) {
          const int d = lane + 32 * c;
          if (d < dh) acc[i][c] = fmaf(zj, kr[d], acc[i][c]);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int r = warp + WARPS * i;
    if (r >= rows) continue;
    T* dst = dq + q_base + (size_t)(t0 + r) * D;
#pragma unroll
    for (int c = 0; c < NACC; ++c) {
      const int d = lane + 32 * c;
      if (d < dh) store_out(dst + d, acc[i][c]);
    }
  }
}

// Launch B: dk and dv from the statistics of launch A.
template <typename T>
__global__ void __launch_bounds__(THREADS)
attention_nhd_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                              const T* __restrict__ v, const T* __restrict__ dout,
                              const float* __restrict__ key_mask, T* __restrict__ dk,
                              T* __restrict__ dv, const float* __restrict__ stats, int Tq,
                              int S, int H, int dh, int causal, float scale) {
  extern __shared__ float smem[];
  const int D = H * dh;
  const int cs = dh + 1;
  float* Ks = smem;                 // [KTILE, dh]    this block's k rows
  float* Vs = Ks + KTILE * dh;      // [KTILE, dh]    this block's v rows
  float* Pt = Vs + KTILE * dh;      // [KTILE, CHUNK] p of (key, query)
  float* Zt = Pt + KTILE * CHUNK;   // [KTILE, CHUNK] dz of (key, query)
  float* Qc = Zt + KTILE * CHUNK;   // [CHUNK, dh+1]  a chunk of q rows
  float* Gc = Qc + CHUNK * cs;      // [CHUNK, dh+1]  the same chunk of dO rows
  float* St = Gc + CHUNK * cs;      // [CHUNK, 3]     their statistics
  float* Mk = St + CHUNK * 3;       // [KTILE]        key mask of this block's keys

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int j0 = blockIdx.x * KTILE;
  const int keys = min(KTILE, S - j0);
  const size_t q_base = (size_t)b * Tq * D + (size_t)h * dh;
  const size_t kv_base = (size_t)b * S * D + (size_t)h * dh;
  const float* st_base = stats + ((size_t)b * H + h) * Tq * 3;

  load_rows(Ks, dh, k, kv_base, j0, keys, D, dh);
  load_rows(Vs, dh, v, kv_base, j0, keys, D, dh);
  for (int j = threadIdx.x; j < keys; j += THREADS)
    Mk[j] = key_mask != nullptr ? key_mask[(size_t)b * S + j0 + j] : 0.f;

  float ak[RPW][NACC];
  float av[RPW][NACC];
#pragma unroll
  for (int i = 0; i < RPW; ++i)
#pragma unroll
    for (int c = 0; c < NACC; ++c) ak[i][c] = av[i][c] = 0.f;

  for (int c0 = 0; c0 < Tq; c0 += CHUNK) {
    const int n = min(CHUNK, Tq - c0);
    __syncthreads();
    load_rows(Qc, cs, q, q_base, c0, n, D, dh);
    load_rows(Gc, cs, dout, q_base, c0, n, D, dh);
    for (int idx = threadIdx.x; idx < n * 3; idx += THREADS) St[idx] = st_base[c0 * 3 + idx];
    __syncthreads();
    // p and dz of this warp's keys against the chunk's queries (lanes split queries)
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const int kr = warp + WARPS * i;
      if (kr >= keys) continue;
      const int j = j0 + kr;
      for (int tt = lane; tt < n; tt += 32) {
        const int t = c0 + tt;
        float s = __fmul_rn(dot_row(Qc + tt * cs, Ks + kr * dh, dh), scale) + Mk[kr];
        if (causal && j > t) s = NEG_INF;
        const float p = expf(s - St[tt * 3]) * St[tt * 3 + 1];
        const float dp = dot_row(Gc + tt * cs, Vs + kr * dh, dh);
        Pt[kr * CHUNK + tt] = p;
        Zt[kr * CHUNK + tt] = __fmul_rn(p * (dp - St[tt * 3 + 2]), scale);
      }
    }
    __syncwarp();  // each warp reads back only its own keys' rows of Pt / Zt
    // dv += p^T.dO and dk += dz^T.q (lanes split dh)
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const int kr = warp + WARPS * i;
      if (kr >= keys) continue;
      for (int tt = 0; tt < n; ++tt) {
        const float p = Pt[kr * CHUNK + tt];
        const float z = Zt[kr * CHUNK + tt];
        const float* gr = Gc + tt * cs;
        const float* qr = Qc + tt * cs;
#pragma unroll
        for (int c = 0; c < NACC; ++c) {
          const int d = lane + 32 * c;
          if (d < dh) {
            av[i][c] = fmaf(p, gr[d], av[i][c]);
            ak[i][c] = fmaf(z, qr[d], ak[i][c]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int kr = warp + WARPS * i;
    if (kr >= keys) continue;
    const size_t off = kv_base + (size_t)(j0 + kr) * D;
#pragma unroll
    for (int c = 0; c < NACC; ++c) {
      const int d = lane + 32 * c;
      if (d < dh) {
        store_out(dk + off + d, ak[i][c]);
        store_out(dv + off + d, av[i][c]);
      }
    }
  }
}

size_t smem_a(int S, int dh) {
  return sizeof(float) *
         (2 * (size_t)QTILE * dh + 2 * (size_t)QTILE * S + S + (size_t)CHUNK * (dh + 1));
}

size_t smem_b(int dh) {
  return sizeof(float) * (2 * (size_t)KTILE * dh + 2 * (size_t)KTILE * CHUNK +
                          2 * (size_t)CHUNK * (dh + 1) + 3 * CHUNK + KTILE);
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* dout, const float* key_mask,
           void* dq, void* dk, void* dv, float* stats, int B, int Tq, int S, int H, int dh,
           int causal, float scale, cudaStream_t stream) {
  const size_t bytes_a = smem_a(S, dh);
  const size_t bytes_b = smem_b(dh);
  cudaError_t e = allow_smem(attention_nhd_bwd_dq_kernel<T>, bytes_a);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = allow_smem(attention_nhd_bwd_dkdv_kernel<T>, bytes_b);
  if (e != cudaSuccess) return static_cast<int>(e);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* gt = static_cast<const T*>(dout);
  dim3 grid_a((Tq + QTILE - 1) / QTILE, H, B);
  attention_nhd_bwd_dq_kernel<T><<<grid_a, THREADS, bytes_a, stream>>>(
      qt, kt, vt, gt, key_mask, static_cast<T*>(dq), stats, Tq, S, H, dh, causal, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid_b((S + KTILE - 1) / KTILE, H, B);
  attention_nhd_bwd_dkdv_kernel<T><<<grid_b, THREADS, bytes_b, stream>>>(
      qt, kt, vt, gt, key_mask, static_cast<T*>(dk), static_cast<T*>(dv), stats, Tq, S, H, dh,
      causal, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// is_bf16: 0 -> q, k, v, dout, dq, dk, dv are float*; 1 -> __nv_bfloat16*.
// key_mask: fp32 [B, S] or null. stats: fp32 scratch of B*H*Tq*3 floats.
// scale: dh^-0.5, computed by the caller. Returns cudaGetLastError() after
// the launches, or the error of raising a kernel's shared-memory limit.
extern "C" int attention_nhd_bwd_launch(const void* q, const void* k, const void* v,
                                        const void* dout, const void* key_mask, void* dq,
                                        void* dk, void* dv, void* stats, int B, int Tq, int S,
                                        int H, int dh, int causal, float scale, int is_bf16,
                                        void* stream) {
  if (dh > MAX_DH) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* km = static_cast<const float*>(key_mask);
  float* st = static_cast<float*>(stats);
  if (is_bf16)
    return launch<__nv_bfloat16>(q, k, v, dout, km, dq, dk, dv, st, B, Tq, S, H, dh, causal,
                                 scale, s);
  return launch<float>(q, k, v, dout, km, dq, dk, dv, st, B, Tq, S, H, dh, causal, scale, s);
}

extern "C" const char* attention_nhd_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
