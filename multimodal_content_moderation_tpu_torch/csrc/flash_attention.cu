// Blockwise (flash) multi-head attention over strided [B, H, T, dh] views,
// for Hopper (sm_90a). Forward only, as the TPU kernel. Two kernels: a bf16
// one on the tensor cores (flash_attention_mma_launch), and an fp32 SIMT one
// (flash_attention_launch) for fp32 inputs, the parity path.
//
// Replaces: multimodal_content_moderation_tpu/ops/pallas_attention.py,
//   flash_attention (kernel _make_flash_kernel), the long-sequence path of
//   fused_mha.
//
// Computes, for every batch row b, head h and query row t < Tq, over the keys
// j < S, in fp32, in the TPU kernel's order:
//   s = (q[b,h,t,:] . k[b,h,j,:]) * dh^-0.5      (scale after the dot)
//   s += mask[b,h,t,j]                           (dense additive, when given)
//   s += key_mask[b,j]                           (additive key row, when given)
//   s = (j <= t) ? s : -FLT_MAX                  (when causal)
//   out[b,h,t,:] = sum_j softmax_j(s) v[b,h,j,:], written in q's type,
// with a running max, a running sum and an fp32 accumulator per row (online
// softmax): a key tile rescales what came before by exp(m_old - m_new).
// The running max starts at -FLT_MAX, not -inf, so a tile whose entries are
// all -inf (a dense and a key mask of -FLT_MAX add up to -inf) adds exp(-inf)
// = 0 and no NaN. Ragged T and S are masked here: a key past S scores -inf
// and weighs exactly 0, a query row past Tq is not stored, nothing is padded.
// The function is the unpadded one: a row whose keys are all masked at
// -FLT_MAX averages its S real keys (the TPU wrapper pads S to a multiple of
// 128 with zero keys that such a row averages too).
//
// Causal: key tiles entirely above the diagonal of the query tile are
// skipped, as on the TPU, unless a row of the tile still has a running max
// of -FLT_MAX (every key so far masked): the skipped keys would weigh 1 each
// there, so the tile is read to keep the unpadded softmax exact.
//
// Strides: q, k, v and out are addressed by element strides for (b, h, t)
// with a contiguous last axis, so the caller passes the projections' [B, T, D]
// memory viewed as [B, H, T, dh] without a transpose; the dense mask takes
// strides for (b, h, t, j), where a stride of 0 broadcasts; the key row takes
// strides for (b, h).
//
// Bound on an H100: at the SigLIP2-B/16-384 vision tower (B=64, T=S=576, 12
// heads of 64, bf16, no mask) one call reads q, k, v and writes the output,
// 226 MB (67.5 us at 3.35 TB/s), against 4 B H T S dh = 65.2 GFLOP (66 us at
// the bf16 tensor-core rate): bound by bytes, nearly balanced.
//
// bf16 design (tensor cores, attention_mma.cuh): one block of 4 warps per
// (64 query rows, head, batch row); each warp owns 16 rows, its Q fragments
// in registers. Key tiles of 64 keys are double-buffered in shared memory as
// bf16 (16-byte cp.async where the rows allow it, element loads otherwise):
// tile i + 1 loads while tile i is multiplied, 36 KB at dh=64 (69.6 KB at
// 128), so several blocks share an SM. S = Q K^T and O += P V run on
// mma.sync m16n8k16 with fp32 accumulation, P split into bf16 hi + lo, the
// softmax in registers: 98 GFLOP of MMA at the vision shape, with no score
// in shared memory and one barrier per tile. A tile of real keys for 16
// real rows without a mask source takes the scale alone (no per-score
// checks). The causal skip of a tile's MMAs is decided per warp; the loads
// and barriers stay uniform across the block, which leaves the tile loop
// only through __syncthreads_or.
//
// fp32 design (SIMT, the parity path): one block of 256 threads per (64-row
// query tile, head, batch row). The query tile sits in shared memory as
// fp32, transposed ([dh][64]); key tiles of 64 keys stream through shared
// memory (K transposed, V as rows padded to a multiple of 4 floats). Each
// thread forms a 4x4 block of the 64x64 score tile with float4 reads, the
// scores go to shared memory, a warp per 8 rows takes the running max and
// sum, and each thread keeps a 4-row x 4-column block of the output
// accumulator per 64 columns of dh in registers, fed by four probabilities
// and one float4 of V per key (16 FMAs per 5 shared loads). Its products run
// on the SIMT units (67 TFLOP/s fp32), a floor of ~0.97 ms at the vision
// shape. Shared memory is dynamic (68.6 KB at dh=64, 120 KB at dh=128),
// raised past 48 KB with cudaFuncSetAttribute. It is templated on the
// element type; the bf16 instance is reachable only through
// flash_attention_launch with is_bf16 = 1, which the port's wrapper never
// asks for (chip_smoke.py times it as the earlier design).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

#include "attention_mma.cuh"

namespace {

constexpr int BQ = 64;           // query rows per block
constexpr int BK = 64;           // keys per tile
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ROWS_PER_WARP = BQ / WARPS;
constexpr int MAX_DH = 128;
constexpr int DG = MAX_DH / 64;  // 4-column output groups per thread, 64 columns apart
constexpr int QS = BQ + 4;      // row stride of the transposed q tile
constexpr int KS = BK + 4;       // row stride of the transposed k tile
constexpr int SS = BK + 1;       // row stride of the score tile
constexpr float NEG_INF = -3.4028235e38f;

struct Strides {
  long long q[3], k[3], v[3], o[3];  // (b, h, t); the last axis is contiguous
  long long mask[4];                 // (b, h, t, j)
  long long key_mask[2];             // (b, h)
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
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const float* __restrict__ mask,
                       const float* __restrict__ key_mask, T* __restrict__ out,
                       int Tq, int S, int dh, int causal, float scale, Strides st) {
  extern __shared__ __align__(16) float smem[];
  const int VS = (dh + 3) & ~3;   // row stride of the v tile: float4 reads
  float* Qt = smem;               // [dh][QS]  q tile, transposed
  float* Kt = Qt + dh * QS;       // [dh][KS]  k tile, transposed
  float* Vs = Kt + dh * KS;       // [BK][VS]
  float* Ss = Vs + BK * VS;       // [BQ][SS]  scores, then probabilities
  float* row_m = Ss + BQ * SS;    // [BQ] running max
  float* row_l = row_m + BQ;      // [BQ] running sum
  float* row_c = row_l + BQ;      // [BQ] this tile's correction

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int tx = tid % 16;  // score columns tx*4..+3; output columns 64 g + tx*4..+3
  const int ty = tid / 16;  // rows ty*4..+3

  const T* qb = q + b * st.q[0] + h * st.q[1];
  const T* kb = k + b * st.k[0] + h * st.k[1];
  const T* vb = v + b * st.v[0] + h * st.v[1];
  const float* mb = mask != nullptr ? mask + b * st.mask[0] + h * st.mask[1] : nullptr;
  const float* kmb = key_mask != nullptr ? key_mask + b * st.key_mask[0] + h * st.key_mask[1]
                                         : nullptr;

  for (int idx = tid; idx < BQ * dh; idx += THREADS) {
    const int r = idx / dh;
    const int d = idx - r * dh;
    const int t = q0 + r;
    Qt[d * QS + r] = t < Tq ? to_f(qb[t * st.q[2] + d]) : 0.f;
  }
  if (tid < BQ) {
    row_m[tid] = NEG_INF;
    row_l[tid] = 0.f;
  }

  float o[4][DG][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int g = 0; g < DG; ++g)
#pragma unroll
      for (int j = 0; j < 4; ++j) o[i][g][j] = 0.f;

  const int last_row = min(Tq, q0 + BQ) - 1;
  for (int k0 = 0; k0 < S; k0 += BK) {
    if (causal && k0 > last_row) {
      // past the diagonal: only rows whose every key so far was masked need
      // the rest (block-uniform condition, so the barrier is safe)
      const int open = tid < BQ && q0 + tid < Tq && row_m[tid] == NEG_INF;
      if (!__syncthreads_or(open)) break;
    }
    __syncthreads();  // the previous tile's Kt, Vs and Ss are consumed
    for (int idx = tid; idx < BK * VS; idx += THREADS) {
      const int c = idx / VS;
      const int d = idx - c * VS;
      const int j = k0 + c;
      const bool in = j < S && d < dh;
      if (d < dh) Kt[d * KS + c] = in ? to_f(kb[j * st.k[2] + d]) : 0.f;
      Vs[c * VS + d] = in ? to_f(vb[j * st.v[2] + d]) : 0.f;
    }
    __syncthreads();

    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    for (int d = 0; d < dh; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(Qt + d * QS + ty * 4);
      const float4 kk = *reinterpret_cast<const float4*>(Kt + d * KS + tx * 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float kv[4] = {kk.x, kk.y, kk.z, kk.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], kv[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
      const int t = q0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx * 4 + j;
        const int kj = k0 + c;
        float s = -INFINITY;
        if (t < Tq && kj < S) {
          s = __fmul_rn(acc[i][j], scale);  // scale after the dot, no FMA contraction
          if (mb != nullptr) s = s + mb[t * st.mask[2] + kj * st.mask[3]];
          if (kmb != nullptr) s = s + kmb[kj];
          if (causal && kj > t) s = NEG_INF;
        }
        Ss[r * SS + c] = s;
      }
    }
    __syncthreads();

    for (int rr = 0; rr < ROWS_PER_WARP; ++rr) {
      const int r = warp * ROWS_PER_WARP + rr;
      float* srow = Ss + r * SS;
      const float s0 = srow[lane];
      const float s1 = srow[lane + 32];
      const float m_old = row_m[r];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(s0, s1)));
      const float p0 = expf(s0 - m_new);
      const float p1 = expf(s1 - m_new);
      srow[lane] = p0;
      srow[lane + 32] = p1;
      const float sum = warp_sum(p0 + p1);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        row_l[r] = row_l[r] * corr + sum;
        row_m[r] = m_new;
        row_c[r] = corr;
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float corr = row_c[ty * 4 + i];
#pragma unroll
      for (int g = 0; g < DG; ++g)
#pragma unroll
        for (int j = 0; j < 4; ++j) o[i][g][j] *= corr;
    }
    const float* prow = Ss + ty * 4 * SS;
    for (int c2 = 0; c2 < BK; ++c2) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = prow[i * SS + c2];
#pragma unroll
      for (int g = 0; g < DG; ++g) {
        const int d0 = 64 * g + tx * 4;
        if (d0 < dh) {  // d0 + 3 < VS: the padded columns hold zeros
          const float4 vv = *reinterpret_cast<const float4*>(Vs + c2 * VS + d0);
          const float vj[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) o[i][g][j] = fmaf(p[i], vj[j], o[i][g][j]);
        }
      }
    }
  }
  __syncthreads();  // row_l is final

  T* ob = out + b * st.o[0] + h * st.o[1];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    const int t = q0 + r;
    if (t >= Tq) continue;
    const float l = row_l[r];
#pragma unroll
    for (int g = 0; g < DG; ++g)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int d = 64 * g + tx * 4 + j;
        if (d < dh) store_out(ob + t * st.o[2] + d, o[i][g][j] / l);
      }
  }
}

size_t smem_bytes(int dh) {
  const size_t vs = (dh + 3) & ~3;
  return sizeof(float) *
         ((size_t)dh * QS + (size_t)dh * KS + (size_t)BK * vs + (size_t)BQ * SS + 3 * BQ);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const float* mask,
           const float* key_mask, void* out, int B, int H, int Tq, int S, int dh,
           int causal, float scale, const Strides& st, cudaStream_t stream) {
  const size_t bytes = smem_bytes(dh);
  if (bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(flash_attention_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  dim3 grid((Tq + BQ - 1) / BQ, H, B);
  flash_attention_kernel<T><<<grid, THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), mask,
      key_mask, static_cast<T*>(out), Tq, S, dh, causal, scale, st);
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
// kernel's order (see the top of the file).
struct FlashScore {
  const float* mb;  // this (b, h)'s dense mask or null
  long long mt, mj;  // its (t, j) strides
  const float* kmb;  // this b's key row or null
  int t0, Tq, S, causal;
  float scale;
  __device__ __forceinline__ float operator()(float acc, int r, int j) const {
    const int t = t0 + r;
    if (t >= Tq || j >= S) return -INFINITY;
    float s = __fmul_rn(acc, scale);  // scale after the dot, no FMA contraction
    if (mb != nullptr) s = s + mb[t * mt + j * mj];
    if (kmb != nullptr) s = s + kmb[j];
    if (causal && j > t) s = am::NEG_INF;
    return s;
  }
};

template <int DHP>
__global__ void __launch_bounds__(MMA_WARPS * 32)
flash_attention_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                           const bf16* __restrict__ v, const float* __restrict__ mask,
                           const float* __restrict__ key_mask, bf16* __restrict__ out, int Tq,
                           int S, int dh, int causal, float scale, Strides st, int vec,
                           int pairs) {
  constexpr int TILE = am::CHUNK * am::row_stride(DHP);  // elements of one staged tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Kbuf = reinterpret_cast<bf16*>(smem_raw);  // [2][64][DHP + 8]
  bf16* Vbuf = Kbuf + 2 * TILE;                    // [2][64][DHP + 8]

  const int q0 = blockIdx.x * MMA_BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int g = (threadIdx.x & 31) >> 2;
  const int t0 = q0 + warp * 16;  // the warp's first row

  const bf16* qb = q + b * st.q[0] + h * st.q[1];
  const bf16* kb = k + b * st.k[0] + h * st.k[1];
  const bf16* vb = v + b * st.v[0] + h * st.v[1];
  bf16* ob = out + b * st.o[0] + h * st.o[1];

  const int ntiles = (S + am::CHUNK - 1) / am::CHUNK;
  auto load_tile = [&](int tile) {
    const int buf = tile & 1;
    am::stage_rows<DHP>(Kbuf + buf * TILE, kb, st.k[2], tile * am::CHUNK, am::CHUNK, S, dh, vec);
    am::stage_rows<DHP>(Vbuf + buf * TILE, vb, st.v[2], tile * am::CHUNK, am::CHUNK, S, dh, vec);
    am::cp_async_commit();
  };
  load_tile(0);

  am::WarpRows<DHP> w;
  w.start(t0 + g < Tq ? qb + (t0 + g) * st.q[2] : nullptr,
          t0 + g + 8 < Tq ? qb + (t0 + g + 8) * st.q[2] : nullptr, dh, pairs);
  const FlashScore score{
      mask != nullptr ? mask + b * st.mask[0] + h * st.mask[1] : nullptr,
      st.mask[2], st.mask[3],
      key_mask != nullptr ? key_mask + b * st.key_mask[0] + h * st.key_mask[1] : nullptr,
      t0, Tq, S, causal, scale};
  // no mask source and all 16 rows real: a tile of real keys needs only the scale
  const bool unmasked = mask == nullptr && key_mask == nullptr && !causal && t0 + 16 <= Tq;

  const int block_last = min(Tq, q0 + MMA_BQ) - 1;
  const int warp_last = min(Tq - 1, t0 + 15);
  for (int i = 0; i < ntiles; ++i) {
    const int k0 = i * am::CHUNK;
    if (causal && k0 > block_last) {
      // past the block's diagonal: only rows whose every key so far was
      // masked need the rest (a block-uniform condition, so the barrier is
      // safe); leave with the whole block
      if (!__syncthreads_or(w.open(t0, Tq))) break;
    }
    am::cp_async_wait<0>();  // tile i has landed
    // tile i is visible to every warp, and every warp is done with tile
    // i - 1, whose buffer takes tile i + 1 while tile i is multiplied
    __syncthreads();
    if (i + 1 < ntiles) load_tile(i + 1);
    // a warp whose rows are all above this tile's keys and have each seen
    // an unmasked key gains exactly 0 from it (warp-uniform)
    const bool skip = t0 >= Tq ||
                      (causal && k0 > warp_last && !__any_sync(0xffffffffu, w.open(t0, Tq)));
    const bf16* Ks = Kbuf + (i & 1) * TILE;
    const bf16* Vs = Vbuf + (i & 1) * TILE;
    if (skip) continue;
    if (unmasked && k0 + am::CHUNK <= S)
      w.attend(Ks, Vs, k0, am::ScaleOnly{scale});
    else
      w.attend(Ks, Vs, k0, score);
  }
  am::cp_async_wait<0>();
  w.finish(t0 + g < Tq ? ob + (t0 + g) * st.o[2] : nullptr,
           t0 + g + 8 < Tq ? ob + (t0 + g + 8) * st.o[2] : nullptr, dh, pairs);
}

template <int DHP>
int launch_mma(const void* q, const void* k, const void* v, const float* mask,
               const float* key_mask, void* out, int B, int H, int Tq, int S, int dh,
               int causal, float scale, const Strides& st, int vec, int pairs,
               cudaStream_t stream) {
  const size_t bytes = sizeof(bf16) * 4 * am::CHUNK * am::row_stride(DHP);
  if (bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(flash_attention_mma_kernel<DHP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  dim3 grid((Tq + MMA_BQ - 1) / MMA_BQ, H, B);
  flash_attention_mma_kernel<DHP><<<grid, MMA_WARPS * 32, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      mask, key_mask, static_cast<bf16*>(out), Tq, S, dh, causal, scale, st, vec, pairs);
  return static_cast<int>(cudaGetLastError());
}

Strides unpack(const long long* strides) {
  Strides st;
  long long* dst[6] = {st.q, st.k, st.v, st.o, st.mask, st.key_mask};
  const int len[6] = {3, 3, 3, 3, 4, 2};
  int n = 0;
  for (int a = 0; a < 6; ++a)
    for (int i = 0; i < len[a]; ++i) dst[a][i] = strides[n++];
  return st;
}

}  // namespace

// bf16 q, k, v and out on the tensor cores; the other arguments as
// flash_attention_launch's below. K and V rows are copied 16 bytes at a time
// where k, v are 16-byte aligned with strides and dh multiples of 8 elements;
// q and out are read and written in pairs where they are 4-byte aligned with
// even strides and dh.
extern "C" int flash_attention_mma_launch(const void* q, const void* k, const void* v,
                                          const void* mask, const void* key_mask, void* out,
                                          int B, int H, int Tq, int S, int dh, int causal,
                                          float scale, const long long* strides,
                                          void* stream) {
  if (dh > MAX_DH || dh < 1) return static_cast<int>(cudaErrorInvalidValue);
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
  const float* km = static_cast<const float*>(key_mask);
  const int dhp = am::padded_width(dh);
  const auto run = dhp == 16 ? launch_mma<16> : dhp == 32 ? launch_mma<32>
                 : dhp == 64 ? launch_mma<64> : launch_mma<128>;
  return run(q, k, v, m, km, out, B, H, Tq, S, dh, causal, scale, st, vec, pairs, s);
}

// is_bf16: 0 -> q, k, v, out are float*; 1 -> __nv_bfloat16*.
// mask: fp32 or null; key_mask: fp32 or null. strides: 18 element strides on
// the host, in the order q (b, h, t), k, v, out (b, h, t), mask (b, h, t, j),
// key_mask (b, h). scale: dh^-0.5, computed by the caller.
// Returns cudaGetLastError() after the launch, or the error of raising the
// kernel's shared-memory limit.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v,
                                      const void* mask, const void* key_mask, void* out,
                                      int B, int H, int Tq, int S, int dh, int causal,
                                      float scale, const long long* strides, int is_bf16,
                                      void* stream) {
  if (dh > MAX_DH || dh < 1) return static_cast<int>(cudaErrorInvalidValue);
  const Strides st = unpack(strides);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* m = static_cast<const float*>(mask);
  const float* km = static_cast<const float*>(key_mask);
  if (is_bf16)
    return launch<__nv_bfloat16>(q, k, v, m, km, out, B, H, Tq, S, dh, causal, scale, st, s);
  return launch<float>(q, k, v, m, km, out, B, H, Tq, S, dh, causal, scale, st, s);
}

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
