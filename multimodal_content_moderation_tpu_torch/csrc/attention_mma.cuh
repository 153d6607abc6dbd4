// The warp-level attention routine that the bf16 forms of flash_attention.cu
// and attention_nhd.cu share: one warp owns 16 query rows and walks the keys
// in chunks of 64 that its block has staged in shared memory, on Hopper's
// tensor cores (mma.sync m16n8k16, bf16 in, fp32 accumulate; the generic
// pieces are in mma_common.cuh). Its two products per chunk, qk_chunk (S =
// Q K^T) and pv_chunk (O += P V, P as bf16 hi + lo), also carry the bf16
// backward (attention_nhd_bwd.cu).
//
// Per chunk, for the warp's rows (thread layout of the m16n8 C fragment:
// lane / 4 owns rows g and g + 8, lane % 4 owns columns 2 (lane % 4) + {0, 1}
// of each 8-column tile):
//   1. S = Q K^T in fp32. Q sits in registers as A fragments, loaded once;
//      K comes from shared memory with ldmatrix. Products of bf16 values are
//      exact in fp32, so this is the reference's fp32 dot in another order.
//   2. The caller's Score functor scales (after the dot, __fmul_rn) and adds
//      the mask sources in the reference's order; a key past S scores -inf.
//   3. Online softmax in registers: the running max starts at -FLT_MAX (a
//      row whose keys are all masked at -FLT_MAX then averages them, as the
//      plain version does); the max of a row is reduced over its four
//      threads with two __shfl_xor_sync; each thread keeps a partial fp32
//      sum l, reduced the same way once at the end. exp(s - m) is one SFU
//      ex2 of (s - m) log2 e (relative error ~2^-22, far below the bf16
//      output's 2^-9).
//   4. O += P V with V fragments from ldmatrix.trans. P is split into two
//      bf16 halves, hi = bf16(p) and lo = bf16(p - hi), and takes two MMAs:
//      P is kept to ~2^-17 relative, as good as an fp32 P for a bf16 output,
//      where one bf16 rounding of P (2^-9) would reach the bf16 tolerance.
// The S C-fragments become the P A-fragments in registers: nothing goes
// through shared memory but K and V.
//
// Shared layout of a staged chunk: 64 rows (keys) of DHP bf16 values with a
// row stride of DHP + 8 elements; the 16 bytes of padding put the 8 rows of
// every ldmatrix on distinct banks. DHP, the head width rounded up to 16,
// 32, 64 or 128, is a template parameter; columns dh..DHP hold zeros.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_common.cuh"

namespace attention_mma {

constexpr int CHUNK = 64;                   // keys per step
constexpr float NEG_INF = -3.4028235e38f;   // -FLT_MAX, the masked score

// row stride, in elements, of a staged K or V chunk
__host__ __device__ constexpr int row_stride(int dhp) { return dhp + 8; }

// the template width for a head width dh <= 128
inline int padded_width(int dh) { return dh <= 16 ? 16 : dh <= 32 ? 32 : dh <= 64 ? 64 : 128; }

using mma::cp_async16;
using mma::cp_async_commit;
using mma::cp_async_wait;
using mma::ldmatrix_x4;
using mma::ldmatrix_x4_trans;
using mma::mma_bf16;
using mma::split_pair;

// e^x as 2^(x log2 e) on the SFU (ex2.approx, relative error ~2^-22; a
// result below 2^-126 flushes to 0): e^-inf = 0, e^0 = 1 exactly
__device__ __forceinline__ float exp_sfu(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x * 1.4426950408889634f));
  return y;
}

// The score of a key that needs no mask and is in range: the dot, scaled
// after it (the Score of a chunk whose rows and keys are all real and
// unmasked)
struct ScaleOnly {
  float scale;
  __device__ __forceinline__ float operator()(float acc, int, int) const {
    return __fmul_rn(acc, scale);
  }
};

// The masked fp32 score of query t and key j of attention over the [B, T, D]
// layout from the raw dot, in the TPU kernel's order: a key past S scores
// -inf (it weighs 0 even in a row whose keys are all masked), a masked one
// -FLT_MAX; mask is the key's additive fp32 mask (0 without one).
__device__ __forceinline__ float key_score(float acc, float scale, float mask, int t, int j,
                                           int S, int causal) {
  if (j >= S) return -INFINITY;
  const float s = __fmul_rn(acc, scale) + mask;  // scale after the dot, no FMA contraction
  return causal && j > t ? NEG_INF : s;
}

// columns c, c + 1 of a bf16 row as one A-fragment register; zeros past dh or
// for a missing row. pairs: the row is 4-byte aligned and dh is even.
__device__ __forceinline__ uint32_t load_pair(const __nv_bfloat16* row, int c, int dh,
                                              bool pairs) {
  if (row == nullptr || c >= dh) return 0u;
  if (pairs) return *reinterpret_cast<const uint32_t*>(row + c);
  const uint32_t lo = __bfloat16_as_ushort(row[c]);
  const uint32_t hi = c + 1 < dh ? __bfloat16_as_ushort(row[c + 1]) : 0u;
  return lo | (hi << 16);
}

__device__ __forceinline__ void store_pair(__nv_bfloat16* row, int c, int dh, bool pairs,
                                           float a, float b) {
  if (row == nullptr || c >= dh) return;
  if (pairs) {
    *reinterpret_cast<__nv_bfloat162*>(row + c) = __floats2bfloat162_rn(a, b);
    return;
  }
  row[c] = __float2bfloat16_rn(a);
  if (c + 1 < dh) row[c + 1] = __float2bfloat16_rn(b);
}

// The A fragments of 16 staged rows of a chunk (row stride row_stride(DHP)),
// the first of which is at rows: a[ks] holds columns 16 ks .. 16 ks + 15.
template <int DHP>
__device__ __forceinline__ void load_a_rows(uint32_t (&a)[DHP / 16][4],
                                            const __nv_bfloat16* rows) {
  const __nv_bfloat16* p = rows + mma::a_frag_offset(threadIdx.x & 31, row_stride(DHP));
#pragma unroll
  for (int ks = 0; ks < DHP / 16; ++ks) ldmatrix_x4(a[ks], p + ks * 16);
}

// s = A B^T for one chunk: A the warp's 16 rows x DHP as fragments, B the
// chunk's 64 staged rows x DHP (s[n] holds B rows 8 n .. 8 n + 7). Products
// of bf16 values are exact in fp32, so this is an fp32 dot in another order.
template <int DHP>
__device__ __forceinline__ void qk_chunk(float (&s)[8][4], const uint32_t (&a)[DHP / 16][4],
                                         const __nv_bfloat16* Bs) {
  constexpr int STR = row_stride(DHP);
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
  // the four 8x8 matrices of one ldmatrix: (rows 0-7, columns 0-7), (0-7,
  // 8-15), (8-15, 0-7), (8-15, 8-15) of a 16x16 block of B
  const __nv_bfloat16* bp = Bs + mma::b_frag_offset_nk(threadIdx.x & 31, STR);
#pragma unroll
  for (int ks = 0; ks < DHP / 16; ++ks) {
#pragma unroll
    for (int n2 = 0; n2 < 4; ++n2) {
      uint32_t b[4];
      ldmatrix_x4(b, bp + n2 * 16 * STR + ks * 16);
      mma_bf16(s[2 * n2], a[ks], b[0], b[1]);
      mma_bf16(s[2 * n2 + 1], a[ks], b[2], b[3]);
    }
  }
}

// o += p V for one chunk: p the fp32 C fragments of the warp's 16 rows x 64
// (as qk_chunk leaves them), split into bf16 hi + lo halves (two MMAs each:
// p kept to ~2^-17, where one bf16 rounding would cost 2^-9); V the chunk's
// 64 staged rows x DHP, transposed on the load.
template <int DHP>
__device__ __forceinline__ void pv_chunk(float (&o)[DHP / 8][4], const float (&p)[8][4],
                                         const __nv_bfloat16* Vs) {
  constexpr int STR = row_stride(DHP);
  // (rows 0-7, columns 0-7), (8-15, 0-7), (0-7, 8-15), (8-15, 8-15)
  const __nv_bfloat16* vp = Vs + mma::b_frag_offset_kn(threadIdx.x & 31, STR);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t ph[4], pl[4];
    split_pair(p[2 * kk][0], p[2 * kk][1], ph[0], pl[0]);
    split_pair(p[2 * kk][2], p[2 * kk][3], ph[1], pl[1]);
    split_pair(p[2 * kk + 1][0], p[2 * kk + 1][1], ph[2], pl[2]);
    split_pair(p[2 * kk + 1][2], p[2 * kk + 1][3], ph[3], pl[3]);
#pragma unroll
    for (int d2 = 0; d2 < DHP / 16; ++d2) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, vp + kk * 16 * STR + d2 * 16);
      mma_bf16(o[2 * d2], ph, b[0], b[1]);
      mma_bf16(o[2 * d2], pl, b[0], b[1]);
      mma_bf16(o[2 * d2 + 1], ph, b[2], b[3]);
      mma_bf16(o[2 * d2 + 1], pl, b[2], b[3]);
    }
  }
}

// One warp's 16 query rows: Q fragments, the output accumulator, and the
// running max and partial sum of the thread's rows g and g + 8.
template <int DHP>
struct WarpRows {
  static constexpr int KSTEPS = DHP / 16;  // k-steps of Q K^T over dh
  static constexpr int OTILES = DHP / 8;   // 8-column tiles of the output
  uint32_t qa[KSTEPS][4];
  float o[OTILES][4];
  float m[2];
  float l[2];

  // row_g, row_g8: rows g and g + 8 of q (null past Tq)
  __device__ __forceinline__ void start(const __nv_bfloat16* row_g, const __nv_bfloat16* row_g8,
                                        int dh, bool pairs) {
    const int tg = threadIdx.x & 3;
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks) {
      const int c = ks * 16 + 2 * tg;
      qa[ks][0] = load_pair(row_g, c, dh, pairs);
      qa[ks][1] = load_pair(row_g8, c, dh, pairs);
      qa[ks][2] = load_pair(row_g, c + 8, dh, pairs);
      qa[ks][3] = load_pair(row_g8, c + 8, dh, pairs);
    }
#pragma unroll
    for (int n = 0; n < OTILES; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
    m[0] = m[1] = NEG_INF;
    l[0] = l[1] = 0.f;
  }

  // true where one of the thread's real rows has seen no unmasked key yet
  // (its running max is still -FLT_MAX): such a row needs every key, since a
  // masked key weighs 1 there (the unpadded softmax of an all-masked row)
  __device__ __forceinline__ bool open(int t0, int Tq) const {
    const int g = (threadIdx.x & 31) >> 2;
    return (t0 + g < Tq && m[0] == NEG_INF) || (t0 + g + 8 < Tq && m[1] == NEG_INF);
  }

  // One chunk of 64 staged keys, the first of which is key k0. Ks, Vs: the
  // chunk's first row in shared memory. score(acc, r, j) -> the fp32 score of
  // the warp's row r (0..15) and key j from the raw dot acc.
  template <typename Score>
  __device__ __forceinline__ void attend(const __nv_bfloat16* Ks, const __nv_bfloat16* Vs,
                                         int k0, const Score& score) {
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2;
    const int tg = lane & 3;

    float s[8][4];
    qk_chunk<DHP>(s, qa, Ks);

    float mn[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float v = score(s[n][e], g + ((e >> 1) << 3), k0 + n * 8 + 2 * tg + (e & 1));
        s[n][e] = v;
        mn[e >> 1] = fmaxf(mn[e >> 1], v);
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mn[i] = fmaxf(mn[i], __shfl_xor_sync(0xffffffffu, mn[i], 1));
      mn[i] = fmaxf(mn[i], __shfl_xor_sync(0xffffffffu, mn[i], 2));
    }
    const float corr[2] = {exp_sfu(m[0] - mn[0]), exp_sfu(m[1] - mn[1])};
    m[0] = mn[0];
    m[1] = mn[1];
    l[0] *= corr[0];
    l[1] *= corr[1];
#pragma unroll
    for (int n = 0; n < OTILES; ++n) {
      o[n][0] *= corr[0];
      o[n][1] *= corr[0];
      o[n][2] *= corr[1];
      o[n][3] *= corr[1];
    }
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp_sfu(s[n][e] - mn[e >> 1]);
        s[n][e] = p;
        l[e >> 1] += p;
      }

    pv_chunk<DHP>(o, s, Vs);
  }

  // out_g, out_g8: rows g and g + 8 of the output (null: not stored). Every
  // lane of the warp calls this (the sums are reduced across lanes).
  __device__ __forceinline__ void finish(__nv_bfloat16* out_g, __nv_bfloat16* out_g8, int dh,
                                         bool pairs) {
    float sum[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      sum[i] = l[i] + __shfl_xor_sync(0xffffffffu, l[i], 1);
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 2);
    }
    const int tg = threadIdx.x & 3;
#pragma unroll
    for (int n = 0; n < OTILES; ++n) {
      const int c = n * 8 + 2 * tg;
      store_pair(out_g, c, dh, pairs, o[n][0] / sum[0], o[n][1] / sum[0]);
      store_pair(out_g8, c, dh, pairs, o[n][2] / sum[1], o[n][3] / sum[1]);
    }
  }
};

// Stages rows [j0, j0 + rows) of a [*, dh] bf16 matrix (row stride ld
// elements, from base) into shared memory at dst (row stride row_stride(DHP)):
// rows at or past S and columns at or past dh are zero. vec: base and ld
// allow 16-byte copies (cp.async, to be waited for by the caller);
// otherwise element loads. Called by every thread of the block.
template <int DHP>
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst, const __nv_bfloat16* base,
                                           long long ld, int j0, int rows, int S, int dh,
                                           bool vec) {
  constexpr int STR = row_stride(DHP);
  if (vec) {
    constexpr int CPR = DHP / 8;  // 16-byte chunks per row
    for (int idx = threadIdx.x; idx < rows * CPR; idx += blockDim.x) {
      const int r = idx / CPR;
      const int c = (idx - r * CPR) * 8;
      const int j = j0 + r;
      const bool ok = j < S && c < dh;
      cp_async16(dst + r * STR + c, ok ? base + j * ld + c : base, ok);
    }
  } else {
    const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);
    for (int idx = threadIdx.x; idx < rows * DHP; idx += blockDim.x) {
      const int r = idx / DHP;
      const int c = idx - r * DHP;
      const int j = j0 + r;
      dst[r * STR + c] = j < S && c < dh ? base[j * ld + c] : zero;
    }
  }
}

}  // namespace attention_mma
