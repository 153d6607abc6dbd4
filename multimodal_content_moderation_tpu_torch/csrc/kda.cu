// Kimi Delta Attention's core (ops/kda.py, models/kimi_linear.py) for Hopper
// (sm_90a): the gated delta rule with a decay per key channel over the
// packed kept tokens of a batch, chunked at 64 tokens, in four launches a
// KDA layer.
//
// Replaces no TPU kernel: the JAX package has no linear attention. Written
// because the recurrence has no library call on the card, and because in
// plain PyTorch the chunked form is some fifty launches a layer with its
// [C, C, dk] pairwise-decay temporaries in device memory.
//
// For N tokens, H heads of dk = dv = 128, C = H 128 (ops/kda.py's docstring
// has the equations):
//   kda_conv_kernel   a block a token: the causal depthwise convolution of
//                     q~ | k~ | v~ [N, 3C] over the tokens of the same row
//                     (taps before the row's first kept token are zero),
//                     SiLU, each head of q and k normalised (eps 1e-6 under
//                     the root), q scaled by dk^-0.5; bf16 out, one rounding.
//   kda_chunk_kernel  a block a (chunk, head): the decay g = -exp(A_log)
//                     softplus(f + dt_bias) and its cumulative sum Gamma in
//                     fp32, beta = sigmoid(b); A_kk and A_qk; the inverse
//                     T = (I + Diag(beta) A_kk)^-1 by forward substitution
//                     in fp32; w = T (beta K e^Gamma), u = T (beta V) on the
//                     tensor cores; Q e^Gamma, K e^(Gamma_last - Gamma),
//                     A_qk and e^Gamma_last for the next launch.
//   kda_state_kernel  a block a (row, head, half of dv): the chunks of the
//                     row in turn, the state S [dk, 64] in fp32 in shared
//                     memory (bf16 as an operand): v_new = u - w S, o = (Q
//                     e^Gamma) S + A_qk v_new, S <- Diag(e^Gamma_last) S +
//                     (K e^(Gamma_last - Gamma))^T v_new.
//   kda_out_kernel    a block a token: RMSNorm of each head's o (fp32 mean
//                     of squares), times the weight and sigmoid(gate).
//
// A strong decay. Inside a chunk Gamma may fall below -100 (a decay of -16
// a token is the init's largest rate), where the factorisation of
// exp(Gamma_i - Gamma_j) as (k_i e^Gamma_i)(k_j e^-Gamma_j) overflows. Here
// every exponent is a later minus an earlier cumulative decay, so at most
// 0: the diagonal 16 x 16 sub-blocks of A take exp(Gamma_i - Gamma_j) for
// each pair and channel; an off-diagonal sub-block (I > J) is a product on
// the tensor cores of (k_i e^(Gamma_i - Gamma_r)) and (k_j e^(Gamma_r -
// Gamma_j)), r the last token of sub-block I - 1, both factors at most 1; a
// factor that underflows to 0 stands for a product that is 0 in fp32 too.
//
// Bound on an H100 at the benchmark's batch (about 13,000 kept tokens, H 32):
// the recurrent form's 3 dk dv multiply-adds a token and head are 41 GFLOP a
// layer, 0.04 ms at 989 TFLOP/s; the core's bf16 inputs (q~, k~, v~, the
// decay's and the gate's pre-activations, beta's logits) read once and its
// output written once are 0.64 GB, 0.19 ms at 3.35 TB/s: bytes bound it. The
// chunked form does about 4x the recurrent operations (the intra-chunk
// products and the inverse) and passes w, u, Q e^Gamma, K e^(Gamma_last -
// Gamma) and A_qk through device memory once between the two chunk launches;
// the forward substitution's 63 dependent steps set the chunk launch's
// latency, so two blocks share each SM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
using namespace nvcuda;

constexpr int HD = 128;  // dk = dv
constexpr int CH = 64;   // tokens a chunk
constexpr int SUB = 16;  // a sub-block of the chunk: the tensor cores' tile
constexpr int TAPS = 4;
constexpr int LDP = 136;  // padded row (bf16) of the off-diagonal operands
constexpr int LDT = 72;   // padded row (bf16) of a 64-wide operand
constexpr int DV = 64;    // value columns a state block keeps

// kda_chunk_kernel's shared memory (bytes)
constexpr int C_G = 0;                      // Gamma fp32 [64][128]
constexpr int C_K = C_G + CH * HD * 4;      // k, then beta k e^Gamma, bf16 [64][128]
constexpr int C_Q = C_K + CH * HD * 2;      // q, then beta v, bf16 [64][128]
constexpr int C_AKK = C_Q + CH * HD * 2;    // A_kk, then T, then staging, fp32 [64][64]
constexpr int C_AQK = C_AKK + CH * CH * 4;  // A_qk fp32 [64][64], then T bf16 [64][72]
constexpr int C_OPS = C_AQK + CH * CH * 4;  // three bf16 [16][136] operands
constexpr int C_BETA = C_OPS + 3 * SUB * LDP * 2;
constexpr int CHUNK_SMEM = C_BETA + CH * 4;

// kda_state_kernel's shared memory (bytes)
constexpr int S_S = 0;                       // S fp32 [128][64]
constexpr int S_SB = S_S + HD * DV * 4;      // S bf16 [128][72]
constexpr int S_W = S_SB + HD * LDT * 2;     // w bf16 [64][128]
constexpr int S_QG = S_W + CH * HD * 2;      // Q e^Gamma
constexpr int S_KG = S_QG + CH * HD * 2;     // K e^(Gamma_last - Gamma)
constexpr int S_VN = S_KG + CH * HD * 2;     // v_new bf16 [64][72]
constexpr int S_A = S_VN + CH * LDT * 2;     // A_qk bf16 [64][72]
constexpr int S_ST = S_A + CH * LDT * 2;     // staging fp32 8 x [16][16]
constexpr int S_GL = S_ST + 8 * SUB * SUB * 4;
constexpr int STATE_SMEM = S_GL + HD * 4;

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragAc = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using FragBc = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

__device__ __forceinline__ void load4(const bf16* p, float* f) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
  const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
  f[0] = a.x;
  f[1] = a.y;
  f[2] = b.x;
  f[3] = b.y;
}

__device__ __forceinline__ void store4(bf16* p, const float* f) {
  uint2 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
  h[0] = __floats2bfloat162_rn(f[0], f[1]);
  h[1] = __floats2bfloat162_rn(f[2], f[3]);
  *reinterpret_cast<uint2*>(p) = u;
}

__global__ void __launch_bounds__(256)
kda_conv_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                const long long* __restrict__ row, bf16* __restrict__ out, int H, float q_scale) {
  const long long n = blockIdx.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long C3 = 3LL * H * HD;
  const long long rn = row[n];
  int taps = 1;  // the token itself and the earlier tokens of its row, up to TAPS
  while (taps < TAPS && n >= taps && row[n - taps] == rn) ++taps;
  for (int gi = warp; gi < 3 * H; gi += 8) {
    const long long c0 = static_cast<long long>(gi) * HD + lane * 4;
    float wt[4][TAPS];
    {
      const uint4* wp = reinterpret_cast<const uint4*>(w + c0 * TAPS);
      const uint4 a = wp[0], b = wp[1];
      const bf16* ha = reinterpret_cast<const bf16*>(&a);
      const bf16* hb = reinterpret_cast<const bf16*>(&b);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int t = 0; t < TAPS; ++t) {
          wt[i][t] = to_f(ha[i * TAPS + t]);
          wt[i + 2][t] = to_f(hb[i * TAPS + t]);
        }
    }
    float acc[4], xv[4];
    load4(x + n * C3 + c0, xv);
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[i] = xv[i] * wt[i][TAPS - 1];
    for (int j = 1; j < taps; ++j) {
      load4(x + (n - j) * C3 + c0, xv);
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i] += xv[i] * wt[i][TAPS - 1 - j];
    }
    float ss = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      acc[i] = acc[i] / (1.f + expf(-acc[i]));
      ss += acc[i] * acc[i];
    }
    if (gi < 2 * H) {
      ss = warp_sum(ss);
      const float r = rsqrtf(ss + 1e-6f);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc[i] *= r;
        if (gi < H) acc[i] *= q_scale;
      }
    }
    store4(out + n * C3 + c0, acc);
  }
}

__global__ void __launch_bounds__(256, 2)
kda_chunk_kernel(const bf16* __restrict__ x, const bf16* __restrict__ f,
                 const bf16* __restrict__ b, int b_stride, const bf16* __restrict__ a_log,
                 const bf16* __restrict__ dt_bias, const int* __restrict__ starts,
                 const int* __restrict__ chunks, int B, int H, bf16* __restrict__ w_out,
                 bf16* __restrict__ u_out, bf16* __restrict__ qg_out, bf16* __restrict__ kg_out,
                 bf16* __restrict__ aqk_out, float* __restrict__ gl_out) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* G = reinterpret_cast<float*>(smem + C_G);
  bf16* K = reinterpret_cast<bf16*>(smem + C_K);
  bf16* Q = reinterpret_cast<bf16*>(smem + C_Q);
  float* Akk = reinterpret_cast<float*>(smem + C_AKK);
  float* Aqk = reinterpret_cast<float*>(smem + C_AQK);
  bf16* Kd = reinterpret_cast<bf16*>(smem + C_OPS);
  bf16* Qd = Kd + SUB * LDP;
  bf16* Kj = Qd + SUB * LDP;
  float* beta = reinterpret_cast<float*>(smem + C_BETA);
  const int c = blockIdx.x, h = blockIdx.y, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  if (c >= chunks[B]) return;
  int lo = 0, hi = B;  // the row: chunks[lo] <= c < chunks[lo + 1]
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (chunks[mid] <= c) lo = mid; else hi = mid;
  }
  const long long t0 = starts[lo] + static_cast<long long>(c - chunks[lo]) * CH;
  const int len = min(CH, static_cast<int>(starts[lo + 1] - t0));
  const long long C = static_cast<long long>(H) * HD, C3 = 3 * C;
  const long long col = static_cast<long long>(h) * HD;

  for (int i = tid; i < CH * HD / 8; i += 256) {
    const int t = i / (HD / 8), v = i % (HD / 8);
    uint4 qv = make_uint4(0, 0, 0, 0), kv = qv;
    if (t < len) {
      const bf16* p = x + (t0 + t) * C3 + col + v * 8;
      qv = *reinterpret_cast<const uint4*>(p);
      kv = *reinterpret_cast<const uint4*>(p + C);
    }
    *reinterpret_cast<uint4*>(Q + t * HD + v * 8) = qv;
    *reinterpret_cast<uint4*>(K + t * HD + v * 8) = kv;
  }
  if (tid < HD) {
    // the decay and its cumulative sum: a thread a channel
    const float a = -expf(to_f(a_log[h]));
    const float bias = to_f(dt_bias[col + tid]);
    float acc = 0.f;
    for (int t = 0; t < CH; ++t) {
      float g = 0.f;
      if (t < len) {
        const float z = to_f(f[(t0 + t) * C + col + tid]) + bias;
        g = a * (z > 20.f ? z : log1pf(expf(z)));
      }
      acc += g;
      G[t * HD + tid] = acc;
    }
  } else if (tid < HD + CH) {
    const int t = tid - HD;
    beta[t] = t < len ? 1.f / (1.f + expf(-to_f(b[(t0 + t) * b_stride + h]))) : 0.f;
  }
  for (int i = tid; i < CH * CH; i += 256) {
    Akk[i] = 0.f;
    Aqk[i] = 0.f;
  }
  __syncthreads();

  // the diagonal sub-blocks: a pair (i >= j) a thread, exp of each channel's
  // difference (the channel order turned by the thread: no bank conflicts)
  for (int p = tid; p < 4 * (SUB * (SUB + 1) / 2); p += 256) {
    const int blk = p / (SUB * (SUB + 1) / 2);
    int q = p % (SUB * (SUB + 1) / 2), i = 0;
    while (q > i) {
      q -= i + 1;
      ++i;
    }
    const int ti = blk * SUB + i, tj = blk * SUB + q;
    float kk = 0.f, qk = 0.f;
    for (int cc = 0; cc < HD; ++cc) {
      const int ch = (cc + tid) & (HD - 1);
      const float kj = to_f(K[tj * HD + ch]) * __expf(G[ti * HD + ch] - G[tj * HD + ch]);
      kk += to_f(K[ti * HD + ch]) * kj;
      qk += to_f(Q[ti * HD + ch]) * kj;
    }
    Aqk[ti * CH + tj] = qk;
    if (q < i) Akk[ti * CH + tj] = kk;
  }
  // the off-diagonal sub-blocks on the tensor cores, decayed to the last
  // token r of the sub-block before I: both factors at most 1
  for (int I = 1; I < CH / SUB; ++I) {
    const int r = SUB * I - 1;
    for (int e = tid; e < SUB * HD; e += 256) {
      const int i = e / HD, ch = e % HD, t = SUB * I + i;
      const float d = __expf(G[t * HD + ch] - G[r * HD + ch]);
      Kd[i * LDP + ch] = __float2bfloat16(to_f(K[t * HD + ch]) * d);
      Qd[i * LDP + ch] = __float2bfloat16(to_f(Q[t * HD + ch]) * d);
    }
    for (int J = 0; J < I; ++J) {
      for (int e = tid; e < SUB * HD; e += 256) {
        const int j = e / HD, ch = e % HD, t = SUB * J + j;
        Kj[j * LDP + ch] =
            __float2bfloat16(to_f(K[t * HD + ch]) * __expf(G[r * HD + ch] - G[t * HD + ch]));
      }
      __syncthreads();
      if (warp < 2) {
        FragA fa;
        FragBc fb;
        FragC acc;
        wmma::fill_fragment(acc, 0.f);
        const bf16* A = warp == 0 ? Kd : Qd;
#pragma unroll
        for (int kk = 0; kk < HD; kk += 16) {
          wmma::load_matrix_sync(fa, A + kk, LDP);
          wmma::load_matrix_sync(fb, Kj + kk, LDP);
          wmma::mma_sync(acc, fa, fb, acc);
        }
        float* dst = (warp == 0 ? Akk : Aqk) + SUB * I * CH + SUB * J;
        wmma::store_matrix_sync(dst, acc, CH, wmma::mem_row_major);
      }
      __syncthreads();
    }
  }

  // what kda_state reads that needs no inverse
  const long long cb = static_cast<long long>(c) * H + h;
  bf16* aq = aqk_out + cb * CH * CH;
  for (int e = tid; e < CH * CH; e += 256) aq[e] = __float2bfloat16(Aqk[e]);
  if (tid < HD) gl_out[cb * HD + tid] = expf(G[(CH - 1) * HD + tid]);
  for (int e = tid; e < CH * HD; e += 256) {
    const int t = e / HD, ch = e % HD;
    if (t < len) {
      const float g = G[e];
      const long long o = (t0 + t) * C + col + ch;
      qg_out[o] = __float2bfloat16(to_f(Q[e]) * expf(g));
      kg_out[o] = __float2bfloat16(to_f(K[e]) * expf(G[(CH - 1) * HD + ch] - g));
    }
  }
  __syncthreads();

  // T = (I + Diag(beta) A_kk)^-1, strictly lower, in place of A_kk: row i
  // from the rows before it, four threads a column
  {
    const int j = tid >> 2, part = tid & 3;
    for (int i = 1; i < CH; ++i) {
      float s = 0.f;
      if (j < i)
        for (int m = j + 1 + part; m < i; m += 4) s += Akk[i * CH + m] * Akk[m * CH + j];
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      __syncthreads();
      if (j < i && part == 0) Akk[i * CH + j] = -beta[i] * (Akk[i * CH + j] + s);
      __syncthreads();
    }
  }
  bf16* Tb = reinterpret_cast<bf16*>(smem + C_AQK);
  for (int e = tid; e < CH * CH; e += 256) {
    const int i = e / CH, j = e % CH;
    Tb[i * LDT + j] = __float2bfloat16(j < i ? Akk[e] : (j == i ? 1.f : 0.f));
  }
  for (int e = tid; e < CH * HD; e += 256) {
    const int t = e / HD, ch = e % HD;
    const float bt = beta[t];
    K[e] = __float2bfloat16(bt * to_f(K[e]) * expf(G[e]));
    Q[e] = __float2bfloat16(t < len ? bt * to_f(x[(t0 + t) * C3 + 2 * C + col + ch]) : 0.f);
  }
  __syncthreads();

  // w = T (beta K e^Gamma), u = T (beta V): 2 x 32 tiles, 8 a warp
  float* stage = Akk + warp * SUB * SUB;
  for (int q = 0; q < 8; ++q) {
    const int tile = warp * 8 + q, which = tile / 32, rt = (tile % 32) / 8, ct = tile % 8;
    const bf16* rhs = which ? Q : K;
    FragA fa;
    FragB fb;
    FragC acc;
    wmma::fill_fragment(acc, 0.f);
#pragma unroll
    for (int kk = 0; kk < CH; kk += 16) {
      wmma::load_matrix_sync(fa, Tb + rt * SUB * LDT + kk, LDT);
      wmma::load_matrix_sync(fb, rhs + kk * HD + ct * SUB, HD);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    wmma::store_matrix_sync(stage, acc, SUB, wmma::mem_row_major);
    __syncwarp();
    bf16* dst = which ? u_out : w_out;
    for (int e = lane; e < SUB * SUB; e += 32) {
      const int t = rt * SUB + e / SUB;
      if (t < len) dst[(t0 + t) * C + col + ct * SUB + e % SUB] = __float2bfloat16(stage[e]);
    }
    __syncwarp();
  }
}

__global__ void __launch_bounds__(256, 1)
kda_state_kernel(const bf16* __restrict__ w, const bf16* __restrict__ u,
                 const bf16* __restrict__ qg, const bf16* __restrict__ kg,
                 const bf16* __restrict__ aqk, const float* __restrict__ gl,
                 const int* __restrict__ starts, const int* __restrict__ chunks, int H,
                 bf16* __restrict__ o) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* S = reinterpret_cast<float*>(smem + S_S);
  bf16* Sb = reinterpret_cast<bf16*>(smem + S_SB);
  bf16* W = reinterpret_cast<bf16*>(smem + S_W);
  bf16* QG = reinterpret_cast<bf16*>(smem + S_QG);
  bf16* KG = reinterpret_cast<bf16*>(smem + S_KG);
  bf16* Vn = reinterpret_cast<bf16*>(smem + S_VN);
  bf16* A = reinterpret_cast<bf16*>(smem + S_A);
  float* GL = reinterpret_cast<float*>(smem + S_GL);
  const int r = blockIdx.x, h = blockIdx.y, v0 = blockIdx.z * DV, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  float* stage = reinterpret_cast<float*>(smem + S_ST) + warp * SUB * SUB;
  const int c0 = chunks[r], c1 = chunks[r + 1];
  if (c0 == c1) return;
  const long long C = static_cast<long long>(H) * HD;
  const long long col = static_cast<long long>(h) * HD;
  for (int e = tid; e < HD * DV; e += 256) {
    S[e] = 0.f;
    Sb[(e / DV) * LDT + e % DV] = __float2bfloat16(0.f);
  }
  for (int c = c0; c < c1; ++c) {
    const long long t0 = starts[r] + static_cast<long long>(c - c0) * CH;
    const int len = min(CH, static_cast<int>(starts[r + 1] - t0));
    for (int i = tid; i < CH * HD / 8; i += 256) {
      const int t = i / (HD / 8), v = i % (HD / 8);
      uint4 a = make_uint4(0, 0, 0, 0), b = a, d = a;
      if (t < len) {
        const long long p = (t0 + t) * C + col + v * 8;
        a = *reinterpret_cast<const uint4*>(w + p);
        b = *reinterpret_cast<const uint4*>(qg + p);
        d = *reinterpret_cast<const uint4*>(kg + p);
      }
      *reinterpret_cast<uint4*>(W + t * HD + v * 8) = a;
      *reinterpret_cast<uint4*>(QG + t * HD + v * 8) = b;
      *reinterpret_cast<uint4*>(KG + t * HD + v * 8) = d;
    }
    const long long cb = static_cast<long long>(c) * H + h;
    for (int i = tid; i < CH * CH / 8; i += 256) {
      const int t = i / (CH / 8), v = i % (CH / 8);
      *reinterpret_cast<uint4*>(A + t * LDT + v * 8) =
          *reinterpret_cast<const uint4*>(aqk + cb * CH * CH + t * CH + v * 8);
    }
    if (tid < HD) GL[tid] = gl[cb * HD + tid];
    __syncthreads();

    // v_new = u - w S: 16 tiles, 2 a warp
    for (int q = 0; q < 2; ++q) {
      const int tile = warp * 2 + q, rt = tile / 4, ct = tile % 4;
      FragA fa;
      FragB fb;
      FragC acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int kk = 0; kk < HD; kk += 16) {
        wmma::load_matrix_sync(fa, W + rt * SUB * HD + kk, HD);
        wmma::load_matrix_sync(fb, Sb + kk * LDT + ct * SUB, LDT);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(stage, acc, SUB, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < SUB * SUB; e += 32) {
        const int t = rt * SUB + e / SUB, v = ct * SUB + e % SUB;
        const float val = t < len ? to_f(u[(t0 + t) * C + col + v0 + v]) - stage[e] : 0.f;
        Vn[t * LDT + v] = __float2bfloat16(val);
      }
      __syncwarp();
    }
    __syncthreads();

    // o = (Q e^Gamma) S + A_qk v_new
    for (int q = 0; q < 2; ++q) {
      const int tile = warp * 2 + q, rt = tile / 4, ct = tile % 4;
      FragA fa;
      FragB fb;
      FragC acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int kk = 0; kk < HD; kk += 16) {
        wmma::load_matrix_sync(fa, QG + rt * SUB * HD + kk, HD);
        wmma::load_matrix_sync(fb, Sb + kk * LDT + ct * SUB, LDT);
        wmma::mma_sync(acc, fa, fb, acc);
      }
#pragma unroll
      for (int kk = 0; kk < CH; kk += 16) {
        wmma::load_matrix_sync(fa, A + rt * SUB * LDT + kk, LDT);
        wmma::load_matrix_sync(fb, Vn + kk * LDT + ct * SUB, LDT);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(stage, acc, SUB, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < SUB * SUB; e += 32) {
        const int t = rt * SUB + e / SUB;
        if (t < len) o[(t0 + t) * C + col + v0 + ct * SUB + e % SUB] = __float2bfloat16(stage[e]);
      }
      __syncwarp();
    }

    // S <- Diag(e^Gamma_last) S + (K e^(Gamma_last - Gamma))^T v_new: 32
    // tiles, 4 a warp
    for (int e = tid; e < HD * DV; e += 256) S[e] *= GL[e / DV];
    __syncthreads();
    for (int q = 0; q < 4; ++q) {
      const int tile = warp * 4 + q, rt = tile / 4, ct = tile % 4;
      FragAc fa;
      FragB fb;
      FragC acc;
      wmma::load_matrix_sync(acc, S + rt * SUB * DV + ct * SUB, DV, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < CH; kk += 16) {
        wmma::load_matrix_sync(fa, KG + kk * HD + rt * SUB, HD);
        wmma::load_matrix_sync(fb, Vn + kk * LDT + ct * SUB, LDT);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(S + rt * SUB * DV + ct * SUB, acc, DV, wmma::mem_row_major);
    }
    __syncthreads();
    for (int e = tid; e < HD * DV; e += 256) Sb[(e / DV) * LDT + e % DV] = __float2bfloat16(S[e]);
    __syncthreads();
  }
}

__global__ void __launch_bounds__(256)
kda_out_kernel(const bf16* __restrict__ o, const bf16* __restrict__ gate,
               const bf16* __restrict__ w, bf16* __restrict__ y, int H, float eps) {
  const long long n = blockIdx.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long C = static_cast<long long>(H) * HD;
  float wv[4];
  load4(w + lane * 4, wv);
  for (int hh = warp; hh < H; hh += 8) {
    const long long p = n * C + static_cast<long long>(hh) * HD + lane * 4;
    float ov[4], gv[4];
    load4(o + p, ov);
    load4(gate + p, gv);
    float ss = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) ss += ov[i] * ov[i];
    const float r = rsqrtf(warp_sum(ss) / HD + eps);
#pragma unroll
    for (int i = 0; i < 4; ++i) ov[i] = ov[i] * r * wv[i] * (1.f / (1.f + expf(-gv[i])));
    store4(y + p, ov);
  }
}

cudaError_t allow_smem() {
  static bool done = false;  // the dynamic shared memory, above 48 KB, allowed once
  if (done) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(kda_chunk_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, CHUNK_SMEM);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kda_state_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             STATE_SMEM);
  done = e == cudaSuccess;
  return e;
}

}  // namespace

// x: bf16 [N, 3 H 128] q~ | k~ | v~; w: bf16 [3 H 128, 4]; row: int64 [N], each
// token's row (the tokens of a row consecutive); out: bf16 [N, 3 H 128].
extern "C" int kda_conv_launch(const void* x, const void* w, const void* row, void* out, int N,
                               int H, float q_scale, void* stream) {
  if (N <= 0 || H <= 0) return cudaErrorInvalidValue;
  kda_conv_kernel<<<N, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w),
      static_cast<const long long*>(row), static_cast<bf16*>(out), H, q_scale);
  return static_cast<int>(cudaGetLastError());
}

// x: kda_conv's output; f: bf16 [N, H 128]; b: bf16 rows of b_stride elements,
// beta's logits in the first H; a_log bf16 [H]; dt_bias bf16 [H 128]; starts,
// chunks: int32 [B + 1]; bound >= chunks[B]. Out: w, u, qg, kg bf16 [N, H 128];
// aqk bf16 [bound, H, 64, 64]; gl fp32 [bound, H, 128].
extern "C" int kda_chunk_launch(const void* x, const void* f, const void* b, int b_stride,
                                const void* a_log, const void* dt_bias, const void* starts,
                                const void* chunks, int B, int bound, int H, void* w, void* u,
                                void* qg, void* kg, void* aqk, void* gl, void* stream) {
  if (B <= 0 || bound <= 0 || H <= 0 || H > 65535) return cudaErrorInvalidValue;
  const cudaError_t e = allow_smem();
  if (e != cudaSuccess) return static_cast<int>(e);
  kda_chunk_kernel<<<dim3(bound, H), 256, CHUNK_SMEM, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(f), static_cast<const bf16*>(b),
      b_stride, static_cast<const bf16*>(a_log), static_cast<const bf16*>(dt_bias),
      static_cast<const int*>(starts), static_cast<const int*>(chunks), B, H,
      static_cast<bf16*>(w), static_cast<bf16*>(u), static_cast<bf16*>(qg),
      static_cast<bf16*>(kg), static_cast<bf16*>(aqk), static_cast<float*>(gl));
  return static_cast<int>(cudaGetLastError());
}

// kda_chunk's outputs; o: bf16 [N, H 128].
extern "C" int kda_state_launch(const void* w, const void* u, const void* qg, const void* kg,
                                const void* aqk, const void* gl, const void* starts,
                                const void* chunks, int B, int H, void* o, void* stream) {
  if (B <= 0 || H <= 0 || H > 65535) return cudaErrorInvalidValue;
  const cudaError_t e = allow_smem();
  if (e != cudaSuccess) return static_cast<int>(e);
  kda_state_kernel<<<dim3(B, H, HD / DV), 256, STATE_SMEM, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(w), static_cast<const bf16*>(u), static_cast<const bf16*>(qg),
      static_cast<const bf16*>(kg), static_cast<const bf16*>(aqk), static_cast<const float*>(gl),
      static_cast<const int*>(starts), static_cast<const int*>(chunks), H, static_cast<bf16*>(o));
  return static_cast<int>(cudaGetLastError());
}

// o, gate: bf16 [N, H 128]; w: bf16 [128]; y: bf16 [N, H 128].
extern "C" int kda_out_launch(const void* o, const void* gate, const void* w, void* y, int N,
                              int H, float eps, void* stream) {
  if (N <= 0 || H <= 0) return cudaErrorInvalidValue;
  kda_out_kernel<<<N, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(o), static_cast<const bf16*>(gate), static_cast<const bf16*>(w),
      static_cast<bf16*>(y), H, eps);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
