// Fused uint8 patch embed for Hopper (sm_90a). Two kernels: a bf16-output
// one on the tensor cores (patch_embed_u8_mma_launch), and a SIMT one
// (patch_embed_u8_launch) for the fp32 output, the parity path.
//
// Replaces: multimodal_content_moderation_tpu/ops/pallas_image.py,
//   patch_embed_u8 (body _embed_kernel).
//
// Computes out[r, n] = sum_k float(x_u8[r, k]) * w[k, n] + b[n], written in
// the output type (fp32 or bf16). w and b are the normalisation-folded fp32
// weight and bias (fold_norm_into_embed), so the per-pixel (x/255 - mean)/std
// costs nothing here.
//
// Bound on an H100, at the ViT-B/32 eval path (B=144: R = 7056 rows,
// K = 3072, D = 768): the product is 2 R K D = 33.3 GFLOP against about
// 42 MB of HBM traffic (12.5 us). On the fp32 SIMT units (67 TFLOP/s) that
// is 0.50 ms, bound by operations; at the bf16 tensor-core rate (989
// TFLOP/s) 0.034 ms, still above the bytes.
//
// bf16 design (tensor cores: mma.sync m16n8k16, bf16 in, fp32 accumulate;
// the generic pieces are in mma_common.cuh). Every u8 value is exact in
// bf16. The fp32 weight is split into hi = bf16(w) and lo = bf16(w - hi),
// which keeps it to ~2^-17 relative, and each k-step is two products, x hi
// and x lo, each exact in fp32: the result differs from the fp32 reference
// by the residual below lo and the order of the sums, far inside the bf16
// output's rounding. That is 4 R K D operations (0.067 ms at CLIP eval).
// Each block owns a 128 x 128 output tile and walks K in steps of 32 with 8
// warps, each a 64 x 32 tile of the output:
//  - a ring of 3 stages holds the raw u8 rows [128][32] and fp32 weight rows
//    [32][128], filled with 16-byte cp.async two k-steps ahead;
//  - when a stage has landed, the block widens its u8 tile into a bf16 tile
//    and splits its weight tile into bf16 hi and lo tiles (rows padded by
//    16 bytes, so the 8 rows of every ldmatrix fall on distinct banks): the
//    split happens once per weight element per block, inside the kernel, so
//    a weight that changes every training step costs no extra pass;
//  - the warps read A fragments with ldmatrix and B fragments with
//    ldmatrix.trans from those tiles and accumulate in fp32 registers;
//  - the epilogue adds the fp32 bias and rounds to bf16 once.
// What bounds it: shared-memory traffic, ~250 bytes per MMA (ldmatrix from
// four warps per tile, the conversion pass, the copies) against an SM's 128
// bytes a clock, more than the MMAs' own time (an H100 run with one part of
// the kernel removed at a time agreed). A Hopper design with wgmma reading
// both operands from shared memory, and the weight split once per call, is
// later work.
// Ragged R, D and K are masked in the kernel (zero-filled rows, columns and
// k tail); nothing is padded on the host. Rows whose length K is not a
// multiple of 16 (or a weight whose D is not a multiple of 4, or unaligned
// memory) are staged element by element.
//
// SIMT design (the fp32 output): a shared-memory tiled GEMM. Each block owns
// a 64x64 output tile and walks K in steps of 32. The u8 tile is widened to
// fp32 on its way into shared memory; 256 threads each accumulate a 4x4
// micro-tile with fp32 FMA; the bias is added in the epilogue before the
// cast. Ragged row, column and K edges are masked in the kernel. It is
// templated on the output type; the bf16 instance is reachable only
// through patch_embed_u8_launch with out_is_bf16 = 1, which the port's
// wrapper asks for only as the uncounted yardstick (chip_smoke.py times it
// as the earlier design).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "mma_common.cuh"

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 32;
constexpr int THREADS = 256;

__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename OutT>
__global__ void __launch_bounds__(THREADS)
patch_embed_u8_kernel(const uint8_t* __restrict__ x, const float* __restrict__ w,
                      const float* __restrict__ b, OutT* __restrict__ out,
                      int R, int K, int D) {
  __shared__ float As[BK][BM + 4];  // As[k][m]: the widened u8 tile, transposed
  __shared__ float Bs[BK][BN + 4];  // Bs[k][n]

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // column group: columns tx*4 .. tx*4+3
  const int ty = tid / 16;  // row group: rows ty*4 .. ty*4+3
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;

  // loaders: A as 64 rows x 4 chunks of 8 bytes; B as 32 rows x 8 chunks of 8 floats
  const int a_row = tid / 4;
  const int a_k = (tid % 4) * 8;
  const int b_k = tid / 8;
  const int b_n = (tid % 8) * 8;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    {
      const int r = m0 + a_row;
      const uint8_t* src = x + (size_t)r * K + k0 + a_k;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int k = k0 + a_k + e;
        As[a_k + e][a_row] = (r < R && k < K) ? (float)src[e] : 0.f;
      }
    }
    {
      const int k = k0 + b_k;
      const float* src = w + (size_t)k * D + n0 + b_n;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int n = n0 + b_n + e;
        Bs[b_k][b_n + e] = (k < K && n < D) ? src[e] : 0.f;
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[4], bb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bb[j] = Bs[kk][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bb[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = m0 + ty * 4 + i;
    if (r >= R) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < D) store_out(out + (size_t)r * D + n, acc[i][j] + b[n]);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 output on the tensor cores
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int MMA_BM = 128;        // output rows per block
constexpr int MMA_BN = 128;        // output columns per block
constexpr int MMA_BK = 32;         // k per stage
constexpr int MMA_THREADS = 256;   // 8 warps: 2 along the rows, 4 along the columns
constexpr int A_STR = MMA_BK + 8;  // bf16 row stride of the widened u8 tile
constexpr int W_STR = MMA_BN + 8;  // bf16 row stride of the hi / lo weight tiles

constexpr int MMA_STAGES = 3;      // raw stages in the ring

// shared memory of the bf16 kernel, in bytes: the raw ring, then the tiles
struct EmbedSmem {
  static constexpr int RAW_A = MMA_BM * MMA_BK;      // a u8 stage
  static constexpr int RAW_W = MMA_BK * MMA_BN * 4;  // an fp32 weight stage
  static constexpr int RAW = RAW_A + RAW_W;
  static constexpr int A_BF16 = MMA_BM * A_STR * 2;  // the widened u8 tile
  static constexpr int W_BF16 = MMA_BK * W_STR * 2;  // one of the hi / lo tiles
  static constexpr int BYTES = MMA_STAGES * RAW + A_BF16 + 2 * W_BF16;  // 87 KB: 2 blocks an SM
};

// 16 u8 values -> 16 bf16 (exact), in order
__device__ __forceinline__ uint4 widen8(uint32_t w0, uint32_t w1) {
  uint32_t r[4];
  const uint32_t w[2] = {w0, w1};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    r[2 * i] = mma::bits(__floats2bfloat162_rn(static_cast<float>(w[i] & 0xffu),
                                               static_cast<float>((w[i] >> 8) & 0xffu)));
    r[2 * i + 1] = mma::bits(__floats2bfloat162_rn(static_cast<float>((w[i] >> 16) & 0xffu),
                                                   static_cast<float>(w[i] >> 24)));
  }
  return make_uint4(r[0], r[1], r[2], r[3]);
}

__global__ void __launch_bounds__(MMA_THREADS, 2)
patch_embed_u8_mma_kernel(const uint8_t* __restrict__ x, const float* __restrict__ w,
                          const float* __restrict__ b, bf16* __restrict__ out, int R, int K,
                          int D, int vec_a, int vec_w, int pairs) {
  using L = EmbedSmem;
  constexpr int MT = MMA_BM / 32;                // 16-row tiles per warp
  constexpr int W_CHUNKS = MMA_BK * MMA_BN / 4;  // 16-byte chunks of a weight stage
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ab = reinterpret_cast<bf16*>(smem_raw + MMA_STAGES * L::RAW);  // [128][A_STR]
  bf16* Wh = Ab + MMA_BM * A_STR;                                      // [32][W_STR]
  bf16* Wl = Wh + MMA_BK * W_STR;                                      // [32][W_STR]

  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * MMA_BM;
  const int n0 = blockIdx.x * MMA_BN;

  // raw stage `stage`: rows m0.. of x at k0.. (u8), rows k0.. of w at n0..
  // (fp32), zero past R, K and D
  auto load_stage = [&](int stage, int k0) {
    uint8_t* ra = smem_raw + stage * L::RAW;
    float* rw = reinterpret_cast<float*>(ra + L::RAW_A);
    if (vec_a) {
      for (int c = tid; c < MMA_BM * 2; c += MMA_THREADS) {
        const int r = c >> 1;
        const int k = k0 + ((c & 1) << 4);
        const bool ok = m0 + r < R && k < K;
        mma::cp_async16(ra + (c << 4), ok ? x + (size_t)(m0 + r) * K + k : x, ok);
      }
    } else {
      for (int i = tid; i < MMA_BM * MMA_BK; i += MMA_THREADS) {
        const int r = i / MMA_BK;
        const int k = k0 + i % MMA_BK;
        ra[i] = m0 + r < R && k < K ? x[(size_t)(m0 + r) * K + k] : uint8_t(0);
      }
    }
    if (vec_w) {
      for (int c = tid; c < W_CHUNKS; c += MMA_THREADS) {
        const int r = c / (MMA_BN / 4);
        const int n = n0 + (c % (MMA_BN / 4)) * 4;
        const bool ok = k0 + r < K && n < D;
        mma::cp_async16(rw + c * 4, ok ? w + (size_t)(k0 + r) * D + n : w, ok);
      }
    } else {
      for (int i = tid; i < MMA_BK * MMA_BN; i += MMA_THREADS) {
        const int r = i / MMA_BN;
        const int n = n0 + i % MMA_BN;
        rw[i] = k0 + r < K && n < D ? w[(size_t)(k0 + r) * D + n] : 0.f;
      }
    }
  };

  // a landed raw stage -> the bf16 tiles: u8 widened, the weight split hi + lo
  auto convert = [&](int stage) {
    const uint8_t* ra = smem_raw + stage * L::RAW;
    const float* rw = reinterpret_cast<const float*>(ra + L::RAW_A);
    for (int c = tid; c < MMA_BM * 2; c += MMA_THREADS) {
      const uint4 v = *reinterpret_cast<const uint4*>(ra + (c << 4));
      bf16* dst = Ab + (c >> 1) * A_STR + ((c & 1) << 4);
      *reinterpret_cast<uint4*>(dst) = widen8(v.x, v.y);
      *reinterpret_cast<uint4*>(dst + 8) = widen8(v.z, v.w);
    }
    for (int c = tid; c < W_CHUNKS; c += MMA_THREADS) {
      const float4 v = *reinterpret_cast<const float4*>(rw + c * 4);
      const int off = (c / (MMA_BN / 4)) * W_STR + (c % (MMA_BN / 4)) * 4;
      uint2 hi, lo;
      mma::split_pair(v.x, v.y, hi.x, lo.x);
      mma::split_pair(v.z, v.w, hi.y, lo.y);
      *reinterpret_cast<uint2*>(Wh + off) = hi;
      *reinterpret_cast<uint2*>(Wl + off) = lo;
    }
  };

  const int warp = tid / 32;
  const int lane = tid & 31;
  const int wm = warp / 4;  // rows 64 wm ..
  const int wn = warp % 4;  // columns 32 wn ..
  float acc[MT][4][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  const bf16* a_base = Ab + wm * (MMA_BM / 2) * A_STR + mma::a_frag_offset(lane, A_STR);
  const int b_off = wn * 32 + mma::b_frag_offset_kn(lane, W_STR);

  const int ktiles = (K + MMA_BK - 1) / MMA_BK;
#pragma unroll
  for (int st = 0; st < MMA_STAGES - 1; ++st) {
    if (st < ktiles) load_stage(st, st * MMA_BK);
    mma::cp_async_commit();
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    mma::cp_async_wait<MMA_STAGES - 2>();  // stage kt has landed (this thread's copies)
    __syncthreads();  // everyone's copies; the bf16 tiles and stage kt - 1 are free
    const int next = kt + MMA_STAGES - 1;
    if (next < ktiles) load_stage(next % MMA_STAGES, next * MMA_BK);
    mma::cp_async_commit();
    convert(kt % MMA_STAGES);
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < MMA_BK / 16; ++ks) {
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) mma::ldmatrix_x4(a[mt], a_base + mt * 16 * A_STR + ks * 16);
#pragma unroll
      for (int n2 = 0; n2 < 2; ++n2) {
        uint32_t bh[4], bl[4];
        mma::ldmatrix_x4_trans(bh, Wh + ks * 16 * W_STR + b_off + n2 * 16);
        mma::ldmatrix_x4_trans(bl, Wl + ks * 16 * W_STR + b_off + n2 * 16);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma::mma_bf16(acc[mt][2 * n2], a[mt], bh[0], bh[1]);
          mma::mma_bf16(acc[mt][2 * n2], a[mt], bl[0], bl[1]);
          mma::mma_bf16(acc[mt][2 * n2 + 1], a[mt], bh[2], bh[3]);
          mma::mma_bf16(acc[mt][2 * n2 + 1], a[mt], bl[2], bl[3]);
        }
      }
    }
  }
  mma::cp_async_wait<0>();  // nothing is left in flight at exit

  // epilogue: + bias in fp32, one rounding to bf16
  const int g = lane >> 2;
  const int tg = lane & 3;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int n = n0 + wn * 32 + nt * 8 + 2 * tg;
    if (n >= D) continue;
    const float b0 = b[n];
    const float b1 = n + 1 < D ? b[n + 1] : 0.f;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = m0 + wm * (MMA_BM / 2) + mt * 16 + g + 8 * i;
        if (r >= R) continue;
        bf16* dst = out + (size_t)r * D + n;
        const float v0 = acc[mt][nt][2 * i] + b0;
        const float v1 = acc[mt][nt][2 * i + 1] + b1;
        if (pairs) {
          *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(v0, v1);
        } else {
          dst[0] = __float2bfloat16_rn(v0);
          if (n + 1 < D) dst[1] = __float2bfloat16_rn(v1);
        }
      }
  }
}

}  // namespace

// bf16 output on the tensor cores; the other arguments as
// patch_embed_u8_launch's below. u8 rows are copied 16 bytes at a time where
// K is a multiple of 16 and x is 16-byte aligned, weight rows where D is a
// multiple of 4 and w is 16-byte aligned; the output is written in pairs
// where D is even and out is 4-byte aligned.
extern "C" int patch_embed_u8_mma_launch(const void* x, const void* w, const void* b, void* out,
                                         int R, int K, int D, void* stream) {
  auto aligned = [](const void* p, int n) { return reinterpret_cast<uintptr_t>(p) % n == 0; };
  const int vec_a = K % 16 == 0 && aligned(x, 16);
  const int vec_w = D % 4 == 0 && aligned(w, 16);
  const int pairs = D % 2 == 0 && aligned(out, 4);
  constexpr int bytes = EmbedSmem::BYTES;
  cudaError_t e = cudaFuncSetAttribute(patch_embed_u8_mma_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((D + MMA_BN - 1) / MMA_BN, (R + MMA_BM - 1) / MMA_BM);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  patch_embed_u8_mma_kernel<<<grid, MMA_THREADS, bytes, s>>>(
      static_cast<const uint8_t*>(x), static_cast<const float*>(w), static_cast<const float*>(b),
      static_cast<bf16*>(out), R, K, D, vec_a, vec_w, pairs);
  return static_cast<int>(cudaGetLastError());
}

// out_is_bf16: 0 -> out is float*, 1 -> out is __nv_bfloat16*.
// Returns cudaGetLastError() after the launch.
extern "C" int patch_embed_u8_launch(const void* x, const void* w, const void* b, void* out,
                                     int R, int K, int D, int out_is_bf16, void* stream) {
  dim3 grid((D + BN - 1) / BN, (R + BM - 1) / BM);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_is_bf16) {
    patch_embed_u8_kernel<__nv_bfloat16><<<grid, THREADS, 0, s>>>(
        static_cast<const uint8_t*>(x), static_cast<const float*>(w),
        static_cast<const float*>(b), static_cast<__nv_bfloat16*>(out), R, K, D);
  } else {
    patch_embed_u8_kernel<float><<<grid, THREADS, 0, s>>>(
        static_cast<const uint8_t*>(x), static_cast<const float*>(w),
        static_cast<const float*>(b), static_cast<float*>(out), R, K, D);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* patch_embed_u8_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
