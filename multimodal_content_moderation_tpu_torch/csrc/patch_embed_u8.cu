// Fused uint8 patch embed for Hopper (sm_90a).
//
// Replaces: multimodal_content_moderation_tpu/ops/pallas_image.py,
//   patch_embed_u8 (body _embed_kernel).
//
// Computes out[r, n] = sum_k float(x_u8[r, k]) * w[k, n] + b[n], written in
// the output type (fp32 or bf16). w and b are the normalisation-folded fp32
// weight and bias (fold_norm_into_embed), so the per-pixel (x/255 - mean)/std
// costs nothing here.
//
// Bound on an H100: the weight stays fp32, as in the TPU kernel, so the
// product runs on the fp32 SIMT units (67 TFLOP/s), not the tensor cores. At
// the ViT-B/32 main path (B=144: R = 7056 rows, K = 3072, D = 768) that is
// 33.3 GFLOP, about 0.50 ms, against about 42 MB of HBM traffic (12.5 us):
// the kernel is bound by operations.
//
// Design: a shared-memory tiled SIMT GEMM. Each block owns a 64x64 output
// tile and walks K in steps of 32. The u8 tile is widened to fp32 on its way
// into shared memory; 256 threads each accumulate a 4x4 micro-tile with fp32
// FMA; the bias is added in the epilogue before the cast. Ragged row, column
// and K edges are masked in the kernel, so nothing is padded on the host. A
// bf16/TF32 tensor-core design (wgmma, TMA) is later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

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

}  // namespace

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
