// Residual add + LayerNorm over bf16 rows for Hopper (sm_90a).
//
// Replaces no TPU kernel: on the TPU XLA fuses the residual add and the
// LayerNorm after it into the neighbouring ops by itself. Eager PyTorch does
// not: the bf16 forward spent five launches on a LayerNorm (three widening
// casts, the op, the rounding) and one more on the add before it, each a
// full pass over the activations in fp32 or bf16. This kernel is one launch.
//
// Computes, for each row r of x [R, D] (bf16) with an optional delta [R, D]:
//   s[r] = bf16(x[r] + delta[r])           (written only when delta is given)
//   y[r] = bf16((s[r] - mean) * rsqrt(var + eps) * scale + bias)
// where mean and the biased variance are taken in fp32 over the ROUNDED s
// (the arithmetic of x = x + attn; y = layer_norm(x) in the port's bf16
// forward), and y is rounded to bf16 once. scale and bias are bf16 [D].
// Without delta it is a plain LayerNorm (s is x itself).
//
// Bound on an H100: bytes. With delta it reads x and delta and writes s and
// y, 8 bytes an element: at the SigLIP2-B/16 vision tower's [12,544, 768]
// that is 77 MB, 23 us at 3.35 TB/s; a plain LayerNorm moves 4 bytes an
// element. The arithmetic (two sums and an FMA an element) is far below.
//
// Design: every row is read once from device memory, held in registers, and
// both statistics are taken from the registers (mean first, then the sum of
// squared deviations: the two-pass variance, no cancellation).
//  - D in {512, 768, 1024} (the towers): one warp a row, eight rows a block
//    of 256 threads. Each lane holds D / 256 vectors of eight bf16 (16-byte
//    loads and stores; lane l's j-th vector is columns 8 (32 j + l) .. + 8,
//    so a warp reads 512 contiguous bytes at a time). Sums by warp shuffle;
//    no shared memory, no barrier.
//  - Any other D that is a multiple of 8 up to 3,072 (the fusion head's
//    512 x 5 = 2,560 rows): one block of 128 threads a row, each thread up to
//    three vectors, sums by warp shuffle and four shared floats.
// x and delta may be row-strided views (a row stride that is a multiple of
// 8 elements, 16-byte aligned); s and y are written contiguous [R, D].

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int WARP_ROWS = 8;  // rows a block of the warp kernel
constexpr int BLOCK_THREADS = 128;
constexpr int BLOCK_VECS = 3;  // vectors a thread of the block kernel: D <= 3,072

__device__ __forceinline__ void load8(const bf16* p, float (&f)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

__device__ __forceinline__ void store8(bf16* p, const float (&f)[8]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// x + delta rounded to bf16 in v, and written to s (one vector at column c)
__device__ __forceinline__ void add_round(float (&v)[8], const bf16* d, bf16* s) {
  float t[8];
  load8(d, t);
#pragma unroll
  for (int e = 0; e < 8; ++e) v[e] = round_bf16(v[e] + t[e]);
  store8(s, v);
}

// (v - mean) * rstd * scale + bias, rounded to bf16, to y (one vector)
__device__ __forceinline__ void normalize_store(const float (&v)[8], float mean, float rstd,
                                                const bf16* scale, const bf16* bias, bf16* y) {
  float g[8], b[8], o[8];
  load8(scale, g);
  load8(bias, b);
#pragma unroll
  for (int e = 0; e < 8; ++e) o[e] = (v[e] - mean) * rstd * g[e] + b[e];
  store8(y, o);
}

template <int V, bool ADD>
__global__ void __launch_bounds__(32 * WARP_ROWS)
add_layer_norm_warp_kernel(const bf16* __restrict__ x, const bf16* __restrict__ delta,
                           const bf16* __restrict__ scale, const bf16* __restrict__ bias,
                           bf16* __restrict__ s, bf16* __restrict__ y, int R,
                           long long x_stride, long long d_stride, float eps) {
  constexpr int D = 256 * V;
  const int lane = threadIdx.x % 32;
  const long long row = static_cast<long long>(blockIdx.x) * WARP_ROWS + threadIdx.x / 32;
  if (row >= R) return;
  float v[V][8];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int c = 8 * (32 * j + lane);
    load8(x + row * x_stride + c, v[j]);
    if (ADD) add_round(v[j], delta + row * d_stride + c, s + row * D + c);
  }
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < V; ++j)
#pragma unroll
    for (int e = 0; e < 8; ++e) sum += v[j][e];
  const float mean = warp_sum(sum) / D;
  float sq = 0.f;
#pragma unroll
  for (int j = 0; j < V; ++j)
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float c = v[j][e] - mean;
      sq += c * c;
    }
  const float rstd = rsqrtf(warp_sum(sq) / D + eps);
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int c = 8 * (32 * j + lane);
    normalize_store(v[j], mean, rstd, scale + c, bias + c, y + row * D + c);
  }
}

// sum over the block's 128 threads; every thread gets it
__device__ __forceinline__ float block_sum(float v, float* shared) {
  v = warp_sum(v);
  if (threadIdx.x % 32 == 0) shared[threadIdx.x / 32] = v;
  __syncthreads();
  const float total = shared[0] + shared[1] + shared[2] + shared[3];
  __syncthreads();  // shared is written again by the next sum
  return total;
}

template <bool ADD>
__global__ void __launch_bounds__(BLOCK_THREADS)
add_layer_norm_block_kernel(const bf16* __restrict__ x, const bf16* __restrict__ delta,
                            const bf16* __restrict__ scale, const bf16* __restrict__ bias,
                            bf16* __restrict__ s, bf16* __restrict__ y, int D,
                            long long x_stride, long long d_stride, float eps) {
  __shared__ float shared[BLOCK_THREADS / 32];
  const long long row = blockIdx.x;
  const int nv = D / 8;
  float v[BLOCK_VECS][8];
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < BLOCK_VECS; ++j) {
    const int i = threadIdx.x + BLOCK_THREADS * j;
    if (i < nv) {
      load8(x + row * x_stride + 8 * i, v[j]);
      if (ADD) add_round(v[j], delta + row * d_stride + 8 * i, s + row * D + 8 * i);
#pragma unroll
      for (int e = 0; e < 8; ++e) sum += v[j][e];
    }
  }
  const float mean = block_sum(sum, shared) / D;
  float sq = 0.f;
#pragma unroll
  for (int j = 0; j < BLOCK_VECS; ++j) {
    if (threadIdx.x + BLOCK_THREADS * j < nv) {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float c = v[j][e] - mean;
        sq += c * c;
      }
    }
  }
  const float rstd = rsqrtf(block_sum(sq, shared) / D + eps);
#pragma unroll
  for (int j = 0; j < BLOCK_VECS; ++j) {
    const int i = threadIdx.x + BLOCK_THREADS * j;
    if (i < nv) {
      normalize_store(v[j], mean, rstd, scale + 8 * i, bias + 8 * i, y + row * D + 8 * i);
    }
  }
}

template <bool ADD>
cudaError_t launch(const bf16* x, const bf16* d, const bf16* g, const bf16* b, bf16* s, bf16* y,
                   int R, int D, long long xs, long long ds, float eps, cudaStream_t st) {
  const dim3 warp_grid((R + WARP_ROWS - 1) / WARP_ROWS);
  const int warp_threads = 32 * WARP_ROWS;
  switch (D) {
    case 512:
      add_layer_norm_warp_kernel<2, ADD><<<warp_grid, warp_threads, 0, st>>>(
          x, d, g, b, s, y, R, xs, ds, eps);
      break;
    case 768:
      add_layer_norm_warp_kernel<3, ADD><<<warp_grid, warp_threads, 0, st>>>(
          x, d, g, b, s, y, R, xs, ds, eps);
      break;
    case 1024:
      add_layer_norm_warp_kernel<4, ADD><<<warp_grid, warp_threads, 0, st>>>(
          x, d, g, b, s, y, R, xs, ds, eps);
      break;
    default:
      if (D <= 0 || D % 8 != 0 || D > 8 * BLOCK_THREADS * BLOCK_VECS) return cudaErrorInvalidValue;
      add_layer_norm_block_kernel<ADD><<<R, BLOCK_THREADS, 0, st>>>(
          x, d, g, b, s, y, D, xs, ds, eps);
  }
  return cudaGetLastError();
}

}  // namespace

// x, delta: bf16 rows with row strides x_stride, delta_stride (elements);
// delta may be null (a plain LayerNorm; s is then not written and may be
// null). scale, bias: bf16 [D]. s, y: bf16 [R, D] contiguous. Every pointer
// 16-byte aligned, strides multiples of 8, D a multiple of 8 up to 3,072.
// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue for a D
// it does not take).
extern "C" int add_layer_norm_launch(const void* x, const void* delta, const void* scale,
                                     const void* bias, void* s, void* y, int R, int D,
                                     long long x_stride, long long delta_stride, float eps,
                                     void* stream) {
  const auto* xp = static_cast<const bf16*>(x);
  const auto* dp = static_cast<const bf16*>(delta);
  const auto* gp = static_cast<const bf16*>(scale);
  const auto* bp = static_cast<const bf16*>(bias);
  auto* sp = static_cast<bf16*>(s);
  auto* yp = static_cast<bf16*>(y);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e = delta
      ? launch<true>(xp, dp, gp, bp, sp, yp, R, D, x_stride, delta_stride, eps, st)
      : launch<false>(xp, dp, gp, bp, sp, yp, R, D, x_stride, delta_stride, eps, st);
  return static_cast<int>(e);
}

extern "C" const char* add_layer_norm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
