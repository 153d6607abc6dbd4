// The sparse expert layer of DeepSeek-V2 (models/deepseek_v2.py) for Hopper
// (sm_90a): routing, the permutation of token slots by expert, two grouped
// GEMMs over every expert in one launch each, and the combine.
//
// Replaces no TPU kernel: the JAX package has no expert layer. Written
// because a loop over 64 experts x 3 products x 26 layers is about 5,000
// launches a batch, on a program whose scoring is already host-bound, and
// because routing must stay on the card: a host read of the expert counts
// in every layer would stall the launching thread once a layer.
//
// One forward of the layer over N tokens of width D, E experts of width F,
// k experts a token (S = N k slots):
//   moe_route_kernel     one warp a token: softmax over the E fp32 gate
//                        logits, greedy top-k (ties to the lower expert),
//                        the weights are the probabilities (not
//                        renormalised) times the scaling factor; per-expert
//                        slot counts by integer atomics (their sum does not
//                        depend on the order).
//   moe_permute_kernel   one block an expert: its slot offset and m-tile
//                        offset (prefix sums of the counts), then its slots
//                        in slot order (a block-wide scan: the same
//                        permutation on every run) -> the token of each
//                        sorted slot, its weight, and each slot's position.
//   moe_grouped_kernel   <gate_up> h = silu(x W_g^T) * (x W_u^T) over the
//                        sorted slots, A rows gathered from x through the
//                        permutation, rounded once to bf16;
//                        <down> y = w_slot * (h W_d^T), rounded once.
//                        One launch covers the m-tiles of all experts: the
//                        grid is sized for the worst case, ceil(S / 128) + E
//                        tiles, each tile finds its expert by a binary search
//                        over the tile offsets read on the card, and a tile
//                        past the last expert's rows exits. An expert with no
//                        slots has no tile and reads no weight.
//   moe_combine_kernel   out[t] = bf16(sum_j y[pos(t, j)] + shared[t]): the k
//                        rows in top-k order, then the shared experts, in
//                        fp32; no atomics, so the output repeats bit for bit.
//
// Bound on an H100 at the benchmark's batch (N about 4,170 kept tokens, D
// 2,048, F 1,408, E 64, k 6): a layer's two products are 2 S D 3 F = 433
// GFLOP, 0.44 ms at 989 TFLOP/s, and read the layer's expert weights once,
// E 3 D F 2 = 1.11 GB, 0.33 ms at 3.35 TB/s: about 390 slots an expert, just
// above the card's ridge, so operations bound it when the router spreads
// tokens evenly and weight bytes when it does not.
//
// Design of the products (a first tensor-core design, not a Hopper-native
// one: mma.sync m16n8k16 from csrc/mma_common.cuh, not wgmma/TMA): 128
// threads a 128 x 128 output tile, four warps of 64 x 64, a three-stage
// cp.async ring of 128 x 64 A and B tiles in dynamic shared memory (rows
// padded to 72 elements: ldmatrix without bank conflicts; 108 KB, two
// blocks an SM), fp32 accumulators in registers. Of six tilings timed on the
// card at the benchmark's batch (64 or 128 rows, 128 or 256 columns, k steps
// of 32 or 64; every one bit for bit the same output) this ran fastest:
// 1.77 ms a layer for both products, about 245 TFLOP/s, against 2.27 ms for
// 128 x 256 tiles with k steps of 32 and 2.49 for 64 x 128 (PERF.md, section
// 6): the deeper k step halves the barriers a tile waits at, and halving the
// L2 traffic with larger tiles gained little, so the rate of mma.sync and
// its operand loads, not L2, is the limit; the next design is wgmma with TMA.
// The grid walks the n-tiles fastest, so the tiles that share an A tile run
// together and an expert's weights are read by its m-tiles at about the same
// time (from L2 after the first). W_g and W_u are stored
// interleaved by 8 rows ([E, 2F, D]: rows 16q .. 16q+7 are W_g's 8q .. 8q+7,
// the next 8 W_u's), so each thread holds the gate and the up of the same
// output element in its accumulators and the SiLU product is the epilogue.

#include "mma_common.cuh"

#include <math.h>

namespace {

using bf16 = __nv_bfloat16;

// the tile (ops/moe.py holds BM, BN and BK too)
constexpr int BM = 128;  // slots (rows) a tile; the permutation's tile offsets use it too
constexpr int BN = 128;
constexpr int BK = 64;
constexpr int STAGES = 3;
constexpr int LDS = BK + 8;  // a staged row, padded by 16 bytes
constexpr int WARPS_M = 2, WARPS_N = 2;  // a warp's tile: 64 x 64
constexpr int WM = BM / (16 * WARPS_M);  // m16 tiles a warp
constexpr int WN = BN / (8 * WARPS_N);  // n8 tiles a warp
constexpr int THREADS = 32 * WARPS_M * WARPS_N;
constexpr int SMEM_BYTES = STAGES * (BM + BN) * LDS * 2;
constexpr int MAX_EXPERTS = 256;
constexpr int PERMUTE_THREADS = 1024;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// EPL: experts a lane holds (E <= 32 EPL)
template <int EPL>
__global__ void __launch_bounds__(256)
moe_route_kernel(const float* __restrict__ logits, int N, int E, int k, float scaling,
                 int* __restrict__ idx, float* __restrict__ weight, int* __restrict__ counts) {
  const long long token = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (token >= N) return;
  const float* l = logits + token * E;
  float v[EPL];
  float mx = -INFINITY;
#pragma unroll
  for (int j = 0; j < EPL; ++j) {
    const int e = lane + 32 * j;
    v[j] = e < E ? l[e] : -INFINITY;
    mx = fmaxf(mx, v[j]);
  }
  mx = warp_max(mx);
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < EPL; ++j) {
    v[j] = lane + 32 * j < E ? expf(v[j] - mx) : 0.f;
    sum += v[j];
  }
  sum = warp_sum(sum);
#pragma unroll
  for (int j = 0; j < EPL; ++j) v[j] = lane + 32 * j < E ? v[j] / sum : -1.f;
  for (int t = 0; t < k; ++t) {
    // this lane's best untaken expert (a probability is >= 0, a taken or
    // absent one -1); ties keep the lower expert
    float bv = -1.f;
    int be = 0x7fffffff;
#pragma unroll
    for (int j = 0; j < EPL; ++j) {
      if (v[j] > bv) {
        bv = v[j];
        be = lane + 32 * j;
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
      const int oe = __shfl_xor_sync(0xffffffffu, be, o);
      if (ov > bv || (ov == bv && oe < be)) {
        bv = ov;
        be = oe;
      }
    }
    if (lane == be % 32) {
#pragma unroll
      for (int j = 0; j < EPL; ++j)
        if (be / 32 == j) v[j] = -1.f;
    }
    if (lane == 0) {
      idx[token * k + t] = be;
      weight[token * k + t] = bv * scaling;
      atomicAdd(&counts[be], 1);
    }
  }
}

__global__ void __launch_bounds__(PERMUTE_THREADS)
moe_permute_kernel(const int* __restrict__ idx, const float* __restrict__ weight,
                   const int* __restrict__ counts, int S, int k, int E, int* __restrict__ offsets,
                   int* __restrict__ tiles, int* __restrict__ rows, float* __restrict__ wsorted,
                   int* __restrict__ slot_pos) {
  __shared__ int warp_base[PERMUTE_THREADS / 32];
  __shared__ int expert_base;
  const int e = blockIdx.x;
  const int lane = threadIdx.x % 32, wid = threadIdx.x / 32;
  if (threadIdx.x == 0) {
    int off = 0, tile = 0;
    for (int i = 0; i < e; ++i) {
      off += counts[i];
      tile += (counts[i] + BM - 1) / BM;
    }
    offsets[e] = off;
    tiles[e] = tile;
    if (e == E - 1) {
      offsets[E] = off + counts[e];
      tiles[E] = tile + (counts[e] + BM - 1) / BM;
    }
    expert_base = off;
  }
  // each thread a run of consecutive slots: their hits, a block-wide scan
  const int chunk = (S + PERMUTE_THREADS - 1) / PERMUTE_THREADS;
  const int lo = min(static_cast<int>(threadIdx.x) * chunk, S), hi = min(lo + chunk, S);
  int c = 0;
  for (int s = lo; s < hi; ++s) c += idx[s] == e;
  int incl = c;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += t;
  }
  if (lane == 31) warp_base[wid] = incl;
  __syncthreads();
  if (wid == 0) {
    const int total = warp_base[lane];
    int w = total;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += t;
    }
    warp_base[lane] = w - total;
  }
  __syncthreads();
  int pos = expert_base + warp_base[wid] + incl - c;
  for (int s = lo; s < hi; ++s) {
    if (idx[s] == e) {
      rows[pos] = s / k;
      wsorted[pos] = weight[s];
      slot_pos[s] = pos;
      ++pos;
    }
  }
}

__device__ __forceinline__ float silu(float g) { return g / (1.f + expf(-g)); }

__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// GATE_UP: A = x [N, K] read through rows[] (the token of each sorted slot),
// W = [E, 2F, K] interleaved by 8, out = h [S, F] (out_cols = F).
// down: A = h [S, K] in sorted order, W = [E, D, K], out = y [S, D] scaled by
// wsorted (out_cols = D).
template <bool GATE_UP>
__global__ void __launch_bounds__(THREADS, 1)
moe_grouped_kernel(const bf16* __restrict__ A, const int* __restrict__ rows,
                   const bf16* __restrict__ W, const float* __restrict__ wsorted,
                   const int* __restrict__ offsets, const int* __restrict__ tiles,
                   bf16* __restrict__ out, int E, int K, int NW, int out_cols) {
  extern __shared__ __align__(16) unsigned char smem[];
  auto As = reinterpret_cast<bf16 (*)[BM][LDS]>(smem);
  auto Bs = reinterpret_cast<bf16 (*)[BN][LDS]>(smem + STAGES * BM * LDS * 2);
  __shared__ int src_row[BM];
  const int mt = blockIdx.y;
  if (mt >= tiles[E]) return;
  // the tile's expert: the last e with tiles[e] <= mt (an empty expert
  // shares its offset with the next one)
  int lo = 0, hi = E;
  while (hi - lo > 1) {
    const int mid = (lo + hi) / 2;
    if (tiles[mid] <= mt) lo = mid; else hi = mid;
  }
  const int e = lo;
  const int r0 = offsets[e] + (mt - tiles[e]) * BM;
  const int rend = offsets[e + 1];
  const int n0 = blockIdx.x * BN;
  const bf16* We = W + (static_cast<long long>(e) * NW + n0) * K;
  if (threadIdx.x < BM) {
    const int r = r0 + threadIdx.x;
    src_row[threadIdx.x] = r < rend ? (GATE_UP ? rows[r] : r) : -1;
  }
  __syncthreads();

  auto load = [&](int stage, int kt) {
    const int k0 = kt * BK;
#pragma unroll
    for (int i = threadIdx.x; i < BM * (BK / 8); i += THREADS) {
      const int r = i / (BK / 8), c = (i % (BK / 8)) * 8;
      const int src = src_row[r];
      const bf16* p = A + static_cast<long long>(src < 0 ? 0 : src) * K + k0 + c;
      mma::cp_async16(&As[stage][r][c], p, src >= 0);
    }
#pragma unroll
    for (int i = threadIdx.x; i < BN * (BK / 8); i += THREADS) {
      const int r = i / (BK / 8), c = (i % (BK / 8)) * 8;
      mma::cp_async16(&Bs[stage][r][c], We + static_cast<long long>(r) * K + k0 + c, true);
    }
  };

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = (warp / WARPS_N) * 16 * WM, wn = (warp % WARPS_N) * 8 * WN;
  float acc[WM][WN][4];
#pragma unroll
  for (int i = 0; i < WM; ++i)
#pragma unroll
    for (int j = 0; j < WN; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;

  const int KT = K / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT) load(s, s);
    mma::cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    mma::cp_async_wait<STAGES - 2>();
    __syncthreads();  // the stage refilled below was read in the last step
    const int next = kt + STAGES - 1;
    if (next < KT) load(next % STAGES, next);
    mma::cp_async_commit();
    const int st = kt % STAGES;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t a[WM][4], b[WN / 2][4];
#pragma unroll
      for (int i = 0; i < WM; ++i)
        mma::ldmatrix_x4(a[i], &As[st][wm + 16 * i][kk] + mma::a_frag_offset(lane, LDS));
#pragma unroll
      for (int j = 0; j < WN / 2; ++j)
        mma::ldmatrix_x4(b[j], &Bs[st][wn + 16 * j][kk] + mma::b_frag_offset_nk(lane, LDS));
#pragma unroll
      for (int i = 0; i < WM; ++i)
#pragma unroll
        for (int j = 0; j < WN / 2; ++j) {
          mma::mma_bf16(acc[i][2 * j], a[i], b[j][0], b[j][1]);
          mma::mma_bf16(acc[i][2 * j + 1], a[i], b[j][2], b[j][3]);
        }
    }
  }

  const int g = lane / 4, tg = lane % 4;
#pragma unroll
  for (int i = 0; i < WM; ++i)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = r0 + wm + 16 * i + g + 8 * half;
      if (row >= rend) continue;
      bf16* o = out + static_cast<long long>(row) * out_cols;
      if (GATE_UP) {
        const int col = (n0 + wn) / 2 + 2 * tg;
#pragma unroll
        for (int p = 0; p < WN / 2; ++p)
          store2(o + col + 8 * p, silu(acc[i][2 * p][2 * half]) * acc[i][2 * p + 1][2 * half],
                 silu(acc[i][2 * p][2 * half + 1]) * acc[i][2 * p + 1][2 * half + 1]);
      } else {
        const float ws = wsorted[row];
        const int col = n0 + wn + 2 * tg;
#pragma unroll
        for (int j = 0; j < WN; ++j)
          store2(o + col + 8 * j, acc[i][j][2 * half] * ws, acc[i][j][2 * half + 1] * ws);
      }
    }
}

__device__ __forceinline__ void add8(const bf16* p, float (&f)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] += t.x;
    f[2 * i + 1] += t.y;
  }
}

__global__ void __launch_bounds__(256)
moe_combine_kernel(const bf16* __restrict__ y, const int* __restrict__ slot_pos,
                   const bf16* __restrict__ shared, bf16* __restrict__ out, int D, int k) {
  const long long t = blockIdx.x;
  for (int v = threadIdx.x; v < D / 8; v += blockDim.x) {
    float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int j = 0; j < k; ++j)
      add8(y + static_cast<long long>(slot_pos[t * k + j]) * D + 8 * v, acc);
    if (shared) add8(shared + t * D + 8 * v, acc);
    uint4 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(acc[2 * i], acc[2 * i + 1]);
    *reinterpret_cast<uint4*>(out + t * D + 8 * v) = u;
  }
}

}  // namespace

// logits: fp32 [N, E]; idx: int32 [N, k], weight: fp32 [N, k]; counts: int32
// [E], zero on entry (the layer's row of the per-expert histogram); offsets,
// tiles: int32 [E + 1]; rows: int32 [N k], wsorted: fp32 [N k], slot_pos:
// int32 [N k]. E up to 256, k up to E, N >= 1.
extern "C" int moe_route_launch(const void* logits, int N, int E, int k, float scaling, void* idx,
                                void* weight, void* counts, void* offsets, void* tiles,
                                void* rows, void* wsorted, void* slot_pos, void* stream) {
  if (N <= 0 || E <= 0 || E > MAX_EXPERTS || k <= 0 || k > E) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* l = static_cast<const float*>(logits);
  auto* ip = static_cast<int*>(idx);
  auto* wp = static_cast<float*>(weight);
  auto* cp = static_cast<int*>(counts);
  const unsigned blocks = static_cast<unsigned>((static_cast<long long>(N) * 32 + 255) / 256);
  if (E <= 64) {
    moe_route_kernel<2><<<blocks, 256, 0, st>>>(l, N, E, k, scaling, ip, wp, cp);
  } else {
    moe_route_kernel<8><<<blocks, 256, 0, st>>>(l, N, E, k, scaling, ip, wp, cp);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  moe_permute_kernel<<<E, PERMUTE_THREADS, 0, st>>>(
      ip, wp, cp, N * k, k, E, static_cast<int*>(offsets), static_cast<int*>(tiles),
      static_cast<int*>(rows), static_cast<float*>(wsorted), static_cast<int*>(slot_pos));
  return static_cast<int>(cudaGetLastError());
}

// gate_up 1: A = x bf16 [N, K], rows int32 [S], W bf16 [E, NW, K] (NW = 2F,
// interleaved by 8), out bf16 [S, NW / 2]; gate_up 0: A = h bf16 [S, K], W
// bf16 [E, NW, K] (NW = D), wsorted fp32 [S], out bf16 [S, NW]. K a multiple
// of 64, NW of 128; max_tiles = ceil(S / 128) + E.
extern "C" int moe_grouped_launch(int gate_up, const void* A, const void* rows, const void* W,
                                  const void* wsorted, const void* offsets, const void* tiles,
                                  void* out, int E, int K, int NW, int max_tiles, void* stream) {
  if (K <= 0 || K % BK != 0 || NW <= 0 || NW % BN != 0 || max_tiles <= 0 || max_tiles > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  static bool sized = false;  // the dynamic shared memory, above 48 KB, allowed once
  if (!sized) {
    cudaError_t e = cudaFuncSetAttribute(moe_grouped_kernel<true>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(moe_grouped_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (e != cudaSuccess) return static_cast<int>(e);
    sized = true;
  }
  const dim3 grid(NW / BN, max_tiles);
  const auto* a = static_cast<const bf16*>(A);
  const auto* w = static_cast<const bf16*>(W);
  const auto* off = static_cast<const int*>(offsets);
  const auto* til = static_cast<const int*>(tiles);
  auto* o = static_cast<bf16*>(out);
  if (gate_up) {
    moe_grouped_kernel<true><<<grid, THREADS, SMEM_BYTES, st>>>(
        a, static_cast<const int*>(rows), w, nullptr, off, til, o, E, K, NW, NW / 2);
  } else {
    moe_grouped_kernel<false><<<grid, THREADS, SMEM_BYTES, st>>>(
        a, nullptr, w, static_cast<const float*>(wsorted), off, til, o, E, K, NW, NW);
  }
  return static_cast<int>(cudaGetLastError());
}

// y bf16 [S, D], slot_pos int32 [N, k], shared bf16 [N, D] or null, out bf16
// [N, D]; D a multiple of 8, every pointer 16-byte aligned.
extern "C" int moe_combine_launch(const void* y, const void* slot_pos, const void* shared,
                                  void* out, int N, int D, int k, void* stream) {
  if (N <= 0 || D <= 0 || D % 8 != 0) return cudaErrorInvalidValue;
  moe_combine_kernel<<<N, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(y), static_cast<const int*>(slot_pos),
      static_cast<const bf16*>(shared), static_cast<bf16*>(out), D, k);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* moe_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
