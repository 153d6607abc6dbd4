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
//                        One persistent launch covers every expert (below).
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
// Design of the products. The first design (mma.sync m16n8k16 with every
// operand through ldmatrix, a three-stage cp.async ring, 128 threads a
// block, a grid sized for the worst case) ran every tiling near 245 TFLOP/s,
// 1.77 ms a layer: the rate of mma.sync and its operand loads was the limit.
// This one is Hopper's own path. A block of 384 threads on each SM walks a
// list of (expert, n-tile, m-tile) work items read on the card from the
// permutation's offsets and tile offsets, m-tiles fastest, so the blocks
// that share an expert's weight tile run at the same time and all but the
// first read it from L2. Warpgroup 2 is the producer (its registers cut
// with setmaxnreg): it keeps a ring of STAGES stages of 128 x 64 A and 256 x
// 64 B tiles in flight, in the 128-byte-swizzled layout wgmma reads. The
// weights come by TMA (one tensor map a weight tensor, [E NW, K], cached on
// the host by pointer and shape), down's A (h in sorted order) by TMA too,
// one 64-row box per live half; gate+up's A rows are gathered from x
// through the permutation, which TMA cannot do, by the producer's 128
// threads with 16-byte cp.async into the same swizzled layout (one 128-byte
// line a row a stage, eight lanes a row), completed on the stage's mbarrier.
// Warpgroups 0 and 1 are the consumers: each owns 64 rows of the 128-row
// tile and issues wgmma m64n256k16 from shared memory into fp32 registers,
// one wgmma group in flight while the previous stage is released. A
// warpgroup whose 64 rows lie past its expert's last slot (about one m-tile
// in four at 390 slots an expert) issues no wgmma: the work follows the
// per-expert counts the kernel reads. The epilogue writes from the
// registers: the consumers' next tile is already loading. W_g and W_u are
// stored interleaved by 8 rows ([E, 2F, D]: rows 16q .. 16q+7 are W_g's 8q ..
// 8q+7, the next 8 W_u's), so in wgmma's accumulator layout each thread
// holds the gate and the up of the same output element and the SiLU product
// is the epilogue. No split-K and no atomics: a run repeats bit for bit.
//
// Timed on the card at the benchmark's batch (4,170 tokens, uniform
// routing, 317-440 slots an expert; CUDA events over 50 calls, NVIDIA H100
// 80GB HBM3 at 700 W): gate+up 0.64-0.70 ms, down 0.31-0.34, both 1.03-1.06
// ms a layer (about 430 TFLOP/s, 42% of the bound; the first design 1.92,
// torch._grouped_mm with the gather and the SiLU product 1.13-1.15, cuBLAS's
// dense products of the same shapes 0.36 / 0.19; outputs equal to the first
// design's bit for bit). The tiles' arrival bounds it: with the wgmma taken
// out the loads alone take 0.71 / 0.31 ms (5-6 TB/s from L2 into the SMs:
// each 256 x K weight tile is read once by each of its expert's 3-4
// m-tiles, each A tile once by each n-tile), with the loads taken out
// down's products alone 0.25 (gate+up's read 0.76, not understood). Yet not
// L2's bandwidth: clusters of two blocks that share each weight tile by TMA
// multicast, half the reads, ran no faster (0.66 / 0.31-0.33 against
// 0.64-0.70 / 0.31-0.33 in the same call; 0.91 / 0.48 with the peer's
// release at cluster scope). Slower too: n-tiles of 128 with six stages
// (0.96 / 0.35), three stages; no faster: each stage released only after
// wait_group 0, n-tiles fastest in the walk, 40 producer registers.

#include <cuda.h>  // CUtensorMap and its enums; the CUDA driver call is found at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <mutex>

namespace {

using bf16 = __nv_bfloat16;

// the grouped products' tile (ops/moe.py holds BM, BN and BK too)
constexpr int BM = 128;  // slots (rows) an m-tile; the permutation's tile offsets use it too
constexpr int HALF = 64;  // a consumer warpgroup's rows
constexpr int BN = 256;
constexpr int BK = 64;  // 128 bytes of bf16: one swizzled line a row
constexpr int STAGES = 4;
constexpr int A_TILE = BM * BK;  // elements a stage
constexpr int B_TILE = BN * BK;
constexpr int THREADS = 384;  // consumer warpgroups 0 and 1, producer warpgroup 2
constexpr int CONSUMERS = 256;
constexpr int PRODUCER_REGS = 56, CONSUMER_REGS = 224;
constexpr int SMEM_BYTES = STAGES * (A_TILE + B_TILE) * 2 + 1024;  // + alignment slack
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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// the barrier counts one arrival when this thread's earlier cp.asyncs land
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" :: "r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" :: "r"(smem_u32(dst)), "l"(src)
               : "memory");
}

// a box of the 2D tensor map at (column c, row r) into shared memory
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int c,
                                         int r) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c),
         "r"(r)
      : "memory");
}

// wgmma's view of a K-major tile in shared memory: rows of 64 bf16 (128
// bytes), 128-byte swizzle, 8-row groups 1,024 bytes apart, the tile
// 1,024-byte aligned; a k16 step within it is 32 bytes further
__device__ __forceinline__ uint64_t smem_desc(const void* tile) {
  return static_cast<uint64_t>((smem_u32(tile) & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// D[64, 256] (+)= A[64, 16] B[256, 16]^T, both from shared memory; the
// first product of a tile (scale_d 0) overwrites D
__device__ __forceinline__ void wgmma_n256(float (&d)[128], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(scale_d));
}

// the compiler may not move the accumulators across an asynchronous wgmma
__device__ __forceinline__ void fence_acc(float (&d)[BN / 2]) {
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Work item w of the persistent walk: for each expert, each n-tile, each
// m-tile (m-tiles fastest). tile_s / off_s: the permutation's tile and slot
// offsets, [E + 1], in shared memory.
struct Work {
  int r0, rend, n0, wrow;  // first sorted slot, the expert's end, first column, first weight row
};

__device__ __forceinline__ Work work_item(const int* tile_s, const int* off_s, int E, int NT,
                                          int NW, int w) {
  // the last expert whose first item is at or before w (an expert with no
  // slots shares its offset with the next one)
  const int q = w / NT;
  int lo = 0, hi = E;
  while (hi - lo > 1) {
    const int mid = (lo + hi) / 2;
    if (tile_s[mid] <= q) lo = mid; else hi = mid;
  }
  const int e = lo, mts = tile_s[e + 1] - tile_s[e];
  const int local = w - tile_s[e] * NT, nt = local / mts, mt = local - nt * mts;
  return {off_s[e] + mt * BM, off_s[e + 1], nt * BN, e * NW + nt * BN};
}

// GATE_UP: A = x [N, K] read through rows[] (the token of each sorted slot),
// W = [E, NW = 2F, K] interleaved by 8, out = h [S, F] (out_cols = F).
// down: A = h [S, K] in sorted order (amap), W = [E, NW = D, K], out = y [S,
// D] scaled by wsorted (out_cols = D). wmap: W as [E NW, K], boxes of 64 x
// BN; amap: h as [S, K], boxes of 64 x HALF (unused by gate+up).
template <bool GATE_UP>
__global__ void __launch_bounds__(THREADS, 1)
moe_grouped_kernel(const __grid_constant__ CUtensorMap wmap,
                   const __grid_constant__ CUtensorMap amap, const bf16* __restrict__ A,
                   const int* __restrict__ rows, const float* __restrict__ wsorted,
                   const int* __restrict__ offsets, const int* __restrict__ tiles,
                   bf16* __restrict__ out, int E, int K, int NW, int out_cols) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES];
  __shared__ int tile_s[MAX_EXPERTS + 1], off_s[MAX_EXPERTS + 1];
  bf16* As = reinterpret_cast<bf16*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  bf16* Bs = As + STAGES * A_TILE;
  for (int i = threadIdx.x; i <= E; i += THREADS) {
    tile_s[i] = tiles[i];
    off_s[i] = offsets[i];
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      // full: the producer's thread 0 (with the bytes TMA brings), and for
      // gate+up each producer thread's cp.asyncs; empty: each consumer warp
      mbar_init(&full[s], GATE_UP ? 1 + (THREADS - CONSUMERS) : 1);
      mbar_init(&empty[s], CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int NT = (NW + BN - 1) / BN, KT = K / BK;
  const int total = tile_s[E] * NT;

  if (threadIdx.x >= CONSUMERS) {
    // producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(PRODUCER_REGS));
    const int p = threadIdx.x - CONSUMERS;
    if (!GATE_UP && p >= 32) return;  // down's loads are TMA alone: one warp issues them
    const int chunk = p % 8;  // gate+up: this thread's 16 bytes of rows p / 8 + 16 j
    int it = 0;
    for (int w = blockIdx.x; w < total; w += gridDim.x) {
      const Work t = work_item(tile_s, off_s, E, NT, NW, w);
      const int halves = min(2, (t.rend - t.r0 + HALF - 1) / HALF);
      int src[8];
      if (GATE_UP) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int r = t.r0 + p / 8 + 16 * j;
          src[j] = r < t.rend ? rows[r] : -1;
        }
      }
      for (int kt = 0; kt < KT; ++kt, ++it) {
        const int s = it % STAGES;
        mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
        bf16* as = As + s * A_TILE;
        if (p == 0) {
          mbar_arrive_tx(&full[s], 2 * (B_TILE + (GATE_UP ? 0 : halves * HALF * BK)));
          tma_load(Bs + s * B_TILE, &wmap, &full[s], kt * BK, t.wrow);
          if (!GATE_UP)
            for (int h = 0; h < halves; ++h)
              tma_load(as + h * HALF * BK, &amap, &full[s], kt * BK, t.r0 + h * HALF);
        }
        if (GATE_UP) {
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int r = p / 8 + 16 * j;
            if (src[j] >= 0)
              cp_async16(as + r * BK + ((chunk ^ (r & 7)) * 8),
                         A + static_cast<long long>(src[j]) * K + kt * BK + chunk * 8);
          }
          cp_async_arrive(&full[s]);
        }
      }
    }
    // leave only once the consumers have released every stage
    for (int i = 0; i < STAGES; ++i, ++it) mbar_wait(&empty[it % STAGES], ((it / STAGES) & 1) ^ 1);
  } else {
    // consumers: warpgroup wg owns rows 64 wg .. 64 wg + 63 of each m-tile
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(CONSUMER_REGS));
    const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    float acc[BN / 2];
    int it = 0;
    for (int w = blockIdx.x; w < total; w += gridDim.x) {
      const Work t = work_item(tile_s, off_s, E, NT, NW, w);
      if (t.r0 + wg * HALF >= t.rend) {
        // no slot in this warpgroup's rows: keep the ring's count, no wgmma
        for (int kt = 0; kt < KT; ++kt, ++it) {
          const int s = it % STAGES;
          mbar_wait(&full[s], (it / STAGES) & 1);
          if (lane == 0) mbar_arrive(&empty[s]);
        }
        continue;
      }
      for (int kt = 0; kt < KT; ++kt, ++it) {
        const int s = it % STAGES;
        mbar_wait(&full[s], (it / STAGES) & 1);
        // gate+up's A came by cp.async (the generic proxy); wgmma reads
        // through the async proxy
        if (GATE_UP) asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        const uint64_t da = smem_desc(As + s * A_TILE + wg * HALF * BK);
        const uint64_t db = smem_desc(Bs + s * B_TILE);
        fence_acc(acc);
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
        for (int k = 0; k < BK / 16; ++k) wgmma_n256(acc, da + 2 * k, db + 2 * k, kt > 0 || k > 0);
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        fence_acc(acc);
        // the previous stage's products are done: release it
        asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
        if (kt > 0 && lane == 0) mbar_arrive(&empty[(it + STAGES - 1) % STAGES]);
      }
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      fence_acc(acc);
      if (lane == 0) mbar_arrive(&empty[(it + STAGES - 1) % STAGES]);

      // epilogue: accumulator j of a thread is row 16 warp + lane / 4 (+ 8
      // for its second pair), column 8 (j / 4) + 2 (lane % 4) (+ 1)
      const int row0 = t.r0 + wg * HALF + warp * 16 + lane / 4;
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int row = row0 + 8 * hr;
        if (row >= t.rend) continue;
        bf16* o = out + static_cast<long long>(row) * out_cols;
        if (GATE_UP) {
          // columns 16 q .. 16 q + 7 are the gate's, the next 8 the up's
#pragma unroll
          for (int q = 0; q < BN / 16; ++q) {
            if (t.n0 + 16 * q < NW)  // else a last n-tile of 128 columns
              store2(o + t.n0 / 2 + 8 * q + 2 * (lane % 4),
                     silu(acc[8 * q + 2 * hr]) * acc[8 * q + 4 + 2 * hr],
                     silu(acc[8 * q + 2 * hr + 1]) * acc[8 * q + 5 + 2 * hr]);
          }
        } else {
          const float ws = wsorted[row];
#pragma unroll
          for (int j = 0; j < BN / 8; ++j) {
            if (t.n0 + 8 * j < NW)
              store2(o + t.n0 + 8 * j + 2 * (lane % 4), acc[4 * j + 2 * hr] * ws,
                     acc[4 * j + 2 * hr + 1] * ws);
          }
        }
      }
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


namespace {

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the CUDA driver the runtime loaded (no -lcuda)
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  static std::once_flag once;
  std::call_once(once, [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  });
  return fn;
}

// The tensor map of a bf16 [rows, cols] row-major tensor in boxes of 64
// columns x box_rows rows, 128-byte swizzle, cached by pointer and shape: a
// batch reuses its 52 weight tensors, and h comes back from PyTorch's
// caching allocator at the same few addresses. A map holds no data, so a
// reused address of the same shape maps the same.
struct MapEntry {
  const void* ptr;
  long long rows, cols;
  int box_rows;
  CUtensorMap map;
};
constexpr int MAP_CACHE = 256;
std::mutex map_lock;
MapEntry map_cache[MAP_CACHE];
int map_count = 0, map_next = 0;

bool tensor_map(const void* ptr, long long rows, long long cols, int box_rows, CUtensorMap* out) {
  std::lock_guard<std::mutex> guard(map_lock);
  for (int i = 0; i < map_count; ++i) {
    const MapEntry& m = map_cache[i];
    if (m.ptr == ptr && m.rows == rows && m.cols == cols && m.box_rows == box_rows) {
      *out = m.map;
      return true;
    }
  }
  const EncodeTiled encode = encode_tiled();
  if (!encode) return false;
  MapEntry m{ptr, rows, cols, box_rows, {}};
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 2};
  const cuuint32_t box[2] = {BK, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t unit[2] = {1, 1};
  if (encode(&m.map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims, strides,
             box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) !=
      CUDA_SUCCESS)
    return false;
  map_cache[map_next] = m;
  map_next = (map_next + 1) % MAP_CACHE;
  if (map_count < MAP_CACHE) ++map_count;
  *out = m.map;
  return true;
}

}  // namespace

// gate_up 1: A = x bf16 [N, K], rows int32 [S], W bf16 [E, NW, K] (NW = 2F,
// interleaved by 8), out bf16 [S, NW / 2]; gate_up 0: A = h bf16 [S, K], W
// bf16 [E, NW, K] (NW = D), wsorted fp32 [S], out bf16 [S, NW]. K a multiple
// of 64, NW of 128 (a last n-tile of 128 columns computes 256 and stores
// 128), A and W 16-byte aligned. One block an SM, each walking the work items
// that the tile offsets give on the card.
extern "C" int moe_grouped_launch(int gate_up, const void* A, const void* rows, const void* W,
                                  const void* wsorted, const void* offsets, const void* tiles,
                                  void* out, int E, int K, int NW, int S, void* stream) {
  if (K <= 0 || K % BK != 0 || NW <= 0 || NW % (BN / 2) != 0 || S <= 0 || E <= 0 ||
      E > MAX_EXPERTS || reinterpret_cast<uintptr_t>(A) % 16 || reinterpret_cast<uintptr_t>(W) % 16)
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
  CUtensorMap wmap, amap;
  if (!tensor_map(W, static_cast<long long>(E) * NW, K, BN, &wmap)) return cudaErrorInvalidValue;
  if (gate_up) {
    amap = wmap;  // not read
  } else if (!tensor_map(A, S, K, HALF, &amap)) {
    return cudaErrorInvalidValue;
  }
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  // the most work items the tile offsets can give: ceil(S / BM) + E m-tiles
  const long long items = (static_cast<long long>(S + BM - 1) / BM + E) * ((NW + BN - 1) / BN);
  const unsigned grid = static_cast<unsigned>(items < sms ? items : sms);
  const auto* a = static_cast<const bf16*>(A);
  const auto* off = static_cast<const int*>(offsets);
  const auto* til = static_cast<const int*>(tiles);
  auto* o = static_cast<bf16*>(out);
  if (gate_up) {
    moe_grouped_kernel<true><<<grid, THREADS, SMEM_BYTES, st>>>(
        wmap, amap, a, static_cast<const int*>(rows), nullptr, off, til, o, E, K, NW, NW / 2);
  } else {
    moe_grouped_kernel<false><<<grid, THREADS, SMEM_BYTES, st>>>(
        wmap, amap, a, nullptr, static_cast<const float*>(wsorted), off, til, o, E, K, NW, NW);
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
