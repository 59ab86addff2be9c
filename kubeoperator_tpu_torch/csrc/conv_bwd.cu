// Backward of ResNet's 1x1 stride-1 convolutions for Hopper (sm_90a), plain
// and fused with BatchNorm and relu, and a per-channel column sum.
//
// Replaces three Pallas TPU kernels of the JAX package:
//   K7  workloads/conv_vjp.py::conv1x1_bwd_pallas (inner `kernel`):
//         k7_wgmma_kernel<false> dx = g . w^T            (ko_conv1x1_bwd_dx)
//         k7_wgmma_kernel<true>  dW = x^T . g, f32, then reduce_chunks_kernel
//                                                        (ko_conv1x1_bwd_dw)
//   K8  workloads/bn_fused.py::conv_bn_relu_bwd (`_bn_bwd_kernel`):
//         colsum_kernel<true>    phase 0: sum g' and sum g'.xhat per channel
//                                (ko_bn_bwd_stats)
//         k8_dx_wgmma_kernel     phase 1: dx = dy . w^T  (ko_bn_bwd_dx)
//         k8_dw_wgmma_kernel     phase 1: dW = x^T . dy, f32, then
//                                reduce_chunks_kernel    (ko_bn_bwd_dw)
//   K9  scripts/perf_bitcast_probe.py::sum_kernel:
//         colsum_kernel<false>   f32 sum per channel     (ko_channel_sum)
//
// Layout: every operand is a row-major [N, C] matrix, N = B*H*W rows of an
// NHWC activation (the port keeps activations [B, H, W, C], so a 1x1
// conv's operands are free views). x [N, Ci], g and y [N, Co] and dx are
// bf16; w is [Ci, Co] bf16; gamma, beta, mu, inv are [Co] f32; dW [Ci, Co]
// f32. Ci and Co are multiples of 64 for the products, C a multiple of 8
// for the sums; N is any positive count (the last tile is masked). The TPU
// kernels reordered rows to [H, W, B, C] so that Mosaic saw a bitcast; sums
// over rows and 1x1 products do not depend on row order, so here no row is
// moved.
//
// What bounds them on the H100: at ResNet-50's path shapes each product is
// 2*N*Ci*Co FLOPs against (N*(Ci+Co) + Ci*Co)*2 bytes. At 25,088 rows and
// 256->1024 K7 needs 26.3 GFLOP and 78.7 MB: bound by tensor-core operations
// (about 0.027 ms at 989 TFLOP/s). Where one channel count is 128 (stage 1,
// 100,352 rows) a product moves more bytes than the tensor cores need time
// for: dx of 512->128 writes 103 MB, bound by bytes. K8 runs where a
// block's input has H*W >= 3136 (nine launches a ResNet-50 step at batch
// 128, 401,408 and 100,352 rows, 64 to 512 channels): each of its products
// reads g and y besides x or w and is bound by bytes (at 401,408 rows and
// 64->256, 462 MB each: 0.138 ms at 3.35 TB/s). K9 reads 205.5 MB: bytes
// again.
//
// What the design does about it. K7 and K8's products run on Hopper's
// warpgroup MMA, fed by a ring of 64-deep k-steps that one producer warp
// fills by TMA (128-byte swizzle; rows and channels past the edge arrive as
// zeros) under full/empty mbarriers; blocks are persistent, one an SM, and
// the ring runs on from tile to tile, so the next tile's loads overlap this
// tile's epilogue. K7 (k7_wgmma_kernel): 128 x 128 output tiles over two
// consumer warpgroups of 64 rows, wgmma m64n128k16 straight from shared
// memory, 4 stages, one wgmma group in flight; dx reads g and w K-major, dW
// reads x and g MN-major (wgmma's transpose flags), so no operand is
// transposed in memory. dx leaves through shared memory and TMA stores of
// whole rows: at the stage-1 sites, with 2-4 k-steps a tile, storing dx is
// most of the work, and 4-byte stores from registers had made it twice as
// slow. ptxas (CUDA 12.8): dx 104 registers, dW 94, no spills; 164,928
// bytes of dynamic shared memory. 128 x 128 tiles need 64 FLOP a byte of
// L2 traffic, so dW at the 25,088- and 6,272-row sites stays 1.1-1.7x
// behind cuBLAS (larger tiles or clusters are the next step). K8
// (k8_dx_wgmma_kernel, k8_dw_wgmma_kernel, described where they are
// defined) takes g and y through the ring and forms dy on chip: dx in
// wgmma's register A fragments, dW in shared memory in place of g. dy is
// rounded to bf16 as the TPU kernel rounds it and never written to global
// memory. Blocks run in parallel and in no order, so the dW sum over N,
// which the TPU kernel carried across its sequential grid in one VMEM
// block, is split in both: each block sums one chunk of rows into its own
// f32 partial tile, and reduce_chunks_kernel adds the partials in a fixed
// order. The result does not depend on scheduling: two runs give the same
// bits. The column sums work the same way (a partial per row chunk, then
// the fixed-order reduction), and the phase barrier of K8 is launch order
// on the stream: stats, then dx, then dW. dx and dW are separate launches,
// so K7 reads g twice and K8 reads g and y three times (the TPU kernel
// read g once, and K8 twice): a one-pass design would need a resident w of
// up to 128 KB beside an f32 dW accumulator of up to 256 KB at K8's
// 128->512 site, and one block's 227 KB holds neither.

#include <climits>

#include <cuda_runtime.h>

#include "sm90.cuh"   // also bf16 and pack

namespace {

constexpr int CH = 64;          // the products take channels in multiples
                                // of one 64-wide TMA box
constexpr int SUM_THREADS = 256;

// What K8 needs to form dy from g and y (unused by K7). sums holds
// [sum g' (= dbeta) | sum g'.xhat (= dgamma)], 2*Co floats.
struct Bn {
  const bf16* y;
  const float *gamma, *beta, *mu, *inv, *sums;
  float inv_n;
  int co, relu;
};

__device__ __forceinline__ void load8(float* dst, const float* src) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(src));
  const float4 b = __ldg(reinterpret_cast<const float4*>(src) + 1);
  dst[0] = a.x; dst[1] = a.y; dst[2] = a.z; dst[3] = a.w;
  dst[4] = b.x; dst[5] = b.y; dst[6] = b.z; dst[7] = b.w;
}

// xhat and the relu-gated g of the TPU kernel, in its order of f32
// operations (no fused multiply-add): the gate is (gamma*xhat + beta)
// rounded to bf16, then compared in f32
__device__ __forceinline__ float gate(float g, float yv, float mu, float inv,
                                      float gamma, float beta, int relu,
                                      float* xhat) {
  *xhat = __fmul_rn(__fsub_rn(yv, mu), inv);
  if (relu) {
    const float pre = __bfloat162float(__float2bfloat16_rn(
        __fadd_rn(__fmul_rn(gamma, *xhat), beta)));
    if (!(pre > 0.f)) g = 0.f;
  }
  return g;
}

// K8 phase 1 per channel j: dy = c*(g' - a - xhat*b) with a = sum g'/N,
// b = sum(g'.xhat)/N and c = gamma*inv, each factor rounded as the TPU
// kernel rounds it (one f32 operation at a time, no fused multiply-add)
struct BnChan {
  float mu, inv, a, b, c, gamma, beta;
};

__device__ __forceinline__ BnChan bn_chan(const Bn& bn, int j) {
  BnChan k;
  k.mu = bn.mu[j];
  k.inv = bn.inv[j];
  k.a = __fmul_rn(bn.sums[j], bn.inv_n);
  k.b = __fmul_rn(bn.sums[bn.co + j], bn.inv_n);
  k.c = __fmul_rn(bn.gamma[j], k.inv);
  k.gamma = bn.gamma[j];
  k.beta = bn.beta[j];
  return k;
}

template <bool RELU>
__device__ __forceinline__ float bn_dy(float g, float y, const BnChan& k) {
  float xhat;
  const float ga = gate(g, y, k.mu, k.inv, k.gamma, k.beta, RELU, &xhat);
  return __fmul_rn(k.c, __fsub_rn(__fsub_rn(ga, k.a), __fmul_rn(xhat, k.b)));
}

// ---------------------------------------------------------------------------
// Column sums of a row-major [n, c] bf16 matrix over one chunk of rows per
// blockIdx.y, into part[chunk][k][c]: K9 (BN = false) sums m itself
// (k = 0); K8's phase 0 (BN = true) sums g' (k = 0) and g'.xhat (k = 1),
// with m = g and xhat from bn.y. A thread owns 8 adjacent channels (one
// 16-byte load a row); a block covers 8*G channels and SUM_THREADS/G rows
// at a time, and adds its rows in a fixed order.
// ---------------------------------------------------------------------------
template <bool BN>
__global__ void __launch_bounds__(SUM_THREADS)
colsum_kernel(const bf16* __restrict__ m, float* __restrict__ part, int n,
              int c, int rows_per_chunk, Bn bn) {
  constexpr int NOUT = BN ? 2 : 1;
  __shared__ float red[NOUT][SUM_THREADS * 8];
  const int G = min(c / 8, 32), R = SUM_THREADS / G;
  const int cg = threadIdx.x % G, rr = threadIdx.x / G;
  const int col = (blockIdx.x * G + cg) * 8;
  const int rbeg = blockIdx.y * rows_per_chunk;
  const int rend = min(n, rbeg + rows_per_chunk);
  float s[NOUT][8] = {};
  // with G not a divisor of SUM_THREADS the last threads have rr == R
  if (rr < R && col < c) {
    float mu[8], inv[8], gm[8], bt[8];
    if (BN) {
      load8(mu, bn.mu + col);
      load8(inv, bn.inv + col);
      load8(gm, bn.gamma + col);
      load8(bt, bn.beta + col);
    }
    for (int row = rbeg + rr; row < rend; row += R) {
      const size_t off = (size_t)row * c + col;
      const uint4 v = *reinterpret_cast<const uint4*>(m + off);
      const bf16* vh = reinterpret_cast<const bf16*>(&v);
      if (BN) {
        const uint4 yv = *reinterpret_cast<const uint4*>(bn.y + off);
        const bf16* yh = reinterpret_cast<const bf16*>(&yv);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          float xhat;
          const float ga = gate(__bfloat162float(vh[e]),
                                __bfloat162float(yh[e]), mu[e], inv[e],
                                gm[e], bt[e], bn.relu, &xhat);
          s[0][e] += ga;
          s[NOUT - 1][e] += ga * xhat;
        }
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) s[0][e] += __bfloat162float(vh[e]);
      }
    }
  }
  if (rr < R)
#pragma unroll
    for (int k = 0; k < NOUT; ++k)
#pragma unroll
      for (int e = 0; e < 8; ++e) red[k][rr * G * 8 + cg * 8 + e] = s[k][e];
  __syncthreads();
  const int j = threadIdx.x;        // channel j of the block's 8*G
  const int cj = blockIdx.x * G * 8 + j;
  if (j < G * 8 && cj < c) {
#pragma unroll
    for (int k = 0; k < NOUT; ++k) {
      float t = 0.f;
      for (int r = 0; r < R; ++r) t += red[k][r * G * 8 + j];
      part[((size_t)blockIdx.y * NOUT + k) * c + cj] = t;
    }
  }
}

// out[j] = sum over chunks of part[chunk][j], j < m, in a fixed order:
// thread (x, y) adds chunks y, y + blockDim.y, ... of column x, then
// thread (x, 0) adds the blockDim.y sums in order of y
__global__ void reduce_chunks_kernel(const float* __restrict__ part,
                                     float* __restrict__ out, int chunks,
                                     int m) {
  __shared__ float red[32][33];
  const int j = blockIdx.x * 32 + threadIdx.x;
  float s = 0.f;
  if (j < m)
    for (int ch = threadIdx.y; ch < chunks; ch += blockDim.y)
      s += part[(size_t)ch * m + j];
  red[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && j < m) {
    float t = 0.f;
    for (int y = 0; y < (int)blockDim.y; ++y) t += red[y][threadIdx.x];
    out[j] = t;
  }
}

cudaError_t reduce_chunks(const float* part, float* out, int chunks, int m,
                          cudaStream_t s) {
  const int ty = chunks < 32 ? chunks : 32;
  reduce_chunks_kernel<<<(m + 31) / 32, dim3(32, ty), 0, s>>>(part, out,
                                                               chunks, m);
  return cudaGetLastError();
}

bool bad_gemm(int n, int ci, int co) {
  return n <= 0 || ci <= 0 || co <= 0 || ci % CH || co % CH;
}

bool bad_chunks(int n, int rows_per_chunk, int chunks, int step) {
  return rows_per_chunk <= 0 || rows_per_chunk % step || chunks <= 0 ||
         chunks > 65535 || (long long)rows_per_chunk * chunks < n ||
         (long long)rows_per_chunk * (chunks - 1) >= n;
}

Bn make_bn(const void* y, const void* gamma, const void* beta,
           const void* mu, const void* inv, const void* sums, int n, int co,
           int relu) {
  return Bn{(const bf16*)y, (const float*)gamma, (const float*)beta,
            (const float*)mu, (const float*)inv, (const float*)sums,
            (float)(1.0 / n), co, relu};
}

// ---------------------------------------------------------------------------
// K7 on wgmma: one main loop for both products. A block computes a 128 x 128
// output tile with two consumer warpgroups of 64 rows each; one producer
// warp keeps a ring of K7_STAGES k-steps in flight, each 64 deep, loaded by
// TMA (128-byte swizzle) and guarded by full/empty mbarriers. Consumers keep
// one wgmma group in flight and release a stage once the group reading it
// is done.
//   dx [n, ci] = g [n, co] . w [ci, co]^T: M = rows, N = ci, k over co. g
//     and w are K-major (co contiguous): one [128][64] box each a stage.
//     The ci tiles of one row tile are neighbours in the tile order, so
//     they run side by side and share its g through L2.
//   dW partial [chunk][ci, co] = x[chunk rows]^T . g[chunk rows]: M = ci,
//     N = co, k over rows; x and g are MN-major (channels contiguous): two
//     [64][64] boxes of each a stage. k7_dw_chunks (conv_vjp.py) makes
//     about one tile per SM; the chunks are added by reduce_chunks in a
//     fixed order.
// Rows past n and channels past ci or co arrive as zeros (TMA bounds);
// the epilogue stores only what lies inside (dx: the TMA store clips).
// ---------------------------------------------------------------------------
constexpr int K7_TILE = 128, K7_STEP = 64, K7_STAGES = 4;
constexpr int K7_CONSUMERS = 256;                  // 2 warpgroups
constexpr int K7_THREADS = K7_CONSUMERS + 32;      // + the producer warp
constexpr int K7_BOX = 64 * 128;                   // bytes of a [64][64] box
constexpr int K7_STAGE_BYTES = 4 * K7_BOX;         // A and B, 32 KB
constexpr int K7_RING = K7_STAGES * K7_STAGE_BYTES;
constexpr int K7_EPI = 2 * 2 * K7_BOX;             // dx: a [64][128] bf16
                                                   // tile a warpgroup
constexpr size_t K7_SMEM = (size_t)K7_RING + K7_EPI +
                           2 * K7_STAGES * sizeof(uint64_t) + 1024;

// The work of one output tile: its origin (m0, n0), the k range, and for
// dW the chunk. Tiles are numbered N tile fastest, then M tile, then chunk.
struct K7Tile {
  int m0, n0, z, k0, steps;
};

template <bool DW>
__device__ __forceinline__ K7Tile k7_tile(int tile, int n, int ci, int co,
                                          int rows_per_chunk) {
  const int tiles_n = ((DW ? co : ci) + K7_TILE - 1) / K7_TILE;
  const int tiles_m = ((DW ? ci : n) + K7_TILE - 1) / K7_TILE;
  K7Tile t;
  t.n0 = (tile % tiles_n) * K7_TILE;
  t.m0 = (tile / tiles_n % tiles_m) * K7_TILE;
  t.z = tile / (tiles_n * tiles_m);
  t.k0 = DW ? t.z * rows_per_chunk : 0;
  const int k_len = DW ? min(n, t.k0 + rows_per_chunk) - t.k0 : co;
  t.steps = (k_len + K7_STEP - 1) / K7_STEP;
  return t;
}

// Persistent: a block walks tiles blockIdx.x, + gridDim.x, ...; the ring
// runs on across tiles, so the producer loads the next tile's first
// k-steps while the consumers store this one.
// dx's epilogue goes through shared memory (each warpgroup's [64][128]
// bf16 as two 128-byte-swizzled [64][64] boxes, so the fragment writes
// meet no bank conflict) and leaves by TMA store, which writes whole rows
// and clips the edges, while the next tile's products run. dW's f32
// partials are stored from registers (each quad writes a 32-byte sector).
template <bool DW>
__global__ void __launch_bounds__(K7_THREADS, 1)
k7_wgmma_kernel(const __grid_constant__ CUtensorMap ta,
                const __grid_constant__ CUtensorMap tb,
                const __grid_constant__ CUtensorMap tc, void* __restrict__ out,
                int n, int ci, int co, int rows_per_chunk, int tiles) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + K7_RING + K7_EPI);
  uint64_t* empty = full + K7_STAGES;

  if (threadIdx.x == 0) {
    for (int s = 0; s < K7_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], K7_CONSUMERS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= K7_CONSUMERS) {                 // the producer warp
    if (threadIdx.x == K7_CONSUMERS) {
      int it = 0;                                    // k-steps so far
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const K7Tile t = k7_tile<DW>(tile, n, ci, co, rows_per_chunk);
        for (int step = 0; step < t.steps; ++step, ++it) {
          const int s = it % K7_STAGES;
          if (it >= K7_STAGES) mbar_wait(&empty[s], (it / K7_STAGES - 1) & 1);
          unsigned char* a = smem + s * K7_STAGE_BYTES;
          unsigned char* b = a + 2 * K7_BOX;
          const int k = t.k0 + step * K7_STEP;
          mbar_expect_tx(&full[s], K7_STAGE_BYTES);
          if (DW) {          // x [k.., m0..] and g [k.., n0..], 64 x 64 boxes
            tma_load_2d(a, &ta, &full[s], t.m0, k);
            tma_load_2d(a + K7_BOX, &ta, &full[s], t.m0 + 64, k);
            tma_load_2d(b, &tb, &full[s], t.n0, k);
            tma_load_2d(b + K7_BOX, &tb, &full[s], t.n0 + 64, k);
          } else {           // g [m0.., k..] and w [n0.., k..], 128 x 64 boxes
            tma_load_2d(a, &ta, &full[s], k, t.m0);
            tma_load_2d(b, &tb, &full[s], k, t.n0);
          }
        }
      }
    }
    return;
  }

  const int wg = threadIdx.x / 128;     // this warpgroup's 64 rows of M
  const int lane = threadIdx.x % 32;
  int it = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const K7Tile t = k7_tile<DW>(tile, n, ci, co, rows_per_chunk);
    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
    for (int step = 0; step < t.steps; ++step, ++it) {
      const int s = it % K7_STAGES;
      mbar_wait(&full[s], (it / K7_STAGES) & 1);
      const uint32_t a = smem_u32(smem + s * K7_STAGE_BYTES) + wg * K7_BOX;
      const uint32_t b = smem_u32(smem + s * K7_STAGE_BYTES) + 2 * K7_BOX;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < K7_STEP / 16; ++kk) {
        if (DW)
          wgmma_ss_n128<1, 1>(acc, desc_mn(a + kk * 2048, K7_BOX),
                              desc_mn(b + kk * 2048, K7_BOX), 1);
        else
          wgmma_ss_n128<0, 0>(acc, desc_k(a + kk * 32), desc_k(b + kk * 32),
                              1);
      }
      wgmma_commit();
      wgmma_wait<1>();                  // the previous step's group is done
      if (step > 0) mbar_arrive(&empty[(it - 1) % K7_STAGES]);
    }
    wgmma_wait<0>();
    fence_regs(acc);
    mbar_arrive(&empty[(it - 1) % K7_STAGES]);

    // accumulator element e sits at row g + 8*((e >> 1) & 1) of the warp's
    // 16, column 8*(e >> 2) + 2*tq + (e & 1)
    const int r16 = ((threadIdx.x / 32) % 4) * 16 + lane / 4;
    if (DW) {
      const int row0 = t.m0 + wg * 64 + r16, col0 = t.n0 + 2 * (lane % 4);
      float* part = static_cast<float*>(out) + (size_t)t.z * ci * co;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = row0 + 8 * half;
        if (row >= ci) continue;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int col = col0 + 8 * j;
          if (col < co)
            *reinterpret_cast<float2*>(part + (size_t)row * co + col) =
                make_float2(acc[4 * j + 2 * half], acc[4 * j + 2 * half + 1]);
        }
      }
    } else {
      unsigned char* epi = smem + K7_RING + wg * 2 * K7_BOX;
      const bool leader = threadIdx.x % 128 == 0;
      if (leader) bulk_wait<0, true>();     // the last store has read epi
      named_sync(1 + wg, 128);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = r16 + 8 * half;
#pragma unroll
        for (int j = 0; j < 16; ++j)
          *reinterpret_cast<uint32_t*>(
              epi + (j / 8) * K7_BOX + r * 128 + (((j % 8) ^ (r % 8)) * 16) +
              (lane % 4) * 4) =
              pack(acc[4 * j + 2 * half], acc[4 * j + 2 * half + 1]);
      }
      fence_proxy_async();
      named_sync(1 + wg, 128);
      if (leader) {
        tma_store_2d(&tc, epi, t.n0, t.m0 + wg * 64);
        tma_store_2d(&tc, epi + K7_BOX, t.n0 + 64, t.m0 + wg * 64);
        bulk_commit();
      }
    }
  }
  if (!DW && threadIdx.x % 128 == 0) bulk_wait<0, false>();
}

// a 2-D tensor map over a row-major [rows, cols] bf16 matrix, box
// [box_rows][64]
cudaError_t k7_map(CUtensorMap* map, const void* m, int rows, int cols,
                   int box_rows) {
  const uint64_t dims[2] = {(uint64_t)cols, (uint64_t)rows};
  const uint64_t strides[1] = {(uint64_t)cols * 2};
  const uint32_t box[2] = {64, (uint32_t)box_rows};
  return make_tensor_map(map, m, 2, dims, strides, box);
}

cudaError_t sm_count(int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  return err;
}

template <bool DW>
cudaError_t k7_launch(const CUtensorMap& ta, const CUtensorMap& tb,
                      const CUtensorMap& tc, void* out, int n, int ci, int co,
                      int rows_per_chunk, int chunks, cudaStream_t s) {
  int sms = 0;
  cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(
      k7_wgmma_kernel<DW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)K7_SMEM);
  if (err != cudaSuccess) return err;
  const int row_tiles = (n + K7_TILE - 1) / K7_TILE;
  const int ci_tiles = (ci + K7_TILE - 1) / K7_TILE;
  const int co_tiles = (co + K7_TILE - 1) / K7_TILE;
  const long long tiles = DW ? (long long)co_tiles * ci_tiles * chunks
                             : (long long)ci_tiles * row_tiles;
  if (tiles > INT_MAX) return cudaErrorInvalidValue;
  const int grid = (int)(tiles < sms ? tiles : sms);
  k7_wgmma_kernel<DW><<<grid, K7_THREADS, K7_SMEM, s>>>(
      ta, tb, tc, out, n, ci, co, rows_per_chunk, (int)tiles);
  return cudaGetLastError();
}

int k7_dx(const void* g, const void* w, void* dx, int n, int ci, int co,
          void* stream) {
  if (bad_gemm(n, ci, co)) return (int)cudaErrorInvalidValue;
  CUtensorMap tg, tw, tdx;
  cudaError_t err = k7_map(&tg, g, n, co, K7_TILE);
  if (err == cudaSuccess) err = k7_map(&tw, w, ci, co, K7_TILE);
  if (err == cudaSuccess) err = k7_map(&tdx, dx, n, ci, 64);
  if (err == cudaSuccess)
    err = k7_launch<false>(tg, tw, tdx, dx, n, ci, co, 0, 1,
                           (cudaStream_t)stream);
  return (int)err;
}

int k7_dw(const void* x, const void* g, void* dw, void* ws, int n, int ci,
          int co, int rows_per_chunk, int chunks, void* stream) {
  if (bad_gemm(n, ci, co) || bad_chunks(n, rows_per_chunk, chunks, K7_STEP))
    return (int)cudaErrorInvalidValue;
  CUtensorMap tx, tg;
  cudaError_t err = k7_map(&tx, x, n, ci, 64);
  if (err == cudaSuccess) err = k7_map(&tg, g, n, co, 64);
  cudaStream_t s = (cudaStream_t)stream;
  if (err == cudaSuccess)   // dW stores from registers: tc unused
    err = k7_launch<true>(tx, tg, tg, ws, n, ci, co, rows_per_chunk, chunks,
                          s);
  if (err != cudaSuccess) return (int)err;
  return (int)reduce_chunks((const float*)ws, (float*)dw, chunks, ci * co, s);
}

// ---------------------------------------------------------------------------
// K8's phase-1 products on wgmma: K7's machinery with dy formed on chip.
// Both kernels are persistent: one producer warp fills a ring of 64-deep
// k-steps by TMA (128-byte swizzle; rows past n arrive as zeros) under
// full/empty mbarriers, and the consumer warpgroups read g and y from the
// ring and form dy = c*(g' - a - xhat*b) (bn_dy) themselves, so dy is never
// written to global memory. In a 128-byte-swizzled box the 16-byte chunk c
// of row r holds channels 8*(c ^ (r % 8)) .. +7: dy keeps the position,
// and the per-channel constants are read at the unswizzled channel.
// ---------------------------------------------------------------------------
constexpr int K8_BOX = 64 * 128;                   // bytes of a [64][64] box

// dx [n, ci] = dy [n, co] . w [ci, co]^T: M = rows, N = ci, k over co. A
// block tile is 128 rows x TN channels of ci (TN = 128, or 64 where ci is
// not a multiple of 128, so that no tile is half zeros) over two consumer
// warpgroups of 64 rows; a stage holds g and y as [128][64] boxes and w as
// a [TN][64] box, all K-major. Each consumer thread reads its rows' g and
// y straight into wgmma's register A fragments (the m16n8k16 layout of
// K1's P: rows quad and quad + 8 of its warp's 16, channels 2tq, 2tq + 1
// and + 8 of each k16 step), forms dy there, rounds it to bf16 and runs
// dx += dy.w^T as wgmma m64nTNk16 with w from shared memory: no
// shared-memory write and no proxy fence between dy and the product. The
// constants of all co channels sit in a shared-memory table (one array per
// BnChan field), filled once a block. With co = 64 a tile has one k-step,
// so only a ring that runs on across tiles overlaps its loads with work.
// dx leaves as K7's does, through swizzled shared memory and TMA stores.
// ptxas (CUDA 12.8): 126-128 registers at TN = 64, 157-160 at TN = 128, no
// spills; up to 195,632 bytes of dynamic shared memory (co = 512).
template <int TN>
struct K8Dx {
  static constexpr int STAGES = TN == 64 ? 4 : 3;
  static constexpr int G = 2 * K8_BOX;               // a [128][64] g or y box
  static constexpr int STAGE = 2 * G + TN / 64 * K8_BOX;
  static constexpr int RING = STAGES * STAGE;
  static constexpr int EPI = 2 * TN / 64 * K8_BOX;   // [64][TN] bf16 a
                                                     // warpgroup
  static constexpr int BAR = RING + EPI;
  static constexpr int TAB = BAR + 2 * STAGES * 8;   // [7][co] f32
  static size_t bytes(int co) { return (size_t)TAB + 7 * 4 * co + 1024; }
};
constexpr int K8_DX_CONSUMERS = 256;                // 2 warpgroups
constexpr int K8_DX_THREADS = K8_DX_CONSUMERS + 32; // + the producer warp

template <int TN>
__device__ __forceinline__ void wgmma_rs_k(float (&d)[TN / 2],
                                           const uint32_t (&a)[4],
                                           uint64_t db) {
  if constexpr (TN == 64)
    wgmma_rs_n64<0>(d, a, db);
  else
    wgmma_rs_n128<0>(d, a, db);
}

template <int TN, bool RELU>
__global__ void __launch_bounds__(K8_DX_THREADS, 1)
k8_dx_wgmma_kernel(const __grid_constant__ CUtensorMap tg,
                   const __grid_constant__ CUtensorMap ty,
                   const __grid_constant__ CUtensorMap tw,
                   const __grid_constant__ CUtensorMap tdx, Bn bn, int ci,
                   int co, int tiles) {
  using L = K8Dx<TN>;
  constexpr int S = L::STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BAR);
  uint64_t* empty = full + S;
  float* tab = reinterpret_cast<float*>(smem + L::TAB);

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], K8_DX_CONSUMERS);
    }
    mbar_fence_init();
  }
  for (int j = threadIdx.x; j < co; j += K8_DX_THREADS) {
    const BnChan k = bn_chan(bn, j);
    const float v[7] = {k.mu, k.inv, k.a, k.b, k.c, k.gamma, k.beta};
#pragma unroll
    for (int p = 0; p < 7; ++p) tab[p * co + j] = v[p];
  }
  __syncthreads();

  // tiles: ci tile fastest, so a row tile's ci tiles share g and y in L2
  const int tiles_n = ci / TN, steps = co / 64;
  if (threadIdx.x >= K8_DX_CONSUMERS) {              // the producer warp
    if (threadIdx.x == K8_DX_CONSUMERS) {
      int it = 0;                                    // k-steps so far
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = tile / tiles_n * 128, n0 = tile % tiles_n * TN;
        for (int step = 0; step < steps; ++step, ++it) {
          const int s = it % S;
          if (it >= S) mbar_wait(&empty[s], (it / S - 1) & 1);
          unsigned char* st = smem + s * L::STAGE;
          mbar_expect_tx(&full[s], L::STAGE);
          tma_load_2d(st, &tg, &full[s], step * 64, m0);
          tma_load_2d(st + L::G, &ty, &full[s], step * 64, m0);
          tma_load_2d(st + 2 * L::G, &tw, &full[s], step * 64, n0);
        }
      }
    }
    return;
  }

  const int wg = threadIdx.x / 128, lane = threadIdx.x % 32;
  const int quad = lane / 4, tq = lane % 4;
  const int r16 = (threadIdx.x / 32 % 4) * 16 + quad;  // row of the WG's 64
  // byte offset of the thread's first row in a [128][64] box and of its
  // channel pair in a 16-byte chunk; the second row is 8 on, and both
  // rows sit at r % 8 == quad
  const int off0 = (wg * 64 + r16) * 128 + tq * 4;
  int it = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int m0 = tile / tiles_n * 128, n0 = tile % tiles_n * TN;
    float acc[TN / 2];
#pragma unroll
    for (int i = 0; i < TN / 2; ++i) acc[i] = 0.0f;
    for (int step = 0; step < steps; ++step, ++it) {
      const int s = it % S;
      mbar_wait(&full[s], (it / S) & 1);
      const unsigned char* st = smem + s * L::STAGE;
      // A fragment [kk][2h + r]: row r16 + 8r, channels 16kk + 8h + 2tq
      // and + 1 of the k-step
      uint32_t af[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int c = step * 64 + 16 * kk + 8 * h + 2 * tq;
          BnChan k[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            k[e].mu = tab[c + e];
            k[e].inv = tab[co + c + e];
            k[e].a = tab[2 * co + c + e];
            k[e].b = tab[3 * co + c + e];
            k[e].c = tab[4 * co + c + e];
            k[e].gamma = RELU ? tab[5 * co + c + e] : 0.0f;
            k[e].beta = RELU ? tab[6 * co + c + e] : 0.0f;
          }
          const int off = off0 + (((2 * kk + h) ^ quad) << 4);
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const __nv_bfloat162 gv = *reinterpret_cast<const __nv_bfloat162*>(
                st + off + r * 8 * 128);
            const __nv_bfloat162 yv = *reinterpret_cast<const __nv_bfloat162*>(
                st + L::G + off + r * 8 * 128);
            af[kk][2 * h + r] =
                pack(bn_dy<RELU>(__low2float(gv), __low2float(yv), k[0]),
                     bn_dy<RELU>(__high2float(gv), __high2float(yv), k[1]));
          }
        }
      }
      const uint32_t wb = smem_u32(st + 2 * L::G);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs_k<TN>(acc, af[kk], desc_k(wb + kk * 32));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      mbar_arrive(&empty[s]);
    }

    // accumulator element e: row r16 + 8*((e >> 1) & 1), column
    // 8*(e >> 2) + 2tq + (e & 1); out through swizzled [64][64] boxes
    unsigned char* epi = smem + L::RING + wg * (L::EPI / 2);
    const bool leader = threadIdx.x % 128 == 0;
    if (leader) bulk_wait<0, true>();       // the last store has read epi
    named_sync(1 + wg, 128);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = r16 + 8 * half;
#pragma unroll
      for (int j = 0; j < TN / 8; ++j)
        *reinterpret_cast<uint32_t*>(epi + (j / 8) * K8_BOX + r * 128 +
                                     (((j % 8) ^ (r % 8)) * 16) + tq * 4) =
            pack(acc[4 * j + 2 * half], acc[4 * j + 2 * half + 1]);
    }
    fence_proxy_async();
    named_sync(1 + wg, 128);
    if (leader) {
#pragma unroll
      for (int b = 0; b < TN / 64; ++b)
        tma_store_2d(&tdx, epi + b * K8_BOX, n0 + 64 * b, m0 + wg * 64);
      bulk_commit();
    }
  }
  if (threadIdx.x % 128 == 0) bulk_wait<0, false>();
}

// dW partial [chunk][ci, co] = x[chunk rows]^T . dy[chunk rows]: M = ci,
// N = co, k over rows, both operands MN-major (channels contiguous), as
// K7's dW. dy is wgmma's B operand, so it must sit in shared memory: the
// consumers form it in place of the stage's g (same box, same swizzle),
// each issues fence.proxy.async, a named barrier over every consumer
// thread orders the writes before the wgmma that reads them, and the stage
// is released only once that wgmma group is done (one group stays in
// flight while the next stage's dy is formed). A thread forms the same 8
// channels of every row it takes for the whole tile, so it holds their
// constants in registers, loaded once a tile. The block tile is
// [64*MW ci] x [NW*TNW co] over MW*NW consumer warpgroups of 64 x TNW:
//   MW 2, NW 1 where ci is a multiple of 128 (TNW 128, or 64 where co is
//     not a multiple of 128): the two warpgroups share one dy;
//   MW 1, NW 2, TNW 128 where ci is not and co is a multiple of 256
//     (64 -> 256: x read once, dy formed once);
//   MW 1, NW 1, TNW 64 otherwise (64 -> 64: one warpgroup a block).
// The chunk split over rows is k8_dw_chunks (conv_vjp.py); the partials
// are added by reduce_chunks in a fixed order. ptxas (CUDA 12.8): 118-163
// registers over the eight instances, no spills; 222,256 bytes of dynamic
// shared memory at most (64 x 256 tiles, 3 stages).
template <int MW, int NW, int TNW>
struct K8Dw {
  static constexpr int CONSUMERS = 128 * MW * NW;
  static constexpr int TNB = NW * TNW;                 // the block's co
  static constexpr int X = MW * K8_BOX;                // MW [64][64] x boxes
  static constexpr int G = TNB / 64 * K8_BOX;          // g (then dy), y
  static constexpr int STAGE = X + 2 * G;
  static constexpr int STAGES = 4 * STAGE <= 196608 ? 4 : 3;
  static constexpr int BAR = STAGES * STAGE;
  static constexpr size_t BYTES = (size_t)BAR + 2 * STAGES * 8 + 1024;
};

template <int TNW>
__device__ __forceinline__ void wgmma_ss_mn(float (&d)[TNW / 2], uint64_t da,
                                            uint64_t db) {
  if constexpr (TNW == 64)
    wgmma_ss_n64<1, 1>(d, da, db, 1);
  else
    wgmma_ss_n128<1, 1>(d, da, db, 1);
}

template <int MW, int NW, int TNW, bool RELU>
__global__ void __launch_bounds__(K8Dw<MW, NW, TNW>::CONSUMERS + 32, 1)
k8_dw_wgmma_kernel(const __grid_constant__ CUtensorMap tx,
                   const __grid_constant__ CUtensorMap tg,
                   const __grid_constant__ CUtensorMap ty,
                   float* __restrict__ part, Bn bn, int n, int ci, int co,
                   int rows_per_chunk, int tiles) {
  using L = K8Dw<MW, NW, TNW>;
  constexpr int S = L::STAGES, NT = L::CONSUMERS;
  constexpr int QN = L::TNB / 8;             // 16-byte chunks of a dy row
  constexpr int ROWS_AT_ONCE = NT / QN;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BAR);
  uint64_t* empty = full + S;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NT);
    }
    mbar_fence_init();
  }
  __syncthreads();

  // tiles: co tile fastest, then ci tile, then row chunk
  const int tiles_n = co / L::TNB, tiles_m = ci / (64 * MW);
  if (threadIdx.x >= NT) {                           // the producer warp
    if (threadIdx.x == NT) {
      int it = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int n0 = tile % tiles_n * L::TNB;
        const int m0 = tile / tiles_n % tiles_m * 64 * MW;
        const int k0 = tile / (tiles_n * tiles_m) * rows_per_chunk;
        const int steps = (min(n, k0 + rows_per_chunk) - k0 + 63) / 64;
        for (int step = 0; step < steps; ++step, ++it) {
          const int s = it % S;
          if (it >= S) mbar_wait(&empty[s], (it / S - 1) & 1);
          unsigned char* st = smem + s * L::STAGE;
          const int k = k0 + step * 64;
          mbar_expect_tx(&full[s], L::STAGE);
#pragma unroll
          for (int b = 0; b < MW; ++b)
            tma_load_2d(st + b * K8_BOX, &tx, &full[s], m0 + 64 * b, k);
#pragma unroll
          for (int b = 0; b < L::TNB / 64; ++b) {
            tma_load_2d(st + L::X + b * K8_BOX, &tg, &full[s], n0 + 64 * b,
                        k);
            tma_load_2d(st + L::X + L::G + b * K8_BOX, &ty, &full[s],
                        n0 + 64 * b, k);
          }
        }
      }
    }
    return;
  }

  const int wg = threadIdx.x / 128, lane = threadIdx.x % 32;
  const int mi = MW == 2 ? wg : 0, ni = NW == 2 ? wg : 0;
  // the thread forms channels n0 + 8q .. + 7 (box q / 8, chunk q % 8) of
  // rows row_first, + ROWS_AT_ONCE, ...
  const int q = threadIdx.x % QN, row_first = threadIdx.x / QN;
  int it = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int n0 = tile % tiles_n * L::TNB;
    const int m0 = tile / tiles_n % tiles_m * 64 * MW;
    const int z = tile / (tiles_n * tiles_m), k0 = z * rows_per_chunk;
    const int steps = (min(n, k0 + rows_per_chunk) - k0 + 63) / 64;
    BnChan k[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) k[e] = bn_chan(bn, n0 + 8 * q + e);
    float acc[TNW / 2];
#pragma unroll
    for (int i = 0; i < TNW / 2; ++i) acc[i] = 0.0f;
    for (int step = 0; step < steps; ++step, ++it) {
      const int s = it % S;
      mbar_wait(&full[s], (it / S) & 1);
      unsigned char* gs = smem + s * L::STAGE + L::X;
#pragma unroll
      for (int i = 0; i < 64 / ROWS_AT_ONCE; ++i) {
        const int r = row_first + i * ROWS_AT_ONCE;
        const int off =
            (q / 8) * K8_BOX + r * 128 + (((q % 8) ^ (r % 8)) << 4);
        const uint4 gv = *reinterpret_cast<const uint4*>(gs + off);
        const uint4 yv = *reinterpret_cast<const uint4*>(gs + L::G + off);
        const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(&gv);
        const __nv_bfloat162* y2 = reinterpret_cast<const __nv_bfloat162*>(&yv);
        uint4 dy;
        uint32_t* d32 = reinterpret_cast<uint32_t*>(&dy);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          d32[e] = pack(
              bn_dy<RELU>(__low2float(g2[e]), __low2float(y2[e]), k[2 * e]),
              bn_dy<RELU>(__high2float(g2[e]), __high2float(y2[e]),
                          k[2 * e + 1]));
        *reinterpret_cast<uint4*>(gs + off) = dy;
      }
      fence_proxy_async();
      named_sync(1, NT);
      const uint32_t xa = smem_u32(smem + s * L::STAGE) + mi * K8_BOX;
      const uint32_t db = smem_u32(gs) + ni * (TNW / 64) * K8_BOX;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss_mn<TNW>(acc, desc_mn(xa + kk * 2048, K8_BOX),
                         desc_mn(db + kk * 2048, K8_BOX));
      wgmma_commit();
      wgmma_wait<1>();                  // the previous step's group is done
      if (step > 0) mbar_arrive(&empty[(it - 1) % S]);
    }
    wgmma_wait<0>();
    fence_regs(acc);
    mbar_arrive(&empty[(it - 1) % S]);

    // accumulator element e: row r16 + 8*((e >> 1) & 1), column
    // 8*(e >> 2) + 2tq + (e & 1); each quad writes a 32-byte sector
    const int r16 = (threadIdx.x / 32 % 4) * 16 + lane / 4;
    const int row0 = m0 + mi * 64 + r16;
    const int col0 = n0 + ni * TNW + 2 * (lane % 4);
    float* out = part + (size_t)z * ci * co;
#pragma unroll
    for (int half = 0; half < 2; ++half)
#pragma unroll
      for (int j = 0; j < TNW / 8; ++j)
        *reinterpret_cast<float2*>(out + (size_t)(row0 + 8 * half) * co +
                                   col0 + 8 * j) =
            make_float2(acc[4 * j + 2 * half], acc[4 * j + 2 * half + 1]);
  }
}

template <int TN, bool RELU>
cudaError_t k8_dx_launch(const void* g, const Bn& bn, const void* w, void* dx,
                         int n, int ci, int co, cudaStream_t s) {
  CUtensorMap tg, ty, tw, tdx;
  cudaError_t err = k7_map(&tg, g, n, co, 128);
  if (err == cudaSuccess) err = k7_map(&ty, bn.y, n, co, 128);
  if (err == cudaSuccess) err = k7_map(&tw, w, ci, co, TN);
  if (err == cudaSuccess) err = k7_map(&tdx, dx, n, ci, 64);
  int sms = 0;
  if (err == cudaSuccess) err = sm_count(&sms);
  const size_t smem = K8Dx<TN>::bytes(co);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(k8_dx_wgmma_kernel<TN, RELU>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
  if (err != cudaSuccess) return err;
  const long long tiles = (long long)((n + 127) / 128) * (ci / TN);
  if (tiles > INT_MAX) return cudaErrorInvalidValue;
  const int grid = (int)(tiles < sms ? tiles : sms);
  k8_dx_wgmma_kernel<TN, RELU><<<grid, K8_DX_THREADS, smem, s>>>(
      tg, ty, tw, tdx, bn, ci, co, (int)tiles);
  return cudaGetLastError();
}

template <int MW, int NW, int TNW, bool RELU>
cudaError_t k8_dw_launch(const void* x, const void* g, const Bn& bn,
                         void* ws, int n, int ci, int co, int rows_per_chunk,
                         int chunks, cudaStream_t s) {
  using L = K8Dw<MW, NW, TNW>;
  CUtensorMap tx, tg, ty;
  cudaError_t err = k7_map(&tx, x, n, ci, 64);
  if (err == cudaSuccess) err = k7_map(&tg, g, n, co, 64);
  if (err == cudaSuccess) err = k7_map(&ty, bn.y, n, co, 64);
  int sms = 0;
  if (err == cudaSuccess) err = sm_count(&sms);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(k8_dw_wgmma_kernel<MW, NW, TNW, RELU>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)L::BYTES);
  if (err != cudaSuccess) return err;
  const long long tiles =
      (long long)(co / L::TNB) * (ci / (64 * MW)) * chunks;
  if (tiles > INT_MAX) return cudaErrorInvalidValue;
  const int grid = (int)(tiles < sms ? tiles : sms);
  k8_dw_wgmma_kernel<MW, NW, TNW, RELU>
      <<<grid, L::CONSUMERS + 32, L::BYTES, s>>>(
          tx, tg, ty, (float*)ws, bn, n, ci, co, rows_per_chunk, (int)tiles);
  return cudaGetLastError();
}

template <bool RELU>
int k8_dx(const void* g, const Bn& bn, const void* w, void* dx, int n,
          int ci, int co, cudaStream_t s) {
  if (ci % 128 == 0)
    return (int)k8_dx_launch<128, RELU>(g, bn, w, dx, n, ci, co, s);
  return (int)k8_dx_launch<64, RELU>(g, bn, w, dx, n, ci, co, s);
}

// the block tiles of k8_dw_wgmma_kernel (see there); k8_dw_chunks
// (conv_vjp.py) plans the row chunks on the same choice
template <bool RELU>
int k8_dw(const void* x, const void* g, const Bn& bn, void* dw, void* ws,
          int n, int ci, int co, int rows_per_chunk, int chunks,
          cudaStream_t s) {
  cudaError_t err;
  if (ci % 128 == 0 && co % 128 == 0)
    err = k8_dw_launch<2, 1, 128, RELU>(x, g, bn, ws, n, ci, co,
                                        rows_per_chunk, chunks, s);
  else if (ci % 128 == 0)
    err = k8_dw_launch<2, 1, 64, RELU>(x, g, bn, ws, n, ci, co,
                                       rows_per_chunk, chunks, s);
  else if (co % 256 == 0)
    err = k8_dw_launch<1, 2, 128, RELU>(x, g, bn, ws, n, ci, co,
                                        rows_per_chunk, chunks, s);
  else
    err = k8_dw_launch<1, 1, 64, RELU>(x, g, bn, ws, n, ci, co,
                                       rows_per_chunk, chunks, s);
  if (err != cudaSuccess) return (int)err;
  return (int)reduce_chunks((const float*)ws, (float*)dw, chunks, ci * co, s);
}

template <bool BN>
int launch_colsum(const void* m, void* out, void* ws, int n, int c,
                  int rows_per_chunk, int chunks, const Bn& bn,
                  void* stream) {
  if (n <= 0 || c <= 0 || c % 8 || bad_chunks(n, rows_per_chunk, chunks, 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int cols_per_block = (c / 8 < 32 ? c / 8 : 32) * 8;
  dim3 grid((c + cols_per_block - 1) / cols_per_block, chunks);
  colsum_kernel<BN><<<grid, SUM_THREADS, 0, s>>>(
      (const bf16*)m, (float*)ws, n, c, rows_per_chunk, bn);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)reduce_chunks((const float*)ws, (float*)out, chunks,
                            (BN ? 2 : 1) * c, s);
}

}  // namespace

// ---------------------------------------------------------------------------
// plain C interface (loaded with ctypes). Each returns cudaGetLastError()
// after its launches, or cudaErrorInvalidValue for a shape it does not
// take. ws is f32 scratch of chunks * (products: ci*co; sums: k*c) floats;
// rows_per_chunk is a multiple of the 64-row k-step for the products.
// ---------------------------------------------------------------------------
extern "C" {

// K7: dx = g . w^T
int ko_conv1x1_bwd_dx(const void* g, const void* w, void* dx, int n, int ci,
                      int co, void* stream) {
  return k7_dx(g, w, dx, n, ci, co, stream);
}

// K7: dW = x^T . g (f32)
int ko_conv1x1_bwd_dw(const void* x, const void* g, void* dw, void* ws,
                      int n, int ci, int co, int rows_per_chunk, int chunks,
                      void* stream) {
  return k7_dw(x, g, dw, ws, n, ci, co, rows_per_chunk, chunks, stream);
}

// K8 phase 0: sums [2, co] = (sum g', sum g'.xhat)
int ko_bn_bwd_stats(const void* g, const void* y, const void* gamma,
                    const void* beta, const void* mu, const void* inv,
                    void* sums, void* ws, int n, int co, int relu,
                    int rows_per_chunk, int chunks, void* stream) {
  const Bn bn = make_bn(y, gamma, beta, mu, inv, nullptr, n, co, relu);
  return launch_colsum<true>(g, sums, ws, n, co, rows_per_chunk, chunks, bn,
                             stream);
}

// K8 phase 1: dx = dy . w^T
int ko_bn_bwd_dx(const void* g, const void* y, const void* w,
                 const void* gamma, const void* beta, const void* mu,
                 const void* inv, const void* sums, void* dx, int n, int ci,
                 int co, int relu, void* stream) {
  const Bn bn = make_bn(y, gamma, beta, mu, inv, sums, n, co, relu);
  if (bad_gemm(n, ci, co)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return relu ? k8_dx<true>(g, bn, w, dx, n, ci, co, s)
              : k8_dx<false>(g, bn, w, dx, n, ci, co, s);
}

// K8 phase 1: dW = x^T . dy (f32)
int ko_bn_bwd_dw(const void* x, const void* g, const void* y,
                 const void* gamma, const void* beta, const void* mu,
                 const void* inv, const void* sums, void* dw, void* ws,
                 int n, int ci, int co, int relu, int rows_per_chunk,
                 int chunks, void* stream) {
  const Bn bn = make_bn(y, gamma, beta, mu, inv, sums, n, co, relu);
  if (bad_gemm(n, ci, co) || bad_chunks(n, rows_per_chunk, chunks, 64))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return relu ? k8_dw<true>(x, g, bn, dw, ws, n, ci, co, rows_per_chunk,
                            chunks, s)
              : k8_dw<false>(x, g, bn, dw, ws, n, ci, co, rows_per_chunk,
                             chunks, s);
}

// K9: out [c] = f32 column sums of m [n, c]
int ko_channel_sum(const void* m, void* out, void* ws, int n, int c,
                   int rows_per_chunk, int chunks, void* stream) {
  return launch_colsum<false>(m, out, ws, n, c, rows_per_chunk, chunks, Bn{},
                              stream);
}

}  // extern "C"
