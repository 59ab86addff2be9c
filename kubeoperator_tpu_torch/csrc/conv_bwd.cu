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
//         gemm_dx_kernel<true>   phase 1: dx = dy . w^T  (ko_bn_bwd_dx)
//         gemm_dw_kernel<true>   phase 1: dW = x^T . dy  (ko_bn_bwd_dw)
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
// for: dx of 512->128 writes 103 MB, bound by bytes. At stage 1's 401,408
// rows and 64->256, K8 moves 514 MB for 26.3 GFLOP: bound by bytes (about
// 0.153 ms at 3.35 TB/s). K9 reads 205.5 MB: bytes again.
//
// What the design does about it. K7 runs on Hopper's warpgroup MMA: one
// main loop (k7_wgmma_kernel) serves both products, 128 x 128 output tiles
// over two consumer warpgroups of 64 rows, wgmma m64n128k16 straight from
// shared memory, fed by a 4-stage ring of 64-deep k-steps that one
// producer warp fills by TMA (128-byte swizzle; rows and channels past the
// edge arrive as zeros) under full/empty mbarriers, with one wgmma group in
// flight. dx reads g and w K-major; dW reads x and g MN-major (wgmma's
// transpose flags), so no operand is transposed in memory. Blocks are
// persistent, one an SM, and the ring runs on from tile to tile, so the
// next tile's loads overlap this tile's epilogue. dx leaves through shared
// memory and TMA stores of whole rows: at the stage-1 sites, with 2-4
// k-steps a tile, storing dx is most of the work, and 4-byte stores from
// registers had made it twice as slow. ptxas (CUDA 12.8): dx 104
// registers, dW 94, no spills; 164,928 bytes of dynamic shared memory
// (4 stages of 32 KB, 32 KB for dx's epilogue). 128 x 128 tiles need
// 64 FLOP a byte of L2 traffic, so dW at the 25,088- and 6,272-row sites
// stays 1.1-1.7x behind cuBLAS (larger tiles or clusters are the next
// step).
// K8's products run on mma.sync m16n8k16 (bf16 operands, f32 accumulators in
// registers) over 64x64 output tiles, 4 warps of 32x32, with 32-deep
// k-steps of bf16 tiles in shared memory. K8's dy is never written to
// memory: each product's tile loader forms dy = gamma*inv*(g' - sum g'/N -
// xhat*sum(g'.xhat)/N) from the g and y tiles as it stages them, rounded to
// bf16 as the TPU kernel rounds it (that loader does not map onto TMA as it
// is). Blocks run in parallel and in no order, so the dW sum over N, which
// the TPU kernel carried across its sequential grid in one VMEM block, is
// split in both: each block sums one chunk of rows into its own f32
// partial tile, and reduce_chunks_kernel adds the partials in a fixed
// order. The result does not depend on scheduling: two runs give the same
// bits. The column sums work the same way (a partial per row chunk, then
// the fixed-order reduction), and the phase barrier of K8 is launch order
// on the stream: stats, then dx, then dW. Tiles of w or of dW fit any Ci,
// Co, so the 2 MB w of the 2048->512 site is streamed tile by tile. dx and
// dW are separate launches, so K7 reads g twice and K8 reads g and y three
// times (the TPU kernel read g once, and K8 twice); the second read of g
// costs K7 at most ~15 us at 25,088 rows, where the resident w and f32 dW
// of the TPU's one-pass design would not fit a block's shared memory.
// K8's tile loads are not pipelined (several blocks on an SM hide each
// other's loads).

#include <climits>

#include <cuda_runtime.h>

#include "mma.cuh"
#include "sm90.cuh"

namespace {

constexpr int TM = 64, TN = 64, TK = 32;   // GEMM block tile and k-step
constexpr int NTHREADS = 128;               // 4 warps, 2 x 2, 32 x 32 each
constexpr int LDK = TK + 8;    // row stride of k-contiguous [64][TK] tiles
constexpr int LDN = TN + 8;    // row stride of [TK][64] tiles
constexpr int SUM_THREADS = 256;

// What K8's operand loader needs to form dy from g and y (unused by K7).
// sums holds [sum g' (= dbeta) | sum g'.xhat (= dgamma)], 2*Co floats.
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

// 8 channels [c, c+8) of dy from 8 of g and y (K8 phase 1)
__device__ __forceinline__ uint4 bn_dy8(uint4 gv, uint4 yv, int c,
                                        const Bn& bn) {
  float mu[8], inv[8], gm[8], bt[8], sg[8], sgx[8];
  load8(mu, bn.mu + c);
  load8(inv, bn.inv + c);
  load8(gm, bn.gamma + c);
  load8(bt, bn.beta + c);
  load8(sg, bn.sums + c);
  load8(sgx, bn.sums + bn.co + c);
  const bf16* gh = reinterpret_cast<const bf16*>(&gv);
  const bf16* yh = reinterpret_cast<const bf16*>(&yv);
  uint4 out;
  bf16* oh = reinterpret_cast<bf16*>(&out);
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    float xhat;
    const float gact = gate(__bfloat162float(gh[e]), __bfloat162float(yh[e]),
                            mu[e], inv[e], gm[e], bt[e], bn.relu, &xhat);
    const float t = __fsub_rn(__fsub_rn(gact, __fmul_rn(sg[e], bn.inv_n)),
                              __fmul_rn(xhat, __fmul_rn(sgx[e], bn.inv_n)));
    oh[e] = __float2bfloat16_rn(__fmul_rn(__fmul_rn(gm[e], inv[e]), t));
  }
  return out;
}

// Stage a [ROWS][COLS] bf16 tile of the row-major [*, ld] matrix m, rows
// from r0 (rows at or past n read as 0) and columns from c0, into shared
// memory with row stride LDS, 16 bytes per thread and step. With BN the
// tile is K8's dy, formed from m = g and bn.y.
template <bool BN, int ROWS, int COLS, int LDS>
__device__ __forceinline__ void stage(bf16* dst, const bf16* __restrict__ m,
                                      int ld, int r0, int c0, int n,
                                      const Bn& bn) {
  constexpr int VEC = COLS / 8;
  for (int idx = threadIdx.x; idx < ROWS * VEC; idx += NTHREADS) {
    const int r = idx / VEC, c = (idx % VEC) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    const int row = r0 + r;
    if (row < n) {
      const size_t off = (size_t)row * ld + c0 + c;
      v = *reinterpret_cast<const uint4*>(m + off);
      if (BN) v = bn_dy8(v, *reinterpret_cast<const uint4*>(bn.y + off),
                         c0 + c, bn);
    }
    *reinterpret_cast<uint4*>(dst + r * LDS + c) = v;
  }
}

// ---------------------------------------------------------------------------
// dx [n, ci] = G [n, co] . w[ci, co]^T, G = g (K7) or dy (K8). One block per
// 64 x 64 tile of dx; the k loop runs over co.
// ---------------------------------------------------------------------------
template <bool BN>
__global__ void __launch_bounds__(NTHREADS)
gemm_dx_kernel(const bf16* __restrict__ g, const bf16* __restrict__ w,
               bf16* __restrict__ dx, int n, int ci, int co, Bn bn) {
  __shared__ __align__(16) bf16 sA[TM * LDK];
  __shared__ __align__(16) bf16 sB[TN * LDK];
  const int r0 = blockIdx.x * TM, n0 = blockIdx.y * TN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gq = lane >> 2, tq = lane & 3;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;

  float acc[2][4][4] = {};
  for (int k0 = 0; k0 < co; k0 += TK) {
    stage<BN, TM, TK, LDK>(sA, g, co, r0, k0, n, bn);
    stage<false, TN, TK, LDK>(sB, w, co, n0, k0, ci, bn);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < TK; kk += 16) {
      uint32_t a[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        load_a<LDK>(a[mi], sA, wm + mi * 16, kk, gq, tq);
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        uint32_t b0, b1;
        load_b<LDK>(b0, b1, sB, wn + ni * 8, kk, gq, tq);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) mma(acc[mi][ni], a[mi], b0, b1);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = r0 + wm + mi * 16 + gq + 8 * half;
      if (row >= n) continue;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int col = n0 + wn + ni * 8 + 2 * tq;
        *reinterpret_cast<uint32_t*>(dx + (size_t)row * ci + col) =
            pack(acc[mi][ni][2 * half], acc[mi][ni][2 * half + 1]);
      }
    }
}

// ---------------------------------------------------------------------------
// part[chunk] [ci, co] = x[rows of chunk]^T . G[rows of chunk], f32, G = g
// (K7) or dy (K8). Grid (co/64, ci/64, chunks); chunk z covers rows
// [z*rows_per_chunk, min(n, (z+1)*rows_per_chunk)).
// ---------------------------------------------------------------------------
template <bool BN>
__global__ void __launch_bounds__(NTHREADS)
gemm_dw_kernel(const bf16* __restrict__ x, const bf16* __restrict__ g,
               float* __restrict__ part, int n, int ci, int co,
               int rows_per_chunk, Bn bn) {
  __shared__ __align__(16) bf16 sX[TK * LDN];
  __shared__ __align__(16) bf16 sG[TK * LDN];
  const int n0 = blockIdx.x * TN, m0 = blockIdx.y * TM;
  const int rbeg = blockIdx.z * rows_per_chunk;
  const int rend = min(n, rbeg + rows_per_chunk);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gq = lane >> 2, tq = lane & 3;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;

  float acc[2][4][4] = {};
  for (int k0 = rbeg; k0 < rend; k0 += TK) {
    stage<false, TK, TM, LDN>(sX, x, ci, k0, m0, rend, bn);
    stage<BN, TK, TN, LDN>(sG, g, co, k0, n0, rend, bn);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < TK; kk += 16) {
      uint32_t a[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        load_at<LDN>(a[mi], sX, kk, wm + mi * 16, lane);
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {
        uint32_t b[4];
        load_bt2<LDN>(b, sG, kk, wn + nj * 16, lane);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          mma(acc[mi][2 * nj], a[mi], b[0], b[1]);
          mma(acc[mi][2 * nj + 1], a[mi], b[2], b[3]);
        }
      }
    }
    __syncthreads();
  }
  float* out = part + (size_t)blockIdx.z * ci * co;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = m0 + wm + mi * 16 + gq + 8 * half;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int col = n0 + wn + ni * 8 + 2 * tq;
        *reinterpret_cast<float2*>(out + (size_t)row * co + col) =
            make_float2(acc[mi][ni][2 * half], acc[mi][ni][2 * half + 1]);
      }
    }
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
  return n <= 0 || ci <= 0 || co <= 0 || ci % TM || co % TN ||
         ci / TM > 65535;
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

template <bool DW>
cudaError_t k7_launch(const CUtensorMap& ta, const CUtensorMap& tb,
                      const CUtensorMap& tc, void* out, int n, int ci, int co,
                      int rows_per_chunk, int chunks, cudaStream_t s) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
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

template <bool BN>
int launch_dx(const void* g, const void* w, void* dx, int n, int ci, int co,
              const Bn& bn, void* stream) {
  if (bad_gemm(n, ci, co)) return (int)cudaErrorInvalidValue;
  dim3 grid((n + TM - 1) / TM, ci / TN);
  gemm_dx_kernel<BN><<<grid, NTHREADS, 0, (cudaStream_t)stream>>>(
      (const bf16*)g, (const bf16*)w, (bf16*)dx, n, ci, co, bn);
  return (int)cudaGetLastError();
}

template <bool BN>
int launch_dw(const void* x, const void* g, void* dw, void* ws, int n,
              int ci, int co, int rows_per_chunk, int chunks, const Bn& bn,
              void* stream) {
  if (bad_gemm(n, ci, co) || bad_chunks(n, rows_per_chunk, chunks, TK))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  dim3 grid(co / TN, ci / TM, chunks);
  gemm_dw_kernel<BN><<<grid, NTHREADS, 0, s>>>(
      (const bf16*)x, (const bf16*)g, (float*)ws, n, ci, co, rows_per_chunk,
      bn);
  cudaError_t err = cudaGetLastError();
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
// rows_per_chunk is a multiple of 32 for the products.
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
  return launch_dx<true>(g, w, dx, n, ci, co, bn, stream);
}

// K8 phase 1: dW = x^T . dy (f32)
int ko_bn_bwd_dw(const void* x, const void* g, const void* y,
                 const void* gamma, const void* beta, const void* mu,
                 const void* inv, const void* sums, void* dw, void* ws,
                 int n, int ci, int co, int relu, int rows_per_chunk,
                 int chunks, void* stream) {
  const Bn bn = make_bn(y, gamma, beta, mu, inv, sums, n, co, relu);
  return launch_dw<true>(x, g, dw, ws, n, ci, co, rows_per_chunk, chunks, bn,
                         stream);
}

// K9: out [c] = f32 column sums of m [n, c]
int ko_channel_sum(const void* m, void* out, void* ws, int n, int c,
                   int rows_per_chunk, int chunks, void* stream) {
  return launch_colsum<false>(m, out, ws, n, c, rows_per_chunk, chunks, Bn{},
                              stream);
}

}  // extern "C"
