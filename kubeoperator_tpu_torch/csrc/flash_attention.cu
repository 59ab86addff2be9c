// Flash attention for Hopper (sm_90a): forward, dQ backward, dK/dV backward,
// on two memory layouts.
//
// Replaces six Pallas TPU kernels of the JAX package's
// kubeoperator_tpu/workloads/flash_attention.py:
//   flash_fwd_wgmma_kernel<D>      <- _fwd / _fwd_kernel                  (K1)
//                                  <- _fwd_packed / _fwd_packed_kernel    (K4)
//   flash_bwd_dq_wgmma_kernel<D>   <- _bwd / _bwd_dq_kernel               (K2)
//   flash_bwd_dkv_wgmma_kernel<D>  <- _bwd / _bwd_dkv_kernel              (K3)
//   flash_bwd_dq_kernel<D, true>   <- _bwd_packed / _bwd_dq_packed_kernel (K5)
//   flash_bwd_dkv_kernel<D, true>  <- _bwd_packed / _bwd_dkv_packed_kernel
//                                                                         (K6)
//
// Layout: q, k, v, o, do, dq, dk, dv are bf16, contiguous, either
// [BH, T, D] (the "bh" layout) or [B, T, nh*D] (the "packed" layout: the
// attention projections' [B, T, H, D] output read in place, with no
// transpose). One block works on one head: blockIdx.y = b*nh + h, the
// head's rows start at b*T*nh*D + h*D and are nh*D apart; the bh layout is
// that with nh = 1. lse and delta are [B*nh, T] f32 in both (the TPU
// kernels stored [.., 8, T] only to satisfy Mosaic's (8, 128) tiling). T is
// a multiple of the 64-row tile (the Python wrapper pads), D is 64 or 128.
// Keys at or past kv_len are masked to -1e30, causal masks row < col the
// same way, and the causal loop bounds equal the JAX kernels' `hi` and
// `lo`. The TPU packed kernels also walked several batch rows and every
// head in one program (`_bb_packed`), a VMEM tuning with no counterpart
// here: a block per (tile, head) already fills the 132 SMs at the ViT shape.
//
// What bounds them on the H100: at the LM's path shape (BH=128, T=2048,
// D=128, causal) each kernel does 2-4 matrix products of T x T x D per head
// and moves only O(T*D) bytes, so all three are bound by tensor-core
// operations (989 TFLOP/s bf16 dense), not by the 3.35 TB/s of HBM. At
// ViT-B/16's shape (B=128, H=12, T=196 padded to 256, D=64, non-causal)
// the sequence is short, and the same kernels are bound by the bytes they
// must move (K4: 154 MB of real rows, 0.046 ms at 3.35 TB/s, against
// 0.02 ms of tensor-core work).
//
// What the design does about it. K1-K4 run on Hopper's warpgroup MMA
// (flash_fwd_wgmma_kernel, flash_bwd_dq_wgmma_kernel and
// flash_bwd_dkv_wgmma_kernel, each described where it is defined):
// 128-row tiles over two consumer warpgroups of 64 rows, the streamed
// operand through a 3- or 4-stage TMA ring of 64-row tiles under
// mbarriers, the score-type products (S = Q.K^T, dP = dO.V^T, or their
// transposes) as wgmma from shared memory, and the probabilities (or dS)
// kept in registers as the A operand of the next product. The forward
// takes both layouts through one tensor map over [B, T, nh*D] (the head's
// box at column h*D); K2 and K3 run on the bh layout. K5 and K6 stay on
// mma.sync m16n8k16 (bf16 operands, f32 accumulation) with the
// accumulators in registers: one block of 4 warps owns a 64-row tile and
// each warp owns 16 rows of it, so a row's softmax statistics live in the
// four lanes that hold it and the T x T scores never leave registers;
// shared memory holds only the bf16 input tiles, loaded unpipelined
// between barriers (about 70 KB a block at D=128), so several blocks
// share an SM and hide each other's loads. As in the TPU kernels, the dQ
// kernel and the dK/dV kernel are separate, so no block reduces across
// another (no atomics) and every output is the same bits every run. In
// all of them the probabilities are rounded to bf16 before the P.V-type
// products. Moving K5 and K6 onto the wgmma kernels is the same tensor map.

#include <climits>

#include <cuda_runtime.h>

#include "mma.cuh"
#include "sm90.cuh"

namespace {

constexpr int BQ = 64;        // query rows per tile
constexpr int BK = 64;        // key rows per tile
constexpr int NWARPS = 4;     // each warp owns 16 rows of the block's tile
constexpr int NTHREADS = NWARPS * 32;
constexpr float NEG_INF = -1e30f;

// bf16 row stride (elements) of the shared tiles: rows stay 16-byte
// aligned and the fragment loads of 8 rows hit 8 different bank groups
template <int D> struct Ld { static constexpr int H = D + 8; };

// copy a [64][D] bf16 tile from global (row stride ld elements) into
// shared memory (row stride LD), 16 bytes per thread per step
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int ld) {
  constexpr int LD = Ld<D>::H, VEC = D / 8;
  for (int idx = threadIdx.x; idx < 64 * VEC; idx += NTHREADS) {
    const int r = idx / VEC, c = idx % VEC;
    *reinterpret_cast<uint4*>(dst + r * LD + c * 8) =
        *reinterpret_cast<const uint4*>(src + (size_t)r * ld + c * 8);
  }
}

// where a block's head starts (blockIdx.y is b*nh + h); each kernel's
// global row stride is PACKED ? nh*D : D. The mma.sync kernels now serve
// the packed layout alone (K5-K6; the others take the wgmma kernels
// below), so PACKED is always true where they are launched; the bh case is
// the one they were written for, with nh = 1 and the constant stride D.
template <int D, bool PACKED>
__device__ __forceinline__ size_t head_base(int t, int nh) {
  if (!PACKED) return (size_t)blockIdx.y * t * D;
  const int b = blockIdx.y / nh, h = blockIdx.y % nh;
  return ((size_t)b * t * nh + h) * D;
}

// accumulator element e of an m16n8 tile sits at row g + 8*(e >> 1),
// column 2*tq + (e & 1); its A-operand image for a k16 step is the pair of
// n-tiles (2kk, 2kk+1)
__device__ __forceinline__ void to_a(uint32_t* a, const float* lo,
                                     const float* hi) {
  a[0] = pack(lo[0], lo[1]);
  a[1] = pack(lo[2], lo[3]);
  a[2] = pack(hi[0], hi[1]);
  a[3] = pack(hi[2], hi[3]);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// ---------------------------------------------------------------------------
// K2/K5: dQ. One block per (q-tile, head); loops over K/V tiles up to the
// diagonal. P and dS stay in registers; dQ accumulates in registers.
// Replaces workloads/flash_attention.py::_bwd_dq_kernel (launched by _bwd)
// and ::_bwd_dq_packed_kernel (launched by _bwd_packed).
// ---------------------------------------------------------------------------
template <int D, bool PACKED>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, bf16* __restrict__ dq,
                    int t, int nh, float scale, int causal, int kv_len) {
  constexpr int LD = Ld<D>::H;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sDO = sQ + BQ * LD;
  bf16* sK = sDO + BQ * LD;
  bf16* sV = sK + BK * LD;

  const int qt = blockIdx.x, bh = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tq = lane & 3;
  const size_t base = head_base<D, PACKED>(t, nh);
  const int ld = PACKED ? nh * D : D;         // global row stride
  const int row0 = qt * BQ + warp * 16 + g;

  load_tile<D>(sQ, q + base + (size_t)qt * BQ * ld, ld);
  load_tile<D>(sDO, dout + base + (size_t)qt * BQ * ld, ld);
  const float lse_r[2] = {lse[(size_t)bh * t + row0], lse[(size_t)bh * t + row0 + 8]};
  const float delta_r[2] = {delta[(size_t)bh * t + row0],
                            delta[(size_t)bh * t + row0 + 8]};

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;

  const int n_kv = t / BK;
  const int hi = causal ? min((qt + 1) * BQ + BK - 1, n_kv * BK) / BK : n_kv;
  for (int j = 0; j < hi; ++j) {
    __syncthreads();
    load_tile<D>(sK, k + base + (size_t)j * BK * ld, ld);
    load_tile<D>(sV, v + base + (size_t)j * BK * ld, ld);
    __syncthreads();

    float s[BK / 8][4], dp[BK / 8][4];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.0f;
      dp[n][0] = dp[n][1] = dp[n][2] = dp[n][3] = 0.0f;
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t aq[4], ado[4];
      load_a<LD>(aq, sQ, warp * 16, kk * 16, g, tq);
      load_a<LD>(ado, sDO, warp * 16, kk * 16, g, tq);
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) {
        uint32_t b0, b1;
        load_b<LD>(b0, b1, sK, n * 8, kk * 16, g, tq);
        mma(s[n], aq, b0, b1);                  // S = Q.K^T
        load_b<LD>(b0, b1, sV, n * 8, kk * 16, g, tq);
        mma(dp[n], ado, b0, b1);                // dP = dO.V^T
      }
    }
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = row0 + 8 * (e >> 1);
        const int col = j * BK + n * 8 + 2 * tq + (e & 1);
        float x = s[n][e] * scale;
        if (causal && row < col) x = NEG_INF;
        if (col >= kv_len) x = NEG_INF;
        const float p = __expf(x - lse_r[e >> 1]);
        s[n][e] = p * (dp[n][e] - delta_r[e >> 1]);   // dS
      }
    }
    // dQ += dS . K
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t da[4];
      to_a(da, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int n = 0; n < D / 8; n += 2) {
        uint32_t b[4];
        load_bt2<LD>(b, sK, kk * 16, n * 8, lane);
        mma(acc[n], da, b[0], b[1]);
        mma(acc[n + 1], da, b[2], b[3]);
      }
    }
  }

  bf16* d0 = dq + base + (size_t)row0 * ld + 2 * tq;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    *reinterpret_cast<uint32_t*>(d0 + n * 8) = pack(acc[n][0] * scale, acc[n][1] * scale);
    *reinterpret_cast<uint32_t*>(d0 + 8 * ld + n * 8) =
        pack(acc[n][2] * scale, acc[n][3] * scale);
  }
}

// ---------------------------------------------------------------------------
// K3/K6: dK and dV, replacing workloads/flash_attention.py::_bwd_dkv_kernel
// (launched by _bwd) and ::_bwd_dkv_packed_kernel (launched by _bwd_packed).
// One block per (k-tile, head); loops over Q tiles from the
// JAX kernel's `lo`. Works on transposed scores S^T = K.Q^T so that each
// warp owns 16 key rows and keeps their dK/dV in registers; each Q tile is
// taken in two 32-row halves to bound the live score registers.
// ---------------------------------------------------------------------------
template <int D, bool PACKED>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, int t, int nh, float scale,
                     int causal, int kv_len) {
  constexpr int LD = Ld<D>::H, QH = 32;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = sK + BK * LD;
  bf16* sQ = sV + BK * LD;
  bf16* sDO = sQ + BQ * LD;
  float* sL = reinterpret_cast<float*>(sDO + BQ * LD);
  float* sD = sL + BQ;

  const int kt = blockIdx.x, bh = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tq = lane & 3;
  const size_t base = head_base<D, PACKED>(t, nh);
  const int ld = PACKED ? nh * D : D;         // global row stride
  const int key0 = kt * BK + warp * 16 + g;   // keys of elements 0,1; +8: 2,3

  load_tile<D>(sK, k + base + (size_t)kt * BK * ld, ld);
  load_tile<D>(sV, v + base + (size_t)kt * BK * ld, ld);

  float acc_dk[D / 8][4], acc_dv[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    acc_dk[n][0] = acc_dk[n][1] = acc_dk[n][2] = acc_dk[n][3] = 0.0f;
    acc_dv[n][0] = acc_dv[n][1] = acc_dv[n][2] = acc_dv[n][3] = 0.0f;
  }

  const int n_q = t / BQ;
  const int lo = causal ? (kt * BK) / BQ : 0;
  for (int i = lo; i < n_q; ++i) {
    __syncthreads();
    load_tile<D>(sQ, q + base + (size_t)i * BQ * ld, ld);
    load_tile<D>(sDO, dout + base + (size_t)i * BQ * ld, ld);
    for (int r = threadIdx.x; r < BQ; r += NTHREADS) {
      sL[r] = lse[(size_t)bh * t + i * BQ + r];
      sD[r] = delta[(size_t)bh * t + i * BQ + r];
    }
    __syncthreads();

#pragma unroll
    for (int h0 = 0; h0 < BQ; h0 += QH) {
      float st[QH / 8][4], dpt[QH / 8][4];
#pragma unroll
      for (int n = 0; n < QH / 8; ++n) {
        st[n][0] = st[n][1] = st[n][2] = st[n][3] = 0.0f;
        dpt[n][0] = dpt[n][1] = dpt[n][2] = dpt[n][3] = 0.0f;
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t ak[4], av[4];
        load_a<LD>(ak, sK, warp * 16, kk * 16, g, tq);
        load_a<LD>(av, sV, warp * 16, kk * 16, g, tq);
#pragma unroll
        for (int n = 0; n < QH / 8; ++n) {
          uint32_t b0, b1;
          load_b<LD>(b0, b1, sQ, h0 + n * 8, kk * 16, g, tq);
          mma(st[n], ak, b0, b1);               // S^T = K.Q^T
          load_b<LD>(b0, b1, sDO, h0 + n * 8, kk * 16, g, tq);
          mma(dpt[n], av, b0, b1);              // dP^T = V.dO^T
        }
      }
#pragma unroll
      for (int n = 0; n < QH / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = key0 + 8 * (e >> 1);
          const int qi = h0 + n * 8 + 2 * tq + (e & 1);
          float x = st[n][e] * scale;
          if (causal && i * BQ + qi < key) x = NEG_INF;
          if (key >= kv_len) x = NEG_INF;
          const float p = __expf(x - sL[qi]);
          st[n][e] = p;                                  // P^T
          dpt[n][e] = p * (dpt[n][e] - sD[qi]);          // dS^T
        }
      }
      // dV += P^T . dO ;  dK += dS^T . Q
#pragma unroll
      for (int kk = 0; kk < QH / 16; ++kk) {
        uint32_t pa[4], da[4];
        to_a(pa, st[2 * kk], st[2 * kk + 1]);
        to_a(da, dpt[2 * kk], dpt[2 * kk + 1]);
#pragma unroll
        for (int n = 0; n < D / 8; n += 2) {
          uint32_t b[4];
          load_bt2<LD>(b, sDO, h0 + kk * 16, n * 8, lane);
          mma(acc_dv[n], pa, b[0], b[1]);
          mma(acc_dv[n + 1], pa, b[2], b[3]);
          load_bt2<LD>(b, sQ, h0 + kk * 16, n * 8, lane);
          mma(acc_dk[n], da, b[0], b[1]);
          mma(acc_dk[n + 1], da, b[2], b[3]);
        }
      }
    }
  }

  // the TPU kernel pre-scaled Q; here dK = (dS^T . Q) * scale, once
  bf16* k0p = dk + base + (size_t)key0 * ld + 2 * tq;
  bf16* v0p = dv + base + (size_t)key0 * ld + 2 * tq;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    *reinterpret_cast<uint32_t*>(k0p + n * 8) =
        pack(acc_dk[n][0] * scale, acc_dk[n][1] * scale);
    *reinterpret_cast<uint32_t*>(k0p + 8 * ld + n * 8) =
        pack(acc_dk[n][2] * scale, acc_dk[n][3] * scale);
    *reinterpret_cast<uint32_t*>(v0p + n * 8) = pack(acc_dv[n][0], acc_dv[n][1]);
    *reinterpret_cast<uint32_t*>(v0p + 8 * ld + n * 8) = pack(acc_dv[n][2], acc_dv[n][3]);
  }
}

// dynamic shared-memory bytes of each kernel (must match the carve-up above)
template <int D> constexpr size_t dq_smem() { return (size_t)4 * 64 * Ld<D>::H * 2; }
template <int D> constexpr size_t dkv_smem() {
  return (size_t)4 * 64 * Ld<D>::H * 2 + (size_t)2 * BQ * 4;
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// ---------------------------------------------------------------------------
// K1 and K4 on wgmma: the forward on either layout. Replaces the JAX
// package's workloads/flash_attention.py::_fwd_kernel (launched by _fwd;
// the bh layout, nh = 1) and ::_fwd_packed_kernel (launched by
// _fwd_packed; the packed layout, nh heads). One block per (128-row Q
// tile, head), blockIdx.x the tile taken from the end and blockIdx.y the
// head: a head's tiles run side by side, so its K and V are read from HBM
// about once and then from L2 (with the head fastest, each block would
// read them from HBM again: ~1.1 GB at the LM's shape), and within a head
// the heavy causal tiles start first. Two consumer warpgroups own 64 rows
// of the tile each; one producer thread loads Q once and K and V through a
// ring of F_STAGES 64-key tiles, by TMA (3-D tensor maps over
// [B, T, nh*D], so rows past T arrive as zeros) with full/empty mbarriers.
// Per key tile a consumer runs S = Q.K^T as wgmma m64n64k16 from shared
// memory (both K-major), the online softmax in registers on the
// accumulator layout (a row's values sit in the 4 lanes of a quad), rounds
// P to bf16 in registers and runs O += P.V as wgmma m64nDk16 with P as the
// register A operand and V MN-major (the transpose flag). Masks only on
// tiles that cross the diagonal (causal) or reach past kv_len; every row
// below T, padded rows included, gets O and a finite lse (K5 and K6 read
// lse there). At the LM's path shape (BH 128, T 2048, D 128, causal: 137
// GFLOP, 0.139 ms at 989 TFLOP/s) it is bound by operations; at ViT's
// (B 128, H 12, T 256, D 64, 3,072 blocks of four key tiles) by bytes,
// where each block's barrier set-up, Q load and epilogue would run exposed
// with one block an SM (117 registers a thread at D = 64 allow one): so at
// D = 64 two blocks share an SM (the launch bounds hold a thread to the 96
// registers that leaves), and each key tile is taken in two 32-key halves,
// whose scores take 16 registers where 64 keys took 32; with whole tiles
// the cap spilled. ptxas (CUDA 12.8): 151 registers at D = 128, 93 at
// D = 64, no spills; 132,200 / 66,664 bytes of dynamic shared memory.
// An FA3-style schedule (tile j's softmax under tile j-1's P.V, the two
// warpgroups taking turns by named barriers) measured no faster here, and
// with 128-key tiles it needs more than the 168 registers a thread that a
// 3-warpgroup block gets, so this loop stays serial within a warpgroup.
// ---------------------------------------------------------------------------
constexpr int F_TILE = 128;                  // query rows per block
constexpr int F_KEYS = 64;                   // keys per K/V tile
constexpr int F_STAGES = 3;                  // K/V tiles in flight
constexpr int F_CONSUMERS = 256;             // 2 warpgroups
constexpr int F_THREADS = F_CONSUMERS + 32;  // + the producer warp
constexpr int F_QBOX = F_TILE * 128;         // bytes of a [128][64] Q box
constexpr int F_KBOX = F_KEYS * 128;         // bytes of a [64][64] K/V box

template <int D>
struct FwdSmem {
  static constexpr int QT = D / 64 * F_QBOX;     // the [128][D] Q tile
  static constexpr int KV = D / 64 * F_KBOX;     // a [64][D] K or V tile
  static constexpr int Q = 0, K = QT, V = K + F_STAGES * KV;
  static constexpr int BAR = V + F_STAGES * KV;
  static constexpr size_t BYTES =
      (size_t)BAR + (1 + 4 * F_STAGES) * sizeof(uint64_t) + 1024;
};

constexpr float LOG2E = 1.4426950408889634f;

// 2^x by the special-function unit (2^-1e30 is 0)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// d[64 x D] += A.B over one k16 step: A the warpgroup's bf16 register
// operand, B a [16][D] slice of MN-major boxes in shared memory (O += P.V,
// dQ += dS.K, dV += P^T.dO, dK += dS^T.Q)
template <int D>
__device__ __forceinline__ void wgmma_rs_d(float (&d)[D / 2],
                                           const uint32_t (&a)[4], uint64_t db) {
  if constexpr (D == 64)
    wgmma_rs_n64<1>(d, a, db);
  else
    wgmma_rs_n128<1>(d, a, db);
}

// The online softmax of SK keys' scores sc (element e: the thread's row
// (e >> 1) & 1, key col0 + 8*(e >> 2) + (e & 1)) in log2 units: keys at or
// past lim[i] masked for row i, running max m and sum l updated, the
// factor alpha that rescales what O held, and P = 2^(s - m) left in sc.
template <int SK>
__device__ __forceinline__ void online_softmax(float (&sc)[SK / 2],
                                               float (&m)[2], float (&l)[2],
                                               float (&alpha)[2],
                                               float scale_log2,
                                               const int (&lim)[2], int col0) {
  float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
  for (int e = 0; e < SK / 2; ++e) {
    const int i = (e >> 1) & 1, col = col0 + 8 * (e >> 2) + (e & 1);
    const float x = col < lim[i] ? sc[e] * scale_log2 : NEG_INF;
    sc[e] = x;
    mx[i] = fmaxf(mx[i], x);
  }
  float sum[2] = {0.0f, 0.0f};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float m_new = fmaxf(m[i], quad_max(mx[i]));
    alpha[i] = exp2_approx(m[i] - m_new);
    m[i] = m_new;
  }
#pragma unroll
  for (int e = 0; e < SK / 2; ++e) {
    sc[e] = exp2_approx(sc[e] - m[(e >> 1) & 1]);
    sum[(e >> 1) & 1] += sc[e];
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + quad_sum(sum[i]);
}

// S = Q.K^T over SK keys (both operands K-major)
template <int SK>
__device__ __forceinline__ void wgmma_scores(float (&d)[SK / 2], uint64_t da,
                                             uint64_t db, int scale_d) {
  if constexpr (SK == 32)
    wgmma_ss_n32<0, 0>(d, da, db, scale_d);
  else
    wgmma_ss_n64<0, 0>(d, da, db, scale_d);
}

template <int D>
__global__ void __launch_bounds__(F_THREADS, D == 64 ? 2 : 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       bf16* __restrict__ o, float* __restrict__ lse, int t,
                       int nh, float scale_log2, int causal, int kv_len) {
  using S = FwdSmem<D>;
  constexpr int BOXES = D / 64, SK = D == 64 ? 32 : 64;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_1024(smem_raw);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + S::BAR);
  uint64_t* k_full = q_full + 1;               // [F_STAGES] each
  uint64_t* v_full = k_full + F_STAGES;
  uint64_t* k_empty = v_full + F_STAGES;
  uint64_t* v_empty = k_empty + F_STAGES;

  const int bh = blockIdx.y, b = bh / nh, hcol = (bh % nh) * D;
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int n_kv = (t + F_KEYS - 1) / F_KEYS;
  // the JAX kernel's `hi`: key tiles past the diagonal are fully masked
  const int hi = causal ? min(((qt + 1) * F_TILE + F_KEYS - 1) / F_KEYS, n_kv)
                        : n_kv;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < F_STAGES; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&k_empty[s], F_CONSUMERS);
      mbar_init(&v_empty[s], F_CONSUMERS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= F_CONSUMERS) {                 // the producer warp
    if (threadIdx.x == F_CONSUMERS) {
      mbar_expect_tx(q_full, S::QT);
      for (int x = 0; x < BOXES; ++x)
        tma_load_3d(smem + S::Q + x * F_QBOX, &tq, q_full, hcol + x * 64,
                    qt * F_TILE, b);
      for (int j = 0; j < hi; ++j) {
        const int s = j % F_STAGES;
        const int parity = (j / F_STAGES - 1) & 1;
        if (j >= F_STAGES) mbar_wait(&k_empty[s], parity);
        mbar_expect_tx(&k_full[s], S::KV);
        for (int x = 0; x < BOXES; ++x)
          tma_load_3d(smem + S::K + s * S::KV + x * F_KBOX, &tk, &k_full[s],
                      hcol + x * 64, j * F_KEYS, b);
        if (j >= F_STAGES) mbar_wait(&v_empty[s], parity);
        mbar_expect_tx(&v_full[s], S::KV);
        for (int x = 0; x < BOXES; ++x)
          tma_load_3d(smem + S::V + s * S::KV + x * F_KBOX, &tv, &v_full[s],
                      hcol + x * 64, j * F_KEYS, b);
      }
    }
    return;
  }

  const int wg = threadIdx.x / 128;
  const int lane = threadIdx.x % 32, g = lane >> 2, tq4 = lane & 3;
  // rows of accumulator elements with ((e >> 1) & 1) == 0; +8 for the others
  const int row0 = qt * F_TILE + wg * 64 + ((threadIdx.x / 32) % 4) * 16 + g;
  const uint32_t q_addr = smem_u32(smem + S::Q) + wg * 64 * 128;
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.0f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.0f, 0.0f}, alpha[2];

  mbar_wait(q_full, 0);
  for (int j = 0; j < hi; ++j) {
    const int s = j % F_STAGES, parity = (j / F_STAGES) & 1;
    // the first key each row may not see: kv_len, or row + 1 when causal,
    // on tiles that cross the diagonal or reach past kv_len
    const bool masked = (causal && (j + 1) * F_KEYS > qt * F_TILE + 1) ||
                        (j + 1) * F_KEYS > kv_len;
    int lim[2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
      lim[i] = !masked ? INT_MAX
                       : (causal ? min(kv_len, row0 + 8 * i + 1) : kv_len);

    mbar_wait(&k_full[s], parity);
    const uint32_t k_addr = smem_u32(smem + S::K + s * S::KV);
    const uint32_t v_addr = smem_u32(smem + S::V + s * S::KV);
    // the key tile in steps of SK keys (at D = 64 two halves: their scores
    // take 16 registers, not 32, and O with them fits the 96 registers a
    // thread that two blocks an SM leave)
#pragma unroll
    for (int h = 0; h < F_KEYS / SK; ++h) {
      float sc[SK / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {    // scale_d 0 at kk = 0
        const int col = (kk % 4) * 32;
        wgmma_scores<SK>(sc, desc_k(q_addr + (kk / 4) * F_QBOX + col),
                         desc_k(k_addr + h * SK * 128 + (kk / 4) * F_KBOX +
                                col),
                         kk);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      if (h == F_KEYS / SK - 1) mbar_arrive(&k_empty[s]);

      online_softmax<SK>(sc, m, l, alpha, scale_log2, lim,
                         j * F_KEYS + h * SK + 2 * tq4);
#pragma unroll
      for (int e = 0; e < D / 2; ++e) acc[e] *= alpha[(e >> 1) & 1];
      // P as the bf16 A operand of SK / 16 k16 steps: step kk takes keys
      // 16kk..16kk+15 of the step, accumulator blocks 2kk and 2kk+1
      uint32_t pa[SK / 16][4];
#pragma unroll
      for (int kk = 0; kk < SK / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          pa[kk][r] = pack(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);

      if (h == 0) mbar_wait(&v_full[s], parity);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < SK / 16; ++kk)
        wgmma_rs_d<D>(acc, pa[kk],
                      desc_mn(v_addr + (h * SK / 16 + kk) * 2048, F_KBOX));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
    }
    mbar_arrive(&v_empty[s]);
  }

  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (l[i] == 0.0f) l[i] = 1.0f;
    inv[i] = 1.0f / l[i];
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    if (row >= t) continue;
    bf16* orow = o + ((size_t)b * t + row) * nh * D + hcol + 2 * tq4;
#pragma unroll
    for (int jb = 0; jb < D / 8; ++jb)
      *reinterpret_cast<uint32_t*>(orow + 8 * jb) =
          pack(acc[4 * jb + 2 * i] * inv[i], acc[4 * jb + 2 * i + 1] * inv[i]);
    // natural-log units, as the JAX kernel's m + log l
    if (tq4 == 0)
      lse[(size_t)bh * t + row] = (m[i] + log2f(l[i])) * 0.6931471805599453f;
  }
}

// [B, T, nh*D] bf16 as a 3-D tensor map (channels innermost), boxes
// [1][rows][64]: head h's box x starts at column h*D + 64x. The bh layout
// [BH, T, D] is the case nh = 1.
cudaError_t head_map(CUtensorMap* map, const void* x, int b, int t, int nh,
                     int d, int rows) {
  const uint64_t width = (uint64_t)nh * d;
  const uint64_t dims[3] = {width, (uint64_t)t, (uint64_t)b};
  const uint64_t strides[2] = {width * 2, (uint64_t)t * width * 2};
  const uint32_t box[3] = {64, (uint32_t)rows, 1};
  return make_tensor_map(map, x, 3, dims, strides, box);
}

// K1 (nh = 1, b = BH) and K4 (the packed layout, nh heads)
template <int D>
cudaError_t launch_fwd_wgmma(const void* q, const void* k, const void* v,
                             void* o, void* lse, int b, int nh, int t,
                             float scale, int causal, int kv_len,
                             cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  cudaError_t err = head_map(&tq, q, b, t, nh, D, F_TILE);
  if (err == cudaSuccess) err = head_map(&tk, k, b, t, nh, D, F_KEYS);
  if (err == cudaSuccess) err = head_map(&tv, v, b, t, nh, D, F_KEYS);
  if (err != cudaSuccess) return err;
  const size_t smem = FwdSmem<D>::BYTES;
  err = allow_smem(flash_fwd_wgmma_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((t + F_TILE - 1) / F_TILE, b * nh);
  flash_fwd_wgmma_kernel<D><<<grid, F_THREADS, smem, stream>>>(
      tq, tk, tv, (bf16*)o, (float*)lse, t, nh, scale * LOG2E, causal,
      kv_len);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K2 on wgmma: the bh-layout dQ. Replaces the JAX package's
// workloads/flash_attention.py::_bwd_dq_kernel (launched by _bwd). K1's
// block shape: one block per (128-row Q tile, head), a head's tiles side
// by side and its heavy causal tiles first; two consumer warpgroups own 64
// rows each; one producer thread loads Q and dO once and K and V through a
// ring of B_STAGES 64-key tiles, by TMA with full/empty mbarriers. Per key
// tile a consumer runs S = Q.K^T and dP = dO.V^T as wgmma m64n64k16 from
// shared memory (all four operands K-major), in two groups so that it
// forms P = 2^(S.scale.log2(e) - lse.log2(e)) while dP is in flight;
// releases V; forms dS = P.(dP - delta), all in registers on the
// accumulator layout, with lse and delta for the thread's two rows read
// once from global; rounds dS to bf16 as the register A
// operand of dQ += dS.K (wgmma m64nDk16, K MN-major: the transpose flag);
// and releases K. The key loop ends at the JAX kernel's `hi`; masks apply
// only on tiles that cross the diagonal or reach past kv_len, and a
// warpgroup skips (but still releases) a tile wholly above the diagonal for
// its rows, or every tile when its rows all lie past T. dQ is scaled once,
// at the end. At the LM's path shape (BH 128, T 2048, D 128, causal: 206
// GFLOP, 0.209 ms at 989 TFLOP/s) it is bound by operations.
// Registers: dQ 64 + S 32 + dP 32 + dS 16 at D = 128 fit the 168 a thread
// that ptxas allows K1's 288-thread block, so no register is moved
// between warpgroups. ptxas (CUDA 12.8): 165 registers at D = 128, 135 at
// D = 64, no spills; 197,768 / 99,464 bytes of dynamic shared memory (4
// stages: with 3, both kernels measured slower on an H100).
// ---------------------------------------------------------------------------
constexpr int B_STAGES = 4;                  // K/V (K2) or Q/dO (K3) tiles
                                             // in flight

template <int D>
struct DqSmem {
  static constexpr int QT = D / 64 * F_QBOX;     // the [128][D] Q or dO tile
  static constexpr int KV = D / 64 * F_KBOX;     // a [64][D] K or V tile
  static constexpr int Q = 0, DO = QT, K = 2 * QT, V = K + B_STAGES * KV;
  static constexpr int BAR = V + B_STAGES * KV;
  static constexpr size_t BYTES =
      (size_t)BAR + (1 + 4 * B_STAGES) * sizeof(uint64_t) + 1024;
};

template <int D>
__global__ void __launch_bounds__(F_THREADS, 1)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap tdo,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          bf16* __restrict__ dq, int t, float scale,
                          int causal, int kv_len) {
  using S = DqSmem<D>;
  constexpr int BOXES = D / 64;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_1024(smem_raw);
  uint64_t* in_full = reinterpret_cast<uint64_t*>(smem + S::BAR);
  uint64_t* k_full = in_full + 1;              // [B_STAGES] each
  uint64_t* v_full = k_full + B_STAGES;
  uint64_t* k_empty = v_full + B_STAGES;
  uint64_t* v_empty = k_empty + B_STAGES;

  const int bh = blockIdx.y;
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int n_kv = t / F_KEYS;
  // the JAX kernel's `hi`: key tiles past the diagonal are fully masked
  const int hi = causal ? min(((qt + 1) * F_TILE + F_KEYS - 1) / F_KEYS, n_kv)
                        : n_kv;

  if (threadIdx.x == 0) {
    mbar_init(in_full, 1);
    for (int s = 0; s < B_STAGES; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&k_empty[s], F_CONSUMERS);
      mbar_init(&v_empty[s], F_CONSUMERS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= F_CONSUMERS) {                 // the producer warp
    if (threadIdx.x == F_CONSUMERS) {
      mbar_expect_tx(in_full, 2 * S::QT);
      for (int b = 0; b < BOXES; ++b) {
        tma_load_3d(smem + S::Q + b * F_QBOX, &tq, in_full, b * 64,
                    qt * F_TILE, bh);
        tma_load_3d(smem + S::DO + b * F_QBOX, &tdo, in_full, b * 64,
                    qt * F_TILE, bh);
      }
      for (int j = 0; j < hi; ++j) {
        const int s = j % B_STAGES;
        const int parity = (j / B_STAGES - 1) & 1;
        if (j >= B_STAGES) mbar_wait(&k_empty[s], parity);
        mbar_expect_tx(&k_full[s], S::KV);
        for (int b = 0; b < BOXES; ++b)
          tma_load_3d(smem + S::K + s * S::KV + b * F_KBOX, &tk, &k_full[s],
                      b * 64, j * F_KEYS, bh);
        if (j >= B_STAGES) mbar_wait(&v_empty[s], parity);
        mbar_expect_tx(&v_full[s], S::KV);
        for (int b = 0; b < BOXES; ++b)
          tma_load_3d(smem + S::V + s * S::KV + b * F_KBOX, &tv, &v_full[s],
                      b * 64, j * F_KEYS, bh);
      }
    }
    return;
  }

  const int wg = threadIdx.x / 128;
  const int lane = threadIdx.x % 32, g = lane >> 2, tq4 = lane & 3;
  const int first = qt * F_TILE + wg * 64;     // this warpgroup's first row
  // rows of accumulator elements with ((e >> 1) & 1) == 0; +8 for the others
  const int row0 = first + ((threadIdx.x / 32) % 4) * 16 + g;
  const uint32_t q_addr = smem_u32(smem + S::Q) + wg * 64 * 128;
  const uint32_t do_addr = smem_u32(smem + S::DO) + wg * 64 * 128;
  const float scale_log2 = scale * LOG2E;
  // per row: -lse in log2 units, delta, and the first key it may not see
  float nl[2], dl[2];
  int lim[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    nl[i] = row < t ? -lse[(size_t)bh * t + row] * LOG2E : 0.0f;
    dl[i] = row < t ? delta[(size_t)bh * t + row] : 0.0f;
    lim[i] = causal ? min(kv_len, row + 1) : kv_len;
  }
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.0f;

  mbar_wait(in_full, 0);
  for (int j = 0; j < hi; ++j) {
    const int s = j % B_STAGES, parity = (j / B_STAGES) & 1;
    mbar_wait(&k_full[s], parity);
    mbar_wait(&v_full[s], parity);
    if (first >= t || (causal && j * F_KEYS >= first + 64)) {
      mbar_arrive(&v_empty[s]);
      mbar_arrive(&k_empty[s]);
      continue;
    }
    const bool masked = (causal && (j + 1) * F_KEYS > first + 1) ||
                        (j + 1) * F_KEYS > kv_len;
    const uint32_t k_addr = smem_u32(smem + S::K + s * S::KV);
    const uint32_t v_addr = smem_u32(smem + S::V + s * S::KV);
    // S and dP in two groups: P is formed while dP is still in flight
    float sc[F_KEYS / 2], dp[F_KEYS / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {      // scale_d 0 at kk = 0
      const int col = (kk % 4) * 32;
      wgmma_ss_n64<0, 0>(sc, desc_k(q_addr + (kk / 4) * F_QBOX + col),
                         desc_k(k_addr + (kk / 4) * F_KBOX + col), kk);
    }
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int col = (kk % 4) * 32;
      wgmma_ss_n64<0, 0>(dp, desc_k(do_addr + (kk / 4) * F_QBOX + col),
                         desc_k(v_addr + (kk / 4) * F_KBOX + col), kk);
    }
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(sc);

    // P into sc; element e: the thread's row (e >> 1) & 1, key
    // j*64 + 8*(e >> 2) + 2*tq4 + (e & 1)
    const int col0 = j * F_KEYS + 2 * tq4;
#pragma unroll
    for (int e = 0; e < F_KEYS / 2; ++e) {
      const int i = (e >> 1) & 1, col = col0 + 8 * (e >> 2) + (e & 1);
      sc[e] = !masked || col < lim[i]
                  ? exp2_approx(fmaf(sc[e], scale_log2, nl[i]))
                  : 0.0f;
    }
    wgmma_wait<0>();
    fence_regs(dp);
    mbar_arrive(&v_empty[s]);
    // dS into sc
#pragma unroll
    for (int e = 0; e < F_KEYS / 2; ++e) sc[e] *= dp[e] - dl[(e >> 1) & 1];
    // dS as the bf16 A operand of 4 k16 steps (keys 16kk..16kk+15)
    uint32_t da[F_KEYS / 16][4];
#pragma unroll
    for (int kk = 0; kk < F_KEYS / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        da[kk][r] = pack(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);

    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < F_KEYS / 16; ++kk)
      wgmma_rs_d<D>(acc, da[kk], desc_mn(k_addr + kk * 2048, F_KBOX));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    mbar_arrive(&k_empty[s]);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    if (row >= t) continue;
    bf16* out = dq + ((size_t)bh * t + row) * D + 2 * tq4;
#pragma unroll
    for (int jb = 0; jb < D / 8; ++jb)
      *reinterpret_cast<uint32_t*>(out + 8 * jb) =
          pack(acc[4 * jb + 2 * i] * scale, acc[4 * jb + 2 * i + 1] * scale);
  }
}

// ---------------------------------------------------------------------------
// K3 on wgmma: the bh-layout dK and dV. Replaces the JAX package's
// workloads/flash_attention.py::_bwd_dkv_kernel (launched by _bwd). One
// block per (128-key tile, head), a head's tiles side by side, the heavy
// causal tiles (low keys) first; two consumer warpgroups own 64 keys each.
// One producer thread loads K and V once and, from the JAX kernel's `lo`,
// each 64-row query tile's Q, dO, lse and delta through a ring of B_STAGES
// stages (Q and dO by TMA, lse and delta as 256-byte bulk copies) with
// full/empty mbarriers. On transposed scores, per query tile: S^T = K.Q^T
// and dP^T = V.dO^T as wgmma m64n64k16 from shared memory (all K-major);
// P^T and dS^T in registers, with lse and delta now per column, read from
// the stage's shared copy; both rounded to bf16 as register A operands of
// dV += P^T.dO and dK += dS^T.Q (wgmma m64nDk16, dO and Q MN-major). No
// tile is transposed in shared memory. Masks only on tiles that cross the
// diagonal or reach past kv_len; a warpgroup skips (but releases) a query
// tile wholly before its keys, or every tile when its keys all lie past T.
// dK is scaled once, at the end. Bound by operations at the LM's path
// shape (275 GFLOP, 0.278 ms at 989 TFLOP/s).
// Registers: dK 64 + dV 64 + S^T 32 + dP^T 32 = 192 at D = 128 before
// addresses, over the 168 a thread that ptxas allows a block of two
// consumer warpgroups and a producer warp (K2's shape: there ptxas
// spilled 688 bytes of K3 at D = 128). So the producer is a whole
// warpgroup that gives registers up by setmaxnreg (K3_PRODUCER_REGS) and
// the consumers take them (K3_CONSUMER_REGS), in one if / else whose
// branches never rejoin, as ptxas needs to honour it (it reports the 168
// a thread the block starts with). One consumer warpgroup a block, 64
// keys, would halve the keys that share a Q/dO load. ptxas (CUDA 12.8): no
// spills at D = 128 or 64, no C7508 warning; 199,784 / 101,480 bytes of
// dynamic shared memory. Overlapping P^T with dP^T in flight and dS^T
// with dV (K2's two groups) needs 208 live registers beside the
// addresses, spilled at D = 128 and measured slower.
// ---------------------------------------------------------------------------
constexpr int K3_THREADS = F_CONSUMERS + 128;   // + the producer warpgroup
constexpr int K3_PRODUCER_REGS = 40;             // 128 x 40 + 256 x 232
constexpr int K3_CONSUMER_REGS = 232;            //   = 64,512 of 65,536

template <int D>
struct DkvSmem {
  static constexpr int KT = D / 64 * F_QBOX;     // the [128][D] K or V tile
  static constexpr int QT = D / 64 * F_KBOX;     // a [64][D] Q or dO tile
  static constexpr int ROWS = F_KEYS * 4;        // a tile's f32 lse or delta
  static constexpr int K = 0, V = KT, Q = 2 * KT, DO = Q + B_STAGES * QT;
  static constexpr int L = DO + B_STAGES * QT, DL = L + B_STAGES * ROWS;
  static constexpr int BAR = DL + B_STAGES * ROWS;
  static constexpr size_t BYTES =
      (size_t)BAR + (1 + 3 * B_STAGES) * sizeof(uint64_t) + 1024;
};

// K3's consumer warpgroups: dK and dV of the warpgroup's 64 keys over the
// query tiles lo..n_q of the ring
template <int D>
__device__ __forceinline__ void dkv_consumer(
    unsigned char* smem, uint64_t* kv_full, uint64_t* q_full,
    uint64_t* d_full, uint64_t* empty, bf16* __restrict__ dk,
    bf16* __restrict__ dv, int bh, int kt, int lo, int n_q, int t,
    float scale, int causal, int kv_len) {
  using S = DkvSmem<D>;
  const int wg = threadIdx.x / 128;
  const int lane = threadIdx.x % 32, g = lane >> 2, tq4 = lane & 3;
  const int first = kt * F_TILE + wg * 64;     // this warpgroup's first key
  // keys of accumulator elements with ((e >> 1) & 1) == 0; +8 for the others
  const int key0 = first + ((threadIdx.x / 32) % 4) * 16 + g;
  const uint32_t k_addr = smem_u32(smem + S::K) + wg * 64 * 128;
  const uint32_t v_addr = smem_u32(smem + S::V) + wg * 64 * 128;
  const float scale_log2 = scale * LOG2E;
  float acc_dk[D / 2], acc_dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc_dk[i] = acc_dv[i] = 0.0f;

  mbar_wait(kv_full, 0);
  for (int i = lo; i < n_q; ++i) {
    const int it = i - lo, s = it % B_STAGES, parity = (it / B_STAGES) & 1;
    mbar_wait(&q_full[s], parity);
    mbar_wait(&d_full[s], parity);
    if (first >= t || (causal && (i + 1) * F_KEYS <= first)) {
      mbar_arrive(&empty[s]);
      continue;
    }
    const bool masked = (causal && i * F_KEYS < first + 63) ||
                        first + 64 > kv_len;
    const uint32_t q_addr = smem_u32(smem + S::Q + s * S::QT);
    const uint32_t do_addr = smem_u32(smem + S::DO + s * S::QT);
    float st[F_KEYS / 2], dpt[F_KEYS / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {      // scale_d 0 at kk = 0
      const int col = (kk % 4) * 32;
      wgmma_ss_n64<0, 0>(st, desc_k(k_addr + (kk / 4) * F_QBOX + col),
                         desc_k(q_addr + (kk / 4) * F_KBOX + col), kk);
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int col = (kk % 4) * 32;
      wgmma_ss_n64<0, 0>(dpt, desc_k(v_addr + (kk / 4) * F_QBOX + col),
                         desc_k(do_addr + (kk / 4) * F_KBOX + col), kk);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(st);
    fence_regs(dpt);

    // P^T into st and dS^T into dpt; element e: the thread's key
    // (e >> 1) & 1, query i*64 + 8*(e >> 2) + 2*tq4 + (e & 1)
    const float* sl = reinterpret_cast<const float*>(smem + S::L + s * S::ROWS);
    const float* sd = reinterpret_cast<const float*>(smem + S::DL + s * S::ROWS);
#pragma unroll
    for (int n = 0; n < F_KEYS / 8; ++n) {
      const float2 l2 = *reinterpret_cast<const float2*>(sl + 8 * n + 2 * tq4);
      const float2 d2 = *reinterpret_cast<const float2*>(sd + 8 * n + 2 * tq4);
      const float nl[2] = {-l2.x * LOG2E, -l2.y * LOG2E}, dl[2] = {d2.x, d2.y};
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int e = 4 * n + 2 * h + c;
          const int key = key0 + 8 * h, q = i * F_KEYS + 8 * n + 2 * tq4 + c;
          const bool keep = !masked || (key < kv_len && (!causal || q >= key));
          const float p = keep ? exp2_approx(fmaf(st[e], scale_log2, nl[c]))
                               : 0.0f;
          st[e] = p;
          dpt[e] = p * (dpt[e] - dl[c]);
        }
    }
    // P^T and dS^T as bf16 A operands of 4 k16 steps (queries 16kk..+15)
    uint32_t pa[F_KEYS / 16][4], da[F_KEYS / 16][4];
#pragma unroll
    for (int kk = 0; kk < F_KEYS / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        pa[kk][r] = pack(st[8 * kk + 2 * r], st[8 * kk + 2 * r + 1]);
        da[kk][r] = pack(dpt[8 * kk + 2 * r], dpt[8 * kk + 2 * r + 1]);
      }

    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < F_KEYS / 16; ++kk)
      wgmma_rs_d<D>(acc_dv, pa[kk], desc_mn(do_addr + kk * 2048, F_KBOX));
#pragma unroll
    for (int kk = 0; kk < F_KEYS / 16; ++kk)
      wgmma_rs_d<D>(acc_dk, da[kk], desc_mn(q_addr + kk * 2048, F_KBOX));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc_dv);
    fence_regs(acc_dk);
    mbar_arrive(&empty[s]);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = key0 + 8 * h;
    if (key >= t) continue;
    bf16* kout = dk + ((size_t)bh * t + key) * D + 2 * tq4;
    bf16* vout = dv + ((size_t)bh * t + key) * D + 2 * tq4;
#pragma unroll
    for (int jb = 0; jb < D / 8; ++jb) {
      *reinterpret_cast<uint32_t*>(kout + 8 * jb) =
          pack(acc_dk[4 * jb + 2 * h] * scale,
               acc_dk[4 * jb + 2 * h + 1] * scale);
      *reinterpret_cast<uint32_t*>(vout + 8 * jb) =
          pack(acc_dv[4 * jb + 2 * h], acc_dv[4 * jb + 2 * h + 1]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(K3_THREADS, 1)
flash_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           const __grid_constant__ CUtensorMap tdo,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           bf16* __restrict__ dk, bf16* __restrict__ dv,
                           int t, float scale, int causal, int kv_len) {
  using S = DkvSmem<D>;
  constexpr int BOXES = D / 64;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_1024(smem_raw);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + S::BAR);
  uint64_t* q_full = kv_full + 1;              // [B_STAGES] each
  uint64_t* d_full = q_full + B_STAGES;
  uint64_t* empty = d_full + B_STAGES;

  const int bh = blockIdx.y, kt = blockIdx.x;
  const int n_q = t / F_KEYS;                  // 64-row query tiles
  // the JAX kernel's `lo`: query tiles before the diagonal are fully masked
  const int lo = causal ? kt * F_TILE / F_KEYS : 0;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < B_STAGES; ++s) {
      mbar_init(&q_full[s], 1);
      mbar_init(&d_full[s], 1);
      mbar_init(&empty[s], F_CONSUMERS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  // one if / else whose branches never rejoin, so that ptxas honours the
  // register moves
  if (threadIdx.x >= F_CONSUMERS) {                 // the producer warpgroup
    regs_dec<K3_PRODUCER_REGS>();
    if (threadIdx.x == F_CONSUMERS) {
      mbar_expect_tx(kv_full, 2 * S::KT);
      for (int b = 0; b < BOXES; ++b) {
        tma_load_3d(smem + S::K + b * F_QBOX, &tk, kv_full, b * 64,
                    kt * F_TILE, bh);
        tma_load_3d(smem + S::V + b * F_QBOX, &tv, kv_full, b * 64,
                    kt * F_TILE, bh);
      }
      for (int i = lo; i < n_q; ++i) {
        const int it = i - lo, s = it % B_STAGES;
        if (it >= B_STAGES) mbar_wait(&empty[s], (it / B_STAGES - 1) & 1);
        const size_t rows = (size_t)bh * t + (size_t)i * F_KEYS;
        mbar_expect_tx(&q_full[s], S::QT + S::ROWS);
        for (int b = 0; b < BOXES; ++b)
          tma_load_3d(smem + S::Q + s * S::QT + b * F_KBOX, &tq, &q_full[s],
                      b * 64, i * F_KEYS, bh);
        bulk_load(smem + S::L + s * S::ROWS, lse + rows, S::ROWS, &q_full[s]);
        mbar_expect_tx(&d_full[s], S::QT + S::ROWS);
        for (int b = 0; b < BOXES; ++b)
          tma_load_3d(smem + S::DO + s * S::QT + b * F_KBOX, &tdo,
                      &d_full[s], b * 64, i * F_KEYS, bh);
        bulk_load(smem + S::DL + s * S::ROWS, delta + rows, S::ROWS,
                  &d_full[s]);
      }
    }
  } else {
    regs_inc<K3_CONSUMER_REGS>();
    dkv_consumer<D>(smem, kv_full, q_full, d_full, empty, dk, dv, bh, kt, lo,
                    n_q, t, scale, causal, kv_len);
  }
}

template <int D>
cudaError_t launch_dq_wgmma(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse,
                            const void* delta, void* dq, int bh, int t,
                            float scale, int causal, int kv_len,
                            cudaStream_t stream) {
  CUtensorMap tq, tk, tv, tdo;
  cudaError_t err = head_map(&tq, q, bh, t, 1, D, F_TILE);
  if (err == cudaSuccess) err = head_map(&tk, k, bh, t, 1, D, F_KEYS);
  if (err == cudaSuccess) err = head_map(&tv, v, bh, t, 1, D, F_KEYS);
  if (err == cudaSuccess) err = head_map(&tdo, dout, bh, t, 1, D, F_TILE);
  if (err != cudaSuccess) return err;
  const size_t smem = DqSmem<D>::BYTES;
  err = allow_smem(flash_bwd_dq_wgmma_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((t + F_TILE - 1) / F_TILE, bh);
  flash_bwd_dq_wgmma_kernel<D><<<grid, F_THREADS, smem, stream>>>(
      tq, tk, tv, tdo, (const float*)lse, (const float*)delta, (bf16*)dq, t,
      scale, causal, kv_len);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv_wgmma(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse,
                             const void* delta, void* dk, void* dv, int bh,
                             int t, float scale, int causal, int kv_len,
                             cudaStream_t stream) {
  CUtensorMap tq, tk, tv, tdo;
  cudaError_t err = head_map(&tq, q, bh, t, 1, D, F_KEYS);
  if (err == cudaSuccess) err = head_map(&tk, k, bh, t, 1, D, F_TILE);
  if (err == cudaSuccess) err = head_map(&tv, v, bh, t, 1, D, F_TILE);
  if (err == cudaSuccess) err = head_map(&tdo, dout, bh, t, 1, D, F_KEYS);
  if (err != cudaSuccess) return err;
  const size_t smem = DkvSmem<D>::BYTES;
  err = allow_smem(flash_bwd_dkv_wgmma_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((t + F_TILE - 1) / F_TILE, bh);
  flash_bwd_dkv_wgmma_kernel<D><<<grid, K3_THREADS, smem, stream>>>(
      tq, tk, tv, tdo, (const float*)lse, (const float*)delta, (bf16*)dk,
      (bf16*)dv, t, scale, causal, kv_len);
  return cudaGetLastError();
}

template <int D, bool PACKED>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      void* dq, int b, int nh, int t, float scale, int causal,
                      int kv_len, cudaStream_t stream) {
  const size_t smem = dq_smem<D>();
  cudaError_t err = allow_smem(flash_bwd_dq_kernel<D, PACKED>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(t / BQ, b * nh);
  flash_bwd_dq_kernel<D, PACKED><<<grid, NTHREADS, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout,
      (const float*)lse, (const float*)delta, (bf16*)dq, t, nh, scale, causal,
      kv_len);
  return cudaGetLastError();
}

template <int D, bool PACKED>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dk, void* dv, int b, int nh, int t, float scale,
                       int causal, int kv_len, cudaStream_t stream) {
  const size_t smem = dkv_smem<D>();
  cudaError_t err = allow_smem(flash_bwd_dkv_kernel<D, PACKED>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(t / BK, b * nh);
  flash_bwd_dkv_kernel<D, PACKED><<<grid, NTHREADS, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout,
      (const float*)lse, (const float*)delta, (bf16*)dk, (bf16*)dv, t, nh,
      scale, causal, kv_len);
  return cudaGetLastError();
}

// shapes the kernels take: T a positive multiple of the tile, b*nh blocks
// within the grid's y limit
bool bad_shape(int b, int nh, int t) {
  return t % BQ != 0 || t <= 0 || b <= 0 || nh <= 0 ||
         (long long)b * nh > 65535;
}

// K1 and K4: the wgmma forward on either layout
int fwd(const void* q, const void* k, const void* v, void* o, void* lse,
        int b, int nh, int t, int d, float scale, int causal, int kv_len,
        void* stream) {
  if (bad_shape(b, nh, t)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (d == 64) return (int)launch_fwd_wgmma<64>(q, k, v, o, lse, b, nh, t, scale, causal, kv_len, s);
  if (d == 128) return (int)launch_fwd_wgmma<128>(q, k, v, o, lse, b, nh, t, scale, causal, kv_len, s);
  return (int)cudaErrorInvalidValue;
}

template <bool PACKED>
int bwd_dq(const void* q, const void* k, const void* v, const void* dout,
           const void* lse, const void* delta, void* dq, int b, int nh, int t,
           int d, float scale, int causal, int kv_len, void* stream) {
  if (bad_shape(b, nh, t)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if constexpr (!PACKED) {     // K2: the wgmma dQ
    if (d == 64) return (int)launch_dq_wgmma<64>(q, k, v, dout, lse, delta, dq, b, t, scale, causal, kv_len, s);
    if (d == 128) return (int)launch_dq_wgmma<128>(q, k, v, dout, lse, delta, dq, b, t, scale, causal, kv_len, s);
  } else {                     // K5
    if (d == 64) return (int)launch_dq<64, PACKED>(q, k, v, dout, lse, delta, dq, b, nh, t, scale, causal, kv_len, s);
    if (d == 128) return (int)launch_dq<128, PACKED>(q, k, v, dout, lse, delta, dq, b, nh, t, scale, causal, kv_len, s);
  }
  return (int)cudaErrorInvalidValue;
}

template <bool PACKED>
int bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
            const void* lse, const void* delta, void* dk, void* dv, int b,
            int nh, int t, int d, float scale, int causal, int kv_len,
            void* stream) {
  if (bad_shape(b, nh, t)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if constexpr (!PACKED) {     // K3: the wgmma dK/dV
    if (d == 64) return (int)launch_dkv_wgmma<64>(q, k, v, dout, lse, delta, dk, dv, b, t, scale, causal, kv_len, s);
    if (d == 128) return (int)launch_dkv_wgmma<128>(q, k, v, dout, lse, delta, dk, dv, b, t, scale, causal, kv_len, s);
  } else {                     // K6
    if (d == 64) return (int)launch_dkv<64, PACKED>(q, k, v, dout, lse, delta, dk, dv, b, nh, t, scale, causal, kv_len, s);
    if (d == 128) return (int)launch_dkv<128, PACKED>(q, k, v, dout, lse, delta, dk, dv, b, nh, t, scale, causal, kv_len, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// ---------------------------------------------------------------------------
// plain C interface (loaded with ctypes). Each returns cudaGetLastError()
// after the launch, or cudaErrorInvalidValue for a shape it does not take.
// ko_flash_*: the bh layout [BH, T, D] (K1-K3); ko_flash_*_packed: the
// packed layout [B, T, H*D] with the head count h (K4-K6).
// ---------------------------------------------------------------------------
extern "C" {

int ko_flash_fwd(const void* q, const void* k, const void* v, void* o,
                 void* lse, int bh, int t, int d, float scale, int causal,
                 int kv_len, void* stream) {
  return fwd(q, k, v, o, lse, bh, 1, t, d, scale, causal, kv_len, stream);
}

int ko_flash_bwd_dq(const void* q, const void* k, const void* v,
                    const void* dout, const void* lse, const void* delta,
                    void* dq, int bh, int t, int d, float scale, int causal,
                    int kv_len, void* stream) {
  return bwd_dq<false>(q, k, v, dout, lse, delta, dq, bh, 1, t, d, scale,
                       causal, kv_len, stream);
}

int ko_flash_bwd_dkv(const void* q, const void* k, const void* v,
                     const void* dout, const void* lse, const void* delta,
                     void* dk, void* dv, int bh, int t, int d, float scale,
                     int causal, int kv_len, void* stream) {
  return bwd_dkv<false>(q, k, v, dout, lse, delta, dk, dv, bh, 1, t, d,
                        scale, causal, kv_len, stream);
}

int ko_flash_fwd_packed(const void* q, const void* k, const void* v, void* o,
                        void* lse, int b, int t, int h, int d, float scale,
                        int causal, int kv_len, void* stream) {
  return fwd(q, k, v, o, lse, b, h, t, d, scale, causal, kv_len, stream);
}

int ko_flash_bwd_dq_packed(const void* q, const void* k, const void* v,
                           const void* dout, const void* lse,
                           const void* delta, void* dq, int b, int t, int h,
                           int d, float scale, int causal, int kv_len,
                           void* stream) {
  return bwd_dq<true>(q, k, v, dout, lse, delta, dq, b, h, t, d, scale,
                      causal, kv_len, stream);
}

int ko_flash_bwd_dkv_packed(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse,
                            const void* delta, void* dk, void* dv, int b,
                            int t, int h, int d, float scale, int causal,
                            int kv_len, void* stream) {
  return bwd_dkv<true>(q, k, v, dout, lse, delta, dk, dv, b, h, t, d, scale,
                       causal, kv_len, stream);
}

}  // extern "C"
