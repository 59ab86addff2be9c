// Flash attention for Hopper (sm_90a): forward, dQ backward, dK/dV
// backward and the backward's delta, each one kernel for two memory
// layouts.
//
// Replaces six Pallas TPU kernels of the JAX package's
// kubeoperator_tpu/workloads/flash_attention.py:
//   flash_fwd_wgmma_kernel<D>      <- _fwd / _fwd_kernel                  (K1)
//                                  <- _fwd_packed / _fwd_packed_kernel    (K4)
//   flash_bwd_dq_wgmma_kernel<D>   <- _bwd / _bwd_dq_kernel               (K2)
//                                  <- _bwd_packed / _bwd_dq_packed_kernel (K5)
//   flash_bwd_dkv_wgmma_kernel<D>  <- _bwd / _bwd_dkv_kernel              (K3)
//                                  <- _bwd_packed / _bwd_dkv_packed_kernel
//                                                                         (K6)
// and computes, in flash_delta_kernel<D>, the backward's
// delta = rowsum(dO * O), which the JAX package leaves to XLA (_bwd and
// _bwd_packed): no TPU kernel stands behind that one.
//
// Layout: q, k, v, o, do, dq, dk, dv are bf16, contiguous, either
// [BH, T, D] (the "bh" layout) or [B, T, nh*D] (the "packed" layout: the
// attention projections' [B, T, H, D] output read in place, with no
// transpose). One block works on one head: blockIdx.y = b*nh + h. Every
// kernel reads its tiles through 3-D TMA tensor maps over [B, T, nh*D]
// (head_map; head h's boxes start at column h*D) and writes row
// (b, row) at ((b*T + row)*nh*D + h*D); the bh layout is the case nh = 1.
// lse and delta are [B*nh, T] f32 in both (the TPU kernels stored
// [.., 8, T] only to satisfy Mosaic's (8, 128) tiling). T is a multiple of
// the 64-row tile (the Python wrapper pads), D is 64 or 128. Keys at or
// past kv_len are masked, causal masks row < col the same way, and the
// causal loop bounds equal the JAX kernels' `hi` and `lo`. The TPU packed
// kernels also walked several batch rows and every head in one program
// (`_bb_packed`), a VMEM tuning with no counterpart here: a block per
// (tile, head) already fills the 132 SMs at the ViT shape.
//
// What bounds them on the H100: at the LM's path shape (BH=128, T=2048,
// D=128, causal) each kernel does 2-4 matrix products of T x T x D per head
// and moves only O(T*D) bytes, so all three are bound by tensor-core
// operations (989 TFLOP/s bf16 dense), not by the 3.35 TB/s of HBM. At
// ViT-B/16's shape (B=128, H=12, T=196 padded to 256, D=64, non-causal)
// the sequence is short, and the same kernels are bound by the bytes they
// must move (K4: 154 MB of real rows, 0.046 ms at 3.35 TB/s, against
// 0.02 ms of tensor-core work). delta does no product and is bound by
// bytes everywhere.
//
// What the design does about it: Hopper's warpgroup MMA fed by TMA, each
// kernel described where it is defined. 128-row tiles over two consumer
// warpgroups of 64 rows; the streamed operand through a 3- or 4-stage TMA
// ring of 64-row tiles under mbarriers; the score-type products
// (S = Q.K^T, dP = dO.V^T, or their transposes) as wgmma from shared
// memory; the probabilities (or dS) kept in registers as the A operand of
// the next product. At D = 64 (ViT), where a head has only four 64-row
// tiles and each block's barrier set-up, first loads and epilogue weigh,
// two blocks share an SM: the forward and dQ take their score products in
// 32-key halves to fit the registers that leaves, and a dK/dV block is one
// consumer warpgroup of 64 keys. As in the TPU kernels, the dQ
// kernel and the dK/dV kernel are separate, so no block reduces across
// another (no atomics) and every output is the same bits every run. In all
// of them the probabilities are rounded to bf16 before the P.V-type
// products.

#include <climits>

#include <cuda_runtime.h>

#include "sm90.cuh"

namespace {

constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// let `kernel` use `bytes` of dynamic shared memory, and give its SMs the
// share of the L1/shared split that `carveout` asks (a percentage of the
// most shared memory; by default CUDA picks the split, which may be too
// little for two blocks of ~100 KB)
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes,
                       int carveout = cudaSharedmemCarveoutDefault) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributePreferredSharedMemoryCarveout, carveout);
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

// a score-type product over SK keys, both operands K-major: S = Q.K^T
// (K1, K2) and dP = dO.V^T (K2)
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
// The backward kernels' shape at D = 64 (ViT's head width), where a head
// has only four 64-row tiles (T 256) and each block's barrier set-up,
// first loads and epilogue weigh, so two blocks share an SM to hide each
// other's: K2 two blocks of 32-key score halves, K3 two blocks of one
// consumer warpgroup. D = 128 (the LM) runs one block an SM of two
// consumer warpgroups on whole 64-key score tiles. Each kernel's note
// says what the two blocks cost it.
// ---------------------------------------------------------------------------
template <int D> constexpr int dq_blocks = D == 64 ? 2 : 1;
// keys of S and dP a K2 consumer holds at once
template <int D> constexpr int dq_cols = dq_blocks<D> == 2 ? 32 : 64;
template <int D> constexpr int dkv_wgs = D == 64 ? 1 : 2;
template <int D> constexpr int dkv_blocks = dkv_wgs<D> == 1 ? 2 : 1;

// ---------------------------------------------------------------------------
// K2 and K5 on wgmma: dQ on either layout. Replaces the JAX package's
// workloads/flash_attention.py::_bwd_dq_kernel (launched by _bwd; the bh
// layout, nh = 1) and ::_bwd_dq_packed_kernel (launched by _bwd_packed;
// the packed layout, nh heads). K1's block shape: one block per (128-row Q
// tile, head), a head's tiles side by side and its heavy causal tiles
// first; two consumer warpgroups own 64 rows each; one producer thread
// loads Q and dO once and K and V through a ring of B_STAGES 64-key tiles,
// by TMA with full/empty mbarriers. Per key tile, in steps of SK keys
// (dq_cols), a consumer runs S = Q.K^T and dP = dO.V^T as wgmma m64nSKk16
// from shared memory (all four operands K-major), in two groups so that it
// forms P = 2^(S.scale.log2(e) - lse.log2(e)) while dP is in flight; forms
// dS = P.(dP - delta), all in registers on the accumulator layout, with lse
// and delta for the thread's two rows read once from global; rounds dS to
// bf16 as the register A operand of dQ += dS.K (wgmma m64nDk16, K MN-major:
// the transpose flag). It releases V after the tile's last dP and K after
// its last dQ product. dQ accumulates over the keys in order, whatever SK.
// The key loop ends at the JAX kernel's `hi`; masks apply only on tiles
// that cross the diagonal or reach past kv_len, and a warpgroup skips (but
// still releases) a tile wholly above the diagonal for its rows, or every
// tile when its rows all lie past T. dQ is scaled once, at the end. At
// the LM's path shape (BH 128, T 2048, D 128, causal: 206 GFLOP, 0.209 ms
// at 989 TFLOP/s) it is bound by operations; at ViT's (K5: 3,072 blocks
// of four key tiles) by bytes, and there two blocks share an SM.
// Registers: dQ 64 + S 32 + dP 32 + dS 16 at D = 128 fit the 168 a thread
// that ptxas allows K1's 288-thread block, so no register is moved between
// warpgroups; at D = 64 two blocks an SM cap a thread at 96 (ptxas counts
// the 9 warps as 10), and dQ 32 + S 16 + dP 16 + dS 8 in 32-key steps fit
// (ptxas, CUDA 12.8: 165 / 96 registers at D = 128 / 64, no spills). On
// an H100 K5 ran faster so than at one block an SM on whole tiles (135
// registers; PERF.md gives both times). 197,768 / 99,464 bytes of dynamic shared memory at D = 128 /
// 64 (4 stages: with 3, K2 and K3 measured slower on an H100).
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
__global__ void __launch_bounds__(F_THREADS, dq_blocks<D>)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap tdo,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          bf16* __restrict__ dq, int t, int nh, float scale,
                          int causal, int kv_len) {
  using S = DqSmem<D>;
  constexpr int BOXES = D / 64, SK = dq_cols<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_1024(smem_raw);
  uint64_t* in_full = reinterpret_cast<uint64_t*>(smem + S::BAR);
  uint64_t* k_full = in_full + 1;              // [B_STAGES] each
  uint64_t* v_full = k_full + B_STAGES;
  uint64_t* k_empty = v_full + B_STAGES;
  uint64_t* v_empty = k_empty + B_STAGES;

  const int bh = blockIdx.y, b = bh / nh, hcol = (bh % nh) * D;
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
      for (int x = 0; x < BOXES; ++x) {
        tma_load_3d(smem + S::Q + x * F_QBOX, &tq, in_full, hcol + x * 64,
                    qt * F_TILE, b);
        tma_load_3d(smem + S::DO + x * F_QBOX, &tdo, in_full, hcol + x * 64,
                    qt * F_TILE, b);
      }
      for (int j = 0; j < hi; ++j) {
        const int s = j % B_STAGES;
        const int parity = (j / B_STAGES - 1) & 1;
        if (j >= B_STAGES) mbar_wait(&k_empty[s], parity);
        mbar_expect_tx(&k_full[s], S::KV);
        for (int x = 0; x < BOXES; ++x)
          tma_load_3d(smem + S::K + s * S::KV + x * F_KBOX, &tk, &k_full[s],
                      hcol + x * 64, j * F_KEYS, b);
        if (j >= B_STAGES) mbar_wait(&v_empty[s], parity);
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
#pragma unroll
    for (int h = 0; h < F_KEYS / SK; ++h) {
      // S and dP in two groups: P is formed while dP is still in flight
      float sc[SK / 2], dp[SK / 2];
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
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int col = (kk % 4) * 32;
        wgmma_scores<SK>(dp, desc_k(do_addr + (kk / 4) * F_QBOX + col),
                         desc_k(v_addr + h * SK * 128 + (kk / 4) * F_KBOX +
                                col),
                         kk);
      }
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(sc);

      // P into sc; element e: the thread's row (e >> 1) & 1, key
      // j*64 + h*SK + 8*(e >> 2) + 2*tq4 + (e & 1)
      const int col0 = j * F_KEYS + h * SK + 2 * tq4;
#pragma unroll
      for (int e = 0; e < SK / 2; ++e) {
        const int i = (e >> 1) & 1, col = col0 + 8 * (e >> 2) + (e & 1);
        sc[e] = !masked || col < lim[i]
                    ? exp2_approx(fmaf(sc[e], scale_log2, nl[i]))
                    : 0.0f;
      }
      wgmma_wait<0>();
      fence_regs(dp);
      if (h == F_KEYS / SK - 1) mbar_arrive(&v_empty[s]);
      // dS into sc, then as the bf16 A operand of SK / 16 k16 steps
      // (keys 16kk..16kk+15 of the step)
#pragma unroll
      for (int e = 0; e < SK / 2; ++e) sc[e] *= dp[e] - dl[(e >> 1) & 1];
      uint32_t da[SK / 16][4];
#pragma unroll
      for (int kk = 0; kk < SK / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          da[kk][r] = pack(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);

      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < SK / 16; ++kk)
        wgmma_rs_d<D>(acc, da[kk],
                      desc_mn(k_addr + (h * SK / 16 + kk) * 2048, F_KBOX));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
    }
    mbar_arrive(&k_empty[s]);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    if (row >= t) continue;
    bf16* out = dq + ((size_t)b * t + row) * nh * D + hcol + 2 * tq4;
#pragma unroll
    for (int jb = 0; jb < D / 8; ++jb)
      *reinterpret_cast<uint32_t*>(out + 8 * jb) =
          pack(acc[4 * jb + 2 * i] * scale, acc[4 * jb + 2 * i + 1] * scale);
  }
}

// ---------------------------------------------------------------------------
// K3 and K6 on wgmma: dK and dV on either layout. Replaces the JAX
// package's workloads/flash_attention.py::_bwd_dkv_kernel (launched by
// _bwd; nh = 1) and ::_bwd_dkv_packed_kernel (launched by _bwd_packed). One
// block per (key tile, head), a head's tiles side by side, the heavy
// causal tiles (low keys) first; a consumer warpgroup owns 64 keys, two a
// block (128-key tiles) at D = 128, one at D = 64. One
// producer thread loads K and V once and, from the JAX kernel's `lo`, each
// 64-row query tile's Q, dO, lse and delta through a ring of B_STAGES
// stages (Q and dO by TMA, lse and delta as 256-byte bulk copies of the
// head's contiguous [T] rows) with full/empty mbarriers. On transposed
// scores, per query tile: S^T = K.Q^T and dP^T = V.dO^T as wgmma
// m64n64k16 from shared memory (all K-major); P^T and dS^T in registers,
// with lse and delta now per column, read from the stage's shared copy;
// both rounded to bf16 as register A operands of dV += P^T.dO and
// dK += dS^T.Q (wgmma m64nDk16, dO and Q MN-major). No tile is transposed
// in shared memory. Masks only on tiles that cross the diagonal or reach
// past kv_len; a warpgroup skips (but releases) a query tile wholly before
// its keys, or every tile when its keys all lie past T. dK is scaled once,
// at the end. Bound by operations at the LM's path shape (275 GFLOP,
// 0.278 ms at 989 TFLOP/s), by bytes at ViT's (K6: 3,072 heads of four
// query tiles).
// Registers: dK 64 + dV 64 + S^T 32 + dP^T 32 = 192 at D = 128 before
// addresses, over the 168 a thread that ptxas allows a block of two
// consumer warpgroups and a producer warp (there ptxas spilled 688 bytes).
// So the producer is a whole warpgroup that gives registers up by
// setmaxnreg (40) and the consumers take them (232), in one if / else
// whose branches never rejoin, as ptxas needs to honour it (it reports the
// 168 a thread the block starts with). That block fills an SM's
// registers. Two such blocks an SM (D = 64) would start a thread at 80
// and leave the consumers 104 of them (24 for the producer): dK 32 + dV 32
// beside the scores spilled even with 16- or 32-query score steps, and
// ran slower. So at D = 64 a block is one consumer
// warpgroup and a producer warp (160 threads, no setmaxnreg, 160
// registers), two blocks an SM, each of its own 64 keys; the two blocks of
// a head's 128 keys read the head's Q and dO twice, the second time from
// L2. On an H100 that ran K6 faster than one block of two warpgroups
// (PERF.md gives both times).
// 199,784 / 85,096 bytes of dynamic shared memory at D = 128 / 64.
// Overlapping P^T with dP^T in flight and dS^T with dV (K2's two groups)
// needs 208 live registers beside the addresses at D = 128; it spilled
// and measured slower. P^T alone under dP^T in flight needs none more,
// and measured the same.
// ---------------------------------------------------------------------------
// threads a block: the consumer warpgroups, and a producer warpgroup
// (two consumers) or warp (one)
template <int D>
constexpr int dkv_threads = 128 * dkv_wgs<D> + (dkv_wgs<D> == 2 ? 128 : 32);
constexpr int K3_PRODUCER_REGS = 40;             // 128 x 40 + 256 x 232
constexpr int K3_CONSUMER_REGS = 232;            //   = 64,512 of 65,536

template <int D>
struct DkvSmem {
  static constexpr int KEYS = 64 * dkv_wgs<D>;   // keys a block
  static constexpr int KBOX = KEYS * 128;        // a [KEYS][64] K or V box
  static constexpr int KT = D / 64 * KBOX;       // the [KEYS][D] K or V tile
  static constexpr int QT = D / 64 * F_KBOX;     // a [64][D] Q or dO tile
  static constexpr int ROWS = F_KEYS * 4;        // a tile's f32 lse or delta
  static constexpr int K = 0, V = KT, Q = 2 * KT, DO = Q + B_STAGES * QT;
  static constexpr int L = DO + B_STAGES * QT, DL = L + B_STAGES * ROWS;
  static constexpr int BAR = DL + B_STAGES * ROWS;
  static constexpr size_t BYTES =
      (size_t)BAR + (1 + 3 * B_STAGES) * sizeof(uint64_t) + 1024;
};

// K3's consumer warpgroups: dK and dV of the warpgroup's 64 keys over the
// query tiles lo..n_q of the ring; the head's rows start at row `base` of
// the [B*T] rows, columns hcol.. of nh*D
template <int D>
__device__ __forceinline__ void dkv_consumer(
    unsigned char* smem, uint64_t* kv_full, uint64_t* q_full,
    uint64_t* d_full, uint64_t* empty, bf16* __restrict__ dk,
    bf16* __restrict__ dv, size_t base, int hcol, int nh, int kt, int lo,
    int n_q, int t, float scale, int causal, int kv_len) {
  using S = DkvSmem<D>;
  const int wg = threadIdx.x / 128;
  const int lane = threadIdx.x % 32, g = lane >> 2, tq4 = lane & 3;
  const int first = kt * S::KEYS + wg * 64;   // this warpgroup's first key
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
      wgmma_ss_n64<0, 0>(st, desc_k(k_addr + (kk / 4) * S::KBOX + col),
                         desc_k(q_addr + (kk / 4) * F_KBOX + col), kk);
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int col = (kk % 4) * 32;
      wgmma_ss_n64<0, 0>(dpt, desc_k(v_addr + (kk / 4) * S::KBOX + col),
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
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + 8 * r;
    if (key >= t) continue;
    const size_t at = (base + key) * nh * D + hcol + 2 * tq4;
#pragma unroll
    for (int jb = 0; jb < D / 8; ++jb) {
      *reinterpret_cast<uint32_t*>(dk + at + 8 * jb) =
          pack(acc_dk[4 * jb + 2 * r] * scale,
               acc_dk[4 * jb + 2 * r + 1] * scale);
      *reinterpret_cast<uint32_t*>(dv + at + 8 * jb) =
          pack(acc_dv[4 * jb + 2 * r], acc_dv[4 * jb + 2 * r + 1]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(dkv_threads<D>, dkv_blocks<D>)
flash_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           const __grid_constant__ CUtensorMap tdo,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           bf16* __restrict__ dk, bf16* __restrict__ dv,
                           int t, int nh, float scale, int causal,
                           int kv_len) {
  using S = DkvSmem<D>;
  constexpr int BOXES = D / 64, CONSUMERS = 128 * dkv_wgs<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_1024(smem_raw);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + S::BAR);
  uint64_t* q_full = kv_full + 1;              // [B_STAGES] each
  uint64_t* d_full = q_full + B_STAGES;
  uint64_t* empty = d_full + B_STAGES;

  const int bh = blockIdx.y, b = bh / nh, hcol = (bh % nh) * D;
  const int kt = blockIdx.x;
  const int n_q = t / F_KEYS;                  // 64-row query tiles
  // the JAX kernel's `lo`: query tiles before the diagonal are fully masked
  const int lo = causal ? kt * S::KEYS / F_KEYS : 0;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < B_STAGES; ++s) {
      mbar_init(&q_full[s], 1);
      mbar_init(&d_full[s], 1);
      mbar_init(&empty[s], CONSUMERS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  // one if / else whose branches never rejoin, so that ptxas honours the
  // register moves
  if (threadIdx.x >= CONSUMERS) {                   // the producer
    if constexpr (dkv_wgs<D> == 2) regs_dec<K3_PRODUCER_REGS>();
    if (threadIdx.x == CONSUMERS) {
      mbar_expect_tx(kv_full, 2 * S::KT);
      for (int x = 0; x < BOXES; ++x) {
        tma_load_3d(smem + S::K + x * S::KBOX, &tk, kv_full, hcol + x * 64,
                    kt * S::KEYS, b);
        tma_load_3d(smem + S::V + x * S::KBOX, &tv, kv_full, hcol + x * 64,
                    kt * S::KEYS, b);
      }
      for (int i = lo; i < n_q; ++i) {
        const int it = i - lo, s = it % B_STAGES;
        if (it >= B_STAGES) mbar_wait(&empty[s], (it / B_STAGES - 1) & 1);
        // the head's lse and delta rows: [B*nh, T] in both layouts
        const size_t rows = (size_t)bh * t + (size_t)i * F_KEYS;
        mbar_expect_tx(&q_full[s], S::QT + S::ROWS);
        for (int x = 0; x < BOXES; ++x)
          tma_load_3d(smem + S::Q + s * S::QT + x * F_KBOX, &tq, &q_full[s],
                      hcol + x * 64, i * F_KEYS, b);
        bulk_load(smem + S::L + s * S::ROWS, lse + rows, S::ROWS, &q_full[s]);
        mbar_expect_tx(&d_full[s], S::QT + S::ROWS);
        for (int x = 0; x < BOXES; ++x)
          tma_load_3d(smem + S::DO + s * S::QT + x * F_KBOX, &tdo,
                      &d_full[s], hcol + x * 64, i * F_KEYS, b);
        bulk_load(smem + S::DL + s * S::ROWS, delta + rows, S::ROWS,
                  &d_full[s]);
      }
    }
  } else {
    if constexpr (dkv_wgs<D> == 2) regs_inc<K3_CONSUMER_REGS>();
    dkv_consumer<D>(smem, kv_full, q_full, d_full, empty, dk, dv,
                    (size_t)b * t, hcol, nh, kt, lo, n_q, t, scale, causal,
                    kv_len);
  }
}

// ---------------------------------------------------------------------------
// delta = rowsum(dO * O) per (row, head), the f32 input of K2/K3 (K5/K6),
// laid out [B, nh, T] like lse. Not a TPU kernel: the JAX package leaves
// it to XLA (_bwd and _bwd_packed of workloads/flash_attention.py). dO and
// O are bf16 [B, T, nh*D] (bh: nh = 1); T may be ragged here. A block takes
// DELTA_ROWS consecutive rows of the [B*T] rows. Each thread reads 16 bytes
// of dO and of O at a time (neighbouring lanes on neighbouring bytes) and
// adds their 8 products in f32 (each exact: a bf16 product fits f32's
// mantissa); the D/8 lanes that hold one (row, head) add theirs by
// shuffles; the sums pass through shared memory so that each head's
// outputs from a block are written as one contiguous run (the heads of a
// row lie T floats apart). Bound by bytes: one read of dO and O.
// ---------------------------------------------------------------------------
constexpr int DELTA_ROWS = 32;
constexpr int DELTA_THREADS = 256;
constexpr int DELTA_MAX_HEADS = 384;        // [heads][DELTA_ROWS] f32 in 48 KB

template <int D>
__global__ void __launch_bounds__(DELTA_THREADS)
flash_delta_kernel(const bf16* __restrict__ dout, const bf16* __restrict__ o,
                   float* __restrict__ delta, int rows, int t, int nh) {
  constexpr int G = D / 8;                     // 16-byte chunks of a head
  extern __shared__ float sums[];              // [nh][DELTA_ROWS]
  const int row0 = blockIdx.x * DELTA_ROWS;
  const int n_rows = min(DELTA_ROWS, rows - row0);
  const int width = nh * G;                    // chunks of a row
  const int total = n_rows * width;
  const uint4* a = reinterpret_cast<const uint4*>(dout) + (size_t)row0 * width;
  const uint4* c = reinterpret_cast<const uint4*>(o) + (size_t)row0 * width;
  const int lane = threadIdx.x % 32;
  // a warp takes 32 consecutive chunks a step: whole (row, head) groups,
  // since G divides 32 and a row holds whole heads
  for (int w = threadIdx.x - lane; w < total; w += DELTA_THREADS) {
    const int i = w + lane;
    float s = 0.0f;
    if (i < total) {
      const uint4 x = a[i], y = c[i];
      const __nv_bfloat162* xp = reinterpret_cast<const __nv_bfloat162*>(&x);
      const __nv_bfloat162* yp = reinterpret_cast<const __nv_bfloat162*>(&y);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float2 xf = __bfloat1622float2(xp[k]);
        const float2 yf = __bfloat1622float2(yp[k]);
        s += xf.x * yf.x;
        s += xf.y * yf.y;
      }
    }
#pragma unroll
    for (int m = 1; m < G; m <<= 1) s += __shfl_xor_sync(0xffffffffu, s, m);
    if (i < total && lane % G == 0)
      sums[(i % width) / G * DELTA_ROWS + i / width] = s;
  }
  __syncthreads();
  for (int k = threadIdx.x; k < nh * n_rows; k += DELTA_THREADS) {
    const int h = k / n_rows, r = k % n_rows;
    const int row = row0 + r, b = row / t;
    delta[((size_t)b * nh + h) * t + row % t] = sums[h * DELTA_ROWS + r];
  }
}

// K2 and K5 (nh = 1, b = BH for the bh layout)
template <int D>
cudaError_t launch_dq_wgmma(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse,
                            const void* delta, void* dq, int b, int nh, int t,
                            float scale, int causal, int kv_len,
                            cudaStream_t stream) {
  CUtensorMap tq, tk, tv, tdo;
  cudaError_t err = head_map(&tq, q, b, t, nh, D, F_TILE);
  if (err == cudaSuccess) err = head_map(&tk, k, b, t, nh, D, F_KEYS);
  if (err == cudaSuccess) err = head_map(&tv, v, b, t, nh, D, F_KEYS);
  if (err == cudaSuccess) err = head_map(&tdo, dout, b, t, nh, D, F_TILE);
  if (err != cudaSuccess) return err;
  const size_t smem = DqSmem<D>::BYTES;
  err = allow_smem(flash_bwd_dq_wgmma_kernel<D>, smem,
                   cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  const dim3 grid((t + F_TILE - 1) / F_TILE, b * nh);
  flash_bwd_dq_wgmma_kernel<D><<<grid, F_THREADS, smem, stream>>>(
      tq, tk, tv, tdo, (const float*)lse, (const float*)delta, (bf16*)dq, t,
      nh, scale, causal, kv_len);
  return cudaGetLastError();
}

// K3 and K6
template <int D>
cudaError_t launch_dkv_wgmma(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse,
                             const void* delta, void* dk, void* dv, int b,
                             int nh, int t, float scale, int causal,
                             int kv_len, cudaStream_t stream) {
  using S = DkvSmem<D>;
  CUtensorMap tq, tk, tv, tdo;
  cudaError_t err = head_map(&tq, q, b, t, nh, D, F_KEYS);
  if (err == cudaSuccess) err = head_map(&tk, k, b, t, nh, D, S::KEYS);
  if (err == cudaSuccess) err = head_map(&tv, v, b, t, nh, D, S::KEYS);
  if (err == cudaSuccess) err = head_map(&tdo, dout, b, t, nh, D, F_KEYS);
  if (err != cudaSuccess) return err;
  err = allow_smem(flash_bwd_dkv_wgmma_kernel<D>, S::BYTES,
                   cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  const dim3 grid((t + S::KEYS - 1) / S::KEYS, b * nh);
  flash_bwd_dkv_wgmma_kernel<D><<<grid, dkv_threads<D>, S::BYTES, stream>>>(
      tq, tk, tv, tdo, (const float*)lse, (const float*)delta, (bf16*)dk,
      (bf16*)dv, t, nh, scale, causal, kv_len);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_delta(const void* dout, const void* o, void* delta, int b,
                         int t, int nh, cudaStream_t stream) {
  const int rows = b * t;
  const size_t smem = (size_t)nh * DELTA_ROWS * sizeof(float);
  flash_delta_kernel<D><<<(rows + DELTA_ROWS - 1) / DELTA_ROWS, DELTA_THREADS,
                          smem, stream>>>((const bf16*)dout, (const bf16*)o,
                                          (float*)delta, rows, t, nh);
  return cudaGetLastError();
}

// shapes the flash kernels take: T a positive multiple of the 64-row tile,
// b*nh blocks within the grid's y limit
bool bad_shape(int b, int nh, int t) {
  return t % F_KEYS != 0 || t <= 0 || b <= 0 || nh <= 0 ||
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

// K2 and K5: the wgmma dQ on either layout
int bwd_dq(const void* q, const void* k, const void* v, const void* dout,
           const void* lse, const void* delta, void* dq, int b, int nh, int t,
           int d, float scale, int causal, int kv_len, void* stream) {
  if (bad_shape(b, nh, t)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (d == 64) return (int)launch_dq_wgmma<64>(q, k, v, dout, lse, delta, dq, b, nh, t, scale, causal, kv_len, s);
  if (d == 128) return (int)launch_dq_wgmma<128>(q, k, v, dout, lse, delta, dq, b, nh, t, scale, causal, kv_len, s);
  return (int)cudaErrorInvalidValue;
}

// K3 and K6: the wgmma dK/dV on either layout
int bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
            const void* lse, const void* delta, void* dk, void* dv, int b,
            int nh, int t, int d, float scale, int causal, int kv_len,
            void* stream) {
  if (bad_shape(b, nh, t)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (d == 64) return (int)launch_dkv_wgmma<64>(q, k, v, dout, lse, delta, dk, dv, b, nh, t, scale, causal, kv_len, s);
  if (d == 128) return (int)launch_dkv_wgmma<128>(q, k, v, dout, lse, delta, dk, dv, b, nh, t, scale, causal, kv_len, s);
  return (int)cudaErrorInvalidValue;
}

// delta on either layout: any T, b*T rows within an int
int delta_rows(const void* dout, const void* o, void* delta, int b, int t,
               int nh, int d, void* stream) {
  if (b <= 0 || t <= 0 || nh <= 0 || nh > DELTA_MAX_HEADS ||
      (long long)b * t > INT_MAX)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (d == 64) return (int)launch_delta<64>(dout, o, delta, b, t, nh, s);
  if (d == 128) return (int)launch_delta<128>(dout, o, delta, b, t, nh, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// ---------------------------------------------------------------------------
// plain C interface (loaded with ctypes). Each returns cudaGetLastError()
// after the launch, or cudaErrorInvalidValue for a shape it does not take.
// ko_flash_*: the bh layout [BH, T, D] (K1-K3); ko_flash_*_packed: the
// packed layout [B, T, H*D] with the head count h (K4-K6); ko_flash_delta:
// delta of either, [B, T, nh*D] -> [B, nh, T] (bh: b = BH, nh = 1).
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
  return bwd_dq(q, k, v, dout, lse, delta, dq, bh, 1, t, d, scale, causal,
                kv_len, stream);
}

int ko_flash_bwd_dkv(const void* q, const void* k, const void* v,
                     const void* dout, const void* lse, const void* delta,
                     void* dk, void* dv, int bh, int t, int d, float scale,
                     int causal, int kv_len, void* stream) {
  return bwd_dkv(q, k, v, dout, lse, delta, dk, dv, bh, 1, t, d, scale,
                 causal, kv_len, stream);
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
  return bwd_dq(q, k, v, dout, lse, delta, dq, b, h, t, d, scale, causal,
                kv_len, stream);
}

int ko_flash_bwd_dkv_packed(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse,
                            const void* delta, void* dk, void* dv, int b,
                            int t, int h, int d, float scale, int causal,
                            int kv_len, void* stream) {
  return bwd_dkv(q, k, v, dout, lse, delta, dk, dv, b, h, t, d, scale,
                 causal, kv_len, stream);
}

int ko_flash_delta(const void* dout, const void* o, void* delta, int b,
                   int t, int nh, int d, void* stream) {
  return delta_rows(dout, o, delta, b, t, nh, d, stream);
}

}  // extern "C"
