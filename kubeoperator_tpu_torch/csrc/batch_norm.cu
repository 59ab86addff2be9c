// Training-mode BatchNorm of an NHWC bf16 activation for Hopper (sm_90a):
// the batch statistics, the normalize (+ relu), and the closed-form
// backward.
//
// Replaces no TPU kernel: the JAX package leaves flax's nn.BatchNorm to
// XLA, which fuses its elementwise work around the two reductions. The
// port ran it as about fifteen PyTorch ops on an f32 copy of x, and
// autograd differentiated that chain op by op. Here it is four kernels
// (workloads/batch_norm.py):
//
//   bn_sums_kernel<false, *>  forward sums: sum x and sum x^2 per channel
//                             over one chunk of rows          (ko_bn_fwd_sums)
//   bn_finish_kernel          the chunks' sums in a fixed order; then mean,
//                             var, inv = rsqrt(var + eps) and the running
//                             statistics (or the [2, C] sums alone, for an
//                             all-reduce before the statistics)
//                                                 (ko_bn_fwd_sums, ko_bn_finish)
//   bn_apply_kernel           out = bf16((x - mean)*(gamma*inv) + beta),
//                             then max(out, 0) with relu      (ko_bn_fwd_apply)
//   bn_sums_kernel<true, *>   backward sums: sum g' and sum g'.xhat, g' the
//                             upstream gradient gated by out > 0 with relu,
//                             xhat = (x - mean)*inv; these are dbeta and
//                             dgamma                          (ko_bn_bwd_sums)
//   bn_dx_kernel              dx = bf16(gamma*inv*(g' - sum g'/N
//                             - xhat*sum g'.xhat/N))          (ko_bn_bwd_dx)
//
// Layout: every operand is a row-major [N, C] matrix, N = B*H*W rows of an
// NHWC activation (free views); x, out, g and dx are bf16, the per-channel
// vectors f32. C is a multiple of 8, N any positive count.
//
// What bounds them on the H100: bytes. At the largest ResNet-50 site
// (batch 256, 56x56, 256 channels: 802,816 rows) x is 411 MB; the forward
// reads it twice and writes out once (6 bytes an element), the backward
// reads x, g (and out, with relu) twice and writes dx once (10 to 14 bytes
// an element). At 3.35 TB/s that is about 0.37 ms forward and 0.61-0.86 ms
// backward at that site; the f32 op chain moved 50-60 bytes an element
// forward and 80-100 backward.
//
// What the design does about it. A thread owns 8 adjacent channels and
// reads them with one 16-byte load a row, four rows in flight; a block of
// 256 threads covers 8*G channels (G = min(C/8, 32)) and 256/G rows at a
// time, so a warp's loads cover whole 128-byte lines. The grid is one
// wave of four such blocks an SM, each over one chunk of rows (the
// wrappers plan it). Sums over rows are split in both: each block adds its
// rows in a fixed order into its own partial, and bn_finish_kernel adds the
// partials in a fixed order. No atomics: two runs give the same bits. The
// statistics and the running update run in that same finishing launch, so
// a forward is three launches (four under a mesh, whose [2, C] sums are
// all-reduced between the chunks' sum and the statistics), a backward
// three. The elementwise formulas take one f32 operation at a time, in the
// plain versions' order (no fused multiply-add), so out, the relu gate and
// dy round as the plain versions round them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int THREADS = 256;    // a block of the sums, apply and dx kernels
constexpr int UNROLL = 4;       // rows in flight a thread
constexpr int FIN = 32;         // bn_finish_kernel: channels a block, and
                                // the threads that split a channel's chunks

__device__ __forceinline__ void load8(float* dst, const float* src) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(src));
  const float4 b = __ldg(reinterpret_cast<const float4*>(src) + 1);
  dst[0] = a.x; dst[1] = a.y; dst[2] = a.z; dst[3] = a.w;
  dst[4] = b.x; dst[5] = b.y; dst[6] = b.z; dst[7] = b.w;
}

__device__ __forceinline__ uint4 ld16(const bf16* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

__device__ __forceinline__ void unpack8(const uint4& u, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 v = __bfloat1622float2(h[i]);
    f[2 * i] = v.x;
    f[2 * i + 1] = v.y;
  }
}

__device__ __forceinline__ uint4 pack8(const float* f) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  return u;
}

// The thread's place in a block of THREADS: G channel groups of 8 side by
// side, R = THREADS/G rows at a time. With G not a divisor of THREADS the
// last threads have rr == R and sit out.
struct Tile {
  int G, R, cg, rr, col, rbeg, rend;
};

__device__ __forceinline__ Tile tile(int n, int c, int rows_per_chunk) {
  Tile t;
  t.G = min(c / 8, 32);
  t.R = THREADS / t.G;
  t.cg = threadIdx.x % t.G;
  t.rr = threadIdx.x / t.G;
  t.col = (blockIdx.x * t.G + t.cg) * 8;
  t.rbeg = blockIdx.y * rows_per_chunk;
  t.rend = min(n, t.rbeg + rows_per_chunk);
  return t;
}

// ---------------------------------------------------------------------------
// Column sums over one chunk of rows per blockIdx.y, into
// part[chunk][k][c]. Forward (BWD = false): k = 0 sum x, k = 1 sum x^2.
// Backward (BWD = true): k = 0 sum g', k = 1 sum g'.xhat, g' = g where
// out > 0 (RELU) and xhat = (x - mean)*inv.
// ---------------------------------------------------------------------------
template <bool BWD, bool RELU>
__global__ void __launch_bounds__(THREADS)
bn_sums_kernel(const bf16* __restrict__ x, const bf16* __restrict__ g,
               const bf16* __restrict__ out, const float* __restrict__ mean,
               const float* __restrict__ inv, float* __restrict__ part, int n,
               int c, int rows_per_chunk) {
  __shared__ float red[2][THREADS * 8];
  const Tile t = tile(n, c, rows_per_chunk);
  float s0[8] = {}, s1[8] = {};
  if (t.rr < t.R && t.col < c) {
    float mu[8], iv[8];
    if (BWD) {
      load8(mu, mean + t.col);
      load8(iv, inv + t.col);
    }
    int row = t.rbeg + t.rr;
    for (; row < t.rend; row += UNROLL * t.R) {
      uint4 xv[UNROLL], gv[UNROLL], ov[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int r = row + u * t.R;
        if (r < t.rend) {
          const size_t off = (size_t)r * c + t.col;
          xv[u] = ld16(x + off);
          if (BWD) gv[u] = ld16(g + off);
          if (BWD && RELU) ov[u] = ld16(out + off);
        }
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        if (row + u * t.R >= t.rend) break;
        float xf[8];
        unpack8(xv[u], xf);
        if (!BWD) {
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            s0[e] = __fadd_rn(s0[e], xf[e]);
            s1[e] = __fadd_rn(s1[e], __fmul_rn(xf[e], xf[e]));
          }
        } else {
          float gf[8], of[8];
          unpack8(gv[u], gf);
          if (RELU) unpack8(ov[u], of);
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const float ga = (RELU && !(of[e] > 0.f)) ? 0.f : gf[e];
            const float xhat = __fmul_rn(__fsub_rn(xf[e], mu[e]), iv[e]);
            s0[e] = __fadd_rn(s0[e], ga);
            s1[e] = __fadd_rn(s1[e], __fmul_rn(ga, xhat));
          }
        }
      }
    }
  }
  if (t.rr < t.R)
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      red[0][t.rr * t.G * 8 + t.cg * 8 + e] = s0[e];
      red[1][t.rr * t.G * 8 + t.cg * 8 + e] = s1[e];
    }
  __syncthreads();
  // thread j adds channel j's R row partials (j < 8G), then thread
  // j + 8G does the same for k = 1
  const int w = t.G * 8;
  for (int idx = threadIdx.x; idx < 2 * w; idx += THREADS) {
    const int k = idx / w, j = idx % w;
    const int cj = blockIdx.x * w + j;
    if (cj < c) {
      float s = 0.f;
      for (int r = 0; r < t.R; ++r) s = __fadd_rn(s, red[k][r * w + j]);
      part[((size_t)blockIdx.y * 2 + k) * c + cj] = s;
    }
  }
}

// ---------------------------------------------------------------------------
// The finisher: thread (x, y) of a FIN x FIN block adds chunks y, y + FIN,
// ... of channel blockIdx.x*FIN + x, for k = 0 and 1, then thread (x, 0)
// adds the FIN sums in order of y. With stats == 0 it writes those sums
// to sums [2, c]. Else they are sum x and sum x^2 over `count` rows:
//   mean = s0/count, var = s1/count - mean^2 (clipped at 0 with clip),
//   inv = rsqrt(var + eps),
//   run_mean = momentum*run_mean + keep*mean, the same for run_var,
// keep = 1 - momentum as the caller rounds it.
// ---------------------------------------------------------------------------
struct Finish {
  const float* part;
  int chunks, c;
  float* sums;
  float *mean, *var, *inv, *run_mean, *run_var;
  float count, eps, momentum, keep;
  int clip, stats;
};

__global__ void __launch_bounds__(FIN * FIN)
bn_finish_kernel(Finish f) {
  __shared__ float red[2][FIN][FIN + 1];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int j = blockIdx.x * FIN + tx;
  float s0 = 0.f, s1 = 0.f;
  if (j < f.c)
    for (int ch = ty; ch < f.chunks; ch += FIN) {
      s0 = __fadd_rn(s0, f.part[((size_t)ch * 2) * f.c + j]);
      s1 = __fadd_rn(s1, f.part[((size_t)ch * 2 + 1) * f.c + j]);
    }
  red[0][ty][tx] = s0;
  red[1][ty][tx] = s1;
  __syncthreads();
  if (ty != 0 || j >= f.c) return;
  float t0 = 0.f, t1 = 0.f;
  for (int y = 0; y < FIN; ++y) {
    t0 = __fadd_rn(t0, red[0][y][tx]);
    t1 = __fadd_rn(t1, red[1][y][tx]);
  }
  if (!f.stats) {
    f.sums[j] = t0;
    f.sums[f.c + j] = t1;
    return;
  }
  const float mu = __fdiv_rn(t0, f.count);
  float var = __fsub_rn(__fdiv_rn(t1, f.count), __fmul_rn(mu, mu));
  if (f.clip) var = fmaxf(var, 0.f);
  f.mean[j] = mu;
  f.var[j] = var;
  f.inv[j] = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(var, f.eps)));
  f.run_mean[j] = __fadd_rn(__fmul_rn(f.momentum, f.run_mean[j]),
                            __fmul_rn(f.keep, mu));
  f.run_var[j] = __fadd_rn(__fmul_rn(f.momentum, f.run_var[j]),
                           __fmul_rn(f.keep, var));
}

// ---------------------------------------------------------------------------
// out = bf16((x - mean)*(gamma*inv) + beta), then max(out, 0) with RELU (on
// the bf16 value: a NaN stays NaN, as torch.relu keeps it)
// ---------------------------------------------------------------------------
template <bool RELU>
__global__ void __launch_bounds__(THREADS)
bn_apply_kernel(const bf16* __restrict__ x, const float* __restrict__ mean,
                const float* __restrict__ gamma, const float* __restrict__ inv,
                const float* __restrict__ beta, bf16* __restrict__ y, int n,
                int c, int rows_per_chunk) {
  const Tile t = tile(n, c, rows_per_chunk);
  if (t.rr >= t.R || t.col >= c) return;
  float mu[8], mul[8], bt[8], iv[8];
  load8(mu, mean + t.col);
  load8(mul, gamma + t.col);
  load8(iv, inv + t.col);
  load8(bt, beta + t.col);
#pragma unroll
  for (int e = 0; e < 8; ++e) mul[e] = __fmul_rn(mul[e], iv[e]);
  for (int row = t.rbeg + t.rr; row < t.rend; row += UNROLL * t.R) {
    uint4 xv[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      if (row + u * t.R < t.rend)
        xv[u] = ld16(x + (size_t)(row + u * t.R) * c + t.col);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (row + u * t.R >= t.rend) break;
      float f[8];
      unpack8(xv[u], f);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        f[e] = __fadd_rn(__fmul_rn(__fsub_rn(f[e], mu[e]), mul[e]), bt[e]);
        if (RELU) {
          const float r = __bfloat162float(__float2bfloat16_rn(f[e]));
          f[e] = r < 0.f ? 0.f : r;
        }
      }
      *reinterpret_cast<uint4*>(y + (size_t)(row + u * t.R) * c + t.col) =
          pack8(f);
    }
  }
}

// ---------------------------------------------------------------------------
// dx = bf16(k*((g' - a) - xhat*b)), per channel a = sum g' * inv_n,
// b = sum g'.xhat * inv_n, k = gamma*inv; inv_n = 1/N over the global
// batch's N rows (K8's dy, without its product)
// ---------------------------------------------------------------------------
template <bool RELU>
__global__ void __launch_bounds__(THREADS)
bn_dx_kernel(const bf16* __restrict__ x, const bf16* __restrict__ g,
             const bf16* __restrict__ out, const float* __restrict__ mean,
             const float* __restrict__ inv, const float* __restrict__ gamma,
             const float* __restrict__ sums, float inv_n,
             bf16* __restrict__ dx, int n, int c, int rows_per_chunk) {
  const Tile t = tile(n, c, rows_per_chunk);
  if (t.rr >= t.R || t.col >= c) return;
  float mu[8], iv[8], a[8], b[8], k[8];
  load8(mu, mean + t.col);
  load8(iv, inv + t.col);
  load8(a, sums + t.col);
  load8(b, sums + c + t.col);
  load8(k, gamma + t.col);
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    a[e] = __fmul_rn(a[e], inv_n);
    b[e] = __fmul_rn(b[e], inv_n);
    k[e] = __fmul_rn(k[e], iv[e]);
  }
  for (int row = t.rbeg + t.rr; row < t.rend; row += UNROLL * t.R) {
    uint4 xv[UNROLL], gv[UNROLL], ov[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int r = row + u * t.R;
      if (r < t.rend) {
        const size_t off = (size_t)r * c + t.col;
        xv[u] = ld16(x + off);
        gv[u] = ld16(g + off);
        if (RELU) ov[u] = ld16(out + off);
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (row + u * t.R >= t.rend) break;
      float xf[8], gf[8], of[8];
      unpack8(xv[u], xf);
      unpack8(gv[u], gf);
      if (RELU) unpack8(ov[u], of);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float ga = (RELU && !(of[e] > 0.f)) ? 0.f : gf[e];
        const float xhat = __fmul_rn(__fsub_rn(xf[e], mu[e]), iv[e]);
        gf[e] = __fmul_rn(k[e], __fsub_rn(__fsub_rn(ga, a[e]),
                                          __fmul_rn(xhat, b[e])));
      }
      *reinterpret_cast<uint4*>(dx + (size_t)(row + u * t.R) * c + t.col) =
          pack8(gf);
    }
  }
}

bool bad_plan(int n, int c, int rows_per_chunk, int chunks) {
  return n <= 0 || c <= 0 || c % 8 || rows_per_chunk <= 0 || chunks <= 0 ||
         chunks > 65535 || (long long)rows_per_chunk * chunks < n ||
         (long long)rows_per_chunk * (chunks - 1) >= n;
}

dim3 grid_of(int c, int chunks) {
  const int cols_per_block = (c / 8 < 32 ? c / 8 : 32) * 8;
  return dim3((c + cols_per_block - 1) / cols_per_block, chunks);
}

cudaError_t finish(const Finish& f, cudaStream_t s) {
  bn_finish_kernel<<<(f.c + FIN - 1) / FIN, dim3(FIN, FIN), 0, s>>>(f);
  return cudaGetLastError();
}

template <bool BWD, bool RELU>
cudaError_t launch_sums(const void* x, const void* g, const void* out,
                 const void* mean, const void* inv, void* part, int n, int c,
                 int rows_per_chunk, int chunks, cudaStream_t s) {
  bn_sums_kernel<BWD, RELU><<<grid_of(c, chunks), THREADS, 0, s>>>(
      (const bf16*)x, (const bf16*)g, (const bf16*)out, (const float*)mean,
      (const float*)inv, (float*)part, n, c, rows_per_chunk);
  return cudaGetLastError();
}

}  // namespace

// ---------------------------------------------------------------------------
// plain C interface (loaded with ctypes). Each returns cudaGetLastError()
// after its launches, or cudaErrorInvalidValue for a shape it does not
// take. part is f32 scratch of chunks * 2 * c floats.
// ---------------------------------------------------------------------------
extern "C" {

// forward sums and the finisher: with stats, mean, var, inv [c] and the
// running statistics updated in place; without, sums [2, c] = (sum x,
// sum x^2) for an all-reduce before ko_bn_finish
int ko_bn_fwd_sums(const void* x, void* part, void* sums, void* mean,
                   void* var, void* inv, void* run_mean, void* run_var,
                   int n, int c, float count, float eps, float momentum,
                   float keep, int clip, int stats, int rows_per_chunk,
                   int chunks, void* stream) {
  if (bad_plan(n, c, rows_per_chunk, chunks))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = launch_sums<false, false>(
      x, nullptr, nullptr, nullptr, nullptr, part, n, c, rows_per_chunk,
      chunks, s);
  if (err != cudaSuccess) return (int)err;
  const Finish f{(const float*)part, chunks, c, (float*)sums, (float*)mean,
                 (float*)var, (float*)inv, (float*)run_mean, (float*)run_var,
                 count, eps, momentum, keep, clip, stats};
  return (int)finish(f, s);
}

// the statistics from sums [2, c] (all-reduced): as ko_bn_fwd_sums with
// stats, over one chunk
int ko_bn_finish(const void* sums, void* mean, void* var, void* inv,
                 void* run_mean, void* run_var, int c, float count,
                 float eps, float momentum, float keep, int clip,
                 void* stream) {
  if (c <= 0) return (int)cudaErrorInvalidValue;
  const Finish f{(const float*)sums, 1, c, nullptr, (float*)mean, (float*)var,
                 (float*)inv, (float*)run_mean, (float*)run_var, count, eps,
                 momentum, keep, clip, 1};
  return (int)finish(f, (cudaStream_t)stream);
}

// out = bf16((x - mean)*(gamma*inv) + beta), max(., 0) with relu
int ko_bn_fwd_apply(const void* x, const void* mean, const void* gamma,
                    const void* inv, const void* beta, void* out, int n,
                    int c, int relu, int rows_per_chunk, int chunks,
                    void* stream) {
  if (bad_plan(n, c, rows_per_chunk, chunks))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid = grid_of(c, chunks);
  if (relu)
    bn_apply_kernel<true><<<grid, THREADS, 0, s>>>(
        (const bf16*)x, (const float*)mean, (const float*)gamma,
        (const float*)inv, (const float*)beta, (bf16*)out, n, c,
        rows_per_chunk);
  else
    bn_apply_kernel<false><<<grid, THREADS, 0, s>>>(
        (const bf16*)x, (const float*)mean, (const float*)gamma,
        (const float*)inv, (const float*)beta, (bf16*)out, n, c,
        rows_per_chunk);
  return (int)cudaGetLastError();
}

// backward sums [2, c] = (sum g', sum g'.xhat); out is read only with relu
int ko_bn_bwd_sums(const void* x, const void* g, const void* out,
                   const void* mean, const void* inv, void* part, void* sums,
                   int n, int c, int relu, int rows_per_chunk, int chunks,
                   void* stream) {
  if (bad_plan(n, c, rows_per_chunk, chunks))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err =
      relu ? launch_sums<true, true>(x, g, out, mean, inv, part, n, c,
                                     rows_per_chunk, chunks, s)
           : launch_sums<true, false>(x, g, out, mean, inv, part, n, c,
                                      rows_per_chunk, chunks, s);
  if (err != cudaSuccess) return (int)err;
  const Finish f{(const float*)part, chunks, c, (float*)sums, nullptr,
                 nullptr, nullptr, nullptr, nullptr, 0.f, 0.f, 0.f, 0.f, 0,
                 0};
  return (int)finish(f, s);
}

// dx over n rows of a batch of n_total rows, from the global sums
int ko_bn_bwd_dx(const void* x, const void* g, const void* out,
                 const void* mean, const void* inv, const void* gamma,
                 const void* sums, void* dx, int n, int n_total, int c,
                 int relu, int rows_per_chunk, int chunks, void* stream) {
  if (bad_plan(n, c, rows_per_chunk, chunks) || n_total < n)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid = grid_of(c, chunks);
  const float inv_n = (float)(1.0 / n_total);
  if (relu)
    bn_dx_kernel<true><<<grid, THREADS, 0, s>>>(
        (const bf16*)x, (const bf16*)g, (const bf16*)out, (const float*)mean,
        (const float*)inv, (const float*)gamma, (const float*)sums, inv_n,
        (bf16*)dx, n, c, rows_per_chunk);
  else
    bn_dx_kernel<false><<<grid, THREADS, 0, s>>>(
        (const bf16*)x, (const bf16*)g, (const bf16*)out, (const float*)mean,
        (const float*)inv, (const float*)gamma, (const float*)sums, inv_n,
        (bf16*)dx, n, c, rows_per_chunk);
  return (int)cudaGetLastError();
}

}  // extern "C"
