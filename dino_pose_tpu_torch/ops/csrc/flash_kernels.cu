// Streamed ("flash") attention for Hopper (sm_90a), CUDA C++ with a plain C
// interface (loaded with ctypes by dino_pose_tpu_torch/ops/_ext.py).
//
// They replace the two Pallas kernels of dino_pose_tpu/ops/attention.py:
// _flash_kernel (:40, pallas_call :114) and _flash_bwd_kernel (:130,
// pallas_call :218). The TPU kernels hold a whole (S, S) f32 score tile of
// one (batch, head) in VMEM (5.4 MB at S = 1297, under the 10 MB budget).
// A Hopper block has at most 227 KB of shared memory, which does not hold
// even the head's K and V past S ~ 320 (block_kernels.cu's attention_kernel
// keeps them resident). Here K and V (or Q and dO) are streamed through
// shared memory in 64-row tiles, so a block's shared memory does not grow
// with S:
//
//   flash_fwd_kernel<DH>      one block per (64-query tile, head, batch),
//                             4 warps x 16 query rows; two passes over the
//                             key tiles: the first finds each row's max m
//                             and sum l (the sum rescaled as the max moves),
//                             the second forms P = bf16(exp(s*scale - m)/l)
//                             and accumulates P V in f32. 53 KB (DH = 64).
//   flash_bwd_dq_kernel<DH>   per 64-query tile over the key tiles: a first
//                             pass sums rowsum(P * dP) exactly in f32, the
//                             second forms dS = P * (dP - rowsum) and
//                             accumulates bf16(dS) K. 79 KB.
//   flash_bwd_dkv_kernel<DH>  per 64-key tile over the query tiles: P and dS
//                             rebuilt from the statistics, dv += bf16(P)^T dO,
//                             dk += bf16(dS)^T Q. 89 KB.
//
// Rounding points are those of the JAX kernels (attention.py:50-69 and
// :143-186): f32 scores times scale, max-subtracted exp, f32 normalisation,
// P rounded to bf16 before P V and the output rounded once; in the backward
// P and dP in f32, bf16(P) and bf16(dS) before their products, dq, dk and dv
// accumulated in f32 and rounded once (dq and dk after the scale). The one
// departure: l is summed tile by tile, rescaled as the running max moves,
// where JAX sums exp(s - max) over the whole row once; the two differ by f32
// roundoff. A single online-softmax pass would round P before it is
// normalised; it is left to a later PR. Keys >= S get P = 0 (JAX's valid_len
// mask) and queries >= S are never written: the ragged last tile is masked,
// no padding copy is made. No atomics: two runs give the same bits.
//
// Bound on an H100 at dinov2-small, 504² input (S = 1297, 6 heads of 64):
// 4*B*H*S^2*dh FLOPs forward (0.084 ms at B = 32), 10*B*H*S^2*dh backward
// (0.209 ms), the JAX CostEstimate counts; operations bound both from
// batch 1. This first version recomputes Q K^T in its second pass (and dq's
// dP twice), runs 16x16x16 WMMA tiles without a copy pipeline, and so sits
// far from that bound; PERF.md holds its times.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

#include "flash_kernels.cuh"

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace dp_flash {
namespace {

constexpr int FQ = 64;         // query rows per block (4 warps x 16)
constexpr int FK = 64;         // keys per streamed tile
constexpr int THREADS = 128;
constexpr int PAD_H = 8;       // bf16 row padding (WMMA ldm % 8 == 0)
constexpr int PAD_F = 4;       // f32 row padding
constexpr int LDS = FK + PAD_F;  // f32 score rows
constexpr int LDP = FK + PAD_H;  // bf16 probability rows

template <int DH>
__host__ __device__ constexpr size_t tile_bytes() {
  return static_cast<size_t>(FQ) * (DH + PAD_H) * 2;
}
constexpr size_t SCORE_BYTES = static_cast<size_t>(FQ) * LDS * 4;
constexpr size_t PROB_BYTES = static_cast<size_t>(FQ) * LDP * 2;

template <int DH>
constexpr size_t fwd_smem() { return 3 * tile_bytes<DH>() + SCORE_BYTES + PROB_BYTES; }
template <int DH>
constexpr size_t dq_smem() { return 4 * tile_bytes<DH>() + 2 * SCORE_BYTES + PROB_BYTES; }
template <int DH>
constexpr size_t dkv_smem() {
  return 4 * tile_bytes<DH>() + 2 * SCORE_BYTES + 2 * PROB_BYTES + 3 * FQ * 4;
}

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> FragBRow;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> FragBCol;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

// rows [r0, r0 + 64) of a (., DH) slab with row stride ld into a padded
// shared tile; rows >= S are zero.
template <int DH>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, long long ld, int r0,
                                          int S) {
  constexpr int VPR = DH / 8;  // 16-byte vectors per row
  constexpr int LDH = DH + PAD_H;
  for (int i = threadIdx.x; i < FQ * VPR; i += THREADS) {
    const int r = i / VPR, c = (i % VPR) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < S) v = *reinterpret_cast<const uint4*>(src + (r0 + r) * ld + c);
    *reinterpret_cast<uint4*>(dst + r * LDH + c) = v;
  }
}

// dst (16 x 64, f32, row stride LDS) = a (16 x DH, fragments) times the
// 64 rows of b (row stride LDH) transposed: a warp's 16 rows of Q K^T,
// dO V^T, K Q^T or V dO^T.
template <int DH>
__device__ __forceinline__ void rows_times_tile_t(float* dst, const FragA (&a)[DH / 16],
                                                  const bf16* b) {
  constexpr int LDH = DH + PAD_H;
#pragma unroll
  for (int n = 0; n < FK; n += 16) {
    FragC acc;
    wmma::fill_fragment(acc, 0.f);
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      FragBCol bf;
      wmma::load_matrix_sync(bf, b + n * LDH + kk * 16, LDH);
      wmma::mma_sync(acc, a[kk], bf, acc);
    }
    wmma::store_matrix_sync(dst + n, acc, LDS, wmma::mem_row_major);
  }
}

// acc (16 x DH) += a (16 x 64 bf16, row stride LDP) times b (64 x DH, row
// stride LDH): P V, dS K, P^T dO, dS^T Q.
template <int DH>
__device__ __forceinline__ void rows_times_tile(FragC (&acc)[DH / 16], const bf16* a,
                                                const bf16* b) {
  constexpr int LDH = DH + PAD_H;
#pragma unroll
  for (int kk = 0; kk < FK; kk += 16) {
    FragA af;
    wmma::load_matrix_sync(af, a + kk, LDP);
#pragma unroll
    for (int j = 0; j < DH / 16; ++j) {
      FragBRow bf;
      wmma::load_matrix_sync(bf, b + kk * LDH + j * 16, LDH);
      wmma::mma_sync(acc[j], af, bf, acc[j]);
    }
  }
}

// Rounds a warp's 16 x DH accumulators to bf16 rows dst + r*ld (r < rows),
// times scale, through its 16 rows of f32 scratch (row stride LDS >= DH).
template <int DH>
__device__ __forceinline__ void store_rows(bf16* dst, long long ld, int rows,
                                           FragC (&acc)[DH / 16], float* scratch, float scale) {
  const int lane = threadIdx.x & 31;
  __syncwarp();
#pragma unroll
  for (int j = 0; j < DH / 16; ++j)
    wmma::store_matrix_sync(scratch + j * 16, acc[j], LDS, wmma::mem_row_major);
  __syncwarp();
  for (int i = lane; i < 16 * DH; i += 32) {
    const int r = i / DH, c = i % DH;
    if (r < rows) dst[r * ld + c] = __float2bfloat16(scratch[r * LDS + c] * scale);
  }
}

// Lane l of a warp owns row (l & 15) of the warp's 16 rows and columns
// [32*(l >> 4), +32) of a 64-wide tile; it visits them in a row-skewed order
// (c = (j + row) & 31) so that the 16 rows fall in different banks.

template <int DH>
__global__ void __launch_bounds__(THREADS) flash_fwd_kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int LDH = DH + PAD_H;
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = reinterpret_cast<bf16*>(smem + tile_bytes<DH>());
  bf16* Vs = reinterpret_cast<bf16*>(smem + 2 * tile_bytes<DH>());
  float* Ss = reinterpret_cast<float*>(smem + 3 * tile_bytes<DH>());
  bf16* Ps = reinterpret_cast<bf16*>(smem + 3 * tile_bytes<DH>() + SCORE_BYTES);

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * FQ, S = p.S;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wr = warp * 16, rr = lane & 15, half = lane >> 4;
  const long long in_base = b * p.in_b + h * p.in_h;

  load_tile<DH>(Qs, p.q + in_base, p.in_r, q0, S);
  __syncthreads();
  FragA qf[DH / 16];
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) wmma::load_matrix_sync(qf[kk], Qs + wr * LDH + kk * 16, LDH);

  const float* srow = Ss + (wr + rr) * LDS + half * 32;
  float m = -INFINITY, l = 0.f;
  // Pass 1: row max and sum over all keys.
  for (int k0 = 0; k0 < S; k0 += FK) {
    __syncthreads();
    load_tile<DH>(Ks, p.k + in_base, p.in_r, k0, S);
    __syncthreads();
    rows_times_tile_t<DH>(Ss + wr * LDS, qf, Ks);
    __syncwarp();
    const int valid = S - k0 - half * 32;  // this lane's valid columns (may be <= 0)
    float tmax = -INFINITY;
#pragma unroll 8
    for (int j = 0; j < 32; ++j) {
      const int c = (j + rr) & 31;
      if (c < valid) tmax = fmaxf(tmax, __fmul_rn(srow[c], p.scale));
    }
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 16));
    const float mnew = fmaxf(m, tmax);  // finite: every tile holds a valid key
    float ts = 0.f;
#pragma unroll 8
    for (int j = 0; j < 32; ++j) {
      const int c = (j + rr) & 31;
      if (c < valid) ts += expf(__fmul_rn(srow[c], p.scale) - mnew);
    }
    ts += __shfl_xor_sync(0xffffffffu, ts, 16);
    l = l * expf(m - mnew) + ts;
    m = mnew;
  }

  // Pass 2: O = bf16(P) V with P = exp(s*scale - m) / l.
  FragC oacc[DH / 16];
#pragma unroll
  for (int j = 0; j < DH / 16; ++j) wmma::fill_fragment(oacc[j], 0.f);
  bf16* prow = Ps + (wr + rr) * LDP + half * 32;
  for (int k0 = 0; k0 < S; k0 += FK) {
    __syncthreads();
    load_tile<DH>(Ks, p.k + in_base, p.in_r, k0, S);
    load_tile<DH>(Vs, p.v + in_base, p.in_r, k0, S);
    __syncthreads();
    rows_times_tile_t<DH>(Ss + wr * LDS, qf, Ks);
    __syncwarp();
    const int valid = S - k0 - half * 32;
#pragma unroll 8
    for (int j = 0; j < 32; ++j) {
      const int c = (j + rr) & 31;
      const float pv = c < valid ? expf(__fmul_rn(srow[c], p.scale) - m) / l : 0.f;
      prow[c] = __float2bfloat16(pv);
    }
    __syncwarp();
    rows_times_tile<DH>(oacc, Ps + wr * LDP, Vs);
  }
  const int q = q0 + wr;
  store_rows<DH>(p.o + b * p.out_b + h * p.out_h + static_cast<long long>(q) * p.out_r,
                 p.out_r, S - q, oacc, Ss + wr * LDS, 1.f);
  if (p.stats != nullptr && half == 0 && q + rr < S) {
    float* st = p.stats + (static_cast<long long>(b) * p.H + h) * 3 * S;
    st[q + rr] = m;
    st[S + q + rr] = l;
  }
}

template <int DH>
__global__ void __launch_bounds__(THREADS) flash_bwd_dq_kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int LDH = DH + PAD_H;
  constexpr size_t T = tile_bytes<DH>();
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Os = reinterpret_cast<bf16*>(smem + T);      // dO tile
  bf16* Ks = reinterpret_cast<bf16*>(smem + 2 * T);
  bf16* Vs = reinterpret_cast<bf16*>(smem + 3 * T);
  float* Ss = reinterpret_cast<float*>(smem + 4 * T);                // scores
  float* Dp = reinterpret_cast<float*>(smem + 4 * T + SCORE_BYTES);  // dP
  bf16* Ds = reinterpret_cast<bf16*>(smem + 4 * T + 2 * SCORE_BYTES);

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * FQ, S = p.S;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wr = warp * 16, rr = lane & 15, half = lane >> 4;
  const long long in_base = b * p.in_b + h * p.in_h;
  float* st = p.stats + (static_cast<long long>(b) * p.H + h) * 3 * S;

  load_tile<DH>(Qs, p.q + in_base, p.in_r, q0, S);
  load_tile<DH>(Os, p.dout + b * p.out_b + h * p.out_h, p.out_r, q0, S);
  __syncthreads();
  FragA qf[DH / 16], of[DH / 16];
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    wmma::load_matrix_sync(qf[kk], Qs + wr * LDH + kk * 16, LDH);
    wmma::load_matrix_sync(of[kk], Os + wr * LDH + kk * 16, LDH);
  }
  const int q = q0 + wr + rr;
  const float m = q < S ? st[q] : 0.f;
  const float l = q < S ? st[S + q] : 1.f;
  const float* srow = Ss + (wr + rr) * LDS + half * 32;
  const float* drow = Dp + (wr + rr) * LDS + half * 32;

  // Pass 1: rowsum(P * dP) over all keys, in f32.
  float rs = 0.f;
  for (int k0 = 0; k0 < S; k0 += FK) {
    __syncthreads();
    load_tile<DH>(Ks, p.k + in_base, p.in_r, k0, S);
    load_tile<DH>(Vs, p.v + in_base, p.in_r, k0, S);
    __syncthreads();
    rows_times_tile_t<DH>(Ss + wr * LDS, qf, Ks);
    rows_times_tile_t<DH>(Dp + wr * LDS, of, Vs);
    __syncwarp();
    const int valid = S - k0 - half * 32;
#pragma unroll 8
    for (int j = 0; j < 32; ++j) {
      const int c = (j + rr) & 31;
      if (c < valid) rs += expf(__fmul_rn(srow[c], p.scale) - m) / l * drow[c];
    }
  }
  rs += __shfl_xor_sync(0xffffffffu, rs, 16);
  if (half == 0 && q < S) st[2 * S + q] = rs;

  // Pass 2: dq = bf16(dS) K * scale, dS = P * (dP - rowsum).
  FragC qacc[DH / 16];
#pragma unroll
  for (int j = 0; j < DH / 16; ++j) wmma::fill_fragment(qacc[j], 0.f);
  bf16* dsrow = Ds + (wr + rr) * LDP + half * 32;
  for (int k0 = 0; k0 < S; k0 += FK) {
    __syncthreads();
    load_tile<DH>(Ks, p.k + in_base, p.in_r, k0, S);
    load_tile<DH>(Vs, p.v + in_base, p.in_r, k0, S);
    __syncthreads();
    rows_times_tile_t<DH>(Ss + wr * LDS, qf, Ks);
    rows_times_tile_t<DH>(Dp + wr * LDS, of, Vs);
    __syncwarp();
    const int valid = S - k0 - half * 32;
#pragma unroll 8
    for (int j = 0; j < 32; ++j) {
      const int c = (j + rr) & 31;
      float ds = 0.f;
      if (c < valid) {
        const float pv = expf(__fmul_rn(srow[c], p.scale) - m) / l;
        ds = pv * (drow[c] - rs);
      }
      dsrow[c] = __float2bfloat16(ds);
    }
    __syncwarp();
    rows_times_tile<DH>(qacc, Ds + wr * LDP, Ks);
  }
  const int qw = q0 + wr;
  store_rows<DH>(p.dq + in_base + static_cast<long long>(qw) * p.in_r, p.in_r, S - qw, qacc,
                 Ss + wr * LDS, p.scale);
}

template <int DH>
__global__ void __launch_bounds__(THREADS) flash_bwd_dkv_kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int LDH = DH + PAD_H;
  constexpr size_t T = tile_bytes<DH>();
  bf16* Kt = reinterpret_cast<bf16*>(smem);
  bf16* Vt = reinterpret_cast<bf16*>(smem + T);
  bf16* Qs = reinterpret_cast<bf16*>(smem + 2 * T);
  bf16* Os = reinterpret_cast<bf16*>(smem + 3 * T);                  // dO tile
  float* St = reinterpret_cast<float*>(smem + 4 * T);                // S^T
  float* Dt = reinterpret_cast<float*>(smem + 4 * T + SCORE_BYTES);  // dP^T
  bf16* Pt = reinterpret_cast<bf16*>(smem + 4 * T + 2 * SCORE_BYTES);
  bf16* Gt = reinterpret_cast<bf16*>(smem + 4 * T + 2 * SCORE_BYTES + PROB_BYTES);  // dS^T
  float* Qstat = reinterpret_cast<float*>(smem + 4 * T + 2 * SCORE_BYTES + 2 * PROB_BYTES);

  const int b = blockIdx.z, h = blockIdx.y, k0 = blockIdx.x * FK, S = p.S;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int kr = warp * 16, rr = lane & 15, half = lane >> 4;
  const long long in_base = b * p.in_b + h * p.in_h;
  const long long out_base = b * p.out_b + h * p.out_h;
  const float* st = p.stats + (static_cast<long long>(b) * p.H + h) * 3 * S;

  load_tile<DH>(Kt, p.k + in_base, p.in_r, k0, S);
  load_tile<DH>(Vt, p.v + in_base, p.in_r, k0, S);
  __syncthreads();
  FragA kf[DH / 16], vf[DH / 16];
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    wmma::load_matrix_sync(kf[kk], Kt + kr * LDH + kk * 16, LDH);
    wmma::load_matrix_sync(vf[kk], Vt + kr * LDH + kk * 16, LDH);
  }
  const bool key_ok = k0 + kr + rr < S;
  const float* srow = St + (kr + rr) * LDS + half * 32;
  const float* drow = Dt + (kr + rr) * LDS + half * 32;
  bf16* prow = Pt + (kr + rr) * LDP + half * 32;
  bf16* grow = Gt + (kr + rr) * LDP + half * 32;

  FragC vacc[DH / 16], kacc[DH / 16];
#pragma unroll
  for (int j = 0; j < DH / 16; ++j) {
    wmma::fill_fragment(vacc[j], 0.f);
    wmma::fill_fragment(kacc[j], 0.f);
  }
  for (int i0 = 0; i0 < S; i0 += FQ) {
    __syncthreads();
    load_tile<DH>(Qs, p.q + in_base, p.in_r, i0, S);
    load_tile<DH>(Os, p.dout + out_base, p.out_r, i0, S);
    for (int i = threadIdx.x; i < 3 * FQ; i += THREADS) {
      const int w = i / FQ, qi = i0 + i % FQ;
      Qstat[i] = qi < S ? st[w * S + qi] : (w == 1 ? 1.f : 0.f);
    }
    __syncthreads();
    rows_times_tile_t<DH>(St + kr * LDS, kf, Qs);
    rows_times_tile_t<DH>(Dt + kr * LDS, vf, Os);
    __syncwarp();
    const int valid = key_ok ? S - i0 - half * 32 : 0;
#pragma unroll 8
    for (int j = 0; j < 32; ++j) {
      const int c = (j + rr) & 31;
      float pv = 0.f, ds = 0.f;
      if (c < valid) {
        const int qi = half * 32 + c;
        pv = expf(__fmul_rn(srow[c], p.scale) - Qstat[qi]) / Qstat[FQ + qi];
        ds = pv * (drow[c] - Qstat[2 * FQ + qi]);
      }
      prow[c] = __float2bfloat16(pv);
      grow[c] = __float2bfloat16(ds);
    }
    __syncwarp();
    rows_times_tile<DH>(vacc, Pt + kr * LDP, Os);
    rows_times_tile<DH>(kacc, Gt + kr * LDP, Qs);
  }
  const int kw = k0 + kr;
  store_rows<DH>(p.dk + in_base + static_cast<long long>(kw) * p.in_r, p.in_r, S - kw, kacc,
                 St + kr * LDS, p.scale);
  store_rows<DH>(p.dv + in_base + static_cast<long long>(kw) * p.in_r, p.in_r, S - kw, vacc,
                 St + kr * LDS, 1.f);
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, size_t smem, const Params& p, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid((p.S + FQ - 1) / FQ, p.H, p.B);
  kernel<<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int DH>
cudaError_t fwd(const Params& p, cudaStream_t stream) {
  return launch(flash_fwd_kernel<DH>, fwd_smem<DH>(), p, stream);
}

template <int DH>
cudaError_t bwd(const Params& p, cudaStream_t stream) {
  cudaError_t err = launch(flash_bwd_dq_kernel<DH>, dq_smem<DH>(), p, stream);
  if (err != cudaSuccess) return err;
  return launch(flash_bwd_dkv_kernel<DH>, dkv_smem<DH>(), p, stream);
}

// The (B, H, S, dh) layout of the standalone wrapper: every tensor contiguous.
Params heads_layout(const void* q, const void* k, const void* v, int B, int H, int S, int dh,
                    float scale) {
  Params p = {};
  p.q = static_cast<const bf16*>(q);
  p.k = static_cast<const bf16*>(k);
  p.v = static_cast<const bf16*>(v);
  p.in_b = p.out_b = static_cast<long long>(H) * S * dh;
  p.in_h = p.out_h = static_cast<long long>(S) * dh;
  p.in_r = p.out_r = dh;
  p.B = B;
  p.H = H;
  p.S = S;
  p.scale = scale;
  return p;
}

}  // namespace

cudaError_t launch_fwd(const Params& p, int dh, cudaStream_t stream) {
  if (dh == 64) return fwd<64>(p, stream);
  if (dh == 32) return fwd<32>(p, stream);
  return cudaErrorInvalidValue;
}

cudaError_t launch_bwd(const Params& p, int dh, cudaStream_t stream) {
  if (p.stats == nullptr) return cudaErrorInvalidValue;
  if (dh == 64) return bwd<64>(p, stream);
  if (dh == 32) return bwd<32>(p, stream);
  return cudaErrorInvalidValue;
}

}  // namespace dp_flash

extern "C" {

// _flash_kernel on (B, H, S, dh) bf16 tensors: o, and the row statistics
// into stats (B, H, 3, S) f32 (rows 0 and 1).
int dp_flash_fwd(const void* q, const void* k, const void* v, void* o, void* stats, int B,
                 int H, int S, int dh, float scale, void* stream) {
  dp_flash::Params p = dp_flash::heads_layout(q, k, v, B, H, S, dh, scale);
  p.o = static_cast<bf16*>(o);
  p.stats = static_cast<float*>(stats);
  return static_cast<int>(dp_flash::launch_fwd(p, dh, static_cast<cudaStream_t>(stream)));
}

// _flash_bwd_kernel on (B, H, S, dh) bf16 tensors: dq, dk, dv from the
// cotangent dout and the forward's statistics (stats row 2 is written).
int dp_flash_bwd(const void* q, const void* k, const void* v, const void* dout, void* stats,
                 void* dq, void* dk, void* dv, int B, int H, int S, int dh, float scale,
                 void* stream) {
  dp_flash::Params p = dp_flash::heads_layout(q, k, v, B, H, S, dh, scale);
  p.dout = static_cast<const bf16*>(dout);
  p.stats = static_cast<float*>(stats);
  p.dq = static_cast<bf16*>(dq);
  p.dk = static_cast<bf16*>(dk);
  p.dv = static_cast<bf16*>(dv);
  return static_cast<int>(dp_flash::launch_bwd(p, dh, static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
