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
//   flash_fwd_kernel<DH, MT>  one block per (16*4*MT-query tile, head,
//                             batch), 4 warps of 16*MT query rows; two
//                             passes over the key tiles: the first finds
//                             each row's max m and sum l (the sum rescaled
//                             as the max moves), the second forms
//                             P = bf16(exp(s*scale - m) * (1/l)) and
//                             accumulates P V in f32.
//   flash_bwd_dq_kernel<DH>   per 64-query tile over the key tiles: a first
//                             pass sums rowsum(P * dP) exactly in f32, the
//                             second forms dS = P * (dP - rowsum) and
//                             accumulates bf16(dS) K.
//   flash_bwd_dkv_kernel<DH>  per 64-key tile over the query tiles: P and dS
//                             rebuilt from the statistics, dv += bf16(P)^T dO,
//                             dk += bf16(dS)^T Q.
//
// Rounding points are those of the JAX kernels (attention.py:50-69 and
// :143-186): f32 scores, max-subtracted exp, f32 normalisation, P rounded to
// bf16 before P V and the output rounded once; in the backward P and dP in
// f32, dS formed with the exact f32 rowsum(P * dP), bf16(P) and bf16(dS)
// before their products, dq, dk and dv accumulated in f32 and rounded once
// (dq and dk after the scale). Departures at the level of f32 roundoff: the
// exp is exp2 with scale*log2(e) folded into one FMA, each row's 1/l is
// taken once and multiplied in, and l is summed tile by tile, rescaled as
// the running max moves, where JAX sums exp(s - max) over the whole row
// once. A single online-softmax pass would round P before it is normalised,
// and rowsum(dO * O) in place of rowsum(P * dP) would move the backward's
// rounding; neither is taken. Keys >= S get P = 0 (JAX's valid_len mask) and
// queries >= S are never written: the ragged last tile is zero-filled in
// shared memory and masked, no padding copy is made. No atomics: two runs
// give the same bits.
//
// Bound on an H100 at dinov2-small, 504² input (S = 1297, 6 heads of 64):
// JAX's counts, 4*B*H*S^2*dh FLOPs forward and 10*B*H*S^2*dh backward
// (0.084 and 0.209 ms at B = 32), bound by operations from batch 1. The
// exact rowsum and the normalised P cost recomputation: the kernels execute
// 6 (forward: Q K^T in both passes) and 18 (backward: Q K^T and dO V^T in
// both dq passes and again in dkv) B*H*S^2*dh FLOPs, ops/attention.py's
// flash_cost. What bounds them on the card is the rate of those products
// and the per-score arithmetic (an exp and a few FMAs on each of S^2 scores
// per pass). The design, for the tensor cores' register-level rate:
//
//   - mma.sync.m16n8k16 (bf16 in, f32 accumulate) through inline PTX, whose
//     fragment layout is documented: scores, P, dP and dS never leave
//     registers. A warp owns 16 rows; the row max and sum reduce over the
//     quad of lanes that holds a row. The f32 accumulator of Q K^T (or
//     K Q^T) is packed to bf16 pairs in place as the A operand of P V,
//     dS K, P^T dO and dS^T Q.
//   - K and V tiles (Q and dO in the dkv kernel) arrive by cp.async in a
//     ring of two stages: the next tile's copy runs while the tensor cores
//     work on the current one (the forward's second pass starts its first
//     tile's copy during the first pass's last). Operands reach registers by
//     ldmatrix (.trans for the k-major B operands) from rows padded by 16
//     bytes, so the eight rows of an 8x8 matrix fall in different banks.
//   - exp2 (ex2.approx.ftz) of one FMA per score; one reciprocal per row.
//   - Tiles (measured on an H100 80GB HBM3 at 700 W at S = 1297, dh = 64,
//     chip_smoke.py's flash phase): 64 keys per streamed tile and 4 warps a
//     block throughout; the forward takes 64 query rows a block (MT = 1:
//     126 blocks at B = 1 on 132 SMs, 0.034 ms against 0.047 for 66
//     128-row blocks) where 128-row blocks would leave fewer than two
//     blocks per SM, else 128 (MT = 2: each ldmatrix'd K and V fragment
//     feeds two row tiles and the K/V traffic per query halves; 0.129
//     against 0.141 ms at B = 8, 0.500 against 0.515 at B = 32). The
//     backward pair runs 64-row tiles (126 blocks each at B = 1): its
//     accumulators (dk and dv, or S, dP and dq) already take 168-245
//     registers a thread, no room for a second row tile.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_kernels.cuh"

typedef __nv_bfloat16 bf16;

namespace dp_flash {
namespace {

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int FK = 64;   // keys (queries in the dkv kernel) per streamed tile
constexpr int PAD = 8;   // bf16 row padding: 16 bytes, conflict-free ldmatrix
constexpr float LOG2E = 1.4426950408889634f;

template <int DH>
constexpr size_t tile_bytes(int rows) {
  return static_cast<size_t>(rows) * (DH + PAD) * sizeof(bf16);
}
// Q tile + two stages of K and V.
template <int DH, int MT>
constexpr size_t fwd_smem() { return tile_bytes<DH>(64 * MT) + 4 * tile_bytes<DH>(FK); }
// Q and dO tiles + two stages of K and V.
template <int DH>
constexpr size_t dq_smem() { return 2 * tile_bytes<DH>(64) + 4 * tile_bytes<DH>(FK); }
// K and V tiles + two stages of Q and dO + two stages of the queries'
// (m * log2e, 1/l, rowsum) triples.
template <int DH>
constexpr size_t dkv_smem() {
  return 2 * tile_bytes<DH>(64) + 4 * tile_bytes<DH>(FK) + 2 * 3 * FK * sizeof(float);
}

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c (16 x 8, f32) += a (16 x 16, bf16) b (16 x 8, bf16).
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The mma fragments (lane = 4*g + t): an accumulator c of a 16 x 8 tile holds
// (row g, cols 2t, 2t+1) in c[0..1] and (row g+8, the same cols) in c[2..3];
// an A operand a[0..3] = (row g, k 2t..), (row g+8, k 2t..), (row g,
// k 2t+8..), (row g+8, k 2t+8..); a B operand b[0..1] = (k 2t.., col g),
// (k 2t+8.., col g).

// rows [r0, r0 + ROWS) of a (., DH) slab with row stride ld into a padded
// shared tile, asynchronously; rows >= S are zero-filled.
template <int DH, int ROWS>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, long long ld, int r0,
                                          int S) {
  constexpr int VPR = DH / 8;  // 16-byte vectors per row
  static_assert(ROWS * VPR % THREADS == 0, "tile vectors must split evenly over the block");
  const uint32_t base = smem_u32(dst);
#pragma unroll
  for (int k = 0; k < ROWS * VPR / THREADS; ++k) {
    const int i = threadIdx.x + k * THREADS;
    const int r = i / VPR, c = (i % VPR) * 8;
    const bool valid = r0 + r < S;
    cp_async16(base + (r * (DH + PAD) + c) * 2, valid ? src + (r0 + r) * ld + c : src, valid);
  }
}

// The A operand of rows [r0, r0 + 16), k [k0, k0 + 16) of a row-major tile.
template <int DH>
__device__ __forceinline__ void lds_a(uint32_t (&a)[4], const bf16* tile, int r0, int k0) {
  const int lane = threadIdx.x & 31;
  ldsm_x4(a, smem_u32(tile + (r0 + (lane & 7) + ((lane >> 3) & 1) * 8) * (DH + PAD) + k0 +
                      (lane >> 4) * 8));
}

// B operands of two 8-column tiles, cols [n0, n0 + 16), from a tile whose
// rows are the columns (K for Q K^T): b[0..1] cols n0.., b[2..3] n0 + 8...
template <int DH>
__device__ __forceinline__ void lds_b_nk(uint32_t (&b)[4], const bf16* tile, int n0, int k0) {
  const int lane = threadIdx.x & 31;
  ldsm_x4(b, smem_u32(tile + (n0 + (lane & 7) + (lane >> 4) * 8) * (DH + PAD) + k0 +
                      ((lane >> 3) & 1) * 8));
}

// B operands of two 8-column tiles from a tile whose rows are k (V for P V).
template <int DH>
__device__ __forceinline__ void lds_b_kn(uint32_t (&b)[4], const bf16* tile, int k0, int n0) {
  const int lane = threadIdx.x & 31;
  ldsm_x4_t(b, smem_u32(tile + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * (DH + PAD) + n0 +
                        (lane >> 4) * 8));
}

// s[mt] (16 x 64, f32) = a[mt] (16 x DH) times the 64 rows of tile
// transposed: Q K^T, dO V^T, K Q^T or V dO^T for MT row tiles.
template <int DH, int MT>
__device__ __forceinline__ void rows_times_tile_t(float (&s)[MT][FK / 8][4],
                                                  const uint32_t (&a)[MT][DH / 16][4],
                                                  const bf16* tile) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < FK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[mt][j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
#pragma unroll
    for (int j2 = 0; j2 < FK / 16; ++j2) {
      uint32_t b[4];
      lds_b_nk<DH>(b, tile, 16 * j2, 16 * kk);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mma(s[mt][2 * j2], a[mt][kk], b[0], b[1]);
        mma(s[mt][2 * j2 + 1], a[mt][kk], b[2], b[3]);
      }
    }
  }
}

// acc[mt] (16 x DH) += p[mt] (16 x 64 as bf16 A operands) times tile
// (64 x DH): P V, dS K, P^T dO, dS^T Q.
template <int DH, int MT>
__device__ __forceinline__ void rows_times_tile(float (&acc)[MT][DH / 8][4],
                                                const uint32_t (&p)[MT][FK / 16][4],
                                                const bf16* tile) {
#pragma unroll
  for (int kk = 0; kk < FK / 16; ++kk) {
#pragma unroll
    for (int j2 = 0; j2 < DH / 16; ++j2) {
      uint32_t b[4];
      lds_b_kn<DH>(b, tile, 16 * kk, 16 * j2);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mma(acc[mt][2 * j2], p[mt][kk], b[0], b[1]);
        mma(acc[mt][2 * j2 + 1], p[mt][kk], b[2], b[3]);
      }
    }
  }
}

// The A operand of the 16 x 64 product's k chunk kk from its accumulator:
// an accumulator's column pairs are an A operand's k pairs.
__device__ __forceinline__ void to_a(uint32_t (&a)[4], const float (&s)[FK / 8][4], int kk) {
  a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
  a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
  a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
  a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
}

template <int DH, int MT>
__device__ __forceinline__ void zero(float (&acc)[MT][DH / 8][4]) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < DH / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.f;
}

// Rounds a warp's 16 x DH accumulator (times scale) to bf16 rows
// dst + r*ld, r = row0 + (g, g + 8) for r < S.
template <int DH>
__device__ __forceinline__ void store_rows(bf16* dst, long long ld, int row0, int S,
                                           const float (&acc)[DH / 8][4], float scale) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = row0 + g + 8 * hr;
    if (r >= S) continue;
    bf16* row = dst + r * ld + 2 * t;
#pragma unroll
    for (int j = 0; j < DH / 8; ++j)
      *reinterpret_cast<uint32_t*>(row + 8 * j) =
          pack_bf16(acc[j][2 * hr] * scale, acc[j][2 * hr + 1] * scale);
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Columns of a 64-wide tile at or past valid (keys >= S) to -inf.
template <int MT>
__device__ __forceinline__ void mask_cols(float (&s)[MT][FK / 8][4], int valid) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < FK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (8 * j + 2 * t + (e & 1) >= valid) s[mt][j][e] = -INFINITY;
}

template <int DH, int MT>
__global__ void __launch_bounds__(THREADS) flash_fwd_kernel(const Params p) {
  constexpr int BQ = 64 * MT, LD = DH + PAD;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + BQ * LD;      // two stages
  bf16* Vs = Ks + 2 * FK * LD;  // two stages

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * BQ, S = p.S;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wr = warp * 16 * MT;
  const long long in_base = b * p.in_b + h * p.in_h;
  const bf16* kg = p.k + in_base;
  const bf16* vg = p.v + in_base;
  const int nt = (S + FK - 1) / FK;
  const float c = p.scale * LOG2E;

  // Step i < nt streams key tile i for pass 1 (K), step nt + t tile t for
  // pass 2 (K and V), into stage i & 1; step i + 1's copy is issued before
  // step i's products.
  auto prefetch = [&](int i) {
    const int t = i < nt ? i : i - nt;
    load_tile<DH, FK>(Ks + (i & 1) * FK * LD, kg, p.in_r, t * FK, S);
    if (i >= nt) load_tile<DH, FK>(Vs + (i & 1) * FK * LD, vg, p.in_r, t * FK, S);
    cp_commit();
  };
  load_tile<DH, BQ>(Qs, p.q + in_base, p.in_r, q0, S);
  prefetch(0);

  uint32_t qa[MT][DH / 16][4];
  float m[MT][2], l[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      m[mt][hr] = -INFINITY;
      l[mt][hr] = 0.f;
    }
  float s[MT][FK / 8][4];

  // Pass 1: each row's max (of the raw products: max commutes with the
  // positive scale) and its sum of exp2((s - m) * scale * log2e), a
  // partial sum per lane, rescaled as the max moves.
  for (int i = 0; i < nt; ++i) {
    prefetch(i + 1);
    cp_wait<1>();
    __syncthreads();
    if (i == 0) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int kk = 0; kk < DH / 16; ++kk) lds_a<DH>(qa[mt][kk], Qs, wr + 16 * mt, 16 * kk);
    }
    rows_times_tile_t<DH, MT>(s, qa, Ks + (i & 1) * FK * LD);
    if (i * FK + FK > S) mask_cols<MT>(s, S - i * FK);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < FK / 8; ++j)
          mx = fmaxf(mx, fmaxf(s[mt][j][2 * hr], s[mt][j][2 * hr + 1]));
        const float mnew = fmaxf(m[mt][hr], quad_max(mx));  // finite: a tile holds a key
        const float mc = mnew * c;
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < FK / 8; ++j)
          sum += ex2(fmaf(s[mt][j][2 * hr], c, -mc)) + ex2(fmaf(s[mt][j][2 * hr + 1], c, -mc));
        l[mt][hr] = l[mt][hr] * ex2((m[mt][hr] - mnew) * c) + sum;
        m[mt][hr] = mnew;
      }
    __syncthreads();
  }

  float mc[MT][2], rl[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      l[mt][hr] = quad_sum(l[mt][hr]);
      mc[mt][hr] = m[mt][hr] * c;
      rl[mt][hr] = 1.f / l[mt][hr];
    }

  // Pass 2: O = bf16(P) V with P = exp2((s - m) * c) * (1/l), in f32.
  float o[MT][DH / 8][4];
  zero<DH, MT>(o);
  for (int t = 0; t < nt; ++t) {
    const int i = nt + t;
    if (t + 1 < nt) {
      prefetch(i + 1);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    rows_times_tile_t<DH, MT>(s, qa, Ks + (i & 1) * FK * LD);
    if (t * FK + FK > S) mask_cols<MT>(s, S - t * FK);
    uint32_t pa[MT][FK / 16][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int j = 0; j < FK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[mt][j][e] = ex2(fmaf(s[mt][j][e], c, -mc[mt][e >> 1])) * rl[mt][e >> 1];
#pragma unroll
      for (int kk = 0; kk < FK / 16; ++kk) to_a(pa[mt][kk], s[mt], kk);
    }
    rows_times_tile<DH, MT>(o, pa, Vs + (i & 1) * FK * LD);
    __syncthreads();
  }

  bf16* og = p.o + b * p.out_b + h * p.out_h;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int r0 = q0 + wr + 16 * mt;
    store_rows<DH>(og, p.out_r, r0, S, o[mt], 1.f);
    if (p.stats != nullptr && (lane & 3) == 0) {
      float* st = p.stats + (static_cast<long long>(b) * p.H + h) * 3 * S;
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int q = r0 + (lane >> 2) + 8 * hr;
        if (q < S) {
          st[q] = m[mt][hr] * p.scale;
          st[S + q] = l[mt][hr];
        }
      }
    }
  }
}

template <int DH>
__global__ void __launch_bounds__(THREADS) flash_bwd_dq_kernel(const Params p) {
  constexpr int LD = DH + PAD;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Os = Qs + 64 * LD;      // dO tile
  bf16* Ks = Os + 64 * LD;      // two stages
  bf16* Vs = Ks + 2 * FK * LD;  // two stages

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * 64, S = p.S;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wr = warp * 16;
  const long long in_base = b * p.in_b + h * p.in_h;
  const bf16* kg = p.k + in_base;
  const bf16* vg = p.v + in_base;
  float* st = p.stats + (static_cast<long long>(b) * p.H + h) * 3 * S;
  const int nt = (S + FK - 1) / FK;
  const float c = p.scale * LOG2E;

  // Step i streams key tile i mod nt (K and V) into stage i & 1: pass 1
  // for i < nt, pass 2 after.
  auto prefetch = [&](int i) {
    const int t = i < nt ? i : i - nt;
    load_tile<DH, FK>(Ks + (i & 1) * FK * LD, kg, p.in_r, t * FK, S);
    load_tile<DH, FK>(Vs + (i & 1) * FK * LD, vg, p.in_r, t * FK, S);
    cp_commit();
  };
  load_tile<DH, 64>(Qs, p.q + in_base, p.in_r, q0, S);
  load_tile<DH, 64>(Os, p.dout + b * p.out_b + h * p.out_h, p.out_r, q0, S);
  prefetch(0);

  float mc[2], rl[2], rs[2] = {0.f, 0.f};
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int q = q0 + wr + (lane >> 2) + 8 * hr;
    mc[hr] = q < S ? st[q] * LOG2E : 0.f;
    rl[hr] = q < S ? 1.f / st[S + q] : 0.f;
  }
  uint32_t qa[1][DH / 16][4], oa[1][DH / 16][4];
  float s[1][FK / 8][4], dp[1][FK / 8][4];

  // P = exp2(s * c - m * log2e) * (1/l), 0 at keys >= S.
  auto probs = [&](int k0) {
    if (k0 + FK > S) mask_cols<1>(s, S - k0);
#pragma unroll
    for (int j = 0; j < FK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[0][j][e] = ex2(fmaf(s[0][j][e], c, -mc[e >> 1])) * rl[e >> 1];
  };

  // Pass 1: rowsum(P * dP) over all keys, in f32.
  for (int i = 0; i < nt; ++i) {
    prefetch(i + 1);
    cp_wait<1>();
    __syncthreads();
    if (i == 0) {
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        lds_a<DH>(qa[0][kk], Qs, wr, 16 * kk);
        lds_a<DH>(oa[0][kk], Os, wr, 16 * kk);
      }
    }
    rows_times_tile_t<DH, 1>(s, qa, Ks + (i & 1) * FK * LD);
    rows_times_tile_t<DH, 1>(dp, oa, Vs + (i & 1) * FK * LD);
    probs(i * FK);
#pragma unroll
    for (int j = 0; j < FK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) rs[e >> 1] = fmaf(s[0][j][e], dp[0][j][e], rs[e >> 1]);
    __syncthreads();
  }
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    rs[hr] = quad_sum(rs[hr]);
    const int q = q0 + wr + (lane >> 2) + 8 * hr;
    if ((lane & 3) == 0 && q < S) st[2 * S + q] = rs[hr];
  }

  // Pass 2: dq = bf16(dS) K * scale, dS = P * (dP - rowsum).
  float dq[1][DH / 8][4];
  zero<DH, 1>(dq);
  for (int t = 0; t < nt; ++t) {
    const int i = nt + t;
    if (t + 1 < nt) {
      prefetch(i + 1);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    rows_times_tile_t<DH, 1>(s, qa, Ks + (i & 1) * FK * LD);
    rows_times_tile_t<DH, 1>(dp, oa, Vs + (i & 1) * FK * LD);
    probs(t * FK);
#pragma unroll
    for (int j = 0; j < FK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[0][j][e] *= dp[0][j][e] - rs[e >> 1];
    uint32_t da[1][FK / 16][4];
#pragma unroll
    for (int kk = 0; kk < FK / 16; ++kk) to_a(da[0][kk], s[0], kk);
    rows_times_tile<DH, 1>(dq, da, Ks + (i & 1) * FK * LD);
    __syncthreads();
  }
  store_rows<DH>(p.dq + in_base, p.in_r, q0 + wr, S, dq[0], p.scale);
}

template <int DH>
__global__ void __launch_bounds__(THREADS) flash_bwd_dkv_kernel(const Params p) {
  constexpr int LD = DH + PAD;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Kt = reinterpret_cast<bf16*>(smem);
  bf16* Vt = Kt + 64 * LD;
  bf16* Qs = Vt + 64 * LD;      // two stages
  bf16* Os = Qs + 2 * FK * LD;  // dO, two stages
  float* Ls = reinterpret_cast<float*>(Os + 2 * FK * LD);  // two stages of (m*log2e, 1/l, rowsum)

  const int b = blockIdx.z, h = blockIdx.y, k0 = blockIdx.x * 64, S = p.S;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int kr = warp * 16;
  const long long in_base = b * p.in_b + h * p.in_h;
  const bf16* qg = p.q + in_base;
  const bf16* og = p.dout + b * p.out_b + h * p.out_h;
  const float* st = p.stats + (static_cast<long long>(b) * p.H + h) * 3 * S;
  const int nt = (S + FK - 1) / FK;
  const float c = p.scale * LOG2E;

  // Query tile t's statistics, read by threads < FK (queries >= S get
  // 1/l = 0, so their P and dS are 0: their Q and dO rows are zero-filled).
  float stat[3];
  auto read_stats = [&](int t) {
    const int q = t * FK + threadIdx.x;
    const bool ok = threadIdx.x < FK && q < S;
    stat[0] = ok ? st[q] * LOG2E : 0.f;
    stat[1] = ok ? 1.f / st[S + q] : 0.f;
    stat[2] = ok ? st[2 * S + q] : 0.f;
  };
  auto write_stats = [&](int stage) {
    if (threadIdx.x < FK)
#pragma unroll
      for (int w = 0; w < 3; ++w) Ls[(stage * 3 + w) * FK + threadIdx.x] = stat[w];
  };
  auto prefetch = [&](int t) {
    load_tile<DH, FK>(Qs + (t & 1) * FK * LD, qg, p.in_r, t * FK, S);
    load_tile<DH, FK>(Os + (t & 1) * FK * LD, og, p.out_r, t * FK, S);
    cp_commit();
  };
  load_tile<DH, 64>(Kt, p.k + in_base, p.in_r, k0, S);
  load_tile<DH, 64>(Vt, p.v + in_base, p.in_r, k0, S);
  prefetch(0);
  read_stats(0);
  write_stats(0);

  uint32_t ka[1][DH / 16][4], va[1][DH / 16][4];
  float s[1][FK / 8][4], dp[1][FK / 8][4];
  float dk[1][DH / 8][4], dv[1][DH / 8][4];
  zero<DH, 1>(dk);
  zero<DH, 1>(dv);
  const int t4 = lane & 3;
  for (int t = 0; t < nt; ++t) {
    const int stage = t & 1;
    if (t + 1 < nt) {
      prefetch(t + 1);
      read_stats(t + 1);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    if (t == 0) {
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        lds_a<DH>(ka[0][kk], Kt, kr, 16 * kk);
        lds_a<DH>(va[0][kk], Vt, kr, 16 * kk);
      }
    }
    const bf16* qt = Qs + stage * FK * LD;
    const bf16* ot = Os + stage * FK * LD;
    rows_times_tile_t<DH, 1>(s, ka, qt);   // S^T: keys x queries
    rows_times_tile_t<DH, 1>(dp, va, ot);  // dP^T
    const float* ls = Ls + stage * 3 * FK;
#pragma unroll
    for (int j = 0; j < FK / 8; ++j) {
      const float2 m2 = *reinterpret_cast<const float2*>(ls + 8 * j + 2 * t4);
      const float2 r2 = *reinterpret_cast<const float2*>(ls + FK + 8 * j + 2 * t4);
      const float2 s2 = *reinterpret_cast<const float2*>(ls + 2 * FK + 8 * j + 2 * t4);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool hi = e & 1;
        const float pv = ex2(fmaf(s[0][j][e], c, -(hi ? m2.y : m2.x))) * (hi ? r2.y : r2.x);
        s[0][j][e] = pv;
        dp[0][j][e] = pv * (dp[0][j][e] - (hi ? s2.y : s2.x));
      }
    }
    uint32_t pa[1][FK / 16][4], da[1][FK / 16][4];
#pragma unroll
    for (int kk = 0; kk < FK / 16; ++kk) {
      to_a(pa[0][kk], s[0], kk);
      to_a(da[0][kk], dp[0], kk);
    }
    rows_times_tile<DH, 1>(dv, pa, ot);
    rows_times_tile<DH, 1>(dk, da, qt);
    if (t + 1 < nt) write_stats(stage ^ 1);
    __syncthreads();
  }
  store_rows<DH>(p.dk + in_base, p.in_r, k0 + kr, S, dk[0], p.scale);
  store_rows<DH>(p.dv + in_base, p.in_r, k0 + kr, S, dv[0], 1.f);
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, size_t smem, int rows, const Params& p, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid((p.S + rows - 1) / rows, p.H, p.B);
  kernel<<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

// The forward's query rows a block: 0 chooses by the launch's size.
int g_fwd_rows = 0;

// 128 rows a block where that still gives every SM two blocks, else 64.
int fwd_rows(const Params& p) {
  if (g_fwd_rows != 0) return g_fwd_rows;
  int device = 0, sms = 0;
  if (cudaGetDevice(&device) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess)
    return 64;
  const long long blocks128 = static_cast<long long>(p.B) * p.H * ((p.S + 127) / 128);
  return blocks128 >= 2LL * sms ? 128 : 64;
}

template <int DH>
cudaError_t fwd(const Params& p, cudaStream_t stream) {
  if (fwd_rows(p) == 128) return launch(flash_fwd_kernel<DH, 2>, fwd_smem<DH, 2>(), 128, p, stream);
  return launch(flash_fwd_kernel<DH, 1>, fwd_smem<DH, 1>(), 64, p, stream);
}

template <int DH>
cudaError_t bwd(const Params& p, cudaStream_t stream) {
  cudaError_t err = launch(flash_bwd_dq_kernel<DH>, dq_smem<DH>(), 64, p, stream);
  if (err != cudaSuccess) return err;
  return launch(flash_bwd_dkv_kernel<DH>, dkv_smem<DH>(), 64, p, stream);
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

// Sets the forward's query rows a block (64 or 128; 0 restores the choice by
// the launch's block count) and returns the previous setting: the tile
// measurement of chip_smoke.py's flash phase.
int dp_flash_fwd_rows(int rows) {
  const int prev = dp_flash::g_fwd_rows;
  if (rows == 0 || rows == 64 || rows == 128) dp_flash::g_fwd_rows = rows;
  return prev;
}

}  // extern "C"
