// Fused FastViT ConvFFN forward and backward for Hopper (sm_90a), CUDA C++
// with a plain C interface (loaded with ctypes by
// dino_pose_tpu_torch/ops/_ext.py). The backward (convffn_bwd_kernel) is
// described where it starts, below the forward.
//
// The forward replaces the Pallas kernel _convffn_fwd_kernel of
// dino_pose_tpu/ops/convffn.py (:92, pallas_call :282) and, with a residual
// operand, _convffn_fwd_res_kernel (:370, via fused_convffn_res :377: the
// stage-pair arm's block output, out + res with res added in bf16 after the
// three bf16 terms), which runs, per row
// of the (B, S, C) input y (one token of the depthwise conv's output):
//
//   m   = y * inv + shift                               BatchNorm as an affine
//   h   = m @ W1 + b1 + ((m @ A1) * mask1[b]) @ B1 * s  fc1 + ConvLoRA
//   g   = gelu(h)
//   out = g @ W2 + b2 + ((g @ A2) * mask2[b]) @ B2 * s  fc2 + ConvLoRA
//
// The point of the TPU design is that the hidden h and g (3-4x C wide) never
// reach HBM: one VMEM pass holds whole samples. Here one block of 8 warps
// takes a 32-row tile and keeps it in shared memory through the whole chain:
//
//   1. m = bf16(y*inv + shift) for the tile; u1 = bf16(f32(m @ A1) * mask1),
//      one (row, rank) pair per thread on the CUDA cores (R <= 8).
//   2. For each 64-column chunk of H:
//        h-chunk = m @ W1[:, chunk]      16x16x16 bf16 WMMA tiles, f32 sums,
//                                        W1 read straight from device memory
//                                        (L2: 2 MB at most, sa12 stage 3);
//        g-chunk = bf16(gelu(bf16(bf16(bf16(h) + bf16(b1)) +
//                  bf16(f32(u1 @ B1) * s))))   into shared memory, bf16;
//        u2     += g-chunk @ A2[chunk]   f32, per (row, rank) thread;
//        out    += g-chunk @ W2[chunk]   WMMA, the f32 (32, C) accumulator
//                                        held in shared memory.
//   3. out = bf16(bf16(bf16(out) + bf16(b2)) + bf16(f32(bf16(u2*mask2) @ B2)
//      * s)), written once.
//
// Every rounding point of the JAX kernel is kept (convffn.py:96-111): the
// products sum in f32 and are rounded to bf16 before their adds; the three
// terms of h (and of out) add left to right in bf16, each sum rounded; the
// LoRA down-products are scaled by the mask in f32 and rounded before their
// up-product. Only the f32 summation order differs.
//
// Shapes: C and H are multiples of 16 (every t8 and sa12 width: C = 48-512,
// H = 144-2048), so the 16x16 tiles need no column masks; rows past M = B*S
// are masked at the ragged edge (zero m, never written). The mask row of a
// token is row / S. Shared memory: 32*(C+8)*2 + 32*(C+4)*4 + 13 KB (115 KB
// at C = 512). The kernel launches on the caller's stream, allocates nothing
// and never synchronises; the C entry returns cudaGetLastError().
//
// Bound on an H100: 4*B*S*C*H FLOPs (plus 4*B*S*R*(C+H) for LoRA) at
// 989 TFLOP/s, or y and out plus the weights at 3.35 TB/s. This first
// version reads its W1/W2 tiles from L2 without a copy pipeline, keeps the
// output accumulator in shared memory, and gives a batch-1 late stage few
// blocks (64 rows = 2 blocks at 8x8); PERF.md holds its times.

#include <algorithm>

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int BM = 32;                   // rows (tokens) per block
constexpr int HC = 64;                   // hidden columns per chunk
constexpr int THREADS = 256;             // 8 warps
constexpr int NWARPS = THREADS / 32;
constexpr int MAXR = 8;                  // LoRA rank taken; BM * MAXR == THREADS
constexpr int PAD_H = 8;                 // bf16 row padding (WMMA ldm % 8 == 0)
constexpr int PAD_F = 4;                 // f32 row padding (WMMA ldm % 4 == 0)
constexpr int LDH = HC + PAD_F;          // Hs row stride (f32)
constexpr int LDG = HC + PAD_H;          // Gs row stride (bf16)
static_assert(BM * MAXR == THREADS, "one (row, rank) pair per thread");

__host__ __device__ __forceinline__ size_t align128(size_t n) {
  return (n + 127) & ~static_cast<size_t>(127);
}

__device__ __forceinline__ float bf16r(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ float bf(bf16 v) { return __bfloat162float(v); }

// Ms (BM, C+8) bf16 | Os (BM, C+4) f32 | Hs (BM, LDH) f32 | Gs (BM, LDG) bf16
// | U1, U2 (BM, MAXR) f32.
size_t smem_bytes(int C) {
  return align128(static_cast<size_t>(BM) * (C + PAD_H) * 2) +
         align128(static_cast<size_t>(BM) * (C + PAD_F) * 4) +
         align128(static_cast<size_t>(BM) * LDH * 4) +
         align128(static_cast<size_t>(BM) * LDG * 2) +
         align128(static_cast<size_t>(2) * BM * MAXR * 4);
}

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> FragB;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

// y, out (M, C) bf16; inv, shift, b2 (C) f32; b1 (H) f32; w1 (C, H), w2 (H, C),
// a1 (C, R), b1l (R, H), a2 (H, R), b2l (R, C) bf16; m1, m2 (M / S, R) f32;
// res (M, C) bf16 or null: _convffn_fwd_res_kernel's residual, added to the
// rounded output in bf16, last (convffn.py:112-113).
__global__ void __launch_bounds__(THREADS)
convffn_fwd_kernel(const bf16* __restrict__ y, const bf16* __restrict__ res,
                   const float* __restrict__ inv,
                   const float* __restrict__ shift, const bf16* __restrict__ w1,
                   const float* __restrict__ b1, const bf16* __restrict__ w2,
                   const float* __restrict__ b2, const bf16* __restrict__ a1,
                   const bf16* __restrict__ b1l, const bf16* __restrict__ a2,
                   const bf16* __restrict__ b2l, const float* __restrict__ m1,
                   const float* __restrict__ m2, bf16* __restrict__ out, int M, int S,
                   int C, int H, int R, float s_lora) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int ldm_ = C + PAD_H, ldo = C + PAD_F;
  bf16* Ms = reinterpret_cast<bf16*>(smem);
  unsigned char* p = smem + align128(static_cast<size_t>(BM) * ldm_ * 2);
  float* Os = reinterpret_cast<float*>(p);
  p += align128(static_cast<size_t>(BM) * ldo * 4);
  float* Hs = reinterpret_cast<float*>(p);
  p += align128(static_cast<size_t>(BM) * LDH * 4);
  bf16* Gs = reinterpret_cast<bf16*>(p);
  p += align128(static_cast<size_t>(BM) * LDG * 2);
  float* U1 = reinterpret_cast<float*>(p);
  float* U2 = U1 + BM * MAXR;

  const int m0 = blockIdx.x * BM;
  const int tid = threadIdx.x, warp = tid >> 5;

  // 1. m = bf16(y*inv + shift) (no fused multiply-add: XLA rounds the product
  //    first); rows past M are zero. The out accumulator starts at zero.
  for (int i = tid; i < BM * C; i += THREADS) {
    const int r = i / C, c = i % C;
    const int gm = m0 + r;
    float v = 0.f;
    if (gm < M)
      v = __fadd_rn(__fmul_rn(bf(y[static_cast<size_t>(gm) * C + c]), inv[c]), shift[c]);
    Ms[r * ldm_ + c] = __float2bfloat16(v);
    Os[r * ldo + c] = 0.f;
  }
  __syncthreads();

  // u1 = bf16(f32(m @ A1) * mask1): thread (ur, uj) owns row ur, rank uj.
  const int ur = tid / MAXR, uj = tid % MAXR;
  const int ugm = m0 + ur;
  const bool owns = uj < R;
  if (owns) {
    float acc = 0.f;
    for (int c = 0; c < C; ++c) acc += bf(Ms[ur * ldm_ + c]) * bf(a1[c * R + uj]);
    const float mask = ugm < M ? m1[(ugm / S) * R + uj] : 0.f;
    U1[ur * MAXR + uj] = bf16r(acc * mask);
  }
  float u2acc = 0.f;
  __syncthreads();

  constexpr int MFR = BM / 16;  // row fragments of the tile
  const int ofr = C / 16;       // column fragments of out
  for (int h0 = 0; h0 < H; h0 += HC) {
    const int w = min(HC, H - h0);  // a multiple of 16
    const int nfr = w / 16;

    // 2a. Hs = m @ W1[:, h0:h0+w], one 16x16 fragment per warp at w = 64.
    for (int f = warp; f < MFR * nfr; f += NWARPS) {
      const int fr = f / nfr, fc = f % nfr;
      FragC acc;
      wmma::fill_fragment(acc, 0.f);
      for (int k = 0; k < C; k += 16) {
        FragA af;
        FragB bfr;
        wmma::load_matrix_sync(af, Ms + fr * 16 * ldm_ + k, ldm_);
        wmma::load_matrix_sync(bfr, w1 + static_cast<size_t>(k) * H + h0 + fc * 16, H);
        wmma::mma_sync(acc, af, bfr, acc);
      }
      wmma::store_matrix_sync(Hs + fr * 16 * LDH + fc * 16, acc, LDH, wmma::mem_row_major);
    }
    __syncthreads();

    // 2b. h = bf16(bf16(bf16(acc) + bf16(b1)) + bf16(f32(u1 @ B1) * s)),
    //     g = bf16(gelu(h)) (exact, erf).
    for (int i = tid; i < BM * w; i += THREADS) {
      const int r = i / w, n = i % w;
      float lora = 0.f;
      for (int j = 0; j < R; ++j)
        lora += U1[r * MAXR + j] * bf(b1l[static_cast<size_t>(j) * H + h0 + n]);
      const float h =
          bf16r(bf16r(bf16r(Hs[r * LDH + n]) + bf16r(b1[h0 + n])) + bf16r(lora * s_lora));
      const float g = h * 0.5f * (1.f + erff(h * 0.70710678118654752440f));
      Gs[r * LDG + n] = __float2bfloat16(g);
    }
    __syncthreads();

    // 2c. u2 += g @ A2[h0:h0+w] for this thread's (row, rank).
    if (owns)
      for (int n = 0; n < w; ++n)
        u2acc += bf(Gs[ur * LDG + n]) * bf(a2[static_cast<size_t>(h0 + n) * R + uj]);

    // 2d. Os += g @ W2[h0:h0+w, :], accumulators loaded from and stored to
    //     shared memory; each warp takes every NWARPS-th fragment.
    for (int f = warp; f < MFR * ofr; f += NWARPS) {
      const int fr = f / ofr, fc = f % ofr;
      float* dst = Os + fr * 16 * ldo + fc * 16;
      FragC acc;
      wmma::load_matrix_sync(acc, dst, ldo, wmma::mem_row_major);
      for (int k = 0; k < w; k += 16) {
        FragA af;
        FragB bfr;
        wmma::load_matrix_sync(af, Gs + fr * 16 * LDG + k, LDG);
        wmma::load_matrix_sync(bfr, w2 + static_cast<size_t>(h0 + k) * C + fc * 16, C);
        wmma::mma_sync(acc, af, bfr, acc);
      }
      wmma::store_matrix_sync(dst, acc, ldo, wmma::mem_row_major);
    }
    __syncthreads();  // Hs and Gs are rewritten by the next chunk
  }

  // 3. u2 = bf16(u2 * mask2); out = bf16(bf16(bf16(acc) + bf16(b2)) +
  //    bf16(f32(u2 @ B2) * s)).
  if (owns) {
    const float mask = ugm < M ? m2[(ugm / S) * R + uj] : 0.f;
    U2[ur * MAXR + uj] = bf16r(u2acc * mask);
  }
  __syncthreads();
  for (int i = tid; i < BM * C; i += THREADS) {
    const int r = i / C, c = i % C;
    const int gm = m0 + r;
    if (gm >= M) continue;
    float lora = 0.f;
    for (int j = 0; j < R; ++j) lora += U2[r * MAXR + j] * bf(b2l[static_cast<size_t>(j) * C + c]);
    const size_t o_idx = static_cast<size_t>(gm) * C + c;
    float o = bf16r(bf16r(bf16r(Os[r * ldo + c]) + bf16r(b2[c])) + bf16r(lora * s_lora));
    if (res != nullptr) o += bf(res[o_idx]);
    out[o_idx] = __float2bfloat16(o);
  }
}

// ---------------------------------------------------------------------------
// Backward: replaces _convffn_bwd_kernel of dino_pose_tpu/ops/convffn.py
// (:117, pallas_call :335), which per row recomputes the forward and forms
//
//   du2 = bf16(f32(df @ B2^T) * s * mask2)
//   dg  = df @ W2^T + du2 @ A2^T                  f32
//   dh  = bf16(dg * gelu'(h))
//   du1 = bf16(f32(dh @ B1^T) * s * mask1)
//   dm  = dh @ W1^T + du1 @ A1^T                  f32
//   dy  = bf16(dm * inv)
//
// and sums over all rows, in f32: dinv = sum dm*y, dshift = sum dm,
// dA1 = m^T du1, dB1 = s u1^T dh, dA2 = g^T du2, dB2 = s u2^T df. The TPU
// grid runs in order and accumulates these in VMEM across programs; here
// blocks run in parallel, so a fixed grid of blocks (as many as fit on the
// card at once) walks the 32-row tiles, block i taking tiles i, i + grid,
// ..., each block adding into its own f32 partial set in device memory
// (always the same thread for the same element); convffn_bwd_reduce_kernel
// then sums the partial sets in block order. No atomics: the same inputs
// give the same bits on every run.
//
// Per tile, shared memory holds m and df (bf16), the f32 (32, C) dm
// accumulator, and for one 64-column chunk of H at a time the f32 h and dg
// products and the bf16 g and dh; h, g, dg and dh never reach device memory,
// as on the TPU. The chunk walk: h-chunk = m @ W1[:, chunk] and dg-chunk =
// df @ W2[chunk]^T on the tensor cores (WMMA; W2^T and W1^T read as
// column-major tiles of W2 and W1), the bias/LoRA epilogue, g, dg += du2 @
// A2^T and dh; then u2 += g @ A2 and du1 += dh @ B1^T per (row, rank)
// thread, the chunk's dA2 and dB1 partials, and dm += dh @ W1[:, chunk]^T
// (WMMA, accumulators in shared memory). After the walk: dm += du1 @ A1^T,
// dy, and the dinv, dshift, dA1, dB2 partials. Rounding points as in the
// JAX kernel; only the f32 summation order differs.
//
// Bound on an H100: 6*B*S*C*H FLOPs (h recomputed, dg, dm) plus the rank-R
// terms at 989 TFLOP/s, or y, df, dy plus the weights at 3.35 TB/s. Like
// the forward, this first version reads its weight tiles from L2 without a
// copy pipeline and adds its partials through device memory (L2) once per
// tile; PERF.md holds its times.

typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> FragBT;

// Ms, DFs (BM, C+8) bf16 | DMs (BM, C+4) f32 | Hs, Ds (BM, LDH) f32 |
// Gs, DHs (BM, LDG) bf16 | U1, DU2, U2, DU1 (BM, MAXR) f32.
size_t bwd_smem_bytes(int C) {
  return 2 * align128(static_cast<size_t>(BM) * (C + PAD_H) * 2) +
         align128(static_cast<size_t>(BM) * (C + PAD_F) * 4) +
         2 * align128(static_cast<size_t>(BM) * LDH * 4) +
         2 * align128(static_cast<size_t>(BM) * LDG * 2) +
         align128(static_cast<size_t>(4) * BM * MAXR * 4);
}

// Partial set of one block (and the reduced output): dinv (C) | dshift (C) |
// dA1 (C, R) | dB1 (R, H) | dA2 (H, R) | dB2 (R, C), f32.
__host__ __device__ __forceinline__ int partial_size(int C, int H, int R) {
  return 2 * C + 2 * R * (C + H);
}

__device__ __forceinline__ float gelu_grad(float z) {
  return 0.5f * (1.f + erff(z * 0.70710678118654752440f)) +
         z * expf(-0.5f * z * z) * 0.3989422804014327f;
}

__global__ void __launch_bounds__(THREADS)
convffn_bwd_kernel(const bf16* __restrict__ y, const bf16* __restrict__ df,
                   const float* __restrict__ inv, const float* __restrict__ shift,
                   const bf16* __restrict__ w1, const float* __restrict__ b1,
                   const bf16* __restrict__ w2, const bf16* __restrict__ a1,
                   const bf16* __restrict__ b1l, const bf16* __restrict__ a2,
                   const bf16* __restrict__ b2l, const float* __restrict__ m1,
                   const float* __restrict__ m2, bf16* __restrict__ dy,
                   float* __restrict__ partials, int M, int S, int C, int H, int R,
                   float s_lora) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int ldm_ = C + PAD_H, ldo = C + PAD_F;
  unsigned char* p = smem;
  bf16* Ms = reinterpret_cast<bf16*>(p);
  p += align128(static_cast<size_t>(BM) * ldm_ * 2);
  bf16* DFs = reinterpret_cast<bf16*>(p);
  p += align128(static_cast<size_t>(BM) * ldm_ * 2);
  float* DMs = reinterpret_cast<float*>(p);
  p += align128(static_cast<size_t>(BM) * ldo * 4);
  float* Hs = reinterpret_cast<float*>(p);
  p += align128(static_cast<size_t>(BM) * LDH * 4);
  float* Ds = reinterpret_cast<float*>(p);
  p += align128(static_cast<size_t>(BM) * LDH * 4);
  bf16* Gs = reinterpret_cast<bf16*>(p);
  p += align128(static_cast<size_t>(BM) * LDG * 2);
  bf16* DHs = reinterpret_cast<bf16*>(p);
  p += align128(static_cast<size_t>(BM) * LDG * 2);
  float* U1 = reinterpret_cast<float*>(p);
  float* DU2 = U1 + BM * MAXR;
  float* U2 = DU2 + BM * MAXR;
  float* DU1 = U2 + BM * MAXR;

  const int tid = threadIdx.x, warp = tid >> 5;
  const int P = partial_size(C, H, R);
  float* part = partials + static_cast<size_t>(blockIdx.x) * P;
  float* p_dinv = part;
  float* p_dshift = part + C;
  float* p_da1 = part + 2 * C;
  float* p_db1 = p_da1 + C * R;
  float* p_da2 = p_db1 + R * H;
  float* p_db2 = p_da2 + H * R;
  for (int i = tid; i < P; i += THREADS) part[i] = 0.f;

  const int ur = tid / MAXR, uj = tid % MAXR;  // this thread's (row, rank)
  const bool owns = uj < R;
  constexpr int MFR = BM / 16;
  const int cfr = C / 16;
  const int tiles = (M + BM - 1) / BM;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int m0 = tile * BM;
    __syncthreads();  // the zeroed partials are visible; the last tile is read

    // 1. m = bf16(y*inv + shift) (product rounded first, as XLA does) and df;
    //    rows past M are zero. dm starts at zero.
    for (int i = tid; i < BM * C; i += THREADS) {
      const int r = i / C, c = i % C;
      const int gm = m0 + r;
      float v = 0.f, d = 0.f;
      if (gm < M) {
        const size_t o = static_cast<size_t>(gm) * C + c;
        v = __fadd_rn(__fmul_rn(bf(y[o]), inv[c]), shift[c]);
        d = bf(df[o]);
      }
      Ms[r * ldm_ + c] = __float2bfloat16(v);
      DFs[r * ldm_ + c] = __float2bfloat16(d);
      DMs[r * ldo + c] = 0.f;
    }
    __syncthreads();

    // u1 = bf16(f32(m @ A1) * mask1), du2 = bf16(f32(df @ B2^T) * s * mask2);
    // rows past M take zero masks.
    const int ugm = m0 + ur;
    const float mk1 = owns && ugm < M ? m1[(ugm / S) * R + uj] : 0.f;
    const float mk2 = owns && ugm < M ? m2[(ugm / S) * R + uj] : 0.f;
    float u2acc = 0.f, du1acc = 0.f;
    if (owns) {
      float a = 0.f, d = 0.f;
      for (int c = 0; c < C; ++c) {
        a += bf(Ms[ur * ldm_ + c]) * bf(a1[c * R + uj]);
        d += bf(DFs[ur * ldm_ + c]) * bf(b2l[static_cast<size_t>(uj) * C + c]);
      }
      U1[ur * MAXR + uj] = bf16r(a * mk1);
      DU2[ur * MAXR + uj] = bf16r(d * s_lora * mk2);
    }
    __syncthreads();

    for (int h0 = 0; h0 < H; h0 += HC) {
      const int w = min(HC, H - h0);  // a multiple of 16
      const int nfr = w / 16;

      // 2a. Hs = m @ W1[:, h0:h0+w] and Ds = df @ W2[h0:h0+w, :]^T.
      for (int f = warp; f < 2 * MFR * nfr; f += NWARPS) {
        const bool dgrad = f >= MFR * nfr;
        const int g = dgrad ? f - MFR * nfr : f;
        const int fr = g / nfr, fc = g % nfr;
        FragC acc;
        wmma::fill_fragment(acc, 0.f);
        for (int k = 0; k < C; k += 16) {
          FragA af;
          if (dgrad) {
            FragBT bfr;
            wmma::load_matrix_sync(af, DFs + fr * 16 * ldm_ + k, ldm_);
            wmma::load_matrix_sync(bfr, w2 + static_cast<size_t>(h0 + fc * 16) * C + k, C);
            wmma::mma_sync(acc, af, bfr, acc);
          } else {
            FragB bfr;
            wmma::load_matrix_sync(af, Ms + fr * 16 * ldm_ + k, ldm_);
            wmma::load_matrix_sync(bfr, w1 + static_cast<size_t>(k) * H + h0 + fc * 16, H);
            wmma::mma_sync(acc, af, bfr, acc);
          }
        }
        wmma::store_matrix_sync((dgrad ? Ds : Hs) + fr * 16 * LDH + fc * 16, acc, LDH,
                                wmma::mem_row_major);
      }
      __syncthreads();

      // 2b. h = bf16(bf16(bf16(acc) + bf16(b1)) + bf16(f32(u1 @ B1) * s)),
      //     g = bf16(gelu(h)); dg = acc + du2 @ A2^T (f32), dh = bf16(dg * gelu'(h)).
      for (int i = tid; i < BM * w; i += THREADS) {
        const int r = i / w, n = i % w;
        float lora1 = 0.f, lora2 = 0.f;
        for (int j = 0; j < R; ++j) {
          lora1 += U1[r * MAXR + j] * bf(b1l[static_cast<size_t>(j) * H + h0 + n]);
          lora2 += DU2[r * MAXR + j] * bf(a2[static_cast<size_t>(h0 + n) * R + j]);
        }
        const float h =
            bf16r(bf16r(bf16r(Hs[r * LDH + n]) + bf16r(b1[h0 + n])) + bf16r(lora1 * s_lora));
        const float g = h * 0.5f * (1.f + erff(h * 0.70710678118654752440f));
        const float dg = Ds[r * LDH + n] + lora2;
        Gs[r * LDG + n] = __float2bfloat16(g);
        DHs[r * LDG + n] = __float2bfloat16(dg * gelu_grad(h));
      }
      __syncthreads();

      // 2c. u2 += g @ A2[chunk], du1 += dh @ B1[:, chunk]^T for this
      //     thread's (row, rank).
      if (owns)
        for (int n = 0; n < w; ++n) {
          u2acc += bf(Gs[ur * LDG + n]) * bf(a2[static_cast<size_t>(h0 + n) * R + uj]);
          du1acc += bf(DHs[ur * LDG + n]) * bf(b1l[static_cast<size_t>(uj) * H + h0 + n]);
        }

      // 2d. The chunk's partials: dA2 += g^T du2, dB1 += s u1^T dh.
      for (int q = tid; q < w * R; q += THREADS) {
        const int n = q / R, j = q % R;
        float acc = 0.f;
        for (int r = 0; r < BM; ++r) acc += bf(Gs[r * LDG + n]) * DU2[r * MAXR + j];
        p_da2[static_cast<size_t>(h0 + n) * R + j] += acc;
      }
      for (int q = tid; q < R * w; q += THREADS) {
        const int j = q / w, n = q % w;
        float acc = 0.f;
        for (int r = 0; r < BM; ++r) acc += U1[r * MAXR + j] * bf(DHs[r * LDG + n]);
        p_db1[static_cast<size_t>(j) * H + h0 + n] += acc * s_lora;
      }

      // 2e. DMs += dh @ W1[:, h0:h0+w]^T, accumulators in shared memory.
      for (int f = warp; f < MFR * cfr; f += NWARPS) {
        const int fr = f / cfr, fc = f % cfr;
        float* dst = DMs + fr * 16 * ldo + fc * 16;
        FragC acc;
        wmma::load_matrix_sync(acc, dst, ldo, wmma::mem_row_major);
        for (int k = 0; k < w; k += 16) {
          FragA af;
          FragBT bfr;
          wmma::load_matrix_sync(af, DHs + fr * 16 * LDG + k, LDG);
          wmma::load_matrix_sync(bfr, w1 + static_cast<size_t>(fc * 16) * H + h0 + k, H);
          wmma::mma_sync(acc, af, bfr, acc);
        }
        wmma::store_matrix_sync(dst, acc, ldo, wmma::mem_row_major);
      }
      __syncthreads();  // Hs, Ds, Gs and DHs are rewritten by the next chunk
    }

    // 3. du1 = bf16(du1 * s * mask1), u2 = bf16(u2 * mask2).
    if (owns) {
      DU1[ur * MAXR + uj] = bf16r(du1acc * s_lora * mk1);
      U2[ur * MAXR + uj] = bf16r(u2acc * mk2);
    }
    __syncthreads();

    // 4. dm += du1 @ A1^T; dy = bf16(dm * inv); dinv += sum dm*y, dshift +=
    //    sum dm (one thread per column, rows in order).
    for (int c = tid; c < C; c += THREADS) {
      float si = 0.f, ss = 0.f;
      for (int r = 0; r < BM && m0 + r < M; ++r) {
        float lora = 0.f;
        for (int j = 0; j < R; ++j) lora += DU1[r * MAXR + j] * bf(a1[c * R + j]);
        const float dm = DMs[r * ldo + c] + lora;
        const size_t o = static_cast<size_t>(m0 + r) * C + c;
        dy[o] = __float2bfloat16(dm * inv[c]);
        si += dm * bf(y[o]);
        ss += dm;
      }
      p_dinv[c] += si;
      p_dshift[c] += ss;
    }
    // dA1 += m^T du1, dB2 += s u2^T df.
    for (int q = tid; q < C * R; q += THREADS) {
      const int c = q / R, j = q % R;
      float acc = 0.f;
      for (int r = 0; r < BM; ++r) acc += bf(Ms[r * ldm_ + c]) * DU1[r * MAXR + j];
      p_da1[q] += acc;
    }
    for (int q = tid; q < R * C; q += THREADS) {
      const int j = q / C, c = q % C;
      float acc = 0.f;
      for (int r = 0; r < BM; ++r) acc += U2[r * MAXR + j] * bf(DFs[r * ldm_ + c]);
      p_db2[q] += acc * s_lora;
    }
  }
}

// out[i] = sum over blocks, in block order, of partials[block * P + i].
__global__ void convffn_bwd_reduce_kernel(const float* __restrict__ partials, int blocks,
                                          int P, float* __restrict__ out) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < P; i += gridDim.x * blockDim.x) {
    float acc = 0.f;
    for (int b = 0; b < blocks; ++b) acc += partials[static_cast<size_t>(b) * P + i];
    out[i] = acc;
  }
}

}  // namespace

extern "C" {

int dp_fused_convffn_res(const void* y, const void* res, const void* inv, const void* shift,
                         const void* w1, const void* b1, const void* w2, const void* b2,
                         const void* a1, const void* b1l, const void* a2, const void* b2l,
                         const void* m1, const void* m2, void* out, int M, int S, int C, int H,
                         int R, float s_lora, void* stream);

// Shared-memory bytes the kernel asks for at width C, so the wrapper can
// refuse a width the card cannot hold before launching.
long long dp_convffn_smem_bytes(int C) { return static_cast<long long>(smem_bytes(C)); }

// _convffn_fwd_kernel: out = fc2(gelu(fc1(y*inv + shift) + lora1)) + lora2
// over M = B*S rows of width C (S rows per sample, for the masks).
int dp_fused_convffn(const void* y, const void* inv, const void* shift, const void* w1,
                     const void* b1, const void* w2, const void* b2, const void* a1,
                     const void* b1l, const void* a2, const void* b2l, const void* m1,
                     const void* m2, void* out, int M, int S, int C, int H, int R,
                     float s_lora, void* stream) {
  return dp_fused_convffn_res(y, nullptr, inv, shift, w1, b1, w2, b2, a1, b1l, a2, b2l, m1, m2,
                              out, M, S, C, H, R, s_lora, stream);
}

// _convffn_fwd_res_kernel: out = res + _convffn_fwd_kernel's out, the sum
// rounded once more in bf16 (res null: _convffn_fwd_kernel).
int dp_fused_convffn_res(const void* y, const void* res, const void* inv, const void* shift,
                         const void* w1, const void* b1, const void* w2, const void* b2,
                         const void* a1, const void* b1l, const void* a2, const void* b2l,
                         const void* m1, const void* m2, void* out, int M, int S, int C, int H,
                         int R, float s_lora, void* stream) {
  const size_t smem = smem_bytes(C);
  cudaError_t err = cudaFuncSetAttribute(
      convffn_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  convffn_fwd_kernel<<<(M + BM - 1) / BM, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(y), static_cast<const bf16*>(res), static_cast<const float*>(inv),
      static_cast<const float*>(shift), static_cast<const bf16*>(w1),
      static_cast<const float*>(b1), static_cast<const bf16*>(w2),
      static_cast<const float*>(b2), static_cast<const bf16*>(a1),
      static_cast<const bf16*>(b1l), static_cast<const bf16*>(a2),
      static_cast<const bf16*>(b2l), static_cast<const float*>(m1),
      static_cast<const float*>(m2), static_cast<bf16*>(out), M, S, C, H, R, s_lora);
  return static_cast<int>(cudaGetLastError());
}

// Shared-memory bytes of the backward kernel at width C.
long long dp_convffn_bwd_smem_bytes(int C) { return static_cast<long long>(bwd_smem_bytes(C)); }

// The backward's grid over M rows of width C: as many blocks as the card
// holds at once (resident blocks per SM times the SMs), at most one per
// 32-row tile; -1 if the query fails. The wrapper sizes the partials by it.
int dp_convffn_bwd_blocks(int M, int C) {
  const size_t smem = bwd_smem_bytes(C);
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaFuncSetAttribute(convffn_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem)) != cudaSuccess ||
      cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, convffn_bwd_kernel, THREADS,
                                                    smem) != cudaSuccess)
    return -1;
  const int tiles = (M + BM - 1) / BM;
  return std::max(1, std::min(tiles, std::max(1, per_sm) * sms));
}

// _convffn_bwd_kernel: dy (M, C) bf16 and the gradients of inv, shift, A1,
// B1, A2, B2, summed into grads (partial_size(C, H, R) f32, laid out as one
// partial set) through partials (blocks sets, scratch).
int dp_fused_convffn_bwd(const void* y, const void* df, const void* inv, const void* shift,
                         const void* w1, const void* b1, const void* w2, const void* b2,
                         const void* a1, const void* b1l, const void* a2, const void* b2l,
                         const void* m1, const void* m2, void* dy, void* partials, void* grads,
                         int blocks, int M, int S, int C, int H, int R, float s_lora,
                         void* stream) {
  (void)b2;  // the output bias has no part in any gradient
  const size_t smem = bwd_smem_bytes(C);
  cudaError_t err = cudaFuncSetAttribute(
      convffn_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  convffn_bwd_kernel<<<blocks, THREADS, smem, st>>>(
      static_cast<const bf16*>(y), static_cast<const bf16*>(df),
      static_cast<const float*>(inv), static_cast<const float*>(shift),
      static_cast<const bf16*>(w1), static_cast<const float*>(b1),
      static_cast<const bf16*>(w2), static_cast<const bf16*>(a1),
      static_cast<const bf16*>(b1l), static_cast<const bf16*>(a2),
      static_cast<const bf16*>(b2l), static_cast<const float*>(m1),
      static_cast<const float*>(m2), static_cast<bf16*>(dy), static_cast<float*>(partials), M,
      S, C, H, R, s_lora);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int P = partial_size(C, H, R);
  convffn_bwd_reduce_kernel<<<(P + THREADS - 1) / THREADS, THREADS, 0, st>>>(
      static_cast<const float*>(partials), blocks, P, static_cast<float*>(grads));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
