// Fused ViT block kernels for Hopper (sm_90a), CUDA C++ with a plain C
// interface (loaded with ctypes by dino_pose_tpu_torch/ops/_ext.py).
//
// They replace the three Pallas kernels of the dinov2 serving path
// (dino_pose_tpu/ops/block.py): _block_kernel (:159), _attn_part_kernel
// (:999, body _attn_half_core :948) and _mlp_part_kernel (:1021). The TPU
// design holds one whole block (12 D^2 bf16 weights = 3.5 MB at D = 384) plus
// a few rows of activations in VMEM per program. Hopper gives a block at most
// 227 KB of shared memory, so each TPU kernel becomes a short chain of
// kernels here, sharing two building blocks:
//
//   gemm_kernel<LN, EPI>   C = epilogue(prologue(A) @ W), bf16 tensor-core
//                          tiles (WMMA 16x16x16, f32 accumulation).
//                          LN = LayerNorm prologue (f32 statistics, output
//                          rounded to bf16) over whole rows held in shared
//                          memory; EPI = +bias | +bias,GELU(erf) |
//                          +bias,*LayerScale,+residual.
//   attention_kernel<DH>   one (batch, head, 64-query tile) per block: K and V
//                          of all S keys for the head stay in shared memory,
//                          f32 scores and softmax, P rounded to bf16 before PV.
//
//   _attn_part_kernel = gemm<LN,BIAS>(qkv) -> attention -> gemm<-,BIAS>(out)
//   _mlp_part_kernel  = gemm<LN,GELU>(fc1) -> gemm<-,LS_RES>(fc2)
//   _block_kernel     = gemm<LN,BIAS> -> attention -> gemm<-,LS_RES>
//                       -> gemm<LN,GELU> -> gemm<-,LS_RES>
//
// Every rounding point of the JAX kernels is reproduced: each product is
// rounded to bf16, then the bias (f32 parameter rounded to bf16) is added in
// bf16; LayerScale multiplies in bf16, the residual adds in bf16.
//
// Shapes: M = B*S rows are masked at the ragged edge (no padding copy); N is a
// multiple of 64, K of 32 (the wrapper checks D % 64 == 0). Kernels launch on
// the caller's stream, allocate nothing and never synchronise; each C entry
// returns cudaGetLastError() after its launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int BM = 64, BN = 64, BK = 32;
constexpr int GEMM_THREADS = 128;  // 4 warps, each a 32x32 quarter of the tile
constexpr int PAD_H = 8;           // bf16 row padding (keeps WMMA ldm % 8 == 0)
constexpr int PAD_F = 4;           // f32 row padding
constexpr int BQ = 64;             // query rows per attention block
constexpr int ATTN_THREADS = 128;  // 4 warps, 16 query rows each

enum Epilogue { EPI_BIAS = 0, EPI_BIAS_GELU = 1, EPI_BIAS_LS_RES = 2 };

__host__ __device__ __forceinline__ size_t align128(size_t n) {
  return (n + 127) & ~static_cast<size_t>(127);
}

__device__ __forceinline__ float bf16r(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

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

size_t gemm_smem_bytes(bool ln, int K) {
  const int lda = ln ? K + PAD_H : BK + PAD_H;
  return align128(static_cast<size_t>(BM) * lda * 2) +
         align128(static_cast<size_t>(BK) * (BN + PAD_H) * 2) +
         align128(static_cast<size_t>(BM) * (BN + PAD_F) * 4);
}

// C[M,N] = epilogue(A'[M,K] @ W[K,N]); A, W, C, res row-major bf16;
// bias, ls, gamma, beta f32 vectors.
template <bool LN, int EPI>
__global__ void __launch_bounds__(GEMM_THREADS)
gemm_kernel(const bf16* __restrict__ A, const bf16* __restrict__ W,
            const float* __restrict__ bias, const float* __restrict__ ls,
            const bf16* __restrict__ res, const float* __restrict__ gamma,
            const float* __restrict__ beta, bf16* __restrict__ out,
            int M, int N, int K, float eps) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int lda = LN ? K + PAD_H : BK + PAD_H;
  constexpr int LDB = BN + PAD_H;
  constexpr int LDC = BN + PAD_F;
  bf16* As = reinterpret_cast<bf16*>(smem);
  const size_t a_bytes = align128(static_cast<size_t>(BM) * lda * 2);
  bf16* Bs = reinterpret_cast<bf16*>(smem + a_bytes);
  const size_t b_bytes = align128(static_cast<size_t>(BK) * LDB * 2);
  float* Cs = reinterpret_cast<float*>(smem + a_bytes + b_bytes);

  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  if (LN) {
    // LayerNorm prologue: whole rows into shared memory, normalised once.
    for (int r = warp; r < BM; r += GEMM_THREADS / 32) {
      const int gm = m0 + r;
      bf16* dst = As + r * lda;
      if (gm >= M) {
        for (int c = lane; c < K; c += 32) dst[c] = __float2bfloat16(0.f);
        continue;
      }
      const bf16* src = A + static_cast<size_t>(gm) * K;
      float s = 0.f;
      for (int c = lane; c < K; c += 32) {
        const float v = __bfloat162float(src[c]);
        dst[c] = src[c];
        s += v;
      }
      const float mu = warp_sum(s) / K;
      float q = 0.f;
      for (int c = lane; c < K; c += 32) {
        const float d = __bfloat162float(dst[c]) - mu;
        q += d * d;
      }
      const float rstd = rsqrtf(warp_sum(q) / K + eps);
      for (int c = lane; c < K; c += 32) {
        const float y = (__bfloat162float(dst[c]) - mu) * rstd * gamma[c] + beta[c];
        dst[c] = __float2bfloat16(y);
      }
    }
    __syncthreads();
  }

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;

  for (int k0 = 0; k0 < K; k0 += BK) {
    if (!LN) {
      for (int i = tid; i < BM * BK / 8; i += GEMM_THREADS) {
        const int r = i / (BK / 8), c = (i % (BK / 8)) * 8;
        const int gm = m0 + r;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (gm < M)
          v = *reinterpret_cast<const uint4*>(A + static_cast<size_t>(gm) * K + k0 + c);
        *reinterpret_cast<uint4*>(As + r * lda + c) = v;
      }
    }
    for (int i = tid; i < BK * BN / 8; i += GEMM_THREADS) {
      const int r = i / (BN / 8), c = (i % (BN / 8)) * 8;
      *reinterpret_cast<uint4*>(Bs + r * LDB + c) =
          *reinterpret_cast<const uint4*>(W + static_cast<size_t>(k0 + r) * N + n0 + c);
    }
    __syncthreads();
    const int acol = LN ? k0 : 0;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfr[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(af[i], As + (wm + 16 * i) * lda + acol + kk, lda);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(bfr[j], Bs + kk * LDB + wn + 16 * j, LDB);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], af[i], bfr[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm + 16 * i) * LDC + wn + 16 * j, acc[i][j], LDC,
                              wmma::mem_row_major);
  __syncthreads();

  for (int i = tid; i < BM * BN; i += GEMM_THREADS) {
    const int r = i / BN, c = i % BN;
    const int gm = m0 + r, gn = n0 + c;
    if (gm >= M) continue;
    float o = bf16r(bf16r(Cs[r * LDC + c]) + bf16r(bias[gn]));
    if (EPI == EPI_BIAS_GELU) {
      o = bf16r(o * 0.5f * (1.f + erff(o * 0.70710678118654752440f)));
    } else if (EPI == EPI_BIAS_LS_RES) {
      const float rv = __bfloat162float(res[static_cast<size_t>(gm) * N + gn]);
      o = bf16r(rv + bf16r(o * bf16r(ls[gn])));
    }
    out[static_cast<size_t>(gm) * N + gn] = __float2bfloat16(o);
  }
}

size_t attention_smem_bytes(int S, int dh) {
  const int sp = (S + 15) / 16 * 16;
  const int ldh = dh + PAD_H;
  return 2 * align128(static_cast<size_t>(sp) * ldh * 2) +
         align128(static_cast<size_t>(BQ) * ldh * 2) +
         align128(static_cast<size_t>(BQ) * (sp + PAD_F) * 4) +
         align128(static_cast<size_t>(BQ) * (sp + PAD_H) * 2);
}

// qkv: (B, S, 3D) bf16 with q|k|v on the last axis (head h at columns
// h*DH within each third); ctx: (B, S, D) bf16. Grid (ceil(S/BQ), H, B).
template <int DH>
__global__ void __launch_bounds__(ATTN_THREADS)
attention_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ ctx, int S, int H,
                 float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int sp = (S + 15) / 16 * 16;
  constexpr int LDH = DH + PAD_H;
  const int lds = sp + PAD_F;
  const int ldp = sp + PAD_H;
  size_t off = 0;
  bf16* Ks = reinterpret_cast<bf16*>(smem + off);
  off += align128(static_cast<size_t>(sp) * LDH * 2);
  bf16* Vs = reinterpret_cast<bf16*>(smem + off);
  off += align128(static_cast<size_t>(sp) * LDH * 2);
  bf16* Qs = reinterpret_cast<bf16*>(smem + off);
  off += align128(static_cast<size_t>(BQ) * LDH * 2);
  float* Ss = reinterpret_cast<float*>(smem + off);
  off += align128(static_cast<size_t>(BQ) * lds * 4);
  bf16* Ps = reinterpret_cast<bf16*>(smem + off);

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * BQ;
  const int D = H * DH, row = 3 * D;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const bf16* base = qkv + static_cast<size_t>(b) * S * row;
  constexpr int VPR = DH / 8;  // 16-byte vectors per head row
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

  for (int i = tid; i < sp * VPR; i += ATTN_THREADS) {
    const int r = i / VPR, c = (i % VPR) * 8;
    uint4 kv = zero, vv = zero;
    if (r < S) {
      const bf16* p = base + static_cast<size_t>(r) * row + h * DH + c;
      kv = *reinterpret_cast<const uint4*>(p + D);
      vv = *reinterpret_cast<const uint4*>(p + 2 * D);
    }
    *reinterpret_cast<uint4*>(Ks + r * LDH + c) = kv;
    *reinterpret_cast<uint4*>(Vs + r * LDH + c) = vv;
  }
  for (int i = tid; i < BQ * VPR; i += ATTN_THREADS) {
    const int r = i / VPR, c = (i % VPR) * 8;
    uint4 qv = zero;
    if (q0 + r < S)
      qv = *reinterpret_cast<const uint4*>(base + static_cast<size_t>(q0 + r) * row + h * DH + c);
    *reinterpret_cast<uint4*>(Qs + r * LDH + c) = qv;
  }
  __syncthreads();

  // Scores for this warp's 16 query rows against all keys (f32).
  const int wr = warp * 16;
  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> qf[DH / 16];
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk)
    wmma::load_matrix_sync(qf[kk], Qs + wr * LDH + kk * 16, LDH);
  for (int n = 0; n < sp; n += 16) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.f);
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> kf;
      wmma::load_matrix_sync(kf, Ks + n * LDH + kk * 16, LDH);
      wmma::mma_sync(acc, qf[kk], kf, acc);
    }
    wmma::store_matrix_sync(Ss + wr * lds + n, acc, lds, wmma::mem_row_major);
  }
  __syncwarp();

  // Row softmax over the S valid keys; padded keys get probability 0.
  for (int r = wr; r < wr + 16; ++r) {
    float* srow = Ss + r * lds;
    float mx = -INFINITY;
    for (int c = lane; c < S; c += 32) mx = fmaxf(mx, srow[c] * scale);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int c = lane; c < S; c += 32) {
      const float e = expf(srow[c] * scale - mx);
      srow[c] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    bf16* prow = Ps + r * ldp;
    for (int c = lane; c < sp; c += 32)
      prow[c] = __float2bfloat16(c < S ? srow[c] / sum : 0.f);
  }
  __syncwarp();

  // O = P V for this warp's rows; staged through its own score rows.
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> oacc[DH / 16];
#pragma unroll
  for (int j = 0; j < DH / 16; ++j) wmma::fill_fragment(oacc[j], 0.f);
  for (int k = 0; k < sp; k += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> pf;
    wmma::load_matrix_sync(pf, Ps + wr * ldp + k, ldp);
#pragma unroll
    for (int j = 0; j < DH / 16; ++j) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> vf;
      wmma::load_matrix_sync(vf, Vs + k * LDH + j * 16, LDH);
      wmma::mma_sync(oacc[j], pf, vf, oacc[j]);
    }
  }
  __syncwarp();
#pragma unroll
  for (int j = 0; j < DH / 16; ++j)
    wmma::store_matrix_sync(Ss + wr * lds + j * 16, oacc[j], lds, wmma::mem_row_major);
  __syncwarp();
  for (int i = lane; i < 16 * DH; i += 32) {
    const int r = i / DH, c = i % DH;
    const int q = q0 + wr + r;
    if (q < S)
      ctx[(static_cast<size_t>(b) * S + q) * D + h * DH + c] =
          __float2bfloat16(Ss[(wr + r) * lds + c]);
  }
}

template <bool LN, int EPI>
cudaError_t launch_gemm(const void* A, const void* W, const void* bias, const void* ls,
                        const void* res, const void* gamma, const void* beta, void* out,
                        int M, int N, int K, float eps, cudaStream_t stream) {
  const size_t smem = gemm_smem_bytes(LN, K);
  cudaError_t err = cudaFuncSetAttribute(gemm_kernel<LN, EPI>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid(N / BN, (M + BM - 1) / BM);
  gemm_kernel<LN, EPI><<<grid, GEMM_THREADS, smem, stream>>>(
      static_cast<const bf16*>(A), static_cast<const bf16*>(W),
      static_cast<const float*>(bias), static_cast<const float*>(ls),
      static_cast<const bf16*>(res), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<bf16*>(out), M, N, K, eps);
  return cudaGetLastError();
}

cudaError_t launch_attention(const void* qkv, void* ctx, int B, int S, int H, int dh,
                             cudaStream_t stream) {
  const size_t smem = attention_smem_bytes(S, dh);
  const float scale = 1.0f / sqrtf(static_cast<float>(dh));
  dim3 grid((S + BQ - 1) / BQ, H, B);
  cudaError_t err;
  if (dh == 64) {
    err = cudaFuncSetAttribute(attention_kernel<64>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    attention_kernel<64><<<grid, ATTN_THREADS, smem, stream>>>(
        static_cast<const bf16*>(qkv), static_cast<bf16*>(ctx), S, H, scale);
  } else if (dh == 32) {
    err = cudaFuncSetAttribute(attention_kernel<32>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    attention_kernel<32><<<grid, ATTN_THREADS, smem, stream>>>(
        static_cast<const bf16*>(qkv), static_cast<bf16*>(ctx), S, H, scale);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

cudaError_t attn_half(const void* x, const void* g1, const void* b1, const void* wqkv,
                      const void* bqkv, const void* wo, const void* bo, const void* ls1,
                      void* qkv, void* ctx, void* out, int B, int S, int D, int H, float eps,
                      cudaStream_t st) {
  const int M = B * S;
  cudaError_t err = launch_gemm<true, EPI_BIAS>(x, wqkv, bqkv, nullptr, nullptr, g1, b1, qkv,
                                                M, 3 * D, D, eps, st);
  if (err != cudaSuccess) return err;
  err = launch_attention(qkv, ctx, B, S, H, D / H, st);
  if (err != cudaSuccess) return err;
  if (ls1 == nullptr)
    return launch_gemm<false, EPI_BIAS>(ctx, wo, bo, nullptr, nullptr, nullptr, nullptr, out,
                                        M, D, D, eps, st);
  return launch_gemm<false, EPI_BIAS_LS_RES>(ctx, wo, bo, ls1, x, nullptr, nullptr, out, M,
                                             D, D, eps, st);
}

cudaError_t mlp_half(const void* x2, const void* g2, const void* b2, const void* w1,
                     const void* bf1, const void* w2, const void* bf2, const void* ls2,
                     void* hbuf, void* y, int M, int D, int hidden, float eps,
                     cudaStream_t st) {
  cudaError_t err = launch_gemm<true, EPI_BIAS_GELU>(x2, w1, bf1, nullptr, nullptr, g2, b2,
                                                     hbuf, M, hidden, D, eps, st);
  if (err != cudaSuccess) return err;
  return launch_gemm<false, EPI_BIAS_LS_RES>(hbuf, w2, bf2, ls2, x2, nullptr, nullptr, y, M, D,
                                             hidden, eps, st);
}

}  // namespace

extern "C" {

// Shared-memory bytes the kernels ask for, so the wrapper can refuse shapes
// the card cannot hold before launching.
long long dp_gemm_smem_bytes(int ln, int K) { return (long long)gemm_smem_bytes(ln != 0, K); }
long long dp_attention_smem_bytes(int S, int dh) { return (long long)attention_smem_bytes(S, dh); }

// _block_kernel: y = x2 + ls2*MLP(LN2(x2)), x2 = x + ls1*(Wo MHA(LN1(x)) + bo).
int dp_fused_block(const void* x, const void* g1, const void* b1, const void* wqkv,
                   const void* bqkv, const void* wo, const void* bo, const void* ls1,
                   const void* g2, const void* b2, const void* w1, const void* bf1,
                   const void* w2, const void* bf2, const void* ls2, void* qkv, void* ctx,
                   void* x2, void* hbuf, void* y, int B, int S, int D, int H, int hidden,
                   float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = attn_half(x, g1, b1, wqkv, bqkv, wo, bo, ls1, qkv, ctx, x2, B, S, D, H,
                              eps, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      mlp_half(x2, g2, b2, w1, bf1, w2, bf2, ls2, hbuf, y, B * S, D, hidden, eps, st));
}

// _attn_part_kernel: o = Wo MHA(LN1(x) Wqkv + bqkv) + bo (no LayerScale).
int dp_fused_attn_part(const void* x, const void* g1, const void* b1, const void* wqkv,
                       const void* bqkv, const void* wo, const void* bo, void* qkv, void* ctx,
                       void* out, int B, int S, int D, int H, float eps, void* stream) {
  return static_cast<int>(attn_half(x, g1, b1, wqkv, bqkv, wo, bo, nullptr, qkv, ctx, out, B,
                                    S, D, H, eps, static_cast<cudaStream_t>(stream)));
}

// _mlp_part_kernel: y = x2 + ls2*(W2 gelu(W1 LN2(x2) + bf1) + bf2).
int dp_fused_mlp_part(const void* x2, const void* g2, const void* b2, const void* w1,
                      const void* bf1, const void* w2, const void* bf2, const void* ls2,
                      void* hbuf, void* y, int M, int D, int hidden, float eps, void* stream) {
  return static_cast<int>(mlp_half(x2, g2, b2, w1, bf1, w2, bf2, ls2, hbuf, y, M, D, hidden,
                                   eps, static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
