// Fused ViT block kernels for Hopper (sm_90a), CUDA C++ with a plain C
// interface (loaded with ctypes by dino_pose_tpu_torch/ops/_ext.py).
//
// They replace the seventeen Pallas kernels of the dinov2 fine-tuning paths
// (dino_pose_tpu/ops/block.py): _block_kernel (:159, also in its training
// form with the residual x2, :592), _attn_part_kernel (:999, body
// _attn_half_core :948), _mlp_part_kernel (:1021), the LoRA layer's backward
// _mlp_dx_kernel (:1044) and its weight-streamed twin _mlp_stream_dx_kernel
// (:1663, the same function), the trainable block's backward _mlp_bwd_kernel
// (:284) and _attn_bwd_kernel (:334), dinov2-large's weight-streamed
// halves _attn_stream_kernel (:1807) and _mlp_stream_kernel (:1636), which
// differ from the resident ones only in their output epilogue (f32 bias),
// and the trainable streamed halves of dinov2-base and -large:
// _mlp_stream_train_kernel (:1695, the MLP half that also saves h2), the
// MLP backward pair _mlp_stream_dx_full_kernel (:1726) + _mlp_stream_dw_kernel
// (:1770) and the attention backward pair _attn_stream_dx_kernel (:1924) +
// _attn_stream_dw_kernel (:1973), which reuse the resident backward chains,
// and one tensor-parallel shard's halves: _attn_part_partial_kernel (:1010)
// and _mlp_part_partial_kernel (:1062), the resident chains on the shard's
// Megatron slice ending in a product with no bias, and the LoRA layer's
// _mlp_partial_dx_kernel (:1099), the dx chain with no LayerScale prologue
// and no residual.
// The TPU design holds one whole block
// (12 D^2 bf16 weights = 3.5 MB at D = 384) plus a few rows of activations
// in VMEM per program. Hopper gives a block at most 227 KB of shared memory,
// so each TPU kernel becomes a short chain of kernels here, sharing these
// building blocks:
//
//   gemm_kernel<WG, TN, EPI>  C = epilogue(A @ W) for every forward product
//                          (and the backward's recomputed ones): wgmma
//                          m64nTNk16 (bf16 in, f32 accumulators in registers)
//                          on 128-byte-swizzled tiles that one producer
//                          thread loads by TMA into a 4-deep mbarrier ring,
//                          outputs staged in shared memory and written by
//                          TMA stores, persistent blocks, tiles of 128 x 128
//                          (two consumer warpgroups) where they fill the 132
//                          SMs, else 64 x 128 or 64 x 64 (one). EPI = +bias |
//                          +bias,GELU(erf) | +bias,*LayerScale,+residual |
//                          +bias with both the pre-activation and its GELU
//                          written out | f32 +bias | f32 +bias,*LayerScale,
//                          then +residual (also writing h2) | none. What
//                          bounds it at B = 128 is the tensor cores (D = 768:
//                          2*M*768*1536 FLOPs against 2*M*(768+1536) bytes,
//                          512 FLOPs a byte, over the card's ~295); the
//                          ring keeps them fed and the swizzle keeps wgmma's
//                          shared-memory reads free of bank conflicts.
//   gemm_nt_kernel<WG, TN, EPI>  the backward's dx products on the same
//                          design, C = epilogue(A @ W^T) with W a forward
//                          weight read as it is stored (both operands
//                          K-major): *gelu'(h) with h's tile loaded by TMA,
//                          f32 or bf16 outputs, optional f32 column sums a
//                          64-row slice.
//   gemm_tn_kernel<WG, TN>  the weight-gradient product dW = A^T @ G on the
//                          same design, reducing over the M = B*S rows with
//                          both operands MN-major (wgmma's transpose bits):
//                          M is split into 64-row-aligned ranges whose f32
//                          partials sum_rows_kernel adds in a fixed order,
//                          or written as dW where one split fills the card;
//                          optional column sums of G from the staged tiles.
//   scale_rows_kernel      bf16(a * scale[k]): the chains' scaled cotangents,
//                          formed once for the two products that read them.
//   attn_fwd_kernel<DH, NK16>  the attention step: K and V of all S keys for
//                          a head in shared memory, a 64-query tile's whole
//                          rows of f32 scores in registers (wgmma), the exact
//                          softmax there, P rounded to bf16 and fed from
//                          registers to the PV wgmma.
//   attn_bwd_dq_kernel<DH, NK16>, attn_bwd_dkv_kernel<DH>  its backward on
//                          the same design, FlashAttention-2 style: per query
//                          tile dq and the softmax statistics (dP once a
//                          tile), then per key tile dk and dv.
//   The resident route takes S up to 320 forward and 304 backward (dh =
//   64). Past that the attention step of every chain launches the streamed
//   kernels of flash_kernels.cu instead (dp_flash::launch_fwd / launch_bwd): a choice
//   between hand-written kernels by shape, made in attn_half and
//   dp_fused_attn_bwd (a backward that streams recomputes its forward
//   streamed too, for the row statistics it reads).
//   ln_rows_kernel         LayerNorm forward, one warp per row.
//   ln_bwd_rows_kernel<SUMS>  LayerNorm backward, one warp per row, with
//                          optional per-block column sums for the vector
//                          gradients.
//
//   Every chain whose TPU kernel normalises its input first launches
//   ln_rows once into a bf16 (M, D) buffer and then the GEMM (the old WMMA
//   GEMM held 64 whole rows in shared memory and normalised them again in
//   each of the N/64 column blocks: 99 KB at D = 768, one block an SM):
//
//   _attn_part_kernel = ln_rows -> gemm<BIAS>(qkv) -> attention -> gemm<BIAS>(out)
//   _mlp_part_kernel  = ln_rows -> gemm<GELU>(fc1) -> gemm<LS_RES>(fc2)
//   _attn_stream_kernel = ln_rows -> gemm<BIAS>(qkv) -> attention -> gemm<F32BIAS>(out)
//   _mlp_stream_kernel  = ln_rows -> gemm<GELU>(fc1) -> gemm<F32BIAS_LS_RES>(fc2)
//   _block_kernel     = ln_rows -> gemm<BIAS> -> attention -> gemm<LS_RES>
//                       -> ln_rows -> gemm<GELU> -> gemm<LS_RES>
//   _mlp_dx_kernel    = ln_rows -> gemm<BIAS>(h1) -> scale_rows(dy*ls2)
//                       -> gemm_nt<*gelu'(h1)>(dh1b) -> gemm_nt<f32>(dm)
//                       -> ln_bwd_rows(dx2)
//   _mlp_bwd_kernel   = ln_rows(m) -> gemm<BIAS,GELU pair>(h1, g)
//                       -> gemm<BIAS>(h2) -> scale_rows(dy*ls2)
//                       -> gemm_nt<*gelu'(h1),sums>(dh1b, dbf1)
//                       -> gemm_tn(dW2 = g^T bf16(dy*ls2)) -> gemm_nt<f32>(dm)
//                       -> ln_bwd_rows<sums>(dx2, dbf2, dls2, dg2, db2)
//                       -> gemm_tn(dW1 = m^T dh1b)
//   _attn_bwd_kernel  = ln_rows(a) -> gemm<BIAS>(qkv) -> attention(ctx)
//                       -> gemm<BIAS>(o) -> scale_rows(dx2*ls1)
//                       -> gemm_nt<bf16>(dctx) -> gemm_tn(dWo = ctx^T
//                       bf16(dx2*ls1)) -> attn_bwd_dq -> attn_bwd_dkv (dqkv)
//                       -> gemm_nt<f32>(da) -> ln_bwd_rows<sums>(dx, dbo,
//                       dls1, dg1, db1) -> gemm_tn<colsums>(dWqkv, dbqkv)
//   _mlp_stream_train_kernel = ln_rows -> gemm<GELU>(fc1)
//                       -> gemm<F32BIAS_LS_RES_H2>(fc2, h2)
//   _mlp_stream_dx_full_kernel + _mlp_stream_dw_kernel = _mlp_bwd_kernel's
//                       chain without the h2 GEMM (h2 saved by the forward),
//                       ln_bwd_rows<sums, UNSCALED> (dbf2 = ls2 * sum(dy))
//   _attn_stream_dx_kernel + _attn_stream_dw_kernel = _attn_bwd_kernel's chain
//                       without the o GEMM and the scaling, on do
//                       (pre-LayerScale): gemm_nt<bf16>(dctx) -> gemm_tn(dWo
//                       = ctx^T do) ... ln_bwd_rows<sums, NO_RES>(dx, dbo =
//                       sum(do), dg1, db1) ...
//   _attn_part_partial_kernel = ln_rows -> gemm<BIAS>(qkv_l, N = 3D/tp)
//                       -> attention (H/tp heads) -> gemm<NONE>(out, K = D/tp)
//   _mlp_part_partial_kernel  = ln_rows -> gemm<GELU>(fc1, N = 4D/tp)
//                       -> gemm<NONE>(fc2)
//   _mlp_partial_dx_kernel    = ln_rows -> gemm<BIAS>(h1) -> gemm_nt<
//                       *gelu'(h1)>(dh1b) -> gemm_nt<f32>(dm)
//                       -> ln_bwd_rows<NO_RES>(dx2)
//
//   The forward halves put the normalised rows in their own output buffer
//   (the attention half's out, the MLP half's y), and the dx chains in dm's
//   f32 buffer: each is dead until a later launch of the chain overwrites
//   it, so the split costs no allocation. ln_rows_kernel is the old
//   prologue's arithmetic, so the GEMMs read the same bf16 rows as before.
//   The scaled cotangents go the same way, into the f32 buffer (dm, da)
//   that the chain's last dx product overwrites; the product that needs
//   them last (dW2, dWo) runs before that.
//
// Every rounding point of the JAX kernels is reproduced: each product is
// rounded to bf16, then the bias (f32 parameter rounded to bf16) is added in
// bf16; LayerScale multiplies in bf16, the residual adds in bf16. In the
// backward, dy*ls2 and dh1b are rounded to bf16, the products dg and dm stay
// f32, dx2 is rounded once. dm goes through device memory as f32 (B*S*D*4
// bytes, 50 MB at batch 128) to a row kernel rather than into a GEMM
// epilogue: the LayerNorm backward needs whole rows, and a 128-column tile holds
// a third of one. The dx chain is bound by its three products (0.909 GFLOP
// per image at S = 257, D = 384: 0.118 ms at batch 128 on an H100) from
// batch 2 up. The trainable block's backward keeps JAX's rounding points
// too: dh1, dy*ls2 and dx2*ls1 enter their bias sums unrounded, the bf16
// dqkv enters dbqkv, the probabilities stay f32 for dS; the residuals h1, g,
// h2, qkv, P, ctx and o are recomputed from (x, x2), as JAX saves nothing
// else. Weight gradients are sums over all B*S rows that the TPU kernel
// carries across its sequential batch grid; a CUDA grid has no order, so
// each range of rows writes f32 partials and one pass adds them in a fixed
// order (no atomics: two runs give the same bits).
//
// Shapes: M = B*S rows are masked at the ragged edge (no padding copy: TMA
// reads the rows and the K tail past the edge as zeros, the stores are
// masked); N is a multiple of 64, K of 32 (the wrapper checks D % 64 == 0).
// The GEMMs' TMA tensor maps are encoded on the host at each launch with
// cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPointByVersion,
// so the library links without -lcuda. Kernels launch on the caller's
// stream, allocate nothing and never synchronise; each C entry returns
// cudaGetLastError() after its launches.

#include <cuda_bf16.h>
#include <cuda.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_kernels.cuh"
#include "hopper.cuh"

typedef __nv_bfloat16 bf16;

namespace {

using namespace dp_hopper;

constexpr int ROW_THREADS = 128;   // 4 warps, one row each (LayerNorm rows)
constexpr int SUM_ROWS = 64;       // rows per block of the column-summing row kernel
constexpr int NSUMS = 4;           // column sums of ln_bwd_rows_kernel<true>


// EPI_BIAS* round the product to bf16 and add the bf16-rounded bias in bf16
// (the resident TPU kernels); EPI_F32BIAS* add the bias to the f32 sum
// before one rounding (the weight-streamed ones, dinov2-large); EPI_NONE
// rounds the product and adds nothing (a tensor-parallel shard's partial
// product, whose bias is added once after the all-reduce).
enum Epilogue {
  EPI_BIAS = 0, EPI_BIAS_GELU = 1, EPI_BIAS_LS_RES = 2, EPI_BIAS_GELU_PAIR = 3,
  EPI_F32BIAS = 4, EPI_F32BIAS_LS_RES = 5, EPI_F32BIAS_LS_RES_H2 = 6, EPI_NONE = 7
};
enum EpilogueNT { EPT_GELU_GRAD = 0, EPT_F32 = 1, EPT_BF16 = 2 };
// What ln_bwd_rows_kernel adds and sums besides the LayerNorm backward:
// ROWS_RESIDENT dx = dres + LN^T(dm), sums (dres*ls, dres*aux, ..) (the
// resident backward kernels); ROWS_UNSCALED the same with sums (dres,
// dres*aux, ..) (the streamed MLP backward, whose dbf2 = ls2 * sum(dy));
// ROWS_NO_RES dx = LN^T(dm) with sums (dres, 0, ..) (the streamed attention
// backward: dres = do adds nothing to dx, and its sum is dbo).
enum RowsMode { ROWS_RESIDENT = 0, ROWS_UNSCALED = 1, ROWS_NO_RES = 2 };

__device__ __forceinline__ float bf16r(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ---------------------------------------------------------------------------
// The three GEMM kernels share one design, warp-specialised for sm_90a:
// warpgroup WG (the last) is the producer, one thread of it issuing the TMA
// loads of each stage's A and B tiles into a GSTAGES-deep ring of
// 128-byte-swizzled tiles guarded by mbarriers; warpgroups 0..WG-1 are the
// consumers, each issuing wgmma.mma_async m64nTNk16 on its 64 rows of the
// tile with f32 accumulators in registers, then an epilogue from those
// registers into swizzled shared memory, which TMA stores write out while
// the next tile's products run. Blocks are persistent: each walks output
// tiles while the producer runs ahead into the next tile's stages. TM =
// 64*WG. They differ in how the operands lie in memory, which only changes
// the TMA boxes and the wgmma descriptors (a K-major operand has the
// reduction axis contiguous, an MN-major one the output axis):
//
//   gemm_kernel<WG, TN, EPI>   C = epi(A[M,K] @ W[K,N])      A K-major, W MN-major
//   gemm_nt_kernel<WG, TN, EPI> C = epi(A[M,K] @ W[N,K]^T)   both K-major
//   gemm_tn_kernel<WG, TN>     dW = A[M,Kin]^T @ G[M,N]       both MN-major
//
// gemm_nt reads a forward weight stored (N, K) as it is, and gemm_tn the
// activations and cotangents as they are: no operand is ever transposed or
// copied. What bounds them at B = 128 is the tensor cores (D = 1024: 2*M*
// 1024*4096 FLOPs against 2*M*(1024+4096) bytes, ~800 FLOPs a byte, over
// the card's ~295); the ring keeps them fed and the swizzle keeps wgmma's
// shared-memory reads free of bank conflicts.
// ---------------------------------------------------------------------------

constexpr int GK = 64;           // K depth of a stage: one 128-byte swizzled bf16 row
constexpr int GSTAGES = 4;       // ring depth
constexpr int WG_THREADS = 128;  // a warpgroup

// EPI_BIAS_GELU_PAIR and EPI_F32BIAS_LS_RES_H2 write a second output.
__host__ __device__ constexpr bool two_outputs(int epi) {
  return epi == EPI_BIAS_GELU_PAIR || epi == EPI_F32BIAS_LS_RES_H2;
}

// The ring of a (WG, TN) tile: stage s holds the A tile (TM x GK, or for
// gemm_tn WG boxes of GK rows x 64) then the B tile (GK x TN).
template <int WG, int TN>
struct RingPlan {
  static constexpr int TM = 64 * WG;
  static constexpr int A_BYTES = TM * GK * 2;
  static constexpr int B_BYTES = GK * TN * 2;
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr int THREADS = (WG + 1) * WG_THREADS;
  static constexpr size_t RING = static_cast<size_t>(GSTAGES) * STAGE_BYTES;
};

// gemm_kernel: each consumer warpgroup stages its 64 x TN output (and the
// second one) in TN/64 swizzled 64 x 64 boxes for the TMA stores. Then
// 2*GSTAGES mbarriers, and slack to align the ring to the 1024 bytes a
// 128-byte swizzle pattern repeats over.
template <int WG, int TN, int EPI>
struct GemmPlan : RingPlan<WG, TN> {
  static constexpr int OUT_BYTES = 64 * TN * 2;
  static constexpr int OUTS = two_outputs(EPI) ? 2 : 1;
  static constexpr size_t SMEM =
      RingPlan<WG, TN>::RING + static_cast<size_t>(WG) * OUTS * OUT_BYTES + 2 * GSTAGES * 8 + 1024;
};

// gemm_nt_kernel: per consumer warpgroup the output staging (bf16 64-column
// or f32 32-column boxes), the aux tile of EPT_GELU_GRAD (h1, loaded by TMA
// beside the main loop) and, with SUMS, four warps' column sums; then the
// ring's barriers and one aux barrier a warpgroup.
template <int WG, int TN, int EPI, bool SUMS>
struct NtPlan : RingPlan<WG, TN> {
  static constexpr int OUT_BYTES = 64 * TN * (EPI == EPT_F32 ? 4 : 2);
  static constexpr int AUX_BYTES = EPI == EPT_GELU_GRAD ? 64 * TN * 2 : 0;
  static constexpr int RED_BYTES = SUMS ? 4 * TN * 4 : 0;
  static constexpr size_t SMEM = RingPlan<WG, TN>::RING +
                                 static_cast<size_t>(WG) * (OUT_BYTES + AUX_BYTES + RED_BYTES) +
                                 (2 * GSTAGES + WG) * 8 + 1024;
};

// gemm_tn_kernel: per consumer warpgroup its 64 x TN f32 output in 32-column
// boxes.
template <int WG, int TN>
struct TnPlan : RingPlan<WG, TN> {
  static constexpr int OUT_BYTES = 64 * TN * 4;
  static constexpr size_t SMEM =
      RingPlan<WG, TN>::RING + static_cast<size_t>(WG) * OUT_BYTES + 2 * GSTAGES * 8 + 1024;
};

// The ring's position, as the producer and each consumer walk it.
struct RingPos {
  int stage = 0;
  uint32_t phase = 0;
  __device__ __forceinline__ void next() {
    if (++stage == GSTAGES) {
      stage = 0;
      phase ^= 1;
    }
  }
};

// The producer's side of the ring for one tile: for each of its ktiles
// stages, wait until the slot is empty, expect its bytes on the slot's full
// barrier and issue its loads (load(slot address, barrier, kt)). bars holds
// full[s], then empty[s].
template <int STAGE_BYTES, typename Load>
__device__ __forceinline__ void produce_tile(uint32_t base, uint32_t bars, int ktiles, RingPos& pos,
                                             Load load) {
  for (int kt = 0; kt < ktiles; ++kt) {
    const uint32_t full = bars + 8 * pos.stage;
    mbar_wait(bars + 8 * (GSTAGES + pos.stage), pos.phase ^ 1);
    mbar_expect_tx(full, STAGE_BYTES);
    load(base + pos.stage * STAGE_BYTES, full, kt);
    pos.next();
  }
}

// The consumers' side for one tile: warpgroup wg waits for each stage,
// issues its GK/16 wgmma steps on its 64 rows (acc += A B), and releases
// the stage one step later, once the next stage's products are issued and
// these retired. on_stage(B tile address) runs after a stage's products are
// issued and before the stage is released.
template <int TN, bool A_MN, bool B_MN, int A_BYTES, int STAGE_BYTES, typename OnStage>
__device__ __forceinline__ void consume_tile(float* acc, uint32_t base, uint32_t bars, int wg,
                                             bool signal, int ktiles, RingPos& pos,
                                             OnStage on_stage) {
  constexpr int R = TN / 2;  // accumulators a thread
  int prev = -1;
  for (int kt = 0; kt < ktiles; ++kt) {
    mbar_wait(bars + 8 * pos.stage, pos.phase);
    const uint32_t sa = base + pos.stage * STAGE_BYTES + wg * BOX_BYTES;
    const uint32_t sb = base + pos.stage * STAGE_BYTES + A_BYTES;
    const uint64_t da = operand_desc<A_MN>(sa), db = operand_desc<B_MN>(sb);
    fence_acc<R>(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < GK / 16; ++kk)
      wgmma_tile<TN, A_MN, B_MN>(acc, da + kk * k16_step<A_MN>(), db + kk * k16_step<B_MN>());
    wgmma_commit();
    on_stage(sb);
    fence_acc<R>(acc);
    wgmma_wait<1>();  // the previous stage's products are done: release it
    if (prev >= 0 && signal) mbar_arrive(bars + 8 * (GSTAGES + prev));
    prev = pos.stage;
    pos.next();
  }
  wgmma_wait<0>();
  fence_acc<R>(acc);
  if (prev >= 0 && signal) mbar_arrive(bars + 8 * (GSTAGES + prev));
}

// Initialise the ring's barriers (full: the producer's expect_tx; empty: one
// arrival per consumer warpgroup) and `extra` more of count 1 after them.
__device__ __forceinline__ void init_ring(uint32_t bars, int consumers, int extra) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < GSTAGES; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (GSTAGES + s), consumers);
    }
    for (int e = 0; e < extra; ++e) mbar_init(bars + 8 * (2 * GSTAGES + e), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// Accumulator i of a consumer thread is row 16*wq + lane/4 + 8*((i/2)%2),
// column 8*(i/4) + 2*(lane%4) + i%2 of its warpgroup's 64 x TN slice. The
// staging offsets of the pair (j, h) = accumulators 4j + 2h and 4j + 2h + 1,
// row r = 16*wq + lane/4 + 8h, in the tensor maps' 128-byte swizzle (16-byte
// chunk c of row r at chunk c ^ (r % 8), so a warp's eight rows hit
// distinct banks): bf16 in 64-column boxes, f32 in 32-column boxes.
__device__ __forceinline__ uint32_t stage_bf16(int j, int r, int lane) {
  return (j / 8) * BOX_BYTES + r * 128 + (((j % 8) ^ (r % 8)) * 16) + (lane & 3) * 4;
}
__device__ __forceinline__ uint32_t stage_f32(int j, int r, int lane) {
  return (j / 4) * BOX_BYTES + r * 128 + ((((j % 4) * 2 + ((lane & 3) >> 1)) ^ (r % 8)) * 16) +
         (lane & 1) * 8;
}

// One thread's two adjacent outputs (columns gn and gn + 1 of element idx's
// row) through the epilogue, as bf16 pairs: out in o, the second output in
// o2. The rounding points of the TPU kernels: EPI_BIAS* round the product,
// add the bf16 bias in bf16, then GELU (f32, one rounding) or *bf16(ls)
// and +res, each rounded. A row past M (in_rows false) reads no residual.
template <int EPI>
__device__ __forceinline__ void gemm_pair(float a0, float a1, bool in_rows, size_t idx, int gn,
                                          const float* __restrict__ bias,
                                          const float* __restrict__ ls,
                                          const bf16* __restrict__ res, uint32_t* o,
                                          uint32_t* o2) {
  constexpr bool F32 = EPI == EPI_F32BIAS || EPI == EPI_F32BIAS_LS_RES || EPI == EPI_F32BIAS_LS_RES_H2;
  constexpr bool RES = EPI == EPI_BIAS_LS_RES || EPI == EPI_F32BIAS_LS_RES || EPI == EPI_F32BIAS_LS_RES_H2;
  float v[2] = {a0, a1}, v2[2] = {0.f, 0.f}, rv[2] = {0.f, 0.f};
  if (RES && in_rows) {
    const __nv_bfloat162 r = *reinterpret_cast<const __nv_bfloat162*>(res + idx);
    rv[0] = __low2float(r);
    rv[1] = __high2float(r);
  }
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    if (EPI == EPI_NONE) continue;
    if (F32) {
      float x = v[c] + bias[gn + c];
      if (EPI == EPI_F32BIAS_LS_RES_H2) v2[c] = x;
      if (EPI != EPI_F32BIAS) x = bf16r(rv[c] + bf16r(x * ls[gn + c]));
      v[c] = x;
      continue;
    }
    float x = bf16r(bf16r(v[c]) + bf16r(bias[gn + c]));
    if (EPI == EPI_BIAS_GELU || EPI == EPI_BIAS_GELU_PAIR) {
      const float gl = bf16r(x * 0.5f * (1.f + erff(x * 0.70710678118654752440f)));
      if (EPI == EPI_BIAS_GELU_PAIR)
        v2[c] = gl;
      else
        x = gl;
    } else if (EPI == EPI_BIAS_LS_RES) {
      x = bf16r(rv[c] + bf16r(x * bf16r(ls[gn + c])));
    }
    v[c] = x;
  }
  __nv_bfloat162 p = __floats2bfloat162_rn(v[0], v[1]), p2 = __floats2bfloat162_rn(v2[0], v2[1]);
  *o = *reinterpret_cast<uint32_t*>(&p);
  *o2 = *reinterpret_cast<uint32_t*>(&p2);
}

// gemm_kernel<WG, TN, EPI>: C[M,N] = epilogue(A[M,K] @ W[K,N]), A, W, C, res
// row-major bf16, bias and ls f32 vectors: every forward product of the
// chains. A is loaded K-major (TM x 64 boxes), W as it is stored, N-major
// (64 x 64 boxes). Tiles walk row-block major, so a row block's A stays in
// L2 across its column blocks.
// EPI_BIAS_GELU_PAIR writes the biased product h to out and gelu(h) to out2.
// EPI_F32BIAS: bf16(acc + bias); EPI_F32BIAS_LS_RES: bf16(res + bf16((acc +
// bias) * ls)), in f32 up to the inner rounding; EPI_F32BIAS_LS_RES_H2 also
// writes h2 = bf16(acc + bias) to out2 (the pre-LayerScale output that
// _mlp_stream_train_kernel saves). EPI_NONE: bf16(acc); bias, ls and res are
// not read.
template <int WG, int TN, int EPI>
__global__ void __launch_bounds__((WG + 1) * WG_THREADS, 1)
gemm_kernel(const __grid_constant__ CUtensorMap tma_a, const __grid_constant__ CUtensorMap tma_w,
            const __grid_constant__ CUtensorMap tma_out,
            const __grid_constant__ CUtensorMap tma_out2, const float* __restrict__ bias,
            const float* __restrict__ ls, const bf16* __restrict__ res, int M, int N, int K) {
  using P = GemmPlan<WG, TN, EPI>;
  constexpr bool TWO = two_outputs(EPI);
  extern __shared__ unsigned char gemm_smem[];
  // The ring starts at the first 1024-byte boundary; then each consumer
  // warpgroup's staging buffers (out, then out2); then the barriers.
  const uint32_t base = (smem_addr(gemm_smem) + 1023u) & ~1023u;
  const uint32_t staging = base + P::RING;
  const uint32_t bars = staging + WG * P::OUTS * P::OUT_BYTES;
  const int wg = threadIdx.x / WG_THREADS;
  const int tiles_n = N / TN;
  const int tiles = (M + P::TM - 1) / P::TM * tiles_n;
  const int ktiles = (K + GK - 1) / GK;
  init_ring(bars, WG, 0);

  if (wg == WG) {
    // Producer: one thread keeps the ring full across all of this block's
    // tiles. In the 128 x 128 plan (384 threads, 168 registers a thread at
    // entry) its warpgroup hands registers to the two consumers, which hold
    // 64 accumulators each; a 256-thread block already leaves its one
    // consumer enough.
    if (WG > 1) asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == WG * WG_THREADS) {
      RingPos pos;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int m0 = t / tiles_n * P::TM, n0 = t % tiles_n * TN;
        produce_tile<P::STAGE_BYTES>(base, bars, ktiles, pos, [&](uint32_t sa, uint32_t full, int kt) {
          tma_load(sa, &tma_a, full, kt * GK, m0);
#pragma unroll
          for (int h = 0; h < TN / 64; ++h)
            tma_load(sa + P::A_BYTES + h * BOX_BYTES, &tma_w, full, n0 + 64 * h, kt * GK);
        });
      }
    }
  } else {
    // Consumers: warpgroup wg owns rows [64*wg, 64*wg + 64) of each tile.
    if (WG > 1) asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    float acc[TN / 2];
    const int lane = threadIdx.x & 31, wq = (threadIdx.x >> 5) & 3;
    const bool signal = (threadIdx.x & (WG_THREADS - 1)) == 0;
    const uint32_t out_s = staging + wg * P::OUTS * P::OUT_BYTES, out2_s = out_s + P::OUT_BYTES;
    RingPos pos;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int m0 = t / tiles_n * P::TM, n0 = t % tiles_n * TN;
#pragma unroll
      for (int i = 0; i < TN / 2; ++i) acc[i] = 0.f;
      consume_tile<TN, false, true, P::A_BYTES, P::STAGE_BYTES>(acc, base, bars, wg, signal, ktiles,
                                                                 pos, [](uint32_t) {});
      // Epilogue into the staging buffers, then one thread stores the slice
      // by TMA, which overlaps the next tile's main loop. Direct 4-byte
      // stores in the accumulator layout cost as much as the products at
      // K = 384.
      if (signal) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      warpgroup_sync(1 + wg);  // the previous tile's stores have read the buffers
      const int row = wq * 16 + (lane >> 2);
      const int col = n0 + 2 * (lane & 3);
#pragma unroll
      for (int j = 0; j < TN / 8; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = row + 8 * h, gm = m0 + wg * 64 + r;
          uint32_t o, o2;
          gemm_pair<EPI>(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1], gm < M,
                         static_cast<size_t>(gm) * N + col + 8 * j, col + 8 * j, bias, ls, res,
                         &o, &o2);
          st_shared(out_s + stage_bf16(j, r, lane), o);
          if (TWO) st_shared(out2_s + stage_bf16(j, r, lane), o2);
        }
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      warpgroup_sync(1 + wg);
      if (signal) {
#pragma unroll
        for (int h = 0; h < TN / 64; ++h) {
          tma_store(&tma_out, out_s + h * BOX_BYTES, n0 + 64 * h, m0 + wg * 64);
          if (TWO) tma_store(&tma_out2, out2_s + h * BOX_BYTES, n0 + 64 * h, m0 + wg * 64);
        }
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      }
    }
    if (signal) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  }
}

// d/dz GELU(z) = Phi(z) + z phi(z), the backward epilogue's f32 factor:
// erf as XLA's f32 rational approximation (x P(x^2) / Q(x^2), x clamped to
// [-4, 4], the erf JAX's compiler emits), exp(-z^2/2) by ex2.approx: two
// special-function operations an element, fewer than erff and expf take
// (tests/test_torch_gemm_bwd.py holds the formula against the exact
// derivative at every bf16 z). The product is rounded to bf16 after it.
__device__ __forceinline__ float gelu_grad(float z) {
  const float x = fminf(fmaxf(z * 0.70710678118654752440f, -4.f), 4.f);
  const float x2 = x * x;
  float p = -2.72614225801306e-10f;
  p = fmaf(p, x2, 2.77068142495902e-08f);
  p = fmaf(p, x2, -2.10102402082508e-06f);
  p = fmaf(p, x2, -5.69250639462346e-05f);
  p = fmaf(p, x2, -7.34990630326855e-04f);
  p = fmaf(p, x2, -2.95459980854025e-03f);
  p = fmaf(p, x2, -1.60960333262415e-02f);
  float q = -1.45660718464996e-05f;
  q = fmaf(q, x2, -2.13374055278905e-04f);
  q = fmaf(q, x2, -1.68282697438203e-03f);
  q = fmaf(q, x2, -7.37332916720468e-03f);
  q = fmaf(q, x2, -1.42647390514189e-02f);
  return 0.5f * (1.f + __fdividef(x * p, q)) + z * __expf(-0.5f * z * z) * 0.3989422804014327f;
}

// One round of the column sums' reduce-scatter: of its 2*HALF sums a lane
// keeps the upper half where `hi`, else the lower, and adds its partner's
// (lane ^ mask) copy of them into slots 0..HALF-1. A template, so that every
// index is a constant and the sums stay in registers.
template <int HALF>
__device__ __forceinline__ void fold_sums(float* cs, bool hi, int mask) {
#pragma unroll
  for (int i = 0; i < HALF; ++i) {
    const float send = hi ? cs[i] : cs[i + HALF];
    const float keep = hi ? cs[i + HALF] : cs[i];
    cs[i] = keep + __shfl_xor_sync(0xffffffffu, send, mask);
  }
}

// gemm_nt_kernel<WG, TN, EPI>: C[M,N] = epilogue(A[M,K] @ W[N,K]^T), the
// dx products of the backward chains: W is a forward weight stored (in,
// out) = row-major (N, K), so both operands are K-major, wgmma's native
// layout (W in TN x 64 boxes). EPT_GELU_GRAD: out bf16 = bf16(acc *
// gelu'(f32 aux[m, n])), aux bf16 (M, N), its tile loaded by TMA into shared
// memory at the start of each tile while the main loop runs; EPT_F32: out
// f32 = acc, staged and stored as f32 boxes; EPT_BF16: out bf16 = bf16(acc).
// With SUMS, each consumer warpgroup also writes the f32 column sums of
// its 64 rows' epilogue values before rounding, rows past M left out, to
// colsum[(m0 + 64*wg) / 64][n], (ceil(M/64), N): each thread adds its two
// rows of each column, the eight lanes of a warp that share columns add
// theirs by a reduce-scatter butterfly (each of three shuffle rounds keeps
// half the columns: 28 shuffles a thread for 32 sums), the four warps
// theirs in shared memory in order, so two runs give the same bits. A
// warpgroup whose rows all lie past M (the ragged last tile) skips its
// epilogue. Shared memory that the epilogue reads back (the aux tile, the
// sums) is read by plain loads, which the compiler batches; the barrier
// waits before them carry the memory clobbers that order them.
template <int WG, int TN, int EPI, bool SUMS>
__global__ void __launch_bounds__((WG + 1) * WG_THREADS, 1)
gemm_nt_kernel(const __grid_constant__ CUtensorMap tma_a, const __grid_constant__ CUtensorMap tma_w,
               const __grid_constant__ CUtensorMap tma_aux,
               const __grid_constant__ CUtensorMap tma_out, float* __restrict__ colsum, int M,
               int N, int K) {
  using P = NtPlan<WG, TN, EPI, SUMS>;
  constexpr bool F32 = EPI == EPT_F32, GELU = EPI == EPT_GELU_GRAD;
  extern __shared__ unsigned char gemm_smem[];
  // Ring, then per warpgroup its output staging and aux tile, then the
  // warpgroups' column-sum rows, then the barriers (full, empty, aux[wg]).
  const uint32_t base = (smem_addr(gemm_smem) + 1023u) & ~1023u;
  const uint32_t staging = base + P::RING;
  const uint32_t red = staging + WG * (P::OUT_BYTES + P::AUX_BYTES);
  const uint32_t bars = red + WG * P::RED_BYTES;
  const int wg = threadIdx.x / WG_THREADS;
  const int tiles_n = N / TN;
  const int tiles = (M + P::TM - 1) / P::TM * tiles_n;
  const int ktiles = (K + GK - 1) / GK;
  init_ring(bars, WG, WG);

  if (wg == WG) {
    if (WG > 1) asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == WG * WG_THREADS) {
      RingPos pos;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int m0 = t / tiles_n * P::TM, n0 = t % tiles_n * TN;
        produce_tile<P::STAGE_BYTES>(base, bars, ktiles, pos, [&](uint32_t sa, uint32_t full, int kt) {
          tma_load(sa, &tma_a, full, kt * GK, m0);
          tma_load(sa + P::A_BYTES, &tma_w, full, kt * GK, n0);
        });
      }
    }
  } else {
    if (WG > 1) asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    float acc[TN / 2];
    const int lane = threadIdx.x & 31, wq = (threadIdx.x >> 5) & 3;
    const int tid = threadIdx.x & (WG_THREADS - 1);
    const bool signal = tid == 0;
    const uint32_t out_s = staging + wg * (P::OUT_BYTES + P::AUX_BYTES);
    const uint32_t aux_s = out_s + P::OUT_BYTES;
    const uint32_t red_s = red + wg * P::RED_BYTES;
    const uint32_t aux_bar = bars + 8 * (2 * GSTAGES + wg);
    // Generic pointers to this warpgroup's aux tile and column-sum rows.
    const unsigned char* aux_p = gemm_smem + (aux_s - smem_addr(gemm_smem));
    float* red_p = reinterpret_cast<float*>(gemm_smem + (red_s - smem_addr(gemm_smem)));
    RingPos pos;
    uint32_t aux_phase = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int m0 = t / tiles_n * P::TM, n0 = t % tiles_n * TN;
      const int r0 = m0 + wg * 64;  // this warpgroup's first row
      const bool live = r0 < M;
      // The aux tile: the previous tile's epilogue read it before the
      // warpgroup barrier that ended it, so the buffer is free.
      if (GELU && live && signal) {
        mbar_expect_tx(aux_bar, P::AUX_BYTES);
#pragma unroll
        for (int h = 0; h < TN / 64; ++h) tma_load(aux_s + h * BOX_BYTES, &tma_aux, aux_bar, n0 + 64 * h, r0);
      }
#pragma unroll
      for (int i = 0; i < TN / 2; ++i) acc[i] = 0.f;
      consume_tile<TN, false, false, P::A_BYTES, P::STAGE_BYTES>(acc, base, bars, wg, signal, ktiles,
                                                                  pos, [](uint32_t) {});
      if (!live) continue;
      if (signal) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      warpgroup_sync(1 + wg);  // the previous tile's stores have read the buffers
      if (GELU) {
        mbar_wait(aux_bar, aux_phase);
        aux_phase ^= 1;
      }
      const int row = wq * 16 + (lane >> 2);
      float cs[TN / 4];  // column 8j + 2(lane%4) + c at 2j + c: this thread's two rows
#pragma unroll
      for (int j = 0; j < TN / 8; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = row + 8 * h;
          float v[2] = {acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]};
          if (GELU) {
            const __nv_bfloat162 z2 =
                *reinterpret_cast<const __nv_bfloat162*>(aux_p + stage_bf16(j, r, lane));
            const float z[2] = {__low2float(z2), __high2float(z2)};
#pragma unroll
            for (int c = 0; c < 2; ++c) v[c] *= gelu_grad(z[c]);
          }
          if (SUMS) {
            const bool in = r0 + r < M;
#pragma unroll
            for (int c = 0; c < 2; ++c) cs[2 * j + c] = (h ? cs[2 * j + c] : 0.f) + (in ? v[c] : 0.f);
          }
          if (F32) {
            st_shared2(out_s + stage_f32(j, r, lane), v[0], v[1]);
          } else {
            __nv_bfloat162 p = __floats2bfloat162_rn(v[0], v[1]);
            st_shared(out_s + stage_bf16(j, r, lane), *reinterpret_cast<uint32_t*>(&p));
          }
        }
      }
      if (SUMS) {
        // Reduce-scatter over the eight lanes that share lane % 4: in round
        // s a lane keeps half of its remaining sums and adds its partner's
        // (lane ^ (16 >> s)) copy of that half. Slot i then holds column
        // index base + i of the cs layout, summed over the warp's 16 rows.
        constexpr int V = TN / 4;
        fold_sums<V / 2>(cs, (lane & 16) != 0, 16);
        fold_sums<V / 4>(cs, (lane & 8) != 0, 8);
        fold_sums<V / 8>(cs, (lane & 4) != 0, 4);
        const int base = ((lane >> 4) & 1) * (V / 2) + ((lane >> 3) & 1) * (V / 4) +
                         ((lane >> 2) & 1) * (V / 8);
#pragma unroll
        for (int i = 0; i < V / 8; i += 2)
          st_shared2(red_s + (wq * TN + 8 * ((base + i) >> 1) + 2 * (lane & 3)) * 4, cs[i],
                     cs[i + 1]);
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      warpgroup_sync(1 + wg);
      if (signal) {
        if (F32) {
#pragma unroll
          for (int h = 0; h < TN / 32; ++h) tma_store(&tma_out, out_s + h * BOX_BYTES, n0 + 32 * h, r0);
        } else {
#pragma unroll
          for (int h = 0; h < TN / 64; ++h) tma_store(&tma_out, out_s + h * BOX_BYTES, n0 + 64 * h, r0);
        }
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      }
      if (SUMS && tid < TN)
        colsum[static_cast<size_t>(r0 / 64) * N + n0 + tid] =
            ((red_p[tid] + red_p[TN + tid]) + red_p[2 * TN + tid]) + red_p[3 * TN + tid];
    }
    if (signal) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  }
}

// gemm_tn_kernel<WG, TN>: the weight-gradient product dW[Kin,N] = A[M,Kin]^T
// @ G[M,N], reducing over the M = B*S rows, split over `splits` row ranges
// of rps rows (a multiple of the 64-row box, so a box never reads the next
// split's rows; TMA reads the rows past M as zeros): split s writes its f32
// partial to rows [s*Kin, (s+1)*Kin) of out (the caller's workspace, or dW
// itself when there is one split), which sum_rows_kernel adds in a fixed
// order. wgmma's A is the Kin x m tile, read MN-major with the transpose bit
// (WG boxes of 64 rows x 64 Kin columns, one per consumer warpgroup), its B
// the m x TN tile of G, MN-major as gemm_kernel reads W. Tiles walk split
// major, so the blocks in flight stream the same rows through L2. With
// gsum, every consumer warpgroup also adds the column sums of G over a
// share of its split's rows from the staged B tiles: the tiles of one
// (split, column block) see the same G rows, so warpgroup part p = (i0 +
// 64*wg) / 64 of the Kin/64 sums the rows r of each stage with r % (Kin/64)
// == p, in order, into gsum[s * Kin/64 + p][n] (the same bits every run,
// and no tile slower than the others).
template <int WG, int TN>
__global__ void __launch_bounds__((WG + 1) * WG_THREADS, 1)
gemm_tn_kernel(const __grid_constant__ CUtensorMap tma_a, const __grid_constant__ CUtensorMap tma_g,
               const __grid_constant__ CUtensorMap tma_out, float* __restrict__ gsum, int M,
               int Kin, int N, int rps, int splits) {
  using P = TnPlan<WG, TN>;
  extern __shared__ unsigned char gemm_smem[];
  const uint32_t base = (smem_addr(gemm_smem) + 1023u) & ~1023u;
  const uint32_t staging = base + P::RING;
  const uint32_t bars = staging + WG * P::OUT_BYTES;
  const int wg = threadIdx.x / WG_THREADS;
  const int tiles_n = N / TN, per_split = Kin / P::TM * tiles_n;
  const int tiles = per_split * splits;
  init_ring(bars, WG, 0);
  // Tile t: its split, Kin block, column block and 64-row k steps.
  auto tile = [&](int t, int& s, int& i0, int& n0) {
    s = t / per_split;
    const int rem = t % per_split;
    i0 = rem / tiles_n * P::TM;
    n0 = rem % tiles_n * TN;
    const int rows = min(rps, M - s * rps);
    return rows > 0 ? (rows + GK - 1) / GK : 0;
  };

  if (wg == WG) {
    if (WG > 1) asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == WG * WG_THREADS) {
      RingPos pos;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        int s, i0, n0;
        const int ktiles = tile(t, s, i0, n0);
        produce_tile<P::STAGE_BYTES>(base, bars, ktiles, pos, [&](uint32_t sa, uint32_t full, int kt) {
          const int m = s * rps + kt * GK;
#pragma unroll
          for (int w = 0; w < WG; ++w) tma_load(sa + w * BOX_BYTES, &tma_a, full, i0 + 64 * w, m);
#pragma unroll
          for (int h = 0; h < TN / 64; ++h)
            tma_load(sa + P::A_BYTES + h * BOX_BYTES, &tma_g, full, n0 + 64 * h, m);
        });
      }
    }
  } else {
    if (WG > 1) asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    float acc[TN / 2];
    const int lane = threadIdx.x & 31, wq = (threadIdx.x >> 5) & 3;
    const int tid = threadIdx.x & (WG_THREADS - 1);
    const bool signal = tid == 0;
    const uint32_t out_s = staging + wg * P::OUT_BYTES;
    // The column of G this thread sums: box tid / 64, 16-byte chunk (tid %
    // 64) / 8 of each row, swizzled by the row; the rows of its part.
    const uint32_t gcol = (tid / 64) * BOX_BYTES + (tid % 8) * 2;
    const int gchunk = (tid % 64) / 8;
    const int parts = Kin / 64;
    RingPos pos;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      int s, i0, n0;
      const int ktiles = tile(t, s, i0, n0);
      const int part = i0 / 64 + wg;
      const bool sums = gsum != nullptr && tid < TN;
      float gs = 0.f;
#pragma unroll
      for (int i = 0; i < TN / 2; ++i) acc[i] = 0.f;
      consume_tile<TN, true, true, P::A_BYTES, P::STAGE_BYTES>(
          acc, base, bars, wg, signal, ktiles, pos, [&](uint32_t sb) {
            if (!sums) return;
            const unsigned char* col = gemm_smem + (sb + gcol - smem_addr(gemm_smem));
#pragma unroll 4
            for (int r = part; r < GK; r += parts)
              gs += __bfloat162float(
                  *reinterpret_cast<const bf16*>(col + r * 128 + ((gchunk ^ (r % 8)) * 16)));
          });
      if (signal) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      warpgroup_sync(1 + wg);
      const int row = wq * 16 + (lane >> 2);
#pragma unroll
      for (int j = 0; j < TN / 8; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h)
          st_shared2(out_s + stage_f32(j, row + 8 * h, lane), acc[4 * j + 2 * h],
                     acc[4 * j + 2 * h + 1]);
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      warpgroup_sync(1 + wg);
      if (signal) {
#pragma unroll
        for (int h = 0; h < TN / 32; ++h)
          tma_store(&tma_out, out_s + h * BOX_BYTES, n0 + 32 * h, s * Kin + i0 + 64 * wg);
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      }
      if (sums) gsum[(static_cast<size_t>(s) * parts + part) * N + n0 + tid] = gs;
    }
    if (signal) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  }
}

// out[m, k] = bf16(f32(a[m, k]) * scale[k]) over (M, K) bf16, 8 elements a
// thread: the chains' scaled cotangents bf16(dy * ls2) and bf16(dx2 * ls1),
// rounded once as the TPU kernels round them, formed once for the two
// products that read them (TMA cannot scale what it loads).
__global__ void scale_rows_kernel(const bf16* __restrict__ a, const float* __restrict__ scale,
                                  bf16* __restrict__ out, long long n8, int k8) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < n8;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    uint4 v = reinterpret_cast<const uint4*>(a)[i];
    const float* sc = scale + (i % k8) * 8;
    bf16* e = reinterpret_cast<bf16*>(&v);
#pragma unroll
    for (int j = 0; j < 8; ++j) e[j] = __float2bfloat16(__bfloat162float(e[j]) * sc[j]);
    reinterpret_cast<uint4*>(out)[i] = v;
  }
}

// out[i] = sum over r of part[r][i], r = 0 .. rows-1 in order: the fixed-order
// second pass of every cross-block reduction.
__global__ void sum_rows_kernel(const float* __restrict__ part, int rows, long long n,
                                float* __restrict__ out) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < n;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    float s = 0.f;
#pragma unroll 8
    for (int r = 0; r < rows; ++r) s += part[r * n + i];
    out[i] = s;
  }
}

// LayerNorm forward over whole rows, rounded to bf16, that every chain's
// first product reads (the arithmetic of the old WMMA GEMM's LayerNorm
// prologue: lane-strided f32 sums, two-pass variance). One warp per row.
__global__ void __launch_bounds__(ROW_THREADS)
ln_rows_kernel(const bf16* __restrict__ x, const float* __restrict__ gamma,
               const float* __restrict__ beta, bf16* __restrict__ out, int M, int D,
               float eps) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (ROW_THREADS / 32) + (threadIdx.x >> 5);
  if (row >= M) return;
  const bf16* src = x + static_cast<size_t>(row) * D;
  bf16* dst = out + static_cast<size_t>(row) * D;
  float s = 0.f;
  for (int c = lane; c < D; c += 32) s += __bfloat162float(src[c]);
  const float mu = warp_sum(s) / D;
  float q = 0.f;
  for (int c = lane; c < D; c += 32) {
    const float d = __bfloat162float(src[c]) - mu;
    q += d * d;
  }
  const float rstd = rsqrtf(warp_sum(q) / D + eps);
  for (int c = lane; c < D; c += 32)
    dst[c] = __float2bfloat16((__bfloat162float(src[c]) - mu) * rstd * gamma[c] + beta[c]);
}

// LayerNorm backward over whole rows, plus the residual's cotangent:
// dx = bf16(dres + r*(dm*g - mean(dm*g) - xhat*mean(dm*g*xhat))), with xhat
// and r recomputed from x in f32 (two-pass statistics). One warp per row;
// a block takes rows [blockIdx.x*rows_per_block, +rows_per_block).
// With SUMS each block also writes, for its rows, the f32 column sums
// sums[blockIdx.x][0..3][c] = (dres*ls, dres*aux, dm*xhat, dm): the vector
// gradients (dbf2, dls2, dg2, db2) of the MLP half, with dres = dy and
// aux = h2, and (dbo, dls1, dg1, db1) of the attention half, with dres = dx2
// and aux = o. Each warp sums its rows in its own shared-memory slice (lane
// l owns the columns c = l mod 32), then the warps' slices are added in
// order. MODE (RowsMode) drops ls (ROWS_UNSCALED), or the residual and aux
// (ROWS_NO_RES), for the streamed backward chains.
template <bool SUMS, int MODE = ROWS_RESIDENT>
__global__ void __launch_bounds__(ROW_THREADS)
ln_bwd_rows_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dres,
                   const float* __restrict__ dm, const float* __restrict__ gamma,
                   const float* __restrict__ ls, const bf16* __restrict__ aux,
                   bf16* __restrict__ dx, float* __restrict__ sums, int M, int D, float eps,
                   int rows_per_block) {
  extern __shared__ __align__(16) float wsum[];  // SUMS: [warps][NSUMS][D]
  constexpr int WARPS = ROW_THREADS / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* acc = wsum + static_cast<size_t>(warp) * NSUMS * D;
  if (SUMS)
    for (int e = lane; e < NSUMS * D; e += 32) acc[e] = 0.f;
  const int r0 = blockIdx.x * rows_per_block, r1 = min(M, r0 + rows_per_block);
  for (int row = r0 + warp; row < r1; row += WARPS) {
    const size_t base = static_cast<size_t>(row) * D;
    float s = 0.f;
    for (int c = lane; c < D; c += 32) s += __bfloat162float(x[base + c]);
    const float mu = warp_sum(s) / D;
    float q = 0.f;
    for (int c = lane; c < D; c += 32) {
      const float d = __bfloat162float(x[base + c]) - mu;
      q += d * d;
    }
    const float r = rsqrtf(warp_sum(q) / D + eps);
    float s1 = 0.f, s2 = 0.f;
    for (int c = lane; c < D; c += 32) {
      const float dh = dm[base + c] * gamma[c];
      s1 += dh;
      s2 += dh * (__bfloat162float(x[base + c]) - mu) * r;
    }
    const float mean1 = warp_sum(s1) / D, mean2 = warp_sum(s2) / D;
    for (int c = lane; c < D; c += 32) {
      const float dmv = dm[base + c];
      const float dh = dmv * gamma[c];
      const float xh = (__bfloat162float(x[base + c]) - mu) * r;
      const float dr = __bfloat162float(dres[base + c]);
      const float dln = r * (dh - mean1 - xh * mean2);
      dx[base + c] = __float2bfloat16(MODE == ROWS_NO_RES ? dln : dr + dln);
      if (SUMS) {
        acc[c] += MODE == ROWS_RESIDENT ? dr * ls[c] : dr;
        if (MODE != ROWS_NO_RES) acc[D + c] += dr * __bfloat162float(aux[base + c]);
        acc[2 * D + c] += dmv * xh;
        acc[3 * D + c] += dmv;
      }
    }
  }
  if (SUMS) {
    __syncthreads();
    for (int e = threadIdx.x; e < NSUMS * D; e += ROW_THREADS) {
      float t = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) t += wsum[static_cast<size_t>(w) * NSUMS * D + e];
      sums[static_cast<size_t>(blockIdx.x) * NSUMS * D + e] = t;
    }
  }
}

// ---------------------------------------------------------------------------
// The resident attention step: the per-head softmax loops of _block_kernel
// (block.py:182-199), _attn_half_core (:972-990) and _attn_bwd_kernel
// (:354-397). For one head, K and V of all S keys (or Q and dO of all S
// queries) stay in shared memory, and one consumer warpgroup holds a
// 64-row tile's whole rows of scores in registers: the softmax sees the
// exact row max over every key, takes exp, divides by the f32 row sum, and
// only then rounds P to bf16, JAX's rounding points (a streamed, online
// softmax moves them):
//
//   attn_fwd_kernel<DH, NK16>      ctx = bf16(bf16(P) V), P = softmax(Q K^T * scale)
//   attn_bwd_dq_kernel<DH, NK16>   dq = bf16(bf16(dS) K * scale) and the rows'
//                                  statistics (max, sum, rowsum(P * dP)), with
//                                  dS = P * (dP - rowsum(P * dP)), dP = dO V^T
//   attn_bwd_dkv_kernel<DH>        dk = bf16(bf16(dS)^T Q * scale),
//                                  dv = bf16(bf16(P)^T dO), P and dS rebuilt
//                                  from the statistics
//
// Every product is a wgmma. Q K^T, dO V^T (and K Q^T, V dO^T) read both
// operands K-major from shared memory, as stored. P V, dS K, P^T dO and
// dS^T Q take P or dS as the A operand straight from registers: the f32
// accumulator of an m64nN product holds, in each 16-column group, exactly
// the A fragment of one k16 step, so no score goes to shared memory; the
// other operand is read MN-major through the transpose bit. Tiles arrive by
// TMA from the packed (B, S, 3D) qkv seen as a 3-D tensor, so rows past S
// of a sample read as zeros and never as the next sample's: boxes of 64
// rows by the head's dh columns, swizzled as wide as a head row (128 bytes
// at dh = 64, 64 at dh = 32). Outputs leave through a staging tile by TMA
// stores, which clip the rows past S. A block is one consumer warpgroup and
// a producer warp whose one thread issues the loads.
//
// The softmax keeps the f32 arithmetic of the WMMA kernels these replace
// (row_softmax), and the tensor cores sum each k16 step of a wgmma as they
// summed an mma.sync step, so ctx and dv keep the replaced kernels' bits;
// dq and dk differ where rowsum(P * dP), summed in another order, moves a
// bf16 rounding.
//
// NK16 is the number of 16-key groups of scores a thread holds, 8 f32 values
// each: the instantiation at or above ceil(S/16) (key_groups). Its 64-key
// chunks are m64n64 products, a 17th group one m64n16, so that S = 257
// holds 272 keys (136 registers), not 320. dP needs the full row's
// rowsum(P * dP) before dS, so the dq kernel computes each 64-key chunk of
// dP once, adds its share of the rowsum and keeps the chunk in shared
// memory (each thread its own values) until dS. The row statistics go to
// device memory, (B, H, 3, S) f32, for the dkv kernel, which walks the
// queries in 64-row chunks with Q and dO resident, accumulating dk and dv
// in registers.
//
// What bounds them: at dinov2-large, B = 128, the forward moves 270 MB (qkv
// read, ctx written: 0.080 ms at 3.35 TB/s) for 4*B*H*S^2*dh = 34.6 GFLOP
// (0.035 ms at 989 TFLOP/s), the backward 472 MB for 86.6 GFLOP: bytes.
// Each block loads its head's K and V (Q and dO) once and walks the head's
// tiles where there are enough heads to fill the card, and the forward and
// dkv blocks fit two an SM.
// ---------------------------------------------------------------------------

constexpr int AQ = 64;            // rows of an attention tile: one wgmma M
constexpr int ATT_THREADS = 160;  // a consumer warpgroup and a producer warp

// A 64-row tile of head rows (dh bf16 values, RB bytes), as TMA lays it
// down: 16-byte chunk j of row r at chunk j ^ (r % 8) (128-byte rows) or
// j ^ ((r / 2) % 4) (64-byte rows).
template <int DH>
struct HeadTile {
  static constexpr int RB = DH * 2;
  static constexpr int BYTES = AQ * RB;
  static constexpr uint64_t LAYOUT = DH == 64 ? 1 : 2;  // wgmma's 128- or 64-byte swizzle
  // A K-major operand's k16 step in descriptor units (16 bytes): 32 bytes
  // along the rows (an MN-major one's is 16 rows, taken as an address).
  static constexpr uint64_t K_STEP = 32 >> 4;
  // The wgmma descriptor of the tile at addr: K-major (8-row groups 8 rows
  // apart, the reduction along each row) or MN-major (the reduction down the
  // rows, one atom of dh columns).
  __device__ static uint64_t desc(uint32_t addr, bool mn) {
    const uint32_t lbo = mn ? BYTES : 16, sbo = 8 * RB;
    return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
           (static_cast<uint64_t>(sbo >> 4) << 32) | (LAYOUT << 62);
  }
  // The offset of lane's 4-byte pair in 16-byte chunk j of row r.
  __device__ static uint32_t pair(int j, int r, int lane) {
    const int sw = DH == 64 ? (r & 7) : ((r >> 1) & 3);
    return r * RB + ((j ^ sw) << 4) + (lane & 3) * 4;
  }
};

// D (64 x 16 f32, 8 registers a thread) += A (64 x 16) * B (16 x 16), both
// from shared memory, as wgmma_n64.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_n16(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1, %11, %12;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

// D (64 x 32 f32) += A (64 x 16 bf16, four registers a thread in the
// accumulator's layout: rows lane/4 and +8, columns 2*(lane%4) and +8) * B
// (16 x 32) from shared memory; TB: B's transpose bit.
template <int TB>
__device__ __forceinline__ void wgmma_rs_n32(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1), "n"(TB));
}

// D (64 x 64 f32) += A (64 x 16, registers, as wgmma_rs_n32) * B (16 x 64).
template <int TB>
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1), "n"(TB));
}


// d (64 x N) += A (64 x 16) B (16 x N), both from shared memory: N = 64
// for a 64-key chunk, 16 for the tail group of S = 257 (17 groups).
template <int N, int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t da, uint64_t db) {
  static_assert(N == 64 || N == 16, "the attention kernels' products are 64 or 16 keys wide");
  if constexpr (N == 64)
    wgmma_n64<TA, TB>(d, da, db);
  else
    wgmma_n16<TA, TB>(d, da, db);
}

// d (64 x N) += A (64 x 16, registers) B (16 x N), B MN-major.
template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a, uint64_t db) {
  if constexpr (N == 64)
    wgmma_rs_n64<1>(d, a, db);
  else
    wgmma_rs_n32<1>(d, a, db);
}

// Keeps the compiler from reusing an A fragment's registers before the
// wgmma that reads them has been waited for.
template <int R>
__device__ __forceinline__ void fence_frag(uint32_t* a) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&p);
}

// One 3-D TMA tile load (coordinates innermost first) completing on bar.
__device__ __forceinline__ void tma_load3(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0,
                                          int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// One 3-D TMA tile store (a bulk group); rows past the tensor's S are not
// written.
__device__ __forceinline__ void tma_store3(const CUtensorMap* map, uint32_t src, int c0, int c1,
                                           int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// d (64 x N) = A (64 x DH) B (N x DH)^T for the tiles at a and b, both
// K-major: issued into the open wgmma group.
template <int DH, int N>
__device__ __forceinline__ void issue_nt(float* d, uint32_t a, uint32_t b) {
  using T = HeadTile<DH>;
  const uint64_t da = T::desc(a, false), db = T::desc(b, false);
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk)
    wgmma_ss<N, 0, 0>(d, da + kk * T::K_STEP, db + kk * T::K_STEP);
}

// d (64 x N) = A B^T as one wgmma group, waited for.
template <int DH, int N>
__device__ __forceinline__ void product_nt(float* d, uint32_t a, uint32_t b) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i) d[i] = 0.f;
  fence_acc<N / 2>(d);
  wgmma_fence();
  issue_nt<DH, N>(d, a, b);
  wgmma_commit();
  wgmma_wait<0>();
  fence_acc<N / 2>(d);
}

// s = Q K^T for the query tile at q against the 16*NK16 keys of the K
// tiles at k: 64-key chunks at s + 32c, the tail after them.
template <int DH, int NK16>
__device__ __forceinline__ void row_scores(float* s, uint32_t q, uint32_t k) {
  using T = HeadTile<DH>;
  constexpr int NC = NK16 / 4, TAIL = NK16 % 4;
#pragma unroll
  for (int i = 0; i < NK16 * 8; ++i) s[i] = 0.f;
  fence_acc<NK16 * 8>(s);
  wgmma_fence();
#pragma unroll
  for (int c = 0; c < NC; ++c) issue_nt<DH, 64>(s + 32 * c, q, k + c * T::BYTES);
  if constexpr (TAIL > 0) issue_nt<DH, 16 * TAIL>(s + 32 * NC, q, k + NC * T::BYTES);
  wgmma_commit();
  wgmma_wait<0>();
  fence_acc<NK16 * 8>(s);
}

// Score i of a thread lies in row (i / 2) % 2 of its two (16*warp + lane/4
// and 8 below it) and at key 8*(i/4) + 2*(lane%4) + i%2 (the m64nN
// accumulator layout, chunk after chunk).
__device__ __forceinline__ int score_col(int i, int lane) { return 8 * (i >> 2) + 2 * (lane & 3) + (i & 1); }

// a / b correctly rounded from y = RN(1/b), one reciprocal a row: q = a*y is
// within an ulp, the residual a - b*q is exact in an FMA, and one
// correction rounds to the IEEE quotient (Markstein) wherever a is normal:
// three operations for division's sequence.
__device__ __forceinline__ float div_by(float a, float b, float y) {
  const float q = __fmul_rn(a, y);
  return fmaf(fmaf(-b, q, a), y, q);
}

// The softmax of the two rows in place, at JAX's rounding points: the exact
// max over every key of s * scale, e = expf(s * scale - max), the f32 row
// sum, p = e / sum (keys >= S masked to p = 0). In the f32 arithmetic of the
// WMMA kernel it replaces, so that P keeps its bits: max(s * scale) as
// max(s) * scale (the same rounded value, scale > 0), the exponent's
// argument one FMA, and the sum in that kernel's order: its lane L = 8*(j %
// 4) + 2*(lane % 4) + e added keys L, L + 32, .. in turn (here the four
// residues of the 8-key group j of each row and e), then a butterfly over
// lanes 16, 8, 4, 2 and 1 apart (the residues two then one apart, this
// thread's lanes two then one apart, then e). mx and sum: the rows'
// statistics, the same in the row's four lanes.
template <int NK16>
__device__ __forceinline__ void row_softmax(float* s, int S, float scale, int lane, float* mx,
                                            float* sum) {
  constexpr int R = NK16 * 8, NJ = NK16 * 2;
  // Only the 16-key groups that reach S are masked.
  const int full = S / 16;
  mx[0] = mx[1] = -INFINITY;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    if (i / 8 >= full && score_col(i, lane) >= S) s[i] = -INFINITY;
    mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = __fmul_rn(fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2)), scale);
  }
#pragma unroll
  for (int i = 0; i < R; ++i) s[i] = expf(fmaf(s[i], scale, -mx[(i >> 1) & 1]));
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float t[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int j = 0; j < NJ; ++j) part[j & 3] += s[4 * j + 2 * h + e];
      t[e] = (part[0] + part[2]) + (part[1] + part[3]);
      t[e] += __shfl_xor_sync(0xffffffffu, t[e], 2);
      t[e] += __shfl_xor_sync(0xffffffffu, t[e], 1);
    }
    sum[h] = t[0] + t[1];
  }
  const float y[2] = {__frcp_rn(sum[0]), __frcp_rn(sum[1])};
#pragma unroll
  for (int i = 0; i < R; ++i) s[i] = div_by(s[i], sum[(i >> 1) & 1], y[(i >> 1) & 1]);
}

// The consumer warpgroup's 64 x DH accumulators times mul, rounded to bf16,
// through the staging tile at stage and out by one TMA store to (c0, c1,
// c2) of map, once the previous store from a staging tile has read it.
// row: the thread's first row of the tile.
template <int DH>
__device__ __forceinline__ void store_tile(const float* o, float mul, uint32_t stage,
                                           const CUtensorMap* map, int c0, int c1, int c2,
                                           int row, int lane, bool signal) {
  using T = HeadTile<DH>;
  if (signal) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  warpgroup_sync(1);
#pragma unroll
  for (int j = 0; j < DH / 8; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
      st_shared(stage + T::pair(j, row + 8 * h, lane),
                pack_bf16(o[4 * j + 2 * h] * mul, o[4 * j + 2 * h + 1] * mul));
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  warpgroup_sync(1);
  if (signal) {
    tma_store3(map, stage, c0, c1, c2);
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  }
}

// The block's head and tile range: blockIdx.x = (b*H + h) * groups + g,
// tiles [g*tpb, min(tiles, (g+1)*tpb)).
struct HeadBlock {
  int b, h, t0, t1;
  __device__ HeadBlock(int S, int H, int tpb) {
    const int tiles = (S + AQ - 1) / AQ, groups = (tiles + tpb - 1) / tpb;
    const int bh = blockIdx.x / groups;
    b = bh / H;
    h = bh % H;
    t0 = blockIdx.x % groups * tpb;
    t1 = min(tiles, t0 + tpb);
  }
};

__device__ __forceinline__ void init_bars(uint32_t bars, int n) {
  if (threadIdx.x == 0) {
    for (int i = 0; i < n; ++i) mbar_init(bars + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// Shared memory: K and V of the head (BOXES 64-key tiles each), two stages
// of a query tile, the ctx staging tile, then the barriers (K/V, query
// full[2], query empty[2]), after slack to align the tiles to 1024 bytes.
template <int DH, int NK16>
struct FwdPlan {
  using T = HeadTile<DH>;
  static constexpr int BOXES = (NK16 + 3) / 4;
  static constexpr int KV = BOXES * T::BYTES;
  static constexpr size_t SMEM = 2 * KV + 3 * T::BYTES + 5 * 8 + 1024;
};

// ctx (B, S, D) for qkv (B, S, 3D) (tensor maps tqkv, tctx; head h at
// columns h*DH of each third). Grid: B*H heads x their query tiles in groups
// of tpb. Two blocks an SM up to NK16 = 20 (the scores' 160 registers and
// what the softmax needs beside them).
template <int DH, int NK16>
__global__ void __launch_bounds__(ATT_THREADS, NK16 <= 20 ? 2 : 1)
attn_fwd_kernel(const __grid_constant__ CUtensorMap tqkv, const __grid_constant__ CUtensorMap tctx,
                int S, int H, int tpb, float scale) {
  using T = HeadTile<DH>;
  using P = FwdPlan<DH, NK16>;
  extern __shared__ unsigned char attn_smem[];
  const uint32_t ks = (smem_addr(attn_smem) + 1023u) & ~1023u;
  const uint32_t vs = ks + P::KV, qs = vs + P::KV, os = qs + 2 * T::BYTES;
  const uint32_t bars = os + T::BYTES, full = bars + 8, empty = bars + 24;
  const HeadBlock blk(S, H, tpb);
  const int D = H * DH;
  init_bars(bars, 5);

  if (threadIdx.x >= WG_THREADS) {
    // Producer: the head's K and V once, then the block's query tiles
    // through two stages.
    if (threadIdx.x == WG_THREADS) {
      mbar_expect_tx(bars, 2 * P::KV);
      for (int i = 0; i < P::BOXES; ++i) {
        tma_load3(ks + i * T::BYTES, &tqkv, bars, D + blk.h * DH, i * AQ, blk.b);
        tma_load3(vs + i * T::BYTES, &tqkv, bars, 2 * D + blk.h * DH, i * AQ, blk.b);
      }
      for (int t = blk.t0; t < blk.t1; ++t) {
        const int k = t - blk.t0, st = k & 1;
        mbar_wait(empty + 8 * st, ((k >> 1) & 1) ^ 1);
        mbar_expect_tx(full + 8 * st, T::BYTES);
        tma_load3(qs + st * T::BYTES, &tqkv, full + 8 * st, blk.h * DH, t * AQ, blk.b);
      }
    }
  } else {
    const int lane = threadIdx.x & 31, row = (threadIdx.x >> 5) * 16 + (lane >> 2);
    const bool signal = threadIdx.x == 0;
    mbar_wait(bars, 0);
    for (int t = blk.t0; t < blk.t1; ++t) {
      const int k = t - blk.t0, st = k & 1;
      mbar_wait(full + 8 * st, (k >> 1) & 1);
      float s[NK16 * 8];
      row_scores<DH, NK16>(s, qs + st * T::BYTES, ks);
      if (signal) mbar_arrive(empty + 8 * st);
      float mx[2], sum[2];
      row_softmax<NK16>(s, S, scale, lane, mx, sum);
      uint32_t p[NK16 * 4];
#pragma unroll
      for (int i = 0; i < NK16 * 4; ++i) p[i] = pack_bf16(s[2 * i], s[2 * i + 1]);
      float o[DH / 2];
#pragma unroll
      for (int i = 0; i < DH / 2; ++i) o[i] = 0.f;
      fence_acc<DH / 2>(o);
      wgmma_fence();
#pragma unroll
      for (int g = 0; g < NK16; ++g) wgmma_rs<DH>(o, p + 4 * g, T::desc(vs + g * 16 * T::RB, true));
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc<DH / 2>(o);
      fence_frag<NK16 * 4>(p);
      store_tile<DH>(o, 1.f, os, &tctx, blk.h * DH, t * AQ, blk.b, row, lane, signal);
    }
    if (signal) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  }
}

// Shared memory: K and V of the head, two stages of (Q, dO) query tiles,
// the dq staging tile, dP's stash (each consumer thread's 8*NK16 values,
// thread-major so that a warp's accesses are consecutive), then the
// barriers (K/V, full[2], empty[2]).
template <int DH, int NK16>
struct DqPlan {
  using T = HeadTile<DH>;
  static constexpr int BOXES = (NK16 + 3) / 4;
  static constexpr int KV = BOXES * T::BYTES;
  static constexpr int STASH = NK16 * 8 * WG_THREADS * 4;
  static constexpr size_t SMEM = 2 * KV + 5 * T::BYTES + STASH + 5 * 8 + 1024;
};

// dq into dqkv (columns h*DH of the first third) and the rows' statistics
// stats[b][h] = (max, sum, rowsum(P * dP)) over S queries, from qkv and
// dctx (tensor maps tqkv, tdout, tdqkv). Grid as attn_fwd_kernel's; one
// block an SM (the stash).
template <int DH, int NK16>
__global__ void __launch_bounds__(ATT_THREADS, 1)
attn_bwd_dq_kernel(const __grid_constant__ CUtensorMap tqkv, const __grid_constant__ CUtensorMap tdout,
                   const __grid_constant__ CUtensorMap tdqkv, float* __restrict__ stats, int S,
                   int H, int tpb, float scale) {
  using T = HeadTile<DH>;
  using P = DqPlan<DH, NK16>;
  constexpr int NC = NK16 / 4, TAIL = NK16 % 4, R = NK16 * 8;
  extern __shared__ unsigned char attn_smem[];
  const uint32_t ks = (smem_addr(attn_smem) + 1023u) & ~1023u;
  const uint32_t vs = ks + P::KV, qs = vs + P::KV, os = qs + 4 * T::BYTES, stash = os + T::BYTES;
  const uint32_t bars = stash + P::STASH, full = bars + 8, empty = bars + 24;
  const HeadBlock blk(S, H, tpb);
  const int D = H * DH;
  init_bars(bars, 5);

  if (threadIdx.x >= WG_THREADS) {
    if (threadIdx.x == WG_THREADS) {
      mbar_expect_tx(bars, 2 * P::KV);
      for (int i = 0; i < P::BOXES; ++i) {
        tma_load3(ks + i * T::BYTES, &tqkv, bars, D + blk.h * DH, i * AQ, blk.b);
        tma_load3(vs + i * T::BYTES, &tqkv, bars, 2 * D + blk.h * DH, i * AQ, blk.b);
      }
      for (int t = blk.t0; t < blk.t1; ++t) {
        const int k = t - blk.t0, st = k & 1;
        const uint32_t q = qs + 2 * st * T::BYTES;
        mbar_wait(empty + 8 * st, ((k >> 1) & 1) ^ 1);
        mbar_expect_tx(full + 8 * st, 2 * T::BYTES);
        tma_load3(q, &tqkv, full + 8 * st, blk.h * DH, t * AQ, blk.b);
        tma_load3(q + T::BYTES, &tdout, full + 8 * st, blk.h * DH, t * AQ, blk.b);
      }
    }
  } else {
    const int tid = threadIdx.x, lane = tid & 31, row = (tid >> 5) * 16 + (lane >> 2);
    const bool signal = tid == 0;
    float* dp_s = reinterpret_cast<float*>(attn_smem + (stash - smem_addr(attn_smem))) + tid;
    float* st = stats + (static_cast<size_t>(blk.b) * H + blk.h) * 3 * S;
    mbar_wait(bars, 0);
    for (int t = blk.t0; t < blk.t1; ++t) {
      const int k = t - blk.t0, sg = k & 1;
      const uint32_t q = qs + 2 * sg * T::BYTES, dout = q + T::BYTES;
      mbar_wait(full + 8 * sg, (k >> 1) & 1);
      float p[R];
      row_scores<DH, NK16>(p, q, ks);
      float mx[2], sum[2], rs[2] = {0.f, 0.f};
      row_softmax<NK16>(p, S, scale, lane, mx, sum);
      // dP = dO V^T a 64-key chunk at a time: its share of rowsum(P * dP),
      // then into the stash until rowsum is whole.
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        float d[32];
        product_nt<DH, 64>(d, dout, vs + c * T::BYTES);
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          rs[(i >> 1) & 1] += p[32 * c + i] * d[i];
          dp_s[(32 * c + i) * WG_THREADS] = d[i];
        }
      }
      if constexpr (TAIL > 0) {
        float d[8 * TAIL];
        product_nt<DH, 16 * TAIL>(d, dout, vs + NC * T::BYTES);
#pragma unroll
        for (int i = 0; i < 8 * TAIL; ++i) {
          rs[(i >> 1) & 1] += p[32 * NC + i] * d[i];
          dp_s[(32 * NC + i) * WG_THREADS] = d[i];
        }
      }
      if (signal) mbar_arrive(empty + 8 * sg);  // Q and dO are read
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        rs[h] += __shfl_xor_sync(0xffffffffu, rs[h], 1);
        rs[h] += __shfl_xor_sync(0xffffffffu, rs[h], 2);
        const int qrow = t * AQ + row + 8 * h;
        if ((lane & 3) == 0 && qrow < S) {
          st[qrow] = mx[h];
          st[S + qrow] = sum[h];
          st[2 * S + qrow] = rs[h];
        }
      }
      // bf16(dS) as the A fragments of dq = dS K.
      uint32_t f[R / 2];
#pragma unroll
      for (int i = 0; i < R / 2; ++i) {
        const float r = rs[i & 1];
        f[i] = pack_bf16(p[2 * i] * (dp_s[2 * i * WG_THREADS] - r),
                         p[2 * i + 1] * (dp_s[(2 * i + 1) * WG_THREADS] - r));
      }
      float o[DH / 2];
#pragma unroll
      for (int i = 0; i < DH / 2; ++i) o[i] = 0.f;
      fence_acc<DH / 2>(o);
      wgmma_fence();
#pragma unroll
      for (int g = 0; g < NK16; ++g) wgmma_rs<DH>(o, f + 4 * g, T::desc(ks + g * 16 * T::RB, true));
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc<DH / 2>(o);
      fence_frag<R / 2>(f);
      store_tile<DH>(o, scale, os, &tdqkv, blk.h * DH, t * AQ, blk.b, row, lane, signal);
    }
    if (signal) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  }
}

// Shared memory of attn_bwd_dkv_kernel at nq 64-query tiles: Q and dO of
// every query, the key tile's K and V (which then stage dk and dv), the
// statistics and the sums' reciprocals (4, nq*64) f32, the barriers (Q/dO,
// K/V full, K/V empty).
template <int DH>
__host__ __device__ constexpr size_t dkv_smem(int nq) {
  return static_cast<size_t>(2 * nq + 2) * HeadTile<DH>::BYTES + 4 * nq * AQ * 4 + 3 * 8 + 1024;
}

// dk and dv into dqkv (columns D + h*DH and 2D + h*DH) from qkv, dctx and
// the dq kernel's statistics. Grid: B*H heads x their key tiles in groups
// of tpb; two blocks an SM.
template <int DH>
__global__ void __launch_bounds__(ATT_THREADS, 2)
attn_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tqkv, const __grid_constant__ CUtensorMap tdout,
                    const __grid_constant__ CUtensorMap tdqkv, const float* __restrict__ stats,
                    int S, int H, int tpb, float scale) {
  using T = HeadTile<DH>;
  extern __shared__ unsigned char attn_smem[];
  const int nq = (S + AQ - 1) / AQ;
  const uint32_t qs = (smem_addr(attn_smem) + 1023u) & ~1023u;
  const uint32_t dos = qs + nq * T::BYTES, kc = dos + nq * T::BYTES, vc = kc + T::BYTES;
  const uint32_t sts = vc + T::BYTES, bars = sts + 4 * nq * AQ * 4;
  const uint32_t full = bars + 8, empty = bars + 16;
  const HeadBlock blk(S, H, tpb);
  const int D = H * DH;
  init_bars(bars, 3);

  if (threadIdx.x >= WG_THREADS) {
    if (threadIdx.x == WG_THREADS) {
      mbar_expect_tx(bars, 2 * nq * T::BYTES);
      for (int j = 0; j < nq; ++j) {
        tma_load3(qs + j * T::BYTES, &tqkv, bars, blk.h * DH, j * AQ, blk.b);
        tma_load3(dos + j * T::BYTES, &tdout, bars, blk.h * DH, j * AQ, blk.b);
      }
      for (int t = blk.t0; t < blk.t1; ++t) {
        const int k = t - blk.t0;
        mbar_wait(empty, (k & 1) ^ 1);
        mbar_expect_tx(full, 2 * T::BYTES);
        tma_load3(kc, &tqkv, full, D + blk.h * DH, t * AQ, blk.b);
        tma_load3(vc, &tqkv, full, 2 * D + blk.h * DH, t * AQ, blk.b);
      }
    }
  } else {
    const int tid = threadIdx.x, lane = tid & 31, row = (tid >> 5) * 16 + (lane >> 2);
    const bool signal = tid == 0;
    // The statistics of every query (rows past S: max 0, sum 1, and P = 0
    // by the mask below), then RN(1/sum) for the division.
    float* sm = reinterpret_cast<float*>(attn_smem + (sts - smem_addr(attn_smem)));
    const float* st = stats + (static_cast<size_t>(blk.b) * H + blk.h) * 3 * S;
    const int qn = nq * AQ;
    for (int i = tid; i < 3 * qn; i += WG_THREADS) {
      const int w = i / qn, qi = i % qn;
      const float v = qi < S ? st[w * S + qi] : (w == 1 ? 1.f : 0.f);
      sm[i] = v;
      if (w == 1) sm[3 * qn + qi] = __frcp_rn(v);
    }
    warpgroup_sync(1);
    mbar_wait(bars, 0);
    for (int t = blk.t0; t < blk.t1; ++t) {
      mbar_wait(full, (t - blk.t0) & 1);
      float dk[DH / 2], dv[DH / 2];
#pragma unroll
      for (int i = 0; i < DH / 2; ++i) dk[i] = dv[i] = 0.f;
      for (int j = 0; j < nq; ++j) {
        // S^T = K Q_j^T and dP^T = V dO_j^T (keys as rows), one group.
        float sT[32], dT[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) sT[i] = dT[i] = 0.f;
        fence_acc<32>(sT);
        fence_acc<32>(dT);
        wgmma_fence();
        issue_nt<DH, 64>(sT, kc, qs + j * T::BYTES);
        issue_nt<DH, 64>(dT, vc, dos + j * T::BYTES);
        wgmma_commit();
        wgmma_wait<0>();
        fence_acc<32>(sT);
        fence_acc<32>(dT);
        uint32_t pf[16], df[16];
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          float pv[2], ds[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int qi = j * AQ + score_col(2 * i + e, lane);
            const float p = qi < S ? div_by(expf(fmaf(sT[2 * i + e], scale, -sm[qi])),
                                            sm[qn + qi], sm[3 * qn + qi])
                                   : 0.f;
            pv[e] = p;
            ds[e] = p * (dT[2 * i + e] - sm[2 * qn + qi]);
          }
          pf[i] = pack_bf16(pv[0], pv[1]);
          df[i] = pack_bf16(ds[0], ds[1]);
        }
        // dv += bf16(P^T) dO_j, dk += bf16(dS^T) Q_j: 16 queries a k16 step.
        fence_acc<DH / 2>(dv);
        fence_acc<DH / 2>(dk);
        wgmma_fence();
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          wgmma_rs<DH>(dv, pf + 4 * g, T::desc(dos + j * T::BYTES + g * 16 * T::RB, true));
          wgmma_rs<DH>(dk, df + 4 * g, T::desc(qs + j * T::BYTES + g * 16 * T::RB, true));
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_acc<DH / 2>(dv);
        fence_acc<DH / 2>(dk);
        fence_frag<16>(pf);
        fence_frag<16>(df);
      }
      // K and V are read: they stage dk and dv, and once the stores have
      // read them the producer may load the next key tile.
      store_tile<DH>(dk, scale, kc, &tdqkv, D + blk.h * DH, t * AQ, blk.b, row, lane, signal);
      store_tile<DH>(dv, 1.f, vc, &tdqkv, 2 * D + blk.h * DH, t * AQ, blk.b, row, lane, signal);
      if (signal) {
        asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
        mbar_arrive(empty);
      }
    }
    if (signal) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  }
}


// The tile plan of an (M, N) product of gemm_kernel or gemm_nt_kernel: 0 =
// 128 x 128 (two consumer warpgroups) where those tiles fill the card; 1 =
// 64 x 128 where only 64-row tiles do; 2 = 64 x 64 otherwise (the batch-1
// products), or where N is not a multiple of 128.
int gemm_plan(int M, int N) {
  const int sms = sm_count();
  if (N % 128 == 0 && (M + 127) / 128 * (N / 128) >= sms) return 0;
  if (N % 128 == 0 && (M + 63) / 64 * (N / 128) >= sms) return 1;
  return 2;
}

// The tile plan of a gemm_tn product dW (Kin, N): the largest tile the
// shape takes (the row splits fill the card), 0 = 128 x 128, 1 = 64 x 128,
// 2 = 64 x 64. ops/block.py _tn_tile mirrors it.
int tn_plan(int Kin, int N) {
  if (N % 128) return 2;
  return Kin % 128 ? 1 : 0;
}

// Rows a split of a gemm_tn product takes: the M rows' 64-row steps shared
// out evenly over `splits` (ops/block.py _split_rows mirrors it).
int split_rows(int M, int splits) {
  const int steps = (M + GK - 1) / GK;
  return (steps + splits - 1) / splits * GK;
}

// Sets the kernel's dynamic shared memory once per instantiation (`sized`
// is the caller's static; every thread that races here sets the same value).
template <typename Kernel>
cudaError_t size_once(Kernel kernel, size_t smem, bool& sized) {
  if (sized) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  sized = err == cudaSuccess;
  return err;
}

int grid_for(int tiles) { return tiles < sm_count() ? tiles : sm_count(); }

template <int WG, int TN, int EPI>
cudaError_t launch_gemm_plan(const void* A, const void* W, const void* bias, const void* ls,
                             const void* res, void* out, void* out2, int M, int N, int K,
                             cudaStream_t stream) {
  using P = GemmPlan<WG, TN, EPI>;
  CUtensorMap ta, tw, to, to2;
  if (!encode_tiles(&ta, A, K, M, P::TM) || !encode_tiles(&tw, W, N, K, GK) ||
      !encode_tiles(&to, out, N, M, 64) ||
      !encode_tiles(&to2, two_outputs(EPI) ? out2 : out, N, M, 64))
    return cudaErrorInvalidValue;
  static bool sized = false;
  cudaError_t err = size_once(gemm_kernel<WG, TN, EPI>, P::SMEM, sized);
  if (err != cudaSuccess) return err;
  gemm_kernel<WG, TN, EPI><<<grid_for((M + P::TM - 1) / P::TM * (N / TN)), P::THREADS, P::SMEM,
                             stream>>>(ta, tw, to, to2, static_cast<const float*>(bias),
                                       static_cast<const float*>(ls),
                                       static_cast<const bf16*>(res), M, N, K);
  return cudaGetLastError();
}

// out = epilogue(A @ W) (and out2 for the paired epilogues), the plan by
// gemm_plan. M any, N % 64 == 0, K % 32 == 0 (the wrappers check).
template <int EPI>
cudaError_t launch_gemm(const void* A, const void* W, const void* bias, const void* ls,
                        const void* res, void* out, int M, int N, int K, cudaStream_t stream,
                        void* out2 = nullptr) {
  if (M <= 0) return cudaSuccess;
  switch (gemm_plan(M, N)) {
    case 0:
      return launch_gemm_plan<2, 128, EPI>(A, W, bias, ls, res, out, out2, M, N, K, stream);
    case 1:
      return launch_gemm_plan<1, 128, EPI>(A, W, bias, ls, res, out, out2, M, N, K, stream);
    default:
      return launch_gemm_plan<1, 64, EPI>(A, W, bias, ls, res, out, out2, M, N, K, stream);
  }
}

template <int WG, int TN, int EPI, bool SUMS>
cudaError_t launch_gemm_nt_plan(const void* A, const void* W, const void* aux, void* out,
                                void* colsum, int M, int N, int K, cudaStream_t stream) {
  using P = NtPlan<WG, TN, EPI, SUMS>;
  CUtensorMap ta, tw, tx, to;
  if (!encode_tiles(&ta, A, K, M, P::TM) || !encode_tiles(&tw, W, K, N, TN) ||
      !encode_tiles(&to, out, N, M, 64, EPI == EPT_F32))
    return cudaErrorInvalidValue;
  if (EPI != EPT_GELU_GRAD)
    tx = ta;  // not read
  else if (!encode_tiles(&tx, aux, N, M, 64))
    return cudaErrorInvalidValue;
  static bool sized = false;
  cudaError_t err = size_once(gemm_nt_kernel<WG, TN, EPI, SUMS>, P::SMEM, sized);
  if (err != cudaSuccess) return err;
  gemm_nt_kernel<WG, TN, EPI, SUMS><<<grid_for((M + P::TM - 1) / P::TM * (N / TN)), P::THREADS,
                                      P::SMEM, stream>>>(ta, tw, tx, to,
                                                         static_cast<float*>(colsum), M, N, K);
  return cudaGetLastError();
}

// out = epilogue(A @ W^T), W stored (N, K); with colsum the per-64-row
// column sums (ceil(M/64), N). The plan by gemm_plan; M any, N % 64 == 0,
// K % 32 == 0.
template <int EPI>
cudaError_t launch_gemm_nt(const void* A, const void* W, const void* aux, void* out, int M, int N,
                           int K, cudaStream_t stream, void* colsum = nullptr) {
  if (M <= 0) return cudaSuccess;
  const bool sums = colsum != nullptr;
  switch (gemm_plan(M, N)) {
    case 0:
      return sums ? launch_gemm_nt_plan<2, 128, EPI, true>(A, W, aux, out, colsum, M, N, K, stream)
                  : launch_gemm_nt_plan<2, 128, EPI, false>(A, W, aux, out, colsum, M, N, K, stream);
    case 1:
      return sums ? launch_gemm_nt_plan<1, 128, EPI, true>(A, W, aux, out, colsum, M, N, K, stream)
                  : launch_gemm_nt_plan<1, 128, EPI, false>(A, W, aux, out, colsum, M, N, K, stream);
    default:
      return sums ? launch_gemm_nt_plan<1, 64, EPI, true>(A, W, aux, out, colsum, M, N, K, stream)
                  : launch_gemm_nt_plan<1, 64, EPI, false>(A, W, aux, out, colsum, M, N, K, stream);
  }
}

// out[i] = sum over the first `rows` rows of part (rows, n), in order.
cudaError_t launch_sum_rows(const void* part, int rows, long long n, void* out,
                            cudaStream_t stream) {
  const long long blocks = (n + 255) / 256;
  sum_rows_kernel<<<static_cast<int>(blocks < 4096 ? blocks : 4096), 256, 0, stream>>>(
      static_cast<const float*>(part), rows, n, static_cast<float*>(out));
  return cudaGetLastError();
}

// out (M, K) = bf16(a * scale[k]); K % 8 == 0.
cudaError_t launch_scale_rows(const void* a, const void* scale, void* out, int M, int K,
                              cudaStream_t stream) {
  const long long n8 = static_cast<long long>(M) * K / 8;
  const long long blocks = (n8 + 255) / 256;
  scale_rows_kernel<<<static_cast<int>(blocks < 4096 ? blocks : 4096), 256, 0, stream>>>(
      static_cast<const bf16*>(a), static_cast<const float*>(scale), static_cast<bf16*>(out), n8,
      K / 8);
  return cudaGetLastError();
}

template <int WG, int TN>
cudaError_t launch_gemm_tn_plan(const void* A, const void* G, void* out, void* gsum, int M,
                                int Kin, int N, int splits, cudaStream_t stream) {
  using P = TnPlan<WG, TN>;
  CUtensorMap ta, tg, to;
  if (!encode_tiles(&ta, A, Kin, M, 64) || !encode_tiles(&tg, G, N, M, 64) ||
      !encode_tiles(&to, out, N, splits * Kin, 64, true))
    return cudaErrorInvalidValue;
  static bool sized = false;
  cudaError_t err = size_once(gemm_tn_kernel<WG, TN>, P::SMEM, sized);
  if (err != cudaSuccess) return err;
  gemm_tn_kernel<WG, TN><<<grid_for(Kin / P::TM * (N / TN) * splits), P::THREADS, P::SMEM,
                           stream>>>(ta, tg, to, static_cast<float*>(gsum), M, Kin, N,
                                     split_rows(M, splits), splits);
  return cudaGetLastError();
}

// dW[Kin, N] = A[M, Kin]^T @ G[M, N] over `splits` row splits: with one,
// straight into dw; with more, f32 partials in ws (splits, Kin, N) that
// sum_rows adds in a fixed order. With gsum_out also the column sums of G
// (N), through gsum_ws (splits * Kin/64, N). The plan by tn_plan; Kin and
// N multiples of 64.
cudaError_t launch_gemm_tn(const void* A, const void* G, void* ws, void* gsum_ws, void* dw,
                           void* gsum_out, int M, int Kin, int N, int splits,
                           cudaStream_t stream) {
  const bool direct = splits == 1;
  void* out = direct ? dw : ws;
  void* gs = gsum_out == nullptr ? nullptr : gsum_ws;
  cudaError_t err;
  switch (tn_plan(Kin, N)) {
    case 0:
      err = launch_gemm_tn_plan<2, 128>(A, G, out, gs, M, Kin, N, splits, stream);
      break;
    case 1:
      err = launch_gemm_tn_plan<1, 128>(A, G, out, gs, M, Kin, N, splits, stream);
      break;
    default:
      err = launch_gemm_tn_plan<1, 64>(A, G, out, gs, M, Kin, N, splits, stream);
  }
  if (err == cudaSuccess && !direct)
    err = launch_sum_rows(ws, splits, static_cast<long long>(Kin) * N, dw, stream);
  if (err != cudaSuccess || gsum_out == nullptr) return err;
  return launch_sum_rows(gsum_ws, splits * (Kin / 64), N, gsum_out, stream);
}

cudaError_t launch_ln_rows(const void* x, const void* gamma, const void* beta, void* out, int M,
                           int D, float eps, cudaStream_t stream) {
  const int rows_per_block = ROW_THREADS / 32;
  ln_rows_kernel<<<(M + rows_per_block - 1) / rows_per_block, ROW_THREADS, 0, stream>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<bf16*>(out), M, D, eps);
  return cudaGetLastError();
}

// dx = dres + LN^T(dm) and the four column sums into vec4 (NSUMS, D),
// through per-block partials part (ceil(M/SUM_ROWS), NSUMS, D); MODE as
// ln_bwd_rows_kernel's.
template <int MODE>
cudaError_t launch_ln_bwd_sums(const void* x, const void* dres, const void* dm,
                               const void* gamma, const void* ls, const void* aux, void* dx,
                               void* part, void* vec4, int M, int D, float eps,
                               cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(ROW_THREADS / 32) * NSUMS * D * 4;
  cudaError_t err = cudaFuncSetAttribute(ln_bwd_rows_kernel<true, MODE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int blocks = (M + SUM_ROWS - 1) / SUM_ROWS;
  ln_bwd_rows_kernel<true, MODE><<<blocks, ROW_THREADS, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(dres),
      static_cast<const float*>(dm), static_cast<const float*>(gamma),
      static_cast<const float*>(ls), static_cast<const bf16*>(aux), static_cast<bf16*>(dx),
      static_cast<float*>(part), M, D, eps, SUM_ROWS);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_sum_rows(part, blocks, static_cast<long long>(NSUMS) * D, vec4, stream);
}

// A (B, S, row) bf16 tensor as TMA boxes of 64 rows x dh columns of one
// sample (3-D, so that rows past S read as zeros and are not written),
// swizzled as wide as a head row.
bool encode_heads(CUtensorMap* map, const void* base, int row, int S, int B, int dh) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr || !bind_context()) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(row), static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(row) * 2,
                                 static_cast<cuuint64_t>(S) * row * 2};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(dh), AQ, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims, strides, box,
            step, CU_TENSOR_MAP_INTERLEAVE_NONE,
            dh == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The chains' attention route: the resident kernels take S up to these
// limits, the streamed ones past them. The first resident kernels' shared
// memory set them; they stay as they were, so that no shape moves between
// the two routes' rounding points.
int resident_limit(int dh, bool backward) {
  if (dh == 64) return backward ? 304 : 320;
  if (dh == 32) return backward ? 384 : 400;
  return 0;
}

bool flash_forward(int S, int dh) { return S > resident_limit(dh, false); }
bool flash_backward(int S, int dh) { return S > resident_limit(dh, true); }

// The 16-key groups of the instantiation that takes S at head width dh: the
// least at or above ceil(S/16) (0 past the resident limits). 17 is
// dinov2's S = 257; 25 only the forward at dh = 32.
int key_groups(int S, int dh) {
  static const int g64[] = {4, 8, 12, 17, 20}, g32[] = {8, 17, 24, 25};
  const int need = (S + 15) / 16;
  const int* g = dh == 64 ? g64 : g32;
  const int n = dh == 64 ? 5 : (dh == 32 ? 4 : 0);
  for (int i = 0; i < n; ++i)
    if (g[i] >= need) return g[i];
  return 0;
}

// Query (key) tiles a block walks: all of its head's where the heads alone
// fill the card `per_sm` blocks an SM deep (K and V, or Q and dO, loaded
// once a head), else one (the batch-1 shapes: a block a tile).
int tiles_per_block(int B, int H, int S, int per_sm) {
  return B * H >= per_sm * sm_count() ? (S + AQ - 1) / AQ : 1;
}

int head_blocks(int B, int H, int S, int tpb) {
  return B * H * (((S + AQ - 1) / AQ + tpb - 1) / tpb);
}

template <int DH, int NK16>
cudaError_t launch_fwd_plan(const CUtensorMap& tq, const CUtensorMap& to, int B, int S, int H,
                            float scale, cudaStream_t stream) {
  using P = FwdPlan<DH, NK16>;
  static bool sized = false;
  cudaError_t err = size_once(attn_fwd_kernel<DH, NK16>, P::SMEM, sized);
  if (err != cudaSuccess) return err;
  const int tpb = tiles_per_block(B, H, S, NK16 <= 20 ? 2 : 1);
  attn_fwd_kernel<DH, NK16><<<head_blocks(B, H, S, tpb), ATT_THREADS, P::SMEM, stream>>>(
      tq, to, S, H, tpb, scale);
  return cudaGetLastError();
}

template <int DH, int NK16>
cudaError_t launch_bwd_plan(const CUtensorMap& tq, const CUtensorMap& tdo, const CUtensorMap& tdq,
                            void* stats, int B, int S, int H, float scale, cudaStream_t stream) {
  using P = DqPlan<DH, NK16>;
  static bool sized_dq = false, sized_dkv = false;
  // The dkv kernel sized once for the most query tiles its head width takes.
  const int nq_max = (resident_limit(DH, true) + AQ - 1) / AQ;
  cudaError_t err = size_once(attn_bwd_dq_kernel<DH, NK16>, P::SMEM, sized_dq);
  if (err == cudaSuccess) err = size_once(attn_bwd_dkv_kernel<DH>, dkv_smem<DH>(nq_max), sized_dkv);
  if (err != cudaSuccess) return err;
  int tpb = tiles_per_block(B, H, S, 1);
  attn_bwd_dq_kernel<DH, NK16><<<head_blocks(B, H, S, tpb), ATT_THREADS, P::SMEM, stream>>>(
      tq, tdo, tdq, static_cast<float*>(stats), S, H, tpb, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  tpb = tiles_per_block(B, H, S, 2);
  attn_bwd_dkv_kernel<DH><<<head_blocks(B, H, S, tpb), ATT_THREADS, dkv_smem<DH>((S + AQ - 1) / AQ),
                            stream>>>(tq, tdo, tdq, static_cast<const float*>(stats), S, H, tpb,
                                      scale);
  return cudaGetLastError();
}

// The chains' view of qkv (B, S, 3D) and ctx (B, S, D) for the streamed
// kernels; dqkv and dctx share those layouts.
dp_flash::Params packed_heads(const void* qkv, int B, int S, int H, int dh) {
  const int D = H * dh;
  const bf16* base = static_cast<const bf16*>(qkv);
  dp_flash::Params p = {};
  p.q = base;
  p.k = base + D;
  p.v = base + 2 * D;
  p.in_b = static_cast<long long>(S) * 3 * D;
  p.in_h = dh;
  p.in_r = 3 * D;
  p.out_b = static_cast<long long>(S) * D;
  p.out_h = dh;
  p.out_r = D;
  p.B = B;
  p.H = H;
  p.S = S;
  p.scale = 1.0f / sqrtf(static_cast<float>(dh));
  return p;
}

// flash: the streamed kernels, which read the forward's statistics from
// stats (written by launch_attention with flash); else the resident pair,
// the dq kernel writing the statistics to stats and the dkv kernel reading
// them.
cudaError_t launch_attn_bwd(const void* qkv, const void* dctx, void* stats, void* dqkv, int B,
                            int S, int H, int dh, bool flash, cudaStream_t stream) {
  if (flash) {
    dp_flash::Params p = packed_heads(qkv, B, S, H, dh);
    bf16* g = static_cast<bf16*>(dqkv);
    const int D = H * dh;
    p.dout = static_cast<const bf16*>(dctx);
    p.stats = static_cast<float*>(stats);
    p.dq = g;
    p.dk = g + D;
    p.dv = g + 2 * D;
    return dp_flash::launch_bwd(p, dh, stream);
  }
  const int D = H * dh;
  CUtensorMap tq, tdo, tdq;
  if (!encode_heads(&tq, qkv, 3 * D, S, B, dh) || !encode_heads(&tdo, dctx, D, S, B, dh) ||
      !encode_heads(&tdq, dqkv, 3 * D, S, B, dh))
    return cudaErrorInvalidValue;
  const float scale = 1.0f / sqrtf(static_cast<float>(dh));
  switch (dh * 100 + key_groups(S, dh)) {
#define ATTN_BWD_CASE(DH, G) \
  case DH * 100 + G:         \
    return launch_bwd_plan<DH, G>(tq, tdo, tdq, stats, B, S, H, scale, stream);
    ATTN_BWD_CASE(64, 4)
    ATTN_BWD_CASE(64, 8)
    ATTN_BWD_CASE(64, 12)
    ATTN_BWD_CASE(64, 17)
    ATTN_BWD_CASE(64, 20)
    ATTN_BWD_CASE(32, 8)
    ATTN_BWD_CASE(32, 17)
    ATTN_BWD_CASE(32, 24)
#undef ATTN_BWD_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

// flash: the streamed forward (writing the row statistics to stats when it
// is not null); else attn_fwd_kernel with the head's K and V resident.
cudaError_t launch_attention(const void* qkv, void* ctx, void* stats, int B, int S, int H,
                             int dh, bool flash, cudaStream_t stream) {
  if (flash) {
    dp_flash::Params p = packed_heads(qkv, B, S, H, dh);
    p.o = static_cast<bf16*>(ctx);
    p.stats = static_cast<float*>(stats);
    return dp_flash::launch_fwd(p, dh, stream);
  }
  CUtensorMap tq, to;
  if (!encode_heads(&tq, qkv, 3 * H * dh, S, B, dh) || !encode_heads(&to, ctx, H * dh, S, B, dh))
    return cudaErrorInvalidValue;
  const float scale = 1.0f / sqrtf(static_cast<float>(dh));
  switch (dh * 100 + key_groups(S, dh)) {
#define ATTN_FWD_CASE(DH, G) \
  case DH * 100 + G:         \
    return launch_fwd_plan<DH, G>(tq, to, B, S, H, scale, stream);
    ATTN_FWD_CASE(64, 4)
    ATTN_FWD_CASE(64, 8)
    ATTN_FWD_CASE(64, 12)
    ATTN_FWD_CASE(64, 17)
    ATTN_FWD_CASE(64, 20)
    ATTN_FWD_CASE(32, 8)
    ATTN_FWD_CASE(32, 17)
    ATTN_FWD_CASE(32, 24)
    ATTN_FWD_CASE(32, 25)
#undef ATTN_FWD_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

// The attention half, its out-projection epilogue OUT_EPI: EPI_BIAS (o,
// resident rounding), EPI_BIAS_LS_RES (x2 = x + ls1*o, the whole block),
// EPI_F32BIAS (o, streamed rounding) or EPI_NONE (a tensor-parallel shard's
// partial o, no bias). D is the model width (x and out), Dl the width of
// the heads this call computes (qkv (M, 3Dl) as [q|k|v], ctx (M, Dl), wo
// (Dl, D)) and H their count: Dl = D on one device, D/tp on a shard. The
// LayerNorm rows (M, D) go into out, the half's own output buffer, which
// nothing reads until the out-projection overwrites it: each call (each
// shard) normalises every row once, into a buffer of its own.
template <int OUT_EPI>
cudaError_t attn_half(const void* x, const void* g1, const void* b1, const void* wqkv,
                      const void* bqkv, const void* wo, const void* bo, const void* ls1,
                      void* qkv, void* ctx, void* out, int B, int S, int D, int Dl, int H,
                      float eps, cudaStream_t st) {
  const int M = B * S;
  cudaError_t err = launch_ln_rows(x, g1, b1, out, M, D, eps, st);
  if (err != cudaSuccess) return err;
  err = launch_gemm<EPI_BIAS>(out, wqkv, bqkv, nullptr, nullptr, qkv, M, 3 * Dl, D, st);
  if (err != cudaSuccess) return err;
  err = launch_attention(qkv, ctx, nullptr, B, S, H, Dl / H, flash_forward(S, Dl / H), st);
  if (err != cudaSuccess) return err;
  return launch_gemm<OUT_EPI>(ctx, wo, bo, ls1, x, out, M, D, Dl, st);
}

// The MLP half, its fc2 epilogue OUT_EPI: EPI_BIAS_LS_RES (resident rounding),
// EPI_F32BIAS_LS_RES (streamed rounding), EPI_F32BIAS_LS_RES_H2 (streamed,
// h2 written to the buffer h2) or EPI_NONE (a tensor-parallel shard's partial
// fc2 product: hidden is the shard's 4D/tp, bf2, ls2 and x2's residual are
// not read). The LayerNorm rows (M, D) go into y, the output buffer, which
// fc2 overwrites once fc1 has read them.
template <int OUT_EPI>
cudaError_t mlp_half(const void* x2, const void* g2, const void* b2, const void* w1,
                     const void* bf1, const void* w2, const void* bf2, const void* ls2,
                     void* hbuf, void* y, int M, int D, int hidden, float eps,
                     cudaStream_t st, void* h2 = nullptr) {
  cudaError_t err = launch_ln_rows(x2, g2, b2, y, M, D, eps, st);
  if (err != cudaSuccess) return err;
  err = launch_gemm<EPI_BIAS_GELU>(y, w1, bf1, nullptr, nullptr, hbuf, M, hidden, D, st);
  if (err != cudaSuccess) return err;
  return launch_gemm<OUT_EPI>(hbuf, w2, bf2, ls2, x2, y, M, D, hidden, st, h2);
}

// The MLP half's backward with its weight gradients (dp_fused_mlp_bwd's
// arguments). SAVED_H2: h2 is the forward's saved pre-LayerScale output (the
// streamed route), so no h2 GEMM runs, and vec4[0] holds sum(dy), which the
// caller scales by ls2 (JAX's dbf2 = ls2 * sum(dy)); otherwise h2 is
// recomputed into the buffer and vec4[0] = sum(dy * ls2).
template <bool SAVED_H2>
cudaError_t mlp_bwd(const void* x2, const void* dy, const void* g2, const void* b2,
                    const void* w1, const void* bf1, const void* w2, const void* bf2,
                    const void* ls2, void* m, void* h1, void* g, void* h2, void* dh1b, void* dm,
                    void* colsum_part, void* row_part, void* ws1, void* ws2, void* dx2,
                    void* dw1, void* dbf1, void* dw2, void* vec4, int M, int D, int hidden,
                    int splits1, int splits2, float eps, cudaStream_t st) {
  cudaError_t err = launch_ln_rows(x2, g2, b2, m, M, D, eps, st);
  if (err != cudaSuccess) return err;
  err = launch_gemm<EPI_BIAS_GELU_PAIR>(m, w1, bf1, nullptr, nullptr, h1, M, hidden, D, st, g);
  if (err != cudaSuccess) return err;
  if (!SAVED_H2) {
    err = launch_gemm<EPI_BIAS>(g, w2, bf2, nullptr, nullptr, h2, M, D, hidden, st);
    if (err != cudaSuccess) return err;
  }
  // bf16(dy * ls2), formed once into dm's f32 buffer (dead until dm is
  // formed), for the two products that read it: dh1b and dW2.
  void* dys = dm;
  err = launch_scale_rows(dy, ls2, dys, M, D, st);
  if (err != cudaSuccess) return err;
  err = launch_gemm_nt<EPT_GELU_GRAD>(dys, w2, h1, dh1b, M, hidden, D, st, colsum_part);
  if (err != cudaSuccess) return err;
  err = launch_sum_rows(colsum_part, (M + 63) / 64, hidden, dbf1, st);
  if (err != cudaSuccess) return err;
  err = launch_gemm_tn(g, dys, ws2, nullptr, dw2, nullptr, M, hidden, D, splits2, st);
  if (err != cudaSuccess) return err;
  err = launch_gemm_nt<EPT_F32>(dh1b, w1, nullptr, dm, M, D, hidden, st);
  if (err != cudaSuccess) return err;
  err = launch_ln_bwd_sums<SAVED_H2 ? ROWS_UNSCALED : ROWS_RESIDENT>(
      x2, dy, dm, g2, ls2, h2, dx2, row_part, vec4, M, D, eps, st);
  if (err != cudaSuccess) return err;
  return launch_gemm_tn(m, dh1b, ws1, nullptr, dw1, nullptr, M, D, hidden, splits1, st);
}

// The attention half's backward with its weight gradients (dp_fused_attn_bwd's
// arguments). STREAM: the cotangent dres is do, the pre-LayerScale output's
// (bf16, already times ls1): o is not recomputed, dctx = bf16(do Wo^T), dx
// = LN1^T(da) with no residual, vec4 = (dbo = sum(do), 0, dg1, db1) and dWo =
// ctx^T do; ls1 and o are not read. Otherwise dres is dx2 and the chain
// scales it by ls1 and adds it to dx.
template <bool STREAM>
cudaError_t attn_bwd(const void* x, const void* dres, const void* g1, const void* b1,
                     const void* wqkv, const void* bqkv, const void* wo, const void* bo,
                     const void* ls1, void* a, void* qkv, void* ctx, void* o, void* dctx,
                     void* dqkv, void* da, void* stats, void* row_part, void* ws_qkv, void* ws_o,
                     void* gsum_part, void* dx, void* dwqkv, void* dbqkv, void* dwo, void* vec4,
                     int B, int S, int D, int H, int splits_qkv, int splits_o, float eps,
                     cudaStream_t st) {
  const int M = B * S;
  cudaError_t err = launch_ln_rows(x, g1, b1, a, M, D, eps, st);
  if (err != cudaSuccess) return err;
  err = launch_gemm<EPI_BIAS>(a, wqkv, bqkv, nullptr, nullptr, qkv, M, 3 * D, D, st);
  if (err != cudaSuccess) return err;
  const bool flash = flash_backward(S, D / H);
  err = launch_attention(qkv, ctx, stats, B, S, H, D / H, flash, st);
  if (err != cudaSuccess) return err;
  // The out-projection's cotangent: do itself, or bf16(dx2 * ls1) formed
  // once into da's f32 buffer (dead until da is formed), for dctx and dWo.
  const void* dob = dres;
  if (!STREAM) {
    err = launch_gemm<EPI_BIAS>(ctx, wo, bo, nullptr, nullptr, o, M, D, D, st);
    if (err != cudaSuccess) return err;
    err = launch_scale_rows(dres, ls1, da, M, D, st);
    if (err != cudaSuccess) return err;
    dob = da;
  }
  err = launch_gemm_nt<EPT_BF16>(dob, wo, nullptr, dctx, M, D, D, st);
  if (err != cudaSuccess) return err;
  err = launch_gemm_tn(ctx, dob, ws_o, nullptr, dwo, nullptr, M, D, D, splits_o, st);
  if (err != cudaSuccess) return err;
  err = launch_attn_bwd(qkv, dctx, stats, dqkv, B, S, H, D / H, flash, st);
  if (err != cudaSuccess) return err;
  err = launch_gemm_nt<EPT_F32>(dqkv, wqkv, nullptr, da, M, D, 3 * D, st);
  if (err != cudaSuccess) return err;
  err = launch_ln_bwd_sums<STREAM ? ROWS_NO_RES : ROWS_RESIDENT>(
      x, dres, da, g1, ls1, o, dx, row_part, vec4, M, D, eps, st);
  if (err != cudaSuccess) return err;
  return launch_gemm_tn(a, dqkv, ws_qkv, gsum_part, dwqkv, dbqkv, M, D, 3 * D, splits_qkv, st);
}

// The MLP half's activation-only backward: h1 = bf16(LN2(x2) W1) + bf16(bf1)
// recomputed into h1buf, dh1b = bf16((dy' W2^T) * gelu'(h1)), dm = dh1b W1^T
// (f32), dx2 = LN2^T(dm) rounded once. _mlp_dx_kernel (PARTIAL false): dy'
// = bf16(dy * ls2) and dx2 adds dy (the residual). _mlp_partial_dx_kernel
// (PARTIAL true, a tensor-parallel shard, hidden = 4D/tp): dy' = dy, the
// cotangent of the shard's partial product (already times ls2), no residual;
// ls2 is not read.
template <bool PARTIAL>
cudaError_t mlp_dx(const void* x2, const void* dy, const void* g2, const void* b2,
                   const void* w1, const void* bf1, const void* w2, const void* ls2, void* h1buf,
                   void* dh1b, void* dm, void* dx2, int M, int D, int hidden, float eps,
                   cudaStream_t st) {
  // The LayerNorm rows (bf16, M x D) go into dm's f32 buffer, which the
  // last product overwrites; once h1 is formed, bf16(dy * ls2) takes their
  // place there (_mlp_dx_kernel's scaled cotangent; a shard's dy is already
  // scaled).
  cudaError_t err = launch_ln_rows(x2, g2, b2, dm, M, D, eps, st);
  if (err != cudaSuccess) return err;
  err = launch_gemm<EPI_BIAS>(dm, w1, bf1, nullptr, nullptr, h1buf, M, hidden, D, st);
  if (err != cudaSuccess) return err;
  const void* dys = dy;
  if (!PARTIAL) {
    err = launch_scale_rows(dy, ls2, dm, M, D, st);
    if (err != cudaSuccess) return err;
    dys = dm;
  }
  err = launch_gemm_nt<EPT_GELU_GRAD>(dys, w2, h1buf, dh1b, M, hidden, D, st);
  if (err != cudaSuccess) return err;
  err = launch_gemm_nt<EPT_F32>(dh1b, w1, nullptr, dm, M, D, hidden, st);
  if (err != cudaSuccess) return err;
  const int rows_per_block = ROW_THREADS / 32;
  ln_bwd_rows_kernel<false, PARTIAL ? ROWS_NO_RES : ROWS_RESIDENT>
      <<<(M + rows_per_block - 1) / rows_per_block, ROW_THREADS, 0, st>>>(
          static_cast<const bf16*>(x2), static_cast<const bf16*>(dy),
          static_cast<const float*>(dm), static_cast<const float*>(g2), nullptr, nullptr,
          static_cast<bf16*>(dx2), nullptr, M, D, eps, rows_per_block);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The GEMM's tile plan for an (M, N) product (gemm_plan): 0 = 128 x 128,
// 1 = 64 x 128, 2 = 64 x 64.
int dp_gemm_plan(int M, int N) { return gemm_plan(M, N); }

// The chains' GEMM alone: out = epilogue(A @ W) with Epilogue mode epi.
int dp_gemm(const void* A, const void* W, const void* bias, const void* ls, const void* res,
            void* out, void* out2, int M, int N, int K, int epi, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (epi) {
#define DP_GEMM_CASE(E)                                                                      \
  case E:                                                                                    \
    err = launch_gemm<E>(A, W, bias, ls, res, out, M, N, K, st, out2);                        \
    break;
    DP_GEMM_CASE(EPI_BIAS)
    DP_GEMM_CASE(EPI_BIAS_GELU)
    DP_GEMM_CASE(EPI_BIAS_LS_RES)
    DP_GEMM_CASE(EPI_BIAS_GELU_PAIR)
    DP_GEMM_CASE(EPI_F32BIAS)
    DP_GEMM_CASE(EPI_F32BIAS_LS_RES)
    DP_GEMM_CASE(EPI_F32BIAS_LS_RES_H2)
    DP_GEMM_CASE(EPI_NONE)
#undef DP_GEMM_CASE
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// The chains' dx product alone: out = epilogue(A' W^T) with EpilogueNT epi,
// W stored (N, K); A' = A, or where scale is not null bf16(A * scale[k])
// formed first in scaled (M, K). With colsum_part not null also colsum (N)
// = the column sums before rounding, through colsum_part (ceil(M/64), N).
int dp_gemm_nt(const void* A, const void* W, const void* scale, void* scaled, const void* aux,
               void* out, void* colsum_part, void* colsum, int M, int N, int K, int epi,
               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaSuccess;
  if (scale != nullptr) {
    err = launch_scale_rows(A, scale, scaled, M, K, st);
    A = scaled;
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  switch (epi) {
    case EPT_GELU_GRAD:
      err = launch_gemm_nt<EPT_GELU_GRAD>(A, W, aux, out, M, N, K, st, colsum_part);
      break;
    case EPT_F32:
      err = launch_gemm_nt<EPT_F32>(A, W, aux, out, M, N, K, st, colsum_part);
      break;
    case EPT_BF16:
      err = launch_gemm_nt<EPT_BF16>(A, W, aux, out, M, N, K, st, colsum_part);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  if (err == cudaSuccess && colsum_part != nullptr)
    err = launch_sum_rows(colsum_part, (M + 63) / 64, N, colsum, st);
  return static_cast<int>(err);
}

// The chains' weight-gradient product alone: dw (Kin, N) = A^T G' in
// `splits` row splits (partials in ws (splits, Kin, N) when more than one),
// G' = G or bf16(G * scale[n]) formed first in scaled (M, N); with gsum not
// null also its column sums (N), through gsum_ws (splits * Kin/64, N).
int dp_gemm_tn(const void* A, const void* G, const void* scale, void* scaled, void* ws,
               void* gsum_ws, void* dw, void* gsum, int M, int Kin, int N, int splits,
               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (scale != nullptr) {
    cudaError_t err = launch_scale_rows(G, scale, scaled, M, N, st);
    if (err != cudaSuccess) return static_cast<int>(err);
    G = scaled;
  }
  return static_cast<int>(launch_gemm_tn(A, G, ws, gsum_ws, dw, gsum, M, Kin, N, splits, st));
}

// The weight-gradient product's tile plan (tn_plan): 0 = 128 x 128, 1 =
// 64 x 128, 2 = 64 x 64.
int dp_gemm_tn_plan(int Kin, int N) { return tn_plan(Kin, N); }

// The chains' LayerNorm rows alone: out (M, D) bf16 = LN(x) rounded once.
int dp_ln_rows(const void* x, const void* gamma, const void* beta, void* out, int M, int D,
               float eps, void* stream) {
  return static_cast<int>(
      launch_ln_rows(x, gamma, beta, out, M, D, eps, static_cast<cudaStream_t>(stream)));
}

// The chains' attention step alone on a packed qkv (B, S, 3*H*dh): the
// streamed kernel (flash != 0) or the resident one.
int dp_packed_attention(const void* qkv, void* ctx, int B, int S, int H, int dh, int flash,
                        void* stream) {
  return static_cast<int>(launch_attention(qkv, ctx, nullptr, B, S, H, dh, flash != 0,
                                           static_cast<cudaStream_t>(stream)));
}
// The chains' attention backward alone: dqkv (B, S, 3*H*dh) from qkv and
// dctx (B, S, H*dh). Streamed (flash != 0): the streamed forward first, for
// the row statistics it writes to stats (its output into ctx, scratch
// (B, S, H*dh)), then the streamed pair, as the backward chains run them;
// else the resident pair, which writes the statistics and reads them back.
// stats: (B, H, 3, S) f32.
int dp_packed_attention_bwd(const void* qkv, const void* dctx, void* ctx, void* stats,
                            void* dqkv, int B, int S, int H, int dh, int flash, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (flash) {
    cudaError_t err = launch_attention(qkv, ctx, stats, B, S, H, dh, true, st);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(launch_attn_bwd(qkv, dctx, stats, dqkv, B, S, H, dh, flash != 0, st));
}
// 1 when the chains' attention forward (backward) at (S, dh) takes the
// streamed kernels of flash_kernels.cu, 0 when the resident ones.
int dp_flash_forward(int S, int dh) { return flash_forward(S, dh) ? 1 : 0; }
int dp_flash_backward(int S, int dh) { return flash_backward(S, dh) ? 1 : 0; }
// The keys the resident kernels compute scores for at (S, dh): 16 * the
// instantiation's key groups (its executed FLOPs).
int dp_attention_keys(int S, int dh) { return 16 * key_groups(S, dh); }

// _block_kernel: y = x2 + ls2*MLP(LN2(x2)), x2 = x + ls1*(Wo MHA(LN1(x)) + bo).
int dp_fused_block(const void* x, const void* g1, const void* b1, const void* wqkv,
                   const void* bqkv, const void* wo, const void* bo, const void* ls1,
                   const void* g2, const void* b2, const void* w1, const void* bf1,
                   const void* w2, const void* bf2, const void* ls2, void* qkv, void* ctx,
                   void* x2, void* hbuf, void* y, int B, int S, int D, int H, int hidden,
                   float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = attn_half<EPI_BIAS_LS_RES>(x, g1, b1, wqkv, bqkv, wo, bo, ls1, qkv, ctx,
                                               x2, B, S, D, D, H, eps, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(mlp_half<EPI_BIAS_LS_RES>(x2, g2, b2, w1, bf1, w2, bf2, ls2, hbuf, y,
                                                    B * S, D, hidden, eps, st));
}

// _attn_part_kernel: o = Wo MHA(LN1(x) Wqkv + bqkv) + bo (no LayerScale).
int dp_fused_attn_part(const void* x, const void* g1, const void* b1, const void* wqkv,
                       const void* bqkv, const void* wo, const void* bo, void* qkv, void* ctx,
                       void* out, int B, int S, int D, int H, float eps, void* stream) {
  return static_cast<int>(attn_half<EPI_BIAS>(x, g1, b1, wqkv, bqkv, wo, bo, nullptr, qkv, ctx,
                                              out, B, S, D, D, H, eps,
                                              static_cast<cudaStream_t>(stream)));
}

// _mlp_part_kernel: y = x2 + ls2*(W2 gelu(W1 LN2(x2) + bf1) + bf2).
int dp_fused_mlp_part(const void* x2, const void* g2, const void* b2, const void* w1,
                      const void* bf1, const void* w2, const void* bf2, const void* ls2,
                      void* hbuf, void* y, int M, int D, int hidden, float eps, void* stream) {
  return static_cast<int>(mlp_half<EPI_BIAS_LS_RES>(x2, g2, b2, w1, bf1, w2, bf2, ls2, hbuf, y,
                                                    M, D, hidden, eps,
                                                    static_cast<cudaStream_t>(stream)));
}

// _attn_stream_kernel (block.py:1807): o = bf16(Wo MHA(LN1(x) Wqkv + bqkv) + bo),
// the out-projection summed and biased in f32. The TPU kernel streams
// per-head-group weight slices through VMEM; here every GEMM already walks
// its weights in 32x64 tiles through shared memory, so the chain is
// _attn_part_kernel's with the f32 epilogue.
int dp_fused_attn_part_stream(const void* x, const void* g1, const void* b1, const void* wqkv,
                              const void* bqkv, const void* wo, const void* bo, void* qkv,
                              void* ctx, void* out, int B, int S, int D, int H, float eps,
                              void* stream) {
  return static_cast<int>(attn_half<EPI_F32BIAS>(x, g1, b1, wqkv, bqkv, wo, bo, nullptr, qkv,
                                                 ctx, out, B, S, D, D, H, eps,
                                                 static_cast<cudaStream_t>(stream)));
}

// _mlp_stream_kernel (block.py:1636): y = x2 + bf16((W2 gelu(W1 LN2(x2) + bf1)
// + bf2) * ls2), fc2 summed, biased and scaled in f32 (the TPU kernel's f32
// accumulator over streamed hidden blocks).
int dp_fused_mlp_part_stream(const void* x2, const void* g2, const void* b2, const void* w1,
                             const void* bf1, const void* w2, const void* bf2, const void* ls2,
                             void* hbuf, void* y, int M, int D, int hidden, float eps,
                             void* stream) {
  return static_cast<int>(mlp_half<EPI_F32BIAS_LS_RES>(x2, g2, b2, w1, bf1, w2, bf2, ls2, hbuf,
                                                       y, M, D, hidden, eps,
                                                       static_cast<cudaStream_t>(stream)));
}

// _mlp_stream_train_kernel (block.py:1695): dp_fused_mlp_part_stream's y, and
// h2 = bf16(W2 gelu(W1 LN2(x2) + bf1) + bf2) (M, D), the pre-LayerScale
// output the streamed backward reads, written by the same fc2 epilogue.
int dp_fused_mlp_part_stream_train(const void* x2, const void* g2, const void* b2,
                                   const void* w1, const void* bf1, const void* w2,
                                   const void* bf2, const void* ls2, void* hbuf, void* h2,
                                   void* y, int M, int D, int hidden, float eps, void* stream) {
  return static_cast<int>(mlp_half<EPI_F32BIAS_LS_RES_H2>(x2, g2, b2, w1, bf1, w2, bf2, ls2,
                                                          hbuf, y, M, D, hidden, eps,
                                                          static_cast<cudaStream_t>(stream), h2));
}

// _mlp_dx_kernel: dx2 = dy + LN2^T(W1^T(gelu'(h1) * W2^T(dy*ls2))), no weight
// gradients. h1 = bf16(LN2(x2) W1) + bf16(bf1) is recomputed into h1buf
// (M, hidden) bf16; dh1b (M, hidden) bf16 and dm (M, D) f32 are scratch.
int dp_fused_mlp_dx(const void* x2, const void* dy, const void* g2, const void* b2,
                    const void* w1, const void* bf1, const void* w2, const void* bf2,
                    const void* ls2, void* h1buf, void* dh1b, void* dm, void* dx2, int M,
                    int D, int hidden, float eps, void* stream) {
  (void)bf2;  // the fc2 bias has no part in dx2
  return static_cast<int>(mlp_dx<false>(x2, dy, g2, b2, w1, bf1, w2, ls2, h1buf, dh1b, dm, dx2,
                                         M, D, hidden, eps, static_cast<cudaStream_t>(stream)));
}

// _mlp_bwd_kernel: dx2 and every MLP weight gradient, summed in f32 over the
// M rows. Recomputed into scratch: m = LN2(x2) (M, D), h1 and g = gelu(h1)
// (M, hidden), h2 (M, D), all bf16 at JAX's rounding points; dh1b
// (M, hidden) bf16 and dm (M, D) f32 as in _mlp_dx_kernel. Partials:
// colsum_part (ceil(M/64), hidden), row_part (ceil(M/64), 4, D), ws1
// (splits1, D, hidden), ws2 (splits2, hidden, D) (not read for one split).
// Outputs f32: dw1 (D, hidden), dbf1 (hidden), dw2 (hidden, D), vec4 (4, D)
// = dbf2 | dls2 | dg2 | db2.
int dp_fused_mlp_bwd(const void* x2, const void* dy, const void* g2, const void* b2,
                     const void* w1, const void* bf1, const void* w2, const void* bf2,
                     const void* ls2, void* m, void* h1, void* g, void* h2, void* dh1b, void* dm,
                     void* colsum_part, void* row_part, void* ws1, void* ws2, void* dx2,
                     void* dw1, void* dbf1, void* dw2, void* vec4, int M, int D, int hidden,
                     int splits1, int splits2, float eps, void* stream) {
  return static_cast<int>(mlp_bwd<false>(x2, dy, g2, b2, w1, bf1, w2, bf2, ls2, m, h1, g, h2,
                                         dh1b, dm, colsum_part, row_part, ws1, ws2, dx2, dw1,
                                         dbf1, dw2, vec4, M, D, hidden, splits1, splits2, eps,
                                         static_cast<cudaStream_t>(stream)));
}

// _mlp_stream_dx_full_kernel (block.py:1726) + _mlp_stream_dw_kernel (:1770),
// the trainable streamed MLP half's backward: dp_fused_mlp_bwd's chain and
// arguments with h2 the forward's saved pre-LayerScale output (read, not
// recomputed) and vec4 = sum(dy) | dls2 | dg2 | db2; dbf2 = ls2 * sum(dy) is
// the caller's. The TPU pair streams (D, bh) and (bh, D) weight blocks and
// keeps each dW block resident over a row sweep; here the GEMMs walk the
// weights in tiles and dW sums fixed-order f32 partials over row splits.
int dp_fused_mlp_bwd_stream(const void* x2, const void* dy, const void* g2, const void* b2,
                            const void* w1, const void* bf1, const void* w2, const void* bf2,
                            const void* ls2, void* m, void* h1, void* g, const void* h2,
                            void* dh1b, void* dm, void* colsum_part, void* row_part, void* ws1,
                            void* ws2, void* dx2, void* dw1, void* dbf1, void* dw2, void* vec4,
                            int M, int D, int hidden, int splits1, int splits2, float eps,
                            void* stream) {
  return static_cast<int>(mlp_bwd<true>(x2, dy, g2, b2, w1, bf1, w2, bf2, ls2, m, h1, g,
                                        const_cast<void*>(h2), dh1b, dm, colsum_part, row_part,
                                        ws1, ws2, dx2, dw1, dbf1, dw2, vec4, M, D, hidden,
                                        splits1, splits2, eps,
                                        static_cast<cudaStream_t>(stream)));
}

// _attn_bwd_kernel: dx and every attention weight gradient, summed in f32
// over the B*S rows. Recomputed into scratch (bf16): a = LN1(x) (M, D), qkv
// (M, 3D), ctx (M, D), o = ctx Wo + bo (M, D, before LayerScale); then dctx
// (M, D) and dqkv (M, 3D) bf16, da (M, D) f32, stats (B, H, 3, S) f32.
// Partials: row_part (ceil(M/64), 4, D), ws_qkv (splits_qkv, D, 3D), ws_o
// (splits_o, D, D) (not read for one split), gsum_part (splits_qkv * D/64,
// 3D).
// Outputs f32: dwqkv (D, 3D), dbqkv (3D), dwo (D, D), vec4 (4, D) = dbo |
// dls1 | dg1 | db1.
int dp_fused_attn_bwd(const void* x, const void* dx2, const void* g1, const void* b1,
                      const void* wqkv, const void* bqkv, const void* wo, const void* bo,
                      const void* ls1, void* a, void* qkv, void* ctx, void* o, void* dctx,
                      void* dqkv, void* da, void* stats, void* row_part, void* ws_qkv,
                      void* ws_o, void* gsum_part, void* dx, void* dwqkv, void* dbqkv,
                      void* dwo, void* vec4, int B, int S, int D, int H, int splits_qkv,
                      int splits_o, float eps, void* stream) {
  return static_cast<int>(attn_bwd<false>(x, dx2, g1, b1, wqkv, bqkv, wo, bo, ls1, a, qkv, ctx,
                                          o, dctx, dqkv, da, stats, row_part, ws_qkv, ws_o,
                                          gsum_part, dx, dwqkv, dbqkv, dwo, vec4, B, S, D, H,
                                          splits_qkv, splits_o, eps,
                                          static_cast<cudaStream_t>(stream)));
}

// _attn_stream_dx_kernel (block.py:1924) + _attn_stream_dw_kernel (:1973),
// the trainable streamed attention half's backward under its pre-LayerScale
// contract: do (B, S, D) bf16 is the cotangent of o = attn(x) itself (the
// LayerScale and the residual live in the caller's stitch). dp_fused_attn_bwd's
// chain without the o recompute and without a residual: dx = LN1^T(da),
// vec4 = dbo | 0 | dg1 | db1 with dbo = sum(do), dWo = ctx^T do. The TPU pair
// streams per-head-group q/k/v column and out-projection row slices; here
// the GEMMs walk the weights in tiles.
int dp_fused_attn_bwd_stream(const void* x, const void* dout, const void* g1, const void* b1,
                             const void* wqkv, const void* bqkv, const void* wo, const void* bo,
                             void* a, void* qkv, void* ctx, void* dctx, void* dqkv, void* da,
                             void* stats, void* row_part, void* ws_qkv, void* ws_o,
                             void* gsum_part, void* dx, void* dwqkv, void* dbqkv, void* dwo,
                             void* vec4, int B, int S, int D, int H, int splits_qkv,
                             int splits_o, float eps, void* stream) {
  return static_cast<int>(attn_bwd<true>(x, dout, g1, b1, wqkv, bqkv, wo, bo, nullptr, a, qkv,
                                         ctx, nullptr, dctx, dqkv, da, stats, row_part, ws_qkv,
                                         ws_o, gsum_part, dx, dwqkv, dbqkv, dwo, vec4, B, S, D, H,
                                         splits_qkv, splits_o, eps,
                                         static_cast<cudaStream_t>(stream)));
}

// _attn_part_partial_kernel (block.py:1010): one tensor-parallel shard's
// attention half, o_l = bf16(MHA_l(LN1(x) Wqkv_l + bqkv_l) Wo_l) with no bias
// (bo is added once after the all-reduce). x (B, S, D); wqkv (D, 3Dl) laid out
// [q_l | k_l | v_l], bqkv (3Dl); wo (Dl, D); H the shard's Dl/dh heads. The
// TPU kernel runs _attn_part_kernel's body on the shard's weights in VMEM;
// here the resident chain runs at the local widths: qkv (B*S, 3Dl) and ctx
// (B*S, Dl) scratch, out (B, S, D).
int dp_fused_attn_part_partial(const void* x, const void* g1, const void* b1, const void* wqkv,
                               const void* bqkv, const void* wo, void* qkv, void* ctx, void* out,
                               int B, int S, int D, int Dl, int H, float eps, void* stream) {
  return static_cast<int>(attn_half<EPI_NONE>(x, g1, b1, wqkv, bqkv, wo, nullptr, nullptr, qkv,
                                              ctx, out, B, S, D, Dl, H, eps,
                                              static_cast<cudaStream_t>(stream)));
}

// _mlp_part_partial_kernel (block.py:1062): one shard's MLP half,
// bf16(gelu(bf16(LN2(x2) W1_l) + bf16(bf1_l)) W2_l) with no bias, LayerScale
// or residual. w1 (D, hidden), w2 (hidden, D) at the shard's hidden = 4D/tp;
// hbuf (M, hidden) scratch.
int dp_fused_mlp_part_partial(const void* x2, const void* g2, const void* b2, const void* w1,
                              const void* bf1, const void* w2, void* hbuf, void* out, int M,
                              int D, int hidden, float eps, void* stream) {
  return static_cast<int>(mlp_half<EPI_NONE>(x2, g2, b2, w1, bf1, w2, nullptr, nullptr, hbuf,
                                             out, M, D, hidden, eps,
                                             static_cast<cudaStream_t>(stream)));
}

// _mlp_partial_dx_kernel (block.py:1099): dx2 of one shard's MLP half with its
// weights held fixed, dx2 = LN2^T(W1_l^T(gelu'(h1) * W2_l^T dp)): dp (M, D)
// is the cotangent of the shard's partial product, already times ls2, and the
// residual's term is added outside. Scratch as dp_fused_mlp_dx's, at the
// shard's hidden width.
int dp_fused_mlp_partial_dx(const void* x2, const void* dp, const void* g2, const void* b2,
                            const void* w1, const void* bf1, const void* w2, void* h1buf,
                            void* dh1b, void* dm, void* dx2, int M, int D, int hidden, float eps,
                            void* stream) {
  return static_cast<int>(mlp_dx<true>(x2, dp, g2, b2, w1, bf1, w2, nullptr, h1buf, dh1b, dm,
                                        dx2, M, D, hidden, eps,
                                        static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
