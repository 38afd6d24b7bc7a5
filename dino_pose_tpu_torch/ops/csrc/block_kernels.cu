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
//   gemm_nt_kernel<SCALE, EPI>  the same tile with W read transposed (the
//                          backward products), an optional per-column scale
//                          prologue, a *gelu'(h), raw-f32 or bf16 epilogue,
//                          and optional per-tile f32 column sums.
//   gemm_tn_kernel<SCALE, GSUM>  the weight-gradient product
//                          dW = A^T @ G, reducing over the M = B*S rows: M is
//                          split over blocks into f32 partials that
//                          sum_rows_kernel adds in a fixed order.
//   attention_kernel<DH>   one (batch, head, 64-query tile) per block: K and V
//                          of all S keys for the head stay in shared memory,
//                          f32 scores and softmax, P rounded to bf16 before PV.
//   attn_bwd_dq_kernel<DH>, attn_bwd_dkv_kernel<DH>  the attention backward,
//                          FlashAttention-2 style: per query tile dq and the
//                          softmax statistics, then per key tile dk and dv.
//   The resident K/V (or Q/dO) hold S up to ~320 (dh = 64). Past that the
//   attention step of every chain launches the streamed kernels of
//   flash_kernels.cu instead (dp_flash::launch_fwd / launch_bwd): a choice
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
//   _mlp_dx_kernel    = ln_rows -> gemm<BIAS>(h1) -> gemm_nt<dy*ls2, *gelu'(h1)>
//                       (dh1b) -> gemm_nt<-, f32>(dm) -> ln_bwd_rows(dx2)
//   _mlp_bwd_kernel   = ln_rows(m) -> gemm<BIAS,GELU pair>(h1, g)
//                       -> gemm<BIAS>(h2) -> gemm_nt<dy*ls2,*gelu'(h1),sums>
//                       (dh1b, dbf1) -> gemm_nt<-,f32>(dm) -> ln_bwd_rows<sums>
//                       (dx2, dbf2, dls2, dg2, db2) -> gemm_tn(dW1 = m^T dh1b)
//                       -> gemm_tn<*ls2>(dW2 = g^T bf16(dy*ls2))
//   _attn_bwd_kernel  = ln_rows(a) -> gemm<BIAS>(qkv) -> attention(ctx)
//                       -> gemm<BIAS>(o) -> gemm_nt<dx2*ls1,bf16>(dctx)
//                       -> attn_bwd_dq -> attn_bwd_dkv (dqkv)
//                       -> gemm_nt<-,f32>(da) -> ln_bwd_rows<sums>(dx, dbo,
//                       dls1, dg1, db1) -> gemm_tn<colsums>(dWqkv, dbqkv)
//                       -> gemm_tn<*ls1>(dWo = ctx^T bf16(dx2*ls1))
//   _mlp_stream_train_kernel = ln_rows -> gemm<GELU>(fc1)
//                       -> gemm<F32BIAS_LS_RES_H2>(fc2, h2)
//   _mlp_stream_dx_full_kernel + _mlp_stream_dw_kernel = _mlp_bwd_kernel's
//                       chain without the h2 GEMM (h2 saved by the forward),
//                       ln_bwd_rows<sums, UNSCALED> (dbf2 = ls2 * sum(dy))
//   _attn_stream_dx_kernel + _attn_stream_dw_kernel = _attn_bwd_kernel's chain
//                       without the o GEMM, on do (pre-LayerScale): gemm_nt<-,
//                       bf16>(dctx) ... ln_bwd_rows<sums, NO_RES>(dx, dbo = sum
//                       (do), dg1, db1) ... gemm_tn(dWo = ctx^T do)
//   _attn_part_partial_kernel = ln_rows -> gemm<BIAS>(qkv_l, N = 3D/tp)
//                       -> attention (H/tp heads) -> gemm<NONE>(out, K = D/tp)
//   _mlp_part_partial_kernel  = ln_rows -> gemm<GELU>(fc1, N = 4D/tp)
//                       -> gemm<NONE>(fc2)
//   _mlp_partial_dx_kernel    = ln_rows -> gemm<BIAS>(h1) -> gemm_nt<-,
//                       *gelu'(h1)>(dh1b) -> gemm_nt<-, f32>(dm)
//                       -> ln_bwd_rows<NO_RES>(dx2)
//
//   The forward halves put the normalised rows in their own output buffer
//   (the attention half's out, the MLP half's y), and the dx chains in dm's
//   f32 buffer: each is dead until a later launch of the chain overwrites
//   it, so the split costs no allocation. ln_rows_kernel is the old
//   prologue's arithmetic, so the GEMMs read the same bf16 rows as before.
//
// Every rounding point of the JAX kernels is reproduced: each product is
// rounded to bf16, then the bias (f32 parameter rounded to bf16) is added in
// bf16; LayerScale multiplies in bf16, the residual adds in bf16. In the
// backward, dy*ls2 and dh1b are rounded to bf16, the products dg and dm stay
// f32, dx2 is rounded once. dm goes through device memory as f32 (B*S*D*4
// bytes, 50 MB at batch 128) to a row kernel rather than into a GEMM
// epilogue: the LayerNorm backward needs whole rows, and a 64x64 tile holds
// a sixth of one. The dx chain is bound by its three products (0.909 GFLOP
// per image at S = 257, D = 384: 0.118 ms at batch 128 on an H100) from
// batch 2 up. The trainable block's backward keeps JAX's rounding points
// too: dh1, dy*ls2 and dx2*ls1 enter their bias sums unrounded, the bf16
// dqkv enters dbqkv, the probabilities stay f32 for dS; the residuals h1, g,
// h2, qkv, P, ctx and o are recomputed from (x, x2), as JAX saves nothing
// else. Weight gradients are sums over all B*S rows that the TPU kernel
// carries across its sequential batch grid; a CUDA grid has no order, so
// each block of rows writes f32 partials and one pass adds them in a fixed
// order (no atomics: two runs give the same bits).
//
// Shapes: M = B*S rows are masked at the ragged edge (no padding copy: TMA
// reads the rows and the K tail past the edge as zeros, the stores are
// masked); N is a multiple of 64, K of 32 (the wrapper checks D % 64 == 0).
// The GEMM's TMA tensor maps are encoded on the host at each launch with
// cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPointByVersion,
// so the library links without -lcuda. Kernels launch on the caller's
// stream, allocate nothing and never synchronise; each C entry returns
// cudaGetLastError() after its launches.

#include <cuda_bf16.h>
#include <cuda.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

#include "flash_kernels.cuh"

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int BM = 64, BN = 64, BK = 32;
constexpr int GEMM_THREADS = 128;  // 4 warps, each a 32x32 quarter of the tile
constexpr int PAD_H = 8;           // bf16 row padding (keeps WMMA ldm % 8 == 0)
constexpr int PAD_F = 4;           // f32 row padding
constexpr int BQ = 64;             // query rows per attention block
constexpr int ATTN_THREADS = 128;  // 4 warps, 16 query rows each
constexpr int ROW_THREADS = 128;   // 4 warps, one row each (LayerNorm rows)
constexpr int SUM_ROWS = 64;       // rows per block of the column-summing row kernel
constexpr int NSUMS = 4;           // column sums of ln_bwd_rows_kernel<true>

constexpr size_t MAX_SMEM = 232448;  // shared memory one Hopper block may use

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

// ---------------------------------------------------------------------------
// gemm_kernel<WG, TN, EPI>: C[M,N] = epilogue(A[M,K] @ W[K,N]), A, W, C, res
// row-major bf16, bias and ls f32 vectors. Warp-specialised for sm_90a:
// warpgroup WG (the last) is the producer, one thread of it issuing the TMA
// loads of A (TM x 64, K-major) and W (64 x TN, N-major: W is read as it is
// stored, never copied or transposed) into a GSTAGES-deep ring of
// 128-byte-swizzled tiles guarded by mbarriers; warpgroups 0..WG-1 are the
// consumers, each issuing wgmma.mma_async m64nTNk16 on 64 rows of the tile
// with f32 accumulators in registers, then the epilogue from those
// registers into swizzled shared memory, which TMA stores write out while
// the next tile's products run. Blocks are persistent: each walks output
// tiles (row-block major, so a row block's A stays in L2 across its column
// blocks) while the producer runs ahead into the next tile's stages.
// TM = 64*WG.
// EPI_BIAS_GELU_PAIR writes the biased product h to out and gelu(h) to out2.
// EPI_F32BIAS: bf16(acc + bias); EPI_F32BIAS_LS_RES: bf16(res + bf16((acc +
// bias) * ls)), in f32 up to the inner rounding; EPI_F32BIAS_LS_RES_H2 also
// writes h2 = bf16(acc + bias) to out2 (the pre-LayerScale output that
// _mlp_stream_train_kernel saves). EPI_NONE: bf16(acc); bias, ls and res are
// not read.
// ---------------------------------------------------------------------------

constexpr int GK = 64;           // K depth of a stage: one 128-byte swizzled bf16 row
constexpr int GSTAGES = 4;       // ring depth
constexpr int WG_THREADS = 128;  // a warpgroup

// EPI_BIAS_GELU_PAIR and EPI_F32BIAS_LS_RES_H2 write a second output.
__host__ __device__ constexpr bool two_outputs(int epi) {
  return epi == EPI_BIAS_GELU_PAIR || epi == EPI_F32BIAS_LS_RES_H2;
}

template <int WG, int TN, int EPI>
struct GemmPlan {
  static constexpr int TM = 64 * WG;
  static constexpr int A_BYTES = TM * GK * 2;
  static constexpr int B_BYTES = GK * TN * 2;
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr int THREADS = (WG + 1) * WG_THREADS;
  // Each consumer warpgroup stages its 64 x TN output (and the second one)
  // in TN/64 swizzled 64 x 64 boxes for the TMA stores.
  static constexpr int OUT_BYTES = 64 * TN * 2;
  static constexpr int OUTS = two_outputs(EPI) ? 2 : 1;
  // The ring, the staging buffers, then 2*GSTAGES mbarriers, and slack to
  // align the ring to the 1024 bytes a 128-byte swizzle pattern repeats over.
  static constexpr size_t SMEM = static_cast<size_t>(GSTAGES) * STAGE_BYTES +
                                 static_cast<size_t>(WG) * OUTS * OUT_BYTES + 2 * GSTAGES * 8 + 1024;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Spin until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// One 2-D TMA tile load (coordinates innermost first) that completes its
// bytes on the barrier; out-of-bounds elements arrive as zeros.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0,
                                         int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// One 2-D TMA tile store from shared memory (a bulk group); rows past the
// tensor's edge are not written.
__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void st_shared(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

// A barrier among the 128 threads of one warpgroup (ids 1 and 2; 0 is
// __syncthreads').
__device__ __forceinline__ void warpgroup_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled tile (layout type 1
// in bits 62-63): start address, leading and stride byte offsets, each >> 4.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma's issue and wait.
template <int R>
__device__ __forceinline__ void fence_acc(float* d) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D (64 x 64 f32, 32 registers a thread) += A (64 x 16, K-major) * B (16 x 64,
// N-major), both read from shared memory through their descriptors.
__device__ __forceinline__ void wgmma_n64(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// D (64 x 128 f32, 64 registers a thread) += A (64 x 16, K-major) * B (16 x 128,
// N-major), both read from shared memory through their descriptors.
__device__ __forceinline__ void wgmma_n128(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

template <int TN>
__device__ __forceinline__ void wgmma_tile(float* d, uint64_t da, uint64_t db) {
  if constexpr (TN == 128)
    wgmma_n128(d, da, db);
  else
    wgmma_n64(d, da, db);
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

template <int WG, int TN, int EPI>
__global__ void __launch_bounds__((WG + 1) * WG_THREADS, 1)
gemm_kernel(const __grid_constant__ CUtensorMap tma_a, const __grid_constant__ CUtensorMap tma_w,
            const __grid_constant__ CUtensorMap tma_out,
            const __grid_constant__ CUtensorMap tma_out2, const float* __restrict__ bias,
            const float* __restrict__ ls, const bf16* __restrict__ res, int M, int N, int K) {
  using P = GemmPlan<WG, TN, EPI>;
  constexpr bool TWO = two_outputs(EPI);
  extern __shared__ unsigned char gemm_smem[];
  // The ring starts at the first 1024-byte boundary: stage s holds A then W;
  // then each consumer warpgroup's staging buffers (out, then out2).
  const uint32_t base = (smem_addr(gemm_smem) + 1023u) & ~1023u;
  const uint32_t staging = base + GSTAGES * P::STAGE_BYTES;
  const uint32_t bars = staging + WG * P::OUTS * P::OUT_BYTES;  // full[s], then empty[s]
  const int wg = threadIdx.x / WG_THREADS;
  const int tiles_n = N / TN;
  const int tiles = (M + P::TM - 1) / P::TM * tiles_n;
  const int ktiles = (K + GK - 1) / GK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < GSTAGES; ++s) {
      mbar_init(bars + 8 * s, 1);                 // the producer's expect_tx
      mbar_init(bars + 8 * (GSTAGES + s), WG);    // one arrival per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == WG) {
    // Producer: one thread keeps the ring full across all of this block's
    // tiles. In the 128 x 128 plan (384 threads, 168 registers a thread at
    // entry) its warpgroup hands registers to the two consumers, which hold
    // 64 accumulators each; a 256-thread block already leaves its one
    // consumer enough.
    if (WG > 1) asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == WG * WG_THREADS) {
      int stage = 0;
      uint32_t phase = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int m0 = t / tiles_n * P::TM, n0 = t % tiles_n * TN;
        for (int kt = 0; kt < ktiles; ++kt) {
          const uint32_t full = bars + 8 * stage;
          mbar_wait(bars + 8 * (GSTAGES + stage), phase ^ 1);
          mbar_expect_tx(full, P::STAGE_BYTES);
          const uint32_t sa = base + stage * P::STAGE_BYTES, sb = sa + P::A_BYTES;
          tma_load(sa, &tma_a, full, kt * GK, m0);
#pragma unroll
          for (int h = 0; h < TN / 64; ++h) tma_load(sb + h * GK * 128, &tma_w, full, n0 + 64 * h, kt * GK);
          if (++stage == GSTAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // Consumers: warpgroup wg owns rows [64*wg, 64*wg + 64) of each tile.
    if (WG > 1) asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    constexpr int R = TN / 2;  // accumulators a thread
    float acc[R];
    const int lane = threadIdx.x & 31, wq = (threadIdx.x >> 5) & 3;
    const bool signal = (threadIdx.x & (WG_THREADS - 1)) == 0;
    const uint32_t out_s = staging + wg * P::OUTS * P::OUT_BYTES, out2_s = out_s + P::OUT_BYTES;
    int stage = 0;
    uint32_t phase = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int m0 = t / tiles_n * P::TM, n0 = t % tiles_n * TN;
#pragma unroll
      for (int i = 0; i < R; ++i) acc[i] = 0.f;
      int prev = -1;
      for (int kt = 0; kt < ktiles; ++kt) {
        mbar_wait(bars + 8 * stage, phase);
        const uint32_t sa = base + stage * P::STAGE_BYTES + wg * 64 * 128;
        const uint32_t sb = base + stage * P::STAGE_BYTES + P::A_BYTES;
        // A: 8-row groups 1024 bytes apart, k16 steps 32 bytes along the
        // swizzled row. W: N-major, 64-column blocks GK*128 bytes apart,
        // 8-row (k) groups 1024 bytes apart, k16 steps two such groups.
        const uint64_t da = sw128_desc(sa, 16, 1024);
        const uint64_t db = sw128_desc(sb, GK * 128, 1024);
        fence_acc<R>(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < GK / 16; ++kk)
          wgmma_tile<TN>(acc, da + static_cast<uint64_t>(2 * kk), db + static_cast<uint64_t>(128 * kk));
        wgmma_commit();
        fence_acc<R>(acc);
        wgmma_wait<1>();  // the previous stage's products are done: release it
        if (prev >= 0 && signal) mbar_arrive(bars + 8 * (GSTAGES + prev));
        prev = stage;
        if (++stage == GSTAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
      fence_acc<R>(acc);
      if (prev >= 0 && signal) mbar_arrive(bars + 8 * (GSTAGES + prev));
      // Epilogue: accumulator i of this thread is row 16*wq + lane/4 +
      // 8*((i/2)%2), column 8*(i/4) + 2*(lane%4) + i%2 of the warpgroup's
      // 64 x TN slice. Its bf16 pairs go into the staging buffers in the
      // tensor maps' 128-byte swizzle (16-byte chunk c of row r at chunk
      // c ^ (r % 8): the warp's eight rows hit distinct banks), then one
      // thread stores the slice by TMA, which overlaps the next tile's main
      // loop. Direct 4-byte stores in this layout cost as much as the
      // products at K = 384.
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
          const uint32_t off = (j / 8) * 64 * 128 + r * 128 + (((j % 8) ^ (r % 8)) * 16) + (lane & 3) * 4;
          st_shared(out_s + off, o);
          if (TWO) st_shared(out2_s + off, o2);
        }
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      warpgroup_sync(1 + wg);
      if (signal) {
#pragma unroll
        for (int h = 0; h < TN / 64; ++h) {
          tma_store(&tma_out, out_s + h * 64 * 128, n0 + 64 * h, m0 + wg * 64);
          if (TWO) tma_store(&tma_out2, out2_s + h * 64 * 128, n0 + 64 * h, m0 + wg * 64);
        }
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      }
    }
    if (signal) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  }
}

// C[M,N] = epilogue(A'[M,K] @ W[N,K]^T) for the backward products: W is a
// forward weight stored (in, out) = row-major (N, K), read transposed. The B
// tile is staged [n][k] in shared memory and loaded as a column-major WMMA
// operand. A' = A, or with SCALE each element bf16(f32(a) * scale[k]).
// EPT_GELU_GRAD: out bf16 = bf16(acc * gelu'(f32 aux[m, n])), aux bf16 (M, N);
// EPT_F32: out f32 = acc (not rounded); EPT_BF16: out bf16 = bf16(acc).
// With colsum, each block also writes the f32 column sums of its tile's
// epilogue values before rounding: colsum[blockIdx.y][n], (ceil(M/BM), N).
template <bool SCALE, int EPI>
__global__ void __launch_bounds__(GEMM_THREADS)
gemm_nt_kernel(const bf16* __restrict__ A, const bf16* __restrict__ W,
               const float* __restrict__ scale, const bf16* __restrict__ aux,
               void* __restrict__ out, float* __restrict__ colsum, int M, int N, int K) {
  constexpr int LDA = BK + PAD_H;  // As[m][k]
  constexpr int LDW = BK + PAD_H;  // Ws[n][k]
  constexpr int LDC = BN + PAD_F;
  __shared__ __align__(128) bf16 As[BM * LDA];
  __shared__ __align__(128) bf16 Ws[BN * LDW];
  __shared__ __align__(128) float Cs[BM * LDC];

  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int tid = threadIdx.x, warp = tid >> 5;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int i = tid; i < BM * BK / 8; i += GEMM_THREADS) {
      const int r = i / (BK / 8), c = (i % (BK / 8)) * 8;
      const int gm = m0 + r;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (gm < M) {
        v = *reinterpret_cast<const uint4*>(A + static_cast<size_t>(gm) * K + k0 + c);
        if (SCALE) {
          bf16* e = reinterpret_cast<bf16*>(&v);
#pragma unroll
          for (int j = 0; j < 8; ++j)
            e[j] = __float2bfloat16(__bfloat162float(e[j]) * scale[k0 + c + j]);
        }
      }
      *reinterpret_cast<uint4*>(As + r * LDA + c) = v;
    }
    for (int i = tid; i < BN * BK / 8; i += GEMM_THREADS) {
      const int r = i / (BK / 8), c = (i % (BK / 8)) * 8;
      *reinterpret_cast<uint4*>(Ws + r * LDW + c) =
          *reinterpret_cast<const uint4*>(W + static_cast<size_t>(n0 + r) * K + k0 + c);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bfr[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(af[i], As + (wm + 16 * i) * LDA + kk, LDA);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(bfr[j], Ws + (wn + 16 * j) * LDW + kk, LDW);
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
    if (gm >= M) {
      Cs[r * LDC + c] = 0.f;  // no part in the column sums
      continue;
    }
    float a = Cs[r * LDC + c];
    const size_t o = static_cast<size_t>(gm) * N + gn;
    if (EPI == EPT_GELU_GRAD) {
      const float z = __bfloat162float(aux[o]);
      const float g = 0.5f * (1.f + erff(z * 0.70710678118654752440f)) +
                      z * expf(-0.5f * z * z) * 0.3989422804014327f;
      a *= g;
      static_cast<bf16*>(out)[o] = __float2bfloat16(a);
    } else if (EPI == EPT_BF16) {
      static_cast<bf16*>(out)[o] = __float2bfloat16(a);
    } else {
      static_cast<float*>(out)[o] = a;
    }
    Cs[r * LDC + c] = a;  // each element belongs to this one thread
  }
  if (colsum != nullptr) {  // the same for the whole block
    __syncthreads();
    if (tid < BN) {
      float s = 0.f;
      for (int r = 0; r < BM; ++r) s += Cs[r * LDC + tid];
      colsum[static_cast<size_t>(blockIdx.y) * N + n0 + tid] = s;
    }
  }
}

// ws[split][Kin, N] = A[rows, Kin]^T @ G'[rows, N] over the split's rows
// [split*rps, min(M, (split+1)*rps)): the weight-gradient product. G' = G,
// or with SCALE each element bf16(f32(g) * scale[n]). Grid (N/BN, Kin/BM,
// splits); a split with no rows writes zeros. With GSUM the blocks of the
// first Kin tile also write the f32 column sums of G' over their rows to
// gsum[split][n]. A is staged [m][i] and loaded as a column-major WMMA
// operand, so no transposed copy is made.
template <bool SCALE, bool GSUM>
__global__ void __launch_bounds__(GEMM_THREADS)
gemm_tn_kernel(const bf16* __restrict__ A, const bf16* __restrict__ G,
               const float* __restrict__ scale, float* __restrict__ ws,
               float* __restrict__ gsum, int M, int Kin, int N, int rps) {
  constexpr int LDA = BM + PAD_H;  // As[m][i]
  constexpr int LDG = BN + PAD_H;  // Gs[m][n]
  __shared__ __align__(128) bf16 As[BK * LDA];
  __shared__ __align__(128) bf16 Gs[BK * LDG];

  const int n0 = blockIdx.x * BN, i0 = blockIdx.y * BM, split = blockIdx.z;
  const int mb = split * rps, me = min(M, mb + rps);
  const int tid = threadIdx.x, warp = tid >> 5;
  const bool sums = GSUM && blockIdx.y == 0 && tid < BN;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);
  const int wi = (warp >> 1) * 32, wn = (warp & 1) * 32;
  float gs = 0.f;

  for (int m0 = mb; m0 < me; m0 += BK) {
    for (int i = tid; i < BK * BM / 8; i += GEMM_THREADS) {
      const int r = i / (BM / 8), c = (i % (BM / 8)) * 8;
      uint4 v = zero;
      if (m0 + r < me)
        v = *reinterpret_cast<const uint4*>(A + static_cast<size_t>(m0 + r) * Kin + i0 + c);
      *reinterpret_cast<uint4*>(As + r * LDA + c) = v;
    }
    for (int i = tid; i < BK * BN / 8; i += GEMM_THREADS) {
      const int r = i / (BN / 8), c = (i % (BN / 8)) * 8;
      uint4 v = zero;
      if (m0 + r < me) {
        v = *reinterpret_cast<const uint4*>(G + static_cast<size_t>(m0 + r) * N + n0 + c);
        if (SCALE) {
          bf16* e = reinterpret_cast<bf16*>(&v);
#pragma unroll
          for (int j = 0; j < 8; ++j)
            e[j] = __float2bfloat16(__bfloat162float(e[j]) * scale[n0 + c + j]);
        }
      }
      *reinterpret_cast<uint4*>(Gs + r * LDG + c) = v;
    }
    __syncthreads();
    if (sums)
      for (int r = 0; r < BK; ++r) gs += __bfloat162float(Gs[r * LDG + tid]);
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> af[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfr[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(af[i], As + kk * LDA + wi + 16 * i, LDA);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(bfr[j], Gs + kk * LDG + wn + 16 * j, LDG);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], af[i], bfr[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* dst = ws + static_cast<size_t>(split) * Kin * N;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(dst + static_cast<size_t>(i0 + wi + 16 * i) * N + n0 + wn + 16 * j,
                              acc[i][j], N, wmma::mem_row_major);
  if (sums) gsum[static_cast<size_t>(split) * N + n0 + tid] = gs;
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

// Attention backward (the per-head loop of _attn_bwd_kernel, block.py:383-397):
//   P = softmax(Q K^T * scale) (f32), dP = dO V^T (f32),
//   dS = P * (dP - rowsum(P * dP)),
//   dq = bf16(bf16(dS) K * scale), dk = bf16(bf16(dS)^T Q * scale),
//   dv = bf16(bf16(P)^T dO),
// dO being the head's slice of dctx. dk and dv sum over all queries, so the
// work is split FlashAttention-2 style: attn_bwd_dq_kernel takes one query
// tile with K and V resident and writes dq and the row statistics (max,
// sum, rowsum(P*dP)); attn_bwd_dkv_kernel takes one key tile with Q and dO
// resident, rebuilds P and dS from those statistics, and writes dk and dv.
// Keys and queries >= S get P = dS = 0 (the forward's masking; no padding
// copy). stats: (B, H, 3, S) f32. dqkv: (B, S, 3D) bf16, q|k|v as qkv.
size_t attn_bwd_smem_bytes(int S, int dh) {
  const int sp = (S + 15) / 16 * 16;
  const int ldh = dh + PAD_H;
  const size_t seq = align128(static_cast<size_t>(sp) * ldh * 2);
  const size_t tile = align128(static_cast<size_t>(BQ) * ldh * 2);
  const size_t pb = align128(static_cast<size_t>(BQ) * (sp + PAD_H) * 2);
  const size_t warps = ATTN_THREADS / 32;
  const size_t dq = 2 * seq + 2 * tile + align128(static_cast<size_t>(BQ) * (sp + PAD_F) * 4) +
                    pb + align128(warps * 256 * 4);
  const size_t dkv = 2 * seq + 2 * tile + 2 * pb + align128(warps * 2 * 256 * 4) +
                     align128(static_cast<size_t>(3) * sp * 4);
  return dq > dkv ? dq : dkv;
}

// Grid (ceil(S/BQ), H, B). Each warp owns 16 query rows of the tile.
template <int DH>
__global__ void __launch_bounds__(ATTN_THREADS)
attn_bwd_dq_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ dctx,
                   float* __restrict__ stats, bf16* __restrict__ dqkv, int S, int H,
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
  bf16* Os = reinterpret_cast<bf16*>(smem + off);  // dO tile
  off += align128(static_cast<size_t>(BQ) * LDH * 2);
  float* Ss = reinterpret_cast<float*>(smem + off);  // scores, then P (f32)
  off += align128(static_cast<size_t>(BQ) * lds * 4);
  bf16* Ps = reinterpret_cast<bf16*>(smem + off);  // bf16(dS)
  off += align128(static_cast<size_t>(BQ) * ldp * 2);
  float* Sc = reinterpret_cast<float*>(smem + off);  // 16x16 f32 per warp

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * BQ;
  const int D = H * DH, row = 3 * D;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const bf16* base = qkv + static_cast<size_t>(b) * S * row;
  const bf16* dbase = dctx + static_cast<size_t>(b) * S * D;
  float* st = stats + (static_cast<size_t>(b) * H + h) * 3 * S;
  constexpr int VPR = DH / 8;
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
    uint4 qv = zero, ov = zero;
    if (q0 + r < S) {
      qv = *reinterpret_cast<const uint4*>(base + static_cast<size_t>(q0 + r) * row + h * DH + c);
      ov = *reinterpret_cast<const uint4*>(dbase + static_cast<size_t>(q0 + r) * D + h * DH + c);
    }
    *reinterpret_cast<uint4*>(Qs + r * LDH + c) = qv;
    *reinterpret_cast<uint4*>(Os + r * LDH + c) = ov;
  }
  __syncthreads();

  // Scores and softmax exactly as attention_kernel, P kept in f32.
  const int wr = warp * 16;
  {
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
  }
  __syncwarp();
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
    __syncwarp();
    for (int c = lane; c < sp; c += 32) srow[c] = c < S ? srow[c] / sum : 0.f;
    if (lane == 0 && q0 + r < S) {
      st[q0 + r] = mx;
      st[S + q0 + r] = sum;
    }
  }
  __syncwarp();

  // dP = dO V^T, 16 keys at a time through this warp's scratch tile, twice:
  // first for rowsum(P * dP), then for dS. Lane pair (2j, 2j+1) owns row j
  // of the tile, eight columns each.
  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> of[DH / 16];
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk)
    wmma::load_matrix_sync(of[kk], Os + wr * LDH + kk * 16, LDH);
  float* sc = Sc + warp * 256;
  const int tr = lane >> 1, tc = (lane & 1) * 8;
  const float* prow = Ss + (wr + tr) * lds;
  float rt = 0.f;
  for (int pass = 0; pass < 2; ++pass) {
    for (int n = 0; n < sp; n += 16) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> vf;
        wmma::load_matrix_sync(vf, Vs + n * LDH + kk * 16, LDH);
        wmma::mma_sync(acc, of[kk], vf, acc);
      }
      wmma::store_matrix_sync(sc, acc, 16, wmma::mem_row_major);
      __syncwarp();
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p = prow[n + tc + j], dp = sc[tr * 16 + tc + j];
        if (pass == 0)
          rt += p * dp;
        else
          Ps[(wr + tr) * ldp + n + tc + j] = __float2bfloat16(p * (dp - rt));
      }
      __syncwarp();
    }
    if (pass == 0) {
      rt += __shfl_xor_sync(0xffffffffu, rt, 1);
      if ((lane & 1) == 0 && q0 + wr + tr < S) st[2 * S + q0 + wr + tr] = rt;
    }
  }
  __syncwarp();

  // dq = bf16(dS) K * scale, staged through this warp's rows of Ss.
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> qacc[DH / 16];
#pragma unroll
  for (int j = 0; j < DH / 16; ++j) wmma::fill_fragment(qacc[j], 0.f);
  for (int k = 0; k < sp; k += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> dsf;
    wmma::load_matrix_sync(dsf, Ps + wr * ldp + k, ldp);
#pragma unroll
    for (int j = 0; j < DH / 16; ++j) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> kf;
      wmma::load_matrix_sync(kf, Ks + k * LDH + j * 16, LDH);
      wmma::mma_sync(qacc[j], dsf, kf, qacc[j]);
    }
  }
  __syncwarp();
#pragma unroll
  for (int j = 0; j < DH / 16; ++j)
    wmma::store_matrix_sync(Ss + wr * lds + j * 16, qacc[j], lds, wmma::mem_row_major);
  __syncwarp();
  for (int i = lane; i < 16 * DH; i += 32) {
    const int r = i / DH, c = i % DH;
    const int q = q0 + wr + r;
    if (q < S)
      dqkv[(static_cast<size_t>(b) * S + q) * row + h * DH + c] =
          __float2bfloat16(Ss[(wr + r) * lds + c] * scale);
  }
}

// Grid (ceil(S/BQ), H, B) over key tiles. Each warp owns 16 keys of the tile
// and walks all queries 16 at a time: S^T = K Q^T and dP^T = V dO^T in its
// scratch tiles, then P^T and dS^T (bf16) into shared rows; at the end
// dv = P^T dO and dk = dS^T Q * scale for its 16 keys.
template <int DH>
__global__ void __launch_bounds__(ATTN_THREADS)
attn_bwd_dkv_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ dctx,
                    const float* __restrict__ stats, bf16* __restrict__ dqkv, int S, int H,
                    float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int sp = (S + 15) / 16 * 16;
  constexpr int LDH = DH + PAD_H;
  const int ldp = sp + PAD_H;
  size_t off = 0;
  bf16* Qs = reinterpret_cast<bf16*>(smem + off);
  off += align128(static_cast<size_t>(sp) * LDH * 2);
  bf16* Os = reinterpret_cast<bf16*>(smem + off);  // dO, all queries
  off += align128(static_cast<size_t>(sp) * LDH * 2);
  bf16* Kt = reinterpret_cast<bf16*>(smem + off);
  off += align128(static_cast<size_t>(BQ) * LDH * 2);
  bf16* Vt = reinterpret_cast<bf16*>(smem + off);
  off += align128(static_cast<size_t>(BQ) * LDH * 2);
  bf16* Pt = reinterpret_cast<bf16*>(smem + off);  // bf16(P)^T, [key][query]
  off += align128(static_cast<size_t>(BQ) * ldp * 2);
  bf16* Dt = reinterpret_cast<bf16*>(smem + off);  // bf16(dS)^T
  off += align128(static_cast<size_t>(BQ) * ldp * 2);
  float* Sc = reinterpret_cast<float*>(smem + off);  // two 16x16 f32 per warp
  off += align128(static_cast<size_t>(ATTN_THREADS / 32) * 2 * 256 * 4);
  float* St = reinterpret_cast<float*>(smem + off);  // max | sum | rowsum(P dP)

  const int b = blockIdx.z, h = blockIdx.y, k0 = blockIdx.x * BQ;
  const int D = H * DH, row = 3 * D;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const bf16* base = qkv + static_cast<size_t>(b) * S * row;
  const bf16* dbase = dctx + static_cast<size_t>(b) * S * D;
  const float* st = stats + (static_cast<size_t>(b) * H + h) * 3 * S;
  constexpr int VPR = DH / 8;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

  for (int i = tid; i < sp * VPR; i += ATTN_THREADS) {
    const int r = i / VPR, c = (i % VPR) * 8;
    uint4 qv = zero, ov = zero;
    if (r < S) {
      qv = *reinterpret_cast<const uint4*>(base + static_cast<size_t>(r) * row + h * DH + c);
      ov = *reinterpret_cast<const uint4*>(dbase + static_cast<size_t>(r) * D + h * DH + c);
    }
    *reinterpret_cast<uint4*>(Qs + r * LDH + c) = qv;
    *reinterpret_cast<uint4*>(Os + r * LDH + c) = ov;
  }
  for (int i = tid; i < BQ * VPR; i += ATTN_THREADS) {
    const int r = i / VPR, c = (i % VPR) * 8;
    uint4 kv = zero, vv = zero;
    if (k0 + r < S) {
      const bf16* p = base + static_cast<size_t>(k0 + r) * row + h * DH + c;
      kv = *reinterpret_cast<const uint4*>(p + D);
      vv = *reinterpret_cast<const uint4*>(p + 2 * D);
    }
    *reinterpret_cast<uint4*>(Kt + r * LDH + c) = kv;
    *reinterpret_cast<uint4*>(Vt + r * LDH + c) = vv;
  }
  for (int i = tid; i < 3 * sp; i += ATTN_THREADS) {
    const int w = i / sp, q = i % sp;
    St[i] = q < S ? st[w * S + q] : 0.f;
  }
  __syncthreads();

  const int kr = warp * 16;
  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> kf[DH / 16], vf[DH / 16];
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    wmma::load_matrix_sync(kf[kk], Kt + kr * LDH + kk * 16, LDH);
    wmma::load_matrix_sync(vf[kk], Vt + kr * LDH + kk * 16, LDH);
  }
  float* s0 = Sc + warp * 512;
  float* s1 = s0 + 256;
  const int tr = lane >> 1, tc = (lane & 1) * 8;
  const bool key_ok = k0 + kr + tr < S;
  for (int i0 = 0; i0 < sp; i0 += 16) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> sacc, dacc;
    wmma::fill_fragment(sacc, 0.f);
    wmma::fill_fragment(dacc, 0.f);
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> qf, of;
      wmma::load_matrix_sync(qf, Qs + i0 * LDH + kk * 16, LDH);
      wmma::load_matrix_sync(of, Os + i0 * LDH + kk * 16, LDH);
      wmma::mma_sync(sacc, kf[kk], qf, sacc);
      wmma::mma_sync(dacc, vf[kk], of, dacc);
    }
    wmma::store_matrix_sync(s0, sacc, 16, wmma::mem_row_major);
    wmma::store_matrix_sync(s1, dacc, 16, wmma::mem_row_major);
    __syncwarp();
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int q = i0 + tc + j;
      float p = 0.f, ds = 0.f;
      if (key_ok && q < S) {
        p = expf(s0[tr * 16 + tc + j] * scale - St[q]) / St[sp + q];
        ds = p * (s1[tr * 16 + tc + j] - St[2 * sp + q]);
      }
      Pt[(kr + tr) * ldp + q] = __float2bfloat16(p);
      Dt[(kr + tr) * ldp + q] = __float2bfloat16(ds);
    }
    __syncwarp();
  }

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> vacc[DH / 16], kacc[DH / 16];
#pragma unroll
  for (int j = 0; j < DH / 16; ++j) {
    wmma::fill_fragment(vacc[j], 0.f);
    wmma::fill_fragment(kacc[j], 0.f);
  }
  for (int k = 0; k < sp; k += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> pf, df;
    wmma::load_matrix_sync(pf, Pt + kr * ldp + k, ldp);
    wmma::load_matrix_sync(df, Dt + kr * ldp + k, ldp);
#pragma unroll
    for (int j = 0; j < DH / 16; ++j) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> of, qf;
      wmma::load_matrix_sync(of, Os + k * LDH + j * 16, LDH);
      wmma::load_matrix_sync(qf, Qs + k * LDH + j * 16, LDH);
      wmma::mma_sync(vacc[j], pf, of, vacc[j]);
      wmma::mma_sync(kacc[j], df, qf, kacc[j]);
    }
  }
  // dk at columns D + h*DH, dv at 2D + h*DH, 16x16 at a time through s0.
  for (int j = 0; j < DH / 16; ++j) {
    for (int which = 0; which < 2; ++which) {
      __syncwarp();
      wmma::store_matrix_sync(s0, which == 0 ? kacc[j] : vacc[j], 16, wmma::mem_row_major);
      __syncwarp();
      const int key = k0 + kr + tr;
      if (key < S) {
        bf16* dst = dqkv + (static_cast<size_t>(b) * S + key) * row + (1 + which) * D + h * DH +
                    j * 16 + tc;
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float v = s0[tr * 16 + tc + e];
          dst[e] = __float2bfloat16(which == 0 ? v * scale : v);
        }
      }
    }
  }
}

// cuTensorMapEncodeTiled through the runtime's driver entry point, so that
// the library links without -lcuda (the runtime finds the driver it runs on).
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                              &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A row-major (outer, inner) bf16 matrix as TMA tiles of (box_outer,
// box_inner) elements, 128-byte swizzled (box_inner = 64).
bool encode_tiles(CUtensorMap* map, const void* base, int inner, int outer, int box_outer) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(inner), static_cast<cuuint64_t>(outer)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(inner) * 2};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(GK), static_cast<cuuint32_t>(box_outer)};
  const cuuint32_t step[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims, strides, box,
            step, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int sm_count() {
  static int count[64] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) return 132;
  if (count[dev] == 0) cudaDeviceGetAttribute(&count[dev], cudaDevAttrMultiProcessorCount, dev);
  return count[dev] > 0 ? count[dev] : 132;
}

// The tile plan of an (M, N) product: 0 = 128 x 128 (two consumer
// warpgroups) where those tiles fill the card; 1 = 64 x 128 where only 64-row
// tiles do; 2 = 64 x 64 otherwise (the batch-1 products), or where N is not a
// multiple of 128.
int gemm_plan(int M, int N) {
  const int sms = sm_count();
  if (N % 128 == 0 && (M + 127) / 128 * (N / 128) >= sms) return 0;
  if (N % 128 == 0 && (M + 63) / 64 * (N / 128) >= sms) return 1;
  return 2;
}

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
  static bool sized = false;  // the same value from every thread that races here
  if (!sized) {
    cudaError_t err = cudaFuncSetAttribute(gemm_kernel<WG, TN, EPI>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(P::SMEM));
    if (err != cudaSuccess) return err;
    sized = true;
  }
  const int tiles = (M + P::TM - 1) / P::TM * (N / TN);
  const int grid = tiles < sm_count() ? tiles : sm_count();
  gemm_kernel<WG, TN, EPI><<<grid, P::THREADS, P::SMEM, stream>>>(
      ta, tw, to, to2, static_cast<const float*>(bias), static_cast<const float*>(ls),
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

template <bool SCALE, int EPI>
cudaError_t launch_gemm_nt(const void* A, const void* W, const void* scale, const void* aux,
                           void* out, int M, int N, int K, cudaStream_t stream,
                           void* colsum = nullptr) {
  dim3 grid(N / BN, (M + BM - 1) / BM);
  gemm_nt_kernel<SCALE, EPI><<<grid, GEMM_THREADS, 0, stream>>>(
      static_cast<const bf16*>(A), static_cast<const bf16*>(W),
      static_cast<const float*>(scale), static_cast<const bf16*>(aux), out,
      static_cast<float*>(colsum), M, N, K);
  return cudaGetLastError();
}

// out[i] = sum over the first `rows` rows of part (rows, n), in order.
cudaError_t launch_sum_rows(const void* part, int rows, long long n, void* out,
                            cudaStream_t stream) {
  const long long blocks = (n + 255) / 256;
  sum_rows_kernel<<<static_cast<int>(blocks < 4096 ? blocks : 4096), 256, 0, stream>>>(
      static_cast<const float*>(part), rows, n, static_cast<float*>(out));
  return cudaGetLastError();
}

// dW[Kin, N] = A[M, Kin]^T @ G'[M, N] through `splits` f32 partials in ws
// (splits, Kin, N); with GSUM also gsum_out[N] = column sums of G' through
// gsum_ws (splits, N).
template <bool SCALE, bool GSUM>
cudaError_t launch_gemm_tn(const void* A, const void* G, const void* scale, void* ws,
                           void* gsum_ws, void* dw, void* gsum_out, int M, int Kin, int N,
                           int splits, cudaStream_t stream) {
  const int rows = (M + splits - 1) / splits;
  const int rps = (rows + BK - 1) / BK * BK;
  dim3 grid(N / BN, Kin / BM, splits);
  gemm_tn_kernel<SCALE, GSUM><<<grid, GEMM_THREADS, 0, stream>>>(
      static_cast<const bf16*>(A), static_cast<const bf16*>(G),
      static_cast<const float*>(scale), static_cast<float*>(ws), static_cast<float*>(gsum_ws),
      M, Kin, N, rps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = launch_sum_rows(ws, splits, static_cast<long long>(Kin) * N, dw, stream);
  if (err != cudaSuccess || !GSUM) return err;
  return launch_sum_rows(gsum_ws, splits, N, gsum_out, stream);
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

template <int DH>
cudaError_t launch_attn_bwd_dh(const void* qkv, const void* dctx, void* stats, void* dqkv,
                               int B, int S, int H, float scale, size_t smem,
                               cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(attn_bwd_dq_kernel<DH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(attn_bwd_dkv_kernel<DH>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid((S + BQ - 1) / BQ, H, B);
  attn_bwd_dq_kernel<DH><<<grid, ATTN_THREADS, smem, stream>>>(
      static_cast<const bf16*>(qkv), static_cast<const bf16*>(dctx),
      static_cast<float*>(stats), static_cast<bf16*>(dqkv), S, H, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attn_bwd_dkv_kernel<DH><<<grid, ATTN_THREADS, smem, stream>>>(
      static_cast<const bf16*>(qkv), static_cast<const bf16*>(dctx),
      static_cast<const float*>(stats), static_cast<bf16*>(dqkv), S, H, scale);
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

bool flash_forward(int S, int dh) { return attention_smem_bytes(S, dh) > MAX_SMEM; }
bool flash_backward(int S, int dh) { return attn_bwd_smem_bytes(S, dh) > MAX_SMEM; }

// flash: the streamed kernels, which read the forward's statistics from
// stats (written by launch_attention with flash); else the resident pair.
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
  const size_t smem = attn_bwd_smem_bytes(S, dh);
  const float scale = 1.0f / sqrtf(static_cast<float>(dh));
  if (dh == 64) return launch_attn_bwd_dh<64>(qkv, dctx, stats, dqkv, B, S, H, scale, smem, stream);
  if (dh == 32) return launch_attn_bwd_dh<32>(qkv, dctx, stats, dqkv, B, S, H, scale, smem, stream);
  return cudaErrorInvalidValue;
}

// flash: the streamed forward (writing the row statistics to stats when it
// is not null); else attention_kernel with the head's K and V resident.
cudaError_t launch_attention(const void* qkv, void* ctx, void* stats, int B, int S, int H,
                             int dh, bool flash, cudaStream_t stream) {
  if (flash) {
    dp_flash::Params p = packed_heads(qkv, B, S, H, dh);
    p.o = static_cast<bf16*>(ctx);
    p.stats = static_cast<float*>(stats);
    return dp_flash::launch_fwd(p, dh, stream);
  }
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
  err = launch_gemm_nt<true, EPT_GELU_GRAD>(dy, w2, ls2, h1, dh1b, M, hidden, D, st,
                                            colsum_part);
  if (err != cudaSuccess) return err;
  err = launch_sum_rows(colsum_part, (M + BM - 1) / BM, hidden, dbf1, st);
  if (err != cudaSuccess) return err;
  err = launch_gemm_nt<false, EPT_F32>(dh1b, w1, nullptr, nullptr, dm, M, D, hidden, st);
  if (err != cudaSuccess) return err;
  err = launch_ln_bwd_sums<SAVED_H2 ? ROWS_UNSCALED : ROWS_RESIDENT>(
      x2, dy, dm, g2, ls2, h2, dx2, row_part, vec4, M, D, eps, st);
  if (err != cudaSuccess) return err;
  err = launch_gemm_tn<false, false>(m, dh1b, nullptr, ws1, nullptr, dw1, nullptr, M, D, hidden,
                                     splits1, st);
  if (err != cudaSuccess) return err;
  return launch_gemm_tn<true, false>(g, dy, ls2, ws2, nullptr, dw2, nullptr, M, hidden, D,
                                     splits2, st);
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
  if (STREAM) {
    err = launch_gemm_nt<false, EPT_BF16>(dres, wo, nullptr, nullptr, dctx, M, D, D, st);
  } else {
    err = launch_gemm<EPI_BIAS>(ctx, wo, bo, nullptr, nullptr, o, M, D, D, st);
    if (err != cudaSuccess) return err;
    err = launch_gemm_nt<true, EPT_BF16>(dres, wo, ls1, nullptr, dctx, M, D, D, st);
  }
  if (err != cudaSuccess) return err;
  err = launch_attn_bwd(qkv, dctx, stats, dqkv, B, S, H, D / H, flash, st);
  if (err != cudaSuccess) return err;
  err = launch_gemm_nt<false, EPT_F32>(dqkv, wqkv, nullptr, nullptr, da, M, D, 3 * D, st);
  if (err != cudaSuccess) return err;
  err = launch_ln_bwd_sums<STREAM ? ROWS_NO_RES : ROWS_RESIDENT>(
      x, dres, da, g1, ls1, o, dx, row_part, vec4, M, D, eps, st);
  if (err != cudaSuccess) return err;
  err = launch_gemm_tn<false, true>(a, dqkv, nullptr, ws_qkv, gsum_part, dwqkv, dbqkv, M, D,
                                    3 * D, splits_qkv, st);
  if (err != cudaSuccess) return err;
  if (STREAM)
    return launch_gemm_tn<false, false>(ctx, dres, nullptr, ws_o, nullptr, dwo, nullptr, M, D, D,
                                        splits_o, st);
  return launch_gemm_tn<true, false>(ctx, dres, ls1, ws_o, nullptr, dwo, nullptr, M, D, D,
                                     splits_o, st);
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
  // last product overwrites once h1 is formed.
  cudaError_t err = launch_ln_rows(x2, g2, b2, dm, M, D, eps, st);
  if (err != cudaSuccess) return err;
  err = launch_gemm<EPI_BIAS>(dm, w1, bf1, nullptr, nullptr, h1buf, M, hidden, D, st);
  if (err != cudaSuccess) return err;
  err = launch_gemm_nt<!PARTIAL, EPT_GELU_GRAD>(dy, w2, ls2, h1buf, dh1b, M, hidden, D, st);
  if (err != cudaSuccess) return err;
  err = launch_gemm_nt<false, EPT_F32>(dh1b, w1, nullptr, nullptr, dm, M, D, hidden, st);
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
// 1 when the chains' attention forward (backward) at (S, dh) takes the
// streamed kernels of flash_kernels.cu, 0 when the resident ones.
int dp_flash_forward(int S, int dh) { return flash_forward(S, dh) ? 1 : 0; }
int dp_flash_backward(int S, int dh) { return flash_backward(S, dh) ? 1 : 0; }

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
// (splits1, D, hidden), ws2 (splits2, hidden, D). Outputs f32: dw1 (D, hidden),
// dbf1 (hidden), dw2 (hidden, D), vec4 (4, D) = dbf2 | dls2 | dg2 | db2.
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
// (splits_o, D, D), gsum_part (splits_qkv, 3D). Outputs f32: dwqkv (D, 3D),
// dbqkv (3D), dwo (D, D), vec4 (4, D) = dbo | dls1 | dg1 | db1.
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
