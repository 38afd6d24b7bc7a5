// Streamed ("flash") attention for Hopper (sm_90a), CUDA C++ with a plain C
// interface (loaded with ctypes by dino_pose_tpu_torch/ops/_ext.py).
//
// They replace the two Pallas kernels of dino_pose_tpu/ops/attention.py:
// _flash_kernel (:40, pallas_call :114) and _flash_bwd_kernel (:130,
// pallas_call :218). The TPU kernels hold a whole (S, S) f32 score tile of
// one (batch, head) in VMEM (5.4 MB at S = 1297, under the 10 MB budget).
// A Hopper block has at most 227 KB of shared memory, which does not hold
// even the head's K and V past S ~ 320 (block_kernels.cu's resident pair
// keeps them there). Here K and V (or Q and dO) stream through shared
// memory in 64-row tiles, so a block's shared memory does not grow with S:
//
//   flash_fwd_kernel<DH, NWG>      one block per 64*NWG-query tile of a
//                                  (batch, head); two passes over the key
//                                  tiles: the first finds each row's max m
//                                  and sum l (the sum rescaled as the max
//                                  moves), the second forms
//                                  P = bf16(exp(s*scale - m) * (1/l)) and
//                                  accumulates P V in f32.
//   flash_bwd_dq_kernel<DH>        per 64-query tile over the key tiles: a
//                                  first pass sums rowsum(P * dP) exactly in
//                                  f32 (stats row 2), the second forms
//                                  dS = P * (dP - rowsum) and accumulates
//                                  bf16(dS) K.
//   flash_bwd_dkv_kernel<DH>       per 64-key tile over the query tiles: P
//                                  and dS rebuilt from the statistics,
//                                  dv += bf16(P)^T dO, dk += bf16(dS)^T Q.
//
// Rounding points are those of the JAX kernels (attention.py:50-69 and
// :143-186): f32 scores, max-subtracted exp, f32 normalisation, P rounded to
// bf16 before P V and the output rounded once; in the backward P and dP in
// f32, dS formed with the exact f32 rowsum(P * dP), bf16(P) and bf16(dS)
// before their products, dq, dk and dv accumulated in f32 and rounded once
// (dq and dk after the scale). Departures at the level of f32 roundoff: the
// exp is exp2 (ex2.approx) with scale*log2(e) folded into one FMA, each
// row's 1/l is taken once and multiplied in, and l is summed tile by tile,
// rescaled as the running max moves, where JAX sums exp(s - max) over the
// whole row once. A single online-softmax pass would round P before it is
// normalised, and rowsum(dO * O) in place of rowsum(P * dP) would move the
// backward's rounding; neither is taken. Keys >= S get P = 0 (JAX's
// valid_len mask); queries >= S are never written. No atomics: two runs give
// the same bits.
//
// Bound on an H100 at dinov2-small, 504² input (S = 1297, 6 heads of 64):
// JAX's counts, 4*B*H*S^2*dh FLOPs forward and 10*B*H*S^2*dh backward
// (0.084 and 0.209 ms at B = 32), bound by operations from batch 1. The
// normalised P and the exact rowsum cost recomputation: the kernels execute
// 6 (forward: Q K^T in both passes) and 18 (backward: Q K^T and dO V^T in
// both dq passes and again in dkv) B*H*S^2*dh FLOPs (ops/attention.py's
// flash_cost), 0.125 and 0.376 ms at 989 TFLOP/s. Beside the products each
// score takes an exp in each pass (two forward, three backward: 0.65 and
// 0.97 G ex2 at B = 32, ~0.16 and ~0.23 ms at 16 a clock an SM), so the
// special-function unit is a floor of its own, and the exps only hide
// behind the products where one warpgroup's softmax runs while another's
// products do. The design (the mma.sync register tiles, two-stage cp.async
// ring and four-warp blocks it replaced ran the products at 237-248
// TFLOP/s):
//
//   - Every product is a wgmma (bf16 in, f32 accumulate). Q K^T, dO V^T,
//     K Q^T and V dO^T read both operands K-major from shared memory, as
//     TMA lays the tiles down; their first k16 step zeroes the accumulator
//     (an instruction writing it while wgmmas are in flight would make the
//     compiler serialise them). P V, dS K, P^T dO and dS^T Q take P or dS as
//     the A operand straight from registers: the f32 accumulator of an
//     m64n64 product holds, in each 16-column group, exactly the A fragment
//     of one k16 step, so no score, P or dS goes to shared memory; the
//     other operand is read MN-major through the transpose bit.
//   - Warp-specialised blocks: consumer warpgroups of 64 rows each (query
//     rows in the forward and dq kernels, key rows in dkv; NWG of them in
//     the forward, one in the backward pair) and a producer
//     whose one thread keeps TMA loads in flight through a ring of stages
//     with full and empty mbarriers (in dkv the producer warp also writes
//     each query tile's (m*log2e, 1/l, rowsum) triple beside it: the stats
//     rows of S f32 values are not 16-byte strided, so TMA cannot load
//     them).
//   - Overlap across blocks, not inside one: a tile's P V (dS K, P^T dO and
//     dS^T Q) runs on while the next tile's scores are issued, and the
//     wait for those retires it; the exps of one block run beside the
//     products of the other blocks on the SM. The 64-row form (NWG = 1,
//     one producer warp) fits three forward or dq blocks an SM (four- and
//     three-stage rings, at most 136 registers a thread) and two dkv
//     blocks. On an H100 it beat, at every measured shape, the 128-row
//     form (NWG = 2: the producer a whole warpgroup that hands its
//     registers to the consumers, setmaxnreg 40 / 232, one block an SM)
//     and a software-pipelined loop that issued tile t + 1's scores before
//     tile t's exps (double the score registers, two blocks an SM): 0.43
//     against 0.57 ms forward, 1.13 against 1.17 ms backward, for the
//     128-row form at (32, 6, 1297, 64) (chip_smoke.py's flash phase; see
//     PERF.md). So every launch takes 64 rows; the forward's 128-row form
//     is kept for that measurement (dp_flash_fwd_rows), the backward pair
//     has the 64-row form alone.
//   - Tensor maps are 4-D (dh, S, H, B) over the operand's strides: S is a
//     dimension of its own, so TMA zero-fills the ragged last tile (never
//     the next sample's rows) and clips the stores of rows >= S; both
//     layouts (the standalone (B, H, S, dh) and the chains' packed qkv
//     (B, S, 3D) with ctx (B, S, D)) are the same map with other strides.
//     Boxes of 64 rows by dh, swizzled as wide as a head row (128 bytes at
//     dh = 64, 64 at dh = 32). Maps are cached per (address, geometry).
//     Outputs leave through a resident tile no product reads any more by
//     TMA stores.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <mutex>
#include <type_traits>

#include "flash_kernels.cuh"
#include "hopper.cuh"

typedef __nv_bfloat16 bf16;

namespace dp_flash {
namespace {

using namespace dp_hopper;

constexpr int WGT = 128;   // threads of a warpgroup
constexpr int TR = 64;     // rows of a tile: one wgmma M, one TMA box
constexpr float LOG2E = 1.4426950408889634f;

// A 64-row tile of head rows (dh bf16 values, RB bytes), as TMA lays it
// down: 16-byte chunk j of row r at chunk j ^ (r % 8) (128-byte rows) or
// j ^ ((r / 2) % 4) (64-byte rows).
template <int DH>
struct Tile {
  static constexpr int RB = DH * 2;
  static constexpr int BYTES = TR * RB;
  static constexpr uint64_t LAYOUT = DH == 64 ? 1 : 2;  // wgmma's 128- or 64-byte swizzle
  static constexpr uint64_t K_STEP = 32 >> 4;           // a K-major k16 step, 16-byte units
  // The wgmma descriptor of the tile at addr: K-major (the reduction along
  // each row) or MN-major (the reduction down the rows, one atom of dh
  // columns).
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

// The block's threads: NWG consumer warpgroups, then the producer (a
// whole warpgroup that hands its registers over at NWG = 2, else one warp).
constexpr int threads_of(int nwg) { return nwg * WGT + (nwg > 1 ? WGT : 32); }

// Shared memory: the block's resident tiles (RES of them: Q, or Q and dO,
// or K and V, NWG each), the ring of STAGES stages of two tiles, EXTRA
// bytes a stage beside the ring (dkv's statistics), then the barriers
// (resident, full[STAGES], empty[STAGES]), after slack to align the tiles to
// 1024 bytes.
template <int DH, int NWG, int RES, int EXTRA, int NS, int BLOCKS>
struct Layout {
  using T = Tile<DH>;
  static constexpr int STAGES = NS;
  // Blocks an SM the kernel is built for: one at NWG = 2, else BLOCKS.
  static constexpr int MIN_BLOCKS = NWG > 1 ? 1 : BLOCKS;
  static constexpr int RING = RES * NWG * T::BYTES;
  static constexpr int STAGE = 2 * T::BYTES;
  static constexpr int SIDE = RING + STAGES * STAGE;
  static constexpr int BARS = SIDE + STAGES * EXTRA;
  static constexpr size_t SMEM = BARS + (1 + 2 * STAGES) * 8 + 1024;
};
// Stages and blocks an SM: the forward and dq kernels fit three one-
// warpgroup blocks an SM (shared memory and 136 registers a thread), dkv,
// whose accumulators take more registers, two.
template <int DH, int NWG>
using FwdLayout = Layout<DH, NWG, 1, 0, 4, 3>;
template <int DH>
using DqLayout = Layout<DH, 1, 2, 0, 3, 3>;
constexpr int STAT_BYTES = 3 * TR * 4;  // (m*log2e, 1/l, rowsum) of 64 queries
template <int DH>
using DkvLayout = Layout<DH, 1, 2, STAT_BYTES, 4, 2>;

// Each instance fits a block's dynamic shared memory on an H100 (232,448
// bytes), and the blocks an SM it is built for fit the SM's 233,472 bytes,
// of which each resident block reserves 1 KB.
template <typename L>
constexpr bool fits_sm() {
  return L::SMEM <= 232448 && L::MIN_BLOCKS * (L::SMEM + 1024) <= 233472;
}
static_assert(fits_sm<FwdLayout<64, 1>>() && fits_sm<FwdLayout<64, 2>>() &&
                  fits_sm<FwdLayout<32, 1>>() && fits_sm<FwdLayout<32, 2>>(),
              "a forward instance does not fit shared memory");
static_assert(fits_sm<DqLayout<64>>() && fits_sm<DqLayout<32>>() && fits_sm<DkvLayout<64>>() &&
                  fits_sm<DkvLayout<32>>(),
              "a backward instance does not fit shared memory");
static_assert(FwdLayout<64, 1>::STAGES >= 3 && DqLayout<64>::STAGES >= 3 &&
                  DkvLayout<64>::STAGES >= 3,
              "a ring holds at least three stages");

// D (64 x 32 f32) += A (64 x 16 bf16, four registers a thread in the
// accumulator's layout: rows lane/4 and +8, columns 2*(lane%4) and +8) * B
// (16 x 32) from shared memory, B MN-major.
__device__ __forceinline__ void wgmma_rs_n32(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 64 f32) += A (64 x 16, registers, as wgmma_rs_n32) * B (16 x 64).
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// Keeps the compiler from reusing an A fragment's registers before the
// wgmma that reads them has been waited for.
template <int R>
__device__ __forceinline__ void fence_frag(uint32_t* a) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(a[i])::"memory");
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

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// One 4-D TMA tile store from shared memory (a bulk group); elements past
// the tensor's edge (rows >= S) are not written.
__device__ __forceinline__ void tma_store4(const CUtensorMap* map, uint32_t src, int c0, int c1,
                                           int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// Fetches the tensor maps' descriptors ahead of their first load.
__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}
template <typename... Maps>
__device__ __forceinline__ void prefetch_maps(const Maps*... maps) {
  (prefetch_map(maps), ...);
}

// A 64-row tile of the (dh, S, H, B) operand at map into shared memory.
__device__ __forceinline__ void load_rows(uint32_t dst, const CUtensorMap* map, uint32_t bar, int r0,
                                          int h, int b) {
  tma_load4(dst, map, bar, 0, r0, h, b);
}

// The accumulator of an m64n64 product: value i of a thread lies in row
// (i / 2) % 2 of its two (16*warp + lane/4 and 8 below it) and at column
// 8*(i/4) + 2*(lane%4) + i%2.
__device__ __forceinline__ int score_col(int i, int lane) { return 8 * (i >> 2) + 2 * (lane & 3) + (i & 1); }

// D (64 x 64 f32) = A (64 x 16) * B (16 x 64) + (acc ? D : 0), both read
// K-major from shared memory through their descriptors. The first k16 step
// of a product passes acc = 0 in place of zeroing D: an instruction that
// writes an accumulator while wgmmas are in flight makes the compiler
// serialise them.
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc));
}

// d (64 x 64) = A B^T for the K-major tiles at a and b, into the open wgmma
// group: Q K^T, dO V^T, K Q^T, V dO^T.
template <int DH>
__device__ __forceinline__ void issue_nt(float* d, uint32_t a, uint32_t b) {
  using T = Tile<DH>;
  const uint64_t da = T::desc(a, false), db = T::desc(b, false);
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk)
    wgmma_ss_n64(d, da + kk * T::K_STEP, db + kk * T::K_STEP, kk > 0);
}

// d (64 x DH) += p (64 x 64, four k16 A fragments of four registers) times
// the tile at t (64 x DH, MN-major), into the open wgmma group: P V, dS K,
// P^T dO, dS^T Q.
template <int DH>
__device__ __forceinline__ void issue_pv(float* d, const uint32_t* p, uint32_t t) {
  using T = Tile<DH>;
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    if constexpr (DH == 64)
      wgmma_rs_n64(d, p + 4 * g, T::desc(t + g * 16 * T::RB, true));
    else
      wgmma_rs_n32(d, p + 4 * g, T::desc(t + g * 16 * T::RB, true));
  }
}

// d (64 x 64) = A B^T for the K-major tiles at a and b as one wgmma group,
// committed and not waited for.
template <int DH>
__device__ __forceinline__ void start_nt(float* d, uint32_t a, uint32_t b) {
  fence_acc<32>(d);
  wgmma_fence();
  issue_nt<DH>(d, a, b);
  wgmma_commit();
  fence_acc<32>(d);
}

// The warpgroup's 64 x DH accumulator times mul, rounded to bf16, through
// the staging tile at stage (a resident tile no product reads any more) and
// out by one TMA store to rows [r0, r0 + 64) of head h of sample b of map.
template <int DH>
__device__ __forceinline__ void store_tile(const float* o, float mul, uint32_t stage,
                                           const CUtensorMap* map, int r0, int h, int b, int row,
                                           int lane, bool signal, int bar_id) {
  using T = Tile<DH>;
  warpgroup_sync(bar_id);
#pragma unroll
  for (int j = 0; j < DH / 8; ++j) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      st_shared(stage + T::pair(j, row + 8 * hh, lane),
                pack_bf16(o[4 * j + 2 * hh] * mul, o[4 * j + 2 * hh + 1] * mul));
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  warpgroup_sync(bar_id);
  if (signal) {
    tma_store4(map, stage, 0, r0, h, b);
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  }
}

template <int STAGES>
__device__ __forceinline__ void init_bars(uint32_t bars, uint32_t full_count, uint32_t empty_count) {
  if (threadIdx.x == 0) {
    mbar_init(bars, 1);
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(bars + 8 + 8 * i, full_count);
      mbar_init(bars + 8 + 8 * STAGES + 8 * i, empty_count);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// The producer's step i into stage i % STAGES: once the consumers have
// released the stage's previous contents, arm its full barrier for bytes.
template <int STAGES>
__device__ __forceinline__ uint32_t claim(uint32_t full, uint32_t empty, int i, uint32_t bytes) {
  const int st = i % STAGES;
  bar_wait(empty + 8 * st, ((i / STAGES) & 1) ^ 1);
  mbar_expect_tx(full + 8 * st, bytes);
  return full + 8 * st;
}

template <int DH, int NWG>
__global__ void __launch_bounds__(threads_of(NWG), FwdLayout<DH, NWG>::MIN_BLOCKS)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap to,
                 float* __restrict__ stats, int S, int H, float scale) {
  using T = Tile<DH>;
  using L = FwdLayout<DH, NWG>;
  constexpr int STAGES = L::STAGES;
  extern __shared__ unsigned char flash_smem[];
  const uint32_t base = (smem_addr(flash_smem) + 1023u) & ~1023u;
  const uint32_t ring = base + L::RING, bars = base + L::BARS;
  const uint32_t full = bars + 8, empty = bars + 8 + 8 * STAGES;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * TR * NWG;
  const int nt = (S + TR - 1) / TR;
  const int wg = threadIdx.x / WGT;
  init_bars<STAGES>(bars, 1, NWG);

  if (wg == NWG) {
    // Producer: the block's query tiles once, then key tile t of pass 1
    // (K) at step t and of pass 2 (K and V) at step nt + t.
    if (NWG > 1) asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == NWG * WGT) {
      prefetch_maps(&tq, &tk, &tv);
      mbar_expect_tx(bars, NWG * T::BYTES);
      for (int w = 0; w < NWG; ++w) load_rows(base + w * T::BYTES, &tq, bars, q0 + TR * w, h, b);
      for (int i = 0; i < 2 * nt; ++i) {
        const int t = i < nt ? i : i - nt;
        const uint32_t ks = ring + (i % STAGES) * L::STAGE;
        // With one key tile pass 2 reuses pass 1's scores: V alone.
        const bool k_tile = i < nt || nt > 1;
        const uint32_t bar = claim<STAGES>(full, empty, i, (k_tile + (i >= nt)) * T::BYTES);
        if (k_tile) load_rows(ks, &tk, bar, t * TR, h, b);
        if (i >= nt) load_rows(ks + T::BYTES, &tv, bar, t * TR, h, b);
      }
    }
    return;
  }
  if (NWG > 1) asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int tid = threadIdx.x % WGT, lane = tid & 31, row = (tid >> 5) * 16 + (lane >> 2);
  const bool signal = tid == 0;
  const uint32_t qs = base + wg * T::BYTES;
  const float c = scale * LOG2E;
  bar_wait(bars, 0);

  // Scores of step i's K tile into d, issued as one wgmma group (not
  // waited for), once the tile has landed.
  auto start = [&](float* d, int i) {
    const int st = i % STAGES;
    bar_wait(full + 8 * st, (i / STAGES) & 1);
    start_nt<DH>(d, qs, ring + st * L::STAGE);
  };

  // Pass 1: each row's max (of the raw products: max commutes with the
  // positive scale) and its sum of exp2((s - m) * scale * log2e), a
  // partial sum per lane, rescaled as the max moves.
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  auto stats_of = [&](auto ragged, float* sc, int valid) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float v[16];
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int k = 4 * (j >> 1) + 2 * hr + (j & 1);
        v[j] = !decltype(ragged)::value || score_col(k, lane) < valid ? sc[k] : -INFINITY;
      }
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 16; ++j) mx = fmaxf(mx, v[j]);
      const float mnew = fmaxf(m[hr], quad_max(mx));  // finite: a tile holds a key
      const float mc = mnew * c;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 16; j += 2) {
        const float e0 = ex2(fmaf(v[j], c, -mc)), e1 = ex2(fmaf(v[j + 1], c, -mc));
        sum += e0 + e1;
        // The exps in place of the scores: at one key tile they are pass
        // 2's, bit for bit (the same max); past it pass 2 recomputes.
        sc[4 * (j >> 1) + 2 * hr] = e0;
        sc[4 * (j >> 1) + 2 * hr + 1] = e1;
      }
      l[hr] = l[hr] * ex2((m[hr] - mnew) * c) + sum;
      m[hr] = mnew;
    }
  };
  auto row_stats = [&](float* sc, int i) {
    fence_acc<32>(sc);
    if (signal) mbar_arrive(empty + 8 * (i % STAGES));
    if (S - i * TR < TR)
      stats_of(std::true_type(), sc, S - i * TR);
    else
      stats_of(std::false_type(), sc, TR);
  };
  float s2[32] = {};
  for (int i = 0; i < nt; ++i) {
    start(s2, i);
    wgmma_wait<0>();
    row_stats(s2, i);
  }
  float mc[2], rl[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    l[hr] = quad_sum(l[hr]);
    mc[hr] = m[hr] * c;
    rl[hr] = 1.f / l[hr];
  }

  // Pass 2: O = bf16(P) V with P = exp2(s * c - m * c) * (1/l), in f32.
  // A tile's P V runs on while the next tile's scores are issued; their
  // wait retires it, and the tile's stage is released then. With one key
  // tile (S <= 64: FastViT's attention) pass 1's exps are still in the
  // registers, the same bits pass 2 would compute again: only V is loaded
  // and waited for.
  float o[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) o[i] = 0.f;
  uint32_t p[16];
  auto probs_of = [&](auto ragged, int valid) {
#pragma unroll
    for (int k = 0; k < 32; ++k) {
      const float pk = ex2(fmaf(s2[k], c, -mc[(k >> 1) & 1])) * rl[(k >> 1) & 1];
      s2[k] = !decltype(ragged)::value || score_col(k, lane) < valid ? pk : 0.f;
    }
  };
  auto probs = [&](int t) {
    fence_acc<32>(s2);
    if (nt == 1) {
#pragma unroll
      for (int k = 0; k < 32; ++k) s2[k] *= rl[(k >> 1) & 1];  // keys >= S: exps of -inf
    } else if (S - t * TR < TR)
      probs_of(std::true_type(), S - t * TR);
    else
      probs_of(std::false_type(), TR);
  };
  auto round_p = [&]() {
#pragma unroll
    for (int j = 0; j < 16; ++j) p[j] = pack_bf16(s2[2 * j], s2[2 * j + 1]);
  };
  for (int t = 0; t < nt; ++t) {
    const int i = nt + t;
    if (nt == 1) {
      bar_wait(full + 8 * (i % STAGES), (i / STAGES) & 1);
    } else {
      start(s2, i);
      wgmma_wait<0>();
    }
    fence_acc<DH / 2>(o);
    if (t > 0) fence_frag<16>(p);
    if (t > 0 && signal) mbar_arrive(empty + 8 * ((i - 1) % STAGES));
    probs(t);
    round_p();
    wgmma_fence();
    issue_pv<DH>(o, p, ring + (i % STAGES) * L::STAGE + T::BYTES);
    wgmma_commit();
    fence_acc<DH / 2>(o);
  }
  wgmma_wait<0>();
  fence_acc<DH / 2>(o);
  fence_frag<16>(p);

  store_tile<DH>(o, 1.f, qs, &to, q0 + TR * wg, h, b, row, lane, signal, 1 + wg);
  if (stats != nullptr && (lane & 3) == 0) {
    float* sp = stats + (static_cast<long long>(b) * H + h) * 3 * S;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int q = q0 + TR * wg + row + 8 * hr;
      if (q < S) {
        sp[q] = m[hr] * scale;
        sp[S + q] = l[hr];
      }
    }
  }
  if (signal) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

template <int DH>
__global__ void __launch_bounds__(threads_of(1), DqLayout<DH>::MIN_BLOCKS)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                    const __grid_constant__ CUtensorMap tdq, float* __restrict__ stats, int S,
                    int H, float scale) {
  using T = Tile<DH>;
  using L = DqLayout<DH>;
  constexpr int STAGES = L::STAGES;
  extern __shared__ unsigned char flash_smem[];
  const uint32_t base = (smem_addr(flash_smem) + 1023u) & ~1023u;
  const uint32_t ring = base + L::RING, bars = base + L::BARS;
  const uint32_t full = bars + 8, empty = bars + 8 + 8 * STAGES;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * TR;
  const int nt = (S + TR - 1) / TR;
  init_bars<STAGES>(bars, 1, 1);

  if (threadIdx.x >= WGT) {
    // Producer warp: the block's Q and dO tiles once, then K and V of key
    // tile i mod nt at step i (pass 1, then pass 2).
    if (threadIdx.x == WGT) {
      prefetch_maps(&tq, &tk, &tv, &tdo);
      mbar_expect_tx(bars, 2 * T::BYTES);
      load_rows(base, &tq, bars, q0, h, b);
      load_rows(base + T::BYTES, &tdo, bars, q0, h, b);
      for (int i = 0; i < 2 * nt; ++i) {
        const int t = i < nt ? i : i - nt;
        const uint32_t ks = ring + (i % STAGES) * L::STAGE;
        const uint32_t bar = claim<STAGES>(full, empty, i, 2 * T::BYTES);
        load_rows(ks, &tk, bar, t * TR, h, b);
        load_rows(ks + T::BYTES, &tv, bar, t * TR, h, b);
      }
    }
    return;
  }
  const int tid = threadIdx.x, lane = tid & 31, row = (tid >> 5) * 16 + (lane >> 2);
  const bool signal = tid == 0;
  const uint32_t qs = base, os = base + T::BYTES;
  const float c = scale * LOG2E;
  float* sp = stats + (static_cast<long long>(b) * H + h) * 3 * S;
  float mc[2], rl[2], rs[2] = {0.f, 0.f};
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int q = q0 + row + 8 * hr;
    mc[hr] = q < S ? sp[q] * LOG2E : 0.f;
    rl[hr] = q < S ? 1.f / sp[S + q] : 0.f;
  }
  bar_wait(bars, 0);

  // Scores and dP = dO V^T of step i's K and V tile into sd and dd, one
  // wgmma group (not waited for), once the tile has landed.
  auto start = [&](float* sd, float* dd, int i) {
    const int st = i % STAGES;
    const uint32_t ks = ring + st * L::STAGE;
    bar_wait(full + 8 * st, (i / STAGES) & 1);
    fence_acc<32>(sd);
    fence_acc<32>(dd);
    wgmma_fence();
    issue_nt<DH>(sd, qs, ks);
    issue_nt<DH>(dd, os, ks + T::BYTES);
    wgmma_commit();
    fence_acc<32>(sd);
    fence_acc<32>(dd);
  };
  // P = exp2(s * c - m * log2e) * (1/l) in place of tile t's scores, 0 at
  // keys >= S.
  auto probs_of = [&](auto ragged, float* sd, int valid) {
#pragma unroll
    for (int k = 0; k < 32; ++k) {
      const float pk = ex2(fmaf(sd[k], c, -mc[(k >> 1) & 1])) * rl[(k >> 1) & 1];
      sd[k] = !decltype(ragged)::value || score_col(k, lane) < valid ? pk : 0.f;
    }
  };
  auto probs = [&](float* sd, float* dd, int t) {
    fence_acc<32>(sd);
    fence_acc<32>(dd);
    if (S - t * TR < TR)
      probs_of(std::true_type(), sd, S - t * TR);
    else
      probs_of(std::false_type(), sd, TR);
  };

  // Pass 1: rowsum(P * dP) over all keys, in f32.
  {
    float sa[32] = {}, da[32] = {};
    auto add_rows = [&](float* sd, float* dd, int i) {
      probs(sd, dd, i);
      if (signal) mbar_arrive(empty + 8 * (i % STAGES));
#pragma unroll
      for (int j = 0; j < 32; ++j) rs[(j >> 1) & 1] = fmaf(sd[j], dd[j], rs[(j >> 1) & 1]);
    };
    for (int i = 0; i < nt; ++i) {
      start(sa, da, i);
      wgmma_wait<0>();
      add_rows(sa, da, i);
    }
  }
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    rs[hr] = quad_sum(rs[hr]);
    const int q = q0 + row + 8 * hr;
    if ((lane & 3) == 0 && q < S) sp[2 * S + q] = rs[hr];
  }

  // Pass 2: dq = bf16(dS) K * scale, dS = P * (dP - rowsum); a tile's dS K
  // runs on while the next tile's products are issued.
  float dq[DH / 2], s[32] = {}, dp[32] = {};
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) dq[i] = 0.f;
  uint32_t f[16];
  auto grads = [&](int t) {
    probs(s, dp, t);
#pragma unroll
    for (int k = 0; k < 32; ++k) s[k] *= dp[k] - rs[(k >> 1) & 1];
  };
  auto round_ds = [&]() {
#pragma unroll
    for (int j = 0; j < 16; ++j) f[j] = pack_bf16(s[2 * j], s[2 * j + 1]);
  };
  for (int t = 0; t < nt; ++t) {
    const int i = nt + t;
    start(s, dp, i);
    wgmma_wait<0>();
    fence_acc<DH / 2>(dq);
    if (t > 0) fence_frag<16>(f);
    if (t > 0 && signal) mbar_arrive(empty + 8 * ((i - 1) % STAGES));
    grads(t);
    round_ds();
    wgmma_fence();
    issue_pv<DH>(dq, f, ring + (i % STAGES) * L::STAGE);
    wgmma_commit();
    fence_acc<DH / 2>(dq);
  }
  wgmma_wait<0>();
  fence_acc<DH / 2>(dq);
  fence_frag<16>(f);
  store_tile<DH>(dq, scale, qs, &tdq, q0, h, b, row, lane, signal, 1);
  if (signal) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

template <int DH>
__global__ void __launch_bounds__(threads_of(1), DkvLayout<DH>::MIN_BLOCKS)
flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                     const __grid_constant__ CUtensorMap tdk, const __grid_constant__ CUtensorMap tdv,
                     const float* __restrict__ stats, int S, int H, float scale) {
  using T = Tile<DH>;
  using L = DkvLayout<DH>;
  constexpr int STAGES = L::STAGES;
  extern __shared__ unsigned char flash_smem[];
  const uint32_t base = (smem_addr(flash_smem) + 1023u) & ~1023u;
  const uint32_t ring = base + L::RING, bars = base + L::BARS;
  const uint32_t full = bars + 8, empty = bars + 8 + 8 * STAGES;
  float* side = reinterpret_cast<float*>(flash_smem + (base + L::SIDE - smem_addr(flash_smem)));
  const int b = blockIdx.z, h = blockIdx.y, k0 = blockIdx.x * TR;
  const int nt = (S + TR - 1) / TR;
  // A stage is full once its tiles have landed and each producer lane has
  // written its share of the statistics (32 arrivals beside the armer's).
  init_bars<STAGES>(bars, 33, 1);

  if (threadIdx.x >= WGT) {
    // Producer warp: the block's K and V tiles once, then Q and dO of query
    // tile j at step j, with the tile's statistics from stats (queries >= S
    // get 1/l = 0, so that their P and dS are 0).
    const int lane = threadIdx.x & 31;
    const float* sp = stats + (static_cast<long long>(b) * H + h) * 3 * S;
    if (lane == 0) {
      prefetch_maps(&tq, &tk, &tv, &tdo);
      mbar_expect_tx(bars, 2 * T::BYTES);
      load_rows(base, &tk, bars, k0, h, b);
      load_rows(base + T::BYTES, &tv, bars, k0, h, b);
    }
    for (int j = 0; j < nt; ++j) {
      const int st = j % STAGES;
      const uint32_t qs = ring + st * L::STAGE;
      bar_wait(empty + 8 * st, ((j / STAGES) & 1) ^ 1);
      if (lane == 0) {
        mbar_expect_tx(full + 8 * st, 2 * T::BYTES);
        load_rows(qs, &tq, full + 8 * st, j * TR, h, b);
        load_rows(qs + T::BYTES, &tdo, full + 8 * st, j * TR, h, b);
      }
      float* ls = side + st * 3 * TR;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int qi = 2 * lane + e, q = j * TR + qi;
        const bool ok = q < S;
        ls[qi] = ok ? sp[q] * LOG2E : 0.f;
        ls[TR + qi] = ok ? 1.f / sp[S + q] : 0.f;
        ls[2 * TR + qi] = ok ? sp[2 * S + q] : 0.f;
      }
      mbar_arrive(full + 8 * st);
    }
    return;
  }
  const int tid = threadIdx.x, lane = tid & 31, row = (tid >> 5) * 16 + (lane >> 2);
  const bool signal = tid == 0;
  const uint32_t kt = base, vt = base + T::BYTES;
  const float c = scale * LOG2E;
  bar_wait(bars, 0);

  float dk[DH / 2], dv[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) dk[i] = dv[i] = 0.f;
  float sT[32] = {}, dT[32] = {};
  uint32_t pf[16], df[16];
  // S^T = K Q_j^T and dP^T = V dO_j^T (keys as rows) of query tile j, one
  // wgmma group (not waited for), once the tile has landed.
  auto start = [&](int j) {
    const int st = j % STAGES;
    const uint32_t qs = ring + st * L::STAGE;
    bar_wait(full + 8 * st, (j / STAGES) & 1);
    fence_acc<32>(sT);
    fence_acc<32>(dT);
    wgmma_fence();
    issue_nt<DH>(sT, kt, qs);
    issue_nt<DH>(dT, vt, qs + T::BYTES);
    wgmma_commit();
    fence_acc<32>(sT);
    fence_acc<32>(dT);
  };
  // P^T and dS^T = P^T * (dP^T - rowsum) in f32 in place, from the
  // statistics of tile j's queries (the columns).
  auto grads = [&](int j) {
    fence_acc<32>(sT);
    fence_acc<32>(dT);
    const float* ls = side + (j % STAGES) * 3 * TR;
#pragma unroll
    for (int k = 0; k < 32; ++k) {
      const int col = score_col(k, lane);
      const float pv = ex2(fmaf(sT[k], c, -ls[col])) * ls[TR + col];
      dT[k] = pv * (dT[k] - ls[2 * TR + col]);
      sT[k] = pv;
    }
  };
  auto round_pds = [&]() {
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      pf[i] = pack_bf16(sT[2 * i], sT[2 * i + 1]);
      df[i] = pack_bf16(dT[2 * i], dT[2 * i + 1]);
    }
  };
  // Per query tile j: dv += bf16(P^T) dO_j and dk += bf16(dS^T) Q_j (16
  // queries a k16 step) run on while tile j + 1's products are issued;
  // their wait retires them, and tile j's stage is released then.
  for (int j = 0; j < nt; ++j) {
    const int st = j % STAGES;
    const uint32_t qs = ring + st * L::STAGE;
    start(j);
    wgmma_wait<0>();
    fence_acc<DH / 2>(dk);
    fence_acc<DH / 2>(dv);
    if (j > 0) {
      fence_frag<16>(pf);
      fence_frag<16>(df);
    }
    if (j > 0 && signal) mbar_arrive(empty + 8 * ((j - 1) % STAGES));
    grads(j);
    round_pds();
    wgmma_fence();
    issue_pv<DH>(dv, pf, qs + T::BYTES);
    issue_pv<DH>(dk, df, qs);
    wgmma_commit();
    fence_acc<DH / 2>(dk);
    fence_acc<DH / 2>(dv);
  }
  wgmma_wait<0>();
  fence_acc<DH / 2>(dk);
  fence_acc<DH / 2>(dv);
  fence_frag<16>(pf);
  fence_frag<16>(df);
  // K and V are read: they stage dk and dv.
  store_tile<DH>(dk, scale, kt, &tdk, k0, h, b, row, lane, signal, 1);
  store_tile<DH>(dv, 1.f, vt, &tdv, k0, h, b, row, lane, signal, 1);
  if (signal) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// A (B, H, S, dh) operand at base with element strides (rows, heads,
// samples) as a 4-D tensor map (dh, S, H, B) of 64-row boxes, swizzled as
// wide as a head row. A map describes only an address and a geometry, so
// the one encoded for them serves every later call with the same (the
// caching allocator hands the same addresses back): a small direct-mapped
// cache saves cuTensorMapEncodeTiled's host time.
bool encode_rows(CUtensorMap* map, const void* base, int dh, int S, int H, int B, long long rs,
                 long long hs, long long bs) {
  struct Entry {
    const void* base;
    int dh, S, H, B;
    long long rs, hs, bs;
    CUtensorMap map;
  };
  static Entry cache[64] = {};
  static std::mutex lock;
  const size_t slot =
      (reinterpret_cast<uintptr_t>(base) >> 6 ^ static_cast<size_t>(S) * 31 ^ H * 7 ^ B) % 64;
  std::lock_guard<std::mutex> guard(lock);
  Entry& e = cache[slot];
  if (e.base != base || e.dh != dh || e.S != S || e.H != H || e.B != B || e.rs != rs ||
      e.hs != hs || e.bs != bs) {
    EncodeTiledFn fn = encode_tiled();
    if (fn == nullptr || !bind_context()) return false;
    const cuuint64_t dims[4] = {static_cast<cuuint64_t>(dh), static_cast<cuuint64_t>(S),
                                static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(B)};
    const cuuint64_t strides[3] = {static_cast<cuuint64_t>(rs) * 2, static_cast<cuuint64_t>(hs) * 2,
                                   static_cast<cuuint64_t>(bs) * 2};
    const cuuint32_t box[4] = {static_cast<cuuint32_t>(dh), TR, 1, 1};
    const cuuint32_t step[4] = {1, 1, 1, 1};
    e.base = nullptr;
    if (fn(&e.map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides, box,
           step, CU_TENSOR_MAP_INTERLEAVE_NONE,
           dh == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
           CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return false;
    e.base = base;
    e.dh = dh;
    e.S = S;
    e.H = H;
    e.B = B;
    e.rs = rs;
    e.hs = hs;
    e.bs = bs;
  }
  *map = e.map;
  return true;
}

bool map_in(CUtensorMap* map, const Params& p, const void* base, int dh) {
  return encode_rows(map, base, dh, p.S, p.H, p.B, p.in_r, p.in_h, p.in_b);
}
bool map_out(CUtensorMap* map, const Params& p, const void* base, int dh) {
  return encode_rows(map, base, dh, p.S, p.H, p.B, p.out_r, p.out_h, p.out_b);
}

// The forward's query rows a block: 64 (one consumer warpgroup, three
// blocks an SM) unless chip_smoke.py's flash phase asks for 128 (two
// consumer warpgroups, one block an SM) through dp_flash_fwd_rows. On an
// H100 the 64-row form beat the 128-row one at every measured shape, B = 1
// to 32 at S = 1297 and fastvit_sa12's S = 64 (PERF.md, row 8).
int g_fwd_rows = 64;

template <int NWG, typename Kernel, typename... Args>
cudaError_t run(Kernel kernel, size_t smem, const Params& p, cudaStream_t stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((p.S + TR * NWG - 1) / (TR * NWG), p.H, p.B);
  kernel<<<grid, threads_of(NWG), smem, stream>>>(args...);
  return cudaGetLastError();
}

template <int DH>
cudaError_t fwd(const Params& p, cudaStream_t stream) {
  CUtensorMap tq, tk, tv, to;
  if (!map_in(&tq, p, p.q, DH) || !map_in(&tk, p, p.k, DH) || !map_in(&tv, p, p.v, DH) ||
      !map_out(&to, p, p.o, DH))
    return cudaErrorInvalidValue;
  if (g_fwd_rows == 128)
    return run<2>(flash_fwd_kernel<DH, 2>, FwdLayout<DH, 2>::SMEM, p, stream, tq, tk, tv, to,
                  p.stats, p.S, p.H, p.scale);
  return run<1>(flash_fwd_kernel<DH, 1>, FwdLayout<DH, 1>::SMEM, p, stream, tq, tk, tv, to,
                p.stats, p.S, p.H, p.scale);
}

template <int DH>
cudaError_t bwd(const Params& p, cudaStream_t stream) {
  CUtensorMap tq, tk, tv, tdo, tdq, tdk, tdv;
  if (!map_in(&tq, p, p.q, DH) || !map_in(&tk, p, p.k, DH) || !map_in(&tv, p, p.v, DH) ||
      !map_out(&tdo, p, p.dout, DH) || !map_in(&tdq, p, p.dq, DH) || !map_in(&tdk, p, p.dk, DH) ||
      !map_in(&tdv, p, p.dv, DH))
    return cudaErrorInvalidValue;
  cudaError_t err = run<1>(flash_bwd_dq_kernel<DH>, DqLayout<DH>::SMEM, p, stream, tq, tk, tv, tdo,
                           tdq, p.stats, p.S, p.H, p.scale);
  if (err != cudaSuccess) return err;
  return run<1>(flash_bwd_dkv_kernel<DH>, DkvLayout<DH>::SMEM, p, stream, tq, tk, tv, tdo, tdk,
                tdv, static_cast<const float*>(p.stats), p.S, p.H, p.scale);
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
  if (p.S < 1 || p.H < 1 || p.B < 1) return cudaErrorInvalidValue;
  if (dh == 64) return fwd<64>(p, stream);
  if (dh == 32) return fwd<32>(p, stream);
  return cudaErrorInvalidValue;
}

cudaError_t launch_bwd(const Params& p, int dh, cudaStream_t stream) {
  if (p.stats == nullptr || p.S < 1 || p.H < 1 || p.B < 1) return cudaErrorInvalidValue;
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

// Sets the forward's query rows a block (64 or 128; 0 restores 64, the
// form every launch takes) and returns the previous setting: the tile
// measurement of chip_smoke.py's flash phase.
int dp_flash_fwd_rows(int rows) {
  const int prev = dp_flash::g_fwd_rows;
  if (rows == 0 || rows == 64 || rows == 128) dp_flash::g_fwd_rows = rows == 0 ? 64 : rows;
  return prev;
}

}  // extern "C"
