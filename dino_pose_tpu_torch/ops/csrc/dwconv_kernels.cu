// FastViT's stride-1 depthwise convs and the RepMixer-combine + depthwise
// conv segment for Hopper (sm_90a), CUDA C++ with a plain C interface
// (loaded with ctypes by dino_pose_tpu_torch/ops/_ext.py).
//
// Two kernel templates replace three Pallas kernels of
// dino_pose_tpu/ops/dwconv.py, all built on the same k x k tap walk
// (_tap_conv, :75):
//
//   dw_kernel<K, RB>     _dw_kernel (:54)              y   = conv(x)
//   pair_kernel<K, 0>    _combine_dw_fwd_kernel (:287) x2  = bf16(a*x + b*y0 + bias),
//                                                      y7  = conv(x2 as rounded)
//   pair_kernel<K, 1>    _combine_dw_bwd_kernel (:310) dx2 = dx2bar + conv'(dy7bar),
//                                                      dx = bf16(dx2*a), dy0 = bf16(dx2*b),
//                                                      sums of dx2*x, dx2*y0, dx2
//
// conv is the stride-1 SAME depthwise (multiplier-1) cross-correlation with
// f32 taps (k*k, C) and f32 sums, rounded once; conv' the same with the
// taps mirrored in H and W, which the kernels read by index (flip), so no
// flipped copy of the taps is made. Activations are NHWC bf16
// (channels_last), per-channel vectors f32.
//
// dw_kernel. The TPU kernel views a sample as an (H, W*C) plane so that C =
// 48 still fills 128-wide vector lanes. Here the work is cut into items of
// (sample, strip of TH output rows, column tile of TWc output columns, group
// of CG <= 64 channels), which the wrapper's plan sizes so that the grid
// covers the 132 SMs at every batch (at batch 1 by tiling W as well as H):
//
//   * persistent blocks walk the items (item = blockIdx.x, + gridDim.x, ...,
//     the channel group slowest); an item's tile (TH + K - 1 rows x TWc +
//     K - 1 columns x CG channels of bf16, zero outside the image: SAME
//     padding) is staged in shared memory by cp.async in 16-byte vectors (8
//     channels), zero-filled by the copy's source size, into one of two
//     buffers: the next item's tile while the block computes the current
//     one;
//   * thread t takes channel pair t % np (np = CG/2) and the (RB-row,
//     8-column) slots t / np, + NT / np, ... of the item; each window row of
//     8 + K - 1 values is read once from shared memory as bf16x2 (both
//     channels in one 4-byte read) and feeds every output row of the slot it
//     touches (RB = 2 where the batch fills the card: register blocking,
//     (2+K-1)*(8+K-1)/16 reads an output pair instead of K*K; RB = 1 at
//     small grids, a shorter chain a thread); outputs are stored as bf16x2;
//   * the pair's 2*K*K f32 taps stay in registers, loaded while the first
//     tile is in flight (at most 170 registers a thread, two blocks of up to
//     192 threads an SM);
//   * the tile's 8-pixel chunks are padded so that a chunk's stride is the
//     channel-pair count modulo 32 banks: the lanes of a warp, which take
//     consecutive (chunk, pair) slots, read 32 different banks.
//
// Where C or the group is not a multiple of 8 channels (fastvit_ma36's C =
// 76), the tile is staged a channel pair at a time with plain loads; odd C
// takes single-channel loads and stores at the pair's edge.
//
// Bound on an H100: 2*K*K f32 FLOPs an output on the CUDA cores (67
// TFLOP/s), or the bf16 activations read and written once at 3.35 TB/s; at
// t8's stage 0 (B = 128, 64x64, C = 48) the K = 7 conv's 2.47 GFLOP take
// 0.037 ms (operations), the K = 3 conv's bytes 0.030 ms. The K = 7 conv
// is bound by instruction issue (the bf16x2 unpacking and the shared-memory
// reads beside each fused multiply-add); PERF.md holds its times.
//
// pair_kernel: see its own note below.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <mutex>

#include "hopper.cuh"

typedef __nv_bfloat16 bf16;
typedef __nv_bfloat162 bf162;

namespace {

using namespace dp_hopper;

constexpr int MAX_THREADS = 192;  // two blocks an SM at up to 170 registers a thread
constexpr int TW = 8;              // output columns of a thread's slot
constexpr int MAX_CG = 64;   // channels of a group
constexpr int SMEM_LIMIT = 232448;

__host__ __device__ __forceinline__ size_t align128(size_t n) {
  return (n + 127) & ~static_cast<size_t>(127);
}

// The tile's layout in bf16 elements: pixel stride ps (the group's channels
// rounded up to even), 8-pixel chunk stride cs = 8*ps + pad, row stride rs.
// The pad, (-7*np) mod 32 four-byte words for np = ps/2 pairs, makes cs
// congruent to np words modulo the 32 banks.
struct Layout {
  int ps, cs, rs, rows, cols;
  __host__ __device__ Layout(int TH, int TWc, int K, int CG) {
    ps = (CG + 1) & ~1;
    const int np = ps / 2;
    cs = 8 * ps + 2 * (((-7 * np) % 32 + 32) % 32);
    rows = TH + K - 1;
    cols = TWc + K - 1;
    rs = (cols + 7) / 8 * cs;
  }
  __host__ __device__ size_t tile_bytes() const {
    return align128(static_cast<size_t>(rows) * rs * 2);
  }
};

// Two tile buffers. ops/dwconv.py's _smem_bytes computes the same.
size_t smem_bytes(int TH, int TWc, int K, int CG) {
  return 2 * Layout(TH, TWc, K, CG).tile_bytes();
}

struct Args {
  const bf16* src;     // x
  const float* taps;   // (K*K, C) f32, row dh*K + dw
  bf16* out;           // y
  int H, W, C, TH, TWc, CG, groups, strips, ctiles, items, flip;
};

struct Item {
  int n, r0, w0, c0, cgn;
};

// Items in the order (group, sample, strip, column tile), the group
// slowest: a block's items (item, + gridDim.x, ...) change group at most
// groups - 1 times.
__device__ __forceinline__ Item decode(const Args& p, int item) {
  Item it;
  const int per_group = p.items / p.groups;
  const int g = item / per_group, s = item - g * per_group;
  const int ct = s % p.ctiles, t = s / p.ctiles;
  it.n = t / p.strips;
  it.r0 = (t - it.n * p.strips) * p.TH;
  it.w0 = ct * p.TWc;
  it.c0 = g * p.CG;
  it.cgn = min(p.CG, p.C - it.c0);
  return it;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ float bf(bf16 v) { return __bfloat162float(v); }

// One pair of activations at o (channels o, o + 1 where have1), as f32.
__device__ __forceinline__ float2 load_pair(const bf16* p, size_t o, bool pairs, bool have1) {
  if (pairs) return __bfloat1622float2(*reinterpret_cast<const bf162*>(p + o));
  return make_float2(bf(p[o]), have1 ? bf(p[o + 1]) : 0.f);
}

__device__ __forceinline__ void store_pair(bf16* p, size_t o, float v0, float v1, bool pairs,
                                           bool have1) {
  if (pairs) {
    *reinterpret_cast<bf162*>(p + o) = __floats2bfloat162_rn(v0, v1);
  } else {
    p[o] = __float2bfloat16(v0);
    if (have1) p[o + 1] = __float2bfloat16(v1);
  }
}

// Walks the tile's pixels (row, col) of this thread: pixel index first,
// then += step, rows of L.cols pixels.
struct PixelWalk {
  int row, col;
  __device__ __forceinline__ PixelWalk(int first, int cols) : row(0), col(first) { wrap(cols); }
  __device__ __forceinline__ void next(int step, int cols) {
    col += step;
    wrap(cols);
  }
  __device__ __forceinline__ void wrap(int cols) {
    while (col >= cols) {
      col -= cols;
      ++row;
    }
  }
};

// Stages item `it`'s tile into T. Where C and CG are multiples of 8: by
// cp.async in 16-byte vectors, zero-filled outside the image, committed as
// one group and not waited for. Elsewhere a channel pair at a time with
// plain loads.
template <int K>
__device__ __forceinline__ void stage(const Args& p, const Layout& L, const Item& it, bf16* T,
                                      bool vec, bool pairs) {
  constexpr int P = K / 2;
  const int tid = threadIdx.x, nt = blockDim.x;
  const size_t img = static_cast<size_t>(it.n) * p.H * p.W * p.C;
  const int h0 = it.r0 - P, w0 = it.w0 - P;
  const int vw = vec ? 8 : 2, per = L.ps / vw;  // nt is a multiple of per
  const int cl = tid % per * vw, step = nt / per;
  const bool ch_in = cl < it.cgn, have1 = cl + 1 < it.cgn;
  for (PixelWalk pw(tid / per, L.cols); pw.row < L.rows; pw.next(step, L.cols)) {
    const int h = h0 + pw.row, w = w0 + pw.col;
    const bool in = ch_in && h >= 0 && h < p.H && w >= 0 && w < p.W;
    const size_t off = in ? img + (static_cast<size_t>(h) * p.W + w) * p.C + it.c0 + cl : 0;
    const int d = pw.row * L.rs + (pw.col >> 3) * L.cs + (pw.col & 7) * L.ps + cl;
    if (vec) {
      cp_async16(T + d, p.src + off, in);
      continue;
    }
    const float2 v = in ? load_pair(p.src, off, pairs, have1) : make_float2(0.f, 0.f);
    *reinterpret_cast<bf162*>(T + d) = __floats2bfloat162_rn(v.x, v.y);  // exact: bf16 values
  }
  if (vec) cp_commit();
}

// RBV output rows a thread's slot (1 where the grid is small: shorter
// chains a thread; 2 at large batches: each window row feeds two); the
// pair's taps in registers.
template <int K, int RBV>
__global__ void __launch_bounds__(MAX_THREADS, 2) dw_kernel(const Args p) {
  constexpr int NV = TW + K - 1;                // values of a window row
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L(p.TH, p.TWc, K, p.CG);
  const size_t tile_b = L.tile_bytes();
  const int nt = blockDim.x, tid = threadIdx.x;
  const int np = L.ps / 2, pr = tid % np, slot0 = tid / np, nslot = nt / np;
  const int chs = p.TWc / TW, subs = p.TH / RBV * chs;
  const bool vec = p.C % 8 == 0 && p.CG % 8 == 0, pairs = p.C % 2 == 0;

  float tx[K * K], ty[K * K];  // the pair's taps
  Item grp;                    // the channel group loaded
  grp.c0 = -1;
  grp.cgn = 0;

  // A channel group's taps: in registers, their loads in flight beside the
  // tile's.
  auto load_group = [&](const Item& it) {
    const int c = it.c0 + 2 * pr;
    const bool have0 = 2 * pr < it.cgn, have1 = 2 * pr + 1 < it.cgn;
#pragma unroll
    for (int j = 0; j < K * K; ++j) {
      const int src = (p.flip ? K * K - 1 - j : j) * p.C + c;
      tx[j] = have0 ? p.taps[src] : 0.f;
      ty[j] = have1 ? p.taps[src + 1] : 0.f;
    }
    grp = it;
  };

  if (blockIdx.x < p.items) {
    const Item first = decode(p, blockIdx.x);
    stage<K>(p, L, first, reinterpret_cast<bf16*>(smem), vec, pairs);
    load_group(first);
  }
  for (int k = 0, item = blockIdx.x; item < p.items; ++k, item += gridDim.x) {
    bf16* const T = reinterpret_cast<bf16*>(smem + (k & 1) * tile_b);
    const Item it = decode(p, item);
    cp_wait_all();
    __syncthreads();  // this item's tile has landed; the other buffer is free
    if (it.c0 != grp.c0) load_group(it);  // a new channel group, the same for the whole block
    if (item + static_cast<int>(gridDim.x) < p.items)
      stage<K>(p, L, decode(p, item + gridDim.x),
               reinterpret_cast<bf16*>(smem + ((k + 1) & 1) * tile_b), vec, pairs);

    const int c = it.c0 + 2 * pr;
    const bool have0 = 2 * pr < it.cgn, have1 = 2 * pr + 1 < it.cgn;
    const size_t img = static_cast<size_t>(it.n) * p.H * p.W * p.C;

    for (int q = slot0; q < subs && have0; q += nslot) {
      const int rg = q / chs, ch = q - rg * chs;
      const int hb = it.r0 + rg * RBV, wb = it.w0 + ch * TW;
      const int nw = min(TW, p.W - wb);
      const bf16* tb = T + rg * RBV * L.rs + ch * L.cs + 2 * pr;
      float acc[RBV][TW][2];
#pragma unroll
      for (int j = 0; j < RBV; ++j)
#pragma unroll
        for (int i = 0; i < TW; ++i) acc[j][i][0] = acc[j][i][1] = 0.f;
#pragma unroll
      for (int r = 0; r < RBV + K - 1; ++r) {
        const bf16* rp = tb + r * L.rs;
        float2 v[NV];
#pragma unroll
        for (int i = 0; i < NV; ++i)
          v[i] = __bfloat1622float2(
              *reinterpret_cast<const bf162*>(rp + (i >> 3) * L.cs + (i & 7) * L.ps));
#pragma unroll
        for (int j = 0; j < RBV; ++j) {
          const int dh = r - j;
          if (dh < 0 || dh >= K) continue;
          float2 t[K];
#pragma unroll
          for (int dw = 0; dw < K; ++dw) t[dw] = make_float2(tx[dh * K + dw], ty[dh * K + dw]);
#pragma unroll
          for (int i = 0; i < TW; ++i)
#pragma unroll
            for (int dw = 0; dw < K; ++dw) {
              acc[j][i][0] = fmaf(v[i + dw].x, t[dw].x, acc[j][i][0]);
              acc[j][i][1] = fmaf(v[i + dw].y, t[dw].y, acc[j][i][1]);
            }
        }
      }
#pragma unroll
      for (int j = 0; j < RBV; ++j) {
        const int h = hb + j;
        if (h >= p.H) break;
        const size_t orow = img + static_cast<size_t>(h) * p.W * p.C + c;
#pragma unroll
        for (int i = 0; i < TW; ++i) {
          if (i >= nw) break;
          store_pair(p.out, orow + static_cast<size_t>(wb + i) * p.C, acc[j][i][0], acc[j][i][1],
                     pairs, have1);
        }
      }
    }
  }
}

// ===========================================================================
// pair_kernel<K, BWD, TWT>: the RepMixer-combine + depthwise-conv segment,
// forward (BWD = 0, replaces _combine_dw_fwd_kernel) and backward (BWD = 1,
// replaces _combine_dw_bwd_kernel), written for Hopper's TMA and mbarriers.
//
// Items are (sample, band of TH rows, column tile of TWc columns, group of
// CG channels), the group slowest; persistent blocks walk them (item =
// blockIdx.x, + gridDim.x, ...). A block streams an item's input rows, RB =
// 2 at a time, through a ring of shared-memory stages:
//
//   * thread 0 issues, for step t of an item, a 4-D TMA box over the NHWC
//     tensor, (CG channels, TWc + K - 1 columns, RB rows, 1 sample), of the
//     conv's operand (x and y0 forward, dy7bar backward) at input rows h0 -
//     P + t*RB: the image's edge and the channels past C arrive as zeros,
//     so the SAME padding costs no address arithmetic; the backward's
//     dx2bar, x and y0 come in boxes without the column halo at the output
//     rows of the step. Its loads run `stages` steps ahead of the block,
//     across items, so the next item's boxes are in flight while the
//     current one computes: a step's stage is refilled as soon as the
//     block's barrier shows it read (after the conversion forward, after
//     the epilogue backward). No producer warp: a forward block of 6 warps
//     keeps 168 registers a thread at two blocks an SM, a backward block of
//     6 up to 255 at one, which the K = 7 conv needs (TWT below). The
//     boxes' tensor maps are encoded once per data pointer and shape and
//     cached;
//   * the consumers convert each landed chunk once into an f32 ring of RB +
//     K - 1 rows (the conv's window): forward x2 = bf16(a*x + b*y0 + bias)
//     with combine1's rounding, 0 at pixels outside the image (the combine
//     of two zero-filled operands would be bias: the padding is x2's, not
//     x's), the item's own pixels of x2 written out as 16-byte vectors;
//     backward dy7bar as it is. So every input pixel is combined and
//     unpacked once an item (the row halo is shared by the band, only the
//     column halo of a tile narrower than W is redone), and the conv reads
//     f32 words with no unpacking;
//   * thread t takes channel t % CG and the TWT-column slot t / CG of the
//     item; its K*K f32 taps stay in registers; each of the RB + K - 1
//     window rows of TWT + K - 1 values is read once and feeds both output
//     rows (an 8-pixel chunk's stride is CG words modulo the 32 banks, so a
//     warp's lanes, which take consecutive (slot, channel) pairs, read 32
//     different banks);
//   * forward y7 is rounded and stored; backward dx2 = dx2bar + the conv
//     (f32), dx and dy0 rounded and stored, and the thread's f32 sums of
//     dx2*x, dx2*y0 and dx2 kept in registers. At a change of channel group
//     and at the end a block sums its threads' sums by slot in a fixed
//     order; each block writes its (3, C) slot, and the last block to finish
//     (picked by a ticket counter that only counts) adds the slots in block
//     order and resets the counter. No atomics add: the same inputs and plan
//     give the same bits.
//
// Bound on an H100: forward x, y0, x2, y7 and backward x, y0, dx2bar,
// dy7bar, dx, dy0 (bf16) at 3.35 TB/s; at t8's stage 0 (B = 128, 64x64, C =
// 48) 0.060 and 0.090 ms, above the K = 7 conv's 0.037 ms of f32 FMAs. A
// cycle trace of an instrumented build (PERF.md) put a block's time
// in the conversion and the conv with its epilogue, at about half the SM's
// issue rate, and a few percent in waiting for the TMA boxes: at K = 7 the
// kernels are held by instruction issue and registers, not bytes. C must
// be a multiple of 8 (the tensor map's 16-byte strides): the wrapper pads
// other widths.

constexpr int RB = 2;                   // input rows of a stage; output rows of a step
constexpr int PAIR_THREADS = 384;       // threads of a forward block, at most; backward half
constexpr int MAX_STAGES = 4;

// The shared memory of one pair plan, in bytes: the stages' barriers and
// the last-block flag; the group's a, b, bias (3, CG) f32; backward the
// block's sums (3, C) f32; the ring of stages (forward: x and y0 boxes with
// the column halo; backward: dy7bar's, then dx2bar's, x's and y0's
// without); the f32 conv ring of RB + K - 1 rows of TWc + K - 1 pixels in
// 8-pixel chunks of cs words (the last chunk unpadded). ops/dwconv.py's
// _pair_smem computes the same.
struct PairLayout {
  uint32_t cols, cs, roww, halo_raw, own_raw, halo, own, stage, vec, bsum, ring, conv, total;
  __host__ __device__ PairLayout(int K, bool bwd, int CG, int TWc, int stages, int C) {
    cols = TWc + K - 1;
    cs = 8 * CG + ((-7 * CG) % 32 + 32) % 32;
    roww = (cols - 1) / 8 * cs + ((cols - 1) % 8 + 1) * CG;
    halo_raw = RB * cols * CG * 2;
    own_raw = RB * TWc * CG * 2;
    halo = align128(halo_raw);
    own = align128(own_raw);
    stage = bwd ? halo + 3 * own : 2 * halo;
    vec = 128;
    bsum = vec + align128(3 * CG * 4);
    ring = bsum + (bwd ? align128(3 * C * 4) : 0);
    conv = ring + stages * stage;
    total = conv + (RB + K - 1) * roww * 4;
  }
};

struct PairArgs {
  const float* a;
  const float* b;
  const float* bias;   // forward
  const float* taps;   // (K*K, C) f32, the forward's (read mirrored backward)
  bf16* out;           // forward y7, backward dx
  bf16* out2;          // forward x2, backward dy0
  float* slots;        // backward (grid, 3, C): a block's sums
  float* sums;         // backward (3, C): da, db, dbias
  unsigned* ticket;    // backward: blocks done, 0 between launches
  int H, W, C, CG, TWc, TH, NC, stages, groups, bands, ctiles, items;
};

struct PairItem {
  int n, h0, w0, c0;
};

__device__ __forceinline__ PairItem pair_item(const PairArgs& p, int item) {
  const int per = p.items / p.groups;
  const int g = item / per, s = item - g * per;
  const int ct = s % p.ctiles, t = s / p.ctiles;
  PairItem it;
  it.n = t / p.bands;
  it.h0 = (t - it.n * p.bands) * p.TH;
  it.w0 = ct * p.TWc;
  it.c0 = g * p.CG;
  return it;
}

// x2 = bf16(a*x + b*y0 + bias): f32 products, each rounded, added left to
// right, then one bf16 rounding (no fused multiply-add: XLA rounds the
// products).
__device__ __forceinline__ bf16 combine1(float x, float y, float a, float b, float bias) {
  return __float2bfloat16(__fadd_rn(__fadd_rn(__fmul_rn(x, a), __fmul_rn(y, b)), bias));
}

__device__ __forceinline__ void consumers_sync(int nc) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(nc) : "memory");
}

// TWT: output columns of a thread's slot. 8 (the forward): blocks of up to
// 384 threads at 168 registers, two blocks an SM at 192. 16 (the
// backward): blocks of up to 192 threads at up to 255 registers, one an
// SM; the longer window row feeds twice the sums, and the epilogue's three
// operand reads, two outputs and three sums an output keep their registers.
template <int K, bool BWD, int TWT>
__global__ void __launch_bounds__(TWT == 16 ? PAIR_THREADS / 2 : PAIR_THREADS)
    pair_kernel(const __grid_constant__ CUtensorMap t_halo, const __grid_constant__ CUtensorMap t_1,
                const __grid_constant__ CUtensorMap t_2, const __grid_constant__ CUtensorMap t_3,
                const PairArgs p) {
  constexpr int P = K / 2, PRE = (K - 1) / RB;  // steps before an item's first output rows
  constexpr int RING = RB + K - 1;              // conv rows: 4 or 8, a power of two
  constexpr int NV = TWT + K - 1;
  extern __shared__ __align__(128) unsigned char smem[];
  const PairLayout L(K, BWD, p.CG, p.TWc, p.stages, p.C);
  const uint32_t base = smem_addr(smem);
  const uint32_t full = base;
  int* const last_flag = reinterpret_cast<int*>(smem + 8 * MAX_STAGES);
  float* const vec = reinterpret_cast<float*>(smem + L.vec);
  float* const bsum = reinterpret_cast<float*>(smem + L.bsum);
  float* const conv = reinterpret_cast<float*>(smem + L.conv);
  const int tid = threadIdx.x, NC = p.NC, CG = p.CG;
  const int steps = p.TH / RB + PRE;

  if (tid == 0) {
    for (int s = 0; s < p.stages; ++s) mbar_init(full + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (BWD)
    for (int i = tid; i < 3 * p.C; i += NC) bsum[i] = 0.f;
  __syncthreads();

  // Thread 0's loads: the block's (item, step) walk, `stages` steps ahead of
  // the consumers, each step into the stage the consumers last freed.
  int ld_item = blockIdx.x, ld_t = 0, ld_s = 0;
  auto issue = [&]() {
    if (ld_item >= p.items) return;
    const PairItem it = pair_item(p, ld_item);
    const int m = ld_t - PRE;  // the output rows' group of this step
    const uint32_t f = full + 8 * ld_s, dst = base + L.ring + ld_s * L.stage;
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // after the block's reads
    mbar_expect_tx(f, BWD ? L.halo_raw + (m >= 0 ? 3 * L.own_raw : 0) : 2 * L.halo_raw);
    const int hin = it.h0 - P + ld_t * RB;
    tma_load4(dst, &t_halo, f, it.c0, it.w0 - P, hin, it.n);
    if (!BWD) {
      tma_load4(dst + L.halo, &t_1, f, it.c0, it.w0 - P, hin, it.n);
    } else if (m >= 0) {
      const int ho = it.h0 + m * RB;
      tma_load4(dst + L.halo, &t_1, f, it.c0, it.w0, ho, it.n);
      tma_load4(dst + L.halo + L.own, &t_2, f, it.c0, it.w0, ho, it.n);
      tma_load4(dst + L.halo + 2 * L.own, &t_3, f, it.c0, it.w0, ho, it.n);
    }
    if (++ld_s == p.stages) ld_s = 0;
    if (++ld_t == steps) {
      ld_t = 0;
      ld_item += gridDim.x;
    }
  };
  if (tid == 0)
    for (int i = 0; i < p.stages; ++i) issue();

  // Thread t: channel t % CG of the group, 8-column slot t / CG of the item.
  const int c = tid % CG, slot = tid / CG;
  const bool conv_thread = slot < p.TWc / TWT;
  const int nv = CG / 8, cols = L.cols, npix = RB * cols;
  const int q = tid % nv, pix0 = tid / nv, pstep = NC / nv;  // the conversion's walk
  const bool converts = tid < pstep * nv;
  const int cs = L.cs, roww = L.roww;
  float tap[K * K];
  float sx = 0.f, sy = 0.f, s1 = 0.f;  // backward: sums of dx2*x, dx2*y0, dx2
  int grp = -1;                        // the channel group loaded
  int s = 0;
  uint32_t ph = 0;

  // Backward: the channel group's sums into the block's (3, C) sums, the
  // slots of each channel added in order (the conv ring is free between
  // items).
  auto flush = [&](int c0) {
    conv[tid] = sx;
    conv[NC + tid] = sy;
    conv[2 * NC + tid] = s1;
    consumers_sync(NC);
    if (tid < CG && c0 + tid < p.C) {
      float t0 = 0.f, t1 = 0.f, t2 = 0.f;
      for (int q = 0; q < p.TWc / TWT; ++q) {
        t0 += conv[q * CG + tid];
        t1 += conv[NC + q * CG + tid];
        t2 += conv[2 * NC + q * CG + tid];
      }
      bsum[c0 + tid] = t0;
      bsum[p.C + c0 + tid] = t1;
      bsum[2 * p.C + c0 + tid] = t2;
    }
    consumers_sync(NC);
    sx = sy = s1 = 0.f;
  };

  for (int item = blockIdx.x; item < p.items; item += gridDim.x) {
    const PairItem it = pair_item(p, item);
    const int gc = it.c0 + c;
    const bool active = conv_thread && gc < p.C;
    if (it.c0 != grp) {  // a new channel group, the same for the whole block
      if (BWD && grp >= 0) flush(grp);
#pragma unroll
      for (int j = 0; j < K * K; ++j) tap[j] = active ? p.taps[(BWD ? K * K - 1 - j : j) * p.C + gc] : 0.f;
      for (int i = tid; i < CG; i += NC) {
        const bool in = it.c0 + i < p.C;
        vec[i] = in ? p.a[it.c0 + i] : 0.f;
        vec[CG + i] = in ? p.b[it.c0 + i] : 0.f;
        vec[2 * CG + i] = !BWD && in ? p.bias[it.c0 + i] : 0.f;
      }
      consumers_sync(NC);
      grp = it.c0;
    }
    const float ca = vec[c], cb = vec[CG + c];
    const size_t img = static_cast<size_t>(it.n) * p.H * p.W * p.C;
    const int h_end = min(p.H, it.h0 + p.TH);

    for (int t = 0; t < steps; ++t) {
      const unsigned char* const st = smem + L.ring + s * L.stage;
      bar_wait(full + 8 * s, ph);

      // The chunk's input rows into the conv ring, 8 channels a vector:
      // thread t the vector t % nv of pixels t / nv, + NC / nv, ...
      const int r0 = it.h0 - P + t * RB;
      for (int pix = pix0; converts && pix < npix; pix += pstep) {
        const int r = pix >= cols ? 1 : 0, j = pix - r * cols;  // RB = 2 rows
        const int h = r0 + r, w = it.w0 - P + j, v = pix * nv + q;
        float f[8];
        if (BWD) {
          const uint4 d = reinterpret_cast<const uint4*>(st)[v];
          const bf16* ds = reinterpret_cast<const bf16*>(&d);
#pragma unroll
          for (int k = 0; k < 8; ++k) f[k] = bf(ds[k]);
        } else if (h >= 0 && h < p.H && w >= 0 && w < p.W && it.c0 + 8 * q < p.C) {
          const uint4 xv = reinterpret_cast<const uint4*>(st)[v];
          const uint4 yv = reinterpret_cast<const uint4*>(st + L.halo)[v];
          const bf16* xs = reinterpret_cast<const bf16*>(&xv);
          const bf16* ys = reinterpret_cast<const bf16*>(&yv);
          float va[8], vb[8], vc[8];
#pragma unroll
          for (int k = 0; k < 8; k += 4) {
            *reinterpret_cast<float4*>(va + k) = *reinterpret_cast<const float4*>(vec + 8 * q + k);
            *reinterpret_cast<float4*>(vb + k) =
                *reinterpret_cast<const float4*>(vec + CG + 8 * q + k);
            *reinterpret_cast<float4*>(vc + k) =
                *reinterpret_cast<const float4*>(vec + 2 * CG + 8 * q + k);
          }
          uint4 x2v;
          bf16* x2 = reinterpret_cast<bf16*>(&x2v);
#pragma unroll
          for (int k = 0; k < 8; ++k) {
            x2[k] = combine1(bf(xs[k]), bf(ys[k]), va[k], vb[k], vc[k]);
            f[k] = bf(x2[k]);
          }
          if (j >= P && j < P + p.TWc && h >= it.h0 && h < h_end)
            *reinterpret_cast<uint4*>(p.out2 + img + (static_cast<size_t>(h) * p.W + w) * p.C +
                                      it.c0 + 8 * q) = x2v;
        } else {
#pragma unroll
          for (int k = 0; k < 8; ++k) f[k] = 0.f;  // x2's own zero padding
        }
        float* dst = conv + ((t * RB + r) & (RING - 1)) * roww + (j >> 3) * cs + (j & 7) * CG + 8 * q;
        reinterpret_cast<float4*>(dst)[0] = make_float4(f[0], f[1], f[2], f[3]);
        reinterpret_cast<float4*>(dst)[1] = make_float4(f[4], f[5], f[6], f[7]);
      }
      consumers_sync(NC);
      if (!BWD && tid == 0) issue();  // the stage is read: refill it

      const int m = t - PRE;
      if (m >= 0 && active) {
        float acc[RB][TWT];
#pragma unroll
        for (int j = 0; j < RB; ++j)
#pragma unroll
          for (int i = 0; i < TWT; ++i) acc[j][i] = 0.f;
        const float* cb0 = conv + slot * (TWT / 8) * cs + c;
#pragma unroll
        for (int r = 0; r < RB + K - 1; ++r) {
          const float* rp = cb0 + ((m * RB + r) & (RING - 1)) * roww;
          float v[NV];
#pragma unroll
          for (int i = 0; i < NV; ++i) v[i] = rp[(i >> 3) * cs + (i & 7) * CG];
#pragma unroll
          for (int j = 0; j < RB; ++j) {
            const int dh = r - j;
            if (dh < 0 || dh >= K) continue;
#pragma unroll
            for (int i = 0; i < TWT; ++i)
#pragma unroll
              for (int dw = 0; dw < K; ++dw) acc[j][i] = fmaf(v[i + dw], tap[dh * K + dw], acc[j][i]);
          }
        }
        const bf16* d2s = reinterpret_cast<const bf16*>(st + L.halo);
        const bf16* xs = reinterpret_cast<const bf16*>(st + L.halo + L.own);
        const bf16* ys = reinterpret_cast<const bf16*>(st + L.halo + 2 * L.own);
#pragma unroll
        for (int j = 0; j < RB; ++j) {
          const int h = it.h0 + m * RB + j;
          if (h >= h_end) break;
#pragma unroll
          for (int i = 0; i < TWT; ++i) {
            const int w = it.w0 + slot * TWT + i;
            if (w >= p.W) break;
            const size_t o = img + (static_cast<size_t>(h) * p.W + w) * p.C + gc;
            if (BWD) {
              const int e = (j * p.TWc + slot * TWT + i) * CG + c;
              const float d2 = bf(d2s[e]) + acc[j][i];
              p.out[o] = __float2bfloat16(d2 * ca);
              p.out2[o] = __float2bfloat16(d2 * cb);
              sx += d2 * bf(xs[e]);
              sy += d2 * bf(ys[e]);
              s1 += d2;
            } else {
              p.out[o] = __float2bfloat16(acc[j][i]);
            }
          }
        }
      }
      consumers_sync(NC);  // the window's oldest rows are free for the next chunk
      if (BWD && tid == 0) issue();
      if (++s == p.stages) {
        s = 0;
        ph ^= 1;
      }
    }
  }

  if (BWD) {
    if (grp >= 0) flush(grp);
    const int n3 = 3 * p.C;
    float* const mine = p.slots + static_cast<size_t>(blockIdx.x) * n3;
    for (int i = tid; i < n3; i += NC) mine[i] = bsum[i];
    __threadfence();
    consumers_sync(NC);
    if (tid == 0) *last_flag = atomicAdd(p.ticket, 1u) == gridDim.x - 1;
    consumers_sync(NC);
    if (*last_flag) {
      __threadfence();
      for (int i = tid; i < n3; i += NC) {
        float acc = 0.f;
        for (int b = 0; b < static_cast<int>(gridDim.x); ++b)
          acc += __ldcg(p.slots + static_cast<size_t>(b) * n3 + i);
        p.sums[i] = acc;
      }
      if (tid == 0) *p.ticket = 0u;
    }
  }
}

// Lets an instance take up to SMEM_LIMIT bytes of dynamic shared memory:
// once per device, not once per launch.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, std::atomic<unsigned>& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned bit = dev < 32 ? 1u << dev : 0u;
  if (done.load() & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
  if (err == cudaSuccess) done.fetch_or(bit);
  return err;
}

template <int K, int RBV>
cudaError_t allow_dw() {
  static std::atomic<unsigned> done{0u};
  return allow_smem(dw_kernel<K, RBV>, done);
}

template <int K, bool BWD, int TWT>
cudaError_t allow_pair() {
  static std::atomic<unsigned> done{0u};
  return allow_smem(pair_kernel<K, BWD, TWT>, done);
}

template <int K, int RBV>
int dw_occupancy(int NT, size_t smem) {
  int blocks = 0;
  if (allow_dw<K, RBV>() != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, dw_kernel<K, RBV>, NT, smem) !=
          cudaSuccess)
    return 0;
  return blocks;
}

template <int K, bool BWD, int TWT>
int pair_occupancy(int NT, size_t smem) {
  int blocks = 0;
  if (allow_pair<K, BWD, TWT>() != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, pair_kernel<K, BWD, TWT>, NT, smem) !=
          cudaSuccess)
    return 0;
  return blocks;
}

template <int K, int RBV>
int launch_dw(const Args& p, int NT, int grid, cudaStream_t stream) {
  const cudaError_t err = allow_dw<K, RBV>();
  if (err != cudaSuccess) return static_cast<int>(err);
  dw_kernel<K, RBV><<<grid, NT, smem_bytes(p.TH, p.TWc, K, p.CG), stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The DW plan the wrapper packs once per shape: B, H, W, C, K, TH, TWc,
// CG, NT, grid, RB (ints).
enum { Q_B, Q_H, Q_W, Q_C, Q_K, Q_TH, Q_TWC, Q_CG, Q_NT, Q_GRID, Q_RB, Q_N };

// Args of a plan after checking what the kernel takes (false: refused).
bool prepare(const int* q, int flip, Args& p) {
  p = Args{};
  p.H = q[Q_H];
  p.W = q[Q_W];
  p.C = q[Q_C];
  p.TH = q[Q_TH];
  p.TWc = q[Q_TWC];
  p.CG = q[Q_CG];
  p.flip = flip;
  const int B = q[Q_B], K = q[Q_K], NT = q[Q_NT], RBV = q[Q_RB];
  if ((K != 3 && K != 7) || (RBV != 1 && RBV != 2) || B < 1 || p.H < 1 || p.W < 1 || p.C < 1 ||
      q[Q_GRID] < 1)
    return false;
  if (p.CG < 1 || p.CG > MAX_CG || (p.C % 2 == 0 && p.CG % 2 != 0)) return false;
  if (p.TH < RBV || p.TH % RBV != 0 || p.TWc < TW || p.TWc % TW != 0) return false;
  const int np = (p.CG + 1) / 2;
  if (NT < np || NT > MAX_THREADS || NT % np != 0) return false;
  if (smem_bytes(p.TH, p.TWc, K, p.CG) > static_cast<size_t>(SMEM_LIMIT)) return false;
  p.groups = (p.C + p.CG - 1) / p.CG;
  p.strips = (p.H + p.TH - 1) / p.TH;
  p.ctiles = (p.W + p.TWc - 1) / p.TWc;
  const long long items = static_cast<long long>(B) * p.strips * p.ctiles * p.groups;
  if (items > 0x7fffffff) return false;
  p.items = static_cast<int>(items);
  return true;
}

// The pair plan the wrapper packs once per shape: B, H, W, C, K, CG, TWc,
// TH, NC, stages, grid, TW (ints).
enum { R_B, R_H, R_W, R_C, R_K, R_CG, R_TWC, R_TH, R_NC, R_ST, R_GRID, R_TW, R_N };

bool prepare_pair(const int* q, bool bwd, PairArgs& p) {
  p = PairArgs{};
  p.H = q[R_H];
  p.W = q[R_W];
  p.C = q[R_C];
  p.CG = q[R_CG];
  p.TWc = q[R_TWC];
  p.TH = q[R_TH];
  p.NC = q[R_NC];
  p.stages = q[R_ST];
  const int B = q[R_B], K = q[R_K];
  if ((K != 3 && K != 7) || B < 1 || p.H < 1 || p.W < 1 || p.C < 8 || p.C % 8 != 0 ||
      q[R_GRID] < 1)
    return false;
  if (p.CG < 8 || p.CG % 8 != 0 || p.CG > 256 || p.TWc < TW || p.TWc % TW != 0 ||
      p.TWc + K - 1 > 256 || p.TH < RB || p.TH % RB != 0)
    return false;
  const int tw = q[R_TW];
  if ((tw != 8 && tw != 16) || p.TWc % tw != 0) return false;
  if (p.NC != (p.CG * (p.TWc / tw) + 31) / 32 * 32 ||
      p.NC > (tw == 16 ? PAIR_THREADS / 2 : PAIR_THREADS))
    return false;
  if (p.stages < 2 || p.stages > MAX_STAGES) return false;
  if (PairLayout(K, bwd, p.CG, p.TWc, p.stages, p.C).total > static_cast<uint32_t>(SMEM_LIMIT))
    return false;
  p.groups = (p.C + p.CG - 1) / p.CG;
  p.bands = (p.H + p.TH - 1) / p.TH;
  p.ctiles = (p.W + p.TWc - 1) / p.TWc;
  const long long items = static_cast<long long>(B) * p.bands * p.ctiles * p.groups;
  if (items > 0x7fffffff || q[R_GRID] > items) return false;
  p.items = static_cast<int>(items);
  return true;
}

// A (B, H, W, C) bf16 tensor as TMA boxes of (cg channels, bw columns, RB
// rows, 1 sample), unswizzled, zero outside. A tensor map describes only an
// address, its dims and its box, so the one encoded for the same seven
// serves every later call (the caching allocator hands the same address
// back): a small direct-mapped cache saves cuTensorMapEncodeTiled's host
// time.
CUresult encode_nhwc(CUtensorMap* map, const void* base, int B, int H, int W, int C, int cg, int bw) {
  struct Entry {
    const void* base;
    int B, H, W, C, cg, bw;
    CUtensorMap map;
  };
  static Entry cache[64] = {};
  static std::mutex lock;
  // A multiplicative hash of the address and shape: same-sized tensors lie
  // multiples of their size apart, which a plain modulus folds into one slot.
  const uint64_t key = (static_cast<uint64_t>(reinterpret_cast<uintptr_t>(base)) >> 4) ^
                       (static_cast<uint64_t>(B * 131 + H * 31 + W * 7 + C) << 40) ^
                       (static_cast<uint64_t>(cg * 17 + bw) << 52);
  const size_t slot = (key * 0x9E3779B97F4A7C15ull) >> 58;
  std::lock_guard<std::mutex> guard(lock);
  Entry& e = cache[slot];
  if (e.base != base || e.B != B || e.H != H || e.W != W || e.C != C || e.cg != cg || e.bw != bw) {
    EncodeTiledFn fn = encode_tiled();
    if (fn == nullptr) return CUDA_ERROR_NOT_FOUND;
    // cuTensorMapEncodeTiled needs a current context on the calling thread,
    // which a thread whose first CUDA work is this launch (autograd's
    // backward thread) does not have yet: bind the device's primary one.
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess || cudaSetDevice(dev) != cudaSuccess)
      return CUDA_ERROR_INVALID_CONTEXT;
    const cuuint64_t dims[4] = {static_cast<cuuint64_t>(C), static_cast<cuuint64_t>(W),
                                static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(B)};
    const cuuint64_t strides[3] = {static_cast<cuuint64_t>(C) * 2,
                                   static_cast<cuuint64_t>(W) * C * 2,
                                   static_cast<cuuint64_t>(H) * W * C * 2};
    const cuuint32_t box[4] = {static_cast<cuuint32_t>(cg), static_cast<cuuint32_t>(bw),
                               static_cast<cuuint32_t>(RB), 1};
    const cuuint32_t step[4] = {1, 1, 1, 1};
    e.base = nullptr;
    const CUresult res =
        fn(&e.map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides, box,
           step, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
           CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (res != CUDA_SUCCESS) return res;
    e.base = base;
    e.B = B;
    e.H = H;
    e.W = W;
    e.C = C;
    e.cg = cg;
    e.bw = bw;
  }
  *map = e.map;
  return CUDA_SUCCESS;
}

template <int K, bool BWD, int TWT>
int run_pair(const CUtensorMap* m, const PairArgs& p, int grid, uint32_t smem, cudaStream_t stream) {
  const cudaError_t err = allow_pair<K, BWD, TWT>();
  if (err != cudaSuccess) return static_cast<int>(err);
  pair_kernel<K, BWD, TWT><<<grid, p.NC, smem, stream>>>(m[0], m[1], m[2], m[3], p);
  return static_cast<int>(cudaGetLastError());
}

// A launch's error: a CUDA error code, or -1000 * (i + 1) - the CUresult
// of cuTensorMapEncodeTiled where tensor map i could not be encoded, -2
// where the plan's slot width is not the direction's.
template <bool BWD>
int launch_pair(const int* q, const PairArgs& p, const void* const* ops, cudaStream_t stream) {
  const int B = q[R_B], K = q[R_K], bw = p.TWc + K - 1;
  CUtensorMap m[4];
  // Forward: x and y0 with the column halo (m[2], m[3] unused copies);
  // backward: dy7bar with it, dx2bar, x and y0 without.
  for (int i = 0; i < 4; ++i) {
    const bool halo = BWD ? i == 0 : i < 2;
    const void* t = ops[BWD || i < 2 ? i : 0];
    const CUresult res = encode_nhwc(&m[i], t, B, p.H, p.W, p.C, p.CG, halo ? bw : p.TWc);
    if (res != CUDA_SUCCESS) return -1000 * (i + 1) - static_cast<int>(res);
  }
  const uint32_t smem = PairLayout(K, BWD, p.CG, p.TWc, p.stages, p.C).total;
  constexpr int TWT = BWD ? 16 : 8;
  if (q[R_TW] != TWT) return -2;
  return K == 3 ? run_pair<3, BWD, TWT>(m, p, q[R_GRID], smem, stream)
                : run_pair<7, BWD, TWT>(m, p, q[R_GRID], smem, stream);
}

}  // namespace

extern "C" {

// Shared-memory bytes a DW block asks for at a plan, the formula the
// wrapper's plan also computes.
long long dp_dw_smem_bytes(int TH, int TWc, int K, int CG) {
  return static_cast<long long>(smem_bytes(TH, TWc, K, CG));
}

// Blocks of NT threads and smem bytes that one SM holds at once (0 where
// the instance cannot launch so), for the wrapper's grid.
int dp_dw_occupancy(int K, int RBV, int NT, long long smem) {
  const size_t s = static_cast<size_t>(smem);
  if (K == 3) return RBV == 1 ? dw_occupancy<3, 1>(NT, s) : RBV == 2 ? dw_occupancy<3, 2>(NT, s) : 0;
  if (K == 7) return RBV == 1 ? dw_occupancy<7, 1>(NT, s) : RBV == 2 ? dw_occupancy<7, 2>(NT, s) : 0;
  return 0;
}

// _dw_kernel: out = conv(x), (B, H, W, C) bf16, taps (K*K, C) f32, mirrored
// in H and W where flip (the conv's transpose).
int dp_dw_conv(const void* plan, const void* x, const void* taps, void* out, int flip,
               void* stream) {
  const int* q = static_cast<const int*>(plan);
  Args p;
  if (!prepare(q, flip, p)) return static_cast<int>(cudaErrorInvalidValue);
  p.src = static_cast<const bf16*>(x);
  p.taps = static_cast<const float*>(taps);
  p.out = static_cast<bf16*>(out);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int NT = q[Q_NT], grid = q[Q_GRID];
  if (q[Q_K] == 3)
    return q[Q_RB] == 1 ? launch_dw<3, 1>(p, NT, grid, st) : launch_dw<3, 2>(p, NT, grid, st);
  return q[Q_RB] == 1 ? launch_dw<7, 1>(p, NT, grid, st) : launch_dw<7, 2>(p, NT, grid, st);
}

// Shared-memory bytes of a pair plan (bwd 0 forward, 1 backward), the
// formula the wrapper's plan also computes.
long long dp_pair_smem(int K, int bwd, int CG, int TWc, int stages, int C) {
  return static_cast<long long>(PairLayout(K, bwd != 0, CG, TWc, stages, C).total);
}

// Blocks of the pair kernel's instance (K, backward, TW columns a slot)
// that one SM holds at once (0: cannot launch so). The forward runs TW = 8,
// the backward 16.
int dp_pair_occupancy(int K, int bwd, int tw, int NT, long long smem) {
  const size_t s = static_cast<size_t>(smem);
  if ((K != 3 && K != 7) || tw != (bwd ? 16 : 8)) return 0;
  if (K == 3) return bwd ? pair_occupancy<3, true, 16>(NT, s) : pair_occupancy<3, false, 8>(NT, s);
  return bwd ? pair_occupancy<7, true, 16>(NT, s) : pair_occupancy<7, false, 8>(NT, s);
}

// _combine_dw_fwd_kernel: x2 = bf16(a*x + b*y0 + bias), y7 = conv(x2).
int dp_combine_dw(const void* plan, const void* x, const void* y0, const void* a, const void* b,
                  const void* bias, const void* taps, void* x2, void* y7, void* stream) {
  const int* q = static_cast<const int*>(plan);
  PairArgs p;
  if (!prepare_pair(q, false, p)) return static_cast<int>(cudaErrorInvalidValue);
  p.a = static_cast<const float*>(a);
  p.b = static_cast<const float*>(b);
  p.bias = static_cast<const float*>(bias);
  p.taps = static_cast<const float*>(taps);
  p.out = static_cast<bf16*>(y7);
  p.out2 = static_cast<bf16*>(x2);
  const void* ops[4] = {x, y0, nullptr, nullptr};
  return launch_pair<false>(q, p, ops, static_cast<cudaStream_t>(stream));
}

// _combine_dw_bwd_kernel on the forward's taps (read mirrored); dx, dy0
// (B, H, W, C) bf16 and sums (3, C) f32 = (da, db, dbias), through slots
// (grid, 3, C) f32, one a block, added in block order by the last block to
// finish (ticket: a zeroed counter the launch leaves at zero).
int dp_combine_dw_bwd(const void* plan, const void* x, const void* y0, const void* dx2bar,
                      const void* dy7bar, const void* a, const void* b, const void* taps,
                      void* dx, void* dy0, void* slots, void* sums, void* ticket, void* stream) {
  const int* q = static_cast<const int*>(plan);
  PairArgs p;
  if (!prepare_pair(q, true, p)) return static_cast<int>(cudaErrorInvalidValue);
  p.a = static_cast<const float*>(a);
  p.b = static_cast<const float*>(b);
  p.taps = static_cast<const float*>(taps);
  p.out = static_cast<bf16*>(dx);
  p.out2 = static_cast<bf16*>(dy0);
  p.slots = static_cast<float*>(slots);
  p.sums = static_cast<float*>(sums);
  p.ticket = static_cast<unsigned*>(ticket);
  const void* ops[4] = {dy7bar, dx2bar, x, y0};
  return launch_pair<true>(q, p, ops, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
