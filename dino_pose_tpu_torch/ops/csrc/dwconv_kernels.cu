// FastViT's stride-1 depthwise convs and the RepMixer-combine + depthwise
// conv segment for Hopper (sm_90a), CUDA C++ with a plain C interface
// (loaded with ctypes by dino_pose_tpu_torch/ops/_ext.py).
//
// One kernel template, dw_kernel<K, MODE>, replaces three Pallas kernels of
// dino_pose_tpu/ops/dwconv.py, all built on the same k x k tap walk
// (_tap_conv, :75):
//
//   MODE DW           _dw_kernel (:54)              y   = conv(x)
//   MODE COMBINE      _combine_dw_fwd_kernel (:287) x2  = bf16(a*x + b*y0 + bias),
//                                                   y7  = conv(x2 as rounded)
//   MODE COMBINE_BWD  _combine_dw_bwd_kernel (:310) dx2 = dx2bar + conv'(dy7bar),
//                                                   dx = bf16(dx2*a), dy0 = bf16(dx2*b),
//                                                   sums of dx2*x, dx2*y0, dx2
//
// conv is the stride-1 SAME depthwise (multiplier-1) cross-correlation with
// f32 taps (k*k, C) and f32 sums, rounded once; conv' the same with the
// taps mirrored in H and W, which the kernel reads by index (flip), so no
// flipped copy of the taps is made. Activations are NHWC bf16
// (channels_last), per-channel vectors f32.
//
// Design. The TPU kernels view a sample as an (H, W*C) plane so that C = 48
// still fills 128-wide vector lanes. Here the work is cut into items of
// (sample, strip of TH output rows, column tile of TWc output columns, group
// of CG <= 64 channels), which the wrapper's plan sizes so that the grid
// covers the 132 SMs at every batch (at batch 1 by tiling W as well as H,
// where the first version shrank its strips to one row with a 7x halo):
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
//   * DW and COMBINE keep the pair's 2*K*K f32 taps in registers, loaded
//     while the first tile is in flight (at most 170 registers a thread, two
//     blocks of up to 192 threads an SM); COMBINE_BWD, whose slots also hold
//     their dx2bar, x and y0 words in registers (loaded before the conv, so
//     their latency hides behind it), reads its taps from shared memory as
//     (tap, pair) float2;
//   * the tile's 8-pixel chunks are padded so that a chunk's stride is the
//     channel-pair count modulo 32 banks: the lanes of a warp, which take
//     consecutive (chunk, pair) slots, read 32 different banks;
//   * COMBINE copies x and y0 in, then forms x2 in place in f32 from the
//     per-channel a, b, bias, rounds it to bf16 and writes the item's own
//     pixels of x2 once (halo pixels recomputed by the neighbouring items
//     with the same rounding), so the conv reads x2 as rounded and x2 makes
//     no extra round trip through device memory;
//   * COMBINE_BWD adds each thread's f32 sums over its slots and items, sums
//     them over the block's threads of a channel pair in a fixed order into
//     the block's own slot (per channel group), and dw_sums_reduce_kernel
//     adds the slots in block order. No atomics: the same inputs and plan
//     give the same bits.
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

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

typedef __nv_bfloat16 bf16;
typedef __nv_bfloat162 bf162;

namespace {

constexpr int MAX_THREADS = 192;  // two blocks an SM at up to 170 registers a thread
constexpr int TW = 8;              // output columns of a thread's slot
constexpr int MAX_CG = 64;   // channels of a group
constexpr int SMEM_LIMIT = 232448;
constexpr int DW = 0, COMBINE = 1, COMBINE_BWD = 2;

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

// Two tile buffers, then COMBINE's y0 tile, or COMBINE_BWD's per-thread
// sums (6, NT) f32 and the group's taps (K*K, pairs) float2.
// ops/dwconv.py's _smem_bytes computes the same.
__host__ __device__ __forceinline__ size_t extra_offset(size_t tile, int mode, int NT) {
  return 2 * tile + (mode == COMBINE ? tile : 0) +
         (mode == COMBINE_BWD ? align128(static_cast<size_t>(6) * NT * 4) : 0);
}

size_t smem_bytes(int TH, int TWc, int K, int CG, int mode, int NT) {
  const Layout L(TH, TWc, K, CG);
  return extra_offset(L.tile_bytes(), mode, NT) +
         (mode == COMBINE_BWD ? align128(static_cast<size_t>(K) * K * L.ps * 4) : 0);
}

struct Args {
  const bf16* src;     // the conv's input: DW x, COMBINE x, COMBINE_BWD dy7bar
  const bf16* y0;      // COMBINE's second operand; COMBINE_BWD's, for the sums
  const bf16* x;       // COMBINE_BWD's x, for the sums
  const bf16* dx2bar;  // COMBINE_BWD
  const float* a;
  const float* b;
  const float* bias;
  const float* taps;   // (K*K, C) f32, row dh*K + dw
  bf16* out;           // DW y, COMBINE y7, COMBINE_BWD dx
  bf16* out2;          // COMBINE x2, COMBINE_BWD dy0
  float* slots;        // COMBINE_BWD (grid, 3, C): a block's sums
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

// x2 = bf16(a*x + b*y0 + bias): f32 products, each rounded, added left to
// right, then one bf16 rounding (no fused multiply-add: XLA rounds the
// products).
__device__ __forceinline__ bf16 combine1(float x, float y, float a, float b, float bias) {
  return __float2bfloat16(__fadd_rn(__fadd_rn(__fmul_rn(x, a), __fmul_rn(y, b)), bias));
}

// Stages item `it`'s tile into T. Where C and CG are multiples of 8: by
// cp.async in 16-byte vectors (COMBINE: x into T, y0 into Y), zero-filled
// outside the image, committed as one group and not waited for. Elsewhere a
// channel pair at a time with plain loads, COMBINE forming x2 on the way
// (rounded into T, the item's own pixels written out).
template <int K, int MODE>
__device__ __forceinline__ void stage(const Args& p, const Layout& L, const Item& it, bf16* T,
                                      bf16* Y, bool vec, bool pairs) {
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
      if (MODE == COMBINE) cp_async16(Y + d, p.y0 + off, in);
      continue;
    }
    float2 v = in ? load_pair(p.src, off, pairs, have1) : make_float2(0.f, 0.f);
    if (MODE == COMBINE && in) {
      const float2 y = load_pair(p.y0, off, pairs, have1);
      const int c = it.c0 + cl;
      bf162 x2;
      x2.x = combine1(v.x, y.x, p.a[c], p.b[c], p.bias[c]);
      x2.y = have1 ? combine1(v.y, y.y, p.a[c + 1], p.b[c + 1], p.bias[c + 1])
                   : __float2bfloat16(0.f);
      v = __bfloat1622float2(x2);
      if (pw.row >= P && pw.row < P + p.TH && pw.col >= P && pw.col < P + p.TWc)
        store_pair(p.out2, off, v.x, v.y, pairs, have1);
    }
    *reinterpret_cast<bf162*>(T + d) = __floats2bfloat162_rn(v.x, v.y);  // exact: bf16 values
  }
  if (vec) cp_commit();
}

// COMBINE's prologue on a tile staged in vectors: T = x2 from x (in T) and
// y0 (in Y) where the pixel is inside the image (outside, T keeps the zero
// the copy wrote: x2's own padding), and the item's own pixels of x2
// written out, 8 channels a thread.
template <int K>
__device__ __forceinline__ void combine_tile(const Args& p, const Layout& L, const Item& it,
                                             bf16* T, const bf16* Y) {
  constexpr int P = K / 2;
  const int tid = threadIdx.x, nt = blockDim.x;
  const size_t img = static_cast<size_t>(it.n) * p.H * p.W * p.C;
  const int h0 = it.r0 - P, w0 = it.w0 - P;
  const int per = L.ps / 8, cl = tid % per * 8, step = nt / per;
  if (cl >= it.cgn) return;
  float ca[8], cb[8], cbias[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = it.c0 + cl + j;
    ca[j] = p.a[c];
    cb[j] = p.b[c];
    cbias[j] = p.bias[c];
  }
  for (PixelWalk pw(tid / per, L.cols); pw.row < L.rows; pw.next(step, L.cols)) {
    const int h = h0 + pw.row, w = w0 + pw.col;
    if (h < 0 || h >= p.H || w < 0 || w >= p.W) continue;
    const int d = pw.row * L.rs + (pw.col >> 3) * L.cs + (pw.col & 7) * L.ps + cl;
    uint4 xv = *reinterpret_cast<const uint4*>(T + d);
    const uint4 yv = *reinterpret_cast<const uint4*>(Y + d);
    bf16* xs = reinterpret_cast<bf16*>(&xv);
    const bf16* ys = reinterpret_cast<const bf16*>(&yv);
#pragma unroll
    for (int j = 0; j < 8; ++j) xs[j] = combine1(bf(xs[j]), bf(ys[j]), ca[j], cb[j], cbias[j]);
    *reinterpret_cast<uint4*>(T + d) = xv;
    if (pw.row >= P && pw.row < P + p.TH && pw.col >= P && pw.col < P + p.TWc)
      *reinterpret_cast<uint4*>(p.out2 + img + (static_cast<size_t>(h) * p.W + w) * p.C +
                                it.c0 + cl) = xv;
  }
}

// COMBINE_BWD's taps: in shared memory as (tap, pair) float2 (channel c,
// c + 1), mirrored where flip, zero past the group's channels; loaded in
// batches of 8 a thread.
template <int K>
__device__ __forceinline__ void stage_taps(const Args& p, const Item& it, float2* taps_s,
                                           int np) {
  const int n = K * K * np, nt = blockDim.x;
  for (int base = threadIdx.x; base < n; base += 8 * nt) {
    float2 v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int i = base + u * nt, j = i / np, c = 2 * (i - j * np);
      const int src = (p.flip ? K * K - 1 - j : j) * p.C + it.c0 + c;
      v[u] = make_float2(i < n && c < it.cgn ? p.taps[src] : 0.f,
                         i < n && c + 1 < it.cgn ? p.taps[src + 1] : 0.f);
    }
#pragma unroll
    for (int u = 0; u < 8; ++u)
      if (base + u * nt < n) taps_s[base + u * nt] = v[u];
  }
}

// One bf16x2 word of activations at o (channels o, o + 1 where have1).
__device__ __forceinline__ uint32_t load_word(const bf16* p, size_t o, bool pairs, bool have1) {
  if (pairs) return *reinterpret_cast<const uint32_t*>(p + o);
  bf162 v;
  v.x = p[o];
  v.y = have1 ? p[o + 1] : __float2bfloat16(0.f);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float2 word2(uint32_t w) {
  return __bfloat1622float2(*reinterpret_cast<const bf162*>(&w));
}

// RBV output rows a thread's slot (1 where the grid is small: shorter
// chains a thread; 2 at large batches: each window row feeds two).
// COMBINE_BWD keeps its taps in shared memory (its slots hold their
// operands in registers while the conv runs); the others in registers.
template <int K, int MODE, int RBV>
__global__ void __launch_bounds__(MAX_THREADS, 2) dw_kernel(const Args p) {
  constexpr int NV = TW + K - 1;                // values of a window row
  constexpr bool TR = MODE != COMBINE_BWD;      // taps in registers
  constexpr int NTAP = TR ? K * K : 1;
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L(p.TH, p.TWc, K, p.CG);
  const size_t tile_b = L.tile_bytes();
  bf16* const Y = reinterpret_cast<bf16*>(smem + 2 * tile_b);
  float* const red = reinterpret_cast<float*>(smem + 2 * tile_b);
  const int nt = blockDim.x, tid = threadIdx.x;
  float2* const taps_s = reinterpret_cast<float2*>(smem + extra_offset(tile_b, MODE, nt));
  const int np = L.ps / 2, pr = tid % np, slot0 = tid / np, nslot = nt / np;
  const int chs = p.TWc / TW, subs = p.TH / RBV * chs;
  const bool vec = p.C % 8 == 0 && p.CG % 8 == 0, pairs = p.C % 2 == 0;

  float tx[NTAP], ty[NTAP];                          // the pair's taps (TR)
  float ca0 = 0.f, ca1 = 0.f, cb0 = 0.f, cb1 = 0.f;  // COMBINE_BWD's a, b of the pair
  float sums[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};   // COMBINE_BWD: x, y0, 1 times dx2
  Item grp;                                          // the channel group loaded
  grp.c0 = -1;
  grp.cgn = 0;
  float* const slot =
      MODE == COMBINE_BWD ? p.slots + static_cast<size_t>(blockIdx.x) * 3 * p.C : nullptr;
  if (MODE == COMBINE_BWD)
    for (int i = tid; i < 3 * p.C; i += nt) slot[i] = 0.f;

  // COMBINE_BWD: the sums of the channel group done into the block's slot,
  // its threads in slot order.
  auto flush = [&]() {
#pragma unroll
    for (int q = 0; q < 6; ++q) red[q * nt + tid] = sums[q];
    __syncthreads();
    const int c = grp.c0 + 2 * pr;
    if (slot0 == 0 && 2 * pr < grp.cgn) {
      float t[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      for (int s = 0; s < nslot; ++s)
#pragma unroll
        for (int q = 0; q < 6; ++q) t[q] += red[q * nt + s * np + pr];
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        slot[q * p.C + c] = t[2 * q];
        if (2 * pr + 1 < grp.cgn) slot[q * p.C + c + 1] = t[2 * q + 1];
      }
    }
#pragma unroll
    for (int q = 0; q < 6; ++q) sums[q] = 0.f;
  };
  // A channel group's taps (and COMBINE_BWD's a, b): in registers, their
  // loads in flight beside the tile's, or staged in shared memory.
  auto load_group = [&](const Item& it) {
    const int c = it.c0 + 2 * pr;
    const bool have0 = 2 * pr < it.cgn, have1 = 2 * pr + 1 < it.cgn;
    if (TR) {
#pragma unroll
      for (int j = 0; j < NTAP; ++j) {
        const int src = (p.flip ? K * K - 1 - j : j) * p.C + c;
        tx[j] = have0 ? p.taps[src] : 0.f;
        ty[j] = have1 ? p.taps[src + 1] : 0.f;
      }
    } else {
      stage_taps<K>(p, it, taps_s, np);
    }
    if (MODE == COMBINE_BWD) {
      ca0 = have0 ? p.a[c] : 0.f;
      cb0 = have0 ? p.b[c] : 0.f;
      ca1 = have1 ? p.a[c + 1] : 0.f;
      cb1 = have1 ? p.b[c + 1] : 0.f;
    }
    grp = it;
  };

  if (blockIdx.x < p.items) {
    const Item first = decode(p, blockIdx.x);
    stage<K, MODE>(p, L, first, reinterpret_cast<bf16*>(smem), Y, vec, pairs);
    if (TR) load_group(first);
  }
  for (int k = 0, item = blockIdx.x; item < p.items; ++k, item += gridDim.x) {
    bf16* const T = reinterpret_cast<bf16*>(smem + (k & 1) * tile_b);
    const Item it = decode(p, item);
    cp_wait_all();
    __syncthreads();  // this item's tile has landed; the other buffer is free
    if (it.c0 != grp.c0) {  // a new channel group, the same for the whole block
      if (MODE == COMBINE_BWD && grp.c0 >= 0) flush();
      load_group(it);
      if (!TR) __syncthreads();
    }
    if (MODE == COMBINE && vec) {
      combine_tile<K>(p, L, it, T, Y);
      __syncthreads();  // x2 in T; Y free
    }
    if (item + static_cast<int>(gridDim.x) < p.items)
      stage<K, MODE>(p, L, decode(p, item + gridDim.x),
                     reinterpret_cast<bf16*>(smem + ((k + 1) & 1) * tile_b), Y, vec, pairs);

    const int c = it.c0 + 2 * pr;
    const bool have0 = 2 * pr < it.cgn, have1 = 2 * pr + 1 < it.cgn;
    const size_t img = static_cast<size_t>(it.n) * p.H * p.W * p.C;
    const float2* const tp = taps_s + pr;

    for (int q = slot0; q < subs && have0; q += nslot) {
      const int rg = q / chs, ch = q - rg * chs;
      const int hb = it.r0 + rg * RBV, wb = it.w0 + ch * TW;
      const int nw = min(TW, p.W - wb);
      // COMBINE_BWD's per-output operands, loaded before the conv so that
      // their latency hides behind it.
      constexpr int OR = MODE == COMBINE_BWD ? RBV : 1, OC = MODE == COMBINE_BWD ? TW : 1;
      uint32_t od[OR][OC], ox[OR][OC], oy[OR][OC];
      if (MODE == COMBINE_BWD) {
#pragma unroll
        for (int j = 0; j < OR; ++j)
#pragma unroll
          for (int i = 0; i < OC; ++i) {
            const bool in = hb + j < p.H && i < nw;
            const size_t o = img + (static_cast<size_t>(hb + j) * p.W + wb + i) * p.C + c;
            od[j][i] = in ? load_word(p.dx2bar, o, pairs, have1) : 0u;
            ox[j][i] = in ? load_word(p.x, o, pairs, have1) : 0u;
            oy[j][i] = in ? load_word(p.y0, o, pairs, have1) : 0u;
          }
      }
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
          for (int dw = 0; dw < K; ++dw)
            t[dw] = TR ? make_float2(tx[TR ? dh * K + dw : 0], ty[TR ? dh * K + dw : 0])
                       : tp[(dh * K + dw) * np];
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
          const size_t o = orow + static_cast<size_t>(wb + i) * p.C;
          if (MODE == COMBINE_BWD) {
            const int jj = MODE == COMBINE_BWD ? j : 0, ii = MODE == COMBINE_BWD ? i : 0;
            const float2 d2 = word2(od[jj][ii]), xv = word2(ox[jj][ii]), yv = word2(oy[jj][ii]);
            const float e0 = d2.x + acc[j][i][0], e1 = d2.y + acc[j][i][1];
            store_pair(p.out, o, e0 * ca0, e1 * ca1, pairs, have1);
            store_pair(p.out2, o, e0 * cb0, e1 * cb1, pairs, have1);
            sums[0] += e0 * xv.x;
            sums[1] += e1 * xv.y;
            sums[2] += e0 * yv.x;
            sums[3] += e1 * yv.y;
            sums[4] += e0;
            sums[5] += e1;
          } else {
            store_pair(p.out, o, acc[j][i][0], acc[j][i][1], pairs, have1);
          }
        }
      }
    }
  }
  if (MODE == COMBINE_BWD) flush();
}

// out[i] = sum over slots, in slot order, of slots[s * n + i].
__global__ void dw_sums_reduce_kernel(const float* __restrict__ slots, int nslots, int n,
                                      float* __restrict__ out) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x) {
    float acc = 0.f;
    for (int s = 0; s < nslots; ++s) acc += slots[static_cast<size_t>(s) * n + i];
    out[i] = acc;
  }
}

// Lets an instance take up to SMEM_LIMIT bytes of dynamic shared memory:
// once per device, not once per launch.
template <int K, int MODE, int RBV>
cudaError_t allow_smem() {
  static std::atomic<unsigned> done{0u};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned bit = dev < 32 ? 1u << dev : 0u;
  if (done.load() & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(dw_kernel<K, MODE, RBV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM_LIMIT);
  if (err == cudaSuccess) done.fetch_or(bit);
  return err;
}

template <int K, int MODE, int RBV>
int occupancy(int NT, size_t smem) {
  int blocks = 0;
  if (allow_smem<K, MODE, RBV>() != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, dw_kernel<K, MODE, RBV>, NT, smem) !=
          cudaSuccess)
    return 0;
  return blocks;
}

template <int K, int MODE, int RBV>
int launch(const Args& p, int NT, int grid, cudaStream_t stream) {
  const cudaError_t err = allow_smem<K, MODE, RBV>();
  if (err != cudaSuccess) return static_cast<int>(err);
  dw_kernel<K, MODE, RBV><<<grid, NT, smem_bytes(p.TH, p.TWc, K, p.CG, MODE, NT), stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The plan the wrapper packs once per shape: B, H, W, C, K, TH, TWc, CG,
// NT, grid, RB (ints).
enum { Q_B, Q_H, Q_W, Q_C, Q_K, Q_TH, Q_TWC, Q_CG, Q_NT, Q_GRID, Q_RB, Q_N };

// Args of a plan after checking what the kernel takes (false: refused).
bool prepare(const int* q, int mode, int flip, Args& p) {
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
  if (smem_bytes(p.TH, p.TWc, K, p.CG, mode, NT) > static_cast<size_t>(SMEM_LIMIT)) return false;
  p.groups = (p.C + p.CG - 1) / p.CG;
  p.strips = (p.H + p.TH - 1) / p.TH;
  p.ctiles = (p.W + p.TWc - 1) / p.TWc;
  const long long items = static_cast<long long>(B) * p.strips * p.ctiles * p.groups;
  if (items > 0x7fffffff) return false;
  p.items = static_cast<int>(items);
  return true;
}

template <int MODE>
int dispatch(const int* q, const Args& p, cudaStream_t st) {
  const int NT = q[Q_NT], grid = q[Q_GRID];
  if (q[Q_K] == 3)
    return q[Q_RB] == 1 ? launch<3, MODE, 1>(p, NT, grid, st) : launch<3, MODE, 2>(p, NT, grid, st);
  return q[Q_RB] == 1 ? launch<7, MODE, 1>(p, NT, grid, st) : launch<7, MODE, 2>(p, NT, grid, st);
}

template <int MODE>
int occupancy_of(int K, int RBV, int NT, size_t smem) {
  if (K == 3) return RBV == 1 ? occupancy<3, MODE, 1>(NT, smem) : occupancy<3, MODE, 2>(NT, smem);
  if (K == 7) return RBV == 1 ? occupancy<7, MODE, 1>(NT, smem) : occupancy<7, MODE, 2>(NT, smem);
  return 0;
}

}  // namespace

extern "C" {

// Shared-memory bytes a block asks for at a plan (mode 0 DW, 1 COMBINE,
// 2 COMBINE_BWD), the formula the wrapper's plan also computes.
long long dp_dw_smem_bytes(int TH, int TWc, int K, int CG, int mode, int NT) {
  return static_cast<long long>(smem_bytes(TH, TWc, K, CG, mode, NT));
}

// Blocks of NT threads and smem bytes that one SM holds at once (0 where
// the instance cannot launch so), for the wrapper's grid.
int dp_dw_occupancy(int K, int mode, int RBV, int NT, long long smem) {
  const size_t s = static_cast<size_t>(smem);
  if (RBV != 1 && RBV != 2) return 0;
  if (mode == DW) return occupancy_of<DW>(K, RBV, NT, s);
  if (mode == COMBINE) return occupancy_of<COMBINE>(K, RBV, NT, s);
  if (mode == COMBINE_BWD) return occupancy_of<COMBINE_BWD>(K, RBV, NT, s);
  return 0;
}

// _dw_kernel: out = conv(x), (B, H, W, C) bf16, taps (K*K, C) f32, mirrored
// in H and W where flip (the conv's transpose).
int dp_dw_conv(const void* plan, const void* x, const void* taps, void* out, int flip,
               void* stream) {
  const int* q = static_cast<const int*>(plan);
  Args p;
  if (!prepare(q, DW, flip, p)) return static_cast<int>(cudaErrorInvalidValue);
  p.src = static_cast<const bf16*>(x);
  p.taps = static_cast<const float*>(taps);
  p.out = static_cast<bf16*>(out);
  return dispatch<DW>(q, p, static_cast<cudaStream_t>(stream));
}

// _combine_dw_fwd_kernel: x2 = bf16(a*x + b*y0 + bias), y7 = conv(x2).
int dp_combine_dw(const void* plan, const void* x, const void* y0, const void* a, const void* b,
                  const void* bias, const void* taps, void* x2, void* y7, void* stream) {
  const int* q = static_cast<const int*>(plan);
  Args p;
  if (!prepare(q, COMBINE, 0, p)) return static_cast<int>(cudaErrorInvalidValue);
  p.src = static_cast<const bf16*>(x);
  p.y0 = static_cast<const bf16*>(y0);
  p.a = static_cast<const float*>(a);
  p.b = static_cast<const float*>(b);
  p.bias = static_cast<const float*>(bias);
  p.taps = static_cast<const float*>(taps);
  p.out = static_cast<bf16*>(y7);
  p.out2 = static_cast<bf16*>(x2);
  return dispatch<COMBINE>(q, p, static_cast<cudaStream_t>(stream));
}

// _combine_dw_bwd_kernel on the forward's taps (read mirrored); dx, dy0
// (B, H, W, C) bf16 and sums (3, C) f32 = (da, db, dbias), through slots
// (grid, 3, C) f32, one a block, added in block order.
int dp_combine_dw_bwd(const void* plan, const void* x, const void* y0, const void* dx2bar,
                      const void* dy7bar, const void* a, const void* b, const void* taps,
                      void* dx, void* dy0, void* slots, void* sums, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* q = static_cast<const int*>(plan);
  Args p;
  if (!prepare(q, COMBINE_BWD, 1, p)) return static_cast<int>(cudaErrorInvalidValue);
  p.src = static_cast<const bf16*>(dy7bar);
  p.x = static_cast<const bf16*>(x);
  p.y0 = static_cast<const bf16*>(y0);
  p.dx2bar = static_cast<const bf16*>(dx2bar);
  p.a = static_cast<const float*>(a);
  p.b = static_cast<const float*>(b);
  p.taps = static_cast<const float*>(taps);
  p.out = static_cast<bf16*>(dx);
  p.out2 = static_cast<bf16*>(dy0);
  p.slots = static_cast<float*>(slots);
  const int err = dispatch<COMBINE_BWD>(q, p, st);
  if (err != 0) return err;
  const int n = 3 * p.C;
  dw_sums_reduce_kernel<<<(n + MAX_THREADS - 1) / MAX_THREADS, MAX_THREADS, 0, st>>>(
      static_cast<const float*>(slots), q[Q_GRID], n, static_cast<float*>(sums));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
