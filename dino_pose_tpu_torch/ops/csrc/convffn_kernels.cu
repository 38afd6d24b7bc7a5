// Fused FastViT ConvFFN forward and backward for Hopper (sm_90a), CUDA C++
// with a plain C interface (loaded with ctypes by
// dino_pose_tpu_torch/ops/_ext.py).
//
// One kernel template, convffn_kernel<BWD, NWG, NSW>, replaces three Pallas
// kernels of dino_pose_tpu/ops/convffn.py: _convffn_fwd_kernel (:92,
// pallas_call :282), _convffn_fwd_res_kernel (:370: the stage-pair arm's
// block output, res added in bf16 after the three bf16 terms) and
// _convffn_bwd_kernel (:117, pallas_call :335). Per row of the (B, S, C)
// input y (one token of the depthwise conv's output):
//
//   m   = y * inv + shift                               BatchNorm as an affine
//   h   = m @ W1 + b1 + ((m @ A1) * mask1[b]) @ B1 * s  fc1 + ConvLoRA
//   g   = gelu(h)
//   out = g @ W2 + b2 + ((g @ A2) * mask2[b]) @ B2 * s  fc2 + ConvLoRA
//
// and the backward recomputes m, u1, h, g and forms
//
//   du2 = bf16(f32(df @ B2^T) * s * mask2)
//   dg  = df @ W2^T + du2 @ A2^T                  f32
//   dh  = bf16(dg * gelu'(h))
//   du1 = bf16(f32(dh @ B1^T) * s * mask1)
//   dm  = dh @ W1^T + du1 @ A1^T                  f32
//   dy  = bf16(dm * inv)
//
// with the sums over all rows dinv = sum dm*y, dshift = sum dm, dA1 = m^T
// du1, dB1 = s u1^T dh, dA2 = g^T du2, dB2 = s u2^T df (base fc1/fc2 frozen).
// As on the TPU, the hidden h, g, dg and dh (3-4x C wide) never reach device
// memory.
//
// Design. A block is persistent: it walks 64-row tiles (wgmma's m64) in a
// fixed order. One producer thread loads each tile's y (and df) boxes by
// TMA from 2-D tensor maps over (M, C) (out-of-bounds rows and columns
// arrive as zeros), and the weights as 64 x 64 boxes of W1 and W2
// (128-byte swizzled, TMA) into a ring of RS slots guarded by mbarriers;
// where all the boxes of a tile fit (t8 and sa12 stage 0) they are loaded
// once and stay resident. The consumers are warpgroups, in one of two
// splits of the work:
//
//   the row split (C <= 128, forward 192): LANES = 2 warpgroups each take
//   their own row tile and read every weight box, so one box load serves
//   two tiles and two chains of epilogue work hide each other's latency;
//   the column split (C >= 256): NWG = 2 warpgroups share one row tile,
//   chunk j of H taken by warpgroup j % NWG, each holding its own output
//   slices (at C = 192 backward, one warpgroup).
//
// The hidden dimension is walked in 64-column chunks:
//
//   h-chunk  = m @ W1[:, chunk]            wgmma m64n64k16, W1 MN-major
//   l1       = u1b @ B1[:, chunk]          one k16 step, an accumulator of its own
//   epilogue h = bf16(bf16(bf16(acc) + bf16(b1)) + bf16(l1 * s)), g = bf16(gelu(h))
//            into shared memory as the next A operand
//   dg-chunk = [df | du2b] @ [W2[chunk]^T ; A2[chunk]^T]   (backward; W2 K-major,
//                                          du2b as one more k16 step), then
//            dh = bf16(dg * gelu'(h)) into shared memory
//   u2 += g @ A2[chunk], du1 += dh @ B1[:, chunk]^T        wgmma m64n8k16
//   dA2[chunk] += g^T du2b, dB1[chunk]^T += dh^T u1b       m64n8k16, A transposed
//   then every consumer's out (dm) slices += g-chunk @ W2[chunk] (dh-chunk @
//   W1[:, chunk]^T, the same W1 boxes read K-major), f32 in registers
//   across the whole walk.
//
// GELU and GELU' take h after its bf16 rounding: the epilogues read them
// from tables of all 65536 bf16 inputs, filled once a device with the f32
// rational erf of block_kernels.cu (XLA's), the same arithmetic as inline.
//
// Consumer warpgroup w owns the 64-column output slices s = w, w + NWG, ...:
// NSW of them a pass, 32 registers each. Where a row tile's out (dm) does
// not fit the registers of two warpgroups (backward C > 384, forward C >
// 512), the walk runs in passes, each recomputing h (and dg) for the next
// NWG * NSW slices; u2, du1 and the weight-gradient partials are taken in
// the first pass only. Where the forward's row tiles would fill less than
// half the card (B = 1 and 8 at late stages), H is split over blocks: each
// walks a run of chunk groups and writes f32 partial out and u2, and
// convffn_fwd_finish_kernel sums the splits in order and runs the
// epilogue (JAX rounds both only after the whole sum over H). The rank-R
// terms run on the tensor cores with R padded to 8 (n8) or 16 (k16) by zero
// rows: u1 = m @ A1 and du2 = df @ B2^T (n8 over K = C), the up-terms u1b @
// B1, u2b @ B2 and the K-concatenated du2b @ A2^T, du1b @ A1^T (one k16 step
// each), u2, du1 (n8), and the four weight-gradient reductions over the
// tile's rows (K = 64). The rank tiles are 8 rows of 128 bytes; where a k16
// step reads 16 rows, rows 8-15 are the next tile (finite) against A
// columns 8-15 that hold exact zeros.
//
// Gradient partials stay on chip: dinv and dshift are column sums of dm in
// f32 registers (warp shuffles, then the four warps in order); all of them
// are added into a shared-memory partial set across every tile the block
// walks and written once at its end ("persistent"). Where the set does not
// fit beside the tiles (wide C or H) each block takes one tile and writes
// its contributions once ("per tile"). convffn_bwd_reduce_kernel sums the
// sets in block order and applies s to dB1 and dB2. No atomics: the same
// inputs give the same bits on every run.
//
// Every rounding point of the JAX kernels is kept (convffn.py:96-114,
// :131-163); only the f32 summation order differs. Where the backward's C
// is wide enough that df's tile does not fit beside m's (sa12 and ma36
// stage 3), df's boxes come through the ring instead ("dfr").
//
// Shapes: C and H multiples of 16 (the wrappers zero-pad fastvit_ma36's C =
// 76 and 152); k16 steps stop at C and H. Rows past M and columns past C
// are zero in m, never written. The kernels launch on the caller's stream,
// allocate nothing and never synchronise; each C entry returns
// cudaGetLastError().
//
// Bound on an H100: 4*B*S*C*H FLOPs forward (6*B*S*C*H backward) plus the
// rank-R terms at 989 TFLOP/s, or y, df, out (dy) and the weights at 3.35
// TB/s. What holds these kernels back is the CUDA-core epilogue of every
// hidden element (roundings, GELU, dh), issued by eight consumer warps an
// SM; PERF.md holds the times.

#include <cuda_bf16.h>
#include <cuda.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <mutex>

#include "hopper.cuh"

typedef __nv_bfloat16 bf16;

namespace {

using namespace dp_hopper;

constexpr int WGT = 128;    // threads of a warpgroup
constexpr int BOX = 8192;   // a 64 x 64 bf16 tile of 128-byte swizzled rows
constexpr int RT = 1024;    // a rank tile: 8 such rows
constexpr int LIMIT = 232448;  // shared-memory bytes a Hopper block may use

// Shared memory of one plan, offsets from the 1024-byte-aligned base: the
// tile buffers (m, and df unless it comes through the ring; one per tile
// buffer and row lane), the weight ring, per consumer warpgroup its g (dh)
// tile and its chunk's B1 and A2^T rank tiles (and a zero tile after them),
// per row lane the rank tile (u1b, du2b, du1b, u2b in 16-column groups) and
// the backward's transposed rank tiles (U1T, DU2T, DU1T, U2T), the C-side
// rank tiles (A1^T and B2 per slice, a zero tile), the backward's
// column-sum scratch, the second column warpgroup's u2/du1 hand-over, per
// row lane the persistent partial set, and the barriers.
struct Layout {
  uint32_t tile, tile_bytes, ring, wg, wg_bytes, lrank, rank, tt, clora, red, xch, part,
      part_bytes, bars, total;
};

// nch: the 64-column chunks of H; lres: every chunk's B1 and A2^T rank tiles
// resident (2 nch + 1 rank tiles), else each warpgroup fills its chunk's.
__host__ __device__ inline Layout make_layout(bool bwd, int nc, int nch, int nwg, int lanes,
                                              int tb, int rs, bool dfr, bool lres, int pfloats) {
  Layout L;
  L.tile_bytes = static_cast<uint32_t>(nc) * BOX * (bwd && !dfr ? 2 : 1);
  L.tile = 0;
  uint32_t o = tb * lanes * L.tile_bytes;
  L.ring = o;
  o += static_cast<uint32_t>(rs) * BOX;
  L.wg_bytes = BOX * (bwd ? 2 : 1) + (lres ? 0 : 3 * RT);
  L.wg = o;
  o += nwg * lanes * L.wg_bytes;
  L.lrank = o;
  if (lres) o += (2 * nch + 1) * RT;
  L.rank = o;
  o += lanes * BOX;
  L.tt = o;
  if (bwd) o += lanes * 4 * RT;
  L.clora = o;
  o += (2 * nc + 1) * RT;
  L.red = o;
  if (bwd) o += nwg * lanes * 2048;
  L.xch = o;
  if (nwg > 1) o += WGT * 8 * 4;
  L.part_bytes = (static_cast<uint32_t>(pfloats) * 4 + 1023) / 1024 * 1024;
  L.part = o;
  o += lanes * L.part_bytes;
  L.bars = o;
  o += (2 * rs + 2 * tb * lanes) * 8;
  L.total = o + 1024;  // slack to align the base
  return L;
}

struct Args {
  const bf16* y;
  const bf16* res;  // the forward's residual (null: none)
  const float* inv;
  const float* shift;
  const float* b1;
  const float* b2;
  const float* m1;
  const float* m2;
  const bf16* a1;
  const bf16* b1l;
  const bf16* a2;
  const bf16* b2l;
  bf16* out;    // forward out, backward dy
  float* part;  // backward partial sets, pfloats each
  // The forward's H split: block b takes chunk groups [split * cpg, ...) of
  // its row tiles and writes f32 partial out (hout: splits x M x C) and u2
  // (hu2: splits x M x 8) for convffn_fwd_finish_kernel.
  float* hout;
  float* hu2;
  int splits, cpg;
  int M, S, C, H, R;
  float s;
  int nc, nch, tiles, passes, tb, rs, resident, dfr, persist, lres, pfloats;
};

__device__ __forceinline__ float bf16r(float v) { return __bfloat162float(__float2bfloat16(v)); }

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Byte offset of element (row, col < 64) of a tile of 128-byte rows in the
// 128-byte swizzle (16-byte chunk c of row r at chunk c ^ (r % 8)).
__device__ __forceinline__ uint32_t swz(int row, int col) {
  return row * 128 + ((((col >> 3) ^ row) & 7) << 4) + (col & 7) * 2;
}

// Stores into shared memory at byte offset `off` of the base: plain C++
// stores, which the compiler may schedule around the loads and arithmetic
// of an epilogue (an asm store with a memory clobber would order them).
__device__ __forceinline__ void sts32(unsigned char* gp, uint32_t off, uint32_t v) {
  *reinterpret_cast<uint32_t*>(gp + off) = v;
}
__device__ __forceinline__ void sts16(unsigned char* gp, uint32_t off, float v) {
  *reinterpret_cast<bf16*>(gp + off) = __float2bfloat16(v);
}

// Two bf16 from global memory by the read-only path.
__device__ __forceinline__ __nv_bfloat162 ldg_bf2(const bf16* p) {
  const unsigned int u = __ldg(reinterpret_cast<const unsigned int*>(p));
  return *reinterpret_cast<const __nv_bfloat162*>(&u);
}

__device__ __forceinline__ void fence_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// A named barrier among the consumer warpgroups (id 1).
template <int NWG>
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(NWG * WGT) : "memory");
}

// D (64 x 8 f32, 4 registers a thread) += A (64 x 16) * B (16 x 8).
template <int TA, int TB>
__device__ __forceinline__ void wgmma_n8(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {%0, %1, %2, %3}, %4, %5, p, 1, 1, "
      "%7, %8;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

__device__ __forceinline__ uint64_t kdesc(uint32_t addr) { return operand_desc<false>(addr); }
__device__ __forceinline__ uint64_t mdesc(uint32_t addr) { return operand_desc<true>(addr); }
constexpr uint64_t KSTEP = k16_step<false>(), MSTEP = k16_step<true>();

template <int N>
__device__ __forceinline__ void zero(float* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) d[i] = 0.f;
}

// The ring as one thread walks it: slot and parity of the next box. In the
// resident plan the slots are the tile's box sequence, loaded once, and a
// consumer restarts at slot 0 on each tile (parity 0 stays complete).
struct Ring {
  int slot = 0, rs = 1;
  uint32_t phase = 0;
  bool resident = false;
  __device__ __forceinline__ void next() {
    if (++slot == rs && !resident) {
      slot = 0;
      phase ^= 1;
    }
  }
};

// The consumers' side of the ring. acquire() waits for the next box and
// returns its address; release() frees a box once the products that read it
// have retired (one arrival a warpgroup); skip() walks past a box another
// warpgroup uses. retire() waits until at most one commit group is in
// flight and releases the boxes of the group before it.
struct Consumer {
  Ring ring;
  uint32_t base, full, empty;
  bool signal;
  int pend[2] = {-1, -1};
  __device__ __forceinline__ int acquire() {
    bar_wait(full + 8 * ring.slot, ring.phase);
    const int s = ring.slot;
    ring.next();
    return s;
  }
  __device__ __forceinline__ uint32_t addr(int slot) const { return base + slot * BOX; }
  __device__ __forceinline__ void release(int slot) {
    if (slot >= 0 && signal && !ring.resident) mbar_arrive(empty + 8 * slot);
  }
  __device__ __forceinline__ void skip(int n) {
    for (int i = 0; i < n; ++i) {
      if (signal && !ring.resident) {
        bar_wait(full + 8 * ring.slot, ring.phase);
        mbar_arrive(empty + 8 * ring.slot);
      }
      ring.next();
    }
  }
  __device__ __forceinline__ void retire(int s0, int s1 = -1) {
    wgmma_wait<1>();
    release(pend[0]);
    release(pend[1]);
    pend[0] = s0;
    pend[1] = s1;
  }
  __device__ __forceinline__ void drain() {
    wgmma_wait<0>();
    release(pend[0]);
    release(pend[1]);
    pend[0] = pend[1] = -1;
  }
};

// The producer's walk of one tile's weight (and, with dfr, df) boxes, in
// the order the consumers take them.
template <bool BWD, int NWG, int NSW, typename Put>
__device__ __forceinline__ void walk_boxes(const Args& a, int t, int g0, int g1, Put put) {
  if (BWD && a.dfr)
    for (int k = 0; k < a.nc; ++k) put(1, 64 * k, 64 * t);  // du2
  for (int p = 0; p < a.passes; ++p) {
    for (int g = g0; g < g1; ++g) {
      for (int w = 0; w < NWG; ++w) {
        const int j = g * NWG + w;
        if (j >= a.nch) continue;
        for (int k = 0; k < a.nc; ++k) put(2, 64 * j, 64 * k);  // W1(k, j): h
        if (BWD)
          for (int k = 0; k < a.nc; ++k) {
            put(3, 64 * k, 64 * j);  // W2(j, k): dg
            if (a.dfr) put(1, 64 * k, 64 * t);
          }
      }
      for (int q = 0; q < NSW; ++q)
        for (int o = 0; o < NWG; ++o) {
          const int s = o + NWG * (q + p * NSW);
          if (s >= a.nc) continue;
          for (int w = 0; w < NWG; ++w) {
            const int j = g * NWG + w;
            if (j >= a.nch) continue;
            if (BWD)
              put(2, 64 * j, 64 * s);  // W1(s, j): dm
            else
              put(3, 64 * s, 64 * j);  // W2(j, s): out
          }
        }
    }
    if (BWD && a.dfr && p == 0)
      for (int q = 0; q * NWG < a.nc; ++q)
        for (int o = 0; o < NWG; ++o)
          if (o + NWG * q < a.nc) put(1, 64 * (o + NWG * q), 64 * t);  // dB2
  }
}

// Phi(z) = (1 + erf(z / sqrt 2)) / 2, erf as XLA's f32 rational
// approximation (x P(x^2) / Q(x^2), x clamped to [-4, 4]), the erf JAX's
// compiler emits. GELU(h) = h Phi(h) (exact, erf) and GELU'(h) = Phi(h) +
// h phi(h) share it.
__device__ __forceinline__ float gelu_cdf(float z) {
  const float x = fminf(fmaxf(z * 0.70710678118654752440f, -4.f), 4.f);
  const float t = x * x, t2 = t * t, t4 = t2 * t2;
  // P(t) = c0 + c1 t + ... + c6 t^6 and Q(t) = d0 + ... + d4 t^4 by Estrin's
  // scheme: shorter dependency chains than Horner's.
  const float p = fmaf(fmaf(-2.72614225801306e-10f, t2,
                            fmaf(2.77068142495902e-08f, t, -2.10102402082508e-06f)),
                       t4,
                       fmaf(fmaf(-5.69250639462346e-05f, t, -7.34990630326855e-04f), t2,
                            fmaf(-2.95459980854025e-03f, t, -1.60960333262415e-02f)));
  const float q = fmaf(-1.45660718464996e-05f, t4,
                       fmaf(fmaf(-2.13374055278905e-04f, t, -1.68282697438203e-03f), t2,
                            fmaf(-7.37332916720468e-03f, t, -1.42647390514189e-02f)));
  return 0.5f * (1.f + __fdividef(x * p, q));
}

__device__ __forceinline__ float gelu_grad(float z) {
  return gelu_cdf(z) + z * __expf(-0.5f * z * z) * 0.3989422804014327f;
}

// h is rounded to bf16 before GELU, so both functions take one of 65536
// inputs: the epilogues read them from tables of every bf16 h, filled once
// a device by gelu_table_kernel with the functions above (the same f32
// arithmetic; a table read in place of ~25 instructions an element).
__device__ unsigned short g_gelu[65536];  // bf16 bits of bf16(h Phi(h))
__device__ float g_gelu_grad[65536];      // GELU'(h)

__global__ void gelu_table_kernel() {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < 65536; i += gridDim.x * blockDim.x) {
    const float h = __bfloat162float(__ushort_as_bfloat16(static_cast<unsigned short>(i)));
    g_gelu[i] = __bfloat16_as_ushort(__float2bfloat16(h * gelu_cdf(h)));
    g_gelu_grad[i] = gelu_grad(h);
  }
}

// The rank values of one n8 accumulator, rounded: v * scale * mask (mask of
// the row's sample and rank; zero past M and R), into 16-column group `grp`
// of the rank tile and, when `transposed`, the transposed tile at tt (both
// offsets from the shared base gp).
__device__ __forceinline__ void put_rank(const Args& a, unsigned char* gp, const float* v,
                                         float scale, const float* mask, int m0, uint32_t rank,
                                         int grp, bool transposed, uint32_t tt, int lane, int wq) {
  float r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = 16 * wq + (lane >> 2) + 8 * (i >> 1), rr = 2 * (lane & 3) + (i & 1);
    const int gm = m0 + row;
    const float mk = gm < a.M && rr < a.R ? __ldg(mask + (gm / a.S) * a.R + rr) : 0.f;
    r[i] = bf16r(v[i] * scale * mk);
    if (transposed) sts16(gp, tt + swz(rr, row), r[i]);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = 16 * wq + (lane >> 2) + 8 * h;
    sts32(gp, rank + swz(row, 16 * grp + 2 * (lane & 3)), pack2(r[2 * h], r[2 * h + 1]));
  }
}

// The kernel. NWG consumer warpgroups split one row tile's chunks and
// output slices (the column split, wide C); LANES warpgroups each take their
// own row tile and read every weight box (the row split, narrow C: NWG = 1),
// so that one box load serves LANES tiles and LANES chains of epilogue work
// hide each other's latency. One producer thread issues the TMA loads: of a
// warp beside one consumer warpgroup (5 warps, up to 255 registers a
// thread), of a warpgroup beside two, which hands its registers to the
// consumers (setmaxnreg: 40 and 232; 12 warps would leave 168).
// Element i (< 1024) of chunk j's rank tiles at dst: B1(j) (8 rows r, 64
// columns h of b1l) then A2^T(j) (8 rows r, 64 columns h of a2^T), zero past
// R and H.
__device__ __forceinline__ void fill_chunk_rank(const Args& a, unsigned char* dst, int j, int i) {
  const int which = i / 512, r = (i / 64) % 8, c = i % 64, h = 64 * j + c;
  const bool in = r < a.R && h < a.H;
  const float v = !in ? 0.f
                  : which == 0 ? __bfloat162float(a.b1l[r * a.H + h])
                               : __bfloat162float(a.a2[h * a.R + r]);
  *reinterpret_cast<bf16*>(dst + which * RT + swz(r, c)) = __float2bfloat16(v);
}

template <int CW>
constexpr int block_threads() {
  return CW * WGT + (CW > 1 ? WGT : 32);
}

template <bool BWD, int NWG, int NSW, int LANES>
__global__ void __launch_bounds__(block_threads<NWG * LANES>(), 1)
convffn_kernel(const __grid_constant__ CUtensorMap tm_y, const __grid_constant__ CUtensorMap tm_df,
               const __grid_constant__ CUtensorMap tm_w1, const __grid_constant__ CUtensorMap tm_w2,
               const Args a) {
  constexpr int CW = NWG * LANES;  // consumer warpgroups
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* gp = smem_raw + (base - raw);  // generic pointer to the base
  const Layout L = make_layout(BWD, a.nc, a.nch, NWG, LANES, a.tb, a.rs, a.dfr, a.lres,
                               a.persist ? a.pfloats : 0);
  const uint32_t full = base + L.bars, empty = full + 8 * a.rs;
  const uint32_t tfull = empty + 8 * a.rs, tempty = tfull + 8 * a.tb * LANES;
  const int tid = threadIdx.x;
  const int wg = __shfl_sync(0xffffffffu, tid / WGT, 0);  // warp-uniform role
  const int C = a.C, H = a.H, R = a.R, nc = a.nc;
  // This block's row tiles (a stride of blocks) and chunk groups [g0, g1).
  const int bidx = blockIdx.x / a.splits, bstride = gridDim.x / a.splits;
  const int split = blockIdx.x % a.splits;
  const int g0 = split * a.cpg, g1 = min((a.nch + NWG - 1) / NWG, g0 + a.cpg);

  // Barriers; zero the rank, chunk-rank and partial regions; the C-side rank
  // tiles A1^T(s) and B2(s) (8 rows r, 64 columns c each) from a1 and b2l.
  if (tid == 0) {
    for (int s = 0; s < a.rs; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, CW);
    }
    for (int i = 0; i < a.tb * LANES; ++i) {
      mbar_init(tfull + 8 * i, 1);
      mbar_init(tempty + 8 * i, NWG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int i = tid; i < LANES * BOX / 16; i += blockDim.x)
    reinterpret_cast<uint4*>(gp + L.rank)[i] = make_uint4(0, 0, 0, 0);
  if (a.lres) {
    // Every chunk's rank tiles B1(j) (rows r, columns h) and A2^T(j), then a
    // zero tile.
    for (int i = tid; i < a.nch * 1024; i += blockDim.x)
      fill_chunk_rank(a, gp + L.lrank + (i / 1024) * 2 * RT, i / 1024, i % 1024);
    for (int i = tid; i < RT / 16; i += blockDim.x)
      reinterpret_cast<uint4*>(gp + L.lrank + 2 * a.nch * RT)[i] = make_uint4(0, 0, 0, 0);
  } else {
    for (int w = 0; w < CW; ++w)
      for (int i = tid; i < 3 * RT / 16; i += blockDim.x)
        reinterpret_cast<uint4*>(gp + L.wg + w * L.wg_bytes + BOX * (BWD ? 2 : 1))[i] =
            make_uint4(0, 0, 0, 0);
  }
  if (a.persist)
    for (int i = tid; i < LANES * static_cast<int>(L.part_bytes) / 4; i += blockDim.x)
      reinterpret_cast<float*>(gp + L.part)[i] = 0.f;
  for (int i = tid; i < nc * 512; i += blockDim.x) {
    const int s = i / 512, r = (i / 64) % 8, c = i % 64, gc = 64 * s + c;
    const bool in = r < R && gc < C;
    const float va = in ? __bfloat162float(a.a1[gc * R + r]) : 0.f;
    const float vb = in ? __bfloat162float(a.b2l[r * C + gc]) : 0.f;
    *reinterpret_cast<bf16*>(gp + L.clora + s * RT + swz(r, c)) = __float2bfloat16(va);
    *reinterpret_cast<bf16*>(gp + L.clora + (nc + s) * RT + swz(r, c)) = __float2bfloat16(vb);
  }
  for (int i = tid; i < RT / 16; i += blockDim.x)
    reinterpret_cast<uint4*>(gp + L.clora + 2 * nc * RT)[i] = make_uint4(0, 0, 0, 0);
  fence_async();
  __syncthreads();

  if (wg == CW) {
    // Producer: one thread issues every TMA load of the block.
    if (CW > 1) asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == CW * WGT) {
      Ring ring;
      ring.rs = a.rs;
      ring.resident = a.resident;
      auto put = [&](int which, int c0, int c1) {
        const CUtensorMap* map = which == 1 ? &tm_df : which == 2 ? &tm_w1 : &tm_w2;
        const uint32_t f = full + 8 * ring.slot;
        bar_wait(empty + 8 * ring.slot, ring.phase ^ 1);
        mbar_expect_tx(f, BOX);
        tma_load(base + L.ring + ring.slot * BOX, map, f, c0, c1);
        ring.next();
      };
      if (a.resident) walk_boxes<BWD, NWG, NSW>(a, 0, g0, g1, put);
      const int nbox = nc * (BWD && !a.dfr ? 2 : 1);
      int it = 0;
      for (int t0 = bidx * LANES; t0 < a.tiles; t0 += bstride * LANES, ++it) {
        const int tb = it % a.tb;
        const uint32_t ph = (it / a.tb) & 1;
        for (int ln = 0; ln < LANES; ++ln) {
          const int bi = tb * LANES + ln, t = t0 + ln;  // a tile past M loads zeros
          const uint32_t buf = base + L.tile + bi * L.tile_bytes;
          bar_wait(tempty + 8 * bi, ph ^ 1);
          mbar_expect_tx(tfull + 8 * bi, nbox * BOX);
          for (int k = 0; k < nc; ++k) {
            tma_load(buf + k * BOX, &tm_y, tfull + 8 * bi, 64 * k, 64 * t);
            if (BWD && !a.dfr)
              tma_load(buf + (nc + k) * BOX, &tm_df, tfull + 8 * bi, 64 * k, 64 * t);
          }
        }
        if (!a.resident) walk_boxes<BWD, NWG, NSW>(a, t0, g0, g1, put);  // dfr: one lane
      }
    }
    return;
  }

  // Consumers: warpgroup wg is column warpgroup cw of row lane ln.
  if (CW > 1) asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int ln = wg / NWG, cw = wg % NWG;
  const int ct = tid % WGT, lane = tid & 31, wq = ct >> 5;
  const int lt = tid - ln * NWG * WGT;  // thread index within the lane
  Consumer cs;
  cs.ring.rs = a.rs;
  cs.ring.resident = a.resident;
  cs.base = base + L.ring;
  cs.full = full;
  cs.empty = empty;
  cs.signal = ct == 0;
  const uint32_t Gs = base + L.wg + wg * L.wg_bytes, Lw = Gs + BOX * (BWD ? 2 : 1);
  const uint32_t RK = base + L.rank + ln * BOX, TT = base + L.tt + ln * 4 * RT;
  const uint32_t CL = base + L.clora;
  const uint32_t U1T = TT, DU2T = TT + RT, DU1T = TT + 2 * RT, U2T = TT + 3 * RT;
  float* spart = reinterpret_cast<float*>(gp + L.part + ln * L.part_bytes);
  const int off_a1 = 2 * C, off_b1 = off_a1 + C * R, off_a2 = off_b1 + R * H, off_b2 = off_a2 + H * R;
  const int own_chunk_boxes = nc * (BWD ? (a.dfr ? 3 : 2) : 1);
  // A barrier among the warpgroups of this row lane.
  auto lane_sync = [&]() {
    if (NWG == 1)
      warpgroup_sync(2 + wg);
    else
      consumer_sync<NWG>();
  };

  float oacc[NSW][32];
  float hacc[32], lacc[32], dgacc[32];  // dgacc: backward only
  uint32_t hpk[16];  // the chunk's h as bf16 pairs (then, backward, its dh)
  float u2a[4], du1a[4];

  int it = 0;
  for (int t0 = bidx * LANES; t0 < a.tiles; t0 += bstride * LANES, ++it) {
    const int tb = it % a.tb;
    const uint32_t ph = (it / a.tb) & 1;
    const int bi = tb * LANES + ln, t = t0 + ln, m0 = 64 * t;
    const uint32_t Ms = base + L.tile + bi * L.tile_bytes, DFs = Ms + nc * BOX;
    // Partial contributions: into this lane's shared set, or (one tile a
    // block) straight into the tile's own set; a lane's tile past M adds
    // exact zeros and writes nothing.
    float* tpart = a.part + static_cast<size_t>(t) * a.pfloats;
    auto sink = [&](int idx, float v) {
      if (a.persist)
        spart[idx] += v;
      else if (t < a.tiles)
        tpart[idx] = v;
    };
    if (a.resident) cs.ring.slot = 0;
    bar_wait(tfull + 8 * bi, ph);

    // 1. m = bf16(y*inv + shift) in place (the product rounded first, as XLA
    //    does); rows past M and columns past C arrived as zeros and stay so.
    for (int i = lt; i < nc * 512; i += NWG * WGT) {
      const int k = i / 512, r = (i / 8) % 64, pc = i % 8;
      const int c0 = 64 * k + 8 * (pc ^ (r & 7));
      if (m0 + r >= a.M || c0 >= C) continue;
      uint4* pv = reinterpret_cast<uint4*>(gp + (Ms - base) + k * BOX + r * 128 + pc * 16);
      uint4 v = *pv;
      bf16* e = reinterpret_cast<bf16*>(&v);
      const float4 i0 = __ldg(reinterpret_cast<const float4*>(a.inv + c0));
      const float4 i1 = __ldg(reinterpret_cast<const float4*>(a.inv + c0 + 4));
      const float4 s0 = __ldg(reinterpret_cast<const float4*>(a.shift + c0));
      const float4 s1 = __ldg(reinterpret_cast<const float4*>(a.shift + c0 + 4));
      const float iv[8] = {i0.x, i0.y, i0.z, i0.w, i1.x, i1.y, i1.z, i1.w};
      const float sv[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
#pragma unroll
      for (int x = 0; x < 8; ++x)
        e[x] = __float2bfloat16(__fadd_rn(__fmul_rn(__bfloat162float(e[x]), iv[x]), sv[x]));
      *pv = v;
    }
    fence_async();
    lane_sync();

    // 2. u1 = bf16(f32(m @ A1) * mask1) (column warpgroup 0) and, backward,
    //    du2 = bf16(f32(df @ B2^T) * s * mask2) (the last one).
    {
      float t4[4];
      if (cw == 0) {
        zero<4>(t4);
        fence_acc<4>(t4);
        wgmma_fence();
        for (int k = 0; k < nc; ++k) {
          const int ks = min(4, (C - 64 * k) / 16);
          for (int kk = 0; kk < ks; ++kk)
            wgmma_n8<0, 0>(t4, kdesc(Ms + k * BOX) + kk * KSTEP, kdesc(CL + k * RT) + kk * KSTEP);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_acc<4>(t4);
        put_rank(a, gp, t4, 1.f, a.m1, m0, RK - base, 0, BWD, U1T - base, lane, wq);
      }
      if (BWD) {
        if (cw == NWG - 1) {
          zero<4>(t4);
          fence_acc<4>(t4);
          for (int k = 0; k < nc; ++k) {
            const int ks = min(4, (C - 64 * k) / 16);
            const int ds = a.dfr ? cs.acquire() : -1;
            const uint32_t A = a.dfr ? cs.addr(ds) : DFs + k * BOX;
            wgmma_fence();
            for (int kk = 0; kk < ks; ++kk)
              wgmma_n8<0, 0>(t4, kdesc(A) + kk * KSTEP, kdesc(CL + (nc + k) * RT) + kk * KSTEP);
            wgmma_commit();
            cs.retire(ds);
          }
          cs.drain();
          fence_acc<4>(t4);
          put_rank(a, gp, t4, a.s, a.m2, m0, RK - base, 1, true, DU2T - base, lane, wq);
        } else if (a.dfr) {
          cs.skip(nc);
        }
      }
      fence_async();
      lane_sync();
    }

    zero<4>(u2a);
    zero<4>(du1a);
    for (int p = 0; p < a.passes; ++p) {
#pragma unroll
      for (int q = 0; q < NSW; ++q) zero<32>(oacc[q]);
      for (int g = g0; g < g1; ++g) {
        float ga[4], gb[4];  // this group's dA2 and dB1^T of the chunk jsink
        int jsink = -1;
        // a. Each column warpgroup's chunk of the group, in order.
        for (int w = 0; w < NWG; ++w) {
          const int j = g * NWG + w;
          if (j >= a.nch) continue;
          if (w != cw) {
            cs.skip(own_chunk_boxes);
            continue;
          }
          const int hw = min(64, H - 64 * j);  // a multiple of 16
          // The chunk's rank tiles B1(j) and A2^T(j): resident, or filled here.
          const uint32_t Lb = a.lres ? base + L.lrank + 2 * j * RT : Lw;
          if (!a.lres) {
            for (int i = ct; i < 1024; i += WGT) fill_chunk_rank(a, gp + (Lw - base), j, i);
            fence_async();
          }
          warpgroup_sync(2 + wg);
          // l1 = u1b @ B1(j), one k16 step into its own accumulator, kept as
          // the bf16 pairs bf16(l1 * s) (16 registers, not 32, while h is
          // summed); then h = m @ W1[:, chunk].
          uint32_t lpk[16];
          zero<32>(lacc);
          fence_acc<32>(lacc);
          wgmma_fence();
          wgmma_n64<0, 1>(lacc, kdesc(RK), mdesc(Lb));
          wgmma_commit();
          wgmma_wait<0>();
          fence_acc<32>(lacc);
#pragma unroll
          for (int i = 0; i < 32; i += 2) lpk[i >> 1] = pack2(lacc[i] * a.s, lacc[i + 1] * a.s);
          zero<32>(hacc);
          fence_acc<32>(hacc);
          for (int k = 0; k < nc; ++k) {
            const int ks = min(4, (C - 64 * k) / 16);
            const int sl = cs.acquire();
            wgmma_fence();
            for (int kk = 0; kk < ks; ++kk)
              wgmma_n64<0, 1>(hacc, kdesc(Ms + k * BOX) + kk * KSTEP, mdesc(cs.addr(sl)) + kk * MSTEP);
            wgmma_commit();
            cs.retire(sl);
          }
          cs.drain();
          fence_acc<32>(hacc);

          // Epilogue: h = bf16(bf16(bf16(acc) + bf16(b1)) + bf16(l1 * s)),
          // g = bf16(gelu(h)) into this warpgroup's g tile; columns past H
          // stay zero.
          // (Every load first, read-only, then the stores: the compiler keeps
          // loads and stores that may alias in program order.)
          uint32_t gpk[16];
#pragma unroll
          for (int i = 0; i < 32; i += 2) {
            const int hc = 64 * j + 8 * (i >> 2) + 2 * (lane & 3);
            uint32_t hb = 0;
            if (hc < H) {
              const float2 bb = __ldg(reinterpret_cast<const float2*>(a.b1 + hc));
              const __nv_bfloat162 l = *reinterpret_cast<const __nv_bfloat162*>(&lpk[i >> 1]);
              hb = pack2(bf16r(bf16r(hacc[i]) + bf16r(bb.x)) + __low2float(l),
                         bf16r(bf16r(hacc[i + 1]) + bf16r(bb.y)) + __high2float(l));
            }
            hpk[i >> 1] = hb;
          }
#pragma unroll
          for (int i = 0; i < 16; ++i)
            gpk[i] = static_cast<uint32_t>(__ldg(g_gelu + (hpk[i] & 0xffff))) |
                     (static_cast<uint32_t>(__ldg(g_gelu + (hpk[i] >> 16))) << 16);
#pragma unroll
          for (int i = 0; i < 32; i += 2) {
            const int row = 16 * wq + (lane >> 2) + 8 * ((i >> 1) & 1);
            sts32(gp, Gs - base + swz(row, 8 * (i >> 2) + 2 * (lane & 3)), gpk[i >> 1]);
          }
          if (BWD) {
            // dg = df @ W2[chunk, :]^T + du2b @ A2(j)^T in one accumulator,
            // then dh = bf16(dg * gelu'(h)) into the dh tile.
            zero<32>(dgacc);
            fence_acc<32>(dgacc);
            for (int k = 0; k < nc; ++k) {
              const int ks = min(4, (C - 64 * k) / 16);
              const int sl = cs.acquire();
              const int ds = a.dfr ? cs.acquire() : -1;
              const uint32_t A = a.dfr ? cs.addr(ds) : DFs + k * BOX;
              wgmma_fence();
              for (int kk = 0; kk < ks; ++kk)
                wgmma_n64<0, 0>(dgacc, kdesc(A) + kk * KSTEP, kdesc(cs.addr(sl)) + kk * KSTEP);
              wgmma_commit();
              cs.retire(sl, ds);
            }
            wgmma_fence();
            wgmma_n64<0, 1>(dgacc, kdesc(RK) + KSTEP, mdesc(Lb + RT));
            wgmma_commit();
            cs.drain();
            fence_acc<32>(dgacc);
#pragma unroll
            for (int i = 0; i < 32; i += 2)
              hpk[i >> 1] = pack2(dgacc[i] * __ldg(g_gelu_grad + (hpk[i >> 1] & 0xffff)),
                                  dgacc[i + 1] * __ldg(g_gelu_grad + (hpk[i >> 1] >> 16)));
#pragma unroll
            for (int i = 0; i < 32; i += 2) {
              const int row = 16 * wq + (lane >> 2) + 8 * ((i >> 1) & 1);
              sts32(gp, Gs - base + BOX + swz(row, 8 * (i >> 2) + 2 * (lane & 3)), hpk[i >> 1]);
            }
          }
          fence_async();
          warpgroup_sync(2 + wg);

          if (p == 0) {
            // u2 += g @ A2(j); backward: du1 += dh @ B1(j)^T, and the chunk's
            // dA2 = g^T du2b and dB1^T = dh^T u1b over the tile's rows
            // (taken after the out (dm) products below).
            zero<4>(ga);
            zero<4>(gb);
            fence_acc<4>(u2a);
            fence_acc<4>(du1a);
            fence_acc<4>(ga);
            fence_acc<4>(gb);
            wgmma_fence();
            for (int kk = 0; kk < hw / 16; ++kk)
              wgmma_n8<0, 0>(u2a, kdesc(Gs) + kk * KSTEP, kdesc(Lb + RT) + kk * KSTEP);
            if (BWD) {
              for (int kk = 0; kk < hw / 16; ++kk)
                wgmma_n8<0, 0>(du1a, kdesc(Gs + BOX) + kk * KSTEP, kdesc(Lb) + kk * KSTEP);
#pragma unroll
              for (int kk = 0; kk < 4; ++kk) {
                wgmma_n8<1, 0>(ga, mdesc(Gs) + kk * MSTEP, kdesc(DU2T) + kk * KSTEP);
                wgmma_n8<1, 0>(gb, mdesc(Gs + BOX) + kk * MSTEP, kdesc(U1T) + kk * KSTEP);
              }
            }
            wgmma_commit();
            jsink = j;
          }
        }
        // Every chunk's g (dh) of the group is in shared memory (one column
        // warpgroup: its own, behind the barrier above).
        if (NWG > 1) lane_sync();

        // b. This warpgroup's out (dm) slices += g-chunk @ W2[chunk, slice]
        //    (dh-chunk @ W1[slice, chunk]^T) over the group's chunks.
#pragma unroll
        for (int q = 0; q < NSW; ++q) {
          for (int o = 0; o < NWG; ++o) {
            const int s = o + NWG * (q + p * NSW);
            if (s >= nc) continue;
            for (int w = 0; w < NWG; ++w) {
              const int j = g * NWG + w;
              if (j >= a.nch) continue;
              if (o != cw) {
                cs.skip(1);
                continue;
              }
              const int hw = min(64, H - 64 * j);
              const uint32_t A = base + L.wg + (ln * NWG + w) * L.wg_bytes + (BWD ? BOX : 0);
              const int sl = cs.acquire();
              fence_acc<32>(oacc[q]);
              wgmma_fence();
              for (int kk = 0; kk < hw / 16; ++kk) {
                if (BWD)
                  wgmma_n64<0, 0>(oacc[q], kdesc(A) + kk * KSTEP, kdesc(cs.addr(sl)) + kk * KSTEP);
                else
                  wgmma_n64<0, 1>(oacc[q], kdesc(A) + kk * KSTEP, mdesc(cs.addr(sl)) + kk * MSTEP);
              }
              wgmma_commit();
              cs.retire(sl);
            }
          }
        }
        cs.drain();
#pragma unroll
        for (int q = 0; q < NSW; ++q) fence_acc<32>(oacc[q]);
        fence_acc<4>(u2a);
        fence_acc<4>(du1a);
        fence_acc<4>(ga);
        fence_acc<4>(gb);
        if (BWD && jsink >= 0) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int h = 64 * jsink + 16 * wq + (lane >> 2) + 8 * (i >> 1);
            const int rr = 2 * (lane & 3) + (i & 1);
            if (h < H && rr < R) {
              sink(off_a2 + h * R + rr, ga[i]);
              sink(off_b1 + rr * H + h, gb[i]);
            }
          }
        }
        if (NWG > 1) lane_sync();  // the group's g (dh) tiles are read
      }

      if (p == 0) {
        // u2 and du1 summed over the column warpgroups in order, rounded,
        // into the rank tiles: u2b = bf16(u2 * mask2), du1b = bf16(du1 * s *
        // mask1).
        float* xch = reinterpret_cast<float*>(gp + L.xch);
        if (NWG > 1) {
          if (cw == 1)
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              xch[ct * 8 + i] = u2a[i];
              xch[ct * 8 + 4 + i] = du1a[i];
            }
          lane_sync();
          if (cw == 0)
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              u2a[i] += xch[ct * 8 + i];
              du1a[i] += xch[ct * 8 + 4 + i];
            }
        }
        if (!BWD && a.splits > 1) {
          // The H split: this split's u2, unmasked, for the finishing kernel.
          if (cw == 0)
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int gm = m0 + 16 * wq + (lane >> 2) + 8 * (i >> 1);
              if (gm < a.M)
                a.hu2[(static_cast<size_t>(split) * a.M + gm) * 8 + 2 * (lane & 3) + (i & 1)] =
                    u2a[i];
            }
        } else if (cw == 0) {
          put_rank(a, gp, u2a, 1.f, a.m2, m0, RK - base, 3, BWD, U2T - base, lane, wq);
          if (BWD) put_rank(a, gp, du1a, a.s, a.m1, m0, RK - base, 2, true, DU1T - base, lane, wq);
        }
        fence_async();
        lane_sync();
      }

      // c. This warpgroup's slices of the pass: forward out = bf16(bf16(
      //    bf16(acc) + bf16(b2)) + bf16(f32(u2b @ B2) * s)) (+ res, last);
      //    backward dm += du1b @ A1^T, dy = bf16(dm * inv), dinv, dshift.
#pragma unroll
      for (int q = 0; q < NSW; ++q) {
        const int s = cw + NWG * (q + p * NSW);
        if (s >= nc) continue;
        if (!BWD && a.splits > 1) {
          // The H split: this split's f32 out slice, for the finishing kernel.
#pragma unroll
          for (int i = 0; i < 32; i += 2) {
            const int gm = m0 + 16 * wq + (lane >> 2) + 8 * ((i >> 1) & 1);
            const int gc = 64 * s + 8 * (i >> 2) + 2 * (lane & 3);
            if (gm < a.M && gc < C)
              *reinterpret_cast<float2*>(a.hout + (static_cast<size_t>(split) * a.M + gm) * C +
                                         gc) = make_float2(oacc[q][i], oacc[q][i + 1]);
          }
          continue;
        }
        if (!BWD) zero<32>(lacc);
        fence_acc<32>(lacc);
        fence_acc<32>(oacc[q]);
        wgmma_fence();
        if (BWD)
          wgmma_n64<0, 1>(oacc[q], kdesc(RK) + 2 * KSTEP, mdesc(CL + s * RT));
        else
          wgmma_n64<0, 1>(lacc, kdesc(RK) + 3 * KSTEP, mdesc(CL + (nc + s) * RT));
        wgmma_commit();
        wgmma_wait<0>();
        fence_acc<32>(lacc);
        fence_acc<32>(oacc[q]);
        float sy[16], ss[16];
#pragma unroll
        for (int i = 0; i < 32; i += 2) {
          const int row = 16 * wq + (lane >> 2) + 8 * ((i >> 1) & 1);
          const int gm = m0 + row, gc = 64 * s + 8 * (i >> 2) + 2 * (lane & 3);
          const bool in = gm < a.M && gc < C;
          const size_t idx = static_cast<size_t>(gm) * C + gc;
          if (BWD) {
            const int ci = 2 * (i >> 2);
            if ((i & 2) == 0) sy[ci] = sy[ci + 1] = ss[ci] = ss[ci + 1] = 0.f;
            if (in) {
              const float d0 = oacc[q][i], d1 = oacc[q][i + 1];
              const __nv_bfloat162 yv = ldg_bf2(a.y + idx);
              const float2 iv = __ldg(reinterpret_cast<const float2*>(a.inv + gc));
              sy[ci] += d0 * __low2float(yv);
              sy[ci + 1] += d1 * __high2float(yv);
              ss[ci] += d0;
              ss[ci + 1] += d1;
              *reinterpret_cast<uint32_t*>(a.out + idx) = pack2(d0 * iv.x, d1 * iv.y);
            }
          } else if (in) {
            const float2 bb = __ldg(reinterpret_cast<const float2*>(a.b2 + gc));
            float o0 = bf16r(bf16r(bf16r(oacc[q][i]) + bf16r(bb.x)) + bf16r(lacc[i] * a.s));
            float o1 = bf16r(bf16r(bf16r(oacc[q][i + 1]) + bf16r(bb.y)) + bf16r(lacc[i + 1] * a.s));
            if (a.res) {
              const __nv_bfloat162 rv = ldg_bf2(a.res + idx);
              o0 += __low2float(rv);
              o1 += __high2float(rv);
            }
            *reinterpret_cast<uint32_t*>(a.out + idx) = pack2(o0, o1);
          }
        }
        if (BWD) {
          // Column sums over the tile's rows: the lanes of a column (lane % 4)
          // by shuffles, then the four warps in order.
          float* red = reinterpret_cast<float*>(gp + L.red) + wg * 512;
#pragma unroll
          for (int ci = 0; ci < 16; ++ci) {
#pragma unroll
            for (int off = 4; off < 32; off <<= 1) {
              sy[ci] += __shfl_xor_sync(0xffffffffu, sy[ci], off);
              ss[ci] += __shfl_xor_sync(0xffffffffu, ss[ci], off);
            }
          }
          if (lane < 4)
#pragma unroll
            for (int ci = 0; ci < 16; ++ci) {
              const int col = 8 * (ci >> 1) + 2 * lane + (ci & 1);
              red[wq * 64 + col] = sy[ci];
              red[256 + wq * 64 + col] = ss[ci];
            }
          warpgroup_sync(2 + wg);
          if (ct < 64 && 64 * s + ct < C) {
            float vy = 0.f, vs = 0.f;
#pragma unroll
            for (int w4 = 0; w4 < 4; ++w4) {
              vy += red[w4 * 64 + ct];
              vs += red[256 + w4 * 64 + ct];
            }
            sink(64 * s + ct, vy);
            sink(C + 64 * s + ct, vs);
          }
          warpgroup_sync(2 + wg);
        }
      }

      if (BWD && p == 0) {
        // dA1(s) = m_s^T du1b and dB2(s)^T = df_s^T u2b over the tile's rows,
        // for every slice s of this column warpgroup.
        for (int q = 0; q * NWG < nc; ++q)
          for (int o = 0; o < NWG; ++o) {
            const int s = o + NWG * q;
            if (s >= nc) continue;
            if (o != cw) {
              if (a.dfr) cs.skip(1);
              continue;
            }
            const int ds = a.dfr ? cs.acquire() : -1;
            const uint32_t D = a.dfr ? cs.addr(ds) : DFs + s * BOX;
            float ga[4], gb[4];
            zero<4>(ga);
            zero<4>(gb);
            fence_acc<4>(ga);
            fence_acc<4>(gb);
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
              wgmma_n8<1, 0>(ga, mdesc(Ms + s * BOX) + kk * MSTEP, kdesc(DU1T) + kk * KSTEP);
              wgmma_n8<1, 0>(gb, mdesc(D) + kk * MSTEP, kdesc(U2T) + kk * KSTEP);
            }
            wgmma_commit();
            cs.retire(ds);
            cs.drain();
            fence_acc<4>(ga);
            fence_acc<4>(gb);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int c = 64 * s + 16 * wq + (lane >> 2) + 8 * (i >> 1);
              const int rr = 2 * (lane & 3) + (i & 1);
              if (c < C && rr < R) {
                sink(off_a1 + c * R + rr, ga[i]);
                sink(off_b2 + rr * C + c, gb[i]);
              }
            }
          }
      }
    }
    // The tile's buffers are read.
    warpgroup_sync(2 + wg);
    if (cs.signal) mbar_arrive(tempty + 8 * bi);
  }

  if (BWD && a.persist) {
    lane_sync();
    float* out = a.part + static_cast<size_t>(blockIdx.x * LANES + ln) * a.pfloats;
    for (int i = lt; i < a.pfloats; i += NWG * WGT) out[i] = spart[i];
  }
}

// The forward's H split, finished: per row and column pair, out = the
// splits' f32 partial products summed in split order, u2 = their partial
// u2 summed the same way, then the forward's epilogue: u2b = bf16(u2 *
// mask2), out = bf16(bf16(bf16(acc) + bf16(b2)) + bf16(f32(u2b @ B2) * s))
// (+ res, last). The rank-R up-term is R multiply-adds an element here.
__global__ void convffn_fwd_finish_kernel(const Args a) {
  const int pairs = a.C / 2;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < a.M * pairs;
       i += gridDim.x * blockDim.x) {
    const int row = i / pairs, c = 2 * (i % pairs);
    float acc0 = 0.f, acc1 = 0.f, l0 = 0.f, l1 = 0.f;
    for (int sp = 0; sp < a.splits; ++sp) {
      const float2 v = *reinterpret_cast<const float2*>(
          a.hout + (static_cast<size_t>(sp) * a.M + row) * a.C + c);
      acc0 += v.x;
      acc1 += v.y;
    }
    for (int r = 0; r < a.R; ++r) {
      float u = 0.f;
      for (int sp = 0; sp < a.splits; ++sp) u += a.hu2[(static_cast<size_t>(sp) * a.M + row) * 8 + r];
      const float ub = bf16r(u * a.m2[(row / a.S) * a.R + r]);
      l0 += ub * __bfloat162float(a.b2l[r * a.C + c]);
      l1 += ub * __bfloat162float(a.b2l[r * a.C + c + 1]);
    }
    const size_t idx = static_cast<size_t>(row) * a.C + c;
    float o0 = bf16r(bf16r(bf16r(acc0) + bf16r(a.b2[c])) + bf16r(l0 * a.s));
    float o1 = bf16r(bf16r(bf16r(acc1) + bf16r(a.b2[c + 1])) + bf16r(l1 * a.s));
    if (a.res) {
      const __nv_bfloat162 rv = *reinterpret_cast<const __nv_bfloat162*>(a.res + idx);
      o0 += __low2float(rv);
      o1 += __high2float(rv);
    }
    *reinterpret_cast<uint32_t*>(a.out + idx) = pack2(o0, o1);
  }
}

// out[i] = sum over the sets, in order, of partials[set * P + i]; the dB1
// and dB2 sums ([b1_lo, b1_hi) and [b2_lo, P)) scaled by s after it.
__global__ void convffn_bwd_reduce_kernel(const float* __restrict__ partials, int sets, int P,
                                          int b1_lo, int b1_hi, int b2_lo, float s,
                                          float* __restrict__ out) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < P; i += gridDim.x * blockDim.x) {
    float acc = 0.f;
    for (int b = 0; b < sets; ++b) acc += partials[static_cast<size_t>(b) * P + i];
    out[i] = (i >= b1_lo && i < b1_hi) || i >= b2_lo ? acc * s : acc;
  }
}

// A tensor map describes only an address, its dims and strides, so the one
// encoded for (base, inner, outer) serves every later call with the same
// three (the caching allocator hands the same address back): a small
// direct-mapped cache of them saves cuTensorMapEncodeTiled's host time.
bool encode_cached(CUtensorMap* map, const void* base, int inner, int outer) {
  struct Entry {
    const void* base;
    int inner, outer;
    CUtensorMap map;
  };
  static Entry cache[64] = {};
  static std::mutex lock;
  const size_t slot = (reinterpret_cast<uintptr_t>(base) >> 8 ^ inner * 31 ^ outer) % 64;
  std::lock_guard<std::mutex> guard(lock);
  Entry& e = cache[slot];
  if (e.base != base || e.inner != inner || e.outer != outer) {
    if (!encode_tiles(&e.map, base, inner, outer, 64)) {
      e.base = nullptr;
      return false;
    }
    e.base = base;
    e.inner = inner;
    e.outer = outer;
  }
  *map = e.map;
  return true;
}

// One instance's launch; its shared-memory limit is raised once a device.
template <bool BWD, int NWG, int NSW, int LANES>
int run(const CUtensorMap& ty, const CUtensorMap& tdf, const CUtensorMap& tw1,
        const CUtensorMap& tw2, const Args& a, uint32_t smem, int blocks, cudaStream_t stream) {
  static bool raised[16] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 16)
    return static_cast<int>(cudaErrorInvalidDevice);
  if (!raised[dev]) {
    const cudaError_t err = cudaFuncSetAttribute(convffn_kernel<BWD, NWG, NSW, LANES>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, LIMIT);
    if (err != cudaSuccess) return static_cast<int>(err);
    raised[dev] = true;
  }
  convffn_kernel<BWD, NWG, NSW, LANES><<<blocks, block_threads<NWG * LANES>(), smem, stream>>>(
      ty, tdf, tw1, tw2, a);
  return static_cast<int>(cudaGetLastError());
}

// The launch of one plan, the tensor maps of y, df, W1 and W2 from the
// cache. The instances: the row split (two lanes) with 1 or 2 slices (3
// forward; backward also one lane, where two lanes' partial sets do not
// fit), the column split (two warpgroups) with 2 or 3 slices (4 forward).
template <bool BWD>
int launch(const Args& a, const void* df, const void* w1, const void* w2, int nwg, int nsw,
           int lanes, int blocks, cudaStream_t stream) {
  const Layout L = make_layout(BWD, a.nc, a.nch, nwg, lanes, a.tb, a.rs, a.dfr, a.lres,
                               a.persist ? a.pfloats : 0);
  if (L.total > static_cast<uint32_t>(LIMIT)) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap ty, tdf, tw1, tw2;
  if (!encode_cached(&ty, a.y, a.C, a.M) || !encode_cached(&tdf, BWD ? df : a.y, a.C, a.M) ||
      !encode_cached(&tw1, w1, a.H, a.C) || !encode_cached(&tw2, w2, a.C, a.H))
    return static_cast<int>(cudaErrorInvalidValue);
  static bool tables[16] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 16)
    return static_cast<int>(cudaErrorInvalidDevice);
  if (!tables[dev]) {
    // The GELU tables, once a device: filled on the stream ahead of the
    // kernel and waited for, so that every later call on any stream finds
    // them; inside a CUDA graph capture the fill is captured with the call.
    gelu_table_kernel<<<64, 1024, 0, stream>>>();
    cudaError_t err = cudaGetLastError();
    cudaStreamCaptureStatus capturing = cudaStreamCaptureStatusNone;
    if (err == cudaSuccess) err = cudaStreamIsCapturing(stream, &capturing);
    if (err == cudaSuccess && capturing == cudaStreamCaptureStatusNone) {
      err = cudaStreamSynchronize(stream);
      tables[dev] = err == cudaSuccess;
    }
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const uint32_t smem = L.total;
  if (nwg == 1 && nsw == 1 && lanes == 2)
    return run<BWD, 1, 1, 2>(ty, tdf, tw1, tw2, a, smem, blocks, stream);
  if (nwg == 1 && nsw == 2 && lanes == 2)
    return run<BWD, 1, 2, 2>(ty, tdf, tw1, tw2, a, smem, blocks, stream);
  if constexpr (!BWD)
    if (nwg == 1 && nsw == 3 && lanes == 2)
      return run<false, 1, 3, 2>(ty, tdf, tw1, tw2, a, smem, blocks, stream);
  if constexpr (BWD) {
    if (nwg == 1 && nsw == 1 && lanes == 1)
      return run<true, 1, 1, 1>(ty, tdf, tw1, tw2, a, smem, blocks, stream);
    if (nwg == 1 && nsw == 2 && lanes == 1)
      return run<true, 1, 2, 1>(ty, tdf, tw1, tw2, a, smem, blocks, stream);
  }
  if (nwg == 2 && nsw == 2 && lanes == 1)
    return run<BWD, 2, 2, 1>(ty, tdf, tw1, tw2, a, smem, blocks, stream);
  if (nwg == 2 && nsw == 3 && lanes == 1)
    return run<BWD, 2, 3, 1>(ty, tdf, tw1, tw2, a, smem, blocks, stream);
  if constexpr (!BWD)
    if (nwg == 2 && nsw == 4 && lanes == 1)
      return run<false, 2, 4, 1>(ty, tdf, tw1, tw2, a, smem, blocks, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

Args make_args(const void* y, const void* res, const void* inv, const void* shift, const void* b1,
               const void* b2, const void* a1, const void* b1l, const void* a2, const void* b2l,
               const void* m1, const void* m2, void* out, int M, int S, int C, int H, int R,
               float s, int passes, int tb, int rs, int resident, int lres) {
  Args a;
  a.y = static_cast<const bf16*>(y);
  a.res = static_cast<const bf16*>(res);
  a.inv = static_cast<const float*>(inv);
  a.shift = static_cast<const float*>(shift);
  a.b1 = static_cast<const float*>(b1);
  a.b2 = static_cast<const float*>(b2);
  a.m1 = static_cast<const float*>(m1);
  a.m2 = static_cast<const float*>(m2);
  a.a1 = static_cast<const bf16*>(a1);
  a.b1l = static_cast<const bf16*>(b1l);
  a.a2 = static_cast<const bf16*>(a2);
  a.b2l = static_cast<const bf16*>(b2l);
  a.out = static_cast<bf16*>(out);
  a.part = nullptr;
  a.hout = a.hu2 = nullptr;
  a.splits = 1;
  a.cpg = (H + 63) / 64;
  a.M = M;
  a.S = S;
  a.C = C;
  a.H = H;
  a.R = R;
  a.s = s;
  a.nc = (C + 63) / 64;
  a.nch = (H + 63) / 64;
  a.tiles = (M + 63) / 64;
  a.passes = passes;
  a.tb = tb;
  a.rs = rs;
  a.resident = resident;
  a.lres = lres;
  a.dfr = 0;
  a.persist = 0;
  a.pfloats = 2 * C + 2 * R * (C + H);
  return a;
}

}  // namespace

extern "C" {

// Shared-memory bytes of a plan (ops/convffn.py convffn_plan mirrors it).
long long dp_convffn_smem(int bwd, int C, int H, int R, int nwg, int lanes, int tb, int rs,
                          int dfr, int lres, int persist) {
  return make_layout(bwd != 0, (C + 63) / 64, (H + 63) / 64, nwg, lanes, tb, rs, dfr != 0,
                     lres != 0, persist ? 2 * C + 2 * R * (C + H) : 0)
      .total;
}

// _convffn_fwd_kernel (res null) or _convffn_fwd_res_kernel: out over M =
// B*S rows of width C (S rows per sample, for the masks), on the plan
// (nwg, nsw, lanes, passes, tb, rs, resident, lres, splits, cpg, blocks)
// that ops/convffn.py chose; with splits > 1, scratch holds splits * M *
// (C + 8) f32 and convffn_fwd_finish_kernel runs after the kernel.
int dp_convffn_fwd(const void* y, const void* res, const void* inv, const void* shift,
                   const void* w1, const void* b1, const void* w2, const void* b2, const void* a1,
                   const void* b1l, const void* a2, const void* b2l, const void* m1,
                   const void* m2, void* out, int M, int S, int C, int H, int R, float s,
                   int nwg, int nsw, int lanes, int passes, int tb, int rs, int resident,
                   int lres, int splits, int cpg, void* scratch, int blocks, void* stream) {
  Args a = make_args(y, res, inv, shift, b1, b2, a1, b1l, a2, b2l, m1, m2, out, M, S, C, H, R, s,
                     passes, tb, rs, resident, lres);
  a.splits = splits;
  a.cpg = cpg;
  a.hout = static_cast<float*>(scratch);
  a.hu2 = a.hout + static_cast<size_t>(splits) * M * C;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int err = launch<false>(a, nullptr, w1, w2, nwg, nsw, lanes, blocks, st);
  if (err != 0 || splits == 1) return err;
  convffn_fwd_finish_kernel<<<(M * C / 2 + 255) / 256, 256, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// _convffn_bwd_kernel: dy (M, C) bf16 and the gradients of inv, shift, A1,
// B1, A2, B2, summed into grads (2C + 2R(C + H) f32: inv, shift, A1 (C, R),
// B1 (R, H), A2 (H, R), B2 (R, C)) through partials (`sets` sets, scratch:
// a set a block's row lane, or a set a tile), on the plan ops/convffn.py
// chose.
int dp_convffn_bwd(const void* y, const void* df, const void* inv, const void* shift,
                   const void* w1, const void* b1, const void* w2, const void* b2, const void* a1,
                   const void* b1l, const void* a2, const void* b2l, const void* m1,
                   const void* m2, void* dy, void* partials, void* grads, int M, int S, int C,
                   int H, int R, float s, int nwg, int nsw, int lanes, int passes, int tb,
                   int rs, int resident, int lres, int dfr, int persist, int blocks, int sets,
                   void* stream) {
  (void)b2;  // the output bias has no part in any gradient
  Args a = make_args(y, nullptr, inv, shift, b1, nullptr, a1, b1l, a2, b2l, m1, m2, dy, M, S, C,
                     H, R, s, passes, tb, rs, resident, lres);
  a.part = static_cast<float*>(partials);
  a.dfr = dfr;
  a.persist = persist;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int err = launch<true>(a, df, w1, w2, nwg, nsw, lanes, blocks, st);
  if (err != 0) return err;
  const int P = a.pfloats, b1_lo = 2 * C + C * R;
  convffn_bwd_reduce_kernel<<<(P + 255) / 256, 256, 0, st>>>(
      static_cast<const float*>(partials), sets, P, b1_lo, b1_lo + R * H,
      b1_lo + 2 * R * H, s, static_cast<float*>(grads));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
