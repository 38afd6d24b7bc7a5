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
// taps flipped in H and W (the wrapper passes them flipped). Activations
// are NHWC bf16 (channels_last), per-channel vectors f32.
//
// The TPU kernels view a sample as an (H, W*C) plane so that C = 48 still
// fills 128-wide vector lanes, and shift it along lanes with rolls. Here the
// contiguous NHWC channel axis maps onto neighbouring threads directly:
//
//   * one block per (sample, strip of TH output rows, group of CG <= 64
//     channels); block (CG, NY) threads, NY = 256 / CG;
//   * the strip plus its K-1 halo rows and columns (zero outside the image:
//     SAME padding) is staged once in shared memory, bf16, which is exact
//     for x, for the rounded x2 and for dy7bar, in 16-byte loads (8 channels)
//     where C is a multiple of 8, several in flight a thread (a load at a
//     time left this phase latency-bound); COMBINE forms x2 there from
//     x and y0 (halo rows recomputed by both neighbouring strips, with the
//     same rounding) and writes the strip's own rows of x2 once;
//   * thread (c, y) keeps channel c's K*K f32 taps in registers and takes
//     the strip's (row, 8-column chunk) items y, y + NY, ...: for each of the
//     K window rows it reads 8 + K - 1 values once and adds their K taps into
//     8 f32 sums (about K*(8+K-1)/8 shared-memory reads an output instead of
//     K*K);
//   * COMBINE_BWD adds each thread's f32 sums over its items, sums them over
//     the block's NY threads of a channel in a fixed order into the block's
//     own slot (one per (sample, strip)), and dw_sums_reduce_kernel adds the
//     slots in slot order. No atomics: the same inputs give the same bits.
//
// The wrapper picks TH (8, halved while the grid would leave SMs idle or the
// tile outgrows ~100 KB) and CG. Any H and W: rows and columns past the
// image are zero in the tile and never written (the TPU kernel's 16-row
// chunks fail at H > 16 with H % 16 != 0).
//
// Bound on an H100: 2*K*K f32 FLOPs an output on the CUDA cores (67
// TFLOP/s), or the bf16 activations read and written once at 3.35 TB/s; at
// t8's stage 0 (B = 128, 64x64, C = 48) the K = 7 conv's 2.47 GFLOP take
// 0.037 ms, above its 0.030 ms of bytes. This first version re-reads each
// halo row K times from shared memory with scalar bf16 loads and writes its
// outputs 2 bytes a thread; PERF.md holds its times.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int THREADS = 256;
constexpr int TW = 8;     // output columns a thread sums at once
constexpr int STAGE = 8;  // tile elements a thread loads at once (scalar staging)
constexpr int VSTAGE = 4; // 16-byte vectors a thread loads at once
constexpr int DW = 0, COMBINE = 1, COMBINE_BWD = 2;

__host__ __device__ __forceinline__ size_t align128(size_t n) {
  return (n + 127) & ~static_cast<size_t>(127);
}

__device__ __forceinline__ float bf(bf16 v) { return __bfloat162float(v); }

__host__ __device__ __forceinline__ int tile_cols(int W, int K) {
  return (W + TW - 1) / TW * TW + K - 1;
}

// The bf16 tile (TH + K - 1, tile_cols, CG), then the backward's per-thread
// sums (3, THREADS) f32.
size_t smem_bytes(int W, int K, int TH, int CG) {
  return align128(static_cast<size_t>(TH + K - 1) * tile_cols(W, K) * CG * 2) +
         static_cast<size_t>(3) * THREADS * 4;
}

// src: the conv's input (DW: x; COMBINE_BWD: dy7bar; COMBINE: unused).
// x, y0: COMBINE's operands, COMBINE_BWD's for the sums. dx2bar: COMBINE_BWD.
// a, b, bias (C) f32; taps (K*K, C) f32. out: DW y, COMBINE y7, COMBINE_BWD
// dx; out2: COMBINE x2, COMBINE_BWD dy0. slots (B * strips, 3, C) f32.
template <int K, int MODE>
__global__ void __launch_bounds__(THREADS)
dw_kernel(const bf16* __restrict__ src, const bf16* __restrict__ x,
          const bf16* __restrict__ y0, const bf16* __restrict__ dx2bar,
          const float* __restrict__ a, const float* __restrict__ b,
          const float* __restrict__ bias, const float* __restrict__ taps,
          bf16* __restrict__ out, bf16* __restrict__ out2, float* __restrict__ slots, int H,
          int W, int C, int TH, int CG, int groups) {
  constexpr int P = K / 2;
  extern __shared__ __align__(128) unsigned char smem[];
  const int nch = (W + TW - 1) / TW, Wp = tile_cols(W, K), rows = TH + K - 1;
  bf16* tile = reinterpret_cast<bf16*>(smem);
  float* red = reinterpret_cast<float*>(
      smem + align128(static_cast<size_t>(rows) * Wp * CG * 2));

  const int g = blockIdx.x % groups, strip = blockIdx.x / groups, n = blockIdx.y;
  const int r0 = strip * TH, c0 = g * CG;
  const int cgn = min(CG, C - c0);  // channels of this group
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const size_t img = static_cast<size_t>(n) * H * W * C;

  // 1. Stage the zero-padded tile, several loads in flight a thread. COMBINE
  //    forms x2 here and writes the strip's own rows of it. Where C and CG
  //    are multiples of 8 (every t8/sa12 width), in 16-byte vectors of 8
  //    channels; else thread (c, y) takes channel c of pixels y, y + NY, ...
  const int npix = rows * Wp;
  if (C % 8 == 0 && CG % 8 == 0) {
    const int vpp = CG / 8, total = npix * vpp, nthreads = blockDim.x * blockDim.y;
    const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
    for (int base = tid; base < total; base += VSTAGE * nthreads) {
      uint4 v0[VSTAGE], v1[VSTAGE];
      size_t off[VSTAGE];
      bool inside[VSTAGE];
#pragma unroll
      for (int u = 0; u < VSTAGE; ++u) {
        const int idx = base + u * nthreads;
        const int pix = idx / vpp, cv = (idx - pix * vpp) * 8;
        const int row = pix / Wp, col = pix - row * Wp;
        const int h = r0 - P + row, w = col - P;
        inside[u] = idx < total && cv < cgn && h >= 0 && h < H && w >= 0 && w < W;
        off[u] = inside[u] ? img + (static_cast<size_t>(h) * W + w) * C + c0 + cv : 0;
        v0[u] = inside[u] ? *reinterpret_cast<const uint4*>((MODE == COMBINE ? x : src) + off[u])
                          : zero;
        v1[u] = MODE == COMBINE && inside[u] ? *reinterpret_cast<const uint4*>(y0 + off[u]) : zero;
      }
#pragma unroll
      for (int u = 0; u < VSTAGE; ++u) {
        const int idx = base + u * nthreads;
        if (idx >= total) break;
        const int pix = idx / vpp, cv = (idx - pix * vpp) * 8;
        uint4 v = v0[u];
        if (MODE == COMBINE && inside[u]) {
          const bf16* xs = reinterpret_cast<const bf16*>(&v0[u]);
          const bf16* ys = reinterpret_cast<const bf16*>(&v1[u]);
          bf16* vs = reinterpret_cast<bf16*>(&v);
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int c = c0 + cv + j;
            // f32 products, each rounded, added left to right, then one bf16
            // rounding (no fused multiply-add: XLA rounds the products).
            vs[j] = __float2bfloat16(
                __fadd_rn(__fadd_rn(__fmul_rn(bf(xs[j]), a[c]), __fmul_rn(bf(ys[j]), b[c])),
                          bias[c]));
          }
          const int row = pix / Wp;
          if (row >= P && row < P + TH) *reinterpret_cast<uint4*>(out2 + off[u]) = v;
        }
        *reinterpret_cast<uint4*>(tile + static_cast<size_t>(pix) * CG + cv) = v;
      }
    }
  } else {
    const int cl = threadIdx.x, c = c0 + cl;
    const bool in_group = cl < cgn;
    float ca = 0.f, cb = 0.f, cbias = 0.f;
    if (MODE == COMBINE && in_group) {
      ca = a[c];
      cb = b[c];
      cbias = bias[c];
    }
    const int step = blockDim.y;
    for (int base = threadIdx.y; base < npix; base += STAGE * step) {
      size_t off[STAGE];
      bool inside[STAGE];
      float v0[STAGE], v1[STAGE];
#pragma unroll
      for (int u = 0; u < STAGE; ++u) {
        const int pix = base + u * step;
        const int row = pix / Wp, col = pix - row * Wp;
        const int h = r0 - P + row, w = col - P;
        inside[u] = in_group && pix < npix && h >= 0 && h < H && w >= 0 && w < W;
        off[u] = inside[u] ? img + (static_cast<size_t>(h) * W + w) * C + c : 0;
        v0[u] = inside[u] ? bf(MODE == COMBINE ? x[off[u]] : src[off[u]]) : 0.f;
        v1[u] = MODE == COMBINE && inside[u] ? bf(y0[off[u]]) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < STAGE; ++u) {
        const int pix = base + u * step;
        if (pix >= npix) break;
        bf16 v = __float2bfloat16(v0[u]);  // exact: v0 is a bf16 value
        if (MODE == COMBINE && inside[u]) {
          // f32 products, each rounded, added left to right, then one bf16
          // rounding (no fused multiply-add: XLA rounds the products).
          v = __float2bfloat16(
              __fadd_rn(__fadd_rn(__fmul_rn(v0[u], ca), __fmul_rn(v1[u], cb)), cbias));
          const int row = pix / Wp;
          if (row >= P && row < P + TH) out2[off[u]] = v;
        }
        tile[static_cast<size_t>(pix) * CG + cl] = v;
      }
    }
  }
  __syncthreads();

  // 2. This thread's channel and its taps.
  const int cl = threadIdx.x;
  const bool active = cl < cgn;
  const int c = c0 + (active ? cl : 0);
  float t[K * K];
#pragma unroll
  for (int j = 0; j < K * K; ++j) t[j] = active ? taps[j * C + c] : 0.f;
  float ac = 0.f, bc = 0.f;
  if (MODE == COMBINE_BWD) {
    ac = a[c];
    bc = b[c];
  }
  float sa = 0.f, sb = 0.f, sd = 0.f;

  // 3. The (row, 8-column chunk) items of the strip.
  for (int item = threadIdx.y; item < TH * nch; item += blockDim.y) {
    const int r = item / nch, w0 = (item % nch) * TW;
    const int h = r0 + r;
    if (!active || h >= H) continue;
    const size_t o0 = img + (static_cast<size_t>(h) * W + w0) * C + c;
    const int nw = min(TW, W - w0);  // outputs of this chunk inside the image
    // COMBINE_BWD's per-output operands, loaded before the conv so that
    // their loads overlap it.
    float d2[TW], xv[TW], yv[TW];
    if (MODE == COMBINE_BWD) {
#pragma unroll
      for (int i = 0; i < TW; ++i) {
        const size_t o = o0 + static_cast<size_t>(i) * C;
        d2[i] = i < nw ? bf(dx2bar[o]) : 0.f;
        xv[i] = i < nw ? bf(x[o]) : 0.f;
        yv[i] = i < nw ? bf(y0[o]) : 0.f;
      }
    }
    float acc[TW];
#pragma unroll
    for (int i = 0; i < TW; ++i) acc[i] = 0.f;
#pragma unroll
    for (int dh = 0; dh < K; ++dh) {
      const bf16* rowp = tile + (static_cast<size_t>(r + dh) * Wp + w0) * CG + cl;
      float v[TW + K - 1];
#pragma unroll
      for (int i = 0; i < TW + K - 1; ++i) v[i] = bf(rowp[i * CG]);
#pragma unroll
      for (int i = 0; i < TW; ++i)
#pragma unroll
        for (int dw = 0; dw < K; ++dw) acc[i] = fmaf(v[i + dw], t[dh * K + dw], acc[i]);
    }
#pragma unroll
    for (int i = 0; i < TW; ++i) {
      if (i >= nw) break;
      const size_t o = o0 + static_cast<size_t>(i) * C;
      if (MODE == COMBINE_BWD) {
        const float dx2 = d2[i] + acc[i];
        out[o] = __float2bfloat16(dx2 * ac);
        out2[o] = __float2bfloat16(dx2 * bc);
        sa += dx2 * xv[i];
        sb += dx2 * yv[i];
        sd += dx2;
      } else {
        out[o] = __float2bfloat16(acc[i]);
      }
    }
  }

  // 4. COMBINE_BWD: the block's sums per channel, threads in y order.
  if (MODE == COMBINE_BWD) {
    red[tid] = sa;
    red[THREADS + tid] = sb;
    red[2 * THREADS + tid] = sd;
    __syncthreads();
    if (threadIdx.y == 0 && active) {
      float s0 = 0.f, s1 = 0.f, s2 = 0.f;
      for (int y = 0; y < blockDim.y; ++y) {
        const int j = y * blockDim.x + cl;
        s0 += red[j];
        s1 += red[THREADS + j];
        s2 += red[2 * THREADS + j];
      }
      const int strips = (H + TH - 1) / TH;
      float* slot = slots + (static_cast<size_t>(n) * strips + strip) * 3 * C;
      slot[c] = s0;
      slot[C + c] = s1;
      slot[2 * C + c] = s2;
    }
  }
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

template <int K, int MODE>
int launch(const void* src, const void* x, const void* y0, const void* dx2bar, const void* a,
           const void* b, const void* bias, const void* taps, void* out, void* out2,
           void* slots, int B, int H, int W, int C, int TH, int CG, int groups,
           cudaStream_t stream) {
  const size_t smem = smem_bytes(W, K, TH, CG);
  cudaError_t err = cudaFuncSetAttribute(dw_kernel<K, MODE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 block(CG, THREADS / CG);
  const dim3 grid(((H + TH - 1) / TH) * groups, B);
  dw_kernel<K, MODE><<<grid, block, smem, stream>>>(
      static_cast<const bf16*>(src), static_cast<const bf16*>(x), static_cast<const bf16*>(y0),
      static_cast<const bf16*>(dx2bar), static_cast<const float*>(a),
      static_cast<const float*>(b), static_cast<const float*>(bias),
      static_cast<const float*>(taps), static_cast<bf16*>(out), static_cast<bf16*>(out2),
      static_cast<float*>(slots), H, W, C, TH, CG, groups);
  return static_cast<int>(cudaGetLastError());
}

template <int MODE>
int dispatch(int K, const void* src, const void* x, const void* y0, const void* dx2bar,
             const void* a, const void* b, const void* bias, const void* taps, void* out,
             void* out2, void* slots, int B, int H, int W, int C, int TH, int CG, int groups,
             cudaStream_t stream) {
  if (CG < 1 || CG > 64 || TH < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (K == 3)
    return launch<3, MODE>(src, x, y0, dx2bar, a, b, bias, taps, out, out2, slots, B, H, W, C,
                           TH, CG, groups, stream);
  if (K == 7)
    return launch<7, MODE>(src, x, y0, dx2bar, a, b, bias, taps, out, out2, slots, B, H, W, C,
                           TH, CG, groups, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// Shared-memory bytes a block asks for (tile and sums), so that the wrapper
// can plan its strips and refuse a width the card cannot hold.
long long dp_dw_smem_bytes(int W, int K, int TH, int CG) {
  return static_cast<long long>(smem_bytes(W, K, TH, CG));
}

// _dw_kernel: out = conv(x), (B, H, W, C) bf16, taps (K*K, C) f32.
int dp_dw_conv(const void* x, const void* taps, void* out, int B, int H, int W, int C, int K,
               int TH, int CG, int groups, void* stream) {
  return dispatch<DW>(K, x, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, taps, out,
                      nullptr, nullptr, B, H, W, C, TH, CG, groups,
                      static_cast<cudaStream_t>(stream));
}

// _combine_dw_fwd_kernel: x2 = bf16(a*x + b*y0 + bias), y7 = conv(x2).
int dp_combine_dw(const void* x, const void* y0, const void* a, const void* b, const void* bias,
                  const void* taps, void* x2, void* y7, int B, int H, int W, int C, int K, int TH,
                  int CG, int groups, void* stream) {
  return dispatch<COMBINE>(K, nullptr, x, y0, nullptr, a, b, bias, taps, y7, x2, nullptr, B, H,
                           W, C, TH, CG, groups, static_cast<cudaStream_t>(stream));
}

// _combine_dw_bwd_kernel: taps flipped; dx, dy0 (B, H, W, C) bf16 and sums
// (3, C) f32 = (da, db, dbias), through slots (B * strips, 3, C) f32.
int dp_combine_dw_bwd(const void* x, const void* y0, const void* dx2bar, const void* dy7bar,
                      const void* a, const void* b, const void* taps, void* dx, void* dy0,
                      void* slots, void* sums, int B, int H, int W, int C, int K, int TH, int CG,
                      int groups, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int err = dispatch<COMBINE_BWD>(K, dy7bar, x, y0, dx2bar, a, b, nullptr, taps, dx, dy0,
                                        slots, B, H, W, C, TH, CG, groups, st);
  if (err != 0) return err;
  const int n = 3 * C, nslots = B * ((H + TH - 1) / TH);
  dw_sums_reduce_kernel<<<(n + THREADS - 1) / THREADS, THREADS, 0, st>>>(
      static_cast<const float*>(slots), nslots, n, static_cast<float*>(sums));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
