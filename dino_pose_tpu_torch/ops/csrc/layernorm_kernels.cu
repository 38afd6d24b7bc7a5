// LayerNorm forward for Hopper (sm_90a), CUDA C++ with a plain C interface
// (loaded with ctypes by dino_pose_tpu_torch/ops/_ext.py).
//
// Replaces _ln_kernel (dino_pose_tpu/ops/layernorm.py:36, through
// _pallas_layernorm :45 and fused_layernorm :72): over each row of D values,
// the f32 mean, then the f32 mean of squared deviations, rsqrt(var + eps),
// the affine in f32 (f32 scale and bias), and one rounding to the input's
// dtype (bf16 or f32). Its backward stays autodiff of the plain formula, as
// in the JAX package (ops/layernorm.py).
//
// The TPU kernel takes 512 rows a program and pads the row count to a
// multiple of 512 with zero rows; here each row is independent work: one
// warp a row for D <= 1024, one block a row up to D = 4096, any row count
// and no padding. A block takes four rows (warps), or two or one where four
// would leave SMs without a block: at dinov2-small's 257 serving rows two,
// 129 blocks, where four gave 65 blocks on 132 SMs. A thread holds its share of
// the row in registers (16-byte chunks of 8 values), so the row is read from
// device memory once and both passes over it (mean, then the squared
// deviations) run in registers: the kernel moves each input byte once and
// each output byte once. That traffic bounds it on an H100 (rows*D*2*itemsize
// + 2*D*4 bytes at 3.35 TB/s; a few operations a byte). Sums run in a fixed
// order (lane, then warp), so two runs give the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int VEC = 8;          // values of a chunk (16 bytes of bf16)
constexpr int THREADS = 128;    // threads a block (a block-a-row block; at most, a warp a row)
constexpr int MAX_CHUNKS = 4;   // chunks a thread holds: D <= 32*8*4 a warp, 128*8*4 a block

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ void load8(const bf16* p, float* v) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const bf16* e = reinterpret_cast<const bf16*>(&u);
#pragma unroll
  for (int j = 0; j < VEC; ++j) v[j] = __bfloat162float(e[j]);
}

__device__ __forceinline__ void load8(const float* p, float* v) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void store8(bf16* p, const float* v) {
  uint4 u;
  bf16* e = reinterpret_cast<bf16*>(&u);
#pragma unroll
  for (int j = 0; j < VEC; ++j) e[j] = __float2bfloat16(v[j]);
  *reinterpret_cast<uint4*>(p) = u;
}

__device__ __forceinline__ void store8(float* p, const float* v) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

// The sum of v over the TPR threads of a row: a warp's shuffle, and for a
// block-wide row the warps' sums added in warp order through red.
template <int TPR>
__device__ __forceinline__ float row_sum(float v, float* red) {
  v = warp_sum(v);
  if (TPR == 32) return v;
  __syncthreads();  // red's previous readers are done
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = 0.f;
#pragma unroll
  for (int w = 0; w < TPR / 32; ++w) t += red[w];
  return t;
}

// y[row] = bf16-or-f32(((x - mean) * rsqrt(var + eps)) * gamma + beta) over
// rows of D (D % 8 == 0, D <= TPR * 8 * MAX_CHUNKS). TPR = 32: a warp a row,
// blockDim.x / 32 rows a block; TPR = THREADS: a block a row. The affine's
// products and sum are kept apart (no fused multiply-add), as the plain
// version computes them.
template <typename T, int TPR>
__global__ void __launch_bounds__(THREADS)
ln_fwd_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
              const float* __restrict__ beta, T* __restrict__ y, int rows, int D, float eps) {
  __shared__ float red[THREADS / 32];
  const int t = TPR == 32 ? (threadIdx.x & 31) : threadIdx.x;
  const int row = TPR == 32 ? blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5) : blockIdx.x;
  if (row >= rows) return;  // a whole warp (TPR = 32) or never (a block a row)
  const T* src = x + static_cast<size_t>(row) * D;
  T* dst = y + static_cast<size_t>(row) * D;
  const int chunks = D / VEC;

  float v[MAX_CHUNKS][VEC];
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < MAX_CHUNKS; ++i) {
    const int c = t + i * TPR;
    if (c < chunks) {
      load8(src + c * VEC, v[i]);
#pragma unroll
      for (int j = 0; j < VEC; ++j) s += v[i][j];
    }
  }
  const float mu = row_sum<TPR>(s, red) / D;
  float q = 0.f;
#pragma unroll
  for (int i = 0; i < MAX_CHUNKS; ++i) {
    if (t + i * TPR < chunks) {
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float d = v[i][j] - mu;
        q += d * d;
      }
    }
  }
  const float rstd = rsqrtf(row_sum<TPR>(q, red) / D + eps);
#pragma unroll
  for (int i = 0; i < MAX_CHUNKS; ++i) {
    const int c = t + i * TPR;
    if (c < chunks) {
      float g[VEC], b[VEC], o[VEC];
      load8(gamma + c * VEC, g);
      load8(beta + c * VEC, b);
#pragma unroll
      for (int j = 0; j < VEC; ++j)
        o[j] = __fadd_rn(__fmul_rn(__fmul_rn(v[i][j] - mu, rstd), g[j]), b[j]);
      store8(dst + c * VEC, o);
    }
  }
}

// The SMs of the current device, read once per device.
int sm_count() {
  static std::atomic<int> cached[32];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= 32) return 132;
  int n = cached[dev].load();
  if (n == 0) {
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) n = 132;
    cached[dev].store(n);
  }
  return n;
}

// Rows (warps) a block for the warp-a-row kernel: four, halved while the
// grid would hold fewer blocks than half the SMs.
int rows_per_block(int rows) {
  const int sms = sm_count();
  int rpb = THREADS / 32;
  while (rpb > 1 && (rows + rpb - 1) / rpb * 2 < sms) rpb /= 2;
  return rpb;
}

template <typename T>
cudaError_t launch_ln(const void* x, const void* gamma, const void* beta, void* y, int rows,
                      int D, float eps, cudaStream_t st) {
  const T* xp = static_cast<const T*>(x);
  const float* g = static_cast<const float*>(gamma);
  const float* b = static_cast<const float*>(beta);
  T* yp = static_cast<T*>(y);
  if (D <= 32 * VEC * MAX_CHUNKS) {
    const int rpb = rows_per_block(rows);
    ln_fwd_kernel<T, 32><<<(rows + rpb - 1) / rpb, 32 * rpb, 0, st>>>(xp, g, b, yp, rows, D,
                                                                      eps);
  } else {
    ln_fwd_kernel<T, THREADS><<<rows, THREADS, 0, st>>>(xp, g, b, yp, rows, D, eps);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// _ln_kernel: y (rows, D) = LayerNorm(x) with f32 gamma, beta (D); x and y
// bf16 (f32 = 0) or f32 (f32 = 1), contiguous and 16-byte aligned.
int dp_layernorm(const void* x, const void* gamma, const void* beta, void* y, int rows, int D,
                 int f32, float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows <= 0) return 0;
  if (D % VEC != 0 || D > THREADS * VEC * MAX_CHUNKS)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(f32 ? launch_ln<float>(x, gamma, beta, y, rows, D, eps, st)
                              : launch_ln<bf16>(x, gamma, beta, y, rows, D, eps, st));
}

}  // extern "C"
