// Streamed ("flash") attention for Hopper: the launchers that
// flash_kernels.cu defines and block_kernels.cu's chains call.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace dp_flash {

// One attention problem: q, k, v and the gradients dq, dk, dv share the
// "in" layout (element (b, h, s, c) at b*in_b + h*in_h + s*in_r + c); o and
// its cotangent dout the "out" layout. The chains pass the packed qkv
// (B, S, 3D) and ctx (B, S, D); the standalone wrapper (B, H, S, dh) tensors.
// stats, when not null, is (B, H, 3, S) f32: the row max and the row sum of
// the forward, then rowsum(P * dP) of the backward.
struct Params {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* o;
  const __nv_bfloat16* dout;
  __nv_bfloat16* dq;
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  float* stats;
  long long in_b, in_h, out_b, out_h;
  int in_r, out_r;
  int B, H, S;
  float scale;
};

// o = softmax(q k^T * scale) v, and stats[0..1] when stats is not null.
cudaError_t launch_fwd(const Params& p, int dh, cudaStream_t stream);
// dq, dk, dv from q, k, v, dout and the forward's stats[0..1]; writes
// stats[2].
cudaError_t launch_bwd(const Params& p, int dh, cudaStream_t stream);

}  // namespace dp_flash
