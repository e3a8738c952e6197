// Fused LAMB and Adam optimizer steps for Hopper (sm_90a), one fp32 tensor
// per call, with a plain C interface loaded through ctypes
// (deepspeed_tpu_torch/ops/cuda_optim.py builds this file with nvcc at
// first use and holds each kernel's plain PyTorch version beside it).
//
// What each kernel replaces (the JAX package's Pallas kernels):
//   lamb_phase1_kernel  <- deepspeed_tpu/ops/pallas_optim.py _lamb_phase1_kernel
//   lamb_phase2_kernel  <- deepspeed_tpu/ops/pallas_optim.py _lamb_phase2_kernel
//   adam_kernel         <- deepspeed_tpu/ops/pallas_optim.py _adam_kernel
// and, through them, upstream DeepSpeed's csrc/fused_lamb_cuda_kernel.cu
// (part 1 + part 2 + part 3) and apex FusedAdam.
//
// Bound.  All three are elementwise passes over fp32 state, so device
// memory bandwidth bounds them, never arithmetic (about 15 flops per
// element against 28 bytes).  Bytes per element:
//   LAMB phase 1  reads p, g, m, v (16 B), writes m, v, u (12 B)   = 28 B
//   LAMB phase 2  reads p, u (8 B), writes p (4 B)                  = 12 B
//   Adam          reads p, g, m, v (16 B), writes p, m, v (12 B)   = 28 B
// so a LAMB step moves 40 B and an Adam step 28 B per parameter.
//
// Design.
//   * The Pallas phase 1 carries the two partial sums (sum p^2, sum u^2)
//     in SMEM across a SEQUENTIAL grid.  CUDA blocks run in parallel and in
//     no order, so here every block of phase 1 writes its own pair of
//     partial sums to a [nblocks, 2] scratch buffer, without atomics, and
//     every block of phase 2 reduces the whole scratch buffer itself, in
//     one fixed order.  All blocks therefore compute the same trust ratio,
//     and the result does not change from run to run.
//   * Both phases are grid-stride loops over the flat, unpadded tensor with
//     16-byte (float4) loads and stores when every pointer is 16-byte
//     aligned, and a scalar loop for the ragged tail (or for unaligned
//     views).  The zero-padded (rows, 128) copy that the TPU kernels need
//     does not exist here.
//   * The runtime scalars come from a small DEVICE buffer, float[8] per
//     tensor: beta1, beta2, 1/combined_scale, step_size, weight_decay, lr.
//     combined_scale comes from the grad norm on the device, so passing it
//     as a host float would sync the host once per tensor.
//   * p, m and v are updated IN PLACE.  The update vector u of LAMB goes
//     through device memory between the two phases (8 of the 40 B).
//
// Numerics follow deepspeed_tpu/ops/optim.py and the Pallas kernels:
// moments without bias correction, denom = sqrt(v) + eps (or
// sqrt(v + eps) with eps_inside_sqrt), L2 decay inside the update for LAMB
// and Adam, decoupled decay lr*wd*p for AdamW, and a LAMB trust ratio of
// 1.0 when either norm is zero.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float denom_of(float v, float eps,
                                          int eps_inside_sqrt) {
  return eps_inside_sqrt ? sqrtf(v + eps) : sqrtf(v) + eps;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Sums a and b over the block; the totals are valid in thread 0.  The
// order of the sum is fixed by the launch shape, so it is deterministic.
__device__ __forceinline__ void block_sum2(float& a, float& b) {
  __shared__ float sa[kThreads / 32];
  __shared__ float sb[kThreads / 32];
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  a = warp_sum(a);
  b = warp_sum(b);
  if (lane == 0) {
    sa[wid] = a;
    sb[wid] = b;
  }
  __syncthreads();
  if (wid == 0) {
    a = lane < kThreads / 32 ? sa[lane] : 0.f;
    b = lane < kThreads / 32 ? sb[lane] : 0.f;
    a = warp_sum(a);
    b = warp_sum(b);
  }
}

__device__ __forceinline__ bool aligned16(const void* a, const void* b,
                                          const void* c, const void* d,
                                          const void* e) {
  const uintptr_t bits = reinterpret_cast<uintptr_t>(a) |
                         reinterpret_cast<uintptr_t>(b) |
                         reinterpret_cast<uintptr_t>(c) |
                         reinterpret_cast<uintptr_t>(d) |
                         reinterpret_cast<uintptr_t>(e);
  return (bits & 15) == 0;
}

// One LAMB phase-1 element: moments, update vector, and the two squares.
__device__ __forceinline__ void lamb_elem(float p, float g, float& m,
                                          float& v, float& u, float b1,
                                          float b2, float inv_scale, float wd,
                                          float eps, int eps_inside_sqrt,
                                          float& sp, float& su) {
  g = g * inv_scale;
  m = b1 * m + (1.f - b1) * g;
  v = b2 * v + (1.f - b2) * g * g;
  u = m / denom_of(v, eps, eps_inside_sqrt) + wd * p;
  sp += p * p;
  su += u * u;
}

__global__ void __launch_bounds__(kThreads)
lamb_phase1_kernel(const float* __restrict__ p, const float* __restrict__ g,
                   float* __restrict__ m, float* __restrict__ v,
                   float* __restrict__ u, float* __restrict__ partials,
                   const float* __restrict__ scal, int64_t n, float eps,
                   int eps_inside_sqrt) {
  const float b1 = scal[0], b2 = scal[1], inv_scale = scal[2], wd = scal[4];
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  float sp = 0.f, su = 0.f;
  int64_t head = 0;
  if (aligned16(p, g, m, v, u)) {
    const int64_t n4 = n >> 2;
    const float4* p4 = reinterpret_cast<const float4*>(p);
    const float4* g4 = reinterpret_cast<const float4*>(g);
    float4* m4 = reinterpret_cast<float4*>(m);
    float4* v4 = reinterpret_cast<float4*>(v);
    float4* u4 = reinterpret_cast<float4*>(u);
    for (int64_t i = tid; i < n4; i += stride) {
      const float4 pp = p4[i];
      const float4 gg = g4[i];
      float4 mm = m4[i];
      float4 vv = v4[i];
      float4 uu;
      lamb_elem(pp.x, gg.x, mm.x, vv.x, uu.x, b1, b2, inv_scale, wd, eps,
                eps_inside_sqrt, sp, su);
      lamb_elem(pp.y, gg.y, mm.y, vv.y, uu.y, b1, b2, inv_scale, wd, eps,
                eps_inside_sqrt, sp, su);
      lamb_elem(pp.z, gg.z, mm.z, vv.z, uu.z, b1, b2, inv_scale, wd, eps,
                eps_inside_sqrt, sp, su);
      lamb_elem(pp.w, gg.w, mm.w, vv.w, uu.w, b1, b2, inv_scale, wd, eps,
                eps_inside_sqrt, sp, su);
      m4[i] = mm;
      v4[i] = vv;
      u4[i] = uu;
    }
    head = n4 << 2;
  }
  for (int64_t i = head + tid; i < n; i += stride) {
    float mm = m[i], vv = v[i], uu;
    lamb_elem(p[i], g[i], mm, vv, uu, b1, b2, inv_scale, wd, eps,
              eps_inside_sqrt, sp, su);
    m[i] = mm;
    v[i] = vv;
    u[i] = uu;
  }
  block_sum2(sp, su);
  if (threadIdx.x == 0) {
    partials[2 * blockIdx.x] = sp;
    partials[2 * blockIdx.x + 1] = su;
  }
}

__global__ void __launch_bounds__(kThreads)
lamb_phase2_kernel(float* __restrict__ p, const float* __restrict__ u,
                   const float* __restrict__ partials, int nparts,
                   const float* __restrict__ scal, int64_t n,
                   float min_coeff, float max_coeff) {
  __shared__ float s_rate;
  float a = 0.f, b = 0.f;
  for (int i = threadIdx.x; i < nparts; i += blockDim.x) {
    a += partials[2 * i];
    b += partials[2 * i + 1];
  }
  block_sum2(a, b);
  if (threadIdx.x == 0) {
    const float w_norm = sqrtf(a);
    const float u_norm = sqrtf(b);
    float coeff = 1.f;
    if (w_norm > 0.f && u_norm > 0.f)
      coeff = fminf(fmaxf(w_norm / u_norm, min_coeff), max_coeff);
    s_rate = scal[3] * coeff;  // step_size * trust ratio
  }
  __syncthreads();
  const float rate = s_rate;
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  int64_t head = 0;
  if (aligned16(p, u, p, u, p)) {
    const int64_t n4 = n >> 2;
    float4* p4 = reinterpret_cast<float4*>(p);
    const float4* u4 = reinterpret_cast<const float4*>(u);
    for (int64_t i = tid; i < n4; i += stride) {
      float4 pp = p4[i];
      const float4 uu = u4[i];
      pp.x = pp.x - rate * uu.x;
      pp.y = pp.y - rate * uu.y;
      pp.z = pp.z - rate * uu.z;
      pp.w = pp.w - rate * uu.w;
      p4[i] = pp;
    }
    head = n4 << 2;
  }
  for (int64_t i = head + tid; i < n; i += stride) p[i] = p[i] - rate * u[i];
}

__device__ __forceinline__ void adam_elem(float& p, float g, float& m,
                                          float& v, float b1, float b2,
                                          float inv_scale, float step_size,
                                          float wd, float lr, float eps,
                                          int eps_inside_sqrt,
                                          int decoupled) {
  g = g * inv_scale;
  m = b1 * m + (1.f - b1) * g;
  v = b2 * v + (1.f - b2) * g * g;
  const float upd = m / denom_of(v, eps, eps_inside_sqrt);
  if (decoupled)
    p = p - step_size * upd - (lr * wd) * p;
  else
    p = p - step_size * (upd + wd * p);
}

__global__ void __launch_bounds__(kThreads)
adam_kernel(float* __restrict__ p, const float* __restrict__ g,
            float* __restrict__ m, float* __restrict__ v,
            const float* __restrict__ scal, int64_t n, float eps,
            int eps_inside_sqrt, int decoupled) {
  const float b1 = scal[0], b2 = scal[1], inv_scale = scal[2];
  const float step_size = scal[3], wd = scal[4], lr = scal[5];
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  int64_t head = 0;
  if (aligned16(p, g, m, v, p)) {
    const int64_t n4 = n >> 2;
    float4* p4 = reinterpret_cast<float4*>(p);
    const float4* g4 = reinterpret_cast<const float4*>(g);
    float4* m4 = reinterpret_cast<float4*>(m);
    float4* v4 = reinterpret_cast<float4*>(v);
    for (int64_t i = tid; i < n4; i += stride) {
      float4 pp = p4[i];
      const float4 gg = g4[i];
      float4 mm = m4[i];
      float4 vv = v4[i];
      adam_elem(pp.x, gg.x, mm.x, vv.x, b1, b2, inv_scale, step_size, wd, lr,
                eps, eps_inside_sqrt, decoupled);
      adam_elem(pp.y, gg.y, mm.y, vv.y, b1, b2, inv_scale, step_size, wd, lr,
                eps, eps_inside_sqrt, decoupled);
      adam_elem(pp.z, gg.z, mm.z, vv.z, b1, b2, inv_scale, step_size, wd, lr,
                eps, eps_inside_sqrt, decoupled);
      adam_elem(pp.w, gg.w, mm.w, vv.w, b1, b2, inv_scale, step_size, wd, lr,
                eps, eps_inside_sqrt, decoupled);
      p4[i] = pp;
      m4[i] = mm;
      v4[i] = vv;
    }
    head = n4 << 2;
  }
  for (int64_t i = head + tid; i < n; i += stride) {
    float pp = p[i], mm = m[i], vv = v[i];
    adam_elem(pp, g[i], mm, vv, b1, b2, inv_scale, step_size, wd, lr, eps,
              eps_inside_sqrt, decoupled);
    p[i] = pp;
    m[i] = mm;
    v[i] = vv;
  }
}

}  // namespace

// C interface.  Every pointer is a device pointer, `stream` is a
// cudaStream_t, and each function returns cudaGetLastError() after its
// launch (0 = cudaSuccess).  `nblocks` of the two LAMB phases must agree:
// phase 1 writes 2 * nblocks partial sums and phase 2 reads them.

extern "C" int dstt_lamb_phase1(const float* p, const float* g, float* m,
                                float* v, float* u, float* partials,
                                int nblocks, const float* scal, int64_t n,
                                float eps, int eps_inside_sqrt,
                                void* stream) {
  lamb_phase1_kernel<<<nblocks, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      p, g, m, v, u, partials, scal, n, eps, eps_inside_sqrt);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dstt_lamb_phase2(float* p, const float* u,
                                const float* partials, int nblocks,
                                const float* scal, int64_t n, float min_coeff,
                                float max_coeff, void* stream) {
  lamb_phase2_kernel<<<nblocks, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      p, u, partials, nblocks, scal, n, min_coeff, max_coeff);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dstt_adam(float* p, const float* g, float* m, float* v,
                         int nblocks, const float* scal, int64_t n, float eps,
                         int eps_inside_sqrt, int decoupled, void* stream) {
  adam_kernel<<<nblocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      p, g, m, v, scal, n, eps, eps_inside_sqrt, decoupled);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* dstt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
