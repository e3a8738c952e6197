// Device helpers shared by the attention kernels (stream_attention.cu,
// block_attention.cu): type casts, warp reductions, shared-memory carving,
// tile loads and the fp32 shared-memory matrix product of the fp32 routes.
// Each .cu file includes this header and is built into its own library.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float kMasked = -1e9f;

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <>
__device__ __forceinline__ __half from_f<__half>(float x) {
  return __float2half(x);
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__host__ __device__ constexpr size_t align128(size_t x) {
  return (x + 127) & ~size_t(127);
}

struct Carve {
  unsigned char* p;
  template <typename U>
  __device__ U* take(size_t bytes) {
    U* out = reinterpret_cast<U*>(p);
    p += bytes;
    return out;
  }
};

// C[M x N] (=, or += when ACC) op(A)[M x K] . op(B)[K x N], all fp32 in
// shared memory, by plain FMAs (never TF32).  A is stored [M][K] (or [K][M]
// when A_T), B is stored [K][N] (or [N][K] when B_T); C is row-major with
// stride ldc.
template <typename T, bool A_T, bool B_T, bool ACC>
__device__ __forceinline__ void mm(float* C, int ldc, const T* A, int lda,
                                   const T* Bm, int ldb, int M, int N,
                                   int K) {
  static_assert(std::is_same<T, float>::value, "the fp32 routes only");
  for (int e = threadIdx.x; e < M * N; e += blockDim.x) {
    const int r = e / N, n = e % N;
    float s = 0.f;
    for (int k = 0; k < K; ++k) {
      const float a = A_T ? A[k * lda + r] : A[r * lda + k];
      const float b = B_T ? Bm[n * ldb + k] : Bm[k * ldb + n];
      s = fmaf(a, b, s);
    }
    C[r * ldc + n] = ACC ? C[r * ldc + n] + s : s;
  }
}

// `rows` rows of d elements, row r at src + r * src_ld (16-byte aligned),
// into a shared tile of stride ld, 16 bytes per thread; zeros in columns
// d..DP-1, and in whole rows rows..pad_rows-1.
template <typename T, int DP>
__device__ __forceinline__ void load_tile(T* dst, int ld, const T* src,
                                          int rows, int d, size_t src_ld,
                                          int pad_rows = 0) {
  constexpr int V = 16 / int(sizeof(T));
  const int cpr = d / V;
  for (int e = threadIdx.x; e < rows * cpr; e += blockDim.x) {
    const int r = e / cpr, c = (e % cpr) * V;
    *reinterpret_cast<uint4*>(dst + r * ld + c) =
        *reinterpret_cast<const uint4*>(src + r * src_ld + c);
  }
  const int pad = DP - d;
  for (int e = threadIdx.x; e < rows * pad; e += blockDim.x) {
    const int r = e / pad, c = d + e % pad;
    dst[r * ld + c] = from_f<T>(0.f);
  }
  for (int e = threadIdx.x; e < (pad_rows - rows) * DP; e += blockDim.x)
    dst[(rows + e / DP) * ld + e % DP] = from_f<T>(0.f);
}

__device__ __forceinline__ void load_vec(float* dst, const float* src,
                                         int n) {
  for (int e = threadIdx.x; e < n; e += blockDim.x) dst[e] = src[e];
}

__device__ __forceinline__ void zero(float* dst, int n) {
  for (int e = threadIdx.x; e < n; e += blockDim.x) dst[e] = 0.f;
}

// Set the dynamic shared-memory size of `kernel` and launch it; returns
// cudaGetLastError() after the launch.
template <typename K, typename A>
int launch(K kernel, dim3 grid, int threads, size_t smem, const A& a,
           cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  kernel<<<grid, threads, smem, stream>>>(a);
  return int(cudaGetLastError());
}

}  // namespace
