// Device helpers shared by the attention kernels (stream_attention.cu,
// block_attention.cu): type casts, warp reductions, shared-memory carving,
// tile loads and the shared-memory matrix product.  Each .cu file includes
// this header and is built into its own library.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <mma.h>
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

// C[M x N] (=, or += when ACC) op(A)[M x K] . op(B)[K x N], all in shared
// memory.  A is stored [M][K] (or [K][M] when A_T), B is stored [K][N] (or
// [N][K] when B_T).  C is fp32, row-major with stride ldc.  bf16/fp16 go
// through WMMA fragments with fp32 accumulation; fp32 through FMAs.
template <typename T, bool A_T, bool B_T, bool ACC>
__device__ __forceinline__ void mm(float* C, int ldc, const T* A, int lda,
                                   const T* Bm, int ldb, int M, int N,
                                   int K) {
  if constexpr (std::is_same<T, float>::value) {
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
  } else {
    using namespace nvcuda;
    using ALayout = typename std::conditional<A_T, wmma::col_major,
                                              wmma::row_major>::type;
    using BLayout = typename std::conditional<B_T, wmma::col_major,
                                              wmma::row_major>::type;
    const int warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
    const int tn = N / 16;
    const int tiles = (M / 16) * tn;
    for (int t = warp; t < tiles; t += nw) {
      const int tm = t / tn, tc = t % tn;
      float* cp = C + tm * 16 * ldc + tc * 16;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
      if (ACC)
        wmma::load_matrix_sync(c, cp, ldc, wmma::mem_row_major);
      else
        wmma::fill_fragment(c, 0.f);
      for (int k = 0; k < K; k += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, T, ALayout> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, T, BLayout> b;
        wmma::load_matrix_sync(
            a, A_T ? A + k * lda + tm * 16 : A + tm * 16 * lda + k, lda);
        wmma::load_matrix_sync(
            b, B_T ? Bm + tc * 16 * ldb + k : Bm + k * ldb + tc * 16, ldb);
        wmma::mma_sync(c, a, b, c);
      }
      wmma::store_matrix_sync(cp, c, ldc, wmma::mem_row_major);
    }
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
