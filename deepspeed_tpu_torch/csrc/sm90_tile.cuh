// Device helpers for the Hopper (sm_90a) attention kernels of
// stream_attention.cu and block_attention.cu: asynchronous global->shared
// copies (cp.async), the register-fragment tensor-core products (ldmatrix
// + mma.sync m16n8k16 and the warpgroup wgmma m64n64k16), shared-memory
// matrix descriptors, the fences and barriers between them, and the
// launch.  attention_common.cuh keeps the older helpers that the fp32
// routes use.
//
// Fragment layouts (lane = 4 * gq + tq, gq = lane / 4, tq = lane % 4):
//   mma.sync m16n8k16 A (16 x 16, row-major):  a[0] = A[gq][2tq..2tq+1],
//     a[1] = A[gq+8][2tq..], a[2] = A[gq][2tq+8..], a[3] = A[gq+8][2tq+8..];
//   B (16 x 8): b[0] = B[2tq..2tq+1][gq], b[1] = B[2tq+8..2tq+9][gq];
//   C (16 x 8): c[0..1] = C[gq][2tq..2tq+1], c[2..3] = C[gq+8][2tq..].
//   wgmma m64nN: warp w of the warpgroup holds rows 16w..16w+15; its
//   accumulator is the mma.sync C layout repeated over the N/8 column
//   groups (d[4n + e]), and its register A operand the mma.sync A layout.
//   So an fp32 accumulator packed pairwise to bf16/fp16 IS the A operand of
//   the next product over the same columns (P after the softmax).

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ------------------------------------------------------------- cp.async

// 16 bytes global -> shared; `valid` false writes 16 zero bytes instead.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N groups of this thread are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Shared-memory writes of this thread (cp.async, st.shared) made visible
// to the asynchronous proxy that wgmma reads its descriptors through.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ------------------------------------------------------- packing, ldmatrix

template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  static_assert(!std::is_same<T, float>::value, "16-bit types only");
  uint32_t r;
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    r = *reinterpret_cast<uint32_t*>(&v);
  } else {
    __half2 v = __floats2half2_rn(lo, hi);
    r = *reinterpret_cast<uint32_t*>(&v);
  }
  return r;
}

// four 8x8 16-bit matrices; lanes 8m..8m+7 give the row addresses of
// matrix m, register m receives it (TRANS: transposed)
template <bool TRANS>
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  if constexpr (TRANS)
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(smem_u32(p)));
  else
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(smem_u32(p)));
}

// ----------------------------------------------------------------- mma.sync

// c += a . b, m16n8k16, 16-bit inputs, fp32 accumulators
template <typename T>
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  else
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ------------------------------------------------------------------ wgmma

// Shared-memory matrix descriptor, no swizzle (CUTLASS's INTERLEAVE): the
// operand is built of 8 x 16-byte core matrices, each 128 contiguous
// bytes.  K-major (rows of the operand contiguous along K): `lbo` is the
// byte step between the two 16-byte K chunks of one k16 slice, `sbo`
// between 8-row groups.  MN-major (transposed): `lbo` steps between
// 8-row groups along K, `sbo` between 8-column groups along M/N.
__device__ __forceinline__ uint64_t gmma_desc(const void* p, uint32_t lbo,
                                              uint32_t sbo) {
  return uint64_t((smem_u32(p) & 0x3FFFF) >> 4) |
         (uint64_t((lbo >> 4) & 0x3FFF) << 16) |
         (uint64_t((sbo >> 4) & 0x3FFF) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Pin registers at this point of the program: the compiler may not move
// their reads or writes across it (around the asynchronous products).
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void reg_fence(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

#define DSTT_D32                                                          \
  "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19," \
  "%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31}"
#define DSTT_D32_OUT(d)                                                    \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),  \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),         \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),     \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),     \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),     \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),     \
      "+f"(d[31])

// d (=, or += when acc) A . B, m64n64k16: A and B from shared memory,
// both K-major
template <typename T>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int acc) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " DSTT_D32
        ", %32, %33, p, 1, 1, 0, 0;\n}\n"
        : DSTT_D32_OUT(d)
        : "l"(da), "l"(db), "r"(acc));
  else
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 " DSTT_D32
        ", %32, %33, p, 1, 1, 0, 0;\n}\n"
        : DSTT_D32_OUT(d)
        : "l"(da), "l"(db), "r"(acc));
}

// d += A . B, m64n64k16: A from registers, B from shared memory MN-major
// (stored K rows of N contiguous elements: the transposed operand)
template <typename T>
__device__ __forceinline__ void wgmma_rs_t(float (&d)[32],
                                           const uint32_t (&a)[4],
                                           uint64_t db) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " DSTT_D32
        ", {%32,%33,%34,%35}, %36, p, 1, 1, 1;\n}\n"
        : DSTT_D32_OUT(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  else
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 " DSTT_D32
        ", {%32,%33,%34,%35}, %36, p, 1, 1, 1;\n}\n"
        : DSTT_D32_OUT(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d += A . B, m64n64k16: A and B from shared memory, both MN-major (A
// stored K rows of M contiguous elements, B K rows of N: both transposed)
template <typename T>
__device__ __forceinline__ void wgmma_ss_tt(float (&d)[32], uint64_t da,
                                            uint64_t db) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " DSTT_D32
        ", %32, %33, p, 1, 1, 1, 1;\n}\n"
        : DSTT_D32_OUT(d)
        : "l"(da), "l"(db), "r"(1));
  else
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 " DSTT_D32
        ", %32, %33, p, 1, 1, 1, 1;\n}\n"
        : DSTT_D32_OUT(d)
        : "l"(da), "l"(db), "r"(1));
}

#undef DSTT_D32
#undef DSTT_D32_OUT

// Barrier over the 128 threads of one warpgroup (named barrier `id`, 1-15;
// 0 is __syncthreads').
__device__ __forceinline__ void wg_barrier(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

// ------------------------------------------------------------------ launch

// Launch `Kernel`, setting its dynamic shared-memory limit on the first
// launch on each device (one bit per device and instantiation) to `limit`
// (0: `smem`; a kernel whose shared memory grows with a runtime size
// passes its largest); returns cudaGetLastError() after the launch.
template <auto Kernel, typename A>
int launch_once(dim3 grid, int threads, size_t smem, const A& a,
                cudaStream_t stream, size_t limit = 0) {
  static std::atomic<uint64_t> set_on{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return int(err);
  const uint64_t bit = uint64_t(1) << (dev & 63);
  if (!(set_on.load(std::memory_order_acquire) & bit)) {
    err = cudaFuncSetAttribute(
        Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        int(limit > smem ? limit : smem));
    if (err != cudaSuccess) return int(err);
    set_on.fetch_or(bit, std::memory_order_release);
  }
  Kernel<<<grid, threads, smem, stream>>>(a);
  return int(cudaGetLastError());
}

}  // namespace
