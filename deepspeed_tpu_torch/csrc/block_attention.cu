// Whole-tile attention for Hopper (sm_90a): the forward and backward kernels
// for short sequences (T <= 128), on q, k, v in the public [B, T, n, d]
// layout read through their strides (the views of the packed qkv projection
// need no copy), with a plain C interface loaded through ctypes
// (deepspeed_tpu_torch/ops/block_attention.py builds this file with nvcc at
// first use and holds each kernel's plain PyTorch version beside it).
//
// What each kernel replaces (deepspeed_tpu/ops/pallas_attention.py):
//   block_fwd_kernel  <- _fwd_kernel  (:106, pallas_call :180)
//   block_bwd_kernel  <- _bwd_kernel  (:122, pallas_call :200)
//
// Contract (the Pallas whole-tile kernels', which is not the streaming
// kernels').  Scores are q.k^T summed in fp32, times `scale`; under `causal`
// a key after the query, then a key whose mask entry is 0, scores -1e9.  The
// softmax is exact over the whole row: row max, sum of exp, then p = e / sum
// in fp32, so a row whose keys are all masked comes out uniform over all T
// keys.  The forward casts the NORMALISED p to the input type before p.V.
// The backward recomputes p, takes dV = p^T dO (p cast), dP = dO V^T, the
// fp32 row sum t = rowsum(dP * p) over the whole row, dS = p * (dP - t) cast
// to the input type WITHOUT the scale, and multiplies the fp32 dQ = dS K and
// dK = dS^T q by `scale`.  It emits no logsumexp.  Every product sums in
// fp32.  Because a fully masked row is uniform, no tile may be skipped: the
// kernels compute the whole [T, T] tile, as the TPU kernels do.
//
// Bound.  At GPT-2 medium, seq 128, micro-batch 32 (B*n = 512 heads,
// T = 128, d = 64, bf16) one T^2 d product pass over all heads is 1.07
// GFLOP and each [B, T, n, d] operand 8.39 MB.  The forward (2 passes, q, k,
// v read and o written: 33.6 MB) is bound by bytes, 10.0 us at 3.35 TB/s
// against 2.2 us of bf16 tensor work at 989 TFLOP/s; the backward (5 passes,
// 7 operands: 58.7 MB) by bytes too, 17.5 us against 5.4 us.
//
// Design.  A simple kernel that is right, before a fast one:
//   * The TPU grid's head and batch blocks are not carried over: each
//     (b, head) is independent.  The forward runs one block per (b, head,
//     query tile of QT rows: 64, or 32 in fp32), 2 blocks per SM by shared
//     memory; K and V of the head and the tile's whole score rows sit in
//     shared memory (T <= 128), so the softmax is the TPU kernel's exact
//     two-pass one, one warp per row.
//   * The backward runs one block per (b, head), so the dK and dV sums over
//     all query rows stay in the block (fp32 accumulators in shared memory)
//     and need no atomics: the sums run in a fixed order.  The block holds K,
//     V and the two accumulators for the whole head and walks the query rows
//     in tiles of QT (32, or 16 in fp32): per tile it recomputes the whole
//     score rows, p, dP, the row sum and dS, adds into dK and dV, and writes
//     the tile's dQ.  At T = 128, d = 64, bf16 that is 167 KB of shared
//     memory and 512 blocks, one per SM at a time, 16 warps each.
//   * bf16/fp16 products run on the tensor cores through WMMA 16x16x16
//     fragments with fp32 accumulation; fp32 products are plain fp32 FMAs
//     (never TF32).  The head dim is zero-padded to DP (32 or 64) in shared
//     memory; a partial query tile is zero-padded and not written.
//   * Outputs (o, dq, dk, dv) are written contiguous [B, T, n, d].

#include "attention_common.cuh"

namespace {

constexpr int kMaxT = 128;  // a score row is held 4 values per lane
constexpr int kFwdThreads = 256;
constexpr int kBwdThreads = 512;
constexpr float kNegInf = -3.0e38f;

struct Args {
  const void *q, *k, *v, *dout;  // dout: contiguous [B, T, n, d]
  const float* mask;             // [B, T], 1 = attend
  void *o, *dq, *dk, *dv;        // contiguous [B, T, n, d]
  long long sB, sT, sH;          // element strides of q, k and v
  int B, n, T, d, causal;
  float scale;
};

// Shared-memory layouts for a runtime T: the same on the host (launch size)
// and on the device (carving).  Row strides carry a 16-byte pad and stay
// multiples of 16 bytes, as WMMA loads need.  The fp32 score tile is reused
// for the fp32 product tile afterwards, so its stride covers both.
template <typename T, int DP>
struct FwdLayout {
  int LDT, LDS, LDP;
  size_t q, kv, s, p, mk, total;
  __host__ __device__ FwdLayout(int Tn, int QT) {
    LDT = DP + 16 / int(sizeof(T));
    LDS = (Tn > DP ? Tn : DP) + 4;
    LDP = Tn + 16 / int(sizeof(T));
    q = align128(size_t(QT) * LDT * sizeof(T));
    kv = align128(size_t(Tn) * LDT * sizeof(T));
    s = align128(size_t(QT) * LDS * 4);
    p = align128(size_t(QT) * LDP * sizeof(T));
    mk = align128(size_t(Tn) * 4);
    total = q + 2 * kv + s + p + mk;  // q; k, v; s / o; p; mask
  }
};

template <typename T, int DP>
struct BwdLayout {
  int LDT, LDS, LDP, LDA;
  size_t kv, op, s, p, acc, mk, total;
  __host__ __device__ BwdLayout(int Tn, int QT) {
    LDT = DP + 16 / int(sizeof(T));
    LDS = (Tn > DP ? Tn : DP) + 4;
    LDP = Tn + 16 / int(sizeof(T));
    LDA = DP + 4;
    kv = align128(size_t(Tn) * LDT * sizeof(T));
    op = align128(size_t(QT) * LDT * sizeof(T));
    s = align128(size_t(QT) * LDS * 4);
    p = align128(size_t(QT) * LDP * sizeof(T));
    acc = align128(size_t(Tn) * LDA * 4);
    mk = align128(size_t(Tn) * 4);
    // k, v; q, dO; s / dq, dp; p, ds; dk, dv; mask
    total = 2 * kv + 2 * op + 2 * s + 2 * p + 2 * acc + mk;
  }
};

// p of one score row (query index qi), as _scores + _softmax: scaled, the
// causal band and then the key mask set to -1e9, max, exp, sum, divide.
// Lane l holds columns l, l + 32, ... in x[].
__device__ __forceinline__ void softmax_row(const float* srow,
                                            const float* mk, int Tn, int qi,
                                            const Args& a,
                                            float (&x)[kMaxT / 32]) {
  const int lane = threadIdx.x & 31;
  float mx = kNegInf;
#pragma unroll
  for (int u = 0; u < kMaxT / 32; ++u) {
    const int c = lane + 32 * u;
    if (c < Tn) {
      float s = srow[c] * a.scale;
      if (a.causal && c > qi) s = kMasked;
      if (mk[c] == 0.f) s = kMasked;
      x[u] = s;
      mx = fmaxf(mx, s);
    }
  }
  mx = warp_max(mx);
  float sum = 0.f;
#pragma unroll
  for (int u = 0; u < kMaxT / 32; ++u) {
    if (lane + 32 * u < Tn) {
      x[u] = expf(x[u] - mx);
      sum += x[u];
    }
  }
  sum = warp_sum(sum);
#pragma unroll
  for (int u = 0; u < kMaxT / 32; ++u)
    if (lane + 32 * u < Tn) x[u] = x[u] / sum;
}

// rows x d of an fp32 shared tile (stride ld), times `mul`, to rows of a
// contiguous [B, T, n, d] array (row stride n * d) in type T.
template <typename T>
__device__ __forceinline__ void store_rows(T* dst, size_t dst_ld,
                                           const float* src, int ld,
                                           int rows, int d, float mul) {
  for (int e = threadIdx.x; e < rows * d; e += blockDim.x) {
    const int r = e / d, c = e % d;
    dst[r * dst_ld + c] = from_f<T>(src[r * ld + c] * mul);
  }
}

// ------------------------------------------------------------------ forward

template <typename T, int DP, int QT>
__global__ void __launch_bounds__(kFwdThreads) block_fwd_kernel(Args a) {
  const FwdLayout<T, DP> L(a.T, QT);
  extern __shared__ __align__(128) unsigned char smem[];
  Carve cv{smem};
  T* Qs = cv.take<T>(L.q);
  T* Ks = cv.take<T>(L.kv);
  T* Vs = cv.take<T>(L.kv);
  float* Ss = cv.take<float>(L.s);
  T* Pc = cv.take<T>(L.p);
  float* mk = cv.take<float>(L.mk);

  const int g = blockIdx.x, b = g / a.n, h = g % a.n;
  const int Tn = a.T, d = a.d, q0 = blockIdx.y * QT;
  const int rows = min(QT, Tn - q0);
  const size_t base = size_t(b) * a.sB + size_t(h) * a.sH;
  const size_t sT = size_t(a.sT);
  load_tile<T, DP>(Qs, L.LDT, static_cast<const T*>(a.q) + base + q0 * sT,
                   rows, d, sT, QT);
  load_tile<T, DP>(Ks, L.LDT, static_cast<const T*>(a.k) + base, Tn, d, sT);
  load_tile<T, DP>(Vs, L.LDT, static_cast<const T*>(a.v) + base, Tn, d, sT);
  load_vec(mk, a.mask + size_t(b) * Tn, Tn);
  __syncthreads();
  mm<T, false, true, false>(Ss, L.LDS, Qs, L.LDT, Ks, L.LDT, QT, Tn, DP);
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < QT; r += blockDim.x >> 5) {
    float x[kMaxT / 32];
    softmax_row(Ss + r * L.LDS, mk, Tn, q0 + r, a, x);
#pragma unroll
    for (int u = 0; u < kMaxT / 32; ++u)
      if (lane + 32 * u < Tn) Pc[r * L.LDP + lane + 32 * u] = from_f<T>(x[u]);
  }
  __syncthreads();
  // o = p.V into the score tile, which is no longer read
  mm<T, false, false, false>(Ss, L.LDS, Pc, L.LDP, Vs, L.LDT, QT, DP, Tn);
  __syncthreads();
  const size_t ld_out = size_t(a.n) * d;
  T* o = static_cast<T*>(a.o) + (size_t(b) * Tn + q0) * ld_out +
         size_t(h) * d;
  store_rows(o, ld_out, Ss, L.LDS, rows, d, 1.f);
}

// ----------------------------------------------------------------- backward

template <typename T, int DP, int QT>
__global__ void __launch_bounds__(kBwdThreads) block_bwd_kernel(Args a) {
  const BwdLayout<T, DP> L(a.T, QT);
  extern __shared__ __align__(128) unsigned char smem[];
  Carve cv{smem};
  T* Ks = cv.take<T>(L.kv);
  T* Vs = cv.take<T>(L.kv);
  T* Qs = cv.take<T>(L.op);
  T* dOs = cv.take<T>(L.op);
  float* Ss = cv.take<float>(L.s);
  float* dPs = cv.take<float>(L.s);
  T* Pc = cv.take<T>(L.p);
  T* dSc = cv.take<T>(L.p);
  float* dKa = cv.take<float>(L.acc);
  float* dVa = cv.take<float>(L.acc);
  float* mk = cv.take<float>(L.mk);

  const int g = blockIdx.x, b = g / a.n, h = g % a.n;
  const int Tn = a.T, d = a.d;
  const size_t base = size_t(b) * a.sB + size_t(h) * a.sH;
  const size_t sT = size_t(a.sT);
  const size_t ld_out = size_t(a.n) * d;
  const size_t obase = size_t(b) * Tn * ld_out + size_t(h) * d;
  const T* q = static_cast<const T*>(a.q) + base;
  const T* dout = static_cast<const T*>(a.dout) + obase;
  load_tile<T, DP>(Ks, L.LDT, static_cast<const T*>(a.k) + base, Tn, d, sT);
  load_tile<T, DP>(Vs, L.LDT, static_cast<const T*>(a.v) + base, Tn, d, sT);
  load_vec(mk, a.mask + size_t(b) * Tn, Tn);
  zero(dKa, Tn * L.LDA);
  zero(dVa, Tn * L.LDA);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int q0 = 0; q0 < Tn; q0 += QT) {
    const int rows = min(QT, Tn - q0);
    __syncthreads();  // the previous tile's q, dO and dq are no longer read
    // zero rows past T give zero dS and dO rows, so they add nothing
    load_tile<T, DP>(Qs, L.LDT, q + q0 * sT, rows, d, sT, QT);
    load_tile<T, DP>(dOs, L.LDT, dout + q0 * ld_out, rows, d, ld_out, QT);
    __syncthreads();
    mm<T, false, true, false>(Ss, L.LDS, Qs, L.LDT, Ks, L.LDT, QT, Tn, DP);
    mm<T, false, true, false>(dPs, L.LDS, dOs, L.LDT, Vs, L.LDT, QT, Tn, DP);
    __syncthreads();
    for (int r = warp; r < QT; r += blockDim.x >> 5) {
      float p[kMaxT / 32];
      softmax_row(Ss + r * L.LDS, mk, Tn, q0 + r, a, p);
      const float* dprow = dPs + r * L.LDS;
      float t = 0.f;
#pragma unroll
      for (int u = 0; u < kMaxT / 32; ++u)
        if (lane + 32 * u < Tn) t += dprow[lane + 32 * u] * p[u];
      t = warp_sum(t);
#pragma unroll
      for (int u = 0; u < kMaxT / 32; ++u) {
        const int c = lane + 32 * u;
        if (c < Tn) {
          Pc[r * L.LDP + c] = from_f<T>(p[u]);
          dSc[r * L.LDP + c] = from_f<T>(p[u] * (dprow[c] - t));
        }
      }
    }
    __syncthreads();
    // three products with disjoint outputs: no barrier between them
    mm<T, true, false, true>(dVa, L.LDA, Pc, L.LDP, dOs, L.LDT, Tn, DP, QT);
    mm<T, true, false, true>(dKa, L.LDA, dSc, L.LDP, Qs, L.LDT, Tn, DP, QT);
    mm<T, false, false, false>(Ss, L.LDS, dSc, L.LDP, Ks, L.LDT, QT, DP, Tn);
    __syncthreads();
    store_rows(static_cast<T*>(a.dq) + obase + q0 * ld_out, ld_out, Ss,
               L.LDS, rows, d, a.scale);
  }
  __syncthreads();
  store_rows(static_cast<T*>(a.dk) + obase, ld_out, dKa, L.LDA, Tn, d,
             a.scale);
  store_rows(static_cast<T*>(a.dv) + obase, ld_out, dVa, L.LDA, Tn, d, 1.f);
}

// ------------------------------------------------------------------ launch

template <typename T, int DP>
int run(bool backward, const Args& a, cudaStream_t stream) {
  constexpr bool f32 = std::is_same<T, float>::value;
  if (!backward) {
    constexpr int QT = f32 ? 32 : 64;
    const FwdLayout<T, DP> L(a.T, QT);
    return launch(block_fwd_kernel<T, DP, QT>,
                  dim3(a.B * a.n, (a.T + QT - 1) / QT), kFwdThreads, L.total,
                  a, stream);
  }
  constexpr int QT = f32 ? 16 : 32;
  const BwdLayout<T, DP> L(a.T, QT);
  return launch(block_bwd_kernel<T, DP, QT>, dim3(a.B * a.n), kBwdThreads,
                L.total, a, stream);
}

template <typename T>
int run_dp(bool backward, const Args& a, cudaStream_t stream) {
  if (a.d <= 32) return run<T, 32>(backward, a, stream);
  return run<T, 64>(backward, a, stream);
}

// dtype: 0 fp32, 1 bf16, 2 fp16
int dispatch(int dtype, bool backward, const Args& a, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a.d % 8 != 0 || a.d > 64 || a.T % 16 != 0 || a.T < 16 ||
      a.T > kMaxT || a.B <= 0 || a.n <= 0)
    return int(cudaErrorInvalidValue);
  switch (dtype) {
    case 0:
      return run_dp<float>(backward, a, s);
    case 1:
      return run_dp<__nv_bfloat16>(backward, a, s);
    case 2:
      return run_dp<__half>(backward, a, s);
  }
  return int(cudaErrorInvalidValue);
}

}  // namespace

// C interface.  Every pointer is a device pointer.  q, k, v are [B, T, n, d]
// in the type `dtype` names, with element strides sB, sT, sH (the last dim
// contiguous; every row 16-byte aligned); dout, o, dq, dk, dv are contiguous
// [B, T, n, d]; mask is fp32 [B, T].  `stream` is a cudaStream_t.  Each
// function returns cudaGetLastError() after its launch (0 = cudaSuccess), or
// cudaErrorInvalidValue for a shape it does not take (T not a multiple of
// 16 in [16, 128], d not a multiple of 8 up to 64).

extern "C" int dstt_block_fwd(int dtype, const void* q, const void* k,
                              const void* v, const float* mask, void* o,
                              long long sB, long long sT, long long sH, int B,
                              int n, int T, int d, float scale, int causal,
                              void* stream) {
  Args a{};
  a.q = q, a.k = k, a.v = v, a.mask = mask, a.o = o;
  a.sB = sB, a.sT = sT, a.sH = sH;
  a.B = B, a.n = n, a.T = T, a.d = d, a.scale = scale, a.causal = causal;
  return dispatch(dtype, false, a, stream);
}

extern "C" int dstt_block_bwd(int dtype, const void* q, const void* k,
                              const void* v, const float* mask,
                              const void* dout, void* dq, void* dk, void* dv,
                              long long sB, long long sT, long long sH, int B,
                              int n, int T, int d, float scale, int causal,
                              void* stream) {
  Args a{};
  a.q = q, a.k = k, a.v = v, a.mask = mask, a.dout = dout;
  a.dq = dq, a.dk = dk, a.dv = dv;
  a.sB = sB, a.sT = sT, a.sH = sH;
  a.B = B, a.n = n, a.T = T, a.d = d, a.scale = scale, a.causal = causal;
  return dispatch(dtype, true, a, stream);
}

extern "C" const char* dstt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
