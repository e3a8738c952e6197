// Streaming (online-softmax) attention for Hopper (sm_90a): the forward and
// three backward kernels, on head-folded [G = batch * heads, T, d] operands,
// with a plain C interface loaded through ctypes
// (deepspeed_tpu_torch/ops/stream_attention.py builds this file with nvcc at
// first use and holds each kernel's plain PyTorch version beside it).
//
// What each kernel replaces (deepspeed_tpu/ops/pallas_attention.py):
//   stream_fwd_kernel        <- _stream_fwd_kernel        (:268)
//   stream_bwd_fused_kernel  <- _stream_bwd_fused_kernel  (:371)
//   stream_dkv_kernel        <- _stream_dkv_kernel        (:330)
//   stream_dq_kernel         <- _stream_dq_kernel         (:435)
//
// Contract (the Pallas kernels', not the einsum path's).  Scores are
// q.k^T * scale summed in fp32; a key whose mask entry is 0, and under
// `causal` a key after the query, scores -1e9.  The forward keeps a running
// row max m (from -1e30), denominator l and fp32 accumulator per query row,
// casts the UNNORMALISED p = exp(s - m) to the input type before p.V,
// divides by max(l, 1e-30) at the end and emits the fp32 logsumexp
// lse = m + log(max(l, 1e-30)).  The backward recomputes p = exp(s - lse)
// and ds = p * (dp - delta) * scale with dp = dO.V^T in fp32 and
// delta = rowsum(dO * O) computed by the caller in fp32; p and ds are cast
// to the input type before dV += p^T dO, dK += ds^T q and dQ += ds k, which
// accumulate in fp32.  A kv tile wholly after a query tile is skipped under
// `causal`, as the Pallas grid skips it.
//
// Bound.  At BERT-large seq 512 (G = 128, T = 512, d = 64, bf16) one
// T^2 d product pass over all G is 4.29 GFLOP, and each [G, T, d] operand
// is 8.39 MB.  The forward (2 passes, ~34 MB) sits at the card's ridge and
// is bound by bytes (10.2 us at 3.35 TB/s against 8.7 us of bf16 tensor
// work at 989 TFLOP/s); the fused backward (5 passes), dkv (4) and dq (3)
// are bound by their products (21.7, 17.4 and 13.0 us).
//
// Design.  A simple kernel that is right, before a fast one:
//   * Tiles of B rows (B = 64 for bf16/fp16, 32 for fp32) replace the
//     512-row TPU tiles; operand tiles are staged in shared memory with a
//     16-byte row pad, the head dim zero-padded to DP (64 or 128).
//   * bf16/fp16 products run on the tensor cores through WMMA 16x16x16
//     fragments with fp32 accumulation; fp32 products are plain fp32 FMAs
//     (never TF32), so the fp32 route holds to fp32 tolerances.
//   * The Pallas grid's sequential axis becomes a loop inside the block:
//     the forward and dq loop over kv tiles, dkv over query tiles.
//   * The fused backward cannot carry dQ across blocks, as the TPU grid
//     carries it across steps, and atomics would make dQ change from run
//     to run.  So ONE block owns all tiles of its g: it visits the kv
//     tiles in ascending j, like the Pallas grid, keeps dK/dV of the kv
//     tile in shared memory and adds each dQ tile product into an fp32
//     [G, T, d] scratch in device memory that the wrapper allocates
//     (128 KB per g at seq 512, L2-resident).  Each thread adds the same
//     elements every time, so the sum is in a fixed order and needs no
//     atomics.  G blocks: 128 at micro-batch 8, about the card's 132 SMs.
//   * The kernels with a block per tile launch 256 threads (8 warps), the
//     fused backward 512 (16); outputs are written in the input type.

#include "attention_common.cuh"

namespace {

// threads per block: the fused backward has one block per g, so it takes
// more warps than the kernels with a block per tile
constexpr int kThreads = 256;
constexpr int kThreadsFused = 512;
constexpr float kMinInit = -1e30f;
constexpr float kTiny = 1e-30f;

// Shared-memory layout of one block, the same on the host (launch size) and
// on the device (carving).  Row strides carry a 16-byte pad against bank
// conflicts and stay multiples of 16 bytes, as WMMA loads need.
template <typename T, int DP, int B>
struct Layout {
  static constexpr int LDT = DP + 16 / int(sizeof(T));  // q/k/v/dO tiles
  static constexpr int LDP = B + 16 / int(sizeof(T));   // p/ds in type T
  static constexpr int LDS = B + 4;                     // fp32 score tiles
  static constexpr int LDA = DP + 4;                    // fp32 accumulators
  static constexpr size_t op = align128(size_t(B) * LDT * sizeof(T));
  static constexpr size_t pt = align128(size_t(B) * LDP * sizeof(T));
  static constexpr size_t sc = align128(size_t(B) * LDS * 4);
  static constexpr size_t acc = align128(size_t(B) * LDA * 4);
  static constexpr size_t vec = align128(size_t(B) * 4);
  // q, k, v; s; p; o; m, l, mask
  static constexpr size_t fwd = 3 * op + sc + pt + acc + 3 * vec;
  // q, dO, k, v; s, dp; p, ds; two accumulators; lse, delta, mask
  static constexpr size_t bwd2 = 4 * op + 2 * sc + 2 * pt + 2 * acc + 3 * vec;
  // the fused backward adds the dQ tile product
  static constexpr size_t bwd3 = bwd2 + acc;
};

// rows x d of an fp32 shared tile (stride ld) to device memory in type T.
template <typename T>
__device__ __forceinline__ void store_tile(T* dst, const float* src, int ld,
                                           int rows, int d) {
  for (int e = threadIdx.x; e < rows * d; e += blockDim.x) {
    const int r = e / d, c = e % d;
    dst[size_t(r) * d + c] = from_f<T>(src[r * ld + c]);
  }
}

struct Args {
  const void *q, *k, *v, *dout;
  const float *mask, *lse_in, *delta;
  void *o, *dq, *dk, *dv;
  float *lse, *dq_acc;
  int G, T, d, causal;
  float scale;
};

// ------------------------------------------------------------------ forward

template <typename T, int DP, int B>
__global__ void __launch_bounds__(kThreads) stream_fwd_kernel(Args a) {
  using Lt = Layout<T, DP, B>;
  extern __shared__ __align__(128) unsigned char smem[];
  Carve cv{smem};
  T* Qs = cv.take<T>(Lt::op);
  T* Ks = cv.take<T>(Lt::op);
  T* Vs = cv.take<T>(Lt::op);
  float* Ss = cv.take<float>(Lt::sc);
  T* Pc = cv.take<T>(Lt::pt);
  float* Os = cv.take<float>(Lt::acc);
  float* m_s = cv.take<float>(Lt::vec);
  float* l_s = cv.take<float>(Lt::vec);
  float* mk = cv.take<float>(Lt::vec);

  const int g = blockIdx.x, i = blockIdx.y, T_len = a.T, d = a.d;
  const int q0 = i * B;
  const size_t base = size_t(g) * T_len * d;
  const T* q = static_cast<const T*>(a.q) + base;
  const T* k = static_cast<const T*>(a.k) + base;
  const T* v = static_cast<const T*>(a.v) + base;
  const float* mask = a.mask + size_t(g) * T_len;

  load_tile<T, DP>(Qs, Lt::LDT, q + size_t(q0) * d, B, d, d);
  zero(Os, B * Lt::LDA);
  for (int r = threadIdx.x; r < B; r += blockDim.x) {
    m_s[r] = kMinInit;
    l_s[r] = 0.f;
  }
  const int nk = T_len / B;
  const int jend = a.causal ? i + 1 : nk;  // tile j runs iff j*B <= q0+B-1
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nw = blockDim.x >> 5;
  for (int j = 0; j < jend; ++j) {
    const int k0 = j * B;
    __syncthreads();  // the previous tile's K/V are no longer read
    load_tile<T, DP>(Ks, Lt::LDT, k + size_t(k0) * d, B, d, d);
    load_tile<T, DP>(Vs, Lt::LDT, v + size_t(k0) * d, B, d, d);
    load_vec(mk, mask + k0, B);
    __syncthreads();
    mm<T, false, true, false>(Ss, Lt::LDS, Qs, Lt::LDT, Ks, Lt::LDT, B, B,
                              DP);
    __syncthreads();
    for (int r = warp; r < B; r += nw) {
      float s[B / 32];
      float mx = kMinInit;
#pragma unroll
      for (int u = 0; u < B / 32; ++u) {
        const int c = lane + 32 * u;
        float x = Ss[r * Lt::LDS + c] * a.scale;
        if (mk[c] == 0.f) x = kMasked;
        if (a.causal && k0 + c > q0 + r) x = kMasked;
        s[u] = x;
        mx = fmaxf(mx, x);
      }
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, warp_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int u = 0; u < B / 32; ++u) {
        const float p = expf(s[u] - m_new);
        sum += p;
        Pc[r * Lt::LDP + lane + 32 * u] = from_f<T>(p);
      }
      sum = warp_sum(sum);
      const float alpha = expf(m_old - m_new);
      for (int c = lane; c < DP; c += 32) Os[r * Lt::LDA + c] *= alpha;
      __syncwarp();
      if (lane == 0) {
        l_s[r] = alpha * l_s[r] + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();
    mm<T, false, false, true>(Os, Lt::LDA, Pc, Lt::LDP, Vs, Lt::LDT, B, DP,
                              B);
  }
  __syncthreads();
  T* o = static_cast<T*>(a.o) + base + size_t(q0) * d;
  for (int e = threadIdx.x; e < B * d; e += blockDim.x) {
    const int r = e / d, c = e % d;
    o[size_t(r) * d + c] =
        from_f<T>(Os[r * Lt::LDA + c] / fmaxf(l_s[r], kTiny));
  }
  for (int r = threadIdx.x; r < B; r += blockDim.x)
    a.lse[size_t(g) * T_len + q0 + r] = m_s[r] + logf(fmaxf(l_s[r], kTiny));
}

// ----------------------------------------------------------------- backward

// The shared tile math (_recompute_p_ds): from staged q, dO, k, v, lse,
// delta and mask, p and ds (scale folded in) in type T.
template <typename T, int DP, int B>
__device__ __forceinline__ void p_ds_tile(const T* Qs, const T* dOs,
                                          const T* Ks, const T* Vs,
                                          const float* lse_s,
                                          const float* delta_s,
                                          const float* mk, float* Ss,
                                          float* dPs, T* Pc, T* dSc, int q0,
                                          int k0, const Args& a) {
  using Lt = Layout<T, DP, B>;
  mm<T, false, true, false>(Ss, Lt::LDS, Qs, Lt::LDT, Ks, Lt::LDT, B, B, DP);
  mm<T, false, true, false>(dPs, Lt::LDS, dOs, Lt::LDT, Vs, Lt::LDT, B, B,
                            DP);
  __syncthreads();
  for (int e = threadIdx.x; e < B * B; e += blockDim.x) {
    const int r = e / B, c = e % B;
    float s = Ss[r * Lt::LDS + c] * a.scale;
    if (mk[c] == 0.f) s = kMasked;
    if (a.causal && k0 + c > q0 + r) s = kMasked;
    const float p = expf(s - lse_s[r]);
    const float ds = p * (dPs[r * Lt::LDS + c] - delta_s[r]) * a.scale;
    Pc[r * Lt::LDP + c] = from_f<T>(p);
    dSc[r * Lt::LDP + c] = from_f<T>(ds);
  }
  __syncthreads();
}

template <typename T, int DP, int B>
struct BwdSmem {
  T *Qs, *dOs, *Ks, *Vs, *Pc, *dSc;
  float *Ss, *dPs, *acc0, *acc1, *lse_s, *delta_s, *mk;
  __device__ explicit BwdSmem(unsigned char* smem) {
    using Lt = Layout<T, DP, B>;
    Carve cv{smem};
    Qs = cv.take<T>(Lt::op);
    dOs = cv.take<T>(Lt::op);
    Ks = cv.take<T>(Lt::op);
    Vs = cv.take<T>(Lt::op);
    Ss = cv.take<float>(Lt::sc);
    dPs = cv.take<float>(Lt::sc);
    Pc = cv.take<T>(Lt::pt);
    dSc = cv.take<T>(Lt::pt);
    acc0 = cv.take<float>(Lt::acc);
    acc1 = cv.take<float>(Lt::acc);
    lse_s = cv.take<float>(Lt::vec);
    delta_s = cv.take<float>(Lt::vec);
    mk = cv.take<float>(Lt::vec);
  }
};

template <typename T, int DP, int B>
__device__ __forceinline__ void load_q_side(const BwdSmem<T, DP, B>& s,
                                            const Args& a, size_t base,
                                            size_t rbase, int q0) {
  using Lt = Layout<T, DP, B>;
  const int d = a.d;
  load_tile<T, DP>(s.Qs, Lt::LDT, static_cast<const T*>(a.q) + base +
                                      size_t(q0) * d, B, d, d);
  load_tile<T, DP>(s.dOs, Lt::LDT, static_cast<const T*>(a.dout) + base +
                                       size_t(q0) * d, B, d, d);
  load_vec(s.lse_s, a.lse_in + rbase + q0, B);
  load_vec(s.delta_s, a.delta + rbase + q0, B);
}

template <typename T, int DP, int B>
__device__ __forceinline__ void load_kv_side(const BwdSmem<T, DP, B>& s,
                                             const Args& a, size_t base,
                                             size_t rbase, int k0) {
  using Lt = Layout<T, DP, B>;
  const int d = a.d;
  load_tile<T, DP>(s.Ks, Lt::LDT, static_cast<const T*>(a.k) + base +
                                      size_t(k0) * d, B, d, d);
  load_tile<T, DP>(s.Vs, Lt::LDT, static_cast<const T*>(a.v) + base +
                                      size_t(k0) * d, B, d, d);
  load_vec(s.mk, a.mask + rbase + k0, B);
}

// dK, dV of one kv tile per block, query tiles innermost.
template <typename T, int DP, int B>
__global__ void __launch_bounds__(kThreads) stream_dkv_kernel(Args a) {
  using Lt = Layout<T, DP, B>;
  extern __shared__ __align__(128) unsigned char smem[];
  const BwdSmem<T, DP, B> s(smem);
  const int g = blockIdx.x, j = blockIdx.y, T_len = a.T, d = a.d;
  const int k0 = j * B;
  const size_t base = size_t(g) * T_len * d, rbase = size_t(g) * T_len;
  load_kv_side(s, a, base, rbase, k0);
  zero(s.acc0, B * Lt::LDA);  // dK
  zero(s.acc1, B * Lt::LDA);  // dV
  const int nq = T_len / B;
  for (int i = a.causal ? j : 0; i < nq; ++i) {
    const int q0 = i * B;
    __syncthreads();
    load_q_side(s, a, base, rbase, q0);
    __syncthreads();
    p_ds_tile<T, DP, B>(s.Qs, s.dOs, s.Ks, s.Vs, s.lse_s, s.delta_s, s.mk,
                        s.Ss, s.dPs, s.Pc, s.dSc, q0, k0, a);
    mm<T, true, false, true>(s.acc0, Lt::LDA, s.dSc, Lt::LDP, s.Qs, Lt::LDT,
                             B, DP, B);
    mm<T, true, false, true>(s.acc1, Lt::LDA, s.Pc, Lt::LDP, s.dOs, Lt::LDT,
                             B, DP, B);
  }
  __syncthreads();
  store_tile(static_cast<T*>(a.dk) + base + size_t(k0) * d, s.acc0, Lt::LDA,
             B, d);
  store_tile(static_cast<T*>(a.dv) + base + size_t(k0) * d, s.acc1, Lt::LDA,
             B, d);
}

// dQ of one query tile per block, kv tiles innermost.
template <typename T, int DP, int B>
__global__ void __launch_bounds__(kThreads) stream_dq_kernel(Args a) {
  using Lt = Layout<T, DP, B>;
  extern __shared__ __align__(128) unsigned char smem[];
  const BwdSmem<T, DP, B> s(smem);
  const int g = blockIdx.x, i = blockIdx.y, T_len = a.T, d = a.d;
  const int q0 = i * B;
  const size_t base = size_t(g) * T_len * d, rbase = size_t(g) * T_len;
  load_q_side(s, a, base, rbase, q0);
  zero(s.acc0, B * Lt::LDA);  // dQ
  const int jend = a.causal ? i + 1 : T_len / B;
  for (int j = 0; j < jend; ++j) {
    const int k0 = j * B;
    __syncthreads();
    load_kv_side(s, a, base, rbase, k0);
    __syncthreads();
    p_ds_tile<T, DP, B>(s.Qs, s.dOs, s.Ks, s.Vs, s.lse_s, s.delta_s, s.mk,
                        s.Ss, s.dPs, s.Pc, s.dSc, q0, k0, a);
    mm<T, false, false, true>(s.acc0, Lt::LDA, s.dSc, Lt::LDP, s.Ks, Lt::LDT,
                              B, DP, B);
  }
  __syncthreads();
  store_tile(static_cast<T*>(a.dq) + base + size_t(q0) * d, s.acc0, Lt::LDA,
             B, d);
}

// One pass over all (kv tile j, query tile i) of one g per block: dK/dV of
// tile j in shared memory, dQ summed over j (ascending) in the fp32 scratch.
template <typename T, int DP, int B>
__global__ void __launch_bounds__(kThreadsFused)
    stream_bwd_fused_kernel(Args a) {
  using Lt = Layout<T, DP, B>;
  extern __shared__ __align__(128) unsigned char smem[];
  const BwdSmem<T, DP, B> s(smem);
  float* dQb = reinterpret_cast<float*>(smem + Lt::bwd2);
  const int g = blockIdx.x, T_len = a.T, d = a.d;
  const size_t base = size_t(g) * T_len * d, rbase = size_t(g) * T_len;
  float* dq_acc = a.dq_acc + base;
  const int n = T_len / B;
  for (int j = 0; j < n; ++j) {
    const int k0 = j * B;
    __syncthreads();
    load_kv_side(s, a, base, rbase, k0);
    zero(s.acc0, B * Lt::LDA);  // dK
    zero(s.acc1, B * Lt::LDA);  // dV
    for (int i = a.causal ? j : 0; i < n; ++i) {
      const int q0 = i * B;
      __syncthreads();
      load_q_side(s, a, base, rbase, q0);
      __syncthreads();
      p_ds_tile<T, DP, B>(s.Qs, s.dOs, s.Ks, s.Vs, s.lse_s, s.delta_s, s.mk,
                          s.Ss, s.dPs, s.Pc, s.dSc, q0, k0, a);
      mm<T, true, false, true>(s.acc0, Lt::LDA, s.dSc, Lt::LDP, s.Qs,
                               Lt::LDT, B, DP, B);
      mm<T, true, false, true>(s.acc1, Lt::LDA, s.Pc, Lt::LDP, s.dOs,
                               Lt::LDT, B, DP, B);
      mm<T, false, false, false>(dQb, Lt::LDA, s.dSc, Lt::LDP, s.Ks, Lt::LDT,
                                 B, DP, B);
      __syncthreads();
      // j = 0 visits every query tile first (under causal too), so it
      // writes; later tiles add.  The element of a thread depends only on
      // threadIdx.x, so each sum runs in ascending j without atomics.
      float* dst = dq_acc + size_t(q0) * d;
      for (int e = threadIdx.x; e < B * d; e += blockDim.x) {
        const int r = e / d, c = e % d;
        const float x = dQb[r * Lt::LDA + c];
        dst[e] = j == 0 ? x : dst[e] + x;
      }
    }
    __syncthreads();
    store_tile(static_cast<T*>(a.dk) + base + size_t(k0) * d, s.acc0,
               Lt::LDA, B, d);
    store_tile(static_cast<T*>(a.dv) + base + size_t(k0) * d, s.acc1,
               Lt::LDA, B, d);
  }
  // the same element-to-thread map as the sums above: no hazard
  T* dq = static_cast<T*>(a.dq) + base;
  for (int i = 0; i < n; ++i)
    for (int e = threadIdx.x; e < B * d; e += blockDim.x)
      dq[size_t(i) * B * d + e] = from_f<T>(dq_acc[size_t(i) * B * d + e]);
}

// ------------------------------------------------------------------ launch

enum Which { kFwd = 0, kBwdFused = 1, kDkv = 2, kDq = 3 };

template <typename T, int DP>
int run(int which, const Args& a, cudaStream_t stream) {
  constexpr int B = std::is_same<T, float>::value ? 32 : 64;
  using Lt = Layout<T, DP, B>;
  if (a.T % B != 0) return int(cudaErrorInvalidValue);
  const dim3 tiles(a.G, a.T / B);
  switch (which) {
    case kFwd:
      return launch(stream_fwd_kernel<T, DP, B>, tiles, kThreads, Lt::fwd, a,
                    stream);
    case kBwdFused:
      return launch(stream_bwd_fused_kernel<T, DP, B>, dim3(a.G),
                    kThreadsFused, Lt::bwd3, a, stream);
    case kDkv:
      return launch(stream_dkv_kernel<T, DP, B>, tiles, kThreads, Lt::bwd2, a,
                    stream);
    case kDq:
      return launch(stream_dq_kernel<T, DP, B>, tiles, kThreads, Lt::bwd2, a,
                    stream);
  }
  return int(cudaErrorInvalidValue);
}

template <typename T>
int run_dp(int which, const Args& a, cudaStream_t stream) {
  if (a.d <= 64) return run<T, 64>(which, a, stream);
  if (a.d <= 128) return run<T, 128>(which, a, stream);
  return int(cudaErrorInvalidValue);
}

// dtype: 0 fp32, 1 bf16, 2 fp16
int dispatch(int dtype, int which, const Args& a, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a.d % 8 != 0 || a.G <= 0 || a.T <= 0) return int(cudaErrorInvalidValue);
  switch (dtype) {
    case 0:
      return run_dp<float>(which, a, s);
    case 1:
      return run_dp<__nv_bfloat16>(which, a, s);
    case 2:
      return run_dp<__half>(which, a, s);
  }
  return int(cudaErrorInvalidValue);
}

}  // namespace

// C interface.  Every pointer is a device pointer to a contiguous array:
// q, k, v, dout, o, dq, dk, dv are [G, T, d] in the type `dtype` names;
// mask, lse, delta are fp32 [G, T]; dq_acc is fp32 [G, T, d] scratch.
// `stream` is a cudaStream_t.  Each function returns cudaGetLastError()
// after its launch (0 = cudaSuccess), or cudaErrorInvalidValue for a shape
// it does not take (d not a multiple of 8 or above 128, T not a multiple
// of the tile).

extern "C" int dstt_stream_fwd(int dtype, const void* q, const void* k,
                               const void* v, const float* mask, void* o,
                               float* lse, int G, int T, int d, float scale,
                               int causal, void* stream) {
  Args a{};
  a.q = q, a.k = k, a.v = v, a.mask = mask, a.o = o, a.lse = lse;
  a.G = G, a.T = T, a.d = d, a.scale = scale, a.causal = causal;
  return dispatch(dtype, kFwd, a, stream);
}

extern "C" int dstt_stream_bwd_fused(int dtype, const void* q, const void* k,
                                     const void* v, const float* mask,
                                     const void* dout, const float* lse,
                                     const float* delta, void* dq, void* dk,
                                     void* dv, float* dq_acc, int G, int T,
                                     int d, float scale, int causal,
                                     void* stream) {
  Args a{};
  a.q = q, a.k = k, a.v = v, a.mask = mask, a.dout = dout, a.lse_in = lse;
  a.delta = delta, a.dq = dq, a.dk = dk, a.dv = dv, a.dq_acc = dq_acc;
  a.G = G, a.T = T, a.d = d, a.scale = scale, a.causal = causal;
  return dispatch(dtype, kBwdFused, a, stream);
}

extern "C" int dstt_stream_dkv(int dtype, const void* q, const void* k,
                               const void* v, const float* mask,
                               const void* dout, const float* lse,
                               const float* delta, void* dk, void* dv, int G,
                               int T, int d, float scale, int causal,
                               void* stream) {
  Args a{};
  a.q = q, a.k = k, a.v = v, a.mask = mask, a.dout = dout, a.lse_in = lse;
  a.delta = delta, a.dk = dk, a.dv = dv;
  a.G = G, a.T = T, a.d = d, a.scale = scale, a.causal = causal;
  return dispatch(dtype, kDkv, a, stream);
}

extern "C" int dstt_stream_dq(int dtype, const void* q, const void* k,
                              const void* v, const float* mask,
                              const void* dout, const float* lse,
                              const float* delta, void* dq, int G, int T,
                              int d, float scale, int causal, void* stream) {
  Args a{};
  a.q = q, a.k = k, a.v = v, a.mask = mask, a.dout = dout, a.lse_in = lse;
  a.delta = delta, a.dq = dq;
  a.G = G, a.T = T, a.d = d, a.scale = scale, a.causal = causal;
  return dispatch(dtype, kDq, a, stream);
}

extern "C" const char* dstt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
