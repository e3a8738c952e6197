// Streaming (online-softmax) attention for Hopper (sm_90a): the forward and
// three backward kernels, on head-folded [G = batch * heads, T, d] operands,
// with a plain C interface loaded through ctypes
// (deepspeed_tpu_torch/ops/stream_attention.py builds this file with nvcc at
// first use and holds each kernel's plain PyTorch version beside it).
//
// What each kernel replaces (deepspeed_tpu/ops/pallas_attention.py):
//   stream_fwd_wg_kernel      <- _stream_fwd_kernel        (:268)  bf16/fp16
//   stream_bwd_mma_kernel     <- _stream_bwd_fused_kernel  (:371)  bf16/fp16
//   stream_dkv_mma_kernel     <- _stream_dkv_kernel        (:330)  bf16/fp16
//   stream_dq_wg_kernel       <- _stream_dq_kernel         (:435)  bf16/fp16
//   stream_fwd_kernel         <- _stream_fwd_kernel        fp32 route
//   stream_bwd_fused_kernel   <- _stream_bwd_fused_kernel  fp32 route
//   stream_dkv_kernel         <- _stream_dkv_kernel        fp32 route
//   stream_dq_kernel          <- _stream_dq_kernel         fp32 route
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
// accumulate in fp32.  A 64-key tile wholly after a 64-row query tile is
// skipped under `causal`, as the Pallas grid skips it.
//
// Bound.  At BERT-large seq 512 (G = 128, T = 512, d = 64, bf16) one
// T^2 d product pass over all G is 4.29 GFLOP, and each [G, T, d] operand
// is 8.39 MB.  The forward (2 passes, ~34 MB) sits at the card's ridge and
// is bound by bytes (10.2 us at 3.35 TB/s against 8.7 us of bf16 tensor
// work at 989 TFLOP/s); the fused backward (5 passes), dkv (4) and dq (3)
// are bound by their products (21.7, 17.4 and 13.0 us).
//
// Design of the bf16/fp16 kernels (the train path):
//   * No product goes through shared memory.  The accumulators live in
//     registers; shared memory holds only the operand tiles and, in the
//     backward, one dS tile.
//   * Operand tiles arrive by cp.async into a ring of two stages, so tile
//     j+1 (K/V in the forward, q/dO/lse/delta in the backward) loads while
//     tile j is computed; one barrier per stage hand-over.
//   * Forward: one block per (g, 128 query rows), two warpgroups of 64 rows
//     (256 threads) that share each K/V tile.  S = q.k^T is a warpgroup
//     wgmma m64n64k16 with q and k read from shared memory (no-swizzle
//     core-matrix layout, sm90_tile.cuh); the online softmax works on the
//     accumulator registers (row max and sum over the 4 lanes of a row by
//     shuffles); p is packed to the input type in registers and is the
//     register A operand of O += p.V (wgmma with V read transposed).  Under
//     causal each warpgroup skips the tiles after its own 64 rows.
//   * Fused backward: one block per (g, kv tile) with one warp per 16 keys:
//     128-key tiles and 8 warps where d <= 64 and T is a multiple of 128
//     (512 blocks at the seq-512 shape, where the fp32 route has 128),
//     64-key
//     tiles and 4 warps otherwise (bwd_warps).  The block keeps dK and dV
//     of its keys in registers over its loop across 64-row query tiles.
//     mma.sync m16n8k16 with ldmatrix(.trans) computes S^T = k.q^T and
//     dP^T = v.dO^T per warp; p^T and dS^T are recomputed in registers and
//     are, packed, the A operands of dV += p^T dO and dK += dS^T q.  dS^T
//     goes to shared memory once, for dQ = dS.k.  Under causal a warp whose
//     64 keys lie after the query tile contributes zeros (the Pallas skip).
//   * dQ sums over kv tiles, which live in different blocks.  It stays
//     bitwise repeatable without floating-point atomics: each block writes
//     its fp32 dQ tile for (kv tile j, g, query tile i) into a partial
//     buffer [n_kv, G, T, d].  After its loop, one __threadfence for all
//     of them, it takes a ticket per visited query tile from the int
//     counter of (g, i); the block that takes the last ticket of tile i
//     sums its partials in ascending j (under causal only the kv tiles
//     that visit it), the Pallas grid's order (pallas_attention.py:
//     413-418), writes dQ in the input type and resets the counter for the
//     next call.  The order of the sum never depends on which block does
//     it.  Cost: n_kv G T d 4 bytes written and read once, 67 MB at the
//     seq-512 shape with 128-key tiles (~20 us each way at 3.35 TB/s).
//     The wrapper keeps the counters and the partials in one scratch
//     buffer per device and stream, and zeroes the counters only when
//     their extent grows; dstt_stream_bwd_fused_scratch gives both sizes.
//     Measured on an H100 at the seq-512 shape (PERF.md): a fence and a
//     ticket after every query tile cost about a third of the kernel;
//     128-key tiles (half the partials) beat 64-key tiles with more blocks
//     per SM; a semaphore-ordered add into one fp32 sum (block j adds
//     after block j - 1) and a sum through distributed shared memory
//     (the kv blocks of one g as a thread-block cluster, in step) were
//     both slower, the cluster most under causal.
//   * Split pair, dkv: the fused backward without dQ (stream_dkv_mma_
//     kernel): the same warps, ring and register dK/dV, p^T and dS^T
//     recomputed in registers (p^T by exp2 in log2 units) as the A operands
//     of dV += p^T dO and dK += dS^T q (kv_tile_step, shared with the fused
//     kernel), and no dS^T store, dQ product, partials, fence or tickets:
//     no scratch at any T.  It waits for query tile i, then (one barrier a
//     tile) loads tile i + 1 into the stage tile i - 1 used.  Blocks of 64
//     keys and 4 warps at every shape: 168 registers at d 64, three blocks
//     an SM.  Measured on an H100 against variants of this file (not
//     committed: verdicts only, PERF.md): 128-key blocks of 8 warps (208
//     registers, one block an SM) and expf were each slower; S^T and dP^T
//     in one interleaved loop, or a cap of 128 registers for a fourth
//     block, spilled and were no faster at seq 1024.  It runs at several
//     times what its products and its ldmatrix reads (each warp reads the
//     whole q and dO tiles twice, 32 KB a 64-row tile) take by count, so
//     latency with few warps an SM likely sets its pace (no hardware
//     counters here to confirm it).
//   * Split pair, dq: the forward's twin (stream_dq_wg_kernel): one block
//     per (g, 128 query rows), a warpgroup of 64 rows each, q and dO loaded
//     once, K/V tiles of 64 keys and their mask by the two-stage cp.async
//     ring (one barrier a tile).  S = q.k^T and dP = dO.v^T are wgmma
//     m64n64k16 from shared memory in one commit group, the mask read as
//     ballot bits while they run; p = exp2(s scale log2e - lse log2e), a
//     masked key's p the row's constant exp(-1e9 - lse) (1 in a fully
//     masked row, as the plain version computes it), and dS = p (dP - delta)
//     scale on the accumulator registers, lse and delta of the thread's two
//     rows held in registers; dS packed to the input type is the register A
//     operand of dQ += dS.k (k read MN-major, as the forward reads V).  Both
//     warpgroups run every tile of the block, so no wgmma sits in a branch
//     that differs per warpgroup (ptxas serialises those); under causal a
//     tile wholly after a warpgroup's rows gives p = 0 (the Pallas skip).
//     No online softmax and no sum across blocks: dQ is bitwise repeatable.
//     dQ stays in registers, is packed into the warpgroup's own q rows and
//     leaves in 16-byte stores.  127 registers at d 64 (two blocks an SM),
//     182 at d 128 (one).
//   * Head dims in (128, 256] run at DP 256, with the same contract and
//     the same rules (columns d..255 zero-filled in shared memory, loads
//     and stores stop at d).  What changes is where the accumulators fit:
//     - forward: FwdSmem<256> is 197,120 bytes and O is 128 fp32 registers
//       a thread (four 64-column chunks), so one block an SM (launch
//       bounds 1, not 2, which would cap the registers at 128);
//     - dq: q and dO at 128 rows would pass the 232,448 bytes a block may
//       take, so one warpgroup of 64 query rows a block (197,120 bytes;
//       dQ 128 registers beside S and dP);
//     - fused backward and dkv: dK and dV of 16 keys over 256 columns
//       would be 256 fp32 registers a thread, so the head dim is split
//       across warps: two warps to each 16 keys, 8 a 64-key block, each
//       owning 128 columns of dK and dV (the DP-128 kernels' registers).
//       Both warps of a pair recompute S^T and dP^T over the whole head
//       dim (bitwise the same; one of them stores dS^T for dQ), so the
//       products are 6 T^2 d passes where dkv needs 4.  The measured
//       alternative (a dkv kernel no longer in this file): dK and dV in
//       two passes over the query tiles with 4 warps, one to each 16 keys,
//       and one 256-column accumulator, which reloads q, dO, lse and delta
//       and recomputes S^T once more (5 passes) at half the warps an SM.
//       On an H100 at G 32, T 2048 it took 1.24-1.37x the split head dim's
//       time, 1.23-1.37x under causal (PERF.md), so dkv and the fused
//       backward split the head dim.
//     The fp32 fused backward and dkv take 16-row tiles at DP 256 (32-row
//     tiles would be 251,776 bytes for the first, and spill in the
//     second); the forward and dq keep 32 rows.
//     ptxas at DP 256 (H100 build, PERF.md): forward 255 registers, dq
//     241, dkv 255, fused 252, 0 spill bytes, with S^T and dP^T over four
//     k16 slices at a time (mma_abt; unrolled whole, dkv and the fused
//     backward spilled 8 and 16 bytes).
//   * Which backward DSTPU_STREAM_BWD=auto takes (ops/stream_attention.py):
//     the fused kernel while its scratch fits STREAM_FUSED_SCRATCH_BUDGET,
//     else the pair.  The budget is the largest fused scratch up to which
//     the fused kernel was no slower than the pair, causal and not, in
//     chip_smoke.py's bwd_sweep on an H100 (capped at 256 MiB, since the
//     scratch stays cached); the sweeps and the value are beside it.
//   * Each instantiation sets its dynamic shared-memory limit once
//     (launch_once); every launch returns cudaGetLastError().
//
// The fp32 route of all four is the first, simple design, kept so fp32
// holds to fp32 tolerances: tiles of 32 rows staged in shared memory with
// a 16-byte row pad, the head dim zero-padded to DP (64, 128 or 256),
// plain fp32 FMAs (never TF32), synchronous loads, accumulators in shared
// memory.  Its fused backward keeps one block per g that visits the kv
// tiles in ascending j and adds each dQ tile into an fp32 [G, T, d]
// scratch with the same element-to-thread map every time (no atomics).

#include "attention_common.cuh"
#include "sm90_tile.cuh"

namespace {

// threads per block of the first kernels: the fp32 fused backward has one
// block per g, so it takes more warps than the kernels with a block per tile
constexpr int kThreads = 256;
constexpr int kThreadsFused = 512;
constexpr float kMinInit = -1e30f;
constexpr float kTiny = 1e-30f;

// Shared-memory layout of one block, the same on the host (launch size) and
// on the device (carving).  Row strides carry a 16-byte pad against bank
// conflicts and stay multiples of 16 bytes, as the 16-byte tile loads need.
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

// ------------------------------------------- bf16/fp16 forward (wgmma)

constexpr int kKv = 64;             // keys per K/V tile, rows per query tile
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kFwdRows = 128;       // query rows per forward block
constexpr int kFwdThreads = 256;    // two warpgroups of 64 rows

// The forward's shared memory: q (128 rows) and two stages of K, V (64
// rows each) and the 64 mask entries, in the no-swizzle core-matrix
// layout: 8-row groups of DP * 16 bytes, each 8 core matrices of 8 rows x
// 16 bytes (the byte of row r, 8-column chunk c is at
// (r / 8) * RB + c * 128 + (r % 8) * 16).
template <int DP>
struct FwdSmem {
  static constexpr int RB = DP * 16;                 // bytes per 8-row group
  static constexpr int TILE = kKv * DP * 2;          // one 64-row tile
  static constexpr int STAGE = 2 * TILE + kKv * 4;   // K, V, mask
  static constexpr int Q = 2 * TILE;
  static constexpr size_t bytes = size_t(Q) + 2 * STAGE;
};

// `rows` rows from row r0 of a [T, d] matrix into the core-matrix layout,
// 16 bytes a thread and consecutive threads on consecutive shared
// addresses; columns d..DP-1 and rows past T are zero-filled.
template <typename T, int DP>
__device__ __forceinline__ void load_cm(unsigned char* dst, const T* src,
                                        int r0, int rows, int T_len, int d,
                                        int nthreads) {
  constexpr int CPR = DP / 8;  // 16-byte chunks per row
  for (int e = threadIdx.x; e < rows * CPR; e += nthreads) {
    const int r = (e / (8 * CPR)) * 8 + (e & 7), c = (e >> 3) % CPR;
    const bool ok = r0 + r < T_len && c * 8 < d;
    cp_async16(dst + (r >> 3) * (DP * 16) + c * 128 + (r & 7) * 16,
               ok ? src + size_t(r0 + r) * d + c * 8 : src, ok);
  }
}

// two blocks an SM up to DP 128; at DP 256 one (197,120 bytes, and O at
// 128 registers a thread)
template <typename T, int DP>
__global__ void __launch_bounds__(kFwdThreads, DP > 128 ? 1 : 2)
    stream_fwd_wg_kernel(Args a) {
  using S = FwdSmem<DP>;
  constexpr int RB = S::RB, NH = DP / 64;  // 64-column chunks of O
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* Qs = smem;
  unsigned char* stages = smem + S::Q;
  const int T_len = a.T, d = a.d;
  const int nqb = (T_len + kFwdRows - 1) / kFwdRows;
  const int g = blockIdx.x / nqb, q0 = (blockIdx.x % nqb) * kFwdRows;
  const int tid = threadIdx.x, wg = tid >> 7;
  const int warp = (tid >> 5) & 3, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const size_t base = size_t(g) * T_len * d;
  const T* q = static_cast<const T*>(a.q) + base;
  const T* k = static_cast<const T*>(a.k) + base;
  const T* v = static_cast<const T*>(a.v) + base;
  const float* mask = a.mask + size_t(g) * T_len;
  const int nk = T_len / kKv;
  const int my_tile = q0 / kKv + wg;  // this warpgroup's 64-row query tile
  const bool active = my_tile < nk;
  const int jend = a.causal ? min(nk, q0 / kKv + 2) : nk;

  auto load_kv = [&](int j, int s) {
    unsigned char* st = stages + s * S::STAGE;
    load_cm<T, DP>(st, k, j * kKv, kKv, T_len, d, kFwdThreads);
    load_cm<T, DP>(st + S::TILE, v, j * kKv, kKv, T_len, d, kFwdThreads);
    if (tid < kKv / 4)
      cp_async16(st + 2 * S::TILE + tid * 16, mask + j * kKv + tid * 4, true);
  };
  load_cm<T, DP>(Qs, q, q0, kFwdRows, T_len, d, kFwdThreads);
  load_kv(0, 0);
  cp_async_commit();

  float o[NH][32];
#pragma unroll
  for (int h = 0; h < NH; ++h)
#pragma unroll
    for (int e = 0; e < 32; ++e) o[h][e] = 0.f;
  float m[2] = {kMinInit, kMinInit}, l[2] = {0.f, 0.f};
  // this thread's rows: row0 and row0 + 8
  const int row0 = my_tile * kKv + 16 * warp + gq;
  const uint64_t qdesc = gmma_desc(Qs + wg * 8 * RB, 128, RB);

  for (int j = 0; j < jend; ++j) {
    if (j + 1 < jend) load_kv(j + 1, (j + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();  // q and tile j have landed
    fence_proxy_async();
    __syncthreads();
    if (active && (!a.causal || j <= my_tile)) {
      const unsigned char* Ks = stages + (j & 1) * S::STAGE;
      const unsigned char* Vs = Ks + S::TILE;
      const float* mk = reinterpret_cast<const float*>(Ks + 2 * S::TILE);
      const int k0 = j * kKv;
      float s[32] = {};  // overwritten: the first k slice does not add
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
        wgmma_ss<T>(s, qdesc + ((kk * 256) >> 4),
                    gmma_desc(Ks + kk * 256, 128, RB), kk > 0);
      wgmma_commit();
      wgmma_wait0();
      reg_fence(s);
      // masks, then the online softmax on the accumulator registers:
      // s[4n + e] is row row0 + 8 (e >> 1), column 8n + 2tq + (e & 1)
      float mx[2] = {kMinInit, kMinInit};
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 8 * n + 2 * tq + (e & 1);
          float x = s[4 * n + e] * a.scale;
          if (mk[c] == 0.f) x = kMasked;
          if (a.causal && k0 + c > row0 + 8 * (e >> 1)) x = kMasked;
          s[4 * n + e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      float alpha[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        const float m_new = fmaxf(m[h], mx[h]);
        alpha[h] = expf(m[h] - m_new);
        m[h] = m_new;
        l[h] *= alpha[h];  // this thread's share of the row sum
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const float p = expf(s[i] - m[(i >> 1) & 1]);
        l[(i >> 1) & 1] += p;
        s[i] = p;
      }
#pragma unroll
      for (int h = 0; h < NH; ++h)
#pragma unroll
        for (int i = 0; i < 32; ++i) o[h][i] *= alpha[(i >> 1) & 1];
      // p (unnormalised, in the input type) as the A operand of p.V
      uint32_t pa[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          pa[kk][r] = pack2<T>(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
#pragma unroll
      for (int h = 0; h < NH; ++h) reg_fence(o[h]);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) reg_fence(pa[kk]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int h = 0; h < NH; ++h)
          wgmma_rs_t<T>(o[h], pa[kk],
                        gmma_desc(Vs + kk * 2 * RB + h * 1024, RB, 128));
      wgmma_commit();
      wgmma_wait0();
#pragma unroll
      for (int h = 0; h < NH; ++h) reg_fence(o[h]);
    }
    __syncthreads();  // stage j & 1 is refilled next iteration
  }
  if (!active) return;
  T* out = static_cast<T*>(a.o) + base;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    l[h] = fmaxf(l[h], kTiny);
  }
#pragma unroll
  for (int hh = 0; hh < NH; ++hh)
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int c = hh * 64 + 8 * n + 2 * tq;
      if (c < d)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<uint32_t*>(out + size_t(row0 + 8 * h) * d + c) =
              pack2<T>(o[hh][4 * n + 2 * h] / l[h],
                       o[hh][4 * n + 2 * h + 1] / l[h]);
    }
  if (tq == 0)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      a.lse[size_t(g) * T_len + row0 + 8 * h] = m[h] + logf(l[h]);
}

// -------------------------------------- bf16/fp16 fused backward (mma.sync)

// 16-key groups per fused-backward block: 8 (128 keys) where the head dim
// fits 64 and T is a multiple of 128, else 4 (64 keys).
inline int bwd_warps(int T, int d) { return d <= 64 && T % 128 == 0 ? 8 : 4; }

// Warps to each 16 keys in the fused backward and dkv: each owns DP /
// col_split(DP) columns of dK and dV, at most 128 (128 fp32 registers for
// both), so two at DP 256.
__host__ __device__ constexpr int col_split(int dp) {
  return dp > 128 ? dp / 128 : 1;
}

// The shared memory of the fused backward (DQ) and of dkv (!DQ) with KW
// 16-key groups: k, v of the block's BK keys; two stages of q, dO (64
// rows), lse, delta; the key mask; for DQ also dS^T [BK keys][64 queries]
// and the last-ticket flags (one per thread).  Row-major with a 16-byte
// row pad (ldmatrix rows land in distinct banks).
template <int DP, int KW, bool DQ>
struct BwdMmaSmem {
  static constexpr int NW = KW * col_split(DP);  // warps a block
  static constexpr int BK = 16 * KW;
  static constexpr int LD = DP + 8;    // elements per operand row
  static constexpr int LDS = kKv + 8;  // elements per dS^T row
  static constexpr int QT = kKv * LD * 2, KT = BK * LD * 2;
  static constexpr int STAGE = 2 * QT + 2 * kKv * 4;
  static constexpr int K = 0, V = KT, ST = 2 * KT;
  static constexpr int MK = ST + 2 * STAGE;
  static constexpr int DS = MK + BK * 4;
  static constexpr int LAST = DS + (DQ ? BK * LDS * 2 : 0);
  static constexpr size_t bytes = size_t(LAST) + (DQ ? 32 * NW * 4 : 0);
};

// `rows` rows from row r0 of a [T, d] matrix into a padded row-major tile
template <typename T, int DP>
__device__ __forceinline__ void load_rows(T* dst, const T* src, int r0,
                                          int rows, int d, int nthreads) {
  constexpr int CPR = DP / 8, LD = DP + 8;
  for (int e = threadIdx.x; e < rows * CPR; e += nthreads) {
    const int r = e / CPR, c = e % CPR;
    const bool ok = c * 8 < d;
    cp_async16(dst + r * LD + c * 8,
               ok ? src + size_t(r0 + r) * d + c * 8 : src, ok);
  }
}

// n floats (a multiple of 4)
__device__ __forceinline__ void load_row_vec(float* dst, const float* src,
                                             int n) {
  if (int(threadIdx.x) < n / 4)
    cp_async16(dst + threadIdx.x * 4, src + threadIdx.x * 4, true);
}

// acc[8][4] (16 rows x 64 columns of this warp, C layout) = A . B^T, with A
// the warp's 16 rows of `As` and B the 64 rows of `Bs`, both row-major
// [rows][DP] in shared memory with row stride LD (K = the head dim).
template <typename T, int DP>
__device__ __forceinline__ void mma_abt(float (&acc)[8][4], const T* As,
                                        const T* Bs, int lane) {
  constexpr int LD = DP + 8;
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  // whole up to DP 128; four k16 slices at a time at DP 256, where the
  // whole loop pushes dkv and the fused backward past 255 registers into
  // spills (ptxas)
#pragma unroll (DP > 128 ? 4 : DP / 16)
  for (int kd = 0; kd < DP / 16; ++kd) {
    uint32_t af[4];
    ldsm_x4<false>(af, As + (lane & 15) * LD + kd * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t bf[4];
      const int mi = lane >> 3;
      ldsm_x4<false>(bf, Bs + (16 * np + (mi >> 1) * 8 + (lane & 7)) * LD +
                             kd * 16 + (mi & 1) * 8);
      mma16816<T>(acc[2 * np], af, bf[0], bf[1]);
      mma16816<T>(acc[2 * np + 1], af, bf[2], bf[3]);
    }
  }
}

// acc[NC/8][4] += A . B over K = 64: A the packed [4][4] fragments of the
// warp's 16 rows, B NC columns of a [64][DP] row-major matrix in shared
// memory (row stride LD; `Bs` at its first column), read transposed.
template <typename T, int DP, int NC>
__device__ __forceinline__ void mma_ab_regs(float (&acc)[NC / 8][4],
                                            const uint32_t (&af)[4][4],
                                            const T* Bs, int lane) {
  constexpr int LD = DP + 8;
  const int mi = lane >> 3;
#pragma unroll
  for (int kq = 0; kq < 4; ++kq)
#pragma unroll
    for (int nd = 0; nd < NC / 16; ++nd) {
      uint32_t bf[4];
      ldsm_x4<true>(bf, Bs + (16 * kq + (mi & 1) * 8 + (lane & 7)) * LD +
                            16 * nd + (mi >> 1) * 8);
      mma16816<T>(acc[2 * nd], af[kq], bf[0], bf[1]);
      mma16816<T>(acc[2 * nd + 1], af[kq], bf[2], bf[3]);
    }
}

// 4-byte words of the fused backward's counters, a multiple of 4
__host__ __device__ inline long long counter_words(int G, int T) {
  return ((long long)G * (T / kKv) + 3) / 4 * 4;
}

// One warp's share of a (kv tile, 64-row query tile) pair in the fused
// backward and dkv: its 16 rows `Kw`, `Vw` of k and v (the thread's keys
// key0 and key0 + 8 of the block's, whose first is key k0) against the
// staged q, dO, lse, delta of the query tile at q0.  p^T = exp(s^T -
// lse) (0 under `skip`, the causal skip), dV += p^T dO, dS^T = p^T (dP^T -
// delta) scale, dK += dS^T q; dS^T is left packed in `fa` (fa[kq][r]: key
// key0 + 8 (r & 1), queries 16 kq + 8 (r >> 1) + 2 tq, +1).  S^T and dP^T
// run over the whole head dim; dK and dV are the NC columns from col0.
template <typename T, int DP, int NC>
__device__ __forceinline__ void kv_tile_step(
    float (&dk)[NC / 8][4], float (&dv)[NC / 8][4], uint32_t (&fa)[4][4],
    const T* Kw, const T* Vw, const T* Qs, const T* dOs, const float* lse_s,
    const float* delta_s, const float* mk, int key0, int k0, int q0,
    int col0, bool skip, const Args& a) {
  const int lane = threadIdx.x & 31, tq = lane & 3;
  // p^T = exp(s^T - lse) on this warp's 16 keys x 64 queries
  float pt[8][4];
  mma_abt<T, DP>(pt, Kw, Qs, lane);
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = 8 * n + 2 * tq + (e & 1), kr = key0 + 8 * (e >> 1);
      float x = pt[n][e] * a.scale;
      if (mk[kr] == 0.f) x = kMasked;
      if (a.causal && k0 + kr > q0 + c) x = kMasked;
      pt[n][e] = skip ? 0.f : exp2f((x - lse_s[c]) * kLog2e);
    }
#pragma unroll
  for (int kq = 0; kq < 4; ++kq)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      fa[kq][r] = pack2<T>(pt[2 * kq + (r >> 1)][2 * (r & 1)],
                           pt[2 * kq + (r >> 1)][2 * (r & 1) + 1]);
  mma_ab_regs<T, DP, NC>(dv, fa, dOs + col0, lane);  // dV += p^T dO

  // dS^T = p^T (dP^T - delta) scale, dP^T = v.dO^T
  float dpt[8][4];
  mma_abt<T, DP>(dpt, Vw, dOs, lane);
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = 8 * n + 2 * tq + (e & 1);
      dpt[n][e] = pt[n][e] * (dpt[n][e] - delta_s[c]) * a.scale;
    }
#pragma unroll
  for (int kq = 0; kq < 4; ++kq)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      fa[kq][r] = pack2<T>(dpt[2 * kq + (r >> 1)][2 * (r & 1)],
                           dpt[2 * kq + (r >> 1)][2 * (r & 1) + 1]);
  mma_ab_regs<T, DP, NC>(dk, fa, Qs + col0, lane);  // dK += dS^T q
}

// One of dK, dV: the warp's keys and NC columns from col0 as packed pairs
// in the input type, 4-byte stores into the [keys, d] rows at `dst`.
template <typename T, int NC>
__device__ __forceinline__ void store_keys(T* dst, int d, int key0, int col0,
                                           const float (&acc)[NC / 8][4]) {
  const int tq = threadIdx.x & 3;
#pragma unroll
  for (int n = 0; n < NC / 8; ++n) {
    const int c = col0 + 8 * n + 2 * tq;
    if (c < d)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<uint32_t*>(dst + size_t(key0 + 8 * h) * d + c) =
            pack2<T>(acc[n][2 * h], acc[n][2 * h + 1]);
  }
}

template <typename T, int NC>
__device__ __forceinline__ void store_dkv(const Args& a, size_t off0,
                                          int key0, int col0,
                                          const float (&dk)[NC / 8][4],
                                          const float (&dv)[NC / 8][4]) {
  store_keys<T, NC>(static_cast<T*>(a.dk) + off0, a.d, key0, col0, dk);
  store_keys<T, NC>(static_cast<T*>(a.dv) + off0, a.d, key0, col0, dv);
}

template <typename T, int DP, int KW>
__global__ void __launch_bounds__(32 * KW * col_split(DP),
                                  KW == 4 && DP == 64 ? 3 : 1)
    stream_bwd_mma_kernel(Args a) {
  using S = BwdMmaSmem<DP, KW, true>;
  constexpr int NW = S::NW, NC = DP / col_split(DP);
  constexpr int LD = S::LD, NT = DP / 8, BK = S::BK, NTH = 32 * NW;
  constexpr int SUB = KW / 4;  // 64-key tiles per block
  constexpr int CW = NW / 4;   // column groups of the dQ product
  constexpr int NTQ = NT / CW;  // its 8-column tiles per warp
  extern __shared__ __align__(128) unsigned char smem[];
  T* Ks = reinterpret_cast<T*>(smem + S::K);
  T* Vs = reinterpret_cast<T*>(smem + S::V);
  T* dSt = reinterpret_cast<T*>(smem + S::DS);
  float* mk = reinterpret_cast<float*>(smem + S::MK);
  int* last = reinterpret_cast<int*>(smem + S::LAST);
  const int T_len = a.T, d = a.d, G = a.G;
  const int nq = T_len / kKv, nkb = T_len / BK;
  const int g = blockIdx.x / nkb, j = blockIdx.x % nkb, k0 = j * BK;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;
  // this warp's 16 keys (group kw) and its dK/dV columns from col0
  const int kw = warp % KW, col0 = (warp / KW) * NC;
  const int sub = j * SUB + kw / 4;  // its 64-key tile
  const size_t base = size_t(g) * T_len * d, rbase = size_t(g) * T_len;
  const T* q = static_cast<const T*>(a.q) + base;
  const T* dout = static_cast<const T*>(a.dout) + base;
  // the scratch: one int counter per (g, query tile), then the fp32
  // partials [nkb, G, T, d] (16-byte aligned)
  int* cnt = reinterpret_cast<int*>(a.dq_acc);
  float* part = a.dq_acc + counter_words(G, T_len);

  auto stage = [&](int s) { return smem + S::ST + s * S::STAGE; };
  auto load_q_tile = [&](int i, int s) {
    unsigned char* st = stage(s);
    load_rows<T, DP>(reinterpret_cast<T*>(st), q, i * kKv, kKv, d, NTH);
    load_rows<T, DP>(reinterpret_cast<T*>(st + S::QT), dout, i * kKv, kKv, d,
                     NTH);
    load_row_vec(reinterpret_cast<float*>(st + 2 * S::QT),
                 a.lse_in + rbase + i * kKv, kKv);
    load_row_vec(reinterpret_cast<float*>(st + 2 * S::QT + kKv * 4),
                 a.delta + rbase + i * kKv, kKv);
  };
  load_rows<T, DP>(Ks, static_cast<const T*>(a.k) + base, k0, BK, d, NTH);
  load_rows<T, DP>(Vs, static_cast<const T*>(a.v) + base, k0, BK, d, NTH);
  load_row_vec(mk, a.mask + rbase + k0, BK);
  const int i0 = a.causal ? j * SUB : 0;
  load_q_tile(i0, 0);
  cp_async_commit();

  float dk[NC / 8][4], dv[NC / 8][4];
#pragma unroll
  for (int n = 0; n < NC / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;
  const int key0 = 16 * kw + gq;  // this thread's keys: key0, key0 + 8

  for (int i = i0, it = 0; i < nq; ++i, ++it) {
    if (i + 1 < nq) load_q_tile(i + 1, (it + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const unsigned char* st = stage(it & 1);
    const T* Qs = reinterpret_cast<const T*>(st);
    const T* dOs = reinterpret_cast<const T*>(st + S::QT);
    const float* lse_s = reinterpret_cast<const float*>(st + 2 * S::QT);
    const float* delta_s = lse_s + kKv;
    const int q0 = i * kKv;
    // under causal a warp whose 64-key tile lies after query tile i skips
    // it (p = dS = 0), as the Pallas grid does
    uint32_t fa[4][4];
    kv_tile_step<T, DP, NC>(dk, dv, fa, Ks + 16 * kw * LD, Vs + 16 * kw * LD,
                            Qs, dOs, lse_s, delta_s, mk, key0, k0, q0, col0,
                            a.causal && sub > i, a);
    // dS^T to shared memory (the warps of one 16-key group hold the same
    // dS^T: the first stores it)
    if (warp < KW)
#pragma unroll
      for (int kq = 0; kq < 4; ++kq)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          *reinterpret_cast<uint32_t*>(
              dSt + (key0 + 8 * (r & 1)) * S::LDS + 16 * kq + 8 * (r >> 1) +
              2 * tq) = fa[kq][r];
    __syncthreads();

    // this block's dQ tile, dS . k over its BK keys: warp w takes the 16
    // queries 16 (w % 4).. and the column group w / 4
    const int rw = warp % 4, c0 = (warp / 4) * (DP / CW);
    float dqp[NTQ][4];
#pragma unroll
    for (int n = 0; n < NTQ; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dqp[n][e] = 0.f;
    const int mi = lane >> 3;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t af[4];
      ldsm_x4<true>(af, dSt + (16 * kk + (mi >> 1) * 8 + (lane & 7)) * S::LDS +
                            16 * rw + (mi & 1) * 8);
#pragma unroll
      for (int nd = 0; nd < NTQ / 2; ++nd) {
        uint32_t bf[4];
        ldsm_x4<true>(bf, Ks + (16 * kk + (mi & 1) * 8 + (lane & 7)) * LD +
                              c0 + 16 * nd + (mi >> 1) * 8);
        mma16816<T>(dqp[2 * nd], af, bf[0], bf[1]);
        mma16816<T>(dqp[2 * nd + 1], af, bf[2], bf[3]);
      }
    }
    float* prow = part + (size_t(j) * G + g) * T_len * d + size_t(q0) * d;
#pragma unroll
    for (int n = 0; n < NTQ; ++n) {
      const int c = c0 + 8 * n + 2 * tq;
      if (c < d)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<float2*>(
              prow + size_t(16 * rw + gq + 8 * h) * d + c) =
              make_float2(dqp[n][2 * h], dqp[n][2 * h + 1]);
    }
  }

  // One ticket per query tile this block visited, after one fence for all
  // its partials; the block that takes the last ticket of tile i sums the
  // partials of tile i in ascending kv tile and writes dQ.
  __threadfence();
  __syncthreads();
  const size_t tile = size_t(kKv) * d, stride = size_t(G) * T_len * d;
  for (int c0 = i0; c0 < nq; c0 += NTH) {
    const int i = c0 + tid;
    if (i < nq) {
      const int jlast = a.causal ? i / SUB : nkb - 1;
      last[tid] = atomicAdd(cnt + size_t(g) * nq + i, 1) == jlast;
    }
    __syncthreads();
    for (int i = c0; i < min(nq, c0 + NTH); ++i) {
      if (!last[i - c0]) continue;
      __threadfence();
      const int jlast = a.causal ? i / SUB : nkb - 1;
      const float* src = part + base + size_t(i) * tile;
      T* dq = static_cast<T*>(a.dq) + base + size_t(i) * tile;
      for (size_t e = size_t(tid) * 4; e < tile; e += NTH * 4) {
        float4 s4 = __ldcg(reinterpret_cast<const float4*>(src + e));
        for (int jj = 1; jj <= jlast; ++jj) {
          const float4 x =
              __ldcg(reinterpret_cast<const float4*>(src + jj * stride + e));
          s4.x += x.x, s4.y += x.y, s4.z += x.z, s4.w += x.w;
        }
        uint2 w;
        w.x = pack2<T>(s4.x, s4.y);
        w.y = pack2<T>(s4.z, s4.w);
        *reinterpret_cast<uint2*>(dq + e) = w;
      }
      if (tid == 0) cnt[size_t(g) * nq + i] = 0;  // ready for the next call
    }
    __syncthreads();  // `last` is rewritten by the next chunk
  }
  store_dkv<T, NC>(a, base + size_t(k0) * d, key0, col0, dk, dv);
}

// ------------------------------------------- bf16/fp16 dkv (mma.sync)

// The fused backward without dQ: the same warps and dK/dV loop, and no dS^T
// store, dQ product, partials, fence or tickets (no scratch); launched
// with 4 16-key groups (64 keys) a block.  The ring waits for query tile
// i, then (one barrier: every warp is done with tile i - 1) loads tile
// i + 1 into the other stage.
template <typename T, int DP, int KW>
__global__ void __launch_bounds__(32 * KW * col_split(DP),
                                  KW == 4 && DP == 64 ? 3 : 1)
    stream_dkv_mma_kernel(Args a) {
  using S = BwdMmaSmem<DP, KW, false>;
  constexpr int NC = DP / col_split(DP);
  constexpr int LD = S::LD, BK = S::BK, NTH = 32 * S::NW;
  constexpr int SUB = KW / 4;  // 64-key tiles per block
  extern __shared__ __align__(128) unsigned char smem[];
  T* Ks = reinterpret_cast<T*>(smem + S::K);
  T* Vs = reinterpret_cast<T*>(smem + S::V);
  float* mk = reinterpret_cast<float*>(smem + S::MK);
  const int T_len = a.T, d = a.d;
  const int nq = T_len / kKv, nkb = T_len / BK;
  const int g = blockIdx.x / nkb, j = blockIdx.x % nkb, k0 = j * BK;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // this warp's 16 keys (group kw) and its dK/dV columns from col0
  const int kw = warp % KW, col0 = (warp / KW) * NC;
  const int sub = j * SUB + kw / 4;  // its 64-key tile
  const size_t base = size_t(g) * T_len * d, rbase = size_t(g) * T_len;
  const T* q = static_cast<const T*>(a.q) + base;
  const T* dout = static_cast<const T*>(a.dout) + base;

  auto stage = [&](int s) { return smem + S::ST + s * S::STAGE; };
  auto load_q_tile = [&](int i, int s) {
    unsigned char* st = stage(s);
    load_rows<T, DP>(reinterpret_cast<T*>(st), q, i * kKv, kKv, d, NTH);
    load_rows<T, DP>(reinterpret_cast<T*>(st + S::QT), dout, i * kKv, kKv, d,
                     NTH);
    load_row_vec(reinterpret_cast<float*>(st + 2 * S::QT),
                 a.lse_in + rbase + i * kKv, kKv);
    load_row_vec(reinterpret_cast<float*>(st + 2 * S::QT + kKv * 4),
                 a.delta + rbase + i * kKv, kKv);
  };
  load_rows<T, DP>(Ks, static_cast<const T*>(a.k) + base, k0, BK, d, NTH);
  load_rows<T, DP>(Vs, static_cast<const T*>(a.v) + base, k0, BK, d, NTH);
  load_row_vec(mk, a.mask + rbase + k0, BK);
  const int i0 = a.causal ? j * SUB : 0;
  load_q_tile(i0, 0);
  cp_async_commit();

  float dk[NC / 8][4], dv[NC / 8][4];
#pragma unroll
  for (int n = 0; n < NC / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;
  const int key0 = 16 * kw + (lane >> 2);

  for (int i = i0, it = 0; i < nq; ++i, ++it) {
    cp_async_wait<0>();
    __syncthreads();
    if (i + 1 < nq) load_q_tile(i + 1, (it + 1) & 1);
    cp_async_commit();
    const unsigned char* st = stage(it & 1);
    const float* lse_s = reinterpret_cast<const float*>(st + 2 * S::QT);
    uint32_t fa[4][4];
    kv_tile_step<T, DP, NC>(dk, dv, fa, Ks + 16 * kw * LD, Vs + 16 * kw * LD,
                            reinterpret_cast<const T*>(st),
                            reinterpret_cast<const T*>(st + S::QT), lse_s,
                            lse_s + kKv, mk, key0, k0, i * kKv, col0,
                            a.causal && sub > i, a);
  }
  store_dkv<T, NC>(a, base + size_t(k0) * d, key0, col0, dk, dv);
}

// ---------------------------------------------- bf16/fp16 dq (wgmma)

// dq's block: WG warpgroups of 64 query rows, two up to DP 128 and one at
// DP 256 (two would need 262,656 bytes).  Its shared memory: q and dO
// (ROWS rows each) and two stages of K, V (64 rows each) and the 64 mask
// entries, in the forward's core-matrix layout.
template <int DP>
struct DqSmem {
  static constexpr int WG = DP > 128 ? 1 : 2;
  static constexpr int ROWS = 64 * WG, THREADS = 128 * WG;
  static constexpr int RB = DP * 16;                 // bytes per 8-row group
  static constexpr int TILE = kKv * DP * 2;          // one 64-row tile
  static constexpr int STAGE = 2 * TILE + kKv * 4;   // K, V, mask
  static constexpr int Q = WG * TILE, DO = WG * TILE;
  static constexpr size_t bytes = size_t(Q) + DO + 2 * STAGE;
};

// The forward's twin: one block per (g, ROWS query rows), a warpgroup per
// 64 rows.  Per 64-key tile, S = q.k^T and dP = dO.v^T (wgmma, one commit
// group), p and dS on the accumulator registers, and dQ += dS.k with dS
// packed as the register A operand (k read MN-major, as the forward reads
// V).  Both warpgroups run every tile of the block, so no wgmma sits in a
// branch; a tile wholly after a warpgroup's rows gives p = 0 under causal
// (the Pallas skip).  Rows past T load as zeros with lse = delta = 0 and
// give dS = 0; they are not stored.
template <typename T, int DP>
__global__ void __launch_bounds__(DqSmem<DP>::THREADS, DP == 64 ? 2 : 1)
    stream_dq_wg_kernel(Args a) {
  using S = DqSmem<DP>;
  constexpr int RB = S::RB, NH = DP / 64;  // 64-column chunks of dQ
  constexpr int NTH = S::THREADS;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* Qs = smem;
  unsigned char* dOs = smem + S::Q;
  unsigned char* stages = dOs + S::DO;
  const int T_len = a.T, d = a.d;
  const int nqb = (T_len + S::ROWS - 1) / S::ROWS;
  const int g = blockIdx.x / nqb, q0 = (blockIdx.x % nqb) * S::ROWS;
  const int tid = threadIdx.x, wg = tid >> 7;
  const int warp = (tid >> 5) & 3, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const size_t base = size_t(g) * T_len * d, rbase = size_t(g) * T_len;
  const T* k = static_cast<const T*>(a.k) + base;
  const T* v = static_cast<const T*>(a.v) + base;
  const float* mask = a.mask + rbase;
  const int nk = T_len / kKv;
  const int my_tile = q0 / kKv + wg;  // this warpgroup's 64-row query tile
  const int jend = a.causal ? min(nk, q0 / kKv + S::WG) : nk;

  auto load_kv = [&](int j, int s) {
    unsigned char* st = stages + s * S::STAGE;
    load_cm<T, DP>(st, k, j * kKv, kKv, T_len, d, NTH);
    load_cm<T, DP>(st + S::TILE, v, j * kKv, kKv, T_len, d, NTH);
    if (tid < kKv / 4)
      cp_async16(st + 2 * S::TILE + tid * 16, mask + j * kKv + tid * 4, true);
  };
  load_cm<T, DP>(Qs, static_cast<const T*>(a.q) + base, q0, S::ROWS, T_len,
                 d, NTH);
  load_cm<T, DP>(dOs, static_cast<const T*>(a.dout) + base, q0, S::ROWS,
                 T_len, d, NTH);
  load_kv(0, 0);
  cp_async_commit();

  // this thread's rows row0 and row0 + 8: p of a masked key is the row's
  // constant exp(-1e9 - lse) (1 in a fully masked row, else 0); an
  // unmasked key's is exp2(s scale log2e - lse log2e)
  const int row0 = my_tile * kKv + 16 * warp + gq;
  const float sl = a.scale * kLog2e;
  float nl2[2], pm[2], dl[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row0 + 8 * h;
    const float lse = r < T_len ? a.lse_in[rbase + r] : 0.f;
    dl[h] = r < T_len ? a.delta[rbase + r] : 0.f;
    nl2[h] = -lse * kLog2e;
    pm[h] = exp2f((kMasked - lse) * kLog2e);
  }
  float dq[NH][32];
#pragma unroll
  for (int h = 0; h < NH; ++h)
#pragma unroll
    for (int e = 0; e < 32; ++e) dq[h][e] = 0.f;
  const uint64_t qdesc = gmma_desc(Qs + wg * 8 * RB, 128, RB);
  const uint64_t odesc = gmma_desc(dOs + wg * 8 * RB, 128, RB);

  for (int j = 0; j < jend; ++j) {
    cp_async_wait<0>();  // q, dO and tile j have landed
    fence_proxy_async();
    __syncthreads();     // ... for every thread; tile j - 1 is done with
    if (j + 1 < jend) load_kv(j + 1, (j + 1) & 1);
    cp_async_commit();
    const unsigned char* Ks = stages + (j & 1) * S::STAGE;
    const unsigned char* Vs = Ks + S::TILE;
    const float* mk = reinterpret_cast<const float*>(Ks + 2 * S::TILE);
    const int k0 = j * kKv;
    float s[32] = {}, dp[32] = {};  // overwritten: the first slice does not add
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      wgmma_ss<T>(s, qdesc + ((kk * 256) >> 4),
                  gmma_desc(Ks + kk * 256, 128, RB), kk > 0);
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      wgmma_ss<T>(dp, odesc + ((kk * 256) >> 4),
                  gmma_desc(Vs + kk * 256, 128, RB), kk > 0);
    wgmma_commit();
    // the tile's key mask as bits (key 2 tq + c at bit c of keep[c >> 5])
    // while the products run
    const uint32_t keep[2] = {
        __ballot_sync(0xffffffffu, mk[lane] != 0.f) >> (2 * tq),
        __ballot_sync(0xffffffffu, mk[32 + lane] != 0.f) >> (2 * tq)};
    wgmma_wait0();
    reg_fence(s);
    reg_fence(dp);
    const bool skip = a.causal && j > my_tile;
    // causal: key k0 + 8 n + 2 tq + e1 lies after row row0 + 8 h
    const int rc[2] = {row0 - k0 - 2 * tq, row0 + 8 - k0 - 2 * tq};
    // s[4n + e] is row row0 + 8 (e >> 1), key k0 + 8n + 2tq + (e & 1)
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int n = i >> 2, e1 = i & 1, h = (i >> 1) & 1;
      bool masked = !(keep[n >> 2] & (1u << (8 * (n & 3) + e1)));
      if (a.causal && 8 * n + e1 > rc[h]) masked = true;
      float p = masked ? pm[h] : exp2f(fmaf(s[i], sl, nl2[h]));
      if (skip) p = 0.f;
      s[i] = p * (dp[i] - dl[h]) * a.scale;  // dS
    }
    uint32_t da[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        da[kk][r] = pack2<T>(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
#pragma unroll
    for (int h = 0; h < NH; ++h) reg_fence(dq[h]);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) reg_fence(da[kk]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int h = 0; h < NH; ++h)
        wgmma_rs_t<T>(dq[h], da[kk],
                      gmma_desc(Ks + kk * 2 * RB + h * 1024, RB, 128));
    wgmma_commit();
    wgmma_wait0();
#pragma unroll
    for (int h = 0; h < NH; ++h) reg_fence(dq[h]);
  }

  // dQ packed into this warpgroup's own q rows (only its products read
  // them, and they are done), then 16-byte stores of whole rows
  unsigned char* Qw = Qs + wg * 8 * RB;
  const int rl = 16 * warp + gq;
#pragma unroll
  for (int h = 0; h < NH; ++h)
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = rl + 8 * hh;
        *reinterpret_cast<uint32_t*>(Qw + (r >> 3) * RB + (8 * h + n) * 128 +
                                     (r & 7) * 16 + 4 * tq) =
            pack2<T>(dq[h][4 * n + 2 * hh], dq[h][4 * n + 2 * hh + 1]);
      }
  wg_barrier(1 + wg);
  constexpr int CPR = DP / 8;
  T* out = static_cast<T*>(a.dq) + base + size_t(my_tile) * kKv * d;
  for (int e = tid & 127; e < kKv * CPR; e += 128) {
    const int r = (e / (8 * CPR)) * 8 + (e & 7), c = (e >> 3) % CPR;
    if (my_tile * kKv + r < T_len && c * 8 < d)
      *reinterpret_cast<uint4*>(out + size_t(r) * d + c * 8) =
          *reinterpret_cast<const uint4*>(Qw + (r >> 3) * RB + c * 128 +
                                          (r & 7) * 16);
  }
}

// ------------------------------------------------------------------ launch

enum Which { kFwd = 0, kBwdFused = 1, kDkv = 2, kDq = 3 };

// the fused backward (DQ; bwd_warps(T, d) 16-key groups a block) or dkv
// (4 groups, 64-key blocks, at every shape); col_split(DP) warps a group
template <typename T, int DP, bool DQ>
int run_bwd(const Args& a, cudaStream_t stream) {
  if constexpr (DQ && DP == 64)
    if (bwd_warps(a.T, a.d) == 8)
      return launch_once<stream_bwd_mma_kernel<T, DP, 8>>(
          dim3(a.G * (a.T / 128)), 256, BwdMmaSmem<DP, 8, true>::bytes, a,
          stream);
  using S = BwdMmaSmem<DP, 4, DQ>;
  constexpr auto kernel = DQ ? stream_bwd_mma_kernel<T, DP, 4>
                             : stream_dkv_mma_kernel<T, DP, 4>;
  return launch_once<kernel>(dim3(a.G * (a.T / 64)), 32 * S::NW, S::bytes,
                             a, stream);
}

// the fp32 route: the first kernels, 32-row tiles; at DP 256 the fused
// backward's and dkv's are 16 rows (at 32 the fused backward would take
// 251,776 bytes of shared memory, and dkv spills in ptxas)
template <int DP>
int run_f32(int which, const Args& a, cudaStream_t stream) {
  constexpr int B = 32, BB = DP > 128 ? 16 : B;
  using Lt = Layout<float, DP, B>;
  if (a.T % B != 0) return int(cudaErrorInvalidValue);
  const dim3 tiles(a.G, a.T / B);
  switch (which) {
    case kFwd:
      return launch_once<stream_fwd_kernel<float, DP, B>>(tiles, kThreads,
                                                          Lt::fwd, a, stream);
    case kBwdFused:
      return launch_once<stream_bwd_fused_kernel<float, DP, BB>>(
          dim3(a.G), kThreadsFused, Layout<float, DP, BB>::bwd3, a, stream);
    case kDkv:
      return launch_once<stream_dkv_kernel<float, DP, BB>>(
          dim3(a.G, a.T / BB), kThreads, Layout<float, DP, BB>::bwd2, a,
          stream);
    case kDq:
      return launch_once<stream_dq_kernel<float, DP, B>>(tiles, kThreads,
                                                         Lt::bwd2, a, stream);
  }
  return int(cudaErrorInvalidValue);
}

// bf16/fp16: the Hopper kernels, each with its own grid; T a multiple of
// the 64-row tile of the Pallas grid's causal skip
template <typename T, int DP>
int run(int which, const Args& a, cudaStream_t stream) {
  if constexpr (std::is_same<T, float>::value) {
    return run_f32<DP>(which, a, stream);
  } else {
    if (a.T % 64 != 0) return int(cudaErrorInvalidValue);
    switch (which) {
      case kFwd:
        return launch_once<stream_fwd_wg_kernel<T, DP>>(
            dim3(a.G * ((a.T + kFwdRows - 1) / kFwdRows)), kFwdThreads,
            FwdSmem<DP>::bytes, a, stream);
      case kBwdFused:
        return run_bwd<T, DP, true>(a, stream);
      case kDkv:
        return run_bwd<T, DP, false>(a, stream);
      case kDq: {
        using S = DqSmem<DP>;
        return launch_once<stream_dq_wg_kernel<T, DP>>(
            dim3(a.G * ((a.T + S::ROWS - 1) / S::ROWS)), S::THREADS, S::bytes,
            a, stream);
      }
    }
    return int(cudaErrorInvalidValue);
  }
}

template <typename T>
int run_dp(int which, const Args& a, cudaStream_t stream) {
  if (a.d <= 64) return run<T, 64>(which, a, stream);
  if (a.d <= 128) return run<T, 128>(which, a, stream);
  if (a.d <= 256) return run<T, 256>(which, a, stream);
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
// mask, lse, delta are fp32 [G, T]; dq_acc is the fused backward's
// scratch of dstt_stream_bwd_fused_scratch() 4-byte words (its counters
// zero before the first call; the kernel leaves them zero).
// `stream` is a cudaStream_t.  Each function returns cudaGetLastError()
// after its launch (0 = cudaSuccess), or cudaErrorInvalidValue for a shape
// it does not take (d not a multiple of 8 or above 256, T not a multiple
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

// 4-byte words of the fused backward's scratch: fp32 [G, T, d] for fp32;
// for bf16/fp16 one int counter per (g, 64-row query tile), padded to a
// multiple of 4, which must be zero before the call (the kernel leaves
// them zero), then the fp32 partials [T / BK, G, T, d] (BK = 16
// bwd_warps(T, d) keys per block).  *counters
// receives the counters' words (0 for fp32).
extern "C" long long dstt_stream_bwd_fused_scratch(int dtype, int G, int T,
                                                   int d,
                                                   long long* counters) {
  const long long gtd = (long long)G * T * d;
  *counters = dtype == 0 ? 0 : counter_words(G, T);
  return dtype == 0 ? gtd : *counters + (T / (16 * bwd_warps(T, d))) * gtd;
}

extern "C" const char* dstt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
