// Whole-tile attention for Hopper (sm_90a): the forward and backward kernels
// for every shape the JAX whole-tile gate takes up to head dim 128 (T a
// multiple of 8 up to 512), on q, k, v in the public [B, T, n, d] layout
// read through their strides (the views of the packed qkv projection need
// no copy), with a plain C interface loaded through ctypes
// (deepspeed_tpu_torch/ops/block_attention.py builds this file with nvcc at
// first use and holds each kernel's plain PyTorch version beside it).
//
// What each kernel replaces (deepspeed_tpu/ops/pallas_attention.py), by
// route (dispatch):
//   route 0, T a multiple of 16 in [16, 128]:
//     block_fwd_wg_kernel  <- _fwd_kernel  (:106, pallas_call :180)  bf16/fp16
//     block_bwd_wg_kernel  <- _bwd_kernel  (:122, pallas_call :200)  bf16/fp16
//       (d <= 128, padded to DP = 64 or 128)
//     block_fwd_kernel     <- _fwd_kernel  fp32 (d <= 64)
//     block_bwd_kernel     <- _bwd_kernel  fp32 (d <= 64)
//   route 1 (the wide route), every other shape up to T 512 and d 128: T
//   past 128 or not a multiple of 16, and fp32 past d 64 (its own note,
//   below the route-0 kernels):
//     block_fwd_wide_kernel                          <- _fwd_kernel
//     block_bwd_wide_dq_kernel + block_bwd_wide_dkv_kernel <- _bwd_kernel
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
// fp32.
//
// The causal skip, and why it is exact.  A row qi with an unmasked key at
// or before it has a real row max, so every key after it scores -1e9 and
// gets p = exp(-1e9 - max) = 0.0 exactly in fp32: its p, p.V and dS are
// exact zeros.  With f the first unmasked key of the batch row, every row
// of a 64-row query block starting at r0 has one iff f <= r0.  T <= 128
// leaves one block with key blocks after it, the first (r0 = 0): the
// bf16/fp16 kernels skip its second key block iff key 0 is unmasked (at
// T = 128 one of the four 64 x 64 block pairs).  Otherwise its first rows
// are uniform over all T keys and it takes the whole row.  The fp32 route
// computes the whole [T, T] tile, as the TPU kernels do.
//
// Bound.  At GPT-2 medium, seq 128, micro-batch 32 (B*n = 512 heads,
// T = 128, d = 64, bf16) one T^2 d product pass over all heads is 1.07
// GFLOP and each [B, T, n, d] operand 8.39 MB.  The forward (2 passes, q, k,
// v read and o written: 33.6 MB) is bound by bytes, 10.0 us at 3.35 TB/s
// against 2.2 us of bf16 tensor work at 989 TFLOP/s; the backward (5 passes,
// 7 operands: 58.7 MB) by bytes too, 17.5 us against 5.4 us.
//
// Design of the bf16/fp16 kernels (the train path).  Both are bound by
// bytes, so the aim is to keep the loads streaming and nothing but the
// operands in shared memory:
//   * One block per (b, head) with NB = ceil(T / 64) warpgroups (128
//     threads each, one per 64 query rows), so K and V are loaded once per
//     head.  The kernels are instantiated per NB (1 or 2) and padded head
//     dim DP (64, or 128 for d in (64, 128]), so every loop over key
//     blocks, query slices, k16 slices and column chunks has a constant
//     count and no wgmma sits in a divergent branch (ptxas serialises
//     those); the skipping warpgroup runs the instantiation for one key
//     block.  The head dim is zero-padded to DP in shared memory (loads
//     and stores stop at d, so device bytes follow d); rows past T are
//     zero-filled and never stored.
//   * q, k, v (and dO) arrive by 16-byte cp.async straight into the
//     no-swizzle core-matrix layout the wgmma descriptors read (8-row
//     groups of 1 KB, each 8 core matrices of 8 rows x 16 bytes), in two
//     commit groups: q, k first, so S is computed while v (and dO) land.
//     The key mask is read into registers beside them and kept as ballot
//     bits, one 32-bit word per 32 keys.
//   * S = q.k^T is wgmma m64n64k16 per 64-key block, q and k from shared
//     memory, into registers.  The softmax is the exact two-pass one on
//     the accumulator registers: a row's T <= 128 scores sit in the 4 lanes
//     of a quad, so its max and its sum are two shuffles each.  It runs in
//     log2 units (exp2 of the scaled difference, the -1e9 fill scaled the
//     same) and multiplies by the row's reciprocal sum (within an ulp of
//     the division); each mask test is a compare against a constant or a
//     constant bit.  Measured on an H100 against variants of this file
//     (PERF.md), each of these was slower: mask reads from shared
//     memory with expf and a division per score (by the most), wgmma in
//     divergent branches, no causal skip, more forward blocks per SM
//     (spills), a forward block per 64 query rows, and a persistent
//     forward that loads the next head while it computes this one.
//   * Forward: p packed pairwise to the input type IS the register A
//     operand of O = p.V (wgmma, V read MN-major through the transpose
//     bit).  O goes to the input type, is staged through the warpgroup's
//     own q rows in shared memory, and leaves in 16-byte stores (8
//     threads per column chunk of 8 rows: whole 32-byte sectors).  48 KB
//     of shared memory and 94 registers a thread at T = 128: two blocks of
//     256 threads per SM (three spill).
//   * Backward: S and dP = dO.V^T into registers, p and t by quad
//     shuffles, dS = p (dP - t) cast; dQ = dS.K with dS as the register A
//     operand, times `scale`, held packed in registers to the end.  p and
//     dS go to shared memory once, in the input type, as [query][key]
//     tiles (a skipped block pair as zeros); after one barrier each
//     warpgroup takes 64 keys and sums dV = p^T dO and dK = dS^T q over
//     all query rows with wgmma reading A and B through the transpose bit,
//     in ascending query order (bitwise repeatable, no atomics).  dQ, dK,
//     dV are staged through the q, k, v tiles and stored as in the
//     forward.  128 KB of shared memory at T = 128 (q, k, v, dO 64 KB; p
//     and dS 64 KB) and 152 registers a thread (S and dP of a warpgroup's
//     rows alone are 128), so one block of 256 threads per SM.  p and dS
//     keep a buffer each: the registers already allow one block per SM,
//     so reusing one buffer for both would add a barrier and no block;
//     a persistent backward that loads the next head into the remaining
//     shared memory while it computes this one measured no faster.
//   * No product goes through shared memory: S, dP, O and the dK/dV
//     accumulators stay in registers.
//   * DP 128 (GPT-2 large's d 96, the 8b preset's 128), on the one
//     m64n64k16 product: S and dP sum 8 k16 slices instead of 4; O, dQ,
//     dK and dV are two 64-column chunks.  The forward takes O one chunk
//     at a time (32 accumulators live, p packed held across both), so it
//     keeps route 0's two blocks of 256 threads per SM: 96 KB of shared
//     memory and 122 registers at T = 128 (ptxas, no spills).  The
//     backward keeps both chunks of dK and dV in flight (128
//     accumulators) beside dQ's packed chunks, which fit: 182 registers
//     at T = 128 (218 at T <= 64), no spills, 192 KB of shared memory,
//     one block per SM as at DP 64.  On an H100 at GPT-2 large's shape
//     (B 32, n 16, T 128, d 96) the forward reads 0.035 ms against the
//     wide route's 0.065 and the backward 0.071 against its 0.176, on the
//     same inputs (PERF.md); padding 96 to 128 costs a third more tensor
//     work, which bytes bound.
//   * Each instantiation sets its dynamic shared-memory limit once
//     (launch_once); its shared memory does not depend on T.

// The fp32 route is the first, simple design, kept for the fp32 parity
// runs: one block per (b, head, 32 query rows) forward and per (b, head)
// backward (query tiles of 16), the head dim padded to 32 or 64, plain
// fp32 FMAs (never TF32) through fp32 score tiles in shared memory, one
// warp per row for the softmax, dK and dV summed in fp32 shared memory.

#include "attention_common.cuh"
#include "sm90_tile.cuh"

namespace {

constexpr int kMaxT = 128;  // a score row is held 4 values per lane
constexpr int kFwdThreads = 256;
constexpr int kBwdThreads = 512;
constexpr float kNegInf = -3.0e38f;

struct Args {
  const void *q, *k, *v, *dout;  // dout: contiguous [B, T, n, d]
  const float* mask;             // [B, T], 1 = attend
  void *o, *dq, *dk, *dv;        // contiguous [B, T, n, d]
  float* stats;  // the wide backward's row max, sum and t: fp32 [3, B, n, T]
  long long sB, sT, sH;          // element strides of q, k and v
  int B, n, T, d, causal;
  float scale;
};

// Shared-memory layouts for a runtime T: the same on the host (launch size)
// and on the device (carving).  Row strides carry a 16-byte pad and stay
// multiples of 16 bytes, as the 16-byte tile loads need.  The fp32 score tile is reused
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

// ---------------------------------------- bf16/fp16 forward and backward

constexpr int kWgMaxD = 128;  // route 0's widest padded head dim
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory of the wgmma kernels for NB blocks of 64 rows (R = 64 NB
// >= T) and the head dim padded to DP (64 or 128): operand tiles of R rows
// (q, k, v, dO) in the core-matrix layout (8-row groups of RB = 16 DP
// bytes, 8-column chunks of 128) and the backward's p and dS as [R
// queries][R keys] tiles in the same layout (8-query groups of R * 16
// bytes, 8-key chunks of 128).  A 64-column chunk of a tile starts 1,024
// bytes after the one before it.
template <int NB, int DP>
struct WgLayout {
  static constexpr int R = 64 * NB, RB = DP * 16;
  static constexpr size_t tile = size_t(R) * DP * 2, pt = size_t(R) * R * 2;
  static constexpr size_t fwd = 3 * tile;           // q, k, v
  static constexpr size_t bwd = 4 * tile + 2 * pt;  // q, k, v, dO; p, dS
};

// byte offset of row r, 8-column chunk c in an operand tile of DP columns
template <int DP>
__device__ __forceinline__ int cm_off(int r, int c) {
  return (r >> 3) * (DP * 16) + c * 128 + (r & 7) * 16;
}

// `rows` rows of d elements (row r at src + r * ld, 16-byte aligned) into
// an R-row operand tile of DP columns by 16-byte cp.async; columns past d
// and rows past `rows` are zero-filled.  Eight consecutive threads take
// one column chunk of eight rows, so a warp fills whole 32-byte sectors of
// each row.
template <typename T, int DP>
__device__ __forceinline__ void load_tile_cm(unsigned char* dst, const T* src,
                                             size_t ld, int rows, int R,
                                             int d) {
  constexpr int C = DP / 8;  // 16-byte column chunks a row
  for (int e = threadIdx.x; e < R * C; e += blockDim.x) {
    const int r = e / (8 * C) * 8 + (e & 7), c = (e >> 3) % C;
    const bool ok = r < rows && c * 8 < d;
    cp_async16(dst + cm_off<DP>(r, c), ok ? src + r * ld + c * 8 : src, ok);
  }
}

// Batch row b's key mask as bits, for every warp: lane l loads keys
// 32 u + l (u < 2 NB) ahead of the tile loads' wait, then bit i of
// keep[u] is set for key 32 u + i when it is below T and unmasked.
template <int NB>
struct KeyBits {
  float m[2 * NB];
  __device__ __forceinline__ KeyBits(const Args& a, int b) {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int u = 0; u < 2 * NB; ++u) {
      const int c = 32 * u + lane;
      m[u] = c < a.T ? a.mask[size_t(b) * a.T + c] : 0.f;
    }
  }
  __device__ __forceinline__ void bits(uint32_t (&keep)[2 * NB]) const {
#pragma unroll
    for (int u = 0; u < 2 * NB; ++u)
      keep[u] = __ballot_sync(0xffffffffu, m[u] != 0.f);
  }
};

// Under causal, the first 64-row block may skip the key blocks after it
// when key 0 is unmasked: every row then has an unmasked key at or before
// it (the exact skip of the header).  Blocks further down have no key
// block after them (T <= 128).
__device__ __forceinline__ bool skips(const Args& a, uint32_t keep0) {
  return a.causal && (keep0 & 1u);
}

// S = q.k^T (or dP = dO.v^T) of a warpgroup's 64 rows at `A` over key
// blocks 0..NKB-1 of `B`: s[j] holds the 64 keys from 64 j, summed over
// the DP / 16 k16 slices of the head dim.  Both operands K-major.
template <typename T, int NKB, int DP>
__device__ __forceinline__ void scores(float (&s)[NKB][32],
                                       const unsigned char* A,
                                       const unsigned char* B) {
  constexpr int RB = DP * 16;
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < NKB; ++j)
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      wgmma_ss<T>(s[j], gmma_desc(A + kk * 256, 128, RB),
                  gmma_desc(B + j * 8 * RB + kk * 256, 128, RB), kk > 0);
  wgmma_commit();
  wgmma_wait0();
#pragma unroll
  for (int j = 0; j < NKB; ++j) reg_fence(s[j]);
}

// acc += A . B over the NKB * 64 columns of the packed register operand
// `w` (a row block of p or dS), B the matching key rows of `Bs` read
// MN-major (v for O = p.v, k for dQ = dS.k), 64 of its columns: `Bs`
// points at the chunk.
template <typename T, int NKB, int DP>
__device__ __forceinline__ void rows_times_keys(float (&acc)[32],
                                                uint32_t (&w)[NKB][4][4],
                                                const unsigned char* Bs) {
  constexpr int RB = DP * 16;
  reg_fence(acc);
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < NKB; ++j)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs_t<T>(acc, w[j][kk],
                    gmma_desc(Bs + (4 * j + kk) * 2 * RB, RB, 128));
  wgmma_commit();
  wgmma_wait0();
  reg_fence(acc);
}

// The exact softmax of a warpgroup's 64 score rows, in place on the
// accumulators: s[j][4n + e] is row `row0 + 8 (e >> 1)`, key
// 64 j + 8 n + 2 tq + (e & 1).  Keys past T take no part (p = 0); key
// blocks from NKB on are not held (p = 0 exactly: the causal skip).  The
// masks come from the key bits and per-thread limits, so each score costs
// compares against constants; exp(x - max) is exp2 of the scaled
// difference, and p = e * (1 / sum), within an ulp of e / sum.
template <int NKB, int NB>
__device__ __forceinline__ void softmax_regs(float (&s)[NKB][32],
                                             const uint32_t (&keep)[2 * NB],
                                             int row0, const Args& a) {
  const int tq = threadIdx.x & 3;
  const int lim = a.T - 2 * tq;             // key c < T: c - 2 tq < lim
  const int rc[2] = {row0 - 2 * tq, row0 + 8 - 2 * tq};  // causal: c > row
  uint32_t kt[2 * NKB];
#pragma unroll
  for (int u = 0; u < 2 * NKB; ++u) kt[u] = keep[u] >> (2 * tq);
  const float sl = a.scale * kLog2e;  // scores in log2 units
  const float masked = kMasked * kLog2e;
  float mx[2] = {kNegInf, kNegInf}, sum[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < NKB; ++j)
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int n = i >> 2, e1 = i & 1, h = (i >> 1) & 1;
      const int c0 = 64 * j + 8 * n + e1;  // the key less 2 tq
      float x = s[j][i] * sl;
      if (a.causal && c0 > rc[h]) x = masked;
      if (!(kt[2 * j + (n >> 2)] & (1u << (8 * (n & 3) + e1)))) x = masked;
      if (c0 >= lim) x = kNegInf;
      s[j][i] = x;
      mx[h] = fmaxf(mx[h], x);
    }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
  }
#pragma unroll
  for (int j = 0; j < NKB; ++j)
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      s[j][i] = exp2f(s[j][i] - mx[(i >> 1) & 1]);
      sum[(i >> 1) & 1] += s[j][i];
    }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
    sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
    sum[h] = 1.f / sum[h];
  }
#pragma unroll
  for (int j = 0; j < NKB; ++j)
#pragma unroll
    for (int i = 0; i < 32; ++i) s[j][i] *= sum[(i >> 1) & 1];
}

// An accumulator times `mul`, packed pairwise to T: w[kk][r] holds columns
// 16 kk + 8 (r >> 1) + 2 tq, +1 of the thread's row + 8 (r & 1), which is
// also the register A operand of a product over those columns (k16 slice
// kk).
template <typename T>
__device__ __forceinline__ void pack_acc(uint32_t (&w)[4][4],
                                         const float (&acc)[32], float mul) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      w[kk][r] = pack2<T>(acc[8 * kk + 2 * r] * mul,
                          acc[8 * kk + 2 * r + 1] * mul);
}

// A warpgroup's packed 64 x 64 tile into the core-matrix layout at `dst`
// (its row 0 and first column; 8-row groups `rb` bytes apart).
__device__ __forceinline__ void stage_words(unsigned char* dst, int rb,
                                            const uint32_t (&w)[4][4]) {
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  const int row = 16 * warp + (lane >> 2), tq = lane & 3;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int rr = row + 8 * (r & 1), c = 2 * kk + (r >> 1);
      *reinterpret_cast<uint32_t*>(dst + (rr >> 3) * rb + c * 128 +
                                   (rr & 7) * 16 + tq * 4) = w[kk][r];
    }
}

// `rows` (<= 64) rows of a staged 64-row tile of DP columns to a
// contiguous [B, T, n, d] array (row stride ld), 16 bytes a thread over
// one warpgroup, as load_tile_cm reads.
template <typename T, int DP>
__device__ __forceinline__ void store_tile(T* dst, size_t ld,
                                           const unsigned char* src,
                                           int rows, int d) {
  constexpr int C = DP / 8;
  for (int e = threadIdx.x & 127; e < 64 * C; e += 128) {
    const int r = e / (8 * C) * 8 + (e & 7), c = (e >> 3) % C;
    if (r < rows && c * 8 < d)
      *reinterpret_cast<uint4*>(dst + r * ld + c * 8) =
          *reinterpret_cast<const uint4*>(src + cm_off<DP>(r, c));
  }
}

// The forward of one warpgroup's 64 query rows over NKB key blocks, after
// q and k have landed: S, the softmax, then (once v has landed) O = p.v
// one 64-column chunk at a time (32 accumulators live, whatever DP),
// each staged through the warpgroup's own q rows (only its products read
// them) and stored.
template <typename T, int NKB, int NB, int DP>
__device__ __forceinline__ void fwd_rows(const Args& a, unsigned char* Qw,
                                         const unsigned char* Ks,
                                         const unsigned char* Vs,
                                         const uint32_t (&keep)[2 * NB],
                                         int r0, T* out) {
  const int row0 =
      r0 + 16 * ((threadIdx.x >> 5) & 3) + ((threadIdx.x & 31) >> 2);
  float s[NKB][32] = {};
  scores<T, NKB, DP>(s, Qw, Ks);
  softmax_regs<NKB, NB>(s, keep, row0, a);
  uint32_t pa[NKB][4][4];
#pragma unroll
  for (int j = 0; j < NKB; ++j) pack_acc<T>(pa[j], s[j], 1.f);
  cp_async_wait<0>();  // v has landed
  fence_proxy_async();
  __syncthreads();
#pragma unroll
  for (int nc = 0; nc < DP / 64; ++nc) {
    float o[32] = {};
    rows_times_keys<T, NKB, DP>(o, pa, Vs + nc * 1024);
    uint32_t ow[4][4];
    pack_acc<T>(ow, o, 1.f);
    stage_words(Qw + nc * 1024, DP * 16, ow);
  }
  wg_barrier(1 + (threadIdx.x >> 7));
  store_tile<T, DP>(out, size_t(a.n) * a.d, Qw, min(64, a.T - r0), a.d);
}

template <typename T, int NB, int DP>
__global__ void __launch_bounds__(128 * NB, 2) block_fwd_wg_kernel(Args a) {
  using L = WgLayout<NB, DP>;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* Qs = smem;
  unsigned char* Ks = Qs + L::tile;
  unsigned char* Vs = Ks + L::tile;
  const int Tn = a.T, d = a.d;
  const int b = blockIdx.x / a.n, h = blockIdx.x % a.n;
  const size_t base = size_t(b) * a.sB + size_t(h) * a.sH;
  const size_t sT = size_t(a.sT);
  load_tile_cm<T, DP>(Qs, static_cast<const T*>(a.q) + base, sT, Tn, L::R,
                      d);
  load_tile_cm<T, DP>(Ks, static_cast<const T*>(a.k) + base, sT, Tn, L::R,
                      d);
  cp_async_commit();
  load_tile_cm<T, DP>(Vs, static_cast<const T*>(a.v) + base, sT, Tn, L::R,
                      d);
  cp_async_commit();
  const KeyBits<NB> mask(a, b);
  cp_async_wait<1>();  // q, k have landed
  fence_proxy_async();
  __syncthreads();
  uint32_t keep[2 * NB];
  mask.bits(keep);

  const int r0 = 64 * (threadIdx.x >> 7);
  unsigned char* Qw = Qs + r0 / 8 * L::RB;  // this warpgroup's q rows
  T* out = static_cast<T*>(a.o) + (size_t(b) * Tn + r0) * a.n * d +
           size_t(h) * d;
  if (NB > 1 && r0 == 0 && skips(a, keep[0]))
    fwd_rows<T, 1, NB, DP>(a, Qw, Ks, Vs, keep, r0, out);
  else
    fwd_rows<T, NB, NB, DP>(a, Qw, Ks, Vs, keep, r0, out);
}

// The backward's first half for one warpgroup's 64 query rows over NKB of
// NB key blocks, after q and k have landed: p and dS to shared memory (the
// skipped key blocks as zeros), and dQ = dS.k times scale, packed, one
// 64-column chunk at a time.
template <typename T, int NKB, int NB, int DP>
__device__ __forceinline__ void bwd_rows(const Args& a, int r0,
                                         const unsigned char* Qs,
                                         const unsigned char* Ks,
                                         const unsigned char* Vs,
                                         const unsigned char* dOs,
                                         unsigned char* Ps, unsigned char* dSs,
                                         const uint32_t (&keep)[2 * NB],
                                         uint32_t (&dqw)[DP / 64][4][4]) {
  constexpr int RB = DP * 16, RBp = WgLayout<NB, DP>::R * 16;
  const int row0 =
      r0 + 16 * ((threadIdx.x >> 5) & 3) + ((threadIdx.x & 31) >> 2);
  float s[NKB][32] = {}, dp[NKB][32] = {};
  scores<T, NKB, DP>(s, Qs + r0 / 8 * RB, Ks);
  softmax_regs<NKB, NB>(s, keep, row0, a);
  uint32_t w[NKB][4][4];
#pragma unroll
  for (int j = 0; j < NKB; ++j) {
    pack_acc<T>(w[j], s[j], 1.f);
    stage_words(Ps + r0 / 8 * RBp + j * 1024, RBp, w[j]);
  }
  const uint32_t zero[4][4] = {};
#pragma unroll
  for (int j = NKB; j < NB; ++j) {
    stage_words(Ps + r0 / 8 * RBp + j * 1024, RBp, zero);
    stage_words(dSs + r0 / 8 * RBp + j * 1024, RBp, zero);
  }

  cp_async_wait<0>();  // dO, v have landed
  fence_proxy_async();
  __syncthreads();
  scores<T, NKB, DP>(dp, dOs + r0 / 8 * RB, Vs);
  float t[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < NKB; ++j)
#pragma unroll
    for (int i = 0; i < 32; ++i) t[(i >> 1) & 1] += dp[j][i] * s[j][i];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    t[h] += __shfl_xor_sync(0xffffffffu, t[h], 1);
    t[h] += __shfl_xor_sync(0xffffffffu, t[h], 2);
  }
#pragma unroll
  for (int j = 0; j < NKB; ++j) {
#pragma unroll
    for (int i = 0; i < 32; ++i)
      dp[j][i] = s[j][i] * (dp[j][i] - t[(i >> 1) & 1]);
    pack_acc<T>(w[j], dp[j], 1.f);
    stage_words(dSs + r0 / 8 * RBp + j * 1024, RBp, w[j]);
  }
#pragma unroll
  for (int nc = 0; nc < DP / 64; ++nc) {
    float dq[32] = {};
    rows_times_keys<T, NKB, DP>(dq, w, Ks + nc * 1024);
    pack_acc<T>(dqw[nc], dq, a.scale);
  }
}

template <typename T, int NB, int DP>
__global__ void __launch_bounds__(128 * NB, 1) block_bwd_wg_kernel(Args a) {
  using L = WgLayout<NB, DP>;
  constexpr int RB = L::RB, RBp = L::R * 16, NC = DP / 64;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* Qs = smem;
  unsigned char* Ks = Qs + L::tile;
  unsigned char* Vs = Ks + L::tile;
  unsigned char* dOs = Vs + L::tile;
  unsigned char* Ps = dOs + L::tile;
  unsigned char* dSs = Ps + L::pt;
  const int Tn = a.T, d = a.d;
  const int b = blockIdx.x / a.n, h = blockIdx.x % a.n;
  const int wg = threadIdx.x >> 7, r0 = 64 * wg;
  const size_t base = size_t(b) * a.sB + size_t(h) * a.sH;
  const size_t sT = size_t(a.sT);
  const size_t ld_out = size_t(a.n) * d;
  const size_t obase = size_t(b) * Tn * ld_out + size_t(h) * d;
  load_tile_cm<T, DP>(Qs, static_cast<const T*>(a.q) + base, sT, Tn, L::R,
                      d);
  load_tile_cm<T, DP>(Ks, static_cast<const T*>(a.k) + base, sT, Tn, L::R,
                      d);
  cp_async_commit();
  load_tile_cm<T, DP>(dOs, static_cast<const T*>(a.dout) + obase, ld_out, Tn,
                      L::R, d);
  load_tile_cm<T, DP>(Vs, static_cast<const T*>(a.v) + base, sT, Tn, L::R,
                      d);
  cp_async_commit();
  const KeyBits<NB> mask(a, b);
  cp_async_wait<1>();  // q, k have landed
  fence_proxy_async();
  __syncthreads();
  uint32_t keep[2 * NB];
  mask.bits(keep);

  uint32_t dqw[NC][4][4];
  if (NB > 1 && r0 == 0 && skips(a, keep[0]))
    bwd_rows<T, 1, NB, DP>(a, r0, Qs, Ks, Vs, dOs, Ps, dSs, keep, dqw);
  else
    bwd_rows<T, NB, NB, DP>(a, r0, Qs, Ks, Vs, dOs, Ps, dSs, keep, dqw);
  fence_proxy_async();  // p, dS visible to every warpgroup's products
  __syncthreads();

  // this warpgroup's 64 keys: dV = p^T dO and dK = dS^T q over the query
  // rows in ascending 16-row slices (a skipped block pair adds zeros; the
  // rows past T have zero dO and dS), each 64-column chunk of the head
  // dim in its own accumulators
  float dv[NC][32] = {}, dk[NC][32] = {};
#pragma unroll
  for (int nc = 0; nc < NC; ++nc) {
    reg_fence(dv[nc]);
    reg_fence(dk[nc]);
  }
  wgmma_fence();
#pragma unroll
  for (int kq = 0; kq < L::R / 16; ++kq) {
    const int off = kq * 2 * RBp + wg * 1024;
#pragma unroll
    for (int nc = 0; nc < NC; ++nc) {
      wgmma_ss_tt<T>(dv[nc], gmma_desc(Ps + off, RBp, 128),
                     gmma_desc(dOs + kq * 2 * RB + nc * 1024, RB, 128));
      wgmma_ss_tt<T>(dk[nc], gmma_desc(dSs + off, RBp, 128),
                     gmma_desc(Qs + kq * 2 * RB + nc * 1024, RB, 128));
    }
  }
  wgmma_commit();
  wgmma_wait0();
#pragma unroll
  for (int nc = 0; nc < NC; ++nc) {
    reg_fence(dv[nc]);
    reg_fence(dk[nc]);
  }
  __syncthreads();  // every product has read q, k, v

  // dQ, dK, dV through this warpgroup's rows of the q, k, v tiles
  unsigned char* dqs = Qs + r0 / 8 * RB;
  unsigned char* dks = Ks + r0 / 8 * RB;
  unsigned char* dvs = Vs + r0 / 8 * RB;
#pragma unroll
  for (int nc = 0; nc < NC; ++nc) {
    uint32_t w[4][4];
    stage_words(dqs + nc * 1024, RB, dqw[nc]);
    pack_acc<T>(w, dk[nc], a.scale);
    stage_words(dks + nc * 1024, RB, w);
    pack_acc<T>(w, dv[nc], 1.f);
    stage_words(dvs + nc * 1024, RB, w);
  }
  wg_barrier(1 + wg);
  const int rows = min(64, Tn - r0);
  const size_t off = obase + size_t(r0) * ld_out;
  store_tile<T, DP>(static_cast<T*>(a.dq) + off, ld_out, dqs, rows, d);
  store_tile<T, DP>(static_cast<T*>(a.dk) + off, ld_out, dks, rows, d);
  store_tile<T, DP>(static_cast<T*>(a.dv) + off, ld_out, dvs, rows, d);
}

// ------------------------------------- the wide route (T <= 512, d <= 128)
//
// Every shape of the JAX gate that the routes above refuse: T a multiple of
// 8 from 8 to 512 and d a multiple of 8 up to 128, in all three types.  It
// computes what they compute (the contract at the top of this file), with
// whole fp32 score rows in shared memory and K, V streamed past them in
// tiles of 64 keys through a two-slot cp.async ring:
//   * block_fwd_wide_kernel: one block per (b, head, QB = 16 NW query
//     rows), NW warps of 16 rows.  Each warp forms its rows' scaled and
//     masked scores tile by tile, takes the exact softmax of each whole row
//     (max, exp, sum, divide), writes p in the input type over its own
//     score row, then O += p.V over the V tiles.
//   * block_bwd_wide_dq_kernel: the same blocks.  S and the softmax as in
//     the forward, p kept in fp32 and the rows' max and sum stored to a
//     scratch; dP = dO.V^T tile by tile for t = rowsum(dP * p) over the
//     whole row (stored too); then dP again for dS = p (dP - t), cast and
//     staged per warp, and dQ += dS.K.
//   * block_bwd_wide_dkv_kernel: one block per (b, head, 16 NW keys), each
//     warp 16 keys.  The query rows stream by 32 with their max, sum and
//     t; p and dS are recomputed transposed (k.q^T, v.dO^T) from them and
//     staged per warp, and dV += p^T dO, dK += dS^T q stay in registers.
//   Every output row is written by one block in a fixed order: no atomics,
//   bitwise repeatable.  The dkv kernel runs after the dq kernel on the
//   same stream (it reads the scratch).
// Products: mma.sync m16n8k16 from ldmatrix fragments for bf16/fp16 (fp32
// accumulators); for fp32 the same fragment elements by plain FMAs (never
// TF32).  d is zero-padded to DP (64, 96 or 128; fp32 64 or 128) and rows
// past T to the tiles in shared memory; nothing past a row is read.  The
// causal skip is the one of the header: with f the batch row's first
// unmasked key, a query block starting at r0 >= f takes no key after its
// last row (those p are exact zeros), and the dkv kernel skips the query
// rows r0 >= f that end before its first key.
// Shared memory at T 512, d 128 (the largest; it follows T): bf16 and fp16
// (QB 64): forward q 17,408 + ring 34,816 + score rows 64 x 516 x 4 =
// 132,096 + mask 2,176 = 186,496 bytes; dq kernel q and dO 34,816 + ring
// 34,816 + score rows 132,096 + dS staging 9,216 + mask 2,176 = 213,120;
// dkv kernel 80,768 at any T.  fp32 runs two warps (QB 32), which halves
// the score rows: 152,704, 178,304 and 111,488.  All fit the 232,448
// bytes a block may opt into; each kernel's limit is set once, at T 512.
// Bound: as the routes above, bytes (GPT-2 large's heads at T 136, B 32,
// n 16, d 96: forward 53.5 MB, 16.0 us at 3.35 TB/s; backward 93.6 MB,
// 27.9 us).  This design reads K and V once per query block, recomputes
// dP in the dq kernel and S and dP in the dkv kernel (8 T^2 d product
// passes in the backward where the function needs 5), and takes p and dS
// to its products through shared memory; route 0's wgmma design (a block
// per head, register accumulators) covers T <= 128 in bf16/fp16, and
// TMA and a block per head for T past 128 are later work.

constexpr int kWideMaxT = 512;
constexpr int kWideMaxD = 128;
constexpr int kKT = 64;  // keys per K/V tile (forward, dq kernel)
constexpr int kQT = 32;  // query rows per step of the dkv kernel

// elements of T in 16 bytes, and the row stride of a tile of DP columns in
// shared memory (a 16-byte pad puts the 8 rows of an ldmatrix in distinct
// banks)
template <typename T>
__host__ __device__ constexpr int vec16() {
  return 16 / int(sizeof(T));
}
template <typename T, int DP>
__host__ __device__ constexpr int ld_tile() {
  return DP + vec16<T>();
}

__host__ __device__ constexpr int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// Shared memory of the forward and dq kernels for a runtime T: the host
// sizes the launch with it and the kernel carves with it.
template <typename T, int DP, int NW>
struct WideLayout {
  static constexpr int QB = 16 * NW, LDT = ld_tile<T, DP>();
  static constexpr int LDST = kKT + vec16<T>();  // dS staging row stride
  static constexpr size_t rows = align128(size_t(QB) * LDT * sizeof(T));
  static constexpr size_t tile = align128(size_t(kKT) * LDT * sizeof(T));
  static constexpr size_t stage =
      align128(size_t(NW) * 16 * LDST * sizeof(T));
  int LDS;                // fp32 score row stride
  size_t s, mk, fwd, dq;  // score rows; mask and the block's int
  __host__ __device__ explicit WideLayout(int Tn) {
    const int Tp = round_up(Tn, kKT);
    LDS = Tp + 4;
    s = align128(size_t(QB) * LDS * 4);
    mk = align128(size_t(Tp) * 4 + 16);
    fwd = rows + 2 * tile + s + mk;               // q; ring; S; mask
    dq = 2 * rows + 2 * tile + s + stage + mk;    // q, dO; ring; S; dS; mask
  }
};

// Shared memory of the dkv kernel (any T).
template <typename T, int DP, int NW>
struct WideDkvLayout {
  static constexpr int KB = 16 * NW, LDT = ld_tile<T, DP>();
  static constexpr int LDST = kQT + vec16<T>();  // p / dS staging stride
  static constexpr size_t kv = align128(size_t(KB) * LDT * sizeof(T));
  static constexpr size_t qt = align128(size_t(kQT) * LDT * sizeof(T));
  static constexpr size_t slot = 2 * qt + align128(3 * kQT * 4);  // q, dO, m l t
  static constexpr size_t stage =
      align128(size_t(NW) * 2 * 16 * LDST * sizeof(T));
  static constexpr size_t total = 2 * kv + 2 * slot + stage + 128;
};

// `rows` rows of d elements (row r at src + r * ld, 16-byte aligned) into
// an R x DP tile by 16-byte cp.async; columns from d and rows from `rows`
// are zero-filled.
template <typename T, int DP>
__device__ __forceinline__ void cp_tile(T* dst, const T* src, size_t ld,
                                        int rows, int R, int d) {
  constexpr int V = vec16<T>(), C = DP / V, LDT = ld_tile<T, DP>();
  for (int e = threadIdx.x; e < R * C; e += blockDim.x) {
    const int r = e / C, c = (e % C) * V;
    const bool ok = r < rows && c < d;
    cp_async16(dst + r * LDT + c, ok ? src + size_t(r) * ld + c : src, ok);
  }
}

// acc[NT][4] += A[16 x K] . B[K x 8 NT] for one warp, in the mma.sync C
// layout: acc[nt][e] is row gq + 8 (e >> 1), column 8 nt + 2 tq + (e & 1).
// A is row-major (stride lda elements); B is stored [n][k] (BNK: row n
// holds its K values) or [k][n] (stride ldb).  K a multiple of 16, NT even.
template <typename T, int NT, bool BNK>
__device__ __forceinline__ void warp_mm(float (&acc)[NT][4], const T* A,
                                        int lda, const T* B, int ldb, int K) {
  const int lane = threadIdx.x & 31;
  if constexpr (std::is_same<T, float>::value) {
    const int gq = lane >> 2, tq = lane & 3;
    for (int k = 0; k < K; ++k) {
      const float a0 = A[gq * lda + k], a1 = A[(gq + 8) * lda + k];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int c = 8 * nt + 2 * tq;
        const float b0 = BNK ? B[c * ldb + k] : B[k * ldb + c];
        const float b1 = BNK ? B[(c + 1) * ldb + k] : B[k * ldb + c + 1];
        acc[nt][0] = fmaf(a0, b0, acc[nt][0]);
        acc[nt][1] = fmaf(a0, b1, acc[nt][1]);
        acc[nt][2] = fmaf(a1, b0, acc[nt][2]);
        acc[nt][3] = fmaf(a1, b1, acc[nt][3]);
      }
    }
  } else {
    for (int k0 = 0; k0 < K; k0 += 16) {
      uint32_t a[4];
      ldsm_x4<false>(a, A + (lane & 15) * lda + k0 + (lane >> 4) * 8);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t b[4];
        if constexpr (BNK)
          ldsm_x4<false>(b, B + (16 * np + (lane & 7) + 8 * (lane >> 4)) * ldb +
                                k0 + 8 * ((lane >> 3) & 1));
        else
          ldsm_x4<true>(b, B + (k0 + (lane & 7) + 8 * ((lane >> 3) & 1)) * ldb +
                               16 * np + 8 * (lane >> 4));
        mma16816<T>(acc[2 * np], a, b[0], b[1]);
        mma16816<T>(acc[2 * np + 1], a, b[2], b[3]);
      }
    }
  }
}

// two neighbouring values to shared memory as T
template <typename T>
__device__ __forceinline__ void put2(T* dst, float lo, float hi) {
  if constexpr (std::is_same<T, float>::value)
    *reinterpret_cast<float2*>(dst) = make_float2(lo, hi);
  else
    *reinterpret_cast<uint32_t*>(dst) = pack2<T>(lo, hi);
}

// a warp's 16 x 8 NT accumulator tile times `mul` into shared memory as T
// (row stride ld)
template <typename T, int NT>
__device__ __forceinline__ void stage_frag(T* dst, int ld,
                                           const float (&acc)[NT][4],
                                           float mul) {
  const int lane = threadIdx.x & 31, gq = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      put2<T>(dst + (gq + 8 * h) * ld + 8 * nt + 2 * tq,
              acc[nt][2 * h] * mul, acc[nt][2 * h + 1] * mul);
}

// A warp's 16 staged rows (`src`, row stride LDT) to rows row0.. of a
// contiguous [B, T, n, d] array (`dst` at row 0 of this (b, head), row
// stride ld), 16 bytes a lane; rows from T are not written.
template <typename T, int DP>
__device__ __forceinline__ void store_warp_rows(T* dst, size_t ld,
                                                const T* src, int row0,
                                                int Tn, int d) {
  constexpr int V = vec16<T>(), C = DP / V, LDT = ld_tile<T, DP>();
  for (int e = threadIdx.x & 31; e < 16 * C; e += 32) {
    const int r = e / C, c = (e % C) * V;
    if (row0 + r < Tn && c < d)
      *reinterpret_cast<uint4*>(dst + size_t(row0 + r) * ld + c) =
          *reinterpret_cast<const uint4*>(src + r * LDT + c);
  }
}

// The batch row's first unmasked key (T when every key is masked), for
// every thread; `red` is an int of shared memory.  With `mk` the row's
// mask is kept there too, zeros from T to Tp.
__device__ __forceinline__ int first_key(const float* mask, int Tn, int Tp,
                                         float* mk, int* red) {
  if (threadIdx.x == 0) *red = Tn;
  __syncthreads();
  int f = Tn;
  for (int c = threadIdx.x; c < Tp; c += blockDim.x) {
    const float m = c < Tn ? mask[c] : 0.f;
    if (mk) mk[c] = m;
    if (m != 0.f && c < f) f = c;
  }
  f = __reduce_min_sync(0xffffffffu, f);
  if ((threadIdx.x & 31) == 0) atomicMin(red, f);
  __syncthreads();
  return *red;
}

// A warp's 16 x 64 product tile s (query rows `row` and row + 8 of this
// thread, keys from c0) scaled and masked as _scores into its fp32 score
// rows: the causal band, then the key mask, to -1e9.
__device__ __forceinline__ void put_scores(float* Sw, int LDS,
                                           const float (&s)[kKT / 8][4],
                                           int row, int c0, const float* mk,
                                           const Args& a) {
  const int lane = threadIdx.x & 31, gq = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int nt = 0; nt < kKT / 8; ++nt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float x[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = c0 + 8 * nt + 2 * tq + e;
        x[e] = s[nt][2 * h + e] * a.scale;
        if (a.causal && c > row + 8 * h) x[e] = kMasked;
        if (mk[c] == 0.f) x[e] = kMasked;
      }
      *reinterpret_cast<float2*>(Sw + (gq + 8 * h) * LDS + c0 + 8 * nt +
                                 2 * tq) = make_float2(x[0], x[1]);
    }
}

// The exact softmax of a warp's 16 whole score rows over the keys below
// kend (the other keys' p are exact zeros), p = e / sum written over each
// row as P (fp32, or the input type) for its first ncols columns.  With
// m_out, the max and sum of rows row0 + r below T are stored there and in
// l_out.  Each lane holds columns lane + 32 u; the loops stop at the
// row's ncols / 32 (unrolled, so x stays in registers).
template <typename P>
__device__ __forceinline__ void softmax_rows(float* Sw, int LDS, int kend,
                                             int ncols, int row0, int Tn,
                                             float* m_out, float* l_out) {
  const int lane = threadIdx.x & 31, nu = ncols / 32;
  for (int r = 0; r < 16; ++r) {
    float* srow = Sw + r * LDS;
    float x[kWideMaxT / 32];
    float mx = kNegInf, sum = 0.f;
#pragma unroll
    for (int u = 0; u < kWideMaxT / 32; ++u) {
      if (u == nu) break;
      const int c = lane + 32 * u;
      x[u] = c < kend ? srow[c] : kNegInf;
      mx = fmaxf(mx, x[u]);
    }
    mx = warp_max(mx);
#pragma unroll
    for (int u = 0; u < kWideMaxT / 32; ++u) {
      if (u == nu) break;
      x[u] = lane + 32 * u < kend ? expf(x[u] - mx) : 0.f;
      sum += x[u];
    }
    sum = warp_sum(sum);
    __syncwarp();  // the whole row is read before p overwrites it
    P* prow = reinterpret_cast<P*>(srow);
#pragma unroll
    for (int u = 0; u < kWideMaxT / 32; ++u) {
      if (u == nu) break;
      prow[lane + 32 * u] = from_f<P>(x[u] / sum);
    }
    if (m_out && lane == 0 && row0 + r < Tn) {
      m_out[row0 + r] = mx;
      l_out[row0 + r] = sum;
    }
  }
  __syncwarp();
}

// The block's place: (b, head) and the first row of its 16 NW rows.
struct WidePlace {
  int bh, b, h, r0;
  __device__ WidePlace(const Args& a, int rows_per_block) {
    const int nblk = (a.T + rows_per_block - 1) / rows_per_block;
    bh = blockIdx.x / nblk;
    r0 = (blockIdx.x % nblk) * rows_per_block;
    b = bh / a.n;
    h = bh % a.n;
  }
};

template <typename T, int DP, int NW>
__global__ void __launch_bounds__(32 * NW) block_fwd_wide_kernel(Args a) {
  using L = WideLayout<T, DP, NW>;
  constexpr int LDT = L::LDT;
  constexpr size_t TE = L::tile / sizeof(T);  // elements per ring slot
  const L lay(a.T);
  extern __shared__ __align__(128) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);
  T* ring = reinterpret_cast<T*>(smem + L::rows);
  float* Ss = reinterpret_cast<float*>(smem + L::rows + 2 * L::tile);
  float* mk = reinterpret_cast<float*>(smem + L::rows + 2 * L::tile + lay.s);
  const int Tn = a.T, d = a.d, Tp = round_up(Tn, kKT);
  const WidePlace at(a, L::QB);
  const size_t sT = size_t(a.sT);
  const size_t base = size_t(at.b) * a.sB + size_t(at.h) * a.sH;
  const T* kp = static_cast<const T*>(a.k) + base;
  const T* vp = static_cast<const T*>(a.v) + base;
  cp_tile<T, DP>(Qs, static_cast<const T*>(a.q) + base + at.r0 * sT, sT,
                 min(L::QB, Tn - at.r0), L::QB, d);
  const int f = first_key(a.mask + size_t(at.b) * Tn, Tn, Tp, mk,
                          reinterpret_cast<int*>(mk + Tp));
  const int kend = a.causal && f <= at.r0 ? min(Tn, at.r0 + L::QB) : Tn;
  const int nt = (kend + kKT - 1) / kKT;
  // the stream: K tiles 0..nt-1, then V tiles 0..nt-1
  auto issue = [&](int i) {
    const int j = i < nt ? i : i - nt;
    cp_tile<T, DP>(ring + (i & 1) * TE, (i < nt ? kp : vp) + j * kKT * sT,
                   sT, min(kKT, Tn - j * kKT), kKT, d);
    cp_async_commit();
  };
  const int w = threadIdx.x >> 5, gq = (threadIdx.x & 31) >> 2;
  T* Qw = Qs + 16 * w * LDT;
  float* Sw = Ss + 16 * w * lay.LDS;
  const int row = at.r0 + 16 * w + gq;
  float o[DP / 8][4] = {};
  issue(0);
  for (int i = 0; i < 2 * nt; ++i) {
    if (i + 1 < 2 * nt) {
      issue(i + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* tile = ring + (i & 1) * TE;
    if (i < nt) {
      float s[kKT / 8][4] = {};
      warp_mm<T, kKT / 8, true>(s, Qw, LDT, tile, LDT, DP);
      put_scores(Sw, lay.LDS, s, row, i * kKT, mk, a);
      if (i == nt - 1) {
        __syncwarp();
        softmax_rows<T>(Sw, lay.LDS, kend, nt * kKT, 0, 0, nullptr, nullptr);
      }
    } else {
      // p of keys 64 (i - nt).. in the input type, over the score rows
      warp_mm<T, DP / 8, false>(o,
                                reinterpret_cast<const T*>(Sw) + (i - nt) * kKT,
                                lay.LDS * 4 / int(sizeof(T)), tile, LDT, kKT);
    }
    __syncthreads();
  }
  // O in the input type, staged through the warp's own q rows
  stage_frag<T, DP / 8>(Qw, LDT, o, 1.f);
  __syncwarp();
  const size_t ld_out = size_t(a.n) * d;
  store_warp_rows<T, DP>(static_cast<T*>(a.o) + size_t(at.b) * Tn * ld_out +
                             size_t(at.h) * d,
                         ld_out, Qw, at.r0 + 16 * w, Tn, d);
}

template <typename T, int DP, int NW>
__global__ void __launch_bounds__(32 * NW) block_bwd_wide_dq_kernel(Args a) {
  using L = WideLayout<T, DP, NW>;
  constexpr int LDT = L::LDT;
  constexpr size_t TE = L::tile / sizeof(T);
  const L lay(a.T);
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* p = smem;
  T* Qs = reinterpret_cast<T*>(p);
  T* dOs = reinterpret_cast<T*>(p += L::rows);
  T* ring = reinterpret_cast<T*>(p += L::rows);
  float* Ss = reinterpret_cast<float*>(p += 2 * L::tile);
  T* dSs = reinterpret_cast<T*>(p += lay.s);
  float* mk = reinterpret_cast<float*>(p += L::stage);
  const int Tn = a.T, d = a.d, Tp = round_up(Tn, kKT);
  const WidePlace at(a, L::QB);
  const size_t sT = size_t(a.sT);
  const size_t base = size_t(at.b) * a.sB + size_t(at.h) * a.sH;
  const size_t ld_out = size_t(a.n) * d;
  const size_t obase = size_t(at.b) * Tn * ld_out + size_t(at.h) * d;
  const T* kp = static_cast<const T*>(a.k) + base;
  const T* vp = static_cast<const T*>(a.v) + base;
  const int rows = min(L::QB, Tn - at.r0);
  cp_tile<T, DP>(Qs, static_cast<const T*>(a.q) + base + at.r0 * sT, sT,
                 rows, L::QB, d);
  cp_tile<T, DP>(dOs, static_cast<const T*>(a.dout) + obase + at.r0 * ld_out,
                 ld_out, rows, L::QB, d);
  const int f = first_key(a.mask + size_t(at.b) * Tn, Tn, Tp, mk,
                          reinterpret_cast<int*>(mk + Tp));
  const int kend = a.causal && f <= at.r0 ? min(Tn, at.r0 + L::QB) : Tn;
  const int nt = (kend + kKT - 1) / kKT;
  // the stream: K 0..nt-1 (S), V 0..nt-1 (t), then V j, K j for each j
  // (dS, dQ)
  auto issue = [&](int i) {
    int j = i;
    const T* src = kp;
    if (i >= 2 * nt) {
      j = (i - 2 * nt) >> 1;
      src = (i - 2 * nt) & 1 ? kp : vp;
    } else if (i >= nt) {
      j = i - nt;
      src = vp;
    }
    cp_tile<T, DP>(ring + (i & 1) * TE, src + j * kKT * sT, sT,
                   min(kKT, Tn - j * kKT), kKT, d);
    cp_async_commit();
  };
  const size_t BnT = size_t(a.B) * a.n * Tn;
  float* m_out = a.stats + size_t(at.bh) * Tn;
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3;
  T* Qw = Qs + 16 * w * LDT;
  const T* dOw = dOs + 16 * w * LDT;
  float* Sw = Ss + 16 * w * lay.LDS;
  T* dSw = dSs + 16 * w * L::LDST;
  const int row = at.r0 + 16 * w + gq;
  float dq[DP / 8][4] = {};
  float t[2] = {0.f, 0.f};
  issue(0);
  for (int i = 0; i < 4 * nt; ++i) {
    if (i + 1 < 4 * nt) {
      issue(i + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* tile = ring + (i & 1) * TE;
    if (i < nt) {
      float s[kKT / 8][4] = {};
      warp_mm<T, kKT / 8, true>(s, Qw, LDT, tile, LDT, DP);
      put_scores(Sw, lay.LDS, s, row, i * kKT, mk, a);
      if (i == nt - 1) {
        __syncwarp();
        softmax_rows<float>(Sw, lay.LDS, kend, nt * kKT, at.r0 + 16 * w, Tn,
                            m_out, m_out + BnT);
      }
    } else if (i < 2 * nt || !((i - 2 * nt) & 1)) {
      // dP = dO.v^T of keys 64 j..
      const int j = i < 2 * nt ? i - nt : (i - 2 * nt) >> 1;
      float dp[kKT / 8][4] = {};
      warp_mm<T, kKT / 8, true>(dp, dOw, LDT, tile, LDT, DP);
      const float* pw = Sw + j * kKT + 2 * tq;
      if (i < 2 * nt) {
#pragma unroll
        for (int n8 = 0; n8 < kKT / 8; ++n8)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            t[e >> 1] += dp[n8][e] * pw[(gq + 8 * (e >> 1)) * lay.LDS +
                                        8 * n8 + (e & 1)];
        if (i == 2 * nt - 1) {
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            t[hh] += __shfl_xor_sync(0xffffffffu, t[hh], 1);
            t[hh] += __shfl_xor_sync(0xffffffffu, t[hh], 2);
            if (tq == 0 && row + 8 * hh < Tn)
              m_out[2 * BnT + row + 8 * hh] = t[hh];
          }
        }
      } else {
#pragma unroll
        for (int n8 = 0; n8 < kKT / 8; ++n8)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            dp[n8][e] = pw[(gq + 8 * (e >> 1)) * lay.LDS + 8 * n8 + (e & 1)] *
                        (dp[n8][e] - t[e >> 1]);
        stage_frag<T, kKT / 8>(dSw, L::LDST, dp, 1.f);
        __syncwarp();
      }
    } else {
      warp_mm<T, DP / 8, false>(dq, dSw, L::LDST, tile, LDT, kKT);
    }
    __syncthreads();
  }
  stage_frag<T, DP / 8>(Qw, LDT, dq, a.scale);
  __syncwarp();
  store_warp_rows<T, DP>(static_cast<T*>(a.dq) + obase, ld_out, Qw,
                         at.r0 + 16 * w, Tn, d);
}

template <typename T, int DP, int NW>
__global__ void __launch_bounds__(32 * NW) block_bwd_wide_dkv_kernel(Args a) {
  using L = WideDkvLayout<T, DP, NW>;
  constexpr int LDT = L::LDT, LDST = L::LDST;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Ks = reinterpret_cast<T*>(smem);
  T* Vs = reinterpret_cast<T*>(smem + L::kv);
  unsigned char* slots = smem + 2 * L::kv;
  T* stg = reinterpret_cast<T*>(slots + 2 * L::slot);
  int* red = reinterpret_cast<int*>(slots + 2 * L::slot + L::stage);
  const int Tn = a.T, d = a.d;
  const WidePlace at(a, L::KB);
  const int k0 = at.r0;
  const size_t sT = size_t(a.sT);
  const size_t base = size_t(at.b) * a.sB + size_t(at.h) * a.sH;
  const size_t ld_out = size_t(a.n) * d;
  const size_t obase = size_t(at.b) * Tn * ld_out + size_t(at.h) * d;
  const T* qp = static_cast<const T*>(a.q) + base;
  const T* dop = static_cast<const T*>(a.dout) + obase;
  const int keys = min(L::KB, Tn - k0);
  cp_tile<T, DP>(Ks, static_cast<const T*>(a.k) + base + k0 * sT, sT, keys,
                 L::KB, d);
  cp_tile<T, DP>(Vs, static_cast<const T*>(a.v) + base + k0 * sT, sT, keys,
                 L::KB, d);
  cp_async_commit();
  const float* mrow = a.mask + size_t(at.b) * Tn;
  const int f = first_key(mrow, Tn, Tn, nullptr, red);
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int key = k0 + 16 * w + gq;  // and key + 8
  const float km[2] = {key < Tn ? mrow[key] : 0.f,
                       key + 8 < Tn ? mrow[key + 8] : 0.f};
  const size_t BnT = size_t(a.B) * a.n * Tn;
  const float* stats = a.stats + size_t(at.bh) * Tn;
  const int nq = (Tn + kQT - 1) / kQT;
  // query tiles whose every row has an unmasked key at or before it and
  // ends before this block's keys add exact zeros (causal): skipped
  auto next = [&](int i) {
    while (i < nq && a.causal && f <= i * kQT && i * kQT + kQT - 1 < k0) ++i;
    return i;
  };
  auto issue = [&](int i, int slot) {
    unsigned char* sl = slots + slot * L::slot;
    const int r0 = i * kQT, rows = min(kQT, Tn - r0);
    cp_tile<T, DP>(reinterpret_cast<T*>(sl), qp + r0 * sT, sT, rows, kQT, d);
    cp_tile<T, DP>(reinterpret_cast<T*>(sl + L::qt), dop + r0 * ld_out, ld_out,
                   rows, kQT, d);
    float* st = reinterpret_cast<float*>(sl + 2 * L::qt);
    for (int e = threadIdx.x; e < 3 * kQT / 4; e += blockDim.x) {
      const int which = e / (kQT / 4), c = (e % (kQT / 4)) * 4;
      const float* src = stats + which * BnT + r0;
      cp_async16(st + which * kQT + c, c < rows ? src + c : src, c < rows);
    }
    cp_async_commit();
  };
  const T* Kw = Ks + 16 * w * LDT;
  const T* Vw = Vs + 16 * w * LDT;
  T* Pw = stg + 2 * 16 * w * LDST;
  T* dSw = Pw + 16 * LDST;
  float dk[DP / 8][4] = {}, dv[DP / 8][4] = {};
  int cur = next(0), slot = 0;
  issue(cur, 0);  // the tile holding key k0 is never skipped
  while (cur < nq) {
    const int nxt = next(cur + 1);
    if (nxt < nq) {
      issue(nxt, slot ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const unsigned char* sl = slots + slot * L::slot;
    const T* Qt = reinterpret_cast<const T*>(sl);
    const T* dOt = reinterpret_cast<const T*>(sl + L::qt);
    const float* st = reinterpret_cast<const float*>(sl + 2 * L::qt);
    const int r0 = cur * kQT;
    float s[kQT / 8][4] = {}, dp[kQT / 8][4] = {};
    warp_mm<T, kQT / 8, true>(s, Kw, LDT, Qt, LDT, DP);
    warp_mm<T, kQT / 8, true>(dp, Vw, LDT, dOt, LDT, DP);
#pragma unroll
    for (int n8 = 0; n8 < kQT / 8; ++n8)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hh = e >> 1, qi = 8 * n8 + 2 * tq + (e & 1);
        float x = s[n8][e] * a.scale;
        if (a.causal && key + 8 * hh > r0 + qi) x = kMasked;
        if (km[hh] == 0.f) x = kMasked;
        const float pv =
            r0 + qi < Tn ? expf(x - st[qi]) / st[kQT + qi] : 0.f;
        s[n8][e] = pv;
        dp[n8][e] = pv * (dp[n8][e] - st[2 * kQT + qi]);
      }
    stage_frag<T, kQT / 8>(Pw, LDST, s, 1.f);
    stage_frag<T, kQT / 8>(dSw, LDST, dp, 1.f);
    __syncwarp();
    warp_mm<T, DP / 8, false>(dv, Pw, LDST, dOt, LDT, kQT);
    warp_mm<T, DP / 8, false>(dk, dSw, LDST, Qt, LDT, kQT);
    __syncthreads();
    cur = nxt;
    slot ^= 1;
  }
  // dK, dV through the warp's own k, v rows
  T* dks = Ks + 16 * w * LDT;
  T* dvs = Vs + 16 * w * LDT;
  stage_frag<T, DP / 8>(dks, LDT, dk, a.scale);
  stage_frag<T, DP / 8>(dvs, LDT, dv, 1.f);
  __syncwarp();
  store_warp_rows<T, DP>(static_cast<T*>(a.dk) + obase, ld_out, dks,
                         k0 + 16 * w, Tn, d);
  store_warp_rows<T, DP>(static_cast<T*>(a.dv) + obase, ld_out, dvs,
                         k0 + 16 * w, Tn, d);
}

// ------------------------------------------------------------------ launch

template <int DP>
int run_f32(bool backward, const Args& a, cudaStream_t stream) {
  if (!backward) {
    const FwdLayout<float, DP> L(a.T, 32);
    return launch(block_fwd_kernel<float, DP, 32>,
                  dim3(a.B * a.n, (a.T + 31) / 32), kFwdThreads, L.total, a,
                  stream);
  }
  const BwdLayout<float, DP> L(a.T, 16);
  return launch(block_bwd_kernel<float, DP, 16>, dim3(a.B * a.n),
                kBwdThreads, L.total, a, stream);
}

template <typename T, int NB, int DP>
int run_wg(bool backward, const Args& a, cudaStream_t stream) {
  using L = WgLayout<NB, DP>;
  const dim3 grid(a.B * a.n);
  if (!backward)
    return launch_once<block_fwd_wg_kernel<T, NB, DP>>(grid, 128 * NB, L::fwd,
                                                       a, stream);
  return launch_once<block_bwd_wg_kernel<T, NB, DP>>(grid, 128 * NB, L::bwd,
                                                     a, stream);
}

// one or two 64-row blocks; d padded to 64 or 128
template <typename T>
int run_wg(bool backward, const Args& a, cudaStream_t stream) {
  if (a.d > 64)
    return a.T > 64 ? run_wg<T, 2, 128>(backward, a, stream)
                    : run_wg<T, 1, 128>(backward, a, stream);
  return a.T > 64 ? run_wg<T, 2, 64>(backward, a, stream)
                  : run_wg<T, 1, 64>(backward, a, stream);
}

template <typename T, int DP, int NW>
int run_wide(bool backward, const Args& a, cudaStream_t stream) {
  using L = WideLayout<T, DP, NW>;
  const dim3 grid(a.B * a.n * ((a.T + L::QB - 1) / L::QB));
  const L lay(a.T), top(kWideMaxT);
  if (!backward)
    return launch_once<block_fwd_wide_kernel<T, DP, NW>>(
        grid, 32 * NW, lay.fwd, a, stream, top.fwd);
  const int rc = launch_once<block_bwd_wide_dq_kernel<T, DP, NW>>(
      grid, 32 * NW, lay.dq, a, stream, top.dq);
  if (rc != 0) return rc;
  // 16 NW keys a block, as the dq kernel's 16 NW query rows: the same grid
  return launch_once<block_bwd_wide_dkv_kernel<T, DP, NW>>(
      grid, 32 * NW, WideDkvLayout<T, DP, NW>::total, a, stream);
}

// d padded to 64, 96 or 128 (fp32: 64 or 128); fp32 runs two warps a block
template <typename T>
int run_wide(bool backward, const Args& a, cudaStream_t stream) {
  constexpr int NW = std::is_same<T, float>::value ? 2 : 4;
  if (a.d <= 64) return run_wide<T, 64, NW>(backward, a, stream);
  if constexpr (!std::is_same<T, float>::value)
    if (a.d <= 96) return run_wide<T, 96, NW>(backward, a, stream);
  return run_wide<T, 128, NW>(backward, a, stream);
}

// dtype: 0 fp32, 1 bf16, 2 fp16.  route 0: the kernels above the wide
// route (T a multiple of 16 in [16, 128]; d <= 128 in bf16 and fp16, d <=
// 64 in fp32); route 1: the wide route (T a multiple of 8 in [8, 512], d
// <= 128), whose backward needs `stats`.
int dispatch(int dtype, int route, bool backward, const Args& a,
             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a.d % 8 != 0 || a.d <= 0 || a.T <= 0 || a.B <= 0 || a.n <= 0)
    return int(cudaErrorInvalidValue);
  if (route == 0) {
    if (a.d > (dtype == 0 ? 64 : kWgMaxD) || a.T % 16 != 0 || a.T < 16 ||
        a.T > kMaxT)
      return int(cudaErrorInvalidValue);
    switch (dtype) {
      case 0:
        return a.d <= 32 ? run_f32<32>(backward, a, s)
                         : run_f32<64>(backward, a, s);
      case 1:
        return run_wg<__nv_bfloat16>(backward, a, s);
      case 2:
        return run_wg<__half>(backward, a, s);
    }
    return int(cudaErrorInvalidValue);
  }
  if (route != 1 || a.T % 8 != 0 || a.T > kWideMaxT || a.d > kWideMaxD ||
      (backward && a.stats == nullptr))
    return int(cudaErrorInvalidValue);
  switch (dtype) {
    case 0:
      return run_wide<float>(backward, a, s);
    case 1:
      return run_wide<__nv_bfloat16>(backward, a, s);
    case 2:
      return run_wide<__half>(backward, a, s);
  }
  return int(cudaErrorInvalidValue);
}

}  // namespace

// C interface.  Every pointer is a device pointer.  q, k, v are [B, T, n, d]
// in the type `dtype` names, with element strides sB, sT, sH (the last dim
// contiguous; every row 16-byte aligned); dout, o, dq, dk, dv are contiguous
// [B, T, n, d]; mask is fp32 [B, T].  `route` picks the kernels (dispatch):
// 0 takes T a multiple of 16 in [16, 128] and d a multiple of 8 up to 128
// in bf16 and fp16 (up to 64 in fp32), 1 (the wide route) T a multiple of 8 in [8, 512] and d a multiple of 8 up
// to 128, and its backward writes and reads `stats`, fp32 [3, B, n, T]
// scratch (route 0 ignores it).  `stream` is a cudaStream_t.  Each function
// returns cudaGetLastError() after its launches (0 = cudaSuccess), or
// cudaErrorInvalidValue for a shape or route it does not take.

extern "C" int dstt_block_fwd(int dtype, int route, const void* q,
                              const void* k, const void* v, const float* mask,
                              void* o, long long sB, long long sT,
                              long long sH, int B, int n, int T, int d,
                              float scale, int causal, void* stream) {
  Args a{};
  a.q = q, a.k = k, a.v = v, a.mask = mask, a.o = o;
  a.sB = sB, a.sT = sT, a.sH = sH;
  a.B = B, a.n = n, a.T = T, a.d = d, a.scale = scale, a.causal = causal;
  return dispatch(dtype, route, false, a, stream);
}

extern "C" int dstt_block_bwd(int dtype, int route, const void* q,
                              const void* k, const void* v, const float* mask,
                              const void* dout, void* dq, void* dk, void* dv,
                              float* stats, long long sB, long long sT,
                              long long sH, int B, int n, int T, int d,
                              float scale, int causal, void* stream) {
  Args a{};
  a.q = q, a.k = k, a.v = v, a.mask = mask, a.dout = dout;
  a.dq = dq, a.dk = dk, a.dv = dv, a.stats = stats;
  a.sB = sB, a.sT = sT, a.sH = sH;
  a.B = B, a.n = n, a.T = T, a.d = d, a.scale = scale, a.causal = causal;
  return dispatch(dtype, route, true, a, stream);
}

extern "C" const char* dstt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
