// Whole-tile attention for Hopper (sm_90a): the forward and backward kernels
// for short sequences (T <= 128), on q, k, v in the public [B, T, n, d]
// layout read through their strides (the views of the packed qkv projection
// need no copy), with a plain C interface loaded through ctypes
// (deepspeed_tpu_torch/ops/block_attention.py builds this file with nvcc at
// first use and holds each kernel's plain PyTorch version beside it).
//
// What each kernel replaces (deepspeed_tpu/ops/pallas_attention.py):
//   block_fwd_wg_kernel  <- _fwd_kernel  (:106, pallas_call :180)  bf16/fp16
//   block_bwd_wg_kernel  <- _bwd_kernel  (:122, pallas_call :200)  bf16/fp16
//   block_fwd_kernel     <- _fwd_kernel  fp32 route
//   block_bwd_kernel     <- _bwd_kernel  fp32 route
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
//     head.  The kernels are instantiated per NB (1 or 2), so every loop
//     over key blocks and query slices has a constant count and no wgmma
//     sits in a divergent branch (ptxas serialises those); the skipping
//     warpgroup runs the instantiation for one key block.  The head dim is
//     zero-padded to 64 in shared memory; rows past T are zero-filled and
//     never stored.
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

constexpr int kDP = 64;        // head dim padded in shared memory
constexpr int kRB = kDP * 16;  // bytes per 8-row group of an operand tile
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory of the wgmma kernels for NB blocks of 64 rows (R = 64 NB
// >= T): operand tiles of R rows (q, k, v, dO) in the core-matrix layout
// and the backward's p and dS as [R queries][R keys] tiles in the same
// layout (8-query groups of R * 16 bytes, 8-key chunks of 128).
template <int NB>
struct WgLayout {
  static constexpr int R = 64 * NB;
  static constexpr size_t tile = size_t(R) * kDP * 2, pt = size_t(R) * R * 2;
  static constexpr size_t fwd = 3 * tile;           // q, k, v
  static constexpr size_t bwd = 4 * tile + 2 * pt;  // q, k, v, dO; p, dS
};

// byte offset of row r, 8-column chunk c in an operand tile
__device__ __forceinline__ int cm_off(int r, int c) {
  return (r >> 3) * kRB + c * 128 + (r & 7) * 16;
}

// `rows` rows of d elements (row r at src + r * ld, 16-byte aligned) into
// an R-row operand tile by 16-byte cp.async; columns past d and rows past
// `rows` are zero-filled.  Eight consecutive threads take one column chunk
// of eight rows, so a warp fills whole 32-byte sectors of each row.
template <typename T>
__device__ __forceinline__ void load_tile_cm(unsigned char* dst, const T* src,
                                             size_t ld, int rows, int R,
                                             int d) {
  for (int e = threadIdx.x; e < R * 8; e += blockDim.x) {
    const int r = (e >> 6) * 8 + (e & 7), c = (e >> 3) & 7;
    const bool ok = r < rows && c * 8 < d;
    cp_async16(dst + cm_off(r, c), ok ? src + r * ld + c * 8 : src, ok);
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
// blocks 0..NKB-1 of `B`: s[j] holds the 64 keys from 64 j.  Both operands
// K-major.
template <typename T, int NKB>
__device__ __forceinline__ void scores(float (&s)[NKB][32],
                                       const unsigned char* A,
                                       const unsigned char* B) {
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < NKB; ++j)
#pragma unroll
    for (int kk = 0; kk < kDP / 16; ++kk)
      wgmma_ss<T>(s[j], gmma_desc(A + kk * 256, 128, kRB),
                  gmma_desc(B + j * 8 * kRB + kk * 256, 128, kRB), kk > 0);
  wgmma_commit();
  wgmma_wait0();
#pragma unroll
  for (int j = 0; j < NKB; ++j) reg_fence(s[j]);
}

// acc += A . B over the NKB * 64 columns of the packed register operand
// `w` (a row block of p or dS), B the matching key rows of `Bs` read
// MN-major (v for O = p.v, k for dQ = dS.k).
template <typename T, int NKB>
__device__ __forceinline__ void rows_times_keys(float (&acc)[32],
                                                uint32_t (&w)[NKB][4][4],
                                                const unsigned char* Bs) {
  reg_fence(acc);
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < NKB; ++j)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs_t<T>(acc, w[j][kk],
                    gmma_desc(Bs + (4 * j + kk) * 2 * kRB, kRB, 128));
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
// (its row 0; 8-row groups `rb` bytes apart).
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

// `rows` (<= 64) rows of a staged 64-row tile to a contiguous [B, T, n, d]
// array (row stride ld), 16 bytes a thread over one warpgroup, as
// load_tile_cm reads.
template <typename T>
__device__ __forceinline__ void store_tile(T* dst, size_t ld,
                                           const unsigned char* src,
                                           int rows, int d) {
  for (int e = threadIdx.x & 127; e < 64 * 8; e += 128) {
    const int r = (e >> 6) * 8 + (e & 7), c = (e >> 3) & 7;
    if (r < rows && c * 8 < d)
      *reinterpret_cast<uint4*>(dst + r * ld + c * 8) =
          *reinterpret_cast<const uint4*>(src + cm_off(r, c));
  }
}

// The forward of one warpgroup's 64 query rows over NKB key blocks, after
// q and k have landed: S, the softmax, then (once v has landed) O = p.v,
// staged through the warpgroup's own q rows (only its products read them)
// and stored.
template <typename T, int NKB, int NB>
__device__ __forceinline__ void fwd_rows(const Args& a, unsigned char* Qw,
                                         const unsigned char* Ks,
                                         const unsigned char* Vs,
                                         const uint32_t (&keep)[2 * NB],
                                         int r0, T* out) {
  const int row0 =
      r0 + 16 * ((threadIdx.x >> 5) & 3) + ((threadIdx.x & 31) >> 2);
  float s[NKB][32] = {};
  scores<T, NKB>(s, Qw, Ks);
  softmax_regs<NKB, NB>(s, keep, row0, a);
  uint32_t pa[NKB][4][4];
#pragma unroll
  for (int j = 0; j < NKB; ++j) pack_acc<T>(pa[j], s[j], 1.f);
  cp_async_wait<0>();  // v has landed
  fence_proxy_async();
  __syncthreads();
  float o[32] = {};
  rows_times_keys<T, NKB>(o, pa, Vs);
  uint32_t ow[4][4];
  pack_acc<T>(ow, o, 1.f);
  stage_words(Qw, kRB, ow);
  wg_barrier(1 + (threadIdx.x >> 7));
  store_tile(out, size_t(a.n) * a.d, Qw, min(64, a.T - r0), a.d);
}

template <typename T, int NB>
__global__ void __launch_bounds__(128 * NB, 2) block_fwd_wg_kernel(Args a) {
  using L = WgLayout<NB>;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* Qs = smem;
  unsigned char* Ks = Qs + L::tile;
  unsigned char* Vs = Ks + L::tile;
  const int Tn = a.T, d = a.d;
  const int b = blockIdx.x / a.n, h = blockIdx.x % a.n;
  const size_t base = size_t(b) * a.sB + size_t(h) * a.sH;
  const size_t sT = size_t(a.sT);
  load_tile_cm(Qs, static_cast<const T*>(a.q) + base, sT, Tn, L::R, d);
  load_tile_cm(Ks, static_cast<const T*>(a.k) + base, sT, Tn, L::R, d);
  cp_async_commit();
  load_tile_cm(Vs, static_cast<const T*>(a.v) + base, sT, Tn, L::R, d);
  cp_async_commit();
  const KeyBits<NB> mask(a, b);
  cp_async_wait<1>();  // q, k have landed
  fence_proxy_async();
  __syncthreads();
  uint32_t keep[2 * NB];
  mask.bits(keep);

  const int r0 = 64 * (threadIdx.x >> 7);
  unsigned char* Qw = Qs + r0 / 8 * kRB;  // this warpgroup's q rows
  T* out = static_cast<T*>(a.o) + (size_t(b) * Tn + r0) * a.n * d +
           size_t(h) * d;
  if (NB > 1 && r0 == 0 && skips(a, keep[0]))
    fwd_rows<T, 1, NB>(a, Qw, Ks, Vs, keep, r0, out);
  else
    fwd_rows<T, NB, NB>(a, Qw, Ks, Vs, keep, r0, out);
}

// The backward's first half for one warpgroup's 64 query rows over NKB of
// NB key blocks, after q and k have landed: p and dS to shared memory (the
// skipped key blocks as zeros), and dQ = dS.k times scale, packed.
template <typename T, int NKB, int NB>
__device__ __forceinline__ void bwd_rows(const Args& a, int r0,
                                         const unsigned char* Qs,
                                         const unsigned char* Ks,
                                         const unsigned char* Vs,
                                         const unsigned char* dOs,
                                         unsigned char* Ps, unsigned char* dSs,
                                         const uint32_t (&keep)[2 * NB],
                                         uint32_t (&dqw)[4][4]) {
  constexpr int RBp = WgLayout<NB>::R * 16;
  const int row0 =
      r0 + 16 * ((threadIdx.x >> 5) & 3) + ((threadIdx.x & 31) >> 2);
  float s[NKB][32] = {}, dp[NKB][32] = {};
  scores<T, NKB>(s, Qs + r0 / 8 * kRB, Ks);
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
  scores<T, NKB>(dp, dOs + r0 / 8 * kRB, Vs);
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
  float dq[32] = {};
  rows_times_keys<T, NKB>(dq, w, Ks);
  pack_acc<T>(dqw, dq, a.scale);
}

template <typename T, int NB>
__global__ void __launch_bounds__(128 * NB, 1) block_bwd_wg_kernel(Args a) {
  using L = WgLayout<NB>;
  constexpr int RBp = L::R * 16;
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
  load_tile_cm(Qs, static_cast<const T*>(a.q) + base, sT, Tn, L::R, d);
  load_tile_cm(Ks, static_cast<const T*>(a.k) + base, sT, Tn, L::R, d);
  cp_async_commit();
  load_tile_cm(dOs, static_cast<const T*>(a.dout) + obase, ld_out, Tn,
               L::R, d);
  load_tile_cm(Vs, static_cast<const T*>(a.v) + base, sT, Tn, L::R, d);
  cp_async_commit();
  const KeyBits<NB> mask(a, b);
  cp_async_wait<1>();  // q, k have landed
  fence_proxy_async();
  __syncthreads();
  uint32_t keep[2 * NB];
  mask.bits(keep);

  uint32_t dqw[4][4];
  if (NB > 1 && r0 == 0 && skips(a, keep[0]))
    bwd_rows<T, 1, NB>(a, r0, Qs, Ks, Vs, dOs, Ps, dSs, keep, dqw);
  else
    bwd_rows<T, NB, NB>(a, r0, Qs, Ks, Vs, dOs, Ps, dSs, keep, dqw);
  fence_proxy_async();  // p, dS visible to every warpgroup's products
  __syncthreads();

  // this warpgroup's 64 keys: dV = p^T dO and dK = dS^T q over the query
  // rows in ascending 16-row slices (a skipped block pair adds zeros; the
  // rows past T have zero dO and dS)
  float dv[32] = {}, dk[32] = {};
  reg_fence(dv);
  reg_fence(dk);
  wgmma_fence();
#pragma unroll
  for (int kq = 0; kq < L::R / 16; ++kq) {
    const int off = kq * 2 * RBp + wg * 1024;
    wgmma_ss_tt<T>(dv, gmma_desc(Ps + off, RBp, 128),
                   gmma_desc(dOs + kq * 2 * kRB, kRB, 128));
    wgmma_ss_tt<T>(dk, gmma_desc(dSs + off, RBp, 128),
                   gmma_desc(Qs + kq * 2 * kRB, kRB, 128));
  }
  wgmma_commit();
  wgmma_wait0();
  reg_fence(dv);
  reg_fence(dk);
  __syncthreads();  // every product has read q, k, v

  // dQ, dK, dV through this warpgroup's rows of the q, k, v tiles
  unsigned char* dqs = Qs + r0 / 8 * kRB;
  unsigned char* dks = Ks + r0 / 8 * kRB;
  unsigned char* dvs = Vs + r0 / 8 * kRB;
  uint32_t w[4][4];
  stage_words(dqs, kRB, dqw);
  pack_acc<T>(w, dk, a.scale);
  stage_words(dks, kRB, w);
  pack_acc<T>(w, dv, 1.f);
  stage_words(dvs, kRB, w);
  wg_barrier(1 + wg);
  const int rows = min(64, Tn - r0);
  const size_t off = obase + size_t(r0) * ld_out;
  store_tile(static_cast<T*>(a.dq) + off, ld_out, dqs, rows, d);
  store_tile(static_cast<T*>(a.dk) + off, ld_out, dks, rows, d);
  store_tile(static_cast<T*>(a.dv) + off, ld_out, dvs, rows, d);
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

template <typename T, int NB>
int run_wg(bool backward, const Args& a, cudaStream_t stream) {
  const dim3 grid(a.B * a.n);
  if (!backward)
    return launch_once<block_fwd_wg_kernel<T, NB>>(
        grid, 128 * NB, WgLayout<NB>::fwd, a, stream);
  return launch_once<block_bwd_wg_kernel<T, NB>>(
      grid, 128 * NB, WgLayout<NB>::bwd, a, stream);
}

template <typename T>
int run_wg(bool backward, const Args& a, cudaStream_t stream) {
  return a.T > 64 ? run_wg<T, 2>(backward, a, stream)
                  : run_wg<T, 1>(backward, a, stream);
}

// dtype: 0 fp32, 1 bf16, 2 fp16
int dispatch(int dtype, bool backward, const Args& a, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a.d % 8 != 0 || a.d > 64 || a.T % 16 != 0 || a.T < 16 ||
      a.T > kMaxT || a.B <= 0 || a.n <= 0)
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
