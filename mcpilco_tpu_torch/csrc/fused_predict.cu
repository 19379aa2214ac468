// Fused multi-head GP posterior prediction for Hopper (sm_90a), fp32 FFMA.
//
// K1 replaces the TPU kernel fused_gram_contract (mcpilco_tpu/ops/
//    fused_predict.py, body _make_body).  For each head g and particle p it
//    forms the masked cross-gram row
//        k = lam * exp(-sum_d w_d (x*_d - X_d)^2)
//            [+ (x* p1w) X^T + p1off + ((x* p2a) X^T) * ((x* p2b) X^T)]
//    and returns kalpha = k . alpha and, per tile of F's columns, the
//    partial sums of quad = sum_n (k F)_n^2.  When x* needs a gradient it
//    also writes kF [G, P, M], the residual K2 consumes.
// K2 replaces fused_gram_contract_bwd_xstar (body _make_bwd_body): dL/dx*
//    from the cotangents g1, g2 of (kalpha, quad).  It forms R = kF F^T from
//    K1's kF and fuses the chain rule
//        kbar = (g1 alpha + 2 g2 R) * mask,  dbar = -kbar * k_se
//    into the GEMM's epilogue.  The TPU kernel recomputed kF to spare VMEM;
//    on this card storing it (1.4 MB a call at M=448) halves K2's FLOPs.
//
// What bounds them: each is one [P, M] x [M, M] fp32 contraction per head,
// 2 G P M^2 = 0.24-1.5 GFLOP on the main paths, with F (0.6-3.7 MB per
// head) resident in the 50 MB L2: microseconds of the card's 67 TFLOP/s
// fp32 rate if the SMs are fed.  The design is a tiled SGEMM:
//  - a grid of (column tile, particle tile, head) blocks, sized so that all
//    132 SMs have work;
//  - the reduction dimension is walked in chunks of BK; the operands'
//    chunks arrive by cp.async through a STAGES-deep shared-memory ring, so
//    the next chunks' loads overlap this chunk's FMAs.  Ragged edges are
//    zero-filled by cp.async's source-size operand; rows that are not
//    16-byte aligned (M % 4 != 0) are copied 4 bytes at a time;
//  - each thread accumulates a 4 x 4 register micro-tile over its slice of
//    every chunk: groups of warps share the tile (sliced K) and sum their
//    partials in a fixed order at the end, which multiplies the warps per
//    SM that hide latency.
// Partial sums over column tiles (quad), point tiles (kalpha in the wide
// path, dx*) are written per tile and summed in a fixed order by
// sum_partials(2): the result is deterministic and no atomics are used.
//
// Lane axis.  Every input and output may carry a leading lane axis L (one
// posterior per seed of the seed farm): the grid's z runs over L * G
// (lane, head) pairs.  Every per-head array is [L, G, ...] and contiguous,
// so z indexes it as the head index did; x* and X_tr are [L, P, D] and
// [L, M, D] and are offset by the lane z / G.  A block reads nothing of
// another lane, and a lane's tiles and summation order do not depend on L
// (the wide path's tiles are picked from one lane's shape): lane l of a
// launch is bitwise equal to a launch on lane l alone.  Every contraction
// is plain fp32 FMA: TF32 and bf16 splits break the posterior algebra's
// cancellation (RESULTS.md, "Pallas fused-predict A/B").
//
// Two paths by input dims.
//  - Narrow, D <= NARROW_D = 8 (the cart-pole paths, D = 6): k1_forward
//    and k2_backward_xstar hold the particle rows and head factors in
//    registers, padded to DP = 6 or 8.  K1 generates its A operand, the k
//    chunk, into shared memory inside the GEMM's mainloop; K2's epilogue
//    recomputes k_se, a2, b2 per (particle, point) pair.
//  - Wide, 8 < D <= MAX_D = 32 (the Furuta SE, D = 12; UR5's SE+P(2),
//    D = 24): one (pair, dim) step costs ~9 FLOPs and the rows do not fit
//    in registers, so regenerating k per column tile (7-15 times at
//    M = 448-960) would cost more than the GEMM.  K1 is two kernels: k1_gen
//    writes the masked k* once per call, transposed [M, Pp], and kalpha's
//    partials per point tile; k1_forward_wide is a plain SGEMM that takes
//    k* through the same cp.async ring as F.  Both generations (k1_gen, and
//    K2's recompute of k_se, a2, b2 after its mainloop) are register-blocked:
//    a thread owns a tile of (particle, point) pairs and per dim reads one
//    value per particle and per point, the head factors applied once per
//    particle.  The distance stays direct differences, sum w (x - X)^2.
//    K2's epilogue takes the TPU backward's formulation: per pair the
//    scalars dbar, kbar, kbar b2, kbar a2, then per block the products
//    [BP, BM] x [BM, D] of them against the point tile,
//        dx* = 2 w (x* sum_m dbar - dbar X) + p1 (kbar X)
//              + p2a ((kbar b2) X) + p2b ((kbar a2) X),
//    register-blocked over 4 dims and the 4 scalars per thread.  Tiles are
//    picked per shape from WIDE_K1 / WIDE_K2 (ops/fused_predict.wide_plan)
//    so that the grids fill the card; K2's also its register budget, so
//    that its grid is resident at once where it can be (K2's time follows
//    its blocks per SM more than its tile).

#include <cuda_runtime.h>

namespace {

constexpr int STAGES = 3;      // depth of the cp.async ring
constexpr int TM = 4, TN = 4;  // register micro-tile of one thread
constexpr int NARROW_D = 8;    // input dims held in registers (padded to 6 or 8)
constexpr int MAX_D = 32;      // input dims of the wide path (padded to MAX_D)

// K1: BP particles x BN columns of F per block, BK training points a chunk.
// SLICES groups of threads each cover the whole tile and take a slice of
// every chunk (sliced K): at P=400 the tiles alone give ~4.5 warps per SM,
// too few to hide shared-memory and L2 latency.
constexpr int K1_BP = 16, K1_BN = 64, K1_BK = 32, K1_SLICES = 2;
constexpr int K1_TILE_T = (K1_BP / TM) * (K1_BN / TN);
constexpr int K1_THREADS = K1_SLICES * K1_TILE_T;
// K2: BP particles x BM training points per block, BK columns of F a chunk,
// sliced the same way; both operands are stored [row][chunk column] with a
// 16-byte-aligned pitch whose rows fall in distinct bank groups for the
// float4 reads.
constexpr int K2_BP = 32, K2_BM = 32, K2_BK = 32, K2_SLICES = 2;
constexpr int K2_TILE_T = (K2_BP / TM) * (K2_BM / TN);
constexpr int K2_THREADS = K2_SLICES * K2_TILE_T;
constexpr int K2_PITCH = K2_BK + 4;

static_assert(TM == 4 && TN == 4, "the inner loops read float4 operands");
static_assert(K1_THREADS % K1_BP == 0 && (K1_BK * K1_BP) % K1_THREADS == 0,
              "K1 generates whole chunk rows per thread");
static_assert(K1_BN / TN <= 32 && 32 % (K1_BN / TN) == 0, "quad is reduced within a warp");
static_assert(TM % K1_SLICES == 0 && TM % K2_SLICES == 0 && K1_TILE_T % 32 == 0 &&
                  K2_TILE_T % 32 == 0 && K1_BK % K1_SLICES == 0 && K2_BK % (4 * K2_SLICES) == 0,
              "a slice is whole warps, whole micro-tile rows and whole chunk columns");

// The wide path.  k1_gen: GEN_BP particles x GEN_BM training points per
// block, a 4 x 4 pair tile per thread; k* is stored [M, Pp] with the
// particle axis padded to Pp, a multiple of GEN_BP (rows past P are zero).
constexpr int GEN_BP = 32, GEN_BM = 64;
constexpr int GEN_THREADS = (GEN_BP / TM) * (GEN_BM / TN);
constexpr int WIDE_BK = 32;  // the wide GEMMs' chunk
// K2-wide's rows in shared memory: points [m][c] 16-byte aligned for float4
// reads, particles [i][c] with an odd pitch (the rows a warp reads fall in
// different banks)
constexpr int XPITCH = MAX_D + 4, XSPITCH = MAX_D + 1;
// (particles, columns of F, slices) of k1_forward_wide and (particles,
// training points, slices, blocks per SM the registers must allow) of
// k2_backward_xstar_wide, per configuration: the index the caller passes
// (ops/fused_predict.py WIDE_K1 / WIDE_K2).  The K2 configurations differ
// only in their particles and their register budget, so they sum in the
// same order (a thread's slice of each chunk, the slices, the tile's
// points, the point tiles) and their results are bitwise equal.
#define WIDE_K1_CONFIGS(X) X(0, 64, 64, 1) X(1, 32, 64, 2) X(2, 16, 32, 4)
#define WIDE_K2_CONFIGS(X) \
  X(0, 32, 32, 2, 4) X(1, 32, 32, 2, 5) X(2, 32, 32, 2, 6) X(3, 16, 32, 2, 5)
#define COUNT_K1(i, bp, bn, s) +1
#define COUNT_K2(i, bp, bm, s, minb) +1
constexpr int N_WIDE_K1 = 0 WIDE_K1_CONFIGS(COUNT_K1);
constexpr int N_WIDE_K2 = 0 WIDE_K2_CONFIGS(COUNT_K2);
static_assert(GEN_THREADS % 32 == 0 && (GEN_BP / TM) <= 32 && 32 % (GEN_BP / TM) == 0,
              "k1_gen reduces kalpha over whole warps");

struct Args {
  const float* se_w;    // [G, D]
  const float* se_lam;  // [G]
  const float* poly1;   // [G, D + 1]
  const float* poly2a;  // [G, D]
  const float* poly2b;  // [G, D]
  const float* xs;      // [P, D]
  const float* xt;      // [M, D]
  const float* alpha;   // [G, M]
  const float* F;       // [G, M, M]
  const float* mask;    // [G, M]
  int G, P, M, D;       // the per-head shapes; each array has L lanes of them in front
  bool vec;  // M % 4 == 0 and F (and kF) 16-byte aligned: 16-byte copies
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Asynchronous global -> shared copies; a false `full` zero-fills the
// destination and reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(full ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool full) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(full ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Start copying the ROWS x COLS block at (r0, c0) of a row-major nr x nc
// matrix (ld floats per row) into dst[r * PITCH + c]; what lies outside the
// matrix is zero-filled.  With `vec` every row is 16-byte aligned and
// nc % 4 == 0, so a 4-float vector is either all inside or all outside.
template <int ROWS, int COLS, int PITCH, int THREADS>
__device__ __forceinline__ void load_tile(float* dst, const float* src, int ld, int nr, int nc,
                                          int r0, int c0, bool vec) {
  if (vec) {
    constexpr int Q = COLS / 4, N = ROWS * Q;
#pragma unroll
    for (int j = 0; j < (N + THREADS - 1) / THREADS; ++j) {
      const int e = threadIdx.x + j * THREADS;
      if (N % THREADS == 0 || e < N) {
        const int r = e / Q, c = (e - r * Q) * 4;
        const bool ok = r0 + r < nr && c0 + c < nc;
        cp_async16(dst + r * PITCH + c, ok ? src + (size_t)(r0 + r) * ld + c0 + c : src, ok);
      }
    }
  } else {
    constexpr int N = ROWS * COLS;
#pragma unroll 4
    for (int e = threadIdx.x; e < N; e += THREADS) {
      const int r = e / COLS, c = e - r * COLS;
      const bool ok = r0 + r < nr && c0 + c < nc;
      cp_async4(dst + r * PITCH + c, ok ? src + (size_t)(r0 + r) * ld + c0 + c : src, ok);
    }
  }
}

// Sum the SLICES partial micro-tiles of one tile position t: slice s keeps
// rows [s * TM / SLICES, +TM / SLICES) and adds the other slices' partials
// of them in slice order (deterministic).  xch: SLICES * TM * TN * TILE_T
// floats of shared memory that no thread reads any more.
template <int SLICES, int TILE_T>
__device__ __forceinline__ void gather_slices(float (&acc)[TM][TN], float* xch, int slice, int t) {
  if (SLICES == 1) return;
  constexpr int RPS = TM / SLICES;
#pragma unroll
  for (int r = 0; r < TM; ++r)
    if (r / RPS != slice)
#pragma unroll
      for (int j = 0; j < TN; ++j) xch[((slice * TM + r) * TN + j) * TILE_T + t] = acc[r][j];
  __syncthreads();
#pragma unroll
  for (int r = 0; r < TM; ++r)
    if (r / RPS == slice)
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        float v = 0.f;
        for (int q = 0; q < SLICES; ++q)
          v += q == slice ? acc[r][j] : xch[((q * TM + r) * TN + j) * TILE_T + t];
        acc[r][j] = v;
      }
}

// K1, narrow.  Block (nt, pt, g): particles [pt*BP, +BP) x F's columns
// [nt*BN, +BN).  Thread (slice, ty, tx) accumulates rows ty*4..+4 and
// columns tx*4..+4 of kF's tile over its slice of each chunk.
template <int DP, bool POLY>
__global__ void __launch_bounds__(K1_THREADS)
k1_forward(Args a, float* __restrict__ kalpha, float* __restrict__ qpart, float* __restrict__ kf) {
  constexpr int BP = K1_BP, BN = K1_BN, BK = K1_BK, T = K1_THREADS, TX = BN / TN;
  constexpr int SLICES = K1_SLICES, KS = BK / SLICES, RPS = TM / SLICES;
  static_assert(DP <= NARROW_D, "the rows sit in registers");
  static_assert(SLICES * TM * TN * K1_TILE_T <= STAGES * BK * BN, "the slices' sum reuses the ring");
  __shared__ __align__(16) float Fs[STAGES][BK * BN];  // F chunk [kk][n]
  __shared__ float Xs[STAGES][BK * DP];                // X chunk [kk][c], dims >= D zero
  __shared__ float Ms[STAGES][BK], As[STAGES][BK];     // mask, alpha chunks
  __shared__ __align__(16) float ks[BK * BP];          // masked k chunk, transposed [kk][i]
  __shared__ float red[T];

  // g: lane * G + head, the index of every per-head array
  const int M = a.M, D = a.D, P = a.P, g = blockIdx.z;
  const int nt = blockIdx.x, n0 = nt * BN, p0 = blockIdx.y * BP;
  const int tid = threadIdx.x, slice = tid / K1_TILE_T, t = tid % K1_TILE_T;
  const int tx = t % TX, ty = t / TX;
  const float* xs = a.xs + (size_t)(g / a.G) * P * D;
  const float* xt = a.xt + (size_t)(g / a.G) * M * D;
  const float* Fg = a.F + (size_t)g * M * M;
  const float* mg = a.mask + (size_t)g * M;
  const float* ag = a.alpha + (size_t)g * M;

  for (int e = tid; e < STAGES * BK * DP; e += T)
    if (e % DP >= D) (&Xs[0][0])[e] = 0.f;  // never copied; visible after the first barrier

  auto load_stage = [&](int s, int chunk) {
    const int m0 = chunk * BK;
    load_tile<BK, BN, BN, T>(Fs[s], Fg, M, M, M, m0, n0, a.vec);
    for (int e = tid; e < BK * D; e += T) {
      const int kk = e / D;
      const bool ok = m0 + kk < M;
      cp_async4(&Xs[s][kk * DP + e - kk * D], ok ? xt + (size_t)m0 * D + e : xt, ok);
    }
    for (int e = tid; e < 2 * BK; e += T) {
      const int kk = e % BK;
      const bool ok = m0 + kk < M;
      const float* src = (e < BK ? mg : ag) + m0 + kk;
      cp_async4(e < BK ? &Ms[s][kk] : &As[s][kk], ok ? src : mg, ok);
    }
  };

  // the particle row this thread generates k for, and its per-head factors
  const int gi = tid % BP;
  const bool row_ok = p0 + gi < P;
  float xi[DP], w[DP], u1[DP], ua[DP], ub[DP];
#pragma unroll
  for (int c = 0; c < DP; ++c) {
    const bool in = c < D;
    xi[c] = in && row_ok ? xs[(size_t)(p0 + gi) * D + c] : 0.f;
    w[c] = in ? a.se_w[g * D + c] : 0.f;
    if (POLY) {
      u1[c] = in ? a.poly1[g * (D + 1) + c] * xi[c] : 0.f;
      ua[c] = in ? a.poly2a[g * D + c] * xi[c] : 0.f;
      ub[c] = in ? a.poly2b[g * D + c] * xi[c] : 0.f;
    }
  }
  const float lam = a.se_lam[g];
  const float p1off = POLY ? a.poly1[g * (D + 1) + D] : 0.f;
  float ka = 0.f;

  auto gen = [&](int s) {
#pragma unroll
    for (int j = 0; j < BK * BP / T; ++j) {
      const int kk = tid / BP + j * (T / BP);
      const float* xm = &Xs[s][kk * DP];
      float d = 0.f;
#pragma unroll
      for (int c = 0; c < DP; ++c) {
        const float df = xi[c] - xm[c];
        d = fmaf(w[c] * df, df, d);
      }
      float k = lam * expf(-d);
      if (POLY) {
        float lin = p1off, a2 = 0.f, b2 = 0.f;
#pragma unroll
        for (int c = 0; c < DP; ++c) {
          lin = fmaf(u1[c], xm[c], lin);
          a2 = fmaf(ua[c], xm[c], a2);
          b2 = fmaf(ub[c], xm[c], b2);
        }
        k += lin + a2 * b2;
      }
      k = row_ok ? k * Ms[s][kk] : 0.f;
      ks[kk * BP + gi] = k;
      ka = fmaf(k, As[s][kk], ka);
    }
  };

  float acc[TM][TN];
#pragma unroll
  for (int r = 0; r < TM; ++r)
#pragma unroll
    for (int c = 0; c < TN; ++c) acc[r][c] = 0.f;

  const int nk = (M + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load_stage(s, s);
    cp_async_commit();
  }
  for (int ch = 0; ch < nk; ++ch) {
    const int s = ch % STAGES;
    cp_async_wait<STAGES - 2>();  // chunk ch has landed (this thread's copies)
    __syncthreads();              // ... everyone's; and chunk ch-1 is consumed
    if (ch + STAGES - 1 < nk) load_stage((ch + STAGES - 1) % STAGES, ch + STAGES - 1);
    cp_async_commit();
    gen(s);
    __syncthreads();
#pragma unroll
    for (int q = 0; q < KS; ++q) {
      const int kk = slice * KS + q;
      const float4 av = *reinterpret_cast<const float4*>(&ks[kk * BP + ty * TM]);
      const float4 bv = *reinterpret_cast<const float4*>(&Fs[s][kk * BN + tx * TN]);
      const float ar[TM] = {av.x, av.y, av.z, av.w}, br[TN] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int r = 0; r < TM; ++r)
#pragma unroll
        for (int c = 0; c < TN; ++c) acc[r][c] = fmaf(ar[r], br[c], acc[r][c]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free
  gather_slices<SLICES, K1_TILE_T>(acc, &Fs[0][0], slice, t);

  // kalpha: the column-tile-0 blocks sum the threads of each row in order
  red[tid] = ka;
  __syncthreads();
  if (nt == 0 && tid < BP && p0 + tid < P) {
    float s = 0.f;
    for (int j = 0; j < T / BP; ++j) s += red[tid + j * BP];
    kalpha[(size_t)g * P + p0 + tid] = s;
  }

  // quad: this tile's sum of squares per row, over the TX threads of a row;
  // each slice finishes its rows
#pragma unroll
  for (int r = 0; r < TM; ++r) {
    if (r / RPS != slice) continue;
    float s = 0.f;
#pragma unroll
    for (int c = 0; c < TN; ++c) s = fmaf(acc[r][c], acc[r][c], s);
#pragma unroll
    for (int o = TX / 2; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    const int row = p0 + ty * TM + r;
    if (tx == 0 && row < P) qpart[((size_t)g * gridDim.x + nt) * P + row] = s;
  }

  if (kf != nullptr) {
    const int n = n0 + tx * TN;
#pragma unroll
    for (int r = 0; r < TM; ++r) {
      const int row = p0 + ty * TM + r;
      if (r / RPS != slice || row >= P) continue;
      float* dst = kf + ((size_t)g * P + row) * M;
      if (a.vec) {
        if (n < M) *reinterpret_cast<float4*>(dst + n) = make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
      } else {
#pragma unroll
        for (int c = 0; c < TN; ++c)
          if (n + c < M) dst[n + c] = acc[r][c];
      }
    }
  }
}

// K2, narrow.  Block (mt, pt, g): particles [pt*BP, +BP) x training points
// [mt*BM, +BM); R = kF F^T over F's columns n in chunks of BK.  Thread
// (slice, ty, tx) accumulates rows ty*4..+4 and points tx + j*TX (j < 4) of
// R's tile over its slice of each chunk.
template <int DP, bool POLY>
__global__ void __launch_bounds__(K2_THREADS)
k2_backward_xstar(Args a, const float* __restrict__ kf, const float* __restrict__ g1,
                  const float* __restrict__ g2, float* __restrict__ dxp) {
  constexpr int BP = K2_BP, BM = K2_BM, BK = K2_BK, T = K2_THREADS, TX = BM / TN;
  constexpr int SLICES = K2_SLICES, KS = BK / SLICES, RPS = TM / SLICES;
  constexpr int PITCH = K2_PITCH, STAGE = (BP + BM) * PITCH;
  constexpr int XCH = SLICES > 1 ? SLICES * TM * TN * K2_TILE_T : 0;
  static_assert(DP <= NARROW_D, "the rows sit in registers");
  static_assert(XCH + BP * TX * DP <= STAGES * STAGE, "the epilogue's buffers reuse the ring");
  __shared__ __align__(16) float ring[STAGES * STAGE];  // per stage: kF [BP][PITCH], F [BM][PITCH]
  __shared__ float xs[BP * DP], g1s[BP], g2s[BP], Xs[BM * DP], als[BM], mks[BM];

  // g: lane * G + head, as in K1
  const int M = a.M, D = a.D, P = a.P, g = blockIdx.z;
  const int mt = blockIdx.x, m0 = mt * BM, p0 = blockIdx.y * BP;
  const int tid = threadIdx.x, slice = tid / K2_TILE_T, t = tid % K2_TILE_T;
  const int tx = t % TX, ty = t / TX;
  const float* xsl = a.xs + (size_t)(g / a.G) * P * D;
  const float* xtl = a.xt + (size_t)(g / a.G) * M * D;
  const float* Fg = a.F + (size_t)g * M * M;
  const float* kfg = kf + (size_t)g * P * M;

  auto load_stage = [&](int s, int chunk) {
    float* st = ring + s * STAGE;
    load_tile<BP, BK, PITCH, T>(st, kfg, M, P, M, p0, chunk * BK, a.vec);
    load_tile<BM, BK, PITCH, T>(st + BP * PITCH, Fg, M, M, M, m0, chunk * BK, a.vec);
  };
  const int nk = (M + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load_stage(s, s);
    cp_async_commit();
  }

  // the epilogue's operands, staged while the first chunks arrive
  for (int e = tid; e < BP * DP; e += T) {
    const int i = e / DP, c = e - i * DP;
    xs[e] = p0 + i < P && c < D ? xsl[(size_t)(p0 + i) * D + c] : 0.f;
  }
  for (int e = tid; e < BM * DP; e += T) {
    const int m = e / DP, c = e - m * DP;
    Xs[e] = m0 + m < M && c < D ? xtl[(size_t)(m0 + m) * D + c] : 0.f;
  }
  for (int e = tid; e < BP; e += T) {
    const bool ok = p0 + e < P;
    g1s[e] = ok ? g1[(size_t)g * P + p0 + e] : 0.f;
    g2s[e] = ok ? g2[(size_t)g * P + p0 + e] : 0.f;
  }
  for (int e = tid; e < BM; e += T) {
    const bool ok = m0 + e < M;
    als[e] = ok ? a.alpha[(size_t)g * M + m0 + e] : 0.f;
    mks[e] = ok ? a.mask[(size_t)g * M + m0 + e] : 0.f;
  }

  float acc[TM][TN];
#pragma unroll
  for (int r = 0; r < TM; ++r)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[r][j] = 0.f;

  for (int ch = 0; ch < nk; ++ch) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (ch + STAGES - 1 < nk) load_stage((ch + STAGES - 1) % STAGES, ch + STAGES - 1);
    cp_async_commit();
    const float* Ak = ring + (ch % STAGES) * STAGE;
    const float* Bk = Ak + BP * PITCH;
#pragma unroll
    for (int q = 0; q < KS; q += 4) {
      const int k4 = slice * KS + q;
      float4 av[TM], bv[TN];
#pragma unroll
      for (int r = 0; r < TM; ++r) av[r] = *reinterpret_cast<const float4*>(Ak + (ty * TM + r) * PITCH + k4);
#pragma unroll
      for (int j = 0; j < TN; ++j) bv[j] = *reinterpret_cast<const float4*>(Bk + (tx + j * TX) * PITCH + k4);
#pragma unroll
      for (int r = 0; r < TM; ++r)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          float v = acc[r][j];
          v = fmaf(av[r].x, bv[j].x, v);
          v = fmaf(av[r].y, bv[j].y, v);
          v = fmaf(av[r].z, bv[j].z, v);
          acc[r][j] = fmaf(av[r].w, bv[j].w, v);
        }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free for the sums below
  gather_slices<SLICES, K2_TILE_T>(acc, ring, slice, t);

  // chain rule for the (i, m) pairs of the slice's rows; points past M have
  // mask 0
  const float lam = a.se_lam[g];
  float* red = ring + XCH;  // the sums over the tile's points: red[i][tx][c]
  float w[DP], p1[DP], pa[DP], pb[DP];
#pragma unroll
  for (int c = 0; c < DP; ++c) {
    const bool in = c < D;
    w[c] = in ? a.se_w[g * D + c] : 0.f;
    if (POLY) {
      p1[c] = in ? a.poly1[g * (D + 1) + c] : 0.f;
      pa[c] = in ? a.poly2a[g * D + c] : 0.f;
      pb[c] = in ? a.poly2b[g * D + c] : 0.f;
    }
  }
  float part[TM][DP];
#pragma unroll
  for (int r = 0; r < TM; ++r) {
    if (r / RPS != slice) continue;
    const int i = ty * TM + r;
    const float* xi = xs + i * DP;
    const float h1 = g1s[i], h2 = 2.f * g2s[i];
#pragma unroll
    for (int c = 0; c < DP; ++c) part[r][c] = 0.f;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int m = tx + j * TX;
      const float* xm = Xs + m * DP;
      const float kbar = (h1 * als[m] + h2 * acc[r][j]) * mks[m];
      float d = 0.f, a2 = 0.f, b2 = 0.f;
#pragma unroll
      for (int c = 0; c < DP; ++c) {
        const float df = xi[c] - xm[c];
        d = fmaf(w[c] * df, df, d);
        if (POLY) {
          const float xx = xi[c] * xm[c];
          a2 = fmaf(pa[c], xx, a2);
          b2 = fmaf(pb[c], xx, b2);
        }
      }
      const float dbar2 = -2.f * kbar * lam * expf(-d);  // 2 * dbar
#pragma unroll
      for (int c = 0; c < DP; ++c) {
        float v = w[c] * dbar2 * (xi[c] - xm[c]);
        if (POLY) v = fmaf(kbar * xm[c], p1[c] + pa[c] * b2 + pb[c] * a2, v);
        part[r][c] += v;
      }
    }
  }

  // sum over the tile's points: red[i][tx][c], then TX values per (i, c)
#pragma unroll
  for (int r = 0; r < TM; ++r)
    if (r / RPS == slice)
#pragma unroll
      for (int c = 0; c < DP; ++c) red[((ty * TM + r) * TX + tx) * DP + c] = part[r][c];
  __syncthreads();
  for (int e = tid; e < BP * D; e += T) {
    const int i = e / D, c = e - i * D;
    if (p0 + i >= P) continue;
    float s = 0.f;
    for (int t = 0; t < TX; ++t) s += red[(i * TX + t) * DP + c];
    dxp[(((size_t)g * gridDim.x + mt) * P + p0 + i) * D + c] = s;
  }
}

// K1, wide: the generation.  Block (mt, pt, g): particles [pt*GEN_BP, +GEN_BP)
// x training points [mt*GEN_BM, +GEN_BM).  The block's rows of x* and X_tr
// are contiguous in memory and are staged by coalesced (16-byte where D % 4
// == 0) reads, transposed to
// dim-major rows with a pitch of 4 floats over the tile (float4-aligned,
// the transposing stores spread over 8 banks).  Thread (ty, tx) owns
// particles tx*4..+4 and points ty*4..+4: per dim it reads one float4 of
// particle values, one of point values and the dim's weight (and the three
// pre-scaled particle float4s of the polynomial terms), for 16 pairs.  It
// writes the masked k* transposed, kt[g][m][i] (a warp's stores are whole
// 128-byte rows), and kalpha's partial over the block's points to
// kapart[g][mt][p]: each thread's 4 points in order, the 4 point groups of
// a warp by a fixed butterfly, then the warps in order.
template <bool POLY>
__global__ void __launch_bounds__(GEN_THREADS)
k1_gen(Args a, int Pp, float* __restrict__ kt, float* __restrict__ kapart) {
  constexpr int BP = GEN_BP, BM = GEN_BM, T = GEN_THREADS, DP = MAX_D, TX = BP / TM;
  constexpr int XRP = BP + 4, XMP = BM + 4;  // the dim-major rows' pitches
  __shared__ __align__(16) float xr[DP * XRP];                 // particle values [c][i]
  __shared__ __align__(16) float pr[POLY ? 3 * DP * XRP : 4];  // p1, p2a, p2b x them [q][c][i]
  __shared__ __align__(16) float xm[DP * XMP];                 // point values [c][m]
  __shared__ float hw[4 * DP], msk[BM], alp[BM], red[T / 32][BP];  // hw: w, p1, p2a, p2b

  const int M = a.M, D = a.D, P = a.P, g = blockIdx.z;
  const int mt = blockIdx.x, m0 = mt * BM, p0 = blockIdx.y * BP;
  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  const float* xs = a.xs + ((size_t)(g / a.G) * P + p0) * D;  // the block's rows
  const float* xt = a.xt + ((size_t)(g / a.G) * M + m0) * D;
  const int np = min(BP, P - p0), nm = min(BM, M - m0);

  if (D % 4 == 0 && ((size_t)xs & 15) == 0 && ((size_t)xt & 15) == 0) {
    // 16-byte loads: a vector never straddles two rows
#pragma unroll 2
    for (int e = 4 * tid; e < BP * D; e += 4 * T) {
      const int i = e / D, c = e - i * D;
      const float4 v = i < np ? *reinterpret_cast<const float4*>(xs + e) : make_float4(0.f, 0.f, 0.f, 0.f);
      xr[c * XRP + i] = v.x, xr[(c + 1) * XRP + i] = v.y;
      xr[(c + 2) * XRP + i] = v.z, xr[(c + 3) * XRP + i] = v.w;
    }
#pragma unroll 4
    for (int e = 4 * tid; e < BM * D; e += 4 * T) {
      const int m = e / D, c = e - m * D;
      const float4 v = m < nm ? *reinterpret_cast<const float4*>(xt + e) : make_float4(0.f, 0.f, 0.f, 0.f);
      xm[c * XMP + m] = v.x, xm[(c + 1) * XMP + m] = v.y;
      xm[(c + 2) * XMP + m] = v.z, xm[(c + 3) * XMP + m] = v.w;
    }
  } else {
#pragma unroll 4
    for (int e = tid; e < BP * D; e += T) {
      const int i = e / D, c = e - i * D;
      xr[c * XRP + i] = i < np ? xs[e] : 0.f;
    }
#pragma unroll 4
    for (int e = tid; e < BM * D; e += T) {
      const int m = e / D, c = e - m * D;
      xm[c * XMP + m] = m < nm ? xt[e] : 0.f;
    }
  }
  for (int e = tid; e < D; e += T) {
    hw[e] = a.se_w[g * D + e];
    if (POLY) {
      hw[DP + e] = a.poly1[g * (D + 1) + e];
      hw[2 * DP + e] = a.poly2a[g * D + e];
      hw[3 * DP + e] = a.poly2b[g * D + e];
    }
  }
  for (int e = tid; e < BM; e += T) {
    const bool ok = e < nm;
    msk[e] = ok ? a.mask[(size_t)g * M + m0 + e] : 0.f;
    alp[e] = ok ? a.alpha[(size_t)g * M + m0 + e] : 0.f;
  }
  __syncthreads();
  if (POLY) {
    // the polynomial factors applied once per particle and dim
#pragma unroll 4
    for (int e = tid; e < BP * D; e += T) {
      const int c = e / BP, i = e - c * BP;
      const float x = xr[c * XRP + i];
      pr[c * XRP + i] = hw[DP + c] * x;
      pr[(DP + c) * XRP + i] = hw[2 * DP + c] * x;
      pr[(2 * DP + c) * XRP + i] = hw[3 * DP + c] * x;
    }
    __syncthreads();
  }

  const float p1off = POLY ? a.poly1[g * (D + 1) + D] : 0.f;
  float d[TM][TN], lin[TM][TN], a2[TM][TN], b2[TM][TN];  // distance and polynomial terms
#pragma unroll
  for (int r = 0; r < TM; ++r)
#pragma unroll
    for (int j = 0; j < TN; ++j) d[r][j] = 0.f, lin[r][j] = p1off, a2[r][j] = 0.f, b2[r][j] = 0.f;
#pragma unroll 2
  for (int c = 0; c < D; ++c) {
    const float4 xv = *reinterpret_cast<const float4*>(&xr[c * XRP + tx * TM]);
    const float4 mv = *reinterpret_cast<const float4*>(&xm[c * XMP + ty * TN]);
    const float wc = hw[c];
    const float x[TM] = {xv.x, xv.y, xv.z, xv.w}, X[TN] = {mv.x, mv.y, mv.z, mv.w};
#pragma unroll
    for (int r = 0; r < TM; ++r)
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const float df = x[r] - X[j];
        d[r][j] = fmaf(wc * df, df, d[r][j]);
      }
    if (POLY) {
      const float4 v1 = *reinterpret_cast<const float4*>(&pr[c * XRP + tx * TM]);
      const float4 va = *reinterpret_cast<const float4*>(&pr[(DP + c) * XRP + tx * TM]);
      const float4 vb = *reinterpret_cast<const float4*>(&pr[(2 * DP + c) * XRP + tx * TM]);
      const float u1[TM] = {v1.x, v1.y, v1.z, v1.w}, ua[TM] = {va.x, va.y, va.z, va.w},
                  ub[TM] = {vb.x, vb.y, vb.z, vb.w};
#pragma unroll
      for (int r = 0; r < TM; ++r)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          lin[r][j] = fmaf(u1[r], X[j], lin[r][j]);
          a2[r][j] = fmaf(ua[r], X[j], a2[r][j]);
          b2[r][j] = fmaf(ub[r], X[j], b2[r][j]);
        }
    }
  }

  const float lam = a.se_lam[g];
  float* ktg = kt + (size_t)g * M * Pp;
  float ka[TM] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    const int m = ty * TN + j;
    float k[TM];
#pragma unroll
    for (int r = 0; r < TM; ++r) {
      float v = lam * expf(-d[r][j]);
      if (POLY) v += lin[r][j] + a2[r][j] * b2[r][j];
      v = p0 + tx * TM + r < P ? v * msk[m] : 0.f;
      k[r] = v;
      ka[r] = fmaf(v, alp[m], ka[r]);
    }
    if (m0 + m < M)
      *reinterpret_cast<float4*>(ktg + (size_t)(m0 + m) * Pp + p0 + tx * TM) =
          make_float4(k[0], k[1], k[2], k[3]);
  }
  // a warp holds 32 / TX point groups of the same particles
#pragma unroll
  for (int r = 0; r < TM; ++r)
#pragma unroll
    for (int o = TX; o < 32; o <<= 1) ka[r] += __shfl_xor_sync(0xffffffffu, ka[r], o);
  if (tid % 32 < TX)
#pragma unroll
    for (int r = 0; r < TM; ++r) red[tid / 32][tx * TM + r] = ka[r];
  __syncthreads();
  if (tid < BP && p0 + tid < P) {
    float s = 0.f;
    for (int w = 0; w < T / 32; ++w) s += red[w][tid];
    kapart[((size_t)g * gridDim.x + mt) * P + p0 + tid] = s;
  }
}

// K1, wide: the GEMM kF = k* F.  Block (nt, pt, g): particles [pt*BP, +BP)
// x F's columns [nt*BN, +BN); both operands are k-major ([kk][i] from kt,
// [kk][n] from F), so a thread's 4 x 4 micro-tile reads one float4 of each
// per kk.  kalpha comes from k1_gen.
template <int BP, int BN, int SLICES>
__global__ void __launch_bounds__(SLICES * (BP / TM) * (BN / TN))
k1_forward_wide(const float* __restrict__ kt, const float* __restrict__ F, int P, int M, int Pp,
                bool vec, float* __restrict__ qpart, float* __restrict__ kf) {
  constexpr int BK = WIDE_BK, TX = BN / TN, TILE_T = (BP / TM) * TX, T = SLICES * TILE_T;
  constexpr int KS = BK / SLICES, STAGE = BK * (BP + BN);
  static_assert(TILE_T % 32 == 0 && TX <= 32 && 32 % TX == 0 && TM % SLICES == 0 &&
                    BK % SLICES == 0, "a slice is whole warps and whole micro-tile rows");
  static_assert(SLICES * TM * TN * TILE_T <= STAGES * STAGE, "the slices' sum reuses the ring");
  __shared__ __align__(16) float ring[STAGES * STAGE];  // per stage: k* [kk][i], F [kk][n]

  const int g = blockIdx.z, nt = blockIdx.x, n0 = nt * BN, p0 = blockIdx.y * BP;
  const int tid = threadIdx.x, slice = tid / TILE_T, t = tid % TILE_T;
  const int tx = t % TX, ty = t / TX;
  const float* ktg = kt + (size_t)g * M * Pp;
  const float* Fg = F + (size_t)g * M * M;

  auto load_stage = [&](int s, int chunk) {
    float* st = ring + s * STAGE;
    load_tile<BK, BP, BP, T>(st, ktg, Pp, M, Pp, chunk * BK, p0, true);
    load_tile<BK, BN, BN, T>(st + BK * BP, Fg, M, M, M, chunk * BK, n0, vec);
  };
  float acc[TM][TN];
#pragma unroll
  for (int r = 0; r < TM; ++r)
#pragma unroll
    for (int c = 0; c < TN; ++c) acc[r][c] = 0.f;

  const int nk = (M + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load_stage(s, s);
    cp_async_commit();
  }
  for (int ch = 0; ch < nk; ++ch) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (ch + STAGES - 1 < nk) load_stage((ch + STAGES - 1) % STAGES, ch + STAGES - 1);
    cp_async_commit();
    const float* As = ring + (ch % STAGES) * STAGE;
    const float* Bs = As + BK * BP;
#pragma unroll
    for (int q = 0; q < KS; ++q) {
      const int kk = slice * KS + q;
      const float4 av = *reinterpret_cast<const float4*>(&As[kk * BP + ty * TM]);
      const float4 bv = *reinterpret_cast<const float4*>(&Bs[kk * BN + tx * TN]);
      const float ar[TM] = {av.x, av.y, av.z, av.w}, br[TN] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int r = 0; r < TM; ++r)
#pragma unroll
        for (int c = 0; c < TN; ++c) acc[r][c] = fmaf(ar[r], br[c], acc[r][c]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free
  gather_slices<SLICES, TILE_T>(acc, ring, slice, t);

  // quad: this tile's sum of squares per row, over the TX threads of a row;
  // each slice finishes its rows
  constexpr int RPS = TM / SLICES;
#pragma unroll
  for (int r = 0; r < TM; ++r) {
    if (r / RPS != slice) continue;
    float s = 0.f;
#pragma unroll
    for (int c = 0; c < TN; ++c) s = fmaf(acc[r][c], acc[r][c], s);
#pragma unroll
    for (int o = TX / 2; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    const int row = p0 + ty * TM + r;
    if (tx == 0 && row < P) qpart[((size_t)g * gridDim.x + nt) * P + row] = s;
  }
  if (kf == nullptr) return;
  const int n = n0 + tx * TN;
#pragma unroll
  for (int r = 0; r < TM; ++r) {
    const int row = p0 + ty * TM + r;
    if (r / RPS != slice || row >= P) continue;
    float* dst = kf + ((size_t)g * P + row) * M;
    if (vec) {
      if (n < M) *reinterpret_cast<float4*>(dst + n) = make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
    } else {
#pragma unroll
      for (int c = 0; c < TN; ++c)
        if (n + c < M) dst[n + c] = acc[r][c];
    }
  }
}

// K2, wide.  Block (mt, pt, g): particles [pt*BP, +BP) x training points
// [mt*BM, +BM); the mainloop is the narrow K2's, the rows of x* and X_tr
// staged while the first chunks arrive.  After it each thread forms d, a2,
// b2 for its pairs (the slice's rows of its micro-tile x its 4 points; per
// dim one value per row and per point), the pairs' scalars go to shared
// memory and the [BP, BM] x [BM, D] products run with each thread owning a
// row and 4 dims of the tile's dx* at a time.  MINB: the blocks per SM the
// registers must leave room for (a whole grid resident at once).
template <bool POLY, int BP, int BM, int SLICES, int MINB>
__global__ void __launch_bounds__(SLICES * (BP / TM) * (BM / TN), MINB)
k2_backward_xstar_wide(Args a, const float* __restrict__ kf, const float* __restrict__ g1,
                       const float* __restrict__ g2, float* __restrict__ dxp) {
  constexpr int BK = WIDE_BK, TX = BM / TN, TILE_T = (BP / TM) * TX, T = SLICES * TILE_T;
  constexpr int KS = BK / SLICES, RPS = TM / SLICES, DP = MAX_D;
  constexpr int PITCH = BK + 4, STAGE = (BP + BM) * PITCH;
  constexpr int NQ = POLY ? 4 : 1, SP = BM * NQ + (POLY ? 4 : 1);  // the scalars [i][m][q]
  constexpr int XCH = SLICES * TM * TN * TILE_T;
  static_assert(TILE_T % 32 == 0 && TX <= 32 && 32 % TX == 0 && TM % SLICES == 0 &&
                    BK % (4 * SLICES) == 0, "a slice is whole warps, rows and chunk columns");
  static_assert(XCH <= STAGES * STAGE && BP * SP <= STAGES * STAGE,
                "the epilogue's buffers reuse the ring");
  __shared__ __align__(16) float ring[STAGES * STAGE];  // per stage: kF [BP][PITCH], F [BM][PITCH]
  __shared__ float xs[BP * XSPITCH];                    // particle rows [i][c], dims >= D zero
  __shared__ __align__(16) float Xs[BM * XPITCH];       // point rows [m][c]
  __shared__ float hw[4 * DP];                          // w, poly1, poly2a, poly2b [q][c]
  __shared__ float g1s[BP], g2s[BP], als[BM], mks[BM], rs[BP];

  const int M = a.M, D = a.D, P = a.P, g = blockIdx.z;
  const int mt = blockIdx.x, m0 = mt * BM, p0 = blockIdx.y * BP;
  const int tid = threadIdx.x, slice = tid / TILE_T, t = tid % TILE_T;
  const int tx = t % TX, ty = t / TX;
  const float* xsl = a.xs + (size_t)(g / a.G) * P * D;
  const float* xtl = a.xt + (size_t)(g / a.G) * M * D;
  const float* Fg = a.F + (size_t)g * M * M;
  const float* kfg = kf + (size_t)g * P * M;

  auto load_stage = [&](int s, int chunk) {
    float* st = ring + s * STAGE;
    load_tile<BP, BK, PITCH, T>(st, kfg, M, P, M, p0, chunk * BK, a.vec);
    load_tile<BM, BK, PITCH, T>(st + BP * PITCH, Fg, M, M, M, m0, chunk * BK, a.vec);
  };
  const int nk = (M + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load_stage(s, s);
    cp_async_commit();
  }

  for (int e = tid; e < BP * XSPITCH; e += T) {
    const int i = e / XSPITCH, c = e - i * XSPITCH;
    xs[e] = p0 + i < P && c < D ? xsl[(size_t)(p0 + i) * D + c] : 0.f;
  }
  for (int e = tid; e < BM * XPITCH; e += T) {
    const int m = e / XPITCH, c = e - m * XPITCH;
    Xs[e] = m0 + m < M && c < D ? xtl[(size_t)(m0 + m) * D + c] : 0.f;
  }
  for (int e = tid; e < 4 * DP; e += T) {
    const int q = e / DP, c = e - q * DP;
    float v = 0.f;
    if (c < D) {
      if (q == 0) v = a.se_w[g * D + c];
      else if (POLY && q == 1) v = a.poly1[g * (D + 1) + c];
      else if (POLY && q == 2) v = a.poly2a[g * D + c];
      else if (POLY) v = a.poly2b[g * D + c];
    }
    hw[e] = v;
  }
  for (int e = tid; e < BP; e += T) {
    const bool ok = p0 + e < P;
    g1s[e] = ok ? g1[(size_t)g * P + p0 + e] : 0.f;
    g2s[e] = ok ? g2[(size_t)g * P + p0 + e] : 0.f;
  }
  for (int e = tid; e < BM; e += T) {
    const bool ok = m0 + e < M;
    als[e] = ok ? a.alpha[(size_t)g * M + m0 + e] : 0.f;
    mks[e] = ok ? a.mask[(size_t)g * M + m0 + e] : 0.f;
  }

  float acc[TM][TN];
#pragma unroll
  for (int r = 0; r < TM; ++r)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[r][j] = 0.f;
  for (int ch = 0; ch < nk; ++ch) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (ch + STAGES - 1 < nk) load_stage((ch + STAGES - 1) % STAGES, ch + STAGES - 1);
    cp_async_commit();
    const float* Ak = ring + (ch % STAGES) * STAGE;
    const float* Bk = Ak + BP * PITCH;
#pragma unroll
    for (int q = 0; q < KS; q += 4) {
      const int k4 = slice * KS + q;
      float4 av[TM], bv[TN];
#pragma unroll
      for (int r = 0; r < TM; ++r) av[r] = *reinterpret_cast<const float4*>(Ak + (ty * TM + r) * PITCH + k4);
#pragma unroll
      for (int j = 0; j < TN; ++j) bv[j] = *reinterpret_cast<const float4*>(Bk + (tx + j * TX) * PITCH + k4);
#pragma unroll
      for (int r = 0; r < TM; ++r)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          float v = acc[r][j];
          v = fmaf(av[r].x, bv[j].x, v);
          v = fmaf(av[r].y, bv[j].y, v);
          v = fmaf(av[r].z, bv[j].z, v);
          acc[r][j] = fmaf(av[r].w, bv[j].w, v);
        }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free
  gather_slices<SLICES, TILE_T>(acc, ring, slice, t);
  __syncthreads();  // every slice has read its partners' partials

  // d, a2, b2 of this thread's pairs: rows ty*4 + slice*RPS + rr, points
  // tx + j*TX; per dim RPS + TN values and the dim's factors
  float dd[RPS][TN], aa[RPS][TN], bb[RPS][TN];
#pragma unroll
  for (int rr = 0; rr < RPS; ++rr)
#pragma unroll
    for (int j = 0; j < TN; ++j) dd[rr][j] = 0.f, aa[rr][j] = 0.f, bb[rr][j] = 0.f;
  const int r0 = ty * TM + slice * RPS;
#pragma unroll 2
  for (int c = 0; c < D; ++c) {
    const float wc = hw[c];
    float x[RPS], X[TN];
#pragma unroll
    for (int rr = 0; rr < RPS; ++rr) x[rr] = xs[(r0 + rr) * XSPITCH + c];
#pragma unroll
    for (int j = 0; j < TN; ++j) X[j] = Xs[(tx + j * TX) * XPITCH + c];
#pragma unroll
    for (int rr = 0; rr < RPS; ++rr) {
      const float xa = POLY ? hw[2 * DP + c] * x[rr] : 0.f;
      const float xb = POLY ? hw[3 * DP + c] * x[rr] : 0.f;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const float df = x[rr] - X[j];
        dd[rr][j] = fmaf(wc * df, df, dd[rr][j]);
        if (POLY) {
          aa[rr][j] = fmaf(xa, X[j], aa[rr][j]);
          bb[rr][j] = fmaf(xb, X[j], bb[rr][j]);
        }
      }
    }
  }


  // the pairs' scalars S[i][m][q]: dbar, and for the polynomial terms kbar,
  // kbar b2, kbar a2; rs[i], dbar's sum over the tile's points (each thread
  // over its 4 points, then the TX threads of the row by a fixed butterfly)
  const float lam = a.se_lam[g];
  float* S = ring;
#pragma unroll
  for (int r = 0; r < TM; ++r) {
    // a compile-time row of acc (a runtime one would put acc in local memory)
    if (r / RPS != slice) continue;
    const int rr = r % RPS, i = r0 + rr;
    const float h1 = g1s[i], h2 = 2.f * g2s[i];
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int m = tx + j * TX;
      const float kbar = (h1 * als[m] + h2 * acc[r][j]) * mks[m];
      const float dbar = -kbar * (lam * expf(-dd[rr][j]));
      sum += dbar;
      if constexpr (POLY)
        *reinterpret_cast<float4*>(S + i * SP + m * 4) =
            make_float4(dbar, kbar, kbar * bb[rr][j], kbar * aa[rr][j]);
      else
        S[i * SP + m] = dbar;
    }
#pragma unroll
    for (int o = TX / 2; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    if (tx == 0) rs[i] = sum;
  }
  __syncthreads();

  // dx*[i][c0..c0+4) over the tile's points, in order; the items are the
  // rows x the groups of 4 dims in use
  const int CG = (D + 3) / 4;
  for (int e = tid; e < BP * CG; e += T) {
    const int i = e / CG, c0 = (e - i * CG) * 4;
    if (p0 + i >= P) continue;
    float o[NQ][4];
#pragma unroll
    for (int q = 0; q < NQ; ++q)
#pragma unroll
      for (int c = 0; c < 4; ++c) o[q][c] = 0.f;
#pragma unroll 4
    for (int m = 0; m < BM; ++m) {
      const float4 X4 = *reinterpret_cast<const float4*>(Xs + m * XPITCH + c0);
      const float X[4] = {X4.x, X4.y, X4.z, X4.w};
      float sq[NQ];
      if constexpr (POLY) {
        const float4 s4 = *reinterpret_cast<const float4*>(S + i * SP + m * 4);
        sq[0] = s4.x, sq[1] = s4.y, sq[2] = s4.z, sq[3] = s4.w;
      } else {
        sq[0] = S[i * SP + m];
      }
#pragma unroll
      for (int q = 0; q < NQ; ++q)
#pragma unroll
        for (int c = 0; c < 4; ++c) o[q][c] = fmaf(sq[q], X[c], o[q][c]);
    }
    float* dst = dxp + (((size_t)g * gridDim.x + mt) * P + p0 + i) * D;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int cc = c0 + c;
      if (cc >= D) break;
      float v = 2.f * hw[cc] * (xs[i * XSPITCH + cc] * rs[i] - o[0][c]);
      if constexpr (POLY)
        v += hw[DP + cc] * o[1][c] + hw[2 * DP + cc] * o[2][c] + hw[3 * DP + cc] * o[3][c];
      dst[cc] = v;
    }
  }
}

Args make_args(const float* se_w, const float* se_lam, const float* poly1, const float* poly2a,
               const float* poly2b, const float* xs, const float* xt, const float* alpha,
               const float* F, const float* mask, int G, int P, int M, int D, int vec) {
  Args a;
  a.se_w = se_w; a.se_lam = se_lam; a.poly1 = poly1; a.poly2a = poly2a; a.poly2b = poly2b;
  a.xs = xs; a.xt = xt; a.alpha = alpha; a.F = F; a.mask = mask;
  a.G = G; a.P = P; a.M = M; a.D = D; a.vec = vec != 0;
  return a;
}

// out[b, n] = sum over t of part[b, t, n], t in increasing order: one thread
// per output, so the sum's order depends on nothing but T.
__global__ void sum_partials(const float* __restrict__ part, float* __restrict__ out, int B, int T,
                             int N) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)B * N) return;
  const size_t b = i / N, n = i - b * N;
  const float* p = part + b * T * N + n;
  float s = 0.f;
  for (int t = 0; t < T; ++t) s += p[(size_t)t * N];
  out[i] = s;
}

// The same for two sets of partials in one launch (the wide K1's kalpha
// over ta point tiles and quad over tb column tiles).
__global__ void sum_partials2(const float* __restrict__ pa, float* __restrict__ oa, int ta,
                              const float* __restrict__ pb, float* __restrict__ ob, int tb, int B,
                              int N) {
  size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t n_out = (size_t)B * N;
  if (i >= 2 * n_out) return;
  const bool second = i >= n_out;
  if (second) i -= n_out;
  const int T = second ? tb : ta;
  const size_t b = i / N, n = i - b * N;
  const float* p = (second ? pb : pa) + b * T * N + n;
  float s = 0.f;
  for (int t = 0; t < T; ++t) s += p[(size_t)t * N];
  (second ? ob : oa)[i] = s;
}

void launch_sum(const float* part, float* out, int B, int T, int N, cudaStream_t s) {
  const size_t n = (size_t)B * N;
  sum_partials<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(part, out, B, T, N);
}

template <int DP, bool POLY>
void launch_k1(const Args& a, int L, float* kalpha, float* qpart, float* kf, cudaStream_t s) {
  const dim3 grid((a.M + K1_BN - 1) / K1_BN, (a.P + K1_BP - 1) / K1_BP, L * a.G);
  k1_forward<DP, POLY><<<grid, K1_THREADS, 0, s>>>(a, kalpha, qpart, kf);
}

template <int DP, bool POLY>
void launch_k2(const Args& a, int L, const float* kf, const float* g1, const float* g2, float* dxp,
               cudaStream_t s) {
  const dim3 grid((a.M + K2_BM - 1) / K2_BM, (a.P + K2_BP - 1) / K2_BP, L * a.G);
  k2_backward_xstar<DP, POLY><<<grid, K2_THREADS, 0, s>>>(a, kf, g1, g2, dxp);
}

int padded_p(int P) { return (P + GEN_BP - 1) / GEN_BP * GEN_BP; }

template <bool POLY>
void launch_gen(const Args& a, int L, float* kt, float* kapart, cudaStream_t s) {
  const dim3 grid((a.M + GEN_BM - 1) / GEN_BM, padded_p(a.P) / GEN_BP, L * a.G);
  k1_gen<POLY><<<grid, GEN_THREADS, 0, s>>>(a, padded_p(a.P), kt, kapart);
}

// the wide GEMM of configuration cfg; returns its column tile's width
int launch_k1_wide(const Args& a, int L, int cfg, const float* kt, float* qpart, float* kf,
                   cudaStream_t s) {
  switch (cfg) {
#define LAUNCH_K1(i, bp, bn, sl)                                                         \
  case i: {                                                                              \
    const dim3 grid((a.M + bn - 1) / bn, (a.P + bp - 1) / bp, L * a.G);                  \
    k1_forward_wide<bp, bn, sl><<<grid, sl * (bp / TM) * (bn / TN), 0, s>>>(             \
        kt, a.F, a.P, a.M, padded_p(a.P), a.vec, qpart, kf);                             \
    return bn;                                                                           \
  }
    WIDE_K1_CONFIGS(LAUNCH_K1)
#undef LAUNCH_K1
  }
  return 0;
}

// Launch K2-wide of configuration cfg; returns its point tile's width.
template <bool POLY>
int launch_k2_wide(const Args& a, int L, int cfg, const float* kf, const float* g1,
                   const float* g2, float* dxp, cudaStream_t s) {
  switch (cfg) {
#define LAUNCH_K2(i, bp, bm, sl, minb)                                                   \
  case i: {                                                                              \
    const dim3 grid((a.M + bm - 1) / bm, (a.P + bp - 1) / bp, L * a.G);                  \
    k2_backward_xstar_wide<POLY, bp, bm, sl, minb>                                       \
        <<<grid, sl * (bp / TM) * (bm / TN), 0, s>>>(a, kf, g1, g2, dxp);                \
    return bm;                                                                           \
  }
    WIDE_K2_CONFIGS(LAUNCH_K2)
#undef LAUNCH_K2
  }
  return 0;
}

}  // namespace

extern "C" {

// Tile sizes, for the caller's partial-sum buffers and its check of its
// plan: {K1 particles, K1 columns of F, K2 particles, K2 training points}
// of the narrow path, then k1_gen's {particles, training points}, the
// number of k1_forward_wide configurations and each one's {particles,
// columns, slices}, then the number of k2_backward_xstar_wide's and each
// one's {particles, points, slices, blocks per SM}; n ints at most.  Returns
// the count written.
int fp_tiles(int* out, int n) {
  int v[8 + 3 * N_WIDE_K1 + 4 * N_WIDE_K2];
  int k = 0;
  v[k++] = K1_BP; v[k++] = K1_BN; v[k++] = K2_BP; v[k++] = K2_BM;
  v[k++] = GEN_BP; v[k++] = GEN_BM;
  v[k++] = N_WIDE_K1;
#define TILE_K1(i, bp, bn, sl) v[k++] = bp; v[k++] = bn; v[k++] = sl;
#define TILE_K2(i, bp, bm, sl, minb) v[k++] = bp; v[k++] = bm; v[k++] = sl; v[k++] = minb;
  WIDE_K1_CONFIGS(TILE_K1)
  v[k++] = N_WIDE_K2;
  WIDE_K2_CONFIGS(TILE_K2)
#undef TILE_K1
#undef TILE_K2
  for (int i = 0; i < k && i < n; ++i) out[i] = v[i];
  return k;
}

// K1 over L lanes, then the sum of its partials.  Every array has the lane
// axis in front: kalpha and quad [L, G, P]; kf [L, G, P, M] or null.
// Narrow (D <= 8): qpart [L, G, ceil(M / K1_BN), P]; kt, kapart and cfg
// unused.  Wide: cfg indexes WIDE_K1_CONFIGS, qpart [L, G, ceil(M / BN of
// cfg), P], kt [L, G, M, Pp] (Pp = P rounded up to GEN_BP), kapart
// [L, G, ceil(M / GEN_BM), P].  Returns a cudaError_t: 0 when every launch
// was accepted.
int fp_forward(const float* se_w, const float* se_lam, const float* poly1, const float* poly2a,
               const float* poly2b, const float* xs, const float* xt, const float* alpha,
               const float* F, const float* mask, float* kalpha, float* qpart, float* quad,
               float* kf, float* kt, float* kapart, int L, int G, int P, int M, int D,
               int use_poly, int vec, int cfg, void* stream) {
  if (D < 1 || D > MAX_D || L < 1 || L * G > 65535) return (int)cudaErrorInvalidValue;
  const Args a = make_args(se_w, se_lam, poly1, poly2a, poly2b, xs, xt, alpha, F, mask, G, P, M, D, vec);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= NARROW_D) {
    if (D <= 6) {
      if (use_poly) launch_k1<6, true>(a, L, kalpha, qpart, kf, s);
      else launch_k1<6, false>(a, L, kalpha, qpart, kf, s);
    } else {
      if (use_poly) launch_k1<NARROW_D, true>(a, L, kalpha, qpart, kf, s);
      else launch_k1<NARROW_D, false>(a, L, kalpha, qpart, kf, s);
    }
    const int err = (int)cudaGetLastError();
    if (err != 0) return err;
    launch_sum(qpart, quad, L * G, (M + K1_BN - 1) / K1_BN, P, s);
    return (int)cudaGetLastError();
  }
  if (cfg < 0 || cfg >= N_WIDE_K1 || kt == nullptr || kapart == nullptr)
    return (int)cudaErrorInvalidValue;
  if (use_poly) launch_gen<true>(a, L, kt, kapart, s);
  else launch_gen<false>(a, L, kt, kapart, s);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  const int bn = launch_k1_wide(a, L, cfg, kt, qpart, kf, s);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  const size_t n = 2 * (size_t)L * G * P;
  sum_partials2<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(
      kapart, kalpha, (M + GEN_BM - 1) / GEN_BM, qpart, quad, (M + bn - 1) / bn, L * G, P);
  return (int)cudaGetLastError();
}

// The wide path's generation alone (k1_gen, then the sum of kalpha's
// partials): kt [L, G, M, Pp], kapart [L, G, ceil(M / GEN_BM), P], kalpha
// [L, G, P]; F may be null.  Any D up to MAX_D.
int fp_gen(const float* se_w, const float* se_lam, const float* poly1, const float* poly2a,
           const float* poly2b, const float* xs, const float* xt, const float* alpha,
           const float* mask, float* kt, float* kapart, float* kalpha, int L, int G, int P, int M,
           int D, int use_poly, void* stream) {
  if (D < 1 || D > MAX_D || L < 1 || L * G > 65535) return (int)cudaErrorInvalidValue;
  const Args a = make_args(se_w, se_lam, poly1, poly2a, poly2b, xs, xt, alpha, nullptr, mask, G, P,
                           M, D, 0);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (use_poly) launch_gen<true>(a, L, kt, kapart, s);
  else launch_gen<false>(a, L, kt, kapart, s);
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  launch_sum(kapart, kalpha, L * G, (M + GEN_BM - 1) / GEN_BM, P, s);
  return (int)cudaGetLastError();
}

// K2 over L lanes, then the sum of its partials over heads and point tiles.
// kf is K1's [L, G, P, M]; g1, g2 [L, G, P]; dx [L, P, D]; dxp, scratch,
// [L, G, ceil(M / BM), P, D] with BM K2_BM (narrow) or cfg's (wide, cfg
// indexes WIDE_K2_CONFIGS).
int fp_backward_xstar(const float* se_w, const float* se_lam, const float* poly1,
                      const float* poly2a, const float* poly2b, const float* xs,
                      const float* xt, const float* alpha, const float* F, const float* mask,
                      const float* kf, const float* g1, const float* g2, float* dxp, float* dx,
                      int L, int G, int P, int M, int D, int use_poly, int vec, int cfg,
                      void* stream) {
  if (D < 1 || D > MAX_D || L < 1 || L * G > 65535) return (int)cudaErrorInvalidValue;
  const Args a = make_args(se_w, se_lam, poly1, poly2a, poly2b, xs, xt, alpha, F, mask, G, P, M, D, vec);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int bm = K2_BM;
  if (D <= 6) {
    if (use_poly) launch_k2<6, true>(a, L, kf, g1, g2, dxp, s);
    else launch_k2<6, false>(a, L, kf, g1, g2, dxp, s);
  } else if (D <= NARROW_D) {
    if (use_poly) launch_k2<NARROW_D, true>(a, L, kf, g1, g2, dxp, s);
    else launch_k2<NARROW_D, false>(a, L, kf, g1, g2, dxp, s);
  } else {
    if (cfg < 0 || cfg >= N_WIDE_K2) return (int)cudaErrorInvalidValue;
    bm = use_poly ? launch_k2_wide<true>(a, L, cfg, kf, g1, g2, dxp, s)
                  : launch_k2_wide<false>(a, L, cfg, kf, g1, g2, dxp, s);
  }
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  launch_sum(dxp, dx, L, G * ((M + bm - 1) / bm), P * D, s);
  return (int)cudaGetLastError();
}

const char* fp_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
