// Fused multi-head GP posterior prediction for Hopper (sm_90a), fp32 FFMA.
//
// K1 k1_forward replaces the TPU kernel fused_gram_contract
//    (mcpilco_tpu/ops/fused_predict.py, body _make_body).  For each head g
//    and particle p it forms the masked cross-gram row
//        k = lam * exp(-sum_d w_d (x*_d - X_d)^2)
//            [+ (x* p1w) X^T + p1off + ((x* p2a) X^T) * ((x* p2b) X^T)]
//    and returns kalpha = k . alpha and, per tile of F's columns, the
//    partial sums of quad = sum_n (k F)_n^2.  When x* needs a gradient it
//    also writes kF [G, P, M], the residual K2 consumes.
// K2 k2_backward_xstar replaces fused_gram_contract_bwd_xstar (body
//    _make_bwd_body): dL/dx* from the cotangents g1, g2 of (kalpha, quad).
//    It forms R = kF F^T from K1's kF and fuses the chain rule
//        kbar = (g1 alpha + 2 g2 R) * mask,  dbar = -kbar * k_se
//    into the GEMM's epilogue.  The TPU kernel recomputed kF to spare VMEM;
//    on this card storing it (1.4 MB a call at M=448) halves K2's FLOPs.
//
// What bounds them: each is one [P, M] x [M, M] fp32 contraction per head,
// 2 G P M^2 = 0.24-0.32 GFLOP at P=400, M=384-448, with F (0.6-0.8 MB per
// head) resident in the 50 MB L2: a few microseconds of the card's 67
// TFLOP/s fp32 rate if the SMs are fed.  The design is a tiled SGEMM:
//  - a grid of (column tile, particle tile, head) blocks, 300-364 blocks at
//    P=400, M=384-448, so that all 132 SMs have work;
//  - the reduction dimension is walked in chunks of BK; F's (and in K2
//    kF's) chunks arrive by cp.async through a STAGES-deep shared-memory
//    ring, so the next chunks' loads overlap this chunk's FMAs.  Ragged
//    edges are zero-filled by cp.async's source-size operand; rows that are
//    not 16-byte aligned (M % 4 != 0) are copied 4 bytes at a time;
//  - each thread accumulates a 4 x 4 register micro-tile over half of
//    every chunk: two groups of warps per block share the tile (sliced K)
//    and sum their partials in a fixed order at the end, which doubles the
//    warps per SM that hide latency;
//  - K1 generates its A operand, the k chunk, into shared memory while the
//    next chunks' copies are in flight;
//  - K2's epilogue recomputes k_se, a2, b2 per (particle, point) pair and
//    reduces over the tile's points through shared memory.
// Partial sums over column tiles (quad) and point tiles (dx*) are written
// per tile and summed in a fixed order by sum_partials: the result is
// deterministic and no atomics are used.
//
// Lane axis.  Every input and output may carry a leading lane axis L (one
// posterior per seed of the seed farm): the grid's z runs over L * G
// (lane, head) pairs.  Every per-head array is [L, G, ...] and contiguous,
// so z indexes it as the head index did; x* and X_tr are [L, P, D] and
// [L, M, D] and are offset by the lane z / G.  A block reads nothing of
// another lane, and a lane's tiles and summation order do not depend on L:
// lane l of a launch is bitwise equal to a launch on lane l alone.  Every contraction is plain fp32
// FMA: TF32 and bf16 splits break the posterior algebra's cancellation
// (RESULTS.md, "Pallas fused-predict A/B").
//
// Input dims.  Up to NARROW_D = 8 dims (the cart-pole paths, D = 6) sit in
// registers, padded to DP = 6 or 8.  Above that (the Furuta SE, D = 12;
// UR5's SE+P(2), D = 24) five DP-float arrays per thread would spill, and
// K2's dx* reduction buffer would outgrow the ring it reuses.  So the wide
// instantiation (DP = MAX_D) keeps the particle rows and the per-head factors
// in shared memory and walks the dims in chunks of DCH = 8: K1 accumulates
// the distance and the polynomial dot products chunk by chunk; K2 first forms
// the per-pair chain-rule scalars over every dim, then reduces dx* one chunk
// of dims at a time through a DCH-wide buffer.  The GEMM mainloops and the
// tiles are those of the narrow path, which stays as it was.

#include <cuda_runtime.h>

namespace {

constexpr int STAGES = 3;      // depth of the cp.async ring
constexpr int TM = 4, TN = 4;  // register micro-tile of one thread
constexpr int NARROW_D = 8;    // input dims held in registers (padded to 6 or 8)
constexpr int MAX_D = 32;      // input dims of the wide path (padded to MAX_D)
constexpr int DCH = 8;         // dims per chunk of the wide path
static_assert(MAX_D % DCH == 0, "the wide path walks whole chunks of dims");

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

// Per-head factors of the wide path in shared memory: hw[q * DP + c] for
// q = 0..3 is w, poly1, poly2a, poly2b at dim c (dims >= D zero).
template <int DP, bool POLY, int T>
__device__ __forceinline__ void stage_head_factors(float* hw, const Args& a, int g) {
  const int D = a.D;
  for (int e = threadIdx.x; e < 4 * DP; e += T) {
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
}

// K1.  Block (nt, pt, g): particles [pt*BP, +BP) x F's columns [nt*BN, +BN).
// Thread (slice, ty, tx) accumulates rows ty*4..+4 and columns tx*4..+4 of
// kF's tile over its slice of each chunk.
template <int DP, bool POLY>
__global__ void __launch_bounds__(K1_THREADS)
k1_forward(Args a, float* __restrict__ kalpha, float* __restrict__ qpart, float* __restrict__ kf) {
  constexpr int BP = K1_BP, BN = K1_BN, BK = K1_BK, T = K1_THREADS, TX = BN / TN;
  constexpr int SLICES = K1_SLICES, KS = BK / SLICES, RPS = TM / SLICES;
  // the wide path's X rows get an odd pitch: the two chunk rows a warp reads
  // at once fall in different banks
  constexpr bool WIDE = DP > NARROW_D;
  constexpr int XP = WIDE ? DP + 1 : DP;
  static_assert(SLICES * TM * TN * K1_TILE_T <= STAGES * BK * BN, "the slices' sum reuses the ring");
  __shared__ __align__(16) float Fs[STAGES][BK * BN];  // F chunk [kk][n]
  __shared__ float Xs[STAGES][BK * XP];                // X chunk [kk][c], dims >= D zero
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

  for (int e = tid; e < STAGES * BK * XP; e += T)
    if (e % XP >= D) (&Xs[0][0])[e] = 0.f;  // never copied; visible after the first barrier

  auto load_stage = [&](int s, int chunk) {
    const int m0 = chunk * BK;
    load_tile<BK, BN, BN, T>(Fs[s], Fg, M, M, M, m0, n0, a.vec);
    for (int e = tid; e < BK * D; e += T) {
      const int kk = e / D;
      const bool ok = m0 + kk < M;
      cp_async4(&Xs[s][kk * XP + e - kk * D], ok ? xt + (size_t)m0 * D + e : xt, ok);
    }
    for (int e = tid; e < 2 * BK; e += T) {
      const int kk = e % BK;
      const bool ok = m0 + kk < M;
      const float* src = (e < BK ? mg : ag) + m0 + kk;
      cp_async4(e < BK ? &Ms[s][kk] : &As[s][kk], ok ? src : mg, ok);
    }
  };

  // the particle row this thread generates k for, and its per-head factors:
  // in registers, or in the wide path in shared memory (rows [BP][XP], then
  // the head factors)
  const int gi = tid % BP;
  const bool row_ok = p0 + gi < P;
  constexpr int DR = WIDE ? 1 : DP;
  float xi[DR], w[DR], u1[DR], ua[DR], ub[DR];
  float* rows = nullptr;
  if constexpr (!WIDE) {
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
  } else {
    __shared__ float wide_rows[BP * XP + 4 * DP];  // visible after the first barrier
    rows = wide_rows;
    for (int e = tid; e < BP * XP; e += T) {
      const int i = e / XP, c = e - i * XP;
      rows[e] = c < D && p0 + i < P ? xs[(size_t)(p0 + i) * D + c] : 0.f;
    }
    stage_head_factors<DP, POLY, T>(rows + BP * XP, a, g);
  }
  const float lam = a.se_lam[g];
  const float p1off = POLY ? a.poly1[g * (D + 1) + D] : 0.f;
  float ka = 0.f;

  auto gen = [&](int s) {
    if constexpr (!WIDE) {
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
    } else {
      // the same sums as the narrow path, dim chunk by dim chunk: each dim
      // of the row is read once for the J training points of this thread
      constexpr int J = BK * BP / T;
      const float* xr = rows + gi * XP;
      const float* hw = rows + BP * XP;
      float d[J], lin[J], a2[J], b2[J];
#pragma unroll
      for (int j = 0; j < J; ++j) d[j] = 0.f, lin[j] = p1off, a2[j] = 0.f, b2[j] = 0.f;
#pragma unroll 1
      for (int c0 = 0; c0 < D; c0 += DCH) {
#pragma unroll
        for (int c = c0; c < c0 + DCH; ++c) {
          const float x = xr[c], wc = hw[c];
          const float q1 = POLY ? hw[DP + c] * x : 0.f;
          const float qa = POLY ? hw[2 * DP + c] * x : 0.f;
          const float qb = POLY ? hw[3 * DP + c] * x : 0.f;
#pragma unroll
          for (int j = 0; j < J; ++j) {
            const float xm = Xs[s][(tid / BP + j * (T / BP)) * XP + c];
            const float df = x - xm;
            d[j] = fmaf(wc * df, df, d[j]);
            if (POLY) {
              lin[j] = fmaf(q1, xm, lin[j]);
              a2[j] = fmaf(qa, xm, a2[j]);
              b2[j] = fmaf(qb, xm, b2[j]);
            }
          }
        }
      }
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int kk = tid / BP + j * (T / BP);
        float k = lam * expf(-d[j]);
        if (POLY) k += lin[j] + a2[j] * b2[j];
        k = row_ok ? k * Ms[s][kk] : 0.f;
        ks[kk * BP + gi] = k;
        ka = fmaf(k, As[s][kk], ka);
      }
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

// K2.  Block (mt, pt, g): particles [pt*BP, +BP) x training points
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
  // the wide path reduces dx* DCH dims at a time; its x rows get an odd pitch
  // (the rows a warp reads fall in different banks)
  constexpr bool WIDE = DP > NARROW_D;
  constexpr int XP = WIDE ? DP + 1 : DP, RD = WIDE ? DCH : DP;
  static_assert(XCH + BP * TX * RD <= STAGES * STAGE, "the epilogue's buffers reuse the ring");
  __shared__ __align__(16) float ring[STAGES * STAGE];  // per stage: kF [BP][PITCH], F [BM][PITCH]
  __shared__ float xs[BP * XP], g1s[BP], g2s[BP], Xs[BM * XP], als[BM], mks[BM];

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
  for (int e = tid; e < BP * XP; e += T) {
    const int i = e / XP, c = e - i * XP;
    xs[e] = p0 + i < P && c < D ? xsl[(size_t)(p0 + i) * D + c] : 0.f;
  }
  for (int e = tid; e < BM * XP; e += T) {
    const int m = e / XP, c = e - m * XP;
    Xs[e] = m0 + m < M && c < D ? xtl[(size_t)(m0 + m) * D + c] : 0.f;
  }
  float* hw = nullptr;  // the wide path's head factors (stage_head_factors)
  if constexpr (WIDE) {
    __shared__ float wide_head[4 * DP];
    hw = wide_head;
    stage_head_factors<DP, POLY, T>(hw, a, g);
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
  if constexpr (!WIDE) {
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
  } else {
    // the pair's scalars need every dim: dbar2 = 2 dbar, and for the
    // polynomial terms kbar, kbar b2, kbar a2
    float sd[TM][TN], sk[TM][TN], sa[TM][TN], sb[TM][TN];
#pragma unroll
    for (int r = 0; r < TM; ++r) {
      if (r / RPS != slice) continue;
      const int i = ty * TM + r;
      const float* xi = xs + i * XP;
      const float h1 = g1s[i], h2 = 2.f * g2s[i];
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int m = tx + j * TX;
        const float* xm = Xs + m * XP;
        const float kbar = (h1 * als[m] + h2 * acc[r][j]) * mks[m];
        float d = 0.f, a2 = 0.f, b2 = 0.f;
#pragma unroll 1
        for (int c0 = 0; c0 < D; c0 += DCH) {
#pragma unroll
          for (int c = c0; c < c0 + DCH; ++c) {
            const float df = xi[c] - xm[c];
            d = fmaf(hw[c] * df, df, d);
            if (POLY) {
              const float xx = xi[c] * xm[c];
              a2 = fmaf(hw[2 * DP + c], xx, a2);
              b2 = fmaf(hw[3 * DP + c], xx, b2);
            }
          }
        }
        sd[r][j] = -2.f * kbar * lam * expf(-d);
        sk[r][j] = kbar;
        sa[r][j] = kbar * b2;
        sb[r][j] = kbar * a2;
      }
    }
    // then dx* one chunk of dims at a time, through a DCH-wide buffer
#pragma unroll 1
    for (int c0 = 0; c0 < D; c0 += DCH) {
#pragma unroll
      for (int r = 0; r < TM; ++r) {
        if (r / RPS != slice) continue;
        const int i = ty * TM + r;
        const float* xi = xs + i * XP + c0;
        const float* h = hw + c0;
        float part[DCH];
#pragma unroll
        for (int c = 0; c < DCH; ++c) part[c] = 0.f;
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          const float* xm = Xs + (tx + j * TX) * XP + c0;
#pragma unroll
          for (int c = 0; c < DCH; ++c) {
            float v = h[c] * sd[r][j] * (xi[c] - xm[c]);
            if (POLY)
              v = fmaf(xm[c], sk[r][j] * h[DP + c] + sa[r][j] * h[2 * DP + c] +
                                  sb[r][j] * h[3 * DP + c], v);
            part[c] += v;
          }
        }
#pragma unroll
        for (int c = 0; c < DCH; ++c) red[(i * TX + tx) * DCH + c] = part[c];
      }
      __syncthreads();
      for (int e = tid; e < BP * DCH; e += T) {
        const int i = e / DCH, c = e - i * DCH;
        if (p0 + i >= P || c0 + c >= D) continue;
        float s = 0.f;
        for (int q = 0; q < TX; ++q) s += red[(i * TX + q) * DCH + c];
        dxp[(((size_t)g * gridDim.x + mt) * P + p0 + i) * D + c0 + c] = s;
      }
      __syncthreads();  // red is written again by the next chunk
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

}  // namespace

extern "C" {

// Tile sizes, for the caller's partial-sum buffers:
// {K1 particles, K1 columns of F, K2 particles, K2 training points}.
void fp_tiles(int* out) {
  out[0] = K1_BP; out[1] = K1_BN; out[2] = K2_BP; out[3] = K2_BM;
}

// K1 over L lanes, then the sum of quad's partials.  Every array has the
// lane axis in front: kalpha and quad [L, G, P]; qpart, scratch for the
// partials, [L, G, ceil(M / K1_BN), P]; kf [L, G, P, M] or null.  Returns a
// cudaError_t: 0 when both launches were accepted.
int fp_forward(const float* se_w, const float* se_lam, const float* poly1, const float* poly2a,
               const float* poly2b, const float* xs, const float* xt, const float* alpha,
               const float* F, const float* mask, float* kalpha, float* qpart, float* quad,
               float* kf, int L, int G, int P, int M, int D, int use_poly, int vec, void* stream) {
  if (D < 1 || D > MAX_D || L < 1 || L * G > 65535) return (int)cudaErrorInvalidValue;
  const Args a = make_args(se_w, se_lam, poly1, poly2a, poly2b, xs, xt, alpha, F, mask, G, P, M, D, vec);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 6) {
    if (use_poly) launch_k1<6, true>(a, L, kalpha, qpart, kf, s);
    else launch_k1<6, false>(a, L, kalpha, qpart, kf, s);
  } else if (D <= NARROW_D) {
    if (use_poly) launch_k1<NARROW_D, true>(a, L, kalpha, qpart, kf, s);
    else launch_k1<NARROW_D, false>(a, L, kalpha, qpart, kf, s);
  } else {
    if (use_poly) launch_k1<MAX_D, true>(a, L, kalpha, qpart, kf, s);
    else launch_k1<MAX_D, false>(a, L, kalpha, qpart, kf, s);
  }
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  launch_sum(qpart, quad, L * G, (M + K1_BN - 1) / K1_BN, P, s);
  return (int)cudaGetLastError();
}

// K2 over L lanes, then the sum of its partials over heads and point tiles.
// kf is K1's [L, G, P, M]; g1, g2 [L, G, P]; dxp, scratch,
// [L, G, ceil(M / K2_BM), P, D]; dx [L, P, D].
int fp_backward_xstar(const float* se_w, const float* se_lam, const float* poly1,
                      const float* poly2a, const float* poly2b, const float* xs,
                      const float* xt, const float* alpha, const float* F, const float* mask,
                      const float* kf, const float* g1, const float* g2, float* dxp, float* dx,
                      int L, int G, int P, int M, int D, int use_poly, int vec, void* stream) {
  if (D < 1 || D > MAX_D || L < 1 || L * G > 65535) return (int)cudaErrorInvalidValue;
  const Args a = make_args(se_w, se_lam, poly1, poly2a, poly2b, xs, xt, alpha, F, mask, G, P, M, D, vec);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 6) {
    if (use_poly) launch_k2<6, true>(a, L, kf, g1, g2, dxp, s);
    else launch_k2<6, false>(a, L, kf, g1, g2, dxp, s);
  } else if (D <= NARROW_D) {
    if (use_poly) launch_k2<NARROW_D, true>(a, L, kf, g1, g2, dxp, s);
    else launch_k2<NARROW_D, false>(a, L, kf, g1, g2, dxp, s);
  } else {
    if (use_poly) launch_k2<MAX_D, true>(a, L, kf, g1, g2, dxp, s);
    else launch_k2<MAX_D, false>(a, L, kf, g1, g2, dxp, s);
  }
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  launch_sum(dxp, dx, L, G * ((M + K2_BM - 1) / K2_BM), P * D, s);
  return (int)cudaGetLastError();
}

const char* fp_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
