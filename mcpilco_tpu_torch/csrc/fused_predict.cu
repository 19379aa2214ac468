// Fused multi-head GP posterior prediction for Hopper (sm_90a), fp32 FFMA.
//
// K1 fp_forward replaces the TPU kernel fused_gram_contract
//    (mcpilco_tpu/ops/fused_predict.py, body _make_body).  For each head g
//    and particle p it forms the cross-gram row
//        k = lam * exp(-sum_d w_d (x*_d - X_d)^2)
//            [+ (x* p1w) X^T + p1off + ((x* p2a) X^T) * ((x* p2b) X^T)]
//    masks it, and returns kalpha = k . alpha and quad = sum_n (k F)_n^2.
// K2 fp_backward_xstar replaces fused_gram_contract_bwd_xstar (body
//    _make_bwd_body): dL/dx* from the cotangents g1, g2 of (kalpha, quad).
//    It recomputes k, forms kF and kF F^T, then
//        kbar = (g1 alpha + 2 g2 kF F^T) * mask,  dbar = -kbar * k_se
//    and accumulates the chain rule of the SE distance and the polynomial
//    terms.  It writes per-head partials dx*[G, P, D]; the caller sums the
//    heads, so the result is deterministic and uses no atomics.
//
// What bounds them on the card: at the flagship shapes (G=2, P=400,
// M<=384, D=6) K1 is ~0.24 GFLOP and K2 ~0.47 GFLOP per call, a few
// microseconds of the card's fp32 rate, while F (576 KB per head) stays
// in the 50 MB L2.  Both are latency- and launch-bound, not bandwidth-
// bound.  The design is the simple correct one: one block per (16-particle
// tile, head); the k tile and X live in shared memory, F streams from L2
// column by column (K1, and K2's kF pass) or through a padded shared tile
// (K2's kF F^T pass, which reads F by rows).  With 25 tiles x 2 heads only
// 50 of 132 SMs get a block at P=400; wgmma, TMA and more blocks are later
// work.  Every contraction is plain fp32 FMA: TF32 and bf16 splits break
// the posterior algebra's cancellation (RESULTS.md, "Pallas fused-predict
// A/B").

#include <cuda_runtime.h>

namespace {

constexpr int TP = 16;        // particles per block
constexpr int THREADS = 128;  // 4 warps
constexpr int WARPS = THREADS / 32;
constexpr int TILE_N = 32;    // F columns per shared tile in K2's second pass

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
  int G, P, M, D;
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Stage X and this block's particle rows in shared memory, then fill the
// transposed, masked k tile kT[m * TP + i].  Rows past P are zero and never
// written out.
template <bool POLY>
__device__ void stage_k_tile(const Args& a, int g, int p0, float* kT, float* X, float* xs) {
  const int M = a.M, D = a.D;
  for (int e = threadIdx.x; e < M * D; e += THREADS) X[e] = a.xt[e];
  for (int e = threadIdx.x; e < TP * D; e += THREADS) {
    const int r = e / D, row = p0 + r;
    xs[e] = row < a.P ? a.xs[(size_t)row * D + (e - r * D)] : 0.f;
  }
  __syncthreads();
  const float* w = a.se_w + g * D;
  const float lam = a.se_lam[g];
  const float* p1 = a.poly1 + g * (D + 1);
  const float* pa = a.poly2a + g * D;
  const float* pb = a.poly2b + g * D;
  const float* msk = a.mask + (size_t)g * M;
  for (int e = threadIdx.x; e < M * TP; e += THREADS) {
    const int m = e / TP, i = e - m * TP;
    const float* xi = xs + i * D;
    const float* xm = X + m * D;
    float d = 0.f;
    for (int c = 0; c < D; ++c) {
      const float df = xi[c] - xm[c];
      d += w[c] * df * df;
    }
    float k = lam * expf(-d);
    if (POLY) {
      float lin = p1[D], a2 = 0.f, b2 = 0.f;
      for (int c = 0; c < D; ++c) {
        const float xx = xi[c] * xm[c];
        lin += p1[c] * xx;
        a2 += pa[c] * xx;
        b2 += pb[c] * xx;
      }
      k += lin + a2 * b2;
    }
    kT[e] = k * msk[m];
  }
  __syncthreads();
}

// acc[i] = sum_m kT[m][i] * F[m][n] for one column n of F (coalesced over n
// across the block's threads; the kT row is a shared-memory broadcast).
__device__ __forceinline__ void kf_column(const float* kT, const float* Fg, int M, int n,
                                          float acc[TP]) {
#pragma unroll
  for (int i = 0; i < TP; ++i) acc[i] = 0.f;
#pragma unroll 4
  for (int m = 0; m < M; ++m) {
    const float f = __ldg(Fg + (size_t)m * M + n);
    const float4* k4 = reinterpret_cast<const float4*>(kT + m * TP);
#pragma unroll
    for (int q = 0; q < TP / 4; ++q) {
      const float4 v = k4[q];
      acc[4 * q + 0] += v.x * f;
      acc[4 * q + 1] += v.y * f;
      acc[4 * q + 2] += v.z * f;
      acc[4 * q + 3] += v.w * f;
    }
  }
}

template <bool POLY>
__global__ void __launch_bounds__(THREADS)
fwd_kernel(Args a, float* __restrict__ kalpha, float* __restrict__ quad) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int M = a.M, D = a.D, g = blockIdx.y, p0 = blockIdx.x * TP;
  float* kT = smem;          // [M, TP]
  float* X = kT + M * TP;    // [M, D]
  float* xs = X + M * D;     // [TP, D]
  float* red = xs + TP * D;  // [WARPS, TP]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  stage_k_tile<POLY>(a, g, p0, kT, X, xs);

  const float* al = a.alpha + (size_t)g * M;
  for (int i = warp; i < TP; i += WARPS) {
    float s = 0.f;
    for (int m = lane; m < M; m += 32) s += kT[m * TP + i] * al[m];
    s = warp_sum(s);
    if (lane == 0 && p0 + i < a.P) kalpha[(size_t)g * a.P + p0 + i] = s;
  }

  const float* Fg = a.F + (size_t)g * M * M;
  float q[TP];
#pragma unroll
  for (int i = 0; i < TP; ++i) q[i] = 0.f;
  for (int n = threadIdx.x; n < M; n += THREADS) {
    float acc[TP];
    kf_column(kT, Fg, M, n, acc);
#pragma unroll
    for (int i = 0; i < TP; ++i) q[i] += acc[i] * acc[i];
  }
#pragma unroll
  for (int i = 0; i < TP; ++i) {
    const float s = warp_sum(q[i]);
    if (lane == 0) red[warp * TP + i] = s;
  }
  __syncthreads();
  if (threadIdx.x < TP && p0 + threadIdx.x < a.P) {
    float s = 0.f;
    for (int w = 0; w < WARPS; ++w) s += red[w * TP + threadIdx.x];
    quad[(size_t)g * a.P + p0 + threadIdx.x] = s;
  }
}

template <bool POLY>
__global__ void __launch_bounds__(THREADS)
bwd_kernel(Args a, const float* __restrict__ g1, const float* __restrict__ g2,
           float* __restrict__ dxp) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int M = a.M, D = a.D, g = blockIdx.y, p0 = blockIdx.x * TP;
  float* kT = smem;                         // [M, TP]  masked k
  float* kFT = kT + M * TP;                 // [M, TP]  (kF)^T
  float* X = kFT + M * TP;                  // [M, D]
  float* xs = X + M * D;                    // [TP, D]
  float* tile = xs + TP * D;                // [THREADS, TILE_N + 1]
  float* part = tile + THREADS * (TILE_N + 1);  // [WARPS, TP, D]
  float* g1s = part + WARPS * TP * D;       // [TP]
  float* g2s = g1s + TP;                    // [TP]
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  for (int e = tid; e < TP; e += THREADS) {
    const bool ok = p0 + e < a.P;
    g1s[e] = ok ? g1[(size_t)g * a.P + p0 + e] : 0.f;
    g2s[e] = ok ? g2[(size_t)g * a.P + p0 + e] : 0.f;
  }
  for (int e = tid; e < WARPS * TP * D; e += THREADS) part[e] = 0.f;
  stage_k_tile<POLY>(a, g, p0, kT, X, xs);

  // pass 1: kF^T into shared memory
  const float* Fg = a.F + (size_t)g * M * M;
  for (int n = tid; n < M; n += THREADS) {
    float acc[TP];
    kf_column(kT, Fg, M, n, acc);
    float4* dst = reinterpret_cast<float4*>(kFT + n * TP);
#pragma unroll
    for (int q = 0; q < TP / 4; ++q)
      dst[q] = make_float4(acc[4 * q], acc[4 * q + 1], acc[4 * q + 2], acc[4 * q + 3]);
  }
  __syncthreads();

  const float* w = a.se_w + g * D;
  const float lam = a.se_lam[g];
  const float* p1 = a.poly1 + g * (D + 1);
  const float* pa = a.poly2a + g * D;
  const float* pb = a.poly2b + g * D;
  // pass 2: each thread owns one training point m of the block of THREADS
  // rows; acc[i] = (kF F^T)[i][m], F read by rows through the shared tile
  for (int m0 = 0; m0 < M; m0 += THREADS) {
    const int m = m0 + tid;
    const bool mv = m < M;
    float acc[TP];
#pragma unroll
    for (int i = 0; i < TP; ++i) acc[i] = 0.f;
    for (int n0 = 0; n0 < M; n0 += TILE_N) {
      for (int e = tid; e < THREADS * TILE_N; e += THREADS) {
        const int r = e / TILE_N, c = e - r * TILE_N;
        const int mm = m0 + r, nn = n0 + c;
        tile[r * (TILE_N + 1) + c] = (mm < M && nn < M) ? Fg[(size_t)mm * M + nn] : 0.f;
      }
      __syncthreads();
      const int ncols = min(TILE_N, M - n0);
      for (int c = 0; c < ncols; ++c) {
        const float f = tile[tid * (TILE_N + 1) + c];
        const float4* k4 = reinterpret_cast<const float4*>(kFT + (n0 + c) * TP);
#pragma unroll
        for (int q = 0; q < TP / 4; ++q) {
          const float4 v = k4[q];
          acc[4 * q + 0] += v.x * f;
          acc[4 * q + 1] += v.y * f;
          acc[4 * q + 2] += v.z * f;
          acc[4 * q + 3] += v.w * f;
        }
      }
      __syncthreads();
    }

    // chain rule for the (i, m) pairs of this thread; invalid m has mask 0
    const float al = mv ? a.alpha[(size_t)g * M + m] : 0.f;
    const float mk = mv ? a.mask[(size_t)g * M + m] : 0.f;
    const float* xm = X + (mv ? m : 0) * D;
    for (int i = 0; i < TP; ++i) {
      const float kbar = (g1s[i] * al + 2.f * g2s[i] * acc[i]) * mk;
      const float* xi = xs + i * D;
      float d = 0.f, a2 = 0.f, b2 = 0.f;
      for (int c = 0; c < D; ++c) {
        const float df = xi[c] - xm[c];
        d += w[c] * df * df;
        if (POLY) {
          const float xx = xi[c] * xm[c];
          a2 += pa[c] * xx;
          b2 += pb[c] * xx;
        }
      }
      const float dbar = -kbar * lam * expf(-d);
      for (int c = 0; c < D; ++c) {
        float v = 2.f * w[c] * dbar * (xi[c] - xm[c]);
        if (POLY) v += kbar * xm[c] * (p1[c] + pa[c] * b2 + pb[c] * a2);
        v = warp_sum(v);
        if (lane == 0) part[(warp * TP + i) * D + c] += v;
      }
    }
  }
  __syncthreads();
  for (int e = tid; e < TP * D; e += THREADS) {
    const int i = e / D, c = e - i * D;
    if (p0 + i < a.P) {
      float s = 0.f;
      for (int wp = 0; wp < WARPS; ++wp) s += part[(wp * TP + i) * D + c];
      dxp[((size_t)g * a.P + p0 + i) * D + c] = s;
    }
  }
}

size_t fwd_smem(int M, int D) { return sizeof(float) * (size_t)(M * TP + M * D + TP * D + WARPS * TP); }

size_t bwd_smem(int M, int D) {
  return sizeof(float) *
         (size_t)(2 * M * TP + M * D + TP * D + THREADS * (TILE_N + 1) + WARPS * TP * D + 2 * TP);
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

Args make_args(const float* se_w, const float* se_lam, const float* poly1, const float* poly2a,
               const float* poly2b, const float* xs, const float* xt, const float* alpha,
               const float* F, const float* mask, int G, int P, int M, int D) {
  Args a;
  a.se_w = se_w; a.se_lam = se_lam; a.poly1 = poly1; a.poly2a = poly2a; a.poly2b = poly2b;
  a.xs = xs; a.xt = xt; a.alpha = alpha; a.F = F; a.mask = mask;
  a.G = G; a.P = P; a.M = M; a.D = D;
  return a;
}

}  // namespace

extern "C" {

// Returns a cudaError_t: 0 when the launch was accepted.
int fp_forward(const float* se_w, const float* se_lam, const float* poly1, const float* poly2a,
               const float* poly2b, const float* xs, const float* xt, const float* alpha,
               const float* F, const float* mask, float* kalpha, float* quad, int G, int P,
               int M, int D, int use_poly, void* stream) {
  const Args a = make_args(se_w, se_lam, poly1, poly2a, poly2b, xs, xt, alpha, F, mask, G, P, M, D);
  const dim3 grid((P + TP - 1) / TP, G);
  const size_t smem = fwd_smem(M, D);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (use_poly) {
    if ((err = allow_smem(fwd_kernel<true>, smem)) != cudaSuccess) return (int)err;
    fwd_kernel<true><<<grid, THREADS, smem, s>>>(a, kalpha, quad);
  } else {
    if ((err = allow_smem(fwd_kernel<false>, smem)) != cudaSuccess) return (int)err;
    fwd_kernel<false><<<grid, THREADS, smem, s>>>(a, kalpha, quad);
  }
  return (int)cudaGetLastError();
}

int fp_backward_xstar(const float* se_w, const float* se_lam, const float* poly1,
                      const float* poly2a, const float* poly2b, const float* xs,
                      const float* xt, const float* alpha, const float* F, const float* mask,
                      const float* g1, const float* g2, float* dxp, int G, int P, int M, int D,
                      int use_poly, void* stream) {
  const Args a = make_args(se_w, se_lam, poly1, poly2a, poly2b, xs, xt, alpha, F, mask, G, P, M, D);
  const dim3 grid((P + TP - 1) / TP, G);
  const size_t smem = bwd_smem(M, D);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (use_poly) {
    if ((err = allow_smem(bwd_kernel<true>, smem)) != cudaSuccess) return (int)err;
    bwd_kernel<true><<<grid, THREADS, smem, s>>>(a, g1, g2, dxp);
  } else {
    if ((err = allow_smem(bwd_kernel<false>, smem)) != cudaSuccess) return (int)err;
    bwd_kernel<false><<<grid, THREADS, smem, s>>>(a, g1, g2, dxp);
  }
  return (int)cudaGetLastError();
}

const char* fp_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
