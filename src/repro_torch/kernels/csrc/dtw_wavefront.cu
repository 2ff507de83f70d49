// DTW baselines for Hopper (sm_90a): the anti-diagonal wavefront DTW over
// aligned pairs (``dtw_wavefront``) and the slanted-strip Sakoe-Chiba DTW
// over aligned pairs or an all-pairs grid (``dtw_banded``).
//
// What they replace.
//   dtw_wavefront <- src/repro/kernels/dtw_wavefront.py _wavefront_kernel
//                    (entry wavefront_dtw), the TPU kernel K5.
//   dtw_banded    <- src/repro/kernels/dtw_banded.py _banded_kernel
//                    (entry banded_dtw), the TPU kernel K6.
// Each repeats its plain PyTorch version (``dtw_wavefront.
// wavefront_dtw_plain``, ``dtw_banded.banded_dtw_plain``) operation by
// operation, so the results are bit-identical to them.
//
// What bounds them on this card. Per needed cell: d subtractions, d
// multiplications and d - 1 additions for the cost, then min and add (K5:
// 2 min + 1 add; K6: the Hillis-Steele scan adds about 4 log2(2w+1)
// operations per cell). The inputs are a few MB of series and the outputs
// one float per pair, so these are instruction-bound kernels, and what
// they lose beyond their bound is loads, shuffles and synchronisation.
//
// What the design does about it. The TPU kernels put 8 pairs on the
// sublanes and a diagonal (K5) or a strip row (K6) on the lanes. Here:
//   K5: one warp owns one pair; lane l holds diagonal positions
//       i = l * C .. l * C + C - 1 (C = 1, 2, 4, 8 or 16; T <= 512) as a
//       register pipeline: x[i] is read once into registers, and y moves
//       one position up per diagonal step (position i at step k + 1 needs
//       the y that position i - 1 held at step k), by one register move
//       or one __shfl_up_sync, with y[k] entering at lane 0 from a batch
//       of 32 that the warp loads coalesced, 32 steps ahead. The step
//       loop has no global load. Positions outside the grid's and the
//       Sakoe-Chiba corridor's range [lo_k, hi_k] of the diagonal take
//       +INF without a cost. Up to 4 channels sit in registers; more
//       channels, and longer series, keep the three live diagonals in
//       shared memory (``wavefront_wide_kernel``).
//   K6: three templates, picked by ``dtw_banded.banded_geometry``:
//     "thread" (2w+1 <= 64): one thread owns one pair and holds the strip
//       row in registers, padded to WP (the power of two >= 2w+1), so the
//       top neighbour is a register and the in-row scan runs with
//       compile-time indices. The block stages its pairs' y rows, a chunk
//       of strip rows at a time, into shared memory, thread-interleaved
//       (row pitch 129 floats, so the transposed staging store and the
//       per-thread reads hit 32 distinct banks).
//     "lanes" (2w+1 <= 256): a group of G lanes owns one pair (G the power
//       of two >= 2w+1, at most 32); lane l holds strip cells u = c * G + l
//       (C = ceil((2w+1)/G) <= 8). With C = 1 the in-row scan and the top
//       neighbour are shuffles inside the group; with C > 1 they go
//       through per-pair shared memory.
//     "wide" (any width): each pair has a warp whose lanes loop over the
//       strip, with the row and the scan in shared memory.
//   In the Gram mode pair p is (A row p / Nb, B row p % Nb), so the dtw_sc
//   Gram never expands the series into a pair batch.
//
// Floating point. The cost uses the _rn intrinsics and the file is built
// with --fmad=false, so the channel sum rounds as the plain version's does.
//
// C interface (bound with ctypes): every function returns
// cudaGetLastError() after its launch (0 = launched).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kInf = 1.0e30f;
constexpr int kWarps = 4;               // warps per thread block
constexpr int kRegChannels = 4;         // K5: most channels in registers

// squared distance of x[i] and y[j], channels summed left to right;
// +INF when any channel of y reads >= INF (the reference's pad test)
__device__ __forceinline__ float cost(const float* __restrict__ x,
                                      const float* __restrict__ y, int i,
                                      int j, int d) {
  float acc = 0.f;
  bool ok = true;
  for (int ch = 0; ch < d; ++ch) {
    const float yv = __ldg(y + (size_t)j * d + ch);
    ok = ok && yv < kInf;
    const float df = __fsub_rn(__ldg(x + (size_t)i * d + ch), yv);
    const float sq = __fmul_rn(df, df);
    acc = ch == 0 ? sq : __fadd_rn(acc, sq);
  }
  return ok ? acc : kInf;
}

// ---------------------------------------------------------------- K5 ----

// Loads y[k0 + lane] (D channels) for the batch of diagonal steps k0 ..
// k0 + 31: +INF past the series; a row with any channel >= INF (or NaN)
// gets +INF in channel 0, so that channel 0 alone carries the reference's
// pad test (ysh < INF on every channel).
template <int D>
__device__ __forceinline__ void load_batch(const float* __restrict__ y,
                                           int T, int k0, int lane,
                                           float (&v)[D]) {
  const int j = k0 + lane;
  bool bad = j >= T;
#pragma unroll
  for (int ch = 0; ch < D; ++ch) {
    v[ch] = j < T ? __ldg(y + (size_t)j * D + ch) : kInf;
    bad = bad || !(v[ch] < kInf);
  }
  if (bad) v[0] = kInf;
}

// One pair per warp, D channels in registers. Position i = lane * C + c
// holds x[i] for the whole sweep and, at step k, y[k - i]: the y values
// move up one position per step. Every D value is a path sum in path
// order (min and add only), so any sweep order gives the plain version's
// bits; positions outside [lo, hi] take +INF as the plain version's
// INF + best, clamped, does.
template <int C, int D>
__global__ void __launch_bounds__(kWarps * 32)
wavefront_kernel(const float* __restrict__ X, const float* __restrict__ Y,
                 int P, int T, int radius, float* __restrict__ out) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long p = (long long)blockIdx.x * kWarps + warp;
  if (p >= P) return;
  const float* x = X + p * T * D;
  const float* y = Y + p * T * D;
  float xv[D][C], yv[D][C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int i = lane * C + c;
#pragma unroll
    for (int ch = 0; ch < D; ++ch) {
      xv[ch][c] = i < T ? __ldg(x + (size_t)i * D + ch) : 0.f;
      yv[ch][c] = kInf;
    }
  }
  float ycur[D], ynext[D];
  load_batch<D>(y, T, 0, lane, ycur);
  load_batch<D>(y, T, 32, lane, ynext);
  // step 0: position 0 holds y[0]
#pragma unroll
  for (int ch = 0; ch < D; ++ch) {
    const float y0 = __shfl_sync(0xffffffffu, ycur[ch], 0);
    if (lane == 0) yv[ch][0] = y0;
  }
  float dm1[C], dm2[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    // cell (0, 0), always inside the grid and the corridor
    float acc = 0.f;
#pragma unroll
    for (int ch = 0; ch < D; ++ch) {
      const float df = __fsub_rn(xv[ch][c], yv[ch][c]);
      const float sq = __fmul_rn(df, df);
      acc = ch == 0 ? sq : __fadd_rn(acc, sq);
    }
    const bool first = lane == 0 && c == 0;
    dm1[c] = first && yv[0][0] < kInf ? acc : kInf;
    dm2[c] = kInf;
  }
  for (int k = 1; k < 2 * T - 1; ++k) {
    if ((k & 31) == 0) {
#pragma unroll
      for (int ch = 0; ch < D; ++ch) ycur[ch] = ynext[ch];
      load_batch<D>(y, T, k + 32, lane, ynext);
    }
    // move y up one position; y[k] enters at position 0
#pragma unroll
    for (int ch = 0; ch < D; ++ch) {
      const float enter = __shfl_sync(0xffffffffu, ycur[ch], k & 31);
      const float up = __shfl_up_sync(0xffffffffu, yv[ch][C - 1], 1);
#pragma unroll
      for (int c = C - 1; c > 0; --c) yv[ch][c] = yv[ch][c - 1];
      yv[ch][0] = lane == 0 ? enter : up;
    }
    // the diagonal's cells inside the grid and the corridor |2i - k| <= r
    int lo = k - T + 1 > 0 ? k - T + 1 : 0;
    int hi = k < T - 1 ? k : T - 1;
    if (radius >= 0) {
      lo = max(lo, (k - radius + 1) >> 1);   // ceil((k - r) / 2)
      hi = min(hi, (k + radius) >> 1);
    }
    float u1 = __shfl_up_sync(0xffffffffu, dm1[C - 1], 1);
    float u2 = __shfl_up_sync(0xffffffffu, dm2[C - 1], 1);
    if (lane == 0) { u1 = kInf; u2 = kInf; }
    float dk[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int i = lane * C + c;
      float acc = 0.f;
#pragma unroll
      for (int ch = 0; ch < D; ++ch) {
        const float df = __fsub_rn(xv[ch][c], yv[ch][c]);
        const float sq = __fmul_rn(df, df);
        acc = ch == 0 ? sq : __fadd_rn(acc, sq);
      }
      const bool ok = i >= lo && i <= hi && yv[0][c] < kInf;
      const float sh1 = c ? dm1[c - 1] : u1;
      const float sh2 = c ? dm2[c - 1] : u2;
      const float best = fminf(fminf(sh1, dm1[c]), sh2);
      dk[c] = ok ? fminf(__fadd_rn(acc, best), kInf) : kInf;
    }
#pragma unroll
    for (int c = 0; c < C; ++c) {
      dm2[c] = dm1[c];
      dm1[c] = dk[c];
    }
  }
  float res = kInf;
#pragma unroll
  for (int c = 0; c < C; ++c)
    if (lane * C + c == T - 1) res = dm1[c];
  res = __shfl_sync(0xffffffffu, res, (T - 1) / C);
  if (lane == 0) out[p] = res;
}

// Series longer than the register layout holds (T > 512): one warp per
// pair, the three live diagonals in per-pair shared memory (T floats each,
// rotating), lanes looping over the positions; the arithmetic is
// wavefront_kernel's, position for position.
__global__ void wavefront_wide_kernel(const float* __restrict__ X,
                                      const float* __restrict__ Y, int P,
                                      int T, int d, int radius,
                                      float* __restrict__ out) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long p = (long long)blockIdx.x * (blockDim.x >> 5) + warp;
  if (p >= P) return;
  const float* x = X + p * T * d;
  const float* y = Y + p * T * d;
  float* buf = smem + (size_t)warp * 3 * T;
  int c1 = 0, c2 = 1, cn = 2;   // diagonals k-1, k-2, k
  for (int i = lane; i < T; i += 32) {
    buf[i] = i == 0 ? cost(x, y, 0, 0, d) : kInf;   // cell (0, 0)
    buf[T + i] = kInf;
  }
  __syncwarp();
  for (int k = 1; k < 2 * T - 1; ++k) {
    const float* dm1 = buf + c1 * T;
    const float* dm2 = buf + c2 * T;
    float* dk = buf + cn * T;
    for (int i = lane; i < T; i += 32) {
      const int j = k - i;
      bool valid = j >= 0 && j < T;
      if (radius >= 0) valid = valid && abs(2 * i - k) <= radius;
      const float cst = valid ? cost(x, y, i, j, d) : kInf;
      const float sh1 = i ? dm1[i - 1] : kInf;
      const float sh2 = i ? dm2[i - 1] : kInf;
      const float best = fminf(fminf(sh1, dm1[i]), sh2);
      dk[i] = fminf(__fadd_rn(cst, best), kInf);
    }
    __syncwarp();
    const int t = c2;
    c2 = c1;
    c1 = cn;
    cn = t;
  }
  if (lane == 0) out[p] = buf[c1 * T + T - 1];
}

int wavefront_wide(const float* X, const float* Y, int P, int T, int d,
                   int radius, float* out, cudaStream_t stream) {
  const size_t per = (size_t)3 * T * 4;
  const int warps = (int)(232448 / per < 4 ? 232448 / per : 4);
  if (warps < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = warps * per;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        wavefront_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const long long grid = ((long long)P + warps - 1) / warps;
  wavefront_wide_kernel<<<dim3((unsigned)grid), dim3(warps * 32), smem,
                          stream>>>(X, Y, P, T, d, radius, out);
  return (int)cudaGetLastError();
}

template <int C, int D>
int wavefront_cd(const float* X, const float* Y, int P, int T, int radius,
                 float* out, cudaStream_t stream) {
  const long long grid = ((long long)P + kWarps - 1) / kWarps;
  wavefront_kernel<C, D><<<dim3((unsigned)grid), dim3(kWarps * 32), 0,
                           stream>>>(X, Y, P, T, radius, out);
  return (int)cudaGetLastError();
}

template <int C>
int wavefront_c(const float* X, const float* Y, int P, int T, int d,
                int radius, float* out, cudaStream_t stream) {
  switch (d) {
    case 1: return wavefront_cd<C, 1>(X, Y, P, T, radius, out, stream);
    case 2: return wavefront_cd<C, 2>(X, Y, P, T, radius, out, stream);
    case 3: return wavefront_cd<C, 3>(X, Y, P, T, radius, out, stream);
    default: return wavefront_cd<C, 4>(X, Y, P, T, radius, out, stream);
  }
}

// ---------------------------------------------------------------- K6 ----

// One pair's strip sweep by a group of G lanes. Returns D(T-1, T-1) on
// every lane of the group.
template <int G, int C>
__device__ float strip_pair(const float* __restrict__ x,
                            const float* __restrict__ y, int T, int d, int w,
                            int lane, unsigned gmask, float* buf) {
  const int W = 2 * w + 1;
  float* sd = buf;              // C > 1: the previous row
  float* sm = buf + C * G;      //        the scan's m
  float* ss = buf + 2 * C * G;  //        the scan's s
  float dprev[C], cst[C], mm[C];
#pragma unroll
  for (int c = 0; c < C; ++c) dprev[c] = kInf;
  for (int t = 0; t < T; ++t) {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int u = c * G + lane;
      const int j = t - w + u;
      cst[c] = (u < W && j >= 0 && j < T) ? cost(x, y, t, j, d) : kInf;
    }
    if (t == 0) {
      // only cell (0, 0) (u = w) starts a path
#pragma unroll
      for (int c = 0; c < C; ++c) mm[c] = c * G + lane == w ? cst[c] : kInf;
    } else {
      // top neighbour D_{t-1}[u+1] (+INF past the strip), and D_{t-1}[u]
      float top[C];
      if constexpr (C == 1) {
        const float dn = __shfl_down_sync(gmask, dprev[0], 1, G);
        top[0] = lane + 1 < W ? dn : kInf;
      } else {
#pragma unroll
        for (int c = 0; c < C; ++c) sd[c * G + lane] = dprev[c];
        __syncwarp(gmask);
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const int u = c * G + lane;
          top[c] = u + 1 < W ? sd[u + 1] : kInf;
        }
        __syncwarp(gmask);
      }
#pragma unroll
      for (int c = 0; c < C; ++c)
        mm[c] = __fadd_rn(cst[c], fminf(top[c], dprev[c]));
    }
    // Hillis-Steele min-plus scan, the association of
    // spdtw_block._minplus_scan_lanes: m = min(m, m_sh + s) with the old
    // s, then s = min(s_sh + s, INF)
    float s[C];
#pragma unroll
    for (int c = 0; c < C; ++c) s[c] = cst[c];
    for (int dd = 1; dd < W; dd <<= 1) {
      if constexpr (C == 1) {
        float m_sh = __shfl_up_sync(gmask, mm[0], dd, G);
        float s_sh = __shfl_up_sync(gmask, s[0], dd, G);
        if (lane < dd) { m_sh = kInf; s_sh = 0.f; }
        const float nm = fminf(mm[0], __fadd_rn(m_sh, s[0]));
        s[0] = fminf(__fadd_rn(s_sh, s[0]), kInf);
        mm[0] = nm;
      } else {
#pragma unroll
        for (int c = 0; c < C; ++c) {
          sm[c * G + lane] = mm[c];
          ss[c * G + lane] = s[c];
        }
        __syncwarp(gmask);
        float nm[C], ns[C];
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const int u = c * G + lane;
          const float m_sh = u >= dd ? sm[u - dd] : kInf;
          const float s_sh = u >= dd ? ss[u - dd] : 0.f;
          nm[c] = fminf(mm[c], __fadd_rn(m_sh, s[c]));
          ns[c] = fminf(__fadd_rn(s_sh, s[c]), kInf);
        }
        __syncwarp(gmask);
#pragma unroll
        for (int c = 0; c < C; ++c) { mm[c] = nm[c]; s[c] = ns[c]; }
      }
    }
    // row 0 is not clamped (the reference's), later rows are
#pragma unroll
    for (int c = 0; c < C; ++c) dprev[c] = t == 0 ? mm[c] : fminf(mm[c], kInf);
  }
  float res = kInf;
#pragma unroll
  for (int c = 0; c < C; ++c)
    if (c * G + lane == w) res = dprev[c];
  return __shfl_sync(gmask, res, w % G, G);
}

template <int G, int C>
__global__ void __launch_bounds__(kWarps * 32)
banded_kernel(const float* __restrict__ A, const float* __restrict__ B,
              int Na, int Nb, int gram, int T, int d, int w,
              float* __restrict__ out) {
  extern __shared__ float smem[];
  constexpr int PPW = 32 / G;           // pairs per warp
  const int warp = threadIdx.x >> 5, l32 = threadIdx.x & 31;
  const int gi = l32 / G, lane = l32 % G;
  const unsigned gmask =
      G == 32 ? 0xffffffffu : (((1u << G) - 1u) << (gi * G));
  const int slot = warp * PPW + gi;
  const long long P = gram ? (long long)Na * Nb : (long long)Na;
  const long long p = (long long)blockIdx.x * (kWarps * PPW) + slot;
  if (p >= P) return;
  const long long a = gram ? p / Nb : p;
  const long long b = gram ? p % Nb : p;
  float* buf = smem + (size_t)slot * (C > 1 ? 3 * C * G : 0);
  const float v = strip_pair<G, C>(A + a * T * d, B + b * T * d, T, d, w,
                                   lane, gmask, buf);
  if (lane == 0) out[p] = v;
}

// One pair's strip sweep by one warp, for strips wider than the register
// templates hold (2w+1 > 256): the previous row and the scan's m and s
// (double-buffered) live in per-pair shared memory, W = 2w+1 floats each,
// and lane l holds strip cells u = l, l + 32, ... The arithmetic is
// strip_pair's, cell for cell. Returns D(T-1, T-1) on every lane.
__device__ float strip_pair_wide(const float* __restrict__ x,
                                 const float* __restrict__ y, int T, int d,
                                 int w, int lane, float* buf) {
  const int W = 2 * w + 1;
  float* sd = buf;              // the previous row
  float* sm[2] = {buf + W, buf + 2 * W};
  float* ss[2] = {buf + 3 * W, buf + 4 * W};
  for (int u = lane; u < W; u += 32) sd[u] = kInf;
  __syncwarp();
  for (int t = 0; t < T; ++t) {
    for (int u = lane; u < W; u += 32) {
      const int j = t - w + u;
      const float cst = (j >= 0 && j < T) ? cost(x, y, t, j, d) : kInf;
      float m;
      if (t == 0) {
        m = u == w ? cst : kInf;   // only cell (0, 0) starts a path
      } else {
        const float top = u + 1 < W ? sd[u + 1] : kInf;
        m = __fadd_rn(cst, fminf(top, sd[u]));
      }
      sm[0][u] = m;
      ss[0][u] = cst;
    }
    __syncwarp();
    int cur = 0;
    for (int dd = 1; dd < W; dd <<= 1) {
      const float* mi = sm[cur];
      const float* si = ss[cur];
      float* mo = sm[cur ^ 1];
      float* so = ss[cur ^ 1];
      for (int u = lane; u < W; u += 32) {
        const float m_sh = u >= dd ? mi[u - dd] : kInf;
        const float s_sh = u >= dd ? si[u - dd] : 0.f;
        mo[u] = fminf(mi[u], __fadd_rn(m_sh, si[u]));
        so[u] = fminf(__fadd_rn(s_sh, si[u]), kInf);
      }
      __syncwarp();
      cur ^= 1;
    }
    // row 0 is not clamped (the reference's), later rows are
    for (int u = lane; u < W; u += 32)
      sd[u] = t == 0 ? sm[cur][u] : fminf(sm[cur][u], kInf);
    __syncwarp();
  }
  return sd[w];
}

__global__ void banded_wide_kernel(const float* __restrict__ A,
                                   const float* __restrict__ B, int Na,
                                   int Nb, int gram, int T, int d, int w,
                                   float* __restrict__ out) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long P = gram ? (long long)Na * Nb : (long long)Na;
  const long long p = (long long)blockIdx.x * (blockDim.x >> 5) + warp;
  if (p >= P) return;
  const long long a = gram ? p / Nb : p;
  const long long b = gram ? p % Nb : p;
  const float v = strip_pair_wide(A + a * T * d, B + b * T * d, T, d, w,
                                  lane, smem + (size_t)warp * 5 * (2 * w + 1));
  if (lane == 0) out[p] = v;
}

int banded_wide(const float* A, const float* B, int Na, int Nb, int gram,
                int T, int d, int w, int warps, float* out,
                cudaStream_t stream) {
  const size_t smem = (size_t)warps * 5 * (2 * w + 1) * 4;
  if (warps < 1 || warps > 32 || smem > 232448)
    return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        banded_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const long long P = gram ? (long long)Na * Nb : (long long)Na;
  const long long grid = (P + warps - 1) / warps;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  banded_wide_kernel<<<dim3((unsigned)grid), dim3(warps * 32), smem,
                       stream>>>(A, B, Na, Nb, gram, T, d, w, out);
  return (int)cudaGetLastError();
}

template <int G, int C>
int banded_gc(const float* A, const float* B, int Na, int Nb, int gram,
              int T, int d, int w, float* out, cudaStream_t stream) {
  constexpr int PPB = kWarps * (32 / G);
  const size_t smem = C > 1 ? (size_t)PPB * 3 * C * G * 4 : 0;
  const long long P = gram ? (long long)Na * Nb : (long long)Na;
  const long long grid = (P + PPB - 1) / PPB;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  banded_kernel<G, C><<<dim3((unsigned)grid), dim3(kWarps * 32), smem,
                        stream>>>(A, B, Na, Nb, gram, T, d, w, out);
  return (int)cudaGetLastError();
}

// ------------------------------------------- K6, one thread per pair ----
//
// For strips of 2w+1 <= 64 cells. One thread owns one pair and holds the
// strip row, padded to WP (the power of two >= 2w+1; 2w+1 is odd, so WP
// is 1, 4, 8, 16, 32 or 64), in registers: m[] the row D_t, s[] the costs
// and then the scan's running sums. The block's 128 pairs have their y
// rows staged into shared memory, ``rows`` strip rows at a time.

constexpr int kThreadPairs = 128;          // pairs (threads) per block
constexpr int kPitch = kThreadPairs + 1;   // floats per staged y row

// Stages y rows j = j0 .. j0 + R - 1 of the block's pairs: slot sl's row jj,
// channel ch at ys[(ch * Rmax + jj) * kPitch + sl], +INF outside [0, T). A
// row with any channel >= INF (or NaN) gets +INF in channel 0, so that
// channel 0 alone carries the reference's pad test (ysl < INF on every
// channel). Each warp copies whole rows, its lanes over j (coalesced); the
// odd pitch puts the 32 lanes' stores in 32 banks.
__device__ __forceinline__ void stage_strip_rows(
    const float* __restrict__ B, long long p0, long long P, int Nb,
    int gram, int T, int d, int j0, int R, int Rmax, float* ys) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int sl = warp; sl < kThreadPairs; sl += kThreadPairs / 32) {
    const long long q = p0 + sl < P ? p0 + sl : P - 1;
    const float* src = B + (gram ? q % Nb : q) * T * d;
    for (int jj = lane; jj < R; jj += 32) {
      const int j = j0 + jj;
      const bool in = j >= 0 && j < T;
      bool bad = !in;
      for (int ch = 0; ch < d; ++ch) {
        const float v = in ? __ldg(src + (size_t)j * d + ch) : kInf;
        bad = bad || !(v < kInf);
        ys[((size_t)ch * Rmax + jj) * kPitch + sl] = v;
      }
      if (bad) ys[(size_t)jj * kPitch + sl] = kInf;
    }
  }
}

// a == b ? x : y, opaque to the compiler: a select over every cell of a
// register row by one run-time index (u == w) can otherwise be folded into
// an indexed access, which moves the row to local memory
__device__ __forceinline__ float pick(int a, int b, float x, float y) {
  float r;
  asm("{\n\t.reg .pred p;\n\tsetp.eq.s32 p, %1, %2;\n\t"
      "selp.f32 %0, %3, %4, p;\n\t}"
      : "=f"(r) : "r"(a), "r"(b), "f"(x), "f"(y));
  return r;
}

// The scan's levels DD, 2 DD, .. < WP over cells u >= DD, u running down
// so that every level reads the previous level's values (see below).
template <int WP, int DD>
__device__ __forceinline__ void scan_levels(float (&m)[WP], float (&s)[WP]) {
#pragma unroll
  for (int u = WP - 1; u >= DD; --u) {
    m[u] = fminf(m[u], __fadd_rn(m[u - DD], s[u]));
    s[u] = fminf(__fadd_rn(s[u - DD], s[u]), kInf);
  }
  if constexpr (2 * DD < WP) scan_levels<WP, 2 * DD>(m, s);
}

template <int WP>
__global__ void __launch_bounds__(kThreadPairs)
banded_thread_kernel(const float* __restrict__ A,
                     const float* __restrict__ B, int Na, int Nb, int gram,
                     int T, int d, int w, int rows,
                     float* __restrict__ out) {
  extern __shared__ float smem[];
  const int slot = threadIdx.x;
  const long long P = gram ? (long long)Na * Nb : (long long)Na;
  const long long p0 = (long long)blockIdx.x * kThreadPairs;
  // the block's tail past the last pair sweeps the last pair again, so
  // that every thread meets the staging barriers
  const long long q = p0 + slot < P ? p0 + slot : P - 1;
  const float* x = A + (gram ? q / Nb : q) * T * d;
  const int W = 2 * w + 1;
  const int Rmax = rows + WP - 1;
  // a cell whose y fails the pad test: +INF at once for one channel; for
  // several, a -INF mark that the channel sums keep negative (or NaN) and
  // the last pass turns into +INF
  const float miss = d == 1 ? kInf : __int_as_float(0xff800000);
  float m[WP], s[WP];
  for (int t0 = 0; t0 < T; t0 += rows) {
    const int nr = min(rows, T - t0);
    __syncthreads();   // the previous chunk's rows have been read
    stage_strip_rows(B, p0, P, Nb, gram, T, d, t0 - w, nr + WP - 1, Rmax,
                     smem);
    __syncthreads();
#pragma unroll 1
    for (int tt = 0; tt < nr; ++tt) {
      const int t = t0 + tt;
      // strip cell u of row t is y row j = t - w + u: staged row tt + u
      const float* yr = smem + (size_t)tt * kPitch + slot;
      const float x0 = __ldg(x + (size_t)t * d);
#pragma unroll
      for (int u = 0; u < WP; ++u) {
        const float yv = yr[u * kPitch];
        const float df = __fsub_rn(x0, yv);
        // cells u >= W pad the row to WP: +INF, so that D_t[W] (the top
        // neighbour of u = W - 1) is +INF as past the reference's strip;
        // u <= WP / 2 is always < W
        const bool ok = yv < kInf && (u <= WP / 2 || u < W);
        s[u] = ok ? __fmul_rn(df, df) : miss;
      }
      if (d > 1) {
        for (int ch = 1; ch < d; ++ch) {
          const float xc = __ldg(x + (size_t)t * d + ch);
          const float* yc = yr + (size_t)ch * Rmax * kPitch;
#pragma unroll
          for (int u = 0; u < WP; ++u) {
            const float df = __fsub_rn(xc, yc[u * kPitch]);
            s[u] = __fadd_rn(s[u], __fmul_rn(df, df));
          }
        }
#pragma unroll
        for (int u = 0; u < WP; ++u) s[u] = s[u] >= 0.f ? s[u] : kInf;
      }
      if (t == 0) {
        // only cell (0, 0) (u = w) starts a path
#pragma unroll
        for (int u = 0; u < WP; ++u) m[u] = pick(u, w, s[u], kInf);
      } else {
        // m[u] still holds D_{t-1}[u]; the top neighbour D_{t-1}[u+1] is
        // read before it is overwritten
#pragma unroll
        for (int u = 0; u < WP; ++u) {
          const float top = u + 1 < WP ? m[u + 1] : kInf;
          m[u] = __fadd_rn(s[u], fminf(top, m[u]));
        }
      }
      // Hillis-Steele min-plus scan, the association of
      // spdtw_block._minplus_scan_lanes: m = min(m, m_sh + s) with the old
      // s, then s = min(s_sh + s, INF) (``scan_levels``). The levels
      // dd < WP are the reference's dd < W, WP being the least power of
      // two >= W. For u < dd the reference's terms are identities:
      // m = min(m, INF + s) keeps m, because m <= c + INF <= INF + s holds
      // at every level (s only grows, and costs are at most INF), and
      // s = min(0 + s, INF) keeps s <= INF; so they are skipped. The scan
      // is a prefix: cells u < W never read the padding u >= W.
      if constexpr (WP > 1) scan_levels<WP, 1>(m, s);
      // row 0 is not clamped (the reference's), later rows are
      if (t > 0) {
#pragma unroll
        for (int u = 0; u < WP; ++u) m[u] = fminf(m[u], kInf);
      }
    }
  }
  float res = kInf;
#pragma unroll
  for (int u = 0; u < WP; ++u) res = pick(u, w, m[u], res);
  if (p0 + slot < P) out[p0 + slot] = res;
}

template <int WP>
int banded_thread(const float* A, const float* B, int Na, int Nb, int gram,
                  int T, int d, int w, int rows, float* out,
                  cudaStream_t stream) {
  const size_t smem = (size_t)(rows + WP - 1) * d * kPitch * 4;
  if (rows < 1 || smem > 232448) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        banded_thread_kernel<WP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const long long P = gram ? (long long)Na * Nb : (long long)Na;
  const long long grid = (P + kThreadPairs - 1) / kThreadPairs;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  banded_thread_kernel<WP><<<dim3((unsigned)grid), dim3(kThreadPairs), smem,
                             stream>>>(A, B, Na, Nb, gram, T, d, w, rows,
                                       out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// (P,) aligned-pair DTW on anti-diagonals: X, Y (P, T, d); radius < 0: no
// corridor.
int dtw_wavefront(const float* X, const float* Y, int P, int T, int d,
                  int radius, float* out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int per_lane = (T + 31) / 32;
  if (T < 1 || d < 1) return (int)cudaErrorInvalidValue;
  if (d > kRegChannels || per_lane > 16)
    return wavefront_wide(X, Y, P, T, d, radius, out, st);
  if (per_lane <= 1) return wavefront_c<1>(X, Y, P, T, d, radius, out, st);
  if (per_lane <= 2) return wavefront_c<2>(X, Y, P, T, d, radius, out, st);
  if (per_lane <= 4) return wavefront_c<4>(X, Y, P, T, d, radius, out, st);
  if (per_lane <= 8) return wavefront_c<8>(X, Y, P, T, d, radius, out, st);
  return wavefront_c<16>(X, Y, P, T, d, radius, out, st);
}

// Sakoe-Chiba DTW of half-width w in the slanted strip. gram != 0: the
// (Na, Nb) grid of A rows x B rows; gram == 0: the (Na,) aligned pairs
// (A row p, B row p). A (Na, T, d), B (Nb, T, d). ``route`` picks the
// template (``dtw_banded.banded_geometry``): 0 "lanes" (2w+1 <= 256),
// 1 "thread" (2w+1 <= 64; ``param`` strip rows staged at a time), 2
// "wide" (any width; ``param`` pairs per block).
int dtw_banded(const float* A, const float* B, int Na, int Nb, int gram,
               int T, int d, int w, int route, int param, float* out,
               void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int W = 2 * w + 1;
  if (T < 1 || d < 1 || w < 0) return (int)cudaErrorInvalidValue;
  if (route == 1) {
#define THREAD(WP) \
  banded_thread<WP>(A, B, Na, Nb, gram, T, d, w, param, out, st)
    if (W <= 1) return THREAD(1);
    if (W <= 4) return THREAD(4);
    if (W <= 8) return THREAD(8);
    if (W <= 16) return THREAD(16);
    if (W <= 32) return THREAD(32);
    if (W <= 64) return THREAD(64);
#undef THREAD
    return (int)cudaErrorInvalidValue;
  }
  if (route == 0) {
#define BANDED(G, C) banded_gc<G, C>(A, B, Na, Nb, gram, T, d, w, out, st)
    if (W <= 1) return BANDED(1, 1);
    if (W <= 4) return BANDED(4, 1);
    if (W <= 8) return BANDED(8, 1);
    if (W <= 16) return BANDED(16, 1);
    if (W <= 32) return BANDED(32, 1);
    if (W <= 64) return BANDED(32, 2);
    if (W <= 128) return BANDED(32, 4);
    if (W <= 256) return BANDED(32, 8);
#undef BANDED
    return (int)cudaErrorInvalidValue;
  }
  if (route == 2)
    return banded_wide(A, B, Na, Nb, gram, T, d, w, param, out, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
