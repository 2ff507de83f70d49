// Block-sparse soft-SP-DTW tile engines for Hopper (sm_90a): the forward
// (``soft_tiles_fwd``), the forward with the L-block stash
// (``soft_tiles_stash``) and the reverse expected-alignment sweep
// (``soft_tiles_bwd``), each in Gram mode (A x B cross-product, pair
// p = a * Nb + b) and paired mode (row p of each side).
//
// What they replace.
//   soft_tiles_fwd   <- src/repro/kernels/soft_block.py _gram_soft_kernel
//                       (entry gram_soft_spdtw_block), the TPU kernel K7;
//   soft_tiles_stash <- _gram_soft_stash_kernel
//                       (entry gram_soft_fwd_stash_pallas), K8;
//   soft_tiles_bwd   <- _gram_soft_bwd_kernel (entry gram_soft_bwd_pallas),
//                       K9.
// The forward walks the row-major plan of ``occupancy._tile_plan`` through
// the result tile and runs ``soft_block.soft_tile_sweep``: the min-plus
// DP of ``spdtw_tiles.cu`` in the (logaddexp, +) semiring on L = -R/gamma,
// with NEG = -1e30 for "unreachable". K7 and K8 share their sweeps, so
// their values agree bit for bit. The backward walks ``BlockSparsePaths.reverse_plan(g_out)`` and
// runs ``soft_block.soft_reverse_tile_sweep``, the E recursion of
// ``core.softdtw._expected_alignment`` restricted to the walked tiles, and
// contracts E with the local-cost derivatives. Unlike the TPU kernels,
// K8 and K9 take d channels (tile-major, channel-inner) like K1.
//
// What bounds them on this card. Per needed cell the forward does two
// logaddexps (an expf and a log1pf each) and ~3d + 4 FP32 operations; the
// backward three expf (the transition coefficients) and the cotangent
// terms; expf and log1pf run on the special-function unit, so the
// operation bound is the SFU rate. K8 also writes 4 S^2 bytes per pair per
// walked tile and K9 reads them back, which at the Gram sizes of the
// training path makes the stash traffic a second bound. At the barycenter
// shapes (~250 pairs) no bound is near: a launch lasts as long as one
// pair's chain of dependent cells.
//
// The forward's arithmetic is the plain version's, the scan twin
// ``soft_block._soft_sweep_core``: per row, g_j = t_j + lae(L(t-1, j),
// L(t-1, j-1)) (column 0 then folds in the left tile's column), and the
// in-row recurrence L_j = lae(g_j, L_{j-1} + t_j) solved by a
// Hillis-Steele scan of log2 S levels, 1 + log2 S logaddexps per cell
// where the bound counts 2. A serial solve (2 per cell) was measured and
// not kept: it rounds differently, and at the 4000 x 1000 soft Gram it
// left values that cancel to ~2e-5 up to 3% (relative) away from the scan
// (ROADMAP section C); the scan keeps the card's values equal to the CPU
// path's bit for bit.
//
// What the design does about it: two templates per kernel, picked by the
// wrapper from the number of pairs P (``soft_block.soft_geometry``).
//   pairs (large P: the 4000 x 1000 soft Gram, the 1000 x 1000 stash
//     forward). K7 / K8 run one thread per pair, as K1 does: the tile's
//     previous row and the row's scan in registers, the row and column
//     edges in shared memory (thread-interleaved), the step's weight block
//     staged in shared memory once per block (so every thread meets every
//     barrier; threads past the last pair rerun pair P - 1 and write
//     nothing), no shuffles, and each stash row written as S contiguous
//     floats. K9 keeps S lanes per pair, lane = tile column, rows
//     bottom-up with the in-row E recurrence a lane-flipped Hillis-Steele
//     scan; its halos (E/L/t top rows, Tp each; the right tile's left
//     column, double-buffered) sit in shared memory per pair.
//   tiles (small P: paired mode at the barycenter shapes). One pair per
//     block; groups of S lanes sweep the tiles of one tile anti-diagonal
//     of the plan at once, one barrier per diagonal (15 diagonals instead
//     of 64 tiles in sequence at T = 128, S = 16). In K7 / K8 lane j owns
//     column j of its tile and the rows run in order, each row's scan in
//     log2 S shuffle steps: the same arithmetic as the pairs template, so
//     the two agree bit for bit. K9 runs the pairs template's per-tile
//     body (``reverse_tile``) on the reverse diagonals.
//   Shared edges of the tiles template: bottom rows per tile column,
//   right columns per tile row (double-buffered by the parity of tj, so a
//   tile never reads and writes one buffer), and the corner each tile hands
//   to its diagonal successor in a buffer of its own, indexed by ti - tj:
//   the bottom-edge slot it came from is rewritten one diagonal earlier by
//   the left neighbour. Tiles of one diagonal have distinct ti and distinct
//   tj, and per ti (per tj) the diagonals visit tj (ti) in plan order, so
//   K9's gx, gy and E blocks equal the pairs template's bit for bit.
//
// Determinism. The TPU kernel summed the cotangents in output blocks that
// its sequential grid revisited; here blocks run in no order. Each pair's
// series cotangents accumulate in its own rows of gx / gy (P, d * Tp) in
// plan order, one writer each; the weight gradient of each reverse step is
// one partial per block (pairs template: summed over the block's pairs in
// slot order) or per pair (tiles template), gw_part (n_parts, K, S * S).
// The wrapper sums the partials, and in Gram mode the per-pair rows, in a
// fixed order, so gradients do not change from run to run. No float
// atomics.
//
// Floating point. The logits, the logaddexp (max + log1pf(expf(-|a-b|)),
// the formula of the plain version), the recurrences and the edge updates
// use the _rn intrinsics in the plain version's order, and the file is
// built with --fmad=false, so the forward equals the plain PyTorch
// version on the card bit for bit (its expf / log1pf are these). The
// backward's sums over a row and over a column run in another order than
// PyTorch's.
//
// C interface (bound with ctypes): every function returns
// cudaGetLastError() after its launch (0 = launched), or an error code
// without launching when the geometry it is given does not fit.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1.0e30f;
constexpr float kHalfNeg = -0.5e30f;
constexpr float kInf = 1.0e30f;
constexpr float kSFloor = -1.0e35f;   // floor of the in-row scan's sum
constexpr int kWarps = 4;             // warps per block, K9's pairs template
constexpr int kTilesThreads = 512;    // most threads of a tiles-template block
constexpr size_t kSmemMax = 232448;   // shared memory a block may use

template <int S>
struct Geo {
  static constexpr int PPW = 32 / S;            // pairs per warp
  static constexpr int PPB = kWarps * PPW;      // pairs per block
};

// the S lanes of this thread's group (S divides 32)
template <int S>
__device__ __forceinline__ unsigned group_mask() {
  const int gi = (threadIdx.x & 31) / S;
  return S == 32 ? 0xffffffffu : (((1u << S) - 1u) << (gi * S));
}

// logaddexp as the plain version computes it
__device__ __forceinline__ float lae(float a, float b) {
  const float delta = __fsub_rn(a, b);
  return __fadd_rn(fmaxf(a, b), log1pf(expf(-fabsf(delta))));
}

// phi(t, j) = sum_k (x_k[t] - y_k[j])^2, channels left to right
template <int S>
__device__ __forceinline__ float sq_dist(const float* __restrict__ xt,
                                         const float* __restrict__ yt, int d,
                                         int t, int j) {
  float acc = 0.f;
  for (int k = 0; k < d; ++k) {
    const float df = __fsub_rn(xt[k * S + t], yt[k * S + j]);
    const float dk = __fmul_rn(df, df);
    acc = k == 0 ? dk : __fadd_rn(acc, dk);
  }
  return acc;
}

// t(t, j) = (w phi) * (-1/gamma), NEG outside the support
__device__ __forceinline__ float logit(float phi, float wv, float ninv) {
  return wv > 0.f ? __fmul_rn(__fmul_rn(phi, wv), ninv) : kNeg;
}

// the transition probability exp(L_from + t_succ - L_succ), clipped
__device__ __forceinline__ float coeff(float Lf, float ts, float Ls) {
  const bool ok = Lf > kHalfNeg && ts > kHalfNeg && Ls > kHalfNeg;
  const float e = fminf(fmaxf(__fsub_rn(__fadd_rn(Lf, ts), Ls), -80.f), 80.f);
  return ok ? expf(e) : 0.f;
}

// _from_L: the soft distance, +INF when unreachable
__device__ __forceinline__ float from_L(float L, float gamma) {
  return L > kHalfNeg ? __fmul_rn(-gamma, L) : kInf;
}

// ------------------------------------------------ K7 / K8, pairs template

// shared floats of one block of nt threads: row edges, right columns, the
// weight block, and the y tiles when they do not sit in registers
template <int S, int D>
constexpr size_t pairs_fwd_floats(int Tp, int d, int nt) {
  return (size_t)nt * (Tp + S) + S * S + (D == 0 ? (size_t)nt * d * S : 0);
}

// One thread per pair over the plan steps 0..n_steps-1 (n_steps =
// g_out + 1); D > 0: the y tile in registers, D channels.
template <int S, int D, bool STASH>
__global__ void pairs_fwd_kernel(const float* __restrict__ A,
                                 const float* __restrict__ B, int Na, int Nb,
                                 int gram, int d, int Tp,
                                 const int* __restrict__ meta, int n_steps,
                                 const float* __restrict__ blocks, float ninv,
                                 float gamma, int g_out, int r,
                                 float* __restrict__ out,
                                 float* __restrict__ stash) {
  extern __shared__ float smem[];
  const int nt = blockDim.x, slot = threadIdx.x;
  const long long P = gram ? (long long)Na * Nb : (long long)Na;
  const long long p = (long long)blockIdx.x * nt + slot;
  const bool real = p < P;
  const long long q = real ? p : P - 1;
  const long long a = gram ? q / Nb : q, b = gram ? q % Nb : q;
  const float* __restrict__ x = A + a * d * Tp;
  const float* __restrict__ y = B + b * d * Tp;
  float* row_edge = smem;                       // [Tp][nt]
  float* col = row_edge + (size_t)nt * Tp;      // [S][nt]
  float* ws = col + (size_t)nt * S;             // [S * S]
  float* ysh = ws + S * S;                      // [d * S][nt] when D == 0
  const size_t stride = (size_t)P * S * S;
  float* __restrict__ st = stash + (size_t)q * S * S;

  for (int j = 0; j < Tp; ++j) row_edge[(size_t)j * nt + slot] = kNeg;
  for (int t = 0; t < S; ++t) col[t * nt + slot] = kNeg;
  float corner = kNeg;   // the top row's last cell of the previous step
  float res = kNeg;
  float yv[D > 0 ? D : 1][S];

  for (int k = 0; k < n_steps; ++k) {
    const int* m = meta + 7 * k;
    const int ti = m[0], tj = m[1], wslot = m[2];
    const bool top_ok = m[3] > 0, left_ok = m[4] > 0, diag_ok = m[5] > 0;
    __syncthreads();   // every thread is done with the previous block
    for (int e = slot; e < S * S; e += nt)
      ws[e] = __ldg(blocks + (size_t)wslot * S * S + e);
    __syncthreads();
    float dp[S];
#pragma unroll
    for (int j = 0; j < S; ++j)
      dp[j] = top_ok ? row_edge[(size_t)(tj * S + j) * nt + slot] : kNeg;
    float c_first;
    if (k == 0) c_first = 0.f;
    else if (diag_ok)
      c_first = left_ok ? corner : row_edge[(size_t)(tj * S - 1) * nt + slot];
    else c_first = kNeg;
    const float new_corner = dp[S - 1];
    const float* __restrict__ xt = x + (size_t)ti * d * S;
    const float* __restrict__ yt = y + (size_t)tj * d * S;
    if constexpr (D > 0) {
#pragma unroll
      for (int kk = 0; kk < D; ++kk)
#pragma unroll
        for (int j4 = 0; j4 < S / 4; ++j4) {
          const float4 v = __ldg(reinterpret_cast<const float4*>(
              yt + kk * S) + j4);
          yv[kk][4 * j4] = v.x;
          yv[kk][4 * j4 + 1] = v.y;
          yv[kk][4 * j4 + 2] = v.z;
          yv[kk][4 * j4 + 3] = v.w;
        }
    } else {
      for (int e = 0; e < d * S; ++e) ysh[(size_t)e * nt + slot] = __ldg(yt + e);
    }
    float tl0 = c_first;
#pragma unroll 1
    for (int t = 0; t < S; ++t) {
      const float lt = left_ok ? col[t * nt + slot] : kNeg;
      float xv[D > 0 ? D : 1];
      if constexpr (D > 0) {
#pragma unroll
        for (int kk = 0; kk < D; ++kk) xv[kk] = __ldg(xt + kk * S + t);
      }
      float mm[S], ss[S];
#pragma unroll
      for (int j = 0; j < S; ++j) {
        float acc = 0.f;
        if constexpr (D > 0) {
#pragma unroll
          for (int kk = 0; kk < D; ++kk) {
            const float df = __fsub_rn(xv[kk], yv[kk][j]);
            const float dk = __fmul_rn(df, df);
            acc = kk == 0 ? dk : __fadd_rn(acc, dk);
          }
        } else {
          for (int kk = 0; kk < d; ++kk) {
            const float df = __fsub_rn(__ldg(xt + kk * S + t),
                                       ysh[(size_t)(kk * S + j) * nt + slot]);
            const float dk = __fmul_rn(df, df);
            acc = kk == 0 ? dk : __fadd_rn(acc, dk);
          }
        }
        ss[j] = logit(acc, ws[t * S + j], ninv);
        // topleft: column j-1 of the previous row; column 0 takes tl0
        const float tl = j ? dp[j - 1] : tl0;
        mm[j] = __fadd_rn(ss[j], lae(dp[j], tl));
      }
      // the left tile's boundary enters as a virtual L_{-1}
      mm[0] = lae(mm[0], __fadd_rn(lt, ss[0]));
      // Hillis-Steele scan of L_j = lae(m_j, L_{j-1} + s_j), the
      // association of soft_block._logaddexp_scan_lanes: m = lae(m, m_sh +
      // s) with the old s, then s = max(s_sh + s, S_FLOOR); j runs down
      // so that every level reads the previous level's values. For j < dd
      // the term is lae(m, NEG + s) with s <= 0: m itself when m is
      // reachable (expf underflows to 0, m + 0 = m), so only unreachable
      // cells (whose sums are not negligible) pay for it. Reachability
      // follows the support, which every pair shares: no divergence.
#pragma unroll
      for (int dd = 1; dd < S; dd <<= 1) {
#pragma unroll
        for (int j = S - 1; j >= 0; --j) {
          if (j >= dd) {
            mm[j] = lae(mm[j], __fadd_rn(mm[j - dd], ss[j]));
            ss[j] = fmaxf(__fadd_rn(ss[j - dd], ss[j]), kSFloor);
          } else {
            if (!(mm[j] > kHalfNeg))
              mm[j] = lae(mm[j], __fadd_rn(kNeg, ss[j]));
            ss[j] = fmaxf(__fadd_rn(0.f, ss[j]), kSFloor);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < S; ++j) dp[j] = mm[j];
      if (k == g_out && t == r) {
        // cell r of the row as a sum of masked terms: a select of mm[r]
        // would index the array at run time and put it in local memory
        float pick = 0.f;
#pragma unroll
        for (int j = 0; j < S; ++j)
          pick = __fadd_rn(pick, j == r ? mm[j] : 0.f);
        res = pick;
      }
      col[t * nt + slot] = dp[S - 1];
      if (STASH && real) {
        float4* row = reinterpret_cast<float4*>(st + (size_t)k * stride +
                                                t * S);
#pragma unroll
        for (int j4 = 0; j4 < S / 4; ++j4)
          row[j4] = make_float4(dp[4 * j4], dp[4 * j4 + 1], dp[4 * j4 + 2],
                                dp[4 * j4 + 3]);
      }
      tl0 = lt;
    }
#pragma unroll
    for (int j = 0; j < S; ++j)
      row_edge[(size_t)(tj * S + j) * nt + slot] = dp[j];
    corner = new_corner;
  }
  if (real) out[p] = from_L(res, gamma);
}

// ------------------------------------------------ K7 / K8, tiles template

// shared floats of one block: bottom rows (Tp), right columns (2 Tp) and
// corners (2 Ti)
__host__ __device__ constexpr size_t tiles_fwd_floats(int Tp, int S) {
  return 3 * (size_t)Tp + 2 * (size_t)(Tp / S);
}

// One pair per block; the groups of S lanes sweep the tiles of one tile
// anti-diagonal at once (``order`` / ``dptr``: the plan steps diagonal by
// diagonal), lane j on column j of its tile, the rows in order.
template <int S, bool STASH>
__global__ void __launch_bounds__(kTilesThreads, 1)
tiles_fwd_kernel(const float* __restrict__ A,
                                 const float* __restrict__ B, int Na, int Nb,
                                 int gram, int d, int Tp,
                                 const int* __restrict__ meta,
                                 const int* __restrict__ order,
                                 const int* __restrict__ dptr, int n_diag,
                                 const float* __restrict__ blocks, float ninv,
                                 float gamma, int g_out, int r,
                                 float* __restrict__ out,
                                 float* __restrict__ stash) {
  extern __shared__ float smem[];
  const int Ti = Tp / S;
  const long long P = gram ? (long long)Na * Nb : (long long)Na;
  const long long p = blockIdx.x;
  const long long a = gram ? p / Nb : p, b = gram ? p % Nb : p;
  const float* __restrict__ x = A + a * d * Tp;
  const float* __restrict__ y = B + b * d * Tp;
  const int G = blockDim.x / S, group = threadIdx.x / S;
  const int lane = threadIdx.x % S;
  const unsigned gmask = group_mask<S>();
  float* bottom = smem;               // [Tp]: by tile column
  float* right = bottom + Tp;         // [2][Tp]: parity of tj, tile row
  float* corners = right + 2 * Tp;    // [2 Ti]: by ti - tj + Ti - 1
  for (int i = threadIdx.x; i < (int)tiles_fwd_floats(Tp, S); i += blockDim.x)
    smem[i] = kNeg;
  __syncthreads();
  const size_t stride = (size_t)P * S * S;
  float* __restrict__ st = stash + (size_t)p * S * S;

  for (int qd = 0; qd < n_diag; ++qd) {
    for (int e = dptr[qd] + group; e < dptr[qd + 1]; e += G) {
      const int k = order[e];
      const int* m = meta + 7 * k;
      const int ti = m[0], tj = m[1], wslot = m[2];
      const bool top_ok = m[3] > 0, left_ok = m[4] > 0, diag_ok = m[5] > 0;
      const int cidx = ti - tj + Ti - 1;
      // the left tile (ti, tj - 1) wrote the buffer of parity (tj - 1) & 1
      const float* lin = right + ((tj + 1) & 1) * Tp + ti * S;
      float* rout = right + (tj & 1) * Tp + ti * S;
      float prev = top_ok ? bottom[tj * S + lane] : kNeg;
      const float c_first = k == 0 ? 0.f : (diag_ok ? corners[cidx] : kNeg);
      __syncwarp(gmask);   // corners[cidx] is read before it is rewritten
      const float* __restrict__ w = blocks + (size_t)wslot * S * S;
      const float* __restrict__ xt = x + (size_t)ti * d * S;
      const float* __restrict__ yt = y + (size_t)tj * d * S;
      float tl0 = c_first;
#pragma unroll 1
      for (int t = 0; t < S; ++t) {
        const float lt = left_ok ? lin[t] : kNeg;
        const float tr = logit(sq_dist<S>(xt, yt, d, t, lane),
                               __ldg(w + t * S + lane), ninv);
        // topleft: column j-1 of the previous row; column 0 takes tl0
        const float sh = __shfl_up_sync(gmask, prev, 1, S);
        const float tl = lane == 0 ? tl0 : sh;
        float g = __fadd_rn(tr, lae(prev, tl));
        // the left tile's boundary enters as a virtual L_{-1}
        if (lane == 0) g = lae(g, __fadd_rn(lt, tr));
        // Hillis-Steele scan of L_j = lae(g_j, L_{j-1} + t_j), the
        // association of soft_block._logaddexp_scan_lanes
        float mm = g, ss = tr;
#pragma unroll
        for (int dd = 1; dd < S; dd <<= 1) {
          float m_sh = __shfl_up_sync(gmask, mm, dd, S);
          float s_sh = __shfl_up_sync(gmask, ss, dd, S);
          if (lane < dd) { m_sh = kNeg; s_sh = 0.f; }
          const float nm = lae(mm, __fadd_rn(m_sh, ss));
          ss = fmaxf(__fadd_rn(s_sh, ss), kSFloor);
          mm = nm;
        }
        if (lane == S - 1) rout[t] = mm;
        if (STASH) st[(size_t)k * stride + t * S + lane] = mm;
        if (k == g_out && t == r && lane == r) out[p] = from_L(mm, gamma);
        prev = mm;
        tl0 = lt;
      }
      bottom[tj * S + lane] = prev;
      if (lane == S - 1) corners[cidx] = prev;
    }
    __syncthreads();
  }
}

// ------------------------------------------------------------------- K9

struct Halo {
  float E, L, t;
};

// One tile of the reverse sweep for one pair on S lanes (lane = tile
// column), rows bottom-up: ``soft_block.soft_reverse_tile_sweep``. ``bel``
// is the tile below's top-row cell of this lane, ``cor`` the below-right
// tile's top-left cell; ``cin`` / ``cout`` the right tile's left column
// and this tile's (E at [0, S), L at [cs, cs + S), t at [2 cs, 2 cs + S)).
// Accumulates the pair's gx rows ``gxr`` and gy columns ``gyr``, writes
// E phi gbar to ``gwd`` and E to ``ed`` (when not null). Returns this
// lane's cell of the top row.
template <int S>
__device__ Halo reverse_tile(const float* __restrict__ xt,
                             const float* __restrict__ yt, int d,
                             const float* __restrict__ w,
                             const float* __restrict__ Lb, float ninv,
                             Halo bel, Halo cor, bool right_ok,
                             const float* cin, int cs, float* cout,
                             bool inject, int ri, int rj, float gb,
                             bool valid, float* __restrict__ gxr,
                             float* __restrict__ gyr, float* gyacc,
                             float* gwd, float* __restrict__ ed, int lane,
                             unsigned gmask) {
  for (int c = 0; c < d; ++c) gyacc[c * S + lane] = 0.f;
  float colEw = 0.f;
  float E_next = bel.E, L_next = bel.L, t_next = bel.t;
  __syncwarp(gmask);

#pragma unroll 1
  for (int u = 0; u < S; ++u) {
    const int r = S - 1 - u;
    const float L_row = Lb[r * S + lane];
    const float wv = w[r * S + lane];
    const float phi = sq_dist<S>(xt, yt, d, r, lane);
    const float t_row = logit(phi, wv, ninv);
    // boundary cell (r+1, S): the below-right corner at the bottom row,
    // the right tile's left column at row r+1 elsewhere
    float eE, eL, et;
    if (r == S - 1) {
      eE = cor.E; eL = cor.L; et = cor.t;
    } else {
      eE = right_ok ? cin[r + 1] : 0.f;
      eL = right_ok ? cin[cs + r + 1] : kNeg;
      et = right_ok ? cin[2 * cs + r + 1] : kNeg;
    }
    const float av = coeff(L_row, t_next, L_next);            // (r+1, j)
    float t_ns = __shfl_down_sync(gmask, t_next, 1, S);
    float L_ns = __shfl_down_sync(gmask, L_next, 1, S);
    float E_ns = __shfl_down_sync(gmask, E_next, 1, S);
    if (lane == S - 1) { t_ns = et; L_ns = eL; E_ns = eE; }
    const float cv = coeff(L_row, t_ns, L_ns);                 // (r+1, j+1)
    float f = __fadd_rn(__fmul_rn(av, E_next), __fmul_rn(cv, E_ns));
    f = __fadd_rn(f, (inject && r == ri && lane == rj) ? 1.f : 0.f);
    // within-row successor (r, j+1); column S lives in the right tile
    const float rrE = right_ok ? cin[r] : 0.f;
    const float rrL = right_ok ? cin[cs + r] : kNeg;
    const float rrt = right_ok ? cin[2 * cs + r] : kNeg;
    float t_rs = __shfl_down_sync(gmask, t_row, 1, S);
    float L_rs = __shfl_down_sync(gmask, L_row, 1, S);
    if (lane == S - 1) { t_rs = rrt; L_rs = rrL; }
    const float bv = coeff(L_row, t_rs, L_rs);                 // (r, j+1)
    // fold the cross-tile b-transition into f, then solve
    // E_j = b_j E_{j+1} + f_j right to left (the flipped-lane scan of
    // soft_block._linrec_scan_lanes)
    if (lane == S - 1) f = __fadd_rn(f, __fmul_rn(bv, rrE));
    float mm = f, ss = bv;
#pragma unroll
    for (int dd = 1; dd < S; dd <<= 1) {
      float m_sh = __shfl_down_sync(gmask, mm, dd, S);
      float s_sh = __shfl_down_sync(gmask, ss, dd, S);
      if (lane + dd >= S) { m_sh = 0.f; s_sh = 1.f; }
      mm = __fadd_rn(mm, __fmul_rn(m_sh, ss));
      ss = __fmul_rn(ss, s_sh);
    }
    const float E = mm;
    if (ed != nullptr && valid) ed[r * S + lane] = E;
    if (lane == 0) {
      cout[r] = E;
      cout[cs + r] = L_row;
      cout[2 * cs + r] = t_row;
    }
    // cotangents: gw(r, j) = E phi gbar; gx(r) from the row sums of
    // E w and E w y; gy(j) from the column sums of E w and E w x
    gwd[r * S + lane] = valid ? __fmul_rn(__fmul_rn(E, phi), gb) : 0.f;
    const float Ew = __fmul_rn(E, wv);
    colEw = __fadd_rn(colEw, Ew);
    float sEw = Ew;
    for (int off = S / 2; off > 0; off >>= 1)
      sEw = __fadd_rn(sEw, __shfl_xor_sync(gmask, sEw, off, S));
    for (int c = 0; c < d; ++c) {
      const float xr = xt[c * S + r];
      gyacc[c * S + lane] = __fadd_rn(gyacc[c * S + lane],
                                      __fmul_rn(Ew, xr));
      float sEwy = __fmul_rn(Ew, yt[c * S + lane]);
      for (int off = S / 2; off > 0; off >>= 1)
        sEwy = __fadd_rn(sEwy, __shfl_xor_sync(gmask, sEwy, off, S));
      if (lane == 0 && valid) {
        const float g = __fmul_rn(
            __fmul_rn(2.f, __fsub_rn(__fmul_rn(xr, sEw), sEwy)), gb);
        gxr[c * S + r] = __fadd_rn(gxr[c * S + r], g);
      }
    }
    E_next = E; L_next = L_row; t_next = t_row;
  }
  // gy of this tile's columns
  if (valid) {
    for (int c = 0; c < d; ++c) {
      const float yj = yt[c * S + lane];
      const float g = __fmul_rn(
          __fmul_rn(-2.f, __fsub_rn(gyacc[c * S + lane],
                                    __fmul_rn(yj, colEw))), gb);
      gyr[c * S + lane] = __fadd_rn(gyr[c * S + lane], g);
    }
  }
  Halo h;
  h.E = E_next; h.L = L_next; h.t = t_next;
  return h;
}

// K9, pairs template: S lanes per pair, every pair of a block walks the
// same reverse plan, so the block synchronises once per tile to sum the
// weight gradient over its pairs. Slots past the last pair run on pair
// P - 1 with a zero cotangent and write nothing of their own.
template <int S>
__global__ void __launch_bounds__(kWarps * 32)
pairs_bwd_kernel(const float* __restrict__ A, const float* __restrict__ B,
                 int Na, int Nb, int gram, int d, int Tp,
                 const int* __restrict__ rmeta, int K,
                 const float* __restrict__ blocks, float ninv,
                 const float* __restrict__ stash,
                 const float* __restrict__ gbar, int ri, int rj,
                 float* __restrict__ gx, float* __restrict__ gy,
                 float* __restrict__ gw_part, float* __restrict__ eout) {
  extern __shared__ float smem[];
  constexpr int PPB = Geo<S>::PPB;
  const int slot = (threadIdx.x >> 5) * Geo<S>::PPW + (threadIdx.x & 31) / S;
  const int lane = threadIdx.x % S;
  const unsigned gmask = group_mask<S>();
  const long long P = gram ? (long long)Na * Nb : (long long)Na;
  const long long p_raw = (long long)blockIdx.x * PPB + slot;
  const bool valid = p_raw < P;
  const long long p = valid ? p_raw : P - 1;
  const long long a = gram ? p / Nb : p, b = gram ? p % Nb : p;
  const float* __restrict__ x = A + a * d * Tp;
  const float* __restrict__ y = B + b * d * Tp;
  const float gb = valid ? gbar[p] : 0.f;
  const size_t stride = (size_t)P * S * S;
  const float* __restrict__ Lp = stash + (size_t)p * S * S;
  float* __restrict__ gxp = gx + (size_t)p * d * Tp;
  float* __restrict__ gyp = gy + (size_t)p * d * Tp;

  // per-pair shared state: E/L/t top halos, two left-column buffers, the
  // tile's weight-gradient block and the column accumulators of gy
  const int per_pair = 3 * Tp + 6 * S + S * S + d * S;
  float* topE = smem + (size_t)slot * per_pair;
  float* topL = topE + Tp;
  float* topt = topL + Tp;
  float* colbuf = topt + Tp;               // [2][3][S]
  float* gwt = colbuf + 6 * S;             // [S][S]
  float* gyacc = gwt + S * S;              // [d][S]
  float* gw_all = smem;                    // slot-major, for the reduction

  for (int j = lane; j < Tp; j += S) {
    topE[j] = 0.f;
    topL[j] = kNeg;
    topt[j] = kNeg;
  }
  for (int h = 0; h < 2; ++h) {
    colbuf[h * 3 * S + lane] = 0.f;
    colbuf[h * 3 * S + S + lane] = kNeg;
    colbuf[h * 3 * S + 2 * S + lane] = kNeg;
  }
  Halo corn = {0.f, kNeg, kNeg};
  __syncwarp(gmask);

  for (int k = 0; k < K; ++k) {
    const int* m = rmeta + 7 * k;
    const int ti = m[0], tj = m[1], wslot = m[2];
    const bool below_ok = m[3] > 0, right_ok = m[4] > 0, diag_ok = m[5] > 0;
    const int fstep = m[6];
    const float* cin = colbuf + (k & 1) * 3 * S;         // right tile's
    float* cout = colbuf + ((k & 1) ^ 1) * 3 * S;        // this tile's
    Halo bel;
    bel.E = below_ok ? topE[tj * S + lane] : 0.f;
    bel.L = below_ok ? topL[tj * S + lane] : kNeg;
    bel.t = below_ok ? topt[tj * S + lane] : kNeg;
    // below-right corner: the saved cell when the right tile was just
    // swept, else a direct read of the top halo
    Halo cor = {0.f, kNeg, kNeg};
    if (diag_ok) {
      if (right_ok) {
        cor = corn;
      } else {
        const int dcol = min((tj + 1) * S, Tp - 1);
        cor.E = topE[dcol]; cor.L = topL[dcol]; cor.t = topt[dcol];
      }
    }
    Halo ncor;
    ncor.E = below_ok ? topE[tj * S] : 0.f;
    ncor.L = below_ok ? topL[tj * S] : kNeg;
    ncor.t = below_ok ? topt[tj * S] : kNeg;
    const Halo h = reverse_tile<S>(
        x + (size_t)ti * d * S, y + (size_t)tj * d * S, d,
        blocks + (size_t)wslot * S * S, Lp + (size_t)fstep * stride, ninv,
        bel, cor, right_ok, cin, S, cout, k == 0, ri, rj, gb, valid,
        gxp + (size_t)ti * d * S, gyp + (size_t)tj * d * S, gyacc, gwt,
        eout == nullptr ? nullptr
                        : eout + (size_t)k * stride + (size_t)p * S * S,
        lane, gmask);
    // publish the halos for the upstream (reverse-order) tiles: the top
    // row (E, L, t of row 0) and the saved below-right corner
    __syncwarp(gmask);
    topE[tj * S + lane] = h.E;
    topL[tj * S + lane] = h.L;
    topt[tj * S + lane] = h.t;
    corn = ncor;
    // the weight gradient of this step, summed over the block's pairs in
    // slot order
    __syncthreads();
    for (int cell = threadIdx.x; cell < S * S; cell += blockDim.x) {
      float s = 0.f;
      for (int qq = 0; qq < PPB; ++qq)
        s = __fadd_rn(s, gw_all[qq * per_pair + 3 * Tp + 6 * S + cell]);
      gw_part[((size_t)blockIdx.x * K + k) * S * S + cell] = s;
    }
    __syncthreads();
  }
}

// shared floats of one block of K9's tiles template with G lane groups:
// E/L/t top halos (3 Tp), left-column halos (2 x 3 Tp), corners (3 x 2 Ti)
// and the gy column sums of every group (G d S)
__host__ __device__ constexpr size_t tiles_bwd_floats(int Tp, int S, int d,
                                                      int G) {
  return 9 * (size_t)Tp + 6 * (size_t)(Tp / S) + (size_t)G * d * S;
}

// K9, tiles template: one pair per block, its lane groups sweep the tiles
// of one reverse tile anti-diagonal at once (``order`` / ``dptr``: the
// reverse steps diagonal by diagonal). The weight gradient of pair p at
// reverse step k is gw_part[p][k].
template <int S>
__global__ void __launch_bounds__(kTilesThreads, 1)
tiles_bwd_kernel(const float* __restrict__ A,
                                 const float* __restrict__ B, int Na, int Nb,
                                 int gram, int d, int Tp,
                                 const int* __restrict__ rmeta, int K,
                                 const int* __restrict__ order,
                                 const int* __restrict__ dptr, int n_diag,
                                 const float* __restrict__ blocks, float ninv,
                                 const float* __restrict__ stash,
                                 const float* __restrict__ gbar, int ri,
                                 int rj, float* __restrict__ gx,
                                 float* __restrict__ gy,
                                 float* __restrict__ gw_part,
                                 float* __restrict__ eout) {
  extern __shared__ float smem[];
  const int Ti = Tp / S;
  const long long P = gram ? (long long)Na * Nb : (long long)Na;
  const long long p = blockIdx.x;
  const long long a = gram ? p / Nb : p, b = gram ? p % Nb : p;
  const float* __restrict__ x = A + a * d * Tp;
  const float* __restrict__ y = B + b * d * Tp;
  const float gb = gbar[p];
  const size_t stride = (size_t)P * S * S;
  const float* __restrict__ Lp = stash + (size_t)p * S * S;
  float* __restrict__ gxp = gx + (size_t)p * d * Tp;
  float* __restrict__ gyp = gy + (size_t)p * d * Tp;
  const int G = blockDim.x / S, group = threadIdx.x / S;
  const int lane = threadIdx.x % S;
  const unsigned gmask = group_mask<S>();
  float* topE = smem;                      // [Tp] each: by tile column
  float* topL = topE + Tp;
  float* topt = topL + Tp;
  float* colbuf = topt + Tp;               // [2][3][Tp]: parity of tj
  float* corE = colbuf + 6 * Tp;           // [2 Ti] each: by ti - tj
  float* corL = corE + 2 * Ti;
  float* cort = corL + 2 * Ti;
  float* gyacc = cort + 2 * Ti + (size_t)group * d * S;   // [d][S]
  for (int i = threadIdx.x; i < Tp; i += blockDim.x) {
    topE[i] = 0.f;
    topL[i] = kNeg;
    topt[i] = kNeg;
  }
  for (int i = threadIdx.x; i < 2 * Tp; i += blockDim.x) {
    const int h = i / Tp, j = i % Tp;
    colbuf[h * 3 * Tp + j] = 0.f;
    colbuf[h * 3 * Tp + Tp + j] = kNeg;
    colbuf[h * 3 * Tp + 2 * Tp + j] = kNeg;
  }
  for (int i = threadIdx.x; i < 2 * Ti; i += blockDim.x) {
    corE[i] = 0.f;
    corL[i] = kNeg;
    cort[i] = kNeg;
  }
  __syncthreads();

  for (int qd = 0; qd < n_diag; ++qd) {
    for (int e = dptr[qd] + group; e < dptr[qd + 1]; e += G) {
      const int k = order[e];
      const int* m = rmeta + 7 * k;
      const int ti = m[0], tj = m[1], wslot = m[2];
      const bool below_ok = m[3] > 0, right_ok = m[4] > 0;
      const bool diag_ok = m[5] > 0;
      const int fstep = m[6];
      const int cidx = ti - tj + Ti - 1;
      // the right tile (ti, tj + 1) wrote the buffer of parity (tj + 1) & 1
      const float* cin = colbuf + ((tj + 1) & 1) * 3 * Tp + ti * S;
      float* cout = colbuf + (tj & 1) * 3 * Tp + ti * S;
      Halo bel;
      bel.E = below_ok ? topE[tj * S + lane] : 0.f;
      bel.L = below_ok ? topL[tj * S + lane] : kNeg;
      bel.t = below_ok ? topt[tj * S + lane] : kNeg;
      // the below-right tile (ti + 1, tj + 1) left its top-left cell here
      Halo cor = {0.f, kNeg, kNeg};
      if (diag_ok) {
        cor.E = corE[cidx]; cor.L = corL[cidx]; cor.t = cort[cidx];
      }
      const Halo h = reverse_tile<S>(
          x + (size_t)ti * d * S, y + (size_t)tj * d * S, d,
          blocks + (size_t)wslot * S * S, Lp + (size_t)fstep * stride, ninv,
          bel, cor, right_ok, cin, Tp, cout, k == 0, ri, rj, gb, true,
          gxp + (size_t)ti * d * S, gyp + (size_t)tj * d * S, gyacc,
          gw_part + ((size_t)p * K + k) * S * S,
          eout == nullptr ? nullptr
                          : eout + (size_t)k * stride + (size_t)p * S * S,
          lane, gmask);
      __syncwarp(gmask);
      topE[tj * S + lane] = h.E;
      topL[tj * S + lane] = h.L;
      topt[tj * S + lane] = h.t;
      if (lane == 0) {
        corE[cidx] = h.E;
        corL[cidx] = h.L;
        cort[cidx] = h.t;
      }
    }
    __syncthreads();
  }
}

// ------------------------------------------------------------ launchers

template <typename Kern>
int prepare(Kern kern, size_t smem) {
  if (smem > kSmemMax) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

struct FwdArgs {
  const float* A;
  const float* B;
  int Na, Nb, gram, d, Tp;
  const int* meta;
  int n_steps;
  const float* blocks;
  float ninv, gamma;
  int g_out, r;
  float* out;
  float* stash;
  int threads;
  const int* order;
  const int* dptr;
  int n_diag;
  cudaStream_t stream;
};

template <int S, int D, bool STASH>
int pairs_fwd_sd(const FwdArgs& f) {
  const int nt = f.threads;
  const size_t smem = pairs_fwd_floats<S, D>(f.Tp, f.d, nt) * 4;
  int rc = prepare(pairs_fwd_kernel<S, D, STASH>, smem);
  if (rc) return rc;
  const long long P = f.gram ? (long long)f.Na * f.Nb : (long long)f.Na;
  const long long grid = (P + nt - 1) / nt;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  pairs_fwd_kernel<S, D, STASH><<<dim3((unsigned)grid), dim3(nt), smem,
                                  f.stream>>>(
      f.A, f.B, f.Na, f.Nb, f.gram, f.d, f.Tp, f.meta, f.n_steps, f.blocks,
      f.ninv, f.gamma, f.g_out, f.r, f.out, f.stash);
  return (int)cudaGetLastError();
}

// the register channels of the pairs template: d itself where d <= 3 and
// S * d <= 64, else 0 (the y tile in shared memory)
template <int S, bool STASH>
int pairs_fwd_s(const FwdArgs& f) {
  const int D = (f.d <= 3 && S * f.d <= 64) ? f.d : 0;
  switch (D) {
    case 1: return pairs_fwd_sd<S, 1, STASH>(f);
    case 2: return pairs_fwd_sd<S, 2, STASH>(f);
    case 3: return pairs_fwd_sd<S, S * 3 <= 64 ? 3 : 0, STASH>(f);
    default: return pairs_fwd_sd<S, 0, STASH>(f);
  }
}

template <int S, bool STASH>
int tiles_fwd_s(const FwdArgs& f) {
  const size_t smem = tiles_fwd_floats(f.Tp, S) * 4;
  int rc = prepare(tiles_fwd_kernel<S, STASH>, smem);
  if (rc) return rc;
  const long long P = f.gram ? (long long)f.Na * f.Nb : (long long)f.Na;
  if (P > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  tiles_fwd_kernel<S, STASH><<<dim3((unsigned)P), dim3(f.threads), smem,
                               f.stream>>>(
      f.A, f.B, f.Na, f.Nb, f.gram, f.d, f.Tp, f.meta, f.order, f.dptr,
      f.n_diag, f.blocks, f.ninv, f.gamma, f.g_out, f.r, f.out, f.stash);
  return (int)cudaGetLastError();
}

template <bool STASH>
int fwd(const FwdArgs& f, int S, int tmpl) {
  if (f.threads < 1 || f.d < 1 || (tmpl == 0 && f.threads > 1024) ||
      (tmpl == 1 && (f.threads > kTilesThreads || f.threads % S != 0)))
    return (int)cudaErrorInvalidValue;
  switch (S * 2 + tmpl) {
    case 16: return pairs_fwd_s<8, STASH>(f);
    case 17: return tiles_fwd_s<8, STASH>(f);
    case 32: return pairs_fwd_s<16, STASH>(f);
    case 33: return tiles_fwd_s<16, STASH>(f);
    case 64: return pairs_fwd_s<32, STASH>(f);
    case 65: return tiles_fwd_s<32, STASH>(f);
    default: return (int)cudaErrorInvalidValue;
  }
}

struct BwdArgs {
  const float* A;
  const float* B;
  int Na, Nb, gram, d, Tp;
  const int* rmeta;
  int K;
  const float* blocks;
  float ninv;
  const float* stash;
  const float* gbar;
  int ri, rj;
  float* gx;
  float* gy;
  float* gw_part;
  float* eout;
  int threads;
  const int* order;
  const int* dptr;
  int n_diag;
  cudaStream_t stream;
};

template <int S>
int pairs_bwd_s(const BwdArgs& f) {
  const size_t per_pair = 3 * (size_t)f.Tp + 6 * S + S * S + (size_t)f.d * S;
  const size_t smem = (size_t)Geo<S>::PPB * per_pair * 4;
  int rc = prepare(pairs_bwd_kernel<S>, smem);
  if (rc) return rc;
  const long long P = f.gram ? (long long)f.Na * f.Nb : (long long)f.Na;
  const long long grid = (P + Geo<S>::PPB - 1) / Geo<S>::PPB;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  pairs_bwd_kernel<S><<<dim3((unsigned)grid), dim3(kWarps * 32), smem,
                        f.stream>>>(
      f.A, f.B, f.Na, f.Nb, f.gram, f.d, f.Tp, f.rmeta, f.K, f.blocks,
      f.ninv, f.stash, f.gbar, f.ri, f.rj, f.gx, f.gy, f.gw_part, f.eout);
  return (int)cudaGetLastError();
}

template <int S>
int tiles_bwd_s(const BwdArgs& f) {
  const size_t smem = tiles_bwd_floats(f.Tp, S, f.d, f.threads / S) * 4;
  int rc = prepare(tiles_bwd_kernel<S>, smem);
  if (rc) return rc;
  const long long P = f.gram ? (long long)f.Na * f.Nb : (long long)f.Na;
  if (P > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  tiles_bwd_kernel<S><<<dim3((unsigned)P), dim3(f.threads), smem,
                        f.stream>>>(
      f.A, f.B, f.Na, f.Nb, f.gram, f.d, f.Tp, f.rmeta, f.K, f.order,
      f.dptr, f.n_diag, f.blocks, f.ninv, f.stash, f.gbar, f.ri, f.rj,
      f.gx, f.gy, f.gw_part, f.eout);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K7: soft values (P,) over the plan steps 0..n_steps-1, n_steps = g_out+1.
// tmpl 0 (pairs): ``threads`` pairs per block; tmpl 1 (tiles): one pair per
// block of ``threads`` = G * S lanes, ``order`` / ``dptr`` / ``n_diag`` the
// plan steps grouped by tile anti-diagonal.
int soft_tiles_fwd(const float* A, const float* B, int Na, int Nb, int gram,
                   int d, int Tp, const int* meta, int n_steps,
                   const float* blocks, int S, float ninv, float gamma,
                   int g_out, int r, float* out, int tmpl, int threads,
                   const int* order, const int* dptr, int n_diag,
                   void* stream) {
  const FwdArgs f = {A, B, Na, Nb, gram, d, Tp, meta, n_steps, blocks, ninv,
                     gamma, g_out, r, out, nullptr, threads, order, dptr,
                     n_diag, (cudaStream_t)stream};
  return fwd<false>(f, S, tmpl);
}

// K8: K7 and the stash (n_steps, P, S*S) of every walked tile's L block.
int soft_tiles_stash(const float* A, const float* B, int Na, int Nb,
                     int gram, int d, int Tp, const int* meta, int n_steps,
                     const float* blocks, int S, float ninv, float gamma,
                     int g_out, int r, float* out, float* stash, int tmpl,
                     int threads, const int* order, const int* dptr,
                     int n_diag, void* stream) {
  const FwdArgs f = {A, B, Na, Nb, gram, d, Tp, meta, n_steps, blocks, ninv,
                     gamma, g_out, r, out, stash, threads, order, dptr,
                     n_diag, (cudaStream_t)stream};
  return fwd<true>(f, S, tmpl);
}

// K9: per-pair gx, gy (P, d*Tp), accumulated (the caller zeroes them);
// gw_part (n_parts, K, S*S): n_parts = ceil(P / (128 / S)) blocks for tmpl
// 0 (pairs, 128 threads), P for tmpl 1 (tiles, ``threads`` = G * S lanes
// per pair over the reverse steps grouped by tile anti-diagonal); eout
// (K, P, S*S) or null.
int soft_tiles_bwd(const float* A, const float* B, int Na, int Nb, int gram,
                   int d, int Tp, const int* rmeta, int K,
                   const float* blocks, int S, float ninv,
                   const float* stash, const float* gbar, int ri, int rj,
                   float* gx, float* gy, float* gw_part, float* eout,
                   int tmpl, int threads, const int* order, const int* dptr,
                   int n_diag, void* stream) {
  const BwdArgs f = {A, B, Na, Nb, gram, d, Tp, rmeta, K, blocks, ninv,
                     stash, gbar, ri, rj, gx, gy, gw_part, eout, threads,
                     order, dptr, n_diag, (cudaStream_t)stream};
  if (d < 1 || (tmpl == 0 && threads != kWarps * 32) ||
      (tmpl == 1 && (threads < S || threads > kTilesThreads ||
                     threads % S != 0)))
    return (int)cudaErrorInvalidValue;
  switch (S * 2 + tmpl) {
    case 16: return pairs_bwd_s<8>(f);
    case 17: return tiles_bwd_s<8>(f);
    case 32: return pairs_bwd_s<16>(f);
    case 33: return tiles_bwd_s<16>(f);
    case 64: return pairs_bwd_s<32>(f);
    case 65: return tiles_bwd_s<32>(f);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
