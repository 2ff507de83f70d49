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
// the result tile and runs ``soft_block.soft_tile_sweep``: the min-plus DP
// of ``spdtw_tiles.cu`` in the (logaddexp, +) semiring on L = -R/gamma,
// with NEG = -1e30 for "unreachable". K7 and K8 share one __device__ sweep
// (``soft_sweep``), so their values agree bit for bit. The backward walks
// ``BlockSparsePaths.reverse_plan(g_out)`` and runs
// ``soft_block.soft_reverse_tile_sweep``, the E recursion of
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
// training path makes the stash traffic a second bound.
//
// What the design does about it. As in ``spdtw_tiles.cu``, the TPU's
// sequential grid axis is a loop inside the kernel and the parallelism is
// across pairs: a group of S lanes owns one pair (S in {8, 16, 32}; four,
// two or one pairs per warp), lane j owns column j of the tile, the in-row
// recurrences are Hillis-Steele scans of log2(S) shuffle steps, and the
// edges of the DP sit in shared memory per pair: the forward's bottom
// edges (row_edge, Tp floats) and right edge (S floats); the backward's
// E/L/t top-row halos (3 Tp floats), and its left-column halos (3 S floats,
// double-buffered: the tile reads the right tile's column at rows r and
// r+1 while it publishes its own). The plan and the weight blocks are read
// from device memory, as every pair reads the same ones.
//
// Determinism. The TPU kernel summed the cotangents in output blocks that
// its sequential grid revisited; here blocks run in no order. Each pair's
// series cotangents accumulate in its own rows of gx / gy (P, d * Tp) in
// plan order, one writer each; the weight gradient of each reverse step is
// summed over the block's pairs in slot order into one partial per block
// (gw_part (n_blocks, K, S * S)). The wrapper sums the partials, and in
// Gram mode the per-pair rows, in a fixed order, so gradients do not change
// from run to run. No float atomics.
//
// Floating point. The logits, the logaddexp (max + log1pf(expf(-|a-b|)),
// the formula of the plain version), the scans and the edge updates use
// the _rn intrinsics in the plain version's order, and the file is built
// with --fmad=false, so the forward can equal the plain PyTorch version on
// the card bit for bit (its expf / log1pf are these). The backward's sums
// over a row and over a column run in another order than PyTorch's.
//
// C interface (bound with ctypes): every function returns
// cudaGetLastError() after its launch (0 = launched).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1.0e30f;
constexpr float kHalfNeg = -0.5e30f;
constexpr float kInf = 1.0e30f;
constexpr float kSFloor = -1.0e35f;   // floor of the forward scan's sum
constexpr int kWarps = 4;             // warps per thread block

template <int S>
struct Geo {
  static constexpr int PPW = 32 / S;            // pairs per warp
  static constexpr int PPB = kWarps * PPW;      // pairs per block
};

struct Lanes {
  int slot;        // pair slot within the block
  int lane;        // lane within the pair's group (= tile column)
  unsigned mask;   // the group's lanes
};

template <int S>
__device__ __forceinline__ Lanes lanes() {
  const int warp = threadIdx.x >> 5, l32 = threadIdx.x & 31;
  const int gi = l32 / S;
  Lanes o;
  o.slot = warp * Geo<S>::PPW + gi;
  o.lane = l32 % S;
  o.mask = S == 32 ? 0xffffffffu : (((1u << S) - 1u) << (gi * S));
  return o;
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

// One pair's forward over the plan steps 0..n_steps-1 (n_steps = g_out + 1).
// Returns the captured L of the result cell (r, r) at step g_out; with
// STASH, writes each step's L block to stash + k * stride.
template <int S, bool STASH>
__device__ float soft_sweep(const float* __restrict__ x,
                            const float* __restrict__ y, int d, int Tp,
                            const int* __restrict__ meta, int n_steps,
                            const float* __restrict__ blocks, float ninv,
                            int g_out, int r, float* row_edge,
                            float* col_edge, float* __restrict__ stash,
                            size_t stride, int lane, unsigned gmask) {
  for (int j = lane; j < Tp; j += S) row_edge[j] = kNeg;
  col_edge[lane] = kNeg;
  __syncwarp(gmask);
  float corner = kNeg;   // top_vec[S-1] of the previous step
  float res = kNeg;      // the result cell, held by lane r

  for (int k = 0; k < n_steps; ++k) {
    const int* m = meta + 7 * k;
    const int ti = m[0], tj = m[1], slot = m[2];
    const bool top_ok = m[3] > 0, left_ok = m[4] > 0, diag_ok = m[5] > 0;
    const float top = top_ok ? row_edge[tj * S + lane] : kNeg;
    float c_first;
    if (k == 0) c_first = 0.f;
    else if (diag_ok) c_first = left_ok ? corner : row_edge[tj * S - 1];
    else c_first = kNeg;
    const float new_corner = top_ok ? row_edge[tj * S + S - 1] : kNeg;
    const float* __restrict__ w = blocks + (size_t)slot * S * S;
    const float* __restrict__ xt = x + (size_t)ti * d * S;
    const float* __restrict__ yt = y + (size_t)tj * d * S;
    float prev = top, tl0 = c_first;
    for (int t = 0; t < S; ++t) {
      const float lt = left_ok ? col_edge[t] : kNeg;
      const float tr = logit(sq_dist<S>(xt, yt, d, t, lane),
                             w[t * S + lane], ninv);
      // topleft: column j-1 of the previous row; column 0 takes tl0
      const float sh = __shfl_up_sync(gmask, prev, 1, S);
      const float tl = lane == 0 ? tl0 : sh;
      float g = __fadd_rn(tr, lae(prev, tl));
      // the left tile's boundary enters as a virtual L_{-1}
      if (lane == 0) g = lae(g, __fadd_rn(lt, tr));
      // Hillis-Steele scan of L_j = logaddexp(g_j, L_{j-1} + t_j), the
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
      __syncwarp(gmask);   // col_edge[t] has been read by every lane
      if (lane == S - 1) col_edge[t] = mm;
      if (STASH) stash[(size_t)k * stride + t * S + lane] = mm;
      if (k == g_out && t == r && lane == r) res = mm;
      prev = mm;
      tl0 = lt;
    }
    __syncwarp(gmask);
    row_edge[tj * S + lane] = prev;
    corner = new_corner;
    __syncwarp(gmask);
  }
  return __shfl_sync(gmask, res, r, S);
}

// K7 / K8. Gram mode: pair p = (A row p / Nb, B row p % Nb); paired mode:
// (A row p, B row p).
template <int S, bool STASH>
__global__ void __launch_bounds__(kWarps * 32)
fwd_kernel(const float* __restrict__ A, const float* __restrict__ B, int Na,
           int Nb, int gram, int d, int Tp, const int* __restrict__ meta,
           int n_steps, const float* __restrict__ blocks, float ninv,
           float gamma, int g_out, int r, float* __restrict__ out,
           float* __restrict__ stash) {
  extern __shared__ float smem[];
  const Lanes ln = lanes<S>();
  const long long P = gram ? (long long)Na * Nb : (long long)Na;
  const long long p = (long long)blockIdx.x * Geo<S>::PPB + ln.slot;
  if (p >= P) return;
  const long long a = gram ? p / Nb : p, b = gram ? p % Nb : p;
  float* row_edge = smem + (size_t)ln.slot * (Tp + S);
  float* col_edge = row_edge + Tp;
  const size_t stride = (size_t)P * S * S;
  const float L = soft_sweep<S, STASH>(
      A + a * d * Tp, B + b * d * Tp, d, Tp, meta, n_steps, blocks, ninv,
      g_out, r, row_edge, col_edge,
      STASH ? stash + (size_t)p * S * S : nullptr, stride, ln.lane, ln.mask);
  // _from_L: the soft distance, +INF when unreachable
  if (ln.lane == 0) out[p] = L > kHalfNeg ? __fmul_rn(-gamma, L) : kInf;
}

// K9. Every pair of a block walks the same reverse plan, so the block
// synchronises once per tile to sum the weight gradient over its pairs.
// Slots past the last pair run on pair P - 1 with a zero cotangent and
// write nothing of their own.
template <int S>
__global__ void __launch_bounds__(kWarps * 32)
bwd_kernel(const float* __restrict__ A, const float* __restrict__ B, int Na,
           int Nb, int gram, int d, int Tp, const int* __restrict__ rmeta,
           int K, const float* __restrict__ blocks, float ninv,
           const float* __restrict__ stash, const float* __restrict__ gbar,
           int ri, int rj, float* __restrict__ gx, float* __restrict__ gy,
           float* __restrict__ gw_part, float* __restrict__ eout) {
  extern __shared__ float smem[];
  constexpr int PPB = Geo<S>::PPB;
  const Lanes ln = lanes<S>();
  const int lane = ln.lane;
  const unsigned gmask = ln.mask;
  const long long P = gram ? (long long)Na * Nb : (long long)Na;
  const long long p_raw = (long long)blockIdx.x * PPB + ln.slot;
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
  float* topE = smem + (size_t)ln.slot * per_pair;
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
  float corE = 0.f, corL = kNeg, cort = kNeg;
  __syncwarp(gmask);

  for (int k = 0; k < K; ++k) {
    const int* m = rmeta + 7 * k;
    const int ti = m[0], tj = m[1], slot = m[2];
    const bool below_ok = m[3] > 0, right_ok = m[4] > 0, diag_ok = m[5] > 0;
    const int fstep = m[6];
    const float* cin = colbuf + (k & 1) * 3 * S;         // right tile's
    float* cout = colbuf + ((k & 1) ^ 1) * 3 * S;        // this tile's
    const float bE = below_ok ? topE[tj * S + lane] : 0.f;
    const float bL = below_ok ? topL[tj * S + lane] : kNeg;
    const float bt = below_ok ? topt[tj * S + lane] : kNeg;
    // below-right corner: the saved cell when the right tile was just
    // swept, else a direct read of the top halo
    float cE = 0.f, cL = kNeg, ct = kNeg;
    if (diag_ok) {
      if (right_ok) {
        cE = corE; cL = corL; ct = cort;
      } else {
        const int dcol = min((tj + 1) * S, Tp - 1);
        cE = topE[dcol]; cL = topL[dcol]; ct = topt[dcol];
      }
    }
    const float ncE = below_ok ? topE[tj * S] : 0.f;
    const float ncL = below_ok ? topL[tj * S] : kNeg;
    const float nct = below_ok ? topt[tj * S] : kNeg;
    const float* __restrict__ w = blocks + (size_t)slot * S * S;
    const float* __restrict__ xt = x + (size_t)ti * d * S;
    const float* __restrict__ yt = y + (size_t)tj * d * S;
    const float* __restrict__ Lb = Lp + (size_t)fstep * stride;
    for (int c = 0; c < d; ++c) gyacc[c * S + lane] = 0.f;
    float colEw = 0.f;
    float E_next = bE, L_next = bL, t_next = bt;
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
        eE = cE; eL = cL; et = ct;
      } else {
        eE = right_ok ? cin[r + 1] : 0.f;
        eL = right_ok ? cin[S + r + 1] : kNeg;
        et = right_ok ? cin[2 * S + r + 1] : kNeg;
      }
      const float av = coeff(L_row, t_next, L_next);            // (r+1, j)
      float t_ns = __shfl_down_sync(gmask, t_next, 1, S);
      float L_ns = __shfl_down_sync(gmask, L_next, 1, S);
      float E_ns = __shfl_down_sync(gmask, E_next, 1, S);
      if (lane == S - 1) { t_ns = et; L_ns = eL; E_ns = eE; }
      const float cv = coeff(L_row, t_ns, L_ns);                 // (r+1, j+1)
      float f = __fadd_rn(__fmul_rn(av, E_next), __fmul_rn(cv, E_ns));
      f = __fadd_rn(f, (k == 0 && r == ri && lane == rj) ? 1.f : 0.f);
      // within-row successor (r, j+1); column S lives in the right tile
      const float rrE = right_ok ? cin[r] : 0.f;
      const float rrL = right_ok ? cin[S + r] : kNeg;
      const float rrt = right_ok ? cin[2 * S + r] : kNeg;
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
      if (eout != nullptr && valid)
        eout[(size_t)k * stride + (size_t)p * S * S + r * S + lane] = E;
      if (lane == 0) {
        cout[r] = E;
        cout[S + r] = L_row;
        cout[2 * S + r] = t_row;
      }
      // cotangents: gw(r, j) = E phi gbar; gx(r) from the row sums of
      // E w and E w y; gy(j) from the column sums of E w and E w x
      gwt[r * S + lane] = valid ? __fmul_rn(__fmul_rn(E, phi), gb) : 0.f;
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
          float* dst = gxp + (size_t)(ti * d + c) * S + r;
          *dst = __fadd_rn(*dst, g);
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
        float* dst = gyp + (size_t)(tj * d + c) * S + lane;
        *dst = __fadd_rn(*dst, g);
      }
    }
    // publish the halos for the upstream (reverse-order) tiles: the top
    // row (E, L, t of row 0) and the saved below-right corner
    __syncwarp(gmask);
    topE[tj * S + lane] = E_next;
    topL[tj * S + lane] = L_next;
    topt[tj * S + lane] = t_next;
    corE = ncE; corL = ncL; cort = nct;
    // the weight gradient of this step, summed over the block's pairs in
    // slot order
    __syncthreads();
    for (int cell = threadIdx.x; cell < S * S; cell += blockDim.x) {
      float s = 0.f;
      for (int q = 0; q < PPB; ++q) s = __fadd_rn(s, gw_all[q * per_pair +
                                                          3 * Tp + 6 * S +
                                                          cell]);
      gw_part[((size_t)blockIdx.x * K + k) * S * S + cell] = s;
    }
    __syncthreads();
  }
}

template <typename Kern>
int prepare(Kern kern, size_t smem) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

template <int S, bool STASH>
int fwd_s(const float* A, const float* B, int Na, int Nb, int gram, int d,
          int Tp, const int* meta, int n_steps, const float* blocks,
          float ninv, float gamma, int g_out, int r, float* out,
          float* stash, cudaStream_t stream) {
  const size_t smem = (size_t)Geo<S>::PPB * (Tp + S) * 4;
  int rc = prepare(fwd_kernel<S, STASH>, smem);
  if (rc) return rc;
  const long long P = gram ? (long long)Na * Nb : (long long)Na;
  const long long grid = (P + Geo<S>::PPB - 1) / Geo<S>::PPB;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  fwd_kernel<S, STASH><<<dim3((unsigned)grid), dim3(kWarps * 32), smem,
                         stream>>>(A, B, Na, Nb, gram, d, Tp, meta, n_steps,
                                   blocks, ninv, gamma, g_out, r, out,
                                   stash);
  return (int)cudaGetLastError();
}

template <bool STASH>
int fwd(const float* A, const float* B, int Na, int Nb, int gram, int d,
        int Tp, const int* meta, int n_steps, const float* blocks, int S,
        float ninv, float gamma, int g_out, int r, float* out, float* stash,
        void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (S) {
    case 8: return fwd_s<8, STASH>(A, B, Na, Nb, gram, d, Tp, meta, n_steps,
                                   blocks, ninv, gamma, g_out, r, out, stash,
                                   st);
    case 16: return fwd_s<16, STASH>(A, B, Na, Nb, gram, d, Tp, meta,
                                     n_steps, blocks, ninv, gamma, g_out, r,
                                     out, stash, st);
    case 32: return fwd_s<32, STASH>(A, B, Na, Nb, gram, d, Tp, meta,
                                     n_steps, blocks, ninv, gamma, g_out, r,
                                     out, stash, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <int S>
int bwd_s(const float* A, const float* B, int Na, int Nb, int gram, int d,
          int Tp, const int* rmeta, int K, const float* blocks, float ninv,
          const float* stash, const float* gbar, int ri, int rj, float* gx,
          float* gy, float* gw_part, float* eout, cudaStream_t stream) {
  const size_t per_pair = 3 * (size_t)Tp + 6 * S + S * S + (size_t)d * S;
  const size_t smem = (size_t)Geo<S>::PPB * per_pair * 4;
  int rc = prepare(bwd_kernel<S>, smem);
  if (rc) return rc;
  const long long P = gram ? (long long)Na * Nb : (long long)Na;
  const long long grid = (P + Geo<S>::PPB - 1) / Geo<S>::PPB;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  bwd_kernel<S><<<dim3((unsigned)grid), dim3(kWarps * 32), smem, stream>>>(
      A, B, Na, Nb, gram, d, Tp, rmeta, K, blocks, ninv, stash, gbar, ri, rj,
      gx, gy, gw_part, eout);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K7: soft values (P,) over the plan steps 0..n_steps-1, n_steps = g_out+1.
int soft_tiles_fwd(const float* A, const float* B, int Na, int Nb, int gram,
                   int d, int Tp, const int* meta, int n_steps,
                   const float* blocks, int S, float ninv, float gamma,
                   int g_out, int r, float* out, void* stream) {
  return fwd<false>(A, B, Na, Nb, gram, d, Tp, meta, n_steps, blocks, S,
                    ninv, gamma, g_out, r, out, nullptr, stream);
}

// K8: K7 and the stash (n_steps, P, S*S) of every walked tile's L block.
int soft_tiles_stash(const float* A, const float* B, int Na, int Nb,
                     int gram, int d, int Tp, const int* meta, int n_steps,
                     const float* blocks, int S, float ninv, float gamma,
                     int g_out, int r, float* out, float* stash,
                     void* stream) {
  return fwd<true>(A, B, Na, Nb, gram, d, Tp, meta, n_steps, blocks, S,
                   ninv, gamma, g_out, r, out, stash, stream);
}

// K9: per-pair gx, gy (P, d*Tp), accumulated (the caller zeroes them);
// gw_part (n_blocks, K, S*S); eout (K, P, S*S) or null.
int soft_tiles_bwd(const float* A, const float* B, int Na, int Nb, int gram,
                   int d, int Tp, const int* rmeta, int K,
                   const float* blocks, int S, float ninv,
                   const float* stash, const float* gbar, int ri, int rj,
                   float* gx, float* gy, float* gw_part, float* eout,
                   void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (S) {
    case 8: return bwd_s<8>(A, B, Na, Nb, gram, d, Tp, rmeta, K, blocks,
                            ninv, stash, gbar, ri, rj, gx, gy, gw_part, eout,
                            st);
    case 16: return bwd_s<16>(A, B, Na, Nb, gram, d, Tp, rmeta, K, blocks,
                              ninv, stash, gbar, ri, rj, gx, gy, gw_part,
                              eout, st);
    case 32: return bwd_s<32>(A, B, Na, Nb, gram, d, Tp, rmeta, K, blocks,
                              ninv, stash, gbar, ri, rj, gx, gy, gw_part,
                              eout, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
