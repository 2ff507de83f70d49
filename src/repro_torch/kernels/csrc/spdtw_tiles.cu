// Block-sparse SP-DTW tile engines for Hopper (sm_90a): the all-pairs Gram
// (``spdtw_tiles_gram``), the aligned-pair batch (``spdtw_tiles_paired``) and
// the pair list of K1's list mode (``spdtw_pair_list``).
//
// What they replace.
//   gram   <- src/repro/kernels/gram_block.py  _gram_spdtw_kernel
//             (entry gram_spdtw_block), the TPU kernel K1.
//   paired <- src/repro/kernels/spdtw_block.py _spdtw_block_kernel
//             (entry spdtw_block), the TPU kernel K2.
// Both walk the row-major active-tile plan of ``occupancy._tile_plan`` and
// run the per-tile DP of ``spdtw_block.tile_sweep``; they share one
// __device__ sweep per route (``sweep_thread``, ``sweep_pair``) so that K1
// and K2 give identical values for the same pair, and both repeat the
// plain PyTorch versions (``gram_block.gram_spdtw_scan`` /
// ``spdtw_paired_scan``) operation by operation, so the results are
// bit-identical to them.
//
// What bounds them on this card. Each DP row is a serial min-plus chain:
// the in-row dependency D(i, j-1) is resolved by a Hillis-Steele scan of
// log2(S) levels (about 4 log2 S operations per cell), and the tiles of one
// pair run one after the other. The work is FP32 ALU work outside the
// tensor cores (sub, mul, add, min), and the inputs are small (a few MB of
// series, the plan and the weight blocks), so device-memory traffic is
// negligible: the kernels are bound by FP32 instruction throughput.
//
// What the design does about it. The TPU kernel walked (A-block, B-block)
// pair tiles through a sequential grid axis and carried edges in VMEM
// scratch. Here the sequential grid axis is a loop inside the kernel, and
// the parallelism is across pairs instead.
//   S in {8, 16, 32} (``thread_kernel``, every T <= 256 under
//   default_tile): one thread owns one pair and holds the tile row in
//   registers, so the scan's levels are independent register operations
//   with compile-time indices; no shuffles, no lane selects. The step's
//   weight block is staged once per block in shared memory and read as a
//   broadcast, and the edges sit in shared memory as [column][pair]
//   (``sweep_thread`` below).
//   S in {64, 128}, or edges too long for the thread route's shared memory
//   (``gram_kernel`` / ``paired_kernel``): a group of min(S, 32) lanes owns
//   one pair (a lane holds S/32 cells), the scan runs on shuffles or
//   through per-pair shared memory, and the bottom edges of the previous
//   tile row (``row_edge``, Tp floats) and the right edge of the left tile
//   (``col_edge``, S floats) live in shared memory per pair.
// ``spdtw_block.tile_geometry`` picks the route. In both, the plan
// (``meta``, n_steps x 7 int32) and the weight blocks are read from device
// memory through L1/L2, in place of the TPU's scalar prefetch, and pruning
// is per pair: a pair whose incoming edges all exceed its threshold skips
// the tile and publishes +INF edges, which is exactly what its pruned sweep
// would have produced.
//
// The cascade's launches (list mode). The 1-NN cascade runs K1 twice a
// job, the prefix pass and the thresholded exact pass, each on a subset
// of the Na x Nb grid (43.6 % and 33.7 % of TwoPatterns' pairs). Over the
// full grid a settled pair stays in the step loop as a dead lane, and a
// warp with a few live pairs takes as long as a full one. So K1 also
// takes a dense list of flat pair ids (``pairs``, ascending, query-major)
// and its length ``count`` in device memory: thread (or lane group) p
// takes pairs[p], and dead lanes no longer hold warps there. The grid is
// sized for Na * Nb; a block past the list's end returns at entry, so
// the host never reads the count. The mode is a template flag (``L``) of
// the same kernels, so the full grid's launches keep their code. Without
// a list (the plain Gram, the DTW Gram, ``engine.gram``), K1 walks the
// full grid as before. A pair's sweep is the same either way, so its
// value is too. ``pair_list_kernel`` builds the list from a bool mask and
// its prefix sum; it replaces no TPU kernel (the TPU's grid had no list)
// and is bound by memory, a few bytes a pair.
//
// Floating point. The cost row and u = c + min(top, topleft) use the
// _rn intrinsics, and the file is built with --fmad=false, so no multiply
// and add are contracted into an FMA: the multivariate channel sum and the
// weight multiply round exactly as the plain version's do.
//
// C interface (bound with ctypes): every function returns
// cudaGetLastError() after its launch (0 = launched).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kInf = 1.0e30f;
constexpr int kWarps = 4;               // warps per thread block

template <int S>
struct Geo {
  static constexpr int G = S < 32 ? S : 32;   // lanes per pair
  static constexpr int C = S / G;             // cells per lane
  static constexpr int PPW = 32 / G;          // pairs per warp
  static constexpr int PPB = kWarps * PPW;    // pairs per block
  // per-pair shared floats beyond row_edge: col_edge, and two scan
  // buffers when a lane holds several cells
  static constexpr int EXTRA = S + (C > 1 ? 2 * S : 0);
};

__device__ __forceinline__ float group_min(float v, unsigned mask, int G) {
  for (int off = G / 2; off > 0; off >>= 1)
    v = fminf(v, __shfl_xor_sync(mask, v, off, G));
  return v;
}

// One pair's sweep over the plan. Returns the pair's value: the result
// cell (r, r) of plan step g_out (+INF when the pair was abandoned), or,
// in prefix mode, min(row_edge) after the n_steps given.
template <int S>
__device__ float sweep_pair(const float* __restrict__ x,
                            const float* __restrict__ y, int d, int Tp,
                            const int* __restrict__ meta, int n_steps,
                            const float* __restrict__ blocks, float thr,
                            bool alive, bool prune, int g_out, int r,
                            bool prefix, float* row_edge, float* col_edge,
                            float* scan_m, float* scan_s, int lane,
                            unsigned gmask) {
  constexpr int G = Geo<S>::G;
  constexpr int C = Geo<S>::C;
  for (int j = lane; j < Tp; j += G) row_edge[j] = kInf;
  for (int j = lane; j < S; j += G) col_edge[j] = kInf;
  __syncwarp(gmask);
  float corner = kInf;   // top_vec[S-1] of the previous step
  float res = kInf;      // the result cell, held by the lane of column r

  for (int k = 0; k < n_steps; ++k) {
    const int* m = meta + 7 * k;
    const int ti = m[0], tj = m[1], slot = m[2];
    const bool top_ok = m[3] > 0, left_ok = m[4] > 0, diag_ok = m[5] > 0;
    // early abandon at the first tile of a new tile row: the previous
    // tile row is complete, so min(row_edge) lower-bounds the result
    if (m[6] > 0 && k > 0 && k <= g_out) {
      float b = kInf;
      for (int j = lane; j < Tp; j += G) b = fminf(b, row_edge[j]);
      b = group_min(b, gmask, G);
      alive = alive && (b <= thr);
    }
    // an abandoned pair reports +INF whatever its edges hold: stop here
    if (!alive) break;
    float top[C];
#pragma unroll
    for (int c = 0; c < C; ++c)
      top[c] = top_ok ? row_edge[tj * S + c * G + lane] : kInf;
    float c_first;
    if (k == 0) c_first = 0.f;
    else if (diag_ok) c_first = left_ok ? corner : row_edge[tj * S - 1];
    else c_first = kInf;
    const float new_corner = top_ok ? row_edge[tj * S + S - 1] : kInf;

    bool run = alive;
    if (prune) {
      float mt = kInf, ml = kInf;
#pragma unroll
      for (int c = 0; c < C; ++c) mt = fminf(mt, top[c]);
      if (left_ok)
        for (int j = lane; j < S; j += G) ml = fminf(ml, col_edge[j]);
      mt = group_min(mt, gmask, G);
      ml = group_min(ml, gmask, G);
      run = alive && (mt <= thr || ml <= thr || c_first <= thr);
    }
    __syncwarp(gmask);
    if (!run) {
      // what the pruned sweep would publish: all-+INF edges
#pragma unroll
      for (int c = 0; c < C; ++c) row_edge[tj * S + c * G + lane] = kInf;
      for (int j = lane; j < S; j += G) col_edge[j] = kInf;
      if (k == g_out) res = kInf;
      corner = new_corner;
      __syncwarp(gmask);
      continue;
    }

    const float* __restrict__ w = blocks + (size_t)slot * S * S;
    const float* __restrict__ xt = x + (size_t)ti * d * S;
    const float* __restrict__ yt = y + (size_t)tj * d * S;
    float dprev[C];
#pragma unroll
    for (int c = 0; c < C; ++c) dprev[c] = top[c];
    float tl0 = c_first;
    for (int t = 0; t < S; ++t) {
      const float lt = left_ok ? col_edge[t] : kInf;
      float cst[C], u[C];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int j = c * G + lane;
        float acc = 0.f;
        for (int kk = 0; kk < d; ++kk) {
          const float df = __fsub_rn(xt[kk * S + t], yt[kk * S + j]);
          const float dk = __fmul_rn(df, df);
          acc = kk == 0 ? dk : __fadd_rn(acc, dk);
        }
        const float wv = w[t * S + j];
        cst[c] = wv > 0.f ? __fmul_rn(acc, wv) : kInf;
      }
      // topleft: column j-1 of the previous row; column 0 takes tl0
      float tlv[C];
      if constexpr (C == 1) {
        const float sh = __shfl_up_sync(gmask, dprev[0], 1, G);
        tlv[0] = lane == 0 ? tl0 : sh;
      } else {
#pragma unroll
        for (int c = 0; c < C; ++c) scan_m[c * G + lane] = dprev[c];
        __syncwarp(gmask);
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const int j = c * G + lane;
          tlv[c] = j == 0 ? tl0 : scan_m[j - 1];
        }
        __syncwarp(gmask);
      }
#pragma unroll
      for (int c = 0; c < C; ++c)
        u[c] = __fadd_rn(cst[c], fminf(dprev[c], tlv[c]));
      // the left tile's boundary enters as a virtual D_{-1}
      if (lane == 0) u[0] = fminf(u[0], __fadd_rn(lt, cst[0]));

      // Hillis-Steele min-plus scan, the association of
      // spdtw_block._minplus_scan_lanes: m = min(m, m_sh + s) with the
      // old s, then s = min(s_sh + s, INF)
      float mm[C], ss[C];
#pragma unroll
      for (int c = 0; c < C; ++c) { mm[c] = u[c]; ss[c] = cst[c]; }
      if constexpr (C == 1) {
#pragma unroll
        for (int dd = 1; dd < S; dd <<= 1) {
          float m_sh = __shfl_up_sync(gmask, mm[0], dd, G);
          float s_sh = __shfl_up_sync(gmask, ss[0], dd, G);
          if (lane < dd) { m_sh = kInf; s_sh = 0.f; }
          const float nm = fminf(mm[0], __fadd_rn(m_sh, ss[0]));
          ss[0] = fminf(__fadd_rn(s_sh, ss[0]), kInf);
          mm[0] = nm;
        }
      } else {
#pragma unroll
        for (int dd = 1; dd < S; dd <<= 1) {
#pragma unroll
          for (int c = 0; c < C; ++c) {
            scan_m[c * G + lane] = mm[c];
            scan_s[c * G + lane] = ss[c];
          }
          __syncwarp(gmask);
          float nm[C], ns[C];
#pragma unroll
          for (int c = 0; c < C; ++c) {
            const int j = c * G + lane;
            const float m_sh = j >= dd ? scan_m[j - dd] : kInf;
            const float s_sh = j >= dd ? scan_s[j - dd] : 0.f;
            nm[c] = fminf(mm[c], __fadd_rn(m_sh, ss[c]));
            ns[c] = fminf(__fadd_rn(s_sh, ss[c]), kInf);
          }
          __syncwarp(gmask);
#pragma unroll
          for (int c = 0; c < C; ++c) { mm[c] = nm[c]; ss[c] = ns[c]; }
        }
      }
      __syncwarp(gmask);   // col_edge[t] has been read by lane 0
#pragma unroll
      for (int c = 0; c < C; ++c) {
        float out = fminf(mm[c], kInf);
        if (prune) out = out <= thr ? out : kInf;
        const int j = c * G + lane;
        if (j == S - 1) col_edge[t] = out;
        if (k == g_out && t == r && j == r) res = out;
        dprev[c] = out;
      }
      tl0 = lt;
    }
    __syncwarp(gmask);
#pragma unroll
    for (int c = 0; c < C; ++c) row_edge[tj * S + c * G + lane] = dprev[c];
    corner = new_corner;
    __syncwarp(gmask);
  }

  if (prefix) {
    float b = kInf;
    for (int j = lane; j < Tp; j += G) b = fminf(b, row_edge[j]);
    return group_min(b, gmask, G);
  }
  res = group_min(res, gmask, G);
  return alive ? res : kInf;
}

// ------------------------------------------------- one thread per pair ----
//
// For S in {8, 16, 32}: one thread owns one pair and holds the tile row in
// registers, so the in-row scan runs with compile-time indices (no shuffles,
// no lane selects) in the association of _minplus_scan_lanes, the
// min(m, INF + s) terms for j < dd included. The block's threads walk the
// same plan, so each step's S x S weight block is staged once into shared
// memory and read as a broadcast; the bottom edges (Tp floats per pair) and
// the right column (S floats) sit in shared memory as [column][pair], so
// neighbouring threads hit neighbouring banks. D > 0: the pair's y tile (D
// channels) in registers; D = 0: d channels, the y tile in shared memory
// as [channel * S + column][pair]. Abandoned and pruned pairs, and the
// block's tail past the last pair, stay in the step loop as dead threads,
// so that every thread meets the block's barriers.
template <int S, int D>
__device__ float sweep_thread(const float* __restrict__ x,
                              const float* __restrict__ y, int d, int Tp,
                              const int* __restrict__ meta, int n_steps,
                              const float* __restrict__ blocks, float thr,
                              bool alive, bool prune, int g_out, int r,
                              bool prefix, float* row_edge, float* col,
                              float* ysh, float* ws, int slot, int nt) {
  for (int j = 0; j < Tp; ++j) row_edge[j * nt + slot] = kInf;
#pragma unroll
  for (int t = 0; t < S; ++t) col[t * nt + slot] = kInf;
  float corner = kInf;   // top_vec[S-1] of the previous step
  float res = kInf;      // the result cell
  constexpr int DR = D > 0 ? D : 1;
  float yv[DR][S];

  for (int k = 0; k < n_steps; ++k) {
    const int* m = meta + 7 * k;
    const int ti = __ldg(m), tj = __ldg(m + 1), wslot = __ldg(m + 2);
    const bool top_ok = __ldg(m + 3) > 0, left_ok = __ldg(m + 4) > 0,
               diag_ok = __ldg(m + 5) > 0, row_first = __ldg(m + 6) > 0;
    __syncthreads();   // the previous step's weights have been read
    for (int e = threadIdx.x; e < S * S; e += blockDim.x)
      ws[e] = __ldg(blocks + (size_t)wslot * S * S + e);
    __syncthreads();
    // early abandon at the first tile of a new tile row
    if (alive && row_first && k > 0 && k <= g_out) {
      float b = kInf;
      for (int j = 0; j < Tp; ++j) b = fminf(b, row_edge[j * nt + slot]);
      alive = b <= thr;
    }
    if (!alive) continue;
    float dprev[S];
#pragma unroll
    for (int j = 0; j < S; ++j)
      dprev[j] = top_ok ? row_edge[(tj * S + j) * nt + slot] : kInf;
    float c_first;
    if (k == 0) c_first = 0.f;
    else if (diag_ok)
      c_first = left_ok ? corner : row_edge[(tj * S - 1) * nt + slot];
    else c_first = kInf;
    const float new_corner = dprev[S - 1];

    if (prune) {
      float mt = kInf, ml = kInf;
#pragma unroll
      for (int j = 0; j < S; ++j) mt = fminf(mt, dprev[j]);
      if (left_ok) {
#pragma unroll
        for (int t = 0; t < S; ++t) ml = fminf(ml, col[t * nt + slot]);
      }
      if (!(mt <= thr || ml <= thr || c_first <= thr)) {
        // what the pruned sweep would publish: all-+INF edges
#pragma unroll
        for (int j = 0; j < S; ++j) row_edge[(tj * S + j) * nt + slot] = kInf;
#pragma unroll
        for (int t = 0; t < S; ++t) col[t * nt + slot] = kInf;
        if (k == g_out) res = kInf;
        corner = new_corner;
        continue;
      }
    }

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
      for (int e = 0; e < d * S; ++e) ysh[e * nt + slot] = __ldg(yt + e);
    }
    float tl0 = c_first;
#pragma unroll 1
    for (int t = 0; t < S; ++t) {
      const float lt = left_ok ? col[t * nt + slot] : kInf;
      float mm[S], ss[S];
#pragma unroll
      for (int j = 0; j < S; ++j) {
        float acc;
        if constexpr (D > 0) {
          acc = 0.f;
#pragma unroll
          for (int kk = 0; kk < D; ++kk) {
            const float df = __fsub_rn(__ldg(xt + kk * S + t), yv[kk][j]);
            const float dk = __fmul_rn(df, df);
            acc = kk == 0 ? dk : __fadd_rn(acc, dk);
          }
        } else {
          acc = 0.f;
          for (int kk = 0; kk < d; ++kk) {
            const float df = __fsub_rn(__ldg(xt + kk * S + t),
                                       ysh[(kk * S + j) * nt + slot]);
            const float dk = __fmul_rn(df, df);
            acc = kk == 0 ? dk : __fadd_rn(acc, dk);
          }
        }
        const float wv = ws[t * S + j];
        ss[j] = wv > 0.f ? __fmul_rn(acc, wv) : kInf;
        // topleft: column j-1 of the previous row; column 0 takes tl0
        const float tlv = j ? dprev[j - 1] : tl0;
        mm[j] = __fadd_rn(ss[j], fminf(dprev[j], tlv));
      }
      // the left tile's boundary enters as a virtual D_{-1}
      mm[0] = fminf(mm[0], __fadd_rn(lt, ss[0]));
      // Hillis-Steele min-plus scan, the association of
      // spdtw_block._minplus_scan_lanes: m = min(m, m_sh + s) with the old
      // s, then s = min(s_sh + s, INF); j runs down so that every level
      // reads the previous level's values
#pragma unroll
      for (int dd = 1; dd < S; dd <<= 1) {
#pragma unroll
        for (int j = S - 1; j >= 0; --j) {
          const float m_sh = j >= dd ? mm[j - dd] : kInf;
          const float s_sh = j >= dd ? ss[j - dd] : 0.f;
          mm[j] = fminf(mm[j], __fadd_rn(m_sh, ss[j]));
          ss[j] = fminf(__fadd_rn(s_sh, ss[j]), kInf);
        }
      }
#pragma unroll
      for (int j = 0; j < S; ++j) {
        float out = fminf(mm[j], kInf);
        if (prune) out = out <= thr ? out : kInf;
        dprev[j] = out;
        if (k == g_out && t == r && j == r) res = out;
      }
      col[t * nt + slot] = dprev[S - 1];
      tl0 = lt;
    }
#pragma unroll
    for (int j = 0; j < S; ++j) row_edge[(tj * S + j) * nt + slot] = dprev[j];
    corner = new_corner;
  }

  if (prefix) {
    float b = kInf;
    for (int j = 0; j < Tp; ++j) b = fminf(b, row_edge[j * nt + slot]);
    return b;
  }
  return alive ? res : kInf;
}

// shared floats of one block of nt threads: row edges, right columns, the
// weight block, and the y tiles when they do not sit in registers
template <int S, int D>
__host__ __device__ constexpr size_t thread_smem_floats(int Tp, int d,
                                                        int nt) {
  return (size_t)nt * (Tp + S) + S * S + (D == 0 ? (size_t)nt * d * S : 0);
}

// K1 (gram) / K2 (!gram), one thread per pair. L (K1's list mode):
// thread p takes the flat pair id pairs[p] for p < *count; the grid is
// sized for Na * Nb, and a block whose first slot is at or past *count
// leaves at entry, before any barrier. L is a template flag, not a
// runtime test: a runtime test made the full grid's launches 6.5 % slower
// (H100, 4000 x 1000 pairs, S = 16), the list's no faster.
template <int S, int D, bool L>
__global__ void thread_kernel(const float* __restrict__ A,
                              const float* __restrict__ B, int Na, int Nb,
                              int gram, int d, int Tp,
                              const int* __restrict__ meta, int n_steps,
                              const float* __restrict__ blocks,
                              const float* __restrict__ thr,
                              const int* __restrict__ pairs,
                              const int* __restrict__ count, int prune,
                              int g_out, int r, int prefix,
                              float* __restrict__ out) {
  extern __shared__ float smem[];
  const int nt = blockDim.x, slot = threadIdx.x;
  long long P;
  if constexpr (L) {
    P = (long long)__ldg(count);
    if ((long long)blockIdx.x * nt >= P) return;
  } else {
    P = gram ? (long long)Na * Nb : (long long)Na;
  }
  const long long p = (long long)blockIdx.x * nt + slot;
  const bool real = p < P;
  long long q;
  if constexpr (L) q = real ? (long long)__ldg(pairs + p) : 0;
  else q = real ? p : P - 1;
  const long long a = gram ? q / Nb : q;
  const long long b = gram ? q % Nb : q;
  float* row_edge = smem;
  float* col = row_edge + (size_t)nt * Tp;
  float* ws = col + (size_t)nt * S;
  float* ysh = ws + S * S;
  const float v = sweep_thread<S, D>(
      A + a * d * Tp, B + b * d * Tp, d, Tp, meta, n_steps, blocks,
      thr ? thr[a] : kInf, real, prune != 0, g_out, r, prefix != 0,
      row_edge, col, ysh, ws, slot, nt);
  if (real) out[q] = v;
}

template <int S, int D>
int thread_sd(const float* A, const float* B, int Na, int Nb, int gram,
              int d, int Tp, const int* meta, int n_steps,
              const float* blocks, const float* thr, const int* pairs,
              const int* count, int prune, int g_out, int r, int prefix,
              int nt, float* out, cudaStream_t stream) {
  const size_t smem = thread_smem_floats<S, D>(Tp, d, nt) * 4;
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        thread_kernel<S, D, true>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    e = cudaFuncSetAttribute(
        thread_kernel<S, D, false>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const long long P = gram ? (long long)Na * Nb : (long long)Na;
  const long long grid = (P + nt - 1) / nt;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const dim3 g((unsigned)grid), t(nt);
  if (pairs)
    thread_kernel<S, D, true><<<g, t, smem, stream>>>(
        A, B, Na, Nb, gram, d, Tp, meta, n_steps, blocks, thr, pairs, count,
        prune, g_out, r, prefix, out);
  else
    thread_kernel<S, D, false><<<g, t, smem, stream>>>(
        A, B, Na, Nb, gram, d, Tp, meta, n_steps, blocks, thr, pairs, count,
        prune, g_out, r, prefix, out);
  return (int)cudaGetLastError();
}

// the register channels of the thread path: d itself where S * d <= 64,
// else 0 (the y tile in shared memory)
template <int S>
int thread_s(const float* A, const float* B, int Na, int Nb, int gram,
             int d, int Tp, const int* meta, int n_steps, const float* blocks,
             const float* thr, const int* pairs, const int* count, int prune,
             int g_out, int r, int prefix, int nt, float* out,
             cudaStream_t stream) {
  const int D = (d <= 3 && S * d <= 64) ? d : 0;
#define THREAD(DD) thread_sd<S, DD>(A, B, Na, Nb, gram, d, Tp, meta, \
                                    n_steps, blocks, thr, pairs, count, \
                                    prune, g_out, r, prefix, nt, out, stream)
  switch (D) {
    case 1: return THREAD(1);
    case 2: return THREAD(2);
    case 3: return THREAD(S * 3 <= 64 ? 3 : 0);
    default: return THREAD(0);
  }
#undef THREAD
}

int thread_route(const float* A, const float* B, int Na, int Nb, int gram,
                 int d, int Tp, const int* meta, int n_steps,
                 const float* blocks, int S, const float* thr,
                 const int* pairs, const int* count, int prune, int g_out,
                 int r, int prefix, int nt, float* out, cudaStream_t st) {
  if (nt < 1 || nt > 1024 || d < 1) return (int)cudaErrorInvalidValue;
  switch (S) {
    case 8: return thread_s<8>(A, B, Na, Nb, gram, d, Tp, meta, n_steps,
                               blocks, thr, pairs, count, prune, g_out, r,
                               prefix, nt, out, st);
    case 16: return thread_s<16>(A, B, Na, Nb, gram, d, Tp, meta, n_steps,
                                 blocks, thr, pairs, count, prune, g_out, r,
                                 prefix, nt, out, st);
    case 32: return thread_s<32>(A, B, Na, Nb, gram, d, Tp, meta, n_steps,
                                 blocks, thr, pairs, count, prune, g_out, r,
                                 prefix, nt, out, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// ------------------------- lane groups: S > 32, or edges too long ----

struct Lanes {
  int slot;        // pair slot within the block
  int lane;        // lane within the pair's group
  unsigned mask;   // the group's lanes
};

template <int S>
__device__ __forceinline__ Lanes lanes() {
  constexpr int G = Geo<S>::G;
  const int warp = threadIdx.x >> 5, l32 = threadIdx.x & 31;
  const int gi = l32 / G;
  Lanes o;
  o.slot = warp * Geo<S>::PPW + gi;
  o.lane = l32 % G;
  o.mask = G == 32 ? 0xffffffffu : (((1u << G) - 1u) << (gi * G));
  return o;
}

// K1: pair id q is (A row q / Nb, B row q % Nb); group p takes q = p, or,
// in list mode (L), q = pairs[p] for p < *count.
template <int S, bool L>
__global__ void __launch_bounds__(kWarps * 32)
gram_kernel(const float* __restrict__ A, const float* __restrict__ B,
            int Na, int Nb, int d, int Tp, const int* __restrict__ meta,
            int n_steps, const float* __restrict__ blocks,
            const float* __restrict__ thr, const int* __restrict__ pairs,
            const int* __restrict__ count, int prune, int g_out, int r,
            int prefix, float* __restrict__ out) {
  extern __shared__ float smem[];
  const Lanes ln = lanes<S>();
  const long long p = (long long)blockIdx.x * Geo<S>::PPB + ln.slot;
  long long q = p;
  if constexpr (L) {
    if (p >= (long long)__ldg(count)) return;
    q = __ldg(pairs + p);
  } else {
    if (p >= (long long)Na * Nb) return;
  }
  const long long a = q / Nb, b = q % Nb;
  float* row_edge = smem + (size_t)ln.slot * (Tp + Geo<S>::EXTRA);
  float* col_edge = row_edge + Tp;
  const float v = sweep_pair<S>(
      A + a * d * Tp, B + b * d * Tp, d, Tp, meta, n_steps, blocks,
      thr ? thr[a] : kInf, true, prune != 0, g_out, r, prefix != 0,
      row_edge, col_edge, col_edge + S, col_edge + 2 * S, ln.lane, ln.mask);
  if (ln.lane == 0) out[q] = v;
}

// K2: pair p is (X row p, Y row p).
template <int S>
__global__ void __launch_bounds__(kWarps * 32)
paired_kernel(const float* __restrict__ X, const float* __restrict__ Y,
              int P, int d, int Tp, const int* __restrict__ meta,
              int n_steps, const float* __restrict__ blocks,
              const float* __restrict__ thr, int prune, int g_out, int r,
              float* __restrict__ out) {
  extern __shared__ float smem[];
  const Lanes ln = lanes<S>();
  const long long p = (long long)blockIdx.x * Geo<S>::PPB + ln.slot;
  if (p >= P) return;
  float* row_edge = smem + (size_t)ln.slot * (Tp + Geo<S>::EXTRA);
  float* col_edge = row_edge + Tp;
  const float v = sweep_pair<S>(
      X + p * d * Tp, Y + p * d * Tp, d, Tp, meta, n_steps, blocks,
      thr ? thr[p] : kInf, true, prune != 0, g_out, r, false, row_edge,
      col_edge, col_edge + S, col_edge + 2 * S, ln.lane, ln.mask);
  if (ln.lane == 0) out[p] = v;
}

template <int S>
int gram_s(const float* A, const float* B, int Na, int Nb, int d, int Tp,
           const int* meta, int n_steps, const float* blocks,
           const float* thr, const int* pairs, const int* count, int prune,
           int g_out, int r, int prefix, float* out, cudaStream_t stream) {
  const size_t smem = (size_t)Geo<S>::PPB * (Tp + Geo<S>::EXTRA) * 4;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        gram_kernel<S, true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    e = cudaFuncSetAttribute(
        gram_kernel<S, false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const long long grid =
      ((long long)Na * Nb + Geo<S>::PPB - 1) / Geo<S>::PPB;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const dim3 g((unsigned)grid), t(kWarps * 32);
  if (pairs)
    gram_kernel<S, true><<<g, t, smem, stream>>>(
        A, B, Na, Nb, d, Tp, meta, n_steps, blocks, thr, pairs, count, prune,
        g_out, r, prefix, out);
  else
    gram_kernel<S, false><<<g, t, smem, stream>>>(
        A, B, Na, Nb, d, Tp, meta, n_steps, blocks, thr, pairs, count, prune,
        g_out, r, prefix, out);
  return (int)cudaGetLastError();
}

// The pair list of a bool mask: flat id i goes to slot csum[i] - 1, where
// csum is the mask's inclusive prefix sum, so the ids come out ascending;
// the last thread writes the count. One thread per mask entry.
__global__ void pair_list_kernel(const uint8_t* __restrict__ mask,
                                 const int* __restrict__ csum, int n,
                                 int* __restrict__ pairs,
                                 int* __restrict__ count) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  if (mask[i]) pairs[csum[i] - 1] = (int)i;
  if (i == n - 1) *count = csum[i];
}

template <int S>
int paired_s(const float* X, const float* Y, int P, int d, int Tp,
             const int* meta, int n_steps, const float* blocks,
             const float* thr, int prune, int g_out, int r, float* out,
             cudaStream_t stream) {
  const size_t smem = (size_t)Geo<S>::PPB * (Tp + Geo<S>::EXTRA) * 4;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        paired_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const long long grid = ((long long)P + Geo<S>::PPB - 1) / Geo<S>::PPB;
  paired_kernel<S><<<dim3((unsigned)grid), dim3(kWarps * 32), smem,
                     stream>>>(X, Y, P, d, Tp, meta, n_steps, blocks, thr,
                               prune, g_out, r, out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// (Na, Nb) Gram. thr (Na,) may be null. pairs (up to Na*Nb flat pair
// ids) and count (1 int, on the device) may be null: with them, only the
// first *count listed pairs are computed and written, every other entry
// of out is left as it is; without, every pair.
// prefix != 0: run the n_steps given, skip result capture, and write
// min(row_edge) per pair (the cascade's prefix bound).
// nt > 0: one thread per pair, nt threads per block (S in {8, 16, 32});
// nt = 0: lane groups (``spdtw_block.tile_geometry`` decides).
int spdtw_tiles_gram(const float* A, const float* B, int Na, int Nb, int d,
                     int Tp, const int* meta, int n_steps,
                     const float* blocks, int S, const float* thr,
                     const int* pairs, const int* count, int prune,
                     int g_out, int r, int prefix, int nt, float* out,
                     void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if ((pairs == nullptr) != (count == nullptr))
    return (int)cudaErrorInvalidValue;
  if (nt > 0)
    return thread_route(A, B, Na, Nb, 1, d, Tp, meta, n_steps, blocks, S,
                        thr, pairs, count, prune, g_out, r, prefix, nt, out,
                        st);
#define GRAM(SS) gram_s<SS>(A, B, Na, Nb, d, Tp, meta, n_steps, blocks, thr, \
                            pairs, count, prune, g_out, r, prefix, out, st)
  switch (S) {
    case 8: return GRAM(8);
    case 16: return GRAM(16);
    case 32: return GRAM(32);
    case 64: return GRAM(64);
    case 128: return GRAM(128);
    default: return (int)cudaErrorInvalidValue;
  }
#undef GRAM
}

// The ascending flat ids of the n set entries of mask (bool bytes) into
// pairs (n ints), their number into count (1 int), both on the device;
// csum (n ints) is the mask's inclusive prefix sum. Nothing is read back.
int spdtw_pair_list(const uint8_t* mask, const int* csum, int n, int* pairs,
                    int* count, void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  constexpr int kThreads = 256;
  pair_list_kernel<<<dim3((unsigned)(((long long)n + kThreads - 1) /
                                     kThreads)),
                     dim3(kThreads), 0, (cudaStream_t)stream>>>(
      mask, csum, n, pairs, count);
  return (int)cudaGetLastError();
}

// (P,) aligned pairs. thr (P,) may be null.
int spdtw_tiles_paired(const float* X, const float* Y, int P, int d, int Tp,
                       const int* meta, int n_steps, const float* blocks,
                       int S, const float* thr, int prune, int g_out, int r,
                       int nt, float* out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (nt > 0)
    return thread_route(X, Y, P, P, 0, d, Tp, meta, n_steps, blocks, S, thr,
                        nullptr, nullptr, prune, g_out, r, 0, nt, out, st);
  switch (S) {
    case 8: return paired_s<8>(X, Y, P, d, Tp, meta, n_steps, blocks, thr,
                               prune, g_out, r, out, st);
    case 16: return paired_s<16>(X, Y, P, d, Tp, meta, n_steps, blocks, thr,
                                 prune, g_out, r, out, st);
    case 32: return paired_s<32>(X, Y, P, d, Tp, meta, n_steps, blocks, thr,
                                 prune, g_out, r, out, st);
    case 64: return paired_s<64>(X, Y, P, d, Tp, meta, n_steps, blocks, thr,
                                 prune, g_out, r, out, st);
    case 128: return paired_s<128>(X, Y, P, d, Tp, meta, n_steps, blocks,
                                   thr, prune, g_out, r, out, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
