// Block-sparse SP-DTW tile engines for Hopper (sm_90a): the all-pairs Gram
// (``spdtw_tiles_gram``) and the aligned-pair batch (``spdtw_tiles_paired``).
//
// What they replace.
//   gram   <- src/repro/kernels/gram_block.py  _gram_spdtw_kernel
//             (entry gram_spdtw_block), the TPU kernel K1.
//   paired <- src/repro/kernels/spdtw_block.py _spdtw_block_kernel
//             (entry spdtw_block), the TPU kernel K2.
// Both walk the row-major active-tile plan of ``occupancy._tile_plan`` and
// run the per-tile DP of ``spdtw_block.tile_sweep``; they share one
// __device__ sweep (``sweep_pair``) so that K1 and K2 give identical values
// for the same pair, and both repeat the plain PyTorch versions
// (``gram_block.gram_spdtw_scan`` / ``spdtw_paired_scan``) operation by
// operation, so the results are bit-identical to them.
//
// What bounds them on this card. Each DP row is a serial min-plus chain:
// the in-row dependency D(i, j-1) is resolved by a Hillis-Steele scan of
// log2(S) dependent shuffle steps, and the tiles of one pair run one after
// the other. The work is FP32 ALU work outside the tensor cores (sub, mul,
// add, min), and the inputs are small (a few MB of series, the plan and
// the weight blocks), so device-memory traffic is negligible: the kernels
// are bound by instruction latency and FP32 instruction rate, not bytes.
//
// What the design does about it. The TPU kernel walked (A-block, B-block)
// pair tiles through a sequential grid axis and carried edges in VMEM
// scratch. Here the sequential grid axis is a loop inside the kernel, and
// the parallelism is across pairs instead: a group of min(S, 32) lanes
// owns one pair (two pairs per warp at S = 16, four at S = 8; at S > 32 a
// lane holds S/32 cells), so thousands of independent pairs hide each
// other's shuffle latency. Per pair, the bottom edges of the previous tile
// row (``row_edge``, Tp floats) and the right edge of the left tile
// (``col_edge``, S floats) live in shared memory; the corner, the alive
// flag and the result capture live in registers. The plan (``meta``,
// n_steps x 7 int32) and the weight blocks are read from device memory
// (through L1/L2; every pair reads the same ones), in place of the TPU's
// scalar prefetch. Pruning is per pair: a pair whose incoming edges all
// exceed its threshold skips the tile and publishes +INF edges, which is
// exactly what its pruned sweep would have produced.
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

// K1: pair p is (A row p / Nb, B row p % Nb).
template <int S>
__global__ void __launch_bounds__(kWarps * 32)
gram_kernel(const float* __restrict__ A, const float* __restrict__ B,
            int Na, int Nb, int d, int Tp, const int* __restrict__ meta,
            int n_steps, const float* __restrict__ blocks,
            const float* __restrict__ thr,
            const uint8_t* __restrict__ alive0, int prune, int g_out, int r,
            int prefix, float* __restrict__ out) {
  extern __shared__ float smem[];
  const Lanes ln = lanes<S>();
  const long long p = (long long)blockIdx.x * Geo<S>::PPB + ln.slot;
  if (p >= (long long)Na * Nb) return;
  const long long a = p / Nb, b = p % Nb;
  float* row_edge = smem + (size_t)ln.slot * (Tp + Geo<S>::EXTRA);
  float* col_edge = row_edge + Tp;
  const float v = sweep_pair<S>(
      A + a * d * Tp, B + b * d * Tp, d, Tp, meta, n_steps, blocks,
      thr ? thr[a] : kInf, alive0 ? alive0[p] != 0 : true, prune != 0,
      g_out, r, prefix != 0, row_edge, col_edge, col_edge + S,
      col_edge + 2 * S, ln.lane, ln.mask);
  if (ln.lane == 0) out[p] = v;
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
           const float* thr, const uint8_t* alive0, int prune, int g_out,
           int r, int prefix, float* out, cudaStream_t stream) {
  const size_t smem = (size_t)Geo<S>::PPB * (Tp + Geo<S>::EXTRA) * 4;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        gram_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const long long grid =
      ((long long)Na * Nb + Geo<S>::PPB - 1) / Geo<S>::PPB;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  gram_kernel<S><<<dim3((unsigned)grid), dim3(kWarps * 32), smem,
                   stream>>>(A, B, Na, Nb, d, Tp, meta, n_steps, blocks, thr,
                             alive0, prune, g_out, r, prefix, out);
  return (int)cudaGetLastError();
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

// (Na, Nb) Gram. thr (Na,) and alive0 (Na*Nb, bool bytes) may be null.
// prefix != 0: run the n_steps given, skip result capture, and write
// min(row_edge) per pair (the cascade's prefix bound).
int spdtw_tiles_gram(const float* A, const float* B, int Na, int Nb, int d,
                     int Tp, const int* meta, int n_steps,
                     const float* blocks, int S, const float* thr,
                     const uint8_t* alive0, int prune, int g_out, int r,
                     int prefix, float* out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (S) {
    case 8: return gram_s<8>(A, B, Na, Nb, d, Tp, meta, n_steps, blocks,
                             thr, alive0, prune, g_out, r, prefix, out, st);
    case 16: return gram_s<16>(A, B, Na, Nb, d, Tp, meta, n_steps, blocks,
                               thr, alive0, prune, g_out, r, prefix, out, st);
    case 32: return gram_s<32>(A, B, Na, Nb, d, Tp, meta, n_steps, blocks,
                               thr, alive0, prune, g_out, r, prefix, out, st);
    case 64: return gram_s<64>(A, B, Na, Nb, d, Tp, meta, n_steps, blocks,
                               thr, alive0, prune, g_out, r, prefix, out, st);
    case 128: return gram_s<128>(A, B, Na, Nb, d, Tp, meta, n_steps, blocks,
                                 thr, alive0, prune, g_out, r, prefix, out,
                                 st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// (P,) aligned pairs. thr (P,) may be null.
int spdtw_tiles_paired(const float* X, const float* Y, int P, int d, int Tp,
                       const int* meta, int n_steps, const float* blocks,
                       int S, const float* thr, int prune, int g_out, int r,
                       float* out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
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
