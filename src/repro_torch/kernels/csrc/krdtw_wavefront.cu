// Anti-diagonal K_rdtw sweeps for Hopper (sm_90a): the all-pairs log-kernel
// Gram (``krdtw_gram``) and the aligned-pair batch (``krdtw_paired``).
//
// What they replace.
//   krdtw_gram   <- src/repro/kernels/gram_block.py      _gram_krdtw_kernel
//                   (entry gram_log_krdtw_block), the TPU kernel K3.
//   krdtw_paired <- src/repro/kernels/krdtw_wavefront.py _krdtw_kernel
//                   (entry wavefront_log_krdtw), the TPU kernel K4.
// Both run paper Algorithm 2 (the K1 + K2 sum-product recursions of
// K_rdtw) one anti-diagonal k = i + j at a time, with one shared per-pair
// rescale by the maximum of the two new and the two previous diagonals,
// exactly as ``krdtw_wavefront.krdtw_sweep`` (the plain PyTorch version)
// does. They share one __device__ sweep per geometry, so K3 and K4 give
// bit-identical values for the same pair: the kernel 1-NN cascade compares
// K4 seeds and survivors against K3 Gram values, and the SVM normalises K3
// Grams by K4 self-similarities.
//
// What bounds them on this card. Per admissible cell: one expf (the local
// kernel) and about 20 FP32 operations (the two recursions and the rescale
// multiplies). Per diagonal and pair, whatever the support: one logf and
// one division (the rescale). The inputs are two (N, T) float arrays and
// the output one float per pair, so device-memory traffic is negligible:
// the kernels are bound by FP32 / SFU instruction throughput.
//
// What the design does about it. The support (grid, corridor or learned
// cells) is the same for every pair of a launch, so the host computes once
// the hull [lo_k, lo_k + width_k) of the admissible positions i of each
// diagonal k (``krdtw_wavefront.krdtw_geometry``); positions outside it
// hold 0, the additive identity, and are never visited. W = max width_k.
//   Narrow hull (W <= 32, ``sweep_narrow``): a group of G lanes (the power
//   of two >= W, raised only when the per-pair shared memory would not fit)
//   owns one pair, 32 / G pairs per warp. Lane l holds position lo_k + l.
//   The i and i - 1 neighbours on diagonals k - 1 and k - 2 come from
//   __shfl_sync at source lanes offset by lo_k - lo_{k-1} and lo_k -
//   lo_{k-2}, which every pair of the launch shares; a source outside the
//   group lies outside the previous hull and reads 0. The support inside
//   the hull is one 32-bit word per diagonal (bit l: position lo_k + l),
//   read through L1. The per-diagonal max is a log2 G-step group
//   reduction.
//   Wide hull, T <= 512 (``sweep_regs``): one warp owns one pair; lane l
//   holds the fixed positions c * 32 + l in registers (C <= 16 slots), and
//   a slot whose 32 positions miss the hull is skipped on that diagonal,
//   which halves the full grid's positions.
//   Wide hull, T > 512 (``sweep_wide``): one warp owns one pair, and the
//   live diagonals live in per-pair shared memory, indexed from the hull's
//   start (three rotating buffers for each of K1 and K2, W floats each);
//   lanes loop over the hull's positions only. The previous diagonal's
//   maximum is carried, not recomputed: rounding x -> x * inv is monotone,
//   so max(round(v * inv)) = round(max(v) * inv) exactly. Any length whose
//   buffers fit runs (T >= 2709 at the full grid).
// A learned support's holes are read as bits of the diagonal-major mask
// through L1 (no full mask in shared memory). kappa(x_i, y_i) is computed
// once per pair into shared memory, and the series are read through L1.
//
// Floating point. Every multiply and add uses the _rn intrinsics in the
// plain version's order, the file is built with --fmad=false, and the
// transcendental functions are expf / logf (no fast math), as PyTorch's
// exp / log kernels on the card use.
//
// C interface (bound with ctypes): every function returns
// cudaGetLastError() after its launch (0 = launched).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1.0e30f;
constexpr float kThird = (float)(1.0 / 3.0);
constexpr int kSmemMax = 232448;

__device__ __forceinline__ float sq(float v) { return __fmul_rn(v, v); }

__device__ __forceinline__ float local_kernel(float a, float b, float neg_nu) {
  return expf(__fmul_rn(neg_nu, sq(__fsub_rn(a, b))));
}

// K1 = kap/3 * (K1_{k-1}[i-1] + K1_{k-1}[i] + K1_{k-2}[i-1])
__device__ __forceinline__ float rec_k1(float kap, float l1, float s1,
                                        float l2) {
  return __fmul_rn(__fmul_rn(kap, kThird), __fadd_rn(__fadd_rn(l1, s1), l2));
}

// K2 = 1/3 * ((dx + dy)/2 * K2_{k-2}[i-1] + dx * K2_{k-1}[i-1]
//             + dy * K2_{k-1}[i])
__device__ __forceinline__ float rec_k2(float dxv, float dyv, float l2,
                                        float l1, float s1) {
  const float t0 = __fmul_rn(__fmul_rn(__fadd_rn(dxv, dyv), 0.5f), l2);
  const float t1 = __fmul_rn(dxv, l1);
  const float t2 = __fmul_rn(dyv, s1);
  return __fmul_rn(kThird, __fadd_rn(__fadd_rn(t0, t1), t2));
}

__device__ __forceinline__ float finish(float tot, float ls) {
  return tot > 0.f ? __fadd_rn(logf(fmaxf(tot, 1e-37f)), ls) : kNeg;
}

// kappa(x_i, y_i) of one pair into shared memory, by n lanes from lane l
__device__ __forceinline__ void fill_dx(const float* __restrict__ x,
                                        const float* __restrict__ y, int T,
                                        float neg_nu, float* dxs, int l,
                                        int n) {
  for (int i = l; i < T; i += n)
    dxs[i] = local_kernel(__ldg(x + i), __ldg(y + i), neg_nu);
}

// ------------------------------------------------------------ narrow ----

// One pair's sweep by the G lanes of a group (lane l of the group, gbase
// its first lane in the warp). lo: (2T-1,) hull starts; hb: (2T-1,) hull
// bits. Every lane of the warp calls it with the same T, so the warp's
// shuffles stay converged. Returns log(K1 + K2) on every lane of the group.
template <int G>
__device__ float sweep_narrow(const float* __restrict__ x,
                              const float* __restrict__ y, int T, float nu,
                              const int* __restrict__ lo,
                              const uint32_t* __restrict__ hb, float* dxs,
                              int l, int gbase) {
  const float neg_nu = -nu;
  fill_dx(x, y, T, neg_nu, dxs, l, G);
  __syncwarp();

  // diagonal 0: only cell (0, 0)
  const bool v0 = l == 0 && (__ldg(hb) & 1u) != 0;
  float k1m1 = v0 ? local_kernel(__ldg(x), __ldg(y), neg_nu) : 0.f;
  float k2m1 = k1m1, k1m2 = 0.f, k2m2 = 0.f;
  int lo1 = __ldg(lo), lo2 = lo1;
  float ls = 0.f;

  for (int k = 1; k < 2 * T - 1; ++k) {
    const int lok = __ldg(lo + k);
    const uint32_t bits = __ldg(hb + k);
    // sources of (k-1, i), (k-1, i-1), (k-2, i-1) inside the group
    const int s1 = l + lok - lo1, s2 = s1 - 1, s3 = l + lok - lo2 - 1;
    const float a_s = __shfl_sync(0xffffffffu, k1m1, gbase + (s1 & (G - 1)));
    const float a_l = __shfl_sync(0xffffffffu, k1m1, gbase + (s2 & (G - 1)));
    const float a_2 = __shfl_sync(0xffffffffu, k1m2, gbase + (s3 & (G - 1)));
    const float b_s = __shfl_sync(0xffffffffu, k2m1, gbase + (s1 & (G - 1)));
    const float b_l = __shfl_sync(0xffffffffu, k2m1, gbase + (s2 & (G - 1)));
    const float b_2 = __shfl_sync(0xffffffffu, k2m2, gbase + (s3 & (G - 1)));
    const bool in1 = s1 >= 0 && s1 < G, in2 = s2 >= 0 && s2 < G,
               in3 = s3 >= 0 && s3 < G;
    float v1 = 0.f, v2 = 0.f;
    if ((bits >> l) & 1u) {
      const int i = lok + l, j = k - i;
      const float kap = local_kernel(__ldg(x + i), __ldg(y + j), neg_nu);
      v1 = rec_k1(kap, in2 ? a_l : 0.f, in1 ? a_s : 0.f, in3 ? a_2 : 0.f);
      v2 = rec_k2(dxs[i], dxs[j], in3 ? b_2 : 0.f, in2 ? b_l : 0.f,
                  in1 ? b_s : 0.f);
    }
    float m = fmaxf(fmaxf(v1, v2), fmaxf(k1m1, k2m1));
#pragma unroll
    for (int off = G / 2; off > 0; off >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    float inv = 1.f;
    if (m > 0.f) {
      inv = __fdiv_rn(1.f, m);
      ls = __fadd_rn(ls, logf(m));
    }
    k1m2 = __fmul_rn(k1m1, inv);
    k1m1 = __fmul_rn(v1, inv);
    k2m2 = __fmul_rn(k2m1, inv);
    k2m1 = __fmul_rn(v2, inv);
    lo2 = lo1;
    lo1 = lok;
  }
  // the result cell (T-1, T-1) at position T-1 of the last diagonal
  const int rs = T - 1 - lo1;
  const float tot = __fadd_rn(k1m1, k2m1);
  const float t = __shfl_sync(0xffffffffu, tot, gbase + (rs & (G - 1)));
  return finish(rs >= 0 && rs < G ? t : 0.f, ls);
}

// K3 (gram != 0): pair p is (A row p / Nb, B row p % Nb);
// K4 (gram == 0): pair p is (A row p, B row p).
template <int G>
__global__ void narrow_kernel(const float* __restrict__ A,
                              const float* __restrict__ B, int Na, int Nb,
                              int gram, int T, float nu,
                              const int* __restrict__ lo,
                              const uint32_t* __restrict__ hb,
                              float* __restrict__ out) {
  extern __shared__ float smem[];
  constexpr int PPW = 32 / G;
  const int warp = threadIdx.x >> 5, l32 = threadIdx.x & 31;
  const int slot = warp * PPW + l32 / G;
  const int ppb = (blockDim.x >> 5) * PPW;
  const long long P = gram ? (long long)Na * Nb : (long long)Na;
  const long long p = (long long)blockIdx.x * ppb + slot;
  // a pair past the end runs the last pair's sweep and writes nothing, so
  // that the warp's shuffles see every lane
  const long long q = p < P ? p : P - 1;
  const long long a = gram ? q / Nb : q;
  const long long b = gram ? q % Nb : q;
  const float v = sweep_narrow<G>(A + a * T, B + b * T, T, nu, lo, hb,
                                  smem + (size_t)slot * T, l32 % G,
                                  l32 - l32 % G);
  if (p < P && l32 % G == 0) out[p] = v;
}

// ---------------------------------------------------- wide, registers ----

// One pair's sweep by one warp for T <= 32 C: lane l holds the fixed
// positions i = c * 32 + l (slot c), with x_i and kappa(x_i, y_i) in
// registers; y_{k-i} and kappa(x_{k-i}, y_{k-i}) are read from shared
// memory. A slot whose 32 positions miss diagonal k's hull is skipped (the
// test is the same on every lane). The i - 1 neighbour of slot c is one
// shuffle: lane l reads lane l - 1, which offers slot c, and lane 0 reads
// lane 31, which offers slot c - 1.
template <int C>
__device__ float sweep_regs(const float* __restrict__ x,
                            const float* __restrict__ y, int T, float nu,
                            const int* __restrict__ lo,
                            const int* __restrict__ wd,
                            const uint32_t* __restrict__ mask, int nw,
                            float* ys, float* dxs, int lane) {
  const float neg_nu = -nu;
  float xv[C], dxv[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int i = c * 32 + lane;
    xv[c] = 0.f;
    dxv[c] = 0.f;
    if (i < T) {
      xv[c] = __ldg(x + i);
      const float yi = __ldg(y + i);
      ys[i] = yi;
      dxv[c] = local_kernel(xv[c], yi, neg_nu);
      dxs[i] = dxv[c];
    }
  }
  __syncwarp();
  float k1m1[C], k1m2[C], k2m1[C], k2m2[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    k1m1[c] = 0.f;
    k1m2[c] = 0.f;
    k2m1[c] = 0.f;
    k2m2[c] = 0.f;
  }
  // diagonal 0: only cell (0, 0)
  if (lane == 0 && __ldg(wd) > 0) {
    k1m1[0] = local_kernel(xv[0], ys[0], neg_nu);
    k2m1[0] = k1m1[0];
  }
  const int src = (lane + 31) & 31;
  float ls = 0.f;
  for (int k = 1; k < 2 * T - 1; ++k) {
    const int lok = __ldg(lo + k), hik = lok + __ldg(wd + k) - 1;
    float n1[C], n2[C];
    float m = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      n1[c] = 0.f;
      n2[c] = 0.f;
      if (c * 32 <= hik && c * 32 + 31 >= lok) {
        const bool top = lane == 31;
        const float a_l = __shfl_sync(
            0xffffffffu, top ? (c ? k1m1[c - 1] : 0.f) : k1m1[c], src);
        const float a_2 = __shfl_sync(
            0xffffffffu, top ? (c ? k1m2[c - 1] : 0.f) : k1m2[c], src);
        const float b_l = __shfl_sync(
            0xffffffffu, top ? (c ? k2m1[c - 1] : 0.f) : k2m1[c], src);
        const float b_2 = __shfl_sync(
            0xffffffffu, top ? (c ? k2m2[c - 1] : 0.f) : k2m2[c], src);
        const int i = c * 32 + lane, j = k - i;
        bool ok = i >= lok && i <= hik;
        if (ok && mask != nullptr)
          ok = ((__ldg(mask + (size_t)k * nw + c) >> lane) & 1u) != 0;
        if (ok) {
          const float kap = local_kernel(xv[c], ys[j], neg_nu);
          n1[c] = rec_k1(kap, a_l, k1m1[c], a_2);
          n2[c] = rec_k2(dxv[c], dxs[j], b_2, b_l, k2m1[c]);
        }
      }
      m = fmaxf(m, fmaxf(fmaxf(n1[c], n2[c]), fmaxf(k1m1[c], k2m1[c])));
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    float inv = 1.f;
    if (m > 0.f) {
      inv = __fdiv_rn(1.f, m);
      ls = __fadd_rn(ls, logf(m));
    }
#pragma unroll
    for (int c = 0; c < C; ++c) {
      k1m2[c] = __fmul_rn(k1m1[c], inv);
      k1m1[c] = __fmul_rn(n1[c], inv);
      k2m2[c] = __fmul_rn(k2m1[c], inv);
      k2m1[c] = __fmul_rn(n2[c], inv);
    }
  }
  // the result cell (T-1, T-1) at position T-1 of the last diagonal
  float tot = 0.f;
#pragma unroll
  for (int c = 0; c < C; ++c)
    if (c * 32 + lane == T - 1) tot = __fadd_rn(k1m1[c], k2m1[c]);
  return finish(__shfl_sync(0xffffffffu, tot, (T - 1) & 31), ls);
}

template <int C>
__global__ void regs_kernel(const float* __restrict__ A,
                            const float* __restrict__ B, int Na, int Nb,
                            int gram, int T, float nu,
                            const int* __restrict__ lo,
                            const int* __restrict__ wd,
                            const uint32_t* __restrict__ mask,
                            float* __restrict__ out) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long P = gram ? (long long)Na * Nb : (long long)Na;
  const long long p = (long long)blockIdx.x * (blockDim.x >> 5) + warp;
  if (p >= P) return;
  const long long a = gram ? p / Nb : p;
  const long long b = gram ? p % Nb : p;
  float* ys = smem + (size_t)warp * 2 * T;
  const float v = sweep_regs<C>(A + a * T, B + b * T, T, nu, lo, wd, mask,
                                (T + 31) / 32, ys, ys + T, lane);
  if (lane == 0) out[p] = v;
}

// ----------------------------------------------- wide, shared memory ----

// One pair's sweep by one warp. lo, wd: (2T-1,) hull starts and widths;
// mask: the bit-packed diagonal-major support ((2T-1) x nw words) or null
// (the hull is the support); buf: T + 6 W floats of shared memory.
__device__ float sweep_wide(const float* __restrict__ x,
                            const float* __restrict__ y, int T, float nu,
                            const int* __restrict__ lo,
                            const int* __restrict__ wd,
                            const uint32_t* __restrict__ mask, int nw, int W,
                            float* buf, int lane) {
  const float neg_nu = -nu;
  float* dxs = buf;
  // K1 buffer c at buf + T + c W, K2 buffer c at buf + T + (3 + c) W
  float* k1b = buf + T;
  float* k2b = buf + T + 3 * W;
  fill_dx(x, y, T, neg_nu, dxs, lane, 32);
  // diagonal 0 (buffer 0 = diagonal k - 1 at k = 1)
  int w1 = __ldg(wd), lo1 = __ldg(lo), w2 = 0, lo2 = 0;
  float pmax = 0.f;
  if (w1 > 0) {
    const bool ok = mask == nullptr || (__ldg(mask) & 1u) != 0;
    const float kap0 = ok ? local_kernel(__ldg(x), __ldg(y), neg_nu) : 0.f;
    if (lane == 0) { k1b[0] = kap0; k2b[0] = kap0; }
    pmax = kap0;
  }
  __syncwarp();
  int c1 = 0, c2 = 1, cn = 2;   // buffers of diagonals k-1, k-2, k
  float ls = 0.f;
  for (int k = 1; k < 2 * T - 1; ++k) {
    const int lok = __ldg(lo + k), wk = __ldg(wd + k);
    float* p1 = k1b + c1 * W;
    const float* p2 = k1b + c2 * W;
    float* q1 = k2b + c1 * W;
    const float* q2 = k2b + c2 * W;
    float* n1 = k1b + cn * W;
    float* n2 = k2b + cn * W;
    float lmax = 0.f;
    for (int r = lane; r < wk; r += 32) {
      const int i = lok + r, j = k - i;
      bool ok = true;
      if (mask != nullptr)
        ok = ((__ldg(mask + (size_t)k * nw + (i >> 5)) >> (i & 31)) & 1u) != 0;
      float v1 = 0.f, v2 = 0.f;
      if (ok) {
        const int r1 = i - lo1, r2 = i - 1 - lo2;
        const bool in_s = r1 >= 0 && r1 < w1, in_l = r1 >= 1 && r1 <= w1,
                   in_2 = r2 >= 0 && r2 < w2;
        const float kap = local_kernel(__ldg(x + i), __ldg(y + j), neg_nu);
        v1 = rec_k1(kap, in_l ? p1[r1 - 1] : 0.f, in_s ? p1[r1] : 0.f,
                    in_2 ? p2[r2] : 0.f);
        v2 = rec_k2(dxs[i], dxs[j], in_2 ? q2[r2] : 0.f,
                    in_l ? q1[r1 - 1] : 0.f, in_s ? q1[r1] : 0.f);
      }
      n1[r] = v1;
      n2[r] = v2;
      lmax = fmaxf(lmax, fmaxf(v1, v2));
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      lmax = fmaxf(lmax, __shfl_xor_sync(0xffffffffu, lmax, off));
    const float m = fmaxf(lmax, pmax);
    float inv = 1.f;
    if (m > 0.f) {
      inv = __fdiv_rn(1.f, m);
      ls = __fadd_rn(ls, logf(m));
    }
    __syncwarp();   // every read of diagonals k-1 and k-2 is done
    for (int r = lane; r < wk; r += 32) {
      n1[r] = __fmul_rn(n1[r], inv);
      n2[r] = __fmul_rn(n2[r], inv);
    }
    for (int r = lane; r < w1; r += 32) {
      p1[r] = __fmul_rn(p1[r], inv);
      q1[r] = __fmul_rn(q1[r], inv);
    }
    pmax = __fmul_rn(lmax, inv);
    __syncwarp();
    const int t = c2;
    c2 = c1;
    c1 = cn;
    cn = t;
    w2 = w1;
    lo2 = lo1;
    w1 = wk;
    lo1 = lok;
  }
  const int rs = T - 1 - lo1;
  const float tot = rs >= 0 && rs < w1
                        ? __fadd_rn(k1b[c1 * W + rs], k2b[c1 * W + rs])
                        : 0.f;
  return finish(tot, ls);
}

__global__ void wide_kernel(const float* __restrict__ A,
                            const float* __restrict__ B, int Na, int Nb,
                            int gram, int T, float nu,
                            const int* __restrict__ lo,
                            const int* __restrict__ wd,
                            const uint32_t* __restrict__ mask, int W,
                            float* __restrict__ out) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long P = gram ? (long long)Na * Nb : (long long)Na;
  const long long p = (long long)blockIdx.x * (blockDim.x >> 5) + warp;
  if (p >= P) return;
  const long long a = gram ? p / Nb : p;
  const long long b = gram ? p % Nb : p;
  const float v = sweep_wide(A + a * T, B + b * T, T, nu, lo, wd, mask,
                             (T + 31) / 32, W,
                             smem + (size_t)warp * (T + 6 * W), lane);
  if (lane == 0) out[p] = v;
}

// ------------------------------------------------------------ launch ----

template <typename K>
int set_smem(K kernel, size_t smem) {
  if (smem > (size_t)kSmemMax) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

template <int G>
int launch_narrow(const float* A, const float* B, int Na, int Nb, int gram,
                  int T, float nu, const int* lo, const uint32_t* hb,
                  int warps, float* out, cudaStream_t stream) {
  const int ppb = warps * (32 / G);
  const size_t smem = (size_t)ppb * T * 4;
  const int rc = set_smem(narrow_kernel<G>, smem);
  if (rc) return rc;
  const long long P = gram ? (long long)Na * Nb : (long long)Na;
  const long long grid = (P + ppb - 1) / ppb;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  narrow_kernel<G><<<dim3((unsigned)grid), dim3(warps * 32), smem,
                     stream>>>(A, B, Na, Nb, gram, T, nu, lo, hb, out);
  return (int)cudaGetLastError();
}

template <int C>
int launch_regs(const float* A, const float* B, int Na, int Nb, int gram,
                int T, float nu, const int* lo, const int* wd,
                const uint32_t* mask, int warps, float* out,
                cudaStream_t stream) {
  if (T > 32 * C) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)warps * 2 * T * 4;
  const int rc = set_smem(regs_kernel<C>, smem);
  if (rc) return rc;
  const long long P = gram ? (long long)Na * Nb : (long long)Na;
  const long long grid = (P + warps - 1) / warps;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  regs_kernel<C><<<dim3((unsigned)grid), dim3(warps * 32), smem, stream>>>(
      A, B, Na, Nb, gram, T, nu, lo, wd, mask, out);
  return (int)cudaGetLastError();
}

// mode 0: narrow hull, n = G lanes per pair, bits the hull words;
// mode 1: wide hull in registers, n = C slots per lane, bits the
// diagonal-major mask or null; mode 2: wide hull in shared memory, bits
// likewise.
int launch(const float* A, const float* B, int Na, int Nb, int gram, int T,
           float nu, const int* lo, const int* wd, const uint32_t* bits,
           int W, int mode, int n, int warps, float* out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (T < 1 || warps < 1 || warps > 32) return (int)cudaErrorInvalidValue;
  if (mode == 1) {
#define REGS(c) launch_regs<c>(A, B, Na, Nb, gram, T, nu, lo, wd, bits, \
                               warps, out, st)
    switch (n) {
      case 1: return REGS(1);
      case 2: return REGS(2);
      case 4: return REGS(4);
      case 8: return REGS(8);
      case 16: return REGS(16);
      default: return (int)cudaErrorInvalidValue;
    }
#undef REGS
  }
  if (mode == 2) {
    const size_t smem = (size_t)warps * (T + 6 * W) * 4;
    const int rc = set_smem(wide_kernel, smem);
    if (rc) return rc;
    const long long P = gram ? (long long)Na * Nb : (long long)Na;
    const long long grid = (P + warps - 1) / warps;
    if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
    wide_kernel<<<dim3((unsigned)grid), dim3(warps * 32), smem, st>>>(
        A, B, Na, Nb, gram, T, nu, lo, wd, bits, W, out);
    return (int)cudaGetLastError();
  }
  if (mode != 0) return (int)cudaErrorInvalidValue;
  const int G = n;
  if (bits == nullptr || W > G) return (int)cudaErrorInvalidValue;
#define NARROW(g) launch_narrow<g>(A, B, Na, Nb, gram, T, nu, lo, bits, \
                                   warps, out, st)
  switch (G) {
    case 1: return NARROW(1);
    case 2: return NARROW(2);
    case 4: return NARROW(4);
    case 8: return NARROW(8);
    case 16: return NARROW(16);
    case 32: return NARROW(32);
    default: return (int)cudaErrorInvalidValue;
  }
#undef NARROW
}

}  // namespace

extern "C" {

// (Na, Nb) log-kernel Gram. lo, wd: (2T-1,) int32 hull starts and widths
// (W their largest width); mode and n as ``launch`` (0: narrow, n lanes per
// pair, bits (2T-1,) hull words; 1: wide in registers, n slots per lane;
// 2: wide in shared memory; 1 and 2 read the (2T-1) x ceil(T/32)
// diagonal-major mask, or null for the grid or a corridor); warps per
// block. ``krdtw_wavefront.krdtw_geometry`` picks them.
int krdtw_gram(const float* A, const float* B, int Na, int Nb, int T,
               float nu, const int* lo, const int* wd, const uint32_t* bits,
               int W, int mode, int n, int warps, float* out, void* stream) {
  return launch(A, B, Na, Nb, 1, T, nu, lo, wd, bits, W, mode, n, warps,
                out, stream);
}

// (P,) aligned pairs: X, Y (P, T); Nb must equal P.
int krdtw_paired(const float* X, const float* Y, int P, int Nb, int T,
                 float nu, const int* lo, const int* wd,
                 const uint32_t* bits, int W, int mode, int n, int warps,
                 float* out, void* stream) {
  return launch(X, Y, P, Nb, 0, T, nu, lo, wd, bits, W, mode, n, warps, out,
                stream);
}

}  // extern "C"
