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
// does. They share one __device__ sweep (``sweep_pair``), so K3 and K4 give
// bit-identical values for the same pair: the kernel 1-NN cascade compares
// K4 seeds and survivors against K3 Gram values, and the SVM normalises K3
// Grams by K4 self-similarities.
//
// What bounds them on this card. Per needed cell: one expf (the local
// kernel), about 20 FP32 operations (the two recursions and the rescale
// multiplies). The inputs are two (N, T) float arrays and the output one
// float per pair, so device-memory traffic is negligible: the kernels are
// bound by FP32 / SFU instruction issue. The diagonal-major sweep visits
// (2T - 1) * T positions for T^2 cells, and a masked or out-of-corridor
// cell costs its test and a zero.
//
// What the design does about it. The TPU kernel put 8 pairs on the
// sublanes and one diagonal on the lanes of a vector register. Here one
// warp owns one pair, and the diagonal lives in registers: lane l holds
// positions i = l * C .. l * C + C - 1 (C = 1, 2, 4, 8 or 16; T <= 512).
// The i - 1 neighbour comes from the lane's own registers or, for its first
// position, from one __shfl_up_sync of the lane below. The column series
// y_{k-i} and dy_{k-i} = kappa(x_{k-i}, y_{k-i}) move one position up per
// diagonal, so they too are register streams shifted by one shuffle, fed
// at position 0 from shared memory. The per-diagonal maximum is a warp
// reduction (max is exact in any order). The learned support is kept in
// shared memory as bits of the diagonal-major layout
// (``mask_to_diagonal_major``), one 32-bit word per 32 positions of a
// diagonal.
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
constexpr int kWarps = 8;               // pairs (warps) per thread block

__device__ __forceinline__ float sq(float v) { return __fmul_rn(v, v); }

__device__ __forceinline__ float local_kernel(float a, float b, float neg_nu) {
  return expf(__fmul_rn(neg_nu, sq(__fsub_rn(a, b))));
}

// One pair's sweep, run by one full warp. x, y: the pair's series in
// device memory; ys, dxs: T floats of per-warp shared memory; mask: the
// bit-packed diagonal-major support in shared memory (null = full grid);
// radius < 0: no corridor. Returns log(K1 + K2) on every lane.
template <int C>
__device__ float sweep_pair(const float* __restrict__ x,
                            const float* __restrict__ y, int T, float nu,
                            int radius, const uint32_t* mask, int nw,
                            float* ys, float* dxs, int lane) {
  const float neg_nu = -nu;
  float xv[C], dxv[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int i = lane * C + c;
    xv[c] = 0.f;
    dxv[c] = 0.f;
    if (i < T) {
      xv[c] = x[i];
      const float yi = y[i];
      ys[i] = yi;
      dxv[c] = local_kernel(xv[c], yi, neg_nu);   // kappa(x_i, y_i)
      dxs[i] = dxv[c];
    }
  }
  __syncwarp();

  // diagonal 0: only cell (0, 0), inside any corridor
  const bool valid0 = mask == nullptr || (mask[0] & 1u) != 0;
  float yv[C], dyv[C], k1m1[C], k1m2[C], k2m1[C], k2m2[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const bool first = lane == 0 && c == 0;
    yv[c] = first ? ys[0] : 0.f;
    dyv[c] = first ? dxs[0] : 0.f;
    k1m1[c] = (first && valid0) ? local_kernel(xv[0], yv[0], neg_nu) : 0.f;
    k2m1[c] = k1m1[c];
    k1m2[c] = 0.f;
    k2m2[c] = 0.f;
  }
  float ls = 0.f;

  for (int k = 1; k < 2 * T - 1; ++k) {
    // the column streams: position i now holds y_{k-i}, dy_{k-i}
    const float y_in = k < T ? ys[k] : 0.f;
    const float dy_in = k < T ? dxs[k] : 0.f;
    const float y_up = __shfl_up_sync(0xffffffffu, yv[C - 1], 1);
    const float dy_up = __shfl_up_sync(0xffffffffu, dyv[C - 1], 1);
#pragma unroll
    for (int c = C - 1; c > 0; --c) {
      yv[c] = yv[c - 1];
      dyv[c] = dyv[c - 1];
    }
    yv[0] = lane == 0 ? y_in : y_up;
    dyv[0] = lane == 0 ? dy_in : dy_up;

    // i - 1 neighbours of the first position, from the lane below
    float a1 = __shfl_up_sync(0xffffffffu, k1m1[C - 1], 1);
    float a2 = __shfl_up_sync(0xffffffffu, k1m2[C - 1], 1);
    float b1 = __shfl_up_sync(0xffffffffu, k2m1[C - 1], 1);
    float b2 = __shfl_up_sync(0xffffffffu, k2m2[C - 1], 1);
    if (lane == 0) { a1 = 0.f; a2 = 0.f; b1 = 0.f; b2 = 0.f; }

    float k1[C], k2[C];
    float m = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int i = lane * C + c;
      const float sh_k1m1 = c ? k1m1[c - 1] : a1;
      const float sh_k1m2 = c ? k1m2[c - 1] : a2;
      const float sh_k2m1 = c ? k2m1[c - 1] : b1;
      const float sh_k2m2 = c ? k2m2[c - 1] : b2;
      bool valid = i < T && i <= k && i > k - T;
      if (radius >= 0) valid = valid && abs(2 * i - k) <= radius;
      if (mask != nullptr && valid)
        valid = ((mask[k * nw + (i >> 5)] >> (i & 31)) & 1u) != 0;
      float v1 = 0.f, v2 = 0.f;
      if (valid) {
        const float kap = local_kernel(xv[c], yv[c], neg_nu);
        // K1 = kap/3 * (K1_{k-1}[i-1] + K1_{k-1}[i] + K1_{k-2}[i-1])
        v1 = __fmul_rn(__fmul_rn(kap, kThird),
                       __fadd_rn(__fadd_rn(sh_k1m1, k1m1[c]), sh_k1m2));
        // K2 = 1/3 * ((dx + dy)/2 * K2_{k-2}[i-1] + dx * K2_{k-1}[i-1]
        //             + dy * K2_{k-1}[i])
        const float t0 = __fmul_rn(
            __fmul_rn(__fadd_rn(dxv[c], dyv[c]), 0.5f), sh_k2m2);
        const float t1 = __fmul_rn(dxv[c], sh_k2m1);
        const float t2 = __fmul_rn(dyv[c], k2m1[c]);
        v2 = __fmul_rn(kThird, __fadd_rn(__fadd_rn(t0, t1), t2));
      }
      k1[c] = v1;
      k2[c] = v2;
      m = fmaxf(m, fmaxf(fmaxf(v1, v2), fmaxf(k1m1[c], k2m1[c])));
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
      k1m1[c] = __fmul_rn(k1[c], inv);
      k2m2[c] = __fmul_rn(k2m1[c], inv);
      k2m1[c] = __fmul_rn(k2[c], inv);
    }
  }

  // the result cell (T-1, T-1) sits at position T-1 of the last diagonal
  float tot = 0.f;
#pragma unroll
  for (int c = 0; c < C; ++c)
    if (lane * C + c == T - 1) tot = __fadd_rn(k1m1[c], k2m1[c]);
  tot = __shfl_sync(0xffffffffu, tot, (T - 1) / C);
  return tot > 0.f ? __fadd_rn(logf(fmaxf(tot, 1e-37f)), ls) : kNeg;
}

// K3 (gram != 0): pair p is (A row p / Nb, B row p % Nb);
// K4 (gram == 0): pair p is (A row p, B row p).
template <int C>
__global__ void __launch_bounds__(kWarps * 32)
krdtw_kernel(const float* __restrict__ A, const float* __restrict__ B,
             int Na, int Nb, int gram, int T, float nu, int radius,
             const uint32_t* __restrict__ mask_g, float* __restrict__ out) {
  extern __shared__ uint32_t smem[];
  const int nw = (T + 31) / 32;
  const int n_mask = mask_g != nullptr ? (2 * T - 1) * nw : 0;
  for (int t = threadIdx.x; t < n_mask; t += blockDim.x) smem[t] = mask_g[t];
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long P = gram ? (long long)Na * Nb : (long long)Na;
  const long long p = (long long)blockIdx.x * kWarps + warp;
  if (p >= P) return;
  const long long a = gram ? p / Nb : p;
  const long long b = gram ? p % Nb : p;
  float* ys = reinterpret_cast<float*>(smem + n_mask) + (size_t)warp * 2 * T;
  const float v = sweep_pair<C>(A + a * T, B + b * T, T, nu, radius,
                                mask_g != nullptr ? smem : nullptr, nw, ys,
                                ys + T, lane);
  if (lane == 0) out[p] = v;
}

template <int C>
int launch_c(const float* A, const float* B, int Na, int Nb, int gram,
             int T, float nu, int radius, const uint32_t* mask, float* out,
             cudaStream_t stream) {
  const int nw = (T + 31) / 32;
  const size_t smem = ((mask ? (size_t)(2 * T - 1) * nw : 0) +
                       (size_t)kWarps * 2 * T) * 4;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        krdtw_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const long long P = gram ? (long long)Na * Nb : (long long)Na;
  const long long grid = (P + kWarps - 1) / kWarps;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  krdtw_kernel<C><<<dim3((unsigned)grid), dim3(kWarps * 32), smem,
                    stream>>>(A, B, Na, Nb, gram, T, nu, radius, mask, out);
  return (int)cudaGetLastError();
}

int launch(const float* A, const float* B, int Na, int Nb, int gram, int T,
           float nu, int radius, const uint32_t* mask, float* out,
           void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int per_lane = (T + 31) / 32;
  if (T < 1) return (int)cudaErrorInvalidValue;
  if (per_lane <= 1)
    return launch_c<1>(A, B, Na, Nb, gram, T, nu, radius, mask, out, st);
  if (per_lane <= 2)
    return launch_c<2>(A, B, Na, Nb, gram, T, nu, radius, mask, out, st);
  if (per_lane <= 4)
    return launch_c<4>(A, B, Na, Nb, gram, T, nu, radius, mask, out, st);
  if (per_lane <= 8)
    return launch_c<8>(A, B, Na, Nb, gram, T, nu, radius, mask, out, st);
  if (per_lane <= 16)
    return launch_c<16>(A, B, Na, Nb, gram, T, nu, radius, mask, out, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// (Na, Nb) log-kernel Gram. mask: (2T-1) x ceil(T/32) words, or null;
// radius < 0: no corridor.
int krdtw_gram(const float* A, const float* B, int Na, int Nb, int T,
               float nu, int radius, const uint32_t* mask, float* out,
               void* stream) {
  return launch(A, B, Na, Nb, 1, T, nu, radius, mask, out, stream);
}

// (P,) aligned pairs: X, Y (P, T); Nb must equal P.
int krdtw_paired(const float* X, const float* Y, int P, int Nb, int T,
                 float nu, int radius, const uint32_t* mask, float* out,
                 void* stream) {
  return launch(X, Y, P, Nb, 0, T, nu, radius, mask, out, stream);
}

}  // extern "C"
