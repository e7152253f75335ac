// EvoNorm-S0 forward for Hopper (sm_90a): two kernels enqueued by one call.
//
// Replaces brats21_tpu/ops/pallas/evonorm_kernel.py:evonorm_s0_pallas
// (apply body _apply_kernel :45; the group statistics _group_inv_std :32).
// For each (sample b, group g), G = min(groups, C) groups of CG = C / G
// channels, the unbiased variance over the spatial rows x CG channels
// (divisor n - 1) gives inv = rsqrt(var + eps); then
// out = x * sigmoid(x) * inv * gamma + beta, in fp32, rounded once to x's
// type.
//
// Bound on the H100: a few operations per element against 2 bytes read and
// 2 written in bf16, so device memory bounds it. Both kernels must read x
// (at the largest level x is ten times the 50 MB L2), so the best this
// design reaches is 4 of the 6 bytes an element it moves.
//
// A block is THREADS threads; each owns a fixed vector of VEC channels
// (16 bytes where C allows it) of one row lane: thread t covers channels
// (t % TPR) * VEC + [0, VEC) of rows lane t / TPR, lanes 0 .. RPI - 1, with
// TPR = C / VEC threads a row and RPI = THREADS / TPR rows an iteration. A
// grid (P, B) strides over each sample's S rows, P blocks a sample; the
// statistics from the last row back, the apply pass from the first on, so
// each starts where the kernel before it left rows in L2.
//
// evonorm_stats: each thread keeps Welford (n, mean, M2) in fp32 for its
// channels over its rows; the block merges them per group (Chan's formula,
// one warp a group, shuffles) and writes one partial (n, mean, M2) per
// (block, group). The last block of a sample to finish (atomic ticket
// after a __threadfence) merges the sample's P partials per group in fp64
// (n reaches 3.3e7 per group at the served level 1), all its threads over
// the partials in two passes (the mean, then M2), writes inv[b, g] and
// resets its ticket to 0 for the next call.
// evonorm_apply: 16-byte loads and stores, gamma, beta and the sample's
// inv loaded once per thread for its channels, rows from the last.
// Each thread keeps several rows' loads in flight in both kernels.
//
// A volume sharded over ranks needs the group statistics of every slab
// before the apply, so two more entry points split the call:
// brats_evonorm_s0_stats launches the statistics kernel alone, whose last
// block writes the sample's (n, mean, M2) per group in fp64 instead of inv;
// the caller merges the ranks' triples into inv; brats_evonorm_s0_apply
// launches the apply kernel alone on that inv.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int UNROLL = 4;        // rows a thread of the apply kernel has in flight
constexpr int STATS_UNROLL = 6;  // and of the statistics kernel (85 registers, 3 blocks an SM)
constexpr int MAX_GROUPS = 64;

struct Plan {
  long long S;  // rows (spatial voxels) per sample
  int C, G, CG;
  int TPR, RPI;  // threads per row, rows per block iteration
  float eps;
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(__half v) { return __half2float(v); }
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ __half from_f<__half>(float v) { return __float2half_rn(v); }

__device__ __forceinline__ float rcp_approx(float v) {  // 1/inf = 0
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Vec {
  T e[VEC];
};

// (na, ma, Ma) <- merge with (nb, mb, Mb), Chan et al.
__device__ __forceinline__ void chan_merge(float& na, float& ma, float& Ma, float nb, float mb,
                                           float Mb) {
  if (nb == 0.0f) return;
  const float n = na + nb, d = mb - ma, f = nb / n;
  ma += d * f;
  Ma += Mb + d * d * na * f;
  na = n;
}

__device__ __forceinline__ void warp_merge(float& n, float& m, float& M2) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float nb = __shfl_down_sync(0xffffffffu, n, off);
    const float mb = __shfl_down_sync(0xffffffffu, m, off);
    const float Mb = __shfl_down_sync(0xffffffffu, M2, off);
    chan_merge(n, m, M2, nb, mb, Mb);
  }
}

// part: [B, P, G, 3] (n, mean, M2); inv: [B, G]; tickets: [B], zero;
// stats: null, or [B, G, 3] fp64 (n, mean, M2), written instead of inv.
// three blocks an SM with six rows in flight a thread: measured faster than
// four blocks with four rows (64 registers) and than eight rows, which spill
template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS, 3)
evonorm_stats(const T* __restrict__ x, float* __restrict__ part, float* __restrict__ inv,
              double* __restrict__ stats, unsigned* __restrict__ tickets, Plan p) {
  __shared__ float s_mean[THREADS * VEC];  // [row lane][channel]
  __shared__ float s_m2[THREADS * VEC];
  __shared__ float s_n[THREADS];           // rows seen by each row lane
  __shared__ double s_red[2][THREADS];
  __shared__ double s_mu[MAX_GROUPS], s_cnt[MAX_GROUPS];
  __shared__ bool s_last;
  const int t = threadIdx.x, lr = t / p.TPR, v = t % p.TPR;
  const int b = blockIdx.y;
  float n = 0.0f, mean[VEC], m2[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) mean[i] = m2[i] = 0.0f;
  auto welford = [&](const Vec<T, VEC>& in) {
    n += 1.0f;
    const float rn = __frcp_rn(n);
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const float xv = to_f(in.e[i]), d = xv - mean[i];
      mean[i] += d * rn;
      m2[i] += d * (xv - mean[i]);
    }
  };
  if (lr < p.RPI) {
    // rows from the end of the sample: the kernel before wrote those last,
    // so the first reads here find them in L2
    const T* xs = x + ((size_t)b * p.S + p.S - 1) * p.C + v * VEC;
    const long long step = (long long)gridDim.x * p.RPI;
    long long r = (long long)blockIdx.x * p.RPI + lr;
    for (; r + (STATS_UNROLL - 1) * step < p.S; r += STATS_UNROLL * step) {
      Vec<T, VEC> in[STATS_UNROLL];
#pragma unroll
      for (int u = 0; u < STATS_UNROLL; ++u)
        in[u] = *reinterpret_cast<const Vec<T, VEC>*>(xs - (r + u * step) * p.C);
#pragma unroll
      for (int u = 0; u < STATS_UNROLL; ++u) welford(in[u]);
    }
    for (; r < p.S; r += step) welford(*reinterpret_cast<const Vec<T, VEC>*>(xs - r * p.C));
  }
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    s_mean[t * VEC + i] = mean[i];
    s_m2[t * VEC + i] = m2[i];
  }
  if (v == 0) s_n[lr] = n;
  __syncthreads();

  // one warp a group: its RPI x CG (row lane, channel) entries
  const int warp = t / 32, lane = t % 32;
  for (int g = warp; g < p.G; g += WARPS) {
    float gn = 0.0f, gm = 0.0f, gM = 0.0f;
    for (int e = lane; e < p.RPI * p.CG; e += 32) {
      const int r = e / p.CG, k = r * p.C + g * p.CG + e % p.CG;
      chan_merge(gn, gm, gM, s_n[r], s_mean[k], s_m2[k]);
    }
    warp_merge(gn, gm, gM);
    if (lane == 0) {
      float* o = part + (((size_t)b * gridDim.x + blockIdx.x) * p.G + g) * 3;
      o[0] = gn;
      o[1] = gm;
      o[2] = gM;
    }
  }

  // the last block of the sample merges every block's partials
  __threadfence();
  __syncthreads();
  if (t == 0) s_last = atomicAdd(&tickets[b], 1u) == gridDim.x - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  // fp64, two sweeps over the sample's P x G partials with the whole block:
  // the group means, then M2 = sum M2_p + sum n_p (mean_p - mean)^2. Thread
  // t keeps group t % G and partials q = t / G + k * per (per = THREADS / G
  // threads a group), so neighbours read neighbouring partials.
  const int P = gridDim.x, per = THREADS / p.G, mine = t % p.G;
  const bool on = t < per * p.G;
  const float* ps = part + ((size_t)b * P * p.G + mine) * 3;
  for (int sweep = 0; sweep < 2; ++sweep) {
    double a0 = 0.0, a1 = 0.0;
    const double mu = sweep ? s_mu[mine] : 0.0;
    int q = on ? t / p.G : P;
    for (; q + (UNROLL - 1) * per < P; q += UNROLL * per) {
      float e[UNROLL][3];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
#pragma unroll
        for (int k = 0; k < 3; ++k) e[u][k] = __ldcg(ps + (size_t)(q + u * per) * p.G * 3 + k);
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const double d = e[u][1] - mu;
        a0 += sweep ? e[u][2] + e[u][0] * d * d : e[u][0];
        a1 += sweep ? 0.0 : (double)e[u][0] * e[u][1];
      }
    }
    for (; q < P; q += per) {
      const float* o = ps + (size_t)q * p.G * 3;
      const double d = __ldcg(o + 1) - mu;
      a0 += sweep ? __ldcg(o + 2) + __ldcg(o) * d * d : __ldcg(o);
      a1 += sweep ? 0.0 : (double)__ldcg(o) * __ldcg(o + 1);
    }
    s_red[0][t] = a0;
    s_red[1][t] = a1;
    __syncthreads();
    // one warp a group sums its per threads
    for (int g = warp; g < p.G; g += WARPS) {
      double r0 = 0.0, r1 = 0.0;
      for (int k = lane; k < per; k += 32) {
        r0 += s_red[0][k * p.G + g];
        r1 += s_red[1][k * p.G + g];
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        r0 += __shfl_down_sync(0xffffffffu, r0, off);
        r1 += __shfl_down_sync(0xffffffffu, r1, off);
      }
      if (lane == 0 && sweep == 0) {
        s_cnt[g] = r0;
        s_mu[g] = r1 / (r0 > 0.0 ? r0 : 1.0);
      }
      if (lane == 0 && sweep == 1 && stats != nullptr) {
        double* o = stats + ((size_t)b * p.G + g) * 3;
        o[0] = s_cnt[g];
        o[1] = s_mu[g];
        o[2] = r0;
      } else if (lane == 0 && sweep == 1) {
        const double var = r0 / (s_cnt[g] - 1.0 > 1.0 ? s_cnt[g] - 1.0 : 1.0);
        inv[b * p.G + g] = (float)(1.0 / sqrt(var + (double)p.eps));
      }
    }
    __syncthreads();
  }
  if (t == 0) tickets[b] = 0;
}

template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS)
evonorm_apply(const T* __restrict__ x, T* __restrict__ y, const float* __restrict__ gamma,
              const float* __restrict__ beta, const float* __restrict__ inv, Plan p) {
  const int t = threadIdx.x, lr = t / p.TPR, v = t % p.TPR;
  if (lr >= p.RPI) return;
  const int b = blockIdx.y;
  float ga[VEC], be[VEC], iv[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    const int c = v * VEC + i;
    ga[i] = gamma[c];
    be[i] = beta[c];
    iv[i] = inv[b * p.G + c / p.CG];
  }
  // rows from the start of the sample: the statistics pass read those
  // last, so the first reads here find them in L2
  const T* xs = x + (size_t)b * p.S * p.C + v * VEC;
  T* ys = y + (size_t)b * p.S * p.C + v * VEC;
  auto apply = [&](const Vec<T, VEC>& in) {
    Vec<T, VEC> out;
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      // the plain version's order, unfused: ((x * sigmoid(x)) * inv) * gamma + beta;
      // sigmoid by the fast exp and reciprocal (a few ulp, far inside one bf16
      // ulp and 1e-5 in fp32): the IEEE ones cost the SM more issue slots than
      // the memory leaves it
      const float xv = to_f(in.e[i]);
      const float sig = rcp_approx(__fadd_rn(1.0f, __expf(-xv)));
      const float o = __fadd_rn(__fmul_rn(__fmul_rn(__fmul_rn(xv, sig), iv[i]), ga[i]), be[i]);
      out.e[i] = from_f<T>(o);
    }
    return out;
  };
  const long long step = (long long)gridDim.x * p.RPI;
  long long r = (long long)blockIdx.x * p.RPI + lr;
  for (; r + (UNROLL - 1) * step < p.S; r += UNROLL * step) {
    Vec<T, VEC> in[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      in[u] = *reinterpret_cast<const Vec<T, VEC>*>(xs + (r + u * step) * p.C);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      *reinterpret_cast<Vec<T, VEC>*>(ys + (r + u * step) * p.C) = apply(in[u]);
  }
  for (; r < p.S; r += step)
    *reinterpret_cast<Vec<T, VEC>*>(ys + r * p.C) =
        apply(*reinterpret_cast<const Vec<T, VEC>*>(xs + r * p.C));
}

enum Mode { kBoth = 0, kStats = 1, kApply = 2 };

struct Args {
  const void* x;
  void* y;
  const void* gamma;
  const void* beta;
  float* part;          // the statistics' partials (kBoth, kStats), then inv (kBoth)
  const float* inv;     // kApply: [B, G]
  double* stats;        // kStats: [B, G, 3]
  unsigned* tickets;
  int B, blocks, apply_blocks;
};

template <typename T, int VEC>
cudaError_t launch(Mode mode, const Args& a, const Plan& p, cudaStream_t s) {
  const float* inv = a.inv;
  if (mode != kApply) {
    float* inv_out = a.part + (size_t)a.B * a.blocks * p.G * 3;
    evonorm_stats<T, VEC><<<dim3(a.blocks, a.B), THREADS, 0, s>>>(
        static_cast<const T*>(a.x), a.part, inv_out, mode == kStats ? a.stats : nullptr,
        a.tickets, p);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess || mode == kStats) return e;
    inv = inv_out;
  }
  evonorm_apply<T, VEC><<<dim3(a.apply_blocks, a.B), THREADS, 0, s>>>(
      static_cast<const T*>(a.x), static_cast<T*>(a.y), static_cast<const float*>(a.gamma),
      static_cast<const float*>(a.beta), inv, p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int vec, Mode mode, const Args& a, const Plan& p, cudaStream_t s) {
  switch (vec) {
    case 1: return launch<T, 1>(mode, a, p, s);
    case 2: return launch<T, 2>(mode, a, p, s);
    case 4: return launch<T, 4>(mode, a, p, s);
    case 8:
      if constexpr (sizeof(T) == 2) return launch<T, 8>(mode, a, p, s);
  }
  return cudaErrorInvalidValue;
}

// checks the arguments, fills the plan and launches on `device`, leaving
// the caller's current device as it was
int run(Mode mode, const Args& a, long long S, int C, int groups, int dtype, int vec, float eps,
        int device, void* stream) {
  if (a.B <= 0 || S <= 0 || C <= 0) return 0;
  const int G = groups < C ? groups : C;
  if (vec < 1 || C % vec != 0 || C / vec > THREADS || C % G != 0 || G > MAX_GROUPS ||
      a.blocks < 1 || a.apply_blocks < 1 || a.B > 65535)
    return (int)cudaErrorInvalidValue;
  Plan p;
  p.S = S;
  p.C = C;
  p.G = G;
  p.CG = C / G;
  p.TPR = C / vec;
  p.RPI = THREADS / p.TPR;
  p.eps = eps;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  int current;
  cudaError_t e = cudaGetDevice(&current);
  if (e == cudaSuccess && current != device) e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (dtype == 0)
    e = dispatch<float>(vec, mode, a, p, s);
  else if (dtype == 1)
    e = dispatch<__nv_bfloat16>(vec, mode, a, p, s);
  else if (dtype == 2)
    e = dispatch<__half>(vec, mode, a, p, s);
  else e = cudaErrorInvalidValue;
  if (current != device) cudaSetDevice(current);
  return (int)e;
}

}  // namespace

// x, y [B, S, C] contiguous (y written), dtype 0 = fp32, 1 = bf16, 2 = fp16;
// gamma, beta fp32 [C]; part fp32 [B * blocks * G * 3 + B * G] (partials,
// then inv); tickets uint32 [>= B], zero, left zero. vec channels a thread
// (C % vec == 0, C / vec <= 256, x and y aligned to vec elements); blocks
// and apply_blocks per sample for the two kernels. Enqueues the statistics and the apply kernel on `stream` of
// `device` and returns cudaGetLastError() (0 = success) without
// synchronising.
extern "C" int brats_evonorm_s0(const void* x, void* y, const void* gamma, const void* beta,
                                void* part, void* tickets, int B, long long S, int C,
                                int groups, int dtype, int vec, int blocks, int apply_blocks,
                                float eps, int device, void* stream) {
  const Args a{x, y, gamma, beta, static_cast<float*>(part), nullptr, nullptr,
               static_cast<unsigned*>(tickets), B, blocks, apply_blocks};
  return run(kBoth, a, S, C, groups, dtype, vec, eps, device, stream);
}

// The statistics kernel alone: stats fp64 [B, G, 3] (n, mean, M2 of each
// sample's groups) written; part fp32 [B * blocks * G * 3] scratch; tickets
// as above. Same layout rules as brats_evonorm_s0.
extern "C" int brats_evonorm_s0_stats(const void* x, void* part, void* stats, void* tickets,
                                      int B, long long S, int C, int groups, int dtype,
                                      int vec, int blocks, int device, void* stream) {
  const Args a{x, nullptr, nullptr, nullptr, static_cast<float*>(part), nullptr,
               static_cast<double*>(stats), static_cast<unsigned*>(tickets), B, blocks, 1};
  return run(kStats, a, S, C, groups, dtype, vec, 0.0f, device, stream);
}

// The apply kernel alone: y = x * sigmoid(x) * inv * gamma + beta with inv
// fp32 [B, G] given. Same layout rules as brats_evonorm_s0.
extern "C" int brats_evonorm_s0_apply(const void* x, void* y, const void* gamma,
                                      const void* beta, const void* inv, int B, long long S,
                                      int C, int groups, int dtype, int vec, int apply_blocks,
                                      int device, void* stream) {
  const Args a{x, y, gamma, beta, nullptr, static_cast<const float*>(inv), nullptr, nullptr,
               B, 1, apply_blocks};
  return run(kApply, a, S, C, groups, dtype, vec, 0.0f, device, stream);
}

extern "C" const char* brats_evonorm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
