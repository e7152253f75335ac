// Min-plus lower envelope of the exact Euclidean distance transform, along
// one axis of a contiguous fp32 tensor, for Hopper (sm_90a).
//
// Replaces brats21_tpu/ops/pallas/edt_kernel.py:envelope_last_axis (body
// _envelope_kernel :28).
//
//   out[o, i, r] = min(1e12, min_j g[o, j, r] + ((i - j) * s)^2)
//
// over the tensor viewed as [outer, n, inner]: the envelope runs along n,
// whose stride is inner, so every axis of a volume is served in place; the
// TPU version moves each axis last first (three transposes per EDT).
// A line is the n elements of one (o, r); there are outer * inner lines.
//
// Each candidate is computed as the JAX package computes it, (i - j) as an
// fp32 difference, times s, squared, added to g[j], each step rounded on
// its own (the _rn intrinsics forbid the compiler's fused multiply-add), so
// the result equals the plain PyTorch version bit for bit. The accumulator
// starts at the package's 1e12 sentinel, as _envelope_1d's does.
//
// Bound on the H100: n candidates of 4 operations (multiply, square, add,
// min; with the subtraction, 5 instructions) per output against 8 bytes
// moved per element, i.e. n/2 operations per byte, far above the card's
// fp32 ridge (67 TFLOP/s over 3.35 TB/s, 20 per byte) at the BraTS line
// lengths (128 to 240): fp32 arithmetic bounds it. The design keeps the O(n^2) scan in shared memory: a block
// stages 32 lines as a [n][33] tile (one lane per line, padded against
// bank conflicts), read with coalesced loads along whichever axis is
// contiguous (the lines themselves when inner == 1, the 32 lanes
// otherwise); each of its 8 warps takes output rows i, four at a time per
// thread so one shared load of g[j] feeds four candidates; the outputs go
// through a second tile so the store is coalesced the same way. The O(n)
// Felzenszwalb envelope is left for later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 32;            // lines per block
constexpr int kPitch = kLanes + 1;    // shared tile row, padded
constexpr int kRows = 8;              // warps per block
constexpr int kUnroll = 4;            // output rows per thread per scan
constexpr float kInf = 1e12f;         // the JAX package's _INF

// Element offset of g[line, j] for a tile of consecutive lines.
__device__ __forceinline__ long long elem(long long line, int j, int n,
                                          long long inner) {
  const long long o = line / inner, r = line - o * inner;
  return (o * n + j) * inner + r;
}

__global__ void __launch_bounds__(kLanes * kRows)
    edt_envelope_kernel(const float* __restrict__ g, float* __restrict__ out,
                        long long lines, int n, long long inner, float s) {
  extern __shared__ float smem[];
  float* tile_in = smem;               // [n][kPitch]
  float* tile_out = smem + n * kPitch; // [n][kPitch]
  const long long line0 = (long long)blockIdx.x * kLanes;
  const int tid = threadIdx.x;
  const int total = n * kLanes;

  // stage the 32 lines; t walks the tile in the order memory is contiguous
  for (int t = tid; t < total; t += blockDim.x) {
    int lane, j;
    if (inner == 1) { lane = t / n; j = t - lane * n; }
    else { j = t / kLanes; lane = t - j * kLanes; }
    const long long line = line0 + lane;
    tile_in[j * kPitch + lane] = line < lines ? g[elem(line, j, n, inner)] : kInf;
  }
  __syncthreads();

  const int lane = tid & (kLanes - 1);
  const int row = tid / kLanes;
  for (int i0 = row; i0 < n; i0 += kRows * kUnroll) {
    float acc[kUnroll], fi[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      acc[u] = kInf;
      fi[u] = (float)(i0 + u * kRows);
    }
    for (int j = 0; j < n; ++j) {
      const float gj = tile_in[j * kPitch + lane];
      const float fj = (float)j;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const float d = __fmul_rn(__fsub_rn(fi[u], fj), s);
        acc[u] = fminf(acc[u], __fadd_rn(gj, __fmul_rn(d, d)));
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = i0 + u * kRows;
      if (i < n) tile_out[i * kPitch + lane] = acc[u];
    }
  }
  __syncthreads();

  for (int t = tid; t < total; t += blockDim.x) {
    int ln, j;
    if (inner == 1) { ln = t / n; j = t - ln * n; }
    else { j = t / kLanes; ln = t - j * kLanes; }
    const long long line = line0 + ln;
    if (line < lines) out[elem(line, j, n, inner)] = tile_out[j * kPitch + ln];
  }
}

}  // namespace

// Shared memory a launch needs for lines of length n.
extern "C" int brats_edt_smem_bytes(int n) {
  return 2 * n * kPitch * (int)sizeof(float);
}

// out = envelope of g along the middle axis of [outer, n, inner]; both
// contiguous fp32 on the current device, out not aliasing g. Launches on
// `stream` and returns cudaGetLastError() (0 = success) without
// synchronising.
extern "C" int brats_edt_envelope(const void* g, void* out, long long outer,
                                  int n, long long inner, float sampling,
                                  void* stream) {
  const long long lines = outer * inner;
  if (lines == 0 || n == 0) return 0;
  const int smem = brats_edt_smem_bytes(n);
  cudaError_t err = cudaFuncSetAttribute(
      edt_envelope_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (lines + kLanes - 1) / kLanes;
  edt_envelope_kernel<<<(unsigned)blocks, kLanes * kRows, smem,
                        (cudaStream_t)stream>>>(
      (const float*)g, (float*)out, lines, n, inner, sampling);
  return (int)cudaGetLastError();
}

extern "C" const char* brats_edt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
