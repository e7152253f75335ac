// 3x3x3 convolution, stride 1, zero padding 1, channels-last, as an
// implicit GEMM for Hopper (sm_90a).
//
// Replaces brats21_tpu/ops/pallas/conv3d_kernel.py:_conv3x3x3_pallas.
//
//   out[m, n] = bias[n] + sum_k A[m, k] * Wt[k, n]
//   m = voxel (b, d, h, w), M = B*D*H*W;  n = output channel, N = Cout;
//   k = tap*Cin + ci with tap = (kd*3 + kh)*3 + kw, K = 27*Cin;
//   A[m, k] = x[b, d+kd-1, h+kh-1, w+kw-1, ci], 0 in the halo.
//
// x is [B, D, H, W, Cin] and w is [3, 3, 3, Cin, Cout] (= [K, N] row-major),
// both contiguous; bias is fp32 [Cout]; out is [B, D, H, W, Cout] in the
// input type. Accumulation is fp32.
//
// Bound on the H100: at the model's widths the work is 2*M*N*K operations
// over (M*Cin + M*Cout)*2 bytes, i.e. ~27*Cin*Cout/(Cin+Cout) >= 600
// operations per byte, far above the card's ~295 bf16 ops/byte ridge: the
// tensor cores bound it. The design keeps im2col out of device memory (it
// would be 27x the activation bytes): each block gathers its A tile
// [128 voxels x 32 k] on the fly into shared memory, zero-filling the halo,
// stages the weight tile [32 k x BN] beside it, and runs bf16 WMMA 16x16x16
// fragments with fp32 accumulators over 8 warps. The bias is added in the
// fp32 epilogue before the one rounding to the output type.
//
// Two kernels, chosen by dtype:
// - conv3x3x3_bf16_pipe (bf16; C_in and C_out multiples of 8, which the
//   Python wrapper ensures by zero-padding the model's 4-channel stem and
//   any other ragged shape): both tiles are copied by cp.async, 16 bytes a
//   thread, through a ring of 4 chunks, the halo and the ragged edges
//   zero-filled by the copy; BN = 128 output channels where C_out > 64, so
//   the A tile is gathered once per 128 channels, else 64.
// - conv3x3x3_f32_fma (fp32, the --no_amp flag, any shape): plain FMA tiles.
// wgmma, TMA and a persistent schedule are left for later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

struct Geom {
  int B, D, H, W, Cin, Cout;
  long long M;  // B*D*H*W output voxels
  int K;        // 27*Cin
};

// Output voxel m split into (d, h, w); base is the element offset of
// x[b, d, h, w, 0]. Rows past M are marked invalid and load zeros.
struct Voxel {
  int d, h, w;
  long long base;
  bool valid;
};

__device__ __forceinline__ Voxel voxel_of(const Geom& g, long long m) {
  Voxel v;
  v.valid = m < g.M;
  long long mm = v.valid ? m : 0;
  v.w = (int)(mm % g.W);
  long long t = mm / g.W;
  v.h = (int)(t % g.H);
  t /= g.H;
  v.d = (int)(t % g.D);
  v.base = mm * g.Cin;
  return v;
}

// Element offset of the tap's input voxel relative to v.base; false in the
// zero halo.
__device__ __forceinline__ bool tap_offset(const Geom& g, const Voxel& v,
                                           int tap, long long* off) {
  const int kd = tap / 9, kh = (tap / 3) % 3, kw = tap % 3;
  const int dd = v.d + kd - 1, hh = v.h + kh - 1, ww = v.w + kw - 1;
  if (!v.valid || dd < 0 || dd >= g.D || hh < 0 || hh >= g.H || ww < 0 ||
      ww >= g.W)
    return false;
  *off = ((long long)((kd - 1) * g.H + (kh - 1)) * g.W + (kw - 1)) * g.Cin;
  return true;
}

__device__ __forceinline__ unsigned pack2(unsigned short lo, unsigned short hi) {
  return (unsigned)lo | ((unsigned)hi << 16);
}

// ---------------------------------------------------------------------------
// bf16, C_in and C_out multiples of 8: cp.async multistage implicit GEMM
// ---------------------------------------------------------------------------
//
// Every 8-k group of an A row is 16 contiguous, aligned bytes of one input
// voxel (or the zero halo), and every 8-n group of a weight row likewise,
// so both tiles are copied global -> shared by cp.async, 16 bytes a thread,
// with the halo and the ragged edges zero-filled by the copy itself.
// STAGES chunks are in flight while the tensor cores work on the oldest.

constexpr int BM = 128;         // output voxels per block
constexpr int THREADS = 256;    // 8 warps
constexpr int PBK = 32;         // k per chunk
constexpr int STAGES = 4;       // chunks in the ring
constexpr int PA_LD = PBK + 8;  // bf16 elements of an A row in shared memory

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = pred ? 16 : 0;  // 0 source bytes: 16 zero bytes land
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// BN output channels per block; each of the 8 warps owns WM x WN fragments
// of 16 x 16, the warps tiling BM x BN as (BM / 16 / WM) x (BN / 16 / WN).
template <int BN, int WM, int WN>
struct Tiles {
  static constexpr int B_LD = BN + 8;
  static constexpr int C_LD = BN + 4;
  static constexpr int A_STAGE = BM * PA_LD * 2;
  static constexpr int B_STAGE = PBK * B_LD * 2;
  static constexpr int PIPE = STAGES * (A_STAGE + B_STAGE);
  static constexpr int EPI = BM * C_LD * 4;
  static constexpr int SMEM = PIPE > EPI ? PIPE : EPI;
  static constexpr int WARPS_N = BN / (16 * WN);
  static constexpr int A_VECS = BM * PBK / 8 / THREADS;  // per thread per chunk
  static constexpr int A_ROW_STEP = THREADS / (PBK / 8);
  static_assert((BM / (16 * WM)) * WARPS_N * 32 == THREADS, "8 warps");
};

template <int BN, int WM, int WN>
__global__ void __launch_bounds__(THREADS, 2)
conv3x3x3_bf16_pipe(const unsigned short* __restrict__ x,
                    const unsigned short* __restrict__ w,
                    const float* __restrict__ bias,
                    unsigned short* __restrict__ out, Geom g) {
  using T = Tiles<BN, WM, WN>;
  extern __shared__ __align__(128) unsigned char smem[];
  auto As = [&](int s) {
    return reinterpret_cast<unsigned short*>(smem + s * T::A_STAGE);
  };
  auto Bs = [&](int s) {
    return reinterpret_cast<unsigned short*>(smem + STAGES * T::A_STAGE +
                                             s * T::B_STAGE);
  };

  const int tid = threadIdx.x;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  // A: rows tid/(PBK/8) + i*A_ROW_STEP, k offset (tid%(PBK/8))*8 within the
  // chunk; the (tap, ci) of that k advances by PBK per chunk
  const int a_row = tid / (PBK / 8), a_kv = (tid % (PBK / 8)) * 8;
  Voxel va[T::A_VECS];
#pragma unroll
  for (int i = 0; i < T::A_VECS; ++i)
    va[i] = voxel_of(g, m0 + a_row + i * T::A_ROW_STEP);
  int a_tap = a_kv / g.Cin, a_ci = a_kv - a_tap * g.Cin;

  auto load_chunk = [&](int chunk, int stage) {
    // A tile [BM x PBK]
#pragma unroll
    for (int i = 0; i < T::A_VECS; ++i) {
      long long off;
      const bool in = a_tap < 27 && tap_offset(g, va[i], a_tap, &off);
      const unsigned short* src = in ? x + va[i].base + off + a_ci : x;
      cp_async16(As(stage) + (a_row + i * T::A_ROW_STEP) * PA_LD + a_kv, src, in);
    }
    // B tile [PBK x BN]
#pragma unroll
    for (int i = 0; i < PBK * BN / 8 / THREADS; ++i) {
      const int v = tid + i * THREADS;
      const int row = v / (BN / 8), col = (v % (BN / 8)) * 8;
      const int k = chunk * PBK + row, n = n0 + col;
      const bool in = k < g.K && n < g.Cout;
      const unsigned short* src = in ? w + (long long)k * g.Cout + n : w;
      cp_async16(Bs(stage) + row * T::B_LD + col, src, in);
    }
    // the next chunk's (tap, ci) for this thread's A vectors
    a_ci += PBK;
    while (a_ci >= g.Cin) {
      a_ci -= g.Cin;
      ++a_tap;
    }
  };

  const int warp = tid >> 5;
  const int wm = (warp / T::WARPS_N) * (16 * WM);
  const int wn = (warp % T::WARPS_N) * (16 * WN);
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[WM][WN];
#pragma unroll
  for (int i = 0; i < WM; ++i)
#pragma unroll
    for (int j = 0; j < WN; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  const int nk = (g.K + PBK - 1) / PBK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load_chunk(s, s);
    cp_async_commit();
  }

  for (int c = 0; c < nk; ++c) {
    // chunk c has landed, and every warp is done with chunk c - 1, whose
    // stage the prefetch below refills
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int pre = c + STAGES - 1;
    if (pre < nk) load_chunk(pre, pre % STAGES);
    cp_async_commit();

    const __nv_bfloat16* a =
        reinterpret_cast<const __nv_bfloat16*>(As(c % STAGES));
    const __nv_bfloat16* b =
        reinterpret_cast<const __nv_bfloat16*>(Bs(c % STAGES));
#pragma unroll
    for (int ks = 0; ks < PBK; ks += 16) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> bf[WN];
#pragma unroll
      for (int j = 0; j < WN; ++j)
        wmma::load_matrix_sync(bf[j], b + ks * T::B_LD + wn + j * 16, T::B_LD);
#pragma unroll
      for (int i = 0; i < WM; ++i) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> af;
        wmma::load_matrix_sync(af, a + (wm + i * 16) * PA_LD + ks, PA_LD);
#pragma unroll
        for (int j = 0; j < WN; ++j) wmma::mma_sync(acc[i][j], af, bf[j], acc[i][j]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // epilogue: fp32 tile through shared memory, + bias, one rounding to
  // bf16, 16-byte stores along C_out (C_out is a multiple of 8)
  float* Cs = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int i = 0; i < WM; ++i)
#pragma unroll
    for (int j = 0; j < WN; ++j)
      wmma::store_matrix_sync(Cs + (wm + i * 16) * T::C_LD + wn + j * 16,
                              acc[i][j], T::C_LD, wmma::mem_row_major);
  __syncthreads();
#pragma unroll
  for (int r = 0; r < BM * BN / 8 / THREADS; ++r) {
    const int item = tid + r * THREADS;
    const int row = item / (BN / 8), col = (item % (BN / 8)) * 8;
    const long long m = m0 + row;
    const int n = n0 + col;
    if (m >= g.M || n >= g.Cout) continue;
    unsigned short e[8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      e[j] = __bfloat16_as_ushort(
          __float2bfloat16(Cs[row * T::C_LD + col + j] + bias[n + j]));
    uint4 v;
    v.x = pack2(e[0], e[1]);
    v.y = pack2(e[2], e[3]);
    v.z = pack2(e[4], e[5]);
    v.w = pack2(e[6], e[7]);
    *reinterpret_cast<uint4*>(out + m * g.Cout + n) = v;
  }
}

template <int BN, int WM, int WN>
cudaError_t launch_pipe(const void* x, const void* w, const void* bias,
                        void* out, const Geom& g, cudaStream_t s) {
  using T = Tiles<BN, WM, WN>;
  auto kernel = conv3x3x3_bf16_pipe<BN, WM, WN>;
  // above 48 KB of shared memory only by request (per device, so per call)
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (e != cudaSuccess) return e;
  dim3 grid((unsigned)((g.M + BM - 1) / BM), (unsigned)((g.Cout + BN - 1) / BN));
  kernel<<<grid, THREADS, T::SMEM, s>>>(
      static_cast<const unsigned short*>(x),
      static_cast<const unsigned short*>(w), static_cast<const float*>(bias),
      static_cast<unsigned short*>(out), g);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// fp32: FMA tiles (64 voxels x 64 channels, 4x4 per thread)
// ---------------------------------------------------------------------------

constexpr int FM = 64, FN = 64, FK = 16;

__global__ void __launch_bounds__(THREADS)
conv3x3x3_f32_fma(const float* __restrict__ x, const float* __restrict__ w,
                  const float* __restrict__ bias, float* __restrict__ out,
                  Geom g) {
  __shared__ float As[FK][FM + 4];
  __shared__ float Bs[FK][FN + 4];

  const int tid = threadIdx.x;
  const long long m0 = (long long)blockIdx.x * FM;
  const int n0 = blockIdx.y * FN;

  // A loads: k column tid%16, rows tid/16 + 16*r
  const int a_k = tid & 15, a_row = tid >> 4;
  Voxel va[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) va[r] = voxel_of(g, m0 + a_row + 16 * r);
  // B loads: n column tid%64, k rows tid/64 + 4*r
  const int b_n = tid & 63, b_k = tid >> 6;

  const int tx = tid & 15, ty = tid >> 4;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < g.K; k0 += FK) {
    const int k = k0 + a_k;
    const bool k_ok = k < g.K;
    const int tap = k_ok ? k / g.Cin : 0, ci = k_ok ? k - tap * g.Cin : 0;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      long long off;
      float v = 0.0f;
      if (k_ok && tap_offset(g, va[r], tap, &off)) v = x[va[r].base + off + ci];
      As[a_k][a_row + 16 * r] = v;
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int kb = k0 + b_k + 4 * r, n = n0 + b_n;
      Bs[b_k + 4 * r][b_n] =
          (kb < g.K && n < g.Cout) ? w[(long long)kb * g.Cout + n] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < FK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long m = m0 + ty * 4 + i;
    if (m >= g.M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < g.Cout) out[m * g.Cout + n] = acc[i][j] + bias[n];
    }
  }
}

}  // namespace

// dtype: 0 = fp32, 1 = bf16 (C_in and C_out multiples of 8). Launches on `stream` and returns
// cudaGetLastError() (0 = success) without synchronising.
extern "C" int brats_conv3x3x3(const void* x, const void* w, const void* bias,
                               void* out, int B, int D, int H, int W, int Cin,
                               int Cout, int dtype, void* stream) {
  Geom g;
  g.B = B; g.D = D; g.H = H; g.W = W; g.Cin = Cin; g.Cout = Cout;
  g.M = (long long)B * D * H * W;
  g.K = 27 * Cin;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (g.M == 0 || Cout == 0) return 0;
  if (dtype == 1) {
    if (Cin % 8 != 0 || Cout % 8 != 0) return (int)cudaErrorInvalidValue;
    // one 128-wide tile of C_out where it fits, so the A tile is gathered
    // once per 128 channels; 64 for the 48-channel level
    if (Cout > 64) return (int)launch_pipe<128, 4, 2>(x, w, bias, out, g, s);
    return (int)launch_pipe<64, 2, 2>(x, w, bias, out, g, s);
  }
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)((g.M + FM - 1) / FM), (unsigned)((Cout + FN - 1) / FN));
  conv3x3x3_f32_fma<<<grid, THREADS, 0, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const float*>(bias), static_cast<float*>(out), g);
  return (int)cudaGetLastError();
}

extern "C" const char* brats_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
