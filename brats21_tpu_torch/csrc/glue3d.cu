// Channels-last glue passes of EquiUnetASSPEvo's served forward (sm_90a).
//
// Replaces no TPU kernel: the JAX package leaves these steps to XLA, which
// fuses them into its neighbours. In eager PyTorch each step was its own
// pass, and some went through NCDHW copies: the ResidualSE gate
// x + x * s (a broadcast multiply and an add, two passes), MaxAvgPool
// (max_pool3d with an index tensor, avg_pool3d through an NCDHW copy, a
// strided concat, then a transposing copy back to channels last) and the
// decoders' trilinear x2 upsample with its skip concat. Each kernel here
// reads its inputs once and writes exactly the contiguous [B, D, H, W, C]
// tensor that the next kernel reads.
//
// Bound on the H100: a few operations per element against 2 bytes read
// and 2 written in bf16, so device memory bounds both.
//
// se_gate_pool: y = x + x * s[b, c] with PyTorch's roundings (x * s
// rounded to x's type, then the add rounded), the block's output; with a
// pooled output it also writes the next level's input [B, D/2, H/2, W/2,
// 2C]: channels [0, C) the 2^3 max of y, [C, 2C) the 2^3 mean of y,
// summed in fp32 in avg_pool3d's (d, h, w) order, divided by 8 and
// rounded once. A thread owns a vector of VEC channels (16 bytes where C
// allows it) of one output voxel and loads its 8 input vectors at once;
// neighbouring threads hold neighbouring channels, then voxels.
//
// upsample_cat: out[..., :Cs] = skip, out[..., Cs:] = the trilinear
// resize of low (align_corners=True) to skip's spatial size, with
// upsample_trilinear3d's index and weight formulas in fp32 (scale
// (in - 1) / (out - 1) computed on the host, source index scale * dst,
// truncated) and its expression tree, rounded once. A thread owns a
// vector of one output voxel: a skip vector is copied, a low vector
// interpolated from 8 neighbours that the neighbouring output voxels'
// threads read too (L1 and L2 serve those); a block's copying threads come
// first and its interpolating threads after them, so warps do not diverge.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Vec {
  T e[VEC];
};

template <typename T, int VEC>
__device__ __forceinline__ Vec<T, VEC> load(const T* p) {
  return *reinterpret_cast<const Vec<T, VEC>*>(p);
}

template <typename T, int VEC>
__device__ __forceinline__ void store(T* p, const Vec<T, VEC>& v) {
  *reinterpret_cast<Vec<T, VEC>*>(p) = v;
}

// x + x * s as PyTorch's two elementwise kernels compute it: each in fp32,
// each rounded to T
template <typename T>
__device__ __forceinline__ T gate(T xv, float sv) {
  const float xf = to_f(xv);
  const float m = to_f(from_f<T>(__fmul_rn(xf, sv)));
  return from_f<T>(__fadd_rn(xf, m));
}

// gate alone: x, y [B, S, C]; s [B, C]; thread t owns channels
// (t % TPR) * VEC + [0, VEC) of row lane t / TPR
template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS)
se_gate(const T* __restrict__ x, const T* __restrict__ s, T* __restrict__ y, long long S,
        int C, int TPR, int RPI) {
  const int t = threadIdx.x, lr = t / TPR, v = t % TPR;
  if (lr >= RPI) return;
  const int b = blockIdx.y;
  float sv[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) sv[i] = to_f(s[(size_t)b * C + v * VEC + i]);
  const T* xs = x + (size_t)b * S * C + v * VEC;
  T* ys = y + (size_t)b * S * C + v * VEC;
  const long long step = (long long)gridDim.x * RPI;
  for (long long r = (long long)blockIdx.x * RPI + lr; r < S; r += step) {
    const Vec<T, VEC> in = load<T, VEC>(xs + r * C);
    Vec<T, VEC> out;
#pragma unroll
    for (int i = 0; i < VEC; ++i) out.e[i] = gate(in.e[i], sv[i]);
    store<T, VEC>(ys + r * C, out);
  }
}

// gate and MaxAvgPool: x, y [B, D, H, W, C] (D, H, W even); pooled
// [B, D/2, H/2, W/2, 2C]; a row lane walks the output voxels
template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS)
se_gate_pool(const T* __restrict__ x, const T* __restrict__ s, T* __restrict__ y,
             T* __restrict__ pooled, int D, int H, int W, int C, int TPR, int RPI) {
  const int t = threadIdx.x, lr = t / TPR, v = t % TPR;
  if (lr >= RPI) return;
  const int b = blockIdx.y;
  const int H2 = H / 2, W2 = W / 2;
  const long long S = (long long)D * H * W, S2 = (long long)(D / 2) * H2 * W2;
  float sv[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) sv[i] = to_f(s[(size_t)b * C + v * VEC + i]);
  const T* xs = x + (size_t)b * S * C + v * VEC;
  T* ys = y + (size_t)b * S * C + v * VEC;
  T* ps = pooled + (size_t)b * S2 * 2 * C + v * VEC;
  const float neg_inf = __int_as_float(0xff800000u);
  const long long step = (long long)gridDim.x * RPI;
  for (long long o = (long long)blockIdx.x * RPI + lr; o < S2; o += step) {
    const int w2 = (int)(o % W2);
    const long long q = o / W2;
    const int h2 = (int)(q % H2), d2 = (int)(q / H2);
    // the 2^3 window in avg_pool3d's summation order: d, then h, then w
    long long row[8];
    Vec<T, VEC> in[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      row[k] = ((long long)(2 * d2 + (k >> 2)) * H + 2 * h2 + ((k >> 1) & 1)) * W + 2 * w2 +
               (k & 1);
      in[k] = load<T, VEC>(xs + row[k] * C);
    }
    float mx[VEC], sum[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      mx[i] = neg_inf;
      sum[i] = 0.0f;
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      Vec<T, VEC> out;
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        out.e[i] = gate(in[k].e[i], sv[i]);
        const float f = to_f(out.e[i]);
        if (f > mx[i] || f != f) mx[i] = f;  // max_pool3d's test: NaN wins
        sum[i] = __fadd_rn(sum[i], f);
      }
      store<T, VEC>(ys + row[k] * C, out);
    }
    Vec<T, VEC> vmax, vmean;
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      vmax.e[i] = from_f<T>(mx[i]);
      vmean.e[i] = from_f<T>(__fdiv_rn(sum[i], 8.0f));
    }
    store<T, VEC>(ps + o * 2 * C, vmax);
    store<T, VEC>(ps + o * 2 * C + C, vmean);
  }
}

struct Resize {
  int D1, H1, W1;       // low's spatial size
  float rd, rh, rw;     // (in - 1) / (out - 1) per axis, 0 where out is 1
};

// upsample_trilinear3d's source index, weight and step to the next plane
// along one axis, for output index o
__device__ __forceinline__ void source(float scale, int o, int in, int& i0, int& ip, float& l0,
                                       float& l1) {
  const float r = scale * o;
  i0 = (int)r;
  ip = (i0 < in - 1) ? 1 : 0;
  l1 = r - i0;
  l0 = 1.0f - l1;
}

// skip [B, D, H, W, Cs], low [B, D1, H1, W1, Cu], out [B, D, H, W, Cs + Cu].
// A block walks RPI output voxels at a time: its first RPI * VS threads
// copy skip's VS vectors of each, the next RPI * VU interpolate low's VU
// vectors, so that every warp but the one across the boundary takes one
// branch
template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS)
upsample_cat(const T* __restrict__ skip, const T* __restrict__ low, T* __restrict__ out,
             int D, int H, int W, int Cs, int Cu, Resize rz, int RPI) {
  const int VS = Cs / VEC, VU = Cu / VEC, Ct = Cs + Cu;
  const bool copy = (int)threadIdx.x < RPI * VS;
  const int u = copy ? threadIdx.x : threadIdx.x - RPI * VS, per = copy ? VS : VU;
  const int lr = u / per, v = u % per;
  if (lr >= RPI) return;
  const int b = blockIdx.y;
  const long long S = (long long)D * H * W, S1 = (long long)rz.D1 * rz.H1 * rz.W1;
  const long long step = (long long)gridDim.x * RPI;
  if (copy) {
    const T* ss = skip + (size_t)b * S * Cs + v * VEC;
    T* os = out + (size_t)b * S * Ct + v * VEC;
    for (long long o = (long long)blockIdx.x * RPI + lr; o < S; o += step)
      store<T, VEC>(os + o * Ct, load<T, VEC>(ss + o * Cs));
    return;
  }
  const T* ls = low + (size_t)b * S1 * Cu + v * VEC;
  T* os = out + (size_t)b * S * Ct + Cs + v * VEC;
  for (long long o = (long long)blockIdx.x * RPI + lr; o < S; o += step) {
    const int w2 = (int)(o % W);
    const long long q = o / W;
    const int h2 = (int)(q % H), t2 = (int)(q / H);
    int t1, t1p, h1, h1p, w1, w1p;
    float t0l, t1l, h0l, h1l, w0l, w1l;
    source(rz.rd, t2, rz.D1, t1, t1p, t0l, t1l);
    source(rz.rh, h2, rz.H1, h1, h1p, h0l, h1l);
    source(rz.rw, w2, rz.W1, w1, w1p, w0l, w1l);
    const long long r000 = ((long long)t1 * rz.H1 + h1) * rz.W1 + w1;
    const long long dt = (long long)t1p * rz.H1 * rz.W1, dh = (long long)h1p * rz.W1;
    Vec<T, VEC> a[8];
#pragma unroll
    for (int k = 0; k < 8; ++k)
      a[k] = load<T, VEC>(ls + (r000 + ((k >> 2) ? dt : 0) + (((k >> 1) & 1) ? dh : 0) +
                                ((k & 1) ? w1p : 0)) * Cu);
    Vec<T, VEC> res;
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      // upsample_trilinear3d_out_frame's expression, term for term, so the
      // compiler contracts it into the same fused multiply-adds
      const float val =
          t0l * (h0l * (w0l * to_f(a[0].e[i]) + w1l * to_f(a[1].e[i])) +
                 h1l * (w0l * to_f(a[2].e[i]) + w1l * to_f(a[3].e[i]))) +
          t1l * (h0l * (w0l * to_f(a[4].e[i]) + w1l * to_f(a[5].e[i])) +
                 h1l * (w0l * to_f(a[6].e[i]) + w1l * to_f(a[7].e[i])));
      res.e[i] = from_f<T>(val);
    }
    store<T, VEC>(os + o * Ct, res);
  }
}

enum Kind { kGate = 0, kGatePool = 1, kUpsampleCat = 2 };

struct Args {
  const void* a;  // x (gate), skip (upsample_cat)
  const void* b;  // s (gate), low (upsample_cat)
  void* y;        // y (gate), out (upsample_cat)
  void* pooled;   // kGatePool
  int B, D, H, W, C, Cu;
  Resize rz;
  int TPR, RPI, blocks;
};

template <typename T, int VEC>
cudaError_t launch(Kind kind, const Args& a, cudaStream_t s) {
  const dim3 grid(a.blocks, a.B);
  const T* in0 = static_cast<const T*>(a.a);
  const T* in1 = static_cast<const T*>(a.b);
  T* out = static_cast<T*>(a.y);
  if (kind == kGate)
    se_gate<T, VEC><<<grid, THREADS, 0, s>>>(in0, in1, out, (long long)a.D * a.H * a.W, a.C,
                                             a.TPR, a.RPI);
  else if (kind == kGatePool)
    se_gate_pool<T, VEC><<<grid, THREADS, 0, s>>>(in0, in1, out, static_cast<T*>(a.pooled),
                                                  a.D, a.H, a.W, a.C, a.TPR, a.RPI);
  else
    upsample_cat<T, VEC><<<grid, THREADS, 0, s>>>(in0, in1, out, a.D, a.H, a.W, a.C, a.Cu,
                                                  a.rz, a.RPI);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int vec, Kind kind, const Args& a, cudaStream_t s) {
  switch (vec) {
    case 1: return launch<T, 1>(kind, a, s);
    case 2: return launch<T, 2>(kind, a, s);
    case 4: return launch<T, 4>(kind, a, s);
    case 8:
      if constexpr (sizeof(T) == 2) return launch<T, 8>(kind, a, s);
  }
  return cudaErrorInvalidValue;
}

// checks the arguments, fills the rest of the plan and launches on
// `device`, leaving the caller's current device as it was
int run(Kind kind, Args a, int dtype, int vec, int device, void* stream) {
  if (a.B <= 0 || a.D <= 0 || a.H <= 0 || a.W <= 0) return 0;
  const int width = kind == kUpsampleCat ? a.C + a.Cu : a.C;
  if (vec < 1 || a.C <= 0 || a.C % vec || a.Cu % vec || width / vec > THREADS ||
      a.blocks < 1 || a.B > 65535 ||
      (kind == kGatePool && (a.D % 2 || a.H % 2 || a.W % 2)) ||
      (kind == kUpsampleCat && (a.Cu <= 0 || a.rz.D1 <= 0 || a.rz.H1 <= 0 || a.rz.W1 <= 0)))
    return (int)cudaErrorInvalidValue;
  a.TPR = width / vec;
  a.RPI = THREADS / a.TPR;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  int current;
  cudaError_t e = cudaGetDevice(&current);
  if (e == cudaSuccess && current != device) e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (dtype == 0)
    e = dispatch<float>(vec, kind, a, s);
  else if (dtype == 1)
    e = dispatch<__nv_bfloat16>(vec, kind, a, s);
  else
    e = cudaErrorInvalidValue;
  if (current != device) cudaSetDevice(current);
  return (int)e;
}

// upsample_trilinear3d's area_pixel_compute_scale with align_corners
float scale(int in, int out) {
  return out > 1 ? static_cast<float>(in - 1) / static_cast<float>(out - 1) : 0.0f;
}

}  // namespace

// x, y [B, D, H, W, C] contiguous (y written), s [B, C], all of dtype
// 0 = fp32, 1 = bf16; pooled null (the gate alone) or
// [B, D/2, H/2, W/2, 2C] (written; D, H, W even). vec channels a thread
// (C % vec == 0, C / vec <= 256, every pointer aligned to vec elements);
// blocks a sample. Enqueues one kernel on `stream` of `device` and returns
// cudaGetLastError() (0 = success) without synchronising.
extern "C" int brats_se_gate_pool(const void* x, const void* s, void* y, void* pooled, int B,
                                  int D, int H, int W, int C, int dtype, int vec, int blocks,
                                  int device, void* stream) {
  Args a{x, s, y, pooled, B, D, H, W, C, 0, Resize{}, 0, 0, blocks};
  return run(pooled ? kGatePool : kGate, a, dtype, vec, device, stream);
}

// skip [B, D, H, W, Cs], low [B, D1, H1, W1, Cu], out [B, D, H, W, Cs + Cu]
// (written), contiguous, one dtype as above; out[..., Cs:] is low resized
// trilinearly to (D, H, W) with align_corners=True. vec divides Cs and Cu,
// (Cs + Cu) / vec <= 256. Same launch rules as brats_se_gate_pool.
extern "C" int brats_upsample_cat(const void* skip, const void* low, void* out, int B, int D,
                                  int H, int W, int Cs, int D1, int H1, int W1, int Cu,
                                  int dtype, int vec, int blocks, int device, void* stream) {
  Args a{skip, low, out, nullptr, B, D, H, W, Cs, Cu,
         Resize{D1, H1, W1, scale(D1, D), scale(H1, H), scale(W1, W)}, 0, 0, blocks};
  return run(kUpsampleCat, a, dtype, vec, device, stream);
}

extern "C" const char* brats_glue_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
