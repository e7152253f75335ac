// B4: Swin UNETR's shifted-window attention (sm_90a), one kernel.
//
// Replaces no TPU kernel: the JAX package has no Swin UNETR. As PyTorch
// calls a Swin block rolls and partitions the qkv grid, writes every
// window's fp32 scores (1000 windows x heads x 343^2 at stage 1 of a 128^3
// window, 1.41 GB with 3 heads), reads and rewrites them for the relative
// position bias, the shift mask and the softmax, and reverses the
// partition and the roll. Here a block computes one (window, head, sample)
// from the qkv Linear's output over the padded grid and writes each
// token's output where the token lies in the unshifted grid.
//
// The cyclic shift and the partition are index arithmetic: token i of
// window (wd, wh, ww) lies at (wd*WD + i_d, ...) of the grid rolled by
// -shift, that is at (wd*WD + i_d + shift_d) mod Dp, ... of the input.
// Its region for the shift mask is MONAI's compute_mask of the rolled
// coordinate on each axis (0 below P - window, 1 below P - shift, else 2);
// its relative position code is that of token i of the module's 7^3
// window, (i/49)*169 + (i/7%7)*13 + i%7, so that the bias of (i, j) is
// table[code_i - code_j + 1098] (MONAI's index; a window clipped to
// n < 343 tokens takes its first n rows and columns, idx[:n, :n]).
//
// Bound on the H100: the exponentials. Per (window, head) 4 n^2 16 FLOP of
// products on the tensor cores against n^2 exponentials on the special
// function units (16 a clock an SM), and q, k, v and the output moved once.
//
// A block of 8 warps stages k (rows of 24 bf16: the fragment loads are free
// of bank conflicts) and v transposed (rows of 360 bf16) in shared memory
// with the head's column of the table and each token's code, region and
// grid offset. A warp takes 16 queries at a time: q from global memory into
// an mma.m16n8k16 A fragment, scores of 64 keys at a time on the tensor
// cores in fp32, the bias, the mask and the scale applied in fp32 in the
// log2 domain, an online softmax (running max and sum, the output rescaled)
// and the probabilities, rounded to bf16, straight from the score
// accumulators into the A fragment of the product with v. The output is
// divided by the row sum in fp32 and rounded to bf16 once.
//
// fp32 (the --no_amp flag): window_attn_f32_kernel, plain FMA. A block of
// 352 threads stages the window's k and v in fp32 in shared memory; each
// thread takes one query and runs the same online softmax over the keys,
// one at a time, with the products, the bias, the mask and the softmax all
// in fp32. The table is read through the read-only cache.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int WIN = 7;                        // the module's window
constexpr int NPAD = 352;                     // 7^3 = 343 tokens rounded up to 16
constexpr int TABLE = (2 * WIN - 1) * (2 * WIN - 1) * (2 * WIN - 1);   // 2197
constexpr int CENTRE = (WIN - 1) * (2 * WIN - 1) * (2 * WIN - 1) + (WIN - 1) * (2 * WIN - 1) +
                       (WIN - 1);             // 1098: the code difference's offset
constexpr int HD = 16;                        // head size
constexpr int KS = 24;                        // k row stride (bf16)
constexpr int VS = 360;                       // transposed v row stride (bf16)
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int KEYS = 64;                      // keys a step of the online softmax
constexpr float LOG2E = 1.4426950408889634f;
constexpr float MASK = -100.0f;               // MONAI's compute_mask
constexpr int F32_THREADS = NPAD;             // fp32: a thread a query

struct Params {
  int B, Dp, Hp, Wp, heads;
  int wd, wh, ww;                             // window
  int sd, sh, sw;                             // shift
  int masked;                                 // any shift > 0
  float scale;                                // head size ^ -1/2
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ int region(int c, int p, int w, int s) {
  return c < p - w ? 0 : (c < p - s ? 1 : 2);
}

// Token i of window (wz, wy, wx) of sample b: its index in the unshifted
// grid and its region of the shift mask (0 where no axis is shifted).
__device__ __forceinline__ void locate(const Params& p, int i, int b, int wz, int wy, int wx,
                                       int& tok, int& reg) {
  const int ld = i / (p.wh * p.ww), lh = (i / p.ww) % p.wh, lw = i % p.ww;
  const int sd = wz * p.wd + ld, sh = wy * p.wh + lh, sw = wx * p.ww + lw;   // rolled
  int od = sd + p.sd, oh = sh + p.sh, ow = sw + p.sw;
  if (od >= p.Dp) od -= p.Dp;
  if (oh >= p.Hp) oh -= p.Hp;
  if (ow >= p.Wp) ow -= p.Wp;
  tok = ((b * p.Dp + od) * p.Hp + oh) * p.Wp + ow;
  reg = p.masked ? region(sd, p.Dp, p.wd, p.sd) * 9 + region(sh, p.Hp, p.wh, p.sh) * 3 +
                       region(sw, p.Wp, p.ww, p.sw)
                 : 0;
}

// The relative position code of token i of the module's 7^3 window.
__device__ __forceinline__ int rel_code(int i) {
  return (i / (WIN * WIN)) * (2 * WIN - 1) * (2 * WIN - 1) + ((i / WIN) % WIN) * (2 * WIN - 1) +
         i % WIN;
}

__global__ void __launch_bounds__(THREADS) window_attn_kernel(
    const __nv_bfloat16* __restrict__ qkv, const float* __restrict__ table,
    __nv_bfloat16* __restrict__ out, Params p) {
  __shared__ __align__(16) __nv_bfloat16 ks[NPAD * KS];
  __shared__ __align__(16) __nv_bfloat16 vt[HD * VS];
  __shared__ float tab[TABLE];
  __shared__ int code[NPAD], reg[NPAD], tok[NPAD];

  const int win = blockIdx.x, head = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int nww = p.Wp / p.ww, nwh = p.Hp / p.wh;
  const int wz = win / (nwh * nww), wy = (win / nww) % nwh, wx = win % nww;
  const int n = p.wd * p.wh * p.ww;
  const int npad = (n + 15) & ~15;
  const long long row = 3LL * p.heads * HD;   // elements of one token's q, k and v

  // the head's column of the table, in the log2 domain
  for (int i = tid; i < TABLE; i += THREADS) tab[i] = table[(long long)i * p.heads + head] * LOG2E;
  for (int i = tid; i < npad; i += THREADS) {
    if (i < n) {
      locate(p, i, b, wz, wy, wx, tok[i], reg[i]);
      code[i] = rel_code(i);
    } else {
      tok[i] = 0;
      reg[i] = -1;
      code[i] = 0;
    }
  }
  __syncthreads();
  // k rows and v transposed; rows past n are zeros
  for (int idx = tid; idx < npad * 2; idx += THREADS) {
    const int i = idx >> 1, half = idx & 1;
    uint4 kv = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
    if (i < n) {
      const __nv_bfloat16* base = qkv + (long long)tok[i] * row + head * HD + half * 8;
      kv = *reinterpret_cast<const uint4*>(base + (long long)p.heads * HD);
      vv = *reinterpret_cast<const uint4*>(base + 2LL * p.heads * HD);
    }
    *reinterpret_cast<uint4*>(&ks[i * KS + half * 8]) = kv;
    const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vv);
#pragma unroll
    for (int e = 0; e < 8; ++e) vt[(half * 8 + e) * VS + i] = ve[e];
  }
  __syncthreads();

  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const float qscale = p.scale * LOG2E;
  const float mask2 = MASK * LOG2E;
  const int nk16 = npad / 16;
  for (int qt = warp; qt < nk16; qt += WARPS) {
    const int r0 = qt * 16 + g, r1 = r0 + 8;
    uint32_t qa[4] = {0, 0, 0, 0};
    if (r0 < n) {
      const __nv_bfloat16* qp = qkv + (long long)tok[r0] * row + head * HD;
      qa[0] = *reinterpret_cast<const uint32_t*>(qp + 2 * t);
      qa[2] = *reinterpret_cast<const uint32_t*>(qp + 2 * t + 8);
    }
    if (r1 < n) {
      const __nv_bfloat16* qp = qkv + (long long)tok[r1] * row + head * HD;
      qa[1] = *reinterpret_cast<const uint32_t*>(qp + 2 * t);
      qa[3] = *reinterpret_cast<const uint32_t*>(qp + 2 * t + 8);
    }
    const int c0 = code[r0] + CENTRE, c1 = code[r1] + CENTRE;
    const int g0 = reg[r0], g1 = reg[r1];
    float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F, l0 = 0.f, l1 = 0.f;
    float o[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};

    for (int k0 = 0; k0 < npad; k0 += KEYS) {
      float s[KEYS / 8][4];
#pragma unroll
      for (int c = 0; c < KEYS / 8; ++c) {
        const int key = k0 + c * 8;
        s[c][0] = s[c][1] = s[c][2] = s[c][3] = 0.f;
        if (key < npad) {
          const uint32_t b0 = *reinterpret_cast<const uint32_t*>(&ks[(key + g) * KS + 2 * t]);
          const uint32_t b1 = *reinterpret_cast<const uint32_t*>(&ks[(key + g) * KS + 2 * t + 8]);
          mma16816(s[c], qa, b0, b1);
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int j = key + 2 * t + e;
            if (j < n) {
              const int cj = code[j], rj = reg[j];
              s[c][e] = fmaf(s[c][e], qscale, tab[c0 - cj]) + (rj != g0 ? mask2 : 0.f);
              s[c][2 + e] = fmaf(s[c][2 + e], qscale, tab[c1 - cj]) + (rj != g1 ? mask2 : 0.f);
            } else {
              s[c][e] = s[c][2 + e] = -CUDART_INF_F;
            }
          }
        } else {
          s[c][0] = s[c][1] = s[c][2] = s[c][3] = -CUDART_INF_F;
        }
      }
      float x0 = -CUDART_INF_F, x1 = -CUDART_INF_F;
#pragma unroll
      for (int c = 0; c < KEYS / 8; ++c) {
        x0 = fmaxf(x0, fmaxf(s[c][0], s[c][1]));
        x1 = fmaxf(x1, fmaxf(s[c][2], s[c][3]));
      }
      x0 = fmaxf(x0, __shfl_xor_sync(0xffffffffu, x0, 1));
      x0 = fmaxf(x0, __shfl_xor_sync(0xffffffffu, x0, 2));
      x1 = fmaxf(x1, __shfl_xor_sync(0xffffffffu, x1, 1));
      x1 = fmaxf(x1, __shfl_xor_sync(0xffffffffu, x1, 2));
      const float n0 = fmaxf(m0, x0), n1 = fmaxf(m1, x1);
      const float f0 = ex2(m0 - n0), f1 = ex2(m1 - n1);
      m0 = n0;
      m1 = n1;
      l0 *= f0;
      l1 *= f1;
#pragma unroll
      for (int d = 0; d < 2; ++d) {
        o[d][0] *= f0;
        o[d][1] *= f0;
        o[d][2] *= f1;
        o[d][3] *= f1;
      }
#pragma unroll
      for (int c = 0; c < KEYS / 8; c += 2) {
        const int key = k0 + c * 8;
        if (key < npad) {
          float pr[2][4];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            pr[h][0] = ex2(s[c + h][0] - m0);
            pr[h][1] = ex2(s[c + h][1] - m0);
            pr[h][2] = ex2(s[c + h][2] - m1);
            pr[h][3] = ex2(s[c + h][3] - m1);
            l0 += pr[h][0] + pr[h][1];
            l1 += pr[h][2] + pr[h][3];
          }
          const uint32_t pa[4] = {pack_bf16(pr[0][0], pr[0][1]), pack_bf16(pr[0][2], pr[0][3]),
                                  pack_bf16(pr[1][0], pr[1][1]), pack_bf16(pr[1][2], pr[1][3])};
#pragma unroll
          for (int d = 0; d < 2; ++d) {
            const uint32_t b0 =
                *reinterpret_cast<const uint32_t*>(&vt[(d * 8 + g) * VS + key + 2 * t]);
            const uint32_t b1 =
                *reinterpret_cast<const uint32_t*>(&vt[(d * 8 + g) * VS + key + 2 * t + 8]);
            mma16816(o[d], pa, b0, b1);
          }
        }
      }
    }
    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const long long ostride = (long long)p.heads * HD;
    if (r0 < n) {
      __nv_bfloat16* op = out + (long long)tok[r0] * ostride + head * HD;
      const float inv = 1.f / l0;
#pragma unroll
      for (int d = 0; d < 2; ++d)
        *reinterpret_cast<uint32_t*>(op + d * 8 + 2 * t) = pack_bf16(o[d][0] * inv, o[d][1] * inv);
    }
    if (r1 < n) {
      __nv_bfloat16* op = out + (long long)tok[r1] * ostride + head * HD;
      const float inv = 1.f / l1;
#pragma unroll
      for (int d = 0; d < 2; ++d)
        *reinterpret_cast<uint32_t*>(op + d * 8 + 2 * t) = pack_bf16(o[d][2] * inv, o[d][3] * inv);
    }
  }
}

__global__ void __launch_bounds__(F32_THREADS) window_attn_f32_kernel(
    const float* __restrict__ qkv, const float* __restrict__ table, float* __restrict__ out,
    Params p) {
  __shared__ __align__(16) float ks[NPAD * HD];
  __shared__ __align__(16) float vs[NPAD * HD];
  __shared__ int tok[NPAD], cr[NPAD];         // grid index; code | region << 16

  const int win = blockIdx.x, head = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int nww = p.Wp / p.ww, nwh = p.Hp / p.wh;
  const int wz = win / (nwh * nww), wy = (win / nww) % nwh, wx = win % nww;
  const int n = p.wd * p.wh * p.ww;
  const long long row = 3LL * p.heads * HD;

  if (tid < n) {
    int reg;
    locate(p, tid, b, wz, wy, wx, tok[tid], reg);
    cr[tid] = rel_code(tid) | reg << 16;
  }
  __syncthreads();
  for (int idx = tid; idx < n * 4; idx += F32_THREADS) {
    const int i = idx >> 2, quarter = idx & 3;
    const float* base = qkv + (long long)tok[i] * row + head * HD + quarter * 4;
    *reinterpret_cast<float4*>(&ks[i * HD + quarter * 4]) =
        *reinterpret_cast<const float4*>(base + (long long)p.heads * HD);
    *reinterpret_cast<float4*>(&vs[i * HD + quarter * 4]) =
        *reinterpret_cast<const float4*>(base + 2LL * p.heads * HD);
  }
  __syncthreads();
  if (tid >= n) return;

  const float qscale = p.scale * LOG2E, mask2 = MASK * LOG2E;
  const float* qp = qkv + (long long)tok[tid] * row + head * HD;
  float q[HD], o[HD];
#pragma unroll
  for (int d = 0; d < HD; d += 4) {
    const float4 v4 = *reinterpret_cast<const float4*>(qp + d);
    q[d] = v4.x * qscale;
    q[d + 1] = v4.y * qscale;
    q[d + 2] = v4.z * qscale;
    q[d + 3] = v4.w * qscale;
  }
#pragma unroll
  for (int d = 0; d < HD; ++d) o[d] = 0.f;
  const int ci = (cr[tid] & 0xffff) + CENTRE, gi = cr[tid] >> 16;
  const float* tcol = table + head;
  float m = -CUDART_INF_F, l = 0.f;
  for (int j = 0; j < n; ++j) {
    const float* kj = &ks[j * HD];
    const float* vj = &vs[j * HD];
    float s = 0.f;
#pragma unroll
    for (int d = 0; d < HD; ++d) s = fmaf(q[d], kj[d], s);
    const int c = cr[j];
    s = fmaf(__ldg(tcol + (long long)(ci - (c & 0xffff)) * p.heads), LOG2E, s) +
        ((c >> 16) != gi ? mask2 : 0.f);
    float e;
    if (s > m) {                              // a new running max: rescale what was summed
      const float f = exp2f(m - s);
      l *= f;
#pragma unroll
      for (int d = 0; d < HD; ++d) o[d] *= f;
      m = s;
      e = 1.f;
    } else {
      e = exp2f(s - m);
    }
    l += e;
#pragma unroll
    for (int d = 0; d < HD; ++d) o[d] = fmaf(e, vj[d], o[d]);
  }
  const float inv = 1.f / l;
  float* op = out + (long long)tok[tid] * p.heads * HD + head * HD;
#pragma unroll
  for (int d = 0; d < HD; d += 4)
    *reinterpret_cast<float4*>(op + d) =
        make_float4(o[d] * inv, o[d + 1] * inv, o[d + 2] * inv, o[d + 3] * inv);
}

}  // namespace

// qkv [B, Dp, Hp, Wp, 3, heads, 16] contiguous, 16-byte aligned, in bf16
// (dtype 1) or fp32 (dtype 0); table [2197, heads] fp32 contiguous; out
// [B, Dp, Hp, Wp, heads * 16] in qkv's dtype (written). Windows wd, wh, ww
// in 1..7 dividing Dp, Hp, Wp; shifts below them (the mask applies where any
// is nonzero). Enqueues one kernel on `stream` of `device` and returns
// cudaGetLastError() (0 = success) without synchronising, leaving the
// caller's current device as it was.
extern "C" int brats_window_attn(const void* qkv, const void* table, void* out, int B, int Dp,
                                 int Hp, int Wp, int heads, int wd, int wh, int ww, int sd, int sh,
                                 int sw, int dtype, int device, void* stream) {
  if (B <= 0 || Dp <= 0 || Hp <= 0 || Wp <= 0) return 0;
  if (heads <= 0 || heads > 65535 || B > 65535 || wd < 1 || wh < 1 || ww < 1 || wd > WIN ||
      wh > WIN || ww > WIN || Dp % wd || Hp % wh || Wp % ww || sd < 0 || sh < 0 || sw < 0 ||
      sd >= wd || sh >= wh || sw >= ww || (long long)B * Dp * Hp * Wp > 0x7fffffffLL ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  Params p{B, Dp, Hp, Wp, heads, wd, wh, ww, sd, sh, sw, (sd | sh | sw) != 0, 0.25f};
  const long long windows = (long long)(Dp / wd) * (Hp / wh) * (Wp / ww);
  if (windows > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  int current;
  cudaError_t e = cudaGetDevice(&current);
  if (e == cudaSuccess && current != device) e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)windows, heads, B);
  const cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == 1)
    window_attn_kernel<<<grid, THREADS, 0, st>>>(static_cast<const __nv_bfloat16*>(qkv),
                                                 static_cast<const float*>(table),
                                                 static_cast<__nv_bfloat16*>(out), p);
  else
    window_attn_f32_kernel<<<grid, F32_THREADS, 0, st>>>(
        static_cast<const float*>(qkv), static_cast<const float*>(table),
        static_cast<float*>(out), p);
  e = cudaGetLastError();
  if (current != device) cudaSetDevice(current);
  return (int)e;
}

extern "C" const char* brats_window_attn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
