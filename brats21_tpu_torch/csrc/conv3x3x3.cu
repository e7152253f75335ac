// 3x3x3 convolution, stride 1, zero padding 1, channels-last, for Hopper
// (sm_90a).
//
// Replaces brats21_tpu/ops/pallas/conv3d_kernel.py:_conv3x3x3_pallas.
//
//   out[m, n] = bias[n] + sum_k A[m, k] * Wt[k, n]
//   m = voxel (b, d, h, w), M = B*D*H*W;  n = output channel, N = Cout;
//   k = (tap, ci) with tap = (kd*3 + kh)*3 + kw, K = 27*Cin;
//   A[m, k] = x[b, d+kd-1, h+kh-1, w+kw-1, ci], 0 in the halo.
//
// Bound on the H100: at the model's widths the work is 2*M*N*K operations
// over (M*Cin + M*Cout)*2 bytes, ~27*Cin*Cout/(Cin+Cout) >= 600 operations
// per byte, far above the card's ~295 bf16 ops/byte ridge: the tensor cores
// bound it, and only wgmma reaches their rate.
//
// bf16 (conv3x3x3_bf16_wgmma): a warp-specialised implicit GEMM.
// - A block computes a brick of BD d x 8 h x 8 w output voxels for BN output
//   channels (BD = 4 at BN = 48, else 2). Two consumer warpgroups each own
//   BD / 2 d-slices, each one 64-row wgmma M tile (row 8*i + j = voxel
//   (h0 + i, w0 + j)).
// - A operand: for each 8-channel group of a 16-channel K chunk the
//   producer issues one tiled TMA load of the input box (d BD+2 x h 10 x
//   w 10 x 8 channels, 1600 B a d-slice) at (c0, w0-1, h0-1, d0-1, b) of x
//   viewed as a 5D tensor (C, W, H, D, B). TMA's out-of-bounds fill is the
//   zero halo. Each of the 27 taps is a shifted window of the same two
//   boxes, read by the wgmma shared-memory descriptor directly (no swizzle,
//   K-major core matrices of 8 voxels x 16 B): start box + ((kd*10 + kh)*10
//   + kw)*16 B, SBO (next 8 rows along M) = one h-row of the box, 160 B,
//   LBO (next 8 channels along K) = the second box. One box pair serves 27
//   wgmma k16 steps per d-slice; no im2col tile is built and no thread
//   computes an address or a halo predicate.
// - B operand: the wrapper packs the weights once per call so that each
//   (N tile, K chunk, group of TG taps) is one contiguous slab in the
//   descriptor's K-major layout [tap][k half][n / 8][8 n][8 k]; one
//   cp.async.bulk moves a slab into a ring stage.
// - One producer warp (setmaxnreg gives its warpgroup's registers to the
//   consumers) keeps both rings full; mbarrier expect-tx completes a stage.
//   Consumers issue wgmma m64n{BN}k16 with fp32 accumulators, keep one
//   group in flight (wait_group 1) and release the previous stage.
// - Epilogue: + bias in fp32, one rounding to bf16 (conv3d_kernel.py:79-81),
//   staged in shared memory, 16-byte stores masked to the volume. Under
//   about one wave of blocks the host plan splits K over C_in chunks: each
//   split writes fp32 partials to a workspace, and conv3x3x3_splitk_reduce
//   sums them in a fixed order, adds the bias and rounds once.
// The wrapper pads C_in to a multiple of 16 (one k16 step) and C_out to
// BN * N tiles with zeros.
//
// fp32 (conv3x3x3_f32_fma, the --no_amp flag, any shape): plain FMA tiles.

#include <cuda.h>  // CUtensorMap and its enums; the encoder comes from the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

// ---------------------------------------------------------------------------
// bf16: wgmma + TMA, warp-specialised
// ---------------------------------------------------------------------------

constexpr int BRICK_H = 8, BRICK_W = 8;
constexpr int BOX_H = BRICK_H + 2, BOX_W = BRICK_W + 2;
constexpr int SLICE_BYTES = BOX_H * BOX_W * 16;  // one d-slice of a box, 8 bf16 channels a voxel
constexpr int A_STAGES = 3;
constexpr int CONSUMERS = 2;  // warpgroups
constexpr int WG_THREADS = 128;
constexpr int WS_THREADS = (CONSUMERS + 1) * WG_THREADS;
constexpr int PRODUCER_REGS = 40;

// BN output channels per block; TG taps per weight slab; MT 64-row M tiles
// (d-slices of the brick) per consumer warpgroup. Up to 96 channels the
// accumulators are small enough for two blocks an SM (80 registers a
// thread, 96 for the consumers after setmaxnreg), so one block's pipeline
// fill and epilogue overlap the other's wgmma; at 192 one block holds the
// SM (168, 232 for the consumers). At 48 each warpgroup takes two d-slices,
// so a block of 256 voxels reads each weight slab once for both.
template <int BN>
struct Cfg {
  static constexpr int MT = BN <= 48 ? 2 : 1;
  static constexpr int BRICK_D = CONSUMERS * MT;
  static constexpr int BOX_D = BRICK_D + 2;
  static constexpr int BOX_BYTES = BOX_D * SLICE_BYTES;
  static constexpr int A_STAGE_BYTES = 2 * BOX_BYTES;  // one 16-channel K chunk
  static constexpr int TAP_BYTES = 16 * BN * 2;       // one tap of one K chunk
  static constexpr int TG = 3;
  static constexpr int GROUPS = 27 / TG;
  static constexpr int B_STAGES = BN <= 48 ? 8 : BN <= 96 ? 4 : 6;
  static constexpr int MIN_BLOCKS = BN <= 96 ? 2 : 1;
  static constexpr int CONSUMER_REGS = BN <= 96 ? 96 : 232;
  static constexpr int B_STAGE_BYTES = TG * TAP_BYTES;
  static constexpr int B_OFF = A_STAGES * A_STAGE_BYTES;
  static constexpr int BAR_OFF = B_OFF + B_STAGES * B_STAGE_BYTES;
  static constexpr int SMEM = BAR_OFF + 2 * (A_STAGES + B_STAGES) * 8;
  static constexpr int ROW_BYTES = BN * 2 + 16;  // epilogue staging row
  static_assert(CONSUMERS * MT * 64 * ROW_BYTES <= BAR_OFF, "staging fits the rings");
  static_assert(B_STAGE_BYTES % 128 == 0 && BOX_BYTES % 128 == 0, "TMA alignment");
  static_assert(MIN_BLOCKS * (SMEM + 1024) <= 228 * 1024, "blocks fit an SM");
};

struct ConvArgs {
  const unsigned char* w;  // packed weights (see the header)
  const float* bias;       // [Cout]
  unsigned short* out;     // bf16 [B, D, H, W, Cout]
  float* ws;               // split-K partials [splits, M, Cout], or null
  long long M;             // B*D*H*W output voxels
  int D, H, W, Cout;       // Cout = BN * N tiles
  int nd, nh, nw;          // bricks along D, H, W
  int chunks;              // Cin / 16
  int chunks_per_split;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Wait for the phase of the given parity to complete. A lost copy would
// hang the card: after 2^26 polls (seconds) the block traps instead.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (uint32_t polls = 0;; ++polls) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (polls == (1u << 26)) __trap();
  }
}

// One box of x (8 channels from c, the brick's halo from (w, h, d)).
__device__ __forceinline__ void tma_load_box(uint32_t dst, const CUtensorMap* map,
                                             int c, int w, int h, int d, int b,
                                             uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5, %6}], [%7];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c), "r"(w), "r"(h), "r"(d), "r"(b),
      "r"(bar)
      : "memory");
}

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// wgmma shared-memory descriptor, no swizzle: start address, LBO (the
// stride between the two 8-element core matrices along K) and SBO (the
// stride between 8-row core matrices along M or N), all in 16-byte units.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// D[64 x N] += A[64 x 16] * B[16 x N], both from shared memory, K-major.
// Accumulator register i of a thread holds row 16*warp + lane/4 + 8*((i/2)%2),
// column 8*(i/4) + 2*(lane%4) + i%2.
template <int N>
struct Wgmma;

template <>
struct Wgmma<48> {
  static __device__ __forceinline__ void mma(float (&d)[24], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23"
        "}, %24, %25, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<96> {
  static __device__ __forceinline__ void mma(float (&d)[48], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
        "}, %48, %49, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<192> {
  static __device__ __forceinline__ void mma(float (&d)[96], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
        "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
        "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
        "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
        "}, %96, %97, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
          "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
          "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
          "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
          "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <int BN>
__global__ void __launch_bounds__(WS_THREADS, Cfg<BN>::MIN_BLOCKS)
conv3x3x3_bf16_wgmma(const __grid_constant__ CUtensorMap xmap, const ConvArgs a) {
  using C = Cfg<BN>;
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t base = smem_u32(smem);
  const uint32_t full_a = base + C::BAR_OFF, empty_a = full_a + 8 * A_STAGES;
  const uint32_t full_b = empty_a + 8 * A_STAGES, empty_b = full_b + 8 * C::B_STAGES;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int i = 0; i < A_STAGES; ++i) {
      mbar_init(full_a + 8 * i, 1);
      mbar_init(empty_a + 8 * i, CONSUMERS * 4);  // lane 0 of each consumer warp
    }
    for (int i = 0; i < C::B_STAGES; ++i) {
      mbar_init(full_b + 8 * i, 1);
      mbar_init(empty_b + 8 * i, CONSUMERS * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  int brick = blockIdx.x;
  const int wx = brick % a.nw;
  brick /= a.nw;
  const int hy = brick % a.nh;
  brick /= a.nh;
  const int dz = brick % a.nd, b = brick / a.nd;
  const int d0 = dz * C::BRICK_D, h0 = hy * BRICK_H, w0 = wx * BRICK_W;
  const int nt = blockIdx.y;
  const int c_begin = blockIdx.z * a.chunks_per_split;
  const int c_end = min(a.chunks, c_begin + a.chunks_per_split);
  const int wg = tid / WG_THREADS;

  if (wg == CONSUMERS) {
    // producer warpgroup: one thread issues every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (tid == CONSUMERS * WG_THREADS) {
      int sa = 0, sb = 0;
      uint32_t pa = 0, pb = 0;
      const unsigned char* src =
          a.w + ((size_t)nt * a.chunks + c_begin) * 27 * C::TAP_BYTES;
      for (int c = c_begin; c < c_end; ++c) {
        mbar_wait(empty_a + 8 * sa, pa ^ 1);
        mbar_expect_tx(full_a + 8 * sa, C::A_STAGE_BYTES);
        const uint32_t dst = base + sa * C::A_STAGE_BYTES;
        tma_load_box(dst, &xmap, c * 16, w0 - 1, h0 - 1, d0 - 1, b, full_a + 8 * sa);
        tma_load_box(dst + C::BOX_BYTES, &xmap, c * 16 + 8, w0 - 1, h0 - 1, d0 - 1, b,
                     full_a + 8 * sa);
        if (++sa == A_STAGES) { sa = 0; pa ^= 1; }
        for (int g = 0; g < C::GROUPS; ++g) {
          mbar_wait(empty_b + 8 * sb, pb ^ 1);
          mbar_expect_tx(full_b + 8 * sb, C::B_STAGE_BYTES);
          bulk_load(base + C::B_OFF + sb * C::B_STAGE_BYTES, src, C::B_STAGE_BYTES,
                    full_b + 8 * sb);
          src += C::B_STAGE_BYTES;
          if (++sb == C::B_STAGES) { sb = 0; pb ^= 1; }
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(C::CONSUMER_REGS));
  // acc[i]: d-slice wg * MT + i of the brick
  float acc[C::MT][BN / 2];
#pragma unroll
  for (int i = 0; i < C::MT; ++i)
#pragma unroll
    for (int k = 0; k < BN / 2; ++k) acc[i][k] = 0.0f;
  const int lane = tid % 32, warp = (tid % WG_THREADS) / 32;
  const uint32_t slice = wg * C::MT * SLICE_BYTES;  // this warpgroup's first d-slice

  int sa = 0, sb = 0, pend_a = -1, pend_b = -1;
  uint32_t pa = 0, pb = 0;
  for (int c = c_begin; c < c_end; ++c) {
    mbar_wait(full_a + 8 * sa, pa);
    const uint32_t box = base + sa * C::A_STAGE_BYTES + slice;
    for (int g = 0; g < C::GROUPS; ++g) {
      mbar_wait(full_b + 8 * sb, pb);
      const uint32_t slab = base + C::B_OFF + sb * C::B_STAGE_BYTES;
      wgmma_fence();
#pragma unroll
      for (int t = 0; t < C::TG; ++t) {
        const int tap = g * C::TG + t;
        const int kd = tap / 9, kh = (tap / 3) % 3, kw = tap % 3;
        const uint64_t db = smem_desc(slab + t * C::TAP_BYTES, BN * 16, 128);
#pragma unroll
        for (int i = 0; i < C::MT; ++i) {
          const uint64_t da =
              smem_desc(box + (i + kd) * SLICE_BYTES + (kh * BOX_W + kw) * 16,
                        C::BOX_BYTES, BOX_W * 16);
          Wgmma<BN>::mma(acc[i], da, db);
        }
      }
      wgmma_commit();
      // the previous group has finished reading its stages: release them
      wgmma_wait<1>();
      if (lane == 0) {
        if (pend_b >= 0) mbar_arrive(empty_b + 8 * pend_b);
        if (pend_a >= 0) mbar_arrive(empty_a + 8 * pend_a);
      }
      pend_b = sb;
      pend_a = g == C::GROUPS - 1 ? sa : -1;
      if (++sb == C::B_STAGES) { sb = 0; pb ^= 1; }
    }
    if (++sa == A_STAGES) { sa = 0; pa ^= 1; }
  }
  wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < C::MT; ++i)
#pragma unroll
    for (int k = 0; k < BN / 2; ++k) asm volatile("" : "+f"(acc[i][k])::"memory");

  const int row0 = warp * 16 + lane / 4, col0 = (lane % 4) * 2;
  if (a.ws != nullptr) {
    // split-K: fp32 partials straight to the workspace, 8 bytes a thread
    // (a quad covers 32 contiguous bytes)
    float* ws = a.ws + (size_t)blockIdx.z * a.M * a.Cout + nt * BN + col0;
#pragma unroll
    for (int i = 0; i < C::MT; ++i)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int d = d0 + wg * C::MT + i;
        const int r = row0 + 8 * half, h = h0 + r / 8, w = w0 + r % 8;
        if (d >= a.D || h >= a.H || w >= a.W) continue;
        float* dst = ws + ((((size_t)b * a.D + d) * a.H + h) * a.W + w) * a.Cout;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
          *reinterpret_cast<float2*>(dst + 8 * j) =
              make_float2(acc[i][4 * j + 2 * half], acc[i][4 * j + 2 * half + 1]);
      }
    return;
  }

  // + bias in fp32, one rounding to bf16, staged through shared memory
  // (both warpgroups are done with the rings) for 16-byte stores
  named_sync(1, CONSUMERS * WG_THREADS);
  unsigned char* stage = smem + wg * C::MT * 64 * C::ROW_BYTES;  // rows i * 64 + r
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = 8 * j + col0;
    const float b0 = a.bias[nt * BN + col], b1 = a.bias[nt * BN + col + 1];
#pragma unroll
    for (int i = 0; i < C::MT; ++i)
#pragma unroll
      for (int half = 0; half < 2; ++half)
        *reinterpret_cast<__nv_bfloat162*>(
            stage + (i * 64 + row0 + 8 * half) * C::ROW_BYTES + col * 2) =
            __floats2bfloat162_rn(acc[i][4 * j + 2 * half] + b0,
                                  acc[i][4 * j + 2 * half + 1] + b1);
  }
  named_sync(2 + wg, WG_THREADS);
  for (int k = tid % WG_THREADS; k < C::MT * 64 * (BN / 8); k += WG_THREADS) {
    const int r = k / (BN / 8), cc = k % (BN / 8);
    const int d = d0 + wg * C::MT + r / 64, h = h0 + r % 64 / 8, w = w0 + r % 8;
    if (d >= a.D || h >= a.H || w >= a.W) continue;
    const size_t m = (((size_t)b * a.D + d) * a.H + h) * a.W + w;
    *reinterpret_cast<uint4*>(a.out + m * a.Cout + nt * BN + cc * 8) =
        *reinterpret_cast<const uint4*>(stage + r * C::ROW_BYTES + cc * 16);
  }
}

// out[m, n] = bf16(sum over splits of ws[s, m, n] + bias[n]), 4 channels a
// thread, the splits summed in order.
__global__ void __launch_bounds__(256)
conv3x3x3_splitk_reduce(const float* __restrict__ ws, const float* __restrict__ bias,
                        unsigned short* __restrict__ out, long long MC, int Cout,
                        int splits) {
  const long long step = 4LL * gridDim.x * blockDim.x;
  for (long long i = 4LL * (blockIdx.x * (long long)blockDim.x + threadIdx.x); i < MC;
       i += step) {
    float4 s = *reinterpret_cast<const float4*>(ws + i);
    for (int z = 1; z < splits; ++z) {
      const float4 t = *reinterpret_cast<const float4*>(ws + z * MC + i);
      s.x += t.x; s.y += t.y; s.z += t.z; s.w += t.w;
    }
    const float4 bv = *reinterpret_cast<const float4*>(bias + i % Cout);
    const __nv_bfloat162 lo = __floats2bfloat162_rn(s.x + bv.x, s.y + bv.y);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(s.z + bv.z, s.w + bv.w);
    uint2 v;
    v.x = *reinterpret_cast<const unsigned*>(&lo);
    v.y = *reinterpret_cast<const unsigned*>(&hi);
    *reinterpret_cast<uint2*>(out + i) = v;
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's driver entry point, so the
// library links no libcuda.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The brick grid and x's tensor map (its box the brick's halo) for N tiles
// of BN, then the launch.
template <int BN>
cudaError_t launch_wgmma(const void* x, ConvArgs a, int B, int Cin, int n_tiles, int splits,
                         cudaStream_t s) {
  using C = Cfg<BN>;
  a.nd = (a.D + C::BRICK_D - 1) / C::BRICK_D;
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorSymbolNotFound;
  CUtensorMap map;
  const cuuint64_t dims[5] = {(cuuint64_t)Cin, (cuuint64_t)a.W, (cuuint64_t)a.H,
                              (cuuint64_t)a.D, (cuuint64_t)B};
  const cuuint64_t strides[4] = {2ull * Cin, 2ull * Cin * a.W, 2ull * Cin * a.W * a.H,
                                 2ull * Cin * a.W * a.H * a.D};
  const cuuint32_t box[5] = {8, BOX_W, BOX_H, C::BOX_D, 1};
  const cuuint32_t unit[5] = {1, 1, 1, 1, 1};
  if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5, const_cast<void*>(x), dims, strides,
             box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;

  auto kernel = conv3x3x3_bf16_wgmma<BN>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       C::SMEM);
  if (e != cudaSuccess) return e;
  // setmaxnreg.inc waits for registers the block does not own when ptxas
  // gave each thread fewer than the split needs: refuse rather than hang
  cudaFuncAttributes attr;
  e = cudaFuncGetAttributes(&attr, kernel);
  if (e != cudaSuccess) return e;
  if (attr.numRegs * WS_THREADS <
      PRODUCER_REGS * WG_THREADS + C::CONSUMER_REGS * CONSUMERS * WG_THREADS)
    return cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)B * a.nd * a.nh * a.nw, n_tiles, splits);
  kernel<<<grid, WS_THREADS, C::SMEM, s>>>(map, a);
  return cudaGetLastError();
}

cudaError_t conv_bf16(const void* x, const void* w, const void* bias, void* out, void* ws,
                      int B, int D, int H, int W, int Cin, int Cout, int bn, int splits,
                      cudaStream_t s) {
  if (Cin % 16 != 0 || (bn != 48 && bn != 96 && bn != 192) || Cout % bn != 0 ||
      splits < 1 || (splits > 1) != (ws != nullptr))
    return cudaErrorInvalidValue;
  ConvArgs a;
  a.w = static_cast<const unsigned char*>(w);
  a.bias = static_cast<const float*>(bias);
  a.out = static_cast<unsigned short*>(out);
  a.ws = static_cast<float*>(ws);
  a.M = (long long)B * D * H * W;
  a.D = D; a.H = H; a.W = W; a.Cout = Cout;
  a.nh = (H + BRICK_H - 1) / BRICK_H;
  a.nw = (W + BRICK_W - 1) / BRICK_W;
  a.chunks = Cin / 16;
  a.chunks_per_split = (a.chunks + splits - 1) / splits;
  if ((splits - 1) * a.chunks_per_split >= a.chunks) return cudaErrorInvalidValue;

  const int n_tiles = Cout / bn;
  cudaError_t e;
  if (bn == 48) e = launch_wgmma<48>(x, a, B, Cin, n_tiles, splits, s);
  else if (bn == 96) e = launch_wgmma<96>(x, a, B, Cin, n_tiles, splits, s);
  else e = launch_wgmma<192>(x, a, B, Cin, n_tiles, splits, s);
  if (e != cudaSuccess || splits == 1) return e;
  const long long MC = a.M * Cout;
  const long long blocks = (MC / 4 + 255) / 256;
  conv3x3x3_splitk_reduce<<<(unsigned)(blocks < 4096 ? blocks : 4096), 256, 0, s>>>(
      static_cast<const float*>(ws), static_cast<const float*>(bias),
      static_cast<unsigned short*>(out), MC, Cout, splits);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// fp32: FMA tiles (64 voxels x 64 channels, 4x4 per thread)
// ---------------------------------------------------------------------------

constexpr int THREADS = 256;
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

// dtype 0 = fp32: x, w [3, 3, 3, Cin, Cout] and out fp32, any shape; bn,
// splits and ws unused.
// dtype 1 = bf16: Cin a multiple of 16, w packed by the wrapper for N tiles
// of bn in {48, 96, 192} output channels (Cout a multiple of bn), K split in
// `splits` parts over Cin chunks with fp32 partials in ws
// [splits, B*D*H*W, Cout] (null when splits is 1).
// Launches on `stream` and returns cudaGetLastError() (0 = success) without
// synchronising.
extern "C" int brats_conv3x3x3(const void* x, const void* w, const void* bias, void* out,
                               void* ws, int B, int D, int H, int W, int Cin, int Cout,
                               int dtype, int bn, int splits, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if ((long long)B * D * H * W == 0 || Cout == 0) return 0;
  if (dtype == 1)
    return (int)conv_bf16(x, w, bias, out, ws, B, D, H, W, Cin, Cout, bn, splits, s);
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  Geom g;
  g.B = B; g.D = D; g.H = H; g.W = W; g.Cin = Cin; g.Cout = Cout;
  g.M = (long long)B * D * H * W;
  g.K = 27 * Cin;
  dim3 grid((unsigned)((g.M + FM - 1) / FM), (unsigned)((Cout + FN - 1) / FN));
  conv3x3x3_f32_fma<<<grid, THREADS, 0, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const float*>(bias), static_cast<float*>(out), g);
  return (int)cudaGetLastError();
}

extern "C" const char* brats_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
