// Lower envelope of parabolas along one axis (one pass of the exact
// Euclidean distance transform), for Hopper (sm_90a).
//
// Replaces brats21_tpu/ops/pallas/edt_kernel.py:envelope_last_axis (body
// _envelope_kernel :28).
//
//   out[o, i, r] = min(1e12, min_j g[o, j, r] + ((i - j) * s)^2)
//
// over the tensor viewed as [outer, n, inner]: the envelope runs along n,
// whose stride is inner, so every axis of a volume is served in place (the
// TPU version moves each axis last first). A line is the n elements of one
// (o, r); there are outer * inner lines.
//
// Algorithm: the lower envelope of the parabolas, O(n) a line, in two
// forms:
// - the integer path (unit sampling, finite entries integers below 2^18:
//   every line of edt_sq at unit sampling, the only sampling the callers
//   use): Felzenszwalb & Huttenlocher's stack, each entry carrying
//   c = g + v^2 and its vertex v, the separators compared by integer
//   cross-multiplication, exact in int32, so no division lies between one
//   element and the next. Each line is cut into four bands, one thread
//   each, whose stacks one thread then joins (the banding of Cao et al.'s
//   Parallel Banding Algorithm, I3D 2010): the join is short because a
//   band's stack is final from the first of its entries that lands on its
//   own band neighbour;
// - the float path (any other line, one thread): Meijster's two phases
//   (Meijster, Roerdink & Hesselink 2000), whose stack holds integer
//   region starts w = floor(x) + 1 from one fp32 division, x being where a
//   parabola overtakes the one below it.
//
// Exactness. Both paths evaluate out[i] exactly as the scan evaluates its
// candidates: g[v] + ((i - v) * s)^2, each step rounded on its own (the _rn
// intrinsics forbid contraction into FMA). On the integer path all of it is
// exact (values below 2^24: the largest squared distance of a BraTS case
// is 240^2+240^2+155^2 = 139,225), so the kernel equals the scan
// (envelope_plain) bit for bit. On the float path at unit sampling with
// integer values the separator is exact too (its numerator and denominator
// are integers below 2^24 and 2n, and one correctly rounded division leaves
// floor(x) intact for |x| <= n). At other samplings two parabolas within an
// ulp of each other at i may be chosen otherwise than the scan chooses: the
// result is then within a rounding of the scan's (held to rtol 1e-6).
// Entries >= 1e12 never enter the envelope (their candidates cannot
// undercut the scan's 1e12 accumulator); a line without a finite entry
// writes fp32(1e12) everywhere, as the scan does.
//
// The first pass of a mask (brats_edt_envelope_mask) reads the bool mask
// (1 byte an element, no fp32 copy of it): its envelope is the squared
// distance to the nearest False element, found by a forward and a backward
// sweep. The rounded candidate ((i - j) * s)^2 is monotone in |i - j|, so
// this equals the scan of where(mask, 1e12, 0) bit for bit at any sampling.
//
// Bound on the H100: bytes. One read and one write of each element
// (8 bytes, 5 for the mask pass) against ~25 operations an element, far
// under the fp32 ridge of 20 operations a byte. The walk along a line is
// sequential, so what the design fights is latency, not bandwidth (clock64
// timings of a one-thread-a-line version put five sixths of a block's time
// in the walk):
// - a block stages 32 lines as [n][33] tiles in shared memory (cp.async for
//   the fp32 passes: every copy in flight, one wait), loaded and stored
//   with coalesced accesses along whichever axis is contiguous (the lines
//   themselves when inner == 1, the 32 lanes otherwise; the padding keeps
//   both patterns free of bank conflicts);
// - the bands put four warps on each block's 32 lines, 24 warps an SM at
//   n = 128 where one thread a line left six, and cut each thread's walk to
//   a quarter of the line;
// - each thread walks one event an iteration, a pop or the next element:
//   with a pop loop nested in the element loop a warp waited at every
//   element for its lane with the most pops;
// - the stack's top two entries live in registers, so a pop test never
//   waits on shared memory;
// - the stack lives in the second tile; the integer path's fills write
//   over the g tile (its entries carry c), the float path's descending fill
//   over stack slot u, which no later step reads. State is 8 bytes an
//   element: 35 KB a block at n = 128 (six blocks an SM), 64 KB at n = 240;
//   the mask pass (one warp a block) needs one tile, 4 bytes an element.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 32;            // lines per block
constexpr int kBands = 4;             // threads a line on the integer path
constexpr int kPitch = kLanes + 1;    // shared tile row, padded
constexpr float kInf = 1e12f;         // the JAX package's _INF
constexpr int kFar = 1 << 28;         // "no False on this side"
// The integer path: entries below 2^18 and lines of at most 768 keep
// c = g + v^2 below 2^20 and every cross product below 2^30.
constexpr float kIntMax = 262144.0f;
constexpr int kCBits = 20;
constexpr uint32_t kCMask = (1u << kCBits) - 1;

// The scan's candidate g + ((i - v) * s)^2, rounded step by step.
__device__ __forceinline__ float cand(float g, int i, int v, float s) {
  const float d = __fmul_rn(__fsub_rn((float)i, (float)v), s);
  return __fadd_rn(g, __fmul_rn(d, d));
}

// Offset of element 0 of line `line` of the [outer, n, inner] view.
__device__ __forceinline__ long long line_base(long long line, int n,
                                               long long inner) {
  const long long o = line / inner;
  return o * n * inner + (line - o * inner);
}

// Stage 32 lines of `src` into tile[j * kPitch + lane] through `cvt`;
// lines past the end read `pad`. Every warp of the block takes a share;
// coalesced along the contiguous axis.
template <int kParts, typename T, typename Tile, typename Cvt>
__device__ __forceinline__ void stage_in(const T* __restrict__ src, Tile* tile,
                                         long long line0, long long lines,
                                         int n, long long inner, Tile pad,
                                         Cvt cvt) {
  const int lane = threadIdx.x % kLanes, part = threadIdx.x / kLanes;
  if (inner == 1) {
    for (int ln = part; ln < kLanes; ln += kParts) {
      const long long line = line0 + ln;
      const T* row = src + line * n;
#pragma unroll 4
      for (int j = lane; j < n; j += kLanes)
        tile[j * kPitch + ln] = line < lines ? cvt(row[j]) : pad;
    }
  } else {
    const long long line = line0 + lane;
    const long long base = line < lines ? line_base(line, n, inner) : 0;
#pragma unroll 4
    for (int j = part; j < n; j += kParts)
      tile[j * kPitch + lane] = line < lines ? cvt(src[base + j * inner]) : pad;
  }
  __syncthreads();
}

// Store tile[j * kPitch + lane] (fp32 bits) to 32 lines of `dst`, lane
// by lane from `tile` or, where alt_lanes has the lane's bit, from `alt`.
template <int kParts>
__device__ __forceinline__ void stage_out(float* __restrict__ dst,
                                          const uint32_t* tile,
                                          const uint32_t* alt,
                                          unsigned alt_lanes, long long line0,
                                          long long lines, int n,
                                          long long inner) {
  const int lane = threadIdx.x % kLanes, part = threadIdx.x / kLanes;
  __syncthreads();
  if (inner == 1) {
    for (int ln = part; ln < kLanes; ln += kParts) {
      const long long line = line0 + ln;
      if (line >= lines) break;
      const uint32_t* from = (alt_lanes >> ln & 1) ? alt : tile;
      float* row = dst + line * n;
#pragma unroll 4
      for (int j = lane; j < n; j += kLanes)
        row[j] = __uint_as_float(from[j * kPitch + ln]);
    }
  } else {
    const long long line = line0 + lane;
    if (line >= lines) return;
    const uint32_t* from = (alt_lanes >> lane & 1) ? alt : tile;
    const long long base = line_base(line, n, inner);
#pragma unroll 4
    for (int j = part; j < n; j += kParts)
      dst[base + j * inner] = __uint_as_float(from[j * kPitch + lane]);
  }
}

// Stage 32 fp32 lines of `g` like stage_in, with cp.async: every copy in
// flight at once, one wait.
template <int kParts>
__device__ __forceinline__ void stage_in_async(const float* __restrict__ g,
                                               float* tile, long long line0,
                                               long long lines, int n,
                                               long long inner) {
  const int lane = threadIdx.x % kLanes, part = threadIdx.x / kLanes;
  if (inner == 1) {
    for (int ln = part; ln < kLanes; ln += kParts) {
      const long long line = line0 + ln;
      for (int j = lane; j < n; j += kLanes) {
        float* dst = tile + j * kPitch + ln;
        if (line < lines) {
          const unsigned sa = (unsigned)__cvta_generic_to_shared(dst);
          asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(sa),
                       "l"(g + line * n + j));
        } else {
          *dst = kInf;
        }
      }
    }
  } else {
    const long long line = line0 + lane;
    const long long base = line < lines ? line_base(line, n, inner) : 0;
    for (int j = part; j < n; j += kParts) {
      float* dst = tile + j * kPitch + lane;
      if (line < lines) {
        const unsigned sa = (unsigned)__cvta_generic_to_shared(dst);
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(sa),
                     "l"(g + base + j * inner));
      } else {
        *dst = kInf;
      }
    }
  }
  asm volatile("cp.async.wait_all;\n" ::);
  __syncthreads();
}

// The integer path, for a line at unit sampling whose finite entries are
// integers in [0, 2^18) (exact in int32): Felzenszwalb & Huttenlocher's
// stack, each entry (c, v) with c = g + v^2, a top entry b going when its
// region (sep(a, b), sep(b, u)) is empty, the separators compared by
// integer cross-multiplication: no division lies between one element and
// the next. The line is cut into kBands bands, one thread each (PBA's
// banding, Cao et al. 2010): band_stack builds a band's stack in the
// band's own slots, merge_bands (one thread) joins them, band_fill writes
// each band's outputs over its g slots, which the entries make unneeded.
// The outputs are the scan's: g[v] + (i - v)^2, exact in fp32 below 2^24.

__device__ __forceinline__ uint32_t pack(int c, int v) {
  return (uint32_t)c | ((uint32_t)v << kCBits);
}

__device__ __forceinline__ bool pops(uint32_t a, uint32_t b, uint32_t u) {
  const int ca = a & kCMask, va = a >> kCBits, cb = b & kCMask, vb = b >> kCBits;
  const int cu = u & kCMask, vu = u >> kCBits;
  return (cu - cb) * (vb - va) <= (cb - ca) * (vu - vb);
}

// The stack of the sites in [b0, b1), in slots b0..; returns its top slot
// (b0 - 1 when empty), or clears `ok` at the first finite entry that is not
// an integer in [0, 2^18). One event an iteration, a pop or the next
// element, so the lanes of a warp diverge only within an iteration; the top
// two entries live in registers, so a pop test never waits on shared
// memory.
__device__ __forceinline__ int band_stack(const float* G, uint32_t* S, int b0,
                                          int b1, bool& ok) {
  int k = b0 - 1;
  uint32_t a = 0, b = 0;                        // slots k - 1 and k
  int u = b0;
  float gu = u < b1 ? G[u * kPitch] : kInf;
  while (u < b1) {
    if (gu < kInf) {
      if (!(gu >= 0.0f && gu < kIntMax && gu == rintf(gu))) {
        ok = false;
        return k;
      }
      const uint32_t e = pack((int)gu + u * u, u);
      if (k > b0 && pops(a, b, e)) {
        b = a;
        if (--k > b0) a = S[(k - 1) * kPitch];
        continue;
      }
      S[++k * kPitch] = e;
      a = b;
      b = e;
    }
    if (++u < b1) gu = G[u * kPitch];
  }
  return k;
}

// Joins the band stacks of one line into one: the slots of band b's
// entries are lo[b]..hi[b] (columns of kLanes); band b's entries are pushed
// in turn onto the stack of the bands before it, popping as FH pops, until
// one lands on its own band neighbour: from there on the band's stack is
// what it was alone, so the rest is kept in place. The result is at most
// kBands contiguous segments of slots.
__device__ void merge_bands(const uint32_t* S, int* lo, int* hi) {
  for (int b = 1; b < kBands; ++b) {
    const int m_lo = lo[b * kLanes], m_hi = hi[b * kLanes];
    hi[b * kLanes] = m_lo - 1;
    for (int j = m_lo; j <= m_hi; ++j) {
      const uint32_t e = S[j * kPitch];
      for (;;) {
        int tb = b;
        while (tb >= 0 && hi[tb * kLanes] < lo[tb * kLanes]) --tb;
        if (tb < 0) break;
        const int t = hi[tb * kLanes];
        int sec = t - 1;
        if (sec < lo[tb * kLanes]) {
          int sb = tb - 1;
          while (sb >= 0 && hi[sb * kLanes] < lo[sb * kLanes]) --sb;
          if (sb < 0) break;                    // the bottom never goes
          sec = hi[sb * kLanes];
        }
        if (!pops(S[sec * kPitch], S[t * kPitch], e)) break;
        --hi[tb * kLanes];
      }
      if (hi[b * kLanes] == j - 1 && j - 1 >= lo[b * kLanes]) {
        hi[b * kLanes] = m_hi;                  // on its band neighbour
        break;
      }
      lo[b * kLanes] = j;
      hi[b * kLanes] = j;
    }
  }
}

// The outputs of positions [b0, b1) from the joined stack: a binary search
// for the entry covering b0, then a walk up the stack.
__device__ void band_fill(float* G, const uint32_t* S, const int* lo,
                          const int* hi, int b0, int b1) {
  if (b0 >= b1) return;
  int first[kBands], count[kBands], total = 0;
#pragma unroll
  for (int b = 0; b < kBands; ++b) {
    first[b] = lo[b * kLanes];
    count[b] = max(hi[b * kLanes] - first[b] + 1, 0);
    total += count[b];
  }
  if (total == 0) {
    for (int i = b0; i < b1; ++i) G[i * kPitch] = kInf;
    return;
  }
  // slot of the r-th entry of the joined stack
  auto slot_of = [&](int r) {
    int sl = 0;
#pragma unroll
    for (int b = 0; b < kBands; ++b) {
      if (r >= 0 && r < count[b]) sl = first[b] + r;
      r -= count[b];
    }
    return sl;
  };
  // the last entry strictly below the one before it at b0
  int lo_r = 0, hi_r = total - 1;
  while (lo_r < hi_r) {
    const int mid = (lo_r + hi_r + 1) >> 1;
    const uint32_t e1 = S[slot_of(mid) * kPitch], e0 = S[slot_of(mid - 1) * kPitch];
    const int c1 = e1 & kCMask, v1 = e1 >> kCBits, c0 = e0 & kCMask, v0 = e0 >> kCBits;
    if (c1 - c0 < 2 * b0 * (v1 - v0)) lo_r = mid;
    else hi_r = mid - 1;
  }
  int r = lo_r;
  uint32_t e = S[slot_of(r) * kPitch];
  int cj = e & kCMask, vj = e >> kCBits, cn = 0, vn = 0;
  if (r + 1 < total) {
    e = S[slot_of(r + 1) * kPitch];
    cn = e & kCMask;
    vn = e >> kCBits;
  }
  for (int i = b0; i < b1; ++i) {
    while (r + 1 < total && cn - cj < 2 * i * (vn - vj)) {
      cj = cn;
      vj = vn;
      if (++r + 1 < total) {
        e = S[slot_of(r + 1) * kPitch];
        cn = e & kCMask;
        vn = e >> kCBits;
      }
    }
    G[i * kPitch] = fminf(kInf, cand((float)(cj - vj * vj), i, vj, 1.0f));
  }
}

// A line outside the integer path's preconditions: Meijster's walk with
// the separator from one fp32 division, by one thread; the output is written
// over the stack.
__device__ __forceinline__ void envelope_float(const float* G, uint32_t* S,
                                               int n, float s) {
  const float s2 = __fmul_rn(s, s);
  // The stack: entries 0..k as (vertex | start << 16). Its top (tv, tt, tg)
  // and the entry below it (sv, sq, sg) live in registers, so a pop test
  // never waits on shared memory; a pop refills the lower one.
  int k = -1, tv = 0, tt = 0, sv = 0, sq = 0;
  float tg = kInf, sg = kInf;
  // One event an iteration, a pop or the next element, so the lanes of a
  // warp diverge only within an iteration: the warp runs as many
  // iterations as its busiest line has events (at most 2n).
  int u = 0;
  float gu = G[0];
  while (u < n) {
    const bool finite = gu < kInf;            // sentinels never enter
    if (finite && k >= 0 && cand(gu, tt, u, s) < cand(tg, tt, tv, s)) {
      // u beats the top at the start of its region: pop it
      tv = sv;
      tt = sq;
      tg = sg;
      if (--k >= 1) {
        const uint32_t e = S[(k - 1) * kPitch];
        sv = e & 0xffff;
        sq = e >> 16;
        sg = G[sv * kPitch];
      }
      continue;
    }
    if (finite) {
      int w = 0;
      bool push = true;
      if (k >= 0) {
        // u is strictly below the top for i > x; w is the first such integer
        const float num = __fadd_rn(__fsub_rn(gu, tg),
                                    __fmul_rn(s2, (float)(u * u - tv * tv)));
        const float x = __fdiv_rn(num, __fmul_rn(s2, (float)(2 * (u - tv))));
        if (x < (float)n) {
          w = max(__float2int_rd(x) + 1, tt + 1);
          push = w < n;
        } else {
          push = false;                       // u never surfaces in [0, n)
        }
      }
      if (push) {
        S[++k * kPitch] = (uint32_t)u | ((uint32_t)w << 16);
        sv = tv;
        sq = tt;
        sg = tg;
        tv = u;
        tt = w;
        tg = gu;
      }
    }
    if (++u < n) gu = G[u * kPitch];
  }
  // fill from the right: out[u] over stack slot u (slots < u still hold
  // entries 0..k, all at or left of their starts); the entry below the
  // current one is loaded ahead
  if (k < 0) {
    for (int i = 0; i < n; ++i) S[i * kPitch] = __float_as_uint(kInf);
  } else {
    for (int i = n - 1; i >= 0; --i) {
      S[i * kPitch] = __float_as_uint(fminf(kInf, cand(tg, i, tv, s)));
      if (i == tt && k > 0) {
        tv = sv;
        tt = sq;
        tg = sg;
        if (--k >= 1) {
          const uint32_t e = S[(k - 1) * kPitch];
          sv = e & 0xffff;
          sq = e >> 16;
          sg = G[sv * kPitch];
        }
      }
    }
  }
}

__global__ void __launch_bounds__(kLanes * kBands)
    edt_envelope_kernel(const float* __restrict__ g, float* __restrict__ out,
                        long long lines, int n, long long inner, float s) {
  extern __shared__ uint32_t smem[];
  __shared__ int seg_lo[kBands * kLanes], seg_hi[kBands * kLanes];
  __shared__ int int_band[kBands * kLanes];
  __shared__ unsigned int_lanes;
  float* gt = reinterpret_cast<float*>(smem);  // [n][kPitch]  g
  uint32_t* st = smem + n * kPitch;             // [n][kPitch]  the stack
  const long long line0 = (long long)blockIdx.x * kLanes;
  stage_in_async<kBands>(g, gt, line0, lines, n, inner);

  const int lane = threadIdx.x % kLanes, band = threadIdx.x / kLanes;
  float* G = gt + lane;
  uint32_t* S = st + lane;
  const int b0 = band * n / kBands, b1 = (band + 1) * n / kBands;
  int* lo = seg_lo + lane;
  int* hi = seg_hi + lane;
  // each band's stack; a line leaves the integer path if a band finds an
  // entry outside its preconditions
  bool ok = s == 1.0f;
  lo[band * kLanes] = b0;
  if (ok) hi[band * kLanes] = band_stack(G, S, b0, b1, ok);
  int_band[band * kLanes + lane] = ok;
  __syncthreads();
  bool int_line = true;
#pragma unroll
  for (int b = 0; b < kBands; ++b) int_line &= int_band[b * kLanes + lane] != 0;
  if (band == 0) {
    const unsigned m = __ballot_sync(0xffffffffu, int_line);
    if (lane == 0) int_lanes = m;
  }
  if (band == 0) {
    if (int_line) merge_bands(S, lo, hi);
    else envelope_float(G, S, n, s);
  }
  __syncthreads();
  if (int_line) band_fill(G, S, lo, hi, b0, b1);
  // integer lines wrote their output over the g tile, the others over the
  // stack tile
  stage_out<kBands>(out, st, reinterpret_cast<const uint32_t*>(gt), int_lanes,
                    line0, lines, n, inner);
}

__global__ void __launch_bounds__(kLanes * kBands)
    edt_mask_kernel(const uint8_t* __restrict__ mask, float* __restrict__ out,
                    long long lines, int n, long long inner, float s) {
  extern __shared__ uint32_t smem[];
  __shared__ int first_false[kBands * kLanes], last_false[kBands * kLanes];
  int* dt = reinterpret_cast<int*>(smem);   // [n][kPitch]: mask, then distances
  const long long line0 = (long long)blockIdx.x * kLanes;
  stage_in<kBands>(mask, dt, line0, lines, n, inner, 1,
                   [](uint8_t m) { return m ? 1 : 0; });
  const int lane = threadIdx.x % kLanes, band = threadIdx.x / kLanes;
  const int b0 = band * n / kBands, b1 = (band + 1) * n / kBands;
  int* D = dt + lane;
  // each band's first and last False; a band then starts its sweeps from
  // the nearest False of the bands beside it
  int mine_first = kFar, mine_last = -kFar;
  for (int u = b0; u < b1; ++u) {
    if (D[u * kPitch] == 0) {
      mine_first = min(mine_first, u);
      mine_last = u;
    }
  }
  first_false[band * kLanes + lane] = mine_first;
  last_false[band * kLanes + lane] = mine_last;
  __syncthreads();
  int last = -kFar, next = 2 * kFar;
#pragma unroll
  for (int b = 0; b < kBands; ++b) {
    if (b < band) last = max(last, last_false[b * kLanes + lane]);
  }
#pragma unroll
  for (int b = kBands - 1; b >= 0; --b) {
    if (b > band && first_false[b * kLanes + lane] < kFar)
      next = first_false[b * kLanes + lane];
  }
  // forward: distance to the nearest False at or left of u (0 at a False)
  for (int u = b0; u < b1; ++u) {
    if (D[u * kPitch] == 0) last = u;
    D[u * kPitch] = min(u - last, kFar);
  }
  // backward: the nearer side, evaluated as the scan evaluates it
  uint32_t* O = reinterpret_cast<uint32_t*>(D);
  for (int u = b1 - 1; u >= b0; --u) {
    const int left = D[u * kPitch];
    if (left == 0) next = u;
    const int d = min(left, next - u);
    const float v = d >= kFar ? kInf : fminf(kInf, cand(0.0f, d, 0, s));
    O[u * kPitch] = __float_as_uint(v);
  }
  stage_out<kBands>(out, reinterpret_cast<uint32_t*>(dt), nullptr, 0u, line0,
                    lines, n, inner);
}

template <typename T>
int launch(void (*kernel)(const T*, float*, long long, int, long long, float),
           int threads, int tiles, const void* in, void* out, long long outer,
           int n, long long inner, float s, void* stream) {
  const long long lines = outer * inner;
  if (lines == 0 || n == 0) return 0;
  const int smem = tiles * n * kPitch * 4;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (lines + kLanes - 1) / kLanes;
  kernel<<<(unsigned)blocks, threads, smem, (cudaStream_t)stream>>>(
      (const T*)in, (float*)out, lines, n, inner, s);
  return (int)cudaGetLastError();
}

}  // namespace

// out = envelope of g along the middle axis of [outer, n, inner]; both
// contiguous fp32 on the current device, out not aliasing g. Launches on
// `stream` and returns cudaGetLastError() (0 = success) without
// synchronising.
extern "C" int brats_edt_envelope(const void* g, void* out, long long outer,
                                  int n, long long inner, float sampling,
                                  void* stream) {
  return launch(edt_envelope_kernel, kLanes * kBands, 2, g, out, outer, n,
                inner, sampling, stream);
}

// out = envelope of where(mask, 1e12, 0) along the middle axis of
// [outer, n, inner]: `mask` contiguous bytes (0 = False), out contiguous
// fp32. Same launch contract as brats_edt_envelope.
extern "C" int brats_edt_envelope_mask(const void* mask, void* out,
                                       long long outer, int n, long long inner,
                                       float sampling, void* stream) {
  return launch(edt_mask_kernel, kLanes * kBands, 1, mask, out, outer, n,
                inner, sampling, stream);
}

extern "C" const char* brats_edt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
