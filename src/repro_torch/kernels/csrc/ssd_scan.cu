// The Mamba-2 SSD scan for Hopper (sm_90a): the forward pass and a
// deterministic backward, f32 arithmetic throughout on f32 or bf16 inputs.
//
// Layout.  x: (B, S, H, P); dt: (B, S, H); Bm, Cm: (B, S, G, N) with head h
// reading group h / (H / G); y, dy, dx: (B, S, H, P); A: (copies, H) f32,
// copy c owning the per_copy consecutive sequences c*per_copy .. — the
// port's per-(row, device) parameter copies, flattened into the batch.
// x, Bm and Cm may be slices of the channels of one wider tensor (the conv
// output): each is addressed as token rows with its own row stride (ldx,
// ldb, ldc elements between consecutive tokens), its (heads, width) block
// packed.  dt, dy and every output are contiguous.
//
// ssd_fwd_kernel (replaces kernels/ssd_scan.py::_ssd_kernel of the TPU
// package)
//   y of the recurrence
//     h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t^T   (P x N, from zero)
//     y_t = h_t C_t
//   in its dual (quadratic) form within tiles of kTile tokens, as the TPU
//   kernel does within its chunk.  With a_t = exp(dt_t A_h), D(t, s) =
//   a_{s+1} ... a_t (running products, as in the backward) and CB[t, s] =
//   C_t . B_s (once a (sequence, group, tile) for all of the group's
//   heads):
//     W_h[t, s] = D(t, s) CB[t, s] dt_s          (s <= t)
//     y[t, (h, p)] = sum_{s <= t} W_h[t, s] x[s, (h, p)]   (s in order).
//   The state crosses tiles only when S > kTile: a tile first adds pre(t)
//   C_t . h_in to y (pre(t) = a_{t0} ... a_t), then leaves h_out =
//   pre(last) h_in + sum_s post(s) dt_s x_s B_s^T (post(s) = a_{s+1} ...
//   a_last; s in order).  At the mamba2 cell's S 16 no state exists.
//   Every term is a direct sum of products.  x, B and C in f32 or bf16,
//   dt in f32 (as the reference's scan reads it), f32 inside, y in x's
//   type.  It needs no chunk size: any S runs (the
//   TPU kernel asserts S % chunk == 0).  N up to 128.
//
//   Mapping.  A persistent grid (as many CTAs an SM as the occupancy query
//   admits, asked once a device) walks units in a fixed stride: (sequence,
//   group, a block of up to 32 heads, or of p values of one head where P
//   is wide) of up to 256 (head, p) rows, a unit's tiles in order.  A
//   two-stage shared-memory ring holds a step's x tile, dt, B and C,
//   filled by 16-byte cp.async (4-byte, or plain copies of bf16, where a
//   row is not aligned); the next step's copies are in flight while this
//   one computes.  A step computes a and CB, then the heads' W,
//   transposed and packed in 16-byte groups of t (rows at an odd count of
//   groups, against bank conflicts), then y: a thread owns four rows of
//   one head (one row where P % 4 != 0) at four consecutive tokens, and a
//   source token s costs it one 16-byte read of x, one of W and 16 FMAs;
//   y leaves in 16-byte stores.  A state (S >
//   kTile) lives in registers, 16 values of N a thread (units of 4096 / N
//   rows there).  No atomics, and a unit's arithmetic reads its own
//   sequence alone: bitwise reproducible and batch-invariant.
// ssd_bwd_kernel (no TPU counterpart: the TPU package has no backward)
//   The gradient of that recurrence, given dy.  With u_t = dt_t x_t, a_t =
//   exp(dt_t A_h), D(t, s) = a_{s+1} ... a_t and the adjoint g_t = dL/dh_t
//   = a_{t+1} g_{t+1} + dy_t C_t^T:
//     dx_s = dt_s (g_s B_s)              dB_s = sum_{h, p} u_s g_s
//     dC_t = sum_{h, p} dy_t h_t         d log a_t = a_t sum_{p, n} g_t h_{t-1}
//     ddt_s = x_s . (g_s B_s) + A_h d log a_s,   dA_h = sum_t dt_t d log a_t.
//   It never holds a state per (row, token).  Within a segment of kSeg
//   tokens it expands g and h into their sums over token pairs s <= t
//   (the dual form), per head, with K[t, s] = dy_t . x_s (over p), CB[t, s]
//   = C_t . B_s and W[t, s] = D(t, s) dt_s K[t, s]:
//     dx_s = dt_s sum_{t >= s} D(t, s) CB[t, s] dy_t
//     dC_t = sum_{s <= t} (sum_h W[t, s]) B_s,  dB_s = sum_{t >= s} (sum_h
//     W[t, s]) C_t,  d log a_t = sum_{s < t <= t'} W[t', s] CB[t', s].
//   Every term is a direct sum of products: no difference of large sums,
//   and the decays are running products of a, as in the recurrence.
//   Across segments (S > kSeg) the state h at each segment end is written
//   to a workspace by a forward pass over the segments (pass 1), and the
//   backward pass over the segments (pass 2) carries a_{t0} g_{t0} from
//   one segment to the one before; both add their boundary terms (dC from
//   the state entering the segment, dB and dx from the carry, and three
//   terms of d log a).  At S <= kSeg (the mamba2 cell) pass 1 does not run
//   and no state exists.  x, B, C and dy in f32 or bf16 (read as f32), dt
//   in f32; dx, dB and dC are written in f32 (the wrapper rounds them to
//   the inputs' type).  N up to 128, P a power of two up to 128.
//
//   Mapping.  A group's heads go in blocks of up to kBlockRows (head, p)
//   rows: kSlots (head, p-chunk) slots x kSeg tokens, a thread per (slot,
//   token s), owning min(P, 8) p values of one head (P > 8: P / 8
//   neighbouring lanes share a head, and K is summed over them by
//   shuffles).  One 256-thread CTA owns a unit: a (sequence, group) whole
//   where the group has at most 512 (N <= 16), 256 (N <= 32) or 128 (head,
//   p) rows, else one head block of it (mamba2-2.7b's 80 heads of 64 at N
//   128: 40 units a sequence; zamba2-7b's 112 at N 64: 56), and walks its
//   blocks segment by segment; the workspace holds each unit's states and
//   carries, of its own rows.  Beyond one segment (its own instance, with
//   a 128-register budget) a step first copies its head block's rows of
//   the entering state and of the carry into shared memory (rows padded to
//   N + 1 floats against bank conflicts) with the coefficients Q[t][r] =
//   pre(t) dy_t and U[t][r] = post(t) dt_t x_t, and runs the boundary
//   terms as register-tiled products over them: a warp a token pair, its
//   lanes over rows for (a g) . B_t and h_start . C_t (then summed over a
//   head's rows by shuffles) and over n for dC and dB, and tiles of 4 rows
//   by 4 n for the carry and pass 1's states, so that each shared-memory
//   read feeds several FMAs.  Each step (segment,
//   head block) stages its x, dy and dt in shared memory with 16-byte
//   cp.async copies (4-byte where a row is not 16-byte aligned), issued as
//   soon as the step before has read its rows, so a step's loads overlap
//   the step before's reductions.  a_t = exp(dt_t A_h) is computed once
//   per (head, token) and CB once per (group, token pair) into shared
//   memory.  A thread's x_s and its dx accumulators sit in registers, its
//   terms of d log a in the head's matrix in shared memory; x, dt and dy
//   leave device memory once.
//
//   Reductions, each in a fixed order (no atomics: the backward is bitwise
//   reproducible, and a sequence's results, and a copy's dA, do not depend
//   on what else shares the launch):
//     K over a head's p-chunks: xor shuffles over P / 8 lanes;
//     sum_h W: per (t, s), over the heads of a block in head order, then
//       over the blocks in order, in a register of its thread;
//     d log a_t: per head, over s < t in order of s of the suffix sums
//       over t' >= t (each a sum in descending t'), then the boundary
//       terms;
//     dB, dC: per (token, n), over the tokens of the segment in order,
//       then the boundary sums (over the rows in order, head block by head
//       block); with several units a group, each unit writes its partial
//       and ssd_dbc_reduce_kernel sums them in unit order;
//     dA: per (sequence, head), dt_t d log a_t in f64, over the 16 tokens
//       of a segment by xor shuffles, then over the segments in order;
//       ssd_dA_reduce_kernel sums the per-sequence partials per copy in
//       sequence order.
//
// Bound.  At the port's shapes (S 16, H 64, P 8, N 16) both kernels are
// bound by their bytes (each reads its inputs once and writes its outputs
// once, 3.35 TB/s on an H100 SXM).  The forward's dual form does 136
// FMAs a (head, p) row of a 16-token tile, against the recurrence's 528,
// and keeps a CTA's next unit (20 KB at the cell's shape) in flight while
// it computes; at 71 168 bytes of shared memory three CTAs share an SM.
// The recurrence it replaced kept one 4-byte load of x a warp in flight,
// behind a dependent loop.  The backward's dual form does ~3 f32
// operations for each byte it must move; the recurrence it replaced did
// ~17 and waited on shuffles, so it was latency-bound at one 512-thread
// CTA an SM.  At 49 792 bytes of shared memory (N 16, 64 heads a group)
// and at most 64 registers a thread, four CTAs (32 warps) are resident on
// an SM, and their staged copies keep the memory busy.  Beyond one
// segment the boundary terms' operations bound it (~12 N a (token, row)):
// at mamba2-2.7b's layer (one 4096-token sequence, 40 units) the 227 KB
// of shared memory a CTA holds one CTA an SM on 40 of the 132.
//
// C interface (bound with ctypes): every entry point launches on the given
// stream, does not synchronise, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 16;          // tokens of a forward tile
constexpr unsigned kFull = 0xffffffffu;
constexpr int kBadShape = -1;      // a shape the kernels do not take

constexpr int kSeg = 16;           // tokens of a backward segment
constexpr int kSlots = 16;         // (head, p-chunk) slots of a head block
constexpr int kBwdThreads = kSeg * kSlots;
constexpr int kChunk = 8;          // p values a backward thread owns
constexpr int kBlockRows = 128;    // (head, p) rows of a head block
constexpr int kHeadMat = kSeg * kSeg + 1;   // a head's kSeg x kSeg, padded
// CTAs an SM the backward's register budget is set for: one segment (S
// <= kSeg) in f32, 64 registers a thread; in bf16, 80; beyond one
// segment, 128 (its staged rows hold it to 1-3 CTAs an SM anyway)
constexpr int kBwdBlocksPerSM = 4;
constexpr int kBwdBlocksPerSMBf16 = 3;
constexpr int kBwdBlocksPerSMMulti = 2;
constexpr int kBwdMaxState = 128;  // N the backward takes
constexpr int kBwdMaxP = 128;      // P the backward takes (kChunk x kSlots)

struct Dims {
  int B, S, H, P, G, N;
  int per_copy;                    // sequences per copy of A
  long long ldx, ldb, ldc;         // elements between consecutive tokens
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Sum over aligned segments of `width` lanes (a power of two <= 32); every
// lane of a segment gets the segment's sum.
__device__ __forceinline__ float seg_sum(float v, int width) {
  for (int off = width >> 1; off > 0; off >>= 1)
    v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// ---- copies into shared memory (both kernels) ---------------------------

constexpr int kThreads = 256;        // threads of a CTA, in both kernels

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Copy `rows` rows of `cols` elements (row r at src + r * ld) into dst (row
// stride dst_ld) as cp.async copies of BYTES each.
template <int BYTES, typename T>
__device__ __forceinline__ void copy_chunks(T* dst, int dst_ld, const T* src,
                                            long long ld, int rows,
                                            int cols) {
  constexpr int PER = BYTES / static_cast<int>(sizeof(T));
  const int q = cols / PER, tid = threadIdx.x;
  auto one = [&](int r, int v) {
    const unsigned to = smem_u32(dst + r * dst_ld + v * PER);
    const T* from = src + r * ld + v * PER;
    if constexpr (BYTES == 16)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(to),
                   "l"(from));
    else
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(to),
                   "l"(from));
  };
  if (q > 0 && kThreads % q == 0) {      // a fixed chunk of a row a thread
    const int sh = __ffs(q) - 1;          // q is a power of two here
    for (int r = tid >> sh; r < rows; r += kThreads >> sh)
      one(r, tid & (q - 1));
  } else {
    for (int e = tid; e < rows * q; e += kThreads) one(e / q, e % q);
  }
}

// The same, 16 bytes a copy where every row is 16-byte aligned in both
// places, else 4, else (bf16 at odd offsets) plain copies.  The caller
// commits and waits.
template <typename T>
__device__ __forceinline__ void copy_tile_async(T* dst, int dst_ld,
                                                const T* src, long long ld,
                                                int rows, int cols) {
  constexpr long long kE = sizeof(T);
  const long long lay =
      static_cast<long long>(reinterpret_cast<uintptr_t>(src) |
                             reinterpret_cast<uintptr_t>(dst)) |
      (ld * kE) | (dst_ld * kE) | (cols * kE);
  if ((lay & 15) == 0) {
    copy_chunks<16>(dst, dst_ld, src, ld, rows, cols);
  } else if ((lay & 3) == 0) {
    copy_chunks<4>(dst, dst_ld, src, ld, rows, cols);
  } else {
    for (int e = threadIdx.x; e < rows * cols; e += kThreads)
      dst[(e / cols) * dst_ld + e % cols] = src[(e / cols) * ld + e % cols];
  }
}

// ---- backward ----------------------------------------------------------

static_assert(kBwdThreads == kThreads, "one thread count for the copies");

// n (<= kChunk) values from shared memory as f32 into v, zeros past n;
// one 16-byte load (bf16) or two (f32) when n is 8 (p is then a multiple
// of 8, so the row is aligned).
__device__ __forceinline__ void load_chunk(float (&v)[kChunk],
                                           const float* p, int n) {
  if (n == kChunk) {
    const float4 lo = *reinterpret_cast<const float4*>(p);
    const float4 hi = *reinterpret_cast<const float4*>(p + 4);
    v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
    v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
  } else {
#pragma unroll
    for (int i = 0; i < kChunk; ++i) v[i] = i < n ? p[i] : 0.f;
  }
}
__device__ __forceinline__ void load_chunk(float (&v)[kChunk],
                                           const __nv_bfloat16* p, int n) {
  if (n == kChunk) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < kChunk / 2; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < kChunk; ++i) v[i] = i < n ? to_f32(p[i]) : 0.f;
  }
}

// Shared memory of the backward (byte offsets): the fixed part at
// compile-time offsets (x and dy staged in the input type, in f32-sized
// slots), then B, C and the boundary sums (kSeg x N f32 each), with S >
// kSeg a head block's rows of the entering state and of the carry
// (kBlockRows x (N + 1) f32 each, rows padded against bank conflicts) and
// the boundary products' coefficients Q and U (kSeg x kBlockRows f32
// each), and dA (the group's heads, f64).
constexpr int kOffD2 = 0;                          // f64 (head, token)
constexpr int kOffX = kOffD2 + 8 * kSlots * kSeg;  // (token, block row)
constexpr int kOffDY = kOffX + 4 * kSeg * kBlockRows;
constexpr int kOffDt = kOffDY + 4 * kSeg * kBlockRows;  // 2 x (token, head)
constexpr int kOffA = kOffDt + 8 * kSeg * kSlots;       // (token, head) ...
constexpr int kOffPre = kOffA + 4 * kSeg * kSlots;
constexpr int kOffPost = kOffPre + 4 * kSeg * kSlots;
constexpr int kOffXd = kOffPost + 4 * kSeg * kSlots;
constexpr int kOffQ = kOffXd + 4 * kSeg * kSlots;
constexpr int kOffT3 = kOffQ + 4 * kSeg * kSlots;
constexpr int kOffCB = kOffT3 + 4 * kSeg * kSlots;      // (t, s)
constexpr int kOffWg = kOffCB + 4 * kSeg * kSeg;
constexpr int kOffK4 = kOffWg + 4 * kSeg * kSeg;        // (head)
constexpr int kOffM = kOffK4 + 4 * kSlots;              // (head, kHeadMat)
constexpr int kOffB = kOffM + 4 * kSlots * kHeadMat;    // then C, sums, dA
static_assert(kOffB % 16 == 0, "the N-sized arrays stay 16-byte aligned");

__host__ __device__ constexpr int bwd_staged_floats(int N, bool staged) {
  return staged ? 2 * kBlockRows * (N + 1) + 2 * kSeg * kBlockRows : 0;
}
__host__ __device__ constexpr int bwd_smem_bytes(int hg, int N, bool staged) {
  return kOffB + 4 * (4 * kSeg * N + bwd_staged_floats(N, staged)) + 8 * hg;
}

// The partition of a group's (head, p) rows into units, fixed by H, P, G
// and N: head blocks of `heads` heads (kSlots slots of min(P, 8) p
// values), and units of up to `bpu` head blocks, at most 512 (N <= 16),
// 256 (N <= 32) or 128 rows (a whole head block where it is wider).  A
// group within that many rows is one unit.
struct BwdPlan {
  int heads;     // heads of a head block
  int nhb;       // head blocks of a group
  int bpu;       // head blocks of a unit, at most
  int units;     // units of a group
  int urows;     // (head, p) rows of a unit, at most
};

BwdPlan bwd_plan(int H, int P, int G, int N) {
  BwdPlan pl;
  const int hg = H / G, nc = P >= kChunk ? P / kChunk : 1;
  pl.heads = kSlots / nc;
  pl.nhb = (hg + pl.heads - 1) / pl.heads;
  const int most = N <= 16 ? 512 : N <= 32 ? 256 : 128;
  pl.bpu = max(1, most / (pl.heads * P));
  pl.units = (pl.nhb + pl.bpu - 1) / pl.bpu;
  pl.urows = min(hg, pl.bpu * pl.heads) * P;
  return pl;
}

// kWide: P >= 8, every chunk is 8 p values; kMulti: S > kSeg, states
// and carries cross the segments (pass 1 and the boundary terms)
template <typename T, bool kWide, bool kMulti>
__global__ void __launch_bounds__(kBwdThreads,
                                  kMulti             ? kBwdBlocksPerSMMulti
                                  : sizeof(T) == 2 ? kBwdBlocksPerSMBf16
                                                     : kBwdBlocksPerSM)
    ssd_bwd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                   const float* __restrict__ A, const T* __restrict__ Bm,
                   const T* __restrict__ Cm, const T* __restrict__ dy,
                   float* __restrict__ dx, float* __restrict__ ddt,
                   double* __restrict__ dA_part, float* __restrict__ dB_out,
                   float* __restrict__ dC_out, float* __restrict__ ws, Dims d,
                   BwdPlan pl) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int hg = d.H / d.G, N = d.N;
  double* sD2 = reinterpret_cast<double*>(smem + kOffD2);
  T* sX = reinterpret_cast<T*>(smem + kOffX);
  T* sDY = reinterpret_cast<T*>(smem + kOffDY);
  float* sDt = reinterpret_cast<float*>(smem + kOffDt);
  float* sA = reinterpret_cast<float*>(smem + kOffA);
  float* sPre = reinterpret_cast<float*>(smem + kOffPre);
  float* sPost = reinterpret_cast<float*>(smem + kOffPost);
  float* sXd = reinterpret_cast<float*>(smem + kOffXd);
  float* sQ = reinterpret_cast<float*>(smem + kOffQ);
  float* sT3 = reinterpret_cast<float*>(smem + kOffT3);
  float* sCB = reinterpret_cast<float*>(smem + kOffCB);
  float* sWg = reinterpret_cast<float*>(smem + kOffWg);
  float* sK4 = reinterpret_cast<float*>(smem + kOffK4);
  float* sM = reinterpret_cast<float*>(smem + kOffM);  // per head: W[t][s]
                                      // at t >= s, suffix sums at s < t
  float* sB = reinterpret_cast<float*>(smem + kOffB);  // (token, n)
  float* sC = sB + kSeg * N;
  float* sAccB = sC + kSeg * N;
  float* sAccC = sAccB + kSeg * N;
  const int nseg = kMulti ? (d.S + kSeg - 1) / kSeg : 1, lds = N + 1;
  float* sH0 = sAccC + kSeg * N;          // with nseg > 1: the block's
  float* sCin = sH0 + kBlockRows * lds;   // rows of h_start and the carry,
  float* sQc = sCin + kBlockRows * lds;   // Q[t][r] = pre(t) dy_t[r],
  float* sUc = sQc + kSeg * kBlockRows;   // U[t][r] = post(t) dt_t x_t[r]
  double* sDA = reinterpret_cast<double*>(
      sAccC + kSeg * N + bwd_staged_floats(N, nseg > 1));

  const int w8 = kWide ? kChunk : d.P, nc = kWide ? d.P / kChunk : 1;
  const int heads = pl.heads;
  // this CTA's unit: (sequence, group) and its head blocks [hb0, hb0 + nhb)
  const int unit = blockIdx.x % pl.units, bg = blockIdx.x / pl.units;
  const int b = bg / d.G, g = bg % d.G;
  const int hb0 = unit * pl.bpu, nhb = min(pl.bpu, pl.nhb - hb0);
  const int copy = b / d.per_copy;
  const int tid = threadIdx.x, s = tid / kSlots, q = tid % kSlots;
  const int c = q % nc, j = q / nc;            // slot: head j, p-chunk c
  const int psh = __ffs(d.P) - 1;              // log2 P: a row's head
  const int warp = tid >> 5, lane = tid & 31;
  const int col = j * d.P + c * w8;            // the chunk in a staged row
  // the workspace (S > kSeg): the state of the unit's rows at the end of
  // each segment but the last, for each CTA, then two carry slots for each
  const long long state = static_cast<long long>(pl.urows) * N;
  auto state_at = [&](int seg) {
    return ws + (static_cast<long long>(blockIdx.x) * (nseg - 1) + seg) *
                    state;
  };
  auto carry_at = [&](int seg) {
    return ws + (static_cast<long long>(gridDim.x) * (nseg - 1) +
                 2LL * blockIdx.x + (seg & 1)) * state;
  };

  auto stage = [&](int seg, int hb, bool with_dy, int buf) {
    const int t0 = seg * kSeg, n_t = min(kSeg, d.S - t0);
    const int h0 = g * hg + hb * heads, nh = min(heads, hg - hb * heads);
    const long long tok = static_cast<long long>(b) * d.S + t0;
    copy_tile_async(sX, kBlockRows, x + tok * d.ldx + h0 * d.P, d.ldx, n_t,
                    nh * d.P);
    if (with_dy)
      copy_tile_async(sDY, kBlockRows, dy + (tok * d.H + h0) * d.P,
                      static_cast<long long>(d.H) * d.P, n_t, nh * d.P);
    copy_tile_async(sDt + buf * kSeg * kSlots, kSlots, dt + tok * d.H + h0,
                    static_cast<long long>(d.H), n_t, nh);
    asm volatile("cp.async.commit_group;\n" ::);
  };
  auto wait_stage = [] { asm volatile("cp.async.wait_all;\n" ::: "memory"); };
  // a = exp(dt A) of the block's heads; with `both`, the decays from the
  // segment's start, pre(t) = a_0 ... a_t, and to its end, post(t) =
  // a_{n_t - 1} ... a_{t + 1} (products in those orders)
  auto decays = [&](const float* sdt, int hbase, int nh, int n_t, bool both) {
    const int t = tid / kSlots, jj = tid % kSlots;
    if (t < n_t && jj < nh)
      sA[tid] = expf(sdt[tid] * A[copy * d.H + hbase + jj]);
    __syncthreads();
    if (both) {
      if (t < n_t && jj < nh) {
        float pre = 1.f, post = 1.f;
        for (int k = 0; k <= t; ++k) pre *= sA[k * kSlots + jj];
        for (int k = n_t - 1; k > t; --k) post *= sA[k * kSlots + jj];
        sPre[tid] = pre;
        sPost[tid] = post;
      }
      __syncthreads();
    }
  };

  // Q[t][r] (with_q) and U[t][r] of the block's first nrow rows, 0 at t >=
  // n_t: the coefficients of the boundary products, one a (token, row)
  auto fill_coefs = [&](const float* sdt, int n_t, int nrow, bool with_q) {
    for (int e = tid; e < kSeg * nrow; e += kBwdThreads) {
      const int t = e / nrow, r = e - t * nrow, jj = r >> psh;
      const bool in = t < n_t;
      if (with_q)
        sQc[t * kBlockRows + r] =
            in ? sPre[t * kSlots + jj] * to_f32(sDY[t * kBlockRows + r]) : 0.f;
      sUc[t * kBlockRows + r] =
          in ? sPost[t * kSlots + jj] *
                   (sdt[t * kSlots + jj] * to_f32(sX[t * kBlockRows + r]))
             : 0.f;
    }
  };
  // out[r][n] = sum_{t < n_t} coef[t][r] M[t][n] (t in order) for the
  // block's rows r < nrow, handed to epi(r, n, out): warp w takes rows 16 w
  // .. 16 w + 15, four at a time, a lane n = lane + 32 m, so a coefficient
  // read serves four n and a row of M four rows
  auto row_products = [&](const float* coef, const float* M, int n_t,
                          int nrow, auto&& epi) {
#pragma unroll 1
    for (int r0 = 16 * warp; r0 < min(nrow, 16 * warp + 16); r0 += 4) {
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int m = 0; m < 4; ++m) acc[i][m] = 0.f;
#pragma unroll 1
      for (int t = 0; t < n_t; ++t) {
        float cf[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) cf[i] = coef[t * kBlockRows + r0 + i];
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const int n = lane + 32 * m;
          const float mv = n < N ? M[t * N + n] : 0.f;
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][m] = fmaf(cf[i], mv, acc[i][m]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int m = 0; m < 4; ++m)
          if (r0 + i < nrow && lane + 32 * m < N)
            epi(r0 + i, lane + 32 * m, acc[i][m]);
    }
  };

  // ---- pass 1 (S > kSeg): the state at the end of each segment ----------
  for (int seg = 0; kMulti && seg < nseg - 1; ++seg) {   // full segments
    const long long tok0 = static_cast<long long>(b) * d.S + seg * kSeg;
    for (int hb = hb0; hb < hb0 + nhb; ++hb) {
      const int hbase = g * hg + hb * heads, nh = min(heads, hg - hb * heads);
      __syncthreads();
      stage(seg, hb, false, 0);
      if (hb == hb0)
        for (int e = tid; e < kSeg * N; e += kBwdThreads)
          sB[e] = to_f32(Bm[(tok0 + e / N) * d.ldb + g * N + e % N]);
      wait_stage();
      __syncthreads();
      decays(sDt, hbase, nh, kSeg, true);
      // h_end = pre(last) h_start + sum_s post(s) u_s B_s
      const long long rbase = static_cast<long long>(hb - hb0) * heads * d.P;
      const int nrow = nh * d.P;
      fill_coefs(sDt, kSeg, nrow, false);
      __syncthreads();
      row_products(sUc, sB, kSeg, nrow, [&](int r, int n, float v) {
        const long long at = (rbase + r) * N + n;
        if (seg > 0)
          v = fmaf(sPre[(kSeg - 1) * kSlots + (r >> psh)],
                   state_at(seg - 1)[at], v);
        state_at(seg)[at] = v;
      });
    }
  }

  // ---- pass 2: the segments backward, head block by head block ----------
  for (int e = tid; e < hg; e += kBwdThreads) sDA[e] = 0.0;
  float wacc = 0.f;                  // sum_h W[t][s] of (t, s) = (s, q)
  const int nsteps = nseg * nhb;
  __syncthreads();
  stage(nseg - 1, hb0, true, 0);
  for (int k = 0; k < nsteps; ++k) {
    const int seg = nseg - 1 - k / nhb, hb = hb0 + k % nhb;
    const int t0 = seg * kSeg, n_t = min(kSeg, d.S - t0);
    const int hbase = g * hg + hb * heads, nh = min(heads, hg - hb * heads);
    const bool has_h0 = seg > 0, has_carry = seg < nseg - 1;
    const float* sdt = sDt + (k & 1) * kSeg * kSlots;
    const long long tok0 = static_cast<long long>(b) * d.S + t0;
    const long long rbase = static_cast<long long>(hb - hb0) * heads * d.P;

    wait_stage();
    __syncthreads();
    if (hb == hb0) {          // the segment's B, C and C_t . B_s
      for (int e = tid; e < kSeg * N; e += kBwdThreads) {
        const int t = e / N, n = e % N;
        const bool in = t < n_t;
        sB[e] = in ? to_f32(Bm[(tok0 + t) * d.ldb + g * N + n]) : 0.f;
        sC[e] = in ? to_f32(Cm[(tok0 + t) * d.ldc + g * N + n]) : 0.f;
        sAccB[e] = 0.f;
        sAccC[e] = 0.f;
      }
      __syncthreads();
      const int t = tid / kSeg, u = tid % kSeg;
      float v = 0.f;
      for (int n = 0; n < N; ++n) v = fmaf(sC[t * N + n], sB[u * N + n], v);
      sCB[tid] = v;
    }
    decays(sdt, hbase, nh, n_t, nseg > 1);

    // thread (s, head j, chunk c): the sums over t >= s
    const bool live = j < nh && s < n_t;
    {
      float xs[kChunk], du[kChunk], dyv[kChunk];
      load_chunk(xs, sX + s * kBlockRows + col, w8);
#pragma unroll
      for (int i = 0; i < kChunk; ++i) du[i] = 0.f;
      const float dts = live ? sdt[s * kSlots + j] : 0.f;
      float xd = 0.f, dcy = 1.f;
#pragma unroll 1
      for (int t = s & ~1; t < n_t; ++t) {   // uniform in a warp (s pairs)
        load_chunk(dyv, sDY + t * kBlockRows + col, w8);
        float kv = 0.f;
#pragma unroll
        for (int i = 0; i < kChunk; ++i) kv = fmaf(dyv[i], xs[i], kv);
        if (nc > 1) kv = seg_sum(kv, nc);
        if (t < s) continue;
        if (t > s) dcy *= sA[t * kSlots + j];
        const float cb = sCB[t * kSeg + s];
        const float w = dcy * dts * kv, f = dcy * cb;
        xd = fmaf(f, kv, xd);
#pragma unroll
        for (int i = 0; i < kChunk; ++i) du[i] = fmaf(f, dyv[i], du[i]);
        if (live && c == 0) {     // W at (t, s); W CB at (s, t), t > s
          sM[j * kHeadMat + t * kSeg + s] = w;
          if (t > s) sM[j * kHeadMat + s * kSeg + t] = w * cb;
        }
      }
      if (live) {
        float* out = dx + ((tok0 + s) * d.H + hbase + j) * d.P + c * w8;
        if (w8 >= 4) {        // P >= 4: every chunk is 16-byte aligned
#pragma unroll
          for (int i = 0; i < kChunk; i += 4)
            if (i < w8)
              *reinterpret_cast<float4*>(out + i) =
                  make_float4(dts * du[i], dts * du[i + 1], dts * du[i + 2],
                              dts * du[i + 3]);
        } else {
#pragma unroll
          for (int i = 0; i < kChunk; ++i)
            if (i < w8) out[i] = dts * du[i];
        }
        if (c == 0) sXd[s * kSlots + j] = xd;
      }
      if (live && c == 0) {   // at (s, t): sum_{t' >= t} W CB, for t > s
        float acc = 0.f;
        for (int t = n_t - 1; t > s; --t) {
          float* m = sM + j * kHeadMat + s * kSeg + t;
          acc += *m;
          *m = acc;
        }
      }
    }
    __syncthreads();
    if (kMulti) {             // the boundary terms of the block's heads
      const int nrow = nh * d.P;
      {                       // the block's rows of h_start and of the
                              // carry a_{t1} g_{t1} into shared memory
        const float* h0 = state_at(seg - 1) + rbase * N;     // if has_h0
        const float* cin = carry_at(seg) + rbase * N;    // if has_carry
#pragma unroll 4
        for (int e = tid; e < nrow * N; e += kBwdThreads) {
          const int r = e / N, n = e % N;
          if (has_h0) sH0[r * lds + n] = h0[e];
          if (has_carry) sCin[r * lds + n] = cin[e];
        }
      }
      fill_coefs(sdt, n_t, nrow, true);
      __syncthreads();
      {                       // warp w: tokens 2 w, 2 w + 1; lane: rows r =
                              // lane + 32 m.  gb = (a g)_r . B_t, hc =
                              // h_start_r . C_t (n in order), k4 = (a g)_r .
                              // h_start_r
        const int t0 = 2 * warp;
        float gb[2][4], hc[2][4], k4r[4];
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          gb[0][m] = gb[1][m] = hc[0][m] = hc[1][m] = k4r[m] = 0.f;
        }
#pragma unroll 2
        for (int n = 0; n < N; ++n) {
          const float b0 = sB[t0 * N + n], b1 = sB[(t0 + 1) * N + n];
          const float c0 = sC[t0 * N + n], c1 = sC[(t0 + 1) * N + n];
#pragma unroll
          for (int m = 0; m < 4; ++m) {
            const int r = lane + 32 * m;
            const float ci = sCin[r * lds + n], hi = sH0[r * lds + n];
            gb[0][m] = fmaf(ci, b0, gb[0][m]);
            gb[1][m] = fmaf(ci, b1, gb[1][m]);
            hc[0][m] = fmaf(hi, c0, hc[0][m]);
            hc[1][m] = fmaf(hi, c1, hc[1][m]);
            k4r[m] = fmaf(ci, hi, k4r[m]);
          }
        }
        // dx_t += dt_t post(t) gb; then e = x_t . gb, q = dy_t . hc and k4
        // summed over each head's rows: a head's slots in m order, then
        // its lanes by xor shuffles (P >= 32), or its P lanes (P < 32)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int t = t0 + i;
          float ev[4], qv[4];
#pragma unroll
          for (int m = 0; m < 4; ++m) {
            const int r = lane + 32 * m, th = t * kSlots + (r >> psh);
            ev[m] = qv[m] = 0.f;
            if (t < n_t && r < nrow) {
              if (has_carry) {
                float* o = dx + ((tok0 + t) * d.H + hbase) * d.P + r;
                *o = fmaf(sdt[th] * sPost[th], gb[i][m], *o);
                ev[m] = to_f32(sX[t * kBlockRows + r]) * gb[i][m];
              }
              if (has_h0) qv[m] = to_f32(sDY[t * kBlockRows + r]) * hc[i][m];
            }
          }
          auto put = [&](int jj, float e, float qs, float k4) {
            if (t >= n_t || jj >= nh) return;
            const int th = t * kSlots + jj;
            if (has_carry) {
              sXd[th] = fmaf(sPost[th], e, sXd[th]);
              sT3[th] = sPost[th] * sdt[th] * e;
            }
            if (has_h0) sQ[th] = sPre[th] * qs;
            if (has_carry && has_h0 && t == 0)
              sK4[jj] = sPre[(n_t - 1) * kSlots + jj] * k4;
          };
          if (d.P >= 32) {
            float e = 0.f, qs = 0.f, k4 = 0.f;
#pragma unroll
            for (int m = 0; m < 4; ++m) {
              e += ev[m];
              qs += qv[m];
              k4 += lane + 32 * m < nrow ? k4r[m] : 0.f;
              if (m == 3 || (32 * (m + 1)) >> psh != (32 * m) >> psh) {
                e = seg_sum(e, 32);
                qs = seg_sum(qs, 32);
                k4 = seg_sum(k4, 32);
                if (lane == 0) put((32 * m) >> psh, e, qs, k4);
                e = qs = k4 = 0.f;
              }
            }
          } else {
#pragma unroll
            for (int m = 0; m < 4; ++m) {
              const int r = lane + 32 * m;
              const float e = seg_sum(ev[m], d.P), qs = seg_sum(qv[m], d.P);
              const float k4 = seg_sum(r < nrow ? k4r[m] : 0.f, d.P);
              if ((lane & (d.P - 1)) == 0 && r < nrow) put(r >> psh, e, qs, k4);
            }
          }
        }
      }
      {                       // warp w: tokens 2 w, 2 w + 1; lane: n = lane
                              // + 32 m.  dC_t += sum_r Q[t][r] h_start_r,
                              // dB_t += sum_r U[t][r] (a g)_r (r in order)
        const int t0 = 2 * warp;
        float dc[2][4], db[2][4];
#pragma unroll
        for (int m = 0; m < 4; ++m) dc[0][m] = dc[1][m] = db[0][m] = db[1][m] = 0.f;
#pragma unroll 2
        for (int r = 0; r < nrow; ++r) {
          const float q0 = sQc[t0 * kBlockRows + r];
          const float q1 = sQc[(t0 + 1) * kBlockRows + r];
          const float u0 = sUc[t0 * kBlockRows + r];
          const float u1 = sUc[(t0 + 1) * kBlockRows + r];
#pragma unroll
          for (int m = 0; m < 4; ++m) {
            const int n = lane + 32 * m;
            if (n < N) {
              const float hi = sH0[r * lds + n], ci = sCin[r * lds + n];
              dc[0][m] = fmaf(q0, hi, dc[0][m]);
              dc[1][m] = fmaf(q1, hi, dc[1][m]);
              db[0][m] = fmaf(u0, ci, db[0][m]);
              db[1][m] = fmaf(u1, ci, db[1][m]);
            }
          }
        }
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int m = 0; m < 4; ++m) {
            const int t = t0 + i, n = lane + 32 * m;
            if (t < n_t && n < N) {
              if (has_h0) sAccC[t * N + n] += dc[i][m];
              if (has_carry) sAccB[t * N + n] += db[i][m];
            }
          }
      }
      if (has_h0)             // the carry into the segment before
        row_products(sQc, sC, n_t, nrow, [&](int r, int n, float v) {
          if (has_carry)
            v = fmaf(sPre[(n_t - 1) * kSlots + (r >> psh)], sCin[r * lds + n],
                     v);
          carry_at(seg + 1)[(rbase + r) * N + n] = v;
        });
      __syncthreads();
    }
    if (k + 1 < nsteps)       // the next step's rows, while this one ends
      stage(nseg - 1 - (k + 1) / nhb, hb0 + (k + 1) % nhb, true, (k + 1) & 1);

    {                         // thread (t, head jj): d log a_t, ddt_t
      const int t = tid / kSlots, jj = tid % kSlots;
      double prod = 0.0;
      if (t < n_t && jj < nh) {
        float dl = 0.f;
        for (int u = 0; u < t; ++u) dl += sM[jj * kHeadMat + u * kSeg + t];
        if (has_carry)
          for (int u = 0; u < t; ++u) dl += sT3[u * kSlots + jj];
        if (has_h0) {
          for (int u = t; u < n_t; ++u) dl += sQ[u * kSlots + jj];
          if (has_carry) dl += sK4[jj];
        }
        ddt[(tok0 + t) * d.H + hbase + jj] =
            fmaf(dl, A[copy * d.H + hbase + jj], sXd[t * kSlots + jj]);
        prod = static_cast<double>(sdt[t * kSlots + jj]) *
               static_cast<double>(dl);
      }
      sD2[jj * kSeg + t] = prod;
      if (t < n_t && jj <= t)  // thread (t, s = jj): sum_h W[t][s]
        for (int h = 0; h < nh; ++h) wacc += sM[h * kHeadMat + t * kSeg + jj];
    }
    __syncthreads();
    {                         // dA: a head's 16 tokens over 16 lanes
      const int jj = tid / kSeg, t = tid % kSeg;
      double v = sD2[jj * kSeg + t];
      for (int off = kSeg / 2; off > 0; off >>= 1)
        v += __shfl_xor_sync(kFull, v, off);
      if (t == 0 && jj < nh) sDA[hb * heads + jj] += v;
    }
    if (hb == hb0 + nhb - 1) {   // the segment's dB and dC (the unit's)
      const int t = tid / kSeg, u = tid % kSeg;
      sWg[tid] = (t < n_t && u <= t) ? wacc : 0.f;
      wacc = 0.f;
      __syncthreads();
      for (int e = tid; e < n_t * N; e += kBwdThreads) {
        const int tt = e / N, n = e % N;
        float dc = 0.f, db = 0.f;
        for (int v = 0; v <= tt; ++v)
          dc = fmaf(sWg[tt * kSeg + v], sB[v * N + n], dc);
        for (int v = tt; v < n_t; ++v)
          db = fmaf(sWg[v * kSeg + tt], sC[v * N + n], db);
        if (has_h0) dc += sAccC[e];
        if (has_carry) db += sAccB[e];
        // the outputs themselves where a group is one unit, else the
        // unit's slice of the partial sums
        const long long at =
            static_cast<long long>(blockIdx.x % pl.units) * d.B * d.S * d.G *
                N +
            (tok0 + tt) * d.G * N + g * N + n;
        dC_out[at] = dc;
        dB_out[at] = db;
      }
    }
  }
  __syncthreads();
  for (int e = hb0 * heads + tid; e < min(hg, (hb0 + nhb) * heads);
       e += kBwdThreads)
    dA_part[static_cast<long long>(b) * d.H + g * hg + e] = sDA[e];
}

// dA (copies, H) = the sum of each copy's per-sequence partials, in
// sequence order.
__global__ void ssd_dA_reduce_kernel(const double* __restrict__ part,
                                     float* __restrict__ dA, int copies,
                                     int per_copy, int H) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= copies * H) return;
  const int c = i / H, h = i % H;
  double s = 0.0;
  for (int j = 0; j < per_copy; ++j)
    s += part[(static_cast<long long>(c) * per_copy + j) * H + h];
  dA[i] = static_cast<float>(s);
}

// dB and dC (`count` elements each) = the sums of the units' partials
// (dB's `units` slices, then dC's), in unit order.
__global__ void ssd_dbc_reduce_kernel(const float* __restrict__ part,
                                      float* __restrict__ dB,
                                      float* __restrict__ dC,
                                      long long count, int units) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= count) return;
  const float* pc = part + static_cast<long long>(units) * count;
  float sb = 0.f, sc = 0.f;
  for (int u = 0; u < units; ++u) {
    sb += part[u * count + i];
    sc += pc[u * count + i];
  }
  dB[i] = sb;
  dC[i] = sc;
}

// ---- forward -----------------------------------------------------------

constexpr int kFwdThreads = kThreads;
constexpr int kFwdRows = 256;        // (head, p) rows of a unit, at most
constexpr int kFwdHeads = 32;        // heads of a unit, at most
constexpr int kStateElems = 4096;    // rows x N of a unit with a state: 16
                                     // values of N a thread
// A head's W, transposed: row s holds W[t, s] for t from 4 floor(s / 4)
// on (whole 16-byte groups of t, zeros at t < s), 160 floats in all,
// padded to an odd count of 16-byte groups against bank conflicts.
__host__ __device__ constexpr int w_row(int s) {
  return 64 * (s / 4) - 8 * (s / 4) * (s / 4 - 1) + (s % 4) * (16 - s / 4 * 4);
}
constexpr int kWMat = 164;
static_assert(w_row(kTile - 1) + 4 == 160 && kWMat % 8 == 4,
              "W^T: 160 floats a head, an odd count of 16-byte groups");
constexpr int kLdCB = kTile + 4;     // CB^T rows, padded
constexpr int kLdA = kTile + 4;      // a's rows (a head each), padded
constexpr int kFwdBlocksPerSM = 3;
constexpr int kFwdMaxState = 128;    // N the forward takes
static_assert(kTile * kTile == kFwdThreads, "CB: one token pair a thread");

// n / d and n % d for 0 <= n, d < 2^31 by a multiply-high and a shift (the
// divisor's magic number is made on the host).
struct FastDiv {
  unsigned d, m, s;
};

FastDiv fast_div(unsigned d) {
  unsigned s = 0;
  while ((1u << s) < d) ++s;
  const unsigned long long m = ((1ull << 32) * ((1ull << s) - d)) / d + 1;
  return {d, static_cast<unsigned>(m), s};
}

__device__ __forceinline__ int div_of(int n, const FastDiv& f) {
  const unsigned u = static_cast<unsigned>(n);
  return static_cast<int>((__umulhi(u, f.m) + u) >> f.s);
}

// The partition of a shape into units, fixed by S, H, P, G and N (not by
// B): a unit is nh heads of np p values each (np < P: one head's block of
// p values), the (head, p) rows of a group in head order.
struct FwdPlan {
  int rows;      // rows of a unit, at most: 256, or 4096 / N with a state
  int nh, np;
  int hg;        // heads a group
  int tiles;     // ceil(S / kTile)
  int units;     // B * G * head blocks * p blocks
  int carry;     // S > kTile: the state crosses tiles
  FastDiv by_pb, by_hb, by_g, by_copy, by_p;
};

// A unit: its sequence, group, copy of A, first head (of all H), heads,
// first p and rows.
struct FwdUnit {
  int b, g, copy, h0, nh, p0, rows;
};

__device__ __forceinline__ FwdUnit fwd_unit(const Dims& d, const FwdPlan& pl,
                                            int u) {
  FwdUnit w;
  int rest = div_of(u, pl.by_pb);
  const int pb = u - rest * static_cast<int>(pl.by_pb.d);
  u = rest;
  rest = div_of(u, pl.by_hb);
  const int hb = u - rest * static_cast<int>(pl.by_hb.d);
  w.b = div_of(rest, pl.by_g);
  w.g = rest - w.b * d.G;
  w.copy = div_of(w.b, pl.by_copy);
  w.h0 = w.g * pl.hg + hb * pl.nh;
  w.nh = min(pl.nh, pl.hg - hb * pl.nh);
  w.p0 = pb * pl.np;
  w.rows = w.nh * min(pl.np, d.P - w.p0);
  return w;
}

// Shared memory of the forward (byte offsets): two stages of (x tile in
// the input type, dt in f32, B and C in the input type, the heads' A in
// f32), then a, pre, post, CB
// (transposed), the heads' W (transposed, packed), and, with a state, its
// term in y (f32).
template <typename T, int NMAX> struct FwdSmem {
  static constexpr int kE = static_cast<int>(sizeof(T));
  static constexpr int kLdBC = NMAX + 16 / kE;      // B, C rows, padded
  static constexpr int kX = kTile * kFwdRows * kE;
  static constexpr int kDt = kTile * kFwdHeads * 4;
  static constexpr int kBC = kTile * kLdBC * kE;
  static constexpr int kAh = 4 * kFwdHeads;
  static constexpr int kStage = kX + kDt + 2 * kBC + kAh;
  static constexpr int kOffA = 2 * kStage;          // (head, token)
  static constexpr int kOffPre = kOffA + 4 * kLdA * kFwdHeads;  // (t, h)
  static constexpr int kOffPost = kOffPre + 4 * kTile * kFwdHeads;
  static constexpr int kOffCB = kOffPost + 4 * kTile * kFwdHeads;  // (s, t)
  static constexpr int kOffW = kOffCB + 4 * kTile * kLdCB;
  static constexpr int kOffYc = kOffW + 4 * kFwdHeads * kWMat;
  static constexpr int kStateRows =
      kStateElems / NMAX < kFwdRows ? kStateElems / NMAX : kFwdRows;
  static constexpr int bytes(int carry) {
    return kOffYc + (carry ? 4 * kTile * kStateRows : 0);
  }
  static_assert(kStage % 16 == 0 && kX % 16 == 0 && kDt % 16 == 0 &&
                    kBC % 16 == 0 && kOffYc % 16 == 0,
                "every array stays 16-byte aligned");
};

// V consecutive elements as f32 from shared memory, and back to global
// memory in T: one access of 4 V bytes (f32) or 2 V (bf16).
template <int V>
__device__ __forceinline__ void load_rows(const float* p, float (&v)[V]) {
  if constexpr (V == 4) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  } else {
    v[0] = *p;
  }
}
template <int V>
__device__ __forceinline__ void load_rows(const __nv_bfloat16* p,
                                          float (&v)[V]) {
  if constexpr (V == 4) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const float2 lo = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
    const float2 hi = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
    v[0] = lo.x; v[1] = lo.y; v[2] = hi.x; v[3] = hi.y;
  } else {
    v[0] = __bfloat162float(*p);
  }
}
template <int V>
__device__ __forceinline__ void store_rows(float* p, const float (&v)[V]) {
  if constexpr (V == 4)
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  else
    *p = v[0];
}
template <int V>
__device__ __forceinline__ void store_rows(__nv_bfloat16* p,
                                           const float (&v)[V]) {
  if constexpr (V == 4) {
    uint2 raw;
    *reinterpret_cast<__nv_bfloat162*>(&raw.x) =
        __floats2bfloat162_rn(v[0], v[1]);
    *reinterpret_cast<__nv_bfloat162*>(&raw.y) =
        __floats2bfloat162_rn(v[2], v[3]);
    *reinterpret_cast<uint2*>(p) = raw;
  } else {
    *p = __float2bfloat16_rn(v[0]);
  }
}

// V: rows a thread owns in the y step (4 where P % 4 == 0, else 1).
template <typename T, int NMAX, int V>
__global__ void __launch_bounds__(kFwdThreads, kFwdBlocksPerSM)
    ssd_fwd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                   const float* __restrict__ A, const T* __restrict__ Bm,
                   const T* __restrict__ Cm, T* __restrict__ y, Dims d,
                   FwdPlan pl) {
  using L = FwdSmem<T, NMAX>;
  constexpr int LDBC = L::kLdBC, SR = L::kStateRows;
  constexpr int TPR = kFwdThreads / SR;   // threads a row's state (N / 16)
  constexpr int NRG = kFwdRows / V;       // row groups of the y step
  extern __shared__ __align__(16) unsigned char smem[];
  float* sA = reinterpret_cast<float*>(smem + L::kOffA);   // (head, t)
  float* sPre = reinterpret_cast<float*>(smem + L::kOffPre);
  float* sPost = reinterpret_cast<float*>(smem + L::kOffPost);
  float* sCB = reinterpret_cast<float*>(smem + L::kOffCB);   // (s, t)
  float* sW = reinterpret_cast<float*>(smem + L::kOffW);  // (head, s, t)
  float* sYc = reinterpret_cast<float*>(smem + L::kOffYc); // (t, row)
  auto stage = [&](int st, int off) {
    return reinterpret_cast<T*>(smem + st * L::kStage + off);
  };
  const int tid = threadIdx.x;
  const long long ldy = static_cast<long long>(d.H) * d.P;
  // the head (within the unit) of row r
  auto head_of = [&](int r) { return pl.np < d.P ? 0 : div_of(r, pl.by_p); };

  // Start the copies of tile k of unit u into stage st.
  auto fetch = [&](int u, int k, int st) {
    const FwdUnit w = fwd_unit(d, pl, u);
    const int n_t = min(kTile, d.S - k * kTile);
    const long long tok = static_cast<long long>(w.b) * d.S + k * kTile;
    const long long gn = static_cast<long long>(w.g) * d.N;
    copy_tile_async(stage(st, 0), kFwdRows,
                    x + tok * d.ldx + static_cast<long long>(w.h0) * d.P +
                        w.p0,
                    d.ldx, n_t, w.rows);
    copy_tile_async(reinterpret_cast<float*>(stage(st, L::kX)), kFwdHeads,
                    dt + tok * d.H + w.h0, d.H, n_t, w.nh);
    copy_tile_async(stage(st, L::kX + L::kDt), LDBC, Bm + tok * d.ldb + gn,
                    d.ldb, n_t, d.N);
    copy_tile_async(stage(st, L::kX + L::kDt + L::kBC), LDBC,
                    Cm + tok * d.ldc + gn, d.ldc, n_t, d.N);
    // A with the tile: a load of it in the step would wait behind the
    // next step's copies
    copy_tile_async(reinterpret_cast<float*>(
                        stage(st, L::kX + L::kDt + 2 * L::kBC)),
                    kFwdHeads, A + static_cast<long long>(w.copy) * d.H + w.h0,
                    d.H, 1, w.nh);
  };

  int u = blockIdx.x;
  if (u >= pl.units) return;
  int k = 0, st = 0;
  fetch(u, 0, 0);
  asm volatile("cp.async.commit_group;\n" ::);
  float h[16];        // with a state: row tid / TPR, n = 16 (tid % TPR) + i
  const int sr = tid / TPR, sc = tid % TPR;
  while (true) {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();  // this step's copies landed; the last step is done
    int nu = u, nk = k + 1;
    if (nk == pl.tiles) {
      nu += gridDim.x;
      nk = 0;
    }
    const bool more = nu < pl.units;
    if (more) fetch(nu, nk, st ^ 1);    // in flight while this step runs
    asm volatile("cp.async.commit_group;\n" ::);

    const FwdUnit w = fwd_unit(d, pl, u);
    const int n_t = min(kTile, d.S - k * kTile);
    const T* sx = stage(st, 0);
    const float* sdt = reinterpret_cast<const float*>(stage(st, L::kX));
    const T* sbm = stage(st, L::kX + L::kDt);
    const T* scm = stage(st, L::kX + L::kDt + L::kBC);
    const float* sah = reinterpret_cast<const float*>(
        stage(st, L::kX + L::kDt + 2 * L::kBC));

    // a = exp(dt A) a (token, head); CB a token pair s <= t
    for (int e = tid; e < kTile * kFwdHeads; e += kFwdThreads) {
      const int t = e / kFwdHeads, j = e % kFwdHeads;
      if (t < n_t && j < w.nh)
        sA[j * kLdA + t] = expf(sdt[e] * sah[j]);
    }
    {
      const int t = tid / kTile, s = tid % kTile;
      if (s <= t && t < n_t) {
        float v = 0.f;
#pragma unroll
        for (int n = 0; n < NMAX; n += 4) {
          if (n >= d.N) break;
          float cv[4], bv[4];
          load_rows<4>(scm + t * LDBC + n, cv);
          load_rows<4>(sbm + s * LDBC + n, bv);
#pragma unroll
          for (int i = 0; i < 4; ++i)
            if (n + i < d.N) v = fmaf(cv[i], bv[i], v);
        }
        sCB[s * kLdCB + t] = v;
      }
    }
    __syncthreads();

    // W of the unit's heads, a thread a (head, s): row s of W^T from its
    // first 16-byte group on (s is uniform in a warp), D(t, s) as running
    // products over t >= s; with a state, pre(t) = a_0 ... a_t and post(t)
    // = a_{n_t - 1} ... a_{t + 1}
    for (int e = tid; e < kFwdHeads * kTile; e += kFwdThreads) {
      const int s = e / kFwdHeads, j = e % kFwdHeads;
      if (j < w.nh && s < n_t) {
        const float dts = sdt[e];
        const float* aj = sA + j * kLdA;
        const float* cbs = sCB + s * kLdCB;
        float* row = sW + j * kWMat + w_row(s) - 4 * (s / 4);
        float dcy = 1.f;
#pragma unroll
        for (int c = 0; c < kTile / 4; ++c) {
          if (c < s / 4) continue;             // t < s: no term, dcy is 1
          const float4 a4 = *reinterpret_cast<const float4*>(aj + 4 * c);
          const float4 cb4 = *reinterpret_cast<const float4*>(cbs + 4 * c);
          const float av[4] = {a4.x, a4.y, a4.z, a4.w};
          const float cb[4] = {cb4.x, cb4.y, cb4.z, cb4.w};
          float wv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int t = 4 * c + i;
            dcy = t > s ? dcy * av[i] : 1.f;
            wv[i] = t >= s ? dcy * cb[i] * dts : 0.f;
          }
          *reinterpret_cast<float4*>(row + 4 * c) =
              make_float4(wv[0], wv[1], wv[2], wv[3]);
        }
      }
    }
    if (pl.carry) {
      for (int e = tid; e < kTile * kFwdHeads; e += kFwdThreads) {
        const int t = e / kFwdHeads, j = e % kFwdHeads;
        if (t < n_t && j < w.nh) {
          float pre = 1.f, post = 1.f;
          for (int q = 0; q <= t; ++q) pre *= sA[j * kLdA + q];
          for (int q = n_t - 1; q > t; --q) post *= sA[j * kLdA + q];
          sPre[e] = pre;
          sPost[e] = post;
        }
      }
    }
    __syncthreads();

    // with a state: its term in y (from the state entering the tile), then
    // the state leaving it; thread (row sr, n-chunk sc)
    if (pl.carry) {
      const bool live = sr < w.rows;
      const int j = live ? head_of(sr) : 0;
      if (k == 0) {
#pragma unroll
        for (int i = 0; i < 16; ++i) h[i] = 0.f;
      } else {
        for (int t = 0; t < n_t; ++t) {
          float part = 0.f;
#pragma unroll
          for (int i = 0; i < 16; ++i) {
            const int n = 16 * sc + i;
            part = fmaf(n < d.N ? to_f32(scm[t * LDBC + n]) : 0.f, h[i],
                        part);
          }
          if (TPR > 1) part = seg_sum(part, TPR);
          if (live && sc == 0)
            sYc[t * SR + sr] = sPre[t * kFwdHeads + j] * part;
        }
      }
      if (k + 1 < pl.tiles) {
        const float keep = sPre[(n_t - 1) * kFwdHeads + j];
#pragma unroll
        for (int i = 0; i < 16; ++i) h[i] *= keep;
        for (int s = 0; s < n_t; ++s) {
          const float coef = sPost[s * kFwdHeads + j] *
                             (sdt[s * kFwdHeads + j] *
                              to_f32(sx[s * kFwdRows + sr]));
#pragma unroll
          for (int i = 0; i < 16; ++i) {
            const int n = 16 * sc + i;
            h[i] = fmaf(coef, n < d.N ? to_f32(sbm[s * LDBC + n]) : 0.f,
                        h[i]);
          }
        }
      }
      __syncthreads();
    }

    // y: V rows of a head at the four tokens 4 g .. 4 g + 3 a thread: a
    // 16-byte read of x and one of W^T a source token s <= 4 g + 3
    T* yu = y + (static_cast<long long>(w.b) * d.S + k * kTile) * ldy +
            static_cast<long long>(w.h0) * d.P + w.p0;
    const bool with_state = pl.carry && k > 0;
    for (int e = tid; e < 4 * NRG; e += kFwdThreads) {
      const int g4 = e / NRG, r = (e % NRG) * V;
      if (r >= w.rows || 4 * g4 >= n_t) continue;
      const float* wj = sW + head_of(r) * kWMat + 4 * g4;
      float acc[4][V];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int v = 0; v < V; ++v)
          acc[i][v] = with_state && 4 * g4 + i < n_t
                          ? sYc[(4 * g4 + i) * SR + r + v]
                          : 0.f;
#pragma unroll
      for (int s = 0; s < kTile; ++s) {
        if (s > 4 * g4 + 3 || s >= n_t) break;
        float xv[V];
        load_rows<V>(sx + s * kFwdRows + r, xv);
        const float4 w4 =
            *reinterpret_cast<const float4*>(wj + w_row(s) - 4 * (s / 4));
        const float wv[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int v = 0; v < V; ++v) acc[i][v] = fmaf(wv[i], xv[v], acc[i][v]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (4 * g4 + i < n_t)
          store_rows<V>(yu + (4 * g4 + i) * ldy + r, acc[i]);
    }

    if (!more) break;
    u = nu;
    k = nk;
    st ^= 1;
  }
}

// Opt in to more than 48 KB of dynamic shared memory when needed; 0 or a
// cudaError_t.
template <typename Kernel>
int allow_smem(Kernel kernel, int bytes) {
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

// The shapes the backward takes: N <= 128, P a power of two up to 128.
bool bwd_takes(int H, int P, int G, int N) {
  return N >= 1 && N <= kBwdMaxState && P >= 1 && P <= kBwdMaxP &&
         (P & (P - 1)) == 0 && G >= 1 && H % G == 0;
}

// The backward's instance for a type and P, its dynamic shared memory at
// S (the state's rows staged where S > kSeg) opted in; 0 or a
// cudaError_t.
template <typename T>
using BwdKernel = decltype(&ssd_bwd_kernel<T, true, true>);

template <typename T>
int bwd_prepare(int hg, int P, int N, int S, BwdKernel<T>* kernel,
                int* bytes) {
  if (S > kSeg)
    *kernel = P >= kChunk ? ssd_bwd_kernel<T, true, true>
                          : ssd_bwd_kernel<T, false, true>;
  else
    *kernel = P >= kChunk ? ssd_bwd_kernel<T, true, false>
                          : ssd_bwd_kernel<T, false, false>;
  *bytes = bwd_smem_bytes(hg, N, S > kSeg);
  cudaFuncSetAttribute(*kernel,
                       cudaFuncAttributePreferredSharedMemoryCarveout,
                       cudaSharedmemCarveoutMaxShared);
  return allow_smem(*kernel, *bytes);
}

template <typename T>
int bwd(const void* x, const float* dt, const float* A, const void* Bm,
        const void* Cm, const void* dy, float* dx, float* ddt, float* dA,
        float* dBm, float* dCm, double* dA_part, float* ws, float* dbc,
        const Dims& d, cudaStream_t stream) {
  const BwdPlan pl = bwd_plan(d.H, d.P, d.G, d.N);
  BwdKernel<T> kernel;
  int bytes = 0;
  if (const int err =
          bwd_prepare<T>(d.H / d.G, d.P, d.N, d.S, &kernel, &bytes))
    return err;
  const long long grid = static_cast<long long>(d.B) * d.G * pl.units;
  if (grid < 1 || grid > 0x7fffffffLL) return kBadShape;
  // a group of one unit writes dB and dC itself; more write partials
  const long long count = static_cast<long long>(d.B) * d.S * d.G * d.N;
  float* out_b = pl.units > 1 ? dbc : dBm;
  float* out_c = pl.units > 1 ? dbc + pl.units * count : dCm;
  kernel<<<static_cast<int>(grid), kBwdThreads, bytes, stream>>>(
      static_cast<const T*>(x), dt, A, static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<const T*>(dy), dx, ddt, dA_part,
      out_b, out_c, ws, d, pl);
  if (const int err = static_cast<int>(cudaGetLastError())) return err;
  const int n = d.B / d.per_copy * d.H;
  ssd_dA_reduce_kernel<<<(n + 255) / 256, 256, 0, stream>>>(
      dA_part, dA, d.B / d.per_copy, d.per_copy, d.H);
  if (const int err = static_cast<int>(cudaGetLastError())) return err;
  if (pl.units > 1)
    ssd_dbc_reduce_kernel<<<static_cast<unsigned>((count + 255) / 256), 256,
                            0, stream>>>(dbc, dBm, dCm, count, pl.units);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int bwd_resources(int H, int P, int G, int N, int S, int* out) {
  BwdKernel<T> kernel;
  int bytes = 0;
  if (const int err = bwd_prepare<T>(H / G, P, N, S, &kernel, &bytes))
    return err;
  const void* kernels[3] = {
      reinterpret_cast<const void*>(kernel),
      reinterpret_cast<const void*>(ssd_dA_reduce_kernel),
      reinterpret_cast<const void*>(ssd_dbc_reduce_kernel)};
  const int threads[3] = {kBwdThreads, 256, 256};
  const int dynamic[3] = {bytes, 0, 0};
  for (int i = 0; i < 3; ++i) {
    cudaFuncAttributes fa;
    if (const cudaError_t err = cudaFuncGetAttributes(&fa, kernels[i]))
      return static_cast<int>(err);
    int blocks = 0;
    if (const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &blocks, kernels[i], threads[i], dynamic[i]))
      return static_cast<int>(err);
    int* o = out + 6 * i;
    o[0] = fa.numRegs;
    o[1] = static_cast<int>(fa.localSizeBytes);
    o[2] = static_cast<int>(fa.sharedSizeBytes);
    o[3] = dynamic[i];
    o[4] = blocks;
    o[5] = threads[i];
  }
  return 0;
}

// The forward's instance, prepared once a device: its shared memory
// allowed, and the bytes and resident CTAs an SM without and with a state.
struct FwdPrepared {
  const void* func = nullptr;
  int bytes[2] = {0, 0};
  int per_sm[2] = {0, 0};
  int sms = 0;
};

constexpr int kMaxDevices = 64;

// Returns a cudaError_t; points `out` at the current device's record.
template <typename T, int NMAX, int V>
int fwd_prepare(const FwdPrepared** out) {
  static FwdPrepared by_device[kMaxDevices];
  int device = 0;
  if (const cudaError_t err = cudaGetDevice(&device))
    return static_cast<int>(err);
  if (device < 0 || device >= kMaxDevices) return kBadShape;
  FwdPrepared& inst = by_device[device];
  *out = &inst;
  if (inst.per_sm[0] > 0) return 0;
  auto kernel = ssd_fwd_kernel<T, NMAX, V>;
  inst.func = reinterpret_cast<const void*>(kernel);
  cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                       cudaSharedmemCarveoutMaxShared);
  for (int m = 0; m < 2; ++m) inst.bytes[m] = FwdSmem<T, NMAX>::bytes(m);
  if (const int err = allow_smem(kernel, inst.bytes[1])) return err;
  cudaDeviceGetAttribute(&inst.sms, cudaDevAttrMultiProcessorCount, device);
  int per_sm[2] = {0, 0};
  for (int m = 0; m < 2; ++m)
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm[m], kernel,
                                                  kFwdThreads, inst.bytes[m]);
  if (const int err = static_cast<int>(cudaGetLastError())) return err;
  inst.per_sm[1] = max(1, per_sm[1]);
  inst.per_sm[0] = max(1, per_sm[0]);
  return 0;
}

// The units of a shape (see FwdPlan); units 0 when the count overflows.
FwdPlan fwd_plan(const Dims& d, int nmax) {
  FwdPlan pl;
  pl.hg = d.H / d.G;
  pl.carry = d.S > kTile;
  pl.rows = pl.carry ? min(kFwdRows, kStateElems / nmax) : kFwdRows;
  if (d.P <= pl.rows) {
    pl.np = d.P;
    pl.nh = min(min(kFwdHeads, pl.rows / d.P), pl.hg);
  } else {
    pl.np = pl.rows;
    pl.nh = 1;
  }
  const int pb = (d.P + pl.np - 1) / pl.np, hb = (pl.hg + pl.nh - 1) / pl.nh;
  pl.tiles = (d.S + kTile - 1) / kTile;
  const long long units = static_cast<long long>(d.B) * d.G * hb * pb;
  pl.units = units > 0x7fffffffLL ? 0 : static_cast<int>(units);
  pl.by_pb = fast_div(pb);
  pl.by_hb = fast_div(hb);
  pl.by_g = fast_div(d.G);
  pl.by_copy = fast_div(d.per_copy);
  pl.by_p = fast_div(d.P);
  return pl;
}

template <typename T, int NMAX, int V>
int fwd(const void* x, const void* dt, const float* A, const void* Bm,
        const void* Cm, void* y, const Dims& d, cudaStream_t stream) {
  const FwdPrepared* inst = nullptr;
  if (const int err = fwd_prepare<T, NMAX, V>(&inst)) return err;
  const FwdPlan pl = fwd_plan(d, NMAX);
  if (pl.units <= 0) return kBadShape;
  const int grid = min(pl.units, inst->sms * inst->per_sm[pl.carry]);
  ssd_fwd_kernel<T, NMAX, V><<<grid, kFwdThreads, inst->bytes[pl.carry],
                               stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt), A,
      static_cast<const T*>(Bm), static_cast<const T*>(Cm),
      static_cast<T*>(y), d, pl);
  return static_cast<int>(cudaGetLastError());
}

// What the forward's instance takes on the current device, without (carry
// 0) or with a state, into out[6]: registers a thread, local memory a
// thread (spills; bytes), static and dynamic shared memory a CTA (bytes),
// resident CTAs an SM, threads a CTA.
template <typename T, int NMAX, int V>
int fwd_resources(int carry, int* out) {
  const FwdPrepared* inst = nullptr;
  if (const int err = fwd_prepare<T, NMAX, V>(&inst)) return err;
  cudaFuncAttributes fa;
  if (const cudaError_t err = cudaFuncGetAttributes(&fa, inst->func))
    return static_cast<int>(err);
  out[0] = fa.numRegs;
  out[1] = static_cast<int>(fa.localSizeBytes);
  out[2] = static_cast<int>(fa.sharedSizeBytes);
  out[3] = inst->bytes[carry];
  out[4] = inst->per_sm[carry];
  out[5] = kFwdThreads;
  return 0;
}

// Call f with the forward's instance for a type, N and P: f(T{}, NMAX, V)
// as a tag; -1 for N the forward does not take.
template <int NMAX, int V> struct FwdTag {
  static constexpr int n = NMAX, v = V;
};

template <typename F>
int with_fwd_instance(int N, int P, F&& f) {
  if (P % 4 == 0) {
    if (N <= 16) return f(FwdTag<16, 4>{});
    if (N <= 32) return f(FwdTag<32, 4>{});
    if (N <= 64) return f(FwdTag<64, 4>{});
    if (N <= kFwdMaxState) return f(FwdTag<128, 4>{});
  } else {
    if (N <= 16) return f(FwdTag<16, 1>{});
    if (N <= 32) return f(FwdTag<32, 1>{});
    if (N <= 64) return f(FwdTag<64, 1>{});
    if (N <= kFwdMaxState) return f(FwdTag<128, 1>{});
  }
  return kBadShape;
}

bool fwd_takes(int H, int P, int G, int N) {
  return N >= 1 && N <= kFwdMaxState && P >= 1 && G >= 1 && H >= G &&
         H % G == 0;
}

}  // namespace

extern "C" {

// x, y: (B, S, H, P); dt: (B, S, H); Bm, Cm: (B, S, G, N); A: (B /
// per_copy, H) and dt f32.  bf16 != 0: x, Bm, Cm, y are bf16, else f32.
// N <= 128.  Returns a cudaError_t, or -1 for a shape the kernel does not
// take.
int ssd_scan_fwd_launch(const void* x, const void* dt, const float* A,
                        const void* Bm, const void* Cm, void* y, int B, int S,
                        int H, int P, int G, int N, int per_copy,
                        long long ldx, long long ldb, long long ldc, int bf16,
                        cudaStream_t stream) {
  if (!fwd_takes(H, P, G, N) || B < 1 || S < 1 || per_copy < 1)
    return kBadShape;
  const Dims d{B, S, H, P, G, N, per_copy, ldx, ldb, ldc};
  return with_fwd_instance(N, P, [&](auto tag) {
    using Tag = decltype(tag);
    return bf16 ? fwd<__nv_bfloat16, Tag::n, Tag::v>(x, dt, A, Bm, Cm, y, d,
                                                      stream)
                : fwd<float, Tag::n, Tag::v>(x, dt, A, Bm, Cm, y, d, stream);
  });
}

// The forward's resources at a shape, into out[6] (see fwd_resources): the
// instance for bf16 or f32, N and P, without (S <= 16) or with a state (S
// > 16).  Returns a cudaError_t, or -1 for a shape the kernel does not
// take.
int ssd_scan_fwd_resources(int H, int P, int G, int N, int S, int bf16,
                           int* out) {
  if (!fwd_takes(H, P, G, N) || S < 1) return kBadShape;
  const int carry = S > kTile;
  return with_fwd_instance(N, P, [&](auto tag) {
    using Tag = decltype(tag);
    return bf16 ? fwd_resources<__nv_bfloat16, Tag::n, Tag::v>(carry, out)
                : fwd_resources<float, Tag::n, Tag::v>(carry, out);
  });
}

// x, Bm, Cm and dy in bf16 (bf16 != 0) or f32; dt, A f32.  dx (like x),
// ddt (like dt), dA (like A), dBm and dCm (like Bm) are f32 and
// contiguous; dA_part: (B, H) f64 scratch; ws: with S > 16, the
// segment-end states and the carries of each unit, B * G * units *
// (ceil(S / 16) + 1) * N * rows floats (nothing with S <= 16); dbc: with
// more than one unit a group, the units' partial dB and dC, 2 * units * B
// * S * G * N floats (units and rows from ssd_scan_bwd_units).  N <= 128;
// P a power of two up to 128.  Returns a cudaError_t, or -1 for a shape
// the kernel does not take.
int ssd_scan_bwd_launch(const void* x, const float* dt, const float* A,
                        const void* Bm, const void* Cm, const void* dy,
                        float* dx, float* ddt, float* dA, float* dBm,
                        float* dCm, double* dA_part, float* ws, float* dbc,
                        int B, int S, int H, int P, int G, int N,
                        int per_copy, long long ldx, long long ldb,
                        long long ldc, int bf16, cudaStream_t stream) {
  if (!bwd_takes(H, P, G, N) || B < 1 || S < 1 || per_copy < 1)
    return kBadShape;
  const Dims d{B, S, H, P, G, N, per_copy, ldx, ldb, ldc};
  return bf16 ? bwd<__nv_bfloat16>(x, dt, A, Bm, Cm, dy, dx, ddt, dA, dBm,
                                   dCm, dA_part, ws, dbc, d, stream)
              : bwd<float>(x, dt, A, Bm, Cm, dy, dx, ddt, dA, dBm, dCm,
                           dA_part, ws, dbc, d, stream);
}

// The backward's units a group and (head, p) rows of a unit at most, at a
// shape, into out[2].  Returns 0, or -1 for a shape the kernel does not
// take.
int ssd_scan_bwd_units(int H, int P, int G, int N, int* out) {
  if (!bwd_takes(H, P, G, N)) return kBadShape;
  const BwdPlan pl = bwd_plan(H, P, G, N);
  out[0] = pl.units;
  out[1] = pl.urows;
  return 0;
}

// The backward's resources at a shape (S > 16: with the state's rows
// staged) and type, into out[18]: for
// ssd_bwd_kernel, ssd_dA_reduce_kernel and ssd_dbc_reduce_kernel, six
// ints each: registers a thread, local memory a thread (spills; bytes),
// static and dynamic shared memory a CTA (bytes), resident CTAs an SM,
// threads a CTA.  Returns a cudaError_t, or -1 for a shape the kernel does
// not take.
int ssd_scan_bwd_resources(int H, int P, int G, int N, int S, int bf16,
                           int* out) {
  if (!bwd_takes(H, P, G, N) || S < 1) return kBadShape;
  return bf16 ? bwd_resources<__nv_bfloat16>(H, P, G, N, S, out)
              : bwd_resources<float>(H, P, G, N, S, out);
}

}  // extern "C"
