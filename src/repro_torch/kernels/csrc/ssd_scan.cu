// The Mamba-2 SSD scan for Hopper (sm_90a): the forward pass and a
// deterministic backward, f32 arithmetic throughout.
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
//   The per-token recurrence, exact like the TPU kernel's chunked dual form:
//     h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t^T   (P x N, from zero)
//     y_t = h_t C_t
//   One thread owns one (b, h, p) row of the state (N registers); the
//   group's B and C rows are staged in shared memory a tile of tokens at a
//   time.  f32 or bf16 inputs, f32 inside, y in the input type.  It needs
//   no chunk size: any S runs (the TPU kernel asserts S % chunk == 0).
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
//   and no state exists.
//
//   Mapping.  One 256-thread CTA owns one (sequence, group) and walks its
//   heads in blocks of up to kBlockRows (head, p) rows: kSlots (head,
//   p-chunk) slots x kSeg tokens, a thread per (slot, token s), owning
//   min(P, 8) p values of one head (P > 8: P / 8 neighbouring lanes share
//   a head, and K is summed over them by shuffles).  Each step (segment,
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
//       block);
//     dA: per (sequence, head), dt_t d log a_t in f64, over the 16 tokens
//       of a segment by xor shuffles, then over the segments in order;
//       ssd_dA_reduce_kernel sums the per-sequence partials per copy in
//       sequence order.
//
// Bound.  At the port's shapes (S 16, H 64, P 8, N 16) both kernels are
// bound by their bytes (each reads its inputs once and writes its outputs
// once, 3.35 TB/s on an H100 SXM).  The backward's dual form does ~3 f32
// operations for each byte it must move; the recurrence it replaced did
// ~17 and waited on shuffles, so it was latency-bound at one 512-thread
// CTA an SM.  At 49 792 bytes of shared memory (N 16, 64 heads a group)
// and at most 64 registers a thread, four CTAs (32 warps) are resident on
// an SM, and their staged copies keep the memory busy.
//
// C interface (bound with ctypes): every entry point launches on the given
// stream, does not synchronise, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 16;          // tokens a forward tile stages
constexpr int kFwdThreads = 256;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kBadShape = -1;      // a shape the kernels do not take

constexpr int kSeg = 16;           // tokens of a backward segment
constexpr int kSlots = 16;         // (head, p-chunk) slots of a head block
constexpr int kBwdThreads = kSeg * kSlots;
constexpr int kChunk = 8;          // p values a backward thread owns
constexpr int kBlockRows = 128;    // (head, p) rows of a head block
constexpr int kHeadMat = kSeg * kSeg + 1;   // a head's kSeg x kSeg, padded
constexpr int kBwdBlocksPerSM = 4;

struct Dims {
  int B, S, H, P, G, N;
  int per_copy;                    // sequences per copy of A
  long long ldx, ldb, ldc;         // elements between consecutive tokens
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Sum over aligned segments of `width` lanes (a power of two <= 32); every
// lane of a segment gets the segment's sum.
__device__ __forceinline__ float seg_sum(float v, int width) {
  for (int off = width >> 1; off > 0; off >>= 1)
    v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// Stage tokens t0 .. t0 + kTile - 1 of group g's B and C rows as f32 into
// sB, sC (kTile x NMAX), zero past S and past N.
template <int NMAX, typename T>
__device__ void stage_bc(float* sB, float* sC, const T* __restrict__ Bm,
                         const T* __restrict__ Cm, const Dims& d, int b,
                         int g, int t0) {
  for (int e = threadIdx.x; e < kTile * NMAX; e += blockDim.x) {
    const int tt = e / NMAX, n = e % NMAX, t = t0 + tt;
    const bool in = t < d.S && n < d.N;
    const long long tok = static_cast<long long>(b) * d.S + t;
    sB[e] = in ? to_f32(Bm[tok * d.ldb + g * d.N + n]) : 0.f;
    sC[e] = in ? to_f32(Cm[tok * d.ldc + g * d.N + n]) : 0.f;
  }
}

template <typename T, int NMAX>
__global__ void __launch_bounds__(kFwdThreads)
    ssd_fwd_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                   const float* __restrict__ A, const T* __restrict__ Bm,
                   const T* __restrict__ Cm, T* __restrict__ y, Dims d) {
  __shared__ float sB[kTile * NMAX], sC[kTile * NMAX];
  const int b = blockIdx.x / d.G, g = blockIdx.x % d.G;
  const int hg = d.H / d.G;
  const int row = blockIdx.y * blockDim.x + threadIdx.x;
  const bool live = row < hg * d.P;
  const int h = g * hg + (live ? row / d.P : 0), p = live ? row % d.P : 0;
  const float a_h = A[(b / d.per_copy) * d.H + h];
  float st[NMAX];
#pragma unroll
  for (int n = 0; n < NMAX; ++n) st[n] = 0.f;
  for (int t0 = 0; t0 < d.S; t0 += kTile) {
    __syncthreads();
    stage_bc<NMAX>(sB, sC, Bm, Cm, d, b, g, t0);
    __syncthreads();
    if (!live) continue;
    const int n_t = min(kTile, d.S - t0);
    for (int tt = 0; tt < n_t; ++tt) {
      const long long tok = static_cast<long long>(b) * d.S + t0 + tt;
      const float dtv = to_f32(dt[tok * d.H + h]);
      const float a = expf(dtv * a_h);
      const float u = dtv * to_f32(x[tok * d.ldx + h * d.P + p]);
      const float* bt = sB + tt * NMAX;
      const float* ct = sC + tt * NMAX;
      float acc = 0.f;
#pragma unroll
      for (int n = 0; n < NMAX; ++n) {
        st[n] = fmaf(a, st[n], u * bt[n]);
        acc = fmaf(st[n], ct[n], acc);
      }
      y[(tok * d.H + h) * d.P + p] = from_f32<T>(acc);
    }
  }
}

// ---- backward ----------------------------------------------------------

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Copy `rows` rows of `cols` floats (row r at src + r * ld) into dst (row
// stride dst_ld) with cp.async: 16 bytes a copy where every row is
// 16-byte aligned in both places, else 4.  The caller commits and waits.
__device__ void copy_rows_async(float* dst, int dst_ld, const float* src,
                                long long ld, int rows, int cols) {
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(dst)) &
       15) == 0 &&
      ((ld | dst_ld | cols) & 3) == 0;
  if (aligned) {
    const int q = cols / 4;
    for (int e = threadIdx.x; e < rows * q; e += blockDim.x) {
      const int r = e / q, v = e % q;
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                       smem_u32(dst + r * dst_ld + 4 * v)),
                   "l"(src + r * ld + 4 * v));
    }
  } else {
    for (int e = threadIdx.x; e < rows * cols; e += blockDim.x) {
      const int r = e / cols, v = e % cols;
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                       smem_u32(dst + r * dst_ld + v)),
                   "l"(src + r * ld + v));
    }
  }
}

// n (<= kChunk) floats from shared memory into v, zeros past n; 16-byte
// loads when n is 8 (p is then a multiple of 8, so the row is aligned).
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

// Shared memory of the backward (byte offsets): the fixed part at
// compile-time offsets, then B, C and the boundary sums (kSeg x N f32
// each) and dA (the group's heads, f64).
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

__host__ __device__ constexpr int bwd_smem_bytes(int hg, int N) {
  return kOffB + 4 * 4 * kSeg * N + 8 * hg;
}

template <bool kWide>                // P >= 8: every chunk is 8 p values
__global__ void __launch_bounds__(kBwdThreads, kBwdBlocksPerSM)
    ssd_bwd_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                   const float* __restrict__ A, const float* __restrict__ Bm,
                   const float* __restrict__ Cm, const float* __restrict__ dy,
                   float* __restrict__ dx, float* __restrict__ ddt,
                   double* __restrict__ dA_part, float* __restrict__ dBm,
                   float* __restrict__ dCm, float* __restrict__ ws, Dims d) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int hg = d.H / d.G, N = d.N;
  double* sD2 = reinterpret_cast<double*>(smem + kOffD2);
  float* sX = reinterpret_cast<float*>(smem + kOffX);
  float* sDY = reinterpret_cast<float*>(smem + kOffDY);
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
  double* sDA = reinterpret_cast<double*>(sAccC + kSeg * N);

  const int w8 = kWide ? kChunk : d.P, nc = kWide ? d.P / kChunk : 1;
  const int heads = kSlots / nc;
  const int nhb = (hg + heads - 1) / heads, nseg = (d.S + kSeg - 1) / kSeg;
  const int b = blockIdx.x / d.G, g = blockIdx.x % d.G;
  const int copy = b / d.per_copy;
  const int tid = threadIdx.x, s = tid / kSlots, q = tid % kSlots;
  const int c = q % nc, j = q / nc;            // slot: head j, p-chunk c
  const int col = j * d.P + c * w8;            // the chunk in a staged row
  // the workspace (S > kSeg): the state at the end of each segment but the
  // last, for each CTA, then two carry slots for each CTA
  const long long state = static_cast<long long>(hg) * d.P * N;
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
    copy_rows_async(sX, kBlockRows, x + tok * d.ldx + h0 * d.P, d.ldx, n_t,
                    nh * d.P);
    if (with_dy)
      copy_rows_async(sDY, kBlockRows, dy + (tok * d.H + h0) * d.P,
                      static_cast<long long>(d.H) * d.P, n_t, nh * d.P);
    copy_rows_async(sDt + buf * kSeg * kSlots, kSlots, dt + tok * d.H + h0,
                    d.H, n_t, nh);
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

  // ---- pass 1 (S > kSeg): the state at the end of each segment ----------
  for (int seg = 0; seg < nseg - 1; ++seg) {   // full segments
    const long long tok0 = static_cast<long long>(b) * d.S + seg * kSeg;
    for (int hb = 0; hb < nhb; ++hb) {
      const int hbase = g * hg + hb * heads, nh = min(heads, hg - hb * heads);
      __syncthreads();
      stage(seg, hb, false, 0);
      if (hb == 0)
        for (int e = tid; e < kSeg * N; e += kBwdThreads)
          sB[e] = Bm[(tok0 + e / N) * d.ldb + g * N + e % N];
      wait_stage();
      __syncthreads();
      decays(sDt, hbase, nh, kSeg, true);
      // h_end = pre(last) h_start + sum_s post(s) u_s B_s
      const long long rbase = static_cast<long long>(hb) * heads * d.P;
      for (int e = tid; e < nh * d.P * N; e += kBwdThreads) {
        const int r = e / N, n = e % N, jj = r / d.P;
        const long long at = (rbase + r) * N + n;
        float v = 0.f;
        for (int t = 0; t < kSeg; ++t)
          v = fmaf(sPost[t * kSlots + jj] *
                       (sDt[t * kSlots + jj] * sX[t * kBlockRows + r]),
                   sB[t * N + n], v);
        if (seg > 0)
          v = fmaf(sPre[(kSeg - 1) * kSlots + jj], state_at(seg - 1)[at], v);
        state_at(seg)[at] = v;
      }
    }
  }

  // ---- pass 2: the segments backward, head block by head block ----------
  for (int e = tid; e < hg; e += kBwdThreads) sDA[e] = 0.0;
  float wacc = 0.f;                  // sum_h W[t][s] of (t, s) = (s, q)
  const int nsteps = nseg * nhb;
  __syncthreads();
  stage(nseg - 1, 0, true, 0);
  for (int k = 0; k < nsteps; ++k) {
    const int seg = nseg - 1 - k / nhb, hb = k % nhb;
    const int t0 = seg * kSeg, n_t = min(kSeg, d.S - t0);
    const int hbase = g * hg + hb * heads, nh = min(heads, hg - hb * heads);
    const bool has_h0 = seg > 0, has_carry = seg < nseg - 1;
    const float* sdt = sDt + (k & 1) * kSeg * kSlots;
    const long long tok0 = static_cast<long long>(b) * d.S + t0;
    const long long rbase = static_cast<long long>(hb) * heads * d.P;

    wait_stage();
    __syncthreads();
    if (hb == 0) {            // the segment's B, C and C_t . B_s
      for (int e = tid; e < kSeg * N; e += kBwdThreads) {
        const int t = e / N, n = e % N;
        const bool in = t < n_t;
        sB[e] = in ? Bm[(tok0 + t) * d.ldb + g * N + n] : 0.f;
        sC[e] = in ? Cm[(tok0 + t) * d.ldc + g * N + n] : 0.f;
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
    {
      const bool live = j < nh && s < n_t;
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
    if (nseg > 1) {           // the boundary terms of the block's heads
      const int nrow = nh * d.P;
      const float* h0 = state_at(seg - 1);   // if has_h0
      const float* cin = carry_at(seg);      // if has_carry: a_{t1} g_{t1}
      {                       // thread (t, head jj), over the head's rows
        const int t = tid / kSlots, jj = tid % kSlots;
        if (t < n_t && jj < nh) {
          const float post = sPost[tid], dtv = sdt[tid];
          float e = 0.f, qv = 0.f, k4 = 0.f;
          for (int p = 0; p < d.P; ++p) {
            const int r = jj * d.P + p;
            const long long at = (rbase + r) * N;
            if (has_carry) {  // dx_t += dt_t post(t) (a g) B_t
              float gb = 0.f;
              for (int n = 0; n < N; ++n)
                gb = fmaf(cin[at + n], sB[t * N + n], gb);
              float* o = dx + ((tok0 + t) * d.H + hbase + jj) * d.P + p;
              *o = fmaf(dtv * post, gb, *o);
              e = fmaf(sX[t * kBlockRows + r], gb, e);
            }
            if (has_h0) {     // q_t = dy_t . (h_start C_t)
              float hc = 0.f;
              for (int n = 0; n < N; ++n)
                hc = fmaf(h0[at + n], sC[t * N + n], hc);
              qv = fmaf(sDY[t * kBlockRows + r], hc, qv);
            }
            if (has_carry && has_h0 && t == 0)   // (a g) . h_start
              for (int n = 0; n < N; ++n)
                k4 = fmaf(cin[at + n], h0[at + n], k4);
          }
          if (has_carry) {
            sXd[tid] = fmaf(post, e, sXd[tid]);
            sT3[tid] = post * dtv * e;
          }
          if (has_h0) sQ[tid] = sPre[tid] * qv;
          if (has_carry && has_h0 && t == 0)
            sK4[jj] = sPre[(n_t - 1) * kSlots + jj] * k4;
        }
      }
      for (int e = tid; e < n_t * N; e += kBwdThreads) {
        const int t = e / N, n = e % N;
        if (has_h0) {         // dC_t += sum pre(t) dy_t h_start
          float v = 0.f;
          for (int r = 0; r < nrow; ++r)
            v = fmaf(sPre[t * kSlots + r / d.P] * sDY[t * kBlockRows + r],
                     h0[(rbase + r) * N + n], v);
          sAccC[e] += v;
        }
        if (has_carry) {      // dB_s += sum post(s) u_s a_{t1} g_{t1}
          float v = 0.f;
          for (int r = 0; r < nrow; ++r) {
            const int jj = r / d.P;
            v = fmaf(sPost[t * kSlots + jj] *
                         (sdt[t * kSlots + jj] * sX[t * kBlockRows + r]),
                     cin[(rbase + r) * N + n], v);
          }
          sAccB[e] += v;
        }
      }
      if (has_h0) {           // the carry into the segment before
        for (int e = tid; e < nrow * N; e += kBwdThreads) {
          const int r = e / N, n = e % N, jj = r / d.P;
          float v = 0.f;
          for (int t = 0; t < n_t; ++t)
            v = fmaf(sPre[t * kSlots + jj] * sDY[t * kBlockRows + r],
                     sC[t * N + n], v);
          if (has_carry)
            v = fmaf(sPre[(n_t - 1) * kSlots + jj], cin[(rbase + r) * N + n],
                     v);
          carry_at(seg + 1)[(rbase + r) * N + n] = v;
        }
      }
      __syncthreads();
    }
    if (k + 1 < nsteps)       // the next step's rows, while this one ends
      stage(nseg - 1 - (k + 1) / nhb, (k + 1) % nhb, true, (k + 1) & 1);

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
    if (hb == nhb - 1) {      // the segment's dB and dC
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
        const long long at = (tok0 + tt) * d.G * N + g * N + n;
        dCm[at] = dc;
        dBm[at] = db;
      }
    }
  }
  __syncthreads();
  for (int e = tid; e < hg; e += kBwdThreads)
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

// Opt in to more than 48 KB of dynamic shared memory when needed; 0 or a
// cudaError_t.
template <typename Kernel>
int allow_smem(Kernel kernel, int bytes) {
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

int round_up32(int v) { return (v + 31) / 32 * 32; }

template <typename T, int NMAX>
int fwd(const void* x, const void* dt, const float* A, const void* Bm,
        const void* Cm, void* y, const Dims& d, cudaStream_t stream) {
  const int rows = d.H / d.G * d.P;
  const int threads = min(round_up32(rows), kFwdThreads);
  const dim3 grid(d.B * d.G, (rows + threads - 1) / threads);
  ssd_fwd_kernel<T, NMAX><<<grid, threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dt), A,
      static_cast<const T*>(Bm), static_cast<const T*>(Cm),
      static_cast<T*>(y), d);
  return static_cast<int>(cudaGetLastError());
}

// The shapes the backward takes: N <= 64, P a power of two, (H / G) * P
// up to 512 (N <= 16), 256 (N <= 32) or 128.
bool bwd_takes(int H, int P, int G, int N) {
  const int most = N <= 16 ? 512 : N <= 32 ? 256 : 128;
  return N >= 1 && N <= 64 && P >= 1 && (P & (P - 1)) == 0 && G >= 1 &&
         H % G == 0 && H / G * P <= most;
}

// The backward's instance for P, its dynamic shared memory opted in; 0
// or a cudaError_t.
using BwdKernel = decltype(&ssd_bwd_kernel<true>);
int bwd_prepare(int hg, int P, int N, BwdKernel* kernel, int* bytes) {
  *kernel = P >= kChunk ? ssd_bwd_kernel<true> : ssd_bwd_kernel<false>;
  *bytes = bwd_smem_bytes(hg, N);
  cudaFuncSetAttribute(*kernel,
                       cudaFuncAttributePreferredSharedMemoryCarveout,
                       cudaSharedmemCarveoutMaxShared);
  return allow_smem(*kernel, *bytes);
}

}  // namespace

extern "C" {

// x, y: (B, S, H, P); dt: (B, S, H); Bm, Cm: (B, S, G, N); A: (B /
// per_copy, H) f32.  bf16 != 0: x, dt, Bm, Cm, y are bf16, else f32.
// N <= 64.  Returns a cudaError_t, or -1 for a shape the kernel does not
// take.
int ssd_scan_fwd_launch(const void* x, const void* dt, const float* A,
                        const void* Bm, const void* Cm, void* y, int B, int S,
                        int H, int P, int G, int N, int per_copy,
                        long long ldx, long long ldb, long long ldc, int bf16,
                        cudaStream_t stream) {
  const Dims d{B, S, H, P, G, N, per_copy, ldx, ldb, ldc};
  if (bf16) {
    if (N <= 16) return fwd<__nv_bfloat16, 16>(x, dt, A, Bm, Cm, y, d, stream);
    if (N <= 32) return fwd<__nv_bfloat16, 32>(x, dt, A, Bm, Cm, y, d, stream);
    if (N <= 64) return fwd<__nv_bfloat16, 64>(x, dt, A, Bm, Cm, y, d, stream);
  } else {
    if (N <= 16) return fwd<float, 16>(x, dt, A, Bm, Cm, y, d, stream);
    if (N <= 32) return fwd<float, 32>(x, dt, A, Bm, Cm, y, d, stream);
    if (N <= 64) return fwd<float, 64>(x, dt, A, Bm, Cm, y, d, stream);
  }
  return kBadShape;
}

// f32 throughout.  dx like x (contiguous), ddt like dt, dA like A, dBm and
// dCm like Bm (contiguous); dA_part: (B, H) f64 scratch; ws: with S > 16,
// the segment-end states and the carries, B * G * (ceil(S / 16) + 1) * N *
// (H / G) * P floats (nothing with S <= 16).  N <= 64; P a power of two;
// (H / G) * P <= 512 (N <= 16), 256 (N <= 32) or 128.
int ssd_scan_bwd_launch(const float* x, const float* dt, const float* A,
                        const float* Bm, const float* Cm, const float* dy,
                        float* dx, float* ddt, float* dA, float* dBm,
                        float* dCm, double* dA_part, float* ws, int B, int S,
                        int H, int P, int G, int N, int per_copy,
                        long long ldx, long long ldb, long long ldc,
                        cudaStream_t stream) {
  if (!bwd_takes(H, P, G, N)) return kBadShape;
  const Dims d{B, S, H, P, G, N, per_copy, ldx, ldb, ldc};
  BwdKernel kernel;
  int bytes = 0;
  if (const int err = bwd_prepare(H / G, P, N, &kernel, &bytes)) return err;
  kernel<<<B * G, kBwdThreads, bytes, stream>>>(
      x, dt, A, Bm, Cm, dy, dx, ddt, dA_part, dBm, dCm, ws, d);
  if (const int err = static_cast<int>(cudaGetLastError())) return err;
  const int n = B / per_copy * H;
  ssd_dA_reduce_kernel<<<(n + 255) / 256, 256, 0, stream>>>(
      dA_part, dA, B / per_copy, per_copy, H);
  return static_cast<int>(cudaGetLastError());
}

// The backward's resources at a shape, into out[12]: for ssd_bwd_kernel,
// then ssd_dA_reduce_kernel, six ints each: registers a thread, local
// memory a thread (spills; bytes), static and dynamic shared memory a CTA
// (bytes), resident CTAs an SM, threads a CTA.  Returns a cudaError_t, or
// -1 for a shape the kernel does not take.
int ssd_scan_bwd_resources(int H, int P, int G, int N, int* out) {
  if (!bwd_takes(H, P, G, N)) return kBadShape;
  BwdKernel kernel;
  int bytes = 0;
  if (const int err = bwd_prepare(H / G, P, N, &kernel, &bytes)) return err;
  const void* kernels[2] = {reinterpret_cast<const void*>(kernel),
                            reinterpret_cast<const void*>(ssd_dA_reduce_kernel)};
  const int threads[2] = {kBwdThreads, 256}, dynamic[2] = {bytes, 0};
  for (int i = 0; i < 2; ++i) {
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

}  // extern "C"
