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
//   One CTA owns one (sequence, group): a thread per (h, p) row of the
//   group's heads.  With u_t = dt_t x_t, a_t = exp(dt_t A), the adjoint
//   state g_t = dL/dh_t = a_{t+1} g_{t+1} + dy_t C_t^T, and cum_t the sum of
//   log a_k to t:
//     dx_t = dt_t (g_t B_t)            dB_t = sum_{h, p} g_t u_t
//     dC_t = sum_{h, p} h_t dy_t       d log a_t = sum_{p, n} g_t a_t h_{t-1}
//     ddt_t = x_t . (g_t B_t) + A d log a_t,   dA = sum_t dt_t d log a_t.
//   Pass 1 runs forward (h_t, dC_t, the state at every segment start of
//   kTile tokens, written to a workspace sized at launch: (B, G,
//   segments - 1, N, rows) f32, empty when S <= kTile); pass 2 runs
//   backward (g_t, dx_t, dB_t, d log a_t).  d log a_t needs h_{t-1} while
//   g runs backward: pass 2 first runs the segment forward again from its
//   start state, saving each row's state every kSub tokens in shared
//   memory, and then rebuilds h_{t-1} from the nearest saved state (at
//   most kSub - 1 steps, in pass 1's arithmetic).  So d log a is summed
//   directly, with no cancellation between large partial sums (measured:
//   closer to a float64 oracle than autograd of the chunked oracle in
//   f32).  The sums over the heads of a group (dB, dC) run as a
//   recursive-halving reduce-scatter across each warp, those over the
//   rows of a head as warp shuffles, both in a fixed pattern, and then
//   over the warps' partials in shared memory in a fixed order; dA's
//   per-sequence partials (f64) are summed per copy in sequence order by
//   ssd_dA_reduce_kernel.  No atomics: the backward is
//   bitwise reproducible, and a copy's dA does not depend on how many
//   copies share the launch.
//
// Bound.  At the port's shapes (S 16, H 64, P 8, N 16) both kernels are
// bound by their bytes (each reads its inputs once and writes its outputs
// once, 3.35 TB/s on an H100 SXM) against a few f32 operations a byte.
// This first version issues plain FMAs and shuffles; tensor cores and TMA
// are left for a later, faster version.
//
// C interface (bound with ctypes): every entry point launches on the given
// stream, does not synchronise, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 16;          // tokens a tile stages; backward segment
constexpr int kSub = 4;            // backward: a state saved every kSub
constexpr int kFwdThreads = 256;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kBadShape = -1;      // a shape the kernels do not take

template <int NMAX>
constexpr int bwd_threads() { return NMAX <= 16 ? 512 : 8192 / NMAX; }

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

// Sums each of a lane's NMAX values over the warp's 32 lanes by recursive
// halving, in a fixed pattern: afterwards v[0 .. K) of lane l hold the sums
// for n = base .. base + K - 1 (K = max(NMAX / 32, 1)); returns base.  With
// NMAX < 32, lanes that differ only in their low bits hold the same sums.
template <int NMAX>
__device__ __forceinline__ int warp_reduce_scatter(float (&v)[NMAX],
                                                   int lane) {
  int base = 0, cnt = NMAX;
#pragma unroll
  for (int step = 0; step < 5; ++step) {
    const int off = 16 >> step;
    if (cnt > 1) {
      const int half = cnt / 2;
      const bool upper = lane & off;
#pragma unroll
      for (int i = 0; i < NMAX / 2; ++i) {
        if (i < half) {
          const float send = upper ? v[i] : v[i + half];
          const float keep = upper ? v[i + half] : v[i];
          v[i] = keep + __shfl_xor_sync(kFull, send, off);
        }
      }
      if (upper) base += half;
      cnt = half;
    } else {
      v[0] += __shfl_xor_sync(kFull, v[0], off);
    }
  }
  return base;
}

// The warp's sums of a lane's NMAX values into red[0 .. NMAX).
template <int NMAX>
__device__ __forceinline__ void warp_sums_to(float* red, float (&v)[NMAX],
                                             int lane) {
  constexpr int kPer = NMAX >= 32 ? NMAX / 32 : 1;
  const int base = warp_reduce_scatter<NMAX>(v, lane);
  if (NMAX >= 32 || (lane & (32 / NMAX - 1)) == 0) {
#pragma unroll
    for (int i = 0; i < kPer; ++i) red[base + i] = v[i];
  }
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

template <int NMAX>
__global__ void __launch_bounds__(bwd_threads<NMAX>())
    ssd_bwd_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                   const float* __restrict__ A, const float* __restrict__ Bm,
                   const float* __restrict__ Cm, const float* __restrict__ dy,
                   float* __restrict__ dx, float* __restrict__ ddt,
                   double* __restrict__ dA_part, float* __restrict__ dBm,
                   float* __restrict__ dCm, float* __restrict__ ws, Dims d) {
  extern __shared__ float smem[];
  const int hg = d.H / d.G, rows = hg * d.P;
  const int nwarps = blockDim.x / 32, warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int seg_w = min(d.P, 32), nsub = (d.P + 31) / 32;
  float* sB = smem;                                 // kTile x NMAX
  float* sC = sB + kTile * NMAX;                    // kTile x NMAX
  float* sRed = sC + kTile * NMAX;                  // kTile x warps x NMAX
  float* sR = sRed + kTile * nwarps * NMAX;         // kTile x hg x nsub
  float* sXdu = sR + kTile * hg * nsub;             // kTile x hg x nsub
  float* sCk = sXdu + kTile * hg * nsub;            // kTile/kSub x NMAX x
                                                    //   threads

  const int b = blockIdx.x / d.G, g = blockIdx.x % d.G;
  const int row = threadIdx.x;
  const bool live = row < rows;
  const int hl = live ? row / d.P : 0, p = live ? row % d.P : 0;
  const int h = g * hg + hl, sub = p / 32;
  const bool lead = live && p % seg_w == 0;         // writes a head partial
  const int copy = b / d.per_copy;
  const float a_h = A[copy * d.H + h];
  const int nseg = (d.S + kTile - 1) / kTile;
  float* wsb = ws + static_cast<long long>(blockIdx.x) * (nseg - 1) * d.N *
                        rows;

  // this row's dt, x and dy at token t (zeros for a thread past the rows)
  auto load = [&](int t, float& dtv, float& xv, float& dyv) {
    const long long tok = static_cast<long long>(b) * d.S + t;
    dtv = live ? dt[tok * d.H + h] : 0.f;
    xv = live ? x[tok * d.ldx + h * d.P + p] : 0.f;
    dyv = live ? dy[(tok * d.H + h) * d.P + p] : 0.f;
  };
  auto head_at = [&](float* s, int tt, int j, int k) -> float& {
    return s[(tt * hg + j) * nsub + k];
  };

  // ---- pass 1: forward — dC and the state at every segment start ----
  {
    float st[NMAX];
#pragma unroll
    for (int n = 0; n < NMAX; ++n) st[n] = 0.f;
    for (int s = 0; s < nseg; ++s) {
      const int t0 = s * kTile;
      if (s > 0 && live) {
#pragma unroll
        for (int n = 0; n < NMAX; ++n)
          if (n < d.N)
            wsb[(static_cast<long long>(s - 1) * d.N + n) * rows + row] =
                st[n];
      }
      __syncthreads();
      stage_bc<NMAX>(sB, sC, Bm, Cm, d, b, g, t0);
      __syncthreads();
#pragma unroll
      for (int tt = 0; tt < kTile; ++tt) {
        if (t0 + tt < d.S) {                        // uniform in the CTA
          float dtv, xv, dyv;
          load(t0 + tt, dtv, xv, dyv);
          const float a = expf(dtv * a_h), u = dtv * xv;
          const float* bt = sB + tt * NMAX;
          float v[NMAX];
#pragma unroll
          for (int n = 0; n < NMAX; ++n) {
            st[n] = fmaf(a, st[n], u * bt[n]);
            v[n] = st[n] * dyv;
          }
          warp_sums_to<NMAX>(sRed + (tt * nwarps + warp) * NMAX, v, lane);
        }
      }
      __syncthreads();
      const int n_t = min(kTile, d.S - t0);
      for (int e = threadIdx.x; e < n_t * d.N; e += blockDim.x) {
        const int tt = e / d.N, n = e % d.N;
        float v = 0.f;
        for (int w = 0; w < nwarps; ++w)
          v += sRed[(tt * nwarps + w) * NMAX + n];
        dCm[(static_cast<long long>(b) * d.S + t0 + tt) * d.G * d.N +
            g * d.N + n] = v;
      }
    }
  }

  // ---- pass 2: backward — dx, dB, ddt, dA ----
  float gst[NMAX];
#pragma unroll
  for (int n = 0; n < NMAX; ++n) gst[n] = 0.f;
  float a_next = 0.f;
  double dA_acc = 0.0;                              // thread j < hg: head j
  for (int s = nseg - 1; s >= 0; --s) {
    const int t0 = s * kTile;
    __syncthreads();
    stage_bc<NMAX>(sB, sC, Bm, Cm, d, b, g, t0);
    __syncthreads();
    // the segment's u_k, a_k, and this row's state at every kSub-th token
    // (from the state entering the segment, in pass 1's arithmetic) in
    // the thread's own slots of sCk
    float us[kTile], as[kTile], hv[NMAX];
#pragma unroll
    for (int n = 0; n < NMAX; ++n)
      hv[n] = (s > 0 && live && n < d.N)
                  ? wsb[(static_cast<long long>(s - 1) * d.N + n) * rows +
                        row]
                  : 0.f;
#pragma unroll
    for (int tt = 0; tt < kTile; ++tt) {
      float dtv = 0.f, xv = 0.f, dyv;
      if (t0 + tt < d.S) load(t0 + tt, dtv, xv, dyv);
      us[tt] = dtv * xv;
      as[tt] = expf(dtv * a_h);
      if (tt % kSub == 0) {
#pragma unroll
        for (int n = 0; n < NMAX; ++n)
          sCk[((tt / kSub) * NMAX + n) * blockDim.x + row] = hv[n];
      }
      const float* bt = sB + tt * NMAX;
#pragma unroll
      for (int n = 0; n < NMAX; ++n)
        hv[n] = fmaf(as[tt], hv[n], us[tt] * bt[n]);
    }
#pragma unroll
    for (int tt = kTile - 1; tt >= 0; --tt) {
      if (t0 + tt < d.S) {                          // uniform in the CTA
        float dtv, xv, dyv;
        load(t0 + tt, dtv, xv, dyv);
        const float* bt = sB + tt * NMAX;
        const float* ct = sC + tt * NMAX;
        float gb = 0.f, cb = 0.f;
#pragma unroll
        for (int n = 0; n < NMAX; ++n) {
          gst[n] *= a_next;
          gb = fmaf(gst[n], bt[n], gb);
          cb = fmaf(ct[n], bt[n], cb);
          gst[n] = fmaf(dyv, ct[n], gst[n]);
        }
        const float du = fmaf(dyv, cb, gb);
        // h_{t-1}: from the nearest saved state at or before it, in pass
        // 1's arithmetic; d log a_t = a_t sum_{p, n} g_t h_{t-1}
        const int c = tt / kSub;
#pragma unroll
        for (int n = 0; n < NMAX; ++n)
          hv[n] = sCk[(c * NMAX + n) * blockDim.x + row];
#pragma unroll
        for (int k = c * kSub; k < tt; ++k) {
          const float* bk = sB + k * NMAX;
#pragma unroll
          for (int n = 0; n < NMAX; ++n)
            hv[n] = fmaf(as[k], hv[n], us[k] * bk[n]);
        }
        float gh = 0.f;
#pragma unroll
        for (int n = 0; n < NMAX; ++n) gh = fmaf(gst[n], hv[n], gh);
        if (live)
          dx[((static_cast<long long>(b) * d.S + t0 + tt) * d.H + h) * d.P +
             p] = dtv * du;
        const float r = seg_sum(as[tt] * gh, seg_w);
        const float xd = seg_sum(xv * du, seg_w);
        if (lead) {
          head_at(sR, tt, hl, sub) = r;
          head_at(sXdu, tt, hl, sub) = xd;
        }
        float v[NMAX];
#pragma unroll
        for (int n = 0; n < NMAX; ++n) v[n] = gst[n] * us[tt];
        warp_sums_to<NMAX>(sRed + (tt * nwarps + warp) * NMAX, v, lane);
        a_next = as[tt];
      }
    }
    __syncthreads();
    const int n_t = min(kTile, d.S - t0);
    for (int e = threadIdx.x; e < n_t * d.N; e += blockDim.x) {
      const int tt = e / d.N, n = e % d.N;
      float v = 0.f;
      for (int w = 0; w < nwarps; ++w) v += sRed[(tt * nwarps + w) * NMAX + n];
      dBm[(static_cast<long long>(b) * d.S + t0 + tt) * d.G * d.N + g * d.N +
          n] = v;
    }
    for (int e = threadIdx.x; e < n_t * hg; e += blockDim.x) {
      const int tt = e / hg, j = e % hg, hh = g * hg + j;
      float r = 0.f, xd = 0.f;
      for (int k = 0; k < nsub; ++k) {
        r += head_at(sR, tt, j, k);
        xd += head_at(sXdu, tt, j, k);
      }
      const long long at =
          (static_cast<long long>(b) * d.S + t0 + tt) * d.H + hh;
      ddt[at] = fmaf(r, A[copy * d.H + hh], xd);
    }
    if (threadIdx.x < hg) {                         // one thread per head:
      const int j = threadIdx.x;                    // dA in token order
      for (int tt = 0; tt < n_t; ++tt) {
        float r = 0.f;
        for (int k = 0; k < nsub; ++k) r += head_at(sR, tt, j, k);
        dA_acc += static_cast<double>(r) *
                  static_cast<double>(dt[(static_cast<long long>(b) * d.S +
                                          t0 + tt) * d.H + g * hg + j]);
      }
    }
  }
  if (threadIdx.x < hg)
    dA_part[static_cast<long long>(b) * d.H + g * hg + threadIdx.x] = dA_acc;
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

template <int NMAX>
int bwd(const float* x, const float* dt, const float* A, const float* Bm,
        const float* Cm, const float* dy, float* dx, float* ddt, float* dA,
        float* dBm, float* dCm, double* dA_part, float* ws, const Dims& d,
        int copies, cudaStream_t stream) {
  const int hg = d.H / d.G, rows = hg * d.P;
  const int threads = round_up32(rows);
  if (threads > bwd_threads<NMAX>()) return kBadShape;
  const int nsub = (d.P + 31) / 32;
  const int floats = 2 * kTile * NMAX + kTile * (threads / 32) * NMAX +
                     2 * kTile * hg * nsub + kTile / kSub * NMAX * threads;
  const int bytes = floats * static_cast<int>(sizeof(float));
  auto kernel = ssd_bwd_kernel<NMAX>;
  if (const int err = allow_smem(kernel, bytes)) return err;
  kernel<<<d.B * d.G, threads, bytes, stream>>>(x, dt, A, Bm, Cm, dy, dx, ddt,
                                                dA_part, dBm, dCm, ws, d);
  if (const int err = static_cast<int>(cudaGetLastError())) return err;
  const int n = copies * d.H;
  ssd_dA_reduce_kernel<<<(n + 255) / 256, 256, 0, stream>>>(
      dA_part, dA, copies, d.per_copy, d.H);
  return static_cast<int>(cudaGetLastError());
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
// dCm like Bm (contiguous); dA_part: (B, H) f64 scratch; ws: the segment
// checkpoints, B * G * (ceil(S / 16) - 1) * N * (H / G) * P floats.
// N <= 64; P a power of two; (H / G) * P <= 512 (N <= 16), 256 (N <= 32)
// or 128.
int ssd_scan_bwd_launch(const float* x, const float* dt, const float* A,
                        const float* Bm, const float* Cm, const float* dy,
                        float* dx, float* ddt, float* dA, float* dBm,
                        float* dCm, double* dA_part, float* ws, int B, int S,
                        int H, int P, int G, int N, int per_copy,
                        long long ldx, long long ldb, long long ldc,
                        cudaStream_t stream) {
  const Dims d{B, S, H, P, G, N, per_copy, ldx, ldb, ldc};
  const int copies = B / per_copy;
  if (N <= 16)
    return bwd<16>(x, dt, A, Bm, Cm, dy, dx, ddt, dA, dBm, dCm, dA_part, ws,
                   d, copies, stream);
  if (N <= 32)
    return bwd<32>(x, dt, A, Bm, Cm, dy, dx, ddt, dA, dBm, dCm, dA_part, ws,
                   d, copies, stream);
  if (N <= 64)
    return bwd<64>(x, dt, A, Bm, Cm, dy, dx, ddt, dA, dBm, dCm, dA_part, ws,
                   d, copies, stream);
  return kBadShape;
}

}  // extern "C"
