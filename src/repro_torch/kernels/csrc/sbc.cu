// Sparse Binary Compression (SBC) kernels for Hopper (sm_90a): the
// streaming passes of the paper's uplink gradient compression.
//
// Both kernels are segmented: one launch covers S independent segments of
// n contiguous f32 values each (every (row, device) upload of one
// parameter leaf), laid out as a row-major (S, n) array.  Ragged tails are
// masked in the kernel; nothing is padded to a block multiple.
//
// sbc_stats (replaces kernels/sbc.py::_stats_kernel of the TPU package)
//   per segment s, against its threshold thr[s]:
//   [sum |x| over x>0 & |x|>=thr, sum |x| over x<0 & |x|>=thr,
//    count of the first group, count of the second]  -> out (S, 4) f32.
//   Bound: it reads S*n*4 bytes once and writes 16 bytes per segment, so
//   it is bandwidth-bound (3.35 TB/s on an H100 SXM); its arithmetic is a
//   compare and an add per element.  Design: each block streams one tile
//   of TILE values of one segment with 16-byte loads where the row
//   alignment allows, keeps per-thread sums in double and integer counts,
//   and writes one partial per tile; a second pass folds each segment's
//   partials.  Both reductions run in a fixed order (no float atomics), so
//   the result is bitwise reproducible from run to run.
//
// sbc_apply (replaces kernels/sbc.py::_apply_kernel of the TPU package)
//   elementwise, with scalars[s] = [thr, val_pos, val_neg]:
//   out = val_pos where x>0 & |x|>=thr, val_neg where x<0 & |x|>=thr,
//   else 0; and in the same pass the error-feedback residual res = x - out.
//   Bound: it reads S*n*4 bytes and writes 2*S*n*4 bytes (bandwidth-bound).
//   Design: one streaming pass with 16-byte loads and stores where the
//   alignment allows; fusing the residual saves the separate x - out pass
//   (a read of two arrays and a write of one).
//
// C interface (bound with ctypes): every entry point launches on the given
// stream, does not synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 8192;             // values per block per segment

struct Partial {
  double pos_sum;
  double neg_sum;
  unsigned long long pos_cnt;
  unsigned long long neg_cnt;
};

__device__ __forceinline__ void accumulate(float v, float thr, double& ps,
                                           double& ns, unsigned& pc,
                                           unsigned& nc) {
  const float m = fabsf(v);
  if (m >= thr) {
    if (v > 0.f) {
      ps += static_cast<double>(m);
      pc += 1u;
    } else if (v < 0.f) {
      ns += static_cast<double>(m);
      nc += 1u;
    }
  }
}

// Fixed-order block reduction of one Partial per thread; the result is
// valid in thread 0.
__device__ Partial block_reduce(Partial p) {
  __shared__ Partial warp_part[kThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    p.pos_sum += __shfl_down_sync(0xffffffffu, p.pos_sum, off);
    p.neg_sum += __shfl_down_sync(0xffffffffu, p.neg_sum, off);
    p.pos_cnt += __shfl_down_sync(0xffffffffu, p.pos_cnt, off);
    p.neg_cnt += __shfl_down_sync(0xffffffffu, p.neg_cnt, off);
  }
  if (lane == 0) warp_part[warp] = p;
  __syncthreads();
  if (warp == 0) {
    p = lane < kThreads / 32 ? warp_part[lane] : Partial{0.0, 0.0, 0ull, 0ull};
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      p.pos_sum += __shfl_down_sync(0xffffffffu, p.pos_sum, off);
      p.neg_sum += __shfl_down_sync(0xffffffffu, p.neg_sum, off);
      p.pos_cnt += __shfl_down_sync(0xffffffffu, p.pos_cnt, off);
      p.neg_cnt += __shfl_down_sync(0xffffffffu, p.neg_cnt, off);
    }
  }
  return p;
}

// grid (tiles, S): block (t, s) reduces tile t of segment s into
// partials[s * tiles + t].
template <bool kVec4>
__global__ void __launch_bounds__(kThreads)
sbc_stats_partial_kernel(const float* __restrict__ x,
                         const float* __restrict__ thr,
                         Partial* __restrict__ partials, long long n,
                         int tiles) {
  const int seg = blockIdx.y;
  const long long lo = static_cast<long long>(blockIdx.x) * kTile;
  const long long hi = min(lo + kTile, n);
  const float* row = x + static_cast<long long>(seg) * n;
  const float t = thr[seg];
  double ps = 0.0, ns = 0.0;
  unsigned pc = 0u, nc = 0u;
  if (kVec4) {
    // n % 4 == 0 and the base is 16-byte aligned, so every row is too
    const float4* row4 = reinterpret_cast<const float4*>(row);
    for (long long i = lo / 4 + threadIdx.x; i < hi / 4; i += kThreads) {
      const float4 v = __ldg(row4 + i);
      accumulate(v.x, t, ps, ns, pc, nc);
      accumulate(v.y, t, ps, ns, pc, nc);
      accumulate(v.z, t, ps, ns, pc, nc);
      accumulate(v.w, t, ps, ns, pc, nc);
    }
  } else {
    for (long long i = lo + threadIdx.x; i < hi; i += kThreads)
      accumulate(__ldg(row + i), t, ps, ns, pc, nc);
  }
  const Partial p = block_reduce(Partial{ps, ns, pc, nc});
  if (threadIdx.x == 0)
    partials[static_cast<long long>(seg) * tiles + blockIdx.x] = p;
}

// grid (S,): folds segment s's partials in a fixed order into out[s, :].
__global__ void __launch_bounds__(kThreads)
sbc_stats_final_kernel(const Partial* __restrict__ partials,
                       float* __restrict__ out, int tiles) {
  const int seg = blockIdx.x;
  Partial p{0.0, 0.0, 0ull, 0ull};
  for (int i = threadIdx.x; i < tiles; i += kThreads) {
    const Partial q = partials[static_cast<long long>(seg) * tiles + i];
    p.pos_sum += q.pos_sum;
    p.neg_sum += q.neg_sum;
    p.pos_cnt += q.pos_cnt;
    p.neg_cnt += q.neg_cnt;
  }
  p = block_reduce(p);
  if (threadIdx.x == 0) {
    float* o = out + 4ll * seg;
    o[0] = static_cast<float>(p.pos_sum);
    o[1] = static_cast<float>(p.neg_sum);
    o[2] = static_cast<float>(p.pos_cnt);
    o[3] = static_cast<float>(p.neg_cnt);
  }
}

__device__ __forceinline__ float binarize(float v, float thr, float vp,
                                          float vn) {
  const bool keep = fabsf(v) >= thr;
  return keep && v > 0.f ? vp : (keep && v < 0.f ? vn : 0.f);
}

// grid (tiles, S): block (t, s) maps tile t of segment s.
template <bool kVec4>
__global__ void __launch_bounds__(kThreads)
sbc_apply_kernel(const float* __restrict__ x,
                 const float* __restrict__ scalars, float* __restrict__ out,
                 float* __restrict__ res, long long n) {
  const int seg = blockIdx.y;
  const long long lo = static_cast<long long>(blockIdx.x) * kTile;
  const long long hi = min(lo + kTile, n);
  const long long base = static_cast<long long>(seg) * n;
  const float thr = scalars[3 * seg];
  const float vp = scalars[3 * seg + 1];
  const float vn = scalars[3 * seg + 2];
  if (kVec4) {
    const float4* x4 = reinterpret_cast<const float4*>(x + base);
    float4* o4 = reinterpret_cast<float4*>(out + base);
    float4* r4 = reinterpret_cast<float4*>(res + base);
    for (long long i = lo / 4 + threadIdx.x; i < hi / 4; i += kThreads) {
      const float4 v = __ldg(x4 + i);
      float4 o;
      o.x = binarize(v.x, thr, vp, vn);
      o.y = binarize(v.y, thr, vp, vn);
      o.z = binarize(v.z, thr, vp, vn);
      o.w = binarize(v.w, thr, vp, vn);
      o4[i] = o;
      r4[i] = make_float4(__fsub_rn(v.x, o.x), __fsub_rn(v.y, o.y),
                          __fsub_rn(v.z, o.z), __fsub_rn(v.w, o.w));
    }
  } else {
    for (long long i = lo + threadIdx.x; i < hi; i += kThreads) {
      const float v = __ldg(x + base + i);
      const float o = binarize(v, thr, vp, vn);
      out[base + i] = o;
      res[base + i] = __fsub_rn(v, o);
    }
  }
}

int tiles_of(long long n) { return static_cast<int>((n + kTile - 1) / kTile); }

}  // namespace

extern "C" {

int sbc_tile() { return kTile; }

int sbc_partial_bytes() { return static_cast<int>(sizeof(Partial)); }

// x: (S, n) f32; thr: (S,) f32; partials: scratch of S * tiles Partials
// (tiles = ceil(n / sbc_tile()), sbc_partial_bytes() each); out: (S, 4).
int sbc_stats_launch(const float* x, const float* thr, void* partials,
                     float* out, int segments, long long n, int vec4,
                     cudaStream_t stream) {
  const int tiles = tiles_of(n);
  Partial* part = static_cast<Partial*>(partials);
  const dim3 grid(tiles, segments);
  if (vec4)
    sbc_stats_partial_kernel<true><<<grid, kThreads, 0, stream>>>(
        x, thr, part, n, tiles);
  else
    sbc_stats_partial_kernel<false><<<grid, kThreads, 0, stream>>>(
        x, thr, part, n, tiles);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  sbc_stats_final_kernel<<<segments, kThreads, 0, stream>>>(part, out, tiles);
  return static_cast<int>(cudaGetLastError());
}

// x, out, res: (S, n) f32; scalars: (S, 3) f32 [thr, val_pos, val_neg].
int sbc_apply_launch(const float* x, const float* scalars, float* out,
                     float* res, int segments, long long n, int vec4,
                     cudaStream_t stream) {
  const dim3 grid(tiles_of(n), segments);
  if (vec4)
    sbc_apply_kernel<true><<<grid, kThreads, 0, stream>>>(x, scalars, out,
                                                          res, n);
  else
    sbc_apply_kernel<false><<<grid, kThreads, 0, stream>>>(x, scalars, out,
                                                           res, n);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
