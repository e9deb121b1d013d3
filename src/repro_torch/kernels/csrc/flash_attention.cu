// Flash attention for Hopper (sm_90a): the forward pass and a
// deterministic backward, f32 accumulation throughout.
//
// Layout.  q, o: (B, S, Hq, HD); k, v: (B, S, Hkv, HD), all contiguous —
// the model's own (batch, seq, head, dim) layout, so no transpose is made
// around the kernels.  Grouped-query attention is resolved by index: query
// head h reads KV head h / (Hq / Hkv); K and V are never repeated.  lse and
// D: (B, Hq, S) f32.  Positions are 0..S-1; the mask is causal and/or a
// sliding window by absolute position (pos_k > pos_q - window), as in the
// TPU kernel.  S need not be a multiple of any tile: ragged tails are
// masked in the kernels (the TPU kernel asserts S % block == 0).
//
// flash_attention_fwd (replaces kernels/flash_attention.py::_flash_kernel
// of the TPU package)
//   o = softmax(scale * q k^T, masked) v with an online softmax (running
//   max m and sum l in f32), o = acc / max(l, 1e-30) in the input type;
//   also writes the row log-sum-exp lse = m + log(l) for the backward.
//   f32 or bf16 inputs.
// flash_attention_bwd_dq (no TPU counterpart: the TPU package has no
// backward kernel)
//   D = rowsum(dO * O) (written for the dK/dV kernel), then
//   dQ = scale * sum_j dS_ij k_j with P = exp(S - lse), dS = P (dP - D),
//   dP = dO v^T.
// flash_attention_bwd_dkdv (no TPU counterpart)
//   per KV head, over the g query heads of its group and all query rows:
//   dV_j = sum_i P_ij dO_i and dK_j = scale * sum_i dS_ij q_i.
//   It reads the D that the dQ kernel wrote, so it is launched after it on
//   the same stream.
//
// Bound.  At this repository's shapes (S = 16, HD = 64) every kernel is
// bound by its bytes: each reads its inputs once and writes its outputs
// once (3.35 TB/s on an H100 SXM), against a few tens of f32 operations a
// byte.  Design: one CTA of four warps owns 16 rows (query rows for the
// forward and dQ, key rows for dK/dV) and streams tiles of 32 rows of the
// other operand through shared memory, one row per lane; scores are dot
// products over HD in registers, rows are reduced with warp shuffles, and
// each lane carries HD/32 columns of its accumulators.  Every sum runs in
// a fixed order and every output element is written by one thread once —
// no atomics — so the results are bitwise reproducible from run to run.
// wgmma and TMA are left for a later, faster version.
//
// C interface (bound with ctypes): every entry point launches on the given
// stream, does not synchronise, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;     // four warps
constexpr int kRows = 16;         // rows a CTA owns
constexpr int kRowsPerWarp = kRows / (kThreads / 32);
constexpr int kCols = 32;         // rows of the streamed tile, one per lane
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

struct Shape {
  int B, S, Hq, Hkv;
  int causal;
  int window;                     // <= 0: no window
  float scale;
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

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

__device__ __forceinline__ bool visible(const Shape& sh, int pq, int pk) {
  return pq < sh.S && pk < sh.S && (!sh.causal || pk <= pq) &&
         (sh.window <= 0 || pk > pq - sh.window);
}

// Element offset of row (b, s, head h) in a (B, S, H, HD) tensor.
template <int HD>
__device__ __forceinline__ size_t row_off(const Shape& sh, int H, int b,
                                          int s, int h) {
  return ((static_cast<size_t>(b) * sh.S + s) * H + h) * HD;
}

// Stage n rows (s0 .. s0+n-1, head h) of a (B, S, H, HD) tensor into shared
// memory as f32 with row stride ld; rows past S are zero.
template <int HD, typename T>
__device__ void stage(float* dst, int ld, const T* __restrict__ src,
                      const Shape& sh, int H, int b, int s0, int n, int h) {
  for (int e = threadIdx.x; e < n * HD; e += kThreads) {
    const int r = e / HD, c = e % HD, s = s0 + r;
    dst[r * ld + c] =
        s < sh.S ? to_f32(src[row_off<HD>(sh, H, b, s, h) + c]) : 0.f;
  }
}

// The key range [lo, hi) that query rows [q0, q1) can see.
__device__ __forceinline__ void key_range(const Shape& sh, int q0, int q1,
                                          int& lo, int& hi) {
  hi = sh.causal ? min(q1, sh.S) : sh.S;
  lo = sh.window > 0 ? max(0, q0 - sh.window + 1) : 0;
}

// The query range [lo, hi) that key rows [k0, k1) are seen by.
__device__ __forceinline__ void query_range(const Shape& sh, int k0, int k1,
                                            int& lo, int& hi) {
  lo = sh.causal ? k0 : 0;
  hi = sh.window > 0 ? min(sh.S, k1 - 1 + sh.window) : sh.S;
}

// Shared memory of each kernel, in floats.
template <int HD> constexpr int fwd_smem() {
  return kRows * HD + kCols * (HD + 1) + kCols * HD;
}
template <int HD> constexpr int dq_smem() {
  return 2 * kRows * HD + 2 * kCols * (HD + 1);
}
template <int HD> constexpr int dkdv_smem() {
  return 2 * kRows * HD + 2 * kCols * (HD + 1) + 2 * kCols;
}

// ---------------------------------------------------------------------------
// forward: CTA (b, h, 16-row query tile)
// ---------------------------------------------------------------------------

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, T* __restrict__ o,
           float* __restrict__ lse, Shape sh) {
  constexpr int LD = HD + 1, PER = HD / 32;
  extern __shared__ float smem[];
  float* qs = smem;                       // [kRows][HD]
  float* ks = qs + kRows * HD;            // [kCols][LD]
  float* vs = ks + kCols * LD;            // [kCols][HD]
  const int tiles = (sh.S + kRows - 1) / kRows;
  const int tile = blockIdx.x % tiles;
  const int h = (blockIdx.x / tiles) % sh.Hq;
  const int b = blockIdx.x / tiles / sh.Hq;
  const int hk = h / (sh.Hq / sh.Hkv);
  const int q0 = tile * kRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  stage<HD>(qs, HD, q, sh, sh.Hq, b, q0, kRows, h);
  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][PER];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < PER; ++c) acc[r][c] = 0.f;
  }
  int lo, hi;
  key_range(sh, q0, q0 + kRows, lo, hi);
  for (int k0 = lo; k0 < hi; k0 += kCols) {
    const int n = min(kCols, sh.S - k0);
    __syncthreads();
    stage<HD>(ks, LD, k, sh, sh.Hkv, b, k0, kCols, hk);
    stage<HD>(vs, HD, v, sh, sh.Hkv, b, k0, kCols, hk);
    __syncthreads();
    const int pk = k0 + lane;
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int i = warp * kRowsPerWarp + r, pq = q0 + i;
      const float* qi = qs + i * HD;
      const float* kj = ks + lane * LD;
      float s = 0.f;
#pragma unroll 16
      for (int d = 0; d < HD; ++d) s = fmaf(qi[d], kj[d], s);
      s = visible(sh, pq, pk) ? s * sh.scale : kNegInf;
      const float m_new = fmaxf(m[r], warp_max(s));
      const float p = expf(s - m_new);
      const float corr = expf(m[r] - m_new);
      l[r] = l[r] * corr + warp_sum(p);
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < PER; ++c) acc[r][c] *= corr;
      for (int j = 0; j < n; ++j) {
        const float pj = __shfl_sync(kFull, p, j);
#pragma unroll
        for (int c = 0; c < PER; ++c)
          acc[r][c] = fmaf(pj, vs[j * HD + c * 32 + lane], acc[r][c]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int pq = q0 + warp * kRowsPerWarp + r;
    if (pq >= sh.S) continue;
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
    T* orow = o + row_off<HD>(sh, sh.Hq, b, pq, h);
#pragma unroll
    for (int c = 0; c < PER; ++c)
      orow[c * 32 + lane] = from_f32<T>(acc[r][c] * inv);
    if (lane == 0)
      lse[(static_cast<size_t>(b) * sh.Hq + h) * sh.S + pq] = m[r] + logf(l[r]);
  }
}

// ---------------------------------------------------------------------------
// backward, dQ (and D): CTA (b, h, 16-row query tile)
// ---------------------------------------------------------------------------

template <int HD>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, const float* __restrict__ o,
          const float* __restrict__ lse, const float* __restrict__ dout,
          float* __restrict__ dq, float* __restrict__ dsum, Shape sh) {
  constexpr int LD = HD + 1, PER = HD / 32;
  extern __shared__ float smem[];
  float* qs = smem;                       // [kRows][HD]
  float* dos = qs + kRows * HD;           // [kRows][HD]
  float* ks = dos + kRows * HD;           // [kCols][LD]
  float* vs = ks + kCols * LD;            // [kCols][LD]
  const int tiles = (sh.S + kRows - 1) / kRows;
  const int tile = blockIdx.x % tiles;
  const int h = (blockIdx.x / tiles) % sh.Hq;
  const int b = blockIdx.x / tiles / sh.Hq;
  const int hk = h / (sh.Hq / sh.Hkv);
  const int q0 = tile * kRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t stat = (static_cast<size_t>(b) * sh.Hq + h) * sh.S;

  stage<HD>(qs, HD, q, sh, sh.Hq, b, q0, kRows, h);
  stage<HD>(dos, HD, dout, sh, sh.Hq, b, q0, kRows, h);
  __syncthreads();
  float dr[kRowsPerWarp], lr[kRowsPerWarp], acc[kRowsPerWarp][PER];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int i = warp * kRowsPerWarp + r, pq = q0 + i;
    float part = 0.f;
    if (pq < sh.S) {
      const float* orow = o + row_off<HD>(sh, sh.Hq, b, pq, h);
#pragma unroll
      for (int c = 0; c < PER; ++c)
        part = fmaf(dos[i * HD + c * 32 + lane], orow[c * 32 + lane], part);
    }
    dr[r] = warp_sum(part);
    lr[r] = pq < sh.S ? lse[stat + pq] : 0.f;
    if (lane == 0 && pq < sh.S) dsum[stat + pq] = dr[r];
#pragma unroll
    for (int c = 0; c < PER; ++c) acc[r][c] = 0.f;
  }
  int lo, hi;
  key_range(sh, q0, q0 + kRows, lo, hi);
  for (int k0 = lo; k0 < hi; k0 += kCols) {
    const int n = min(kCols, sh.S - k0);
    __syncthreads();
    stage<HD>(ks, LD, k, sh, sh.Hkv, b, k0, kCols, hk);
    stage<HD>(vs, LD, v, sh, sh.Hkv, b, k0, kCols, hk);
    __syncthreads();
    const int pk = k0 + lane;
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int i = warp * kRowsPerWarp + r, pq = q0 + i;
      const float* qi = qs + i * HD;
      const float* doi = dos + i * HD;
      const float* kj = ks + lane * LD;
      const float* vj = vs + lane * LD;
      float s = 0.f, dp = 0.f;
#pragma unroll 16
      for (int d = 0; d < HD; ++d) {
        s = fmaf(qi[d], kj[d], s);
        dp = fmaf(doi[d], vj[d], dp);
      }
      const float p = visible(sh, pq, pk) ? expf(s * sh.scale - lr[r]) : 0.f;
      const float ds = p * (dp - dr[r]);
      for (int j = 0; j < n; ++j) {
        const float dsj = __shfl_sync(kFull, ds, j);
#pragma unroll
        for (int c = 0; c < PER; ++c)
          acc[r][c] = fmaf(dsj, ks[j * LD + c * 32 + lane], acc[r][c]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int pq = q0 + warp * kRowsPerWarp + r;
    if (pq >= sh.S) continue;
    float* row = dq + row_off<HD>(sh, sh.Hq, b, pq, h);
#pragma unroll
    for (int c = 0; c < PER; ++c) row[c * 32 + lane] = acc[r][c] * sh.scale;
  }
}

// ---------------------------------------------------------------------------
// backward, dK and dV: CTA (b, KV head, 16-row key tile)
// ---------------------------------------------------------------------------

template <int HD>
__global__ void __launch_bounds__(kThreads)
dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ lse,
            const float* __restrict__ dout, const float* __restrict__ dsum,
            float* __restrict__ dk, float* __restrict__ dv, Shape sh) {
  constexpr int LD = HD + 1, PER = HD / 32;
  extern __shared__ float smem[];
  float* ks = smem;                       // [kRows][HD]
  float* vs = ks + kRows * HD;            // [kRows][HD]
  float* qs = vs + kRows * HD;            // [kCols][LD]
  float* dos = qs + kCols * LD;           // [kCols][LD]
  float* ls = dos + kCols * LD;           // [kCols]
  float* dsm = ls + kCols;                // [kCols]
  const int tiles = (sh.S + kRows - 1) / kRows;
  const int tile = blockIdx.x % tiles;
  const int hk = (blockIdx.x / tiles) % sh.Hkv;
  const int b = blockIdx.x / tiles / sh.Hkv;
  const int g = sh.Hq / sh.Hkv;
  const int k0 = tile * kRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  stage<HD>(ks, HD, k, sh, sh.Hkv, b, k0, kRows, hk);
  stage<HD>(vs, HD, v, sh, sh.Hkv, b, k0, kRows, hk);
  float gk[kRowsPerWarp][PER], gv[kRowsPerWarp][PER];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
    for (int c = 0; c < PER; ++c) gk[r][c] = gv[r][c] = 0.f;
  int lo, hi;
  query_range(sh, k0, k0 + kRows, lo, hi);
  for (int h = hk * g; h < (hk + 1) * g; ++h) {
    const size_t stat = (static_cast<size_t>(b) * sh.Hq + h) * sh.S;
    for (int qb = lo; qb < hi; qb += kCols) {
      const int n = min(kCols, sh.S - qb);
      __syncthreads();
      stage<HD>(qs, LD, q, sh, sh.Hq, b, qb, kCols, h);
      stage<HD>(dos, LD, dout, sh, sh.Hq, b, qb, kCols, h);
      if (threadIdx.x < kCols) {
        const int pq = qb + threadIdx.x;
        ls[threadIdx.x] = pq < sh.S ? lse[stat + pq] : 0.f;
        dsm[threadIdx.x] = pq < sh.S ? dsum[stat + pq] : 0.f;
      }
      __syncthreads();
      const int pq = qb + lane;
      const float* qi = qs + lane * LD;
      const float* doi = dos + lane * LD;
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const int j = warp * kRowsPerWarp + r, pk = k0 + j;
        const float* kj = ks + j * HD;
        const float* vj = vs + j * HD;
        float s = 0.f, dp = 0.f;
#pragma unroll 16
        for (int d = 0; d < HD; ++d) {
          s = fmaf(qi[d], kj[d], s);
          dp = fmaf(doi[d], vj[d], dp);
        }
        const float p =
            visible(sh, pq, pk) ? expf(s * sh.scale - ls[lane]) : 0.f;
        const float ds = p * (dp - dsm[lane]);
        for (int i = 0; i < n; ++i) {
          const float pi = __shfl_sync(kFull, p, i);
          const float dsi = __shfl_sync(kFull, ds, i);
#pragma unroll
          for (int c = 0; c < PER; ++c) {
            gv[r][c] = fmaf(pi, dos[i * LD + c * 32 + lane], gv[r][c]);
            gk[r][c] = fmaf(dsi, qs[i * LD + c * 32 + lane], gk[r][c]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int pk = k0 + warp * kRowsPerWarp + r;
    if (pk >= sh.S) continue;
    const size_t off = row_off<HD>(sh, sh.Hkv, b, pk, hk);
#pragma unroll
    for (int c = 0; c < PER; ++c) {
      dk[off + c * 32 + lane] = gk[r][c] * sh.scale;
      dv[off + c * 32 + lane] = gv[r][c];
    }
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

// Allow a kernel the dynamic shared memory it needs above the 48 KB
// default; returns a cudaError_t.
template <typename Kernel>
int allow_smem(Kernel kernel, int bytes) {
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

int blocks(const Shape& sh, int heads) {
  return sh.B * heads * ((sh.S + kRows - 1) / kRows);
}

template <typename T, int HD>
int fwd(const void* q, const void* k, const void* v, void* o, float* lse,
        const Shape& sh, cudaStream_t stream) {
  auto kernel = fwd_kernel<T, HD>;
  const int bytes = fwd_smem<HD>() * static_cast<int>(sizeof(float));
  if (const int err = allow_smem(kernel, bytes)) return err;
  kernel<<<blocks(sh, sh.Hq), kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, sh);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int dq(const float* q, const float* k, const float* v, const float* o,
       const float* lse, const float* dout, float* dq_, float* dsum,
       const Shape& sh, cudaStream_t stream) {
  auto kernel = dq_kernel<HD>;
  const int bytes = dq_smem<HD>() * static_cast<int>(sizeof(float));
  if (const int err = allow_smem(kernel, bytes)) return err;
  kernel<<<blocks(sh, sh.Hq), kThreads, bytes, stream>>>(
      q, k, v, o, lse, dout, dq_, dsum, sh);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int dkdv(const float* q, const float* k, const float* v, const float* lse,
         const float* dout, const float* dsum, float* dk, float* dv,
         const Shape& sh, cudaStream_t stream) {
  auto kernel = dkdv_kernel<HD>;
  const int bytes = dkdv_smem<HD>() * static_cast<int>(sizeof(float));
  if (const int err = allow_smem(kernel, bytes)) return err;
  kernel<<<blocks(sh, sh.Hkv), kThreads, bytes, stream>>>(
      q, k, v, lse, dout, dsum, dk, dv, sh);
  return static_cast<int>(cudaGetLastError());
}

constexpr int kBadHeadDim = -1;

}  // namespace

extern "C" {

// q, o: (B, S, Hq, hd); k, v: (B, S, Hkv, hd); lse: (B, Hq, S) f32.
// bf16 != 0: q, k, v, o are bf16, else f32.  hd in {32, 64, 128}.
int flash_attention_fwd_launch(const void* q, const void* k, const void* v,
                               void* o, float* lse, int B, int S, int Hq,
                               int Hkv, int hd, int causal, int window,
                               float scale, int bf16, cudaStream_t stream) {
  const Shape sh{B, S, Hq, Hkv, causal, window, scale};
  if (bf16) {
    if (hd == 32) return fwd<__nv_bfloat16, 32>(q, k, v, o, lse, sh, stream);
    if (hd == 64) return fwd<__nv_bfloat16, 64>(q, k, v, o, lse, sh, stream);
    if (hd == 128)
      return fwd<__nv_bfloat16, 128>(q, k, v, o, lse, sh, stream);
  } else {
    if (hd == 32) return fwd<float, 32>(q, k, v, o, lse, sh, stream);
    if (hd == 64) return fwd<float, 64>(q, k, v, o, lse, sh, stream);
    if (hd == 128) return fwd<float, 128>(q, k, v, o, lse, sh, stream);
  }
  return kBadHeadDim;
}

// f32 throughout; dout, dq like q; dsum: (B, Hq, S) f32 output.
int flash_attention_bwd_dq_launch(const float* q, const float* k,
                                  const float* v, const float* o,
                                  const float* lse, const float* dout,
                                  float* dq_, float* dsum, int B, int S,
                                  int Hq, int Hkv, int hd, int causal,
                                  int window, float scale,
                                  cudaStream_t stream) {
  const Shape sh{B, S, Hq, Hkv, causal, window, scale};
  if (hd == 32) return dq<32>(q, k, v, o, lse, dout, dq_, dsum, sh, stream);
  if (hd == 64) return dq<64>(q, k, v, o, lse, dout, dq_, dsum, sh, stream);
  if (hd == 128)
    return dq<128>(q, k, v, o, lse, dout, dq_, dsum, sh, stream);
  return kBadHeadDim;
}

// f32 throughout; dsum from flash_attention_bwd_dq_launch; dk, dv like k.
int flash_attention_bwd_dkdv_launch(const float* q, const float* k,
                                    const float* v, const float* lse,
                                    const float* dout, const float* dsum,
                                    float* dk, float* dv, int B, int S,
                                    int Hq, int Hkv, int hd, int causal,
                                    int window, float scale,
                                    cudaStream_t stream) {
  const Shape sh{B, S, Hq, Hkv, causal, window, scale};
  if (hd == 32) return dkdv<32>(q, k, v, lse, dout, dsum, dk, dv, sh, stream);
  if (hd == 64) return dkdv<64>(q, k, v, lse, dout, dsum, dk, dv, sh, stream);
  if (hd == 128)
    return dkdv<128>(q, k, v, lse, dout, dsum, dk, dv, sh, stream);
  return kBadHeadDim;
}

}  // extern "C"
