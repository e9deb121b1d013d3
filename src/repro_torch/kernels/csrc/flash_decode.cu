// Flash decode for Hopper (sm_90a): one query token per sequence against a
// KV cache, f32 accumulation, split over the cache and combined in a fixed
// order (replaces kernels/flash_decode.py::_decode_kernel of the TPU
// package).
//
// Layout.  q, o: (B, 1, Hq, HD); k, v: (B, ctx, Hkv, HD), all contiguous —
// the model's own cache layout, read in place.  Grouped-query attention is
// resolved by index: KV head j serves query heads j*g .. j*g + g - 1,
// g = Hq / Hkv; K and V are never repeated.  pos: one int32 in device
// memory, the absolute position of the token being decoded (>= 0), read by
// the kernels as the TPU kernel reads it from SMEM, so the host never waits
// for it.
//
// Masking, as the TPU kernel.  Without a window slot i is visible when
// i <= pos.  With a window the cache is a ring buffer: slot i holds
// key_pos = pos - ((pos - i) mod ctx) (a floored modulo: C++ '%' truncates
// toward zero, so the remainder is brought into [0, ctx) by hand), visible
// when 0 <= key_pos <= pos and key_pos > pos - window.  In both modes a
// slot past pos was never written (its key_pos is negative), so only slots
// 0 .. min(pos, ctx - 1) are visited: blocks wholly past pos are skipped,
// which changes nothing but the rounding order, since the slot of pos itself
// is always visible.  Scores are scaled by 1/sqrt(HD); masked scores take no
// weight; o = acc / max(l, 1e-30) in q's type.  Any ctx is taken (the TPU
// kernel needs ctx % block_s == 0).
//
// decode_split_kernel: one CTA of four warps per (split, KV head, sequence).
// The visible slots are cut into 32-slot tiles and the tiles into `splits`
// contiguous runs, one per CTA, so the CTAs stay busy at any pos; `splits`
// is chosen at launch so that the grid fills one wave of the card (the
// CTAs that fit on an SM at once, times the SMs, over B * Hkv; at most 32,
// and at most one run a tile of the cache).  The CTA
// streams its run's K/V tiles once for all g query rows of its KV head,
// double-buffered in shared memory in the cache's own type (cp.async, 16
// bytes a copy: tile t + 1 is in flight while tile t is used).  Each warp
// owns R query rows (rows warp, warp + 4, ...; R = 1, 2, 4 or 8, the least
// that covers g / 4, so registers follow the group size; larger groups
// take further passes over the run) and runs their online softmax with one
// slot per lane: the dot products over HD (each K chunk read once for the
// R rows, four partial sums), the row max and sum by warp shuffles, and
// P.V with each lane holding HD/32 consecutive columns (each V chunk read
// once for the R rows).  It writes its run's (acc, m, l) per row to a
// workspace.
// decode_combine_kernel: one warp per (sequence, query head) merges the
// runs: lane s holds run s's (m, l); M = max m_s and L = sum l_s e^(m_s-M)
// by fixed shuffle trees, then o = sum_s acc_s e^(m_s - M) / max(L, 1e-30)
// in run order.  No atomics: every sum runs in a fixed order, so the output
// is bitwise reproducible from run to run.
//
// Bound.  Decode reads every visible K/V slot once and does ~4*HD f32
// operations a (row, slot) pair: at the model's shapes (g = 4, HD = 128)
// that is about 2 operations a byte in f32 (4 in bf16), under the card's
// 20 f32 operations a byte of HBM bandwidth, so the bytes bound it.  The
// split over the cache is what lets a batch of 8 sequences x 8 KV heads
// (64 (sequence, head) pairs) fill 132 SMs; the double buffer keeps a tile
// of loads in flight per CTA.  wgmma and TMA are left for a later version.
//
// C interface (bound with ctypes): the entry point launches both kernels on
// the given stream, does not synchronise, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;     // four warps
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;         // slots of one K/V tile, one per lane
constexpr int kMaxSplits = 32;    // runs the combine merges, one per lane
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

struct Shape {
  int B, ctx, Hq, Hkv;
  int window;                     // <= 0: no window
  int splits;                     // 1 .. kMaxSplits, set at launch
  float scale;
};

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

// Element type traits: K (padded rows) and V tiles live in shared memory in
// the cache's type; kVec elements make one 16-byte copy.
template <typename T> struct Elem;
template <> struct Elem<float> {
  static constexpr int kVec = 4;
  // f32 rows of HD + 4: 16-byte aligned, and 16-byte loads by eight
  // lanes of different rows hit distinct banks
  static constexpr int kPad = 4;
};
template <> struct Elem<__nv_bfloat16> {
  static constexpr int kVec = 8;
  static constexpr int kPad = 8;
};

// Eight consecutive elements as f32 (two 16-byte loads for f32, one for
// bf16), from shared or global memory.
__device__ __forceinline__ void load8(const float* p, float (&out)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p,
                                      float (&out)[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

// N (2 or 4) consecutive elements as f32.
template <int N>
__device__ __forceinline__ void loadn(const float* p, float (&out)[N]) {
  if constexpr (N == 4) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  } else {
    const float2 a = *reinterpret_cast<const float2*>(p);
    out[0] = a.x; out[1] = a.y;
  }
}
template <int N>
__device__ __forceinline__ void loadn(const __nv_bfloat16* p,
                                      float (&out)[N]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(p);
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// 16 bytes global -> shared, asynchronously; src_bytes 0 fills zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Slots 0 .. visible_slots - 1 can hold a visible key (see the header).
__device__ __forceinline__ int visible_slots(const Shape& sh, int pos) {
  return max(0, min(pos + 1, sh.ctx));
}

__device__ __forceinline__ bool visible(const Shape& sh, int pos, int slot) {
  if (sh.window <= 0) return slot <= pos;
  int r = (pos - slot) % sh.ctx;  // truncated toward zero ...
  if (r < 0) r += sh.ctx;         // ... brought to the floored modulo
  const int key_pos = pos - r;
  return key_pos >= 0 && key_pos <= pos && key_pos > pos - sh.window;
}

// Workspace row of (sequence b, query head h, split s): HD accumulators,
// then m and l, padded to HD + 4 floats so that rows stay 16-byte aligned.
template <int HD>
__host__ __device__ constexpr int part_row() { return HD + 4; }
template <int HD>
__device__ __forceinline__ size_t part_off(const Shape& sh, int b, int h,
                                           int s) {
  return ((static_cast<size_t>(b) * sh.Hq + h) * sh.splits + s) *
         part_row<HD>();
}

// Shared memory of the split kernel, in bytes: two K tiles (rows padded),
// two V tiles, R * 4 query rows in f32.
template <typename T, int HD, int R> constexpr int split_smem() {
  return 2 * kTile * (HD + Elem<T>::kPad) * static_cast<int>(sizeof(T)) +
         2 * kTile * HD * static_cast<int>(sizeof(T)) +
         R * kWarps * HD * static_cast<int>(sizeof(float));
}

// ---------------------------------------------------------------------------
// per-split partial softmax: CTA (split, KV head, sequence)
// ---------------------------------------------------------------------------

template <typename T, int HD, int R>
__global__ void __launch_bounds__(kThreads)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ pos_ptr,
                    float* __restrict__ part, Shape sh) {
  constexpr int VEC = Elem<T>::kVec, LDK = HD + Elem<T>::kPad;
  constexpr int PER = HD / 32, CHUNKS = HD / VEC, ROWS = R * kWarps;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ks = reinterpret_cast<T*>(smem_raw);            // [2][kTile][LDK]
  T* vs = ks + 2 * kTile * LDK;                      // [2][kTile][HD]
  float* qs = reinterpret_cast<float*>(vs + 2 * kTile * HD);  // [ROWS][HD]
  const int split = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int g = sh.Hq / sh.Hkv;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int pos = *pos_ptr;
  const int n_valid = visible_slots(sh, pos);
  const int n_tiles = (n_valid + kTile - 1) / kTile;
  const int per_split = (n_tiles + sh.splits - 1) / sh.splits;
  const int t_begin = min(split * per_split, n_tiles);
  const int t_end = min(t_begin + per_split, n_tiles);
  const size_t kv_row = static_cast<size_t>(sh.Hkv) * HD;   // slot stride
  const T* kb = k + static_cast<size_t>(b) * sh.ctx * kv_row + hk * HD;
  const T* vb = v + static_cast<size_t>(b) * sh.ctx * kv_row + hk * HD;

  // start the copies of tile t into buffer buf (rows past the visible
  // slots are zero-filled)
  auto load_tile = [&](int t, int buf) {
    const int s0 = t * kTile;
    for (int e = threadIdx.x; e < kTile * CHUNKS; e += kThreads) {
      const int j = e / CHUNKS, c = (e % CHUNKS) * VEC;
      const bool in = s0 + j < n_valid;
      const size_t off = in ? (s0 + j) * kv_row + c : 0;
      cp_async16(ks + (buf * kTile + j) * LDK + c, kb + off, in ? 16 : 0);
      cp_async16(vs + (buf * kTile + j) * HD + c, vb + off, in ? 16 : 0);
    }
  };

  for (int r0 = 0; r0 < g; r0 += ROWS) {
    const int rows = min(ROWS, g - r0);
    __syncthreads();                      // the previous pass is done
    if (t_begin < t_end) load_tile(t_begin, 0);
    cp_async_commit();
    for (int e = threadIdx.x; e < rows * (HD / 8); e += kThreads) {
      const int r = e / (HD / 8), c = (e % (HD / 8)) * 8;
      float val[8];
      load8(q + (static_cast<size_t>(b) * sh.Hq + hk * g + r0 + r) * HD + c,
            val);
#pragma unroll
      for (int i = 0; i < 8; ++i) qs[r * HD + c + i] = val[i];
    }
    float m[R], l[R], acc[R][PER];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      m[i] = kNegInf;
      l[i] = 0.f;
#pragma unroll
      for (int c = 0; c < PER; ++c) acc[i][c] = 0.f;
    }
    for (int t = t_begin; t < t_end; ++t) {
      const int buf = (t - t_begin) & 1;
      if (t + 1 < t_end) load_tile(t + 1, buf ^ 1);
      cp_async_commit();
      cp_async_wait_one();                // tile t has landed
      __syncthreads();
      const int s0 = t * kTile;
      const int n = min(kTile, n_valid - s0);
      const bool ok = lane < n && visible(sh, pos, s0 + lane);
      // scores: lane = slot, R rows at once, four partial sums each
      float part_s[R][4];
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int u = 0; u < 4; ++u) part_s[i][u] = 0.f;
      const T* kj = ks + (buf * kTile + lane) * LDK;
#pragma unroll 4
      for (int d = 0; d < HD; d += 8) {
        float kv8[8];
        load8(kj + d, kv8);
#pragma unroll
        for (int i = 0; i < R; ++i) {
          const float* qi = qs + (warp + i * kWarps) * HD + d;
          const float4 a = *reinterpret_cast<const float4*>(qi);
          const float4 c4 = *reinterpret_cast<const float4*>(qi + 4);
          part_s[i][0] = fmaf(a.x, kv8[0], part_s[i][0]);
          part_s[i][1] = fmaf(a.y, kv8[1], part_s[i][1]);
          part_s[i][2] = fmaf(a.z, kv8[2], part_s[i][2]);
          part_s[i][3] = fmaf(a.w, kv8[3], part_s[i][3]);
          part_s[i][0] = fmaf(c4.x, kv8[4], part_s[i][0]);
          part_s[i][1] = fmaf(c4.y, kv8[5], part_s[i][1]);
          part_s[i][2] = fmaf(c4.z, kv8[6], part_s[i][2]);
          part_s[i][3] = fmaf(c4.w, kv8[7], part_s[i][3]);
        }
      }
      float p[R];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        float s =
            (part_s[i][0] + part_s[i][1]) + (part_s[i][2] + part_s[i][3]);
        s = ok ? s * sh.scale : kNegInf;
        const float m_new = fmaxf(m[i], warp_max(s));
        p[i] = ok ? expf(s - m_new) : 0.f;
        const float corr = expf(m[i] - m_new);
        l[i] = l[i] * corr + warp_sum(p[i]);
        m[i] = m_new;
#pragma unroll
        for (int c = 0; c < PER; ++c) acc[i][c] *= corr;
      }
      // P.V: lane holds columns lane*PER .. lane*PER + PER - 1
      const T* vt = vs + buf * kTile * HD + lane * PER;
      for (int j = 0; j < n; ++j) {
        float vj[PER];
        loadn<PER>(vt + j * HD, vj);
#pragma unroll
        for (int i = 0; i < R; ++i) {
          const float pj = __shfl_sync(kFull, p[i], j);
#pragma unroll
          for (int c = 0; c < PER; ++c) acc[i][c] = fmaf(pj, vj[c], acc[i][c]);
        }
      }
      __syncthreads();                    // buffer buf may be refilled
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int row = warp + i * kWarps;
      if (row < rows) {
        float* dst = part + part_off<HD>(sh, b, hk * g + r0 + row, split);
#pragma unroll
        for (int c = 0; c < PER; ++c) dst[lane * PER + c] = acc[i][c];
        if (lane == 0) {
          dst[HD] = m[i];
          dst[HD + 1] = l[i];
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// combine the splits: one warp per (sequence, query head)
// ---------------------------------------------------------------------------

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
decode_combine_kernel(const float* __restrict__ part, T* __restrict__ o,
                      Shape sh) {
  constexpr int PER = HD / 32;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= sh.B * sh.Hq) return;
  const int b = row / sh.Hq, h = row % sh.Hq;
  const float* base = part + part_off<HD>(sh, b, h, 0);
  const bool mine = lane < sh.splits;
  const float m_s = mine ? base[lane * part_row<HD>() + HD] : kNegInf;
  const float l_s = mine ? base[lane * part_row<HD>() + HD + 1] : 0.f;
  const float mx = warp_max(m_s);
  const float w_s = mine ? expf(m_s - mx) : 0.f;
  const float inv = 1.f / fmaxf(warp_sum(l_s * w_s), 1e-30f);
  float acc[PER];
#pragma unroll
  for (int c = 0; c < PER; ++c) acc[c] = 0.f;
#pragma unroll 4
  for (int s = 0; s < sh.splits; ++s) {
    const float w = __shfl_sync(kFull, w_s, s);
    float a[PER];
    loadn<PER>(base + s * part_row<HD>() + lane * PER, a);
#pragma unroll
    for (int c = 0; c < PER; ++c) acc[c] = fmaf(a[c], w, acc[c]);
  }
  T* dst = o + static_cast<size_t>(row) * HD + lane * PER;
#pragma unroll
  for (int c = 0; c < PER; ++c) dst[c] = from_f32<T>(acc[c] * inv);
}

// ---------------------------------------------------------------------------
// launcher
// ---------------------------------------------------------------------------

// Allow a kernel the dynamic shared memory it needs above the 48 KB
// default; returns a cudaError_t.
template <typename Kernel>
int allow_smem(Kernel kernel, int bytes) {
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

// Launch the split kernel with `splits` set to fill one wave of the card
// (the resident CTAs of this instance on every SM, found once).
template <typename T, int HD, int R>
int split(const void* q, const void* k, const void* v, const int* pos,
          float* part, Shape& sh, cudaStream_t stream) {
  auto kernel = decode_split_kernel<T, HD, R>;
  const int bytes = split_smem<T, HD, R>();
  static int wave = 0;            // CTAs resident at once on the card
  if (wave == 0) {
    if (const int err = allow_smem(kernel, bytes)) return err;
    int device = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&device);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                  bytes);
    if (const int err = static_cast<int>(cudaGetLastError())) return err;
    wave = max(1, sms * per_sm);
  }
  const int tiles = (sh.ctx + kTile - 1) / kTile;
  sh.splits = max(1, min(min(kMaxSplits, tiles), wave / (sh.B * sh.Hkv)));
  kernel<<<dim3(sh.splits, sh.Hkv, sh.B), kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), pos, part, sh);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HD>
int decode(const void* q, const void* k, const void* v, const int* pos,
           float* part, void* o, Shape sh, cudaStream_t stream) {
  // rows a warp carries: the least power of two that covers g / 4
  const int g = sh.Hq / sh.Hkv;
  int err;
  if (g <= kWarps)
    err = split<T, HD, 1>(q, k, v, pos, part, sh, stream);
  else if (g <= 2 * kWarps)
    err = split<T, HD, 2>(q, k, v, pos, part, sh, stream);
  else if (g <= 4 * kWarps)
    err = split<T, HD, 4>(q, k, v, pos, part, sh, stream);
  else
    err = split<T, HD, 8>(q, k, v, pos, part, sh, stream);
  if (err) return err;
  const int rows = sh.B * sh.Hq;
  decode_combine_kernel<T, HD><<<(rows + kWarps - 1) / kWarps, kThreads, 0,
                                 stream>>>(part, static_cast<T*>(o), sh);
  return static_cast<int>(cudaGetLastError());
}

constexpr int kBadShape = -1;

}  // namespace

extern "C" {

// q, o: (B, 1, Hq, hd); k, v: (B, ctx, Hkv, hd); pos: one int32 on the
// device; part: a f32 workspace of B * Hq * 32 * (hd + 4) floats.
// bf16 != 0: q, k, v, o are bf16, else f32.  hd in {64, 128}; window <= 0:
// none.
int flash_decode_launch(const void* q, const void* k, const void* v,
                        const int* pos, float* part, void* o, int B, int ctx,
                        int Hq, int Hkv, int hd, int window, float scale,
                        int bf16, cudaStream_t stream) {
  const Shape sh{B, ctx, Hq, Hkv, window, 1, scale};
  if (bf16) {
    if (hd == 64)
      return decode<__nv_bfloat16, 64>(q, k, v, pos, part, o, sh, stream);
    if (hd == 128)
      return decode<__nv_bfloat16, 128>(q, k, v, pos, part, o, sh, stream);
  } else {
    if (hd == 64) return decode<float, 64>(q, k, v, pos, part, o, sh, stream);
    if (hd == 128)
      return decode<float, 128>(q, k, v, pos, part, o, sh, stream);
  }
  return kBadShape;
}

}  // extern "C"
