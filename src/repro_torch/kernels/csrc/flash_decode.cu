// Flash decode for Hopper (sm_90a): one query token per sequence against a
// KV cache, f32 accumulation, one launch per call: the cache is split into
// runs over CTAs, and the last CTA of each (sequence, KV head) to finish
// merges the runs' partial softmaxes in a fixed order (replaces
// kernels/flash_decode.py::_decode_kernel of the TPU package).
//
// Layout.  q, o: (B, 1, Hq, HD); k, v: (B, ctx, Hkv, HD), all contiguous —
// the model's own cache layout, read in place.  Grouped-query attention is
// resolved by index: KV head j serves query heads j*g .. j*g + g - 1,
// g = Hq / Hkv; K and V are never repeated.  pos: one int32 in device
// memory, the absolute position of the token being decoded (>= 0), read by
// the kernel as the TPU kernel reads it from SMEM, so the host never waits
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
// decode_kernel: one CTA of four warps per (run, KV head, sequence).  The
// visible slots are cut into 32-slot tiles and the tiles into `splits`
// contiguous runs, one per CTA, so the CTAs stay busy at any pos; `splits`
// is chosen at launch so that the grid fills one wave of the card (the
// CTAs that fit on an SM at once, times the SMs, over B * Hkv; at most 32,
// and at most one run a tile of the cache).  The CTA streams its run's K/V
// tiles once for all g query rows of its KV head, double-buffered in
// shared memory in the cache's own type (cp.async, 16 bytes a copy: tile
// t + 1 is in flight while tile t is used).  Each warp owns R query rows
// (rows warp, warp + 4, ...; R = 1, 2, 4 or 8, the least that covers
// g / 4, so registers follow the group size; larger groups take further
// passes over the run) and runs their online softmax with one slot per
// lane: the dot products over HD (each K chunk read once for the R rows,
// four partial sums), the row max and sum by warp shuffles, and P.V with
// each lane holding HD/32 consecutive columns (each V chunk read once for
// the R rows).
// The merge, in the same launch: each CTA writes its run's (acc, m, l) per
// row to a buffer the wrapper keeps (it stays in L2), then adds one to its
// (sequence, KV head)'s arrival count, an integer atomic with release and
// acquire semantics; the CTA that arrives last reads every run's partials
// back (through L2) and merges them in run order: M = max m_s,
// L = sum l_s e^(m_s - M), o = sum acc_s e^(m_s - M) / max(L, 1e-30), then
// sets the count back to 0 for the next call.  A run with no visible tile
// contributes m = -1e30, l = 0, acc = 0.  No float atomics and no second
// kernel: every sum has one owner and a fixed order, so the output is
// bitwise reproducible from run to run.
//
// Why not a thread-block cluster merging in distributed shared memory: one
// cluster per (sequence, KV head) must hold all its runs, and the card
// holds 62 clusters of 6 CTAs at once (3 CTAs an SM at 68 608 bytes), not
// the decode cell's 64, so 6 tiles at pos 191 met 5 CTAs; and at a 32k
// cache the clusters that fit one wave carried fewer tiles in flight than
// free runs do (PERF.md).
//
// Bound.  Decode reads every visible K/V slot once and does ~4*HD f32
// operations a (row, slot) pair: at the model's shapes (g = 4, HD = 128)
// that is about 2 operations a byte in f32 (4 in bf16), under the card's
// 20 f32 operations a byte of HBM bandwidth, so the bytes bound it.  The
// split over the cache is what lets a batch of 8 sequences x 8 KV heads
// (64 (sequence, head) pairs) fill 132 SMs; the double buffer keeps a tile
// of loads in flight per CTA; the merge in the last CTA saves the second
// launch and its round trip.  wgmma and TMA are left for a later version.
//
// C interface (bound with ctypes): the entry point launches the kernel on
// the given stream, does not synchronise, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;     // four warps
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;         // slots of one K/V tile, one per lane
constexpr int kMaxSplits = 32;    // runs a (sequence, KV head), one a lane
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
  static constexpr int kResident = 3;   // CTAs an SM at HD 128, R <= 2
  // f32 rows of HD + 4: 16-byte aligned, and 16-byte loads by eight
  // lanes of different rows hit distinct banks
  static constexpr int kPad = 4;
};
template <> struct Elem<__nv_bfloat16> {
  static constexpr int kVec = 8;
  static constexpr int kResident = 6;
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

// Partials row of (sequence b, query head h, run s): HD accumulators, then
// m and l, padded to HD + 4 floats so that rows stay 16-byte aligned.
template <int HD>
__host__ __device__ constexpr int part_row() { return HD + 4; }
template <int HD>
__device__ __forceinline__ size_t part_off(const Shape& sh, int b, int h,
                                           int s) {
  return ((static_cast<size_t>(b) * sh.Hq + h) * sh.splits + s) *
         part_row<HD>();
}

// Shared memory of the kernel, in bytes: two K tiles (rows padded), two V
// tiles, R * 4 query rows in f32.
template <typename T, int HD, int R> constexpr int decode_smem() {
  return 2 * kTile * (HD + Elem<T>::kPad) * static_cast<int>(sizeof(T)) +
         2 * kTile * HD * static_cast<int>(sizeof(T)) +
         R * kWarps * HD * static_cast<int>(sizeof(float));
}

// N (2 or 4) consecutive floats through L2 (ld.global.cg: other SMs wrote
// them during this launch).
template <int N>
__device__ __forceinline__ void ldcg_n(const float* p, float (&out)[N]) {
  if constexpr (N == 4) {
    const float4 a = __ldcg(reinterpret_cast<const float4*>(p));
    out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  } else {
    const float2 a = __ldcg(reinterpret_cast<const float2*>(p));
    out[0] = a.x; out[1] = a.y;
  }
}

// Add one to an arrival count with release and acquire semantics at the
// scope of the card, and return the count before: the writes this CTA made
// before its barrier are visible to whoever counts after it, and the writes
// of those who counted before are visible to this CTA after its barrier.
__device__ __forceinline__ int arrive(int* count) {
  int before;
  asm volatile("atom.add.acq_rel.gpu.global.s32 %0, [%1], 1;\n"
               : "=r"(before)
               : "l"(count)
               : "memory");
  return before;
}

// The last CTA of (sequence b, KV head hk): every run's partials of the g
// rows merged in run order, o written in q's type.  Each warp takes rows
// warp, warp + 4, ...; each lane HD/32 columns, and every lane reads the
// runs' (m, l) itself.  A row's first eight runs (m, l and columns) are
// requested together, so the merge waits for one round trip to L2 at up to
// eight runs.  No warp shuffle: the code stays free of collectives under
// the CTA's branch into the merge.
template <typename T, int HD>
__device__ void merge_runs(const float* part, T* o, const Shape& sh, int b,
                           int hk) {
  constexpr int PER = HD / 32, BATCH = 8, ROW = part_row<HD>();
  const int g = sh.Hq / sh.Hkv;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < g; r += kWarps) {
    const int h = hk * g + r;
    const float* base = part + part_off<HD>(sh, b, h, 0);
    float mb[BATCH], lb[BATCH], a[BATCH][PER];
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      mb[u] = kNegInf;
      lb[u] = 0.f;
#pragma unroll
      for (int c = 0; c < PER; ++c) a[u][c] = 0.f;
      if (u < sh.splits) {
        mb[u] = __ldcg(base + u * ROW + HD);
        lb[u] = __ldcg(base + u * ROW + HD + 1);
        ldcg_n<PER>(base + u * ROW + lane * PER, a[u]);
      }
    }
    float mx = kNegInf;
#pragma unroll
    for (int u = 0; u < BATCH; ++u) mx = fmaxf(mx, mb[u]);
    for (int s = BATCH; s < sh.splits; ++s)
      mx = fmaxf(mx, __ldcg(base + s * ROW + HD));
    float den = 0.f, acc[PER];
#pragma unroll
    for (int c = 0; c < PER; ++c) acc[c] = 0.f;
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      if (u < sh.splits) {
        const float w = expf(mb[u] - mx);
        den += lb[u] * w;
#pragma unroll
        for (int c = 0; c < PER; ++c) acc[c] = fmaf(a[u][c], w, acc[c]);
      }
    }
    for (int s = BATCH; s < sh.splits; ++s) {
      const float* run = base + s * ROW;
      const float w = expf(__ldcg(run + HD) - mx);
      den += __ldcg(run + HD + 1) * w;
      float as[PER];
      ldcg_n<PER>(run + lane * PER, as);
#pragma unroll
      for (int c = 0; c < PER; ++c) acc[c] = fmaf(as[c], w, acc[c]);
    }
    den = fmaxf(den, 1e-30f);
    T* dst = o + (static_cast<size_t>(b) * sh.Hq + h) * HD + lane * PER;
#pragma unroll
    for (int c = 0; c < PER; ++c) dst[c] = from_f32<T>(acc[c] / den);
  }
}

// ---------------------------------------------------------------------------
// the kernel: CTA (run, KV head, sequence)
// ---------------------------------------------------------------------------

// The CTAs an SM must hold, for the register budget: as many as the shared
// memory lets in at R <= 2 (6 in bf16: at most 80 registers); 1 at R >= 4,
// whose rows need the registers (the compiler spills below ~170).
template <typename T, int R> struct MinResident {
  static constexpr int value = R <= 2 ? Elem<T>::kResident : 1;
};

template <typename T, int HD, int R>
__global__ void __launch_bounds__(kThreads, MinResident<T, R>::value)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const int* __restrict__ pos_ptr,
              float* __restrict__ part, int* __restrict__ arrivals,
              T* __restrict__ o, Shape sh) {
  constexpr int VEC = Elem<T>::kVec, LDK = HD + Elem<T>::kPad;
  constexpr int PER = HD / 32, CHUNKS = HD / VEC, ROWS = R * kWarps;
  constexpr int D_UNROLL = R >= 4 ? 2 : 4;   // K chunks in flight a lane
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
  // slots are zero-filled): thread x copies column chunk x % CHUNKS of rows
  // x / CHUNKS + i * JSTEP, so its addresses are set once, and a tile only
  // adds its offset
  constexpr int JSTEP = kThreads / CHUNKS;
  static_assert(kThreads % CHUNKS == 0 && kTile % JSTEP == 0, "copies");
  const int j0 = threadIdx.x / CHUNKS, c0 = (threadIdx.x % CHUNKS) * VEC;
  const T* kg = kb + j0 * kv_row + c0;
  const T* vg = vb + j0 * kv_row + c0;
  T* kd = ks + j0 * LDK + c0;
  T* vd = vs + j0 * HD + c0;
  auto load_tile = [&](int t, int buf) {
    const int s0 = t * kTile;
    const size_t at = static_cast<size_t>(s0) * kv_row;
#pragma unroll
    for (int i = 0; i < kTile / JSTEP; ++i) {
      const bool in = s0 + j0 + i * JSTEP < n_valid;
      const size_t off = at + static_cast<size_t>(i * JSTEP) * kv_row;
      const int row = buf * kTile + i * JSTEP;
      cp_async16(kd + row * LDK, in ? kg + off : kb, in ? 16 : 0);
      cp_async16(vd + row * HD, in ? vg + off : vb, in ? 16 : 0);
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
#pragma unroll(D_UNROLL)
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
#pragma unroll 8
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
  // arrive: the barrier orders every thread's partials before thread 0's
  // release; the last of the runs to arrive merges, after its acquire.  The
  // flag lives in the drained query rows: a static __shared__ variable
  // beside the dynamic shared memory made the whole kernel slower at a long
  // cache (PERF.md).
  __syncthreads();
  int& last = *reinterpret_cast<int*>(qs);
  if (threadIdx.x == 0) {
    int* count = arrivals + b * sh.Hkv + hk;
    last = arrive(count) == sh.splits - 1;
    if (last) *count = 0;           // ready for the next call
  }
  __syncthreads();
  if (!last) return;
  merge_runs<T, HD>(part, o, sh, b, hk);
}

// ---------------------------------------------------------------------------
// launcher
// ---------------------------------------------------------------------------

// One instance of the kernel, prepared once: its shared memory allowed and
// the CTAs of it the card holds at once.
struct Prepared {
  const void* func = nullptr;
  int bytes = 0;
  int per_sm = 0;                 // resident CTAs an SM
  int wave = 0;                   // resident CTAs on the card
};

// Returns a cudaError_t; points `out` at the instance's record.
template <typename T, int HD, int R>
int prepare(const Prepared** out) {
  static Prepared pr;
  *out = &pr;
  if (pr.wave > 0) return 0;
  auto kernel = decode_kernel<T, HD, R>;
  pr.func = reinterpret_cast<const void*>(kernel);
  pr.bytes = decode_smem<T, HD, R>();
  if (pr.bytes > 48 * 1024)
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         pr.bytes);
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&pr.per_sm, kernel, kThreads,
                                                pr.bytes);
  if (const int err = static_cast<int>(cudaGetLastError())) return err;
  pr.wave = max(1, sms * pr.per_sm);
  return 0;
}

// The runs of a (sequence, KV head): enough to fill one wave of the card,
// at most kMaxSplits and at most the cache's tiles.
int splits_for(const Prepared& pr, const Shape& sh) {
  const int tiles = (sh.ctx + kTile - 1) / kTile;
  return max(1, min(min(kMaxSplits, tiles), pr.wave / (sh.B * sh.Hkv)));
}

template <typename T, int HD, int R>
int launch(const void* q, const void* k, const void* v, const int* pos,
           float* part, int* arrivals, void* o, Shape sh,
           cudaStream_t stream) {
  const Prepared* pr = nullptr;
  if (const int err = prepare<T, HD, R>(&pr)) return err;
  sh.splits = splits_for(*pr, sh);
  decode_kernel<T, HD, R>
      <<<dim3(sh.splits, sh.Hkv, sh.B), kThreads, pr->bytes, stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), pos, part, arrivals, static_cast<T*>(o),
          sh);
  return static_cast<int>(cudaGetLastError());
}

// What an instance takes at a shape, into out[7]: registers a thread, local
// memory a thread (spills; bytes), static and dynamic shared memory a CTA
// (bytes), threads a CTA, resident CTAs an SM, and the runs the launch
// cuts a (sequence, KV head) into.
template <typename T, int HD, int R>
int resources(const Shape& sh, int* out) {
  const Prepared* pr = nullptr;
  if (const int err = prepare<T, HD, R>(&pr)) return err;
  cudaFuncAttributes fa;
  if (const cudaError_t err = cudaFuncGetAttributes(&fa, pr->func))
    return static_cast<int>(err);
  out[0] = fa.numRegs;
  out[1] = static_cast<int>(fa.localSizeBytes);
  out[2] = static_cast<int>(fa.sharedSizeBytes);
  out[3] = pr->bytes;
  out[4] = kThreads;
  out[5] = pr->per_sm;
  out[6] = splits_for(*pr, sh);
  return 0;
}

// The instance for a shape: the element type, the head dim, and the rows a
// warp carries (the least power of two that covers g / 4).  Op has
// `template <typename T, int HD, int R> int run() const`.
template <typename T, int HD, typename Op>
int by_rows(int g, const Op& op) {
  if (g <= kWarps) return op.template run<T, HD, 1>();
  if (g <= 2 * kWarps) return op.template run<T, HD, 2>();
  if (g <= 4 * kWarps) return op.template run<T, HD, 4>();
  return op.template run<T, HD, 8>();
}

constexpr int kBadShape = -1;

template <typename Op>
int by_shape(const Shape& sh, int hd, int bf16, const Op& op) {
  if (sh.B <= 0 || sh.ctx <= 0 || sh.Hkv <= 0 || sh.Hq % sh.Hkv)
    return kBadShape;
  const int g = sh.Hq / sh.Hkv;
  if (bf16) {
    if (hd == 64) return by_rows<__nv_bfloat16, 64>(g, op);
    if (hd == 128) return by_rows<__nv_bfloat16, 128>(g, op);
  } else {
    if (hd == 64) return by_rows<float, 64>(g, op);
    if (hd == 128) return by_rows<float, 128>(g, op);
  }
  return kBadShape;
}

struct LaunchOp {
  const void *q, *k, *v;
  const int* pos;
  float* part;
  int* arrivals;
  void* o;
  Shape sh;
  cudaStream_t stream;
  template <typename T, int HD, int R> int run() const {
    return launch<T, HD, R>(q, k, v, pos, part, arrivals, o, sh, stream);
  }
};

struct ResourcesOp {
  Shape sh;
  int* out;
  template <typename T, int HD, int R> int run() const {
    return resources<T, HD, R>(sh, out);
  }
};

}  // namespace

extern "C" {

// q, o: (B, 1, Hq, hd); k, v: (B, ctx, Hkv, hd); pos: one int32 on the
// device; part: the runs' partials, B * Hq * 32 * (hd + 4) floats, and
// arrivals: B * Hkv int32 counts, 0 before the first call (each call leaves
// them at 0), both kept by the caller from call to call on one stream.
// bf16 != 0: q, k, v, o are bf16, else f32.  hd in {64, 128}; window <= 0:
// none.  Returns a cudaError_t, or -1 for a shape the kernel does not take.
int flash_decode_launch(const void* q, const void* k, const void* v,
                        const int* pos, float* part, int* arrivals, void* o,
                        int B, int ctx, int Hq, int Hkv, int hd, int window,
                        float scale, int bf16, cudaStream_t stream) {
  const Shape sh{B, ctx, Hq, Hkv, window, 1, scale};
  return by_shape(sh, hd, bf16,
                  LaunchOp{q, k, v, pos, part, arrivals, o, sh, stream});
}

// The resources of the instance that takes this shape (see resources), into
// out[7]; returns a cudaError_t, or -1 for a shape the kernel does not take.
int flash_decode_resources(int B, int ctx, int Hq, int Hkv, int hd, int bf16,
                           int* out) {
  const Shape sh{B, ctx, Hq, Hkv, 0, 1, 1.f};
  return by_shape(sh, hd, bf16, ResourcesOp{sh, out});
}

}  // extern "C"
