// Flash attention for Hopper (sm_90a): the forward pass and a
// deterministic backward, f32 accumulation throughout.  Every kernel takes
// f32 or bf16 inputs (q, k, v, o, dO in one type; lse and D in f32), reads
// them in their type, computes in f32 and rounds its outputs once to it;
// head dims 32, 64, 112 and 128.
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
// byte.
//
// The forward.  Its work unit is (sequence b, KV head, query tile) and
// covers the query heads of the KV head's group together (up to 32 heads a
// unit; a larger group is cut into chunks of 32): a unit is 32 query rows,
// row r = (position q0 + r / hc, head r % hc of the chunk), hc = min(g, 32)
// heads by 32 / hc positions, so each K/V row is read from memory once per
// query tile and not once per query head.  At the transformer cell's shape
// (S 16, g 2) a unit is a whole sequence of one KV head.  Keys come in tiles
// of 16 rows aligned to multiples of 16 ([16t, 16t + 16)), from the tile of
// the unit's first visible key to that of its last; rows past S are copied
// as zeros and masked.  The grid is persistent: as many CTAs of eight warps
// as the card holds at once (from the occupancy query, once a device: 3 an
// SM at 80 registers a thread, 2 for f32 at HD 128), each walking the units
// in a fixed stride; a step is one key tile of one unit.  Unit and row
// indices are decoded by multiply-high division.  A two-stage ring in
// dynamic shared memory holds each step's K and V tiles and each unit's
// query rows in the input type, filled by 16-byte cp.async copies: the next
// step's copies (and the next unit's queries) are in flight while this step
// computes.  The math is FFMA in f32: thread (row group rg, lane j of its
// half-warp) scores key j against rows rg and rg + 16 (dot products over HD
// from shared memory in 16-byte reads, four partial sums a row, element d
// into sum d mod 4, then (s0 + s1) + (s2 + s3)), the row max and sum are
// taken over the half-warp by xor shuffles, P goes through shared memory,
// and the same thread accumulates columns j * HD/16 .. of P.V for its two
// rows, so m, l and the correction stay in its registers.  A masked score
// takes p = 0 explicitly, so a tile that a row cannot see leaves its (m, l,
// acc) exactly as they were, however many such tiles a unit has: a row's
// result depends only on its own visible tiles, in increasing key order, and
// not on the unit it falls in, on B, or on the CTA or stage that ran it
// (batch-invariant).  o is stored as HD/16 consecutive elements a thread
// (one 16-byte store for f32 at HD 64; element by element at HD 112,
// whose 7 columns a thread do not make a 16-byte vector).  Rows in shared
// memory are HD plus one 16-byte copy long, so the 16-byte copies divide
// every head dim (HD 112: 28 of f32, 14 of bf16).
//
// The dQ kernel.  Its work unit is the forward's (sequence b, KV head, head
// chunk, query tile of 32 rows over the group's query heads), so each K/V
// tile is read once for all g query heads and each dQ row is owned by one
// unit; a step is one 16-key tile aligned to 16, from the tile of the
// unit's first visible key to that of its last.  The grid is persistent
// (CTAs an SM from the occupancy query, once a device).  A two-stage ring
// in dynamic shared memory holds each step's K and V tiles and each unit's
// q and dO rows with their lse, filled by cp.async (16-byte rows, 4-byte
// lse): the next step's copies (and the next unit's rows) are in flight
// while this step computes.  o is read once a unit: into a slot of its own
// where the shared memory admits 3 CTAs an SM with it (hd 32, 64), else
// into the ring's stage ahead of the unit's first key tile, as a step of
// its own (hd 128); the slot is free once D is taken.  D = rowsum(dO o) is
// taken from shared memory once a unit, before its first key tile: eight
// threads a row, each over every eighth 16-byte chunk in order, then a
// fixed xor butterfly; one store a row.  The CTA's halves split the scores
// by product: a thread of half 0 takes s = q.k, one of half 1 dp = dO.v,
// for keys j, j + 8 against rows rg, rg + 16 (four partial sums over HD,
// element d into sum d mod 4, then (s0 + s1) + (s2 + s3)).  Half 0 writes p
// = exp(s scale - lse) to shared memory and signals a named barrier; half
// 1 waits on it and overwrites p with dS = p (dp - D), both 0 where masked.
// Then every thread adds dS K over the tile's keys in order into two rows
// by HD/16 columns in registers.  dQ is scaled once and stored as 16-byte
// vectors at the unit's last step.  A masked (row, key) has dS = 0 exactly,
// so a row's result does not depend on the unit it falls in or on B
// (batch-invariant).
//
// The dK/dV kernel.  Its work unit is (sequence b, KV head, key tile of 16
// rows aligned to 16) and covers every query head of the KV head's group,
// so each dK/dV row is owned by one unit and written once.  A unit's steps
// walk the query rows that its keys can see in the forward's 32-row layout
// (row r = position q0 + r / hc, head r % hc of a head chunk): head chunks,
// then query tiles from the first visible to the last.  At the transformer
// cell's shape (S 16, g 2) a unit is one step of 32 query rows by 16 keys.
// The grid is persistent, as the forward's (CTAs an SM from the occupancy
// query, once a device); a two-stage ring in dynamic shared memory holds
// each step's q and dO rows with their lse and D, and each unit's K and V
// tiles, filled by cp.async (16-byte rows, 4-byte statistics): the next
// step's copies (and the next unit's K and V) are in flight while this step
// computes.  The math is FFMA in f32, and the CTA's two halves split it by
// product, so that each 16-byte shared-memory read feeds more FMAs: in the
// scores a thread of half 0 takes s = q.k, one of half 1 dp = dO.v, for
// keys j, j + 8 against rows rg, rg + 16 (four partial sums over HD,
// element d into sum d mod 4, then (s0 + s1) + (s2 + s3)); half 0 writes p
// = exp(s scale - lse), half 1 dp - D, both 0 where masked, transposed to
// shared memory.  Then a thread of half 0 owns HD/16 columns of dV of keys
// jo, jo + 8 and adds p dO over the step's 32 rows in row order, one of
// half 1 the same columns of dK with dS = p (dp - D) and q, reading the rows
// as 16-byte vectors.  dK scale and dV are stored as 16-byte vectors at the
// unit's last step.  A row's terms go in an order fixed by S, Hq, Hkv,
// causal and window alone, so dK and dV are batch-invariant.
//
// In every kernel each sum runs in a fixed order and every output element
// is written by one thread once — no atomics — so the results are bitwise
// reproducible from run to run.
//
// C interface (bound with ctypes): every entry point launches on the given
// stream, does not synchronise, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

struct Shape {
  int B, S, Hq, Hkv;
  int causal;
  int window;                     // <= 0: no window
  float scale;
};

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

// ---------------------------------------------------------------------------
// forward: persistent CTAs over units (b, KV head, head chunk, query tile)
// ---------------------------------------------------------------------------

constexpr int kFwdThreads = 256;                    // eight warps
constexpr int kUnitRows = 32;                       // query rows of a unit
constexpr int kKeyTile = 16;                        // keys of a tile
constexpr int kRowGroups = kFwdThreads / kKeyTile;  // 16: half-warps
constexpr int kRowsPer = kUnitRows / kRowGroups;    // 2 rows a thread
constexpr int kStages = 2;                          // the copy ring
constexpr int kSmemPerSM = 232448;                  // usable bytes an SM
constexpr int kSmemReserved = 1024;                 // the system's, a CTA
constexpr int kMaxResident = 3;                     // 80 registers a thread

// n / d and n % d for 0 <= n, d < 2^31 by a multiply-high and a shift
// (the divisor's magic number is made on the host): a few instructions in
// place of a division's few tens.
struct FastDiv {
  unsigned d, m, s;
};

FastDiv fast_div(unsigned d) {
  unsigned s = 0;
  while ((1u << s) < d) ++s;
  const unsigned long long m =
      ((1ull << 32) * ((1ull << s) - d)) / d + 1;
  return {d, static_cast<unsigned>(m), s};
}

__device__ __forceinline__ int div_of(int n, const FastDiv& f) {
  const unsigned u = static_cast<unsigned>(n);
  return static_cast<int>((__umulhi(u, f.m) + u) >> f.s);
}

// The partition of a shape into units, fixed by S, Hq and Hkv alone (not by
// B): hc heads of a KV head's group by qt positions make a unit's rows.
struct FwdPlan {
  int g;        // query heads a KV head
  int hc;       // query heads of a unit, min(g, kUnitRows)
  int qt;       // query positions of a unit, kUnitRows / hc
  int units;    // B * Hkv * nhc * nqt
  FastDiv by_hc, by_nhc, by_nqt, by_hkv;  // nhc = ceil(g / hc), nqt =
                                          // ceil(S / qt) query tiles
};

// Elements of one 16-byte copy; rows in shared memory are padded by one
// copy, so that 16-byte reads of eight different rows at one column hit
// distinct banks.
template <typename T> struct Vec { static constexpr int n = 16 / sizeof(T); };

template <typename T, int HD>
__host__ __device__ constexpr int fwd_ld() { return HD + Vec<T>::n; }
template <typename T, int HD>
__host__ __device__ constexpr int fwd_q_elems() {
  return kUnitRows * fwd_ld<T, HD>();
}
template <typename T, int HD>
__host__ __device__ constexpr int fwd_k_elems() {
  return kKeyTile * fwd_ld<T, HD>();
}
template <typename T, int HD>
__host__ __device__ constexpr int fwd_v_elems() {
  return kKeyTile * HD;
}
// Bytes: the ring of query rows, K and V tiles in T, then P in f32.
template <typename T, int HD>
__host__ __device__ constexpr int fwd_smem() {
  return kStages *
             (fwd_q_elems<T, HD>() + fwd_k_elems<T, HD>() +
              fwd_v_elems<T, HD>()) *
             static_cast<int>(sizeof(T)) +
         kUnitRows * kKeyTile * static_cast<int>(sizeof(float));
}
// The CTAs an SM must hold, for the register budget: kMaxResident, or,
// where the shared memory admits no more than that (f32 at HD 128: 3),
// one less than it admits, so that the instance's 16 accumulators a thread
// fit in 128 registers without spills.
template <typename T, int HD> struct FwdResident {
  static constexpr int by_smem =
      kSmemPerSM / (fwd_smem<T, HD>() + kSmemReserved);
  static constexpr int value =
      by_smem <= kMaxResident ? (by_smem > 1 ? by_smem - 1 : 1)
                              : kMaxResident;
};

// Eight consecutive elements as f32 (two 16-byte loads for f32, one for
// bf16), from shared memory.
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

// N consecutive elements as f32, from shared memory, and back to global
// memory in T: one access of 4 * N bytes (f32) or 2 * N (bf16) for N 2, 4
// or 8; element by element otherwise (N 1 and 7: head dim 112's columns,
// 28 bytes of f32 at 4-byte alignment).
template <int N>
__device__ __forceinline__ void loadn(const float* p, float (&out)[N]) {
  if constexpr (N == 8) {
    load8(p, out);
  } else if constexpr (N == 4) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  } else if constexpr (N == 2) {
    const float2 a = *reinterpret_cast<const float2*>(p);
    out[0] = a.x; out[1] = a.y;
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = p[i];
  }
}
template <int N>
__device__ __forceinline__ void loadn(const __nv_bfloat16* p,
                                      float (&out)[N]) {
  if constexpr (N == 8) {
    load8(p, out);
  } else if constexpr (N % 2 == 0) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(p);
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = __bfloat162float(p[i]);
  }
}
template <int N>
__device__ __forceinline__ void storen(float* p, const float (&in)[N]) {
  if constexpr (N == 8) {
    reinterpret_cast<float4*>(p)[0] = make_float4(in[0], in[1], in[2], in[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(in[4], in[5], in[6], in[7]);
  } else if constexpr (N == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(in[0], in[1], in[2], in[3]);
  } else if constexpr (N == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(in[0], in[1]);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) p[i] = in[i];
  }
}
template <int N>
__device__ __forceinline__ void storen(__nv_bfloat16* p,
                                       const float (&in)[N]) {
  if constexpr (N == 8) {
    uint4 raw;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      h[i] = __floats2bfloat162_rn(in[2 * i], in[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = raw;
  } else if constexpr (N == 4) {
    uint2 raw;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
    h[0] = __floats2bfloat162_rn(in[0], in[1]);
    h[1] = __floats2bfloat162_rn(in[2], in[3]);
    *reinterpret_cast<uint2*>(p) = raw;
  } else if constexpr (N == 2) {
    *reinterpret_cast<__nv_bfloat162*>(p) =
        __floats2bfloat162_rn(in[0], in[1]);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) p[i] = __float2bfloat16_rn(in[i]);
  }
}

// 16 bytes global -> shared, asynchronously; src_bytes 0 fills zeros and
// reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes)
               : "memory");
}
// 4 bytes global -> shared, asynchronously, as cp_async16.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// threadIdx.x read anew (a volatile read): what a block of code derives
// from it is recomputed there and not held in registers across the loop.
__device__ __forceinline__ int fresh_tid() {
  int t;
  asm volatile("mov.u32 %0, %%tid.x;\n" : "=r"(t));
  return t;
}

// Named barrier `id` over n threads: arrive signals it without waiting,
// sync waits until n threads have arrived or synced; the shared-memory
// writes made before either are seen by the threads that pass it.
__device__ __forceinline__ void named_bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void named_bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// The row max and sum over the 16 lanes of a half-warp (xor offsets below
// 16 stay inside it); every lane ends with the same bits.
__device__ __forceinline__ float half_max(float v) {
#pragma unroll
  for (int off = kKeyTile / 2; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(kFull, v, off));
  return v;
}
__device__ __forceinline__ float half_sum(float v) {
#pragma unroll
  for (int off = kKeyTile / 2; off > 0; off >>= 1)
    v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// A unit: its sequence, KV head, head chunk, first query position, and the
// key tiles [t_begin, t_end) that its rows can see.
struct Unit {
  int b, hk, hc, q0, t_begin, t_end;
};

__device__ __forceinline__ Unit unit_of(const Shape& sh, const FwdPlan& pl,
                                        int u) {
  Unit x;
  int rest = div_of(u, pl.by_nqt);
  const int qt = u - rest * pl.by_nqt.d;
  u = rest;
  rest = div_of(u, pl.by_nhc);
  x.hc = u - rest * pl.by_nhc.d;
  u = rest;
  x.b = div_of(u, pl.by_hkv);
  x.hk = u - x.b * sh.Hkv;
  x.q0 = qt * pl.qt;
  int lo, hi;
  key_range(sh, x.q0, x.q0 + pl.qt, lo, hi);
  x.t_begin = lo / kKeyTile;
  x.t_end = (hi + kKeyTile - 1) / kKeyTile;
  return x;
}

template <typename T, int HD>
__global__ void __launch_bounds__(kFwdThreads, FwdResident<T, HD>::value)
fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, T* __restrict__ o,
           float* __restrict__ lse, Shape sh, FwdPlan pl) {
  constexpr int VEC = Vec<T>::n, LD = fwd_ld<T, HD>(), CH = HD / VEC;
  constexpr int QE = fwd_q_elems<T, HD>(), KE = fwd_k_elems<T, HD>();
  constexpr int VE = fwd_v_elems<T, HD>();
  constexpr int CPT = HD / kKeyTile;      // output columns a thread
  // the dot products go in chunks of one 16-byte read (4 f32, 8 bf16),
  // unrolled over HD
  constexpr int DC = VEC, D_UNROLL = HD / DC;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);           // [kStages][rows][LD]
  T* ks = qs + kStages * QE;                        // [kStages][16][LD]
  T* vs = ks + kStages * KE;                        // [kStages][16][HD]
  float* ps = reinterpret_cast<float*>(vs + kStages * VE);   // [rows][16]
  const int tid = threadIdx.x;
  const int j = tid % kKeyTile, rg = tid / kKeyTile;
  const int unit_rows = pl.qt * pl.hc;

  // Start the copies of key tile t of unit x into stage `to`, and, with
  // qslot >= 0, of its query rows into query slot qslot.  Rows of no
  // (position, head) and keys past S are zero-filled.
  auto fetch = [&](const Unit& x, int t, int to, int qslot) {
    if (qslot >= 0) {
      T* dst = qs + qslot * QE;
      constexpr int N = kUnitRows * CH;
#pragma unroll
      for (int i = 0; i < (N + kFwdThreads - 1) / kFwdThreads; ++i) {
        const int e = tid + i * kFwdThreads;
        if (N % kFwdThreads != 0 && e >= N) break;
        const int r = e / CH, c = (e % CH) * VEC, dp = div_of(r, pl.by_hc);
        const int pos = x.q0 + dp, hi = x.hc * pl.hc + r - dp * pl.hc;
        const bool ok = r < unit_rows && pos < sh.S && hi < pl.g;
        const T* src =
            ok ? q + ((static_cast<size_t>(x.b) * sh.S + pos) * sh.Hq +
                      x.hk * pl.g + hi) * HD + c
               : q;
        cp_async16(dst + r * LD + c, src, ok ? 16 : 0);
      }
    }
    T* kd = ks + to * KE;
    T* vd = vs + to * VE;
    constexpr int N = kKeyTile * CH;
#pragma unroll
    for (int i = 0; i < (N + kFwdThreads - 1) / kFwdThreads; ++i) {
      const int e = tid + i * kFwdThreads;
      if (N % kFwdThreads != 0 && e >= N) break;
      const int jj = e / CH, c = (e % CH) * VEC, pk = t * kKeyTile + jj;
      const bool ok = pk < sh.S;
      const size_t off =
          ((static_cast<size_t>(x.b) * sh.S + pk) * sh.Hkv + x.hk) * HD + c;
      cp_async16(kd + jj * LD + c, ok ? k + off : k, ok ? 16 : 0);
      cp_async16(vd + jj * HD + c, ok ? v + off : v, ok ? 16 : 0);
    }
  };

  // The thread's rows rg + 16 i of unit x: (query head in the group, and
  // position, or -1 for a row of no (position, head)).
  auto row_of = [&](const Unit& x, int i, int& hi) {
    const int r = rg + i * kRowGroups, dp = div_of(r, pl.by_hc);
    hi = x.hc * pl.hc + r - dp * pl.hc;
    const int pos = x.q0 + dp;
    return r < unit_rows && pos < sh.S && hi < pl.g ? pos : -1;
  };

  // The running state of the thread's rows of a unit.  Only the unit's
  // index, its tile range and the rows' positions stay live across a step;
  // the rest of a unit is decoded again where it is needed.
  float m[kRowsPer], l[kRowsPer], acc[kRowsPer][CPT];
  int pos[kRowsPer];
  auto start = [&](const Unit& x) {
#pragma unroll
    for (int i = 0; i < kRowsPer; ++i) {
      int hi;
      pos[i] = row_of(x, i, hi);
      m[i] = kNegInf;
      l[i] = 0.f;
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;
    }
  };

  int u = blockIdx.x;
  if (u >= pl.units) return;
  int t, t_end, st = 0, qslot = 0;
  {
    const Unit x = unit_of(sh, pl, u);
    t = x.t_begin;
    t_end = x.t_end;
    fetch(x, t, st, qslot);
    cp_async_commit();
    start(x);
  }
  while (true) {
    // the next step: the next key tile of this unit, or the first of the
    // next unit (with its query rows), copied while this step computes
    const bool last = t + 1 >= t_end;     // this unit's last tile
    const int nu = last ? u + static_cast<int>(gridDim.x) : u;
    const bool more = nu < pl.units;
    if (more) {
      const Unit nx = unit_of(sh, pl, nu);
      fetch(nx, last ? nx.t_begin : t + 1, st ^ 1, last ? qslot ^ 1 : -1);
    }
    cp_async_commit();
    cp_async_wait_one();                  // this step's copies have landed
    __syncthreads();

    // scores: key j of the tile against the thread's two rows
    const T* qb = qs + qslot * QE;
    const T* kj = ks + st * KE + j * LD;
    float part[kRowsPer][4];
#pragma unroll
    for (int i = 0; i < kRowsPer; ++i)
#pragma unroll
      for (int w = 0; w < 4; ++w) part[i][w] = 0.f;
#pragma unroll(D_UNROLL)
    for (int d = 0; d < HD; d += DC) {
      float kv[DC];
      loadn<DC>(kj + d, kv);
#pragma unroll
      for (int i = 0; i < kRowsPer; ++i) {
        float qv[DC];
        loadn<DC>(qb + (rg + i * kRowGroups) * LD + d, qv);
#pragma unroll
        for (int w = 0; w < DC; ++w)
          part[i][w & 3] = fmaf(qv[w], kv[w], part[i][w & 3]);
      }
    }
    const int pk = t * kKeyTile + j;
#pragma unroll
    for (int i = 0; i < kRowsPer; ++i) {
      const bool vis = pos[i] >= 0 && pk < sh.S &&
                       (!sh.causal || pk <= pos[i]) &&
                       (sh.window <= 0 || pk > pos[i] - sh.window);
      float s = (part[i][0] + part[i][1]) + (part[i][2] + part[i][3]);
      s = vis ? s * sh.scale : kNegInf;
      const float m_new = fmaxf(m[i], half_max(s));
      const float p = vis ? expf(s - m_new) : 0.f;
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + half_sum(p);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[i][c] *= corr;
      ps[(rg + i * kRowGroups) * kKeyTile + j] = p;
    }
    __syncwarp();                         // a row's P is its half-warp's

    // P.V: the thread's columns j * CPT .. of its two rows, keys in order
    const T* vc = vs + st * VE + j * CPT;
#pragma unroll
    for (int j0 = 0; j0 < kKeyTile; j0 += 4) {
      float4 p4[kRowsPer];
#pragma unroll
      for (int i = 0; i < kRowsPer; ++i)
        p4[i] = *reinterpret_cast<const float4*>(
            ps + (rg + i * kRowGroups) * kKeyTile + j0);
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        float vv[CPT];
        loadn<CPT>(vc + (j0 + w) * HD, vv);
#pragma unroll
        for (int i = 0; i < kRowsPer; ++i) {
          const float pw = w == 0 ? p4[i].x
                         : w == 1 ? p4[i].y
                         : w == 2 ? p4[i].z
                                  : p4[i].w;
#pragma unroll
          for (int c = 0; c < CPT; ++c) acc[i][c] = fmaf(pw, vv[c], acc[i][c]);
        }
      }
    }

    if (last) {                           // write the unit's rows out
      const Unit x = unit_of(sh, pl, u);
#pragma unroll
      for (int i = 0; i < kRowsPer; ++i) {
        if (pos[i] < 0) continue;
        int hi;
        row_of(x, i, hi);
        const int head = x.hk * pl.g + hi;
        const float inv = 1.f / fmaxf(l[i], 1e-30f);
        float out[CPT];
#pragma unroll
        for (int c = 0; c < CPT; ++c) out[c] = acc[i][c] * inv;
        storen<CPT>(o + ((static_cast<size_t>(x.b) * sh.S + pos[i]) *
                             sh.Hq + head) * HD + j * CPT,
                    out);
        if (j == 0)
          lse[(static_cast<size_t>(x.b) * sh.Hq + head) * sh.S +
              pos[i]] = m[i] + logf(l[i]);
      }
    }
    __syncthreads();                      // this stage may be refilled
    if (!more) break;
    if (last) {
      u = nu;
      const Unit x = unit_of(sh, pl, u);
      t = x.t_begin;
      t_end = x.t_end;
      qslot ^= 1;
      start(x);
    } else {
      ++t;
    }
    st ^= 1;
  }
}

// ---------------------------------------------------------------------------
// backward, dQ (and D): persistent CTAs over the forward's units (b, KV
// head, head chunk, query tile)
// ---------------------------------------------------------------------------

constexpr int kDqThreads = 256;                      // eight warps
constexpr int kDLanes = kDqThreads / kUnitRows;      // threads a row for D
// dS rows: the score phase's writes (4 rows x 8 keys a warp) hit distinct
// banks, and rows stay 16-byte aligned
constexpr int kDsLd = 24;

// Elements of 32 rows in T padded by one 16-byte copy: a unit's q, dO or
// o rows, or a stage of the ring (a K tile, then a V tile, 16 rows each).
template <typename T, int HD>
__host__ __device__ constexpr int dq_row_elems() {
  return kUnitRows * (HD + Vec<T>::n);
}
// Bytes: `blocks` blocks of 32 rows in T (q and dO in two slots, the ring's
// two stages, and o where it has a slot of its own), then lse in two
// slots, D, and p / dS in f32.
template <typename T, int HD>
__host__ __device__ constexpr int dq_bytes(int blocks) {
  return blocks * dq_row_elems<T, HD>() * static_cast<int>(sizeof(T)) +
         (3 * kUnitRows + kUnitRows * kDsLd) *
             static_cast<int>(sizeof(float));
}
// o has a slot of its own where the shared memory admits kMaxResident CTAs
// an SM with it (hd 32, 64; every bf16 instance); else it takes the ring's
// stage ahead of a unit's first key tile (f32 at hd 112, 128: 2 CTAs an
// SM).  The CTAs an SM must hold, for the register budget: as many as the
// shared memory admits, up to kMaxResident.
template <typename T, int HD> struct DqLayout {
  static constexpr bool o_slot =
      kSmemPerSM / (dq_bytes<T, HD>(7) + kSmemReserved) >= kMaxResident;
  static constexpr int smem = dq_bytes<T, HD>(o_slot ? 7 : 6);
  static constexpr int by_smem = kSmemPerSM / (smem + kSmemReserved);
  static constexpr int resident =
      by_smem < 1 ? 1 : (by_smem < kMaxResident ? by_smem : kMaxResident);
};

template <typename T, int HD>
__global__ void __launch_bounds__(kDqThreads, DqLayout<T, HD>::resident)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const T* __restrict__ o,
          const float* __restrict__ lse, const T* __restrict__ dout,
          T* __restrict__ dq, float* __restrict__ dsum, Shape sh,
          FwdPlan pl) {
  constexpr int VEC = Vec<T>::n, LD = HD + VEC, CH = HD / VEC;
  constexpr int RE = dq_row_elems<T, HD>(), KE = kKeyTile * LD;
  constexpr bool O_SLOT = DqLayout<T, HD>::o_slot;
  constexpr int RING = O_SLOT ? 0 : 1;        // steps a unit before its
                                              // first key tile (o's)
  constexpr int HALF = kDqThreads / 2;
  constexpr int KH = kKeyTile / 2;            // keys j and j + KH a thread
  constexpr int CPT = HD / kKeyTile;          // dQ columns a thread
  // the score loop reads 4 elements a row at a time (16 bytes of f32, 8
  // of bf16), unrolled by 4 (all of it at f32 HD 112, 128), as dK/dV's
  constexpr int D_UNROLL = VEC == 4 && HD > 64 ? HD / 4 : 4;
  extern __shared__ __align__(16) float smem[];
  T* qs = reinterpret_cast<T*>(smem);         // [2][rows][LD]
  T* dos = qs + 2 * RE;                       // [2][rows][LD]
  T* ring = dos + 2 * RE;                     // [kStages][K 16, V 16][LD]
  T* os = ring + kStages * RE;                // [rows][LD], where o has a
                                              // slot
  float* lses = reinterpret_cast<float*>(os + (O_SLOT ? RE : 0));  // [2][rows]
  float* dr = lses + 2 * kUnitRows;           // [rows]: D
  float* pds = dr + kUnitRows;                // [rows][kDsLd]: p, then dS
  const int tid = threadIdx.x;
  // Scores: the CTA's two halves (four warps each) split them by product,
  // half 0 s = q.k and half 1 dp = dO.v, keys j, j + 8 against rows rg, rg
  // + 16.  dQ: every thread, rows rr, rr + 16 and columns cg * CPT ...
  const int half = tid / HALF, idx = tid % HALF;
  const int j = idx % KH, rg = idx / KH;
  const int cg = tid % kKeyTile, rr = tid / kKeyTile;
  const int unit_rows = pl.qt * pl.hc;

  // Row r of unit x: (query head in the group, and position, or -1 for a
  // row of no (position, head)).
  auto row_of = [&](const Unit& x, int r, int& hi) {
    const int dp = div_of(r, pl.by_hc);
    hi = x.hc * pl.hc + r - dp * pl.hc;
    const int pos = x.q0 + dp;
    return r < unit_rows && pos < sh.S && hi < pl.g ? pos : -1;
  };

  // Start the copies of step e of unit x into stage `to`: at e == 0 the
  // unit's q and dO rows and lse into slot `slot` and its o rows (into o's
  // slot, or into the stage, which then holds nothing else); at a key tile
  // its K and V.  Rows of no (position, head) and keys past S are
  // zero-filled.
  auto fetch = [&](const Unit& x, int e, int to, int slot) {
    // read anew, so the copies' addresses are not hoisted out of the loop
    // into registers (at 80 a thread they spilled)
    const int ft = fresh_tid();
    T* stage = ring + to * RE;
    if (e == 0) {
      T* qd = qs + slot * RE;
      T* od = dos + slot * RE;
      T* oo = O_SLOT ? os : stage;
      constexpr int N = kUnitRows * CH;
#pragma unroll
      for (int i = 0; i < (N + kDqThreads - 1) / kDqThreads; ++i) {
        const int el = ft + i * kDqThreads;
        if (N % kDqThreads != 0 && el >= N) break;   // hd 112, bf16 hd 32
        const int r = el / CH, col = (el % CH) * VEC;
        int hi;
        const int pos = row_of(x, r, hi);
        const bool ok = pos >= 0;
        const size_t off =
            ((static_cast<size_t>(x.b) * sh.S + (ok ? pos : 0)) * sh.Hq +
             x.hk * pl.g + hi) * HD + col;
        cp_async16(qd + r * LD + col, ok ? q + off : q, ok ? 16 : 0);
        cp_async16(od + r * LD + col, ok ? dout + off : dout, ok ? 16 : 0);
        cp_async16(oo + r * LD + col, ok ? o + off : o, ok ? 16 : 0);
      }
      if (ft < kUnitRows) {
        int hi;
        const int pos = row_of(x, ft, hi);
        const bool ok = pos >= 0;
        const size_t off =
            (static_cast<size_t>(x.b) * sh.Hq + x.hk * pl.g + hi) * sh.S +
            (ok ? pos : 0);
        cp_async4(lses + slot * kUnitRows + ft, ok ? lse + off : lse,
                  ok ? 4 : 0);
      }
      if (RING) return;
    }
    const int t = x.t_begin + e - RING;
    constexpr int N = kKeyTile * CH;
#pragma unroll
    for (int i = 0; i < (N + kDqThreads - 1) / kDqThreads; ++i) {
      const int el = ft + i * kDqThreads;
      if (N % kDqThreads != 0 && el >= N) break;
      const int jj = el / CH, col = (el % CH) * VEC, pk = t * kKeyTile + jj;
      const bool ok = pk < sh.S;
      const size_t off =
          ((static_cast<size_t>(x.b) * sh.S + (ok ? pk : 0)) * sh.Hkv +
           x.hk) * HD + col;
      cp_async16(stage + jj * LD + col, ok ? k + off : k, ok ? 16 : 0);
      cp_async16(stage + KE + jj * LD + col, ok ? v + off : v, ok ? 16 : 0);
    }
  };

  float acc[2][CPT];                          // dQ of rows rr, rr + 16
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;

  // Only the unit's index and its steps stay live across a step; the rest
  // of a unit is decoded again where it is needed.
  int u = blockIdx.x;
  if (u >= pl.units) return;
  int e = 0, steps, st = 0, slot = 0;
  {
    const Unit x = unit_of(sh, pl, u);
    steps = x.t_end - x.t_begin + RING;
    fetch(x, 0, st, slot);
  }
  cp_async_commit();
  while (true) {
    cp_async_wait_all();                  // this step's copies have landed
    __syncthreads();                      // and the last step is done
    const bool last = e + 1 >= steps;

    if (e == 0) {
      const Unit x = unit_of(sh, pl, u);
      // D = rowsum(dO o) of the unit's rows: kDLanes threads a row, each
      // over every kDLanes-th 16-byte chunk in order, then a butterfly
      const int dt = fresh_tid(), r = dt / kDLanes, lane = dt % kDLanes;
      const T* dor = dos + slot * RE + r * LD;
      const T* orow = (O_SLOT ? os : ring + st * RE) + r * LD;
      float sum = 0.f;
      auto chunk = [&](int cc) {
        float a[VEC], b[VEC];
        loadn<VEC>(dor + cc * VEC, a);
        loadn<VEC>(orow + cc * VEC, b);
#pragma unroll
        for (int w = 0; w < VEC; ++w) sum = fmaf(a[w], b[w], sum);
      };
      if constexpr (CH % kDLanes == 0) {
#pragma unroll
        for (int i = 0; i < CH / kDLanes; ++i) chunk(lane + i * kDLanes);
      } else {                            // hd 112, bf16 hd 32
#pragma unroll
        for (int i = 0; i < (CH + kDLanes - 1) / kDLanes; ++i)
          if (lane + i * kDLanes < CH) chunk(lane + i * kDLanes);
      }
#pragma unroll
      for (int off = kDLanes / 2; off > 0; off >>= 1)
        sum += __shfl_xor_sync(kFull, sum, off);
      if (lane == 0) {
        dr[r] = sum;
        int hi;
        const int pos = row_of(x, r, hi);
        if (pos >= 0)
          dsum[(static_cast<size_t>(x.b) * sh.Hq + x.hk * pl.g + hi) *
                   sh.S + pos] = sum;
      }
      __syncthreads();                    // D is the CTA's; o's slot (or
                                          // stage) may be refilled
    }

    // the next step: the next of this unit, or the first of the next unit
    // (with its rows), copied while this step computes
    const int nu = last ? u + static_cast<int>(gridDim.x) : u;
    const bool more = nu < pl.units;
    if (more)
      fetch(unit_of(sh, pl, nu), last ? 0 : e + 1, st ^ 1,
            last ? slot ^ 1 : slot);
    cp_async_commit();

    if (!RING || e > 0) {
      const Unit x = unit_of(sh, pl, u);
      const int t = x.t_begin + e - RING;
      // scores: s = q.k (half 0) or dp = dO.v (half 1) of keys j, j + 8
      // against rows rg, rg + 16, as four partial sums each
      const T* rows = (half ? dos : qs) + slot * RE;
      const T* keys = ring + st * RE + half * KE;
      float part[2][2][4];                // [key][row][partial sum]
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int w = 0; w < 4; ++w) part[a][i][w] = 0.f;
#pragma unroll(D_UNROLL)
      for (int d = 0; d < HD; d += 4) {
        float kv[2][4], rv[2][4];
#pragma unroll
        for (int a = 0; a < 2; ++a) loadn<4>(keys + (j + a * KH) * LD + d,
                                             kv[a]);
#pragma unroll
        for (int i = 0; i < 2; ++i)
          loadn<4>(rows + (rg + i * kRowGroups) * LD + d, rv[i]);
#pragma unroll
        for (int a = 0; a < 2; ++a)
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int w = 0; w < 4; ++w)
              part[a][i][w] = fmaf(rv[i][w], kv[a][w], part[a][i][w]);
      }
      // half 0: p = exp(s scale - lse) into pds, then signal half 1;
      // half 1: dp - D, then, once p is there, dS = p (dp - D) over it;
      // each 0 where masked
      float e1[2][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = rg + i * kRowGroups;
        int hi;
        const int pos = row_of(x, r, hi);
        const float stat = half ? dr[r] : lses[slot * kUnitRows + r];
#pragma unroll
        for (int a = 0; a < 2; ++a) {
          const int pk = t * kKeyTile + j + a * KH;
          const bool vis = pos >= 0 && pk < sh.S &&
                           (!sh.causal || pk <= pos) &&
                           (sh.window <= 0 || pk > pos - sh.window);
          const float sum = (part[a][i][0] + part[a][i][1]) +
                            (part[a][i][2] + part[a][i][3]);
          if (half)
            e1[i][a] = vis ? sum - stat : 0.f;
          else
            pds[r * kDsLd + j + a * KH] =
                vis ? expf(sum * sh.scale - stat) : 0.f;
        }
      }
      if (half) {
        named_bar_sync(1, kDqThreads);    // half 0's p are there
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int a = 0; a < 2; ++a) {
            float* pa = pds + (rg + i * kRowGroups) * kDsLd + j + a * KH;
            *pa = *pa * e1[i][a];
          }
      } else {
        named_bar_arrive(1, kDqThreads);
      }
      __syncthreads();                    // dS is the CTA's

      // dQ += dS K: rows rr, rr + 16, columns cg * CPT .., keys in order
      const T* kc = ring + st * RE + cg * CPT;
#pragma unroll
      for (int j0 = 0; j0 < kKeyTile; j0 += 4) {
        float dsv[2][4];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          loadn<4>(pds + (rr + i * kRowGroups) * kDsLd + j0, dsv[i]);
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          float kk[CPT];
          loadn<CPT>(kc + (j0 + w) * LD, kk);
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int c = 0; c < CPT; ++c)
              acc[i][c] = fmaf(dsv[i][w], kk[c], acc[i][c]);
        }
      }
    }

    if (last) {                           // write the unit's rows out
      const Unit x = unit_of(sh, pl, u);
      const int wt = fresh_tid(), wr = wt / kKeyTile, wc = wt % kKeyTile;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        int hi;
        const int pos = row_of(x, wr + i * kRowGroups, hi);
        if (pos >= 0) {
          float out[CPT];
#pragma unroll
          for (int c = 0; c < CPT; ++c) out[c] = acc[i][c] * sh.scale;
          storen<CPT>(dq + ((static_cast<size_t>(x.b) * sh.S + pos) *
                                sh.Hq + x.hk * pl.g + hi) * HD + wc * CPT,
                      out);
        }
#pragma unroll
        for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;
      }
    }
    if (!more) break;
    if (last) {
      u = nu;
      const Unit x = unit_of(sh, pl, u);
      steps = x.t_end - x.t_begin + RING;
      e = 0;
      slot ^= 1;
    } else {
      ++e;
    }
    st ^= 1;
  }
}

// ---------------------------------------------------------------------------
// backward, dK and dV: persistent CTAs over units (b, KV head, key tile)
// ---------------------------------------------------------------------------

constexpr int kDkdvThreads = 256;                       // eight warps
// column groups of a half's 128 threads over 8 key pairs
constexpr int kColGroups = (kDkdvThreads / 2) / (kKeyTile / 2);
constexpr int kPld = kUnitRows + 4;                     // P^T rows

// The partition of a shape into units, fixed by S, Hq and Hkv alone (not by
// B): hc heads of a KV head's group by qt positions make a step's rows.
struct DkdvPlan {
  int g, hc, qt, nhc;   // as FwdPlan
  int units;            // B * Hkv * nkt, nkt = ceil(S / 16) key tiles
  FastDiv by_hc, by_nkt, by_hkv;
};

// Elements (in T) of a stage's q (or dO) rows and of a slot's K (or V)
// tile; rows are padded by one 16-byte copy, as the forward's.
template <typename T, int HD>
__host__ __device__ constexpr int dkdv_row_elems() {
  return kUnitRows * (HD + Vec<T>::n);
}
template <typename T, int HD>
__host__ __device__ constexpr int dkdv_key_elems() {
  return kKeyTile * (HD + Vec<T>::n);
}
// Bytes: the ring of q and dO rows (T), lse and D (f32), the K and V slots
// (T), then P^T and (dP - D)^T (f32).
template <typename T, int HD>
__host__ __device__ constexpr int dkdv_smem() {
  return kStages * (2 * dkdv_row_elems<T, HD>() +
                    2 * dkdv_key_elems<T, HD>()) *
             static_cast<int>(sizeof(T)) +
         (kStages * 2 * kUnitRows + 2 * kKeyTile * kPld) *
             static_cast<int>(sizeof(float));
}
// The CTAs an SM must hold, for the register budget: as many as the shared
// memory admits, up to kMaxResident (2 for f32 at HD 112 and 128).
template <typename T, int HD> struct DkdvResident {
  static constexpr int by_smem =
      kSmemPerSM / (dkdv_smem<T, HD>() + kSmemReserved);
  static constexpr int value =
      by_smem < 1 ? 1 : (by_smem < kMaxResident ? by_smem : kMaxResident);
};

// A unit: its sequence, KV head, first key, and the query tiles [qb, qb +
// nq) that its keys are seen by; its steps are nhc * nq.
struct DkUnit {
  int b, hk, k0, qb, nq;
};

__device__ __forceinline__ DkUnit dkdv_unit(const Shape& sh,
                                            const DkdvPlan& pl, int u) {
  DkUnit x;
  const int rest = div_of(u, pl.by_nkt);
  x.k0 = (u - rest * static_cast<int>(pl.by_nkt.d)) * kKeyTile;
  x.b = div_of(rest, pl.by_hkv);
  x.hk = rest - x.b * sh.Hkv;
  int lo, hi;
  query_range(sh, x.k0, x.k0 + kKeyTile, lo, hi);
  x.qb = lo / pl.qt;
  x.nq = (hi + pl.qt - 1) / pl.qt - x.qb;
  return x;
}

template <typename T, int HD>
__global__ void __launch_bounds__(kDkdvThreads, DkdvResident<T, HD>::value)
dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, const float* __restrict__ lse,
            const T* __restrict__ dout, const float* __restrict__ dsum,
            T* __restrict__ dk, T* __restrict__ dv, Shape sh,
            DkdvPlan pl) {
  constexpr int VEC = Vec<T>::n, LD = HD + VEC, CH = HD / VEC;
  constexpr int RE = dkdv_row_elems<T, HD>(), KE = dkdv_key_elems<T, HD>();
  constexpr int HALF = kDkdvThreads / 2;
  constexpr int KH = kKeyTile / 2;            // keys j and j + KH a thread
  constexpr int CPT = HD / kColGroups;        // columns a thread
  // columns of one access: VEC where it divides CPT, CPT where that
  // divides VEC, else one (hd 112's 7 columns a thread, spread by 16)
  constexpr int CW = CPT % VEC == 0                   ? VEC
                     : CPT < VEC && VEC % CPT == 0 ? CPT
                                                     : 1;
  constexpr int NP = CPT / CW;                // accesses a row
  // the score loop reads 4 elements a row at a time (16 bytes of f32, 8
  // of bf16), unrolled by 4 (all of it at f32 HD 112, 128): fewer loads in
  // flight keep the instance within its registers, without spills
  constexpr int D_UNROLL = VEC == 4 && HD > 64 ? HD / 4 : 4;
  extern __shared__ __align__(16) float smem[];
  T* qs = reinterpret_cast<T*>(smem);        // [kStages][rows][LD]
  T* dos = qs + kStages * RE;                // [kStages][rows][LD]
  float* stat = reinterpret_cast<float*>(dos + kStages * RE);
                                             // [kStages][lse, D][rows]
  T* ks = reinterpret_cast<T*>(stat + kStages * 2 * kUnitRows);
                                             // [slots][16][LD]
  T* vs = ks + kStages * KE;                 // [slots][16][LD]
  float* pt = reinterpret_cast<float*>(vs + kStages * KE);
                                             // [16][kPld]: P^T
  float* et = pt + kKeyTile * kPld;       // [16][kPld]: (dP - D)^T
  const int tid = threadIdx.x;
  // The two halves of the CTA (four warps each) split the work by product:
  // half 0 scores s = q.k and sums dV = P^T dO, half 1 scores dp = dO.v and
  // sums dK = dS^T q.  Scores: keys j, j + 8 against rows rg, rg + 16;
  // sums: keys jo, jo + 8, the columns of group cg.
  const int half = tid / HALF, idx = tid % HALF;
  const int j = idx % KH, rg = idx / KH;
  const int jo = idx / kColGroups, cg = idx % kColGroups;
  const int unit_rows = pl.qt * pl.hc;

  // Step e of unit x: its head chunk c and first query position q0.
  auto step_of = [&](const DkUnit& x, int e, int& q0) {
    const int c = e / x.nq;
    q0 = (x.qb + e - c * x.nq) * pl.qt;
    return c;
  };
  // Row r of the step (c, q0): (query head in the group, and position, or
  // -1 for a row of no (position, head)).
  auto row_of = [&](int c, int q0, int r, int& hi) {
    const int dp = div_of(r, pl.by_hc);
    hi = c * pl.hc + r - dp * pl.hc;
    const int pos = q0 + dp;
    return r < unit_rows && pos < sh.S && hi < pl.g ? pos : -1;
  };

  // Start the copies of step e of unit x (its q and dO rows, lse and D)
  // into stage `to`.  Rows of no (position, head) are zero-filled.
  auto fetch_rows = [&](const DkUnit& x, int e, int to) {
    int q0;
    const int c = step_of(x, e, q0);
    T* qd = qs + to * RE;
    T* od = dos + to * RE;
    constexpr int N = kUnitRows * CH;
#pragma unroll
    for (int i = 0; i < (N + kDkdvThreads - 1) / kDkdvThreads; ++i) {
      const int el = tid + i * kDkdvThreads;
      if (N % kDkdvThreads != 0 && el >= N) break;
      const int r = el / CH, col = (el % CH) * VEC;
      int hi;
      const int pos = row_of(c, q0, r, hi);
      const size_t off =
          ((static_cast<size_t>(x.b) * sh.S + pos) * sh.Hq + x.hk * pl.g +
           hi) * HD + col;
      cp_async16(qd + r * LD + col, pos >= 0 ? q + off : q,
                 pos >= 0 ? 16 : 0);
      cp_async16(od + r * LD + col, pos >= 0 ? dout + off : dout,
                 pos >= 0 ? 16 : 0);
    }
    if (tid < 2 * kUnitRows) {
      const int r = tid % kUnitRows;
      const float* src = tid < kUnitRows ? lse : dsum;
      int hi;
      const int pos = row_of(c, q0, r, hi);
      const size_t off =
          (static_cast<size_t>(x.b) * sh.Hq + x.hk * pl.g + hi) * sh.S + pos;
      cp_async4(stat + to * 2 * kUnitRows + tid, pos >= 0 ? src + off : src,
                pos >= 0 ? 4 : 0);
    }
  };

  // Start the copies of unit x's K and V tiles into slot `to`; keys past S
  // are zero-filled.
  auto fetch_kv = [&](const DkUnit& x, int to) {
    constexpr int N = kKeyTile * CH;
#pragma unroll
    for (int i = 0; i < (N + kDkdvThreads - 1) / kDkdvThreads; ++i) {
      const int el = tid + i * kDkdvThreads;
      if (N % kDkdvThreads != 0 && el >= N) break;
      const int jj = el / CH, col = (el % CH) * VEC, pk = x.k0 + jj;
      const bool ok = pk < sh.S;
      const size_t off =
          ((static_cast<size_t>(x.b) * sh.S + pk) * sh.Hkv + x.hk) * HD + col;
      cp_async16(ks + to * KE + jj * LD + col, ok ? k + off : k,
                 ok ? 16 : 0);
      cp_async16(vs + to * KE + jj * LD + col, ok ? v + off : v,
                 ok ? 16 : 0);
    }
  };

  float acc[2][CPT];                      // dV (half 0) or dK (half 1)
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;

  int u = blockIdx.x;
  if (u >= pl.units) return;
  DkUnit x = dkdv_unit(sh, pl, u);
  int e = 0, st = 0, slot = 0;
  fetch_kv(x, slot);
  fetch_rows(x, e, st);
  cp_async_commit();
  while (true) {
    // the next step: the next of this unit, or the first of the next unit
    // (with its K and V), copied while this step computes
    const bool last = e + 1 >= pl.nhc * x.nq;   // this unit's last step
    const int nu = last ? u + static_cast<int>(gridDim.x) : u;
    const bool more = nu < pl.units;
    if (more) {
      if (last) {
        const DkUnit nx = dkdv_unit(sh, pl, nu);
        fetch_kv(nx, slot ^ 1);
        fetch_rows(nx, 0, st ^ 1);
      } else {
        fetch_rows(x, e + 1, st ^ 1);
      }
    }
    cp_async_commit();
    cp_async_wait_one();                  // this step's copies have landed
    __syncthreads();

    // scores: s = q.k (half 0) or dp = dO.v (half 1) of keys j, j + 8
    // against rows rg, rg + 16, as four partial sums each
    {
      const T* rows = (half ? dos : qs) + st * RE;
      const T* keys = (half ? vs : ks) + slot * KE;
      float part[2][2][4];                // [key][row][partial sum]
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int w = 0; w < 4; ++w) part[a][i][w] = 0.f;
#pragma unroll(D_UNROLL)
      for (int d = 0; d < HD; d += 4) {
        float kv[2][4], rv[2][4];
#pragma unroll
        for (int a = 0; a < 2; ++a) loadn<4>(keys + (j + a * KH) * LD + d,
                                             kv[a]);
#pragma unroll
        for (int i = 0; i < 2; ++i)
          loadn<4>(rows + (rg + i * kRowGroups) * LD + d, rv[i]);
#pragma unroll
        for (int a = 0; a < 2; ++a)
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int w = 0; w < 4; ++w)
              part[a][i][w] = fmaf(rv[i][w], kv[a][w], part[a][i][w]);
      }
      const float* sb = stat + st * 2 * kUnitRows + half * kUnitRows;
      float* out = half ? et : pt;
      int q0;
      const int c = step_of(x, e, q0);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = rg + i * kRowGroups;
        int hi;
        const int pos = row_of(c, q0, r, hi);
#pragma unroll
        for (int a = 0; a < 2; ++a) {
          const int jj = j + a * KH, pk = x.k0 + jj;
          const bool vis = pos >= 0 && pk < sh.S &&
                           (!sh.causal || pk <= pos) &&
                           (sh.window <= 0 || pk > pos - sh.window);
          const float sum = (part[a][i][0] + part[a][i][1]) +
                            (part[a][i][2] + part[a][i][3]);
          // half 0: p = exp(s scale - lse); half 1: dP - D; 0 where masked
          out[jj * kPld + r] =
              !vis ? 0.f : half ? sum - sb[r] : expf(sum * sh.scale - sb[r]);
        }
      }
    }
    __syncthreads();                      // P^T and (dP - D)^T are the CTA's

    // dV += P^T dO (half 0) or dK += dS^T q with dS = P (dP - D) (half 1):
    // keys jo, jo + 8, the columns of group cg, the step's rows in order
    {
      const T* rows = (half ? qs : dos) + st * RE;
#pragma unroll
      for (int r0 = 0; r0 < kUnitRows; r0 += 4) {
        float coef[2][4];
#pragma unroll
        for (int a = 0; a < 2; ++a) {
          const int jj = jo + a * KH;
          loadn<4>(pt + jj * kPld + r0, coef[a]);
          if (half) {
            float ev[4];
            loadn<4>(et + jj * kPld + r0, ev);
#pragma unroll
            for (int w = 0; w < 4; ++w) coef[a][w] *= ev[w];
          }
        }
#pragma unroll
        for (int w = 0; w < 4; ++w) {
#pragma unroll
          for (int m = 0; m < NP; ++m) {
            const int col = (m * kColGroups + cg) * CW;
            float rv[CW];
            loadn<CW>(rows + (r0 + w) * LD + col, rv);
#pragma unroll
            for (int a = 0; a < 2; ++a)
#pragma unroll
              for (int cc = 0; cc < CW; ++cc)
                acc[a][m * CW + cc] =
                    fmaf(coef[a][w], rv[cc], acc[a][m * CW + cc]);
          }
        }
      }
    }

    if (last) {                           // write the unit's rows out
      T* dst = half ? dk : dv;
      const float mul = half ? sh.scale : 1.f;
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        const int pk = x.k0 + jo + a * KH;
        if (pk >= sh.S) continue;
        const size_t off =
            ((static_cast<size_t>(x.b) * sh.S + pk) * sh.Hkv + x.hk) * HD;
#pragma unroll
        for (int m = 0; m < NP; ++m) {
          float o[CW];
#pragma unroll
          for (int cc = 0; cc < CW; ++cc) o[cc] = acc[a][m * CW + cc] * mul;
          storen<CW>(dst + off + (m * kColGroups + cg) * CW, o);
        }
      }
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int cc = 0; cc < CPT; ++cc) acc[a][cc] = 0.f;
    }
    __syncthreads();                      // this stage may be refilled
    if (!more) break;
    if (last) {
      u = nu;
      x = dkdv_unit(sh, pl, u);
      e = 0;
      slot ^= 1;
    } else {
      ++e;
    }
    st ^= 1;
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

constexpr int kBadHeadDim = -1;
constexpr int kBadShape = -2;     // no unit, or more than 2^31 of them
constexpr int kUnaligned = -3;    // a pointer not 16-byte aligned

// Allow a kernel the dynamic shared memory it needs above the 48 KB
// default; returns a cudaError_t.
template <typename Kernel>
int allow_smem(Kernel kernel, int bytes) {
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

// A persistent kernel's instance, prepared once a device: its shared
// memory allowed and the CTAs of it an SM holds at once.
struct Prepared {
  const void* func = nullptr;
  int bytes = 0;
  int threads = 0;
  int per_sm = 0;                 // resident CTAs an SM
  int sms = 0;
};

constexpr int kMaxDevices = 64;

// Returns a cudaError_t; points `out` at the current device's record in
// by_device, the instance's own.
template <typename Kernel>
int prepare(Prepared (&by_device)[kMaxDevices], Kernel kernel, int bytes,
            int threads, const Prepared** out) {
  int device = 0;
  if (const cudaError_t err = cudaGetDevice(&device))
    return static_cast<int>(err);
  if (device < 0 || device >= kMaxDevices) return kBadShape;
  Prepared& inst = by_device[device];
  *out = &inst;
  if (inst.per_sm > 0) return 0;
  inst.func = reinterpret_cast<const void*>(kernel);
  inst.bytes = bytes;
  inst.threads = threads;
  if (const int err = allow_smem(kernel, inst.bytes)) return err;
  cudaDeviceGetAttribute(&inst.sms, cudaDevAttrMultiProcessorCount, device);
  int per_sm = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                inst.bytes);
  if (const int err = static_cast<int>(cudaGetLastError())) return err;
  inst.per_sm = max(1, per_sm);
  return 0;
}

template <typename T, int HD>
int fwd_prepare(const Prepared** out) {
  static Prepared by_device[kMaxDevices];
  return prepare(by_device, fwd_kernel<T, HD>, fwd_smem<T, HD>(),
                 kFwdThreads, out);
}

template <typename T, int HD>
int dq_prepare(const Prepared** out) {
  static Prepared by_device[kMaxDevices];
  return prepare(by_device, dq_kernel<T, HD>, DqLayout<T, HD>::smem,
                 kDqThreads, out);
}

template <typename T, int HD>
int dkdv_prepare(const Prepared** out) {
  static Prepared by_device[kMaxDevices];
  return prepare(by_device, dkdv_kernel<T, HD>, dkdv_smem<T, HD>(),
                 kDkdvThreads, out);
}

// What a prepared instance takes on the current device, into out[6]:
// registers a thread, local memory a thread (spills; bytes), static and
// dynamic shared memory a CTA (bytes), threads a CTA, resident CTAs an SM.
int resources(const Prepared* inst, int* out) {
  cudaFuncAttributes fa;
  if (const cudaError_t err = cudaFuncGetAttributes(&fa, inst->func))
    return static_cast<int>(err);
  out[0] = fa.numRegs;
  out[1] = static_cast<int>(fa.localSizeBytes);
  out[2] = static_cast<int>(fa.sharedSizeBytes);
  out[3] = inst->bytes;
  out[4] = inst->threads;
  out[5] = inst->per_sm;
  return 0;
}

// The units of a shape (see FwdPlan); units 0 when the count overflows.
FwdPlan fwd_plan(const Shape& sh) {
  FwdPlan pl;
  pl.g = sh.Hq / sh.Hkv;
  pl.hc = min(pl.g, kUnitRows);
  pl.qt = kUnitRows / pl.hc;
  const int nhc = (pl.g + pl.hc - 1) / pl.hc;
  const int nqt = (sh.S + pl.qt - 1) / pl.qt;
  const long long units = static_cast<long long>(sh.B) * sh.Hkv * nhc * nqt;
  pl.units = units > 0x7fffffffLL ? 0 : static_cast<int>(units);
  pl.by_hc = fast_div(pl.hc);
  pl.by_nhc = fast_div(nhc);
  pl.by_nqt = fast_div(nqt);
  pl.by_hkv = fast_div(sh.Hkv);
  return pl;
}

template <typename T, int HD>
int fwd(const void* q, const void* k, const void* v, void* o, float* lse,
        const Shape& sh, cudaStream_t stream) {
  const Prepared* inst = nullptr;
  if (const int err = fwd_prepare<T, HD>(&inst)) return err;
  const FwdPlan pl = fwd_plan(sh);
  if (pl.units <= 0) return kBadShape;
  const int grid = min(pl.units, inst->sms * inst->per_sm);
  fwd_kernel<T, HD><<<grid, kFwdThreads, inst->bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, sh, pl);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HD>
int fwd_resources(int* out) {
  const Prepared* inst = nullptr;
  if (const int err = fwd_prepare<T, HD>(&inst)) return err;
  return resources(inst, out);
}

template <typename T, int HD>
int dq(const void* q, const void* k, const void* v, const void* o,
       const float* lse, const void* dout, void* dq_, float* dsum,
       const Shape& sh, cudaStream_t stream) {
  const Prepared* inst = nullptr;
  if (const int err = dq_prepare<T, HD>(&inst)) return err;
  const FwdPlan pl = fwd_plan(sh);
  if (pl.units <= 0) return kBadShape;
  const int grid = min(pl.units, inst->sms * inst->per_sm);
  dq_kernel<T, HD><<<grid, kDqThreads, inst->bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(o), lse,
      static_cast<const T*>(dout), static_cast<T*>(dq_), dsum, sh, pl);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HD>
int dq_resources(int* out) {
  const Prepared* inst = nullptr;
  if (const int err = dq_prepare<T, HD>(&inst)) return err;
  return resources(inst, out);
}

// The units of a shape (see DkdvPlan); units 0 when the count overflows.
DkdvPlan dkdv_plan(const Shape& sh) {
  DkdvPlan pl;
  pl.g = sh.Hq / sh.Hkv;
  pl.hc = min(pl.g, kUnitRows);
  pl.qt = kUnitRows / pl.hc;
  pl.nhc = (pl.g + pl.hc - 1) / pl.hc;
  const int nkt = (sh.S + kKeyTile - 1) / kKeyTile;
  const long long units = static_cast<long long>(sh.B) * sh.Hkv * nkt;
  pl.units = units > 0x7fffffffLL ? 0 : static_cast<int>(units);
  pl.by_hc = fast_div(pl.hc);
  pl.by_nkt = fast_div(nkt);
  pl.by_hkv = fast_div(sh.Hkv);
  return pl;
}

template <typename T, int HD>
int dkdv(const void* q, const void* k, const void* v, const float* lse,
         const void* dout, const float* dsum, void* dk, void* dv,
         const Shape& sh, cudaStream_t stream) {
  const Prepared* inst = nullptr;
  if (const int err = dkdv_prepare<T, HD>(&inst)) return err;
  const DkdvPlan pl = dkdv_plan(sh);
  if (pl.units <= 0) return kBadShape;
  const int grid = min(pl.units, inst->sms * inst->per_sm);
  dkdv_kernel<T, HD><<<grid, kDkdvThreads, inst->bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lse, static_cast<const T*>(dout), dsum,
      static_cast<T*>(dk), static_cast<T*>(dv), sh, pl);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HD>
int dkdv_resources(int* out) {
  const Prepared* inst = nullptr;
  if (const int err = dkdv_prepare<T, HD>(&inst)) return err;
  return resources(inst, out);
}

// Call f with the instance tag of a head dim (f(HdTag<HD>{})); -1 for a
// head dim no kernel takes.
template <int HD> struct HdTag {
  static constexpr int hd = HD;
};

template <typename F>
int with_head_dim(int hd, F&& f) {
  switch (hd) {
    case 32: return f(HdTag<32>{});
    case 64: return f(HdTag<64>{});
    case 112: return f(HdTag<112>{});
    case 128: return f(HdTag<128>{});
    default: return kBadHeadDim;
  }
}

}  // namespace

extern "C" {

// q, o: (B, S, Hq, hd); k, v: (B, S, Hkv, hd); lse: (B, Hq, S) f32.
// bf16 != 0: q, k, v, o are bf16, else f32.  hd in {32, 64, 112, 128}.
// q, k, v and o must be 16-byte aligned (the copies are 16-byte vectors);
// returns -3 otherwise, -1 for another hd, -2 for a shape with no unit or
// too many.
int flash_attention_fwd_launch(const void* q, const void* k, const void* v,
                               void* o, float* lse, int B, int S, int Hq,
                               int Hkv, int hd, int causal, int window,
                               float scale, int bf16, cudaStream_t stream) {
  const Shape sh{B, S, Hq, Hkv, causal, window, scale};
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o)) &
      15)
    return kUnaligned;
  if (B <= 0 || S <= 0 || Hkv <= 0 || Hq % Hkv) return kBadShape;
  return with_head_dim(hd, [&](auto tag) {
    constexpr int HD = decltype(tag)::hd;
    return bf16 ? fwd<__nv_bfloat16, HD>(q, k, v, o, lse, sh, stream)
                : fwd<float, HD>(q, k, v, o, lse, sh, stream);
  });
}

// The forward instance's resources on the current device (see resources),
// into out[6]; returns a cudaError_t, or -1 for another hd.
int flash_attention_fwd_resources(int hd, int bf16, int* out) {
  return with_head_dim(hd, [&](auto tag) {
    constexpr int HD = decltype(tag)::hd;
    return bf16 ? fwd_resources<__nv_bfloat16, HD>(out)
                : fwd_resources<float, HD>(out);
  });
}

// q, k, v, o, dout and dq in one type (bf16 != 0: bf16, else f32), dout
// and dq like q; lse and dsum: (B, Hq, S) f32, dsum an output.  q, k, v,
// o, dout and dq must be 16-byte aligned (the copies are 16-byte
// vectors); returns -3 otherwise, -1 for another hd, -2 for a shape with
// no unit or too many.
int flash_attention_bwd_dq_launch(const void* q, const void* k,
                                  const void* v, const void* o,
                                  const float* lse, const void* dout,
                                  void* dq_, float* dsum, int B, int S,
                                  int Hq, int Hkv, int hd, int causal,
                                  int window, float scale, int bf16,
                                  cudaStream_t stream) {
  const Shape sh{B, S, Hq, Hkv, causal, window, scale};
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o) |
       reinterpret_cast<uintptr_t>(dout) | reinterpret_cast<uintptr_t>(dq_)) &
      15)
    return kUnaligned;
  if (B <= 0 || S <= 0 || Hkv <= 0 || Hq <= 0 || Hq % Hkv) return kBadShape;
  return with_head_dim(hd, [&](auto tag) {
    constexpr int HD = decltype(tag)::hd;
    return bf16 ? dq<__nv_bfloat16, HD>(q, k, v, o, lse, dout, dq_, dsum, sh,
                                        stream)
                : dq<float, HD>(q, k, v, o, lse, dout, dq_, dsum, sh,
                                stream);
  });
}

// The dQ instance's resources on the current device (see resources), into
// out[6]; returns a cudaError_t, or -1 for another hd.
int flash_attention_bwd_dq_resources(int hd, int bf16, int* out) {
  return with_head_dim(hd, [&](auto tag) {
    constexpr int HD = decltype(tag)::hd;
    return bf16 ? dq_resources<__nv_bfloat16, HD>(out)
                : dq_resources<float, HD>(out);
  });
}

// q, k, v, dout, dk and dv in one type (bf16 != 0: bf16, else f32); dsum
// from flash_attention_bwd_dq_launch; dk, dv like k.  q, k, v, dout, dk
// and dv must be 16-byte aligned (the copies are 16-byte vectors);
// returns -3 otherwise, -1 for another hd, -2 for a shape with no unit or
// too many.
int flash_attention_bwd_dkdv_launch(const void* q, const void* k,
                                    const void* v, const float* lse,
                                    const void* dout, const float* dsum,
                                    void* dk, void* dv, int B, int S,
                                    int Hq, int Hkv, int hd, int causal,
                                    int window, float scale, int bf16,
                                    cudaStream_t stream) {
  const Shape sh{B, S, Hq, Hkv, causal, window, scale};
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(dout) |
       reinterpret_cast<uintptr_t>(dk) | reinterpret_cast<uintptr_t>(dv)) &
      15)
    return kUnaligned;
  if (B <= 0 || S <= 0 || Hkv <= 0 || Hq <= 0 || Hq % Hkv) return kBadShape;
  return with_head_dim(hd, [&](auto tag) {
    constexpr int HD = decltype(tag)::hd;
    return bf16 ? dkdv<__nv_bfloat16, HD>(q, k, v, lse, dout, dsum, dk, dv,
                                          sh, stream)
                : dkdv<float, HD>(q, k, v, lse, dout, dsum, dk, dv, sh,
                                  stream);
  });
}

// The dK/dV instance's resources on the current device (see resources),
// into out[6]; returns a cudaError_t, or -1 for another hd.
int flash_attention_bwd_dkdv_resources(int hd, int bf16, int* out) {
  return with_head_dim(hd, [&](auto tag) {
    constexpr int HD = decltype(tag)::hd;
    return bf16 ? dkdv_resources<__nv_bfloat16, HD>(out)
                : dkdv_resources<float, HD>(out);
  });
}

}  // extern "C"
