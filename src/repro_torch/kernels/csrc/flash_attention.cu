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
// (one 16-byte store for f32 at HD 64).
//
// The backward.  One CTA of four warps owns 16 rows (query rows for dQ, key
// rows for dK/dV) and streams tiles of 32 rows of the other operand through
// shared memory, one row per lane; scores are dot products over HD in
// registers, rows are reduced with warp shuffles, and each lane carries
// HD/32 columns of its accumulators.
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

// the backward's CTA: four warps owning 16 rows, streaming tiles of 32
constexpr int kThreads = 128;
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

// Stage n rows (s0 .. s0+n-1, head h) of a (B, S, H, HD) f32 tensor into
// shared memory with row stride ld; rows past S are zero.
template <int HD>
__device__ void stage(float* dst, int ld, const float* __restrict__ src,
                      const Shape& sh, int H, int b, int s0, int n, int h) {
  for (int e = threadIdx.x; e < n * HD; e += kThreads) {
    const int r = e / HD, c = e % HD, s = s0 + r;
    dst[r * ld + c] = s < sh.S ? src[row_off<HD>(sh, H, b, s, h) + c] : 0.f;
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

// Shared memory of the backward kernels, in floats.
template <int HD> constexpr int dq_smem() {
  return 2 * kRows * HD + 2 * kCols * (HD + 1);
}
template <int HD> constexpr int dkdv_smem() {
  return 2 * kRows * HD + 2 * kCols * (HD + 1) + 2 * kCols;
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

// N (2, 4 or 8) consecutive elements as f32, from shared memory, and back
// to global memory in T: one access of 4 * N bytes (f32) or 2 * N (bf16).
template <int N>
__device__ __forceinline__ void loadn(const float* p, float (&out)[N]) {
  if constexpr (N == 8) {
    load8(p, out);
  } else if constexpr (N == 4) {
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
  if constexpr (N == 8) {
    load8(p, out);
  } else {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(p);
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
}
template <int N>
__device__ __forceinline__ void storen(float* p, const float (&in)[N]) {
  if constexpr (N == 8) {
    reinterpret_cast<float4*>(p)[0] = make_float4(in[0], in[1], in[2], in[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(in[4], in[5], in[6], in[7]);
  } else if constexpr (N == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(in[0], in[1], in[2], in[3]);
  } else {
    *reinterpret_cast<float2*>(p) = make_float2(in[0], in[1]);
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
  } else {
    *reinterpret_cast<__nv_bfloat162*>(p) =
        __floats2bfloat162_rn(in[0], in[1]);
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
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
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

constexpr int kBadHeadDim = -1;
constexpr int kBadShape = -2;     // no unit, or more than 2^31 of them
constexpr int kUnaligned = -3;    // a forward pointer not 16-byte aligned

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

// The forward's instance, prepared once a device: its shared memory
// allowed and the CTAs of it an SM holds at once.
struct FwdPrepared {
  const void* func = nullptr;
  int bytes = 0;
  int per_sm = 0;                 // resident CTAs an SM
  int sms = 0;
};

constexpr int kMaxDevices = 64;

// Returns a cudaError_t; points `out` at the current device's record.
template <typename T, int HD>
int fwd_prepare(const FwdPrepared** out) {
  static FwdPrepared by_device[kMaxDevices];
  int device = 0;
  if (const cudaError_t err = cudaGetDevice(&device))
    return static_cast<int>(err);
  if (device < 0 || device >= kMaxDevices) return kBadShape;
  FwdPrepared& inst = by_device[device];
  *out = &inst;
  if (inst.per_sm > 0) return 0;
  auto kernel = fwd_kernel<T, HD>;
  inst.func = reinterpret_cast<const void*>(kernel);
  inst.bytes = fwd_smem<T, HD>();
  if (const int err = allow_smem(kernel, inst.bytes)) return err;
  cudaDeviceGetAttribute(&inst.sms, cudaDevAttrMultiProcessorCount, device);
  int per_sm = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kFwdThreads,
                                                inst.bytes);
  if (const int err = static_cast<int>(cudaGetLastError())) return err;
  inst.per_sm = max(1, per_sm);
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
  const FwdPrepared* inst = nullptr;
  if (const int err = fwd_prepare<T, HD>(&inst)) return err;
  const FwdPlan pl = fwd_plan(sh);
  if (pl.units <= 0) return kBadShape;
  const int grid = min(pl.units, inst->sms * inst->per_sm);
  fwd_kernel<T, HD><<<grid, kFwdThreads, inst->bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, sh, pl);
  return static_cast<int>(cudaGetLastError());
}

// What the forward's instance takes on the current device, into out[6]:
// registers a thread, local memory a thread (spills; bytes), static and
// dynamic shared memory a CTA (bytes), threads a CTA, resident CTAs an SM.
template <typename T, int HD>
int fwd_resources(int* out) {
  const FwdPrepared* inst = nullptr;
  if (const int err = fwd_prepare<T, HD>(&inst)) return err;
  cudaFuncAttributes fa;
  if (const cudaError_t err = cudaFuncGetAttributes(&fa, inst->func))
    return static_cast<int>(err);
  out[0] = fa.numRegs;
  out[1] = static_cast<int>(fa.localSizeBytes);
  out[2] = static_cast<int>(fa.sharedSizeBytes);
  out[3] = inst->bytes;
  out[4] = kFwdThreads;
  out[5] = inst->per_sm;
  return 0;
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

}  // namespace

extern "C" {

// q, o: (B, S, Hq, hd); k, v: (B, S, Hkv, hd); lse: (B, Hq, S) f32.
// bf16 != 0: q, k, v, o are bf16, else f32.  hd in {32, 64, 128}.  q, k,
// v and o must be 16-byte aligned (the copies and stores are 16-byte
// vectors); returns -3 otherwise, -1 for another hd, -2 for a shape with
// no unit or too many.
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

// The forward instance's resources on the current device (see
// fwd_resources), into out[6]; returns a cudaError_t, or -1 for another hd.
int flash_attention_fwd_resources(int hd, int bf16, int* out) {
  if (bf16) {
    if (hd == 32) return fwd_resources<__nv_bfloat16, 32>(out);
    if (hd == 64) return fwd_resources<__nv_bfloat16, 64>(out);
    if (hd == 128) return fwd_resources<__nv_bfloat16, 128>(out);
  } else {
    if (hd == 32) return fwd_resources<float, 32>(out);
    if (hd == 64) return fwd_resources<float, 64>(out);
    if (hd == 128) return fwd_resources<float, 128>(out);
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
