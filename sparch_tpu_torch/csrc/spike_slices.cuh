// The column-slice layout of the recurrent spiking forwards for Hopper
// (sm_90a): the time loop of fused_cell_fwd.cu's RLIF/RadLIF forms and of
// tp_cell_fwd.cu, and their first product.
//
// Replaces, with those files: sparch_tpu/ops/pallas_cells.py `_fwd_kernel`
// (recurrent forms) and sparch_tpu/ops/pallas_tp.py `_tp_fwd_kernel`.
//
// What bound the layout before it on this card (one block a batch row, V's
// spiking rows gathered from L2 at every step; PERF.md section 6):
// at (256, 100, 1024) a step read ~138 spiking rows of V over every block's
// columns, ~145 MB a step from L2 in 4-byte requests, a row of V that
// spiked in 35 batch rows read 35 times; the bf16 mode, half the bytes,
// gained only 13-15 %: load requests and their latency on a chain of 100
// steps. And the first product s0 @ V walked all H rows of V from L2 in
// every block, one row an iteration.
//
// Layout (plan: ops/fused_cells.py `_fwd_plan`, checked by check_plan):
// - A block owns a column slice of `cols` columns (a multiple of 32 in
//   float32, of 64 in bf16, where a lane owns two neighbouring columns) and
//   the neurons of those columns for the `rows` batch rows of a row group.
//   Its slice of V (H rows of `cols` elements, read from V's rows in
//   16-byte pieces where the row stride allows, zero past the rank's
//   block, and one zero row) is copied into shared memory once and stays
//   there for all T: every element of V it loads serves every batch row
//   whose spike word has that bit set, from shared memory.
// - The slices of all ranks and `n_res` row groups at a time make one
//   cooperative launch; a block walks its groups g = k, k + n_res, ...
//   Every block of a group publishes its rows' spike words (one
//   __ballot_sync word a warp and row) into the slot of global memory that
//   the group's rows own, each word in one 64-bit store beside its step's
//   tag (t + 1; the first product's launch zeroes the slot, or across
//   cards the caller behind its entry barrier). A block then
//   reads its rows' words (rows x ceil(H/32)), polling each until it
//   carries the step's tag: the word is its own flag, so a step needs no
//   fence, no counter and no second trip to L2, and a block waits only on
//   the blocks of its group. Two parities of slot and of the words in
//   shared memory, one block barrier a step. The stores and loads are at
//   system scope, which the form across cards needs (one rank a card, each
//   rank's own slot on its card, every word stored into every rank's slot
//   over NVLink); on one card they took the time of gpu scope and gave the
//   same bits (PERF.md section 6).
// - A warp owns 32 (bf16: 64) columns of a row: it
//   turns the row's words into a list of its spiking rows k, ascending
//   (popc, a warp scan, __ffs; each entry the byte offset of row k in the
//   slice), padded to four entries with the zero row, and adds V[k][its
//   columns] from shared memory down the list, four rows a round, the next
//   round's loads in flight, one add after another.
// - The first product s0 @ V (s0 need not be 0/1) runs before the time
//   loop as a launch of its own (first_product_kernel): a thread one
//   column of eight batch rows, V's rows from L2 once a block.
//
// Rounding, as in the layout before: for each (row, column) the spiking
// rows are added in ascending k, one __fadd_rn after another from 0.f; a
// padded zero row adds +0, which changes no sum that started at +0; the
// first product is __fmul_rn then __fadd_rn, k ascending, a row whose s0
// is 0 skipped, s0 rounded to bf16 for it alone in the bf16 mode. So every
// output equals the layout before's bit for bit on any V.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "dropout_hash.cuh"
#include "tile_stream.cuh"
#include "tp_exchange.cuh"

namespace sparch {
namespace slices {

constexpr int kMaxThreads = 512;
constexpr int kFirstRows = 8;     // batch rows of a first-product block
constexpr int kFirstCols = 128;   // columns (threads) of one
constexpr int kFirstTile = 32;    // rows of V a thread has in flight
constexpr size_t kMaxSmem = 232448;  // an H100 block's shared memory
constexpr unsigned kFull = 0xffffffffu;

// neurons a lane owns in a row (the bf16 slice is loaded as bf16 pairs)
template <bool BF>
struct Lane {
  static constexpr int cpt = BF ? 2 : 1;
  static constexpr int rows = BF ? 2 : 4;  // rows a warp walks at most
};

struct Args {
  const void* wx;       // (B, T, ld): float, or bf16 where wx_bf16
  const float* scale;   // (ld,) AFFINE
  const float* shift;
  const float* alpha;   // (ld,)
  const float* beta;
  const float* a;
  const float* b;
  const void* V;        // (H, ld) float/bf16: the launch's columns
  const float* sv0;     // (B, ld): the first product
  const float* u0;      // (B, ld)
  const float* w0;
  const float* s0f;     // (B, H): the full initial spikes
  void* s_out;          // (B, T, ld): float, bf16 in the bf16 mode
  float* u_out;         // RESID
  const int* seed;      // DROPOUT
  uint32_t keep_u32;
  float inv_keep;
  DropRows drop;
  tp::Peers peers;      // slots [2][B][W] u64 (tag << 32 | word), zeroed
  int B, T, H, W;       // W = ceil(H/32) spike words a row
  int P, rank0, n_local, Hl, ld;  // single card: 1, 0, 1, H, H
  int S_r, cols, rows, n_res, n_groups;
  float threshold;
  int wx_bf16;
};

__host__ __device__ inline size_t slice_bytes(int H, int cols, bool bf16) {
  return ((size_t)(H + 1) * cols * (bf16 ? 2 : 4) + 15) / 16 * 16;
}
// a warp's list: H entries at most, padded to four, and four more read
// ahead by the walk's prefetch
__host__ __device__ inline int list_len(int H) { return (H + 11) / 4 * 4; }
// two parities of the group's words, rounded to 16 bytes
__host__ __device__ inline size_t words_bytes(int H, int rows) {
  return ((size_t)rows * ((H + 31) / 32) * 8 + 15) / 16 * 16;
}
// dynamic shared memory: the slice and its zero row, two parities of the
// group's words, one list a warp (4-byte entries)
__host__ __device__ inline size_t smem_bytes(int H, int cols, int rows,
                                             int threads, bool bf16) {
  return slice_bytes(H, cols, bf16) + words_bytes(H, rows) +
         (size_t)(threads / 32) * list_len(H) * 4;
}

// A tagged spike word, past L1 (the slot is written by other SMs), at
// system scope.
__device__ __forceinline__ void store_word(unsigned long long* p,
                                           unsigned long long v) {
  asm volatile("st.relaxed.sys.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}
__device__ __forceinline__ unsigned long long load_word(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.sys.global.u64 %0, [%1];"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}
constexpr int kPoll = 8;  // words a thread has in flight

// The n words of slot `src` into `dst`, each once it carries `tag`; traps
// after tp::kSpinTimeoutNs.
__device__ __forceinline__ void poll_words(const unsigned long long* src,
                                           uint32_t* dst, int n,
                                           unsigned tag) {
  const unsigned long long ready = (unsigned long long)tag << 32;
  for (int k0 = threadIdx.x; k0 < n; k0 += kPoll * blockDim.x) {
    unsigned long long v[kPoll];
#pragma unroll
    for (int j = 0; j < kPoll; ++j) {
      const int k = k0 + j * blockDim.x;
      v[j] = k < n ? load_word(src + k) : ready;
    }
#pragma unroll
    for (int j = 0; j < kPoll; ++j) {
      const int k = k0 + j * blockDim.x;
      if ((unsigned)(v[j] >> 32) != tag) {
        const unsigned long long t0 = tp::globaltimer();
        do {
          v[j] = load_word(src + k);
          if (tp::globaltimer() - t0 > tp::kSpinTimeoutNs) __trap();
        } while ((unsigned)(v[j] >> 32) != tag);
      }
      if (k < n) dst[k] = (uint32_t)v[j];
    }
  }
}

// spreads the low 16 bits of x to the even bits
__device__ __forceinline__ uint32_t spread16(uint32_t x) {
  x &= 0xffffu;
  x = (x | (x << 8)) & 0x00ff00ffu;
  x = (x | (x << 4)) & 0x0f0f0f0fu;
  x = (x | (x << 2)) & 0x33333333u;
  x = (x | (x << 1)) & 0x55555555u;
  return x;
}

// The lane's CPT values of a row of the slice at `at` (the lane's columns
// of that row, 4 bytes).
template <bool BF>
__device__ __forceinline__ void slice_row(const unsigned char* at, float* v) {
  const uint32_t bits = *reinterpret_cast<const uint32_t*>(at);
  if constexpr (BF) {
    v[0] = __uint_as_float(bits << 16);
    v[1] = __uint_as_float(bits & 0xffff0000u);
  } else {
    v[0] = __uint_as_float(bits);
  }
}

// One tile of the first product: kFirstTile rows of V from k0 (v) into
// the kFirstRows sums of a thread's column.
__device__ __forceinline__ void first_tile(const float* s0t, int k0, int H,
                                           const float* v, float* acc) {
#pragma unroll
  for (int j = 0; j < kFirstTile; ++j) {
    if (k0 + j >= H) break;
    const float* sk = s0t + (k0 + j) * kFirstRows;
    const float4 lo = *reinterpret_cast<const float4*>(sk);
    const float4 hi = *reinterpret_cast<const float4*>(sk + 4);
    const float s8[kFirstRows] = {lo.x, lo.y, lo.z, lo.w,
                                  hi.x, hi.y, hi.z, hi.w};
#pragma unroll
    for (int r = 0; r < kFirstRows; ++r) {
      if (s8[r] != 0.f) acc[r] = __fadd_rn(acc[r], __fmul_rn(s8[r], v[j]));
    }
  }
}

// sv0[row][c] = sum over k ascending of s0f[row][k] * V[k][c] (__fmul_rn
// then __fadd_rn, a zero s0 skipped) for the data columns c < n_cols of a
// (H, ld) matrix V; in the bf16 mode s0 is rounded to bf16 and V is bf16.
// Grid (ceil(n_cols / blockDim.x), ceil(B / kFirstRows)), blockDim.x up to
// kFirstCols, fewer where the grid would not fill the card; dynamic
// shared
// memory: the block's rows of s0, transposed (H x kFirstRows floats). A
// thread holds two tiles of its column of V in registers, the next one in
// flight from L2 while it adds the current one. It also zeroes the n_zero
// words of the time loop's slot.
template <bool BF>
__global__ void __launch_bounds__(kFirstCols)
first_product_kernel(const void* V, const float* s0f, float* sv0, int B,
                     int H, int ld, int n_cols, unsigned long long* zero,
                     size_t n_zero) {
  using ST = typename Elem<BF>::type;
  extern __shared__ float first_s0t[];
  float* s0t = first_s0t;
  {
    const size_t at = ((size_t)blockIdx.y * gridDim.x + blockIdx.x) *
                          blockDim.x + threadIdx.x;
    const size_t all = (size_t)gridDim.x * gridDim.y * blockDim.x;
    for (size_t i = at; i < n_zero; i += all) zero[i] = 0ull;
  }
  const int row0 = blockIdx.y * kFirstRows;
  const int nrow = min(kFirstRows, B - row0);
  if (H % 4 == 0 && reinterpret_cast<uintptr_t>(s0f) % 16 == 0) {
    const int h4 = H / 4;
#pragma unroll 4
    for (int i = threadIdx.x; i < h4 * kFirstRows; i += blockDim.x) {
      const int r = i / h4, k = (i % h4) * 4;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r < nrow) {
        v = *reinterpret_cast<const float4*>(s0f + (size_t)(row0 + r) * H +
                                             k);
      }
      s0t[k * kFirstRows + r] = BF ? round_bf16(v.x) : v.x;
      s0t[(k + 1) * kFirstRows + r] = BF ? round_bf16(v.y) : v.y;
      s0t[(k + 2) * kFirstRows + r] = BF ? round_bf16(v.z) : v.z;
      s0t[(k + 3) * kFirstRows + r] = BF ? round_bf16(v.w) : v.w;
    }
  } else {
#pragma unroll 4
    for (int i = threadIdx.x; i < H * kFirstRows; i += blockDim.x) {
      const int r = i / H, k = i % H;
      const float v = r < nrow ? s0f[(size_t)(row0 + r) * H + k] : 0.f;
      s0t[k * kFirstRows + r] = BF ? round_bf16(v) : v;
    }
  }
  __syncthreads();
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = c < n_cols;
  const ST* vc = static_cast<const ST*>(V) + (live ? c : 0);
  float acc[kFirstRows];
#pragma unroll
  for (int r = 0; r < kFirstRows; ++r) acc[r] = 0.f;
  // rows past H load row H - 1, which first_tile never adds
  float cur[kFirstTile], next[kFirstTile];
#pragma unroll
  for (int j = 0; j < kFirstTile; ++j) {
    cur[j] = to_float(vc[(size_t)min(j, H - 1) * ld]);
  }
  for (int k0 = 0; k0 < H; k0 += kFirstTile) {
    const int k1 = k0 + kFirstTile;
#pragma unroll
    for (int j = 0; j < kFirstTile; ++j) {
      next[j] = to_float(vc[(size_t)min(k1 + j, H - 1) * ld]);
    }
    first_tile(s0t, k0, H, cur, acc);
#pragma unroll
    for (int j = 0; j < kFirstTile; ++j) cur[j] = next[j];
  }
  if (!live) return;
  for (int r = 0; r < nrow; ++r) sv0[(size_t)(row0 + r) * ld + c] = acc[r];
}

template <bool ADAPTIVE, bool AFFINE, bool RESID, bool DROPOUT, bool BF>
__global__ void __launch_bounds__(kMaxThreads, 1)
slice_fwd_kernel(const Args p) {
  using ST = typename Elem<BF>::type;
  constexpr int CPT = Lane<BF>::cpt;
  constexpr int NR = Lane<BF>::rows;
  extern __shared__ __align__(16) unsigned char slice_smem[];
  unsigned char* smem = slice_smem;
  const int H = p.H, W = p.W, T = p.T, cols = p.cols, ld = p.ld;
  const int m = cols / (32 * CPT);  // warps a row of the slice
  const int q = (blockDim.x >> 5) / m;  // rows at a time
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int chunk = warp % m, rsub = warp / m;
  const int sl = blockIdx.x / p.n_res;  // the launch's slice
  const int res = blockIdx.x % p.n_res;
  const int rank = p.rank0 + sl / p.S_r;
  const int s = sl % p.S_r;
  const int c0 = rank * p.Hl + s * cols;  // the slice's first column
  const int end = rank * p.Hl + min(p.Hl, (s + 1) * cols);
  const int dshift = p.rank0 * p.Hl;      // global column - data column
  bool wx_bf16 = false;
  if constexpr (BF) wx_bf16 = p.wx_bf16;

  uint32_t* words = reinterpret_cast<uint32_t*>(smem + slice_bytes(H, cols, BF));
  uint32_t* list = reinterpret_cast<uint32_t*>(
                       smem + slice_bytes(H, cols, BF) + words_bytes(H, p.rows)) +
                   warp * list_len(H);
  {
    // the slice: row k at k * cols, its columns c0 .. c0 + cols - 1 of V's
    // row k, zero from `end` on (the rank's block ends there)
    using Raw = typename std::conditional<BF, unsigned short, unsigned>::type;
    constexpr int E = 16 / sizeof(ST);  // elements of a 16-byte piece
    const int n_live = end - c0;
    const Raw* src = static_cast<const Raw*>(p.V) + (c0 - dshift);
    if (ld % E == 0 && (c0 - dshift) % E == 0 && n_live % E == 0 &&
        reinterpret_cast<uintptr_t>(p.V) % 16 == 0) {
      const int per_row = cols / E;
      uint4* dst = reinterpret_cast<uint4*>(smem);
      for (int i = threadIdx.x; i < H * per_row; i += blockDim.x) {
        const int k = i / per_row, j = i % per_row * E;
        dst[i] = j < n_live ? __ldg(reinterpret_cast<const uint4*>(
                                  src + (size_t)k * ld + j))
                            : make_uint4(0u, 0u, 0u, 0u);
      }
    } else {
      Raw* dst = reinterpret_cast<Raw*>(smem);
      for (int i = threadIdx.x; i < H * cols; i += blockDim.x) {
        const int k = i / cols, j = i % cols;
        dst[i] = j < n_live ? src[(size_t)k * ld + j] : Raw(0);
      }
    }
    uint32_t* zero = reinterpret_cast<uint32_t*>(smem) +
                     (size_t)H * cols * sizeof(ST) / 4;
    for (int i = threadIdx.x; i < cols * (int)sizeof(ST) / 4; i += blockDim.x)
      zero[i] = 0u;
  }
  // the lane's columns in a slice row, and a row's bytes: a list entry is
  // the byte offset of its row k
  const unsigned char* vlane =
      smem + (chunk * 32 * CPT + lane * CPT) * sizeof(ST);
  const uint32_t row_bytes = cols * sizeof(ST);

  int dc[CPT];
  bool live[CPT];
  float al[CPT], oma[CPT], be[CPT], aa[CPT], bb[CPT], sc[CPT], sh[CPT];
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    const int gc = c0 + chunk * 32 * CPT + lane * CPT + c;
    live[c] = gc < end;
    dc[c] = (live[c] ? gc : c0) - dshift;
    al[c] = p.alpha[dc[c]];
    oma[c] = __fsub_rn(1.0f, al[c]);
    be[c] = ADAPTIVE ? p.beta[dc[c]] : 0.f;
    aa[c] = ADAPTIVE ? p.a[dc[c]] : 0.f;
    bb[c] = ADAPTIVE ? p.b[dc[c]] : 0.f;
    sc[c] = AFFINE ? p.scale[dc[c]] : 0.f;
    sh[c] = AFFINE ? p.shift[dc[c]] : 0.f;
  }
  // the spike words the warp publishes: its chunk's CPT words, where they
  // lie inside the slice's rank (a rank's width is a multiple of 128)
  const int word0 = (c0 + chunk * 32 * CPT) / 32;
  const bool one_card = p.n_local == p.P;
  const int n_dst = one_card ? 1 : p.P;
  const unsigned long long* own_slot =
      static_cast<const unsigned long long*>(
          p.peers.slots[one_card ? 0 : rank]);
  __syncthreads();  // the slice is in

  for (int g = res; g < p.n_groups; g += p.n_res) {
    const int row0 = g * p.rows;
    const int nrow = min(p.rows, p.B - row0);
    float u[NR][CPT], w[NR][CPT], st[NR][CPT], sv[NR][CPT], x[NR][CPT];
    uint32_t drop_base[NR];
#pragma unroll
    for (int i = 0; i < NR; ++i) {
      const int r = rsub + i * q;
      const bool ok = r < nrow;
      const size_t row = row0 + (ok ? r : 0);
      drop_base[i] =
          DROPOUT ? dropout_row_base(p.seed, (int)row, p.drop) : 0u;
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const bool on = ok && live[c];
        const size_t at = row * ld + dc[c];
        u[i][c] = on ? p.u0[at] : 0.f;
        w[i][c] = ADAPTIVE && on ? p.w0[at] : 0.f;
        st[i][c] = on ? p.s0f[row * H + dc[c] + dshift] : 0.f;
        sv[i][c] = on ? p.sv0[at] : 0.f;
        x[i][c] = on ? load_stream<BF>(p.wx, row * T * ld + dc[c], wx_bf16)
                     : 0.f;
      }
    }

    for (int t = 0; t < T; ++t) {
#pragma unroll
      for (int i = 0; i < NR; ++i) {
        const int r = rsub + i * q;
        if (r >= nrow) continue;  // the warp's rows: uniform
        const size_t at_t = ((size_t)(row0 + r) * T + t) * ld;
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          float d = x[i][c];
          if (AFFINE) d = __fadd_rn(__fmul_rn(sc[c], d), sh[c]);
          d = __fadd_rn(d, sv[i][c]);
          if (ADAPTIVE) {
            w[i][c] = __fadd_rn(__fadd_rn(__fmul_rn(be[c], w[i][c]),
                                          __fmul_rn(aa[c], u[i][c])),
                                __fmul_rn(bb[c], st[i][c]));
            d = __fsub_rn(d, w[i][c]);
          }
          u[i][c] = __fadd_rn(__fmul_rn(al[c], __fsub_rn(u[i][c], st[i][c])),
                              __fmul_rn(oma[c], d));
          st[i][c] = u[i][c] > p.threshold ? 1.f : 0.f;
          if (live[c]) {
            float stored = st[i][c];
            if (DROPOUT) {
              // the raw spike stays in the recurrence
              stored = dropout_keep(drop_base[i], dc[c] + dshift, t,
                                    p.keep_u32)
                           ? __fmul_rn(st[i][c], p.inv_keep)
                           : 0.f;
            }
            static_cast<ST*>(p.s_out)[at_t + dc[c]] = from_float<ST>(stored);
            if (RESID) p.u_out[at_t + dc[c]] = u[i][c];
          }
        }
      }
      if (t + 1 == T) break;  // the last step's spikes feed nothing
      const int parity = t & 1;
#pragma unroll
      for (int i = 0; i < NR; ++i) {
        const int r = rsub + i * q;
        if (r >= nrow) continue;
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          x[i][c] = live[c] ? load_stream<BF>(
                                  p.wx,
                                  ((size_t)(row0 + r) * T + t + 1) * ld + dc[c],
                                  wx_bf16)
                            : 0.f;
        }
        uint32_t wd0, wd1 = 0u;
        if constexpr (CPT == 1) {
          wd0 = __ballot_sync(kFull, live[0] && st[i][0] != 0.f);
        } else {
          const uint32_t b0 = __ballot_sync(kFull, live[0] && st[i][0] != 0.f);
          const uint32_t b1 =
              __ballot_sync(kFull, live[CPT - 1] && st[i][CPT - 1] != 0.f);
          wd0 = spread16(b0) | (spread16(b1) << 1);
          wd1 = spread16(b0 >> 16) | (spread16(b1 >> 16) << 1);
        }
        const int word = word0 + lane;
        if (lane < CPT && word * 32 < end) {
          const size_t at = ((size_t)parity * p.B + row0 + r) * W + word;
          const unsigned long long v =
              ((unsigned long long)(t + 1) << 32) | (lane == 0 ? wd0 : wd1);
          for (int dq = 0; dq < n_dst; ++dq) {
            store_word(static_cast<unsigned long long*>(p.peers.slots[dq]) +
                           at,
                       v);
          }
        }
      }
      // the group's words of this step, into this parity's buffer; the
      // barrier after it also ends every warp's walk of the other parity
      uint32_t* wbuf = words + parity * p.rows * W;
      poll_words(own_slot + ((size_t)parity * p.B + row0) * W, wbuf,
                 nrow * W, (unsigned)(t + 1));
      __syncthreads();
#pragma unroll
      for (int i = 0; i < NR; ++i) {
        const int r = rsub + i * q;
        if (r >= nrow) continue;
        // the row's spiking rows k, ascending
        const uint32_t* wrow = wbuf + r * W;
        int n = 0;
        for (int w0 = 0; w0 < W; w0 += 32) {
          const int wi = w0 + lane;
          uint32_t mw = wi < W ? wrow[wi] : 0u;
          const int cnt = __popc(mw);
          int incl = cnt;
#pragma unroll
          for (int dd = 1; dd < 32; dd <<= 1) {
            const int y = __shfl_up_sync(kFull, incl, dd);
            if (lane >= dd) incl += y;
          }
          int off = n + incl - cnt;
          while (mw) {
            list[off++] = (uint32_t)(wi * 32 + __ffs(mw) - 1) * row_bytes;
            mw &= mw - 1;
          }
          n += __shfl_sync(kFull, incl, 31);
        }
        // the zero row up to a multiple of four and four entries beyond
        const int n4 = (n + 3) & ~3;
        if (lane < n4 + 4 - n) list[n + lane] = (uint32_t)H * row_bytes;
        __syncwarp();
        float acc[CPT];
#pragma unroll
        for (int c = 0; c < CPT; ++c) acc[c] = 0.f;
        // four rows a round, the next round's loads issued before this
        // round's adds
        const uint4* l4 = reinterpret_cast<const uint4*>(list);
        float v[4][CPT];
        {
          const uint4 kk = l4[0];
          slice_row<BF>(vlane + kk.x, v[0]);
          slice_row<BF>(vlane + kk.y, v[1]);
          slice_row<BF>(vlane + kk.z, v[2]);
          slice_row<BF>(vlane + kk.w, v[3]);
        }
        for (int j = 4; j <= n4; j += 4) {
          const uint4 kk = l4[j >> 2];
          float nv[4][CPT];
          slice_row<BF>(vlane + kk.x, nv[0]);
          slice_row<BF>(vlane + kk.y, nv[1]);
          slice_row<BF>(vlane + kk.z, nv[2]);
          slice_row<BF>(vlane + kk.w, nv[3]);
#pragma unroll
          for (int c = 0; c < CPT; ++c) {
            acc[c] = __fadd_rn(
                __fadd_rn(__fadd_rn(__fadd_rn(acc[c], v[0][c]), v[1][c]),
                          v[2][c]),
                v[3][c]);
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) {
#pragma unroll
            for (int c = 0; c < CPT; ++c) v[e][c] = nv[e][c];
          }
        }
#pragma unroll
        for (int c = 0; c < CPT; ++c) sv[i][c] = acc[c];
        __syncwarp();  // the list is the next row's
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

// CUDA events around the two launches (first product, time loop), where
// the caller asks for the split; then the call waits for the card.
struct Split {
  cudaEvent_t ev[3] = {nullptr, nullptr, nullptr};
  bool on = false;
  explicit Split(bool want) : on(want) {
    if (!on) return;
    for (auto& e : ev) cudaEventCreate(&e);
  }
  ~Split() {
    if (!on) return;
    for (auto& e : ev) cudaEventDestroy(e);
  }
  void mark(int i, cudaStream_t st) {
    if (on) cudaEventRecord(ev[i], st);
  }
  void report(float* ms) {
    if (!on) return;
    cudaEventSynchronize(ev[2]);
    for (int i = 0; i < 2; ++i) cudaEventElapsedTime(&ms[i], ev[i], ev[i + 1]);
  }
};

// The plan the wrapper passes, checked against the shape: every (rank,
// row, neuron) owned once, the slice and its buffers in shared memory.
inline bool check_plan(const Args& p, int threads, bool bf16) {
  const int cpt = bf16 ? 2 : 1, nr = bf16 ? 2 : 4;
  if (p.cols <= 0 || p.cols % (32 * cpt) != 0 || threads <= 0 ||
      threads % 32 != 0 || threads > kMaxThreads || p.rows <= 0 ||
      p.n_res <= 0 || p.H >= 65535) {
    return false;
  }
  const int m = p.cols / (32 * cpt);
  const int warps = threads / 32;
  if (warps % m != 0 || (warps / m) * nr < p.rows) return false;
  if (p.n_groups != (p.B + p.rows - 1) / p.rows || p.n_res > p.n_groups)
    return false;
  if (p.S_r != (p.Hl + p.cols - 1) / p.cols) return false;
  return smem_bytes(p.H, p.cols, p.rows, threads, bf16) <= kMaxSmem;
}

// Blocks of the time loop's kernel an SM holds at (cols, rows, threads);
// 0 where the query fails.
template <bool A, bool F, bool RS, bool DR, bool BF>
int blocks_per_sm(int H, int cols, int rows, int threads) {
  auto kernel = slice_fwd_kernel<A, F, RS, DR, BF>;
  const size_t smem = smem_bytes(H, cols, rows, threads, BF);
  if (smem > kMaxSmem) return 0;
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem) != cudaSuccess) {
    return 0;
  }
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, threads,
                                                    smem) != cudaSuccess) {
    return 0;
  }
  return n;
}

// The first product into sv0 (p.sv0; the launch's n_local*Hl columns of
// p.V), then the time loop in one cooperative launch.
template <bool A, bool F, bool RS, bool DR, bool BF>
cudaError_t launch(const Args& p, float* sv0, int threads, float* split_ms,
                   cudaStream_t st) {
  const int n_cols = p.n_local * p.Hl;
  const size_t first_smem = (size_t)p.H * kFirstRows * sizeof(float);
  auto first = first_product_kernel<BF>;
  cudaError_t err = cudaFuncSetAttribute(
      first, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)first_smem);
  if (err != cudaSuccess) return err;
  auto kernel = slice_fwd_kernel<A, F, RS, DR, BF>;
  const size_t smem = smem_bytes(p.H, p.cols, p.rows, threads, BF);
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  Split split(split_ms != nullptr);
  split.mark(0, st);
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int row_blocks = (p.B + kFirstRows - 1) / kFirstRows;
  int cols_b = kFirstCols;
  while (cols_b > 32 && (n_cols + cols_b - 1) / cols_b * row_blocks < sms)
    cols_b /= 2;
  const dim3 grid((n_cols + cols_b - 1) / cols_b, row_blocks);
  // one-card form: the first product zeroes the one slot every block uses.
  // Across cards every rank's slot is zeroed by the caller before the entry
  // barrier (ops/tp_cards.py), since the peers store into it.
  const bool one_card = p.n_local == p.P;
  unsigned long long* slot =
      one_card ? static_cast<unsigned long long*>(p.peers.slots[0]) : nullptr;
  first<<<grid, cols_b, first_smem, st>>>(
      p.V, p.s0f, sv0, p.B, p.H, p.ld, n_cols, slot,
      one_card ? (size_t)2 * p.B * p.W : 0);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  split.mark(1, st);
  err = tp::launch_cooperative(kernel, p.n_local * p.S_r * p.n_res, threads,
                               smem, p, st);
  if (err != cudaSuccess) return err;
  split.mark(2, st);
  split.report(split_ms);
  return cudaGetLastError();
}

}  // namespace slices
}  // namespace sparch
