// The tensor-parallel exchange harnesses for Hopper (sm_90a): a chained
// all-gather and a chained reduce-scatter over the P ranks of the TP axis.
//
// Replaces: sparch_tpu/ops/pallas_tp.py `_ag_kernel` (:180, through
// `tp_all_gather` :214) and `_rs_kernel` (:241, through `tp_reduce_scatter`
// :261). Like them these kernels are harnesses: they pin the exchange that
// the TP cell kernels (tp_cell_fwd.cu, tp_cell_bwd.cu) run at every step,
// with `rounds` exchanges back to back.
//
// The result contract. Every output equals the plain version's
// (ops/fused_tp.py tp_all_gather_plain, tp_reduce_scatter_plain) bit for
// bit, at every P from 1 to kMaxRanks, at any B and for any rounds >= 1:
// - all-gather: rank q's (B, Hl) block x_q; round 0 gathers x, round r > 0
//   gathers (own column block of round r-1's gather) + 1, so round r
//   holds x + r. Every rank writes its (rounds, B, P*Hl) planes.
// - reduce-scatter: rank q's (B, P*Hl) partial x_q; round 0 reduces x,
//   round r > 0 reduces x_q + acc_{r-1}[:, 0] (the rank's previous reduced
//   first column, broadcast over the row). Column block d of a partial
//   goes to rank d, into its slot at sender offset (d - q) mod P; the
//   receiver adds its own block first, then the arrivals by offset
//   1 .. P-1: the JAX kernel's order (pallas_tp.py:169-172).
// - The rounds stay chained through two parity slots: round r's payload
//   depends on what round r-1 received, as in `_ag_kernel` / `_rs_kernel`.
//   That chain is the back-pressure (no credit flags): a rank stores into
//   a slot for exchange e+2 only after exchange e+1, which each peer
//   publishes only after it has read that slot for exchange e.
// - The kernels are written against `Peers` (tp_exchange.cuh: every rank's
//   slot and counter base) and run the ranks rank0 .. rank0+n_local-1; the
//   one-card form runs all P (n_local = P), the form across cards one a
//   card (n_local = 1, a launch per card, ops/tp_cards.py).
//
// What bounds them on this card: latency. At the smoke's shape (B=128,
// Hl=256, P=4, 3 rounds) a round moves about 2 MB through L2, a few
// hundred ns of bandwidth; the rest is the chain of each round (push,
// release fence, the peers' counts, fetch) and the launch.
//
// Design.
// - Row groups. A block owns `rows` batch rows of one rank (the plan,
//   ops/fused_tp.py `_collective_plan`: about one block an SM, at most four
//   rows) and makes one handshake per group and round. Where the card
//   holds fewer blocks than groups, block k of every rank walks groups k,
//   k + per_rank, ... in the same order (the deadlock rule of
//   tp_exchange.cuh); the launch is cooperative, so the runtime refuses a
//   grid that cannot be resident.
// - The handshake is warp 0's: lane q stands for rank q, so the P-1
//   releases take one fence and the P-1 spins run side by side (one after
//   another they cost an L2 round trip each).
// - The payload moves through shared memory. Slots are sender-major
//   ([parity][sender][row]), so a block's rows for one peer are one run.
//   Every copy is a bulk asynchronous copy (cp.async.bulk, no tensor map):
//   runs of global memory land in shared memory on an mbarrier, and shared
//   memory goes to a peer's slot (lanes of warp 0) or to the output (warp
//   1) as bulk stores. A publish waits for the pushes with
//   cp.async.bulk.wait_group and orders them before the release with
//   fence.proxy.async; lane q fetches sender q's run as soon as q's count
//   is in; the output stores complete behind the next round (two gathered
//   stages). Bulk copies beat 16-byte vector accesses at P = 4 and 8
//   (PERF.md §6, rows 8-9).
// - The scope the layout needs. Where the launch runs every rank
//   (n_local == P, the one-card form) the handshake is at gpu scope
//   (fence.acq_rel.gpu, relaxed .gpu stores, acquire .gpu loads);
//   otherwise at system scope (peers over NVLink), as tp_exchange.cuh.
// - One launch a call. Counters [sender][block in rank][parity] count the
//   exchanges of a launch (e/2 + 1 at exchange e of a block's walk). Each
//   receiving block zeroes its own counters after its last exchange: it has
//   then seen every sender's last count, and no sender writes them again in
//   that launch. So a launch leaves them zero for the next one that takes
//   them, and a CUDA graph replays with no zeroing between (the host zeroes
//   them once, when it allocates them). Two launches that run at once must
//   not share counters: ops/fused_tp.py gives eager launches those of their
//   stream and the launches of a graph capture counters of their own (by
//   capture and stream, sparch_tp_capture_id), so only two overlapping
//   replays of one graph would share them, which its slots forbid anyway.
// - The cross-card form (n_local < P) needs the same of every peer: a
//   launch may start only after every peer's previous launch on these
//   counters and slots has ended. Its caller supplies that entry barrier
//   (the JAX kernels' entry barrier stands for it): ops/tp_cards.py zeroes
//   every card's counters, then every card's stream waits on every card's
//   zeroing and on the peers' previous launches, by CUDA events.
// - A spin that has not ended after kSpinTimeoutNs traps.
//
// C interface, bound with ctypes: each entry point returns the launch's
// cudaError_t (or an invalid-value error for arguments or a plan it does
// not take) and never synchronises. `plan` (host memory): {rows a group,
// blocks a rank}.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tile_stream.cuh"
#include "tp_exchange.cuh"

// chip_profile.py `collectives` stamps each round's phases through it
#ifndef COLL_STAMP
#define COLL_STAMP(round, k)
#endif

namespace {

using sparch::tp::Peers;

constexpr int kThreads = 256;
// dynamic shared memory a block may take (ops/fused_tp.py _COLL_SMEM)
constexpr int kSmemMax = 232448 - 1024;

struct Args {
  const float* x;  // all-gather: (B, ld), local rank l's block at column
                   // l*Hl; reduce-scatter: [n_local][B][H] partials
  float* out;      // all-gather: [n_local][rounds][B][H]; reduce-scatter:
                   // (rounds, B, ld), local rank l's block at column l*Hl
  Peers peers;     // slots: [2][P][B][Hl] floats; counters
                   // [P][per_rank][2]
  int P, rank0, n_local, B, H, Hl, ld, rounds;
  int rows, per_rank, groups;  // the plan
};

// Shared memory of a block, in floats, for `rows` rows.
inline size_t ag_floats(int rows, int H, int Hl) {
  return (size_t)rows * (Hl + 2 * H);  // payload, two gathered stages
}
inline size_t rs_floats(int rows, int H, int Hl) {
  // partials, payload, arrivals, two reduced stages
  return (size_t)rows * (3 * H + 2 * Hl);
}

// ---------------------------------------------------------------------------
// The handshake, at the scope the layout needs
// ---------------------------------------------------------------------------

template <bool kSys>
__device__ __forceinline__ void fence_acq_rel() {
  if constexpr (kSys) {
    asm volatile("fence.acq_rel.sys;" ::: "memory");
  } else {
    asm volatile("fence.acq_rel.gpu;" ::: "memory");
  }
}
template <bool kSys>
__device__ __forceinline__ void store_relaxed(unsigned* p, unsigned v) {
  if constexpr (kSys) {
    asm volatile("st.relaxed.sys.global.u32 [%0], %1;" ::"l"(p), "r"(v)
                 : "memory");
  } else {
    asm volatile("st.relaxed.gpu.global.u32 [%0], %1;" ::"l"(p), "r"(v)
                 : "memory");
  }
}

template <bool kSys>
__device__ __forceinline__ unsigned load_acquire(const unsigned* p) {
  unsigned v;
  if constexpr (kSys) {
    asm volatile("ld.acquire.sys.global.u32 %0, [%1];"
                 : "=r"(v)
                 : "l"(p)
                 : "memory");
  } else {
    asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
                 : "=r"(v)
                 : "l"(p)
                 : "memory");
  }
  return v;
}

__device__ __forceinline__ unsigned* counter(const Args& a, int owner,
                                             int sender, int k, int parity) {
  return a.peers.flags[owner] + ((size_t)sender * a.per_rank + k) * 2 +
         parity;
}

// After the block's last exchange: zero the counters its peers wrote.
__device__ __forceinline__ void reset_counters(const Args& a, int rank,
                                               int k) {
  if (threadIdx.x != 0) return;
  for (int q = 0; q < a.P; ++q) {
    if (q == rank) continue;
    store_relaxed<false>(counter(a, rank, q, k, 0), 0u);
    store_relaxed<false>(counter(a, rank, q, k, 1), 0u);
  }
}

// ---------------------------------------------------------------------------
// Moving pieces (runs of `len` floats, len a multiple of 4, 16-byte aligned)
// ---------------------------------------------------------------------------

struct Piece {
  float* dst;
  const float* src;
};

__device__ __forceinline__ void bulk_store(float* dst, const float* src,
                                           uint32_t bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
          dst),
      "r"(sparch::shared_addr(src)), "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void fence_proxy_global() {
  asm volatile("fence.proxy.async.global;" ::: "memory");
}
__device__ __forceinline__ void fence_proxy_shared() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ int warp_id() { return threadIdx.x >> 5; }

// n pieces from shared memory to global memory (`piece(j)` names piece
// j): bulk stores by the lanes of warp `W`.
template <int W, typename F>
__device__ __forceinline__ void put(int n, int len, F piece) {
  if (warp_id() == W) {
    for (int j = threadIdx.x & 31; j < n; j += 32) {
      const Piece p = piece(j);
      bulk_store(p.dst, p.src, (uint32_t)len * 4u);
    }
  }
}

// The bulk stores warp `W` issued since its last commit form one group;
// then all but its newest `pending` groups are complete (`kRead`: have read
// their shared memory), ordered before the warp's next generic accesses.
template <int W, int pending, bool kRead = false>
__device__ __forceinline__ void commit_and_wait() {
  if (warp_id() == W) {
    asm volatile("cp.async.bulk.commit_group;");
    if constexpr (kRead) {
      asm volatile("cp.async.bulk.wait_group.read %0;" ::"n"(pending)
                   : "memory");
    } else {
      asm volatile("cp.async.bulk.wait_group %0;" ::"n"(pending)
                   : "memory");
      fence_proxy_global();
    }
    __syncwarp();
  }
}

// n pieces from global memory to shared memory: bulk copies by thread 0
// onto `bar` (after a proxy fence, so that they see what a generic acquire
// made visible). `land` waits.
template <typename F>
__device__ __forceinline__ void get(int n, int len, uint64_t* bar,
                                    F piece) {
  if (threadIdx.x == 0) {
    fence_proxy_global();
    fence_proxy_shared();
    sparch::mbar_expect_tx(bar, (uint32_t)(n * len) * 4u);
    for (int j = 0; j < n; ++j) {
      const Piece p = piece(j);
      sparch::bulk_copy(p.dst, p.src, (uint32_t)len * 4u, bar);
    }
  }
}

__device__ __forceinline__ void land(uint64_t* bar, uint32_t& phase) {
  sparch::mbar_wait(bar, phase);
  phase ^= 1u;
}

// Generic writes to shared memory are done and visible to bulk copies.
__device__ __forceinline__ void staged() {
  fence_proxy_shared();
  __syncthreads();
}

__device__ __forceinline__ void init_bar(uint64_t* bar) {
  if (threadIdx.x == 0) {
    sparch::mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    fence_proxy_shared();
  }
  __syncthreads();
}

__device__ __forceinline__ float4 add4(float4 v, float s) {
  return make_float4(__fadd_rn(v.x, s), __fadd_rn(v.y, s),
                     __fadd_rn(v.z, s), __fadd_rn(v.w, s));
}
__device__ __forceinline__ float4 add4(float4 v, float4 w) {
  return make_float4(__fadd_rn(v.x, w.x), __fadd_rn(v.y, w.y),
                     __fadd_rn(v.z, w.z), __fadd_rn(v.w, w.w));
}

// Exchange e of block k of `rank` (round r of its group), after the
// block's payload of exchange e is in every rank's slot (warp 0's drain
// carries it), then the fetch of what every rank sent this block
// (`piece(q)`: sender q's `len` floats). Lane q of warp 0 stands for rank
// q: for a peer, a release (one fence for the warp, then the count into
// peer q's counter) and a spin of acquire loads on peer q's count. Lane q
// then fetches sender q's run at once (its own at once), so early peers'
// runs land while later ones are awaited.
template <bool kSys, typename F>
__device__ __forceinline__ void exchange_fetch(const Args& a, int rank,
                                               int k, int e, int r, int len,
                                               uint64_t* bar, F piece) {
  const int lane = threadIdx.x & 31;
  const int first = (rank + 1) % a.P;  // the lane whose phases are stamped
  if (warp_id() == 0) {
    const int parity = e & 1;
    const unsigned count = (unsigned)(e >> 1) + 1u;
    if (lane == 0) sparch::mbar_expect_tx(bar, (uint32_t)(a.P * len) * 4u);
    __syncwarp();
    if (lane < a.P && lane != rank) {
      fence_acq_rel<kSys>();
      if (lane == first) COLL_STAMP(r, 2);
      store_relaxed<kSys>(counter(a, lane, rank, k, parity), count);
      if (lane == first) COLL_STAMP(r, 3);
      const unsigned* c = counter(a, rank, lane, k, parity);
      const unsigned long long t0 = sparch::tp::globaltimer();
      while (load_acquire<kSys>(c) < count) {
        if (sparch::tp::globaltimer() - t0 > sparch::tp::kSpinTimeoutNs) {
          __trap();
        }
      }
    } else if (lane == first) {  // P = 1: no peer
      COLL_STAMP(r, 2);
      COLL_STAMP(r, 3);
    }
    if (lane == first) COLL_STAMP(r, 4);
    if (lane < a.P) {
      fence_proxy_global();
      fence_proxy_shared();
      const Piece p = piece(lane);
      sparch::bulk_copy(p.dst, p.src, (uint32_t)len * 4u, bar);
    }
    __syncwarp();
  }
}

// ---------------------------------------------------------------------------
// The kernels. Slots of both: per rank [2][P][B][Hl] floats, [parity]
// [sender or sender offset][row], so the n rows a block sends to a peer
// are one run. Warp 0 pushes, makes the handshake and fetches, warp 1
// writes the output; every thread computes the next payload.
// ---------------------------------------------------------------------------

template <bool kSys>
__global__ void __launch_bounds__(kThreads)
tp_all_gather_kernel(const Args a) {
  extern __shared__ __align__(128) float smem[];
  __shared__ __align__(8) uint64_t bar;
  const int local = blockIdx.x / a.per_rank, k = blockIdx.x % a.per_rank;
  const int rank = a.rank0 + local;
  const int H = a.H, Hl = a.Hl, P = a.P;
  const size_t plane = (size_t)a.rows * H;
  float* const pay = smem;                         // [rows][Hl]
  float* const gat = smem + (size_t)a.rows * Hl;   // [2][P][n][Hl]
  auto slot = [&](int q, int parity, int s, int row) {
    return static_cast<float*>(a.peers.slots[q]) +
           (((size_t)parity * P + s) * a.B + row) * Hl;
  };
  uint32_t phase = 0;
  init_bar(&bar);
  int e = 0;
  for (int g = k; g < a.groups; g += a.per_rank) {
    const int row0 = g * a.rows, n = min(a.rows, a.B - row0);
    const size_t blk = (size_t)n * Hl;  // a sender's block of the group
    // round 0's block: this rank's columns of x
    get(n, Hl, &bar, [&](int i) {
      return Piece{pay + (size_t)i * Hl,
                   a.x + (size_t)(row0 + i) * a.ld + (size_t)local * Hl};
    });
    land(&bar, phase);
    for (int r = 0; r < a.rounds; ++r, ++e) {
      const int parity = e & 1;
      float* const stage = gat + parity * plane;
      if (threadIdx.x == 0) COLL_STAMP(r, 0);
      // the block into every rank's slot, at this rank's sender index
      put<0>(P, (int)blk, [&](int q) {
        return Piece{slot(q, parity, rank, row0), pay};
      });
      commit_and_wait<0, 0>();
      if (threadIdx.x == 0) COLL_STAMP(r, 1);
      exchange_fetch<kSys>(a, rank, k, e, r, (int)blk, &bar, [&](int s) {
        return Piece{stage + s * blk, slot(rank, parity, s, row0)};
      });
      land(&bar, phase);
      if (threadIdx.x == 0) COLL_STAMP(r, 5);
      // the gathered rows out, behind the next round (stage is fetched
      // into again two rounds on, once these have read it)
      float* const o =
          a.out + (((size_t)local * a.rounds + r) * a.B + row0) * H;
      put<1>(P * n, Hl, [&](int j) {
        const int s = j / n, i = j - s * n;
        return Piece{o + (size_t)i * H + (size_t)s * Hl,
                     stage + s * blk + (size_t)i * Hl};
      });
      commit_and_wait<1, 1, true>();
      if (r + 1 < a.rounds) {  // next round's block: own columns + 1
        const float4* own =
            reinterpret_cast<const float4*>(stage + rank * blk);
        float4* pay4 = reinterpret_cast<float4*>(pay);
        for (int i = threadIdx.x; i < (int)(blk >> 2); i += blockDim.x) {
          pay4[i] = add4(own[i], 1.0f);
        }
      }
      staged();
      if (threadIdx.x == 0) COLL_STAMP(r, 6);
    }
  }
  commit_and_wait<1, 0, true>();  // shared memory read before exit
  reset_counters(a, rank, k);
}

template <bool kSys>
__global__ void __launch_bounds__(kThreads)
tp_reduce_scatter_kernel(const Args a) {
  extern __shared__ __align__(128) float smem[];
  __shared__ __align__(8) uint64_t bar;
  const int local = blockIdx.x / a.per_rank, k = blockIdx.x % a.per_rank;
  const int rank = a.rank0 + local;
  const int H = a.H, Hl = a.Hl, P = a.P;
  const size_t plane = (size_t)a.rows * H;
  float* const xs = smem;                   // [P][n][Hl]: the partial
  float* const pay = xs + plane;            // [P][n][Hl]: round r > 0's
  float* const recv = pay + plane;          // [P][n][Hl]: by offset
  float* const red = recv + plane;          // [2][n][Hl]: reduced
  auto slot = [&](int q, int parity, int off, int row) {
    return static_cast<float*>(a.peers.slots[q]) +
           (((size_t)parity * P + off) * a.B + row) * Hl;
  };
  uint32_t phase = 0;
  init_bar(&bar);
  int e = 0;
  for (int g = k; g < a.groups; g += a.per_rank) {
    const int row0 = g * a.rows, n = min(a.rows, a.B - row0);
    const size_t blk = (size_t)n * Hl;
    // the partial's rows, column block d at xs + d * blk
    get(P * n, Hl, &bar, [&](int j) {
      const int d = j / n, i = j - d * n;
      return Piece{xs + d * blk + (size_t)i * Hl,
                   a.x + ((size_t)local * a.B + row0 + i) * H +
                       (size_t)d * Hl};
    });
    land(&bar, phase);
    for (int r = 0; r < a.rounds; ++r, ++e) {
      const int parity = e & 1;
      const float* const src = r == 0 ? xs : pay;
      float* const sum = red + parity * blk;
      if (threadIdx.x == 0) COLL_STAMP(r, 0);
      // column block d to rank d, at sender offset d - rank
      put<0>(P, (int)blk, [&](int d) {
        return Piece{slot(d, parity, (d - rank + P) % P, row0),
                     src + d * blk};
      });
      commit_and_wait<0, 0>();
      if (threadIdx.x == 0) COLL_STAMP(r, 1);
      exchange_fetch<kSys>(a, rank, k, e, r, (int)blk, &bar, [&](int q) {
        const int off = (rank - q + P) % P;  // sender q's offset
        return Piece{recv + off * blk, slot(rank, parity, off, row0)};
      });
      land(&bar, phase);
      if (threadIdx.x == 0) COLL_STAMP(r, 5);
      // own block first, then the arrivals by offset 1 .. P-1
      const float4* recv4 = reinterpret_cast<const float4*>(recv);
      float4* sum4 = reinterpret_cast<float4*>(sum);
      const int blk4 = (int)(blk >> 2), hl4 = Hl >> 2;
      for (int i = threadIdx.x; i < blk4; i += blockDim.x) {
        float4 v = recv4[i];
        for (int off = 1; off < P; ++off) v = add4(v, recv4[off * blk4 + i]);
        sum4[i] = v;
      }
      if (r + 1 < a.rounds) {  // next round's payload: partial + acc[:, 0]
        const float4* xs4 = reinterpret_cast<const float4*>(xs);
        float4* pay4 = reinterpret_cast<float4*>(pay);
        for (int dr = warp_id(); dr < P * n; dr += kThreads / 32) {
          const size_t first = (size_t)(dr % n) * Hl;  // the row's column 0
          float acc0 = recv[first];  // as the sum above adds it
          for (int off = 1; off < P; ++off) {
            acc0 = __fadd_rn(acc0, recv[off * blk + first]);
          }
          for (int c = threadIdx.x & 31; c < hl4; c += 32) {
            pay4[(size_t)dr * hl4 + c] = add4(xs4[(size_t)dr * hl4 + c], acc0);
          }
        }
      }
      staged();
      // the reduced rows out (behind the next round, done reading before
      // the reduce after it writes this stage again)
      float* const o = a.out + ((size_t)r * a.B + row0) * a.ld +
                       (size_t)local * Hl;
      put<1>(n, Hl, [&](int i) {
        return Piece{o + (size_t)i * a.ld, sum + (size_t)i * Hl};
      });
      commit_and_wait<1, 0, true>();
      if (threadIdx.x == 0) COLL_STAMP(r, 6);
    }
  }
  commit_and_wait<1, 0, true>();  // shared memory read before exit
  reset_counters(a, rank, k);
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

template <auto kernel>
cudaError_t allow_smem(int smem) {
  // set once a device and kernel, to the most any launch asked for
  static int allowed[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (smem <= allowed[dev] || smem <= 48 * 1024) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err == cudaSuccess) allowed[dev] = smem;
  return err;
}

template <auto kernel>
int launch(const Args& a, int smem, cudaStream_t st) {
  cudaError_t err = allow_smem<kernel>(smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.n_local * a.per_rank);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, a);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

bool aligned(const void* p) { return ((uintptr_t)p & 15u) == 0; }

// The arguments and the plan, checked; smem: the block's bytes.
bool make_args(const float* x, float* out, void* const* slots,
               unsigned* const* flags, int B, int H, int P, int rank0,
               int n_local, int ld, int rounds, const int* plan, bool reduce,
               Args* a, int* smem) {
  if (!x || !out || !plan || B < 1 || H < 1 || P < 1 ||
      P > sparch::tp::kMaxRanks || H % P || (H / P) % 4 || n_local < 1 ||
      rank0 < 0 || rank0 + n_local > P || rounds < 1 || ld % 4 ||
      ld < n_local * (H / P) || !aligned(x) || !aligned(out)) {
    return false;
  }
  Args v{};
  if (!sparch::tp::make_peers(slots, flags, P, &v.peers)) return false;
  for (int q = 0; q < P; ++q) {
    if (!aligned(slots[q])) return false;
  }
  v.x = x;
  v.out = out;
  v.P = P;
  v.rank0 = rank0;
  v.n_local = n_local;
  v.B = B;
  v.H = H;
  v.Hl = H / P;
  v.ld = ld;
  v.rounds = rounds;
  v.rows = plan[0];
  v.per_rank = plan[1];
  if (v.rows < 1 || v.per_rank < 1) return false;
  v.groups = (B + v.rows - 1) / v.rows;
  const size_t floats = reduce ? rs_floats(v.rows, H, v.Hl)
                               : ag_floats(v.rows, H, v.Hl);
  if (v.per_rank > v.groups || floats * 4 > (size_t)kSmemMax) return false;
  *a = v;
  *smem = (int)(floats * 4);
  return true;
}

}  // namespace

// Peer access from card `dev` to card `peer` (cudaDeviceEnablePeerAccess;
// already enabled counts as done, and that error is cleared, so that no
// later launch reports it). Leaves `dev` the current device.
extern "C" int sparch_tp_enable_peer(int dev, int peer) {
  cudaError_t err = cudaSetDevice(dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceEnablePeerAccess(peer, 0);
  if (err == cudaErrorPeerAccessAlreadyEnabled) {
    cudaGetLastError();
    err = cudaSuccess;
  }
  return (int)err;
}

// The id of the CUDA graph capture under way on `stream`; 0 where none.
extern "C" unsigned long long sparch_tp_capture_id(void* stream) {
  cudaStreamCaptureStatus status = cudaStreamCaptureStatusNone;
  unsigned long long id = 0;
  const cudaError_t err = cudaStreamGetCaptureInfo(
      static_cast<cudaStream_t>(stream), &status, &id);
  return err == cudaSuccess && status == cudaStreamCaptureStatusActive ? id
                                                                       : 0;
}

// Blocks of one collective (reduce: the reduce-scatter) with `smem` bytes
// of dynamic shared memory that an SM of the current card holds
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor); 0 where it cannot run.
extern "C" int sparch_tp_collective_blocks(int reduce, int smem) {
  int n = 0;
  cudaError_t err =
      reduce ? allow_smem<tp_reduce_scatter_kernel<false>>(smem)
             : allow_smem<tp_all_gather_kernel<false>>(smem);
  if (err != cudaSuccess) return 0;
  err = reduce ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                     &n, tp_reduce_scatter_kernel<false>, kThreads, smem)
               : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                     &n, tp_all_gather_kernel<false>, kThreads, smem);
  return err == cudaSuccess ? n : 0;
}

// slots/flags: host arrays of P device pointers, every rank's slot buffer
// ([2][P][B][H/P] floats) and counters ([P][plan[1]][2] u32, zero between
// launches, and taken by no other launch that may run at the same time).
// x: (B, ld); out: [n_local][rounds][B][H].
extern "C" int sparch_tp_all_gather(const float* x, float* out,
                                    void* const* slots,
                                    unsigned* const* flags, int B, int H,
                                    int P, int rank0, int n_local, int ld,
                                    int rounds, const int* plan,
                                    void* stream) {
  Args a;
  int smem = 0;
  if (!make_args(x, out, slots, flags, B, H, P, rank0, n_local, ld, rounds,
                 plan, false, &a, &smem)) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return n_local == P ? launch<tp_all_gather_kernel<false>>(a, smem, st)
                      : launch<tp_all_gather_kernel<true>>(a, smem, st);
}

// slots and flags as above. x: [n_local][B][H] partials; out: (rounds, B,
// ld).
extern "C" int sparch_tp_reduce_scatter(const float* x, float* out,
                                        void* const* slots,
                                        unsigned* const* flags, int B, int H,
                                        int P, int rank0, int n_local, int ld,
                                        int rounds, const int* plan,
                                        void* stream) {
  Args a;
  int smem = 0;
  if (!make_args(x, out, slots, flags, B, H, P, rank0, n_local, ld, rounds,
                 plan, true, &a, &smem)) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return n_local == P ? launch<tp_reduce_scatter_kernel<false>>(a, smem, st)
                      : launch<tp_reduce_scatter_kernel<true>>(a, smem, st);
}
