// The in-kernel exchange of the tensor-parallel (TP) kernels for Hopper
// (sm_90a): tp_collectives.cu, tp_cell_fwd.cu and tp_cell_bwd.cu, and (its
// two halves, publish and await_peers, once per thread-block cluster)
// tp_ann.cuh's tp_ann_fwd.cu and tp_ann_bwd.cu.
//
// Replaces: sparch_tpu/ops/pallas_tp.py `_collective_barrier` (:87),
// `_ag_exchange` (:102) and `_rs_exchange` (:138), the building blocks of
// the TPU kernels `_ag_kernel`, `_rs_kernel`, `_tp_fwd_kernel` and
// `_tp_bwd_kernel`. There, P chips on the TP axis copy blocks into one
// another's VMEM with remote DMAs and wait on DMA semaphores. Here, P ranks
// store into one another's slot buffers in global memory and wait on step
// counters beside them.
//
// Ranks and peers. Every kernel is written against `Peers`: the base of
// every rank's slot buffer and counter array, in rank order, and against
// the rank a block runs. A launch runs the ranks rank0 .. rank0+n_local-1,
// `per_rank` blocks each (block b runs local rank b / per_rank). In the
// one-card form one cooperative launch runs all P ranks on the one card and
// every peer buffer lies in its memory, so a peer store is an ordinary
// global store. In the form across cards (ops/tp_cards.py) each card runs
// one rank (n_local = 1), a cooperative launch a card, and rank q's buffers
// lie on card q: a peer store crosses NVLink, with peer access enabled
// between every pair of cards and every card agreeing on per_rank and
// n_groups.
//
// The exchange of one row group at exchange index e:
// - Every thread stores its part of the block into slot `e & 1` of every
//   rank (its own included) with st.global.cg, then the block synchronises.
// - One thread makes the stores visible to the whole system
//   (__threadfence_system, right over NVLink too) and publishes the count
//   e/2 + 1 into every peer's counter of (sender = its rank, row group,
//   parity) with st.release.sys. It then spins with ld.acquire.sys until
//   the counters of all P-1 peers for that row group and parity reach the
//   count, and the block synchronises again. The slot is then read with
//   ld.global.cg: L1 is not coherent across SMs, L2 is the meeting point.
// - Parity, as in the JAX kernels (pallas_tp.py:18-37): two slots, and
//   each (sender, parity) has its own counter, so an arrival of exchange
//   e+1 can never be taken for one of exchange e. No credit flags: a rank
//   stores into slot p for exchange e+2 only after it has waited on
//   exchange e+1, which each peer publishes only after it has read slot p
//   for exchange e (its next payload depends on what it read). The value
//   chain is the backpressure; the harnesses of tp_collectives.cu pin it.
// - The wire's element type is the kernel's: float, or bf16 in the
//   bf16-stream mode (wire_store rounds to nearest, ties to even), so a
//   slot holds exactly the value every rank reads; the spike exchange of
//   tp_cell_fwd.cu moves 32-bit words in either mode.
// - Counters are monotonic within a launch and zeroed before each launch
//   (the wrapper allocates them zeroed on the launch's stream), so a count
//   of an earlier launch or an earlier exchange cannot be read as this
//   one's. Across cards the zeroing also needs a barrier before the launch,
//   as the JAX kernels' entry barrier: every card zeroes its counters, and
//   every card's stream waits on every card's zeroing, and on the peers'
//   previous launches on the same buffers, by CUDA events
//   (ops/tp_cards.py).
//
// Deadlock. A block waits on its peers' blocks of the same row group, so
// all of them must be resident at once: every launch is cooperative
// (cudaLaunchCooperativeKernel refuses a grid that cannot be co-resident),
// and plan_blocks sizes the grid from the occupancy calculator. Where the
// rows outnumber the resident blocks, a block walks its row groups g =
// k, k + per_rank, ..., in the same order on every rank, so block k of
// every rank works on the same group at the same time. A spin that has not
// ended after kSpinTimeoutNs traps (the launch then fails with an error)
// instead of holding the card.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sparch {
namespace tp {

constexpr int kMaxRanks = 8;
constexpr unsigned long long kSpinTimeoutNs = 10ull * 1000 * 1000 * 1000;

// Every rank's exchange buffers, by rank. slots: the kernel's own layout;
// flags: [P][n_groups][2] counters, indexed by sender, row group and parity.
struct Peers {
  void* slots[kMaxRanks];
  unsigned* flags[kMaxRanks];
};

// Host: `peers` from host arrays of the P ranks' buffer bases. False where
// P is out of range or an array or a base is missing.
inline bool make_peers(void* const* slots, unsigned* const* flags, int P,
                       Peers* peers) {
  if (!slots || !flags || P < 1 || P > kMaxRanks) return false;
  *peers = Peers{};
  for (int q = 0; q < P; ++q) {
    if (!slots[q] || !flags[q]) return false;
    peers->slots[q] = slots[q];
    peers->flags[q] = flags[q];
  }
  return true;
}

// Which ranks a launch runs and how its blocks map onto them.
struct Layout {
  int P;         // ranks on the TP axis
  int rank0;     // first rank this launch runs
  int n_local;   // ranks this launch runs (P in the one-card form)
  int per_rank;  // blocks per rank
  int n_groups;  // row groups, each with its own counters
};

__device__ __forceinline__ int local_rank(const Layout& l) {
  return blockIdx.x / l.per_rank;
}
__device__ __forceinline__ int block_in_rank(const Layout& l) {
  return blockIdx.x % l.per_rank;
}

__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
__device__ __forceinline__ void store_release_sys(unsigned* p, unsigned v) {
  asm volatile("st.release.sys.global.u32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}
__device__ __forceinline__ unsigned load_acquire_sys(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.sys.global.u32 %0, [%1];"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

// One element of a slot, stored past L1 (st.global.cg) and read back from
// L2 (ld.global.cg), in the wire's type: float, or bf16 (rounded as it is
// stored).
__device__ __forceinline__ void wire_store(float* p, float v) {
  __stcg(p, v);
}
__device__ __forceinline__ void wire_store(__nv_bfloat16* p, float v) {
  __stcg(reinterpret_cast<unsigned short*>(p),
         __bfloat16_as_ushort(__float2bfloat16_rn(v)));
}
__device__ __forceinline__ float wire_load(const float* p) {
  return __ldcg(p);
}
__device__ __forceinline__ float wire_load(const __nv_bfloat16* p) {
  return __bfloat162float(
      __ushort_as_bfloat16(__ldcg(reinterpret_cast<const unsigned short*>(p))));
}

__device__ __forceinline__ unsigned* counter(unsigned* base, const Layout& l,
                                             int sender, int group,
                                             int parity) {
  return base + ((size_t)sender * l.n_groups + group) * 2 + parity;
}

// The block's half of exchange e of row group `group`, after every thread
// has stored its payload into slot e & 1 of every rank: see the header. On
// return the block may read its own rank's slot e & 1.
__device__ __forceinline__ void exchange(const Peers& peers, const Layout& l,
                                         int rank, int group, int e) {
  __syncthreads();
  if (threadIdx.x == 0 && l.P > 1) {
    const int parity = e & 1;
    const unsigned count = (unsigned)(e >> 1) + 1u;
    __threadfence_system();
    for (int q = 0; q < l.P; ++q) {
      if (q != rank) {
        store_release_sys(counter(peers.flags[q], l, rank, group, parity),
                          count);
      }
    }
    const unsigned long long t0 = globaltimer();
    for (int q = 0; q < l.P; ++q) {
      if (q == rank) continue;
      const unsigned* c = counter(peers.flags[rank], l, q, group, parity);
      while (load_acquire_sys(c) < count) {
        if (globaltimer() - t0 > kSpinTimeoutNs) __trap();
      }
    }
    __threadfence();
  }
  __syncthreads();
}

__device__ __forceinline__ void fence_acq_rel_sys() {
  asm volatile("fence.acq_rel.sys;" ::: "memory");
}
__device__ __forceinline__ void store_relaxed_sys(unsigned* p, unsigned v) {
  asm volatile("st.relaxed.sys.global.u32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}
__device__ __forceinline__ unsigned load_relaxed_sys(const unsigned* p) {
  unsigned v;
  asm volatile("ld.relaxed.sys.global.u32 %0, [%1];"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

// The two halves of exchange e for kernels in which several blocks (the
// blocks of a thread-block cluster, tp_ann.cuh) share a row group: after a
// barrier over all of them, one thread publishes the count for the group;
// then one thread of each block waits on the peers and its block
// synchronises. One fence for all the counters, and one after all the
// waits: a fence.acq_rel.sys before relaxed stores is a release pattern
// and after relaxed loads an acquire pattern (the PTX memory model), and
// release is cumulative, so the barrier's order carries the other blocks'
// slot stores to a peer that reads the count.
__device__ __forceinline__ void publish(const Peers& peers, const Layout& l,
                                        int rank, int group, int e) {
  const unsigned count = (unsigned)(e >> 1) + 1u;
  fence_acq_rel_sys();
  for (int q = 0; q < l.P; ++q) {
    if (q != rank) {
      store_relaxed_sys(counter(peers.flags[q], l, rank, group, e & 1),
                        count);
    }
  }
}
__device__ __forceinline__ void await_peers(const Peers& peers,
                                            const Layout& l, int rank,
                                            int group, int e) {
  const unsigned count = (unsigned)(e >> 1) + 1u;
  const unsigned long long t0 = globaltimer();
  for (int q = 0; q < l.P; ++q) {
    if (q == rank) continue;
    const unsigned* c = counter(peers.flags[rank], l, q, group, e & 1);
    while (load_relaxed_sys(c) < count) {
      if (globaltimer() - t0 > kSpinTimeoutNs) __trap();
    }
  }
  fence_acq_rel_sys();
}

// Blocks per rank of a cooperative launch of `kernel` (threads, dynamic
// shared memory) that runs n_local ranks over n_groups row groups: as many
// as the card holds at once, at most one per group. Also reports the
// blocks one SM holds. Fails where the card holds fewer than n_local
// blocks (never falls back to a launch that could deadlock).
template <typename K>
cudaError_t plan_blocks(K kernel, int threads, size_t smem, int n_local,
                        int n_groups, int* per_rank, int* per_sm) {
  int dev = 0, sms = 0, coop = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (!coop) return cudaErrorNotSupported;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
  }
  int n = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, threads,
                                                      smem);
  if (err != cudaSuccess) return err;
  *per_sm = n;
  const int cap = n * sms / n_local;
  if (cap < 1) return cudaErrorCooperativeLaunchTooLarge;
  *per_rank = cap < n_groups ? cap : n_groups;
  return cudaSuccess;
}

template <typename K, typename A>
cudaError_t launch_cooperative(K kernel, int blocks, int threads, size_t smem,
                               const A& args, cudaStream_t stream) {
  void* params[] = {const_cast<A*>(&args)};
  return cudaLaunchCooperativeKernel((const void*)kernel, dim3(blocks),
                                     dim3(threads), params, smem, stream);
}

}  // namespace tp
}  // namespace sparch
