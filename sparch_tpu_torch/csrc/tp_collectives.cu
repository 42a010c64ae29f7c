// The tensor-parallel exchange harnesses for Hopper (sm_90a): a chained
// all-gather and a chained reduce-scatter over the P ranks of the TP axis.
//
// Replaces: sparch_tpu/ops/pallas_tp.py `_ag_kernel` (:180, through
// `tp_all_gather` :214) and `_rs_kernel` (:241, through `tp_reduce_scatter`
// :261). Like them these kernels are harnesses: they pin the exchange that
// the TP cell kernels (tp_cell_fwd.cu, tp_cell_bwd.cu) run at every step,
// with `rounds` exchanges back to back through the two parity slots, each
// round's payload depending on the round before (an unchained loop would
// race, tp_exchange.cuh). Bit for bit with their plain versions
// (ops/fused_tp.py tp_all_gather_plain, tp_reduce_scatter_plain):
// - all-gather: rank q's (B, Hl) block x_q; round 0 gathers x, round r > 0
//   gathers (own column block of round r-1's gather) + 1, so round r
//   holds x + r. Every rank writes its (rounds, B, P*Hl) planes.
// - reduce-scatter: rank q's (B, P*Hl) partial x_q; round 0 reduces x,
//   round r > 0 reduces x_q + acc_{r-1}[:, 0] (the rank's previous reduced
//   first column, broadcast over the row). Column block d of a partial
//   goes to rank d, into its slot at sender offset (d - q) mod P; the
//   receiver adds its own block first, then the arrivals by offset
//   1 .. P-1: the JAX kernel's order (pallas_tp.py:169-172).
//
// What bounds them on this card: latency. At the smoke's shape (B=128,
// Hl=256, P=4, 3 rounds) the payload is a few hundred KB per round; each
// round is a release/acquire handshake between P blocks (a few us).
//
// Design: one block per row (each row is its own group of counters),
// walking rows where the card holds fewer blocks than P*B; threads stride
// over the row's columns.
//
// C interface, bound with ctypes: each entry point returns the launch's
// cudaError_t (or an invalid-value error for arguments it does not take)
// and never synchronises. `plan` (host memory, may be null) receives
// {blocks per rank, blocks per SM}.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tp_exchange.cuh"

namespace {

using sparch::tp::Layout;
using sparch::tp::Peers;

constexpr int kThreads = 256;

struct AgArgs {
  const float* x;  // (B, ld): local rank l's block at column l*Hl
  float* out;      // [n_local][rounds][B][H]
  Peers peers;     // slots: per rank [2][B][H] floats
  Layout lay;
  int B, H, Hl, ld, rounds;
};

struct RsArgs {
  const float* x;  // [n_local][B][H]: each local rank's partial
  float* out;      // (rounds, B, ld): local rank l's block at column l*Hl
  Peers peers;     // slots: per rank [2][P][B][Hl] floats
  Layout lay;
  int B, H, Hl, ld, rounds;
};

__global__ void __launch_bounds__(kThreads)
tp_all_gather_kernel(const AgArgs p) {
  const Layout& l = p.lay;
  const int local = sparch::tp::local_rank(l);
  const int rank = l.rank0 + local;
  const int col0 = local * p.Hl;
  auto slot = [&](int q, int parity, int row) {
    return static_cast<float*>(p.peers.slots[q]) +
           ((size_t)parity * p.B + row) * p.H;
  };
  for (int row = sparch::tp::block_in_rank(l); row < p.B; row += l.per_rank) {
    for (int r = 0; r < p.rounds; ++r) {
      const int parity = r & 1;
      for (int c = threadIdx.x; c < p.Hl; c += blockDim.x) {
        // round r > 0: my own block of the last gather, + 1
        const float v =
            r == 0 ? p.x[(size_t)row * p.ld + col0 + c]
                   : __ldcg(slot(rank, parity ^ 1, row) + rank * p.Hl + c) +
                         1.0f;
        for (int q = 0; q < l.P; ++q) {
          __stcg(slot(q, parity, row) + rank * p.Hl + c, v);
        }
      }
      sparch::tp::exchange(p.peers, l, rank, row, r);
      float* o = p.out + (((size_t)local * p.rounds + r) * p.B + row) * p.H;
      const float* in = slot(rank, parity, row);
      for (int c = threadIdx.x; c < p.H; c += blockDim.x) o[c] = __ldcg(in + c);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
tp_reduce_scatter_kernel(const RsArgs p) {
  const Layout& l = p.lay;
  const int local = sparch::tp::local_rank(l);
  const int rank = l.rank0 + local;
  const int col0 = local * p.Hl;
  __shared__ float acc0;  // the last round's reduced first column
  auto slot = [&](int q, int parity, int d, int row) {
    return static_cast<float*>(p.peers.slots[q]) +
           (((size_t)parity * l.P + d) * p.B + row) * p.Hl;
  };
  for (int row = sparch::tp::block_in_rank(l); row < p.B; row += l.per_rank) {
    const float* x = p.x + ((size_t)local * p.B + row) * p.H;
    for (int r = 0; r < p.rounds; ++r) {
      const int parity = r & 1;
      __syncthreads();  // acc0 of round r-1 is written
      const float prev = r == 0 ? 0.f : acc0;
      for (int c = threadIdx.x; c < p.H; c += blockDim.x) {
        const float v = r == 0 ? x[c] : x[c] + prev;
        const int dst = c / p.Hl;
        const int d = (dst - rank + l.P) % l.P;
        __stcg(slot(dst, parity, d, row) + (c - dst * p.Hl), v);
      }
      sparch::tp::exchange(p.peers, l, rank, row, r);
      for (int c = threadIdx.x; c < p.Hl; c += blockDim.x) {
        float acc = __ldcg(slot(rank, parity, 0, row) + c);
        for (int d = 1; d < l.P; ++d) {
          acc = __fadd_rn(acc, __ldcg(slot(rank, parity, d, row) + c));
        }
        p.out[((size_t)r * p.B + row) * p.ld + col0 + c] = acc;
        if (c == 0) acc0 = acc;
      }
    }
  }
}

Layout make_layout(int P, int rank0, int n_local, int n_groups) {
  Layout l;
  l.P = P;
  l.rank0 = rank0;
  l.n_local = n_local;
  l.per_rank = 0;
  l.n_groups = n_groups;
  return l;
}

template <typename K, typename A>
int plan_and_launch(K kernel, A& a, int* plan, cudaStream_t st) {
  int per_sm = 0;
  cudaError_t err = sparch::tp::plan_blocks(
      kernel, kThreads, 0, a.lay.n_local, a.lay.n_groups, &a.lay.per_rank,
      &per_sm);
  if (err != cudaSuccess) return (int)err;
  if (plan) {
    plan[0] = a.lay.per_rank;
    plan[1] = per_sm;
  }
  err = sparch::tp::launch_cooperative(kernel, a.lay.n_local * a.lay.per_rank,
                                       kThreads, 0, a, st);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

bool shape_ok(int B, int H, int P, int n_local, int rank0, int rounds) {
  return B > 0 && H > 0 && P > 0 && H % P == 0 && rounds > 0 &&
         n_local > 0 && rank0 >= 0 && rank0 + n_local <= P;
}

}  // namespace

// slots/flags: host arrays of P device pointers, every rank's slot buffer
// ([2][B][H] floats) and zeroed counters ([P][B][2] u32). out: [n_local]
// [rounds][B][H].
extern "C" int sparch_tp_all_gather(const float* x, float* out,
                                    void* const* slots,
                                    unsigned* const* flags, int B, int H,
                                    int P, int rank0, int n_local, int ld,
                                    int rounds, int* plan, void* stream) {
  Peers peers;
  if (!x || !out || !shape_ok(B, H, P, n_local, rank0, rounds) ||
      !sparch::tp::make_peers(slots, flags, P, &peers)) {
    return (int)cudaErrorInvalidValue;
  }
  AgArgs a{x, out, peers, make_layout(P, rank0, n_local, B), B, H, H / P,
           ld, rounds};
  return plan_and_launch(tp_all_gather_kernel, a, plan,
                         static_cast<cudaStream_t>(stream));
}

// slots: every rank's [2][P][B][H/P] floats; flags as above. x: [n_local]
// [B][H] partials; out: (rounds, B, ld).
extern "C" int sparch_tp_reduce_scatter(const float* x, float* out,
                                        void* const* slots,
                                        unsigned* const* flags, int B, int H,
                                        int P, int rank0, int n_local, int ld,
                                        int rounds, int* plan, void* stream) {
  Peers peers;
  if (!x || !out || !shape_ok(B, H, P, n_local, rank0, rounds) ||
      !sparch::tp::make_peers(slots, flags, P, &peers)) {
    return (int)cudaErrorInvalidValue;
  }
  RsArgs a{x, out, peers, make_layout(P, rank0, n_local, B), B, H, H / P,
           ld, rounds};
  return plan_and_launch(tp_reduce_scatter_kernel, a, plan,
                         static_cast<cudaStream_t>(stream));
}
