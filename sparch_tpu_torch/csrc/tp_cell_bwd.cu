// Tensor-parallel fused RLIF/RadLIF backward for Hopper (sm_90a):
// reverse-time BPTT with the boxcar surrogate over the neuron-sharded
// layout of tp_cell_fwd.cu.
//
// Replaces: sparch_tpu/ops/pallas_tp.py `_tp_bwd_kernel` (:448, through
// `_tp_backward` :727), in its two stream modes (BF): float32, and the TPU
// kernel's mxu_bf16 mode (below). Rank r owns the neurons of its column
// block. With A_t = dL/du_t, B_t = dL/dw_t, g_t the output cotangent and
// R_{t+1} the recurrent adjoint term, walking t = T..1 (:516-606):
//   C_t = g_t - alpha*A_{t+1} + R_{t+1} + b*B_{t+1}
//   A_t = window(u_t - thr)*C_t + alpha*A_{t+1} + a*B_{t+1}
//   D_t = (1-alpha)*A_t  (= dWx_t)
//   D_full = all-gather of every rank's D_t        (tp_exchange.cuh)
//   R_t = D_full @ Vrow^T, Vrow = V[shard, :]      (the rank's columns of
//                                                   D_full @ V^T)
//   B_t = beta*B_{t+1} - D_t
// and dalpha, da, db, dbeta, du0, dw0, ds0 as in fused_cell_bwd.cu (whose
// header derives them), dbeta by the P_t = B_t + beta*P_{t+1} recursion
// without a w series: the JAX kernel unwinds w from its end instead, and
// so needs the boundary states this port does not save. One exchange per
// step (T per row, the t = 1 one feeding ds0), every rank alike.
//
// dV = sum_t s_{t-1}^T D_t is a product after the time loop
// (dv_product.cuh, shared with fused_cell_bwd.cu), as the port's single-card
// backward computes it, over the membrane series (s recomputed as u > thr)
// and the D series. In the one-card form the ranks' dWx blocks side by side
// are the gathered D series, so the dV blocks of all ranks are one product
// over the full u series and dWx. Across cards a rank would keep the
// gathered series it reads from its slots; that form is not written (no
// multi-card run is possible here) and the entry point refuses n_local < P.
//
// What bounds it on this card: operations. Every step is a dense (B, H) x
// (H, Hl) product per rank, 2*B*H*H FLOP over all ranks, T times in
// sequence, and dV another 2*B*T*H*H: at (256, 100, 1024) 107 GFLOP, 1.6 ms
// at the float32 peak, against ~400 MB of streams (0.12 ms at HBM rate).
//
// bf16 mode (the JAX kernel's mxu_bf16: sdt bf16, pallas_tp.py:739): g is
// read and dWx written as bf16 streams (:745, :783), V^T is bf16 (rounded
// once by the wrapper, :505-506, :813), and the wire is bf16
// (tp_exchange.cuh), so D is rounded to bf16 as it is staged (:547) and
// both R = D_full @ Vrow^T and dV see the rounded value (:555-566; dWx is
// that value too, and dV reads it back). dV's left operand is rounded as
// well (s0, which need not be 0/1, :561); A, B, R, the carried state and
// every reduction stay float32, and B_t takes the unrounded D (:577).
// These are fused_cell_bwd.cu's bf16 rounding points.
//
// Design:
// - A block runs one rank's neurons for BT batch rows (a row group) and
//   walks the groups k, k + per_rank, ... on every rank alike; thread j owns
//   the rank's neurons j + i*blockDim.x (NPT of them) for the BT rows, with
//   A, B, P, R and the carried u in registers.
// - Each step the block stores its D rows into every rank's slot and, after
//   the exchange, reads the group's D_full rows back into shared memory as
//   [j][row]; R streams the rank's block of V^T from L2 through shared
//   memory in 64 KB TMA tiles, kStages deep, the stream running on across
//   steps and groups (tile_stream.cuh's pipeline). Vrow^T is the column
//   block r*Hl of one V^T that the wrapper transposes once (a pointer
//   offset, rows ld apart), so a tile is TJ row pieces of Hl floats, one
//   bulk copy each.
// - BT is the smallest of 1, 2, 4, 8 (NPT*BT <= 16, shared memory allowing)
//   at which the card holds every group of every rank at once; more rows
//   per block also read each V^T tile for more rows. Where even the largest
//   does not fit, blocks walk groups. Cooperative launch, as every TP kernel.
// - Reductions in a fixed order: per-block partials, a second kernel adds
//   them in ascending order; no atomics. Two runs give the same bits.
//
// C interface, bound with ctypes: sparch_tp_cell_bwd enqueues the kernels on
// the stream, returns cudaGetLastError() (or an invalid-value error for
// arguments it does not take) and never synchronises. `plan` (host memory,
// may be null) receives {BT, blocks per rank, blocks per SM, threads}.

#include <cuda_runtime.h>
#include <stdint.h>

#include "dv_product.cuh"
#include "tile_stream.cuh"
#include "tp_exchange.cuh"

namespace {

using namespace sparch;
using sparch::tp::Layout;
using sparch::tp::Peers;

constexpr int kThreads = 512;
constexpr int kMaxNpt = 4;    // so Hl <= 2048
constexpr int kMaxWork = 16;  // NPT * BT
constexpr int kVecs = 4;      // dalpha, dbeta, da, db

// g, VT, dwx and the slots are float, or bf16 in the bf16 mode.
struct BwdArgs {
  const void* g;       // (B, T, ld)
  const float* u_seq;  // (B, T, ld)
  const float* alpha;  // (ld,)
  const float* beta;
  const float* a;
  const float* b;
  const void* VT;      // (H, ld): V^T, rank l's Vrow^T at column l*Hl
  const float* u0;     // (B, ld)
  const float* w0;
  const float* s0f;    // (B, H): the gathered initial spikes
  void* dwx;           // (B, T, ld)
  float* partials;     // [n_local][per_rank][kVecs][Hl]
  float* du0;          // (B, ld)
  float* dw0;
  float* ds0;
  Peers peers;         // slots: per rank [2][B][H] elements
  Layout lay;
  int B, T, H, Hl, ld;
  float threshold;
};

// The stream of a rank's (H, Hl) block of V^T (elements MT), whose rows lie
// ld apart: tile n holds TJ rows j, one bulk copy per row, all reporting to
// the stage's mbarrier; T passes per row group.
template <typename MT>
struct ShardStream {
  const MT* base;
  MT* stages;
  uint64_t* full;
  int next_tile;
  int tile;
  int total_tiles;
  int n_tiles;
  int TJ;
  int H;
  int Hl;
  int ld;
};

template <typename MT>
__device__ __forceinline__ ShardStream<MT> shard_stream(const MT* base, int ld,
                                                        MT* stages,
                                                        uint64_t* full, int H,
                                                        int Hl, int passes) {
  ShardStream<MT> s;
  s.base = base;
  s.stages = stages;
  s.full = full;
  s.next_tile = 0;
  s.tile = 0;
  s.H = H;
  s.Hl = Hl;
  s.ld = ld;
  s.TJ = min(H, (kTileBytes / (int)sizeof(MT)) / Hl);
  s.n_tiles = (H + s.TJ - 1) / s.TJ;
  s.total_tiles = passes * s.n_tiles;
  return s;
}

// Start the copy of the stream's next tile (warp 0), if it has one left.
template <typename MT>
__device__ __forceinline__ void shard_start(ShardStream<MT>& s) {
  const int n = s.next_tile++;
  if (n >= s.total_tiles || threadIdx.x >= 32) return;
  const int j0 = (n % s.n_tiles) * s.TJ;
  const int rows = min(s.TJ, s.H - j0);
  const uint32_t row_bytes = (uint32_t)s.Hl * sizeof(MT);
  uint64_t* bar = &s.full[n % kStages];
  MT* dst = s.stages + (size_t)(n % kStages) * (kTileBytes / sizeof(MT));
  if (threadIdx.x == 0) mbar_expect_tx(bar, rows * row_bytes);
  __syncwarp();
  for (int q = threadIdx.x; q < rows; q += 32) {
    bulk_copy(dst + (size_t)q * s.Hl, s.base + (size_t)(j0 + q) * s.ld,
              row_bytes, bar);
  }
}

template <typename MT>
__device__ __forceinline__ void shard_open(ShardStream<MT>& s) {
  if (threadIdx.x == 0) {
    for (int k = 0; k < kStages; ++k) mbar_init(&s.full[k], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  for (int k = 0; k < kStages - 1; ++k) shard_start(s);
}

// mbar_wait with the exchange's time limit: a tile that never lands traps
// instead of holding the card.
__device__ __forceinline__ void shard_wait(uint64_t* bar, uint32_t parity) {
  const unsigned long long t0 = tp::globaltimer();
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(shared_addr(bar)), "r"(parity)
        : "memory");
    if (!done && tp::globaltimer() - t0 > tp::kSpinTimeoutNs) __trap();
  } while (!done);
}

// acc[i][r] += sum_j left[j][r] * VT[j][col0 + col[i]], j ascending, tile by
// tile (tile_stream.cuh stream_matrix over the strided block). `left` is
// H x BT floats in shared memory, written by the block before the call;
// when the call returns every thread is done reading it.
template <int NPT, int BT, typename MT>
__device__ __forceinline__ void shard_product(ShardStream<MT>& s,
                                              const float* left,
                                              const int (&col)[NPT],
                                              float (&acc)[NPT][BT]) {
  for (int jt = 0; jt < s.n_tiles; ++jt, ++s.tile) {
    shard_wait(&s.full[s.tile % kStages], (s.tile / kStages) & 1);
    __syncthreads();
    shard_start(s);  // into the stage of the tile before, free now
    const MT* stage =
        s.stages + (size_t)(s.tile % kStages) * (kTileBytes / sizeof(MT));
    const int j0 = jt * s.TJ;
    const int rows = min(s.TJ, s.H - j0);
#pragma unroll kUnroll
    for (int q = 0; q < rows; ++q) {
      float d[BT];
      load_rows<BT>(left + (size_t)(j0 + q) * BT, d);
#pragma unroll
      for (int i = 0; i < NPT; ++i) {
        const float v = to_float(stage[q * s.Hl + col[i]]);
#pragma unroll
        for (int r = 0; r < BT; ++r) acc[i][r] = fmaf(d[r], v, acc[i][r]);
      }
    }
  }
  __syncthreads();
}

template <bool ADAPTIVE, int NPT, int BT, bool BF>
__global__ void __launch_bounds__(kThreads)
tp_cell_bwd_kernel(const BwdArgs p) {
  using ST = typename Elem<BF>::type;  // g, dWx, V^T, wire
  // dynamic shared memory: the group's D_full as [j][row] (H*BT floats),
  // then, 16-byte aligned, the kStages tiles of V^T's block
  extern __shared__ __align__(16) float smem[];
  __shared__ uint64_t full[kStages];
  const Layout& l = p.lay;
  const int H = p.H, T = p.T, ld = p.ld, Hl = p.Hl;
  const int local = tp::local_rank(l);
  const int blk = tp::block_in_rank(l);
  const int rank = l.rank0 + local;
  const int col0 = local * Hl;
  const float thr = p.threshold;
  float* left = smem;
  const int my_groups = (l.n_groups - blk + l.per_rank - 1) / l.per_rank;
  ShardStream<ST> vt = shard_stream(
      static_cast<const ST*>(p.VT) + col0, ld,
      reinterpret_cast<ST*>(smem + ((H * BT + 3) & ~3)), full, H, Hl,
      my_groups * T);

  float al[NPT], oma[NPT], be[NPT], aa[NPT], bb[NPT];
  float dal[NPT], dbe[NPT], daa[NPT], dbb[NPT];
  float A[NPT][BT], Bw[NPT][BT], Pq[NPT][BT], R[NPT][BT], up[NPT][BT];
  int col[NPT];
#pragma unroll
  for (int i = 0; i < NPT; ++i) {
    col[i] = threadIdx.x + i * blockDim.x;
    const int c = col0 + col[i];
    al[i] = p.alpha[c];
    oma[i] = 1.0f - al[i];
    be[i] = ADAPTIVE ? p.beta[c] : 0.f;
    aa[i] = ADAPTIVE ? p.a[c] : 0.f;
    bb[i] = ADAPTIVE ? p.b[c] : 0.f;
    dal[i] = dbe[i] = daa[i] = dbb[i] = 0.f;
  }
  shard_open(vt);

  for (int grp = blk; grp < l.n_groups; grp += l.per_rank) {
    const int row0 = grp * BT;
    bool rowlive[BT];
#pragma unroll
    for (int r = 0; r < BT; ++r) rowlive[r] = row0 + r < p.B;
#pragma unroll
    for (int i = 0; i < NPT; ++i) {
#pragma unroll
      for (int r = 0; r < BT; ++r) {
        A[i][r] = Bw[i][r] = Pq[i][r] = R[i][r] = 0.f;
        // u_t of the first step walked, carried as the next one's u_t
        up[i][r] = rowlive[r]
                       ? p.u_seq[((size_t)(row0 + r) * T + (T - 1)) * ld +
                                 col0 + col[i]]
                       : 0.f;
      }
    }

    for (int t = T - 1; t >= 0; --t) {
      const int e = T - 1 - t;  // exchange index
      const int parity = e & 1;
#pragma unroll
      for (int i = 0; i < NPT; ++i) {
        const int c = col0 + col[i];
#pragma unroll
        for (int r = 0; r < BT; ++r) {
          const bool ok = rowlive[r];
          const size_t row = (size_t)(row0 + r);
          const size_t at = (row * T + t) * ld + c;
          const float g_t =
              ok ? to_float(static_cast<const ST*>(p.g)[at]) : 0.f;
          const float u_t = up[i][r];
          float u_p = 0.f, s_p = 0.f;
          if (ok) {
            if (t > 0) {
              u_p = p.u_seq[at - ld];
              s_p = u_p > thr ? 1.f : 0.f;
            } else {
              u_p = p.u0[row * ld + c];
              s_p = p.s0f[row * H + rank * Hl + col[i]];
            }
          }
          up[i][r] = u_p;
          const float alphaA = al[i] * A[i][r];
          float C = g_t - alphaA;
          C += R[i][r];
          if (ADAPTIVE) C += bb[i] * Bw[i][r];
          const float wsub = u_t - thr;
          const bool window = ok && wsub > -0.5f && wsub <= 0.5f;
          float A_new = (window ? C : 0.f) + alphaA;
          if (ADAPTIVE) A_new += aa[i] * Bw[i][r];
          const float dd = oma[i] * A_new;
          if (ok) {
            static_cast<ST*>(p.dwx)[at] = from_float<ST>(dd);
            const size_t slot_at = ((size_t)parity * p.B + row) * H +
                                   rank * Hl + col[i];
            for (int q = 0; q < l.P; ++q) {
              tp::wire_store(static_cast<ST*>(p.peers.slots[q]) + slot_at,
                             dd);
            }
          }
          dal[i] += A_new * (u_p - s_p - u_t);
          if (ADAPTIVE) {
            const float B_new = be[i] * Bw[i][r] - dd;
            dbe[i] += (aa[i] * u_p + bb[i] * s_p) * Pq[i][r];
            Pq[i][r] = B_new + be[i] * Pq[i][r];
            daa[i] += B_new * u_p;
            dbb[i] += B_new * s_p;
            Bw[i][r] = B_new;
          }
          A[i][r] = A_new;
        }
      }
      tp::exchange(p.peers, l, rank, grp, e);
      // the group's gathered D rows, [j][row]
      const ST* in = static_cast<const ST*>(p.peers.slots[rank]) +
                     ((size_t)parity * p.B + row0) * H;
      for (int idx = threadIdx.x; idx < BT * H; idx += blockDim.x) {
        const int r = idx / H;
        const int j = idx - r * H;
        left[j * BT + r] = row0 + r < p.B ? tp::wire_load(in + idx) : 0.f;
      }
#pragma unroll
      for (int i = 0; i < NPT; ++i) {
#pragma unroll
        for (int r = 0; r < BT; ++r) R[i][r] = 0.f;
      }
      // R[b][i] = sum_j D_full[b][j] * V[rank*Hl + i][j], j ascending
      shard_product<NPT, BT>(vt, left, col, R);
    }

    // the group's initial-state gradients
#pragma unroll
    for (int i = 0; i < NPT; ++i) {
#pragma unroll
      for (int r = 0; r < BT; ++r) {
        if (!rowlive[r]) continue;
        const size_t at = (size_t)(row0 + r) * ld + col0 + col[i];
        float du0 = al[i] * A[i][r];
        float ds0 = -(al[i] * A[i][r]);
        ds0 += R[i][r];
        if (ADAPTIVE) {
          du0 += aa[i] * Bw[i][r];
          ds0 += bb[i] * Bw[i][r];
          p.dw0[at] = be[i] * Bw[i][r];
          dbe[i] += p.w0[at] * Pq[i][r];
        }
        p.du0[at] = du0;
        p.ds0[at] = ds0;
      }
    }
  }

  float* part = p.partials + ((size_t)local * l.per_rank + blk) * kVecs * Hl;
#pragma unroll
  for (int i = 0; i < NPT; ++i) {
    part[0 * Hl + col[i]] = dal[i];
    part[1 * Hl + col[i]] = dbe[i];
    part[2 * Hl + col[i]] = daa[i];
    part[3 * Hl + col[i]] = dbb[i];
  }
}

// out[q][col] = sum over the rank's blocks, ascending, of its partials; the
// dalpha row (q = 0) is divided by 1 - alpha, hoisted out of the time loop.
__global__ void tp_vec_reduce_kernel(const float* __restrict__ partials,
                                     const float* __restrict__ alpha,
                                     float* __restrict__ out, int per_rank,
                                     int Hl, int n_cols) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= kVecs * n_cols) return;
  const int q = idx / n_cols;
  const int col = idx - q * n_cols;
  const int local = col / Hl;
  const int c = col - local * Hl;
  float sum = 0.f;
  for (int k = 0; k < per_rank; ++k) {
    sum += partials[(((size_t)local * per_rank + k) * kVecs + q) * Hl + c];
  }
  if (q == 0) sum = sum / (1.0f - alpha[col]);
  out[idx] = sum;
}

template <bool A, int NPT, int BT, bool BF>
void try_plan(const BwdArgs& p, tp::Plan& best, bool& all_fit) {
  if constexpr (NPT * BT <= kMaxWork) {
    const size_t smem = (((size_t)p.H * BT + 3) & ~(size_t)3) * sizeof(float) +
                        (size_t)kStages * kTileBytes;
    tp::try_plan(tp_cell_bwd_kernel<A, NPT, BT, BF>, BT, p.Hl / NPT, smem,
                 (p.B + BT - 1) / BT, p.lay.n_local, best, all_fit);
  }
}

template <bool A, int NPT, bool BF>
int launch_npt(BwdArgs& p, int* plan, cudaStream_t st) {
  tp::Plan best{0, 0, 0, 0};
  bool all_fit = false;
  try_plan<A, NPT, 1, BF>(p, best, all_fit);
  try_plan<A, NPT, 2, BF>(p, best, all_fit);
  try_plan<A, NPT, 4, BF>(p, best, all_fit);
  try_plan<A, NPT, 8, BF>(p, best, all_fit);
  if (best.bt == 0) return (int)cudaErrorCooperativeLaunchTooLarge;
  p.lay.per_rank = best.per_rank;
  p.lay.n_groups = (p.B + best.bt - 1) / best.bt;
  if (plan) {
    plan[0] = best.bt;
    plan[1] = best.per_rank;
    plan[2] = best.per_sm;
    plan[3] = p.Hl / NPT;
  }
  const int blocks = p.lay.n_local * best.per_rank;
  const int threads = p.Hl / NPT;
  cudaError_t err = cudaErrorInvalidValue;
  switch (best.bt) {
    case 1:
      err = tp::launch_cooperative(tp_cell_bwd_kernel<A, NPT, 1, BF>,
                                   blocks, threads, best.smem, p, st);
      break;
    case 2:
      err = tp::launch_cooperative(tp_cell_bwd_kernel<A, NPT, 2, BF>,
                                   blocks, threads, best.smem, p, st);
      break;
    case 4:
      err = tp::launch_cooperative(tp_cell_bwd_kernel<A, NPT, 4, BF>,
                                   blocks, threads, best.smem, p, st);
      break;
    default:
      if constexpr (NPT * 8 <= kMaxWork) {
        err = tp::launch_cooperative(tp_cell_bwd_kernel<A, NPT, 8, BF>,
                                     blocks, threads, best.smem, p, st);
      }
      break;
  }
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

template <bool A, bool BF>
int launch_adaptive(BwdArgs& p, int npt, int* plan, cudaStream_t st) {
  switch (npt) {
    case 1: return launch_npt<A, 1, BF>(p, plan, st);
    case 2: return launch_npt<A, 2, BF>(p, plan, st);
    default: return launch_npt<A, 4, BF>(p, plan, st);
  }
}

template <bool BF>
int launch_form(BwdArgs& p, bool adaptive, int npt, int* plan,
                cudaStream_t st) {
  return adaptive ? launch_adaptive<true, BF>(p, npt, plan, st)
                  : launch_adaptive<false, BF>(p, npt, plan, st);
}

}  // namespace

// slots/flags: host arrays of P device pointers, every rank's D slots
// ([2][B][H] elements) and zeroed counters ([P][B][2] u32). partials holds
// n_local*B*4*(H/P) floats, vecs (4, n_local*H/P) receives dalpha, dbeta,
// da, db; dV (H, H) and dv_partials (ksplit, H, H) the dV product. bf16
// selects the bf16-stream mode (g, VT, dwx and the slots bf16).
extern "C" int sparch_tp_cell_bwd(
    const void* g, const float* u_seq, const float* alpha, const float* beta,
    const float* a, const float* b, const void* VT, const float* u0,
    const float* w0, const float* s0f, void* dwx, float* partials,
    float* vecs, float* dV, float* dv_partials, float* du0, float* dw0,
    float* ds0, void* const* slots, unsigned* const* flags, int B, int T,
    int H, int P, int rank0, int n_local, int ld, float threshold,
    int adaptive, int ksplit, int bf16, int* plan, void* stream) {
  if (B <= 0 || T <= 0 || P < 1 || P > tp::kMaxRanks || H <= 0 ||
      H % (P * 128) != 0 || H / P > kThreads * kMaxNpt || rank0 != 0 ||
      n_local != P || ld != H || ksplit < 1 || !g || !u_seq || !alpha ||
      !VT || !u0 || !s0f || !dwx || !partials || !vecs || !dV ||
      !dv_partials || !du0 || !ds0 ||
      (adaptive && (!beta || !a || !b || !w0 || !dw0))) {
    return (int)cudaErrorInvalidValue;
  }
  BwdArgs p{};
  if (!tp::make_peers(slots, flags, P, &p.peers)) {
    return (int)cudaErrorInvalidValue;
  }
  p.g = g;
  p.u_seq = u_seq;
  p.alpha = alpha;
  p.beta = beta;
  p.a = a;
  p.b = b;
  p.VT = VT;
  p.u0 = u0;
  p.w0 = w0;
  p.s0f = s0f;
  p.dwx = dwx;
  p.partials = partials;
  p.du0 = du0;
  p.dw0 = dw0;
  p.ds0 = ds0;
  p.lay.P = P;
  p.lay.rank0 = rank0;
  p.lay.n_local = n_local;
  p.B = B;
  p.T = T;
  p.H = H;
  p.Hl = H / P;
  p.ld = ld;
  p.threshold = threshold;
  int npt = 1;
  while (p.Hl / npt > kThreads) npt *= 2;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err = bf16 ? launch_form<true>(p, adaptive != 0, npt, plan, st)
                 : launch_form<false>(p, adaptive != 0, npt, plan, st);
  if (err != 0) return err;

  const int n_cols = n_local * p.Hl;
  tp_vec_reduce_kernel<<<(kVecs * n_cols + 255) / 256, 256, 0, st>>>(
      partials, alpha, vecs, p.lay.per_rank, p.Hl, n_cols);
  err = (int)cudaGetLastError();
  if (err != 0) return err;

  // dV over the full u series and the ranks' dWx blocks (the gathered D)
  const int R = B * T;
  int rows_per_split = (R + ksplit - 1) / ksplit;
  rows_per_split = (rows_per_split + kBK - 1) / kBK * kBK;
  const int tiles = (H + kTile - 1) / kTile;
  const dim3 grid(tiles, tiles, ksplit);
  if (bf16) {
    dv_kernel<__nv_bfloat16><<<grid, kDvThreads, 0, st>>>(
        u_seq, s0f, static_cast<const __nv_bfloat16*>(dwx), dv_partials, T,
        H, R, rows_per_split, threshold);
  } else {
    dv_kernel<float><<<grid, kDvThreads, 0, st>>>(
        u_seq, s0f, static_cast<const float*>(dwx), dv_partials, T, H, R,
        rows_per_split, threshold);
  }
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  sum_parts_kernel<<<(H * H + 255) / 256, 256, 0, st>>>(dv_partials, dV,
                                                        ksplit, H * H);
  return (int)cudaGetLastError();
}
