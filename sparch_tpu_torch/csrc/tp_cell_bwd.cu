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
// Design: thread-block clusters per rank (tp_ann.cuh on cluster_slice.cuh,
// as tp_ann_bwd.cu). A cluster of C blocks, one per SM, owns R batch rows
// (a row group) of one rank; block k owns the rank's neurons k*Hs ..
// k*Hs+Hs-1 and the (H, Hs) slice of the rank's block of V^T (the rows of
// V for its neurons), resident in shared memory where it fits beside the
// operands, else streamed from L2 once per cluster and step. Thread tx owns
// neuron k*Hs + tx for all R rows of the group (R = 8, or 4, 2, 1 where two
// parities of R gathered rows of H floats would pass 128 KB), with A, B, P,
// R and the carried u in registers. Each step the thread puts its D rows
// into the operand of every block of its cluster (distributed shared
// memory) and, where P > 1, into every rank's slot; the cluster crosses
// one barrier, block 0 publishes for the cluster, every block waits on the
// peers and copies their columns from its slot (tp_ann.cuh exchange); then
// each thread sums its column over j = 0 .. H-1 in ascending order with
// fmaf, as the kernel before the cluster split (one block for whole rows,
// the rank's V^T block streamed per block and step) did, so D, dWx, du0,
// dw0, ds0 and dV are its bits and the single-card kernel's, at every P.
// All P ranks run in one cooperative cluster launch; the wrapper chooses
// the cluster size from cudaOccupancyMaxActiveClusters (ops/fused_tp.py
// `_bwd_plan`: the fewest warps a block times walks), and a rank walks its
// row groups where the card holds fewer clusters than it has groups.
// Reductions in a fixed order, no atomics, so two runs give the same bits:
// each thread sums dalpha, dbeta, da and db of its neuron over all T and
// the rows of a partial, steps from the last and rows ascending within a
// step, and a second kernel adds the partials of a rank in ascending
// order. A partial has the rows of a block of the kernel before the split
// (part_rows, chosen by the wrapper), so these gradients keep its bits
// wherever its blocks held every row group at once.
//
// C interface, bound with ctypes: sparch_tp_cell_bwd checks the plan it is
// given (cluster, rows, resident, part_rows) against its own at that
// cluster size, enqueues the kernels on the stream, returns the first
// launch error (or an invalid-value error for arguments it does not take)
// and never synchronises, unless it is given split_ms: then it records
// CUDA events around each launch, waits for them and writes the
// milliseconds of the time loop, the dV product (the sum of its splits
// included) and the second passes there. `plan` (host memory, may be null) receives the time loop's plan
// (tp_ann::report).

#include <cuda_runtime.h>
#include <stdint.h>

#include "dv_product.cuh"
#include "tp_ann.cuh"

namespace {

using namespace sparch;
using sparch::tp_ann::RowsSite;

constexpr int kMaxHl = 2048;  // neurons of a rank
constexpr int kVecs = 4;      // dalpha, dbeta, da, db
// two parities of a cluster's gathered rows take at most this
constexpr long kOperandBytes = 131072;

// g, VT, dwx and the slots are float, or bf16 in the bf16 mode.
struct BwdArgs {
  const void* g;       // (B, T, ld)
  const float* u_seq;  // (B, T, ld)
  const float* alpha;  // (ld,)
  const float* beta;
  const float* a;
  const float* b;
  const void* VT;      // the packed slices of the ranks' blocks of V^T
  const float* u0;     // (B, ld)
  const float* w0;
  const float* s0f;    // (B, H): the gathered initial spikes
  void* dwx;           // (B, T, ld)
  float* partials;     // [n_local][n_parts][kVecs][Hl]
  float* du0;          // (B, ld)
  float* dw0;
  float* ds0;
  tp::Peers peers;     // slots: per rank [2][B][H] elements
  tp::Layout lay;
  int B, T, H, Hl, ld;
  float threshold;
  int n_parts;
  slice::Plan plan;
};

// RT: the rows of a cluster, all owned by each thread; PR: the rows of a
// partial of the parameter gradients.
template <bool ADAPTIVE, bool BF, int RT, int PR>
__global__ void __launch_bounds__(slice::kMaxThreads, 1)
tp_cell_bwd_kernel(const __grid_constant__ BwdArgs p) {
  using ST = typename Elem<BF>::type;  // g, dWx, V^T, wire
  constexpr int NS = RT / PR;          // partials a thread sums
  // two parities of the [j][row] operand (RT*H floats each), then the
  // resident slice or the stream's stages
  extern __shared__ __align__(16) float smem[];
  __shared__ uint64_t full[kStages];
  const slice::Plan& pl = p.plan;
  const tp::Layout& l = p.lay;
  const int H = p.H, T = p.T, Hl = p.Hl, ld = p.ld, Hs = pl.cols;
  const int CL = pl.cluster;
  const int k = (int)(blockIdx.x % CL);
  const int cl = (int)(blockIdx.x / CL);
  const int local = cl / l.per_rank;
  const int first = cl % l.per_rank;
  const size_t RH = (size_t)RT * H;
  const float thr = p.threshold;

  const int tx = threadIdx.x % Hs;
  const int col = k * Hs + tx;  // the rank's neuron
  const bool live = (int)threadIdx.x < Hs && col < Hl;
  const int rank = l.rank0 + local;
  const int gc = local * Hl + (live ? col : 0);  // its column of a stream
  RowsSite<RT> x;
  x.peers = &p.peers;
  x.lay = &l;
  x.rank = rank;
  x.gcol = rank * Hl + col;
  x.B = p.B;
  x.Hg = H;
  x.Hl = Hl;
  x.W = H;
  x.R = RT;
  x.C = CL;
  x.live = live;

  const int gates[2] = {1, 0};
  const int walks = (l.n_groups - first + l.per_rank - 1) / l.per_rank;
  slice::Stream<ST> s = slice::open_stream(
      static_cast<const ST*>(p.VT) + ((size_t)local * CL + k) * H * Hs,
      reinterpret_cast<ST*>(smem + 2 * RH), full, pl, H, Hs, gates,
      walks * T);
  slice::begin(s);
  const ST* g_in = static_cast<const ST*>(p.g);
  ST* dwx_out = static_cast<ST*>(p.dwx);
  const float al = p.alpha[gc];
  const float oma = 1.0f - al;
  const float be = ADAPTIVE ? p.beta[gc] : 0.f;
  const float aa = ADAPTIVE ? p.a[gc] : 0.f;
  const float bb = ADAPTIVE ? p.b[gc] : 0.f;

  for (int w = 0; w < walks; ++w) {
    x.group = first + w * l.per_rank;
    x.row_base = x.group * RT;
    x.row0 = x.row_base;
    const int row0 = x.row0;
    float dal[NS], dbe[NS], daa[NS], dbb[NS];
#pragma unroll
    for (int q = 0; q < NS; ++q) dal[q] = dbe[q] = daa[q] = dbb[q] = 0.f;
    float A[RT], Bw[RT], Pq[RT], R[RT], up[RT];
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      x.rowlive[r] = row0 + r < p.B;
      A[r] = Bw[r] = Pq[r] = R[r] = 0.f;
      // u_t of the first step walked, carried as the next one's u_t
      up[r] = live && x.rowlive[r]
                  ? p.u_seq[((size_t)(row0 + r) * T + (T - 1)) * ld + gc]
                  : 0.f;
    }
    // every block of the cluster runs, and is done with the group before,
    // before any stores into it
    slice::cluster_barrier();
    if (w == 0) slice::await_resident(s);

    for (int t = T - 1; t >= 0; --t) {
      const int e = T - 1 - t;  // exchange index
      float dd_r[RT];
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        const bool ok = live && x.rowlive[r];
        const size_t row = (size_t)(row0 + r);
        const size_t at = (row * T + t) * ld + gc;
        const float g_t = ok ? to_float(g_in[at]) : 0.f;
        const float u_t = up[r];
        float u_p = 0.f, s_p = 0.f;
        if (ok) {
          if (t > 0) {
            u_p = p.u_seq[at - ld];
            s_p = u_p > thr ? 1.f : 0.f;
          } else {
            u_p = p.u0[row * ld + gc];
            s_p = p.s0f[row * H + rank * Hl + col];
          }
        }
        up[r] = u_p;
        const float alphaA = al * A[r];
        float C = g_t - alphaA;
        C += R[r];
        if (ADAPTIVE) C += bb * Bw[r];
        const float wsub = u_t - thr;
        const bool window = ok && wsub > -0.5f && wsub <= 0.5f;
        float A_new = (window ? C : 0.f) + alphaA;
        if (ADAPTIVE) A_new += aa * Bw[r];
        const float dd = oma * A_new;
        if (ok) dwx_out[at] = from_float<ST>(dd);
        dd_r[r] = dd;
        dal[r / PR] += A_new * (u_p - s_p - u_t);
        if (ADAPTIVE) {
          const float B_new = be * Bw[r] - dd;
          dbe[r / PR] += (aa * u_p + bb * s_p) * Pq[r];
          Pq[r] = B_new + be * Pq[r];
          daa[r / PR] += B_new * u_p;
          dbb[r / PR] += B_new * s_p;
          Bw[r] = B_new;
        }
        A[r] = A_new;
      }
      // D into every block's operand and every rank's slot (rounded as the
      // wire rounds), gathered; then R[b][i] = sum_j D_full[b][j] *
      // V[rank*Hl + i][j], j ascending
      float* op = smem + (size_t)(e & 1) * RH;
      tp_ann::put<BF, ST>(x, op, 0, e, dd_r);
      tp_ann::exchange<ST>(x, op, 1, e);
      float acc[1][RT] = {};
      slice::pass<1, true>(s, 0, op, 0, RT, tx, Hs, acc);
#pragma unroll
      for (int r = 0; r < RT; ++r) R[r] = acc[0][r];
    }

    if (!live) continue;
    // the group's initial-state gradients and the thread's partials
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      if (!x.rowlive[r]) continue;
      const size_t at = (size_t)(row0 + r) * ld + gc;
      float du0 = al * A[r];
      float ds0 = -(al * A[r]);
      ds0 += R[r];
      if (ADAPTIVE) {
        du0 += aa * Bw[r];
        ds0 += bb * Bw[r];
        p.dw0[at] = be * Bw[r];
        dbe[r / PR] += p.w0[at] * Pq[r];
      }
      p.du0[at] = du0;
      p.ds0[at] = ds0;
    }
#pragma unroll
    for (int q = 0; q < NS; ++q) {
      const int part_i = row0 / PR + q;
      if (part_i >= p.n_parts) break;
      float* part =
          p.partials + ((size_t)local * p.n_parts + part_i) * kVecs * Hl;
      part[0 * Hl + col] = dal[q];
      part[1 * Hl + col] = dbe[q];
      part[2 * Hl + col] = daa[q];
      part[3 * Hl + col] = dbb[q];
    }
  }
}

// out[q][col] = sum over the rank's partials, ascending; the dalpha row
// (q = 0) is divided by 1 - alpha, hoisted out of the time loop.
__global__ void tp_vec_reduce_kernel(const float* __restrict__ partials,
                                     const float* __restrict__ alpha,
                                     float* __restrict__ out, int n_parts,
                                     int Hl, int n_cols) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= kVecs * n_cols) return;
  const int q = idx / n_cols;
  const int col = idx - q * n_cols;
  const int local = col / Hl;
  const int c = col - local * Hl;
  float sum = 0.f;
  for (int k = 0; k < n_parts; ++k) {
    sum += partials[(((size_t)local * n_parts + k) * kVecs + q) * Hl + c];
  }
  if (q == 0) sum = sum / (1.0f - alpha[col]);
  out[idx] = sum;
}

using Kernel = void (*)(BwdArgs);

template <bool A, bool BF, int RT>
Kernel kernel_rows(int part_rows) {
  if constexpr (RT >= 8) {
    if (part_rows == 8) return tp_cell_bwd_kernel<A, BF, RT, 8>;
  }
  if constexpr (RT >= 4) {
    if (part_rows == 4) return tp_cell_bwd_kernel<A, BF, RT, 4>;
  }
  if constexpr (RT >= 2) {
    if (part_rows == 2) return tp_cell_bwd_kernel<A, BF, RT, 2>;
  }
  return tp_cell_bwd_kernel<A, BF, RT, 1>;
}

template <bool A, bool BF>
Kernel kernel_mode(int rows, int part_rows) {
  switch (rows) {
    case 8: return kernel_rows<A, BF, 8>(part_rows);
    case 4: return kernel_rows<A, BF, 4>(part_rows);
    case 2: return kernel_rows<A, BF, 2>(part_rows);
    default: return kernel_rows<A, BF, 1>(part_rows);
  }
}

// The instantiation a launch takes.
Kernel kernel_for(int adaptive, int bf16, int rows, int part_rows) {
  if (adaptive) {
    return bf16 ? kernel_mode<true, true>(rows, part_rows)
                : kernel_mode<true, false>(rows, part_rows);
  }
  return bf16 ? kernel_mode<false, true>(rows, part_rows)
              : kernel_mode<false, false>(rows, part_rows);
}

// One rank's time-loop plan at `cluster` blocks (ops/fused_tp.py
// `_bwd_rank_plan` computes the same): cluster_slice.cuh's rule for one
// matrix and one operand plane with the rank's Hl neurons split over the
// cluster, the most rows of 8, 4, 2, 1 whose two operand parities take at
// most kOperandBytes, and one thread a column (it owns every row).
slice::Plan cell_plan(int B, int H, int P, int cluster, int bf16) {
  int rows = 8;
  while (rows > 1 && 2L * rows * H * (long)sizeof(float) > kOperandBytes) {
    rows /= 2;
  }
  slice::Plan pl =
      slice::make_plan(B, H, 1, bf16 ? 2 : 4, 1, H / P, cluster, rows);
  pl.threads = (pl.cols + 31) / 32 * 32;
  return pl;
}

bool shape_ok(int B, int H, int P, int cluster) {
  return B > 0 && P >= 1 && P <= tp::kMaxRanks && H > 0 &&
         H % (P * 128) == 0 && H / P <= kMaxHl && cluster >= 1 &&
         cluster <= slice::kMaxCluster;
}

}  // namespace

// slots/flags: host arrays of P device pointers, every rank's D slots
// ([2][B][H] elements) and zeroed counters ([P][groups][2] u32). partials
// holds n_local*n_parts*4*(H/P) floats (n_parts = B / part_rows, rounded
// up), vecs (4, n_local*H/P) receives dalpha, dbeta, da, db; dV (H, H) and
// dv_partials (ksplit, H, H; unused and may be null at ksplit 1) the dV
// product, in the tile dv_tile (dv_product.cuh `dv_tile`). VT: every
// block's slice of
// every rank's block of V^T (ops/fused_tp_ann.py `_pack_slices`). bf16
// selects the bf16-stream mode (g, VT, dwx and the slots bf16). cluster,
// rows, resident: the plan the wrapper packed VT for; part_rows: the rows
// of a partial (1, 2, 4 or 8, dividing rows). split_ms: null, or three
// floats of host memory (see above).
extern "C" int sparch_tp_cell_bwd(
    const void* g, const float* u_seq, const float* alpha, const float* beta,
    const float* a, const float* b, const void* VT, const float* u0,
    const float* w0, const float* s0f, void* dwx, float* partials,
    float* vecs, float* dV, float* dv_partials, float* du0, float* dw0,
    float* ds0, void* const* slots, unsigned* const* flags, int B, int T,
    int H, int P, int rank0, int n_local, int ld, float threshold,
    int adaptive, int ksplit, int dv_tile, int bf16, int cluster, int rows,
    int resident, int part_rows, float* split_ms, int* plan, void* stream) {
  if (!shape_ok(B, H, P, cluster) || T <= 0 || rank0 != 0 || n_local != P ||
      ld != H || ksplit < 1 || !g || !u_seq || !alpha || !VT || !u0 ||
      !s0f || !dwx || !partials || !vecs || !dV ||
      (ksplit > 1 && !dv_partials) || !du0 ||
      !ds0 || (adaptive && (!beta || !a || !b || !w0 || !dw0)) ||
      !dv_tile_ok(dv_tile, H, 1, ksplit) ||
      (part_rows != 1 && part_rows != 2 && part_rows != 4 &&
       part_rows != 8)) {
    return (int)cudaErrorInvalidValue;
  }
  const slice::Plan pl = cell_plan(B, H, P, cluster, bf16);
  if (rows != pl.rows || resident != pl.resident || pl.rows % part_rows ||
      !tp_ann::runs(pl, 1, bf16)) {
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
  p.B = B;
  p.T = T;
  p.H = H;
  p.Hl = H / P;
  p.ld = ld;
  p.threshold = threshold;
  p.n_parts = (B + part_rows - 1) / part_rows;
  p.plan = pl;
  const Kernel kernel = kernel_for(adaptive, bf16, pl.rows, part_rows);
  int max = 0;
  const int per_rank = tp_ann::clusters_per_rank(kernel, pl, n_local, &max);
  if (max < 0) {
    const cudaError_t err = cudaGetLastError();
    return err != cudaSuccess ? (int)err : (int)cudaErrorInvalidConfiguration;
  }
  if (per_rank == 0) return (int)cudaErrorCooperativeLaunchTooLarge;
  p.lay = tp::Layout{P, rank0, n_local, per_rank, pl.clusters};
  tp_ann::report(plan, pl, per_rank, max);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Split split(split_ms != nullptr);
  split.mark(0, st);
  int err = (int)tp_ann::launch(kernel, pl, n_local * per_rank, p, st);
  if (err == 0) err = (int)cudaGetLastError();
  if (err != 0) return err;
  split.mark(1, st);

  // dV over the full u series and the ranks' dWx blocks (the gathered D)
  err = (int)(bf16 ? launch_spike_dv(u_seq, s0f,
                                     static_cast<const __nv_bfloat16*>(dwx),
                                     threshold, dV, dv_partials, T, H, B * T,
                                     dv_tile, ksplit, st)
                   : launch_spike_dv(u_seq, s0f,
                                     static_cast<const float*>(dwx),
                                     threshold, dV, dv_partials, T, H, B * T,
                                     dv_tile, ksplit, st));
  if (err != 0) return err;
  split.mark(2, st);

  const int n_cols = n_local * p.Hl;
  tp_vec_reduce_kernel<<<(kVecs * n_cols + 255) / 256, 256, 0, st>>>(
      partials, alpha, vecs, p.n_parts, p.Hl, n_cols);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  split.mark(3, st);
  split.report(split_ms, 3);
  return (int)cudaGetLastError();
}

// How many clusters of the time loop's plan at `cluster` blocks the card
// holds at once (cudaOccupancyMaxActiveClusters) for the instantiation of
// (adaptive, bf16, part_rows); -1 where the plan does not run or the query
// fails.
extern "C" int sparch_tp_cell_bwd_max_clusters(int B, int H, int P,
                                               int adaptive, int bf16,
                                               int cluster, int part_rows) {
  if (!shape_ok(B, H, P, cluster)) return -1;
  const slice::Plan pl = cell_plan(B, H, P, cluster, bf16);
  if (!tp_ann::runs(pl, 1, bf16) || pl.rows % part_rows) return -1;
  return slice::max_active_clusters(
      kernel_for(adaptive, bf16, pl.rows, part_rows), pl);
}
