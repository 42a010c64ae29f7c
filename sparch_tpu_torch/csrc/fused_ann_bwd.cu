// Fused non-spiking recurrent cell, backward, for Hopper (sm_90a):
// reverse-time BPTT of the sigmoid RNN, the LiGRU and the GRU in one
// template, with the per-gate batchnorm affine and the output dropout of
// the forward.
//
// Replaces: sparch_tpu/ops/pallas_ann.py `_ann_bwd_kernel`, the TPU kernel
// behind the VJP of rnn/ligru/gru_pallas, in two stream modes (BF):
// float32 streams, and the TPU kernel's mxu_bf16 mode. In that mode g, the
// residual series (raw y, z, r, c) and the per-gate dWx are bf16 streams,
// the packed transposed matrices are bf16, each raw input stream (read with
// the affine) is float32 or bf16 as the forward got it, every dpre is
// rounded to bf16 where it enters a product (the adjoint product and dV, so
// the scratch series the dV kernel reads are bf16), the dV products' left
// operands are rounded too (y0 and r*y_p; a stored y is bf16 already), and
// dWx = bf16(dpre*scale); dscale and dshift (from the float32 dpre), dV and
// dy0 stay float32 in their fixed order.
//
// With G_t the total adjoint of y_t (the output cotangent, masked and
// scaled like the forward's output under dropout, plus what step t+1
// carries back) and y_p = y_{t-1} (y0 at the first step), walking
// t = T..1 (gate 0 is the candidate with V, gate 1 the update z with Vz,
// gate 2 the reset r with Vr):
//   RNN:   dpre  = G*y_t*(1-y_t)
//          G_{t-1} += dpre @ V^T
//   LiGRU: dcpre = c > 0 ? G*(1-z) : 0 ;  dzpre = G*(y_p-c)*z*(1-z)
//          G_{t-1} += G*z + dcpre @ V^T + dzpre @ Vz^T
//   GRU:   dcpre = G*(1-z)*(1-c^2) ;  dzpre = G*(y_p-c)*z*(1-z)
//          dry   = dcpre @ V^T ;  drpre = dry*y_p*r*(1-r)
//          G_{t-1} += G*z + dry*r + dzpre @ Vz^T + drpre @ Vr^T
//   per gate: dWx_t = dpre*scale ; dscale = sum dpre*wx ; dshift = sum dpre
//             dV = sum y_p^T dpre   (the GRU's candidate: (r*y_p)^T dcpre)
//   dy0 = G_0
// It reads the residual series of the forward (the raw y, z[, r], c) and
// regenerates the dropout mask from the seed.
//
// What bounds it on this card: as in the forward, the dense products on
// the chain, one adjoint product per gate and step against a V^T that fits
// no SM, two of the GRU's three dependent (dcpre @ V^T -> drpre ->
// drpre @ Vr^T); then the dV outer products, 2*B*T*H*H FLOP per gate. At
// (128, 100, 512) the GRU does 40 GFLOP (0.60 ms at the float32 peak
// outside the tensor cores) on 290 MB of streams (87 us at HBM rate):
// operations bound it.
//
// Design:
// - Time loop: that of fused_ann_fwd.cu in reverse (cluster_slice.cuh). A
//   cluster of C blocks owns R batch rows for all T, block k the column
//   slice k*Hs .. k*Hs+Hs-1 of V^T, Vz^T, Vr^T (the rows of V: the adjoint
//   of its neurons), thread (tx, ty) neuron k*Hs + tx for four of the rows
//   with the carried adjoint in registers. A step exchanges each gate's
//   dpre through distributed shared memory and runs its adjoint products
//   in passes: RNN dpre on parity s & 1 (s = T-1-t), then V^T; LiGRU
//   [dcpre | dzpre] on parity s & 1, then [V^T | Vz^T]; GRU [dcpre |
//   dzpre] on parity 0, then [V^T | Vz^T] (dry and the z term), drpre on
//   parity 1, then Vr^T. Each column is summed over all H rows in
//   ascending order with FMAs, so dWx, dy0 and the carried adjoint are
//   those of the kernel this design replaced (one block for whole rows)
//   and of tp_ann_bwd.cu without the affine and the dropout, bit for bit.
//   The slice stays in shared memory where it fits, else it streams from
//   L2 once per cluster and step.
// - Reductions are in a fixed order, so two runs give the same bits, and
//   use no atomics. dscale and dshift: each thread sums its neuron over
//   each pair of its rows (PAIR: H <= 512) or each row, steps from the last
//   and rows ascending within a step, in registers, and writes
//   partials[part][2*gates][H]; a second kernel adds the parts in ascending
//   order. These are the sums of the kernel before the cluster split (one
//   block for two rows, or one row, of every step), so dscale and dshift
//   keep their bits too, and a training run its trajectory.
//   dV: a product kernel after the time loop, per gate one (H, B*T) x (B*T,
//   H) product of the y series shifted by one step (times r for the GRU's
//   candidate) with the stored dpre series (dWx itself without the affine,
//   else a scratch series written beside it, since dWx is then
//   dpre*scale), tiled by the plan `dv_tile`; where B*T is split, the same
//   second kernel adds the splits in ascending order (dv_product.cuh,
//   shared with the other backwards).
// - Edges are masked: rows >= B and neurons >= H load nothing, hold zero
//   adjoints and store nothing.
//
// C interface, bound with ctypes: sparch_fused_ann_bwd checks the plan it
// is given (ops/fused_ann.py `_bwd_plan`: the time loop's cluster, rows
// and resident slice, n_parts and ksplit, which size the caller's
// partials buffers, and the dV product's tile) against its own, enqueues all the kernels on the
// stream, returns the first launch error (or an invalid-value error for
// arguments it does not take) and never synchronises, unless it is given
// split_ms: then it records CUDA events around each launch, waits for them
// and writes the milliseconds of the time loop, the dV product (the sum
// of its splits included) and the second passes there.

#include <cuda_runtime.h>
#include <stdint.h>

#include "cluster_slice.cuh"
#include "dropout_hash.cuh"
#include "dv_product.cuh"

namespace {

using namespace sparch;
using slice::kRt;

constexpr int kMaxH = 2048;
constexpr int kPairH = 512;  // dscale/dshift partials of two rows up to here
constexpr int kRnn = 0, kLigru = 1, kGru = 2;

struct Args {
  const void* g;       // g and the residual series: float, bf16 in bf16 mode
  const void* wx[3];   // the raw input streams, read only with the affine;
                       // float, or bf16 where wx_bf16 (bf16 mode only)
  const void* y_seq;
  const void* z;
  const void* r;
  const void* c;
  const float* scale;  // (gates, H), or null for no affine
  const void* VT;      // the packed slices of the transposed matrices
  const float* y0;
  const int* seed;     // null for no dropout
  void* dwx[3];        // float, bf16 in the bf16 mode, like dd
  void* dd[3];         // dpre before the scale, written only with the affine
  float* partials;
  float* dy0;
  int B;
  int T;
  int H;
  uint32_t keep_u32;
  float inv_keep;
  DropRows drop;
  int wx_bf16;         // the input streams are bf16, not float
  int n_parts;         // partials of dscale/dshift
  slice::Plan plan;
};

template <int MODE, bool BF, bool PAIR>
__global__ void __launch_bounds__(slice::kMaxThreads, 1)
fused_ann_bwd_kernel(const Args p) {
  using ST = typename Elem<BF>::type;
  constexpr int G = MODE + 1;
  constexpr int PR = PAIR ? 2 : 1;          // rows of a dscale partial
  constexpr int NS = kRt / PR;              // partials a thread sums
  constexpr int NA = MODE == kRnn ? 1 : 2;      // gates of the first pass
  constexpr int PL = MODE == kRnn ? 1 : 2;      // operands of a parity
  // two parities of PL [j][row] operands (R*H floats each), then the
  // resident slice or the stream's stages
  extern __shared__ __align__(16) float smem[];
  __shared__ uint64_t full[kStages];
  const slice::Plan& pl = p.plan;
  const int H = p.H, T = p.T, R = pl.rows, Hs = pl.cols, C = pl.cluster;
  const int k = (int)(blockIdx.x % C);
  const int cluster = (int)(blockIdx.x / C);
  const int row_base = cluster * R;
  const size_t RH = (size_t)R * H;

  const int tx = threadIdx.x % Hs;
  const int ty_raw = threadIdx.x / Hs;
  const bool thread_live = ty_raw < R / kRt;
  const int ry0 = thread_live ? ty_raw * kRt : 0;
  const int row0 = row_base + ry0;
  const int col = k * Hs + tx;
  const bool live = thread_live && col < H;
  const bool affine = p.scale != nullptr;
  const bool dropout = p.seed != nullptr;
  const bool wx_bf16 = BF && p.wx_bf16;

  const int gates[2] = {NA, MODE == kGru ? 1 : 0};
  slice::Stream<ST> s = slice::open_stream(
      static_cast<const ST*>(p.VT) + (size_t)k * G * H * Hs,
      reinterpret_cast<ST*>(smem + 2 * PL * RH), full, pl, H, Hs, gates, T);
  slice::begin(s);
  const ST* g_in = static_cast<const ST*>(p.g);
  const ST* y_seq = static_cast<const ST*>(p.y_seq);
  const ST* z_in = static_cast<const ST*>(p.z);
  const ST* r_in = static_cast<const ST*>(p.r);
  const ST* c_in = static_cast<const ST*>(p.c);

  float sc[G], dsc[G][NS], dsh[G][NS];
  float D[kRt];
  bool rowlive[kRt];
  uint32_t drop_base[kRt];
#pragma unroll
  for (int r = 0; r < kRt; ++r) {
    rowlive[r] = thread_live && row0 + r < p.B;
    drop_base[r] = (dropout && rowlive[r])
                       ? dropout_row_base(p.seed, row0 + r, p.drop)
                       : 0u;
    D[r] = 0.f;
  }
  const int c0 = live ? col : 0;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    sc[g] = affine ? p.scale[g * H + c0] : 1.f;
#pragma unroll
    for (int q = 0; q < NS; ++q) dsc[g][q] = dsh[g][q] = 0.f;
  }
  // every block of the cluster runs before any stores into it
  slice::cluster_barrier();
  slice::await_resident(s);

  for (int t = T - 1; t >= 0; --t) {
    const int par = (T - 1 - t) & 1;
    float Gt[kRt], yp[kRt], z[kRt], rr[kRt], c[kRt];
    float dpre[G][kRt];
#pragma unroll
    for (int r = 0; r < kRt; ++r) {
      const bool ok = live && rowlive[r];
      const size_t row = (size_t)(row0 + r);
      const size_t at = (row * T + t) * H + col;
      float g_t = ok ? to_float(g_in[at]) : 0.f;
      if (dropout) {
        g_t = dropout_keep(drop_base[r], col, t, p.keep_u32)
                  ? g_t * p.inv_keep
                  : 0.f;
      }
      Gt[r] = g_t + D[r];
      if constexpr (MODE == kRnn) {
        const float y_t = ok ? to_float(y_seq[at]) : 0.f;
        dpre[0][r] = Gt[r] * y_t * (1.0f - y_t);
      } else {
        yp[r] = !ok ? 0.f
                    : (t > 0 ? to_float(y_seq[at - H]) : p.y0[row * H + col]);
        z[r] = ok ? to_float(z_in[at]) : 0.f;
        c[r] = ok ? to_float(c_in[at]) : 0.f;
        const float omz = 1.0f - z[r];
        dpre[1][r] = Gt[r] * (yp[r] - c[r]) * z[r] * omz;
        if constexpr (MODE == kLigru) {
          dpre[0][r] = c[r] > 0.f ? Gt[r] * omz : 0.f;
        } else {
          rr[r] = ok ? to_float(r_in[at]) : 0.f;
          dpre[0][r] = Gt[r] * omz * (1.0f - c[r] * c[r]);
        }
      }
    }
    // the GRU's [dcpre | dzpre] on parity 0, the others' dpre on par
    float* op = smem + (size_t)(MODE == kGru ? 0 : par) * PL * RH;
    if (live) {
      slice::to_cluster<BF>(op, (size_t)col * R + ry0, dpre[0], C);
      if constexpr (MODE != kRnn) {
        slice::to_cluster<BF>(op + RH, (size_t)col * R + ry0, dpre[1], C);
      }
    }
    slice::cluster_barrier();
    float a[NA][kRt];
#pragma unroll
    for (int g = 0; g < NA; ++g) {
#pragma unroll
      for (int r = 0; r < kRt; ++r) a[g][r] = 0.f;
    }
    // dpre_0 @ V^T [, dpre_1 @ Vz^T]
    slice::pass<NA, NA == 1>(s, 0, op + ry0, (int)RH, R, tx, Hs, a);
    float a2[1][kRt] = {};
    if constexpr (MODE == kGru) {
      // a[0] is dry, the adjoint of r*y_p
#pragma unroll
      for (int r = 0; r < kRt; ++r) {
        dpre[2][r] = a[0][r] * yp[r] * rr[r] * (1.0f - rr[r]);
      }
      float* op1 = smem + PL * RH;
      if (live) slice::to_cluster<BF>(op1, (size_t)col * R + ry0, dpre[2], C);
      slice::cluster_barrier();
      slice::pass<1, true>(s, 1, op1 + ry0, 0, R, tx, Hs, a2);  // @ Vr^T
    }
#pragma unroll
    for (int r = 0; r < kRt; ++r) {
      if constexpr (MODE == kRnn) {
        D[r] = a[0][r];
      } else if constexpr (MODE == kLigru) {
        D[r] = Gt[r] * z[r] + a[0][r] + a[1][r];
      } else {
        D[r] = Gt[r] * z[r] + a[0][r] * rr[r] + a[1][r] + a2[0][r];
      }
      const bool ok = live && rowlive[r];
      const size_t at = ((size_t)(row0 + r) * T + t) * H + col;
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float dp = dpre[g][r];
        if (affine) {
          const float wx_t = ok ? load_stream<BF>(p.wx[g], at, wx_bf16) : 0.f;
          dsc[g][r / PR] += dp * wx_t;
          dsh[g][r / PR] += dp;
          if (ok) {
            static_cast<ST*>(p.dwx[g])[at] = from_float<ST>(dp * sc[g]);
            static_cast<ST*>(p.dd[g])[at] = from_float<ST>(dp);
          }
        } else if (ok) {
          static_cast<ST*>(p.dwx[g])[at] = from_float<ST>(dp);
        }
      }
    }
  }

  if (!live) return;
#pragma unroll
  for (int r = 0; r < kRt; ++r) {
    if (rowlive[r]) p.dy0[(size_t)(row0 + r) * H + col] = D[r];
  }
  if (affine) {
#pragma unroll
    for (int q = 0; q < NS; ++q) {
      const int part_i = row0 / PR + q;
      if (part_i >= p.n_parts) break;
      float* part = p.partials + (size_t)part_i * 2 * G * H;
#pragma unroll
      for (int g = 0; g < G; ++g) {
        part[g * H + col] = dsc[g][q];
        part[(G + g) * H + col] = dsh[g][q];
      }
    }
  }
}

using Kernel = void (*)(Args);

template <int MODE>
Kernel kernel_of(int H, int bf16) {
  if (H <= kPairH) {
    return bf16 ? fused_ann_bwd_kernel<MODE, true, true>
                : fused_ann_bwd_kernel<MODE, false, true>;
  }
  return bf16 ? fused_ann_bwd_kernel<MODE, true, false>
              : fused_ann_bwd_kernel<MODE, false, false>;
}

// The instantiation that a launch of the mode at width H takes.
Kernel kernel_for(int mode, int H, int bf16) {
  switch (mode) {
    case kRnn: return kernel_of<kRnn>(H, bf16);
    case kLigru: return kernel_of<kLigru>(H, bf16);
    default: return kernel_of<kGru>(H, bf16);
  }
}

slice::Plan bwd_plan(int B, int H, int mode, int bf16) {
  return slice::make_plan(B, H, mode + 1, bf16 ? 2 : 4, mode == kRnn ? 1 : 2);
}

}  // namespace

// mode: 0 RNN, 1 LiGRU, 2 GRU. Null pointers switch parts off: scale (no
// affine: wx, dd and vecs are then not touched) and seed (no dropout).
// Operands of gates the mode lacks are ignored. vecs is (2*gates, H):
// dscale by gate, then dshift by gate. bf16 selects the bf16-stream mode:
// g, the residual series, dwx, dd and VT are then bf16, and the raw input
// streams are bf16 where wx_bf16. VT: every block's slice of the
// transposed matrices (ops/fused_ann.py `_pack_slices`); cluster, rows,
// resident, n_parts (partials is (n_parts, 2*gates, H), a part of two
// rows at H <= 512, else of one), ksplit (dv_partials is (ksplit, gates,
// H, H), unused and may be null at ksplit 1) and dv_tile (the dV
// product's, dv_product.cuh `dv_tile`): the plan. split_ms: null, or
// three floats of host memory (see above).
extern "C" int sparch_fused_ann_bwd(
    const void* g, const void* wx0, const void* wx1, const void* wx2,
    const void* y_seq, const void* z, const void* r, const void* c,
    const float* scale, const void* VT, const float* y0, const int* seed,
    void* dwx0, void* dwx1, void* dwx2, void* dd0, void* dd1,
    void* dd2, float* partials, float* vecs, float* dV, float* dv_partials,
    float* dy0, int B, int T, int H, int mode, unsigned int keep_u32,
    float inv_keep, int tile_rows, int row_seg, int row_stride,
    int row_off, int cluster, int rows, int resident, int n_parts,
    int ksplit, int dv_tile, int bf16, int wx_bf16, float* split_ms,
    void* stream) {
  const DropRows drop{tile_rows, row_seg, row_stride, row_off};
  const void* wx[3] = {wx0, wx1, wx2};
  void* dwx[3] = {dwx0, dwx1, dwx2};
  void* dd[3] = {dd0, dd1, dd2};
  if (B <= 0 || T <= 0 || H <= 0 || H > kMaxH || mode < kRnn ||
      mode > kGru || !g || !y_seq || !VT || !y0 || !partials || !vecs ||
      !dV || (ksplit > 1 && !dv_partials) || !dy0 ||
      (mode >= kLigru && (!z || !c)) ||
      (mode == kGru && !r) || (seed && !drop_rows_ok(drop)) || ksplit < 1 ||
      (wx_bf16 && !bf16)) {
    return (int)cudaErrorInvalidValue;
  }
  const int G = mode + 1;
  const bool affine = scale != nullptr;
  for (int k = 0; k < G; ++k) {
    if (!dwx[k] || (affine && (!wx[k] || !dd[k]))) {
      return (int)cudaErrorInvalidValue;
    }
  }
  const slice::Plan pl = bwd_plan(B, H, mode, bf16);
  const int part_rows = H <= kPairH ? 2 : 1;
  if (cluster != pl.cluster || rows != pl.rows || resident != pl.resident ||
      pl.threads > slice::kMaxThreads ||
      n_parts != (B + part_rows - 1) / part_rows ||
      !dv_tile_ok(dv_tile, H, G, ksplit)) {
    return (int)cudaErrorInvalidValue;
  }
  const Args p{g, {wx0, wx1, wx2}, y_seq, z, r, c, scale, VT, y0, seed,
               {dwx0, dwx1, dwx2}, {dd0, dd1, dd2}, partials, dy0, B, T, H,
               keep_u32, inv_keep, drop, wx_bf16, n_parts, pl};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Split split(split_ms != nullptr);
  split.mark(0, st);
  int err = (int)slice::launch(kernel_for(mode, H, bf16), pl, p, st);
  if (err == 0) err = (int)cudaGetLastError();
  if (err != 0) return err;
  split.mark(1, st);

  DvArgs a{y_seq, y0, mode == kGru ? r : nullptr, {}, nullptr, 0.f, T, H,
           B * T, dv_rows_per_split(B * T, ksplit), G, 0};
  for (int k = 0; k < 3; ++k) a.dpre[k] = affine ? dd[k] : dwx[k];
  err = (int)(bf16 ? launch_dv<false, __nv_bfloat16>(a, dV, dv_partials,
                                                     dv_tile, ksplit, st)
                   : launch_dv<false, float>(a, dV, dv_partials, dv_tile,
                                             ksplit, st));
  if (err != 0) return err;
  split.mark(2, st);

  if (affine) {
    const int n_vec = 2 * G * H;
    sum_parts_kernel<<<(n_vec + 255) / 256, 256, 0, st>>>(partials, vecs,
                                                          n_parts, n_vec);
    err = (int)cudaGetLastError();
    if (err != 0) return err;
  }
  split.mark(3, st);
  split.report(split_ms, 3);
  return (int)cudaGetLastError();
}

// How many clusters of the time loop's plan for (B, H, mode, bf16) the card
// holds at once (cudaOccupancyMaxActiveClusters), or -1.
extern "C" int sparch_fused_ann_bwd_max_clusters(int B, int H, int mode,
                                                 int bf16) {
  if (B <= 0 || H <= 0 || H > kMaxH || mode < kRnn || mode > kGru) return -1;
  const slice::Plan pl = bwd_plan(B, H, mode, bf16);
  return slice::max_active_clusters(kernel_for(mode, H, bf16), pl);
}

// The dV product alone, as the backwards launch it (dv_product.cuh
// `launch_dv`), for the card tests: dV (gates, H, H) from the left
// operand's series `left` (B, T, H), its row at t = 0 `left0` (B, H), r
// (the GRU's reset series, else null) and a right series (B, T, H) a gate.
// spiking: left is the u series (float), left0 s0, one gate, and the left
// operand is left > threshold; else left is y and left0 y0. The right
// series (and y, r) are bf16 where bf16; ksplit, dv_tile and dv_partials
// as for sparch_fused_ann_bwd.
extern "C" int sparch_dv_product(const void* left, const float* left0,
                                 const void* r, const void* dpre0,
                                 const void* dpre1, const void* dpre2,
                                 float* dV, float* dv_partials, int B, int T,
                                 int H, int G, int spiking, float threshold,
                                 int ksplit, int dv_tile, int bf16,
                                 void* stream) {
  const void* dpre[3] = {dpre0, dpre1, dpre2};
  if (B <= 0 || T <= 0 || H <= 0 || G < 1 || G > 3 || (spiking && G != 1) ||
      ksplit < 1 || !left || !left0 || !dV || (ksplit > 1 && !dv_partials) ||
      !dv_tile_ok(dv_tile, H, G, ksplit)) {
    return (int)cudaErrorInvalidValue;
  }
  for (int k = 0; k < G; ++k) {
    if (!dpre[k]) return (int)cudaErrorInvalidValue;
  }
  const DvArgs a{left, left0, r, {dpre0, dpre1, dpre2}, nullptr, threshold,
                 T, H, B * T, dv_rows_per_split(B * T, ksplit), G, 0};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (spiking) {
    return (int)(bf16 ? launch_dv<true, __nv_bfloat16>(a, dV, dv_partials,
                                                       dv_tile, ksplit, st)
                      : launch_dv<true, float>(a, dV, dv_partials, dv_tile,
                                               ksplit, st));
  }
  return (int)(bf16 ? launch_dv<false, __nv_bfloat16>(a, dV, dv_partials,
                                                      dv_tile, ksplit, st)
                    : launch_dv<false, float>(a, dV, dv_partials, dv_tile,
                                              ksplit, st));
}
