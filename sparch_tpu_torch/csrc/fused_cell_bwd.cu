// Fused spiking-cell backward for Hopper (sm_90a): reverse-time BPTT with
// the boxcar surrogate for LIF, adLIF, RLIF and RadLIF in one template,
// with the batchnorm affine and the output dropout of the forward.
//
// Replaces: sparch_tpu/ops/pallas_cells.py `_bwd_kernel`, the TPU kernel
// behind the VJP of lif/adlif/rlif/radlif_pallas, in two stream modes (BF):
// float32 streams, and the TPU kernel's mxu_bf16 mode. In that mode the
// cotangent g and dWx are bf16 streams, V^T is bf16 (rounded once by the
// wrapper), Wx (read with the affine) is float32 or bf16 as the forward
// got it, dDrive is rounded to bf16 where it enters a product (the adjoint
// product and dV, so the scratch series the dV kernel reads is stored in
// bf16) and dWx = bf16(dDrive*scale); the membrane series, all adjoint
// state and every reduced gradient (dscale and dshift from the float32
// dDrive) stay float32 and keep their fixed order.
//
// With A_t = dL/du_t, B_t = dL/dw_t and g_t the output cotangent (masked
// and scaled like the forward's output under DROPOUT), walking t = T..1:
//   C_t = g_t - alpha*A_{t+1} + ((1-alpha)*A_{t+1}) @ V^T + b*B_{t+1}
//   A_t = window(u_t - thr)*C_t + alpha*A_{t+1} + a*B_{t+1}
//   B_t = beta*B_{t+1} - (1-alpha)*A_t
//   dDrive_t = (1-alpha)*A_t ;  dWx_t = dDrive_t * scale
//   dscale = sum dDrive_t*Wx_t ;  dshift = sum dDrive_t
//   dV     = sum s_{t-1}^T dDrive_t
//   dalpha = sum A_t*(u_{t-1} - s_{t-1} - u_t) / (1-alpha)
//   da     = sum B_t*u_{t-1} ;  db = sum B_t*s_{t-1}
//   dbeta  = sum B_t*w_{t-1}
//          = sum w_0*P_1 + sum (a*u_{t-1} + b*s_{t-1})*P_{t+1},
//            P_t = B_t + beta*P_{t+1}
//   du_0 = alpha*A_1 + a*B_1 ;  dw_0 = beta*B_1
//   ds_0 = -alpha*A_1 + ((1-alpha)*A_1) @ V^T + b*B_1
// window(x) = -0.5 < x <= 0.5. s_t = u_t > thr is recomputed from the saved
// u series (the same float32 values the forward thresholded); at t = 1 the
// previous state is u0, s0 as given (s0 need not be 0/1). The second form
// of dbeta writes w_{t-1} out as beta^{t-1}*w_0 + sum_k beta^{t-2-k}*(a*u_k +
// b*s_k) and exchanges the sums, so the kernel needs no w series: none is
// stored by the forward and none is unwound here. All gradients are with
// respect to the clamped constants and the masked V; the clamp and the
// mask are pulled back by autograd outside.
//
// What bounds it on this card: for the recurrent forms the dense product
// ((1-alpha)*A) @ V^T of every step, 2*B*H*H FLOP against a V that does
// not fit in one SM's shared memory (1 MB at H=512), T times in sequence;
// then the dV product, 2*B*T*H*H FLOP. At (128, 100, 512) that is 6.7
// GFLOP each, 0.2 ms at the float32 peak, against 105 MB of streams (31 us
// at HBM rate): operations bound it.
//
// Design:
// - Recurrent forms (RLIF, RadLIF): the time loop runs as thread-block
//   clusters (cluster_slice.cuh, as fused_ann_bwd.cu). A cluster of C
//   blocks, one per SM (six, eight where a slice of six would pass 512
//   columns), owns R batch rows for the whole sequence; block k owns the
//   neurons k*Hs .. k*Hs+Hs-1, both for the elementwise update and for the
//   columns of the adjoint product, and holds the (H, Hs) slice of V^T
//   (the rows of V for its neurons): resident in shared memory where it
//   fits beside the operands (float32 H = 512: 180 KB), else streamed from
//   L2 through tile_stream.cuh's stages once per cluster and step. Thread
//   (tx, ty) owns neuron k*Hs + tx for the kRt rows from ty*kRt, with A, B,
//   P, the carried product and u in registers. Each step a thread stores
//   its dDrive (rounded to bf16 in the bf16 mode) into the operand of every
//   block of the cluster through distributed shared memory ([j][row], two
//   parities), the cluster crosses one barrier, and each thread sums its
//   column over j = 0 .. H-1 in ascending order with fmaf: the sums, and so
//   every output, of the kernel before the cluster split (one block for
//   whole rows, all of V^T streamed per block and step).
// - Non-recurrent forms (LIF, adLIF): no product. One block owns BT batch
//   rows (two at H <= 512, else one) for the whole sequence; thread j owns
//   NPT neurons for all BT rows.
// - Reductions are in a fixed order, so two runs give the same bits: each
//   thread sums its neurons' parameter gradients over all T and the rows of
//   a partial (two at H <= 512, else one; the rows of a block before the
//   cluster split, so the reduced gradients keep their bits; each product
//   rounded as that kernel rounded it, add_product), steps from
//   the last and rows ascending within a step, in registers, writes them
//   to partials[part][6][H], and a second kernel adds the parts in
//   ascending order (and divides dalpha by 1-alpha). No atomics.
// - dV is a product after the time loop (dv_product.cuh, shared with
//   tp_cell_bwd.cu): one (H, B*T) x (B*T, H) product whose left operand is
//   recomputed from the u series (s0 for the first step of each row) and
//   whose right operand is the stored dDrive (dWx itself without the
//   affine, else a scratch stream written beside it), tiled by the plan
//   `dv_tile`; where B*T is split, a fourth kernel adds the splits in
//   ascending order.
// - Edges are masked: rows >= B and neurons >= H load nothing, hold zero
//   adjoints and store nothing.
//
// C interface, bound with ctypes: sparch_fused_cell_bwd checks the plan it
// is given (ops/fused_cells.py `_bwd_plan`: for the recurrent forms the
// time loop's cluster, rows and resident slice; n_parts and ksplit, which
// size the caller's partials buffers; the dV product's tile) against its
// own, enqueues all the
// kernels on the stream, returns the first launch error (or an
// invalid-value error for arguments it does not take) and never
// synchronises, unless it is given split_ms: then it records CUDA events
// around each launch, waits for them and writes the milliseconds of the
// time loop, the dV product (the sum of its splits included) and the
// second passes there.

#include <cuda_runtime.h>
#include <stdint.h>

#include "cluster_slice.cuh"
#include "dropout_hash.cuh"
#include "dv_product.cuh"

namespace {

using namespace sparch;
using slice::kRt;

constexpr int kThreads = 512;
constexpr int kWork = 2;    // rows of a block times neurons of a thread
constexpr int kMaxNpt = 8;  // so H <= kThreads * kMaxNpt = 4096
constexpr int kVecs = 6;    // dalpha, dbeta, da, db, dscale, dshift
constexpr int kPairH = 512;  // partials of two rows up to here, else one
// A block of the cluster kernel at most (so 128 registers a thread), and
// the most columns a slice of six may have before the cluster takes eight.
constexpr int kClusterThreads = 512;
constexpr int kMaxCols = 512;

struct Args {
  const void* g;    // the streams g, dwx and dd: float, bf16 in bf16 mode
  const void* wx;   // float, or bf16 where wx_bf16 (bf16 mode only)
  const float* u_seq;
  const float* scale;
  const float* alpha;
  const float* beta;
  const float* a;
  const float* b;
  const void* VT;
  const float* u0;
  const float* w0;
  const float* s0;
  const int* seed;
  void* dwx;
  void* dd;
  float* partials;
  float* du0;
  float* dw0;
  float* ds0;
  int B;
  int T;
  int H;
  float threshold;
  uint32_t keep_u32;
  float inv_keep;
  int tile_rows;
};

// The bf16 mode's one more flag rides in a struct of its own, so that the
// float32 kernels' parameter block, and with it their code, stays what it
// was before the mode existed (an int appended to Args changed how the
// float32 time loops compiled).
struct ArgsBf16 : Args {
  int wx_bf16;  // the Wx stream is bf16, not float
};
template <bool BF>
struct ModeArgs {
  using type = Args;
};
template <>
struct ModeArgs<true> {
  using type = ArgsBf16;
};

// The non-recurrent forms (LIF, adLIF): RECURRENT is false in every
// instantiation (the recurrent forms run cell_bwd_cluster_kernel). One
// block owns BT rows for all T; thread j owns NPT neurons for the BT rows.
template <bool RECURRENT, bool ADAPTIVE, bool AFFINE, bool DROPOUT, int NPT,
          bool BF>
__global__ void __launch_bounds__(kThreads)
fused_cell_bwd_kernel(const typename ModeArgs<BF>::type p) {
  static_assert(!RECURRENT, "the recurrent forms run the cluster kernel");
  using ST = typename Elem<BF>::type;
  constexpr int BT = kWork / NPT > 0 ? kWork / NPT : 1;
  const int H = p.H;
  const int T = p.T;
  const int row0 = blockIdx.x * BT;
  const float thr = p.threshold;
  const ST* g_in = static_cast<const ST*>(p.g);
  ST* dwx_out = static_cast<ST*>(p.dwx);
  bool wx_bf16 = false;
  if constexpr (BF) wx_bf16 = p.wx_bf16;

  float al[NPT], oma[NPT], be[NPT], aa[NPT], bb[NPT], sc[NPT];
  float dal[NPT], dbe[NPT], daa[NPT], dbb[NPT], dsc[NPT], dsh[NPT];
  float A[NPT][BT], Bw[NPT][BT], P[NPT][BT], up[NPT][BT];
  int col[NPT];
  bool live[NPT];
  bool rowlive[BT];
  uint32_t drop_base[BT];

#pragma unroll
  for (int r = 0; r < BT; ++r) {
    rowlive[r] = row0 + r < p.B;
    drop_base[r] = (DROPOUT && rowlive[r])
                       ? sparch::dropout_row_base(p.seed, row0 + r,
                                                  p.tile_rows)
                       : 0u;
  }
#pragma unroll
  for (int i = 0; i < NPT; ++i) {
    const int j = threadIdx.x + i * blockDim.x;
    live[i] = j < H;
    col[i] = live[i] ? j : 0;
    const int c = col[i];
    al[i] = p.alpha[c];
    oma[i] = 1.0f - al[i];
    be[i] = ADAPTIVE ? p.beta[c] : 0.f;
    aa[i] = ADAPTIVE ? p.a[c] : 0.f;
    bb[i] = ADAPTIVE ? p.b[c] : 0.f;
    sc[i] = AFFINE ? p.scale[c] : 1.f;
    dal[i] = dbe[i] = daa[i] = dbb[i] = dsc[i] = dsh[i] = 0.f;
#pragma unroll
    for (int r = 0; r < BT; ++r) {
      A[i][r] = Bw[i][r] = P[i][r] = 0.f;
      // u_t of the first step walked, carried from step to step as the
      // next one's u_t
      const bool ok = live[i] && rowlive[r];
      up[i][r] = ok ? p.u_seq[((size_t)(row0 + r) * T + (T - 1)) * H + c]
                    : 0.f;
    }
  }

  for (int t = T - 1; t >= 0; --t) {
#pragma unroll
    for (int i = 0; i < NPT; ++i) {
      const int c = col[i];
#pragma unroll
      for (int r = 0; r < BT; ++r) {
        const bool ok = live[i] && rowlive[r];
        const size_t row = (size_t)(row0 + r);
        const size_t at = (row * T + t) * H + c;
        float g_t = ok ? to_float(g_in[at]) : 0.f;
        if (DROPOUT) {
          g_t = sparch::dropout_keep(drop_base[r], c, t, p.keep_u32)
                    ? g_t * p.inv_keep
                    : 0.f;
        }
        const float u_t = up[i][r];
        float u_p = 0.f, s_p = 0.f;
        if (ok) {
          if (t > 0) {
            u_p = p.u_seq[at - H];
            s_p = u_p > thr ? 1.f : 0.f;
          } else {
            u_p = p.u0[row * H + c];
            s_p = p.s0[row * H + c];
          }
        }
        up[i][r] = u_p;
        const float alphaA = al[i] * A[i][r];
        float C = g_t - alphaA;
        if (ADAPTIVE) C += bb[i] * Bw[i][r];
        const float wsub = u_t - thr;
        const bool window = ok && wsub > -0.5f && wsub <= 0.5f;
        float A_new = (window ? C : 0.f) + alphaA;
        if (ADAPTIVE) A_new += aa[i] * Bw[i][r];
        const float dd = oma[i] * A_new;
        if (AFFINE) {
          const float wx_t = ok ? load_stream<BF>(p.wx, at, wx_bf16) : 0.f;
          dsc[i] += dd * wx_t;
          dsh[i] += dd;
        }
        if (ok) dwx_out[at] = from_float<ST>(AFFINE ? dd * sc[i] : dd);
        dal[i] += A_new * (u_p - s_p - u_t);
        if (ADAPTIVE) {
          const float B_new = be[i] * Bw[i][r] - dd;
          dbe[i] += (aa[i] * u_p + bb[i] * s_p) * P[i][r];
          P[i][r] = B_new + be[i] * P[i][r];
          daa[i] += B_new * u_p;
          dbb[i] += B_new * s_p;
          Bw[i][r] = B_new;
        }
        A[i][r] = A_new;
      }
    }
  }

  // initial-state gradients and this block's parameter partials
  float* part = p.partials + (size_t)blockIdx.x * kVecs * H;
#pragma unroll
  for (int i = 0; i < NPT; ++i) {
    if (!live[i]) continue;
    const int c = col[i];
#pragma unroll
    for (int r = 0; r < BT; ++r) {
      if (!rowlive[r]) continue;
      const size_t at = (size_t)(row0 + r) * H + c;
      float du0 = al[i] * A[i][r];
      float ds0 = -(al[i] * A[i][r]);
      if (ADAPTIVE) {
        du0 += aa[i] * Bw[i][r];
        ds0 += bb[i] * Bw[i][r];
        p.dw0[at] = be[i] * Bw[i][r];
        dbe[i] += p.w0[at] * P[i][r];
      }
      p.du0[at] = du0;
      p.ds0[at] = ds0;
    }
    part[0 * H + c] = dal[i];
    part[1 * H + c] = dbe[i];
    part[2 * H + c] = daa[i];
    part[3 * H + c] = dbb[i];
    part[4 * H + c] = dsc[i];
    part[5 * H + c] = dsh[i];
  }
}

// The recurrent forms' parameters: those of Args with VT the packed slices
// of V^T (ops/fused_ann.py `_pack_slices`), the flags as values, and the
// plan.
struct ClusterArgs {
  const void* g;
  const void* wx;
  const float* u_seq;
  const float* scale;  // null: no affine (wx and dd are then not touched)
  const float* alpha;
  const float* beta;
  const float* a;
  const float* b;
  const void* VT;
  const float* u0;
  const float* w0;
  const float* s0;
  const int* seed;     // null: no dropout
  void* dwx;
  void* dd;
  float* partials;
  float* du0;
  float* dw0;
  float* ds0;
  int B, T, H;
  float threshold;
  uint32_t keep_u32;
  float inv_keep;
  int tile_rows;
  int wx_bf16;
  int n_parts;
  slice::Plan plan;
};

// acc + a*b in a parameter gradient's sum, rounded once (fmaf) where
// `fused`, else twice (the product, then the sum): as the kernel before the
// cluster split rounded it, whose compiler fused these products at its
// widths of one neuron a thread (H <= kPairH) and, past H = 2*kPairH (four
// or eight neurons a thread), in its instantiations with the affine and
// the dropout, and nowhere else. Written out, the sums depend on no
// compiler's choice.
__device__ __forceinline__ float add_product(float acc, float a, float b,
                                             bool fused) {
  return fused ? fmaf(a, b, acc) : __fadd_rn(acc, __fmul_rn(a, b));
}

// The recurrent forms (RLIF, RadLIF): see the header. PAIR: a partial of
// the parameter gradients sums two rows (H <= kPairH), else one.
template <bool ADAPTIVE, bool BF, bool PAIR>
__global__ void __launch_bounds__(kClusterThreads, 1)
cell_bwd_cluster_kernel(const __grid_constant__ ClusterArgs p) {
  using ST = typename Elem<BF>::type;
  constexpr int PR = PAIR ? 2 : 1;  // rows of a partial
  constexpr int NS = kRt / PR;      // partials a thread sums
  // two parities of the [j][row] operand (R*H floats each), then the
  // resident slice or the stream's stages
  extern __shared__ __align__(16) float smem[];
  __shared__ uint64_t full[kStages];
  const slice::Plan& pl = p.plan;
  const int H = p.H, T = p.T, R = pl.rows, Hs = pl.cols, CL = pl.cluster;
  const int k = (int)(blockIdx.x % CL);
  const int row_base = (int)(blockIdx.x / CL) * R;
  const size_t RH = (size_t)R * H;
  const float thr = p.threshold;

  const int tx = threadIdx.x % Hs;
  const int ty_raw = threadIdx.x / Hs;
  const bool thread_live = ty_raw < R / kRt;
  const int ry0 = thread_live ? ty_raw * kRt : 0;
  const int row0 = row_base + ry0;
  const int col = k * Hs + tx;
  const bool live = thread_live && col < H;
  const int c = live ? col : 0;
  const bool affine = p.scale != nullptr;
  const bool dropout = p.seed != nullptr;
  const bool wx_bf16 = BF && p.wx_bf16;
  const bool fused = PAIR || (H > 2 * kPairH && affine && dropout);

  const int gates[2] = {1, 0};
  slice::Stream<ST> s = slice::open_stream(
      static_cast<const ST*>(p.VT) + (size_t)k * H * Hs,
      reinterpret_cast<ST*>(smem + 2 * RH), full, pl, H, Hs, gates, T);
  slice::begin(s);
  const ST* g_in = static_cast<const ST*>(p.g);
  ST* dwx_out = static_cast<ST*>(p.dwx);
  ST* dd_out = static_cast<ST*>(p.dd);

  const float al = p.alpha[c];
  const float oma = 1.0f - al;
  const float be = ADAPTIVE ? p.beta[c] : 0.f;
  const float aa = ADAPTIVE ? p.a[c] : 0.f;
  const float bb = ADAPTIVE ? p.b[c] : 0.f;
  const float sc = affine ? p.scale[c] : 1.f;
  float dal[NS], dbe[NS], daa[NS], dbb[NS], dsc[NS], dsh[NS];
#pragma unroll
  for (int q = 0; q < NS; ++q) {
    dal[q] = dbe[q] = daa[q] = dbb[q] = dsc[q] = dsh[q] = 0.f;
  }
  float A[kRt], Bw[kRt], P[kRt], AV[kRt], up[kRt];
  bool rowlive[kRt];
  uint32_t drop_base[kRt];
#pragma unroll
  for (int r = 0; r < kRt; ++r) {
    rowlive[r] = thread_live && row0 + r < p.B;
    drop_base[r] = (dropout && rowlive[r])
                       ? dropout_row_base(p.seed, row0 + r, p.tile_rows)
                       : 0u;
    A[r] = Bw[r] = P[r] = AV[r] = 0.f;
    // u_t of the first step walked, carried as the next one's u_t
    up[r] = live && rowlive[r]
                ? p.u_seq[((size_t)(row0 + r) * T + (T - 1)) * H + col]
                : 0.f;
  }
  // every block of the cluster runs before any stores into it
  slice::cluster_barrier();
  slice::await_resident(s);

  for (int t = T - 1; t >= 0; --t) {
    float dd_r[kRt];
#pragma unroll
    for (int r = 0; r < kRt; ++r) {
      const bool ok = live && rowlive[r];
      const size_t row = (size_t)(row0 + r);
      const size_t at = (row * T + t) * H + col;
      float g_t = ok ? to_float(g_in[at]) : 0.f;
      if (dropout) {
        g_t = dropout_keep(drop_base[r], c, t, p.keep_u32) ? g_t * p.inv_keep
                                                           : 0.f;
      }
      const float u_t = up[r];
      float u_p = 0.f, s_p = 0.f;
      if (ok) {
        if (t > 0) {
          u_p = p.u_seq[at - H];
          s_p = u_p > thr ? 1.f : 0.f;
        } else {
          u_p = p.u0[row * H + col];
          s_p = p.s0[row * H + col];
        }
      }
      up[r] = u_p;
      const float alphaA = al * A[r];
      float C = g_t - alphaA;
      C += AV[r];
      if (ADAPTIVE) C += bb * Bw[r];
      const float wsub = u_t - thr;
      const bool window = ok && wsub > -0.5f && wsub <= 0.5f;
      float A_new = (window ? C : 0.f) + alphaA;
      if (ADAPTIVE) A_new += aa * Bw[r];
      const float dd = oma * A_new;
      if (affine) {
        const float wx_t = ok ? load_stream<BF>(p.wx, at, wx_bf16) : 0.f;
        dsc[r / PR] = add_product(dsc[r / PR], dd, wx_t, fused);
        dsh[r / PR] += dd;
      }
      if (ok) {
        dwx_out[at] = from_float<ST>(affine ? dd * sc : dd);
        if (affine) dd_out[at] = from_float<ST>(dd);
      }
      dd_r[r] = dd;
      dal[r / PR] = add_product(dal[r / PR], A_new, u_p - s_p - u_t,
                               fused);
      if (ADAPTIVE) {
        const float B_new = be * Bw[r] - dd;
        dbe[r / PR] += (aa * u_p + bb * s_p) * P[r];
        P[r] = B_new + be * P[r];
        daa[r / PR] = add_product(daa[r / PR], B_new, u_p, fused);
        dbb[r / PR] = add_product(dbb[r / PR], B_new, s_p, fused);
        Bw[r] = B_new;
      }
      A[r] = A_new;
    }
    // dDrive into every block's operand (bf16 mode: rounded where it
    // enters the adjoint product), then AV = dDrive @ V^T, j ascending
    float* op = smem + (size_t)((T - 1 - t) & 1) * RH;
    if (live) slice::to_cluster<BF>(op, (size_t)col * R + ry0, dd_r, CL);
    slice::cluster_barrier();
    float av[1][kRt] = {};
    slice::pass<1, true>(s, 0, op + ry0, 0, R, tx, Hs, av);
#pragma unroll
    for (int r = 0; r < kRt; ++r) AV[r] = av[0][r];
  }

  // initial-state gradients and the thread's parameter partials
  if (!live) return;
#pragma unroll
  for (int r = 0; r < kRt; ++r) {
    if (!rowlive[r]) continue;
    const size_t at = (size_t)(row0 + r) * H + col;
    float du0 = al * A[r];
    float ds0 = -(al * A[r]);
    ds0 += AV[r];
    if (ADAPTIVE) {
      du0 += aa * Bw[r];
      ds0 += bb * Bw[r];
      p.dw0[at] = be * Bw[r];
      dbe[r / PR] += p.w0[at] * P[r];
    }
    p.du0[at] = du0;
    p.ds0[at] = ds0;
  }
#pragma unroll
  for (int q = 0; q < NS; ++q) {
    const int part_i = row0 / PR + q;
    if (part_i >= p.n_parts) break;
    float* part = p.partials + (size_t)part_i * kVecs * H;
    part[0 * H + col] = dal[q];
    part[1 * H + col] = dbe[q];
    part[2 * H + col] = daa[q];
    part[3 * H + col] = dbb[q];
    part[4 * H + col] = dsc[q];
    part[5 * H + col] = dsh[q];
  }
}

// out[q][j] = sum over parts, ascending, of partials[part][q][j]; the
// dalpha row (q = 0) is divided by 1 - alpha, hoisted out of the time loop.
__global__ void vec_reduce_kernel(const float* __restrict__ partials,
                                  const float* __restrict__ alpha,
                                  float* __restrict__ out, int n_blocks,
                                  int H) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= kVecs * H) return;
  float sum = 0.f;
  for (int k = 0; k < n_blocks; ++k) {
    sum += partials[(size_t)k * kVecs * H + idx];
  }
  if (idx < H) sum = sum / (1.0f - alpha[idx]);
  out[idx] = sum;
}

// The non-recurrent forms' launch, by neurons a thread and flags.
template <bool A, bool F, bool D, int NPT, bool BF>
void launch_one(const ArgsBf16& p, int n_blocks, int threads,
                cudaStream_t st) {
  fused_cell_bwd_kernel<false, A, F, D, NPT, BF><<<n_blocks, threads, 0, st>>>(
      p);
}

template <bool A, bool F, bool D, bool BF>
void launch_mode(const ArgsBf16& p, int n_blocks, int npt, int threads,
                 cudaStream_t st) {
  switch (npt) {
    case 1:
      launch_one<A, F, D, 1, BF>(p, n_blocks, threads, st);
      break;
    case 2:
      launch_one<A, F, D, 2, BF>(p, n_blocks, threads, st);
      break;
    case 4:
      launch_one<A, F, D, 4, BF>(p, n_blocks, threads, st);
      break;
    default:
      launch_one<A, F, D, 8, BF>(p, n_blocks, threads, st);
      break;
  }
}

template <bool A, bool F, bool D>
void launch_npt(const ArgsBf16& p, bool bf16, int n_blocks, int npt,
                int threads, cudaStream_t st) {
  if (bf16) {
    launch_mode<A, F, D, true>(p, n_blocks, npt, threads, st);
  } else {
    launch_mode<A, F, D, false>(p, n_blocks, npt, threads, st);
  }
}

template <bool A>
void launch_affine(const ArgsBf16& p, bool bf16, bool affine, bool dropout,
                   int n_blocks, int npt, int threads, cudaStream_t st) {
  if (affine && dropout) {
    launch_npt<A, true, true>(p, bf16, n_blocks, npt, threads, st);
  } else if (affine) {
    launch_npt<A, true, false>(p, bf16, n_blocks, npt, threads, st);
  } else if (dropout) {
    launch_npt<A, false, true>(p, bf16, n_blocks, npt, threads, st);
  } else {
    launch_npt<A, false, false>(p, bf16, n_blocks, npt, threads, st);
  }
}

using ClusterKernel = void (*)(ClusterArgs);

template <bool A>
ClusterKernel cluster_kernel_of(int H, int bf16) {
  if (H <= kPairH) {
    return bf16 ? cell_bwd_cluster_kernel<A, true, true>
                : cell_bwd_cluster_kernel<A, false, true>;
  }
  return bf16 ? cell_bwd_cluster_kernel<A, true, false>
              : cell_bwd_cluster_kernel<A, false, false>;
}

// The recurrent forms' plan (ops/fused_cells.py `_cluster_plan` computes
// the same): cluster_slice.cuh's rule for one matrix and one operand
// plane, in clusters of up to six blocks, or of eight where a slice of six
// would pass kMaxCols columns (H > 3072: four rows of threads each).
slice::Plan cluster_plan(int B, int H, int bf16) {
  const int six = ((H + 5) / 6 + slice::kColAlign - 1) / slice::kColAlign *
                  slice::kColAlign;
  return slice::make_plan(B, H, 1, bf16 ? 2 : 4, 1, 0, six > kMaxCols ? 8 : 0);
}

}  // namespace

// bf16 selects the bf16-stream mode: g, dwx and dd are then bf16, and wx is
// bf16 where wx_bf16. VT (recurrent forms): every block's slice of V^T
// (ops/fused_ann.py `_pack_slices`), bf16 in that mode. n_parts
// (partials is (n_parts, 6, H), a part of two rows at H <= 512, else of
// one), ksplit (dv_partials is (ksplit, H, H), unused and may be null at
// ksplit 1) and, for the recurrent forms, cluster, rows, resident and
// dv_tile (the dV product's, dv_product.cuh `dv_tile`): the plan.
// split_ms: null, or three floats of host memory (see the header).
extern "C" int sparch_fused_cell_bwd(
    const void* g, const void* wx, const float* u_seq, const float* scale,
    const float* alpha, const float* beta, const float* a, const float* b,
    const void* VT, const float* u0, const float* w0, const float* s0,
    const int* seed, void* dwx, void* dd, float* partials, float* vecs,
    float* dV, float* dv_partials, float* du0, float* dw0, float* ds0,
    int B, int T, int H, float threshold, int recurrent, int adaptive,
    int affine, unsigned int keep_u32, float inv_keep, int tile_rows,
    int n_parts, int ksplit, int dv_tile, int cluster, int rows,
    int resident, int bf16, int wx_bf16, float* split_ms, void* stream) {
  if (B <= 0 || T <= 0 || H <= 0 || H > kThreads * kMaxNpt || !g || !u_seq ||
      !alpha || !u0 || !s0 || !dwx || !partials || !vecs || !du0 || !ds0 ||
      (recurrent && (!VT || !dV || (ksplit > 1 && !dv_partials))) ||
      (adaptive && (!beta || !a || !b || !w0 || !dw0)) ||
      (affine && (!wx || !scale)) || (affine && recurrent && !dd) ||
      (seed && tile_rows <= 0) || (wx_bf16 && !bf16) || ksplit < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const int part_rows = H <= kPairH ? 2 : 1;
  if (n_parts != (B + part_rows - 1) / part_rows) {
    return (int)cudaErrorInvalidValue;
  }
  const slice::Plan pl = cluster_plan(B, H, bf16);
  if (recurrent && (cluster != pl.cluster || rows != pl.rows ||
                    resident != pl.resident ||
                    pl.threads > kClusterThreads ||
                    !dv_tile_ok(dv_tile, H, 1, ksplit))) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Split split(split_ms != nullptr);
  split.mark(0, st);
  int err = 0;
  if (recurrent) {
    const ClusterArgs p{g, affine ? wx : nullptr, u_seq,
                        affine ? scale : nullptr, alpha, beta, a, b, VT, u0,
                        w0, s0, seed, dwx, dd, partials, du0, dw0, ds0, B, T,
                        H, threshold, keep_u32, inv_keep, tile_rows, wx_bf16,
                        n_parts, pl};
    const ClusterKernel kernel = adaptive ? cluster_kernel_of<true>(H, bf16)
                                          : cluster_kernel_of<false>(H, bf16);
    err = (int)slice::launch(kernel, pl, p, st);
  } else {
    // fewest neurons per thread that keep the block within kThreads
    int npt = 1;
    while ((H + npt - 1) / npt > kThreads) npt *= 2;
    const int threads = (((H + npt - 1) / npt) + 31) / 32 * 32;
    const ArgsBf16 p{{g, wx, u_seq, scale, alpha, beta, a, b, VT, u0, w0, s0,
                      seed, dwx, dd, partials, du0, dw0, ds0, B, T, H,
                      threshold, keep_u32, inv_keep, tile_rows},
                     wx_bf16};
    const bool dropout = seed != nullptr;
    if (adaptive) {
      launch_affine<true>(p, bf16 != 0, affine, dropout, n_parts, npt,
                          threads, st);
    } else {
      launch_affine<false>(p, bf16 != 0, affine, dropout, n_parts, npt,
                           threads, st);
    }
  }
  if (err == 0) err = (int)cudaGetLastError();
  if (err != 0) return err;
  split.mark(1, st);

  if (recurrent) {
    const void* dd_series = affine ? dd : dwx;
    err = (int)(bf16 ? launch_spike_dv(
                           u_seq, s0,
                           static_cast<const __nv_bfloat16*>(dd_series),
                           threshold, dV, dv_partials, T, H, B * T, dv_tile,
                           ksplit, st)
                     : launch_spike_dv(u_seq, s0,
                                       static_cast<const float*>(dd_series),
                                       threshold, dV, dv_partials, T, H,
                                       B * T, dv_tile, ksplit, st));
    if (err != 0) return err;
  }
  split.mark(2, st);

  const int n_vec = kVecs * H;
  vec_reduce_kernel<<<(n_vec + 255) / 256, 256, 0, st>>>(partials, alpha,
                                                         vecs, n_parts, H);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  split.mark(3, st);
  split.report(split_ms, 3);
  return (int)cudaGetLastError();
}
