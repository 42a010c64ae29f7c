// Leaky cumulative-softmax readout backward for Hopper (sm_90a).
//
// Replaces: sparch_tpu/ops/pallas_cells.py `_readout_bwd_kernel`, the TPU
// kernel behind the VJP of readout_pallas.
//
// out = sum_t softmax(u_t) with u_t = alpha*u_{t-1} + (1-alpha)*Wx_t, and
// gout its cotangent, constant over t. With p_t = softmax(u_t) recomputed
// from the saved u series, for one batch row, walking t = T..1:
//   G_t    = p_t * (gout - <p_t, gout>) + alpha*G_{t+1}
//   dWx_t  = (1-alpha) * G_t
//   dalpha = sum_{b,t} G_t * (u_{t-1} - u_t) / (1-alpha)
//   du_0   = alpha * G_1
// (u_{t-1} - Wx_t = (u_{t-1} - u_t)/(1-alpha), the divide hoisted out of
// the loop; u_0 as given.)
//
// What bounds it on this card: latency, like the forward. At the training
// shape (B=128, T=100, C=35) it reads 1.8 MB and writes 1.8 MB, about a
// microsecond at HBM rate. Only G is sequential (two dependent float
// operations a step); p_t and <p_t, gout> depend only on u_t.
//
// Design (readout.cuh): a block owns `rows` batch rows and walks T in
// chunks from the last. Per chunk it stages u_{t0-1} .. u_{t0+n-1} of its
// rows (u_0 before the first step) by cp.async, then
//   1. the warps take the (row, t) softmaxes, two at a time a warp, in the
//      lane layout of one warp a row, and store p_t and <p_t, gout>;
//   2. one thread a (row, class) walks t down the chunk: G, dWx and the
//      dalpha partial, carried from chunk to chunk in registers.
// Each block writes its rows' dalpha partials; the last block to finish
// (a ticket from a device counter that it resets) adds the B rows per class
// in ascending order from 0.f and divides by 1-alpha. One launch.
//
// Bits: the outputs are those of the earlier design (one warp a row, a
// second kernel adding the dalpha rows), whose updates had no rounding
// intrinsics and which nvcc compiled (its SASS) to: FADD class sums, an
// FFMA chain from 0 for <e, gout>, G = fma(p, gout - pg, alpha*G) with
// alpha*G rounded, the partial fma(G, u_{t-1} - u_t, partial), IEEE
// divides. They are written here as those intrinsics, with p and pg
// stored apart (not their product).
//
// Past 32 * kMaxVpl classes the wide form runs (readout_bwd_wide_kernel):
// a block a row, walking T in chunks from the last; per chunk a warp a step
// takes the max, the class sum and <e, gout> (readout.cuh wide_stats) into
// shared memory, then the threads walk G down the chunk a class at a time,
// p_t recomputed as e / sum, G and the dalpha partial carried from chunk to
// chunk in du0 and partials; the last block adds the partial rows per class
// in ascending order, as above.
//
// C interface, bound with ctypes: sparch_readout_bwd enqueues the launch,
// returns cudaGetLastError() (or an invalid-value error for a shape or plan
// it does not take) and never synchronises. Two launches must not run at
// once on one card (they share the ticket counter).

#include "readout.cuh"

namespace {

using readout::kMaxVpl;

__device__ unsigned int g_ticket = 0;

// Steps a group of phase 2's walk down t.
constexpr int kStep = 4;

// The operands of steps t, t-1, ..., t-kStep+1: p and <p, gout> of each,
// and u_t, u_{t-1}, ..., u_{t-kStep} (ur[i*C] holds u_{t0-1+i}, so u_{t-k}
// is ur[(t-k+1)*C]; u_{t-k} is uu[k]). Steps before the chunk read its
// first (no branch); they are not used.
__device__ __forceinline__ void load_steps(const float* pr, const float* pgr,
                                           const float* ur, int C, int t,
                                           float (&p)[kStep],
                                           float (&pg)[kStep],
                                           float (&uu)[kStep + 1]) {
#pragma unroll
  for (int k = 0; k < kStep; ++k) {
    const int tk = max(t - k, 0);
    p[k] = pr[tk * C];
    pg[k] = pgr[tk];
    uu[k] = ur[max(t - k + 1, 0) * C];
  }
  uu[kStep] = ur[max(t - kStep + 1, 0) * C];
}

template <int VPL>
__global__ void __launch_bounds__(readout::kThreads)
readout_bwd_kernel(const float* __restrict__ gout,
                   const float* __restrict__ u_seq,
                   const float* __restrict__ alpha,
                   const float* __restrict__ u0, float* __restrict__ dwx,
                   float* __restrict__ partials, float* __restrict__ dalpha,
                   float* __restrict__ du0, int B, int T, int C, int rows,
                   int tc) {
  // su: rows x (tc + 1) x C, u_{t0-1} first; sp: rows x tc x C, p;
  // sg: rows x C, gout; spg: rows x tc, <p, gout>
  extern __shared__ __align__(16) float s[];
  float* su = s;
  float* sp = su + (size_t)rows * (tc + 1) * C;
  float* sg = sp + (size_t)rows * tc * C;
  float* spg = sg + (size_t)rows * C;
  __shared__ bool last;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31, nw = nt >> 5;
  const int row0 = blockIdx.x * rows;
  const int nr = min(rows, B - row0);
  const bool mine = tid < nr * C;
  const int r = mine ? tid / C : 0;
  const int c = mine ? tid - r * C : 0;
  const size_t grow = (size_t)(row0 + r);
  float al = 0.f, oma = 0.f, go = 0.f, G = 0.f, dal = 0.f;
  if (mine) {
    al = alpha[c];
    oma = __fsub_rn(1.0f, al);
  }
  int at[VPL];
  bool live[VPL];
  readout::class_slots<VPL>(lane, C, at, live);
  readout::stage(sg, gout + (size_t)row0 * C, nr * C);

  for (int t0 = (T - 1) / tc * tc; t0 >= 0; t0 -= tc) {
    const int n = min(tc, T - t0);
    for (int q = 0; q < nr; ++q) {
      float* dst = su + (size_t)q * (tc + 1) * C;
      const float* row = u_seq + (size_t)(row0 + q) * T * C;
      if (t0 > 0) {
        readout::stage(dst, row + (size_t)(t0 - 1) * C, (n + 1) * C);
      } else {
        readout::stage(dst, u0 + (size_t)(row0 + q) * C, C);
        readout::stage(dst + C, row, n * C);
      }
    }
    readout::stage_wait();
    if (mine) go = sg[r * C + c];

    // 1. p_t and <p_t, gout>, two softmaxes a warp at a time (the second
    // repeats the first where none is left: the same values to the same
    // place)
    const int total = nr * n;
    for (int j = warp; j < total; j += 2 * nw) {
      const int jj[2] = {j, j + nw < total ? j + nw : j};
      int q[2], t[2];
      float x[2][VPL];
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        q[k] = jj[k] / n;
        t[k] = jj[k] - q[k] * n;
        const float* ut = su + ((size_t)q[k] * (tc + 1) + t[k] + 1) * C;
#pragma unroll
        for (int v = 0; v < VPL; ++v) {
          const float xv = ut[at[v]];
          x[k][v] = live[v] ? xv : 0.f;
        }
      }
      float sum[2], dot[2];
      readout::exp_sum<VPL, 2>(x, live, sum);
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        dot[k] = 0.f;
        const float* g = sg + q[k] * C;
#pragma unroll
        for (int v = 0; v < VPL; ++v) {
          const float gv = g[at[v]];
          dot[k] = __fmaf_rn(x[k][v], live[v] ? gv : 0.f, dot[k]);
        }
      }
      readout::warp_sum<2>(sum);
      readout::warp_sum<2>(dot);
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        float* p = sp + ((size_t)q[k] * tc + t[k]) * C;
#pragma unroll
        for (int v = 0; v < VPL; ++v) {
          // a dead class divides 1 (0 / sum would take the divide's
          // slow path), and is not stored
          const float pv = __fdiv_rn(live[v] ? x[k][v] : 1.f, sum[k]);
          if (live[v]) p[at[v]] = pv;
        }
        const float pg = __fdiv_rn(dot[k], sum[k]);
        if (lane == 0) spg[q[k] * tc + t[k]] = pg;
      }
    }
    __syncthreads();

    // 2. G down the chunk, kStep steps a group, the next group's operands
    // loaded while this one's are used
    if (mine) {
      const float* ur = su + (size_t)r * (tc + 1) * C + c;  // u_{t0-1+i}
      const float* pr = sp + (size_t)r * tc * C + c;
      const float* pgr = spg + r * tc;
      float* dr = dwx + (grow * T + t0) * C + c;
      float p[kStep], pg[kStep], uu[kStep + 1];  // steps t, t-1, ...
      int t = n - 1;
      load_steps(pr, pgr, ur, C, t, p, pg, uu);
      for (; t >= kStep - 1; t -= kStep) {
        float p1[kStep], pg1[kStep], uu1[kStep + 1];
        load_steps(pr, pgr, ur, C, t - kStep, p1, pg1, uu1);
#pragma unroll
        for (int k = 0; k < kStep; ++k) {
          G = __fmaf_rn(p[k], __fsub_rn(go, pg[k]), __fmul_rn(al, G));
          dr[(size_t)(t - k) * C] = __fmul_rn(oma, G);
          dal = __fmaf_rn(G, __fsub_rn(uu[k + 1], uu[k]), dal);
        }
#pragma unroll
        for (int k = 0; k < kStep; ++k) {
          p[k] = p1[k];
          pg[k] = pg1[k];
          uu[k] = uu1[k];
        }
        uu[kStep] = uu1[kStep];
      }
      for (; t >= 0; --t) {
        G = __fmaf_rn(pr[t * C], __fsub_rn(go, pgr[t]), __fmul_rn(al, G));
        dr[(size_t)t * C] = __fmul_rn(oma, G);
        dal = __fmaf_rn(G, __fsub_rn(ur[t * C], ur[(t + 1) * C]), dal);
      }
    }
    __syncthreads();  // before the next chunk is staged over this one
  }
  if (mine) {
    du0[grow * C + c] = __fmul_rn(al, G);
    partials[grow * C + c] = dal;
  }

  // the last block adds the partial rows per class (the ticket as a grid
  // barrier takes it: the block's stores, then one fence and the atomic)
  __syncthreads();
  if (tid == 0) {
    __threadfence();
    last = atomicAdd(&g_ticket, 1u) == gridDim.x - 1;
    if (last) __threadfence();
  }
  __syncthreads();
  if (!last) return;
  // as many rows a pass as the shared memory holds, sixteen loads a thread
  // in flight (from L2: other blocks wrote them)
  const int per = (rows * (2 * C + tc * (2 * C + 1))) / C;
  float sum = 0.f;
  for (int b0 = 0; b0 < B; b0 += per) {
    const int m = min(per, B - b0) * C;
    const float* src = partials + (size_t)b0 * C;
    for (int i0 = tid; i0 < m; i0 += 16 * nt) {
      float v[16];
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        const int i = i0 + k * nt;
        v[k] = i < m ? __ldcg(src + i) : 0.f;
      }
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        const int i = i0 + k * nt;
        if (i < m) s[i] = v[k];
      }
    }
    __syncthreads();
    if (tid < C) sum = readout::ordered_sum(s + tid, C, m / C, sum);
    __syncthreads();
  }
  if (tid < C) dalpha[tid] = __fdiv_rn(sum, __fsub_rn(1.0f, alpha[tid]));
  if (tid == 0) g_ticket = 0;
}

// The wide form (C past the lane layout): one block a row.
__global__ void __launch_bounds__(readout::kThreads)
readout_bwd_wide_kernel(const float* __restrict__ gout,
                        const float* __restrict__ u_seq,
                        const float* __restrict__ alpha,
                        const float* __restrict__ u0, float* __restrict__ dwx,
                        float* __restrict__ partials,
                        float* __restrict__ dalpha, float* __restrict__ du0,
                        int B, int T, int C, int tc) {
  extern __shared__ __align__(16) float s[];  // tc maxes, sums, <p, gout>
  float* sm = s;
  float* ss = s + tc;
  float* spg = s + 2 * tc;
  __shared__ bool last;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int warp = tid >> 5, nw = nt >> 5;
  const size_t row = blockIdx.x;
  const float* g = gout + row * C;
  const float* u = u_seq + row * T * C;
  float* d = dwx + row * T * C;
  float* carry_g = du0 + row * C;       // G between chunks, then du0
  float* carry_a = partials + row * C;  // the dalpha partial

  for (int t0 = (T - 1) / tc * tc; t0 >= 0; t0 -= tc) {
    const int n = min(tc, T - t0);
    const bool first = t0 + n == T;
    // 1. each step's max, class sum and <p, gout>, a warp a step
    for (int j = warp; j < n; j += nw) {
      float m, sum, dot;
      readout::wide_stats(u + (size_t)(t0 + j) * C, g, C, m, sum, dot);
      if ((tid & 31) == 0) {
        sm[j] = m;
        ss[j] = sum;
        spg[j] = __fdiv_rn(dot, sum);
      }
    }
    __syncthreads();
    // 2. G down the chunk, a class at a time (each thread the same classes
    // in every chunk, so it reads back only its own carries)
    for (int c = tid; c < C; c += nt) {
      const float al = alpha[c], oma = __fsub_rn(1.0f, al), go = g[c];
      float G = first ? 0.f : carry_g[c];
      float dal = first ? 0.f : carry_a[c];
      for (int t = n - 1; t >= 0; --t) {
        const size_t at = (size_t)(t0 + t) * C + c;
        const float ut = u[at];
        const float prev = t0 + t > 0 ? u[at - C] : u0[row * C + c];
        const float p = __fdiv_rn(expf(__fsub_rn(ut, sm[t])), ss[t]);
        G = __fmaf_rn(p, __fsub_rn(go, spg[t]), __fmul_rn(al, G));
        d[at] = __fmul_rn(oma, G);
        dal = __fmaf_rn(G, __fsub_rn(prev, ut), dal);
      }
      carry_g[c] = t0 == 0 ? __fmul_rn(al, G) : G;
      carry_a[c] = dal;
    }
    __syncthreads();  // before the next chunk's statistics
  }

  // the last block adds the partial rows per class, each from 0.f in
  // ascending row order (from L2: other blocks wrote them)
  if (tid == 0) {
    __threadfence();
    last = atomicAdd(&g_ticket, 1u) == gridDim.x - 1;
    if (last) __threadfence();
  }
  __syncthreads();
  if (!last) return;
  for (int c = tid; c < C; c += nt) {
    float sum = 0.f;
    for (int b = 0; b < B; ++b) {
      sum = __fadd_rn(sum, __ldcg(partials + (size_t)b * C + c));
    }
    dalpha[c] = __fdiv_rn(sum, __fsub_rn(1.0f, alpha[c]));
  }
  if (tid == 0) g_ticket = 0;
}

template <int VPL>
int launch(const float* gout, const float* u_seq, const float* alpha,
           const float* u0, float* dwx, float* partials, float* dalpha,
           float* du0, int B, int T, int C, const readout::Plan& p,
           cudaStream_t st) {
  const int err = readout::allow_smem(readout_bwd_kernel<VPL>, p.smem);
  if (err != 0) return err;
  const int blocks = (B + p.rows - 1) / p.rows;
  readout_bwd_kernel<VPL><<<blocks, 32 * p.warps, p.smem, st>>>(
      gout, u_seq, alpha, u0, dwx, partials, dalpha, du0, B, T, C, p.rows,
      p.t_chunk);
  return (int)cudaGetLastError();
}

}  // namespace

// partials: (B, C) scratch for the per-row dalpha sums. rows, warps,
// t_chunk: the plan (readout.cuh `plan`), checked against the current
// card's.
extern "C" int sparch_readout_bwd(const float* gout, const float* u_seq,
                                  const float* alpha, const float* u0,
                                  float* dwx, float* partials, float* dalpha,
                                  float* du0, int B, int T, int C, int rows,
                                  int warps, int t_chunk, void* stream) {
  readout::Plan p;
  if (B <= 0 || T <= 0 || C <= 0 || !gout || !u_seq ||
      !alpha || !u0 || !dwx || !partials || !dalpha || !du0 ||
      !readout::plan_ok(B, T, C, true, rows, warps, t_chunk, &p)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (C > 32 * kMaxVpl) {
    readout_bwd_wide_kernel<<<B, 32 * p.warps, p.smem, st>>>(
        gout, u_seq, alpha, u0, dwx, partials, dalpha, du0, B, T, C,
        p.t_chunk);
    return (int)cudaGetLastError();
  }
  const int vpl = (C + 31) / 32;
  if (vpl == 1) {
    return launch<1>(gout, u_seq, alpha, u0, dwx, partials, dalpha, du0, B,
                     T, C, p, st);
  }
  if (vpl == 2) {
    return launch<2>(gout, u_seq, alpha, u0, dwx, partials, dalpha, du0, B,
                     T, C, p, st);
  }
  if (vpl <= 4) {
    return launch<4>(gout, u_seq, alpha, u0, dwx, partials, dalpha, du0, B,
                     T, C, p, st);
  }
  return launch<8>(gout, u_seq, alpha, u0, dwx, partials, dalpha, du0, B, T,
                   C, p, st);
}
