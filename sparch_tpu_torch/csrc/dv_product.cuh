// The dV products of the recurrent backward kernels for Hopper (sm_90a),
// run after their time loops: one kernel, dv_kernel, instantiated for the
// spiking backwards (fused_cell_bwd.cu, tp_cell_bwd.cu) and the
// non-spiking ones (fused_ann_bwd.cu, tp_ann_bwd.cu). It replaces the dV
// part of the TPU backward kernels (sparch_tpu/ops/pallas_cells.py
// `_bwd_kernel`, pallas_ann.py `_ann_bwd_kernel`, pallas_tp.py
// `_tp_bwd_kernel`, pallas_tp_ann.py `_tp_ann_bwd_kernel`), which sum it in
// VMEM a step at a time.
//
// dV = sum over rows q = (b, t) of left_q^T dpre_q: an (H, B*T) x (B*T, H)
// product whose left operand comes from the forward's series (the spikes
// s_{t-1} = u_{t-1} > thr, s0 at t = 0; the non-spiking y_{t-1}, times r_t
// for the GRU's candidate, y0 at t = 0) and whose right operand is the
// stored dDrive or dpre series. The rows are cut into ksplit splits of
// dv_rows_per_split rows (ops/fused_ann.py `_dv_split` sets ksplit). Each
// output element is one fmaf chain over its split's rows in ascending
// (b, t), from +0; sum_parts_kernel (tile_stream.cuh) adds the splits in
// ascending order, and with one split the product writes dV itself (a
// chain never ends on -0, so the pass would copy its bits). Tiles and
// stages change no bit: the chains are the same.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "tile_stream.cuh"

namespace sparch {

constexpr int kBK = 16;  // a split's rows are a multiple of this

// Rows per split: a multiple of kBK.
inline int dv_rows_per_split(int R, int ksplit) {
  const int rows = (R + ksplit - 1) / ksplit;
  return (rows + kBK - 1) / kBK * kBK;
}

// ---------------------------------------------------------------------------
// A dense product, FMAs on the CUDA cores (tensor cores would sum in
// another order). The spiking left operand is 0 or 1 but at t = 0 and is
// not skipped: a product that walks the spikes grows with the firing rate
// (trained layers fire at 8-27 %) and lost to this one past ~15 %. A
// block owns a BM x BN tile of one gate's dV for one split, a thread TM x
// TN outputs; stages of SK rows of both operands go through registers into
// two shared-memory buffers: the next stage's loads (16-byte, or 8 in
// bf16) are in flight while this one is summed, and on their way in the
// left operand is formed once a stage element (the spike u_{t-1} > thr or
// s0; y_{t-1} or y0, times r_t for the GRU's candidate; rounded to bf16 in
// that mode) and bf16 widened. (b, t) of a thread's rows advance a stage
// at a time; a stage past a split's end is masked (its right operand is
// 0, so whatever its left one, the chain keeps its value).
// Bound: 2 * gates * B*T * H^2 float32 operations (the spiking product:
// bytes, and 2 * H operations a spike).
struct DvArgs {
  const void* left;     // the left operand's series: y_seq (float, bf16 in
                        // the bf16 mode) or the spiking u_seq (float)
  const float* left0;   // its row at t = 0: y0, or s0
  const void* r;        // the GRU's reset series, else null
  const void* dpre[3];  // the right operand, by gate (float, bf16 in the
                        // bf16 mode)
  float* out;           // dV (gates, H, H), or with ksplit > 1 the
                        // partials (ksplit, gates, H, H)
  float thr;            // the spiking threshold
  int T;
  int H;
  int R;                // B*T
  int rows_per_split;
  int G;
  int vec;              // H % 4 == 0 and every operand 16-byte aligned
};

// The tiles (dV rows x columns a block), largest first; launch_dv gives
// each its outputs a thread and stage depth.
constexpr int kDvTiles = 3;
constexpr int kDvTileM[kDvTiles] = {128, 128, 64};
constexpr int kDvTileN[kDvTiles] = {128, 64, 64};

// The tile plan (ops/fused_ann.py `_dv_tile` computes the same): among the
// tiles whose grid gives each of the card's sms SMs a block, the one whose
// last round of blocks is fullest (blocks / (sms * ceil(blocks / sms))),
// the larger on a tie; where none does, the smallest.
inline int dv_tile(int H, int G, int ksplit, int sms) {
  int best = -1;
  long long best_blocks = 0, best_rounds = 1;
  for (int i = 0; i < kDvTiles; ++i) {
    const long long blocks = (long long)G * ksplit *
                             ((H + kDvTileM[i] - 1) / kDvTileM[i]) *
                             ((H + kDvTileN[i] - 1) / kDvTileN[i]);
    if (blocks < sms) continue;
    const long long rounds = (blocks + sms - 1) / sms;
    if (best < 0 || blocks * best_rounds > best_blocks * rounds) {
      best = i;
      best_blocks = blocks;
      best_rounds = rounds;
    }
  }
  return best < 0 ? kDvTiles - 1 : best;
}

// The SMs of the current card, which the tile plan fills; 0 if unknown.
inline int device_sms() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess) {
    return 0;
  }
  return sms;
}

// Whether `tile` is the plan's for this card (the wrappers compute it from
// torch's count of the card's SMs).
inline bool dv_tile_ok(int tile, int H, int G, int ksplit) {
  const int sms = device_sms();
  return sms > 0 && tile == dv_tile(H, G, ksplit, sms);
}

// Four consecutive elements as raw bits (a float's each, or two bf16 a
// word); those at or past `left` are 0. vec: one 16- (8-) byte load.
template <typename ST>
__device__ __forceinline__ uint4 load4(const ST* p, int left, bool vec) {
  if constexpr (sizeof(ST) == 4) {
    if (vec) return __ldg(reinterpret_cast<const uint4*>(p));
    uint32_t e[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (c < left) e[c] = __float_as_uint(p[c]);
    }
    return make_uint4(e[0], e[1], e[2], e[3]);
  } else {
    if (vec) {
      const uint2 h = __ldg(reinterpret_cast<const uint2*>(p));
      return make_uint4(h.x, h.y, 0u, 0u);
    }
    const unsigned short* q = reinterpret_cast<const unsigned short*>(p);
    uint32_t e[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (c < left) e[c] = q[c];
    }
    return make_uint4(e[0] | e[1] << 16, e[2] | e[3] << 16, 0u, 0u);
  }
}
// The four floats of load4's bits.
template <typename ST>
__device__ __forceinline__ void unpack4(uint4 v, float* x) {
  if constexpr (sizeof(ST) == 4) {
    x[0] = __uint_as_float(v.x);
    x[1] = __uint_as_float(v.y);
    x[2] = __uint_as_float(v.z);
    x[3] = __uint_as_float(v.w);
  } else {
    x[0] = __uint_as_float(v.x << 16);
    x[1] = __uint_as_float(v.x & 0xffff0000u);
    x[2] = __uint_as_float(v.y << 16);
    x[3] = __uint_as_float(v.y & 0xffff0000u);
  }
}

// out[split][gate][m][n] = the chain over the rows q of the split,
// ascending, of left[q][m] * dpre_gate[q][n]. kSpike: left = u_{t-1}[b] >
// thr ? 1 : 0 (s0 at t = 0), else left = y_{t-1}[b] (y0 at t = 0), times
// r_t[b] for the GRU's candidate (gate 0). ST is the element type of the
// right operand and of y; with bf16 the left operand is rounded to bf16
// too, and the sum is float32.
template <bool kSpike, typename ST, int BM, int BN, int TM, int TN, int SK>
__global__ void __launch_bounds__(BM / TM * (BN / TN))
dv_kernel(const DvArgs a) {
  constexpr int NT = BM / TM * (BN / TN);  // threads
  constexpr int kTx = BN / TN;              // threads along n
  constexpr int kAChunks = SK * BM / 4 / NT;  // 4-element pieces of a
  constexpr int kBChunks = SK * BN / 4 / NT;  // stage of A and of B
  constexpr int kAStep = NT / (BM / 4);       // rows between a thread's
  constexpr int kBStep = NT / (BN / 4);       // pieces
  constexpr int GA = BM / (TM / 4);  // a thread's rows: TM / 4 groups of 4,
  constexpr int GB = BN / (TN / 4);  // GA apart; its columns alike
  constexpr bool kBf = sizeof(ST) == 2;
  using LT = typename std::conditional<kSpike, float, ST>::type;
  static_assert(kAChunks * kAStep == SK && kBChunks * kBStep == SK &&
                    SK % kBK == 0,
                "a stage is SK rows, a multiple of a split's rounding");
  extern __shared__ __align__(16) float dv_smem[];
  float(*As)[SK][BM] = reinterpret_cast<float(*)[SK][BM]>(dv_smem);
  float(*Bs)[SK][BN] =
      reinterpret_cast<float(*)[SK][BN]>(dv_smem + 2 * SK * BM);
  const int tid = threadIdx.x;
  const int tx = tid % kTx;
  const int ty = tid / kTx;
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int gate = blockIdx.z % a.G;
  const int split = blockIdx.z / a.G;
  const int H = a.H;
  const int T = a.T;
  const bool vec = a.vec != 0;
  const ST* dd = static_cast<const ST*>(
      gate == 0 ? a.dpre[0] : gate == 1 ? a.dpre[1] : a.dpre[2]);
  const LT* ys = static_cast<const LT*>(a.left);
  const ST* rs = !kSpike && a.r != nullptr && gate == 0
                     ? static_cast<const ST*>(a.r)
                     : nullptr;
  const int q_begin = split * a.rows_per_split;
  const int q_end = min(a.R, q_begin + a.rows_per_split);
  const int n_stages =
      q_begin < q_end ? (q_end - q_begin + SK - 1) / SK : 0;
  const int acol = (tid % (BM / 4)) * 4;
  const int arow = tid / (BM / 4);
  const int bcol = (tid % (BN / 4)) * 4;
  const int brow = tid / (BN / 4);
  // (t, b) of this thread's rows of A in the stage being loaded
  int tq[kAChunks], bq[kAChunks];
#pragma unroll
  for (int i = 0; i < kAChunks; ++i) {
    const int q = q_begin + arow + i * kAStep;
    tq[i] = q % T;
    bq[i] = q / T;
  }
  uint4 ya[kAChunks], ra[kAChunks], yb[kBChunks];
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  }
  // s = -1 loads and stores stage 0; stage s + 1 is loaded before stage s
  // is summed and stored after it
  for (int s = -1; s < n_stages; ++s) {
    const bool more = s + 1 < n_stages;
    if (more) {
      const int q0 = q_begin + (s + 1) * SK;
#pragma unroll
      for (int i = 0; i < kAChunks; ++i) {
        const int q = q0 + arow + i * kAStep;
        const int m = m0 + acol;
        ya[i] = ra[i] = make_uint4(0u, 0u, 0u, 0u);
        if (q < q_end && m < H) {
          ya[i] = tq[i] == 0
                      ? load4(a.left0 + (size_t)bq[i] * H + m, H - m, vec)
                      : load4(ys + (size_t)(q - 1) * H + m, H - m, vec);
          if (rs != nullptr) {
            ra[i] = load4(rs + (size_t)q * H + m, H - m, vec);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < kBChunks; ++i) {
        const int q = q0 + brow + i * kBStep;
        const int n = n0 + bcol;
        yb[i] = q < q_end && n < H
                    ? load4(dd + (size_t)q * H + n, H - n, vec)
                    : make_uint4(0u, 0u, 0u, 0u);
      }
    }
    if (s >= 0) {
      const int buf = s & 1;
#pragma unroll
      for (int kk = 0; kk < SK; ++kk) {
        float av[TM], bv[TN];
#pragma unroll
        for (int g = 0; g < TM / 4; ++g) {
          const float4 v =
              *reinterpret_cast<const float4*>(&As[buf][kk][g * GA + ty * 4]);
          av[4 * g] = v.x;
          av[4 * g + 1] = v.y;
          av[4 * g + 2] = v.z;
          av[4 * g + 3] = v.w;
        }
#pragma unroll
        for (int g = 0; g < TN / 4; ++g) {
          const float4 v =
              *reinterpret_cast<const float4*>(&Bs[buf][kk][g * GB + tx * 4]);
          bv[4 * g] = v.x;
          bv[4 * g + 1] = v.y;
          bv[4 * g + 2] = v.z;
          bv[4 * g + 3] = v.w;
        }
#pragma unroll
        for (int i = 0; i < TM; ++i) {
#pragma unroll
          for (int j = 0; j < TN; ++j) {
            acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
          }
        }
      }
    }
    if (more) {
      // the left operand formed, the right one widened; then the rows'
      // (t, b) advance a stage
      const int buf = (s + 1) & 1;
#pragma unroll
      for (int i = 0; i < kAChunks; ++i) {
        float y[4];
        if (tq[i] == 0) {
          unpack4<float>(ya[i], y);
        } else {
          unpack4<LT>(ya[i], y);
          if (kSpike) {
#pragma unroll
            for (int c = 0; c < 4; ++c) y[c] = y[c] > a.thr ? 1.f : 0.f;
          }
        }
        if (rs != nullptr) {
          float rv[4];
          unpack4<ST>(ra[i], rv);
#pragma unroll
          for (int c = 0; c < 4; ++c) y[c] *= rv[c];
        }
        if (kBf) {
#pragma unroll
          for (int c = 0; c < 4; ++c) y[c] = round_bf16(y[c]);
        }
        *reinterpret_cast<float4*>(&As[buf][arow + i * kAStep][acol]) =
            make_float4(y[0], y[1], y[2], y[3]);
        tq[i] += SK;
        while (tq[i] >= T) {
          tq[i] -= T;
          ++bq[i];
        }
      }
#pragma unroll
      for (int i = 0; i < kBChunks; ++i) {
        float x[4];
        unpack4<ST>(yb[i], x);
        *reinterpret_cast<float4*>(&Bs[buf][brow + i * kBStep][bcol]) =
            make_float4(x[0], x[1], x[2], x[3]);
      }
    }
    __syncthreads();
  }

  float* out = a.out + ((size_t)split * a.G + gate) * H * H;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + (i / 4) * GA + ty * 4 + i % 4;
    if (m >= H) continue;
#pragma unroll
    for (int h = 0; h < TN / 4; ++h) {
      const int n = n0 + h * GB + tx * 4;
      if (vec && n < H) {
        *reinterpret_cast<float4*>(&out[(size_t)m * H + n]) =
            make_float4(acc[i][h * 4], acc[i][h * 4 + 1], acc[i][h * 4 + 2],
                        acc[i][h * 4 + 3]);
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          if (n + c < H) out[(size_t)m * H + n + c] = acc[i][h * 4 + c];
        }
      }
    }
  }
}

template <bool kSpike, typename ST, int BM, int BN, int TM, int TN, int SK>
cudaError_t launch_tile(const DvArgs& a, dim3 grid, cudaStream_t st) {
  const auto kernel = dv_kernel<kSpike, ST, BM, BN, TM, TN, SK>;
  const int smem = 2 * SK * (BM + BN) * (int)sizeof(float);
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, BM / TM * (BN / TN), smem, st>>>(a);
  return cudaGetLastError();
}

// The dV product of a backward, as it launches it: into dV with one
// split, else into dv_partials, which sum_parts_kernel then adds into dV.
// a.out and a.vec are set here; tile: the plan's (dv_tile), checked by
// the caller.
template <bool kSpike, typename ST>
cudaError_t launch_dv(DvArgs a, float* dV, float* dv_partials, int tile,
                      int ksplit, cudaStream_t st) {
  const auto aligned = [](const void* p) {
    return p == nullptr || reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  a.out = ksplit == 1 ? dV : dv_partials;
  a.vec = a.H % 4 == 0 && aligned(a.left) && aligned(a.left0) &&
          aligned(a.r) && aligned(a.out);
  for (int k = 0; k < a.G; ++k) a.vec = a.vec && aligned(a.dpre[k]);
  const int bm = kDvTileM[tile];
  const int bn = kDvTileN[tile];
  const dim3 grid((a.H + bn - 1) / bn, (a.H + bm - 1) / bm, a.G * ksplit);
  // per tile: outputs a thread and rows a stage (each thread sums 1024
  // products a stage; 128 x 64 at 8 x 8 and 64 x 64 at 4 x 4 with 64-row
  // stages were the fastest of the shapes tried at GRU 1024 and 512)
  cudaError_t err;
  if (tile == 0) {
    err = launch_tile<kSpike, ST, 128, 128, 8, 8, 16>(a, grid, st);
  } else if (tile == 1) {
    err = launch_tile<kSpike, ST, 128, 64, 8, 8, 16>(a, grid, st);
  } else {
    err = launch_tile<kSpike, ST, 64, 64, 4, 4, 64>(a, grid, st);
  }
  if (err != cudaSuccess || ksplit == 1) return err;
  const int n = a.G * a.H * a.H;
  sum_parts_kernel<<<(n + 255) / 256, 256, 0, st>>>(dv_partials, dV, ksplit,
                                                    n);
  return cudaGetLastError();
}

// The spiking product of a backward: left = u_seq > thr (s0 at t = 0),
// right = the dDrive series dd, one gate.
template <typename DT>
cudaError_t launch_spike_dv(const float* u_seq, const float* s0,
                            const DT* dd, float thr, float* dV,
                            float* dv_partials, int T, int H, int R,
                            int tile, int ksplit, cudaStream_t st) {
  const DvArgs a{u_seq, s0, nullptr, {dd, nullptr, nullptr}, nullptr, thr,
                 T, H, R, dv_rows_per_split(R, ksplit), 1, 0};
  return launch_dv<true, DT>(a, dV, dv_partials, tile, ksplit, st);
}

// CUDA events around the launches of one backward call, where the caller
// asks for their milliseconds (split_ms): mark(i) before launch i, mark(n)
// after the last; report() waits for the last and writes the n times.
struct Split {
  cudaEvent_t ev[4] = {nullptr, nullptr, nullptr, nullptr};
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
  void report(float* ms, int n) {
    if (!on) return;
    cudaEventSynchronize(ev[n]);
    for (int i = 0; i < n; ++i) cudaEventElapsedTime(&ms[i], ev[i], ev[i + 1]);
  }
};

}  // namespace sparch
