// Output-dropout keep mask for the fused spiking cells (sm_90a).
//
// Replaces: sparch_tpu/ops/pallas_cells.py `_random_keep`, its index-hash
// branch, bit for bit. The forward and the backward kernel call it with the
// same arguments and so regenerate one mask; nothing is stored.
//
// The mask of element (row b, column c) at timestep t (0-based) is
//   bits(seed0, seed1, tile_i = g / tile_rows, r = g % tile_rows, c, t)
//     < keep_u32
// with g the global batch row of b (DropRows), keep_u32 = min(2^32-1,
// round((1-p)*2^32)) computed on the host, and tile_rows the batch tile of
// ops/fused_cells.py dropout_tile_rows of the global batch. All arithmetic
// wraps in uint32. Kept values are multiplied by float32(1/(1-p)), also
// computed on the host.
//
// Under data parallelism a rank holds a contiguous slice of each segment
// of the global batch (one segment, or two where a bidirectional layer
// stacks the flipped sequence on the batch): local row b is global row
//   g = (b / seg) * stride + off + b % seg
// with seg the rank's rows a segment, stride the global rows a segment and
// off the rank's first row in it. One process: seg = stride = B, off = 0,
// so g = b and the mask is the one of the whole batch.
//
// The seed is two int32 in device memory, read by the kernel, so drawing
// it costs no host synchronisation.
#pragma once

#include <stdint.h>

namespace sparch {

// The batch tile of the hash and the map from a rank's rows to the global
// batch's (see above).
struct DropRows {
  int tile_rows;
  int seg;
  int stride;
  int off;
};

inline bool drop_rows_ok(const DropRows& m) {
  return m.tile_rows > 0 && m.seg > 0 && m.off >= 0 &&
         m.off + m.seg <= m.stride;
}

// The part of the hash input that one batch row keeps for the whole
// sequence.
__device__ __forceinline__ uint32_t dropout_row_base(const int* seed,
                                                     int row,
                                                     const DropRows& m) {
  const int g = row / m.seg * m.stride + m.off + row % m.seg;
  const uint32_t r = (uint32_t)(g % m.tile_rows);
  const uint32_t tile_i = (uint32_t)(g / m.tile_rows);
  return r * 0x9E3779B1u + (uint32_t)seed[0] * 0xC2B2AE3Du +
         (uint32_t)seed[1] + tile_i * 0x165667B1u;
}

__device__ __forceinline__ bool dropout_keep(uint32_t row_base, int col,
                                             int t, uint32_t keep_u32) {
  uint32_t z = row_base + (uint32_t)col * 0x85EBCA77u +
               (uint32_t)t * 0x27D4EB2Fu;
  z ^= z >> 16;
  z *= 0x7FEB352Du;
  z ^= z >> 15;
  z *= 0x846CA68Bu;
  z ^= z >> 16;
  return z < keep_u32;
}

}  // namespace sparch
