// Shared device helpers of the port's kernels.
//
// - The murmur3 counter RNG of the Pallas kernels
//   (letf_tpu/ops/pallas_joint.py: _mix, _bits_to_unit; pallas_compose.py:
//   _stream_bits), bit-exact with letf_tpu_torch/ops/rng.py.
// - Min/max/clip that propagate NaN like XLA's and torch's maximum/minimum
//   (fmaxf/fminf drop a NaN operand, which would change the strategies'
//   NaN warm-up semantics).
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define LETF_GOLD 0x9E3779B9u
#define LETF_M1 0x85EBCA6Bu
#define LETF_M2 0xC2B2AE35u
#define LETF_DAY_PRIME 0x7FEB352Du
#define LETF_TWO_PI 6.283185307179586f

static __device__ __forceinline__ uint32_t letf_mix(uint32_t x) {
  x ^= x >> 16;
  x *= LETF_M1;
  x ^= x >> 13;
  x *= LETF_M2;
  x ^= x >> 16;
  return x;
}

// uint32 -> (0, 1): top 24 bits + half-ulp offset.
static __device__ __forceinline__ float letf_unit(uint32_t bits) {
  return (float)(bits >> 8) * (1.0f / 16777216.0f) + (0.5f / 16777216.0f);
}

// Uniform of draw index idx under a (trial, day) counter key.
static __device__ __forceinline__ float letf_stream_unit(uint32_t day_key,
                                                         uint32_t idx) {
  return letf_unit(letf_mix(day_key + LETF_GOLD * idx));
}

static __device__ __forceinline__ uint32_t letf_lane_key(int id, uint32_t s0) {
  return letf_mix(((uint32_t)id * LETF_GOLD) ^ s0);
}

static __device__ __forceinline__ uint32_t letf_day_key(uint32_t lane_key,
                                                        uint32_t day,
                                                        uint32_t s1) {
  return letf_mix(lane_key ^ (day * LETF_DAY_PRIME) ^ s1);
}

static __device__ __forceinline__ float jmax(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : fmaxf(a, b));
}
static __device__ __forceinline__ float jmin(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : fminf(a, b));
}
static __device__ __forceinline__ float jclip(float x, float lo, float hi) {
  return jmin(jmax(x, lo), hi);
}
// 0/1 float of a predicate (NaN compares are already false).
static __device__ __forceinline__ float f01(bool p) { return p ? 1.0f : 0.0f; }

// What the card gives kernel fn at a launch of `threads` threads and
// `dyn_smem` bytes of dynamic shared memory, into out[7]: registers a
// thread, static shared bytes, dynamic shared bytes, local (spill) bytes a
// thread, threads a block, resident blocks an SM, resident warps an SM.
// Each source's letf_info_* entry calls it for its kernels (info.cu).
static inline int letf_fill_info(const void* fn, int threads, int dyn_smem,
                                 int* out) {
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, fn);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, threads,
                                                      (size_t)dyn_smem);
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.sharedSizeBytes;
  out[2] = dyn_smem;
  out[3] = (int)a.localSizeBytes;
  out[4] = threads;
  out[5] = blocks;
  out[6] = blocks * ((threads + 31) / 32);
  return 0;
}
