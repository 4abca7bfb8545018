// Kernel K2: per-trial random-start window, out[s, b] = x[s + off[b], b]
// (+ bias[b]), up to six channels per launch.
//
// Replaces letf_tpu/ops/pallas_window.py::_window_kernel_4d (pallas_call at
// pallas_window.py:275, entry window_offsets_slab) and its transpose
// fallback _window_kernel (pallas_call at :353, via _window_tiles). On the
// TPU a gather was ~20x the cost of the surrounding math, so those kernels
// built the shift from a log2(max_off)-level shift-select tree with
// lookahead tails. The result here is bitwise the gather (NaN payloads
// included); a channel without a bias is copied without an add, so -0.0
// and NaN payloads survive. The plain PyTorch version is
// ops/window.py::window_plain.
//
// What bounds it on the H100: memory traffic, one read and one write of
// each [S, B] channel (3 GB each way for six 30-year channels at
// B = 16,384; 1.8 ms at 3.35 TB/s). A direct offset load (the first port)
// has each lane of a warp on its own row, so a 32-byte sector brings 4
// useful bytes: ~8x the bytes, 19.5 ms. Here a block takes one channel and
// a strip of 32 consecutive trials, one 128-byte line of each [T, B] row,
// reduces the strip's offsets to lo = min, hi = max, and streams the input
// rows lo .. hi + S - 1 into a shared-memory ring with cp.async, several
// batches in flight, while its warps emit the output rows whose inputs have
// arrived: row s of lane b is ring[(s + off[b] - lo) mod rows][b]. Reads
// are whole lines read once, (S + hi - lo) / S of the useful bytes (at most
// 1.17x at T - S = 1,260), writes are whole lines, and each lane reads its
// own ring column (no bank conflicts). The ring takes 225 KB of shared
// memory, one block an SM, so the grid is persistent: one block an SM
// walking over the (strip, channel) items. A strip whose span hi - lo + 1
// is more than the ring holds is taken as narrower sub-strips of 16, 8, ...
// trials (a sub-strip of one trial always fits); the ragged last strip is
// masked.

#include <limits.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kMaxCh = 6;
constexpr int kThreads = 256;
constexpr int kSmemBytes = 225 * 1024;             // the ring
constexpr int kRingFloats = kSmemBytes / 4;
constexpr int kBatchFloats = 96 * 32;              // 12 KB a batch
constexpr int kDepth = 4;                          // batches in flight

struct WinArgs {
  const float* x[kMaxCh];
  float* out[kMaxCh];
  const float* bias[kMaxCh];
};

// The widest span a sub-strip of 2^level trials may have: the ring's rows
// less the kDepth batches loaded while the oldest needed row is still read.
__device__ __forceinline__ int max_span(int level) {
  return (kRingFloats >> level) - kDepth * (kBatchFloats >> level) + 1;
}

__device__ __forceinline__ void cp_async(float* dst, const float* src,
                                         bool vec4) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  if (vec4)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
                 "l"(src)
                 : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_wait_depth() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kDepth - 1) : "memory");
}
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// One sub-strip [b0, b0 + nb) of width w = 2^lw of one channel: input rows
// lo .. hi + S - 1 through the ring, output rows 0 .. S - 1.
__device__ void window_strip(float* ring, const float* __restrict__ x,
                             float* __restrict__ out,
                             const float* __restrict__ bias,
                             const int* __restrict__ offs, int lw, int b0,
                             int nb, int lo, int hi, int S, int B,
                             bool vec4) {
  const int w = 1 << lw;
  const int rows = kRingFloats >> lw;              // ring rows
  const int nbr = kBatchFloats >> lw;              // rows a batch
  const int nrows = hi - lo + S;                   // input rows
  const int nbatch = (nrows + nbr - 1) / nbr;
  const int v = vec4 && w >= 4 ? 4 : 1;            // floats a copy
  const int lcpr = lw - (v == 4 ? 2 : 0);          // log2 copies a row
  const int tid = threadIdx.x;

  auto issue = [&](int j) {
    const int r0 = j * nbr;
    const int r1 = min(nrows, r0 + nbr);
    if (r0 < r1) {
      const int base = r0 % rows;
      const int n = (r1 - r0) << lcpr;
      for (int i = tid; i < n; i += kThreads) {
        const int r = i >> lcpr;
        const int col = (i & ((1 << lcpr) - 1)) * v;
        if (col < nb) {
          int slot = base + r;
          if (slot >= rows) slot -= rows;
          cp_async(ring + slot * w + col,
                   x + (size_t)(lo + r0 + r) * B + b0 + col, v == 4);
        }
      }
    }
    cp_commit();
  };

  // Emission: thread (c, p) writes column c of rows p, p + P, ...
  const int c = tid & (w - 1);
  const int P = kThreads >> lw;
  const bool mine = c < nb;
  const int off = mine ? offs[b0 + c] : lo;
  const float bb = (mine && bias != nullptr) ? bias[b0 + c] : 0.0f;
  float* __restrict__ o = out + b0 + c;

#pragma unroll 1
  for (int j = 0; j < kDepth; ++j) issue(j);
  int e = 0;                                       // outputs emitted
#pragma unroll 1
  for (int j = 0; j < nbatch; ++j) {
    cp_wait_depth();
    __syncthreads();
    const int avail = min(nrows, (j + 1) * nbr);   // rows in the ring
    const int e1 = j == nbatch - 1 ? S : min(S, lo + avail - hi);
    if (mine) {
      int s = e + (tid >> lw);
      if (s < e1) {
        int slot = (s + off - lo) % rows;
        if (bias != nullptr) {
          for (; s < e1; s += P) {
            o[(size_t)s * B] = ring[slot * w + c] + bb;
            slot += P;
            if (slot >= rows) slot -= rows;
          }
        } else {
          for (; s < e1; s += P) {
            o[(size_t)s * B] = ring[slot * w + c];
            slot += P;
            if (slot >= rows) slot -= rows;
          }
        }
      }
    }
    e = max(e, e1);
    __syncthreads();
    issue(j + kDepth);
  }
  cp_wait_all();
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads, 1)
window_kernel(WinArgs a, const int* __restrict__ offs, int n_ch, int S,
              int B, int vec4) {
  extern __shared__ float4 ring4[];
  float* ring = reinterpret_cast<float*>(ring4);
  __shared__ int lo_tab[6][32], hi_tab[6][32];
  __shared__ int level_s;
  const int n_strips = (B + 31) / 32;
  const int items = n_strips * n_ch;
  const int lane = threadIdx.x & 31;
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int ch = item % n_ch, strip = item / n_ch;
    __syncthreads();            // the last item's reads of the tables done
    if (threadIdx.x < 32) {
      // Offset min/max over every aligned group of 1, 2, ..., 32 lanes,
      // then the widest group size whose spans all fit the ring.
      const int b = strip * 32 + lane;
      int mn = b < B ? offs[b] : INT_MAX;
      int mx = b < B ? offs[b] : INT_MIN;
      int level = 0;
#pragma unroll
      for (int L = 0; L < 6; ++L) {
        if (L > 0) {
          mn = min(mn, __shfl_xor_sync(0xffffffffu, mn, 1 << (L - 1)));
          mx = max(mx, __shfl_xor_sync(0xffffffffu, mx, 1 << (L - 1)));
        }
        lo_tab[L][lane] = mn;
        hi_tab[L][lane] = mx;
        const bool fits = mn > mx || mx - mn + 1 <= max_span(L);
        if (__all_sync(0xffffffffu, fits)) level = L;
      }
      if (lane == 0) level_s = level;
    }
    __syncthreads();
    const int lw = level_s;
    const int w = 1 << lw;
    for (int q = 0; q < 32; q += w) {
      const int b0 = strip * 32 + q;
      const int lo = lo_tab[lw][q], hi = hi_tab[lw][q];
      if (b0 >= B || lo > hi) break;
      window_strip(ring, a.x[ch], a.out[ch], a.bias[ch], offs, lw, b0,
                   min(w, B - b0), lo, hi, S, B, vec4 != 0);
    }
  }
}

int window_smem_attr() {
  return (int)cudaFuncSetAttribute(
      window_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
}

}  // namespace

extern "C" int letf_window(int n_ch, const void* const* xs,
                           void* const* outs, const void* const* biases,
                           const int* offs, int T, int S, int B,
                           void* stream) {
  if (n_ch < 1 || n_ch > kMaxCh) return (int)cudaErrorInvalidValue;
  WinArgs a;
  bool vec4 = B % 4 == 0;
  for (int c = 0; c < kMaxCh; ++c) {
    a.x[c] = c < n_ch ? (const float*)xs[c] : nullptr;
    a.out[c] = c < n_ch ? (float*)outs[c] : nullptr;
    a.bias[c] = c < n_ch ? (const float*)biases[c] : nullptr;
    if (c < n_ch && ((uintptr_t)a.x[c] & 15) != 0) vec4 = false;
  }
  if (B > 0 && S > 0) {
    // A shared-memory size the card refuses is an error, never a fallback.
    const int err = window_smem_attr();
    if (err != 0) return err;
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    const int items = (B + 31) / 32 * n_ch;
    const int grid = items < sms ? items : sms;
    window_kernel<<<grid, kThreads, kSmemBytes, (cudaStream_t)stream>>>(
        a, offs, n_ch, S, B, (int)vec4);
  }
  return (int)cudaGetLastError();
}

extern "C" int letf_info_window(int* out) {
  const int err = window_smem_attr();
  if (err != 0) return err;
  return letf_fill_info((const void*)window_kernel, kThreads, kSmemBytes,
                        out);
}
