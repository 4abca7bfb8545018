// Kernel K7: per-column stable merge of two ascending halves by (key, sec),
// carrying payload columns.
//
// Replaces letf_tpu/ops/pallas_sort.py::_merge_kernel (pallas_call at
// pallas_sort.py:122, entries sort_bridge / sort_bridge_donate) for the tax
// bridge's "merge" and "valley" sorts. The TPU kernel ran a bitonic
// network on whole VMEM-resident rows. Here each element finds its output
// position directly (a rank merge): its index in its own half plus the
// number of elements of the other half that precede it, found by binary
// search. Elements of the first half precede equal elements of the second
// (stable), so the result is the stable sort of the column by (key, sec)
// -- bitwise lax.sort(num_keys=2, is_stable=True), which the bridge's
// unique (key, sec) pairs make equal to the TPU network's output. Keys
// and secondaries compare as int32 (a non-negative float32 key's bits are
// order-preserving); payloads are moved as 32-bit words. The plain PyTorch
// version is ops/sort_bridge.py::sort_bridge_plain.
//
// Layout [N, R], N = 2 S rows (the halves), R columns (one per trial,
// contiguous), as the bridge keeps its per-day tensors. What bounds it on
// the H100: memory latency of the binary searches (log2 S ~ 13 dependent
// loads of key and sec per element; the first steps coalesce across a
// warp, the later ones scatter) and the scattered 4-byte stores; nothing
// is computed. One thread per element, 128 columns per block.

#include "common.cuh"

namespace {

constexpr int kMaxArr = 8;   // key, sec, up to six payloads

struct MergeArgs {
  const int* in[kMaxArr];
  int* out[kMaxArr];
};

// (ka, sa) < (kb, sb), lexicographic.
__device__ __forceinline__ bool lex_less(int ka, int sa, int kb, int sb) {
  return ka < kb || (ka == kb && sa < sb);
}

__global__ void merge_kernel(MergeArgs a, int n_arr, int has_sec, int S,
                             int R) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  const int* __restrict__ key = a.in[0];
  const int* __restrict__ sec = has_sec ? a.in[1] : nullptr;
  for (int i = blockIdx.y; i < 2 * S; i += gridDim.y) {
    const int h = i >= S ? 1 : 0;
    const int j = i - h * S;
    const int o = (1 - h) * S;
    const size_t at = (size_t)i * R + r;
    const int k = key[at];
    const int s = has_sec ? sec[at] : 0;
    // Number of other-half elements placed before this one: strictly
    // smaller ones for a first-half element, smaller-or-equal ones for a
    // second-half element.
    int lo = 0, hi = S;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      const size_t ax = (size_t)(o + mid) * R + r;
      const int kx = key[ax];
      const int sx = has_sec ? sec[ax] : 0;
      const bool before = h == 0 ? lex_less(kx, sx, k, s)
                                 : !lex_less(k, s, kx, sx);
      if (before)
        lo = mid + 1;
      else
        hi = mid;
    }
    const size_t to = (size_t)(j + lo) * R + r;
    for (int c = 0; c < n_arr; ++c) a.out[c][to] = a.in[c][at];
  }
}

}  // namespace

// ins/outs: n_arr column-major [2 S, R] arrays of 32-bit words (key first,
// then sec when has_sec, then payloads).
extern "C" int letf_merge(int n_arr, const void* const* ins,
                          void* const* outs, int has_sec, int S, int R,
                          void* stream) {
  if (n_arr < 1 || n_arr > kMaxArr || (has_sec && n_arr < 2))
    return (int)cudaErrorInvalidValue;
  MergeArgs a;
  for (int c = 0; c < kMaxArr; ++c) {
    a.in[c] = c < n_arr ? (const int*)ins[c] : nullptr;
    a.out[c] = c < n_arr ? (int*)outs[c] : nullptr;
  }
  const int threads = 128;
  dim3 grid((R + threads - 1) / threads, 2 * S < 65535 ? 2 * S : 65535);
  if (S > 0 && R > 0) {
    merge_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(a, n_arr,
                                                             has_sec, S, R);
  }
  return (int)cudaGetLastError();
}

extern "C" int letf_info_merge(int* out) {
  return letf_fill_info((const void*)merge_kernel, 128, 0, out);
}
