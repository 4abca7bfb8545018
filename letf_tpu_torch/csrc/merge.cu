// Kernel K7: per-column stable merge of two ascending halves by (key, sec),
// carrying payload columns.
//
// Replaces letf_tpu/ops/pallas_sort.py::_merge_kernel (pallas_call at
// pallas_sort.py:122, entries sort_bridge / sort_bridge_donate) for the tax
// bridge's "merge" and "valley" sorts. The TPU kernel ran a bitonic
// network on whole VMEM-resident rows. Here one block merges one trial:
//
// 1. to_trial_major: each array's two halves ([S, R] day-major each, the
//    bridge's layout, trials contiguous) are transposed through 32 x 32
//    shared-memory tiles into a trial-major scratch [R, 2S], head at
//    columns [0, S), tail at [S, 2S). A payload whose head is all zero
//    (head_zero) has only its tail moved.
// 2. merge_trial, one block a trial: the trial's key and sec rows are
//    staged in dynamic shared memory; each thread finds where its run of
//    outputs starts on the merge path (a binary search over the two
//    halves in shared memory), merges its run sequentially and writes the
//    output permutation (uint16, in shared memory, or in device scratch
//    where the halves leave no room: beyond ~46 years); then every array
//    moves through the permutation, its row staged in shared memory, with
//    coalesced stores back into the scratch row.
// 3. The scratch rows are transposed back to the [2S, R] outputs.
//
// Every device-memory access is a coalesced row. Elements of the first
// half precede equal elements of the second (stable), so the result is
// the stable sort of the column by (key, sec) -- bitwise
// lax.sort(num_keys=2, is_stable=True), which the bridge's unique (key,
// sec) pairs make equal to the TPU network's output. Keys and secondaries
// compare as int32 (a non-negative float32 key's bits are order-
// preserving); payloads move as 32-bit words. The plain PyTorch version is
// ops/sort_bridge.py::sort_bridge_plain.
//
// Limits: the trial's key and sec rows must fit in a block's shared memory
// (8 bytes an element with sec, 4 without: S <= 14,528 days with sec) and
// the permutation in uint16 (2S <= 65,536). The wrapper raises beyond.

#include "common.cuh"

namespace {

constexpr int kMaxArr = 8;            // key, sec, up to six payloads
constexpr int kTile = 32;             // transpose tile edge
constexpr int kTileRows = 8;          // transpose block: 32 x 8 threads
constexpr int kMergeThreads = 1024;
constexpr int kMaxSmem = 232448;      // dynamic shared bytes a block can use

// One transpose: dst[c * dst_stride + col0 + r] = src[r * src_stride + c]
// for r < rows, c < cols.
struct Job {
  const int* src;
  int* dst;
  int src_stride, dst_stride, col0;
};
struct Jobs {
  Job job[2 * kMaxArr];
  int rows, cols;
};

__global__ void __launch_bounds__(kTile * kTileRows)
    transpose_kernel(const __grid_constant__ Jobs jobs) {
  __shared__ int tile[kTile][kTile + 1];
  const Job& j = jobs.job[blockIdx.z];
  const int c0 = blockIdx.x * kTile, r0 = blockIdx.y * kTile;
  for (int y = threadIdx.y; y < kTile; y += kTileRows) {
    const int r = r0 + y, c = c0 + threadIdx.x;
    if (r < jobs.rows && c < jobs.cols)
      tile[y][threadIdx.x] = j.src[(size_t)r * j.src_stride + c];
  }
  __syncthreads();
  for (int y = threadIdx.y; y < kTile; y += kTileRows) {
    const int c = c0 + y, r = r0 + threadIdx.x;
    if (r < jobs.rows && c < jobs.cols)
      j.dst[(size_t)c * j.dst_stride + j.col0 + r] = tile[threadIdx.x][y];
  }
}

// (ka, sa) < (kb, sb), lexicographic.
__device__ __forceinline__ bool lex_less(int ka, int sa, int kb, int sb) {
  return ka < kb || (ka == kb && sa < sb);
}

// Block-wide copy of len words from device to shared memory, two words a
// load where both ends are 8-byte aligned.
__device__ __forceinline__ void stage(int* dst, const int* src, int len) {
  if (((reinterpret_cast<uintptr_t>(dst) | reinterpret_cast<uintptr_t>(src))
       & 7) == 0) {
    const int2* s2 = reinterpret_cast<const int2*>(src);
    int2* d2 = reinterpret_cast<int2*>(dst);
#pragma unroll 4
    for (int k = threadIdx.x; k < len / 2; k += blockDim.x) d2[k] = s2[k];
    if ((len & 1) && threadIdx.x == 0) dst[len - 1] = src[len - 1];
  } else {
#pragma unroll 4
    for (int k = threadIdx.x; k < len; k += blockDim.x) dst[k] = src[k];
  }
}

// One block merges trial blockIdx.x of the trial-major scratch tm
// ([n_arr, R, 2S] words: key, sec when has_sec, payloads) in place.
// perm_dev: [R, 2S] uint16 device scratch, or null to keep the
// permutation in shared memory after the key and sec rows.
__global__ void __launch_bounds__(kMergeThreads)
    merge_trial(int* __restrict__ tm, int n_arr, int has_sec,
                unsigned head_zero, int S, int R,
                uint16_t* __restrict__ perm_dev) {
  extern __shared__ int smem[];
  const int n = 2 * S;
  const size_t plane = (size_t)R * n;
  int* ks = smem;
  int* ss = smem + n;
  uint16_t* perm = perm_dev != nullptr
      ? perm_dev + (size_t)blockIdx.x * n
      : reinterpret_cast<uint16_t*>(smem + (1 + has_sec) * n);
  int* key_row = tm + (size_t)blockIdx.x * n;
  stage(ks, key_row, n);
  if (has_sec) stage(ss, key_row + plane, n);
  __syncthreads();

  // This thread's outputs [d0, d1): the merge path's split at diagonal
  // d0 takes i elements of the head and d0 - i of the tail, i the first
  // head index whose element does not precede tail element d0 - 1 - i.
  const int per = (n + blockDim.x - 1) / blockDim.x;
  const int d0 = min(n, (int)threadIdx.x * per), d1 = min(n, d0 + per);
  if (d0 < d1) {
    int lo = max(0, d0 - S), hi = min(d0, S);
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      const int b = S + d0 - 1 - mid;
      const bool b_first = has_sec ? lex_less(ks[b], ss[b], ks[mid], ss[mid])
                                   : ks[b] < ks[mid];
      if (!b_first)
        lo = mid + 1;
      else
        hi = mid;
    }
    int i = lo, j = S + d0 - lo;
    for (int k = d0; k < d1; ++k) {
      bool take_tail = i >= S;
      if (!take_tail && j < n)
        take_tail = has_sec ? lex_less(ks[j], ss[j], ks[i], ss[i])
                            : ks[j] < ks[i];
      perm[k] = (uint16_t)(take_tail ? j : i);
      if (take_tail)
        ++j;
      else
        ++i;
    }
  }
  __syncthreads();

  for (int k = threadIdx.x; k < n; k += blockDim.x) key_row[k] = ks[perm[k]];
  if (has_sec) {
    int* sec_row = key_row + plane;
    for (int k = threadIdx.x; k < n; k += blockDim.x)
      sec_row[k] = ss[perm[k]];
  }
  for (int c = 1 + has_sec; c < n_arr; ++c) {
    const bool hz = (head_zero >> c) & 1u;
    int* row = tm + c * plane + (size_t)blockIdx.x * n;
    __syncthreads();               // every read of ks done
    if (hz)
      stage(ks + S, row + S, S);
    else
      stage(ks, row, n);
    __syncthreads();
    for (int k = threadIdx.x; k < n; k += blockDim.x) {
      const int p = perm[k];
      row[k] = (hz && p < S) ? 0 : ks[p];
    }
  }
}

// Shared bytes of merge_trial: the key (and sec) rows, and the
// permutation where it fits beside them (ops/sort_bridge.py mirrors it).
int merge_smem(int S, int has_sec, int* perm_in_smem) {
  const long rows = (long)(1 + has_sec) * 2 * S * 4;
  const long with_perm = rows + 2L * 2 * S;
  *perm_in_smem = with_perm <= kMaxSmem;
  return (int)(*perm_in_smem ? with_perm : rows);
}

}  // namespace

// n_arr arrays (key first, then sec when has_sec, then payloads), each as
// its two halves: heads[c] and tails[c] [S, R] (heads[c] unused where bit
// c of head_zero is set: that payload's head is all zero), outs[c]
// [2S, R]. tm: [n_arr, R, 2S] words of device scratch; perm_dev: [R, 2S]
// uint16 of device scratch where the permutation does not fit in shared
// memory (merge_smem says when), else null.
extern "C" int letf_merge(int n_arr, const void* const* heads,
                          const void* const* tails, void* const* outs,
                          int has_sec, unsigned head_zero, int S, int R,
                          void* tm, void* perm_dev, void* stream) {
  if (n_arr < 1 || n_arr > kMaxArr || (has_sec && n_arr < 2) || S < 0 ||
      R < 0 || 2L * S > 65536 || (R + kTile - 1) / kTile > 65535 ||
      (head_zero & (has_sec ? 3u : 1u)))
    return (int)cudaErrorInvalidValue;
  int in_smem = 0;
  const int smem = merge_smem(S, has_sec, &in_smem);
  if (smem > kMaxSmem || (!in_smem && perm_dev == nullptr))
    return (int)cudaErrorInvalidValue;
  if (S == 0 || R == 0) return (int)cudaSuccess;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        merge_trial, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  cudaStream_t st = (cudaStream_t)stream;
  const int n = 2 * S;
  const size_t plane = (size_t)R * n;
  int* scratch = (int*)tm;
  const dim3 threads(kTile, kTileRows);

  Jobs in{};
  int n_jobs = 0;
  for (int c = 0; c < n_arr; ++c) {
    for (int h = (head_zero >> c) & 1u; h < 2; ++h) {
      in.job[n_jobs++] = Job{(const int*)(h ? tails[c] : heads[c]),
                             scratch + c * plane, R, n, h * S};
    }
  }
  in.rows = S;
  in.cols = R;
  transpose_kernel<<<dim3((R + kTile - 1) / kTile, (S + kTile - 1) / kTile,
                          n_jobs), threads, 0, st>>>(in);

  merge_trial<<<R, kMergeThreads, smem, st>>>(
      scratch, n_arr, has_sec, head_zero, S, R,
      in_smem ? nullptr : (uint16_t*)perm_dev);

  Jobs out{};
  for (int c = 0; c < n_arr; ++c)
    out.job[c] = Job{scratch + c * plane, (int*)outs[c], n, R, 0};
  out.rows = R;
  out.cols = n;
  transpose_kernel<<<dim3((n + kTile - 1) / kTile, (R + kTile - 1) / kTile,
                          n_arr), threads, 0, st>>>(out);
  return (int)cudaGetLastError();
}

// merge_trial at the 30-year bridge shape (S = 7,560 days, with sec).
extern "C" int letf_info_merge(int* out) {
  int in_smem = 0;
  const int smem = merge_smem(7560, 1, &in_smem);
  const cudaError_t err = cudaFuncSetAttribute(
      merge_trial, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (err != cudaSuccess) return (int)err;
  return letf_fill_info((const void*)merge_trial, kMergeThreads, smem, out);
}
