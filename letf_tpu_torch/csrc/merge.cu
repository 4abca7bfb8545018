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
// sec) pairs make equal to the TPU network's output. Keys and payloads
// move as 64-bit words, since the bridge computes in float64 (a float32
// share coordinate near 10^7 shares is one share apart): keys compare as
// int64 (a non-negative float64 key's bits are order-preserving), the
// int32 secondaries as int32. The plain PyTorch version is
// ops/sort_bridge.py::sort_bridge_plain.
//
// Limits: the trial's key row must fit in a block's shared memory (8
// bytes an element, S <= 14,528 days) and the permutation in uint16 (2S
// <= 65,536). The wrapper raises beyond. The sec row stays in shared
// memory where it fits beside the keys (S <= 9,685 days, ~38 years);
// beyond, the merge reads sec from the scratch row on key ties and the sec
// row moves through the permutation as a payload does.

#include "common.cuh"

namespace {

constexpr int kMaxArr = 8;            // key, sec, up to six payloads
constexpr int kTile = 32;             // transpose tile edge
constexpr int kTileRows = 8;          // transpose block: 32 x 8 threads
constexpr int kMergeThreads = 1024;
constexpr int kMaxSmem = 232448;      // dynamic shared bytes a block can use
using Word = long long;               // a key or payload element

// One transpose: dst[c * dst_stride + col0 + r] = src[r * src_stride + c]
// for r < rows, c < cols, of words of type T.
struct Job {
  const void* src;
  void* dst;
  int src_stride, dst_stride, col0;
};
struct Jobs {
  Job job[2 * kMaxArr];
  int rows, cols;
};

template <typename T>
__global__ void __launch_bounds__(kTile * kTileRows)
    transpose_kernel(const __grid_constant__ Jobs jobs) {
  __shared__ T tile[kTile][kTile + 1];
  const Job& j = jobs.job[blockIdx.z];
  const T* src = static_cast<const T*>(j.src);
  T* dst = static_cast<T*>(j.dst);
  const int c0 = blockIdx.x * kTile, r0 = blockIdx.y * kTile;
  for (int y = threadIdx.y; y < kTile; y += kTileRows) {
    const int r = r0 + y, c = c0 + threadIdx.x;
    if (r < jobs.rows && c < jobs.cols)
      tile[y][threadIdx.x] = src[(size_t)r * j.src_stride + c];
  }
  __syncthreads();
  for (int y = threadIdx.y; y < kTile; y += kTileRows) {
    const int c = c0 + y, r = r0 + threadIdx.x;
    if (r < jobs.rows && c < jobs.cols)
      dst[(size_t)c * j.dst_stride + j.col0 + r] = tile[threadIdx.x][y];
  }
}

// (ka, sa) < (kb, sb), lexicographic.
__device__ __forceinline__ bool lex_less(Word ka, int sa, Word kb, int sb) {
  return ka < kb || (ka == kb && sa < sb);
}

// Block-wide copy of len words from device to shared memory: 32-bit words
// (the sec row) two a load where both ends are 8-byte aligned; 64-bit
// words one a load.
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

__device__ __forceinline__ void stage(long long* dst, const long long* src,
                                      int len) {
#pragma unroll 4
  for (int k = threadIdx.x; k < len; k += blockDim.x) dst[k] = src[k];
}

// The trial-major scratch: the plane of each array ([R, 2S] words: key,
// sec when has_sec, payloads).
struct Planes {
  void* plane[kMaxArr];
};

// One block merges trial blockIdx.x of the trial-major scratch planes in
// place (keys and payloads of Word, the sec plane of int). perm_dev:
// [R, 2S] uint16 device scratch, or null to keep the permutation in shared
// memory after the key and sec rows.
__global__ void __launch_bounds__(kMergeThreads)
    merge_trial(const __grid_constant__ Planes planes, int n_arr,
                int has_sec, int sec_in_smem, unsigned head_zero, int S,
                uint16_t* __restrict__ perm_dev) {
  extern __shared__ __align__(8) unsigned char smem_raw[];
  const int n = 2 * S;
  Word* ks = reinterpret_cast<Word*>(smem_raw);
  int* sec_row = has_sec
      ? static_cast<int*>(planes.plane[1]) + (size_t)blockIdx.x * n
      : nullptr;
  // The sec row the merge compares: staged after the keys, or read in
  // place from the scratch row (written only after the merge).
  int* ss = sec_in_smem ? reinterpret_cast<int*>(ks + n) : sec_row;
  uint16_t* perm = perm_dev != nullptr
      ? perm_dev + (size_t)blockIdx.x * n
      : reinterpret_cast<uint16_t*>(reinterpret_cast<int*>(ks + n)
                                    + has_sec * sec_in_smem * n);
  Word* key_row = static_cast<Word*>(planes.plane[0]) + (size_t)blockIdx.x * n;
  stage(ks, key_row, n);
  if (has_sec && sec_in_smem) stage(ss, sec_row, n);
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
  if (has_sec && sec_in_smem) {
    for (int k = threadIdx.x; k < n; k += blockDim.x)
      sec_row[k] = ss[perm[k]];
  } else if (has_sec) {
    // The sec row through the key row's shared memory, as a payload.
    int* si = reinterpret_cast<int*>(ks);
    __syncthreads();               // every read of ks and of sec_row done
    stage(si, sec_row, n);
    __syncthreads();
    for (int k = threadIdx.x; k < n; k += blockDim.x)
      sec_row[k] = si[perm[k]];
  }
  for (int c = 1 + has_sec; c < n_arr; ++c) {
    const bool hz = (head_zero >> c) & 1u;
    Word* row = static_cast<Word*>(planes.plane[c]) + (size_t)blockIdx.x * n;
    __syncthreads();               // every read of ks done
    if (hz)
      stage(ks + S, row + S, S);
    else
      stage(ks, row, n);
    __syncthreads();
    for (int k = threadIdx.x; k < n; k += blockDim.x) {
      const int p = perm[k];
      row[k] = (hz && p < S) ? Word(0) : ks[p];
    }
  }
}

// Shared bytes of merge_trial: the key row, the sec row where it fits
// beside the keys and the permutation where it fits beside them
// (ops/sort_bridge.py mirrors it).
int merge_smem(int S, int has_sec, int* sec_in_smem, int* perm_in_smem) {
  const long keys = (long)sizeof(Word) * 2 * S;
  *sec_in_smem = has_sec && keys + 4L * 2 * S <= kMaxSmem;
  const long rows = keys + 4L * 2 * S * *sec_in_smem;
  const long with_perm = rows + 2L * 2 * S;
  *perm_in_smem = with_perm <= kMaxSmem;
  return (int)(*perm_in_smem ? with_perm : rows);
}

// The attribute belongs to the current device: set once on each.
cudaError_t allow_merge_smem() {
  constexpr int kMaxDevices = 64;
  static bool attr_set[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && attr_set[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(
      merge_trial, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kMaxSmem);
  if (err == cudaSuccess && dev < kMaxDevices) attr_set[dev] = true;
  return err;
}

}  // namespace

// n_arr arrays (key first, then sec when has_sec, then payloads), each as
// its two halves: heads[c] and tails[c] [S, R] (heads[c] unused where bit
// c of head_zero is set: that payload's head is all zero), outs[c]
// [2S, R]; keys and payloads of 64-bit words, sec int32. tm: device
// scratch of the planes in array order (each [R, 2S]: 8 bytes an element
// of the key and each payload, 4 of sec); perm_dev: [R, 2S] uint16 of
// device scratch where the permutation does not fit in shared memory
// (merge_smem says when), else null.
extern "C" int letf_merge(int n_arr, const void* const* heads,
                          const void* const* tails, void* const* outs,
                          int has_sec, unsigned head_zero, int S, int R,
                          void* tm, void* perm_dev, void* stream) {
  if (n_arr < 1 || n_arr > kMaxArr || (has_sec && n_arr < 2) || S < 0 ||
      R < 0 || 2L * S > 65536 || (R + kTile - 1) / kTile > 65535 ||
      (head_zero & (has_sec ? 3u : 1u)))
    return (int)cudaErrorInvalidValue;
  int sec_in_smem = 0, in_smem = 0;
  const int smem = merge_smem(S, has_sec, &sec_in_smem, &in_smem);
  if (smem > kMaxSmem || (!in_smem && perm_dev == nullptr))
    return (int)cudaErrorInvalidValue;
  if (S == 0 || R == 0) return (int)cudaSuccess;
  const cudaError_t err = allow_merge_smem();
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  const int n = 2 * S;
  const size_t plane = (size_t)R * n;
  Planes planes{};
  unsigned char* at = static_cast<unsigned char*>(tm);
  for (int c = 0; c < n_arr; ++c) {
    planes.plane[c] = at;
    at += plane * ((has_sec && c == 1) ? sizeof(int) : sizeof(Word));
  }
  const dim3 threads(kTile, kTileRows);

  Jobs in{}, in_sec{};
  int n_jobs = 0, n_sec = 0;
  for (int c = 0; c < n_arr; ++c) {
    for (int h = (head_zero >> c) & 1u; h < 2; ++h) {
      const Job job{h ? tails[c] : heads[c], planes.plane[c], R, n, h * S};
      if (has_sec && c == 1)
        in_sec.job[n_sec++] = job;
      else
        in.job[n_jobs++] = job;
    }
  }
  in.rows = in_sec.rows = S;
  in.cols = in_sec.cols = R;
  transpose_kernel<Word><<<dim3((R + kTile - 1) / kTile,
                                (S + kTile - 1) / kTile, n_jobs),
                           threads, 0, st>>>(in);
  if (n_sec)
    transpose_kernel<int><<<dim3((R + kTile - 1) / kTile,
                                 (S + kTile - 1) / kTile, n_sec),
                            threads, 0, st>>>(in_sec);

  merge_trial<<<R, kMergeThreads, smem, st>>>(
      planes, n_arr, has_sec, sec_in_smem, head_zero, S,
      in_smem ? nullptr : (uint16_t*)perm_dev);

  Jobs out{}, out_sec{};
  n_jobs = n_sec = 0;
  for (int c = 0; c < n_arr; ++c) {
    const Job job{planes.plane[c], outs[c], n, R, 0};
    if (has_sec && c == 1)
      out_sec.job[n_sec++] = job;
    else
      out.job[n_jobs++] = job;
  }
  out.rows = out_sec.rows = R;
  out.cols = out_sec.cols = n;
  transpose_kernel<Word><<<dim3((n + kTile - 1) / kTile,
                                (R + kTile - 1) / kTile, n_jobs),
                           threads, 0, st>>>(out);
  if (n_sec)
    transpose_kernel<int><<<dim3((n + kTile - 1) / kTile,
                                 (R + kTile - 1) / kTile, n_sec),
                            threads, 0, st>>>(out_sec);
  return (int)cudaGetLastError();
}

// merge_trial at the 30-year bridge shape (S = 7,560 days, with sec).
extern "C" int letf_info_merge(int* out) {
  int sec_in_smem = 0, in_smem = 0;
  const int smem = merge_smem(7560, 1, &sec_in_smem, &in_smem);
  const cudaError_t err = allow_merge_smem();
  if (err != cudaSuccess) return (int)err;
  return letf_fill_info((const void*)merge_trial, kMergeThreads, smem, out);
}
