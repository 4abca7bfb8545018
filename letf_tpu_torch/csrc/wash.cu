// Kernel K8: one-use wash-sale replacement matching over day bitsets.
//
// Replaces letf_tpu/ops/pallas_wash.py::_wash_kernel_impl (pallas_call at
// pallas_wash.py:87, entry wash_matching_pallas). For each day d with a
// loss sale, take the nearest unused buy within +-30 days (nearer first,
// the earlier day first at equal distance -- _PREF_OFFSETS), mark it used,
// and disallow loss * min(1, replacement shares / sold shares). Outputs
// equal the plain PyTorch version bitwise (ops/wash.py::wash_plain, a port
// of tax/device_bridge._wash_matching_scan).
//
// What bounds it on the H100. Its bytes (three [S, B] float64 inputs and
// three outputs; 0.054 ms at 3.35 TB/s for the sampled report's [7,560,
// ~650])
// and, in the first port's one-thread-a-trial day loop, a serial chain of
// a few memory latencies every day (a load of loss[d], then up to 60
// dependent probes of buy_q on a loss day): 18.5 ms. Only the matching
// itself is serial, and only on loss days, so it runs in three launches:
// (a) bits_kernel, one thread per 32-day word of a trial, coalesced across
//     trials: two bitsets per trial, "eligible buy" (buy_q > 0.001) and
//     "loss day" (loss > 0), as uint32 words [NW, B], days past S zero;
// (b) match_kernel, one thread per trial, a 32-trial block: the trial's
//     loss words and eligible words (padded by a zero word at each end)
//     go to shared memory, the latter becoming the "available" bitset
//     (eligible and not used: the used flags are cleared bits, an
//     absolute-day bitset, which is the reference's 64-row ring exactly
//     since a ring slot is reused only after its day has left the
//     window). It walks the loss days
//     (__ffs over the loss words) and for each loss day d forms the window
//     of days [d - 32, d + 31] from three words by funnel shifts, takes the
//     highest available bit among days d-30..d-1 (__clz) and the lowest
//     among d+1..d+30 (__ffs), the earlier at equal distance, clears its
//     bit and writes the offset (0: none) into off[d];
// (c) epilogue_kernel, one thread per trial-day, coalesced: dis = loss *
//     (q >= m ? 1 : q / max(m, 1e-30)) with q = buy_q[d + off] (the same
//     expression as the plain version), off, has; off is read back only on
//     loss days, so (b) writes nothing else.
// tests/test_torch_wash.py holds a numpy transcription of (b) bitwise to
// the plain version and to the Pallas kernel.
//
// Values are float64, as the bridge computes (a float32 share coordinate
// near 10^7 shares is one share apart); (b) sees only the bitsets.

#include "common.cuh"

namespace {

constexpr int kWindow = 30;
constexpr int kBits = 256;      // threads a block of (a) and (c)
constexpr double kMinShares = 0.001;
constexpr double kTiny = 1e-30;

// common.cuh's jmax for double.
__device__ __forceinline__ double jmax(double a, double b) {
  return (a != a) ? a : ((b != b) ? b : fmax(a, b));
}

// (a): word w of trial b. ebits/lbits [NW, B].
__global__ void __launch_bounds__(kBits)
bits_kernel(const double* __restrict__ loss, const double* __restrict__ buy,
            int S, int B, int NW, uint32_t* __restrict__ ebits,
            uint32_t* __restrict__ lbits) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  const int w = blockIdx.y;
  if (b >= B) return;
  const int d0 = w * 32;
  const int n = min(32, S - d0);
  uint32_t e = 0u, l = 0u;
  for (int j = 0; j < n; ++j) {
    const size_t at = (size_t)(d0 + j) * B + b;
    e |= (uint32_t)(buy[at] > kMinShares) << j;
    l |= (uint32_t)(loss[at] > 0.0) << j;
  }
  ebits[(size_t)w * B + b] = e;
  lbits[(size_t)w * B + b] = l;
}

// (b): the trial's matching. Dynamic shared memory, a column a lane:
// avail[(k + 1) * 32 + lane] = available bits of word k (zero words at
// k = -1 and k = NW), then the loss words lw[k * 32 + lane].
__global__ void __launch_bounds__(32)
match_kernel(const uint32_t* __restrict__ ebits,
             const uint32_t* __restrict__ lbits, int B, int NW,
             int* __restrict__ off) {
  extern __shared__ uint32_t smem[];
  uint32_t* avail = smem;
  uint32_t* lw = smem + (NW + 2) * 32;
  const int lane = threadIdx.x;
  const int b = blockIdx.x * 32 + lane;
  const int bc = b < B ? b : B - 1;
  avail[lane] = 0u;
#pragma unroll 8
  for (int k = 0; k < NW; ++k) {
    avail[(k + 1) * 32 + lane] = ebits[(size_t)k * B + bc];
    lw[k * 32 + lane] = lbits[(size_t)k * B + bc];
  }
  avail[(NW + 1) * 32 + lane] = 0u;
  if (b >= B) return;       // each lane reads and writes its own column
  // One loss day a step, each lane at its own: a lane skips its empty
  // words alone, so the warp takes about as many steps as its busiest
  // lane has loss days.
  int k = 0;
  uint32_t pending = lw[lane];
  for (;;) {
    while (pending == 0u && ++k < NW) pending = lw[k * 32 + lane];
    if (pending == 0u) break;
    const int d = k * 32 + __ffs(pending) - 1;
    pending &= pending - 1u;
    // Days [d - 32, d + 31]: lo bit j is day d - 32 + j, hi bit j day
    // d + j (words k - 1, k, k + 1, padded).
    const int s = d & 31;
    const uint32_t w0 = avail[k * 32 + lane];
    const uint32_t w1 = avail[(k + 1) * 32 + lane];
    const uint32_t w2 = avail[(k + 2) * 32 + lane];
    const uint32_t lo = __funnelshift_r(w0, w1, s) & 0xfffffffcu;
    const uint32_t hi = (__funnelshift_r(w1, w2, s) >> 1) & 0x3fffffffu;
    const int below = lo != 0u ? __clz(lo) + 1 : 99;   // d - day
    const int above = __ffs(hi);                        // day - d, 0: none
    int o = 0;
    if (below <= kWindow && (above == 0 || below <= above))
      o = -below;
    else if (above != 0)
      o = above;
    if (o != 0) {
      const int x = d + o;
      avail[((x >> 5) + 1) * 32 + lane] &= ~(1u << (x & 31));
    }
    off[(size_t)d * B + b] = o;
  }
}

// (c): every trial-day.
__global__ void __launch_bounds__(kBits)
epilogue_kernel(const double* __restrict__ loss,
                const double* __restrict__ sell,
                const double* __restrict__ buy, int S, int B,
                double* __restrict__ dis, int* __restrict__ off,
                unsigned char* __restrict__ has) {
  const size_t n = (size_t)S * B;
  for (size_t at = (size_t)blockIdx.x * blockDim.x + threadIdx.x; at < n;
       at += (size_t)gridDim.x * blockDim.x) {
    const double l = loss[at];
    double dv = 0.0;
    int o = 0;
    if (l > 0.0) {
      o = off[at];
      if (o != 0) {
        const double q = buy[at + (ptrdiff_t)o * B];
        const double m = sell[at];
        const double frac = q >= m ? 1.0 : q / jmax(m, kTiny);
        dv = l * frac;
      }
    }
    dis[at] = dv;
    off[at] = o;
    has[at] = o != 0;
  }
}

int match_smem(int NW) {
  return (2 * NW + 2) * 32 * (int)sizeof(uint32_t);
}

// Lets match_kernel take smem bytes of dynamic shared memory (past 48 KB
// only by the attribute; past 227 KB, about 28,000 days, not at all).
cudaError_t allow_smem(int smem) {
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute((const void*)match_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem);
}

}  // namespace

// The three launches on [S, B] float64 values. bits: [2, ceil(S / 32), B]
// uint32 scratch.
extern "C" int letf_wash(const double* loss, const double* sell,
                         const double* buy, int S, int B, double* dis,
                         int* off, unsigned char* has, uint32_t* bits,
                         void* stream) {
  if (S <= 0 || B <= 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  const int NW = (S + 31) / 32;
  uint32_t* ebits = bits;
  uint32_t* lbits = bits + (size_t)NW * B;
  bits_kernel<<<dim3((B + kBits - 1) / kBits, NW), kBits, 0, st>>>(
      loss, buy, S, B, NW, ebits, lbits);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int smem = match_smem(NW);
  err = allow_smem(smem);
  if (err != cudaSuccess) return (int)err;
  match_kernel<<<(B + 31) / 32, 32, smem, st>>>(ebits, lbits, B, NW, off);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t n = (size_t)S * B;
  const int blocks = (int)((n + kBits - 1) / kBits < 132 * 16
                               ? (n + kBits - 1) / kBits
                               : 132 * 16);
  epilogue_kernel<<<blocks, kBits, 0, st>>>(loss, sell, buy, S, B, dis, off,
                                            has);
  return (int)cudaGetLastError();
}

// The matching launch (b), the serial one, at the sampled report's 7,560
// days.
extern "C" int letf_info_wash(int* out) {
  const int smem = match_smem((7560 + 31) / 32);
  const cudaError_t err = allow_smem(smem);
  if (err != cudaSuccess) return (int)err;
  return letf_fill_info((const void*)match_kernel, 32, smem, out);
}
