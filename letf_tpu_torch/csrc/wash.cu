// Kernel K8: sequential one-use wash-sale replacement matching, one thread
// per trial, one pass over the days.
//
// Replaces letf_tpu/ops/pallas_wash.py::_wash_kernel_impl (pallas_call at
// pallas_wash.py:87, entry wash_matching_pallas). For each day with a loss
// sale, take the nearest unused buy within +-30 days (preference: nearer
// first, the earlier day first at equal distance -- _PREF_OFFSETS), mark it
// used, and disallow loss * min(1, replacement shares / sold shares). The
// used flags of the 61-day window live in a 64-bit ring mask in a register
// (bit = day mod 64; the day entering the window is cleared each step);
// buy quantities are read straight from buy_q[d + o] in the [S, B] layout,
// so each probe coalesces across a warp. Days without a loss skip the
// search (nothing is marked on them). Outputs equal the plain PyTorch
// version bitwise (ops/wash.py::wash_plain, a port of
// tax/device_bridge._wash_matching_scan).
//
// What bounds it on the H100: latency of the probes on loss days (up to 60
// dependent-branch loads, usually a few) in a serial day loop, at ~650
// trials for the sampled report -- a handful of warps on the whole card.

#include "common.cuh"

namespace {

constexpr int kWindow = 30;
constexpr float kMinShares = 0.001f;

__global__ void __launch_bounds__(32)
wash_kernel(const float* __restrict__ loss, const float* __restrict__ sell,
            const float* __restrict__ buy, int S, int B,
            float* __restrict__ dis, int* __restrict__ off,
            unsigned char* __restrict__ has) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  unsigned long long used = 0ull;
  for (int d = 0; d < S; ++d) {
    used &= ~(1ull << ((d + kWindow) & 63));
    const size_t at = (size_t)d * B + b;
    const float l = loss[at];
    float dv = 0.0f;
    int ro = 0;
    unsigned char h = 0;
    if (l > 0.0f) {
      float rep_q = 0.0f;
      for (int k = 1; k <= kWindow && !h; ++k) {
        for (int sgn = -1; sgn <= 1 && !h; sgn += 2) {
          const int x = d + sgn * k;
          if (x < 0 || x >= S) continue;
          const unsigned long long bit = 1ull << (x & 63);
          if (used & bit) continue;
          const float q = buy[(size_t)x * B + b];
          if (q > kMinShares) {
            used |= bit;
            h = 1;
            ro = sgn * k;
            rep_q = q;
          }
        }
      }
      if (h) {
        const float m = sell[at];
        const float frac = rep_q >= m ? 1.0f : rep_q / jmax(m, 1e-30f);
        dv = l * frac;
      }
    }
    dis[at] = dv;
    off[at] = ro;
    has[at] = h;
  }
}

}  // namespace

extern "C" int letf_wash(const float* loss, const float* sell,
                         const float* buy, int S, int B, float* dis,
                         int* off, unsigned char* has, void* stream) {
  const int threads = 32;
  const int blocks = (B + threads - 1) / threads;
  if (S > 0 && B > 0) {
    wash_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        loss, sell, buy, S, B, dis, off, has);
  }
  return (int)cudaGetLastError();
}

extern "C" int letf_info_wash(int* out) {
  return letf_fill_info((const void*)wash_kernel, 32, 0, out);
}
