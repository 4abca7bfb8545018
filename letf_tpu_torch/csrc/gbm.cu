// Kernel K6: levered GBM buy-and-hold, one thread per trial.
//
// Replaces letf_tpu/ops/pallas_path.py::_gbm_kernel (pallas_call at
// pallas_path.py:110, entry gbm_buyhold_pallas): per trial, standard
// normals by Box-Muller, two days per draw pair, the last odd day using z1
// of its pair only; final wealth exp(sum log1p(max(net, -0.999))) with
// net = L * (mu + sigma * z) - cost, and the max drawdown
// 1 - exp(-max(peak - acc)) of the log-wealth acc. Outputs [N] each.
//
// The TPU kernel drew its bits from the core's hardware PRNG, which cannot
// be reproduced; here a counter generator keyed by (seed words, trial, day
// pair): the murmur3 mixers of common.cuh, pair key
// mix(mix(trial * GOLD ^ w0) ^ pair * DAY_PRIME ^ w1), draws 0 and 1 of it.
// The seed words are a threefry hash of the seed (ops/gbm.py), so adjacent
// seeds share no stream structure. The plain version,
// ops/gbm.py::gbm_plain, draws the same bits and runs the same float32
// operations in the same order.
//
// What bounds it on the H100: instruction issue. It moves 8 bytes a trial
// and keeps its carry in registers, so the time is the instructions of a
// trial-day over the card's 528 schedulers. The first port spent ~119 a
// trial-day (PERF.md): log1pf every day, IEEE sqrtf and library
// sinf/cosf with their slow paths (the Payne-Hanek reduction took 32 local
// bytes), and NaN-propagating maxima three times a day. This version
// compounds in the linear domain instead:
// - each day g = 1 + max(net, -0.999) (>= 0.001 - 1.3e-8, formed exactly
//   as the reference forms the argument of its log1p), the block wealth
//   wb *= g, the drawdown ratio d = min(d * g, 1) and its minimum
//   mn = min(mn, d). d_t = W_t / max_{s<=t} W_s = exp(-(peak - acc)), so
//   1 - mn is the reference's drawdown; a ruined path's d may underflow to
//   0, and 1 - 0 = 1 is what 1 - exp(-mdd) gives in float32 there;
// - every kp day pairs (a block) acc += logf(wb) and wb = 1; the last odd
//   day is a block of its own. Final wealth is expf(acc). The wrapper
//   picks kp from the parameters so that wb stays a normal float32 over
//   any block: with |z| <= 5.9 (a 24-bit unit uniform is >= 2^-25, so
//   sqrt(-2 ln u1) <= 5.887), g lies in [gmin, gmax] =
//   [max(1 + L mu - |L| 5.9 sigma - cost, 0.001), 1 + L mu + |L| 5.9 sigma
//   - cost], and 2 kp days keep gmin^(2kp) >= e^-87 and gmax^(2kp) <= e^88.
//   Where even one pair cannot hold that, the wrapper raises;
// - the square root is FastMath's (fastmath.cuh; sqrtf's bits without its
//   slow-path branch: its argument is 0 or at least 2.4e-7, inside the
//   range, and 0 is selected apart), sine and cosine are sin_cos (the math
//   library's fast path bit for bit; a Box-Muller angle never needs the
//   slow one), so no local memory is used;
// - no NaN can enter: every uniform lies in (0, 1], so z is finite, and
//   the wrapper refuses non-finite parameters; plain fminf/fmaxf serve.
// The float32 product form is closer to a float64 evaluation of the
// reference's recurrence than the float32 log-domain form it replaces
// (tests/test_torch_gbm.py). The murmur3 hash alone (~17 instructions a
// trial-day) sets a floor of ~4.5 ms at 1,048,576 x 7,560.

#include "fastmath.cuh"

namespace {

__device__ __forceinline__ void gbm_day(float z, float mu, float sigma,
                                        float lev, float cost, float& wb,
                                        float& d, float& mn) {
  const float net = lev * (mu + sigma * z) - cost;
  const float g = 1.0f + fmaxf(net, -0.999f);
  wb = wb * g;
  d = fminf(d * g, 1.0f);
  mn = fminf(mn, d);
}

// The pair's two normals, z1 = rad * cos and z2 = rad * sin, with sqrtf's
// and cosf/sinf's bits.
__device__ __forceinline__ void pair_normals(uint32_t lane, uint32_t i,
                                             uint32_t w1, float& z1,
                                             float& z2) {
  const uint32_t pk = letf_day_key(lane, i, w1);
  const float u1 = letf_stream_unit(pk, 0);
  const float u2 = letf_stream_unit(pk, 1);
  const float x = -2.0f * logf(u1);
  FastMath fm;
  const float rad = x > 0.0f ? fm.sqrt(x) : 0.0f;
  float sn, cs;
  sin_cos(LETF_TWO_PI * u2, sn, cs);
  z1 = rad * cs;
  z2 = rad * sn;
}

__global__ void __launch_bounds__(128)
gbm_kernel(uint32_t w0, uint32_t w1, int n_trials, int n_days, int kp,
           float mu, float sigma, float lev, float cost,
           float* __restrict__ out_w, float* __restrict__ out_mdd) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= n_trials) return;
  const uint32_t lane = letf_lane_key(b, w0);
  const int n_pairs = n_days / 2;
  float acc = 0.0f, wb = 1.0f, d = 1.0f, mn = 1.0f;
  for (int i0 = 0; i0 < n_pairs; i0 += kp) {
    const int i1 = min(i0 + kp, n_pairs);
#pragma unroll 2
    for (int i = i0; i < i1; ++i) {
      float z1, z2;
      pair_normals(lane, (uint32_t)i, w1, z1, z2);
      gbm_day(z1, mu, sigma, lev, cost, wb, d, mn);
      gbm_day(z2, mu, sigma, lev, cost, wb, d, mn);
    }
    acc = acc + logf(wb);
    wb = 1.0f;
  }
  if (n_days % 2 == 1) {
    float z1, z2;
    pair_normals(lane, (uint32_t)n_pairs, w1, z1, z2);
    gbm_day(z1, mu, sigma, lev, cost, wb, d, mn);
    acc = acc + logf(wb);
  }
  out_w[b] = expf(acc);
  out_mdd[b] = 1.0f - mn;
}

}  // namespace

extern "C" int letf_gbm(unsigned int w0, unsigned int w1, int n_trials,
                        int n_days, int kp, float mu, float sigma, float lev,
                        float cost, float* out_w, float* out_mdd,
                        void* stream) {
  const int threads = 128;
  const int blocks = (n_trials + threads - 1) / threads;
  if (n_trials > 0 && kp > 0)
    gbm_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        w0, w1, n_trials, n_days, kp, mu, sigma, lev, cost, out_w, out_mdd);
  return (int)cudaGetLastError();
}

extern "C" int letf_info_gbm(int* out) {
  return letf_fill_info((const void*)gbm_kernel, 128, 0, out);
}
