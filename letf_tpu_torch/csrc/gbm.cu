// Kernel K6: levered GBM buy-and-hold, one thread per trial.
//
// Replaces letf_tpu/ops/pallas_path.py::_gbm_kernel (pallas_call at
// pallas_path.py:110, entry gbm_buyhold_pallas): per trial, standard
// normals by Box-Muller, two days per draw pair; log-wealth
// acc += log1p(max(L * (mu + sigma * z) - cost, -0.999)), the running peak
// and the max drawdown (peak - acc) carried in registers; the last odd day
// uses z1 of its pair only. Outputs exp(acc) and 1 - exp(-mdd), [N] each.
//
// The TPU kernel drew its bits from the core's hardware PRNG, which cannot
// be reproduced; here a counter generator keyed by (seed words, trial, day
// pair): the murmur3 mixers of common.cuh, pair key
// mix(mix(trial * GOLD ^ w0) ^ pair * DAY_PRIME ^ w1), draws 0 and 1 of it.
// The seed words are a threefry hash of the seed (ops/gbm.py), so adjacent
// seeds share no stream structure. The plain version,
// ops/gbm.py::gbm_plain, draws the same bits; a unit uniform that rounds
// to 1.0 (one draw in 2^24) gives rad = 0 in both.
//
// What bounds it on the H100: arithmetic, ~14 f32 operations and 2.5
// transcendentals a trial-day (log1pf every day; logf, sqrtf, sinf, cosf
// every pair) against 8 bytes written a trial; the carry is three floats in
// registers and the loop has no memory traffic at all.

#include "common.cuh"

namespace {

__device__ __forceinline__ void gbm_step(float& acc, float& peak, float& mdd,
                                         float z, float mu, float sigma,
                                         float lev, float cost) {
  const float r = mu + sigma * z;
  const float net = lev * r - cost;
  acc = acc + log1pf(jmax(net, -0.999f));
  peak = jmax(peak, acc);
  mdd = jmax(mdd, peak - acc);
}

__global__ void gbm_kernel(uint32_t w0, uint32_t w1, int n_trials,
                           int n_days, float mu, float sigma, float lev,
                           float cost, float* __restrict__ out_w,
                           float* __restrict__ out_mdd) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= n_trials) return;
  const uint32_t lane = letf_lane_key(b, w0);
  const int n_pairs = (n_days + 1) / 2;
  const bool odd_tail = (n_days % 2) == 1;
  float acc = 0.0f, peak = 0.0f, mdd = 0.0f;
  for (int i = 0; i < n_pairs; ++i) {
    const uint32_t pk = letf_day_key(lane, (uint32_t)i, w1);
    const float u1 = letf_stream_unit(pk, 0);
    const float u2 = letf_stream_unit(pk, 1);
    const float rad = sqrtf(-2.0f * logf(u1));
    const float ang = LETF_TWO_PI * u2;
    gbm_step(acc, peak, mdd, rad * cosf(ang), mu, sigma, lev, cost);
    if (i + 1 < n_pairs || !odd_tail)
      gbm_step(acc, peak, mdd, rad * sinf(ang), mu, sigma, lev, cost);
  }
  out_w[b] = expf(acc);
  out_mdd[b] = 1.0f - expf(-mdd);
}

}  // namespace

extern "C" int letf_gbm(unsigned int w0, unsigned int w1, int n_trials,
                        int n_days, float mu, float sigma, float lev,
                        float cost, float* out_w, float* out_mdd,
                        void* stream) {
  const int threads = 128;
  const int blocks = (n_trials + threads - 1) / threads;
  if (n_trials > 0)
    gbm_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        w0, w1, n_trials, n_days, mu, sigma, lev, cost, out_w, out_mdd);
  return (int)cudaGetLastError();
}

extern "C" int letf_info_gbm(int* out) {
  return letf_fill_info((const void*)gbm_kernel, 128, 0, out);
}
