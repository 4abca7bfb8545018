// Kernel K4: the 19 strategies over precomputed channels, one thread per
// trial, one pass over the days.
//
// Replaces letf_tpu/ops/pallas_strategies.py::_strategy_kernel in its
// channel modes (pallas_call at pallas_strategies.py:1081, entry
// pallas_strategies_run), both of them:
// - channel mode (FUSED = false): 23 [S, B] channels in CHANNELS order
//   (r_tqqq, r_spy, r_sso, r_tmf, cash, regime, vix, then the 16 signals
//   spy_price .. rsi14); the strategies read the signals at shift(1), i.e.
//   yesterday's channel values carried in registers, and S7 today's;
// - fused-signals mode (FUSED = true): only the first 7 channels; the 16
//   signals are computed in the kernel from ring buffers (the same
//   signals_read / signals_step as kernel K3).
// The day math is strategies_day.cuh, shared with K3, so the strategies'
// arithmetic is one copy. spy_price is a channel in channel mode (not
// compounded here), as in the reference, so SMA compares see the same bits
// as the signal pass that made it. The flush-to-zero ruin floor is kept.
// The plain PyTorch version is ops/strategies.py::strategies_plain.
//
// What bounds it on the H100: the serial day recurrence (~1,200 flops and
// 3 powf a day) with ~130 floats of live strategy state: latency-bound at
// one thread per trial (16,384 trials are ~4 warps per SM). Channel mode
// also reads 23 floats a trial-day (92 bytes, coalesced across a warp):
// 11.4 GB for a 16,384 x 7,560 chunk, 3.4 ms at 3.35 TB/s, far under the
// recurrence. Any trial count B is taken (the TPU's 1,024-trial tile is
// gone). Only the 57 summary rows are written.

#include "strategies_day.cuh"

namespace {

using namespace strategies_day;

constexpr int NCH = 23;

template <bool FUSED>
__global__ void __launch_bounds__(32)
strategies_kernel(const float* __restrict__ cf, const float* __restrict__ kc,
                  const float* const* __restrict__ chans, float* rings,
                  int S, int B, int apply_costs, float* __restrict__ out) {
  __shared__ float K[NK_STRAT];
  for (int i = threadIdx.x; i < NK_STRAT; i += blockDim.x) K[i] = kc[i];
  __syncthreads();
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;

  const float* ch[NCH];
#pragma unroll
  for (int c = 0; c < (FUSED ? 7 : NCH); ++c) ch[c] = chans[c];
  const Rings rg{rings, b, B};
  StratState st;
  init_strategies(st, K);
  float sum[NSUM];
  if constexpr (FUSED) init_signals(sum, rg);
  const bool costs = apply_costs != 0;

  for (int t = 0; t < S; ++t) {
    const size_t at = (size_t)t * B + b;
    const float r_tqqq = ch[0][at], r_spy = ch[1][at], r_sso = ch[2][at];
    const float r_tmf = ch[3][at], cashr = ch[4][at], reg = ch[5][at];
    const float vix = ch[6][at];
    const float cft = cf != nullptr ? cf[t] : 0.0f;
    float cur[NSIG];
    if constexpr (FUSED) {
      const RingIn rin = signals_read(rg, t);
      if (t == 0)
        signals_step<true>(sum, rg, t, st.psig[G_PRICE], r_tqqq, r_spy, rin,
                           cur);
      else
        signals_step<false>(sum, rg, t, st.psig[G_PRICE], r_tqqq, r_spy, rin,
                            cur);
    } else {
#pragma unroll
      for (int i = 0; i < NSIG; ++i) cur[i] = ch[7 + i][at];
    }
    if (t == 0)
      strategies_step<true>(st, K, costs, t, r_tqqq, r_spy, r_sso, r_tmf,
                           cashr, reg, vix, cur, cft);
    else
      strategies_step<false>(st, K, costs, t, r_tqqq, r_spy, r_sso, r_tmf,
                            cashr, reg, vix, cur, cft);
  }
  store_summary(st, out, b, B);
}

}  // namespace

// Registers, shared memory and resident blocks of the kernel in its
// channel (fused = 0) or fused-signals mode at its launch shape.
extern "C" int letf_info_strategies(int fused, int* out) {
  return fused ? letf_fill_info((const void*)strategies_kernel<true>, 32, 0,
                                out)
               : letf_fill_info((const void*)strategies_kernel<false>, 32, 0,
                                out);
}

// chans: device array of the channel pointers (23, or 7 when fused); rings
// [RING_ROWS, B] scratch (fused only); out [57, B].
extern "C" int letf_strategies(const float* cf, const float* kc,
                               const float* const* chans, float* rings,
                               int S, int B, int apply_costs, int has_cf,
                               int fused, float* out, void* stream) {
  const int threads = 32;
  const int blocks = (B + threads - 1) / threads;
  if (B > 0 && S > 0) {
    if (fused)
      strategies_kernel<true><<<blocks, threads, 0, (cudaStream_t)stream>>>(
          has_cf ? cf : nullptr, kc, chans, rings, S, B, apply_costs, out);
    else
      strategies_kernel<false><<<blocks, threads, 0, (cudaStream_t)stream>>>(
          has_cf ? cf : nullptr, kc, chans, rings, S, B, apply_costs, out);
  }
  return (int)cudaGetLastError();
}
