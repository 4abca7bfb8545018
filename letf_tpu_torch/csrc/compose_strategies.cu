// Kernel K3: cost composition + 16 rolling signals + 19 strategies, one
// thread per trial, one pass over the window's days.
//
// Replaces letf_tpu/ops/pallas_strategies.py::_strategy_kernel in
// fused-compose mode (pallas_call at pallas_strategies.py:1156, entry
// pallas_compose_strategies_run). The day body is the reference's
// (pallas_strategies.py:321-966) in meaning, line for line: stress + crisis
// jumps + funding + leverage/expense/financing + tracking error with counter
// draws from streams 16+ and 32+ (compose_day.cuh, shared with kernel K5;
// TE chains for the four consumed assets only) and the per-day repair; the
// ring-buffer signals and the 19 strategies with the cashflow schedule and
// ruin floor (strategies_day.cuh, shared with kernel K4); the validity
// accumulators. Day 0 is a separate template instance (the reference's
// static day-0 specialisation). The plain PyTorch version is
// ops/compose_strategies.py::compose_strategies_plain.
//
// What bounds it on the H100: a long serial per-trial recurrence (~2,000
// flops and 13 transcendentals a day) with ~160 floats of live state,
// more than the 255 registers a thread may hold, at only ~4 warps per SM
// for a 16,384-trial chunk: it is latency-bound. The 456 floats a trial
// keeps in its signal rings (x 64, spy 128, price 256, std20 8 days) live
// in a wrapper-allocated global scratch [456, B], trial-contiguous so each
// ring access coalesces across a warp and stays L2-resident (30 MB at
// B = 16,384). Scalar state is left to registers and local memory; the six
// input loads and the 64-row summary store coalesce. Hiding the latency
// (more trials per SM, splitting the draws out) is later work.

#include "compose_day.cuh"
#include "strategies_day.cuh"

namespace {

using namespace compose_day;
using namespace strategies_day;

// Constants table (ops/compose_strategies.py::kernel_consts): the strategy
// constants (strategies_day.cuh), then the composition's.
enum { K_ONE_M_EMA = NK_STRAT, K_EMA, K_IDX_TQQQ, K_IDX_SPY, K_IDX_SSO,
       K_IDX_TMF, K_UND, K_DF = K_UND + NA, K_M2DF = K_DF + NA,
       NK = K_M2DF + NA };

struct Tables {
  float spa[NSP], spd[NSP], ap[NAP * NA], k[NK];
};

struct ComposeState {
  float sum[NSUM];
  float liq, cred, te[4], bias[4];
  float jc, ls, cs, fin, vmin, vmax, rhi;
};

template <bool FIRST>
__device__ __forceinline__ void day(StratState& st, ComposeState& cs,
                                    const Tables& T, const Rings& rg,
                                    const float* cf, uint32_t lane_key,
                                    uint32_t s1, bool apply_costs, int t,
                                    float spy_w, float qqq_w, float tlt_w,
                                    float vix, float irx, float reg) {
  const float* K = T.k;
  cs.vmin = jmin(cs.vmin, vix);
  cs.vmax = jmax(cs.vmax, vix);
  cs.rhi = cs.rhi + reg;

  // ---- stress + crisis jumps + funding (compose_day.cuh) ----
  const uint32_t dk = letf_day_key(lane_key, (uint32_t)t, s1);
  const DayStress ds = stress_day<FIRST>(T.spa, T.spd, dk, cs.liq, cs.cred,
                                         spy_w, qqq_w, vix, irx, reg);
  cs.jc = cs.jc + ds.jump_on;
  cs.ls = cs.ls + ds.liq_n;
  cs.cs = cs.cs + ds.cred_n;

  // ---- leverage / costs / tracking error: TQQQ, SPY, SSO, TMF ----
  float fin_day = f01(isfinite(tlt_w)) * f01(isfinite(vix));
  float etf[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int a = (int)K[K_IDX_TQQQ + k];
    const int ui = (int)K[K_UND + a];
    const float src = ui == 0 ? ds.spy_a : (ui == 1 ? ds.qqq_a : tlt_w);
    const float e = asset_day<FIRST>(T.ap, a, src, ds, dk, K[K_DF + a],
                                     K[K_M2DF + a], K[K_EMA],
                                     K[K_ONE_M_EMA], cs.te[k], cs.bias[k]);
    const float fin_a = f01(isfinite(e));
    fin_day = fin_day * fin_a;
    etf[k] = jclip(bsel(fin_a, e, 0.0f), -0.999f, 10.0f);
  }
  cs.fin = cs.fin * fin_day;
  const float cashr = g2(T.spa, T.spd, CASH_RATE, reg) / 252.0f;

  // ---- rolling signals, then the strategies (strategies_day.cuh) ----
  float cur[NSIG];
  signals_step<FIRST>(cs.sum, rg, t, st.psig[G_PRICE], etf[0], etf[1], cur);
  strategies_step<FIRST>(st, K, apply_costs, t, etf[0], etf[1], etf[2],
                        etf[3], cashr, reg, vix, cur,
                        cf != nullptr ? cf[t] : 0.0f);
}

__global__ void __launch_bounds__(32)
compose_strategies_kernel(const float* __restrict__ cf,
                          const float* __restrict__ sp,
                          const float* __restrict__ ap,
                          const float* __restrict__ kc,
                          const int* __restrict__ ids, uint32_t s0,
                          uint32_t s1, const float* __restrict__ spy,
                          const float* __restrict__ qqq,
                          const float* __restrict__ tlt,
                          const float* __restrict__ vix,
                          const float* __restrict__ irx,
                          const float* __restrict__ regime, float* rings,
                          int S, int B, int apply_costs,
                          float* __restrict__ out) {
  __shared__ Tables tb;
  for (int i = threadIdx.x; i < NSP; i += blockDim.x) {
    tb.spa[i] = sp[2 * i];
    tb.spd[i] = sp[2 * i + 1] - sp[2 * i];
  }
  for (int i = threadIdx.x; i < NAP * NA; i += blockDim.x) tb.ap[i] = ap[i];
  for (int i = threadIdx.x; i < NK; i += blockDim.x) tb.k[i] = kc[i];
  __syncthreads();
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;

  const Rings rg{rings, b, B};
  const uint32_t lane_key = letf_lane_key(ids[b], s0);
  StratState st;
  init_strategies(st, tb.k);
  ComposeState cs;
  init_signals(cs.sum, rg);
  cs.liq = 0.0f; cs.cred = 0.0f;
#pragma unroll
  for (int k = 0; k < 4; ++k) { cs.te[k] = 0.0f; cs.bias[k] = 0.0f; }
  cs.jc = 0.0f; cs.ls = 0.0f; cs.cs = 0.0f; cs.fin = 1.0f;
  cs.vmin = INFINITY; cs.vmax = -INFINITY; cs.rhi = 0.0f;

  for (int t = 0; t < S; ++t) {
    const size_t at = (size_t)t * B + b;
    if (t == 0)
      day<true>(st, cs, tb, rg, cf, lane_key, s1, apply_costs != 0, t,
                spy[at], qqq[at], tlt[at], vix[at], irx[at], regime[at]);
    else
      day<false>(st, cs, tb, rg, cf, lane_key, s1, apply_costs != 0, t,
                 spy[at], qqq[at], tlt[at], vix[at], irx[at], regime[at]);
  }

  store_summary(st, out, b, B);
  const float tail[7] = {cs.fin, cs.jc, cs.ls, cs.cs, cs.vmin, cs.vmax,
                         cs.rhi};
#pragma unroll
  for (int i = 0; i < 7; ++i) out[(size_t)(3 * NS + i) * B + b] = tail[i];
}

}  // namespace

extern "C" int letf_compose_strategies(
    const float* cf, const float* sp, const float* ap, const float* kc,
    const int* ids, unsigned int s0, unsigned int s1, const float* spy,
    const float* qqq, const float* tlt, const float* vix, const float* irx,
    const float* regime, float* rings, int S, int B, int apply_costs,
    int has_cf, float* out, void* stream) {
  const int threads = 32;
  const int blocks = (B + threads - 1) / threads;
  if (B > 0 && S > 0) {
    compose_strategies_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        has_cf ? cf : nullptr, sp, ap, kc, ids, s0, s1, spy, qqq, tlt, vix,
        irx, regime, rings, S, B, apply_costs, out);
  }
  return (int)cudaGetLastError();
}
