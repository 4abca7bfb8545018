// The cost-composition day math shared by kernel K3
// (compose_strategies.cu) and kernel K5 (compose.cu): latent liquidity /
// credit stress AR(1) with Bernoulli crisis jumps, the signed jump on
// SPY/QQQ, the state-linked funding spread, and one asset's leverage /
// expense / financing composition with its AR(1) tracking error (EMA
// de-bias, tanh clip). Counter draws come from streams 16+ (stress) and 32+
// (tracking error), as in letf_tpu/ops/pallas_compose.py::_compose_kernel.
//
// Day 0 is a static specialisation (FIRST): stress starts at its regime
// mean, no jump fires, the tracking error starts at 0. The Pallas compose
// kernel multiplies by (1 - first) instead; the two agree for every finite
// input.
//
// Division, square root and the Box-Muller trigonometry go through a math
// policy M (fastmath.cuh). K3 runs IeeeMath: `/`, sqrtf, sinf and cosf as
// written (FastMath would spill it, PERF.md). K5 runs a day by FastMath
// and again by IeeeMath where FastMath's flag falls, the same bits
// without the slow-path branches.
#pragma once

#include "fastmath.cuh"

namespace compose_day {

constexpr int NA = 6;
constexpr int STRESS_IDX = 16, TE_IDX = 32;

// Stress-table rows ([16, 2] -> per-regime a and b - a) and asset-table
// rows ([9, A]), as ops/compose.py names them.
enum { LIQ_MU, LIQ_PHI, LIQ_SIG, CRED_MU, CRED_PHI, CRED_SIG, JP_BASE,
       JP_SCALE, CASH_RATE, F_BASE, F_BVIX, F_BINV, F_BLIQ, F_BCRED, F_MIN,
       F_MAX, NSP };
enum { C_LEV, C_ER, C_BETA, C_FSPREAD, C_RHO, C_SQ, C_TE_SCALE, C_DOWNSIDE,
       C_CLIP, NAP };

// Stress/cash row i at regime reg (0/1): a + (b - a) * reg.
__device__ __forceinline__ float g2(const float* spa, const float* spd,
                                    int i, float reg) {
  return spa[i] + spd[i] * reg;
}

template <class M>
__device__ __forceinline__ float t_polar(uint32_t dk, int idx0, float df,
                                         float m2df, M& m) {
  const float u1 = letf_stream_unit(dk, idx0);
  const float u2 = letf_stream_unit(dk, idx0 + 1);
  const float w = expf(logf(u1) * m2df) - 1.0f;
  return m.sqrt(df * w) * m.cos(LETF_TWO_PI * u2);
}

// What one day's stress and funding leave for the per-asset composition.
struct DayStress {
  float liq_n, cred_n, jump_on, spy_a, qqq_a;
  float risk_free, spread, vix_mult, regime_mult;
};

// Stress + crisis jump + funding spread of one day; updates liq/cred.
template <bool FIRST, class M>
__device__ __forceinline__ DayStress stress_day(const float* spa,
                                                const float* spd,
                                                uint32_t dk, float& liq,
                                                float& cred, float spy_w,
                                                float qqq_w, float vix,
                                                float irx, float reg, M& m) {
  DayStress d;
  float n_liq, n_cred;
  {
    const float u1 = letf_stream_unit(dk, STRESS_IDX);
    const float u2 = letf_stream_unit(dk, STRESS_IDX + 1);
    const float rad = m.sqrt(-2.0f * logf(u1));
    float sn, cs;
    m.sin_cos(LETF_TWO_PI * u2, sn, cs);
    n_liq = rad * cs;
    n_cred = rad * sn;
  }
  const float u_jump = letf_stream_unit(dk, STRESS_IDX + 4);
  const float t5 =
      t_polar(dk, STRESS_IDX + 2, 5.0f, (float)(-2.0 / 5.0), m);

  const float lmu = g2(spa, spd, LIQ_MU, reg);
  const float cmu = g2(spa, spd, CRED_MU, reg);
  if (FIRST) {
    d.liq_n = lmu;
    d.cred_n = cmu;
    d.jump_on = 0.0f;
  } else {
    d.liq_n = jclip(lmu + g2(spa, spd, LIQ_PHI, reg) * (liq - lmu)
                        + g2(spa, spd, LIQ_SIG, reg) * n_liq,
                    0.0f, 3.0f);
    d.cred_n = jclip(cmu + g2(spa, spd, CRED_PHI, reg) * (cred - cmu)
                         + g2(spa, spd, CRED_SIG, reg) * n_cred,
                     0.0f, 3.0f);
  }
  const float vix_amp = jmax(m.div(vix - 25.0f, 30.0f), 0.0f);
  const float pjump = jclip(g2(spa, spd, JP_BASE, reg) + 0.008f * vix_amp
                                + 0.003f * d.liq_n,
                            0.0f, 0.01f);
  if (!FIRST) d.jump_on = f01(u_jump < pjump);
  const float signed_jump = d.jump_on * t5 * g2(spa, spd, JP_SCALE, reg);
  d.spy_a = jclip(spy_w - signed_jump, -0.95f, 3.0f);
  d.qqq_a = jclip(qqq_w - 1.12f * signed_jump, -0.95f, 4.0f);
  liq = d.liq_n;
  cred = d.cred_n;

  d.risk_free = m.div(jclip(irx, 0.0f, 20.0f), 100.0f);
  const float term = 1.25f - 1.1f * jclip(d.cred_n, 0.0f, 3.0f);
  const float inv_curve = jmax(-term, 0.0f);
  const float stress_v = jmax(vix - 20.0f, 0.0f);
  float spread = spa[F_BASE] + spa[F_BVIX] * stress_v
                 + spa[F_BINV] * inv_curve
                 + spa[F_BLIQ] * jclip(d.liq_n, 0.0f, 3.0f)
                 + spa[F_BCRED] * jclip(d.cred_n, 0.0f, 3.0f);
  d.spread = jmin(jmax(spread, spa[F_MIN]), spa[F_MAX]);
  d.vix_mult = jclip(m.sqrt(m.div(vix, 20.0f)), 0.5f, 1.5f);
  d.regime_mult = 1.0f + 0.15f * reg;
  return d;
}

// Asset a's net daily return before any bound (lev * und - expense -
// borrow + clipped tracking error); src is its underlying stream's return.
// Updates the asset's tracking-error and EMA-bias carries.
template <bool FIRST, class M>
__device__ __forceinline__ float asset_day(const float* ap, int a, float src,
                                           const DayStress& d, uint32_t dk,
                                           float df, float m2df, float ema,
                                           float one_m_ema, float& te,
                                           float& bias, M& m) {
  const float und = src * ap[C_BETA * NA + a];
  const float lev = ap[C_LEV * NA + a];
  const float borrow = m.div(jmax(lev - 1.0f, 0.0f)
                                 * jmax(d.risk_free + d.spread, 0.0f),
                             252.0f);
  const float lev_ret = lev * und - m.div(ap[C_ER * NA + a], 252.0f) - borrow;
  const float t_a = t_polar(dk, TE_IDX + 2 * a, df, m2df, m);
  const float negu = f01(und < 0.0f);
  const float move = (1.0f + 0.3f * fabsf(und))
                     * (ap[C_DOWNSIDE * NA + a] * negu + 0.98f * (1.0f - negu));
  const float innov_te = t_a * ap[C_TE_SCALE * NA + a] * d.vix_mult
                         * d.regime_mult;
  const float te_n = FIRST ? 0.0f
                           : ap[C_RHO * NA + a] * te
                                 + ap[C_SQ * NA + a] * innov_te * move;
  const float bias_n = ema * te_n + one_m_ema * bias;
  const float cap = ap[C_CLIP * NA + a];
  const float safe = jmax(cap, 1e-6f);
  const float raw = te_n - bias_n;
  const float mclip = f01(cap > 0.0f);
  const float te_out = mclip * (safe * tanhf(m.div(raw, safe)))
                       + (1.0f - mclip) * raw;
  te = te_n;
  bias = bias_n;
  return lev_ret + te_out;
}

}  // namespace compose_day
