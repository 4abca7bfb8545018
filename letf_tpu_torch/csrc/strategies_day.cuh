// The strategy day math shared by kernel K3 (compose_strategies.cu) and
// kernel K4 (strategies.cu): the 16 rolling signals from ring buffers and
// exact add/subtract window sums (signals_read + signals_step), and one day
// of the 19 strategies with their shift(1) signal reads, the cashflow
// overlay, the ruin floor and the running drawdowns (strategies_step). The
// semantics are letf_tpu/ops/pallas_strategies.py::_strategy_kernel's day
// body (:499-966) line for line: pandas min_periods NaN rules, the
// reference quirks S7 (no cash on the idle fraction, today's signal), S8
// (no costs), S9 (frozen on NaN-signal days), S19 (5% rebalance
// threshold), benchmarks compounding from day 0 while the loop strategies
// start on day 1. Day 0 is a static specialisation (FIRST), as in the
// reference.
//
// The group split. No strategy reads another's carries: each reads the
// day's inputs (DayCtx) and its own equity, allocation, trade count,
// running max and drawdown (plus S4/S5/S8's positions and S6's sleeves),
// and settles them itself (settle / s6's own). So the 19 strategies fall
// into NGROUP groups, strategies_group<G>, balanced by cost (S6's
// leverage-drift turnover and the powf of S11, S14 and S15 are the heavy
// ones): K3 and K4's channel mode run each group on a warp of its own,
// K4's fused-signals mode runs the four in order on one thread
// (strategies_step). Every value is computed by the same expression, in
// the same order, either way, so K3 and K4's fused-signals mode stay
// bitwise equal. Likewise the signal pass is split into its ring reads
// (signals_read) and the day's arithmetic, so that K3 can issue day t +
// 1's reads before day t's writes: a read is of a day at least 5 back,
// never of the day before.
//
// The strategies divide through a math policy M (fastmath.cuh): IeeeMath
// is `/`; group_day runs a group's day by FastMath and again by IeeeMath
// when FastMath's flag falls, the same bits without the slow-path branches
// in the common case (K4). The signals divide and take square roots by
// `/` and sqrtf.
//
// The plain PyTorch versions are ops/compose_strategies.py::signals_step
// and ::strategies_step.
#pragma once

#include "fastmath.cuh"

namespace strategies_day {

constexpr int NS = 19;
constexpr int NSIG = 16;
constexpr int NGROUP = 4;
constexpr int RW_X = 64, RW_SPY = 128, RW_P = 256, RW_S20 = 8;
constexpr int R_X = 0, R_SPY = RW_X, R_P = RW_X + RW_SPY,
              R_S20 = RW_X + RW_SPY + RW_P;
constexpr int RING_ROWS = R_S20 + RW_S20;
constexpr float SPREAD = 0.0003f, TURNOVER_EPS = 1e-4f;
constexpr float SQ252 = 15.874507866387544f;
constexpr float W6A = 0.6f, W6B = 0.4f;
constexpr float FLT_MIN_NORMAL = 1.17549435082228750797e-38f;

// Strategy constants: the first entries of every strategy kernel's float
// table (ops/compose_strategies.py::strategy_consts).
enum { K_IC, K_SP0, K_SPD, K_RCPD_LEV, K_RCPD, K_L6A, K_L6B, K_IC_W6A,
       K_IC_W6B, NK_STRAT };
// shift(1) signals, in pallas_strategies.CHANNELS[7:] order.
enum { G_PRICE, G_STD20_MP20, G_DSTD20_MP20, G_STD5, G_STD10, G_STD20,
       G_STD60, G_DSTD20, G_SKEW60, G_MEAN60, G_VOLMOM5, G_SUM126,
       G_SMA200_MP1, G_SMA200, G_SMA100_MP1, G_RSI14 };
// Running window sums.
enum { S1_5, S2_5, S1_10, S2_10, S1_20, S2_20, S1_60, S2_60, S3_60, N1_20,
       N2_20, SPY1_126, P1_100, P1_200, G1_14, L1_14, NSUM };

// The group of strategy i (0-based): S1-S6 | S7-S11 | S12-S14, S16 |
// S15, S17-S19.
__host__ __device__ constexpr int group_of(int i) {
  return i <= 5 ? 0 : i <= 10 ? 1 : (i <= 13 || i == 15) ? 2 : 3;
}

// Equity below float32's smallest normal is ruin (0), as in the reference,
// which runs with subnormals flushed to zero: an equity that underflows
// there stays 0, where IEEE arithmetic would keep a subnormal equity that
// can recover. NaN passes through.
__device__ __forceinline__ float ruin_floor(float e) {
  return e < FLT_MIN_NORMAL ? 0.0f : e;
}

__device__ __forceinline__ float asel(float m, float a, float b) {
  return m * a + (1.0f - m) * b;
}
__device__ __forceinline__ float bsel(float m, float a, float b) {
  return m != 0.0f ? a : b;
}
__device__ __forceinline__ float guard(float v, float eps, float def,
                                       float* m = nullptr) {
  const float mm = f01(v >= eps);
  if (m) *m = mm;
  return bsel(mm, v, def);
}

// Per-trial strategy carries. A K3 strategy warp keeps the whole struct but
// touches only its group's fields; the rest are dead and take no register.
struct StratState {
  float eq[NS], pa[NS], tr[NS], rm[NS], dd[NS];
  float pos4, pos5, pos8, s6p0, s6p1, s6e0, s6e1, pvix;
  float psig[NSIG];
};

__device__ __forceinline__ void init_strategies(StratState& st,
                                                const float* K) {
  const float NaN = __int_as_float(0x7fc00000);
  const float IC = K[K_IC];
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    st.eq[i] = IC; st.pa[i] = 0.0f; st.tr[i] = 0.0f; st.rm[i] = IC;
    st.dd[i] = 0.0f;
  }
  st.pos4 = 0.0f; st.pos5 = 0.0f; st.pos8 = 0.0f;
  st.s6p0 = K[K_IC_W6A]; st.s6p1 = K[K_IC_W6B];
  st.s6e0 = K[K_L6A]; st.s6e1 = K[K_L6B];
  st.pvix = NaN;
#pragma unroll
  for (int i = 0; i < NSIG; ++i) st.psig[i] = NaN;
}

// Where one trial's signal rings live: a wrapper-allocated global scratch
// [RING_ROWS, ld], trial-contiguous, so each access coalesces across a warp.
struct Rings {
  float* base;
  int b, ld;
  __device__ __forceinline__ float& at(int row0, int W, int t, int lag) const {
    return base[(size_t)(row0 + ((t - lag) & (W - 1))) * ld + b];
  }
};

__device__ __forceinline__ void init_signals(float* sum, const Rings& rg) {
#pragma unroll
  for (int i = 0; i < NSUM; ++i) sum[i] = 0.0f;
  for (int r = 0; r < RING_ROWS; ++r) rg.base[(size_t)r * rg.ld + rg.b] = 0.0f;
}

// The ring values day t's signals read (all of days t - 5 and earlier).
struct RingIn {
  float x5, x10, x20, x60, spy126, p100, p200, p14, p15, s20l5;
};

__device__ __forceinline__ RingIn signals_read(const Rings& rg, int t) {
  RingIn r;
  r.x5 = rg.at(R_X, RW_X, t, 5); r.x10 = rg.at(R_X, RW_X, t, 10);
  r.x20 = rg.at(R_X, RW_X, t, 20); r.x60 = rg.at(R_X, RW_X, t, 60);
  r.spy126 = rg.at(R_SPY, RW_SPY, t, 126);
  r.p100 = rg.at(R_P, RW_P, t, 100); r.p200 = rg.at(R_P, RW_P, t, 200);
  r.p14 = rg.at(R_P, RW_P, t, 14); r.p15 = rg.at(R_P, RW_P, t, 15);
  r.s20l5 = rg.at(R_S20, RW_S20, t, 5);
  return r;
}

// Today's 16 signals (cur, in G_* order) from today's TQQQ and SPY
// returns and the ring values signals_read gave for day t; prev_price is
// yesterday's SPY price signal. Updates the window sums and writes today's
// values into the rings.
template <bool FIRST>
__device__ __forceinline__ void signals_step(float* sum, const Rings& rg,
                                            int t, float prev_price,
                                            float r_tqqq, float r_spy,
                                            const RingIn& in, float* cur) {
  const float NaN = __int_as_float(0x7fc00000);
  const float price = FIRST ? 100.0f * (1.0f + r_spy)
                            : prev_price * (1.0f + r_spy);
  const float x = r_tqqq;
  const float neg = jmin(x, 0.0f);
  const float x5 = in.x5, x10 = in.x10, x20 = in.x20, x60 = in.x60;
  const float spy126 = in.spy126, p100 = in.p100, p200 = in.p200;
  const float p14 = in.p14, p15 = in.p15, s20l5 = in.s20l5;
  auto leave = [&](int lag) { return t >= lag ? 1.0f : 0.0f; };
  auto upd = [&](int i, float add, float sub, int lag) {
    sum[i] = sum[i] + add - leave(lag) * sub;
    return sum[i];
  };
  const float s1_5 = upd(S1_5, x, x5, 5);
  const float s2_5 = upd(S2_5, x * x, x5 * x5, 5);
  const float s1_10 = upd(S1_10, x, x10, 10);
  const float s2_10 = upd(S2_10, x * x, x10 * x10, 10);
  const float s1_20 = upd(S1_20, x, x20, 20);
  const float s2_20 = upd(S2_20, x * x, x20 * x20, 20);
  const float s1_60 = upd(S1_60, x, x60, 60);
  const float s2_60 = upd(S2_60, x * x, x60 * x60, 60);
  const float s3_60 = upd(S3_60, x * x * x, x60 * x60 * x60, 60);
  const float ng20 = jmin(x20, 0.0f);
  const float n1_20 = upd(N1_20, neg, ng20, 20);
  const float n2_20 = upd(N2_20, neg * neg, ng20 * ng20, 20);
  const float spy1_126 = upd(SPY1_126, r_spy, spy126, 126);
  const float p1_100 = upd(P1_100, price, p100, 100);
  const float p1_200 = upd(P1_200, price, p200, 200);
  const float delta = FIRST ? 0.0f : price - prev_price;
  const float sub_d = leave(15) * (p14 - p15);
  const float g1_14 = upd(G1_14, jmax(delta, 0.0f), jmax(sub_d, 0.0f), 0);
  const float l1_14 = upd(L1_14, jmax(-delta, 0.0f), jmax(-sub_d, 0.0f), 0);

  const float tn = (float)t + 1.0f;
  auto nn = [&](float w) { return fminf(tn, w); };
  auto gate = [&](int min_t, float v) { return t >= min_t ? v : NaN; };
  auto wstd = [&](float s1, float s2, float w, int min_t) {
    const float n = nn(w);
    const float mean = s1 / n;
    const float var = jmax(s2 - n * mean * mean, 0.0f) / fmaxf(n - 1.0f, 1.0f);
    return gate(min_t, sqrtf(var) * SQ252);
  };
  cur[G_PRICE] = price;
  cur[G_STD5] = wstd(s1_5, s2_5, 5.0f, 1);
  cur[G_STD10] = wstd(s1_10, s2_10, 10.0f, 1);
  cur[G_STD20] = wstd(s1_20, s2_20, 20.0f, 1);
  cur[G_STD60] = wstd(s1_60, s2_60, 60.0f, 1);
  cur[G_STD20_MP20] = wstd(s1_20, s2_20, 20.0f, 19);
  cur[G_DSTD20] = wstd(n1_20, n2_20, 20.0f, 1);
  cur[G_DSTD20_MP20] = wstd(n1_20, n2_20, 20.0f, 19);
  {
    const float n60 = nn(60.0f);
    const float mean60 = s1_60 / n60;
    cur[G_MEAN60] = mean60 * 252.0f;
    const float m2 = jmax(s2_60 - n60 * mean60 * mean60, 0.0f);
    const float m3 = s3_60 - 3.0f * mean60 * s2_60
                     + 2.0f * n60 * mean60 * mean60 * mean60;
    const float var60 = m2 / fmaxf(n60 - 1.0f, 1.0f);
    const float sd60 = sqrtf(var60);
    const float denom = fmaxf(n60 - 1.0f, 1.0f) * fmaxf(n60 - 2.0f, 1.0f)
                        * sd60 * sd60 * sd60;
    const float skew_ok = (t >= 2 ? 1.0f : 0.0f) * f01(sd60 > 0.0f);
    cur[G_SKEW60] = bsel(skew_ok, n60 * m3 / jmax(denom, 1e-37f), NaN);
  }
  cur[G_VOLMOM5] = gate(5, cur[G_STD20] / s20l5 - 1.0f);
  cur[G_SUM126] = spy1_126;
  cur[G_SMA200_MP1] = p1_200 / nn(200.0f);
  cur[G_SMA200] = gate(199, p1_200 / nn(200.0f));
  cur[G_SMA100_MP1] = p1_100 / nn(100.0f);
  {
    const float rs = g1_14 / l1_14;
    cur[G_RSI14] = gate(13, 100.0f - 100.0f / (1.0f + rs));
  }

  // Today's values into the rings (every read above is of an earlier day).
  rg.at(R_X, RW_X, t, 0) = x;
  rg.at(R_SPY, RW_SPY, t, 0) = r_spy;
  rg.at(R_P, RW_P, t, 0) = price;
  rg.at(R_S20, RW_S20, t, 0) = cur[G_STD20];
}

// What every strategy reads of one day: the constants, today's returns,
// cash, regime, VIX and cashflow, today's signals (S7 reads its vol signal
// unshifted) and yesterday's (prev, pp) and VIX.
struct DayCtx {
  const float* K;
  bool costs;
  int t;
  float r_tqqq, r_spy, r_sso, r_tmf, cashr, reg, vix, cft;
  const float* cur;
  const float* prev;
  float pp, vix_prev;
};

// Strategy i's equity after the day's return, cashflow overlay, ruin floor,
// trade count, running max, drawdown and allocation (every strategy but S6,
// which settles in s6).
template <bool FIRST, class M>
__device__ __forceinline__ void settle(StratState& st, int i, float ret,
                                       float traded, float pa_new,
                                       float cft, M& m) {
  const float eq_new = ruin_floor(
      ((FIRST && i >= 3) ? st.eq[i] : st.eq[i] * (1.0f + ret)) + cft);
  if (FIRST) {
    st.rm[i] = eq_new;
    st.eq[i] = eq_new;
    return;
  }
  st.tr[i] = st.tr[i] + traded;
  const float rm_new = jmax(st.rm[i], eq_new);
  const float safe_rm = asel(f01(rm_new > 0.0f), jmax(rm_new, 1e-30f), 1.0f);
  const float ddv = m.div(eq_new - rm_new, safe_rm);
  st.dd[i] = jmax(st.dd[i], -ddv);
  st.rm[i] = rm_new;
  st.eq[i] = eq_new;
  st.pa[i] = pa_new;
}

// The vol-target family's return and trade flag at allocation alloc.
__device__ __forceinline__ void vol_family(const StratState& st,
                                           const DayCtx& c, int i,
                                           float alloc, bool include_cash,
                                           float& ret, float& trm) {
  const float turnover = fabsf(alloc - st.pa[i]);
  trm = f01(turnover > TURNOVER_EPS);
  ret = include_cash ? alloc * c.r_tqqq + (1.0f - alloc) * c.cashr
                     : alloc * c.r_tqqq;
  if (c.costs) ret = ret - trm * turnover * SPREAD;
}

// ---- S1-S3 benchmarks ----
template <bool FIRST, class M>
__device__ __forceinline__ void s_bench(StratState& st, const DayCtx& c, M& m) {
  const float r[3] = {c.r_tqqq, c.r_spy, c.r_sso};
#pragma unroll
  for (int i = 0; i < 3; ++i)
    settle<FIRST>(st, i, r[i], 0.0f, st.pa[i], c.cft, m);
}

// ---- S4/S5 SMA state machines ----
template <bool FIRST, class M>
__device__ __forceinline__ void s_sma(StratState& st, const DayCtx& c, M& m) {
  const float* K = c.K;
  float new4, new5, flip4, flip5;
  if (FIRST) {
    new4 = st.pos4; new5 = st.pos5; flip4 = 0.0f; flip5 = 0.0f;
  } else {
    const float pp = c.pp;
    const float sma1 = c.prev[G_SMA200_MP1];
    const float buy4 = f01(pp >= sma1), sell4 = f01(pp < sma1);
    new4 = asel(f01(st.pos4 == 1.0f), 1.0f - sell4, buy4);
    flip4 = f01(new4 != st.pos4);
    const float thresh5 = sma1 * (float)(1.0 - 0.02);
    const float buy5 = f01(pp >= thresh5), sell5 = f01(pp < thresh5);
    new5 = asel(f01(st.pos5 == 1.0f), 1.0f - sell5, buy5);
    flip5 = f01(new5 != st.pos5);
  }
  const float sma_cost = m.div(K[K_SP0] + K[K_SPD] * c.reg, 10000.0f)
                         + K[K_RCPD_LEV] * fabsf(c.r_tqqq);
  const float newp[2] = {new4, new5}, flip[2] = {flip4, flip5};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float ret_s = asel(newp[i], c.r_tqqq, c.cashr);
    if (c.costs) ret_s = ret_s - flip[i] * sma_cost;
    settle<FIRST>(st, 3 + i, ret_s, flip[i], st.pa[3 + i], c.cft, m);
  }
  if (!FIRST) {
    st.pos4 = new4;
    st.pos5 = new5;
  }
}

// ---- S6 60/40 TQQQ/TMF with leverage-drift turnover ----
template <bool FIRST, class M>
__device__ __forceinline__ void s6(StratState& st, const DayCtx& c, M& m) {
  const float* K = c.K;
  const int t = c.t;
  const float r_tqqq = c.r_tqqq, r_tmf = c.r_tmf;
  const float L6A = K[K_L6A], L6B = K[K_L6B];
  const float pg0 = st.s6p0 * (1.0f + r_tqqq);
  const float pg1 = st.s6p1 * (1.0f + r_tmf);
  const float u6a = m.div(r_tqqq, L6A), u6b = m.div(r_tmf, L6B);
  const float den_a = 1.0f + L6A * u6a, den_b = 1.0f + L6B * u6b;
  const float ma = f01(fabsf(den_a) > 0.01f), mb = f01(fabsf(den_b) > 0.01f);
  const float emb0 =
      asel(ma, m.div(L6A * (1.0f + u6a), bsel(ma, den_a, 1.0f)), L6A);
  const float emb1 =
      asel(mb, m.div(L6B * (1.0f + u6b), bsel(mb, den_b, 1.0f)), L6B);
  const float total6 = pg0 + pg1;
  const float rebf = (t % 21 == 0 && t > 0) ? 1.0f : 0.0f;
  const float inv_t6 = m.div(1.0f, jmax(total6, 1e-30f));
  const float cw0 = pg0 * inv_t6, cw1 = pg1 * inv_t6;
  const float w_turn = fabsf(cw0 - W6A) + fabsf(cw1 - W6B);
  const float lev_turn = m.div(fabsf(emb0 - L6A), L6A) * cw0
                         + m.div(fabsf(emb1 - L6B), L6B) * cw1;
  const float tot_turn = w_turn + lev_turn;
  const float do_cost = c.costs ? rebf * f01(tot_turn > 0.01f) : 0.0f;
  const float total_after = asel(do_cost, total6 * (1.0f - tot_turn * K[K_RCPD]),
                                 total6);
  float s6p0n, s6p1n, s6e0n, s6e1n, equity6, traded;
  if (FIRST) {
    s6p0n = st.s6p0; s6p1n = st.s6p1; s6e0n = st.s6e0; s6e1n = st.s6e1;
    equity6 = st.eq[5];
    traded = 0.0f;
  } else {
    s6p0n = asel(rebf, total_after * W6A, pg0);
    s6p1n = asel(rebf, total_after * W6B, pg1);
    s6e0n = asel(rebf, L6A, emb0);
    s6e1n = asel(rebf, L6B, emb1);
    equity6 = total_after;
    traded = rebf;
  }
  // The sleeves follow the cashflow overlay and the ruin floor.
  const float eq_new = ruin_floor(equity6 + c.cft);
  const float s6_scale = m.div(eq_new, jmax(equity6, 1e-30f));
  s6p0n = s6p0n * s6_scale;
  s6p1n = s6p1n * s6_scale;
  if (FIRST) {
    st.rm[5] = eq_new;
    st.eq[5] = eq_new;
  } else {
    st.tr[5] = st.tr[5] + traded * 2.0f;
    const float rm_new = jmax(st.rm[5], eq_new);
    const float safe_rm = asel(f01(rm_new > 0.0f), jmax(rm_new, 1e-30f), 1.0f);
    const float ddv = m.div(eq_new - rm_new, safe_rm);
    st.dd[5] = jmax(st.dd[5], -ddv);
    st.rm[5] = rm_new;
    st.eq[5] = eq_new;
  }
  st.s6p0 = s6p0n; st.s6p1 = s6p1n; st.s6e0 = s6e0n; st.s6e1 = s6e1n;
}

// ---- S7 vol targeting 20% (no cash on the idle fraction) ----
template <bool FIRST, class M>
__device__ __forceinline__ void s7(StratState& st, const DayCtx& c, M& m) {
  float m7, ret, tr;
  const float v7 = guard(c.cur[G_STD20_MP20], 0.01f, 1.0f, &m7);
  const float pos7 = asel(m7, jclip(m.div(0.20f, v7), 0.2f, 2.0f), 1.0f);
  vol_family(st, c, 6, pos7, false, ret, tr);
  settle<FIRST>(st, 6, ret, tr, pos7, c.cft, m);
}

// ---- S8 composite regime (TQQQ / SPY / cash; no costs) ----
template <bool FIRST, class M>
__device__ __forceinline__ void s8(StratState& st, const DayCtx& c, M& m) {
  float target8, ret, tr;
  if (FIRST) {
    target8 = st.pos8;
    ret = 0.0f;
    tr = 0.0f;
  } else {
    const float* prev = c.prev;
    const float rsi8 = prev[G_RSI14];
    const float sc = f01(c.pp > prev[G_SMA200])
                     + f01((rsi8 > 40.0f) && (rsi8 < 80.0f))
                     + f01(c.vix_prev < 25.0f);
    target8 = asel(f01(sc == 3.0f), 2.0f, asel(f01(sc == 2.0f), 1.0f, 0.0f));
    ret = asel(f01(target8 == 2.0f), c.r_tqqq,
               asel(f01(target8 == 1.0f), c.r_spy, c.cashr));
    tr = f01(target8 != st.pos8);
  }
  settle<FIRST>(st, 7, ret, tr, st.pa[7], c.cft, m);
  if (!FIRST) st.pos8 = target8;
}

// ---- S9 adaptive vol target (skips NaN days entirely) ----
template <bool FIRST, class M>
__device__ __forceinline__ void s9(StratState& st, const DayCtx& c, M& m) {
  const float v9r = c.prev[G_STD20_MP20], sma9 = c.prev[G_SMA200];
  const float ok9 = f01(v9r >= 0.001f) * f01(!isnan(sma9));
  const float target_v9 = asel(f01(c.pp > sma9), 0.35f, 0.12f);
  const float v9 = bsel(ok9, v9r, 1.0f);
  const float alloc9 =
      asel(ok9, jclip(m.div(target_v9, v9), 0.0f, 1.0f), st.pa[8]);
  float ret9, tr9;
  vol_family(st, c, 8, alloc9, true, ret9, tr9);
  settle<FIRST>(st, 8, ret9 * ok9, tr9 * ok9, alloc9, c.cft, m);
}

// ---- S10 Sortino (downside vol target) ----
template <bool FIRST, class M>
__device__ __forceinline__ void s10(StratState& st, const DayCtx& c, M& m) {
  float m10, ret, tr;
  const float dv10 = guard(c.prev[G_DSTD20_MP20], 0.001f, 1.0f, &m10);
  const float alloc10 = asel(m10, jclip(m.div(0.15f, dv10), 0.0f, 1.5f), 1.0f);
  vol_family(st, c, 9, alloc10, true, ret, tr);
  settle<FIRST>(st, 9, ret, tr, alloc10, c.cft, m);
}

// ---- S11 hyper-convex ----
template <bool FIRST, class M>
__device__ __forceinline__ void s11(StratState& st, const DayCtx& c, M& m) {
  float ret, tr;
  const float v11 = guard(c.prev[G_STD20], 0.001f, 0.5f);
  float alloc11 = m.div(0.25f, v11);
  alloc11 = asel(f01(c.pp > c.prev[G_SMA200_MP1]), powf(alloc11, 1.2f),
                 alloc11);
  alloc11 = jclip(alloc11, 0.0f, 1.0f);
  vol_family(st, c, 10, alloc11, true, ret, tr);
  settle<FIRST>(st, 10, ret, tr, alloc11, c.cft, m);
}

// ---- S12 vol velocity (max of fast/slow vols) ----
template <bool FIRST, class M>
__device__ __forceinline__ void s12(StratState& st, const DayCtx& c, M& m) {
  float ret, tr;
  const float v12 = guard(jmax(c.prev[G_STD20], c.prev[G_STD5]), 0.001f, 0.5f);
  const float alloc12 = jclip(m.div(0.22f, v12), 0.0f, 1.0f);
  vol_family(st, c, 11, alloc12, true, ret, tr);
  settle<FIRST>(st, 11, ret, tr, alloc12, c.cft, m);
}

// ---- S13 vol-of-vol momentum ----
template <bool FIRST, class M>
__device__ __forceinline__ void s13(StratState& st, const DayCtx& c, M& m) {
  float ret, tr;
  const float v13 = guard(c.prev[G_STD20], 0.001f, 0.5f);
  const float vm13 = c.prev[G_VOLMOM5];
  float alloc13 = m.div(0.25f, v13);
  alloc13 = asel(f01(vm13 < -0.10f), alloc13 * 1.2f, alloc13);
  alloc13 = asel(f01(vm13 > 0.10f), alloc13 * 0.7f, alloc13);
  alloc13 = jclip(alloc13, 0.0f, 1.0f);
  vol_family(st, c, 12, alloc13, true, ret, tr);
  settle<FIRST>(st, 12, ret, tr, alloc13, c.cft, m);
}

// ---- S14 skewness-adjusted convex ----
template <bool FIRST, class M>
__device__ __forceinline__ void s14(StratState& st, const DayCtx& c, M& m) {
  float ret, tr;
  const float v14 = guard(c.prev[G_STD20], 0.001f, 0.5f);
  const float sk = c.prev[G_SKEW60];
  float alloc14 = m.div(0.25f, v14);
  alloc14 = asel(f01(sk > 0.0f), powf(alloc14, 1.3f), alloc14);
  alloc14 = asel(f01(sk < -0.5f), alloc14 * 0.5f, alloc14);
  alloc14 = jclip(alloc14, 0.0f, 1.0f);
  vol_family(st, c, 13, alloc14, true, ret, tr);
  settle<FIRST>(st, 13, ret, tr, alloc14, c.cft, m);
}

// ---- S15 meta-ensemble ----
template <bool FIRST, class M>
__device__ __forceinline__ void s15(StratState& st, const DayCtx& c, M& m) {
  float ret, tr;
  const float* prev = c.prev;
  const float dv15 = guard(prev[G_DSTD20], 0.001f, 0.25f);
  float alloc15 = m.div(0.28f, dv15);
  alloc15 = asel(f01(c.pp > prev[G_SMA200_MP1]), powf(alloc15, 1.2f),
                 alloc15);
  const float brake15 = f01(prev[G_STD5] > 1.5f * prev[G_STD20]);
  alloc15 = asel(brake15, alloc15 * 0.5f, alloc15);
  alloc15 = jclip(alloc15, 0.0f, 1.0f);
  vol_family(st, c, 14, alloc15, true, ret, tr);
  settle<FIRST>(st, 14, ret, tr, alloc15, c.cft, m);
}

// ---- S16 crisis alpha (regime asymmetric) ----
template <bool FIRST, class M>
__device__ __forceinline__ void s16(StratState& st, const DayCtx& c, M& m) {
  float ret, tr;
  const float vr16 = m.div(c.prev[G_STD5], c.prev[G_STD60]);
  const float crisis16 = jmin(f01(c.vix > 25.0f) + f01(vr16 > 1.5f), 1.0f);
  const float target16 = asel(crisis16, 0.08f, 0.30f);
  float m16;
  const float rv16 = guard(c.prev[G_STD5], 0.001f, 1.0f, &m16);
  const float alloc16 =
      asel(m16, jclip(m.div(target16, rv16), 0.0f, 1.2f), 0.5f);
  vol_family(st, c, 15, alloc16, true, ret, tr);
  settle<FIRST>(st, 15, ret, tr, alloc16, c.cft, m);
}

// ---- S17 tail-risk optimizer (skew-aware Kelly) ----
template <bool FIRST, class M>
__device__ __forceinline__ void s17(StratState& st, const DayCtx& c, M& m) {
  float ret, tr;
  const float* prev = c.prev;
  const float vol17 = guard(prev[G_STD20], 0.001f, 0.25f);
  const float dvol17 = bsel(f01(prev[G_DSTD20] >= 0.001f), prev[G_DSTD20],
                            vol17 * 0.6f);
  const float skew17 = bsel(f01(!isnan(prev[G_SKEW60])), prev[G_SKEW60], 0.0f);
  const float mean17 = bsel(f01(!isnan(prev[G_MEAN60])), prev[G_MEAN60], 0.08f);
  const float sneg5 = f01(skew17 < -0.5f), sneg0 = f01(skew17 < 0.0f);
  const float spos5 = f01(skew17 > 0.5f);
  const float eff17 = asel(sneg5, dvol17 * 1.5f,
                           asel(sneg0, dvol17 * 1.2f,
                                asel(spos5, vol17 * 0.9f, vol17)));
  const float pen17 = asel(sneg5, 0.6f,
                           asel(sneg0, 0.8f, asel(spos5, 1.2f, 1.0f)));
  const float kelly17 = asel(f01(eff17 > 0.01f),
                             jclip(m.div(mean17 - 0.03f, eff17 * eff17) * 0.7f,
                                   0.2f, 2.0f), 1.0f);
  const float alloc17 =
      jclip(m.div(0.30f, eff17) * pen17 * m.div(kelly17, 1.5f), 0.0f, 1.5f);
  vol_family(st, c, 16, alloc17, true, ret, tr);
  settle<FIRST>(st, 16, ret, tr, alloc17, c.cft, m);
}

// ---- S18 momentum-vol convergence ----
template <bool FIRST, class M>
__device__ __forceinline__ void s18(StratState& st, const DayCtx& c, M& m) {
  float ret, tr;
  const float* prev = c.prev;
  const float mom18 = bsel(f01(!isnan(prev[G_SUM126])), prev[G_SUM126], 0.0f);
  const float vf18 = guard(prev[G_STD10], 0.001f, 0.30f);
  const float vs18 = guard(prev[G_STD60], 0.001f, 0.25f);
  const float mm18 = asel(f01(mom18 > 0.05f), 1.3f,
                          asel(f01(mom18 > 0.0f), 1.0f, 0.5f));
  const float vr18 = m.div(vf18, vs18);
  const float out_band = jmin(f01(vr18 < 0.8f) + f01(vr18 > 1.3f), 1.0f);
  const float vm18 = asel(f01(vr18 < 0.8f), 1.2f,
                          asel(f01(vr18 > 1.3f), 0.6f, 1.0f));
  const float eff18 = asel(out_band, vf18, vs18);
  const float alloc18 = jclip(m.div(0.28f * mm18 * vm18, eff18), 0.0f, 1.5f);
  vol_family(st, c, 17, alloc18, true, ret, tr);
  settle<FIRST>(st, 17, ret, tr, alloc18, c.cft, m);
}

// ---- S19 conviction compounder (5% rebalance threshold) ----
template <bool FIRST, class M>
__device__ __forceinline__ void s19(StratState& st, const DayCtx& c, M& m) {
  const float* prev = c.prev;
  const float mom19 = bsel(f01(!isnan(prev[G_SUM126])), prev[G_SUM126], 0.0f);
  const float dv19 = guard(prev[G_DSTD20], 0.001f, 0.20f);
  const float vf19 = guard(prev[G_STD5], 0.001f, 0.30f);
  const float vs19 = guard(prev[G_STD60], 0.001f, 0.25f);
  const float mom_score = asel(f01(mom19 > 0.15f), 1.0f,
                               asel(f01(mom19 > 0.05f), 0.7f,
                                    asel(f01(mom19 > 0.0f), 0.4f, 0.0f)));
  const float trend_score = f01(c.pp > prev[G_SMA100_MP1]) * 0.5f;
  const float vr19 = m.div(vf19, vs19);
  const float vol_score = asel(f01(vr19 < 0.9f), 0.5f,
                               asel(f01(vr19 < 1.2f), 0.3f, 0.0f));
  const float conviction = mom_score + trend_score + vol_score;
  const float cand19 = jclip(m.div(0.32f, dv19) * (0.3f + conviction * 0.55f),
                             0.0f, 1.5f);
  const float turn19 = fabsf(cand19 - st.pa[18]);
  const float rebal19 = f01(turn19 > 0.05f);
  const float alloc19 = asel(rebal19, cand19, st.pa[18]);
  float ret19 = alloc19 * c.r_tqqq + (1.0f - alloc19) * c.cashr;
  if (c.costs) ret19 = ret19 - rebal19 * turn19 * SPREAD;
  settle<FIRST>(st, 18, ret19, rebal19, alloc19, c.cft, m);
}

// One day of group G's strategies (group_of), each settled in turn,
// dividing by m.
template <int G, bool FIRST, class M>
__device__ __forceinline__ void strategies_group(StratState& st,
                                                 const DayCtx& c, M& m) {
  if constexpr (G == 0) {
    s_bench<FIRST>(st, c, m); s_sma<FIRST>(st, c, m); s6<FIRST>(st, c, m);
  } else if constexpr (G == 1) {
    s7<FIRST>(st, c, m); s8<FIRST>(st, c, m); s9<FIRST>(st, c, m);
    s10<FIRST>(st, c, m); s11<FIRST>(st, c, m);
  } else if constexpr (G == 2) {
    s12<FIRST>(st, c, m); s13<FIRST>(st, c, m); s14<FIRST>(st, c, m);
    s16<FIRST>(st, c, m);
  } else {
    s15<FIRST>(st, c, m); s17<FIRST>(st, c, m); s18<FIRST>(st, c, m);
    s19<FIRST>(st, c, m);
  }
}

// One day of group G by FastMath, and by IeeeMath again from the saved
// carries if an operand fell out of FastMath's range (fastmath.cuh), so
// the bits are IeeeMath's either way. c.prev points at st's shift(1)
// signals, which no group writes.
template <int G, bool FIRST>
__device__ __forceinline__ void group_day(StratState& st, const DayCtx& c) {
  StratState n = st;
  FastMath fm;
  strategies_group<G, FIRST>(n, c, fm);
  if (!fm.ok) {
    n = st;
    IeeeMath im;
    strategies_group<G, FIRST>(n, c, im);
  }
  st = n;
}

__device__ __forceinline__ DayCtx day_ctx(const StratState& st,
                                          const float* K, bool costs, int t,
                                          float r_tqqq, float r_spy,
                                          float r_sso, float r_tmf,
                                          float cashr, float reg, float vix,
                                          const float* cur, float cft) {
  return DayCtx{K, costs, t, r_tqqq, r_spy, r_sso, r_tmf, cashr, reg, vix,
                cft, cur, st.psig, st.psig[G_PRICE], st.pvix};
}

// Roll the shift(1) values: yesterday's VIX and signals become today's.
__device__ __forceinline__ void roll(StratState& st, float vix,
                                     const float* cur) {
  st.pvix = vix;
#pragma unroll
  for (int i = 0; i < NSIG; ++i) st.psig[i] = cur[i];
}

// One day of the 19 strategies on one thread (K4): the four groups in
// order, then the roll. cur: today's signals (G_* order); cft: the day's
// cashflow.
template <bool FIRST>
__device__ __forceinline__ void strategies_step(StratState& st, const float* K,
                                               bool apply_costs, int t,
                                               float r_tqqq, float r_spy,
                                               float r_sso, float r_tmf,
                                               float cashr, float reg,
                                               float vix, const float* cur,
                                               float cft) {
  const DayCtx c = day_ctx(st, K, apply_costs, t, r_tqqq, r_spy, r_sso,
                           r_tmf, cashr, reg, vix, cur, cft);
  group_day<0, FIRST>(st, c);
  group_day<1, FIRST>(st, c);
  group_day<2, FIRST>(st, c);
  group_day<3, FIRST>(st, c);
  roll(st, vix, cur);
}

// Strategy i's three summary rows of [3 * NS, B]: final equity, trade
// count, max drawdown.
__device__ __forceinline__ void store_strategy(const StratState& st, int i,
                                               float* out, int b, int B) {
  out[(size_t)i * B + b] = st.eq[i];
  out[(size_t)(NS + i) * B + b] = st.tr[i];
  out[(size_t)(2 * NS + i) * B + b] = st.dd[i];
}

// The 57 summary rows of all strategies.
__device__ __forceinline__ void store_summary(const StratState& st,
                                              float* out, int b, int B) {
#pragma unroll
  for (int i = 0; i < NS; ++i) store_strategy(st, i, out, b, B);
}

}  // namespace strategies_day
