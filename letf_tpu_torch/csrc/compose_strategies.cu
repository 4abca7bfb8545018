// Kernel K3: cost composition + 16 rolling signals + 19 strategies, one
// pass over the window's days, a block of warps per 32 trials.
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
// What bounds it on the H100. A trial-day is a serial recurrence of a few
// thousand instructions (13 precise transcendentals, ~60 IEEE divisions,
// every multiply and add one instruction under -fmad=false). One thread per
// trial (the first port) put ~4 warps on an SM for a 16,384-trial chunk,
// one per scheduler, each walking the whole day's chain alone. The work of
// a day splits cleanly, so here a block owns 32 trials (one per lane) and
// each of its 7 warps runs one part of every day for them, uniform across
// its lanes:
// - two composition warps: stress + jumps + funding, then TQQQ and SPY
//   (warp A, which also keeps the jump/liquidity/credit/VIX/regime
//   accumulators and writes cash, regime and VIX) or SSO and TMF (warp B).
//   Both run stress_day on the same counter bits and each keeps its own
//   liquidity/credit carries, so both have the same bits without a hand-off;
//   each day's six inputs load two days ahead;
// - one signal warp: signals_step from the day's TQQQ and SPY returns, the
//   next day's ring reads issued before this day's (strategies_day.cuh);
// - four strategy warps, one strategy group each (strategies_day.cuh's
//   group split, the groups K4 runs in order on one thread), each with
//   only its group's carries and its own copy of yesterday's signals.
// The stages pass through shared memory: a ring of 3 tiles of D days, each
// day 23 floats x 32 trials (four ETF returns, cash, regime, VIX, 16
// signals). At step k the composition warps fill tile k, the signal warp
// tile k - 1, the strategy warps read tile k - 2, then the block meets at
// one barrier; the three tiles are distinct, so no slot is read while it is
// written. 72 registers a thread let 4 blocks (28 warps) share an SM, so a
// 16,384-trial chunk (512 blocks) runs in one wave. The 456 floats a trial
// keeps in its signal rings stay in a wrapper-allocated global scratch
// [456, B rounded up to 32] (30 MB, L2-resident): in shared memory they
// would take 58 KB a block and leave room for 3 blocks an SM, not 4 (two
// waves). What bounds it now: each block's own chain of days. The kernel
// takes about as long on 4,096 trials (one block an SM) as on 16,384 (four;
// chip_smoke.py times both), so the SM's issue slots are far from full.
// More registers a thread, other placements of the roles on the SM's
// schedulers, one warp for all 19 strategies, unrolled day loops or a
// tile's counter draws computed together were no faster or slower in
// exploratory builds; which latency inside a warp's day sets the pace is
// open (no instruction-level profiler runs on the card's machine). K3's
// arithmetic is K4's expression by expression, so its summaries are bitwise
// K4's fused-signals mode on the same returns.

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

constexpr int D = 4;                        // days per stage tile
constexpr int W_COMP = 0, W_SIG = 2, W_STRAT = 3;
constexpr int NWARP = W_STRAT + NGROUP;     // 7
constexpr int THREADS = 32 * NWARP;
constexpr int MIN_BLOCKS = 4;               // resident blocks an SM
// One day's stage fields.
enum { F_ETF, F_CASH = F_ETF + 4, F_REG, F_VIX, F_CUR, NF = F_CUR + NSIG };
constexpr int OUT_TAIL = 3 * NS;            // first of the 7 tail rows

struct Shared {
  Tables tb;
  float stage[3][D][NF][32];
  float fin_b[32];
};

__device__ __forceinline__ void block_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(THREADS) : "memory");
}

struct Args {
  const float* cf;
  const int* ids;
  uint32_t s0, s1;
  const float *spy, *qqq, *tlt, *vix, *irx, *regime;
  float* rings;
  int ring_ld, S, B, apply_costs;
  float* out;
};

// Composition warp HALF (0: TQQQ, SPY and the accumulators; 1: SSO, TMF).
template <int HALF, bool FIRST>
__device__ __forceinline__ void compose_stage_day(
    Shared& sh, float (*slot)[32], int lane, uint32_t dk, float spy_w,
    float qqq_w, float tlt_w, float vix, float irx, float reg, float& liq,
    float& cred, float* te, float* bias, float* acc, float& fin) {
  const Tables& T = sh.tb;
  const float* K = T.k;
  if (HALF == 0) {
    acc[4] = jmin(acc[4], vix);
    acc[5] = jmax(acc[5], vix);
    acc[6] = acc[6] + reg;
  }
  IeeeMath im;
  const DayStress ds = stress_day<FIRST>(T.spa, T.spd, dk, liq, cred, spy_w,
                                         qqq_w, vix, irx, reg, im);
  if (HALF == 0) {
    acc[1] = acc[1] + ds.jump_on;
    acc[2] = acc[2] + ds.liq_n;
    acc[3] = acc[3] + ds.cred_n;
  }
  // The path-finite flag: every factor is 0 or 1, so the two warps'
  // partial products multiply to the one-thread product exactly.
  float fin_day = HALF == 0 ? f01(isfinite(tlt_w)) * f01(isfinite(vix))
                            : 1.0f;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int k = 2 * HALF + j;
    const int a = (int)K[K_IDX_TQQQ + k];
    const int ui = (int)K[K_UND + a];
    const float src = ui == 0 ? ds.spy_a : (ui == 1 ? ds.qqq_a : tlt_w);
    const float e = asset_day<FIRST>(T.ap, a, src, ds, dk, K[K_DF + a],
                                     K[K_M2DF + a], K[K_EMA],
                                     K[K_ONE_M_EMA], te[j], bias[j], im);
    const float fin_a = f01(isfinite(e));
    fin_day = fin_day * fin_a;
    slot[F_ETF + k][lane] = jclip(bsel(fin_a, e, 0.0f), -0.999f, 10.0f);
  }
  fin = fin * fin_day;
  if (HALF == 0) {
    slot[F_CASH][lane] = g2(T.spa, T.spd, CASH_RATE, reg) / 252.0f;
    slot[F_REG][lane] = reg;
    slot[F_VIX][lane] = vix;
  }
}

template <int HALF>
__device__ void compose_role(Shared& sh, const Args& a, int lane, int b,
                             int bc, int ntile) {
  const uint32_t lane_key = letf_lane_key(a.ids[bc], a.s0);
  float liq = 0.0f, cred = 0.0f;
  float te[2] = {0.0f, 0.0f}, bias[2] = {0.0f, 0.0f};
  // jump days, liquidity sum, credit sum, VIX min, VIX max, regime-1 days
  // (acc[1..6]; warp A only).
  float acc[7] = {0.0f, 0.0f, 0.0f, 0.0f, INFINITY, -INFINITY, 0.0f};
  float fin = 1.0f;
  // The six inputs of days t + 1 and t + 2 load while day t computes.
  auto load = [&](int t, float* v) {
    if (t < a.S) {
      const size_t at = (size_t)t * a.B + bc;
      v[0] = a.spy[at]; v[1] = a.qqq[at]; v[2] = a.tlt[at];
      v[3] = a.vix[at]; v[4] = a.irx[at]; v[5] = a.regime[at];
    }
  };
  float n1[6], n2[6];
  load(0, n1);
  load(1, n2);
  for (int k = 0; k < ntile + 2; ++k) {
    if (k < ntile) {
      float(*stage)[NF][32] = sh.stage[k % 3];
#pragma unroll 1
      for (int j = 0; j < D; ++j) {
        const int t = k * D + j;
        if (t >= a.S) break;
        float in[6];
#pragma unroll
        for (int i = 0; i < 6; ++i) { in[i] = n1[i]; n1[i] = n2[i]; }
        load(t + 2, n2);
        const uint32_t dk = letf_day_key(lane_key, (uint32_t)t, a.s1);
        if (t == 0)
          compose_stage_day<HALF, true>(sh, stage[j], lane, dk, in[0], in[1],
                                        in[2], in[3], in[4], in[5], liq,
                                        cred, te, bias, acc, fin);
        else
          compose_stage_day<HALF, false>(sh, stage[j], lane, dk, in[0],
                                         in[1], in[2], in[3], in[4], in[5],
                                         liq, cred, te, bias, acc, fin);
      }
    }
    block_sync();
  }
  if (HALF == 1) sh.fin_b[lane] = fin;
  block_sync();
  if (HALF == 0 && b < a.B) {
    acc[0] = fin * sh.fin_b[lane];
#pragma unroll
    for (int i = 0; i < 7; ++i) a.out[(size_t)(OUT_TAIL + i) * a.B + b] = acc[i];
  }
}

__device__ void signal_role(Shared& sh, const Args& a, int lane, int b,
                            int ntile) {
  const Rings rg{a.rings, b, a.ring_ld};
  float sum[NSUM];
  init_signals(sum, rg);
  float prev_price = __int_as_float(0x7fc00000);
  // Day t + 1's ring reads (days t - 4 and earlier) go out before day t
  // writes day t's values, which they never read.
  RingIn next = signals_read(rg, 0);
  for (int k = 0; k < ntile + 2; ++k) {
    const int kt = k - 1;
    if (kt >= 0 && kt < ntile) {
      float(*stage)[NF][32] = sh.stage[kt % 3];
#pragma unroll 1
      for (int j = 0; j < D; ++j) {
        const int t = kt * D + j;
        if (t >= a.S) break;
        const RingIn rin = next;
        if (t + 1 < a.S) next = signals_read(rg, t + 1);
        float cur[NSIG];
        const float r_tqqq = stage[j][F_ETF][lane];
        const float r_spy = stage[j][F_ETF + 1][lane];
        if (t == 0)
          signals_step<true>(sum, rg, t, prev_price, r_tqqq, r_spy, rin, cur);
        else
          signals_step<false>(sum, rg, t, prev_price, r_tqqq, r_spy, rin,
                              cur);
        prev_price = cur[G_PRICE];
#pragma unroll
        for (int i = 0; i < NSIG; ++i) stage[j][F_CUR + i][lane] = cur[i];
      }
    }
    block_sync();
  }
  block_sync();
}

template <int G>
__device__ void strategy_role(Shared& sh, const Args& a, int lane, int b,
                              int ntile) {
  const float* K = sh.tb.k;
  const bool costs = a.apply_costs != 0;
  StratState st;
  init_strategies(st, K);
  for (int k = 0; k < ntile + 2; ++k) {
    const int kt = k - 2;
    if (kt >= 0) {
      float(*stage)[NF][32] = sh.stage[kt % 3];
      const int t0 = kt * D;
#pragma unroll 1
      for (int j = 0; j < D; ++j) {
        const int t = t0 + j;
        if (t >= a.S) break;
        float cur[NSIG];
#pragma unroll
        for (int i = 0; i < NSIG; ++i) cur[i] = stage[j][F_CUR + i][lane];
        const float vix = stage[j][F_VIX][lane];
        const DayCtx c = day_ctx(
            st, K, costs, t, stage[j][F_ETF][lane], stage[j][F_ETF + 1][lane],
            stage[j][F_ETF + 2][lane], stage[j][F_ETF + 3][lane],
            stage[j][F_CASH][lane], stage[j][F_REG][lane], vix, cur,
            a.cf != nullptr ? a.cf[t] : 0.0f);
        // IEEE division here: FastMath with its recompute (group_day, as
        // K4 runs it) spills under K3's 72-register cap and took K3 from
        // 50.6 to 63.8 ms (PERF.md, PR 6).
        IeeeMath im;
        if (t == 0)
          strategies_group<G, true>(st, c, im);
        else
          strategies_group<G, false>(st, c, im);
        roll(st, vix, cur);
      }
    }
    block_sync();
  }
  block_sync();
  if (b < a.B) {
#pragma unroll
    for (int i = 0; i < NS; ++i)
      if (group_of(i) == G) store_strategy(st, i, a.out, b, a.B);
  }
}

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
compose_strategies_kernel(Args a, const float* __restrict__ sp,
                          const float* __restrict__ ap,
                          const float* __restrict__ kc) {
  __shared__ Shared sh;
  for (int i = threadIdx.x; i < NSP; i += blockDim.x) {
    sh.tb.spa[i] = sp[2 * i];
    sh.tb.spd[i] = sp[2 * i + 1] - sp[2 * i];
  }
  for (int i = threadIdx.x; i < NAP * NA; i += blockDim.x) sh.tb.ap[i] = ap[i];
  for (int i = threadIdx.x; i < NK; i += blockDim.x) sh.tb.k[i] = kc[i];
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // Lanes past B (the ragged last block) run on the last trial's inputs,
  // keep their own ring column (ring_ld is B rounded up to 32) and store
  // nothing, so every warp meets every barrier.
  const int b = blockIdx.x * 32 + lane;
  const int bc = b < a.B ? b : a.B - 1;
  const int ntile = (a.S + D - 1) / D;
  switch (warp) {
    case W_COMP: compose_role<0>(sh, a, lane, b, bc, ntile); break;
    case W_COMP + 1: compose_role<1>(sh, a, lane, b, bc, ntile); break;
    case W_SIG: signal_role(sh, a, lane, b, ntile); break;
    case W_STRAT: strategy_role<0>(sh, a, lane, b, ntile); break;
    case W_STRAT + 1: strategy_role<1>(sh, a, lane, b, ntile); break;
    case W_STRAT + 2: strategy_role<2>(sh, a, lane, b, ntile); break;
    default: strategy_role<3>(sh, a, lane, b, ntile); break;
  }
}

}  // namespace

// rings: [RING_ROWS, ceil(B / 32) * 32] scratch; out: [64, B].
extern "C" int letf_compose_strategies(
    const float* cf, const float* sp, const float* ap, const float* kc,
    const int* ids, unsigned int s0, unsigned int s1, const float* spy,
    const float* qqq, const float* tlt, const float* vix, const float* irx,
    const float* regime, float* rings, int S, int B, int apply_costs,
    int has_cf, float* out, void* stream) {
  const int blocks = (B + 31) / 32;
  if (B > 0 && S > 0) {
    const Args a{has_cf ? cf : nullptr, ids, s0, s1, spy, qqq, tlt, vix,
                 irx, regime, rings, blocks * 32, S, B, apply_costs, out};
    compose_strategies_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
        a, sp, ap, kc);
  }
  return (int)cudaGetLastError();
}

extern "C" int letf_info_compose_strategies(int* out) {
  return letf_fill_info((const void*)compose_strategies_kernel, THREADS, 0,
                        out);
}
